#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each a hard failure (non-zero exit, no result line):

1. Build the hand-written CUDA kernels from ``src/repro_torch/kernels/csrc``,
   one ``nvcc`` per source, all started together, and print the build time
   and ptxas' register/shared-memory report; phase 17's dry-run matrix is
   traced meanwhile.  Every phase's title goes to stderr too, after the
   seconds since the script's imports.
2. Hold each kernel against its plain PyTorch version on the card at the
   shapes of the path that runs it (serving internlm2-1.8b: Hkv 8, G 2,
   D 128; the KWS Impulse; training; serving falcon-mamba-7b):
   - both attention kernels on the float contiguous cache: decode with 4
     slots at kv_len {0, 1, 37, S}, chunk prefill of C = 64 with 20 pad
     rows, at S = 576 and S = 555;
   - the same cases on the int8 contiguous cache, and on a paged pool
     (float and int8) with blocks of 64 and of 8 entries, a scrambled
     block table, and the unmapped blocks poisoned (NaN K/V, or NaN int8
     scales, and valid-looking positions; every table entry past a slot's
     live blocks names a poisoned block), so a read outside the live table
     shows up; and decode with all four slots full at S = 576 (bf16, float
     and int8 paged with blocks of 64), where the bytes weigh most;
   - ``int8_matmul`` at M in {4, 64} for each (K, N) of the projections,
     (2048, 2048), (2048, 1024), (2048, 8192), (8192, 2048), at M 1 and 16
     for (2048, 8192), at M 4 and 64 for gemma3-4b's down projection
     (10240, 2560) and zamba2-2.7b's shared block (2560, 2560) and (2560,
     10240), and a ragged case (M 5, K 200, N 300): **bitwise**
     equal to the plain version, each timed row with its share of the
     bound and its factor over ``torch._int_mm``;
   - ``mel_frontend`` on the full-width batch (512 one-second keyword clips,
     50,688 frames, L 320, 257 bins, 40 mels, as ``frame_signal``'s unfold
     view), the quickstart's MFCC frontend (32 mels, 0.5 s clips), ragged
     frame counts 1, 99 and 50,689, the kernel tests' dense shapes (L 256,
     129 bins; L 512, 257 bins), the EON tuner's longest frames (L 800 on
     n_fft 512, 257 bins, 40 and 32 mels, a fit batch of 32 clips at hops
     of 400 and 160), and silence (exactly log(1e-6)):
     elementwise within ``MEL_ATOL`` of the plain version; each timed row
     (the single clip of 99 frames among them) with its factor over the
     rfft chain (a frame longer than n_fft folded first) and its bound,
     whose operations count at the TF32
     tensor-core rate (the kernel's DFT products run there), the f32
     CUDA-core figure beside it.
   - ``flash_attention`` and ``flash_attention_bwd`` (the training path,
     bf16, on the tensor cores) at the training shape (B 4, S 2048, Hq 16,
     Hkv 8, D 128, causal), a ragged S of 1,000, ``causal=False``, a
     window of 256 and D 64: the output, and dQ/dK/dV against autograd
     through the plain version in f32 from the same inputs; each time
     also as a share of its bound and a factor over SDPA.
   - ``mamba_scan`` (the mamba1 layer's selective scan, N 16) at a prefill
     chunk (B 1, S 64, D 8192, bf16, with a carried-in state), a decode
     step (B 4, S 1, with a state), a long one-shot scan (B 1, S 2048,
     from zeros), a ragged shape (B 2, S 37, D 200) and f32 inputs: y and
     the final state within ``MAMBA_TOL`` of the plain version's largest
     magnitude; and a ragged tail with dt = 0, whose final state and real
     outputs must equal **bitwise** the kernel's on the real prefix alone;
     each timed row with its share of the bound.  Its backward
     (``MAMBA_BWD_CASES``: falcon-mamba's training shape, B 1, S 2,048,
     D 8,192, bf16 from zeros; B 2, S 1,000 with h0 and a final state's
     gradient; the smoke width in f32) against ``mamba_scan_bwd_ref``
     within ``MAMBA_BWD_TOL``, two runs bitwise equal, planted faults
     failing (``split_without_carry`` among them: two calls cut at a
     segment boundary that carry nothing across).
   - slices 7 and 8 (``SLICE_LAYOUTS``): both serving kernels at
     gemma3-4b's heads (Hkv 4, G 2, D 256) on a contiguous cache of 1,600
     and on the ring layout (decode over a ring of 1,024 that has
     wrapped; a chunk against ``[ring ∥ chunk]``, positions out of index
     order, window 1,024), and at G 3 and G 4 (D 128, phase 3's cache),
     float and int8 K/V, bf16 and f32, each bf16 row timed as above;
     ``flash_attention``'s forward and backward at B 1, S 2048, Hq 8,
     Hkv 4, D 256, causal and with a window of 1,024, and on packed rows
     by position (``FA_D256_CASES``, bf16 and f32; the backward since
     slice 10).  Slice 8 part 2: both serving kernels at zamba2-2.7b's heads
     (Hkv 32, G 1, D 80, computed on tiles of 128) over phase 3's cache
     of 576, contiguous, paged with blocks of 64 (unmapped blocks
     poisoned) and with all four slots full, float and int8, bf16 and
     f32; the forward and backward at B 1, S 2,048 and S 1,000, 32/32
     heads of 80, causal (``FA_D80_CASES``, bf16 and f32).
   Attention tolerance, elementwise against the plain version computed in
   f32 from the same inputs (int8 dequantized and rounded as the kernel
   rounds): in bf16, the output's own rounding (2^-8 of its size) plus
   1e-5; in f32, 1e-5.  Gradients: the same rounding term plus
   ``FA_GRAD_ATOL`` of the gradient's median magnitude.  Each kernel's and
   layout's median time over 30 launches (L2 flushed before each, as the
   serving path finds it), the plain version's, the byte/operation bound
   and a library yardstick's time: ``F.scaled_dot_product_attention`` on
   dense bf16 K/V prepared beforehand (dequantized, gathered; for the
   training kernels the KV heads repeated, the backward through
   autograd), ``torch._int_mm`` (the int32 product alone, M padded to 32,
   the least it takes) for the int8 matmul, the rfft chain
   ``torch.fft.rfft`` -> |.|^2 -> mel -> log for the mel frontend; no
   PyTorch call computes a selective scan, so ``mamba_scan`` has none.
   The port never calls any of them.  Beside the attention and
   ``int8_matmul`` rows stand the timing floor (a kernel that writes one
   float) and the kernel's time after a flush that leaves the L2 clean.
3. Serve eight requests through ``ContinuousBatchServer`` at the full
   width of internlm2-1.8b and 3 of its 24 layers (``SERVE_LAYERS``: a
   depth cut for the script's time, which phases 3, 4, 5 and their
   artifact runs share; d_model 2048, 16/8 heads, d_ff 8192, vocab 92544
   padded to 94208), bf16, random weights from a seeded
   generator on the card: 4 slots, prefill chunk 64, 32 new tokens each,
   max_prompt 512 (capacity 576).  Every request must return 32 tokens in
   the padded vocabulary; each kernel's launch count in that run must equal
   layers x steps as the server's metrics report them.  Then, over four
   seeds, chunk, ragged-chunk and decode steps are run through the kernels
   and through the plain attention (f32 from the same bf16 cache, rounded
   once to bf16 as the kernels round) on copies of the same cache: every
   layer's attention call must be within the kernel tolerance of the plain
   version on its own inputs, and the logits must agree at atol
   ``LOGIT_ATOL`` (bf16 layers amplify single-ulp rounding differences;
   PERF.md gives the readings behind the limit, taken at 24 layers), with
   equal greedy tokens on at least 90% of the compared rows.  The main
   oracle is exact: a small float32 config (head_dim 128) served through the
   kernels must give the same greedy tokens as the plain path on the CPU.
4. A profile of decode and chunk steps says where a step's time goes
   (host wall, device busy, kernels per step, attention, ``int8_matmul``,
   GEMMs).
5. The int8 paged path: the same model, ``precision="int8"``, through
   ``PagedBatchServer`` (4 slots, chunk 64, 32 new tokens, max_prompt 512:
   capacity 576, blocks of 64, 9 table entries) with a pool of 24 blocks,
   below the 36 the four slots could hold, on eight prompts of which four
   share a 256-token prefix.  Every request must return 32 tokens; the run
   must preempt at least once and hit the prefix cache at least once; each
   kernel's launch count must equal what the step counts imply
   (``int8_matmul``: 7 x layers x (decode steps + chunk steps)).  The int8
   logits are held against the plain path (plain attention and plain int8
   matmul) on copies of the same pool as in phase 3, at
   ``INT8_LOGIT_ATOL``, with greedy tokens equal on at least
   ``INT8_GREEDY_EQUAL_MIN`` of the rows; both paths' noise floor (the
   plain path with float64 attention) is printed beside them.  The exact
   oracle again: a small float32 int8 config served through the kernels
   gives the CPU plain path's tokens, through ``PagedBatchServer`` with
   blocks of 8 and a pool small enough to preempt, and through
   ``StaticBatchServer``.  Then the int8 paged steps' profile.  Last,
   calibrated activations: the small float32 config's quantized weights
   with an amax attached per scope (``SMALL_AMAX``) give the CPU's tokens
   through ``ContinuousBatchServer``; at full width a dynamic int8
   continuous run of phase 3's requests records the rows each projection
   scope is fed, ``calibrate_amax`` folds them into one amax a scope, and
   the calibrated run of the same requests must launch every kernel as
   often as the dynamic run did; its logits are held against the plain
   path at ``INT8_LOGIT_ATOL`` (greedy ``CAL_GREEDY_EQUAL_MIN``).
6. The KWS Impulse at full width: DS-CNN at the repo's defaults (12
   classes, 64 filters, 4 blocks) on the MFE block's defaults, f32 with
   TF32 off, random weights from a seeded generator on the card.  2,048
   one-second clips in batches of 512 (clips/s), 32 single-clip calls
   (latency p50, split into DSP and NN time), PTQ on 16 clips and the int8
   labels of the 2,048 against float's; ``mel_frontend`` must launch once
   per ``features`` call.  A profile gives the device's idle share.  The
   same weights and 64 clips on the port's CPU path: float and int8 logits
   within ``KWS_LOGIT_ATOL``, labels equal where the CPU's top-two gap
   exceeds it, PTQ values and scales bitwise equal; the quickstart Impulse
   (MFCC 32 mels / 10 coefficients + a 2-block conv1d stack, 0.5 s clips)
   gives the CPU's labels on every clip.  Then ``Impulse.fit`` at full
   width: the same DS-CNN on MFE from seeded weights, trained on 1,536 of
   the clips and held out on 512, 3 epochs at batch 32 (144 AdamW steps):
   ``mel_frontend`` must launch once a step and once per ``evaluate``
   batch and nothing else; the last epoch's loss below the first's and
   ln 12; ``val_acc`` at least ``FIT_VAL_ACC_MIN``; the held-out int8
   accuracy after PTQ within 0.1 of float.  Step ms, clips/s, a profiled
   step's idle share and ``mel_frontend`` share, and the MCU estimates
   (predictions for those boards, not card numbers).  The quickstart
   Impulse fitted 2 epochs at batch 16 on its 64 clips on the card and on
   the CPU from the same weights: history within ``FIT_LOSS_RTOL``,
   logits within ``FIT_LOGIT_ATOL``, labels equal where the CPU's top-two
   gap clears it, weights within the Adam bound.
7. Full-width training of internlm2-1.8b at 12 of its 24 layers
   (``TRAIN_LAYERS``: a depth cut for the script's time and for the bytes
   its checkpoint writes; phase 17's train cell runs all 24): f32
   masters, bf16 activations,
   ``make_train_step`` with remat "full" and AdamW (lr 3e-4) through
   ``Trainer`` for 8 steps of batch 4 x seq 2048 from the Markov token
   stream over its first 4,096 ids, checkpointing to a temporary
   directory.  Every step's loss must be finite, and three losses must
   fall: the loss by step (the last step's below the first's), the first
   step's batch and a held-out batch from the stream's tail (never trained
   on), both scored by ``forward_train`` before the first step and after
   the last; each attention kernel's launches must equal what the path
   implies (a forward, a recomputed forward and a backward a layer and
   step).
   Step ms (median of steps 3 to 8), tokens/s, MFU, peak device memory,
   then a profile (one step outside the timed range, the mean of two
   steps inside it): the attention kernels' share of the device time,
   each one's ms a step, and the idle share.  Then ``REMAT_STEPS`` steps
   under each of the reference's remat policies (after an untimed one):
   the median step ms and the peak memory, which must fall in the order
   none >= dots >= dots_no_batch >= full.  A small float32 config
   trained 3 steps on the card and on the CPU from the same weights must
   agree (``TRAIN_TOL``).
8. Full-width mamba1 serving: falcon-mamba-7b (d_model 4096, d_inner
   8192, state 16, dt_rank 256, vocab 65024 padded to 65536) at 8 of its
   64 layers (``MAMBA_LAYERS``: depth cut so that the script keeps within
   its time as phases 10 to 14 join it), bf16,
   random weights from a seeded generator on the card, through
   ``ContinuousBatchServer`` as in phase 3 (4 slots, chunk 64, 32 new
   tokens, eight prompts of 9 to 512 tokens).  Every request must return
   32 tokens in the padded vocabulary, and ``mamba_scan`` must launch
   exactly 16 x (chunk steps + decode steps).
   Then, as in phase 3 over four seeds, chunk, ragged-chunk and
   decode steps through the kernel and through the plain scan on copies
   of the same state: every layer's scan within ``MAMBA_TOL`` of the
   plain version on its own inputs, the logits within
   ``MAMBA_LOGIT_ATOL``, greedy tokens equal on at least
   ``MAMBA_GREEDY_EQUAL_MIN`` of the rows.  The exact oracle: the small
   float32 smoke config served on the card gives the CPU plain path's
   tokens through ``ContinuousBatchServer`` and ``PagedBatchServer``.
   Last, a profile of decode and chunk steps (host wall, device busy, idle
   share, kernels per step, the scan's share) and tokens/s, TTFT and the
   state's bytes.

Phases 3, 5 (paged and calibrated), 6 (inference) and 8 then run once
more from the deployment artifact (``use_artifact=True``;
``compile_impulse`` at batch 512 and 1): the decode step, or the whole
Impulse, exported with ``torch.export`` and replayed as a CUDA graph
captured when the engine is built.  Each prints the build time,
``artifact_bytes`` and ``temp_bytes``, tokens/s (clips/s) and the decode
step's (the call's) host wall, device busy and idle share beside the
eager run's, and must give the eager run's tokens (the Impulse: its
logits, within ``KWS_LOGIT_ATOL`` and bitwise where cuDNN picks the same
algorithm under capture, and labels).  A replay launches the captured
kernels without a wrapper: the kernels a run executed are the wrappers'
count in it plus the capture's count times the replays, and they must
equal the eager run's launches, one replay a decode step (or call).
10. One-shot prefill at full width (``make_prefill_step``): internlm2-1.8b
   (``SERVE_LAYERS`` deep) at B 4, S 512 and gemma3-4b (``GEMMA_LAYERS``
   deep; depth cut for the script's time) at B 1, S 2,048 (past its window, so the
   rings come from ``_ring_select``), each against the chunked path on
   the same prompts: the last-token logits within ``PREFILL_LOGIT_ATOL``,
   every cache entry within ``PREFILL_CACHE_ATOL``, the positions equal,
   ``flash_attention`` launched once a layer; 32 greedy tokens decoded
   from ``grow_cache``, teacher-forced with ``ContinuousBatchServer``'s
   tokens on the same prompts, equal to them on at least
   ``PREFILL_GREEDY_EQUAL_MIN``.  The exact oracle: a float32 gemma3 of
   smoke widths with heads of 256 (13 layers, window 8) served and
   prefilled on the card gives the CPU's greedy tokens.
11. gemma3-4b at full width and 6 of its 34 layers (``GEMMA_LAYERS``:
   1 of its 5 groups of 5 windowed layers and a global one; a depth cut
   for the script's time; d_model
   2560, 8/4 heads of 256, window 1,024, vocab 262,144), bf16, seeded
   weights: four prompts of
   900 to 1,500 tokens (every ring wraps) with 32 new tokens, 4 slots,
   chunks of 64, max_prompt 1,536, through ``ContinuousBatchServer``
   (float) and ``PagedBatchServer`` (int8): every request returns 32
   tokens, each kernel's launches equal 6 x the steps; the logits
   against the plain path on copies of the cache as in phase 3 (two
   seeds, slots filled past the window), at ``GEMMA_LOGIT_ATOL`` and
   ``GEMMA_INT8_LOGIT_ATOL``.  Then granite-3-8b at full width (40 layers,
   G 4), float, phase 3's requests, with its launch counts.
12. zamba2-2.7b at full width and 6 of its 54 layers (``ZAMBA_LAYERS``:
   1 of its 9 groups of 6 mamba2 blocks, each closed by one shared
   attention block of 32/32 heads of 80; a depth cut for the script's
   time; d_model 2560, 80 SSM heads of 64, state 64, vocab 32,000 padded
   to 32,768; 428,076,960 parameters), bf16, seeded weights: phase 3's
   eight requests through ``ContinuousBatchServer`` (float) and
   ``PagedBatchServer`` (int8), every request 32 tokens, each serving
   kernel launched once a step and ``int8_matmul`` 7 times a step
   (int8); the logits against the plain path on copies of the cache as
   in phase 3, at ``ZAMBA_LOGIT_ATOL`` and ``ZAMBA_INT8_LOGIT_ATOL``; a
   profile of its decode and chunk steps; one-shot prefill at B 1, S
   2,048 against the chunked path at ``ZAMBA_PREFILL_LIMITS`` (the SSM
   states too), ``flash_attention`` launched 3 times.  The
   exact oracle: a float32 zamba2 of smoke depth with heads of 80 served
   (continuous; int8 paged, preempting) and prefilled on the card gives
   the CPU's greedy tokens.
9. The EON tuner (``EONTuner.search``: 8 candidates sampled, screened by
   the MCU estimator for the nano33ble, trained 1 epoch each on 384
   seeded one-second keyword clips of 4 classes and ranked on 128) and a
   ``Project`` through every stage (ingest, impulse, 8 epochs, test,
   PTQ, estimate, tune, ``deploy(int8=True)`` to a file): the reloaded
   artifact's logits must equal the artifact's before saving, and the
   eager int8 logits within ``KWS_LOGIT_ATOL``.

13. The MoE decoders at full width, bf16, seeded weights, depth cut to
   fit the card and the script's time (``MOE_LAYERS``): phi3.5-moe-42b-a6.6b
   at 6 of its 32 layers (d_model 4096, 32/8 heads of 128, 16 experts of
   d_ff 6400, top 2; 8,070,287,360 parameters, 15.0 GiB) serves phase 3's requests
   through ``ContinuousBatchServer`` (float) and phase 5's shared-prefix
   requests through ``PagedBatchServer`` (int8, a pool of 16 blocks; the
   prefix cache must hit), each held to its launch counts (``int8_matmul``
   4 a layer: the experts stay float); its logits against the plain path
   on copies of the cache as in phase 3, with the expert choices of every
   MoE call of both paths compared and counted; a profile of its decode
   and chunk steps.  dbrx-132b at 8 of its 40 layers (d_model 6144, 48/8
   heads: G 6, 16 experts of d_ff 10752, top 4; 27,305,809,920
   parameters) serves phase 3's requests (float), its logits against the
   plain path, and is prefilled in one shot at B 1, S 2,048 against the
   chunked path, each side's dropped rows reported (the one-shot call
   routes T = 2,048 rows a layer, a chunk 64, so their capacities
   differ).  phi3.5-moe at 2 layers trains 3 steps of B 1 x S 2,048 (f32
   masters, AdamW, remat "full"): step ms, losses, peak memory, the
   attention kernels' launches.  The exact oracle: a small float32 config
   of each (head dim 128, G 4 and G 6) on the card gives the CPU's tokens
   (continuous; int8 paged, preempting; one-shot prefill), and its decode
   step captured as a CUDA graph gives the eager tokens.  Phase 2 holds
   both serving kernels at G 6 (contiguous and paged with blocks of 64,
   float and int8), ``int8_matmul`` at the MoE decoders' attention
   projections (K 4,096 and 6,144) and both training attention kernels at
   B 1, S 2,048, 32/8 and 48/8 heads.
14. The encoder-decoder backbone: seamless-m4t-large-v2 at full width
   and 6 of its 24 encoder and 6 of its 24 decoder layers
   (``SEAMLESS_LAYERS``: a depth cut for the script's time; d_model 1024,
   16/16 heads of 64, d_ff 8192, vocab 256,206 padded to 258,048;
   906,002,432 parameters), bf16, seeded weights.  Four rows, each an encoder pass
   over 512 frames (the stub frontend's embeddings from
   ``api.synthetic_inputs``) and a decoder prompt of 64 tokens: one-shot
   (``forward_prefill``, ``grow_cache`` by 64, 64 greedy decode steps) and
   chunked (``init_chunk_cache`` of 128, chunks of 16, the same decode
   steps teacher-forced with the one-shot run's tokens), in float and
   then in native int8.  Each run is held to its launch counts (the
   encoder's and the decoder's ``flash_attention``, self and cross
   ``flash_decode`` and ``flash_chunk_prefill``, ``int8_matmul``) and
   leaves the cross caches bitwise unchanged; its logits against the
   same run with every kernel patched to its plain version, at
   ``ENCDEC_LOGIT_ATOL`` with greedy tokens equal on at least
   ``ENCDEC_GREEDY_EQUAL_MIN``; the float one-shot against the float
   chunked path at ``ENCDEC_CHUNKED_LIMITS`` (the int8 gap printed: the
   one-shot prefill attends the unquantized K/V, the chunks the quantized
   cross entries, as in the reference).  The decode loop's tokens/s, the
   encoder pass's ms and one decode step's profile.  Then training at
   the same depth: f32 masters, AdamW, remat "full", 3 steps of B 2 x S
   2,048 (S_enc 512): losses, step ms, peak memory, 36 forward and 18
   backward attention launches a step.  The exact oracle: the smoke config at
   d_model 256 (head dim 64) in float32 on the card gives the CPU's
   greedy tokens, one-shot and chunked.  Phase 2 holds both training
   attention kernels with keys of another length (B 2, Sq 2,048 on Skv
   512; Sq 1,000 on Skv 250; the encoder's S 512, all ``causal=False``,
   16/16 heads of 64), both serving kernels at D 64 and G 1 (the self
   cache and the cross cache read from position 2^30, float and int8)
   and ``int8_matmul`` at K 1,024 and 8,192 (M 4, 64 and 2,048).
15. The VLM: qwen2-vl-72b at full width (d_model 8,192, 64/8 heads of
   128, d_ff 29,568, vocab 152,064 padded to 153,600, M-RoPE sections
   (16, 24, 24)) and 8 of its 80 layers (``QWEN_LAYERS``: 19.1 GB of
   bf16 weights; depth cut for the card's memory and the script's time),
   seeded weights.  Two rows of 1,200 patch and text embeddings (the stub
   frontend's) at Qwen2-VL's three-stream positions (text, an image whose
   patches share one temporal position, text from one past its largest
   id; one row left-padded at -1): one-shot prefill (``flash_attention``
   masked by the temporal stream) and 32 decode steps written past the
   prompt, float and then native int8, each held to its launch counts
   and, teacher-forced with the float run's tokens, against the same run
   through the plain kernels at ``QWEN_LOGIT_ATOL`` (greedy
   ``QWEN_GREEDY_EQUAL_MIN``); text prompts (B 2 x 512) one-shot against
   chunks of 64 (chunked prefill takes one-stream positions) at
   ``QWEN_CHUNKED_LIMITS`` (float; the int8 gap printed).  Training at 1
   layer and full width (3.39 B parameters, f32 masters and AdamW), 3
   steps of B 1 x S 2,048 embedding batches at an image's positions:
   losses, step ms, MFU, peak memory, the attention kernels' launches.
   The exact oracle: the smoke config at d_model 256 (4/2 heads of 64,
   sections (8, 12, 12)) in float32 on the card gives the CPU's greedy
   tokens at image positions, float and int8.  Phase 2 holds both
   training attention kernels masked by position (``FA_POS_CASES``: an
   image's positions at B 1, S 2,048, 64/8 heads of 128, bf16 and f32;
   packed rows with pads at B 2, S 1,000, causal and with a window of
   256; the bound on the visible pairs, SDPA with the same boolean mask
   on its memory-efficient backend), both serving kernels at G 8 (D 128,
   contiguous and paged, float and int8) and ``int8_matmul`` at its
   projections (K 8,192 into N 8,192 and 29,568, K 29,568 into N 8,192).
16. Training breadth at full width (``BREADTH``): falcon-mamba-7b at 24
   of its 64 layers, zamba2-2.7b at all 54, gemma3-4b at 18 of its 34,
   f32 masters, bf16 activations, remat "full", AdamW, ``BREADTH_STEPS``
   steps of B 1 x S 2,048: finite losses, step ms, tokens/s, peak
   memory, and the launches of the scan's backward and of
   ``flash_attention``'s at D 80 and D 256; a two-layer run of each
   against the plain path's loss and gradients (``BREADTH_GRAD_RTOL``,
   ``BREADTH_LOSS_ATOL``); one more falcon-mamba step profiled, the
   scan backward's device ms and share.

17. The dry run against the card (``launch/dryrun.py``, resource
   estimation before touching the hardware).  The matrix, every arch of
   ``ALIASES`` x ``SHAPES`` on the one-card mesh, is traced on the
   ``meta`` device by ``repro_torch.launch.dryrun`` in three processes of
   their own (no card: ``CUDA_VISIBLE_DEVICES`` empty; one a group of
   shapes, ``DRYRUN_MATRIX_GROUPS``) while phase 1's
   ``nvcc`` compiles; phase 1 waits for them, so that no timed phase has
   them beside it, and phase 17 prints one line a cell (status, ``fits_hbm``,
   bottleneck, ``roofline_fraction``, HBM GiB, trace seconds): no
   ``error``, ``DRYRUN_MATRIX`` skipped and ok.  Then ``DRYRUN_CELLS``,
   four cut cells that the card runs in seconds, each traced on ``meta``
   and run on the card through the same entry point under the same
   ``StepCounter``: internlm2-1.8b ``train_4k`` cut to one microbatch (B
   2 x 4,096, remat "full", AdamW), its ``prefill_32k`` cut to B 1, its
   ``decode_32k`` cut to B 8 on a full cache of 32,768 entries (random
   K/V, every position valid), and falcon-mamba-7b's ``prefill_32k`` at B
   1 at all 64 layers, in a process of its own (``chip_smoke.py
   --dryrun-cell``) whose allocator grows its segments
   (``DRYRUN_APART_ALLOC``: with the default allocator the cell runs the
   card out of memory, even in a fresh process), f32 weights as the dry
   run's: the counted FLOPs of the trace and of
   the card run must be equal; the predicted ``per_device_hbm_bytes``
   against ``torch.cuda.max_memory_allocated`` after a reset, less what
   earlier phases still held, within ``DRYRUN_MEM_RTOL``; the step's ms (median of ``DRYRUN_REPS``
   uncounted runs) beside the roofline's time and the measured fraction
   of the H100's peak on the useful FLOPs; the kernels' launches of the
   counted run, which must equal the counter's calls.  ``H100.hbm_bytes``
   must equal the card's ``total_memory``.  ``PodConfigTuner`` on
   internlm2-1.8b x ``train_4k`` (``DRYRUN_TUNER_SAMPLES``): the ranked
   rows, the best fitting the card's memory.  Last the elastic cycle:
   the trained weights saved, ``plan_rescale({"data": 1, "model": 1},
   1)``, ``build_mesh`` and ``elastic_restore`` onto the card, bitwise
   equal.

Phases 10 to 17 run before phase 9.  Each main path (phases 3, 5
paged and calibrated, 6 inference and fit, 7, 8, their artifact runs, 9,
10, 11, 12, 13, 14, 15, 16 and 17's card runs) runs with every launch
count set to 0 just before it and read just after.  Prints the kernels'
JSON line, the card's name and power limit, and last ``{"ok": true,
"device": {...}}``.  Needs one GPU; exits non-zero without one, or
without the rest of the repository beside it.
"""
from __future__ import annotations

import atexit
import contextlib
import copy
import dataclasses
import gc
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from types import SimpleNamespace
from unittest import mock

import numpy as np
import torch
import torch.nn.functional as F

T_START = time.perf_counter()              # after the imports
HBM_BYTES_PER_S = 3.35e12                  # H100 SXM
PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 67e12,
            torch.int8: 1979e12}
TF32_OPS = 495e12         # f32 products on the tensor cores (TF32, dense)
# flash_attention_bwd and mamba_scan_bwd are the gradients of the same TPU
# kernels, which have none
REPLACES = {"flash_decode": "src/repro/kernels/flash_decode.py:147",
            "flash_chunk_prefill": "src/repro/kernels/flash_decode.py:334",
            "int8_matmul": "src/repro/kernels/int8_matmul.py:45",
            "mel_frontend": "src/repro/kernels/mel_frontend.py:34",
            "flash_attention": "src/repro/kernels/flash_attention.py:83",
            "flash_attention_bwd": "src/repro/kernels/flash_attention.py:83",
            "mamba_scan": "src/repro/kernels/mamba_scan.py:49",
            "mamba_scan_bwd": "src/repro/kernels/mamba_scan.py:49"}
SOURCES = {"flash_decode": "src/repro_torch/kernels/csrc/flash_decode.cu",
           "flash_chunk_prefill":
               "src/repro_torch/kernels/csrc/flash_decode.cu",
           "int8_matmul": "src/repro_torch/kernels/csrc/int8_matmul.cu",
           "mel_frontend": "src/repro_torch/kernels/csrc/mel_frontend.cu",
           "flash_attention":
               "src/repro_torch/kernels/csrc/flash_attention.cu",
           "flash_attention_bwd":
               "src/repro_torch/kernels/csrc/flash_attention.cu",
           "mamba_scan": "src/repro_torch/kernels/csrc/mamba_scan.cu",
           "mamba_scan_bwd": "src/repro_torch/kernels/csrc/mamba_scan.cu"}
HKV, G, D = 8, 2, 128
DEV = "cuda"
# phases 3 to 5 (and their artifact runs) serve internlm2-1.8b at 3 of its
# 24 layers, and phase 7 trains it at 12: depth cut (from 12 and 24) so
# that the script keeps within half its time; phase 7's checkpoint (f32
# masters and AdamW's two moments, 12 bytes a parameter) halves with it
SERVE_LAYERS, TRAIN_LAYERS = 3, 12
# A bf16 output may differ from the f32 plain value by its own rounding,
# at most 2^-8 of its size, plus the f32 summation-order slack (below 1e-6
# in the f32 check); an f32 output by that slack alone.
TOL = {torch.bfloat16: (2.0 ** -8, 1e-5), torch.float32: (0.0, 1e-5)}
# Twice the largest of 16 serving-step readings on the H100 (0.1328),
# rounded up to a power of two; PERF.md gives the readings.
LOGIT_ATOL = 0.5
GREEDY_EQUAL_MIN = 0.9    # share of compared rows (95.2% read)
# The same rule on the int8 paged path: twice the largest of its 16
# readings (0.5273), rounded up to a power of two; greedy tokens equal on
# 83.7% of the rows there, so at least 80% is required.  The per-row
# activation quantizer amplifies single-ulp attention differences; the
# plain path run once more in float64 shows the same spread (PERF.md).
INT8_LOGIT_ATOL = 2.0
INT8_GREEDY_EQUAL_MIN = 0.8
# The same path with calibrated activations (one amax a projection scope,
# phase 5): the logits at INT8_LOGIT_ATOL, greedy tokens equal on 77.8%
# of the rows at the first reading (the plain path's own f32 against f64
# floor 86.4%), so at least 70% is required.  A static range quantizes
# most rows on a coarser grid than their own amax would, so a rounding
# flip moves a value further (PERF.md).
CAL_GREEDY_EQUAL_MIN = 0.7
GEMM_NAMES = ("gemm", "gemv", "cutlass", "xmma", "cublas", "nvjet")
# The mel frontend's log-mel, kernel against the plain version in f32 from
# the same inputs: the two sum in another order (the plain f32 version is
# within 7.4e-6 of the JAX reference on keyword clips).
MEL_ATOL = 1e-4
# Card against CPU for the KWS Impulses, float and int8 logits: twice the
# largest of the four readings on the H100 (2.89e-6), rounded up to a
# power of two, the rule of the serving limits; PERF.md gives the readings.
KWS_LOGIT_ATOL = 2.0 ** -17
# Phase 6's fit: the DS-CNN trained on the first 1,536 of the 2,048 clips
# and held out on 512, 3 epochs at batch 32 (144 AdamW steps), lr 1e-3.
FIT_TRAIN, FIT_EPOCHS, FIT_BATCH, FIT_LR = 1536, 3, 32, 1e-3
# The held-out accuracy after the fit: at most half of what the first
# card run read (0.5195 on the H100; chance is 1/12).
FIT_VAL_ACC_MIN = 0.25
# Card against CPU, the quickstart Impulse fitted 2 epochs at batch 16
# (8 AdamW steps) from the same weights: the per-epoch loss and accuracy
# relative, the logits after the fit absolute.  Twice the largest reading
# on the H100 over 9 weight seeds (7.32e-8 and 4.77e-6: f32 in another
# summation order, carried through 8 Adam steps;
# scripts/chip_fit_readings.py), rounded up to a power of two; PERF.md
# gives the reasoning.
FIT_CHECK_EPOCHS = 2
FIT_LOSS_RTOL = 2.0 ** -22
FIT_LOGIT_ATOL = 2.0 ** -16
# Phase 5's small calibrated config: one amax per projection scope, as the
# JAX package's calibrated test attaches them.
SMALL_AMAX = {"wq": 4.0, "wk": 4.0, "wv": 4.0, "wo": 4.0, "w_gate": 4.0,
              "w_up": 4.0, "w_down": 8.0}
KWS_CLIPS, KWS_BATCH, KWS_SINGLE = 2048, 512, 32
# The training kernels' gradients in bf16 against the backward's plain
# version in f32 on the same inputs and the kernel's own rounded output
# (``ref.flash_attention_bwd_ref``), so that only the summation order
# differs: elementwise, the output's rounding (2^-8 of each value) plus
# FA_GRAD_ATOL of the gradient's median magnitude.  The median, not the
# largest value: under causal attention the gradients shrink along the
# sequence, the first rows' 100 to 200 times the median.  Twice the
# largest of the readings on the H100 (6.16e-5 of the median, dV at D 64),
# rounded up to a power of two; PERF.md gives them.
FA_GRAD_ATOL = 2.0 ** -12
# The same check's term for the backward at D 80 and D 256 (phase 2's wide
# rows).  An element whose sum cancels (|dV| near 0 at an early key, where
# the terms P dO are large) reads the kernel's f32 error of the terms, not
# of the result: at 32/32 heads the D 128 kernel, whose arithmetic D 80
# shares, read 3.17e-4 of the median at one of three seeds, the D 80
# kernel 1.7e-4 (scripts/chip_fa_grad_readings.py, PERF.md); twice the
# largest, rounded up to a power of two
FA_WIDE_GRAD_ATOL = 2.0 ** -10
# the spill stores ptxas may report for a dK/dV pass at D 80 or D 256
# (bf16 and f32, index and position masks): 8 to 16 bytes read on the
# H100's build (PERF.md §7), with room for a few more
FA_DKDV_SPILL_CAP = 32
# name: (B, S, Hq, Hkv, D, causal, window)
FA_CASES = {"train_b4_s2048": (4, 2048, 16, 8, 128, True, 0),
            "ragged_s1000": (4, 1000, 16, 8, 128, True, 0),
            "full_s2048": (4, 2048, 16, 8, 128, False, 0),
            "window256_s2048": (4, 2048, 16, 8, 128, True, 256),
            "d64_s2048": (4, 2048, 16, 8, 64, True, 0),
            # phase 13: phi3.5-moe's training (32/8 heads, G 4) and
            # dbrx-132b's one-shot prefill (48/8 heads, G 6), B 1 x S 2048
            "g4_b1_s2048": (1, 2048, 32, 8, 128, True, 0),
            "g6_b1_s2048": (1, 2048, 48, 8, 128, True, 0)}
# the query tile of the bf16 dK/dV pass (kTile in flash_attention.cu)
FA_FAULT_CASE, FA_TILE_Q = "train_b4_s2048", 64
# the kernels of the bf16 path (the f32 CUDA-core kernels are named
# fa_fwd_kernel, fa_dkdv_kernel, fa_dq_kernel)
FA_KERNELS = ("fa_fwd_wgmma_kernel", "fa_rowdot_kernel",
              "fa_dkdv_wgmma_kernel", "fa_dq_wgmma_kernel")
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ, TRAIN_LR = 8, 4, 2048, 3e-4
# timed steps under each remat policy (after an untimed one)
REMAT_STEPS = 3
# The training stream: TRAIN_TOKENS tokens of the Markov stream over the
# first TRAIN_STREAM_VOCAB ids (the model keeps its full vocabulary), so
# that each state occurs about 24 times and 8 steps can learn what a
# held-out batch shares; over all 92,544 ids each occurs about once and the
# model only memorises the windows it saw (PERF.md).
TRAIN_TOKENS, TRAIN_STREAM_VOCAB = 100_000, 4096
# Card against CPU, the small float32 config after 3 AdamW steps (lr 1e-3):
# loss and grad norm relative, weights absolute.  Twice the largest reading
# on the H100 (7.66e-8, 2.26e-7, 2.36e-5: f32 in another summation order,
# which AdamW's division by sqrt(v) amplifies in the weights), rounded up
# to a power of two; PERF.md gives the readings.
TRAIN_TOL = {"loss_rtol": 2.0 ** -22, "grad_norm_rtol": 2.0 ** -21,
             "param_atol": 2.0 ** -14}
# The selective scan against its plain version in f32 on the same inputs:
# the largest |kernel - plain| of y and of the final state, each over that
# output's largest magnitude (exp and the sum over the state round in
# another order).  Twice the largest reading on the H100 (4.74e-7, a layer
# of phase 8, whose decays near 1 keep a long memory), rounded up to a
# power of two; PERF.md gives the readings.
MAMBA_TOL = 2.0 ** -20
# name: (B, S, D, N, dtype, carried-in state)
MAMBA_CASES = {"chunk_b1_s64": (1, 64, 8192, 16, torch.bfloat16, True),
               "decode_b4_s1": (4, 1, 8192, 16, torch.bfloat16, True),
               "oneshot_b1_s2048": (1, 2048, 8192, 16, torch.bfloat16, False),
               "ragged_b2_s37_d200": (2, 37, 200, 16, torch.bfloat16, True),
               "f32_b2_s64": (2, 64, 8192, 16, torch.float32, True)}
MAMBA_TIMED = ("chunk_b1_s64", "decode_b4_s1", "oneshot_b1_s2048")
MAMBA_LIBRARY = "none: no single PyTorch call computes a selective scan"
# falcon-mamba's logits, the scan through the kernel against the plain
# scan on copies of the same state: twice the largest of 16 readings on
# the H100 (0.2812), rounded up to a power of two; greedy tokens equal on
# 96.1% of the rows there, so at least 90% is required.  64 bf16 layers
# carry single-ulp differences of the scan's f32 output onward.
MAMBA_LOGIT_ATOL = 1.0
# phase 8's depth: 8 of falcon-mamba-7b's 64 layers (cut from 64 to 32,
# 16 and then 8 as later phases joined, so that the script keeps within
# half its time)
MAMBA_LAYERS, MAMBA_PARAMS = 8, 1_379_373_056
MAMBA_GREEDY_EQUAL_MIN = 0.9


def stamp(label: str) -> None:
    """``label`` on stderr after the seconds since the script's imports,
    so that the end of stderr says how far a run got."""
    print(f"[{time.perf_counter() - T_START:.1f} s] {label}",
          file=sys.stderr, flush=True)


def phase(title: str) -> None:
    """Print a phase's title, and stamp it on stderr."""
    print(title, flush=True)
    stamp(title)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def import_port():
    src = Path(__file__).resolve().parent / "src"
    sys.path.insert(0, str(src))
    try:
        import repro_torch
    except ImportError as e:
        fail(f"the port is not beside this script ({e})")
    check(Path(repro_torch.__file__).resolve().parents[1] == src,
          f"imported repro_torch from {repro_torch.__file__}, not {src}")


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------
_flush_buf = None


def flush_l2() -> None:
    global _flush_buf
    if _flush_buf is None:
        _flush_buf = torch.empty(96 << 20, dtype=torch.uint8, device="cuda")
    _flush_buf.zero_()


def flush_l2_clean() -> None:
    """The same eviction by reading the buffer: the L2 is left holding
    clean lines, which the next kernel's reads need not write back."""
    if _flush_buf is None:
        flush_l2()
    _flush_buf.sum()


def time_ms(fn, reps: int = 30, warmup: int = 5, flush=flush_l2) -> float:
    """Median device time of one call.  The stream is first held by a spin
    kernel while every launch is queued, so the events time the kernels
    back to back, not the host's launch overhead; the L2 is flushed
    before each call, as the serving path finds it cold."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(100_000_000)     # ~60 ms: longer than the queueing
    pairs = []
    for _ in range(reps):
        flush()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    return float(np.median([a.elapsed_time(b) for a, b in pairs]))


def tol_ratio(out: torch.Tensor, want: torch.Tensor) -> float:
    """Largest |out - want| in units of the elementwise limit of
    ``out``'s dtype: <= 1 passes."""
    rtol, atol = TOL[out.dtype]
    lim = rtol * want.abs() + atol
    return float(((out.float() - want).abs() / lim).max())


def sdpa_call(q, k, v, qpos, pos, kvl, window=0):
    """One F.scaled_dot_product_attention call over the same function,
    inputs laid out as it wants them beforehand."""
    qs = q.transpose(1, 2).contiguous()
    ks = k.transpose(1, 2).contiguous()
    vs = v.transpose(1, 2).contiguous()
    idx = torch.arange(k.shape[1], device=k.device)
    mask = ((pos[:, None, :] >= 0) & (pos[:, None, :] <= qpos[:, :, None])
            & (idx[None, None, :] < kvl[:, None, None]))
    if window > 0:
        mask &= pos[:, None, :] > qpos[:, :, None] - window
    mask = mask[:, None]
    return lambda: F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask,
                                                  enable_gqa=True)


def dequant_rounded(kv, dtype) -> torch.Tensor:
    """The kernels' int8 dequant, value * scale in f32 rounded once to the
    working dtype, as f32."""
    return (kv.q.float() * kv.scale[..., None]).to(dtype).float()


def f32_inputs(q, k, v):
    """q, K and V in f32 as the kernels compute with them: float K/V
    widened, int8 K/V dequantized and rounded once to q's dtype."""
    if isinstance(k, tuple):
        return q.float(), dequant_rounded(k, q.dtype), \
            dequant_rounded(v, q.dtype)
    return q.float(), k.float(), v.float()


def plain_attention(ref, kind, q, k, v, qpos, pos, kv_len=None,
                    block_table=None, window=0):
    """The plain version of either attention kernel in any layout: an
    ``Int8KV`` cache goes in as values and scales, a paged pool through
    its block table."""
    ks = vs = None
    if isinstance(k, tuple):
        (k, ks), (v, vs) = k, v
    if block_table is not None:
        return getattr(ref, f"paged_{kind}_attention_ref")(
            q, k, v, qpos, pos, block_table, kv_len, window=window,
            k_scale=ks, v_scale=vs)
    return getattr(ref, f"{kind}_attention_ref")(
        q, k, v, qpos, pos, window=window, kv_len=kv_len, k_scale=ks,
        v_scale=vs)


def make_layout_case(gen, Int8KV, int8, bs, b, c, s, fills, reals, dtype,
                     heads=(HKV, G, D)):
    """A cache of S entries per slot in one layout.  Contiguous (``bs``
    None): slot i holds ``fills[i]`` entries at positions 0.., the rest −1.
    Paged: the slots' live blocks are a scrambled set of pool blocks; the
    unmapped blocks hold NaN K/V (int8: NaN scales) and valid-looking
    positions, and every table entry past a slot's live blocks names one
    of them.  Int8 values carry scales amax/127 of about unit size.
    Returns q, k, v (tensors or ``Int8KV``), query positions, positions,
    kv_len and the block table (None when contiguous)."""
    dev = DEV
    hkv, g, d = heads
    q = torch.randn(b, c, hkv * g, d, generator=gen, device=dev).to(dtype)
    qpos = torch.full((b, c), -1, dtype=torch.int32, device=dev)
    for i, (n, r) in enumerate(zip(fills, reals)):
        qpos[i, :r] = torch.arange(n - r, n, dtype=torch.int32, device=dev)
    kvl = torch.tensor(fills, dtype=torch.int32, device=dev)
    table, poisoned = None, []
    if bs is None:
        outer, rows = b, s
        idx = torch.arange(s, device=dev, dtype=torch.int32)
        pos = torch.where(idx[None] < kvl[:, None], idx[None], -1) \
            .to(torch.int32)
    else:
        need = [-(-f // bs) for f in fills]
        outer, rows = sum(need) + 2, bs
        order = torch.randperm(outer, generator=gen, device=dev).tolist()
        pos = torch.randint(0, 3, (outer, bs), generator=gen, device=dev,
                            dtype=torch.int32)
        table = torch.full((b, s // bs), order[-1], dtype=torch.int32,
                           device=dev)
        nxt = 0
        for i, f in enumerate(fills):
            for j in range(need[i]):
                blk = order[nxt]
                nxt += 1
                table[i, j] = blk
                n = min(bs, f - j * bs)
                pos[blk] = -1
                pos[blk, :n] = torch.arange(j * bs, j * bs + n,
                                            dtype=torch.int32, device=dev)
        poisoned = order[nxt:]
    return (q,) + kv_leaves(gen, Int8KV, int8, (outer, rows, hkv, d),
                            poisoned, dtype) + (qpos, pos, kvl, table)


def kv_leaves(gen, Int8KV, int8, shape, poisoned, dtype) -> tuple:
    """K and V of ``shape``: random values of ``dtype``, or int8 values
    with scales amax/127 of about unit size; the ``poisoned`` outer rows
    NaN (int8: NaN scales)."""
    dev = DEV
    if int8:
        def leaf():
            scale = torch.rand(shape[:-1], generator=gen, device=dev) \
                * (1.5 / 127) + 0.5 / 127
            scale[poisoned] = float("nan")
            return Int8KV(torch.randint(-127, 128, shape, generator=gen,
                                        device=dev, dtype=torch.int8), scale)
    else:
        def leaf():
            x = torch.randn(shape, generator=gen, device=dev).to(dtype)
            x[poisoned] = float("nan")
            return x
    return leaf(), leaf()


def make_ring_case(gen, Int8KV, int8, b, c, w, fills, reals, dtype,
                   heads=(4, 2, 256)):
    """The ring layout of the sliding-window layers, gemma3's heads by
    default.  Decode (``c`` 1): slot i's ring of ``w`` rows holds its
    positions max(0, n - w) .. n - 1 at ``pos % w`` (n = ``fills[i]``, the
    query at n - 1), read up to min(n, w) rows.  A chunk: the ring holds
    the n positions before the chunk, and the chunk's ``c`` entries follow
    it, the first ``reals[i]`` at n .., the pad tail −1: ``[ring ∥
    chunk]``, positions out of index order, every row read, as the chunk
    layer's ring branch hands them to the kernel.  The window is ``w``."""
    dev = DEV
    hkv, g, d = heads
    s = w if c == 1 else w + c
    q = torch.randn(b, c, hkv * g, d, generator=gen, device=dev).to(dtype)
    qpos = torch.full((b, c), -1, dtype=torch.int32, device=dev)
    pos = torch.full((b, s), -1, dtype=torch.int32, device=dev)
    for i, (n, r) in enumerate(zip(fills, reals)):
        held = torch.arange(max(0, n - w), n, device=dev)
        pos[i, held % w] = held.to(torch.int32)
        if c == 1:
            qpos[i, 0] = n - 1
        else:
            qpos[i, :r] = torch.arange(n, n + r, dtype=torch.int32,
                                       device=dev)
            pos[i, w:] = qpos[i]
    kvl = torch.tensor([min(n, w) if c == 1 else s for n in fills],
                       dtype=torch.int32, device=dev)
    return (q,) + kv_leaves(gen, Int8KV, int8, (b, s, hkv, d), [], dtype) \
        + (qpos, pos, kvl, None)


def work():
    """The kernels' operation counts (``repro_torch/roofline/collect.py``),
    which the dry run's counter uses too: one definition of each."""
    from repro_torch.roofline import collect
    return collect


def layout_bound_ms(q, k, qpos, pos, kvl, table, window=0) -> tuple:
    """Least time for one call: each input read once (the live K/V rows and
    their int8 scales, their positions, the block-table entries, q and the
    query positions), the output written once; operations 4·D per (query
    row, valid entry, head)."""
    int8 = isinstance(k, tuple)
    hkv = (k[0] if int8 else k).shape[2]
    d, g = q.shape[-1], q.shape[2] // hkv
    s = pos.shape[1] if table is None else table.shape[1] * pos.shape[1]
    live = int(kvl.clamp(max=s).sum())
    per_entry = hkv * (2 * d * (1 if int8 else k.element_size())
                       + (8 if int8 else 0)) + 4
    nbytes = (live * per_entry + 2 * q.numel() * q.element_size()
              + qpos.numel() * 4 + kvl.numel() * 4
              + (table.numel() * 4 if table is not None else 0))
    # the valid (row, entry) pairs are those of the slots' logical caches
    idx = torch.arange(s, device=q.device)
    lpos = pos if table is None else \
        pos[table.long()].reshape(table.shape[0], -1)
    valid = ((lpos[:, None, :] >= 0) & (lpos[:, None, :] <= qpos[:, :, None])
             & (idx[None, None, :] < kvl[:, None, None]))
    if window > 0:
        valid &= lpos[:, None, :] > qpos[:, :, None] - window
    ops = work().attention_flops(d, int(valid.sum()), hkv * g)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[q.dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def dense_inputs(q, k, v, pos, table):
    """The layout's K/V and positions as one dense bf16/f32 slot cache
    (dequantized, gathered through the table, poison zeroed), made before
    the library call is timed."""
    _, kf, vf = f32_inputs(q, k, v)
    if table is not None:
        b = table.shape[0]
        kf, vf, pos = (t[table.long()].reshape((b, -1) + t.shape[2:])
                       for t in (kf, vf, pos))
    return (torch.nan_to_num(kf).to(q.dtype),
            torch.nan_to_num(vf).to(q.dtype), pos)


# layout: (int8 K/V, pool block size or None for the contiguous cache)
LAYOUTS = {"float": (False, None), "int8": (True, None),
           "paged_bs64": (False, 64), "int8_paged_bs64": (True, 64),
           "int8_paged_bs8": (True, 8)}


def wrapper_call(fd, kind, q, k, v, qp, pos, kvl, table, window=0):
    """The kernel's wrapper alone on inputs laid out beforehand as
    ``ops.decode_attention``/``ops.chunk_attention`` lay them out (for a
    chunk, q grouped by KV head and the positions by row: two copies, and
    a third for the output, that the ops call makes each time)."""
    b, c, hq, d = q.shape
    (kq, ks), (vq, vs) = (x if isinstance(x, tuple) else (x, None)
                          for x in (k, v))
    hkv = kq.shape[2]
    g = hq // hkv
    if kind == "decode":
        qg, qr, fn = q.reshape(b, hkv, g, d), qp, fd.flash_decode
    else:
        qg = q.reshape(b, c, hkv, g, d).permute(0, 2, 1, 3, 4) \
            .reshape(b, hkv, c * g, d).contiguous()
        qr = qp[:, :, None].expand(b, c, g).reshape(b, c * g).contiguous()
        fn = fd.flash_chunk_prefill
    return lambda: fn(qg, kq, vq, qr, pos, kvl, k_scale=ks, v_scale=vs,
                      block_table=table, window=window)


def time_layout_row(ops, ref, kind, kern, q, k, v, qpos, qp, pos, kvl,
                    table, err, floor_ms, window=0) -> dict:
    """One timed attention row: the ops call (what the serving path makes)
    after the usual flush and after one that leaves the L2 clean, the
    kernel's wrapper alone, the plain version, SDPA on dense K/V, the
    bound, and beside them the timing floor, the share of the bound and
    the factor over SDPA."""
    def call():
        return kern(q, k, v, qp, pos, kv_len=kvl, block_table=table,
                    window=window)
    ms = time_ms(call)
    clean_ms = time_ms(call, flush=flush_l2_clean)
    alone_ms = time_ms(wrapper_call(ops.fd, kind, q, k, v, qp, pos, kvl,
                                    table, window))
    plain_ms = time_ms(lambda: plain_attention(
        ref, kind, q, k, v, qp, pos, kv_len=kvl, block_table=table,
        window=window))
    kd, vd, pd = dense_inputs(q, k, v, pos, table)
    lib_ms = time_ms(sdpa_call(q, kd, vd, qpos, pd, kvl, window))
    b_ms, b_by = layout_bound_ms(q, k, qpos, pos, kvl, table, window)
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
            "clean_l2_ms": clean_ms, "wrapper_alone_ms": alone_ms,
            "timing_floor_ms": floor_ms,
            "share_of_bound": b_ms / ms, "factor_vs_library": ms / lib_ms}


def check_layouts(ops, ref, Int8KV):
    """Both attention kernels in every layout against their plain
    versions; returns each kernel's timed rows by layout (bf16, S 576),
    and decode with all four slots full in the float and int8 paged
    (blocks of 64) layouts, the bytes-bound case."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    one = torch.zeros(1, device=DEV)
    floor_ms = time_ms(one.zero_)
    print(f"  timing floor (one float written): {floor_ms:.5f} ms")
    rows = {"flash_decode": {}, "flash_chunk_prefill": {}}
    cases = []
    for layout, (int8, bs) in LAYOUTS.items():
        for s in ((576, 555) if bs is None else (576,)):
            for dtype in (torch.bfloat16, torch.float32):
                cases.append((layout, s, dtype, {
                    "flash_decode": ("decode", make_layout_case(
                        gen, Int8KV, int8, bs, 4, 1, s, [0, 1, 37, s],
                        [0, 1, 1, 1], dtype), ops.decode_attention),
                    "flash_chunk_prefill": ("chunk", make_layout_case(
                        gen, Int8KV, int8, bs, 1, 64, s, [448], [44], dtype),
                        ops.chunk_attention),
                }))
    for layout in ("float", "int8_paged_bs64"):
        cases.append((f"{layout}_full", 576, torch.bfloat16, {
            "flash_decode": ("decode", make_layout_case(
                gen, Int8KV, *LAYOUTS[layout], 4, 1, 576, [576] * 4,
                [1] * 4, torch.bfloat16), ops.decode_attention)}))
    for layout, s, dtype, by_name in cases:
        for name, (kind, case, kern) in by_name.items():
            q, k, v, qpos, pos, kvl, table = case
            qp = qpos[:, 0] if kind == "decode" else qpos
            out = kern(q, k, v, qp, pos, kv_len=kvl, block_table=table)
            torch.cuda.synchronize()
            want = plain_attention(ref, kind, *f32_inputs(q, k, v), qp, pos,
                                   kv_len=kvl, block_table=table)
            err = float((out.float() - want).abs().max())
            ratio = tol_ratio(out, want)
            b, hkv, r = q.shape[0], HKV, q.shape[1] * G
            plan = ops.fd._plan(b, hkv, r, s, dtype, isinstance(k, tuple), D)
            print(f"  {name:20s} {layout:21s} S={s} {str(dtype):15s}"
                  f" max|err| {err:.3g}, {ratio:.3f} of the limit"
                  f"  ({plan.kernel}, {plan.rows} rows a block, split"
                  f" {plan.split}, grid {plan.grid})")
            check(out.dtype == dtype and bool(out.isfinite().all()),
                  f"{name} {layout}: non-finite or wrong dtype")
            check(ratio <= 1, f"{name} disagrees with its plain version,"
                  f" {layout} S={s} {dtype}: {ratio} of the limit")
            if not layout.endswith("_full"):
                zero = out[0] if kind == "decode" else out[0, 44:]
                check(bool((zero == 0).all()),
                      f"{name} {layout}: empty slot or pad rows not zero")
            if s != 576 or dtype != torch.bfloat16:
                continue
            row = time_layout_row(ops, ref, kind, kern, q, k, v, qpos, qp,
                                  pos, kvl, table, err, floor_ms)
            rows[name][layout] = row
            print(f"  {name:20s} {layout:21s} kernel {row['ms']:.5f} ms"
                  f" (clean L2 {row['clean_l2_ms']:.5f}, wrapper alone"
                  f" {row['wrapper_alone_ms']:.5f}, floor {floor_ms:.5f})"
                  f"  plain {row['plain_ms']:.4f} ms  sdpa"
                  f" {row['library_ms']:.5f} ms  bound {row['bound_ms']:.6f}"
                  f" ms ({row['bound_by']}): {row['share_of_bound']:.4f} of"
                  f" the bound, {row['factor_vs_library']:.2f}x SDPA")
    return rows


# The serving attention shapes of slices 7 and 8: name -> ((Hkv, G, D),
# cache rows (the ring's window for a ring), layout: "contiguous", "ring",
# "paged64" (blocks of 64, the unmapped ones poisoned) or "full" (decode
# with every slot full)).  gemma3-4b's global layers read a contiguous
# cache of its capacity (max_prompt 1536 + 32 new tokens, rounded to
# 1,600), its local layers a ring of 1,024 (a chunk: [ring ∥ chunk]);
# llama3.2-3b and granite-3-8b are phase 3's shapes at G 3 and G 4
# (phi3.5-moe's too); dbrx-132b's (phase 13) at G 6, contiguous and
# paged, a chunk of 64 then 384 rows a KV head;
# zamba2-2.7b's shared block (phase 12) has 32/32 heads of 80 over phase
# 3's capacity of 576.
SLICE_LAYOUTS = {"d256_g2": ((4, 2, 256), 1600, "contiguous"),
                 "d256_g2_ring": ((4, 2, 256), 1024, "ring"),
                 "d128_g3": ((8, 3, 128), 576, "contiguous"),
                 "d128_g4": ((8, 4, 128), 576, "contiguous"),
                 "d128_g6": ((8, 6, 128), 576, "contiguous"),
                 "d128_g6_paged_bs64": ((8, 6, 128), 576, "paged64"),
                 "d80_g1": ((32, 1, 80), 576, "contiguous"),
                 "d80_g1_paged_bs64": ((32, 1, 80), 576, "paged64"),
                 "d80_g1_full": ((32, 1, 80), 576, "full"),
                 # seamless-m4t-large-v2 (phase 14): 16/16 heads of 64,
                 # the decoder's self cache, and the cross cache (the
                 # encoder's 512 entries read whole from position 2^30)
                 "d64_g1": ((16, 1, 64), 576, "contiguous"),
                 "d64_g1_cross": ((16, 1, 64), 512, "cross"),
                 # qwen2-vl-72b (phase 15): 64/8 heads of 128, G 8, on
                 # the 16-row block; a chunk of 64 is 512 rows a KV head
                 "d128_g8": ((8, 8, 128), 576, "contiguous"),
                 "d128_g8_paged_bs64": ((8, 8, 128), 576, "paged64")}
# the query position of a cross-attention read (``layers.py``)
CROSS_QUERY_POSITION = 2 ** 30


def make_cross_case(gen, Int8KV, int8, b, c, s, reals, dtype, heads):
    """The cross-attention layout: every slot holds the encoder's ``s``
    entries at positions 0.., read whole; the real queries sit at
    ``CROSS_QUERY_POSITION``, the rest of a chunk's rows are pad (−1)."""
    dev = DEV
    hkv, g, d = heads
    q = torch.randn(b, c, hkv * g, d, generator=gen, device=dev).to(dtype)
    qpos = torch.full((b, c), -1, dtype=torch.int32, device=dev)
    for i, r in enumerate(reals):
        qpos[i, :r] = CROSS_QUERY_POSITION
    pos = torch.arange(s, dtype=torch.int32, device=dev)[None] \
        .repeat(b, 1)
    kvl = torch.full((b,), s, dtype=torch.int32, device=dev)
    return (q,) + kv_leaves(gen, Int8KV, int8, (b, s, hkv, d), [], dtype) \
        + (qpos, pos, kvl, None)


def check_slice_attention(ops, ref, Int8KV, layouts=SLICE_LAYOUTS):
    """Both serving kernels at ``SLICE_LAYOUTS``, float and int8 K/V, bf16
    and f32, against their plain versions at the kernel tolerance: decode
    with 4 slots (contiguous and paged: fills 0, 1, 37 and full; ring: 1,
    37, 1,024 and 1,500, wrapped; "full": all four full) and a chunk of 64
    with 20 pad rows (contiguous and paged: 128 rows short of full; ring:
    1,200 positions before it); "cross": decode with 4 slots and a chunk
    of 16 at 4 slots with pad tails, every entry read from position 2^30.
    Returns the bf16 rows, timed as phase 2's, by layout."""
    gen = torch.Generator(device="cuda").manual_seed(17)
    floor_ms = time_ms(torch.zeros(1, device=DEV).zero_)
    rows = {"flash_decode": {}, "flash_chunk_prefill": {}}
    for layout, (heads, s, kind) in layouts.items():
        ring = kind == "ring"
        window = s if ring else 0
        bs = 64 if kind == "paged64" else None
        for int8 in (False, True):
            for dtype in (torch.bfloat16, torch.float32):
                if kind == "cross":
                    cases = {
                        "flash_decode": ("decode", make_cross_case(
                            gen, Int8KV, int8, 4, 1, s, [1] * 4, dtype,
                            heads), ops.decode_attention),
                        "flash_chunk_prefill": ("chunk", make_cross_case(
                            gen, Int8KV, int8, 4, 16, s, [16, 12, 16, 5],
                            dtype, heads), ops.chunk_attention)}
                elif kind == "full":
                    cases = {"flash_decode": ("decode", make_layout_case(
                        gen, Int8KV, int8, None, 4, 1, s, [s] * 4, [1] * 4,
                        dtype, heads), ops.decode_attention)}
                elif ring:
                    cases = {
                        "flash_decode": ("decode", make_ring_case(
                            gen, Int8KV, int8, 4, 1, s, [1, 37, s, 1500],
                            [1] * 4, dtype, heads), ops.decode_attention),
                        "flash_chunk_prefill": ("chunk", make_ring_case(
                            gen, Int8KV, int8, 1, 64, s, [1200], [44],
                            dtype, heads), ops.chunk_attention)}
                else:
                    cases = {
                        "flash_decode": ("decode", make_layout_case(
                            gen, Int8KV, int8, bs, 4, 1, s,
                            [0, 1, 37, s], [0, 1, 1, 1], dtype, heads),
                            ops.decode_attention),
                        "flash_chunk_prefill": ("chunk", make_layout_case(
                            gen, Int8KV, int8, bs, 1, 64, s, [s - 128],
                            [44], dtype, heads), ops.chunk_attention)}
                key = layout + ("_int8" if int8 else "")
                for name, (step, case, kern) in cases.items():
                    q, k, v, qpos, pos, kvl, table = case
                    qp = qpos[:, 0] if step == "decode" else qpos
                    out = kern(q, k, v, qp, pos, kv_len=kvl,
                               block_table=table, window=window)
                    torch.cuda.synchronize()
                    want = plain_attention(ref, step, *f32_inputs(q, k, v),
                                           qp, pos, kv_len=kvl,
                                           block_table=table, window=window)
                    err = float((out.float() - want).abs().max())
                    ratio = tol_ratio(out, want)
                    hkv, g, d = heads
                    plan = ops.fd._plan(
                        q.shape[0], hkv, q.shape[1] * g,
                        s if table is not None else pos.shape[1], dtype,
                        int8, d)
                    print(f"  {name:20s} {key:18s} {str(dtype):15s} max|err|"
                          f" {err:.3g}, {ratio:.3f} of the limit"
                          f"  ({plan.kernel}, {plan.rows} rows a block,"
                          f" split {plan.split}, grid {plan.grid})")
                    check(out.dtype == dtype and bool(out.isfinite().all()),
                          f"{name} {key}: non-finite or wrong dtype")
                    check(ratio <= 1, f"{name} disagrees with its plain"
                          f" version, {key} {dtype}: {ratio} of the limit")
                    pad = 12 if kind == "cross" else 44
                    zero = out[1 if kind == "cross" else 0, pad:] \
                        if step == "chunk" else \
                        (None if kind in ("ring", "full", "cross")
                         else out[0])
                    check(zero is None or bool((zero == 0).all()),
                          f"{name} {key}: empty slot or pad rows not zero")
                    if dtype != torch.bfloat16:
                        continue
                    row = time_layout_row(ops, ref, step, kern, q, k, v,
                                          qpos, qp, pos, kvl, table, err,
                                          floor_ms, window)
                    rows[name][key] = row
                    print(f"  {name:20s} {key:18s} kernel {row['ms']:.5f} ms"
                          f"  plain {row['plain_ms']:.4f} ms  sdpa"
                          f" {row['library_ms']:.5f} ms  bound"
                          f" {row['bound_ms']:.6f} ms ({row['bound_by']}):"
                          f" {row['share_of_bound']:.4f} of the bound,"
                          f" {row['factor_vs_library']:.2f}x SDPA")
    return rows


MATMUL_SHAPES = ((2048, 2048), (2048, 1024), (2048, 8192), (8192, 2048))
# qwen2-vl-72b's projections (phase 15, int8): q/o (8192, 8192), k/v (8192,
# 1024; seamless-m4t's down projection's shape, timed with phase 14's),
# gate/up (8192, 29568), down (29568, 8192)
QWEN_MATMUL_SHAPES = tuple((m, k, n) for k, n in ((8192, 8192),
                                                  (8192, 29568),
                                                  (29568, 8192))
                           for m in (4, 64))


def check_int8_matmul(ops, ref, im, only=None):
    """``int8_matmul`` against its plain version, bitwise, at the serving
    shapes (M = 4 slots at decode, M = 64 in a chunk; M 1 and 16, the
    decode regime's ends, at 2048 -> 8192) and a ragged case; returns the
    timed rows by shape, each with its share of the bound and its factor
    over ``torch._int_mm``.  Two readings put the times in context: the
    timing floor (``time_ms`` of a kernel that writes one float) and the
    kernel's time after a flush that leaves the L2 clean (``time_ms``'s
    flush leaves it full of dirty lines, which the kernel's reads must
    first write back).  ``only``: those (M, K, N) alone (and the ragged
    case)."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    one = torch.zeros(1, device=DEV)
    floor_ms = time_ms(one.zero_)
    print(f"  timing floor (one float written): {floor_ms:.5f} ms")
    rows = {}
    shapes = [(m, k, n) for k, n in MATMUL_SHAPES for m in (4, 64)]
    shapes += [(1, 2048, 8192), (16, 2048, 8192)]
    # gemma3-4b's down projection (phase 11, int8): K 10,240 past 8,192;
    # zamba2-2.7b's shared block (phase 12, int8): (2560, 2560) four times
    # and (2560, 10240) twice an application, its down projection as
    # gemma3's
    shapes += [(4, 10240, 2560), (64, 10240, 2560), (4, 2560, 2560),
               (64, 2560, 2560), (4, 2560, 10240), (64, 2560, 10240)]
    # the MoE decoders' attention projections (phase 13, int8; the experts
    # stay float): phi3.5-moe's q/o (4096, 4096) and k/v (4096, 1024),
    # dbrx-132b's (6144, 6144) and (6144, 1024)
    shapes += [(m, k, n) for k, n in ((4096, 4096), (4096, 1024),
                                      (6144, 6144), (6144, 1024))
               for m in (4, 64)]
    # seamless-m4t-large-v2 (phase 14, int8): the attention projections
    # and the cross K/V (1024, 1024), gate/up (1024, 8192), down (8192,
    # 1024), and the cross K/V over the whole encoder output (M 2,048 = B
    # 4 x S_enc 512)
    shapes += [(m, k, n) for k, n in ((1024, 1024), (1024, 8192),
                                      (8192, 1024))
               for m in (4, 64)] + [(2048, 1024, 1024)]
    shapes += list(QWEN_MATMUL_SHAPES)
    if only is not None:
        shapes = [sh for sh in shapes if sh in only]
    for m, k, n in shapes + [(5, 200, 300)]:
        x = torch.randint(-127, 128, (m, k), generator=gen, device=DEV,
                          dtype=torch.int8)
        w = torch.randint(-127, 128, (n, k), generator=gen, device=DEV,
                          dtype=torch.int8)
        xs = torch.rand(m, generator=gen, device=DEV) * 0.05 + 1e-4
        ws = torch.rand(n, generator=gen, device=DEV) * 0.05 + 1e-4
        out = ops.int8_matmul(x, w, xs, ws)
        torch.cuda.synchronize()
        want = ref.int8_matmul_ref(x, w, xs, ws)
        same = torch.equal(out, want)
        plan = im._plan(m, n, k)
        print(f"  int8_matmul M={m} K={k} N={n}: bitwise equal {same}"
              f"  ({plan.regime}, tile {plan.mt} x {plan.bn}, split"
              f" {plan.split}, grid {plan.grid})")
        check(same, f"int8_matmul differs from its plain version at"
              f" {(m, k, n)}: max |err| {float((out - want).abs().max())}")
        if (m, k, n) not in shapes:
            continue
        ms = time_ms(lambda: ops.int8_matmul(x, w, xs, ws))
        clean_ms = time_ms(lambda: ops.int8_matmul(x, w, xs, ws),
                           flush=flush_l2_clean)
        plain_ms = time_ms(lambda: ref.int8_matmul_ref(x, w, xs, ws))
        # torch._int_mm takes M > 16 only: M is padded to 32 for it
        xp = torch.zeros((max(m, 32), k), dtype=torch.int8, device=DEV)
        xp[:m] = x
        wt = w.t()
        lib_ms = time_ms(lambda: torch._int_mm(xp, wt))
        nbytes = m * k + n * k + 4 * (m + n) + 4 * m * n
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = work().int8_matmul_ops(m, n, k) / PEAK_OPS[torch.int8] \
            * 1e3
        bound = max(t_bytes, t_ops)
        rows[f"M{m}_K{k}_N{n}"] = {
            "max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": lib_ms, "share_of_bound": bound / ms,
            "factor_vs_library": ms / lib_ms, "clean_l2_ms": clean_ms,
            "timing_floor_ms": floor_ms}
        print(f"  int8_matmul M={m} K={k} N={n}: kernel {ms:.5f} ms (clean"
              f" L2 {clean_ms:.5f})  plain {plain_ms:.4f} ms  _int_mm (M"
              f" {max(m, 32)}) {lib_ms:.5f} ms  bound {bound:.5f} ms:"
              f" {bound / ms:.3f} of the bound, {ms / lib_ms:.2f}x _int_mm")
    return rows


def keyword_clips(port, n: int, n_classes: int, n_samples: int, seed: int):
    """``n`` keyword clips of ``n_samples`` (the port's generator), classes
    shuffled together: (n, n_samples) f32 numpy and the labels."""
    samples = port.synthetic.keyword_audio(
        n_per_class=-(-n // n_classes), n_classes=n_classes,
        n_samples=n_samples, seed=seed)
    order = np.random.RandomState(seed).permutation(len(samples))[:n]
    return (np.stack([samples[i].data for i in order]),
            np.asarray([samples[i].label for i in order]))


def mel_bound_ms(frames, nbins: int, n_mels: int) -> tuple:
    """Least time for one call: the signal under the frames read once
    (overlapping frames share it), the tables read once, the log-mel
    written once; 4·L·nbins + 2·nbins·n_mels operations a frame at the
    TF32 tensor-core rate (the kernel's DFT products run there, each as
    three TF32 products, so it can reach at most a third of this bound).
    Returns (bound ms, "bytes" or "operations", the same bound with the
    operations at the f32 CUDA-core rate, as it was stated before the
    products moved to the tensor cores)."""
    f3 = frames if frames.dim() == 3 else frames[None]
    nb, nf, l = f3.shape
    sf = f3.stride(1)
    span = (nf - 1) * sf + l if sf < l else nf * l
    n_frames = nb * nf
    nbytes = 4 * (nb * span + l + 2 * l * nbins + nbins * n_mels
                  + n_frames * n_mels)
    ops = work().mel_frontend_flops(n_frames, l, nbins, n_mels)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / TF32_OPS * 1e3
    t_f32 = max(t_bytes, ops / PEAK_OPS[torch.float32] * 1e3)
    return (max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations", t_f32)


def rfft_call(frames, window, mel_fb, n_fft: int):
    """The library yardstick, the same function through cuFFT and cuBLAS.
    For frame_len <= n_fft the zero-padded rfft is the DFT the tables
    hold; a longer frame (the tuner's 800 samples at n_fft 512) is folded
    modulo n_fft first, since the tables' angles repeat every n_fft
    samples."""
    l = frames.shape[-1]

    def run():
        xw = frames * window
        if l > n_fft:
            xw = F.pad(xw, (0, -l % n_fft)).unflatten(-1, (-1, n_fft)) \
                .sum(-2)
        spec = torch.fft.rfft(xw, n=n_fft)
        power = spec.real * spec.real + spec.imag * spec.imag
        return torch.log(torch.clamp(power @ mel_fb, min=1e-6))
    return run


def check_mel_frontend(port, clips):
    """``mel_frontend`` against its plain version at the Impulse path's
    shapes: the full-width batch of 512 one-second clips as the unfold
    view, the quickstart's MFCC frontend (32 mels, 0.5 s clips), ragged
    frame counts 1, 99 and 50,689, the kernel tests' dense shapes (L 256,
    129 bins; L 512, 257 bins), and silence (exactly the plain value,
    log(1e-6)), and the EON tuner's longest frames (L 800, 0.05 s, against
    n_fft 512 and 257 bins) at 40 and 32 mels on a fit batch of 32 clips,
    hops of 400 and 160.  Returns the timed rows by case."""
    blocks = port.dsp_blocks
    gen = torch.Generator(device=DEV).manual_seed(5)
    full = blocks.MFEBlock()
    quick = blocks.MFEBlock(n_mels=32)
    sig = torch.from_numpy(clips[:KWS_BATCH]).to(DEV)
    long_sig = torch.randn(50_688 * 160 + 320, generator=gen, device=DEV) \
        * 0.3
    cases = {
        "full_width_512x99": (blocks.frame_signal(sig, 320, 160),
                              full.tables(DEV), 512),
        "quickstart_64x49_32mels": (
            blocks.frame_signal(sig[:64, :8000], 320, 160),
            quick.tables(DEV), 512),
    }
    for f in (1, 99, 50_689):
        cases[f"ragged_F{f}"] = (
            blocks.frame_signal(long_sig[:(f - 1) * 160 + 320], 320, 160),
            full.tables(DEV), 512)
    rng = np.random.RandomState(3)
    for f, l, nbins, n_mels in ((128, 256, 129, 40), (256, 512, 257, 32)):
        kk = np.arange(nbins)[None, :] * np.arange(l)[:, None] * 2 * np.pi / l
        arrays = (rng.randn(f, l), np.hanning(l), np.cos(kk), -np.sin(kk),
                  rng.rand(nbins, n_mels))
        frames, *tables = (torch.from_numpy(a.astype(np.float32)).to(DEV)
                           for a in arrays)
        cases[f"dense_F{f}_L{l}_{nbins}bins"] = (frames, tables, l)
    silence = torch.zeros_like(sig)
    cases["silence_512x99"] = (blocks.frame_signal(silence, 320, 160),
                               full.tables(DEV), 512)
    for n_mels, stride_s in ((40, 0.025), (32, 0.01)):
        tuner = blocks.MFEBlock(frame_s=0.05, stride_s=stride_s,
                                n_mels=n_mels)
        frames = blocks.frame_signal(sig[:32], tuner.frame_len,
                                     tuner.stride)
        cases[f"tuner_L800_32x{frames.shape[1]}_{n_mels}mels"] = (
            frames, tuner.tables(DEV), 512)
    timed = ("full_width_512x99", "quickstart_64x49_32mels", "ragged_F99",
             "ragged_F50689", "dense_F128_L256_129bins",
             "dense_F256_L512_257bins", "tuner_L800_32x39_40mels",
             "tuner_L800_32x96_32mels")
    rows = {}
    print(f"  SM clock, power: {gpu_line('clocks.sm,power.draw')}")
    for name, (frames, tables, n_fft) in cases.items():
        out = port.ops.mel_frontend(frames, *tables)
        torch.cuda.synchronize()
        want = port.ref.mel_frontend_ref(frames, *tables)
        err = float((out - want).abs().max())
        print(f"  mel_frontend {name:26s} frames {tuple(frames.shape)}:"
              f" max|err| {err:.3g}")
        check(out.shape == want.shape and bool(out.isfinite().all()),
              f"mel_frontend {name}: shape {tuple(out.shape)} or non-finite")
        check(err <= MEL_ATOL, f"mel_frontend disagrees with its plain"
              f" version at {name}: {err} > {MEL_ATOL}")
        if name.startswith("silence"):
            floor = float(want.flatten()[0])
            check(torch.equal(out, want) and bool((out == floor).all())
                  and abs(floor - float(np.log(1e-6))) < 1e-5,
                  f"silence: not exactly log(1e-6) everywhere ({floor})")
        if name not in timed:
            continue
        window, cos, sin, mel = tables
        ms = time_ms(lambda: port.ops.mel_frontend(frames, *tables))
        plain_ms = time_ms(lambda: port.ref.mel_frontend_ref(frames,
                                                             *tables))
        lib = rfft_call(frames, window, mel, n_fft)
        lib_err = float((lib() - want).abs().max())
        lib_ms = time_ms(lib)
        b_ms, b_by, f32_ms = mel_bound_ms(frames, cos.shape[1],
                                          mel.shape[1])
        rows[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                      "bound_ms": b_ms, "bound_by": b_by,
                      "bound_f32_ms": f32_ms, "library_ms": lib_ms,
                      "library_max_abs_err": lib_err}
        print(f"  mel_frontend {name:26s} kernel {ms:.4f} ms  plain"
              f" {plain_ms:.4f} ms  rfft {lib_ms:.4f} ms (max|err|"
              f" {lib_err:.3g})  {ms / lib_ms:.2f}x rfft  bound"
              f" {b_ms:.5f} ms ({b_by}; {f32_ms:.5f} at the f32 rate)")
    return rows


def fa_pairs(s: int, causal: bool, window: int) -> int:
    """The (query, key) pairs the mask keeps in one (batch, head)."""
    return work().attention_pairs(s, causal, window)


def fa_bounds(b, s, hq, hkv, d, causal, window, skv=None) -> dict:
    """Least time of the forward and the backward, bf16: operations 4·D
    per kept (query, key) pair and head (two products), the backward 2.5
    times the forward's, at 989 TFLOP/s; bytes: each input read once,
    each output written once (forward: q, k, v -> out, lse; backward: q,
    k, v, out, dO, lse -> dQ, dK, dV), at 3.35 TB/s.  ``skv``: keys of
    another length than the S queries (every pair kept)."""
    pairs = s * skv if skv is not None else fa_pairs(s, causal, window)
    skv = s if skv is None else skv
    ops = work().attention_flops(d, pairs, b * hq)
    q_bytes, kv_bytes = 2 * b * s * hq * d, 2 * 2 * b * skv * hkv * d
    lse = 4 * b * hq * s
    out = {}
    for name, n_ops, n_bytes in (
            ("flash_attention", ops, 2 * q_bytes + kv_bytes + lse),
            ("flash_attention_bwd", work().ATTENTION_BWD_FACTOR * ops,
             4 * q_bytes + 2 * kv_bytes + lse)):
        t_ops = n_ops / PEAK_OPS[torch.bfloat16] * 1e3
        t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
        out[name] = (max(t_ops, t_bytes),
                     "operations" if t_ops >= t_bytes else "bytes")
    return out


def sdpa_train_calls(q, k, v, do, causal, window):
    """The library yardstick of both training kernels:
    ``F.scaled_dot_product_attention`` on the same bf16 inputs laid out
    (B, H, S, D) with the KV heads repeated beforehand, and its backward
    through autograd."""
    g = q.shape[2] // k.shape[2]
    qs, ks, vs = (t.transpose(1, 2).contiguous() for t in
                  (q, k.repeat_interleave(g, 2), v.repeat_interleave(g, 2)))
    dos = do.transpose(1, 2).contiguous()
    mask = None
    if window > 0:
        i = torch.arange(q.shape[1], device=q.device)
        mask = (i[None, :] > i[:, None] - window) & \
            ((i[None, :] <= i[:, None]) if causal else True)
    kw = dict(attn_mask=mask, is_causal=causal and mask is None)
    leaves = [t.clone().requires_grad_() for t in (qs, ks, vs)]
    out = F.scaled_dot_product_attention(*leaves, **kw)
    return (lambda: F.scaled_dot_product_attention(qs, ks, vs, **kw),
            lambda: torch.autograd.grad(out, leaves, dos, retain_graph=True))


def grad_reading(got: torch.Tensor, want: torch.Tensor,
                 atol: float = FA_GRAD_ATOL) -> tuple:
    """A bf16 gradient against its f32 plain value: (reading, share of the
    limit).  The reading is the largest excess of |got - want| over the
    output's rounding, 2^-8 |want|, in units of want's median magnitude;
    the limit is that rounding plus ``atol`` of the median."""
    w = want.abs()
    med = float(w.median())
    diff = (got.float() - want).abs()
    return (float((diff - 2.0 ** -8 * w).max()) / med,
            float((diff / (2.0 ** -8 * w + atol * med)).max()))


def rounding_share(want: torch.Tensor, atol: float = FA_GRAD_ATOL) -> float:
    """``grad_reading``'s share of the limit for ``want`` rounded once to
    bf16: what a backward whose only error is its output's rounding reads.
    Round to nearest moves a value by up to 2^-8 of itself, the limit's
    own rounding term, so a large value can read close to 1."""
    w = want.abs()
    diff = (want.to(torch.bfloat16).float() - want).abs()
    return float((diff / (2.0 ** -8 * w + atol * w.median())).max())


def bwd_rounded_once(ref, q, k, v, out, do, causal=True, window=0,
                     q_pos=None, k_pos=None):
    """``ref.flash_attention_bwd_ref`` as a bf16 backward without the
    kernel's split of P and dS into a high and a low bf16 half computes
    it: P rounded once to bf16 before dV = Pᵀ dO, dS rounded once before
    dQ = dS K and dK = dSᵀ Q, the products summed in f32, the gradients
    returned in q.dtype."""
    b, _, h, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    qf, kf, vf, of, dof = (t.float() for t in (q, k, v, out, do))
    kf, vf = kf.repeat_interleave(g, dim=2), vf.repeat_interleave(g, dim=2)
    p, mask = ref._attention_probs(qf, kf, causal, window, q_pos, k_pos)
    rowdot = (dof * of).sum(-1).transpose(1, 2)
    ds = p * (torch.einsum("bqhd,bkhd->bhqk", dof, vf) - rowdot[..., None])
    if mask is not None:
        ds = torch.where(mask, ds, 0.0)
    p, ds = (t.to(torch.bfloat16).float() for t in (p, ds))
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf) * (d ** -0.5)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf) * (d ** -0.5)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dof)
    dk, dv = (t.reshape(b, skv, hkv, g, d).sum(3) for t in (dk, dv))
    return tuple(t.to(q.dtype) for t in (dq, dk, dv))


def fa_planted_faults(fa, ref, q, k, v, out, lse, do, grads, want,
                      atol=FA_GRAD_ATOL, **kw):
    """The gradient check must fail three planted faults (shares of the
    limit, each above 1): dK/dV of a kernel that skips its last query tile
    (``FA_TILE_Q`` rows) in the dK/dV pass -- the kernel's own backward
    with dO zeroed on those rows, which then add nothing to dK and dV --,
    each gradient 10% too large on the second half of the sequence, and
    the control of the limit's tightness: ``bwd_rounded_once``, one bf16
    rounding of P (read in dV) or of dS (in dQ and dK)."""
    do_cut = do.clone()
    do_cut[:, -FA_TILE_Q:] = 0
    _, dk_cut, dv_cut = fa.flash_attention_bwd(q, k, v, out, lse, do_cut,
                                               **kw)
    s = q.shape[1]
    faults = {"skip_last_q_tile_dk": grad_reading(dk_cut, want[1], atol)[1],
              "skip_last_q_tile_dv": grad_reading(dv_cut, want[2], atol)[1]}
    for gname, got, w in zip(("dq", "dk", "dv"), grads, want):
        scaled = got.clone()
        scaled[:, s // 2:] *= 1.1
        faults[f"late_half_x1.1_{gname}"] = grad_reading(scaled, w, atol)[1]
    once = bwd_rounded_once(ref, q, k, v, out, do, **kw)
    for gname, got, w in zip(("ds_bf16_once_dq", "ds_bf16_once_dk",
                              "p_bf16_once_dv"), once, want):
        faults[gname] = grad_reading(got, w, atol)[1]
    return faults


def check_flash_attention(port):
    """Both training kernels against their plain versions at ``FA_CASES``
    (bf16): the output against ``flash_attention_ref`` at the bf16 limit
    of ``TOL``; dQ/dK/dV against ``flash_attention_bwd_ref`` in f32 on the
    same inputs and the kernel's output, by ``grad_reading``, and at the
    training shape the planted faults of ``fa_planted_faults``; prints the
    readings (what ``FA_GRAD_ATOL`` is set from).  Returns each kernel's
    timed rows by case."""
    fa, ref = port.fa, port.ref
    gen = torch.Generator(device=DEV).manual_seed(7)
    rows = {"flash_attention": {}, "flash_attention_bwd": {}}
    readings = {}
    for name, (b, s, hq, hkv, d, causal, window) in FA_CASES.items():
        kw = dict(causal=causal, window=window)
        q, do = (torch.randn(b, s, hq, d, generator=gen, device=DEV)
                 .to(torch.bfloat16) for _ in range(2))
        k, v = (torch.randn(b, s, hkv, d, generator=gen, device=DEV)
                .to(torch.bfloat16) for _ in range(2))
        out, lse = fa.flash_attention_fwd(q, k, v, **kw)
        grads = fa.flash_attention_bwd(q, k, v, out, lse, do, **kw)
        torch.cuda.synchronize()
        f32 = [t.float() for t in (q, k, v)]
        want_out = ref.flash_attention_ref(*f32, causal, window)
        want = ref.flash_attention_bwd_ref(*f32, out.float(), do.float(),
                                           causal, window)
        f_err = float((out.float() - want_out).abs().max())
        f_ratio = tol_ratio(out, want_out)
        check(out.dtype == torch.bfloat16 and bool(out.isfinite().all())
              and f_ratio <= 1, f"flash_attention disagrees with its plain"
              f" version at {name}: {f_ratio} of the limit")
        g_err, g_read, g_share = [], [], []
        for gname, got, w in zip(("dq", "dk", "dv"), grads, want):
            reading, ratio = grad_reading(got, w)
            g_err.append(float((got.float() - w).abs().max()))
            g_read.append(reading)
            g_share.append(ratio)
            check(got.dtype == torch.bfloat16
                  and bool(got.isfinite().all()) and ratio <= 1,
                  f"flash_attention_bwd {gname} disagrees with the plain"
                  f" backward at {name}: {ratio} of the limit")
        readings[name] = dict(zip(("dq", "dk", "dv"), g_read))
        print(f"  flash_attention {name:16s} max|err| {f_err:.3g}"
              f" ({f_ratio:.3f} of the limit); backward max|err| dq/dk/dv"
              f" {g_err[0]:.3g}/{g_err[1]:.3g}/{g_err[2]:.3g}, beyond the"
              f" rounding {max(g_read):.3g} of the median value; shares of"
              f" the limit dq/dk/dv {g_share[0]:.4f}/{g_share[1]:.4f}/"
              f"{g_share[2]:.4f}")
        if name == FA_FAULT_CASE:
            faults = fa_planted_faults(fa, ref, q, k, v, out, lse, do,
                                       grads, want, **kw)
            print(f"  planted faults at {name}, shares of the limit:"
                  f" {json.dumps(faults)}")
            check(min(faults.values()) > 1, f"the gradient check passes a"
                  f" planted fault: {faults}")
        del f32, want_out, want
        kern = {"flash_attention": lambda: fa.flash_attention_fwd(q, k, v,
                                                                  **kw),
                "flash_attention_bwd": lambda: fa.flash_attention_bwd(
                    q, k, v, out, lse, do, **kw)}
        plain = {"flash_attention": lambda: ref.flash_attention_ref(
                     q, k, v, causal, window),
                 "flash_attention_bwd": lambda: ref.flash_attention_bwd_ref(
                     q, k, v, out, do, causal, window)}
        lib_f, lib_b = sdpa_train_calls(q, k, v, do, causal, window)
        lib = {"flash_attention": lib_f, "flash_attention_bwd": lib_b}
        bounds = fa_bounds(b, s, hq, hkv, d, causal, window)
        for kname, err in (("flash_attention", f_err),
                           ("flash_attention_bwd", max(g_err))):
            ms = time_ms(kern[kname], reps=10)
            plain_ms = time_ms(plain[kname], reps=10)
            lib_ms = time_ms(lib[kname], reps=10)
            b_ms, b_by = bounds[kname]
            rows[kname][name] = {"max_abs_err": err, "ms": ms,
                                 "plain_ms": plain_ms, "bound_ms": b_ms,
                                 "bound_by": b_by, "library_ms": lib_ms}
            print(f"  {kname:19s} {name:16s} kernel {ms:.4f} ms  plain"
                  f" {plain_ms:.4f} ms  sdpa {lib_ms:.4f} ms  bound"
                  f" {b_ms:.5f} ms ({b_by}): {b_ms / ms:.3f} of the"
                  f" bound, {ms / lib_ms:.2f}x sdpa")
        del plain, lib, lib_f, lib_b
    worst = max(max(r.values()) for r in readings.values())
    print(f"  flash_attention_bwd readings (median values beyond the"
          f" rounding): {json.dumps(readings)}; largest {worst:.4g}, limit"
          f" FA_GRAD_ATOL {FA_GRAD_ATOL}")
    return rows


# flash_attention at gemma3-4b's shapes (B 1, S 2048, 8/4 heads of 256):
# the global layers (causal) and the local ones (window 1,024), and packed
# rows with pads (by position); name: (B, S, Hq, Hkv, D, causal, window[,
# positions])
FA_D256_CASES = {"d256_s2048": (1, 2048, 8, 4, 256, True, 0),
                 "d256_window1024_s2048": (1, 2048, 8, 4, 256, True, 1024),
                 "d256_packed_b2_s1000": (2, 1000, 8, 4, 256, True, 0,
                                          "packed")}
# and at zamba2-2.7b's (its shared block: B 1, S 2048, 32/32 heads of 80,
# causal), with a ragged S
FA_D80_CASES = {"d80_s2048": (1, 2048, 32, 32, 80, True, 0),
                "d80_s1000": (1, 1000, 32, 32, 80, True, 0)}


def check_flash_attention_wide(port, cases):
    """Both training kernels at the head dims of 80 and 256 (``cases``),
    bf16 and f32 at every case, against their plain versions as
    ``check_attention_cases`` holds them (the gradients' term
    ``FA_WIDE_GRAD_ATOL``); returns each kernel's bf16 rows by case."""
    return check_attention_cases(port, cases, tuple(cases), seed=9,
                                 grad_atol=FA_WIDE_GRAD_ATOL)


# flash_attention with keys of another length (seamless-m4t-large-v2's
# cross-attention, phase 14: 16/16 heads of 64, causal=False): the
# training shape (B 2, S 2,048 on S_enc 512), a ragged pair, and the
# encoder's own bidirectional attention (B 4, S 512); name: (B, Sq, Skv,
# Hq, Hkv, D)
FA_CROSS_CASES = {"cross_b2_s2048_skv512": (2, 2048, 512, 16, 16, 64),
                  "cross_b2_s1000_skv250": (2, 1000, 250, 16, 16, 64),
                  "encoder_b4_s512": (4, 512, 512, 16, 16, 64)}


def check_flash_attention_cross(port, cases=FA_CROSS_CASES):
    """Both training kernels at ``causal=False`` with Sq != Skv (and the
    encoder's Sq == Skv), bf16, against their plain versions as
    ``check_flash_attention`` holds them (the output at the bf16 limit,
    dQ/dK/dV by ``grad_reading``; f32 at its limit too), timed against
    the plain versions, SDPA (which takes Sq != Skv) and the bound.
    Returns each kernel's rows by case."""
    fa, ref = port.fa, port.ref
    gen = torch.Generator(device=DEV).manual_seed(19)
    rows = {"flash_attention": {}, "flash_attention_bwd": {}}
    for name, (b, sq, skv, hq, hkv, d) in cases.items():
        for dtype in (torch.float32, torch.bfloat16):
            q, do = (torch.randn(b, sq, hq, d, generator=gen, device=DEV)
                     .to(dtype) for _ in range(2))
            k, v = (torch.randn(b, skv, hkv, d, generator=gen, device=DEV)
                    .to(dtype) for _ in range(2))
            out, lse = fa.flash_attention_fwd(q, k, v, causal=False)
            grads = fa.flash_attention_bwd(q, k, v, out, lse, do,
                                           causal=False)
            torch.cuda.synchronize()
            f32 = [t.float() for t in (q, k, v)]
            want_out = ref.flash_attention_ref(*f32, False)
            want = ref.flash_attention_bwd_ref(*f32, out.float(),
                                               do.float(), False)
            f_err = float((out.float() - want_out).abs().max())
            f_ratio = tol_ratio(out, want_out)
            check(out.dtype == dtype and bool(out.isfinite().all())
                  and f_ratio <= 1 and tuple(lse.shape) == (b, hq, sq),
                  f"flash_attention disagrees with its plain version at"
                  f" {name} {dtype}: {f_ratio} of the limit")
            g_err, g_ratio = [], []
            for gname, got, w in zip(("dq", "dk", "dv"), grads, want):
                check(got.shape == w.shape, f"{gname} {tuple(got.shape)}")
                g_err.append(float((got.float() - w).abs().max()))
                if dtype == torch.bfloat16:
                    ratio = grad_reading(got, w)[1]
                else:
                    ratio = float((got - w).abs().max()
                                  / (2.0 ** -16 * w.abs().max()))
                g_ratio.append(ratio)
                check(bool(got.isfinite().all()) and ratio <= 1,
                      f"flash_attention_bwd {gname} disagrees with the"
                      f" plain backward at {name} {dtype}: {ratio} of the"
                      f" limit")
            print(f"  flash_attention {name:22s} {str(dtype):15s} max|err|"
                  f" {f_err:.3g} ({f_ratio:.3f} of the limit); backward"
                  f" dq/dk/dv {g_err[0]:.3g}/{g_err[1]:.3g}/{g_err[2]:.3g}"
                  f" ({max(g_ratio):.3f} of the limit)")
            del f32, want_out, want
        g = hq // hkv
        qs, ks, vs, dos = (t.transpose(1, 2).contiguous() for t in
                           (q, k.repeat_interleave(g, 2),
                            v.repeat_interleave(g, 2), do))
        leaves = [t.clone().requires_grad_() for t in (qs, ks, vs)]
        lib_out = F.scaled_dot_product_attention(*leaves)
        lib = {"flash_attention":
                   lambda: F.scaled_dot_product_attention(qs, ks, vs),
               "flash_attention_bwd": lambda: torch.autograd.grad(
                   lib_out, leaves, dos, retain_graph=True)}
        kern = {"flash_attention": lambda: fa.flash_attention_fwd(
                    q, k, v, causal=False),
                "flash_attention_bwd": lambda: fa.flash_attention_bwd(
                    q, k, v, out, lse, do, causal=False)}
        plain = {"flash_attention": lambda: ref.flash_attention_ref(
                     q, k, v, False),
                 "flash_attention_bwd": lambda: ref.flash_attention_bwd_ref(
                     q, k, v, out, do, False)}
        bounds = fa_bounds(b, sq, hq, hkv, d, False, 0, skv)
        for kname, err in (("flash_attention", f_err),
                           ("flash_attention_bwd", max(g_err))):
            ms = time_ms(kern[kname], reps=10)
            plain_ms = time_ms(plain[kname], reps=10)
            lib_ms = time_ms(lib[kname], reps=10)
            b_ms, b_by = bounds[kname]
            rows[kname][name] = {"max_abs_err": err, "ms": ms,
                                 "plain_ms": plain_ms, "bound_ms": b_ms,
                                 "bound_by": b_by, "library_ms": lib_ms}
            print(f"  {kname:19s} {name:22s} kernel {ms:.4f} ms  plain"
                  f" {plain_ms:.4f} ms  sdpa {lib_ms:.4f} ms  bound"
                  f" {b_ms:.5f} ms ({b_by}): {b_ms / ms:.3f} of the"
                  f" bound, {ms / lib_ms:.2f}x sdpa")
        del plain, lib, lib_out, leaves
    return rows


# flash_attention masked by position (phase 15, qwen2-vl-72b: 64/8 heads of
# 128): Qwen2-VL's image positions (64 text tokens, an image of 1 x 32 x 32
# patches on one temporal position, then text from one past its largest
# id) at B 1, S 2,048, bf16 and f32 (FA_POS_F32); packed rows (B 2, S
# 1,000, two sequences a row, pads at -1), causal and with a window of
# 256; name: (B, S, Hq, Hkv, D, causal, window, positions)
FA_POS_CASES = {
    "vlm_image_b1_s2048": (1, 2048, 64, 8, 128, True, 0, "image"),
    "packed_b2_s1000": (2, 1000, 64, 8, 128, True, 0, "packed"),
    "packed_window256_b2_s1000": (2, 1000, 64, 8, 128, True, 256, "packed")}
FA_POS_F32 = ("vlm_image_b1_s2048",)
# the packed rows: each row's second sequence starts at the cut, and its
# last entries are pads
FA_PACKED_CUTS, FA_PACKED_PADS = (400, 550), (37, 11)


def image_positions(port, segments, b=1):
    """(B, S, 3) int32 on the card: Qwen2-VL's three streams of one
    sequence of ``segments`` (``api.mrope_positions``), every row alike."""
    pos = port.api.mrope_positions(segments, DEV)
    return pos[None].expand(b, *pos.shape).contiguous()


def fa_case_positions(port, kind, b, s):
    """The (B, S) int32 positions of a ``FA_POS_CASES`` case: the temporal
    stream of the image layout, or packed rows."""
    if kind == "image":
        return image_positions(port, [("text", 64), ("image", (1, 32, 32)),
                                      ("text", s - 1088)], b)[..., 0] \
            .contiguous()
    rows = []
    for i in range(b):
        cut, pad = FA_PACKED_CUTS[i % 2], FA_PACKED_PADS[i % 2]
        row = torch.cat([torch.arange(cut), torch.arange(s - cut)])
        row[s - pad:] = -1
        rows.append(row)
    return torch.stack(rows).to(torch.int32).to(DEV)


def fa_pos_bounds(b, s, hq, hkv, d, pairs) -> dict:
    """``fa_bounds`` for the position masks: operations on the visible
    (query, key) pairs these positions give (``pairs``, over the batch),
    bytes as there plus the positions (int32, queries and keys)."""
    ops = work().attention_flops(d, pairs, hq)
    q_bytes, kv_bytes = 2 * b * s * hq * d, 2 * 2 * b * s * hkv * d
    lse, pos = 4 * b * hq * s, 2 * 4 * b * s
    out = {}
    for name, n_ops, n_bytes in (
            ("flash_attention", ops, 2 * q_bytes + kv_bytes + lse + pos),
            ("flash_attention_bwd", work().ATTENTION_BWD_FACTOR * ops,
             4 * q_bytes + 2 * kv_bytes + lse + pos)):
        t_ops = n_ops / PEAK_OPS[torch.bfloat16] * 1e3
        t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
        out[name] = (max(t_ops, t_bytes),
                     "operations" if t_ops >= t_bytes else "bytes")
    return out


def sdpa_masked_calls(q, k, v, do, mask):
    """The library yardstick of the position kernels: SDPA with the same
    boolean mask (B, 1, S, S) on the KV heads repeated beforehand, and its
    backward through autograd.  The flash backend takes no mask: the
    memory-efficient one is asked for."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    g = q.shape[2] // k.shape[2]
    qs, ks, vs = (t.transpose(1, 2).contiguous() for t in
                  (q, k.repeat_interleave(g, 2), v.repeat_interleave(g, 2)))
    dos = do.transpose(1, 2).contiguous()

    def fwd(*args):
        with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
            return F.scaled_dot_product_attention(*args, attn_mask=mask)
    leaves = [t.clone().requires_grad_() for t in (qs, ks, vs)]
    out = fwd(*leaves)
    return (lambda: fwd(qs, ks, vs),
            lambda: torch.autograd.grad(out, leaves, dos, retain_graph=True))


def check_flash_attention_positions(port, cases=FA_POS_CASES):
    """``check_attention_cases`` at the position masks' ``cases``
    (``FA_POS_F32`` in f32 too)."""
    return check_attention_cases(port, cases, FA_POS_F32, seed=23)


def check_attention_cases(port, cases, f32_cases, seed,
                          grad_atol=FA_GRAD_ATOL):
    """Both training kernels against their plain versions at ``cases``
    (B, S, Hq, Hkv, D, causal, window[, positions]: index masks, or the
    position masks of ``fa_case_positions``), in bf16 and, for
    ``f32_cases``, f32 too: the output at the limit of ``TOL`` (every row:
    a pad query's mean of V too, finite), dQ/dK/dV by ``grad_reading``
    (f32: 2^-16 of the largest value; bf16: ``grad_atol`` of the median
    beside the rounding), each bf16 case also failing
    ``fa_planted_faults``; each bf16 row timed against the plain versions,
    SDPA (with the same mask) and the bound on the visible pairs.
    Returns each kernel's rows by case."""
    fa, ref = port.fa, port.ref
    gen = torch.Generator(device=DEV).manual_seed(seed)
    rows = {"flash_attention": {}, "flash_attention_bwd": {}}
    for name, case in cases.items():
        b, s, hq, hkv, d, causal, window = case[:7]
        pos = fa_case_positions(port, case[7], b, s) if len(case) > 7 \
            else None
        kw = dict(causal=causal, window=window, q_pos=pos, k_pos=pos)
        dtypes = (torch.float32, torch.bfloat16) if name in f32_cases \
            else (torch.bfloat16,)
        for dtype in dtypes:
            q, do = (torch.randn(b, s, hq, d, generator=gen, device=DEV)
                     .to(dtype) for _ in range(2))
            k, v = (torch.randn(b, s, hkv, d, generator=gen, device=DEV)
                    .to(dtype) for _ in range(2))
            out, lse = fa.flash_attention_fwd(q, k, v, **kw)
            grads = fa.flash_attention_bwd(q, k, v, out, lse, do, **kw)
            torch.cuda.synchronize()
            f32 = [t.float() for t in (q, k, v)]
            want_out = ref.flash_attention_ref(*f32, causal, window, pos,
                                               pos)
            want = ref.flash_attention_bwd_ref(*f32, out.float(), do.float(),
                                               causal, window, pos, pos)
            f_err = float((out.float() - want_out).abs().max())
            f_ratio = tol_ratio(out, want_out)
            check(out.dtype == dtype and bool(out.isfinite().all())
                  and bool(lse.isfinite().all()) and f_ratio <= 1,
                  f"flash_attention disagrees with its plain version at"
                  f" {name} {dtype}: {f_ratio} of the limit")
            g_err, g_ratio, detail = [], [], {}
            for gname, got, w in zip(("dq", "dk", "dv"), grads, want):
                g_err.append(float((got.float() - w).abs().max()))
                if dtype == torch.bfloat16:
                    reading, ratio = grad_reading(got, w, grad_atol)
                    detail[gname] = dict(
                        share=ratio, reading=reading,
                        rounding_share=rounding_share(w, grad_atol))
                else:
                    ratio = float((got - w).abs().max()
                                  / (2.0 ** -16 * w.abs().max()))
                g_ratio.append(ratio)
            print(f"  flash_attention {name:26s} {str(dtype):15s} max|err|"
                  f" {f_err:.3g} ({f_ratio:.3f} of the limit); backward"
                  f" dq/dk/dv {g_err[0]:.3g}/{g_err[1]:.3g}/{g_err[2]:.3g}"
                  f" ({max(g_ratio):.3f} of the limit)")
            if dtype == torch.bfloat16:
                # each gradient's share beside the share of its own
                # rounding to bf16
                print(f"  by gradient (share of the limit, reading beyond"
                      f" the rounding, share of the rounding alone):"
                      f" {json.dumps(detail)}")
            for gname, got, w, ratio in zip(("dq", "dk", "dv"), grads, want,
                                            g_ratio):
                check(got.dtype == dtype and got.shape == w.shape
                      and bool(got.isfinite().all()) and ratio <= 1,
                      f"flash_attention_bwd {gname} disagrees with the plain"
                      f" backward at {name} {dtype}: {ratio} of the limit")
            if dtype == torch.bfloat16:
                faults = fa_planted_faults(fa, ref, q, k, v, out, lse, do,
                                           grads, want, grad_atol, **kw)
                print(f"  planted faults at {name}, shares of the limit:"
                      f" {json.dumps(faults)}")
                check(min(faults.values()) > 1, f"the gradient check passes"
                      f" a planted fault at {name}: {faults}")
            del f32, want_out, want
        extra = {}
        if pos is None:
            lib_f, lib_b = sdpa_train_calls(q, k, v, do, causal, window)
            bounds = fa_bounds(b, s, hq, hkv, d, causal, window)
            lib_name = "sdpa"
        else:
            mask = ref.attention_mask(s, s, causal, window, pos, pos)
            pairs = int(mask.sum())
            extra = {"visible_pairs": pairs,
                     "rows_seeing_no_key": int((~mask.any(-1)).sum()),
                     "library": "SDPA, memory-efficient backend, boolean"
                                " mask"}
            lib_f, lib_b = sdpa_masked_calls(q, k, v, do, mask)
            bounds = fa_pos_bounds(b, s, hq, hkv, d, pairs)
            lib_name = "sdpa(efficient, mask)"
            del mask
        kern = {"flash_attention": lambda: fa.flash_attention_fwd(
                    q, k, v, **kw),
                "flash_attention_bwd": lambda: fa.flash_attention_bwd(
                    q, k, v, out, lse, do, **kw)}
        plain = {"flash_attention": lambda: ref.flash_attention_ref(
                     q, k, v, causal, window, pos, pos),
                 "flash_attention_bwd": lambda: ref.flash_attention_bwd_ref(
                     q, k, v, out, do, causal, window, pos, pos)}
        lib = {"flash_attention": lib_f, "flash_attention_bwd": lib_b}
        for kname, err in (("flash_attention", f_err),
                           ("flash_attention_bwd", max(g_err))):
            ms = time_ms(kern[kname], reps=10)
            plain_ms = time_ms(plain[kname], reps=10)
            lib_ms = time_ms(lib[kname], reps=10)
            b_ms, b_by = bounds[kname]
            rows[kname][name] = {"max_abs_err": err, "ms": ms,
                                 "plain_ms": plain_ms, "bound_ms": b_ms,
                                 "bound_by": b_by, "library_ms": lib_ms,
                                 **extra}
            print(f"  {kname:19s} {name:26s} kernel {ms:.4f} ms  plain"
                  f" {plain_ms:.4f} ms  {lib_name} {lib_ms:.4f} ms  bound"
                  f" {b_ms:.5f} ms ({b_by}): {b_ms / ms:.3f} of the bound,"
                  f" {ms / lib_ms:.2f}x sdpa")
        del plain, lib, lib_f, lib_b
    return rows


def scan_inputs(gen, b, s, d, n, dtype, with_h0):
    """The JAX kernel test's distributions, drawn on the card: x, B, C ~
    N(0, 0.5), dt = softplus(N(0, 0.5)), a = -exp(N(0, 0.3)), h0 ~ N(0, 1)
    or None."""
    def normal(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=DEV) * scale
    x, bm, cm = (normal(*shape, scale=0.5).to(dtype)
                 for shape in ((b, s, d), (b, s, n), (b, s, n)))
    dt = F.softplus(normal(b, s, d, scale=0.5)).to(dtype)
    a = -torch.exp(normal(d, n, scale=0.3))
    h0 = normal(b, d, n) if with_h0 else None
    return x, dt, bm, cm, a, h0


def scan_bound_ms(b, s, d, n, dtype, with_h0) -> tuple:
    """Least time for one scan: x, dt, B and C read once in their dtype, A
    and h0 once, y and h_final written once in f32; 7 f32 operations a
    (t, d, n) and 1 a (t, d)."""
    es = torch.tensor([], dtype=dtype).element_size()
    nbytes = (es * 2 * b * s * (d + n) + 4 * d * n
              + 4 * b * d * n * (2 if with_h0 else 1) + 4 * b * s * d)
    ops = work().mamba_scan_flops(b, s, d, n)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[torch.float32] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def check_mamba_scan(port):
    """``mamba_scan`` against its plain version at ``MAMBA_CASES``, within
    ``MAMBA_TOL`` of each output's largest magnitude, and the dt = 0 pad
    tail bitwise; returns the timed rows by case."""
    ops, ref = port.ops, port.ref
    gen = torch.Generator(device=DEV).manual_seed(9)
    rows = {}
    for name, (b, s, d, n, dtype, with_h0) in MAMBA_CASES.items():
        args = scan_inputs(gen, b, s, d, n, dtype, with_h0)
        y, h = ops.mamba_scan(*args)
        torch.cuda.synchronize()
        want_y, want_h = ref.mamba_scan_ref(*args)
        reading = scan_reading(y, h, want_y, want_h)
        err = max(float((y - want_y).abs().max()),
                  float((h - want_h).abs().max()))
        print(f"  mamba_scan {name:20s}: reading {reading:.3g} of the"
              f" largest magnitude (limit {MAMBA_TOL:.3g}), max|err| {err:.3g}")
        check(y.shape == (b, s, d) and h.shape == (b, d, n)
              and bool(y.isfinite().all()) and bool(h.isfinite().all()),
              f"mamba_scan {name}: shapes {tuple(y.shape)} {tuple(h.shape)}"
              " or non-finite")
        check(reading <= MAMBA_TOL, f"mamba_scan disagrees with its plain"
              f" version at {name}: {reading} > {MAMBA_TOL}")
        if name not in MAMBA_TIMED:
            continue
        ms = time_ms(lambda: ops.mamba_scan(*args))
        # the plain version launches about nine kernels a step: few
        # repeats, so that they are queued behind the spin kernel (at S
        # 2048 one call alone outlasts it, and the host's launch rate is
        # timed)
        plain_ms = time_ms(lambda: ref.mamba_scan_ref(*args),
                           reps=max(1, min(30, 192 // s)), warmup=1)
        b_ms, b_by = scan_bound_ms(b, s, d, n, dtype, with_h0)
        rows[name] = {"max_abs_err": err, "reading": reading, "ms": ms,
                      "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                      "library_ms": None, "library": MAMBA_LIBRARY}
        print(f"  mamba_scan {name:20s} kernel {ms:.5f} ms  plain"
              f" {plain_ms:.4f} ms  bound {b_ms:.6f} ms ({b_by}),"
              f" {b_ms / ms:.3f} of it")
    # a ragged chunk's pad tail (dt = 0) against the real prefix alone
    x, dt, bm, cm, a, h0 = scan_inputs(gen, 2, 64, 8192, 16, torch.bfloat16,
                                       True)
    real = 37
    masked = dt.clone()
    masked[:, real:] = 0
    y, h = ops.mamba_scan(x, masked, bm, cm, a, h0)
    y_cut, h_cut = ops.mamba_scan(*(t[:, :real] for t in (x, dt, bm, cm)),
                                  a, h0)
    torch.cuda.synchronize()
    same = torch.equal(h, h_cut) and torch.equal(y[:, :real], y_cut)
    print(f"  mamba_scan pad tail (dt = 0 past {real} of 64): final state and"
          f" real outputs bitwise equal to the real prefix's {same}")
    check(same, "mamba_scan: a dt = 0 pad tail changed the state")
    return rows


# The scan's backward against its plain version on the same inputs, each
# gradient read as the largest |kernel - plain| beyond the output's own
# rounding (2^-8 of |plain| for the bf16 gradients dx, ddt, dB and dC; none
# for dA and dh0, f32), over that gradient's largest magnitude.  Twice the
# largest reading on the H100 (1.30e-6, dA of the carried case), rounded
# up to a power of two (PERF.md gives the readings).
MAMBA_BWD_TOL = 2.0 ** -18
# name: (B, S, D, N, dtype, carried-in state and a gradient of the final
# state): falcon-mamba's training shape, a ragged carried one, the smoke
# width in f32
MAMBA_BWD_CASES = {
    "train_b1_s2048": (1, 2048, 8192, 16, torch.bfloat16, False),
    "carried_b2_s1000": (2, 1000, 8192, 16, torch.bfloat16, True),
    "f32_smoke_b2_s256": (2, 256, 128, 8, torch.float32, True)}
MAMBA_BWD_TIMED = ("train_b1_s2048",)
MAMBA_BWD_NAMES = ("dx", "ddt", "dB", "dC", "dA", "dh0")


def scan_bwd_readings(got, want) -> dict:
    """Each gradient's reading (``MAMBA_BWD_TOL``'s units) against the
    plain gradients in f32."""
    out = {}
    for name, g, w in zip(MAMBA_BWD_NAMES, got, want):
        w = w.float()
        rounding = 2.0 ** -8 if g.dtype == torch.bfloat16 else 0.0
        excess = (g.float() - w).abs() - rounding * w.abs()
        out[name] = float(excess.max().clamp(min=0)) / float(w.abs().max())
    return out


def scan_bwd_bound_ms(b, s, d, n, dtype, carried) -> tuple:
    """Least time of the backward: x, dt, B and C read once in their
    dtype, dy (f32), A, and h0 and dh_final where given, once; dx, ddt, dB
    and dC written once in the dtype, dA and dh0 in f32.  Operations: 20
    f32 a (t, d, n): the state h[t] (3) and its decay (2), the carried
    gradient (3), and the sums of dx, ddt, dA, dB and dC (12)."""
    es = torch.tensor([], dtype=dtype).element_size()
    nbytes = (es * 4 * b * s * (d + n) + 4 * b * s * d + 4 * 2 * d * n
              + 4 * b * d * n * (3 if carried else 1))
    ops = work().mamba_scan_bwd_flops(b, s, d, n)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[torch.float32] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def scan_bwd_split(ms_, args, cut) -> list:
    """The planted fault ``split_without_carry``: the backward of the
    same inputs as two independent calls cut at step ``cut``, with no
    state carried into the second nor gradient into the first; their
    gradients joined (dA summed, dh0 from the first)."""
    x, dt, bm, cm, a, h0, dy, dhf = args

    def part(t, lo, hi):
        return t[:, lo:hi].contiguous()
    s = x.shape[1]
    first = ms_.mamba_scan_bwd(*(part(t, 0, cut) for t in (x, dt, bm, cm)),
                               a, h0, part(dy, 0, cut), None)
    second = ms_.mamba_scan_bwd(*(part(t, cut, s) for t in (x, dt, bm, cm)),
                                a, None, part(dy, cut, s), dhf)
    return ([torch.cat([u, v], dim=1) for u, v in zip(first[:4], second[:4])]
            + [first[4] + second[4], first[5]])


def check_mamba_scan_bwd(port):
    """``mamba_scan_bwd`` against ``mamba_scan_bwd_ref`` at
    ``MAMBA_BWD_CASES`` (dy ~ N(0, 1) and, where carried, h0 and dh_final
    ~ N(0, 1)), within ``MAMBA_BWD_TOL``; two runs give the same bits
    (fixed-order sums); four planted faults must fail: the final state's
    gradient dropped, the last segment's dy dropped (a kernel that skips
    its last segment), each gradient 10% too large on the second half of
    the sequence, and the sequence cut at a segment boundary into two
    calls that carry nothing across (``scan_bwd_split``).  Returns the
    timed rows by case."""
    ms_, ref = port.ms, port.ref
    gen = torch.Generator(device=DEV).manual_seed(31)
    rows, readings = {}, {}
    for name, (b, s, d, n, dtype, carried) in MAMBA_BWD_CASES.items():
        x, dt, bm, cm, a, h0 = scan_inputs(gen, b, s, d, n, dtype, carried)
        dy = torch.randn(b, s, d, generator=gen, device=DEV)
        dhf = (torch.randn(b, d, n, generator=gen, device=DEV) if carried
               else None)
        args = (x, dt, bm, cm, a, h0, dy, dhf)
        got = ms_.mamba_scan_bwd(*args)
        again = ms_.mamba_scan_bwd(*args)
        torch.cuda.synchronize()
        # the plain version in f32 from the same values: its gradients
        # unrounded, so that the reading sees the kernel's one rounding
        want = ref.mamba_scan_bwd_ref(*(None if t is None else t.float()
                                        for t in args))
        same = all(torch.equal(u, w) for u, w in zip(got, again))
        read = scan_bwd_readings(got, want)
        readings[name] = read
        err = max(float((g.float() - w.float()).abs().max())
                  for g, w in zip(got, want))
        print(f"  mamba_scan_bwd {name:18s} readings {json.dumps(read)}"
              f" (limit {MAMBA_BWD_TOL:.3g}), max|err| {err:.3g}, two runs"
              f" bitwise equal {same}")
        check(same, f"mamba_scan_bwd {name}: two runs differ")
        dtypes = [dtype] * 4 + [torch.float32] * 2
        check(all(g.shape == w.shape and g.dtype == t
                  and bool(g.isfinite().all())
                  for g, w, t in zip(got, want, dtypes)),
              f"mamba_scan_bwd {name}: shapes, dtypes or non-finite")
        check(max(read.values()) <= MAMBA_BWD_TOL, f"mamba_scan_bwd"
              f" disagrees with its plain version at {name}: {read}")
        if carried:
            segments = ms_.segment_ranges(s)
            dy_cut = dy.clone()
            dy_cut[:, segments[-1][0]:] = 0
            late = [g.clone() for g in got]
            for g in late[:4]:
                g[:, s // 2:] *= 1.1
            split = scan_bwd_split(ms_, args, segments[len(segments) // 2][0])
            faults = {
                "drop_dh_final": max(scan_bwd_readings(ms_.mamba_scan_bwd(
                    *args[:7], None), want).values()),
                "skip_last_chunk": max(scan_bwd_readings(ms_.mamba_scan_bwd(
                    *args[:6], dy_cut, dhf), want).values()),
                **{f"late_half_x1.1_{k}": scan_bwd_readings(late, want)[k]
                   for k in MAMBA_BWD_NAMES[:4]},
                "split_without_carry": max(scan_bwd_readings(
                    split, want).values())}
            faults = {k: v / MAMBA_BWD_TOL for k, v in faults.items()}
            print(f"  planted faults at {name}, shares of the limit:"
                  f" {json.dumps(faults)}")
            check(min(faults.values()) > 1, f"the scan gradient check passes"
                  f" a planted fault: {faults}")
        del want
        if name not in MAMBA_BWD_TIMED:
            continue
        ms = time_ms(lambda: ms_.mamba_scan_bwd(*args), reps=10)
        plain_ms = time_ms(lambda: ref.mamba_scan_bwd_ref(*args), reps=1,
                           warmup=1)
        b_ms, b_by = scan_bwd_bound_ms(b, s, d, n, dtype, carried)
        rows[name] = {"max_abs_err": err, "readings": read, "ms": ms,
                      "plain_ms": plain_ms, "bound_ms": b_ms,
                      "bound_by": b_by, "library_ms": None,
                      "library": MAMBA_LIBRARY}
        print(f"  mamba_scan_bwd {name:18s} kernel {ms:.4f} ms  plain"
              f" {plain_ms:.2f} ms  bound {b_ms:.5f} ms ({b_by}),"
              f" {b_ms / ms:.3f} of it")
    worst = max(max(r.values()) for r in readings.values())
    print(f"  mamba_scan_bwd readings: largest {worst:.4g}, limit"
          f" MAMBA_BWD_TOL {MAMBA_BWD_TOL:.4g}")
    return rows


# ---------------------------------------------------------------------------
# Phase 3: full-width serving
# ---------------------------------------------------------------------------
def reset_counts(port) -> None:
    for mod in (port.fd, port.im, port.mf, port.fa, port.ms):
        mod.reset_launches()


def read_counts(port) -> dict:
    return {**port.fd.LAUNCHES, **port.im.LAUNCHES, **port.mf.LAUNCHES,
            **port.fa.LAUNCHES, **port.ms.LAUNCHES}


def full_config(port, layers=SERVE_LAYERS):
    """internlm2-1.8b at its full width, cut to ``layers`` of its 24."""
    cfg = port.configs.get("internlm2-1.8b")
    check(cfg.n_layers == 24 and cfg.d_model == 2048
          and cfg.padded_vocab() == 94208, f"unexpected config {cfg}")
    return dataclasses.replace(cfg, n_layers=layers)


def serve_full(port, cfg):
    t0 = time.perf_counter()
    params = port.init_params(cfg, torch.Generator(device=DEV).manual_seed(0),
                              DEV)
    torch.cuda.synchronize()
    print(f"  weights: {sum(p.numel() for p in params.parameters())} params"
          f" in {time.perf_counter() - t0:.1f} s")
    kw = dict(slots=4, prefill_chunk=64, max_new_tokens=32, max_prompt=512,
              device=DEV)
    warm = port.server.ContinuousBatchServer(cfg, params, **kw)
    warm.submit([np.arange(9, dtype=np.int32)], max_new_tokens=2)
    warm.run()
    del warm

    rng = np.random.RandomState(0)
    lens = [9, 37, 64, 128, 200, 301, 450, 512]
    prompts = [rng.randint(0, cfg.vocab_size, n).astype(np.int32)
               for n in lens]
    srv = port.server.ContinuousBatchServer(cfg, params, **kw)
    check(srv.capacity == 576, f"capacity {srv.capacity} != 576")
    reqs = srv.submit(prompts)
    reset_counts(port)
    torch.cuda.synchronize()
    metrics = srv.run()
    torch.cuda.synchronize()
    launches = read_counts(port)
    vpad = cfg.padded_vocab()
    for r in reqs:
        check(len(r.tokens) == 32, f"request {r.rid}: {len(r.tokens)} tokens")
        check(all(0 <= t < vpad for t in r.tokens),
              f"request {r.rid}: token out of [0, {vpad})")
    want = {name: 0 for name in launches}
    want.update(flash_decode=cfg.n_layers * metrics["decode_steps"],
                flash_chunk_prefill=cfg.n_layers * metrics["prefill_chunks"])
    check(launches == want, f"launches {launches} != layers x steps {want}")
    print(f"  launches {launches} = {cfg.n_layers} x (decode steps, chunk"
          f" steps)")
    print("  metrics " + json.dumps(metrics))
    return params, launches, metrics, eager_run(srv, prompts, reqs, kw,
                                                launches, metrics)


def small_config(port):
    """A float32 internlm2-shaped config at the narrowest widths the
    kernels take: 2 layers, d_model 256, 2/1 heads of 128."""
    return dataclasses.replace(port.configs.get_smoke("internlm2-1.8b"),
                               d_model=256, n_heads=2, n_kv_heads=1,
                               dtype="float32")


def serve_small_vs_cpu(port):
    """The repo's token-exactness oracle on a small input: the small
    float32 config served through the kernels on the card gives the same
    greedy tokens as the plain path on the CPU, on the prompts and budgets
    of the CPU parity test."""
    cfg = small_config(port)
    rng = np.random.RandomState(2)
    prompts = [rng.randint(0, cfg.vocab_size, n).astype(np.int32)
               for n in (3, 11, 7, 16)]
    budgets = [5, 4, 6, 3]
    host = port.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    tokens = {}
    for dev in ("cpu", DEV):
        srv = port.server.ContinuousBatchServer(
            cfg, host.to(dev), slots=2, max_prompt=16, prefill_chunk=4,
            max_new_tokens=8, device=dev)
        reqs = srv.submit(prompts, max_new_tokens=budgets)
        srv.run()
        tokens[dev] = [r.tokens for r in reqs]
    check(tokens[DEV] == tokens["cpu"],
          f"small float32 serving: card {tokens[DEV]} != cpu {tokens['cpu']}")
    print(f"  small float32 serving, card == cpu tokens: {tokens[DEV]}")


def serve_small_int8_vs_cpu(port):
    """The exact oracle at int8: the small float32 config, int8 weights,
    activations and KV cache, served through the kernels on the card gives
    the CPU plain path's tokens, through ``PagedBatchServer`` with blocks
    of 8 and a pool of 8 blocks for 3 slots (it preempts), and through
    ``StaticBatchServer``; three of the six prompts share a 16-token
    prefix, as in the CPU parity test."""
    cfg = small_config(port)
    rng = np.random.RandomState(5)
    prompts = [rng.randint(0, cfg.vocab_size, n).astype(np.int32)
               for n in (14, 15, 13)]
    base = rng.randint(0, cfg.vocab_size, 16).astype(np.int32)
    prompts += [np.concatenate([base, rng.randint(0, cfg.vocab_size, n)
                                .astype(np.int32)]) for n in (1, 3, 2)]
    budgets = [12, 10, 12, 5, 6, 4]
    host = port.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    engines = {
        "paged": (port.server.PagedBatchServer,
                  dict(slots=3, max_prompt=20, prefill_chunk=4,
                       max_new_tokens=12, block_size=8, pool_blocks=8)),
        "static": (port.server.StaticBatchServer,
                   dict(batch_size=2, max_prompt=20, prefill_chunk=4,
                        max_new_tokens=12)),
    }
    for name, (engine, kw) in engines.items():
        tokens, metrics = {}, {}
        for dev in ("cpu", DEV):
            srv = engine(cfg, host.to(dev), precision="int8", device=dev,
                         **kw)
            reqs = srv.submit(prompts, max_new_tokens=budgets)
            metrics[dev] = srv.run()
            tokens[dev] = [r.tokens for r in reqs]
        check(tokens[DEV] == tokens["cpu"],
              f"small int8 {name} serving: card {tokens[DEV]} != cpu"
              f" {tokens['cpu']}")
        if name == "paged":
            check(metrics[DEV]["preemptions"] >= 1
                  and metrics[DEV]["prefix_hit_blocks"] >= 1,
                  f"small int8 paged serving did not preempt and hit:"
                  f" {metrics[DEV]}")
            print(f"  small int8 paged serving: preemptions"
                  f" {metrics[DEV]['preemptions']}, prefix-hit blocks"
                  f" {metrics[DEV]['prefix_hit_blocks']}")
        print(f"  small int8 {name} serving, card == cpu tokens:"
              f" {tokens[DEV]}")


def calibrated_policy(port):
    return dataclasses.replace(port.quantize.INT8, activations="calibrated")


def serve_small_calibrated_vs_cpu(port):
    """The exact oracle with calibrated activations: the small float32
    config's weights quantized once, a calibrated amax attached per scope
    (``SMALL_AMAX``), served through ``ContinuousBatchServer`` on the card
    gives the CPU plain path's tokens on the prompts and budgets of the
    CPU parity test."""
    cfg, qz = small_config(port), port.quantize
    rng = np.random.RandomState(4)
    prompts = [rng.randint(0, cfg.vocab_size, n).astype(np.int32)
               for n in (3, 11, 7)]
    budgets = [5, 4, 6]
    host = port.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    qparams = qz.attach_act_amax(qz.quantize_model_params(host, qz.INT8),
                                 SMALL_AMAX)
    tokens = {}
    for dev in ("cpu", DEV):
        srv = port.server.ContinuousBatchServer(
            cfg, qparams.to(dev), slots=2, max_prompt=16, prefill_chunk=4,
            max_new_tokens=8, precision=calibrated_policy(port), device=dev)
        reqs = srv.submit(prompts, max_new_tokens=budgets)
        srv.run()
        tokens[dev] = [r.tokens for r in reqs]
    check(tokens[DEV] == tokens["cpu"],
          f"small calibrated int8 serving: card {tokens[DEV]} != cpu"
          f" {tokens['cpu']}")
    print(f"  small calibrated int8 continuous serving, card == cpu tokens:"
          f" {tokens[DEV]}")


def projection_sites(params) -> dict:
    """The address of each layer's int8 values -> its projection's scope
    name (``wq`` ... ``w_down``): the per-layer views the serving steps
    hand ``quant_matmul`` start there."""
    sites = {}
    for scope in ("attn", "mlp"):
        for name, qt in params["blocks"][scope].tree().items():
            for i in range(qt.q.shape[0]):
                sites[qt.q[i].data_ptr()] = name
    return sites


def serve_calibrated(port, cfg, params):
    """Full-width calibrated int8 serving through ``ContinuousBatchServer``
    on phase 3's requests.  A dynamic int8 run of the same requests feeds
    the calibration: each projection scope's amax is ``calibrate_amax``
    over the rows that run gave that scope's ``quant_matmul`` (recorded
    here, outside the package), attached with ``attach_act_amax``.  Then
    the calibrated run, counts set to 0 before it and read after: the
    kernels must launch as often as in the dynamic run.  Returns the
    calibrated server, its launches and metrics, and the greedy agreement
    with the dynamic run."""
    qz, layers = port.quantize, port.layers
    kw = dict(slots=4, prefill_chunk=64, max_new_tokens=32, max_prompt=512,
              device=DEV)
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, cfg.vocab_size, n).astype(np.int32)
               for n in (9, 37, 64, 128, 200, 301, 450, 512)]
    dyn = port.server.ContinuousBatchServer(cfg, params, precision="int8",
                                            **kw)
    sites = projection_sites(dyn.params)
    rows = {name: [] for name in set(sites.values())}
    kern = layers.quant_matmul

    def recording(x, w, *, policy=None):
        rows[sites[w.q.data_ptr()]].append(x.detach().abs().amax())
        return kern(x, w, policy=policy)

    dreqs = dyn.submit(prompts)
    reset_counts(port)
    with mock.patch.object(layers, "quant_matmul", recording):
        dyn.run()
    torch.cuda.synchronize()
    dyn_launches = read_counts(port)
    amax = {name: qz.calibrate_amax(r) for name, r in sorted(rows.items())}
    print("  calibrated amax by scope (from the dynamic run): "
          + json.dumps(amax))

    srv = port.server.ContinuousBatchServer(
        cfg, qz.attach_act_amax(dyn.params, amax),
        precision=calibrated_policy(port), **kw)
    reqs = srv.submit(prompts)
    reset_counts(port)
    torch.cuda.synchronize()
    metrics = srv.run()
    torch.cuda.synchronize()
    launches = read_counts(port)
    vpad = cfg.padded_vocab()
    for r in reqs:
        check(len(r.tokens) == 32, f"request {r.rid}: {len(r.tokens)} tokens")
        check(all(0 <= t < vpad for t in r.tokens),
              f"request {r.rid}: token out of [0, {vpad})")
    steps = metrics["decode_steps"] + metrics["prefill_chunks"]
    want = {name: 0 for name in launches}
    want.update(flash_decode=cfg.n_layers * metrics["decode_steps"],
                flash_chunk_prefill=cfg.n_layers * metrics["prefill_chunks"],
                int8_matmul=7 * cfg.n_layers * steps)
    check(launches == want, f"calibrated launches {launches} != step counts"
          f" {want}")
    check(launches == dyn_launches, f"calibrated launches {launches} !="
          f" the dynamic run's {dyn_launches}")
    same = sum(a == b for r, d in zip(reqs, dreqs)
               for a, b in zip(r.tokens, d.tokens))
    agreement = same / sum(len(r.tokens) for r in reqs)
    print(f"  launches {launches} = the dynamic run's; greedy tokens equal"
          f" to the dynamic int8 run's on {same} of"
          f" {sum(len(r.tokens) for r in reqs)}")
    print("  metrics " + json.dumps(metrics, default=str))
    return srv, launches, metrics, agreement, eager_run(
        srv, prompts, reqs, dict(kw, precision=srv.prec), launches, metrics)


class Steps:
    """The serving path's chunk and decode steps on one 4-slot cache of
    ``capacity`` entries (576 by default): contiguous, or (``paged``) a
    pool of 4 x capacity / 64 blocks of 64 entries in a scrambled block
    table; under ``policy``."""

    def __init__(self, port, cfg, params, policy, paged: bool, seed: int,
                 capacity: int = 576):
        ss, kc = port.serve_step, port.kvcache
        self.params, self.paged = params, paged
        if paged:
            n_tbl = capacity // 64
            self._chunk = ss.make_paged_chunk_prefill_step(cfg, policy)
            self._decode = ss.make_paged_decode_step(cfg, policy)
            self.cache = kc.alloc_paged_cache(cfg, 4, capacity, 4 * n_tbl,
                                              DEV, policy, 64)
            gen = torch.Generator(device=DEV).manual_seed(seed)
            self.table = torch.randperm(4 * n_tbl, generator=gen,
                                        device=DEV) \
                .to(torch.int32).reshape(4, n_tbl)
        else:
            self._chunk = ss.make_chunk_prefill_step(cfg, policy)
            self._decode = ss.make_slot_decode_step(cfg, policy)
            self.cache = kc.alloc_decode_cache(cfg, 4, capacity, DEV, policy)

    def chunk(self, cache, slot, toks, poss, kvl):
        if self.paged:
            return self._chunk(self.params, cache, toks, poss, kvl,
                               self.table[slot:slot + 1], slot)
        return self._chunk(self.params, cache, toks, poss, slot, kvl)

    def decode(self, cache, tok, pos, kvl):
        if self.paged:
            return self._decode(self.params, cache, tok, pos, kvl,
                                self.table)
        return self._decode(self.params, cache, tok, pos, kvl)

    @staticmethod
    def copy(cache):
        return {key: (type(leaf)(*(t.clone() for t in leaf))
                      if isinstance(leaf, tuple) else leaf.clone())
                for key, leaf in cache.items()}


def rounded_once(ref, kind, dtype=torch.float32):
    """The plain attention in f32 (or ``dtype``) from the same inputs (int8
    dequantized and rounded as the kernels do), rounded once to the
    working dtype, as the kernels compute it."""
    def call(q, k, v, *args, **kw):
        inputs = (t.to(dtype) for t in f32_inputs(q, k, v))
        return plain_attention(ref, kind, *inputs, *args, **kw).to(q.dtype)
    return call


def checked(kern, ref, kind, worst, name):
    """``kern``, with each call's output held against the plain version on
    the same inputs (f32) at the kernel tolerance; the worst ratio to the
    limit goes to ``worst[name]``."""
    def call(q, k, v, *args, **kw):
        out = kern(q, k, v, *args, **kw)
        want = plain_attention(ref, kind, *f32_inputs(q, k, v), *args, **kw)
        worst[name] = max(worst.get(name, 0.0), tol_ratio(out, want))
        return out
    return call


def attention_paths(port) -> SimpleNamespace:
    """The serving path's attention through the kernels (each call held
    against the plain version at the kernel tolerance, the worst ratio to
    the limit in ``wiring``), through the plain attention ``rounded_once``
    with the plain int8 matmul, and the same in float64: each a list of
    patches."""
    layers, ops, ref = port.layers, port.ops, port.ref
    wiring = {}
    plain_matmul = mock.patch.object(ops, "int8_matmul",
                                     ref.int8_matmul_ref)
    return SimpleNamespace(
        kernel=[mock.patch.multiple(
            layers,
            decode_attention=checked(ops.decode_attention, ref, "decode",
                                     wiring, "flash_decode"),
            chunk_attention=checked(ops.chunk_attention, ref, "chunk",
                                    wiring, "flash_chunk_prefill"))],
        plain=[mock.patch.multiple(
            layers, decode_attention=rounded_once(ref, "decode"),
            chunk_attention=rounded_once(ref, "chunk")), plain_matmul],
        plain64=[mock.patch.multiple(
            layers,
            decode_attention=rounded_once(ref, "decode", torch.float64),
            chunk_attention=rounded_once(ref, "chunk", torch.float64)),
            plain_matmul],
        wiring=wiring, kernels={"flash_decode", "flash_chunk_prefill"})


def scan_reading(y, h, want_y, want_h) -> float:
    """The larger of y's and the final state's largest |kernel - plain|,
    each over that output's largest magnitude."""
    return max(float((y - want_y).abs().max() / want_y.abs().max()),
               float((h - want_h).abs().max() / want_h.abs().max()))


def scan_paths(port) -> SimpleNamespace:
    """The mamba1 layers' scan through the kernel (each call held against
    the plain version on the same inputs, the worst ratio to ``MAMBA_TOL``
    in ``wiring``) and through the plain scan; there is no float64 path."""
    ops, ref = port.ops, port.ref
    kern, wiring = ops.mamba_scan, {}

    def checked_scan(*args):
        y, h = kern(*args)
        ratio = scan_reading(y, h, *ref.mamba_scan_ref(*args)) / MAMBA_TOL
        wiring["mamba_scan"] = max(wiring.get("mamba_scan", 0.0), ratio)
        return y, h
    return SimpleNamespace(
        kernel=[mock.patch.object(ops, "mamba_scan", checked_scan)],
        plain=[mock.patch.object(ops, "mamba_scan", ref.mamba_scan_ref)],
        plain64=None, wiring=wiring, kernels={"mamba_scan"})


def patched(patches) -> contextlib.ExitStack:
    stack = contextlib.ExitStack()
    for patch in patches:
        stack.enter_context(patch)
    return stack


def logits_vs_plain(port, cfg, params, atol, greedy_min, paths,
                    policy=None, paged=False, seeds=(1, 2, 3, 4),
                    capacity=576, fill_chunks=(1, 6)):
    """Serving steps through the kernels against the same steps through
    the plain path (``attention_paths``: attention ``rounded_once`` and
    the plain int8 matmul; ``scan_paths``: the plain scan) on a copy of
    the same cache.

    For each seed: slots 1 and 3 are filled with ``fill_chunks`` (1..5
    by default) chunks of a cache of ``capacity`` entries, then a full
    chunk step (slot 1), a ragged chunk step (slot 3, 1..63 real rows) and
    two decode steps (slots 1 and 3 live, 0 and 2 idle) are compared on
    their live rows.  Inside the kernel runs every kernel call of every
    layer is also held against the plain version on its own inputs, at
    the kernel tolerance: that check sees each layer's inputs without the
    layers' amplification of rounding.  The logits must agree at
    ``atol``, and the greedy tokens on at least ``greedy_min`` of the
    compared rows.  Where the paths have one, the same steps through the
    plain path in float64 (attention rounded once) give the noise floor of
    both measures: what a difference of summation order alone does to the
    logits.

    An MoE config's plain paths take the kernel path's expert ids and
    drops, call for call (``MoEPin``): a choice that flips on a near tie
    would send the rows on different trajectories, and the logits would
    then differ by what the random experts make of it, not by the
    kernels' error.  Each plain path's own choices are counted where they
    differ from the ids it took."""
    wiring = paths.wiring
    pins = {key: MoEPin(port) for key in ("kernel", "plain", "plain64")} \
        if cfg.is_moe else None

    def pinned(key):
        if pins is None:
            return contextlib.nullcontext()
        if key == "kernel":
            return pins[key].patch()
        kernel = pins["kernel"]
        return pins[key].patch(lambda i: kernel.ids[i],
                               lambda i: kernel.keeps[i])

    def ints(a):
        return torch.as_tensor(np.asarray(a, np.int32), device=DEV)

    readings = []
    for seed in seeds:
        rng = np.random.RandomState(seed)
        steps = Steps(port, cfg, params, policy, paged, seed, capacity)
        cache = steps.cache
        fill = {0: 0, 1: 0, 2: 0, 3: 0}

        def chunk_run(slot, n_real):
            toks = np.zeros((1, 64), np.int32)
            poss = np.full((1, 64), -1, np.int32)
            toks[0, :n_real] = rng.randint(0, cfg.vocab_size, n_real)
            poss[0, :n_real] = np.arange(fill[slot], fill[slot] + n_real)
            args = (ints(toks), ints(poss), ints([fill[slot] + 64]))
            fill[slot] += n_real
            return lambda c: steps.chunk(c, slot, *args)[1][0, :n_real]

        def decode_run():
            live = [1, 3]
            tok = ints([rng.randint(cfg.vocab_size) if i in live else 0
                        for i in range(4)])
            pos = ints([fill[i] for i in range(4)])
            kvl = ints([fill[i] + 1 if i in live else 0 for i in range(4)])
            for i in live:
                fill[i] += 1
            return lambda c: steps.decode(c, tok, pos, kvl)[1][live]

        with patched(paths.kernel):
            for slot in (1, 3):
                for _ in range(rng.randint(*fill_chunks)):
                    chunk_run(slot, 64)(cache)
        runs = [("chunk", lambda: chunk_run(1, 64)),
                ("chunk_ragged", lambda: chunk_run(3, rng.randint(1, 64))),
                ("decode", decode_run), ("decode", decode_run)]
        for name, make in runs:
            run = make()
            copy, copy64 = Steps.copy(cache), Steps.copy(cache)
            with patched(paths.kernel), pinned("kernel"):
                got = run(cache).float()
            with patched(paths.plain), pinned("plain"):
                want = run(copy).float()
            for key in cache:
                if key.endswith("_pos"):
                    check(torch.equal(cache[key], copy[key]),
                          f"{name}: stored positions {key} differ")
            same = got.argmax(-1) == want.argmax(-1)
            readings.append(dict(
                seed=seed, step=name, rows=int(got.shape[0]),
                fill=[fill[1], fill[3]],
                max_abs_gap=float((got - want).abs().max()),
                logit_std=float(want.std()), argmax_equal=int(same.sum())))
            if pins is not None:
                check(len(pins["kernel"].ids) == len(pins["plain"].ids)
                      == cfg.n_layers and pins["plain"].count("unmatched")
                      == 0, f"{name}: the plain path's routing not pinned")
                readings[-1].update(
                    routing_choices=pins["plain"].count("choices"),
                    routing_differ=pins["plain"].count("differ"),
                    rows_dropped=pins["kernel"].drops()[0])
            if paths.plain64 is not None:
                with patched(paths.plain64), pinned("plain64"):
                    alt = run(copy64).float()
                readings[-1].update(
                    f64_gap=float((alt - want).abs().max()),
                    f64_argmax_equal=int((alt.argmax(-1) == want.argmax(-1))
                                         .sum()))
                if pins is not None:
                    readings[-1]["f64_routing_differ"] = \
                        pins["plain64"].count("differ")
            print("  logits " + json.dumps(readings[-1]))
    worst_gap = max(r["max_abs_gap"] for r in readings)
    equal = sum(r["argmax_equal"] for r in readings)
    rows = sum(r["rows"] for r in readings)
    print(f"  serving logits: largest gap {worst_gap:.4g} over"
          f" {len(readings)} steps (atol {atol}); greedy tokens equal"
          f" on {equal} of {rows} rows; every layer's kernel call within"
          f" {json.dumps(wiring)} of the kernel limit")
    if pins is not None:
        print(f"  routing (the plain paths take the kernel path's expert"
              f" ids): the plain path's own top k differs in"
              f" {sum(r['routing_differ'] for r in readings)} of"
              f" {sum(r['routing_choices'] for r in readings)} choices"
              f" (every row of every MoE layer, pad rows and idle slots"
              f" too), the float64 path's in"
              f" {sum(r.get('f64_routing_differ', 0) for r in readings)}")
    if paths.plain64 is not None:
        print(f"  noise floor, plain f32 vs plain f64 attention: largest gap"
              f" {max(r['f64_gap'] for r in readings):.4g}, greedy tokens"
              f" equal on {sum(r['f64_argmax_equal'] for r in readings)} of"
              f" {rows} rows")
    check(set(wiring) == paths.kernels and max(wiring.values()) <= 1,
          f"a kernel call of the serving path disagrees with its plain"
          f" version: {wiring}")
    check(worst_gap <= atol, f"serving logits disagree: {worst_gap}")
    check(equal >= greedy_min * rows,
          f"greedy tokens equal on only {equal} of {rows} rows")
    return readings


# ---------------------------------------------------------------------------
# Phase 4: where a step's time goes
# ---------------------------------------------------------------------------
def _merged_us(spans) -> float:
    total, end = 0.0, float("-inf")
    for ts, dur in sorted(spans):
        if ts >= end:
            total += dur
        elif ts + dur > end:
            total += ts + dur - end
        end = max(end, ts + dur)
    return total


def trace_calls(calls, n: int):
    """Host wall ms per call of ``calls(i)``, i < n, ending in a sync; then
    one ``torch.profiler`` pass over the same calls.  The pass starts with
    one more call outside its timed range, since a session can miss the
    first kernel it sees.  Returns the wall ms and the trace's kernel and
    copy events that start inside the timed range."""
    trace = Path(__file__).resolve().parent / "build" / "profile.json"
    trace.parent.mkdir(exist_ok=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(n):
        calls(i)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / n
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        calls(0)
        torch.cuda.synchronize()
        with torch.profiler.record_function("timed_calls"):
            for i in range(n):
                calls(i)
            torch.cuda.synchronize()
    prof.export_chrome_trace(str(trace))
    events = json.loads(trace.read_text())["traceEvents"]
    trace.unlink()
    start = min(e["ts"] for e in events if e.get("name") == "timed_calls")
    timed = [e for e in events if e.get("ts", -1) >= start]
    return (wall_ms, [e for e in timed if e.get("cat") == "kernel"],
            [e for e in timed if e.get("cat") == "gpu_memcpy"])


def profile_steps(port, cfg, params, policy=None, paged=False):
    """Host wall time of decode steps (4 slots at fill 257..264) and chunk
    steps (64 tokens into slot 0 at fill 384..512), each ending in a host
    read of its tokens as in the server; then one ``torch.profiler`` pass
    over the same steps for device time by kernel family."""
    steps = Steps(port, cfg, params, policy, paged, 0)
    cache = steps.cache
    rng = np.random.RandomState(2)

    def ints(a):
        return torch.as_tensor(np.asarray(a, np.int32), device=DEV)

    def chunk_at(slot, c0):
        return steps.chunk(cache, slot,
                           ints(rng.randint(0, cfg.vocab_size, (1, 64))),
                           ints(np.arange(c0, c0 + 64)[None]), ints([c0 + 64]))

    for slot in range(4):
        for c0 in range(0, 256, 64):
            chunk_at(slot, c0)
    calls = {
        "decode": (lambda i: steps.decode(
            cache, ints(rng.randint(0, cfg.vocab_size, 4)),
            ints([256 + i] * 4), ints([257 + i] * 4)), 8),
        "chunk": (lambda i: chunk_at(0, 320 + 64 * (i % 3)), 3),
    }
    return {name: profile_step(name, step, n)
            for name, (step, n) in calls.items()}


KERNEL_FAMILIES = ("attention", "int8_matmul", "mamba_scan",
                   "mamba_scan_bwd", "gemm", "other")


def kernel_family(name: str) -> str:
    """A profiled kernel's family by its name: every kernel of the scan's
    backward (summary, combine, main, sum) names ``mamba_scan_bwd``."""
    low = name.lower()
    return ("attention" if "attn_kernel" in low else
            "int8_matmul" if "int8_mm_kernel" in low else
            "mamba_scan_bwd" if "mamba_scan_bwd" in low else
            "mamba_scan" if "mamba_scan_kernel" in low else
            "gemm" if any(w in low for w in GEMM_NAMES) else "other")


def profile_step(name: str, step, n: int, quiet: bool = False) -> dict:
    """``step(i)`` once to warm, then ``trace_calls`` over ``n`` calls,
    each ending in a host read of its tokens: host wall, device busy, idle
    share, kernels a step and device time by kernel family."""
    step(0)[0].cpu()
    wall_ms, kernels, _ = trace_calls(lambda i: step(i)[0].cpu(), n)
    fam = dict.fromkeys(KERNEL_FAMILIES, 0.0)
    by_name = {}
    for e in kernels:
        fam[kernel_family(e["name"])] += e["dur"] / 1e3 / n
        by_name[e["name"][:60]] = by_name.get(e["name"][:60], 0.0) \
            + e["dur"] / 1e3 / n
    busy = _merged_us([(e["ts"], e["dur"]) for e in kernels]) / 1e3 / n
    out = dict(host_wall_ms=wall_ms, device_busy_ms=busy,
               idle_share=1 - busy / wall_ms if wall_ms else None,
               kernels_per_step=len(kernels) / n,
               **{f"{k}_ms": v for k, v in fam.items()})
    print(f"  {name} step: " + json.dumps(out))
    if not quiet:
        print(f"  {name} step: attention_ms {fam['attention']:.4f}"
              f"  int8_matmul_ms {fam['int8_matmul']:.4f}  device_busy_ms"
              f" {busy:.4f}  kernels_per_step {len(kernels) / n:g}")
        for kname, ms in sorted(by_name.items(), key=lambda x: -x[1])[:6]:
            print(f"    {ms:.4f} ms/step  {kname}")
    return out


# ---------------------------------------------------------------------------
# Phase 5: the int8 paged path
# ---------------------------------------------------------------------------
def shared_prefix_prompts(cfg) -> list:
    """Phase 5's eight prompts (seeded): four share a 256-token prefix."""
    rng = np.random.RandomState(0)
    prefix = rng.randint(0, cfg.vocab_size, 256).astype(np.int32)
    spec = [(True, 44), (False, 450), (False, 512), (False, 200),
            (True, 100), (True, 37), (True, 150), (False, 64)]
    return [np.concatenate([prefix, rng.randint(0, cfg.vocab_size, n)
                            .astype(np.int32)]) if shared
            else rng.randint(0, cfg.vocab_size, n).astype(np.int32)
            for shared, n in spec]


def serve_int8_paged(port, cfg, params):
    """Full-width int8 serving through ``PagedBatchServer`` with a pool
    that preempts and prompts that share a prefix; returns the server (its
    quantized weights serve the later checks), its launches and metrics."""
    kw = dict(slots=4, prefill_chunk=64, max_new_tokens=32, max_prompt=512,
              precision="int8", device=DEV)
    warm = port.server.PagedBatchServer(cfg, params, **kw)
    warm.submit([np.arange(9, dtype=np.int32)], max_new_tokens=2)
    warm.run()
    del warm

    prompts = shared_prefix_prompts(cfg)
    srv = port.server.PagedBatchServer(cfg, params, pool_blocks=16, **kw)
    check((srv.capacity, srv.block_size, srv.n_table) == (576, 64, 9),
          f"capacity/block/table {srv.capacity}/{srv.block_size}/"
          f"{srv.n_table} != 576/64/9")
    reqs = srv.submit(prompts)
    reset_counts(port)
    torch.cuda.synchronize()
    metrics = srv.run()
    torch.cuda.synchronize()
    launches = read_counts(port)
    vpad = cfg.padded_vocab()
    for r in reqs:
        check(len(r.tokens) == 32, f"request {r.rid}: {len(r.tokens)} tokens")
        check(all(0 <= t < vpad for t in r.tokens),
              f"request {r.rid}: token out of [0, {vpad})")
    check(metrics["preemptions"] >= 1, f"no preemption: {metrics}")
    check(metrics["prefix_hit_blocks"] >= 1, f"no prefix hit: {metrics}")
    steps = metrics["decode_steps"] + metrics["prefill_chunks"]
    want = {name: 0 for name in launches}
    want.update(flash_decode=cfg.n_layers * metrics["decode_steps"],
                flash_chunk_prefill=cfg.n_layers * metrics["prefill_chunks"],
                int8_matmul=7 * cfg.n_layers * steps)
    check(launches == want, f"launches {launches} != step counts {want}")
    print(f"  launches {launches} = {cfg.n_layers} x (decode steps, chunk"
          f" steps), 7 x {cfg.n_layers} x all steps")
    kvb = {prec: port.kvcache.kv_cache_bytes(cfg, 4, 576, precision=prec)
           for prec in ("float", "int8")}
    print(f"  kv_cache_bytes of the 4 x 576 rectangle by the formula: int8"
          f" {kvb['int8']}, bf16 {kvb['float']}; the int8 pool of 16 blocks"
          f" holds {metrics['kv_cache_bytes']}")
    print("  metrics " + json.dumps(metrics))
    return srv, launches, metrics, eager_run(
        srv, prompts, reqs, dict(kw, pool_blocks=16), launches, metrics)


# ---------------------------------------------------------------------------
# Phase 6: the full-width KWS Impulse (DSP block -> DS-CNN, float and int8)
# ---------------------------------------------------------------------------
def profile_calls(calls, n: int) -> dict:
    """``trace_calls`` over ``n`` Impulse calls: device busy (merged kernel
    spans), the idle share, the mel kernel's share, copies."""
    wall_ms, kernels, copies = trace_calls(calls, n)
    mel = [e["dur"] for e in kernels if "mel_frontend_kernel" in e["name"]]
    busy = _merged_us([(e["ts"], e["dur"]) for e in kernels]) / 1e3 / n
    mel_ms = sum(mel) / 1e3 / n
    by_name = {}
    for e in kernels:
        by_name[e["name"][:60]] = by_name.get(e["name"][:60], 0.0) \
            + e["dur"] / 1e3 / n
    top = sorted(by_name.items(), key=lambda x: -x[1])[:8]
    return dict(host_wall_ms=wall_ms, device_busy_ms=busy,
                idle_share=1 - busy / wall_ms, mel_kernel_ms=mel_ms,
                mel_kernels_seen=len(mel), other_kernels_ms=busy - mel_ms,
                copy_ms=sum(e["dur"] for e in copies) / 1e3 / n,
                kernels_per_call=len(kernels) / n,
                top_kernels_ms=[[k, v] for k, v in top])


def top2_gap(logits: torch.Tensor) -> torch.Tensor:
    top = logits.topk(2, dim=-1).values
    return top[:, 0] - top[:, 1]


def card_vs_cpu(port, imp, xs, name: str, every_label: bool = False
                ) -> dict:
    """The same weights and clips through the port's CPU path: float and
    int8 logits within ``KWS_LOGIT_ATOL``, labels equal wherever the CPU's
    top-two gap exceeds it (``every_label``: on every row), and the PTQ
    trees bitwise equal."""
    tree = port.tree
    cpu = port.Impulse(imp.dsp, imp.learn, imp.input_shape,
                       params=tree.map_tree(lambda t: t.cpu(), imp.params),
                       device="cpu")
    out = {}
    for kind, fn in (("float", "logits"), ("int8", "logits_int8")):
        if kind == "int8":
            imp.quantize(xs[:16])
            cpu.quantize(xs[:16])
        got = getattr(imp, fn)(xs).cpu()
        want = getattr(cpu, fn)(xs)
        gap = float((got - want).abs().max())
        clear = top2_gap(want) > KWS_LOGIT_ATOL
        same = got.argmax(-1) == want.argmax(-1)
        out[kind] = dict(max_abs_gap=gap, rows=int(got.shape[0]),
                         clear_rows=int(clear.sum()),
                         labels_equal=int(same.sum()),
                         min_top2_gap=float(top2_gap(want).min()))
        print(f"  {name} card vs cpu, {kind}: " + json.dumps(out[kind]))
        check(gap <= KWS_LOGIT_ATOL, f"{name} {kind} logits: card vs cpu"
              f" gap {gap} > {KWS_LOGIT_ATOL}")
        check(bool(same.all() if every_label else same[clear].all()),
              f"{name} {kind}: labels differ between the card and the CPU")
    for part in ("q", "scales"):
        same = tree.map_tree(
            lambda a, b: a is None if b is None else torch.equal(a.cpu(), b),
            getattr(imp.qparams, part), getattr(cpu.qparams, part))
        check(all(tree.leaves(same)), f"{name}: PTQ {part} differ between"
              " the card and the CPU")
    return out


def kws_impulse(port, clips):
    """DS-CNN at the repo's defaults on the MFE block's defaults, random
    weights from a seeded generator on the card: 2,048 one-second clips in
    batches of 512, 32 single-clip calls split into DSP and NN time, then
    PTQ on 16 clips and the int8 logits of the 2,048.  The counts are set
    to 0 before and read after; ``mel_frontend`` must have launched once
    per features call.  Then the idle share, the card against the CPU on
    64 clips, and the quickstart Impulse's labels against the CPU's."""
    cb = port.core_blocks
    imp = port.Impulse(cb.make_dsp_block("mfe"), cb.make_learn_block("ds-cnn"),
                       input_shape=16_000, device=DEV)
    check((imp.learn.cfg.n_classes, imp.learn.cfg.n_filters,
           imp.learn.cfg.n_blocks, imp.dsp.impl.n_mels,
           imp.dsp.impl.frame_len, imp.dsp.impl.stride,
           imp.dsp.impl.n_fft) == (12, 64, 4, 40, 320, 160, 512),
          f"unexpected KWS config {imp.learn.cfg} {imp.dsp.impl}")
    imp.init(torch.Generator(device=DEV).manual_seed(0))
    print(f"  DS-CNN {port.kws.count_params(imp.params)} params, features"
          f" {imp.dsp.feature_shape(16_000)}")
    imp.logits(clips[:KWS_BATCH]).cpu()                     # warm up
    imp.learn.apply(imp.params, imp.features(clips[:1])).cpu()

    reset_counts(port)
    torch.cuda.synchronize()
    feature_calls = 0
    t0 = time.perf_counter()
    labels = []
    for i in range(0, KWS_CLIPS, KWS_BATCH):
        labels.append(imp.logits(clips[i:i + KWS_BATCH]).argmax(-1))
        feature_calls += 1
    labels = torch.cat(labels).cpu()
    batch_s = time.perf_counter() - t0
    dsp_ms, nn_ms = [], []
    for i in range(KWS_SINGLE):
        t0 = time.perf_counter()
        feats = imp.features(clips[i:i + 1])
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        imp.learn.apply(imp.params, feats).argmax(-1).cpu()
        t2 = time.perf_counter()
        dsp_ms.append((t1 - t0) * 1e3)
        nn_ms.append((t2 - t1) * 1e3)
        feature_calls += 1
    imp.quantize(clips[:16])
    labels8 = []
    for i in range(0, KWS_CLIPS, KWS_BATCH):
        labels8.append(imp.logits_int8(clips[i:i + KWS_BATCH]).argmax(-1))
        feature_calls += 1
    labels8 = torch.cat(labels8).cpu()
    torch.cuda.synchronize()
    launches = read_counts(port)
    want = {name: 0 for name in launches}
    want.update(mel_frontend=feature_calls)
    check(launches == want, f"KWS launches {launches} != {want}")
    print(f"  launches {launches}: one mel_frontend per features call")
    check(labels.shape == (KWS_CLIPS,) and labels8.shape == (KWS_CLIPS,)
          and int(labels.max()) < 12 and int(labels8.max()) < 12,
          "KWS labels out of range")
    metrics = dict(
        clips_per_s=KWS_CLIPS / batch_s,
        batch1_p50_ms=float(np.median(np.add(dsp_ms, nn_ms))),
        batch1_dsp_p50_ms=float(np.median(dsp_ms)),
        batch1_nn_p50_ms=float(np.median(nn_ms)),
        int8_labels_equal_share=float((labels8 == labels).float().mean()),
        int8_compression=imp.qparams.meta["compression"])
    print("  metrics " + json.dumps(metrics))

    prof = {
        "batch512": profile_calls(lambda i: imp.logits(
            clips[i * KWS_BATCH:(i + 1) * KWS_BATCH]), 2),
        "batch1": profile_calls(lambda i: imp.logits(clips[i:i + 1]), 8),
    }
    for name, row in prof.items():
        print(f"  profile {name}: " + json.dumps(row))
    card_vs_cpu(port, imp, clips[:64], "DS-CNN + MFE")

    quick, qclips, _ = quickstart(port)
    card_vs_cpu(port, quick, qclips, "quickstart", every_label=True)
    return launches, metrics, prof, imp


def quickstart(port):
    """The quickstart Impulse (MFCC 32 mels / 10 coefficients + a 2-block
    conv1d stack, 4 classes, 0.5 s clips), seeded weights on the card, and
    64 of its clips with their labels."""
    cb = port.core_blocks
    quick = port.Impulse(
        cb.make_dsp_block("mfcc", n_mels=32, n_coeffs=10),
        cb.make_learn_block("conv1d-stack", n_blocks=2, ch_first=16,
                            ch_last=64, n_classes=4),
        input_shape=8000, device=DEV)
    quick.init(torch.Generator(device=DEV).manual_seed(1))
    qclips, qlabels = keyword_clips(port, 64, 4, 8000, seed=2)
    return quick, qclips, qlabels


def kws_fit(port, clips, labels):
    """``Impulse.fit`` at full width: the DS-CNN at the repo's defaults on
    the MFE block's defaults, seeded weights on the card, trained on the
    first ``FIT_TRAIN`` clips for ``FIT_EPOCHS`` epochs at batch
    ``FIT_BATCH`` (lr ``FIT_LR``) with the rest held out for ``val_acc``.
    The counts are set to 0 before the fit and read after:
    ``mel_frontend`` must launch once a step and once per ``evaluate``
    batch, and nothing else.  Each step ends in a sync here (the fit
    itself reads its metrics once an epoch) for the step times.  Then PTQ
    and the held-out accuracies, the MCU estimates, a profile of 8 steps
    and the quickstart Impulse's fit on the card against the CPU's."""
    cb = port.core_blocks
    imp = port.Impulse(cb.make_dsp_block("mfe"), cb.make_learn_block("ds-cnn"),
                       input_shape=16_000, device=DEV)
    train = (clips[:FIT_TRAIN], labels[:FIT_TRAIN])
    held = (clips[FIT_TRAIN:], labels[FIT_TRAIN:])
    step, stamps = imp.train_step, []

    def timed(*args):
        out = step(*args)
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        return out

    reset_counts(port)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with mock.patch.object(imp, "train_step", timed):
        hist = imp.fit(train, epochs=FIT_EPOCHS, batch_size=FIT_BATCH,
                       lr=FIT_LR, generator=torch.Generator(device=DEV)
                       .manual_seed(0), eval_data=held)["history"]
    fit_s = time.perf_counter() - t0
    launches = read_counts(port)
    per_epoch = -(-FIT_TRAIN // FIT_BATCH)
    evals = FIT_EPOCHS * -(-len(held[0]) // 64)
    check(len(stamps) == FIT_EPOCHS * per_epoch, f"{len(stamps)} steps")
    want = {name: 0 for name in launches}
    want.update(mel_frontend=len(stamps) + evals)
    check(launches == want, f"fit launches {launches} != one mel_frontend a"
          f" step and an evaluate batch {want}")
    print(f"  launches {launches}: {len(stamps)} steps + {evals} evaluate"
          f" batches")
    for rec in hist:
        print("  epoch " + json.dumps(rec))
    # intervals inside epochs 2 on (each epoch's first one holds the
    # previous epoch's evaluation)
    step_ms = [(b - a) * 1e3 for e in range(1, FIT_EPOCHS)
               for a, b in zip(stamps[e * per_epoch:(e + 1) * per_epoch],
                               stamps[e * per_epoch + 1:(e + 1) * per_epoch])]
    first, last = hist[0], hist[-1]
    check(last["loss"] < first["loss"] and last["loss"] < np.log(12),
          f"fit loss did not fall below the first epoch's and ln 12: {hist}")
    check(last["val_acc"] >= FIT_VAL_ACC_MIN,
          f"val_acc {last['val_acc']} < {FIT_VAL_ACC_MIN}")
    imp.quantize(train[0][:16])
    f32_acc = imp.evaluate(imp.params, *held)
    int8_acc = imp.int8_accuracy(*held)
    check(int8_acc >= f32_acc - 0.1,
          f"int8 held-out accuracy {int8_acc} < float {f32_acc} - 0.1")
    metrics = dict(step_ms=float(np.median(step_ms)),
                   clips_per_s=FIT_BATCH / float(np.median(step_ms)) * 1e3,
                   fit_s=fit_s, val_acc=last["val_acc"],
                   heldout_f32_acc=f32_acc, heldout_int8_acc=int8_acc)
    print("  fit metrics " + json.dumps(metrics))
    for target in port.estimator.TARGETS:
        for engine in ("eon", "tflm"):
            r = port.estimator.estimate_impulse(imp, target, engine=engine)
            print(f"  estimate (the estimator's prediction for the board,"
                  f" not a card number) {target} {engine} int8: dsp"
                  f" {r.dsp_latency_ms:.2f} ms, nn {r.nn_latency_ms:.2f} ms,"
                  f" ram {r.ram_kb:.1f} kB, flash {r.flash_kb:.1f} kB, fits"
                  f" {r.fits}, macs {r.detail['macs']}")

    params = port.tree.map_tree(
        lambda t: t.clone().requires_grad_(True), imp.params)
    opt_cfg = port.optimizer.AdamWConfig(lr=FIT_LR, weight_decay=0.0,
                                         grad_clip=1.0)
    opt = port.optimizer.adamw_init(params)
    xs = torch.as_tensor(train[0][:8 * FIT_BATCH], device=DEV)
    ys = torch.as_tensor(train[1][:8 * FIT_BATCH], dtype=torch.long,
                         device=DEV)
    prof = profile_calls(lambda i: imp.train_step(
        params, opt, opt_cfg, xs[i * FIT_BATCH:(i + 1) * FIT_BATCH],
        ys[i * FIT_BATCH:(i + 1) * FIT_BATCH]), 8)
    prof["mel_share"] = prof["mel_kernel_ms"] / prof["device_busy_ms"]
    print("  profile of a fit step: " + json.dumps(prof))
    fit_vs_cpu(port)
    return launches, metrics, prof


def fit_vs_cpu(port):
    """The quickstart Impulse fitted ``FIT_CHECK_EPOCHS`` epochs at batch
    16 on its 64 clips on the card and on the CPU from the same weights:
    the loss and accuracy history within ``FIT_LOSS_RTOL``, the logits
    after the fit within ``FIT_LOGIT_ATOL``, labels equal wherever the
    CPU's top-two gap exceeds it, and every weight within the Adam bound
    (``2 x lr x steps``: a leaf whose gradient is noise moves by up to lr
    a step, whatever the noise's sign)."""
    quick, qclips, qlabels = quickstart(port)
    tree = port.tree
    imps = {dev: port.Impulse(quick.dsp, quick.learn, quick.input_shape,
                              params=tree.map_tree(lambda t: t.to(dev),
                                                   quick.params),
                              device=dev) for dev in (DEV, "cpu")}
    hist = {dev: imp.fit((qclips, qlabels), epochs=FIT_CHECK_EPOCHS,
                         batch_size=16, lr=FIT_LR)["history"]
            for dev, imp in imps.items()}
    loss_gap = max(abs(a[k] - b[k]) / abs(b[k]) for a, b in
                   zip(hist[DEV], hist["cpu"]) for k in ("loss", "acc")
                   if b[k])
    got = imps[DEV].logits(qclips).cpu()
    want = imps["cpu"].logits(qclips)
    gap = float((got - want).abs().max())
    clear = top2_gap(want) > FIT_LOGIT_ATOL
    same = got.argmax(-1) == want.argmax(-1)
    w_gap = max(float((a.cpu() - b).abs().max()) for a, b in zip(
        tree.leaves(imps[DEV].params), tree.leaves(imps["cpu"].params)))
    steps = FIT_CHECK_EPOCHS * -(-len(qclips) // 16)
    reading = dict(history_rel_gap=loss_gap, logits_max_abs_gap=gap,
                   rows=int(got.shape[0]), clear_rows=int(clear.sum()),
                   labels_equal=int(same.sum()), weights_max_abs_gap=w_gap,
                   adam_bound=2 * FIT_LR * steps)
    print("  quickstart fit, card vs cpu: " + json.dumps(reading))
    check(loss_gap <= FIT_LOSS_RTOL, f"fit history: card vs cpu relative"
          f" gap {loss_gap} > {FIT_LOSS_RTOL}: {hist}")
    check(gap <= FIT_LOGIT_ATOL, f"fitted logits: card vs cpu gap {gap} >"
          f" {FIT_LOGIT_ATOL}")
    check(bool(same[clear].all()), "fitted labels differ between the card"
          " and the CPU")
    check(w_gap <= 2 * FIT_LR * steps, f"fitted weights: card vs cpu gap"
          f" {w_gap} beyond the Adam bound")
    return reading


# ---------------------------------------------------------------------------
# Phase 7: full-width training
# ---------------------------------------------------------------------------
def train_state(port, cfg) -> tuple:
    """Phase 7's start: f32 masters from a seeded generator on the card,
    their AdamW state, and the Markov token stream over
    ``TRAIN_STREAM_VOCAB`` ids (``TRAIN_TOKENS`` to train on, then a
    held-out batch's worth)."""
    params = port.init_params(cfg, torch.Generator(device=DEV).manual_seed(0),
                              DEV, trainable=True)
    opt_state = port.optimizer.adamw_init(params)
    tokens = port.synthetic.token_stream(
        TRAIN_TOKENS + TRAIN_BATCH * (TRAIN_SEQ + 1), TRAIN_STREAM_VOCAB,
        seed=1)
    return params, opt_state, tokens


def train_full(port, cfg):
    """internlm2-1.8b at full width, f32 masters from a seeded generator on
    the card, bf16 activations: ``Trainer`` -> ``make_train_step`` (remat
    "full", AdamW lr 3e-4) -> ``forward_train`` for ``TRAIN_STEPS`` steps
    of batch 4 x seq 2048 from the stream over ``TRAIN_STREAM_VOCAB`` ids,
    the final checkpoint written to a temporary directory and the best
    step restored.  The losses by step, of the first batch and of a
    held-out batch (scored before and after the run) must fall.  Launch
    counts are set to 0 before the run and read after it; then the
    profile of two steps."""
    t0 = time.perf_counter()
    params, opt_state, tokens = train_state(port, cfg)
    step = port.train_step.make_train_step(
        cfg, remat="full", opt=port.optimizer.AdamWConfig(lr=TRAIN_LR))
    # training windows come from the first TRAIN_TOKENS tokens; the held-out
    # batch is the stream's tail, never trained on
    batches = port.synthetic.lm_batches(tokens[:TRAIN_TOKENS], TRAIN_BATCH,
                                        TRAIN_SEQ, seed=0)
    # the first step's batch, drawn again from the same seed
    seen = {k: torch.from_numpy(v).to(DEV) for k, v in next(
        port.synthetic.lm_batches(tokens[:TRAIN_TOKENS], TRAIN_BATCH,
                                  TRAIN_SEQ, seed=0)).items()}
    unseen = port.launch_train.held_out(tokens, TRAIN_BATCH, TRAIN_SEQ, DEV)

    def held_losses() -> tuple:
        return tuple(port.launch_train.eval_loss(cfg, params, b)
                     for b in (seen, unseen))
    n_params = sum(p.numel() for p in params.parameters())
    torch.cuda.synchronize()
    print(f"  {n_params} f32 parameters and optimizer state on the card,"
          f" token stream made, in {time.perf_counter() - t0:.1f} s")
    held_before = held_losses()
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as ckdir:
        trainer = port.Trainer(
            step, params, opt_state, ckpt_dir=Path(ckdir), device=DEV,
            config=port.TrainerConfig(total_steps=TRAIN_STEPS,
                                      checkpoint_every=0, keep_checkpoints=1,
                                      log_every=1))
        reset_counts(port)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = trainer.run(batches)
        run_s = time.perf_counter() - t0
        launches = read_counts(port)
        saved = trainer.ckpt.all_steps()
    peak = torch.cuda.max_memory_allocated()
    held_after = held_losses()
    hist = result["history"]
    losses = [h["loss"] for h in hist]
    check(len(losses) == TRAIN_STEPS and all(np.isfinite(losses)),
          f"training losses {losses}")
    print(f"  the first batch's loss: {held_before[0]:.4f} before the first"
          f" step ({losses[0]:.4f} in step 1), {held_after[0]:.4f} after"
          f" step {TRAIN_STEPS}; a held-out batch's: {held_before[1]:.4f}"
          f" -> {held_after[1]:.4f}")
    check(losses[-1] < losses[0] and held_after[0] < held_before[0]
          and held_after[1] < held_before[1], f"the loss did not fall: by"
          f" step {losses}, the first batch {held_before[0]} ->"
          f" {held_after[0]}, held out {held_before[1]} -> {held_after[1]}")
    check(saved == [TRAIN_STEPS], f"checkpoints {saved}")
    layers = cfg.n_layers
    want = {name: 0 for name in launches}
    want.update(flash_attention=2 * layers * TRAIN_STEPS,
                flash_attention_bwd=layers * TRAIN_STEPS)
    check(launches == want, f"training launches {launches} != {want}")
    print(f"  launches {launches}: {layers} forward + {layers} recomputed"
          f" forward and {layers} backward a step")

    step_s = float(np.median([h["step_time_s"] for h in hist[2:]]))
    tokens_step = TRAIN_BATCH * TRAIN_SEQ
    # N: the weights of the matmuls (blocks and unembedding); the input
    # embedding is a gather and does no multiply-adds
    n_matmul = n_params - cfg.padded_vocab() * cfg.d_model
    attn_flops = 3 * 4 * cfg.resolved_head_dim * cfg.n_heads * layers \
        * TRAIN_BATCH * fa_pairs(TRAIN_SEQ, True, 0)
    model_flops = 6 * n_matmul * tokens_step + attn_flops
    metrics = dict(
        losses=losses, first_batch_loss=[held_before[0], held_after[0]],
        held_out_loss=[held_before[1], held_after[1]],
        step_ms=step_s * 1e3,
        step_ms_all=[h["step_time_s"] * 1e3 for h in hist],
        tokens_per_s=tokens_step / step_s,
        mfu=model_flops / step_s / PEAK_OPS[torch.bfloat16],
        mfu_n=n_matmul, model_flops_per_step=model_flops,
        peak_memory_bytes=peak, run_s=run_s,
        restored_step=result.get("restored_step"),
        attention_launches_per_step={k: v // TRAIN_STEPS
                                     for k, v in launches.items() if v})
    print("  metrics " + json.dumps(metrics))

    batch = next(batches)

    def one_step(i):
        _, _, m = step(trainer.params, trainer.opt_state, batch)
        float(m["loss"])
    wall_ms, kernels, copies = trace_calls(one_step, 2)
    attn = [e for e in kernels if any(n in e["name"] for n in FA_KERNELS)]
    busy = _merged_us([(e["ts"], e["dur"]) for e in kernels]) / 1e3 / 2
    attn_ms = sum(e["dur"] for e in attn) / 1e3 / 2
    check(busy > 0 and len(attn) > 0, f"the profile of a training step saw"
          f" {len(kernels)} kernels, {len(attn)} of attention")
    attn_by_kernel = {}
    for e in attn:
        kname = next(n for n in FA_KERNELS if n in e["name"])
        attn_by_kernel[kname] = attn_by_kernel.get(kname, 0.0) \
            + e["dur"] / 1e3 / 2
    prof = dict(host_wall_ms=wall_ms, device_busy_ms=busy,
                idle_share=1 - busy / wall_ms, attention_ms=attn_ms,
                attention_share=attn_ms / busy,
                attention_ms_by_kernel=attn_by_kernel,
                attention_kernels_per_step=len(attn) / 2,
                kernels_per_step=len(kernels) / 2,
                copy_ms=sum(e["dur"] for e in copies) / 1e3 / 2)
    by_name = {}
    for e in kernels:
        key = e["name"][:70]
        by_name[key] = by_name.get(key, 0.0) + e["dur"] / 1e3 / 2
    print("  profile of a step: " + json.dumps(prof))
    for kname, ms in sorted(by_name.items(), key=lambda x: -x[1])[:8]:
        print(f"    {ms:.3f} ms/step  {kname}")
    metrics["remat"] = remat_policies(port, cfg, trainer.params,
                                      trainer.opt_state, batch)
    del trainer, params, opt_state, result
    return launches, metrics, prof


def remat_policies(port, cfg, params, opt_state, batch) -> dict:
    """Under each remat policy of the reference, a first untimed step and
    ``REMAT_STEPS`` timed ones (host wall, each ending in a sync): the
    median step ms, every step's, and the peak memory, which must fall in
    the order none >= dots >= dots_no_batch >= full (each keeps a subset
    of the one before).  The policies take turns on the same parameters,
    which each step updates in place: their losses differ, their work
    does not."""
    out = {}
    for policy in port.transformer.REMAT_POLICIES:
        step = port.train_step.make_train_step(
            cfg, remat=policy, opt=port.optimizer.AdamWConfig(lr=TRAIN_LR))
        step(params, opt_state, batch)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times = []
        for _ in range(REMAT_STEPS):
            t0 = time.perf_counter()
            _, _, m = step(params, opt_state, batch)
            loss = float(m["loss"])
            times.append((time.perf_counter() - t0) * 1e3)
        out[policy] = dict(step_ms=float(np.median(times)), step_ms_all=times,
                           peak_memory_bytes=torch.cuda.max_memory_allocated(),
                           loss=loss)
        check(np.isfinite(loss), f"remat {policy}: loss {loss}")
    print("  remat policies " + json.dumps(out))
    peaks = [out[p]["peak_memory_bytes"]
             for p in ("none", "dots", "dots_no_batch", "full")]
    check(peaks == sorted(peaks, reverse=True), f"peak memory by remat"
          f" policy not in the order none >= dots >= dots_no_batch >= full:"
          f" {peaks}")
    return out


def train_small_vs_cpu(port):
    """A small float32 config (2 layers, d_model 128, 2/1 heads of 64)
    trained 3 steps (remat "full", AdamW lr 1e-3) on the card and on the
    CPU from the same weights and batches: loss and grad norm each step,
    and every weight after, within ``TRAIN_TOL``."""
    cfg = dataclasses.replace(port.configs.get_smoke("internlm2-1.8b"),
                              d_model=128, n_heads=2, n_kv_heads=1,
                              dtype="float32")
    tokens = port.synthetic.token_stream(20_000, cfg.vocab_size, seed=1)
    runs = {}
    for dev in ("cpu", DEV):
        params = port.init_params(cfg, torch.Generator().manual_seed(0),
                                  "cpu", trainable=True).to(dev)
        opt_state = port.optimizer.adamw_init(params)
        step = port.train_step.make_train_step(
            cfg, remat="full", opt=port.optimizer.AdamWConfig(lr=1e-3))
        batches = port.synthetic.lm_batches(tokens, 4, 64, seed=2)
        metrics = []
        for _ in range(3):
            _, _, m = step(params, opt_state, next(batches))
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
        runs[dev] = (metrics, [p.detach().cpu()
                               for p in port.tree.leaves(params.tree())])
    (m_cpu, p_cpu), (m_card, p_card) = runs["cpu"], runs[DEV]
    read = dict(
        loss_rel=max(abs(a[0] - b[0]) / abs(b[0])
                     for a, b in zip(m_card, m_cpu)),
        grad_norm_rel=max(abs(a[1] - b[1]) / abs(b[1])
                          for a, b in zip(m_card, m_cpu)),
        param_abs=max(float((a - b).abs().max())
                      for a, b in zip(p_card, p_cpu)))
    print(f"  small float32 training, card vs cpu over 3 steps:"
          f" {json.dumps(read)} (limits {json.dumps(TRAIN_TOL)});"
          f" losses card {[m[0] for m in m_card]}")
    check(read["loss_rel"] <= TRAIN_TOL["loss_rtol"]
          and read["grad_norm_rel"] <= TRAIN_TOL["grad_norm_rtol"]
          and read["param_abs"] <= TRAIN_TOL["param_atol"],
          f"small float32 training: card and cpu disagree: {read}")
    return read


# ---------------------------------------------------------------------------
# Phase 8: full-width mamba1 serving
# ---------------------------------------------------------------------------
def mamba_config(port):
    """falcon-mamba-7b at its full width, cut to ``MAMBA_LAYERS`` of its
    64 layers."""
    cfg = port.configs.get("falcon-mamba-7b")
    check((cfg.n_layers, cfg.d_model, cfg.d_inner, cfg.ssm_state,
           cfg.padded_vocab(), cfg.tie_embeddings)
          == (64, 4096, 8192, 16, 65536, False), f"unexpected config {cfg}")
    return dataclasses.replace(cfg, n_layers=MAMBA_LAYERS)


def serve_mamba_full(port, cfg):
    """falcon-mamba-7b at full width (``MAMBA_LAYERS`` deep) through
    ``ContinuousBatchServer``, as phase 3 serves internlm2: returns the
    weights, launches and metrics."""
    t0 = time.perf_counter()
    params = port.init_params(cfg, torch.Generator(device=DEV).manual_seed(0),
                              DEV)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    print(f"  weights: {n_params} params in {time.perf_counter() - t0:.1f} s")
    check(n_params == MAMBA_PARAMS, f"{n_params} parameters")
    kw = dict(slots=4, prefill_chunk=64, max_new_tokens=32, max_prompt=512,
              device=DEV)
    warm = port.server.ContinuousBatchServer(cfg, params, **kw)
    warm.submit([np.arange(9, dtype=np.int32)], max_new_tokens=2)
    warm.run()
    del warm

    rng = np.random.RandomState(0)
    lens = [9, 37, 64, 128, 200, 301, 450, 512]
    prompts = [rng.randint(0, cfg.vocab_size, n).astype(np.int32)
               for n in lens]
    srv = port.server.ContinuousBatchServer(cfg, params, **kw)
    reqs = srv.submit(prompts)
    reset_counts(port)
    torch.cuda.synchronize()
    metrics = srv.run()
    torch.cuda.synchronize()
    launches = read_counts(port)
    vpad = cfg.padded_vocab()
    for r in reqs:
        check(len(r.tokens) == 32, f"request {r.rid}: {len(r.tokens)} tokens")
        check(all(0 <= t < vpad for t in r.tokens),
              f"request {r.rid}: token out of [0, {vpad})")
    want = {name: 0 for name in launches}
    want.update(mamba_scan=cfg.n_layers * (metrics["decode_steps"]
                                           + metrics["prefill_chunks"]))
    check(launches == want, f"launches {launches} != layers x steps {want}")
    print(f"  launches {launches} = {cfg.n_layers} x (decode steps + chunk"
          f" steps)")
    print("  metrics " + json.dumps(metrics))
    return params, launches, metrics, eager_run(srv, prompts, reqs, kw,
                                                launches, metrics)


def serve_small_mamba_vs_cpu(port):
    """The exact oracle for the mamba1 trunk: the float32 smoke config (2
    layers, d_model 64, state 8) served through the kernel on the card
    gives the CPU plain path's tokens, through ``ContinuousBatchServer``
    and ``PagedBatchServer`` (blocks of 8), on the prompts and budgets of
    the CPU parity tests."""
    cfg = dataclasses.replace(port.configs.get_smoke("falcon-mamba-7b"),
                              dtype="float32")
    rng = np.random.RandomState(3)
    prompts = [rng.randint(0, cfg.vocab_size, n).astype(np.int32)
               for n in (5, 12, 9, 3, 16)]
    budgets = [6, 4, 8, 5, 3]
    host = port.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    common = dict(slots=2, max_prompt=16, prefill_chunk=4, max_new_tokens=8)
    engines = {"continuous": (port.server.ContinuousBatchServer, {}),
               "paged": (port.server.PagedBatchServer, dict(block_size=8))}
    for name, (engine, kw) in engines.items():
        tokens = {}
        for dev in ("cpu", DEV):
            srv = engine(cfg, host.to(dev), device=dev, **common, **kw)
            reqs = srv.submit(prompts, max_new_tokens=budgets)
            srv.run()
            tokens[dev] = [r.tokens for r in reqs]
        check(tokens[DEV] == tokens["cpu"],
              f"small float32 mamba1 {name} serving: card {tokens[DEV]} !="
              f" cpu {tokens['cpu']}")
        print(f"  small float32 mamba1 {name} serving, card == cpu tokens:"
              f" {tokens[DEV]}")


# ---------------------------------------------------------------------------
# The deployment artifact (paper C4): phases 3, 5, 6 and 8 from the artifact
# ---------------------------------------------------------------------------
def eager_run(srv, prompts, reqs, kw, launches, metrics) -> SimpleNamespace:
    """What an artifact run is held to: the eager run's requests, engine
    options, the server's weights, tokens, launches and metrics."""
    return SimpleNamespace(engine=type(srv), params=srv.params,
                           prompts=prompts, kw=kw, launches=launches,
                           metrics=metrics,
                           tokens=[list(r.tokens) for r in reqs])


def executed(port, step, host: dict) -> dict:
    """Kernel launches of a run that replays ``step``: the wrappers' count
    (the eager steps beside it; a replay launches the captured kernels
    without a wrapper) plus the capture's launches times the replays."""
    return {k: host[k] + step.captured_launches[k] * step.replays
            for k in host}


def artifact_serving(port, name, cfg, eager) -> tuple:
    """The eager run's requests once more through the same engine with
    ``use_artifact=True``: the decode step compiled into an artifact,
    rehydrated and captured as a CUDA graph when the engine is built
    (timed), then every decode step of the run replayed.  The counts are
    set to 0 just before the run and read just after.  Gates: the eager
    run's tokens, a replay a decode step, and the kernels executed (the
    wrappers' count plus the capture's times the replays) equal to the
    eager run's launches.  Returns the executed launches, the metrics and
    the artifact's report."""
    t0 = time.perf_counter()
    srv = eager.engine(cfg, eager.params, use_artifact=True, **eager.kw)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    step = srv.decode
    check(isinstance(step, port.eon.GraphStep) and step.graph is not None,
          f"{name}: the engine's decode step is not a captured graph")
    check(step.replays == 0, f"{name}: {step.replays} replays before run()")
    reqs = srv.submit(eager.prompts)
    reset_counts(port)
    torch.cuda.synchronize()
    metrics = srv.run()
    torch.cuda.synchronize()
    host = read_counts(port)
    tokens = [list(r.tokens) for r in reqs]
    same = sum(a == b for t, e in zip(tokens, eager.tokens)
               for a, b in zip(t, e))
    check(tokens == eager.tokens, f"{name}: the artifact's tokens differ"
          f" from the eager run's ({same} of"
          f" {sum(map(len, eager.tokens))} equal)")
    check(step.replays == metrics["decode_steps"]
          == eager.metrics["decode_steps"],
          f"{name}: {step.replays} replays, {metrics['decode_steps']} decode"
          f" steps, eager {eager.metrics['decode_steps']}")
    ran = executed(port, step, host)
    check(ran == eager.launches, f"{name}: kernels executed {ran} (host"
          f" {host}, captured {step.captured_launches} x {step.replays}"
          f" replays) != the eager run's {eager.launches}")
    art = srv.artifact
    report = dict(name=art.name, build_s=build_s,
                  compile_time_s=art.compile_time_s,
                  artifact_bytes=art.artifact_bytes,
                  temp_bytes=art.memory["temp_bytes"],
                  argument_bytes=art.memory["argument_bytes"],
                  flops=art.flops, captured_launches=step.captured_launches,
                  replays=step.replays, host_launches=host)
    print(f"  {name} from the artifact: tokens equal to the eager run's"
          f" ({sum(map(len, tokens))}); kernels executed {ran} = host"
          f" {host} + captured {step.captured_launches} x {step.replays}"
          " replays = the eager run's")
    print(f"  {name} artifact " + json.dumps(report))
    print(f"  {name} tokens_per_s eager {eager.metrics['tokens_per_s']:.2f}"
          f"  artifact {metrics['tokens_per_s']:.2f}  ttft_p50_s eager"
          f" {eager.metrics['ttft_p50_s']:.4f} artifact"
          f" {metrics['ttft_p50_s']:.4f}")
    return ran, metrics, report, srv


def decode_side_by_side(port, name, srv, fill: int) -> dict:
    """The decode step eager and from the engine's artifact, on the
    engine's own weights and cache after its run, with the same inputs:
    8 steps of 4 slots at fill ``fill``..``fill + 7`` (paged: slot s on
    pool blocks from s x ceil((fill + 8) / BS) on), each ending in a host
    read of its tokens.  Host wall, device busy, idle share and kernels a
    step of both."""
    cfg = srv.cfg
    ss = port.serve_step
    rng = np.random.RandomState(2)
    toks = [torch.as_tensor(rng.randint(0, cfg.vocab_size, 4)
                            .astype(np.int32), device=DEV)
            for _ in range(9)]

    def ints(v):
        return torch.full((4,), v, dtype=torch.int32, device=DEV)

    extra = ()
    if isinstance(srv, port.server.PagedBatchServer):
        eager = ss.make_paged_decode_step(cfg, srv.prec)
        per = -(-(fill + 8) // srv.block_size)
        table = torch.zeros((4, srv.n_table), dtype=torch.int32, device=DEV)
        if srv.paged_keys:
            check(4 * per <= srv.pool_blocks, f"{name}: fill {fill} needs"
                  f" {4 * per} of {srv.pool_blocks} blocks")
            table[:, :per] = torch.arange(4 * per, dtype=torch.int32,
                                          device=DEV).reshape(4, per)
        extra = (table,)
    else:
        eager = ss.make_slot_decode_step(cfg, srv.prec)
    out = {}
    for kind, fn in (("eager", eager), ("artifact", srv.decode)):
        out[kind] = profile_step(
            f"{name} {kind} decode", lambda i, fn=fn: fn(
                srv.params, srv.cache, toks[i], ints(fill - 1 + i),
                ints(fill + i), *extra), 8, quiet=True)
    e, a = out["eager"], out["artifact"]
    print(f"  {name} decode step, eager | artifact: host wall"
          f" {e['host_wall_ms']:.3f} | {a['host_wall_ms']:.3f} ms, device"
          f" busy {e['device_busy_ms']:.3f} | {a['device_busy_ms']:.3f} ms,"
          f" idle share {e['idle_share']:.3f} | {a['idle_share']:.3f},"
          f" kernels {e['kernels_per_step']:g} | {a['kernels_per_step']:g}")
    return out


def kws_artifact(port, imp, clips, eager_metrics, eager_prof) -> tuple:
    """Phase 6's Impulse from its artifact (``compile_impulse``) at batch
    512 and 1: the same 2,048 clips in batches of 512 (clips/s) and 32
    single clips (the whole call's p50), with the counts set to 0 before
    and read after.  Gates: the eager logits (bitwise, or within
    ``KWS_LOGIT_ATOL`` if cuDNN chose another algorithm under capture),
    the eager labels, no wrapper launch (every call a replay) and one
    ``mel_frontend`` captured per graph.  Then a profile's idle share
    beside the eager one."""
    eon = port.eon
    arts, fns = {}, {}
    for b in (KWS_BATCH, 1):
        t0 = time.perf_counter()
        arts[b] = eon.compile_impulse(imp, batch_size=b)
        fns[b] = arts[b].rehydrate()
        fns[b](torch.from_numpy(clips[:b]))          # capture
        torch.cuda.synchronize()
        print(f"  artifact batch {b}: {arts[b].name}, build"
              f" {time.perf_counter() - t0:.2f} s, " + json.dumps(
                  dict(artifact_bytes=arts[b].artifact_bytes,
                       **arts[b].memory, flops=arts[b].flops)))
    big, one = fns[KWS_BATCH], fns[1]
    worst = 0.0
    for i in range(0, 1024, KWS_BATCH):
        got = big(torch.from_numpy(clips[i:i + KWS_BATCH])).clone()
        want = imp.logits(clips[i:i + KWS_BATCH])
        worst = max(worst, float((got - want).abs().max()))
    got1 = one(torch.from_numpy(clips[:1])).clone()
    worst = max(worst, float((got1 - imp.logits(clips[:1])).abs().max()))
    check(worst <= KWS_LOGIT_ATOL, f"KWS artifact logits differ from the"
          f" eager ones by {worst} > {KWS_LOGIT_ATOL}")
    print(f"  artifact logits against eager: max|gap| {worst:.3g}"
          f" ({'bitwise' if worst == 0 else 'within KWS_LOGIT_ATOL'})")

    replays0 = {b: fns[b].replays for b in fns}
    reset_counts(port)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    labels = []
    for i in range(0, KWS_CLIPS, KWS_BATCH):
        labels.append(big(torch.from_numpy(
            clips[i:i + KWS_BATCH])).argmax(-1))
    labels = torch.cat(labels).cpu()
    batch_s = time.perf_counter() - t0
    one_ms, eager_one_ms = [], []
    for i in range(KWS_SINGLE):
        t0 = time.perf_counter()
        one(torch.from_numpy(clips[i:i + 1])).argmax(-1).cpu()
        one_ms.append((time.perf_counter() - t0) * 1e3)
    host = read_counts(port)
    for i in range(KWS_SINGLE):
        t0 = time.perf_counter()
        imp.logits(clips[i:i + 1]).argmax(-1).cpu()
        eager_one_ms.append((time.perf_counter() - t0) * 1e3)
    calls = {b: fns[b].replays - replays0[b] for b in fns}
    check(all(n == 0 for n in host.values()), f"KWS artifact: wrapper"
          f" launches {host} during replays")
    check(all(fns[b].captured_launches == dict(
        {k: 0 for k in host}, mel_frontend=1) for b in fns),
          f"KWS artifact: captured {[fns[b].captured_launches for b in fns]}")
    eager_labels = torch.cat([imp.logits(clips[i:i + KWS_BATCH]).argmax(-1)
                              for i in range(0, KWS_CLIPS, KWS_BATCH)]).cpu()
    check(torch.equal(labels, eager_labels), "KWS artifact labels differ")
    ran = {k: sum(fns[b].captured_launches[k] * calls[b] for b in fns)
           for k in host}
    metrics = dict(clips_per_s=KWS_CLIPS / batch_s,
                   batch1_p50_ms=float(np.median(one_ms)),
                   eager_batch1_call_p50_ms=float(np.median(eager_one_ms)))
    prof = {
        "batch512": profile_calls(lambda i: big(torch.from_numpy(
            clips[i * KWS_BATCH:(i + 1) * KWS_BATCH])), 2),
        "batch1": profile_calls(lambda i: one(torch.from_numpy(
            clips[i:i + 1])), 8),
    }
    for b in ("batch512", "batch1"):
        e, a = eager_prof[b], prof[b]
        print(f"  KWS {b}, eager | artifact: host wall"
              f" {e['host_wall_ms']:.4f} | {a['host_wall_ms']:.4f} ms,"
              f" device busy {e['device_busy_ms']:.4f} |"
              f" {a['device_busy_ms']:.4f} ms, idle share"
              f" {e['idle_share']:.3f} | {a['idle_share']:.3f}, kernels"
              f" {e['kernels_per_call']:g} | {a['kernels_per_call']:g}")
    print(f"  KWS clips_per_s eager {eager_metrics['clips_per_s']:.1f} |"
          f" artifact {metrics['clips_per_s']:.1f}; batch-1 whole call p50"
          f" eager {metrics['eager_batch1_call_p50_ms']:.3f} | artifact"
          f" {metrics['batch1_p50_ms']:.3f} ms; kernels executed {ran}")
    return ran, metrics, prof


def tuner_and_project(port) -> tuple:
    """Phase 9: ``EONTuner.search`` on the card (8 samples, 1 epoch) on
    seeded one-second keyword clips, 4 classes, 384 to train and 128 to
    rank; then a ``Project`` through every stage, ending in
    ``deploy(int8=True)`` to a file and its reload, whose logits must
    equal the artifact's before saving.  Returns the launches of each
    (counts set to 0 before, read after) and a summary."""
    clips, labels = keyword_clips(port, 512, 4, 16_000, seed=7)
    tuner = port.tuner.EONTuner(input_samples=16_000, n_classes=4,
                                target="nano33ble", seed=0, device=DEV)
    reset_counts(port)
    t0 = time.perf_counter()
    cands = tuner.sample(8)
    for c in cands:
        print(f"  sampled {c.describe()}")
    survivors = tuner.screen(cands)
    for c in survivors:
        e = c.estimate
        print(f"  survivor {c.describe()}: ram {e.ram_kb:.1f} KB, flash"
              f" {e.flash_kb:.1f} KB, latency {e.total_latency_ms:.1f} ms")
    ranked = tuner.evaluate(survivors, (clips[:384], labels[:384]),
                            (clips[384:], labels[384:]), epochs=1)
    torch.cuda.synchronize()
    tuner_s = time.perf_counter() - t0
    tuner_launches = read_counts(port)
    for c in ranked:
        print(f"  ranked {c.accuracy:.4f}  {c.describe()}")
    check(bool(survivors) and all(c.trained for c in ranked)
          and [c.accuracy for c in ranked]
          == sorted((c.accuracy for c in ranked), reverse=True),
          "EON tuner: no survivor, or not ranked by accuracy")
    check(tuner_launches["mel_frontend"] > 0,
          f"EON tuner: no mel_frontend launch ({tuner_launches})")
    print(f"  EON tuner: {len(cands)} sampled, {len(survivors)} survived the"
          f" screen, trained 1 epoch each in {tuner_s:.1f} s; launches"
          f" {tuner_launches}")

    reset_counts(port)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        p = port.project.Project("kws-card", Path(tmp) / "project",
                                 device=DEV)
        version = p.ingest(port.synthetic.keyword_audio(
            n_per_class=24, n_classes=3, n_samples=4000))
        p.set_impulse("mfcc", {"n_mels": 32, "n_coeffs": 10},
                      "conv1d-stack", {"n_blocks": 2, "ch_first": 16,
                                       "ch_last": 32})
        p.train(epochs=8)
        acc = p.test()["accuracy"]
        meta = p.quantize()
        est = p.estimate("nano33ble")
        p.tune(n_samples=4, epochs=1)
        art = p.deploy(Path(tmp) / "deploy.bin", int8=True)
        loaded = port.eon.CompiledArtifact.load(Path(tmp) / "deploy.bin")
        xs = torch.from_numpy(p.dataset.arrays("test")[0][:1])
        before = art.rehydrate()(xs).clone()
        after = loaded.rehydrate()(xs).clone()
        eager = p.impulse.logits_int8(xs)
        log_saved = (Path(tmp) / "project" / "project_log.json").exists()
        stages = p.summary()["stages_run"]
    torch.cuda.synchronize()
    project_launches = read_counts(port)
    gap = float((before - eager).abs().max())
    check(torch.equal(before, after) and bool(after.isfinite().all()),
          "Project: the reloaded artifact's logits differ from the"
          " artifact's before saving")
    check(gap <= KWS_LOGIT_ATOL, f"Project: the int8 artifact's logits"
          f" differ from the eager int8 logits by {gap}")
    check(log_saved and stages == ["ingest", "set_impulse", "train", "test",
                                   "quantize", "estimate", "tune",
                                   "deploy"], f"Project stages {stages}")
    summary = dict(version=version, test_accuracy=acc,
                   compression=meta["compression"], ram_kb=est.ram_kb,
                   flash_kb=est.flash_kb, fits=est.fits,
                   artifact=art.name, artifact_bytes=art.artifact_bytes,
                   reload_equal=True, int8_vs_eager_gap=gap,
                   seconds=time.perf_counter() - t0)
    print("  Project " + json.dumps(summary))
    print(f"  Project launches {project_launches}")
    return tuner_launches, project_launches, dict(
        tuner_s=tuner_s, sampled=len(cands), survivors=len(survivors),
        ranked=[c.accuracy for c in ranked], project=summary)


# ---------------------------------------------------------------------------
# Phases 10 and 11: slices 7 and 8 (one-shot prefill, the sliding-window
# ring of gemma3-4b, granite-3-8b)
# ---------------------------------------------------------------------------
def init_full(port, cfg, n_params=None):
    """Seeded weights of a full config on the card, and a warm-up request
    through ``ContinuousBatchServer`` (the first cuBLAS calls)."""
    t0 = time.perf_counter()
    params = port.init_params(cfg, torch.Generator(device=DEV).manual_seed(0),
                              DEV)
    torch.cuda.synchronize()
    n = sum(p.numel() for p in params.parameters())
    print(f"  {cfg.name} weights: {n} params in"
          f" {time.perf_counter() - t0:.1f} s")
    check(n_params is None or n == n_params, f"{n} parameters")
    warm = port.server.ContinuousBatchServer(cfg, params, slots=1,
                                             prefill_chunk=64, device=DEV)
    warm.submit([np.arange(9, dtype=np.int32)], max_new_tokens=2)
    warm.run()
    return params


def attention_layers(port, cfg) -> int:
    """The attention layers a step runs: every layer, or the hybrid
    trunk's shared block once a group."""
    pat = port.params.layer_pattern(cfg)
    return pat["n_groups"] if pat["kind"] == "hybrid" else cfg.n_layers


def serve_run(port, cfg, srv, lens, prompts=None):
    """Prompts of ``lens`` tokens (seeded; or ``prompts``), 32 new tokens
    each, through ``srv``: every request returns 32 tokens in the padded
    vocabulary, and each kernel's launches equal what the step counts
    imply (attention: attention layers x steps; int8: ``int8_matmul`` 7 x
    attention layers x steps, 4 in an MoE block, whose experts stay
    float).  Returns the launches, metrics and tokens."""
    if prompts is None:
        rng = np.random.RandomState(0)
        prompts = [rng.randint(0, cfg.vocab_size, n).astype(np.int32)
                   for n in lens]
    reqs = srv.submit(prompts)
    reset_counts(port)
    torch.cuda.synchronize()
    metrics = srv.run()
    torch.cuda.synchronize()
    launches = read_counts(port)
    vpad = cfg.padded_vocab()
    for r in reqs:
        check(len(r.tokens) == 32, f"request {r.rid}: {len(r.tokens)} tokens")
        check(all(0 <= t < vpad for t in r.tokens),
              f"request {r.rid}: token out of [0, {vpad})")
    steps = metrics["decode_steps"] + metrics["prefill_chunks"]
    n_attn = attention_layers(port, cfg)
    want = {name: 0 for name in launches}
    want.update(flash_decode=n_attn * metrics["decode_steps"],
                flash_chunk_prefill=n_attn * metrics["prefill_chunks"])
    if srv.precision == "int8":
        want["int8_matmul"] = (4 if cfg.is_moe else 7) * n_attn * steps
    name = f"{cfg.name} {type(srv).__name__} {srv.precision}"
    check(launches == want, f"{name}: launches {launches} != what the"
          f" steps imply {want}")
    print(f"  {name}: launches {launches} = {n_attn} attention layers x"
          f" (decode steps, chunk steps)")
    print("  metrics " + json.dumps(metrics))
    return launches, metrics, [list(r.tokens) for r in reqs]


# gemma3-4b at full width: four prompts of 900 to 1,500 tokens (past the
# local layers' window of 1,024, so every ring wraps) and 32 new tokens, 4
# slots, chunks of 64, max_prompt 1,536 (capacity 1,600)
GEMMA_LENS = [900, 1100, 1300, 1500]
GEMMA_KW = dict(slots=4, prefill_chunk=64, max_new_tokens=32,
                max_prompt=1536, device=DEV)
# phase 11's depth (and phase 10's): 6 of gemma3-4b's 34 layers, 1 of its
# 5 groups (cut from 22 so that the script keeps within half its time)
GEMMA_LAYERS, GEMMA_PARAMS = 6, 1_237_352_960
# Twice the largest of the float and int8 paged readings on the H100 (the
# rule of LOGIT_ATOL), rounded up to a power of two; PERF.md gives them.
GEMMA_LOGIT_ATOL = 0.5
GEMMA_INT8_LOGIT_ATOL = 2.0
# One-shot prefill against the chunked path on the same prompt: the
# largest |difference| of the last-token logits and of any cache entry
# (bf16 in another summation order through every layer), twice the
# largest reading rounded up to a power of two; greedy tokens of a
# teacher-forced decode from the prefill's cache equal the chunk engine's
# on at least PREFILL_GREEDY_EQUAL_MIN of them.
PREFILL_LOGIT_ATOL = 0.5
PREFILL_CACHE_ATOL = 0.5
PREFILL_GREEDY_EQUAL_MIN = 0.9
PREFILL_LIMITS = dict(logit=PREFILL_LOGIT_ATOL, cache=PREFILL_CACHE_ATOL,
                      greedy=PREFILL_GREEDY_EQUAL_MIN)


def gemma_config(port):
    """gemma3-4b at its full width, cut to ``GEMMA_LAYERS`` of its 34
    layers."""
    cfg = port.configs.get("gemma3-4b")
    check(cfg.n_layers == 34 and cfg.resolved_head_dim == 256
          and cfg.sliding_window == 1024 and cfg.padded_vocab() == 262144,
          f"unexpected config {cfg}")
    return dataclasses.replace(cfg, n_layers=GEMMA_LAYERS)


def serve_gemma(port, cfg):
    """gemma3-4b at full width, bf16: float through
    ``ContinuousBatchServer`` and int8 through ``PagedBatchServer``, each
    held to its launch counts, then its logits against the plain path on
    copies of the cache, as phase 3 (two seeds; slots filled with 17 to
    22 chunks, past the window).  Returns the launches and metrics of both
    runs."""
    params = init_full(port, cfg, GEMMA_PARAMS)
    srv = port.server.ContinuousBatchServer(cfg, params, **GEMMA_KW)
    check(srv.capacity == 1600, f"capacity {srv.capacity} != 1600")
    launches, metrics, _ = serve_run(port, cfg, srv, GEMMA_LENS)
    del srv
    logits_vs_plain(port, cfg, params, GEMMA_LOGIT_ATOL, GREEDY_EQUAL_MIN,
                    attention_paths(port), seeds=(1, 2), capacity=1600,
                    fill_chunks=(17, 23))
    srv = port.server.PagedBatchServer(cfg, params, precision="int8",
                                       **GEMMA_KW)
    launches8, metrics8, _ = serve_run(port, cfg, srv, GEMMA_LENS)
    logits_vs_plain(port, cfg, srv.params, GEMMA_INT8_LOGIT_ATOL,
                    INT8_GREEDY_EQUAL_MIN, attention_paths(port),
                    port.quantize.INT8, True, seeds=(1, 2), capacity=1600,
                    fill_chunks=(17, 23))
    del srv, params
    torch.cuda.empty_cache()
    return launches, metrics, launches8, metrics8


def prefill_vs_chunked(port, cfg, params, prompts, limits=PREFILL_LIMITS):
    """One-shot prefill (``make_prefill_step``, the B prompts at once)
    against the chunked path on the same prompts: each prompt's chunk
    steps of 64 into its own slot of a cache, and ``ContinuousBatchServer``
    serving the prompts with 32 new tokens.  The last-token logits within
    ``limits["logit"]``, every K/V entry of the cache (the full-attention
    rows of the prompt, the rings whole) within ``limits["cache"]`` and the
    positions equal; then 32 greedy tokens of a decode from
    ``grow_cache``, teacher-forced with the engine's tokens, equal the
    engine's on at least ``limits["greedy"]`` of them (``PREFILL_LIMITS``
    by default).  ``flash_attention`` must launch once an attention
    layer.  An SSM state (the hybrid trunk's) is held whole against the
    chunked path's at ``limits["state"]``.  Returns the launches and
    readings."""
    b, s = len(prompts), len(prompts[0])
    toks = torch.as_tensor(np.stack(prompts), device=DEV)
    step = port.serve_step.make_prefill_step(cfg)
    # MoE: the chunked path and the engine's chunks take the one-shot
    # call's expert ids and drops, the teacher-forced decode the engine's
    # (``MoEPin``; B 1, whole chunks); a free chunked run is reported
    pins = {key: MoEPin(port) for key in ("oneshot", "chunked", "engine",
                                          "decode", "free")} \
        if cfg.is_moe else {}
    check(not pins or (b == 1 and s % 64 == 0), f"MoE prefill at B {b}, S"
          f" {s}: the routing is pinned for B 1 and whole chunks only")
    n_layers, n_chunks, k = cfg.n_layers, s // 64, cfg.experts_per_tok

    def pinned(key, source=None):
        if not pins:
            return contextlib.nullcontext()
        if source is None:
            return pins[key].patch()
        return pins[key].patch(*source)

    def oneshot_rows(j, rec, width):
        c = j // n_layers
        if c >= n_chunks:
            return None
        return rec[j % n_layers][64 * width * c:64 * width * (c + 1)]
    from_oneshot = (lambda j: oneshot_rows(j, pins["oneshot"].ids, 1),
                    lambda j: oneshot_rows(j, pins["oneshot"].keeps, k))
    reset_counts(port)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with pinned("oneshot"):
        nxt, logits, cache = step(params, {"tokens": toks})
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    launches = read_counts(port)
    want = {name: 0 for name in launches}
    want["flash_attention"] = attention_layers(port, cfg)
    check(launches == want, f"prefill launches {launches} != {want}")

    kc, ss = port.kvcache, port.serve_step
    chunk_step = ss.make_chunk_prefill_step(cfg)

    def chunked_path():
        """Each prompt's chunk steps into its slot: the cache and the
        last-token logits."""
        chunked = kc.alloc_decode_cache(cfg, b, s + 64, DEV)
        last = []
        for i in range(b):
            for p in range(0, s, 64):
                c = min(64, s - p)
                tk = torch.zeros((1, 64), dtype=torch.int32, device=DEV)
                ps = torch.full((1, 64), -1, dtype=torch.int32, device=DEV)
                tk[0, :c] = toks[i, p:p + c]
                ps[0, :c] = torch.arange(p, p + c, dtype=torch.int32,
                                         device=DEV)
                kvl = torch.tensor([p + 64], dtype=torch.int32, device=DEV)
                _, lg, _ = chunk_step(params, chunked, tk, ps, i, kvl)
            last.append(lg[0, c - 1])
        return chunked, torch.stack(last)

    def gaps(chunked, last):
        """(logit gap, K/V gap, K/V largest value, SSM state gap) against
        the one-shot call; the positions must be equal."""
        cache_gap, state_gap, cache_max = 0.0, 0.0, 0.0
        for key, leaf in cache.items():
            other = chunked[key]
            if key == "ssm":
                state_gap = max(float((a.float() - b.float()).abs().max())
                                for a, b in zip(leaf, other))
                continue
            if key.endswith("_pos"):
                check(torch.equal(leaf, other[..., :leaf.shape[-1]]),
                      f"prefill {key} differs from the chunked path's")
                continue
            rows = leaf.shape[-3]
            want = other[..., :rows, :, :].float()
            cache_gap = max(cache_gap,
                            float((leaf.float() - want).abs().max()))
            cache_max = max(cache_max, float(want.abs().max()))
        logit_gap = float((logits.float() - last.float()).abs().max())
        return logit_gap, cache_gap, cache_max, state_gap

    with pinned("chunked", from_oneshot):
        logit_gap, cache_gap, cache_max, state_gap = gaps(*chunked_path())

    srv = port.server.ContinuousBatchServer(
        cfg, params, slots=b, prefill_chunk=64, max_prompt=s,
        max_new_tokens=32, device=DEV)
    reqs = srv.submit(list(prompts))
    with pinned("engine", from_oneshot):
        srv.run()
    engine = torch.tensor([r.tokens for r in reqs], device=DEV)
    grown = port.transformer.grow_cache(cfg, cache, 33)
    got = [nxt]
    fns = port.api.model_fns(cfg)
    skip = n_chunks * n_layers
    from_engine = (lambda j: pins["engine"].ids[skip + j],
                   lambda j: pins["engine"].keeps[skip + j])
    with torch.no_grad(), pinned("decode", from_engine):
        for t in range(31):
            pos = torch.full((b,), s + t, dtype=torch.int32, device=DEV)
            lg, grown = fns.forward_decode(cfg, params, grown,
                                           engine[:, t].to(torch.int32), pos)
            got.append(lg.argmax(-1).to(torch.int32))
    equal = int((torch.stack(got, 1) == engine).sum())
    reading = dict(model=cfg.name, batch=b, seq=s, logit_gap=logit_gap,
                   cache_gap=cache_gap, cache_max=cache_max,
                   greedy_equal=equal, greedy_rows=b * 32,
                   prefill_s=prefill_s)
    if "ssm" in cache:
        reading["state_gap"] = state_gap
    if pins:
        # T = B x S rows a layer against T = 64 a chunk: the capacities
        # differ, so where the one-shot call drops rows the free chunked
        # path, which drops its own, differs, and near ties flip its
        # choices; the pinned paths take the one-shot call's
        with pinned("free"):
            free = gaps(*chunked_path())
        free_ids = pins["free"].ids
        reading.update(
            oneshot_dropped_routed=pins["oneshot"].drops(),
            chunked_dropped_routed=pins["chunked"].drops(),
            free_dropped_routed=pins["free"].drops(),
            free_logit_gap=free[0], free_cache_gap=free[1],
            free_routing_differ=sum(
                int((free_ids[j] != from_oneshot[0](j)).sum())
                for j in range(len(free_ids))),
            **{f"routing_{key}": [pins[key].count("differ"),
                                  pins[key].count("choices")]
               for key in ("chunked", "engine", "decode")})
        check(all(pins[key].count("unmatched") == 0
                  for key in ("chunked", "engine", "decode")),
              "a pinned path dropped a row the one-shot call kept")
    print("  prefill " + json.dumps(reading))
    check(logit_gap <= limits["logit"], f"prefill logits: {logit_gap}")
    check(cache_gap <= limits["cache"], f"prefill cache: {cache_gap}")
    check("ssm" not in cache or state_gap <= limits["state"],
          f"prefill SSM state: {state_gap}")
    check(equal >= limits["greedy"] * b * 32,
          f"prefill greedy tokens equal on only {equal} of {b * 32}")
    return launches, reading


class MoEPin:
    """The MoE layers' routing and capacity drops in one run, recorded or
    taken from another run: inside ``patch(ids, keeps)`` the i-th
    ``route_topk`` call returns the expert ids ``ids(i)`` gives (its own
    where ``ids`` is None), weighted by the softmax of its own logits at
    them, and the i-th ``_dispatch_indices`` call keeps only rows that
    ``keeps(i)`` keeps.  Every call's ids and keep mask are recorded
    (``ids``, ``keeps``); ``differ`` counts the ``choices`` taken where
    the call's own top k differs, ``unmatched`` the rows a given mask
    keeps that this call's capacity drops.  The counts stay on the card
    until read."""

    def __init__(self, port):
        self.moe = port.moe
        self.route, self.dispatch = port.moe.route_topk, \
            port.moe._dispatch_indices
        self.ids, self.keeps = [], []

    def count(self, name) -> int:
        return int(sum(getattr(self, name), torch.zeros((), device=DEV)))

    @contextlib.contextmanager
    def patch(self, ids=None, keeps=None):
        self.ids, self.keeps = [], []
        self.differ, self.choices, self.unmatched = [], [], []

        def route(logits, k):
            own, w = self.route(logits, k)
            take = None if ids is None else ids(len(self.ids))
            if take is not None:
                self.differ.append((own != take).sum())
                self.choices.append(take.numel())
                own = take
                w = torch.softmax(logits.float().gather(-1, take), dim=-1)
            self.ids.append(own)
            return own, w

        def dispatch(logits, k, e, capacity):
            flat_e, slot_c, keep, w = self.dispatch(logits, k, e, capacity)
            take = None if keeps is None else keeps(len(self.keeps))
            if take is not None:
                self.unmatched.append((take & ~keep).sum())
                keep = keep & take
                slot_c = torch.where(keep, slot_c, capacity)
            self.keeps.append(keep)
            return flat_e, slot_c, keep, w
        with mock.patch.object(self.moe, "route_topk", route), \
                mock.patch.object(self.moe, "_dispatch_indices", dispatch):
            yield self

    def drops(self) -> list:
        """[rows dropped, rows routed] over the recorded calls."""
        return [int(sum((~k).sum() for k in self.keeps)),
                sum(k.numel() for k in self.keeps)]


def small_gemma_config(port):
    """A float32 gemma3-shaped config at a kernel's head dim: the smoke
    config's widths with heads of 256, its window of 8, 13 layers (2
    groups of 5 local and 1 global, and a local tail)."""
    return dataclasses.replace(port.configs.get_smoke("gemma3-4b"),
                               head_dim=256, n_layers=13, dtype="float32")


def small_gemma_vs_cpu(port):
    """The exact oracle of the ring: the small float32 gemma3 config on
    the card gives the CPU plain path's greedy tokens, served through
    ``ContinuousBatchServer`` (chunks of 4, prompts that wrap the window)
    and one-shot prefilled, grown and decoded."""
    cfg = small_gemma_config(port)
    rng = np.random.RandomState(2)
    prompts = [rng.randint(0, cfg.vocab_size, n).astype(np.int32)
               for n in (3, 11, 7, 21)]
    budgets = [5, 12, 6, 3]
    host = port.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    served, oneshot = {}, {}
    for dev in ("cpu", DEV):
        params = host.to(dev)
        srv = port.server.ContinuousBatchServer(
            cfg, params, slots=2, max_prompt=24, prefill_chunk=4,
            max_new_tokens=12, device=dev)
        reqs = srv.submit(prompts, max_new_tokens=budgets)
        srv.run()
        served[dev] = [r.tokens for r in reqs]
        step = port.serve_step.make_prefill_step(cfg)
        fns = port.api.model_fns(cfg)
        toks = torch.as_tensor(prompts[3][None], device=dev)
        nxt, _, cache = step(params, {"tokens": toks})
        cache = port.transformer.grow_cache(cfg, cache, 12)
        out = [int(nxt[0])]
        with torch.no_grad():
            for t in range(10):
                pos = torch.tensor([21 + t], dtype=torch.int32, device=dev)
                lg, cache = fns.forward_decode(
                    cfg, params, cache,
                    torch.tensor([out[-1]], dtype=torch.int32, device=dev),
                    pos)
                out.append(int(lg[0].argmax()))
        oneshot[dev] = out
    check(served[DEV] == served["cpu"], f"small gemma3 serving: card"
          f" {served[DEV]} != cpu {served['cpu']}")
    check(oneshot[DEV] == oneshot["cpu"], f"small gemma3 prefill: card"
          f" {oneshot[DEV]} != cpu {oneshot['cpu']}")
    print(f"  small float32 gemma3 (D 256, window 8), card == cpu tokens:"
          f" served {served[DEV]}, one-shot prefill {oneshot[DEV]}")


def prefill_phase(port):
    """One-shot prefill at full width: internlm2-1.8b (``SERVE_LAYERS``
    deep) at B 4, S 512 and gemma3-4b (``GEMMA_LAYERS`` deep) at B 1, S
    2,048 (past the window: the rings come from ``_ring_from_prefill``),
    each against the chunked path.  Returns each model's launches and
    readings."""
    out = {}
    for cfg, b, s in ((full_config(port), 4, 512),
                      (gemma_config(port), 1, 2048)):
        arch = cfg.name
        params = init_full(port, cfg)
        rng = np.random.RandomState(5)
        prompts = [rng.randint(0, cfg.vocab_size, s).astype(np.int32)
                   for _ in range(b)]
        out[arch] = prefill_vs_chunked(port, cfg, params, prompts)
        del params
        torch.cuda.empty_cache()
    small_gemma_vs_cpu(port)
    return out


def serve_granite(port):
    """granite-3-8b at full width (40 layers, d_model 4096, 32/8 heads of
    128: G 4), bf16, through ``ContinuousBatchServer`` on phase 3's
    requests, held to its launch counts."""
    cfg = port.configs.get("granite-3-8b")
    check(cfg.n_layers == 40 and cfg.n_heads // cfg.n_kv_heads == 4,
          f"unexpected config {cfg}")
    params = init_full(port, cfg, 8_179_224_576)
    srv = port.server.ContinuousBatchServer(
        cfg, params, slots=4, prefill_chunk=64, max_new_tokens=32,
        max_prompt=512, device=DEV)
    launches, metrics, _ = serve_run(port, cfg, srv,
                                     [9, 37, 64, 128, 200, 301, 450, 512])
    del srv, params
    torch.cuda.empty_cache()
    return launches, metrics


# ---------------------------------------------------------------------------
# Phase 12: slice 8 part 2 (zamba2-2.7b's hybrid trunk)
# ---------------------------------------------------------------------------
# zamba2-2.7b at full width: phase 3's eight prompts of 9 to 512 tokens, 32
# new tokens, 4 slots, chunks of 64, max_prompt 512 (capacity 576)
ZAMBA_LENS = [9, 37, 64, 128, 200, 301, 450, 512]
ZAMBA_KW = dict(slots=4, prefill_chunk=64, max_new_tokens=32,
                max_prompt=512, device=DEV)
# phase 12's depth: 6 of zamba2-2.7b's 54 layers, 1 of its 9 groups (cut
# from 18 so that the script keeps within half its time)
ZAMBA_LAYERS, ZAMBA_PARAMS = 6, 428_076_960
# The rule of LOGIT_ATOL: twice the largest of the float (and of the int8
# paged) readings on the H100 (0.2734 and 0.3223), rounded up to a power
# of two; PERF.md gives them.  Greedy tokens equal on 90.4% of the rows
# (float) and 89.9% (int8), with the plain path's own f32 against f64
# floor at 91.4% and 94.7%: at least 85% and 80% are required.
ZAMBA_LOGIT_ATOL = 1.0
ZAMBA_INT8_LOGIT_ATOL = 1.0
ZAMBA_GREEDY_EQUAL_MIN = 0.85
# One-shot prefill against the chunked path, by the same rule: 54 layers
# and 9 attention layers read gaps of 0.4492 (logits, of std 1.0), 0.6172
# (K/V) and 0.4438 (the SSM states, which the two paths reach through
# chunks of 256 and of 64), past phase 10's 0.5 on the K/V; greedy tokens
# equal on 30 of 32.
ZAMBA_PREFILL_LIMITS = dict(logit=1.0, cache=2.0, state=1.0, greedy=0.85)


def zamba_config(port):
    cfg = port.configs.get("zamba2-2.7b")
    nh = cfg.resolved_ssm_heads
    check(cfg.n_layers == 54 and cfg.d_model == 2560
          and cfg.n_heads == cfg.n_kv_heads == 32
          and cfg.resolved_head_dim == 80 and nh == 80
          and cfg.d_inner // nh == 64 and cfg.ssm_state == 64
          and cfg.padded_vocab() == 32768, f"unexpected config {cfg}")
    return dataclasses.replace(cfg, n_layers=ZAMBA_LAYERS)


def serve_zamba(port, cfg):
    """zamba2-2.7b at full width, bf16: float through
    ``ContinuousBatchServer`` and int8 through ``PagedBatchServer``, each
    held to its launch counts (one shared-block application a group and
    step), then its logits against the plain path on copies of the cache,
    as phase 3;
    a profile of its float decode and chunk steps; one-shot prefill at B
    1, S 2,048 against the chunked path.  Returns the launches and
    metrics of both runs, the prefill's launches and reading, and the
    profile."""
    params = init_full(port, cfg, ZAMBA_PARAMS)
    srv = port.server.ContinuousBatchServer(cfg, params, **ZAMBA_KW)
    check(srv.capacity == 576, f"capacity {srv.capacity} != 576")
    launches, metrics, _ = serve_run(port, cfg, srv, ZAMBA_LENS)
    del srv
    logits_vs_plain(port, cfg, params, ZAMBA_LOGIT_ATOL,
                    ZAMBA_GREEDY_EQUAL_MIN, attention_paths(port))
    prof = profile_steps(port, cfg, params)
    srv = port.server.PagedBatchServer(cfg, params, precision="int8",
                                       **ZAMBA_KW)
    launches8, metrics8, _ = serve_run(port, cfg, srv, ZAMBA_LENS)
    logits_vs_plain(port, cfg, srv.params, ZAMBA_INT8_LOGIT_ATOL,
                    INT8_GREEDY_EQUAL_MIN, attention_paths(port),
                    port.quantize.INT8, True)
    del srv
    rng = np.random.RandomState(5)
    prompts = [rng.randint(0, cfg.vocab_size, 2048).astype(np.int32)]
    prefill = prefill_vs_chunked(port, cfg, params, prompts,
                                 ZAMBA_PREFILL_LIMITS)
    del params
    torch.cuda.empty_cache()
    return launches, metrics, launches8, metrics8, prefill, prof


def small_zamba_config(port):
    """A float32 zamba2-shaped config at the shared block's head dim: the
    smoke config (6 layers, a shared block every 3, 4 SSM heads) at
    d_model 160 with 2/2 heads of 80."""
    return dataclasses.replace(port.configs.get_smoke("zamba2-2.7b"),
                               d_model=160, n_heads=2, n_kv_heads=2,
                               dtype="float32")


def small_zamba_vs_cpu(port):
    """The exact oracle of the hybrid trunk at D 80: the small float32
    config on the card gives the CPU plain path's greedy tokens, served
    through ``ContinuousBatchServer`` (chunks of 4) and, int8, through
    ``PagedBatchServer`` (blocks of 8, a pool that preempts), and one-shot
    prefilled, grown and decoded."""
    cfg = small_zamba_config(port)
    check(cfg.resolved_head_dim == 80, f"head dim {cfg.resolved_head_dim}")
    rng = np.random.RandomState(2)
    prompts = [rng.randint(0, cfg.vocab_size, n).astype(np.int32)
               for n in (3, 11, 7, 21)]
    budgets = [5, 12, 6, 3]
    host = port.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    served, paged, oneshot = {}, {}, {}
    for dev in ("cpu", DEV):
        params = host.to(dev)
        srv = port.server.ContinuousBatchServer(
            cfg, params, slots=2, max_prompt=24, prefill_chunk=4,
            max_new_tokens=12, device=dev)
        reqs = srv.submit(prompts, max_new_tokens=budgets)
        srv.run()
        served[dev] = [r.tokens for r in reqs]
        srv = port.server.PagedBatchServer(
            cfg, params, slots=3, max_prompt=24, prefill_chunk=4,
            max_new_tokens=12, block_size=8, pool_blocks=7,
            precision="int8", device=dev)
        reqs = srv.submit(prompts, max_new_tokens=budgets)
        metrics = srv.run()
        check(metrics["preemptions"] > 0, "the small int8 pool never"
              " preempted")
        paged[dev] = [r.tokens for r in reqs]
        step = port.serve_step.make_prefill_step(cfg)
        fns = port.api.model_fns(cfg)
        toks = torch.as_tensor(prompts[3][None], device=dev)
        nxt, _, cache = step(params, {"tokens": toks})
        cache = port.transformer.grow_cache(cfg, cache, 12)
        out = [int(nxt[0])]
        with torch.no_grad():
            for t in range(10):
                pos = torch.tensor([21 + t], dtype=torch.int32, device=dev)
                lg, cache = fns.forward_decode(
                    cfg, params, cache,
                    torch.tensor([out[-1]], dtype=torch.int32, device=dev),
                    pos)
                out.append(int(lg[0].argmax()))
        oneshot[dev] = out
    check(served[DEV] == served["cpu"], f"small zamba2 serving: card"
          f" {served[DEV]} != cpu {served['cpu']}")
    check(paged[DEV] == paged["cpu"], f"small zamba2 int8 paged: card"
          f" {paged[DEV]} != cpu {paged['cpu']}")
    check(oneshot[DEV] == oneshot["cpu"], f"small zamba2 prefill: card"
          f" {oneshot[DEV]} != cpu {oneshot['cpu']}")
    print(f"  small float32 zamba2 (D 80), card == cpu tokens: served"
          f" {served[DEV]}, int8 paged {paged[DEV]}, one-shot prefill"
          f" {oneshot[DEV]}")


def zamba_phase(port):
    """Phase 12: zamba2-2.7b served and prefilled at full width, then the
    small float32 oracle.  Returns ``serve_zamba``'s results."""
    t0 = time.perf_counter()
    out = serve_zamba(port, zamba_config(port))
    small_zamba_vs_cpu(port)
    launches, metrics, launches8, metrics8 = out[:4]
    print(f"  tokens_per_s zamba2 float {metrics['tokens_per_s']:.2f}, int8"
          f" paged {metrics8['tokens_per_s']:.2f}  ttft_p50_s"
          f" {metrics['ttft_p50_s']:.4f} / {metrics8['ttft_p50_s']:.4f}"
          f"  state and kv bytes {metrics['kv_cache_bytes']} /"
          f" {metrics8['kv_cache_bytes']}  phase"
          f" {time.perf_counter() - t0:.1f} s")
    return out


# ---------------------------------------------------------------------------
# Phase 13: slice 9 part 1 (the MoE decoders)
# ---------------------------------------------------------------------------
PHI, DBRX = "phi3.5-moe-42b-a6.6b", "dbrx-132b"
# Depth cuts, widths untouched: phi3.5-moe takes 2.42 GiB of bf16 weights
# a layer (16 experts of 4096 x 6400, three banks), so all 32 layers (77.5
# GiB and 0.5 GiB of embeddings) leave no room for a cache on an 80 GB
# card; 24 layers (58.6 GiB) fit, and 6 (15.0 GiB) keep the script within
# half its time.  dbrx-132b takes 6.07 GiB a layer and 2.3 GiB of
# embeddings: 8 of its 40 layers, 50.9 GiB.
MOE_LAYERS = {PHI: 6, DBRX: 8}
MOE_PARAMS = {PHI: 8_070_287_360, DBRX: 27_305_809_920}
# (layers, d_model, heads, KV heads, d_ff, experts, top-k) of the full
# configs
MOE_WIDTHS = {PHI: (32, 4096, 32, 8, 6400, 16, 2),
              DBRX: (40, 6144, 48, 8, 10752, 16, 4)}
# phase 3's eight requests, 4 slots, chunks of 64, 32 new tokens
MOE_KW = dict(slots=4, prefill_chunk=64, max_new_tokens=32, max_prompt=512,
              device=DEV)
# Logits against the plain path, the plain path taking the kernel path's
# expert ids and drops (``MoEPin``): left free, a near tie's flipped
# choice sends a row down another expert, and at 24 random layers the
# logits then differ by up to 6.5 (std 1.28), the plain path against
# itself in float64 as much.  By the rule of LOGIT_ATOL, twice the
# largest reading on the H100 (phi3.5-moe 0.4141 float, 0.4746 int8;
# dbrx 0.6753), rounded up to a power of two; PERF.md gives them.  Greedy
# tokens equal on 91.9% (float), 88.8% (int8) and 92% (dbrx) of the rows,
# the plain path's own f32-vs-f64 floor 92.2%, 91.7% and 93%: at least
# 85% and 80% are required.
MOE_LOGIT_ATOL = {PHI: 1.0, DBRX: 2.0}
MOE_INT8_LOGIT_ATOL = 1.0
MOE_GREEDY_EQUAL_MIN = 0.85
MOE_INT8_GREEDY_EQUAL_MIN = 0.8
# One-shot prefill against the chunked path, the chunked path taking the
# one-shot call's expert ids and drops (the one-shot call drops 526 of
# its 65,536 rows, the chunks none of theirs; left free the gaps read 9.1
# and 9.1): logits 0.4756, K/V 0.7471 (values up to 8.69), greedy 30 of
# 32, by the same rule.
MOE_PREFILL_LIMITS = dict(logit=1.0, cache=2.0, greedy=0.85)
# Training phi3.5-moe: 2 of 32 layers (2,869,055,488 parameters: f32
# masters, gradients and AdamW's two moments take about 46 GB), B 1 x S
# 2,048, remat "full", 3 steps
MOE_TRAIN_LAYERS, MOE_TRAIN_PARAMS, MOE_TRAIN_STEPS = 2, 2_869_055_488, 3


def moe_config(port, arch, layers=None):
    """The full config, checked against its published widths, at
    ``layers`` (default ``MOE_LAYERS``) of its depth."""
    cfg = port.configs.get(arch)
    got = (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_ff,
           cfg.n_experts, cfg.experts_per_tok)
    check(got == MOE_WIDTHS[arch] and cfg.resolved_head_dim == 128,
          f"unexpected config {cfg}")
    return dataclasses.replace(cfg, n_layers=layers or MOE_LAYERS[arch])


def routing_summary(readings) -> dict:
    return dict(choices=sum(r["routing_choices"] for r in readings),
                differ=sum(r["routing_differ"] for r in readings),
                f64_differ=sum(r.get("f64_routing_differ", 0)
                               for r in readings),
                max_logit_gap=max(r["max_abs_gap"] for r in readings),
                greedy_equal=sum(r["argmax_equal"] for r in readings),
                rows=sum(r["rows"] for r in readings))


def serve_phi(port):
    """phi3.5-moe at full width and ``MOE_LAYERS``, bf16: phase 3's requests
    through ``ContinuousBatchServer`` (float) and phase 5's shared-prefix
    requests through ``PagedBatchServer`` (int8, a pool of 16 blocks),
    each held to its launch counts, its logits against the plain path on
    copies of the cache (the plain path taking the kernel path's expert
    ids and drops, its own choices counted where they differ); the prefix
    cache must hit.  A profile of its float decode and chunk steps."""
    cfg = moe_config(port, PHI)
    params = init_full(port, cfg, MOE_PARAMS[PHI])
    srv = port.server.ContinuousBatchServer(cfg, params, **MOE_KW)
    check(srv.capacity == 576, f"capacity {srv.capacity} != 576")
    launches, metrics, _ = serve_run(port, cfg, srv, ZAMBA_LENS)
    del srv
    logits = logits_vs_plain(port, cfg, params, MOE_LOGIT_ATOL[PHI],
                             MOE_GREEDY_EQUAL_MIN, attention_paths(port),
                             seeds=(1, 2, 3))
    prof = profile_steps(port, cfg, params)
    srv = port.server.PagedBatchServer(cfg, params, pool_blocks=16,
                                       precision="int8", **MOE_KW)
    launches8, metrics8, _ = serve_run(port, cfg, srv, None,
                                       shared_prefix_prompts(cfg))
    check(metrics8["prefix_hit_blocks"] >= 1, f"no prefix hit: {metrics8}")
    logits8 = logits_vs_plain(port, cfg, srv.params, MOE_INT8_LOGIT_ATOL,
                              MOE_INT8_GREEDY_EQUAL_MIN,
                              attention_paths(port), port.quantize.INT8,
                              True, seeds=(1, 2))
    del srv, params
    torch.cuda.empty_cache()
    return dict(launches=launches, metrics=metrics, launches8=launches8,
                metrics8=metrics8, profile=prof,
                routing=routing_summary(logits),
                routing_int8=routing_summary(logits8))


def serve_dbrx(port):
    """dbrx-132b at full width and 8 layers, bf16 (G 6): phase 3's
    requests through ``ContinuousBatchServer``, its logits against the
    plain path (one seed, the routing pinned as phi3.5-moe's), and
    one-shot prefill at B 1, S 2,048 against the chunked path, with the
    rows each side drops."""
    cfg = moe_config(port, DBRX)
    params = init_full(port, cfg, MOE_PARAMS[DBRX])
    srv = port.server.ContinuousBatchServer(cfg, params, **MOE_KW)
    launches, metrics, _ = serve_run(port, cfg, srv, ZAMBA_LENS)
    del srv
    logits = logits_vs_plain(port, cfg, params, MOE_LOGIT_ATOL[DBRX],
                             MOE_GREEDY_EQUAL_MIN, attention_paths(port),
                             seeds=(1,))
    rng = np.random.RandomState(5)
    prompts = [rng.randint(0, cfg.vocab_size, 2048).astype(np.int32)]
    prefill = prefill_vs_chunked(port, cfg, params, prompts,
                                 MOE_PREFILL_LIMITS)
    del params
    torch.cuda.empty_cache()
    return dict(launches=launches, metrics=metrics, prefill=prefill,
                routing=routing_summary(logits))


def train_phi(port):
    """phi3.5-moe at full width and 2 layers: f32 masters from a seeded
    generator on the card, bf16 activations, ``make_train_step`` (remat
    "full", AdamW) for 3 steps of B 1 x S 2,048 from the Markov stream:
    finite losses, ``flash_attention`` launched 2 x 2 a step (forward and
    recomputed forward) and its backward 2.  Step ms, tokens/s, losses,
    peak memory."""
    cfg = moe_config(port, PHI, MOE_TRAIN_LAYERS)
    params = port.init_params(cfg, torch.Generator(device=DEV).manual_seed(0),
                              DEV, trainable=True)
    n = sum(p.numel() for p in params.parameters())
    check(n == MOE_TRAIN_PARAMS, f"{n} trainable parameters")
    opt_state = port.optimizer.adamw_init(params)
    step = port.train_step.make_train_step(
        cfg, remat="full", opt=port.optimizer.AdamWConfig(lr=TRAIN_LR))
    tokens = port.synthetic.token_stream(TRAIN_TOKENS, TRAIN_STREAM_VOCAB,
                                         seed=1)
    batches = port.synthetic.lm_batches(tokens, 1, TRAIN_SEQ, seed=0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(port)
    losses, times = [], []
    for _ in range(MOE_TRAIN_STEPS):
        t0 = time.perf_counter()
        _, _, m = step(params, opt_state, next(batches))
        losses.append(float(m["loss"]))
        times.append((time.perf_counter() - t0) * 1e3)
    launches = read_counts(port)
    peak = torch.cuda.max_memory_allocated()
    check(all(np.isfinite(losses)), f"training losses {losses}")
    want = {name: 0 for name in launches}
    want.update(flash_attention=2 * MOE_TRAIN_LAYERS * MOE_TRAIN_STEPS,
                flash_attention_bwd=MOE_TRAIN_LAYERS * MOE_TRAIN_STEPS)
    check(launches == want, f"training launches {launches} != {want}")
    metrics = dict(params=n, losses=losses, step_ms_all=times,
                   step_ms=float(np.median(times[1:])),
                   tokens_per_s=TRAIN_SEQ / np.median(times[1:]) * 1e3,
                   peak_memory_bytes=peak)
    print("  training " + json.dumps(metrics))
    del params, opt_state
    torch.cuda.empty_cache()
    return launches, metrics


def small_moe_config(port, arch):
    """The smoke config in float32 at the kernels' head dim (128, d_model
    256) with the full config's head group: G 4 (phi3.5-moe), G 6
    (dbrx)."""
    g = MOE_WIDTHS[arch][2] // MOE_WIDTHS[arch][3]
    return dataclasses.replace(port.configs.get_smoke(arch), d_model=256,
                               n_heads=g, n_kv_heads=1, head_dim=128,
                               dtype="float32")


def small_moe_vs_cpu(port):
    """The exact oracle of each MoE decoder: its small float32 config on
    the card gives the CPU plain path's greedy tokens, served through
    ``ContinuousBatchServer`` (chunks of 4) and, int8, through
    ``PagedBatchServer`` (blocks of 8, a pool that preempts), and one-shot
    prefilled, grown and decoded; and on the card its decode step, with
    the routing, captured as a CUDA graph (``use_artifact``) gives the
    eager tokens, one replay a decode step."""
    rng = np.random.RandomState(2)
    budgets = [5, 12, 6, 3]
    out = {}
    for arch in (PHI, DBRX):
        cfg = small_moe_config(port, arch)
        prompts = [rng.randint(0, cfg.vocab_size, n).astype(np.int32)
                   for n in (3, 11, 7, 21)]
        host = port.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        kw = dict(slots=2, max_prompt=24, prefill_chunk=4,
                  max_new_tokens=12)
        runs = {}
        for dev in ("cpu", DEV):
            params = host.to(dev)
            srv = port.server.ContinuousBatchServer(cfg, params, device=dev,
                                                    **kw)
            reqs = srv.submit(prompts, max_new_tokens=budgets)
            srv.run()
            served = [r.tokens for r in reqs]
            srv = port.server.PagedBatchServer(
                cfg, params, slots=3, max_prompt=24, prefill_chunk=4,
                max_new_tokens=12, block_size=8, pool_blocks=7,
                precision="int8", device=dev)
            reqs = srv.submit(prompts, max_new_tokens=budgets)
            metrics = srv.run()
            check(metrics["preemptions"] > 0, "the small int8 pool never"
                  " preempted")
            paged = [r.tokens for r in reqs]
            toks = torch.as_tensor(prompts[3][None], device=dev)
            nxt, _, cache = port.serve_step.make_prefill_step(cfg)(
                params, {"tokens": toks})
            cache = port.transformer.grow_cache(cfg, cache, 12)
            oneshot = [int(nxt[0])]
            with torch.no_grad():
                for t in range(10):
                    lg, cache = port.transformer.forward_decode(
                        cfg, params, cache,
                        torch.tensor([oneshot[-1]], dtype=torch.int32,
                                     device=dev),
                        torch.tensor([21 + t], dtype=torch.int32,
                                     device=dev))
                    oneshot.append(int(lg[0].argmax()))
            runs[dev] = (served, paged, oneshot)
        srv = port.server.ContinuousBatchServer(
            cfg, host.to(DEV), device=DEV, use_artifact=True, **kw)
        reqs = srv.submit(prompts, max_new_tokens=budgets)
        metrics = srv.run()
        graph = [r.tokens for r in reqs]
        check(runs[DEV] == runs["cpu"], f"small {arch}: card {runs[DEV]}"
              f" != cpu {runs['cpu']}")
        check(graph == runs[DEV][0] and isinstance(srv.decode,
                                                   port.eon.GraphStep)
              and srv.decode.replays == metrics["decode_steps"],
              f"small {arch} from the CUDA graph: {graph} != eager"
              f" {runs[DEV][0]}")
        out[arch] = runs[DEV]
        print(f"  small float32 {arch} (G {cfg.n_heads}, D 128), card =="
              f" cpu tokens: served {runs[DEV][0]}, int8 paged"
              f" {runs[DEV][1]}, one-shot prefill {runs[DEV][2]}; the"
              f" decode step as a CUDA graph gives the served tokens over"
              f" {metrics['decode_steps']} replays")
    return out


def moe_phase(port):
    """Phase 13: phi3.5-moe and dbrx-132b served (and dbrx prefilled) at
    full width, phi3.5-moe trained at 2 layers, then the small float32
    oracles.  Returns the readings by part."""
    t0 = time.perf_counter()
    phi = serve_phi(port)
    t1 = time.perf_counter()
    dbrx = serve_dbrx(port)
    t2 = time.perf_counter()
    train = train_phi(port)
    small_moe_vs_cpu(port)
    print(f"  tokens_per_s phi3.5-moe float"
          f" {phi['metrics']['tokens_per_s']:.2f},"
          f" int8 paged {phi['metrics8']['tokens_per_s']:.2f} (prefix hit"
          f" blocks {phi['metrics8']['prefix_hit_blocks']}), dbrx"
          f" {dbrx['metrics']['tokens_per_s']:.2f}; routing choices"
          f" differing from the plain path: phi3.5-moe"
          f" {phi['routing']['differ']} of {phi['routing']['choices']}"
          f" (int8 {phi['routing_int8']['differ']} of"
          f" {phi['routing_int8']['choices']}), dbrx"
          f" {dbrx['routing']['differ']} of {dbrx['routing']['choices']};"
          f" training step {train[1]['step_ms']:.1f} ms, peak"
          f" {train[1]['peak_memory_bytes'] / 2**30:.2f} GiB; phi3.5-moe"
          f" part {t1 - t0:.1f} s, dbrx part {t2 - t1:.1f} s, phase"
          f" {time.perf_counter() - t0:.1f} s")
    return dict(phi=phi, dbrx=dbrx, train=train)


# ---------------------------------------------------------------------------
# Phase 14: slice 9 part 2 (the encoder-decoder backbone)
# ---------------------------------------------------------------------------
SEAMLESS = "seamless-m4t-large-v2"
# (decoder layers, encoder layers, d_model, heads, KV heads, head dim,
# d_ff, padded vocab) of the full config
SEAMLESS_WIDTHS = (24, 24, 1024, 16, 16, 64, 8192, 258048)
# phase 14's depth: 6 of the 24 decoder and 6 of the 24 encoder layers
# (cut from all of them so that the script keeps within half its time)
SEAMLESS_LAYERS, SEAMLESS_PARAMS = (6, 6), 906_002_432
# 4 rows, each an encoder pass over 512 frames (the stub frontend's
# embeddings, B 4 x S_enc 512 x 1,024) and a decoder prompt of 64 tokens,
# then 64 greedy decode steps; the chunked path in chunks of 16 into a
# cache of 128 (the one-shot cache grown by 64)
ENCDEC_B, ENCDEC_ENC, ENCDEC_PROMPT, ENCDEC_NEW = 4, 512, 64, 64
ENCDEC_CHUNK = 16
# the chunked path's plain run stops after its chunks and this many decode
# steps (the decode kernel is held over all 64 in the one-shot path)
ENCDEC_PLAIN_CHUNKED_STEPS = 16
# Logits of each path (one-shot and chunked, each teacher-forced with the
# float one-shot run's tokens) against the same path through the plain
# kernels, and the float one-shot against the float chunked path.  By the
# rule of LOGIT_ATOL, twice the largest reading on the H100 rounded up to
# a power of two (float 0.2046, int8 0.6973, one-shot against chunked
# 0.0869).  Greedy tokens equal on 88.2% to 91.5% (float) and 59.6% to
# 64.7% (int8) of the rows: random weights leave near ties at the top of
# 256,206 logits, and under int8 a single-ulp attention difference moves
# a per-row activation quantizer by a step (the plain path against itself
# with float64 attention agrees on 86.2%); the small int8 config gives
# the CPU's tokens exactly (PERF.md gives the readings).
ENCDEC_LOGIT_ATOL = {"float": 0.5, "int8": 2.0}
ENCDEC_GREEDY_EQUAL_MIN = {"float": 0.85, "int8": 0.5}
ENCDEC_CHUNKED_LIMITS = dict(logit=0.25, greedy=0.9)
# Training at phase 14's depth: B 2 x S 2,048 (S_enc 512), remat "full",
# 3 steps
ENCDEC_TRAIN_BATCH, ENCDEC_TRAIN_SEQ, ENCDEC_TRAIN_STEPS = 2, 2048, 3
# The small float32 config (D 64) on the card against the CPU: greedy
# tokens equal, logits within twice the largest reading on the H100
# rounded up to a power of two (float 7.45e-7, int8 3.58e-7)
ENCDEC_SMALL_LOGIT_ATOL = {"float": 2.0 ** -19, "int8": 2.0 ** -20}


def encdec_config(port):
    cfg = port.configs.get(SEAMLESS)
    got = (cfg.n_layers, cfg.n_enc_layers, cfg.d_model, cfg.n_heads,
           cfg.n_kv_heads, cfg.resolved_head_dim, cfg.d_ff,
           cfg.padded_vocab())
    check(got == SEAMLESS_WIDTHS and cfg.is_encdec, f"unexpected config"
          f" {cfg}")
    return dataclasses.replace(cfg, n_layers=SEAMLESS_LAYERS[0],
                               n_enc_layers=SEAMLESS_LAYERS[1])


def plain_flash_attention(ref, dtype=torch.float32):
    """The whole-sequence attention's plain version in f32 (or ``dtype``)
    from the same inputs (and positions), rounded once to the working
    dtype."""
    def call(q, k, v, *, causal=True, window=0, q_pos=None, k_pos=None):
        return ref.flash_attention_ref(q.to(dtype), k.to(dtype), v.to(dtype),
                                       causal, window, q_pos,
                                       k_pos).to(q.dtype)
    return call


def encdec_plain(port, dtype=torch.float32) -> list:
    """Patches that send every kernel of the enc-dec path to its plain
    version: both attention kernels of the serving layers and
    ``flash_attention`` in f32 (or ``dtype``) rounded once, the plain int8
    matmul."""
    layers, ops, ref = port.layers, port.ops, port.ref
    return [mock.patch.multiple(
        layers, flash_attention=plain_flash_attention(ref, dtype),
        decode_attention=rounded_once(ref, "decode", dtype),
        chunk_attention=rounded_once(ref, "chunk", dtype)),
        mock.patch.object(ops, "int8_matmul", ref.int8_matmul_ref)]


def encdec_expected(cfg, path: str, int8: bool) -> dict:
    """The launches of one run of ``path`` ("oneshot": prefill and
    ``ENCDEC_NEW`` decode steps; "chunked": ``init_chunk_cache``, the
    chunks, the same decode steps).  A decode step's layer attends twice
    (self, cross) and runs 9 projections (q, k, v, o; the cross q, o; the
    MLP's 3); a prefill's decoder layer 11 (the cross K/V too), an
    encoder layer 7."""
    n, e = cfg.n_layers, cfg.n_enc_layers
    chunks = ENCDEC_PROMPT // ENCDEC_CHUNK
    want = dict(flash_decode=2 * n * ENCDEC_NEW, flash_chunk_prefill=0,
                int8_matmul=0, mel_frontend=0, flash_attention=e,
                flash_attention_bwd=0, mamba_scan=0, mamba_scan_bwd=0)
    mm = 7 * e + 9 * n * ENCDEC_NEW
    if path == "oneshot":
        want["flash_attention"] += 2 * n
        mm += 11 * n
    else:
        want["flash_chunk_prefill"] = 2 * n * chunks
        mm += 2 * n + 9 * n * chunks
    if int8:
        want["int8_matmul"] = mm
    return want


def encdec_run(port, cfg, params, enc, prompts, policy, path, forced=None,
               steps=None):
    """One run of ``path``: the one-shot prefill, ``grow_cache`` by
    ``ENCDEC_NEW`` and ``steps`` (default ``ENCDEC_NEW``) decode steps,
    or ``init_chunk_cache`` (capacity prompt + new), chunks of
    ``ENCDEC_CHUNK`` and the same decode steps.  Each step takes the greedy token, or ``forced[:, t]``
    (teacher forcing).  The cross caches must come out bitwise unchanged.
    Returns (logits of the prompt's last row and of each step, tokens fed,
    decode wall s)."""
    ed, dev = port.encdec, DEV
    b, s = prompts.shape
    steps = ENCDEC_NEW if steps is None else steps
    with torch.no_grad():
        if path == "oneshot":
            last, cache = ed.forward_prefill(
                cfg, params, {"enc_embeddings": enc, "tokens": prompts},
                policy)
            cache = port.transformer.grow_cache(cfg, cache, ENCDEC_NEW)
        else:
            cache = ed.init_chunk_cache(cfg, params, enc, s + ENCDEC_NEW,
                                        policy)
            for p in range(0, s, ENCDEC_CHUNK):
                pos = torch.arange(p, p + ENCDEC_CHUNK, dtype=torch.int32,
                                   device=dev)[None].expand(b, -1)
                kvl = torch.full((b,), p + ENCDEC_CHUNK, dtype=torch.int32,
                                 device=dev)
                lg, cache = ed.forward_prefill_chunk(
                    cfg, params, cache, prompts[:, p:p + ENCDEC_CHUNK],
                    pos.contiguous(), policy, kv_len=kvl)
            last = lg[:, -1]
        cross = {key: Steps.copy({key: cache[key]})[key]
                 for key in ("xk", "xv", "enc_pos")}
        logits = [last]
        fed = [last.argmax(-1).to(torch.int32) if forced is None
               else forced[:, 0]]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for t in range(steps):
            pos = torch.full((b,), s + t, dtype=torch.int32, device=dev)
            lg, cache = ed.forward_decode(cfg, params, cache, fed[-1], pos,
                                          policy=policy, kv_len=pos + 1)
            logits.append(lg)
            if t + 1 < steps:
                fed.append(lg.argmax(-1).to(torch.int32) if forced is None
                           else forced[:, t + 1])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    for key, leaf in cross.items():
        same = all(torch.equal(a, c) for a, c in zip(
            leaf if isinstance(leaf, tuple) else (leaf,),
            cache[key] if isinstance(leaf, tuple) else (cache[key],)))
        check(same, f"enc-dec {path}: the cross cache {key} was written")
    return torch.stack(logits), torch.stack(fed, 1), wall


def logit_reading(got, want) -> dict:
    """Largest |got - want| over every step and row, and the rows whose
    greedy tokens agree."""
    gap = max(float((g.float() - w.float()).abs().max())
              for g, w in zip(got, want))
    equal = int((got.argmax(-1) == want.argmax(-1)).sum())
    return dict(max_abs_gap=gap, greedy_equal=equal,
                rows=got.shape[0] * got.shape[1])


def time_encoder(port, cfg, params, enc, policy) -> float:
    """Median ms of the encoder pass (``encode``) over 3 calls, device
    time between events."""
    times = []
    with torch.no_grad():
        for _ in range(4):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            port.encdec.encode(cfg, params, enc, policy=policy)
            b.record()
            torch.cuda.synchronize()
            times.append(a.elapsed_time(b))
    return float(np.median(times[1:]))


def serve_encdec(port, cfg):
    """seamless-m4t-large-v2 at full width and ``SEAMLESS_LAYERS``, bf16,
    seeded weights: the one-shot and the chunked paths in float, then in native
    int8, each held to its launch counts and, teacher-forced with the
    float one-shot run's tokens, to the same path through the plain
    kernels; the float one-shot against the float chunked path (the int8
    gap printed: the one-shot prefill attends the unquantized K/V, the
    chunks the quantized cross entries).  The decode loop's tokens/s, the
    encoder pass's ms and a profile of one decode step."""
    params = port.init_params(cfg, torch.Generator(device=DEV).manual_seed(0),
                              DEV)
    n = sum(p.numel() for p in params.parameters())
    check(n == SEAMLESS_PARAMS, f"{n} parameters")
    gen = torch.Generator(device=DEV).manual_seed(11)
    inputs = port.api.synthetic_inputs(cfg, ENCDEC_B, 4 * ENCDEC_ENC, gen,
                                       train=False, device=DEV)
    enc = inputs["enc_embeddings"]
    prompts = inputs["tokens"][:, :ENCDEC_PROMPT].contiguous()
    check(tuple(enc.shape) == (ENCDEC_B, ENCDEC_ENC, cfg.d_model),
          f"frame embeddings {tuple(enc.shape)}")
    with torch.no_grad():
        _, warm = port.encdec.forward_prefill(
            cfg, params, {"enc_embeddings": enc, "tokens": prompts})
        warm = port.transformer.grow_cache(cfg, warm, 2)
        for t in range(2):
            pos = torch.full((ENCDEC_B,), ENCDEC_PROMPT + t,
                             dtype=torch.int32, device=DEV)
            port.encdec.forward_decode(cfg, params, warm, prompts[:, t], pos)
        del warm
    out = {"launches": {}, "metrics": {}}
    forced = None
    runs = {}
    for precision in ("float", "int8"):
        t_prec = time.perf_counter()
        policy = None if precision == "float" else port.quantize.INT8
        weights = params if policy is None else \
            port.quantize.quantize_model_params(params, policy)
        encoder_ms = time_encoder(port, cfg, weights, enc, policy)
        for path in ("oneshot", "chunked"):
            key = f"{path}_{precision}"
            reset_counts(port)
            torch.cuda.synchronize()
            logits, fed, wall = encdec_run(port, cfg, weights, enc, prompts,
                                           policy, path, forced)
            launches = read_counts(port)
            want = encdec_expected(cfg, path, policy is not None)
            check(launches == want, f"enc-dec {key} launches {launches} !="
                  f" {want}")
            if forced is None:
                forced = fed
            steps = ENCDEC_NEW if path == "oneshot" else \
                ENCDEC_PLAIN_CHUNKED_STEPS
            with patched(encdec_plain(port)):
                plain, _, _ = encdec_run(port, cfg, weights, enc, prompts,
                                         policy, path, forced, steps)
            reading = logit_reading(logits[:1 + steps], plain)
            runs[key] = logits
            out["launches"][key] = launches
            out["metrics"][key] = dict(
                vs_plain=reading, decode_wall_s=wall,
                tokens_per_s=ENCDEC_B * ENCDEC_NEW / wall,
                encoder_ms=encoder_ms)
            if path == "oneshot" and policy is not None:
                # the noise floor: the plain path against itself with its
                # attention in float64
                with patched(encdec_plain(port, torch.float64)):
                    plain64, _, _ = encdec_run(port, cfg, weights, enc,
                                               prompts, policy, path, forced)
                out["metrics"][key]["plain_vs_plain64"] = logit_reading(
                    plain, plain64)
                del plain64
            del plain
            print(f"  enc-dec {key}: " + json.dumps(out["metrics"][key]))
            check(reading["max_abs_gap"] <= ENCDEC_LOGIT_ATOL[precision],
                  f"enc-dec {key} logits against the plain path:"
                  f" {reading['max_abs_gap']}")
            check(reading["greedy_equal"] >= ENCDEC_GREEDY_EQUAL_MIN[
                precision] * reading["rows"], f"enc-dec {key} greedy"
                f" tokens equal the plain path's on only"
                f" {reading['greedy_equal']} of {reading['rows']}")
        gap = logit_reading(runs[f"chunked_{precision}"],
                            runs[f"oneshot_{precision}"])
        out["metrics"][f"oneshot_vs_chunked_{precision}"] = gap
        print(f"  enc-dec one-shot against chunked, {precision}: "
              + json.dumps(gap))
        if precision == "float":
            check(gap["max_abs_gap"] <= ENCDEC_CHUNKED_LIMITS["logit"],
                  f"enc-dec one-shot against chunked: {gap['max_abs_gap']}")
            check(gap["greedy_equal"] >= ENCDEC_CHUNKED_LIMITS["greedy"]
                  * gap["rows"], f"enc-dec one-shot against chunked: greedy"
                  f" equal on only {gap['greedy_equal']} of {gap['rows']}")
            out["profile"] = profile_encdec_decode(port, cfg, params, enc,
                                                   prompts)
        print(f"  {precision} part {time.perf_counter() - t_prec:.1f} s")
        del weights
    del params, runs
    torch.cuda.empty_cache()
    return out


def profile_encdec_decode(port, cfg, params, enc, prompts) -> dict:
    """Host wall, device busy, idle share and kernels of one float decode
    step (4 rows, the cache of the one-shot prefill grown by 64), eight
    steps traced."""
    ed = port.encdec
    with torch.no_grad():
        _, cache = ed.forward_prefill(
            cfg, params, {"enc_embeddings": enc, "tokens": prompts})
        cache = port.transformer.grow_cache(cfg, cache, ENCDEC_NEW)
        tok = prompts[:, -1].contiguous()

        def step(i):
            pos = torch.full((ENCDEC_B,), ENCDEC_PROMPT + i, dtype=torch.int32,
                             device=DEV)
            lg, _ = ed.forward_decode(cfg, params, cache, tok, pos,
                                      kv_len=pos + 1)
            return (lg.argmax(-1),)
        return profile_step("enc-dec float decode", step, 8)


def train_encdec(port, cfg):
    """seamless-m4t-large-v2 at full width and ``SEAMLESS_LAYERS``: f32
    masters from a
    seeded generator on the card, bf16 activations, ``make_train_step``
    (remat "full", AdamW) for 3 steps of B 2 x S 2,048 (S_enc 512, the
    stub frontend's frame embeddings from ``api.synthetic_inputs``):
    finite losses; ``flash_attention`` launched 2 x 18 a step (the
    encoder's 6 and the decoder's self and cross 12, and each recomputed)
    and its backward 18.  Step ms, losses, peak memory."""
    params = port.init_params(cfg, torch.Generator(device=DEV).manual_seed(0),
                              DEV, trainable=True)
    n = sum(p.numel() for p in params.parameters())
    check(n == SEAMLESS_PARAMS, f"{n} trainable parameters")
    opt_state = port.optimizer.adamw_init(params)
    step = port.train_step.make_train_step(
        cfg, remat="full", opt=port.optimizer.AdamWConfig(lr=TRAIN_LR))
    gen = torch.Generator(device=DEV).manual_seed(12)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(port)
    losses, times = [], []
    for _ in range(ENCDEC_TRAIN_STEPS):
        batch = port.api.synthetic_inputs(cfg, ENCDEC_TRAIN_BATCH,
                                          ENCDEC_TRAIN_SEQ, gen, device=DEV)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, _, m = step(params, opt_state, batch)
        losses.append(float(m["loss"]))
        times.append((time.perf_counter() - t0) * 1e3)
    launches = read_counts(port)
    peak = torch.cuda.max_memory_allocated()
    check(all(np.isfinite(losses)), f"training losses {losses}")
    attn = cfg.n_enc_layers + 2 * cfg.n_layers
    want = {name: 0 for name in launches}
    want.update(flash_attention=2 * attn * ENCDEC_TRAIN_STEPS,
                flash_attention_bwd=attn * ENCDEC_TRAIN_STEPS)
    check(launches == want, f"training launches {launches} != {want}")
    tokens = ENCDEC_TRAIN_BATCH * ENCDEC_TRAIN_SEQ
    metrics = dict(params=n, losses=losses, step_ms_all=times,
                   step_ms=float(np.median(times[1:])),
                   tokens_per_s=tokens / np.median(times[1:]) * 1e3,
                   peak_memory_bytes=peak)
    print("  training " + json.dumps(metrics))
    del params, opt_state
    torch.cuda.empty_cache()
    return launches, metrics


def small_encdec_config(port):
    """The smoke config in float32 at d_model 256 (4 heads of 64, the
    kernels' least head dim; the smoke config's 16 runs only the plain
    versions)."""
    return dataclasses.replace(port.configs.get_smoke(SEAMLESS),
                               d_model=256, dtype="float32")


def small_encdec_vs_cpu(port) -> dict:
    """The exact oracle: the small float32 config on the card gives the
    CPU plain path's greedy tokens, in float and in native int8 (the same
    quantized weights), one-shot (prefill, ``grow_cache``, 8 decode
    steps) and chunked (chunks of 4), logits within
    ``ENCDEC_SMALL_LOGIT_ATOL``."""
    cfg = small_encdec_config(port)
    check(cfg.resolved_head_dim == 64, f"head dim {cfg.resolved_head_dim}")
    host = port.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    inputs = port.api.synthetic_inputs(cfg, 2, 24, torch.Generator()
                                       .manual_seed(1), train=False,
                                       device="cpu")
    ed = port.encdec
    readings = {}
    for precision in ("float", "int8"):
        policy = None if precision == "float" else port.quantize.INT8
        weights = host if policy is None else \
            port.quantize.quantize_model_params(host, policy)
        runs = {}
        for dev in ("cpu", DEV):
            params = weights if dev == "cpu" else \
                copy.deepcopy(weights).to(dev)
            enc, toks = (inputs[k].to(dev)
                         for k in ("enc_embeddings", "tokens"))
            with torch.no_grad():
                lg, cache = ed.forward_prefill(
                    cfg, params, {"enc_embeddings": enc, "tokens": toks},
                    policy)
                cache = port.transformer.grow_cache(cfg, cache, 8)
                logits, fed = [lg], [lg.argmax(-1).to(torch.int32)]
                for t in range(8):
                    lg, cache = ed.forward_decode(
                        cfg, params, cache, fed[-1],
                        torch.full((2,), 24 + t, dtype=torch.int32,
                                   device=dev), policy=policy)
                    logits.append(lg)
                    fed.append(lg.argmax(-1).to(torch.int32))
                chunked = ed.init_chunk_cache(cfg, params, enc, 32, policy)
                for p in range(0, 24, 4):
                    pos = torch.arange(p, p + 4, dtype=torch.int32,
                                       device=dev)[None].repeat(2, 1)
                    lc, chunked = ed.forward_prefill_chunk(
                        cfg, params, chunked, toks[:, p:p + 4], pos, policy,
                        kv_len=torch.full((2,), p + 4, dtype=torch.int32,
                                          device=dev))
                logits.append(lc[:, -1])
            runs[dev] = (torch.stack(logits).cpu(), torch.stack(fed).cpu())
        gap = float((runs[DEV][0] - runs["cpu"][0]).abs().max())
        readings[precision] = dict(logit_gap=gap,
                                   tokens=runs[DEV][1].t().tolist())
        check(torch.equal(runs[DEV][1], runs["cpu"][1]), f"small enc-dec"
              f" {precision}: card tokens {runs[DEV][1].tolist()} != cpu"
              f" {runs['cpu'][1].tolist()}")
        check(gap <= ENCDEC_SMALL_LOGIT_ATOL[precision],
              f"small enc-dec {precision} logits: {gap}")
    print("  small float32 enc-dec (D 64), card against cpu: "
          + json.dumps(readings))
    return readings


def encdec_phase(port):
    """Phase 14: seamless-m4t-large-v2 served in one shot and in chunks,
    float and int8, then trained, at full width and ``SEAMLESS_LAYERS``;
    then the small
    float32 oracle.  Returns the readings by part."""
    t0 = time.perf_counter()
    cfg = encdec_config(port)
    serve = serve_encdec(port, cfg)
    t1 = time.perf_counter()
    train = train_encdec(port, cfg)
    t2 = time.perf_counter()
    small = small_encdec_vs_cpu(port)
    print(f"  small oracle part {time.perf_counter() - t2:.1f} s")
    m = serve["metrics"]
    print(f"  enc-dec decode tokens_per_s float {m['oneshot_float']['tokens_per_s']:.2f}"
          f" (chunked {m['chunked_float']['tokens_per_s']:.2f}), int8"
          f" {m['oneshot_int8']['tokens_per_s']:.2f}; encoder pass"
          f" {m['oneshot_float']['encoder_ms']:.3f} ms float,"
          f" {m['oneshot_int8']['encoder_ms']:.3f} ms int8; decode step"
          f" idle share {serve['profile']['idle_share']:.3f},"
          f" {serve['profile']['kernels_per_step']:g} kernels; training"
          f" step {train[1]['step_ms']:.1f} ms, peak"
          f" {train[1]['peak_memory_bytes'] / 2**30:.2f} GiB; serving part"
          f" {t1 - t0:.1f} s, training part {t2 - t1:.1f} s, phase"
          f" {time.perf_counter() - t0:.1f} s")
    return dict(serve=serve, train=train, small=small)


# ---------------------------------------------------------------------------
# Phase 15: slice 9 part 3 (the VLM, qwen2-vl-72b)
# ---------------------------------------------------------------------------
QWEN = "qwen2-vl-72b"
# (layers, d_model, heads, KV heads, head dim, d_ff, padded vocab, M-RoPE
# sections) of the full config
QWEN_WIDTHS = (80, 8192, 64, 8, 128, 29568, 153600, (16, 24, 24))
# Depth cut for the card's memory and the script's time: 8 of 80 layers
# (877,674,496 parameters a layer, 1.755 GB in bf16, and the embedding and
# the unembedding 1,258,291,200 each): 19.1 GB of bf16 weights; the int8
# tree is made from them and the float tree freed.  Training: 1 layer and
# the two tables (3.39 B parameters at 16 bytes each: f32 masters, their
# gradients and AdamW's two moments, 54 GB) at B 1 x S 2,048, S not cut.
QWEN_LAYERS, QWEN_PARAMS = 8, 9_537_986_560
QWEN_TRAIN_LAYERS, QWEN_TRAIN_PARAMS = 1, 3_394_265_088
# Two rows of 1,200: 64 text tokens, an image of 1 x 32 x 32 patches on
# one temporal position (its h/w grid on the other two streams), 112 text
# tokens from one past its largest id; and 48 pads at -1 (left), 32 text
# tokens, an image of 1 x 24 x 40, 160 text tokens.  The stub frontend's
# embeddings (a normal times 0.1) stand for the text and patch embeddings.
QWEN_SEGMENTS = ([("text", 64), ("image", (1, 32, 32)), ("text", 112)],
                 [("text", 32), ("image", (1, 24, 40)), ("text", 160)])
QWEN_PADS, QWEN_NEW = (0, 48), 32
# the text prompts of the one-shot against chunked check: B 2 x 512, in
# chunks of 64 (chunked prefill takes one-stream positions: text only)
QWEN_TEXT, QWEN_CHUNK = 512, 64
QWEN_TRAIN_SEGMENTS = [("text", 64), ("image", (1, 32, 32)), ("text", 960)]
QWEN_TRAIN_STEPS = 3
# Logits of the image path (one-shot prefill and 32 decode steps, the
# decode teacher-forced with the float run's tokens) against the same path
# through the plain kernels; the text one-shot against the chunked path.
# By the rule of LOGIT_ATOL, twice the largest reading on the H100 rounded
# up to a power of two (float 0.3572, int8 1.5195, one-shot against
# chunked 0.4219); greedy tokens equal on 97.0% (float), 68.2% (int8)
# and 89.4% (one-shot against chunked) of the rows there, so at least
# 90%, 50% and 85% are required (PERF.md gives the readings).
QWEN_LOGIT_ATOL = {"float": 1.0, "int8": 4.0}
QWEN_GREEDY_EQUAL_MIN = {"float": 0.9, "int8": 0.5}
QWEN_CHUNKED_LIMITS = dict(logit=1.0, greedy=0.85)
# The small float32 config (D 64) on the card against the CPU: greedy
# tokens equal, logits within twice the largest reading on the H100
# rounded up to a power of two (float 6.26e-7, int8 2.38e-7)
QWEN_SMALL_LOGIT_ATOL = {"float": 2.0 ** -19, "int8": 2.0 ** -21}
QWEN_SMALL_SEGMENTS = ([("text", 5), ("image", (1, 4, 6)), ("text", 11)],
                       [("text", 4), ("image", (1, 3, 5)), ("text", 18)])
QWEN_SMALL_PADS = (0, 3)


def free_card() -> None:
    """Return what the deleted trees held to the card: a weight tree's
    cached per-layer views refer back to it, so its memory waits for the
    cycle collector."""
    gc.collect()
    torch.cuda.empty_cache()


def qwen_config(port, layers=QWEN_LAYERS):
    cfg = port.configs.get(QWEN)
    got = (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
           cfg.resolved_head_dim, cfg.d_ff, cfg.padded_vocab(),
           tuple(cfg.mrope_sections))
    check(got == QWEN_WIDTHS and cfg.rope_variant == "mrope"
          and cfg.frontend == "vision", f"unexpected config {cfg}")
    return dataclasses.replace(cfg, n_layers=layers)


def mrope_rows(port, segments, pads, dev=None):
    """(B, S, 3) int32 on ``dev`` (the card unless named): each row's
    ``api.mrope_positions`` after its left pads (-1 in every stream)."""
    dev = DEV if dev is None else dev
    rows = []
    for seg, pad in zip(segments, pads):
        pos = port.api.mrope_positions(seg, dev)
        rows.append(torch.cat([torch.full((pad, 3), -1, dtype=torch.int32,
                                          device=dev), pos]))
    check(len({len(r) for r in rows}) == 1, "rows of one length")
    return torch.stack(rows)


def patch_embeddings(cfg, gen, b, s, dev=None):
    """The stub frontend's embeddings, as ``api.synthetic_inputs`` draws
    them: a standard normal cast to the activation dtype, times 0.1."""
    dev = DEV if dev is None else dev
    return torch.randn(b, s, cfg.d_model, generator=gen, device=dev) \
        .to(cfg.activation_dtype) * 0.1


def qwen_expected(cfg, steps, int8, prefill="oneshot") -> dict:
    """The launches of one image or text run: the one-shot prefill (one
    ``flash_attention`` a layer) or ``prefill`` chunks (one
    ``flash_chunk_prefill`` a layer each), then ``steps`` decode steps; 7
    ``int8_matmul`` a layer a call under int8."""
    n = cfg.n_layers
    want = dict(flash_decode=n * steps, flash_chunk_prefill=0,
                int8_matmul=0, mel_frontend=0, flash_attention=0,
                flash_attention_bwd=0, mamba_scan=0, mamba_scan_bwd=0)
    calls = steps + 1
    if prefill == "oneshot":
        want["flash_attention"] = n
    else:
        want["flash_chunk_prefill"] = n * prefill
        calls = steps + prefill
    if int8:
        want["int8_matmul"] = 7 * n * calls
    return want


def qwen_decode(port, cfg, params, cache, first, start, s, policy, forced,
                steps, logits):
    """``steps`` greedy (or ``forced``) decode steps from the prompt's
    last logits ``first``: row s + t of the cache, position ``start`` + t
    (one past each row's largest id).  Appends to ``logits``; returns the
    tokens fed and the loop's wall seconds."""
    tr = port.transformer
    b = first.shape[0]
    fed = [first.argmax(-1).to(torch.int32) if forced is None
           else forced[:, 0]]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for t in range(steps):
        row = torch.full((b,), s + t, dtype=torch.int32, device=first.device)
        lg, cache = tr.forward_decode(cfg, params, cache, fed[-1],
                                      (start + t).to(torch.int32), row,
                                      policy=policy, kv_len=row + 1)
        logits.append(lg)
        if t + 1 < steps:
            fed.append(lg.argmax(-1).to(torch.int32) if forced is None
                       else forced[:, t + 1])
    torch.cuda.synchronize()
    return torch.stack(fed, 1), time.perf_counter() - t0


def qwen_image_run(port, cfg, params, emb, pos, policy, forced=None,
                   steps=QWEN_NEW):
    """One-shot prefill of the embedding batch at its image positions,
    ``grow_cache`` by ``QWEN_NEW``, ``steps`` decode steps.  Returns
    (logits (1 + steps, B, V), tokens fed, prefill s, decode s)."""
    tr = port.transformer
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        last, cache = tr.forward_prefill(
            cfg, params, {"embeddings": emb, "positions": pos}, policy)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        check(torch.equal(cache["full_pos"], pos[..., 0]),
              "the prefill cache's positions are not the temporal stream")
        cache = tr.grow_cache(cfg, cache, QWEN_NEW)
        start = pos[..., 0].max(dim=1).values + 1
        logits = [last]
        fed, wall = qwen_decode(port, cfg, params, cache, last, start,
                                pos.shape[1], policy, forced, steps, logits)
    return torch.stack(logits), fed, prefill_s, wall


def qwen_text_run(port, cfg, params, toks, policy, path, forced):
    """The text prompts one-shot (``forward_prefill`` on tokens, the
    default positions: the index kernels) or in chunks of ``QWEN_CHUNK``
    (``forward_prefill_chunk`` into a slot cache), then ``QWEN_NEW``
    decode steps teacher-forced with ``forced``.  Returns the logits."""
    tr, kc = port.transformer, port.kvcache
    b, s = toks.shape
    with torch.no_grad():
        if path == "oneshot":
            last, cache = tr.forward_prefill(cfg, params, {"tokens": toks},
                                             policy)
            cache = tr.grow_cache(cfg, cache, QWEN_NEW)
        else:
            cache = kc.alloc_decode_cache(cfg, b, s + QWEN_NEW, DEV, policy)
            for p in range(0, s, QWEN_CHUNK):
                ps = torch.arange(p, p + QWEN_CHUNK, dtype=torch.int32,
                                  device=DEV)[None].repeat(b, 1)
                kvl = torch.full((b,), p + QWEN_CHUNK, dtype=torch.int32,
                                 device=DEV)
                lg, cache = tr.forward_prefill_chunk(
                    cfg, params, cache, toks[:, p:p + QWEN_CHUNK], ps,
                    policy, kv_len=kvl)
            last = lg[:, -1]
        start = torch.full((b,), s, dtype=torch.int32, device=DEV)
        logits = [last]
        fed, _ = qwen_decode(port, cfg, params, cache, last, start, s,
                             policy, forced, QWEN_NEW, logits)
    return torch.stack(logits), fed


def serve_qwen(port, cfg):
    """qwen2-vl-72b at full width and ``QWEN_LAYERS`` layers, bf16, seeded
    weights, float and then native int8: the image batch prefilled in one
    shot and decoded, held to its launch counts and, teacher-forced with
    the float run's tokens, against the same run through the plain kernels
    (``encdec_plain``: the position-masked attention's plain version too);
    the text prompts one-shot against chunked, each held to its counts.
    Returns the launches by run and the readings."""
    t0 = time.perf_counter()
    params = port.init_params(cfg, torch.Generator(device=DEV).manual_seed(0),
                              DEV)
    n = sum(p.numel() for p in params.parameters())
    check(n == QWEN_PARAMS, f"{n} parameters")
    gen = torch.Generator(device=DEV).manual_seed(14)
    pos = mrope_rows(port, QWEN_SEGMENTS, QWEN_PADS)
    b, s = pos.shape[:2]
    emb = patch_embeddings(cfg, gen, b, s)
    toks = torch.randint(0, cfg.vocab_size, (b, QWEN_TEXT), generator=gen,
                         device=DEV, dtype=torch.int32)
    print(f"  weights and inputs in {time.perf_counter() - t0:.1f} s: B {b}"
          f" x S {s}, temporal positions up to"
          f" {pos[..., 0].max(dim=1).values.tolist()}")
    qwen_image_run(port, cfg, params, emb, pos, None, steps=2)    # warm
    out = {"launches": {}, "metrics": {}}
    forced = None
    weights = params
    for precision in ("float", "int8"):
        t_prec = time.perf_counter()
        policy = None if precision == "float" else port.quantize.INT8
        if policy is not None:
            weights = port.quantize.quantize_model_params(params, policy)
            del params
            free_card()
        reset_counts(port)
        logits, fed, prefill_s, wall = qwen_image_run(
            port, cfg, weights, emb, pos, policy, forced)
        launches = read_counts(port)
        want = qwen_expected(cfg, QWEN_NEW, policy is not None)
        check(launches == want, f"qwen2-vl image {precision} launches"
              f" {launches} != {want}")
        if forced is None:
            forced = fed
        with patched(encdec_plain(port)):
            plain, _, _, _ = qwen_image_run(port, cfg, weights, emb, pos,
                                            policy, forced)
        reading = logit_reading(logits, plain)
        key = f"image_{precision}"
        out["launches"][key] = launches
        out["metrics"][key] = dict(vs_plain=reading, prefill_s=prefill_s,
                                   decode_wall_s=wall,
                                   tokens_per_s=b * QWEN_NEW / wall)
        print(f"  qwen2-vl {key}: " + json.dumps(out["metrics"][key]))
        check(reading["max_abs_gap"] <= QWEN_LOGIT_ATOL[precision],
              f"qwen2-vl {key} logits against the plain path:"
              f" {reading['max_abs_gap']}")
        check(reading["greedy_equal"] >= QWEN_GREEDY_EQUAL_MIN[precision]
              * reading["rows"], f"qwen2-vl {key} greedy tokens equal the"
              f" plain path's on only {reading['greedy_equal']} of"
              f" {reading['rows']}")
        del plain
        runs, text_forced = {}, None
        for path in ("oneshot", "chunked"):
            reset_counts(port)
            runs[path], fed = qwen_text_run(port, cfg, weights, toks, policy,
                                            path, text_forced)
            launches = read_counts(port)
            want = qwen_expected(cfg, QWEN_NEW, policy is not None,
                                 "oneshot" if path == "oneshot"
                                 else QWEN_TEXT // QWEN_CHUNK)
            check(launches == want, f"qwen2-vl text {path} {precision}"
                  f" launches {launches} != {want}")
            out["launches"][f"text_{path}_{precision}"] = launches
            text_forced = fed if text_forced is None else text_forced
        gap = logit_reading(runs["chunked"], runs["oneshot"])
        out["metrics"][f"text_oneshot_vs_chunked_{precision}"] = gap
        print(f"  qwen2-vl text one-shot against chunked, {precision}: "
              + json.dumps(gap))
        if precision == "float":
            check(gap["max_abs_gap"] <= QWEN_CHUNKED_LIMITS["logit"],
                  f"qwen2-vl one-shot against chunked: {gap['max_abs_gap']}")
            check(gap["greedy_equal"] >= QWEN_CHUNKED_LIMITS["greedy"]
                  * gap["rows"], f"qwen2-vl one-shot against chunked:"
                  f" greedy equal on only {gap['greedy_equal']} of"
                  f" {gap['rows']}")
        del runs
        print(f"  {precision} part {time.perf_counter() - t_prec:.1f} s")
    del weights
    free_card()
    return out


def train_qwen(port):
    """qwen2-vl-72b at full width and ``QWEN_TRAIN_LAYERS`` layer: f32
    masters from a seeded generator on the card, bf16 activations,
    ``make_train_step`` (remat "full", AdamW) for 3 steps of B 1 x S 2,048
    embedding batches at an image's positions: finite losses,
    ``flash_attention`` launched twice a layer a step (forward and
    recomputed forward, masked by position) and its backward once.  Step
    ms, tokens/s, MFU (6 x the weights the matmuls read x tokens, plus
    3 x the forward attention's operations on the visible pairs, over 989
    TFLOP/s) and peak memory."""
    cfg = qwen_config(port, QWEN_TRAIN_LAYERS)
    params = port.init_params(cfg, torch.Generator(device=DEV).manual_seed(0),
                              DEV, trainable=True)
    n = sum(p.numel() for p in params.parameters())
    check(n == QWEN_TRAIN_PARAMS, f"{n} trainable parameters")
    opt_state = port.optimizer.adamw_init(params)
    step = port.train_step.make_train_step(
        cfg, remat="full", opt=port.optimizer.AdamWConfig(lr=TRAIN_LR))
    pos = mrope_rows(port, [QWEN_TRAIN_SEGMENTS], [0])
    s = pos.shape[1]
    gen = torch.Generator(device=DEV).manual_seed(15)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(port)
    losses, times = [], []
    for _ in range(QWEN_TRAIN_STEPS):
        batch = {"embeddings": patch_embeddings(cfg, gen, 1, s),
                 "positions": pos,
                 "labels": torch.randint(0, cfg.vocab_size, (1, s),
                                         generator=gen, device=DEV,
                                         dtype=torch.int32)}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, _, m = step(params, opt_state, batch)
        losses.append(float(m["loss"]))
        times.append((time.perf_counter() - t0) * 1e3)
    launches = read_counts(port)
    peak = torch.cuda.max_memory_allocated()
    check(all(np.isfinite(losses)), f"training losses {losses}")
    layers = cfg.n_layers
    want = {name: 0 for name in launches}
    want.update(flash_attention=2 * layers * QWEN_TRAIN_STEPS,
                flash_attention_bwd=layers * QWEN_TRAIN_STEPS)
    check(launches == want, f"training launches {launches} != {want}")
    step_s = float(np.median(times[1:])) / 1e3
    pairs = int(port.ref.attention_mask(s, s, True, 0, pos[..., 0],
                                        pos[..., 0]).sum())
    # N: the matmuls' weights (blocks and unembedding): an embedding batch
    # reads no token table
    n_matmul = n - cfg.padded_vocab() * cfg.d_model
    attn_flops = 3 * 4 * cfg.resolved_head_dim * cfg.n_heads * layers * pairs
    model_flops = 6 * n_matmul * s + attn_flops
    metrics = dict(params=n, layers=layers, batch=1, seq=s, losses=losses,
                   step_ms_all=times, step_ms=step_s * 1e3,
                   tokens_per_s=s / step_s, visible_pairs=pairs,
                   mfu=model_flops / step_s / PEAK_OPS[torch.bfloat16],
                   model_flops_per_step=model_flops, peak_memory_bytes=peak)
    print("  training " + json.dumps(metrics))
    del params, opt_state
    torch.cuda.empty_cache()
    return launches, metrics


def small_qwen_config(port):
    """The smoke config in float32 at d_model 256: 4/2 heads of 64 (the
    kernels' least head dim; the smoke config's 16 runs only the plain
    versions), M-RoPE sections (8, 12, 12)."""
    return dataclasses.replace(port.configs.get_smoke(QWEN), d_model=256,
                               n_heads=4, n_kv_heads=2, head_dim=64,
                               mrope_sections=(8, 12, 12), dtype="float32")


def small_qwen_vs_cpu(port) -> dict:
    """The exact oracle: the small float32 config on the card gives the
    CPU plain path's greedy tokens on an embedding batch at image
    positions (one row left-padded), one-shot prefill, ``grow_cache`` and
    8 decode steps, in float and native int8, logits within
    ``QWEN_SMALL_LOGIT_ATOL``."""
    cfg = small_qwen_config(port)
    check(cfg.resolved_head_dim == 64, f"head dim {cfg.resolved_head_dim}")
    host = port.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    pos_cpu = mrope_rows(port, QWEN_SMALL_SEGMENTS, QWEN_SMALL_PADS, "cpu")
    b, s = pos_cpu.shape[:2]
    emb_cpu = patch_embeddings(cfg, torch.Generator().manual_seed(1), b, s,
                               "cpu")
    tr = port.transformer
    readings = {}
    for precision in ("float", "int8"):
        policy = None if precision == "float" else port.quantize.INT8
        weights = host if policy is None else \
            port.quantize.quantize_model_params(host, policy)
        runs = {}
        for dev in ("cpu", DEV):
            params = weights if dev == "cpu" else \
                copy.deepcopy(weights).to(dev)
            emb, pos = emb_cpu.to(dev), pos_cpu.to(dev)
            with torch.no_grad():
                lg, cache = tr.forward_prefill(
                    cfg, params, {"embeddings": emb, "positions": pos},
                    policy)
                cache = tr.grow_cache(cfg, cache, 8)
                start = pos[..., 0].max(dim=1).values + 1
                logits, fed = [lg], [lg.argmax(-1).to(torch.int32)]
                for t in range(8):
                    row = torch.full((b,), s + t, dtype=torch.int32,
                                     device=dev)
                    lg, cache = tr.forward_decode(
                        cfg, params, cache, fed[-1],
                        (start + t).to(torch.int32), row, policy=policy,
                        kv_len=row + 1)
                    logits.append(lg)
                    fed.append(lg.argmax(-1).to(torch.int32))
            runs[dev] = (torch.stack(logits).cpu(), torch.stack(fed).cpu())
        gap = float((runs[DEV][0] - runs["cpu"][0]).abs().max())
        readings[precision] = dict(logit_gap=gap,
                                   tokens=runs[DEV][1].t().tolist())
        check(torch.equal(runs[DEV][1], runs["cpu"][1]), f"small qwen2-vl"
              f" {precision}: card tokens {runs[DEV][1].tolist()} != cpu"
              f" {runs['cpu'][1].tolist()}")
        check(gap <= QWEN_SMALL_LOGIT_ATOL[precision],
              f"small qwen2-vl {precision} logits: {gap}")
    print("  small float32 qwen2-vl (D 64, image positions), card against"
          " cpu: " + json.dumps(readings))
    return readings


def qwen_phase(port):
    """Phase 15: qwen2-vl-72b at full width, its image batch prefilled in
    one shot and decoded, its text prompts one-shot against chunked,
    float and int8; trained at one layer; then the small float32 oracle.
    Returns the readings by part."""
    t0 = time.perf_counter()
    serve = serve_qwen(port, qwen_config(port))
    t1 = time.perf_counter()
    train = train_qwen(port)
    t2 = time.perf_counter()
    small = small_qwen_vs_cpu(port)
    m = serve["metrics"]
    # a float decode step reads the blocks and the unembedding once; of
    # the token table it gathers B rows only
    step_bytes = 2 * (QWEN_PARAMS - QWEN_WIDTHS[6] * QWEN_WIDTHS[1])
    m["decode_weights_floor_ms"] = step_bytes / HBM_BYTES_PER_S * 1e3
    print(f"  qwen2-vl float decode step reads {step_bytes} bytes of"
          f" weights: {m['decode_weights_floor_ms']:.3f} ms at"
          f" {HBM_BYTES_PER_S:.3g} B/s")
    print(f"  qwen2-vl prefill (B 2 x 1,200, {QWEN_LAYERS} layers) float"
          f" {m['image_float']['prefill_s'] * 1e3:.1f} ms, int8"
          f" {m['image_int8']['prefill_s'] * 1e3:.1f} ms; decode tokens_per_s"
          f" float {m['image_float']['tokens_per_s']:.2f}, int8"
          f" {m['image_int8']['tokens_per_s']:.2f}; training step"
          f" {train[1]['step_ms']:.1f} ms, mfu {train[1]['mfu']:.4f}, peak"
          f" {train[1]['peak_memory_bytes'] / 2**30:.2f} GiB; serving part"
          f" {t1 - t0:.1f} s, training part {t2 - t1:.1f} s, small oracle"
          f" {time.perf_counter() - t2:.1f} s, phase"
          f" {time.perf_counter() - t0:.1f} s")
    return dict(serve=serve, train=train, small=small)


# ---------------------------------------------------------------------------
# Phase 16: training breadth at full width
# ---------------------------------------------------------------------------
# arch: (layers trained, the two-layer config's changes).  falcon-mamba-7b
# at 24 of 64 layers (all 64 would hold 7.28 B x 16 bytes of masters,
# gradients and AdamW state, 116 GB); zamba2-2.7b at all 54 (9 groups of
# 6); gemma3-4b at 18 of 34 (three groups of five local and one global
# layer: its tied 262,144 x 2,560 table and 2 GiB of f32 logits a row).
# The two-layer configs keep each kind of layer: zamba2 one group of two
# mamba2 layers closed by the shared block, gemma3 one local and one
# global layer.
BREADTH = {"falcon-mamba-7b": (24, {}),
           "zamba2-2.7b": (54, {"attn_every": 2}),
           "gemma3-4b": (18, {"local_global_ratio": 1})}
BREADTH_STEPS, BREADTH_SEQ = 3, 2048
# A two-layer run's gradients through the kernels against the same run
# through the plain versions (autograd of the plain attention and scan) on
# the card, bf16 activations from the same f32 masters: each weight's
# |kernel - plain| norm over the plain gradient's norm, the worst weight;
# the loss absolute.  Twice the largest reading on the H100 (9.97e-3,
# falcon-mamba; 8.70e-4, gemma3), rounded up to a power of two (PERF.md
# gives the readings).
BREADTH_GRAD_RTOL = 2.0 ** -5
BREADTH_LOSS_ATOL = 2.0 ** -9


def breadth_config(port, arch, layers, **changes):
    cfg = port.configs.get(arch)
    return dataclasses.replace(cfg, n_layers=layers, **changes)


def breadth_batch(port, cfg, seed):
    tokens = port.synthetic.token_stream(20_000, cfg.vocab_size, seed=1)
    return {k: torch.from_numpy(v).to(DEV) for k, v in next(
        port.synthetic.lm_batches(tokens, 1, BREADTH_SEQ, seed=seed)).items()}


def plain_training_paths(port) -> list:
    """The training path's kernels replaced by their plain versions, which
    autograd differentiates: the attention and the scan."""
    ref = port.ref

    def attention(q, k, v, *, causal=True, window=0, q_pos=None,
                  k_pos=None):
        return ref.flash_attention_ref(q, k, v, causal, window, q_pos, k_pos)
    return [mock.patch.object(port.layers, "flash_attention", attention),
            mock.patch.object(port.ops, "mamba_scan", ref.mamba_scan_ref)]


def breadth_grads_vs_plain(port, arch, changes) -> dict:
    """``forward_train``'s loss and every gradient of a two-layer run at
    full width through the kernels against the same run through their
    plain versions: readings against ``BREADTH_GRAD_RTOL`` and
    ``BREADTH_LOSS_ATOL``."""
    cfg = breadth_config(port, arch, 2, **changes)
    params = port.init_params(cfg, torch.Generator(device=DEV).manual_seed(1),
                              DEV, trainable=True)
    batch = breadth_batch(port, cfg, seed=5)
    plist = port.tree.leaves(params.tree())
    runs = []
    for patches in ([], plain_training_paths(port)):
        with patched(patches):
            loss, _ = port.transformer.forward_train(cfg, params, batch)
            grads = torch.autograd.grad(loss, plist, allow_unused=True,
                                        materialize_grads=True)
        runs.append((float(loss.detach()), [g.float() for g in grads]))
        del loss, grads
    (loss_k, g_k), (loss_p, g_p) = runs
    rel = [float((a - b).norm() / b.norm().clamp(min=1e-30))
           for a, b in zip(g_k, g_p)]
    read = dict(loss_gap=abs(loss_k - loss_p), grad_rel=max(rel),
                weights=len(rel), loss=loss_k)
    print(f"  {arch} two layers, kernels against the plain path:"
          f" {json.dumps(read)} (limits grad {BREADTH_GRAD_RTOL},"
          f" loss {BREADTH_LOSS_ATOL})")
    check(all(np.isfinite([loss_k, loss_p])) and all(np.isfinite(rel)),
          f"{arch}: non-finite two-layer run {read}")
    check(read["grad_rel"] <= BREADTH_GRAD_RTOL
          and read["loss_gap"] <= BREADTH_LOSS_ATOL,
          f"{arch}: two-layer gradients disagree with the plain path: {read}")
    del params, runs, g_k, g_p
    torch.cuda.empty_cache()
    return read


def breadth_train(port, arch, layers) -> tuple:
    """``arch`` at full width and ``layers`` deep: f32 masters from a
    seeded generator on the card, bf16 activations, ``make_train_step``
    (remat "full", AdamW) for ``BREADTH_STEPS`` steps of B 1 x
    ``BREADTH_SEQ`` from the token stream: finite losses, step ms,
    tokens/s, peak memory and the launches of the step's kernels (counts
    set to 0 just before the steps and read just after)."""
    cfg = breadth_config(port, arch, layers)
    t0 = time.perf_counter()
    params = port.init_params(cfg, torch.Generator(device=DEV).manual_seed(0),
                              DEV, trainable=True)
    opt_state = port.optimizer.adamw_init(params)
    n = sum(p.numel() for p in params.parameters())
    step = port.train_step.make_train_step(
        cfg, remat="full", opt=port.optimizer.AdamWConfig(lr=TRAIN_LR))
    tokens = port.synthetic.token_stream(50_000, cfg.vocab_size, seed=1)
    batches = port.synthetic.lm_batches(tokens, 1, BREADTH_SEQ, seed=0)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    reset_counts(port)
    losses, times = [], []
    for _ in range(BREADTH_STEPS):
        batch = next(batches)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, _, m = step(params, opt_state, batch)
        losses.append(float(m["loss"]))
        times.append((time.perf_counter() - t0) * 1e3)
    launches = read_counts(port)
    peak = torch.cuda.max_memory_allocated()
    check(all(np.isfinite(losses)), f"{arch} training losses {losses}")
    step_ms = float(np.median(times[1:]))
    metrics = dict(params=n, layers=layers, batch=1, seq=BREADTH_SEQ,
                   losses=losses, step_ms_all=times, step_ms=step_ms,
                   tokens_per_s=BREADTH_SEQ / step_ms * 1e3,
                   peak_memory_bytes=peak, setup_s=setup_s,
                   launches={k: v for k, v in launches.items() if v})
    print(f"  {arch} at {layers} layers: " + json.dumps(metrics))
    if cfg.family == "ssm":
        metrics["profile"] = breadth_profile(step, params, opt_state,
                                             next(batches))
    del params, opt_state, step
    torch.cuda.empty_cache()
    return cfg, launches, metrics


def breadth_profile(step, params, opt_state, batch) -> dict:
    """One more training step under ``torch.profiler`` (after the launch
    counts are read): device busy ms and each kernel family's ms, the
    scan's backward's share of the busy time."""
    def one(i):
        float(step(params, opt_state, batch)[2]["loss"])
    wall_ms, kernels, _ = trace_calls(one, 1)
    fam = dict.fromkeys(KERNEL_FAMILIES, 0.0)
    for e in kernels:
        fam[kernel_family(e["name"])] += e["dur"] / 1e3
    busy = _merged_us([(e["ts"], e["dur"]) for e in kernels]) / 1e3
    check(busy > 0 and fam["mamba_scan_bwd"] > 0, f"the profile of a"
          f" training step saw {len(kernels)} kernels, none of the scan's"
          f" backward")
    prof = dict(host_wall_ms=wall_ms, device_busy_ms=busy,
                idle_share=1 - busy / wall_ms, kernels_per_step=len(kernels),
                scan_bwd_share=fam["mamba_scan_bwd"] / busy,
                **{f"{k}_ms": v for k, v in fam.items()})
    print("  profile of a step: " + json.dumps(prof))
    return prof


def breadth_phase(port) -> dict:
    """Phase 16: each config of ``BREADTH`` trained at full width, its
    kernels' launches checked (falcon-mamba: the scan forward twice a
    layer a step, remat's recompute included, and its backward once;
    zamba2 and gemma3: ``flash_attention`` twice an attention layer a step
    and its backward once, at D 80 and D 256), and a two-layer run's
    gradients against the plain path.  Returns {arch: {launches, metrics,
    grads}}."""
    t_phase = time.perf_counter()
    out = {}
    for arch, (layers, changes) in BREADTH.items():
        t0 = time.perf_counter()
        cfg, launches, metrics = breadth_train(port, arch, layers)
        want = {name: 0 for name in launches}
        if cfg.family == "ssm":
            want.update(mamba_scan=2 * layers * BREADTH_STEPS,
                        mamba_scan_bwd=layers * BREADTH_STEPS)
        else:
            n_attn = (layers // cfg.attn_every if cfg.family == "hybrid"
                      else layers)
            want.update(flash_attention=2 * n_attn * BREADTH_STEPS,
                        flash_attention_bwd=n_attn * BREADTH_STEPS)
        check(launches == want, f"{arch} training launches {launches} !="
              f" {want}")
        grads = breadth_grads_vs_plain(port, arch, changes)
        print(f"  {arch} part {time.perf_counter() - t0:.1f} s")
        out[arch] = dict(launches=launches, metrics=metrics, grads=grads)
    print(f"  phase {time.perf_counter() - t_phase:.1f} s")
    return out


# ---------------------------------------------------------------------------
# Phase 17: the dry run against the card
# ---------------------------------------------------------------------------
# the one-card matrix: 10 archs x 4 shapes, long_500k only sub-quadratic
DRYRUN_MATRIX = {"ok": 33, "skipped": 7, "error": 0}
# (name, arch, layers (None: all), seq_len, global_batch, kind): the cut
# cells the card runs
DRYRUN_CELLS = (("train_4k_b2", "internlm2-1.8b", None, 4096, 2, "train"),
                ("prefill_32k_b1", "internlm2-1.8b", None, 32768, 1,
                 "prefill"),
                ("decode_32k_b8", "internlm2-1.8b", None, 32768, 8,
                 "decode"),
                ("mamba_prefill_32k_b1", "falcon-mamba-7b", None, 32768, 1,
                 "prefill"))
# falcon-mamba's one-shot prefill of 32,768 tokens at all 64 layers makes
# 38 GiB of temporaries beside 29 GiB of f32 weights; the default
# caching allocator then holds 22.7 GiB reserved but unusable and runs the
# card out of memory, even in a fresh process.  So that cell runs in a
# process of its own whose allocator maps its blocks into segments that
# grow (PYTORCH_CUDA_ALLOC_CONF, a setting of that process alone)
DRYRUN_APART = "mamba_prefill_32k_b1"
DRYRUN_APART_ALLOC = "expandable_segments:True"
DRYRUN_CELL_TIMEOUT_S = 300
DRYRUN_REPS = {"train": 2, "prefill": 2, "decode": 5}
# |max_memory_allocated - what earlier phases held - predicted| /
# predicted: twice the largest reading (+8.49e-4, the train cell: cuBLAS'
# workspace made in the step; prefill 0, decode 960 bytes, falcon-mamba
# +4.78e-4 at 64 layers in its own process, whose step makes the 32 MiB
# workspace; PERF.md) rounded up to a power of two
DRYRUN_MEM_RTOL = 2.0 ** -9
DRYRUN_TUNER_SAMPLES = 6
# the matrix's processes, one a group of shapes: long_500k (zamba2-2.7b's
# cell alone is 38 s of the matrix's 101 s on the H100's host), train_4k
# (40 s) and the serving shapes (21 s); PERF.md gives the trace seconds
DRYRUN_MATRIX_GROUPS = (("long_500k",), ("train_4k",),
                        ("decode_32k", "prefill_32k"))
DRYRUN_MATRIX_TIMEOUT_S = 300


def start_dryrun_matrix(port, out: Path) -> list:
    """The dry-run matrix, every arch of ``ALIASES`` x ``SHAPES`` traced on
    the ``meta`` device by ``repro_torch.launch.dryrun``, in one process a
    group of ``DRYRUN_MATRIX_GROUPS``, none of which sees the card.  Each
    writes one JSON a cell under ``out`` and its lines to
    ``out/matrix-<i>.log``.  Started before the build, they trace while
    ``nvcc`` compiles, and ``finish_dryrun_matrix`` waits for them before
    phase 2: no timed phase has them beside it."""
    src = Path(__file__).resolve().parent / "src"
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1",
               PYTHONPATH=str(src))
    code = ("import sys\n"
            "from repro_torch.launch import dryrun\n"
            "for shape in sys.argv[2:]:\n"
            "    dryrun.main(['--shape', shape, '--out', sys.argv[1]])\n")
    shapes = [s for group in DRYRUN_MATRIX_GROUPS for s in group]
    check(sorted(shapes) == sorted(port.dryrun.SHAPES), f"the matrix's"
          f" groups {DRYRUN_MATRIX_GROUPS} are not the shapes"
          f" {list(port.dryrun.SHAPES)}")
    procs = []
    for i, group in enumerate(DRYRUN_MATRIX_GROUPS):
        with open(out / f"matrix-{i}.log", "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, "-c", code, str(out), *group], env=env,
                stdout=log, stderr=subprocess.STDOUT))
    atexit.register(lambda: [p.kill() for p in procs if p.poll() is None])
    return procs


def finish_dryrun_matrix(procs: list, out: Path) -> float:
    """Wait for the matrix's processes; each must exit 0.  Returns the
    seconds waited."""
    t0 = time.perf_counter()
    for i, proc in enumerate(procs):
        left = DRYRUN_MATRIX_TIMEOUT_S - (time.perf_counter() - t0)
        try:
            rc = proc.wait(timeout=max(left, 1.0))
        except subprocess.TimeoutExpired:
            for p in procs:
                p.kill()
            fail(f"the dry-run matrix took more than"
                 f" {DRYRUN_MATRIX_TIMEOUT_S} s past the build")
        tail = (out / f"matrix-{i}.log").read_text()[-2000:]
        check(rc == 0, f"the dry-run matrix's process {i} exited {rc}:"
              f" {tail}")
    return time.perf_counter() - t0


def dryrun_matrix(out: Path, waited: float) -> dict:
    """The matrix's cells, traced before phase 2 (``waited`` the seconds
    that phase 1 waited for them): a line a cell, its statuses
    checked."""
    status, rows = {}, []
    for path in sorted(out.glob("*_single.json")):
        row = json.loads(path.read_text())
        status[row["status"]] = status.get(row["status"], 0) + 1
        if row["status"] == "ok":
            r = row["roofline"]
            print(f"  {row['arch']:22s} {row['shape']:12s} ok  fits_hbm"
                  f" {r['fits_hbm']!s:5s} {r['bottleneck']:7s} roofline"
                  f" {r['roofline_fraction']:.4f}  HBM"
                  f" {row['memory']['per_device_hbm_gib']:9.3f} GiB  trace"
                  f" {row['t_trace_s']:.2f} s")
            rows.append({k: row[k] for k in ("arch", "shape", "t_trace_s")}
                        | {k: r[k] for k in ("fits_hbm", "bottleneck",
                                             "roofline_fraction",
                                             "hbm_gib")})
        else:
            print(f"  {row['arch']:22s} {row['shape']:12s}"
                  f" {row['status']}: {row.get('why', row.get('error'))}")
    status = {k: status.get(k, 0) for k in DRYRUN_MATRIX}
    check(status == DRYRUN_MATRIX, f"dry-run matrix {status} !="
          f" {DRYRUN_MATRIX}")
    print(f"  matrix {status}; traced during the build, which then waited"
          f" {waited:.1f} s for it")
    return {"status": status, "rows": rows, "waited_s": waited}


def full_cache(port, cfg, shape, gen):
    """The decode cell's cache on the card: the abstract prefill cache's
    leaves, K/V random (0.5 x N(0, 1)) and every position valid."""
    def fill(path, t):
        if "pos" in path:
            return torch.arange(t.shape[-1], dtype=t.dtype, device=DEV
                                ).expand(t.shape).contiguous()
        # drawn in the leaf's dtype, scaled in place: a float32 draw of
        # a 12 GiB bf16 leaf would take 24 GiB more
        return torch.randn(t.shape, generator=gen, device=DEV,
                           dtype=t.dtype).mul_(0.5)

    def walk(tree, path):
        if isinstance(tree, dict):
            return {k: walk(v, path + "/" + k) for k, v in tree.items()}
        if isinstance(tree, tuple):
            return type(tree)(*(walk(v, path + f"/{i}")
                                for i, v in enumerate(tree)))
        return fill(path, tree)
    return walk(port.api.abstract_cache(cfg, shape), "")


def dryrun_cell(port, arch, layers, seq, batch, kind) -> tuple:
    """One cut cell: the meta trace's prediction, then the same step on
    the card under the same counter (memory, FLOPs, launches), then
    ``DRYRUN_REPS`` uncounted runs for its time.  Returns (launches,
    row, the card's weights)."""
    cfg = port.configs.get(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    shape = port.core_arch.ShapeConfig(kind, seq, batch, kind)
    meta = port.collect.StepCounter()
    t0 = time.perf_counter()
    args, outs = port.dryrun.trace_step(cfg, shape, meta)
    t_trace = time.perf_counter() - t0
    pred = port.dryrun.step_memory(args, outs, meta.peak_bytes)
    del args, outs
    rep = port.roofline.RooflineReport(
        arch=arch, shape=kind, mesh="1x1", n_chips=1,
        hlo_flops=meta.costs.flops, hlo_bytes=meta.costs.bytes_accessed,
        hlo_bytes_min=meta.costs.bytes_min, collective_bytes=0.0,
        collective_detail={}, per_device_hbm=pred["per_device_hbm_bytes"],
        model_flops=port.roofline.model_flops(cfg, shape)).finalize()
    free_card()
    # what earlier phases still hold (cuBLAS' workspace, cached views): not
    # this step's, so taken off the card's peak
    other = torch.cuda.memory_allocated()
    gen = torch.Generator(device=DEV).manual_seed(17)
    params = port.init_params(cfg, gen, DEV, dtype=torch.float32,
                              trainable=kind == "train")
    if kind == "decode":
        inputs = {"cache": full_cache(port, cfg, shape, gen),
                  "token": torch.zeros(batch, dtype=torch.int32, device=DEV),
                  "position": torch.full((batch,), seq - 1,
                                         dtype=torch.int32, device=DEV)}
    else:
        inputs = port.api.synthetic_inputs(cfg, batch, seq, gen,
                                           train=kind == "train", device=DEV)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(port)
    card = port.collect.StepCounter()
    port.dryrun.trace_step(cfg, shape, card, params=params, inputs=inputs)
    torch.cuda.synchronize()
    launches = read_counts(port)
    peak = torch.cuda.max_memory_allocated()
    check(card.costs.flops == meta.costs.flops,
          f"{arch} {kind}: the card run counted {card.costs.flops} FLOPs,"
          f" the meta trace {meta.costs.flops}")
    check({k: v for k, v in launches.items() if v}
          == {k: v for k, v in card.launches.items()},
          f"{arch} {kind}: launches {launches} != the counter's calls"
          f" {dict(card.launches)}")
    times = []
    for _ in range(DRYRUN_REPS[kind]):
        t0 = time.perf_counter()
        port.dryrun.trace_step(cfg, shape, None, params=params,
                               inputs=inputs)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    ms = float(np.median(times))
    t_roof = max(rep.t_compute, rep.t_memory_min, rep.t_collective) * 1e3
    gap = (peak - other - pred["per_device_hbm_bytes"]) \
        / pred["per_device_hbm_bytes"]
    row = {"predicted_hbm_bytes": pred["per_device_hbm_bytes"],
           "argument_bytes": pred["argument_bytes"],
           "other_allocated_bytes": other, "allocated_before_bytes": base,
           "max_memory_allocated": peak,
           "memory_gap": gap, "counted_flops": card.costs.flops,
           "meta_flops": meta.costs.flops, "model_flops": rep.model_flops,
           "step_ms": ms, "step_ms_runs": times, "roofline_ms": t_roof,
           "bottleneck": rep.bottleneck,
           "roofline_fraction": rep.roofline_fraction,
           "measured_fraction_of_peak":
               rep.model_flops / (ms / 1e3) / port.hw.H100.peak_flops_bf16,
           "trace_s": t_trace, "launches": {k: v for k, v in
                                            launches.items() if v}}
    print(f"  {arch} ({cfg.n_layers} layers) {kind} B {batch} x {seq}:"
          f" FLOPs {card.costs.flops:.6e}"
          f" (meta {meta.costs.flops:.6e})  HBM predicted"
          f" {pred['per_device_hbm_bytes'] / 2**30:.3f} GiB, max allocated"
          f" {peak / 2**30:.3f} less {other / 2**30:.3f} held before (gap"
          f" {gap:+.5f}; allocated before the step {base / 2**30:.3f},"
          f" arguments {pred['argument_bytes'] / 2**30:.3f})  step"
          f" {ms:.2f} ms,"
          f" roofline {t_roof:.2f} ms ({rep.bottleneck}), measured"
          f" {row['measured_fraction_of_peak']:.4f} of peak  launches"
          f" {row['launches']}")
    check(abs(gap) <= DRYRUN_MEM_RTOL, f"{arch} {kind}: max allocated"
          f" {peak} less {other} against the predicted"
          f" {pred['per_device_hbm_bytes']}: gap {gap:+.5f}, limit"
          f" {DRYRUN_MEM_RTOL}")
    del inputs
    return launches, row, params


def dryrun_cell_apart(name: str) -> tuple:
    """One of ``DRYRUN_CELLS`` in a process of its own (this script with
    ``--dryrun-cell``) whose allocator takes ``DRYRUN_APART_ALLOC``: its
    lines printed, and its (launches, row)."""
    env = dict(os.environ, PYTORCH_CUDA_ALLOC_CONF=DRYRUN_APART_ALLOC)
    cmd = [sys.executable, str(Path(__file__).resolve()), "--dryrun-cell",
           name]
    try:
        run = subprocess.run(cmd, env=env, capture_output=True, text=True,
                             timeout=DRYRUN_CELL_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        fail(f"dry-run cell {name} took more than {DRYRUN_CELL_TIMEOUT_S}"
             f" s")
    lines = run.stdout.splitlines()
    for line in lines[:-1]:
        print(line)
    check(run.returncode == 0 and lines, f"dry-run cell {name} exited"
          f" {run.returncode}: {run.stderr[-3000:]}")
    got = json.loads(lines[-1])
    return got["launches"], got["row"]


def dryrun_cell_main(name: str) -> None:
    """``chip_smoke.py --dryrun-cell NAME``: that cell of ``DRYRUN_CELLS``
    alone, its (launches, row) as the last line."""
    port = load_port()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cells = {c[0]: c[1:] for c in DRYRUN_CELLS}
    check(name in cells, f"no dry-run cell {name}")
    launches, row, _ = dryrun_cell(port, *cells[name])
    row["allocator"] = os.environ.get("PYTORCH_CUDA_ALLOC_CONF", "")
    print(json.dumps({"launches": launches, "row": row}))


def elastic_cycle(port, cfg, params) -> dict:
    """Save the trained weights, rescale to the one-card mesh and restore
    them onto the card: bitwise equal."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        ck = port.Checkpointer(Path(d))
        ck.save(1, params)
        plan = port.elastic.plan_rescale({"data": 1, "model": 1}, 1)
        mesh = port.elastic.build_mesh(plan.new_shape)
        restored, _ = port.elastic.elastic_restore(
            ck, params, port.sharding.make_rules("tp"),
            port.params.logical_axes(cfg), mesh)
    want, got = port.tree.leaves(params.tree()), port.tree.leaves(restored)
    check(len(got) == len(want), "elastic_restore: another set of leaves")
    for i, (t, w) in enumerate(zip(got, want)):
        check(t.device.type == "cuda" and t.dtype == w.dtype
              and torch.equal(t, w), f"elastic_restore: leaf {i} differs")
    print(f"  elastic cycle: {plan.note}; {len(got)} leaves restored onto"
          f" {mesh.device} bitwise in {time.perf_counter() - t0:.1f} s")
    return {"plan": plan.new_shape, "leaves": len(got), "bitwise": True}


def dryrun_phase(port, out: Path, waited: float) -> dict:
    """Phase 17: the matrix, the four cut cells against the card, the
    pod tuner and the elastic cycle."""
    t_phase = time.perf_counter()
    total = torch.cuda.get_device_properties(0).total_memory
    check(port.hw.H100.hbm_bytes == total, f"H100.hbm_bytes"
          f" {port.hw.H100.hbm_bytes} != the card's total_memory {total}")
    matrix = dryrun_matrix(out, waited)
    cells, launches = {}, {}
    for name, arch, layers, seq, batch, kind in DRYRUN_CELLS:
        if name == DRYRUN_APART:
            launches[name], cells[name] = dryrun_cell_apart(name)
            continue
        launches[name], cells[name], params = dryrun_cell(
            port, arch, layers, seq, batch, kind)
        if kind == "train":
            elastic = elastic_cycle(port, port.configs.get(arch), params)
        del params
        free_card()
    t0 = time.perf_counter()
    ranked = port.tuner.PodConfigTuner(
        port.dryrun.run_cell, arch="internlm2-1.8b",
        shape="train_4k").search(n_samples=DRYRUN_TUNER_SAMPLES)
    rows = [{"strategy": c.strategy, "n_micro": c.report["n_micro"],
             "remat": c.remat,
             "roofline_fraction": c.report["roofline"]["roofline_fraction"],
             "bottleneck": c.report["roofline"]["bottleneck"],
             "hbm_gib": c.report["memory"]["per_device_hbm_gib"]}
            for c in ranked]
    for r in rows:
        print(f"  tuner {r}")
    check(rows and rows[0]["hbm_gib"] <= total / 2**30,
          f"the tuner's best row does not fit the card: {rows[:1]}")
    print(f"  tuner {len(rows)} of {DRYRUN_TUNER_SAMPLES} fit, part"
          f" {time.perf_counter() - t0:.1f} s; phase"
          f" {time.perf_counter() - t_phase:.1f} s")
    return {"matrix": matrix, "cells": cells, "tuner": rows,
            "elastic": elastic, "launches": launches}


def gpu_line(query: str = "name,power.limit") -> str:
    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def load_port():
    """The port's modules, imported from the checkout beside this file."""
    import_port()
    from repro_torch import configs
    from repro_torch.core import blocks as core_blocks
    from repro_torch.core import eon_compiler as eon
    from repro_torch.core import estimator, project, quantize, tree, tuner
    from repro_torch.core.impulse import Impulse
    from repro_torch.data import synthetic
    from repro_torch.dsp import blocks as dsp_blocks
    from repro_torch.kernels import build, ops, ref
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import int8_matmul as im
    from repro_torch.kernels import mamba_scan as ms
    from repro_torch.kernels import mel_frontend as mf
    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.core import arch as core_arch
    from repro_torch.launch import dryrun, elastic
    from repro_torch.launch import train as launch_train
    from repro_torch.roofline import collect, hw
    from repro_torch.roofline import model as roofline
    from repro_torch.sharding import policy as sharding
    from repro_torch.models import api, encdec, kws, layers, moe
    from repro_torch.models import params as model_params
    from repro_torch.models import transformer
    from repro_torch.models.params import init_params
    from repro_torch.serve import kvcache, serve_step, server
    from repro_torch.train import optimizer, train_step
    from repro_torch.train.trainer import Trainer, TrainerConfig
    return SimpleNamespace(configs=configs, quantize=quantize, build=build,
                           ops=ops, ref=ref, fd=fd, im=im, mf=mf, fa=fa,
                           ms=ms,
                           optimizer=optimizer, train_step=train_step,
                           launch_train=launch_train,
                           Trainer=Trainer, TrainerConfig=TrainerConfig,
                           layers=layers, init_params=init_params,
                           params=model_params,
                           api=api, transformer=transformer, moe=moe,
                           encdec=encdec,
                           kvcache=kvcache, serve_step=serve_step,
                           server=server, core_blocks=core_blocks, tree=tree,
                           Impulse=Impulse, synthetic=synthetic,
                           dsp_blocks=dsp_blocks, kws=kws,
                           estimator=estimator, eon=eon, tuner=tuner,
                           project=project, Checkpointer=Checkpointer,
                           core_arch=core_arch, dryrun=dryrun,
                           elastic=elastic, collect=collect, hw=hw,
                           roofline=roofline, sharding=sharding)


def main() -> None:
    if not torch.cuda.is_available():
        fail("no CUDA device: the port's smoke run needs one GPU")
    if sys.argv[1:2] == ["--dryrun-cell"]:
        dryrun_cell_main(sys.argv[2])
        return
    port = load_port()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on "
          f"{torch.cuda.get_device_name(0)}")

    phase("phase 1: build (one nvcc per source, all at once), the dry-run"
          " matrix traced meanwhile")
    t0 = time.perf_counter()
    dryrun_dir = tempfile.TemporaryDirectory()
    matrix_procs = start_dryrun_matrix(port, Path(dryrun_dir.name))
    logs = port.build.build_all()
    wide_spills, scan_bwd_spills = [], []
    for name, log in logs.items():
        print(f"  {name}:")
        entry = ""
        for line in log.splitlines():
            if "Compiling entry function" in line:
                entry = line.strip()
                print("   " + entry[:170])
            elif "registers" in line or "spill" in line:
                print("   " + line.strip())
                spill = re.search(r"(\d+) bytes spill stores", line)
                cap = FA_DKDV_SPILL_CAP if "dkdv" in entry else 0
                if ("Li256E" in entry or "Li80E" in entry) and spill \
                        and int(spill.group(1)) > cap:
                    wide_spills.append(f"{entry} ({spill.group(1)} bytes)")
                if "mamba_scan_bwd" in entry and spill \
                        and int(spill.group(1)) > 0:
                    scan_bwd_spills.append(f"{entry} ({spill.group(1)}"
                                           f" bytes)")
    # the D 256 and D 80 instantiations of the forward, serving and dQ
    # kernels were chosen so that none spills; their dK/dV passes spill a
    # little, as that pass does at every head dim (PERF.md gives the bytes)
    check(not wide_spills, f"a D 256 or D 80 kernel spills more than its"
          f" cap: {wide_spills}")
    # the scan backward keeps a sub-chunk's decays and states in registers:
    # none of its kernels may spill
    check(not scan_bwd_spills, f"a kernel of the scan backward spills:"
          f" {scan_bwd_spills}")
    port.fd._lib()
    port.im._lib()
    port.mf._lib()
    port.fa._lib()
    port.ms._lib()
    print(f"  build phase {time.perf_counter() - t0:.1f} s")
    matrix_waited = finish_dryrun_matrix(matrix_procs,
                                         Path(dryrun_dir.name))
    print(f"  dry-run matrix traced; waited {matrix_waited:.1f} s for it")

    t0 = time.perf_counter()
    clips, labels = keyword_clips(port, KWS_CLIPS, 12, 16_000, seed=0)
    print(f"  {KWS_CLIPS} keyword clips of 1 s made in"
          f" {time.perf_counter() - t0:.1f} s")

    phase("phase 2: kernels against their plain versions")
    layout_rows = check_layouts(port.ops, port.ref, port.quantize.Int8KV)
    stamp("phase 2: serving attention layouts checked")
    mm_rows = check_int8_matmul(port.ops, port.ref, port.im)
    stamp("phase 2: int8_matmul checked")
    mel_rows = check_mel_frontend(port, clips)
    stamp("phase 2: mel_frontend checked")
    fa_rows = check_flash_attention(port)
    stamp("phase 2: flash_attention checked")
    scan_rows = check_mamba_scan(port)
    stamp("phase 2: mamba_scan checked")
    print("  slices 7 and 8: D 256 (gemma3), G 3 and G 4 (llama3.2,"
          " granite), D 80 (zamba2)")
    for name, rows in check_slice_attention(port.ops, port.ref,
                                            port.quantize.Int8KV).items():
        layout_rows[name].update(rows)
    stamp("phase 2: slices 7 and 8 checked")
    print("  slices 8 and 10: flash_attention forward and backward at D 256"
          " (gemma3) and D 80 (zamba2)")
    for cases in (FA_D256_CASES, FA_D80_CASES):
        for name, rows in check_flash_attention_wide(port, cases).items():
            fa_rows[name].update(rows)
    stamp("phase 2: flash_attention at D 256 and D 80 checked")
    print("  slice 10: the mamba_scan backward (falcon-mamba's training)")
    scan_bwd_rows = check_mamba_scan_bwd(port)
    stamp("phase 2: the mamba_scan backward checked")
    print("  slice 9 part 2: keys of another length (seamless-m4t: D 64,"
          " 16/16 heads, causal=False)")
    for name, rows in check_flash_attention_cross(port).items():
        fa_rows[name].update(rows)
    stamp("phase 2: keys of another length checked")
    print("  slice 9 part 3: masks by position (qwen2-vl: 64/8 heads of"
          " 128, an image's positions, packed rows with pads)")
    for name, rows in check_flash_attention_positions(port).items():
        fa_rows[name].update(rows)

    phase(f"phase 3: full-width serving, internlm2-1.8b bf16 at"
          f" {SERVE_LAYERS} of its 24 layers")
    cfg = full_config(port)
    params, launches, metrics, run3 = serve_full(port, cfg)
    logits_vs_plain(port, cfg, params, LOGIT_ATOL, GREEDY_EQUAL_MIN,
                    attention_paths(port))
    serve_small_vs_cpu(port)
    phase("phase 4: where a step's time goes")
    profile_steps(port, cfg, params)
    print(f"  tokens_per_s {metrics['tokens_per_s']:.2f}  ttft_p50_s "
          f"{metrics['ttft_p50_s']:.4f}  ttft_p95_s {metrics['ttft_p95_s']:.4f}"
          f"  kv_cache_bytes {metrics['kv_cache_bytes']}")
    phase("phase 3 from the artifact")
    launches_a3, _, art3, asrv = artifact_serving(
        port, "float continuous", cfg, run3)
    art3["decode"] = decode_side_by_side(port, "float continuous", asrv, 257)
    del asrv

    phase(f"phase 5: full-width int8 paged serving, internlm2-1.8b bf16 at"
          f" {SERVE_LAYERS} of its 24 layers")
    srv, launches8, metrics8, run5 = serve_int8_paged(port, cfg, params)
    stamp("phase 5: int8 paged served")
    int8 = port.quantize.INT8
    logits_vs_plain(port, cfg, srv.params, INT8_LOGIT_ATOL,
                    INT8_GREEDY_EQUAL_MIN, attention_paths(port), int8, True)
    serve_small_int8_vs_cpu(port)
    profile_steps(port, cfg, srv.params, int8, True)
    print(f"  int8 paged tokens_per_s {metrics8['tokens_per_s']:.2f}"
          f"  ttft_p50_s {metrics8['ttft_p50_s']:.4f}  ttft_p95_s"
          f" {metrics8['ttft_p95_s']:.4f}  kv_cache_bytes"
          f" {metrics8['kv_cache_bytes']}  preemptions"
          f" {metrics8['preemptions']}  prefix_hit_blocks"
          f" {metrics8['prefix_hit_blocks']}")
    stamp("phase 5: int8 paged logits, oracle and profile checked")
    print("  int8 paged from the artifact")
    launches_a5, _, art5, asrv = artifact_serving(port, "int8 paged", cfg,
                                                  run5)
    art5["decode"] = decode_side_by_side(port, "int8 paged", asrv, 129)
    del asrv
    stamp("phase 5: int8 paged artifact run")
    print("  calibrated int8 activations, continuous")
    t0 = time.perf_counter()
    serve_small_calibrated_vs_cpu(port)
    cal_srv, launches_cal, metrics_cal, cal_agree, run5c = serve_calibrated(
        port, cfg, srv.params)
    logits_vs_plain(port, cfg, cal_srv.params, INT8_LOGIT_ATOL,
                    CAL_GREEDY_EQUAL_MIN, attention_paths(port),
                    cal_srv.prec)
    print(f"  calibrated int8 tokens_per_s {metrics_cal['tokens_per_s']:.2f}"
          f"  ttft_p50_s {metrics_cal['ttft_p50_s']:.4f}  ttft_p95_s"
          f" {metrics_cal['ttft_p95_s']:.4f}  greedy agreement with the"
          f" dynamic run {cal_agree:.4f}  part"
          f" {time.perf_counter() - t0:.1f} s")
    stamp("phase 5: calibrated int8 served and checked")
    print("  calibrated int8 from the artifact")
    launches_a5c, _, art5c, asrv = artifact_serving(
        port, "int8 calibrated", cfg, run5c)
    art5c["decode"] = decode_side_by_side(port, "int8 calibrated", asrv, 257)
    del asrv
    del cal_srv, run5c

    phase("phase 6: full-width KWS Impulse, DS-CNN on MFE, f32 and PTQ int8")
    t0 = time.perf_counter()
    launches_kws, kws_metrics, kws_prof, kws_imp = kws_impulse(port, clips)
    print(f"  clips_per_s {kws_metrics['clips_per_s']:.1f}  batch-1 p50"
          f" {kws_metrics['batch1_p50_ms']:.3f} ms (DSP"
          f" {kws_metrics['batch1_dsp_p50_ms']:.3f}, NN"
          f" {kws_metrics['batch1_nn_p50_ms']:.3f})  idle share batch 512"
          f" {kws_prof['batch512']['idle_share']:.3f}, batch 1"
          f" {kws_prof['batch1']['idle_share']:.3f}  phase"
          f" {time.perf_counter() - t0:.1f} s")
    print("  the KWS Impulse from the artifact")
    launches_a6, kws_art_metrics, kws_art_prof = kws_artifact(
        port, kws_imp, clips, kws_metrics, kws_prof)
    del kws_imp
    print("  Impulse.fit at full width, DS-CNN on MFE")
    t0 = time.perf_counter()
    launches_fit, fit_metrics, fit_prof = kws_fit(port, clips, labels)
    print(f"  fit step_ms {fit_metrics['step_ms']:.3f}  clips_per_s"
          f" {fit_metrics['clips_per_s']:.1f}  idle share"
          f" {fit_prof['idle_share']:.3f}  mel_frontend share of device"
          f" busy {fit_prof['mel_share']:.3f}  val_acc"
          f" {fit_metrics['val_acc']:.4f}  held-out int8"
          f" {fit_metrics['heldout_int8_acc']:.4f} (float"
          f" {fit_metrics['heldout_f32_acc']:.4f})  part"
          f" {time.perf_counter() - t0:.1f} s")

    phase(f"phase 7: full-width training, internlm2-1.8b at {TRAIN_LAYERS}"
          f" of its 24 layers, f32 masters, bf16")
    del params, srv, run3, run5
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    launches_train, train_metrics, train_prof = train_full(
        port, full_config(port, TRAIN_LAYERS))
    stamp("phase 7: trained, profiled, remat policies run")
    train_small_vs_cpu(port)
    print(f"  step_ms {train_metrics['step_ms']:.1f}  tokens_per_s"
          f" {train_metrics['tokens_per_s']:.1f}  mfu"
          f" {train_metrics['mfu']:.4f}  peak memory"
          f" {train_metrics['peak_memory_bytes'] / 2**30:.2f} GiB  attention"
          f" share {train_prof['attention_share']:.3f}  idle share"
          f" {train_prof['idle_share']:.3f}  phase"
          f" {time.perf_counter() - t0:.1f} s")

    phase(f"phase 8: full-width mamba1 serving, falcon-mamba-7b bf16 at"
          f" {MAMBA_LAYERS} of its 64 layers")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    mcfg = mamba_config(port)
    mparams, launches_ssm, metrics_ssm, run8 = serve_mamba_full(port, mcfg)
    logits_vs_plain(port, mcfg, mparams, MAMBA_LOGIT_ATOL,
                    MAMBA_GREEDY_EQUAL_MIN, scan_paths(port))
    serve_small_mamba_vs_cpu(port)
    ssm_prof = profile_steps(port, mcfg, mparams)
    shares = {name: p["mamba_scan_ms"] / p["device_busy_ms"]
              for name, p in ssm_prof.items()}
    print(f"  mamba_scan share of device busy: {json.dumps(shares)}")
    print(f"  tokens_per_s {metrics_ssm['tokens_per_s']:.2f}  ttft_p50_s"
          f" {metrics_ssm['ttft_p50_s']:.4f}  ttft_p95_s"
          f" {metrics_ssm['ttft_p95_s']:.4f}  state bytes"
          f" {metrics_ssm['kv_cache_bytes']}  phase"
          f" {time.perf_counter() - t0:.1f} s")
    phase("phase 8 from the artifact")
    launches_a8, _, art8, asrv = artifact_serving(port, "falcon-mamba", mcfg,
                                                  run8)
    art8["decode"] = decode_side_by_side(port, "falcon-mamba", asrv, 257)
    del asrv
    del mparams, run8
    torch.cuda.empty_cache()

    phase("phase 10: one-shot prefill at full width, and its exact oracle")
    t0 = time.perf_counter()
    prefill = prefill_phase(port)
    print(f"  phase {time.perf_counter() - t0:.1f} s")
    phase(f"phase 11: gemma3-4b (the sliding-window ring, D 256; full"
          f" width, {GEMMA_LAYERS} of 34 layers) and granite-3-8b (G 4)"
          f" served")
    t0 = time.perf_counter()
    gcfg = gemma_config(port)
    launches_g, metrics_g, launches_g8, metrics_g8 = serve_gemma(port, gcfg)
    t1 = time.perf_counter()
    launches_gr, metrics_gr = serve_granite(port)
    print(f"  tokens_per_s gemma3 float {metrics_g['tokens_per_s']:.2f},"
          f" int8 paged {metrics_g8['tokens_per_s']:.2f}, granite"
          f" {metrics_gr['tokens_per_s']:.2f}  ttft_p50_s gemma3"
          f" {metrics_g['ttft_p50_s']:.4f} / {metrics_g8['ttft_p50_s']:.4f},"
          f" granite {metrics_gr['ttft_p50_s']:.4f}  gemma3 part"
          f" {t1 - t0:.1f} s, granite part {time.perf_counter() - t1:.1f} s")
    phase(f"phase 12: zamba2-2.7b (mamba2 groups and a shared attention"
          f" block of D 80) served and prefilled at full width, {ZAMBA_LAYERS}"
          f" of 54 layers")
    (launches_z, metrics_z, launches_z8, metrics_z8, prefill_z,
     prof_z) = zamba_phase(port)
    phase(f"phase 13: the MoE decoders, phi3.5-moe-42b-a6.6b"
          f" ({MOE_LAYERS[PHI]} of 32 layers) and dbrx-132b"
          f" ({MOE_LAYERS[DBRX]} of 40), served, prefilled and trained at"
          f" full width")
    moe = moe_phase(port)
    phi, dbrx, (launches_mt, metrics_mt) = moe["phi"], moe["dbrx"], \
        moe["train"]
    phase(f"phase 14: the encoder-decoder backbone, seamless-m4t-large-v2"
          f" at full width and {SEAMLESS_LAYERS[0]} + {SEAMLESS_LAYERS[1]}"
          f" of its 24 + 24 layers, served in one shot and in chunks (float"
          f" and int8) and trained")
    encdec = encdec_phase(port)
    enc_l = encdec["serve"]["launches"]
    launches_et, metrics_et = encdec["train"]
    phase(f"phase 15: the VLM, qwen2-vl-72b at full width and {QWEN_LAYERS}"
          f" of its 80 layers: an image batch prefilled in one shot and"
          f" decoded, text one-shot against chunked (float and int8);"
          f" trained at {QWEN_TRAIN_LAYERS} layer")
    vlm = qwen_phase(port)
    vlm_l = vlm["serve"]["launches"]
    launches_qt, metrics_qt = vlm["train"]
    phase("phase 16: training breadth at full width: falcon-mamba-7b (24 of"
          " 64 layers), zamba2-2.7b (54), gemma3-4b (18 of 34)")
    breadth = breadth_phase(port)
    breadth_l = {arch: r["launches"] for arch, r in breadth.items()}
    phase("phase 17: the dry run against the card (the matrix traced on"
          " meta, four cut cells run on the card, the pod tuner, the"
          " elastic cycle)")
    free_card()
    dry = dryrun_phase(port, Path(dryrun_dir.name), matrix_waited)
    dryrun_dir.cleanup()
    dry_l = dry["launches"]

    phase("phase 9: the EON tuner and the Project API on the card")
    t0 = time.perf_counter()
    launches_tuner, launches_project, tp_summary = tuner_and_project(port)
    print(f"  phase {time.perf_counter() - t0:.1f} s")
    print("  artifacts " + json.dumps({
        "float_continuous": art3, "int8_paged": art5,
        "int8_continuous_calibrated": art5c, "mamba1_serving": art8,
        "kws_impulse": {"metrics": kws_art_metrics, "profile": kws_art_prof},
        "tuner_and_project": tp_summary}))
    print("  slices 7 and 8 " + json.dumps({
        "prefill": {arch: r[1] for arch, r in prefill.items()},
        "gemma3_continuous": metrics_g, "gemma3_int8_paged": metrics_g8,
        "granite_continuous": metrics_gr}))
    print("  slice 8 part 2 " + json.dumps({
        "zamba2_continuous": metrics_z, "zamba2_int8_paged": metrics_z8,
        "prefill_zamba2": prefill_z[1], "zamba2_step_profile": prof_z}))
    print("  slice 9 part 1 " + json.dumps({
        "phi3.5_moe_continuous": phi["metrics"],
        "phi3.5_moe_int8_paged": phi["metrics8"],
        "phi3.5_moe_step_profile": phi["profile"],
        "phi3.5_moe_routing": phi["routing"],
        "phi3.5_moe_int8_routing": phi["routing_int8"],
        "dbrx_continuous": dbrx["metrics"], "dbrx_routing": dbrx["routing"],
        "prefill_dbrx": dbrx["prefill"][1],
        "phi3.5_moe_training": metrics_mt}))
    print("  slice 9 part 2 " + json.dumps({
        "encdec": encdec["serve"]["metrics"],
        "encdec_decode_step_profile": encdec["serve"]["profile"],
        "encdec_training": metrics_et, "encdec_small_f32": encdec["small"]}))
    print("  slice 9 part 3 " + json.dumps({
        "qwen2vl": vlm["serve"]["metrics"], "qwen2vl_training": metrics_qt,
        "qwen2vl_small_f32": vlm["small"]}))
    print("  slice 11 " + json.dumps({k: dry[k] for k in (
        "matrix", "cells", "tuner", "elastic")}))
    print("  slice 10 " + json.dumps({
        "lm_training_remat": train_metrics["remat"],
        **{f"{arch}_training": {k: r[k] for k in ("metrics", "grads")}
           for arch, r in breadth.items()}}))
    print(f"total {time.perf_counter() - t_start:.1f} s")

    by_path = {name: {"float_continuous": launches[name],
                      "int8_paged": launches8[name],
                      "int8_continuous_calibrated": launches_cal[name],
                      "kws_impulse": launches_kws[name],
                      "kws_fit": launches_fit[name],
                      "lm_training": launches_train[name],
                      "mamba1_serving": launches_ssm[name],
                      "float_continuous_artifact": launches_a3[name],
                      "int8_paged_artifact": launches_a5[name],
                      "int8_continuous_calibrated_artifact":
                          launches_a5c[name],
                      "kws_impulse_artifact": launches_a6[name],
                      "mamba1_serving_artifact": launches_a8[name],
                      "eon_tuner": launches_tuner[name],
                      "project": launches_project[name],
                      "prefill_internlm2":
                          prefill["internlm2-1.8b"][0][name],
                      "prefill_gemma3": prefill["gemma3-4b"][0][name],
                      "gemma3_continuous": launches_g[name],
                      "gemma3_int8_paged": launches_g8[name],
                      "granite_continuous": launches_gr[name],
                      "zamba2_continuous": launches_z[name],
                      "zamba2_int8_paged": launches_z8[name],
                      "prefill_zamba2": prefill_z[0][name],
                      "phi3.5_moe_continuous": phi["launches"][name],
                      "phi3.5_moe_int8_paged": phi["launches8"][name],
                      "dbrx_continuous": dbrx["launches"][name],
                      "prefill_dbrx": dbrx["prefill"][0][name],
                      "phi3.5_moe_training": launches_mt[name],
                      **{f"encdec_{key}": n[name]
                         for key, n in enc_l.items()},
                      "encdec_training": launches_et[name],
                      **{f"qwen2vl_{key}": n[name]
                         for key, n in vlm_l.items()},
                      "qwen2vl_training": launches_qt[name],
                      **{f"{arch}_training": n[name]
                         for arch, n in breadth_l.items()},
                      **{f"dryrun_{cell}": n[name]
                         for cell, n in dry_l.items()}}
               for name in REPLACES}
    serving = (launches, launches8, launches_g, launches_g8, launches_gr,
               launches_z, launches_z8, phi["launches"], phi["launches8"],
               dbrx["launches"]) + tuple(enc_l.values()) \
        + tuple(vlm_l.values()) + (dry_l["decode_32k_b8"],)
    kernels = []
    for name in ("flash_decode", "flash_chunk_prefill"):
        kernels.append(dict(
            name=name, route="cuda", source=SOURCES[name],
            replaces=REPLACES[name],
            launches=sum(n[name] for n in serving),
            launches_by_path=by_path[name], **layout_rows[name]["float"],
            layouts=layout_rows[name]))
    kernels.append(dict(
        name="int8_matmul", route="cuda", source=SOURCES["int8_matmul"],
        replaces=REPLACES["int8_matmul"],
        launches=launches8["int8_matmul"] + launches_cal["int8_matmul"]
        + launches_g8["int8_matmul"] + launches_z8["int8_matmul"]
        + phi["launches8"]["int8_matmul"]
        + sum(n["int8_matmul"] for n in enc_l.values())
        + sum(n["int8_matmul"] for n in vlm_l.values()),
        launches_by_path=by_path["int8_matmul"],
        **mm_rows["M4_K2048_N8192"], shapes=mm_rows))
    kernels.append(dict(
        name="mel_frontend", route="cuda", source=SOURCES["mel_frontend"],
        replaces=REPLACES["mel_frontend"],
        launches=launches_kws["mel_frontend"] + launches_fit["mel_frontend"],
        launches_by_path=by_path["mel_frontend"],
        **mel_rows["full_width_512x99"], shapes=mel_rows))
    for name in ("flash_attention", "flash_attention_bwd"):
        kernels.append(dict(
            name=name, route="cuda", source=SOURCES[name],
            replaces=REPLACES[name],
            launches=launches_train[name] + prefill_z[0][name] + sum(
                prefill[arch][0][name] for arch in prefill)
            + dbrx["prefill"][0][name] + launches_mt[name]
            + sum(n[name] for n in enc_l.values()) + launches_et[name]
            + sum(n[name] for n in vlm_l.values()) + launches_qt[name]
            + sum(n[name] for n in breadth_l.values())
            + sum(n[name] for n in dry_l.values()),
            launches_by_path=by_path[name],
            **fa_rows[name]["train_b4_s2048"], shapes=fa_rows[name]))
    kernels.append(dict(
        name="mamba_scan", route="cuda", source=SOURCES["mamba_scan"],
        replaces=REPLACES["mamba_scan"],
        launches=launches_ssm["mamba_scan"]
        + breadth_l["falcon-mamba-7b"]["mamba_scan"]
        + dry_l["mamba_prefill_32k_b1"]["mamba_scan"],
        launches_by_path=by_path["mamba_scan"],
        **scan_rows["chunk_b1_s64"], shapes=scan_rows))
    kernels.append(dict(
        name="mamba_scan_bwd", route="cuda", source=SOURCES["mamba_scan_bwd"],
        replaces=REPLACES["mamba_scan_bwd"],
        launches=breadth_l["falcon-mamba-7b"]["mamba_scan_bwd"],
        launches_by_path=by_path["mamba_scan_bwd"],
        **scan_bwd_rows["train_b1_s2048"], shapes=scan_bwd_rows))
    print(json.dumps({"kernels": kernels}))
    print(gpu_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
