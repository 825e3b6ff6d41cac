"""Drive the PyTorch port on one NVIDIA GPU and check it, phase by phase.

    python3 chip_smoke.py

Phases (each raises on failure; the script then exits non-zero):

1. the card's name and power limit (nvidia-smi);
2. build the hand-written CUDA kernels from the checkout (five sources, one
   nvcc each, all started together, sm_90a) and print each kernel's
   registers and spills (the f32 attention's ``tf32x3_attention_*`` and
   the f32 subsampling's ``tc_pw_kernel`` / ``tc_wgrad_kernel`` among them);
3. each kernel against its plain PyTorch version on the same inputs, TF32
   off, the plain version computed in f32.  Tolerance: |kernel - plain| <=
   1e-4 (f32) or 2e-2 (bf16) of max |plain|:
   - flash attention at the flagship [2, 2048, 6, 128] with lengths
     [2048, 1600] and ragged T 1000 with lengths [1000, 777, 1000], bf16
     (the tensor-core kernels) and f32 (the ``"tf32x3"`` route: tensor-core
     kernels taking each product as three TF32 products), f32 also at head
     dim 30 (zero-padded by the wrapper), and in bf16 with a random,
     non-prefix 0/1 mask at the flagship shape and at T 37 (one key tile);
     every backward runs twice and must repeat bit for bit (no atomics), and
     each dtype must take its route; the bf16 kernels are
     also held against the plain version on the bf16 tensors, which rounds
     where the kernels round (``check_rounding``: 1 bf16 ulp of max, and at
     most 5 % of elements differing in dq, dk, dv, and in out at T 37);
   - fused subsampling, forward and backward (gx and all 10 weight
     gradients), at the flagship window [2, 16384, 80] with C 256 and ragged
     [3, 1001, 80], bf16 (the tensor-core kernels) and f32 (the ``"tf32x3"``
     route: each pointwise product as three TF32 products on the tensor
     cores); the backward runs twice and must repeat bit for bit (no
     atomics), and each dtype must take its route; the bf16 kernels are also
     held against the plain version on the bf16 tensors
     (``check_subsample_rounding``: every output within 2 bf16 ulps of its
     max, at most 2 % of out's and 15 % of gx's elements differing);
   - the bf16 subsampling with ``relu`` (the NeMo preset's activation) at
     the flagship window, forward and backward with gx, with the same checks
     (every launch of that activation, each backward with gx);
   - both bf16 kernels at AWMC's batch-1 shapes, with the same checks:
     attention [1, 2048, 6, 128] with length 2048 and 1792 (the ragged last
     window), subsampling [1, 16384, 80];
   - both bf16 kernels at the protocol drivers' evaluation-engine batch of
     4 windows (phases 16-16c), with the same checks: attention [4, 2048,
     6, 128] with lengths [2048, 2048, 2048, 1792] (a recording's last
     window) and [2048, 2048, 2048, 1100], subsampling [4, 16384, 80];
   - both bf16 kernels at phase 19's utterances (a clean and an augmented
     copy), with the same checks: attention [2, 64, 6, 128] (one query
     tile) and [2, 512, 6, 128], unpadded, subsampling [2, 512, 80] and
     [2, 4096, 80];
   - both bf16 kernels at phase 21's chunks (T_ds 256), with the same
     checks: attention [1, 256, 6, 128] at length 256 and a ragged 200, and
     [4, 256, 6, 128] (grpo's batch-4 step), subsampling [1, 2048, 80] and
     [4, 2048, 80];
   - the bf16 attention at phase 22's padded training batch, with the same
     checks: [4, 2048, 6, 128] with lengths [2048, 1100, 0, 0] and [1024, 0,
     0, 0] (zero-length rows: a ragged last batch, a recording's half
     window); its subsampling [4, 16384, 80] is the evaluation engine's case
     above;
   - each kernel ``autograd.Function`` under ``torch.func.vmap`` at R = 3,
     bf16, forward and backward, bit for bit against the per-record loop:
     attention [3, 2, 2048, 6, 128] (q, k, v views of one qkv tensor) with
     ragged lengths in exactly one launch each way for the group, and
     subsampling [3, 2, 16384, 80] with three distinct weight sets in one
     launch a record each way (``check_vmap``: phase 24's calls);
   - soft-DTW R and E (f32, 1e-4 relative on R, 1e-4 of max |E| on E, each
     E from the same R) at the
     ``benchmark()`` defaults (4, 256, 256), at (2, 1500, 700) with bandwidth
     100, at the utterance engine's shapes (1, 64, 64) and (1, 512, 512) and
     at (1, 2048, 2048); each kernel runs twice and must repeat bit for bit;
4. kernel, plain and library times (CUDA events after warm-up) at the
   flagship or benchmark shape, and the least time the card could take
   (bound).  Attention and subsampling are timed on both routes: bf16
   (tensor cores, the main path) and f32 (the parity route: 3xTF32 on the
   tensor cores, bounded by three TF32 products at 495 TFLOP/s, for the
   subsampling its pointwise products only and the rest at 67 TFLOP/s, and,
   as ``bound_cuda_core_ms``, by the same work all at 67 TFLOP/s on the CUDA
   cores).
   Library: SDPA with a boolean mask in the same dtype for attention (the
   kernels SDPA runs in f32 named from a profile); for
   the fused subsampling, the cuDNN stack the ``"conv"`` path runs (four
   ``F.conv2d`` calls with their activations, forward, and backward through
   autograd) in the same dtype; none for soft-DTW.  Soft-DTW is also timed
   at (1, 64, 64), (1, 512, 512) and (1, 2048, 2048), and its chain floor
   printed: (N + M - 1) steps at the latency of one step's dependent chain,
   the kernels' own step run alone by one warp and timed in SM cycles at the
   clock it ran at, beside the kernels' own time a step on a single strip of
   32 rows (one warp, 4096 columns), which is not a bound (a
   ``{"softdtw_chain": ...}`` line).
   The subsampling is also timed forward with ``relu`` and backward with gx
   (the entropy pass's), its bound adding stage 0's input gradient and gx's
   bytes, beside the plain version and cuDNN's backward with the input
   gradient.  The port never calls a
   library yardstick.  Then one subsampling forward and one backward of
   each route (bf16 and f32) under torch.profiler, broken down by kernel (a
   ``{"subsample_breakdown": ...}`` line);
5. the main path: the port's NSTI driver (``evals/run.py`` ``main``) on one
   30720-frame ``synthetic_spec`` recording (9 windows of seq 16384 /
   overlap 14336, the last ragged at 14336 frames) at the flagship widths
   with ``attention_impl="pallas_flash"`` and ``subsampling_impl="conv"``,
   bf16, random weights from a seed; the launch counters are zeroed just
   before and read just after, and every attention launch must have taken
   the bf16 tensor-core route;
6. output checks on that run: the engine's stitched log-probs are finite
   with the expected shape and the weights moved; then, on a small input,
   the full-depth model in f32 through the attention kernel agrees with the
   plain attention path on valid frames (1e-3), and so do its weight
   gradients (1e-3 of each gradient's max |value|, or of 1 % of the largest
   where that is more), cuDNN deterministic on both sides: this run's
   launches of the f32 route (``"tf32x3"``) are its ``parity_launches`` in
   the kernels line (its ``launches``, the main path's, are 0);
7. where the time goes: the driver's engine, warm, on the same recording:
   engine wall of 3 runs, ms per window and RTFx at the fastest; then, on
   the recording's first 3 windows (seq + stride frames), one untraced run
   and one under torch.profiler for device busy time, idle share against
   that untraced wall, device time by kernel family and the top kernels (a
   ``{"profile": ...}`` line; phases 7b, 11, 15b, 17b, 18b and 20a trace
   their 3 windows alike);
5b-7b. the same for ``subsampling_impl="pallas"`` (the fused subsampling
   kernels on the path; every subsampling launch must have taken the bf16
   route too); 6b also holds the full-depth f32 model through the f32
   subsampling kernels against the same model on the plain subsampling
   version (output and weight gradients) and against the ``"conv"`` model
   (output), on lengths [4000, 3000] (multiples of 8, where the two
   semantics agree), within 1e-3 on valid frames: this run's f32-route
   launches are ``fused_subsample_f32``'s ``parity_launches``;
5c. the f32 path: ``evals/run.py`` ``main`` on phase 5's recording at the
   flagship widths in f32 with ``attention_impl="pallas_flash"`` and
   ``"conv"`` subsampling (so the f32 attention kernels, route
   ``"tf32x3"``, are the only kernels on the path), again with ``"xla"``
   attention, and a third time with ``"pallas_flash"`` and ``"pallas"``
   subsampling (the f32 subsampling kernels, route ``"tf32x3"``, too),
   cuDNN deterministic in all three: attention launches exactly 6 / 6 per
   window and subsampling launches exactly 1 / 1 per window, all on that
   route (``f32_path_launches`` in the kernels line); stitched log-probs of
   the other runs within 1e-3 of max |log-prob| of the first, equal greedy
   ids (the windows are multiples of 8, where the two subsampling semantics
   agree); each engine's warm walls (cuDNN's own algorithms), ms per window
   and RTFx (a ``{"f32_path": ...}`` line);
8. soft-DTW's own path: ``benchmark(use_pallas=True)`` on the card, value
   and gradient of ``SoftDTW`` through both kernels, its launch counters
   zeroed just before and read just after;
9. checkpoints at flagship width: the seed-0 flagship weights (bf16,
   ``"pallas_flash"``, ``"pallas"``) saved as a DAE1 file and reloaded by
   ``load_any_checkpoint`` (state dict bit for bit, config field for
   field); the same weights as a reference ``{"model", "config"}`` torch
   pickle, reloaded (the same tensors; its config names no kernel); the
   flagship with batch-renorm mid-norms and moved running statistics as a
   reference pickle whose config names no norm: reloaded as batch renorm bit
   for bit, its log-probs on the card within 1e-3 of the in-memory model's;
10. the AWMC main path: ``evals/run_dynamic_eval_full.py`` ``main`` with
   ``--awmc --checkpoint`` the DAE1 file, on phase 5's recording (online, 1
   epoch, lr 9e-5); the launch counters are zeroed just before and read just
   after: every attention and subsampling launch on the bf16 route, and per
   adapted window exactly 24 attention forwards and 6 backwards, 4
   subsampling forwards and 1 backward (anchor, leader, student, clean);
   the run's stitched log-probs finite with the expected shape, the
   student's weights moved, its WER a number.  10b (parity): the full-depth
   f32 AWMC engine on a 2-window recording (3000 frames at seq 2048 /
   overlap 1024: 2048 and 1976 frames, multiples of 8) through the f32
   kernels (attention and subsampling ``"tf32x3"``), against
   the same engine with ``"xla"`` attention and ``"conv"`` subsampling,
   cuDNN deterministic on both sides: stitched log-probs within 1e-3 of max
   |log-prob|, equal greedy ids; its f32-route launches are
   ``awmc_parity_launches``;
11. where AWMC's time goes: phase 7's profile of the driver's warm AWMC
   engine (a ``{"profile": ...}`` line with ``"path": "awmc"``);
12. the native host libraries: ``native/levenshtein.cc`` and
   ``native/arpa_reader.cc`` built with ``g++`` (build seconds printed; a
   failed build, zlib's header missing included, fails the phase), and the
   native WER against the pure-Python DP on one 10k-word pair: equal counts,
   both timed;
13. the ``-lm`` path: ``evals/run.py`` ``main`` on phase 5b's recording and
   configuration with ``--tokenizer`` a 4095-piece vocabulary and ``-lm`` a
   token-level 4-gram ARPA file over it (both written from a seed: every
   unigram, ~2e5 / 5e5 / 5e5 higher-order n-grams, each extending a
   lower-order one), ``--beams 20`` and ``lm_tta_beams=3``: LM-fused
   pseudo-labels in every window and the final beam decode on the card.  The
   launch counters are zeroed just before and read just after: 6 / 6
   attention and 1 / 1 subsampling launches per window, all on the bf16
   route.  Checks: the n-gram tables on ``cuda``, read by the native reader;
   the transcript non-empty; the beam on the card gives the CPU's tokens on
   the first 512 collapsed frames of the record's stitched output (same
   function, same tables).  Prints ARPA load seconds and table bytes, the
   frames the collapse kept, the pseudo-label beam's ms per window, the
   final decode's seconds, the record's wall and the adaptation's ms per
   window beside phase 5b's (a ``{"lm_path": ...}`` line);
14. the transformer-LM ``-lm`` path: a seeded LM at the published lming
   shape (6 x 512, 8 heads, expansion 4, cache 128) over phase 13's
   vocabulary, written as a DLM1 file and as a lming torch pickle, both read
   back bit for bit; ``evals/run.py`` ``main -lm <DLM1> --beams 20 -kwargs
   lm_tta_beams=3`` on a 3-window recording (18432 frames: the recording is
   cut, not the widths), flagship, ``"pallas"`` subsampling.  Launches
   exactly 6 / 6 attention and 1 / 1 subsampling per window, all bf16; the
   LM on ``cuda`` in f32 (the drivers pass no compute dtype); a non-empty
   transcript; the card's beam equal to the CPU's (the pickle's LM) on the
   first 512 collapsed frames, scores within 1e-4 relative.  A ``{"tlm_path":
   ...}`` line: load seconds, LM parameters and cache bytes, pseudo-label
   beam ms per window and per frame, final decode ms per kept frame, record
   wall;
15. the consistency path: ``evals/run_dynamic_eval_full.py`` ``main
   --consistency --checkpoint`` phase 9's DAE1 file, offline, 1 epoch, on
   phase 5's recording: per chunk exactly 12 attention forwards and 6
   backwards, 2 subsampling forwards and 1 backward (the adaptation's batch
   and the re-inference), all bf16; every chunk's weights moved, finite
   WER, peak device memory printed.  15b: its profile (a ``{"profile":
   ...}`` line with ``"path": "consistency"``).  15c (parity): a 2-layer f32
   consistency engine at flagship widths, offline, 2 epochs, on phase 10b's
   2-window recording, through the f32 kernels (both ``"tf32x3"``)
   against the plain path, cuDNN deterministic on both sides (stitched
   log-probs within 1e-3 of max |log-prob|, equal greedy ids); its f32-route
   launches are ``consistency_parity_launches``;
16. the protocol drivers at the flagship widths, bf16, ``"pallas"``
   subsampling, with the launch scripts' settings (offline, shuffled
   windows, 1 epoch, lr 9e-5, 6 frequency masks of width < 34, no time
   masks), each driven twice through its ``main`` (first and warm), the
   launch counters zeroed just before each run and read just after: per
   run exactly one attention launch per layer and one subsampling launch
   per forward (a window's [augmented, clean] batch, or ``infer_batch``
   windows of the evaluation engine) and per backward, as the plans
   (``half_concat_plan``, ``loo_plan``, ``seq_plan``) derive them from the
   engine's code, all bf16, none of soft-DTW.  16: ``run_half_concat_eval``
   ``-ao 14336`` on four 30720-frame recordings: each fold adapt-only on a
   61440-frame concatenation (24 windows; no stitched log-probs, weights
   moved from the pristine ones, which stay bit for bit), then 2 records of
   9 windows evaluated with that fold's weights; the baseline evaluates all
   4; a pickle with 2 folds and a baseline, finite WERs.  16b:
   ``run_within_recording_loo_eval`` on one 131072-frame recording at
   ``--loo_seq_len 65536 --loo_overlap 57344``: 10 chunks, 4 adaptations
   (chunks 0, 1, 8, 9) and 6 windowed inferences; ``loo_eval`` took the
   ``"loo"`` mode, its stitch covers every downsampled frame, finite.  16c:
   ``run_seq_eval`` on one 49152-frame recording at ``--nsti_seq_len 32768
   --nsti_overlap 28672``: 6 outer chunks (the stop rule adds a sixth of
   28672 frames) of 10, 10, 10, 10, 10 and 8 windows; the second-level
   stitch has the recording's downsampled length, finite.  Each prints a
   ``{"protocols": ...}`` line: plan, windows adapted and evaluated, walls
   (first, warm), engine seconds, the adapting engine's re-inference
   seconds (timed apart), ms per adapted window (adaptation alone: the
   adapting engine's seconds less its re-inference), launches, card;
17. entropy augmentation: ``evals/run.py`` ``main`` with ``-kwargs
   entropy_augmentation_enabled=true --profile build/profiles/phase17``
   on phase 5's recording, flagship, bf16, ``"pallas"`` subsampling: per
   adapted window exactly 12 attention forwards and 12 backwards (the
   batch-1 entropy pass and the batch-2 step) and 2 subsampling forwards and
   2 backwards, exactly one of them with gx (``gx_launches``), all bf16;
   stitched log-probs finite, weights moved; the Chrome trace of repeat 0
   exists and holds CUDA kernels (kept gzipped); the first window's
   perturbation in f32, max |delta| beside max |aug| (finite, non-zero);
   peak memory above what the phase began with; 17b its profile (``"path": "entropy"``) and an
   ``{"entropy_path": ...}`` line;
18. the NeMo preset: ``stt_en_fastconformer_ctc_large`` (17 layers, d 512,
   8 heads x 64, vocab 1024, ``rel_pos``, ``input_xscale``, biases,
   ``batch_norm``, relu x8 dw-striding with 256 channels) with
   ``"pallas"`` subsampling, bf16, its weights random from a seed as a
   NeMo-named state dict through ``convert_nemo_state_dict`` (running
   statistics mean ~ N(0, 0.1), var ~ U(0.5, 2)), saved as DAE1 and driven
   by ``evals/run.py`` ``main --checkpoint`` on phase 5's recording with a
   1024-piece vocabulary: per window 0 attention launches (``rel_pos`` is
   plain PyTorch in both packages) and exactly 1 subsampling forward and 1
   backward, no gx, all bf16 and relu; stitched log-probs finite, weights
   moved, peak memory above what the phase began with; the preset at full depth in f32 through the f32
   subsampling kernel against the plain subsampling version on lengths
   [4000, 3000], within 1e-3 on valid frames (``nemo_parity_launches``);
   18b its profile (``"path": "nemo"``: ms per window, RTFx, warm, 3 runs)
   and a ``{"nemo_path": ...}`` line;
19. the utterance path: ``evals/run_utterance_eval.py`` ``main
   --segment_frames 512`` on phase 5's recording (60 utterances, T_ds 64;
   online, 1 epoch, lr 9e-5), flagship, bf16, ``"pallas"`` subsampling: per
   utterance exactly 6 attention forwards and 6 backwards and 1 subsampling
   forward and 1 backward, all bf16, no soft-DTW launch and no final pass;
   transcript and WER finite, every utterance's log-probs finite, weights
   moved; warm ms per utterance over the 60, device busy and idle share over
   the first 10 under torch.profiler.  19b: ``UtteranceTTAEngine(soft_dtw_weight=0.1)`` on 8 utterances
   of 512 frames and 2 of 4096 cut from that recording, a fixed perturbation
   as its ``augment_fn``: per utterance the same launches and exactly 1 R
   and 1 E soft-DTW kernel; the D of the first utterance of each length,
   taken where the engine hands it to ``kernels.softdtw.soft_dtw``, must be
   asymmetric (max |D - D^T| above 1e-3 of max |D|), holds both kernels
   against the plain version as phase 3 does (R 1e-4 relative, E from the
   kernel's R within 1e-4 of max |E|, bit-for-bit repeats), and through
   ``soft_dtw`` gives the R kernel's value and the E kernel's gradient bit
   for bit; warm ms per utterance at each length with and without the
   soft-DTW term, the soft-DTW kernels' ms and their share of the step, peak
   memory above what the phase began with; a ``{"utterance_path": ...}``
   line;
20. wav2vec2-base (``evals/run_wav2vec2.py --full_size``, f32): the chunked
   mode on a 60 s synthetic wave at 48000 / 16000 samples (30 windows),
   stitched log-probs finite over ``feat_extract_output_lengths``' frames,
   weights moved, its profile (``"path": "wav2vec2"``); 20b
   ``--per_utterance`` (``ctc_mean``, clip 10) on the driver's own two 4 s
   records, finite log-probs, weights moved; 0 attention, subsampling and
   soft-DTW launches in both; a ``{"wav2vec2_path": ...}`` line;
21. the encoder-decoder path: ``evals/enc_dec_dynamic_eval_test.py``
   ``main`` with the flagship encoder (bf16, ``"pallas_flash"``,
   ``"pallas"`` subsampling) and ``EncDecConfig``'s default decoder (4 x
   512, 8 heads x 64, f32 as in JAX), random from seed 0, a 4095-piece
   vocabulary as ``--tokenizer``, on a 16384-frame recording with
   ``launch_scripts/eval_list_encdec_deval.sh``'s settings (``-seq 2048 -o
   0 -kwargs optim_lr=9e-6 epochs=1``: 8 chunks), three times: ``grpo`` with
   no filter, ``grpo`` with the ``quality_plus_decode_agreement`` stack,
   ``teacher_ce``.  Each run's branches are read by wrapping
   ``tta.encdec_rl`` for the run (:class:`BranchLog`), and its launches
   must be exactly what they derive: per encoder pass (a teacher decode,
   the rollouts' decode, a teacher-forced pass, an update's forward, a
   final decode) one attention forward per layer and one subsampling
   forward, per update one backward of each, all bf16; a teacher and a
   final decode per chunk, updates at batch 4 (``grpo``) or 1
   (``teacher_ce``); finite WER and a transcript, finite adapted weights
   that moved where a chunk updated, ``pos_enc`` unchanged bit for bit.
   21a: the first run's engine warm: ms per decode step of the teacher
   (batch 1) and of the rollouts (batch 4); over the recording's first 2
   chunks, ms per chunk (untraced) and, under torch.profiler (the device's
   activity alone), device busy time, idle share and the attention and
   subsampling kernels' share; peak memory; an ``{"encdec_path": ...}``
   line.  21b:
   ``evals/enc_dec_inference_test.py`` ``-mode default`` (exactly 6 / 0
   attention and 1 / 0 subsampling launches a chunk) and
   ``evals/enc_dec_ctc_beam_inference_test.py -beams 10`` (one encoder pass
   over the recording) on the same recording and model, all bf16; the
   card's beam equal to the CPU's on the first 512 frames of the CTC
   branch's log-probs (an ``{"encdec_inference": ...}`` line).  21c: the
   enc-dec at full depth in f32 through the f32 kernels against the plain
   path (``"xla"``, ``"conv"``), teacher-forced on a batch of 2 at lengths
   2048 and 1600, cuDNN deterministic: CTC log-probs and decoder logits
   within 1e-3 on valid frames and positions (``encdec_parity_launches``).
22. NST finetuning: ``train/cli.py`` ``main -config <yaml> --data
   <manifest>``, the yaml written here (JSON, which is YAML in flow style:
   the card has no PyYAML) with the flagship widths (bf16,
   ``"pallas_flash"``, ``"pallas"``), lr 1e-5, batch 4 x 16384 frames,
   overlap 0, EMA 0.8, clip 0.8, 6 frequency masks of width < 34; the
   manifest two synthetic 16 kHz wavs of 73728 frames (737.28 s: 4.5
   windows, so 2 steps a recording, the second one ragged window and three
   zero-length rows), 4 steps.  Launches exactly 12 attention forwards
   (teacher and student) and 6 backwards, 2 subsampling forwards and 1
   backward without gx a step, all bf16; every loss finite, the weights
   moved, the EMA between the initial and the trained weights (projected on
   their difference, inside (0, 1)), ``epoch_0.ckpt`` and its side file
   written, and ``NSTTrainer.resume`` of it gives the weights, the EMA,
   MADGRAD's state and ``step_count`` bit for bit.  22a: the trainer warm,
   3 steps three times untraced (ms per step) and once under
   torch.profiler: device busy, idle share, time by kernel family, the
   kernels' share; peak memory above the phase's start; a ``{"train_path":
   ...}`` line;
22b. one NST step of the full-depth flagship in f32 through the f32 kernels
   (``"tf32x3"``) against the plain path (``"xla"``, ``"conv"``), the
   augmentation off, cuDNN deterministic, on a batch of 4 x 16384 frames at
   lengths 16384, 8192, 0, 0: the loss within 1e-3 relative, the weight
   gradients within phase 6's bar; exactly 12 / 6 attention and 2 / 1
   subsampling launches on the f32 route (``train_parity_launches``);
23. word-level LM fusion as the reference fuses its word 4-gram with a
   character CTC model: a synthetic word 4-gram ARPA (20000 words of 1 to 9
   letters, ~6e4 n-grams per higher order) and the character tokenizer;
   ``build_ctcdecoder(..., lm_level="auto")`` (it must pick word level, its
   tables read natively onto the device) and ``word_beam_search`` over the
   ARPA's words, each on the card and on the CPU on one set of log-probs
   spelling 120 of the words with close rivals: equal live beams
   (``check_live_beams``) and texts, every word of the lexicon search in the
   lexicon; a ``{"word_fusion": ...}`` line.  Each new heading prints its
   seconds.
24. records batching (``--dp_records``' engine): ``DynamicEvalEngine.batched``
   on 4 ``synthetic_spec`` recordings of 30720, 30720, 22528 and 16384
   frames (9, 9, 5 and 1 windows: 9 group steps) at the flagship (bf16,
   ``"pallas_flash"``, ``"pallas"``, seed 0) with phase 5's TTA settings,
   each record seeded as its serial run; launches exactly 6 / 6 attention
   (the group folded into one launch a layer) and 4 / 4 subsampling (one a
   record) a group step, all bf16; every output finite with its shape, every
   record's weights moved; per record, against the serial engine on the
   same record and seed, max |Δ log-prob| and the share of frames with the
   same argmax (printed); the warm group's ms a step beside 4 serial window
   steps; over 3 group steps (each record's first SEQ + 2 strides frames),
   device busy time and idle share from torch.profiler; peak memory above
   the phase's start; a ``{"records_path": ...}`` line.  24b: the same API
   in f32 at the flagship widths (TF32 off, the ``"tf32x3"`` kernels) on
   16384 + 8192 frames against the serial engine, cuDNN deterministic:
   log-probs within 1e-4 of max |log-prob|, equal greedy ids.  24c:
   ``evals/run.py`` ``main --dp_records`` (online) and ``--dp`` (offline)
   at world size 1 (NCCL), f32, on the same two records, against the serial
   driver: equal transcripts and WER, and each record's stitched log-probs
   (from the engine the driver built) within 1e-4 of max with equal greedy
   ids.  24d: one NSTI window step (16384 frames) at the flagship, bf16,
   with ``checkpoint_every_n_layers=1, remat_subsampling=True`` beside the
   same step without, twice: the updated weights bit for bit, or within the
   two plain steps' spread; each run's peak memory; the recomputation's
   extra forwards exactly 6 attention and 1 subsampling; a ``{"remat":
   ...}`` line.
25. tensor and sequence parallelism: ``torch.distributed.run
   --nproc_per_node 2`` on this script (PARALLEL_RANK set), a gloo group
   with both ranks on the one card (NCCL refuses two ranks on one device;
   gloo runs its all-reduce and all-gather on CUDA tensors).  25a: the
   NSTI engine ``evals.common.build_engine`` builds with ``--dp --tp 2``
   (a ``('dp', 'tp')`` mesh of 1 x 2, the working copy sharded) on a
   3-window recording, the flagship (bf16, ``"pallas_flash"``,
   ``"pallas"``), against the same run at tp 1 in each rank: ≥ 0.99 of
   frames with the same argmax, max |Δ log-prob| printed; on each rank
   exactly 6 / 6 attention launches of 3 heads and 1 / 1 subsampling a
   window; the same in f32 at 2 layers (TF32 off), max |Δ log-prob| and
   the tp 1 run's own repeat spread printed only (CTC's atomics carried
   through 3 windows of MADGRAD), and held: the engine's windowed inference
   before adaptation (``epochs=0``) within 1e-4 of max |log-prob| with
   greedy ids equal, and the gradients of a fixed linear functional of one
   window's log-probs through a model sliced by ``shard_params``, each
   rank's slices within 1e-4 of max of the whole model's.  25b: ``seq_shard_axes`` under
   ``use_mesh`` of a ``('dp', 'sp')`` mesh of 1 x 2 on a batch of 2 x 16384
   frames (T_ds 1024 a rank), forward and one step against the unsharded
   model in the same rank: f32 at 2 layers, log-probs within 1e-4 of max
   on valid frames and the gradients of a fixed linear functional of the
   log-probs within 1e-4 of max (the CTC loss's gradients printed, not
   held); bf16 at the flagship depth, ≥ 0.99 of valid frames with the same
   argmax; every attention launch a query block (6 heads, 1024 rows from
   row 1024 r against 2048 keys), one a layer forward and one a layer in
   each of the two backwards, subsampling 1 / 2;
   peak memory a rank beside the unsharded run's; a ``{"parallel": ...}``
   line.  25c (first, in this process): the query-block kernels of both
   routes on q [2, 1024, 6, 128] against k, v [2, 2048, 6, 128], lengths
   2048 and 1600, both blocks: against the plain version at phase 3's
   bars, out, lse and dq rows the full call's bit for bit, the blocks' dk
   and dv summed within phase 3's bf16 ulp bar (f32: its 1e-4 bar) of the
   full call's, a block of 700 rows from row 300 against the plain version;
   each block's CUDA-event times beside the full call's.

Where the NSTI engine's adapt step replays CUDA graphs (``tta/graphed.py``:
on the card, for a window shape that repeats within a record), the kernels'
counters count the passes that run their wrappers: each eager adapt step,
and a capture's warm-up and capture passes; a replay runs none and counts
nothing.  The adapt step's per-window launches above are therefore checked
over ``windows - replays + 2 * captures`` passes (:func:`graph_offset`
gives the difference from the engine's own totals), and phase 5's engine
captures once and replays every window after the first.

Prints the card line, a ``{"kernels": [...]}`` line (each kernel's
``launches`` on the NSTI path, ``awmc_launches`` on the AWMC path,
``lm_launches`` on the ``-lm`` path, ``tlm_launches`` on the transformer-LM
path, ``consistency_launches`` on the consistency path,
``protocol_launches`` over the first runs of phases 16-16c,
``entropy_launches`` (phase 17), ``nemo_launches`` (phase 18),
``utterance_launches`` and ``utterance_softdtw_launches`` (phases 19 and
19b), ``wav2vec2_launches`` (phases 20 and 20b) and ``encdec_launches``
(phases 21 and 21b) and ``trainer_launches`` (phase 22), each read from its
own runs; ``encdec_parity_launches`` (21c) and ``train_parity_launches``
(22b) beside the other parity counts; ``records_launches`` (phase 24),
``remat_launches`` (24d's remat step) and ``vmap_launches`` (phase 3's
vmapped calls), ``tp_launches`` and ``sp_launches`` (rank 0's in 25a and
25b: bf16 on the main routes, f32 on the parity routes), for the attention
``query_block_ms`` (25c: each block's ms) and ``query_block_full_ms``,
and for the f32 kernels ``records_parity_launches`` (24b)
and ``records_driver_launches`` (24c); ``f32_path_launches`` for the f32
attention and
subsampling, from phase 5c; the subsampling backwards' ``entropy_gx_launches``
and ``nemo_gx_launches``, its ``gx_ms`` / ``gx_bound_ms`` /
``gx_library_ms``, and the bf16 forward's ``relu_ms``), and last
``{"ok": true, "device": {...}}``.  TF32 stays off throughout for PyTorch's
matmuls and convolutions; cuDNN's deterministic algorithms are on only
inside the parity comparisons (phases 6, 6b, 5c, 10b, 15c, 21c, 22b, 24b,
24c), so the
timed phases keep cuDNN's own choice.
"""

from __future__ import annotations

import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import torch

START = time.time()  # the phase headings' clock
FWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# bf16 kernels against the plain version that rounds as they do (phase 3
# prints both numbers); a plain version that does not round fails the share
# (tests/test_torch_chip_smoke.py)
BF16_ULPS = 1.0
BF16_DIFF_SHARE = 0.05
# the bf16 subsampling kernels against the rounding plain version: bf16 ulps
# of max |plain| for every output, share of differing elements for out and gx
SUB_BF16_ULPS = 2.0
SUB_DIFF_SHARE = {"out": 0.02, "gx": 0.15}
# relu's derivative jumps at 0: where the kernels' and the plain version's
# pre-activations straddle 0 by rounding, their gradients differ there by the
# whole local gradient, which no element-wise bar on gx can hold; gx is held
# by its L2 error relative to the plain version's and the share of its
# elements beyond FWD_TOL of max (the weight gradients, sums over every
# position, and out keep the element-wise bars)
RELU_GX = {"rel_l2": 1e-2, "share": 1e-3}
ATTENTION_KEY_TILE = 64  # keys per tile of the bf16 forward kernel
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}  # H100 SXM dense
PEAK_BYTES = 3.35e12
F32_FLOPS = 67e12  # outside the tensor cores
TF32_FLOPS = 495e12  # dense, on the tensor cores: the f32 attention's three products each
ODD_HEAD_DIM = 30  # phase 3's f32 attention at a head dim the wrapper pads
N_FRAMES = 30720
SEQ, OVERLAP = 16384, 14336
N_WINDOWS = 9  # ops.chunk.chunk_starts_and_lengths(N_FRAMES, SEQ, OVERLAP)
TIMED_RUNS = 3
TOP_KERNELS = 15
SUB_FLAGSHIP = (2, 16384, 80, 256)  # B, T, F, C of one adapted window
SUB_RAGGED = (3, 1001, 80, 256)
SDTW_BENCH = (4, 256, 256)  # kernels.softdtw.benchmark defaults, D 64, gamma 1
SDTW_UTTERANCE = ((1, 64, 64), (1, 512, 512), (1, 2048, 2048))  # B = 1, T_ds 64 to ~2k
SDTW_CASES = ((SDTW_BENCH, 0), ((2, 1500, 700), 100), ((1, 64, 64), 0), ((1, 512, 512), 0),
              ((1, 2048, 2048), 0))
SDTW_STRIP = (1, 32, 4096)  # one strip: the kernels' own time a step
AWMC_PARITY = (3000, 2048, 1024)  # frames, seq, overlap: windows of 2048 and 1976
RUN_KWARGS = ["-kwargs", "epochs=1", "online=true", "shuffle=false", "optim_lr=9e-5",
              "spec_augment_n_freq_masks=6", "spec_augment_freq_mask_param=34", "seed=0"]
WER_WORDS = 10_000  # phase 12's long pair, timed on the native path
WER_COUNTS = (442, 371, 1136)  # its (ins, del, sub) by the Python DP (text/wer.py::_edit_ops)
WER_DP_WORDS = 2_000  # phase 12's pair on both paths
LM_VOCAB = 4095  # the flagship's vocabulary (+ blank)
LM_COUNTS = (200_000, 500_000, 500_000)  # drawn bigrams, trigrams, 4-grams (before dedup)
LM_BEAMS, LM_TTA_BEAMS = 20, 3
LM_CHECK_FRAMES = 512  # phases 13 and 14: card-against-CPU decode
TLM_FRAMES, TLM_WINDOWS = 18432, 3  # phase 14's recording: 16384, 16384, 14336 frames
TLM_HEADS = 8  # the published lming shape: 6 x 512, 8 heads, expansion 4, cache 128
TLM_RTOL = 1e-4  # phase 14's card-against-CPU beam scores
CONSISTENCY_PARITY_LAYERS = 2  # phase 15's f32 engine: flagship widths, depth cut
# phases 16-16c: the protocol drivers with the launch scripts' settings
# (launch_scripts/tune_half_concat_eval.sh, tune_within_loo.sh, eval_seq2.sh:
# offline, shuffled windows, 1 epoch)
PROTOCOL_KWARGS = ["-kwargs", "epochs=1", "optim_lr=9e-5", "spec_augment_n_freq_masks=6",
                   "spec_augment_freq_mask_param=34", "spec_augment_n_time_masks=0", "seed=0"]
HALF_RECORDS = 4  # phase 16: four recordings of N_FRAMES frames
LOO_FRAMES, LOO_SEQ, LOO_OVERLAP = 131072, 65536, 57344  # phase 16b: 10 chunks
SEQ_FRAMES, NSTI_SEQ, NSTI_OVERLAP = 49152, 32768, 28672  # phase 16c: 6 outer chunks
# the flagship's fields in a reference checkpoint's config (no kernel named)
REFERENCE_FIELDS = ("feat_in", "n_layers", "d_model", "n_heads", "head_dim", "vocab_size",
                    "subsampling_factor", "subsampling_conv_channels", "conv_kernel_size",
                    "rotary_base_freq", "self_conditioning")
FAMILIES = (
    ("flash_attention", ("tc_attention_", "tf32x3_attention_")),
    ("fused_subsample", ("::tc_pw_kernel<", "::tc_wgrad_kernel(", "::weights_kernel(",
                         "::pw_kernel<", "::wgrad_kernel<", "::dw_bwd_kernel<", "::gx_kernel",
                         "namespace)::reduce_kernel(")),
    ("conv", ("conv", "cudnn", "fprop", "implicit", "wgrad", "dgrad")),
    ("gemm", ("gemm", "xmma", "cutlass", "sm90_", "ampere_", "cublas")),
    ("ctc", ("ctc",)),
    ("norm_softmax", ("layer_norm", "softmax", "LayerNorm")),
    ("reduce", ("reduce",)),
    ("elementwise", ("elementwise", "vectorized", "unrolled", "Kernel")),
)


def log(msg: str) -> None:
    """Print ``msg``; a phase's heading (``[n] ...``) with the seconds since
    the script began."""
    if msg.startswith("["):
        msg = f"{msg} (at {time.time() - START:.1f} s)"
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def flagship_config(**overrides):
    from dynamic_asr_eval_tpu_torch.models import ConformerConfig

    kw = dict(feat_in=80, n_layers=6, d_model=768, n_heads=6, head_dim=128, vocab_size=4095,
              subsampling_factor=8, subsampling_conv_channels=256, conv_kernel_size=9,
              rotary_base_freq=1_500_000.0, self_conditioning=True,
              compute_dtype=torch.bfloat16, attention_impl="pallas_flash",
              attention_logits_in_compute_dtype=True, head_in_compute_dtype=True)
    kw.update(overrides)
    return ConformerConfig(**kw)


def cuda_ms(fn, iters=20, warmup=3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(flops, nbytes, peak_flops):
    """(least ms, "operations" or "bytes")."""
    t_ops, t_bytes = flops / peak_flops * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def check_close(what, pairs, tol):
    """pairs of (name, kernel output, plain output in f32) → {name: max |err|}."""
    errs = {}
    for name, a, b in pairs:
        err = (a.float() - b).abs().max().item()
        scale = b.abs().max().item()
        if not err <= tol * scale:
            raise AssertionError(f"{what} {name}: |err| {err:.3e} > {tol} x {scale:.3e}")
        errs[name] = err
    return errs


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------


def attention_inputs(B, T, H, D, lengths, dtype, seed=0):
    """q, k contiguous and v a strided view of one qkv tensor, as the model
    hands them to the kernel.  ``lengths`` None: a random 0/1 mask."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    qkv = torch.randn(B, T, 3, H, D, generator=g, device="cuda").to(dtype)
    q, k, v = qkv.unbind(2)
    if lengths is None:
        mask = torch.rand(B, T, generator=g, device="cuda") < 0.5
    else:
        mask = torch.arange(T, device="cuda")[None] < torch.tensor(lengths, device="cuda")[:, None]
    dout = torch.randn(B, T, H, D, generator=g, device="cuda").to(dtype)
    return q.contiguous(), k.contiguous(), v, mask, dout


def check_attention(A, B, T, H, D, lengths, dtype):
    q, k, v, mask, dout = attention_inputs(B, T, H, D, lengths, dtype)
    A.reset_counters()
    out, lse = A.flash_attention_fwd(q, k, v, mask)
    grads = A.flash_attention_bwd(q, k, v, mask, out, lse, dout)
    again = A.flash_attention_bwd(q, k, v, mask, out, lse, dout)
    route = A.ROUTES[dtype]
    if A.route_launches[route] != [1, 2]:
        raise AssertionError(f"attention {dtype}: launches by route {A.route_launches}, "
                             f"expected {route} only")
    ref_out, ref_lse = A.attention_reference(q.float(), k.float(), v.float(), mask)
    ref_grads = A.attention_reference_bwd(q.float(), k.float(), v.float(), mask,
                                          ref_out, ref_lse, dout.float())
    torch.cuda.synchronize()
    what = f"attention {dtype} T={T} lengths={lengths or 'random 0/1 mask'}"
    if not all(torch.equal(a, b) for a, b in zip(grads, again)):
        raise AssertionError(f"{what}: the backward does not repeat bit for bit")
    errs = check_close(what, zip(("out", "dq", "dk", "dv"), (out,) + tuple(grads),
                                 (ref_out,) + tuple(ref_grads)), FWD_TOL[dtype])
    lse_err = (lse - ref_lse).abs().max().item()
    if not lse_err <= 1e-3:
        raise AssertionError(f"{what}: lse |err| {lse_err:.3e}")
    log(f"  {what} ({route}): " + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
        + f", lse {lse_err:.2e}; backward repeats bit for bit")
    if dtype == torch.bfloat16:
        check_rounding(A, what, T, q, k, v, mask, dout, out, lse, grads)
    return errs


def bf16_ulp(x: float) -> float:
    """One bf16 ulp at |x|: 2^(floor(log2 |x|) - 7)."""
    return 2.0 ** (math.floor(math.log2(x)) - 7)


def check_rounding(A, what, T, q, k, v, mask, dout, out, lse, grads):
    """The bf16 kernels against the plain version on the same bf16 tensors,
    which rounds where JAX's Pallas kernel rounds (P before P·V and dV, dS
    before dQ and dK); the plain backward gets the kernel's own out and lse.
    Every output within BF16_ULPS bf16 ulps of its max |plain|; the share of
    elements that differ at all within BF16_DIFF_SHARE for dq, dk, dv, and for
    out where T fits one key tile (past one tile the kernel rounds P against
    each tile's running max, the plain version against the row's max)."""
    r_out, _ = A.attention_reference(q, k, v, mask)
    r_grads = A.attention_reference_bwd(q, k, v, mask, out, lse, dout)
    torch.cuda.synchronize()
    report = []
    for name, a, b in zip(("out", "dq", "dk", "dv"), (out,) + tuple(grads),
                          (r_out,) + tuple(r_grads)):
        ulps = (a.float() - b.float()).abs().max().item() / bf16_ulp(b.float().abs().max().item())
        share = (a != b).float().mean().item()
        held = name != "out" or T <= ATTENTION_KEY_TILE
        if not (ulps <= BF16_ULPS and (share <= BF16_DIFF_SHARE or not held)):
            raise AssertionError(f"{what} against the rounding plain version: {name} "
                                 f"{ulps} ulps of max, {share:.4f} of elements differ")
        report.append(f"{name} {ulps} ulp, {share:.4f} differ" + ("" if held else " (not held)"))
    log(f"    against the plain version rounding as the kernel: {', '.join(report)}")


def time_attention(A, B, T, H, D, lengths, dtype):
    import torch.nn.functional as F

    q, k, v, mask, dout = attention_inputs(B, T, H, D, lengths, dtype, seed=1)
    out, lse = A.flash_attention_fwd(q, k, v, mask)
    ref_out, ref_lse = A.attention_reference(q, k, v, mask)
    same = A._same_segment(mask)  # [B, 1, T, T]
    qs, ks, vs = (x.transpose(1, 2).detach().requires_grad_(True) for x in (q, k, v))
    sdpa_out = F.scaled_dot_product_attention(qs, ks, vs, attn_mask=same)
    dout_t = dout.transpose(1, 2)
    t = {
        "fwd": cuda_ms(lambda: A.flash_attention_fwd(q, k, v, mask)),
        "bwd": cuda_ms(lambda: A.flash_attention_bwd(q, k, v, mask, out, lse, dout)),
        "fwd_plain": cuda_ms(lambda: A.attention_reference(q, k, v, mask)),
        "bwd_plain": cuda_ms(lambda: A.attention_reference_bwd(q, k, v, mask, ref_out,
                                                               ref_lse, dout)),
        "fwd_library": cuda_ms(lambda: F.scaled_dot_product_attention(qs, ks, vs, attn_mask=same)),
        "bwd_library": cuda_ms(lambda: torch.autograd.grad(sdpa_out, (qs, ks, vs), dout_t,
                                                           retain_graph=True)),
    }
    # least time for this run's inputs: pairs (i, j) of one segment only
    pairs = sum(n * n + (T - n) * (T - n) for n in lengths) * H
    esize = torch.finfo(dtype).bits // 8
    tensor_bytes = B * T * H * D * esize
    lse_bytes = B * H * T * 4
    work = {"fwd": (4 * D * pairs, 4 * tensor_bytes + lse_bytes + B * T * 4),
            "bwd": (10 * D * pairs, 8 * tensor_bytes + lse_bytes + B * T * 4)}
    if dtype == torch.float32:
        # the f32 kernels take each product as three TF32 products on the
        # tensor cores; the same work on the CUDA cores is bounded too
        bounds = {k: bound(3 * f, b, TF32_FLOPS) for k, (f, b) in work.items()}
        bounds.update({f"{k}_cuda_core": bound(f, b, F32_FLOPS) for k, (f, b) in work.items()})
    else:
        bounds = {k: bound(f, b, PEAK_FLOPS[dtype]) for k, (f, b) in work.items()}
    return t, bounds


def sdpa_kernels(A, dtype):
    """The kernels SDPA (phase 4's yardstick) runs at the flagship shape in
    ``dtype``, forward and backward, from the profile."""
    import torch.nn.functional as F

    from dynamic_asr_eval_tpu_torch.perf import profile_kernels

    q, k, v, mask, dout = attention_inputs(2, 2048, 6, 128, [2048, 1600], dtype, seed=1)
    same = A._same_segment(mask)
    qs, ks, vs = (x.transpose(1, 2).detach().requires_grad_(True) for x in (q, k, v))
    out = F.scaled_dot_product_attention(qs, ks, vs, attn_mask=same)
    result = {
        "fwd": profile_kernels(lambda: F.scaled_dot_product_attention(qs, ks, vs, attn_mask=same)),
        "bwd": profile_kernels(lambda: torch.autograd.grad(out, (qs, ks, vs), dout.transpose(1, 2),
                                                           retain_graph=True))}
    for kind, rows in result.items():
        log(f"  SDPA {dtype} {kind} by kernel: " + (
            ", ".join(f"{n} x{c} {ms:.4f} ms" for n, c, ms in rows)
            if isinstance(rows, list) else rows))
    return result


# ---------------------------------------------------------------------------
# fused subsampling
# ---------------------------------------------------------------------------


def subsample_inputs(S, B, T, F, C, dtype, seed=0):
    """x [B, T, F], the 10 f32 weights in the JAX layouts, g at the output."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(B, T, F, generator=g, device="cuda").to(dtype)
    shapes = {"k9": (9, C), "dw1": (9, C), "dw2": (9, C), "pw1": (C, C), "pw2": (C, C)}
    ws = []
    for name in S.WEIGHT_NAMES:
        scale = 1 / 3 if name in ("k9", "dw1", "dw2") else (C ** -0.5 if name.startswith("pw") else 0.1)
        ws.append(torch.randn(shapes.get(name, (C,)), generator=g, device="cuda") * scale)
    gout = torch.randn(B, S.ceil_chain(T)[2], F // 8, C, generator=g, device="cuda").to(dtype)
    return x, ws, gout


def check_subsample(S, shape, dtype, act="silu"):
    x, ws, gout = subsample_inputs(S, *shape, dtype)
    S.reset_counters()
    out = S.fused_subsample_fwd(x, ws, act)
    gx, gws = S.fused_subsample_bwd(x, ws, gout, act)
    gx2, gws2 = S.fused_subsample_bwd(x, ws, gout, act)
    route = S.ROUTES[dtype]
    if (S.route_launches[route] != [1, 2] or S.act_launches[act] != [1, 2]
            or S.gx_launches != 2):
        raise AssertionError(f"fused subsampling {dtype} {act}: launches by route "
                             f"{S.route_launches}, by activation {S.act_launches}, gx "
                             f"{S.gx_launches}; expected {route} and {act} only, gx 2")
    ref = S.fused_subsample_reference(x.float(), *ws, act_name=act)
    ref_gx, ref_gws = S.fused_subsample_reference_bwd(x.float(), ws, gout.float(), act, True)
    torch.cuda.synchronize()
    what = f"fused subsampling {dtype} {act} {shape}"
    if not (torch.equal(gx, gx2) and all(torch.equal(a, b) for a, b in zip(gws, gws2))):
        raise AssertionError(f"{what}: the backward does not repeat bit for bit")
    if act == "relu" and dtype == torch.bfloat16:
        errs = check_close(what, [("out", out, ref)], FWD_TOL[dtype])
        errs.update(check_subsample_relu_rounding(S, what, x, ws, gout, out, gx, gws))
        log(f"  {what} ({route}): out {errs['out']:.2e} of the plain version in f32; backward "
            f"repeats bit for bit")
        return errs
    errs = check_close(what, zip(("out", "gx") + S.WEIGHT_NAMES, [out, gx] + gws,
                                 [ref, ref_gx] + ref_gws), FWD_TOL[dtype])
    log(f"  {what} ({route}): out {errs['out']:.2e}, gx {errs['gx']:.2e}, "
        f"weights {max(errs[n] for n in S.WEIGHT_NAMES):.2e}; backward repeats bit for bit")
    if dtype == torch.bfloat16:
        check_subsample_rounding(S, what, x, ws, gout, out, gx, gws, act)
    return errs


def check_subsample_rounding(S, what, x, ws, gout, out, gx, gws, act="silu"):
    """The bf16 kernels against the plain version on the same bf16 tensors,
    which rounds where the TPU kernel (and so the kernels) round.  Every
    output within SUB_BF16_ULPS bf16 ulps of its max |plain|; the share of
    elements that differ at all within SUB_DIFF_SHARE for out and gx (the
    weight gradients are f32 sums taken in another order, so all of their
    elements differ a little)."""
    r_out = S.fused_subsample_reference(x, *ws, act_name=act)
    r_gx, r_gws = S.fused_subsample_reference_bwd(x, ws, gout, act, True)
    torch.cuda.synchronize()
    report, worst = [], 0.0
    for name, a, b in zip(("out", "gx") + S.WEIGHT_NAMES, [out, gx] + gws, [r_out, r_gx] + r_gws):
        ulps = (a.float() - b.float()).abs().max().item() / bf16_ulp(b.float().abs().max().item())
        worst = max(worst, ulps)
        if name in ("out", "gx"):
            share = (a != b.to(a.dtype)).float().mean().item()
            if not share <= SUB_DIFF_SHARE[name]:
                raise AssertionError(f"{what} against the rounding plain version: {name} {share:.4f} "
                                     f"of elements differ")
            report.append(f"{name} {ulps:.2f} ulp, {share:.4f} differ")
        if not ulps <= SUB_BF16_ULPS:
            raise AssertionError(f"{what} against the rounding plain version: {name} {ulps} ulps "
                                 f"of max")
    log(f"    against the plain version rounding as the kernels: {', '.join(report)}, "
        f"weights <= {worst:.2f} ulp")


def check_subsample_relu_rounding(S, what, x, ws, gout, out, gx, gws):
    """The bf16 kernels with ``relu`` against the plain version on the same
    bf16 tensors: out within SUB_BF16_ULPS bf16 ulps of its max and at most
    SUB_DIFF_SHARE["out"] of its elements differing; each weight gradient
    within FWD_TOL of its max; gx by RELU_GX (L2 error relative to the plain
    gx, share of elements beyond FWD_TOL of max) and at most
    SUB_DIFF_SHARE["gx"] of its elements differing.  Returns {name: max
    |err|} (out's against the plain version in f32 comes from the caller)."""
    r_out = S.fused_subsample_reference(x, *ws, act_name="relu")
    r_gx, r_gws = S.fused_subsample_reference_bwd(x, ws, gout, "relu", True)
    torch.cuda.synchronize()
    tol = FWD_TOL[torch.bfloat16]
    ulps = (out.float() - r_out.float()).abs().max().item() / bf16_ulp(
        r_out.float().abs().max().item())
    share = {"out": (out != r_out).float().mean().item(), "gx": (gx != r_gx).float().mean().item()}
    if not (ulps <= SUB_BF16_ULPS and share["out"] <= SUB_DIFF_SHARE["out"]):
        raise AssertionError(f"{what} against the rounding plain version: out {ulps:.2f} ulps, "
                             f"{share['out']:.4f} of elements differ")
    errs = check_close(what, zip(S.WEIGHT_NAMES, gws, [g.float() for g in r_gws]), tol)
    err = (gx.float() - r_gx.float()).abs()
    scale = r_gx.float().abs().max().item()
    rel_l2 = (err.norm() / r_gx.float().norm()).item()
    beyond = (err > tol * scale).float().mean().item()
    if not (rel_l2 <= RELU_GX["rel_l2"] and beyond <= RELU_GX["share"]
            and share["gx"] <= SUB_DIFF_SHARE["gx"]):
        raise AssertionError(f"{what} against the rounding plain version: gx relative L2 "
                             f"{rel_l2:.3e}, {beyond:.2e} of elements beyond {tol} of max, "
                             f"{share['gx']:.4f} differ")
    errs["gx"] = err.max().item()
    log(f"    against the plain version rounding as the kernels: out {ulps:.2f} ulp, "
        f"{share['out']:.4f} differ; weights <= {max(errs[n] for n in S.WEIGHT_NAMES):.2e}; gx "
        f"relative L2 {rel_l2:.2e}, {beyond:.2e} beyond {tol} of max (kinks), "
        f"{share['gx']:.4f} differ")
    return errs


def conv_weights(S, ws, dtype):
    """The fused kernel's weights as the ``"conv"`` path's conv2d weights."""
    k9, b0, dw1, bdw1, pw1, bpw1, dw2, bdw2, pw2, bpw2 = ws
    C = k9.shape[1]
    out = [k9.t().reshape(C, 1, 3, 3), b0]
    for dw, bdw, pw, bpw in ((dw1, bdw1, pw1, bpw1), (dw2, bdw2, pw2, bpw2)):
        out += [dw.t().reshape(C, 1, 3, 3), bdw, pw.t()[:, :, None, None], bpw]
    return [w.to(dtype).detach().requires_grad_(True) for w in out]


def conv_stack(x, w):
    """The cuDNN stack of the ``"conv"`` path, without its masks: x [B, T, F]
    → [B, C, T/8, F/8]."""
    import torch.nn.functional as F

    C = w[0].shape[0]
    h = F.silu(F.conv2d(x[:, None], w[0], w[1], stride=2, padding=1))
    for i in (2, 6):
        h = F.conv2d(h, w[i], w[i + 1], stride=2, padding=1, groups=C)
        h = F.silu(F.conv2d(h, w[i + 2], w[i + 3]))
    return h


def subsample_work(B, T, F, C, dtype):
    """(flops, bytes, pointwise-product flops) of the forward, of the
    backward on the main path (no gx) and of the backward with gx (the
    entropy pass): stage 0, both depthwise convs and both pointwise
    products; the backward recomputes the forward and adds the input and
    weight gradients of each but stage 0's input gradient, which gx adds
    (as many operations as stage 0, and gx written once)."""
    from dynamic_asr_eval_tpu_torch.kernels.subsample import ceil_chain

    T0, T1, T2 = ceil_chain(T)
    M0, M1, M2 = B * T0 * F // 2, B * T1 * F // 4, B * T2 * F // 8
    stage0, dw, pw = 18 * M0 * C, 18 * (M1 + M2) * C, 2 * (M1 + M2) * C * C
    esize = torch.finfo(dtype).bits // 8
    weights = (32 * C + 2 * C * C) * 4
    x_bytes, out_bytes = B * T * F * esize, M2 * C * esize
    fwd = stage0 + dw + pw
    bwd = fwd + 2 * pw + 2 * dw + stage0
    return {"fwd": (fwd, x_bytes + out_bytes + weights, pw),
            "bwd": (bwd, x_bytes + out_bytes + 2 * weights, 3 * pw),
            "bwd_gx": (bwd + stage0, 2 * x_bytes + out_bytes + 2 * weights, 3 * pw)}


def tf32x3_bound(flops, products, nbytes):
    """(least ms, "operations" or "bytes") of work whose ``products`` flops
    run as three TF32 products on the tensor cores and the rest on the CUDA
    cores in f32."""
    t_ops = (3 * products / TF32_FLOPS + (flops - products) / F32_FLOPS) * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def time_subsample(S, dtype=torch.bfloat16):
    x, ws, gout = subsample_inputs(S, *SUB_FLAGSHIP, dtype, seed=1)
    lw = conv_weights(S, ws, dtype)
    lib_out = conv_stack(x, lw)
    g_nchw = gout.permute(0, 3, 1, 2).contiguous()
    xg = x.detach().requires_grad_(True)
    lib_out_gx = conv_stack(xg, lw)
    t = {
        "fwd": cuda_ms(lambda: S.fused_subsample_fwd(x, ws)),
        "bwd": cuda_ms(lambda: S.fused_subsample_bwd(x, ws, gout, need_gx=False)),
        "fwd_plain": cuda_ms(lambda: S.fused_subsample_reference(x, *ws), iters=5),
        "bwd_plain": cuda_ms(lambda: S.fused_subsample_reference_bwd(x, ws, gout, "silu", False), iters=5),
        "fwd_library": cuda_ms(lambda: conv_stack(x, lw)),
        "bwd_library": cuda_ms(lambda: torch.autograd.grad(lib_out, lw, g_nchw, retain_graph=True)),
        "fwd_bwd_library": cuda_ms(lambda: torch.autograd.grad(conv_stack(x, lw), lw, g_nchw)),
        # the entropy pass's backward (with gx) and the NeMo preset's relu
        "bwd_gx": cuda_ms(lambda: S.fused_subsample_bwd(x, ws, gout, need_gx=True)),
        "bwd_gx_plain": cuda_ms(lambda: S.fused_subsample_reference_bwd(x, ws, gout, "silu", True),
                                iters=5),
        "bwd_gx_library": cuda_ms(lambda: torch.autograd.grad(lib_out_gx, [xg] + lw, g_nchw,
                                                              retain_graph=True)),
        "fwd_relu": cuda_ms(lambda: S.fused_subsample_fwd(x, ws, "relu")),
    }
    work = subsample_work(*SUB_FLAGSHIP, dtype)
    if dtype == torch.float32:
        # the f32 kernels take each pointwise product as three TF32 products
        # on the tensor cores; the same work all on the CUDA cores is bounded too
        bounds = {k: tf32x3_bound(f, p, b) for k, (f, b, p) in work.items()}
        bounds.update({f"{k}_cuda_core": bound(f, b, F32_FLOPS) for k, (f, b, _) in work.items()})
    else:
        bounds = {k: bound(f, b, PEAK_FLOPS[dtype]) for k, (f, b, _) in work.items()}
    return t, bounds


def subsample_breakdown(S, card):
    """One forward and one backward call of each route (bf16 and f32) at the
    flagship window (no gx, as on the main path) under torch.profiler: device
    ms and launches of each kernel inside them (a ``{"subsample_breakdown":
    ...}`` line, keyed by route)."""
    from dynamic_asr_eval_tpu_torch.perf import profile_kernels

    result = {"card": card, "shape": SUB_FLAGSHIP}
    for dtype in (torch.bfloat16, torch.float32):
        x, ws, gout = subsample_inputs(S, *SUB_FLAGSHIP, dtype, seed=1)
        route = S.ROUTES[dtype]
        result[route] = {
            "fwd": profile_kernels(lambda: S.fused_subsample_fwd(x, ws)),
            "bwd": profile_kernels(lambda: S.fused_subsample_bwd(x, ws, gout, need_gx=False))}
        for kind, rows in result[route].items():
            log(f"  fused subsampling {dtype} ({route}) {kind} by kernel: " + (
                ", ".join(f"{n} x{c} {ms:.4f} ms" for n, c, ms in rows)
                if isinstance(rows, list) else rows))
    print(json.dumps({"subsample_breakdown": result}))


# ---------------------------------------------------------------------------
# soft-DTW
# ---------------------------------------------------------------------------


def softdtw_inputs(D, shape, bandwidth, seed=0):
    """Squared distances of standard-normal 64-dim features, band applied."""
    B, N, M = shape
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(B, N, 64, generator=g, device="cuda")
    y = torch.randn(B, M, 64, generator=g, device="cuda")
    return D._apply_band(D.pairwise_sq_dist(x, y), bandwidth)


def check_softdtw(D, shape, bandwidth, gamma=1.0, Db=None, what="soft-DTW"):
    """Both kernels against the plain version at ``shape``, on ``Db`` (band
    applied) or on :func:`softdtw_inputs`: R within 1e-4 relative (to
    max(|R|, 1)), E (from the kernel's R) within 1e-4 of max |E|, each
    kernel repeating bit for bit."""
    if Db is None:
        Db = softdtw_inputs(D, shape, bandwidth)
    R = D.softdtw_R(Db, gamma)
    E = D.softdtw_E(Db, R, gamma)
    R2, E2 = D.softdtw_R(Db, gamma), D.softdtw_E(Db, R, gamma)
    ref_R = D.forward_R_reference(Db, gamma)
    ref_E = D.backward_E_reference(Db, R, gamma)  # E's inputs: the same D and R
    torch.cuda.synchronize()
    what = f"{what} {shape} bandwidth {bandwidth}"
    if not (torch.equal(R, R2) and torch.equal(E, E2)):
        raise AssertionError(f"{what}: the kernels do not repeat bit for bit")
    r_err = ((R - ref_R).abs() / ref_R.abs().clamp_min(1.0)).max().item()
    e_err = (E - ref_E).abs().max().item()
    e_scale = ref_E.abs().max().item()
    if not (r_err <= 1e-4 and torch.isfinite(E).all() and e_err <= 1e-4 * e_scale):
        raise AssertionError(f"{what}: R rel err {r_err:.3e}, E err {e_err:.3e} of max "
                             f"{e_scale:.3e}")
    log(f"  {what}: R rel {r_err:.2e}, E {e_err:.2e} (max |E| {e_scale:.3e}, loss "
        f"{R[0, shape[1], shape[2]].item():.6g}); both repeat bit for bit")
    return {"R": (R - ref_R).abs().max().item(), "E": e_err, "R_rel": r_err, "E_max": e_scale,
            "value": R[:, shape[1], shape[2]].tolist()}


def softdtw_work(B, N, M):
    """(ops, bytes): ~15 f32 operations a cell forward (3 divisions, 3 exp,
    a log, max, adds), ~17 backward; D read and R written once forward; D
    and R read and E written once backward."""
    cells, padded = B * N * M, B * (N + 2) * (M + 2)
    return {"fwd": (15 * cells, 4 * (cells + padded)),
            "bwd": (17 * cells, 4 * (2 * cells + padded))}


def softdtw_kernel_ms(D, shape, gamma=1.0, iters=20):
    """(forward ms, whole backward call ms) of the kernels at ``shape``."""
    Db = softdtw_inputs(D, shape, 0, seed=1)
    R = D.softdtw_R(Db, gamma)
    return (cuda_ms(lambda: D.softdtw_R(Db, gamma), iters=iters),
            cuda_ms(lambda: D.softdtw_E(Db, R, gamma), iters=iters))


def softdtw_constant(D, name):
    """A ``constexpr int`` of the kernels' source."""
    return int(re.search(rf"constexpr int {name} = (\d+);", D.SOURCE.read_text()).group(1))


def softdtw_chain(D, card, shapes):
    """The chain floor of each shape: its N + M - 1 steps at the latency of
    one step's dependent chain (``kernels.softdtw.chain_step``: the kernels'
    own step run alone by one warp, in SM cycles, at the clock it ran at).
    Beside it, and not a bound, the kernels' own time a step on a single
    strip (SDTW_STRIP: one warp, no strip above to wait on), which adds what
    a step carries besides its chain: loads, stores and ring traffic."""
    D.chain_step()  # the card's clock up
    chain = {k: D.chain_step(backward=k == "bwd") for k in ("fwd", "bwd")}
    floors = {f"{s}": {k: (s[1] + s[2] - 1) * v["ns"] * 1e-6 for k, v in chain.items()}
              for s in shapes}
    # the steps the kernels take on the strip: a panel of P columns takes
    # P + 31 (lane 31 starts 31 steps after lane 0), rounded up to whole chunks
    B, N, M = SDTW_STRIP
    panel, chunk = (softdtw_constant(D, name) for name in ("PANEL", "CHUNK"))
    P = min(panel, M)
    steps = -(-M // P) * -(-(P + 31) // chunk) * chunk
    fwd_ms, bwd_ms = softdtw_kernel_ms(D, SDTW_STRIP, iters=200)
    strip_ns = {"fwd": fwd_ms / steps * 1e6, "bwd": bwd_ms / steps * 1e6}
    result = {"card": card, "chain_step": chain, "floor_ms": floors,
              "single_strip": {"shape": SDTW_STRIP, "steps": steps, "fwd_ms": fwd_ms,
                               "bwd_ms": bwd_ms, "step_ns": strip_ns}}
    log(f"  soft-DTW chain: one step {chain['fwd']['cycles']:.1f} / {chain['bwd']['cycles']:.1f} "
        f"cycles forward / backward at {chain['fwd']['mhz']:.0f} / {chain['bwd']['mhz']:.0f} MHz "
        f"({chain['fwd']['ns']:.2f} / {chain['bwd']['ns']:.2f} ns); the kernels on a single "
        f"strip {SDTW_STRIP}: {strip_ns['fwd']:.2f} / {strip_ns['bwd']:.2f} ns a step")
    print(json.dumps({"softdtw_chain": result}))
    return floors


def time_softdtw(D, card, gamma=1.0):
    for shape in SDTW_UTTERANCE:
        fwd_ms, bwd_ms = softdtw_kernel_ms(D, shape, gamma)
        log(f"  softdtw at {shape}: fwd {fwd_ms:.4f} ms, bwd {bwd_ms:.4f} ms")
    floors = softdtw_chain(D, card, SDTW_UTTERANCE + (SDTW_BENCH,))
    Db = softdtw_inputs(D, SDTW_BENCH, 0, seed=1)
    R = D.softdtw_R(Db, gamma)
    t = {
        "fwd": cuda_ms(lambda: D.softdtw_R(Db, gamma)),
        "bwd": cuda_ms(lambda: D.softdtw_E(Db, R, gamma)),
        "fwd_plain": cuda_ms(lambda: D.forward_R_reference(Db, gamma), iters=3, warmup=1),
        "bwd_plain": cuda_ms(lambda: D.backward_E_reference(Db, R, gamma), iters=3, warmup=1),
    }
    bounds = {k: bound(f, b, F32_FLOPS) for k, (f, b) in softdtw_work(*SDTW_BENCH).items()}
    bounds.update({f"{k}_chain": (v, "chain") for k, v in floors[f"{SDTW_BENCH}"].items()})
    return t, bounds


# ---------------------------------------------------------------------------
# the main path
# ---------------------------------------------------------------------------


class EngineRecorder:
    """Stands in for the engine that the driver builds: passes each call on
    with ``return_params=True`` and keeps the engine, the call's arguments
    and its output, so that the checks read the driver's own run."""

    def __init__(self):
        self.engine = None
        self.calls = []
        self.outputs = []

    def wrap(self, build_engine):
        def build(*args, **kwargs):
            self.engine = build_engine(*args, **kwargs)
            return self
        return build

    def __call__(self, params, spec, *args, **kwargs):
        out = self.engine(params, spec, *args, return_params=True, **kwargs)
        self.calls.append((params, spec))
        self.outputs.append(out)
        return out

    def batched(self, params, specs, *args, **kwargs):
        """``--dp_records``' call: each record's call and output kept."""
        outs = self.engine.batched(params, specs, *args, return_params=True, **kwargs)
        self.calls += [(params, spec) for spec in specs]
        self.outputs += outs
        return outs

    def __getattr__(self, name):  # the engine's mesh, config, window_count
        if name == "engine":
            raise AttributeError(name)
        return getattr(self.engine, name)


def counted(modules, fn):
    """``fn()`` with every count at 0 before it; (its result, {module: (fwd,
    bwd)}, {module: {route: (fwd, bwd)}}), read after the card is done."""
    for mod in modules.values():
        mod.reset_counters()
    out = fn()
    torch.cuda.synchronize()
    launches = {k: (m.fwd_launches, m.bwd_launches) for k, m in modules.items()}
    routes = {k: {r: tuple(c) for r, c in m.route_launches.items()}
              for k, m in modules.items() if hasattr(m, "route_launches")}
    return out, launches, routes


def main_path(cfg, kernel_modules, driver=None, flags=(), kwargs=(), frames=N_FRAMES):
    """A driver (default ``evals.run``) on a ``frames``-frame recording (the
    flagship one by default), its ``main`` given ``cfg`` (None: the
    configuration comes from ``flags``, e.g. ``--checkpoint``) and
    ``kwargs`` added to ``RUN_KWARGS``; returns (wer, wall, {module: (fwd,
    bwd) launches}, {module: {route: (fwd, bwd)}}, result detail,
    recorder)."""
    import pickle

    if driver is None:
        from dynamic_asr_eval_tpu_torch.evals import run as driver

    os.environ["DAE_SYNTH_SPEC_FRAMES"] = str(frames)
    recorder = EngineRecorder()
    build_engine = driver.build_engine
    with tempfile.TemporaryDirectory() as tmp:
        args = driver.parse_args([
            "-d", "synthetic_spec", "--quiet", "-s", os.path.join(tmp, "r.pkl"),
            "-seq", str(SEQ), "-o", str(OVERLAP), *flags, *RUN_KWARGS, *kwargs])
        driver.build_engine = recorder.wrap(build_engine)
        try:
            t0 = time.time()
            wer, launches, routes = counted(kernel_modules,
                                            lambda: driver.main(args, model_config=cfg))
            wall = time.time() - t0
        finally:
            driver.build_engine = build_engine
        with open(os.path.join(tmp, "r_1.pkl"), "rb") as f:
            detail = pickle.load(f)
    return wer, wall, launches, routes, detail, recorder


def graph_offset(*engines) -> int:
    """The adapt steps' passes that the kernels' counters saw beyond one a
    window: two for each CUDA graph an NSTI engine captured (its warm-up
    and capture passes) less one for each window that replayed one (no
    wrapper runs); 0 for an engine without graphs."""
    graphs = [getattr(e, "graphs", None) for e in engines if e is not None]
    return sum(2 * g.captures - g.replays for g in graphs if g is not None)


def check_launches(launches, expect, windows=N_WINDOWS, exact=False, offset=0, graphed=None):
    """expect: {module: per-window (fwd, bwd)}; forward >= (``exact``: ==)
    and backward == that count times the windows, plus ``graphed`` (the part
    of ``expect`` the adapt step's model passes launch; default all of it)
    times ``offset`` (:func:`graph_offset`)."""
    graphed = expect if graphed is None else graphed
    for name, (fwd_per, bwd_per) in expect.items():
        fwd, bwd = launches[name]
        g_fwd, g_bwd = graphed.get(name, (0, 0))
        want_fwd, want_bwd = fwd_per * windows + g_fwd * offset, bwd_per * windows + g_bwd * offset
        if not ((fwd == want_fwd if exact else fwd >= want_fwd) and bwd == want_bwd):
            raise AssertionError(f"{name} launches fwd {fwd}, bwd {bwd}; expected "
                                 f"{'==' if exact else '>='} {want_fwd} and == {want_bwd}")


def bf16_only(by_route, expect) -> bool:
    """All of ``expect`` launches on the bf16 route (``"tensor_core"``), none
    on any other."""
    return "tensor_core" in by_route and all(
        tuple(c) == (tuple(expect) if r == "tensor_core" else (0, 0)) for r, c in by_route.items())


def check_routes(what, launches, routes):
    """Every launch of each routed module on the bf16 tensor-core kernels."""
    for name, by_route in routes.items():
        if not bf16_only(by_route, launches[name]):
            raise AssertionError(f"{what}: {name} launches by route {by_route}: not all on the "
                                 f"bf16 tensor-core kernels")


def weight_change(adapted, params):
    """Largest change of any weight; ``adapted`` is a state dict or, from
    the consistency engine, one per chunk (the smallest chunk's largest)."""
    if isinstance(adapted, list):
        return min(weight_change(chunk, params) for chunk in adapted)
    return max((adapted[k].float() - params[k].float()).abs().max().item() for k in params)


def check_driver_output(cfg, wer, detail, recorder, frames=N_FRAMES):
    """The driver's own run: stitched log-probs finite with the expected
    shape, weights that moved (every chunk's, for the consistency engine)."""
    if len(detail["model_output"]) != 1 or not math.isfinite(wer):
        raise AssertionError(f"driver result malformed: wer {wer}, {detail.get('model_output')}")
    if len(recorder.outputs) != 1:
        raise AssertionError(f"the driver made {len(recorder.outputs)} engine calls, not 1")
    (out,), ((params, _),) = recorder.outputs, recorder.calls
    lp = out.numpy_logits()
    expect = (-(-frames // cfg.subsampling_factor), cfg.n_classes)
    if lp.shape != expect:
        raise AssertionError(f"stitched log-probs {lp.shape} != {expect}")
    if not torch.isfinite(torch.from_numpy(lp)).all():
        raise AssertionError("non-finite stitched log-probs")
    moved = weight_change(out.params, params)
    if not moved > 0:
        raise AssertionError("adaptation did not move the weights")
    log(f"  driver's engine run: stitched {lp.shape}, finite; max weight change {moved:.3e}")
    return params


def valid_frame_err(a, b):
    err = 0.0
    for i, n in enumerate(a["length"].tolist()):
        err = max(err, (a["final_posteriors"][i, :n] - b["final_posteriors"][i, :n]).abs().max().item())
    return err


def f32_model(params, **overrides):
    from dynamic_asr_eval_tpu_torch.models import SCConformer

    model = SCConformer(flagship_config(**{**overrides, "compute_dtype": torch.float32})).cuda()
    model.load_state_dict({k: v.float() for k, v in params.items()})
    return model


def model_run(model, x, lengths):
    """The model's output and the weight gradients of its valid frames'
    summed log-probs."""
    out = model(x, lengths)
    logp = out["final_posteriors"]
    valid = torch.arange(logp.shape[1], device="cuda")[None] < out["length"][:, None]
    loss = (logp * valid[..., None]).sum()
    names, weights = zip(*model.named_parameters())
    grads = torch.autograd.grad(loss, weights, allow_unused=True)
    return out, {n: g for n, g in zip(names, grads) if g is not None}


def grad_err(grads_a, grads_b):
    """Largest difference of two gradient sets, each weight against its own
    max |value| (or 1 % of the largest where that is more)."""
    top = {n: g.abs().max().item() for n, g in grads_b.items()}
    floor = 1e-2 * max(top.values())  # a weight whose gradient is ~0 on both paths
    return max((grads_a[n] - grads_b[n]).abs().max().item() / max(top[n], floor) for n in grads_b)


def check_attention_model(params, A):
    """The full-depth model in f32 on a small input: kernel path against the
    plain attention path, output on valid frames and weight gradients of the
    valid frames' summed log-probs.  Returns the f32 route's (fwd, bwd)
    launches in the kernel-path run (its parity launches)."""
    from dynamic_asr_eval_tpu_torch.device import deterministic_cudnn

    g = torch.Generator(device="cuda").manual_seed(3)
    x = torch.randn(2, 80, 4000, generator=g, device="cuda")
    lengths = torch.tensor([4000, 3001], device="cuda")
    route = A.ROUTES[torch.float32]
    A.reset_counters()
    with deterministic_cudnn():
        a, grads_a = model_run(f32_model(params), x, lengths)
        torch.cuda.synchronize()
        launches = tuple(A.route_launches[route])
        b, grads_b = model_run(f32_model(params, attention_impl="xla"), x, lengths)
    err = valid_frame_err(a, b)
    gerr = grad_err(grads_a, grads_b)
    if not (err <= 1e-3 and gerr <= 1e-3 and launches[0] > 0 and launches[1] > 0):
        raise AssertionError(f"kernel-path model vs plain path: output |err| {err:.3e}, weight "
                             f"gradients {gerr:.3e} of max (> 1e-3?), f32 launches {launches}")
    log(f"  full-depth f32 model, kernel vs plain attention on valid frames: {err:.2e}; weight "
        f"gradients {gerr:.2e} of max; f32 ({route}) launches fwd {launches[0]}, "
        f"bwd {launches[1]}")
    return launches


def check_subsample_model(params, S):
    """The full-depth f32 model with ``"pallas"`` subsampling: through the
    kernels (the f32 route), against the same model on the plain subsampling
    version (output on valid frames and weight gradients of the valid frames'
    summed log-probs) and against the ``"conv"`` model (output), at lengths
    that are multiples of 8.  Returns the f32 route's (fwd, bwd) launches
    (its parity launches)."""
    import dynamic_asr_eval_tpu_torch.models.conformer as conformer
    from dynamic_asr_eval_tpu_torch.device import deterministic_cudnn

    g = torch.Generator(device="cuda").manual_seed(4)
    x = torch.randn(2, 80, 4000, generator=g, device="cuda")
    lengths = torch.tensor([4000, 3000], device="cuda")
    model = f32_model(params, subsampling_impl="pallas")
    route = S.ROUTES[torch.float32]
    S.reset_counters()
    with deterministic_cudnn():
        a, grads_a = model_run(model, x, lengths)
        torch.cuda.synchronize()
        launches = tuple(S.route_launches[route])
        kernel_entry = conformer.fused_subsample
        conformer.fused_subsample = S.fused_subsample_reference
        try:
            b, grads_b = model_run(model, x, lengths)
        finally:
            conformer.fused_subsample = kernel_entry
        with torch.no_grad():
            c = f32_model(params)(x, lengths)
    err_plain, err_conv = valid_frame_err(a, b), valid_frame_err(a, c)
    gerr = grad_err(grads_a, grads_b)
    if not (err_plain <= 1e-3 and err_conv <= 1e-3 and gerr <= 1e-3 and launches == (1, 1)):
        raise AssertionError(f"pallas model: vs plain subsampling {err_plain:.3e} (weight gradients "
                             f"{gerr:.3e} of max), vs conv model {err_conv:.3e} (> 1e-3?); f32 "
                             f"launches {launches}")
    log(f"  full-depth f32 model, subsampling kernels vs plain version {err_plain:.2e} (weight "
        f"gradients {gerr:.2e} of max), vs the conv model {err_conv:.2e} on valid frames; f32 "
        f"({route}) launches fwd {launches[0]}, bwd {launches[1]}")
    return launches


def check_checkpoints(tmp, device="cuda"):
    """Phase 9: the flagship's seed-0 weights through a DAE1 file and a
    reference torch pickle; returns the DAE1 file's path."""
    import dataclasses

    from dynamic_asr_eval_tpu_torch.models import init_conformer
    from dynamic_asr_eval_tpu_torch.models.checkpoint import load_any_checkpoint, save_checkpoint

    cfg = flagship_config(subsampling_impl="pallas")
    state = init_conformer(cfg, seed=0).state_dict()
    dae, ref = os.path.join(tmp, "flagship.dae"), os.path.join(tmp, "flagship.pt")
    t0 = time.time()
    save_checkpoint(dae, state, cfg)
    t1 = time.time()
    _, dae_state, dae_cfg = load_any_checkpoint(dae)
    t2 = time.time()
    model_cfg = {k: getattr(cfg, k) for k in REFERENCE_FIELDS}
    torch.save({"model": state, "config": {"model": model_cfg}}, ref)
    _, ref_state, ref_cfg = load_any_checkpoint(ref)
    for what, loaded in (("DAE1", dae_state), ("reference pickle", ref_state)):
        if loaded.keys() != state.keys() or not all(torch.equal(loaded[k], v)
                                                    for k, v in state.items()):
            raise AssertionError(f"{what} checkpoint: the reloaded state dict differs")
    if dataclasses.asdict(dae_cfg) != dataclasses.asdict(cfg):
        raise AssertionError(f"DAE1 checkpoint: config {dae_cfg} != {cfg}")
    if any(getattr(ref_cfg, k) != v for k, v in model_cfg.items()):
        raise AssertionError(f"reference pickle: config {ref_cfg} lost a field of {model_cfg}")
    log(f"  DAE1 {os.path.getsize(dae) / 1e6:.1f} MB: saved in {t1 - t0:.2f} s, reloaded in "
        f"{t2 - t1:.2f} s, {len(state)} tensors bit for bit, config field for field; reference "
        f"pickle reloaded bit for bit (its config names no kernel: attention "
        f"{ref_cfg.attention_impl!r}, subsampling {ref_cfg.subsampling_impl!r})")
    check_batch_renorm_reference(tmp, model_cfg, device)
    return dae


def check_batch_renorm_reference(tmp, model_cfg, device="cuda"):
    """Phase 9, batch renorm: the flagship with batch-renorm mid-norms and
    moved running statistics (mean ~ N(0, 0.1), var ~ U(0.5, 2)) as a
    reference pickle whose config names no norm: reloaded as batch renorm,
    bit for bit, and on the card its log-probs are the in-memory model's."""
    from dynamic_asr_eval_tpu_torch.models import ConformerConfig, init_conformer
    from dynamic_asr_eval_tpu_torch.models.checkpoint import load_any_checkpoint

    cfg = ConformerConfig(default_norm="batch_renorm", **model_cfg)
    model = init_conformer(cfg, seed=0)
    g = torch.Generator().manual_seed(9)
    with torch.no_grad():
        for layer in model.layers:
            norm = layer.conv.norm_mid
            norm.running_mean.copy_(0.1 * torch.randn(norm.running_mean.shape, generator=g))
            norm.running_var.copy_(0.5 + 1.5 * torch.rand(norm.running_var.shape, generator=g))
    path = os.path.join(tmp, "flagship_batch_renorm.pt")
    torch.save({"model": model.state_dict(), "config": {"model": model_cfg}}, path)
    loaded, state, loaded_cfg = load_any_checkpoint(path)
    if loaded_cfg != cfg or state.keys() != model.state_dict().keys() or not all(
            torch.equal(state[k], v) for k, v in model.state_dict().items()):
        raise AssertionError(f"batch-renorm reference pickle: config {loaded_cfg} or weights "
                             f"differ from the in-memory model's")
    x = torch.randn(1, cfg.feat_in, 4000, generator=g).to(device)
    lengths = torch.tensor([3001], device=device)
    with torch.no_grad():
        a, b = loaded.to(device)(x, lengths), model.to(device)(x, lengths)
    err = valid_frame_err(a, b)
    if not (err <= 1e-3 and torch.isfinite(a["final_posteriors"]).all()):
        raise AssertionError(f"batch-renorm reference pickle: log-probs {err:.3e} from the "
                             f"in-memory model's")
    log(f"  batch-renorm reference pickle: default_norm {loaded_cfg.default_norm!r} from the "
        f"running statistics, {len(state)} tensors bit for bit; log-probs on the card "
        f"{err:.2e} from the in-memory model's")


def check_awmc_run(cfg, launches, routes, wer, detail, recorder):
    """Phase 10's checks: exact per-window launches, all on the bf16 route;
    the driver's own output."""
    per_window = {"attention": (4 * cfg.n_layers, cfg.n_layers), "subsample": (4, 1)}
    for name, (fwd, bwd) in per_window.items():
        expect = (fwd * N_WINDOWS, bwd * N_WINDOWS)
        if launches[name] != expect:
            raise AssertionError(f"AWMC {name} launches {launches[name]}, expected {expect} "
                                 f"(anchor, leader, student and clean forwards, one backward)")
        if not bf16_only(routes[name], expect):
            raise AssertionError(f"AWMC {name} launches by route {routes[name]}: not all on "
                                 f"the bf16 tensor-core kernels")
    return check_driver_output(cfg, wer, detail, recorder)


def f32_route_launches(what, A, S):
    """{module: (fwd, bwd)} launches of the attention's and the subsampling's
    f32 routes since the counters were zeroed; raises if a bf16 kernel ran."""
    if A.route_launches["tensor_core"] != [0, 0] or S.route_launches["tensor_core"] != [0, 0]:
        raise AssertionError(f"{what} launched a bf16 kernel")
    return {"attention": tuple(A.route_launches[A.ROUTES[torch.float32]]),
            "subsample": tuple(S.route_launches[S.ROUTES[torch.float32]])}


def check_awmc_parity(params, A, S):
    """Phase 10b: the full-depth f32 AWMC engine through the f32 kernels
    against the same engine on the plain path; returns the f32 route's
    launches {module: (fwd, bwd)}."""
    import numpy as np

    from dynamic_asr_eval_tpu_torch.config import TTAConfig
    from dynamic_asr_eval_tpu_torch.device import deterministic_cudnn
    from dynamic_asr_eval_tpu_torch.tta import AWMCEngine

    frames, seq, overlap = AWMC_PARITY
    spec = np.random.default_rng(5).standard_normal((80, frames)).astype(np.float32)
    tta = TTAConfig(seq_len=seq, overlap=overlap, epochs=1, online=True, shuffle=False,
                    lm_tta_beams=0, optim_args={"lr": 9e-5})

    def run(**overrides):
        model = f32_model(params, **overrides)
        out = AWMCEngine(model, model.config.blank_id, 8, tta, device="cuda")(
            None, spec, seq, overlap, rng=0)
        torch.cuda.synchronize()
        return out

    A.reset_counters()
    S.reset_counters()
    with deterministic_cudnn():
        a = run(subsampling_impl="pallas")
        launches = f32_route_launches("the f32 AWMC engine", A, S)
        b = run(attention_impl="xla")
    lp_a, lp_b = a.numpy_logits(), b.numpy_logits()
    err, scale = float(np.abs(lp_a - lp_b).max()), float(np.abs(lp_b).max())
    same_ids = np.array_equal(a.greedy_ids(), b.greedy_ids())
    if not (lp_a.shape == lp_b.shape and err <= 1e-3 * scale and same_ids
            and min(min(v) for v in launches.values()) > 0):
        raise AssertionError(f"f32 AWMC, kernels vs plain path: {err:.3e} (max |log-prob| "
                             f"{scale:.3e}), greedy ids equal {same_ids}, f32 launches {launches}")
    log(f"  full-depth f32 AWMC engine, kernels vs plain path on {lp_a.shape[0]} frames: "
        f"{err:.2e} (max |log-prob| {scale:.3e}); greedy ids equal; f32 launches {launches} "
        f"(attention {A.ROUTES[torch.float32]}, subsampling {S.ROUTES[torch.float32]})")
    return launches


def check_consistency_run(cfg, launches, routes, wer, detail, recorder):
    """Phase 15's checks: per chunk, one forward (augmented and clean in one
    batch) and one backward each epoch, then the offline re-inference's
    forward; all on the bf16 route; the driver's own output, every chunk's
    weights moved."""
    epochs = max(recorder.engine.config.epochs, 1)
    per_chunk = {"attention": ((epochs + 1) * cfg.n_layers, epochs * cfg.n_layers),
                 "subsample": (epochs + 1, epochs)}
    for name, (fwd, bwd) in per_chunk.items():
        expect = (fwd * N_WINDOWS, bwd * N_WINDOWS)
        if launches[name] != expect:
            raise AssertionError(f"consistency {name} launches {launches[name]}, expected "
                                 f"{expect} (per chunk and epoch one forward and one backward, "
                                 f"then the re-inference)")
    check_routes("consistency path", launches, routes)
    if len(recorder.outputs[0].params) != N_WINDOWS:
        raise AssertionError(f"{len(recorder.outputs[0].params)} chunks' weights returned, "
                             f"not {N_WINDOWS}")
    return check_driver_output(cfg, wer, detail, recorder)


def check_consistency_parity(A, S):
    """Phase 15, parity: a CONSISTENCY_PARITY_LAYERS-layer f32 consistency
    engine at flagship widths (seeded weights), offline, 2 epochs, through
    the f32 kernels against the same engine on the plain path; returns the
    f32 route's launches {module: (fwd, bwd)}."""
    import numpy as np

    from dynamic_asr_eval_tpu_torch.config import TTAConfig
    from dynamic_asr_eval_tpu_torch.device import deterministic_cudnn
    from dynamic_asr_eval_tpu_torch.models import init_conformer
    from dynamic_asr_eval_tpu_torch.tta import ConsistencyEngine

    frames, seq, overlap = AWMC_PARITY
    spec = np.random.default_rng(7).standard_normal((80, frames)).astype(np.float32)
    tta = TTAConfig(seq_len=seq, overlap=overlap, epochs=2, online=False, shuffle=False,
                    lm_tta_beams=0, optim_args={"lr": 9e-5})
    state = init_conformer(flagship_config(n_layers=CONSISTENCY_PARITY_LAYERS), seed=6).state_dict()

    def run(**overrides):
        model = f32_model(state, n_layers=CONSISTENCY_PARITY_LAYERS, **overrides)
        out = ConsistencyEngine(model, model.config.blank_id, 8, tta, device="cuda")(
            None, spec, seq, overlap, rng=0)
        torch.cuda.synchronize()
        return out

    A.reset_counters()
    S.reset_counters()
    with deterministic_cudnn():
        a = run(subsampling_impl="pallas")
        launches = f32_route_launches("the f32 consistency engine", A, S)
        b = run(attention_impl="xla")
    lp_a, lp_b = a.numpy_logits(), b.numpy_logits()
    err, scale = float(np.abs(lp_a - lp_b).max()), float(np.abs(lp_b).max())
    same_ids = np.array_equal(a.greedy_ids(), b.greedy_ids())
    if not (lp_a.shape == lp_b.shape and err <= 1e-3 * scale and same_ids
            and min(min(v) for v in launches.values()) > 0):
        raise AssertionError(f"f32 consistency, kernels vs plain path: {err:.3e} (max |log-prob| "
                             f"{scale:.3e}), greedy ids equal {same_ids}, f32 launches {launches}")
    log(f"  {CONSISTENCY_PARITY_LAYERS}-layer f32 consistency engine at flagship widths, kernels "
        f"vs plain path on {lp_a.shape[0]} frames: {err:.2e} (max |log-prob| {scale:.3e}); greedy "
        f"ids equal; f32 launches {launches}")
    return launches


# ---------------------------------------------------------------------------
# the protocol drivers (phases 16, 16b, 16c)
# ---------------------------------------------------------------------------


def n_windows(frames, seq=SEQ, overlap=OVERLAP) -> int:
    from dynamic_asr_eval_tpu_torch.ops.chunk import chunk_starts_and_lengths

    return len(chunk_starts_and_lengths(frames, seq, overlap)[0])


def n_forwards(windows, infer_batch) -> int:
    """The evaluation engine's forwards over ``windows``: ``infer_batch``
    windows a forward."""
    return -(-windows // infer_batch)


def engine_plan(frames, infer_batch, adapt_only=False):
    """(windows adapted, forwards) of one offline NSTI engine call with
    ``epochs=1``: one forward and one backward of the [augmented, clean]
    batch per window, then, unless ``adapt_only``, the re-inference of
    every window with the adapted weights."""
    windows = n_windows(frames)
    infer = 0 if adapt_only else n_forwards(windows, infer_batch)
    return windows, windows + infer


def half_concat_plan(frames, n_records, infer_batch):
    """Phase 16: the baseline evaluates every record; each fold adapts only
    on the concatenation of its half, then evaluates the other half."""
    per_record = n_windows(frames)
    plan = {"records": n_records, "adapted": 0, "evaluated": n_records * per_record,
            "forwards": n_records * n_forwards(per_record, infer_batch), "adapt_calls": 2,
            "eval_calls": 2 * n_records}
    for fold in (0, 1):
        n_adapt = n_records // 2 if fold == 0 else n_records - n_records // 2
        adapted, fwd = engine_plan(frames * n_adapt, infer_batch, adapt_only=True)
        plan["adapted"] += adapted
        plan["forwards"] += fwd + (n_records - n_adapt) * n_forwards(per_record, infer_batch)
        plan["evaluated"] += (n_records - n_adapt) * per_record
    return plan


def loo_plan(frames, loo_seq, loo_overlap, infer_batch):
    """Phase 16b: one adaptation per chunk that has an audio-disjoint
    partner, then windowed inference of each of its partners.  Offline, the
    adapting engine also re-infers its own chunk, whose output the driver
    drops (``discarded``: those windows)."""
    from dynamic_asr_eval_tpu_torch.ops.chunk import chunk_starts_and_lengths

    starts, lens = chunk_starts_and_lengths(frames, loo_seq, loo_overlap)
    valid = {i: [j for j in range(len(starts)) if starts[j] >= starts[i] + lens[i]
                 or starts[i] >= starts[j] + lens[j]] for i in range(len(starts))}
    usable = [i for i in valid if valid[i]]
    plan = {"n_chunks": len(starts), "usable": usable,
            "pairs": sum(len(v) for v in valid.values()), "adapted": 0, "evaluated": 0,
            "discarded": 0, "forwards": 0, "adapt_calls": len(usable),
            "eval_calls": sum(len(v) for v in valid.values())}
    for i in usable:
        adapted, fwd = engine_plan(lens[i], infer_batch)
        plan["adapted"] += adapted
        plan["forwards"] += fwd
        plan["discarded"] += adapted
        for j in valid[i]:
            plan["evaluated"] += n_windows(lens[j])
            plan["forwards"] += n_forwards(n_windows(lens[j]), infer_batch)
    return plan


def seq_plan(frames, nsti_seq, nsti_overlap, infer_batch):
    """Phase 16c: the full NSTI engine on each outer chunk."""
    from dynamic_asr_eval_tpu_torch.ops.chunk import chunk_starts_and_lengths

    _, lens = chunk_starts_and_lengths(frames, nsti_seq, nsti_overlap)
    plan = {"n_chunks": len(lens), "inner_windows": [n_windows(L) for L in lens], "adapted": 0,
            "evaluated": 0, "forwards": 0, "adapt_calls": len(lens), "eval_calls": 0}
    for L in lens:
        adapted, fwd = engine_plan(L, infer_batch)
        plan["adapted"] += adapted
        plan["forwards"] += fwd
        plan["evaluated"] += adapted  # the re-inference gives the output
    return plan


def plan_launches(plan, n_layers, offset=0):
    """{module: (fwd, bwd)}: one attention launch per layer and one
    subsampling launch per forward (a batch of windows) or backward, and
    ``offset`` (:func:`graph_offset`) more adapt-step passes of each."""
    fwd, bwd = plan["forwards"] + offset, plan["adapted"] + offset
    return {"attention": (n_layers * fwd, n_layers * bwd), "subsample": (fwd, bwd)}


def check_protocol_launches(what, launches, routes, expect):
    """Exactly ``expect`` launches of each module, all on the bf16 route."""
    for name, want in expect.items():
        if tuple(launches[name]) != tuple(want):
            raise AssertionError(f"{what}: {name} launches {launches[name]}, expected {want}")
        if name in routes and not bf16_only(routes[name], want):
            raise AssertionError(f"{what}: {name} launches by route {routes[name]}: not all on "
                                 f"the bf16 tensor-core kernels")


class CallLog:
    """Stands in for an engine that a protocol driver builds: passes each
    call on unchanged, synchronizes the card around it and keeps (params,
    frames, keyword arguments, output, seconds); every other attribute is
    the engine's.  The engine's windowed inference (an adapting engine's
    offline re-inference) is timed apart, into ``infer_seconds``."""

    def __init__(self, engine, run):
        self.engine, self.run, self.calls, self.infer_seconds = engine, run, [], []
        infer = engine._infer

        def timed_infer(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.time()
            out = infer(*args, **kwargs)
            torch.cuda.synchronize()
            self.infer_seconds.append(time.time() - t0)
            return out
        engine._infer = timed_infer

    def __getattr__(self, name):
        return getattr(self.engine, name)

    def __call__(self, params, spec, *args, **kwargs):
        if self.run.pristine is None:  # the driver's weights, before any call
            self.run.params = params
            self.run.pristine = {k: v.clone() for k, v in params.items()}
        torch.cuda.synchronize()
        t0 = time.time()
        out = self.engine(params, spec, *args, **kwargs)
        torch.cuda.synchronize()
        self.calls.append((params, spec.shape[-1], kwargs, out, time.time() - t0))
        return out


class ProtocolRun:
    """One run of a protocol driver's ``main`` with its engines logged and
    its ``core`` function's (``loo_eval``, ``seq_eval_one``) results kept."""

    def __init__(self, driver, core=None):
        self.driver, self.core = driver, core
        self.adapt = self.eval = None
        self.pristine = self.params = None
        self.core_results = []

    def patches(self):
        d = self.driver

        def wrap_build(build, slot):
            def built(*args, **kwargs):
                log = CallLog(build(*args, **kwargs), self)
                setattr(self, slot, log)
                return log
            return built

        out = {"build_engine": wrap_build(d.build_engine, "adapt")}
        if hasattr(d, "build_eval_engine"):
            out["build_eval_engine"] = wrap_build(d.build_eval_engine, "eval")
        if self.core is not None:
            core = getattr(d, self.core)

            def kept(*args, **kwargs):
                result = core(*args, **kwargs)
                self.core_results.append(result)
                return result
            out[self.core] = kept
        return out

    def __call__(self, cfg, frames, flags, kernel_modules, pickle_name):
        """Returns (the driver's return, wall seconds, {module: (fwd, bwd)},
        {module: {route: (fwd, bwd)}}, the result pickle); the counters are
        zeroed just before ``main`` and read just after."""
        import pickle

        os.environ["DAE_SYNTH_SPEC_FRAMES"] = ",".join(str(f) for f in frames)
        patches = self.patches()
        saved = {name: getattr(self.driver, name) for name in patches}
        with tempfile.TemporaryDirectory() as tmp:
            args = self.driver.parse_args([
                "-d", "synthetic_spec", "--quiet", "-s", os.path.join(tmp, "r.pkl"),
                "-seq", str(SEQ), "-o", str(OVERLAP), *flags, *PROTOCOL_KWARGS])
            for name, fn in patches.items():
                setattr(self.driver, name, fn)
            try:
                for mod in kernel_modules.values():
                    mod.reset_counters()
                t0 = time.time()
                result = self.driver.main(args, model_config=cfg)
                torch.cuda.synchronize()
                wall = time.time() - t0
                launches = {k: (m.fwd_launches, m.bwd_launches)
                            for k, m in kernel_modules.items()}
                routes = {k: {r: tuple(c) for r, c in m.route_launches.items()}
                          for k, m in kernel_modules.items() if hasattr(m, "route_launches")}
            finally:
                for name, fn in saved.items():
                    setattr(self.driver, name, fn)
            with open(os.path.join(tmp, pickle_name), "rb") as f:
                detail = pickle.load(f)
        return result, wall, launches, routes, detail

    def check_pristine(self, what):
        """The driver's weights are bit for bit what they were before its
        first engine call."""
        if not all(torch.equal(self.params[k], v) for k, v in self.pristine.items()):
            raise AssertionError(f"{what}: the pristine weights changed")

    def check_calls(self, what, plan):
        n = (len(self.adapt.calls), len(self.eval.calls) if self.eval else 0)
        if n != (plan["adapt_calls"], plan["eval_calls"]):
            raise AssertionError(f"{what}: {n[0]} adaptations and {n[1]} evaluations, expected "
                                 f"{plan['adapt_calls']} and {plan['eval_calls']}")


def finite_wers(what, wers):
    if not all(math.isfinite(w) for w in wers):
        raise AssertionError(f"{what}: WER not finite: {wers}")


def check_half_concat(run, result, detail, plan):
    """Phase 16: adapt-only folds (no stitched log-probs, weights moved,
    pristine weights unchanged), each fold's evaluations with that fold's
    weights, a pickle with 2 folds and a baseline, finite WERs."""
    run.check_calls("half-concat", plan)
    run.check_pristine("half-concat")
    folds = []
    for params, _, kwargs, out, _ in run.adapt.calls:
        if not (kwargs.get("adapt_only") and out.logits is None and out.counts is None):
            raise AssertionError(f"half-concat: an adaptation was not adapt-only: {kwargs}")
        moved = weight_change(out.params, run.pristine)
        if params is not run.params or not moved > 0:
            raise AssertionError(f"half-concat: a fold did not adapt from the pristine weights "
                                 f"(max change {moved})")
        folds.append(out.params)
    n = plan["records"]  # fold 0 adapts on the first n // 2 records and evaluates the rest
    want = [run.params] * n + [folds[0]] * (n - n // 2) + [folds[1]] * (n // 2)
    if [p is w for (p, *_), w in zip(run.eval.calls, want)] != [True] * len(want):
        raise AssertionError("half-concat: an evaluation ran with the wrong weights")
    if len(detail["folds"]) != 2 or detail["baseline"] is None:
        raise AssertionError(f"half-concat pickle: {sorted(detail)}, {len(detail['folds'])} folds")
    finite_wers("half-concat", [result, detail["baseline"]["wer"]]
                + [f["wer"] for f in detail["folds"]])
    return [weight_change(f, run.pristine) for f in folds]


def check_stitched(what, logits, frames, cfg):
    """Stitched log-probs of the whole recording: one row per downsampled
    frame (no gap dropped), finite."""
    expect = (-(-frames // cfg.subsampling_factor), cfg.n_classes)
    if logits.shape != expect or not torch.isfinite(torch.from_numpy(logits)).all():
        raise AssertionError(f"{what}: stitched log-probs {logits.shape} (expected {expect}), "
                             f"finite {bool(torch.isfinite(torch.from_numpy(logits)).all())}")


def check_loo(run, result, detail, plan, frames, cfg):
    """Phase 16b: ``loo_eval`` took the ``"loo"`` mode over every chunk, and
    its stitched coverage has no gap."""
    run.check_calls("LOO", plan)
    run.check_pristine("LOO")
    ((logits, meta),) = run.core_results
    if meta != {"n_chunks": plan["n_chunks"], "mode": "loo"}:
        raise AssertionError(f"LOO: loo_eval returned {meta}")
    check_stitched("LOO", logits, frames, cfg)
    finite_wers("LOO", [result, detail["wer"]])


def check_seq(run, result, detail, frames, cfg):
    """Phase 16c: the second-level stitch has the recording's downsampled
    length and finite values."""
    run.check_pristine("sequence scaling")
    (logits,) = run.core_results
    check_stitched("sequence scaling", logits, frames, cfg)
    finite_wers("sequence scaling", [result, detail["wer"]])


def protocol_phase(label, driver, card, kernel_modules, cfg, frames, flags, pickle_name, plan_fn,
                   check, core=None):
    """Runs a protocol driver twice (first and warm), zeroing and reading the
    launch counters around each run; checks each run's launches (exact, all
    bf16) and the first run's output; prints a ``{"protocols": ...}`` line
    and returns the first run's launches and routes."""
    name = driver.__name__.rsplit(".", 1)[-1]
    runs = []
    for attempt in ("first", "warm"):
        run = ProtocolRun(driver, core)
        result, wall, launches, routes, detail = run(cfg, frames, flags, kernel_modules,
                                                     pickle_name)
        plan = plan_fn(run.adapt.infer_batch)
        offset = graph_offset(run.adapt, run.eval)
        check_protocol_launches(f"{name} ({attempt})", launches, routes,
                                {**plan_launches(plan, cfg.n_layers, offset), "softdtw": (0, 0)})
        extra = check(run, result, detail, plan) if attempt == "first" else None
        runs.append((run, wall, launches, routes, result, extra))
    (first, first_wall, launches, routes, result, extra), (warm, warm_wall, *_) = runs
    adapt_s = [sum(c[-1] for c in r.adapt.calls) for r in (first, warm)]
    reinfer_s = [sum(r.adapt.infer_seconds) for r in (first, warm)]
    eval_s = [sum(c[-1] for c in r.eval.calls) if r.eval else 0.0 for r in (first, warm)]
    # adaptation only: the adapting engine's seconds less its re-inference
    per_window = [(a - i) * 1e3 / plan["adapted"] for a, i in zip(adapt_s, reinfer_s)]
    line = {"phase": label, "driver": name, "card": card, "frames": frames,
            "plan": plan, "windows_adapted": plan["adapted"],
            "windows_evaluated": plan["evaluated"], "forwards": plan["forwards"],
            "wall_s": {"first": first_wall, "warm": warm_wall},
            "adapt_engine_s": {"first": adapt_s[0], "warm": adapt_s[1]},
            "adapt_engine_reinfer_s": {"first": reinfer_s[0], "warm": reinfer_s[1]},
            "eval_engine_s": {"first": eval_s[0], "warm": eval_s[1]},
            "ms_per_adapted_window": {"first": per_window[0], "warm": per_window[1]},
            "wer": result, "launches": launches}
    if extra is not None:
        line["fold_weight_change"] = extra
    log(f"  {name}: {plan['adapted']} windows adapted, {plan['evaluated']} evaluated, "
        f"{plan['forwards']} forwards; wall first {first_wall:.3f} s, warm {warm_wall:.3f} s; "
        f"adaptation alone {per_window[1]:.2f} ms a window (warm; the adapting engine's "
        f"re-inference {reinfer_s[1]:.3f} s apart); launches {launches}, all bf16")
    print(json.dumps({"protocols": line}))
    return launches, routes


def protocol_phases(card, A, S, D):
    """Phases 16, 16b and 16c at the flagship widths, bf16, ``"pallas"``
    subsampling; returns each phase's first-run (launches, routes)."""
    from dynamic_asr_eval_tpu_torch.evals import (
        run_half_concat_eval,
        run_seq_eval,
        run_within_recording_loo_eval,
    )

    modules = {"attention": A, "subsample": S, "softdtw": D}
    cfg = flagship_config(subsampling_impl="pallas")
    log(f"[16] half-concat: evals.run_half_concat_eval.main -ao {OVERLAP} on {HALF_RECORDS} "
        f"{N_FRAMES}-frame recordings, flagship, bf16, subsampling_impl='pallas', offline, "
        f"on {card}")
    half = protocol_phase(
        "16", run_half_concat_eval, card, modules, cfg, [N_FRAMES] * HALF_RECORDS,
        ["-ao", str(OVERLAP)], "r.pkl", lambda ib: half_concat_plan(N_FRAMES, HALF_RECORDS, ib),
        check_half_concat)
    log(f"[16b] within-recording LOO: evals.run_within_recording_loo_eval.main --loo_seq_len "
        f"{LOO_SEQ} --loo_overlap {LOO_OVERLAP} on a {LOO_FRAMES}-frame recording, flagship, "
        f"bf16, offline, on {card}")
    loo = protocol_phase(
        "16b", run_within_recording_loo_eval, card, modules, cfg, [LOO_FRAMES],
        ["--loo_seq_len", str(LOO_SEQ), "--loo_overlap", str(LOO_OVERLAP)], "r_1.pkl",
        lambda ib: loo_plan(LOO_FRAMES, LOO_SEQ, LOO_OVERLAP, ib),
        lambda run, result, detail, plan: check_loo(run, result, detail, plan, LOO_FRAMES, cfg),
        core="loo_eval")
    log(f"[16c] sequence scaling: evals.run_seq_eval.main --nsti_seq_len {NSTI_SEQ} "
        f"--nsti_overlap {NSTI_OVERLAP} on a {SEQ_FRAMES}-frame recording, flagship, bf16, "
        f"offline, on {card}")
    seq = protocol_phase(
        "16c", run_seq_eval, card, modules, cfg, [SEQ_FRAMES],
        ["--nsti_seq_len", str(NSTI_SEQ), "--nsti_overlap", str(NSTI_OVERLAP)], "r_1.pkl",
        lambda ib: seq_plan(SEQ_FRAMES, NSTI_SEQ, NSTI_OVERLAP, ib),
        lambda run, result, detail, plan: check_seq(run, result, detail, SEQ_FRAMES, cfg),
        core="seq_eval_one")
    return half, loo, seq


# ---------------------------------------------------------------------------
# the native host libraries and the -lm path
# ---------------------------------------------------------------------------


class Timed:
    """Stands in for ``fn``: synchronizes the card before and after each call
    and keeps each call's seconds."""

    def __init__(self, fn):
        self.fn = fn
        self.seconds = []

    def __call__(self, *args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.time()
        out = self.fn(*args, **kwargs)
        torch.cuda.synchronize()
        self.seconds.append(time.time() - t0)
        return out


def wer_pair(n_words, seed=0):
    """A reference of ``n_words`` words from a 5000-word vocabulary and a
    hypothesis with ~10 % substitutions, 5 % deletions and 5 % insertions."""
    import numpy as np

    rng = np.random.default_rng(seed)
    ref = [f"w{i}" for i in rng.integers(0, 5000, n_words)]
    hyp = []
    for word, u in zip(ref, rng.random(n_words)):
        if u < 0.10:
            hyp.append(f"w{rng.integers(0, 5000)}")
        elif u < 0.15:
            continue
        else:
            hyp.append(word)
            if u > 0.95:
                hyp.append(f"w{rng.integers(0, 5000)}")
    return " ".join(hyp), " ".join(ref)


def check_native_libraries(card):
    """Phase 12: both native libraries built (g++ seconds of this process);
    the native WER on a long pair against the Python DP's stored counts, and
    against the Python DP itself, both timed, on a shorter pair."""
    from dynamic_asr_eval_tpu_torch.lm import arpa_native
    from dynamic_asr_eval_tpu_torch.text import wer

    builds = {}
    for lib in (wer.LIBRARY, arpa_native.LIBRARY):
        lib.load()
        builds[lib.source.name] = lib.build_seconds
        log(f"  {lib.source.name}: " + ("built before this phase" if lib.build_seconds is None
                                        else f"g++ {lib.build_seconds:.2f} s"))
    hyp, ref = wer_pair(WER_WORDS)
    t0 = time.time()
    native = tuple(int(x) for x in wer.wer_counts(hyp, ref)[:3])
    native_s = time.time() - t0
    if native != WER_COUNTS:
        raise AssertionError(f"native WER counts {native} != the Python DP's {WER_COUNTS}")
    hyp, ref = wer_pair(WER_DP_WORDS)
    t0 = time.time()
    short = tuple(int(x) for x in wer.wer_counts(hyp, ref)[:3])
    t1 = time.time()
    plain = wer._edit_ops(hyp.split(), ref.split())
    t2 = time.time()
    if short != plain:
        raise AssertionError(f"native WER counts {short} != the Python DP's {plain}")
    result = {"card": card, "g++_seconds": builds, "words": WER_WORDS, "ins_del_sub": native,
              "native_s": native_s, "dp_words": WER_DP_WORDS, "dp_ins_del_sub": short,
              "dp_native_s": t1 - t0, "python_dp_s": t2 - t1}
    log(f"  {WER_WORDS}-word pair, native (ins, del, sub) {native}, as the Python DP gives: "
        f"{native_s:.4f} s; {WER_DP_WORDS}-word pair, {short} on both paths: native "
        f"{t1 - t0:.4f} s, Python DP {t2 - t1:.2f} s ({card})")
    print(json.dumps({"native_wer": result}))


def synthetic_pieces(n):
    """``n`` distinct word-start pieces: "▁" and a bijective base-26 letter
    string (a, b, ..., z, aa, ab, ...)."""
    pieces = []
    for i in range(n):
        word, j = "", i
        while j >= 0:
            word = chr(ord("a") + j % 26) + word
            j = j // 26 - 1
        pieces.append("\u2581" + word)
    return pieces


def write_vocab(directory, vocab=LM_VOCAB):
    """The vocabulary file of ``vocab`` synthetic pieces (the tokenizer of
    phases 13 and 14); returns its path."""
    path = os.path.join(directory, "synthetic.vocab")
    with open(path, "w", encoding="utf-8") as f:
        f.write("\n".join(synthetic_pieces(vocab)) + "\n")
    return path


def write_synthetic_lm(directory, seed=0, vocab=LM_VOCAB, counts=LM_COUNTS):
    """A vocabulary file of ``vocab`` pieces and a token-level ARPA file
    over them: every unigram, and per higher order ``counts[k]`` draws of a
    lower-order n-gram extended by a random piece (duplicates dropped), with
    random log10 probabilities and backoffs.  Returns (vocab path, ARPA path,
    n-grams per order)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    pieces = np.array(synthetic_pieces(vocab), dtype=object)
    vocab_path = write_vocab(directory, vocab)
    grams = [np.arange(vocab)[:, None]]
    for n in counts:
        prev = grams[-1]
        rows = np.concatenate([prev[rng.integers(0, len(prev), n)],
                               rng.integers(0, vocab, (n, 1))], axis=1)
        grams.append(np.unique(rows, axis=0))
    arpa_path = os.path.join(directory, "synthetic.arpa")
    with open(arpa_path, "w", encoding="utf-8") as f:
        f.write("\\data\\\n" + "".join(f"ngram {k + 1}={len(g)}\n" for k, g in enumerate(grams)))
        for k, g in enumerate(grams):
            logp = rng.uniform(-4.0, -0.5, len(g))
            words = [" ".join(row) for row in pieces[g]]
            if k + 1 < len(grams):
                backoff = rng.uniform(-1.0, 0.0, len(g))
                body = [f"{a:.4f}\t{w}\t{b:.4f}" for a, w, b in zip(logp, words, backoff)]
            else:
                body = [f"{a:.4f}\t{w}" for a, w in zip(logp, words)]
            f.write(f"\n\\{k + 1}-grams:\n" + "\n".join(body) + "\n")
        f.write("\n\\end\\\n")
    return vocab_path, arpa_path, [len(g) for g in grams]


def check_live_beams(what, got, want, rel=1e-5):
    """Two searches' live beams (score above -1e29): same order, tokens and
    lengths, scores within ``rel``; returns the largest relative difference."""
    (gt, gl, gs), (wt, wl, ws) = ([x.cpu() for x in r] for r in (got, want))
    live = ws > -1e29
    if not (torch.equal(gs > -1e29, live) and torch.equal(gl[live], wl[live])
            and all(torch.equal(gt[b, : gl[b]], wt[b, : wl[b]]) for b in torch.nonzero(live)[:, 0])):
        raise AssertionError(f"{what}: the live beams differ in tokens, lengths or order")
    diff = ((gs[live] - ws[live]).abs() / ws[live].abs().clamp_min(1e-30)).max().item()
    if not diff <= rel:
        raise AssertionError(f"{what}: beam scores differ by {diff:.3e} relative (> {rel})")
    return diff


def lm_path(tmp, card, kernel_modules, pallas_profile, expect):
    """Phase 13: ``evals.run.main -lm`` at flagship width; returns the
    kernels' launches ({module: (fwd, bwd)}) and, for the modules with
    routes, the launches by route."""
    import argparse

    import dynamic_asr_eval_tpu_torch.evals.common as common
    import dynamic_asr_eval_tpu_torch.tta.runner as runner
    from dynamic_asr_eval_tpu_torch.lm.loader import load_lm_adapter
    from dynamic_asr_eval_tpu_torch.ops.beam_search import (
        beam_search_device,
        collapse_blank_frames_device,
    )
    from dynamic_asr_eval_tpu_torch.ops.chunk import chunk_starts_and_lengths
    from dynamic_asr_eval_tpu_torch.text import load_tokenizer

    t0 = time.time()
    vocab_path, arpa_path, counts = write_synthetic_lm(tmp)
    arpa_mb = os.path.getsize(arpa_path) / 1e6
    log(f"  synthetic LM: {LM_VOCAB} pieces; n-grams by order {counts}; {arpa_mb:.1f} MB of ARPA "
        f"written in {time.time() - t0:.2f} s")
    cfg = flagship_config(subsampling_impl="pallas")
    timers = {"load": Timed(common.load_lm_adapter), "beam": Timed(runner.beam_search_device),
              "decode": Timed(common.decode_output)}
    originals = common.load_lm_adapter, runner.beam_search_device, common.decode_output
    common.load_lm_adapter, runner.beam_search_device, common.decode_output = (
        timers["load"], timers["beam"], timers["decode"])
    try:
        wer, wall, launches, routes, detail, recorder = main_path(
            cfg, kernel_modules,
            flags=("--tokenizer", vocab_path, "-lm", arpa_path, "--beams", str(LM_BEAMS)),
            kwargs=(f"lm_tta_beams={LM_TTA_BEAMS}",))
    finally:
        common.load_lm_adapter, runner.beam_search_device, common.decode_output = originals
    check_launches(launches, expect, offset=graph_offset(recorder))
    check_routes("-lm path", launches, routes)
    check_driver_output(cfg, wer, detail, recorder)
    engine, (out,) = recorder.engine, recorder.outputs
    adapter = engine.lm_adapter
    if adapter is None or engine.config.lm_tta_beams != LM_TTA_BEAMS:
        raise AssertionError("the NSTI engine runs without LM-fused pseudo-labels")
    devices = {t.device.type for t in adapter.lm.keys.values()}
    if adapter.lm.reader != "native" or devices != {"cuda"}:
        raise AssertionError(f"n-gram tables read by the {adapter.lm.reader} parser, on "
                             f"{devices}, the engine on {engine.device}")
    if len(timers["beam"].seconds) != N_WINDOWS or len(timers["decode"].seconds) != 1:
        raise AssertionError(f"{len(timers['beam'].seconds)} pseudo-label beams and "
                             f"{len(timers['decode'].seconds)} final decodes, expected "
                             f"{N_WINDOWS} and 1")
    hyp = detail["model_output"][0]
    if not hyp.strip():
        raise AssertionError("the -lm decode gave an empty transcript")
    log(f"  WER {wer}; launches {launches}; by route {routes}; evals.run wall {wall:.3f} s; "
        f"transcript of {len(hyp.split())} words; n-gram tables on {engine.device}, read by the "
        f"native reader")

    log(f"  the card's beam against the CPU's on the first {LM_CHECK_FRAMES} collapsed frames")
    kw = dict(common.lm_kwargs(argparse.Namespace()), beam_width=LM_BEAMS)
    n_valid = (out.counts > 0).sum()
    lp_c, n_kept = collapse_blank_frames_device(out.logits, threshold=0.99, valid_frames=n_valid)
    lp = lp_c[: min(int(n_kept), LM_CHECK_FRAMES)]
    gpu_timer = Timed(beam_search_device)
    got = gpu_timer(lp, adapter, **kw)
    cpu_adapter = load_lm_adapter(arpa_path, load_tokenizer(vocab_path), device="cpu")
    t0 = time.time()
    want = beam_search_device(lp.cpu(), cpu_adapter, **kw)
    cpu_s = time.time() - t0
    diff = check_live_beams("-lm decode, card against CPU", got, want)
    log(f"  equal live beams ({int((want[2] > -1e29).sum())}, best of "
        f"{int(want[1][0])} tokens); scores within {diff:.2e} relative; card "
        f"{gpu_timer.seconds[0]:.3f} s, CPU {cpu_s:.3f} s")

    _, lengths = chunk_starts_and_lengths(N_FRAMES, SEQ, OVERLAP)
    label_frames = sum(-(-int(n) // cfg.subsampling_factor) for n in lengths)
    beam_s = sum(timers["beam"].seconds)
    result = {
        "card": card, "arpa_ngrams_by_order": counts, "arpa_mb": arpa_mb,
        "arpa_load_s": timers["load"].seconds[0], "table_bytes": adapter.lm.table_bytes(),
        "frames_stitched": int(n_valid), "frames_kept_by_collapse": int(n_kept),
        "pseudo_label_beam_ms_per_window": beam_s / N_WINDOWS * 1e3,
        "pseudo_label_beam_ms_by_window": [t * 1e3 for t in timers["beam"].seconds],
        "pseudo_label_beam_ms_per_frame": beam_s / label_frames * 1e3,
        "final_decode_s": timers["decode"].seconds[0],
        "final_decode_ms_per_kept_frame": timers["decode"].seconds[0] / int(n_kept) * 1e3,
        "record_wall_s": detail["elapsed_times"][0],
        "adapt_ms_per_window": out.elapsed / N_WINDOWS * 1e3,
        "adapt_ms_per_window_without_beam": (out.elapsed - beam_s) / N_WINDOWS * 1e3,
        "phase_5b_ms_per_window": pallas_profile["ms_per_window"],
        "check_frames": int(lp.shape[0]), "check_card_s": gpu_timer.seconds[0],
        "check_cpu_s": cpu_s, "check_max_rel_score_diff": diff, "wer": wer,
    }
    for key, val in result.items():
        if key != "pseudo_label_beam_ms_by_window":
            log(f"  {key}: {val}")
    print(json.dumps({"lm_path": result}))
    return launches, routes


def write_transformer_lm(directory, vocab, seed=0):
    """Phase 14's LM: seeded weights at the published lming shape over
    ``vocab`` pieces, written as a DLM1 file and as a lming torch pickle
    (DDP prefixes, its config naming the head count); both files are read
    back and must give the weights bit for bit.  Returns (DLM1 path, pickle
    path, config, parameter count, seconds to write and read both)."""
    from dynamic_asr_eval_tpu_torch.lm.loader import (
        load_lm_checkpoint,
        load_lm_torch_checkpoint,
        save_lm_checkpoint,
    )
    from dynamic_asr_eval_tpu_torch.lm.transformer_lm import TransformerLMConfig, init_lm

    t0 = time.time()
    cfg = TransformerLMConfig(vocab_size=vocab, n_heads=TLM_HEADS)
    state = init_lm(cfg, seed=seed).state_dict()
    dlm, pt = os.path.join(directory, "tlm.dlm"), os.path.join(directory, "tlm.pt")
    save_lm_checkpoint(dlm, state, cfg)
    torch.save({"model": {f"module.{k}": v for k, v in state.items()},
                "config": {"model": {"n_heads": TLM_HEADS}}}, pt)
    (from_dlm, dlm_cfg), (from_pt, pt_cfg) = (
        load_lm_checkpoint(dlm), load_lm_torch_checkpoint(pt, verbose=False))
    for what, model in (("DLM1", from_dlm), ("torch pickle", from_pt)):
        loaded = model.state_dict()
        if loaded.keys() != state.keys() or not all(torch.equal(loaded[k], v)
                                                    for k, v in state.items()):
            raise AssertionError(f"transformer LM {what}: the reloaded weights differ")
    if dlm_cfg != cfg or pt_cfg != cfg:
        raise AssertionError(f"transformer LM configs {dlm_cfg}, {pt_cfg} != {cfg}")
    return dlm, pt, cfg, sum(v.numel() for v in state.values()), time.time() - t0


def tlm_path(tmp, card, kernel_modules, expect):
    """Phase 14: ``evals.run.main -lm <DLM1>`` at flagship width on a
    TLM_WINDOWS-window recording; returns the kernels' launches ({module:
    (fwd, bwd)}) and, for the modules with routes, the launches by route."""
    import argparse

    import dynamic_asr_eval_tpu_torch.evals.common as common
    import dynamic_asr_eval_tpu_torch.tta.runner as runner
    from dynamic_asr_eval_tpu_torch.lm.loader import load_lm_adapter
    from dynamic_asr_eval_tpu_torch.ops.beam_search import (
        TransformerLMAdapter,
        beam_search_device,
        collapse_blank_frames_device,
    )
    from dynamic_asr_eval_tpu_torch.ops.chunk import chunk_starts_and_lengths
    from dynamic_asr_eval_tpu_torch.text import load_tokenizer

    vocab_path = write_vocab(tmp)
    tokenizer = load_tokenizer(vocab_path)
    dlm, pt, lm_cfg, n_params, files_s = write_transformer_lm(tmp, tokenizer.vocab_size())
    log(f"  transformer LM {lm_cfg.n_layers} x {lm_cfg.d_model}, {lm_cfg.n_heads} heads, cache "
        f"{lm_cfg.max_cache_length}, vocabulary {lm_cfg.vocab_size}: {n_params} parameters; "
        f"DLM1 {os.path.getsize(dlm) / 1e6:.1f} MB and torch pickle written and read back bit for "
        f"bit in {files_s:.2f} s")
    cfg = flagship_config(subsampling_impl="pallas")
    timers = {"load": Timed(common.load_lm_adapter), "beam": Timed(runner.beam_search_device),
              "decode": Timed(common.decode_output)}
    originals = common.load_lm_adapter, runner.beam_search_device, common.decode_output
    common.load_lm_adapter, runner.beam_search_device, common.decode_output = (
        timers["load"], timers["beam"], timers["decode"])
    try:
        wer, wall, launches, routes, detail, recorder = main_path(
            cfg, kernel_modules,
            flags=("--tokenizer", vocab_path, "-lm", dlm, "--beams", str(LM_BEAMS)),
            kwargs=(f"lm_tta_beams={LM_TTA_BEAMS}",), frames=TLM_FRAMES)
    finally:
        common.load_lm_adapter, runner.beam_search_device, common.decode_output = originals
    check_launches(launches, expect, windows=TLM_WINDOWS, exact=True,
                   offset=graph_offset(recorder))
    check_routes("transformer-LM path", launches, routes)
    check_driver_output(cfg, wer, detail, recorder, frames=TLM_FRAMES)
    engine, (out,) = recorder.engine, recorder.outputs
    adapter = engine.lm_adapter
    if not isinstance(adapter, TransformerLMAdapter) or engine.config.lm_tta_beams != LM_TTA_BEAMS:
        raise AssertionError(f"the NSTI engine runs with {type(adapter).__name__} and "
                             f"lm_tta_beams={engine.config.lm_tta_beams}, not the transformer LM")
    if adapter.device.type != "cuda" or adapter.config.compute_dtype != torch.float32:
        raise AssertionError(f"the LM on {adapter.device} in {adapter.config.compute_dtype}")
    if len(timers["beam"].seconds) != TLM_WINDOWS or len(timers["decode"].seconds) != 1:
        raise AssertionError(f"{len(timers['beam'].seconds)} pseudo-label beams and "
                             f"{len(timers['decode'].seconds)} final decodes, expected "
                             f"{TLM_WINDOWS} and 1")
    hyp = detail["model_output"][0]
    if not hyp.strip():
        raise AssertionError("the transformer-LM decode gave an empty transcript")
    log(f"  WER {wer}; launches {launches}; by route {routes}; evals.run wall {wall:.3f} s; "
        f"transcript of {len(hyp.split())} words; the LM on {adapter.device}, f32")

    log(f"  the card's beam against the CPU's on the first {LM_CHECK_FRAMES} collapsed frames")
    kw = dict(common.lm_kwargs(argparse.Namespace()), beam_width=LM_BEAMS)
    n_valid = (out.counts > 0).sum()
    lp_c, n_kept = collapse_blank_frames_device(out.logits, threshold=0.99, valid_frames=n_valid)
    lp = lp_c[: min(int(n_kept), LM_CHECK_FRAMES)]
    gpu_timer = Timed(beam_search_device)
    advances = []  # frames on which the LM advanced in the card's search
    adapter.advance = lambda *a, advance=adapter.advance: advances.append(1) or advance(*a)
    try:
        got = gpu_timer(lp, adapter, **kw)
    finally:
        del adapter.advance
    cpu_adapter = load_lm_adapter(pt, tokenizer, device="cpu")  # the pickle of the same weights
    t0 = time.time()
    want = beam_search_device(lp.cpu(), cpu_adapter, **kw)
    cpu_s = time.time() - t0
    diff = check_live_beams("transformer-LM decode, card against CPU", got, want, rel=TLM_RTOL)
    if not advances:
        raise AssertionError("the LM never advanced in the compared searches")
    log(f"  equal live beams ({int((want[2] > -1e29).sum())}, best of {int(want[1][0])} tokens); "
        f"scores within {diff:.2e} relative; the LM advanced on {len(advances)} of "
        f"{lp.shape[0]} frames; card {gpu_timer.seconds[0]:.3f} s, CPU {cpu_s:.3f} s")

    _, lengths = chunk_starts_and_lengths(TLM_FRAMES, SEQ, OVERLAP)
    label_frames = sum(-(-int(n) // cfg.subsampling_factor) for n in lengths)
    beam_s = sum(timers["beam"].seconds)
    L, H, N, D = lm_cfg.n_layers, lm_cfg.n_heads, lm_cfg.max_cache_length, lm_cfg.head_dim
    result = {
        "card": card, "lm_shape": [L, lm_cfg.d_model, H, N, lm_cfg.vocab_size],
        "lm_params": n_params, "lm_param_bytes": n_params * 4,
        "cache_bytes_per_beam": 2 * L * H * N * D * 4,
        "cache_bytes_b20": 2 * L * LM_BEAMS * H * N * D * 4,
        "lm_load_s": timers["load"].seconds[0], "lm_files_s": files_s,
        "windows": TLM_WINDOWS, "frames_stitched": int(n_valid),
        "frames_kept_by_collapse": int(n_kept),
        "pseudo_label_beam_ms_per_window": beam_s / TLM_WINDOWS * 1e3,
        "pseudo_label_beam_ms_by_window": [t * 1e3 for t in timers["beam"].seconds],
        "pseudo_label_beam_ms_per_frame": beam_s / label_frames * 1e3,
        "final_decode_s": timers["decode"].seconds[0],
        "final_decode_ms_per_kept_frame": timers["decode"].seconds[0] / int(n_kept) * 1e3,
        "record_wall_s": detail["elapsed_times"][0],
        "adapt_ms_per_window_without_beam": (out.elapsed - beam_s) / TLM_WINDOWS * 1e3,
        "check_frames": int(lp.shape[0]), "check_card_s": gpu_timer.seconds[0],
        "check_cpu_s": cpu_s, "check_max_rel_score_diff": diff,
        "check_lm_advances": len(advances), "transcript_words": len(hyp.split()), "wer": wer,
    }
    for key, val in result.items():
        if key != "pseudo_label_beam_ms_by_window":
            log(f"  {key}: {val}")
    print(json.dumps({"tlm_path": result}))
    return launches, routes


def ptxas_report(build_log: str):
    """(mangled kernel name, registers, spill-store bytes) for each entry in
    nvcc's ``-Xptxas -v`` output."""
    rows, name, spills = [], None, 0
    for line in build_log.splitlines():
        if "Compiling entry function" in line:
            name, spills = line.split("'")[1], 0
        elif "spill stores" in line and name is not None:
            spills = int(re.search(r"(\d+) bytes spill stores", line).group(1))
        elif "registers" in line and name is not None:
            rows.append((name, int(re.search(r"Used (\d+) registers", line).group(1)), spills))
            name = None
    return rows


def demangle(names):
    """The kernels' names without their parameters, by ``cu++filt -p`` (it
    ships beside nvcc)."""
    from dynamic_asr_eval_tpu_torch.kernels._build import nvcc

    tool = os.path.join(os.path.dirname(nvcc()), "cu++filt")
    out = subprocess.run([tool, "-p"], input="\n".join(names), capture_output=True, text=True,
                         check=True, timeout=60)
    return out.stdout.splitlines()


def family(name: str) -> str:
    for fam, keys in FAMILIES:
        if any(k in name for k in keys):
            return fam
    return "other"


def wall_ms(fn) -> float:
    """``fn()`` once, in ms of wall time between two synchronisations of the
    card."""
    torch.cuda.synchronize()
    t0 = time.time()
    fn()
    torch.cuda.synchronize()
    return (time.time() - t0) * 1e3


def warm_run_ms(recorder, seq=None, overlap=None, frames=None) -> float:
    """One run of the driver's engine on its recording (its first ``frames``
    frames or samples when given) and weights (warm after the driver's own
    run), in ms of wall time; windows of ``seq`` / ``overlap`` (default SEQ
    / OVERLAP)."""
    engine, ((params, spec),) = recorder.engine, recorder.calls
    if frames is not None:
        spec = spec[..., :frames]
    return wall_ms(lambda: engine(params, spec, SEQ if seq is None else seq,
                                  OVERLAP if overlap is None else overlap, rng=0))


# phase 5c's driver runs: (attention_impl, subsampling_impl), f32
F32_RUNS = {"pallas_flash": ("pallas_flash", "conv"), "xla": ("xla", "conv"),
            "pallas_subsampling": ("pallas_flash", "pallas")}


def f32_path(card, A, S):
    """Phase 5c: the flagship NSTI in f32 through ``evals.run.main``, three
    driver runs, cuDNN deterministic in each: ``"pallas_flash"`` (the f32
    attention kernels, ``"conv"`` subsampling), ``"xla"`` (plain attention,
    ``"conv"``) and ``"pallas_subsampling"`` (the f32 attention kernels and
    the f32 subsampling kernels, ``"pallas"``).  Launches exactly n_layers
    attention forwards and backwards per window on the f32 route in both
    kernel runs, exactly 1 / 1 subsampling launches per window on it in the
    third, none in ``"xla"``; the stitched log-probs of the other two runs
    within 1e-3 of max |log-prob| of ``"pallas_flash"``'s, equal greedy ids
    (the windows are multiples of 8, where the fused kernels' unmasked
    semantics and ``"conv"``'s masks agree); then each engine's warm walls
    (cuDNN's own algorithms).  Returns the f32-route (fwd, bwd) launches by
    kernel: the attention's of ``"pallas_flash"``, the subsampling's of
    ``"pallas_subsampling"``."""
    import numpy as np

    from dynamic_asr_eval_tpu_torch.device import deterministic_cudnn

    runs, route = {}, A.ROUTES[torch.float32]
    for name, (attention, subsampling) in F32_RUNS.items():
        cfg = flagship_config(compute_dtype=torch.float32, attention_impl=attention,
                              subsampling_impl=subsampling)
        modules = {"attention": A} if subsampling == "conv" else {"attention": A, "subsample": S}
        with deterministic_cudnn():
            wer, wall, launches, routes, detail, recorder = main_path(cfg, modules)
        check_driver_output(cfg, wer, detail, recorder)
        runs[name] = (recorder, routes, wall)
    passes = {name: N_WINDOWS + graph_offset(run[0]) for name, run in runs.items()}

    def want(name, per_pass, routes_of):
        return {r: ((per_pass * passes[name],) * 2 if r == route else (0, 0))
                for r in routes_of.values()}

    kernel_routes, plain_routes = runs["pallas_flash"][1], runs["xla"][1]
    fused_routes = runs["pallas_subsampling"][1]
    if (kernel_routes["attention"] != want("pallas_flash", cfg.n_layers, A.ROUTES)
            or fused_routes["attention"] != want("pallas_subsampling", cfg.n_layers, A.ROUTES)
            or any(c != (0, 0) for c in plain_routes["attention"].values())):
        raise AssertionError(f"f32 path: attention launches by route {kernel_routes['attention']}"
                             f" and {fused_routes['attention']} (expected {cfg.n_layers} / "
                             f"{cfg.n_layers} over {passes} passes), on the xla path "
                             f"{plain_routes['attention']}")
    sub_route = S.ROUTES[torch.float32]
    sub_want = {r: ((passes["pallas_subsampling"],) * 2 if r == sub_route else (0, 0))
                for r in S.ROUTES.values()}
    if fused_routes.get("subsample") != sub_want:
        raise AssertionError(f"f32 path: subsampling launches by route "
                             f"{fused_routes.get('subsample')} (expected {sub_want})")
    base = runs["pallas_flash"][0].outputs[0]
    lp_base = base.numpy_logits()
    scale = float(np.abs(lp_base).max())
    errs = {}
    for name in ("xla", "pallas_subsampling"):
        other = runs[name][0].outputs[0]
        lp = other.numpy_logits()
        same_ids = lp.shape == lp_base.shape and np.array_equal(other.greedy_ids(),
                                                                 base.greedy_ids())
        errs[name] = float(np.abs(lp - lp_base).max()) if lp.shape == lp_base.shape else math.inf
        if not (errs[name] <= 1e-3 * scale and same_ids):
            raise AssertionError(f"f32 path, {name} vs the kernel attention run: "
                                 f"{errs[name]:.3e} (max |log-prob| {scale:.3e}), greedy ids "
                                 f"equal {same_ids}")
    log(f"  attention launches {kernel_routes['attention']} ({route}: {cfg.n_layers} / "
        f"{cfg.n_layers} per window), subsampling launches {fused_routes['subsample']} "
        f"({sub_route}: 1 / 1 per window); stitched log-probs against the pallas_flash run: xla "
        f"{errs['xla']:.2e}, pallas_subsampling {errs['pallas_subsampling']:.2e} (max "
        f"|log-prob| {scale:.3e}); greedy ids equal")
    result = {"card": card, "frames": N_FRAMES, "windows": N_WINDOWS, "route": route,
              "launches": kernel_routes["attention"][route],
              "subsample_route": sub_route,
              "subsample_launches": fused_routes["subsample"][sub_route],
              "max_abs_err": errs["xla"], "pallas_subsampling_max_abs_err":
                  errs["pallas_subsampling"], "max_abs_log_prob": scale}
    for name, (recorder, _, wall) in runs.items():
        walls = [warm_run_ms(recorder) for _ in range(TIMED_RUNS)]
        result[name] = {"driver_wall_s": wall, "engine_walls_ms": walls,
                        "ms_per_window": min(walls) / N_WINDOWS,
                        "rtfx": N_FRAMES / 100.0 / (min(walls) / 1e3)}
        log(f"  {name}: engine walls {walls} ms, {min(walls) / N_WINDOWS:.2f} ms per window, "
            f"RTFx {result[name]['rtfx']:.2f}")
    print(json.dumps({"f32_path": result}))
    return {"flash_attention_f32": kernel_routes["attention"][route],
            "fused_subsample_f32": fused_routes["subsample"][sub_route]}


def kernel_ms(fn, cpu=True):
    """``fn()`` once under torch.profiler: {kernel name: device ms}.  Ranges
    that annotate kernels are left out; empty where the profiler sees no
    device time.  ``cpu=False`` records the device's activity alone (fewer
    events for a run of many small launches)."""
    from collections import defaultdict

    acts = [torch.profiler.ProfilerActivity.CUDA]
    if cpu:
        acts.insert(0, torch.profiler.ProfilerActivity.CPU)
    with torch.profiler.profile(activities=acts) as prof:
        fn()
    by_kernel = defaultdict(float)
    for evt in prof.key_averages():
        dev_us = getattr(evt, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(evt, "self_cuda_time_total", 0.0)
        if getattr(evt, "is_user_annotation", False) or "#" in evt.key:
            continue  # a range around kernels (Optimizer.step#...), not a kernel
        if dev_us and evt.device_type == torch.autograd.DeviceType.CUDA:
            by_kernel[evt.key] += dev_us / 1e3
    return dict(by_kernel)


def profile_engine(recorder, card, path, seq=None, overlap=None, windows=N_WINDOWS,
                   frames=N_FRAMES, frame_rate=100.0):
    """Where the time of one recording goes: the driver's engine, warm, on
    the same recording and weights, timed TIMED_RUNS times; then, on the
    recording's first ``seq + (seq - overlap)`` frames (3 windows from the
    chunker: two whole and a ragged tail), one untraced run and one under
    torch.profiler.  Device busy time is the sum of kernel times over the
    traced windows (ranges that annotate kernels are left out); the idle
    share is ``1 - busy / wall`` of that cut recording's untraced run.
    ``seq`` / ``overlap`` / ``windows`` give the recording's window plan
    (default the flagship's), ``frames`` its length at ``frame_rate`` a
    second (default N_FRAMES at a 10 ms hop; samples at 16000 for a
    waveform)."""
    from collections import defaultdict

    walls_ms = [warm_run_ms(recorder, seq, overlap) for _ in range(TIMED_RUNS)]
    wall_ms = min(walls_ms)
    seq_ = SEQ if seq is None else seq
    cut = 2 * seq_ - (OVERLAP if overlap is None else overlap)
    traced = n_windows(cut, seq_, OVERLAP if overlap is None else overlap)
    cut_wall_ms = warm_run_ms(recorder, seq, overlap, frames=cut)
    by_kernel = kernel_ms(lambda: warm_run_ms(recorder, seq, overlap, frames=cut))
    busy_ms = sum(by_kernel.values())
    result = {"path": path, "card": card, "frames": frames, "windows": windows,
              "engine_walls_ms": walls_ms, "ms_per_window": wall_ms / windows,
              "rtfx": frames / frame_rate / (wall_ms / 1e3), "traced_frames": cut,
              "traced_windows": traced, "traced_wall_ms": cut_wall_ms}
    if busy_ms <= 0:
        result.update(device_busy_ms="not measured", idle_share="not measured")
    else:
        fams = defaultdict(float)
        for k, ms in by_kernel.items():
            fams[family(k)] += ms
        result.update(
            device_busy_ms=busy_ms, device_busy_ms_per_window=busy_ms / traced,
            idle_share=max(0.0, 1.0 - busy_ms / cut_wall_ms),
            families_ms=dict(sorted(fams.items(), key=lambda kv: -kv[1])),
            top_kernels_ms=[[k[:90], ms] for k, ms in
                            sorted(by_kernel.items(), key=lambda kv: -kv[1])[:TOP_KERNELS]])
    for key, val in result.items():
        if key != "top_kernels_ms":
            log(f"  {key}: {val}")
    for name, ms in result.get("top_kernels_ms", []):
        log(f"  {ms:9.3f} ms  {name}")
    print(json.dumps({"profile": result}))
    return result


def drive(label, cfg, kernel_modules, expect, card, check_model):
    log(f"[5{label}] main path: evals.run.main, NSTI on a {N_FRAMES}-frame recording, flagship, "
        f"bf16, subsampling_impl={cfg.subsampling_impl!r}")
    wer, wall, launches, routes, detail, recorder = main_path(cfg, kernel_modules)
    graphs = recorder.engine.graphs
    if (graphs.captures, graphs.replays, graphs.failures) != (
            1, len(recorder.calls) * N_WINDOWS - 1, 0):
        raise AssertionError(f"NSTI: {graphs.captures} graph captures, {graphs.replays} "
                             f"replays, {graphs.failures} failures over "
                             f"{len(recorder.calls)} x {N_WINDOWS} windows")
    check_launches(launches, expect, offset=graph_offset(recorder))
    check_routes("NSTI", launches, routes)
    log(f"  WER {wer}; launches {launches}; by route {routes}; evals.run wall {wall:.3f} s "
        f"(record {detail['elapsed_times'][0]:.3f} s, first run: includes warm-up)")
    log(f"[6{label}] output checks")
    params = check_driver_output(cfg, wer, detail, recorder)
    model_launches = check_model(params)
    log(f"[7{label}] where the time goes: the driver's engine, warm, on {card}")
    profile = profile_engine(recorder, card, f"subsampling_{cfg.subsampling_impl}")
    return launches, routes, model_launches, profile


# ---------------------------------------------------------------------------
# phases 17 and 18: entropy augmentation, the NeMo preset
# ---------------------------------------------------------------------------


def entropy_plan(n_layers):
    """Phase 17's launches per adapted window: the entropy pass (a batch-1
    forward and backward, the backward with gx) and the adaptation step (a
    batch-2 forward and backward)."""
    return {"attention": (2 * n_layers, 2 * n_layers), "subsample": (2, 2), "softdtw": (0, 0),
            "gx": 1}


# rel_pos is plain attention in both packages
NEMO_PLAN = {"attention": (0, 0), "subsample": (1, 1), "softdtw": (0, 0), "gx": 0}


def check_path_launches(what, launches, routes, gx, plan, windows=N_WINDOWS, acts=None,
                        act=None, offset=0, graphed=None):
    """Exact per-window launches (``plan``: module → (fwd, bwd), and ``gx``
    the backwards with gx; ``graphed``, the adapt step's model passes' part
    of it, counted ``offset`` more times: :func:`check_launches`), every
    launch on the bf16 route, and with ``act`` every subsampling launch of
    that activation."""
    check_launches(launches, {k: v for k, v in plan.items() if k != "gx"}, windows, exact=True,
                   offset=offset, graphed=graphed)
    check_routes(what, launches, routes)
    if gx != plan["gx"] * windows:
        raise AssertionError(f"{what}: {gx} subsampling backwards with gx, expected "
                             f"{plan['gx'] * windows}")
    if act is not None and any(tuple(c) != (tuple(launches["subsample"]) if a == act else (0, 0))
                               for a, c in acts.items()):
        raise AssertionError(f"{what}: subsampling launches by activation {acts}, expected "
                             f"{act} only")


def check_profile_trace(directory):
    """``--profile``'s Chrome trace of repeat 0: it exists and holds CUDA
    kernels; kept gzipped (Perfetto reads it so).  Returns (events, CUDA
    kernel events, bytes)."""
    import gzip
    import shutil

    from dynamic_asr_eval_tpu_torch.evals.common import PROFILE_TRACE

    path = os.path.join(directory, PROFILE_TRACE)
    if not os.path.isfile(path):
        raise AssertionError(f"--profile wrote no trace: {os.listdir(directory)}")
    nbytes = os.path.getsize(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kernels = sum(1 for e in events if e.get("cat") == "kernel")
    if not kernels:
        raise AssertionError("--profile's trace holds no CUDA kernel")
    with open(path, "rb") as src, gzip.open(path + ".gz", "wb") as dst:
        shutil.copyfileobj(src, dst)
    os.remove(path)
    return len(events), kernels, nbytes


def entropy_delta(recorder):
    """The entropy perturbation of the recording's first window, f32, from
    the pristine weights: (max |δ|, max |augmented window|)."""
    import numpy as np

    engine, ((params, spec),) = recorder.engine, recorder.calls
    spec = np.asarray(spec)
    spec = spec[0] if spec.ndim == 3 else spec
    engine._load(params)
    window = torch.as_tensor(spec[:, :SEQ], device=engine.device).float()
    aug = engine._augment(window[None], engine._generator(0), SEQ)
    delta = engine._entropy_delta(aug, SEQ)
    d_max, a_max = delta.abs().max().item(), aug.abs().max().item()
    if not (torch.isfinite(delta).all() and d_max > 0):
        raise AssertionError(f"entropy perturbation not finite or zero: max |delta| {d_max}")
    return d_max, a_max


def entropy_path(card, A, S, D, profile_dir):
    """Phase 17: ``evals.run.main -kwargs entropy_augmentation_enabled=true
    --profile DIR`` at the flagship, bf16, ``"pallas"`` subsampling."""
    cfg = flagship_config(subsampling_impl="pallas")
    start_gb = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    wer, wall, launches, routes, detail, recorder = main_path(
        cfg, {"attention": A, "subsample": S, "softdtw": D}, flags=("--profile", profile_dir),
        kwargs=("entropy_augmentation_enabled=true",))
    gx = S.gx_launches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9 - start_gb
    log(f"  WER {wer}; launches {launches}, gx {gx}; by route {routes}; evals.run wall "
        f"{wall:.3f} s (first run, under the profiler); peak device memory {peak_gb:.2f} GB "
        f"above the {start_gb:.2f} GB held when the phase began")
    check_path_launches("entropy NSTI", launches, routes, gx, entropy_plan(cfg.n_layers),
                        offset=graph_offset(recorder),
                        graphed={"attention": (cfg.n_layers, cfg.n_layers), "subsample": (1, 1)})
    check_driver_output(cfg, wer, detail, recorder)
    n_events, n_kernels, nbytes = check_profile_trace(profile_dir)
    log(f"  --profile: {n_events} events, {n_kernels} CUDA kernels, {nbytes / 1e6:.1f} MB "
        f"(kept gzipped in {profile_dir})")
    d_max, a_max = entropy_delta(recorder)
    log(f"  first window's perturbation: max |delta| {d_max:.3e} beside max |aug| {a_max:.3e} "
        f"(f32; in bf16 it may round away inside the model)")
    log(f"[17b] where entropy NSTI's time goes: the driver's engine, warm, on {card}")
    profile = profile_engine(recorder, card, "entropy")
    print(json.dumps({"entropy_path": {
        "card": card, "launches": launches, "gx_launches": gx, "peak_gb": peak_gb,
        "start_gb": start_gb,
        "delta_max": d_max, "aug_max": a_max, "trace_events": n_events,
        "trace_kernels": n_kernels, "ms_per_window": profile["ms_per_window"],
        "rtfx": profile["rtfx"]}}))
    return launches, routes, gx


def synthetic_nemo_state(cfg, seed=0):
    """A NeMo ``ConformerEncoder`` + ``ConvASRDecoder`` state dict with
    NeMo's names and shapes for ``cfg``, random from ``seed``: kernels
    lecun-normal, biases and norm offsets ~ N(0, 0.02), norm scales ~ 1 +
    N(0, 0.02), ``pos_bias_u`` / ``_v`` ~ N(0, 0.02), running statistics
    mean ~ N(0, 0.1) and var ~ U(0.5, 2)."""
    g = torch.Generator().manual_seed(seed)
    sd = {}

    def kernel(name, shape, fan_in):
        sd[name] = torch.randn(shape, generator=g) / math.sqrt(fan_in)

    def small(name, shape, centre=0.0):
        sd[name] = centre + 0.02 * torch.randn(shape, generator=g)

    def dense(prefix, n_out, n_in, bias=True):
        kernel(f"{prefix}.weight", (n_out, n_in), n_in)
        if bias:
            small(f"{prefix}.bias", (n_out,))

    d, C, H, D, K = (cfg.d_model, cfg.subsampling_conv_channels, cfg.n_heads, cfg.head_dim,
                     cfg.conv_kernel_size)
    kernel("encoder.pre_encode.conv.0.weight", (C, 1, 3, 3), 9)
    small("encoder.pre_encode.conv.0.bias", (C,))
    for i in range({2: 1, 4: 2, 8: 3}[cfg.subsampling_factor] - 1):
        kernel(f"encoder.pre_encode.conv.{2 + 3 * i}.weight", (C, 1, 3, 3), 9)
        small(f"encoder.pre_encode.conv.{2 + 3 * i}.bias", (C,))
        kernel(f"encoder.pre_encode.conv.{3 + 3 * i}.weight", (C, C, 1, 1), C)
        small(f"encoder.pre_encode.conv.{3 + 3 * i}.bias", (C,))
    f_ds = cfg.feat_in
    for _ in range({2: 1, 4: 2, 8: 3}[cfg.subsampling_factor]):
        f_ds = -(-f_ds // 2)
    dense("encoder.pre_encode.out", d, C * f_ds)
    for n in range(cfg.n_layers):
        e = f"encoder.layers.{n}"
        for norm in ("norm_feed_forward1", "norm_self_att", "norm_conv", "norm_feed_forward2",
                     "norm_out"):
            small(f"{e}.{norm}.weight", (d,), 1.0)
            small(f"{e}.{norm}.bias", (d,))
        for f in (1, 2):
            dense(f"{e}.feed_forward{f}.linear1", cfg.expansion_factor * d, d)
            dense(f"{e}.feed_forward{f}.linear2", d, cfg.expansion_factor * d)
        for x in "qkv":
            dense(f"{e}.self_attn.linear_{x}", H * D, d)
        dense(f"{e}.self_attn.linear_out", d, H * D)
        dense(f"{e}.self_attn.linear_pos", H * D, d, bias=False)
        small(f"{e}.self_attn.pos_bias_u", (H, D))
        small(f"{e}.self_attn.pos_bias_v", (H, D))
        kernel(f"{e}.conv.pointwise_conv1.weight", (2 * d, d, 1), d)
        small(f"{e}.conv.pointwise_conv1.bias", (2 * d,))
        kernel(f"{e}.conv.depthwise_conv.weight", (d, 1, K), K)
        small(f"{e}.conv.depthwise_conv.bias", (d,))
        small(f"{e}.conv.batch_norm.weight", (d,), 1.0)
        small(f"{e}.conv.batch_norm.bias", (d,))
        sd[f"{e}.conv.batch_norm.running_mean"] = 0.1 * torch.randn((d,), generator=g)
        sd[f"{e}.conv.batch_norm.running_var"] = 0.5 + 1.5 * torch.rand((d,), generator=g)
        sd[f"{e}.conv.batch_norm.num_batches_tracked"] = torch.tensor(1000)
        kernel(f"{e}.conv.pointwise_conv2.weight", (d, d, 1), d)
        small(f"{e}.conv.pointwise_conv2.bias", (d,))
    kernel("decoder.decoder_layers.0.weight", (cfg.n_classes, d, 1), d)
    small("decoder.decoder_layers.0.bias", (cfg.n_classes,))
    return sd


def check_nemo_subsample_model(cfg, params, S):
    """Phase 18, parity: the preset at full depth in f32 with ``"pallas"``
    subsampling, through the f32 subsampling kernel (relu) against the same
    model on the plain subsampling version, on lengths [4000, 3000]
    (multiples of 8), within 1e-3 on valid frames.  Returns the f32 route's
    (fwd, bwd) launches."""
    import dataclasses

    import dynamic_asr_eval_tpu_torch.models.conformer as conformer
    from dynamic_asr_eval_tpu_torch.device import deterministic_cudnn
    from dynamic_asr_eval_tpu_torch.models import SCConformer

    model = SCConformer(dataclasses.replace(cfg, compute_dtype=torch.float32)).cuda()
    model.load_state_dict({k: v.float() for k, v in params.items()})
    g = torch.Generator(device="cuda").manual_seed(5)
    x = torch.randn(2, cfg.feat_in, 4000, generator=g, device="cuda")
    lengths = torch.tensor([4000, 3000], device="cuda")
    route = S.ROUTES[torch.float32]
    S.reset_counters()
    with deterministic_cudnn(), torch.no_grad():
        a = model(x, lengths)
        torch.cuda.synchronize()
        launches, relu = tuple(S.route_launches[route]), tuple(S.act_launches["relu"])
        kernel_entry = conformer.fused_subsample
        conformer.fused_subsample = S.fused_subsample_reference
        try:
            b = model(x, lengths)
        finally:
            conformer.fused_subsample = kernel_entry
    err = valid_frame_err(a, b)
    if not (err <= 1e-3 and launches == (1, 0) and relu == (1, 0)
            and torch.isfinite(a["final_posteriors"]).all()):
        raise AssertionError(f"NeMo preset f32: subsampling kernel vs plain {err:.3e} (> 1e-3?); "
                             f"f32 launches {launches}, relu {relu}")
    log(f"  full-depth f32 NeMo preset, subsampling kernel (relu, {route}) vs plain version on "
        f"valid frames: {err:.2e}")
    return launches


def nemo_path(tmp, card, A, S, D):
    """Phase 18: the NeMo preset at full width (17 x 512, 8 x 64 heads,
    vocab 1024, ``rel_pos``, relu subsampling, ``"pallas"``, bf16) from a
    synthetic NeMo state dict, saved as DAE1 and driven through
    ``evals.run.main --checkpoint`` with a 1024-piece vocabulary."""
    import dataclasses

    from dynamic_asr_eval_tpu_torch.models.checkpoint import save_checkpoint
    from dynamic_asr_eval_tpu_torch.models.nemo_convert import (
        convert_nemo_state_dict,
        load_default_instance,
    )

    cfg = dataclasses.replace(load_default_instance(), subsampling_impl="pallas")
    t0 = time.time()
    state = convert_nemo_state_dict(synthetic_nemo_state(cfg), cfg)
    dae = os.path.join(tmp, "nemo.dae")
    save_checkpoint(dae, state, cfg)
    vocab_dir = os.path.join(tmp, "nemo_vocab")
    os.makedirs(vocab_dir, exist_ok=True)
    vocab = write_vocab(vocab_dir, cfg.vocab_size)
    log(f"  synthetic NeMo state dict converted and saved ({os.path.getsize(dae) / 1e6:.1f} MB "
        f"DAE1) in {time.time() - t0:.2f} s")
    start_gb = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    wer, wall, launches, routes, detail, recorder = main_path(
        None, {"attention": A, "subsample": S, "softdtw": D},
        flags=("--checkpoint", dae, "--tokenizer", vocab))
    gx, acts = S.gx_launches, {a: tuple(c) for a, c in S.act_launches.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9 - start_gb
    log(f"  WER {wer}; launches {launches}, gx {gx}; by route {routes}; by activation {acts}; "
        f"evals.run wall {wall:.3f} s (first run); peak device memory {peak_gb:.2f} GB above "
        f"the {start_gb:.2f} GB held when the phase began")
    run_cfg = recorder.engine.model.config
    if run_cfg != cfg:
        raise AssertionError(f"the driver ran {run_cfg}, not the preset {cfg}")
    check_path_launches("NeMo NSTI", launches, routes, gx, NEMO_PLAN, acts=acts, act="relu",
                        offset=graph_offset(recorder))
    params = check_driver_output(cfg, wer, detail, recorder)
    parity = check_nemo_subsample_model(cfg, params, S)
    log(f"[18b] where the NeMo preset's time goes: the driver's engine, warm, on {card}")
    profile = profile_engine(recorder, card, "nemo")
    print(json.dumps({"nemo_path": {
        "card": card, "launches": launches, "gx_launches": gx, "act_launches": acts,
        "peak_gb": peak_gb, "start_gb": start_gb, "ms_per_window": profile["ms_per_window"],
        "rtfx": profile["rtfx"],
        "engine_walls_ms": profile["engine_walls_ms"]}}))
    return launches, routes, gx, parity


# ---------------------------------------------------------------------------
# phases 19 and 20: the utterance path, wav2vec2-base
# ---------------------------------------------------------------------------

UTT_SEGMENT = 512  # phase 19: --segment_frames (T_ds 64); phase 5's recording gives 60
# phase 19: utterances whose run torch.profiler traces (its cost grows with
# the run's events; 19b traces its 10)
UTT_PROFILED = 10
UTT_SDTW = ((512, 8), (4096, 2))  # phase 19b: (frames, utterances) cut from that recording
SOFT_DTW_WEIGHT = 0.1
ASYMMETRY_MIN = 1e-3  # phase 19b: max |D - D^T| / max |D| of the engine's D, at least
SAMPLE_RATE = 16000
W2V_SAMPLES = 60 * SAMPLE_RATE  # phase 20: the chunked mode's synthetic recording, 60 s
W2V_SEQ, W2V_OVERLAP = 48000, 16000  # run_wav2vec2's remap of SEQ / OVERLAP
W2V_UTTERANCES = (64000, 64000)  # phase 20b: run_wav2vec2's own two 4 s records
W2V_PLAN = {"attention": (0, 0), "subsample": (0, 0), "softdtw": (0, 0), "gx": 0}
SOFTDTW_KERNEL = re.compile(r"namespace\)::(fwd|bwd)_kernel\(")  # csrc/softdtw.cu's R and E


def utterance_plan(n_layers, soft_dtw=False):
    """Launches per utterance of the utterance engine (online, 1 epoch): one
    batch-2 forward and backward, no final pass; with a soft-DTW weight one
    R and one E kernel."""
    return {"attention": (n_layers, n_layers), "subsample": (1, 1),
            "softdtw": (1, 1) if soft_dtw else (0, 0), "gx": 0}


def fixed_perturbation(batch, generator, length):
    """Phase 19b's ``augment_fn``: a fixed perturbation of half the batch's
    standard deviation, seeded by its width, so that the augmented and the
    clean posteriors differ and the engine's D is not symmetric."""
    g = torch.Generator(device=batch.device).manual_seed(batch.shape[-1])
    return batch + 0.5 * batch.std() * torch.randn(batch.shape, generator=g, device=batch.device)


def check_utterance_outputs(what, outs, lengths, out_len, n_classes, adapted, params):
    """One finite [out_len(T), n_classes] log-prob matrix per utterance of
    length T; weights that moved.  Returns the largest weight change."""
    import numpy as np

    if len(outs) != len(lengths):
        raise AssertionError(f"{what}: {len(outs)} outputs for {len(lengths)} utterances")
    for i, (out, T) in enumerate(zip(outs, lengths)):
        if out.shape != (out_len(T), n_classes) or not np.isfinite(out).all():
            raise AssertionError(f"{what}: utterance {i} log-probs {out.shape} (expected "
                                 f"{(out_len(T), n_classes)}), finite {np.isfinite(out).all()}")
    moved = weight_change(adapted, params)
    if not moved > 0:
        raise AssertionError(f"{what}: adaptation did not move the weights")
    return moved


def check_utterance_run(what, wer, detail, recorder, lengths, out_len, n_classes):
    """A driver's run of the utterance engine on one recording: one finite
    WER and transcript, one engine call over ``lengths``, its outputs as
    :func:`check_utterance_outputs` holds them."""
    if len(detail["model_output"]) != 1 or not math.isfinite(wer):
        raise AssertionError(f"{what}: driver result malformed: wer {wer}, "
                             f"{detail.get('model_output')}")
    if len(recorder.outputs) != 1:
        raise AssertionError(f"{what}: {len(recorder.outputs)} engine calls, not 1")
    (params, utts), (outs, adapted, _) = recorder.calls[0], recorder.outputs[0]
    got = [u["spectrogram"].shape[-1] for u in utts]
    if got != list(lengths):
        raise AssertionError(f"{what}: utterances of {got} frames, expected {list(lengths)}")
    return check_utterance_outputs(what, outs, lengths, out_len, n_classes, adapted, params)


def cut_utterances(recording, plan):
    """Utterances of ``plan``'s (frames, count) cut one after another from
    the start of a [F, T] recording."""
    utts, start = [], 0
    for frames, count in plan:
        for _ in range(count):
            utts.append({"spectrogram": recording[:, start:start + frames]})
            start += frames
    if start > recording.shape[1]:
        raise AssertionError(f"the plan {plan} needs {start} frames, the recording has "
                             f"{recording.shape[1]}")
    return utts


def check_engine_softdtw(D, Dmat, gamma=1.0):
    """The engine's own D: both kernels against the plain version as phase 3
    holds them (:func:`check_softdtw`), and the autograd wrapper the engine
    calls (``soft_dtw``) giving the R kernel's value and the E kernel's
    gradient bit for bit."""
    B, N, M = Dmat.shape
    errs = check_softdtw(D, (B, N, M), 0, gamma, Db=Dmat, what="the engine's soft-DTW")
    x = Dmat.detach().clone().requires_grad_(True)
    loss = D.soft_dtw(x, gamma, 0, True)
    (g,) = torch.autograd.grad(loss.sum(), x)
    R = D.softdtw_R(Dmat, gamma)
    E = D.softdtw_E(Dmat, R, gamma)
    torch.cuda.synchronize()
    if not (torch.equal(loss.detach(), R[:, N, M]) and torch.equal(g, E)):
        raise AssertionError(f"the engine's soft-DTW {(B, N, M)}: soft_dtw's value or gradient "
                             f"is not the kernels' R and E")
    return dict(errs, shape=[B, N, M])


def asymmetry(Dmat):
    """max |D - D^T| over max |D|: near 0 when the augmented and the clean
    posteriors are the same sequence."""
    return ((Dmat - Dmat.transpose(1, 2)).abs().max() / Dmat.abs().max()).item()


def softdtw_step_ms(D, Dmat, gamma=1.0):
    """ms of the soft-DTW term's kernels (value and D-gradient) at the
    engine's D: the R and the E kernel."""
    def step():
        x = Dmat.detach().requires_grad_(True)
        torch.autograd.grad(D.soft_dtw(x, gamma, 0, True).sum(), x)
    return cuda_ms(step, iters=10)


def warm_utterance_ms(engine, params, utts):
    """The fastest of TIMED_RUNS warm runs of ``engine`` over ``utts``, in
    ms per utterance."""
    return min(wall_ms(lambda: engine(params, utts)) for _ in range(TIMED_RUNS)) / len(utts)


def utterance_busy_ms(engine, params, utts):
    """One warm run of ``engine`` over ``utts`` under torch.profiler:
    {"ms_per_utterance": device busy ms an utterance, "idle_share": 1 - busy
    / the fastest of TIMED_RUNS warm walls, "softdtw_ms": the soft-DTW
    kernels' share of busy}, or "not measured" where the profiler sees no
    device time."""
    wall = warm_utterance_ms(engine, params, utts) * len(utts)
    by_kernel = kernel_ms(lambda: engine(params, utts))
    busy = sum(by_kernel.values())
    if busy <= 0:
        return "not measured"
    sdtw = sum(ms for k, ms in by_kernel.items() if SOFTDTW_KERNEL.search(k))
    return {"ms_per_utterance": busy / len(utts), "idle_share": max(0.0, 1.0 - busy / wall),
            "softdtw_ms_per_utterance": sdtw / len(utts)}


def utterance_path(card, A, S, D):
    """Phase 19: the utterance engine at the flagship (bf16,
    ``"pallas_flash"``, ``"pallas"`` subsampling).  (a)
    ``evals.run_utterance_eval.main --segment_frames 512`` on phase 5's
    recording; (b) ``UtteranceTTAEngine(soft_dtw_weight=0.1)`` on 8
    utterances of 512 frames and 2 of 4096 cut from it, and the engine's own
    D of the first utterance of each length through the kernels against the
    plain version.  Returns (a)'s and (b)'s (launches, routes)."""
    import numpy as np

    from dynamic_asr_eval_tpu_torch.evals import run_utterance_eval
    from dynamic_asr_eval_tpu_torch.tta.utterance import UtteranceTTAEngine

    cfg = flagship_config(subsampling_impl="pallas")
    modules = {"attention": A, "subsample": S, "softdtw": D}
    f = cfg.subsampling_factor

    def out_len(T):
        return -(-T // f)

    start_gb = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    wer, wall, launches, routes, detail, recorder = main_path(
        cfg, modules, run_utterance_eval, ("--segment_frames", str(UTT_SEGMENT)))
    n_utts = N_FRAMES // UTT_SEGMENT
    log(f"  WER {wer}; launches {launches}, gx {S.gx_launches}; by route {routes}; driver wall "
        f"{wall:.3f} s (first run) for {n_utts} utterances of {UTT_SEGMENT} frames")
    check_path_launches("utterance", launches, routes, S.gx_launches,
                        utterance_plan(cfg.n_layers), windows=n_utts)
    moved = check_utterance_run("utterance", wer, detail, recorder, [UTT_SEGMENT] * n_utts,
                                out_len, cfg.n_classes)
    params, utts = recorder.calls[0]
    plain_engine = recorder.engine
    ms_512 = warm_utterance_ms(plain_engine, params, utts)
    busy_512 = utterance_busy_ms(plain_engine, params, utts[:UTT_PROFILED])
    log(f"  {n_utts} utterances, finite log-probs, max weight change {moved:.3e}; warm "
        f"{ms_512:.3f} ms per utterance at {UTT_SEGMENT} frames, device busy (the first "
        f"{UTT_PROFILED}) {busy_512}")

    log(f"[19b] UtteranceTTAEngine(soft_dtw_weight={SOFT_DTW_WEIGHT}) on "
        f"{', '.join(f'{c} x {n}' for n, c in UTT_SDTW)} frames of the same recording")
    recording = np.concatenate([u["spectrogram"] for u in utts], axis=1)
    sdtw_utts = cut_utterances(recording, UTT_SDTW)
    lengths = [u["spectrogram"].shape[-1] for u in sdtw_utts]

    def perturbed_engine(weight):
        return UtteranceTTAEngine(plain_engine.model, cfg.blank_id, f, plain_engine.config,
                                  augment_fn=fixed_perturbation, soft_dtw_weight=weight,
                                  device=plain_engine.device)

    engine, no_sdtw = perturbed_engine(SOFT_DTW_WEIGHT), perturbed_engine(0.0)
    seen = []
    soft_dtw = D.soft_dtw

    def spy(Dmat, gamma=1.0, bandwidth=0, use_pallas=False):
        seen.append(Dmat.detach().clone())
        return soft_dtw(Dmat, gamma, bandwidth, use_pallas)

    D.soft_dtw = spy
    try:
        t0 = time.time()
        (outs, adapted, _), sdtw_launches, sdtw_routes = counted(
            modules, lambda: engine(params, sdtw_utts, return_params=True))
        first_wall = time.time() - t0
    finally:
        D.soft_dtw = soft_dtw
    log(f"  launches {sdtw_launches}, gx {S.gx_launches}; by route {sdtw_routes}; first wall "
        f"{first_wall:.3f} s")
    check_path_launches("utterance soft-DTW", sdtw_launches, sdtw_routes, S.gx_launches,
                        utterance_plan(cfg.n_layers, soft_dtw=True), windows=len(sdtw_utts))
    sdtw_moved = check_utterance_outputs("utterance soft-DTW", outs, lengths, out_len,
                                         cfg.n_classes, adapted, params)
    if [tuple(x.shape) for x in seen] != [(1, out_len(n), out_len(n)) for n in lengths]:
        raise AssertionError(f"soft-DTW D shapes {[tuple(x.shape) for x in seen]}")
    firsts, buckets = {}, {}
    for i, (n, x) in enumerate(zip(lengths, seen)):
        firsts.setdefault(n, x)
        buckets.setdefault(n, []).append(sdtw_utts[i])
    parity = {}
    for n, x in firsts.items():
        skew = asymmetry(x)
        if not skew > ASYMMETRY_MIN:
            raise AssertionError(f"the engine's D at {n} frames is symmetric (max |D - D^T| "
                                 f"{skew:.3e} of max |D|): the perturbation did not reach it")
        parity[n] = dict(check_engine_softdtw(D, x), asymmetry=skew)
        log(f"  the engine's D at {n} frames: max |D - D^T| {skew:.3e} of max |D|; soft_dtw "
            f"gives the kernels' R and E bit for bit")
    per_bucket = {}
    for n, subset in buckets.items():
        with_ms = warm_utterance_ms(engine, params, subset)
        without_ms = warm_utterance_ms(no_sdtw, params, subset)
        sdtw_ms = softdtw_step_ms(D, firsts[n])
        per_bucket[n] = {"utterances": len(subset), "ms_per_utterance": with_ms,
                         "ms_per_utterance_without_softdtw": without_ms,
                         "softdtw_ms": sdtw_ms, "softdtw_share": sdtw_ms / with_ms}
        log(f"  {n} frames: {with_ms:.3f} ms per utterance with soft-DTW, {without_ms:.3f} "
            f"without; the soft-DTW kernels {sdtw_ms:.4f} ms ({sdtw_ms / with_ms:.1%} of the "
            f"step)")
    sdtw_busy = utterance_busy_ms(engine, params, sdtw_utts)
    log(f"  the {len(sdtw_utts)} utterances with soft-DTW: device busy {sdtw_busy}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9 - start_gb
    print(json.dumps({"utterance_path": {
        "card": card, "frames": N_FRAMES, "segment_frames": UTT_SEGMENT, "utterances": n_utts,
        "driver_wall_s": wall, "warm_ms_per_utterance": ms_512, "device_busy": busy_512,
        "profiled_utterances": UTT_PROFILED,
        "softdtw_device_busy": sdtw_busy, "launches": launches,
        "softdtw_plan": [list(p) for p in UTT_SDTW], "softdtw_first_wall_s": first_wall,
        "softdtw_launches": sdtw_launches, "softdtw_weight_change": sdtw_moved,
        "softdtw_parity": {str(n): p for n, p in parity.items()},
        "per_bucket": {str(n): b for n, b in per_bucket.items()},
        "peak_gb": peak_gb, "start_gb": start_gb}}))
    return (launches, routes), (sdtw_launches, sdtw_routes)


def long_wave_record(samples):
    """``run_wav2vec2``'s synthetic wave (its first record's sine plus
    noise), ``samples`` long."""
    import numpy as np

    rng = np.random.default_rng(0)
    wave = (0.1 * np.sin(2 * np.pi * 180 * np.arange(samples) / SAMPLE_RATE)
            + 0.01 * rng.standard_normal(samples)).astype(np.float32)
    return {"id": "synthetic_long", "text": "the quick brown fox", "wave": wave}


def stitched_frames(cfg, samples, seq=W2V_SEQ, overlap=W2V_OVERLAP):
    """Frames the windowed wav2vec2 engine's stitch covers: the furthest
    window start (in frames) plus that window's encoder output."""
    from dynamic_asr_eval_tpu_torch.models.wav2vec2 import feat_extract_output_lengths
    from dynamic_asr_eval_tpu_torch.ops.chunk import chunk_starts_and_lengths

    starts, lens = chunk_starts_and_lengths(samples, seq, overlap)
    ds = cfg.downsampling_factor
    return max(int(s) // ds + feat_extract_output_lengths(cfg, int(n))
               for s, n in zip(starts, lens))


def check_wav2vec2_config(cfg):
    """The driver ran wav2vec2-base (``--full_size``) in f32."""
    base = dict(hidden=768, n_layers=12, n_heads=12, ff_dim=3072, conv_dim=512,
                pos_conv_kernel=128, pos_conv_groups=16, compute_dtype=torch.float32)
    got = {k: getattr(cfg, k) for k in base}
    if got != base:
        raise AssertionError(f"the driver ran {got}, not wav2vec2-base {base}")


def wav2vec2_path(card, A, S, D):
    """Phase 20: wav2vec2-base (``--full_size``, f32) through
    ``evals.run_wav2vec2.main``: (a) the chunked mode on a 60 s synthetic
    wave at 48000 / 16000 samples, its profile; (b) ``--per_utterance``
    (``ctc_mean``, clip 10) on the driver's own two 4 s records.  No kernel
    of the repository runs: 0 launches.  Returns (launches, routes) of (a)
    and (b) together."""
    from dynamic_asr_eval_tpu_torch.evals import run_wav2vec2
    from dynamic_asr_eval_tpu_torch.models.wav2vec2 import feat_extract_output_lengths
    from dynamic_asr_eval_tpu_torch.ops.chunk import chunk_starts_and_lengths

    modules = {"attention": A, "subsample": S, "softdtw": D}
    start_gb = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    records = run_wav2vec2._wave_records
    run_wav2vec2._wave_records = lambda args: [long_wave_record(W2V_SAMPLES)]
    try:
        wer, wall, launches, routes, detail, recorder = main_path(
            None, modules, run_wav2vec2, ("-d", "synthetic", "--full_size"))
    finally:
        run_wav2vec2._wave_records = records
    cfg = recorder.engine.model.config
    windows = len(chunk_starts_and_lengths(W2V_SAMPLES, W2V_SEQ, W2V_OVERLAP)[0])
    log(f"  WER {wer}; launches {launches}; driver wall {wall:.3f} s (first run) for "
        f"{W2V_SAMPLES / SAMPLE_RATE:.0f} s of audio in {windows} windows")
    check_wav2vec2_config(cfg)
    check_path_launches("wav2vec2", launches, routes, S.gx_launches, W2V_PLAN, windows=windows)
    if len(detail["model_output"]) != 1 or not math.isfinite(wer) or len(recorder.outputs) != 1:
        raise AssertionError(f"wav2vec2: driver result malformed: wer {wer}, "
                             f"{detail.get('model_output')}, {len(recorder.outputs)} calls")
    (out,), ((params, _),) = recorder.outputs, recorder.calls
    lp = out.numpy_logits()
    expect = (stitched_frames(cfg, W2V_SAMPLES), cfg.vocab_size)
    if lp.shape != expect or not torch.isfinite(torch.from_numpy(lp)).all():
        raise AssertionError(f"wav2vec2: stitched log-probs {lp.shape} (expected {expect}), "
                             f"finite {torch.isfinite(torch.from_numpy(lp)).all()}")
    moved = weight_change(out.params, params)
    if not moved > 0:
        raise AssertionError("wav2vec2: adaptation did not move the weights")
    log(f"  stitched {lp.shape}, finite; max weight change {moved:.3e}")
    log(f"[20a] where wav2vec2's time goes: the driver's engine, warm, on {card}")
    profile = profile_engine(recorder, card, "wav2vec2", W2V_SEQ, W2V_OVERLAP, windows,
                             W2V_SAMPLES, SAMPLE_RATE)
    del recorder

    log(f"[20b] evals.run_wav2vec2.main --full_size --per_utterance (ctc_mean, clip 10) on the "
        f"driver's own records ({len(W2V_UTTERANCES)} x {W2V_UTTERANCES[0]} samples)")
    u_wer, u_wall, u_launches, u_routes, u_detail, u_recorder = main_path(
        None, modules, run_wav2vec2, ("-d", "synthetic", "--full_size", "--per_utterance"))
    log(f"  WER {u_wer}; launches {u_launches}; driver wall {u_wall:.3f} s (first run)")
    check_path_launches("wav2vec2 per utterance", u_launches, u_routes, S.gx_launches, W2V_PLAN,
                        windows=len(W2V_UTTERANCES))
    engine = u_recorder.engine
    if (engine.loss_norm, engine.clip_norm) != ("ctc_mean", 10.0):
        raise AssertionError(f"per utterance: loss_norm {engine.loss_norm}, clip "
                             f"{engine.clip_norm}")
    if len(u_detail["model_output"]) != len(W2V_UTTERANCES) or not math.isfinite(u_wer):
        raise AssertionError(f"per utterance: driver result malformed: wer {u_wer}")
    u_moved = []
    for (params, utts), (outs, adapted, _) in zip(u_recorder.calls, u_recorder.outputs):
        lengths = [u["spectrogram"].shape[-1] for u in utts]
        u_moved.append(check_utterance_outputs(
            "wav2vec2 per utterance", outs, lengths,
            lambda T: feat_extract_output_lengths(cfg, T), cfg.vocab_size, adapted, params))
    if len(u_moved) != len(W2V_UTTERANCES):
        raise AssertionError(f"per utterance: {len(u_moved)} engine calls")
    warm_ms = warm_utterance_ms(engine, *u_recorder.calls[0])
    peak_gb = torch.cuda.max_memory_allocated() / 1e9 - start_gb
    log(f"  finite log-probs, weights moved ({min(u_moved):.3e}); warm per utterance "
        f"{warm_ms:.3f} ms; peak device memory {peak_gb:.2f} GB above the {start_gb:.2f} GB "
        f"held when the phase began")
    print(json.dumps({"wav2vec2_path": {
        "card": card, "samples": W2V_SAMPLES, "windows": windows, "seq": W2V_SEQ,
        "overlap": W2V_OVERLAP, "driver_wall_s": wall, "launches": launches,
        "weight_change": moved, "ms_per_window": profile["ms_per_window"],
        "rtfx": profile["rtfx"], "engine_walls_ms": profile["engine_walls_ms"],
        "per_utterance_driver_wall_s": u_wall, "per_utterance_launches": u_launches,
        "per_utterance_warm_ms": warm_ms, "per_utterance_samples": list(W2V_UTTERANCES),
        "peak_gb": peak_gb, "start_gb": start_gb}}))
    total = {k: tuple(a + b for a, b in zip(launches[k], u_launches[k])) for k in launches}
    total_routes = {k: {r: tuple(a + b for a, b in zip(c, u_routes[k][r]))
                        for r, c in by.items()} for k, by in routes.items()}
    return total, total_routes


# ---------------------------------------------------------------------------
# phases 21-21c: the encoder-decoder path
# ---------------------------------------------------------------------------

# launch_scripts/eval_list_encdec_deval.sh: -seq 2048 -o 0 -kwargs
# optim_lr=9e-6 epochs=1, on a 16384-frame recording (8 chunks)
ENCDEC_FRAMES, ENCDEC_SEQ = 16384, 2048
ENCDEC_CHUNKS = ENCDEC_FRAMES // ENCDEC_SEQ
ENCDEC_KWARGS = ["-kwargs", "optim_lr=9e-6", "epochs=1"]
# the launch script's filter stacks: "baseline" and "quality_plus_decode_agreement"
QUALITY_PLUS_DECODE_AGREEMENT = (
    "--teacher_filter_max_length", "--teacher_filter_max_consecutive_token_repeat",
    "--teacher_filter_repeated_token_ngrams", "--teacher_filter_repeated_words",
    "--teacher_filter_low_confidence", "--teacher_filter_ctc_agreement",
    "--teacher_filter_decode_agreement")
ENCDEC_RUNS = (("grpo", ("--training_mode", "grpo")),
               ("grpo_quality_plus_decode_agreement",
                ("--training_mode", "grpo") + QUALITY_PLUS_DECODE_AGREEMENT),
               ("teacher_ce", ("--training_mode", "teacher_ce")))
ENCDEC_PROFILED_CHUNKS = 2  # phase 21's trace: the recording's first 2 chunks
ENCDEC_BEAMS = 10  # phase 21b's joint CTC beam
ENCDEC_PARITY_LENGTHS = (2048, 1600)  # phase 21c: frames (multiples of 8), text 64 / 40
ENCDEC_PARITY_TEXT = (64, 40)


def encdec_config(**overrides):
    """The flagship encoder (``"pallas"`` subsampling unless overridden) with
    ``EncDecConfig``'s default decoder (4 x 512, 8 heads x 64, ff x4,
    ``max_text_len`` 256; f32 whatever the encoder's dtype, as in JAX)."""
    from dynamic_asr_eval_tpu_torch.models.encdec import EncDecConfig

    return EncDecConfig(encoder=flagship_config(**{"subsampling_impl": "pallas", **overrides}))


class BranchLog:
    """The branches of an enc-dec run, read by wrapping ``tta.encdec_rl`` for
    the run's length: every ``generate_encdec`` call (its sample count and
    whether it ran the encoder: the teacher, the rollouts and the final
    decode do; the agreement decode reuses the teacher's encoder output),
    every teacher-forced pass, and every update with its batch."""

    def __init__(self):
        self.generates, self.teacher_forced, self.updates = [], 0, []

    def __enter__(self):
        from dynamic_asr_eval_tpu_torch.tta import encdec_rl as R

        E = R.EncDecDynamicEvalEngine
        self._saved = (R.generate_encdec, E._teacher_forced, E._policy_loss, E._teacher_ce_loss)
        gen, tf, policy, ce = self._saved
        log_ = self

        def generate(model, audio, cfg, *args, encoder_out=None, **kwargs):
            log_.generates.append((kwargs.get("sample", 1), encoder_out is None))
            return gen(model, audio, cfg, *args, encoder_out=encoder_out, **kwargs)

        def teacher_forced(self, *args, **kwargs):
            log_.teacher_forced += 1
            return tf(self, *args, **kwargs)

        def policy_loss(self, audio, a_len, hyp_tokens, *args, **kwargs):
            log_.updates.append(hyp_tokens.shape[0])
            return policy(self, audio, a_len, hyp_tokens, *args, **kwargs)

        def teacher_ce_loss(self, audio, *args, **kwargs):
            log_.updates.append(audio.shape[0])
            return ce(self, audio, *args, **kwargs)

        R.generate_encdec = generate
        E._teacher_forced, E._policy_loss, E._teacher_ce_loss = (teacher_forced, policy_loss,
                                                                 teacher_ce_loss)
        return self

    def __exit__(self, *exc):
        from dynamic_asr_eval_tpu_torch.tta import encdec_rl as R

        E = R.EncDecDynamicEvalEngine
        R.generate_encdec, E._teacher_forced, E._policy_loss, E._teacher_ce_loss = self._saved
        return False

    @property
    def encodes(self):
        return sum(1 for _, encoded in self.generates if encoded)

    def rollouts(self, n=4):
        return sum(1 for sample, _ in self.generates if sample == n)

    def plan(self, n_layers):
        """The launches these branches make: a forward of every layer's
        attention and of the subsampling per encoder pass (the encoding
        generates, the teacher-forced passes, the updates' forwards), a
        backward of each per update."""
        fwd, bwd = self.encodes + self.teacher_forced + len(self.updates), len(self.updates)
        return {"attention": (n_layers * fwd, n_layers * bwd), "subsample": (fwd, bwd),
                "softdtw": (0, 0), "gx": 0}


def encdec_driver_run(driver, cfg, kernel_modules, tmp, vocab, flags=(), frames=ENCDEC_FRAMES):
    """An enc-dec driver's ``main`` on a ``frames``-frame ``synthetic_spec``
    recording with the launch script's settings, ``cfg`` its model (random
    from seed 0) and ``vocab`` its tokenizer, the counts zeroed just before
    and read just after; returns (wer, wall, launches, routes, detail, the
    recorder of its engine or None, the branch log)."""
    import pickle

    os.environ["DAE_SYNTH_SPEC_FRAMES"] = str(frames)
    args = driver.parse_args(["-d", "synthetic_spec", "--quiet", "-s", os.path.join(tmp, "r.pkl"),
                              "-seq", str(ENCDEC_SEQ), "-o", "0", "--tokenizer", vocab, *flags,
                              *ENCDEC_KWARGS])
    recorder, build = None, getattr(driver, "build_engine", None)
    if build is not None:
        recorder = EngineRecorder()
        driver.build_engine = recorder.wrap(build)
    try:
        with BranchLog() as branches:
            t0 = time.time()
            wer, launches, routes = counted(kernel_modules,
                                            lambda: driver.main(args, model_config=cfg))
            wall = time.time() - t0
    finally:
        if build is not None:
            driver.build_engine = build
    with open(os.path.join(tmp, "r_1.pkl"), "rb") as f:
        detail = pickle.load(f)
    return wer, wall, launches, routes, detail, recorder, branches


def check_encdec_run(what, cfg, wer, detail, recorder, branches, filtered):
    """One enc-dec TTA run: the branches add up (a teacher decode and a
    final decode of every chunk, a teacher-forced pass of every chunk where
    the filters need one, ``grpo``'s rollouts and updates at batch 4,
    ``teacher_ce``'s at batch 1), a finite WER and a transcript, finite
    adapted weights that moved where a chunk updated (and are the pristine
    ones where none did), ``pos_enc`` unchanged bit for bit.  Returns the
    largest weight change."""
    n, mode = ENCDEC_CHUNKS, recorder.engine.training_mode
    rollouts = branches.rollouts(recorder.engine.num_rollouts)
    teachers = sum(1 for s, e in branches.generates if s == 1 and e) - n  # less the final decode
    agreements = sum(1 for _, e in branches.generates if not e)
    want_batch = recorder.engine.num_rollouts if mode != "teacher_ce" else 1
    if not (teachers == n and agreements == (n if filtered else 0)
            and (0 < branches.teacher_forced <= n if filtered else branches.teacher_forced == 0)
            and (rollouts == 0 if mode == "teacher_ce" else rollouts <= n)
            and len(branches.updates) <= (rollouts if mode != "teacher_ce" else n)
            and all(b == want_batch for b in branches.updates)):
        raise AssertionError(f"{what}: branches {branches.generates}, {branches.teacher_forced} "
                             f"teacher-forced passes, updates at batches {branches.updates}")
    transcript = detail["model_output"]
    if len(transcript) != 1 or not transcript[0].strip() or not math.isfinite(wer):
        raise AssertionError(f"{what}: WER {wer}, transcript {transcript}")
    (params, _), (_, adapted, _) = recorder.calls[0], recorder.outputs[0]
    if not all(torch.isfinite(v.float()).all() for v in adapted.values()):
        raise AssertionError(f"{what}: non-finite adapted weights")
    if not torch.equal(adapted["pos_enc.weight"], params["pos_enc.weight"]):
        raise AssertionError(f"{what}: the frozen pos_enc moved")
    moved = weight_change(adapted, params)
    if (moved > 0) != bool(branches.updates):
        raise AssertionError(f"{what}: {len(branches.updates)} updates, max weight change "
                             f"{moved}")
    return moved


def encdec_timing(recorder, vocab_tok, card):
    """Phase 21's warm numbers on its first run's engine and recording: ms
    per decode step of the greedy teacher (batch 1) and of the rollouts
    (batch 4, sampled); the engine's call over the recording's first
    ENCDEC_PROFILED_CHUNKS chunks once untraced (ms per chunk, their final
    decode included) and once under torch.profiler: device busy time, idle
    share against the untraced wall, and the attention and subsampling
    kernels' share of busy."""
    from collections import defaultdict

    from dynamic_asr_eval_tpu_torch.models.encdec import generate_encdec

    engine, ((params, spec),) = recorder.engine, recorder.calls
    run = lambda s: engine(params, s, ENCDEC_SEQ, vocab_tok)  # noqa: E731
    chunk = torch.as_tensor(spec[..., :ENCDEC_SEQ], device="cuda").float().reshape(
        1, -1, ENCDEC_SEQ)
    length = torch.tensor([ENCDEC_SEQ], device="cuda")
    g = torch.Generator(device="cuda").manual_seed(0)
    steps = engine.max_generate
    teacher_ms = min(wall_ms(lambda: generate_encdec(
        engine._work, chunk, engine.config, max_generate=steps, length=length))
        for _ in range(3))
    rollout_ms = min(wall_ms(lambda: generate_encdec(
        engine._work, chunk, engine.config, generator=g, sample=engine.num_rollouts,
        greedy=False, max_generate=steps, length=length)) for _ in range(3))
    cut = spec[..., :ENCDEC_PROFILED_CHUNKS * ENCDEC_SEQ]
    cut_ms = wall_ms(lambda: run(cut))
    by_kernel = kernel_ms(lambda: run(cut), cpu=False)
    busy = sum(by_kernel.values())
    result = {"card": card, "warm_ms_per_chunk": cut_ms / ENCDEC_PROFILED_CHUNKS,
              "decode_steps": steps,
              "teacher_ms_per_decode_step": teacher_ms / steps,
              "rollout_ms_per_decode_step": rollout_ms / steps,
              "profiled_chunks": ENCDEC_PROFILED_CHUNKS, "profiled_wall_ms": cut_ms}
    if busy <= 0:
        result.update(device_busy_ms="not measured", idle_share="not measured")
    else:
        fams = defaultdict(float)
        for k, ms in by_kernel.items():
            fams[family(k)] += ms
        result.update(device_busy_ms=busy, idle_share=max(0.0, 1.0 - busy / cut_ms),
                      attention_share=fams["flash_attention"] / busy,
                      subsample_share=fams["fused_subsample"] / busy,
                      families_ms=dict(sorted(fams.items(), key=lambda kv: -kv[1])),
                      top_kernels_ms=[[k[:90], ms] for k, ms in sorted(
                          by_kernel.items(), key=lambda kv: -kv[1])[:TOP_KERNELS]])
    return result


def encdec_path(tmp, card, A, S, D):
    """Phase 21: ``evals.enc_dec_dynamic_eval_test.main`` at the flagship
    encoder (bf16, ``"pallas_flash"``, ``"pallas"``) with the default f32
    decoder, random from seed 0, on a 16384-frame recording with the launch
    script's settings, three times: ``grpo`` with no filter, ``grpo`` with
    the ``quality_plus_decode_agreement`` stack, ``teacher_ce``.  Launches
    exactly as each run's branches derive them, all bf16; the outputs as
    :func:`check_encdec_run` holds them; the first run's warm timing and
    profile.  Returns the three runs' launches and routes together."""
    from dynamic_asr_eval_tpu_torch.evals import enc_dec_dynamic_eval_test
    from dynamic_asr_eval_tpu_torch.text import load_tokenizer

    cfg = encdec_config()
    modules = {"attention": A, "subsample": S, "softdtw": D}
    vocab = write_vocab(tmp)
    start_gb = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    total, total_routes, runs, timing = None, None, {}, None
    for name, flags in ENCDEC_RUNS:
        wer, wall, launches, routes, detail, recorder, branches = encdec_driver_run(
            enc_dec_dynamic_eval_test, cfg, modules, tmp, vocab, flags)
        plan = branches.plan(cfg.encoder.n_layers)
        check_path_launches(f"enc-dec {name}", launches, routes, S.gx_launches, plan, windows=1)
        moved = check_encdec_run(f"enc-dec {name}", cfg, wer, detail, recorder, branches,
                                 filtered=name != "grpo" and name != "teacher_ce")
        runs[name] = {"driver_wall_s": wall, "wer": wer, "launches": launches,
                      "encoder_passes": plan["subsample"][0], "updates": len(branches.updates),
                      "update_batch": branches.updates[:1],
                      "rollouts": branches.rollouts(recorder.engine.num_rollouts),
                      "teacher_forced": branches.teacher_forced,
                      "weight_change": moved,
                      "transcript_words": len(detail["model_output"][0].split())}
        log(f"  {name}: WER {wer}; driver wall {wall:.3f} s (first run); launches {launches}, "
            f"all bf16, as the branches derive them: {plan['subsample'][0]} encoder passes, "
            f"{len(branches.updates)} updates at batch {branches.updates[:1]}, "
            f"{runs[name]['rollouts']} rollout decodes, {branches.teacher_forced} teacher-forced; "
            f"max weight change {moved:.3e}, pos_enc unchanged")
        if timing is None:
            log(f"[21a] where the enc-dec step's time goes: the first run's engine, warm, on "
                f"{card}")
            timing = encdec_timing(recorder, load_tokenizer(vocab), card)
            for key, val in timing.items():
                if key != "top_kernels_ms":
                    log(f"  {key}: {val}")
            for kname, ms in timing.get("top_kernels_ms", []):
                log(f"  {ms:9.3f} ms  {kname}")
        del recorder
        total = launches if total is None else {
            k: tuple(a + b for a, b in zip(total[k], launches[k])) for k in launches}
        total_routes = routes if total_routes is None else {
            k: {r: tuple(a + b for a, b in zip(c, routes[k][r])) for r, c in by.items()}
            for k, by in total_routes.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9 - start_gb
    log(f"  peak device memory {peak_gb:.2f} GB above the {start_gb:.2f} GB held when the phase "
        f"began")
    print(json.dumps({"encdec_path": {
        "card": card, "frames": ENCDEC_FRAMES, "seq": ENCDEC_SEQ, "chunks": ENCDEC_CHUNKS,
        "runs": runs, "timing": timing, "peak_gb": peak_gb, "start_gb": start_gb}}))
    return total, total_routes


def encdec_inference_path(tmp, card, A, S, D):
    """Phase 21b: ``evals.enc_dec_inference_test.main -mode default``
    (chunked greedy AR decode: exactly 6 / 0 attention and 1 / 0
    subsampling launches a chunk) and ``evals.enc_dec_ctc_beam_inference_test
    .main -beams 10`` (the whole recording's CTC branch: exactly one
    encoder pass) on phase 21's recording and model, all bf16; the card's
    beam against the CPU's (the same function on the same log-probs) on the
    first LM_CHECK_FRAMES frames.  Returns both runs' launches and routes
    together."""
    from dynamic_asr_eval_tpu_torch.evals import enc_dec_ctc_beam_inference_test
    from dynamic_asr_eval_tpu_torch.evals import enc_dec_inference_test as ed_inf
    from dynamic_asr_eval_tpu_torch.ops.beam_search import UniformLMAdapter, beam_search_device

    cfg = encdec_config()
    L = cfg.encoder.n_layers
    modules = {"attention": A, "subsample": S, "softdtw": D}
    vocab = write_vocab(tmp)
    wer, wall, launches, routes, detail, _, branches = encdec_driver_run(
        ed_inf, cfg, modules, tmp, vocab, ("-mode", "default"))
    check_path_launches("enc-dec inference", launches, routes, S.gx_launches,
                        {"attention": (L, 0), "subsample": (1, 0), "softdtw": (0, 0), "gx": 0},
                        windows=ENCDEC_CHUNKS)
    if len(branches.generates) != ENCDEC_CHUNKS or not math.isfinite(wer) \
            or not detail["model_output"][0].strip():
        raise AssertionError(f"enc-dec inference: {branches.generates}, WER {wer}, "
                             f"{detail['model_output']}")
    log(f"  -mode default: WER {wer}; driver wall {wall:.3f} s; launches {launches}, all bf16, "
        f"{ENCDEC_CHUNKS} chunks of one encoder pass each")

    seen = []

    def spy(log_probs, *args, **kwargs):
        seen.append(log_probs.detach().clone())
        return beam_search_device(log_probs, *args, **kwargs)

    ed_inf.beam_search_device = spy
    try:
        j_wer, j_wall, j_launches, j_routes, j_detail, _, _ = encdec_driver_run(
            enc_dec_ctc_beam_inference_test, cfg, modules, tmp, vocab,
            ("-beams", str(ENCDEC_BEAMS)))
    finally:
        ed_inf.beam_search_device = beam_search_device
    check_path_launches("enc-dec joint CTC beam", j_launches, j_routes, S.gx_launches,
                        {"attention": (L, 0), "subsample": (1, 0), "softdtw": (0, 0), "gx": 0},
                        windows=1)
    (lp,) = seen
    if lp.shape != (ENCDEC_FRAMES // cfg.encoder.subsampling_factor, cfg.encoder.n_classes) \
            or not torch.isfinite(lp).all() or not math.isfinite(j_wer):
        raise AssertionError(f"enc-dec joint: log-probs {tuple(lp.shape)}, WER {j_wer}")
    kw = dict(beam_width=ENCDEC_BEAMS, alpha=0.45, beta=1.53, prune_less_than_val=3.17)
    check = lp[:LM_CHECK_FRAMES]
    got = beam_search_device(check, UniformLMAdapter(cfg.vocab_size, device="cuda"), **kw)
    want = beam_search_device(check.cpu(), UniformLMAdapter(cfg.vocab_size, device="cpu"), **kw)
    diff = check_live_beams("enc-dec joint beam, card against CPU", got, want)
    log(f"  joint CTC beam (-beams {ENCDEC_BEAMS}): WER {j_wer}; driver wall {j_wall:.3f} s; "
        f"launches {j_launches}, all bf16; log-probs {tuple(lp.shape)}, finite; the card's beam "
        f"equals the CPU's on the first {check.shape[0]} frames (scores within {diff:.2e})")
    print(json.dumps({"encdec_inference": {
        "card": card, "frames": ENCDEC_FRAMES, "chunks": ENCDEC_CHUNKS,
        "default_wall_s": wall, "default_wer": wer, "default_launches": launches,
        "joint_wall_s": j_wall, "joint_wer": j_wer, "joint_launches": j_launches,
        "beams": ENCDEC_BEAMS, "check_frames": int(check.shape[0]),
        "check_max_rel_score_diff": diff}}))
    total = {k: tuple(a + b for a, b in zip(launches[k], j_launches[k])) for k in launches}
    total_routes = {k: {r: tuple(a + b for a, b in zip(c, j_routes[k][r]))
                        for r, c in by.items()} for k, by in routes.items()}
    return total, total_routes


def check_encdec_parity(A, S):
    """Phase 21c: the enc-dec at full depth in f32 through the f32 kernels
    (``"pallas_flash"``, ``"pallas"``: route ``"tf32x3"``) against the same
    weights on the plain path (``"xla"``, ``"conv"``), teacher-forced, on a
    batch of 2 at lengths that are multiples of 8, cuDNN deterministic: CTC
    log-probs on valid frames and decoder logits on valid text positions
    within 1e-3.  Returns the f32 routes' launches {module: (fwd, bwd)}."""
    from dynamic_asr_eval_tpu_torch.device import deterministic_cudnn
    from dynamic_asr_eval_tpu_torch.models.encdec import EncDecConformer, init_encdec

    kernel_cfg = encdec_config(compute_dtype=torch.float32)
    plain_cfg = encdec_config(compute_dtype=torch.float32, attention_impl="xla",
                              subsampling_impl="conv")
    kernel = init_encdec(kernel_cfg, seed=0).cuda().eval()
    plain = EncDecConformer(plain_cfg).cuda().eval()
    plain.load_state_dict(kernel.state_dict())
    g = torch.Generator(device="cuda").manual_seed(5)
    T = max(ENCDEC_PARITY_LENGTHS)
    x = torch.randn(len(ENCDEC_PARITY_LENGTHS), 80, T, generator=g, device="cuda")
    lengths = torch.tensor(ENCDEC_PARITY_LENGTHS, device="cuda")
    text = torch.randint(0, kernel_cfg.vocab_size, (len(ENCDEC_PARITY_TEXT),
                                                    max(ENCDEC_PARITY_TEXT)),
                         generator=g, device="cuda")
    text_lengths = torch.tensor(ENCDEC_PARITY_TEXT, device="cuda")
    with deterministic_cudnn(), torch.no_grad():
        a, launches, routes = counted({"attention": A, "subsample": S}, lambda: kernel(
            x, text, length=lengths, text_lengths=text_lengths))
        b = plain(x, text, length=lengths, text_lengths=text_lengths)
    torch.cuda.synchronize()
    ctc_err = max((a["final_posteriors_ctc"][i, :n] - b["final_posteriors_ctc"][i, :n])
                  .abs().max().item() for i, n in enumerate(a["length"].tolist()))
    lm_err = max((a["final_posteriors_lm"][i, :n] - b["final_posteriors_lm"][i, :n])
                 .abs().max().item() for i, n in enumerate(ENCDEC_PARITY_TEXT))
    f32 = {k: tuple(routes[k][m.ROUTES[torch.float32]]) for k, m in (("attention", A),
                                                                     ("subsample", S))}
    L = kernel_cfg.encoder.n_layers
    if not (ctc_err <= 1e-3 and lm_err <= 1e-3 and f32 == {"attention": (L, 0),
                                                           "subsample": (1, 0)}
            and launches == f32):
        raise AssertionError(f"enc-dec f32 parity: CTC {ctc_err:.3e}, decoder logits "
                             f"{lm_err:.3e} (> 1e-3?); launches {launches}, f32 route {f32}")
    log(f"  full-depth f32 enc-dec through the f32 kernels against the plain path: CTC "
        f"log-probs {ctc_err:.2e} on valid frames, decoder logits {lm_err:.2e} on valid "
        f"positions; f32 launches {f32}")
    return f32


# ---------------------------------------------------------------------------
# phases 22-23: NST finetuning and word-level LM fusion
# ---------------------------------------------------------------------------

HOP = 160  # audio.features' hop: a wave of (frames - 1) * HOP samples gives frames frames
TRAIN_FRAMES = 73728  # phase 22: each wav 737.28 s, 4.5 windows of TRAIN_SEQ
TRAIN_WAVS, TRAIN_SEQ, TRAIN_BATCH = 2, 16384, 4
TRAIN_PLAN = {"attention": (12, 6), "subsample": (2, 1), "softdtw": (0, 0), "gx": 0}  # a step
TRAIN_PROFILED_STEPS = 3
TRAIN_PARITY_LENGTHS = (16384, 8192, 0, 0)  # phase 22b: the trainer's last batch, widened
WORD_COUNTS = (20_000, 60_000, 60_000, 60_000)  # words, then drawn 2-, 3-, 4-grams (pre-dedup)
WORD_TEXT_WORDS = 120  # the words phase 23's log-probs spell
WORD_BEAMS = 20
TRAIN_DEVICE = "cuda"  # phases 22-23's device ("cpu" in the tests' rehearsals)


def train_steps() -> int:
    """NST steps of one of phase 22's recordings: its windows (overlap 0) in
    batches."""
    from dynamic_asr_eval_tpu_torch.ops.chunk import chunk_starts_and_lengths

    return -(-len(chunk_starts_and_lengths(TRAIN_FRAMES, TRAIN_SEQ, 0)[0]) // TRAIN_BATCH)


def write_wav(path, frames, seed=0):
    """A 16 kHz int16 wave of noise that featurizes to ``frames`` frames."""
    import wave

    import numpy as np

    x = np.random.default_rng(seed).uniform(-0.3, 0.3, (frames - 1) * HOP)
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(SAMPLE_RATE)
        w.writeframes((x * 32767).astype(np.int16).tobytes())
    return path


def train_yaml(path, ckpt_dir):
    """Phase 22's trainer yaml, in flow style (JSON): the flagship model
    (bf16, ``"pallas_flash"``, ``"pallas"``), lr 1e-5, batch 4 x 16384 frames,
    overlap 0, EMA 0.8, clip 0.8, 6 frequency masks of width < 34."""
    import dataclasses

    model = dataclasses.asdict(flagship_config(subsampling_impl="pallas"))
    model["compute_dtype"] = "bfloat16"
    raw = {"model": model, "optimizer": {"args": {"lr": 1e-5}},
           "scheduler": {"warmup_steps": 1},
           "training": {"batch_size": TRAIN_BATCH, "ema_decay": 0.8, "clip_value": 0.8,
                        "max_epochs": 1, "random_seed": 0},
           "audio_chunking": {"size": TRAIN_SEQ, "overlap": 0},
           "spec_augment": {"n_freq_masks": 6, "freq_mask_param": 34, "n_time_masks": 0},
           "checkpointing": {"dir": ckpt_dir}}
    with open(path, "w") as f:
        json.dump(raw, f, indent=1)
    return path


def flat(state):
    return torch.cat([v.float().flatten() for v in state.values()])


def check_ema_between(initial, trained, ema):
    """The EMA lies between the initial and the trained weights: projected
    on their difference, strictly inside (0, 1), and nearer the start than
    the trained weights are.  Returns (projection, |ema - init| / |trained -
    init|)."""
    d, e = flat(trained) - flat(initial), flat(ema) - flat(initial)
    proj = float((e @ d) / (d @ d))
    ratio = float(e.norm() / d.norm())
    if not (0.0 < proj < 1.0 and 0.0 < ratio < 1.0):
        raise AssertionError(f"EMA not between the initial and the trained weights: projection "
                             f"{proj:.4f}, norm ratio {ratio:.4f}")
    return proj, ratio


def check_resume(trainer, ckpt, cfg):
    """``NSTTrainer.resume`` of ``ckpt`` into a fresh trainer gives the
    weights, the EMA, MADGRAD's state and ``step_count`` bit for bit."""
    from dynamic_asr_eval_tpu_torch.models import init_conformer
    from dynamic_asr_eval_tpu_torch.train import NSTTrainer

    other = NSTTrainer(init_conformer(cfg, seed=1), None, cfg, trainer.cfg,
                       device=trainer.device)
    other.resume(ckpt)
    same = all(torch.equal(a, b) for a, b in zip(other.model.state_dict().values(),
                                                trainer.model.state_dict().values()))
    same &= all(torch.equal(a, b) for a, b in zip(other.teacher.state_dict().values(),
                                                 trainer.teacher.state_dict().values()))
    ours, theirs = other._opt_state(), trainer._opt_state()
    same &= ours["count"] == theirs["count"] and all(
        torch.equal(ours[k][n], theirs[k][n]) for k in ("grad_sum", "grad_sum_sq", "x0")
        for n in theirs[k])
    if not (same and other.step_count == trainer.step_count
            and other.recordings_seen == trainer.recordings_seen):
        raise AssertionError(f"resume of {ckpt}: weights, EMA or optimizer state differ, or "
                             f"steps {other.step_count} != {trainer.step_count}")
    del other


def train_timing(trainer, card):
    """Warm numbers of the trained trainer: ms per step over
    TRAIN_PROFILED_STEPS steps (a spectrogram of that many batches of whole
    windows), untraced, three times;
    then once under torch.profiler (the device's activity alone): device busy
    time, idle share against the fastest untraced wall, time by kernel
    family, the attention and subsampling kernels' share of busy."""
    from collections import defaultdict

    import numpy as np

    steps = TRAIN_PROFILED_STEPS
    spec = np.random.default_rng(5).standard_normal(
        (80, steps * TRAIN_BATCH * TRAIN_SEQ)).astype(np.float32)
    walls = [wall_ms(lambda: trainer.train_recording(spec)) for _ in range(3)]
    by_kernel = kernel_ms(lambda: trainer.train_recording(spec), cpu=False)
    busy, wall = sum(by_kernel.values()), min(walls)
    result = {"card": card, "steps": steps, "walls_ms": walls, "warm_ms_per_step": wall / steps}
    if busy <= 0:
        result.update(device_busy_ms="not measured", idle_share="not measured")
    else:
        fams = defaultdict(float)
        for k, ms in by_kernel.items():
            fams[family(k)] += ms
        result.update(device_busy_ms=busy, device_busy_ms_per_step=busy / steps,
                      idle_share=max(0.0, 1.0 - busy / wall),
                      attention_share=fams["flash_attention"] / busy,
                      subsample_share=fams["fused_subsample"] / busy,
                      kernels_share=(fams["flash_attention"] + fams["fused_subsample"]) / busy,
                      families_ms=dict(sorted(fams.items(), key=lambda kv: -kv[1])),
                      top_kernels_ms=[[k[:90], ms] for k, ms in sorted(
                          by_kernel.items(), key=lambda kv: -kv[1])[:TOP_KERNELS]])
    return result


def train_path(tmp, card, A, S, D):
    """Phase 22: ``train/cli.py main`` at the flagship width on two
    synthetic wavs (``--device`` TRAIN_DEVICE).  Returns the run's launches
    and routes."""
    import math

    import dynamic_asr_eval_tpu_torch.train.nst as nst
    from dynamic_asr_eval_tpu_torch.models import init_conformer
    from dynamic_asr_eval_tpu_torch.train import cli

    device = TRAIN_DEVICE
    t0 = time.time()
    records = [{"id": f"wav{i}", "text": "synthetic",
                "audio": write_wav(os.path.join(tmp, f"train{i}.wav"), TRAIN_FRAMES, seed=i)}
               for i in range(TRAIN_WAVS)]
    manifest = os.path.join(tmp, "train.json")
    with open(manifest, "w") as f:
        json.dump(records, f)
    ckpt_dir = os.path.join(tmp, "nst_ckpt")
    config = train_yaml(os.path.join(tmp, "train.yaml"), ckpt_dir)
    log(f"  {TRAIN_WAVS} wavs of {TRAIN_FRAMES} frames written in {time.time() - t0:.2f} s")

    steps = TRAIN_WAVS * train_steps()
    losses = []
    train_recording = nst.NSTTrainer.train_recording

    def recorded(self, *args, **kwargs):
        out = train_recording(self, *args, **kwargs)
        losses.append(out)
        return out

    start_gb = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    nst.NSTTrainer.train_recording = recorded
    try:
        t0 = time.time()
        trainer, launches, routes = counted({"attention": A, "subsample": S, "softdtw": D},
                                            lambda: cli.main(["-config", config, "--data",
                                                              manifest, "--device", device]))
        wall = time.time() - t0
    finally:
        nst.NSTTrainer.train_recording = train_recording
    peak_gb = torch.cuda.max_memory_allocated() / 1e9 - start_gb
    check_path_launches("trainer", launches, routes, S.gx_launches, TRAIN_PLAN, windows=steps)
    flat_losses = [x for rec in losses for x in rec]
    if not (len(flat_losses) == steps == trainer.step_count and len(losses) == TRAIN_WAVS
            and trainer.recordings_seen == TRAIN_WAVS and trainer.device.type == device
            and all(math.isfinite(x) for x in flat_losses)):
        raise AssertionError(f"trainer: losses {losses}, {trainer.step_count} steps, "
                             f"{trainer.recordings_seen} recordings on {trainer.device}; "
                             f"expected {steps} finite losses over {TRAIN_WAVS} recordings")
    cfg = trainer.model_config
    initial = {k: v.to(device) for k, v in init_conformer(cfg, seed=0).state_dict().items()}
    trained, ema = trainer.model.state_dict(), trainer.teacher.state_dict()
    moved = weight_change(trained, initial)
    proj, ratio = check_ema_between(initial, trained, ema)
    ckpt = os.path.join(ckpt_dir, "epoch_0.ckpt")
    if not (moved > 0 and os.path.exists(ckpt) and os.path.exists(ckpt + ".train_state.pkl")):
        raise AssertionError(f"trainer: weights moved {moved}, checkpoint {ckpt} written "
                             f"{os.path.exists(ckpt)}")
    check_resume(trainer, ckpt, cfg)
    log(f"  cli.main: {steps} steps over {TRAIN_WAVS} recordings in {wall:.3f} s (first run); "
        f"losses {flat_losses}; launches {launches}, all bf16, exactly {TRAIN_PLAN} a step; "
        f"max weight change {moved:.3e}; EMA at {proj:.3f} of the way (norm ratio {ratio:.3f}); "
        f"{ckpt} resumes bit for bit")
    log(f"[22a] where a training step's time goes: the trained trainer, warm, on {card}")
    timing = train_timing(trainer, card)
    for key, val in timing.items():
        if key != "top_kernels_ms":
            log(f"  {key}: {val}")
    for kname, ms in timing.get("top_kernels_ms", []):
        log(f"  {ms:9.3f} ms  {kname}")
    print(json.dumps({"train_path": {
        "card": card, "recordings": TRAIN_WAVS, "frames": TRAIN_FRAMES, "seq": TRAIN_SEQ,
        "batch": TRAIN_BATCH, "steps": steps, "losses": flat_losses, "first_wall_s": wall,
        "first_ms_per_step": wall / steps * 1e3, "launches": launches,
        "weight_change": moved, "ema_projection": proj, "timing": timing, "peak_gb": peak_gb,
        "start_gb": start_gb}}))
    del trainer
    return launches, routes


def check_train_parity(A, S):
    """Phase 22b: one NST step of the full-depth flagship in f32 through the
    f32 kernels (``"pallas_flash"``, ``"pallas"``: route ``"tf32x3"``) against
    the same weights on the plain path (``"xla"``, ``"conv"``), the
    augmentation off, cuDNN deterministic, on the trainer's batch of 4 x 16384
    frames with lengths 16384, 8192, 0, 0 (multiples of 8, where the two
    subsampling semantics agree): the loss within 1e-3 relative, the
    student's weight gradients within 1e-3 of each one's max |value| (or 1 %
    of the largest).  Returns the f32 routes' launches {module: (fwd, bwd)}."""
    from dynamic_asr_eval_tpu_torch.config import SpecAugmentConfig
    from dynamic_asr_eval_tpu_torch.device import deterministic_cudnn
    from dynamic_asr_eval_tpu_torch.models import SCConformer, init_conformer
    from dynamic_asr_eval_tpu_torch.train import NSTTrainer, TrainConfig

    device = TRAIN_DEVICE
    kernel_cfg = flagship_config(compute_dtype=torch.float32, subsampling_impl="pallas")
    plain_cfg = flagship_config(compute_dtype=torch.float32, attention_impl="xla",
                                subsampling_impl="conv")
    tcfg = TrainConfig(batch_size=len(TRAIN_PARITY_LENGTHS), seq_len=TRAIN_SEQ,
                       spec_augment=SpecAugmentConfig(n_freq_masks=0))
    kernel_model = init_conformer(kernel_cfg, seed=0)
    plain_model = SCConformer(plain_cfg)
    plain_model.load_state_dict(kernel_model.state_dict())
    g = torch.Generator(device=device).manual_seed(6)
    x = torch.randn(len(TRAIN_PARITY_LENGTHS), 80, TRAIN_SEQ, generator=g, device=device)
    lengths = torch.tensor(TRAIN_PARITY_LENGTHS, device=device)
    x = x * (torch.arange(TRAIN_SEQ, device=device)[None, None] < lengths[:, None, None])
    with deterministic_cudnn():
        kernel = NSTTrainer(kernel_model, None, kernel_cfg, tcfg, device=device)
        (loss_a, grads_a), launches, routes = counted(
            {"attention": A, "subsample": S}, lambda: kernel.loss_and_grads(x, lengths))
        names = list(kernel.named_params)
        grads_a = dict(zip(names, grads_a))
        del kernel
        plain = NSTTrainer(plain_model, None, plain_cfg, tcfg, device=device)
        loss_b, grads_b = plain.loss_and_grads(x, lengths)
        grads_b = dict(zip(names, grads_b))
        del plain
    torch.cuda.synchronize()
    loss_err = abs(float(loss_a) - float(loss_b)) / abs(float(loss_b))
    gerr = grad_err(grads_a, grads_b)
    f32 = {k: tuple(routes[k][m.ROUTES[torch.float32]]) for k, m in (("attention", A),
                                                                     ("subsample", S))}
    L = kernel_cfg.n_layers
    want = {"attention": (2 * L, L), "subsample": (2, 1)}
    if not (loss_err <= 1e-3 and gerr <= 1e-3 and f32 == want and launches == f32):
        raise AssertionError(f"NST step f32 parity: loss {float(loss_a)} vs {float(loss_b)} "
                             f"({loss_err:.3e} relative), weight gradients {gerr:.3e} of max "
                             f"(> 1e-3?); launches {launches}, f32 route {f32}, expected {want}")
    log(f"  full-depth f32 NST step through the f32 kernels against the plain path: loss "
        f"{float(loss_a):.6f} vs {float(loss_b):.6f} ({loss_err:.2e} relative), weight gradients "
        f"{gerr:.2e} of max; f32 launches {f32}")
    return f32


def write_word_arpa(directory, seed=0):
    """Phase 23's WORD-level 4-gram ARPA over WORD_COUNTS[0] words of letters,
    each one to three synthetic piece texts joined (1 to 9 letters), plus
    ``<s>``, ``</s>`` and ``<unk>``; higher orders as
    :func:`write_synthetic_lm` draws them.  Returns (ARPA path, words,
    n-grams per order)."""
    import numpy as np

    counts = WORD_COUNTS
    rng = np.random.default_rng(seed)
    texts = [p[1:] for p in synthetic_pieces(LM_VOCAB)]
    words = set()
    while len(words) < counts[0]:
        k = int(rng.integers(1, 4))
        words.add("".join(texts[int(i)] for i in rng.integers(0, len(texts), k)))
    words = sorted(words)
    names = np.array(["<s>", "</s>", "<unk>"] + words, dtype=object)
    grams = [np.arange(len(names))[:, None]]
    for n in counts[1:]:
        prev = grams[-1]
        rows = np.concatenate([prev[rng.integers(0, len(prev), n)],
                               rng.integers(3, len(names), (n, 1))], axis=1)
        grams.append(np.unique(rows, axis=0))
    arpa_path = os.path.join(directory, "word.arpa")
    with open(arpa_path, "w", encoding="utf-8") as f:
        f.write("\\data\\\n" + "".join(f"ngram {k + 1}={len(g)}\n" for k, g in enumerate(grams)))
        for k, g in enumerate(grams):
            logp = rng.uniform(-5.0, -0.5, len(g))
            lines = [" ".join(row) for row in names[g]]
            if k + 1 < len(grams):
                bo = rng.uniform(-1.0, 0.0, len(g))
                body = [f"{a:.4f}\t{w}\t{b:.4f}" for a, w, b in zip(logp, lines, bo)]
            else:
                body = [f"{a:.4f}\t{w}" for a, w in zip(logp, lines)]
            f.write(f"\n\\{k + 1}-grams:\n" + "\n".join(body) + "\n")
        f.write("\n\\end\\\n")
    return arpa_path, words, [len(g) for g in grams]


def word_log_probs(tok, words, seed=0):
    """Log-probs [T, V+1] spelling WORD_TEXT_WORDS lexicon words, with a blank
    frame between tokens, noise below the blank, and at every seventh token a
    rival within 0.5 of it (so the LM decides)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    text = " ".join(words[int(i)] for i in rng.integers(0, len(words), WORD_TEXT_WORDS))
    V = tok.vocab_size() + 1
    rows = []
    for j, tid in enumerate(tok.encode(text)):
        row = rng.uniform(-16, -10, V).astype(np.float32)
        row[V - 1], row[tid] = -6.0, 0.0
        if j % 7 == 3:
            row[int(rng.integers(0, V - 1))] = -float(rng.uniform(0.0, 0.5))
        rows += [row, np.where(np.arange(V) == V - 1, 0.0, row - 4).astype(np.float32)]
    lp = np.stack(rows)
    return (lp - np.log(np.exp(lp).sum(-1, keepdims=True))).astype(np.float32), text


def lexicon_beams(x, words, tok):
    """The beams of ``word_beam_search(x, words, tok, beam_width=WORD_BEAMS)``,
    built from its public pieces at its defaults: (tokens, lengths, scores)."""
    from dynamic_asr_eval_tpu_torch.ops.beam_search import UniformLMAdapter, beam_search_device
    from dynamic_asr_eval_tpu_torch.ops.lexicon import (
        LexiconConstrainedAdapter,
        build_lexicon_tables,
    )

    V = x.shape[1] - 1
    prefix_set, word_set = build_lexicon_tables(words, tok, x.device)
    adapter = LexiconConstrainedAdapter(UniformLMAdapter(V, device=x.device), prefix_set,
                                        word_set, tok.encode(" ")[0], V)
    return beam_search_device(x, adapter, beam_width=WORD_BEAMS, alpha=1.0, beta=0.0,
                              exclude_token_zero=False)


def word_fusion_path(tmp, card):
    """Phase 23: word-level fusion on the card, as the reference fuses a word
    4-gram with a character CTC model: ``build_ctcdecoder(...,
    lm_level="auto")`` on a synthetic word ARPA and ``word_beam_search`` over
    its words, with the character tokenizer, on TRAIN_DEVICE and on the CPU,
    on one set of log-probs: equal live beams (``check_live_beams``; the
    lexicon search's beams from :func:`lexicon_beams`) and texts."""
    from dynamic_asr_eval_tpu_torch.ops.lexicon import word_beam_search
    from dynamic_asr_eval_tpu_torch.ops.pyctc_compat import build_ctcdecoder
    from dynamic_asr_eval_tpu_torch.text import CharTokenizer

    t0 = time.time()
    arpa_path, words, counts = write_word_arpa(tmp)
    tok = CharTokenizer()
    lp, text = word_log_probs(tok, words)
    log(f"  word ARPA: {counts} n-grams by order over {len(words)} words, "
        f"{os.path.getsize(arpa_path) / 1e6:.1f} MB, written in {time.time() - t0:.2f} s; "
        f"log-probs [{lp.shape[0]}, {lp.shape[1]}] spelling {WORD_TEXT_WORDS} words")
    result = {"card": card, "ngrams_by_order": counts, "frames": int(lp.shape[0]),
              "vocab": tok.vocab_size()}
    beams, texts, lex_beams, lex_text = {}, {}, {}, {}
    for side, dev in (("card", TRAIN_DEVICE), ("cpu", "cpu")):
        t0 = time.time()
        dec = build_ctcdecoder(tok, arpa_path, alpha=0.5, beta=1.0, lm_level="auto", device=dev)
        load_s = time.time() - t0
        ad = dec.word_adapter
        if ad is None or ad.device.type != dev or ad.lm.reader != "native" or any(
                t.device.type != dev for t in ad.lm.keys.values()):
            raise AssertionError(f"build_ctcdecoder(lm_level='auto') on {dev}: word adapter "
                                 f"{ad}, tables not all on {dev} or not read natively")
        x = torch.as_tensor(lp, device=dev)
        beam_s = wall_ms(lambda: beams.__setitem__(side, dec.beams(x, WORD_BEAMS))) / 1e3
        texts[side] = dec.decode(x, WORD_BEAMS)
        lex_s = wall_ms(lambda: lex_text.__setitem__(side, word_beam_search(
            x, words, tok, beam_width=WORD_BEAMS))) / 1e3
        lex_beams[side] = lexicon_beams(x, words, tok)
        result[side] = {"load_s": load_s, "beam_s": beam_s,
                        "beam_ms_per_frame": beam_s / lp.shape[0] * 1e3,
                        "lexicon_beam_s": lex_s, "word_table_keys": int(ad.word_keys.numel()),
                        "prefix_table_keys": int(ad.prefix_keys.numel())}
    diff = check_live_beams("word-level fusion, card against CPU", beams["card"], beams["cpu"])
    lex_diff = check_live_beams("word_beam_search, card against CPU", lex_beams["card"],
                                lex_beams["cpu"])
    if not (texts["card"] == texts["cpu"] and texts["card"].strip()
            and lex_text["card"] == lex_text["cpu"] and lex_text["card"].strip()):
        raise AssertionError(f"word fusion: texts differ or are empty: {texts}, {lex_text}")
    spelled = text.split()
    decoded = texts["card"].split()
    lex_words = set(words)
    result.update(max_rel_score_diff=diff, lexicon_max_rel_score_diff=lex_diff,
                  words_decoded=len(decoded), words_spelled=len(spelled),
                  word_errors_vs_spelled=wer_counts_total(spelled, decoded),
                  lexicon_words_out_of_lexicon=sum(w not in lex_words
                                                   for w in lex_text["card"].split()))
    for key, val in result.items():
        log(f"  {key}: {val}")
    if result["lexicon_words_out_of_lexicon"]:
        raise AssertionError("word_beam_search returned words outside its lexicon")
    print(json.dumps({"word_fusion": result}))


# ---------------------------------------------------------------------------
# phase 3's vmap cases; phases 24-24d: records batching, the data-parallel
# drivers, rematerialisation
# ---------------------------------------------------------------------------

RECORDS_DEVICE = "cuda"  # phase 3's vmap cases and phases 24-24d ("cpu" in the rehearsals)
VMAP_R = 3
VMAP_ATTENTION = (2, 2048, 6, 128)  # B, T, H, D of each record
VMAP_LENGTHS = ((2048, 1600), (1792, 2048), (1000, 2048))
VMAP_SUBSAMPLE = (2, 16384, 80, 256)  # B, T, F, C of each record
RECORDS_FRAMES = (30720, 30720, 22528, 16384)  # phase 24's group: 9, 9, 5 and 1 windows
RECORDS_PROFILED_STEPS = 3
RECORDS_PARITY_FRAMES = (16384, 8192)  # phases 24b and 24c: one window each


def check_vmap(A, S):
    """Phase 3's vmap cases, bf16: each kernel ``autograd.Function`` under
    ``torch.func.vmap`` at R = VMAP_R against the per-record loop, bit for
    bit, forward and backward.  Attention [R, 2, 2048, 6, 128] (q, k, v
    views of one qkv tensor, as the model hands them) with ragged lengths:
    exactly one launch forward and one backward for the group; subsampling
    [R, 2, 16384, 80] with three distinct weight sets: one launch per record
    each way.  Returns {module: (fwd, bwd)} of the vmapped runs."""
    dev, R = RECORDS_DEVICE, VMAP_R
    g = torch.Generator(device=dev).manual_seed(3)
    B, T, H, D = VMAP_ATTENTION
    qkv = torch.randn(R, B, T, 3, H, D, generator=g, device=dev).to(torch.bfloat16)
    qkv.requires_grad_(True)
    mask = (torch.arange(T, device=dev)[None, None]
            < torch.tensor(VMAP_LENGTHS, device=dev)[..., None])
    dout = torch.randn(R, B, T, H, D, generator=g, device=dev).to(torch.bfloat16)

    def attention(x, m):
        return A.flash_attention(*x.unbind(2), m)

    def run_attention():
        out = torch.func.vmap(attention)(qkv, mask)
        out.backward(dout)
        return out

    out, attn_launches, attn_routes = counted({"attention": A}, run_attention)
    grad, qkv.grad = qkv.grad, None
    loop = torch.stack([attention(qkv[r], mask[r]) for r in range(R)])
    loop.backward(dout)
    torch.cuda.synchronize()
    if not (torch.equal(out, loop) and torch.equal(grad, qkv.grad)):
        raise AssertionError("attention under vmap differs from the per-record loop")
    if attn_launches["attention"] != (1, 1) or not bf16_only(attn_routes["attention"], (1, 1)):
        raise AssertionError(f"attention under vmap: launches {attn_launches}, by route "
                             f"{attn_routes}; expected one bf16 launch each way")
    log(f"  attention [{R}, {B}, {T}, {H}, {D}] under vmap, lengths {VMAP_LENGTHS}: out, dq, dk, "
        f"dv equal to the per-record loop bit for bit; launches {attn_launches['attention']}")

    Bs, Ts, Fs, C = VMAP_SUBSAMPLE
    x = torch.randn(R, Bs, Ts, Fs, generator=g, device=dev).to(torch.bfloat16)
    shapes = {"k9": (9, C), "dw1": (9, C), "dw2": (9, C), "pw1": (C, C), "pw2": (C, C)}
    ws = []  # subsample_inputs' scales, a set per record
    for name in S.WEIGHT_NAMES:
        scale = 1 / 3 if name in ("k9", "dw1", "dw2") else (C ** -0.5 if name.startswith("pw")
                                                             else 0.1)
        w = torch.randn((R,) + shapes.get(name, (C,)), generator=g, device=dev) * scale
        ws.append(w.requires_grad_(True))
    gout = torch.randn(R, Bs, S.ceil_chain(Ts)[2], Fs // 8, C, generator=g,
                       device=dev).to(torch.bfloat16)

    def run_subsample():
        out = torch.func.vmap(S.fused_subsample)(x, *ws)
        out.backward(gout)
        return out

    out, sub_launches, sub_routes = counted({"subsample": S}, run_subsample)
    grads = [w.grad for w in ws]
    for w in ws:
        w.grad = None
    loop = torch.stack([S.fused_subsample(x[r], *(w[r] for w in ws)) for r in range(R)])
    loop.backward(gout)
    torch.cuda.synchronize()
    if not (torch.equal(out, loop) and all(torch.equal(a, w.grad) for a, w in zip(grads, ws))):
        raise AssertionError("subsampling under vmap differs from the per-record loop")
    if sub_launches["subsample"] != (R, R) or not bf16_only(sub_routes["subsample"], (R, R)):
        raise AssertionError(f"subsampling under vmap: launches {sub_launches}, by route "
                             f"{sub_routes}; expected {R} bf16 launches each way")
    log(f"  subsampling [{R}, {Bs}, {Ts}, {Fs}] under vmap, {R} weight sets: out and the 10 "
        f"weight gradients equal to the per-record loop bit for bit; launches "
        f"{sub_launches['subsample']}")
    return {**attn_launches, **sub_launches}


def records_engine(cfg, frames, kwargs=()):
    """The NSTI engine ``evals.common.build_engine`` builds from phase 5's
    settings (``RUN_KWARGS``; seq SEQ, overlap OVERLAP) for ``cfg`` with
    random weights from seed 0 on RECORDS_DEVICE, and ``synthetic_spec``
    spectrograms of ``frames`` frames (seeds 0, 1, ...)."""
    from dynamic_asr_eval_tpu_torch.data import get_dataset
    from dynamic_asr_eval_tpu_torch.evals import common, run
    from dynamic_asr_eval_tpu_torch.models import init_conformer

    os.environ["DAE_SYNTH_SPEC_FRAMES"] = ",".join(str(n) for n in frames)
    args = run.parse_args(["-d", "synthetic_spec", "--quiet", "--device", RECORDS_DEVICE,
                           "-seq", str(SEQ), "-o", str(OVERLAP), *RUN_KWARGS, *kwargs])
    model = init_conformer(cfg, seed=0).to(RECORDS_DEVICE)
    engine = common.build_engine(args, model, cfg)
    specs = [rec["process_fn"](rec)[0] for rec in get_dataset("synthetic_spec", args.split)]
    return engine, specs


def records_plan(frames, n_layers):
    """Launches of one records-batched adaptation (online, 1 epoch): a group
    step per window of the longest record, each step one attention launch
    per layer each way for the whole group and one subsampling launch per
    record each way.  Returns (group steps, {module: (fwd, bwd)})."""
    steps = max(n_windows(n, SEQ, OVERLAP) if n > SEQ else 1 for n in frames)
    R = len(frames)
    return steps, {"attention": (n_layers * steps, n_layers * steps),
                   "subsample": (R * steps, R * steps)}


def check_records_launches(what, launches, routes, expect, route="tensor_core"):
    """Exactly ``expect`` ({module: (fwd, bwd)}), every launch on ``route``."""
    for name, want in expect.items():
        by_route = routes[name]
        if tuple(launches[name]) != tuple(want) or any(
                tuple(c) != (tuple(want) if r == route else (0, 0)) for r, c in by_route.items()):
            raise AssertionError(f"{what}: {name} launches {launches[name]}, by route "
                                 f"{by_route}; expected {want} on {route}")


def frame_agreement(a, b):
    """(max |a - b| of two stitched outputs' log-probs, the share of frames
    whose most likely class is the same)."""
    la, lb = a.numpy_logits(), b.numpy_logits()
    return float(abs(la - lb).max()), float((la.argmax(-1) == lb.argmax(-1)).mean())


def records_path(card, A, S):
    """Phase 24: ``engine.batched`` on RECORDS_FRAMES at the flagship width
    (bf16, ``"pallas_flash"``, ``"pallas"``), phase 5's TTA settings, each
    record seeded as the serial run of it; then each record through the
    serial engine with the same seed.  Returns the batched run's launches
    and routes."""
    cfg = flagship_config(subsampling_impl="pallas")
    engine, specs = records_engine(cfg, RECORDS_FRAMES)
    seeds = list(range(len(specs)))
    steps, plan = records_plan(RECORDS_FRAMES, cfg.n_layers)
    start = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    outs, launches, routes = counted({"attention": A, "subsample": S}, lambda: engine.batched(
        None, specs, SEQ, OVERLAP, rngs=seeds, return_params=True))
    first_s = time.time() - t0
    peak_gb = (torch.cuda.max_memory_allocated() - start) / 1e9
    check_records_launches("records batching", launches, routes, plan)
    params = {k: v.detach().clone() for k, v in engine.model.state_dict().items()}
    serial = [engine(None, s, SEQ, OVERLAP, rng=seed) for s, seed in zip(specs, seeds)]
    per_record = []
    for r, (out, ref) in enumerate(zip(outs, serial)):
        lp = out.numpy_logits()
        want = (-(-RECORDS_FRAMES[r] // cfg.subsampling_factor), cfg.n_classes)
        moved = weight_change(out.params, params)
        if lp.shape != want or not torch.isfinite(torch.from_numpy(lp)).all() or not moved > 0:
            raise AssertionError(f"records batching, record {r}: log-probs {lp.shape} (expected "
                                 f"{want}), finite {torch.isfinite(torch.from_numpy(lp)).all()}, "
                                 f"weights moved {moved}")
        err, same = frame_agreement(out, ref)
        per_record.append({"frames": RECORDS_FRAMES[r], "max_abs_log_prob_diff": err,
                           "same_argmax_share": same, "max_weight_change": moved})
        log(f"  record {r} ({RECORDS_FRAMES[r]} frames): stitched {lp.shape}, finite, weights "
            f"moved {moved:.3e}; against its serial run: max |d log-prob| {err:.3e}, "
            f"{same:.4f} of frames with the same argmax")
    group_ms = min(wall_ms(lambda: engine.batched(None, specs, SEQ, OVERLAP, rngs=seeds))
                   for _ in range(TIMED_RUNS))
    serial_ms = min(wall_ms(lambda: engine(None, specs[0], SEQ, OVERLAP, rng=0))
                    for _ in range(TIMED_RUNS)) / n_windows(RECORDS_FRAMES[0], SEQ, OVERLAP)
    cut = [s[..., : SEQ + (RECORDS_PROFILED_STEPS - 1) * (SEQ - OVERLAP)] for s in specs]
    cut_ms = wall_ms(lambda: engine.batched(None, cut, SEQ, OVERLAP, rngs=seeds))
    by_kernel = kernel_ms(lambda: engine.batched(None, cut, SEQ, OVERLAP, rngs=seeds), cpu=False)
    busy = sum(by_kernel.values())
    result = {"card": card, "records": len(specs), "frames": list(RECORDS_FRAMES),
              "group_steps": steps, "launches": launches, "first_call_s": first_s,
              "peak_gb_above_start": peak_gb, "per_record": per_record,
              "warm_group_ms": group_ms, "group_ms_per_step": group_ms / steps,
              "serial_ms_per_window": serial_ms,
              "serial_ms_for_group_step": len(specs) * serial_ms,
              "profiled_steps": RECORDS_PROFILED_STEPS, "profiled_wall_ms": cut_ms}
    if busy <= 0:
        result.update(device_busy_ms="not measured", idle_share="not measured")
    else:
        from collections import defaultdict

        fams = defaultdict(float)
        for k, ms in by_kernel.items():
            fams[family(k)] += ms
        result.update(device_busy_ms=busy, device_busy_ms_per_step=busy / RECORDS_PROFILED_STEPS,
                      idle_share=max(0.0, 1.0 - busy / cut_ms),
                      families_ms=dict(sorted(fams.items(), key=lambda kv: -kv[1])))
    log(f"  launches {launches} over {steps} group steps; first call {first_s:.3f} s; peak "
        f"{peak_gb:.2f} GB above the phase's start; warm group {group_ms:.2f} ms, "
        f"{group_ms / steps:.2f} ms a group step of {len(specs)} records against "
        f"{len(specs)} x {serial_ms:.2f} ms serial window steps; over {RECORDS_PROFILED_STEPS} "
        f"group steps: wall {cut_ms:.2f} ms, device busy {result['device_busy_ms']}, idle "
        f"share {result['idle_share']}")
    print(json.dumps({"records_path": result}))
    return launches, routes


def check_records_parity(A, S):
    """Phase 24b: ``engine.batched`` at the flagship widths in f32 (TF32
    off, the ``"tf32x3"`` kernels) on RECORDS_PARITY_FRAMES against the
    serial engine on each record with the same seed, cuDNN deterministic:
    log-probs within 1e-4 of max |log-prob| and the same greedy ids.
    Returns the f32 route's launches {module: (fwd, bwd)}."""
    from dynamic_asr_eval_tpu_torch.device import deterministic_cudnn

    cfg = flagship_config(compute_dtype=torch.float32, subsampling_impl="pallas")
    engine, specs = records_engine(cfg, RECORDS_PARITY_FRAMES)
    seeds = list(range(len(specs)))
    _, plan = records_plan(RECORDS_PARITY_FRAMES, cfg.n_layers)
    with deterministic_cudnn():
        outs, launches, routes = counted({"attention": A, "subsample": S},
                                         lambda: engine.batched(None, specs, SEQ, OVERLAP,
                                                                rngs=seeds))
        serial = [engine(None, s, SEQ, OVERLAP, rng=seed) for s, seed in zip(specs, seeds)]
    check_records_launches("records batching, f32", launches, routes, plan, route="tf32x3")
    for r, (out, ref) in enumerate(zip(outs, serial)):
        err, _ = frame_agreement(out, ref)
        scale = float(abs(ref.numpy_logits()).max())
        same = bool((out.greedy_ids() == ref.greedy_ids()).all()
                    if len(out.greedy_ids()) == len(ref.greedy_ids()) else False)
        if not (err <= 1e-4 * scale and same):
            raise AssertionError(f"records batching f32, record {r}: max |d log-prob| {err:.3e} "
                                 f"(max |log-prob| {scale:.3e}), greedy ids equal {same}")
        log(f"  record {r} ({RECORDS_PARITY_FRAMES[r]} frames): max |d log-prob| {err:.3e} of "
            f"max {scale:.3e} against its serial run; greedy ids equal")
    log(f"  f32 launches {launches}")
    return {k: tuple(launches[k]) for k in launches}


def records_driver_path(card, A, S):
    """Phase 24c: ``evals/run.py main`` at world size 1 (NCCL on the card)
    on RECORDS_PARITY_FRAMES, f32, TF32 off, cuDNN deterministic: with
    ``--dp_records`` (online) against the serial driver, and with ``--dp``
    (offline) against the serial driver offline: the same transcripts and
    WER, and each record's stitched log-probs (read from the engine the
    driver built) within 1e-4 of max |log-prob| with the same greedy ids.
    Returns the ``--dp_records`` and ``--dp`` runs' f32 launches together
    {module: (fwd, bwd)}."""
    import pickle

    import torch.distributed as dist

    from dynamic_asr_eval_tpu_torch.device import deterministic_cudnn
    from dynamic_asr_eval_tpu_torch.evals import run

    cfg = flagship_config(compute_dtype=torch.float32, subsampling_impl="pallas")
    os.environ["DAE_SYNTH_SPEC_FRAMES"] = ",".join(str(n) for n in RECORDS_PARITY_FRAMES)
    runs = {}
    build_engine = run.build_engine
    for name, flags, kwargs in (("serial", (), ()), ("dp_records", ("--dp_records",), ()),
                                ("serial_offline", (), ("online=false",)),
                                ("dp", ("--dp",), ("online=false",))):
        recorder = EngineRecorder()
        with tempfile.TemporaryDirectory() as tmp:
            args = run.parse_args(["-d", "synthetic_spec", "--quiet", "--device", RECORDS_DEVICE,
                                   "-s", os.path.join(tmp, "r.pkl"), "-seq", str(SEQ), "-o",
                                   str(OVERLAP), *flags, *RUN_KWARGS, *kwargs])
            run.build_engine = recorder.wrap(build_engine)
            t0 = time.time()
            try:
                with deterministic_cudnn():
                    wer, launches, _ = counted({"attention": A, "subsample": S},
                                               lambda: run.main(args, model_config=cfg))
            finally:
                run.build_engine = build_engine
            wall = time.time() - t0
            with open(os.path.join(tmp, "r_1.pkl"), "rb") as f:
                detail = pickle.load(f)
        runs[name] = (wer, detail, launches, recorder.outputs)
        log(f"  {name}: WER {wer}, {wall:.2f} s, launches {launches}, greedy ids a record "
            f"{[len(o.greedy_ids()) for o in recorder.outputs]}")
    for name, ref in (("dp_records", "serial"), ("dp", "serial_offline")):
        (wer, detail, _, outs), (ref_wer, ref_detail, _, ref_outs) = runs[name], runs[ref]
        if not (wer == ref_wer and detail["model_output"] == ref_detail["model_output"]
                and set(detail) == set(ref_detail) and len(outs) == len(ref_outs)):
            raise AssertionError(f"{name}: WER {wer}, transcripts {detail['model_output']}; "
                                 f"{ref}: WER {ref_wer}, {ref_detail['model_output']}")
        for r, (out, want) in enumerate(zip(outs, ref_outs)):
            err, _ = frame_agreement(out, want)
            scale = float(abs(want.numpy_logits()).max())
            same = (len(out.greedy_ids()) == len(want.greedy_ids())
                    and bool((out.greedy_ids() == want.greedy_ids()).all()))
            if not (err <= 1e-4 * scale and same):
                raise AssertionError(f"{name}, record {r}: max |d log-prob| {err:.3e} against "
                                     f"{ref} (max |log-prob| {scale:.3e}), greedy ids equal {same}")
            log(f"  {name}, record {r}: max |d log-prob| {err:.3e} of max {scale:.3e} against "
                f"{ref}; greedy ids equal")
    if not (dist.is_initialized() and dist.get_world_size() == 1):
        raise AssertionError("the data-parallel drivers left no process group of 1")
    backend = dist.get_backend()
    dist.destroy_process_group()
    log(f"  --dp_records and --dp give the serial driver's transcripts and WER (world size 1, "
        f"{backend})")
    return {k: tuple(a + b for a, b in zip(runs["dp_records"][2][k], runs["dp"][2][k]))
            for k in runs["dp"][2]}


def remat_path(card, A, S):
    """Phase 24d: one NSTI window step (a SEQ-frame recording, ``adapt_only``)
    at the flagship width, bf16, with ``checkpoint_every_n_layers=1,
    remat_subsampling=True`` beside the same step without, twice: the
    updated weights equal bit for bit, or within the spread of the two runs
    without; each run's peak memory; the recomputation's extra forward
    launches (one attention a layer, one subsampling).  Returns the remat
    run's launches and routes."""
    from dynamic_asr_eval_tpu_torch.evals import common, run
    from dynamic_asr_eval_tpu_torch.models import SCConformer

    cfg = flagship_config(subsampling_impl="pallas")
    remat_cfg = flagship_config(subsampling_impl="pallas", checkpoint_every_n_layers=1,
                                remat_subsampling=True)
    engine, (spec,) = records_engine(cfg, (SEQ,))
    model = SCConformer(remat_cfg).to(RECORDS_DEVICE)
    model.load_state_dict(engine.model.state_dict())
    args = run.parse_args(["-d", "synthetic_spec", "--quiet", "--device", RECORDS_DEVICE,
                           "-seq", str(SEQ), "-o", str(OVERLAP), *RUN_KWARGS])
    remat_engine = common.build_engine(args, model, remat_cfg)
    L = cfg.n_layers
    expect = {"plain": {"attention": (L, L), "subsample": (1, 1)},
              "remat": {"attention": (2 * L, L), "subsample": (2, 1)}}
    runs = {}
    for name, eng in (("plain", engine), ("plain_again", engine), ("remat", remat_engine)):
        start = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out, launches, routes = counted({"attention": A, "subsample": S}, lambda: eng(
            None, spec, SEQ, OVERLAP, rng=0, adapt_only=True))
        peak_gb = (torch.cuda.max_memory_allocated() - start) / 1e9
        check_records_launches(f"remat phase, {name}", launches, routes,
                               expect["remat" if name == "remat" else "plain"])
        runs[name] = (out.params, launches, routes, peak_gb)
    base = runs["plain"][0]

    def spread(other):
        return max((other[k].float() - base[k].float()).abs().max().item() for k in base)

    noise, diff = spread(runs["plain_again"][0]), spread(runs["remat"][0])
    if not diff <= noise:
        raise AssertionError(f"remat: updated weights {diff:.3e} from the plain step's, beyond "
                             f"the spread of two plain steps {noise:.3e}")
    result = {"card": card, "frames": SEQ, "max_weight_diff": diff, "plain_spread": noise,
              "bit_for_bit": diff == 0.0, "peak_gb_above_start":
                  {k: v[3] for k, v in runs.items()},
              "launches": {k: v[1] for k, v in runs.items()},
              "weight_change": weight_change(base, engine.model.state_dict())}
    log(f"  remat step: weights {diff:.3e} from the plain step's (two plain steps: {noise:.3e}); "
        f"peak above start {result['peak_gb_above_start']}; launches {result['launches']}")
    print(json.dumps({"remat": result}))
    return runs["remat"][1], runs["remat"][2]


# ---------------------------------------------------------------------------
# phase 25: tensor and sequence parallelism
# ---------------------------------------------------------------------------

PARALLEL_RANK = "CHIP_SMOKE_PARALLEL_RANK"  # set in phase 25's two rank processes: their out dir
TP_FRAMES = SEQ + (SEQ - OVERLAP)  # phase 25a: a 3-window recording
SP_LENGTHS = (16384, 12800)  # phase 25b: frames of a batch of 2 (T_ds 2048, 1024 a rank)
QB_SHAPE = (2, 2048, 6, 128)  # phase 25c: B, Tk, H, D; two query blocks of 1024 rows
QB_LENGTHS = [2048, 1600]
QB_RAGGED = (300, 700)  # phase 25c: a block of 700 rows from row 300, inside a tile


def check_query_block(A, dtype):
    """Phase 25c: the attention kernels on one query block: q [2, 1024, 6,
    128] (rows 0 and 1024 of the sequence) against k, v [2, 2048, 6, 128],
    lengths 2048 and 1600.  Each block against the plain version at phase
    3's bar; its out, lse and dq rows the full call's bit for bit (the
    blocks start on a query-tile boundary); the blocks' dk and dv summed
    against the full call's (bf16: within BF16_ULPS bf16 ulps of max, f32:
    phase 3's bar); a block of 700 rows from row 300 against the plain
    version; each block's CUDA-event times beside the full call's.  Returns
    {"fwd"/"bwd": (block ms, full ms)} and the max |err| against the plain
    version."""
    B, Tk, H, D = QB_SHAPE
    q, k, v, mask, dout = attention_inputs(B, Tk, H, D, QB_LENGTHS, dtype, seed=5)
    full_out, full_lse = A.flash_attention_fwd(q, k, v, mask)
    full = A.flash_attention_bwd(q, k, v, mask, full_out, full_lse, dout)
    what = f"query block {dtype}"
    n = Tk // 2
    sums = [torch.zeros(B, Tk, H, D, device="cuda") for _ in range(2)]
    worst, block_ms = 0.0, {"fwd": [], "bwd": []}
    for offset, rows in ((0, n), (n, n), QB_RAGGED):
        qb, db = q[:, offset : offset + rows], dout[:, offset : offset + rows]
        out, lse = A.flash_attention_fwd(qb, k, v, mask, offset)
        grads = A.flash_attention_bwd(qb, k, v, mask, out, lse, db, offset)
        ref_out, ref_lse = A.attention_reference(qb.float(), k.float(), v.float(), mask, offset)
        ref = A.attention_reference_bwd(qb.float(), k.float(), v.float(), mask, ref_out, ref_lse,
                                        db.float(), offset)
        torch.cuda.synchronize()
        name = f"{what}, rows {offset}-{offset + rows}"
        errs = check_close(name, zip(("out", "dq", "dk", "dv"), (out,) + tuple(grads),
                                     (ref_out,) + tuple(ref)), FWD_TOL[dtype])
        worst = max(worst, *errs.values())
        line = ", ".join(f"{k_} {v_:.2e}" for k_, v_ in errs.items())
        if rows == n:
            sl = slice(offset, offset + rows)
            if not (torch.equal(out, full_out[:, sl]) and torch.equal(lse, full_lse[..., sl])
                    and torch.equal(grads[0], full[0][:, sl])):
                raise AssertionError(f"{name}: out, lse and dq rows differ from the full call's")
            sums[0] += grads[1].float()
            sums[1] += grads[2].float()
            block_ms["fwd"].append(cuda_ms(lambda: A.flash_attention_fwd(qb, k, v, mask, offset)))
            block_ms["bwd"].append(cuda_ms(lambda: A.flash_attention_bwd(qb, k, v, mask, out, lse,
                                                                         db, offset)))
            line += "; out, lse and dq rows the full call's bit for bit"
        log(f"  {name} against the plain version: {line}")
    for name, got, want in (("dk", sums[0], full[1]), ("dv", sums[1], full[2])):
        scale = want.float().abs().max().item()
        err = (got - want.float()).abs().max().item()
        if dtype == torch.bfloat16:
            ulps = err / bf16_ulp(scale)
            ok, shown = ulps <= BF16_ULPS, f"{ulps:.3f} bf16 ulps of max"
        else:
            ok, shown = err <= FWD_TOL[dtype] * scale, f"{err:.3e} of max {scale:.3e}"
        if not ok:
            raise AssertionError(f"{what}: the blocks' {name} summed, against the full call: "
                                 f"{shown}")
        log(f"  {what}: the two blocks' {name} summed against the full call's: {shown}")
    timing = {kind: (block_ms[kind], cuda_ms(fn)) for kind, fn in (
        ("fwd", lambda: A.flash_attention_fwd(q, k, v, mask)),
        ("bwd", lambda: A.flash_attention_bwd(q, k, v, mask, full_out, full_lse, dout)))}
    log(f"  {what} ms, block 0 and block 1 beside the full call: " + "; ".join(
        f"{kind} {b[0]:.4f}, {b[1]:.4f} / {f:.4f}" for kind, (b, f) in timing.items()))
    return timing, worst


def parallel_engine(cfg, tp: int, frames: int, epochs: int = 1):
    """Phase 25a: the NSTI engine ``evals.common.build_engine`` builds from
    phase 5's settings on ``cuda:0`` (``--dp --tp tp`` where ``tp`` is above
    1: a ``('dp', 'tp')`` mesh over the two ranks; ``epochs`` 0: windowed
    inference), random weights from seed 0, and a ``synthetic_spec``
    recording of ``frames`` frames."""
    from dynamic_asr_eval_tpu_torch.data import get_dataset
    from dynamic_asr_eval_tpu_torch.evals import common, run
    from dynamic_asr_eval_tpu_torch.models import init_conformer

    os.environ["DAE_SYNTH_SPEC_FRAMES"] = str(frames)
    flags = ["--dp", "--tp", str(tp)] if tp > 1 else []
    args = run.parse_args(["-d", "synthetic_spec", "--quiet", "--device", "cuda:0",
                           "-seq", str(SEQ), "-o", str(OVERLAP), *flags, *RUN_KWARGS,
                           f"epochs={epochs}"])
    model = init_conformer(cfg, seed=0).to("cuda:0")
    engine = common.build_engine(args, model, cfg)
    (rec,) = get_dataset("synthetic_spec", args.split)
    return engine, rec["process_fn"](rec)[0]


class AttentionShapes:
    """Within ``with``: the (H, Tq, Tk, q_offset) of every attention kernel
    launch forward (a spy on ``kernels.attention._kernel_fwd``)."""

    def __init__(self, A):
        self.A, self.calls = A, []

    def __enter__(self):
        inner = self.inner = self.A._kernel_fwd

        def spy(q, k, v, seg, q_offset=0):
            self.calls.append((q.shape[2], q.shape[1], k.shape[1], q_offset))
            return inner(q, k, v, seg, q_offset)

        self.A._kernel_fwd = spy
        return self

    def __exit__(self, *exc):
        self.A._kernel_fwd = self.inner


def tp_rank_phase(A, S):
    """Phase 25a in one rank: the 3-window NSTI run at tp 2 (bf16 flagship,
    ``"pallas_flash"``, ``"pallas"``) and the same run at tp 1, then both in
    f32 at 2 layers (TF32 off, cuDNN deterministic), where the tp 1 run goes
    twice: the run's own repeat spread (CTC's CUDA backward sums with
    atomics, and 3 windows of MADGRAD carry it on) printed beside the tp
    difference, neither held.  What holds f32 tp 2 to tp 1 is what
    separates a sharding fault from that noise (:func:`tp_held_f32`)."""
    from dynamic_asr_eval_tpu_torch.device import deterministic_cudnn

    result = {}
    for name, cfg in (("bf16", flagship_config(subsampling_impl="pallas")),
                      ("f32", flagship_config(compute_dtype=torch.float32, n_layers=2,
                                              subsampling_impl="pallas"))):
        outs = {}
        for tp in (2, 1) if name == "bf16" else (2, 1, "repeat"):
            if tp == "repeat":
                engine, spec = parallel_engine(cfg, 1, TP_FRAMES)
                with deterministic_cudnn():
                    again = engine(None, spec, SEQ, OVERLAP, rng=0)
                result[name]["repeat_max_abs_log_prob_diff"] = frame_agreement(again, outs[1])[0]
                del engine
                continue
            engine, spec = parallel_engine(cfg, tp, TP_FRAMES)
            with deterministic_cudnn(), AttentionShapes(A) as shapes:
                t0 = time.time()
                out, launches, routes = counted({"attention": A, "subsample": S},
                                                lambda: engine(None, spec, SEQ, OVERLAP, rng=0))
                wall = time.time() - t0
            outs[tp] = out
            if tp == 2:
                result[name] = {"launches": launches, "routes": routes, "wall_s": wall,
                                "heads": sorted({c[0] for c in shapes.calls}),
                                "layers": cfg.n_layers, "windows": n_windows(TP_FRAMES)}
            del engine
        err, same = frame_agreement(outs[2], outs[1])
        scale = float(abs(outs[1].numpy_logits()).max())
        result[name].update(max_abs_log_prob_diff=err, same_argmax_share=same, scale=scale,
                            greedy_equal=greedy_equal(outs[2], outs[1]))
        if name == "f32":
            result[name]["held"] = tp_held_f32(cfg, spec)
    return result


def greedy_equal(a, b) -> bool:
    ia, ib = a.greedy_ids(), b.greedy_ids()
    return bool(len(ia) == len(ib) and (ia == ib).all())


def tp_held_f32(cfg, spec):
    """Phase 25a's held f32 checks at tp 2 against tp 1: (1) the engine's
    windowed inference before any adaptation (``epochs=0``, 3 windows):
    log-probs and greedy ids; (2) one forward and backward of the first
    window through a model sliced by ``shard_params`` on ``make_mesh(tp=2)``
    and through the whole model: the weight gradients of a fixed linear
    functional of the valid frames' log-probs, each rank's slices against
    the same slices of the whole gradients (as 25b holds sequence
    parallelism)."""
    import copy

    from dynamic_asr_eval_tpu_torch.device import deterministic_cudnn
    from dynamic_asr_eval_tpu_torch.models import init_conformer
    from dynamic_asr_eval_tpu_torch.parallel import make_mesh, shard_params
    from dynamic_asr_eval_tpu_torch.parallel.mesh import shard_state

    outs = {}
    for tp in (2, 1):
        engine, spec = parallel_engine(cfg, tp, TP_FRAMES, epochs=0)
        with deterministic_cudnn():
            outs[tp] = engine(None, spec, SEQ, OVERLAP, rng=0)
        del engine
    err, same = frame_agreement(outs[2], outs[1])
    held = {"infer_max_abs_log_prob_diff": err, "infer_same_argmax_share": same,
            "infer_scale": float(abs(outs[1].numpy_logits()).max()),
            "infer_greedy_equal": greedy_equal(outs[2], outs[1])}

    mesh = make_mesh(tp=2)
    whole = init_conformer(cfg, seed=0).to("cuda:0")
    sliced = copy.deepcopy(whole)
    sharding = shard_params(sliced, mesh)
    x = torch.as_tensor(spec[..., :SEQ], dtype=torch.float32, device="cuda:0")  # [1, 80, SEQ]
    length = torch.tensor([SEQ], device="cuda:0")
    w = torch.randn(1, SEQ // 8, cfg.n_classes, generator=torch.Generator().manual_seed(11))
    grads, lps = {}, {}
    for kind, model in (("tp2", sliced), ("tp1", whole)):
        with deterministic_cudnn():
            lp = model(x, length)["final_posteriors"]
            linear = (lp * w.to(lp.device)[:, :lp.shape[1]]).sum() / lp.shape[1]
            names = [n for n, _ in model.named_parameters()]
            grads[kind] = dict(zip(names, torch.autograd.grad(linear, list(model.parameters()))))
        lps[kind] = lp.detach()
    want = shard_state(grads["tp1"], sharding, mesh)
    held.update(
        step_max_abs_log_prob_diff=(lps["tp2"] - lps["tp1"]).abs().max().item(),
        step_scale=lps["tp1"].abs().max().item(),
        max_grad_diff=max((grads["tp2"][n] - want[n]).abs().max().item() for n in want),
        grad_scale=max(v.abs().max().item() for v in grads["tp1"].values()))
    return held


def sp_rank_phase(A, S):
    """Phase 25b in one rank: a forward and one step of a batch of 2 x 16384
    frames (lengths SP_LENGTHS) with ``seq_shard_axes`` under ``use_mesh``
    of a ``('dp', 'sp')`` mesh over the two ranks, against the unsharded
    model, f32 at 2 layers and bf16 at the flagship depth, all through the
    kernels; peak memory of each.  The step's weight gradients are held on
    a fixed linear functional of the valid frames' log-probs; the NSTI CTC
    loss's gradients are printed beside them: CTC's alignment posteriors
    turn the GEMMs' ~1e-7 relative differences in the log-probs into ~1e-4
    relative ones in its gradients, so they bound nothing here."""
    import dataclasses

    from torch.distributed.device_mesh import DeviceMesh

    from dynamic_asr_eval_tpu_torch.device import deterministic_cudnn
    from dynamic_asr_eval_tpu_torch.models import SCConformer, init_conformer
    from dynamic_asr_eval_tpu_torch.ops.ctc import ctc_loss
    from dynamic_asr_eval_tpu_torch.parallel import use_mesh

    import contextlib

    mesh = DeviceMesh("cpu", torch.arange(2).reshape(1, 2), mesh_dim_names=("dp", "sp"))
    g = torch.Generator().manual_seed(7)
    x = torch.randn(2, 80, max(SP_LENGTHS), generator=g).cuda()
    length = torch.tensor(SP_LENGTHS).cuda()
    ds = (length + 7) // 8
    result = {}
    for name, cfg in (("f32", flagship_config(compute_dtype=torch.float32, n_layers=2,
                                              subsampling_impl="pallas")),
                      ("bf16", flagship_config(subsampling_impl="pallas"))):
        labels = torch.randint(0, cfg.vocab_size, (2, 256), generator=g).cuda()
        label_len = torch.tensor([256, 200]).cuda()
        weights = torch.randn(2, max(SP_LENGTHS) // 8, cfg.n_classes, generator=g).cuda()
        ref = init_conformer(cfg, seed=0).cuda()
        sharded = SCConformer(dataclasses.replace(cfg, seq_shard_axes=("dp", "sp"))).cuda()
        sharded.load_state_dict(ref.state_dict())
        runs = {}
        for kind, model, ctx in (("unsharded", ref, contextlib.nullcontext()),
                                 ("sp", sharded, use_mesh(mesh))):
            start = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()

            def step():
                with ctx:
                    lp = model(x, length)["final_posteriors"]
                    valid = torch.arange(lp.shape[1], device="cuda")[None] < ds[:, None]
                    linear = (lp * weights)[valid].sum() / valid.sum()
                    held = torch.autograd.grad(linear, list(model.parameters()),
                                               retain_graph=True)
                    loss = ctc_loss(lp, ds, labels, label_len, blank_id=cfg.blank_id) / ds.sum()
                    loss.backward()
                return lp.detach(), loss.item(), held

            with deterministic_cudnn(), AttentionShapes(A) as shapes:
                (lp, loss, held), launches, routes = counted({"attention": A, "subsample": S},
                                                             step)
            peak = (torch.cuda.max_memory_allocated() - start) / 1e9
            names = [n for n, _ in model.named_parameters()]
            grads = dict(zip(names, held))
            ctc_grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
            model.zero_grad(set_to_none=True)
            runs[kind] = (lp, loss, grads, launches, routes, peak, shapes.calls, ctc_grads)
        lp, loss, grads, launches, routes, peak, calls, ctc = runs["sp"]
        lp_ref, loss_ref, grads_ref, *_, peak_ref, _, ctc_ref = runs["unsharded"]
        valid = torch.arange(lp.shape[1], device="cuda")[None] < ds[:, None]
        scale = lp_ref[valid].abs().max().item()
        g_scale = max(v.abs().max().item() for v in grads_ref.values())
        ctc_scale = max(v.abs().max().item() for v in ctc_ref.values())
        result[name] = {
            "launches": launches, "routes": routes, "peak_gb": peak, "unsharded_peak_gb": peak_ref,
            "loss": loss, "unsharded_loss": loss_ref, "shape": list(lp.shape),
            "max_abs_log_prob_diff": (lp - lp_ref).abs()[valid].max().item(), "scale": scale,
            "same_argmax_share": (lp.argmax(-1) == lp_ref.argmax(-1))[valid].float().mean().item(),
            "max_grad_diff": max((grads[n] - grads_ref[n]).abs().max().item() for n in grads_ref),
            "grad_scale": g_scale,
            "ctc_max_grad_diff": max((ctc[n] - ctc_ref[n]).abs().max().item() for n in ctc_ref),
            "ctc_grad_scale": ctc_scale,
            "query_blocks": sorted(set(calls)),
            "query_block_launches": sum(c[1] != c[2] for c in calls)}
        del ref, sharded
    return result


def parallel_rank() -> int:
    """Phase 25's rank process (started by ``torch.distributed.run`` with
    PARALLEL_RANK set to the directory for its results): gloo, both ranks on
    ``cuda:0``; phases 25a and 25b; ``rank<r>.json``."""
    import torch.distributed as dist

    from dynamic_asr_eval_tpu_torch.device import set_parity_precision
    from dynamic_asr_eval_tpu_torch.kernels import attention as A
    from dynamic_asr_eval_tpu_torch.kernels import subsample as S

    set_parity_precision()
    torch.cuda.set_device(0)
    dist.init_process_group("gloo")
    rank = dist.get_rank()
    result = {"rank": rank, "tp": tp_rank_phase(A, S)}
    result["sp"] = sp_rank_phase(A, S)
    with open(os.path.join(os.environ[PARALLEL_RANK], f"rank{rank}.json"), "w") as f:
        json.dump(result, f)
    dist.destroy_process_group()
    return 0


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def parallel_path(card):
    """Phases 25a and 25b: two gloo ranks on the one card
    (``torch.distributed.run --nproc_per_node 2`` on this script), NCCL
    refusing two ranks on one device.  Holds each rank's results; returns
    rank 0's {"tp": ..., "sp": ...}."""
    with tempfile.TemporaryDirectory() as tmp:
        cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", "2",
               "--master_port", str(free_port()), os.path.abspath(__file__)]
        t0 = time.time()
        proc = subprocess.run(cmd, env={**os.environ, PARALLEL_RANK: tmp}, capture_output=True,
                              text=True, timeout=600)
        if proc.returncode:
            raise AssertionError(f"phase 25's ranks exited {proc.returncode}:\n"
                                 f"{proc.stdout[-3000:]}\n{proc.stderr[-8000:]}")
        ranks = []
        for r in range(2):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
    wall = time.time() - t0
    L = flagship_config().n_layers
    for r, res in enumerate(ranks):
        for name, tp in res["tp"].items():
            W, layers = tp["windows"], tp["layers"]
            route = "tensor_core" if name == "bf16" else "tf32x3"
            expect = {"attention": (layers * W, layers * W), "subsample": (W, W)}
            check_records_launches(f"phase 25a, rank {r}, {name}", tp["launches"], tp["routes"],
                                   expect, route=route)
            if tp["heads"] != [3]:
                raise AssertionError(f"phase 25a, rank {r}, {name}: attention launches of "
                                     f"{tp['heads']} heads, expected 3 (6 over tp 2)")
            held = tp.get("held")
            ok = (tp["same_argmax_share"] >= 0.99 if name == "bf16" else
                  held["infer_max_abs_log_prob_diff"] <= 1e-4 * held["infer_scale"]
                  and held["infer_greedy_equal"]
                  and held["max_grad_diff"] <= 1e-4 * held["grad_scale"])
            if not ok:
                raise AssertionError(f"phase 25a, rank {r}, {name}: against tp 1 {tp}")
            repeat = (f" (tp 1 run twice: {tp['repeat_max_abs_log_prob_diff']:.3e}; neither "
                      f"held)" if "repeat_max_abs_log_prob_diff" in tp else "")
            log(f"  25a rank {r}, {name} ({layers} layers, {W} windows): tp 2 against tp 1: max "
                f"|d log-prob| {tp['max_abs_log_prob_diff']:.3e}{repeat} of max {tp['scale']:.3e}, "
                f"{tp['same_argmax_share']:.4f} of frames with the same argmax, greedy ids equal "
                f"{tp['greedy_equal']}; launches {tp['launches']} (exactly {layers} / {layers} "
                f"attention of 3 heads and 1 / 1 subsampling a window, {route}); "
                f"{tp['wall_s']:.2f} s")
            if held:
                log(f"  25a rank {r}, {name} held: before adaptation max |d log-prob| "
                    f"{held['infer_max_abs_log_prob_diff']:.3e} of max {held['infer_scale']:.3e}, "
                    f"greedy ids equal {held['infer_greedy_equal']}; one window's forward "
                    f"{held['step_max_abs_log_prob_diff']:.3e} of max {held['step_scale']:.3e}, "
                    f"max |d grad| of the linear functional {held['max_grad_diff']:.3e} of max "
                    f"{held['grad_scale']:.3e}")
        for name, sp in res["sp"].items():
            layers = L if name == "bf16" else 2
            route = "tensor_core" if name == "bf16" else "tf32x3"
            # one forward, two backwards (the linear functional's and CTC's)
            check_records_launches(f"phase 25b, rank {r}, {name}", sp["launches"], sp["routes"],
                                   {"attention": (layers, 2 * layers), "subsample": (1, 2)},
                                   route=route)
            blocks = [[6, 1024, 2048, 1024 * r]]  # H, Tq, Tk, q_offset
            if sp["query_blocks"] != blocks or sp["query_block_launches"] != layers:
                raise AssertionError(f"phase 25b, rank {r}, {name}: attention launches "
                                     f"{sp['query_blocks']} x {sp['query_block_launches']}, "
                                     f"expected {layers} of {blocks}")
            ok = (sp["same_argmax_share"] >= 0.99 if name == "bf16" else
                  sp["max_abs_log_prob_diff"] <= 1e-4 * sp["scale"]
                  and sp["max_grad_diff"] <= 1e-4 * sp["grad_scale"])
            if not ok:
                raise AssertionError(f"phase 25b, rank {r}, {name}: against unsharded {sp}")
            log(f"  25b rank {r}, {name} ({layers} layers): sp 2 against unsharded: max |d "
                f"log-prob| {sp['max_abs_log_prob_diff']:.3e} of max {sp['scale']:.3e}, "
                f"{sp['same_argmax_share']:.4f} of valid frames with the same argmax; CTC loss "
                f"{sp['loss']:.6g} / {sp['unsharded_loss']:.6g}; max |d grad| of the linear "
                f"functional {sp['max_grad_diff']:.3e} of max {sp['grad_scale']:.3e}, of the CTC "
                f"loss {sp['ctc_max_grad_diff']:.3e} of max {sp['ctc_grad_scale']:.3e} (not "
                f"held); query blocks "
                f"(H, Tq, Tk, q_offset) {sp['query_blocks']} x {sp['query_block_launches']}; "
                f"peak memory {sp['peak_gb']:.2f} GB (unsharded {sp['unsharded_peak_gb']:.2f} GB)")
    line = {"card": card, "ranks": 2, "backend": "gloo", "wall_s": wall,
            "tp": ranks[0]["tp"], "sp": ranks[0]["sp"]}
    print(json.dumps({"parallel": line}))
    return ranks[0]


def wer_counts_total(ref, hyp) -> int:
    """Word edits (insertions + deletions + substitutions) of ``hyp`` against
    ``ref``."""
    from dynamic_asr_eval_tpu_torch.text import wer_counts

    return int(wer_counts(" ".join(hyp), " ".join(ref))[:3].sum())


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                      "dynamic_asr_eval_tpu_torch")):
        print("chip_smoke: run it from a checkout of the repository", file=sys.stderr)
        return 2
    from dynamic_asr_eval_tpu_torch.device import set_parity_precision
    from dynamic_asr_eval_tpu_torch.kernels import attention as A
    from dynamic_asr_eval_tpu_torch.kernels import softdtw as D
    from dynamic_asr_eval_tpu_torch.kernels import subsample as S

    set_parity_precision()
    card = card_line()
    log(card)
    log(f"[1] card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}; "
        "TF32 off for matmuls and cuDNN in every phase")

    t0 = time.time()
    libraries = list(A.LIBRARIES.values()) + list(S.LIBRARIES.values()) + [D.LIBRARY]
    with ThreadPoolExecutor(len(libraries)) as pool:
        for fut in [pool.submit(lib.load) for lib in libraries]:
            fut.result()
    log(f"[2] kernels built in {time.time() - t0:.2f} s")
    for lib in libraries:
        log(f"  {lib.source.name}: nvcc {lib.build_seconds} s")
        rows = ptxas_report(lib.build_log)
        for name, (_, regs, spills) in zip(demangle([r[0] for r in rows]), rows):
            log(f"    {name}: {regs} registers, {spills} bytes spill stores")

    log("[3] kernels against their plain versions")
    errs = {}
    for dtype in (torch.bfloat16, torch.float32):
        errs[("attn", dtype)] = check_attention(A, 2, 2048, 6, 128, [2048, 1600], dtype)
        check_attention(A, 3, 1000, 6, 128, [1000, 777, 1000], dtype)
    check_attention(A, 2, 300, 2, ODD_HEAD_DIM, [300, 177], torch.float32)
    check_attention(A, 2, 2048, 6, 128, None, torch.bfloat16)
    check_attention(A, 2, 37, 6, 128, [37, 20], torch.bfloat16)
    for length in (2048, 1792):  # AWMC's batch-1 windows
        check_attention(A, 1, 2048, 6, 128, [length], torch.bfloat16)
    # the protocol drivers' evaluation engine: forwards of infer_batch 4
    # windows, the last of a recording 14336 frames, and a ragged batch
    for lengths in ([2048, 2048, 2048, 1792], [2048, 2048, 2048, 1100]):
        check_attention(A, 4, 2048, 6, 128, lengths, torch.bfloat16)
    for frames, _ in UTT_SDTW:  # phase 19's utterances: T_ds 64 (one tile) and 512
        T = frames // 8
        check_attention(A, 2, T, 6, 128, [T, T], torch.bfloat16)
    # phase 21's chunks (T_ds 256): the teacher, the teacher-forced pass, the
    # final decode and teacher_ce's step at batch 1 (and a ragged chunk of
    # 1600 frames); grpo's step at batch 4
    for lengths in ([256], [200], [256] * 4):
        check_attention(A, len(lengths), ENCDEC_SEQ // 8, 6, 128, lengths, torch.bfloat16)
    # phase 22's trainer: its padded batch of 4 windows with zero-length rows
    # (a ragged last batch), and a recording's last batch (a half window and
    # three empty rows)
    for lengths in ([2048, 1100, 0, 0], [1024, 0, 0, 0]):
        check_attention(A, 4, 2048, 6, 128, lengths, torch.bfloat16)
    for dtype in (torch.bfloat16, torch.float32):
        errs[("sub", dtype)] = check_subsample(S, SUB_FLAGSHIP, dtype)
        check_subsample(S, SUB_RAGGED, dtype)
    # AWMC's windows; the evaluation engine's batches and phase 22's trainer
    # batch (4 x 16384)
    for batch in (1, 4):
        check_subsample(S, (batch,) + SUB_FLAGSHIP[1:], torch.bfloat16)
    for frames, _ in UTT_SDTW:  # phase 19's utterances
        check_subsample(S, (2, frames) + SUB_FLAGSHIP[2:], torch.bfloat16)
    for batch in (1, 4):  # phase 21's chunks
        check_subsample(S, (batch, ENCDEC_SEQ) + SUB_FLAGSHIP[2:], torch.bfloat16)
    errs[("sub_relu", torch.bfloat16)] = check_subsample(S, SUB_FLAGSHIP, torch.bfloat16, "relu")
    for shape, bandwidth in SDTW_CASES:
        e = check_softdtw(D, shape, bandwidth)
        if shape == SDTW_BENCH:
            errs["sdtw"] = e
    vmap_launches = check_vmap(A, S)  # the records-batched step's calls

    log("[4] timing at the flagship (attention and subsampling: bf16 and f32) and "
        "benchmark (soft-DTW: f32) shapes")
    times = {}
    for name, (t, bnd) in (
            ("flash_attention", time_attention(A, 2, 2048, 6, 128, [2048, 1600], torch.bfloat16)),
            ("flash_attention_f32",
             time_attention(A, 2, 2048, 6, 128, [2048, 1600], torch.float32)),
            ("fused_subsample", time_subsample(S)),
            ("fused_subsample_f32", time_subsample(S, torch.float32)),
            ("softdtw", time_softdtw(D, card))):
        times[name] = (t, bnd)
        for k, v in t.items():
            log(f"  {name} {k}: {v:.4f} ms")
        for k, (ms, by) in bnd.items():
            log(f"  {name} bound {k}: {ms * 1e3:.2f} us ({by})")
    library_kernels = sdpa_kernels(A, torch.float32)
    subsample_breakdown(S, card)

    attn_per_window = (flagship_config().n_layers, flagship_config().n_layers)
    _, routes, parity_launches, _ = drive("", flagship_config(), {"attention": A},
                                          {"attention": attn_per_window}, card,
                                          lambda params: check_attention_model(params, A))
    _, pallas_routes, sub_parity_launches, pallas_profile = drive(
        "b", flagship_config(subsampling_impl="pallas"), {"attention": A, "subsample": S},
        {"attention": attn_per_window, "subsample": (1, 1)}, card,
        lambda params: check_subsample_model(params, S))
    log(f"[5c] the f32 path: evals.run.main, NSTI on the {N_FRAMES}-frame recording, flagship, "
        f"f32: the f32 attention kernels with subsampling_impl='conv', xla attention with 'conv', "
        f"and the f32 attention and subsampling kernels ('pallas'), on {card}")
    f32_path_launches = f32_path(card, A, S)

    log("[8] soft-DTW's own path: kernels.softdtw.benchmark(use_pallas=True)")
    D.reset_counters()
    bench = D.benchmark(use_pallas=True)
    sdtw_launches = (D.fwd_launches, D.bwd_launches)
    if not (sdtw_launches[0] > 0 and sdtw_launches[1] > 0 and math.isfinite(bench["loss"])):
        raise AssertionError(f"soft-DTW benchmark: {bench}, launches {sdtw_launches}")
    plain = D.benchmark(use_pallas=False)
    if not math.isclose(bench["loss"], plain["loss"], rel_tol=1e-4):
        raise AssertionError(f"soft-DTW benchmark loss {bench['loss']} != plain {plain['loss']}")
    log(f"  kernels: {bench['seconds_per_iter'] * 1e3:.3f} ms per iteration, loss {bench['loss']:.6g}, "
        f"launches fwd {sdtw_launches[0]}, bwd {sdtw_launches[1]}; plain version "
        f"{plain['seconds_per_iter'] * 1e3:.3f} ms per iteration")

    from dynamic_asr_eval_tpu_torch.evals import run_dynamic_eval_full

    with tempfile.TemporaryDirectory() as tmp:
        log("[9] checkpoints at flagship width: DAE1 and a reference torch pickle")
        dae = check_checkpoints(tmp)
        log(f"[10] AWMC main path: evals.run_dynamic_eval_full.main --awmc --checkpoint (DAE1), "
            f"{N_FRAMES}-frame recording, flagship, bf16")
        awmc_modules = {"attention": A, "subsample": S, "softdtw": D}
        wer, wall, launches, awmc_routes, detail, recorder = main_path(
            None, awmc_modules, run_dynamic_eval_full, ("--awmc", "--checkpoint", dae))
        cfg = recorder.engine.model.config
        log(f"  WER {wer}; launches {launches}; by route {awmc_routes}; driver wall {wall:.3f} s "
            f"(record {detail['elapsed_times'][0]:.3f} s, first run: includes warm-up)")
        params = check_awmc_run(cfg, launches, awmc_routes, wer, detail, recorder)
        log("[10b] AWMC parity: full-depth f32 engine, kernels against the plain path")
        awmc_parity_routes = check_awmc_parity(params, A, S)
        log(f"[11] where AWMC's time goes: the driver's engine, warm, on {card}")
        profile_engine(recorder, card, "awmc")
        del recorder

        log("[12] native host libraries: g++ builds, and the native WER against the Python DP")
        check_native_libraries(card)
        log(f"[13] the -lm path: evals.run.main, NSTI with lm_tta_beams={LM_TTA_BEAMS} and a "
            f"{LM_BEAMS}-beam final decode, on the {N_FRAMES}-frame recording, flagship, bf16, "
            f"subsampling_impl='pallas', on {card}")
        lm_counts, lm_routes = lm_path(tmp, card, {"attention": A, "subsample": S, "softdtw": D},
                                       pallas_profile,
                                       {"attention": attn_per_window, "subsample": (1, 1)})
        log(f"[14] the transformer-LM path: evals.run.main -lm <DLM1>, NSTI with lm_tta_beams="
            f"{LM_TTA_BEAMS} and a {LM_BEAMS}-beam final decode, on a {TLM_FRAMES}-frame "
            f"recording ({TLM_WINDOWS} windows), flagship, bf16, subsampling_impl='pallas', "
            f"on {card}")
        tlm_counts, tlm_routes = tlm_path(tmp, card, {"attention": A, "subsample": S, "softdtw": D},
                                          {"attention": attn_per_window, "subsample": (1, 1)})
        log(f"[15] the consistency path: evals.run_dynamic_eval_full.main --consistency "
            f"--checkpoint (DAE1), offline, {N_FRAMES}-frame recording, flagship, bf16")
        torch.cuda.reset_peak_memory_stats()
        wer, wall, cons_counts, cons_routes, detail, recorder = main_path(
            None, awmc_modules, run_dynamic_eval_full, ("--consistency", "--checkpoint", dae),
            kwargs=("online=false",))
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        cfg = recorder.engine.model.config
        log(f"  WER {wer}; launches {cons_counts}; by route {cons_routes}; driver wall {wall:.3f} "
            f"s (record {detail['elapsed_times'][0]:.3f} s, first run: includes warm-up); peak "
            f"device memory {peak_gb:.2f} GB")
        check_consistency_run(cfg, cons_counts, cons_routes, wer, detail, recorder)
        log(f"  every chunk's weights moved; {N_WINDOWS} chunks' weights returned")
        log(f"[15b] where the consistency engine's time goes: the driver's engine, warm, on {card}")
        profile_engine(recorder, card, "consistency")
        del recorder
        log("[15c] consistency parity: f32 engine at flagship widths, kernels against the plain "
            "path")
        cons_parity_routes = check_consistency_parity(A, S)

    protocol_runs = protocol_phases(card, A, S, D)

    log(f"[17] entropy augmentation: evals.run.main -kwargs entropy_augmentation_enabled=true "
        f"--profile, NSTI on the {N_FRAMES}-frame recording, flagship, bf16, "
        f"subsampling_impl='pallas', on {card}")
    profile_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "profiles",
                               "phase17")
    if os.path.isdir(profile_dir):  # this script's own output of an earlier run
        import shutil

        shutil.rmtree(profile_dir)
    entropy_counts, entropy_routes, entropy_gx = entropy_path(card, A, S, D, profile_dir)
    with tempfile.TemporaryDirectory() as tmp:
        log(f"[18] the NeMo preset: stt_en_fastconformer_ctc_large at full width from a synthetic "
            f"NeMo state dict, evals.run.main --checkpoint (DAE1), NSTI on the {N_FRAMES}-frame "
            f"recording, bf16, subsampling_impl='pallas', on {card}")
        nemo_counts, nemo_routes, nemo_gx, nemo_parity = nemo_path(tmp, card, A, S, D)
    log(f"[19] the utterance path: evals.run_utterance_eval.main --segment_frames {UTT_SEGMENT} "
        f"on the {N_FRAMES}-frame recording, flagship, bf16, subsampling_impl='pallas', on "
        f"{card}")
    (utt_counts, utt_routes), (sdtw_counts, sdtw_routes) = utterance_path(card, A, S, D)
    log(f"[20] wav2vec2-base: evals.run_wav2vec2.main --full_size, f32, the chunked mode on "
        f"{W2V_SAMPLES // SAMPLE_RATE} s of synthetic audio at {W2V_SEQ} / {W2V_OVERLAP} "
        f"samples, on {card}")
    w2v_counts, w2v_routes = wav2vec2_path(card, A, S, D)
    with tempfile.TemporaryDirectory() as tmp:
        log(f"[21] the encoder-decoder path: evals.enc_dec_dynamic_eval_test.main, the flagship "
            f"encoder (bf16, subsampling_impl='pallas') and the default f32 decoder, "
            f"{ENCDEC_FRAMES} frames at -seq {ENCDEC_SEQ} -o 0, on {card}")
        encdec_counts, encdec_routes = encdec_path(tmp, card, A, S, D)
        log(f"[21b] evals.enc_dec_inference_test.main -mode default and "
            f"evals.enc_dec_ctc_beam_inference_test.main -beams {ENCDEC_BEAMS} on the same "
            f"recording and model, on {card}")
        inf_counts, inf_routes = encdec_inference_path(tmp, card, A, S, D)
    log("[21c] enc-dec parity: the full-depth f32 enc-dec, kernels against the plain path")
    encdec_parity = check_encdec_parity(A, S)
    with tempfile.TemporaryDirectory() as tmp:
        log(f"[22] NST finetuning: train.cli.main -config <yaml> --data <{TRAIN_WAVS} wavs>, the "
            f"flagship (bf16, 'pallas_flash', 'pallas'), {TRAIN_FRAMES} frames each, batch "
            f"{TRAIN_BATCH} x {TRAIN_SEQ}, on {card}")
        t_phase = time.time()
        train_counts, train_routes = train_path(tmp, card, A, S, D)
        log(f"  phases 22-22a took {time.time() - t_phase:.1f} s")
    log("[22b] NST step parity: the full-depth f32 flagship, kernels against the plain path")
    t_phase = time.time()
    train_parity = check_train_parity(A, S)
    log(f"  phase 22b took {time.time() - t_phase:.1f} s")
    with tempfile.TemporaryDirectory() as tmp:
        log(f"[23] word-level LM fusion: build_ctcdecoder(lm_level='auto') and "
            f"word_beam_search, card against CPU, on {card}")
        t_phase = time.time()
        word_fusion_path(tmp, card)
        log(f"  phase 23 took {time.time() - t_phase:.1f} s")
    t_phase = time.time()
    log(f"[24] records batching: DynamicEvalEngine.batched on {len(RECORDS_FRAMES)} "
        f"synthetic_spec recordings of {RECORDS_FRAMES} frames, the flagship (bf16, "
        f"'pallas_flash', 'pallas'), phase 5's TTA settings, beside the serial engine, on {card}")
    records_counts, records_routes = records_path(card, A, S)
    log(f"[24b] records batching f32 parity: {RECORDS_PARITY_FRAMES} frames, the flagship in "
        f"f32 through the f32 kernels, against the serial engine")
    records_parity = check_records_parity(A, S)
    log(f"[24c] evals.run.main --dp_records and --dp at world size 1, f32, on "
        f"{RECORDS_PARITY_FRAMES} frames, against the serial driver")
    records_driver = records_driver_path(card, A, S)
    log(f"[24d] rematerialisation: one NSTI window step of {SEQ} frames, the flagship (bf16), "
        f"checkpoint_every_n_layers=1 and remat_subsampling=True beside the plain step, on "
        f"{card}")
    remat_counts, remat_routes = remat_path(card, A, S)
    log(f"  phases 24-24d took {time.time() - t_phase:.1f} s")
    t_phase = time.time()
    log("[25c] the query-block attention kernels (sequence parallelism's): q [2, 1024, 6, 128] "
        "against k, v [2, 2048, 6, 128], both routes, both blocks, against the plain version "
        "and the full call")
    query_block = {dtype: check_query_block(A, dtype) for dtype in (torch.bfloat16,
                                                                    torch.float32)}
    log(f"[25] tensor and sequence parallelism: two gloo ranks on the one card; 25a: the "
        f"{TP_FRAMES}-frame NSTI run at tp 2 against tp 1, the flagship (bf16, 'pallas_flash', "
        f"'pallas') and 2 layers in f32; 25b: sp 2 on {SP_LENGTHS} frames against unsharded, "
        f"on {card}")
    parallel = parallel_path(card)
    log(f"  phases 25-25c took {time.time() - t_phase:.1f} s")
    encdec_counts = {k: tuple(a + b for a, b in zip(encdec_counts[k], inf_counts[k]))
                     for k in encdec_counts}
    encdec_routes = {k: {r: tuple(a + b for a, b in zip(c, inf_routes[k][r]))
                         for r, c in by.items()} for k, by in encdec_routes.items()}

    sources = {"flash_attention": "flash_attention_bf16.cu",
               "flash_attention_f32": "flash_attention.cu",
               "fused_subsample": "fused_subsample_bf16.cu",
               "fused_subsample_f32": "fused_subsample.cu", "softdtw": "softdtw.cu"}
    replaces = {
        ("flash_attention", "fwd"): "dynamic_asr_eval_tpu/kernels/attention.py:56",
        ("flash_attention", "bwd"): "dynamic_asr_eval_tpu/kernels/attention.py:56",
        ("flash_attention_f32", "fwd"): "dynamic_asr_eval_tpu/kernels/attention.py:56",
        ("flash_attention_f32", "bwd"): "dynamic_asr_eval_tpu/kernels/attention.py:56",
        ("fused_subsample", "fwd"): "dynamic_asr_eval_tpu/kernels/subsample.py:278",
        ("fused_subsample", "bwd"): "dynamic_asr_eval_tpu/kernels/subsample.py:438",
        ("fused_subsample_f32", "fwd"): "dynamic_asr_eval_tpu/kernels/subsample.py:278",
        ("fused_subsample_f32", "bwd"): "dynamic_asr_eval_tpu/kernels/subsample.py:438",
        ("softdtw", "fwd"): "dynamic_asr_eval_tpu/kernels/softdtw.py:129",
        ("softdtw", "bwd"): "dynamic_asr_eval_tpu/kernels/softdtw.py:92",
    }
    # launches on the NSTI path (by route: attention in the "conv" run,
    # subsampling in the "pallas" run; soft-DTW: its own path), on the AWMC
    # path (phase 10), the -lm path (phase 13), the transformer-LM path
    # (phase 14) and the consistency path (phase 15); the f32 routes are the
    # parity routes and run 0 times there, their counts in the f32 runs of
    # phases 6 and 6b go under "parity_launches", of phase 10b under
    # "awmc_parity_launches", of phase 15c under "consistency_parity_launches",
    # the f32 kernels' in phase 5c under "f32_path_launches"
    def by_kernel(routes_, counts_):
        return {"flash_attention": routes_["attention"]["tensor_core"],
                "flash_attention_f32": routes_["attention"][A.ROUTES[torch.float32]],
                "fused_subsample": routes_["subsample"]["tensor_core"],
                "fused_subsample_f32": routes_["subsample"][S.ROUTES[torch.float32]],
                "softdtw": counts_["softdtw"]}

    nsti_launches = by_kernel({"attention": routes["attention"],
                               "subsample": pallas_routes["subsample"]}, {"softdtw": sdtw_launches})
    parity = {"flash_attention_f32": parity_launches, "fused_subsample_f32": sub_parity_launches}
    awmc_launches = by_kernel(awmc_routes, launches)
    lm_launches = by_kernel(lm_routes, lm_counts)
    tlm_launches = by_kernel(tlm_routes, tlm_counts)
    consistency_launches = by_kernel(cons_routes, cons_counts)
    entropy_launches = by_kernel(entropy_routes, entropy_counts)
    nemo_launches = by_kernel(nemo_routes, nemo_counts)
    utterance_launches = by_kernel(utt_routes, utt_counts)
    utterance_softdtw_launches = by_kernel(sdtw_routes, sdtw_counts)
    wav2vec2_launches = by_kernel(w2v_routes, w2v_counts)
    encdec_launches = by_kernel(encdec_routes, encdec_counts)
    trainer_launches = by_kernel(train_routes, train_counts)
    no_softdtw = {"softdtw": (0, 0)}
    records_launches = by_kernel(records_routes, no_softdtw)
    remat_launches = by_kernel(remat_routes, no_softdtw)
    # phase 25: rank 0's launches at tp 2 (25a) and sp 2 (25b), bf16 on the
    # main routes and f32 on the parity routes
    tp_runs, sp_runs = parallel["tp"], parallel["sp"]
    tp_launches = by_kernel({"attention": {"tensor_core": tp_runs["bf16"]["launches"]["attention"],
                                           "tf32x3": tp_runs["f32"]["launches"]["attention"]},
                             "subsample": {"tensor_core": tp_runs["bf16"]["launches"]["subsample"],
                                           "tf32x3": tp_runs["f32"]["launches"]["subsample"]}},
                            no_softdtw)
    sp_launches = by_kernel({"attention": {"tensor_core": sp_runs["bf16"]["launches"]["attention"],
                                           "tf32x3": sp_runs["f32"]["launches"]["attention"]},
                             "subsample": {"tensor_core": sp_runs["bf16"]["launches"]["subsample"],
                                           "tf32x3": sp_runs["f32"]["launches"]["subsample"]}},
                            no_softdtw)
    vmap_by_kernel = {"flash_attention": vmap_launches["attention"],
                      "fused_subsample": vmap_launches["subsample"]}
    protocol_launches = {}  # phases 16, 16b and 16c together
    for counts_, routes_ in protocol_runs:
        for name, counts in by_kernel(routes_, counts_).items():
            protocol_launches[name] = tuple(
                a + b for a, b in zip(protocol_launches.get(name, (0, 0)), counts))
    awmc_parity = {"flash_attention_f32": awmc_parity_routes["attention"],
                   "fused_subsample_f32": awmc_parity_routes["subsample"]}
    consistency_parity = {"flash_attention_f32": cons_parity_routes["attention"],
                          "fused_subsample_f32": cons_parity_routes["subsample"]}
    encdec_parity = {"flash_attention_f32": encdec_parity["attention"],
                     "fused_subsample_f32": encdec_parity["subsample"]}
    train_parity = {"flash_attention_f32": train_parity["attention"],
                    "fused_subsample_f32": train_parity["subsample"]}
    err_keys = {
        ("flash_attention", "fwd"): (errs[("attn", torch.bfloat16)], ("out",)),
        ("flash_attention", "bwd"): (errs[("attn", torch.bfloat16)], ("dq", "dk", "dv")),
        ("flash_attention_f32", "fwd"): (errs[("attn", torch.float32)], ("out",)),
        ("flash_attention_f32", "bwd"): (errs[("attn", torch.float32)], ("dq", "dk", "dv")),
        ("fused_subsample", "fwd"): (errs[("sub", torch.bfloat16)], ("out",)),
        ("fused_subsample_relu", "fwd"): (errs[("sub_relu", torch.bfloat16)], ("out",)),
        ("fused_subsample_relu", "bwd"): (errs[("sub_relu", torch.bfloat16)],
                                          ("gx",) + S.WEIGHT_NAMES),
        ("fused_subsample", "bwd"): (errs[("sub", torch.bfloat16)], ("gx",) + S.WEIGHT_NAMES),
        ("fused_subsample_f32", "fwd"): (errs[("sub", torch.float32)], ("out",)),
        ("fused_subsample_f32", "bwd"): (errs[("sub", torch.float32)], ("gx",) + S.WEIGHT_NAMES),
        ("softdtw", "fwd"): (errs["sdtw"], ("R",)),
        ("softdtw", "bwd"): (errs["sdtw"], ("E",)),
    }
    kernels = []
    for name in ("flash_attention", "flash_attention_f32", "fused_subsample", "fused_subsample_f32",
                 "softdtw"):
        t, bnd = times[name]
        for i, kind in enumerate(("fwd", "bwd")):
            e, keys = err_keys[(name, kind)]
            extra = ({"parity_launches": parity[name][i],
                      "awmc_parity_launches": awmc_parity[name][i],
                      "consistency_parity_launches": consistency_parity[name][i],
                      "encdec_parity_launches": encdec_parity[name][i],
                      "train_parity_launches": train_parity[name][i]}
                     if name in parity else {})
            if name in parity:  # phases 24b and 24c run the f32 routes
                extra.update(records_parity_launches=records_parity[
                    "attention" if name.startswith("flash") else "subsample"][i],
                             records_driver_launches=records_driver[
                    "attention" if name.startswith("flash") else "subsample"][i])
            if name in f32_path_launches:
                extra.update(f32_path_launches=f32_path_launches[name][i],
                             bound_cuda_core_ms=bnd[f"{kind}_cuda_core"][0])
            if name == "flash_attention_f32":
                extra.update(library_kernels=library_kernels[kind])
            if name.startswith("flash_attention"):  # phase 25c
                timing, qb_err = query_block[torch.float32 if name.endswith("f32")
                                             else torch.bfloat16]
                extra.update(query_block_ms=timing[kind][0], query_block_full_ms=timing[kind][1],
                             query_block_max_abs_err=qb_err)
            if name == "softdtw":
                extra.update(chain_floor_ms=bnd[f"{kind}_chain"][0])
            if name == "fused_subsample_f32":
                extra.update(nemo_parity_launches=nemo_parity[i])
            if name == "fused_subsample":  # phase 3's relu case, phase 4's relu forward
                relu_e, relu_keys = err_keys[("fused_subsample_relu", kind)]
                extra.update(relu_max_abs_err=max(relu_e[k] for k in relu_keys),
                             relu_ms=t["fwd_relu"] if kind == "fwd" else None)
            if name.startswith("fused_subsample") and kind == "bwd":
                # the backward with gx (the entropy pass's): its launches on the
                # entropy and NeMo paths (all bf16), its times and bound
                bf16 = name == "fused_subsample"
                extra.update(entropy_gx_launches=entropy_gx if bf16 else 0,
                             nemo_gx_launches=nemo_gx if bf16 else 0,
                             gx_ms=t["bwd_gx"], gx_plain_ms=t["bwd_gx_plain"],
                             gx_library_ms=t["bwd_gx_library"], gx_bound_ms=bnd["bwd_gx"][0],
                             gx_bound_by=bnd["bwd_gx"][1])
            kernels.append({
                "name": f"{name}_{kind}",
                "route": "cuda",
                "source": f"dynamic_asr_eval_tpu_torch/kernels/csrc/{sources[name]}",
                "replaces": replaces[(name, kind)],
                "launches": nsti_launches[name][i],
                "awmc_launches": awmc_launches[name][i],
                "lm_launches": lm_launches[name][i],
                "tlm_launches": tlm_launches[name][i],
                "consistency_launches": consistency_launches[name][i],
                "protocol_launches": protocol_launches[name][i],
                "entropy_launches": entropy_launches[name][i],
                "nemo_launches": nemo_launches[name][i],
                "utterance_launches": utterance_launches[name][i],
                "utterance_softdtw_launches": utterance_softdtw_launches[name][i],
                "wav2vec2_launches": wav2vec2_launches[name][i],
                "encdec_launches": encdec_launches[name][i],
                "trainer_launches": trainer_launches[name][i],
                "records_launches": records_launches[name][i],
                "remat_launches": remat_launches[name][i],
                "vmap_launches": vmap_by_kernel.get(name, (0, 0))[i],
                "tp_launches": tp_launches[name][i],
                "sp_launches": sp_launches[name][i],
                "max_abs_err": max(e[k] for k in keys),
                "ms": t[kind],
                "kernel_ms": t[kind],
                "plain_ms": t[f"{kind}_plain"],
                "bound_ms": bnd[kind][0],
                "bound_us": bnd[kind][0] * 1e3,
                "bound_by": bnd[kind][1],
                "library_ms": t.get(f"{kind}_library"),
                **extra,
            })
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(parallel_rank() if os.environ.get(PARALLEL_RANK) else main())
