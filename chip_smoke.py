#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU: `python3 chip_smoke.py`.

Phases (any failure ends the run with a non-zero exit and no result line):

1. Environment: the card's name and power limit (`nvidia-smi`), torch and
   CUDA versions, the precision flags as the engine pins them.
2. Build: `nvcc` compiles `byzantinemomentum_tpu_torch/csrc/prng_kernels.cu`
   (the key tree's dropout-mask, Bernoulli-mask and split kernels),
   `csrc/search_kernels.cu` (the line search's `linesearch_step`),
   `csrc/mixture_kernels.cu` (the `--gars-per-call` draw's
   `operand_hash` and `mixture_draw`), `csrc/gar_kernels.cu`
   and `csrc/sort_kernels.cu` from this checkout into the kernel libraries
   the run needs (one per round count, and one per (kernel, n, element
   type) for the four sorting kernels, in f32, bf16 and f16), all side by
   side (`closest_mean` once for each m it meets, `trimmed_mean` once for
   each f); prints their count, the build's seconds and each kernel's
   registers and spills, and fails on a spill; prints the SASS
   instruction counts of the redesigned kernels at the headline shapes
   (`cuobjdump -sass`; `lower_median`, `trimmed_mean` and `colsort` at
   n = 25, f = 11, in each dtype). The MNIST grid's f32 libraries too:
   `lower_median` at n = 51 and 11, `trimmed_mean` at n = 51 for f = 24
   and 12 and at n = 11 for f = 4, `closest_mean` at n = 51 for m = 27
   and 39, `selected_median_mean` for Bulyan's 27 rounds at n = 51,
   f = 12.
3. The key tree (`key_tree_kernels`): the dropout-mask kernel against its
   plain version and the CPU's bits, bit for bit, for the three masks of
   `empire-cnn` at the headline's (S, B) = (20, 50), at krum_f11's S = 14
   and at a ragged (3, 5) that fills no whole block, and through the
   model's draw (three launches); the split kernel and the init of
   empire-cnn and simples-conv on the card against the CPU's bits; the
   records of both at the headline: the three masks of a step (24.7 M
   bytes written; bound by 32-bit integer issue, 74 operations an
   element, at a quarter of the f32 rate) and the split of the step key
   into S + 2, with the host's time a step of each against the eager
   int64 threefry.
   The line search's state update (`search_kernel`): `linesearch_step`
   against its plain version on the card and the CPU's, bit for bit, on
   swept states (expansion, contraction, the negative-x guard with prop_x
   > 0 and with prop_x = 0 down to -0 from the largest f32 step; f32 and
   f64 values, NaN values); its record times one probe's update (52
   bytes: launch-bound).
   The `--gars-per-call` draw (`mixture_kernels_check`): `operand_hash`
   against its plain version (the int64 emulation), its one-multiply
   int64 form and the CPU's, bit for bit, on stacks with NaN payloads of
   both signs, +-0, +-inf and a subnormal (`hash_stack`) at the
   headline's [25, 1,310,922] in f32, bf16 and f16 and at WRN-28-10's
   f32[11, 36,489,290]; `mixture_draw` against its plain version and the
   CPU's for each hash; its records: `operand_hash` at the headline f32
   shape (bound by its bytes; the library column is the one-multiply
   int64 form) and `mixture_draw` (one thread, launch-bound), the other
   shapes logged. The 14 named inits and empire-cnn's `apply_named_init`
   on the card against the CPU's bits (orthogonal within 1e-6).
   Kernels against their plain PyTorch versions on the card: the seven
   f32 kernels at the headline shape f32[25, 1,310,922] (Bulyan's W at
   f=5, Krum's weights at f=11, Brute's mask at f=11 from the brute
   enumeration itself, the trimmed mean at f=5 and 11, the closest mean
   with m = n - f about the median and the trimmed mean, the column
   sort), on a ragged d with NaN rows, +-inf, ties, columns whose median
   is +inf or -inf and a column of +-0 (a selected +inf must stay +inf
   in Brute's mean), and at n = 2 and 64; the bf16 and
   f16 forms of the four sorting kernels on the same cases; each GAR of
   the port on the card against the same GAR on the CPU at a small size,
   Brute and CGE at n=11, f=4. Bulyan's W, Krum's w and Brute's mask
   from `sq_gram` must equal those from `sq_gram_plain`; `lower_median`,
   `trimmed_mean` and `colsort` must equal their plain versions exactly
   (+-0 equal, NaN by position), and `colsort` must put every -0 of a
   column before its +0. `ms`,
   `plain_ms` and `library_ms` are medians of 20 CUDA-event times of one
   call on an idle stream (the host's time to issue the call lies inside
   the interval); `queued_ms` and `library_queued_ms` are per call,
   medians over 5 CUDA-event times of 20 calls queued back to back (the
   host's time hides behind the device's work). For `sq_gram` and
   `weighted_rows_mean` it also prints the achieved GB/s, the host's
   time per call of the wrapper and of the library call, and their
   one-call times before their redesign, as for `selected_median_mean`
   and the three forms of `closest_mean`, `lower_median` and
   `trimmed_mean`, and for `colsort`; for the last three it also times
   the one-column form (the operand one element off alignment) beside the
   two-column one, and for `colsort` `out.copy_(x)` on the same tensor,
   the card's floor for the same bytes.
   The library calls are `torch.matmul` (1, 3, 4), `torch.sort` (5, 7),
   `torch.kthvalue` (6: the same rank on finite input; null where it
   refuses a dtype);
   `bound_ms` is the larger of the bytes the function must move over the
   card's memory rate and its operations over the card's f32
   (non-tensor-core) peak (the half forms compute in f32 too), counting
   2 operations per compare-exchange of a sorting network and 1 per
   one-sided comparator of a pruned one.
   The MNIST grid's shapes (`mnist_kernels`): at f32[51, 79,510]
   (`simples-full`) with the last f rows all NaN (the `nan` attack), f =
   24 and 12: Krum's w and Bulyan's W (f = 12) from `sq_gram` equal those
   from `sq_gram_plain`, and `sq_gram`, `weighted_rows_mean` and
   `selected_median_mean` (m2 = 1, 3 and the 27 rounds) agree with their
   plain versions; on the same rows with +-inf entries and a +-0 column,
   `lower_median` and `trimmed_mean` (f = 24: the window [24, 27) is the
   top three finite ranks) exactly, `closest_mean` (m = 27: every finite
   value, never a NaN) about the median and the trimmed mean; at
   f32[11, 431,080] (`simples-conv`, f = 4) and f32[11, 69]
   (`simples-logit`, the phishing cell) the same for Krum, `lower_median`
   and `trimmed_mean`. Records `<kernel>_n51` time kernels 1, 2, 3, 6, 7
   and 8 at the n = 51 shapes as above.
   The GAR diagnostics (`diag_kernels`, logged as a phase of its own):
   every diagnose form of the registry (`GAR.diagnosed`) at the
   headline's f32[25, 1,310,922] with f = 5 (`diag_operand`: a NaN row,
   NaN, +-inf and half-integer ties, a +-0 column): its aggregate bit for
   bit its plain form's, its launches by dtype exactly `DIAG_CALLS` (the
   aggregate's kernels, the Gram of the distances, the colsort of the
   rank trim; Bulyan's are its plain form's), and its aux held to the
   same form with every kernel's plain version on the card
   (`plain_kernels`, which launches nothing): selection and trim fraction
   exactly, distances and scores within rtol 1e-5 and 1e-5 of their
   largest finite magnitude, the aggregate within the kernels' tolerance;
   each form's time is logged against its plain form's. Then each form on
   the card against the CPU port at a small size (Bulyan n = 11, f = 2;
   Brute, CGE and Average n = 11, f = 4; the others n = 25, f = 11).
   WRN-28-10's shapes (`wrn_kernels`): the Bernoulli keep-mask kernel
   (keep 0.7, `bernoulli_masks`) against its plain version (the eager
   `prng.bernoulli`) bit for bit at the 12 masks of a step at (S, B) =
   (9, 20) and at (3, 2), against the CPU's bits at (3, 2) and at one
   mask of each width at (9, 20), and through the model's draw (12
   launches, no `dropout_masks`); its record times the 12 masks of a step
   (206.4 M elements; integer-issue bound as for `dropout_masks`).
   Kernels 1, 2, 3 and 6 at f32[11, 36,489,290] (Bulyan's W at f = 2,
   Krum's w at f = 2) against their plain versions at the tolerances
   above (6 exactly); records `<kernel>_wrn` time them as above.
   The rest of the model zoo (`zoo_kernels`, `zoo_gradients`): the mask
   kernels through the models' draws (VGG16's two 8-bit classifier
   masks, keys 0 and 1 of each worker's split, at (S, B) = (9, 50);
   MobileNetV2's Bernoulli mask from the worker keys themselves at (14,
   50) and (3, 2)), their launches and the CPU's bits; each GAR kernel
   a zoo cell launches at its cell's operand against its plain version
   (`sq_gram` and `selected_median_mean` at resnet18's f32[25,
   11,181,642], `sq_gram` and `weighted_rows_mean` at resnet50's [25,
   23,528,522], `lower_median` at vgg16's [11, 134,301,514] (5.9 GB),
   `trimmed_mean` at densenet121's [25, 6,964,106], `lower_median` and
   `closest_mean` at mobilenet_v2's [25, 2,236,682], `lower_median` at
   the transformer's [11, 104,394]), timed as records
   `<kernel>_<family>`; then each family's train-mode forward and
   gradient at full width on the card against the CPU's, batch 4, on the
   same weights and masks (`card_vs_cpu_gradient`: the card's f32
   outputs, gradient and BatchNorm state no farther from the CPU's
   float64 ones than 4 times the CPU's own f32 run, or 1e-5), the card's
   init equal to the CPU's bits for densenet121, mobilenet_v2 and the
   transformer (the resnets' and vgg16's CPU draws would take from 12 s
   to minutes: the card's weights are copied).
   Then the device-resident path (`data/device.py`): `DeviceData.gather`
   on the card gives the same bits as on the CPU (CIFAR-10's train split
   with flips, its test split, and both under `--no-transform`; MNIST
   normalized without flips, FashionMNIST flipped without normalization,
   and the raw phishing rows with float labels); the attacks' jitter
   noise: `alie.row_key` of f32[20, 1,310,922] and `prng.normal` at
   f32[5, 1,310,922] give the CPU's bits on the card; and the
   grouped honest phase on the card is held against the vmapped one at
   the headline shape (same weights, batches and dropout masks): every
   gradient row within 1e-2 relative L2 (the engine tests' max-pool
   near-tie bound), the losses within rtol 1e-4 and the BatchNorm state
   within rtol 1e-4, atol 1e-5; it prints how many rows agree
   elementwise (rtol 1e-4, atol 1e-5). The same at WRN-28-10's width for
   the appendix's Bulyan line (S = 9, shared weights) and its
   `at_worker` Median line (S = 7, per-worker lookaheads from random
   momentum buffers: `groups=7` convolutions), each phase timed on the
   device clock (median of 3).
4. Cells through the port's driver, CIFAR-10 (synthetic fallback),
   empire-cnn, n=25, batch 50, momentum 0.99 at update, clip 5,
   nb-for-study 1: the headline cell (f=5, 5 real Byzantine workers,
   Bulyan against `empire factor:1.1`, 16 steps), the `krum_f11` cell
   (f=11, 11 real, Krum against `empire factor:1.1`, 16 steps), then 16
   steps each of Median, Trimmed mean, Phocas, MeaMed and Aksel at f=11,
   11 real, against `little factor:1.5 negative:true`; the brute cell
   (f=11, 11 real, against `empire factor:1.1`) and CGE (f=11, against
   `little`); `--dtype bfloat16` runs of Median, Trimmed mean, Phocas
   and MeaMed and `--dtype float16` runs of Phocas and MeaMed (f=11,
   `little`);
   the headline cell at `--dtype float32 --compute-dtype bfloat16`, the
   headline with `--no-grouped-workers`, and the paper's CIFAR-10 grid
   cell `cifar10-empire-bulyan-f_5-lr_0.01-at_update` as `reproduce.py`
   writes it (the headline with `--learning-rate-decay 167
   --learning-rate-decay-delta 1500 --l2-regularize 1e-2
   --nb-for-study-past 25 --evaluation-delta 100`) (16 steps each).
   Then the MNIST half of the paper (synthetic MNIST and FashionMNIST,
   phishing): the driver's defaults (`default`: `mnist`, `simples-conv`,
   n = 11, `average`, `nan` with no real Byzantine worker; 16 steps, no
   kernel); `BASELINE.md` configs 2-3 (`baseline_mnist_krum`, `_median`,
   `_trmean`: `simples-conv`, n = 11, f = 4 real, `empire factor:1.1`);
   seven cells of `reproduce.py::submit_mnist` with its flags unchanged
   (`simples-full`, n = 51, batch 83); the grid's flags with `--attack
   nan` for Krum, Median, Trimmed mean, Phocas and MeaMed at f = 24 and
   Bulyan at f = 12; and `phishing-krum` (`simples-logit`, `bce`, the
   `sigmoid` criterion, n = 11, f = 4, `empire`); 50 steps each but the
   default's 16, each cut only in steps.
   Then the adaptive attacks, whose line search calls the GAR 16 times a
   step inside the attack: `headline_adaptive` (the headline's flags with
   `--attack empire` and no `--attack-args`, the JAX default
   `factor:-16`; 16 steps), `krum_f11_strict` (Krum, f=11, `empire-strict
   epsilon:-16`), `median_little_adaptive` (Median, f=11, `little
   factor:-16 negative:true`), `median_bf16_adaptive` (the same under
   `--dtype bfloat16`: f32 probes, a bf16 outer median) and `cge_anticge`
   (CGE, f=11, `anticge`), 16 steps each; and the rest of the attack
   registry on `baseline_mnist_krum`'s flags, 50 steps each:
   `mnist-alie-krum`, `mnist-alie-warmup-krum` (`window:25`: the burst,
   then the hidden phase), `mnist-framing-krum` (`victim:0 push:1.0
   jitter:0.1`), `mnist-mimic-median` (`victim:0 jitter:0.1`).
   Then the rest of the driver's training flags on the headline's
   flags, 16 steps each: `headline_mixture` (`--gars
   "bulyan,2;krum,1;median,1"`, drawn once a step on the host's mirror
   of the key chain: each member's launches equal what the draws worked
   out here from `--seed 1` predict, `mixture_draws`, and the driver
   fails a chunk whose device key differs from the mirror),
   `headline_mixture_per_call` (the same with `--gars-per-call` against
   the `empire` search: every member at each of the 16 probes and the
   outer call, 18 `operand_hash` and `mixture_draw` launches a step) and
   `headline_adam` (`--optimizer adam`).
   Then the paper's appendix grid on WRN-28-10 at full width (depth 28,
   widen 10, d = 36,489,290; n = 11, batch 20, `crossentropy`, dropout
   0.3, Nesterov, the schedule `0.02,8000,0.004,16000,0.0008`, clip 5,
   `--l2-regularize 5e-4`), its flags as `reproduce-appendix.py::submit`
   writes them: `cifar10-empire-bulyan-f_2-lr_pow-at_update-nesterov`
   (also `bench.py`'s `wrn28x10` f32 cell), `wrn28x10_mixed` (the same
   at `--dtype float32 --compute-dtype bfloat16`),
   `cifar10-little-median-f_4-lr_pow-at_worker-nesterov` (per-worker
   lookaheads, `groups=7`), `cifar10-empire-krum-f_4-lr_pow-at_update-nesterov`,
   and `baseline_wrn_aksel` (`BASELINE.md` config 5: the Bulyan line with
   `--gar aksel --nb-local-steps 2`, the vmapped honest phase); a WRN
   step launches the split of the step key and 12 Bernoulli masks a local
   step (and at two local steps one more split, of the workers' keys).
   Then the rest of the model zoo at full width, each timed
   (`ZOO_CELLS`, the vmapped honest phase: none has a grouped forward):
   on CIFAR-10 with the CIFAR cells' flags and `--loss crossentropy`
   (raw logits), `resnet18_bulyan` (n = 25, f = 5, Bulyan against
   `empire factor:1.1`), `resnet50_krum_f11` (Krum, f = 11, `little`),
   `vgg16_median` (n = 11, f = 2, Median, `little`; two dropout masks a
   step), `densenet121_trmean` (f = 11, Trimmed mean, `little`),
   `mobilenet_v2_meamed` (f = 11, MeaMed, `little`; one Bernoulli mask a
   step), 16 steps each; and `transformer_mnist_median` (the JAX driver
   test's line at the default width: MNIST, Median, 2 real Byzantine
   workers against `little factor:1.5`, 50 steps); each logs its peak
   device memory (`max_memory_allocated`).
   Then the GAR diagnostics (`DIAG_CELLS`, logged as a phase of its own),
   16 steps each with `--gar-diagnostics`: `headline_diag` (the
   headline's flags), `trmean_diag` (Trimmed mean at f = 11 against
   `little`: the rank trim's colsort, once a step) and
   `mnist_krum_worker_diag` (the JAX `tests/test_diag.py` line at the
   full width of simples-full: MNIST, n = 9, f = 2, Krum against `empire
   factor:1.1`, momentum at the workers, `--nb-for-study 7`, seed 11, on
   that test's 512 / 128 synthetic images, `CELL_ENV`),
   each with exact launches (a diagnose step's: `DIAG_CALLS` and the
   acceptation ratio's) and a study header of `STUDY_COLUMNS +
   FORENSIC_COLUMNS` whose forensic columns hold (`forensic_verdict`:
   well-formed `Sel workers`, `Suspicion max` in [0, 1], a non-zero clip
   fraction for the Trimmed mean; on the JAX test's line no attacker
   selected from step 8 on and a falling `Var/norm ratio`); then
   `diag_vs_plain`: under deterministic cuDNN `headline_diag`'s first 24
   columns are byte-equal to the headline's.
   Then the fault plans (`FAULT_CELLS`, the phase `fault cells`,
   `--fault-plan`): `headline_faults` (the headline's flags with
   HEADLINE_PLAN: a device lost, a NaN window, an attack row dropped, a
   straggler across the chunk boundary at step 8, a duplicate and a
   scaled window; masked Bulyan through `sq_gram`, `weighted_rows_mean`
   and two colsorts a step), `krum_f11_faults_diag` (krum_f11's flags
   with the plan, its scaled window on worker 4, and
   `--gar-diagnostics`: masked Krum through `sq_gram` and
   `weighted_rows_mean`, the diag program on the full stack),
   `adaptive_faults` (`headline_adaptive`'s flags with the plan: the 16
   probes of the line search take the masked Bulyan too) and
   `mnist-faults-krum-r_0.02` (`reproduce.py::submit_faults`'s line at
   rate 0.02, its plan from `FaultPlan.generate(..., seed=200)`, 30
   steps), each with exact launches (`MASKED_CALLS`), a study header of
   `STUDY_COLUMNS + FAULT_COLUMNS [+ FORENSIC_COLUMNS]` whose three fault
   columns equal the schedule's (`expected_fault_columns`) and steps/s
   beside its unfaulted cell's; the suspicion tracker's quarantine term
   for the NaN worker (`quarantine_verdict`); `masked_vs_plain`: masked
   Bulyan and Krum at the headline operand on each step of their plans,
   the kernels against their plain versions on the card (`f_eff`
   exactly, the aggregate within rtol 1e-5, atol 1e-6); `fault_vs_single`:
   `headline_faults` at M = 1 and 8 byte-equal under deterministic cuDNN;
   `fault_resume` (`resume_runs` on FAULT_RESUME, side by side under
   deterministic cuDNN): killed past step 8 and `--auto-resume`d from
   checkpoint-7, inside the straggler window, the two uninterrupted runs'
   CSVs byte for byte.
   Then health and rollback (the phase `health cells`): `headline_health`
   (the headline with `--health`; steps/s beside the headline's), the
   headline with `--no-telemetry` (telemetry is on in every other run,
   each with a result directory: `telemetry_verdict` holds each run's
   `telemetry.jsonl` and heartbeat complete) and 48 headline steps with
   and without `--rollback-budget 1`, each with exact launches;
   `health_vs_f64`: a chunk of `headline_health`, each step's health
   floats within rtol 1e-5 of an f64 recomputation on the card of its
   stack, the histograms equal but for a shown near-tie, the counts
   equal; the chunk profile of `headline_health`; then in child
   processes side by side under deterministic cuDNN
   (`health_children`): the headline and `headline_health` (the first
   24 columns and the eval file byte-equal), and the headline with a
   checkpoint every 4 steps and `--rollback-budget 2`, uninterrupted and
   poisoned after the chunk past step 6 at M = 1 and 8 (restored from
   checkpoint-4, steps 0-15 once each, `Rollbacks` 0 then 1, rows 0-3
   the uninterrupted run's, M = 1 and 8 byte-equal); beside them
   `tighten_check` (Krum at f = 5 tightened to 6, its launches exact
   over the steps run; the headline's Bulyan not tightened, as the
   driver says) and `anomaly_check` (48 single steps, the parameters
   multiplied after each step past 36: at 1e6 with `--health` the first
   anomaly edge leads the non-finite flag by at least 2 steps, with
   `--rollback-on-anomaly` the run gives up after the edge; at 10 it
   rolls back on anomalies only and gives up).
   Every run takes the driver's default `--steps-per-program` 8: chunks
   of up to 8 steps cut at every evaluation and checkpoint (`chunks`).
   Every CIFAR and WRN cell runs 16 steps, two chunks of 8 (the
   evaluation at step 16 ends the second), so the throughput, which
   counts the steps after the first chunk, times one whole chunk of 8.
   Every run starts from
   `--seed 1` alone: the JAX key tree gives its weights, step keys and
   dropout masks. Launch counts are zeroed before each run and read
   after it: every (kernel, dtype) count must equal exactly the count a
   step worked out from the code times the steps (`Cell.per_step`: the
   GAR's calls, the split of the step key once a step, and on
   empire-cnn the three dropout masks), and no other kernel may launch.
   A searching cell launches `linesearch_step` 15 times a step (after
   each of its 16 probes but the first). Each run must take every step
   and evaluation through the device-resident path and every honest phase
   through the grouped program (the vmapped one under
   `--no-grouped-workers` or at two local steps): the engine's counts
   must equal the step and evaluation counts, and its multi-step
   dispatches the chunks of more than one step worked out from the
   horizon. Each study CSV must
   carry the JAX package's header and a finite "Defense gradient norm".
   Then kill and resume (`resume_check`): an 8-step headline run with
   `--checkpoint-delta 2 --auto-resume` in child processes, twice
   uninterrupted, then SIGKILLed at step 3 (after its second checkpoint)
   and resumed with the same command line; the log says whether the two
   uninterrupted runs are byte-equal, and the resumed CSVs must then
   equal them byte for byte (up to the `Restarts` column), else lie
   within SPREAD_FACTOR (16) times their spread, or SPREAD_FLOOR (1%) of
   the column's largest magnitude, in every study column (a cosine in
   the rows where its two vectors' norms lie beyond that bound from
   zero: a vector the bound cannot tell from zero has no direction).
   Where the default runs are not byte-equal, the same three runs again
   with cuDNN's deterministic algorithms (A, B and the killed run side by
   side on the card, then the resume), held the same way.
   Then no host read inside a step (`no_host_reads`): after a warm-up
   step, one chunk of `Engine.train_multi_indexed` (its draw, uploads,
   gathers and steps) under `torch.cuda.set_sync_debug_mode("error")`,
   which fails on any synchronizing call, for the headline,
   `headline_adaptive`, `krum_f11_strict`, `median_bf16_adaptive`,
   `cge_anticge`, `headline_mixture`, `headline_mixture_per_call`,
   `headline_adam`, `headline_diag`, `headline_faults`,
   `adaptive_faults`, `krum_f11_faults_diag` (a plan attached),
   `mnist-alie-warmup-krum` and `default` (8 steps each),
   brute (1 step), the WRN Bulyan cell (2 steps) and `baseline_wrn_aksel`
   (2 steps at k = 2). Then `fused_vs_single`: the headline,
   `headline_adaptive`, `default` and (under deterministic cuDNN only)
   `headline_mixture` at `--steps-per-program` 1 and 8
   inside one call (16 steps; 20,000 synthetic CIFAR-10 train images, so
   no epoch boundary falls inside the window: a chunk that held one
   would draw its flips after the reshuffle), with steps/s of each; their
   CSVs must be byte-equal under deterministic cuDNN, and in the default
   mode within the resume check's bound (`spread_verdict`) of an M = 1
   run, the spread taken over 2 to FUSED_SINGLE_RUNS (8) M = 1 runs,
   drawn until it holds the M = 8 run: the default mode's runs part ways
   after a few steps, and two runs on one branch say nothing of the
   other. Then
   `--device-gar cpu` on `default`, Krum against `alie-warmup` (window
   8) and Krum against the default `empire` search (16 steps each): the
   defense, its line search and the attack's state on the CPU, its study
   CSV byte-equal to (or within the kernels' tolerance of) the all-card
   run's, all under deterministic cuDNN, so that only the placement
   differs (where the placement's last-bit differences grow past the
   kernels' tolerance over the 16 steps, as in the curvature column,
   within the resume check's bound of two card runs); no GAR-kernel or
   `linesearch_step` launch, one hop a step.
5. Where a step's time goes (over 3 warm steps; WRN's, the per-call
   mixture's and the zoo cells' over 1), for the headline, `krum_f11`,
   mixed-precision headline, vmapped headline,
   `mnist-empire-krum-f_24-lr_0.5-at_update`, `headline_adaptive`, the
   mixture and Adam cells (the update phase's time under Adam),
   `headline_diag` (the defense's time with the diagnose form),
   `headline_faults` (the masked defense's, on the plan's first steps) and the
   appendix's Bulyan WRN-28-10 cells and the six zoo cells, through the
   driver's path: per-phase CUDA-event times (the index draw and upload,
   the gather on the device, the step keys and dropout masks, the honest,
   defense and update phases), the
   busiest kernels and the device's busy share (`torch.profiler`; the
   union of the kernels' intervals, their summed times beside it); and
   each of them but WRN's, the per-call mixture's and the zoo's at the
   driver's default M = 8
   (`chunk_profile`): wall and device-busy ms a step over one warm chunk
   of 8.
6. Attribution and the grid: the headline
   through the driver with `--attribution --telemetry-mfu` (16 steps, the
   second chunk traced): its `attribution.json`'s phases tile `total_ms`;
   the convolution backward kernels, launched from the autograd engine's
   device thread, land in `honest` (the join by time); kernels 1
   (`gram_tiled_kernel`) and 2 (`selected_median_mean_kernel`) land in
   `gar`, as many as their wrappers' launch counters moved over the
   window; `device_ms` within 10% of phase 5's `chunk_profile` busy time
   of the headline, the phase sum within 15% of the traced chunk's
   `device_step_ms` gauge, an `mfu` gauge in (0, 0.068] (f32 against the
   bf16 peak); its steps/s beside the flag-free headline's
   (`attribution_check`). Its child processes (`grid_children`,
   `grid_children_verdict`), none of them timed, run earlier, beside the
   health cells' children (phase 4, `health_cells`): `python -m
   byzantinemomentum_tpu_torch.obs --selfcheck` on the card;
   `reproduce.py::submit_mnist`'s Krum line at n = 51, unbounded in
   practice, taking SIGUSR1 (an attributed `profile-<step>/` over one
   chunk), then SIGTERM (exit 130, status `interrupted`); the same line
   cut to 20 steps (checkpoints every 5) through the port's `Jobs`, its
   first attempt killed at step 12 and resumed from checkpoint-10,
   beside the same line uninterrupted, both under deterministic cuDNN
   and cuBLAS: the study CSVs byte-equal but for the `Restarts` column,
   the eval CSVs byte-equal.

The line before the last is the `{"kernels": [...]}` record (one record
per kernel and element type at the headline shape, launches summed over
the CIFAR runs of phase 4, the diagnostics and fault cells' included
(`colsort`'s from `trmean_diag` and the masked sorts), the two
key-tree kernels', `linesearch_step`'s,
`operand_hash`'s and `mixture_draw`'s too; one
`<kernel>_n51` record per kernel of the
MNIST grid at its n = 51 shape, launches summed over the MNIST-half runs
at n = 51; `bernoulli_masks` and one `<kernel>_wrn` record per kernel at
WRN-28-10's width, launches summed over the WRN runs; one
`<kernel>_<family>` record per kernel a zoo cell launches, at its
operand, launches from that cell);
the last line is `{"ok": true, "device": {...}}`. Before them it logs
the seconds each phase (and each WRN cell and profile) took. Needs one
card; exits non-zero without one.
"""

import collections
import contextlib
import dataclasses
import io
import itertools
import json
import math
import os
import pathlib
import re
import shutil
import signal
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from byzantinemomentum_tpu_torch import checkpoint as checkpoint_mod
from byzantinemomentum_tpu_torch import data as data_mod
from byzantinemomentum_tpu_torch import faults as faults_mod
from byzantinemomentum_tpu_torch import models as models_mod
from byzantinemomentum_tpu_torch import obs, prng
from byzantinemomentum_tpu_torch.attacks import alie
from byzantinemomentum_tpu_torch.cli import attack as driver
from byzantinemomentum_tpu_torch.data.device import DeviceData
from byzantinemomentum_tpu_torch.engine import (
    FAULT_COLUMNS, FORENSIC_COLUMNS, HEALTH_COLUMNS, RECOVERY_COLUMNS,
    STUDY_COLUMNS)
from byzantinemomentum_tpu_torch.engine import health as health_mod
from byzantinemomentum_tpu_torch.engine.step import pin_precision
from byzantinemomentum_tpu_torch.faults import inject, quorum, sanitize
from byzantinemomentum_tpu_torch.models import core as core_mod
from byzantinemomentum_tpu_torch.obs.perf import card_peaks
from byzantinemomentum_tpu_torch.ops import (
    _common, _cuda, brute, bulyan, gar_kernels, gars, krum, mixture_kernels,
    prng_kernels, search_kernels, sort_kernels)

F32, BF16, F16 = torch.float32, torch.bfloat16, torch.float16
BOOL, I64 = torch.bool, torch.int64  # the mask and split kernels' counts
# Steps of every CIFAR and WRN cell: two chunks of the driver's default
# `--steps-per-program` 8 (the evaluation at the last step ends the
# second), so the throughput, which counts the steps after the first
# chunk, times one whole chunk
STEPS = 16
M_DEFAULT = 8     # the driver's --steps-per-program
# The headline's workers and batch: its dropout masks and step keys
HEADLINE_S, HEADLINE_B = 20, 50
# The headline's stack: n = 25 rows of empire-cnn's d
HEADLINE_N, HEADLINE_D = 25, 1_310_922
# Row counts the sorting kernels meet below, each with the trims f of
# `check_sort_kernels` (closest_mean's m = n - f)
SORT_CASES = {2: (0,), 25: (5, 11), 64: (7, 31)}
# The MNIST half's shapes: n = 51 at f = 24 and 12 (simples-full), n = 11
# at f = 4 (simples-conv, and simples-logit on phishing); Bulyan at n = 51,
# f = 12 runs 27 rounds
MNIST_D, BASELINE_D, PHISHING_D = 79_510, 431_080, 69
# WRN-28-10 as `reproduce-appendix.py::submit` runs it: n = 11 workers,
# batch 20; at f = 2 the S = 9 honest workers draw the step's 12 dropout
# masks (keep 0.7: `bernoulli_masks`)
WRN_ARGS = {"depth": 28, "widen_factor": 10, "dropout_rate": 0.3,
            "num_classes": 10}
WRN_N, WRN_S, WRN_B, WRN_D = 11, 9, 20, 36_489_290
MNIST_SORT_BUILDS = (("lower_median", 51, F32), ("lower_median", 11, F32),
                     ("trimmed_mean", 51, F32, None, 24),
                     ("trimmed_mean", 51, F32, None, 12),
                     ("trimmed_mean", 11, F32, None, 4),
                     ("closest_mean", 51, F32, 27),
                     ("closest_mean", 51, F32, 39))
TOL_RTOL, TOL_ATOL = 1e-5, 1e-6  # tests/test_torch_ops.py's tolerances
# Two ulps of each half dtype: the sorting kernels' half forms round after
# every operation, as their plain versions do (tests/test_torch_gpu.py)
HALF_RTOL = {torch.bfloat16: 2.0 ** -7, torch.float16: 2.0 ** -10}
DTYPE_NAMES = _cuda.DTYPE_NAMES
# 32-bit integer operations a second: an SM has 64 INT32 lanes against
# 128 FP32 lanes, and the f32 rate counts an FMA as 2 operations, so a
# quarter of the f32 rate (16.75 T/s on the SXM part)
INT32_SHARE = 0.25
# Phase-3 times of the redesigned kernels before their redesign (one call
# each, PERF.md's kernel table, NVIDIA H100 80GB HBM3, 700.00 W), printed
# beside this run's
BEFORE_REDESIGN_MS = {"sq_gram": 0.3078, "weighted_rows_mean": 0.0888,
                      "selected_median_mean": 0.1346, "closest_mean": 0.1787,
                      "closest_mean_bf16": 0.1786, "closest_mean_f16": 0.1931,
                      "lower_median": 0.0939, "lower_median_bf16": 0.1002,
                      "lower_median_f16": 0.0949, "trimmed_mean": 0.1138,
                      "trimmed_mean_bf16": 0.1168, "trimmed_mean_f16": 0.1145,
                      "colsort": 0.1406, "colsort_bf16": 0.1201,
                      "colsort_f16": 0.1094}


def log(*args):
    print(*args, flush=True)


def cuda_ms(fn, reps=20, warmup=3):
    """Median CUDA-event time of one call of `fn()` on an idle stream, in
    milliseconds (the host's time to issue the call lies inside the
    interval)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def queued_ms(fn, launches=20, reps=5):
    """Median over `reps` of the CUDA-event time of `launches` calls of
    `fn()` queued back to back, per call: the device's time, where the
    host issues a call faster than the device runs it."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(launches):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / launches)
    return statistics.median(times)


def host_us(fn, calls=200):
    """The host's time per call of `fn()` in microseconds, over `calls`
    calls with no synchronization inside the window."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e6


def compare(name, got, want, atol=TOL_ATOL, rtol=TOL_RTOL):
    """Non-finite masks exact, finite values within tolerance; returns the
    largest absolute error over the finite entries."""
    got, want = got.float().cpu(), want.float().cpu()
    for kind, test in (("NaN", torch.isnan), ("+inf", torch.isposinf),
                       ("-inf", torch.isneginf)):
        if not torch.equal(test(got), test(want)):
            raise SystemExit(f"{name}: {kind} positions differ")
    finite = torch.isfinite(want)
    err = (got[finite] - want[finite]).abs()
    bad = err > atol + rtol * want[finite].abs()
    if bool(bad.any()):
        raise SystemExit(f"{name}: {int(bad.sum())} values off, max abs "
                         f"error {float(err.max())}")
    return float(err.max()) if err.numel() else 0.0


def environment():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script needs a GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    pin_precision()
    log(smi)
    log(f"python {sys.version.split()[0]} torch {torch.__version__} cuda "
        f"{torch.version.cuda} device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")
    matmul = torch.backends.cuda.matmul
    log(f"tf32 matmul {matmul.allow_tf32} cudnn "
        f"{torch.backends.cudnn.allow_tf32}; reduced-precision reductions "
        f"bf16 {matmul.allow_bf16_reduced_precision_reduction} f16 "
        f"{matmul.allow_fp16_reduced_precision_reduction}")
    return smi


def build():
    """Phase 2: the `sq_gram`/`weighted_rows_mean`/`masked_rows_mean`
    library, the `selected_median_mean` ones for the round counts this
    script meets (13 at n=25, f=5; 5 at n=11, f=2; 27 at n=51, f=12), the
    MNIST grid's f32 sorting kernels (`MNIST_SORT_BUILDS`) and the four sorting
    kernels at the row counts and element types it meets (`closest_mean`
    for each m, `trimmed_mean` for each f it meets), compiled side by
    side; prints each kernel's registers and spills, and fails on a
    spill."""
    jobs = [(prng_kernels.build,), (search_kernels.build,),
            (mixture_kernels.build,)]
    jobs += [(gar_kernels.build, rounds) for rounds in (0, 5, 13, 27)]
    # The masked Bulyan's stack of n - 2 rounds (the fault cells)
    jobs.append((sort_kernels.build, "colsort", HEADLINE_N - 2, F32))
    jobs += [(sort_kernels.build, *job) for job in MNIST_SORT_BUILDS]
    jobs += [(sort_kernels.build, kernel, n, dtype)
             for kernel in ("lower_median", "colsort")
             for n in SORT_CASES for dtype in sort_kernels.DTYPES]
    jobs += [(sort_kernels.build, kernel, n, dtype, *extra)
             for n, fs in SORT_CASES.items() for f in fs
             for dtype in sort_kernels.DTYPES
             for kernel, extra in (("closest_mean", (n - f,)),
                                   ("trimmed_mean", (None, f)))]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(jobs)) as pool:
        built = list(pool.map(lambda job: job[0](*job[1:]), jobs))
    log(f"build {len(built)} libraries in {time.perf_counter() - t0:.1f} s "
        f"-> {', '.join(path.name for path, _ in built)}")
    spills = []
    for path, text in built:
        kernels = re.findall(
            r"Function properties for (\w+)\s+\d+ bytes stack frame, (\d+) "
            r"bytes spill stores.*?Used (\d+) registers", text, re.S)
        log(f"  ptxas {path.name}: " + ", ".join(
            f"{kernel_name(name)} {regs} registers, {spill} bytes spilled"
            for name, spill, regs in kernels))
        spills += [f"{path.name}: {kernel_name(name)}"
                   for name, spill, _ in kernels if int(spill)]
    if spills:
        raise SystemExit(f"ptxas spilled registers in {', '.join(spills)}")
    for path, _ in built:
        if re.search(r"-r13\.so$|-closest_mean-n25-\w+-m14\.so$|"
                     r"-(lower_median|colsort)-n25-\w+\.so$|"
                     r"-trimmed_mean-n25-\w+-f11\.so$", path.name):
            sass_summary(path)


def sass_summary(path):
    """Instruction counts of each kernel of a library, from `cuobjdump
    -sass` (NOPs left out): in all, FFMA, integer min/max, and each loop
    (a backward branch) with its FFMA."""
    cuobjdump = pathlib.Path("/usr/local/cuda/bin/cuobjdump")
    if not cuobjdump.is_file():
        log(f"  sass {path.name}: cuobjdump not found")
        return
    text = subprocess.run([str(cuobjdump), "-sass", str(path)], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    for function in text.split("Function : ")[1:]:
        code = [(int(addr, 16), op) for addr, op in re.findall(
            r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)",
            function) if op != "NOP"]
        loops = []
        for addr, op in code:
            if not op.startswith("BRA"):
                continue
            target = re.search(rf"/\*{addr:04x}\*/[^;]*BRA[^;]*0x([0-9a-f]+)", function)
            if target and int(target.group(1), 16) < addr:
                body = [o for a, o in code if int(target.group(1), 16) <= a <= addr]
                loops.append(f"{len(body)} ({sum(o.startswith('FFMA') for o in body)} FFMA)")
        ops = [op for _, op in code]
        log(f"  sass {kernel_name(function.split()[0])}: {len(ops)} instructions, "
            f"{sum(op.startswith('FFMA') for op in ops)} FFMA, "
            f"{sum('IMNMX' in op for op in ops)} integer min/max; loops "
            + ", ".join(loops))


def kernel_name(mangled):
    """`name<args>` of a mangled kernel: the name is <length><name> before
    its template (I...E, integer arguments as Li<value>E) or parameter
    (E...) list."""
    match = re.search(r"[0-9]([a-z_]+_kernel)(?=[EI])(I(?:Li-?[0-9]+E)+E)?",
                      mangled)
    if not match:
        return mangled
    args = re.findall(r"Li(-?[0-9]+)E", match.group(2) or "")
    return match.group(1) + (f"<{','.join(args)}>" if args else "")


def split_record_name(name):
    """(kernel, dtype, family of runs) of a record's name: the f32 form at
    the headline shape under the kernel's name, the half forms as
    `<kernel>_bf16` and `<kernel>_f16` (family "cifar"); the MNIST
    half's f32 form at n workers as `<kernel>_n<n>` (family "n<n>"); the
    f32 form at WRN-28-10's width as `<kernel>_wrn` (family "wrn"); the
    key-tree kernels under their names, in the operand types they count
    (the masks' bool, the split's int64), family "cifar", but the
    Bernoulli masks, which only WRN draws (family "wrn"); a kernel at a
    zoo model's shapes as `<kernel>_<family>` (`ZOO`: "vgg16", ...), the
    masks in bool."""
    if name in ("dropout_masks", "split_keys", "mixture_draw"):
        return name, BOOL if name == "dropout_masks" else I64, "cifar"
    if name == "bernoulli_masks":
        return name, BOOL, "wrn"
    match = re.fullmatch(r"(\w+?)_(n[0-9]+|wrn|" + "|".join(ZOO) + ")", name)
    if match:
        kernel = match.group(1)
        return (kernel, BOOL if kernel.endswith("_masks") else F32,
                match.group(2))
    for half in (BF16, F16):
        suffix = "_" + DTYPE_NAMES[half]
        if name.endswith(suffix):
            return name[:-len(suffix)], half, "cifar"
    return name, F32, "cifar"


SOURCES = {"sq_gram": "gar_kernels.cu", "selected_median_mean": "gar_kernels.cu",
           "weighted_rows_mean": "gar_kernels.cu",
           "masked_rows_mean": "gar_kernels.cu",
           "dropout_masks": "prng_kernels.cu", "split_keys": "prng_kernels.cu",
           "bernoulli_masks": "prng_kernels.cu",
           "linesearch_step": "search_kernels.cu",
           "operand_hash": "mixture_kernels.cu",
           "mixture_draw": "mixture_kernels.cu"}
# The key-tree kernels replace no Pallas kernel: they stand where XLA
# generates the threefry hash in the JAX package
REPLACES = {"dropout_masks": "models/core.py:561",
            "linesearch_step": "ops/linesearch.py:92",
            "operand_hash": "engine/step.py:511",
            "mixture_draw": "engine/program.py:81",
            "bernoulli_masks": "models/core.py:577",
            "split_keys": "engine/step.py:598",
            "sq_gram": "pallas_gar.py:135", "selected_median_mean": "pallas_gar.py:237",
            "weighted_rows_mean": "pallas_gar.py:210",
            "masked_rows_mean": "pallas_gar.py:258",
            "colsort": "pallas_sort.py:189",
            "lower_median": "pallas_sort.py:200",
            "trimmed_mean": "pallas_sort.py:215",
            "closest_mean": "pallas_sort.py:252"}


def timed_record(name, kernel, fn, plain, library, nbytes, ops, err, smi,
                 integer=False):
    """The `kernels` record of one kernel call `fn` (launches filled in
    after phase 4): its times, its plain version's and its library
    call's, and its bound from `nbytes` and `ops`, f32 operations or,
    with `integer`, 32-bit integer ones; logged."""
    bandwidth, flops32 = card_peaks(smi)
    rate = flops32 * INT32_SHARE if integer else flops32
    t_bytes, t_ops = nbytes / bandwidth * 1e3, ops / rate * 1e3
    rec = {
        "name": name, "route": "cuda",
        "source": "byzantinemomentum_tpu_torch/csrc/"
                  + SOURCES.get(kernel, "sort_kernels.cu"),
        "replaces": "byzantinemomentum_tpu/" + (
            REPLACES[kernel] if "/" in REPLACES[kernel]
            else "ops/" + REPLACES[kernel]),
        "launches": None, "max_abs_err": err,
        "ms": cuda_ms(fn), "plain_ms": cuda_ms(plain),
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": cuda_ms(library) if library else None,
        "queued_ms": queued_ms(fn),
        "library_queued_ms": queued_ms(library) if library else None}
    log(f"  {name}: {rec['ms']:.4f} ms ({rec['queued_ms']:.4f} queued), "
        f"plain {rec['plain_ms']:.4f} ms, bound {rec['bound_ms']:.4f} ms "
        f"({rec['bound_by']}), library {rec['library_ms']} "
        f"({rec['library_queued_ms']} queued)")
    return rec


def kernels_vs_plain(smi):
    """Phase 3; returns the per-kernel records without launch counts."""
    dev = torch.device("cuda")
    n, f, d = 25, 5, 1310922
    f11 = 11
    gen = torch.Generator(device=dev).manual_seed(0)
    g = torch.randn((n, d), generator=gen, device=dev)
    dist = _common.pairwise_distances(g)
    W = bulyan.selection_weights(dist, f)
    w = krum.selection_weights(dist, f11)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    mask = brute.best_subset_mask_from_dist(dist, f11)
    end.record()
    end.synchronize()
    k = n - f11
    rounds = W.shape[0]
    m2 = rounds - 2 * f
    log(f"headline operand f32{list(g.shape)}: rounds {rounds}, m2 {m2}; "
        f"Krum at f={f11} selects {int((w > 0).sum())} rows; Brute at "
        f"f={f11} keeps {int(mask.sum())} rows (the enumeration of "
        f"{math.comb(n, k)} subsets took {start.elapsed_time(end):.1f} ms)")
    if int(mask.sum()) != k:
        raise SystemExit(f"brute mask keeps {int(mask.sum())} rows, not {k}")
    # The selections from the kernel's Gram must be those of the plain one
    plain_dist = _common.distances_from_sq_gram(gar_kernels.sq_gram_plain(g))
    for label, got, want in (
            ("Bulyan's W", W, bulyan.selection_weights(plain_dist, f)),
            ("Krum's w", w, krum.selection_weights(plain_dist, f11)),
            ("Brute's mask", mask, brute.best_subset_mask_from_dist(plain_dist, f11))):
        if not torch.equal(got, want):
            raise SystemExit(f"{label} from sq_gram differs from the one "
                             f"from sq_gram_plain")
    log("Bulyan's W, Krum's w and Brute's mask from sq_gram equal those "
        "from sq_gram_plain at the headline operand")
    # One record per kernel and element type: f32 under the kernel's name,
    # the half forms as `<kernel>_bf16` and `<kernel>_f16`
    errs = dict.fromkeys(("sq_gram", "selected_median_mean",
                          "weighted_rows_mean", "masked_rows_mean",
                          *sort_kernels.KERNELS), 0.0)
    errs.update({f"{kernel}_{DTYPE_NAMES[dtype]}": 0.0
                 for dtype in (BF16, F16) for kernel in sort_kernels.KERNELS})

    def record_name(kernel, dtype):
        return kernel if dtype == F32 else f"{kernel}_{DTYPE_NAMES[dtype]}"

    def check(name, label, got, want, atol=TOL_ATOL, dtype=F32, rtol=None):
        if rtol is None:
            rtol = HALF_RTOL.get(dtype, TOL_RTOL)
        if got.dtype != want.dtype or got.dtype != dtype:
            raise SystemExit(f"{name} {label}: dtype {got.dtype}, plain "
                             f"{want.dtype}, expected {dtype}")
        name = record_name(name, dtype)
        errs[name] = max(errs[name], compare(f"{name} {label}", got, want,
                                             atol, rtol))

    def gram_atol(plain):
        diag = torch.diagonal(plain)
        return TOL_RTOL * float(diag[torch.isfinite(diag)].max())

    def signed_zeros_in_order(name, out):
        """Every -0 of a column of `out` before its +0 (the keys' order)."""
        out = out.float()
        rank = torch.arange(out.shape[0], device=out.device)[:, None]
        zero = out == 0
        neg, pos = zero & torch.signbit(out), zero & ~torch.signbit(out)
        last_neg = torch.where(neg, rank, -1).amax(dim=0)
        first_pos = torch.where(pos, rank, out.shape[0]).amin(dim=0)
        if not bool((last_neg < first_pos).all()):
            raise SystemExit(f"{name}: a +0 comes before a -0 in a column")

    def check_sort_kernels(label, h, fs, dtypes=sort_kernels.DTYPES):
        nh = h.shape[0]
        for dtype in dtypes:
            x = h.to(dtype)
            tol = {"dtype": dtype, "atol": 0.0 if dtype != F32 else TOL_ATOL}
            # The column sort and the median move values: exactly equal
            # (+-0 equal, NaN by position); the trimmed mean adds and
            # divides as its plain version does
            out = sort_kernels.colsort(x)
            check("colsort", label, out, sort_kernels.colsort_plain(x),
                  atol=0.0, dtype=dtype, rtol=0.0)
            signed_zeros_in_order(f"colsort {label} {dtype}", out)
            del out
            check("lower_median", label, sort_kernels.lower_median(x),
                  sort_kernels.lower_median_plain(x), atol=0.0, dtype=dtype,
                  rtol=0.0)
            for fh in fs:
                check("trimmed_mean", f"{label} f={fh}",
                      sort_kernels.trimmed_mean(x, fh),
                      sort_kernels.trimmed_mean_plain(x, fh), atol=0.0,
                      dtype=dtype, rtol=0.0)
                for centre_name, centre in (
                        ("median", sort_kernels.lower_median_plain(x)),
                        ("trmean", sort_kernels.trimmed_mean_plain(x, fh))):
                    check("closest_mean", f"{label} m={nh - fh} about the "
                          f"{centre_name}",
                          sort_kernels.closest_mean(x, centre, nh - fh),
                          sort_kernels.closest_mean_plain(x, centre, nh - fh),
                          **tol)

    plain_gram = gar_kernels.sq_gram_plain(g)
    check("sq_gram", "headline", gar_kernels.sq_gram(g), plain_gram,
          atol=gram_atol(plain_gram))
    for m in (1, m2):
        check("selected_median_mean", f"headline m2={m}",
              gar_kernels.selected_median_mean(W, g, m),
              gar_kernels.selected_median_mean_plain(W, g, m))
    for label, weights in (("Krum f=11", w), ("Bulyan W", W)):
        check("weighted_rows_mean", f"headline {label}",
              gar_kernels.weighted_rows_mean(weights, g),
              gar_kernels.select_rows(weights, g))
    check("masked_rows_mean", "headline Brute f=11",
          gar_kernels.masked_rows_mean(mask, g, k),
          gar_kernels.masked_rows_mean_plain(mask, g, k))
    check_sort_kernels("headline", g, (f, f11))
    # The masked Bulyan's stack of n - 2 rounds (the fault cells) at the
    # headline width: the rows of its inert rounds NaN (from round
    # n - 2f - 2 = 13 on where all 25 rows are active)
    stack = g[:n - 2].clone()
    stack[rounds:] = torch.nan
    out = sort_kernels.colsort(stack)
    check("colsort", f"headline n={n - 2}, rows {rounds}.. NaN", out,
          sort_kernels.colsort_plain(stack), atol=0.0, rtol=0.0)
    signed_zeros_in_order(f"colsort headline n={n - 2}", out)
    del stack, out

    # Ragged d: NaN rows, +-inf, a selected NaN, half-integer values (ties,
    # +0 only)
    rng = np.random.default_rng(1)

    def ragged(rows):
        h = np.round(rng.standard_normal((rows, 100_003)) * 2.0).astype(np.float32) / 2.0
        h += np.float32(0.0)
        h[rows - 1, rng.integers(0, h.shape[1], 50)] = np.nan
        h[min(3, rows - 1), rng.integers(0, h.shape[1], 50)] = np.nan
        h[0, rng.integers(0, h.shape[1], 20)] = np.inf
        h[rows // 2, rng.integers(0, h.shape[1], 20)] = -np.inf
        # Columns whose median is +inf (0..4) and -inf (5..9), a column
        # of +-0 only (10); the rows past the first half stay finite there
        h[:rows // 2 + 1, 0:5] = np.inf
        h[:rows // 2 + 1, 5:10] = -np.inf
        h[:, 10] = np.where(rng.random(rows) < 0.5, -0.0, 0.0)
        return torch.from_numpy(h).to(dev)

    h = ragged(n)
    Wr = bulyan.selection_weights(_common.pairwise_distances(h), f)
    Wr[0, n - 1] = Wr[0][Wr[0] > 0][0]  # round 0 also selects a NaN row
    plain_h = gar_kernels.sq_gram_plain(h)
    check("sq_gram", "ragged", gar_kernels.sq_gram(h), plain_h,
          atol=gram_atol(plain_h))
    for m in (1, 2, 3, rounds):
        check("selected_median_mean", f"ragged m2={m}",
              gar_kernels.selected_median_mean(Wr, h, m),
              gar_kernels.selected_median_mean_plain(Wr, h, m))
    # With m2 = rounds every stack value is taken: the NaN must come out
    if not bool(gar_kernels.selected_median_mean(Wr, h, rounds).isnan().any()):
        raise SystemExit("ragged case: the selected NaN reached no output")
    wr = (Wr[0] > 0).float() / float((Wr[0] > 0).sum())
    for label, weights in (("w", wr), ("W", Wr)):
        out = gar_kernels.weighted_rows_mean(weights, h)
        check("weighted_rows_mean", f"ragged {label}", out,
              gar_kernels.select_rows(weights, h))
        if not bool(out.isnan().any()):
            raise SystemExit("ragged case: weighted_rows_mean lost the selected NaN")
    # Brute's mean keeps row 0 (+inf entries) and drops the NaN rows: a
    # selected +inf stays +inf, not NaN
    keep = torch.zeros(n, dtype=torch.bool, device=dev)
    keep[torch.arange(0, n - 1, 2, device=dev)] = True
    keep[3] = False
    out = gar_kernels.masked_rows_mean(keep, h, int(keep.sum()))
    check("masked_rows_mean", "ragged", out,
          gar_kernels.masked_rows_mean_plain(keep, h, int(keep.sum())))
    if not bool(out.isposinf().any()):
        raise SystemExit("ragged case: masked_rows_mean lost a selected +inf")
    check_sort_kernels("ragged", h, (f, f11))

    # The row counts at the ends of the kernels' domain
    for rows in (2, 64):
        fs = SORT_CASES[rows]
        h = ragged(rows)
        check_sort_kernels(f"n={rows}", h, fs)
        W_rows = torch.from_numpy(
            (rng.random((rows, rows)) < 0.5).astype(np.float32) / rows).to(dev)
        W_rows[:, rows - 1] = 1.0 / rows  # every row selects the NaN row
        for label, weights in (("w", W_rows[0]), ("W", W_rows)):
            check("weighted_rows_mean", f"n={rows} {label}",
                  gar_kernels.weighted_rows_mean(weights, h),
                  gar_kernels.select_rows(weights, h))
        check("masked_rows_mean", f"n={rows}",
              gar_kernels.masked_rows_mean(W_rows[0] > 0, h, rows // 2),
              gar_kernels.masked_rows_mean_plain(W_rows[0] > 0, h, rows // 2))

    # Each GAR: the CUDA path against the CPU plain path
    small = torch.from_numpy(rng.standard_normal((11, 5001)).astype(np.float32))
    compare("bulyan cuda vs cpu", gars["bulyan"](small.to(dev), f=2),
            gars["bulyan"](small, f=2))
    small[7:] = small[:7].mean(dim=0) - 1.5 * small[:7].std(dim=0)
    small[2, :7] = torch.nan
    for name in ("brute", "cge"):
        compare(f"{name} cuda vs cpu", gars[name](small.to(dev), f=4),
                gars[name](small, f=4))
        if (float(gars[name].influence(small[:7].to(dev), small[7:].to(dev), f=4))
                != float(gars[name].influence(small[:7], small[7:], f=4))):
            raise SystemExit(f"{name}: influence differs on the card")
    small = torch.from_numpy(rng.standard_normal((25, 20_001)).astype(np.float32))
    small[14:] = small[:14].mean(dim=0) - 1.5 * small[:14].std(dim=0)
    small[2, :7] = torch.nan
    for name, kwargs in (("krum", {}), ("median", {}), ("trmean", {}),
                         ("phocas", {}), ("meamed", {}), ("aksel", {}),
                         ("aksel", {"mode": "n-f"})):
        compare(f"{name} cuda vs cpu", gars[name](small.to(dev), f=f11, **kwargs),
                gars[name](small, f=f11, **kwargs))
    for dtype in (BF16, F16):
        half = small.to(dtype)
        for name in ("median", "trmean", "phocas", "meamed"):
            compare(f"{name} {DTYPE_NAMES[dtype]} cuda vs cpu",
                    gars[name](half.to(dev), f=f11), gars[name](half, f=f11),
                    atol=0.0, rtol=HALF_RTOL[dtype])
    log("kernels agree with their plain versions: " + ", ".join(
        f"{name} max abs err {err:.3e}" for name, err in errs.items()))

    def kthvalue(x):
        """`torch.kthvalue` at the lower median's rank (the same function
        on finite input), or None, with the error printed, where it
        refuses x's dtype on the card."""
        def call():
            return torch.kthvalue(x, (n - 1) // 2 + 1, dim=0)
        try:
            call()
            torch.cuda.synchronize()
        except RuntimeError as err:
            log(f"  torch.kthvalue refuses {x.dtype}: {err}")
            return None
        return call

    exchanges = len(sort_kernels.batcher_pairs(n))
    # The keyed networks are pruned to the ranks read: one operation a
    # one-sided comparator, two a two-sided one
    closest_ops = sort_kernels.selection_operations(n, n - f11 - 1)
    median_ops = sort_kernels.selection_operations(n, (n - 1) // 2)
    trimmed_ops = sort_kernels.selection_operations(n, range(f11, n - f11))
    # (name, kernel, plain, library call, bytes, f32 operations)
    work = [
        ("sq_gram", lambda: gar_kernels.sq_gram(g),
         lambda: gar_kernels.sq_gram_plain(g), lambda: torch.matmul(g, g.T),
         (n * d + n * n) * 4, 2 * (n * (n + 1) // 2) * d),
        ("selected_median_mean",
         lambda: gar_kernels.selected_median_mean(W, g, m2),
         lambda: gar_kernels.selected_median_mean_plain(W, g, m2), None,
         (n * d + rounds * n + d) * 4,
         (2 * rounds * n + sort_kernels.selection_operations(rounds)) * d),
        ("weighted_rows_mean", lambda: gar_kernels.weighted_rows_mean(w, g),
         lambda: gar_kernels.select_rows(w, g), lambda: torch.matmul(w, g),
         (n * d + n + d) * 4, 2 * n * d),
        # The k selected rows are all it must read; k adds and a divide a
        # coordinate. The library call is equivalent on finite input only
        ("masked_rows_mean", lambda: gar_kernels.masked_rows_mean(mask, g, k),
         lambda: gar_kernels.masked_rows_mean_plain(mask, g, k),
         lambda: torch.matmul(mask.float(), g) / k,
         (k * d + d) * 4 + n, (k + 1) * d)]
    for dtype in sort_kernels.DTYPES:
        x = g.to(dtype)
        size = x.element_size()
        median = sort_kernels.lower_median_plain(x)
        work += [
            (record_name("colsort", dtype), lambda x=x: sort_kernels.colsort(x),
             lambda x=x: sort_kernels.colsort_plain(x),
             lambda x=x: torch.sort(x, dim=0).values,
             2 * n * d * size, 2 * exchanges * d),
            (record_name("lower_median", dtype),
             lambda x=x: sort_kernels.lower_median(x),
             lambda x=x: sort_kernels.lower_median_plain(x),
             kthvalue(x), (n * d + d) * size, median_ops * d),
            # n - 2f - 1 adds and a divide
            (record_name("trimmed_mean", dtype),
             lambda x=x: sort_kernels.trimmed_mean(x, f11),
             lambda x=x: sort_kernels.trimmed_mean_plain(x, f11),
             lambda x=x: torch.sort(x, dim=0),
             (n * d + d) * size, (trimmed_ops + n - 2 * f11) * d),
            # Deviations: a subtract and an absolute value per value
            (record_name("closest_mean", dtype),
             lambda x=x, c=median: sort_kernels.closest_mean(x, c, n - f11),
             lambda x=x, c=median: sort_kernels.closest_mean_plain(x, c, n - f11),
             None, (n * d + 2 * d) * size, (closest_ops + 2 * n) * d)]
    records = []
    for name, fn, plain, library, nbytes, ops in work:
        kernel, dtype, _ = split_record_name(name)
        rec = timed_record(name, kernel, fn, plain, library, nbytes, ops,
                           errs[name], smi)
        records.append(rec)
        if kernel in ("lower_median", "trimmed_mean", "colsort"):
            # The one-column form at the same shape: `column_width` takes it
            # for an operand one element past an aligned allocation
            off = torch.empty(n * d + 1, dtype=dtype, device=dev)[1:].view(n, d)
            off.copy_(g)
            args = (f11,) if kernel == "trimmed_mean" else ()

            def single(off=off, args=args, wrapper=getattr(sort_kernels, kernel)):
                return wrapper(off, *args)
            log(f"    {name}: one column a thread (the operand one element off "
                f"alignment) {cuda_ms(single):.4f} ms ({queued_ms(single):.4f} "
                f"queued), two: {rec['ms']:.4f} ({rec['queued_ms']:.4f})")
            del off, single
        if kernel == "colsort":
            src = g.to(dtype)
            dst = torch.empty_like(src)

            def copy(src=src, dst=dst):
                return dst.copy_(src)
            log(f"    {name}: the card's floor for the same bytes, out.copy_(x) "
                f"on the same tensor: {cuda_ms(copy):.4f} ms ({queued_ms(copy):.4f} "
                f"queued); the kernel {rec['ms']:.4f} ({rec['queued_ms']:.4f})")
            del src, dst, copy
        if name in BEFORE_REDESIGN_MS:
            library_us = f"{host_us(library):.2f} us" if library else "none"
            log(f"    {name}: {nbytes / rec['ms'] / 1e6:.1f} GB/s achieved one "
                f"call, {nbytes / rec['queued_ms'] / 1e6:.1f} queued "
                f"({nbytes} bytes); host time per call {host_us(fn):.2f} us "
                f"(library {library_us}); before the redesign one call "
                f"took {BEFORE_REDESIGN_MS[name]} ms (NVIDIA H100 80GB "
                f"HBM3, 700.00 W)")
    return records


def key_tree_kernels(smi):
    """Phase 3, the key tree: `prng_kernels.dropout_masks` against its
    plain version on the card and the CPU's bits for the three masks at
    the headline's (S, B) = (20, 50), at krum_f11's S = 14 and at a ragged
    (3, 5) that fills no whole block; the model's draw through it (three
    launches); `split_keys` against the CPU's bits; `init` of empire-cnn
    and simples-conv on the card against the CPU's bits. Returns the timed
    records of the two kernels at the headline: the three masks of a step
    (24.7 M bytes written, integer-issue bound) and the split of the
    step's key into S + 2."""
    dev = torch.device("cuda")
    model = models_mod.build("empire-cnn", device=dev)
    for S, B in ((HEADLINE_S, HEADLINE_B), (14, 50), (3, 5)):
        wkeys = prng.split(prng.fold_in(prng.PRNGKey(S), B), S)
        for j, shape in enumerate(model.jax_mask_shapes(B)):
            got = prng_kernels.dropout_masks(wkeys.to(dev), j, shape, 192)
            plain = prng_kernels.dropout_masks_plain(wkeys.to(dev), j, shape, 192)
            cpu = prng_kernels.dropout_masks_plain(wkeys, j, shape, 192)
            if not (torch.equal(got, plain) and torch.equal(got.cpu(), cpu)):
                raise SystemExit(f"dropout_masks differs from its plain version "
                                 f"or the CPU's bits at S={S} B={B} mask {j}")
        _cuda.reset_launches()
        card = model.draw_masks(wkeys.to(dev), B)
        if prng_kernels.dropout_masks.launches != 3:
            raise SystemExit("draw_masks did not launch the mask kernel 3 times")
        for got, want in zip(card, model.draw_masks(wkeys, B)):
            if not torch.equal(got.cpu(), want):
                raise SystemExit(f"the card's masks differ from the CPU's at "
                                 f"S={S} B={B}")
        log(f"dropout_masks S={S} B={B}: the three masks equal the plain "
            f"version and the CPU's bits (keep share "
            f"{float(card[0].float().mean()):.4f})")
    for n in (3, HEADLINE_S + 2, 53):
        key = prng.fold_in(prng.PRNGKey(n), 1)
        if not torch.equal(prng_kernels.split_keys(key.to(dev), n).cpu(),
                           prng.split(key, n)):
            raise SystemExit(f"split_keys into {n} differs from the CPU's bits")
    for name in ("empire-cnn", "simples-conv"):
        card, cpu = (models_mod.build(name, device=where) for where in (dev, "cpu"))
        card.init(prng.PRNGKey(1, device=dev))
        cpu.init(prng.PRNGKey(1))
        for (key, a), (_, b) in zip(card.state_dict().items(),
                                    cpu.state_dict().items()):
            if not torch.equal(a.cpu(), b):
                raise SystemExit(f"{name}.init on the card differs from the "
                                 f"CPU's bits at {key}")
    log("split_keys and the init of empire-cnn and simples-conv on the card "
        "equal the CPU's bits")

    wkeys = prng.split(prng.PRNGKey(0, device=dev), HEADLINE_S)
    shapes = model.jax_mask_shapes(HEADLINE_B)
    elements = HEADLINE_S * sum(math.prod(shape) for shape in shapes)

    def masks():
        return [prng_kernels.dropout_masks(wkeys, j, shape, 192)
                for j, shape in enumerate(shapes)]

    def masks_plain():
        return [prng_kernels.dropout_masks_plain(wkeys, j, shape, 192)
                for j, shape in enumerate(shapes)]

    rng = prng.fold_in(prng.PRNGKey(1, device=dev), 1)
    n = HEADLINE_S + 2
    records = [
        timed_record("dropout_masks", "dropout_masks", masks, masks_plain, None,
                     HEADLINE_S * 16 + elements,
                     prng_kernels.hash_operations(elements), 0.0, smi,
                     integer=True),
        timed_record("split_keys", "split_keys",
                     lambda: prng_kernels.split_keys(rng, n),
                     lambda: prng_kernels.split_keys_plain(rng, n), None,
                     16 + n * 16, n * 72, 0.0, smi, integer=True)]
    log(f"  dropout_masks: the three masks of a headline step, {elements} "
        f"elements ({elements} bytes written): host time a step "
        f"{host_us(masks):.2f} us (plain {host_us(masks_plain, calls=20):.2f} us)")
    log(f"  split_keys into {n}: host time a step "
        f"{host_us(lambda: prng_kernels.split_keys(rng, n)):.2f} us, the eager "
        f"int64 threefry {host_us(lambda: prng.split(rng, n)):.2f} us")
    return records


def search_states():
    """Line-search states through expansion, contraction and the guard:
    prop_x above and below best_x, prop_x = 0 with deltas up to the
    largest f32 (the guard halves down to -0), a subnormal step, and 48
    random states whose values lie within 8 times the smallest normal
    (the flushes of subnormal operands and results); better, worse,
    equal, NaN and subnormal values (1 + 2^-40 beats 1 only in f64, 1e-40
    is subnormal in f32 and 1e-310 in f64). Yields `(xs, best_y, ints,
    y)` as Python values."""
    big, tiny = float(np.finfo(np.float32).max), 1e-45
    normal = float(np.finfo(np.float32).tiny)
    xs = [(0.0, 1.0, 1.0), (3.0, 7.0, 4.0), (7.0, 3.0, 0.8), (5.5, 5.5, 2.25),
          (1.0, 0.0, big), (0.0, 0.0, big), (2.0, tiny, big), (0.2, 0.2, 0.64),
          (1e30, 1e-30, 3e38), (0.0, -0.0, 0.5), (4.0, 4.0, tiny),
          (0.0, 2.0 ** -125, 2.0 ** -123), (0.0, normal, normal / 0.8)]
    rng = np.random.default_rng(0)
    xs += [tuple(float(v) for v in row)
           for row in np.float32(rng.uniform(0, 8, (48, 3)) * normal)]
    ys = [(0.0, 1.0), (1.0, 0.0), (2.0, 2.0), (0.0, math.nan), (math.nan, 1.0),
          (1.0, 1.0 + 2.0 ** -40), (0.0, 1e-40), (0.0, 1e-310)]
    for x in xs:
        for best_y, y in ys:
            for phase in (0, 1):
                yield x, best_y, (phase, 9), y


def search_kernel(smi):
    """Phase 3, the line search's state update: `search_kernels.
    linesearch_step` against its plain version on the card and the CPU's,
    bit for bit (signed zeros included), on `search_states()` with f32
    and f64 values; its record: one probe's update (52 bytes in and out
    of the f32 form, a dozen scalar operations: launch-bound)."""
    dev = torch.device("cuda")

    def bits(t):
        view = {torch.float32: torch.int32, torch.float64: torch.int64,
                torch.int32: torch.int32}[t.dtype]
        return t.contiguous().view(view).cpu()

    cases = 0
    for ydt in (torch.float32, torch.float64):
        for x, best_y, ints, y in search_states():
            cpu = (torch.tensor(x, dtype=torch.float32),
                   torch.tensor(best_y, dtype=ydt),
                   torch.tensor(ints, dtype=torch.int32),
                   torch.tensor(y, dtype=ydt))
            card = tuple(t.to(dev) for t in cpu)
            got = search_kernels.linesearch_step(*card)
            for want in (search_kernels.linesearch_step_plain(*card),
                         search_kernels.linesearch_step_plain(*cpu)):
                if not all(torch.equal(bits(a), bits(b))
                           for a, b in zip(got, want)):
                    raise SystemExit(f"linesearch_step differs from its plain "
                                     f"version at {x}, {best_y}, {ints}, {y} "
                                     f"({ydt}): {[t.tolist() for t in got]} "
                                     f"against {[t.tolist() for t in want]}")
            cases += 1
    log(f"linesearch_step equals its plain version on the card and the "
        f"CPU's bit for bit in {cases} states (f32 and f64 values, the guard "
        f"to -0, NaN values)")
    state = (torch.tensor([0.0, 1.0, 1.0], device=dev),
             torch.tensor(0.0, device=dev),
             torch.tensor([0, 15], dtype=torch.int32, device=dev),
             torch.tensor(1.0, device=dev))
    return [timed_record(
        "linesearch_step", "linesearch_step",
        lambda: search_kernels.linesearch_step(*state),
        lambda: search_kernels.linesearch_step_plain(*state), None,
        28 + 24, 12, 0.0, smi)]


def hash_stack(n, d, dtype, seed, device="cuda"):
    """An (n, d) stack of `dtype` for the mixture hash: normal values
    with, at the first flat positions (wrapping round a small stack),
    +0, -0, +inf, -inf, then NaN payloads of both signs (quiet and
    signalling) and a subnormal."""
    gen = torch.Generator(device=device).manual_seed(seed)
    g = torch.randn((n, d), generator=gen, device=device).to(dtype)
    flat = g.view(-1)
    for k, value in enumerate((0.0, -0.0, math.inf, -math.inf)):
        flat[k % flat.numel()] = value
    # NaN words of each dtype (as signed ints): quiet +, quiet - with a
    # payload, signalling +, signalling + with a payload; then a subnormal
    words = {F32: (0x7FC00000, -0x003FFFFF, 0x7F800001, 0x7FA5A5A5, 1),
             BF16: (0x7FC0, -0x003F, 0x7F81, 0x7FA5, 1),
             F16: (0x7E00, -0x01FF, 0x7C01, 0x7D55, 1)}[dtype]
    bits = flat.view(torch.int32 if dtype == F32 else torch.int16)
    for k, word in enumerate(words):
        bits[(4 + k) % flat.numel()] = word
    return g


def mixture_kernels_check(smi):
    """Phase 3, the `--gars-per-call` draw: `operand_hash` against its
    plain version (the int64 emulation) on the card and on the CPU, bit
    for bit, on `hash_stack`s at the headline's [25, 1,310,922] in f32,
    bf16 and f16 and at WRN-28-10's f32[11, 36,489,290]; `mixture_draw`
    against its plain version and the CPU's for each hash and a few keys;
    the named inits on the card against the CPU's bits (orthogonal within
    atol 1e-6: another QR). Returns the records of `operand_hash` (f32 at
    the headline shape: one read of the operand, bound by its bytes; the
    library column is `operand_hash_int64`, one int64 multiply a word)
    and `mixture_draw` (one thread: launch-bound); logs the same times at
    the WRN shape and in bf16 and f16."""
    dev = torch.device("cuda")
    cum = torch.tensor(MIXTURE_CUM)
    records = []
    shapes = ((HEADLINE_N, HEADLINE_D, F32), (HEADLINE_N, HEADLINE_D, BF16),
              (HEADLINE_N, HEADLINE_D, F16), (WRN_N, WRN_D, F32))
    for n, d, dtype in shapes:
        g = hash_stack(n, d, dtype, seed=n + d)
        got = mixture_kernels.operand_hash(g)
        plain = mixture_kernels.operand_hash_plain(g)
        library = mixture_kernels.operand_hash_int64(g)
        if dtype == F32 and n == HEADLINE_N:
            cpu = mixture_kernels.operand_hash_plain(g.cpu())
        else:
            cpu = plain  # the CPU's plain version at this size: seconds
        if not int(got) == int(plain) == int(library) == int(cpu):
            raise SystemExit(f"operand_hash differs from its plain version at "
                             f"{dtype}[{n}, {d}]: {int(got)} against "
                             f"{int(plain)} (int64 {int(library)}, CPU "
                             f"{int(cpu)})")
        for seed in range(4):
            key = prng.fold_in(prng.PRNGKey(seed), n)
            drawn = mixture_kernels.mixture_draw(key.to(dev), got, cum.to(dev))
            want = mixture_kernels.mixture_draw_plain(key, got.cpu(), cum)
            if int(drawn) != int(want) or int(mixture_kernels.mixture_draw_plain(
                    key.to(dev), got, cum.to(dev))) != int(want):
                raise SystemExit(f"mixture_draw differs from its plain version "
                                 f"at {dtype}[{n}, {d}], key {seed}")
        label = f"operand_hash {DTYPE_NAMES[dtype]}[{n}, {d}]"
        log(f"{label}: {int(got)} on the card, in its plain version, in the "
            f"int64 form and on the CPU; mixture_draw equal for 4 keys")
        nbytes = g.numel() * g.element_size() + 8
        # The index's multiply and or, the word's product and the sum (and
        # a half's widening, a shift or a few selects, uncounted)
        rec = timed_record(
            "operand_hash", "operand_hash",
            lambda: mixture_kernels.operand_hash(g),
            lambda: mixture_kernels.operand_hash_plain(g),
            lambda: mixture_kernels.operand_hash_int64(g),
            nbytes, 4 * g.numel(), 0.0, smi, integer=True)
        if dtype == F32 and n == HEADLINE_N:
            records.append(rec)
        else:
            log(f"  ({label} is logged, not recorded)")
        del g, got, plain, library
        torch.cuda.empty_cache()
    key, h = prng.PRNGKey(0, device=dev), torch.tensor(12345, device=dev)
    records.append(timed_record(
        "mixture_draw", "mixture_draw",
        lambda: mixture_kernels.mixture_draw(key, h, cum.to(dev)),
        lambda: mixture_kernels.mixture_draw_plain(key, h, cum.to(dev)), None,
        16 + 8 + 4 * len(MIXTURE_CUM) + 4,
        2 * prng_kernels.hash_operations(1) + len(MIXTURE_CUM), 0.0, smi,
        integer=True))
    named_inits_on_card()
    return records


def named_inits_on_card():
    """Each named init on the card against the CPU's bits at an HWIO, a
    dense and a 1-D shape (orthogonal within atol 1e-6: the card's QR),
    and `apply_named_init` on empire-cnn under `fold_in(PRNGKey(1), 2)`
    (xavier_normal weights, uniform vectors) equal on both."""
    dev = torch.device("cuda")
    count = 0
    for name, init in sorted(core_mod.inits.items()):
        if name.endswith("_"):
            continue
        for seed, shape in enumerate(((3, 3, 16, 32), (64, 10), (7,))):
            try:
                cpu = init(prng.PRNGKey(seed), shape)
            except ValueError:  # eye, dirac, sparse and orthogonal's shapes
                continue
            card = init(prng.PRNGKey(seed, device=dev), shape).cpu()
            same = (torch.allclose(card, cpu, rtol=0, atol=1e-6)
                    if name == "orthogonal" else torch.equal(card, cpu))
            if not same:
                raise SystemExit(f"init {name} on the card differs from the "
                                 f"CPU's at {shape}")
            count += 1
    models = []
    for where in (dev, "cpu"):
        model = models_mod.build("empire-cnn", device=where)
        model.init(prng.PRNGKey(1, device=where))
        core_mod.apply_named_init(model, prng.fold_in(prng.PRNGKey(
            1, device=where), 2), init_multi="xavier_normal",
            init_mono="uniform")
        models.append(model)
    for (key, a), (_, b) in zip(models[0].state_dict().items(),
                                models[1].state_dict().items()):
        if not torch.equal(a.cpu(), b):
            raise SystemExit(f"apply_named_init on the card differs from the "
                             f"CPU's bits at {key}")
    log(f"named inits: {count} (init, shape) pairs and empire-cnn's "
        f"apply_named_init on the card equal the CPU's bits (orthogonal "
        f"within 1e-6)")


def nan_attack_operand(n, f, d, seed, extremes=False, device="cuda"):
    """f32[n, d] on `device` as the `nan` attack leaves a GAR's input:
    n - f standard normal rows, then f rows all NaN. `extremes` adds +inf
    and -inf entries to two honest rows and columns whose honest values
    are +-0 only (0), end in three +inf (1: a median and a top window of
    +inf), are all -inf (2) or mix +-inf (3)."""
    rng = np.random.default_rng(seed)
    g = rng.standard_normal((n, d)).astype(np.float32)
    g[n - f:] = np.nan
    if extremes:
        h = n - f
        g[0, rng.integers(4, d, 20)] = np.inf
        g[1, rng.integers(4, d, 20)] = -np.inf
        g[:h, 0] = np.where(rng.random(h) < 0.5, -0.0, 0.0)
        g[:3, 1] = np.inf
        g[:h, 2] = -np.inf
        g[:h, 3] = np.where(np.arange(h) % 2 == 0, np.inf, -np.inf)
    return torch.from_numpy(g).to(device)


def mnist_kernels(smi):
    """Phase 3 at the MNIST grid's shapes: kernels 1, 2, 3, 6, 7 and 8 on
    the `nan` attack's rows at n = 51 (f = 24 and 12, d = 79,510) and
    kernels 1, 3, 6 and 7 at n = 11 (f = 4, d = 431,080 and 69), against
    their plain versions; returns the timed `<kernel>_n51` records."""
    errs = collections.defaultdict(float)

    def check(name, label, got, want, atol=TOL_ATOL, rtol=TOL_RTOL):
        errs[name] = max(errs[name], compare(f"{name} {label}", got, want,
                                             atol, rtol))

    def same(label, got, want):
        if not torch.equal(got, want):
            raise SystemExit(f"{label} from sq_gram differs from the one "
                             f"from sq_gram_plain")

    operands = {}
    for n, f, d in ((51, 24, MNIST_D), (51, 12, MNIST_D), (11, 4, BASELINE_D),
                    (11, 4, PHISHING_D)):
        label = f"n={n} f={f} d={d}"
        h = n - f
        g = operands[f] = nan_attack_operand(n, f, d, seed=n + f)
        plain_gram = gar_kernels.sq_gram_plain(g)
        diag = torch.diagonal(plain_gram)
        check("sq_gram", label, gar_kernels.sq_gram(g), plain_gram,
              atol=TOL_RTOL * float(diag[torch.isfinite(diag)].max()))
        dist = _common.pairwise_distances(g)
        plain_dist = _common.distances_from_sq_gram(plain_gram)
        # Krum scores each row over its n - f - 1 nearest: the h finite
        # rows see each other, the f NaN rows lie at +inf
        w = krum.selection_weights(dist, f)
        same(f"Krum's w at {label}", w, krum.selection_weights(plain_dist, f))
        if bool((w[h:] > 0).any()) or int((w > 0).sum()) != n - f - 2:
            raise SystemExit(f"Krum at {label} selected {w.tolist()}")
        check("weighted_rows_mean", label, gar_kernels.weighted_rows_mean(w, g),
              gar_kernels.select_rows(w, g))
        if 4 * f + 3 <= n:
            W = bulyan.selection_weights(dist, f)
            same(f"Bulyan's W at {label}", W,
                 bulyan.selection_weights(plain_dist, f))
            rounds = W.shape[0]
            operands["W"], operands["m2"] = W, rounds - 2 * f
            for m2 in (1, rounds - 2 * f, rounds):
                out = gar_kernels.selected_median_mean(W, g, m2)
                check("selected_median_mean", f"{label} m2={m2}", out,
                      gar_kernels.selected_median_mean_plain(W, g, m2))
                if not bool(torch.isfinite(out).all()):
                    raise SystemExit(f"Bulyan at {label} took a NaN row")
        # Sorting kernels: exact (+-0 equal, NaN by position) for the
        # median and the trimmed mean
        x = nan_attack_operand(n, f, d, seed=n + f + 1, extremes=True)
        finite = torch.isfinite(x[:h]).all(dim=0)
        check("lower_median", label, sort_kernels.lower_median(x),
              sort_kernels.lower_median_plain(x), atol=0.0, rtol=0.0)
        trmean = sort_kernels.trimmed_mean(x, f)
        check("trimmed_mean", label, trmean,
              sort_kernels.trimmed_mean_plain(x, f), atol=0.0, rtol=0.0)
        # NaN sorts last: the window [f, n - f) holds finite ranks only
        top = torch.sort(x[:h, finite], dim=0).values[f:n - f].mean(dim=0)
        compare(f"trimmed_mean {label} against the finite ranks",
                trmean[finite], top)
        if not (bool(trmean[1].isposinf()) and bool(trmean[2].isneginf())):
            raise SystemExit(f"trimmed_mean at {label} lost an infinite window")
        if n == 51:
            for centre_name, c in (
                    ("median", sort_kernels.lower_median_plain(x)),
                    ("trmean", sort_kernels.trimmed_mean_plain(x, f))):
                out = sort_kernels.closest_mean(x, c, h)
                check("closest_mean", f"{label} m={h} about the {centre_name}",
                      out, sort_kernels.closest_mean_plain(x, c, h))
                # m = n - f takes every finite value and never a NaN key
                compare(f"closest_mean {label} m={h} against the finite mean",
                        out[finite], x[:h, finite].mean(dim=0))
    log("MNIST grid shapes: kernels agree with their plain versions: "
        + ", ".join(f"{name} max abs err {err:.3e}" for name, err in errs.items()))

    n, g, g12, W, m2 = 51, operands[24], operands[12], operands["W"], operands["m2"]
    d, rounds = MNIST_D, W.shape[0]
    w = krum.selection_weights(_common.pairwise_distances(g), 24)
    median = sort_kernels.lower_median_plain(g)
    # (kernel, call, plain, library call, bytes, f32 operations), as in
    # `kernels_vs_plain`
    work = [
        ("sq_gram", lambda: gar_kernels.sq_gram(g),
         lambda: gar_kernels.sq_gram_plain(g), lambda: torch.matmul(g, g.T),
         (n * d + n * n) * 4, 2 * (n * (n + 1) // 2) * d),
        ("selected_median_mean",
         lambda: gar_kernels.selected_median_mean(W, g12, m2),
         lambda: gar_kernels.selected_median_mean_plain(W, g12, m2), None,
         (n * d + rounds * n + d) * 4,
         (2 * rounds * n + sort_kernels.selection_operations(rounds)) * d),
        ("weighted_rows_mean", lambda: gar_kernels.weighted_rows_mean(w, g),
         lambda: gar_kernels.select_rows(w, g), lambda: torch.matmul(w, g),
         (n * d + n + d) * 4, 2 * n * d),
        ("lower_median", lambda: sort_kernels.lower_median(g),
         lambda: sort_kernels.lower_median_plain(g),
         lambda: torch.kthvalue(g, (n - 1) // 2 + 1, dim=0), (n * d + d) * 4,
         sort_kernels.selection_operations(n, (n - 1) // 2) * d),
        ("trimmed_mean", lambda: sort_kernels.trimmed_mean(g, 24),
         lambda: sort_kernels.trimmed_mean_plain(g, 24),
         lambda: torch.sort(g, dim=0), (n * d + d) * 4,
         (sort_kernels.selection_operations(n, range(24, n - 24)) + n - 48) * d),
        ("closest_mean", lambda: sort_kernels.closest_mean(g, median, n - 24),
         lambda: sort_kernels.closest_mean_plain(g, median, n - 24), None,
         (n * d + 2 * d) * 4,
         (sort_kernels.selection_operations(n, n - 24 - 1) + 2 * n) * d)]
    return [timed_record(f"{kernel}_n51", kernel, fn, plain, library, nbytes,
                         ops, errs[kernel], smi)
            for kernel, fn, plain, library, nbytes, ops in work]


# Kernel launches of one call of each rule's diagnose form (the outer
# aggregation of a `--gar-diagnostics` step): its aggregate's kernels,
# the Gram behind `dist` where the aggregate has none, and the colsort
# of the rank trim (`ops/diag.py::rank_kept_mask`)
DIAG_CALLS = {
    "average": (("sq_gram", 1),),
    "bulyan": (("sq_gram", 1), ("selected_median_mean", 1)),
    "krum": (("sq_gram", 1), ("weighted_rows_mean", 1)),
    "brute": (("sq_gram", 1), ("masked_rows_mean", 1)),
    "median": (("lower_median", 1), ("sq_gram", 1)),
    "trmean": (("trimmed_mean", 1), ("colsort", 1), ("sq_gram", 1)),
    "phocas": (("trimmed_mean", 1), ("closest_mean", 1), ("colsort", 1),
               ("sq_gram", 1)),
    "meamed": (("lower_median", 1), ("closest_mean", 1), ("colsort", 1),
               ("sq_gram", 1)),
    "aksel": (("lower_median", 1), ("sq_gram", 1)),
    "cge": (("sq_gram", 1),),
}
# The acceptation ratio's launches beside the outer call (Krum's and
# Brute's selections take a Gram, Aksel's a median)
INFLUENCE_CALLS = {"krum": (("sq_gram", 1),), "brute": (("sq_gram", 1),),
                   "aksel": (("lower_median", 1),)}


def diag_launches(gar, influence=True):
    """The exact f32 launches of a diagnose call of `gar` (with its
    acceptation ratio's: a `--gar-diagnostics` step)."""
    calls = collections.Counter()
    for kernel, count in (*DIAG_CALLS[gar],
                          *(INFLUENCE_CALLS.get(gar, ()) if influence else ())):
        calls[kernel, F32] += count
    return dict(calls)


@contextlib.contextmanager
def plain_kernels():
    """Every GAR caller's dispatch as for an operand outside the kernels'
    domain: on the card each takes its plain PyTorch version."""
    saved = gar_kernels.supported, sort_kernels.supported
    gar_kernels.supported = sort_kernels.supported = lambda g: False
    try:
        yield
    finally:
        gar_kernels.supported, sort_kernels.supported = saved


def launched():
    """The wrappers' launch counts by (kernel, dtype), non-zero only."""
    return {(kernel, dt): count for kernel, wrapper in WRAPPERS.items()
            for dt, count in wrapper.launches_by_dtype.items() if count}


def check_diag(label, got, want, exact_values=False):
    """A diagnose form's `(aggregate, aux)` against another run's: the
    selection and the trim fraction exactly, the aggregate within the
    kernels' tolerance (exactly with `exact_values`), the distances and
    scores within rtol 1e-5 and an absolute floor of 1e-5 of their largest
    finite magnitude (a Gram-read distance cancels at that scale),
    non-finite entries at the same places."""
    (agg, aux), (want_agg, want_aux) = got, want
    for key in ("selection", "trim_frac"):
        if not torch.equal(aux[key].cpu(), want_aux[key].cpu()):
            raise SystemExit(f"{label}: {key} differs: {aux[key].tolist()} "
                             f"against {want_aux[key].tolist()}")
    compare(f"{label} aggregate", agg, want_agg,
            *((0.0, 0.0) if exact_values else ()))
    for key in ("dist", "scores"):
        ref = want_aux[key].float()
        finite = ref[torch.isfinite(ref)].abs()
        scale = float(finite.max()) if finite.numel() else 0.0
        compare(f"{label} {key}", aux[key], ref,
                atol=max(TOL_ATOL, TOL_RTOL * scale))


def diag_operand(n, d, seed, device="cuda", nan_row=True):
    """f32[n, d]: normal rows, the second half of the columns rounded to
    half-integers (ties), the last row all NaN (with `nan_row`) and NaN
    entries in row 3, +inf entries in row 0 and -inf in row 1, a column
    of +-0."""
    rng = np.random.default_rng(seed)
    g = rng.standard_normal((n, d)).astype(np.float32)
    g[:, d // 2:] = np.round(g[:, d // 2:] * 2.0) / 2.0
    if nan_row:
        g[n - 1] = np.nan
    g[3, rng.integers(0, d, 50)] = np.nan
    g[0, rng.integers(0, d, 20)] = np.inf
    g[1, rng.integers(0, d, 20)] = -np.inf
    g[:, 7] = np.where(rng.random(n) < 0.5, -0.0, 0.0)
    return torch.from_numpy(g).to(device)


def diag_kernels(smi):
    """Phase 3, the GAR diagnostics (`--gar-diagnostics`): every diagnose
    form of the registry at the headline's f32[25, 1,310,922] (f = 5; a
    NaN row, NaN, +-inf, ties, a +-0 column: `diag_operand`) on the card,
    its aggregate bit for bit the plain form's (`unchecked`), held against
    the same form with the kernels' plain versions on the card
    (`plain_kernels`, which launches nothing), its launches by dtype
    exactly `DIAG_CALLS`; then each form on the card against the CPU at a
    small size (Bulyan at n = 11, f = 2, Brute, CGE and Average at n = 11,
    f = 4, the others at n = 25, f = 11, as phase 3's GAR check has them).
    Logs each form's time against its plain form's at the headline."""
    n, f, d = 25, 5, 1310922
    g = diag_operand(n, d, seed=16)
    if diag_launches("bulyan") != gar_launches("bulyan"):
        raise SystemExit("Bulyan's diagnose form launches other kernels "
                         "than its plain form")
    for name in sorted(DIAG_CALLS):
        gar = gars[name]
        _cuda.reset_launches()
        out = gar.diagnosed(g, f=f)
        torch.cuda.synchronize()
        got = launched()
        if got != diag_launches(name, influence=False):
            raise SystemExit(f"{name} diagnose: launches {got}, expected "
                             f"{diag_launches(name, influence=False)}")
        plain_agg = gar.unchecked(g, f=f)
        if not torch.equal(out[0].view(torch.int32), plain_agg.view(torch.int32)):
            raise SystemExit(f"{name} diagnose: the aggregate differs from "
                             f"the plain form's")
        _cuda.reset_launches()
        with plain_kernels():
            want = gar.diagnosed(g, f=f)
        torch.cuda.synchronize()
        if launched():
            raise SystemExit(f"{name}: the plain versions launched {launched()}")
        check_diag(f"{name} diagnose headline", out, want)
        ms = cuda_ms(lambda gar=gar: gar.diagnosed(g, f=f), reps=5, warmup=1)
        plain_ms = cuda_ms(lambda gar=gar: gar.unchecked(g, f=f), reps=5,
                           warmup=1)
        selected = int((out[1]["selection"] > 0).sum())
        log(f"{name} diagnose at f32[{n}, {d}] f={f}: launches "
            f"{ {k: c for (k, _), c in got.items()} }, aggregate bit for bit "
            f"the plain form's, aux held to the plain versions'; {selected} "
            f"workers selected, clip fraction "
            f"{float(out[1]['trim_frac'].mean()):.6f}; {ms:.4f} ms a call "
            f"against {plain_ms:.4f} ms without diagnostics on {smi}")
        del out, want, plain_agg
    del g
    torch.cuda.empty_cache()
    rng = np.random.default_rng(17)
    for rows, f_small, names in ((11, 2, ("bulyan",)),
                                 (11, 4, ("brute", "cge", "average")),
                                 (25, 11, ("krum", "median", "trmean", "phocas",
                                           "meamed", "aksel"))):
        # At n = 11 one non-finite row fewer, so that Bulyan's and Brute's
        # selections stay among finite rows
        small = diag_operand(rows, 5001 if rows == 11 else 20_001,
                             seed=int(rng.integers(1 << 30)), device="cpu",
                             nan_row=rows > 11)
        for name in names:
            check_diag(f"{name} diagnose cuda vs cpu (n={rows}, f={f_small})",
                       gars[name].diagnosed(small.cuda(), f=f_small),
                       gars[name].diagnosed(small, f=f_small))
    log("diagnose forms on the card agree with the CPU port at the small "
        "sizes")


def wrn_kernels(smi):
    """Phase 3 at WRN-28-10's shapes: `prng_kernels.bernoulli_masks`
    (keep 0.7) against its plain version on the card, bit for bit, at the
    12 masks of a step at (S, B) = (9, 20) and at (3, 2), and against the
    CPU's bits at (3, 2) and at one mask of each width at (9, 20); the
    model's draw through it (12 launches, no `dropout_masks`); kernels 1,
    2, 3 and 6 at f32[11, 36,489,290] (Bulyan's W at f = 2, Krum's w at
    f = 2) against their plain versions. Returns the timed records: the
    12 masks of a step (206.4 M elements, integer-issue bound) and
    `<kernel>_wrn`."""
    dev = torch.device("cuda")
    model = models_mod.build("wide_resnet-Wide_ResNet", device="meta", **WRN_ARGS)
    keep = 1.0 - WRN_ARGS["dropout_rate"]
    t0 = time.perf_counter()
    for S, B, cpu_masks in ((WRN_S, WRN_B, (0, 4, 8)), (3, 2, range(12))):
        wkeys = prng.split(prng.fold_in(prng.PRNGKey(S), B), S)
        for j, shape in enumerate(model.jax_mask_shapes(B)):
            got = prng_kernels.bernoulli_masks(wkeys.to(dev), j, shape, keep)
            if not torch.equal(got, prng_kernels.bernoulli_masks_plain(
                    wkeys.to(dev), j, shape, keep)):
                raise SystemExit(f"bernoulli_masks differs from its plain "
                                 f"version at S={S} B={B} mask {j}")
            if j in cpu_masks and not torch.equal(
                    got.cpu(), prng_kernels.bernoulli_masks_plain(
                        wkeys, j, shape, keep)):
                raise SystemExit(f"bernoulli_masks differs from the CPU's bits "
                                 f"at S={S} B={B} mask {j}")
        _cuda.reset_launches()
        card = model.draw_masks(wkeys.to(dev), B)
        if (prng_kernels.bernoulli_masks.launches,
                prng_kernels.dropout_masks.launches) != (12, 0):
            raise SystemExit("WRN's draw_masks did not launch the Bernoulli "
                             "kernel 12 times (and the 8-bit one never)")
        log(f"bernoulli_masks S={S} B={B}: the 12 masks of a WRN-28-10 step "
            f"equal the plain version (masks {list(cpu_masks)} the CPU's bits "
            f"too; keep share {float(card[0].float().mean()):.5f})")
        del card, got
    log(f"  the Bernoulli checks took {time.perf_counter() - t0:.1f} s")

    shapes = model.jax_mask_shapes(WRN_B)
    wkeys = prng.split(prng.PRNGKey(0, device=dev), WRN_S)
    elements = WRN_S * sum(math.prod(shape) for shape in shapes)

    def masks():
        return [prng_kernels.bernoulli_masks(wkeys, j, shape, keep)
                for j, shape in enumerate(shapes)]

    def masks_plain():
        return [prng_kernels.bernoulli_masks_plain(wkeys, j, shape, keep)
                for j, shape in enumerate(shapes)]

    records = [timed_record("bernoulli_masks", "bernoulli_masks", masks,
                            masks_plain, None, WRN_S * 16 + elements,
                            prng_kernels.hash_operations(elements), 0.0, smi,
                            integer=True)]
    log(f"  bernoulli_masks: the 12 masks of a WRN-28-10 step, {elements} "
        f"elements ({elements} bytes written), threshold "
        f"{prng_kernels.bernoulli_threshold(keep)} of 2^23: host time a step "
        f"{host_us(masks, calls=50):.2f} us")

    n, d, f = WRN_N, WRN_D, 2
    gen = torch.Generator(device=dev).manual_seed(12)
    g = torch.randn((n, d), generator=gen, device=dev)
    errs = {}
    plain_gram = gar_kernels.sq_gram_plain(g)
    errs["sq_gram"] = compare("sq_gram at WRN width", gar_kernels.sq_gram(g),
                              plain_gram,
                              atol=TOL_RTOL * float(torch.diagonal(plain_gram).max()))
    dist = _common.pairwise_distances(g)
    plain_dist = _common.distances_from_sq_gram(plain_gram)
    W, w = bulyan.selection_weights(dist, f), krum.selection_weights(dist, f)
    if not (torch.equal(W, bulyan.selection_weights(plain_dist, f))
            and torch.equal(w, krum.selection_weights(plain_dist, f))):
        raise SystemExit("Bulyan's W or Krum's w at WRN width differ from "
                         "those from sq_gram_plain")
    rounds = W.shape[0]
    m2 = rounds - 2 * f
    errs["selected_median_mean"] = compare(
        "selected_median_mean at WRN width",
        gar_kernels.selected_median_mean(W, g, m2),
        gar_kernels.selected_median_mean_plain(W, g, m2))
    errs["weighted_rows_mean"] = compare(
        "weighted_rows_mean at WRN width", gar_kernels.weighted_rows_mean(w, g),
        gar_kernels.select_rows(w, g))
    errs["lower_median"] = compare(
        "lower_median at WRN width", sort_kernels.lower_median(g),
        sort_kernels.lower_median_plain(g), atol=0.0, rtol=0.0)
    log(f"WRN width f32[{n}, {d}] ({g.numel() * 4 / 1e9:.2f} GB): kernels 1, "
        f"2, 3 and 6 agree with their plain versions (Bulyan {rounds} rounds, "
        f"m2 {m2}): " + ", ".join(f"{name} max abs err {err:.3e}"
                                  for name, err in errs.items()))
    del plain_gram, dist, plain_dist
    work = [
        ("sq_gram", lambda: gar_kernels.sq_gram(g),
         lambda: gar_kernels.sq_gram_plain(g), lambda: torch.matmul(g, g.T),
         (n * d + n * n) * 4, 2 * (n * (n + 1) // 2) * d),
        ("selected_median_mean",
         lambda: gar_kernels.selected_median_mean(W, g, m2),
         lambda: gar_kernels.selected_median_mean_plain(W, g, m2), None,
         (n * d + rounds * n + d) * 4,
         (2 * rounds * n + sort_kernels.selection_operations(rounds)) * d),
        ("weighted_rows_mean", lambda: gar_kernels.weighted_rows_mean(w, g),
         lambda: gar_kernels.select_rows(w, g), lambda: torch.matmul(w, g),
         (n * d + n + d) * 4, 2 * n * d),
        ("lower_median", lambda: sort_kernels.lower_median(g),
         lambda: sort_kernels.lower_median_plain(g),
         lambda: torch.kthvalue(g, (n - 1) // 2 + 1, dim=0), (n * d + d) * 4,
         sort_kernels.selection_operations(n, (n - 1) // 2) * d)]
    records += [timed_record(f"{kernel}_wrn", kernel, fn, plain, library,
                             nbytes, ops, errs[kernel], smi)
                for kernel, fn, plain, library, nbytes, ops in work]
    del g, work
    torch.cuda.empty_cache()
    return records


def zoo_kernels(smi):
    """Phase 3 at the zoo cells' shapes (`ZOO_CELLS`): the mask kernels
    through the models' draws, VGG16's two 8-bit classifier masks (keys 0
    and 1 of each worker's split) at (S, B) = (9, 50) and MobileNetV2's
    Bernoulli mask from the worker keys themselves at (14, 50) and (3, 2):
    the launches each draw makes, and bit for bit the CPU's; then each
    GAR kernel a zoo cell launches at its cell's operand, f32[n, d] (d the
    model's), against its plain version at `kernels_vs_plain`'s
    tolerances: `sq_gram` and `selected_median_mean` at resnet18's
    [25, 11,181,642] (Bulyan's W at f = 5), `sq_gram` and
    `weighted_rows_mean` at resnet50's [25, 23,528,522] (Krum's w at
    f = 11), `lower_median` at vgg16's [11, 134,301,514] (5.9 GB),
    `trimmed_mean` at densenet121's [25, 6,964,106] (f = 11),
    `lower_median` and `closest_mean` at mobilenet_v2's [25, 2,236,682]
    (m = 14 about the median), `lower_median` at the transformer's
    [11, 104,394]. Returns the timed records `<kernel>_<family>`."""
    dev = torch.device("cuda")
    records = []
    mask_wrappers = {"dropout_masks": prng_kernels.dropout_masks,
                     "bernoulli_masks": prng_kernels.bernoulli_masks}
    for family, S, B in (("vgg16", 9, 50), ("mobilenet_v2", 14, 50),
                         ("mobilenet_v2", 3, 2)):
        model = models_mod.build(ZOO[family][0], device="meta")
        wkeys = prng.split(prng.fold_in(prng.PRNGKey(S), B), S)
        _cuda.reset_launches()
        card = model.draw_masks(wkeys.to(dev), B)
        launched = {kernel: wrapper.launches
                    for kernel, wrapper in mask_wrappers.items()}
        want = {**dict.fromkeys(mask_wrappers, 0),
                **{kernel: count for (kernel, _), count
                   in ZOO_MASKS[family].items()}}
        if launched != want:
            raise SystemExit(f"{family}'s draw_masks launched {launched}, "
                             f"expected {want}")
        for j, (got, cpu) in enumerate(zip(card, model.draw_masks(wkeys, B))):
            if not torch.equal(got.cpu(), cpu):
                raise SystemExit(f"{family}'s mask {j} at S={S} B={B} "
                                 f"differs from the CPU's bits")
        log(f"{family}'s draw_masks S={S} B={B}: {launched} launches, "
            f"{[list(m.shape) for m in card]} equal to the CPU's bits (keep "
            f"share {float(card[0].float().mean()):.5f})")
        if B > 2:
            elements = sum(m.numel() for m in card)
            kernel = next(k for k, count in want.items() if count)
            records.append(timed_record(
                f"{kernel}_{family}", kernel,
                lambda model=model, wkeys=wkeys.to(dev), B=B:
                    model.draw_masks(wkeys, B),
                lambda model=model, wkeys=wkeys.to(dev), B=B: [
                    (prng_kernels.dropout_masks_plain(wkeys, j, (B, 4096), 128)
                     if family == "vgg16" else
                     prng_kernels.bernoulli_masks_plain(wkeys, None, (B, 1280),
                                                        0.8))
                    for j in range(len(card))],
                None, S * 16 + elements, prng_kernels.hash_operations(elements),
                0.0, smi, integer=True))
        del card

    gen = torch.Generator(device=dev).manual_seed(15)
    for family, n, f, kernels in (
            ("resnet18", 25, 5, ("sq_gram", "selected_median_mean")),
            ("resnet50", 25, 11, ("sq_gram", "weighted_rows_mean")),
            ("vgg16", 11, 2, ("lower_median",)),
            ("densenet121", 25, 11, ("trimmed_mean",)),
            ("mobilenet_v2", 25, 11, ("lower_median", "closest_mean")),
            ("transformer", 11, 4, ("lower_median",))):
        d = ZOO[family][1]
        g = torch.randn((n, d), generator=gen, device=dev)
        plain_gram = gar_kernels.sq_gram_plain(g)
        dist = _common.distances_from_sq_gram(plain_gram)
        W = bulyan.selection_weights(dist, f) if n >= 4 * f + 3 else None
        w = krum.selection_weights(dist, f)
        rounds = W.shape[0] if W is not None else 0
        m2 = rounds - 2 * f
        median = sort_kernels.lower_median_plain(g)
        work = {
            "sq_gram": (lambda: gar_kernels.sq_gram(g),
                        lambda: gar_kernels.sq_gram_plain(g),
                        lambda: torch.matmul(g, g.T),
                        (n * d + n * n) * 4, 2 * (n * (n + 1) // 2) * d,
                        TOL_RTOL * float(torch.diagonal(plain_gram).max()), TOL_RTOL),
            "selected_median_mean": (
                lambda: gar_kernels.selected_median_mean(W, g, m2),
                lambda: gar_kernels.selected_median_mean_plain(W, g, m2), None,
                (n * d + rounds * n + d) * 4,
                (2 * rounds * n + sort_kernels.selection_operations(rounds)) * d,
                TOL_ATOL, TOL_RTOL),
            "weighted_rows_mean": (
                lambda: gar_kernels.weighted_rows_mean(w, g),
                lambda: gar_kernels.select_rows(w, g),
                lambda: torch.matmul(w, g), (n * d + n + d) * 4, 2 * n * d,
                TOL_ATOL, TOL_RTOL),
            "lower_median": (
                lambda: sort_kernels.lower_median(g),
                lambda: sort_kernels.lower_median_plain(g),
                lambda: torch.kthvalue(g, (n - 1) // 2 + 1, dim=0),
                (n * d + d) * 4,
                sort_kernels.selection_operations(n, (n - 1) // 2) * d, 0.0, 0.0),
            "trimmed_mean": (
                lambda: sort_kernels.trimmed_mean(g, f),
                lambda: sort_kernels.trimmed_mean_plain(g, f),
                lambda: torch.sort(g, dim=0), (n * d + d) * 4,
                (sort_kernels.selection_operations(n, range(f, n - f))
                 + n - 2 * f) * d, 0.0, 0.0),
            "closest_mean": (
                lambda: sort_kernels.closest_mean(g, median, n - f),
                lambda: sort_kernels.closest_mean_plain(g, median, n - f), None,
                (n * d + 2 * d) * 4,
                (sort_kernels.selection_operations(n, n - f - 1) + 2 * n) * d,
                TOL_ATOL, TOL_RTOL)}
        del plain_gram, dist
        errs = []
        for kernel in kernels:
            fn, plain, library, nbytes, ops, atol, rtol = work[kernel]
            err = compare(f"{kernel} at {family}'s f32[{n}, {d}]", fn(),
                          plain(), atol=atol, rtol=rtol)
            errs.append(f"{kernel} max abs err {err:.3e}")
            records.append(timed_record(f"{kernel}_{family}", kernel, fn,
                                        plain, library, nbytes, ops, err, smi))
        log(f"{family}'s operand f32[{n}, {d}] ({g.numel() * 4 / 1e9:.2f} "
            f"GB, f = {f}): " + ", ".join(errs))
        del g, work, W, w, median
        torch.cuda.empty_cache()
    return records


# Phase 3's card-against-CPU gradients: (family, whether the CPU draws
# the init too); the resnets' 11-24 M and vgg16's 134 M normal draws
# take from 12 s to minutes in the eager int64 threefry on a host CPU, so
# those take the card's weights (densenet121 holds the same convolution
# init to the CPU's bits)
ZOO_GRADIENTS = (("resnet18", False), ("resnet50", False), ("vgg16", False),
                 ("densenet121", True), ("mobilenet_v2", True),
                 ("transformer", True))
# The card's f32 forward, gradient and BatchNorm state are held against
# the CPU's float64 ones on the same weights: no farther from them than
# ZOO_SLACK times the CPU's own f32 run, or ZOO_FLOOR (relative L2 for
# the gradient, relative to the largest output for the outputs, absolute
# for the state). cuDNN and the CPU sum in other orders, and at batch 4
# the last stage's BatchNorm normalizes 4 values a channel (1x1 pixels),
# which magnifies those last bits by as much as the values' spread is
# small: resnet50's f32 gradient on a CPU lies 8e-2 (relative L2) from
# its float64 one, and the card's f32 one as far from the CPU's f32, so
# a fixed f32 tolerance either fails the well-made run or passes a
# broken one. cuDNN's algorithms may round more than the CPU's: on an
# H100 mobilenet_v2's f32 outputs lay 2.2 times as far from float64 as
# the CPU's (4.2e-4 against 1.9e-4), every other family's within 1.3
# times; a wrong kernel lands orders of magnitude farther
ZOO_SLACK, ZOO_FLOOR = 4.0, 1e-5


def card_vs_cpu_gradient(name, seed=1, batch=4, cpu_init=True, device="cuda"):
    """One worker's train-mode forward and gradient of `sum(out * R)` of
    the model `name` at full width on the card (f32) and on the CPU (f32
    and float64), on the same weights (the card's `init(PRNGKey(seed))`;
    with `cpu_init` the CPU draws them too, and they must be the card's
    bits), inputs, dropout masks (the card's kernels against the CPU's
    draw, bit for bit) and R. Returns `{"outputs", "gradient", "state":
    (the card's error, the CPU f32 run's error)}` against float64, raising
    where the card's passes `ZOO_SLACK` times the CPU's or `ZOO_FLOOR`."""
    dev = torch.device(device)
    card = models_mod.build(name, device=dev)
    cpu = models_mod.build(name, device="cpu")
    card.init(prng.PRNGKey(seed, device=dev))
    if cpu_init:
        cpu.init(prng.PRNGKey(seed))
        for key, value in card.state_dict().items():
            if not torch.equal(value.cpu(), cpu.state_dict()[key]):
                raise SystemExit(f"{name}: the card's init of {key} differs "
                                 f"from the CPU's bits")
    else:
        cpu.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    wide = models_mod.build(name, device="cpu", dtype=torch.float64)
    wide.load_state_dict(cpu.state_dict())
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn((batch, *card.input_shape), generator=gen)
    R = torch.randn((batch, 10), generator=gen)
    wkeys = prng.split(prng.PRNGKey(seed + 1), 1)
    runs = []
    for model, where in ((card, dev), (cpu, torch.device("cpu")),
                         (wide, torch.device("cpu"))):
        dtype = next(model.parameters()).dtype
        masks = tuple(m[0] for m in model.draw_masks(wkeys.to(where), batch))
        flat = models_mod.FlatParams(model)
        theta = flat.flatten(dict(model.named_parameters())).detach()
        theta.requires_grad_()
        buffers = dict(model.named_buffers())
        out, state = torch.func.functional_call(
            model, {**flat.unflatten(theta), **buffers},
            (x.to(where, dtype),), {"train": True, "masks": masks})
        (out * R.to(where, dtype)).sum().backward()
        runs.append((out.detach().cpu().double(), theta.grad.cpu().double(),
                     {f"{k}.{s}": v.detach().cpu().double()
                      for k, stats in state.items() for s, v in stats.items()},
                     [m.cpu() for m in masks]))
    (out64, grad64, state64, masks64) = runs[2]
    errors = {"outputs": [], "gradient": [], "state": []}
    for out, grad, state, masks in runs[:2]:
        if not all(torch.equal(a, b) for a, b in zip(masks, masks64)):
            raise SystemExit(f"{name}: the card's masks differ from the CPU's")
        errors["outputs"].append(float((out - out64).abs().max()
                                       / out64.abs().max()))
        errors["gradient"].append(float((grad - grad64).norm() / grad64.norm()))
        errors["state"].append(max((float((state[k] - v).abs().max())
                                    for k, v in state64.items()), default=0.0))
    bad = [kind for kind, (card_err, cpu_err) in errors.items()
           if card_err > max(ZOO_SLACK * cpu_err, ZOO_FLOOR)]
    if bad:
        raise SystemExit(f"{name}: the card's {', '.join(bad)} lie farther "
                         f"from float64 than {ZOO_SLACK}x the CPU's f32 run "
                         f"(card, CPU f32: {errors})")
    return errors


def zoo_gradients(smi):
    """Phase 3: each zoo family's card gradient at full width against the
    CPU's (`card_vs_cpu_gradient`, batch 4, `ZOO_GRADIENTS`)."""
    for family, cpu_init in ZOO_GRADIENTS:
        t0 = time.perf_counter()
        errors = card_vs_cpu_gradient(ZOO[family][0], cpu_init=cpu_init)
        log(f"{family} (d = {ZOO[family][1]}), batch 4, train mode, against "
            f"the CPU's float64 (the card's f32 / the CPU's f32): " + ", ".join(
                f"{kind} {card:.3e} / {cpu:.3e}"
                for kind, (card, cpu) in errors.items())
            + "; init " + ("the CPU's bits" if cpu_init else "the card's, copied")
            + f" ({time.perf_counter() - t0:.1f} s) on {smi}")
        torch.cuda.empty_cache()


def device_paths(smi):
    """Phase 3, the device-resident path: `DeviceData.gather` on the card
    against the same gather on the CPU, bit for bit; the grouped honest
    phase against the vmapped one on the card at the headline shape."""
    dev = torch.device("cuda")
    # CIFAR-10 with and without its transform; MNIST normalized without
    # flips, FashionMNIST flipped without normalization, the raw phishing
    # rows
    for name, no_transform in (("cifar10", False), ("cifar10", True),
                               ("mnist", False), ("fashionmnist", False),
                               ("phishing", False)):
        splits = data_mod.make_datasets(name, 50, 100,
                                        no_transform=no_transform, seed=1)
        for split, count in zip(splits, (25, 5)):
            cpu, card = DeviceData(split, "cpu"), DeviceData(split, dev)
            idx, flips = cpu.sample_indices(count)
            (x, y), (cx, cy) = (card.gather(*card.upload(idx, flips)),
                                cpu.gather(*cpu.upload(idx, flips)))
            if not (x.dtype == cx.dtype == torch.float32 and torch.equal(
                    x.cpu().view(torch.int32), cx.view(torch.int32))
                    and torch.equal(y.cpu(), cy)):
                raise SystemExit(f"DeviceData.gather on the card differs from "
                                 f"the CPU's ({name}, no_transform="
                                 f"{no_transform}, {list(x.shape)})")
    log("DeviceData.gather on the card equals the CPU's bit for bit (train "
        "and test splits of CIFAR-10 with and without the transform, MNIST, "
        "FashionMNIST and phishing)")

    # The attacks' jitter: the noise key (a hash of the honest rows'
    # bits) and `prng.normal` at the headline shape, card against CPU
    honest = torch.randn((20, 1310922), generator=torch.Generator().manual_seed(5))
    key = alie.row_key(honest)
    if not torch.equal(alie.row_key(honest.to(dev)).cpu(), key):
        raise SystemExit("alie.row_key on the card differs from the CPU's")
    noise = prng.normal(key.to(dev), (5, 1310922))
    if not torch.equal(noise.cpu().view(torch.int32),
                       prng.normal(key, (5, 1310922)).view(torch.int32)):
        raise SystemExit("prng.normal on the card differs from the CPU's bits")
    log(f"prng.normal f32[5, 1310922] on the card equals the CPU's bit for "
        f"bit (key {key.tolist()} from alie.row_key of f32[20, 1310922], "
        f"equal on both)")

    grouped_vs_vmapped(cifar_cell("headline", "bulyan", 5, EMPIRE, 1), smi)


def grouped_vs_vmapped(cell, smi, worker_momentum=False, timed=False):
    """The grouped honest phase against the vmapped one on the card for a
    cell's first step (same weights, batches and dropout masks): every
    gradient row within 1e-2 relative L2 (a near tie: a max-pool window or
    a ReLU input within rounding of 0), the losses within rtol 1e-4 and
    the BatchNorm state within rtol 1e-4, atol 1e-5; logs how many rows
    agree elementwise (rtol 1e-4, atol 1e-5). `worker_momentum` gives the
    workers random momentum buffers, so that their Nesterov lookaheads
    (the weights of the `groups=S` convolutions) differ; `timed` logs the
    device time of each phase (median of 3 CUDA-event times)."""
    engines = []
    with tempfile.TemporaryDirectory() as tmp:
        for flags in ((), VMAPPED_RUN):
            args = driver._postprocess(driver.process_commandline(
                cell_argv(cell._replace(argv=cell.argv + flags), 1, tmp)))
            engines.append(driver._setup(args)[1:])
    (grouped, state), (vmapped, _) = engines
    if worker_momentum:
        gen = torch.Generator(device=state.theta.device).manual_seed(3)
        state = dataclasses.replace(state, momentum_workers=1e-2 * torch.randn(
            state.momentum_workers.shape, generator=gen,
            device=state.theta.device))
    S = grouped.cfg.nb_sampled
    data = grouped.train_data
    xs, ys = data.gather(*data.upload(*grouped.sample_indices()))
    masks = grouped.draw_masks(grouped.step_keys(state.rng)[2], xs.shape[1])
    lr = args.initial_lr(0)

    def phase(engine):
        return engine.phase_honest(state, xs, ys, lr, masks)

    (G, loss, net, *_), (V, vloss, vnet, *_) = (
        phase(engine) for engine in (grouped, vmapped))
    if (grouped.counts["grouped_phases"], vmapped.counts["vmapped_phases"]) != (1, 1):
        raise SystemExit("the grouped and vmapped engines took another honest phase")
    rel = (torch.linalg.vector_norm(G - V, dim=1)
           / torch.linalg.vector_norm(V, dim=1))
    exact = torch.isclose(G, V, rtol=1e-4, atol=1e-5).all(dim=1)
    if not bool((rel < 1e-2).all()):
        raise SystemExit(f"{cell.name}: grouped honest rows off the vmapped "
                         f"ones: {rel.tolist()}")
    compare("grouped honest loss", loss, vloss, atol=0.0, rtol=1e-4)
    for name in vnet:
        compare(f"grouped BatchNorm state {name}", net[name], vnet[name],
                atol=1e-5, rtol=1e-4)
    log(f"{cell.name}: grouped honest phase against the vmapped one at "
        f"f32{list(xs.shape)}, {S} workers "
        f"({'per-worker' if worker_momentum else 'shared'} weights): "
        f"{int(exact.sum())} of {S} rows within rtol 1e-4, atol 1e-5, the "
        f"largest row distance {float(rel.max()):.3e} relative L2 on {smi}")
    if timed:
        del G, V, net, vnet
        times = [cuda_ms(lambda engine=engine: phase(engine), reps=3, warmup=1)
                 for engine in (grouped, vmapped)]
        log(f"  {cell.name}: honest phase on the device clock, grouped "
            f"{times[0]:.3f} ms, vmapped {times[1]:.3f} ms (median of 3) on "
            f"{smi}")


# A phase-4 run: its driver flags but the common ones (`cell_argv`), its
# steps, the family of records its launches count for ("cifar", or
# "n<n>" for the MNIST half's runs at n workers) and the exact launches a
# step of each (kernel, dtype)
Cell = collections.namedtuple("Cell", "name argv steps family per_step")
EMPIRE = ("empire", ("factor:1.1",))
LITTLE = ("little", ("factor:1.5", "negative:true"))
# The JAX default factor -16: a line search of 16 defense calls a step
EMPIRE_ADAPTIVE = ("empire", ())
LITTLE_ADAPTIVE = ("little", ("factor:-16", "negative:true"))
STRICT_ADAPTIVE = ("empire-strict", ("epsilon:-16",))
ANTICGE = ("anticge", ())
PROBES = 16  # line-search evaluations a step at factor (epsilon) -16
# The search's state update after each probe but the first, on the
# device: `linesearch_step` counts under the objective's f32
SEARCH_STEP = {("linesearch_step", F32): PROBES - 1}
BF16_RUN = ("--dtype", "bfloat16")
F16_RUN = ("--dtype", "float16")
MIXED_RUN = ("--dtype", "float32", "--compute-dtype", "bfloat16")
VMAPPED_RUN = ("--no-grouped-workers",)
# `reproduce.py::submit_cifar`'s flags beyond the headline's
GRID_RUN = ("--model-args", "cifar100:False", "--loss", "nll",
            "--learning-rate-decay", "167", "--learning-rate-decay-delta",
            "1500", "--l2-regularize", "1e-2", "--nb-for-study-past", "25",
            "--evaluation-delta", "100")
# Kernel launches of one outer call of each GAR and of its acceptation
# ratio (Krum and Brute take a second Gram for it; Aksel a second median)
GAR_CALLS = {"average": (), "cge": (),
             "krum": (("sq_gram", 2), ("weighted_rows_mean", 1)),
             "bulyan": (("sq_gram", 1), ("selected_median_mean", 1)),
             "brute": (("sq_gram", 2), ("masked_rows_mean", 1)),
             "median": (("lower_median", 1),),
             "trmean": (("trimmed_mean", 1),),
             "phocas": (("trimmed_mean", 1), ("closest_mean", 1)),
             "meamed": (("lower_median", 1), ("closest_mean", 1)),
             "aksel": (("lower_median", 2),)}
# The key tree's launches a step: the step key's split, and on empire-cnn
# the three dropout masks (WRN-28-10's: `wrn_cell`)
SPLIT_STEP = {("split_keys", I64): 1}
MASKS_STEP = {("dropout_masks", BOOL): 3}
# The `--gars` mixture cells: Bulyan, Krum and Median at 2:1:1
MIXTURE = "bulyan,2;krum,1;median,1"
MIXTURE_MEMBERS = ("bulyan", "krum", "median")
MIXTURE_CUM = (2.0, 3.0, 4.0)
MIXTURE_RUN = ("--gars", MIXTURE)
# Per call: each of the 16 probes and the outer aggregation runs every
# member (Krum's acceptation ratio takes one more Gram), and each of them
# and the influence hashes its operand and draws
PER_CALL_STEP = {("sq_gram", F32): 2 * (PROBES + 1) + 1,
                 ("selected_median_mean", F32): PROBES + 1,
                 ("weighted_rows_mean", F32): PROBES + 1,
                 ("lower_median", F32): PROBES + 1,
                 ("operand_hash", F32): PROBES + 2,
                 ("mixture_draw", I64): PROBES + 2, **SEARCH_STEP}


def mixture_draws(steps, seed=1, S=HEADLINE_S):
    """The members a per-step `MIXTURE` draws in the first `steps` steps
    of a run from `--seed seed` with S sampled workers, worked out here
    from the JAX key tree on the CPU (the engine's host mirror computes
    the same on Python ints): the step key `fold_in(PRNGKey(seed), 1)`,
    split into S + 2 each step, key 0 the next step's, key 1's uniform
    through the inverse CDF."""
    rng = prng.fold_in(prng.PRNGKey(seed), 1)
    cum = np.asarray(MIXTURE_CUM, np.float32)
    members = []
    for _ in range(steps):
        keys = prng.split(rng, S + 2)
        rng = keys[0]
        u = np.float32(prng.uniform(keys[1], ()).item())
        members.append(min(int(np.searchsorted(cum, u * cum[-1],
                                               side="right")),
                           len(cum) - 1))
    return members


def mixture_launches(steps):
    """A per-step `MIXTURE` run's exact launches in `steps` steps: the
    drawn member's each step (`mixture_draws`), and the key tree's."""
    totals = collections.Counter()
    for member in mixture_draws(steps):
        totals.update(gar_launches(MIXTURE_MEMBERS[member]))
    return dict(totals)


def gar_launches(gar, dtype=F32):
    """The exact launches a step of `gar`'s kernels in `dtype` (the
    sorting kernels run in the GAR stack's dtype, the others in f32)."""
    return {(kernel, dtype if kernel in sort_kernels.KERNELS else F32): count
            for kernel, count in GAR_CALLS[gar]}


def cifar_cell(name, gar, f, attack, steps=STEPS, flags=(), dtype=F32,
               per_step=None):
    """A run on CIFAR-10, empire-cnn, n=25, f real Byzantine workers,
    batch 50, momentum 0.99 at update, clip 5, nb-for-study 1 (its own
    flags last, so they override these); an attack with no arguments
    takes the JAX defaults (no `--attack-args`). `per_step` is the exact
    GAR launches a step (`gar_launches(gar, dtype)` when None), or a
    function of the step count giving a run's totals where they vary by
    step (a per-step mixture); the key tree's are added."""
    attack, attack_args = attack
    per_step = gar_launches(gar, dtype) if per_step is None else per_step
    argv = ("--dataset", "cifar10", "--model", "empire-cnn",
            "--nb-workers", "25", "--nb-decl-byz", str(f),
            "--nb-real-byz", str(f), "--gar", gar, "--attack", attack,
            *(("--attack-args", *attack_args) if attack_args else ()),
            "--batch-size", "50",
            "--batch-size-test", "100", "--batch-size-test-reps", "5",
            "--evaluation-delta", str(steps), "--momentum", "0.99",
            "--momentum-at", "update", "--gradient-clip", "5",
            "--learning-rate", "0.01", "--nb-for-study", "1",
            "--nb-for-study-past", "1", *flags)
    if callable(per_step):
        totals = per_step

        def per_step(steps):
            return {**totals(steps), **{key: count * steps for key, count
                                        in {**SPLIT_STEP, **MASKS_STEP}.items()}}
    else:
        per_step = {**per_step, **SPLIT_STEP, **MASKS_STEP}
    return Cell(name, argv, steps, "cifar", per_step)


# `reproduce.py::submit_mnist`: its common flags in its order, and the
# arguments of its attacks (with `nan`, which takes none)
MNIST_GRID = ("--batch-size", "83", "--model", "simples-full", "--loss", "nll",
              "--learning-rate-decay-delta", "300", "--momentum", "0.9",
              "--l2-regularize", "0.0001", "--evaluation-delta", "5",
              "--gradient-clip", "2", "--nb-steps", "300", "--nb-for-study",
              "1", "--nb-for-study-past", "150")
GRID_ATTACKS = {"little": ("factor:1.5", "negative:True"),
                "empire": ("factor:1.1",), "nan": ()}
MNIST_STEPS = 50


def grid_argv(name):
    """The flags of the run `name` of `reproduce.py::submit_mnist`, as it
    writes them (`--nb-steps 300` included; `cell_argv` overrides it);
    `<dataset>-nan-<gar>-...` is the same run against `nan`."""
    match = re.fullmatch(r"(\w+)-average-n_(\d+)-lr_([\d.]+)(-nesterov)?", name)
    if match:
        dataset, n, lr, nesterov = match.groups()
        return (*MNIST_GRID, "--nb-workers", n, "--dataset", dataset,
                "--learning-rate", lr, *(("--momentum-nesterov",) * bool(nesterov)))
    dataset, attack, gar, f, lr, at, nesterov = re.fullmatch(
        r"(\w+)-(\w+)-(\w+)-f_(\d+)-lr_([\d.]+)-at_(update|worker)(-nesterov)?",
        name).groups()
    args = GRID_ATTACKS[attack]
    return (*MNIST_GRID, "--nb-workers", "51", "--dataset", dataset,
            "--learning-rate", lr, "--nb-decl-byz", f, "--nb-real-byz", f,
            "--gar", gar, "--attack", attack,
            *(("--attack-args", *args) if args else ()), "--momentum-at", at,
            *(("--momentum-nesterov",) * bool(nesterov)))


# `reproduce-appendix.py::submit`: its common flags in its order (WRN-28-10
# at full width), and the arguments of its attacks
APPENDIX = ("--batch-size", "20", "--model", "wide_resnet-Wide_ResNet",
            "--model-args", "depth:28", "widen_factor:10", "dropout_rate:0.3",
            "num_classes:10", "--learning-rate-schedule",
            "0.02,8000,0.004,16000,0.0008", "--gradient-clip", "5", "--loss",
            "crossentropy", "--momentum", "0.99", "--momentum-nesterov",
            "--l2-regularize", "0.0005", "--evaluation-delta", "100",
            "--nb-steps", "20000", "--nb-for-study", "1", "--nb-for-study-past",
            "1", "--nb-workers", "11")
APPENDIX_ATTACKS = {"little": ("factor:1.5", "negative:True"),
                    "empire": ("factor:1.1",)}


APPENDIX_BULYAN = "cifar10-empire-bulyan-f_2-lr_pow-at_update-nesterov"


def appendix_argv(name):
    """The flags of the run `name` of `reproduce-appendix.py::submit`, as
    it writes them (`--nb-steps 20000` included; `cell_argv` overrides
    it)."""
    dataset, attack, gar, f, at = re.fullmatch(
        r"(\w+)-(\w+)-(\w+)-f_(\d+)-lr_pow-at_(update|worker)-nesterov",
        name).groups()
    return (*APPENDIX, "--dataset", dataset, "--nb-decl-byz", f,
            "--nb-real-byz", f, "--gar", gar, "--attack", attack,
            "--attack-args", *APPENDIX_ATTACKS[attack], "--momentum-at", at)


def wrn_cell(name, line, gar, flags=(), local_steps=1):
    """A WRN-28-10 run (family "wrn", `STEPS` steps): the appendix line
    `line` with `flags` after it; a step launches its GAR's kernels and,
    at `local_steps` k, k + 1 key splits (the step key's, and the workers'
    keys into k when k > 1) and 12 k Bernoulli masks."""
    per_step = {**gar_launches(gar),
                ("split_keys", I64): 1 + (local_steps > 1),
                ("bernoulli_masks", BOOL): 12 * local_steps}
    return Cell(name, (*appendix_argv(line), *flags), STEPS, "wrn", per_step)


def mnist_cell(name, argv, gar, steps=MNIST_STEPS):
    """A run of the MNIST half, in the family of its worker count (the
    driver's default 11 where `argv` sets none); the simple models draw
    no dropout mask, so a step launches its GAR's kernels and the split."""
    argv = tuple(argv)
    n = argv[argv.index("--nb-workers") + 1] if "--nb-workers" in argv else "11"
    return Cell(name, argv, steps, f"n{n}", {**gar_launches(gar), **SPLIT_STEP})


def grid_cell(name):
    gar = name.split("-")[2] if "-average-" not in name else "average"
    return mnist_cell(name, grid_argv(name), gar)


def baseline_cell(gar):
    """`BASELINE.md` configs 2-3: the driver's defaults (MNIST,
    simples-conv, n = 11) with f = 4 real Byzantine workers against
    `empire factor:1.1`."""
    return mnist_cell(f"baseline_mnist_{gar}", (
        "--nb-decl-byz", "4", "--nb-real-byz", "4", "--gar", gar,
        "--attack", "empire", "--attack-args", "factor:1.1"), gar)


def attack_cell(name, attack, attack_args, gar="krum"):
    """`baseline_cell`'s flags (MNIST, simples-conv, n = 11, f = 4 real)
    against another attack (none calls the defense)."""
    return mnist_cell(name, (
        "--nb-decl-byz", "4", "--nb-real-byz", "4", "--gar", gar,
        "--attack", attack, *(("--attack-args", *attack_args) if attack_args else ())),
        gar)


# The rest of the model zoo at full width (`models/resnet.py`, `vgg.py`,
# `densenet.py`, `mobilenet.py`, `transformer.py`): family name -> (model,
# flat parameter count d). None has a grouped forward (the JAX package has
# no `apply_grouped` for them): each takes the vmapped honest phase
ZOO = {"resnet18": ("resnet18", 11_181_642),
       "resnet50": ("resnet50", 23_528_522),
       "vgg16": ("vgg16", 134_301_514),
       "densenet121": ("densenet121", 6_964_106),
       "mobilenet_v2": ("mobilenet_v2", 2_236_682),
       "transformer": ("transformer-classifier", 104_394)}
# The dropout launches of a step: VGG's two classifier masks (keep 0.5, the
# 8-bit threshold), MobileNetV2's one (keep 0.8, the Bernoulli path, from
# the worker's key itself)
ZOO_MASKS = {"vgg16": {("dropout_masks", BOOL): 2},
             "mobilenet_v2": {("bernoulli_masks", BOOL): 1}}


def zoo_cell(name, family, n, f, gar, attack):
    """A zoo model's run on CIFAR-10 with `cifar_cell`'s flags (n workers,
    f real Byzantine workers, batch 50, momentum 0.99 at update, clip 5,
    16 steps) and `--loss crossentropy` (the torchvision families return
    raw logits): a step launches its GAR's kernels, the split of the step
    key and the model's dropout masks (family `family`)."""
    attack, attack_args = attack
    argv = ("--dataset", "cifar10", "--model", ZOO[family][0],
            "--nb-workers", str(n), "--nb-decl-byz", str(f),
            "--nb-real-byz", str(f), "--gar", gar, "--attack", attack,
            "--attack-args", *attack_args, "--batch-size", "50",
            "--batch-size-test", "100", "--batch-size-test-reps", "5",
            "--evaluation-delta", str(STEPS), "--momentum", "0.99",
            "--momentum-at", "update", "--gradient-clip", "5",
            "--learning-rate", "0.01", "--nb-for-study", "1",
            "--nb-for-study-past", "1", "--loss", "crossentropy")
    return Cell(name, argv, STEPS, family, {**gar_launches(gar), **SPLIT_STEP,
                                            **ZOO_MASKS.get(family, {})})


ZOO_CELLS = (
    zoo_cell("resnet18_bulyan", "resnet18", 25, 5, "bulyan", EMPIRE),
    zoo_cell("resnet50_krum_f11", "resnet50", 25, 11, "krum", LITTLE),
    zoo_cell("vgg16_median", "vgg16", 11, 2, "median", LITTLE),
    zoo_cell("densenet121_trmean", "densenet121", 25, 11, "trmean", LITTLE),
    zoo_cell("mobilenet_v2_meamed", "mobilenet_v2", 25, 11, "meamed", LITTLE),
    # `tests/test_driver.py:148`'s line at the model's default width (depth
    # 2, dim 64, heads 4), on MNIST with the driver's defaults otherwise
    Cell("transformer_mnist_median", (
        "--model", "transformer-classifier", "--gar", "median",
        "--nb-real-byz", "2", "--attack", "little", "--attack-args",
        "factor:1.5", "--nb-for-study", "11", "--nb-for-study-past", "2"),
        MNIST_STEPS, "transformer", {**gar_launches("median"), **SPLIT_STEP}),
)


CELLS = (
    cifar_cell("headline", "bulyan", 5, EMPIRE),
    cifar_cell("krum_f11", "krum", 11, EMPIRE),
    *(cifar_cell(gar, gar, 11, LITTLE)
      for gar in ("median", "trmean", "phocas", "meamed", "aksel")),
    cifar_cell("brute", "brute", 11, EMPIRE),
    cifar_cell("cge", "cge", 11, LITTLE),
    *(cifar_cell(f"{gar}_bf16", gar, 11, LITTLE, flags=BF16_RUN, dtype=BF16)
      for gar in ("median", "trmean", "phocas", "meamed")),
    *(cifar_cell(f"{gar}_f16", gar, 11, LITTLE, flags=F16_RUN, dtype=F16)
      for gar in ("phocas", "meamed")),
    cifar_cell("headline_mixed", "bulyan", 5, EMPIRE, flags=MIXED_RUN),
    cifar_cell("headline_vmapped", "bulyan", 5, EMPIRE, flags=VMAPPED_RUN),
    cifar_cell("cifar10-empire-bulyan-f_5-lr_0.01-at_update", "bulyan", 5,
               EMPIRE, flags=GRID_RUN),
    # The adaptive attacks: each probe of the line search calls the GAR,
    # and the outer aggregation once more (Bulyan and Median have no
    # acceptation ratio; Krum's takes one more Gram). Under bf16 the
    # probes are f32 and only the outer median is bf16
    cifar_cell("headline_adaptive", "bulyan", 5, EMPIRE_ADAPTIVE,
               per_step={("sq_gram", F32): PROBES + 1,
                         ("selected_median_mean", F32): PROBES + 1,
                         **SEARCH_STEP}),
    cifar_cell("krum_f11_strict", "krum", 11, STRICT_ADAPTIVE,
               per_step={("sq_gram", F32): PROBES + 2,
                         ("weighted_rows_mean", F32): PROBES + 1,
                         **SEARCH_STEP}),
    cifar_cell("median_little_adaptive", "median", 11, LITTLE_ADAPTIVE,
               per_step={("lower_median", F32): PROBES + 1, **SEARCH_STEP}),
    cifar_cell("median_bf16_adaptive", "median", 11, LITTLE_ADAPTIVE,
               flags=BF16_RUN,
               per_step={("lower_median", F32): PROBES, ("lower_median", BF16): 1,
                         **SEARCH_STEP}),
    cifar_cell("cge_anticge", "cge", 11, ANTICGE, per_step={}),
    # The `--gars` mixture drawn once a step (only the drawn member runs:
    # the host mirrors the key chain) and at every defense call (every
    # member runs, the hash and the draw pick one on the card), and the
    # headline under Adam
    cifar_cell("headline_mixture", "bulyan", 5, EMPIRE, flags=MIXTURE_RUN,
               per_step=mixture_launches),
    cifar_cell("headline_mixture_per_call", "bulyan", 5, EMPIRE_ADAPTIVE,
               flags=(*MIXTURE_RUN, "--gars-per-call"),
               per_step=PER_CALL_STEP),
    cifar_cell("headline_adam", "bulyan", 5, EMPIRE,
               flags=("--optimizer", "adam")),
    # The MNIST half: the driver's defaults (no kernel), BASELINE.md's
    # MNIST configs, the paper's grid and its cells against `nan`, phishing
    mnist_cell("default", (), "average", steps=STEPS),
    *(baseline_cell(gar) for gar in ("krum", "median", "trmean")),
    *(grid_cell(name) for name in (
        "mnist-little-bulyan-f_12-lr_0.5-at_worker-nesterov",
        "mnist-empire-krum-f_24-lr_0.5-at_update",
        "fashionmnist-little-median-f_24-lr_0.02-at_worker",
        "fashionmnist-empire-trmean-f_12-lr_0.5-at_update-nesterov",
        "mnist-little-phocas-f_24-lr_0.02-at_update",
        "mnist-empire-meamed-f_12-lr_0.5-at_worker",
        "mnist-average-n_27-lr_0.5",
        *(f"mnist-nan-{gar}-f_{f}-lr_0.5-at_update" for gar, f in (
            ("krum", 24), ("median", 24), ("trmean", 24), ("phocas", 24),
            ("meamed", 24), ("bulyan", 12))))),
    mnist_cell("phishing-krum", (
        "--dataset", "phishing", "--model", "simples-logit", "--loss", "bce",
        "--criterion", "sigmoid", "--gar", "krum", "--nb-workers", "11",
        "--nb-decl-byz", "4", "--nb-real-byz", "4", "--attack", "empire",
        "--attack-args", "factor:1.1"), "krum"),
    # The rest of the attack registry on BASELINE.md's MNIST flags
    attack_cell("mnist-alie-krum", "alie", ()),
    attack_cell("mnist-alie-warmup-krum", "alie-warmup", ("window:25",)),
    attack_cell("mnist-framing-krum", "framing",
                ("victim:0", "push:1.0", "jitter:0.1")),
    attack_cell("mnist-mimic-median", "mimic", ("victim:0", "jitter:0.1"),
                gar="median"),
    # The paper's appendix grid on WRN-28-10 (`bench.py`'s wrn28x10 cell in
    # f32 and bf16-mixed) and BASELINE.md config 5 (two local steps, the
    # vmapped honest phase)
    wrn_cell(APPENDIX_BULYAN, APPENDIX_BULYAN, "bulyan"),
    wrn_cell("wrn28x10_mixed", APPENDIX_BULYAN, "bulyan", MIXED_RUN),
    wrn_cell("cifar10-little-median-f_4-lr_pow-at_worker-nesterov",
             "cifar10-little-median-f_4-lr_pow-at_worker-nesterov", "median"),
    wrn_cell("cifar10-empire-krum-f_4-lr_pow-at_update-nesterov",
             "cifar10-empire-krum-f_4-lr_pow-at_update-nesterov", "krum"),
    wrn_cell("baseline_wrn_aksel", APPENDIX_BULYAN, "aksel",
             ("--gar", "aksel", "--nb-local-steps", "2"), local_steps=2),
    # The rest of the model zoo, each timed
    *ZOO_CELLS,
)
# GAR diagnostics (`--gar-diagnostics`), driven after `CELLS` in a phase
# of their own: the headline (Bulyan's diagnose form launches its plain
# form's kernels), Trimmed mean at f = 11 (the rank trim's colsort) and
# the JAX package's `tests/test_diag.py` line at the full width of
# simples-full (MNIST, n = 9, f = 2, Krum against `empire factor:1.1`,
# momentum at the workers, `--nb-for-study 7`, seed 11, 16 steps)
DIAG_RUN = ("--gar-diagnostics",)
DIAG_CELLS = (
    cifar_cell("headline_diag", "bulyan", 5, EMPIRE, flags=DIAG_RUN,
               per_step=diag_launches("bulyan")),
    cifar_cell("trmean_diag", "trmean", 11, LITTLE, flags=DIAG_RUN,
               per_step=diag_launches("trmean")),
    mnist_cell("mnist_krum_worker_diag", (
        "--batch-size", "8", "--batch-size-test", "32",
        "--batch-size-test-reps", "2", "--model", "simples-full", "--seed",
        "11", "--nb-workers", "9", "--nb-decl-byz", "2", "--nb-real-byz", "2",
        "--gar", "krum", "--attack", "empire", "--attack-args", "factor:1.1",
        "--momentum-at", "worker", "--nb-for-study", "7",
        "--nb-for-study-past", "2", *DIAG_RUN), "krum", steps=STEPS),
)
# Fault plans (`--fault-plan`), driven after the diagnostics cells in a
# phase of their own ("fault cells"). HEADLINE_PLAN: a device lost at
# step 2, a NaN window over steps 2-5, an attack row dropped over 4-6, a
# straggler over 6-9 (across the chunk boundary at step 8), a duplicate
# at 10-11 and a scaled window at 12-13
HEADLINE_PLAN = faults_mod.FaultPlan(events=(
    faults_mod.device_loss(3, 2),
    faults_mod.corrupt_gradient(9, 2, mode="nan", duration=4),
    faults_mod.drop_worker(22, 4, duration=3),
    faults_mod.straggler(1, 6, delay_steps=4),
    faults_mod.duplicate_submission(12, 10, source=13, duration=2),
    faults_mod.corrupt_gradient(14, 12, mode="scale", scale=10.0, duration=2),
))
# At f = 11 the honest rows are 0-13, and the plan's validation refuses a
# scaled window on row 14 (an attack row): it moves to worker 4
KRUM_F11_PLAN = dataclasses.replace(HEADLINE_PLAN, events=(
    *HEADLINE_PLAN.events[:5],
    faults_mod.corrupt_gradient(4, 12, mode="scale", scale=10.0, duration=2)))
# `reproduce.py::submit_faults`'s plan at rate 0.02 (the grid that
# `study.fault_rate_sweep` reads)
MNIST_FAULT_PLAN = faults_mod.FaultPlan.generate(
    nb_workers=9, nb_steps=30, seed=200,
    rates={"straggler": 0.02, "drop_worker": 0.02, "corrupt_gradient": 0.01})
FAULT_PLANS = {"headline": HEADLINE_PLAN, "krum_f11": KRUM_F11_PLAN,
               "mnist": MNIST_FAULT_PLAN}
# Where `write_fault_plans` puts them for the cells' `--fault-plan`
FAULT_PLAN_DIR = (pathlib.Path(tempfile.gettempdir())
                  / f"bmt-chip-smoke-plans-{os.getpid()}")


def plan_flag(name):
    return ("--fault-plan", str(FAULT_PLAN_DIR / f"{name}.json"))


def write_fault_plans():
    FAULT_PLAN_DIR.mkdir(parents=True, exist_ok=True)
    for name, plan in FAULT_PLANS.items():
        plan.save(FAULT_PLAN_DIR / f"{name}.json")


# One masked call's launches (`faults/quorum.py`): the Gram and the
# weighted rows mean (Bulyan's stack of its n - 2 rounds, Krum's average),
# and for Bulyan's stage 2 two colsorts (the stack's median and the
# deviations' threshold); the coordinate-wise rules sort with colsort
MASKED_CALLS = {
    "bulyan": (("sq_gram", 1), ("weighted_rows_mean", 1), ("colsort", 2)),
    "krum": (("sq_gram", 1), ("weighted_rows_mean", 1)),
    "median": (("colsort", 1),), "trmean": (("colsort", 1),),
    "phocas": (("colsort", 2),), "meamed": (("colsort", 2),),
}


def masked_launches(gar, calls=1):
    """The exact f32 launches of `calls` masked calls of `gar`."""
    return {(kernel, F32): calls * count for kernel, count in MASKED_CALLS[gar]}


FAULT_CELLS = (
    cifar_cell("headline_faults", "bulyan", 5, EMPIRE,
               flags=plan_flag("headline"), per_step=masked_launches("bulyan")),
    # Krum at f = 11 under diagnostics: the masked aggregation, the diag
    # program on the full stack and the acceptation ratio's Gram
    cifar_cell("krum_f11_faults_diag", "krum", 11, EMPIRE,
               flags=(*plan_flag("krum_f11"), *DIAG_RUN),
               per_step=dict(collections.Counter(masked_launches("krum"))
                             + collections.Counter(diag_launches("krum")))),
    # The line search's 16 probes take the masked Bulyan too
    cifar_cell("adaptive_faults", "bulyan", 5, EMPIRE_ADAPTIVE,
               flags=plan_flag("headline"),
               per_step={**masked_launches("bulyan", calls=PROBES + 1),
                         **SEARCH_STEP}),
    mnist_cell("mnist-faults-krum-r_0.02", (
        "--batch-size", "16", "--model", "simples-full", "--loss", "nll",
        "--momentum", "0.9", "--evaluation-delta", "10", "--nb-steps", "30",
        "--nb-for-study", "9", "--nb-for-study-past", "3", "--nb-workers",
        "9", "--batch-size-test", "32", "--batch-size-test-reps", "2",
        "--learning-rate", "0.5", "--gar", "krum", "--nb-decl-byz", "2",
        *plan_flag("mnist")), "krum", steps=30),
)
# The health cells (`--health`, `--rollback-budget`), driven after the
# fault cells in a phase of their own ("health cells"): the headline with
# the health vector; the headline without telemetry (on by default with a
# result directory); 48 headline steps in chunks of 8 with and without a
# rollback budget (its isfinite flag, read with each chunk's rows)
HEALTH_RUN = ("--health",)
HEALTH_CELL = cifar_cell("headline_health", "bulyan", 5, EMPIRE,
                         flags=HEALTH_RUN)
NO_TELEMETRY_CELL = cifar_cell("headline_no_telemetry", "bulyan", 5, EMPIRE,
                               flags=("--no-telemetry",))
BUDGET_STEPS = 48
BUDGET_CELLS = tuple(
    cifar_cell(name, "bulyan", 5, EMPIRE, BUDGET_STEPS,
               ("--checkpoint-delta", str(BUDGET_STEPS), *flags))
    for name, flags in (("headline_48", ()),
                        ("headline_48_budget", ("--rollback-budget", "1"))))
# The rollback: the headline with a checkpoint every 4 steps and a budget
# of 2, its parameters poisoned after the chunk past step ROLLBACK_NAN
# (the flag read before the milestone at step 8, the restore from
# checkpoint-4), at M = 8 (chunks of 4) and M = 1
ROLLBACK_FLAGS = ("--checkpoint-delta", "4", "--rollback-budget", "2")
ROLLBACK_NAN = 6
ROLLBACK_CELLS = {
    M: cifar_cell(f"headline_rollback_m{M}", "bulyan", 5, EMPIRE,
                  flags=(*ROLLBACK_FLAGS, "--steps-per-program", str(M)))
    for M in (1, M_DEFAULT)}
# The quorum tightening after that rollback: Krum at f = 5 takes f = 6
# (n >= 2f + 3), the headline's Bulyan does not (n >= 4f + 3 fails)
TIGHTEN_CELLS = (
    cifar_cell("krum_f5_tighten", "krum", 5, EMPIRE,
               flags=(*ROLLBACK_FLAGS, "--rollback-tighten-quorum")),
    cifar_cell("headline_tighten", "bulyan", 5, EMPIRE,
               flags=(*ROLLBACK_FLAGS, "--rollback-tighten-quorum")))
# The JAX health test's early warning at the headline: 48 single-step
# chunks, a checkpoint every 5 steps, a budget of 1, the parameters
# multiplied by a factor after every chunk past step 36: 1e6 with
# --health, and with --rollback-on-anomaly; 10 with --rollback-on-anomaly
# (at 1e6 the headline's state is non-finite one step after the anomaly
# edge, before the pipelined trigger can act, so the JAX driver's order,
# the non-finite flag first, rolls back on it)
ANOMALY_CELLS = tuple(
    (cifar_cell(name, "bulyan", 5, EMPIRE, 48,
                ("--steps-per-program", "1", "--checkpoint-delta", "5",
                 "--rollback-budget", "1", flag)),
     {"BMT_CHAOS_BLOWUP_AT_STEP": "36", "BMT_CHAOS_BLOWUP_FACTOR": factor})
    for name, flag, factor in (
        ("headline_anomaly", "--health", "1e6"),
        ("headline_anomaly_trigger", "--rollback-on-anomaly", "1e6"),
        ("headline_anomaly_trigger_x10", "--rollback-on-anomaly", "10")))
CELLS_BY_NAME = {cell.name: cell for cell in (*CELLS, *DIAG_CELLS,
                                              *FAULT_CELLS, HEALTH_CELL)}
# Each cell's steps/s (`drive`), so a fault cell's stands beside its
# unfaulted cell's
RATES = {}
# Cells that run on other synthetic sets than the script's: the JAX
# diagnostics test's line on that test's own (its `small_synth` fixture),
# on which the test's claims (no attacker selected from step 8 on) are
# made
CELL_ENV = {"mnist_krum_worker_diag": {"BMT_SYNTH_TRAIN": "512",
                                       "BMT_SYNTH_TEST": "128"}}


@contextlib.contextmanager
def cell_env(name):
    """The environment `CELL_ENV` gives cell `name`, restored after."""
    env = CELL_ENV.get(name, {})
    saved = {key: os.environ.get(key) for key in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for key, value in saved.items():
            if value is None:
                os.environ.pop(key)
            else:
                os.environ[key] = value
# Phase 5's cells: each profiled over warm steps (`step_profile`), and
# but for those of `STEP_PROFILED_ONLY` over a chunk of the default M too
# (`chunk_profile`). Brute's profile (its enumeration, 98% of its step,
# 95k device operations a step) was taken out when the zoo cells came
# in, to keep the run inside its time limit, as were the chunk profiles
# of WRN-28-10, of the per-call mixture and of the zoo cells (tens of
# thousands of device operations a chunk to trace)
PROFILED = ("headline", "krum_f11", "headline_mixed", "headline_vmapped",
            "mnist-empire-krum-f_24-lr_0.5-at_update", "headline_adaptive",
            "headline_mixture", "headline_mixture_per_call", "headline_adam",
            "headline_diag", "headline_faults", APPENDIX_BULYAN,
            *(cell.name for cell in ZOO_CELLS))
STEP_PROFILED_ONLY = (APPENDIX_BULYAN, "headline_mixture_per_call",
                      *(cell.name for cell in ZOO_CELLS))
WRAPPERS = {wrapper.__name__: wrapper for wrapper in (
    gar_kernels.sq_gram, gar_kernels.selected_median_mean,
    gar_kernels.weighted_rows_mean, gar_kernels.masked_rows_mean,
    sort_kernels.colsort, sort_kernels.lower_median,
    sort_kernels.trimmed_mean, sort_kernels.closest_mean,
    prng_kernels.dropout_masks, prng_kernels.bernoulli_masks,
    prng_kernels.split_keys, search_kernels.linesearch_step,
    mixture_kernels.operand_hash, mixture_kernels.mixture_draw)}


def cell_argv(cell, steps, resdir):
    """The driver's command line for a cell of `CELLS` (the common flags
    first and `--nb-steps` after the cell's, so that it overrides a
    grid line's `--nb-steps 300`)."""
    return ["--device", "cuda", "--seed", "1", *cell.argv,
            "--nb-steps", str(steps), "--result-directory", resdir]


def chunks(steps, evaluation_delta, checkpoint_delta, per_program=M_DEFAULT):
    """The chunk lengths the driver's horizon cuts a run of `steps` steps
    into: up to `per_program` steps, ending at every evaluation and
    checkpoint boundary and at the last step."""
    sizes, step = [], 0
    while step < steps:
        bounds = [(step // delta + 1) * delta
                  for delta in (evaluation_delta, checkpoint_delta) if delta > 0]
        size = max(1, min(per_program, min([*bounds, steps]) - step))
        sizes.append(size)
        step += size
    return sizes


def drive(cell, smi):
    """Phase 4, one run; returns its launch counts by (kernel, dtype)."""
    name, _, steps, _, per_step = cell
    with tempfile.TemporaryDirectory() as tmp:
        argv = cell_argv(cell, steps, tmp)
        _cuda.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        with cell_env(name):
            summary = driver.run(argv)
        torch.cuda.synchronize()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        launches = {(kernel, dt): count for kernel, wrapper in WRAPPERS.items()
                    for dt, count in wrapper.launches_by_dtype.items() if count}
        lines = (pathlib.Path(tmp) / "study").read_text().split(os.linesep)
        evals = len(range(0, steps + 1, driver.process_commandline(
            argv).evaluation_delta))
        records = telemetry_verdict(name, pathlib.Path(tmp), steps, evals,
                                    "--no-telemetry" not in cell.argv)
    header = lines[0]
    forensic = "--gar-diagnostics" in cell.argv
    faulted = "--fault-plan" in cell.argv
    recovery = "--rollback-budget" in cell.argv
    health = "--health" in cell.argv
    columns = (("FAULT_COLUMNS", FAULT_COLUMNS, faulted),
               ("RECOVERY_COLUMNS", RECOVERY_COLUMNS, recovery),
               ("FORENSIC_COLUMNS", FORENSIC_COLUMNS, forensic),
               ("HEALTH_COLUMNS", HEALTH_COLUMNS, health))
    if header != "# " + "\t".join(STUDY_COLUMNS + sum(
            (names for _, names, on in columns if on), ())):
        raise SystemExit(f"{name}: study header differs from STUDY_COLUMNS"
                         + "".join(f" + {label}" for label, _, on in columns
                                   if on))
    rows = [line.split("\t") for line in lines[1:]]
    if len(rows) != steps:
        raise SystemExit(f"{name}: study has {len(rows)} rows, expected {steps}")
    if faulted:
        fault_verdict(name, rows, smi)
    if forensic:
        forensic_verdict(name, rows, smi)
    col = STUDY_COLUMNS.index("Defense gradient norm")
    norms = np.array([float(row[col]) for row in rows])
    if not np.all(np.isfinite(norms)):
        raise SystemExit(f"{name}: non-finite defense gradient norm: {norms}")
    # Exactly the counts worked out from the code, and no other kernel
    want = (per_step(steps) if callable(per_step)
            else {key: per * steps for key, per in per_step.items()})
    if launches != want:
        raise SystemExit(f"{name}: launches {launches} in {steps} steps, "
                         f"expected {want}")
    # Every step and evaluation on the device-resident batches, every
    # honest phase on the program asked for
    args = driver.process_commandline(argv)
    # A model without a grouped forward (the zoo's) takes the vmapped one
    grouped = getattr(models_mod.models[args.model], "forward_grouped", None)
    honest = ("vmapped_phases" if args.no_grouped_workers or args.nb_local_steps > 1
              or grouped is None else "grouped_phases")
    sizes = chunks(steps, args.evaluation_delta, args.checkpoint_delta,
                   args.steps_per_program)
    multi = sum(size > 1 for size in sizes)
    want = {"indexed_steps": steps, honest: steps,
            "indexed_evals": len(range(0, steps + 1, args.evaluation_delta)),
            **({"multi_dispatches": multi} if multi else {})}
    if summary["counts"] != want:
        raise SystemExit(f"{name}: engine counts {summary['counts']}, expected "
                         f"{want}: the run left the device-resident path or "
                         f"took the other honest phase")
    rate = summary["steps_per_s"]
    if rate is None or not math.isfinite(rate):
        raise SystemExit(f"{name}: no throughput measured")
    RATES[name] = rate
    ratio = rows[-1][STUDY_COLUMNS.index("Attack acceptation ratio")]
    counts = {f"{kernel}[{DTYPE_NAMES[dt]}]": count
              for (kernel, dt), count in launches.items()}
    if name == "headline_mixture":
        drawn = collections.Counter(MIXTURE_MEMBERS[m]
                                    for m in mixture_draws(steps))
        log(f"{name}: the host mirror's draws {dict(drawn)} over {steps} "
            f"steps predict every member's launches exactly; the mirror "
            f"equalled the device's key at each chunk's end")
    log(f"{name} cell: {steps} steps in chunks {sizes}, {rate:.4f} steps/s "
        f"after the first chunk, {records} telemetry records, engine counts "
        f"{summary['counts']}, "
        f"launches {counts}, defense norms {norms[0]:.4e} .. "
        f"{norms[-1]:.4e}, acceptation ratio {ratio}, peak memory "
        f"{peak_gb:.2f} GB (max_memory_allocated) on {smi}")
    return launches


def forensic_verdict(name, rows, smi):
    """A `--gar-diagnostics` run's forensic columns: `Sel workers` the
    ';'-joined indices of distinct workers (or '-'), finite `Dist honest
    med` and `Var/norm ratio` (under a fault plan, at the steps where no
    honest row is NaN), `Clip frac` in [0, 1] (above 0 for the Trimmed
    mean), `Suspicion max` in [0, 1]; for the JAX diagnostics test's
    line, from step 8 on no selection names the attackers 7 and 8, and
    `Var/norm ratio` ends below where it started."""
    argv = list(CELLS_BY_NAME[name].argv)
    faulted = "--fault-plan" in argv
    first = len(STUDY_COLUMNS) + len(FAULT_COLUMNS) * faulted
    args = driver.process_commandline(argv)
    n = int(args.nb_workers)
    clean = np.ones(len(rows), bool)
    if faulted:
        schedule = faults_mod.build_schedule(
            faults_mod.FaultPlan.load(args.fault_plan), nb_workers=n,
            nb_honests=n - args.nb_real_byz)
        clean = np.array([not schedule.step_rows(step)[1].any()
                          for step in range(len(rows))])
    selections = []
    for row in rows:
        cell = row[first]
        picked = [int(w) for w in cell.split(";")] if cell != "-" else []
        if picked != sorted(set(picked)) or not all(0 <= w < n for w in picked):
            raise SystemExit(f"{name}: malformed Sel workers {cell!r}")
        selections.append(set(picked))
    values = np.array([[float(v) for v in row[first + 1:]] for row in rows])
    med, ratio, clip, suspicion = values.T
    if not (np.all(np.isfinite(med[clean]))
            and np.all(np.isfinite(ratio[clean]))):
        raise SystemExit(f"{name}: non-finite distance median or ratio")
    if not np.all((clip >= 0) & (clip <= 1)):
        raise SystemExit(f"{name}: clip fraction outside [0, 1]: {clip}")
    if not np.all((suspicion >= 0) & (suspicion <= 1)):
        raise SystemExit(f"{name}: suspicion outside [0, 1]: {suspicion}")
    if name == "trmean_diag" and not np.all(clip > 0):
        raise SystemExit(f"{name}: the trimmed mean trimmed nothing: {clip}")
    if name == "mnist_krum_worker_diag":
        late = [sel & {7, 8} for step, sel in enumerate(selections)
                if step >= 8]
        if any(late):
            raise SystemExit(f"{name}: an attacker selected from step 8 on: "
                             f"{[sorted(s) for s in selections]}")
        if not ratio[-1] < ratio[0]:
            raise SystemExit(f"{name}: Var/norm ratio {ratio[0]} .. "
                             f"{ratio[-1]} did not fall")
    log(f"{name} forensic columns: selected {sorted(selections[0])} at step "
        f"0 and {sorted(selections[-1])} at step {len(rows) - 1}; distance "
        f"median {med[0]:.4e} .. {med[-1]:.4e}, Var/norm ratio "
        f"{ratio[0]:.4e} .. {ratio[-1]:.4e}, clip fraction {clip.mean():.4f} "
        f"on average, suspicion max {suspicion.max():.4f} at most on {smi}")


def diag_vs_plain(smi):
    """Phase 4, `--gar-diagnostics` changes nothing but the columns it
    adds: under deterministic cuDNN (and PyTorch's deterministic
    algorithms) `headline_diag`'s study rows are byte-equal to the
    headline's in the 24 study columns (16 steps each, the default M)."""
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        runs = {name: fused_run(CELLS_BY_NAME[name], M_DEFAULT)
                for name in ("headline", "headline_diag")}
    finally:
        torch.backends.cudnn.deterministic = False
        torch.use_deterministic_algorithms(False)
    plain, diag = ([row.split("\t") for row in runs[name][2].split(os.linesep)[1:]]
                   for name in ("headline", "headline_diag"))
    width = len(STUDY_COLUMNS)
    if len(plain) != STEPS or [row[:width] for row in diag] != plain:
        raise SystemExit("diag_vs_plain: headline_diag's first 24 columns "
                         "differ from the headline's")
    log(f"diag_vs_plain (deterministic): headline_diag's {STEPS} rows equal "
        f"the headline's byte for byte in the {width} study columns; "
        f"{runs['headline'][0]:.4f} steps/s without diagnostics, "
        f"{runs['headline_diag'][0]:.4f} with, on {smi}")


def expected_fault_columns(name):
    """A fault cell's `Faults injected`, `Workers active` and `Quorum f`
    rows worked out on the host from its plan's schedule: the schedule's
    count; the rows neither dropped nor quarantined, where the honest
    rows corrupted to NaN are quarantined and so, when one is, are the
    `empire` rows (a multiple of the honest rows' mean, NaN with it);
    the declared f clamped to the rule's ceiling at that count
    (`faults/quorum.py::_F_CEILING`)."""
    cell = CELLS_BY_NAME[name]
    args = driver.process_commandline(list(cell.argv))
    n, h = args.nb_workers, args.nb_workers - args.nb_real_byz
    plan = faults_mod.FaultPlan.load(args.fault_plan)
    schedule = faults_mod.build_schedule(plan, nb_workers=n, nb_honests=h)
    ceiling = quorum._F_CEILING.get(args.gar, lambda count: (count - 1) // 2)
    out = []
    for step in range(cell.steps):
        stale, nan, zero, scale, dup, drop, injected = schedule.step_rows(step)
        bad = np.zeros(n, bool)
        bad[:h] = nan
        if nan.any() and args.attack == "empire":
            bad[h:] = True
        active = int((~drop & ~bad).sum())
        out.append([injected, active,
                    max(min(args.nb_decl_byz, ceiling(active)), 0)])
    return out


def fault_verdict(name, rows, smi):
    """A fault cell's three columns (`FAULT_COLUMNS`, after the study
    columns) equal `expected_fault_columns`."""
    first = len(STUDY_COLUMNS)
    got = [[int(v) for v in row[first:first + len(FAULT_COLUMNS)]]
           for row in rows]
    want = expected_fault_columns(name)
    if got != want:
        raise SystemExit(f"{name}: fault columns {got}, expected {want}")
    columns = list(zip(*got))
    log(f"{name} fault columns (equal to the schedule's): Faults injected "
        f"{list(columns[0])}, Workers active {list(columns[1])}, Quorum f "
        f"{list(columns[2])} on {smi}")


class QuarantineLog(obs.SuspicionTracker):
    """A suspicion tracker that keeps, after each step, the post-quarantine
    active mask it was given and its quarantine term."""

    steps = []

    def update(self, step, selection, distances=None, active=None,
               dist_matrix=None):
        out = super().update(step, selection, distances=distances,
                             active=active, dist_matrix=dist_matrix)
        QuarantineLog.steps.append((step, np.asarray(active),
                                    self._quarantine.copy()))
        return out


def quarantine_verdict(smi):
    """`krum_f11_faults_diag`: the tracker is fed the `Active mask`, so
    worker 9 (NaN over steps 2-5) carries the quarantine term from step 2,
    growing to step 5 and decaying after, worker 3 (lost at step 2) from
    step 2 on, and worker 0 never."""
    log_ = QuarantineLog.steps
    active = np.array([a for _, a, _ in log_])
    term = np.array([q for _, _, q in log_])
    held = (len(log_) == STEPS
            and not active[2:6, 9].any() and active[[0, 1, 6], 9].all()
            and np.all(term[:2, 9] == 0) and np.all(np.diff(term[1:6, 9]) > 0)
            and np.all(np.diff(term[5:, 9]) < 0)
            and np.all(term[2:, 3] > 0) and not term[:, 0].any())
    if not held:
        raise SystemExit(f"krum_f11_faults_diag: the tracker's quarantine "
                         f"term {term[:, [0, 3, 9]].tolist()} on active masks "
                         f"{active[:, [0, 3, 9]].tolist()}")
    log(f"krum_f11_faults_diag: the suspicion tracker's quarantine term of "
        f"worker 9 rises over its NaN steps 2-5 to {term[5, 9]:.4f} and "
        f"decays to {term[-1, 9]:.4f}; worker 3's (lost at step 2) ends at "
        f"{term[-1, 3]:.4f}, worker 0's stays 0 on {smi}")


def fault_resume(smi):
    """Under deterministic cuDNN, FAULT_RESUME (`resume_runs` side by
    side): the killed run restarts from checkpoint-7, inside the straggler
    window, and must write the uninterrupted runs' eval file and study
    rows byte for byte (`resume_verdict`, `exact`)."""
    with tempfile.TemporaryDirectory() as tmp:
        resume_verdict(resume_runs(pathlib.Path(tmp), True, side_by_side=True,
                                   case=FAULT_RESUME),
                       "faults, cudnn.deterministic", smi, case=FAULT_RESUME,
                       exact=True)


def fault_vs_single(smi):
    """Under deterministic cuDNN, `headline_faults` at M = 1 and M = 8
    writes the same study and eval bytes (the chunk's fault rows in one
    upload, the straggler window across the chunk boundary at step 8), on
    `fused_vs_single`'s FUSED_TRAIN images (no epoch boundary inside a
    chunk)."""
    saved = os.environ.get("BMT_SYNTH_TRAIN")
    os.environ["BMT_SYNTH_TRAIN"] = FUSED_TRAIN
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        runs = {M: fused_run(CELLS_BY_NAME["headline_faults"], M)
                for M in (1, M_DEFAULT)}
    finally:
        torch.backends.cudnn.deterministic = False
        torch.use_deterministic_algorithms(False)
        if saved is None:
            os.environ.pop("BMT_SYNTH_TRAIN")
        else:
            os.environ["BMT_SYNTH_TRAIN"] = saved
    if runs[1][1:] != runs[M_DEFAULT][1:]:
        raise SystemExit("fault_vs_single: headline_faults at M = 1 and "
                         "M = 8 wrote different CSVs")
    log(f"fault_vs_single (deterministic): headline_faults at M = 1 "
        f"({runs[1][0]:.4f} steps/s) and M = 8 ({runs[M_DEFAULT][0]:.4f} "
        f"steps/s) wrote the same study and eval bytes on {smi}")


# Each fault cell and the cell it faults
FAULT_BASE = {"headline_faults": "headline",
              "krum_f11_faults_diag": "krum_f11",
              "adaptive_faults": "headline_adaptive"}


def masked_vs_plain(smi):
    """The masked Bulyan (f = 5, HEADLINE_PLAN) and Krum (f = 11,
    KRUM_F11_PLAN) at the headline operand (phase 3's f32[25, 1,310,922]),
    on each of the plan's STEPS steps as the engine builds it: the honest
    rows (rolled by the step, so a straggler's buffered rows differ from
    its fresh ones) through `inject.inject`, the empire rows -1.1 times
    their mean (NaN where an honest row is), `sanitize.quarantine`; then
    `quorum.masked_aggregate` with the kernels (launches exactly
    MASKED_CALLS) against the same call with their plain versions on the
    card (`plain_kernels`): `f_eff` exactly, the aggregate within rtol
    1e-5, atol 1e-6 (`tests/test_torch_gpu.py`'s tolerance).

    The selection is read off the Gram matrix, and the scores of
    normal rows at this width lie within a Gram's f32 rounding of each
    other: both Grams are held to the f64 one (within 1e-5 of its
    largest diagonal entry, phase 3's tolerance), and where the two
    calls select other rows from them (the weights from each Gram), the
    step is a near-tie, logged and not compared; where they select the
    same rows the aggregates must agree. Each rule must compare most of
    its steps."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    g = torch.randn((HEADLINE_N, HEADLINE_D), generator=gen, device=dev)
    for name, f, plan in (("bulyan", 5, HEADLINE_PLAN),
                          ("krum", 11, KRUM_F11_PLAN)):
        h = HEADLINE_N - f
        schedule = faults_mod.build_schedule(plan, nb_workers=HEADLINE_N,
                                             nb_honests=h)
        rows = schedule.upload(0, STEPS, dev)
        buffer = g[:h] if schedule.has_stale else g.new_zeros((0, HEADLINE_D))
        select = {"bulyan": lambda *a: bulyan.selection_weights_masked(*a)[0],
                  "krum": krum.selection_weights_masked}[name]
        err, counts, ties = 0.0, [], []
        for step in range(STEPS):
            honest, buffer, ctx = inject.inject(
                rows.at(step), schedule.has_stale, g[:h].roll(step, 0), buffer)
            G = torch.cat([honest,
                           (honest.mean(dim=0) * -1.1).expand(f, -1)])
            active, _ = sanitize.quarantine(G, ctx.active)
            _cuda.reset_launches()
            agg, f_eff = quorum.masked_aggregate(gars[name], G, active,
                                                 f_decl=f)
            torch.cuda.synchronize()
            if launched() != masked_launches(name):
                raise SystemExit(f"masked {name} step {step}: launches "
                                 f"{launched()}, expected "
                                 f"{masked_launches(name)}")
            _cuda.reset_launches()
            with plain_kernels():
                want, want_f = quorum.masked_aggregate(gars[name], G, active,
                                                       f_decl=f)
            torch.cuda.synchronize()
            if launched():
                raise SystemExit(f"masked {name}: the plain versions "
                                 f"launched {launched()}")
            if not torch.equal(f_eff, want_f):
                raise SystemExit(f"masked {name} step {step}: f_eff "
                                 f"{int(f_eff)}, plain {int(want_f)}")
            counts.append((int(active.sum()), int(f_eff)))
            grams = {"kernel": gar_kernels.sq_gram(G),
                     "plain": gar_kernels.sq_gram_plain(G)}
            exact = (G.double() @ G.double().T).float()
            diag = torch.diagonal(exact)
            atol = TOL_RTOL * float(diag[torch.isfinite(diag)].max())
            for label, gram in grams.items():
                compare(f"masked {name} step {step} {label} Gram against f64",
                        gram, exact, atol=atol, rtol=0.0)
            n_eff = active.sum(dtype=torch.int32)
            weights = [select(_common.distances_from_sq_gram(gram), active,
                              n_eff, f_eff) for gram in grams.values()]
            if not torch.equal(*weights):
                ties.append(step)
                continue
            err = max(err, compare(f"masked {name} step {step}", agg, want))
        if 2 * len(ties) > STEPS:
            raise SystemExit(f"masked {name}: near-ties at steps {ties}, "
                             f"most of the {STEPS}")
        log(f"masked {name} (f = {f}) at the headline operand, {STEPS} steps "
            f"of its plan (active rows, f_eff: {counts}): the kernels' "
            f"aggregate within rtol {TOL_RTOL}, atol {TOL_ATOL} of the plain "
            f"versions' (max abs error {err:.3g}) on "
            f"{STEPS - len(ties)} steps; near-ties (the two Grams, each "
            f"within 1e-5 of the f64 one's largest diagonal entry, select "
            f"other rows) at steps {ties}; f_eff equal, launches "
            f"{masked_launches(name)} a call, on {smi}")
    _cuda.reset_launches()


def fault_cells(smi, totals):
    """The `fault cells` phase: FAULT_CELLS through the driver (their
    launches into `totals`), the quarantine in the forensic columns, each
    cell's steps/s beside its unfaulted cell's, `masked_vs_plain`,
    `fault_vs_single` and `fault_resume`."""
    for cell in FAULT_CELLS:
        saved = obs.SuspicionTracker
        if cell.name == "krum_f11_faults_diag":
            QuarantineLog.steps = []
            obs.SuspicionTracker = QuarantineLog
        try:
            launches = drive(cell, smi)
        finally:
            obs.SuspicionTracker = saved
        for (kernel, dtype), count in launches.items():
            totals[kernel, dtype, cell.family] += count
        if cell.name in FAULT_BASE:
            base = FAULT_BASE[cell.name]
            log(f"{cell.name}: {RATES[cell.name]:.4f} steps/s against "
                f"{base}'s {RATES[base]:.4f} on {smi}")
    quarantine_verdict(smi)
    masked_vs_plain(smi)
    fault_vs_single(smi)
    fault_resume(smi)


def telemetry_verdict(name, resdir, steps, evals, on=True):
    """A completed run's `telemetry.jsonl` and heartbeat: `run_start` and
    `data_setup` first, an `eval` span per evaluation, a `device_step_ms`
    sample, `run_end` at `steps` with status `completed`, and a final
    heartbeat at `steps` saying so; with telemetry off (`on` False),
    neither file. Returns the count of records."""
    records = obs.load_records(resdir)
    heartbeat = obs.read_heartbeat(resdir)
    if not on:
        if records or heartbeat is not None:
            raise SystemExit(f"{name}: --no-telemetry wrote a timeline")
        return 0
    events = [r["name"] for r in records if r["kind"] == "event"]
    end = [r["data"] for r in records if r["name"] == "run_end"]
    spans = [r for r in records if r["kind"] == "span" and r["name"] == "eval"]
    gauges = {r["name"] for r in records if r["kind"] == "gauge"}
    if (events[:2] != ["run_start", "data_setup"] or len(spans) != evals
            or "device_step_ms" not in gauges or not end
            or end[-1]["status"] != "completed" or end[-1]["step"] != steps
            or heartbeat is None or heartbeat.get("step") != steps
            or heartbeat.get("status") != "completed"):
        raise SystemExit(f"{name}: incomplete telemetry: events {events}, "
                         f"{len(spans)} eval spans (expected {evals}), "
                         f"gauges {sorted(gauges)}, heartbeat {heartbeat}")
    return len(records)


def health_f64(G_honest, G_attack, grad_defense, theta_old, theta_new):
    """The health vector's floats and the submitted rows' norms, in f64
    on the card."""
    Gh, Ga, gd, t0, t1 = (x.double() for x in (G_honest, G_attack,
                                               grad_defense, theta_old,
                                               theta_new))
    avg = Gh.mean(dim=0)
    dev = Gh - avg
    weight, update = torch.linalg.vector_norm(t1), torch.linalg.vector_norm(
        t0 - t1)
    return {"Var ratio": (dev * dev).sum() / (Gh.shape[0] - 1)
            / (avg * avg).sum(),
            "Weight norm": weight, "Update norm": update,
            "Update/weight": update / weight,
            "norms": torch.cat([torch.linalg.vector_norm(G, dim=1)
                                for G in (Gh, Ga)]),
            "Nonfinite aggregate": float(not torch.isfinite(gd).all())}


def health_vs_f64(smi, M=M_DEFAULT):
    """One warm chunk of `headline_health` on the driver's path, each
    step's `phase_update` inputs and output recomputed in f64 on the card:
    the four health floats within rtol 1e-5, the histogram's bins equal
    where no norm lies within 1e-6 of a bin edge (a near-tie, logged),
    the non-finite counts equal."""
    args, engine, state = setup_cell(HEALTH_CELL)
    lrs = np.full(M, args.initial_lr(0), np.float32)
    state, _ = engine.train_multi_indexed(state, *engine.sample_indices(1),
                                          lrs[:1])
    wants = []
    update = engine.phase_update

    def recomputed(state, G_sampled, loss_avg, net_state, new_mw, G_honest,
                   G_attack, grad_defense, *rest, **kwargs):
        new_state, metrics = update(state, G_sampled, loss_avg, net_state,
                                    new_mw, G_honest, G_attack, grad_defense,
                                    *rest, **kwargs)
        wants.append(health_f64(G_honest, G_attack, grad_defense,
                                state.theta, new_state.theta))
        return new_state, metrics

    engine.phase_update = recomputed
    _, metrics = engine.train_multi_indexed(state, *engine.sample_indices(M),
                                            lrs)
    worst, ties = 0.0, 0
    for i, want in enumerate(wants):
        for key in ("Var ratio", "Weight norm", "Update norm",
                    "Update/weight"):
            got, exact = float(metrics[key][i]), float(want[key])
            err = abs(got - exact) / abs(exact)
            worst = max(worst, err)
            if not err <= 1e-5:
                raise SystemExit(f"health_vs_f64: step {i} {key} {got} "
                                 f"against f64 {exact} (rel {err:.3e})")
        norms = want["norms"]
        bins = torch.clamp(torch.floor((torch.log2(norms) - health_mod.HIST_LO)
                                       / health_mod.HIST_WIDTH),
                           0, health_mod.HIST_BINS - 1).long()
        hist = torch.bincount(bins, minlength=health_mod.HIST_BINS).float()
        if not torch.equal(hist, metrics["Norm hist"][i].float()):
            edges = 2.0 ** (health_mod.HIST_LO + health_mod.HIST_WIDTH
                            * torch.round((torch.log2(norms)
                                           - health_mod.HIST_LO)
                                          / health_mod.HIST_WIDTH))
            if not bool((torch.abs(norms / edges - 1) <= 1e-6).any()):
                raise SystemExit(f"health_vs_f64: step {i} histogram "
                                 f"{metrics['Norm hist'][i].tolist()} against "
                                 f"f64 {hist.tolist()}")
            ties += 1
            log(f"  health_vs_f64: step {i}: a norm within 1e-6 of a bin "
                f"edge, the bins not compared")
        counts = [float(metrics[key][i]) for key in (
            "Nonfinite submitted", "Nonfinite aggregate", "Nonfinite state")]
        want_counts = [float((~torch.isfinite(norms)).sum()),
                       want["Nonfinite aggregate"],
                       float(not math.isfinite(float(want["Weight norm"])))]
        if counts != want_counts:
            raise SystemExit(f"health_vs_f64: step {i} non-finite counts "
                             f"{counts} against {want_counts}")
    log(f"health_vs_f64: {len(wants)} steps of headline_health at M = {M}: "
        f"the health floats within {worst:.3e} (relative) of f64 on the "
        f"card, the histograms equal ({ties} near-ties), no non-finite "
        f"count on {smi}")


def _quiet_run(argv, env=None):
    """`driver.run(argv)` under the environment `env`, its stdout and
    stderr caught; returns (summary, the text it printed)."""
    out = io.StringIO()
    saved = {key: os.environ.get(key) for key in (env or {})}
    os.environ.update(env or {})
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(out):
            summary = driver.run(argv)
    finally:
        for key, value in saved.items():
            if value is None:
                os.environ.pop(key)
            else:
                os.environ[key] = value
    return summary, out.getvalue()


def _records(resdir, name):
    return [r.get("data") or {} for r in obs.load_records(resdir)
            if r["name"] == name]


def tighten_check(smi, totals):
    """`--rollback-tighten-quorum` after the rollback at ROLLBACK_NAN: Krum
    at f = 5 goes on at f = 6 (its launches exactly Krum's over the steps
    run, rewound ones included), the headline's Bulyan keeps f = 5 with
    the driver's "Quorum not tightened" line; both finish their 16 rows."""
    nan = {"BMT_CHAOS_NAN_AT_STEP": str(ROLLBACK_NAN)}
    with tempfile.TemporaryDirectory() as tmp:
        for cell, line in zip(TIGHTEN_CELLS, (
                "Rollback: declared Byzantine count tightened to f=6",
                "Quorum not tightened: 'bulyan' cannot run with f=6")):
            resdir = pathlib.Path(tmp) / cell.name
            _cuda.reset_launches()
            summary, text = _quiet_run(cell_argv(cell, cell.steps,
                                                 str(resdir)), nan)
            launches = {(kernel, dt): count
                        for kernel, wrapper in WRAPPERS.items()
                        for dt, count in wrapper.launches_by_dtype.items()
                        if count}
            want = {key: per * summary["steps_run"]
                    for key, per in cell.per_step.items()}
            rows = (resdir / "study").read_text().split(os.linesep)[1:]
            if (line not in text or summary["rollbacks"] != 1
                    or summary["diverged"] or launches != want
                    or [row.split("\t")[0] for row in rows]
                    != [str(i) for i in range(cell.steps)]):
                raise SystemExit(f"{cell.name}: rollbacks "
                                 f"{summary['rollbacks']}, launches "
                                 f"{launches} (expected {want}), rows "
                                 f"{len(rows)}, log:\n{text[-2000:]}")
            for (kernel, dtype), count in launches.items():
                totals[kernel, dtype, cell.family] += count
            log(f"{cell.name}: rolled back once, {summary['steps_run']} "
                f"steps run for {cell.steps} rows, launches exact "
                f"{ {f'{k}[{DTYPE_NAMES[d]}]': c for (k, d), c in launches.items()} }"
                f", the driver said {line!r} on {smi}")


def anomaly_check(smi):
    """ANOMALY_CELLS through the driver, each giving up (exit code 1, a
    `divergence_giveup` blackbox) after an anomaly edge: with --health
    the first edge comes at least 2 steps before the first non-finite
    flag; with --rollback-on-anomaly the first edge comes before the
    first flag, and at the factor of 10, where the state is still finite
    when the trigger acts, every flag and rollback is an anomaly."""
    with tempfile.TemporaryDirectory() as tmp:
        for cell, env in ANOMALY_CELLS:
            resdir = pathlib.Path(tmp) / cell.name
            summary, text = _quiet_run(cell_argv(cell, cell.steps,
                                                 str(resdir)), env)
            edges = [(e["channel"], e.get("rule"), e["step"])
                     for e in _records(resdir, "health_anomaly")]
            flags = [(e["trigger"], e["step"])
                     for e in _records(resdir, "health_flag")]
            rollbacks = [(e["trigger"], e["step"], e["restored"])
                         for e in _records(resdir, "rollback")]
            box = obs.load_blackbox(resdir)
            report = (f"{cell.name} (x{env['BMT_CHAOS_BLOWUP_FACTOR']}): "
                      f"anomaly edges {edges}, flags {flags}, rollbacks "
                      f"{rollbacks}, blackbox {box and box['reason']} ring "
                      f"{box and len(box['ring'])}, {summary['steps_run']} "
                      f"steps run")
            log(f"{report} on {smi}")
            first = min((step for *_, step in edges), default=None)
            nonfinite = [step for trigger, step in flags
                         if trigger == "non-finite"]
            if (not summary["diverged"] or first is None or not flags
                    or not box or box["reason"] != "divergence_giveup"
                    or first >= min(step for _, step in flags)):
                raise SystemExit(f"{report}: expected a give-up after an "
                                 f"anomaly edge\n{text[-2000:]}")
            if "--health" in cell.argv:
                lead = min(nonfinite) - first if nonfinite else None
                if lead is None or lead < 2:
                    raise SystemExit(f"{report}: the anomaly leads the "
                                     f"non-finite flag by {lead} steps")
                log(f"  the first anomaly edge leads the non-finite flag by "
                    f"{lead} steps")
            elif env["BMT_CHAOS_BLOWUP_FACTOR"] == "10" and (
                    nonfinite or not rollbacks
                    or any(trigger != "anomaly" for trigger, *_ in rollbacks)):
                raise SystemExit(f"{report}: expected rollbacks on "
                                 f"anomalies only")


def health_children(tmp):
    """The headline, `headline_health` and the rollback runs started in
    child processes side by side under deterministic cuDNN
    (`_resume_child`), on `fused_vs_single`'s train split, into `tmp`;
    returns `{label: process}`."""
    data = {"BMT_SYNTH_TRAIN": FUSED_TRAIN}
    nan = {**data, "BMT_CHAOS_NAN_AT_STEP": ROLLBACK_NAN}
    children = {"headline": (CELLS_BY_NAME["headline"], data),
                "headline_health": (HEALTH_CELL, data),
                "rollback_ref": (ROLLBACK_CELLS[M_DEFAULT], data),
                **{f"rollback_m{M}": (cell, nan)
                   for M, cell in ROLLBACK_CELLS.items()}}
    return {label: _resume_child(tmp / label, True, extra, cell)
            for label, (cell, extra) in children.items()}


def health_children_verdict(tmp, procs, t0, smi):
    """`health_children`'s runs, waited for: `headline_health`'s first 24
    columns and eval file byte-equal to the headline's; the rollback runs
    exit 0 with steps 0-15 once each, `Rollbacks` 0 for steps 0-3 and 1
    after, restored from checkpoint-4, rows 0-3 byte-equal to an
    uninterrupted run's (the same flags, no poison) and non-finite only
    where that run's are, M = 1 and M = 8 byte-equal."""
    _waited(procs, {label: 0 for label in procs}, t0)

    def study(label):
        return [row.split("\t") for row in
                (tmp / label / "study").read_text().split(os.linesep)[1:]]

    width = len(STUDY_COLUMNS)
    plain, health = study("headline"), study("headline_health")
    if ([row[:width] for row in health] != plain
            or (tmp / "headline" / "eval").read_text()
            != (tmp / "headline_health" / "eval").read_text()):
        raise SystemExit("headline_health: its first 24 columns or its "
                         "eval file differ from the headline's")
    ref = study("rollback_ref")
    for M in ROLLBACK_CELLS:
        label = f"rollback_m{M}"
        rows = study(label)
        roll = _records(tmp / label, "rollback")
        values = np.array([[float(v) for v in row[2:width]]
                           for row in rows])
        ref_nan = np.isnan(np.array([[float(v) for v in row[2:width]]
                                     for row in ref]))
        if ([row[0] for row in rows] != [str(i) for i in range(STEPS)]
                or rows[:4] != ref[:4]
                or [row[width] for row in rows] != ["0"] * 4 + ["1"] * 12
                or [(r["step"], r["restored"]) for r in roll]
                != [(4, "checkpoint-4")]
                or not np.array_equal(~np.isfinite(values), ref_nan)):
            raise SystemExit(f"{label}: rows {[row[0] for row in rows]}, "
                             f"Rollbacks {[row[width] for row in rows]}, "
                             f"rollbacks {roll}, rows 0-3 as the "
                             f"uninterrupted run's: {rows[:4] == ref[:4]}")
    same = all((tmp / "rollback_m1" / name).read_text()
               == (tmp / f"rollback_m{M_DEFAULT}" / name).read_text()
               for name in ("study", "eval"))
    if not same:
        raise SystemExit("headline_rollback: M = 1 and M = 8 wrote other "
                         "CSVs")
    log(f"health children (deterministic, side by side, "
        f"{time.perf_counter() - t0:.1f} s): headline_health's first 24 "
        f"columns and eval file byte-equal to the headline's; the "
        f"rollback at step {ROLLBACK_NAN} restored checkpoint-4 at M = 1 "
        f"and M = {M_DEFAULT} (byte-equal), steps 0-15 once each, "
        f"Rollbacks 0 then 1, rows 0-3 the uninterrupted run's on {smi}")


def health_cells(smi, totals, grid_tmp):
    """The `health cells` phase: the timed runs first, on a card of their
    own (`headline_health`, the headline without telemetry, 48 steps with
    and without a rollback budget; their launches into `totals`), the f64
    recomputation and the chunk profile of `headline_health`; then the
    children of `health_children` and of phase 6's `grid_children` (in
    `grid_tmp`; none of their checks is timed), and beside them
    `tighten_check` and `anomaly_check`."""
    for cell in (HEALTH_CELL, NO_TELEMETRY_CELL, *BUDGET_CELLS):
        for (kernel, dtype), count in drive(cell, smi).items():
            totals[kernel, dtype, cell.family] += count
    log(f"headline_health: {RATES['headline_health']:.4f} steps/s against "
        f"the headline's {RATES['headline']:.4f} (telemetry on); the "
        f"headline with --no-telemetry {RATES['headline_no_telemetry']:.4f}; "
        f"48 steps {RATES['headline_48']:.4f} without and "
        f"{RATES['headline_48_budget']:.4f} with --rollback-budget 1 on "
        f"{smi}")
    health_vs_f64(smi)
    chunk_profile(HEALTH_CELL, smi)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        t0 = time.perf_counter()
        procs = health_children(tmp)
        grid = grid_children(grid_tmp)
        try:
            try:
                tighten_check(smi, totals)
                anomaly_check(smi)
            except BaseException:
                for proc in procs.values():
                    proc.kill()
                    proc.wait()
                raise
            health_children_verdict(tmp, procs, t0, smi)
        except BaseException:
            grid_children_end(grid)
            raise
        grid_children_verdict(grid_tmp, grid, smi)


def device_work(events):
    """The device's own events (kernels, copies, sets) among a profiler's
    events or averages: the device-side spans of the engine's phase
    ranges (`gpu_user_annotation`, open while a profiler runs,
    `engine/program.py::scope`) are no device work."""
    # A FunctionEvent has a `name`, a FunctionEventAvg a `key`
    return [e for e in events if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and getattr(e, "name", getattr(e, "key", None))
            not in obs.attrib.PHASES]


def union_busy_us(prof):
    """The device's busy time under a `torch.profiler` window: the union
    of the kernels' intervals on the device clock (kernels that overlap,
    as cuDNN's engines may, would count twice in a sum)."""
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in device_work(prof.events()))
    busy_us, reach = 0.0, -math.inf
    for start, end in spans:
        if end > reach:
            busy_us += end - max(start, reach)
            reach = end
    return busy_us


def setup_cell(cell, steps=None):
    """A cell's engine and fresh state through the driver's own set-up
    (`_postprocess`, `_setup`), with its study metrics on; returns
    `(args, engine, state)`."""
    with tempfile.TemporaryDirectory() as tmp:
        args = driver._postprocess(driver.process_commandline(
            cell_argv(cell, steps or cell.steps, tmp)))
        _, engine, state = driver._setup(args)
    return args, engine, state


def step_profile(cell, smi, steps=3, setup=None):
    """Phase 5: where the device time of a cell's step goes, over `steps`
    warm steps on the driver's path: the host draws the step's indices and
    flips, uploads them and the device gathers the batches. CUDA events
    between the index draw, the gather and the engine's three phases give
    each one's time on the device's clock; `torch.profiler` gives the
    busiest kernels and the device's busy share of the wall time (the
    union of the kernels' intervals; their summed times beside it).
    `setup` is the cell's `(args, engine, state)` where the caller has
    them (`setup_cell`); returns them, the state advanced."""
    args, engine, state = setup or setup_cell(cell, steps)
    data = engine.train_data
    lr = args.initial_lr(0)
    phase_ms = dict.fromkeys(("draw+upload", "gather", "keys+masks", "honest",
                              "defense", "update"), 0.0)

    def step(state):
        marks = [torch.cuda.Event(enable_timing=True) for _ in range(7)]
        marks[0].record()
        idx, flips = data.upload(*engine.sample_indices())
        marks[1].record()
        xs, ys = data.gather(idx, flips)
        marks[2].record()
        batch = engine._batch_of(xs)
        rng, mix_key, wkeys = engine.step_keys(state.rng)
        rng_host, member = engine.mirror_keys(state)
        masks = engine.draw_masks(wkeys, batch)
        marks[3].record()
        *honest, G_honest = engine.phase_honest(state, xs, ys, lr, masks)
        # Under a fault plan the honest phase ends with the injection
        G_honest, fault_buffer, fault = engine.phase_faults(state, G_honest)
        marks[4].record()
        defense = engine.phase_defense(G_honest, state.attack_state,
                                       mix_key=mix_key, member=member,
                                       fault=fault)
        marks[5].record()
        state, _ = engine.phase_update(
            state, *honest, G_honest, *defense[:4], lr, batch, rng=rng,
            rng_host=rng_host, **engine.defense_extras(defense),
            fault_buffer=fault_buffer)
        marks[6].record()
        return state, marks

    for _ in range(2):
        state, _ = step(state)
    torch.cuda.synchronize()
    honest_path = "grouped" if engine.grouped is not None else "vmapped"
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        all_marks = []
        for _ in range(steps):
            state, marks = step(state)
            all_marks.append(marks)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    for marks in all_marks:
        for name, a, b in zip(phase_ms, marks, marks[1:]):
            phase_ms[name] += a.elapsed_time(b) / steps

    kernels = device_work(prof.key_averages())

    def device_ms(event):
        total = getattr(event, "device_time_total", None)
        if total is None:
            total = event.cuda_time_total
        return total / 1e3 / steps

    busy_ms = union_busy_us(prof) / 1e3 / steps
    summed_ms = sum(device_ms(e) for e in kernels)
    log(f"{cell.name} step profile ({honest_path} honest phase) over "
        f"{steps} steps on {smi}: wall "
        f"{wall_ms:.3f} ms/step, device busy {busy_ms:.3f} ms/step "
        f"({100 * busy_ms / wall_ms:.1f}%; kernel times summed "
        f"{summed_ms:.3f} ms/step), "
        f"{sum(e.count for e in kernels) // steps} device ops/step")
    log("  device clock per phase (ms/step): " + ", ".join(
        f"{name} {ms:.3f}" for name, ms in phase_ms.items()))
    for event in sorted(kernels, key=device_ms, reverse=True)[:12]:
        log(f"  {device_ms(event):9.4f} ms/step {event.count // steps:5d}x  "
            f"{event.key[:90]}")
    return args, engine, state


# Phase 4's kill-and-resume cell: a short headline run with checkpoints
RESUME_CELL = cifar_cell("headline_resume", "bulyan", 5, EMPIRE, 8,
                         ("--evaluation-delta", "2", "--checkpoint-delta", "2",
                          "--auto-resume"))
RESUME_KILL_STEP = 3  # after its second checkpoint (steps 0 and 2)
# A kill-and-resume case: the cell, the step its run is killed at
# (BMT_CHAOS_KILL_AT_STEP) and the step of the checkpoint it restarts from
Resume = collections.namedtuple("Resume", "cell kill_step restart")
RESUME = Resume(RESUME_CELL, RESUME_KILL_STEP, 2)
# The headline fault cell with checkpoints at steps 7 and 14: its run
# killed at the first chunk boundary past step 8 (step 14, before that
# checkpoint) restarts from checkpoint-7, inside the straggler window
# (steps 6-9)
FAULT_RESUME = Resume(cifar_cell(
    "headline_faults_resume", "bulyan", 5, EMPIRE,
    flags=(*plan_flag("headline"), "--checkpoint-delta", "7",
           "--auto-resume")), 8, 7)
# How far a resumed run may lie from an uninterrupted one where the card
# is not deterministic: SPREAD_FACTOR times two uninterrupted runs'
# spread, or SPREAD_FLOOR of the column's largest magnitude, whichever is
# larger. The two differences are draws of the same noise, so their ratio
# scatters widely (up to 8.2 seen); the drift stays within 1e-3 of the
# columns' magnitudes, and a wrong resume (another key, batch or state)
# moves them by far more
SPREAD_FACTOR = 16
SPREAD_FLOOR = 1e-2
# A child run with cuDNN's deterministic algorithms (and PyTorch's,
# where it has them), to hold a resume byte for byte on the card
DETERMINISTIC = ("import sys, torch; "
                 "torch.backends.cudnn.deterministic = True; "
                 "torch.use_deterministic_algorithms(True, warn_only=True); "
                 "from byzantinemomentum_tpu_torch.cli.attack import main; "
                 "sys.exit(main(sys.argv[1:]))")


def _resume_child(resdir, deterministic, extra=None, cell=RESUME_CELL):
    """One child process of `cell` through the driver, started and not
    waited for; its output goes to `<resdir>.out` and `<resdir>.err`
    (files: a child never blocks on a full pipe)."""
    env = {**os.environ, "PYTHONPATH": str(pathlib.Path(__file__).resolve().parent),
           "CUBLAS_WORKSPACE_CONFIG": ":4096:8",
           **{k: str(v) for k, v in (extra or {}).items()}}
    entry = (["-c", DETERMINISTIC] if deterministic
             else ["-m", "byzantinemomentum_tpu_torch"])
    resdir.parent.mkdir(parents=True, exist_ok=True)
    with open(f"{resdir}.out", "w") as out, open(f"{resdir}.err", "w") as err:
        proc = subprocess.Popen(
            [sys.executable, *entry, *cell_argv(cell, cell.steps, str(resdir))],
            env=env, stdout=out, stderr=err)
    proc.logs = resdir
    return proc


def _waited(procs, expected, t0):
    """Wait for each `{label: process}` child (600 s at most), check its
    exit code against `expected[label]`; returns `{label: stdout}`. Kills
    every child still running when one fails."""
    out = {}
    try:
        for label, proc in procs.items():
            proc.wait(timeout=600)
            if proc.returncode != expected[label]:
                stderr = pathlib.Path(f"{proc.logs}.err").read_text()
                raise SystemExit(f"resume run {label} exited {proc.returncode}, "
                                 f"expected {expected[label]}:\n{stderr[-3000:]}")
            log(f"  resume run {label}: done after "
                f"{time.perf_counter() - t0:.1f} s")
            out[label] = pathlib.Path(f"{proc.logs}.out").read_text()
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return out


def resume_runs(tmp, deterministic, side_by_side=False, case=RESUME):
    """`case.cell` through the driver in child processes: twice
    uninterrupted (A, B), then SIGKILLed at step `case.kill_step`
    (`BMT_CHAOS_KILL_AT_STEP`) and `--auto-resume`d with the same command
    line (R); with `side_by_side`, A, B and the killed run at once, then
    the resume, else one after the other. Returns each run's `(eval
    file, study rows without the recovery columns)` and checks the kill,
    the restart from checkpoint-`case.restart` and the `Restarts`
    column."""
    cell, steps, restart = case.cell, case.cell.steps, case.restart
    strip = len(RECOVERY_COLUMNS)
    faults = FAULT_COLUMNS if "--fault-plan" in cell.argv else ()
    header = "# " + "\t".join(STUDY_COLUMNS + faults + RECOVERY_COLUMNS)
    kill = {"BMT_CHAOS_KILL_AT_STEP": case.kill_step}
    t0 = time.perf_counter()
    first = [(name, kill if name == "R" else None) for name in "ABR"]
    labels = {name: f"{name}{' (killed)' if extra else ''}"
              for name, extra in first}

    def child(name, extra=None):
        return _resume_child(tmp / name, deterministic, extra, cell)

    if side_by_side:
        _waited({labels[name]: child(name, extra) for name, extra in first},
                {labels[name]: -9 if extra else 0 for name, extra in first}, t0)
    else:
        for name, extra in first:
            _waited({labels[name]: child(name, extra)},
                    {labels[name]: -9 if extra else 0}, t0)
    found = checkpoint_mod.find_latest_valid(tmp / "R")
    if found is None or found.name != f"checkpoint-{restart}":
        raise SystemExit(f"the killed run left {found} as its newest "
                         f"checkpoint, expected checkpoint-{restart}")
    resumed = _waited({"R": child("R")}, {"R": 0}, t0)
    if f"Auto-resume: restart #1 from checkpoint-{restart}" not in resumed["R"]:
        raise SystemExit(f"the resumed run did not restart from "
                         f"checkpoint-{restart}")
    out = {}
    for name in "ABR":
        study = (tmp / name / "study").read_text().split(os.linesep)
        if study[0] != header:
            raise SystemExit(f"run {name}: study header {study[0]!r}")
        restarts = [row.split("\t")[-1] for row in study[1:]]
        if restarts != (["0"] * restart + ["1"] * (steps - restart)
                        if name == "R" else ["0"] * steps):
            raise SystemExit(f"run {name}: Restarts column {restarts}")
        out[name] = ((tmp / name / "eval").read_text(),
                     [row.rsplit("\t", strip)[0] for row in study[1:]])
    return out


def resume_verdict(runs, label, smi, case=RESUME, exact=False):
    """Byte-equal resumed CSVs where A and B are byte-equal, else R within
    SPREAD_FACTOR times the spread of A and B (or SPREAD_FLOOR of the
    column's largest magnitude) in every study column, NaN positions
    equal; with `exact`, A and B must be byte-equal. Logs which held,
    fails otherwise. Returns whether A and B were byte-equal."""
    (eval_a, rows_a), (eval_b, rows_b), (eval_r, rows_r) = (
        runs[name] for name in "ABR")
    same = eval_a == eval_b and rows_a == rows_b
    log(f"resume check ({label}): two uninterrupted card runs of "
        f"{case.cell.steps} steps are {'byte-equal' if same else 'NOT byte-equal'} "
        f"(eval {eval_a == eval_b}, study {rows_a == rows_b})")
    if same:
        if eval_r != eval_a or rows_r != rows_a:
            raise SystemExit(f"resume check ({label}): the killed and resumed "
                             f"run's CSVs differ from the uninterrupted run's "
                             f"on a deterministic card")
        log(f"resume check ({label}): the killed (step {case.kill_step}) and "
            f"resumed (from checkpoint-{case.restart}) run wrote the "
            f"uninterrupted run's eval file and study rows byte for byte "
            f"(Restarts 0, then 1 from step {case.restart}) on {smi}")
        return True
    if exact:
        raise SystemExit(f"resume check ({label}): the two uninterrupted "
                         f"runs are not byte-equal")

    ratio = spread_verdict(f"resume check ({label})", (rows_a, rows_b),
                           rows_r)
    log(f"resume check ({label}): the resumed run lies within {SPREAD_FACTOR} "
        f"times the spread of two uninterrupted runs or {SPREAD_FLOOR} of the "
        f"column's magnitude in every study column (largest |R - A| over "
        f"the bound {ratio:.3f}) on {smi}")
    return False


# Each study cosine and the norm columns of its two vectors. A cosine is
# compared only in the rows where both norms, in R and in A, lie beyond
# their columns' bounds from zero: a vector the bound cannot tell from
# zero has no direction to hold (the adaptive attacks' rows are (1 - x)
# times the honest mean, and their cosines change sign as the searched x
# crosses 1)
COSINE_NORMS = {
    STUDY_COLUMNS.index(f"{u}-{v.lower()} cosine"): (
        STUDY_COLUMNS.index(f"{u} gradient norm"),
        STUDY_COLUMNS.index(f"{v} gradient norm"))
    for u, v in itertools.combinations(
        ("Sampled", "Honest", "Attack", "Defense"), 2)}


def spread_verdict(label, refs, rows_r, final=True):
    """Study rows R against A = `refs[0]`, two runs that should agree,
    where `refs` are runs of the same thing on a card that is not
    deterministic: NaN positions equal and every column of R within
    SPREAD_FACTOR times the spread (the largest difference between two of
    `refs`) or SPREAD_FLOOR of the column's largest magnitude, the
    cosines where their vectors' norms are beyond that bound from zero
    (`COSINE_NORMS`); logs the spread and returns the largest |R - A|
    over its bound. Where R lies outside, fails if `final`, else returns
    that ratio (above 1) for the caller to draw another reference run."""
    def values(rows):
        return np.array([[float(v) for v in row.split("\t")] for row in rows])

    runs = [values(rows) for rows in refs]
    a, r = runs[0], values(rows_r)
    if not np.array_equal(np.isnan(r), np.isnan(a)):
        raise SystemExit(f"{label}: NaN positions differ")
    kept = np.nonzero(~np.isnan(a).all(axis=0))[0]
    runs = [x[:, kept] for x in runs]
    a, r = runs[0], r[:, kept]
    spread = np.max([np.nanmax(np.abs(x - y), axis=0)
                     for i, x in enumerate(runs) for y in runs[i + 1:]],
                    axis=0)
    bound = np.maximum(SPREAD_FACTOR * spread,
                       SPREAD_FLOOR * np.nanmax(np.abs(a), axis=0))
    diff = np.abs(r - a)
    at = {column: i for i, column in enumerate(kept)}
    masked = 0
    for cosine, norms in COSINE_NORMS.items():
        if cosine in at:
            rows = np.zeros(len(a), dtype=bool)
            for norm in (at[n] for n in norms):
                rows |= (np.minimum(a[:, norm], r[:, norm]) <= bound[norm])
            diff[rows, at[cosine]] = 0.0
            masked += int(rows.sum())
    off = np.nanmax(diff, axis=0)
    log(f"{label}: largest |R - A| a column {off.tolist()}; "
        f"spread of {len(runs)} runs {spread.tolist()}; |R - A| / spread "
        f"{(off / np.where(spread > 0, spread, np.inf)).tolist()}; "
        f"{masked} cosine entries of a vector within its bound of zero")
    ratio = float(np.where(bound > 0, off / np.where(bound > 0, bound, 1),
                           np.where(off > 0, np.inf, 0.0)).max())
    if final and ratio > 1:
        outside = [STUDY_COLUMNS[kept[i]] for i in np.nonzero(off > bound)[0]]
        raise SystemExit(f"{label}: R left {SPREAD_FACTOR} times the spread "
                         f"of {len(runs)} runs (and {SPREAD_FLOOR} of the "
                         f"columns' magnitudes) in {outside}")
    return ratio


def resume_check(smi):
    """Phase 4, kill and resume (`resume_runs`, `resume_verdict`) on the
    driver's default settings, one run after the other; where those runs
    are not byte-equal, once more with deterministic cuDNN algorithms
    (A, B and the killed run side by side: deterministic runs do not
    depend on what else the card runs), which must then hold the resume
    byte for byte (or, if even they are not byte-equal, within the
    spread)."""
    with tempfile.TemporaryDirectory() as tmp:
        deterministic = resume_verdict(
            resume_runs(pathlib.Path(tmp) / "default", False), "default", smi)
        if not deterministic:
            resume_verdict(resume_runs(pathlib.Path(tmp) / "deterministic",
                                       True, side_by_side=True),
                           "cudnn.deterministic", smi)


# The paths whose chunk runs under `set_sync_debug_mode("error")`, each
# with its chunk length: the default 8 steps, brute's one, WRN's two
NO_READ_CELLS = (("headline", M_DEFAULT), ("headline_adaptive", M_DEFAULT),
                 ("krum_f11_strict", M_DEFAULT),
                 ("median_bf16_adaptive", M_DEFAULT),
                 ("cge_anticge", M_DEFAULT),
                 ("headline_mixture", M_DEFAULT),
                 ("headline_mixture_per_call", M_DEFAULT),
                 ("headline_adam", M_DEFAULT), ("headline_diag", M_DEFAULT),
                 ("headline_health", M_DEFAULT),
                 ("headline_faults", M_DEFAULT), ("adaptive_faults", M_DEFAULT),
                 ("krum_f11_faults_diag", M_DEFAULT),
                 ("mnist-alie-warmup-krum", M_DEFAULT),
                 ("default", M_DEFAULT), ("brute", 1), (APPENDIX_BULYAN, 2),
                 ("baseline_wrn_aksel", 2))


def no_host_reads(smi):
    """Phase 4, no host read inside a step: for each path of
    `NO_READ_CELLS`, after a warm-up step, one chunk of
    `Engine.train_multi_indexed` (the index draw, the uploads, the gathers
    and the steps) runs under `torch.cuda.set_sync_debug_mode("error")`,
    so any synchronizing call (`.item()`, a blocking copy, a 0-d index)
    fails the run; the chunk's stacked columns must be `[M]` with a
    finite defense norm."""
    for name, M in NO_READ_CELLS:
        cell = CELLS_BY_NAME[name]
        args, engine, state = setup_cell(cell)
        lrs = np.full(M, args.initial_lr(0), np.float32)
        state, _ = engine.train_multi_indexed(state, *engine.sample_indices(1),
                                              lrs[:1])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        torch.cuda.set_sync_debug_mode("error")
        try:
            state, metrics = engine.train_multi_indexed(
                state, *engine.sample_indices(M), lrs)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        issued = time.perf_counter() - t0
        torch.cuda.synchronize()
        done = time.perf_counter() - t0
        norms = metrics["Defense gradient norm"]
        if norms.shape != (M,) or not bool(torch.isfinite(norms).all()):
            raise SystemExit(f"no_host_reads {name}: defense norms {norms}")
        log(f"no_host_reads {name}: a chunk of {M} steps queued with no "
            f"synchronizing call in {issued * 1e3:.1f} ms of host time, done "
            f"after {done * 1e3:.1f} ms on {smi}")
        del engine, state, metrics
        torch.cuda.empty_cache()


# `fused_vs_single`'s cells, and the train split that keeps every epoch
# boundary out of their 16 steps: 20,000 synthetic CIFAR-10 images are
# 400 batches of 50, 20 headline steps of S = 20 (a chunk that held a
# boundary would draw its flips after the reshuffle, unlike single steps)
FUSED_CELLS = ("headline", "headline_adaptive", "default", "headline_mixture")
# Cells held only under deterministic cuDNN: the mixture's members are
# the headline's kernels, whose default-mode branching the headline holds
DETERMINISTIC_ONLY = ("headline_mixture",)
FUSED_TRAIN = "20000"
# In the default mode the headline's runs part ways after a few steps,
# at M = 1 as at M = 8: cuDNN's unordered sums tip a near-tie in the
# defense's selection one way or the other, and runs on one branch lie
# an order of magnitude closer together than runs on two (the log gives
# each spread). Two M = 1 runs on one branch say nothing of the other,
# so M = 1 runs are drawn, up to FUSED_SINGLE_RUNS, until their spread
# holds the M = 8 run (a run on no branch of theirs stays outside it)
FUSED_SINGLE_RUNS = 8


def fused_run(cell, M):
    """`fused_vs_single`'s run of `cell` at `--steps-per-program` M:
    (steps/s, eval file, study file)."""
    with tempfile.TemporaryDirectory() as tmp:
        summary = driver.run([*cell_argv(cell, STEPS, tmp),
                              "--steps-per-program", str(M)])
        return (summary["steps_per_s"],
                (pathlib.Path(tmp) / "eval").read_text(),
                (pathlib.Path(tmp) / "study").read_text())


def fused_vs_single(smi):
    """Phase 4, `--steps-per-program` 1 against the default 8 inside one
    call, for `FUSED_CELLS` (16 steps each, the evaluation at step 16:
    chunks 0-8 and 8-16), with steps/s of each. Under deterministic cuDNN
    (and PyTorch's deterministic algorithms) the study and eval files of
    M = 1 and M = 8 must be byte-equal; in the default mode the M = 8 run
    must lie within the resume check's bound (`spread_verdict`:
    SPREAD_FACTOR times the spread of the M = 1 runs, or SPREAD_FLOOR of
    the column's magnitude) of the first M = 1 run, the spread taken over
    2 to FUSED_SINGLE_RUNS M = 1 runs, drawn until it holds the M = 8
    run."""
    saved = os.environ.get("BMT_SYNTH_TRAIN")
    os.environ["BMT_SYNTH_TRAIN"] = FUSED_TRAIN
    try:
        for deterministic in (False, True):
            torch.backends.cudnn.deterministic = deterministic
            torch.use_deterministic_algorithms(deterministic, warn_only=True)
            label = "deterministic" if deterministic else "default"
            for name in FUSED_CELLS:
                if name in DETERMINISTIC_ONLY and not deterministic:
                    continue
                cell = CELLS_BY_NAME[name]
                single, fused = fused_run(cell, 1), fused_run(cell, M_DEFAULT)
                same = single[1:] == fused[1:]
                log(f"fused_vs_single {name} ({label}): {STEPS} steps, "
                    f"{single[0]:.4f} steps/s at M = 1, "
                    f"{fused[0]:.4f} at M = {M_DEFAULT}; CSVs "
                    f"{'byte-equal' if same else 'NOT byte-equal'} on {smi}")
                if same:
                    continue
                if deterministic:
                    raise SystemExit(f"fused_vs_single {name}: M = 1 and M = "
                                     f"{M_DEFAULT} wrote other CSVs under "
                                     f"deterministic algorithms")
                refs = [single]
                ratio = math.inf
                while ratio > 1:
                    refs.append(fused_run(cell, 1))
                    ratio = spread_verdict(
                        f"fused_vs_single {name} ({label})",
                        [ref[2].split(os.linesep)[1:] for ref in refs],
                        fused[2].split(os.linesep)[1:],
                        final=len(refs) == FUSED_SINGLE_RUNS)
                distinct = len({ref[1:] for ref in refs})
                log(f"  {name}: M = {M_DEFAULT} within the bound (largest "
                    f"|M8 - M1| over it {ratio:.3f}) of {len(refs)} M = 1 "
                    f"runs, {distinct} of them distinct")
    finally:
        torch.backends.cudnn.deterministic = False
        torch.use_deterministic_algorithms(False)
        if saved is None:
            os.environ.pop("BMT_SYNTH_TRAIN")
        else:
            os.environ["BMT_SYNTH_TRAIN"] = saved


# `--device-gar cpu`'s cells: the driver's defaults (no defense kernel),
# Krum against the stateful `alie-warmup` (its counter hops with the
# rows; the window ends inside the run) and Krum against the default
# `empire` search (16 probes of the GAR a step, on the CPU)
DEVICE_GAR_CELLS = (
    CELLS_BY_NAME["default"],
    attack_cell("mnist-alie-warmup8-krum", "alie-warmup", ("window:8",)),
    attack_cell("mnist-empire-search-krum", "empire", ()),
)


def hop_verdict(label, card, card2, hop):
    """The `--device-gar cpu` run's study file `hop` against two all-card
    runs' (`card`, `card2`): byte-equal, or within the kernels' tolerance
    of `card`, or, where the placement's last-bit differences (the CPU's
    sums) grew past that tolerance over the steps, within the resume
    check's bound (`spread_verdict` against the spread of the two card
    runs, or SPREAD_FLOOR of the column's magnitude). Returns (what held,
    the largest |hop - card|); fails otherwise."""
    if hop == card:
        return "byte-equal to", 0.0
    rows = [text.split(os.linesep)[1:] for text in (card, card2, hop)]
    a, b = (torch.tensor([[float(v) for v in row.split("\t")] for row in r],
                         dtype=torch.float64) for r in (rows[0], rows[2]))
    try:
        return "within tolerance of", compare(f"{label} study", b, a)
    except SystemExit as past:
        ratio = spread_verdict(label, rows[:2], rows[2])
        err = float((b - a).abs().nan_to_num().max())
        return (f"past the kernels' tolerance ({past}) but within the "
                f"resume check's bound (largest over it {ratio:.3f}) of"), err


def device_gar_cell(smi):
    """Phase 4, `--device-gar cpu` on `DEVICE_GAR_CELLS`, 16 steps each:
    the defense (the attack with its line search, the GAR, the influence)
    runs on the CPU (plain versions), the study CSV tracks the all-card
    run's (`hop_verdict`: byte-equal, or within the plain-versus-kernel
    tolerance, or where the drift grew past it, the resume bound), the
    run launches no defense kernel (no GAR kernel, no `linesearch_step`;
    the split launches as before, once a step), forces one step a
    dispatch and counts its hops. The three runs take cuDNN's
    deterministic algorithms (and PyTorch's), so that the card runs agree
    and what differs is the defense's placement."""
    steps = STEPS
    for cell in DEVICE_GAR_CELLS:
        torch.backends.cudnn.deterministic = True
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            with tempfile.TemporaryDirectory() as tmp:
                card = driver.run(cell_argv(cell, steps, f"{tmp}/card"))
                driver.run(cell_argv(cell, steps, f"{tmp}/card2"))
                _cuda.reset_launches()
                hop = driver.run([*cell_argv(cell, steps, f"{tmp}/hop"),
                                  "--device-gar", "cpu"])
                launches = {(kernel, dt): count
                            for kernel, wrapper in WRAPPERS.items()
                            for dt, count in wrapper.launches_by_dtype.items()
                            if count}
                rows = [(pathlib.Path(tmp) / run / "study").read_text()
                        for run in ("card", "card2", "hop")]
        finally:
            torch.backends.cudnn.deterministic = False
            torch.use_deterministic_algorithms(False)
        label = f"device-gar cpu ({cell.name})"
        want = {key: per * steps for key, per in SPLIT_STEP.items()}
        if launches != want:
            raise SystemExit(f"{label}: launches {launches}, expected {want}")
        delta = driver.process_commandline(
            cell_argv(cell, steps, "")).evaluation_delta
        want = {"indexed_steps": steps, "grouped_phases": steps,
                "device_gar_steps": steps,
                "indexed_evals": len(range(0, steps + 1, delta))}
        if hop["counts"] != want:
            raise SystemExit(f"{label}: engine counts {hop['counts']}, "
                             f"expected {want}")
        verdict, err = hop_verdict(label, *rows)
        log(f"{label}, {steps} steps: study CSV {verdict} the "
            f"all-card run's (largest |hop - card| {err:.3e}), launches "
            f"{launches}, {hop['steps_per_s']:.4f} steps/s against "
            f"{card['steps_per_s']:.4f} on the card, counts {hop['counts']}, "
            f"on {smi}")


# `chunk_profile`'s device-busy ms a step, by cell (phase 6 holds the
# headline's attribution to it)
CHUNK_BUSY_MS = {}


def chunk_profile(cell, smi, M=M_DEFAULT, setup=None):
    """Phase 5 at the driver's default M: one warm chunk of `M` steps
    through `Engine.train_multi_indexed` (the index draw included) under
    `torch.profiler`: wall and device-busy ms a step and the busy share.
    `setup` as for `step_profile`."""
    args, engine, state = setup or setup_cell(cell)
    lrs = np.full(M, args.initial_lr(0), np.float32)
    state, _ = engine.train_multi_indexed(state, *engine.sample_indices(M), lrs)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, _ = engine.train_multi_indexed(
            state, *engine.sample_indices(M), lrs)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / M
    busy_ms = union_busy_us(prof) / 1e3 / M
    CHUNK_BUSY_MS[cell.name] = busy_ms
    ops = sum(e.count for e in device_work(prof.key_averages())) // M
    log(f"{cell.name} chunk profile at M = {M} on {smi}: wall {wall_ms:.3f} "
        f"ms/step, device busy {busy_ms:.3f} ms/step "
        f"({100 * busy_ms / wall_ms:.1f}%), {ops} device ops/step")


# Phase 6: the headline with the profiler flags through the driver
ATTRIB_CELL = cifar_cell("headline_attribution", "bulyan", 5, EMPIRE,
                         flags=("--attribution", "--telemetry-mfu"))
# MFU of an f32 step against the bf16 peak stays below the f32 rate over
# it: 67 / 989.4 TFLOP/s on the SXM part
MFU_CEILING = 0.068
# The grid runner's line: `reproduce.py::submit_mnist`'s Krum run at
# n = 51, cut to GRID_STEPS steps with a checkpoint every 5; the first
# attempt of the run named `killed` dies at GRID_KILL
GRID_LINE = "mnist-empire-krum-f_24-lr_0.5-at_update"
GRID_STEPS, GRID_KILL = 20, 12
GRID_CHILD = "\n".join((
    "import os, pathlib, sys",
    "os.environ['CUBLAS_WORKSPACE_CONFIG'] = ':4096:8'",
    "import torch",
    "torch.backends.cudnn.deterministic = True",
    "torch.use_deterministic_algorithms(True, warn_only=True)",
    "d = pathlib.Path(sys.argv[sys.argv.index('--result-directory') + 1])",
    "fuse = d.parent / 'fuse'",
    "if d.name.startswith('killed') and not fuse.exists():",
    "    fuse.write_text('blown')",
    f"    os.environ['BMT_CHAOS_KILL_AT_STEP'] = '{GRID_KILL}'",
    "from byzantinemomentum_tpu_torch.cli.attack import main",
    "sys.exit(main(sys.argv[1:]))"))


def attribution_check(smi):
    """Phase 6, the headline with `--attribution --telemetry-mfu` in this
    process: the traced chunk's attribution against the launch counters
    (snapshotted as the driver opens and closes the window), the thread
    join of the backward kernels, phase 5's busy time, the gauge, MFU."""
    wrappers = {"sq_gram": (gar_kernels.sq_gram, "gram_tiled_kernel"),
                "selected_median_mean": (gar_kernels.selected_median_mean,
                                         "selected_median_mean_kernel")}
    marks = []
    start, stop = driver._start_profiler, driver._stop_profiler

    def marked(fn):
        def call(*args):
            marks.append({name: wrapper.launches
                          for name, (wrapper, _) in wrappers.items()})
            return fn(*args)
        return call

    driver._start_profiler, driver._stop_profiler = marked(start), marked(stop)
    try:
        with tempfile.TemporaryDirectory() as tmp:
            resdir = pathlib.Path(tmp)
            summary, _ = _quiet_run(cell_argv(ATTRIB_CELL, STEPS, tmp))
            att = obs.attrib.load_attribution(resdir)
            trace = obs.attrib.kineto.load_trace(resdir / "attribution-trace")
            records = obs.load_records(resdir)
    finally:
        driver._start_profiler, driver._stop_profiler = start, stop
    name = ATTRIB_CELL.name
    if att is None or att["steps"] != M_DEFAULT or len(marks) != 2:
        raise SystemExit(f"{name}: no attribution of one {M_DEFAULT}-step "
                         f"chunk ({att and att['steps']}, {len(marks)} "
                         f"profiler calls)")
    phase_sum = sum(p["ms"] for p in att["phases"].values())
    if abs(phase_sum - att["total_ms"]) > 1e-9 * att["total_ms"]:
        raise SystemExit(f"{name}: phases {phase_sum} do not tile "
                         f"{att['total_ms']}")
    events = obs.attrib.kineto.op_events(trace)
    raw = [e for e in trace["traceEvents"] if e.get("ph") == "X"]
    device = sorted((e for e in raw if e.get("cat") in
                     ("kernel", "gpu_memcpy", "gpu_memset")),
                    key=lambda e: e["ts"])
    launch_tid = {(e.get("args") or {}).get("correlation"): e.get("tid")
                  for e in raw if e.get("cat") in ("cuda_runtime",
                                                   "cuda_driver")}
    dispatching = {e.get("tid") for e in raw
                   if e.get("cat") == "user_annotation"
                   and e.get("name") == "honest"}
    # The kernels the autograd engine's device thread launched: the
    # backward, outside every range of that thread
    backward = [event for event, e in zip(events, device)
                if launch_tid.get((e.get("args") or {}).get("correlation"),
                                  next(iter(dispatching))) not in dispatching]
    convs = [e for e in backward if obs.attrib.op_class_of(e.name) == "mxu"]
    stray = {obs.attrib.phase_of(e.scope) for e in backward} - {"honest"}
    if not convs or stray:
        raise SystemExit(f"{name}: {len(backward)} kernels launched off the "
                         f"dispatching thread, {len(convs)} GEMM/convolution "
                         f"ones, phases outside honest {stray}")
    delta = {kernel: marks[1][kernel] - marks[0][kernel] for kernel in wrappers}
    found = {}
    for kernel, (_, device_name) in wrappers.items():
        hits = [e for e in events if device_name in e.name]
        where = {obs.attrib.phase_of(e.scope) for e in hits}
        found[kernel] = len(hits)
        if len(hits) != delta[kernel] or not hits or where != {"gar"}:
            raise SystemExit(f"{name}: {len(hits)} {device_name} events in "
                             f"phases {where}, the launch counter moved "
                             f"{delta[kernel]} over the window")
    busy = CHUNK_BUSY_MS["headline"]
    if abs(att["device_ms"] - busy) > 0.10 * busy:
        raise SystemExit(f"{name}: device_ms {att['device_ms']:.3f} against "
                         f"the headline's chunk-profile busy {busy:.3f}")
    gauges = [r["value"] for r in records if r["kind"] == "gauge"
              and r["name"] == "device_step_ms"
              and (r.get("data") or {}).get("step") == STEPS]
    if not gauges or abs(phase_sum - gauges[-1]) > 0.15 * gauges[-1]:
        raise SystemExit(f"{name}: phase sum {phase_sum:.3f} ms against the "
                         f"traced chunk's device_step_ms {gauges}")
    mfus = [r["value"] for r in records if r["kind"] == "gauge"
            and r["name"] == "mfu"]
    flops = [r["data"]["flops"] for r in records
             if r["name"] == "flops_per_step"]
    if not mfus or not all(0.0 < v <= MFU_CEILING for v in mfus) or not flops:
        raise SystemExit(f"{name}: mfu gauges {mfus}, flops {flops}")
    RATES[name] = summary["steps_per_s"]
    log(f"{name}: {att['total_ms']:.3f} ms a step over the traced chunk, "
        f"device {att['device_ms']:.3f} (chunk profile's busy {busy:.3f}), "
        f"host gap {att['host_gap_fraction']:.1%}, gauge {gauges[-1]:.3f}; "
        f"phases (ms/step) " + ", ".join(
            f"{k} {v['ms']:.3f} ({v['ops']} events)"
            for k, v in att["phases"].items() if v["ms"] > 0.0)
        + "; op classes " + ", ".join(f"{k} {v:.3f}" for k, v
                                      in att["op_classes"].items())
        + f"; {len(backward)} kernels from the autograd device thread in "
        f"honest ({len(convs)} GEMM/convolution); gar: {found} as the "
        f"counters moved; flops a step {flops[0]:.6e}, mfu {mfus}; "
        f"{summary['steps_per_s']:.4f} steps/s against the flag-free "
        f"headline's {RATES['headline']:.4f} on {smi}")


def grid_children(tmp):
    """Phase 6's child processes, started side by side: `python -m
    byzantinemomentum_tpu_torch.obs --selfcheck` on the card, the SIGUSR1
    run (`GRID_LINE`, unbounded in practice) and the port's `Jobs` over the
    killed and the uninterrupted `GRID_LINE` cut to GRID_STEPS steps (its
    worker threads started; `grid_verdict` waits for them)."""
    from byzantinemomentum_tpu_torch import reproduce
    from byzantinemomentum_tpu_torch.utils.jobs import Jobs

    class Lines:
        def __init__(self):
            self.submitted = {}

        def submit(self, name, command):
            self.submitted[name] = command

    lines = Lines()
    reproduce.submit_mnist(lines)
    line = lines.submitted[GRID_LINE][3:]  # less the launcher
    env = {**os.environ, "PYTHONPATH": str(pathlib.Path(__file__).resolve()
                                           .parent)}
    tmp.mkdir(parents=True, exist_ok=True)
    procs = {}
    with open(tmp / "selfcheck.out", "w") as out:
        procs["selfcheck"] = subprocess.Popen(
            [sys.executable, "-m", "byzantinemomentum_tpu_torch.obs",
             "--selfcheck"], env=env, stdout=out, stderr=subprocess.STDOUT)
    live = tmp / "live"
    with open(f"{live}.out", "w") as out:
        procs["sigusr1"] = subprocess.Popen(
            [sys.executable, "-m", "byzantinemomentum_tpu_torch", *line,
             "--device", "cuda", "--seed", "1", "--nb-steps", "100000",
             "--result-directory", str(live)],
            env=env, stdout=out, stderr=subprocess.STDOUT)
    command = [sys.executable, "-c", GRID_CHILD, *line,
               "--nb-steps", str(GRID_STEPS), "--checkpoint-delta", "5"]
    jobs = Jobs(tmp / "grid", devices=("cuda",), supercharge=2, seeds=(1,),
                max_retries=1, retry_backoff=0)
    jobs.submit("killed", command)
    jobs.submit("uninterrupted", command)
    jobs.start()
    procs["grid"] = jobs
    return procs


def sigusr1_verdict(tmp, proc, smi):
    """The SIGUSR1 child: SIGUSR1 after its first heartbeat, SIGTERM once
    the window is attributed; exit 130, `profile-<step>/` attributed over
    one chunk (5 steps: the line evaluates every 5) with `honest` and
    `gar` time, `run_end` `interrupted`."""
    live = tmp / "live"
    deadline = time.monotonic() + 300
    signalled = False
    while time.monotonic() < deadline and proc.poll() is None:
        if not signalled and obs.read_heartbeat(live) is not None:
            proc.send_signal(signal.SIGUSR1)
            signalled = True
        if signalled and _records(live, "attribution"):
            break
        time.sleep(0.2)
    if proc.poll() is not None or not signalled:
        raise SystemExit(f"SIGUSR1 run: no window before it ended "
                         f"(rc {proc.poll()}):\n"
                         + pathlib.Path(f"{live}.out").read_text()[-3000:])
    proc.send_signal(signal.SIGTERM)
    proc.wait(timeout=120)
    windows = sorted(live.glob("profile-*"))
    window = _records(live, "profiler_window")
    end = _records(live, "run_end")
    att = obs.attrib.load_attribution(windows[0]) if windows else None
    if (proc.returncode != 130 or len(windows) != 1 or att is None
            or att["steps"] != 5 or att["phases"]["honest"]["ms"] <= 0
            or att["phases"]["gar"]["ms"] <= 0 or not window
            or window[0]["to_step"] - window[0]["from_step"] != 5
            or not end or end[-1]["status"] != "interrupted"):
        raise SystemExit(f"SIGUSR1 run: rc {proc.returncode}, windows "
                         f"{windows}, window {window}, run_end {end}, "
                         f"attribution {att and att['phases']}")
    log(f"SIGUSR1 -> SIGTERM run: window {windows[0].name} (steps "
        f"{window[0]['from_step']}-{window[0]['to_step']}) attributed, "
        f"{att['total_ms']:.3f} ms a step (honest "
        f"{att['phases']['honest']['ms']:.3f}, gar "
        f"{att['phases']['gar']['ms']:.3f}); exit 130, run_end "
        f"'interrupted' at step {end[-1]['step']} on {smi}")


def grid_verdict(tmp, procs, smi):
    """The grid runner's runs, waited for: both done; the killed run's
    first attempt died at GRID_KILL and the retry resumed from
    checkpoint-10; its study CSV byte-equal to the uninterrupted run's
    but for the `Restarts` column, its eval CSV byte-equal."""
    procs["grid"].wait()
    grid = tmp / "grid"
    killed, ref = grid / "killed-1", grid / "uninterrupted-1"
    if not killed.is_dir() or not ref.is_dir() or not (grid / "fuse").exists():
        raise SystemExit(f"grid runner: {sorted(p.name for p in grid.iterdir())}")

    def rows(path):
        return [line.rsplit("\t", 1)[0] for line in
                path.read_text().split(os.linesep)[1:]]

    log_text = (killed / "stdout.log").read_text()
    restarts = [line.rsplit("\t", 1)[1] for line in
                (killed / "study").read_text().split(os.linesep)[1:]]
    if ("restart #1 from checkpoint-10" not in log_text
            or rows(killed / "study") != rows(ref / "study")
            or len(restarts) != GRID_STEPS
            or (killed / "eval").read_text() != (ref / "eval").read_text()):
        raise SystemExit(f"grid runner: the resumed {GRID_LINE} differs from "
                         f"the uninterrupted run (Restarts {restarts})")
    log(f"grid runner: {GRID_LINE} at {GRID_STEPS} steps through Jobs, the "
        f"first attempt killed at step {GRID_KILL}, resumed from "
        f"checkpoint-10: study and eval byte-equal to the uninterrupted "
        f"run's but for Restarts ({restarts[0]} .. {restarts[-1]}) under "
        f"deterministic cuDNN on {smi}")


def selfcheck_verdict(tmp, proc, smi):
    """The `python -m byzantinemomentum_tpu_torch.obs --selfcheck` child,
    on the card: rc 0, its `attribution:` line from a CUDA trace."""
    rc = proc.wait(timeout=300)
    out = (tmp / "selfcheck.out").read_text()
    lines = [line for line in out.splitlines()
             if line.startswith("attribution: ")]
    if rc != 0 or len(lines) != 1 or "obs selfcheck: OK" not in out:
        raise SystemExit(f"obs --selfcheck: rc {rc}:\n{out[-3000:]}")
    data = json.loads(lines[0][len("attribution: "):])
    if data["backend"] != "cuda":
        raise SystemExit(f"obs --selfcheck ran on {data['backend']}")
    log(f"obs --selfcheck on the card: {lines[0]} on {smi}")


def grid_children_end(procs):
    """Every child of `grid_children` ended: the unbounded ones killed,
    the runner's waited for (its runs end by themselves)."""
    for name in ("sigusr1", "selfcheck"):
        if procs[name].poll() is None:
            procs[name].kill()
            procs[name].wait()
    procs["grid"].wait()


def grid_children_verdict(tmp, procs, smi):
    """`grid_children`'s runs, each held by its verdict; every child
    ended whatever fails."""
    try:
        sigusr1_verdict(tmp, procs["sigusr1"], smi)
        selfcheck_verdict(tmp, procs["selfcheck"], smi)
        grid_verdict(tmp, procs, smi)
    finally:
        grid_children_end(procs)


def main():
    os.environ.setdefault("BMT_SYNTH_TRAIN", "5000")
    os.environ.setdefault("BMT_SYNTH_TEST", "500")
    t0 = time.perf_counter()
    phases = {}

    def lap(name):
        phases[name] = time.perf_counter() - t0 - sum(phases.values())
        log(f"phase {name}: {phases[name]:.1f} s")

    smi = environment()
    write_fault_plans()
    build()
    lap("build")
    records = (key_tree_kernels(smi) + search_kernel(smi)
               + mixture_kernels_check(smi) + kernels_vs_plain(smi)
               + mnist_kernels(smi))
    lap("kernels")
    diag_kernels(smi)
    lap("diag kernels")
    records += wrn_kernels(smi)
    lap("WRN kernels")
    records += zoo_kernels(smi)
    lap("zoo kernels")
    zoo_gradients(smi)
    lap("zoo gradients")
    device_paths(smi)
    grouped_vs_vmapped(CELLS_BY_NAME[APPENDIX_BULYAN], smi, timed=True)
    grouped_vs_vmapped(CELLS_BY_NAME[
        "cifar10-little-median-f_4-lr_pow-at_worker-nesterov"], smi,
        worker_momentum=True, timed=True)
    lap("device paths")
    totals = collections.Counter()
    for cell in CELLS:
        if cell.family == "wrn" and "cells" not in phases:
            lap("cells")  # the WRN cells come last, each timed
        for (kernel, dtype), count in drive(cell, smi).items():
            totals[kernel, dtype, cell.family] += count
        if cell.family == "wrn" or cell.family in ZOO:
            lap(cell.name)
    for cell in DIAG_CELLS:
        for (kernel, dtype), count in drive(cell, smi).items():
            totals[kernel, dtype, cell.family] += count
    diag_vs_plain(smi)
    lap("diag cells")
    fault_cells(smi, totals)
    lap("fault cells")
    with tempfile.TemporaryDirectory() as grid_tmp:
        health_cells(smi, totals, pathlib.Path(grid_tmp))
    lap("health cells")
    resume_check(smi)
    lap("resume")
    no_host_reads(smi)
    lap("no host reads")
    fused_vs_single(smi)
    lap("fused vs single")
    device_gar_cell(smi)
    lap("device-gar")
    for cell in (*CELLS, *DIAG_CELLS, *FAULT_CELLS):
        if cell.name in PROFILED:
            # WRN's step is 18k device operations, the per-call mixture's
            # 5k and the zoo's up to 13k: one step each keeps their
            # traces' processing short
            setup = step_profile(cell, smi, steps=1 if cell.name
                                 in STEP_PROFILED_ONLY else 3)
            # and at the driver's default M, on the same engine
            if cell.name not in STEP_PROFILED_ONLY:
                chunk_profile(cell, smi, setup=setup)
            del setup
            torch.cuda.empty_cache()
            lap(f"profile {cell.name}")
    attribution_check(smi)
    lap("attribution")
    for record in records:
        record["launches"] = totals[split_record_name(record["name"])]
    log(f"seconds by phase: " + ", ".join(
        f"{name} {seconds:.1f}" for name, seconds in phases.items())
        + f"; {time.perf_counter() - t0:.1f} in all")

    shutil.rmtree(FAULT_PLAN_DIR, ignore_errors=True)
    print(json.dumps({"kernels": records}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
