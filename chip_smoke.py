#!/usr/bin/env python3
"""Drive the PyTorch port's flagship text-to-motion sampling, training and
evaluation, its music-to-dance and speech-to-gesture long-form
evaluations, its baselines, ControlNet training, baseline training,
bf16 / remat / optax-default-optimizer training, data-parallel training
and evaluation (2 processes), the model across ranks (the expert- and
tensor-parallel flagship, mesh serving; 2 processes), pipeline
parallelism (2 stages) and the baselines in bf16 and int8 on one NVIDIA
GPU, and hold each of its CUDA kernels against its plain PyTorch version.

Run from the root of the repository, on a machine with one card and the CUDA
toolkit:

    python3 chip_smoke.py

Phases; any failure exits non-zero:
  1. the card's name and power limit; build the kernels from
     motioncraft_tpu_torch/csrc/ with nvcc for sm_90a
  2. each kernel against its plain version on the same inputs, at every
     shape of phase 4 (K1-K4's route; K1 and K4 also at layer 0, whose
     motion MoE routes one CFG half), of phase 7 (K4's positions, K5, K6,
     at B = 32), of phase 10 (K1-K4 at the M2D shapes: a CFG-doubled
     batch of 2 x 120 frames for one recording and 8 x 120 for 4 in
     lockstep, and layer 0's half of each) and of phase 11 (the same at the
     S2G shapes, 2 x 64 and 8 x 64), K1-K3's bf16 instantiations at the
     T2M shapes (K1 motion, text and layer 0), and K1-K4 in f32 and K1-K3
     in bf16 at phase 12's smallest and largest buckets (2 x 64 and 16 x
     196, with layer 0's half of each) and at phase 14's drift batch (64 x
     196, with its layer 0's half), K1-K4 at phase 25's flagship visualizer
     call (8 x 196, with its layer 0's half), K4's positions, K5 and K6 at phase 14's
     training batches (16: --grad-accum 2 of 32; 8: the calibration
     checkpoint's), and K5 at phase 15's inference shapes (B = 16:
     MotionDiffuse's self-attention over 196 frames masked past varied
     lengths and its cross-attention over 77 text keys, 8 heads of 64; MCM's
     channel self-attention, 512 tokens over 4 heads of 49, which the
     wrapper pads to 64, and its cross-attention, 4 heads of 128; the pad's
     bytes and device time stand beside that case as pad_bytes and pad_ms,
     and its bound is the function's own bytes at d = 49; MCM also at
     phase 25's one prompt, B = 1), and K1, K2 and
     K4's route at phase 16's FineMoGen shapes (B = 16, 64-wide heads, for
     finemogen_t2m_smplx's 12 heads and finemogen_t2m's 8: K1 on the
     motion MoE at D = 64, F = 256 and on the text MoE at D = 256, K2 at
     d = 64, F = 512, K4's route over the motion, a skewed and the text
     MoE's logits), and K5 at phase 17's shapes (the MCM ControlNet at R =
     1 and 2 rows, no CFG: the channel self-attention [R, 512, 4, 49],
     padded to 64 as phase 15's, and the cross-attention [R, 196, 8, 64]
     over 77 keys; ReMoDiffuse at B = 16: its retrieval encoder's
     self-attention [32, 196, 8, 64] masked past the retrieved lengths, the
     semantics-modulated attention of the 64 CFG rows [64, 196, 8, 64] over
     77 + 98 + 196 = 371 keys masked by cond_type 99 / 1 / 10 / 0, -2e6
     where a retrieved frame is padded and the retrieval off, and
     MoMatMoGen's dual one over 567 keys), and K4's positions, K5 and K6 at
     phase 18's training microbatches (the flagship's 128, the S2G
     ControlNet's 96 and the M2D one's 84, T = 196; a control block has its
     base's shapes), and phase 19's training batches (K5 at MotionDiffuse's
     64 [64, 196, 8, 64] over 196 masked and 77 text keys, at MCM's 256 its
     channel self-attention [256, 512, 4, 49], padded to 64 as phase 15's,
     and its cross-attention [256, 196, 4, 128], at the MCM ControlNet's 128
     [128, 512, 4, 49] and [128, 196, 8, 64]; K6 on FineMoGen's motion
     slots at its 128, D = 64, F = 256: its K4 positions and text slots
     are phase 18's flagship cases at 128), and K6's bf16 instantiation
     (phase 20's bf16 training) on the flagship's text slots at B = 32 and
     128 and on FineMoGen's D = 64 motion slots at 128, and K6's f16
     instantiation (phase 20's float16 training) on the flagship's text
     slots at B = 32 and 128 (tolerance one f16 ulp of the largest output,
     2^-10 x max |plain|), and phase 21's
     ranks (K5 over a rank's 64 rows of the flagship, whose K4 positions
     and K6 slots are those of the global 128; the S2G ControlNet's base at
     2 x 8 windows of 64 frames: K4's positions over the 16, K5 over a
     rank's 8, K6 on the slots of the 16), and phase 22's (K6 on the local
     experts [8, C, D] and on hidden slices at F / 2 in training at 32; in
     sampling K6 on the local experts at the eval capacity of a dispatch
     of 2 requests, K1 at F / 2 and K2 at f / 2 [4 x 196, 1536] x [12,
     128, 256], b2 zeros; K4's route over a 2-rank serving dispatch of 4),
     each with the launches of its phase-22 run, and phase 23's (a pipeline
     stage's K4 positions, K5 and K6 at a training microbatch of
     MP_BATCH / PP_MICROBATCHES = 16 rows, K1-K4 at a sampling microbatch
     of 2 CFG rows), each with the launches of its phase-23 run, and K5's
     bf16 instantiation at phase 24's shapes (MotionDiffuse's and MCM's
     self- and cross-attention at B = 16 on bf16 operands, MCM's channel
     attention padded to 64; the MCM ControlNet's first channel
     self-attention at R = 1 and 2), beside phase 24's mixed-dtype calls
     through the f32 instantiation (the MCM ControlNet's cross-attention:
     f32 queries, bf16 text keys and values; ReMoDiffuse's
     semantics-modulated attention: bf16 queries, f32 keys and values): max abs error against its
     tolerance (1e-2 x max |plain| for bf16; K4 exact in its
     integers, its route's gates within 1e-6; on every path a route case
     leaning to one expert must drop choices); the kernel's device time from
     torch.profiler
     (ms: its kernels' own durations, which a back-to-back timing of a
     kernel of a few microseconds does not give, the host issuing the calls
     slower than the card runs them), and from CUDA events the time of a
     back-to-back call (call_ms) and of the plain version;
     the least time the card could take (bound_ms: f32 products in 3xTF32
     on the tensor cores, which K1-K3, K5 and K6 run, bf16 products at the
     dense bf16 rate; K4's work on the CUDA
     cores; K1's work is the rows that carry a choice, not the padding of
     each expert's group), and for f32 work the f32 bound on the CUDA cores
     as a second note (bound_f32_ms); how many of K3's clusters fit on the card at once
  3. the flagship MotionDiffusion (configs/stmogen/t2m_motionx_0_125b.py) on
     the card, with seeded fabricated weights
  4. two batches of 16 requests (T = 196, varied lengths) through
     single_device_test: DDIM-50 with CFG 6.5; finite [16, 196, 322] outputs
  5. per-batch wall time, and each kernel's launches, which must equal the
     count that 50 steps x 4 layers imply (each MoE routes in one
     moe_route launch; no positions-only launch)
  6. one flagship forward_test on the card against the same weights and
     inputs on the CPU (plain versions), B = 2, the CPU's MoE gates fed the
     card's gate logits so that a near-tie cannot route a token differently
  7. train_model on the same flagship (Adam lr 2e-4, the config's recipe):
     1 warm-up + 3 steps of B = 32 seeded synthetic batches (T = 196,
     lengths 40-196); finite losses, every trainable parameter moved, CLIP
     unchanged bit for bit; per-step wall ms, max memory allocated, and the
     launches per step (K5 = 4, K6 = K4's positions = 8, K1-K3 and K4's
     route none)
  8. one flagship training loss and every parameter's gradient on the card
     against the CPU, B = 2, gate noise 0, the CPU's gate logits pinned to
     the card's as in phase 6
  9. the T2M protocol evaluation through tools/torch_test.py on the same
     flagship config: a synthetic Motion-X tree of EVAL_CLIPS (32) clips (196 x 322,
     written here in tools/make_tiny_data.py's layout), phase 3's weights
     saved with save_params and loaded back by --checkpoint, a full-width
     SMPL-X evaluator (DistilBERT 6 x 768, ActorAgnostic 4 x 256) saved as
     its .npz; one replication at batch 16: DDIM-50 CFG through K1-K4, the
     evaluator on the card, R-Precision / Matching / FID / Diversity (on
     half the clips).  The loaded model's forward equals the in-memory one's
     bit for bit, every metric is finite, K1-K4's launches are what 50 steps
     x 4 layers x the batches imply, GT mode on the same tree gives FID <= 1e-3, and the
     evaluator's embeddings on the card agree with the CPU's; wall seconds of
     sampling and of evaluation, samples per second
 10. the M2D long-form evaluation through tools/torch_m2d_test.py on
     configs/stmogen/m2d_finedance_0125b.py (the ControlNet over the
     flagship base, 2 control blocks, 163-d music): seeded fabricated
     weights saved and loaded back by --checkpoint, a synthetic FineDance
     tree of 4 cross-genre test tracks of 360 + 300 frames (3 windows of
     120 overlapping by 30 after the head trim), sampled at R = 1 and at
     --recording-batch 4: window 0 DDIM-50, each later window RePaint's
     harmonized DDIM (84 steps, 57 denoiser calls); per-window wall ms,
     windows per minute, the sampling share; K1-K4's launches equal the
     count the code implies; metrics.json carries tools/m2d_test.py's keys;
     windowed_sample_batch at R = 1 equals windowed_sample bit for bit on
     the card with the same draws, and neither waits for the device inside
     its window loop (CUDA sync debug mode; both on PARITY_RESPACE's
     schedule); one ControlNet CFG forward
     (c on, 2 x 120) and one whole outpainted window at R = 2 (two
     recordings in lockstep, the condition encoded once for the batch, as
     windowed_sample_batch encodes a chunk's), card against CPU with the
     gate logits pinned as in phase 6 and the same draws, the window on
     PARITY_RESPACE's DDIM-10 schedule
 11. the S2G long-form evaluation through tools/torch_s2g_test.py on
     configs/stmogen/s2g_beats2_0125b.py (the same ControlNet over the
     flagship base, its condition raw onset + amplitude at 16 kHz through
     the WavEncoder, out_dim 1536): seeded fabricated weights with sane
     BatchNorm statistics saved and loaded back by --checkpoint, a
     synthetic BEAT2 tree of 4 test recordings of 124 frames (2 windows of
     64 overlapping by 4) with onsets that fire, TextGrid words and a
     mean-velocity file, and an SMPL-X npz at the real sizes written here;
     sampled at R = 1 and at --recording-batch 4: per-window wall ms,
     windows per minute, the sampling share; K1-K4's launches equal the
     count the code implies, and the WavEncoder runs once a window (R = 1)
     or once a chunk (R = 4), never a denoiser step; metrics.json carries
     tools/s2g_test.py's keys with LBS joints and face vertices; the
     encoder's device time on one window against its f32 bound; the
     samplers at R = 1 agree and wait for the device only for their result
     (CUDA sync debug mode, PARITY_RESPACE's schedule); the WavEncoder, one
     ControlNet CFG forward and
     one whole outpainted window (PARITY_RESPACE's schedule) card against
     CPU with the gate logits pinned; then the same ControlNet with the
     wav2vec pre-encoder (condition_pre_encode_type='wav2vec', the
     base-960h Wav2Vec2 at its full width: 7 convolutions of 512, 12 layers
     of 768) on seeded fabricated weights: the conditioner's device time on
     one window; the conditioner, one ControlNet CFG forward and one
     outpainted window card against CPU as above; one window sampled on the
     card (the config's DDIM-50), its wall ms
 12. serving through MotionGenServer on the same flagship with phase 3's
     weights: one server in f32 and one in bf16 (the weights cast, the
     denoiser in bf16 through K1-K3's bf16 instantiations), each with batch
     buckets 1, 2, 4, 8 and sequence buckets 64, 128, 196, warmed up on
     the batch buckets its traffic fills (SERVE_WARM) at every sequence
     bucket; 4 client threads send 2 seeded requests each (one
     at a time, lengths 40-196) beside 2 long-form requests of 400 frames:
     every result finite and of its length, dispatches and occupancy
     consistent with stats(), K1-K4's launches what the dispatches imply
     (the bf16 server only the bf16 K1-K3, the f32 one only the f32 ones);
     latency p50/p95, requests per second, mean occupancy and padding
     fraction per dtype; one bf16 forward_test card vs CPU with the gate
     logits pinned (within 5e-2 x scale), and bf16 vs f32 on the card with
     the expert choices that differ (reported)
 13. the step cache and int8 inference on phase 3's flagship: two batches of
     16 through single_device_test uncached, with all-compute flags (equal
     to uncached bit for bit), at reuse_every=2 and with the committed
     table (artifacts/step_cache_flagship.json): K1-K4's launches what the
     flags imply, wall ms a batch, no device wait in a cached sampling call
     (CUDA sync debug mode); tools/torch_test.py with --bf16 --int8 (W8A8)
     and --bf16 --int8 w8 on a synthetic tree of 16 clips: finite metrics
     and the stamped flags, K1/K2 launched no time under W8A8, the int8
     products (int_mm, torch._int_mm) that the model implies, int8 weight
     bytes against f32, ms a batch; one W8A8 and one W8 forward_test card
     vs CPU with the gate logits pinned (W8A8 held to limits read in the
     same run from the card's own output with its input one ulp apart, the
     activation codes that differ counted, the float forward shown to
     break those limits); every int8 product shape of that run, and m = 1 and 2,
     exactly equal to the int32 product, with its device ms and bound (one
     JSON line); one M2D track of three windows at --step-cache 2 through
     tools/torch_m2d_test.py (windows 1 and 2 are the harmonized loop: its
     first step after each re-noising jump computes), launches checked; a W8A8
     MotionGenServer, warmed up on the batch bucket its traffic fills first
     (LOWPREC_SERVE_WARM), on phase 12's traffic, latency p50/p95
 14. the trained-weights quality harness over a learnable tree of 256
     clips (tools/make_tiny_data.py --protocol-learnable, written here) with
     configs/tests/protocol_learn.py's flagship: the evaluator trainer
     (tools/torch_train_protocol_evaluator.py, 1000 steps, held-out top-1
     >= 0.5); tools/torch_train.py at --grad-accum 2 for 2 epochs, then
     --resume for a third (the resume line, finite losses, params.npz
     loading strictly and equal to the trained weights, K4's positions, K5
     and K6 launched as the steps imply and nothing else); the calibration
     checkpoint (tools/torch_make_calib_ckpt.py, 8 steps); the drift of
     every approximate mode on it (tools/torch_measure_approx_drift.py,
     exact, step cache 2, the committed table, W8, W8A8, all bf16, 64
     clips): finite metrics and deltas, a sample error above 0 in every
     approximate mode, K1-K4 launched as the flags imply, and a second run
     that reuses every mode; wall seconds of each step
 15. the baselines on the card, with seeded fabricated weights:
     configs/motiondiffuse/motiondiffuse_t2m_smplx.py,
     configs/mcm/mcm_t2m_smplx.py and configs/mdm/mdm_t2m_smplx.py at full
     width; K5 under torch.no_grad keeps no autograd graph; for each, one
     batch of 16 requests (T = 196, lengths 40-196) through
     single_device_test with its DDPM respaced to 100 steps
     (BASELINE_DDPM_RESPACE): finite [16, 196, 322] outputs, K5's launches
     100 x 8 layers x 2 for
     MotionDiffuse and MCM and 0 for MDM (nothing else launched), the
     batch's wall ms; one denoiser call profiled (device kernels launched,
     device ms, idle share); one forward_test card vs CPU at B = 2; the
     weights saved with save_params and loaded back by --checkpoint's
     loader, whose forward equals the in-memory one bit for bit; then
     configs/mcm/mcm_t2m.py's DDIM-50 on one batch of 16 with the same
     launch check; then tools/torch_test.py on MotionDiffuse over a
     synthetic Motion-X tree of 16 clips at batch 16 (one replication, a
     full-width SMPL-X evaluator, R-Precision and Matching over the 16,
     Diversity on 8): finite metrics, K5's launches what 100 steps x 16
     imply, wall seconds of
     sampling and of evaluation
 16. FineMoGen (SAMI) on the card, with seeded fabricated weights:
     configs/finemogen/finemogen_t2m_smplx.py at full width (4 layers, 12
     heads x 64, 16 experts top-2, CLIP); one batch of 16 requests (T =
     196, lengths 40-196) through single_device_test with DDIM-50 CFG:
     finite [16, 196, 322] outputs, K1 and K4's route launched 2 x 4 a
     denoiser call (each SAMI layer's text and motion MoE: nothing is
     hoisted), K2 4, nothing else, the batch's wall ms; one denoiser call
     profiled (device kernels, device ms, idle share); one forward_test
     card vs CPU at B = 2 with the gate logits pinned as in phase 6; then
     tools/torch_test.py on configs/finemogen/finemogen_t2m.py over a
     synthetic HumanML3D tree of 64 clips (263-d, captions with their
     tokens) at batch 16: the five T2M metrics through the full-width BiGRU
     evaluator (seeded, hashed word vectors; MultiModality on 8 x 2 more
     samples), finite, K1, K2 and K4's launches what 5 batches x 50 steps
     imply; the evaluator's motion and text embeddings card vs CPU; GT mode
     on the same tree, and on configs/finemogen/finemogen_kit.py over a
     251-d KIT-ML tree of 64 clips (its evaluator reads 247 features),
     gives FID <= 1e-3; wall seconds of sampling and of evaluation
 17. the MCM ControlNet and ReMoDiffuse on the card, with seeded
     fabricated weights: tools/torch_m2d_test.py on
     configs/mcm/mcm_m2d_finedance.py and tools/torch_s2g_test.py on
     configs/mcm/mcm_s2g_beats2.py (8 MCM layers + 2 control blocks, 512
     wide; 196-frame windows overlapping by 30 / 4; 2 recordings of two
     windows each, R = 1 and R = 2 in lockstep, R rows a denoiser call):
     finite predictions and metrics, K5 20 a denoiser call and nothing
     else; one denoiser call profiled (device kernels, device ms, idle
     share); card vs CPU on one denoiser call, one outpainted window on the
     same draws (PARITY_RESPACE's schedule) and (S2G) the WavEncoder on one
     window; R = 2 against R = 1 on the same draws (each recording's rows of
     the lockstep draws; PARITY_RESPACE's schedule).
     Then configs/remodiffuse/remodiffuse_t2m.py: a fabricated retrieval
     bank of 4,096 entries (HumanML3D's train split, which the config's
     t2m_text_train.npz indexes, holds 23,384), the picks of 16 requests
     (RetrievalDatabase) timed on the host,
     encode_retrieval once, one DDIM-50 four-way CFG batch of 16 through
     MotionDiffusion.sample(extra_model_kwargs={"re_dict": ...}): finite
     [16, 196, 263] motions, K5 4 (the encoder) + 50 x 4 launches; one
     denoiser call profiled; card vs CPU on encode_retrieval and one
     denoiser call (B = 2); one MoMatMoGen forward at the same width (K5
     twice a layer), card vs CPU
 18. ControlNet training from a T2M base through tools/torch_train.py, at
     full width on synthetic trees written in the shipped configs' paths:
     stage 1, configs/stmogen/t2m_motionx_0_125b.py as shipped on its mixed
     train set (Motion-X, FineDance and BEAT2 through build_mixed_dataset,
     the RepeatDataset times cut to 1), 3 steps of 128, params.npz; stage
     2, s2g_beats2_0125b_local_unfreeze.py (batch 96, the WavEncoder,
     unfreeze_mode root_face_hand) and m2d_finedance_0125b.py (batch 84,
     163-d music) from it with --base-checkpoint, 3 steps each: before the
     first step each copied block equals its base block bit for bit and the
     test forward with the condition on equals the base's alone; after,
     every frozen leaf of params.npz is stage 1's bit for bit, every other
     one moved (but the face head under face_no_loss), the WavEncoder's
     statistics moved; every stage's losses finite and K4's positions, K5
     and K6 launched as CN_STEPS steps imply; one S2G training step card vs
     CPU (B = 2 windows of its train set, gate logits pinned as in phase 8);
     stage 3, tools/torch_s2g_test.py on stage 2's S2G params.npz over one
     recording of two windows (K1-K4 as the windows imply).  Per stage: the
     median step ms of steps 2-3, samples/s, max memory, launches a step and
     one more step's idle share from torch.profiler, with the card's name
     and power limit
 19. baseline training through tools/torch_train.py, at full width on
     synthetic trees written in the shipped configs' paths: stage 1,
     configs/{motiondiffuse,mcm,mdm,finemogen}/*_t2m_smplx.py as shipped
     (batches 64 / 256 / 768 / 128), each on its batch's first clips of one
     Motion-X tree (the RepeatDataset times cut to 1) for 4 steps, one an
     epoch, the first a warm-up; MCM's params.npz; stage 2,
     configs/mcm/mcm_m2d_finedance.py from it with --base-checkpoint (batch
     128, FineDance train tracks), its copied blocks the base's and its
     test forward with c on the base's alone before the first step: every
     run's losses finite, its launches a step K5 16 (MotionDiffuse, MCM),
     20 (the ControlNet: 8 base + 2 copied layers x 2), K4's positions and
     K6 8 (FineMoGen) and nothing for MDM (the backward launches none), its
     frozen parameters (each CLIP, MDM's at clip, the ControlNet's base,
     the base checkpoint's) bit for bit where they started; one training
     step of each card vs CPU at B = 2 of its train set (MDM at dropout 0,
     gate logits pinned as in phase 8).  Per run: the median step ms of
     steps 2-3, samples/s, max memory, launches a step and one more step's
     idle share from torch.profiler
 20. the rest of training on the flagship with phase 3's weights: 4
     train_model steps of B = 32 in bf16 (the config's fp16 option: bf16
     copies of the f32 master parameters, the text path and its MoEs in
     bf16 through K6's bf16 instantiation, the motion path in f32 on the
     rounded weights through the f32 K6): finite losses, every master
     parameter f32 and moved (but the face head), CLIP unchanged, launches
     exactly K4's positions 8, K5 4, K6 4 and K6 bf16 4 a step, and the
     step ms beside phase 7's f32 ones; one bf16 training step card vs CPU
     (B = 2, gate logits pinned as in phase 8, within MODEL_BF16_TOL); one
     bf16 step of B = 128 with remat off and on on the same weights: the
     same loss, less max memory allocated with it on, both step times;
     one update of each of Adafactor, AdaBelief and LAMB (optax's defaults)
     on the flagship's trainable parameters from the same seeded gradients,
     card vs CPU within OPT_REL_TOL of each tensor's update (plus two f32
     ulps of its largest parameter); then float16 (F16_TRAIN: dtype
     float16, a static loss scale of 8, as the JAX package's option): 4
     train_model steps of B = 32 with the text path and its MoEs in f16
     through K6's f16 instantiation, the motion path in f32: finite losses,
     f32 masters, CLIP unchanged, launches exactly K4's positions 8, K5 4,
     K6 4 and K6 f16 4 a step, every K5 call's operand dtypes recorded (K5
     has no f16 instantiation and refuses f16), the step ms; one float16
     step card vs CPU (B = 2, gates pinned, the loss scale applied, within
     MODEL_F16_TOL)
 21. data parallelism on torch.distributed (phase 3's weights): the
     flagship through train_model at its config's global batch of 128,
     DP_STEPS steps (the first a warm-up), first in one process, then on 2
     ranks of 64 rows on the one card over gloo with CUDA tensors (NCCL
     refuses two ranks on one card), each rank's gate logits pinned to its
     rows of the one-process run's: the losses, the parameters after the
     Adam steps (DP_PARAM_TOL), the ranks' parameters equal bit for bit, K4's
     positions, K5 and K6 launched as the steps imply on each rank, per-rank
     step ms, samples/s, max memory and the gradient all-reduce's ms; the
     S2G ControlNet (configs/stmogen/s2g_beats2_0125b.py) one SGD step at
     2 x 8 windows of 64 frames the same way, its gradients (GRAD_REL_TOL)
     and its WavEncoder's BatchNorm running statistics (global batch
     statistics) against one process's; one step
     in a one-rank NCCL group through the same code path (and the flagship
     over NCCL one card a rank where the host has two cards; else a line
     says it was not run); tools/torch_test.py over 2 processes on the card
     (gloo) on DP_EVAL_CLIPS synthetic Motion-X clips: every clip once, in
     dataset order, on both ranks, metrics on rank 0 alone, K1-K4 launched
     as each rank's batches imply, each rank's predictions bit for bit those
     of one process over its slice (seed + rank) at --dispatch-batches 2
 22. the model across ranks (phase 3's weights), 2 gloo ranks on the one
     card: the flagship with its experts over an ``expert`` mesh of 2 and
     then with its FFNs' hidden dims over a ``tensor`` mesh of 2 (the
     expert leaves at E / 2, the hidden leaves at F / 2 on each rank,
     checked), MP_STEPS Adam steps at a global batch of MP_BATCH through
     train_model, each gate's logits pinned to the one-process run's rows:
     the losses and the gathered whole parameters against one process
     (DP_PARAM_TOL), K4's positions, K5 and K6 launched as the steps imply,
     each rank's parameter and optimizer bytes, step ms, and the
     collectives' calls, bytes and ms (all-to-all, all-reduce,
     all-gather); each mesh's batch of MP_SAMPLE_REQUESTS requests (DDIM-10)
     through apis/test.py:mesh_sample (expert: K4's route over the
     gathered logits and K6 on the local experts; tensor: K1 and K2 on
     hidden slices) against one process's (MODEL_REL_TOL); then a 2-rank
     data-mesh MotionGenServer answering MP_SERVE_REQUESTS requests in
     dispatches of 4 against the one-card server on the same dispatches
     (MODEL_REL_TOL), requests/s of both
 23. pipeline parallelism, in phase 22's launch of 2 gloo ranks: the
     flagship (its config, gate noise 1.0) with pipeline_axis on a pipe
     mesh of 2 (data 1 x pipe 2, layers 0-1 on rank 0, 2-3 on rank 1),
     MP_STEPS Adam steps at a global batch of MP_BATCH in PP_MICROBATCHES
     microbatches through train_model, against one process running the same
     pipelined config (the layers per microbatch in sequence) on the card:
     the losses (MODEL_REL_TOL) and the gathered whole parameters
     (DP_PARAM_TOL), each rank's layers its stage's and no others, its
     block parameter and Adam bytes half one process's, K4's positions, K5
     and K6 launched on each rank as its stage's microbatches imply, step
     ms and the messages' calls, bytes and ms; the ranks' params.npz (blocks
     stacked, written by rank 0) equals the gathered weights and loads into
     the plain flagship on one card, and a DDIM-50 batch of
     MP_SAMPLE_REQUESTS requests sampled over the pipe mesh (K1-K4 on each
     stage) equals the pipelined config's per-microbatch sampling in one
     process from that file (MODEL_REL_TOL)
 24. the baselines in low precision, with seeded fabricated weights:
     motiondiffuse_t2m_smplx, mcm_t2m_smplx, mdm_t2m_smplx,
     finemogen_t2m_smplx and remodiffuse_t2m (on retrieved rows at phase
     17's bank's shapes) each in bf16, W8 and W8A8, one denoiser call
     (one request) card vs CPU, the gate logits pinned as in phase 6: bf16 within
     MODEL_BF16_TOL x scale (FineMoGen's rows before its CFG mix), W8
     within MODEL_REL_TOL, W8A8 within W8A8_SENS times the card's own
     one-ulp sensitivity read in this run (phase 13's rule; at least
     MODEL_REL_TOL x scale, MDM's quantized products being its time MLP's
     alone); then a bf16
     DDIM-50 batch of 16 of configs/mcm/mcm_t2m.py (every K5 call through
     K5's bf16 instantiation: 50 x 16 launches, nothing else) and of
     finemogen_t2m_smplx uncached and with --step-cache 2's flags (K1 bf16,
     K2 bf16 and K4's route as the flags imply), wall ms
     beside phases 15's and 16's f32 batches
 25. the visualizers, each CLI through its main(argv) on seeded fabricated
     weights saved as a params.npz (VIS_*): tools/torch_visualize.py on the
     flagship, 4 prompts of VIS_LENGTHS frames in one DDIM-50 CFG call
     (npz layouts, --web players; K1-K4 as sampling_counts; two of the
     prompts at VIS_PARITY_RESPACE card vs CPU, the same noise, the gate
     logits pinned as in phase 6, within MODEL_REL_TOL), on
     configs/mcm/mcm_t2m.py (one prompt, the 263-d branch, K5's launches);
     tools/torch_m2d_visualize.py on one synthetic FineDance track
     (VIS_M2D_FRAMES a window, --web) and tools/torch_s2g_visualize.py on
     one synthetic BEAT2 recording of VIS_S2G_FRAMES (2 windows, --web;
     res_ and gt_ npz files), each run's wall s, denoiser calls, launches
     and idle share (torch.profiler)
 26. the rest of the baseline zoo: three STMoGen variants of the flagship's
     config at its widths (128 a head, 16 experts top-2, text 256, 4
     layers, ff 512), seeded fabricated weights, each one CFG DDIM call
     (ZOO_RESPACE) of ZOO_BATCH requests at T = 196 through
     MotionDiffusion.sample: V1 motionx with patch_size 2 on the stack and
     STMA (K3 at T / 2 = 98 patches), the linear top-k gate and a 4-entry
     ffn_cfg list (F 512, 256, 512, 256); V2 human_ml3d, 8 heads (7 parts +
     body) with the body graph (the smpl_parts STGCN) and one text head a
     head (text_latent_dim 32: K5 over 77 + 196 keys in every layer, no
     K3); V3 human_ml3d with joints (23 heads); a first call records each
     kernel's arguments at every distinct shape it gives it (K1 and K4's
     route: the text MoE, layer 0's motion MoE on one CFG half, layers
     1-3's on both); a second, uninstrumented, has its launches exact (K1
     and K4's route once a layer for the text MoE, then per step and layer
     one motion MoE, one SFFN and K3 or K5), a finite sample of the right
     shape and the call's wall ms; then one launch of each kernel at each
     recorded shape against its plain version at phase 2's tolerances,
     with its times
 27. one JSON line of the kernels' numbers, and last the device line

The script imports nothing of JAX and nothing of motioncraft_tpu.
"""

from __future__ import annotations

import contextlib
import functools
import json
import math
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(ROOT, "configs", "stmogen", "t2m_motionx_0_125b.py")
M2D_CONFIG = os.path.join(ROOT, "configs", "stmogen", "m2d_finedance_0125b.py")
S2G_CONFIG = os.path.join(ROOT, "configs", "stmogen", "s2g_beats2_0125b.py")
F32_PEAK = 67e12      # H100 SXM CUDA-core f32, FLOP/s
TF32_PEAK = 495e12    # H100 SXM dense TF32 tensor cores, FLOP/s; 3xTF32 takes 3 passes
BF16_PEAK = 989e12    # H100 SXM dense bf16 (and fp16) tensor cores, FLOP/s
HBM_PEAK = 3.35e12    # H100 SXM device memory, bytes/s
KERNEL_REL_TOL = 1e-4   # kernel vs plain: max abs err <= tol * max |plain|
PLAIN_ONE_CALL_MS = 20.0
# a bf16 kernel vs its plain version: both round the output (and K1's and
# K2's hidden) to bf16, one ulp 3.9e-3 relative; a sum near a rounding
# boundary may round the other way
KERNEL_BF16_TOL = 1e-2
KERNEL_F16_TOL = 2.0 ** -10  # one f16 ulp of the largest output
# bf16 forward card vs CPU: the two round bf16 in other places (cuBLAS
# against the CPU's products, the kernels' sums against the plain ones')
MODEL_BF16_TOL = 5e-2
# moe_route's gates and ge against the plain version's: a softmax over 16
# terms summed in another order moves a gate in [0, 1] by a few f32 ulps
GATE_ATOL = 1e-6
MODEL_REL_TOL = 1e-4    # card vs CPU forward: <= tol * max(1, max |CPU|)
# card vs CPU gradient, per tensor: <= tol * max(1, max |CPU|); a gradient
# sums the whole batch, the card's MoE gathers add theirs back with atomics
# in a varying order, and the f32 products sum in other orders
GRAD_REL_TOL = 1e-3
BATCH, BATCHES, SEED = 16, 2, 0
TRAIN_BATCH, TRAIN_STEPS = 32, 4  # 1 warm-up + 3 timed
# one replication (320 before phase 21 came, which put the script over 1000 s
# on one host; 160 before phase 22 came, 96 before phase 24 came, 64 before
# phase 25 came); the Diversity metric draws half of them (300 of 320 before)
EVAL_CLIPS = 32
GT_FID_TOL = 1e-3
# phase 10: 4 FineDance test tracks of the cross-genre split, 360 frames
# trimmed + 300 kept: 3 windows of 120 overlapping by 30 (a window costs
# the same at any track length; 1290 frames, 14 windows, kept phase 10
# over two minutes; phase 13's one cached track at 2 windows has too few
# frames for its FID statistics)
M2D_TRACKS, M2D_FRAMES, M2D_REC_BATCH = ["063", "132", "143", "036"], 300, 4
# the lockstep window held against the CPU: 2 recordings (its RePaint
# steps run at full width on the host's CPU; R = 4 left the script near its
# 1200 s limit on a slow host, and R = 1's window beside it, which R = 2's
# path covers, went with phase 18)
M2D_PARITY_R = 2
# the card-vs-CPU outpainted windows of phases 10, 11 and 17 sample on this
# respacing, DDIM-10 (12 RePaint steps), in place of their configs' DDIM-50
# (84): a cut in depth for phase 22's time, since the CPU runs its side of
# each window at full width, step by step; so do (since phase 25 came, for
# its time) the samplers that phases 10 and 11 hold against each other in
# CUDA sync debug mode and phase 17's lockstep-vs-alone windows, which
# compare the card with itself
PARITY_RESPACE = "2,2,2,2,2"
# phase 11: 4 BEAT2 test recordings of 124 frames: 2 windows of 64
# overlapping by 4 (a window costs the same at any recording length; 244
# frames, 4 windows, before phase 22 came, 184, 3 windows, before phase 24
# came)
S2G_RECORDINGS, S2G_FRAMES, S2G_REC_BATCH = 4, 124, 4
# the SMPL-X neutral body model's sizes: vertices, faces, shape and
# expression directions, pose-corrective directions
SMPLX_SIZES = dict(vertices=10475, faces=20908, shapedirs=400, posedirs=486)
# phase 12: one server a dtype over the flagship, its buckets, 4 client
# threads of 1 request each (8 before phase 18 came, which put the script
# over 900 s, 4 before phase 20 came, 3 before phase 21 came, 2 before phase
# 22 came), 2 long-form requests
SERVE_BUCKETS, SERVE_SEQ_BUCKETS = (1, 2, 4, 8), (64, 128, 196)
SERVE_CLIENTS, SERVE_PER_CLIENT, SERVE_LONG, SERVE_LONG_FRAMES = 4, 1, 2, 400
# the batch buckets each server warms up: those its traffic fills (every
# bucket of SERVE_BUCKETS before phase 25 came; 12 pairs took 8.7 s a server)
SERVE_WARM = (1, 2)
# the bucket pairs (batch, frames) whose kernel shapes phase 2 checks: the
# smallest and the largest
SERVE_CHECKED = ((1, 64), (8, 196))
# phase 13: the committed step-cache table (DDIM-50 x 4 layers, 83 of 200
# (step, layer) pairs computed), the clips of each int8 evaluation through
# tools/torch_test.py (two batches), the int8 tensor cores' dense peak, and
# the W8A8 forward card vs CPU: an activation whose f32 value differs in the
# last bit (sums in another order) can cross a rounding boundary of its
# int8 code, which moves its row by 1/127 of its largest entry in the next
# product, and later layers see those rows.  So no fixed tolerance holds
# it: its limits are W8A8_SENS times what a one-ulp change of the input and
# of every activation before its quantization does to the card's own W8A8
# forward in the same run (max and mean abs difference, share of codes that
# differ), and the first activation that differs holds the module-level
# bound of tests/test_torch_quant.py (codes one apart, at most
# W8A8_FIRST_SHARE of them).  At the flagship, card vs CPU reads 0.6-1.1
# times that sensitivity and the float forward's mean distance 2.5-2.7
# times it: W8A8_SENS sits between
STEP_CACHE_TABLE = os.path.join(ROOT, "artifacts", "step_cache_flagship.json")
LOWPREC_CLIPS = BATCH  # one batch (two before phase 18)
# the W8A8 server's requests a client (phase 12's 4 before phase 19 came,
# which put the script over 1000 s on one host; 2 before phase 20 came)
LOWPREC_SERVE_PER_CLIENT = 1
# the batch buckets the W8A8 server warms up: the one its traffic fills
# first (every bucket of SERVE_BUCKETS before phase 23 came, 1, 2, 4 before
# phase 24 came, 1, 2, those its traffic can fill, before phase 25 came: a
# warm-up is a W8A8 DDIM-50 call a frame bucket, 2.5 s each)
LOWPREC_SERVE_WARM = (1,)
INT8_PEAK = 1979e12   # H100 SXM dense int8 tensor cores, OP/s
W8A8_SENS = 1.5
W8A8_FIRST_SHARE = 1e-3
# phase 14: the quality harness over a learnable tree (tools/make_tiny_data.py
# --protocol-learnable) of 256 clips, its first 32 the test set (64 before
# phase 24 came: one batch of the drift's, not two); the
# evaluator's training steps (1500 before phase 22 came) and its held-out
# top-1 floor (chance 1/32; the test batch's 32 clips hold 20 classes, so
# 0.625 at most)
HARNESS_CONFIG = os.path.join(ROOT, "configs", "tests", "protocol_learn.py")
HARNESS_CLIPS, HARNESS_TEST_CLIPS = 256, 32
HARNESS_EVAL_STEPS, HARNESS_TOP1 = 1000, 0.5
# the harness config's batch (the drift's requests a batch, the loader's
# batch in training), the training CLI's --grad-accum and the calibration
# checkpoint's batch: the shapes whose kernels phase 2 checks for phase 14
HARNESS_BATCH, HARNESS_GRAD_ACCUM, HARNESS_CALIB_BATCH = 32, 2, 8
# phase 20: bf16 training (the config's fp16 option with its compute
# dtype), the batch of its remat pair (phase 18's flagship batch), and the
# optimizers' card-vs-CPU limit on each tensor's update: its f32 reductions
# (Adafactor's factored means and RMS, LAMB's norms) over up to millions of
# elements sum in another order on the card (and each device rounds the
# updated parameter to its f32 ulp: the check adds two of those)
BF16_TRAIN = dict(dtype="bfloat16")
# float16 training (phase 20): the JAX package's fp16 option in float16
# with a static loss scale (no skipped step, no dynamic scaler); its
# card-vs-CPU step within MODEL_F16_TOL: f16's ulp is 2^-11 relative (8x
# finer than bf16's, held at MODEL_BF16_TOL), but the card rounds in other
# places (K6 rounds its hidden once, cuBLAS sums in another order)
F16_TRAIN = dict(dtype="float16", loss_scale=8.0)
MODEL_F16_TOL = 2e-2
REMAT_BATCH = 128
OPT_REL_TOL = 1e-4
# phase 21: data parallelism, DP_WORLD ranks on the one card over gloo
# (NCCL refuses two ranks on one card): the flagship at its config's global
# batch, DP_STEPS train_model steps (the first a warm-up); the S2G
# ControlNet's global BatchNorm, one step at a global batch of
# DP_S2G_BATCH windows of DP_S2G_FRAMES (a cut in depth: phase 18 trains
# it at 96, beside which the card would not hold the ranks); then
# tools/torch_test.py over DP_WORLD processes on DP_EVAL_CLIPS synthetic
# clips (phase 9's kind; a cut from its 160; DP_STEPS 4 and 64 clips before
# phase 22 came, DP_STEPS 3 before phase 24 came).  The flagship's parameters on
# 2 ranks after its Adam steps against one process's on the same card: each
# element within DP_PARAM_TOL x lr but for DP_PARAM_FRAC of a tensor (those
# within two lr a step): the ranks' gradient sums run in another order and
# the MoE's backward adds with atomics, and Adam moves an element whose
# gradient sits at that rounding level by up to lr either way (as
# tests/test_torch_train.py holds two Adam steps against JAX).  The S2G step
# takes SGD at the config's lr, so its update is the gradient, held as
# phase 8 holds one (GRAD_REL_TOL)
DP_WORLD, DP_STEPS, DP_S2G_BATCH, DP_S2G_FRAMES, DP_EVAL_CLIPS = 2, 2, 16, 64, 32
DP_PARAM_TOL, DP_PARAM_FRAC = 2e-2, 1e-3
DP_TIMEOUT_S = 600
# phase 22: the model across ranks, MP_WORLD gloo ranks on the one card: the
# flagship at a global batch of MP_BATCH, MP_STEPS Adam steps (the first a
# warm-up) on each mesh of MP_MESHES (the experts over 2 ranks; the FFNs'
# hidden dims over 2), held against one process with the gate logits
# pinned as phase 21 pins them (DP_PARAM_TOL); each mesh's DDIM-50 batch of
# MP_SAMPLE_REQUESTS requests (mesh_sample: K4 and K6 on the local experts;
# K1 and K2 on hidden slices) against one process's; a 2-rank data-mesh
# server over the flagship answering MP_SERVE_REQUESTS requests in
# dispatches of the largest of MP_SERVE_BUCKETS against the one-card
# server on the same dispatches (MODEL_REL_TOL)
MP_WORLD, MP_BATCH, MP_STEPS, MP_SAMPLE_REQUESTS = 2, 32, 2, 2
# each mesh's sampling batch (and the one process's it is held against) on
# PARITY_RESPACE's DDIM-10 in place of the config's DDIM-50: a cut in depth
# for the script's time (two meshes' 50 steps, each step's collectives
# through gloo on the host, took 12.6 s a rank)
MP_SAMPLE_RESPACE = PARITY_RESPACE
MP_MESHES = (("ep", ("data", "expert"), (1, 2)), ("tp", ("data", "expert", "tensor"), (1, 1, 2)))
MP_SERVE_BUCKETS, MP_SERVE_REQUESTS, MP_TIMEOUT_S = (2, 4), 4, 900
# phase 23: pipeline parallelism in phase 22's launch (the docstring's
# phase 23): the flagship pipelined over a pipe mesh of MP_WORLD stages,
# each step's global batch of MP_BATCH in PP_MICROBATCHES microbatches
PP_MICROBATCHES = 2
# the bf16 instantiations of K1-K3 (bf16 inference)
BF16_KERNELS = ("grouped_ffn", "head_ffn", "stma_linear_attention")
# training's kernels: K4's positions, K5, K6
TRAINING_KERNELS = ("moe_positions", "fused_linear_attention", "fused_expert_ffn")
# phase 15: the baselines at full width on seeded fabricated weights, each
# sampling one batch of BATCH requests with its config's DDPM respaced to
# BASELINE_DDPM_RESPACE steps (all 1000 before phase 24 came, which put the
# script past 1200 s on a slow host, 250 before phase 25 came; the same
# sampler and denoiser, a tenth of the calls); mcm_t2m.py's DDIM-50; the
# protocol run's clips (one replication at BATCH, Diversity on half of
# them) on MotionDiffuse
MD_CONFIG = os.path.join(ROOT, "configs", "motiondiffuse", "motiondiffuse_t2m_smplx.py")
MCM_CONFIG = os.path.join(ROOT, "configs", "mcm", "mcm_t2m_smplx.py")
MDM_CONFIG = os.path.join(ROOT, "configs", "mdm", "mdm_t2m_smplx.py")
MCM_DDIM_CONFIG = os.path.join(ROOT, "configs", "mcm", "mcm_t2m.py")
BASELINE_DDPM_RESPACE = "100"
BASELINE_CONFIGS = (MD_CONFIG, MCM_CONFIG, MDM_CONFIG)
# phase 24: the baselines in low precision: each of LP_CONFIGS (ReMoDiffuse
# on retrieved rows at phase 17's bank's shapes) card vs CPU in each of
# LP_MODES, then bf16 DDIM-50 batches of MCM and FineMoGen
LP_CONFIGS = (MD_CONFIG, MCM_CONFIG, MDM_CONFIG,
              os.path.join(ROOT, "configs", "finemogen", "finemogen_t2m_smplx.py"),
              os.path.join(ROOT, "configs", "remodiffuse", "remodiffuse_t2m.py"))
LP_MODES = ("bf16", "w8", "w8a8")
# phase 24's card-vs-CPU call: one request (the CPU's full-width forwards
# are most of the phase's time)
LP_BATCH = 1
# the protocol run: one batch (two before phase 18, 4 in PR 12)
BASELINE_CLIPS, BASELINE_FRAMES = BATCH, 196
# phase 16: FineMoGen at full width (Motion-X 322-d, 12 heads) and its
# HumanML3D config's protocol run on a synthetic tree of 64 clips;
# MultiModality on 8 samples x 2 repeats
FMG_CONFIG = os.path.join(ROOT, "configs", "finemogen", "finemogen_t2m_smplx.py")
FMG_HML_CONFIG = os.path.join(ROOT, "configs", "finemogen", "finemogen_t2m.py")
FMG_KIT_CONFIG = os.path.join(ROOT, "configs", "finemogen", "finemogen_kit.py")
FMG_CLIPS, FMG_MM_SAMPLES, FMG_MM_REPEATS = 64, 8, 2
# phase 17: the MCM ControlNet's M2D and S2G configs through the long-form
# CLIs (2 recordings of two 196-frame windows each, at R = 1 and R = 2 in
# lockstep), ReMoDiffuse's DDIM-50 batch of BATCH over a fabricated
# retrieval bank of REMO_BANK entries (each motion [196, 263] f32, 77 CLIP
# tokens of 512; HumanML3D's train split, 23,384, before phase 22 came: its
# 8.5 GB took 23-27 s to make), and one MoMatMoGen forward
MCM_M2D_CONFIG = os.path.join(ROOT, "configs", "mcm", "mcm_m2d_finedance.py")
MCM_S2G_CONFIG = os.path.join(ROOT, "configs", "mcm", "mcm_s2g_beats2.py")
REMO_CONFIG = os.path.join(ROOT, "configs", "remodiffuse", "remodiffuse_t2m.py")
MCM_RECORDINGS, MCM_REC_BATCH, REMO_BANK = 2, 2, 4096
# phase 18: ControlNet training from a T2M base, CN_STEPS optimizer steps a
# stage.  Stage 1's mixed set (the flagship's shipped train set, its
# RepeatDataset times cut to 1): MIX_CLIPS Motion-X clips of MIX_CLIP_FRAMES,
# MIX_TRACKS FineDance train tracks and MIX_RECORDINGS BEAT2 train
# recordings of MIX_REC_FRAMES (10 windows of 64 every 20 each): 388
# samples, 3 steps of 128.  Stage 2: CN_S2G_RECORDINGS BEAT2 train
# recordings of CN_S2G_FRAMES (27 windows each, 324: 3 steps of 96) and
# CN_M2D_TRACKS FineDance train tracks (one crop a track: one step of 84 an
# epoch, CN_M2D_EPOCHS epochs); FineDance tracks are 360 + CN_FRAMES
# frames.  Stage 3: one BEAT2 test recording of CN_TEST_FRAMES (2 windows).
# Fewer than 3 steps leave the S2G condition encoder unmoved (its output
# meets zero-initialized layers), which the stage checks
CN_S2G_CONFIG = os.path.join(ROOT, "configs", "stmogen", "s2g_beats2_0125b_local_unfreeze.py")
CN_STEPS, CN_FRAMES, CN_TEST_FRAMES = 3, 256, 124
MIX_CLIPS, MIX_CLIP_FRAMES, MIX_TRACKS, MIX_RECORDINGS, MIX_REC_FRAMES = 360, 196, 8, 2, 244
CN_S2G_RECORDINGS, CN_S2G_FRAMES, CN_M2D_TRACKS, CN_M2D_EPOCHS = 12, 600, 100, 3
# phase 19: baseline training through tools/torch_train.py, BL_STEPS
# optimizer steps a run (one an epoch over a set of one batch, the first a
# warm-up; 4 before phase 22 came): the four Motion-X configs on one tree of clips of BL_FRAMES
# frames (as many as the largest batch, MDM's 768), then the MCM ControlNet
# from stage 1's MCM on its batch of FineDance train tracks
BL_CONFIGS = (MD_CONFIG, MCM_CONFIG, MDM_CONFIG, FMG_CONFIG)
BL_STEPS, BL_FRAMES = 3, 196
# phase 25: the visualizers on seeded fabricated weights: the flagship's
# prompts (one DDIM-50 CFG call of 4: 8 rows), MCM's one prompt, one
# FineDance track's window, one BEAT2 recording of two 64-frame windows
VIS_TEXTS = ("a person walks forward then turns around", "a person waves with the right hand",
             "a person jumps", "a person dances in a circle")
VIS_LENGTHS = (196, 120, 60, 196)
# the prompts of the card-vs-CPU check and its respacing, DDIM-5 (the CPU's
# side of all four at PARITY_RESPACE's DDIM-10 took 20.4 s of a 118 s phase,
# of two 7.3-9.2 s)
VIS_PARITY, VIS_PARITY_RESPACE = (0, 2), "1,1,1,1,1"
VIS_M2D_FRAMES, VIS_S2G_FRAMES = 120, 124
# the shipped configs' data paths under <dir>/data
MIX_MOTIONX = dict(motions="motion_data/smplx_322", texts="texts/semantic_labels",
                   ann="humanml3d_align_train_val.txt", mean="humanml3d_align_mean.npy",
                   std="humanml3d_align_std.npy")
BEAT2_DIR = os.path.join("datasets", "beats2", "PantoMatrix", "BEAT2", "beat_english_v2.0.0")

# phase 26: the zoo's STMoGen variants (ZOO_VARIANTS), one DDIM call each of
# ZOO_BATCH requests at T = 196, respaced to ZOO_RESPACE; every distinct
# shape of each kernel held against its plain version
ZOO_BATCH, ZOO_RESPACE = 2, "2,2,2,2,2"
ZOO_VARIANTS = ("V1", "V2", "V3")

PALLAS = {
    "moe_route": "motioncraft_tpu/ops/pallas_moe.py:54",
    "moe_positions": "motioncraft_tpu/ops/pallas_moe.py:54",
    "grouped_ffn": "motioncraft_tpu/ops/pallas_moe_ffn.py:46",
    "head_ffn": "motioncraft_tpu/ops/pallas_sffn.py:41",
    "stma_linear_attention": "motioncraft_tpu/ops/pallas_stma_attention.py:74",
    "fused_linear_attention": "motioncraft_tpu/ops/pallas_attention.py:111",
    "fused_expert_ffn": "motioncraft_tpu/ops/pallas_ffn.py:86",
}
PALLAS.update({f"{k}_bf16": PALLAS[k]
               for k in (*BF16_KERNELS, "fused_expert_ffn", "fused_linear_attention")})
PALLAS["fused_expert_ffn_f16"] = PALLAS["fused_expert_ffn"]
SOURCES = {
    "moe_route": "motioncraft_tpu_torch/csrc/moe_positions.cu",
    "moe_positions": "motioncraft_tpu_torch/csrc/moe_positions.cu",
    "grouped_ffn": "motioncraft_tpu_torch/csrc/moe_ffn.cu",
    "head_ffn": "motioncraft_tpu_torch/csrc/sffn.cu",
    "stma_linear_attention": "motioncraft_tpu_torch/csrc/stma_attention.cu",
    "fused_linear_attention": "motioncraft_tpu_torch/csrc/linear_attention.cu",
    "fused_expert_ffn": "motioncraft_tpu_torch/csrc/expert_ffn.cu",
}
SOURCES.update({f"{k}_bf16": SOURCES[k]
                for k in (*BF16_KERNELS, "fused_expert_ffn", "fused_linear_attention")})
SOURCES["fused_expert_ffn_f16"] = SOURCES["fused_expert_ffn"]


class PhaseError(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise PhaseError(msg)


SKIPPED_INITS = ("kaiming_uniform_", "uniform_", "normal_", "trunc_normal_",
                 "xavier_uniform_", "zeros_", "ones_")


@contextlib.contextmanager
def skip_init(torch):
    """Build modules without their default initialisation, for a model whose
    whole state dict is loaded (or fabricated and loaded) strictly right
    after: torch.nn.init's fills become no-ops inside (a 160 M-parameter
    baseline builds in 0.2 s on the host instead of 2.6)."""
    saved = {name: getattr(torch.nn.init, name) for name in SKIPPED_INITS}
    for name in SKIPPED_INITS:
        setattr(torch.nn.init, name, lambda tensor, *args, **kwargs: tensor)
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(torch.nn.init, name, fn)


# params.npz snapshots that several phases load through a CLI, by the
# weights they hold: each written once where main() keeps a directory for
# them ("dir", which lives as long as the script)
SNAPSHOTS = {"dir": None}


def snapshot(tmp, name, key, write):
    """The path of a params.npz of the weights ``key`` names (a config and
    the seed or the state dict they come from), written by ``write(path)``:
    once for the whole run in SNAPSHOTS["dir"] where main() set one, else as
    ``name`` in ``tmp``."""
    if SNAPSHOTS["dir"] is None:
        path = os.path.join(tmp, name)
        write(path)
        return path
    if key not in SNAPSHOTS:
        path = os.path.join(SNAPSHOTS["dir"], f"{len(SNAPSHOTS)}_{name}")
        write(path)
        SNAPSHOTS[key] = path
    return SNAPSHOTS[key]


def checkpoint_run(torch, fn, *args, **kwargs):
    """``fn(*args, **kwargs)``: a CLI run whose --checkpoint loads the
    denoiser's whole state dict strictly right after building it
    (load_eval_variables), so its build_architecture skips the default
    initialisation (skip_init); every other module the CLI builds (an
    evaluator) keeps its own."""
    from motioncraft_tpu_torch import registry

    real = registry.build_architecture

    def build(*a, **k):
        with skip_init(torch):
            return real(*a, **k)

    registry.build_architecture = build
    try:
        return fn(*args, **kwargs)
    finally:
        registry.build_architecture = real


def time_ms(torch, fn, reps=20):
    """Mean time of one call over ``reps`` back-to-back calls, between two
    CUDA events: the device's time, or the host's where issuing a call
    takes longer than running it."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_events_ns(torch, prof):
    """The durations (ns) of the device's events in a finished torch.profiler
    session, read from its raw kineto events: prof.events() builds a Python
    object for every event and runtime call, seconds for a CLI run's 10^4
    launches."""
    return [e.duration_ns() for e in prof.profiler.kineto_results.events()
            if e.device_type() == torch.autograd.DeviceType.CUDA]


def device_ms(torch, fn, reps=20, attempts=3):
    """Mean device time of one call over ``reps`` calls: the summed
    durations of the kernels it ran, from torch.profiler, without the gaps
    in which the card waited for the host.  A profiling session now and
    then hands back no device events at all (on an H100 once in about a
    hundred sessions, and the first session of most int8 product shapes);
    such a session is run again, up to ``attempts`` times in all, and then
    the call is timed with CUDA events (``time_ms``: host gaps included)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for attempt in range(attempts):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = sum(device_events_ns(torch, prof)) / 1e3
        if us > 0:
            return us / 1e3 / reps
        print(f"[profile] session {attempt + 1} of {attempts} saw no device time")
    print("[profile] timed with CUDA events instead")
    return time_ms(torch, fn, reps)


def bound(flops, nbytes, peak):
    """(ms, 'bytes' | 'operations'): the larger of bytes over the memory
    rate and flops over ``peak``."""
    t_ops, t_bytes = flops / peak * 1e3, nbytes / HBM_PEAK * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


class FfnArgs(tuple):
    """grouped_ffn's arguments, and ``kept``: how many of xs's rows carry a
    choice (the others pad each expert's group to BLOCK rows)."""

    def __new__(cls, args, kept):
        self = super().__new__(cls, args)
        self.kept = kept
        return self


def flagship_inputs(torch, cfg, dev, B2=2 * BATCH, T=None, training=True, layer0=False,
                    Bt=TRAIN_BATCH):
    """Inputs of every kernel at the shapes the phase-4 batches (K1, K2, K3,
    K4's route: B2 CFG-doubled rows of T frames) and, with ``training``, the
    phase-7 training steps (K4's positions over B2 rows, K5 and K6 over Bt)
    give them.  With ``layer0``, K1's and K4's route at layer 0, whose
    motion MoE routes one CFG half (cfg_layer0_dedup)."""
    from motioncraft_tpu_torch.ops.moe_ffn import BLOCK

    g = torch.Generator(device=dev).manual_seed(SEED)
    m = cfg["model"]
    ca = m["ca_block_cfg"]
    T = T or m["max_seq_len"]
    H, L = ca["num_heads"], ca["latent_dim"]
    E, K, TXT = ca["num_experts"], ca["topk"], ca["max_text_seq_len"]
    f = m["ffn_cfg"]["ffn_dim"]
    r = lambda *s: torch.randn(*s, generator=g, device=dev)  # noqa: E731

    def moe_case(n_tokens, d, hid):
        ids = torch.randint(0, E, (K * n_tokens,), generator=g, device=dev,
                            dtype=torch.int32)
        cap = K * int(1.5 * ((n_tokens + E - 1) // E))
        fill = torch.bincount(ids.long(), minlength=E).clamp(max=cap)
        aligned = (fill + BLOCK - 1) // BLOCK * BLOCK
        M = (n_tokens * K + BLOCK - 1) // BLOCK * BLOCK + E * BLOCK
        starts = torch.arange(M // BLOCK, device=dev) * BLOCK
        be = torch.searchsorted(torch.cumsum(aligned, 0), starts, right=True)
        be = be.clamp(max=E - 1).to(torch.int32)
        ffn = FfnArgs((be, r(M, d), r(E, d, hid) / math.sqrt(d), r(E, hid) * 0.1,
                       r(E, hid, d) / math.sqrt(hid)), kept=int(fill.sum()))
        return (ids, E), ffn

    def route_case(n_tokens, skew=0.0):
        logits = r(n_tokens, E)
        logits[:, 0] += skew  # every token leans to expert 0: it overflows
        return logits, K, K * int(1.5 * ((n_tokens + E - 1) // E)), BLOCK

    if layer0:
        n = B2 // 2 * T * H
        return {"moe_route": [route_case(n), route_case(n, skew=3.0)],
                "grouped_ffn": [moe_case(n, L, 4 * L)[1]]}
    pos_motion, ffn_motion = moe_case(B2 * T * H, L, 4 * L)
    pos_text, ffn_text = moe_case(B2 * TXT, ca["text_latent_dim"], 4 * ca["text_latent_dim"])
    route = [route_case(B2 * T * H), route_case(B2 * T * H, skew=3.0), route_case(B2 * TXT)]
    lengths = torch.randint(min(40, T), T + 1, (B2,), generator=g, device=dev)
    mask = (torch.arange(T, device=dev)[None] < lengths[:, None]).float()[..., None]
    tcond = torch.cat([torch.ones(B2 // 2), torch.zeros(B2 // 2)]).to(dev).reshape(B2, 1, 1)
    sampling = {
        "moe_route": route,
        "grouped_ffn": [ffn_motion, ffn_text],
        "head_ffn": [(r(B2 * T, H * L), r(H, L, f) / math.sqrt(L), r(H, f) * 0.1,
                      r(H, f, L) / math.sqrt(f), r(H, L) * 0.1)],
        "stma_linear_attention": [(r(B2, T, H, 4 * L), r(B2, TXT, 2 * L), mask, tcond)],
    }
    if not training:
        return sampling

    # training at B = Bt: STMA's global attention over 77 text + T motion
    # keys (masked past each length, text off for 1 in 10), and the slot
    # buffers of the motion and the text MoE (filled up to their loads)
    t_len = torch.randint(min(40, T), T + 1, (Bt,), generator=g, device=dev)
    key_mask = torch.cat([(torch.rand(Bt, 1, generator=g, device=dev) > 0.1).float()
                          .expand(Bt, TXT),
                          (torch.arange(T, device=dev)[None] < t_len[:, None]).float()],
                         dim=1)[:, :, None, None]
    la = (r(Bt, T, H, L), r(Bt, TXT + T, H, L) + (1 - key_mask) * -1e6,
          r(Bt, TXT + T, H, L) * key_mask)

    def slots_case(n_tokens, d, hid):
        cap = K * int(1.5 * ((n_tokens + E - 1) // E))
        ids = torch.randint(0, E, (K * n_tokens,), generator=g, device=dev)
        fill = torch.bincount(ids, minlength=E).clamp(max=cap)
        xe = r(E, cap, d) * (torch.arange(cap, device=dev)[None] < fill[:, None])[..., None]
        return (xe, r(E, d, hid) / math.sqrt(d), r(E, hid) * 0.1,
                r(E, hid, d) / math.sqrt(hid), r(E, d) * 0.1)

    return {
        "fused_linear_attention": [la],
        "fused_expert_ffn": [slots_case(Bt * T * H, L, 4 * L),
                             slots_case(Bt * TXT, ca["text_latent_dim"],
                                        4 * ca["text_latent_dim"])],
        "moe_positions": [pos_motion, pos_text],
        **sampling,
    }


def baseline_attention_inputs(torch, model_cfg, dev, B=BATCH):
    """K5's cases in one of phase 15's baselines (MotionDiffuse, MCM), at
    the shapes its sampling gives them, B requests of T = max_seq_len
    frames: the self-attention's (MotionDiffuse: T motion keys masked past
    varied lengths; MCM: over the latent channels as tokens, T frames split
    over the heads, no mask) and the cross-attention's over 77 text keys."""
    g = torch.Generator(device=dev).manual_seed(SEED)
    m = model_cfg["model"]
    T, D = m["max_seq_len"], m["latent_dim"]
    sa, ca = m["sa_block_cfg"], m["ca_block_cfg"]
    r = lambda *s: torch.randn(*s, generator=g, device=dev)  # noqa: E731

    def case(n_q, n_k, H, d, key_mask=None):
        k, v = r(B, n_k, H, d), r(B, n_k, H, d)
        if key_mask is not None:
            k, v = k + (1 - key_mask) * -1e6, v * key_mask
        return (r(B, n_q, H, d), k, v)

    if m["type"] == "MCMTransformer":
        self_case = case(D, D, sa["num_heads"], T // sa["num_heads"])
    else:
        lengths = torch.randint(min(40, T), T + 1, (B,), generator=g, device=dev)
        mask = (torch.arange(T, device=dev)[None] < lengths[:, None]).float()[:, :, None, None]
        self_case = case(T, T, sa["num_heads"], D // sa["num_heads"], mask)
    cross_case = case(T, 77, ca["num_heads"], D // ca["num_heads"])
    return {"fused_linear_attention": [self_case, cross_case]}


def retrieval_attention_inputs(torch, model_cfg, dev, B=BATCH):
    """K5's cases in phase 17's ReMoDiffuse (MoMatMoGen: ``model_cfg``'s
    type) sampling at B requests of T = max_seq_len frames: the retrieval
    encoder's self-attention over the B x R retrieved motions (masked past
    their lengths), and the semantics-modulated attention of the 4B CFG
    rows (cond_type 99 / 1 / 10 / 0) over 77 text keys, the R x T / stride
    retrieved frames and the T motion frames (the dual version: twice, its
    own and the other person's), masked as the model masks them: the text
    off in rows 10 and 0, the retrieval off in rows 1 and 0 and on its
    padded frames (-2e6 where both), the motion past varied lengths."""
    g = torch.Generator(device=dev).manual_seed(SEED)
    m = model_cfg["model"]
    rc = m["retrieval_cfg"]
    T, D, H = m["max_seq_len"], m["latent_dim"], m["ca_block_cfg"]["num_heads"]
    R, stride, Tb = rc["num_retrieval"], rc["stride"], rc["max_seq_len"]
    rH = rc["sa_block_cfg"]["num_heads"]
    r = lambda *s: torch.randn(*s, generator=g, device=dev)  # noqa: E731
    neg = -1e6

    def lengths_mask(n, frames):
        lengths = torch.randint(min(40, frames), frames + 1, (n,), generator=g, device=dev)
        return (torch.arange(frames, device=dev)[None] < lengths[:, None]).float()

    retr_mask = lengths_mask(B * R, Tb)
    km = retr_mask[:, :, None, None]
    encoder = (r(B * R, Tb, rH, D // rH), r(B * R, Tb, rH, D // rH) + (1 - km) * neg,
               r(B * R, Tb, rH, D // rH) * km)
    cond = torch.tensor([99, 1, 10, 0], device=dev).repeat_interleave(B)
    text_on = ((cond % 10) > 0).float()[:, None]
    retr_on = ((cond // 10) > 0).float()[:, None]
    re_mask = retr_mask[:, ::stride].reshape(B, -1).repeat(4, 1)
    motion = lengths_mask(B, T).repeat(4, 1)
    persons = 2 if m["type"] == "MoMatMoGenTransformer" else 1
    add = torch.cat([(1 - text_on).expand(4 * B, 77) * neg,
                     (1 - retr_on) * neg + (1 - re_mask) * neg,
                     *[(1 - motion) * neg] * persons], dim=1)[:, :, None, None]
    mul = torch.cat([text_on.expand(4 * B, 77), retr_on * re_mask,
                     *[motion] * persons], dim=1)[:, :, None, None]
    N, d = add.shape[1], D // H
    sma = (r(4 * B, T, H, d), r(4 * B, N, H, d) + add, r(4 * B, N, H, d) * mul)
    return {"fused_linear_attention": [encoder, sma]}


def kernel_paths(torch, cfg, m2d_cfg, dev, s2g_cfg=None, baseline_cfgs=(), finemogen_cfgs=None,
                 mcm_cfgs=None, retrieval_cfgs=(), train_cfgs=(), baseline_train_cfgs=(),
                 dp_cfgs=(), mp_cfg=None):
    """(path, inputs) for phase 2: the T2M shapes (with training's), those
    of phase 12's buckets, of phase 25's flagship visualizer call (and MCM's
    one prompt among the baselines'), of phase 14's drift and training, the M2D ones
    and the S2G ones; R recordings in lockstep are a CFG-doubled
    batch of 2R x window frames (120 for M2D, 64 for S2G: the base blocks
    past layer 0 and the control blocks), and layer 0's motion MoE routes
    its first half; then K5's inference shapes of phase 15's baselines
    (``baseline_cfgs``: their model configs, the ones with K5 attentions),
    and phase 16's FineMoGen sampling (``finemogen_cfgs``: {tag: model
    config} of the configs it samples; K1-K2 and K4's route at the
    flagship's batch with each one's SAMI widths; no K3, and no layer-0
    half: SAMI routes both CFG halves); then phase 17's: the MCM
    ControlNet's K5 cases at R recordings in lockstep (``mcm_cfgs``: {tag:
    model config}; R rows, as it runs no CFG: its base's channel and cross
    attention) and ReMoDiffuse's and MoMatMoGen's (``retrieval_cfgs``:
    their model configs); then phase 18's training microbatches
    (``train_cfgs``: (tag, model config of the denoiser or a ControlNet's
    base, batch); K4's positions, K5 and K6: a ControlNet's copied blocks
    have its base's shapes); then phase 19's training batches
    (``baseline_train_cfgs``: (tag, model config, batch); K5 for
    MotionDiffuse, MCM and the MCM ControlNet, whose copied blocks have its
    base's shapes; K6 on FineMoGen's motion MoE); then phase 21's ranks
    (``dp_cfgs``: (tag, model config, global batch, frames, kernels): each
    rank's K5 over its rows, K4's positions over the global token list and
    K6 on a slot buffer of the global capacity; ``kernels`` those not
    already checked at the same shapes); then phase 22's (``mp_cfg``: the
    flagship's model config; ``mp_paths``)."""
    t2m = flagship_inputs(torch, cfg, dev)
    layer0 = flagship_inputs(torch, cfg, dev, training=False, layer0=True)
    paths = [("t2m", t2m), ("t2m layer 0", layer0),
             ("t2m bf16", bf16_inputs(torch, t2m)), ("t2m layer 0 bf16", bf16_inputs(torch, layer0)),
             # phase 20's bf16 and float16 training: K6's bf16 and f16
             # instantiations on the text slots
             (f"t2m train bf16 B={TRAIN_BATCH}",
              half_cases(torch, "fused_expert_ffn", t2m["fused_expert_ffn"][1:])),
             (f"t2m train f16 B={TRAIN_BATCH}",
              half_cases(torch, "fused_expert_ffn", t2m["fused_expert_ffn"][1:], "float16"))]
    # phase 12's smallest and largest buckets (b requests, T frames: 2b
    # CFG rows), in f32 and in bf16, each with layer 0's half
    for b, T in SERVE_CHECKED:
        full = flagship_inputs(torch, cfg, dev, B2=2 * b, T=T, training=False)
        half = flagship_inputs(torch, cfg, dev, B2=2 * b, T=T, training=False, layer0=True)
        tag = f"serve b={b} T={T}"
        paths += [(tag, full), (f"{tag} layer 0", half),
                  (f"{tag} bf16", bf16_inputs(torch, full)),
                  (f"{tag} layer 0 bf16", bf16_inputs(torch, half))]
    # phase 25: the flagship visualizer's one call of VIS_TEXTS (2x CFG rows
    # at T = 196), with layer 0's half
    b = len(VIS_TEXTS)
    paths += [(f"vis b={b}", flagship_inputs(torch, cfg, dev, B2=2 * b, training=False)),
              (f"vis b={b} layer 0", flagship_inputs(torch, cfg, dev, B2=2 * b, training=False,
                                                     layer0=True))]
    # phase 14: the drift's batches (HARNESS_BATCH requests: 2x CFG rows)
    # in f32 and in bf16, each with layer 0's half; the training CLI's
    # microbatches and the calibration checkpoint's batches (K4's
    # positions, K5, K6)
    full = flagship_inputs(torch, cfg, dev, B2=2 * HARNESS_BATCH, training=False)
    half = flagship_inputs(torch, cfg, dev, B2=2 * HARNESS_BATCH, training=False, layer0=True)
    tag = f"harness drift b={HARNESS_BATCH}"
    paths += [(tag, full), (f"{tag} layer 0", half), (f"{tag} bf16", bf16_inputs(torch, full)),
              (f"{tag} layer 0 bf16", bf16_inputs(torch, half))]
    for Bt in (HARNESS_BATCH // HARNESS_GRAD_ACCUM, HARNESS_CALIB_BATCH):
        train = flagship_inputs(torch, cfg, dev, B2=Bt, Bt=Bt)
        paths.append((f"harness train B={Bt}", {k: train[k] for k in TRAINING_KERNELS}))
    for tag, lf_cfg, batch in (("m2d", m2d_cfg, M2D_REC_BATCH),
                               ("s2g", s2g_cfg, S2G_REC_BATCH)):
        if lf_cfg is None:
            continue
        base = {"model": lf_cfg["model"]["model"]["base_model"]}
        win = lf_cfg["windowed"]["window"]
        for R in (1, batch):
            paths += [(f"{tag} R={R}", flagship_inputs(torch, base, dev, B2=2 * R, T=win,
                                                       training=False)),
                      (f"{tag} R={R} layer 0", flagship_inputs(
                          torch, base, dev, B2=2 * R, T=win, training=False, layer0=True))]
    for model_cfg in baseline_cfgs:
        cases = baseline_attention_inputs(torch, model_cfg, dev)
        tag = f"{model_cfg['model']['type']} B={BATCH}"
        # and in bf16 (phase 24): its three operands bf16, K5's bf16 instantiation
        paths += [(tag, cases), (f"{tag} bf16", half_cases(
            torch, "fused_linear_attention", cases["fused_linear_attention"]))]
        if model_cfg["model"]["type"] == "MCMTransformer":
            # phase 25's one prompt (mcm_t2m.py has the smplx config's shapes)
            paths.append(("MCMTransformer B=1",
                          baseline_attention_inputs(torch, model_cfg, dev, B=1)))
    for tag, fmg_cfg in (finemogen_cfgs or {}).items():
        fmg = flagship_inputs(torch, fmg_cfg, dev, training=False)
        paths.append((f"{tag} B={BATCH}",
                      {k: v for k, v in fmg.items() if k != "stma_linear_attention"}))
    for tag, mcm_cfg in (mcm_cfgs or {}).items():
        base = {"model": mcm_cfg["model"]["base_model"]}
        for R in (1, MCM_REC_BATCH):
            cases = baseline_attention_inputs(torch, base, dev, B=R)
            sa, ca = cases["fused_linear_attention"]
            # in bf16 its f32 time embedding makes the stream f32 after the
            # first self-attention: that one is all bf16, every
            # cross-attention meets f32 queries beside bf16 text keys and
            # values (K5's f32 instantiation on the widened operands)
            mixed = (ca[0], ca[1].to(torch.bfloat16), ca[2].to(torch.bfloat16))
            paths += [(f"{tag} R={R}", cases),
                      (f"{tag} R={R} bf16", {**half_cases(torch, "fused_linear_attention", [sa]),
                                             "fused_linear_attention": [mixed]})]
    for model_cfg in retrieval_cfgs:
        cases = retrieval_attention_inputs(torch, model_cfg, dev)
        tag = f"{model_cfg['model']['type']} B={BATCH}"
        paths.append((tag, cases))
        if model_cfg["model"]["type"] == "ReMoDiffuseTransformer":
            # in bf16 its semantics-modulated attention joins the f32
            # retrieval's keys and values (encoded from the bank's f32 rows)
            # with bf16 queries: K5's f32 instantiation on the widened query
            q, k, v = cases["fused_linear_attention"][1]
            paths.append((f"{tag} bf16",
                          {"fused_linear_attention": [(q.to(torch.bfloat16), k, v)]}))
    for tag, model_cfg, Bt in train_cfgs:
        train = flagship_inputs(torch, model_cfg, dev, B2=Bt, Bt=Bt)
        paths.append((f"{tag} train B={Bt}", {k: train[k] for k in TRAINING_KERNELS}))
        if tag == "t2m":  # and K6's bf16 and f16 text slots at that batch (phase 20 at 128)
            paths += [(f"{tag} train bf16 B={Bt}",
                       half_cases(torch, "fused_expert_ffn", train["fused_expert_ffn"][1:])),
                      (f"{tag} train f16 B={Bt}",
                       half_cases(torch, "fused_expert_ffn", train["fused_expert_ffn"][1:],
                                  "float16"))]
    for tag, model_cfg, Bt in baseline_train_cfgs:
        m = model_cfg["model"]
        if m["type"] == "FineMoGenTransformer":
            # its motion MoE's slots at D = 64; K4's positions over B x 196 x
            # 12 and B x 77 tokens and the text slots at D = 256 are phase
            # 18's flagship cases at the same B
            train = flagship_inputs(torch, model_cfg, dev, B2=Bt, Bt=Bt)
            cases = {"fused_expert_ffn": train["fused_expert_ffn"][:1],
                     **half_cases(torch, "fused_expert_ffn", train["fused_expert_ffn"][:1])}
        else:
            cases = baseline_attention_inputs(torch, {"model": m.get("base_model", m)}, dev,
                                              B=Bt)
        paths.append((f"{tag} train B={Bt}", cases))
    for tag, model_cfg, Bg, T, kernels in dp_cfgs:
        local = flagship_inputs(torch, model_cfg, dev, B2=Bg // DP_WORLD, T=T,
                                Bt=Bg // DP_WORLD)
        cases = {"fused_linear_attention": local["fused_linear_attention"]}
        if len(kernels) > 1:
            whole = flagship_inputs(torch, model_cfg, dev, B2=Bg, T=T, Bt=Bg)
            cases |= {k: whole[k] for k in ("moe_positions", "fused_expert_ffn")}
        paths.append((f"{tag} {DP_WORLD} ranks x {Bg // DP_WORLD}",
                      {k: cases[k] for k in kernels}))
    if mp_cfg is not None:
        paths += mp_paths(torch, mp_cfg, dev)
    return paths


def mp_slice(torch, name, args, experts=1, hidden=1):
    """A case of K1 / K2 / K6 as a rank of phase 22 runs it: the first
    1 / ``experts`` of the experts (K6 on this rank's slot buffers: the
    local experts hold the group's tokens at the global capacity), the
    first 1 / ``hidden`` of the hidden dim (b2 zeros: it adds after the
    ranks' partial outputs are summed)."""
    if name == "grouped_ffn":
        be, xs, w1, b1, w2 = args
        f = w1.shape[2] // hidden
        return FfnArgs((be, xs, w1[..., :f].contiguous(), b1[:, :f].contiguous(),
                        w2[:, :f].contiguous()), args.kept)
    first, w1, b1, w2, b2 = args
    n = w1.shape[0] // experts if name == "fused_expert_ffn" else w1.shape[0]
    f = w1.shape[2] // hidden
    if name == "fused_expert_ffn":
        first = first[:n].contiguous()
    return (first, w1[:n, :, :f].contiguous(), b1[:n, :f].contiguous(),
            w2[:n, :f].contiguous(), b2[:n] if hidden == 1 else torch.zeros_like(b2[:n]))


def mp_eval_slots(torch, cfg, dev, B2):
    """K6's cases of an expert-sharded sampling call at B2 CFG rows: the
    slot buffers [E, C, D] of the motion and the text MoE at the eval
    capacity of the whole dispatch, filled up to seeded loads."""
    g = torch.Generator(device=dev).manual_seed(SEED + 22)
    m = cfg["model"]
    ca = m["ca_block_cfg"]
    E, K, H, L = ca["num_experts"], ca["topk"], ca["num_heads"], ca["latent_dim"]
    out = []
    for n_tokens, d in ((B2 * m["max_seq_len"] * H, L),
                        (B2 * ca["max_text_seq_len"], ca["text_latent_dim"])):
        cap = max(1, min(K * int(1.5 * ((n_tokens + E - 1) // E)), n_tokens))
        ids = torch.randint(0, E, (K * n_tokens,), generator=g, device=dev)
        fill = torch.bincount(ids, minlength=E).clamp(max=cap)
        r = lambda *shape: torch.randn(*shape, generator=g, device=dev)  # noqa: E731
        xe = r(E, cap, d) * (torch.arange(cap, device=dev)[None] < fill[:, None])[..., None]
        out.append((xe, r(E, d, 4 * d) / math.sqrt(d), r(E, 4 * d) * 0.1,
                    r(E, 4 * d, d) / math.sqrt(4 * d), r(E, d) * 0.1))
    return out


def mp_paths(torch, cfg, dev):
    """Phase 22's kernel shapes, each path named as ``main`` attributes its
    launches: K6 on the local experts ([E / 2, C, D]) and on hidden
    slices (F / 2) in training at MP_BATCH; in sampling, K6 on the local
    experts at the eval capacity, K1 and K2 on hidden slices; K4's route
    over a 2-rank serving dispatch (the largest bucket); and phase 23's:
    a pipeline stage's training microbatch (K4's positions, K5, K6) and
    sampling microbatch (K1-K4)."""
    train = flagship_inputs(torch, cfg, dev, B2=MP_BATCH, Bt=MP_BATCH)["fused_expert_ffn"]
    B2 = 2 * MP_SAMPLE_REQUESTS
    sample = flagship_inputs(torch, cfg, dev, B2=B2, training=False)
    serve = flagship_inputs(torch, cfg, dev, B2=2 * MP_SERVE_BUCKETS[-1], training=False)
    # phase 23: a stage's training microbatch; a sampling microbatch of the
    # CFG-doubled batch (no layer-0 half: the pipelined stack has no dedup)
    mb = MP_BATCH // PP_MICROBATCHES
    pp_train = flagship_inputs(torch, cfg, dev, B2=mb, Bt=mb)
    pp_sample = flagship_inputs(torch, cfg, dev, B2=B2 // PP_MICROBATCHES, training=False)
    k6 = "fused_expert_ffn"
    return [
        (f"ep train B={MP_BATCH}", {k6: [mp_slice(torch, k6, a, experts=2) for a in train]}),
        (f"tp train B={MP_BATCH}", {k6: [mp_slice(torch, k6, a, hidden=2) for a in train]}),
        (f"ep sample b={MP_SAMPLE_REQUESTS}",
         {k6: [mp_slice(torch, k6, a, experts=2) for a in mp_eval_slots(torch, cfg, dev, B2)]}),
        (f"tp sample b={MP_SAMPLE_REQUESTS}",
         {"grouped_ffn": [mp_slice(torch, "grouped_ffn", a, hidden=2)
                          for a in sample["grouped_ffn"]],
          "head_ffn": [mp_slice(torch, "head_ffn", a, hidden=2) for a in sample["head_ffn"]]}),
        (f"serve {MP_WORLD} ranks b={MP_SERVE_BUCKETS[-1]}", {"moe_route": serve["moe_route"]}),
        (f"pp train microbatch B={mb}", {k: pp_train[k] for k in TRAINING_KERNELS}),
        (f"pp sample microbatch of {B2 // PP_MICROBATCHES} CFG rows",
         {k: pp_sample[k] for k in ("grouped_ffn", "head_ffn", "stma_linear_attention",
                                    "moe_route")}),
    ]


# phase 22's run of each of mp_paths' paths (by the path's first words)
MP_PATH_RUNS = {"ep train": "ep_train", "tp train": "tp_train", "ep sample": "ep_sample",
                "tp sample": "tp_sample", f"serve {MP_WORLD} ranks": "serve",
                "pp train": "pp_train", "pp sample": "pp_sample"}


def bf16_inputs(torch, inputs):
    """The bf16 kernels' cases of a path: K1-K3's inputs rounded to bf16
    (but K3's 0/1 mask and text flag, which a bf16 model passes in f32)."""
    out = {}
    for name in BF16_KERNELS:
        for args in inputs.get(name, []):
            n = 2 if name == "stma_linear_attention" else len(args)
            cast = tuple(a.to(torch.bfloat16) if a.is_floating_point() and i < n else a
                         for i, a in enumerate(args))
            out.setdefault(f"{name}_bf16", []).append(
                FfnArgs(cast, args.kept) if isinstance(args, FfnArgs) else cast)
    return out


def half_cases(torch, name, cases, dtype="bfloat16"):
    """The bf16 (or float16) instantiation of kernel ``name`` on ``cases``,
    every operand rounded to that dtype: K6's slots as the bf16 or float16
    training step hands its text MoEs' slots and half weights to it, K5's
    operands as a bf16-cast baseline hands them to it."""
    suffix = {"bfloat16": "_bf16", "float16": "_f16"}[dtype]
    return {f"{name}{suffix}": [tuple(a.to(getattr(torch, dtype)) for a in args)
                                for args in cases]}


def kernel_work(name, args):
    """(flops, bytes) of one call: the operations the function needs, each
    input read once, each output written once (in its own dtype)."""
    name = name.removesuffix("_bf16").removesuffix("_f16")

    def nb(t):
        return t.numel() * t.element_size()

    if name == "moe_positions":
        M = args[0].numel()
        return M, 8 * M + 4 * args[1]
    if name == "moe_route":
        from motioncraft_tpu_torch.ops.moe_positions import route_rows

        logits, K, _, block = args
        N, E = logits.shape
        M = route_rows(N, K, E, block)
        # per logit: max, subtract, exp, sum and a compare per pick; the
        # logits in, gates, r, ge, token_for_rank, block_expert, counts out
        return N * E * (4 + K), 4 * (2 * N * E + 2 * N * K + M + M // block + E)
    if name == "grouped_ffn":
        # the rows that carry a choice; the padding of each expert's group
        # to BLOCK rows is the kernel's layout, not the function's work
        be, xs, w1, b1, w2 = args
        n, d, hid = args.kept, xs.shape[1], w1.shape[2]
        nbytes = 2 * n * d * xs.element_size() + nb(be) + nb(w1) + nb(b1) + nb(w2)
        return 4 * n * d * hid, nbytes
    if name == "head_ffn":
        x, w1, b1, w2, b2 = args
        n, hd = x.shape
        f = w1.shape[2]
        nbytes = 2 * nb(x) + nb(w1) + nb(b1) + nb(w2) + nb(b2)
        return 4 * n * hd * f, nbytes
    if name == "fused_linear_attention":
        # the output in bf16 for three bf16 operands, else in f32
        q, k, v = args
        B, T, H, d = q.shape
        N = k.shape[1]
        out = 2 if all(t.element_size() == 2 for t in args) else 4
        return 2 * B * H * (N + T) * d * d, nb(q) + nb(k) + nb(v) + out * q.numel()
    if name == "fused_expert_ffn":
        xe, w1, b1, w2, b2 = args
        E, C, d = xe.shape
        nbytes = 2 * nb(xe) + nb(w1) + nb(b1) + nb(w2) + nb(b2)
        return 4 * E * C * d * w1.shape[2], nbytes
    mot, txt, mask, tcond = args
    B, T, H, d4 = mot.shape
    d, TXT = d4 // 4, txt.shape[1]
    flops = B * H * (2 * (T + TXT) * d * d + 2 * T * d * d)
    # of mot's four lanes the function reads key, value and query, not the
    # body value
    nbytes = (3 * nb(mot) // 4 + nb(txt) + nb(mask) + nb(tcond)
              + B * T * H * d * mot.element_size())
    return flops, nbytes


def phase_kernels(torch, cfg, m2d_cfg, dev, s2g_cfg=None, baseline_cfgs=(),
                  finemogen_cfgs=None, mcm_cfgs=None, retrieval_cfgs=(), train_cfgs=(),
                  baseline_train_cfgs=(), dp_cfgs=(), mp_cfg=None):
    """Phase 2: every kernel against its plain version, with times, at the
    T2M shapes, at the M2D and S2G ones, at the baselines', at FineMoGen's,
    at the MCM ControlNet's, ReMoDiffuse's and MoMatMoGen's, at phase 18's
    training microbatches, at phase 19's training batches, at phase 21's
    ranks and at phase 22's."""
    from motioncraft_tpu_torch.ops import KERNELS
    from motioncraft_tpu_torch.ops.stma_attention import max_active_clusters

    print(f"[kernel] stma_linear_attention d=128: {max_active_clusters()} clusters of 4 "
          f"CTAs resident at once (cudaOccupancyMaxActiveClusters)")

    rows = {}
    for path, inputs in kernel_paths(torch, cfg, m2d_cfg, dev, s2g_cfg, baseline_cfgs,
                                     finemogen_cfgs, mcm_cfgs, retrieval_cfgs, train_cfgs,
                                     baseline_train_cfgs, dp_cfgs, mp_cfg):
        for name, cases in inputs.items():
            for i, args in enumerate(cases):
                kernel_case(torch, rows, path, name, i, args, KERNELS[name])
    return rows


def pad_bytes(name, args):
    """The bytes that K5's wrapper moves beyond the function's own at a head
    width the kernel is not instantiated for: the operands written at the
    padded width w and read back, and the output's w - d extra columns
    written.  0 for every other case.  They are the wrapper's cost, not the
    function's work, so the bound leaves them out; the measured times
    include them."""
    if name.removesuffix("_bf16") != "fused_linear_attention":
        return 0
    from motioncraft_tpu_torch.ops.linear_attention import padded_width

    q, k, v = args
    d = q.shape[-1]
    w = padded_width(d)
    padded = (q.numel() + k.numel() + v.numel()) * w // d
    return 0 if w == d else q.element_size() * (2 * padded + q.numel() * (w - d) // d)


def kernel_case(torch, rows, path, name, i, args, fns):
    """One phase-2 case: check it, time it and add it to its kernel's row."""
    wrapper, plain = fns
    got, want = wrapper(*args), plain(*args)
    torch.cuda.synchronize()
    label = f"{name} {path} case {i}"
    if name == "moe_route":
        err = max(float((a - b).abs().max()) for a, b in zip(got, want)
                  if a.dtype == torch.float32)
        ints = [f for f, a, b in zip(got._fields, got, want)
                if a.dtype != torch.float32 and not torch.equal(a, b)]
        ok, tol = err <= GATE_ATOL and not ints, f"{GATE_ATOL}; integers exact"
        dropped = int((got.r == got.token_for_rank.numel()).sum())
        print(f"[kernel] {label}: {dropped} of {got.r.numel()} choices "
              f"dropped; integer outputs that differ: {ints}")
        check(dropped > 0 or i != 1, f"the skewed route case ({label}) dropped nothing")
    elif name == "moe_positions":
        err = max(float((a - b).abs().max()) for a, b in zip(got, want))
        ok, tol = err == 0, "exact"
    else:
        err = float((got.float() - want.float()).abs().max())
        scale = float(want.abs().max())
        rel = (KERNEL_BF16_TOL if name.endswith("_bf16") else
               KERNEL_F16_TOL if name.endswith("_f16") else KERNEL_REL_TOL)
        # K5 on operands of both dtypes computes in f32, as the JAX package's
        # dispatch promotes
        expect = (functools.reduce(torch.promote_types, [a.dtype for a in args])
                  if name.startswith("fused_linear") else
                  args[1 if name.startswith("grouped") else 0].dtype)
        check(got.dtype == want.dtype == expect, f"{name}: output dtype {got.dtype}")
        ok, tol = err <= rel * scale, f"{rel} x {scale:.4g}"
    shapes = [tuple(a.shape) for a in args if hasattr(a, "shape")]
    kept = (f"; {args.kept} of {shapes[1][0]} rows carry a choice"
            if isinstance(args, FfnArgs) else "")
    print(f"[kernel] {label} {shapes}: max_abs_err {err:.3e} (tol {tol}){kept}")
    check(ok, f"{label} disagrees with its plain version: {err} (tol {tol})")
    ms = device_ms(torch, lambda: wrapper(*args))
    call_ms = time_ms(torch, lambda: wrapper(*args))
    # a plain version of 20 ms or more (K4's, a host-side loop) is timed
    # over one call: twenty would take seconds a case
    plain_ms = time_ms(torch, lambda: plain(*args), reps=1)
    if plain_ms < PLAIN_ONE_CALL_MS:
        plain_ms = time_ms(torch, lambda: plain(*args))
    flops, nbytes = kernel_work(name, args)
    if name in ("moe_positions", "moe_route"):  # on the CUDA cores only
        bound_ms, bound_by = f32_ms, f32_by = bound(flops, nbytes, F32_PEAK)
    elif name.endswith(("_bf16", "_f16")):  # 16-bit products at the dense rate (the same)
        bound_ms, bound_by = bound(flops, nbytes, BF16_PEAK)
        f32_ms = f32_by = None  # no f32 work: the 16-bit bound is the only one
    else:  # f32 products: 3xTF32 on the tensor cores is the fastest exact way
        bound_ms, bound_by = bound(3 * flops, nbytes, TF32_PEAK)
        f32_ms, f32_by = bound(flops, nbytes, F32_PEAK)
    f32_note = ("" if f32_ms is None else
                f"; f32 CUDA-core bound {f32_ms:.4f} ms ({f32_by}, share {f32_ms / ms:.3f})")
    print(f"[kernel] {label}: {ms:.4f} ms on the device ({call_ms:.4f} ms a "
          f"back-to-back call), plain {plain_ms:.4f} ms, "
          f"bound {bound_ms:.4f} ms ({bound_by}, share {bound_ms / ms:.3f}){f32_note}")
    case = {"path": path, "shape": shapes, "ms": ms, "call_ms": call_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "max_abs_err": err}
    extra = pad_bytes(name, args)
    if extra:
        from motioncraft_tpu_torch.ops.linear_attention import pad_heads, padded_width

        width = padded_width(args[0].shape[-1])
        case["pad_bytes"] = extra
        case["pad_ms"] = device_ms(torch, lambda: pad_heads(*args, width))
        print(f"[kernel] {label}: the wrapper's pad to d = {width} moves {extra} bytes "
              f"beyond the function's; its copies take {case['pad_ms']:.4f} ms of the "
              f"{ms:.4f} ms")
    if name in rows:  # the row's own numbers are the first (the T2M) case's
        rows[name]["cases"].append(case)
        return
    rows[name] = {"name": name, "route": "cuda", "source": SOURCES[name],
                  "replaces": PALLAS[name], "max_abs_err": err, "ms": ms,
                  "call_ms": call_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                  "bound_by": bound_by, "bound_f32_ms": f32_ms,
                  "bound_f32_by": f32_by, "library_ms": None, "cases": [case]}


def requests(num, seed, T, feats=322):
    import numpy as np
    from motioncraft_tpu_torch.apis import make_text_batch

    verbs = ["walks", "jumps", "waves", "dances", "kicks", "turns", "sits down",
             "runs in a circle"]
    rng = np.random.RandomState(seed)
    texts = [f"a person {verbs[i % len(verbs)]} then {verbs[(3 * i + 1) % len(verbs)]}"
             for i in range(num)]
    lengths = rng.randint(min(40, T), T + 1, (num, 1)).astype(np.int32)
    batch = make_text_batch(texts, max_seq_len=T, input_feats=feats, lengths=lengths)
    batch["motion_metas"] = [{"text": s} for s in texts]
    return batch


def sampling_counts(calls, denoiser_calls, layers, suffix=""):
    """K1-K4's launches over ``calls`` sampling calls that make
    ``denoiser_calls`` denoiser calls in all: per sampling call the text MoE
    once a layer, then per denoiser call and layer one motion MoE, one SFFN
    and one global attention (``suffix`` "_bf16": K1-K3's bf16
    instantiations; K4 routes f32 logits in both)."""
    return {"moe_route": layers * (denoiser_calls + calls),
            f"grouped_ffn{suffix}": layers * (denoiser_calls + calls),
            f"head_ffn{suffix}": layers * denoiser_calls,
            f"stma_linear_attention{suffix}": layers * denoiser_calls}


def phase_e2e(torch, arch):
    """Phases 4-5: the batches through single_device_test, with counts."""
    import numpy as np
    from motioncraft_tpu_torch.apis import single_device_test
    from motioncraft_tpu_torch.ops import launch_counts, reset_launch_counts

    T, D = arch.model.max_seq_len, arch.model.input_feats
    batches = [requests(BATCH, SEED + i, T) for i in range(BATCHES)]
    reset_launch_counts()
    t0 = time.perf_counter()
    results = single_device_test(arch, batches, seed=SEED, device=arch.device,
                                 logger=lambda s: print(f"[e2e] {s}"))
    wall = time.perf_counter() - t0
    counts = launch_counts()
    print(f"[e2e] {len(results)} samples in {wall:.3f} s; launches {counts}")
    check(len(results) == BATCH * BATCHES, f"{len(results)} results")
    for item in results:
        check(item["pred_motion"].shape == (T, D), f"shape {item['pred_motion'].shape}")
        check(np.isfinite(item["pred_motion"]).all(), "non-finite motion")
    steps, layers = arch.diffusion_test.num_timesteps, arch.model.num_layers
    # per sampling call: the text MoE once per layer, then per step and layer
    # one motion MoE, one SFFN and one global attention
    want = dict.fromkeys(counts, 0) | sampling_counts(BATCHES, BATCHES * steps, layers)
    check(counts == want, f"launch counts {counts} != expected {want}")
    spread = float(np.std([r["pred_motion"] for r in results], axis=0).mean())
    print(f"[e2e] steps {steps}, layers {layers}; mean spread across samples {spread:.4g}")
    return counts


def phase_parity(torch, cfg, arch, sd):
    """Phase 6: forward_test on the card against the CPU (plain kernels).

    A token whose top-2 gate logits are a near-tie (gaps of 1e-8 occur at
    this size) can pick another expert on another device: both runs are
    right, yet that token's output and, through the global attention, its
    whole sequence differ.  So the CPU's MoE gates are fed the card's gate
    logits; every other op, each kernel's plain version included, runs on
    the CPU's own inputs.  The gates' own difference and the tokens that
    would have flipped are printed."""
    from motioncraft_tpu_torch.models.moe import CosineTopGate
    from motioncraft_tpu_torch.registry import build_architecture

    with skip_init(torch):
        cpu = build_architecture(cfg, device="cpu")
    cpu.model.load_state_dict(sd, strict=True)
    batch = requests(2, SEED + 100, arch.model.max_seq_len)
    g = torch.Generator().manual_seed(SEED + 7)
    x = torch.randn(batch["motion"].shape, generator=g)
    ts = torch.full((2,), 499, dtype=torch.long)
    card_logits, gate_diff, flips = [], [0.0], [0]
    k = cfg["model"]["ca_block_cfg"]["topk"]

    def record(mod, inp, out):
        card_logits.append(out.cpu())

    def replay(mod, inp, out):
        want = card_logits[len(replayed)]
        replayed.append(out)
        gate_diff[0] = max(gate_diff[0], float((out - want).abs().max()))
        own, card = (torch.sort(v, dim=1, descending=True, stable=True).indices[:, :k]
                     .sort(dim=1).values for v in (out, want))
        flips[0] += int((own != card).any(dim=1).sum())
        return want

    replayed = []
    outs = {}
    for label, a, hook in (("cuda", arch, record), ("cpu", cpu, replay)):
        handles = [m.register_forward_hook(hook) for m in a.modules()
                   if isinstance(m, CosineTopGate)]
        with torch.no_grad():
            xf = a.encode_text(batch["text_ids"])
            out = a.model(x.to(a.device), ts.to(a.device),
                          motion_mask=torch.as_tensor(batch["motion_mask"], device=a.device),
                          motion_length=torch.as_tensor(batch["motion_length"],
                                                        device=a.device),
                          xf_out=xf, text_feats=a.model.precompute_text_feats(xf))
        for h in handles:
            h.remove()
        outs[label] = (xf.cpu(), out.cpu())
    check(len(replayed) == len(card_logits) > 0, "gate calls differ between devices")
    over, gap = [], float("inf")
    for lg in card_logits:
        top = torch.sort(lg, dim=1, descending=True, stable=True)
        gap = min(gap, float((top.values[:, k - 1] - top.values[:, k]).min()))
        N, E = lg.shape
        cap = max(1, min(k * int(1.5 * ((N + E - 1) // E)), N))
        load = int(torch.bincount(top.indices[:, :k].reshape(-1), minlength=E).max())
        if load > cap:
            over.append(f"{load}>{cap}")
    print(f"[parity] MoE calls over capacity (largest expert load > capacity): "
          f"{len(over)} of {len(card_logits)} {over}; smallest gap between the "
          f"top-{k} and the next gate logit: {gap:.3e}")
    print(f"[parity] {len(card_logits)} gate calls: card vs CPU gate logits max abs diff "
          f"{gate_diff[0]:.3e}; tokens whose top-2 experts would differ: {flips[0]}")
    for what, i in (("encode_text", 0), ("forward_test", 1)):
        got, want = outs["cuda"][i], outs["cpu"][i]
        scale = max(1.0, float(want.abs().max()))
        diff = float((got - want).abs().max())
        print(f"[parity] {what} B=2: card vs CPU max abs diff {diff:.3e} "
              f"(tol {MODEL_REL_TOL} x {scale:.4g})")
        check(diff <= MODEL_REL_TOL * scale, f"{what} card vs CPU: {diff} > tol")


def phase_train(torch, full_cfg, arch):
    """Phase 7: train_model on the flagship, B = 32, with counts."""
    import numpy as np
    from motioncraft_tpu_torch.apis import make_train_batch, train_model
    from motioncraft_tpu_torch.ops import launch_counts, reset_launch_counts

    T = arch.model.max_seq_len
    batches = [make_train_batch(TRAIN_BATCH, seed=SEED + i, max_seq_len=T)
               for i in range(TRAIN_STEPS)]
    before = {k: v.clone() for k, v in arch.model.state_dict().items()}
    lines = []

    def log(msg):
        lines.append(msg)
        print(f"[train] {msg}")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    state = train_model(arch, batches, optimizer_cfg=full_cfg["optimizer"],
                        lr_config=full_cfg["lr_config"], max_epochs=1,
                        steps_per_epoch=TRAIN_STEPS, seed=SEED, log_interval=1, logger=log)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    check(state.step == TRAIN_STEPS and not arch.training, "train_model did not finish")
    losses = [float(m.split(" loss=")[1].split()[0]) for m in lines if " loss=" in m]
    step_ms = [float(m.split("step_ms=")[1]) for m in lines if "step_ms=" in m]
    check(len(losses) == TRAIN_STEPS and np.isfinite(losses).all(), f"losses {losses}")
    after = arch.model.state_dict()
    trainable = {n for n, p in arch.model.named_parameters() if p.requires_grad}
    frozen = [n for n in before if n.startswith("text_enc.clip.")]
    moved = [n for n in trainable if not torch.equal(after[n], before[n])]
    check(frozen and all(torch.equal(after[n], before[n]) for n in frozen),
          "a frozen CLIP parameter changed")
    # face_no_loss masks the face features out of the loss, so the face head
    # gets an exactly zero gradient and Adam leaves it where it is
    still = sorted(trainable - set(moved))
    check(all(n.startswith("out.face_out.") for n in still),
          f"trainable parameters that did not move: {still[:5]}")
    want = dict.fromkeys(counts, 0) | training_counts(TRAIN_STEPS, arch.model.num_layers)
    print(f"[train] {TRAIN_STEPS} steps of B={TRAIN_BATCH} in {wall:.3f} s; step wall ms "
          f"{step_ms} (first = warm-up); max memory allocated {peak / 2**30:.3f} GiB; "
          f"{len(moved)} of {len(trainable)} trainable tensors moved (not: {still}), "
          f"{len(frozen)} CLIP tensors unchanged; launches {counts}")
    check(counts == want, f"training launch counts {counts} != expected {want}")
    return counts, step_ms


def training_counts(forwards, layers):
    """K4's positions, K5 and K6 over ``forwards`` training forwards: per
    layer one linear attention and two MoEs (motion, text), each one
    positions launch and one expert FFN; the backward recomputes in plain
    PyTorch."""
    return {"moe_positions": 2 * layers * forwards,
            "fused_linear_attention": layers * forwards,
            "fused_expert_ffn": 2 * layers * forwards}


def phase_train_parity(torch, cfg, sd, batch=None, frozen=("text_enc/clip",),
                       tag="train-parity", card="cuda", fp16=None):
    """Phase 8: one training loss and its gradients, card vs CPU, B = 2,
    gate noise 0 on both; the CPU's gates take the card's gate logits (as
    values; the gradient flows through its own gate), so a near-tie cannot
    route a token differently.  Phase 18 hands it a ControlNet's config,
    a batch with its condition ``c`` and the prefixes training freezes:
    the gradients of the trainable parameters are compared; phase 19 a
    baseline's (a model without MoE gates: nothing to pin).  Every scalar
    loss term is compared.  ``card``: the device held against the CPU (the
    CPU itself in a rehearsal).  With ``fp16`` (phase 20: BF16_TRAIN or
    F16_TRAIN) both run that half step (half copies of the parameters,
    ``apis/train.py:cast_parameters``; the loss times its ``loss_scale``,
    the gradients divided by it) and are held to MODEL_BF16_TOL or
    MODEL_F16_TOL: the two round in other places."""
    import copy
    from motioncraft_tpu_torch.apis import make_train_batch
    from motioncraft_tpu_torch.apis.train import cast_parameters, half_dtype
    from motioncraft_tpu_torch.models.moe import CosineTopGate
    from motioncraft_tpu_torch.parallel import freeze
    from motioncraft_tpu_torch.registry import build_architecture

    tcfg = copy.deepcopy(cfg)
    ca = tcfg["model"].get("base_model", tcfg["model"]).get("ca_block_cfg") or {}
    if "gate_noise" in ca:
        ca["gate_noise"] = 0.0
    if batch is None:
        batch = make_train_batch(2, seed=SEED + 200, max_seq_len=cfg["model"]["max_seq_len"])
    g = torch.Generator().manual_seed(SEED + 8)
    draws = dict(t=torch.randint(0, 1000, (2,), generator=g),
                 noise=torch.randn(batch["motion"].shape, generator=g),
                 cond_type=torch.tensor([37, 4]).reshape(2, 1, 1))  # text on, text off
    class Pin(torch.autograd.Function):
        """The card's value, the identity's gradient."""

        @staticmethod
        def forward(ctx, out, value):
            return value.clone()

        @staticmethod
        def backward(ctx, grad):
            return grad, None

    card_logits, replayed, results = [], [], {}

    def record(mod, inp, out):
        card_logits.append(out.detach().cpu())

    def replay(mod, inp, out):
        want = card_logits[len(replayed)]
        replayed.append(out)
        return Pin.apply(out, want)

    for label, dev, hook in (("cuda", card, record), ("cpu", "cpu", replay)):
        with skip_init(torch):
            a = build_architecture(tcfg, device=dev)
        a.model.load_state_dict(sd, strict=True)
        freeze(a.model, frozen)
        handles = [m.register_forward_hook(hook) for m in a.modules()
                   if isinstance(m, CosineTopGate)]
        a.train()
        scale = float(fp16.get("loss_scale", 1.0)) if fp16 else 1.0
        with (cast_parameters(a.model, half_dtype(fp16)) if fp16
              else contextlib.nullcontext()):
            total, logs = a.loss(batch, **draws)
            (total * scale).backward()
        a.eval()
        for h in handles:
            h.remove()
        gated = any(isinstance(m, CosineTopGate) for m in a.modules())
        results[label] = ({k: float(v.detach()) for k, v in logs.items()
                           if "loss" in k and v.ndim == 0},
                          {n: p.grad.cpu() / scale for n, p in a.model.named_parameters()
                           if p.grad is not None})
        del a
    check(len(replayed) == len(card_logits) and (len(replayed) > 0) == gated,
          "gate calls differ between devices")
    (lc, gc), (lp, gp) = results["cuda"], results["cpu"]
    check(set(lc) == set(lp), f"loss terms {sorted(lc)} on the card, {sorted(lp)} on the CPU")
    loss_tol = grad_tol = (MODEL_F16_TOL if fp16 and half_dtype(fp16) == torch.float16 else
                           MODEL_BF16_TOL)
    if not fp16:
        loss_tol, grad_tol = MODEL_REL_TOL, GRAD_REL_TOL
    for k in lc:
        diff, scale = abs(lc[k] - lp[k]), max(1.0, abs(lp[k]))
        print(f"[{tag}] {k}: card {lc[k]:.7f} CPU {lp[k]:.7f} diff {diff:.3e} "
              f"(tol {loss_tol} x {scale:.4g})")
        check(diff <= loss_tol * scale, f"training {k} card vs CPU: {diff}")
    check(set(gc) == set(gp) and gc, "the gradients cover other parameters on the two devices")
    worst = max(((float((gc[n] - gp[n]).abs().max()) / max(1.0, float(gp[n].abs().max())), n)
                 for n in gp))
    print(f"[{tag}] {len(gp)} gradient tensors; worst max|card - CPU| / max(1, "
          f"max|CPU|) = {worst[0]:.3e} at {worst[1]} (tol {grad_tol})")
    check(worst[0] <= grad_tol, f"gradient {worst[1]} card vs CPU: {worst[0]}")
    return lc, len(gp)


def write_motionx_tree(root, n, T, seed, layout=None):
    """A synthetic Motion-X tree in tools/make_tiny_data.py's layout:
    datasets/motionx/{motions/<name>.npy [T, 322], texts/<name>.txt, ann.txt,
    mean.npy, std.npy}; ``layout`` (MIX_MOTIONX) renames those five for a
    config's own paths (the flagship's mixed train set)."""
    import numpy as np

    names = dict(motions="motions", texts="texts", ann="ann.txt", mean="mean.npy",
                 std="std.npy") | (layout or {})
    rng = np.random.RandomState(seed)
    d = os.path.join(root, "datasets", "motionx")
    for sub in ("motions", "texts"):
        os.makedirs(os.path.join(d, names[sub]), exist_ok=True)
    np.save(os.path.join(d, names["mean"]), np.zeros(322, np.float32))
    np.save(os.path.join(d, names["std"]), np.ones(322, np.float32))
    verbs = ["walks", "jumps", "waves", "dances", "kicks", "turns", "sits down",
             "runs in a circle", "crouches", "claps"]
    clips = [f"clip{i:04d}" for i in range(n)]
    for i, name in enumerate(clips):
        np.save(os.path.join(d, names["motions"], name + ".npy"),
                (rng.randn(T, 322) * 0.5).astype(np.float32))
        with open(os.path.join(d, names["texts"], name + ".txt"), "w") as f:
            f.write(f"a person {verbs[i % len(verbs)]} then {verbs[(7 * i + 3) % len(verbs)]}"
                    f" {i // len(verbs)} times\n")
    with open(os.path.join(d, names["ann"]), "w") as f:
        f.write("\n".join(clips) + "\n")


def write_humanml3d_tree(root, n, T, seed, feats=263, dataset="human_ml3d"):
    """A synthetic HumanML3D (or KIT-ML: ``feats`` 251, ``dataset`` kit_ml)
    tree in the released layout: datasets/<dataset>/{motions/<name>.npy
    [length, feats] (lengths 40 to T), texts/<name>.txt (two captions),
    tokens/<name>.txt ('word/POS' lines, one a caption), test.txt, mean.npy,
    std.npy}."""
    import numpy as np

    rng = np.random.RandomState(seed)
    d = os.path.join(root, "datasets", dataset)
    for sub in ("motions", "texts", "tokens"):
        os.makedirs(os.path.join(d, sub), exist_ok=True)
    np.save(os.path.join(d, "mean.npy"), np.zeros(feats, np.float32))
    np.save(os.path.join(d, "std.npy"), np.ones(feats, np.float32))
    verbs = [("walks", "walk"), ("jumps", "jump"), ("waves", "wave"), ("kicks", "kick"),
             ("turns", "turn"), ("runs", "run"), ("crouches", "crouch"), ("claps", "clap")]
    names = [f"{i:06d}" for i in range(n)]
    for i, name in enumerate(names):
        length = int(rng.randint(min(40, T), T + 1))
        np.save(os.path.join(d, "motions", name + ".npy"),
                (rng.randn(length, feats) * 0.5).astype(np.float32))
        caps, toks = [], []
        for j in range(2):
            (v1, l1), (v2, l2) = verbs[(i + j) % len(verbs)], verbs[(3 * i + j + 1) % len(verbs)]
            caps.append(f"a person {v1} then {v2} {i // len(verbs)} times")
            toks.append(f"a/DET person/NOUN {l1}/VERB then/ADV {l2}/VERB "
                        f"{i // len(verbs)}/NUM time/NOUN")
        for sub, lines in (("texts", caps), ("tokens", toks)):
            with open(os.path.join(d, sub, name + ".txt"), "w") as f:
                f.write("\n".join(lines) + "\n")
    with open(os.path.join(d, "test.txt"), "w") as f:
        f.write("\n".join(names) + "\n")


def load_tool(name):
    """tools/<name>.py as a module."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(name, os.path.join(ROOT, "tools",
                                                                     name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def phase_eval(torch, full_cfg, sd, dev="cuda", config=CONFIG, clips=EVAL_CLIPS):
    """Phase 9: the protocol evaluation of tools/torch_test.py on ``config``
    (whose model ``full_cfg`` is), with checks."""
    import tempfile

    import numpy as np
    from motioncraft_tpu_torch.eval.models import T2MContrastiveModel_SMPLX
    from motioncraft_tpu_torch.ops import launch_counts, reset_launch_counts
    from motioncraft_tpu_torch.registry import build_architecture
    from motioncraft_tpu_torch.utils.checkpoint import save_params
    from motioncraft_tpu_torch.utils.convert import to_jax_params

    torch_test = load_tool("torch_test")
    cfg = full_cfg["model"]
    T = cfg["model"]["max_seq_len"]
    ev_cfg = {k: v for k, v in full_cfg["data"]["test"]["eval_cfg"]["evaluator_model"].items()
              if k not in ("type", "init_cfg")}
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        tree = os.path.join(tmp, "data")
        write_motionx_tree(tree, clips, T, SEED)
        with skip_init(torch):
            mem = build_architecture(cfg, device=dev)
        mem.model.load_state_dict(sd, strict=True)
        params = snapshot(tmp, "params.npz", ("t2m", id(sd)),
                          lambda path: save_params(path, mem.model))
        # a full-width evaluator, seeded, as the native .npz snapshot
        ev = T2MContrastiveModel_SMPLX(**ev_cfg, seed=SEED, device="cpu")
        evaluator = os.path.join(tmp, "evaluator.npz")
        save_params(evaluator, {"motion": {"params": to_jax_params(ev.motion_module.state_dict())},
                                "text": {"params": to_jax_params(ev.text_module.state_dict())}})
        n_ev = sum(p.numel() for m in (ev.motion_module, ev.text_module) for p in m.parameters())
        print(f"[eval] {clips} clips of {T} x 322, the flagship's weights "
              f"({os.path.getsize(params) / 2**20:.0f} MiB) and a {n_ev / 1e6:.1f} M-parameter "
              f"evaluator written in {time.perf_counter() - t0:.1f} s")
        metrics = [dict(type="R Precision", batch_size=32, top_k=3),
                   dict(type="Matching Score", batch_size=32), dict(type="FID", emb_scale=1.0),
                   dict(type="Diversity", num_samples=clips // 2)]
        opts = [f"data.test.data_prefix={tree}", "data.test.ann_file=ann.txt",
                "data.test.motion_dir=motions", "data.test.text_dir=texts",
                "data.test.eval_cfg.replication_times=1",
                f"data.test.eval_cfg.metrics={metrics!r}",
                "data.test.eval_cfg.evaluator_model.init_cfg="
                + repr(dict(type="Pretrained", checkpoint=evaluator))]
        argv = [config, os.path.join(tmp, "ddim"), "--device", dev, "--batch-size", str(BATCH),
                "--checkpoint", params, "--seed", str(SEED), "--cfg-options", *opts]
        reset_launch_counts()
        run = checkpoint_run(torch, torch_test.main, argv)
        counts = launch_counts()
        out, loaded = run["out"], run["arch"]
        n = len(run["results"])
        metric = {k: v for k, v in out.items() if k not in ("flags", "protocol")}
        print(f"[eval] metrics {json.dumps(metric)}; flags {json.dumps(out['flags'])}")
        print(f"[eval] {n} samples: sampling {run['sample_s']:.3f} s "
              f"({n / run['sample_s']:.3f} samples/s), evaluation {run['eval_s']:.3f} s; "
              f"sampling share {run['sample_s'] / (run['sample_s'] + run['eval_s']):.3f}; "
              f"launches {counts}")
        check(n == clips and len(metric) == 12, f"{n} results, metrics {sorted(metric)}")
        check(all(np.isfinite(v) for v in metric.values()), f"non-finite metrics {metric}")
        batches = -(-clips // BATCH)
        steps, layers = loaded.diffusion_test.num_timesteps, loaded.model.num_layers
        want = dict.fromkeys(counts, 0) | sampling_counts(batches, batches * steps, layers)
        check(counts == want, f"eval launch counts {counts} != expected {want}")

        # the loaded model against the in-memory one: one forward, same noise
        batch = requests(BATCH, SEED + 300, T)
        g = torch.Generator(device=dev).manual_seed(SEED + 9)
        x = torch.randn(batch["motion"].shape, generator=g, device=dev)
        ts = torch.full((BATCH,), 499, dtype=torch.long, device=dev)
        outs = []
        for a in (loaded, mem):
            with torch.no_grad():
                xf = a.encode_text(batch["text_ids"])
                outs.append(a.model(x, ts, motion_mask=a._tensor(batch["motion_mask"]),
                                    motion_length=a._tensor(batch["motion_length"]),
                                    xf_out=xf, text_feats=a.model.precompute_text_feats(xf)))
        diff = float((outs[0] - outs[1]).abs().max())
        print(f"[eval] loaded vs in-memory flagship forward, B={BATCH}: max abs diff {diff:.3e}"
              f" (bit for bit: {torch.equal(outs[0], outs[1])})")
        check(torch.equal(outs[0], outs[1]), "the loaded weights do not give the in-memory output")
        del mem, loaded, outs

        # the evaluator on the card against the CPU, one batch of results
        card_ev = run["dataset"].evaluator_model
        cpu_ev = T2MContrastiveModel_SMPLX(**ev_cfg, device="cpu",
                                           init_cfg=dict(type="Pretrained", checkpoint=evaluator))
        check(card_ev.device.type == dev and card_ev.pretrained_loaded, "evaluator not loaded")
        res = run["results"][:BATCH]
        motion = np.stack([r["pred_motion"] for r in res])
        lengths = np.array([int(r["motion_length"].reshape(-1)[0]) for r in res])
        texts = [r["text"] for r in res]
        for what, a, b in (("encode_motion", card_ev.encode_motion(motion, lengths),
                            cpu_ev.encode_motion(motion, lengths)),
                           ("encode_text", card_ev.encode_text(texts), cpu_ev.encode_text(texts))):
            scale = max(1.0, float(b.abs().max()))
            diff = float((a.cpu() - b).abs().max())
            print(f"[eval] evaluator {what} B={BATCH}: card vs CPU max abs diff {diff:.3e} "
                  f"(tol {MODEL_REL_TOL} x {scale:.4g})")
            check(diff <= MODEL_REL_TOL * scale, f"evaluator {what} card vs CPU: {diff}")
        del run

        gt_argv = [config, os.path.join(tmp, "gt"), "--device", dev, "--batch-size", str(BATCH),
                   "--seed", str(SEED), "--cfg-options", "model.inference_type=gt", *opts]
        gt = torch_test.main(gt_argv)
        fid = gt["out"]["FID (mean)"]
        print(f"[eval] GT mode: FID (mean) {fid:.3e} (tol {GT_FID_TOL}); evaluation "
              f"{gt['eval_s']:.3f} s")
        check(abs(fid) <= GT_FID_TOL, f"GT-mode FID {fid}")
    print(f"[eval] phase 9 took {time.perf_counter() - t_phase:.1f} s")
    return counts


def write_finedance_tree(root, names, frames, seed):
    """A synthetic FineDance tree in tools/make_tiny_data.py's layout:
    datasets/finedance/{motion_fea163/<name>.npy [360 + frames, 319],
    music_npy/<name>.npy [360 + frames, 163], label_json/<name>.json,
    mean.npy, std.npy}; ``names`` of the cross-genre test split (phases 10,
    13, 17) or its train split (phase 18)."""
    import numpy as np

    rng = np.random.RandomState(seed)
    d = os.path.join(root, "datasets", "finedance")
    for sub in ("motion_fea163", "music_npy", "label_json"):
        os.makedirs(os.path.join(d, sub), exist_ok=True)
    np.save(os.path.join(d, "mean.npy"), np.zeros(322, np.float32))
    np.save(os.path.join(d, "std.npy"), np.ones(322, np.float32))
    styles = ["Jazz", "Hiphop", "Breaking", "Locking", "Popping", "Dai"]
    for i, name in enumerate(names):
        n = 360 + frames
        np.save(os.path.join(d, "motion_fea163", name + ".npy"),
                (rng.randn(n, 319) * 0.3).astype(np.float32))
        np.save(os.path.join(d, "music_npy", name + ".npy"),
                rng.randn(n, 163).astype(np.float32))
        with open(os.path.join(d, "label_json", name + ".json"), "w") as f:
            json.dump({"name": f"song{name}", "style1": styles[i % len(styles)],
                       "style2": styles[(i + 2) % len(styles)]}, f)


def count_syncs(torch, fn):
    """(fn's result, the places where it waited for the device): CUDA sync
    debug mode warns at every synchronising call."""
    import warnings

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            out = fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return out, [f"{os.path.basename(w.filename)}:{w.lineno}" for w in seen
                 if "synchroniz" in str(w.message)]


def phase_m2d(torch, full_cfg, dev="cuda", config=M2D_CONFIG, tracks=M2D_TRACKS,
              frames=M2D_FRAMES):
    """Phase 10: the M2D long-form evaluation of tools/torch_m2d_test.py on
    ``config`` (whose content ``full_cfg`` is), at R = 1 and at R =
    M2D_REC_BATCH, with checks."""
    import tempfile

    import numpy as np
    from motioncraft_tpu_torch.apis.windowed import (_concat_parts, num_windows,
                                                     windowed_sample, windowed_sample_batch)
    from motioncraft_tpu_torch.diffusion import (RepaintConfig, generator_randn,
                                                 harmonize_schedule)
    from motioncraft_tpu_torch.ops import launch_counts, reset_launch_counts
    from motioncraft_tpu_torch.registry import build_architecture
    from motioncraft_tpu_torch.utils.checkpoint import save_params
    from motioncraft_tpu_torch.utils.convert import fabricate_state_dict

    tool = load_tool("torch_m2d_test")
    cfg = full_cfg["model"]
    window, pre = full_cfg["windowed"]["window"], full_cfg["windowed"]["pre_frames"]
    t_phase = time.perf_counter()
    with skip_init(torch):
        arch = build_architecture(cfg, device=dev)
    sd = fabricate_state_dict(arch.model, seed=SEED)
    arch.model.load_state_dict(sd, strict=True)
    model = arch.model
    print(f"[m2d] {type(model).__name__}: {model.num_layers} base layers + "
          f"{model.copy_blocks_num} control blocks, "
          f"{sum(p.numel() for p in model.parameters()) / 1e6:.1f} M parameters")
    # per sampling call: the text MoE of every base and control layer once,
    # then per denoiser call each layer's motion MoE, SFFN and attention
    layers = model.num_layers + model.copy_blocks_num
    steps = arch.diffusion_test.num_timesteps
    rp = RepaintConfig(overlap_len=pre)
    outpaint_calls = sum(d for _, d in harmonize_schedule(steps, rp))
    wins = num_windows(frames, window, pre)
    calls = steps + (wins - 1) * outpaint_calls  # denoiser calls a track

    def want_counts(groups):
        per = {"moe_route": groups * layers * (calls + wins),
               "grouped_ffn": groups * layers * (calls + wins),
               "head_ffn": groups * layers * calls,
               "stma_linear_attention": groups * layers * calls}
        return {k: per.get(k, 0) for k in launch_counts()}

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        tree = os.path.join(tmp, "data")
        write_finedance_tree(tree, tracks, frames, SEED)
        params = snapshot(tmp, "params.npz", (config, SEED),
                          lambda path: save_params(path, model))
        print(f"[m2d] {len(tracks)} tracks of 360 + {frames} frames and the weights "
              f"({os.path.getsize(params) / 2**20:.0f} MiB) written in "
              f"{time.perf_counter() - t0:.1f} s; {wins} windows a track, "
              f"{calls} denoiser calls ({steps} + {wins - 1} x {outpaint_calls})")
        runs = {}
        for R in (1, M2D_REC_BATCH):
            argv = [config, "--device", dev, "--checkpoint", params, "--seed", str(SEED),
                    "--work-dir", os.path.join(tmp, f"R{R}"), "--recording-batch", str(R),
                    "--cfg-options", f"data.test.data_prefix={tree}"]
            reset_launch_counts()
            run = checkpoint_run(torch, tool.main, argv)
            counts = launch_counts()
            out = run["out"]
            groups = -(-len(tracks) // R)
            n_win = run["windows"] * R  # track windows sampled
            print(f"[m2d] R={R}: {run['windows']} window batches ({n_win} track windows) in "
                  f"{run['sample_s']:.3f} s: {run['sample_s'] / run['windows'] * 1e3:.1f} ms "
                  f"a window batch, {n_win * 60 / run['sample_s']:.1f} windows per minute; "
                  f"evaluation {run['eval_s']:.3f} s, sampling share "
                  f"{run['sample_s'] / (run['sample_s'] + run['eval_s']):.3f}; launches {counts}")
            metric = {k: v for k, v in out.items() if k not in ("flags", "protocol")}
            print(f"[m2d] R={R} metrics {json.dumps(metric)}; flags {json.dumps(out['flags'])}")
            check(set(out) == {"FID_whole", "FID_hands", "Diversity", "protocol", "flags"}
                  and set(out["flags"]) == {"untrained_evaluator", "hash_tokenizer",
                                            "int8_weights", "step_cache"},
                  f"metrics.json keys {sorted(out)} / {sorted(out['flags'])}")
            check(all(np.isfinite(v) for v in metric.values()), f"non-finite metrics {metric}")
            check(len(run["preds"]) == len(tracks)
                  and all(p.shape == (frames, 322) and np.isfinite(p).all()
                          for p in run["preds"]), "predictions of the wrong shape or not finite")
            want = want_counts(groups)
            check(counts == want, f"R={R} launch counts {counts} != expected {want}")
            runs[R] = {"counts": counts, "sample_s": run["sample_s"], "eval_s": run["eval_s"],
                       "windows": run["windows"]}
            infos = run["infos"]
            del run

    # windowed_sample_batch at R = 1 against windowed_sample, same draws,
    # over the first windows of one track; neither waits for the device in
    # its window loop (the one wait is the copy of the result)
    arch.repaint_cfg = rp
    music = infos[0]["c"]
    short = window + 2 * (window - pre)
    mwb = tool.make_window_batch_fn(music, infos[0]["text"][0], window)
    kw = dict(window=window, pre_frames=pre, repaint=rp)
    outs = {}
    with parity_schedule(cfg, arch):  # the check's length does not matter
        for label, fn in (("single", lambda r: windowed_sample(arch, mwb, total_frames=short,
                                                               randn=r, **kw)),
                          ("batch", lambda r: windowed_sample_batch(
                              arch, [mwb], [short], randn=r, precompute_condition=False,
                              **kw)[0])):
            randn = generator_randn(torch.Generator(device=dev).manual_seed(SEED + 11), dev)
            outs[label], syncs = count_syncs(torch, lambda: fn(randn))
            print(f"[m2d] {label} sampler, {num_windows(short, window, pre)} windows at "
                  f"respace {PARITY_RESPACE}: {len(syncs)} waits for the device {syncs}")
            check(len(syncs) <= 1, f"the {label} window loop waits for the device: {syncs}")
    check(np.array_equal(outs["single"], outs["batch"]),
          "windowed_sample_batch (R = 1) differs from windowed_sample")
    print("[m2d] windowed_sample_batch at R = 1 equals windowed_sample bit for bit")

    def window_batch(R, w):
        mwbs = [tool.make_window_batch_fn(i["c"], i["text"][0], window) for i in infos[:R]]
        start = w * (window - pre)
        return {k: torch.as_tensor(v) for k, v in
                _concat_parts([m(start, start + window) for m in mwbs]).items()}

    window_parity(torch, cfg, arch, sd, window_batch, window, pre, "m2d", (M2D_PARITY_R,))
    print(f"[m2d] phase 10 took {time.perf_counter() - t_phase:.1f} s")
    return runs


@contextlib.contextmanager
def parity_schedule(cfg, *archs):
    """``archs`` (built from the model config ``cfg``) sampling on
    PARITY_RESPACE in place of the config's respacing, put back after."""
    from motioncraft_tpu_torch.diffusion import build_diffusion

    saved = [a.diffusion_test for a in archs]
    short = dict(cfg["diffusion_test"], respace=PARITY_RESPACE)
    for a in archs:
        a.diffusion_test = build_diffusion(short, device=a.device)
    try:
        yield
    finally:
        for a, d in zip(archs, saved):
            a.diffusion_test = d


def window_parity(torch, cfg, arch, sd, window_batch, window, pre, tag, rec_batches,
                  extras=()):
    """Card vs CPU on a long-form path, the CPU's MoE gates fed the card's
    gate logits (as phase 6), both devices on the same draws: ``extras``
    ((what, fn(arch)) without gate calls, such as a condition encoder), one
    ControlNet CFG forward (c on, one recording), then one whole outpainted
    window (window 1 of its recordings, outpainted from a seeded previous
    window) for each R of ``rec_batches`` in lockstep, the condition of R > 1
    encoded once for the batch as windowed_sample_batch encodes a chunk's
    (``c_enc``), on PARITY_RESPACE's schedule.  ``window_batch(R, w)`` is
    window w of the first R recordings as CPU tensors."""
    from motioncraft_tpu_torch.models.moe import CosineTopGate
    from motioncraft_tpu_torch.registry import build_architecture

    with skip_init(torch):
        cpu = build_architecture(cfg, device="cpu")
    cpu.model.load_state_dict(sd, strict=True)
    cpu.repaint_cfg = arch.repaint_cfg
    g = torch.Generator().manual_seed(SEED + 12)
    card_logits, replayed = [], []

    def record(mod, inp, out):
        card_logits.append(out.cpu())

    def replay(mod, inp, out):
        want = card_logits[len(replayed)]
        replayed.append(out)
        return want

    def compare(what, fn, gates=True):
        """fn(arch) on the card, then on the CPU; the results within tol."""
        outs, pinned = {}, len(card_logits)
        for label, a, hook in (("cuda", arch, record), ("cpu", cpu, replay)):
            handles = [m.register_forward_hook(hook) for m in a.modules()
                       if isinstance(m, CosineTopGate)]
            try:
                with torch.no_grad():
                    outs[label] = fn(a).cpu()
            finally:
                for h in handles:
                    h.remove()
        check(len(replayed) == len(card_logits) > pinned or not gates,
              "gate calls differ between devices")
        got, want = outs["cuda"], outs["cpu"]
        check(got.shape == want.shape and torch.isfinite(got).all(), f"{what}: {got.shape}")
        scale = max(1.0, float(want.abs().max()))
        diff = float((got - want).abs().max())
        print(f"[{tag}-parity] {what}: card vs CPU max abs diff {diff:.3e} "
              f"(tol {MODEL_REL_TOL} x {scale:.4g}; {len(card_logits) - pinned} gate "
              f"calls pinned)")
        check(diff <= MODEL_REL_TOL * scale, f"{what} card vs CPU: {diff} > tol")

    for what, fn in extras:
        compare(what, fn, gates=False)
    batch = window_batch(1, 0)
    x = torch.randn(1, window, 322, generator=g)

    def forward(a):
        b = {k: v.to(a.device) for k, v in batch.items()}
        xf = a.encode_text(b["text_ids"])
        return a.model(x.to(a.device), torch.full((1,), 499, device=a.device),
                       motion_mask=b["motion_mask"], xf_out=xf,
                       text_feats=a.model.precompute_text_feats(xf), c=b["c"])

    compare(f"ControlNet CFG forward, 2 x {window}, c on", forward)

    # a window's draws: its noise, then one a step (57 outpainting and 27
    # re-noising ones at DDIM-50; 9 and 3 at PARITY_RESPACE's DDIM-10)
    with parity_schedule(cfg, arch, cpu):
        outpaint_windows(torch, arch, window_batch, window, pre, rec_batches, g, compare)


def outpaint_windows(torch, arch, window_batch, window, pre, rec_batches, g, compare):
    """window_parity's outpainted windows, one for each R of
    ``rec_batches``, on ``arch``'s schedule."""
    from motioncraft_tpu_torch.diffusion import Outpainting, Replay, harmonize_schedule

    steps = len(harmonize_schedule(arch.diffusion_test.num_timesteps, arch.repaint_cfg))
    mask = (torch.arange(window) < pre).reshape(1, window, 1)
    for R in rec_batches:
        batch_r = window_batch(R, 1)
        last = torch.randn(R, window, 322, generator=g)
        gt = torch.cat([last[:, -pre:], torch.zeros(R, window - pre, 322)], dim=1)
        draws = [torch.randn(R, window, 322, generator=g) for _ in range(1 + steps)]

        def outpaint(a):
            b = {k: v.to(a.device) for k, v in batch_r.items()}
            if R > 1:
                b["c_enc"] = a.model.encode_condition(b.pop("c"), window)
            source = Replay(draws, a.device)
            out = a.sample(b, randn=source, outpainting=Outpainting(
                mask=mask.to(a.device), gt=gt.to(a.device)))
            check(source.done(), f"the window took {source.used} of {len(draws)} draws")
            return out

        compare(f"outpainted window, R = {R} ({2 * R} x {window}), {steps} RePaint steps"
                + (", condition encoded for the batch" if R > 1 else ""), outpaint)


def write_smplx_npz(path, seed):
    """An SMPL-X body model npz at the neutral model's sizes (SMPLX_SIZES;
    55 joints, the SMPL-X tree, hand means), seeded: the real asset is not
    in the repository."""
    import numpy as np
    from motioncraft_tpu_torch.ops.fk import SMPLX_PARENTS

    rng = np.random.RandomState(seed)
    V, J = SMPLX_SIZES["vertices"], len(SMPLX_PARENTS)
    regressor = rng.rand(J, V)
    weights = rng.rand(V, J) ** 8  # each vertex led by a few joints
    np.savez(path,
             v_template=(rng.randn(V, 3) * 0.3).astype(np.float32),
             shapedirs=(rng.randn(V, 3, SMPLX_SIZES["shapedirs"]) * 0.01).astype(np.float32),
             posedirs=(rng.randn(V, 3, SMPLX_SIZES["posedirs"]) * 0.001).astype(np.float32),
             J_regressor=regressor / regressor.sum(1, keepdims=True),
             weights=weights / weights.sum(1, keepdims=True),
             kintree_table=np.stack([np.where(SMPLX_PARENTS < 0, 2 ** 32 - 1, SMPLX_PARENTS),
                                     np.arange(J)]).astype(np.int64),
             hands_meanl=rng.randn(45) * 0.1, hands_meanr=rng.randn(45) * 0.1,
             f=rng.randint(0, V, (SMPLX_SIZES["faces"], 3)).astype(np.int64))


def write_beat2_tree(root, n, frames, seed, train=0, train_frames=0, data_dir=None,
                     smplx=True):
    """A synthetic BEAT2 tree in the layout data/beat2.py reads (under
    ``data_dir``, default root/beat2), n test recordings of speaker 2 of
    ``frames`` frames and ``train`` train recordings of ``train_frames``:
    smplxflame_30/<name>.npz (poses [frames, 165], expressions [frames,
    100], trans, betas [300]), wave16k/<name>.wav (16 kHz speech-like noise
    with a syllable burst every 0.2-0.4 s, so that onsets fire),
    textgrid/<name>.TextGrid (a word every 0.4 s),
    weights/mean_vel_smplxflame_30.npy, the split csv, mean/std stats and
    (with ``smplx``) an SMPL-X npz; returns the path of its
    st_mogen_emage-schema yaml."""
    import numpy as np
    from scipy.io import wavfile

    rng = np.random.RandomState(seed)
    d = data_dir or os.path.join(root, "beat2")
    for sub in ("smplxflame_30", "wave16k", "textgrid", "weights"):
        os.makedirs(os.path.join(d, sub), exist_ok=True)
    recs = ([(f"2_scott_0_{i + 1}_{i + 1}", "test", frames) for i in range(n)]
            + [(f"2_scott_1_{i + 1}_{i + 1}", "train", train_frames) for i in range(train)])
    with open(os.path.join(d, "train_test_split.csv"), "w") as f:
        f.write("id,type\n" + "".join(f"{name},{split}\n" for name, split, _ in recs))
    vocab = ["so", "the", "point", "is", "that", "we", "really", "need", "to", "talk",
             "about", "gestures", "and", "speech", "today"]
    sr = 16000
    for i, (name, _, frames) in enumerate(recs):
        np.savez(os.path.join(d, "smplxflame_30", name + ".npz"),
                 poses=(rng.randn(frames, 165) * 0.2).astype(np.float32),
                 expressions=(rng.randn(frames, 100) * 0.3).astype(np.float32),
                 trans=(rng.randn(frames, 3) * 0.05).astype(np.float32),
                 betas=(rng.randn(300) * 0.5).astype(np.float32))
        n_samples = int(frames / 30 * sr)
        wav = rng.randn(n_samples) * 0.01
        at = int(rng.randint(1000, 4000))
        while at < n_samples:
            span = min(2400, n_samples - at)
            wav[at:at + span] += (rng.randn(span) * 0.4 * np.exp(-np.arange(span) / 600))
            at += int(rng.randint(3200, 6400))
        wavfile.write(os.path.join(d, "wave16k", name + ".wav"), sr,
                      (np.clip(wav, -1, 1) * 32767).astype(np.int16))
        seconds = frames / 30
        words = [(k * 0.4, min((k + 1) * 0.4, seconds), vocab[(i + k) % len(vocab)])
                 for k in range(int(seconds / 0.4))]
        with open(os.path.join(d, "textgrid", name + ".TextGrid"), "w") as f:
            f.write('File type = "ooTextFile"\nObject class = "TextGrid"\n\nxmin = 0\n'
                    f'xmax = {seconds}\ntiers? <exists>\nsize = 1\nitem []:\n'
                    f'    item [1]:\n        class = "IntervalTier"\n        name = "words"\n'
                    f'        xmin = 0\n        xmax = {seconds}\n'
                    f'        intervals: size = {len(words)}\n')
            for k, (a, b, w) in enumerate(words):
                f.write(f"        intervals [{k + 1}]:\n            xmin = {a}\n"
                        f'            xmax = {b}\n            text = "{w}"\n')
    np.save(os.path.join(d, "weights", "mean_vel_smplxflame_30.npy"),
            rng.uniform(0.3, 0.8, 55).astype(np.float32))
    np.save(os.path.join(root, "mean.npy"), np.zeros(322, np.float32))
    np.save(os.path.join(root, "std.npy"), np.ones(322, np.float32))
    smplx_path = os.path.join(root, "SMPLX_NEUTRAL_2020.npz")
    if smplx:
        write_smplx_npz(smplx_path, seed)
    path = os.path.join(root, "beat2.yaml")
    with open(path, "w") as f:
        f.write(f"data_path: {d}/\npose_length: 64\nstride: 20\npre_frames: 4\n"
                "pose_fps: 30\naudio_sr: 16000\naudio_rep: onset+amplitude\n"
                "pose_rep: smplxflame_30\ntraining_speakers: [2]\n"
                + (f"smplx_model_path: {smplx_path}\n" if smplx else "")
                + f"mean_pose_path: {root}/mean.npy\nstd_pose_path: {root}/std.npy\n")
    return path


def wav_encoder_flops(torch, encoder, wav):
    """The multiply-adds x 2 of ``encoder``'s convolutions on ``wav``,
    counted from each Conv1d's output shape."""
    flops = [0]

    def count(mod, inp, out):
        flops[0] += 2 * out.numel() * mod.in_channels * mod.kernel_size[0]

    handles = [m.register_forward_hook(count) for m in encoder.modules()
               if isinstance(m, torch.nn.Conv1d)]
    with torch.no_grad():
        encoder(wav)
    for h in handles:
        h.remove()
    return flops[0]


def phase_s2g(torch, full_cfg, dev="cuda", config=S2G_CONFIG, recordings=S2G_RECORDINGS,
              frames=S2G_FRAMES):
    """Phase 11: the S2G long-form evaluation of tools/torch_s2g_test.py on
    ``config`` (whose content ``full_cfg`` is), at R = 1 and at R =
    S2G_REC_BATCH, with checks."""
    import tempfile

    import numpy as np
    from motioncraft_tpu_torch.apis.windowed import (_concat_parts, num_windows,
                                                     windowed_sample, windowed_sample_batch)
    from motioncraft_tpu_torch.diffusion import (RepaintConfig, generator_randn,
                                                 harmonize_schedule)
    from motioncraft_tpu_torch.models.blocks import WavEncoder
    from motioncraft_tpu_torch.ops import launch_counts, reset_launch_counts
    from motioncraft_tpu_torch.registry import build_architecture
    from motioncraft_tpu_torch.utils.checkpoint import save_params
    from motioncraft_tpu_torch.utils.convert import fabricate_state_dict

    tool = load_tool("torch_s2g_test")
    cfg = full_cfg["model"]
    win_cfg = full_cfg["windowed"]
    window, pre = win_cfg["window"], win_cfg["pre_frames"]
    fps, spf = win_cfg["pose_fps"], win_cfg["audio_sr"] // win_cfg["pose_fps"]
    t_phase = time.perf_counter()
    with skip_init(torch):
        arch = build_architecture(cfg, device=dev)
    sd = fabricate_state_dict(arch.model, seed=SEED)
    arch.model.load_state_dict(sd, strict=True)
    model = arch.model
    enc = model.condition_pre_encoder
    print(f"[s2g] {type(model).__name__}: {model.num_layers} base layers + "
          f"{model.copy_blocks_num} control blocks, "
          f"{sum(p.numel() for p in model.parameters()) / 1e6:.1f} M parameters "
          f"({sum(p.numel() for p in enc.parameters()) / 1e6:.1f} M in the WavEncoder, "
          f"{sum(1 for k in sd if k.endswith('running_var'))} BatchNorm statistics)")
    layers = model.num_layers + model.copy_blocks_num
    steps = arch.diffusion_test.num_timesteps
    rp = RepaintConfig(overlap_len=pre)
    outpaint_calls = sum(d for _, d in harmonize_schedule(steps, rp))
    wins = num_windows(frames, window, pre)
    calls = steps + (wins - 1) * outpaint_calls  # denoiser calls a recording

    def want_counts(groups):
        per = {"moe_route": groups * layers * (calls + wins),
               "grouped_ffn": groups * layers * (calls + wins),
               "head_ffn": groups * layers * calls,
               "stma_linear_attention": groups * layers * calls}
        return {k: per.get(k, 0) for k in launch_counts()}

    # the WavEncoder's calls: once a sampling call (R = 1: a window), or once
    # a chunk of windows for a lockstep batch, never a denoiser step
    enc_calls, encoder_forward = [0], WavEncoder.forward

    def counted_forward(self, wav):
        enc_calls[0] += 1
        return encoder_forward(self, wav)

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        yaml_path = write_beat2_tree(tmp, recordings, frames, SEED)
        params = snapshot(tmp, "params.npz", (config, SEED),
                          lambda path: save_params(path, model))
        print(f"[s2g] {recordings} recordings of {frames} frames, an SMPL-X npz "
              f"({SMPLX_SIZES['vertices']} vertices) and the weights "
              f"({os.path.getsize(params) / 2**20:.0f} MiB) written in "
              f"{time.perf_counter() - t0:.1f} s; {wins} windows a recording, "
              f"{calls} denoiser calls ({steps} + {wins - 1} x {outpaint_calls})")
        runs = {}
        for R in (1, S2G_REC_BATCH):
            argv = [config, "--device", dev, "--checkpoint", params, "--seed", str(SEED),
                    "--beats2-args", yaml_path, "--work-dir", os.path.join(tmp, f"R{R}"),
                    "--recording-batch", str(R)]
            reset_launch_counts()
            enc_calls[0] = 0
            WavEncoder.forward = counted_forward
            try:
                run = checkpoint_run(torch, tool.main, argv)
            finally:
                WavEncoder.forward = encoder_forward
            counts = launch_counts()
            out = run["out"]
            groups = -(-recordings // R)
            n_win = run["windows"] * R  # recording windows sampled
            print(f"[s2g] R={R}: {run['windows']} window batches ({n_win} recording windows) "
                  f"in {run['sample_s']:.3f} s: {run['sample_s'] / run['windows'] * 1e3:.1f} ms "
                  f"a window batch, {n_win * 60 / run['sample_s']:.1f} windows per minute; "
                  f"metric stage {run['eval_s']:.3f} s, sampling share "
                  f"{run['sample_s'] / (run['sample_s'] + run['eval_s']):.3f}; WavEncoder "
                  f"calls {enc_calls[0]}; launches {counts}")
            metric = {k: v for k, v in out.items() if k not in ("flags", "protocol")}
            print(f"[s2g] R={R} metrics {json.dumps(metric)}; flags {json.dumps(out['flags'])}")
            check(set(out) == {"L1div", "BeatAlign", "facial_L2", "facial_LVD", "FID_whole",
                               "FID_hands", "protocol", "flags"}
                  and set(out["flags"]) == {"smplx_vertices", "mmae_asset",
                                            "untrained_evaluator", "hash_tokenizer",
                                            "int8_weights", "step_cache"},
                  f"metrics.json keys {sorted(out)} / {sorted(out['flags'])}")
            check(out["flags"]["smplx_vertices"] and out["flags"]["mmae_asset"]
                  and run["body_model"] is not None, "the SMPL-X route did not run")
            check(all(np.isfinite(v) for v in metric.values()), f"non-finite metrics {metric}")
            check(len(run["preds"]) == recordings
                  and all(p.shape == (frames, 322) and np.isfinite(p).all()
                          for p in run["preds"]), "predictions of the wrong shape or not finite")
            want = want_counts(groups)
            check(counts == want, f"R={R} launch counts {counts} != expected {want}")
            check(enc_calls[0] == (recordings * wins if R == 1 else groups),
                  f"R={R}: the WavEncoder ran {enc_calls[0]} times")
            runs[R] = {"counts": counts, "sample_s": run["sample_s"], "eval_s": run["eval_s"],
                       "windows": run["windows"], "encoder_calls": enc_calls[0]}
            recs = run["recordings"]
            del run

    def window_batch(R, w):
        mwbs = [tool.make_window_batch_fn(r, window, spf, fps) for r in recs[:R]]
        start = w * (window - pre)
        return {k: torch.as_tensor(v) for k, v in
                _concat_parts([m(start, start + window) for m in mwbs]).items()}

    # the encoder on one window: its device time against the f32 bound of
    # its convolutions (cuDNN, TF32 off)
    c1 = window_batch(1, 0)["c"].to(dev)
    with torch.no_grad():
        flops = wav_encoder_flops(torch, enc, c1)
        enc_ms = device_ms(torch, lambda: enc(c1), reps=5)
        enc_call_ms = time_ms(torch, lambda: enc(c1), reps=5)
    bound_ms, bound_by = bound(flops, 4 * (c1.numel() + window * enc.block5.conv1.out_channels
                                           + sum(p.numel() for p in enc.parameters())),
                               F32_PEAK)
    print(f"[s2g] WavEncoder on one window {tuple(c1.shape)}: {flops / 1e9:.2f} GFLOP, "
          f"{enc_ms:.3f} ms on the device ({enc_call_ms:.3f} ms a back-to-back call), "
          f"f32 bound {bound_ms:.3f} ms ({bound_by}, share {bound_ms / enc_ms:.3f})")

    # the samplers at R = 1 over the first windows of one recording, same
    # draws: windowed_sample_batch with the condition per window equals
    # windowed_sample bit for bit; encoded per chunk, within tolerance; none
    # waits for the device in its window loop (the one wait is the copy of
    # the result)
    arch.repaint_cfg = rp
    short = window + 2 * (window - pre)
    mwb = tool.make_window_batch_fn(recs[0], window, spf, fps)
    kw = dict(window=window, pre_frames=pre, repaint=rp)
    outs = {}
    with parity_schedule(cfg, arch):  # the check's length does not matter
        for label, fn in (("single", lambda r: windowed_sample(arch, mwb, total_frames=short,
                                                               randn=r, **kw)),
                          ("batch", lambda r: windowed_sample_batch(
                              arch, [mwb], [short], randn=r, precompute_condition=False,
                              **kw)[0]),
                          ("batch encoded", lambda r: windowed_sample_batch(
                              arch, [mwb], [short], randn=r, **kw)[0])):
            randn = generator_randn(torch.Generator(device=dev).manual_seed(SEED + 11), dev)
            outs[label], syncs = count_syncs(torch, lambda: fn(randn))
            print(f"[s2g] {label} sampler, {num_windows(short, window, pre)} windows at "
                  f"respace {PARITY_RESPACE}: {len(syncs)} waits for the device {syncs}")
            check(len(syncs) <= 1, f"the {label} window loop waits for the device: {syncs}")
    check(np.array_equal(outs["single"], outs["batch"]),
          "windowed_sample_batch (R = 1) differs from windowed_sample")
    scale = max(1.0, float(np.abs(outs["single"]).max()))
    diff = float(np.abs(outs["batch encoded"] - outs["single"]).max())
    print(f"[s2g] windowed_sample_batch at R = 1 equals windowed_sample bit for bit; with "
          f"the condition encoded per chunk: max abs diff {diff:.3e} "
          f"(tol {MODEL_REL_TOL} x {scale:.4g})")
    check(diff <= MODEL_REL_TOL * scale, f"condition encoded per chunk: {diff}")

    def encode(a):
        return a.model.condition_pre_encoder(window_batch(1, 0)["c"].to(a.device))

    window_parity(torch, cfg, arch, sd, window_batch, window, pre, "s2g", (1,),
                  extras=[(f"WavEncoder, one window of {window * spf} samples", encode)])
    runs["encoder"] = {"flops": flops, "ms": enc_ms, "call_ms": enc_call_ms,
                       "bound_ms": bound_ms}
    del arch, model, enc
    runs["wav2vec"] = s2g_wav2vec(torch, cfg, window_batch, window, pre, dev)
    print(f"[s2g] phase 11 took {time.perf_counter() - t_phase:.1f} s")
    return runs


def s2g_wav2vec(torch, cfg, window_batch, window, pre, dev="cuda"):
    """Phase 11's wav2vec ControlNet: ``cfg`` (the S2G model config) with
    ``condition_pre_encode_type='wav2vec'`` (the base-960h Wav2Vec2 at its
    full width) on seeded fabricated weights: the conditioner's device time
    on one window; the conditioner, a ControlNet CFG forward and one
    outpainted window card vs CPU (window_parity); then one window sampled
    on the card at the config's schedule (wall ms)."""
    import copy

    from motioncraft_tpu_torch.diffusion import RepaintConfig
    from motioncraft_tpu_torch.registry import build_architecture
    from motioncraft_tpu_torch.utils.convert import fabricate_state_dict

    t0 = time.perf_counter()
    w_cfg = copy.deepcopy(cfg)
    w_cfg["model"]["condition_encode_cfg"]["condition_pre_encode_type"] = "wav2vec"
    with skip_init(torch):
        arch = build_architecture(w_cfg, device=dev)
    sd = fabricate_state_dict(arch.model, seed=SEED + 13)
    arch.model.load_state_dict(sd, strict=True)
    arch.repaint_cfg = RepaintConfig(overlap_len=pre)
    cond = arch.model.condition_pre_encoder
    n_w2v = sum(p.numel() for p in cond.parameters())
    c1 = window_batch(1, 0)["c"].to(dev)
    with torch.no_grad():
        cond_ms = device_ms(torch, lambda: cond(c1, window), reps=5)

    def encode(a):
        return a.model.condition_pre_encoder(window_batch(1, 0)["c"].to(a.device), window)

    window_parity(torch, w_cfg, arch, sd, window_batch, window, pre, "s2g-wav2vec", (1,),
                  extras=[(f"Wav2Vec2 conditioner, one window of {c1.shape[1]} samples",
                           encode)])
    # one window at the config's schedule, warm after the parity's card runs
    batch = {k: v.to(dev) for k, v in window_batch(1, 0).items()}
    g = torch.Generator(device=dev).manual_seed(SEED + 14)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    with torch.no_grad():
        out = arch.sample(batch, generator=g)
    torch.cuda.synchronize()
    window_ms = (time.perf_counter() - t1) * 1e3
    check(out.shape == (1, window, 322) and torch.isfinite(out).all(),
          f"the wav2vec window: {tuple(out.shape)}")
    print(f"[s2g-wav2vec] Wav2Vec2 conditioner ({n_w2v / 1e6:.1f} M parameters) on one "
          f"window {tuple(c1.shape)}: {cond_ms:.3f} ms on the device; one window sampled on "
          f"the card ({arch.diffusion_test.num_timesteps} steps): {window_ms:.1f} ms wall")
    del arch
    torch.cuda.empty_cache()
    took = time.perf_counter() - t0
    print(f"[s2g-wav2vec] the wav2vec ControlNet took {took:.1f} s")
    return {"conditioner_ms": cond_ms, "window_ms": window_ms, "s": took}


def serve_traffic(torch, srv, T, seed, per_client=SERVE_PER_CLIENT):
    """SERVE_CLIENTS threads, each sending ``per_client`` seeded requests
    one after another (lengths 40-T, seeded prompts), and SERVE_LONG
    long-form requests beside them.  Returns (results per request as
    (length, motion), long results, wall seconds)."""
    import threading

    import numpy as np

    verbs = ["walks", "jumps", "waves", "dances", "kicks", "turns", "sits down",
             "runs in a circle", "crouches", "claps"]
    rng = np.random.RandomState(seed)
    plan = [[(f"a person {verbs[a]} then {verbs[b]}", int(n))
             for a, b, n in zip(rng.randint(0, len(verbs), per_client),
                                rng.randint(0, len(verbs), per_client),
                                rng.randint(min(40, T), T + 1, per_client))]
            for _ in range(SERVE_CLIENTS)]
    results, errors = [], []

    def client(reqs):
        try:
            for text, n in reqs:
                results.append((n, srv.submit(text, n).result(timeout=300)))
        except Exception as e:  # noqa: BLE001 -- reported by the phase
            errors.append(e)

    t0 = time.perf_counter()
    longs = [srv.submit_long(f"a person walks a long way, take {i}", SERVE_LONG_FRAMES)
             for i in range(SERVE_LONG)]
    threads = [threading.Thread(target=client, args=(reqs,)) for reqs in plan]
    for th in threads:
        th.start()
    for th in threads:
        th.join(600)
    long_out = [f.result(timeout=600) for f in longs]
    wall = time.perf_counter() - t0
    check(not errors and not any(th.is_alive() for th in threads), f"clients failed: {errors}")
    return results, long_out, wall


def phase_serve(torch, cfg, sd, dev="cuda"):
    """Phase 12: MotionGenServer over the flagship on the card, one server in
    f32 and one in bf16 (the weights cast, the denoiser in bf16 through
    K1-K3's bf16 instantiations), each warmed up on SERVE_WARM, then the
    same seeded traffic; results, stats and launches checked; one bf16
    forward card vs CPU (gate logits pinned) and bf16 vs f32 on the card."""
    import numpy as np
    from motioncraft_tpu_torch.apis import bf16_cast_
    from motioncraft_tpu_torch.apis.windowed import num_windows
    from motioncraft_tpu_torch.diffusion import RepaintConfig, harmonize_schedule
    from motioncraft_tpu_torch.ops import launch_counts, reset_launch_counts
    from motioncraft_tpu_torch.registry import build_architecture
    from motioncraft_tpu_torch.serving import MotionGenServer
    from motioncraft_tpu_torch.serving.server import covered_frames

    t_phase = time.perf_counter()
    T, D = cfg["model"]["max_seq_len"], cfg["model"]["input_feats"]
    archs = {}
    for dtype in ("f32", "bf16"):
        with skip_init(torch):
            arch = build_architecture(cfg, device=dev)
        arch.model.load_state_dict(sd, strict=True)
        archs[dtype] = bf16_cast_(arch) if dtype == "bf16" else arch
    layers, steps = archs["f32"].model.num_layers, archs["f32"].diffusion_test.num_timesteps
    # a long request: windows of T frames overlapping by the server's 4,
    # window 0 DDIM, each later one outpainted over the RePaint schedule
    pre = 4
    wins = num_windows(covered_frames(SERVE_LONG_FRAMES, T, pre), T, pre)
    rp = RepaintConfig(overlap_len=pre, add_blend=True)
    long_calls = steps + (wins - 1) * sum(d for _, d in harmonize_schedule(steps, rp))
    out = {}
    for dtype, arch in archs.items():
        srv = MotionGenServer(arch, max_seq_len=T, input_feats=D, batch_buckets=SERVE_BUCKETS,
                              seq_buckets=SERVE_SEQ_BUCKETS, max_wait_ms=20.0, seed=SEED,
                              compute_dtype=torch.bfloat16 if dtype == "bf16" else None)
        t0 = time.perf_counter()
        srv.warmup(SERVE_WARM)
        warm = time.perf_counter() - t0
        # one sampling batch of 16 (phase 4's first), warm, in this dtype
        batch16 = requests(BATCH, SEED, T)
        g16 = torch.Generator(device=dev).manual_seed(SEED)
        t0 = time.perf_counter()
        with torch.inference_mode():
            pred16 = arch.sample(batch16, generator=g16,
                                 compute_dtype=srv._compute_dtype).cpu()  # waits for the card
        batch16_ms = (time.perf_counter() - t0) * 1e3
        check(pred16.shape == (BATCH, T, D) and bool(torch.isfinite(pred16).all()),
              f"[serve] {dtype} batch of {BATCH}")
        reset_launch_counts()
        with srv:
            results, long_out, wall = serve_traffic(torch, srv, T, SEED + 40)
            st = srv.stats()
        counts = launch_counts()
        n_req = SERVE_CLIENTS * SERVE_PER_CLIENT + SERVE_LONG
        for n, m in results:
            check(m.shape == (n, D) and np.isfinite(m).all(), f"[serve] {dtype}: {m.shape}")
        for m in long_out:
            check(m.shape == (SERVE_LONG_FRAMES, D) and np.isfinite(m).all(),
                  f"[serve] {dtype} long: {m.shape}")
        check(len(results) == n_req - SERVE_LONG and st["requests"] == n_req,
              f"[serve] {dtype}: {len(results)} results, stats {st}")
        check(abs(st["mean_occupancy"] * st["dispatches"] - n_req) < 1e-6
              and 0 <= st["padding_fraction"] < 1 and st["long_dispatches"] >= 1,
              f"[serve] {dtype}: stats {st}")
        short, n_long = st["dispatches"] - st["long_dispatches"], st["long_dispatches"]
        want = dict.fromkeys(counts, 0) | sampling_counts(
            short + n_long * wins, short * steps + n_long * long_calls, layers,
            "_bf16" if dtype == "bf16" else "")
        print(f"[serve] {dtype}: warm-up of {len(SERVE_WARM) * len(SERVE_SEQ_BUCKETS)} "
              f"bucket pairs {warm:.1f} s; one sampling batch of {BATCH} {batch16_ms:.1f} ms "
              f"wall; {n_req} requests ({SERVE_LONG} long of "
              f"{SERVE_LONG_FRAMES} frames, {wins} windows) in {wall:.3f} s: "
              f"{n_req / wall:.3f} requests/s; latency p50 {st['latency_p50_s']:.3f} s, p95 "
              f"{st['latency_p95_s']:.3f} s; {st['dispatches']} dispatches "
              f"({st['long_dispatches']} long), mean occupancy {st['mean_occupancy']:.3f}, "
              f"padding fraction {st['padding_fraction']:.3f}; launches {counts}")
        check(counts == want, f"[serve] {dtype} launch counts {counts} != expected {want}")
        out[dtype] = {"stats": st, "wall_s": wall, "requests_per_s": n_req / wall,
                      "counts": counts, "warmup_s": warm, "batch16_ms": batch16_ms}

    bf16_parity(torch, cfg, sd, archs)
    print(f"[serve] phase 12 took {time.perf_counter() - t_phase:.1f} s")
    return out


def bf16_parity(torch, cfg, sd, archs):
    """One flagship forward_test (B = 2) in bf16 on the card against the
    CPU's plain bf16 versions, the CPU's gates fed the card's logits, within
    MODEL_BF16_TOL x scale; and the card's bf16 forward against its f32 one
    (reported: bf16 moves near-tied tokens to other experts)."""
    from motioncraft_tpu_torch.apis import bf16_cast_
    from motioncraft_tpu_torch.models.moe import CosineTopGate
    from motioncraft_tpu_torch.registry import build_architecture

    batch = requests(2, SEED + 500, cfg["model"]["max_seq_len"])
    x = torch.randn(batch["motion"].shape, generator=torch.Generator().manual_seed(SEED + 13))
    ts = torch.full((2,), 499, dtype=torch.long)
    logits = {"cuda": [], "f32": []}
    replayed, flips = [], [0, 0]

    def recorder(key):
        def hook(mod, inp, o):
            logits[key].append(o.cpu())
        return hook

    def replay(mod, inp, o):
        want = logits["cuda"][len(replayed)]
        replayed.append(o)
        return want

    def forward(a, dtype):
        with torch.no_grad():
            xf = a.encode_text(batch["text_ids"]).to(dtype)
            return a.model(x.to(a.device, dtype), ts.to(a.device),
                           motion_mask=torch.as_tensor(batch["motion_mask"], device=a.device),
                           motion_length=torch.as_tensor(batch["motion_length"],
                                                         device=a.device),
                           xf_out=xf, text_feats=a.model.precompute_text_feats(xf)).cpu()

    with skip_init(torch):
        cpu = build_architecture(cfg, device="cpu")
    cpu.model.load_state_dict(sd, strict=True)
    bf16_cast_(cpu)
    outs = {}
    for label, a, dtype, hook in (("f32", archs["f32"], torch.float32, recorder("f32")),
                                  ("cuda", archs["bf16"], torch.bfloat16, recorder("cuda")),
                                  ("cpu", cpu, torch.bfloat16, replay)):
        handles = [m.register_forward_hook(hook) for m in a.modules()
                   if isinstance(m, CosineTopGate)]
        try:
            outs[label] = forward(a, dtype)
        finally:
            for h in handles:
                h.remove()
    k = cfg["model"]["ca_block_cfg"]["topk"]
    for a, b in zip(logits["cuda"], logits["f32"]):
        pick = [torch.sort(v, dim=1, descending=True, stable=True).indices[:, :k]
                .sort(dim=1).values for v in (a, b)]
        flips[0] += int((pick[0] != pick[1]).sum())
        flips[1] += pick[0].numel()
    got, want, f32 = outs["cuda"], outs["cpu"], outs["f32"]
    check(got.dtype == torch.float32 and torch.isfinite(got).all(), "bf16 forward")
    check(len(replayed) == len(logits["cuda"]) > 0, "gate calls differ between devices")
    diff_f32 = float((got - f32).abs().max())
    print(f"[serve-parity] bf16 vs f32 forward on the card, B=2: max abs diff {diff_f32:.3e} "
          f"(scale {float(f32.abs().max()):.4g}); expert choices that differ "
          f"{flips[0]} of {flips[1]} (reported, not gated)")
    scale = max(1.0, float(want.abs().max()))
    diff = float((got - want).abs().max())
    print(f"[serve-parity] bf16 forward_test B=2: card vs CPU max abs diff {diff:.3e} "
          f"(tol {MODEL_BF16_TOL} x {scale:.4g}; {len(replayed)} gate calls pinned)")
    check(diff <= MODEL_BF16_TOL * scale, f"bf16 forward card vs CPU: {diff} > tol")


# ---------------------------------------------------------------- phase 13

def cached_counts(calls, tables, layers, copy=0, suffix=""):
    """K1-K4's launches over ``calls`` sampling calls whose denoiser calls
    ran the (step, layer) pairs that ``tables`` (one [denoise steps,
    layers] reuse table a call) do not reuse: per call the text MoE of every
    layer (and control block) once, then per computed pair one motion MoE,
    one SFFN and one attention, a control-injected layer (1..copy) twice
    (its control block and its base block)."""
    weight = [1 + (1 <= i <= copy) for i in range(layers)]
    computed = sum(int(((~t) * weight).sum()) for t in tables)
    text = calls * (layers + copy)
    return {"moe_route": text + computed, f"grouped_ffn{suffix}": text + computed,
            f"head_ffn{suffix}": computed, f"stma_linear_attention{suffix}": computed}


def int8_products(model):
    """(per sampling call, per denoiser call): the int8 products (int_mm
    calls) a W8A8 model runs: one a W8A8 QLinear, two a head of an int8
    SFFN, two an expert of an int8 MoE layer; the text MoEs' once a
    sampling call (hoisted), the rest once a denoiser call."""
    from motioncraft_tpu_torch.models.blocks import SFFN, QLinear
    from motioncraft_tpu_torch.models.moe import MoELayer

    once, per_step = 0, 0
    for name, m in model.named_modules():
        n = 0
        if isinstance(m, QLinear) and not m.weight_only:
            n = 1
        elif isinstance(m, SFFN) and hasattr(m, "w1_scale"):
            n = 2 * m.num_heads
        elif isinstance(m, MoELayer) and hasattr(m, "expert_w1_scale"):
            n = 2 * m.num_experts
        if "text_moe" in name:
            once += n
        else:
            per_step += n
    return once, per_step


def model_bytes(model):
    return sum(t.numel() * t.element_size()
               for t in list(model.parameters()) + list(model.buffers()))


def record_codes(quant, store):
    """Wrap ops.quant.quantize_rows to keep every int8 activation code array
    (on the host), in call order; returns the original."""
    real = quant.quantize_rows

    def wrapped(x):
        xq, ax = real(x)
        store.append(xq.cpu())
        return xq, ax

    quant.quantize_rows = wrapped
    return real


def phase_lowprec(torch, full_cfg, m2d_cfg, arch, sd, dev="cuda", clips=LOWPREC_CLIPS,
                  config=CONFIG, m2d_config=M2D_CONFIG):
    """Phase 13: the step cache and int8 inference on phase 3's flagship
    (``config`` and ``m2d_config`` the files of ``full_cfg`` and
    ``m2d_cfg``)."""
    t_phase = time.perf_counter()
    out = {"cache": lowprec_step_cache(torch, arch)}
    out["int8"] = lowprec_cli(torch, full_cfg, sd, dev, clips, config)
    out["parity"] = lowprec_parity(torch, full_cfg["model"], sd, arch.device)
    out["int_mm"] = int_mm_table(torch, out["int8"]["w8a8"]["shapes"], dev)
    out["m2d"] = lowprec_m2d(torch, m2d_cfg, dev, m2d_config)
    out["serve"] = lowprec_serve(torch, full_cfg["model"], sd, dev)
    print(f"[lowprec] phase 13 took {time.perf_counter() - t_phase:.1f} s")
    return out


def lowprec_step_cache(torch, arch):
    """Two batches of 16 through single_device_test with the step cache:
    all-compute flags equal the uncached sampler bit for bit; at
    reuse_every=2 and with the committed table K1-K4 launch what the flags
    imply, no device wait inside the step loop, wall ms per batch."""
    import numpy as np
    from motioncraft_tpu_torch.apis import single_device_test
    from motioncraft_tpu_torch.diffusion import StepCacheConfig, load_flags, pattern_flags
    from motioncraft_tpu_torch.ops import launch_counts, reset_launch_counts

    T = arch.model.max_seq_len
    steps, layers = arch.diffusion_test.num_timesteps, arch.model.num_layers
    batches = [requests(BATCH, SEED + i, T) for i in range(BATCHES)]
    table = load_flags(STEP_CACHE_TABLE)
    configs = [("uncached", None),
               ("all-compute", StepCacheConfig(reuse_every=1, warmup=1, tail=0)),
               ("reuse_every=2", StepCacheConfig(reuse_every=2)),
               ("table", StepCacheConfig(flags=table))]
    single_device_test(arch, batches[:1], seed=SEED, device=arch.device)  # warm-up
    runs = {}
    for label, sc in configs:
        reset_launch_counts()
        t0 = time.perf_counter()
        res = single_device_test(arch, batches, seed=SEED, device=arch.device, step_cache=sc)
        ms = (time.perf_counter() - t0) / BATCHES * 1e3
        counts = launch_counts()
        preds = np.stack([r["pred_motion"] for r in res])
        check(np.isfinite(preds).all(), f"[cache] {label}: non-finite motion")
        flags = (np.zeros((steps, layers), bool) if sc is None
                 else pattern_flags(steps, layers, sc))
        want = dict.fromkeys(counts, 0) | cached_counts(BATCHES, [flags] * BATCHES, layers)
        print(f"[cache] {label}: {ms:.1f} ms a batch of {BATCH} (wall); "
              f"{int((~flags).sum())} of {flags.size} (step, layer) pairs computed; "
              f"launches {counts}")
        check(counts == want, f"[cache] {label} launch counts {counts} != expected {want}")
        runs[label] = {"ms": ms, "counts": counts, "preds": preds,
                       "computed": int((~flags).sum())}
    check(np.array_equal(runs["all-compute"]["preds"], runs["uncached"]["preds"]),
          "[cache] all-compute flags differ from the uncached sampler")
    check(runs["table"]["computed"] == 83 and runs["reuse_every=2"]["computed"] == 27 * layers,
          f"[cache] computed pairs {runs['table']['computed']} / "
          f"{runs['reuse_every=2']['computed']}")
    for label in ("reuse_every=2", "table"):
        d = np.abs(runs[label]["preds"] - runs["uncached"]["preds"])
        print(f"[cache] {label} against uncached: max abs diff {d.max():.3e}, mean {d.mean():.3e}"
              f" (scale {np.abs(runs['uncached']['preds']).max():.3e})")
    print("[cache] all-compute flags equal the uncached sampler bit for bit")
    if arch.device.type == "cuda":
        # the batch on the card first: its upload from pageable host memory
        # waits, the step loop must not
        batch = {k: torch.as_tensor(v, device=arch.device) for k, v in batches[0].items()
                 if isinstance(v, np.ndarray)}
        g = torch.Generator(device=arch.device).manual_seed(SEED)
        _, syncs = count_syncs(torch, lambda: arch.sample(
            batch, generator=g, step_cache=StepCacheConfig(flags=table)))
        print(f"[cache] one cached sampling call waits for the device {len(syncs)} times {syncs}")
        check(not syncs, f"[cache] the cached step loop waits for the device: {syncs}")
    return {k: {"ms": v["ms"], "counts": v["counts"], "computed": v["computed"]}
            for k, v in runs.items()}


def lowprec_cli(torch, full_cfg, sd, dev, clips, config=CONFIG):
    """tools/torch_test.py --bf16 --int8 (W8A8) and --bf16 --int8 w8 on a
    synthetic tree of ``clips`` clips (an untrained full-width evaluator):
    finite metrics and the stamped keys, K1/K2 launch no time under W8A8,
    the int8 products the model implies, weight bytes, ms a batch."""
    import tempfile

    import numpy as np
    from motioncraft_tpu_torch.ops import launch_counts, quant, reset_launch_counts
    from motioncraft_tpu_torch.utils.checkpoint import save_params

    torch_test = load_tool("torch_test")
    cfg = full_cfg["model"]
    T = cfg["model"]["max_seq_len"]
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        tree = os.path.join(tmp, "data")
        write_motionx_tree(tree, clips, T, SEED + 1)
        from motioncraft_tpu_torch.registry import build_architecture
        with skip_init(torch):
            mem = build_architecture(cfg, device="cpu")
        mem.model.load_state_dict(sd, strict=True)
        f32_bytes = model_bytes(mem.model)
        params = snapshot(tmp, "params.npz", ("t2m", id(sd)),
                          lambda path: save_params(path, mem.model))
        del mem
        # the Diversity metric draws fewer samples than the clips
        small = os.path.join(tmp, "config.py")
        with open(small, "w") as f:
            f.write(f"_base_ = [{config!r}]\n"
                    "data = dict(test=dict(eval_cfg=dict(replication_times=1, metrics=[\n"
                    "    dict(type='R Precision', batch_size=8, top_k=3),\n"
                    "    dict(type='Matching Score', batch_size=8),\n"
                    "    dict(type='FID', emb_scale=1.0),\n"
                    f"    dict(type='Diversity', num_samples={clips // 2})])))\n")
        opts = [f"data.test.data_prefix={tree}", "data.test.ann_file=ann.txt",
                "data.test.motion_dir=motions", "data.test.text_dir=texts"]
        for mode in ("w8a8", "w8"):
            shapes = {}

            def record(a, b, shapes=shapes):
                key = (a.shape[0], a.shape[1], b.shape[1], b.stride(0) == 1)
                shapes[key] = shapes.get(key, 0) + 1

            argv = [small, os.path.join(tmp, mode), "--device", str(dev), "--batch-size",
                    str(BATCH), "--checkpoint", params, "--seed", str(SEED), "--bf16",
                    "--int8", mode, "--cfg-options", *opts]
            reset_launch_counts()
            quant.int_mm.hooks.append(record)
            try:
                run = checkpoint_run(torch, torch_test.main, argv)
            finally:
                quant.int_mm.hooks.remove(record)
            counts = launch_counts()
            # a CPU rehearsal launches nothing: it counts the calls
            n_mm = counts["int_mm"] if torch.device(dev).type == "cuda" else sum(shapes.values())
            res, model = run["out"], run["arch"].model
            n_batches = -(-clips // BATCH)
            steps = run["arch"].diffusion_test.num_timesteps
            layers = model.num_layers
            metric = {k: v for k, v in res.items() if k not in ("flags", "protocol")}
            check(len(run["results"]) == clips and all(np.isfinite(v) for v in metric.values()),
                  f"[int8] {mode}: {len(run['results'])} results, metrics {metric}")
            check(res["flags"]["int8_weights"] == mode and set(res["flags"]) == {
                "untrained_evaluator", "hash_tokenizer", "int8_weights", "step_cache",
                "step_cache_table"}, f"[int8] {mode}: flags {res['flags']}")
            want = dict.fromkeys(counts, 0) | sampling_counts(
                n_batches, n_batches * steps, layers, "_bf16")
            once, per_step = int8_products(model)
            if mode == "w8a8":  # no grouped FFN (slot buffers), no head FFN kernel
                want["grouped_ffn_bf16"] = want["head_ffn_bf16"] = 0
            want_mm = n_batches * (once + steps * per_step)
            if torch.device(dev).type == "cuda":
                want["int_mm"] = want_mm
            n_q, elems = quant.count_quantized(model)
            ms = run["sample_s"] / n_batches * 1e3
            print(f"[int8] bf16 + {mode}: {n_q} int8 weights, {elems / 1e6:.2f} M elements: "
                  f"{elems / 2**20:.1f} MiB int8 against {4 * elems / 2**20:.1f} MiB f32 "
                  f"({2 * elems / 2**20:.1f} MiB bf16); model {model_bytes(model) / 2**20:.1f} "
                  f"MiB against {f32_bytes / 2**20:.1f} MiB f32; {ms:.1f} ms a batch of "
                  f"{BATCH} (wall); launches {counts}; int8 products {n_mm} "
                  f"({once} + {steps} x {per_step} a batch)")
            print(f"[int8] {mode} metrics {json.dumps(metric)}")
            check(counts == want, f"[int8] {mode} launch counts {counts} != expected {want}")
            check(n_mm == want_mm and (n_mm > 0) == (mode == "w8a8"),
                  f"[int8] {mode}: {n_mm} int8 products, expected {want_mm}")
            out[mode] = {"ms": ms, "counts": counts, "int_mm": n_mm, "weights": n_q,
                         "int8_bytes": elems, "model_bytes": model_bytes(model),
                         "f32_bytes": f32_bytes, "shapes": shapes}
            del run, model
    return out


def lowprec_parity(torch, cfg, sd, dev):
    """One W8A8 forward_test (f32, B = 2; two input draws before phase 24
    came) and one W8 on the
    card against the CPU, every gate fed the card's logits (as phase 6); both devices
    quantize to the same int8 bytes and scales.  W8 holds within
    MODEL_REL_TOL x scale.  W8A8 holds to readings of the same run (see
    W8A8_SENS): card vs CPU within W8A8_SENS times the card's own W8A8
    output moved by a one-ulp change of its input and of every activation
    before its quantization, in max and mean abs difference and in the
    share of activation codes that differ; the first
    quantized activation that differs at all by one code at most, in at
    most W8A8_FIRST_SHARE of its codes.  The card's float forward (the
    same weights unquantized, the gates pinned alike) must break the mean
    limit, or the check could not tell W8A8 from float."""
    from motioncraft_tpu_torch.apis import int8_quantize_
    from motioncraft_tpu_torch.models.moe import CosineTopGate
    from motioncraft_tpu_torch.ops import quant
    from motioncraft_tpu_torch.registry import build_architecture

    ts = torch.full((2,), 499, dtype=torch.long)
    inf = float("inf")

    def forward(a, batch, inp, logits, codes=None, nudge=False):
        """a's test forward of ``inp``; with no ``logits`` yet, its gate
        logits are recorded into it, else each gate returns the recorded
        ones; ``codes`` collects the int8 activation codes; ``nudge`` moves
        every activation one ulp up before its quantization."""
        record, calls = not logits, []

        def gate(mod, args, o):
            if record:
                logits.append(o.cpu())
                return None
            calls.append(None)
            return logits[len(calls) - 1].to(o.device)

        handles = [m.register_forward_hook(gate) for m in a.modules()
                   if isinstance(m, CosineTopGate)]
        real = record_codes(quant, codes) if codes is not None else None
        if nudge:
            rec = quant.quantize_rows
            quant.quantize_rows = lambda t: rec(torch.nextafter(t, torch.full_like(t, inf)))
        try:
            with torch.no_grad():
                xf = a.encode_text(batch["text_ids"])
                out = a.model(
                    inp.to(a.device), ts.to(a.device),
                    motion_mask=torch.as_tensor(batch["motion_mask"], device=a.device),
                    motion_length=torch.as_tensor(batch["motion_length"], device=a.device),
                    xf_out=xf, text_feats=a.model.precompute_text_feats(xf)).cpu()
        finally:
            if real is not None:
                quant.quantize_rows = real
            for h in handles:
                h.remove()
        check(record or len(calls) == len(logits) > 0, "[int8-parity] gate calls differ")
        return out

    def build(d, mode=None):
        with skip_init(torch):
            a = build_architecture(cfg, device=d)
        a.model.load_state_dict(sd, strict=True)
        return a if mode is None else int8_quantize_(a, weight_only=mode == "w8")

    def compare(got, want, codes_got=(), codes_want=()):
        check([c.shape for c in codes_got] == [c.shape for c in codes_want],
              "[int8-parity] the quantized activations differ in order")
        d = (got - want).abs()
        diffs = [(a.int() - b.int()).abs() for a, b in zip(codes_got, codes_want)]
        first = next((t for t in diffs if t.any()), None)
        return {"max": float(d.max()), "mean": float(d.mean()),
                "flips": sum(int(t.gt(0).sum()) for t in diffs)
                / max(1, sum(t.numel() for t in diffs)),
                "differing": sum(bool(t.any()) for t in diffs), "activations": len(diffs),
                "first_max": 0 if first is None else int(first.max()),
                "first_share": 0.0 if first is None else float(first.gt(0).float().mean()),
                "worst": max((int(t.max()) for t in diffs), default=0)}

    out = {}
    # W8A8 and W8 on one input draw
    for mode, draw in (("w8a8", 0), ("w8", 0)):
        batch = requests(2, SEED + draw + 600, cfg["model"]["max_seq_len"])
        x = torch.randn(batch["motion"].shape,
                        generator=torch.Generator().manual_seed(SEED + draw + 17))
        archs = {"card": build(dev, mode), "cpu": build("cpu", mode)}
        q_card = {k: v for k, v in archs["card"].model.state_dict().items()
                  if v.dtype == torch.int8 or k.endswith("scale")}
        q_cpu = archs["cpu"].model.state_dict()
        check(all(torch.equal(v.cpu(), q_cpu[k]) for k, v in q_card.items()),
              f"[int8-parity] {mode}: card and CPU quantize differently")
        logits, codes = [], {"card": [], "cpu": [], "nudged": []}
        got = forward(archs["card"], batch, x, logits, codes["card"])
        want = forward(archs["cpu"], batch, x, logits, codes["cpu"])
        del archs["cpu"]
        scale = max(1.0, float(want.abs().max()))
        r = compare(got, want, codes["card"], codes["cpu"])
        if mode == "w8":
            print(f"[int8-parity] w8 forward_test B=2: card vs CPU max abs diff {r['max']:.3e} "
                  f"(tol {MODEL_REL_TOL} x {scale:.4g})")
            check(r["max"] <= MODEL_REL_TOL * scale, f"[int8-parity] w8: {r['max']}")
            out[mode] = {"card_cpu": r, "scale": scale}
            continue
        tag = f"w8a8, draw {draw}"
        nudged = forward(archs["card"], batch, torch.nextafter(x, torch.full_like(x, inf)),
                         logits, codes["nudged"], nudge=True)
        sens = compare(nudged, got, codes["nudged"], codes["card"])
        del codes, archs
        fl = compare(forward(build(dev), batch, x, logits), got)
        lim = {k: W8A8_SENS * sens[k] for k in ("max", "mean", "flips")}
        for label, v in (("card vs CPU", r), ("card, nudged one ulp", sens)):
            print(f"[int8-parity] {tag} forward_test B=2, {label}: max abs diff {v['max']:.4e}, "
                  f"mean {v['mean']:.4e} (scale {scale:.4g}); codes that differ: a share "
                  f"{v['flips']:.4e} in {v['differing']} of {v['activations']} activations, "
                  f"the first of them {v['first_share']:.4e} of its codes by at most "
                  f"{v['first_max']}, any by at most {v['worst']}")
        print(f"[int8-parity] {tag} limits ({W8A8_SENS} x the one-ulp readings): max "
              f"{lim['max']:.4e}, mean {lim['mean']:.4e}, share {lim['flips']:.4e}; the float "
              f"forward against the card's W8A8: max {fl['max']:.4e}, mean {fl['mean']:.4e}")
        check(all(r[k] <= lim[k] for k in lim),
              f"[int8-parity] {tag} card vs CPU {r} beyond the limits {lim}")
        check(r["first_max"] <= 1 and r["first_share"] <= W8A8_FIRST_SHARE,
              f"[int8-parity] {tag}: the first differing activation: {r}")
        check(fl["mean"] > lim["mean"],
              f"[int8-parity] the float forward ({fl}) is within the W8A8 limits {lim}")
        out[tag] = {"card_cpu": r, "sensitivity": sens, "float": fl, "limits": lim,
                    "scale": scale}
    return out


def int_mm_table(torch, shapes, dev):
    """Each int8 product shape of the W8A8 run, and m = 1 and 2 at the
    time MLP's and the stylization products' widths: int_mm on the card
    exactly equal to the plain int32 product (computed in f64 on the card,
    which holds every partial sum of these sizes exactly, and for the first
    rows on the CPU), its device ms and bound (int8 tensor cores)."""
    from motioncraft_tpu_torch.ops import quant

    g = torch.Generator(device="cpu").manual_seed(SEED + 19)
    cases = dict(shapes)
    for (m, k, n, col), c in list(shapes.items()):
        if m == BATCH or m == 2 * BATCH:  # a time-MLP or stylization width
            for small in (1, 2):
                cases.setdefault((small, k, n, col), 0)
    rows = []
    for (m, k, n, col), calls in sorted(cases.items(), key=lambda kv: kv[0][1:] + kv[0][:1]):
        a = torch.randint(-127, 128, (m, k), generator=g, dtype=torch.int8).to(dev)
        b = torch.randint(-127, 128, (n, k) if col else (k, n), generator=g,
                          dtype=torch.int8).to(dev)
        b = b.t() if col else b
        got = quant.int_mm(a, b)
        ref = (a.double() @ b.double()).to(torch.int32)
        head = quant.int_mm_plain(a[:64].cpu(), b.cpu())
        check(torch.equal(got, ref) and torch.equal(got[:64].cpu(), head),
              f"[int_mm] {m}x{k}x{n}: not the int32 product")
        # no device time on the CPU (a rehearsal)
        ms = (device_ms(torch, lambda: quant.int_mm(a, b)) if torch.device(dev).type == "cuda"
              else float("nan"))
        t_ms, by = bound(2 * m * k * n, m * k + k * n + 4 * m * n, INT8_PEAK)
        rows.append({"m": m, "k": k, "n": n, "mat2": "column-major" if col else "row-major",
                     "calls_per_batch": calls, "ms": ms, "bound_ms": t_ms, "bound_by": by})
        print(f"[int_mm] {m} x {k} x {n} ({rows[-1]['mat2']} mat2, {calls} calls in the W8A8 "
              f"run): exact; {ms:.4f} ms, bound {t_ms:.4f} ms ({by})")
    print(json.dumps({"int8_products": rows}))
    return rows


def lowprec_m2d(torch, m2d_cfg, dev, config=M2D_CONFIG):
    """One M2D track of phase 10's length (three windows: window 0 plain,
    windows 1 and 2 RePaint's harmonized loop; the FID needs two 150-frame
    chunks) at R = 1 with --step-cache 2 through tools/torch_m2d_test.py:
    finite predictions and metrics, the flags stamped, and K1-K4's
    launches what the reuse tables imply (every first denoise step after a
    re-noising jump computes)."""
    import tempfile

    import numpy as np
    from motioncraft_tpu_torch.apis.windowed import num_windows
    from motioncraft_tpu_torch.diffusion import (RepaintConfig, StepCacheConfig,
                                                 harmonize_schedule, pattern_flags)
    from motioncraft_tpu_torch.ops import launch_counts, reset_launch_counts
    from motioncraft_tpu_torch.registry import build_architecture
    from motioncraft_tpu_torch.utils.checkpoint import save_params
    from motioncraft_tpu_torch.utils.convert import fabricate_state_dict

    tool = load_tool("torch_m2d_test")
    cfg = m2d_cfg["model"]
    window, pre = m2d_cfg["windowed"]["window"], m2d_cfg["windowed"]["pre_frames"]
    frames = M2D_FRAMES
    with tempfile.TemporaryDirectory() as tmp:
        with skip_init(torch):
            arch = build_architecture(cfg, device="cpu")
        layers, copy = arch.model.num_layers, arch.model.copy_blocks_num
        steps = arch.diffusion_test.num_timesteps

        def write(path):  # phase 10's weights
            arch.model.load_state_dict(fabricate_state_dict(arch.model, seed=SEED), strict=True)
            save_params(path, arch.model)

        params = snapshot(tmp, "params.npz", (config, SEED), write)
        del arch
        tree = os.path.join(tmp, "data")
        write_finedance_tree(tree, M2D_TRACKS[:1], frames, SEED + 3)
        argv = [config, "--device", str(dev), "--checkpoint", params, "--seed", str(SEED),
                "--work-dir", os.path.join(tmp, "out"), "--step-cache", "2",
                "--cfg-options", f"data.test.data_prefix={tree}"]
        reset_launch_counts()
        run = checkpoint_run(torch, tool.main, argv)
        counts = launch_counts()
    sc = StepCacheConfig(reuse_every=2)
    schedule = harmonize_schedule(steps, RepaintConfig(overlap_len=pre))
    mask = np.array([dn for _, dn in schedule])
    tables = [pattern_flags(steps, layers, sc)] + [
        pattern_flags(len(mask), layers, sc, denoise_mask=mask)[mask]] * (run["windows"] - 1)
    want = dict.fromkeys(counts, 0) | cached_counts(run["windows"], tables, layers, copy)
    out = run["out"]
    print(f"[m2d-cache] {run['windows']} windows ({frames} frames) at --step-cache 2 in "
          f"{run['sample_s']:.3f} s: {run['sample_s'] / run['windows'] * 1e3:.1f} ms a window; "
          f"window 1 computes {int((~tables[-1]).sum())} of {tables[-1].size} (denoise step, "
          f"layer) pairs; launches {counts}")
    metric = {k: v for k, v in out.items() if k not in ("flags", "protocol")}
    check(run["windows"] == num_windows(frames, window, pre) and out["flags"]["step_cache"] == 2
          and all(p.shape == (frames, 322) and np.isfinite(p).all() for p in run["preds"])
          and all(np.isfinite(v) for v in metric.values()),
          f"[m2d-cache] windows {run['windows']}, flags {out['flags']}, metrics {metric}")
    check(counts == want, f"[m2d-cache] launch counts {counts} != expected {want}")
    return {"counts": counts, "ms": run["sample_s"] / run["windows"] * 1e3}


def lowprec_serve(torch, cfg, sd, dev):
    """A MotionGenServer holding a W8A8 (f32 activations) flagship: warmed
    up on the bucket pairs its traffic can reach (LOWPREC_SERVE_WARM), then
    phase 12's traffic: finite results, K1 and K2 launch no time, K3/K4
    what the dispatches imply; latency p50/p95."""
    import numpy as np
    from motioncraft_tpu_torch.apis import int8_quantize_
    from motioncraft_tpu_torch.apis.windowed import num_windows
    from motioncraft_tpu_torch.diffusion import RepaintConfig, harmonize_schedule
    from motioncraft_tpu_torch.ops import launch_counts, reset_launch_counts
    from motioncraft_tpu_torch.registry import build_architecture
    from motioncraft_tpu_torch.serving import MotionGenServer
    from motioncraft_tpu_torch.serving.server import covered_frames

    T, D = cfg["model"]["max_seq_len"], cfg["model"]["input_feats"]
    with skip_init(torch):
        arch = build_architecture(cfg, device=dev)
    arch.model.load_state_dict(sd, strict=True)
    int8_quantize_(arch)
    layers, steps = arch.model.num_layers, arch.diffusion_test.num_timesteps
    pre = 4
    wins = num_windows(covered_frames(SERVE_LONG_FRAMES, T, pre), T, pre)
    rp = RepaintConfig(overlap_len=pre, add_blend=True)
    long_calls = steps + (wins - 1) * sum(d for _, d in harmonize_schedule(steps, rp))
    srv = MotionGenServer(arch, max_seq_len=T, input_feats=D, batch_buckets=SERVE_BUCKETS,
                          seq_buckets=SERVE_SEQ_BUCKETS, max_wait_ms=20.0, seed=SEED)
    t0 = time.perf_counter()
    srv.warmup(LOWPREC_SERVE_WARM)
    warm = time.perf_counter() - t0
    reset_launch_counts()
    with srv:
        results, long_out, wall = serve_traffic(torch, srv, T, SEED + 40,
                                                LOWPREC_SERVE_PER_CLIENT)
        st = srv.stats()
    counts = launch_counts()
    n_req = SERVE_CLIENTS * LOWPREC_SERVE_PER_CLIENT + SERVE_LONG
    for n, m in results:
        check(m.shape == (n, D) and np.isfinite(m).all(), f"[serve-int8] {m.shape}")
    for m in long_out:
        check(m.shape == (SERVE_LONG_FRAMES, D) and np.isfinite(m).all(),
              f"[serve-int8] long: {m.shape}")
    check(st["requests"] == n_req, f"[serve-int8] stats {st}")
    short, n_long = st["dispatches"] - st["long_dispatches"], st["long_dispatches"]
    want = dict.fromkeys(counts, 0) | sampling_counts(
        short + n_long * wins, short * steps + n_long * long_calls, layers)
    want["grouped_ffn"] = want["head_ffn"] = 0
    if torch.device(dev).type == "cuda":  # the CPU counts no int8 launch
        once, per_step = int8_products(arch.model)
        want["int_mm"] = (once * (short + n_long * wins)
                          + per_step * (short * steps + n_long * long_calls))
    print(f"[serve-int8] W8A8 f32: warm-up {warm:.1f} s; {n_req} requests in {wall:.3f} s: "
          f"{n_req / wall:.3f} requests/s; latency p50 {st['latency_p50_s']:.3f} s, p95 "
          f"{st['latency_p95_s']:.3f} s; {st['dispatches']} dispatches "
          f"({st['long_dispatches']} long), mean occupancy {st['mean_occupancy']:.3f}; "
          f"launches {counts}")
    check(counts == want, f"[serve-int8] launch counts {counts} != expected {want}")
    return {"stats": st, "counts": counts, "requests_per_s": n_req / wall}


# ---------------------------------------------------------------- phase 14

def harness_config(path, base, tree, test_ann, evaluator, test_clips):
    """A config file that ``_base_``s ``base`` (the learnable-tree harness
    config), reads ``tree`` (training: every clip; test: ``test_ann``), loads
    ``evaluator`` and keeps one checkpoint."""
    stats = os.path.join(tree, "datasets", "motionx")
    with open(path, "w") as f:
        f.write(f"""_base_ = [{base!r}]
pipeline = [
    dict(type='Normalize', mean_path={os.path.join(stats, 'mean.npy')!r},
         std_path={os.path.join(stats, 'std.npy')!r}),
    dict(type='Crop', crop_size=196),
    dict(type='ToTensor', keys=['motion', 'motion_mask']),
    dict(type='Collect', keys=['motion', 'motion_mask', 'motion_length'],
         meta_keys=['text']),
]
data = dict(
    train=dict(data_prefix={tree!r}, pipeline=pipeline),
    test=dict(data_prefix={tree!r}, pipeline=pipeline, ann_file={test_ann!r},
              eval_cfg=dict(
                  replication_times=1,
                  evaluator_model=dict(init_cfg=dict(type='Pretrained',
                                                     checkpoint={evaluator!r})),
                  metrics=[dict(type='R Precision', batch_size=32, top_k=3),
                           dict(type='Matching Score', batch_size=32),
                           dict(type='FID', emb_scale=1.0),
                           dict(type='Diversity', num_samples={test_clips // 2})])))
checkpoint_config = dict(interval=1, max_keep_ckpts=1)
log_config = dict(interval=4)
""")


def phase_harness(torch, full_cfg, dev="cuda", config=HARNESS_CONFIG, clips=HARNESS_CLIPS,
                  test_clips=HARNESS_TEST_CLIPS, eval_steps=HARNESS_EVAL_STEPS,
                  table=STEP_CACHE_TABLE):
    """Phase 14: the trained-weights quality harness on ``config`` (whose
    model ``full_cfg`` is) over a learnable tree of ``clips`` clips written
    here: the evaluator trainer, the training CLI with a resume, the
    calibration checkpoint and the drift of every approximate mode, each
    through its tool, with checks and launch counts."""
    import re
    import tempfile

    import numpy as np
    from motioncraft_tpu_torch.apis import bf16_cast_, int8_quantize_
    from motioncraft_tpu_torch.diffusion import (StepCacheConfig, build_diffusion, load_flags,
                                                 pattern_flags)
    from motioncraft_tpu_torch.ops import launch_counts, reset_launch_counts
    from motioncraft_tpu_torch.registry import build_architecture
    from motioncraft_tpu_torch.utils.checkpoint import load_eval_variables

    t_phase = time.perf_counter()
    wall = {}
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        tree = os.path.join(tmp, "data")
        load_tool("make_tiny_data").make_protocol_learnable(tree, np.random.RandomState(SEED),
                                                            n=clips)
        d = os.path.join(tree, "datasets", "motionx")
        with open(os.path.join(d, "ann.txt")) as f:
            names = [ln.strip() for ln in f if ln.strip()]
        with open(os.path.join(d, "test_ann.txt"), "w") as f:
            f.write("\n".join(names[:test_clips]) + "\n")
        evaluator = os.path.join(tmp, "evaluator.npz")
        cfg_path = os.path.join(tmp, "config.py")
        harness_config(cfg_path, config, tree, "test_ann.txt", evaluator, test_clips)
        wall["data"] = time.perf_counter() - t0

        # the evaluator: InfoNCE on the card, held-out top-1
        t0 = time.perf_counter()
        ev_tool = load_tool("torch_train_protocol_evaluator")
        ev = ev_tool.run(ev_tool.parse_args(["--root", tree, "--out", evaluator, "--device",
                                             str(dev), "--steps", str(eval_steps)]),
                         logger=lambda m: None)
        wall["evaluator"] = time.perf_counter() - t0
        print(f"[harness] evaluator: {eval_steps} steps in {wall['evaluator']:.3f} s, loss "
              f"{ev['losses'][0]:.4f} -> {ev['losses'][-1]:.4f}, held-out top-1 "
              f"{ev['top1']:.3f} (floor {HARNESS_TOP1})")
        check(np.isfinite(ev["losses"]).all(), "[harness] non-finite evaluator loss")
        check(ev["top1"] >= HARNESS_TOP1, f"[harness] evaluator top-1 {ev['top1']}")
        del ev

        # training: 2 epochs, then --resume for a third
        train_tool = load_tool("torch_train")
        work = os.path.join(tmp, "train")
        check(full_cfg["data"]["samples_per_gpu"] == HARNESS_BATCH,
              f"[harness] the config's batch is not {HARNESS_BATCH}: phase 2 checks that")
        argv = [cfg_path, "--work-dir", work, "--device", str(dev), "--grad-accum",
                str(HARNESS_GRAD_ACCUM)]
        counts = {}
        for label, extra in (("first", ["--max-epochs", "2"]),
                             ("resumed", ["--resume", "--max-epochs", "3"])):
            reset_launch_counts()
            t0 = time.perf_counter()
            state = train_tool.main(argv + extra)
            wall[f"train {label}"] = time.perf_counter() - t0
            counts[label] = launch_counts()
        with open(os.path.join(work, "train.log")) as f:
            log = f.read()
        losses = [float(x) for x in re.findall(r" loss=(\S+)", log)]
        resumes = re.findall(r"resumed from \S+ at epoch (\d+)", log)
        done = [int(e) for e in re.findall(r"epoch (\d+) done in", log)]
        steps_per_epoch = int(re.search(r"dataset: \d+ samples, (\d+) steps/epoch",
                                        log).group(1))
        print(f"[harness] training: {wall['train first']:.3f} s for 2 epochs, "
              f"{wall['train resumed']:.3f} s for the resumed third; {steps_per_epoch} "
              f"steps an epoch; losses {losses}; resumed at epoch {resumes}; epochs done {done}")
        check(resumes == ["1"] and done == [0, 1, 2], f"[harness] resume: {resumes}, {done}")
        check(losses and np.isfinite(losses).all(), f"[harness] training losses {losses}")
        check(state.step == 3 * steps_per_epoch, f"[harness] {state.step} optimizer steps")
        layers = full_cfg["model"]["model"]["num_layers"]
        for label, epochs in (("first", 2), ("resumed", 1)):
            # --grad-accum: that many microbatch forwards an optimizer step
            want = dict.fromkeys(counts[label], 0) | training_counts(
                HARNESS_GRAD_ACCUM * epochs * steps_per_epoch, layers)
            print(f"[harness] training {label}: launches {counts[label]}")
            check(counts[label] == want,
                  f"[harness] training {label} launches {counts[label]} != expected {want}")
        with skip_init(torch):
            loaded = build_architecture(full_cfg["model"], device=dev)
        load_eval_variables(full_cfg["model"], loaded.model,
                            checkpoint=os.path.join(work, "params.npz"))
        trained = state.model.state_dict()
        same = all(torch.equal(v, trained[k]) for k, v in loaded.model.state_dict().items())
        print(f"[harness] params.npz loads strictly; equal to the trained weights: {same}")
        check(same, "[harness] params.npz differs from the trained weights")
        del state, loaded, trained
        out["train"] = {k: counts["first"][k] + counts["resumed"][k] for k in counts["first"]}

        # the calibration checkpoint
        calib_tool = load_tool("torch_make_calib_ckpt")
        calib = os.path.join(tmp, "calib.npz")
        reset_launch_counts()
        t0 = time.perf_counter()
        res = calib_tool.run(calib_tool.parse_args([cfg_path, calib, "--device", str(dev),
                                                    "--steps", "8", "--batch-size",
                                                    str(HARNESS_CALIB_BATCH)]),
                             logger=lambda m: None)
        wall["calibration checkpoint"] = time.perf_counter() - t0
        out["calib"] = launch_counts()
        print(f"[harness] calibration checkpoint: {res['steps']} steps in "
              f"{wall['calibration checkpoint']:.3f} s, losses {res['losses']}; "
              f"launches {out['calib']}")
        check(res["steps"] == 8 and res["losses"] and np.isfinite(res["losses"]).all(),
              f"[harness] calibration checkpoint: {res['steps']} steps, {res['losses']}")
        del res

        # the drift of every approximate mode, then a second run that reuses them
        drift_tool = load_tool("torch_measure_approx_drift")
        argv = ["--config", cfg_path, "--checkpoint", calib, "--table", table, "--out",
                os.path.join(tmp, "drift.json"), "--workroot", os.path.join(tmp, "drift"),
                "--device", str(dev), "--replications", "1", "--limit", str(test_clips)]
        t0 = time.perf_counter()
        drift = checkpoint_run(torch, drift_tool.run, drift_tool.parse_args(argv),
                               logger=lambda m: None)
        wall["drift"] = time.perf_counter() - t0
        modes = drift["out"]["modes"]
        check(list(modes) == list(drift_tool.MODE_NAMES), f"[harness] modes {list(modes)}")
        steps = build_diffusion(full_cfg["model"]["diffusion_test"]).num_timesteps
        batches = -(-test_clips // full_cfg["data"]["samples_per_gpu"])
        # the W8A8 mode's int8 products: the model's, on a quantized copy
        w8a8 = bf16_cast_(build_architecture(full_cfg["model"], device=dev))
        once, per_step = int8_products(int8_quantize_(w8a8).model)
        del w8a8
        flags = {"exact": None, "int8w": None, "int8": None,
                 "step_cache_2": pattern_flags(steps, layers, StepCacheConfig(reuse_every=2)),
                 "step_cache_table": load_flags(table)}
        out["drift"] = {}
        for name, m in modes.items():
            rec = drift["records"][name]
            got = rec["launches"]
            f = np.zeros((steps, layers), bool) if flags[name] is None else flags[name]
            want = dict.fromkeys(got, 0) | cached_counts(batches, [f] * batches, layers,
                                                         suffix="_bf16")
            want["int_mm"] = 0
            if name == "int8":  # W8A8: slot buffers, no K1/K2; the int8 products
                want["grouped_ffn_bf16"] = want["head_ffn_bf16"] = 0
                want["int_mm"] = batches * (once + steps * per_step)
            values = list(m["metrics"].values()) + list(m.get("delta_vs_exact", {}).values())
            err = m.get("sample_rel_err")
            print(f"[harness] drift {name}: {rec['clips']} clips, {rec['wall_s']:.3f} s "
                  f"(sampling {rec['sample_s']:.3f} s, evaluation {rec['eval_s']:.3f} s); "
                  f"metrics {json.dumps(m['metrics'])}; delta {json.dumps(m.get('delta_vs_exact'))}"
                  f"; sample_rel_err {json.dumps(err)}; launches {got}")
            check(len(m["metrics"]) == 6 and np.isfinite(values).all(),
                  f"[harness] drift {name}: metrics {m['metrics']}")
            check(name == "exact" or err["mean"] > 0, f"[harness] drift {name}: no error")
            check(got == want, f"[harness] drift {name} launches {got} != expected {want}")
            check(name != "int8" or got["int_mm"] > 0, "[harness] W8A8 ran no int8 product")
            out["drift"][name] = got
        reset_launch_counts()
        t0 = time.perf_counter()
        again = checkpoint_run(torch, drift_tool.run, drift_tool.parse_args(argv),
                               logger=lambda m: None)
        wall["drift reused"] = time.perf_counter() - t0
        relaunched = {k: v for k, v in launch_counts().items() if v}
        reused = [k for k, r in again["records"].items() if r["reused"]]
        print(f"[harness] second drift run: {wall['drift reused']:.3f} s, reused {reused}, "
              f"launches {relaunched}")
        check(reused == list(modes) and not relaunched and again["out"]["modes"] == modes,
              "[harness] the second drift run did not reuse every mode")
    print(f"[harness] wall s: {json.dumps(wall)}")
    print(f"[harness] phase 14 took {time.perf_counter() - t_phase:.1f} s")
    return out


def baseline_condition(torch, arch, batch):
    """A baseline's test-forward keywords for ``batch`` on its device: the
    masks and the text condition as its encode_text gives it (xf_proj and
    xf_out, or MDM's pooled text)."""
    enc = arch.encode_text(batch["text_ids"])
    xf_proj, xf = enc if isinstance(enc, tuple) else (None, enc)
    kw = {"motion_mask": arch._tensor(batch["motion_mask"]),
          "motion_length": arch._tensor(batch["motion_length"]), "xf_out": xf}
    return kw if xf_proj is None else dict(kw, xf_proj=xf_proj)


def baseline_forward(torch, arch, batch, x, ts):
    """One test forward of a baseline at the given inputs on its device."""
    with torch.no_grad():
        return arch.model(x.to(arch.device), ts.to(arch.device),
                          **baseline_condition(torch, arch, batch))


def profile_call(torch, fn, reps=5):
    """(device kernels launched, device ms, wall ms) of one call: the first
    two from torch.profiler over ``reps`` calls, the wall time between CUDA
    events over back-to-back calls without the profiler."""
    from torch.profiler import ProfilerActivity, profile

    wall = time_ms(torch, fn, reps)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = device_events_ns(torch, prof)
    busy = sum(events) / 1e6
    return len(events) / reps, busy / reps, wall


def k5_keeps_nothing(torch, dev):
    """K5 at inference (torch.no_grad) on operands that require a gradient
    returns a tensor with no autograd graph, so no input is kept for a
    backward pass; under grad mode it is differentiable."""
    from motioncraft_tpu_torch.ops import fused_linear_attention

    g = torch.Generator(device=dev).manual_seed(SEED)
    ops = [torch.randn(2, 77, 4, 64, generator=g, device=dev).requires_grad_()
           for _ in range(3)]
    with torch.no_grad():
        out = fused_linear_attention(*ops)
    check(out.grad_fn is None and not out.requires_grad,
          "K5 under no_grad kept an autograd graph")
    out = fused_linear_attention(*ops)
    check(out.grad_fn is not None, "K5 under grad mode is not differentiable")
    print("[baseline] K5 under no_grad: no autograd graph, no inputs kept; under grad "
          "mode: differentiable")


def k5_per_call(model):
    """K5's launches a denoiser call of a baseline: one per Efficient
    attention (an MCM ControlNet's with its condition on, whose control
    blocks run too)."""
    return sum(type(m).__name__.startswith("Efficient") for m in model.modules())


def phase_baselines(torch, dev="cuda", configs=BASELINE_CONFIGS, ddim_config=MCM_DDIM_CONFIG,
                    protocol_config=MD_CONFIG, clips=BASELINE_CLIPS):
    """Phase 15: MotionDiffuse, MCM and MDM at full width with their DDPM
    sampling, MCM's DDIM-50 config, and tools/torch_test.py's protocol run
    on MotionDiffuse; each with checks.  Returns per run the launches, the
    wall ms and (the three DDPM families) one denoiser call's profile."""
    import tempfile

    import numpy as np
    from motioncraft_tpu_torch.apis import single_device_test
    from motioncraft_tpu_torch.config import Config
    from motioncraft_tpu_torch.eval.models import T2MContrastiveModel_SMPLX
    from motioncraft_tpu_torch.ops import launch_counts, reset_launch_counts
    from motioncraft_tpu_torch.registry import build_architecture
    from motioncraft_tpu_torch.utils.checkpoint import load_eval_variables, save_params
    from motioncraft_tpu_torch.utils.convert import fabricate_state_dict, to_jax_params

    t_phase = time.perf_counter()
    k5_keeps_nothing(torch, dev)
    out = {}

    def sample_batch(tag, arch, feats):
        T = BASELINE_FRAMES
        batch = requests(BATCH, SEED + 500, T, feats)
        reset_launch_counts()
        t0 = time.perf_counter()
        res = single_device_test(arch, [batch], seed=SEED, device=arch.device)
        wall = (time.perf_counter() - t0) * 1e3
        counts = launch_counts()
        steps = arch.diffusion_test.num_timesteps
        per_call = k5_per_call(arch.model)
        want = dict.fromkeys(counts, 0) | {"fused_linear_attention": steps * per_call}
        print(f"[baseline] {tag}: {arch.inference_type} over {steps} steps, {len(res)} "
              f"requests of {T} x {feats} in {wall:.1f} ms ({wall / steps:.3f} ms a step); "
              f"K5 launches {counts['fused_linear_attention']} ({per_call} a denoiser call)")
        check(len(res) == BATCH, f"{tag}: {len(res)} results")
        pred = np.stack([r["pred_motion"] for r in res])
        check(pred.shape == (BATCH, T, feats) and np.isfinite(pred).all(),
              f"{tag}: output {pred.shape}, finite {np.isfinite(pred).all()}")
        check(counts == want, f"{tag}: launch counts {counts} != expected {want}")
        return batch, {"counts": counts, "wall_ms": wall, "steps": steps,
                       "k5_per_call": per_call}

    with tempfile.TemporaryDirectory() as tmp:
        for path in configs:
            tag = os.path.basename(path)[:-3]
            cfg = Config.fromfile(path).model
            cfg["diffusion_test"]["respace"] = BASELINE_DDPM_RESPACE
            t0 = time.perf_counter()
            with skip_init(torch):
                arch = build_architecture(cfg, device=dev)
            sd = fabricate_state_dict(arch.model, seed=SEED)
            arch.model.load_state_dict(sd, strict=True)
            print(f"[baseline] {tag}: {type(arch.model).__name__} built in "
                  f"{time.perf_counter() - t0:.1f} s, "
                  f"{sum(p.numel() for p in arch.parameters()) / 1e6:.1f} M parameters")
            feats = cfg["model"]["input_feats"]
            batch, out[tag] = sample_batch(tag, arch, feats)

            # one denoiser call at the batch's shape: launches, device time, idle
            T = batch["motion"].shape[1]
            g = torch.Generator(device=dev).manual_seed(SEED + 11)
            x = torch.randn((BATCH, T, feats), generator=g, device=dev)
            ts = torch.full((BATCH,), 499, dtype=torch.long, device=dev)
            kw = baseline_condition(torch, arch, batch)

            def call():
                with torch.no_grad():
                    arch.model(x, ts, **kw)

            launches, busy, wall = profile_call(torch, call)
            out[tag].update(call_launches=launches, call_device_ms=busy, call_wall_ms=wall)
            print(f"[baseline] {tag}: one denoiser call B={BATCH}: {launches:.0f} device "
                  f"kernels, {busy:.3f} ms on the device, {wall:.3f} ms a back-to-back call "
                  f"(idle share {1 - busy / wall:.3f})")

            # card vs CPU, B = 2
            with skip_init(torch):
                cpu = build_architecture(cfg, device="cpu")
            cpu.model.load_state_dict(sd, strict=True)
            small = requests(2, SEED + 100, T, feats)
            x2, ts2 = x[:2].cpu(), torch.tensor([999, 321])
            got = baseline_forward(torch, arch, small, x2, ts2).cpu()
            want = baseline_forward(torch, cpu, small, x2, ts2)
            scale = max(1.0, float(want.abs().max()))
            diff = float((got - want).abs().max())
            print(f"[baseline] {tag}: forward_test B=2 card vs CPU max abs diff {diff:.3e} "
                  f"(tol {MODEL_REL_TOL} x {scale:.4g})")
            check(diff <= MODEL_REL_TOL * scale, f"{tag} forward card vs CPU: {diff}")
            del cpu

            # saved and loaded back through --checkpoint's loader
            params = os.path.join(tmp, tag + ".npz")
            save_params(params, arch.model)
            with skip_init(torch):
                loaded = build_architecture(cfg, device=dev)
            load_eval_variables(cfg, loaded.model, checkpoint=params)
            a, b = (baseline_forward(torch, m, batch, x, ts) for m in (loaded, arch))
            print(f"[baseline] {tag}: loaded vs in-memory forward B={BATCH}: bit for bit "
                  f"{torch.equal(a, b)}")
            check(torch.equal(a, b), f"{tag}: the loaded weights do not give the in-memory "
                                     "output")
            del loaded, arch, a, b

        # MCM's DDIM-50 config (HumanML3D 263-d)
        cfg = Config.fromfile(ddim_config).model
        with skip_init(torch):
            arch = build_architecture(cfg, device=dev)
        arch.model.load_state_dict(fabricate_state_dict(arch.model, seed=SEED), strict=True)
        _, out["mcm_t2m ddim50"] = sample_batch("mcm_t2m", arch, cfg["model"]["input_feats"])
        del arch

        # the protocol run: tools/torch_test.py on MotionDiffuse
        torch_test = load_tool("torch_test")
        md_cfg = Config.fromfile(protocol_config)
        T = md_cfg["model"]["model"]["max_seq_len"]
        tree = os.path.join(tmp, "data")
        write_motionx_tree(tree, clips, T, SEED)
        ev_cfg = {k: v for k, v in
                  md_cfg["data"]["test"]["eval_cfg"]["evaluator_model"].items()
                  if k not in ("type", "init_cfg")}
        ev = T2MContrastiveModel_SMPLX(**ev_cfg, seed=SEED, device="cpu")
        evaluator = os.path.join(tmp, "evaluator.npz")
        save_params(evaluator, {"motion": {"params": to_jax_params(ev.motion_module.state_dict())},
                                "text": {"params": to_jax_params(ev.text_module.state_dict())}})
        metrics = [dict(type="R Precision", batch_size=min(32, clips), top_k=3),
                   dict(type="Matching Score", batch_size=min(32, clips)),
                   dict(type="FID", emb_scale=1.0),
                   dict(type="Diversity", num_samples=clips // 2)]
        opts = [f"data.test.data_prefix={tree}", "data.test.ann_file=ann.txt",
                "data.test.motion_dir=motions", "data.test.text_dir=texts",
                "data.test.eval_cfg.replication_times=1",
                f"model.diffusion_test.respace={BASELINE_DDPM_RESPACE!r}",
                f"data.test.eval_cfg.metrics={metrics!r}",
                "data.test.eval_cfg.evaluator_model.init_cfg="
                + repr(dict(type="Pretrained", checkpoint=evaluator))]
        argv = [protocol_config, os.path.join(tmp, "md"), "--device", dev,
                "--batch-size", str(BATCH), "--checkpoint",
                os.path.join(tmp, os.path.basename(protocol_config)[:-3] + ".npz"),
                "--seed", str(SEED), "--cfg-options", *opts]
        reset_launch_counts()
        run = checkpoint_run(torch, torch_test.main, argv)
        counts = launch_counts()
        n = len(run["results"])
        metric = {k: v for k, v in run["out"].items() if k not in ("flags", "protocol")}
        loaded = run["arch"]
        steps, per_call = loaded.diffusion_test.num_timesteps, k5_per_call(loaded.model)
        want = dict.fromkeys(counts, 0) | {
            "fused_linear_attention": -(-clips // BATCH) * steps * per_call}
        print(f"[baseline] protocol run: metrics {json.dumps(metric)}")
        print(f"[baseline] protocol run: {n} samples: sampling {run['sample_s']:.3f} s "
              f"({n / run['sample_s']:.3f} samples/s), evaluation {run['eval_s']:.3f} s; "
              f"launches {counts}")
        check(n == clips and len(metric) == 12, f"{n} results, metrics {sorted(metric)}")
        check(all(np.isfinite(v) for v in metric.values()), f"non-finite metrics {metric}")
        check(counts == want, f"protocol launch counts {counts} != expected {want}")
        out["protocol"] = {"counts": counts, "sample_s": run["sample_s"],
                           "eval_s": run["eval_s"]}
        del run, loaded
    print(f"[baseline] phase 15 took {time.perf_counter() - t_phase:.1f} s")
    return out


def finemogen_counts(calls, layers):
    """K1, K2 and K4's route over ``calls`` FineMoGen denoiser calls: each
    SAMI layer routes and runs its text and its motion MoE (nothing is
    hoisted out of the loop), each SFFN runs K2 once."""
    return {"moe_route": 2 * layers * calls, "grouped_ffn": 2 * layers * calls,
            "head_ffn": layers * calls}


def finemogen_protocol_config(tmp, base, clips):
    """A synthetic tree of ``clips`` clips under ``tmp`` in the layout of
    ``base``'s test set (a HumanML3D or KIT-ML FineMoGen config: its
    dataset and motion width), and a config file that takes ``base`` and
    points its test set at the tree: the same pipeline on the tree's
    statistics, one replication, Diversity on half the clips and
    MultiModality on FMG_MM_SAMPLES x FMG_MM_REPEATS.  Returns the file."""
    from motioncraft_tpu_torch.config import Config

    cfg = Config.fromfile(base)
    dataset = cfg["data"]["test"]["dataset_name"]
    tree = os.path.join(tmp, dataset)
    write_humanml3d_tree(tree, clips, cfg["model"]["model"]["max_seq_len"], SEED,
                         feats=cfg["model"]["model"]["input_feats"], dataset=dataset)
    d = os.path.join(tree, "datasets", dataset)
    pipeline = [dict(type="Normalize", mean_path=os.path.join(d, "mean.npy"),
                     std_path=os.path.join(d, "std.npy")),
                dict(type="Crop", crop_size=196),
                dict(type="ToTensor", keys=["motion", "motion_mask"]),
                dict(type="Collect", keys=["motion", "motion_mask", "motion_length"],
                     meta_keys=["text", "token"])]
    metrics = [dict(type="R Precision", batch_size=32, top_k=3),
               dict(type="Matching Score", batch_size=32), dict(type="FID"),
               dict(type="Diversity", num_samples=clips // 2),
               dict(type="MultiModality", num_samples=FMG_MM_SAMPLES,
                    num_repeats=FMG_MM_REPEATS, num_picks=1)]
    path = os.path.join(tmp, f"{os.path.basename(base)[:-3]}_tree.py")
    with open(path, "w") as f:
        f.write(f"_base_ = [{os.path.abspath(base)!r}]\n"
                f"data = dict(test=dict(data_prefix={tree!r}, pipeline={pipeline!r},\n"
                f"                      eval_cfg=dict(replication_times=1, "
                f"metrics={metrics!r})))\n")
    return path


def phase_finemogen(torch, dev="cuda", config=FMG_CONFIG, protocol_config=FMG_HML_CONFIG,
                    kit_config=FMG_KIT_CONFIG, clips=FMG_CLIPS):
    """Phase 16: FineMoGen at full width with DDIM-50 CFG sampling, one
    denoiser call profiled, card vs CPU, and tools/torch_test.py on its
    HumanML3D config through the BiGRU evaluator; then GT mode on the
    HumanML3D and on the KIT-ML (251-d) config; each with checks.  Returns
    the launches, wall times and the call's profile."""
    import tempfile

    import numpy as np
    from motioncraft_tpu_torch.apis import single_device_test
    from motioncraft_tpu_torch.config import Config
    from motioncraft_tpu_torch.eval.models import T2MContrastiveModel
    from motioncraft_tpu_torch.ops import launch_counts, reset_launch_counts
    from motioncraft_tpu_torch.registry import build_architecture
    from motioncraft_tpu_torch.utils.checkpoint import save_params
    from motioncraft_tpu_torch.utils.convert import fabricate_state_dict

    t_phase = time.perf_counter()
    cfg = Config.fromfile(config).model
    t0 = time.perf_counter()
    with skip_init(torch):
        arch = build_architecture(cfg, device=dev)
    sd = fabricate_state_dict(arch.model, seed=SEED)
    arch.model.load_state_dict(sd, strict=True)
    print(f"[finemogen] {os.path.basename(config)}: {type(arch.model).__name__} built in "
          f"{time.perf_counter() - t0:.1f} s, "
          f"{sum(p.numel() for p in arch.parameters()) / 1e6:.1f} M parameters")
    T, feats = arch.model.max_seq_len, arch.model.input_feats
    steps, layers = arch.diffusion_test.num_timesteps, arch.model.num_layers

    # one DDIM-50 CFG batch of 16
    batch = requests(BATCH, SEED + 600, T, feats)
    reset_launch_counts()
    t0 = time.perf_counter()
    res = single_device_test(arch, [batch], seed=SEED, device=arch.device)
    wall = (time.perf_counter() - t0) * 1e3
    counts = launch_counts()
    want = dict.fromkeys(counts, 0) | finemogen_counts(steps, layers)
    pred = np.stack([r["pred_motion"] for r in res])
    print(f"[finemogen] DDIM-{steps} CFG batch of {BATCH} x {T} x {feats} in {wall:.1f} ms "
          f"({wall / steps:.3f} ms a step); launches {counts}")
    check(pred.shape == (BATCH, T, feats) and np.isfinite(pred).all(),
          f"output {pred.shape}, finite {np.isfinite(pred).all()}")
    check(counts == want, f"FineMoGen launch counts {counts} != expected {want}")
    out = {"batch": {"counts": counts, "wall_ms": wall, "steps": steps}}

    # one denoiser call at the batch's shape: launches, device time, idle
    g = torch.Generator(device=dev).manual_seed(SEED + 11)
    x = torch.randn((BATCH, T, feats), generator=g, device=dev)
    ts = torch.full((BATCH,), 499, dtype=torch.long, device=dev)
    kw = baseline_condition(torch, arch, batch)

    def call():
        with torch.no_grad():
            arch.model(x, ts, **kw)

    launches, busy, call_wall = profile_call(torch, call)
    out["batch"].update(call_launches=launches, call_device_ms=busy, call_wall_ms=call_wall)
    print(f"[finemogen] one denoiser call B={BATCH}: {launches:.0f} device kernels, "
          f"{busy:.3f} ms on the device, {call_wall:.3f} ms a back-to-back call "
          f"(idle share {1 - busy / call_wall:.3f})")
    phase_parity(torch, cfg, arch, sd)
    del arch

    # the protocol run on the HumanML3D config through the BiGRU evaluator
    torch_test = load_tool("torch_test")
    hml = Config.fromfile(protocol_config)
    with tempfile.TemporaryDirectory() as tmp:
        config_file = finemogen_protocol_config(tmp, protocol_config, clips)
        params = os.path.join(tmp, "params.npz")
        with skip_init(torch):
            model = build_architecture(hml.model, device="cpu")
        model.model.load_state_dict(fabricate_state_dict(model.model, seed=SEED), strict=True)
        save_params(params, model.model)
        del model
        argv = [config_file, os.path.join(tmp, "ddim"), "--device", dev, "--batch-size",
                str(BATCH), "--checkpoint", params, "--seed", str(SEED)]
        reset_launch_counts()
        run = checkpoint_run(torch, torch_test.main, argv)
        counts = launch_counts()
        n = len(run["results"])
        metric = {k: v for k, v in run["out"].items() if k not in ("flags", "protocol")}
        loaded = run["arch"]
        batches = -(-n // BATCH)
        want = dict.fromkeys(counts, 0) | finemogen_counts(
            batches * loaded.diffusion_test.num_timesteps, loaded.model.num_layers)
        print(f"[finemogen] protocol run: metrics {json.dumps(metric)}; "
              f"flags {json.dumps(run['out']['flags'])}")
        print(f"[finemogen] protocol run: {n} samples: sampling {run['sample_s']:.3f} s "
              f"({n / run['sample_s']:.3f} samples/s), evaluation {run['eval_s']:.3f} s; "
              f"launches {counts}")
        check(n == clips + FMG_MM_SAMPLES * FMG_MM_REPEATS and len(metric) == 14,
              f"{n} results, metrics {sorted(metric)}")
        check(all(np.isfinite(v) for v in metric.values()), f"non-finite metrics {metric}")
        check(counts == want, f"protocol launch counts {counts} != expected {want}")
        out["protocol"] = {"counts": counts, "sample_s": run["sample_s"],
                           "eval_s": run["eval_s"]}

        # the BiGRU evaluator on the card against the CPU: the same seeded
        # weights (the config's checkpoint is not in the repository)
        card_ev = run["dataset"].evaluator_model
        ev_cfg = {k: v for k, v in hml["data"]["test"]["eval_cfg"]["evaluator_model"].items()
                  if k != "type"}
        cpu_ev = T2MContrastiveModel(**ev_cfg, device="cpu")
        check(type(card_ev) is T2MContrastiveModel and card_ev.device.type == dev,
              f"evaluator {type(card_ev).__name__} on {card_ev.device}")
        for a, b in ((card_ev.movement, cpu_ev.movement), (card_ev.motion_gru, cpu_ev.motion_gru),
                     (card_ev.text_gru, cpu_ev.text_gru), (card_ev.pos_emb, cpu_ev.pos_emb)):
            check(all(torch.equal(u.cpu(), v) for u, v in zip(a.state_dict().values(),
                                                            b.state_dict().values())),
                  "the card's evaluator weights are not the CPU's")
        res = run["results"][:BATCH]
        motion = np.stack([r["pred_motion"] for r in res])
        lengths = np.array([int(r["motion_length"].reshape(-1)[0]) for r in res])
        texts, tokens = [r["text"] for r in res], [r["token"] for r in res]
        for what, a, b in (("encode_motion", card_ev.encode_motion(motion, lengths),
                            cpu_ev.encode_motion(motion, lengths)),
                           ("encode_text", card_ev.encode_text(texts, tokens),
                            cpu_ev.encode_text(texts, tokens))):
            scale = max(1.0, float(b.abs().max()))
            diff = float((a.cpu() - b).abs().max())
            print(f"[finemogen] BiGRU evaluator {what} B={BATCH}: card vs CPU max abs diff "
                  f"{diff:.3e} (tol {MODEL_REL_TOL} x {scale:.4g})")
            check(diff <= MODEL_REL_TOL * scale, f"evaluator {what} card vs CPU: {diff}")
        del run, loaded

        # GT mode: the test set against itself through each evaluator, the
        # KIT-ML one reading 251-d motions
        for base, cfg_file in ((protocol_config, config_file),
                               (kit_config, finemogen_protocol_config(tmp, kit_config, clips))):
            name = os.path.basename(base)
            gt = torch_test.main([cfg_file, os.path.join(tmp, f"gt_{name[:-3]}"), "--device",
                                  dev, "--batch-size", str(BATCH), "--seed", str(SEED),
                                  "--cfg-options", "model.inference_type=gt"])
            fid, ev = gt["out"]["FID (mean)"], gt["dataset"].evaluator_model
            feats = Config.fromfile(base)["model"]["model"]["input_feats"]
            print(f"[finemogen] GT mode on {name} ({feats}-d): FID (mean) {fid:.3e} "
                  f"(tol {GT_FID_TOL}); evaluation {gt['eval_s']:.3f} s")
            check(abs(fid) <= GT_FID_TOL, f"GT-mode FID {fid} on {name}")
            check(type(ev) is T2MContrastiveModel and ev.device.type == dev
                  and ev.movement.conv1.in_channels == feats - 4,
                  f"{name}'s evaluator {type(ev).__name__} on {ev.device}")
            del gt, ev
    print(f"[finemogen] phase 16 took {time.perf_counter() - t_phase:.1f} s")
    return out

# ---------------------------------------------------------------- phase 17
def compare_devices(torch, tag, what, fn, card, cpu):
    """fn(arch) on the card's architecture and on the CPU's (no MoE to pin):
    the results within MODEL_REL_TOL x max(1, max |CPU|)."""
    with torch.no_grad():
        got, want = fn(card).cpu(), fn(cpu).cpu()
    check(got.shape == want.shape and torch.isfinite(got).all(), f"{what}: {got.shape}")
    scale = max(1.0, float(want.abs().max()))
    diff = float((got - want).abs().max())
    print(f"[{tag}-parity] {what}: card vs CPU max abs diff {diff:.3e} "
          f"(tol {MODEL_REL_TOL} x {scale:.4g})")
    check(diff <= MODEL_REL_TOL * scale, f"{tag} {what} card vs CPU: {diff} > tol")
    return diff


def mcm_long_form(torch, kind, config, tmp, dev="cuda", recordings=MCM_RECORDINGS):
    """Phase 17's MCM ControlNet on ``config``: tools/torch_m2d_test.py
    (``kind`` "m2d") or tools/torch_s2g_test.py ("s2g") at R = 1 and R =
    MCM_REC_BATCH over recordings of two windows, K5's launches what the
    calls imply (nothing else launched); one denoiser call profiled; card
    vs CPU on one denoiser call and one outpainted window with the same
    draws (and, for S2G, the WavEncoder on one window); R = MCM_REC_BATCH
    in lockstep against each recording alone on the same draws."""
    import numpy as np
    from motioncraft_tpu_torch.apis.windowed import (_concat_parts, num_windows,
                                                      windowed_sample, windowed_sample_batch)
    from motioncraft_tpu_torch.config import Config
    from motioncraft_tpu_torch.diffusion import Outpainting, Replay, RepaintConfig
    from motioncraft_tpu_torch.diffusion import harmonize_schedule
    from motioncraft_tpu_torch.ops import launch_counts, reset_launch_counts
    from motioncraft_tpu_torch.registry import build_architecture
    from motioncraft_tpu_torch.utils.checkpoint import save_params
    from motioncraft_tpu_torch.utils.convert import fabricate_state_dict

    full = Config.fromfile(config)
    cfg, win_cfg = full["model"], full["windowed"]
    window, pre = win_cfg["window"], win_cfg["pre_frames"]
    tag = f"mcm-{kind}"
    with skip_init(torch):
        arch = build_architecture(cfg, device=dev)
    sd = fabricate_state_dict(arch.model, seed=SEED)
    arch.model.load_state_dict(sd, strict=True)
    model = arch.model
    steps = arch.diffusion_test.num_timesteps
    rp = RepaintConfig(overlap_len=pre)
    outpaint_calls = sum(d for _, d in harmonize_schedule(steps, rp))
    frames = 2 * window - pre
    wins = num_windows(frames, window, pre)
    calls = steps + (wins - 1) * outpaint_calls  # denoiser calls a recording
    per_call = k5_per_call(model)
    print(f"[{tag}] {type(model).__name__}: {model.num_layers} MCM layers + "
          f"{model.copy_blocks_num} control blocks, "
          f"{sum(p.numel() for p in model.parameters()) / 1e6:.1f} M parameters; "
          f"{recordings} recordings of {frames} frames: {wins} windows of {window} "
          f"overlapping by {pre}, {calls} denoiser calls ({steps} + {wins - 1} x "
          f"{outpaint_calls}), K5 {per_call} a call")
    root = os.path.join(tmp, tag)
    os.makedirs(root)
    params = os.path.join(root, "params.npz")
    save_params(params, model)
    if kind == "m2d":
        tool = load_tool("torch_m2d_test")
        tree = os.path.join(root, "data")
        write_finedance_tree(tree, M2D_TRACKS[:recordings], frames, SEED)
        extra = ["--cfg-options", f"data.test.data_prefix={tree}"]
    else:
        tool = load_tool("torch_s2g_test")
        extra = ["--beats2-args", write_beat2_tree(root, recordings, frames, SEED)]
    out = {}
    for R in (1, MCM_REC_BATCH):
        argv = [config, "--device", dev, "--checkpoint", params, "--seed", str(SEED),
                "--work-dir", os.path.join(root, f"R{R}"), "--recording-batch", str(R), *extra]
        reset_launch_counts()
        run = checkpoint_run(torch, tool.main, argv)
        counts = launch_counts()
        groups = -(-recordings // R)
        want = dict.fromkeys(counts, 0) | {"fused_linear_attention": groups * calls * per_call}
        metric = {k: v for k, v in run["out"].items() if k not in ("flags", "protocol")}
        n_win = run["windows"] * R
        print(f"[{tag}] R={R}: {run['windows']} window batches ({n_win} recording windows, "
              f"{R} rows a denoiser call) in {run['sample_s']:.3f} s: "
              f"{run['sample_s'] / run['windows'] * 1e3:.1f} ms a window batch, "
              f"{n_win * 60 / run['sample_s']:.1f} windows per minute; metric stage "
              f"{run['eval_s']:.3f} s; launches {counts}")
        print(f"[{tag}] R={R} metrics {json.dumps(metric)}")
        check(len(run["preds"]) == recordings
              and all(p.shape == (frames, 322) and np.isfinite(p).all() for p in run["preds"]),
              f"{tag} R={R}: predictions of the wrong shape or not finite")
        check(metric and all(np.isfinite(v) for v in metric.values()),
              f"{tag} R={R}: metrics {metric}")
        check(counts == want, f"{tag} R={R}: launch counts {counts} != expected {want}")
        out[R] = {"counts": counts, "sample_s": run["sample_s"], "eval_s": run["eval_s"],
                  "windows": run["windows"]}
        recs = run["infos"] if kind == "m2d" else run["recordings"]
        del run

    def make_mwbs(R):
        if kind == "m2d":
            return [tool.make_window_batch_fn(i["c"], i["text"][0], window) for i in recs[:R]]
        spf = win_cfg["audio_sr"] // win_cfg["pose_fps"]
        return [tool.make_window_batch_fn(r, window, spf, win_cfg["pose_fps"])
                for r in recs[:R]]

    def window_batch(R, w):
        start = w * (window - pre)
        return {k: torch.as_tensor(v) for k, v in
                _concat_parts([m(start, start + window) for m in make_mwbs(R)]).items()}

    # the CLI's two paths on the card: R = MCM_REC_BATCH recordings in
    # lockstep against each one alone (windowed_sample) on its rows of the
    # lockstep run's draws
    R, lock_draws = MCM_REC_BATCH, []
    g_lock = torch.Generator(device=dev).manual_seed(SEED + 15)

    def keep(shape):
        lock_draws.append(torch.randn(tuple(shape), generator=g_lock, device=dev))
        return lock_draws[-1].clone()

    kw = dict(window=window, pre_frames=pre, repaint=rp)
    with parity_schedule(cfg, arch):  # the check's length does not matter
        lock = windowed_sample_batch(arch, make_mwbs(R), [frames] * R, randn=keep, **kw)
        for r, mwb in enumerate(make_mwbs(R)):
            rows = Replay([a[r:r + 1] for a in lock_draws], dev)
            alone = windowed_sample(arch, mwb, total_frames=frames, randn=rows, **kw)
            check(rows.done(), f"{tag}: recording {r} alone took {rows.used} of "
                  f"{len(lock_draws)} draws")
            scale = max(1.0, float(np.abs(alone).max()))
            diff = float(np.abs(lock[r] - alone).max())
            print(f"[{tag}-parity] recording {r} of {R} in lockstep vs alone, {frames} frames "
                  f"at respace {PARITY_RESPACE}, same draws: max abs diff {diff:.3e} (tol "
                  f"{MODEL_REL_TOL} x {scale:.4g})")
            check(lock[r].shape == alone.shape and diff <= MODEL_REL_TOL * scale,
                  f"{tag} recording {r}: lockstep vs alone {diff} > tol")

    # one denoiser call at R = 1, the condition encoded as sampling does
    batch = {k: v.to(dev) for k, v in window_batch(1, 0).items()}
    g = torch.Generator().manual_seed(SEED + 13)
    x = torch.randn(1, window, 322, generator=g)
    ts = torch.full((1,), 499)
    with torch.no_grad():
        xp, xf = arch.encode_text(batch["text_ids"])
        c_enc = model.encode_condition(batch["c"], window)

    def call():
        with torch.no_grad():
            model(x.to(dev), ts.to(dev), motion_mask=batch["motion_mask"], xf_out=xf,
                  xf_proj=xp, c_enc=c_enc)

    reset_launch_counts()
    call()
    check(launch_counts()["fused_linear_attention"] == per_call, f"{tag}: K5 a call")
    launches, busy, wall = profile_call(torch, call)
    out["call"] = {"launches": launches, "device_ms": busy, "wall_ms": wall,
                   "k5": per_call}
    print(f"[{tag}] one denoiser call, 1 x {window}: {launches:.0f} device kernels "
          f"({per_call} of them K5), {busy:.3f} ms on the device, {wall:.3f} ms a "
          f"back-to-back call (idle share {1 - busy / wall:.3f})")

    # card vs CPU: one denoiser call (the raw condition), the encoder, and
    # window 1 outpainted from a seeded previous window on the same draws
    with skip_init(torch):
        cpu = build_architecture(cfg, device="cpu")
    cpu.model.load_state_dict(sd, strict=True)
    arch.repaint_cfg = cpu.repaint_cfg = rp
    host = window_batch(1, 0)

    def forward(a):
        b = {k: v.to(a.device) for k, v in host.items()}
        proj, text = a.encode_text(b["text_ids"])
        return a.model(x.to(a.device), ts.to(a.device), motion_mask=b["motion_mask"],
                       xf_out=text, xf_proj=proj, c=b["c"])

    compare_devices(torch, tag, f"denoiser call, 1 x {window}, c on", forward, arch, cpu)
    if kind == "s2g":
        compare_devices(torch, tag, f"WavEncoder, one window of {host['c'].shape[1]} samples",
                        lambda a: a.model.condition_pre_encoder(host["c"].to(a.device)),
                        arch, cpu)
    batch1 = window_batch(1, 1)
    last = torch.randn(1, window, 322, generator=g)
    gt = torch.cat([last[:, -pre:], torch.zeros(1, window - pre, 322)], dim=1)
    mask = (torch.arange(window) < pre).reshape(1, window, 1)

    def outpaint(a):
        source = Replay(draws, a.device)
        res = a.sample({k: v.to(a.device) for k, v in batch1.items()}, randn=source,
                       outpainting=Outpainting(mask=mask.to(a.device), gt=gt.to(a.device)))
        check(source.done(), f"the window took {source.used} of {len(draws)} draws")
        return res

    with parity_schedule(cfg, arch, cpu):
        n_steps = len(harmonize_schedule(arch.diffusion_test.num_timesteps, rp))
        draws = [torch.randn(1, window, 322, generator=g) for _ in range(1 + n_steps)]
        compare_devices(torch, tag, f"outpainted window, 1 x {window}, {n_steps} RePaint "
                        "steps", outpaint, arch, cpu)
    del cpu, arch
    return out


def write_retrieval_bank(torch, path, n, T, feats, width, seed, dev="cuda"):
    """A retrieval bank .npz with RetrievalDatabase's keys, written to
    ``path`` (a file name or a binary file object): n entries of
    text_features [width], a caption, motions [T, feats] with their
    m_lengths (40..T), clip_seq_features [77, width], all f32, drawn on
    ``dev`` (2.1e9 normals at full size)."""
    import numpy as np

    g = torch.Generator(device=dev).manual_seed(seed)

    def normal(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev) * scale).cpu().numpy()

    np.savez(path, text_features=normal(n, width),
             captions=np.array([f"a person does move {i}" for i in range(n)]),
             motions=normal(n, T, feats, scale=0.5),
             m_lengths=torch.randint(min(40, T), T + 1, (n,), generator=g,
                                     device=dev).cpu().numpy(),
             clip_seq_features=normal(n, 77, width))


def momat_config(remo):
    """MoMatMoGen at the width of the ReMoDiffuse model config ``remo`` (no
    config of the repo builds it): the dual transformer, its cross-attention
    the dual semantics-modulated one."""
    m = remo["model"]
    return dict(remo, model=dict(m, type="MoMatMoGenTransformer", ca_block_cfg=dict(
        m["ca_block_cfg"], type="DualSemanticsModulatedAttention")))


def retrieval_runs(torch, dev="cuda", config=REMO_CONFIG, bank=REMO_BANK):
    """Phase 17's ReMoDiffuse: the picks of a fabricated bank for BATCH
    requests, encode_retrieval once, one DDIM-50 batch through
    ``sample(extra_model_kwargs={"re_dict": ...})`` with K5's launches (the
    encoder's layers once, the semantics-modulated attention of every layer
    a step) and finite [BATCH, T, feats] motions; one denoiser call
    profiled; card vs CPU on encode_retrieval and one denoiser call (B = 2);
    then one MoMatMoGen forward at the same width (K5 twice a layer) and
    card vs CPU on it."""
    import io

    import numpy as np
    from motioncraft_tpu_torch.config import Config
    from motioncraft_tpu_torch.models.baselines import RetrievalDatabase
    from motioncraft_tpu_torch.ops import launch_counts, reset_launch_counts
    from motioncraft_tpu_torch.registry import build_architecture
    from motioncraft_tpu_torch.utils.convert import fabricate_state_dict

    cfg = Config.fromfile(config).model
    m, rc = cfg["model"], cfg["model"]["retrieval_cfg"]
    T, feats, R = m["max_seq_len"], m["input_feats"], rc["num_retrieval"]
    with skip_init(torch):
        arch = build_architecture(cfg, device=dev)
    sd = fabricate_state_dict(arch.model, seed=SEED)
    arch.model.load_state_dict(sd, strict=True)
    model = arch.model
    steps, layers = arch.diffusion_test.num_timesteps, model.num_layers
    print(f"[remo] {type(model).__name__}: {layers} layers, {R} retrievals, "
          f"{sum(p.numel() for p in model.parameters()) / 1e6:.1f} M parameters")
    # the bank .npz in memory (about 8.5 GB at full size), loaded as a file
    t0 = time.perf_counter()
    with io.BytesIO() as f:
        write_retrieval_bank(torch, f, bank, rc["max_seq_len"], feats, rc["latent_dim"], SEED,
                             dev)
        f.seek(0)
        db = RetrievalDatabase(**dict(rc, retrieval_file=f))
    print(f"[remo] retrieval bank of {len(db.m_lengths)} entries (motions "
          f"{db.motions.nbytes / 1e9:.2f} GB, CLIP tokens {db.clip_seq_features.nbytes / 1e9:.2f}"
          f" GB) made and loaded in {time.perf_counter() - t0:.1f} s")
    batch = requests(BATCH, SEED + 700, T, feats)
    queries = np.random.RandomState(SEED + 701).randn(BATCH, rc["latent_dim"])
    asked = list(zip(queries, batch["motion_length"].reshape(-1), batch["motion_metas"]))
    t0 = time.perf_counter()
    picks = [i for q, n, meta in asked for i in db.retrieve(q, int(n), meta["text"])]
    t1 = time.perf_counter()
    gathered = [torch.as_tensor(a) for a in db.gather(picks, BATCH)]
    t2 = time.perf_counter()
    again = [i for q, n, meta in asked for i in db.retrieve(q, int(n), meta["text"])]
    pick_ms, gather_ms = (t1 - t0) * 1e3, (t2 - t1) * 1e3
    cached_ms = (time.perf_counter() - t2) * 1e3
    check(len(picks) == BATCH * R and again == picks, f"{len(picks)} picks")
    print(f"[remo] host retrieval of {BATCH} requests over {len(db.m_lengths)} entries: "
          f"picks {pick_ms:.1f} ms ({pick_ms / BATCH:.2f} ms a request), gather of "
          f"{BATCH * R} rows {gather_ms:.1f} ms, the same requests again from the cache "
          f"{cached_ms:.3f} ms")

    def encode(a, rows=BATCH):
        return a.model.encode_retrieval(*(t[:rows * R].to(a.device) for t in gathered), R)

    reset_launch_counts()
    t0 = time.perf_counter()
    with torch.no_grad():
        re_dict = encode(arch)
    pred = arch.sample(batch, generator=torch.Generator(device=dev).manual_seed(SEED),
                       extra_model_kwargs={"re_dict": re_dict})
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    counts = launch_counts()
    n_enc = rc["num_motion_layers"]
    want = dict.fromkeys(counts, 0) | {"fused_linear_attention": n_enc + steps * layers}
    print(f"[remo] DDIM-{steps} 4-way CFG batch of {BATCH} x {T} x {feats} ({4 * BATCH} rows a "
          f"call) in {wall:.1f} ms ({wall / steps:.3f} ms a step), encode_retrieval "
          f"included; launches {counts}")
    check(pred.shape == (BATCH, T, feats) and bool(torch.isfinite(pred).all()),
          f"ReMoDiffuse output {tuple(pred.shape)}")
    check(counts == want, f"ReMoDiffuse launch counts {counts} != expected {want}")
    out = {"remodiffuse": {"counts": counts, "wall_ms": wall, "steps": steps,
                           "pick_ms": pick_ms, "gather_ms": gather_ms}}

    g = torch.Generator().manual_seed(SEED + 14)
    x = torch.randn(BATCH, T, feats, generator=g)
    ts = torch.full((BATCH,), 640)
    kw = baseline_condition(torch, arch, batch)

    def call():
        with torch.no_grad():
            model(x.to(dev), ts.to(dev), re_dict=re_dict, **kw)

    launches, busy, call_wall = profile_call(torch, call)
    out["remodiffuse"].update(call_launches=launches, call_device_ms=busy,
                              call_wall_ms=call_wall)
    print(f"[remo] one denoiser call B={BATCH} ({4 * BATCH} rows): {launches:.0f} device "
          f"kernels, {busy:.3f} ms on the device, {call_wall:.3f} ms a back-to-back call "
          f"(idle share {1 - busy / call_wall:.3f})")

    small = {k: v[:2] for k, v in batch.items()}
    with skip_init(torch):
        cpu = build_architecture(cfg, device="cpu")
    cpu.model.load_state_dict(sd, strict=True)
    for what, key in (("re_motion", "re_motion"), ("re_text", "re_text")):
        compare_devices(torch, "remo", f"encode_retrieval {what}, 2 x {R} rows",
                        lambda a, k=key: encode(a, 2)[k], arch, cpu)

    def forward(a):
        return a.model(x[:2].to(a.device), ts[:2].to(a.device), re_dict=encode(a, 2),
                       **baseline_condition(torch, a, small))

    compare_devices(torch, "remo", "denoiser call, B = 2 (8 rows)", forward, arch, cpu)
    del arch, cpu

    # MoMatMoGen at the same width: two persons through one joint embedding
    dual = momat_config(cfg)
    with skip_init(torch):
        arch = build_architecture(dual, device=dev)
    sd = fabricate_state_dict(arch.model, seed=SEED)
    arch.model.load_state_dict(sd, strict=True)
    x2 = torch.randn(BATCH, T, 2 * feats, generator=g)
    kw = baseline_condition(torch, arch, batch)
    with torch.no_grad():
        re_dual = encode(arch)
    reset_launch_counts()
    t0 = time.perf_counter()
    with torch.no_grad():
        y = arch.model(x2.to(dev), ts.to(dev), re_dict=re_dual, **kw)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    counts = launch_counts()
    want = dict.fromkeys(counts, 0) | {"fused_linear_attention": 2 * layers}
    print(f"[momat] one forward, B={BATCH} ({4 * BATCH} rows) x {T} x {2 * feats}: "
          f"{wall:.1f} ms; launches {counts}")
    check(y.shape == (BATCH, T, 2 * feats) and bool(torch.isfinite(y).all()),
          f"MoMatMoGen output {tuple(y.shape)}")
    check(counts == want, f"MoMatMoGen launch counts {counts} != expected {want}")
    out["momatmogen"] = {"counts": counts, "wall_ms": wall}
    with skip_init(torch):
        cpu = build_architecture(dual, device="cpu")
    cpu.model.load_state_dict(sd, strict=True)
    compare_devices(torch, "momat", "forward, B = 2 (8 rows)", lambda a: a.model(
        x2[:2].to(a.device), ts[:2].to(a.device), re_dict=encode(a, 2),
        **baseline_condition(torch, a, small)), arch, cpu)
    return out


def phase_mcm_retrieval(torch, dev="cuda", m2d_config=MCM_M2D_CONFIG,
                        s2g_config=MCM_S2G_CONFIG, remo_config=REMO_CONFIG):
    """Phase 17: the MCM ControlNet through both long-form CLIs, then
    ReMoDiffuse and MoMatMoGen.  Returns each run's launches and times."""
    import tempfile

    t_phase = time.perf_counter()
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for kind, config in (("m2d", m2d_config), ("s2g", s2g_config)):
            out[f"mcm_{kind}"] = mcm_long_form(torch, kind, config, tmp, dev)
    out.update(retrieval_runs(torch, dev, remo_config))
    print(f"[mcm/remo] phase 17 took {time.perf_counter() - t_phase:.1f} s")
    return out


def stage_trees(root, seed):
    """Phase 18's two synthetic trees, each under <dir>/data in the paths
    its configs name (the flagship's mixed set, the S2G and M2D ControlNet
    configs), with configs/beat2/st_mogen_emage.yaml copied beside it (its
    data and cache paths are relative): ``mix`` for stage 1 (Motion-X
    clips, FineDance train tracks, BEAT2 train recordings) and ``cn`` for
    stages 2 and 3 (BEAT2 train recordings and one test recording,
    FineDance train tracks).  Returns (mix dir, cn dir, stage 3's yaml)."""
    import shutil

    import numpy as np
    from motioncraft_tpu_torch.data.datasets import finedance_split

    train_tracks = finedance_split("cross_genre")[0]
    dirs = {}
    for tag in ("mix", "cn"):
        d = os.path.join(root, tag)
        os.makedirs(os.path.join(d, "configs", "beat2"))
        shutil.copy(os.path.join(ROOT, "configs", "beat2", "st_mogen_emage.yaml"),
                    os.path.join(d, "configs", "beat2"))
        pm = os.path.join(d, "data", "datasets", "beats2", "PantoMatrix")
        os.makedirs(pm)
        np.save(os.path.join(pm, "mean.npy"), np.zeros(322, np.float32))
        np.save(os.path.join(pm, "std.npy"), np.ones(322, np.float32))
        dirs[tag] = d
    mix, cn = dirs["mix"], dirs["cn"]
    write_motionx_tree(os.path.join(mix, "data"), MIX_CLIPS, MIX_CLIP_FRAMES, seed,
                       MIX_MOTIONX)
    write_finedance_tree(os.path.join(mix, "data"), train_tracks[:MIX_TRACKS], CN_FRAMES,
                         seed + 1)
    write_beat2_tree(mix, 0, 0, seed + 2, train=MIX_RECORDINGS, train_frames=MIX_REC_FRAMES,
                     data_dir=os.path.join(mix, "data", BEAT2_DIR))
    write_finedance_tree(os.path.join(cn, "data"), train_tracks[:CN_M2D_TRACKS], CN_FRAMES,
                         seed + 3)
    yaml_path = write_beat2_tree(cn, 1, CN_TEST_FRAMES, seed + 4, train=CN_S2G_RECORDINGS,
                                 train_frames=CN_S2G_FRAMES,
                                 data_dir=os.path.join(cn, "data", BEAT2_DIR))
    return mix, cn, yaml_path


def train_stage(torch, tag, argv, cwd, per_step, on_start=None, steps=CN_STEPS,
                label="cn-train"):
    """One tools/torch_train.py run of ``steps`` optimizer steps in ``cwd``
    with the launch counts and the peak memory of the run, the counts held
    to ``per_step`` (kernel -> launches a step; every other kernel 0);
    ``on_start(arch)`` runs on the CLI's own model once its base checkpoint
    (if any) is grafted, before the optimizer is made (what it launches is
    not counted).  Then one more step on the final state under
    torch.profiler, for the idle share.  Returns {"state", "arch",
    "counts", "steps_ms", "step_ms", "samples_s", "peak", "idle",
    "work"}."""
    import numpy as np
    import motioncraft_tpu_torch.apis as apis
    from motioncraft_tpu_torch.apis.train import device_prefetch, make_train_step
    from motioncraft_tpu_torch.ops import COUNTED, launch_counts, reset_launch_counts
    from motioncraft_tpu_torch.utils.card import card_line
    from torch.profiler import ProfilerActivity, profile

    tool = load_tool("torch_train")
    seen, real = {}, apis.train_model

    def recording(arch, loader, model_transform=None, **kw):
        seen.update(arch=arch, loader=loader)  # the CLI's model and loader

        def transform(model):
            if model_transform is not None:
                model_transform(model)
            saved = launch_counts()
            on_start(arch)
            for name, wrapper in COUNTED.items():
                wrapper.launches = saved[name]

        return real(arch, loader, **kw,
                    model_transform=transform if on_start else model_transform)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    here = os.getcwd()
    os.chdir(cwd)
    apis.train_model = recording
    t0 = time.perf_counter()
    try:
        state = tool.main(argv)
    finally:
        apis.train_model = real
        os.chdir(here)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts, peak = launch_counts(), torch.cuda.max_memory_allocated()
    work = os.path.join(cwd, argv[argv.index("--work-dir") + 1])
    with open(os.path.join(work, "train.log")) as f:
        lines = [ln for ln in f if " loss=" in ln]
    losses = [float(ln.split(" loss=")[1].split()[0]) for ln in lines]
    steps_ms = [float(ln.split("step_ms=")[1]) for ln in lines]
    check(state.step == steps and len(losses) == steps and np.isfinite(losses).all(),
          f"{tag}: {state.step} steps, losses {losses}")
    want = dict.fromkeys(counts, 0) | {k: n * steps for k, n in per_step.items()}
    check(counts == want, f"{tag}: launch counts {counts} != expected {want}")

    # one more step (a fourth update of the in-memory model, after
    # params.npz is written), profiled: its busy device time over its wall
    arch, batch_size = seen["arch"], seen["loader"].batch_size
    feed = device_prefetch(iter(seen["loader"]), arch.device)
    batch = next(feed)
    feed.close()
    step = make_train_step(arch, state)
    arch.train()
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t1 = time.perf_counter()
            step(batch, state.generator)
            torch.cuda.synchronize()
            step_wall = (time.perf_counter() - t1) * 1e3
    finally:
        arch.eval()
    busy = sum(device_events_ns(torch, prof)) / 1e6
    med = float(np.median(steps_ms[1:]))
    per_step = {k: counts[k] // steps for k in TRAINING_KERNELS}
    print(f"[{label}] {tag}: {steps} steps of B={batch_size} in {wall:.1f} s (the CLI "
          f"run, checkpoints included); step wall ms {steps_ms} (first = warm-up), median of "
          f"steps 2-{steps} {med:.1f} ms, {batch_size / med * 1e3:.1f} samples/s; max "
          f"memory allocated {peak / 2**30:.3f} GiB; launches a step {per_step}; one more step "
          f"under torch.profiler {step_wall:.1f} ms wall, {busy:.1f} ms busy on the device, "
          f"idle share {1 - busy / step_wall:.3f}; losses {losses}; card {card_line()}")
    return {"state": state, "arch": arch, "counts": counts, "steps_ms": steps_ms,
            "step_ms": med, "samples_s": batch_size / med * 1e3, "peak": peak,
            "idle": 1 - busy / step_wall, "work": work}


def controlnet_start(torch, c, start):
    """``on_start`` of a ControlNet's stage (phases 18 and 19): on the CLI's
    model with its base grafted, each control block's copied block is its
    base block bit for bit, and the zero-initialised projections leave the
    test forward with the condition ``c`` on equal to the base's alone.
    Keeps the starting state_dict (on the host) in ``start``."""

    def on_start(arch):
        m = arch.model
        sd = {k: v.detach().cpu().clone() for k, v in m.state_dict().items()}
        for i in range(m.copy_blocks_num):
            block = {k: v for k, v in sd.items() if k.startswith(f"base_model.block_{i}.")}
            copied = {k.replace(f"base_model.block_{i}.", f"controlnet_{i}.copied_block."): v
                      for k, v in block.items()}
            check(block and all(torch.equal(sd[k], v) for k, v in copied.items())
                  and len(copied) == sum(k.startswith(f"controlnet_{i}.copied_block.")
                                         for k in sd),
                  f"controlnet_{i}.copied_block is not base_model.block_{i}")
        batch = requests(2, SEED + 18, m.base_model.max_seq_len)
        g = torch.Generator(device=arch.device).manual_seed(SEED + 18)
        x = torch.randn(batch["motion"].shape, generator=g, device=arch.device)
        ts = torch.tensor([999, 420], device=arch.device)
        enc = arch.encode_text(batch["text_ids"])
        xf_proj, xf_out = enc if isinstance(enc, tuple) else (None, enc)  # MCM: the pair
        kw = dict(motion_mask=arch._tensor(batch["motion_mask"]),
                  motion_length=arch._tensor(batch["motion_length"]), xf_out=xf_out,
                  **({} if xf_proj is None else {"xf_proj": xf_proj}))
        with_c = m(x, ts, c=arch._tensor(c), **kw)
        base = m.base_model(x, ts, **kw)
        diff = float((with_c - base).abs().max())
        print(f"[cn-train] {type(m).__name__} from the base: {m.copy_blocks_num} copied blocks "
              f"equal their base blocks bit for bit; test forward with c on vs the base alone "
              f"(B=2): max abs diff {diff:.3e} (bit for bit: {torch.equal(with_c, base)})")
        check(torch.equal(with_c, base), "the zero-initialised control branch changed the output")
        start.update(sd)

    return on_start


def check_controlnet_result(torch, tag, npz, base_npz, start, frozen):
    """Stage 2's params.npz against the base it started from and its
    starting state: every frozen leaf the base's bit for bit, every other
    leaf moved, the WavEncoder's running statistics moved.  Three kinds of
    leaf have a gradient of exactly 0 and may stay: the face head under
    face_no_loss, a convolution bias that a BatchNorm in training follows
    (the batch mean takes it out; what it gets is rounding), and the key
    bias of STMA's body self-attention (its key softmax over the sequence
    does not see a shift of a channel)."""
    from motioncraft_tpu_torch.utils.checkpoint import load_params
    from motioncraft_tpu_torch.utils.convert import from_jax_params, from_jax_variables

    got = from_jax_variables(load_params(npz))
    base = from_jax_params(load_params(base_npz)["params"])
    check(set(got) == set(start), f"{tag}: params.npz holds other names than the model")
    bad = [n for n in frozen if not torch.equal(got[n], base[n[len("base_model."):]])]
    check(frozen and not bad, f"{tag}: frozen leaves that are not the base's: {bad[:5]}")
    trainable = [n for n in got if n not in frozen and not n.endswith(
        ("running_mean", "running_var", "num_batches_tracked"))]
    still = [n for n in trainable if torch.equal(got[n], start[n])]
    zero_grad = re.compile(r"base_model\.out\.face_out\..*|condition_pre_encoder\.block\d\."
                           r"(conv1|conv2|down_conv)\.bias|.*\.body_d_attn\.key\.bias")
    stuck = [n for n in still if not zero_grad.fullmatch(n)]
    check(not stuck, f"{tag}: trainable leaves that did not move: {stuck[:5]}")
    stats = [n for n in got if n.endswith(("running_mean", "running_var"))]
    check(all(not torch.equal(got[n], start[n]) for n in stats),
          f"{tag}: WavEncoder statistics that did not move")
    print(f"[cn-train] {tag}: {len(frozen)} frozen tensors the base's bit for bit, "
          f"{len(trainable) - len(still)} of {len(trainable)} trainable tensors moved (not: "
          f"{still}), {len(stats)} BatchNorm statistics moved")


def phase_controlnet_train(torch, dev="cuda", t2m_config=CONFIG, s2g_config=CN_S2G_CONFIG,
                           m2d_config=M2D_CONFIG):
    """Phase 18: ControlNet training from a T2M base through
    tools/torch_train.py, at full width on synthetic trees: stage 1 the
    flagship config as shipped on its mixed train set (3 steps of its batch
    of 128), stage 2 the S2G (WavEncoder, root_face_hand) and M2D
    ControlNets from stage 1's params.npz with --base-checkpoint (3 steps
    each at their own batch), card vs CPU on one S2G training step, stage 3
    tools/torch_s2g_test.py on stage 2's S2G params.npz."""
    import tempfile

    import numpy as np
    from motioncraft_tpu_torch.apis.windowed import num_windows
    from motioncraft_tpu_torch.config import Config
    from motioncraft_tpu_torch.data import collate
    from motioncraft_tpu_torch.diffusion import RepaintConfig, harmonize_schedule
    from motioncraft_tpu_torch.ops import launch_counts, reset_launch_counts
    from motioncraft_tpu_torch.registry import build_architecture, build_dataset
    from motioncraft_tpu_torch.utils.convert import fabricate_state_dict

    t_phase = time.perf_counter()
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        mix, cn, yaml_path = stage_trees(tmp, SEED)
        print(f"[cn-train] trees written in {time.perf_counter() - t0:.1f} s: stage 1 "
              f"{MIX_CLIPS} Motion-X clips, {MIX_TRACKS} FineDance train tracks and "
              f"{MIX_RECORDINGS} BEAT2 train recordings of {MIX_REC_FRAMES} frames (the "
              f"RepeatDataset times 100 / 2000 / 100 cut to 1); stage 2 {CN_S2G_RECORDINGS} "
              f"BEAT2 train recordings of {CN_S2G_FRAMES} frames and {CN_M2D_TRACKS} FineDance "
              f"train tracks; stage 3 one test recording of {CN_TEST_FRAMES} frames")
        t2m = train_stage(torch, "stage 1 t2m_motionx_0_125b (mixed)",
                          [t2m_config, "--device", str(dev), "--work-dir", "t2m",
                           "--max-epochs", "1", "--cfg-options", "data.train.text.times=1",
                           "data.train.music.times=1", "data.train.speech.times=1",
                           "evaluation=None", "log_config.interval=1"],
                          mix, training_counts(
                              1, Config.fromfile(t2m_config)["model"]["model"]["num_layers"]))
        out["t2m_mixed"] = t2m
        base_npz = os.path.join(t2m["work"], "params.npz")
        del t2m["state"], t2m["arch"]
        torch.cuda.empty_cache()

        rng = np.random.RandomState(SEED + 5)
        for tag, path, c, epochs in (
                ("s2g", s2g_config, rng.rand(2, 64 * 533, 2).astype(np.float32), 1),
                ("m2d", m2d_config, rng.randn(2, 196, 163).astype(np.float32),
                 CN_M2D_EPOCHS)):
            m = Config.fromfile(path)["model"]["model"]
            layers = m["base_model"]["num_layers"] + m["copy_blocks_num"]
            start = {}
            run = train_stage(torch, f"stage 2 {os.path.basename(path)[:-3]}",
                              [path, "--device", str(dev), "--work-dir", tag, "--base-checkpoint",
                               base_npz, "--max-epochs", str(epochs), "--cfg-options",
                               "log_config.interval=1", f"checkpoint_config.interval={epochs}"],
                              cn, training_counts(1, layers), controlnet_start(torch, c, start))
            frozen = {n for n, p in run["arch"].model.named_parameters() if not p.requires_grad}
            check_controlnet_result(torch, tag, os.path.join(run["work"], "params.npz"),
                                    base_npz, start, frozen)
            del run["state"], run["arch"], start
            torch.cuda.empty_cache()
            out[tag] = run

        # card vs CPU: one S2G training step on two windows of its train set
        cfg = Config.fromfile(s2g_config)
        here = os.getcwd()
        os.chdir(cn)
        try:
            dataset = build_dataset(cfg.data["train"])
            np.random.seed(SEED)
            batch = collate([dataset[0], dataset[1]])
        finally:
            os.chdir(here)
        with skip_init(torch):
            shapes = build_architecture(cfg["model"], device="cpu").model
        sd = fabricate_state_dict(shapes, seed=SEED + 18)
        frozen = load_tool("torch_train").frozen_prefixes(cfg["model"]["model"])
        phase_train_parity(torch, cfg["model"], sd, batch=batch, frozen=frozen,
                           tag="cn-train parity", card=dev)

        # stage 3: sample the trained S2G ControlNet
        tool = load_tool("torch_s2g_test")
        reset_launch_counts()
        run = checkpoint_run(torch, tool.main, [
            s2g_config, "--device", str(dev), "--checkpoint",
            os.path.join(out["s2g"]["work"], "params.npz"), "--seed", str(SEED),
            "--beats2-args", yaml_path, "--work-dir", os.path.join(tmp, "s2g_test")])
        counts = launch_counts()
        metric = {k: v for k, v in run["out"].items() if k not in ("flags", "protocol")}
        print(f"[cn-train] stage 3 tools/torch_s2g_test.py on the trained S2G ControlNet: "
              f"{run['windows']} windows in {run['sample_s']:.3f} s, metrics "
              f"{json.dumps(metric)}; launches {counts}")
        check(len(run["preds"]) == 1 and run["preds"][0].shape == (CN_TEST_FRAMES, 322)
              and np.isfinite(run["preds"][0]).all(), "stage 3's prediction")
        # the denoiser calls of one recording: DDIM over the first window,
        # RePaint's harmonized loop over each later one (phase 11's count)
        m = cfg["model"]["model"]
        layers = m["base_model"]["num_layers"] + m["copy_blocks_num"]
        steps = run["arch"].diffusion_test.num_timesteps
        win = cfg["windowed"]
        wins = num_windows(CN_TEST_FRAMES, win["window"], win["pre_frames"])
        calls = steps + (wins - 1) * sum(
            d for _, d in harmonize_schedule(steps, RepaintConfig(overlap_len=win["pre_frames"])))
        want = dict.fromkeys(counts, 0) | {
            "moe_route": layers * (calls + wins), "grouped_ffn": layers * (calls + wins),
            "head_ffn": layers * calls, "stma_linear_attention": layers * calls}
        check(run["windows"] == wins and counts == want,
              f"stage 3: {run['windows']} windows, launch counts {counts} != expected {want}")
        out["s2g_test"] = {"counts": counts}
        del run
    print(f"[cn-train] phase 18 took {time.perf_counter() - t_phase:.1f} s")
    return out



# ---------------------------------------------------------------- phase 19
def baseline_counts(model_cfg):
    """K4's positions, K5 and K6 launched a training step by a baseline (its
    forward; the backward recomputes their plain versions): two K5 a layer
    (MotionDiffuse's and MCM's self- or channel attention and their
    cross-attention; an MCM ControlNet's base and copied blocks alike), two
    MoEs a layer (FineMoGen's SAMI: K4's positions and K6 each), none for
    MDM, whose attention is the plain softmax one."""
    m = model_cfg["model"]
    if m["type"] == "ControlT2MHalfMCM":
        return {"fused_linear_attention": 2 * (m["base_model"]["num_layers"]
                                               + m["copy_blocks_num"])}
    if m["type"] in ("MotionDiffuseTransformer", "MCMTransformer"):
        return {"fused_linear_attention": 2 * m["num_layers"]}
    if m["type"] == "FineMoGenTransformer":
        return {"moe_positions": 2 * m["num_layers"], "fused_expert_ffn": 2 * m["num_layers"]}
    return {}


def keep_start(start):
    """``on_start`` that keeps the CLI's starting state_dict (on the host)
    in ``start``."""

    def on_start(arch):
        start.update({k: v.detach().cpu().clone() for k, v in arch.model.state_dict().items()})

    return on_start


def check_frozen(torch, tag, model, start, base=None):
    """After a run: every frozen parameter of ``model`` is where it started,
    bit for bit (and, with ``base``, a grafted base's flax-named params,
    the base checkpoint's); how many trainable ones moved."""
    from motioncraft_tpu_torch.utils.convert import from_jax_params

    sd = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    frozen = [n for n, p in model.named_parameters() if not p.requires_grad]
    moved = [n for n in frozen if not torch.equal(sd[n], start[n])]
    check(frozen and not moved, f"{tag}: frozen parameters that moved: {moved[:5]}")
    if base is not None:
        want = from_jax_params(base)
        off = [n for n in frozen if not torch.equal(sd[n], want[n[len("base_model."):]])]
        check(not off, f"{tag}: frozen parameters that are not the base's: {off[:5]}")
    trainable = [n for n, p in model.named_parameters() if p.requires_grad]
    still = sum(torch.equal(sd[n], start[n]) for n in trainable)
    where = "" if base is None else " (the base checkpoint's)"
    print(f"[bl-train] {tag}: {len(frozen)} frozen tensors bit for bit where they started"
          f"{where}; "
          f"{len(trainable) - still} of {len(trainable)} trainable tensors moved (a "
          f"zero-initialised output or residual projection holds the gradient back from the "
          f"layers behind it in the first steps)")


def phase_baseline_train(torch, dev="cuda", configs=BL_CONFIGS, m2d_config=MCM_M2D_CONFIG):
    """Phase 19: baseline training through tools/torch_train.py at full
    width on synthetic trees in the shipped configs' paths: stage 1, the
    Motion-X configs of MotionDiffuse, MCM, MDM and FineMoGen as shipped, a
    run each of BL_STEPS steps of its batch; stage 2, the MCM ControlNet
    (mcm_m2d_finedance.py) from stage 1's MCM params.npz; then card vs CPU
    on one training step of each (MDM at dropout 0)."""
    import tempfile

    import numpy as np
    from motioncraft_tpu_torch.config import Config, cfg_options_from_args
    from motioncraft_tpu_torch.data import collate
    from motioncraft_tpu_torch.data.datasets import finedance_split
    from motioncraft_tpu_torch.registry import build_architecture, build_dataset
    from motioncraft_tpu_torch.utils.checkpoint import load_params
    from motioncraft_tpu_torch.utils.convert import fabricate_state_dict

    t_phase = time.perf_counter()
    tool = load_tool("torch_train")
    cfgs = {os.path.basename(p)[:-3]: (p, Config.fromfile(p)) for p in configs}
    m2d = Config.fromfile(m2d_config)
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        data = os.path.join(tmp, "data")
        batches = {tag: c.data["samples_per_gpu"] for tag, (_, c) in cfgs.items()}
        write_motionx_tree(data, max(batches.values()), BL_FRAMES, SEED + 19, MIX_MOTIONX)
        ann = os.path.join(data, "datasets", "motionx")
        with open(os.path.join(ann, MIX_MOTIONX["ann"])) as f:
            names = f.read().split()
        for B in set(batches.values()):  # each run's set: its batch's first clips
            with open(os.path.join(ann, f"train_{B}.txt"), "w") as f:
                f.write("\n".join(names[:B]) + "\n")
        m2d_batch = m2d.data["samples_per_gpu"]
        write_finedance_tree(data, finedance_split("cross_genre")[0][:m2d_batch], CN_FRAMES,
                             SEED + 20)
        print(f"[bl-train] trees written in {time.perf_counter() - t0:.1f} s: "
              f"{len(names)} Motion-X clips of {BL_FRAMES} frames (each run's set its batch's "
              f"first clips: {batches}; the RepeatDataset times 100 cut to 1), {m2d_batch} "
              f"FineDance train tracks of 360 + {CN_FRAMES} frames")
        mcm_tag = os.path.basename(MCM_CONFIG)[:-3]
        for tag, (path, cfg) in cfgs.items():
            B, start = batches[tag], {}
            keep = BL_STEPS if tag == mcm_tag else BL_STEPS + 1  # stage 2's base only
            run = train_stage(torch, f"stage 1 {tag}",
                              [path, "--device", str(dev), "--work-dir", tag, "--max-epochs",
                               str(BL_STEPS), "--cfg-options", "data.train.times=1",
                               f"data.train.dataset.ann_file=train_{B}.txt",
                               "log_config.interval=1", f"checkpoint_config.interval={keep}"],
                              tmp, baseline_counts(cfg["model"]), keep_start(start),
                              steps=BL_STEPS, label="bl-train")
            check_frozen(torch, tag, run["arch"].model, start)
            del run["state"], run["arch"], start
            torch.cuda.empty_cache()
            out[tag] = run

        base_npz = os.path.join(out[mcm_tag]["work"], "params.npz")
        start = {}
        c = np.random.RandomState(SEED + 21).randn(2, BL_FRAMES, 163).astype(np.float32)
        run = train_stage(torch, "stage 2 mcm_m2d_finedance",
                          [m2d_config, "--device", str(dev), "--work-dir", "mcm_m2d",
                           "--base-checkpoint", base_npz, "--max-epochs", str(BL_STEPS),
                           "--cfg-options", "log_config.interval=1",
                           f"checkpoint_config.interval={BL_STEPS + 1}"],
                          tmp, baseline_counts(m2d["model"]), controlnet_start(torch, c, start),
                          steps=BL_STEPS, label="bl-train")
        check_frozen(torch, "mcm_m2d", run["arch"].model, start,
                     base=load_params(base_npz)["params"])
        del run["state"], run["arch"], start
        torch.cuda.empty_cache()
        out["mcm_m2d"] = run

        # card vs CPU: one training step of each, at full width on two
        # samples of its train set
        here = os.getcwd()
        for tag, path in [(t, p) for t, (p, _) in cfgs.items()] + [("mcm_m2d", m2d_config)]:
            cfg = Config.fromfile(path)
            if cfg.model["model"]["type"] == "MDMTransformer":
                cfg.merge_from_dict(cfg_options_from_args(["model.model.dropout=0"]))
            os.chdir(tmp)
            try:
                dataset = build_dataset(cfg.data["train"])
                np.random.seed(SEED)
                batch = collate([dataset[0], dataset[1]])
            finally:
                os.chdir(here)
            with skip_init(torch):
                shapes = build_architecture(cfg["model"], device="cpu").model
            sd = fabricate_state_dict(shapes, seed=SEED + 19)
            phase_train_parity(torch, cfg["model"], sd, batch=batch,
                               frozen=tool.frozen_prefixes(cfg["model"]["model"]),
                               tag=f"bl-train parity {tag}", card=dev)
    print(f"[bl-train] phase 19 took {time.perf_counter() - t_phase:.1f} s")
    return out


def bf16_training_counts(steps, layers, half="bf16"):
    """K4's positions, K5, the f32 K6 and the 16-bit K6 over ``steps`` bf16
    (or, ``half="f16"``, float16) training steps of the flagship: per layer
    the text MoE's slots (16-bit features, 16-bit weights) through the
    16-bit K6, the motion MoE's (f32 slots, the weights widened) through
    the f32 one."""
    return {"moe_positions": 2 * layers * steps, "fused_linear_attention": layers * steps,
            "fused_expert_ffn": layers * steps, f"fused_expert_ffn_{half}": layers * steps}


def half_train(torch, full_cfg, sd, batches, fp16, f32_step_ms=None, dev="cuda"):
    """Phase 20's half-precision steps: TRAIN_STEPS train_model steps of
    ``batches`` with ``fp16`` (BF16_TRAIN or F16_TRAIN) from ``sd``: finite
    losses, f32 masters, every trainable parameter moved (but the face
    head) and finite, CLIP unchanged, exact launches, every K5 call's
    operand dtypes recorded (K5 has no f16 instantiation and refuses f16);
    then one such step card vs CPU (phase 8's, gates pinned)."""
    import numpy as np
    from motioncraft_tpu_torch.apis import train_model
    from motioncraft_tpu_torch.apis.train import half_dtype
    from motioncraft_tpu_torch.ops import launch_counts, reset_launch_counts
    from motioncraft_tpu_torch.registry import build_architecture

    t0 = time.perf_counter()
    half = "f16" if half_dtype(fp16) == torch.float16 else "bf16"
    tag = f"{half}-train"
    cfg = full_cfg["model"]
    with skip_init(torch):
        arch = build_architecture(cfg, device=dev)
    arch.model.load_state_dict(sd, strict=True)
    before = {k: v.clone() for k, v in arch.model.state_dict().items()}
    lines, k5_dtypes = [], {}

    def log(msg):
        lines.append(msg)
        print(f"[{tag}] {msg}")

    def recorded(_, k5):
        def call(*args):
            key = "/".join(str(a.dtype).removeprefix("torch.") for a in args)
            k5_dtypes[key] = k5_dtypes.get(key, 0) + 1
            return k5(*args)
        return call

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    with kernel_sites(recorded, ("fused_linear_attention",)):
        state = train_model(arch, batches, optimizer_cfg=full_cfg["optimizer"],
                            lr_config=full_cfg["lr_config"], max_epochs=1,
                            steps_per_epoch=TRAIN_STEPS, seed=SEED, log_interval=1, logger=log,
                            fp16=fp16)
    torch.cuda.synchronize()
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    losses = [float(m.split(" loss=")[1].split()[0]) for m in lines if " loss=" in m]
    step_ms = [float(m.split("step_ms=")[1]) for m in lines if "step_ms=" in m]
    check(state.step == TRAIN_STEPS and len(losses) == TRAIN_STEPS
          and np.isfinite(losses).all(), f"{half} losses {losses}")
    after = arch.model.state_dict()
    check(all(v.dtype == before[k].dtype for k, v in after.items()),
          "a master parameter changed its dtype")
    check(all(torch.isfinite(v).all() for v in after.values() if v.is_floating_point()),
          f"a master parameter is not finite after the {half} steps")
    trainable = {n for n, p in arch.model.named_parameters() if p.requires_grad}
    frozen = [n for n in before if n.startswith("text_enc.clip.")]
    still = sorted(n for n in trainable if torch.equal(after[n], before[n]))
    check(frozen and all(torch.equal(after[n], before[n]) for n in frozen),
          "a frozen CLIP parameter changed")
    # the face head takes no loss; a key bias under the softmax over the
    # keys shifts every logit alike, so its gradient is zero up to rounding,
    # which bf16's coarse sums leave and f16's do not
    idle = ("out.face_out.",) + (("attn.key.bias",) if half == "f16" else ())
    check(all(n.startswith(idle[0]) or n.endswith(idle[1:]) for n in still),
          f"trainable parameters that did not move: {still[:5]}")
    want = dict.fromkeys(counts, 0) | bf16_training_counts(TRAIN_STEPS, arch.model.num_layers,
                                                           half=half)
    print(f"[{tag}] {TRAIN_STEPS} steps of B={TRAIN_BATCH} with fp16={fp16}: step wall ms "
          f"{step_ms} (first = warm-up; f32, phase 7: {f32_step_ms}); max memory allocated "
          f"{peak / 2**30:.3f} GiB; losses {losses}; launches {counts}; K5 calls by operand "
          f"dtypes {k5_dtypes}")
    check(counts == want, f"{half} training launch counts {counts} != expected {want}")
    check(all(counts[k] > 0 for k in bf16_training_counts(1, 1, half=half)),
          f"a kernel of the {half} training path was launched no time")
    check(not any("float16" in k.replace("bfloat16", "") for k in k5_dtypes),
          f"K5 was handed a float16 operand: {k5_dtypes}")
    del arch, state
    torch.cuda.empty_cache()

    # one such training step card vs CPU, B = 2, gate logits pinned
    phase_train_parity(torch, cfg, sd, tag=f"{tag}-parity", card=dev, fp16=fp16)
    print(f"[{tag}] the {half} steps took {time.perf_counter() - t0:.1f} s")
    return {"counts": counts, "step_ms": step_ms, "peak_gib": peak / 2**30,
            "k5_dtypes": k5_dtypes}


def phase_bf16_train(torch, full_cfg, sd, f32_step_ms=None, dev="cuda"):
    """Phase 20: the rest of training on the flagship with phase 3's
    weights: TRAIN_STEPS train_model steps of B = TRAIN_BATCH in bf16
    (``fp16=BF16_TRAIN``) and one card vs CPU (``half_train``), beside
    phase 7's f32 step times; one bf16 step of B = REMAT_BATCH with
    ``remat`` off and on (SGD at lr 0, so both see the same weights): the
    same loss, less memory with it on; one update of each of Adafactor,
    AdaBelief and LAMB on the flagship's trainable parameters from the same
    seeded gradients, card vs CPU; then the same steps in float16
    (``fp16=F16_TRAIN``)."""
    from motioncraft_tpu_torch.apis import make_train_batch, make_train_step, set_random_seed
    from motioncraft_tpu_torch.parallel import TrainState
    from motioncraft_tpu_torch.registry import build_architecture
    from motioncraft_tpu_torch.utils.card import card_line

    t_phase = time.perf_counter()
    cfg = full_cfg["model"]
    T = cfg["model"]["max_seq_len"]
    batches = [make_train_batch(TRAIN_BATCH, seed=SEED + i, max_seq_len=T)
               for i in range(TRAIN_STEPS)]
    bf16 = half_train(torch, full_cfg, sd, batches, BF16_TRAIN, f32_step_ms, dev)

    # remat off and on at B = REMAT_BATCH, one bf16 step each on the same weights
    with skip_init(torch):
        arch = build_architecture(cfg, device=dev)
    arch.model.load_state_dict(sd, strict=True)
    batch = make_train_batch(REMAT_BATCH, seed=SEED + 20, max_seq_len=T)
    state = TrainState(arch.model, {"type": "SGD", "lr": 0.0})
    step = make_train_step(arch, state, fp16=BF16_TRAIN)
    remat = {}
    arch.train()
    try:
        for on in (False, False, True):  # the first a warm-up
            arch.model.remat = on
            g = set_random_seed(SEED + 20, dev)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            loss = float(step(batch, g)["loss"])  # waits for the device
            remat[on] = {"loss": loss, "ms": (time.perf_counter() - t0) * 1e3,
                         "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    finally:
        arch.model.remat = False
        arch.eval()
    print(f"[bf16-train] B={REMAT_BATCH} bf16 step, remat off / on: loss "
          f"{remat[False]['loss']:.7f} / {remat[True]['loss']:.7f}, wall ms "
          f"{remat[False]['ms']:.1f} / {remat[True]['ms']:.1f}, max memory allocated "
          f"{remat[False]['peak_gib']:.3f} / {remat[True]['peak_gib']:.3f} GiB; "
          f"card {card_line()}")
    check(remat[True]["loss"] == remat[False]["loss"], "remat changed the loss")
    check(remat[True]["peak_gib"] < remat[False]["peak_gib"], "remat did not lower memory")
    del arch, state, step

    # one update of each optax-default optimizer, card vs CPU, the same gradients
    with skip_init(torch):
        models = {d: build_architecture(cfg, device=d).model for d in (dev, "cpu")}
    gen = torch.Generator().manual_seed(SEED + 21)
    grads = {n: torch.randn(p.shape, generator=gen) * 1e-3
             for n, p in models["cpu"].named_parameters() if not n.startswith("text_enc.clip.")}
    opts = {}
    for typ in ("Adafactor", "AdaBelief", "Lamb"):
        moved = {}
        for d, model in models.items():
            model.load_state_dict(sd, strict=True)
            st = TrainState(model, {"type": typ, "lr": full_cfg["optimizer"]["lr"]})
            for n, p in model.named_parameters():
                if p.requires_grad:
                    p.grad = grads[n].to(d)
            t0 = time.perf_counter()
            st.apply_gradients()
            if d != "cpu":
                torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            moved[d] = ({n: p.detach().cpu() for n, p in model.named_parameters()
                         if n in grads}, ms)
        (card, card_ms), (cpu, cpu_ms) = moved[dev], moved["cpu"]
        # each device rounds the updated parameter to its own f32 ulp: two
        # ulps of the largest parameter beside OPT_REL_TOL of the update
        worst = max((float((card[n] - cpu[n]).abs().max())
                     / (OPT_REL_TOL * float((cpu[n] - sd[n].cpu()).abs().max())
                        + 2.0 ** -22 * float(cpu[n].abs().max())), n) for n in cpu)
        check(any(not torch.equal(cpu[n], sd[n].cpu()) for n in cpu), f"{typ} moved nothing")
        print(f"[bf16-train] {typ} update of {len(cpu)} tensors: worst max|card - CPU| / "
              f"(OPT_REL_TOL x max|CPU update| + 2 ulp of max|CPU|) = {worst[0]:.3e} at "
              f"{worst[1]} (tol 1); card {card_ms:.1f} ms, CPU {cpu_ms:.1f} ms wall")
        check(worst[0] <= 1.0, f"{typ} update card vs CPU: {worst}")
        opts[typ] = {"worst": worst[0], "card_ms": card_ms}
    del models
    torch.cuda.empty_cache()
    f16 = half_train(torch, full_cfg, sd, batches, F16_TRAIN, f32_step_ms, dev)
    print(f"[bf16-train] phase 20 took {time.perf_counter() - t_phase:.1f} s")
    return {**bf16, "remat": remat, "optimizers": opts, "f16": f16}


# ---------------------------------------------------------------- phase 21
def patch_kernel_sites(wrap, names=None):
    """Point the models' kernel sites (the wrappers that models/moe.py,
    models/attentions.py and models/blocks.py call, by name; all of them,
    or those in ``names``) at ``wrap(name, fn)``, ``fn`` the site's current
    one.  Returns a function that puts them back."""
    from motioncraft_tpu_torch.models import attentions, blocks, moe

    sites = {"moe_positions_counts": moe, "fused_expert_ffn": moe, "moe_route": moe,
             "grouped_ffn": moe, "fused_linear_attention": attentions,
             "stma_linear_attention": attentions, "head_ffn": blocks}
    old = [(sites[n], n, getattr(sites[n], n)) for n in names or sites]
    for mod, n, fn in old:
        setattr(mod, n, wrap(n, fn))

    def restore():
        for mod, n, fn in old:
            setattr(mod, n, fn)
    return restore


@contextlib.contextmanager
def kernel_sites(wrap, names=None):
    """patch_kernel_sites while the block runs."""
    restore = patch_kernel_sites(wrap, names)
    try:
        yield
    finally:
        restore()


def cpu_launch_counting():
    """A rehearsal on the CPU: the wrappers count no launches there (they
    run their plain versions), so stand-ins that the models call bump each
    wrapper's count as its launch would.  They stay for the process; each
    wraps the ops module's wrapper, so a second call counts once."""
    from motioncraft_tpu_torch import ops

    def counted(name, _):
        wrapper = getattr(ops, name)

        def call(*args, **kwargs):
            wrapper.launches += 1
            return wrapper(*args, **kwargs)
        return call

    patch_kernel_sites(counted)


def dp_device(torch, kind, rank):
    """A rank's device: the CPU in a rehearsal, else the card rank modulo
    the cards (every rank on the one card where there is one)."""
    if kind == "cpu":
        torch.set_num_threads(2)  # the ranks share the host's cores
        return torch.device("cpu")
    dev = torch.device("cuda", rank % torch.cuda.device_count())
    torch.cuda.set_device(dev)
    return dev


def dp_train_part(torch, part, mesh, dev):
    """One of phase 21's training runs, through train_model on ``dev``:
    the model ``part["cfg"]`` from the weights in ``part["sd"]`` over the
    batches in ``part["batches"]`` (this rank's rows on a mesh), Adam as
    the config's recipe.  Without a mesh (the one-process reference) every
    MoE gate's logits are recorded into ``part["pins"]``; on a mesh each
    gate call takes its rows of them (as values; the gradient flows through
    its own gate), so a near-tie between logits computed at 64 rows and at
    128 cannot route a token differently.  Returns the losses, step ms,
    launches, max memory, the trainable parameters and BatchNorm
    statistics after the steps (rank 0 writes its parameters to
    ``part["rank0"]``), and on a mesh the ranks' largest parameter
    difference and the gradient all-reduce's ms."""
    import numpy as np
    import torch.distributed as tdist
    from motioncraft_tpu_torch.apis import train_model
    from motioncraft_tpu_torch.models.moe import CosineTopGate
    from motioncraft_tpu_torch.ops import launch_counts, reset_launch_counts
    from motioncraft_tpu_torch.parallel.mesh import shard_batch
    from motioncraft_tpu_torch.registry import build_architecture
    from motioncraft_tpu_torch.utils.dist_utils import allreduce_grads

    class Pin(torch.autograd.Function):
        """The given value, the identity's gradient."""

        @staticmethod
        def forward(ctx, out, value):
            return value.clone()

        @staticmethod
        def backward(ctx, grad):
            return grad, None

    with skip_init(torch):
        arch = build_architecture(part["cfg"], device=dev)
    arch.model.load_state_dict(torch.load(part["sd"], map_location=dev), strict=True)
    batches = [shard_batch(dict(np.load(f)), mesh) for f in part["batches"]]
    pins = {} if mesh is None else torch.load(part["pins"])
    calls = dict.fromkeys(pins, 0)

    def hook(name):
        def fn(mod, inp, out):
            if mesh is None:
                pins.setdefault(name, []).append(out.detach().cpu())
                return None
            i, n = calls[name], out.shape[0]
            calls[name] = i + 1
            want = pins[name][i][mesh.rank * n:(mesh.rank + 1) * n].to(out.device)
            return Pin.apply(out, want)
        return fn

    handles = [m.register_forward_hook(hook(n)) for n, m in arch.model.named_modules()
               if isinstance(m, CosineTopGate)]
    lines = []
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    reset_launch_counts()
    state = train_model(arch, batches, optimizer_cfg=part["optimizer"],
                        lr_config=part["lr_config"], max_epochs=1,
                        steps_per_epoch=len(batches), seed=SEED, log_interval=1,
                        logger=lines.append, frozen_prefixes=part["frozen"], mesh=mesh)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    counts = launch_counts()
    for h in handles:
        h.remove()
    out = {"losses": [float(m.split(" loss=")[1].split()[0]) for m in lines if " loss=" in m],
           "step_ms": [float(m.split("step_ms=")[1]) for m in lines if "step_ms=" in m],
           "counts": counts, "steps": state.step,
           "peak_gib": torch.cuda.max_memory_allocated(dev) / 2**30 if dev.type == "cuda"
           else None,
           "stats": {k: v.cpu().clone() for k, v in arch.model.state_dict().items()
                     if "running_" in k}}
    params = [(n, p) for n, p in arch.model.named_parameters() if p.requires_grad]
    if mesh is None:
        torch.save(pins, part["pins"])
        out["params"] = {n: p.detach().cpu().clone() for n, p in params}
    else:
        worst = 0.0
        for _, p in params:  # every rank's parameters against rank 0's
            ref = p.detach().clone()
            tdist.broadcast(ref, src=0)
            worst = max(worst, float((p.detach() - ref).abs().max()))
        out["rank_diff"] = worst
        out["pinned"] = all(calls[n] == len(pins[n]) for n in pins) and bool(pins)
        if mesh.rank == 0:
            torch.save({n: p.detach().cpu() for n, p in params}, part["rank0"])
        # the gradient all-reduce alone: one flat buffer of every trainable
        # gradient, as a step sends it (once: the steps warmed the group up;
        # three calls after a fourth took 3-9 s a rank over gloo)
        for _, p in params:
            p.grad = torch.zeros_like(p)
        grads = [p for _, p in params]
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        allreduce_grads(grads, mesh)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        out["allreduce_ms"] = (time.perf_counter() - t0) * 1e3
        out["allreduce_mib"] = sum(p.numel() for p in grads) * 4 / 2**20
    del arch, state, params
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def dp_rank(rank, kind, parts, eval_argv=None):
    """A rank of phase 21: its device, the data mesh of the joined group,
    each training part of ``parts`` in turn, then (``eval_argv``) the
    evaluation."""
    import torch
    from motioncraft_tpu_torch.parallel.mesh import create_mesh

    dev = dp_device(torch, kind, rank)
    if dev.type == "cpu":
        cpu_launch_counting()
    mesh = create_mesh(device=dev)
    out = {part["tag"]: dp_train_part(torch, part, mesh, dev) for part in parts}
    if eval_argv is not None:
        out["eval"] = dp_eval(eval_argv, mesh, dev)
    return out


def dp_eval(argv, mesh, dev):
    """tools/torch_test.py (``argv``) in the joined group: its launches and
    merged results (rank 0's predictions from its dump, written before its
    evaluation rewrites the results); then this process alone over its
    slice of the same dataset (seed + rank, two batches a dispatch), whose
    predictions must be its part of the merged ones bit for bit."""
    import numpy as np
    import torch
    from motioncraft_tpu_torch.apis import single_device_test
    from motioncraft_tpu_torch.data import build_dataloader
    from motioncraft_tpu_torch.ops import launch_counts, reset_launch_counts

    torch_test = load_tool("torch_test")
    args = torch_test.parse_args(argv)
    reset_launch_counts()
    run = checkpoint_run(torch, torch_test.run, args, logger=lambda m: None)
    counts = launch_counts()
    merged = (np.load(args.dump_samples + ".npz")["pred_motion"] if run["out"] else
              np.stack([r["pred_motion"] for r in run["results"]]))
    dataset = run["dataset"]
    loader = build_dataloader(dataset, samples_per_gpu=args.batch_size, shuffle=False,
                              round_up=True, dist=True)
    loader.drop_last = False
    alone = single_device_test(run["arch"], loader, seed=args.seed + mesh.rank, device=dev,
                               dispatch_batches=2)
    n = len(range(mesh.rank, len(merged), mesh.world))
    mine = np.stack([r["pred_motion"] for r in alone])[:n]
    return {"counts": counts, "texts": [r["text"] for r in run["results"]],
            "order": [dataset[i]["motion_metas"]["text"] for i in range(len(dataset))],
            "merged": merged, "alone": bool(np.array_equal(mine, merged[mesh.rank::mesh.world])),
            "alone_texts": [r["text"] for r in alone][:n] == [
                r["text"] for r in run["results"]][mesh.rank::mesh.world],
            "sample_s": run["sample_s"], "out": run["out"]}


def phase_data_parallel(torch, full_cfg, sd, dev="cuda", config=CONFIG, s2g_config=S2G_CONFIG,
                        batch=None, s2g_batch=DP_S2G_BATCH, eval_clips=DP_EVAL_CLIPS):
    """Phase 21: data-parallel training and multi-process evaluation (see
    the module docstring).  ``dev`` "cpu" rehearses it on the CPU with gloo
    everywhere and counting stand-ins in every process."""
    import tempfile

    import numpy as np
    import torch.distributed as tdist
    from motioncraft_tpu_torch.apis import make_train_batch, train_model
    from motioncraft_tpu_torch.config import Config
    from motioncraft_tpu_torch.diffusion import build_diffusion
    from motioncraft_tpu_torch.ops import launch_counts, reset_launch_counts
    from motioncraft_tpu_torch.parallel.mesh import create_mesh, launch
    from motioncraft_tpu_torch.registry import build_architecture
    from motioncraft_tpu_torch.utils.card import card_line
    from motioncraft_tpu_torch.utils.checkpoint import save_params
    from motioncraft_tpu_torch.utils.convert import fabricate_state_dict

    t_phase = time.perf_counter()
    kind = torch.device(dev).type
    main_dev = dp_device(torch, kind, 0)
    if kind == "cpu":
        cpu_launch_counting()
    card = card_line() if kind == "cuda" else "CPU rehearsal"
    cfg = full_cfg["model"]
    T = cfg["model"]["max_seq_len"]
    batch = batch or full_cfg["data"]["samples_per_gpu"]
    s2g_cfg = Config.fromfile(s2g_config)
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        # the flagship at its config's global batch, and the S2G ControlNet
        # (its WavEncoder's BatchNorm) at a global batch of s2g_batch
        rng = np.random.RandomState(SEED + 21)
        t2m = dict(tag="t2m", cfg=cfg, sd=os.path.join(tmp, "t2m.pt"), frozen=("text_enc/clip",),
                   optimizer=full_cfg["optimizer"], lr_config=full_cfg["lr_config"],
                   pins=os.path.join(tmp, "t2m_pins.pt"), rank0=os.path.join(tmp, "t2m_r0.pt"),
                   batches=[])
        torch.save({k: v.cpu() for k, v in sd.items()}, t2m["sd"])
        for i in range(DP_STEPS):
            path = os.path.join(tmp, f"t2m_{i}.npz")
            np.savez(path, **make_train_batch(batch, seed=SEED + 210 + i, max_seq_len=T))
            t2m["batches"].append(path)
        with skip_init(torch):
            shapes = build_architecture(s2g_cfg["model"], device="cpu").model
        # the S2G step with SGD at the config's lr: its update is the
        # gradient, held as phase 8 holds one (Adam's first step is lr times
        # each gradient's sign, which rounding flips where the BatchNorms'
        # backward cancels a gradient to near 0)
        s2g = dict(tag="s2g", cfg=s2g_cfg["model"], sd=os.path.join(tmp, "s2g.pt"),
                   frozen=load_tool("torch_train").frozen_prefixes(s2g_cfg["model"]["model"]),
                   optimizer=dict(type="SGD", lr=s2g_cfg["optimizer"]["lr"], momentum=0.0),
                   lr_config=s2g_cfg["lr_config"],
                   pins=os.path.join(tmp, "s2g_pins.pt"), rank0=os.path.join(tmp, "s2g_r0.pt"),
                   batches=[os.path.join(tmp, "s2g_0.npz")])
        torch.save(fabricate_state_dict(shapes, seed=SEED + 21), s2g["sd"])
        del shapes
        sb = make_train_batch(s2g_batch, seed=SEED + 219, max_seq_len=DP_S2G_FRAMES)
        spf = s2g_cfg["windowed"]["audio_sr"] // s2g_cfg["windowed"]["pose_fps"]
        n = DP_S2G_FRAMES * spf  # onset + amplitude at 16 kHz
        sb["c"] = np.stack([np.abs(rng.randn(s2g_batch, n)) * 0.3,
                            (rng.rand(s2g_batch, n) < 2e-3).astype(np.float64)],
                           axis=-1).astype(np.float32)
        np.savez(s2g["batches"][0], **sb)
        parts = [t2m, s2g]
        # (d)'s inputs: tools/torch_test.py on a tree of eval_clips clips
        tree = os.path.join(tmp, "data")
        write_motionx_tree(tree, eval_clips, T, SEED + 21)

        def write(path):
            with skip_init(torch):
                mem = build_architecture(cfg, device="cpu")
            mem.model.load_state_dict({k: v.cpu() for k, v in sd.items()}, strict=True)
            save_params(path, mem.model)

        params = snapshot(tmp, "params.npz", ("t2m", id(sd)), write)
        metrics = [dict(type="R Precision", batch_size=min(32, eval_clips), top_k=3),
                   dict(type="Matching Score", batch_size=min(32, eval_clips)),
                   dict(type="FID", emb_scale=1.0),
                   dict(type="Diversity", num_samples=eval_clips // 2)]
        argv = [config, os.path.join(tmp, "eval"), "--device", kind, "--batch-size",
                str(BATCH), "--checkpoint", params, "--seed", str(SEED),
                "--dist-backend", "gloo", "--dump-samples", os.path.join(tmp, "dump"),
                "--cfg-options", f"data.test.data_prefix={tree}",
                "data.test.ann_file=ann.txt", "data.test.motion_dir=motions",
                "data.test.text_dir=texts", "data.test.eval_cfg.replication_times=1",
                f"data.test.eval_cfg.metrics={metrics!r}"]

        # (a, b) the one-process references first, each freed before the next
        ref = {}
        for part in parts:
            ref[part["tag"]] = dp_train_part(torch, part, None, main_dev)
        print(f"[dp] one process: flagship B={batch} {DP_STEPS} steps, step ms "
              f"{ref['t2m']['step_ms']} (first = warm-up), losses {ref['t2m']['losses']}, "
              f"max memory {ref['t2m']['peak_gib']} GiB; S2G ControlNet B={s2g_batch} one "
              f"step, loss {ref['s2g']['losses']}; card {card}")

        # (a, b, d) two ranks on the one card over gloo, CUDA tensors: the
        # training parts, then tools/torch_test.py over the two processes
        t0 = time.perf_counter()
        ranks = launch(dp_rank, DP_WORLD, args=(kind, parts, argv), backend="gloo",
                       init_method=f"file://{os.path.join(tmp, 'gloo')}",
                       timeout_s=DP_TIMEOUT_S, group_timeout_s=DP_TIMEOUT_S)
        wall = time.perf_counter() - t0
        for part in parts:
            tag, one = part["tag"], ref[part["tag"]]
            layers = (part["cfg"]["model"].get("num_layers")
                      or part["cfg"]["model"]["base_model"]["num_layers"]
                      + part["cfg"]["model"]["copy_blocks_num"])
            want = dict.fromkeys(one["counts"], 0) | training_counts(len(part["batches"]),
                                                                    layers)
            rank0 = torch.load(part["rank0"])
            for r, res in enumerate(ranks):
                got = res[tag]
                local = (batch if tag == "t2m" else s2g_batch) // DP_WORLD
                timed = got["step_ms"][1:] or got["step_ms"]
                print(f"[dp] {tag} rank {r}: {len(got['losses'])} steps of {local} rows, step "
                      f"ms {got['step_ms']} (first = warm-up), "
                      f"{local / (np.median(timed) / 1e3):.1f} samples/s a rank, max memory "
                      f"{got['peak_gib']} GiB, gradient all-reduce {got['allreduce_ms']:.1f} ms "
                      f"for {got['allreduce_mib']:.1f} MiB (gloo, {kind} tensors), launches "
                      f"{got['counts']}; card {card}")
                check(got["steps"] == len(part["batches"]) and got["pinned"],
                      f"{tag} rank {r}: steps {got['steps']}, every gate pinned {got['pinned']}")
                check(got["counts"] == want, f"{tag} rank {r} launches {got['counts']} != {want}")
                check(got["rank_diff"] == 0.0, f"{tag} rank {r} parts from rank 0's parameters "
                      f"by {got['rank_diff']}")
                for i, (a, b) in enumerate(zip(got["losses"], one["losses"])):
                    tol = MODEL_REL_TOL * max(1.0, abs(b)) + 1e-5  # printed to 5 decimals
                    check(abs(a - b) <= tol, f"{tag} step {i} loss {a} against one process {b}")
                for k, v in one["stats"].items():
                    diff = float((got["stats"][k] - v).abs().max())
                    check(diff <= MODEL_REL_TOL * max(1.0, float(v.abs().max())),
                          f"{tag} rank {r} BatchNorm {k} against one process: {diff}")
            # the updated parameters: after Adam each element within
            # DP_PARAM_TOL x lr of the one-process step's but for
            # DP_PARAM_FRAC of a tensor, those within two lr a step; after SGD
            # the gradient within GRAD_REL_TOL of max(1, scale), as phase 8
            lr, start = part["optimizer"]["lr"], torch.load(part["sd"])
            worst, outliers = 0.0, 0
            for n, want_p in one["params"].items():
                diff = (rank0[n] - want_p).abs()
                if part["optimizer"]["type"] == "SGD":  # the update is lr x gradient
                    grad = (want_p - start[n].cpu()).abs() / lr
                    rel = float(diff.max()) / lr / max(1.0, float(grad.max()))
                    worst = max(worst, rel)
                    check(rel <= GRAD_REL_TOL, f"{tag} {n}: gradient {rel:.3e} of scale")
                    continue
                far = int((diff > DP_PARAM_TOL * lr).sum())
                worst, outliers = max(worst, float(diff.max()) / lr), outliers + far
                check(far <= max(1, int(DP_PARAM_FRAC * diff.numel()))
                      and float(diff.max()) <= 2 * len(part["batches"]) * lr,
                      f"{tag} {n}: {far} elements past {DP_PARAM_TOL} lr, max "
                      f"{float(diff.max()) / lr:.3g} lr")
            moved = sum(not torch.equal(rank0[n], start[n].cpu()) for n in one["params"])
            held = (f"worst gradient {worst:.3e} of max(1, scale) (tol {GRAD_REL_TOL})"
                    if part["optimizer"]["type"] == "SGD" else
                    f"largest difference {worst:.3e} lr, {outliers} elements past "
                    f"{DP_PARAM_TOL} lr")
            print(f"[dp] {tag}: 2 ranks vs one process: losses {ranks[0][tag]['losses']} / "
                  f"{one['losses']}; {len(one['params'])} trainable tensors ({moved} moved), "
                  f"{held}; {len(one['stats'])} BatchNorm running statistics within "
                  f"{MODEL_REL_TOL} of scale")
            out[tag] = {"counts": ranks[0][tag]["counts"],
                        "step_ms": [res[tag]["step_ms"] for res in ranks],
                        "allreduce_ms": [res[tag]["allreduce_ms"] for res in ranks],
                        "one_step_ms": one["step_ms"]}
        print(f"[dp] two ranks (training, both parts, then the evaluation) took {wall:.1f} s")

        # (d) the evaluation's checks
        ev = [r["eval"] for r in ranks]
        per_rank = -(-eval_clips // DP_WORLD)
        batches = -(-per_rank // BATCH)
        steps = build_diffusion(cfg["diffusion_test"]).num_timesteps
        want = sampling_counts(batches, batches * steps, cfg["model"]["num_layers"])
        metric = {k: v for k, v in ev[0]["out"].items() if k not in ("flags", "protocol")}
        print(f"[dp] tools/torch_test.py over {DP_WORLD} processes on one card (gloo): "
              f"{eval_clips} clips, {per_rank} a rank at batch {BATCH}, sampling "
              f"{[round(e['sample_s'], 3) for e in ev]} s; metrics on rank 0 "
              f"{json.dumps(metric)}; launches {[e['counts'] for e in ev]}; card {card}")
        check(ev[1]["out"] is None and all(np.isfinite(v) for v in metric.values()),
              "metrics on rank 0 alone, finite")
        for r, e in enumerate(ev):
            check(e["counts"] == dict.fromkeys(e["counts"], 0) | want,
                  f"eval rank {r} launches {e['counts']} != {want}")
            print(f"[dp] rank {r}'s {per_rank} predictions against this process alone over "
                  f"its slice (seed + {r}), --dispatch-batches 2: bit for bit {e['alone']}")
            check(e["alone"] and e["alone_texts"],
                  f"rank {r}'s predictions differ from one process over its slice")
        check(all(len(e["texts"]) == eval_clips and e["texts"] == e["order"] for e in ev)
              and np.array_equal(ev[0]["merged"], ev[1]["merged"]),
              "the merged results are not every clip once, in dataset order, on both ranks")
        out["eval"] = {"counts": ev[0]["counts"], "sample_s": [e["sample_s"] for e in ev]}
        del ranks, ev

        # (c) a one-rank NCCL group through the same code path: one step
        if kind == "cuda":
            tdist.init_process_group("nccl", init_method=f"file://{os.path.join(tmp, 'nccl1')}",
                                     world_size=1, rank=0)
            try:
                mesh = create_mesh(device=main_dev)
                with skip_init(torch):
                    arch = build_architecture(cfg, device=main_dev)
                arch.model.load_state_dict(sd, strict=True)
                lines = []
                reset_launch_counts()
                state = train_model(arch, [make_train_batch(TRAIN_BATCH, seed=SEED + 220,
                                                            max_seq_len=T)],
                                    optimizer_cfg=full_cfg["optimizer"], max_epochs=1,
                                    seed=SEED, log_interval=1, logger=lines.append, mesh=mesh)
                torch.cuda.synchronize()
                counts = launch_counts()
                loss = float(lines[0].split(" loss=")[1].split()[0])
                print(f"[dp] one-rank NCCL group ({mesh.backend}): one step of "
                      f"{TRAIN_BATCH}, loss {loss:.5f}, launches {counts}")
                check(state.step == 1 and np.isfinite(loss)
                      and counts == dict.fromkeys(counts, 0) | training_counts(
                          1, cfg["model"]["num_layers"]), "the one-rank NCCL step")
                del arch, state
            finally:
                tdist.destroy_process_group()
            torch.cuda.empty_cache()
        if kind == "cuda" and torch.cuda.device_count() >= DP_WORLD:
            ranks = launch(dp_rank, DP_WORLD, args=(kind, parts[:1]), backend="nccl",
                           init_method=f"file://{os.path.join(tmp, 'nccl_train')}",
                           timeout_s=DP_TIMEOUT_S, group_timeout_s=DP_TIMEOUT_S)
            for r, res in enumerate(ranks):
                got = res["t2m"]
                print(f"[dp] NCCL rank {r} on cuda:{r}: step ms {got['step_ms']}, gradient "
                      f"all-reduce {got['allreduce_ms']:.1f} ms, losses {got['losses']}")
                check(got["rank_diff"] == 0.0 and got["pinned"], f"NCCL rank {r}")
            out["nccl_step_ms"] = [res["t2m"]["step_ms"] for res in ranks]
        else:
            print(f"[dp] NCCL across cards not run: {torch.cuda.device_count()} card(s) here "
                  f"({card})")

    print(f"[dp] phase 21 took {time.perf_counter() - t_phase:.1f} s")
    return out


def gate_pins(torch, model, mesh, pins):
    """Forward hooks on every MoE gate of ``model``: without a mesh each
    call's logits are appended to ``pins`` ({gate: [logits a call]}, on the
    host); on a mesh each call's logits become this rank's tokens of the
    pinned call's (parallel/mesh.py:token_rows over the MoE's blocks of
    rows: one in training, the CFG halves in sampling), the gradient through
    its own gate, as phase 21 pins them.  Returns the hooks and the calls
    made, by gate."""
    from motioncraft_tpu_torch.models.moe import CosineTopGate, MoELayer
    from motioncraft_tpu_torch.parallel.mesh import token_rows

    class Pin(torch.autograd.Function):
        """The given value, the identity's gradient."""

        @staticmethod
        def forward(ctx, out, value):
            return value.clone()

        @staticmethod
        def backward(ctx, grad):
            return grad, None

    blocks, calls, handles = {}, {}, []
    for name, m in model.named_modules():
        if isinstance(m, MoELayer):
            def pre(mod, args, kwargs, name=name):
                blocks[name] = kwargs.get("blocks", 1)
            handles.append(m.register_forward_pre_hook(pre, with_kwargs=True))
        elif isinstance(m, CosineTopGate):
            def hook(mod, inp, out, name=name, layer=name.rsplit(".", 1)[0]):
                i = calls.get(name, 0)
                calls[name] = i + 1
                if mesh is None:
                    pins.setdefault(name, []).append(out.detach().cpu())
                    return None
                rows = token_rows(mesh, out.shape[0], blocks.get(layer, 1), out.device)
                return Pin.apply(out, pins[name][i].to(out.device)[rows])
            handles.append(m.register_forward_hook(hook))
    return handles, calls


def mp_requests(T):
    """Phase 22's serving traffic: (text, length) of MP_SERVE_REQUESTS
    requests of up to T frames, in dispatches of the largest bucket."""
    return [(f"a person performs motion {i} with both arms", max(1, T * (40 + 19 * i) // 196))
            for i in range(MP_SERVE_REQUESTS)]


def mp_serve(torch, cfg, sd, mesh, dev, pins):
    """Phase 22's server over ``mesh`` (every rank; rank 0 submits the
    traffic a dispatch at a time, the others follow) or one process: the
    outputs, requests/s and launches on rank 0."""
    from motioncraft_tpu_torch.ops import launch_counts, reset_launch_counts
    from motioncraft_tpu_torch.registry import build_architecture
    from motioncraft_tpu_torch.serving import MotionGenServer

    with skip_init(torch):
        arch = build_architecture(cfg, device=dev)
    arch.model.load_state_dict(sd, strict=True)
    arch.eval()
    handles, calls = gate_pins(torch, arch.model, mesh, pins)
    srv = MotionGenServer(arch, max_seq_len=cfg["model"]["max_seq_len"],
                          input_feats=cfg["model"]["input_feats"],
                          batch_buckets=MP_SERVE_BUCKETS, max_wait_ms=200.0, seed=SEED + 22,
                          mesh=mesh)
    reset_launch_counts()
    out = None
    try:
        if mesh is not None and not mesh.lead:
            srv.follow()
        else:
            reqs, big = mp_requests(cfg["model"]["max_seq_len"]), MP_SERVE_BUCKETS[-1]
            t0 = time.perf_counter()
            outs = []
            for i in range(0, len(reqs), big):  # each group fills the largest bucket
                group = reqs[i:i + big]
                outs += srv.generate([t for t, _ in group], [n for _, n in group],
                                     timeout=MP_TIMEOUT_S)
            wall = time.perf_counter() - t0
            srv.stop()
            out = {"outs": outs, "rps": len(reqs) / wall, "wall_s": wall,
                   "stats": srv.stats()}
    finally:
        srv.stop()
        for h in handles:
            h.remove()
    counts = launch_counts()
    if out is not None:
        out["counts"], out["calls"] = counts, sum(calls.values())
    del arch, srv
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def mp_sample(torch, cfg, sd, mesh, dev, pins, batch):
    """One CFG batch on MP_SAMPLE_RESPACE's schedule over ``mesh``
    (``apis/test.py:mesh_sample``; the model cut to this rank's shards) or
    in one process, gate logits pinned / recorded: the output and the
    launches."""
    from motioncraft_tpu_torch.apis import mesh_sample
    from motioncraft_tpu_torch.ops import launch_counts, reset_launch_counts
    from motioncraft_tpu_torch.parallel.tp import shard_module_
    from motioncraft_tpu_torch.registry import build_architecture

    cfg = dict(cfg, diffusion_test=dict(cfg["diffusion_test"], respace=MP_SAMPLE_RESPACE))
    with skip_init(torch):
        arch = build_architecture(cfg, device=dev)
    arch.model.load_state_dict(sd, strict=True)
    shard_module_(arch.model, mesh)
    arch.eval()
    handles, _ = gate_pins(torch, arch.model, mesh, pins)
    reset_launch_counts()
    t0 = time.perf_counter()
    try:
        with torch.inference_mode():
            got = mesh_sample(arch, batch, mesh,
                              generator=torch.Generator(device=dev).manual_seed(SEED + 22))
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    finally:
        for h in handles:
            h.remove()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    del arch
    return got.float().cpu(), counts, wall


def mp_shard_report(torch, state, mesh):
    """A rank's parameter and optimizer bytes and the local shapes of the
    first layer's expert and SFFN leaves."""
    model = state.model
    pbytes = sum(p.numel() * p.element_size() for p in model.parameters())
    obytes = sum(v.numel() * v.element_size() for st in state.optimizer.state.values()
                 for v in st.values() if torch.is_tensor(v))
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()
              if k in ("block_0.ca_block.motion_moe.model.expert_w1",
                       "block_0.ca_block.text_moe.model.expert_w1", "block_0.ffn.w1",
                       "text_enc.clip.resblock_0.mlp_fc.weight",
                       "text_enc.clip.token_embedding.weight")}
    return {"param_bytes": pbytes, "opt_bytes": obytes, "shapes": shapes}


def mp_train(torch, job, sd, mesh, dev):
    """One mesh of phase 22: its training steps through train_model on this
    rank's rows (the model cut to its shards there), gate logits pinned to
    the one-process run's rows, then its sampling batch; returns losses,
    step ms, launches, the collectives' calls, bytes and ms, the bytes and
    shapes this rank holds, and (rank 0) the whole parameters' distance to
    one process's and the sample's."""
    import numpy as np
    from motioncraft_tpu_torch.apis import train_model
    from motioncraft_tpu_torch.ops import launch_counts, reset_launch_counts
    from motioncraft_tpu_torch.parallel.mesh import shard_batch
    from motioncraft_tpu_torch.parallel.tp import full_state_dict
    from motioncraft_tpu_torch.registry import build_architecture
    from motioncraft_tpu_torch.utils.dist_utils import traffic

    cfg = job["cfg"]
    with skip_init(torch):
        arch = build_architecture(cfg, device=dev)
    arch.model.load_state_dict(sd, strict=True)
    batches = [shard_batch(dict(np.load(f)), mesh) for f in job["batches"]]
    handles, calls = gate_pins(torch, arch.model, mesh, torch.load(job["pins"]))
    lines = []
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    reset_launch_counts()
    traffic(reset=True, timing=True)
    state = train_model(arch, batches, optimizer_cfg=job["optimizer"],
                        lr_config=job["lr_config"], max_epochs=1, steps_per_epoch=len(batches),
                        seed=SEED, log_interval=1, logger=lines.append,
                        frozen_prefixes=("text_enc/clip",), mesh=mesh)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    counts, coll = launch_counts(), traffic(reset=True)
    for h in handles:
        h.remove()
    out = {"losses": [float(m.split(" loss=")[1].split()[0]) for m in lines if " loss=" in m],
           "step_ms": [float(m.split("step_ms=")[1]) for m in lines if "step_ms=" in m],
           "counts": counts, "traffic": coll, "steps": state.step,
           "pinned": bool(calls) and all(n > 0 for n in calls.values()),
           "peak_gib": torch.cuda.max_memory_allocated(dev) / 2**30 if dev.type == "cuda"
           else None, **mp_shard_report(torch, state, mesh)}
    whole = full_state_dict(arch.model, state.sharding)
    if mesh.lead:
        want = torch.load(job["ref_params"])
        lr = job["optimizer"]["lr"]
        worst, far = 0.0, 0
        for n, w in want.items():
            diff = (whole[n] - w).abs()
            worst = max(worst, float(diff.max()) / lr)
            far += int(((diff > DP_PARAM_TOL * lr).sum() > max(1, int(DP_PARAM_FRAC * diff.numel())))
                       or float(diff.max()) > 2 * len(batches) * lr)
        out["param_worst_lr"], out["param_far_tensors"] = worst, far
        out["moved"] = sum(not torch.equal(whole[n], sd[n].cpu()) for n in want)
    del arch, state, whole
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    got, scounts, wall = mp_sample(torch, cfg, sd, mesh, dev, torch.load(job["sample_pins"]),
                                   job["sample_batch"])
    want = torch.load(job["sample_ref"])
    out["sample_err"] = float((got - want).abs().max())
    out["sample_scale"] = float(want.abs().max())
    out["sample_counts"], out["sample_s"] = scounts, wall
    out["sample_traffic"] = traffic(reset=True, timing=False)
    return out


def pp_config(cfg):
    """Phase 23's model config: the flagship's with pipeline_axis."""
    import copy

    cfg = copy.deepcopy(cfg)
    cfg["model"]["pipeline_axis"] = "pipe"
    cfg["model"]["pipeline_microbatches"] = PP_MICROBATCHES
    return cfg


def pp_counts(steps, layers, denoiser_calls=0):
    """A stage's launches: training's over ``steps`` steps of
    PP_MICROBATCHES microbatches through its ``layers`` layers
    (training_counts), or sampling's over ``denoiser_calls`` calls, each
    microbatch of each layer routing its text and its motion MoE (no text
    hoist) and running one SFFN and one global attention."""
    if not denoiser_calls:
        return training_counts(steps * PP_MICROBATCHES, layers)
    n = layers * PP_MICROBATCHES * denoiser_calls
    return {"moe_route": 2 * n, "grouped_ffn": 2 * n, "head_ffn": n,
            "stma_linear_attention": n}


def pp_bytes(torch, state):
    """The bytes of a training state's parameters and optimizer moments,
    the decoder layers' ("block") apart from the rest, and the layers it
    holds."""
    from motioncraft_tpu_torch.parallel.pp import is_stage_key

    names = {p: n for n, p in state.model.named_parameters()}

    def split(named):
        out = {"block": 0, "rest": 0}
        for n, t in named:
            out["block" if is_stage_key(n) else "rest"] += t.numel() * t.element_size()
        return out

    return {"param_bytes": split(state.model.named_parameters()),
            "opt_bytes": split((names[p], v) for p, st in state.optimizer.state.items()
                               for v in st.values() if torch.is_tensor(v) and v.dim()),
            "layers": list(state.model.layer_ids)}


def pp_train(torch, job, sd, mesh, dev):
    """Phase 23 on this rank of the pipe mesh, or (``mesh`` None) the
    pipelined config in one process: MP_STEPS Adam steps through
    train_model, the gate noise drawn (no pins: a microbatch's forward is
    the same computation on a stage as in one process); one process saves
    its trainable parameters to ``job["pp_ref"]``; on the mesh, the ranks'
    params.npz (rank 0 writes it and holds it and the gathered parameters
    against the reference) and a DDIM-50 batch over the pipe mesh.
    Returns losses, step ms, launches, the messages' calls, bytes and ms,
    the bytes and layers this rank holds."""
    import numpy as np
    from motioncraft_tpu_torch.apis import mesh_sample, train_model
    from motioncraft_tpu_torch.ops import launch_counts, reset_launch_counts
    from motioncraft_tpu_torch.parallel.mesh import shard_batch
    from motioncraft_tpu_torch.parallel.tp import full_state_dict
    from motioncraft_tpu_torch.registry import build_architecture
    from motioncraft_tpu_torch.utils.checkpoint import load_params, save_state_params
    from motioncraft_tpu_torch.utils.convert import from_jax_params
    from motioncraft_tpu_torch.utils.dist_utils import traffic

    with skip_init(torch):
        arch = build_architecture(job["pp_cfg"], device=dev)
    arch.model.load_state_dict(sd, strict=True)
    batches = [shard_batch(dict(np.load(f)), mesh) for f in job["batches"]]
    lines = []
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    reset_launch_counts()
    traffic(reset=True, timing=True)
    state = train_model(arch, batches, optimizer_cfg=job["optimizer"],
                        lr_config=job["lr_config"], max_epochs=1, steps_per_epoch=len(batches),
                        seed=SEED, log_interval=1, logger=lines.append,
                        frozen_prefixes=("text_enc/clip",), mesh=mesh)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    counts, coll = launch_counts(), traffic(reset=True, timing=False)
    out = {"losses": [float(m.split(" loss=")[1].split()[0]) for m in lines if " loss=" in m],
           "step_ms": [float(m.split("step_ms=")[1]) for m in lines if "step_ms=" in m],
           "counts": counts, "traffic": coll, "steps": state.step,
           "peak_gib": torch.cuda.max_memory_allocated(dev) / 2**30 if dev.type == "cuda"
           else None, **pp_bytes(torch, state)}
    frozen = {n for n, p in arch.model.named_parameters() if not p.requires_grad}
    whole = full_state_dict(arch.model, state.sharding)  # whole on global rank 0
    if mesh is None:
        torch.save({n: v for n, v in whole.items() if n not in frozen}, job["pp_ref"])
    else:
        save_state_params(job["pp_npz"], state)  # every rank; rank 0 writes
        if mesh.lead:
            loaded = from_jax_params(load_params(job["pp_npz"])["params"])
            out["npz_exact"] = (set(loaded) == set(whole)
                                and all(torch.equal(loaded[k], whole[k]) for k in whole))
            want, lr = torch.load(job["pp_ref"]), job["optimizer"]["lr"]
            worst, far = 0.0, 0
            for n, w in want.items():
                diff = (whole[n] - w).abs()
                worst = max(worst, float(diff.max()) / lr)
                far += int(((diff > DP_PARAM_TOL * lr).sum()
                            > max(1, int(DP_PARAM_FRAC * diff.numel())))
                           or float(diff.max()) > 2 * len(batches) * lr)
            out["param_worst_lr"], out["param_far_tensors"] = worst, far
            out["moved"] = sum(not torch.equal(whole[n], sd[n].cpu()) for n in want)
            out["compared"] = len(want)
        arch.eval()
        reset_launch_counts()
        t0 = time.perf_counter()
        with torch.inference_mode():
            got = mesh_sample(arch, job["sample_batch"], mesh,
                              generator=torch.Generator(device=dev).manual_seed(SEED + 23))
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        out["sample_s"] = time.perf_counter() - t0
        out["sample"], out["sample_counts"] = got.float().cpu(), launch_counts()
        out["sample_traffic"] = traffic(reset=True)
    del arch, state, whole
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def pp_from_npz(torch, job, model_cfg, dev):
    """A DDIM-50 batch of phase 23's requests in one process from the
    ranks' params.npz, loaded (load_eval_variables: the blocks unstacked)
    into ``model_cfg``'s model: the output and the launches."""
    from motioncraft_tpu_torch.ops import launch_counts, reset_launch_counts
    from motioncraft_tpu_torch.registry import build_architecture
    from motioncraft_tpu_torch.utils.checkpoint import load_eval_variables

    with skip_init(torch):
        arch = build_architecture(model_cfg, device=dev)
    load_eval_variables(model_cfg, arch.model, checkpoint=job["pp_npz"])
    arch.eval()
    reset_launch_counts()
    with torch.inference_mode():
        got = arch.sample(job["sample_batch"],
                          generator=torch.Generator(device=dev).manual_seed(SEED + 23))
    out = got.float().cpu(), launch_counts()
    del arch
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def mp_rank(rank, kind, job):
    """A rank of phase 22: its device, each mesh of MP_MESHES in turn, the
    data-mesh server, then phase 23's pipe mesh."""
    import numpy as np
    import torch
    from motioncraft_tpu_torch.parallel.mesh import create_mesh

    dev = dp_device(torch, kind, rank)
    if dev.type == "cpu":
        cpu_launch_counting()
    job = dict(job, sample_batch=dict(np.load(job["sample_npz"])))
    sd = torch.load(job["sd"], map_location=dev)
    out = {tag: mp_train(torch, job, sd, create_mesh(device=dev, axes=axes, shape=shape), dev)
           for tag, axes, shape in MP_MESHES}
    out["serve"] = mp_serve(torch, job["cfg"], sd, create_mesh(device=dev), dev,
                            torch.load(job["serve_pins"]))
    out["pp"] = pp_train(torch, job, sd, create_mesh(device=dev, axes=("data", "pipe"),
                                                     shape=(1, MP_WORLD)), dev)
    return out


def phase_model_parallel(torch, full_cfg, sd, dev="cuda"):
    """Phase 22: the model across ranks (see the module docstring).  ``dev``
    "cpu" rehearses it on the CPU with gloo and counting stand-ins in every
    process."""
    import tempfile

    import numpy as np
    from motioncraft_tpu_torch.apis import make_text_batch, make_train_batch
    from motioncraft_tpu_torch.parallel.mesh import launch
    from motioncraft_tpu_torch.utils.card import card_line

    t_phase = time.perf_counter()
    kind = torch.device(dev).type
    main_dev = dp_device(torch, kind, 0)
    if kind == "cpu":
        cpu_launch_counting()
    card = card_line() if kind == "cuda" else "CPU rehearsal"
    cfg = full_cfg["model"]
    T = cfg["model"]["max_seq_len"]
    ca = cfg["model"]["ca_block_cfg"]
    E, F, f = ca["num_experts"], 4 * ca["latent_dim"], cfg["model"]["ffn_cfg"]["ffn_dim"]
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        job = dict(cfg=cfg, sd=os.path.join(tmp, "sd.pt"), pins=os.path.join(tmp, "pins.pt"),
                   ref_params=os.path.join(tmp, "ref.pt"), optimizer=full_cfg["optimizer"],
                   lr_config=full_cfg["lr_config"], sample_pins=os.path.join(tmp, "spins.pt"),
                   sample_ref=os.path.join(tmp, "sref.pt"),
                   serve_pins=os.path.join(tmp, "vpins.pt"), batches=[],
                   pp_cfg=pp_config(cfg), pp_ref=os.path.join(tmp, "pp_ref.pt"),
                   pp_npz=os.path.join(tmp, "pp", "params.npz"))
        torch.save({k: v.cpu() for k, v in sd.items()}, job["sd"])
        for i in range(MP_STEPS):
            path = os.path.join(tmp, f"b{i}.npz")
            np.savez(path, **make_train_batch(MP_BATCH, seed=SEED + 220 + i, max_seq_len=T))
            job["batches"].append(path)
        lengths = np.asarray([[T], [T // 2 + 11]][:MP_SAMPLE_REQUESTS], np.int32)
        job["sample_batch"] = make_text_batch(
            ["a person walks forward and waves", "someone jumps twice"][:MP_SAMPLE_REQUESTS],
            T, cfg["model"]["input_feats"], lengths=lengths)

        # the one-process references on the card: the training steps (their
        # gate logits recorded), the sampling batch, the server
        part = dict(tag="t2m", cfg=cfg, sd=job["sd"], frozen=("text_enc/clip",),
                    optimizer=job["optimizer"], lr_config=job["lr_config"], pins=job["pins"],
                    batches=job["batches"])
        ref = dp_train_part(torch, part, None, main_dev)
        torch.save(ref["params"], job["ref_params"])
        spins = {}
        got, one_counts, one_s = mp_sample(torch, cfg, sd, None, main_dev, spins,
                                           job["sample_batch"])
        torch.save(got, job["sample_ref"])
        torch.save(spins, job["sample_pins"])
        vpins = {}
        one_serve = mp_serve(torch, cfg, sd, None, main_dev, vpins)
        torch.save(vpins, job["serve_pins"])
        one_pp = pp_train(torch, job, sd, None, main_dev)
        print(f"[mp] one process: flagship B={MP_BATCH} {MP_STEPS} steps, step ms "
              f"{ref['step_ms']} (first = warm-up), losses {ref['losses']}; batch of "
              f"{MP_SAMPLE_REQUESTS} at respace {MP_SAMPLE_RESPACE} in {one_s:.2f} s; server "
              f"{MP_SERVE_REQUESTS} requests in "
              f"{one_serve['wall_s']:.2f} s ({one_serve['rps']:.3f} requests/s); card {card}")

        # the sampling batch goes to the ranks as a file: spawn pipes the
        # arguments to a rank only as it unpickles them, after its imports,
        # and a large one holds back the start of the next rank
        job["sample_npz"] = os.path.join(tmp, "sample_batch.npz")
        np.savez(job["sample_npz"], **job["sample_batch"])
        t0 = time.perf_counter()
        ranks = launch(mp_rank, MP_WORLD, args=(kind, {k: v for k, v in job.items()
                                                       if k != "sample_batch"}), backend="gloo",
                       init_method=f"file://{os.path.join(tmp, 'gloo')}",
                       timeout_s=MP_TIMEOUT_S, group_timeout_s=MP_TIMEOUT_S)
        wall = time.perf_counter() - t0
        lr = job["optimizer"]["lr"]
        for tag, axes, shape in MP_MESHES:
            mesh_shape = dict(zip(axes, shape))
            X, Tt = mesh_shape.get("expert", 1), mesh_shape.get("tensor", 1)
            local_rows = MP_BATCH // (mesh_shape.get("data", 1) * X)
            want_train = training_counts(MP_STEPS, cfg["model"]["num_layers"])
            for r, res in enumerate(ranks):
                got = res[tag]
                timed = got["step_ms"][1:] or got["step_ms"]
                tr = got["traffic"]
                coll = ", ".join(f"{k} {v['calls']} calls {v['bytes'] / 2**20:.1f} MiB "
                                 f"{v['ms']:.1f} ms" for k, v in sorted(tr.items()))
                print(f"[mp] {tag} {mesh_shape} rank {r}: {len(got['losses'])} steps of "
                      f"{local_rows} rows, step ms {got['step_ms']} (first = warm-up), "
                      f"{local_rows / (np.median(timed) / 1e3):.1f} samples/s a rank, max "
                      f"memory {got['peak_gib']} GiB; parameters {got['param_bytes'] / 2**20:.1f}"
                      f" MiB, optimizer {got['opt_bytes'] / 2**20:.1f} MiB, shapes "
                      f"{got['shapes']}; collectives over {MP_STEPS} steps: {coll}; launches "
                      f"{got['counts']}; card {card}")
                shapes = got["shapes"]
                check(shapes["block_0.ca_block.motion_moe.model.expert_w1"]
                      == (E // X, ca["latent_dim"], F // Tt)
                      and shapes["block_0.ffn.w1"] == (ca["num_heads"], ca["latent_dim"], f // Tt),
                      f"{tag} rank {r}: expert / SFFN leaves {shapes}")
                check(got["steps"] == MP_STEPS and got["pinned"],
                      f"{tag} rank {r}: steps {got['steps']}, gates pinned {got['pinned']}")
                check(got["counts"] == dict.fromkeys(got["counts"], 0) | want_train,
                      f"{tag} rank {r} launches {got['counts']} != {want_train}")
                for i, (a, b) in enumerate(zip(got["losses"], ref["losses"])):
                    tol = MODEL_REL_TOL * max(1.0, abs(b)) + 1e-5  # printed to 5 decimals
                    check(abs(a - b) <= tol, f"{tag} step {i} loss {a} against one process {b}")
                check(got["sample_err"] <= MODEL_REL_TOL * max(1.0, got["sample_scale"]),
                      f"{tag} rank {r}: sample against one process {got['sample_err']}")
                samp = ", ".join(f"{k} {v['calls']} calls {v['bytes'] / 2**20:.1f} MiB "
                                 f"{v['ms']:.1f} ms" for k, v in sorted(got["sample_traffic"]
                                                                      .items()))
                print(f"[mp] {tag} rank {r}: batch of {MP_SAMPLE_REQUESTS} at respace "
                      f"{MP_SAMPLE_RESPACE} over the mesh in {got['sample_s']:.2f} s, max abs "
                      f"diff {got['sample_err']:.3e} "
                      f"against one process (tol {MODEL_REL_TOL} x max(1, "
                      f"{got['sample_scale']:.4g})); collectives {samp}; launches "
                      f"{got['sample_counts']}")
            r0 = ranks[0][tag]
            print(f"[mp] {tag}: 2 ranks vs one process: losses {r0['losses']} / "
                  f"{ref['losses']}; whole parameters after {MP_STEPS} Adam steps: largest "
                  f"difference {r0['param_worst_lr']:.3e} lr, {r0['param_far_tensors']} tensors "
                  f"past {DP_PARAM_TOL} lr beyond {DP_PARAM_FRAC} of their elements, "
                  f"{r0['moved']} of {len(ref['params'])} moved")
            check(r0["param_far_tensors"] == 0, f"{tag}: parameters against one process")
            out[f"{tag}_train"] = {"counts": r0["counts"], "step_ms": [
                res[tag]["step_ms"] for res in ranks], "traffic": [res[tag]["traffic"]
                                                                   for res in ranks]}
            out[f"{tag}_sample"] = {"counts": r0["sample_counts"]}
        srv = ranks[0]["serve"]
        worst = max(float(np.abs(a - b).max()) / max(1.0, float(np.abs(b).max()))
                    for a, b in zip(srv["outs"], one_serve["outs"]))
        print(f"[mp] server over {MP_WORLD} ranks (data mesh, gloo): {MP_SERVE_REQUESTS} "
              f"requests in {srv['wall_s']:.2f} s, {srv['rps']:.3f} requests/s (one card "
              f"{one_serve['rps']:.3f}); {srv['stats']['dispatches']} dispatches; largest "
              f"difference to the one-card server {worst:.3e} of max(1, scale); launches "
              f"{srv['counts']}; card {card}")
        check(ranks[1]["serve"] is None and len(srv["outs"]) == MP_SERVE_REQUESTS
              and all(np.isfinite(o).all() for o in srv["outs"]), "the mesh server's answers")
        check(worst <= MODEL_REL_TOL, f"the mesh server against the one-card server: {worst}")
        out["serve"] = {"counts": srv["counts"], "rps": srv["rps"],
                        "one_rps": one_serve["rps"]}
        print(f"[mp] two ranks (both meshes' training and sampling, the server, then phase "
              f"23's pipe mesh) took {wall:.1f} s")
        out |= phase_pipeline(torch, cfg, job, ranks, one_pp, main_dev, card)
    print(f"[mp] phases 22-23 took {time.perf_counter() - t_phase:.1f} s")
    return out


def phase_pipeline(torch, cfg, job, ranks, one, dev, card):
    """Phase 23's checks of the ranks' results (``ranks``: each rank's of
    mp_rank, their ["pp"]) against one process's (``one``), and the
    per-microbatch sampling in one process from the ranks' params.npz;
    returns rank 0's launches of the training and of the sampling."""
    t0 = time.perf_counter()
    L, S = cfg["model"]["num_layers"], MP_WORLD
    mb = MP_BATCH // PP_MICROBATCHES
    calls = sum(int(n) for n in str(cfg["diffusion_test"]["respace"]).split(","))
    want_train = pp_counts(MP_STEPS, L // S)
    want_sample = pp_counts(0, L // S, denoiser_calls=calls)
    print(f"[pp] one process, pipelined config ({PP_MICROBATCHES} microbatches of {mb}): "
          f"{MP_STEPS} Adam steps of {MP_BATCH}, step ms {one['step_ms']} (first = warm-up), "
          f"losses {one['losses']}, max memory {one['peak_gib']} GiB; parameters "
          f"{one['param_bytes']} B, Adam moments {one['opt_bytes']} B; card {card}")
    for r, res in enumerate(ranks):
        got = res["pp"]
        coll = ", ".join(f"{k} {v['calls']} calls {v['bytes'] / 2**20:.1f} MiB {v['ms']:.1f} ms"
                         for k, v in sorted(got["traffic"].items()))
        print(f"[pp] pipe rank {r} (layers {got['layers']}): {len(got['losses'])} steps, step ms "
              f"{got['step_ms']} (first = warm-up), max memory {got['peak_gib']} GiB; parameters "
              f"{got['param_bytes']} B, Adam moments {got['opt_bytes']} B; messages and "
              f"collectives over {MP_STEPS} steps: {coll}; launches {got['counts']}; card {card}")
        check(got["layers"] == list(range(r * L // S, (r + 1) * L // S)),
              f"pipe rank {r} holds layers {got['layers']}")
        check(got["steps"] == MP_STEPS, f"pipe rank {r}: steps {got['steps']}")
        for kind in ("param_bytes", "opt_bytes"):
            check(got[kind]["block"] * S == one[kind]["block"] > 0
                  and got[kind]["rest"] == one[kind]["rest"],
                  f"pipe rank {r}: {kind} {got[kind]} against one process's {one[kind]}")
        check(got["counts"] == dict.fromkeys(got["counts"], 0) | want_train,
              f"pipe rank {r} training launches {got['counts']} != {want_train}")
        check(got["sample_counts"] == dict.fromkeys(got["sample_counts"], 0) | want_sample,
              f"pipe rank {r} sampling launches {got['sample_counts']} != {want_sample}")
        for i, (a, b) in enumerate(zip(got["losses"], one["losses"])):
            tol = MODEL_REL_TOL * max(1.0, abs(b)) + 1e-5  # printed to 5 decimals
            check(abs(a - b) <= tol, f"pipe rank {r} step {i} loss {a} against one process {b}")
    r0 = ranks[0]["pp"]
    print(f"[pp] 2 stages vs one process: losses {r0['losses']} / {one['losses']}; whole "
          f"parameters after {MP_STEPS} Adam steps: largest difference "
          f"{r0['param_worst_lr']:.3e} lr, {r0['param_far_tensors']} tensors past "
          f"{DP_PARAM_TOL} lr beyond {DP_PARAM_FRAC} of their elements, {r0['moved']} of "
          f"{r0['compared']} moved; params.npz equals the gathered weights: {r0['npz_exact']}")
    check(r0["param_far_tensors"] == 0, "pipe: parameters against one process")
    check(r0["npz_exact"], "pipe: params.npz against the gathered weights")
    # the ranks' params.npz in one process: the pipelined config per
    # microbatch, and the plain flagship (the blocks unstacked)
    ref, ref_counts = pp_from_npz(torch, job, job["pp_cfg"], dev)
    plain, _ = pp_from_npz(torch, job, cfg, dev)
    scale = float(ref.abs().max())
    worst = max(float((res["pp"]["sample"] - ref).abs().max()) for res in ranks)
    print(f"[pp] DDIM-50 batch of {MP_SAMPLE_REQUESTS} over the pipe mesh in "
          f"{r0['sample_s']:.2f} s against one process's per-microbatch sampling from "
          f"params.npz: max abs diff {worst:.3e} (tol {MODEL_REL_TOL} x max(1, {scale:.4g})); "
          f"the plain flagship from params.npz (routing the whole doubled batch) "
          f"{float((plain - ref).abs().max()):.3e} from it; launches {r0['sample_counts']} "
          f"(one process {ref_counts}); messages "
          + ", ".join(f"{k} {v['calls']} calls {v['bytes'] / 2**20:.1f} MiB"
                      for k, v in sorted(r0["sample_traffic"].items())))
    check(worst <= MODEL_REL_TOL * max(1.0, scale), "pipe: sample against one process")
    check(bool(torch.isfinite(plain).all()) and tuple(plain.shape) == tuple(ref.shape),
          "pipe: the plain flagship's batch from params.npz")
    print(f"[pp] phase 23's checks took {time.perf_counter() - t0:.1f} s")
    return {"pp_train": {"counts": r0["counts"]}, "pp_sample": {"counts": r0["sample_counts"]}}


# ---------------------------------------------------------------- phase 24
def lp_model(torch, arch, mode):
    """``arch`` cast to bf16 (``bf16``) or with int8 weights (``w8``,
    ``w8a8``) in place; returns its compute dtype."""
    from motioncraft_tpu_torch.apis import bf16_cast_, int8_quantize_

    if mode == "bf16":
        bf16_cast_(arch)
        return torch.bfloat16
    int8_quantize_(arch, weight_only=mode == "w8")
    return torch.float32


def lp_forward(torch, arch, batch, x, ts, dtype, extra, logits, rows=None, nudge=False):
    """One test forward of a baseline in ``dtype`` on its device (the text
    condition cast as sampling casts it); with no ``logits`` yet its MoE
    gates' logits are recorded into the list, else each gate returns the
    recorded ones (the CPU fed the card's, as phase 6); ``rows`` collects
    the output module's rows before a CFG mix; ``nudge`` moves the input
    and every activation before its int8 quantization one ulp up."""
    from motioncraft_tpu_torch.models.moe import CosineTopGate
    from motioncraft_tpu_torch.ops import quant

    record, calls = not logits, []

    def gate(mod, args, o):
        if record:
            logits.append(o.cpu())
            return None
        calls.append(None)
        return logits[len(calls) - 1].to(o.device)

    handles = [m.register_forward_hook(gate) for m in arch.modules()
               if isinstance(m, CosineTopGate)]
    if rows is not None:
        handles.append(arch.model.out.register_forward_hook(
            lambda m, a, o: rows.append(o.float().cpu())))
    inf = float("inf")
    real = quant.quantize_rows
    if nudge:
        x = torch.nextafter(x, torch.full_like(x, inf))
        quant.quantize_rows = lambda t: real(torch.nextafter(t, torch.full_like(t, inf)))
    try:
        with torch.no_grad():
            kw = baseline_condition(torch, arch, batch)
            kw["xf_out"] = kw["xf_out"].to(dtype)
            if "xf_proj" in kw:
                kw["xf_proj"] = kw["xf_proj"].to(dtype)
            if getattr(arch.model, "precompute_text_feats", None) is not None:
                kw["text_feats"] = arch.model.precompute_text_feats(kw["xf_out"])
            return arch.model(x.to(arch.device, dtype), ts.to(arch.device),
                              **kw, **extra).float().cpu()
    finally:
        quant.quantize_rows = real
        for h in handles:
            h.remove()
        check(record or len(calls) == len(logits), "[lowprec-baselines] gate calls differ")


def lp_retrieval(torch, arch, cfg, B):
    """ReMoDiffuse's ``re_dict`` for B requests on ``arch``'s device: B x R
    retrieved rows at the bank's shapes (phase 17's: motions [T, feats]
    with lengths 40..T, 77 CLIP token features), seeded, encoded by the
    model as sampling encodes them (from f32 rows)."""
    m = cfg["model"]
    rc = m["retrieval_cfg"]
    n, T = B * rc["num_retrieval"], rc["max_seq_len"]
    g = torch.Generator().manual_seed(SEED + 24)
    motions = torch.randn(n, T, m["input_feats"], generator=g)
    lengths = torch.randint(40, T + 1, (n,), generator=g)
    mask = (torch.arange(T)[None] < lengths[:, None]).float()
    clip = torch.randn(n, 77, rc["latent_dim"], generator=g)
    with torch.no_grad():
        return {"re_dict": arch.model.encode_retrieval(
            motions.to(arch.device), mask.to(arch.device), clip.to(arch.device),
            rc["num_retrieval"])}


def lp_parity(torch, path, dev):
    """Phase 24's checks of one baseline config: one denoiser call
    (LP_BATCH requests of T frames) card vs CPU on the same fabricated weights in bf16, W8 and
    W8A8.  bf16 within MODEL_BF16_TOL x scale (a CFG-guided family's rows
    before the mix: the mix multiplies the rows' bf16 roundings by the
    guidance); W8 within MODEL_REL_TOL; W8A8 within W8A8_SENS times the
    card's own output moved by a one-ulp change of its input and of every
    activation before its quantization (max and mean abs difference, read
    in this run, as phase 13 holds the flagship's), and never below
    MODEL_REL_TOL x scale.  Returns each mode's readings."""
    import copy

    from motioncraft_tpu_torch.config import Config
    from motioncraft_tpu_torch.registry import build_architecture
    from motioncraft_tpu_torch.utils.convert import fabricate_state_dict

    tag = os.path.basename(path)[:-3]
    cfg = Config.fromfile(path).model
    archs = {}
    for d in (dev, "cpu"):
        with skip_init(torch):
            archs[d] = build_architecture(cfg, device=d)
    sd = fabricate_state_dict(archs["cpu"].model, seed=SEED + 24)
    for a in archs.values():
        a.model.load_state_dict(sd, strict=True)
    m = cfg["model"]
    T, feats = m.get("max_seq_len", 196), m["input_feats"]
    batch = requests(LP_BATCH, SEED + 240, T, feats)
    g = torch.Generator().manual_seed(SEED + 241)
    x = torch.randn(batch["motion"].shape, generator=g)
    ts = torch.full((LP_BATCH,), 499, dtype=torch.long)
    guided = hasattr(archs["cpu"].model, "cfg_mix")
    out = {}
    for mode in LP_MODES:
        card, cpu = (copy.deepcopy(archs[d]) for d in (dev, "cpu"))
        dtype = lp_model(torch, card, mode)
        lp_model(torch, cpu, mode)
        extra = ({} if m["type"] != "ReMoDiffuseTransformer" else
                 {d: lp_retrieval(torch, a, cfg, LP_BATCH)
                  for d, a in ((dev, card), ("cpu", cpu))})
        logits, rows = [], {dev: [], "cpu": []}
        got = lp_forward(torch, card, batch, x, ts, dtype, extra.get(dev, {}), logits,
                         rows[dev] if guided else None)
        want = lp_forward(torch, cpu, batch, x, ts, dtype, extra.get("cpu", {}), logits,
                          rows["cpu"] if guided else None)
        check(torch.isfinite(got).all() and got.shape == want.shape,
              f"[lowprec-baselines] {tag} {mode}: output {tuple(got.shape)}")
        scale = max(1.0, float(want.abs().max()))
        diff = float((got - want).abs().max())
        r = {"max": diff, "mean": float((got - want).abs().mean()), "scale": scale}
        if mode == "bf16":
            a, b = (rows[dev][0], rows["cpu"][0]) if guided else (got, want)
            r["rows_max"] = float((a - b).abs().max())
            r["rows_scale"] = max(1.0, float(b.abs().max()))
            ok, lim = (r["rows_max"] <= MODEL_BF16_TOL * r["rows_scale"],
                       f"{MODEL_BF16_TOL} x {r['rows_scale']:.4g}"
                       + (" on the rows before the CFG mix" if guided else ""))
        elif mode == "w8":
            ok, lim = diff <= MODEL_REL_TOL * scale, f"{MODEL_REL_TOL} x {scale:.4g}"
        else:
            nudged = lp_forward(torch, card, batch, x, ts, dtype, extra.get(dev, {}), logits,
                                nudge=True)
            sens = {"max": float((nudged - got).abs().max()),
                    "mean": float((nudged - got).abs().mean())}
            r["sensitivity"] = sens
            # never below the f32 bound: MDM's quantized products are its
            # time MLP's alone, whose one-ulp reading is far below the f32
            # sums' order on the rest of its trunk
            limits = {k: max(W8A8_SENS * sens[k], MODEL_REL_TOL * scale) for k in sens}
            ok = all(r[k] <= limits[k] for k in sens)
            lim = (f"{W8A8_SENS} x the one-ulp readings, at least {MODEL_REL_TOL} x scale: "
                   f"max {limits['max']:.4e}, mean {limits['mean']:.4e}")
        print(f"[lowprec-baselines] {tag} {mode} forward_test B={LP_BATCH}: card vs CPU max abs diff "
              f"{diff:.4e}, mean {r['mean']:.4e} (scale {scale:.4g}); limit {lim}"
              + (f"; rows before the mix {r['rows_max']:.4e}" if "rows_max" in r and guided
                 else "") + (f"; {len(logits)} gate calls pinned" if logits else ""))
        check(ok, f"[lowprec-baselines] {tag} {mode}: card vs CPU {r} beyond {lim}")
        out[mode] = r
        del card, cpu
    return out


def lp_batch(torch, arch, dtype, step_cache=None, tag=""):
    """One DDIM batch of BATCH requests of ``arch`` through single_device_test
    in ``dtype`` (optionally cached): (wall ms, launch counts, predictions)."""
    import numpy as np
    from motioncraft_tpu_torch.apis import single_device_test
    from motioncraft_tpu_torch.ops import launch_counts, reset_launch_counts

    batch = requests(BATCH, SEED + 242, arch.model.max_seq_len, arch.model.input_feats)
    reset_launch_counts()
    t0 = time.perf_counter()
    res = single_device_test(arch, [batch], seed=SEED, device=arch.device,
                             compute_dtype=dtype, step_cache=step_cache)
    wall = (time.perf_counter() - t0) * 1e3
    counts = launch_counts()
    pred = np.stack([r["pred_motion"] for r in res])
    check(pred.shape[0] == BATCH and np.isfinite(pred).all(),
          f"[lowprec-baselines] {tag}: output {pred.shape}, finite {np.isfinite(pred).all()}")
    return wall, counts, pred


def phase_lowprec_baselines(torch, dev="cuda", configs=LP_CONFIGS, mcm_config=MCM_DDIM_CONFIG,
                            fmg_config=FMG_CONFIG, f32_ms=None):
    """Phase 24: the baselines in low precision.  Each of ``configs`` in
    bf16, W8 and W8A8, one denoiser call card vs CPU (``lp_parity``); then
    two bf16 DDIM-50 batches of BATCH: MCM (``mcm_config``: every K5 call
    all bf16, K5's bf16 instantiation and nothing else of K5), and
    FineMoGen uncached against the step cache at reuse_every=2 (K1, K2 and
    K4's route as the flags imply), their wall ms beside the f32 batches of
    phases 15 and 16 (``f32_ms``).  Returns the readings and the MCM
    batch's launches (``counts``)."""
    from motioncraft_tpu_torch.config import Config
    from motioncraft_tpu_torch.diffusion import StepCacheConfig
    from motioncraft_tpu_torch.diffusion.stepcache import pattern_flags
    from motioncraft_tpu_torch.registry import build_architecture
    from motioncraft_tpu_torch.utils.convert import fabricate_state_dict

    t_phase = time.perf_counter()
    out = {"parity": {os.path.basename(p)[:-3]: lp_parity(torch, p, dev) for p in configs}}
    f32_ms = f32_ms or {}

    def build(path):
        with skip_init(torch):
            arch = build_architecture(Config.fromfile(path).model, device=dev)
        arch.model.load_state_dict(fabricate_state_dict(arch.model, seed=SEED), strict=True)
        lp_model(torch, arch, "bf16")
        return arch

    arch = build(mcm_config)
    steps = arch.diffusion_test.num_timesteps
    wall, counts, _ = lp_batch(torch, arch, torch.bfloat16, tag="mcm bf16")
    per_call = k5_per_call(arch.model)
    want = dict.fromkeys(counts, 0) | {"fused_linear_attention_bf16": steps * per_call}
    print(f"[lowprec-baselines] {os.path.basename(mcm_config)} bf16 DDIM-{steps} batch of "
          f"{BATCH}: {wall:.1f} ms (f32, phase 15: {f32_ms.get('mcm', float('nan')):.1f} ms); "
          f"K5 bf16 launches {counts['fused_linear_attention_bf16']} ({per_call} a denoiser "
          f"call), f32 K5 {counts['fused_linear_attention']}")
    check(counts == want, f"[lowprec-baselines] MCM bf16 launches {counts} != {want}")
    out["mcm"] = {"wall_ms": wall, "counts": counts, "f32_wall_ms": f32_ms.get("mcm")}
    del arch

    arch = build(fmg_config)
    steps, layers = arch.diffusion_test.num_timesteps, arch.model.num_layers
    cache = StepCacheConfig(reuse_every=2)
    flags = pattern_flags(steps, layers, cache)
    runs = {}
    for label, sc in (("uncached", None), ("step cache 2", cache)):
        wall, counts, pred = lp_batch(torch, arch, torch.bfloat16, sc, f"finemogen {label}")
        computed = int((~flags).sum()) if sc is not None else steps * layers
        want = dict.fromkeys(counts, 0) | {"grouped_ffn_bf16": 2 * computed,
                                           "moe_route": 2 * computed,
                                           "head_ffn_bf16": computed}
        check(counts == want, f"[lowprec-baselines] FineMoGen {label} launches {counts} != "
              f"{want}")
        runs[label] = {"wall_ms": wall, "counts": counts, "pred": pred}
        print(f"[lowprec-baselines] {os.path.basename(fmg_config)} bf16 DDIM-{steps} CFG "
              f"batch of {BATCH}, {label}: {wall:.1f} ms; {computed} of {steps * layers} "
              f"(step, layer) pairs computed")
    drift = float(abs(runs["step cache 2"]["pred"] - runs["uncached"]["pred"]).max())
    print(f"[lowprec-baselines] FineMoGen bf16: step cache 2 against uncached max abs "
          f"{drift:.4e}; f32 uncached (phase 16) {f32_ms.get('finemogen', float('nan')):.1f} ms")
    out["finemogen"] = {k: {"wall_ms": v["wall_ms"], "counts": v["counts"]}
                        for k, v in runs.items()} | {"f32_wall_ms": f32_ms.get("finemogen"),
                                                      "cache_drift": drift}
    del arch
    out["counts"] = out["mcm"]["counts"]
    print(f"[lowprec-baselines] phase 24 took {time.perf_counter() - t_phase:.1f} s")
    return out


# ---------------------------------------------------------------- phase 25
def profiled_run(torch, fn, dev):
    """(fn's result, wall s, the device's busy s under torch.profiler's CUDA
    activity, None off the card) of one call; the wall ends before the
    profiler stops (its trace's processing is not the call's)."""
    from torch.profiler import ProfilerActivity, profile

    if torch.device(dev).type != "cuda":
        t0 = time.perf_counter()
        out = fn()
        return out, time.perf_counter() - t0, None
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy = sum(device_events_ns(torch, prof)) / 1e9
    return out, wall, busy


def check_smplx_npz(path, T, tag):
    """A visualizer's SMPL-X npz: poses [T, 165] with the two lower-face
    joints (69:75) zero, expressions [T, 100], trans [T, 3], betas [300],
    all finite."""
    import numpy as np

    d = np.load(path, allow_pickle=True)
    shapes = {k: d[k].shape for k in ("poses", "expressions", "trans", "betas")}
    check(shapes == {"poses": (T, 165), "expressions": (T, 100), "trans": (T, 3),
                     "betas": (300,)}, f"[vis] {tag} {os.path.basename(path)}: {shapes}")
    check(all(np.isfinite(d[k]).all() for k in shapes), f"[vis] {tag}: non-finite values")
    check(not np.abs(d["poses"][:, 69:75]).any(), f"[vis] {tag}: poses 69:75 not zero")


def check_player(path, T, tag):
    """A web player: its embedded joints [T, 55, 3], finite, with the SMPL-X
    parents."""
    import numpy as np
    from motioncraft_tpu_torch.ops.fk import SMPLX_PARENTS

    with open(path) as f:
        html = f.read()
    m = re.search(r'<script id="motion-data" type="application/json">(.*?)</script>', html, re.S)
    check(m is not None and "<canvas" in html, f"[vis] {tag} {path}: no player")
    data = json.loads(m.group(1))
    joints = np.asarray(data["joints"], np.float64)
    check(joints.shape == (T, 55, 3) and np.isfinite(joints).all()
          and data["parents"] == SMPLX_PARENTS.tolist(),
          f"[vis] {tag} {os.path.basename(path)}: joints {joints.shape}")


def vis_run(torch, tag, tool, argv, dev, calls, want):
    """One visualizer run through ``tool.main(argv)`` with its launch counts
    (``want``: the counts it must launch, every other kernel none), wall s,
    the sampling's wall s and the idle share of the whole run."""
    from motioncraft_tpu_torch.ops import launch_counts, reset_launch_counts

    reset_launch_counts()
    t0 = time.perf_counter()
    with skip_init(torch):  # --checkpoint loads the whole state dict, strictly
        res, wall, busy = profiled_run(
            torch, lambda: tool.main(argv, logger=lambda s: print(f"[vis] {tag}: {s}")), dev)
    counts = launch_counts()
    profiler_s = time.perf_counter() - t0 - wall
    want = dict.fromkeys(counts, 0) | want
    idle = None if busy is None else 1 - busy / wall
    print(f"[vis] {tag}: {wall:.2f} s wall (sampling {res['sample_s']:.3f} s), {calls} "
          f"denoiser calls, device busy {busy if busy is None else round(busy, 3)} s, idle "
          f"share {idle if idle is None else round(idle, 3)} (the profiler's trace "
          f"{profiler_s:.1f} s more); launches {({k: v for k, v in counts.items() if v})}")
    check(counts == want, f"[vis] {tag} launch counts {counts} != {want}")
    return res, {"wall_s": wall, "sample_s": res["sample_s"], "denoiser_calls": calls,
                 "busy_s": busy, "idle": idle, "counts": counts}


def fabricated_npz(torch, tmp, name, config, seed, sd=None):
    """Seeded fabricated weights of ``config``'s model (or the flagship's
    state dict ``sd``), made on the host and saved as a save_params
    snapshot (``snapshot``: ``name`` in ``tmp``, or the one an earlier
    phase wrote of the same weights): (its path, the denoiser's number of
    layers a denoiser call runs, its K5 launches a call, its DDIM steps)."""
    from motioncraft_tpu_torch.config import Config
    from motioncraft_tpu_torch.registry import build_architecture
    from motioncraft_tpu_torch.utils.checkpoint import save_params
    from motioncraft_tpu_torch.utils.convert import fabricate_state_dict, to_jax_variables

    with skip_init(torch):
        arch = build_architecture(Config.fromfile(config).model, device="cpu")
    model = arch.model
    path = snapshot(tmp, name, ("t2m", id(sd)) if sd is not None else (config, seed),
                    lambda p: save_params(p, to_jax_variables(
                        sd if sd is not None else fabricate_state_dict(model, seed=seed))))
    layers = model.num_layers + getattr(model, "copy_blocks_num", 0)
    return path, layers, k5_per_call(model), arch.diffusion_test.num_timesteps


def write_stats(path_mean, path_std, feats, seed):
    """Seeded de-normalisation stats (mean, std in [0.5, 1.5)) of ``feats``."""
    import numpy as np

    rng = np.random.RandomState(seed)
    os.makedirs(os.path.dirname(path_mean), exist_ok=True)
    np.save(path_mean, (rng.randn(feats) * 0.1).astype(np.float32))
    np.save(path_std, rng.uniform(0.5, 1.5, feats).astype(np.float32))


def vis_parity(torch, tool, argv, dev, tag):
    """The flagship visualizer card vs CPU on the prompts VIS_PARITY picks,
    at VIS_PARITY_RESPACE's depth (``argv`` without --text and its lengths): the
    same initial noise, the CPU's MoE gates fed the card's gate logits (as
    phase 6), within MODEL_REL_TOL x max(1, max |CPU|) on the de-normalised
    motion."""
    from torch.nn.modules.module import register_module_forward_hook

    from motioncraft_tpu_torch.diffusion import Replay
    from motioncraft_tpu_torch.models.moe import CosineTopGate

    argv = argv + ["--text", *(VIS_TEXTS[i] for i in VIS_PARITY), "--motion_length",
                   *(str(VIS_LENGTHS[i]) for i in VIS_PARITY), "--cfg-options",
                   f"model.diffusion_test.respace='{VIS_PARITY_RESPACE}'"]
    noise = torch.randn((len(VIS_PARITY), max(VIS_LENGTHS), 322),
                        generator=torch.Generator().manual_seed(SEED + 25))
    logits, replayed, out = [], [], {}

    def record(mod, inp, o):
        if isinstance(mod, CosineTopGate):
            logits.append(o.cpu())

    def replay(mod, inp, o):
        if isinstance(mod, CosineTopGate):
            replayed.append(None)
            return logits[len(replayed) - 1].to(o.device)

    t0, secs = time.perf_counter(), {}
    for d, hook in ((dev, record), ("cpu", replay)):
        handle = register_module_forward_hook(hook)
        try:
            source = Replay([noise], d)
            t1 = time.perf_counter()
            with skip_init(torch):
                out[d] = tool.main(argv + ["--device", str(d).split(":")[0], "--out",
                                           f"parity_{str(d).split(':')[0]}"], randn=source,
                                   logger=lambda s: None)["pred"]
            secs[str(d).split(":")[0]] = time.perf_counter() - t1
            check(source.done(), f"[vis] {tag} parity: {source.used} draws used")
        finally:
            handle.remove()
    check(len(replayed) == len(logits) > 0, "[vis] gate calls differ between devices")
    got, want = out[dev], out["cpu"]
    scale = max(1.0, float(abs(want).max()))
    diff = float(abs(got - want).max())
    print(f"[vis] {tag} card vs CPU, {len(VIS_PARITY)} prompts at respace {VIS_PARITY_RESPACE}: "
          f"max abs diff {diff:.3e} (tol {MODEL_REL_TOL} x {scale:.4g}; {len(logits)} gate "
          f"calls pinned) in {time.perf_counter() - t0:.1f} s "
          f"({', '.join(f'{k} {v:.1f} s' for k, v in secs.items())})")
    check(diff <= MODEL_REL_TOL * scale, f"[vis] {tag} card vs CPU: {diff} > tol")
    return diff


def phase_visualize(torch, sd=None, dev="cuda", t2m_config=CONFIG, mcm_config=MCM_DDIM_CONFIG,
                    m2d_config=M2D_CONFIG, s2g_config=S2G_CONFIG, parity=True):
    """Phase 25: the visualizers on the card, each CLI through its
    main(argv) on seeded fabricated weights saved as a params.npz (the
    flagship's: phase 3's state dict ``sd`` where given), run from
    a scratch directory holding the configs' de-normalisation stats:
    tools/torch_visualize.py on the flagship (VIS_TEXTS at VIS_LENGTHS,
    --web; then, with ``parity``, card vs CPU) and on MCM (one prompt),
    tools/torch_m2d_visualize.py on one synthetic FineDance track (--web),
    tools/torch_s2g_visualize.py on one synthetic BEAT2 recording of two
    windows (--web).  Returns each run's readings."""
    import tempfile

    import numpy as np
    from motioncraft_tpu_torch.apis.windowed import num_windows
    from motioncraft_tpu_torch.config import Config
    from motioncraft_tpu_torch.diffusion import RepaintConfig, harmonize_schedule

    t_phase = time.perf_counter()
    vis, m2d_vis, s2g_vis = (load_tool(n) for n in ("torch_visualize", "torch_m2d_visualize",
                                                     "torch_s2g_visualize"))
    cwd, out = os.getcwd(), {}
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            # (a) the flagship: 4 prompts, one DDIM-50 CFG call of 4
            t0 = time.perf_counter()
            cfg = Config.fromfile(t2m_config)
            norm = cfg.data["test"]["pipeline"][0]
            write_stats(norm["mean_path"], norm["std_path"], 322, SEED + 25)
            params, layers, _, steps = fabricated_npz(torch, tmp, "t2m.npz", t2m_config, SEED, sd)
            print(f"[vis] flagship weights ({os.path.getsize(params) / 2**20:.0f} MiB) and "
                  f"stats written in {time.perf_counter() - t0:.1f} s")
            argv = [t2m_config, "--checkpoint", params, "--seed", str(SEED)]
            res, out["t2m"] = vis_run(
                torch, "flagship", vis,
                argv + ["--text", *VIS_TEXTS, "--motion_length", *map(str, VIS_LENGTHS),
                        "--device", str(dev), "--out", "t2m", "--web"],
                dev, steps, sampling_counts(1, steps, layers))
            for i, T in enumerate(VIS_LENGTHS):
                check_smplx_npz(os.path.join("t2m", f"sample_{i}.npz"), T, "flagship")
                check_player(os.path.join("t2m", f"sample_{i}.html"), T, "flagship")
            check(np.isfinite(res["pred"]).all(), "[vis] flagship: non-finite motion")
            del res
            if parity:
                out["t2m"]["parity_max_abs"] = vis_parity(torch, vis, argv, dev, "flagship")

            # (b) MCM: the 263-d branch, K5
            t0 = time.perf_counter()
            cfg = Config.fromfile(mcm_config)
            norm = cfg.data["test"]["pipeline"][0]
            write_stats(norm["mean_path"], norm["std_path"], 263, SEED + 26)
            params, _, k5, steps = fabricated_npz(torch, tmp, "mcm.npz", mcm_config, SEED + 26)
            print(f"[vis] MCM weights and stats written in {time.perf_counter() - t0:.1f} s")
            res, out["mcm"] = vis_run(
                torch, "mcm", vis, [mcm_config, "--checkpoint", params, "--text", VIS_TEXTS[0],
                                    "--motion_length", str(VIS_LENGTHS[1]), "--device",
                                    str(dev), "--out", "mcm"],
                dev, steps, {"fused_linear_attention": steps * k5})
            m = np.load(os.path.join("mcm", "sample_0.npz"))["motion"]
            check(m.shape == (VIS_LENGTHS[1], 263) and np.isfinite(m).all(),
                  f"[vis] mcm: motion {m.shape}")
            del res

            # (c) M2D: one FineDance track, one window
            t0 = time.perf_counter()
            cfg = Config.fromfile(m2d_config)
            tree = os.path.join(tmp, "data")
            write_finedance_tree(tree, ["063"], VIS_M2D_FRAMES, SEED + 27)
            # phase 10's weights
            params, layers, _, steps = fabricated_npz(torch, tmp, "m2d.npz", m2d_config, SEED)
            print(f"[vis] M2D track and weights written in {time.perf_counter() - t0:.1f} s")
            want = {"moe_route": layers * (steps + 1), "grouped_ffn": layers * (steps + 1),
                    "head_ffn": layers * steps, "stma_linear_attention": layers * steps}
            res, out["m2d"] = vis_run(
                torch, "m2d", m2d_vis,
                [m2d_config, "--checkpoint", params, "--track", "063", "--motion_length",
                 str(VIS_M2D_FRAMES), "--device", str(dev), "--out", "m2d", "--web",
                 "--seed", str(SEED), "--cfg-options", f"data.test.data_prefix={tree}"],
                dev, steps, want)
            name = f"res_063_{VIS_M2D_FRAMES}_0"
            check_smplx_npz(os.path.join("m2d", name + ".npz"), VIS_M2D_FRAMES, "m2d")
            check_player(os.path.join("m2d", name + ".html"), VIS_M2D_FRAMES, "m2d")
            del res

            # (d) S2G: one BEAT2 recording of two windows
            t0 = time.perf_counter()
            cfg = Config.fromfile(s2g_config)
            root = os.path.join(tmp, "beat2_root")
            yaml_path = write_beat2_tree(root, 1, VIS_S2G_FRAMES, SEED + 28, smplx=False)
            write_stats(os.path.join(root, "mean.npy"), os.path.join(root, "std.npy"), 322,
                        SEED + 28)
            # phase 11's weights
            params, layers, _, steps = fabricated_npz(torch, tmp, "s2g.npz", s2g_config, SEED)
            print(f"[vis] BEAT2 recording and weights written in "
                  f"{time.perf_counter() - t0:.1f} s")
            window, pre = cfg.windowed["window"], cfg.windowed["pre_frames"]
            wins = num_windows(VIS_S2G_FRAMES, window, pre)
            calls = steps + (wins - 1) * sum(
                d for _, d in harmonize_schedule(steps, RepaintConfig(overlap_len=pre)))
            want = {"moe_route": layers * (calls + wins), "grouped_ffn": layers * (calls + wins),
                    "head_ffn": layers * calls, "stma_linear_attention": layers * calls}
            res, out["s2g"] = vis_run(
                torch, "s2g", s2g_vis,
                [s2g_config, "--checkpoint", params, "--beats2-args", yaml_path, "--device",
                 str(dev), "--out", "s2g", "--web", "--seed", str(SEED)],
                dev, calls, want)
            rec = res["recordings"][0]["name"]
            for kind in ("res", "gt"):
                check_smplx_npz(os.path.join("s2g", f"{kind}_{rec}.npz"), VIS_S2G_FRAMES,
                                f"s2g {kind}")
            check_player(os.path.join("s2g", f"res_{rec}.html"), VIS_S2G_FRAMES, "s2g")
            betas = np.load(os.path.join("s2g", f"gt_{rec}.npz"))["betas"]
            check(np.array_equal(betas, np.asarray(res["recordings"][0]["betas"], np.float32)),
                  "[vis] s2g: the recording's betas were not exported")
            del res
        finally:
            os.chdir(cwd)
    print(f"[vis] phase 25 took {time.perf_counter() - t_phase:.1f} s")
    return out


def zoo_config(cfg, name):
    """Variant ``name`` of the flagship's model config (``cfg``: the
    architecture's), at its widths: V1 motionx, patch_size 2 on the stack
    and STMA, the linear top-k gate, per-layer FFN widths 512 / 256; V2
    human_ml3d, 8 heads (7 parts + body), the smpl_parts body graph, one
    text head a head; V3 human_ml3d, 23 joint heads."""
    import copy

    cfg = copy.deepcopy(cfg)
    cfg["diffusion_test"]["respace"] = ZOO_RESPACE
    m = cfg["model"]
    ca, ffn = m["ca_block_cfg"], m["ffn_cfg"]
    L = ca["latent_dim"]
    if name == "V1":
        m["patch_size"] = ca["patch_size"] = 2
        ca["gate_type"] = "linear_top"
        m["ffn_cfg"] = [dict(ffn, ffn_dim=f) for f in (512, 256) * (m["num_layers"] // 2)]
        return cfg
    H = 8 if name == "V2" else 23
    m.update(input_feats=263, latent_dim=L * H)
    ca["num_heads"] = ffn["num_heads"] = H
    m["pose_encoder_cfg"].update(dataset_name="human_ml3d", input_dim=263)
    m["pose_decoder_cfg"].update(dataset_name="human_ml3d", output_dim=263)
    if name == "V2":
        m["pose_encoder_cfg"].update(body_graph=True, gnn_cfg=dict(
            graph_cfg=dict(layout="smpl_parts", mode="spatial"), in_channels=L,
            base_channels=L, num_stages=2))
        ca.update(num_text_heads=H, text_latent_dim=ca["text_latent_dim"] // H)
    else:
        m["pose_encoder_cfg"]["joints"] = m["pose_decoder_cfg"]["joints"] = True
    return cfg


@contextlib.contextmanager
def captured_launches(torch):
    """Record, while it is open, the arguments (cloned) of the first launch
    at each distinct shape of K1-K5 as the models call them, into {kernel:
    {shapes: args}}; K1's cases carry how many of their rows carry a choice
    (the route just before them says)."""
    seen, route = {}, {}

    def recording(name, fn):
        def call(*args):
            out = fn(*args)
            if name == "moe_route":
                route["last"] = out
            key = tuple(tuple(a.shape) if torch.is_tensor(a) else a for a in args)
            cases = seen.setdefault(name, {})
            if key not in cases:
                kept = tuple(a.detach().clone() if torch.is_tensor(a) else a for a in args)
                if name == "grouped_ffn":
                    r = route["last"]
                    kept = FfnArgs(kept, int((r.r < r.token_for_rank.numel()).sum()))
                cases[key] = kept
            return out
        return call

    with kernel_sites(recording, ("moe_route", "grouped_ffn", "head_ffn",
                                  "stma_linear_attention", "fused_linear_attention")):
        yield seen


def phase_zoo(torch, cfg, rows, dev="cuda"):
    """Phase 26: each variant's DDIM call with exact launches and a finite
    sample, then its kernels' cases added to the kernels' rows.  Returns
    {variant: {"counts", "wall_ms"}}."""
    from motioncraft_tpu_torch.ops import KERNELS, launch_counts, reset_launch_counts
    from motioncraft_tpu_torch.registry import build_architecture
    from motioncraft_tpu_torch.utils.convert import fabricate_state_dict

    t_phase = time.perf_counter()
    out = {}
    for vi, name in enumerate(ZOO_VARIANTS):
        vcfg = zoo_config(cfg, name)
        m = vcfg["model"]
        t0 = time.perf_counter()
        with skip_init(torch):
            arch = build_architecture(vcfg, device=dev)
        arch.model.load_state_dict(fabricate_state_dict(arch.model, seed=SEED + vi), strict=True)
        T, D = m["max_seq_len"], m["input_feats"]
        print(f"[zoo] {name}: built in {time.perf_counter() - t0:.1f} s, "
              f"{sum(p.numel() for p in arch.parameters()) / 1e6:.1f} M parameters, "
              f"{m['ca_block_cfg']['num_heads']} heads, patch {m.get('patch_size', 1)}")
        batch = requests(ZOO_BATCH, SEED + 260 + vi, T, feats=D)
        # a first call records every kernel's arguments at each distinct
        # shape; the second, uninstrumented, is the one counted and timed
        with captured_launches(torch) as seen, torch.no_grad():
            arch.sample(batch, generator=torch.Generator(device=dev).manual_seed(SEED + vi))
        g = torch.Generator(device=dev).manual_seed(SEED + vi)
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        with torch.no_grad():
            sample = arch.sample(batch, generator=g)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        counts = launch_counts()
        steps, layers = arch.diffusion_test.num_timesteps, m["num_layers"]
        want = dict.fromkeys(counts, 0) | sampling_counts(1, steps, layers)
        if m["ca_block_cfg"].get("num_text_heads", 1) > 1:  # K5 in place of K3
            want["fused_linear_attention"] = want.pop("stma_linear_attention")
            want["stma_linear_attention"] = 0
        print(f"[zoo] {name}: one DDIM-{steps} call of {ZOO_BATCH} x {T} frames, "
              f"{wall:.1f} ms wall; launches {counts}")
        check(counts == want, f"zoo {name} launch counts {counts} != expected {want}")
        check(tuple(sample.shape) == (ZOO_BATCH, T, D), f"zoo {name} sample {tuple(sample.shape)}")
        check(bool(torch.isfinite(sample).all()), f"zoo {name}: non-finite sample")
        print(f"[zoo] {name}: sample finite, max |x| {float(sample.abs().max()):.4g}")
        out[name] = {"counts": counts, "wall_ms": wall}
        for kname, cases in seen.items():
            # in the order the call made them: K1 and K4's route the text
            # MoE, layer 0's motion MoE (one CFG half), layers 1-3's (both)
            for j, args in enumerate(cases.values()):
                # case index 0: kernel_case takes K4's case 1 for a skewed one
                kernel_case(torch, rows, f"zoo {name} {j}", kname, 0, args, KERNELS[kname])
        del arch, sample, seen
        torch.cuda.empty_cache()
    print(f"[zoo] phase 26 took {time.perf_counter() - t_phase:.1f} s")
    return out


def main():
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        from motioncraft_tpu_torch.config import Config
        from motioncraft_tpu_torch.ops import _build
        from motioncraft_tpu_torch.registry import build_architecture
        from motioncraft_tpu_torch.utils.convert import fabricate_state_dict
    except ImportError as e:
        print(f"chip_smoke: the port is not next to this script ({e})", file=sys.stderr)
        return 2
    for path in (CONFIG, M2D_CONFIG, S2G_CONFIG, HARNESS_CONFIG, *BASELINE_CONFIGS,
                 MCM_DDIM_CONFIG, FMG_CONFIG, FMG_HML_CONFIG, FMG_KIT_CONFIG, MCM_M2D_CONFIG,
                 MCM_S2G_CONFIG, REMO_CONFIG, CN_S2G_CONFIG):
        if not os.path.isfile(path):
            print(f"chip_smoke: missing {path}", file=sys.stderr)
            return 2

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    print(f"[card] {smi}")
    print(f"[card] torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    seconds = _build.build()
    print(f"[build] kernels built in {seconds:.1f} s into {_build.BUILD_DIR}")
    # the params.npz snapshots that phases share (removed at exit)
    import atexit
    import shutil
    import tempfile

    SNAPSHOTS["dir"] = tempfile.mkdtemp(prefix="chip_smoke_")
    atexit.register(shutil.rmtree, SNAPSHOTS["dir"], True)

    full_cfg = Config.fromfile(CONFIG)
    m2d_cfg = Config.fromfile(M2D_CONFIG)
    s2g_cfg = Config.fromfile(S2G_CONFIG)
    cfg = full_cfg["model"]
    dev = torch.device("cuda")
    k5_cfgs = [Config.fromfile(p)["model"] for p in (MD_CONFIG, MCM_CONFIG)]
    fmg_cfgs = {os.path.basename(p)[:-3]: Config.fromfile(p)["model"]
                for p in (FMG_CONFIG, FMG_HML_CONFIG)}
    # phase 17's: the MCM ControlNet (M2D and S2G share their base's
    # shapes at a 196-frame window), ReMoDiffuse and MoMatMoGen
    mcm_cfgs = {"mcm_m2d_finedance": Config.fromfile(MCM_M2D_CONFIG)["model"]}
    remo = Config.fromfile(REMO_CONFIG)["model"]
    retrieval_cfgs = [remo, momat_config(remo)]
    # phase 18's: the flagship's training batch and the ControlNets' (their
    # base and copied blocks share the base's shapes)
    train_cfgs = [("t2m", cfg, full_cfg["data"]["samples_per_gpu"])] + [
        (tag, {"model": c["model"]["model"]["base_model"]}, c["data"]["samples_per_gpu"])
        for tag, c in (("s2g", Config.fromfile(CN_S2G_CONFIG)), ("m2d", m2d_cfg))]
    # phase 19's: each baseline's training batch, the MCM ControlNet's
    bl_train_cfgs = [(os.path.basename(p)[:-3], c["model"], c["data"]["samples_per_gpu"])
                     for p, c in ((p, Config.fromfile(p))
                                  for p in (MD_CONFIG, MCM_CONFIG, FMG_CONFIG, MCM_M2D_CONFIG))]
    # phase 21's: each rank's K5 at the flagship's 64 rows (its K4
    # positions and K6 over the global 128 are phase 18's t2m cases), and the
    # S2G ControlNet's base at its 2 x 8 windows
    dp_cfgs = [("t2m dp", cfg, full_cfg["data"]["samples_per_gpu"], None,
                ("fused_linear_attention",)),
               ("s2g dp", {"model": s2g_cfg["model"]["model"]["base_model"]}, DP_S2G_BATCH,
                DP_S2G_FRAMES, TRAINING_KERNELS)]
    rows = phase_kernels(torch, cfg, m2d_cfg, dev, s2g_cfg, k5_cfgs, fmg_cfgs, mcm_cfgs,
                         retrieval_cfgs, train_cfgs, bl_train_cfgs, dp_cfgs, mp_cfg=cfg)

    t0 = time.perf_counter()
    with skip_init(torch):
        arch = build_architecture(cfg, device="cuda")
    sd = fabricate_state_dict(arch.model, seed=SEED)
    arch.model.load_state_dict(sd, strict=True)
    print(f"[model] flagship built in {time.perf_counter() - t0:.1f} s, "
          f"{sum(p.numel() for p in arch.parameters()) / 1e6:.1f} M parameters")

    counts = phase_e2e(torch, arch)
    phase_parity(torch, cfg, arch, sd)
    train_counts, f32_step_ms = phase_train(torch, full_cfg, arch)
    del arch
    phase_train_parity(torch, cfg, sd)
    eval_counts = phase_eval(torch, full_cfg, sd)
    m2d = phase_m2d(torch, m2d_cfg)
    s2g = phase_s2g(torch, s2g_cfg)
    serve = phase_serve(torch, cfg, sd)
    with skip_init(torch):
        arch = build_architecture(cfg, device="cuda")
    arch.model.load_state_dict(sd, strict=True)
    low = phase_lowprec(torch, full_cfg, m2d_cfg, arch, sd)
    del arch
    harness = phase_harness(torch, Config.fromfile(HARNESS_CONFIG))
    baselines = phase_baselines(torch)
    finemogen = phase_finemogen(torch)
    mcm_remo = phase_mcm_retrieval(torch)
    controlnet = phase_controlnet_train(torch)
    baseline_train = phase_baseline_train(torch)
    bf16_train = phase_bf16_train(torch, full_cfg, sd, f32_step_ms)
    dp = phase_data_parallel(torch, full_cfg, sd)
    mp = phase_model_parallel(torch, full_cfg, sd)
    lowprec_bl = phase_lowprec_baselines(torch, f32_ms={
        "mcm": baselines["mcm_t2m ddim50"]["wall_ms"],
        "finemogen": finemogen["batch"]["wall_ms"]})
    vis = phase_visualize(torch, sd)
    zoo = phase_zoo(torch, cfg, rows)

    for name, row in rows.items():
        # each kernel's count on the path it serves: sampling for K1-K3 and
        # K4's route, training for K4's positions, K5 and K6, bf16 serving
        # for K1-K3's bf16 instantiations; and on the evaluation paths of
        # phases 9, 10 and 11 (R = 1, then R = 4) and the two servers of
        # phase 12 (f32, then bf16)
        row["launches"] = (counts[name] or train_counts[name] or serve["bf16"]["counts"][name]
                           or bf16_train["counts"][name] or bf16_train["f16"]["counts"][name]
                           or lowprec_bl["counts"][name])
        row["eval_launches"] = eval_counts[name]
        row["m2d_launches"] = [m2d[R]["counts"][name] for R in sorted(m2d)]
        row["s2g_launches"] = [s2g[R]["counts"][name] for R in (1, S2G_REC_BATCH)]
        row["serve_launches"] = [serve[dt]["counts"][name] for dt in ("f32", "bf16")]
        # phase 13: the step cache (reuse_every=2, the committed table), the
        # int8 evaluations (bf16 + W8A8, bf16 + W8), the cached M2D track and
        # the W8A8 server
        row["cache_launches"] = [low["cache"][k]["counts"][name]
                                 for k in ("reuse_every=2", "table")]
        row["int8_launches"] = [low["int8"][m]["counts"][name] for m in ("w8a8", "w8")]
        row["m2d_cache_launches"] = low["m2d"]["counts"][name]
        row["serve_int8_launches"] = low["serve"]["counts"][name]
        # phase 14: the training CLI (both runs), the calibration checkpoint
        # and each drift mode (exact, step_cache_2, step_cache_table, int8w,
        # int8), all in bf16
        row["harness_train_launches"] = harness["train"][name]
        row["harness_calib_launches"] = harness["calib"][name]
        row["harness_drift_launches"] = [c[name] for c in harness["drift"].values()]
        # phase 15: each baseline's DDPM batch, MCM's DDIM-50 batch and the
        # protocol run on MotionDiffuse
        row["baseline_launches"] = {k: v["counts"][name] for k, v in baselines.items()}
        # phase 16: FineMoGen's DDIM-50 batch and its protocol run
        row["finemogen_launches"] = [finemogen[k]["counts"][name] for k in ("batch", "protocol")]
        # phase 17: the MCM ControlNet's M2D and S2G CLI runs (R = 1, then
        # R = 2), ReMoDiffuse's DDIM-50 batch and the MoMatMoGen forward
        row["mcm_launches"] = {k: [mcm_remo[k][R]["counts"][name] for R in (1, MCM_REC_BATCH)]
                               for k in ("mcm_m2d", "mcm_s2g")}
        row["retrieval_launches"] = {k: mcm_remo[k]["counts"][name]
                                     for k in ("remodiffuse", "momatmogen")}
        # phase 18: stage 1 (the flagship on its mixed set), stage 2 (the S2G
        # and M2D ControlNets from it), each CN_STEPS steps, and stage 3 (the
        # trained S2G ControlNet through tools/torch_s2g_test.py)
        row["controlnet_train_launches"] = {k: controlnet[k]["counts"][name]
                                            for k in ("t2m_mixed", "s2g", "m2d", "s2g_test")}
        # phase 19: stage 1 (MotionDiffuse, MCM, MDM, FineMoGen) and stage 2
        # (the MCM ControlNet from stage 1's MCM), each BL_STEPS steps
        row["baseline_train_launches"] = {k: v["counts"][name]
                                          for k, v in baseline_train.items()}
        # phase 20: the bf16 and the float16 train_model steps (TRAIN_STEPS
        # of B = TRAIN_BATCH each)
        row["bf16_train_launches"] = bf16_train["counts"][name]
        row["f16_train_launches"] = bf16_train["f16"]["counts"][name]
        # phase 21: rank 0's data-parallel steps (the flagship's DP_STEPS,
        # the S2G ControlNet's one) and its share of the 2-process evaluation
        row["dp_launches"] = {k: dp[k]["counts"][name] for k in ("t2m", "s2g", "eval")}
        # phase 22: rank 0's steps and sampling batch on each mesh, its
        # share of the mesh server's dispatches, and phase 23's steps and
        # sampling batch on the first pipeline stage; each of phase 2's
        # cases at phase 22's and 23's shapes carries the launches of the
        # run it stands for
        row["mp_launches"] = {k: v["counts"][name] for k, v in mp.items()}
        # phase 24: the bf16 DDIM-50 batches of MCM and of FineMoGen
        # (uncached, step cache 2)
        row["lowprec_baseline_launches"] = {
            "mcm": lowprec_bl["mcm"]["counts"][name],
            **{f"finemogen {k}": v["counts"][name]
               for k, v in lowprec_bl["finemogen"].items() if isinstance(v, dict)}}
        # phase 25: the visualizers (the flagship's DDIM-50 call of 4
        # prompts, MCM's one prompt, the M2D window, the S2G recording)
        row["vis_launches"] = {k: v["counts"][name] for k, v in vis.items()}
        # phase 26: each zoo variant's DDIM call
        row["zoo_launches"] = {k: v["counts"][name] for k, v in zoo.items()}
        for case in row["cases"]:
            run = next((v for k, v in MP_PATH_RUNS.items() if case["path"].startswith(k)), None)
            if run is not None:
                case["launches"] = mp[run]["counts"][name]
                check(case["launches"] > 0, f"{name} at {case['path']} was launched no time "
                      "in phases 22-23")
        check(row["launches"] > 0, f"{name} was launched no time on its path")
    print(json.dumps({"kernels": list(rows.values())}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
