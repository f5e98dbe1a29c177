#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``.  It needs one
CUDA device and exits non-zero without one (or without the package beside
it), printing no result.  The phases, each raising on failure:

1. build   — compile the attention kernels from ``csrc/`` with nvcc.
2. kernels — hold each kernel against its plain PyTorch form on the card at
             the serving shapes (B = 1 and 8, N = 4096 tokens, Ck = 64,
             Cv = C = 512), at a ragged N (65² = 4225) and at DANet-R18's
             narrow head (Ck = 16, Cv = C = 128), in float32 (max |diff| <=
             1e-4 x max |plain|: summation order, and the kernels' 3xTF32
             products) and in bfloat16
             inputs (<= 2e-2 x max |plain|, output dtype kept), plus two
             odd widths (C = 100 and 67); each kernel launched twice on one
             input must give the same bits; every kernel against float64
             at an input scale where a single-pass TF32 product fails the
             same bound, and with NaN inputs; then
             time kernel, plain form and a library yardstick with CUDA
             events, taking turns, both for a single launch and per call
             in runs of 20 back to back, and the host's microseconds per
             call at B = 1,
             each against its bound: for float32 work the least time of a
             float32-accurate route, 3xTF32 on the tensor cores (a third of
             the TF32 rate) or the bytes at the memory rate; all three on
             bfloat16 inputs (as bf16 training and serving give them)
             against the bf16 rate or the bytes, their plain forms and a
             bf16 library call (SDPA; ``bmm`` + ``softmax``; ``bmm``).
3. predictor — DANet-R101 at 512² with every weight drawn from seed 0
             (gammas and last-BN scales included), ``predict_batch`` on a
             synthetic 480x640 image with 4 click sets, compared with the
             same predictor forced onto the plain forms (<= 1e-3 abs; the
             three logits <= 1e-3 x max(1, max |logit|)); request latency
             and its breakdown (host prepare, forward with kernels and
             with plain forms, paste-back, profiler top kernels).
4. service — ``InferenceService(max_batch=4)`` under 8 concurrent submits;
             every mask matches ``Predictor.predict`` (<= 1e-4 abs).
5. http    — the HTTP front on localhost answers 3 predicts and /healthz.
6. train   — (a) the kernels' autograd functions alone at DANet-R101's
             attention shapes: every input's gradient within 1e-3 x max |g|
             of autograd through the plain forms; then one step's gradients
             of DANet-R101 at 512², B = 2, every weight drawn from seed 0,
             dropout off, through the kernels, through the plain forms and
             through the plain forms in float64: every parameter tensor
             within 1e-3 x its max |g| of the plain path, or, where float32
             itself is further off, within the plain path's own distance
             from float64 (a deep random net amplifies the kernels'
             float32-level differences; the PAM key bias, zero in exact
             arithmetic, is scaled by the key weight's), the query/key/value
             gradients nonzero, and each kernel's forward counter up by
             exactly 1; (b) the default
             train step (B = 16, SGD 5e-8 / 0.9 / 5e-4, f32) with the
             kernels and with the plain forms, timed in turns with CUDA
             events, images/s, peak memory, a profiler table of one step
             and the device's idle share, and the host pipeline's ms per
             batch of 16; (c) ``python -m distributedpytorch_tpu_torch
             --fake-data`` as a subprocess (DANet-R101 at 512², 4 optimizer
             steps, 2 validations): finite losses, Jaccard in [0, 1], a
             committed checkpoint whose weights ``Predictor.from_run``
             serves bit for bit, and the kernels' launches in the fit equal
             to one per train step and per validation sample.
             bf16 (``train.precision=bfloat16``): (d) one DANet-R101 step's
             gradients at B = 2 through the kernels, through the plain
             forms in bf16 and in float32: every gradient float32, every
             tensor within 2e-2 x its float32 max |g| of the bf16 plain
             path or within that path's own distance from float32, q/k/v
             gradients nonzero, each counter up by 1; (e) the bf16 B = 16
             step in turns with the float32 kernel step and the bf16
             plain-form step (median of 5, images/s, peak memory, profiler
             split, idle share), and one bf16 step with ``model.remat``;
             (f) the bf16 CLI fit at train batch 2 sent SIGTERM after its
             first step line (exit 0, ``preempted``, a committed step with
             ``interrupted_epoch``), then ``resume=auto``: the straight
             run's final step, no batch twice, weights within the stated
             tolerance of a straight run's (``resume_check``: the spread
             measured over three straight runs, one started beside the
             resumed run), launches one per train step
             and validation sample over both runs, and
             ``Predictor.from_run`` serving it in bf16 on float32 weights,
             bitwise the checkpoint's model; (g) a ``Trainer`` warm-started
             from its weights holds them bit for bit, at step 0 with an
             empty optimizer.
7. host    — the host-data layer (phases 6h-6j): (h) each op of the host
             library (``csrc/host_image_ops.cpp``, built with the host C++
             compiler) against its numpy form at the main path's shapes,
             ms of both and max |diff| within ``HOST_OP_TOL``, and ms per
             sample of the default stack on the library, on the numpy
             forms and with the fused crop + resize; (i) ms per
             batch of 16 at 512² from a 375x500 fake VOC set for the
             threaded loader on the numpy forms and on the library, the
             worker-process loader (``data.loader=grain``) at 2 and 8
             processes (capped by the CPU affinity), with
             ``data.fused_crop_resize``, and on an on-disk JPEG/PNG tree with
             ``data.decode_cache`` 0 and 64 (only where PIL imports), the
             worker loader's samples bitwise the threaded loader's, the
             peak ``/dev/shm`` use, no worker left after each; (j) the bf16
             B = 16 step fed by the worker loader (data wait per step, step
             ms, images/s, the stream's idle share between steps; finite
             losses, one launch per kernel per step), then the worker-fed
             bf16 CLI fit (``data.loader=grain data.num_workers=2
             data.fused_crop_resize=true``) SIGTERMed after its first step
             line and resumed: the straight run's final step, no batch
             twice, no process of either fit's process group left.

8. dist    — data parallelism (``parallel/``): (a) world size 1 over NCCL
             through the launcher's torchrun path (its environment set
             here), DDP, cross-replica BatchNorm and ZeRO-1 engaged; (b)
             two ranks over gloo on the one card (NCCL refuses two ranks on
             one device), ``dp``, ``dp_zero1`` and
             ``train.reduce_buckets=4``: DANet-R101 at 512², bf16, global
             batch 16, every weight drawn from seed 0, dropout off, two
             steps at lr 1e-3 each held to the single-process step from the
             same weights (each step's loss, each tensor's update, within
             6d's bf16 bound: 2e-2 of the reference's own size or the bf16
             reference's distance from float32, plus 4 ulps of the
             weight), each rank launching each kernel once per step, then
             ms per step with the share an all_reduce of the gradients
             alone takes; (c) a 2-rank CLI fit (ResNet-18 at 64², gloo)
             whose rank 1 alone gets SIGTERM: both ranks stop at one step
             and save once (``num_shards`` 2), ``resume=auto`` reaches the
             straight runs' final step within 6f's rule, and no process of
             any fit's group is left.  The wrong-device case of the kernels'
             device guard needs a host with two cards and is not run.
9. semantic — the semantic task and the DeepLab family (no attention
             kernel lies on this path; their counters must not move):
             (a) DeepLabV3, DeepLabV3+ and FCN on ResNet-101 at 513², 21
             classes, aux head, every weight drawn from seed 0, eval mode,
             B = 1: the card's float32 logits (TF32 off) within 1e-3 x
             max(1, max |logit|) of the CPU's; (b) one DeepLabV3-R101 step
             at B = 2 from the trainer's initial weights, dropout off,
             labels with a void border: the loss within 1e-5 of the CPU's
             on the card's logits, every gradient within 1e-3 x its max |g|
             of the card's float64 step or within 4x the CPU's float32
             step's own distance from it (float32 itself is off by more on
             some tensors: cancelling sums over 2 x 257² positions, and the
             image-pool BatchNorm over two values), and an all-void batch
             giving loss 0 and zero gradients; (c) BASELINE config 4, the
             B = 8 DeepLabV3-R101 train step, bf16 and float32 in turns
             (median of 5, CUDA events), images/s, peak memory, a profiler
             split (convolutions, BatchNorm, loss, resize, the rest) and the
             idle share; (d) the semantic fit, a ``Trainer`` in this
             process (``task=semantic``
             DeepLabV3-R101 513² bf16, train batch 4, full-res validation
             under 3-scale + flip TTA, 2 steps): finite losses, mIoU and
             pixel accuracy in [0, 1] with 21 per-class entries, a committed
             checkpoint, then ``SemanticPredictor.from_run``'s resize map
             bitwise the argmax of the trainer's eval forward, ``slide``,
             and ``--predict`` writing a PNG; (e) ``fullres_argmax`` on the
             card against the host full-res protocol on the same
             probabilities, >= 99.9% of pixels agreeing.
10. trainer — the rest of the trainer, DANet-R101 at 512² in bf16 on the
             fake fixture: (a) a ``Trainer`` trains an epoch, validates a
             snapshot on the ``val_overlap`` thread while the next epoch
             trains, and a serial validation of the same snapshot at the
             join gives the same Jaccard (1e-4) and loss (1e-6 relative);
             the wall time of an epoch plus the overlapped validation
             against an epoch plus a serial one; one launch per kernel per
             step and val sample; (b) the look-ahead evaluator over the
             fixture's val samples against a per-sample reference built
             here from ``eval_step`` and the host protocol (same bounds),
             its ms per sample and the device's idle share in a profiler
             window; (c) the fit (a ``Trainer`` in this process) with
             ``val_overlap=true`` and ``profile_epoch=1``: ``run_dir/profile`` holds a Chrome trace
             naming each of the four attention kernels at least once per
             step of epoch 1, and ``kernel_launches`` is exactly the steps
             plus the validated samples; (d) its TensorBoard writer: where
             ``tensorboard`` is installed, ``run_dir/tb`` holds
             ``val/jaccard`` at each validation and (with matplotlib) the
             ``val_panels`` image, else no file and no error; (e) at B = 16
             bf16: ``model.remat`` alone, ``remat_policy`` dots_saveable and
             nothing_saveable held to the step without remat by 6d's rule,
             ``bn_fp32_stats=false`` by the L2 rule at ``KNOB_L2_FACTOR``,
             each step's ms and peak memory; AdamW's first update against
             optax's closed form within 1e-6 relative.
11. telemetry — the telemetry and chaos core, DANet-R101 at 512² in bf16
             on the fake fixture, train batch 4, two epochs, a loss read at
             every step: (a) the default fit (``telemetry`` and
             ``data.governor=observe`` at their defaults): the flight
             recorder (schema v1, ``fit_start`` ... the checkpoint commit
             ... ``fit_end``, nothing dropped), ``fit_summary.json`` with
             ``recovery`` null and the governor's ``feed`` block, the five
             goodput buckets non-negative and within the total, ``compile``
             > 0, the productive share in (0, 1], the MFU in (0, 1) against
             the card's peak (not the fallback) from the FLOP counter, every
             ``governor.jsonl`` line in the JAX schema and not applied, and
             one launch per kernel per step and val sample; (b) the same fit
             with every batch fetch 200 ms late (``DPTPU_CHAOS_PLAN``), then
             the clean fit again: the ``input_wait`` bucket up by at least
             0.9 x the injected sleep over the lower of the two clean fits
             around it (the first fit of a process books one-time costs to
             its first fetches), each fetch's wait of the three fits
             printed, ``governor.jsonl`` recording the stall above the
             target and the would-be escalation, the loader's depth and the
             echo factor unchanged; (c) the B = 16 bf16 step through the trainer's
             per-step body with telemetry on and off, in turns, median of 5
             (CUDA events), and the body's host microseconds (printed, not
             gated); (d) SIGUSR2 during a fit with ``profile_epoch=1``:
             ``trace_on_demand/trace_000`` names each attention kernel,
             ``trace_captures_total`` +1, a second SIGUSR2 during
             ``profile_epoch`` refused and counted, the fit complete; (e) the
             HTTP front after a few predicts: ``GET /metrics`` parses with
             the serve families and ``span_seconds``, ``POST /debug/trace``
             writes a trace, and an ``error`` fault at ``serve/enqueue``
             closes that request's connection unanswered (as the JAX front
             does) while the next request is served.
12. devdata — device-side instance data, DANet-R101 at 512² in bf16:
             (a) the device stage (``data.device_augment`` +
             ``device_augment_geom`` + ``device_guidance``,
             ``nellipse_gaussians``) at B = 16 on the card against the CPU
             on the same draws: max |diff| per key printed; the image
             channels within ``DEV_IMAGE_TOL`` = 1e-2 on [0, 255] (an ulp
             of ``cos``/``sin`` moves a source coordinate by ~1e-5 px),
             the masks differing on at most ``DEV_MASK_FRAC`` = 1e-4 of
             their pixels (a nearest coordinate within an ulp of a half
             pixel), the guidance channel from the same mask and draws
             within ``DEV_GUIDE_TOL`` = 1e-2; (b) the stage under
             ``torch.cuda.set_sync_debug_mode("error")``; (c) its device
             ms (CUDA events, median of 20) beside the host's ms for the
             same work on a batch of cached crops and 6i's loader ms; (d)
             the B = 16 bf16 step fed from the host (as 6e) against the
             device stage fed by ``prefetch_to_device`` with a window of 2,
             median of 5 in turns, images/s, idle share, peak memory, one
             launch per kernel per step; (e) the default fit (as 11a) in turns
             with the path the prefetcher replaced (bypassed: the step
             copies the host batch from pageable memory), in-step, window
             2, window 2, in-step, then ``data.device_prefetch=0``, then 2
             with the device stage and ``data.prepared_cache``: the
             input-wait share and buckets,
             the launches exactly the steps plus the val samples; (f) that
             fit's validation (the prepared val cache, device guidance): ms
             per sample and the idle share in a profiler window, its
             Jaccard within ``DEV_VAL_JAC_TOL`` = 1e-2 of the host-guidance
             validation of the same cache and weights; (g) the prepared
             cache at 512² from 375x500 images: fill and read ms per
             sample, bytes per sample, read back bitwise; (h) a
             ``device/put`` latency fault (``DEV_PUT_DELAY_S`` = 0.2 s a
             placement) leaves ``input_wait`` at least the epochs times
             the delay (each epoch's first placement cannot hide behind a
             step), its growth over the clean fit printed; an error fault
             fails the fit loudly and leaves no placement thread; (i) one config-4 step (DeepLabV3-R101 513², B = 8,
             bf16) with the device flip and scale-rotate: finite loss, the
             warped-out ``crop_gt`` ring 255 and the ids exact, no attention
             kernel launched.
13. sessions — head-injected guidance and session serving, DANet-R101 at
             512², ``guidance_inject="head"``, every weight drawn from seed 0
             (the gates and ``guidance_proj`` non-zero), in float32 and then
             bf16 on the same weights: (a) ``decode(encode(x))`` against the
             ``stage="full"`` forward at B = 1 and 4, in probability,
             bitwise (the same ops on the same shapes); (b) an encode
             launches no attention kernel, a decode of B crops exactly one
             of each; (c) the cold click (prepare,
             encode, decode, paste-back) and the warm click
             (``prepare_guidance``, decode, paste-back) on the host's clock,
             20 each in turns, p50; the encode and decode ms (CUDA events
             around a lone launch, median of 21, and the profiler's device
             busy of each stage), the encode share of the device time beside
             the FLOP counter's share (meta device, plain forms), and one
             cold click's idle share; (d) ``InferenceService(max_batch
             =8)``: 8 sessions, one cold and 3 warm clicks each, submitted 8
             at a time: the cold and warm masks bitwise the references at the
             service's bucket, 8 (the stateless masks of the same clicks,
             or the moved clicks' guidance, by 1 and 2 px, decoded in the
             sessions' crops), and the stateless B = 1 ``predict`` of the
             same clicks within ``SESSION_CROSS_TOL`` (1e-4 f32, 5e-2 bf16:
             another batch shape, so another cuDNN algorithm) of bucket 8;
             every burst one bucket-8 group holding all 8 sessions, and
             launching exactly one of each kernel; 8 x
             ``feature_struct(1)`` bytes live (32 MiB a session in f32, 16
             in bf16), 24 hits and 8 misses; a budget of 3 entries evicting
             the oldest of 4 sessions; an out-of-crop click re-encoding,
             bitwise the stateless mask; (e)
             f32 only: over HTTP, stateless, cold and warm masks bitwise
             equal, and at lane depth 1 a session's second queued click shed
             with 429 ``session_lane`` (raised as ``SessionLaneFullError``);
             (f) a fit (a ``Trainer`` in this process) with
             ``model.guidance_inject=head`` (bf16, 2
             steps of B = 4, one validation): finite losses, launches one per
             step and val sample, and ``Predictor.from_run`` serving a
             session whose warm click is the stateless mask, bitwise.
14. head_knobs — DANet's head knobs at DANet-R101's width: (a) the position
             branch's module (C = 512: Ck = 64, Cv = 512) at B = 2, N =
             4096, weights drawn from seed 0, gate 1, in float32 and bf16:
             the blocked plain form at key blocks 512 and 1000 (a ragged
             last block) and ``flash`` with ``pam_block_size=128`` held to
             the full plain form, forward and every gradient by the bounds
             of phases 2 and 6a/6d (``PAM_FORM_TOL``; the key bias's
             gradient, 0 in exact arithmetic, scaled by the key weight's),
             ``flash`` launching one PAM kernel a forward and ``einsum``
             none, and each form's forward ms; (b) ``moe_ffn`` against
             ``moe_ffn_dense`` at B = 1 (N = 4096, d = h = 512, E = 4) for
             k = 1 and 2 at capacity factors 1.25 and 0.5: the routing
             equal, output, aux and every gradient within ``MOE_TOL`` of
             the dense form's largest value, the forward + backward ms
             and peak memory of both; (c) DANet-R101 bf16 with
             ``moe_experts=4 moe_k=2`` at B = 8: the first step's loss the
             task loss plus 0.01 x the aux on the same dropout masks, the
             step against the same model without its MoE in turns (median
             of 5, peak memory), each launching each kernel once; then
             the CLI fit ``MOE_FIT_ARGS`` (2 steps of B = 8, one
             validation of 8 samples) served by ``Predictor.from_run``
             (one ``predict_batch`` of 4 click sets): finite losses and
             2 + 8 + 1 launches of each kernel; and the same fit (a ``Trainer``
             in this process) with
             ``model.pam_impl=einsum model.pam_block_size=1024``: no PAM
             launch, the CAM kernels 11 each.
15. host_data — the instance task's host data: (a) each of the five host
             guidance families (``HOST_FAMILIES``) on 512² crops of 375x500
             fake masks against the port's device form for the same fixed
             points, within the JAX package's bounds for its own pair
             (``HOST_DEVICE_TOL``: 0.5 on [0, 255], 2e-3 for
             ``extreme_points``), and the host's ms per sample of the
             family's val stage and of the whole train stack; (b) the
             fit ``HOST_DATA_ARGS`` (a ``Trainer`` in this process;
             DANet-R101 512² float32, DEXTR's
             ``extreme_points`` guidance) with ``data.sbd_root`` on a fake
             SBD tree written by the port (``make_fake_sbd``, SBD's 375x500,
             repeating the fake VOC's val ids): its parameter report's
             ``train_set`` a ``Combined(...)`` of the length counted part by
             part with the val ids excluded, one step per full batch,
             finite losses, a Jaccard in [0, 1], launches one per step and
             val sample, then ``Predictor.from_run`` serving a batch of 4
             click sets with that family (one launch each); (c) the same
             fit with ``confidence_l1l2`` (a ``Trainer`` in this process),
             launches exact, and ``Predictor.from_run`` refusing its run
             with the JAX package's message; (d) DeepLabV3-R101 at 513² in
             bf16 with ``data.sbd_root``: the combined semantic set, finite
             losses, no attention kernel launched.
16. swap   — hot swap with canary generations, DANet-R101 at 512²
             ``guidance_inject=head``, float32, through
             ``InferenceService(max_batch=4)``: generation 0 is
             ``Predictor.fresh(seed=0)``, generation 1 comes from
             ``load_swap_predictor`` on a seed-7 ``state_dict``.  (a) It is
             admitted at ``canary_fraction=1.0`` (``swap()`` timed, its
             warm-up on the calling thread); a pre-swap session's warm
             clicks bitwise before, during and after ``promote()``; a new
             session's mask within 1e-4 of generation 1's own
             ``Predictor.predict`` (``SWAP_NEW_TOL``); one promote in
             ``health()["swap"]``.  (b) Allocated memory less the session
             store's bytes rises by one weight set (every parameter and
             buffer at its dtype's size, printed) in the window and, once generation
             0 is retired and the script's own reference dropped, returns to
             its level before the swap, each within 16 MiB
             (``SWAP_FREE_TOL``).  (c) A ``serve/swap_params`` ``nan`` plan
             armed around ``load_swap_predictor``: the poisoned canary's
             first request fails over (its mask bitwise the active
             generation's), it is rolled back and none of its sessions stay.
             (d) The warm-click p50 over 20 clicks before the swap and in the
             window (the old session in turns with the new one), each under
             the 100 ms budget.  (e) A ResNet-101 ``deep_stem`` backbone's
             forward at 512², float32 against float64 on the card, each map
             within 1e-3 of its largest value (``DEEP_STEM_TOL``, 9b's bound).
17. quantize — int8 weight-only serving (``serve/quantize.py``), DANet-R101
             at 512², every weight drawn from seed 0, TF32 off: (a)
             ``quantize_predictor`` of the float32 predictor: every conv's
             ``weight_q``/``weight_scale`` on the card bitwise the host
             quantizer's for the same weights, no float conv weight on the
             int8 model, the float32 predictor's B = 1 forward bitwise as
             before; (b) ``forward_prepared`` at buckets 1, 2 and 4 on the
             int8 predictor in float32, then on the int8 copy of a bf16
             predictor on the same weights: one launch of each kernel a
             forward, each head's logits and the probabilities against the
             plain forms on the same int8 model (``QUANT_PLAIN_TOL``: phase
             3's 1e-3 in float32, phase 2's 2e-2 in bf16), the probabilities
             against the float predictor of the same dtype within the band
             the JAX package documents (max |diff| <= 0.25, mean <= 0.02),
             the mask IoU at 0.5 printed, not gated (random weights); (c)
             the allocated rise of building the int8 predictor within 16 MiB
             of ``quantize_report``'s bytes (``QUANT_MEM_TOL``), its ratio to
             the float32 weight set printed; (d) ``forward_prepared`` p50 at
             B = 1 and 4, float32 and int8 in turns, 20 calls each (printed,
             not gated); (e) an int8 canary in a float32
             ``InferenceService(max_batch=4)`` at ``canary_fraction=1.0``: 3
             requests bitwise its own ``predict``, rolled back, the float32
             answer bitwise; then a float32 ``state_dict`` (the same seed-0
             weights) swapped onto an int8 active generation by
             ``load_swap_predictor``: a float32 ``Predictor``, served within
             1e-4 of the float32 predictor (``QUANT_SWAP_TOL``), promoted, the
             int8 generation's answer bitwise before and after; each
             generation launching every kernel; (f) ``python -m
             distributedpytorch_tpu_torch.serve --fresh-init 512:resnet101:0
             --quantize int8`` started at the phase's start: its boot line's
             ``quantization`` block, one ``POST /v1/predict`` answered, exit 0
             on SIGTERM and no process of its group left.
18. aot    — the AOT program cache (``serve/aot.py``), DANet-R101 at 512²,
             every weight drawn from seed 0, float32, TF32 off: (a) ``python
             -m distributedpytorch_tpu_torch.serve.aot`` of the stem ladder
             at ``max_batch=2`` (``forward_b1``, ``forward_b2``;
             AOTInductor packages), started before phase 12 at the lowest
             CPU priority so that it compiles on the cores phases 12-17
             leave idle: each program's build seconds, the packages' bytes,
             and at least one Inductor compile a program on the build's
             ``CompileWatchdog``; (b) a
             fresh predictor with both packages loaded (``AotCache.load``)
             and installed: ``forward_prepared`` at buckets 1 and 2 within
             1e-3 of the eager forward (phase 3's ``AOT_TOL``), one launch of
             each kernel per forward, the same bits twice, the profiler's
             device kernels of one package forward naming
             ``pam_forward_kernel``, ``cam_gram_kernel`` and
             ``cam_apply_kernel``, and the p50 of the package and the eager
             forward (printed); (c) ``python -m
             distributedpytorch_tpu_torch.serve --fresh-init 512:resnet101:0
             --max-batch 2 --warmup --aot-cache DIR`` as a fresh process: the
             boot line's ``cold_start`` with ``aot_cache`` ``hit`` and 2
             programs loaded, the server's ``0 compiles on the
             CompileWatchdog`` line before it, 4 HTTP masks within 1e-3 of
             the in-process eager masks, ``/healthz`` ok with no retrace;
             the same server's eager ``--warmup`` boot beside it (seconds to
             the boot line and the card's MiB in use by each server,
             printed); (d) the warm boot with ``DPTPU_CHAOS_PLAN`` arming a
             ``bitflip`` at ``serve/aot_load``: a ``REFUSING`` line,
             ``aot_cache`` ``partial`` or ``miss``, masks as in (c); then
             ``python -m distributedpytorch_tpu_torch.serve.aot --verify``
             on a copy with one bit flipped exits 1 naming the entry; (e)
             while the script has run under ``AOT_EXTRA_DEADLINE_S``, each
             at bucket 1 on DANet-R50 (ResNet-101's widths): the bf16 stem
             program (2e-2), the split encode/decode pair (1e-3) and the
             int8 stem program (``QUANT_PLAIN_TOL``), each against its eager
             forward with one launch of each kernel; what is left out is
             printed.

The first line describes the host (CPU affinity, ``/dev/shm``, RAM,
whether PIL imports and cv2, grain, tensorboard and matplotlib are
installed).  The launch counters
are zeroed just before phase 3 and read after phase 5 (the serving path),
zeroed by the trainer when its fit starts and read from its
``fit_summary.json`` (the training paths, f32, bf16 and worker-fed, the
latter two summed over the preempted and resumed runs), and zeroed just
before the bf16 run is served (the bf16 serving path), and zeroed by each
rank of phase 8 (a) and (b) before each of its steps (the data-parallel
path, rank 0's counts summed), zeroed just before phase 10a's overlapped
epoch and read after its join (the overlapped validation path), and
zeroed by the trainer when phase 10c's fit starts and read from its
``fit_summary.json``, and likewise for phase 11a's default fit and phase
12e's fit with the device stage, taken as the difference across 13d's
service calls (its bursts, the budget and out-of-crop clicks; the
references are computed before) and across 13e's HTTP calls, in each
dtype, summed (the session serving path), and read from 13f's
``fit_summary.json``, and read from each of 14c's fits'
``fit_summary.json`` plus the served batch's launches: every kernel must
have run on each, but PAM on 14c's blocked-form fit, where it must not,
and read from 15b's ``fit_summary.json`` plus its served batch's
launches, 15c's and 15d's (where none may run), and zeroed just before
16a and taken as the difference across each of the service's requests
in 16a-16d (both generations', each of which must launch every kernel,
and the poisoned canary's click; the warm-ups and the reference
``predict`` left out) (the swap path), and taken as the difference
across 17b's int8 forwards in both dtypes and each of 17e's requests
(every generation's; the plain forms, references, warm-ups and 17d's
timing left out) (the int8 path), and taken as the difference across
18b's package forwards and 18e's (the AOT path; the builds' round trips,
the eager references and the timing left out; the servers of 18c and
18d launch in their own processes).  Launches made
only to compare the model with its plain forms (phase 2's logits) are
taken out of the counts.  Every
bounded check of phases 6f-6j and 8 records its
smallest limit / value, printed as the ``margins`` line before the
records.  The second-to-last line is the ``kernels`` JSON record; the last
line is the device record.  ``--phases train`` (or any comma list of
``kernels,serve,train,host,dist,semantic,trainer,telemetry,devdata,sessions,head_knobs,host_data,swap,quantize,aot``) runs part of the script for development
and then prints neither record.
"""

from __future__ import annotations

import contextlib
import gc
import json
import math
import statistics
import subprocess
import sys
import threading
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

#: dense peak rates (float32 FLOP/s on CUDA cores, bf16 FLOP/s and TF32
#: FLOP/s on tensor cores, memory bytes/s) from NVIDIA's data sheets, by
#: card variant
PEAKS = {
    "H100 SXM": (67e12, 989e12, 495e12, 3.35e12),
    "H100 PCIe": (51e12, 756e12, 378e12, 2.0e12),
    "H100 NVL": (60e12, 835e12, 417.5e12, 3.9e12),
}
REPO = Path(__file__).resolve().parent
TPU_KERNELS = {
    "position_attention": "distributedpytorch_tpu/ops/pallas_attention.py:50",
    "cam_energy": "distributedpytorch_tpu/ops/pallas_attention.py:167",
    "cam_apply": "distributedpytorch_tpu/ops/pallas_attention.py:195",
}
SOURCE = "distributedpytorch_tpu_torch/csrc/attention.cu"


def log(msg: str) -> None:
    print(msg, flush=True)


#: every bounded check's smallest limit / value over this run (inf where
#: the value was 0); printed as the ``margins`` line before the records
MARGINS: dict[str, float] = {}


def note_margin(name: str, value: float, limit: float) -> float:
    """Record ``limit / value`` as ``name``'s margin (the smallest seen)."""
    ratio = math.inf if value == 0 else limit / value
    MARGINS[name] = min(MARGINS.get(name, math.inf), ratio)
    return ratio


def check(name: str, value: float, limit: float) -> None:
    """Raise unless ``value <= limit``; print both and the margin."""
    ratio = note_margin(name, value, limit)
    log(f"check {name}: {value:.3e} <= {limit:.3e} (limit/value {ratio:.3g})")
    if not value <= limit:
        raise AssertionError(f"{name}: {value:.3e} > {limit:.3e}")


def _launches_since(ca, before: dict) -> dict:
    return {k: ca.launches[k] - before[k] for k in before}


@contextlib.contextmanager
def _uncounted(ca):
    """Launches inside the block (a comparison with the plain forms, not a
    path) are taken back out of the counts."""
    before = dict(ca.launches)
    try:
        yield
    finally:
        ca.launches.update(before)


def card_peaks(name: str) -> tuple[str, tuple[float, float, float, float]]:
    for key in ("PCIe", "NVL"):
        if key in name:
            return f"H100 {key}", PEAKS[f"H100 {key}"]
    return "H100 SXM", PEAKS["H100 SXM"]


#: calls per CUDA-event pair of the back-to-back timing
RUN = 20
#: step times of earlier phases that later ones print beside their own
STEP_MS: dict[str, float] = {}


def median_ms(fns, inner: int = 1, reps: int = 21, warmup: int = 3) -> list[float]:
    """Milliseconds per call of each of ``fns``: the median over ``reps``
    rounds, each round timing every function in turn with one CUDA-event
    pair around ``inner`` calls back to back, so that a slow spell of the
    card or of the host falls on all of them alike.  With ``inner = 1`` (a
    single launch) the device waits for whatever part of the host's launch
    cost comes before its first kernel; runs of ``RUN`` calls hide that
    cost wherever the device is the slower of the two."""
    import torch

    for fn in fns:
        for _ in range(warmup):
            fn()
    times = [[] for _ in fns]
    for _ in range(reps):
        for fn, acc in zip(fns, times):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(inner):
                fn()
            end.record()
            end.synchronize()
            acc.append(start.elapsed_time(end) / inner)
    return [statistics.median(t) for t in times]


def both_ms(*fns) -> tuple[list[float], list[float]]:
    """Single-launch ms and ms per call in runs of ``RUN`` of each of
    ``fns``, timed together."""
    return median_ms(fns), median_ms(fns, inner=RUN)


def host_us(fn, calls: int = 50, reps: int = 5) -> float:
    """Host microseconds per ``fn()`` while the device's queue has room:
    the Python wrapper's own cost, its launches included (median of
    ``reps`` loops of ``calls`` calls, the device drained before each)."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        times.append((time.perf_counter() - t0) / calls * 1e6)
    torch.cuda.synchronize()
    return statistics.median(times)


def bound(flops: float, nbytes: float, rate: float, bw: float) -> tuple[float, str]:
    """The least time (ms) for ``flops`` at ``rate`` and ``nbytes`` at ``bw``,
    and which of the two sets it."""
    by_ops, by_bytes = flops / rate, nbytes / bw
    return max(by_ops, by_bytes) * 1e3, "operations" if by_ops >= by_bytes else "bytes"


def phase_kernels(torch, ca, att, peaks) -> dict:
    """Phase 2: correctness on the card, then timings at B = 1 and B = 8."""
    import torch.nn.functional as F

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(*shape, generator=gen, device=dev) * scale).to(dtype)

    # Scales keep the softmaxes soft enough that float32 summation-order
    # noise in the scores is not amplified past the stated bound;
    # check_precision holds the kernels to float64 at larger ones.
    def pam_inputs(b, n, ck, cv, dtype):
        return (randn(b, n, ck, scale=0.5, dtype=dtype),
                randn(b, n, ck, scale=0.5, dtype=dtype),
                randn(b, n, cv, dtype=dtype))

    def cam_inputs(b, n, c, dtype):
        return (randn(b, n, c, scale=0.05, dtype=dtype),)

    def apply_inputs(b, n, c, dtype):
        x = randn(b, n, c, scale=0.05, dtype=dtype)
        return att.channel_energy(x), x

    kernels = {
        "position_attention": (ca.flash_position_attention,
                               att.position_attention, pam_inputs),
        "cam_energy": (ca.cam_energy, att.channel_energy, cam_inputs),
        "cam_apply": (ca.cam_apply, att.channel_apply, apply_inputs),
    }
    # (B, N, Ck, C): serving shapes at B = 1 and 8, ragged N, narrow head,
    # and two odd widths (C = 100: 16-byte rows in float32 but not in
    # bfloat16; C = 67: no 16-byte rows at all)
    shapes = [(1, 4096, 64, 512), (8, 4096, 64, 512), (2, 4225, 64, 512),
              (2, 65, 16, 128), (2, 4225, 16, 100), (1, 257, 8, 67)]
    errors = {name: 0.0 for name in kernels}
    for name, (kernel, plain, make) in kernels.items():
        for b, n, ck, c in shapes:
            for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
                args = make(b, n, ck, c, dtype) if name == "position_attention" \
                    else make(b, n, c, dtype)
                out = kernel(*args)
                torch.cuda.synchronize()
                ref = plain(*args)
                torch.cuda.synchronize()
                if out.dtype != ref.dtype or out.shape != ref.shape:
                    raise AssertionError(
                        f"{name} {dtype}: got {out.dtype} {tuple(out.shape)}, "
                        f"plain gives {ref.dtype} {tuple(ref.shape)}")
                err = (out.float() - ref.float()).abs().max().item()
                limit = tol * ref.float().abs().max().item()
                if not err <= limit:
                    raise AssertionError(
                        f"{name} B={b} N={n} C={c} {dtype}: max |diff| {err:.3e}"
                        f" > {limit:.3e}")
                if dtype == torch.float32 and n == 4096 and c == 512:
                    errors[name] = max(errors[name], err)
                # no atomics: a second launch gives the same bits
                if not torch.equal(out, kernel(*args)):
                    raise AssertionError(f"{name} B={b} N={n} C={c} {dtype}: "
                                         f"two launches differ")
                log(f"check {name} B={b} N={n} C={c} {str(dtype)[6:]}: "
                    f"max|diff| {err:.3e} <= {limit:.3e}; a second launch is "
                    f"bitwise equal")

    check_precision(torch, ca, att, randn)
    check_nan(torch, ca, att, randn)

    f32, bf16, tf32, bw = peaks
    # float32 work at float32 accuracy: 3xTF32 on the tensor cores, three
    # TF32 products per product, beats the CUDA cores' float32 rate
    f32_exact = max(tf32 / 3, f32)
    n, ck, c = 4096, 64, 512
    records = {}
    for b in (1, 8):
        q, k, v = pam_inputs(b, n, ck, c, torch.float32)
        x, = cam_inputs(b, n, c, torch.float32)
        attn = att.channel_energy(x)
        # E is symmetric: the function needs its c(c + 1) / 2 distinct entries
        gram_flops = 2.0 * b * n * c * (c + 1) / 2
        work = {
            # (kernel, plain, library, flops, bytes)
            "position_attention": (
                lambda: ca.flash_position_attention(q, k, v),
                lambda: att.position_attention(q, k, v),
                lambda: F.scaled_dot_product_attention(
                    q[:, None], k[:, None], v[:, None], scale=1.0),
                2.0 * b * n * n * (ck + c), 4.0 * b * n * (2 * ck + 2 * c)),
            "cam_energy": (
                lambda: ca.cam_energy(x),
                lambda: att.channel_energy(x),
                lambda: torch.softmax(_rowmax_minus(torch.bmm(x.transpose(1, 2), x)), -1),
                gram_flops, 4.0 * b * (n * c + c * c)),
            "cam_apply": (
                lambda: ca.cam_apply(attn, x),
                lambda: att.channel_apply(attn, x),
                lambda: torch.bmm(x, attn.transpose(1, 2)),
                2.0 * b * n * c * c, 4.0 * b * (2 * n * c + c * c)),
        }
        for name, (kern, plain, lib, flops, nbytes) in work.items():
            (ms, plain_ms, lib_ms), (ms_run, plain_run, lib_run) = both_ms(
                kern, plain, lib)
            bound_ms, bound_by = bound(flops, nbytes, f32_exact, bw)
            cuda_core_ms, _ = bound(flops, nbytes, f32, bw)
            log(f"time {name} B={b}: kernel {ms:.4f} ms single launch, {ms_run:.4f} "
                f"ms in runs of {RUN}; plain {plain_ms:.4f} / {plain_run:.4f} ms; "
                f"library {lib_ms:.4f} / {lib_run:.4f} ms; bound {bound_ms:.4f} ms "
                f"({bound_by}, 3xTF32), {bound_ms / ms:.1%} of it single, "
                f"{bound_ms / ms_run:.1%} in runs; CUDA-core f32 bound "
                f"{cuda_core_ms:.4f} ms")
            if min(ms, ms_run) < bound_ms:
                raise AssertionError(f"{name} B={b}: {min(ms, ms_run):.4f} ms is below "
                                     f"its bound {bound_ms:.4f} ms: the work is miscounted")
            if name == "cam_energy":
                computed = gram_tile_entries(c, ca._GRAM_TILE)
                tiles_ms, _ = bound(2.0 * b * n * computed, nbytes, f32_exact, bw)
                log(f"time cam_energy B={b}: the Gram computes {computed} entries "
                    f"(its whole tiles on and above the diagonal) of the "
                    f"{c * (c + 1) // 2} it needs; bound at the computed count "
                    f"{tiles_ms:.4f} ms")
            if b == 1:
                records[name] = {
                    "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                    "bound_ms": bound_ms, "bound_by": bound_by,
                    "ms_run20": ms_run, "plain_ms_run20": plain_run,
                    "library_ms_run20": lib_run,
                    "host_us": host_us(kern), "library_host_us": host_us(lib)}
                log(f"time {name} B=1: host {records[name]['host_us']:.1f} us per "
                    f"call of the wrapper, {records[name]['library_host_us']:.1f} us "
                    f"of the library call")
        # the energy kernel's two launches, each alone
        partial, energy = ca._gram_buffers(x)
        splits = partial.shape[1]
        (gram_ms, softmax_ms), (gram_run, softmax_run) = both_ms(
            lambda: ca._launch_gram(x, partial),
            lambda: ca._launch_softmax(partial, energy))
        gram_bound, gram_by = bound(gram_flops, 4.0 * b * (n * c + splits * c * c),
                                    f32_exact, bw)
        softmax_bound, softmax_by = bound(0.0, 4.0 * b * (splits + 1) * c * c,
                                          f32_exact, bw)
        log(f"time cam_energy B={b} launches: Gram ({splits} slices of N) "
            f"{gram_ms:.4f} ms single, {gram_run:.4f} ms in runs, bound "
            f"{gram_bound:.4f} ms ({gram_by}); softmax {softmax_ms:.4f} ms single, "
            f"{softmax_run:.4f} ms in runs, bound {softmax_bound:.4f} ms "
            f"({softmax_by})")
        (ours, composite), (ours_run, composite_run) = both_ms(
            lambda: ca.flash_channel_attention(x),
            lambda: torch.bmm(
                torch.softmax(_rowmax_minus(torch.bmm(x.transpose(1, 2), x)), -1),
                x.transpose(1, 2)))
        log(f"time channel_attention B={b}: kernels {ours:.4f} ms single, "
            f"{ours_run:.4f} ms in runs; library composite bmm+softmax+bmm "
            f"{composite:.4f} ms single, {composite_run:.4f} ms in runs")
    # bf16 inputs, as the bf16 training and serving forwards give them, each
    # kernel against its plain form and a library call on the same inputs,
    # in turns; bounds at the bf16 tensor-core rate (or the bytes: bf16
    # tokens, float32 maps)
    for b in (1, 8):
        q, k, v = pam_inputs(b, n, ck, c, torch.bfloat16)
        x, = cam_inputs(b, n, c, torch.bfloat16)
        attn = att.channel_energy(x)
        work = {
            "position_attention": (
                lambda: ca.flash_position_attention(q, k, v),
                lambda: att.position_attention(q, k, v),
                lambda: F.scaled_dot_product_attention(
                    q[:, None], k[:, None], v[:, None], scale=1.0),
                2.0 * b * n * n * (ck + c), 2.0 * b * n * (2 * ck + 2 * c)),
            # the library calls round E (energy) or the map (apply) to
            # bf16: a cheaper, less accurate function than the kernels'
            "cam_energy": (
                lambda: ca.cam_energy(x),
                lambda: att.channel_energy(x),
                lambda: torch.softmax(_rowmax_minus(
                    torch.bmm(x.transpose(1, 2), x).float()), -1),
                2.0 * b * n * c * (c + 1) / 2, 2.0 * b * n * c + 4.0 * b * c * c),
            "cam_apply": (
                lambda: ca.cam_apply(attn, x),
                lambda: att.channel_apply(attn, x),
                lambda: torch.bmm(x, attn.transpose(1, 2).to(torch.bfloat16)),
                2.0 * b * n * c * c, 4.0 * b * n * c + 4.0 * b * c * c),
        }
        for name, (kern, plain, lib, flops, nbytes) in work.items():
            (ms, plain_ms, lib_ms), (ms_run, plain_run, lib_run) = both_ms(
                kern, plain, lib)
            bf16_ms, bf16_by = bound(flops, nbytes, bf16, bw)
            log(f"time {name} B={b} bf16: kernel {ms:.4f} ms single, {ms_run:.4f} "
                f"ms in runs of {RUN}; plain {plain_ms:.4f} / {plain_run:.4f} ms; "
                f"library {lib_ms:.4f} / {lib_run:.4f} ms; bf16 bound {bf16_ms:.4f} "
                f"ms ({bf16_by}), {bf16_ms / ms:.1%} of it single, "
                f"{bf16_ms / ms_run:.1%} in runs")
            if min(ms, ms_run) < bf16_ms:
                raise AssertionError(f"{name} B={b} bf16: {min(ms, ms_run):.4f} ms is "
                                     f"below its bound {bf16_ms:.4f} ms")
            if b == 1:
                records[name]["bf16"] = {
                    "ms": ms, "ms_run20": ms_run, "plain_ms": plain_ms,
                    "plain_ms_run20": plain_run, "library_ms": lib_ms,
                    "library_ms_run20": lib_run, "bound_ms": bf16_ms,
                    "bound_by": bf16_by}
    for name in records:
        records[name]["max_abs_err"] = errors[name]
    return records


#: the scale of the inputs at which check_precision holds each kernel to
#: float64 and requires a single-pass TF32 product to fail: X for the
#: channel kernels, q and k for the position kernel (v at unit scale)
PRECISION_SCALE = {"cam_energy": 0.25, "cam_apply": 0.25,
                   "position_attention": 1.0}


def check_precision(torch, ca, att, randn) -> None:
    """Float32 accuracy of the kernels at B = 1, N = 4096, Ck = 64,
    C = Cv = 512, against their plain forms taken in float64, with the bound
    of the other checks, 1e-4 x max |exact|.  The float32 plain form
    (cuBLAS) and the same form with single-pass TF32 products
    (``allow_tf32``) are held to it beside the kernel.  At
    ``PRECISION_SCALE`` the kernel must pass and the single-pass TF32 form
    must miss, or the check could not tell a single-pass TF32 kernel from a
    float32-exact one; the other scales are printed only: at unit scale the
    float32 channel energy itself sits at the bound (``rowmax - E`` rounds
    to the ulp of the diagonal, ~|x|^2 N)."""
    failures = []

    def hold(name, scale, kernel, plain, ref):
        limit = 1e-4 * ref.abs().max().item()
        err = {}
        for what, fn, tf32 in (("kernel", kernel, False),
                               ("float32 plain", plain, False),
                               ("single-pass TF32 plain", plain, True)):
            torch.backends.cuda.matmul.allow_tf32 = tf32
            try:
                got = fn()
            finally:
                torch.backends.cuda.matmul.allow_tf32 = False
            err[what] = (got.double() - ref).abs().max().item()
        log(f"check {name} precision, inputs at scale {scale} vs float64: limit "
            f"{limit:.3e}; " + ", ".join(
                f"{what} {e:.3e} ({e / limit:.3g}x the limit)"
                for what, e in err.items()))
        if scale != PRECISION_SCALE[name]:
            return
        if not err["kernel"] <= limit:
            failures.append(f"{name} at scale {scale}: {err['kernel']:.3e} > "
                            f"{limit:.3e} against float64")
        if not err["single-pass TF32 plain"] > limit:
            failures.append(f"{name}: single-pass TF32 passes the check at "
                            f"scale {scale}, so it cannot see TF32 rounding")

    for scale in (1.0, 0.25, 0.05):
        x = randn(1, 4096, 512, scale=scale)
        xd = x.double()
        exact = torch.softmax(_rowmax_minus(xd.transpose(1, 2) @ xd), -1)
        attn = exact.float()
        hold("cam_energy", scale, lambda: ca.cam_energy(x),
             lambda: att.channel_energy(x), exact)
        hold("cam_apply", scale, lambda: ca.cam_apply(attn, x),
             lambda: att.channel_apply(attn, x), xd @ attn.double().transpose(1, 2))
    for scale in (1.0, 0.5):
        q, k = randn(1, 4096, 64, scale=scale), randn(1, 4096, 64, scale=scale)
        v = randn(1, 4096, 512)
        exact = torch.softmax(q.double() @ k.double().transpose(1, 2), -1) @ v.double()
        hold("position_attention", scale, lambda: ca.flash_position_attention(q, k, v),
             lambda: att.position_attention(q, k, v), exact)
    if failures:
        raise AssertionError("; ".join(failures))


def check_nan(torch, ca, att, randn) -> None:
    """NaN in gives NaN out exactly where the plain form has it: X carries
    two float32 NaN payloads (every mantissa bit set, as the device's own
    NaN; only the lowest bit set) in batch entries 0 and 1, and the map one
    in entry 2; for the position kernel q, k and v carry one each in
    entries 0, 1 and 2 (a query row, a key, a value channel); float32 and
    bfloat16 inputs."""
    for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
        x = randn(3, 300, 128, scale=0.05)
        attn = att.channel_energy(x)
        x.view(torch.int32)[0, 5, 7] = 0x7fffffff
        x.view(torch.int32)[1, 10, 20] = 0x7f800001
        attn.view(torch.int32)[2, 3, 9] = 0x7fffffff
        x = x.to(dtype)
        q, k, v = randn(3, 300, 64, scale=0.5), randn(3, 300, 64, scale=0.5), \
            randn(3, 300, 512)
        q.view(torch.int32)[0, 5, 7] = 0x7fffffff
        k.view(torch.int32)[1, 10, 20] = 0x7f800001
        v.view(torch.int32)[2, 3, 9] = 0x7fffffff
        q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
        for name, kernel, plain, args in (
                ("cam_energy", ca.cam_energy, att.channel_energy, (x,)),
                ("cam_apply", ca.cam_apply, att.channel_apply, (attn, x)),
                ("position_attention", ca.flash_position_attention,
                 att.position_attention, (q, k, v))):
            out, ref = kernel(*args).float(), plain(*args).float()
            nan = ref.isnan()
            if not nan.any() or not torch.equal(out.isnan(), nan):
                raise AssertionError(f"{name} {dtype}: NaN at {int(out.isnan().sum())} "
                                     f"entries, the plain form at {int(nan.sum())}")
            err = (out - ref)[~nan].abs().max().item()
            limit = tol * ref[~nan].abs().max().item()
            if not err <= limit:
                raise AssertionError(f"{name} {dtype} with NaN inputs: finite max "
                                     f"|diff| {err:.3e} > {limit:.3e}")
            log(f"check {name} NaN inputs {str(dtype)[6:]}: NaN at the plain form's "
                f"{int(nan.sum())} entries and no others; finite max|diff| "
                f"{err:.3e} <= {limit:.3e}")


def gram_tile_entries(c: int, tile: int) -> int:
    """Entries of E that the Gram kernel computes: its whole tiles on and
    above the diagonal (the rest are their mirror images)."""
    sides = [min(tile, c - i) for i in range(0, c, tile)]
    return sum(a * b for i, a in enumerate(sides) for b in sides[i:])


def _rowmax_minus(energy):
    return energy.amax(dim=-1, keepdim=True) - energy


def synthetic_image(seed: int = 0):
    """A 480x640 RGB image with smooth structure plus noise, and 4 click
    sets (extreme points of boxes inside it)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:480, 0:640].astype(np.float32)
    image = np.stack([127 + 100 * np.sin(xx / 37.0 + c) * np.cos(yy / 53.0 - c)
                      for c in range(3)], -1)
    image += rng.normal(0, 10, image.shape)
    image = np.clip(image, 0, 255).astype(np.uint8)
    clicks = []
    for x0, y0, x1, y1 in ((60, 40, 300, 260), (320, 200, 600, 460),
                           (200, 100, 420, 380), (10, 300, 180, 470)):
        cx, cy = (x0 + x1) / 2, (y0 + y1) / 2
        clicks.append(np.array([[x0, cy], [cx, y0], [x1, cy], [cx, y1]],
                               np.float64))
    return image, clicks


def phase_predictor(torch, Predictor, ca) -> tuple:
    import numpy as np

    pred = Predictor.fresh(512, "resnet101", seed=0, device="cuda")
    gammas = {n: p.item() for n, p in pred.model.named_parameters()
              if n.endswith("gamma")}
    if not all(abs(g) > 0 for g in gammas.values()):
        raise AssertionError(f"a residual gate is zero: {gammas}")
    log(f"predictor: DANet-R101 512^2 fresh seed 0, gammas {gammas}")
    image, clicks = synthetic_image()
    t0 = time.perf_counter()
    masks = pred.predict_batch(image, clicks)
    log(f"predictor: first predict_batch (build + cuDNN search) "
        f"{time.perf_counter() - t0:.3f} s")
    counts = dict(ca.launches)
    if not all(counts[k] > 0 for k in counts):
        raise AssertionError(f"a kernel was not launched by predict_batch: {counts}")
    for m in masks:
        if m.shape != image.shape[:2] or not np.isfinite(m).all():
            raise AssertionError(f"bad mask {m.shape}")
    # the three heads' logits on the same prepared batch: the PAM and CAM
    # heads see their branch right after one conv-BN-ReLU
    x = torch.from_numpy(np.stack([pred.prepare(image, c)[0] for c in clicks]))
    x = x.to("cuda").permute(0, 3, 1, 2).contiguous()
    with torch.inference_mode(), _uncounted(ca):
        fast = pred.model(x)
        pred.model.set_attention_impl("xla")
        slow = pred.model(x)
        plain = pred.predict_batch(image, clicks)
        pred.model.set_attention_impl("auto")
    for head, a, b in zip(("fused", "pam", "cam"), fast, slow):
        err = (a - b).abs().max().item()
        bound = 1e-3 * max(1.0, b.abs().max().item())
        log(f"predictor: {head} logits kernels vs plain max |diff| {err:.3e} "
            f"<= {bound:.3e}; logit range [{b.min().item():.3f}, "
            f"{b.max().item():.3f}]")
        if not err <= bound:
            raise AssertionError(f"{head} logits: {err:.3e} > {bound:.3e}")
    diff = max(float(np.abs(a - b).max()) for a, b in zip(masks, plain))
    spread = [float(m.max() - m.min()) for m in masks]
    log(f"predictor: kernels vs plain forms max |diff| {diff:.3e} (<= 1e-3); "
        f"mask ranges {spread}")
    if not diff <= 1e-3:
        raise AssertionError(f"predictor kernels vs plain: {diff:.3e} > 1e-3")
    lat = []
    for _ in range(10):
        t0 = time.perf_counter()
        pred.predict(image, clicks[0])
        lat.append((time.perf_counter() - t0) * 1e3)
    lat_b = []
    for _ in range(5):
        t0 = time.perf_counter()
        pred.predict_batch(image, clicks)
        lat_b.append((time.perf_counter() - t0) * 1e3)
    log(f"predictor: request latency predict (1 click set) median "
        f"{statistics.median(lat):.2f} ms; predict_batch (4) median "
        f"{statistics.median(lat_b):.2f} ms")
    breakdown(torch, pred, image, clicks)
    return pred, image, clicks


def _host_ms(fn, reps: int = 5) -> float:
    """Median host-clock milliseconds of ``fn()`` (which synchronises)."""
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def breakdown(torch, pred, image, clicks) -> None:
    """Where a request's time goes: host preprocessing, the forward (with
    the kernels and with the plain forms), paste-back, and the device time
    of the top CUDA kernels of one B = 1 forward."""
    import numpy as np

    from distributedpytorch_tpu_torch import native_ops

    prep_ms = _host_ms(lambda: pred.prepare(image, clicks[0]))
    native_ops.reset_calls()
    concat, bbox = pred.prepare(image, clicks[0])
    prep_calls = dict(native_ops.calls)
    prob = pred.forward_prepared(concat)[0]
    paste_ms = _host_ms(lambda: pred.paste_back(prob, bbox, image.shape[:2]))
    with numpy_forms():
        prep_np_ms = _host_ms(lambda: pred.prepare(image, clicks[0]))
        paste_np_ms = _host_ms(lambda: pred.paste_back(prob, bbox, image.shape[:2]))
    log(f"breakdown: prepare {prep_ms:.2f} ms on the host library ({prep_np_ms:.2f} "
        f"ms on the numpy forms; library calls of one prepare {prep_calls}), "
        f"paste_back {paste_ms:.2f} ms ({paste_np_ms:.2f} ms on the numpy forms)")
    stack = {b: np.stack([concat] * b) for b in (1, 4)}
    fwd = {}
    for impl in ("auto", "xla"):
        pred.model.set_attention_impl(impl)
        for b in (1, 4):
            fwd[impl, b] = _host_ms(lambda: pred.forward_prepared(stack[b]))
    pred.model.set_attention_impl("auto")
    log(f"breakdown: prepare {prep_ms:.2f} ms, paste_back {paste_ms:.2f} ms "
        f"per click set; forward_prepared B=1 {fwd['auto', 1]:.2f} ms "
        f"(plain attention {fwd['xla', 1]:.2f} ms), B=4 {fwd['auto', 4]:.2f} ms "
        f"(plain attention {fwd['xla', 4]:.2f} ms)")
    x = torch.from_numpy(concat[None]).to("cuda").permute(0, 3, 1, 2).contiguous()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.inference_mode(), torch.profiler.profile(activities=acts) as prof:
        pred.model(x)
        torch.cuda.synchronize()
    # device kernels and copies only: aten:: operator rows repeat the
    # device time of the kernels they launch
    events = [e for e in prof.key_averages()
              if e.self_device_time_total > 0 and not e.key.startswith("aten::")]
    total = sum(e.self_device_time_total for e in events)
    attn = sum(e.self_device_time_total for e in events
               if "pam_forward" in e.key or "cam_" in e.key)
    log(f"breakdown: profiler device time of one B=1 forward {total / 1e3:.3f} ms "
        f"over {len(events)} kernel names, of which the attention kernels "
        f"{attn / 1e3:.3f} ms")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:10]:
        log(f"breakdown:   {e.self_device_time_total / 1e3:8.3f} ms "
            f"x{e.count:<4d} {e.key[:90]}")


def phase_service(pred, image, clicks, InferenceService) -> None:
    import numpy as np

    requests = [clicks[i % len(clicks)] + 3.0 * (i // len(clicks))
                for i in range(8)]
    expected = [pred.predict(image, pts) for pts in requests]
    svc = InferenceService(pred, max_batch=4, max_wait_s=0.02)
    svc.warmup()
    with svc:
        with ThreadPoolExecutor(8) as pool:
            futures = list(pool.map(lambda p: svc.submit(image, p), requests))
        got = [f.result(timeout=300) for f in futures]
        stats = svc.metrics.snapshot()
    diff = max(float(np.abs(a - b).max()) for a, b in zip(got, expected))
    log(f"service: 8 concurrent submits resolved, max |diff| vs predict "
        f"{diff:.3e} (<= 1e-4); stats {json.dumps(stats)}")
    if not diff <= 1e-4:
        raise AssertionError(f"service vs predict: {diff:.3e} > 1e-4")


def phase_http(pred, image, clicks, InferenceService, make_server,
               ServeClient) -> None:
    import numpy as np

    svc = InferenceService(pred, max_batch=4).start()
    server = make_server(svc, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        url = f"http://127.0.0.1:{server.server_port}"
        client = ServeClient(url, timeout_s=300)
        for pts in clicks[:3]:
            t0 = time.perf_counter()
            mask = client.predict(image, pts)
            ms = (time.perf_counter() - t0) * 1e3
            if mask.shape != image.shape[:2] or not np.isfinite(mask).all():
                raise AssertionError(f"bad HTTP mask {mask.shape}")
            log(f"http: POST /v1/predict -> mask {mask.shape}, {ms:.2f} ms")
        with urllib.request.urlopen(url + "/healthz", timeout=30) as r:
            health = json.loads(r.read())
            if r.status != 200 or not health["ok"]:
                raise AssertionError(f"/healthz: {r.status} {health}")
        log(f"http: GET /healthz -> 200 ok, state {health['state']}")
    finally:
        server.shutdown()
        server.server_close()
        svc.stop()
        thread.join(timeout=30)


#: parameters whose gradient is zero in exact arithmetic, each held to the
#: bound of another: the PAM key conv's bias shifts every score of a query
#: row by the same amount, which the softmax cancels, so what is left of
#: its gradient is rounding noise
GRAD_SCALE_OF = {"head.pam.key.bias": "head.pam.key.weight"}
#: the profiler's names for the device time of the convolutions
CONV_FORWARD = ("aten::cudnn_convolution",)
CONV_BACKWARD = ("aten::convolution_backward",)
BATCH_NORM = ("aten::cudnn_batch_norm", "aten::native_batch_norm",
              "aten::cudnn_batch_norm_backward",
              "aten::native_batch_norm_backward")
ATTENTION_KERNELS = ("pam_forward_kernel", "cam_gram_kernel",
                     "cam_softmax_kernel", "cam_apply_kernel")


class Cycled:
    """``dataset``'s samples repeated to ``n``."""

    def __init__(self, dataset, n: int):
        self.dataset, self.n = dataset, n

    def __len__(self) -> int:
        return self.n

    def __getitem__(self, index: int, rng=None) -> dict:
        return self.dataset.__getitem__(index % len(self.dataset), rng=rng)


def train_dataset():
    """The train split of the in-memory fake VOC fixture that ``--fake-data``
    trains on (seed 0, every object), through the default train stack at
    512²."""
    from distributedpytorch_tpu_torch.data import fake, pipeline, voc

    tree = fake.make_fake_voc(n_images=8, size=(96, 128), n_val=3, seed=0)
    return voc.VOCInstanceSegmentation(
        tree, split="train", area_thres=0,
        transform=pipeline.build_train_transform(crop_size=(512, 512)))


def phase_train_grads(torch, ca, Predictor, batch) -> None:
    """6a: one step's gradients through the kernels and the plain forms."""
    from distributedpytorch_tpu_torch.ops.losses import multi_output_loss
    from distributedpytorch_tpu_torch.parallel.step import device_batch

    check_function_grads(torch, ca)
    model = Predictor.fresh(512, "resnet101", seed=0, device="cuda").model.train()
    model.head.dropout_rate = 0.0
    data = device_batch(batch, torch.device("cuda"))
    saved = {k: v.clone() for k, v in model.state_dict().items()}
    grads, rises, loss = {}, {}, {}
    # the convolutions' algorithms fixed, so that only attention differs
    torch.backends.cudnn.deterministic = True
    try:
        for path, impl, dtype in (("kernels", "flash", torch.float32),
                                  ("plain", "xla", torch.float32),
                                  ("float64", "xla", torch.float64)):
            model.to(dtype).load_state_dict(saved)
            model.zero_grad(set_to_none=True)
            model.set_attention_impl(impl)
            before = dict(ca.launches)
            out = multi_output_loss(model(data["concat"].to(dtype)),
                                    data["crop_gt"].to(dtype))
            out.backward()
            torch.cuda.synchronize()
            loss[path] = out.item()
            rises[path] = {k: ca.launches[k] - before[k] for k in before}
            grads[path] = {n: p.grad.detach().double()
                           for n, p in model.named_parameters()}
    finally:
        torch.backends.cudnn.deterministic = False
    log(f"train grads: DANet-R101 512^2 B={data['concat'].shape[0]}, loss with kernels "
        f"{loss['kernels']:.9f}, plain forms {loss['plain']:.9f}, plain forms in "
        f"float64 {loss['float64']:.9f}; forward launches with kernels "
        f"{rises['kernels']}, plain {rises['plain']}")
    if any(n != 1 for n in rises["kernels"].values()) or any(rises["plain"].values()):
        raise AssertionError(f"launches per forward+backward: kernels "
                             f"{rises['kernels']} (want 1 each), plain {rises['plain']}")
    kernels, plain, exact = grads["kernels"], grads["plain"], grads["float64"]
    rows, failures = [], []
    for name in plain:
        scale = plain[GRAD_SCALE_OF.get(name, name)].abs().max().item()
        diff = (kernels[name] - plain[name]).abs().max().item()
        f32_err = (plain[name] - exact[name]).abs().max().item()
        rows.append((diff / scale, diff / max(f32_err, 1e-300),
                     f32_err / exact[GRAD_SCALE_OF.get(name, name)].abs().max().item(),
                     name))
        if not diff <= max(1e-3 * scale, f32_err):
            failures.append(f"{name}: {diff:.3e} > 1e-3 x {scale:.3e} and > the "
                            f"float32 error {f32_err:.3e}")
    by_ratio = sorted(rows)
    by_f32 = sorted(rows, key=lambda r: r[1])
    over = [r for r in rows if r[0] > 1e-3]
    log(f"train grads: {len(rows)} parameter tensors; kernels vs plain max|diff| / "
        f"max|g|: largest {by_ratio[-1][0]:.3e} ({by_ratio[-1][3]}), median "
        f"{by_ratio[len(rows) // 2][0]:.3e}, {len(over)} above 1e-3; the float32 "
        f"plain path vs float64, max|diff| / max|g|: median "
        f"{statistics.median(r[2] for r in rows):.3e}, largest {max(r[2] for r in rows):.3e}; "
        f"kernels vs plain over the float32 error, largest {by_f32[-1][1]:.3e} "
        f"({by_f32[-1][3]})")
    pam = {n: kernels[f"head.pam.{n}"].abs().max().item()
           for n in ("query.weight", "key.weight", "value.weight", "query.bias",
                     "key.bias", "value.bias")}
    log("train grads: PAM max|g| with kernels " + ", ".join(
        f"{n} {v:.3e}" for n, v in pam.items()) + " (the key bias is held to the "
        "key weight's scale: its gradient is zero in exact arithmetic)")
    if failures:
        raise AssertionError("gradients, kernels vs plain forms: " + "; ".join(failures))
    if not all(pam[n] > 0 for n in ("query.weight", "key.weight", "value.weight")):
        raise AssertionError(f"a PAM projection gets no gradient through the kernels: {pam}")


def check_function_grads(torch, ca) -> None:
    """The kernels' autograd functions alone, at DANet-R101's attention shapes
    (B = 2, N = 4096, Ck = 64, C = Cv = 512): the gradients of q, k, v and x
    for a random upstream gradient against autograd through the plain forms
    (full softmax), each within 1e-3 x max |g|."""
    from distributedpytorch_tpu_torch.ops import attention as att

    gen = torch.Generator(device="cuda").manual_seed(1)

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device="cuda") * scale

    cases = (("position_attention", ca.flash_position_attention, att.position_attention,
              (randn(2, 4096, 64, scale=0.5), randn(2, 4096, 64, scale=0.5),
               randn(2, 4096, 512))),
             ("channel_attention", ca.flash_channel_attention, att.channel_attention,
              (randn(2, 4096, 512, scale=0.05),)))
    for name, kernel, plain, inputs in cases:
        upstream = randn(2, 4096, 512)
        got, want = ([x.detach().requires_grad_() for x in inputs] for _ in range(2))
        got = torch.autograd.grad(kernel(*got), got, upstream)
        want = torch.autograd.grad(plain(*want), want, upstream)
        ratios = [((g - w).abs().max() / w.abs().max()).item()
                  for g, w in zip(got, want)]
        log(f"train grads: {name} alone, gradient of each input through the kernel "
            f"vs the plain form, max|diff| / max|g| "
            + ", ".join(f"{r:.3e}" for r in ratios) + " (limit 1e-3)")
        if not all(r <= 1e-3 for r in ratios):
            raise AssertionError(f"{name}: input gradients {ratios} above 1e-3")


def _device_events(prof):
    """The profiler's device kernels and copies (no annotation ranges)."""
    from torch.autograd import DeviceType

    events = prof.events()
    cpu_names = {e.name for e in events if e.device_type == DeviceType.CPU}
    return [e for e in events if e.device_type == DeviceType.CUDA
            and e.name not in cpu_names
            and not getattr(e, "is_user_annotation", False)]


def _op_device_ms(prof, names) -> float:
    """Device ms of the kernels launched inside the host ops ``names``."""
    from torch.autograd import DeviceType

    return sum(e.device_time_total for e in prof.events()
               if e.device_type == DeviceType.CPU and e.name in names) / 1e3


def _profile_split(torch, ca, prof, step_ms: float, what: str,
                   label: str) -> dict:
    """Log one profiled step's device time by part, its top kernels and
    the idle share against ``step_ms``; returns the parts."""
    kernels = _device_events(prof)
    busy = sum(e.device_time_total for e in kernels) / 1e3
    attention = sum(e.device_time_total for e in kernels
                    if any(k in e.name for k in ATTENTION_KERNELS)) / 1e3
    parts = {
        "convolutions, forward": _op_device_ms(prof, CONV_FORWARD),
        "convolutions, backward": _op_device_ms(prof, CONV_BACKWARD),
        "batch norm, forward and backward": _op_device_ms(prof, BATCH_NORM),
        "attention kernels, forward": attention,
        "plain-form recompute, backward": _op_device_ms(prof, (ca.RECOMPUTE_RANGE,)),
        "optimizer step": sum(e.device_time_total for e in prof.events()
                              if e.name.startswith("Optimizer.step")
                              and e.device_type != torch.autograd.DeviceType.CUDA) / 1e3,
        "host-to-device copies": sum(e.device_time_total for e in kernels
                                     if e.name.startswith("Memcpy HtoD")) / 1e3,
    }
    idle = 1.0 - busy / step_ms
    log(f"{label} profile: {what}, device busy {busy:.2f} ms over {len(kernels)} "
        f"kernels and copies; idle share {idle:.4f} of the {step_ms:.2f} ms median "
        f"step")
    for what, t in parts.items():
        log(f"{label} profile:   {t:9.2f} ms  {what}")
    log(f"{label} profile:   {busy - sum(parts.values()):9.2f} ms  everything else")
    by_name: dict[str, list[float]] = {}
    for e in kernels:
        by_name.setdefault(e.name, []).append(e.device_time_total / 1e3)
    for name, ts in sorted(by_name.items(), key=lambda kv: -sum(kv[1]))[:10]:
        log(f"{label} profile:   top {sum(ts):9.2f} ms x{len(ts):<4d} {name[:90]}")
    return parts


def phase_train_step(torch, ca, dataset, batch_size: int = 16, rounds: int = 5) -> None:
    """6b: the default train step with the kernels and with the plain forms."""
    from distributedpytorch_tpu_torch.data import pipeline
    from distributedpytorch_tpu_torch.models import build_model
    from distributedpytorch_tpu_torch.parallel.step import (
        create_train_state,
        make_train_step,
    )
    from distributedpytorch_tpu_torch.train.config import OptimConfig
    from distributedpytorch_tpu_torch.train.optim import make_optimizer

    loader = pipeline.DataLoader(Cycled(dataset, 3 * batch_size), batch_size,
                                 shuffle=True, drop_last=True, seed=0)
    t0 = time.perf_counter()
    batches = list(loader)
    loader_ms = (time.perf_counter() - t0) * 1e3 / len(batches)
    t0 = time.perf_counter()
    for i in range(batch_size):
        dataset.__getitem__(i % len(dataset), rng=pipeline.sample_rng(0, 1, i))
    sample_ms = (time.perf_counter() - t0) * 1e3 / batch_size
    log(f"train data: default train stack at 512^2, {loader_ms:.1f} ms per batch of "
        f"{batch_size} through the DataLoader ({loader.num_workers} threads), "
        f"{sample_ms:.1f} ms per sample in one thread")

    cfg = OptimConfig()
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = build_model("danet")
    optimizer, schedule = make_optimizer(cfg, model, total_steps=100)
    state = create_train_state(model, optimizer, schedule, 0, torch.device("cuda"))
    step = make_train_step()
    batch = batches[0]
    paths = {"kernels": "auto", "plain": "xla"}
    peak_gb = {}
    for label, impl in paths.items():
        model.set_attention_impl(impl)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        first = step(state, batch).item()
        peak_gb[label] = torch.cuda.max_memory_allocated() / 2**30
        log(f"train step: first step with {label} {time.perf_counter() - t0:.3f} s, "
            f"loss {first:.6f}, peak memory {peak_gb[label]:.2f} GiB")
        step(state, batch)
    times = {label: [] for label in paths}
    losses = []
    before = dict(ca.launches)
    for _ in range(rounds):
        for label, impl in paths.items():
            model.set_attention_impl(impl)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            losses.append(step(state, batch))
            end.record()
            end.synchronize()
            times[label].append(start.elapsed_time(end))
    rise = {k: ca.launches[k] - before[k] for k in before}
    if any(n != rounds for n in rise.values()):
        raise AssertionError(f"{rounds} kernel-path steps launched {rise}: want one "
                             f"forward launch per kernel per step")
    if not torch.isfinite(torch.stack(losses)).all():
        raise AssertionError(f"non-finite train losses: {torch.stack(losses).tolist()}")
    ms = {label: statistics.median(t) for label, t in times.items()}
    for label in paths:
        log(f"train step: B={batch_size} 512^2 with {label} {ms[label]:.2f} ms median "
            f"of {rounds} (all {', '.join(f'{t:.2f}' for t in times[label])}), "
            f"{batch_size / ms[label] * 1e3:.2f} images/s, peak memory "
            f"{peak_gb[label]:.2f} GiB")

    model.set_attention_impl("auto")
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        step(state, batch)
        torch.cuda.synchronize()
    _profile_split(torch, ca, prof, ms["kernels"],
                   f"one B={batch_size} step with kernels", "train")


def _read_jsonl(path: Path) -> list[dict]:
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def phase_train_fit(torch, ca, Predictor) -> dict:
    """6c: the entry point end to end, then its run served."""
    import shutil
    import tempfile

    import numpy as np

    from distributedpytorch_tpu_torch.models import build_model
    from distributedpytorch_tpu_torch.train.checkpoint import (
        CheckpointManager,
        param_digest,
    )
    from distributedpytorch_tpu_torch.train.config import from_json

    work = Path(tempfile.mkdtemp(prefix="chip_smoke_fit_"))
    try:
        cmd = [sys.executable, "-m", "distributedpytorch_tpu_torch", "--fake-data",
               "data.train_batch=4", "data.area_thres=0", "epochs=2",
               f"work_dir={work}", "checkpoint.digest=true"]
        log(f"train fit: {' '.join(cmd[1:])}")
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                              timeout=600)
        fit_s = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"the fit exited {proc.returncode}:\n"
                                 f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
        (run,) = work.glob("run_*")
        with open(run / "fit_summary.json") as f:
            summary = json.load(f)
        records = _read_jsonl(run / "metrics.jsonl")
        epochs = [r for r in records if "train/step_losses" in r]
        step_losses = [x for r in epochs for x in r["train/step_losses"]]
        vals = [r for r in records if "val/jaccard" in r]
        final = summary["final_step"]
        if final < 4 or len(step_losses) != final or \
                not all(x is not None and math.isfinite(x) for x in step_losses):
            raise AssertionError(f"fit: {final} steps, losses {step_losses}")
        if len(vals) != 2 or not all(0.0 <= r["val/jaccard"] <= 1.0 for r in vals):
            raise AssertionError(f"fit validations: {vals}")
        with open(run / "checkpoints" / "COMMITTED.json") as f:
            ledger = json.load(f)
        if final not in ledger["latest"]:
            raise AssertionError(f"COMMITTED.json {ledger} does not name step {final}")
        launches = summary["kernel_launches"]
        want = final + sum(int(r["val/n_samples"]) for r in vals)
        if any(n != want for n in launches.values()):
            raise AssertionError(f"launches in the fit {launches}: want {want} each "
                                 f"({final} train steps + the validation samples)")
        log(f"train fit: {fit_s:.1f} s wall (process start, model build, data, "
            f"{final} steps, 2 validations, checkpoints); losses "
            f"{[round(x, 6) for x in step_losses]}; val jaccard "
            f"{[round(r['val/jaccard'], 6) for r in vals]} over "
            f"{[int(r['val/n_samples']) for r in vals]} samples; COMMITTED.json {ledger}; "
            f"kernel launches {launches}")
        for r in epochs:
            n = len(r["train/step_losses"])
            data_ms = r["train/data_wait_seconds"] / n * 1e3
            log(f"train fit: epoch {int(r['train/epoch'])}: {n} steps of B=4, "
                f"{r['train/epoch_seconds'] / n * 1e3:.1f} ms per step of the loop, "
                f"of which {data_ms:.1f} ms waiting on the host data; "
                f"{r['train/imgs_per_sec']:.2f} images/s")

        pred = Predictor.from_run(str(run), step=final, device="cuda")
        _, meta = CheckpointManager(str(run / "checkpoints")).load(final)
        if param_digest(pred.model.state_dict()) != meta["param_digest"]:
            raise AssertionError("the served weights are not the trained model's")
        cfg = from_json(str(run / "config.json"))
        model = build_model(cfg.model.name, backbone=cfg.model.backbone)
        payload, _ = CheckpointManager(str(run / "checkpoints")).load(final)
        model.load_state_dict(payload["model"], strict=True)
        model.to("cuda").eval()
        image, clicks = synthetic_image()
        concat, _ = pred.prepare(image, clicks[0])
        x = torch.from_numpy(concat[None]).to("cuda").permute(0, 3, 1, 2).contiguous()
        with torch.inference_mode():
            served = pred.model(x)
            direct = model(x)
        if not all(torch.equal(a, b) for a, b in zip(served, direct)):
            raise AssertionError("served logits differ from the checkpoint's model")
        mask = pred.predict(image, clicks[0])
        if mask.shape != image.shape[:2] or not np.isfinite(mask).all():
            raise AssertionError(f"bad mask from the trained run {mask.shape}")
        log(f"train fit: Predictor.from_run(step {final}) serves the weights the "
            f"trainer hashed at save (sha256 {meta['param_digest'][:16]}...), its "
            f"three logits bitwise equal to the checkpoint's model; a click gives a "
            f"finite {mask.shape} mask")
        return launches
    finally:
        shutil.rmtree(work, ignore_errors=True)


def phase_train_grads_bf16(torch, ca, Predictor, batch) -> None:
    """6d: one bf16 step's gradients through the kernels, through the plain
    forms in bf16 and through the plain forms in float32."""
    from distributedpytorch_tpu_torch.ops.losses import multi_output_loss
    from distributedpytorch_tpu_torch.parallel.step import _forward, device_batch
    from distributedpytorch_tpu_torch.train.precision import precision_policy

    policy = precision_policy("bfloat16")
    model = Predictor.fresh(512, "resnet101", seed=0, device="cuda").model.train()
    model.head.dropout_rate = 0.0
    data = device_batch(batch, torch.device("cuda"))
    saved = {k: v.clone() for k, v in model.state_dict().items()}
    grads, rises, loss, dtypes = {}, {}, {}, {}
    torch.backends.cudnn.deterministic = True
    try:
        for path, impl, pol in (("kernels", "flash", policy),
                                ("plain", "xla", policy),
                                ("float32", "xla", None)):
            model.load_state_dict(saved)
            model.set_compute_dtype(torch.bfloat16 if pol else None)
            model.zero_grad(set_to_none=True)
            model.set_attention_impl(impl)
            before = dict(ca.launches)
            out = multi_output_loss(_forward(model, data["concat"], pol),
                                    data["crop_gt"])
            out.backward()
            torch.cuda.synchronize()
            loss[path] = out.item()
            rises[path] = {k: ca.launches[k] - before[k] for k in before}
            dtypes[path] = {p.grad.dtype for p in model.parameters()}
            grads[path] = {n: p.grad.detach().double()
                           for n, p in model.named_parameters()}
    finally:
        torch.backends.cudnn.deterministic = False
    log(f"train grads bf16: DANet-R101 512^2 B={data['concat'].shape[0]}, loss with "
        f"kernels {loss['kernels']:.9f}, plain forms in bf16 {loss['plain']:.9f}, "
        f"plain forms in float32 {loss['float32']:.9f}; forward launches with "
        f"kernels {rises['kernels']}; gradient dtypes {sorted(map(str, dtypes['kernels']))}")
    if any(n != 1 for n in rises["kernels"].values()) or any(rises["plain"].values()):
        raise AssertionError(f"launches per bf16 forward+backward: kernels "
                             f"{rises['kernels']} (want 1 each), plain {rises['plain']}")
    if dtypes["kernels"] != {torch.float32}:
        raise AssertionError(f"bf16 step gradients in {dtypes['kernels']}, not float32")
    kernels, plain, f32 = grads["kernels"], grads["plain"], grads["float32"]
    rows, failures = [], []
    for name in plain:
        scale = f32[GRAD_SCALE_OF.get(name, name)].abs().max().item()
        diff = (kernels[name] - plain[name]).abs().max().item()
        own = (plain[name] - f32[name]).abs().max().item()
        rows.append((diff / scale, diff / max(own, 1e-300), own / scale, name))
        if not diff <= max(BF16_GRAD_TOL * scale, own):
            failures.append(f"{name}: {diff:.3e} > {BF16_GRAD_TOL} x {scale:.3e} and "
                            f"> the bf16 plain path's distance from float32 {own:.3e}")
    by_ratio = sorted(rows)
    log(f"train grads bf16: {len(rows)} parameter tensors; kernels vs plain bf16 "
        f"max|diff| / max|g|: largest {by_ratio[-1][0]:.3e} ({by_ratio[-1][3]}), "
        f"median {by_ratio[len(rows) // 2][0]:.3e}; the bf16 plain path vs float32, "
        f"max|diff| / max|g|: median {statistics.median(r[2] for r in rows):.3e}, "
        f"largest {max(r[2] for r in rows):.3e}; kernels-vs-plain over plain-vs-float32:"
        f" median {statistics.median(r[1] for r in rows):.3e}, largest "
        f"{max(r[1] for r in rows):.3e} ({max(rows, key=lambda r: r[1])[3]})")
    pam = {n: kernels[f"head.pam.{n}"].abs().max().item()
           for n in ("query.weight", "key.weight", "value.weight")}
    log("train grads bf16: PAM max|g| with kernels " +
        ", ".join(f"{n} {v:.3e}" for n, v in pam.items()))
    if failures:
        raise AssertionError("bf16 gradients, kernels vs plain forms: " +
                             "; ".join(failures))
    if not all(v > 0 for v in pam.values()):
        raise AssertionError(f"a PAM projection gets no bf16 gradient: {pam}")


def phase_train_step_bf16(torch, ca, dataset, batch_size: int = 16,
                          rounds: int = 5) -> None:
    """6e: the bf16 train step (B = 16) in turns with the float32 kernel step
    and the bf16 plain-form step; then one bf16 step with remat."""
    from distributedpytorch_tpu_torch.data import pipeline
    from distributedpytorch_tpu_torch.models import build_model
    from distributedpytorch_tpu_torch.parallel.step import (
        create_train_state,
        make_train_step,
    )
    from distributedpytorch_tpu_torch.train.config import OptimConfig
    from distributedpytorch_tpu_torch.train.optim import make_optimizer
    from distributedpytorch_tpu_torch.train.precision import precision_policy

    loader = pipeline.DataLoader(Cycled(dataset, batch_size), batch_size,
                                 shuffle=True, drop_last=True, seed=0)
    batch = next(iter(loader))
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = build_model("danet", dtype="bfloat16")
    optimizer, schedule = make_optimizer(OptimConfig(), model, total_steps=100)
    state = create_train_state(model, optimizer, schedule, 0, torch.device("cuda"))
    steps = {"bf16": make_train_step(precision=precision_policy("bfloat16")),
             "f32": make_train_step()}
    # (label, step, compute dtype, attention impl)
    paths = {"bf16 kernels": ("bf16", torch.bfloat16, "auto"),
             "f32 kernels": ("f32", None, "auto"),
             "bf16 plain": ("bf16", torch.bfloat16, "xla")}

    def use(label):
        kind, dtype, impl = paths[label]
        model.set_compute_dtype(dtype)
        model.set_attention_impl(impl)
        return steps[kind]

    peak_gb = {}
    for label in paths:
        step = use(label)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        first = step(state, batch).item()
        peak_gb[label] = torch.cuda.max_memory_allocated() / 2**30
        log(f"train step bf16: first step with {label} {time.perf_counter() - t0:.3f} s, "
            f"loss {first:.6f}, peak memory {peak_gb[label]:.2f} GiB")
        step(state, batch)
    times = {label: [] for label in paths}
    losses = []
    before = dict(ca.launches)
    for _ in range(rounds):
        for label in paths:
            step = use(label)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            losses.append(step(state, batch))
            end.record()
            end.synchronize()
            times[label].append(start.elapsed_time(end))
    rise = {k: ca.launches[k] - before[k] for k in before}
    if any(n != 2 * rounds for n in rise.values()):
        raise AssertionError(f"{2 * rounds} kernel-path steps launched {rise}: want "
                             f"one forward launch per kernel per step")
    if not torch.isfinite(torch.stack(losses)).all():
        raise AssertionError(f"non-finite train losses: {torch.stack(losses).tolist()}")
    if any(p.dtype != torch.float32 for p in model.parameters()) or any(
            m.dtype != torch.float32 for s in optimizer.state.values()
            for m in s.values() if torch.is_tensor(m)):
        raise AssertionError("bf16 training left float32 parameters or momentum")
    ms = {label: statistics.median(t) for label, t in times.items()}
    STEP_MS["6e bf16 kernels"] = ms["bf16 kernels"]
    for label in paths:
        log(f"train step bf16: B={batch_size} 512^2 with {label} {ms[label]:.2f} ms "
            f"median of {rounds} (all {', '.join(f'{t:.2f}' for t in times[label])}), "
            f"{batch_size / ms[label] * 1e3:.2f} images/s, peak memory "
            f"{peak_gb[label]:.2f} GiB")
    step = use("bf16 kernels")
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        step(state, batch)
        torch.cuda.synchronize()
    parts = _profile_split(torch, ca, prof, ms["bf16 kernels"],
                           f"one B={batch_size} bf16 step with kernels", "train bf16")
    # aten::_to_copy also carries the batch's copy to the device
    casts = _op_device_ms(prof, ("aten::_to_copy",)) - parts["host-to-device copies"]
    log(f"train bf16 profile:   dtype casts (aten::_to_copy but the batch's copy) "
        f"{casts:.2f} ms, within the parts above")

    model.backbone.remat = True
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        step(state, batch)
        remat_peak = torch.cuda.max_memory_allocated() / 2**30
        remat_ms = []
        for _ in range(3):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            step(state, batch)
            end.record()
            end.synchronize()
            remat_ms.append(start.elapsed_time(end))
    finally:
        model.backbone.remat = False
    log(f"train step bf16: B={batch_size} with model.remat=true "
        f"{statistics.median(remat_ms):.2f} ms median of 3 "
        f"({', '.join(f'{t:.2f}' for t in remat_ms)}), peak memory "
        f"{remat_peak:.2f} GiB (without remat {peak_gb['bf16 kernels']:.2f} GiB)")


#: the bf16 gradient check's own bound, as a share of the float32 max |g|
BF16_GRAD_TOL = 2e-2
#: resumed vs straight final weights on the card, where the backward is
#: not bitwise repeatable (cuDNN's default weight-gradient algorithms and
#: the bilinear upsample's backward add in no fixed order, and bf16
#: magnifies it): max |diff| per tensor within this share of the straight
#: run's own movement from its initial weights, or within this factor of
#: the card's run-to-run spread (the largest max |diff| between any two of
#: three straight runs, one of them run beside the resumed run, so that
#: the spread is measured under the resumed run's conditions too), plus
#: this many float32 ulps of the tensor's largest value (not for the PAM
#: key bias, whose gradient is zero in exact arithmetic); and the whole
#: model's L2 distance within this share of the straight run's L2
#: movement.  A batch skipped or trained twice moves the weights by about a
#: tenth of a 10-step run's movement, and a state not restored by more.
RESUME_MOVE_TOL, RESUME_SPREAD_FACTOR, RESUME_ULPS, RESUME_L2_TOL = 0.5, 4, 4, 1e-3


#: the bf16 CLI fit of 6f: train batch 2, so that the fixture's 11 train
#: objects make 5 steps per epoch and a stop after the first step line
#: lands inside an epoch (at train batch 4 an epoch is 2 steps, and any
#: such stop would land on an epoch's last step, whose batch the resume
#: replays)
FIT_ARGS = ["--fake-data", "train.precision=bfloat16", "data.train_batch=2",
            "data.area_thres=0", "epochs=2", "checkpoint.digest=true",
            "log_every_steps=1", "checkpoint.preempt_check_every=1"]


def _fit_cmd(work: Path, *extra: str) -> list[str]:
    return [sys.executable, "-m", "distributedpytorch_tpu_torch", *FIT_ARGS,
            f"work_dir={work}", *extra]


def _run_record(run: Path) -> dict:
    with open(run / "fit_summary.json") as f:
        summary = json.load(f)
    records = _read_jsonl(run / "metrics.jsonl")
    return {"summary": summary,
            "epochs": [r for r in records if "train/step_losses" in r],
            "vals": [r for r in records if "val/jaccard" in r]}


def resume_check(torch, init: dict, straights: list[dict], resumed: dict,
                 tag: str = "6f", scale_of: dict | None = None
                 ) -> tuple[list[str], list, dict]:
    """Hold a resumed run's final ``state_dict`` to straight runs' (the
    first is the reference; every pair of them measures the run-to-run
    spread) with the ``RESUME_*`` rule above; records the margins under
    ``tag``.  Returns (failures, per-tensor rows, L2 distances)."""
    scale_of = GRAD_SCALE_OF if scale_of is None else scale_of
    ref = straights[0]
    rows, failures = [], []
    sq = {"resumed": 0.0, "moved": 0.0}
    pairs = [(i, j) for i in range(len(straights)) for j in range(i + 1, len(straights))]
    pair_sq = [0.0] * len(pairs)
    for key, want_t in ref.items():
        got_t = resumed[key]
        if not want_t.is_floating_point():
            if not torch.equal(got_t, want_t):
                failures.append(f"{key}: {got_t} != {want_t}")
            continue
        w, g = want_t.double(), got_t.double()
        others = [s[key].double() for s in straights]
        spread = 0.0
        for n, (i, j) in enumerate(pairs):
            d = others[i] - others[j]
            spread = max(spread, d.abs().max().item())
            pair_sq[n] += float((d ** 2).sum())
        sq["resumed"] += float(((g - w) ** 2).sum())
        sq["moved"] += float(((w - init[key].double()) ** 2).sum())
        diff = (g - w).abs().max().item()
        moved = (w - init[key].double()).abs().max().item()
        ulps = RESUME_ULPS * torch.finfo(torch.float32).eps * w.abs().max().item()
        if key in scale_of:
            continue
        rows.append((diff / max(moved, 1e-300), diff, key))
        limit = max(RESUME_MOVE_TOL * moved, RESUME_SPREAD_FACTOR * spread) + ulps
        note_margin(f"{tag} resumed vs straight, per tensor", diff, limit)
        if not diff <= limit:
            failures.append(f"{key}: {diff:.3e} > {limit:.3e} ({RESUME_MOVE_TOL} x "
                            f"its movement {moved:.3e}, {RESUME_SPREAD_FACTOR} x the "
                            f"straight runs' spread {spread:.3e}, + {ulps:.3e})")
    l2 = {k: v ** 0.5 for k, v in sq.items()}
    l2["spread"] = max(pair_sq) ** 0.5
    note_margin(f"{tag} resumed vs straight, L2", l2["resumed"],
                RESUME_L2_TOL * l2["moved"])
    if not l2["resumed"] <= RESUME_L2_TOL * l2["moved"]:
        failures.append(f"L2 distance {l2['resumed']:.3e} > {RESUME_L2_TOL} x the "
                        f"straight run's movement {l2['moved']:.3e}")
    return failures, rows, l2


def phase_train_resume(torch, ca, Predictor,
                       device: str = "cuda") -> tuple[dict, dict]:
    """6f and 6g: the bf16 CLI fit preempted by SIGTERM and resumed with
    ``resume=auto`` against a straight run, the resumed run served, then a
    warm start from its weights.  Returns the kernels' launches of the
    two fits and of the bf16 serving forward."""
    import shutil
    import signal
    import tempfile

    import numpy as np

    from distributedpytorch_tpu_torch.models import build_model
    from distributedpytorch_tpu_torch.train.checkpoint import CheckpointManager
    from distributedpytorch_tpu_torch.train.config import apply_overrides, from_json
    from distributedpytorch_tpu_torch.train.trainer import Trainer

    root = Path(tempfile.mkdtemp(prefix="chip_smoke_resume_"))
    procs = []
    straight_log = open(root / "straight.log", "w+")

    def straight_run(name: str) -> subprocess.Popen:
        proc = subprocess.Popen(_fit_cmd(root / name), cwd=REPO, text=True,
                                stdout=straight_log, stderr=subprocess.STDOUT)
        procs.append(proc)
        return proc

    try:
        work = root / "preempted"
        log(f"train resume: {' '.join(_fit_cmd(work)[1:])}")
        # three straight runs: the reference and the card's run-to-run
        # spread, two alongside the preempted run, one alongside the
        # resumed run
        straights = [straight_run("straight"), straight_run("again")]
        t0 = time.perf_counter()
        first = subprocess.Popen(_fit_cmd(work), cwd=REPO, text=True,
                                 stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        procs.append(first)
        out = []
        for line in first.stdout:
            out.append(line)
            if line.startswith("[step 1] train/loss="):
                first.send_signal(signal.SIGTERM)
                log(f"train resume: SIGTERM after its first step line, "
                    f"{time.perf_counter() - t0:.1f} s after start")
                break
        out.extend(first.stdout)
        if first.wait(timeout=600) != 0:
            raise AssertionError(f"the preempted fit exited {first.returncode}:\n"
                                 f"{''.join(out)[-3000:]}")
        (run_a,) = work.glob("run_*")
        a = _run_record(run_a)
        mgr_a = CheckpointManager(str(run_a / "checkpoints"))
        _, meta_a = mgr_a.load()
        if not a["summary"]["preempted"] or "interrupted_epoch" not in meta_a:
            raise AssertionError(f"preempted fit: summary {a['summary']}, meta {meta_a}")
        log(f"train resume: preempted at step {a['summary']['final_step']}, committed "
            f"{mgr_a.committed_steps()} with interrupted_epoch "
            f"{meta_a['interrupted_epoch']}, epoch_steps_done {meta_a['epoch_steps_done']}")
        straights.append(straight_run("third"))
        proc = subprocess.run(_fit_cmd(work, "resume=auto"), cwd=REPO,
                              capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise AssertionError(f"the resumed fit exited {proc.returncode}:\n"
                                 f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
        if any(p.wait(timeout=600) != 0 for p in straights):
            straight_log.seek(0)
            raise AssertionError(f"a straight fit exited "
                                 f"{[p.returncode for p in straights]}:\n"
                                 f"{straight_log.read()[-3000:]}")
        fit_s = time.perf_counter() - t0
        (run_b,) = set(work.glob("run_*")) - {run_a}
        runs_s = [next((root / n).glob("run_*")) for n in ("straight", "again", "third")]
        run_s = runs_s[0]
        b, s = _run_record(run_b), _run_record(run_s)
        steps_per_epoch = len(s["epochs"][0]["train/step_losses"])
        done = meta_a["epoch_steps_done"]
        resumed_epoch = b["epochs"][0]
        trained = a["summary"]["final_step"] + \
            b["summary"]["final_step"] - b["summary"]["start_step"]
        if b["summary"]["final_step"] != s["summary"]["final_step"] or \
                trained != s["summary"]["final_step"] or \
                b["summary"]["start_step"] != a["summary"]["final_step"] or \
                resumed_epoch.get("train/resumed_at_batch") != done or \
                len(resumed_epoch["train/step_losses"]) != steps_per_epoch - done:
            raise AssertionError(f"resume: straight {s['summary']}, preempted "
                                 f"{a['summary']}, resumed {b['summary']}, first "
                                 f"resumed epoch {resumed_epoch}")
        launches = {k: a["summary"]["kernel_launches"][k] +
                    b["summary"]["kernel_launches"][k] for k in TPU_KERNELS}
        want = s["summary"]["final_step"] + sum(
            int(r["val/n_samples"]) for r in a["vals"] + b["vals"])
        if any(n != want for n in launches.values()):
            raise AssertionError(f"launches over both fits {launches}: want {want} "
                                 "each (train steps + validation samples)")
        log(f"train resume: resumed at epoch {b['summary']['start_epoch']} batch "
            f"{done} of {steps_per_epoch}, final step {b['summary']['final_step']} as "
            f"the straight run's; {trained} steps trained over both runs; launches "
            f"over both {launches}; {fit_s:.1f} s wall for the five fits")

        final = s["summary"]["final_step"]
        straight_ws = [CheckpointManager(str(r / "checkpoints")).load(final)[0]["model"]
                       for r in runs_s]
        resumed_w, meta_b = CheckpointManager(str(run_b / "checkpoints")).load(final)
        cfg = from_json(str(run_b / "config.json"))
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(cfg.seed)
            init = build_model(cfg.model.name, backbone=cfg.model.backbone).state_dict()
        failures, rows, l2 = resume_check(torch, init, straight_ws,
                                          resumed_w["model"])
        equal = sum(1 for _, d, _ in rows if d == 0.0)
        log(f"train resume: final weights, resumed vs straight: {equal} of "
            f"{len(rows)} float tensors bitwise equal; largest max|diff| "
            f"{max(r[1] for r in rows):.3e}; largest max|diff| over the tensor's own "
            f"movement: " + ", ".join(f"{r:.3e} ({k})" for r, _, k in sorted(rows)[-5:])
            + f"; L2 distance {l2['resumed']:.3e} against the straight run's L2 "
            f"movement {l2['moved']:.3e}; the largest L2 distance between two "
            f"straight runs {l2['spread']:.3e}")
        log("train resume: margins (limit / value, smallest over the tensors): " +
            ", ".join(f"{k[len('6f resumed vs straight, '):]} {v:.3g}"
                      for k, v in MARGINS.items() if k.startswith("6f")))
        if failures:
            raise AssertionError("resumed vs straight weights: " + "; ".join(failures[:8]))

        ca.reset_launches()
        pred = Predictor.from_run(str(run_b), step=final, device=device)
        if pred.dtype != torch.bfloat16 or any(
                p.dtype != torch.float32 for p in pred.model.parameters()):
            raise AssertionError(f"Predictor.from_run of the bf16 run: dtype {pred.dtype}")
        model = build_model(cfg.model.name, backbone=cfg.model.backbone,
                            dtype="bfloat16")
        model.load_state_dict(resumed_w["model"], strict=True)
        model.to(device).eval()
        image, clicks = synthetic_image()
        concat, _ = pred.prepare(image, clicks[0])
        x = torch.from_numpy(concat[None]).to(device).permute(0, 3, 1, 2).contiguous()
        with torch.inference_mode():
            served = pred.model(x)
        mask = pred.predict(image, clicks[0])
        serve_launches = dict(ca.launches)
        with torch.inference_mode():
            direct = model(x)
        if not all(o.dtype == torch.bfloat16 for o in served) or \
                not all(torch.equal(p, q) for p, q in zip(served, direct)):
            raise AssertionError("served bf16 logits differ from the checkpoint's model")
        if mask.shape != image.shape[:2] or not np.isfinite(mask).all():
            raise AssertionError(f"bad mask from the resumed run {mask.shape}")
        log(f"train resume: Predictor.from_run(step {final}) serves in bf16 on float32 "
            f"weights, its three bf16 logits bitwise equal to the checkpoint's model; "
            f"kernel launches of its forwards {serve_launches}")
        del pred, model

        # 6g: warm start from the resumed run's weights
        pth = root / "resumed_weights.pth"
        torch.save(resumed_w["model"], pth)
        wcfg = apply_overrides(cfg, [f"checkpoint.warm_start={pth}", "resume=null",
                                     f"work_dir={root / 'warm'}"])
        trainer = Trainer(wcfg, device=device)
        got = trainer.model.state_dict()
        mismatched = [k for k, v in resumed_w["model"].items()
                      if not k.endswith("num_batches_tracked")
                      and not torch.equal(got[k].cpu(), v.cpu())]
        if mismatched or trainer.state.step != 0 or trainer.state.optimizer.state:
            raise AssertionError(f"warm start: mismatched {mismatched[:5]}, step "
                                 f"{trainer.state.step}, optimizer state "
                                 f"{len(trainer.state.optimizer.state)}")
        trainer.close()
        log(f"train warm start: checkpoint.warm_start={pth.name}: "
            f"{len(resumed_w['model'])} tensors bitwise equal (BatchNorm's "
            f"num_batches_tracked aside), step 0, empty optimizer state")
        del trainer
        return launches, serve_launches
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        straight_log.close()
        shutil.rmtree(root, ignore_errors=True)


def environment_line() -> str:
    """CPU affinity, /dev/shm size and free space, host RAM, and whether
    PIL imports and cv2, grain, tensorboard and matplotlib are installed
    (found, not imported)."""
    import importlib.util
    import os
    import platform

    cpus = len(os.sched_getaffinity(0)) if hasattr(os, "sched_getaffinity") \
        else os.cpu_count()
    try:
        st = os.statvfs("/dev/shm")
        shm = (f"/dev/shm {st.f_blocks * st.f_frsize / 2**20:.0f} MiB, "
               f"{st.f_bavail * st.f_frsize / 2**20:.0f} MiB free")
    except OSError:
        shm = "/dev/shm absent"
    ram = os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES") / 2**30
    avail = "?"
    with contextlib.suppress(OSError, ValueError, IndexError):
        with open("/proc/meminfo") as f:
            avail = next(f"{int(line.split()[1]) / 2**20:.1f}" for line in f
                         if line.startswith("MemAvailable"))
    try:
        import PIL
        pil = f"PIL {PIL.__version__} imports"
    except ImportError:
        pil = "PIL does not import"
    found = ", ".join(f"{m} {'installed' if importlib.util.find_spec(m) else 'absent'}"
                      for m in ("cv2", "grain", "tensorboard", "matplotlib"))
    return (f"env: CPU affinity {cpus} (os.cpu_count {os.cpu_count()}), {shm}, "
            f"host RAM {ram:.1f} GiB ({avail} GiB available), {pil}, {found}; "
            f"python {platform.python_version()}")


@contextlib.contextmanager
def numpy_forms():
    """Within the block the host ops take their numpy forms
    (``DPTPU_NATIVE=0``), in this process and in workers started in it."""
    import os

    old = os.environ.get("DPTPU_NATIVE")
    os.environ["DPTPU_NATIVE"] = "0"
    try:
        yield
    finally:
        if old is None:
            del os.environ["DPTPU_NATIVE"]
        else:
            os.environ["DPTPU_NATIVE"] = old


def _best_ms(fn, reps: int) -> float:
    """Median host-clock ms of ``reps`` calls of ``fn`` after one warm-up."""
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def host_image(size: tuple[int, int], seed: int = 0):
    """A float32 RGB image in [0, 255] with smooth structure plus noise."""
    import numpy as np

    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size[0], 0:size[1]].astype(np.float32)
    img = np.stack([127 + 100 * np.sin(xx / 17.0 + c) * np.cos(yy / 23.0 - c)
                    for c in range(3)], -1)
    return np.clip(img + rng.normal(0, 10, img.shape), 0, 255).astype(np.float32)


#: native vs numpy bounds of phase 6h (max |diff| on the [0, 255] scale for
#: images, [0, 1] for the heatmaps; 0 where the op picks pixels)
HOST_OP_TOL = {"resize": 1e-3, "resize_nearest": 0.0, "warp_cubic_uint8": 1.0,
               "warp_nearest": 0.0, "crop_resize": 1e-3, "gaussian_hm": 1e-5,
               "nellipse": 1e-5, "hflip": 0.0}


def phase_host_ops(src: tuple[int, int] = (375, 500),
                   crop: tuple[int, int] = (512, 512), reps: int = 5,
                   tree=None, samples: int = 8) -> dict:
    """6h: each host-library op against its numpy form at the main path's
    shapes (a VOC-sized image, its crop resized to ``crop``): ms of both
    and max |diff| within :data:`HOST_OP_TOL`; then ms per sample of the
    default train stack over ``tree`` (a fake VOC train split at ``src``)
    in one thread, on the library, on the numpy forms, and fused."""
    import numpy as np

    from distributedpytorch_tpu_torch import imaging, native_ops
    from distributedpytorch_tpu_torch.data import guidance
    from distributedpytorch_tpu_torch.utils import helpers

    t0 = time.perf_counter()
    native_ops.load()
    log(f"host ops: library {native_ops.LIBRARY} built or found in "
        f"{time.perf_counter() - t0:.2f} s")
    h, w = src
    img = host_image(src)
    img8 = img.astype(np.uint8)
    mask = np.zeros(src, np.float32)
    mask[h // 5:4 * h // 5, w // 4:3 * w // 4] = 1.0
    window = (-w // 12, h // 12, 3 * w // 5, 9 * h // 10)
    big = host_image((max(crop[0] + 188, h), max(crop[1] + 138, w)), seed=1)
    crop_img = helpers.crop_from_bbox(img, window, zero_pad=True)
    m = imaging.rotation_matrix((w / 2, h / 2), 13.7, 1.1)
    pts = np.array([[crop[1] * 0.1, crop[0] * 0.5], [crop[1] * 0.5, crop[0] * 0.12],
                    [crop[1] * 0.9, crop[0] * 0.45], [crop[1] * 0.55, crop[0] * 0.9]])
    grid = (np.arange(crop[1]), np.arange(crop[0]))
    cases = [  # (name, tolerance key, what, function)
        ("resize", "resize", f"cubic {window[3] - window[1] + 1}x"
         f"{window[2] - window[0] + 1}x3 -> {crop[0]}x{crop[1]}",
         lambda: imaging.resize(crop_img, crop, imaging.CUBIC)),
        ("resize", "resize", f"cubic {big.shape[0]}x{big.shape[1]}x3 -> "
         f"{crop[0]}x{crop[1]}", lambda: imaging.resize(big, crop, imaging.CUBIC)),
        ("resize", "resize_nearest", f"nearest {h}x{w} mask -> {crop[0]}x{crop[1]}",
         lambda: imaging.resize(mask, crop, imaging.NEAREST)),
        ("warp_affine", "warp_cubic_uint8", f"cubic {h}x{w}x3 uint8, 13.7 deg x 1.1",
         lambda: imaging.warp_affine(img8, m, src, imaging.CUBIC, 0)),
        ("warp_affine", "warp_nearest", f"nearest {h}x{w} mask, border 255",
         lambda: imaging.warp_affine(mask, m, src, imaging.NEAREST, 255)),
        ("crop_resize", "crop_resize", f"cubic window {window} of {h}x{w}x3 -> "
         f"{crop[0]}x{crop[1]}", lambda: imaging.crop_resize(img, window, crop,
                                                             imaging.CUBIC)),
        ("gaussian_hm", "gaussian_hm", f"make_gt, 4 points, {crop[0]}x{crop[1]}",
         lambda: helpers.make_gt(np.zeros(crop, np.float32), pts)),
        ("nellipse", "nellipse", f"compute_nellipse, 4 points, {crop[0]}x{crop[1]}",
         lambda: guidance.compute_nellipse(*grid, pts)),
        ("hflip", "hflip", f"{h}x{w}x3 float32", lambda: imaging.flip_h(img)),
    ]
    out = {}
    for op, tol_key, what, fn in cases:
        native_ops.reset_calls()
        got = fn()
        if native_ops.calls[op] < 1:
            raise AssertionError(f"{op} did not run on the host library: "
                                 f"{native_ops.calls}")
        with numpy_forms():
            want = fn()
            ms_np = _best_ms(fn, max(1, reps // 2))
        ms = _best_ms(fn, reps)
        if got.shape != want.shape or got.dtype != want.dtype:
            raise AssertionError(f"{op} ({what}): {got.shape} {got.dtype} vs the "
                                 f"numpy form's {want.shape} {want.dtype}")
        diff = float(np.abs(got.astype(np.float64) - want).max())
        log(f"host op: {op} ({what}): {ms:.3f} ms on the library, {ms_np:.3f} ms "
            f"in the numpy form")
        check(f"6h {tol_key}, library vs numpy form, max |diff|", diff,
              HOST_OP_TOL[tol_key])
        out[f"{op} ({what})"] = {"ms": ms, "numpy_ms": ms_np, "max_abs_diff": diff}

    from distributedpytorch_tpu_torch.data import pipeline

    tree = tree if tree is not None else host_tree(4, src)
    per_sample = {}
    for label, fused, forms in (("on the library", False, contextlib.nullcontext),
                                ("on the numpy forms", False, numpy_forms),
                                ("fused crop + resize, on the library", True,
                                 contextlib.nullcontext)):
        ds = host_dataset(tree, crop, fused=fused)
        n = min(samples, len(ds))
        with forms():
            t0 = time.perf_counter()
            for i in range(n):
                ds.__getitem__(i, rng=pipeline.sample_rng(0, 0, i))
            per_sample[label] = (time.perf_counter() - t0) * 1e3 / n
    log(f"host data: ms per sample of the default train stack at {crop[0]}x{crop[1]} "
        f"from {src[0]}x{src[1]} in one thread: " + ", ".join(
            f"{v:.1f} {k}" for k, v in per_sample.items()))
    out["ms per sample"] = per_sample
    return out


def host_tree(n_images: int, size: tuple[int, int], seed: int = 0):
    """An in-memory fake VOC train split of ``n_images`` at ``size``."""
    from distributedpytorch_tpu_torch.data import fake

    return fake.make_fake_voc(n_images=n_images + 1, size=size, n_val=1, seed=seed)


def host_dataset(tree, crop: tuple[int, int], fused: bool = False,
                 decode_cache: int = 0):
    """The train split of ``tree`` through the default train stack."""
    from distributedpytorch_tpu_torch.data import pipeline, voc

    return voc.VOCInstanceSegmentation(
        tree, split="train", area_thres=0, decode_cache=decode_cache,
        transform=pipeline.build_train_transform(crop_size=crop,
                                                 fused_crop_resize=fused))


def write_tree(tree, root: Path) -> None:
    """``tree`` as a VOC2012 directory: JPEG images, PNG masks (PIL)."""
    from PIL import Image

    voc = root / "VOCdevkit" / "VOC2012"
    dirs = {k: voc / d for k, d in (("image", "JPEGImages"),
                                    ("instances", "SegmentationObject"),
                                    ("classes", "SegmentationClass"),
                                    ("sets", "ImageSets/Segmentation"))}
    for d in dirs.values():
        d.mkdir(parents=True, exist_ok=True)
    ids = tree.split_ids("train")
    (dirs["sets"] / "train.txt").write_text("\n".join(ids))
    for im_id in ids:
        Image.fromarray(tree.image(im_id)).save(dirs["image"] / f"{im_id}.jpg",
                                                quality=90)
        Image.fromarray(tree.instances(im_id)).save(dirs["instances"] / f"{im_id}.png")
        Image.fromarray(tree.classes(im_id)).save(dirs["classes"] / f"{im_id}.png")


class ShmPeak:
    """Samples the used bytes of ``/dev/shm`` every 20 ms in a thread; the
    peak above the level at the start is :attr:`peak` (None without
    ``/dev/shm``)."""

    def __init__(self):
        import os

        self._os = os
        self.peak = None
        self._stop = threading.Event()
        self._base = self._used()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _used(self):
        try:
            st = self._os.statvfs("/dev/shm")
        except OSError:
            return None
        return (st.f_blocks - st.f_bfree) * st.f_frsize

    def _run(self):
        while not self._stop.wait(0.02):
            used = self._used()
            if used is not None and self._base is not None:
                self.peak = max(self.peak or 0, used - self._base)

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()


def no_children(where: str) -> None:
    import multiprocessing

    left = multiprocessing.active_children()
    if left:
        raise AssertionError(f"worker processes left after {where}: {left}")


def loader_ms(loader, n: int) -> tuple[float, float, list]:
    """(ms to the first batch, ms per batch after it, the batches) over the
    first ``n`` batches of ``loader``'s epoch 0."""
    loader.set_epoch(0)
    batches = []
    it = iter(loader)
    t0 = time.perf_counter()
    try:
        for batch in it:
            batches.append(batch)
            if len(batches) == 1:
                t1 = time.perf_counter()
            if len(batches) == n:
                break
    finally:
        it.close()
    t2 = time.perf_counter()
    return (t1 - t0) * 1e3, (t2 - t1) * 1e3 / max(1, len(batches) - 1), batches


def phase_loaders(tree=None, n_images: int = 64,
                  size: tuple[int, int] = (375, 500),
                  crop: tuple[int, int] = (512, 512), batch: int = 16,
                  n_samples: int = 128, workers: tuple[int, ...] = (2, 8),
                  decode_cache: int = 64, numpy_batches: int = 2) -> dict:
    """6i: ms per batch of ``batch`` for the threaded loader on the numpy
    forms and on the host library, the worker loader at each of
    ``workers`` (capped by the CPU affinity), with the fused crop + resize,
    and over an on-disk JPEG/PNG tree with and without the decode cache
    (only where PIL imports); the worker loader's samples against the
    threaded loader's, bit for bit; no worker left after any of them."""
    import importlib.util
    import shutil
    import tempfile

    import numpy as np

    from distributedpytorch_tpu_torch.data import grain_pipeline, pipeline

    t0 = time.perf_counter()
    tree = tree if tree is not None else host_tree(n_images, size)
    dataset = Cycled(host_dataset(tree, crop), n_samples)
    log(f"host data: in-memory fake VOC, {n_images} train images at {size[0]}x"
        f"{size[1]}, {len(dataset.dataset)} objects cycled to {n_samples} samples, "
        f"made in {time.perf_counter() - t0:.1f} s")
    n_batches = n_samples // batch
    results, shm = {}, {}

    def run(label, loader, n=n_batches):
        first, per, got = loader_ms(loader, n)
        results[label] = per
        log(f"host data: {per:.1f} ms per batch of {batch}, {label} "
            f"({len(got)} batches; the first after {first:.1f} ms)")
        no_children(label)
        return got

    with numpy_forms():
        run("threads (2) + numpy forms",
            pipeline.DataLoader(dataset, batch, shuffle=True, drop_last=True,
                                seed=0, num_workers=2), numpy_batches)
    run("threads (2) + host library",
        pipeline.DataLoader(dataset, batch, shuffle=True, drop_last=True, seed=0,
                            num_workers=2), 2 * numpy_batches)
    cap = grain_pipeline.cpu_count()
    counts = sorted({min(n, cap) for n in workers})
    for n in counts:
        loader = grain_pipeline.GrainDataLoader(dataset, batch, shuffle=True,
                                                drop_last=True, seed=0,
                                                num_workers=n)
        with ShmPeak() as peak:
            got = run(f"data.loader=grain, {n} processes + host library", loader)
        shm[n] = peak.peak
    # the worker loader's samples against the threaded loader's sample
    # function, for the same (seed, epoch, index)
    plan = loader.batch_plan()
    checked = 0
    for (_, idxs), b in list(zip(plan, got))[:2]:
        for k, i in enumerate(idxs):
            want = dataset.__getitem__(int(i), rng=pipeline.sample_rng(0, 0, i))
            for key, val in want.items():
                if key != "meta" and not np.array_equal(b[key][k], val):
                    raise AssertionError(f"worker loader sample {i} differs from the "
                                         f"threaded loader's in {key}")
            checked += 1
    log(f"check 6i worker vs threaded samples: {checked} samples of {counts[-1]} "
        f"worker processes bitwise equal to the threaded loader's (exact)")
    fused = Cycled(host_dataset(tree, crop, fused=True), n_samples)
    run(f"data.loader=grain, {counts[-1]} processes, data.fused_crop_resize",
        grain_pipeline.GrainDataLoader(fused, batch, shuffle=True, drop_last=True,
                                       seed=0, num_workers=counts[-1]))
    if importlib.util.find_spec("PIL") is None:
        log("host data: PIL does not import here: the on-disk JPEG/PNG timing "
            "with and without data.decode_cache is skipped")
    else:
        root = Path(tempfile.mkdtemp(prefix="chip_smoke_voc_"))
        try:
            write_tree(tree, root)
            for cache in (0, decode_cache):
                disk = Cycled(host_dataset(str(root), crop, decode_cache=cache),
                              n_samples)
                run(f"data.loader=grain, {counts[-1]} processes, on-disk "
                    f"{size[0]}x{size[1]} JPEG/PNG tree, data.decode_cache={cache}",
                    grain_pipeline.GrainDataLoader(disk, batch, shuffle=True,
                                                   drop_last=True, seed=0,
                                                   num_workers=counts[-1]))
        finally:
            shutil.rmtree(root, ignore_errors=True)
    log("host data: peak /dev/shm use above its level at the start, by worker "
        "count: " + ", ".join(f"{n}: {'not measured' if v is None else f'{v / 2**20:.1f} MiB'}"
                              for n, v in shm.items()))
    log("host data: " + json.dumps({k: round(v, 2) for k, v in results.items()}))
    STEP_MS["6i threads (2) + host library"] = results["threads (2) + host library"]
    return results


#: the worker-fed bf16 CLI fit of 6j, SIGTERMed after its first step line
#: and resumed: the fake fixture's 11 train objects on 2 workers make
#: batches of 2 from slices of 6 and 5, 5 steps an epoch
WORKER_FIT_ARGS = ["--fake-data", "train.precision=bfloat16", "data.train_batch=2",
                   "data.loader=grain", "data.num_workers=2",
                   "data.fused_crop_resize=true", "epochs=2", "data.area_thres=0",
                   "log_every_steps=1", "checkpoint.preempt_check_every=1"]


def group_members(pgid: int) -> list[str]:
    """Live (not zombie) processes of process group ``pgid``, from /proc."""
    import os

    out = []
    for pid in os.listdir("/proc"):
        if not pid.isdigit():
            continue
        try:
            with open(f"/proc/{pid}/stat") as f:
                stat = f.read()
        except OSError:
            continue
        fields = stat[stat.rindex(")") + 2:].split()
        if int(fields[2]) == pgid and fields[0] != "Z":
            out.append(f"{pid} {stat[stat.index('('):stat.rindex(')') + 1]} {fields[0]}")
    return out


def run_in_group(cmd: list[str], timeout: float = 600, on_line=None) -> tuple[int, str]:
    """Run ``cmd`` in a new process group (its own session), stream its
    output to ``on_line(proc, line)``, and fail if any process of the group
    is still alive 10 s after it exits."""
    proc = subprocess.Popen(cmd, cwd=REPO, text=True, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, start_new_session=True)
    out = []
    try:
        for line in proc.stdout:
            out.append(line)
            if on_line is not None:
                on_line(proc, line)
        proc.wait(timeout=timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    deadline = time.perf_counter() + 10
    while (left := group_members(proc.pid)) and time.perf_counter() < deadline:
        time.sleep(0.2)
    if left:
        raise AssertionError(f"processes of {' '.join(cmd[1:4])} ... alive after it "
                             f"exited: {left}")
    return proc.returncode, "".join(out)


def phase_train_workers(torch, ca, dataset, batch_size: int = 16,
                        steps: int = 12, warm: int = 2) -> dict:
    """6j: the bf16 train step at B = 16 fed by the worker loader at the
    affinity-capped count; then the worker-fed bf16 CLI fit SIGTERMed and
    resumed.  Returns the kernels' launches of the two fits."""
    import shutil
    import signal
    import tempfile

    from distributedpytorch_tpu_torch.data import grain_pipeline
    from distributedpytorch_tpu_torch.models import build_model
    from distributedpytorch_tpu_torch.parallel.step import (
        create_train_state,
        make_train_step,
    )
    from distributedpytorch_tpu_torch.train.config import OptimConfig
    from distributedpytorch_tpu_torch.train.optim import make_optimizer
    from distributedpytorch_tpu_torch.train.precision import precision_policy

    workers = grain_pipeline.cpu_count()
    loader = grain_pipeline.GrainDataLoader(dataset, batch_size, shuffle=True,
                                            drop_last=True, seed=0,
                                            num_workers=workers)
    if len(loader) < steps:
        raise AssertionError(f"{len(loader)} batches for {steps} steps")
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = build_model("danet", dtype="bfloat16")
    optimizer, schedule = make_optimizer(OptimConfig(), model, total_steps=100)
    state = create_train_state(model, optimizer, schedule, 0, torch.device("cuda"))
    step = make_train_step(precision=precision_policy("bfloat16"))
    loader.set_epoch(0)
    waits, events, losses = [], [], []
    before = None
    it = iter(loader)
    try:
        for k in range(steps):
            if k == warm:
                torch.cuda.synchronize()
                before = dict(ca.launches)
                t_loop = time.perf_counter()
            t0 = time.perf_counter()
            batch = next(it)
            waits.append((time.perf_counter() - t0) * 1e3)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            losses.append(step(state, batch))
            end.record()
            events.append((start, end))
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t_loop) * 1e3
    finally:
        it.close()
    no_children("the worker-fed bf16 steps")
    timed = steps - warm
    rise = {k: ca.launches[k] - before[k] for k in before}
    if any(n != timed for n in rise.values()):
        raise AssertionError(f"{timed} worker-fed bf16 steps launched {rise}: want one "
                             f"forward launch per kernel per step")
    if not torch.isfinite(torch.stack(losses)).all():
        raise AssertionError(f"non-finite losses: {torch.stack(losses).tolist()}")
    dev = [s.elapsed_time(e) for s, e in events[warm:]]
    gaps = [events[i][1].elapsed_time(events[i + 1][0])
            for i in range(warm, steps - 1)]
    span = events[warm][0].elapsed_time(events[-1][1])
    log(f"train workers: bf16 B={batch_size} 512^2 fed by {workers} worker processes "
        f"(data.loader=grain), {timed} steps after {warm}: {wall / timed:.1f} ms per "
        f"step of the loop, {statistics.median(waits[warm:]):.1f} ms median data wait "
        f"(all {', '.join(f'{w:.1f}' for w in waits[warm:])}), "
        f"{statistics.median(dev):.1f} ms median device step (events around it); "
        f"{batch_size * timed / wall * 1e3:.2f} images/s; the stream idle between "
        f"steps {sum(gaps) / span:.4f} of the steps' span; launches {rise}")
    del model, optimizer, state
    gc.collect()
    torch.cuda.empty_cache()

    root = Path(tempfile.mkdtemp(prefix="chip_smoke_workers_"))
    try:
        cmd = [sys.executable, "-m", "distributedpytorch_tpu_torch", *WORKER_FIT_ARGS,
               f"work_dir={root}"]
        log(f"train workers fit: {' '.join(cmd[1:])}")

        def stop_after_first_step(proc, line):
            if line.startswith("[step 1] train/loss=") and proc.poll() is None:
                proc.send_signal(signal.SIGTERM)
                log("train workers fit: SIGTERM after its first step line")

        t0 = time.perf_counter()
        rc, out = run_in_group(cmd, on_line=stop_after_first_step)
        if rc != 0:
            raise AssertionError(f"the preempted worker-fed fit exited {rc}:\n{out[-3000:]}")
        (run_a,) = root.glob("run_*")
        a = _run_record(run_a)
        if not a["summary"]["preempted"]:
            raise AssertionError(f"the worker-fed fit was not preempted: {a['summary']}")
        rc, out = run_in_group(cmd + ["resume=auto"])
        if rc != 0:
            raise AssertionError(f"the resumed worker-fed fit exited {rc}:\n{out[-3000:]}")
        fit_s = time.perf_counter() - t0
        (run_b,) = set(root.glob("run_*")) - {run_a}
        b = _run_record(run_b)
        # a straight run's steps: the same loader over the same fixture
        from distributedpytorch_tpu_torch.data import fake, voc
        tree = fake.make_fake_voc(n_images=8, size=(96, 128), n_val=3, seed=0)
        per_epoch = len(grain_pipeline.GrainDataLoader(
            voc.VOCInstanceSegmentation(tree, split="train", area_thres=0), 2,
            drop_last=True, num_workers=2))
        straight = 2 * per_epoch
        done = int(b["epochs"][0].get("train/resumed_at_batch", 0))
        trained = a["summary"]["final_step"] + \
            b["summary"]["final_step"] - b["summary"]["start_step"]
        if b["summary"]["final_step"] != straight or trained != straight or \
                b["summary"]["start_step"] != a["summary"]["final_step"] or \
                len(b["epochs"][0]["train/step_losses"]) != per_epoch - done or \
                not all(x is not None and math.isfinite(x)
                        for r in a["epochs"] + b["epochs"]
                        for x in r["train/step_losses"]):
            raise AssertionError(f"worker-fed resume: preempted {a['summary']}, "
                                 f"resumed {b['summary']}, epochs {b['epochs']}")
        launches = {k: a["summary"]["kernel_launches"][k] +
                    b["summary"]["kernel_launches"][k] for k in TPU_KERNELS}
        want = straight + sum(int(r["val/n_samples"]) for r in a["vals"] + b["vals"])
        if any(n != want for n in launches.values()):
            raise AssertionError(f"launches over both worker-fed fits {launches}: "
                                 f"want {want} each")
        for r in b["epochs"]:
            n = len(r["train/step_losses"])
            log(f"train workers fit: resumed epoch {int(r['train/epoch'])}: {n} steps "
                f"of B=2 on 2 worker processes, "
                f"{r['train/data_wait_seconds'] / n * 1e3:.1f} ms waiting on data and "
                f"{r['train/epoch_seconds'] / n * 1e3:.1f} ms per step of the loop")
        log(f"train workers fit: preempted at step {a['summary']['final_step']}, "
            f"resumed at batch {done} of {per_epoch}, final step "
            f"{b['summary']['final_step']} = a straight run's {straight}; {trained} "
            f"steps over both runs; no process of either fit's group left; "
            f"launches {launches}; {fit_s:.1f} s wall for both")
        return launches
    finally:
        shutil.rmtree(root, ignore_errors=True)


def phase_train(torch, ca, Predictor) -> dict:
    """Phase 6 (a-g); returns the launch counts of each training and bf16
    serving path."""
    from distributedpytorch_tpu_torch.data import pipeline

    t0 = time.perf_counter()
    dataset = train_dataset()
    batch = pipeline.collate([dataset.__getitem__(i, rng=pipeline.sample_rng(0, 0, i))
                              for i in range(2)])
    phase_train_grads(torch, ca, Predictor, batch)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"train: (a) done at {time.perf_counter() - t0:.1f} s")
    phase_train_step(torch, ca, dataset)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"train: (b) done at {time.perf_counter() - t0:.1f} s")
    launches = phase_train_fit(torch, ca, Predictor)
    log(f"train: (c) done at {time.perf_counter() - t0:.1f} s")
    phase_train_grads_bf16(torch, ca, Predictor, batch)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"train: (d) done at {time.perf_counter() - t0:.1f} s")
    phase_train_step_bf16(torch, ca, dataset)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"train: (e) done at {time.perf_counter() - t0:.1f} s")
    bf16_fit, bf16_serve = phase_train_resume(torch, ca, Predictor)
    log(f"train: (f, g) done; phase wall time {time.perf_counter() - t0:.1f} s")
    return {"train": launches, "train_bf16": bf16_fit, "serve_bf16": bf16_serve}


def phase_host(torch, ca) -> dict:
    """Phase 6 (h-j): the host library, the loaders, and the bf16 step and
    CLI fit fed by worker processes; returns the launch counts of the
    worker-fed fits."""
    t0 = time.perf_counter()
    tree = host_tree(64, (375, 500))
    phase_host_ops(tree=tree)
    log(f"host: (h) done at {time.perf_counter() - t0:.1f} s")
    phase_loaders(tree)
    log(f"host: (i) done at {time.perf_counter() - t0:.1f} s")
    launches = phase_train_workers(
        torch, ca, Cycled(host_dataset(tree, (512, 512)), 256))
    log(f"host: (j) done; phase wall time {time.perf_counter() - t0:.1f} s")
    return {"train_workers": launches}


#: the dist phase's optimizer (lr large enough that two steps move the
#: weights past their float32 ulps, small enough that the second step's
#: gradients stay near the first's, as 6d's gradients are compared), its
#: global batch and the steps compared and then timed
DIST_LR, DIST_BATCH, DIST_STEPS, DIST_TIMED = 1e-4, 16, 2, 2
#: the 2-rank CLI fit of (c): ResNet-18 at 64^2 on the fake fixture, global
#: batch 4 (2 per rank: 3 steps per epoch over a rank's 6 of the 11
#: objects), float32 on gloo
DIST_FIT_ARGS = ["--dist-backend", "gloo", "--fake-data", "model.backbone=resnet18",
                 "data.crop_size=[64,64]", "data.relax=10", "data.area_thres=0",
                 "data.train_batch=4", "epochs=2", "optim.lr=1e-3",
                 "log_every_steps=1", "checkpoint.preempt_check_every=1"]


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def _rank_env(rank: int, world: int, port: int) -> dict:
    """torchrun's environment for ``rank`` of a one-host group."""
    return {"RANK": str(rank), "WORLD_SIZE": str(world), "LOCAL_RANK": str(rank),
            "LOCAL_WORLD_SIZE": str(world), "MASTER_ADDR": "localhost",
            "MASTER_PORT": str(port)}


def dist_rank(spec: dict) -> None:
    """A rank of (a) or (b): joins the group its torchrun environment
    describes through the launcher's path (``initialize_distributed``),
    then, for each strategy, builds the trainer's data-parallel state
    (DANet-R101 in bf16 on float32 weights, cross-replica BatchNorm, DDP,
    ZeRO-1 under dp_zero1) from the saved weights and runs its rows of the
    global batches: the compared steps, then the timed ones.  Rank 0
    writes the results."""
    import os

    os.environ.update(spec["env"])
    sys.path.insert(0, str(REPO))
    import torch
    import torch.distributed as dist

    from distributedpytorch_tpu_torch.models import build_model
    from distributedpytorch_tpu_torch.ops import cuda_attention as ca
    from distributedpytorch_tpu_torch.parallel import mesh
    from distributedpytorch_tpu_torch.parallel.step import (
        create_train_state,
        make_train_step,
        wrap_data_parallel,
    )
    from distributedpytorch_tpu_torch.parallel.zero import shard_optimizer
    from distributedpytorch_tpu_torch.train.config import OptimConfig
    from distributedpytorch_tpu_torch.train.optim import make_optimizer
    from distributedpytorch_tpu_torch.train.precision import apply_policy

    device = mesh.initialize_distributed(backend=spec["backend"])
    rank, world = mesh.process_index(), mesh.data_axis_size()
    policy = apply_policy("bfloat16")
    init = torch.load(spec["init"])
    batches = torch.load(spec["batches"], weights_only=False)
    per = DIST_BATCH // world
    mine = [{k: v[rank * per:(rank + 1) * per] for k, v in b.items()} for b in batches]
    out = {"world": world, "backend": dist.get_backend(), "device": str(device)}
    for strategy in spec["strategies"]:
        model = build_model("danet", dtype="bfloat16", dropout_rate=0.0,
                            bn_cross_replica=True)
        model.load_state_dict(init)
        opt, sched = make_optimizer(OptimConfig(lr=DIST_LR), model, 100)
        state = create_train_state(model, opt, sched, 0, device)
        if strategy == "dp_zero1":
            state.optimizer = shard_optimizer(opt)
        buckets = 4 if strategy == "reduce_buckets=4" else 0
        wrap_data_parallel(state, buckets)
        step = make_train_step(precision=policy, global_balance=not buckets)
        losses, launches, times = [], [], []
        for i in range(DIST_STEPS + DIST_TIMED):
            ca.reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss = step(state, mine[i % len(mine)]).item()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            launches.append(dict(ca.launches))
            losses.append(loss)
            if i == DIST_STEPS - 1 and rank == 0:
                torch.save({k: v.cpu() for k, v in model.state_dict().items()},
                           Path(spec["out"]) / f"{strategy}.pt")
        out[strategy] = {"losses": losses[:DIST_STEPS], "launches": launches,
                         "ms": times[DIST_STEPS:], "first_ms": times[0]}
        if strategy == spec["strategies"][0]:
            n = sum(p.numel() for p in model.parameters())
            flat = torch.zeros(n, device=device)
            ar = []
            for _ in range(4):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                dist.all_reduce(flat)
                torch.cuda.synchronize()
                ar.append((time.perf_counter() - t0) * 1e3)
            out["allreduce_ms"], out["grad_mib"] = ar[1:], n * 4 / 2**20
            del flat
        del state, model, opt, step
        torch.cuda.empty_cache()
    gathered = [None] * world
    dist.all_gather_object(gathered, out)
    if rank == 0:
        with open(Path(spec["out"]) / "results.json", "w") as f:
            json.dump(gathered, f)
    mesh.destroy_distributed()


def _run_ranks(specs: list[dict], timeout: float = 600) -> None:
    """Spawn one process per spec running :func:`dist_rank`; fail if any
    exits non-zero or outlives ``timeout``."""
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=dist_rank, args=(spec,)) for spec in specs]
    for p in procs:
        p.start()
    deadline = time.perf_counter() + timeout
    try:
        for p in procs:
            p.join(max(1.0, deadline - time.perf_counter()))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    codes = [p.exitcode for p in procs]
    if codes != [0] * len(procs):
        raise AssertionError(f"dist ranks exited {codes}")


def _dist_reference(torch, init: dict, batches: list, precision: str | None,
                    attention_impl: str = "auto"):
    """The single-process step (no group: the plain layers) from ``init``
    on the global batches: losses and the weights after DIST_STEPS."""
    from distributedpytorch_tpu_torch.models import build_model
    from distributedpytorch_tpu_torch.parallel.step import (
        create_train_state,
        make_train_step,
    )
    from distributedpytorch_tpu_torch.train.config import OptimConfig
    from distributedpytorch_tpu_torch.train.optim import make_optimizer
    from distributedpytorch_tpu_torch.train.precision import apply_policy

    policy = apply_policy(precision or "float32")
    model = build_model("danet", dtype=precision or "float32", dropout_rate=0.0,
                        attention_impl=attention_impl)
    model.load_state_dict(init)
    opt, sched = make_optimizer(OptimConfig(lr=DIST_LR), model, 100)
    state = create_train_state(model, opt, sched, 0, torch.device("cuda"))
    step = make_train_step(precision=policy)
    losses = [step(state, batches[i]).item() for i in range(DIST_STEPS)]
    weights = {k: v.cpu() for k, v in model.state_dict().items()}
    del state, model, opt
    gc.collect()
    torch.cuda.empty_cache()
    return losses, weights


def dist_compare(torch, what: str, got: dict, init: dict, refs: dict) -> list[str]:
    """A data-parallel bf16 run's losses and weights after DIST_STEPS
    against the single-process steps ``refs`` (``bf16`` with the kernels,
    ``plain`` bf16 on the plain forms, ``f32``: (losses, weights) each),
    with the bounds of 6d: within BF16_GRAD_TOL of the bf16 step's own
    size (each step's loss; each tensor's update, its max |update|), or
    within a bf16 step's own distance from the float32 step, plus
    RESUME_ULPS float32 ulps of max(1, the weight) (the tests' max(1,
    |leaf|): flax's zero-initialised last BatchNorm scales leave the layers
    before them an update that is zero in exact arithmetic at step 1 and
    second-order at step 2).  The data-parallel run is a bf16 computation
    of its own (its BatchNorm sums in float32 where cuDNN's does not), so
    it is measured against whichever reference is nearest."""
    failures = []
    bf16, f32 = refs["bf16"], refs["f32"]
    for i, g in enumerate(got["losses"]):
        b, f = bf16[0][i], f32[0][i]
        limit = max(BF16_GRAD_TOL * abs(b),
                    *(abs(r[0][i] - f) for r in refs.values()))
        diff = min(abs(g - r[0][i]) for r in refs.values())
        note_margin(f"dist {what}, loss", diff, limit)
        if not diff <= limit:
            failures.append(f"step {i + 1} loss {g:.6f} vs {b:.6f} (limit {limit:.3e})")
    rows = []
    for key, w0 in init.items():
        b, g = bf16[1][key], got["weights"][key]
        if not w0.is_floating_point():
            if not torch.equal(g, b):
                failures.append(f"{key}: {g} != {b}")
            continue
        deltas = {name: r[1][key].double() - w0.double() for name, r in refs.items()}
        dg = g.double() - w0.double()
        scale_key = GRAD_SCALE_OF.get(key, key)
        scale = (bf16[1][scale_key].double() - init[scale_key].double()).abs().max().item()
        own = max((d - deltas["f32"]).abs().max().item() for d in deltas.values())
        diff = min((dg - d).abs().max().item() for d in deltas.values())
        ulps = RESUME_ULPS * torch.finfo(torch.float32).eps * max(
            1.0, b.abs().max().item())
        limit = max(BF16_GRAD_TOL * scale, own) + ulps
        note_margin(f"dist {what}, weights", diff, limit)
        rows.append((diff / limit, key))
        if not diff <= limit:
            failures.append(f"{key}: update differs by {diff:.3e} > {limit:.3e}")
    rows.sort()
    log(f"dist {what}: losses {['%.6f' % x for x in got['losses']]} against the "
        f"single-process bf16 {['%.6f' % x for x in bf16[0]]} (plain forms "
        f"{['%.6f' % x for x in refs['plain'][0]]}, float32 "
        f"{['%.6f' % x for x in f32[0]]}); weights after {DIST_STEPS} steps, "
        f"update difference over its limit: median {rows[len(rows) // 2][0]:.3g}, "
        f"largest " + ", ".join(f"{r:.3g} ({k})" for r, k in rows[-3:]))
    return failures


def phase_dist(torch, dataset) -> dict:
    """(a) world size 1 over NCCL, (b) two ranks over gloo on the one card,
    (c) a 2-rank CLI fit SIGTERMed on rank 1 and resumed.  Returns the
    kernels' launches of the data-parallel steps (rank 0, (a) and (b))."""
    import shutil
    import tempfile

    from distributedpytorch_tpu_torch.data import pipeline
    from distributedpytorch_tpu_torch.models import build_model

    t0 = time.perf_counter()
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_dist_"))
    try:
        loader = pipeline.DataLoader(Cycled(dataset, DIST_STEPS * DIST_BATCH),
                                     DIST_BATCH, shuffle=True, drop_last=True, seed=1)
        batches = list(loader)
        torch.save(batches, root / "batches.pt")
        # the trainer's initial weights (seed 0, flax's initialisers): every
        # weight drawn from a seed as 6a/6d draw them makes a net so
        # ill-conditioned that its bf16 loss is 2% off float32's, and two
        # bf16 computations' updates differ by as much as either is off
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(0)
            init = build_model("danet", dropout_rate=0.0).state_dict()
        torch.save(init, root / "init.pt")
        refs = {"bf16": _dist_reference(torch, init, batches, "bfloat16"),
                "plain": _dist_reference(torch, init, batches, "bfloat16", "xla"),
                "f32": _dist_reference(torch, init, batches, None)}
        log(f"dist: single-process references (B={DIST_BATCH}, lr {DIST_LR}) at "
            f"{time.perf_counter() - t0:.1f} s")
        launches = {k: 0 for k in TPU_KERNELS}
        failures = []
        for label, world, backend, strategies in (
                ("a", 1, "nccl", ["dp_zero1"]),
                ("b", 2, "gloo", ["dp", "dp_zero1", "reduce_buckets=4"])):
            out = root / label
            out.mkdir()
            port = _free_port()
            specs = [{"env": _rank_env(r, world, port), "backend": backend,
                      "strategies": strategies, "init": str(root / "init.pt"),
                      "batches": str(root / "batches.pt"), "out": str(out)}
                     for r in range(world)]
            t1 = time.perf_counter()
            _run_ranks(specs)
            with open(out / "results.json") as f:
                ranks = json.load(f)
            for r, res in enumerate(ranks):
                if res["world"] != world or res["backend"] != backend:
                    raise AssertionError(f"({label}) rank {r}: {res['world']} ranks "
                                         f"over {res['backend']}")
            for strategy in strategies:
                what = f"({label}) W={world} {backend} {strategy}"
                per_rank = [res[strategy] for res in ranks]
                for r, res in enumerate(per_rank):
                    if any(n != {k: 1 for k in TPU_KERNELS} for n in res["launches"]):
                        raise AssertionError(f"{what}: rank {r} launches per step "
                                             f"{res['launches']} (want 1 per kernel)")
                for k in TPU_KERNELS:
                    launches[k] += sum(n[k] for n in per_rank[0]["launches"])
                got = {"losses": per_rank[0]["losses"],
                       "weights": torch.load(out / f"{strategy}.pt")}
                failures += dist_compare(torch, what, got, init, refs)
                ms = statistics.median(per_rank[0]["ms"])
                line = (f"dist {what}: {ms:.2f} ms per step of {DIST_BATCH} "
                        f"({DIST_BATCH // world} per rank; median of {DIST_TIMED}: "
                        f"{', '.join('%.2f' % t for t in per_rank[0]['ms'])}; first "
                        f"step {per_rank[0]['first_ms']:.1f} ms), "
                        f"{DIST_BATCH / ms * 1e3:.2f} images/s")
                if label == "a":
                    line += (f"; the single-process bf16 step of 6e "
                             f"{STEP_MS.get('6e bf16 kernels', float('nan')):.2f} ms")
                else:
                    ar = statistics.median(ranks[0]["allreduce_ms"])
                    line += (f"; an all_reduce of the {ranks[0]['grad_mib']:.1f} MiB "
                             f"of gradients alone {ar:.2f} ms ({ar / ms:.3f} of the step)")
                log(line)
            log(f"dist ({label}): {time.perf_counter() - t1:.1f} s")
        if failures:
            raise AssertionError("dist vs single-process: " + "; ".join(failures[:8]))
        phase_dist_fit(torch, root)
        log(f"dist: phase wall time {time.perf_counter() - t0:.1f} s")
        return launches
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _start_fit(work: Path, port: int, *extra: str, stdout=None) -> list:
    """The two ranks of a CLI fit, each in a new process group of its own,
    torchrun's environment set; rank 0's output to ``stdout`` if given."""
    import os

    procs = []
    for r in range(2):
        cmd = [sys.executable, "-m", "distributedpytorch_tpu_torch", *DIST_FIT_ARGS,
               f"work_dir={work}", *extra]
        to = stdout if r == 0 and stdout is not None else subprocess.DEVNULL
        procs.append(subprocess.Popen(
            cmd, cwd=REPO, text=True, env={**os.environ, **_rank_env(r, 2, port)},
            stdout=to, stderr=subprocess.STDOUT if to is not subprocess.DEVNULL
            else subprocess.DEVNULL, start_new_session=True))
    return procs


def _finish_fit(procs: list, what: str, timeout: float = 600) -> None:
    """Wait for both ranks: exit 0 each, and no process of either rank's
    group alive 10 s later."""
    codes = [p.wait(timeout=timeout) for p in procs]
    if codes != [0, 0]:
        raise AssertionError(f"{what}: ranks exited {codes}")
    deadline = time.perf_counter() + 10
    while (left := [m for p in procs for m in group_members(p.pid)]) and \
            time.perf_counter() < deadline:
        time.sleep(0.2)
    if left:
        raise AssertionError(f"{what}: processes of its groups alive after it "
                             f"exited: {left}")


def phase_dist_fit(torch, root: Path) -> None:
    """(c): a 2-rank CLI fit (gloo, one card) whose rank 1 alone gets
    SIGTERM after rank 0's first step line: both ranks stop at one step and
    save once; ``resume=auto`` continues it to the straight 2-rank run's
    final step, its weights held to three straight runs with 6f's rule;
    no process of any fit's group is left."""
    import signal

    from distributedpytorch_tpu_torch.models import build_model
    from distributedpytorch_tpu_torch.train.checkpoint import CheckpointManager

    t0 = time.perf_counter()
    groups = []
    try:
        straights = [_start_fit(root / f"straight{i}", _free_port()) for i in (0, 1)]
        groups += straights
        work = root / "preempted"
        first = _start_fit(work, _free_port(), stdout=subprocess.PIPE)
        groups.append(first)
        out = []
        for line in first[0].stdout:
            out.append(line)
            if line.startswith("[step 1] train/loss="):
                first[1].send_signal(signal.SIGTERM)
                log(f"dist (c): SIGTERM to rank 1 alone after rank 0's first step "
                    f"line, {time.perf_counter() - t0:.1f} s after start")
                break
        out.extend(first[0].stdout)
        try:
            _finish_fit(first, "the preempted 2-rank fit")
        except AssertionError as e:
            raise AssertionError(f"{e}\n{''.join(out)[-3000:]}") from None
        (run_a,) = work.glob("run_*")
        a = _run_record(run_a)
        _, meta_a = CheckpointManager(str(run_a / "checkpoints")).load()
        stop = a["summary"]["final_step"]
        if not a["summary"]["preempted"] or \
                a["summary"]["final_step_by_rank"] != [stop, stop] or \
                meta_a.get("num_shards") != 2 or meta_a["step"] != stop:
            raise AssertionError(f"preempted 2-rank fit: summary {a['summary']}, "
                                 f"meta {meta_a}")
        log(f"dist (c): both ranks stopped at step {stop} "
            f"(final_step_by_rank {a['summary']['final_step_by_rank']}), one save "
            f"with num_shards {meta_a['num_shards']}, epoch_steps_done "
            f"{meta_a['epoch_steps_done']}")
        third = _start_fit(root / "straight2", _free_port())
        groups.append(third)
        resumed = _start_fit(work, _free_port(), "resume=auto")
        groups.append(resumed)
        for procs, what in ((resumed, "the resumed 2-rank fit"),
                            (straights[0], "straight 0"), (straights[1], "straight 1"),
                            (third, "straight 2")):
            _finish_fit(procs, what)
        (run_b,) = set(work.glob("run_*")) - {run_a}
        b = _run_record(run_b)
        runs_s = [next((root / f"straight{i}").glob("run_*")) for i in range(3)]
        s = _run_record(runs_s[0])
        final = s["summary"]["final_step"]
        trained = stop + b["summary"]["final_step"] - b["summary"]["start_step"]
        if b["summary"]["final_step"] != final or trained != final or \
                b["summary"]["final_step_by_rank"] != [final, final] or \
                b["epochs"][0].get("train/resumed_at_batch") != meta_a["epoch_steps_done"]:
            raise AssertionError(f"2-rank resume: straight {s['summary']}, resumed "
                                 f"{b['summary']}, first epoch {b['epochs'][0]}")
        straight_ws = [CheckpointManager(str(r / "checkpoints")).load(final)[0]["model"]
                       for r in runs_s]
        resumed_w = CheckpointManager(str(run_b / "checkpoints")).load(final)[0]["model"]
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(0)
            init = build_model("danet", backbone="resnet18").state_dict()
        failures, rows, l2 = resume_check(torch, init, straight_ws, resumed_w,
                                          tag="dist (c)")
        log(f"dist (c): resumed at batch {meta_a['epoch_steps_done']} to step "
            f"{final} as the straight runs; final weights {sum(d == 0 for _, d, _ in rows)}"
            f" of {len(rows)} float tensors bitwise equal, largest max|diff| "
            f"{max(r[1] for r in rows):.3e}, L2 distance {l2['resumed']:.3e} against an "
            f"L2 movement of {l2['moved']:.3e} (straight runs' largest L2 spread "
            f"{l2['spread']:.3e}); margins " + ", ".join(
                f"{k[len('dist (c) resumed vs straight, '):]} {v:.3g}"
                for k, v in MARGINS.items() if k.startswith("dist (c)"))
            + f"; no process of the 5 fits' groups left; {time.perf_counter() - t0:.1f} s")
        if failures:
            raise AssertionError("2-rank resumed vs straight: " + "; ".join(failures[:8]))
    finally:
        for procs in groups:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()


#: the profiler's names for the semantic step's loss and resizes
SEM_LOSS = ("aten::logsumexp", "aten::gather",
            "autograd::engine::evaluate_function: LogsumexpBackward0",
            "autograd::engine::evaluate_function: GatherBackward0")
SEM_RESIZE = ("aten::upsample_bilinear2d", "aten::upsample_bilinear2d_backward")
#: the semantic path: BASELINE config 4's shape
SEM_SIZE, SEM_CLASSES = 513, 21


def randomize_segmenter(torch, model, seed: int = 0):
    """Every parameter and BatchNorm statistic of a DeepLab/FCN model drawn
    from ``seed`` (the last-BN scales included, which flax zero-inits), at
    scales that keep a 101-layer net finite; the classifiers' weights 100x
    wider, for logits of order 10."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, module in model.named_modules():
            if isinstance(module, torch.nn.Conv2d):
                fan_in = module.weight[0].numel()
                gain = 100.0 if name.endswith(("classifier", "Conv_1")) \
                    and module.weight.shape[2] == 1 else 2.0
                module.weight.normal_(0.0, (gain / fan_in) ** 0.5, generator=gen)
                if module.bias is not None:
                    module.bias.normal_(0.0, 0.1, generator=gen)
            elif isinstance(module, torch.nn.BatchNorm2d):
                module.weight.uniform_(0.2, 0.6, generator=gen)
                module.bias.normal_(0.0, 0.1, generator=gen)
                module.running_mean.normal_(0.0, 0.1, generator=gen)
                module.running_var.uniform_(0.5, 2.0, generator=gen)
    return model


def _semantic_image(seed: int, size: int = SEM_SIZE):
    import numpy as np

    return np.random.default_rng(seed).uniform(
        0, 255, (1, size, size, 3)).astype(np.float32)


def semantic_forward(torch) -> None:
    """9a: the three families' eval forward on the card against the CPU."""
    from distributedpytorch_tpu_torch.models import build_model

    x = torch.from_numpy(_semantic_image(1)).permute(0, 3, 1, 2).contiguous()
    for name in ("deeplabv3", "deeplabv3plus", "fcn"):
        model = randomize_segmenter(torch, build_model(
            name, nclass=SEM_CLASSES, backbone="resnet101", aux_head=True,
            in_channels=3)).eval()
        t0 = time.perf_counter()
        with torch.inference_mode():
            want = model(x)
        cpu_s = time.perf_counter() - t0
        model.to("cuda")
        with torch.inference_mode():
            got = model(x.to("cuda"))
        torch.cuda.synchronize()
        if [tuple(g.shape) for g in got] != [(1, SEM_CLASSES, SEM_SIZE, SEM_SIZE)] * 2:
            raise AssertionError(f"{name}: output shapes {[g.shape for g in got]}")
        for label, g, w in zip(("primary", "aux"), got, want):
            g = g.float().cpu()
            if not torch.isfinite(g).all():
                raise AssertionError(f"{name} {label}: non-finite logits")
            scale = max(1.0, w.abs().max().item())
            check(f"semantic (a) {name} {label}, card vs CPU float32, max|diff|",
                  (g - w).abs().max().item(), 1e-3 * scale)
        log(f"semantic (a): {name}-R101 {SEM_SIZE}^2 OS {model.output_stride}, "
            f"{SEM_CLASSES} classes, aux on, B=1, max|logit| "
            f"{want[0].abs().max().item():.3f}; CPU forward {cpu_s:.1f} s")
        del model, got
        torch.cuda.empty_cache()


def _semantic_grads(torch, model, saved, batch, dtype, device="cuda"):
    """One forward and backward of ``model`` (weights ``saved``) in
    ``dtype`` on ``device`` on ``batch``: (loss, the outputs, the batch on
    the device, every parameter's gradient in float64 on the card)."""
    from distributedpytorch_tpu_torch.parallel.step import _compute_loss, device_batch

    model.to(device=device, dtype=dtype).load_state_dict(saved)
    model.zero_grad(set_to_none=True)
    data = {k: v.to(dtype) for k, v in
            device_batch(batch, torch.device(device)).items()}
    outputs = model(data["concat"])
    loss = _compute_loss(outputs, data, (1.0, 0.4), loss_type="multi_softmax")
    loss.backward()
    grads = {n: p.grad.detach().to("cuda", torch.float64)
             for n, p in model.named_parameters()}
    return loss.item(), [o.detach() for o in outputs], data, grads


def semantic_step_checks(torch) -> None:
    """9b: a DeepLabV3-R101 step's loss and gradients on the card."""
    import numpy as np

    from distributedpytorch_tpu_torch.models import build_model
    from distributedpytorch_tpu_torch.ops.losses import softmax_xent_ignore

    rng = np.random.default_rng(2)
    labels = rng.integers(0, SEM_CLASSES, (2, SEM_SIZE, SEM_SIZE, 1)).astype(np.float32)
    labels[:, :24] = labels[:, -24:] = 255.0  # a void border
    labels[:, :, :24] = labels[:, :, -24:] = 255.0
    batch = {"concat": np.concatenate([_semantic_image(3), _semantic_image(4)]),
             "crop_gt": labels}
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)  # the trainer's initial weights
        model = build_model("deeplabv3", nclass=SEM_CLASSES, backbone="resnet101",
                            aux_head=True, in_channels=3, dropout_rate=0.0)
    model.train()
    saved = {k: v.clone() for k, v in model.state_dict().items()}
    torch.backends.cudnn.deterministic = True
    try:
        loss32, outputs, data, g32 = _semantic_grads(torch, model, saved, batch,
                                                     torch.float32)
        labels_cpu = data["crop_gt"][:, 0].cpu()
        cpu_loss = sum(w * softmax_xent_ignore(o.cpu(), labels_cpu)
                       for w, o in zip((1.0, 0.4), outputs)).item()
        check("semantic (b) loss, card vs CPU on the card's logits, relative",
              abs(loss32 - cpu_loss) / abs(cpu_loss), 1e-5)
        del outputs, data
        loss64, _, _, g64 = _semantic_grads(torch, model, saved, batch, torch.float64)
        t0 = time.perf_counter()
        loss_cpu, _, _, gcpu = _semantic_grads(torch, model, saved, batch,
                                               torch.float32, device="cpu")
        cpu_s = time.perf_counter() - t0
    finally:
        torch.backends.cudnn.deterministic = False
    # float32 arithmetic itself is off float64 by more than 1e-3 of some
    # tensors' max|g| here (cancelling sums over 2 x 257^2 positions, and
    # the image-pool BatchNorm over two values, whose input gradient is
    # rounding over the batch's spread); the CPU's float32 step, another
    # implementation, measures that distance
    ratios, failures, by_cpu = [], [], []
    for name, want in g64.items():
        scale = want.abs().max().item()
        diff = (g32[name] - want).abs().max().item()
        cpu_off = (gcpu[name] - want).abs().max().item()
        limit = max(1e-3 * scale, 4.0 * cpu_off)
        note_margin("semantic (b) gradients, card float32 vs float64 per tensor",
                    diff, limit)
        ratios.append((diff / scale if scale else 0.0, name))
        if not diff <= limit:
            failures.append(f"{name}: {diff:.3e} > 1e-3 x {scale:.3e} and > 4 x "
                            f"the CPU float32 step's distance {cpu_off:.3e}")
        elif diff > 1e-3 * scale:
            by_cpu.append((diff / cpu_off, diff / scale, name))
    ratios.sort()
    by_cpu.sort()
    log(f"semantic (b): DeepLabV3-R101 {SEM_SIZE}^2 B=2, the trainer's initial "
        f"weights, dropout off, void border 24 px; loss card float32 {loss32:.9f}, "
        f"float64 {loss64:.9f}, CPU float32 {loss_cpu:.9f} ({cpu_s:.1f} s); "
        f"{len(ratios)} parameter tensors, card float32 vs float64 max|diff| / "
        f"max|g|: median {ratios[len(ratios) // 2][0]:.3e}, largest "
        f"{ratios[-1][0]:.3e} ({ratios[-1][1]}); {len(by_cpu)} above 1e-3 and "
        f"within 4x the CPU float32 step's distance from float64, the largest at "
        f"{max((r[0] for r in by_cpu), default=0.0):.3f}x it")
    for of_cpu, ratio, name in by_cpu[-4:]:
        log(f"semantic (b):   {name}: {ratio:.3e} of max|g|, {of_cpu:.3f}x the "
            f"CPU float32 distance")
    if failures:
        raise AssertionError("semantic (b) gradients, float32 vs float64: "
                             + "; ".join(failures[:8]))
    del g32, g64, gcpu

    void = dict(batch, crop_gt=np.full_like(labels, 255.0))
    loss, _, _, grads = _semantic_grads(torch, model, saved, void, torch.float32)
    gmax = max(g.abs().max().item() for g in grads.values())
    log(f"semantic (b): all-void batch, loss {loss!r}, largest |g| {gmax!r}")
    if loss != 0.0 or gmax != 0.0:
        raise AssertionError(f"all-void batch: loss {loss}, max |g| {gmax}")
    del model, grads
    torch.cuda.empty_cache()


def semantic_step_timed(torch, batch_size: int = 8, rounds: int = 5) -> None:
    """9c: BASELINE config 4's train step, bf16 and float32, timed in turns."""
    import numpy as np

    from distributedpytorch_tpu_torch.models import build_model
    from distributedpytorch_tpu_torch.parallel.step import (
        create_train_state,
        make_train_step,
    )
    from distributedpytorch_tpu_torch.train.config import OptimConfig
    from distributedpytorch_tpu_torch.train.optim import make_optimizer
    from distributedpytorch_tpu_torch.train.precision import precision_policy

    rng = np.random.default_rng(5)
    labels = rng.integers(0, SEM_CLASSES, (batch_size, SEM_SIZE, SEM_SIZE, 1))
    labels[rng.random(labels.shape) < 0.05] = 255
    batch = {"concat": rng.uniform(0, 255, (batch_size, SEM_SIZE, SEM_SIZE, 3)
                                   ).astype(np.float32),
             "crop_gt": labels.astype(np.float32)}
    paths = {}
    for label, precision in (("bf16", "bfloat16"), ("f32", None)):
        policy = precision_policy(precision) if precision else None
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(0)
            model = build_model("deeplabv3", nclass=SEM_CLASSES,
                                backbone="resnet101", aux_head=True,
                                in_channels=3, dtype=precision or "float32")
        optimizer, schedule = make_optimizer(OptimConfig(lr=1e-4), model, 100)
        state = create_train_state(model, optimizer, schedule, 0,
                                   torch.device("cuda"))
        paths[label] = (state, make_train_step(
            loss_weights=(1.0, 0.4), precision=policy, loss_type="multi_softmax"))
    peak_gb = {}
    for label, (state, step) in paths.items():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        first = step(state, batch).item()
        step(state, batch)
        torch.cuda.synchronize()
        peak_gb[label] = torch.cuda.max_memory_allocated() / 2**30
        log(f"semantic (c): first two {label} steps {time.perf_counter() - t0:.3f} s, "
            f"loss {first:.6f}, peak memory {peak_gb[label]:.2f} GiB")
    times = {label: [] for label in paths}
    losses = []
    for _ in range(rounds):
        for label, (state, step) in paths.items():
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            losses.append(step(state, batch))
            end.record()
            end.synchronize()
            times[label].append(start.elapsed_time(end))
    if not torch.isfinite(torch.stack(losses)).all():
        raise AssertionError(f"non-finite semantic train losses: "
                             f"{torch.stack(losses).tolist()}")
    ms = {label: statistics.median(t) for label, t in times.items()}
    for label in paths:
        STEP_MS[f"semantic {label}"] = ms[label]
        log(f"semantic (c): config 4, DeepLabV3-R101 {SEM_SIZE}^2 OS 16 B={batch_size} "
            f"{SEM_CLASSES} classes aux on, {label}: {ms[label]:.2f} ms median of "
            f"{rounds} (all {', '.join(f'{t:.2f}' for t in times[label])}), "
            f"{batch_size / ms[label] * 1e3:.2f} images/s, peak memory "
            f"{peak_gb[label]:.2f} GiB")
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for label, (state, step) in paths.items():
        with torch.profiler.profile(activities=acts) as prof:
            step(state, batch)
            torch.cuda.synchronize()
        kernels = _device_events(prof)
        busy = sum(e.device_time_total for e in kernels) / 1e3
        parts = {"convolutions, forward and backward":
                 _op_device_ms(prof, CONV_FORWARD + CONV_BACKWARD),
                 "batch norm, forward and backward": _op_device_ms(prof, BATCH_NORM),
                 "loss (logsumexp, gather), forward and backward":
                 _op_device_ms(prof, SEM_LOSS),
                 "bilinear resize, forward and backward": _op_device_ms(prof, SEM_RESIZE)}
        log(f"semantic (c) profile: {label} B={batch_size}, device busy {busy:.2f} ms "
            f"over {len(kernels)} kernels and copies; idle share "
            f"{1.0 - busy / ms[label]:.4f} of the {ms[label]:.2f} ms median step")
        for what, t in parts.items():
            log(f"semantic (c) profile:   {t:9.2f} ms  {what}")
        log(f"semantic (c) profile:   {busy - sum(parts.values()):9.2f} ms  the rest")
    del paths
    torch.cuda.empty_cache()


SEM_FIT_ARGS = ["--fake-data", "task=semantic", "model.name=deeplabv3",
                "model.nclass=21", "model.in_channels=3", "model.aux_head=true",
                "model.loss_weights=[1.0,0.4]", "data.crop_size=[513,513]",
                "train.precision=bfloat16", "data.train_batch=4", "data.val_batch=2",
                "eval_full_res=true", "eval_tta_scales=[0.75,1.0,1.25]",
                "eval_tta_flip=true", "epochs=2"]


def semantic_fit(torch) -> None:
    """9d: the semantic fit (a ``Trainer`` in this process), then its run
    served, through ``--predict`` too."""
    import shutil
    import tempfile

    import numpy as np

    from distributedpytorch_tpu_torch import imaging
    from distributedpytorch_tpu_torch.parallel.step import TrainState, make_eval_step
    from distributedpytorch_tpu_torch.predict import (
        SemanticPredictor,
        load_run_config,
        load_run_model,
    )
    from distributedpytorch_tpu_torch.train.precision import precision_policy

    work = Path(tempfile.mkdtemp(prefix="chip_smoke_semantic_"))
    try:
        log(f"semantic (d): {' '.join(SEM_FIT_ARGS)}")
        t0 = time.perf_counter()
        run = _in_process_fit(torch, _trainer_args(SEM_FIT_ARGS)
                              + [f"work_dir={work}"])
        fit_s = time.perf_counter() - t0
        with open(run / "fit_summary.json") as f:
            summary = json.load(f)
        records = _read_jsonl(run / "metrics.jsonl")
        step_losses = [x for r in records for x in r.get("train/step_losses", [])]
        vals = [r for r in records if "val/miou" in r]
        final = summary["final_step"]
        if final < 2 or len(step_losses) != final or \
                not all(x is not None and math.isfinite(x) for x in step_losses):
            raise AssertionError(f"semantic fit: {final} steps, losses {step_losses}")
        for r in vals:
            if not (0.0 <= r["val/miou"] <= 1.0 and 0.0 <= r["val/pixel_acc"] <= 1.0
                    and len(r["val/per_class_iou"]) == SEM_CLASSES
                    and r["val/jaccard"] == r["val/miou"]):
                raise AssertionError(f"semantic validation record {r}")
        if len(vals) != 2:
            raise AssertionError(f"semantic fit validations: {vals}")
        with open(run / "checkpoints" / "COMMITTED.json") as f:
            ledger = json.load(f)
        if final not in ledger["latest"]:
            raise AssertionError(f"COMMITTED.json {ledger} does not name step {final}")
        if any(summary["kernel_launches"].values()):
            raise AssertionError(f"semantic fit launches {summary['kernel_launches']}")
        log(f"semantic (d): {fit_s:.1f} s wall, {final} steps, losses "
            f"{[round(x, 6) for x in step_losses]}; val mIoU "
            f"{[round(r['val/miou'], 6) for r in vals]}, pixel accuracy "
            f"{[round(r['val/pixel_acc'], 6) for r in vals]} over "
            f"{[int(r['val/n_samples']) for r in vals]} images (full-res, TTA 3 "
            f"scales x flip); COMMITTED.json {ledger}; kernel launches "
            f"{summary['kernel_launches']}")

        pred = SemanticPredictor.from_run(str(run), device="cuda")
        cfg = load_run_config(str(run))
        model, _ = load_run_model(str(run), cfg)
        state = TrainState(model.to("cuda"), None, None, None)
        eval_step = make_eval_step(loss_weights=cfg.model.loss_weights,
                                   precision=precision_policy(cfg.train.precision),
                                   loss_type="multi_softmax")
        image = np.random.default_rng(6).uniform(0, 255, (375, 500, 3))
        resized = imaging.resize(np.clip(image.astype(np.float32), 0, 255),
                                 (SEM_SIZE, SEM_SIZE), imaging.CUBIC)
        outputs, _ = eval_step(state, {
            "concat": resized[None],
            "crop_gt": np.zeros((1, SEM_SIZE, SEM_SIZE, 1), np.float32)})
        want = imaging.resize(outputs[0].argmax(dim=1)[0].cpu().numpy().astype(
            np.float32), image.shape[:2], imaging.NEAREST).astype(np.uint8)
        got = pred.predict(image, mode="resize")
        if got.dtype != np.uint8 or not np.array_equal(got, want):
            raise AssertionError(f"SemanticPredictor resize: {got.dtype}, "
                                 f"{int((got != want).sum())} pixels differ from "
                                 "the trainer's eval forward")
        t0 = time.perf_counter()
        slid = pred.predict(image, mode="slide")
        slide_s = time.perf_counter() - t0
        if slid.shape != image.shape[:2] or slid.max() >= SEM_CLASSES:
            raise AssertionError(f"slide: {slid.shape}, max class {slid.max()}")
        from PIL import Image

        Image.fromarray(image.astype(np.uint8)).save(work / "image.png")
        out = work / "classes.png"
        proc = subprocess.run(
            [sys.executable, "-m", "distributedpytorch_tpu_torch", "--predict",
             str(work / "image.png"), "--run-dir", str(run), "--out", str(out)],
            cwd=REPO, capture_output=True, text=True, timeout=300)
        if proc.returncode != 0 or not out.exists():
            raise AssertionError(f"--predict exited {proc.returncode}:\n"
                                 f"{proc.stdout[-2000:]}\n{proc.stderr[-2000:]}")
        with Image.open(out) as im:
            png = np.asarray(im)
        if png.shape != image.shape[:2]:
            raise AssertionError(f"--predict wrote a {png.shape} PNG")
        log(f"semantic (d): SemanticPredictor.from_run resize == the trainer's "
            f"bf16 eval forward's argmax, bit for bit ({got.size} pixels, classes "
            f"{sorted(set(np.unique(got).tolist()))}); slide {slide_s:.2f} s for "
            f"375x500; --predict wrote a {png.shape} PNG: "
            f"{proc.stdout.strip().splitlines()[-1][:160]}")
    finally:
        shutil.rmtree(work, ignore_errors=True)


def semantic_fullres(torch) -> None:
    """9e: ``fullres_argmax`` on the card against the host protocol."""
    import numpy as np

    from distributedpytorch_tpu_torch import imaging
    from distributedpytorch_tpu_torch.ops.warp import fullres_argmax
    from distributedpytorch_tpu_torch.utils.helpers import fixed_resize

    gen = torch.Generator(device="cuda").manual_seed(7)
    logits = torch.randn(2, SEM_CLASSES, SEM_SIZE, SEM_SIZE, generator=gen,
                         device="cuda") * 4
    probs = torch.softmax(logits, dim=1)
    sizes = np.array([[375, 500], [500, 333]], np.int64)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    maps = fullres_argmax(probs, torch.from_numpy(sizes), (500, 500)).cpu().numpy()
    dev_ms = (time.perf_counter() - t0) * 1e3
    host = probs.permute(0, 2, 3, 1).cpu().numpy()
    agree, total = 0, 0
    t0 = time.perf_counter()
    for j, (h, w) in enumerate(sizes):
        want = np.argmax(fixed_resize(host[j], (int(h), int(w)),
                                      flagval=imaging.LINEAR), axis=-1)
        agree += int((maps[j, :h, :w] == want).sum())
        total += int(h * w)
    host_ms = (time.perf_counter() - t0) * 1e3
    share = agree / total
    note_margin("semantic (e) full-res agreement, disagreeing share",
                1.0 - share, 1e-3)
    log(f"check semantic (e) fullres_argmax vs the host protocol: {share:.6f} of "
        f"{total} pixels agree >= 0.999 (the card {dev_ms:.1f} ms with readback, "
        f"the host {host_ms:.1f} ms)")
    if share < 0.999:
        raise AssertionError(f"full-res agreement {share:.6f} < 0.999")


def phase_semantic(torch, ca) -> None:
    """Phase 9: the semantic task and the DeepLab family (9a-9e); no
    attention kernel lies on this path, so their counters must not move."""
    ca.reset_launches()
    t0 = time.perf_counter()
    semantic_forward(torch)
    semantic_step_checks(torch)
    semantic_step_timed(torch)
    if any(ca.launches.values()):  # before 9d's Trainer zeroes the counters
        raise AssertionError(f"attention kernels launched on the semantic path: "
                             f"{dict(ca.launches)}")
    semantic_fit(torch)
    semantic_fullres(torch)
    if any(ca.launches.values()):
        raise AssertionError(f"attention kernels launched on the semantic path: "
                             f"{dict(ca.launches)}")
    log(f"semantic: no attention kernel launched; phase {time.perf_counter() - t0:.1f} s")


#: the trainer phase's fit: DANet-R101 at 512^2 in bf16 on the fake
#: fixture, train batch 2 (5 steps per epoch over its 11 train objects),
#: each epoch validated over its 16 val objects
TRAINER_ARGS = ["data.fake=true", "train.precision=bfloat16", "data.train_batch=2",
                "data.area_thres=0", "log_every_steps=1", 'log_writers=["jsonl"]',
                "checkpoint.keep_latest=1"]
#: 10c's fit: train batch 4 (2 steps per epoch), two epochs, each
#: validated on the thread beside the next, epoch 1 traced
TRAINER_FIT_ARGS = ["--fake-data", "train.precision=bfloat16", "data.train_batch=4",
                    "data.area_thres=0", "epochs=2", "val_overlap=true",
                    "profile_epoch=1", 'log_writers=["console","jsonl","tensorboard"]']
#: 10e's model: DANet-R101 at 512^2, every weight drawn from seed 0
KNOB_MODEL = (512, "resnet101")
#: the overlapped validation against a serial one of the same snapshot:
#: the Jaccard at every threshold within this (one pixel flipping at a
#: threshold moves a sample's IoU by less than 1e-4 at these sizes; the
#: forwards repeat bit for bit, so 0 is expected) and the loss within
#: this relative difference
OVERLAP_JAC_TOL, OVERLAP_LOSS_TOL = 1e-4, 1e-6
#: 10e: a remat variant's gradients held to the bf16 step without remat
#: by 6d's rule (each tensor within BF16_GRAD_TOL x its float32 max |g|,
#: or within the bf16 step's own distance from the float32 step); the
#: recompute runs the same kernels, so they agree to the last bit but for
#: cuDNN's choices.  bn_fp32_stats=false changes the arithmetic itself
#: (flax's E[x^2] - E[x]^2 in bf16 cancels where the mean is large against
#: the spread): its whole gradient's L2 distance from the bf16 step within
#: KNOB_L2_FACTOR x the bf16 step's own L2 distance from float32, and
#: its loss within that factor of the bf16 loss's distance from the
#: float32 loss or KNOB_LOSS_TOL relative, whichever is larger (a CPU
#: DANet-R18 64^2 probe: 1.2x and 2.6x)
KNOB_L2_FACTOR, KNOB_LOSS_TOL = 4.0, 1e-2
#: the AdamW check: lr, weight decay, and the bound on max |p - p_closed|
#: / max |p_closed| per tensor (float32 rounding of the parameters)
ADAMW_LR, ADAMW_WD, ADAMW_TOL = 1e-3, 1e-2, 1e-6


def _jaccard_gap(a: dict, b: dict) -> float:
    return max(abs(a["jaccard_per_threshold"][t] - b["jaccard_per_threshold"][t])
               for t in a["jaccard_per_threshold"])


def trainer_overlap(torch, ca, work: Path, device: str = "cuda",
                    rounds: int = 2) -> dict:
    """10a: one Trainer trains an epoch and validates once (the eval
    shapes warmed), then validates a snapshot on the thread while the next
    epoch trains; a serial validation of the same snapshot at the join
    gives the same metrics.  Then the wall time of an epoch plus the
    overlapped validation against an epoch plus a serial one, in turns,
    ``rounds`` of each.  Returns the launch counts of the first
    overlapped epoch + validation."""
    from distributedpytorch_tpu_torch.train.config import Config, apply_overrides
    from distributedpytorch_tpu_torch.train.trainer import Trainer

    cfg = apply_overrides(Config(), TRAINER_ARGS + [
        f"epochs={1 + 2 * rounds}", "val_overlap=true", f"work_dir={work}"])
    tr = Trainer(cfg, device=device)

    def overlapped(epoch: int):
        tr._launch_overlapped_val(epoch - 1, tr.state.step)
        snapshot, box = tr._pending_val[2], tr._pending_val[4]
        tr.train_epoch(epoch)
        tr._join_overlapped_val(None, finish=False)
        return snapshot, box["result"][0]

    def serial(epoch: int):
        tr.train_epoch(epoch)
        return tr.state, tr._eval_metrics(tr.state)[0]

    try:
        tr.train_epoch(0)
        tr._eval_metrics(tr.state)
        torch.cuda.synchronize()
        times: dict = {"overlapped": [], "serial": []}
        epoch = 1
        for r in range(rounds):
            for mode, run in (("overlapped", overlapped), ("serial", serial)):
                if r == 0 and mode == "overlapped":
                    ca.reset_launches()
                t0 = time.perf_counter()
                snapshot, metrics = run(epoch)
                torch.cuda.synchronize()
                times[mode].append(time.perf_counter() - t0)
                if r == 0 and mode == "overlapped":
                    launches = dict(ca.launches)
                    first, first_snapshot = metrics, snapshot
                epoch += 1
        serial_same, _ = tr._eval_metrics(first_snapshot)
        check("10a overlapped vs serial validation of one snapshot, Jaccard",
              _jaccard_gap(first, serial_same), OVERLAP_JAC_TOL)
        check("10a overlapped vs serial validation of one snapshot, loss (relative)",
              abs(first["loss"] - serial_same["loss"]) / abs(serial_same["loss"]),
              OVERLAP_LOSS_TOL)
        n, steps = first["n_samples"], len(tr.train_loader)
        want = steps + n
        if any(v != want for v in launches.values()):
            raise AssertionError(f"10a: the overlapped epoch launched {launches}: "
                                 f"want {want} each ({steps} steps + {n} val samples)")
        log(f"trainer (a): DANet-R101 512^2 bf16, train batch 2, {steps} steps per "
            f"epoch, {n} val samples; overlapped validation Jaccard "
            f"{first['jaccard']:.6f} loss {first['loss']:.9f}, serial of the same "
            f"snapshot {serial_same['jaccard']:.6f} / {serial_same['loss']:.9f}; "
            f"launches in the overlapped epoch {launches}")
        log(f"trainer (a): wall time of an epoch + its validation, in turns: "
            f"overlapped {', '.join(f'{t:.3f}' for t in times['overlapped'])} s, "
            f"serial {', '.join(f'{t:.3f}' for t in times['serial'])} s (median "
            f"ratio {statistics.median(times['overlapped']) / statistics.median(times['serial']):.3f}; "
            f"the thread launches on the main thread's stream, so only host work "
            f"overlaps)")
        return launches
    finally:
        tr._discard_overlapped_val()
        tr.close()


def trainer_look_ahead(torch, ca, work: Path, device: str = "cuda") -> None:
    """10b: the look-ahead evaluator over the 16 val samples against a
    per-sample reference built here from ``eval_step`` and the host
    protocol; its seconds per sample and the device's idle share in a
    profiler window around it."""
    import numpy as np

    from distributedpytorch_tpu_torch.ops.metrics import np_jaccard_thresholds
    from distributedpytorch_tpu_torch.train.config import Config, apply_overrides
    from distributedpytorch_tpu_torch.train.evaluate import evaluate
    from distributedpytorch_tpu_torch.train.trainer import Trainer
    from distributedpytorch_tpu_torch.utils.helpers import crop2fullmask, tens2image

    cfg = apply_overrides(Config(), TRAINER_ARGS + ["epochs=1", f"work_dir={work}"])
    tr = Trainer(cfg, device=device)
    try:
        thresholds = tuple(cfg.eval_thresholds)
        tr.val_loader.set_epoch(0)
        jac, n, losses = np.zeros(len(thresholds)), 0, []
        for batch in tr.val_loader:
            outputs, loss = tr.eval_step(tr.state, batch)
            losses.append(loss.item())
            logits = outputs[0][:, 0].to(torch.bfloat16).float().cpu().numpy()
            probs = 1.0 / (1.0 + np.exp(-logits))
            for j in range(probs.shape[0]):
                gt = tens2image(np.asarray(batch["gt"][j]))
                void = tens2image(np.asarray(batch["void_pixels"][j]))
                n += 1
                if gt.max() <= 0.5:
                    jac += [float(not (probs[j] > t).any()) for t in thresholds]
                    continue
                bbox = tuple(int(v) for v in np.asarray(batch["bbox"][j]))
                full = crop2fullmask(probs[j], bbox, gt.shape[:2],
                                     zero_pad=cfg.data.zero_pad, relax=cfg.data.relax)
                jac += np_jaccard_thresholds(full, thresholds, gt > 0.5, void)
        ref = {"jaccard_per_threshold": dict(zip(map(str, thresholds),
                                                 (jac / n).tolist())),
               "loss": sum(losses) / len(losses)}
        tr.val_loader.set_epoch(0)
        evaluate(tr.eval_step, tr.state, tr.val_loader, thresholds=thresholds,
                 relax=cfg.data.relax, bf16_readback=True)  # warm
        tr.val_loader.set_epoch(0)
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            got = evaluate(tr.eval_step, tr.state, tr.val_loader, thresholds=thresholds,
                           relax=cfg.data.relax, bf16_readback=True)
            torch.cuda.synchronize()
            window_ms = (time.perf_counter() - t0) * 1e3
        busy = sum(e.device_time_total for e in _device_events(prof)) / 1e3
        check("10b look-ahead vs per-sample reference, Jaccard", _jaccard_gap(got, ref),
              OVERLAP_JAC_TOL)
        check("10b look-ahead vs per-sample reference, loss (relative)",
              abs(got["loss"] - ref["loss"]) / abs(ref["loss"]), OVERLAP_LOSS_TOL)
        if got["n_samples"] != n or got["_first_batch"] is None:
            raise AssertionError(f"10b: {got['n_samples']} samples (want {n}), "
                                 f"first-batch record {got['_first_batch'] is not None}")
        log(f"trainer (b): look-ahead evaluate over {n} val samples (val batch "
            f"{cfg.data.val_batch}), Jaccard {got['jaccard']:.6f} (reference "
            f"{max(ref['jaccard_per_threshold'].values()):.6f}); "
            f"{got['seconds'] / n * 1e3:.2f} ms per sample inside the window; device "
            f"busy {busy:.2f} ms of the {window_ms:.2f} ms window, idle share "
            f"{1.0 - busy / window_ms:.4f}")
    finally:
        tr.close()


def trainer_fit(torch, ca, work: Path) -> dict:
    """10c and 10d: the fit (a ``Trainer`` in this process) with
    ``val_overlap``, ``profile_epoch=1``
    and the TensorBoard writer: the trace names the four kernels at least
    once per step of epoch 1, the launches are exact, and the writers'
    files are there where their packages are.  Returns its launches."""
    import importlib.util

    log(f"trainer (c): {' '.join(TRAINER_FIT_ARGS)} (a Trainer in this process)")
    t0 = time.perf_counter()
    run = _in_process_fit(torch, _trainer_args(TRAINER_FIT_ARGS)
                          + [f"work_dir={work}"])
    fit_s = time.perf_counter() - t0
    rec = _run_record(run)
    steps = [len(r["train/step_losses"]) for r in rec["epochs"]]
    vals = rec["vals"]
    launches = rec["summary"]["kernel_launches"]
    want = sum(steps) + sum(int(r["val/n_samples"]) for r in vals)
    if len(vals) != 2 or any(v != want for v in launches.values()):
        raise AssertionError(f"10c: launches {launches}, want {want} each ({steps} "
                             f"steps + {[r['val/n_samples'] for r in vals]} samples)")
    traces = list((run / "profile").glob("*.pt.trace.json"))
    if len(traces) != 1:
        raise AssertionError(f"10c: {len(traces)} traces under {run / 'profile'}")
    with open(traces[0]) as f:
        names = [e.get("name", "") for e in json.load(f)["traceEvents"]
                 if e.get("cat") == "kernel"]
    counts = {k: sum(k in name for name in names) for k in ATTENTION_KERNELS}
    if any(c < steps[1] for c in counts.values()):
        raise AssertionError(f"10c: kernels in the epoch-1 trace {counts}: want at "
                             f"least {steps[1]} each (one per train step)")
    log(f"trainer (c): {fit_s:.1f} s wall; steps per epoch {steps}, val Jaccard "
        f"{[round(r['val/jaccard'], 6) for r in vals]}; kernel launches {launches} "
        f"= {want} each, exact; the epoch-1 trace ({traces[0].stat().st_size / 2**20:.1f}"
        f" MiB, {len(names)} kernels) holds {counts}")

    have = {m: importlib.util.find_spec(m) is not None
            for m in ("tensorboard", "matplotlib")}
    tb = run / "tb"
    if not have["tensorboard"]:
        files = list(tb.rglob("*")) if tb.exists() else []
        if files:
            raise AssertionError(f"10d: no tensorboard, yet {files}")
        log("trainer (d): tensorboard is not installed: the writer was a no-op "
            "(the fit exited 0, no files under run_dir/tb)")
        return launches
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    acc = EventAccumulator(str(tb), size_guidance={"images": 0})
    acc.Reload()
    jac = [(e.step, round(e.value, 6)) for e in acc.Scalars("val/jaccard")]
    panels = [e.step for e in acc.Images("val_panels")] \
        if "val_panels" in acc.Tags()["images"] else []
    if [s for s, _ in jac] != [int(r["step"]) for r in vals]:
        raise AssertionError(f"10d: val/jaccard in run_dir/tb {jac}, metrics.jsonl "
                             f"{[(r['step'], r['val/jaccard']) for r in vals]}")
    if have["matplotlib"] and not panels:
        raise AssertionError("10d: matplotlib is installed but no val_panels image")
    log(f"trainer (d): run_dir/tb holds val/jaccard {jac} and val_panels images at "
        f"steps {panels} (matplotlib {'installed' if have['matplotlib'] else 'absent'})")
    return launches


def trainer_knobs(torch, ca, dataset, batch_size: int = 16, rounds: int = 3,
                  device: str = "cuda") -> None:
    """10e: at B = 16, bf16, DANet-R101 512^2: model.remat_policy (none,
    remat alone, dots_saveable, nothing_saveable) and bn_fp32_stats=false,
    each step's loss and gradients against the bf16 step without the knob
    (6d's rule, float32 as the yardstick), with its peak memory and step
    ms; then AdamW's first update against optax's closed form."""
    from distributedpytorch_tpu_torch.data import pipeline
    from distributedpytorch_tpu_torch.models.resnet import set_fp32_stats
    from distributedpytorch_tpu_torch.ops.losses import multi_output_loss
    from distributedpytorch_tpu_torch.parallel.step import (
        _forward,
        create_train_state,
        device_batch,
        make_train_step,
    )
    from distributedpytorch_tpu_torch.predict import Predictor
    from distributedpytorch_tpu_torch.train.config import OptimConfig
    from distributedpytorch_tpu_torch.train.optim import apply_update, make_optimizer
    from distributedpytorch_tpu_torch.train.precision import precision_policy

    policy = precision_policy("bfloat16")
    loader = pipeline.DataLoader(Cycled(dataset, batch_size), batch_size,
                                 shuffle=True, drop_last=True, seed=0)
    batch = next(iter(loader))
    model = Predictor.fresh(*KNOB_MODEL, seed=0, device=device).model.train()
    model.head.dropout_rate = 0.0
    data = device_batch(batch, torch.device(device))
    saved = {k: v.clone() for k, v in model.state_dict().items()}
    # (label, compute dtype, remat, remat_policy, bn_fp32_stats)
    variants = {"float32": (None, False, None, True),
                "bf16": (torch.bfloat16, False, None, True),
                "remat": (torch.bfloat16, True, None, True),
                "dots_saveable": (torch.bfloat16, True, "dots_saveable", True),
                "nothing_saveable": (torch.bfloat16, True, "nothing_saveable", True),
                "bn_fp32_stats=false": (torch.bfloat16, False, None, False)}

    def use(label):
        dtype, remat, pol, fp32 = variants[label]
        model.set_compute_dtype(dtype)
        model.backbone.remat, model.backbone.remat_policy = remat, pol
        set_fp32_stats(model, fp32)
        return policy if dtype is not None else None

    grads, losses = {}, {}
    torch.backends.cudnn.deterministic = True
    try:
        for label in variants:
            model.load_state_dict(saved)
            model.zero_grad(set_to_none=True)
            loss = multi_output_loss(_forward(model, data["concat"], use(label)),
                                     data["crop_gt"])
            loss.backward()
            losses[label] = loss.item()
            grads[label] = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
    finally:
        torch.backends.cudnn.deterministic = False
    f32, bf16 = grads["float32"], grads["bf16"]

    def l2(a: dict, b: dict) -> float:
        return sum(float(((a[n].double() - b[n].double()) ** 2).sum()) for n in a) ** 0.5

    own_l2 = l2(bf16, f32) / l2(f32, {n: 0.0 * g for n, g in f32.items()})
    for label in ("remat", "dots_saveable", "nothing_saveable", "bn_fp32_stats=false"):
        worst, failures = 0.0, []
        for name, g in grads[label].items():
            scale = f32[GRAD_SCALE_OF.get(name, name)].abs().max().item()
            own = (bf16[name].double() - f32[name].double()).abs().max().item()
            diff = (g.double() - bf16[name].double()).abs().max().item()
            limit = max(BF16_GRAD_TOL * scale, own)
            worst = max(worst, diff / limit)
            if not diff <= limit:
                failures.append(f"{name}: {diff:.3e} > {limit:.3e}")
        rel_l2 = l2(grads[label], bf16) / l2(bf16, {n: 0.0 * g for n, g in bf16.items()})
        log(f"trainer (e): {label}: loss {losses[label]:.9f} (bf16 {losses['bf16']:.9f},"
            f" float32 {losses['float32']:.9f}); gradients vs the bf16 step: largest "
            f"per-tensor diff / 6d's limit {worst:.3e} ({len(failures)} tensors over), "
            f"whole-model relative L2 {rel_l2:.3e} (the bf16 step's own from float32 "
            f"{own_l2:.3e})")
        own_loss = abs(losses["bf16"] - losses["float32"]) / abs(losses["float32"])
        check(f"10e {label} loss vs bf16 (relative)",
              abs(losses[label] - losses["bf16"]) / abs(losses["bf16"]),
              max(KNOB_LOSS_TOL, KNOB_L2_FACTOR * own_loss))
        if label == "bn_fp32_stats=false":
            check("10e bn_fp32_stats=false gradient L2 vs bf16 (relative)", rel_l2,
                  KNOB_L2_FACTOR * own_l2)
        elif failures:
            raise AssertionError(f"10e {label}: gradients " + "; ".join(failures[:5]))
        else:
            note_margin(f"10e {label} gradients vs bf16", worst, 1.0)

    model.load_state_dict(saved)
    optimizer, schedule = make_optimizer(OptimConfig(), model, total_steps=100)
    state = create_train_state(model, optimizer, schedule, 0, torch.device(device))
    step = make_train_step(precision=policy)
    for label in variants:
        if label == "float32":
            continue
        use(label)
        step(state, batch)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times = []
        for _ in range(rounds):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            step(state, batch)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        log(f"trainer (e): B={batch_size} bf16 step with {label}: "
            f"{statistics.median(times):.2f} ms median of {rounds} "
            f"({', '.join(f'{t:.2f}' for t in times)}), peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    use("bf16")

    model.load_state_dict(saved)
    opt, sched = make_optimizer(OptimConfig(name="adamw", lr=ADAMW_LR,
                                            weight_decay=ADAMW_WD), model, 10)
    before = {n: p.detach().double().clone() for n, p in model.named_parameters()}
    for n, p in model.named_parameters():
        p.grad = bf16[n].clone()
    apply_update(opt, sched, 0)
    worst = 0.0
    for n, p in model.named_parameters():
        g, p0 = bf16[n].double(), before[n]
        closed = p0 - ADAMW_LR * (g / (g.abs() + 1e-8) + ADAMW_WD * p0)
        worst = max(worst, ((p.detach().double() - closed).abs().max()
                            / closed.abs().max().clamp_min(1e-30)).item())
    check("10e adamw first update vs optax's closed form (relative)", worst, ADAMW_TOL)


def phase_trainer(torch, ca) -> dict:
    """Phase 10 (a-e); returns the launch counts of the overlapped
    validation's epoch and of the fit."""
    import shutil
    import tempfile

    t0 = time.perf_counter()
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_trainer_"))
    try:
        overlap = trainer_overlap(torch, ca, work / "overlap")
        log(f"trainer: (a) done at {time.perf_counter() - t0:.1f} s")
        trainer_look_ahead(torch, ca, work / "look_ahead")
        log(f"trainer: (b) done at {time.perf_counter() - t0:.1f} s")
        fit = trainer_fit(torch, ca, work / "fit")
        log(f"trainer: (c, d) done at {time.perf_counter() - t0:.1f} s")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    trainer_knobs(torch, ca, train_dataset())
    gc.collect()
    torch.cuda.empty_cache()
    log(f"trainer: (e) done; phase wall time {time.perf_counter() - t0:.1f} s")
    return {"val_overlap": overlap, "trainer_fit": fit}


#: phase 11's fits: DANet-R101 512^2 bf16 at train batch 4 (2 steps per
#: epoch), two epochs, a loss read (and a governor tick) at every step;
#: ``telemetry`` and ``data.governor`` at their defaults
TELEMETRY_ARGS = ["data.fake=true", "train.precision=bfloat16", "data.train_batch=4",
                  "data.area_thres=0", "epochs=2", "log_every_steps=1",
                  'log_writers=["jsonl"]', "checkpoint.keep_latest=1"]
#: 11b's fault: every batch fetch 200 ms late
FETCH_DELAY_S = 0.2
#: the JAX package's governor.jsonl and feed-block keys
GOVERNOR_LINE_KEYS = {"ts", "step", "epoch", "action", "applied", "stall", "target",
                      "detail"}
FEED_KEYS = {"mode", "target", "input_wait_fraction", "echo_effective", "echo_armed",
             "shortfall", "actions"}


def _telemetry_trainer(work: Path, *extra: str):
    from distributedpytorch_tpu_torch.train.config import Config, apply_overrides
    from distributedpytorch_tpu_torch.train.trainer import Trainer

    return Trainer(apply_overrides(Config(), TELEMETRY_ARGS + [f"work_dir={work}",
                                                               *extra]),
                   device="cuda")


@contextlib.contextmanager
def fetch_waits():
    """The seconds of each ``input_wait`` account the main thread closes
    inside the block (one per batch fetch of a fit), in order."""
    from distributedpytorch_tpu_torch.telemetry import goodput

    waits: list[float] = []
    credit = goodput.GoodputAccountant._credit

    def recording(self, bucket, seconds):
        if bucket == "input_wait" and threading.current_thread() is threading.main_thread():
            waits.append(seconds)
        credit(self, bucket, seconds)

    goodput.GoodputAccountant._credit = recording
    try:
        yield waits
    finally:
        goodput.GoodputAccountant._credit = credit


def _telemetry_fit(torch, work: Path, plan: dict | None = None,
                   extra: tuple[str, ...] = ()):
    """One fit of ``TELEMETRY_ARGS`` and ``extra`` (through
    ``DPTPU_CHAOS_PLAN`` when a plan is given); returns its run dir,
    history, events block, the loader's prefetch depth and echo factor
    after the fit, the fired plan and each batch fetch's input wait."""
    import os

    from distributedpytorch_tpu_torch.chaos import sites

    tr = _telemetry_trainer(work, *extra)
    if plan is not None:
        os.environ[sites.PLAN_ENV] = json.dumps(plan)
    try:
        with fetch_waits() as waits:
            history = tr.fit()
        block = tr._events.block()
        knobs = (tr.train_loader.prefetch, tr._echo, tr._host_prefetch)
    finally:
        os.environ.pop(sites.PLAN_ENV, None)
        fired = sites.armed()
        sites.disarm()
        tr.close()
    run = Path(tr.run_dir)
    del tr
    gc.collect()
    torch.cuda.empty_cache()
    return run, history, block, knobs, fired, waits


def _event_records(run: Path) -> list[dict]:
    (path,) = (run / "events").glob("*.jsonl")
    return _read_jsonl(path)


def telemetry_default_fit(torch, work: Path) -> tuple[dict, dict, list]:
    """11a: the default fit's flight recorder, summary blocks, goodput, MFU,
    governor ledger and launches.  Returns its history, launches and each
    batch fetch's input wait."""
    t0 = time.perf_counter()
    run, hist, block, knobs, _, waits = _telemetry_fit(torch, work)
    wall = time.perf_counter() - t0
    rec = _run_record(run)
    summary = rec["summary"]
    events = _event_records(run)
    kinds = [(e["source"], e["kind"]) for e in events]
    if {e["v"] for e in events} != {1} or kinds[0] != ("trainer", "fit_start") \
            or kinds[-1] != ("trainer", "fit_end") \
            or ("checkpoint", "commit") not in kinds[1:-1] or block["dropped"] != 0:
        raise AssertionError(f"11a: events {kinds}, block {block}")
    if summary["recovery"] is not None or set(summary["feed"] or {}) != FEED_KEYS:
        raise AssertionError(f"11a: summary recovery {summary['recovery']}, "
                             f"feed {summary['feed']}")
    gp = hist["goodput"]
    five = [gp["buckets"][b] for b in ("step", "compile", "checkpoint", "eval",
                                       "input_wait")]
    if min(five) < 0 or sum(five) > gp["total_s"] or gp["buckets"]["compile"] <= 0 \
            or not 0 < gp["goodput"] <= 1:
        raise AssertionError(f"11a: goodput {gp}")
    mfu = hist["mfu"]
    if not 0 < mfu["mfu"] < 1 or mfu["peak_source"] == "fallback" \
            or mfu["flops_source"] != "flop_counter":
        raise AssertionError(f"11a: mfu {mfu}")
    lines = _read_jsonl(run / "governor.jsonl") if (run / "governor.jsonl").exists() \
        else []
    feed = hist["feed"]
    if any(set(x) != GOVERNOR_LINE_KEYS or x["applied"] for x in lines) \
            or feed["mode"] != "observe" or not 0 <= feed["input_wait_fraction"] <= 1:
        raise AssertionError(f"11a: governor.jsonl {lines}, feed {feed}")
    steps = [len(r["train/step_losses"]) for r in rec["epochs"]]
    launches = summary["kernel_launches"]
    want = sum(steps) + sum(int(r["val/n_samples"]) for r in rec["vals"])
    if any(v != want for v in launches.values()):
        raise AssertionError(f"11a: launches {launches}, want {want} each")
    log(f"telemetry (a): default fit {wall:.1f} s wall; events {kinds} "
        f"(emitted {block['emitted']}, dropped 0); goodput total "
        f"{gp['total_s']:.3f} s, buckets " + json.dumps(
            {k: round(v, 4) for k, v in gp["buckets"].items()})
        + f", productive {gp['goodput']:.4f}; mfu {mfu['mfu']:.6f} "
        f"({mfu['flops_per_step']:.4e} FLOP/step over {mfu['step_time_s'] * 1e3:.2f} "
        f"ms/step, peak {mfu['peak_source']} {mfu['peak_flops_per_device']:.4g}, "
        f"{mfu['flops_source']}); feed {json.dumps(feed)}; governor.jsonl "
        f"{len(lines)} lines {[x['action'] for x in lines]}; kernel launches "
        f"{launches} = {want} each ({steps} steps + val samples), exact")
    return hist, launches, waits


def _waits_ms(waits: list[float]) -> str:
    return "[" + ", ".join(f"{w * 1e3:.1f}" for w in waits) + "] ms"


def telemetry_fault_fit(torch, work: Path, clean: dict, clean_waits: list) -> None:
    """11b: the same fit with every batch fetch 200 ms late through
    ``DPTPU_CHAOS_PLAN``, then the clean fit again: the input_wait bucket
    grows by at least 0.9 x the injected sleep over the lower of the two
    clean fits around it (the first fit of a process also books one-time
    costs to its first fetches), governor.jsonl records the stall above
    the target and the would-be escalation, and nothing is actuated."""
    plan = {"name": "slow_feed", "seed": 0, "faults": [
        {"site": "trainer/batch_fetch", "kind": "latency", "delay_s": FETCH_DELAY_S}]}
    run, hist, _, knobs, fired, waits = _telemetry_fit(torch, work / "fault", plan)
    _, again, *_, again_waits = _telemetry_fit(torch, work / "clean")
    fetches = sum(1 for site, _, _ in fired.firings if site == "trainer/batch_fetch")
    cleans = [clean["goodput"]["buckets"]["input_wait"],
              again["goodput"]["buckets"]["input_wait"]]
    grew = hist["goodput"]["buckets"]["input_wait"] - min(cleans)
    log(f"telemetry (b): input wait per fetch: clean (a) {_waits_ms(clean_waits)}, "
        f"faulted {_waits_ms(waits)}, clean again {_waits_ms(again_waits)}")
    if fetches < 4 or grew < 0.9 * FETCH_DELAY_S * fetches:
        raise AssertionError(f"11b: input_wait grew {grew:.3f} s over {fetches} "
                             f"fetches of {FETCH_DELAY_S} s")
    lines = _read_jsonl(run / "governor.jsonl") if (run / "governor.jsonl").exists() \
        else []
    target = hist["feed"]["target"]
    escalated = [x for x in lines if x["stall"] is not None and x["stall"] > target
                 and x["action"] in ("pack_recommendation", "raise_prefetch")]
    if not escalated or any(x["applied"] for x in lines):
        raise AssertionError(f"11b: governor.jsonl {lines}")
    if knobs != (2, 1, 2):
        raise AssertionError(f"11b: knobs moved: loader prefetch, echo, host "
                             f"prefetch {knobs}")
    gp = hist["goodput"]
    log(f"telemetry (b): {fetches} fetches x {FETCH_DELAY_S} s injected; input_wait "
        f"{gp['buckets']['input_wait']:.4f} s vs the clean fits {cleans[0]:.4f} s "
        f"(a) and {cleans[1]:.4f} s (after): +{grew:.4f} s over the lower (>= "
        f"{0.9 * FETCH_DELAY_S * fetches:.2f}); buckets " + json.dumps(
            {k: round(v, 4) for k, v in gp["buckets"].items()})
        + f"; governor.jsonl {[(x['action'], x['stall'], x['applied']) for x in lines]}"
        f" (target {target}); feed {json.dumps(hist['feed'])}; loader prefetch, echo "
        f"unchanged {knobs[:2]}")


def telemetry_cost(torch, dataset, work: Path, batch_size: int = 16,
                   rounds: int = 5, device: str = "cuda") -> None:
    """11c: the B = 16 bf16 train step through the trainer's own per-step
    body (the input_wait account and chaos site around the fetch, the
    trace tick, the compile/step account, the step's chaos site) with
    telemetry on and off, in turns, median of 5 (CUDA events); and the
    host microseconds of that body around a no-op step."""
    import types

    from distributedpytorch_tpu_torch.chaos import sites
    from distributedpytorch_tpu_torch.data import pipeline
    from distributedpytorch_tpu_torch.models import build_model
    from distributedpytorch_tpu_torch.parallel.step import create_train_state, make_train_step
    from distributedpytorch_tpu_torch.telemetry import TraceCapture, get_accountant, set_enabled
    from distributedpytorch_tpu_torch.train.config import OptimConfig
    from distributedpytorch_tpu_torch.train.optim import make_optimizer
    from distributedpytorch_tpu_torch.train.precision import precision_policy
    from distributedpytorch_tpu_torch.train.trainer import Trainer

    loader = pipeline.DataLoader(Cycled(dataset, batch_size), batch_size,
                                 shuffle=True, drop_last=True, seed=0)
    batch = next(iter(loader))
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = build_model("danet", dtype="bfloat16")
    optimizer, schedule = make_optimizer(OptimConfig(), model, total_steps=100)
    state = create_train_state(model, optimizer, schedule, 0, torch.device(device))
    acct = get_accountant()
    host = types.SimpleNamespace(train_step=make_train_step(
        precision=precision_policy("bfloat16")), state=state,
        _step_compiled=True, _prod_steps=0, _trace=None)

    def use(on: bool) -> None:
        set_enabled(on)
        acct.reset(enabled=on)
        host._trace = TraceCapture(str(work / "trace_on_demand")) if on else None

    def body():
        with acct.account("input_wait"):
            b = sites.fire("trainer/batch_fetch", payload=batch)
        return Trainer._dispatch(host, b)

    try:
        for on in (True, False):
            use(on)
            body()
            body()
        torch.cuda.synchronize()
        times = {True: [], False: []}
        for r in range(rounds):
            for on in ((True, False) if r % 2 == 0 else (False, True)):
                use(on)
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                body()
                end.record()
                end.synchronize()
                times[on].append(start.elapsed_time(end))
        step = host.train_step
        host.train_step = lambda state, b: None
        us = {}
        for on in (True, False):
            use(on)
            t0 = time.perf_counter()
            for _ in range(2000):
                body()
            us[on] = (time.perf_counter() - t0) / 2000 * 1e6
        host.train_step = step
    finally:
        set_enabled(True)
        acct.reset(enabled=True)
    on, off = statistics.median(times[True]), statistics.median(times[False])
    log(f"telemetry (c): B={batch_size} bf16 step, median of {rounds} in turns: "
        f"telemetry on {on:.2f} ms ({', '.join(f'{t:.2f}' for t in times[True])}), "
        f"off {off:.2f} ms ({', '.join(f'{t:.2f}' for t in times[False])}); ratio "
        f"on/off {on / off:.4f} (the JAX contract: <= 1.02; not gated here); the "
        f"per-step body's host cost around a no-op step {us[True]:.2f} us on, "
        f"{us[False]:.2f} us off")


def telemetry_trace(torch, work: Path) -> None:
    """11d: SIGUSR2 at the first step of epoch 0 arms a capture that lands
    in ``trace_on_demand/trace_000`` (closed when ``profile_epoch=1``'s
    profiler starts) and names each attention kernel; a second SIGUSR2 at
    the first step of epoch 1 is refused (profile_epoch's profiler is on)
    and counted; the fit completes."""
    import os
    import signal

    from distributedpytorch_tpu_torch.telemetry import get_registry

    reg = get_registry()
    done = reg.counter("trace_captures_total").value
    failed = reg.counter("trace_capture_failures_total").value
    tr = _telemetry_trainer(work, "profile_epoch=1")
    pending = {0, 1}
    scalars = tr.writer.scalars

    def signalling(values, step):
        if "train/loss" in values and values["train/epoch"] in pending:
            pending.discard(values["train/epoch"])
            os.kill(os.getpid(), signal.SIGUSR2)
        return scalars(values, step)

    tr.writer.scalars = signalling
    try:
        hist = tr.fit()
    finally:
        tr.close()
    run = Path(tr.run_dir)
    del tr
    gc.collect()
    torch.cuda.empty_cache()
    traces = list((run / "trace_on_demand" / "trace_000").glob("*.pt.trace.json"))
    if pending or len(traces) != 1 or len(hist["train_loss"]) != 2:
        raise AssertionError(f"11d: signals left {pending}, traces {traces}, "
                             f"epochs {hist['train_loss']}")
    with open(traces[0]) as f:
        names = [e.get("name", "") for e in json.load(f)["traceEvents"]
                 if e.get("cat") == "kernel"]
    counts = {k: sum(k in name for name in names) for k in ATTENTION_KERNELS}
    captured = reg.counter("trace_captures_total").value - done
    refused = reg.counter("trace_capture_failures_total").value - failed
    if min(counts.values()) < 1 or captured != 1 or refused != 1:
        raise AssertionError(f"11d: kernels in the trace {counts}, captures "
                             f"{captured}, refused {refused}")
    log(f"telemetry (d): SIGUSR2 -> {traces[0].relative_to(run)} "
        f"({traces[0].stat().st_size / 2**20:.1f} MiB, {len(names)} kernels) holds "
        f"{counts}; trace_captures_total +{captured:g}; the second SIGUSR2, during "
        f"profile_epoch, refused and counted (trace_capture_failures_total "
        f"+{refused:g}); the fit completed its 2 epochs")


def _http(url: str, body: bytes | None = None, timeout: float = 120.0):
    """(status, body bytes) of one request, or the exception's type name
    when the connection closes unanswered."""
    import http.client
    from urllib.parse import urlsplit

    parts = urlsplit(url)
    conn = http.client.HTTPConnection(parts.hostname, parts.port, timeout=timeout)
    try:
        conn.request("GET" if body is None else "POST",
                     parts.path + (f"?{parts.query}" if parts.query else ""),
                     body=body, headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, resp.read()
    except (http.client.HTTPException, ConnectionError) as e:
        return type(e).__name__, b""
    finally:
        conn.close()


def telemetry_serve(torch, Predictor, InferenceService, make_server, work: Path) -> None:
    """11e: the HTTP front's ``GET /metrics`` after a few predicts parses as
    Prometheus text with the serve families and ``span_seconds``; ``POST
    /debug/trace`` captures a batch; an ``error`` fault at
    ``serve/enqueue`` fails its one request as on the JAX front (the
    connection closes unanswered), and the next request is served."""
    import numpy as np

    from distributedpytorch_tpu_torch.chaos import faults, sites
    from distributedpytorch_tpu_torch.serve.client import encode_array
    from distributedpytorch_tpu_torch.telemetry import TraceCapture

    image, clicks = synthetic_image(0)
    pred = Predictor.fresh(512, "resnet101", seed=0, device="cuda")
    svc = InferenceService(pred, max_batch=4,
                           trace=TraceCapture(str(work / "serve_trace"))).start()
    server = make_server(svc, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_port}"

    def predict():
        return _http(url + "/v1/predict", json.dumps(
            {"image": encode_array(image),
             "points": np.asarray(clicks[0]).tolist()}).encode())

    try:
        for _ in range(3):
            code, _ = predict()
            if code != 200:
                raise AssertionError(f"11e: predict -> {code}")
        code, reply = _http(url + "/debug/trace?steps=1", b"")
        target = json.loads(reply)["trace_dir"] if code == 202 else None
        predict()
        predict()
        code_m, text = _http(url + "/metrics")
        text = text.decode()
        plan = faults.FaultPlan.from_dict({"name": "front_door", "faults": [
            {"site": "serve/enqueue", "kind": "error", "at": [1]}]})
        with sites.armed_plan(plan):
            faulted = predict()[0]
            after = predict()[0]
    finally:
        server.shutdown()
        server.server_close()
        svc.stop()
        thread.join(timeout=30)
    families, samples = set(), 0
    for line in text.splitlines():
        if line.startswith("# TYPE "):
            families.add(line.split()[2])
        elif line and not line.startswith("#"):
            name, value = line.rsplit(" ", 1)
            float(value)
            samples += 1
    want = {"serve_requests_total", "serve_completed_total", "serve_latency_seconds",
            "serve_batch_dispatches_total", "span_seconds"}
    traced = list(Path(target).glob("*.pt.trace.json")) if target else []
    if code_m != 200 or not want <= families or len(traced) != 1:
        raise AssertionError(f"11e: /metrics {code_m} families {sorted(families)}; "
                             f"/debug/trace {code} {traced}")
    if faulted != "RemoteDisconnected" or after != 200 or thread.is_alive():
        raise AssertionError(f"11e: faulted request -> {faulted}, next -> {after}")
    log(f"telemetry (e): GET /metrics -> 200, {len(families)} families, {samples} "
        f"samples, serve families and span_seconds present; POST /debug/trace -> "
        f"202, {Path(traced[0]).name} written; error fault at serve/enqueue: that "
        f"request's connection closed unanswered ({faulted}, as on the JAX front), "
        f"the next served ({after}); the front stopped cleanly")


def phase_telemetry(torch, ca, Predictor, InferenceService, make_server) -> dict:
    """Phase 11 (a-e); returns the launch counts of the default fit."""
    import shutil
    import tempfile

    t0 = time.perf_counter()
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_telemetry_"))
    try:
        clean, launches, waits = telemetry_default_fit(torch, work / "default")
        telemetry_fault_fit(torch, work / "fault", clean, waits)
        log(f"telemetry: (a, b) done at {time.perf_counter() - t0:.1f} s")
        telemetry_cost(torch, train_dataset(), work / "cost")
        gc.collect()
        torch.cuda.empty_cache()
        telemetry_trace(torch, work / "trace")
        log(f"telemetry: (c, d) done at {time.perf_counter() - t0:.1f} s")
        telemetry_serve(torch, Predictor, InferenceService, make_server, work / "serve")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"telemetry: (e) done; phase wall time {time.perf_counter() - t0:.1f} s")
    return {"telemetry_fit": launches}


#: phase 12's bounds.  (a) the device stage on the card against the CPU on
#: the same draws: the image channels within DEV_IMAGE_TOL on [0, 255]
#: (the same gathers and weights; ``cos``/``sin`` and the coordinate
#: arithmetic may differ by an ulp between the two, which moves a source
#: coordinate by ~1e-5 px, times the steepest step between neighbours);
#: the masks differ on at most DEV_MASK_FRAC of their pixels (a nearest
#: source coordinate within an ulp of a half pixel rounds the other way);
#: the guidance channel computed from the same mask and the same draws
#: within DEV_GUIDE_TOL on [0, 255] (float32 ``exp``/``sqrt`` of the two)
DEV_IMAGE_TOL, DEV_MASK_FRAC, DEV_GUIDE_TOL = 1e-2, 1e-4, 1e-2
#: (f) the Jaccard of the device-guidance validation against the
#: host-guidance validation of the same cache and weights (the bound of
#: the CPU fit band, tests/test_torch_port_fit_band.py)
DEV_VAL_JAC_TOL = 1e-2
#: (h) the device/put latency fault's delay.  The window starts empty at
#: every epoch and the worker pulls and places the epoch's first batch
#: only when the consumer first asks for it, so that placement's sleep
#: cannot hide behind a step: the faulted fit's ``input_wait`` must be at
#: least (epochs x DEV_PUT_DELAY_S), whatever the window hides of the rest
DEV_PUT_DELAY_S = 0.2
#: the device stage of phase 12's fits and steps
DEVICE_STAGE_ARGS = ["data.device_augment=true", "data.device_augment_geom=true",
                     "data.device_guidance=true"]


def devdata_dataset():
    """The fake fixture's train split through the host stack the device
    stage leaves: crop and resize to 512², no flip, rotation or guidance
    (``concat`` has the 3 image channels)."""
    from distributedpytorch_tpu_torch.data import fake, pipeline, voc

    tree = fake.make_fake_voc(n_images=8, size=(96, 128), n_val=3, seed=0)
    return voc.VOCInstanceSegmentation(
        tree, split="train", area_thres=0,
        transform=pipeline.build_train_transform(
            crop_size=(512, 512), guidance="none", flip=False, geom=False))


def _device_stage():
    from distributedpytorch_tpu_torch.ops.augment import make_device_augment
    from distributedpytorch_tpu_torch.ops.guidance_device import make_device_guidance

    return make_device_augment(hflip=True, scale_rotate=True,
                               guidance_fn=make_device_guidance())


def devdata_stage(torch, dataset, batch_size: int = 16):
    """12a-b: the device stage on the card against the CPU from the same
    draws, and on the card under ``set_sync_debug_mode("error")``; returns
    the stage and its device ms (12c)."""
    from distributedpytorch_tpu_torch.data import pipeline
    from distributedpytorch_tpu_torch.ops.augment import make_device_augment
    from distributedpytorch_tpu_torch.ops.guidance_device import make_device_guidance
    from distributedpytorch_tpu_torch.parallel.step import device_batch, step_generator

    loader = pipeline.DataLoader(Cycled(dataset, batch_size), batch_size,
                                 shuffle=True, drop_last=True, seed=0)
    host = next(iter(loader))
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    on_cpu, on_card = device_batch(host, cpu), device_batch(host, cuda)
    stage, geometry = _device_stage(), make_device_augment(hflip=True,
                                                           scale_rotate=True)
    draws = stage.draw(on_cpu, torch.Generator().manual_seed(0))
    card_draws = {k: v.to(cuda) for k, v in draws.items()}
    g_cpu = geometry.apply(on_cpu, draws)
    g_card = geometry.apply(on_card, card_draws)
    image = float((g_card["concat"].cpu() - g_cpu["concat"]).abs().max())
    flips = {k: float((g_card[k].cpu() != g_cpu[k]).float().mean())
             for k in ("crop_gt",)}
    guide = make_device_guidance()
    same = {k: v.to(cuda) for k, v in g_cpu.items()}
    m_cpu = guide.apply(g_cpu, u=draws["guidance_u"])["concat"][:, 3]
    m_card = guide.apply(same, u=card_draws["guidance_u"])["concat"][:, 3]
    guidance = float((m_card.cpu() - m_cpu).abs().max())
    full_cpu = stage.apply(on_cpu, draws)
    full_card = stage.apply(on_card, card_draws)
    per_key = {k: float((full_card[k].cpu() - full_cpu[k]).abs().max())
               for k in full_cpu}
    log(f"devdata (a): the device stage (flip, scale-rotate, nellipse_gaussians "
        f"guidance) at B={batch_size} 512^2, card against CPU on the same draws: "
        f"max |diff| per key of the whole stage {json.dumps(per_key)}; geometry "
        f"only: image {image:.3e}, crop_gt pixels differing {flips['crop_gt']:.3e}; "
        f"guidance on the same mask and draws {guidance:.3e} (0-255 scale)")
    check("12a device stage card vs CPU, image channels", image, DEV_IMAGE_TOL)
    check("12a device stage card vs CPU, mask pixels differing", flips["crop_gt"],
          DEV_MASK_FRAC)
    check("12a device guidance card vs CPU, same mask and draws", guidance,
          DEV_GUIDE_TOL)
    if full_card["concat"].shape != (batch_size, 4, 512, 512) \
            or not torch.isfinite(full_card["concat"]).all():
        raise AssertionError(f"12a: stage output {tuple(full_card['concat'].shape)}")

    gen = step_generator(0, 1, 0, cuda)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = stage(on_card, gen)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    log(f"devdata (b): the stage and its draws ran under "
        f"torch.cuda.set_sync_debug_mode('error') without a host synchronisation "
        f"(output {tuple(out['concat'].shape)})")
    ms, geom_ms, guide_ms = median_ms(
        [lambda: stage(on_card, gen), lambda: geometry(on_card, gen),
         lambda: guide(g_card, gen)], reps=20)
    log(f"devdata (c): of the stage's {ms:.3f} ms, the flip and scale-rotate "
        f"alone {geom_ms:.3f} ms, the guidance alone {guide_ms:.3f} ms (CUDA "
        f"events, median of 20 single calls each)")
    return stage, ms


def devdata_cache(tree, work: Path, crop: tuple[int, int] = (512, 512)):
    """12g: the prepared cache over ``tree`` at 512²: fill and read ms per
    sample (one thread), bytes per sample, read back bitwise; returns the
    cache (for 12c's host timing)."""
    import os

    from distributedpytorch_tpu_torch.data import prepared, voc

    base = voc.VOCInstanceSegmentation(tree, split="train", area_thres=0)
    ds = prepared.PreparedInstanceDataset(base, str(work), crop_size=crop)
    n = len(ds)
    t0 = time.perf_counter()
    first = [ds[i] for i in range(n)]
    fill = (time.perf_counter() - t0) / n * 1e3
    ds.flush()
    t0 = time.perf_counter()
    again = [ds[i] for i in range(n)]
    read = (time.perf_counter() - t0) / n * 1e3
    if any(a["crop_image"].tobytes() != b["crop_image"].tobytes()
           or a["crop_gt"].tobytes() != b["crop_gt"].tobytes()
           for a, b in zip(first, again)) or ds.n_prepared != n:
        raise AssertionError("12g: a cached row read back differs from its fill")
    size = sum(os.path.getsize(os.path.join(ds.cache_dir, f))
               for f in os.listdir(ds.cache_dir))
    log(f"devdata (g): prepared cache of {n} samples at {crop[0]}^2 from "
        f"375x500 images: fill {fill:.2f} ms per sample (decode, crop, resize, "
        f"write), read {read:.2f} ms per sample (memmap, unpack, float32), "
        f"{size / n / 1e6:.4f} MB per sample on disk; read back bitwise")
    return ds


def devdata_host_ms(cache, stage_ms: float, batch_size: int = 16) -> None:
    """12c: the stage's device ms beside the host's ms for the same work
    (flip, scale-rotate, guidance and concat of ``batch_size`` cached
    512² crops, one thread, the host library)."""
    import numpy as np

    from distributedpytorch_tpu_torch.data import pipeline

    post = pipeline.build_prepared_post_transform()
    samples = [{k: v for k, v in cache[i].items() if k != "bbox"}
               for i in range(batch_size)]
    rng = np.random.default_rng(0)

    def host_batch():
        pipeline.collate([post(dict(s), rng) for s in samples])

    host = _best_ms(host_batch, 3)
    loader = STEP_MS.get("6i threads (2) + host library")
    log(f"devdata (c): the device stage at B={batch_size} 512^2 {stage_ms:.3f} ms on "
        f"the card (CUDA events, median of 20); the same work on the host "
        f"{host:.1f} ms a batch (one thread: flip, scale-rotate, guidance, concat, "
        f"collate); 6i's threaded loader, the whole host stack: "
        + ("not measured in this run" if loader is None else f"{loader:.1f} ms a batch"))


def devdata_step(torch, ca, stage, batch_size: int = 16, rounds: int = 5) -> dict:
    """12d: the B = 16 bf16 step fed from the host (the host stack with
    guidance, the pageable copy in the step, as 6e) against the device
    stage fed by ``prefetch_to_device`` with a window of 2, in turns."""
    import itertools

    from distributedpytorch_tpu_torch.data import pipeline
    from distributedpytorch_tpu_torch.models import build_model
    from distributedpytorch_tpu_torch.parallel.mesh import prefetch_to_device
    from distributedpytorch_tpu_torch.parallel.step import (
        DEVICE_KEYS,
        create_train_state,
        make_train_step,
    )
    from distributedpytorch_tpu_torch.train.config import OptimConfig
    from distributedpytorch_tpu_torch.train.optim import make_optimizer
    from distributedpytorch_tpu_torch.train.precision import precision_policy

    host_batch = next(iter(pipeline.DataLoader(
        Cycled(train_dataset(), batch_size), batch_size, shuffle=True,
        drop_last=True, seed=0)))
    bare = list(itertools.islice(iter(pipeline.DataLoader(
        Cycled(devdata_dataset(), 2 * batch_size), batch_size, shuffle=True,
        drop_last=True, seed=0)), 2))
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = build_model("danet", dtype="bfloat16")
    optimizer, schedule = make_optimizer(OptimConfig(), model, total_steps=100)
    cuda = torch.device("cuda")
    state = create_train_state(model, optimizer, schedule, 0, cuda)
    policy = precision_policy("bfloat16")
    steps = {"host-fed": make_train_step(precision=policy),
             "device stage, device_prefetch=2": make_train_step(
                 precision=policy, augment=stage, seed=0)}
    placed = prefetch_to_device(itertools.cycle(bare), cuda, size=2, keys=DEVICE_KEYS)

    def run(label):
        b = host_batch if label == "host-fed" else next(placed)
        return steps[label](state, b)

    peak = {}
    try:
        for label in steps:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            run(label)
            run(label)
            torch.cuda.synchronize()
            peak[label] = torch.cuda.max_memory_allocated() / 2**30
        times = {label: [] for label in steps}
        losses = []
        before = dict(ca.launches)
        for _ in range(rounds):
            for label in steps:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                losses.append(run(label))
                end.record()
                end.synchronize()
                times[label].append(start.elapsed_time(end))
        rise = {k: ca.launches[k] - before[k] for k in before}
        if any(n != 2 * rounds for n in rise.values()):
            raise AssertionError(f"12d: {2 * rounds} steps launched {rise}")
        if not torch.isfinite(torch.stack(losses)).all():
            raise AssertionError(f"12d: non-finite losses {torch.stack(losses).tolist()}")
        ms = {label: statistics.median(t) for label, t in times.items()}
        idle = {}
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        for label in steps:
            torch.cuda.synchronize()
            with torch.profiler.profile(activities=acts) as prof:
                run(label)
                torch.cuda.synchronize()
            busy = sum(e.device_time_total for e in _device_events(prof)) / 1e3
            idle[label] = 1.0 - busy / ms[label]
    finally:
        placed.close()
    for label in steps:
        log(f"devdata (d): B={batch_size} bf16 step {label}: {ms[label]:.2f} ms median "
            f"of {rounds} in turns (all {', '.join(f'{t:.2f}' for t in times[label])}), "
            f"{batch_size / ms[label] * 1e3:.2f} images/s, idle share "
            f"{idle[label]:.4f}, peak memory {peak[label]:.2f} GiB")
    return ms


def _input_wait(hist: dict) -> str:
    gp = hist["goodput"]["buckets"]
    return (f"input-wait share {hist['feed']['input_wait_fraction']}, input_wait "
            f"{gp['input_wait']:.4f} s of step {gp['step']:.4f} + compile "
            f"{gp['compile']:.4f} s")


def _in_step_copy(batches, device, size=2, keys=None):
    """The path ``prefetch_to_device`` replaced: the host batches reach the
    step unplaced, and the step copies them from pageable memory."""
    return iter(batches)


def devdata_fits(torch, work: Path) -> tuple[dict, dict]:
    """12e-f: the default fit in turns with the path it replaces (the
    prefetcher bypassed, the batch copied inside the step), then with
    ``device_prefetch=0``, then 2 with the device stage and the prepared
    cache, whose validation (prepared, device guidance) is timed in a
    profiler window and held to the host-guidance validation of the same
    cache and weights.  Returns the device-stage fit's launches and the
    first ``device_prefetch=2`` history."""
    from distributedpytorch_tpu_torch.parallel import mesh

    runs = {}
    for i, label in enumerate(("in-step copy", "device_prefetch=2", "device_prefetch=2",
                               "in-step copy", "device_prefetch=0")):
        extra = ("data.device_prefetch=0",) if label == "device_prefetch=0" else ()
        placer = mesh.prefetch_to_device
        if label == "in-step copy":
            mesh.prefetch_to_device = _in_step_copy
        try:
            run, hist, *_ = _telemetry_fit(torch, work / f"fit{i}", extra=extra)
        finally:
            mesh.prefetch_to_device = placer
        runs.setdefault(label, []).append(hist)
        log(f"devdata (e): default fit, {label}: {_input_wait(hist)}")
    log("devdata (e): input-wait share / input_wait s, in turns: " + "; ".join(
        f"{label} " + ", ".join(
            f"{h['feed']['input_wait_fraction']:.4f} / "
            f"{h['goodput']['buckets']['input_wait']:.4f}" for h in hs)
        for label, hs in runs.items()))
    cache = str(work / "cache")
    tr = _telemetry_trainer(work / "stage", *DEVICE_STAGE_ARGS,
                          f"data.prepared_cache={cache}")
    try:
        hist = tr.fit()
        run = Path(tr.run_dir)
        rec = _run_record(run)
        launches = rec["summary"]["kernel_launches"]
        steps = sum(len(r["train/step_losses"]) for r in rec["epochs"])
        want = steps + sum(int(r["val/n_samples"]) for r in rec["vals"])
        if any(v != want for v in launches.values()) or not tr._val_device_guidance:
            raise AssertionError(f"12e: launches {launches}, want {want} each")
        log(f"devdata (e): default fit, device_prefetch=2 + device stage + "
            f"prepared_cache: {_input_wait(hist)}; kernel launches {launches} = "
            f"{want} each ({steps} steps + val samples), exact (11a's record in "
            f"PERF.md: input-wait share 0.2036 / 0.1114)")
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            got, _ = tr._eval_metrics(tr.state)
            torch.cuda.synchronize()
            window_ms = (time.perf_counter() - t0) * 1e3
        kernels = _device_events(prof)
        busy = sum(e.device_time_total for e in kernels) / 1e3
        host = _telemetry_trainer(work / "host", f"data.prepared_cache={cache}")
        try:
            host.model.load_state_dict(tr.model.state_dict())
            ref, _ = host._eval_metrics(host.state)
        finally:
            host.close()
        n = got["n_samples"]
        log(f"devdata (f): validation from the prepared cache with device guidance: "
            f"{got['seconds'] / n * 1e3:.2f} ms per sample over {n} samples, device "
            f"busy {busy:.2f} ms of the {window_ms:.2f} ms window, idle share "
            f"{1.0 - busy / window_ms:.4f}, {len(kernels) / n:.0f} kernels and "
            f"copies a sample (10b's record in PERF.md: 31.00-48.75 ms at "
            f"0.85-0.90); "
            f"Jaccard {got['jaccard']:.6f} against host guidance "
            f"{ref['jaccard']:.6f} on the same weights")
        check("12f device vs host guidance validation, Jaccard",
              abs(got["jaccard"] - ref["jaccard"]), DEV_VAL_JAC_TOL)
    finally:
        tr.close()
    del tr
    gc.collect()
    torch.cuda.empty_cache()
    return launches, runs["device_prefetch=2"][0]


def devdata_chaos(torch, work: Path, clean: dict) -> None:
    """12h: a latency fault at ``device/put`` shows in ``input_wait``; an
    error fault there fails the fit loudly, leaving no placement thread."""
    from distributedpytorch_tpu_torch.chaos.faults import InjectedFaultError

    plan = {"name": "slow_put", "seed": 0, "faults": [
        {"site": "device/put", "kind": "latency", "delay_s": DEV_PUT_DELAY_S}]}
    run, hist, _, _, fired, _ = _telemetry_fit(torch, work / "latency", plan)
    puts = sum(1 for site, _, _ in fired.firings if site == "device/put")
    waited = hist["goodput"]["buckets"]["input_wait"]
    grew = waited - clean["goodput"]["buckets"]["input_wait"]
    injected = DEV_PUT_DELAY_S * puts
    epochs = len(_run_record(run)["epochs"])
    floor = epochs * DEV_PUT_DELAY_S
    if puts < 4 or epochs < 2 or waited < floor:
        raise AssertionError(f"12h: input_wait {waited:.3f} s under {floor:.3f} s "
                             f"({epochs} epochs x {DEV_PUT_DELAY_S} s) over {puts} "
                             f"placements {DEV_PUT_DELAY_S} s late")
    plan = {"name": "dead_put", "seed": 0, "faults": [
        {"site": "device/put", "kind": "error", "at": [2]}]}
    try:
        _telemetry_fit(torch, work / "error", plan, extra=("epochs=1",))
    except InjectedFaultError as e:
        raised = str(e)
    else:
        raise AssertionError("12h: an error fault at device/put did not fail the fit")
    left = [t.name for t in threading.enumerate() if t.name.startswith("device-put")]
    if left:
        raise AssertionError(f"12h: placement threads left after the failed fit: {left}")
    gc.collect()
    torch.cuda.empty_cache()
    log(f"devdata (h): device/put {DEV_PUT_DELAY_S} s late x {puts} placements: "
        f"input_wait {waited:.4f} s (floor {floor:.2f} s: the first placement of "
        f"each of {epochs} epochs), up {grew:.4f} s on the clean fit ({grew / injected:.4f} "
        f"of the {injected:.2f} s injected); an error fault at the 2nd placement "
        f"failed the fit loudly ({raised!r}), no placement thread left")


def devdata_semantic(torch, ca, batch_size: int = 8) -> None:
    """12i: one config-4 step (DeepLabV3-R101 513², B = 8, bf16) with the
    device flip and scale-rotate: finite loss, the warped-out ring of
    ``crop_gt`` filled with 255 and the ids kept, no attention kernel."""
    import numpy as np

    from distributedpytorch_tpu_torch.models import build_model
    from distributedpytorch_tpu_torch.ops.augment import make_device_augment
    from distributedpytorch_tpu_torch.parallel.step import (
        create_train_state,
        make_train_step,
    )
    from distributedpytorch_tpu_torch.train.config import Config, OptimConfig
    from distributedpytorch_tpu_torch.train.optim import make_optimizer
    from distributedpytorch_tpu_torch.train.precision import precision_policy

    rng = np.random.default_rng(5)
    batch = {"concat": rng.uniform(0, 255, (batch_size, SEM_SIZE, SEM_SIZE, 3)
                                   ).astype(np.float32),
             "crop_gt": rng.integers(0, SEM_CLASSES, (batch_size, SEM_SIZE, SEM_SIZE, 1)
                                     ).astype(np.float32)}
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = build_model("deeplabv3", nclass=SEM_CLASSES, backbone="resnet101",
                            aux_head=True, in_channels=3, dtype="bfloat16")
    optimizer, schedule = make_optimizer(OptimConfig(lr=1e-4), model, 100)
    state = create_train_state(model, optimizer, schedule, 0, torch.device("cuda"))
    d = Config().data
    stage = make_device_augment(hflip=True, scale_rotate=True, rots=tuple(d.rots),
                                scales=tuple(d.scales), semantic=True)
    seen = []

    def augment(data, generator):
        out = stage(data, generator)
        seen.append(out["crop_gt"])
        return out

    step = make_train_step(loss_weights=(1.0, 0.4), precision=precision_policy(
        "bfloat16"), loss_type="multi_softmax", augment=augment, seed=0)
    before = dict(ca.launches)
    losses = [step(state, batch) for _ in range(2)]
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    losses.append(step(state, batch))
    end.record()
    end.synchronize()
    gt = seen[-1]
    ids = torch.unique(gt)
    void = float((gt == 255).float().mean())
    if not torch.isfinite(torch.stack(losses)).all() or void <= 0 \
            or not bool(((ids == 255) | ((ids >= 0) & (ids < SEM_CLASSES)
                                          & (ids == ids.round()))).all()):
        raise AssertionError(f"12i: losses {torch.stack(losses).tolist()}, ids "
                             f"{ids.tolist()[:25]}, void share {void}")
    if dict(ca.launches) != before:
        raise AssertionError(f"12i: attention kernels launched on the semantic "
                             f"path: {before} -> {dict(ca.launches)}")
    del state, model, optimizer
    gc.collect()
    torch.cuda.empty_cache()
    log(f"devdata (i): config 4 (DeepLabV3-R101 {SEM_SIZE}^2 B={batch_size} bf16) "
        f"with the device flip and scale-rotate: losses "
        f"{[round(float(x), 6) for x in losses]}, a step "
        f"{start.elapsed_time(end):.2f} ms; crop_gt after the stage: 255 on "
        f"{void:.4f} of pixels (the warped-out ring), ids in 0..20 exact; the "
        f"attention kernels launched 0 times")


def phase_devdata(torch, ca) -> dict:
    """Phase 12 (a-i); returns the launch counts of the device-stage fit."""
    import shutil
    import tempfile

    t0 = time.perf_counter()
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_devdata_"))
    try:
        stage, stage_ms = devdata_stage(torch, devdata_dataset())
        log(f"devdata: (a, b) done at {time.perf_counter() - t0:.1f} s")
        cache = devdata_cache(host_tree(64, (375, 500)), work / "cache")
        devdata_host_ms(cache, stage_ms)
        log(f"devdata: (g, c) done at {time.perf_counter() - t0:.1f} s")
        devdata_step(torch, ca, stage)
        gc.collect()
        torch.cuda.empty_cache()
        log(f"devdata: (d) done at {time.perf_counter() - t0:.1f} s")
        launches, clean = devdata_fits(torch, work / "fits")
        log(f"devdata: (e, f) done at {time.perf_counter() - t0:.1f} s")
        devdata_chaos(torch, work / "chaos", clean)
        log(f"devdata: (h) done at {time.perf_counter() - t0:.1f} s")
        devdata_semantic(torch, ca)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    log(f"devdata: (i) done; phase wall time {time.perf_counter() - t0:.1f} s")
    return {"devdata_fit": launches}


#: 13d: the stateless B = 1 ``predict`` of a session's clicks against the
#: session's mask at bucket 8, in probability: another batch shape, so
#: cuDNN may take another algorithm (seen: 4.530e-06 f32, 2.442e-02 bf16)
SESSION_CROSS_TOL = {"float32": 1e-4, "bfloat16": 5e-2}
#: 13c: the clicks each timing takes turns over
SESSION_CLICKS = 20
#: 13f: the head-injected fit, 2 steps of B = 4 at 512² in bf16, one
#: validation
SESSION_FIT_ARGS = ["--fake-data", "train.precision=bfloat16", "data.train_batch=4",
                    "data.area_thres=0", "epochs=1", "model.guidance_inject=head"]


def _session_requests(clicks):
    """8 sessions' click sets: the 4 of ``synthetic_image`` and the same
    moved by 3 px."""
    return [clicks[i % 4] + 3.0 * (i // 4) for i in range(8)]


def _stage_flops(torch) -> tuple[float, float]:
    """Forward FLOPs of one 512² crop through the encode and the decode
    stage of DANet-R101 (OS 8), counted on the meta device with the plain
    attention forms (the kernels do the same products)."""
    from torch.utils.flop_counter import FlopCounterMode

    from distributedpytorch_tpu_torch.models import build_model

    with torch.device("meta"):
        model = build_model("danet", nclass=1, backbone="resnet101",
                            attention_impl="xla", guidance_inject="head").eval()
        rgb = torch.zeros(1, 3, 512, 512)
        g = torch.zeros(1, 1, 512, 512)
    with torch.no_grad():
        with FlopCounterMode(display=False) as enc:
            feats = model(rgb, stage="encode")
        with FlopCounterMode(display=False) as dec:
            model((feats, g), stage="decode", out_size=(512, 512))
    return float(enc.get_total_flops()), float(dec.get_total_flops())


def sessions_stages(torch, ca, pred, image, clicks, label: str) -> None:
    """13a and 13b: stage parity at B = 1 and 4, and the kernels' launches
    of each stage."""
    import numpy as np

    concat = np.stack([pred.prepare(image, c)[0] for c in clicks])
    for b in (1, 4):
        x = torch.from_numpy(concat[:b]).to(pred.device)
        ca.reset_launches()
        feats = pred.encode(x[..., :-1])
        torch.cuda.synchronize()
        enc_launches = dict(ca.launches)
        staged = pred.decode_device(feats, x[..., -1:])
        torch.cuda.synchronize()
        dec_launches = dict(ca.launches)
        if any(enc_launches.values()) or any(n != 1 for n in dec_launches.values()):
            raise AssertionError(f"13b {label} B={b}: launches after encode "
                                 f"{enc_launches}, after decode {dec_launches}; "
                                 "want 0 and exactly 1 of each")
        with torch.inference_mode():
            full = pred.model(x.permute(0, 3, 1, 2).contiguous().to(pred.dtype))[0]
            full = torch.sigmoid(full.float())[:, 0]
        bitwise = torch.equal(staged, full)
        err = (staged - full).abs().max().item()
        log(f"sessions (a, b) {label} B={b}: decode(encode(x)) vs the full forward "
            f"bitwise {bitwise}, max |diff| {err:.3e}; features "
            f"{tuple(feats.shape)} {str(feats.dtype).removeprefix('torch.')}; "
            f"launches encode {enc_launches}, decode {dec_launches}")
        if not bitwise:
            raise AssertionError(f"13a {label} B={b}: decode(encode(x)) is not "
                                 f"bitwise the full forward (max |diff| {err:.3e})")


def sessions_latency(torch, pred, image, clicks, flops: tuple[float, float],
                     label: str) -> dict:
    """13c: the cold and the warm click on the host's clock, in turns, and
    the encode and decode device ms with CUDA events; the encode share of
    the device time and the idle share of a cold click."""
    import numpy as np

    pts = clicks[0]

    def cold():
        concat, bbox = pred.prepare(image, pts)
        feats = pred.encode(concat[None, ..., :-1])
        prob = pred.decode(feats, concat[None, ..., -1:])[0]
        return pred.paste_back(prob, bbox, image.shape[:2]), feats, bbox

    _, feats, bbox = cold()

    def warm():
        g = pred.prepare_guidance(pts, bbox)
        prob = pred.decode(feats, g[None])[0]
        return pred.paste_back(prob, bbox, image.shape[:2])

    warm()
    cold_ms, warm_ms = [], []
    for _ in range(SESSION_CLICKS):
        t0 = time.perf_counter()
        cold()
        cold_ms.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        warm()
        warm_ms.append((time.perf_counter() - t0) * 1e3)
    concat, _ = pred.prepare(image, pts)
    x = torch.from_numpy(concat[None]).to(pred.device)
    rgb, g = x[..., :-1].contiguous(), x[..., -1:].contiguous()
    enc_ms, dec_ms = median_ms([lambda: pred.encode(rgb),
                                lambda: pred.decode_device(feats, g)])
    # one profiler session, each stage in a range of its own: the device
    # time of the kernels each range launched (a profiler per stage once
    # read 0 for the decode)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    stages = {"encode": lambda: pred.encode(rgb),
              "decode": lambda: pred.decode_device(feats, g), "cold": cold}
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        for name, fn in stages.items():
            t0 = time.perf_counter()
            with torch.profiler.record_function(f"sessions/{name}"):
                fn()
                torch.cuda.synchronize()
            window_ms = (time.perf_counter() - t0) * 1e3
    busy = {name: _op_device_ms(prof, (f"sessions/{name}",)) for name in stages}
    host = {"prepare_guidance": _host_ms(lambda: pred.prepare_guidance(pts, bbox)),
            "paste_back": _host_ms(lambda: pred.paste_back(
                pred.decode(feats, g)[0], bbox, image.shape[:2]))}
    p50_cold, p50_warm = statistics.median(cold_ms), statistics.median(warm_ms)
    flop_share = flops[0] / sum(flops)
    log(f"sessions (c) {label}: cold click p50 {p50_cold:.2f} ms, warm click p50 "
        f"{p50_warm:.2f} ms (warm / cold {p50_warm / p50_cold:.4f}), "
        f"{SESSION_CLICKS} each in turns; a lone launch of each stage, CUDA events "
        f"(median of 21): encode {enc_ms:.4f} ms, decode {dec_ms:.4f} ms (share "
        f"{enc_ms / (enc_ms + dec_ms):.4f}); profiler device busy: encode "
        f"{busy['encode']:.4f} ms, decode {busy['decode']:.4f} ms, encode share "
        f"{busy['encode'] / max(busy['encode'] + busy['decode'], 1e-9):.4f} "
        f"(reckoned 0.59; "
        f"FLOP counter {flop_share:.4f}: encode {flops[0] / 1e9:.1f} GFLOP, decode "
        f"{flops[1] / 1e9:.1f} GFLOP); one cold click: device busy "
        f"{busy['cold']:.2f} ms of {window_ms:.2f} ms, idle share "
        f"{1.0 - busy['cold'] / window_ms:.4f}; host ms prepare_guidance "
        f"{host['prepare_guidance']:.2f}, decode + read-back + paste_back "
        f"{host['paste_back']:.2f}")
    return {"cold_ms": p50_cold, "warm_ms": p50_warm, "encode_ms": enc_ms,
            "decode_ms": dec_ms}


def sessions_service(torch, ca, pred, image, clicks, InferenceService,
                     label: str) -> dict:
    """13d: 8 sessions, 3 warm clicks each, through ``InferenceService``.
    Returns the kernels' launches of the service's own calls: the bursts
    and the budget and out-of-crop clicks (every reference is computed
    before them, and the warm-up is left out)."""
    import numpy as np

    requests = _session_requests(clicks)
    prepared = [pred.prepare(image, pts) for pts in requests]
    concat = np.stack([c for c, _ in prepared])
    bboxes = [b for _, b in prepared]
    # references at the service's bucket: the stateless forward of the 8
    # crops, and the moved clicks' guidance decoded in the sessions' crops
    feats = pred.encode(concat[..., :-1])
    want = {0.0: [pred.paste_back(p, b, image.shape[:2]) for p, b in
                  zip(pred.decode(feats, concat[..., -1:]), bboxes)]}
    for moved in (1.0, 2.0):
        g = np.stack([pred.prepare_guidance(r + moved, b)
                      for r, b in zip(requests, bboxes)])
        want[moved] = [pred.paste_back(p, b, image.shape[:2])
                       for p, b in zip(pred.decode(feats, g), bboxes)]
    del feats
    single = [pred.predict(image, pts) for pts in requests]
    per = pred.feature_struct(1).nbytes
    # a long wait: each burst of 8 is one bucket-8 group
    svc = InferenceService(pred, max_batch=8, max_wait_s=1.0)
    svc.warmup()
    with svc, ThreadPoolExecutor(8) as pool:
        def burst(moved: float):
            futs = list(pool.map(
                lambda i: svc.submit(image, requests[i] + moved, session_id=f"s{i}"),
                range(8)))
            return [f.result(timeout=300) for f in futs]

        start = dict(svc.metrics.batch_buckets)
        counted = dict(ca.launches)
        cold = burst(0.0)
        cold_launches = _launches_since(ca, counted)
        snap = svc.health()["sessions"]
        if (snap["live"], snap["live_bytes"], snap["misses"]) != (8, 8 * per, 8):
            raise AssertionError(f"13d {label}: after 8 cold clicks {snap}; want 8 "
                                 f"live, {8 * per} bytes, 8 misses")
        before = dict(svc.metrics.batch_buckets)
        masks = {"cold": (cold, want[0.0])}
        warm_from = dict(ca.launches)
        for moved in (0.0, 1.0, 2.0):
            masks[f"warm {moved:g} px"] = (burst(moved), want[moved])
        warm_launches = _launches_since(ca, warm_from)
        after = dict(svc.metrics.batch_buckets)
        snap = svc.health()["sessions"]
    warm_groups = {b: after.get(b, 0) - before.get(b, 0) for b in after}
    if snap["hits"] != 24 or snap["misses"] != 8:
        raise AssertionError(f"13d {label}: {snap}; want 24 hits, 8 misses")
    if warm_groups != {8: 3} or before.get(8, 0) - start.get(8, 0) != 1:
        raise AssertionError(f"13d {label}: each burst must be one bucket-8 group "
                             f"({start} -> {before} -> {after})")
    if any(n != 1 for n in cold_launches.values()) or \
            any(n != 3 for n in warm_launches.values()):
        raise AssertionError(f"13d {label}: launches of the cold burst "
                             f"{cold_launches}, of the 3 warm bursts "
                             f"{warm_launches}; want 1 and 3 of each")
    diff = {name: max(float(np.abs(m - w).max()) for m, w in zip(got, ref))
            for name, (got, ref) in masks.items()}
    cross = max(float(np.abs(a - b).max()) for a, b in zip(single, want[0.0]))
    log(f"sessions (d) {label}: 8 sessions x (1 cold + 3 warm) clicks; live "
        f"{snap['live']} sessions, {snap['live_bytes']} bytes = 8 x "
        f"{per} ({per / 2**20:g} MiB a session); each burst one bucket-8 "
        f"group (warm decodes {warm_groups}), launches cold {cold_launches}, "
        f"warm {warm_launches}; max |diff| vs the bucket-8 references {diff} "
        f"(bitwise required); the same clicks at B = 1 differ from bucket 8 "
        f"by up to {cross:.3e}")
    if any(diff.values()):
        raise AssertionError(f"13d {label}: session masks are not bitwise the "
                             f"bucket-8 references: {diff}")
    check(f"13d {label} stateless B = 1 vs bucket 8", cross, SESSION_CROSS_TOL[label])

    with InferenceService(pred, max_batch=8, max_wait_s=0.0,
                          session_budget_bytes=3 * per) as svc:
        budget_from = dict(ca.launches)
        for i in range(4):
            svc.predict(image, requests[i], timeout=300, session_id=f"b{i}")
        snap = svc.health()["sessions"]
        if (snap["live"], snap["evictions"]["lru"]) != (3, 1) or \
                svc._store.get("b0") is not None:
            raise AssertionError(f"13d {label}: budget of 3 entries: {snap}")
        far = np.array([[5.0, 5.0], [40.0, 3.0], [75.0, 5.0], [40.0, 30.0]])
        moved = svc.predict(image, far, timeout=300, session_id="b3")
        plain = svc.predict(image, far, timeout=300)
        budget_launches = _launches_since(ca, budget_from)
        snap = svc.health()["sessions"]
        if snap["misses"] != 5 or not np.array_equal(moved, plain):
            raise AssertionError(f"13d {label}: an out-of-crop click must re-encode "
                                 f"and give the stateless mask: {snap}")
    log(f"sessions (d) {label}: a budget of 3 entries evicts the oldest of 4 "
        f"(lru {snap['evictions']['lru']}); an out-of-crop click re-encodes "
        f"(misses {snap['misses']}), bitwise the stateless mask; launches "
        f"{budget_launches}")
    return {k: cold_launches[k] + warm_launches[k] + budget_launches[k]
            for k in cold_launches}


def sessions_http(torch, ca, pred, image, clicks, InferenceService, make_server,
                  ServeClient) -> dict:
    """13e: a session over HTTP, and a 429 with ``code: session_lane``.
    Returns the kernels' launches of the HTTP calls (a stateless click, a
    session's cold click and two warm ones; the shed click launches
    nothing): exactly 4 of each."""
    import numpy as np

    from distributedpytorch_tpu_torch.serve.service import SessionLaneFullError

    svc = InferenceService(pred, max_batch=4, session_lane_depth=1).start()
    server = make_server(svc, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    gate = threading.Event()
    try:
        client = ServeClient(f"http://127.0.0.1:{server.server_port}", timeout_s=300)
        pts = clicks[1]
        counted = dict(ca.launches)
        plain = client.predict(image, pts)
        cold = client.predict(image, pts, session_id="h")
        t0 = time.perf_counter()
        warm = client.predict(image, pts, session_id="h")
        warm_ms = (time.perf_counter() - t0) * 1e3
        if not (np.array_equal(plain, cold) and np.array_equal(cold, warm)):
            raise AssertionError("13e: stateless, cold and warm HTTP masks differ")
        decode = pred.decode

        def gated(*a, **kw):
            gate.wait(timeout=60)
            return decode(*a, **kw)

        pred.decode = gated
        pending = ThreadPoolExecutor(1).submit(client.predict, image, pts,
                                               session_id="h")
        deadline = time.time() + 30
        while not svc._lanes.get("h") and time.time() < deadline:
            time.sleep(0.01)
        try:
            client.predict(image, pts, session_id="h")
            raise AssertionError("13e: a second queued click of one session "
                                 "was not shed at lane depth 1")
        except SessionLaneFullError as e:
            shed = str(e)
        gate.set()
        if not np.array_equal(pending.result(timeout=300), warm):
            raise AssertionError("13e: the gated warm click changed its mask")
        launches = _launches_since(ca, counted)
        if any(n != 4 for n in launches.values()):
            raise AssertionError(f"13e: launches of the HTTP calls {launches}; "
                                 "want 4 of each")
        health = client.health()
        log(f"sessions (e): HTTP stateless == cold == warm bitwise (warm round trip "
            f"{warm_ms:.2f} ms); a second click of one session at lane depth 1 -> "
            f"429 session_lane ({shed[:60]}...); /healthz sessions "
            f"{json.dumps(health['sessions'])}; launches {launches}")
        return launches
    finally:
        gate.set()
        pred.__dict__.pop("decode", None)
        server.shutdown()
        server.server_close()
        svc.stop()
        thread.join(timeout=30)


def sessions_fit(torch, ca, Predictor) -> dict:
    """13f: a head-injected fit (a ``Trainer`` in this process), served
    with a session."""
    import shutil
    import tempfile

    import numpy as np

    from distributedpytorch_tpu_torch.serve.service import InferenceService

    work = Path(tempfile.mkdtemp(prefix="chip_smoke_sessions_"))
    try:
        t0 = time.perf_counter()
        run = _in_process_fit(torch, _trainer_args(SESSION_FIT_ARGS)
                              + [f"work_dir={work}"])
        rec = _run_record(run)
        final = rec["summary"]["final_step"]
        losses = [x for r in rec["epochs"] for x in r["train/step_losses"]]
        launches = rec["summary"]["kernel_launches"]
        want = final + sum(int(r["val/n_samples"]) for r in rec["vals"])
        if final != 2 or not all(x is not None and math.isfinite(x) for x in losses):
            raise AssertionError(f"13f: {final} steps, losses {losses}")
        if any(n != want for n in launches.values()):
            raise AssertionError(f"13f: launches {launches}, want {want} each")
        pred = Predictor.from_run(str(run), device="cuda")
        image, clicks = synthetic_image()
        with InferenceService(pred, max_batch=2) as svc:
            plain = svc.predict(image, clicks[0], timeout=300)
            cold = svc.predict(image, clicks[0], timeout=300, session_id="f")
            warm = svc.predict(image, clicks[0], timeout=300, session_id="f")
            snap = svc.health()["sessions"]
        if not (pred.supports_sessions and np.array_equal(plain, cold)
                and np.array_equal(cold, warm) and snap["hits"] == 1
                and np.isfinite(warm).all()):
            raise AssertionError(f"13f: the fit's run does not serve a session: {snap}")
        log(f"sessions (f): `{' '.join(SESSION_FIT_ARGS)}`: {final} steps in "
            f"{time.perf_counter() - t0:.1f} s wall, losses "
            f"{[round(x, 6) for x in losses]}, val jaccard "
            f"{[round(r['val/jaccard'], 6) for r in rec['vals']]}, launches "
            f"{launches}; Predictor.from_run serves it in "
            f"{str(pred.dtype).removeprefix('torch.')}: a session's warm click "
            f"bitwise the stateless one, {snap['live_bytes']} bytes cached")
        return launches
    finally:
        shutil.rmtree(work, ignore_errors=True)


def phase_sessions(torch, ca, Predictor, InferenceService, make_server,
                   ServeClient) -> dict:
    """Phase 13 (a-f); returns the launch counts of the session serving
    path (13d's service calls and 13e's HTTP calls, both dtypes) and of the
    head-injected fit."""
    t0 = time.perf_counter()
    pred = Predictor.fresh(512, "resnet101", seed=0, device="cuda",
                           guidance_inject="head")
    drawn = {n: float(p.detach().abs().max())
             for n, p in pred.model.named_parameters()
             if n.endswith("gamma") or n.startswith("guidance_proj")}
    if not all(v > 0 for v in drawn.values()):
        raise AssertionError(f"13: a gate or the guidance projection is zero: {drawn}")
    image, clicks = synthetic_image()
    flops = _stage_flops(torch)
    launches = dict.fromkeys(TPU_KERNELS, 0)
    for label, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        if dtype != torch.float32:
            pred = Predictor(pred.model, resolution=(512, 512), device="cuda",
                             dtype=dtype)
        log(f"sessions: DANet-R101 512^2 guidance_inject=head, {label}, fresh seed "
            f"0 (|gate|, max |guidance_proj| {drawn}); feature_struct(1) "
            f"{pred.feature_struct(1)}")
        sessions_stages(torch, ca, pred, image, clicks, label)
        sessions_latency(torch, pred, image, clicks, flops, label)
        counted = [sessions_service(torch, ca, pred, image, clicks,
                                    InferenceService, label)]
        if label == "float32":
            counted.append(sessions_http(torch, ca, pred, image, clicks,
                                         InferenceService, make_server, ServeClient))
        for path in counted:
            for k in launches:
                launches[k] += path[k]
        log(f"sessions: {label} done at {time.perf_counter() - t0:.1f} s")
    del pred
    gc.collect()
    torch.cuda.empty_cache()
    fit = sessions_fit(torch, ca, Predictor)
    log(f"sessions: (f) done; phase wall time {time.perf_counter() - t0:.1f} s")
    return {"sessions": launches, "sessions_fit": fit}


#: 14a: the position branch's forms held to the full plain form, each
#: with its ``pam_block_size``; the bounds of phases 2 (forward) and 6a/6d
#: (gradients)
PAM_FORMS = {"blocked 512": ("einsum", 512), "blocked 1000": ("einsum", 1000),
             "flash, block 128": ("flash", 128)}
PAM_FORM_TOL = {"float32": (1e-4, 1e-3), "bfloat16": (2e-2, 2e-2)}
PAM_GRAD_SCALE_OF = {"key.bias": "key.weight"}
#: 14b: moe_ffn against moe_ffn_dense in float32 (TF32 off), relative to
#: the dense form's largest value: the two sum the same products in
#: another order
MOE_TOL = 1e-4
#: 14c: the MoE fit, 2 steps of B = 8 at 512² in bf16 (one step an epoch
#: on the fixture's 11 objects), one validation of its 8 val samples
MOE_FIT_ARGS = ["--fake-data", "train.precision=bfloat16", "data.train_batch=8",
                "data.area_thres=0", "epochs=2", "eval_every=2",
                "model.moe_experts=4", "model.moe_k=2"]
#: 14c's second fit: the blocked plain position form, so no PAM launch
EINSUM_FIT_ARGS = ["model.pam_impl=einsum", "model.pam_block_size=1024"]
#: the paths on which a kernel is not meant to run
PATHS_WITHOUT = {"head_knobs_einsum": ("position_attention",),
                 "host_data_semantic": tuple(TPU_KERNELS)}


def _pam_module(torch, dtype, seed: int = 0):
    """DANet-R101's position branch at its width (C = 512: Ck = 64, Cv =
    512), weights drawn from ``seed`` as flax draws them, the gate 1."""
    from distributedpytorch_tpu_torch.models.danet import PositionAttentionModule
    from distributedpytorch_tpu_torch.models.resnet import flax_init_, set_compute_dtype

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        module = flax_init_(PositionAttentionModule(512))
    with torch.no_grad():
        module.gamma.fill_(1.0)
    set_compute_dtype(module, dtype)
    return module.cuda()


def head_knobs_pam(torch, ca) -> None:
    """14a: the PAM forms at B = 2, N = 4096, f32 and bf16."""
    for label, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        module = _pam_module(torch, dtype)
        x = torch.randn(2, 512, 64, 64, generator=torch.Generator().manual_seed(1))
        x = x.to("cuda", dtype)

        def run(impl, block):
            module.impl, module.block_size = impl, block
            xx = x.detach().requires_grad_()
            before = dict(ca.launches)
            out = module(xx)
            fwd = _launches_since(ca, before)["position_attention"]
            out.float().square().sum().backward()
            grads = {"x": xx.grad, **{n: p.grad.clone()
                                      for n, p in module.named_parameters()}}
            module.zero_grad(set_to_none=True)
            return out.detach().float(), grads, fwd

        with _uncounted(ca):
            ref, ref_grads, n = run("einsum", None)
            if n:
                raise AssertionError(f"14a: the full plain form launched {n} PAM kernels")
            tol, gtol = PAM_FORM_TOL[label]
            for form, (impl, block) in PAM_FORMS.items():
                out, grads, n = run(impl, block)
                want = 1 if impl == "flash" else 0
                if n != want:
                    raise AssertionError(f"14a {form} {label}: {n} PAM launches a "
                                         f"forward, want {want}")
                check(f"14a {form} {label} forward", (out - ref).abs().max().item(),
                      tol * ref.abs().max().item())
                # the key bias's gradient is 0 in exact arithmetic (a
                # softmax is blind to a per-row constant): scaled as 6a does
                worst = max((g.float() - ref_grads[k].float()).abs().max().item()
                            / ref_grads[PAM_GRAD_SCALE_OF.get(k, k)].float().abs().max().item()
                            for k, g in grads.items())
                check(f"14a {form} {label} gradients (worst tensor, relative)",
                      worst, gtol)
            forms = {"full": ("einsum", None), **PAM_FORMS}

            def timed(impl, block):
                def call():
                    module.impl, module.block_size = impl, block
                    with torch.no_grad():
                        module(x)
                return call

            ms = median_ms([timed(*f) for f in forms.values()], reps=7)
        module.impl, module.block_size = "auto", None
        log(f"head_knobs (a): PAM forms at B=2 N=4096 Ck=64 Cv=512 {label}, forward ms "
            + ", ".join(f"{f} {t:.4f}" for f, t in zip(forms, ms)))


def head_knobs_moe(torch) -> None:
    """14b: ``moe_ffn`` against ``moe_ffn_dense`` at DANet-R101's head width,
    B = 1 (N = 4096 tokens, d = h = 512, E = 4)."""
    from distributedpytorch_tpu_torch.parallel import moe

    g = torch.Generator().manual_seed(2)
    mlp = moe.MoEMlp(512, 4, 512, generator=g)
    with torch.no_grad():
        for b in (mlp.b1, mlp.b2):
            b.normal_(0.0, 0.1, generator=g)
    mlp.cuda()
    x0 = torch.randn(4096, 512, generator=g).cuda()
    for k in (1, 2):
        for factor in (1.25, 0.5):
            n, e = x0.shape[0], 4
            cap = moe.expert_capacity(n, e, factor)
            route = moe.router(x0, mlp.w_gate, k=k, capacity=cap)
            dispatch, _, aux_dense = moe.router_dense(x0, mlp.w_gate.detach(), k=k,
                                                      capacity=cap)
            rows = torch.arange(n, device="cuda").expand(k, n)[route.keep]
            kept = dispatch[rows, route.expert[route.keep], route.slot[route.keep]]
            if not (bool((kept == 1).all()) and int(dispatch.sum()) == int(route.keep.sum())):
                raise AssertionError(f"14b k={k} factor {factor}: the routing differs "
                                     "from the dense form's")
            results, peaks = {}, {}
            for name in ("moe_ffn", "moe_ffn_dense"):
                fn = getattr(moe, name)
                params = {p: t.detach().clone().requires_grad_()
                          for p, t in mlp.params().items()}
                x = x0.clone().requires_grad_()
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                base = torch.cuda.memory_allocated()
                y, aux = fn(params, x, k=k, capacity_factor=factor)
                (y.square().sum() + aux).backward()
                torch.cuda.synchronize()
                peaks[name] = (torch.cuda.max_memory_allocated() - base) / 2**20
                results[name] = [y.detach(), aux.detach(), x.grad,
                                 *(params[p].grad for p in moe.PARAM_NAMES)]
            worst = max((a - b).abs().max().item() / max(b.abs().max().item(), 1e-30)
                        for a, b in zip(*results.values()))
            check(f"14b k={k} factor {factor} output, aux and gradients "
                  "(worst tensor, relative)", worst, MOE_TOL)
            if abs(float(aux_dense) - float(results["moe_ffn"][1])) > 1e-6:
                raise AssertionError(f"14b: aux {float(aux_dense)} vs "
                                     f"{float(results['moe_ffn'][1])}")

            def fwd_bwd(name):
                fn = getattr(moe, name)
                params = {p: t.detach().requires_grad_() for p, t in mlp.params().items()}
                x = x0.detach().requires_grad_()

                def call():
                    y, aux = fn(params, x, k=k, capacity_factor=factor)
                    (y.square().sum() + aux).backward()
                return call

            ms = median_ms([fwd_bwd("moe_ffn"), fwd_bwd("moe_ffn_dense")], reps=7)
            log(f"head_knobs (b): k={k} factor {factor}: capacity {cap}, kept "
                f"{int(route.keep.sum())} of {k * n} choices, aux {float(aux_dense):.6f}; "
                f"forward+backward ms moe_ffn {ms[0]:.4f}, dense {ms[1]:.4f}; peak "
                f"memory above the inputs MiB moe_ffn {peaks['moe_ffn']:.1f}, dense "
                f"{peaks['moe_ffn_dense']:.1f}")
    # the B = 8 step's token count (N = 32768, k = 2, factor 1.25): the
    # index form alone (the dense one would hold two 5.4 GB tensors)
    x0 = torch.randn(8 * 4096, 512, generator=g).cuda().requires_grad_()
    params = {p: t.detach().requires_grad_() for p, t in mlp.params().items()}

    def call():
        y, aux = moe.moe_ffn(params, x0, k=2, capacity_factor=1.25)
        (y.square().sum() + aux).backward()

    (ms,) = median_ms([call], reps=7)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        call()
        torch.cuda.synchronize()
    by_name: dict[str, float] = {}
    for e in _device_events(prof):
        by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time_total / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    log(f"head_knobs (b): N=32768 k=2 factor 1.25 moe_ffn forward+backward {ms:.4f} "
        f"ms, device busy {sum(by_name.values()):.4f} ms; top kernels "
        + "; ".join(f"{name[:60]} {t:.4f} ms" for name, t in top))


def head_knobs_step(torch, ca, batch_size: int = 8, rounds: int = 5) -> None:
    """14c (in process): the bf16 B = 8 step of DANet-R101 with
    ``moe_experts=4 moe_k=2`` against the same model without its MoE, in
    turns; the step's loss holds the aux term."""
    from distributedpytorch_tpu_torch.models import build_model
    from distributedpytorch_tpu_torch.ops.losses import multi_output_loss
    from distributedpytorch_tpu_torch.parallel.step import (
        _forward,
        create_train_state,
        make_train_step,
    )
    from distributedpytorch_tpu_torch.train.config import OptimConfig
    from distributedpytorch_tpu_torch.train.optim import make_optimizer
    from distributedpytorch_tpu_torch.train.precision import precision_policy

    policy = precision_policy("bfloat16")
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = build_model("danet", dtype="bfloat16", moe_experts=4, moe_k=2)
    optimizer, schedule = make_optimizer(OptimConfig(), model, total_steps=100)
    state = create_train_state(model, optimizer, schedule, 0, torch.device("cuda"))
    step = make_train_step(precision=policy, aux_loss_weight=0.01)
    g = torch.Generator(device="cuda").manual_seed(3)
    batch = {"concat": torch.rand(batch_size, 4, 512, 512, device="cuda",
                                  generator=g) * 255,
             "crop_gt": (torch.rand(batch_size, 1, 512, 512, device="cuda",
                                    generator=g) < 0.3).float()}
    # the step's loss is the task loss plus 0.01 x the aux, on the same
    # dropout masks (a copy of the state's generator)
    saved = state.generator.get_state()
    with torch.no_grad():
        outs, aux = _forward(model.train(), batch["concat"], policy, state.generator,
                             with_aux=True)
        task = multi_output_loss(outs, batch["crop_gt"]).item()
    state.generator.set_state(saved)
    loss = step(state, batch).item()
    aux = aux.item()
    log(f"head_knobs (c): first MoE step loss {loss:.6f}, task loss {task:.6f} + "
        f"0.01 x aux {aux:.6f} = {task + 0.01 * aux:.6f}")
    if not (math.isfinite(loss) and abs(loss - (task + 0.01 * aux)) < 0.25 * 0.01 * aux):
        raise AssertionError(f"14c: the step's loss {loss} is not the task loss "
                             f"{task} + 0.01 x aux {aux}")
    moe_module = model.head.moe
    variants = {"moe": moe_module, "no moe": None}
    times = {k: [] for k in variants}
    peak = {}
    before = dict(ca.launches)
    for r in range(rounds + 1):
        for label, m in variants.items():
            model.head.moe = m
            if r == 0:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            step(state, batch)
            end.record()
            end.synchronize()
            if r == 0:
                peak[label] = torch.cuda.max_memory_allocated() / 2**30
            else:
                times[label].append(start.elapsed_time(end))
    model.head.moe = moe_module
    rise = _launches_since(ca, before)
    if any(n != 2 * (rounds + 1) for n in rise.values()):
        raise AssertionError(f"14c: {2 * (rounds + 1)} steps launched {rise}")
    ms = {k: statistics.median(t) for k, t in times.items()}
    log(f"head_knobs (c): bf16 B={batch_size} 512^2 step, median of {rounds} in "
        f"turns: MoE (E=4, k=2) {ms['moe']:.2f} ms (all "
        f"{', '.join(f'{t:.2f}' for t in times['moe'])}), peak {peak['moe']:.2f} GiB; "
        f"without {ms['no moe']:.2f} ms (all "
        f"{', '.join(f'{t:.2f}' for t in times['no moe'])}), peak "
        f"{peak['no moe']:.2f} GiB; MoE / without {ms['moe'] / ms['no moe']:.4f}")


def head_knobs_fit(torch, ca, Predictor, work: Path, *extra: str,
                   cli: bool = True) -> tuple[dict, object]:
    """14c: a MoE fit through the CLI (or, without ``cli``, a ``Trainer``
    in this process), then ``Predictor.from_run`` serving one batch of 4
    click sets; the fit's launches plus the served batch's."""
    import numpy as np

    t0 = time.perf_counter()
    if cli:
        cmd = [sys.executable, "-m", "distributedpytorch_tpu_torch", *MOE_FIT_ARGS,
               *extra, f"work_dir={work}"]
        proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                              timeout=600)
        if proc.returncode != 0:
            raise AssertionError(f"14c: the fit exited {proc.returncode}:\n"
                                 f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
        (run,) = work.glob("run_*")
    else:
        run = _in_process_fit(torch, _trainer_args(MOE_FIT_ARGS) + [
            *extra, f"work_dir={work}"])
    rec = _run_record(run)
    final = rec["summary"]["final_step"]
    losses = [x for r in rec["epochs"] for x in r["train/step_losses"]]
    launches = rec["summary"]["kernel_launches"]
    n_val = sum(int(r["val/n_samples"]) for r in rec["vals"])
    if final != 2 or n_val != 8 or not all(
            x is not None and math.isfinite(x) for x in losses):
        raise AssertionError(f"14c: {final} steps, {n_val} val samples, losses {losses}")
    pred = Predictor.from_run(str(run), device="cuda")
    image, clicks = synthetic_image()
    before = dict(ca.launches)
    masks = pred.predict_batch(image, clicks)
    served = _launches_since(ca, before)
    if not all(m.shape == image.shape[:2] and np.isfinite(m).all() for m in masks):
        raise AssertionError("14c: the served masks are not finite")
    total = {k: launches[k] + served[k] for k in TPU_KERNELS}
    log(f"head_knobs (c): `{' '.join(MOE_FIT_ARGS + list(extra))}`: {final} steps in "
        f"{time.perf_counter() - t0:.1f} s wall, losses {[round(x, 6) for x in losses]}, "
        f"val jaccard {[round(r['val/jaccard'], 6) for r in rec['vals']]}, fit launches "
        f"{launches}, served batch of {len(clicks)} launches {served}")
    return total, pred.model


def phase_head_knobs(torch, ca, Predictor) -> dict:
    """Phase 14 (a-c); returns the launch counts of the MoE fit and serve,
    with the kernel and with the blocked plain position form."""
    import shutil
    import tempfile

    t0 = time.perf_counter()
    head_knobs_pam(torch, ca)
    head_knobs_moe(torch)
    head_knobs_step(torch, ca)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"head_knobs: (a-b) and the step done at {time.perf_counter() - t0:.1f} s")
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_head_knobs_"))
    try:
        moe_path, model = head_knobs_fit(torch, ca, Predictor, work / "moe")
        want = {k: 2 + 8 + 1 for k in TPU_KERNELS}
        if moe_path != want or model.head.moe is None:
            raise AssertionError(f"14c: MoE launches {moe_path}, want {want}")
        einsum_path, model = head_knobs_fit(torch, ca, Predictor, work / "einsum",
                                            *EINSUM_FIT_ARGS, cli=False)
        want["position_attention"] = 0
        if einsum_path != want or (model.head.pam.impl, model.head.pam.block_size) \
                != ("einsum", 1024):
            raise AssertionError(f"14c: einsum launches {einsum_path}, want {want}")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    log(f"head_knobs: phase wall time {time.perf_counter() - t0:.1f} s")
    return {"head_knobs_moe": moe_path, "head_knobs_einsum": einsum_path}


#: phase 15's host guidance families (``data.guidance``) and each one's
#: bound against the port's device form on the same mask and fixed
#: points: the JAX package's own pair's (tests/test_device_guidance.py),
#: 0.5 on [0, 255], 2e-3 for ``extreme_points`` on [0, 1]
HOST_FAMILIES = ("nellipse_gaussians", "nellipse", "extreme_points",
                 "confidence_l1l2", "confidence_gaussian")
HOST_DEVICE_TOL = {"extreme_points": 2e-3}
#: 15b's fit: the default DANet-R101 512² float32 fit on the fake fixture
#: with DEXTR's extreme-point guidance and SBD merged, one epoch of B = 4
HOST_DATA_ARGS = ["--fake-data", "data.guidance=extreme_points",
                  "data.train_batch=4", "data.area_thres=0", "epochs=1"]
#: 15d's fit: DeepLabV3-R101 at 513² in bf16 on the fake fixture with SBD
SBD_SEMANTIC_ARGS = ["data.fake=true", "task=semantic", "model.name=deeplabv3",
                     "model.nclass=21", "model.in_channels=3",
                     "data.crop_size=[513,513]", "train.precision=bfloat16",
                     "data.train_batch=4", "epochs=1"]
#: the fake SBD tree: 4 images at SBD's usual 375x500, one of them val,
#: plus the fake VOC's val images written into its train split
SBD_SIZE = (375, 500)
#: the JAX package's refusal of a run whose guidance clicks cannot give
CONFIDENCE_REFUSAL = ("this run's guidance family ('confidence_l1l2') is not "
                      "derivable from clicks alone (confidence maps need the gt "
                      "mask; 'none' has no channel) — click-based prediction "
                      "does not apply to it")


def host_data_families(torch) -> None:
    """15a: each host guidance family on 512² crops of 375x500 fake masks
    against the port's device form (fixed points), and the host's ms per
    sample: the family's val stage on a cached crop, and the whole train
    stack (flip, scale-rotate, crop, resize, guidance) from the image."""
    import numpy as np

    from distributedpytorch_tpu_torch.data import pipeline, voc
    from distributedpytorch_tpu_torch.data import transforms as T
    from distributedpytorch_tpu_torch.ops import guidance_device

    tree = host_tree(8, SBD_SIZE, seed=0)
    crops = voc.VOCInstanceSegmentation(
        tree, split="train", area_thres=0,
        transform=T.Compose(pipeline.build_crop_stage((512, 512), 50, True)))
    samples = [crops[i] for i in range(min(len(crops), 12))]
    masks = np.stack([s["crop_gt"] for s in samples]).astype(np.float32)
    dev_masks = torch.from_numpy(masks).to("cuda")
    parts = []
    for family in HOST_FAMILIES:
        stage = T.Compose(pipeline._guidance_stage(family, 0.6, is_val=True))
        host, ms = [], []
        for s in samples:
            t0 = time.perf_counter()
            out = stage({"crop_image": s["crop_image"], "crop_gt": s["crop_gt"]})
            ms.append((time.perf_counter() - t0) * 1e3)
            host.append(out["concat"][..., 3])
        with torch.inference_mode():
            dev = guidance_device.guidance_map(dev_masks, family=family,
                                               is_val=True).cpu().numpy()
        torch.cuda.synchronize()
        gap = float(np.abs(dev - np.stack(host)).max())
        check(f"15a {family}, host vs device form, max |diff|", gap,
              HOST_DEVICE_TOL.get(family, 0.5))
        train = voc.VOCInstanceSegmentation(
            tree, split="train", area_thres=0,
            transform=pipeline.build_train_transform(crop_size=(512, 512),
                                                     guidance=family))
        stack_ms = []
        for i in range(len(samples)):
            t0 = time.perf_counter()
            x = train.__getitem__(i, rng=pipeline.sample_rng(0, 0, i))
            stack_ms.append((time.perf_counter() - t0) * 1e3)
            if x["concat"].shape != (512, 512, 4) or not np.isfinite(x["concat"]).all():
                raise AssertionError(f"15a {family}: concat {x['concat'].shape}")
        parts.append(f"{family} stage {statistics.median(ms):.2f} ms, train stack "
                     f"{statistics.median(stack_ms):.2f} ms, max |host - device| "
                     f"{gap:.3e}")
    log(f"host_data (a): {len(samples)} crops of 512² from {SBD_SIZE[0]}x"
        f"{SBD_SIZE[1]}, median ms per sample on one host thread: "
        + "; ".join(parts))


def _fake_sbd(root: Path) -> tuple[list[str], int, int]:
    """The fake SBD tree under ``root`` (the port's writer), the fake VOC
    val ids it repeats, and the instance and semantic lengths of the
    combined train sets ``--fake-data`` builds, counted here part by part:
    VOC train, plus SBD less the VOC val ids."""
    from distributedpytorch_tpu_torch.data import (
        SBDInstanceSegmentation,
        SBDSemanticSegmentation,
        VOCInstanceSegmentation,
        fake,
        make_fake_sbd,
    )

    voc_tree = fake.make_fake_voc(n_images=8, size=(96, 128), n_val=3, seed=0)
    val_ids = voc_tree.split_ids("val")
    make_fake_sbd(str(root), n_images=4, size=SBD_SIZE, n_val=1, seed=0,
                  overlap_ids=val_ids)
    inst = SBDInstanceSegmentation(str(root), split=["train", "val"])
    sem = SBDSemanticSegmentation(str(root), split=["train", "val"])
    n_inst = len(VOCInstanceSegmentation(voc_tree, split="train")) + sum(
        inst.sample_image_id(i) not in val_ids for i in range(len(inst)))
    n_sem = len(voc_tree.split_ids("train")) + sum(
        im_id not in val_ids for im_id in sem.im_ids)
    return val_ids, n_inst, n_sem


def _param_report(run: Path) -> dict:
    """The run's parameter report, ``key: value`` per line."""
    from distributedpytorch_tpu_torch.train.config import from_json

    cfg = from_json(str(run / "config.json"))
    with open(run / f"{cfg.experiment_name}.txt") as f:
        return dict(line.rstrip("\n").split(": ", 1) for line in f if ": " in line)


def _combined_fit_checks(tag: str, run: Path, n_train: int,
                         batch: int = 4) -> tuple[dict, list, list]:
    """A one-epoch fit over a combined set of ``n_train`` samples: the
    param report names it, one step per full batch, finite losses, one
    validation with its metric in [0, 1].  Returns the summary, losses and
    validation records."""
    rec = _run_record(run)
    final = rec["summary"]["final_step"]
    losses = [x for r in rec["epochs"] for x in r["train/step_losses"]]
    train_set = _param_report(run)["train_set"]
    if not (train_set.startswith("Combined(") and train_set.endswith(f", n={n_train})")):
        raise AssertionError(f"{tag}: train_set {train_set}, want Combined(..., "
                             f"n={n_train})")
    if final != n_train // batch or len(losses) != final or not all(
            x is not None and math.isfinite(x) for x in losses):
        raise AssertionError(f"{tag}: {final} steps over {n_train} samples, losses "
                             f"{losses}")
    if len(rec["vals"]) != 1 or not 0.0 <= rec["vals"][0]["val/jaccard"] <= 1.0:
        raise AssertionError(f"{tag}: validations {rec['vals']}")
    return rec["summary"], losses, rec["vals"]


def host_data_fit(torch, ca, Predictor, work: Path, sbd: Path,
                  n_train: int) -> dict:
    """15b: the fit (a ``Trainer`` in this process) with
    ``data.guidance=extreme_points`` and ``data.sbd_root``, served by
    ``Predictor.from_run``; its launches plus the served batch's."""
    import numpy as np

    t0 = time.perf_counter()
    run = _in_process_fit(torch, _trainer_args(HOST_DATA_ARGS)
                          + [f"data.sbd_root={sbd}", f"work_dir={work}"])
    wall = time.perf_counter() - t0
    summary, losses, vals = _combined_fit_checks("15b", run, n_train)
    launches = summary["kernel_launches"]
    want = summary["final_step"] + int(vals[0]["val/n_samples"])
    if any(v != want for v in launches.values()):
        raise AssertionError(f"15b: launches {launches}, want {want} each")
    pred = Predictor.from_run(str(run), device="cuda")
    if pred.guidance != "extreme_points":
        raise AssertionError(f"15b: served with {pred.guidance}")
    image, clicks = synthetic_image()
    before = dict(ca.launches)
    masks = pred.predict_batch(image, clicks)
    served = _launches_since(ca, before)
    if any(v != 1 for v in served.values()) or not all(
            m.shape == image.shape[:2] and np.isfinite(m).all() for m in masks):
        raise AssertionError(f"15b: the served batch launched {served}")
    log(f"host_data (b): `{' '.join(HOST_DATA_ARGS)} data.sbd_root=...`: "
        f"{wall:.1f} s wall; train_set {_param_report(run)['train_set']}; "
        f"{summary['final_step']} steps, losses {[round(x, 6) for x in losses]}, val "
        f"jaccard {round(vals[0]['val/jaccard'], 6)} over "
        f"{int(vals[0]['val/n_samples'])} samples; fit launches {launches} = {want} "
        f"each, exact; Predictor.from_run (extreme_points) served a batch of "
        f"{len(clicks)} click sets, launches {served}")
    del pred
    return {k: launches[k] + served[k] for k in TPU_KERNELS}


def _trainer_args(cli_args: list[str]) -> list[str]:
    """The ``Config`` overrides of a CLI argument list (``--fake-data`` is
    ``data.fake=true``)."""
    return ["data.fake=true" if a == "--fake-data" else a for a in cli_args]


def _in_process_fit(torch, overrides: list[str]) -> Path:
    """A ``Trainer`` fit on the card in this process, writing its records
    to ``metrics.jsonl`` only unless ``overrides`` name the writers;
    returns its run."""
    from distributedpytorch_tpu_torch.train.config import Config, apply_overrides
    from distributedpytorch_tpu_torch.train.trainer import Trainer

    tr = Trainer(apply_overrides(Config(), ['log_writers=["jsonl"]', *overrides]),
                 device="cuda")
    try:
        tr.fit()
    finally:
        tr.close()
    run = Path(tr.run_dir)
    del tr
    gc.collect()
    torch.cuda.empty_cache()
    return run


def host_data_confidence(torch, Predictor, work: Path, sbd: Path,
                         n_train: int) -> dict:
    """15c: 15b's fit with ``data.guidance=confidence_l1l2`` (a ``Trainer``
    in this process), and ``Predictor.from_run`` refusing it with the JAX
    package's message; the fit's launches."""
    t0 = time.perf_counter()
    run = _in_process_fit(torch, _trainer_args(HOST_DATA_ARGS)
                          + ["data.guidance=confidence_l1l2", f"data.sbd_root={sbd}",
                             f"work_dir={work}"])
    wall = time.perf_counter() - t0
    summary, losses, vals = _combined_fit_checks("15c", run, n_train)
    launches = summary["kernel_launches"]
    want = summary["final_step"] + int(vals[0]["val/n_samples"])
    if any(v != want for v in launches.values()):
        raise AssertionError(f"15c: launches {launches}, want {want} each")
    try:
        Predictor.from_run(str(run), device="cuda")
    except ValueError as e:
        if str(e) != CONFIDENCE_REFUSAL:
            raise AssertionError(f"15c: from_run refused with {e!r}") from e
    else:
        raise AssertionError("15c: from_run served a confidence_l1l2 run")
    log(f"host_data (c): data.guidance=confidence_l1l2 with SBD: {wall:.1f} s wall, "
        f"{summary['final_step']} steps, losses {[round(x, 6) for x in losses]}, val "
        f"jaccard {round(vals[0]['val/jaccard'], 6)}; launches {launches} = {want} "
        f"each, exact; Predictor.from_run refused it with the JAX message")
    return launches


def host_data_semantic(torch, work: Path, sbd: Path, n_train: int) -> dict:
    """15d: DeepLabV3-R101 with ``data.sbd_root`` (a ``Trainer`` in this
    process): the combined semantic set, finite losses, no attention
    kernel launched."""
    t0 = time.perf_counter()
    run = _in_process_fit(torch, SBD_SEMANTIC_ARGS + [f"data.sbd_root={sbd}",
                                                      f"work_dir={work}"])
    wall = time.perf_counter() - t0
    summary, losses, vals = _combined_fit_checks("15d", run, n_train)
    launches = summary["kernel_launches"]
    if any(launches.values()):
        raise AssertionError(f"15d: launches {launches}, want none")
    log(f"host_data (d): `{' '.join(SBD_SEMANTIC_ARGS)} data.sbd_root=...`: "
        f"{wall:.1f} s wall; train_set {_param_report(run)['train_set']}; "
        f"{summary['final_step']} steps, losses {[round(x, 6) for x in losses]}, "
        f"val mIoU {round(vals[0]['val/miou'], 6)}; launches {launches}")
    return launches


def phase_host_data(torch, ca, Predictor) -> dict:
    """Phase 15 (a-d); returns the launch counts of 15b (fit and served
    batch), 15c and 15d."""
    import shutil
    import tempfile

    t0 = time.perf_counter()
    host_data_families(torch)
    log(f"host_data: (a) done at {time.perf_counter() - t0:.1f} s")
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_host_data_"))
    try:
        val_ids, n_inst, n_sem = _fake_sbd(work / "sbd")
        log(f"host_data: fake SBD tree ({SBD_SIZE[0]}x{SBD_SIZE[1]}) repeating the "
            f"fake VOC val ids {val_ids}: combined train sets of {n_inst} instance "
            f"and {n_sem} semantic samples expected")
        paths = {"host_data_extreme_points": host_data_fit(
            torch, ca, Predictor, work / "extreme_points", work / "sbd", n_inst)}
        paths["host_data_confidence"] = host_data_confidence(
            torch, Predictor, work / "confidence", work / "sbd", n_inst)
        paths["host_data_semantic"] = host_data_semantic(
            torch, work / "semantic", work / "sbd", n_sem)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"host_data: phase wall time {time.perf_counter() - t0:.1f} s")
    return paths


#: 16b: after the retire, allocated memory within this of its level
#: before the swap, less one weight set
SWAP_FREE_TOL = 16 << 20
#: 16d: warm clicks on each side (before the swap; in the window, in
#: turns with the canary's session), held to the 100 ms request budget
SWAP_CLICKS = 20
LATENCY_BUDGET_MS = 100.0
#: 16a and 16b: the pre-swap session's idle time allowed before it
#: expires; above the swap's warm-up, so the session lives through it
SWAP_SESSION_TTL_S = 2.5
#: 16a: a new session's mask against generation 1's own Predictor.predict
SWAP_NEW_TOL = 1e-4
#: 16e: each feature map of the deep-stem backbone in float32 against
#: float64 on the card, relative to its largest value (9b's bound)
DEEP_STEM_TOL = 1e-3


def _weight_bytes(model) -> int:
    """Bytes of the parameters and buffers, each at its own dtype's size:
    one generation's weight set (an int8 one's quantized weights are
    buffers)."""
    return sum(t.numel() * t.element_size()
               for t in (*model.parameters(), *model.buffers()))


def _held(torch, svc) -> tuple[int, int]:
    """(allocated bytes, the session store's bytes) on the card."""
    torch.cuda.synchronize()
    return torch.cuda.memory_allocated(), svc.health()["sessions"]["live_bytes"]


def _wait_retired(svc, gen: int, timeout: float = 30.0) -> float:
    """Seconds until ``gen`` reads retired in ``health()["swap"]`` and the
    service's predictor is off it (the worker's 1 Hz sweep)."""
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < timeout:
        states = {g["gen"]: g["state"] for g in svc.health()["swap"]["generations"]}
        if states.get(gen) == "retired" and svc._pool.is_resident(svc.predictor):
            return time.perf_counter() - t0
        time.sleep(0.05)
    raise AssertionError(f"16: generation {gen} not retired in {timeout} s: "
                         f"{svc.health()['swap']}")


def swap_window(torch, ca, svc, state7, image, clicks) -> dict:
    """16a, 16b and 16d: a session before the swap, generation 1 loaded
    from ``state7`` and swapped in at ``canary_fraction=1.0``, the window
    (the old session's warm clicks in turns with a new session's), the
    promote and the retire.  Returns the launches of generation 0's and
    generation 1's requests and the figures."""
    import numpy as np

    from distributedpytorch_tpu_torch.serve.swap import load_swap_predictor

    def click(sid, pts):
        counted = dict(ca.launches)
        t0 = time.perf_counter()
        mask = svc.predict(image, pts, timeout=300, session_id=sid)
        return mask, (time.perf_counter() - t0) * 1e3, _launches_since(ca, counted)

    by_gen = {0: dict.fromkeys(TPU_KERNELS, 0), 1: dict.fromkeys(TPU_KERNELS, 0)}

    def book(gen, launches):
        for k, n in launches.items():
            by_gen[gen][k] += n

    old_pts, new_pts = clicks[0], clicks[1]
    before, _, launches = click("old", old_pts)
    book(0, launches)
    before_ms = []
    for _ in range(SWAP_CLICKS):
        mask, ms, launches = click("old", old_pts)
        book(0, launches)
        before_ms.append(ms)
        if not np.array_equal(mask, before):
            raise AssertionError("16a: a warm click before the swap changed its mask")
    mem_before = _held(torch, svc)
    t0 = time.perf_counter()
    gen1 = load_swap_predictor(svc.predictor, state7)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    weights = _weight_bytes(gen1.model)
    t0 = time.perf_counter()
    gen = svc.swap(gen1, label="seed 7", canary_fraction=1.0)
    swap_s = time.perf_counter() - t0
    mem_window = _held(torch, svc)
    during, _, launches = click("old", old_pts)
    book(0, launches)
    fresh, _, launches = click("new", new_pts)
    book(gen, launches)
    window_ms = {0: [], gen: []}
    for _ in range(SWAP_CLICKS):
        for sid, pts, g in (("old", old_pts, 0), ("new", new_pts, gen)):
            mask, ms, launches = click(sid, pts)
            book(g, launches)
            window_ms[g].append(ms)
            if not np.array_equal(mask, during if g == 0 else fresh):
                raise AssertionError(f"16d: a warm click of generation {g} changed "
                                     "its mask in the window")
    svc.promote()
    after, _, launches = click("old", old_pts)
    book(0, launches)
    with _uncounted(ca):
        own = gen1.predict(image, new_pts)
    new_err = float(np.abs(fresh - own).max())
    health = svc.health()
    if not (np.array_equal(before, during) and np.array_equal(before, after)):
        raise AssertionError("16a: the pre-swap session's mask changed across the "
                             "swap or the promote")
    if np.array_equal(before, fresh) or health["swap"]["swaps"]["promoted"] != 1:
        raise AssertionError(f"16a: the new session did not reach generation {gen}: "
                             f"{health['swap']}")
    check("16a new session vs generation 1's Predictor.predict, max |diff|",
          new_err, SWAP_NEW_TOL)
    if health["sessions"]["by_generation"] != {"0": 1, str(gen): 1}:
        raise AssertionError(f"16a: sessions {health['sessions']}")
    log(f"swap (a): load_swap_predictor {load_s:.3f} s; swap() {swap_s:.3f} s on "
        f"the calling thread (warm-up of buckets {svc.buckets}, encode and "
        f"decode); the pre-swap session's warm "
        f"clicks bitwise before, during and after promote(); the new session's "
        f"mask vs generation {gen}'s own predict, max |diff| {new_err:.3e}; "
        f"health swap {json.dumps(health['swap'])}")

    wait_s = _wait_retired(svc, 0)
    p50 = {"before": statistics.median(before_ms),
           "window gen 0": statistics.median(window_ms[0]),
           "window gen 1": statistics.median(window_ms[gen])}
    return {"launches": by_gen, "swap_s": swap_s, "weights": weights,
            "mem": (mem_before, mem_window), "retire_s": wait_s,
            "p50": p50, "fresh": fresh, "new_pts": new_pts}


def swap_poisoned(torch, ca, svc, fresh, new_pts, image) -> dict:
    """16c: a NaN-poisoned checkpoint (the ``serve/swap_params`` site armed
    around ``load_swap_predictor``) admitted as the canary: its first
    request fails over to the active generation and it is rolled back.
    Returns the launches of the poisoned click (both generations')."""
    import numpy as np

    from distributedpytorch_tpu_torch.chaos import sites
    from distributedpytorch_tpu_torch.chaos.faults import FaultPlan
    from distributedpytorch_tpu_torch.serve.swap import load_swap_predictor

    plan = FaultPlan.from_dict({"seed": 0, "faults": [
        {"site": "serve/swap_params", "kind": "nan", "at": [1]}]})
    active = svc.predictor
    with sites.armed_plan(plan):
        bad = load_swap_predictor(active, active.model.state_dict())
    poisoned = sum(1 for t in bad.model.state_dict().values()
                   if t.is_floating_point() and torch.isnan(t).all())
    gen = svc.swap(bad, label="poisoned", canary_fraction=1.0)
    del bad
    counted = dict(ca.launches)
    mask = svc.predict(image, new_pts, timeout=300, session_id="poisoned")
    launches = _launches_since(ca, counted)
    health = svc.health()
    sw, sessions = health["swap"], health["sessions"]
    if not np.array_equal(mask, fresh):
        raise AssertionError("16c: the failed-over mask is not the active "
                             "generation's, bitwise")
    if sw["swaps"]["rolled_back"] != 1 or sw["canary"] is not None:
        raise AssertionError(f"16c: the poisoned canary was not rolled back: {sw}")
    if str(gen) in sessions["by_generation"]:
        raise AssertionError(f"16c: the canary's sessions stayed: {sessions}")
    retire_s = _wait_retired(svc, gen)
    log(f"swap (c): serve/swap_params nan poisoned {poisoned} float tensors; "
        f"generation {gen}'s first request failed over (mask bitwise the active "
        f"generation's), rolled back (health swap {json.dumps(sw)}), sessions "
        f"{json.dumps(sessions['by_generation'])}, retired {retire_s:.2f} s "
        f"later; launches of the click {launches}")
    return launches


def swap_deep_stem(torch) -> None:
    """16e: an R101 ``deep_stem`` backbone's forward at 512² on the card,
    float32 against float64."""
    import copy

    from distributedpytorch_tpu_torch.models.resnet import ResNet

    net = randomize_segmenter(torch, ResNet(depth=101, output_stride=8,
                                            in_channels=4, deep_stem=True)).eval()
    net64 = copy.deepcopy(net).to("cuda", torch.float64)
    net = net.to("cuda")
    x = torch.from_numpy(_semantic_image(5, 512)).permute(0, 3, 1, 2)
    x = torch.cat([x, x[:, :1]], 1).contiguous().to("cuda")
    t0 = time.perf_counter()
    with torch.inference_mode():
        got = net(x)
        want = net64(x.double())
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    errs = {}
    for key, w in want.items():
        g = got[key]
        if not torch.isfinite(g).all():
            raise AssertionError(f"16e: non-finite {key}")
        errs[key] = (g.double() - w).abs().max().item() / w.abs().max().item()
        check(f"16e deep stem {key}, float32 vs float64, max |diff| / max |f64|",
              errs[key], DEEP_STEM_TOL)
    log(f"swap (e): ResNet-101 deep_stem OS 8 at 512², stem "
        f"{tuple(net.Conv_0.weight.shape)}, {tuple(net.Conv_1.weight.shape)}, "
        f"{tuple(net.Conv_2.weight.shape)}; features "
        f"{ {k: tuple(v.shape) for k, v in got.items()} }; float32 vs float64 "
        f"relative max |diff| {errs}; both forwards {ms:.1f} ms")
    del net, net64, got, want


def phase_swap(torch, ca, Predictor, InferenceService) -> dict:
    """Phase 16 (a-e); returns the launch counts of the swap path (every
    request of the service's window, both generations, and the poisoned
    canary's click; the warm-ups and references left out)."""
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    image, clicks = synthetic_image()
    gen0 = Predictor.fresh(512, "resnet101", seed=0, device="cuda",
                           guidance_inject="head")
    state7 = Predictor.fresh(512, "resnet101", seed=7, device="cpu",
                             guidance_inject="head").model.state_dict()
    svc = InferenceService(gen0, max_batch=4, max_wait_s=0.0,
                           session_ttl_s=SWAP_SESSION_TTL_S)
    svc.warmup()
    with svc:
        ca.reset_launches()
        window = swap_window(torch, ca, svc, state7, image, clicks)
        del state7
        (mem_before, live_before), (mem_window, live_window) = window["mem"]
        held, _ = _held(torch, svc)
        gen0 = None  # the script's own reference; the service re-pointed its own
        gc.collect()
        mem_after, live_after = _held(torch, svc)
        weights = window["weights"]
        # net of the session store's features (32 MiB an entry, expiring
        # by TTL while the retire is awaited): the window holds two weight
        # sets, and after the retire one again
        base = mem_before - live_before
        rise = mem_window - live_window - base
        after = mem_after - live_after - base
        check("16b allocated less the sessions' bytes, in the window vs before "
              "the swap plus one weight set, |diff| bytes", abs(rise - weights),
              SWAP_FREE_TOL)
        check("16b allocated less the sessions' bytes, after the retire vs before "
              "the swap, |diff| bytes", abs(after), SWAP_FREE_TOL)
        log(f"swap (b): one weight set {weights} bytes ({weights / 2**20:.2f} MiB); "
            f"allocated (the sessions' bytes) before the swap {mem_before} "
            f"({live_before}), in the window {mem_window} ({live_window}): "
            f"{rise / 2**20:+.3f} MiB net; after generation 0 retired "
            f"({window['retire_s']:.2f} s after the promote, the sessions' TTL "
            f"{SWAP_SESSION_TTL_S} s) {held} with the script's reference held, "
            f"{mem_after} ({live_after}) with it dropped: {after / 2**20:+.3f} MiB "
            f"net of before")
        poisoned = swap_poisoned(torch, ca, svc, window["fresh"], window["new_pts"],
                                 image)
    p50 = window["p50"]
    for name, ms in p50.items():
        check(f"16d warm-click p50 {name}, ms", ms, LATENCY_BUDGET_MS)
    log(f"swap (d): warm-click p50 over {SWAP_CLICKS} clicks, ms: "
        + ", ".join(f"{k} {v:.3f}" for k, v in p50.items()))
    by_gen = window["launches"]
    if not all(n > 0 for g in by_gen.values() for n in g.values()):
        raise AssertionError(f"16: a kernel did not launch on each generation: {by_gen}")
    launches = {k: by_gen[0][k] + by_gen[1][k] + poisoned[k] for k in TPU_KERNELS}
    log(f"swap: launches by generation {by_gen}, poisoned click {poisoned}, "
        f"total {launches}")
    del svc, window
    gc.collect()
    torch.cuda.empty_cache()
    swap_deep_stem(torch)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"swap: phase wall time {time.perf_counter() - t0:.1f} s")
    return {"swap": launches}


#: 17b: the int8 forward against the float predictor of its dtype, the
#: band the JAX package documents for its int8 serve forward
QUANT_BAND_MAX = 0.25
QUANT_BAND_MEAN = 0.02
#: 17b: the int8 predictor's kernels against its plain forms, by compute
#: dtype: (each head's logits, relative to max(1, max |logit|); the
#: probabilities, absolute); float32 phase 3's, bfloat16 phase 2's bound
QUANT_PLAIN_TOL = {"float32": (1e-3, 1e-3), "bfloat16": (2e-2, 2e-2)}
#: 17c: the allocated rise of building the int8 predictor against
#: ``quantize_report``'s bytes (16b's tolerance)
QUANT_MEM_TOL = 16 << 20
QUANT_BUCKETS = (1, 2, 4)
#: 17d: forward_prepared calls timed per batch size and form
QUANT_RUNS = 20
#: 17e: a float32 generation's mask against the float32 predictor's on
#: the same weights (another module: 16a's bound)
QUANT_SWAP_TOL = 1e-4
#: 17f: the server's boot command
QUANT_CLI = ["-m", "distributedpytorch_tpu_torch.serve", "--fresh-init",
             "512:resnet101:0", "--quantize", "int8", "--port", "0"]
QUANT_BLOCK = {"weight_dtype": "int8", "granularity": "per_channel",
               "symmetric": True}


def _crops(pred, image, clicks, b: int):
    import numpy as np

    return np.stack([pred.prepare(image, clicks[i % len(clicks)])[0]
                     for i in range(b)])


def quantize_build(torch, ca, base, x1):
    """17a and 17c: the int8 predictor built beside a float32 one."""
    import numpy as np

    from distributedpytorch_tpu_torch.serve.quantize import (
        quantize_leaf,
        quantize_predictor,
        quantize_report,
        quantized_weights,
    )

    with _uncounted(ca):
        before = base.forward_prepared(x1)
    gc.collect()
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    req0 = torch.cuda.memory_stats().get("requested_bytes.all.current", 0)
    t0 = time.perf_counter()
    qpred = quantize_predictor(base)
    torch.cuda.synchronize()
    quant_s = time.perf_counter() - t0
    rise = torch.cuda.memory_allocated() - mem0
    # the bytes the tensors asked for, before the allocator's rounding
    requested = torch.cuda.memory_stats().get("requested_bytes.all.current", 0) - req0
    state = base.model.state_dict()
    leaves = quantized_weights(qpred.model)
    differ = []
    for name, leaf in leaves.items():
        want = quantize_leaf(state[name].cpu().numpy())
        if not (np.array_equal(leaf.q.cpu().numpy(), want.q)
                and np.array_equal(leaf.scale.cpu().numpy(), want.scale)):
            differ.append(name)
    if differ or len(leaves) != sum(1 for v in state.values() if v.ndim == 4):
        raise AssertionError(f"17a: {len(differ)} int8 weights on the card differ from "
                             f"the host quantizer's ({differ[:4]}), or {len(leaves)} "
                             "quantized is not every conv")
    kept = [k for k, v in qpred.model.state_dict().items()
            if v.is_floating_point() and v.ndim == 4 and v.shape[1:] != (1, 1, 1)]
    if kept:
        raise AssertionError(f"17a: float conv weights kept on the int8 model: {kept[:4]}")
    with _uncounted(ca):
        after = base.forward_prepared(x1)
    if not np.array_equal(before, after):
        raise AssertionError("17a: the base predictor's B = 1 forward changed")
    report = quantize_report(qpred.model)
    total = report["quantized_bytes"] + report["float_bytes"]
    f32 = _weight_bytes(base.model)
    log(f"quantize (a): {len(leaves)} conv weights on the card bitwise the host "
        f"quantizer's; no float conv weight on the int8 model; the float32 "
        f"predictor's B = 1 forward bitwise before and after; quantize_predictor "
        f"{quant_s:.3f} s")
    check("17c allocated rise of building the int8 predictor vs quantize_report's "
          "bytes, |diff| bytes", abs(rise - total), QUANT_MEM_TOL)
    log(f"quantize (c): quantize_report {json.dumps(report)}, total {total} bytes "
        f"({total / 2**20:.2f} MiB) against the float32 weight set {f32} bytes "
        f"({f32 / 2**20:.2f} MiB): {total / f32:.4f}; allocated rise {rise} bytes "
        f"({rise / 2**20:.2f} MiB), {(rise - total) / 2**20:+.3f} MiB of the report; "
        f"requested rise {requested} bytes, {(requested - total) / 2**20:+.3f} MiB of "
        f"the report; the int8 model's parameters and buffers "
        f"{_weight_bytes(qpred.model)} bytes")
    return qpred


def quantize_forward(torch, ca, qpred, ref, image, clicks) -> dict:
    """17b at the int8 predictor's dtype: ``forward_prepared`` at each
    bucket (its launches counted), the kernels against the plain forms on
    the same int8 model, and the band against ``ref``, the float predictor
    of that dtype.  Returns the counted launches."""
    import numpy as np

    name = str(qpred.dtype).removeprefix("torch.")
    rel, prob_tol = QUANT_PLAIN_TOL[name]
    launches = dict.fromkeys(TPU_KERNELS, 0)
    for b in QUANT_BUCKETS:
        x = _crops(qpred, image, clicks, b)
        counted = dict(ca.launches)
        got = qpred.forward_prepared(x)
        step = _launches_since(ca, counted)
        if any(n != 1 for n in step.values()):
            raise AssertionError(f"17b: {name} B={b} launched {step}, not one of each")
        for k, n in step.items():
            launches[k] += n
        t = torch.from_numpy(x).to("cuda").permute(0, 3, 1, 2).contiguous()
        with torch.inference_mode(), _uncounted(ca):
            fast = qpred.model(t.to(qpred.dtype))
            fused_float = ref.model(t.to(ref.dtype))[0].float()
            qpred.model.set_attention_impl("xla")
            slow = qpred.model(t.to(qpred.dtype))
            plain = qpred.forward_prepared(x)
            qpred.model.set_attention_impl("auto")
            want = ref.forward_prepared(x)
        for head, a, s in zip(("fused", "pam", "cam"), fast, slow):
            s = s.float()
            check(f"17b {name} B={b} {head} logits kernels vs plain, max |diff| / "
                  "max(1, max |logit|)",
                  (a.float() - s).abs().max().item() / max(1.0, s.abs().max().item()), rel)
        check(f"17b {name} B={b} probabilities kernels vs plain, max |diff|",
              float(np.abs(got - plain).max()), prob_tol)
        diff = np.abs(got - want)
        check(f"17b {name} B={b} int8 vs {name} weights, max |diff|", float(diff.max()),
              QUANT_BAND_MAX)
        check(f"17b {name} B={b} int8 vs {name} weights, mean |diff|",
              float(diff.mean()), QUANT_BAND_MEAN)
        m_int8, m_float = got > 0.5, want > 0.5
        union = int((m_int8 | m_float).sum())
        logit_err = (fast[0].float() - fused_float).abs().max().item() \
            / fused_float.abs().max().item()
        log(f"quantize (b): {name} B={b} mask IoU at 0.5 int8 vs {name} weights "
            f"{(m_int8 & m_float).sum() / max(union, 1):.4f} (union {union} px; not "
            f"gated); probability range {float(got.min()):.4f}-{float(got.max()):.4f}; "
            f"fused logits int8 vs {name} weights max |diff| / max |logit| "
            f"{logit_err:.3e} (range {fused_float.min().item():.2f} to "
            f"{fused_float.max().item():.2f}; not gated)")
    return launches


def quantize_latency(base, qpred, image, clicks) -> None:
    """17d: ``forward_prepared`` p50 at B = 1 and 4, float32 weights and
    int8 in turns, ``QUANT_RUNS`` calls each (host clock; the call reads
    the probabilities back)."""
    xs = {b: _crops(base, image, clicks, b) for b in (1, 4)}
    times = {(form, b): [] for form in ("f32", "int8") for b in xs}
    for _ in range(QUANT_RUNS):
        for b, x in xs.items():
            for form, pred in (("f32", base), ("int8", qpred)):
                t0 = time.perf_counter()
                pred.forward_prepared(x)
                times[form, b].append((time.perf_counter() - t0) * 1e3)
    p50 = {key: statistics.median(v) for key, v in times.items()}
    log("quantize (d): forward_prepared p50 over "
        f"{QUANT_RUNS} calls in turns, ms: " + ", ".join(
            f"B={b} f32 {p50['f32', b]:.3f} int8 {p50['int8', b]:.3f} "
            f"(int8 / f32 {p50['int8', b] / p50['f32', b]:.4f})" for b in xs))


def quantize_swaps(torch, ca, base, qpred, InferenceService, image, clicks) -> dict:
    """17e: an int8 canary in a float32 service, rolled back; a float32
    state dict swapped onto an int8 active generation.  Returns the
    launches of every request, by generation."""
    import numpy as np

    from distributedpytorch_tpu_torch.models.resnet import Conv2d
    from distributedpytorch_tpu_torch.predict import Predictor
    from distributedpytorch_tpu_torch.serve.swap import load_swap_predictor

    by_gen = {g: dict.fromkeys(TPU_KERNELS, 0)
              for g in ("f32 active", "int8 canary", "int8 active", "f32 swapped in")}

    def request(svc, gen, pts, sid=None):
        counted = dict(ca.launches)
        mask = svc.predict(image, pts, timeout=300, session_id=sid)
        for k, n in _launches_since(ca, counted).items():
            by_gen[gen][k] += n
        return mask

    svc = InferenceService(base, max_batch=4, max_wait_s=0.0)
    svc.warmup()
    with svc:
        t0 = time.perf_counter()
        gen = svc.swap(qpred, label="int8", canary_fraction=1.0)
        swap_s = time.perf_counter() - t0
        for pts in clicks[:3]:
            mask = request(svc, "int8 canary", pts)
            with _uncounted(ca):
                own = qpred.predict(image, pts)
            if not np.array_equal(mask, own):
                raise AssertionError("17e: the int8 canary's mask is not its own predict's")
        svc.rollback()
        mask = request(svc, "f32 active", clicks[0])
        with _uncounted(ca):
            own = base.predict(image, clicks[0])
        sw = svc.health()["swap"]
        if not np.array_equal(mask, own) or sw["canary"] is not None \
                or sw["swaps"]["rolled_back"] != 1:
            raise AssertionError(f"17e: after the rollback: {sw}")
    log(f"quantize (e): int8 canary admitted as generation {gen} in {swap_s:.3f} s "
        f"(warm-up of buckets {svc.buckets}), 3 requests bitwise its own predict, "
        f"rolled back, the float32 generation's answer bitwise; health swap "
        f"{json.dumps(sw)}")
    svc = InferenceService(qpred, max_batch=4, max_wait_s=0.0)
    svc.warmup()
    with svc:
        before = request(svc, "int8 active", clicks[0])
        t0 = time.perf_counter()
        gen1 = load_swap_predictor(qpred, base.model.state_dict())
        load_s = time.perf_counter() - t0
        quantized = sum(1 for m in gen1.model.modules()
                        if isinstance(m, Conv2d) and m.quantized)
        if type(gen1) is not Predictor or gen1.quant_policy is not None or quantized:
            raise AssertionError(f"17e: a float32 swap onto int8 gave {type(gen1)} with "
                                 f"{quantized} quantized layers")
        svc.swap(gen1, label="f32", canary_fraction=1.0)
        errs = []
        for pts in clicks[:2]:
            mask = request(svc, "f32 swapped in", pts)
            with _uncounted(ca):
                errs.append(float(np.abs(mask - base.predict(image, pts)).max()))
        svc.promote()
        again = request(svc, "f32 swapped in", clicks[0])
        health = svc.health()["swap"]
    with _uncounted(ca):
        if not np.array_equal(before, qpred.predict(image, clicks[0])):
            raise AssertionError("17e: the int8 base's answer changed across the swap")
    check("17e float32 generation swapped onto int8 vs the float32 predictor, max "
          "|diff|", max(errs + [float(np.abs(again - base.predict(image, clicks[0])).max())]),
          QUANT_SWAP_TOL)
    log(f"quantize (e): float32 state dict onto the int8 active generation: "
        f"load_swap_predictor {load_s:.3f} s, a float32 Predictor (no quantized "
        f"layer), served and promoted; health swap {json.dumps(health)}")
    if not all(n > 0 for g in by_gen.values() for n in g.values()):
        raise AssertionError(f"17e: a kernel did not launch on each generation: {by_gen}")
    log(f"quantize (e): launches by generation {json.dumps(by_gen)}")
    return by_gen


def quantize_cli_start():
    """17f's server, started in a process group of its own; its output
    lines go to a queue."""
    import queue

    proc = subprocess.Popen([sys.executable, *QUANT_CLI], cwd=REPO, text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            start_new_session=True)
    lines: queue.Queue = queue.Queue()

    def pump():
        for line in proc.stdout:
            lines.put(line)
        lines.put(None)

    threading.Thread(target=pump, daemon=True).start()
    return proc, lines, time.perf_counter()


def quantize_cli_finish(server, image, clicks) -> None:
    """17f: the boot line's ``quantization`` block, one request answered
    over HTTP, SIGTERM: exit 0 and no process of its group left."""
    import signal

    import numpy as np

    from distributedpytorch_tpu_torch.serve.client import ServeClient

    proc, lines, t0 = server
    out, boot = [], None
    try:
        while boot is None:
            line = lines.get(timeout=max(1.0, 300 - (time.perf_counter() - t0)))
            if line is None:
                raise AssertionError("17f: the server exited before its boot line: "
                                     + "".join(out[-20:]))
            out.append(line)
            if line.startswith('{"serving"'):
                boot = json.loads(line)
        boot_s = time.perf_counter() - t0
        t1 = time.perf_counter()
        mask = ServeClient(boot["serving"], timeout_s=300).predict(image, clicks[0])
        req_ms = (time.perf_counter() - t1) * 1e3
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    while (line := lines.get(timeout=30)) is not None:
        out.append(line)
    deadline = time.perf_counter() + 10
    while (left := group_members(proc.pid)) and time.perf_counter() < deadline:
        time.sleep(0.2)
    if rc != 0 or left or not any(ln.startswith('{"stopped"') for ln in out):
        raise AssertionError(f"17f: server exit {rc}, left {left}: " + "".join(out[-20:]))
    if boot["quantization"] != QUANT_BLOCK or boot["device"] != "cuda":
        raise AssertionError(f"17f: boot line {boot}")
    if mask.shape != image.shape[:2] or not np.isfinite(mask).all():
        raise AssertionError(f"17f: bad mask {mask.shape}")
    log(f"quantize (f): python {' '.join(QUANT_CLI)}: boot line after {boot_s:.1f} s "
        f"{json.dumps(boot)}; POST /v1/predict answered in {req_ms:.1f} ms, mask "
        f"{mask.shape} finite; SIGTERM, exit 0, no process left")


def phase_quantize(torch, ca, Predictor, InferenceService) -> dict:
    """Phase 17 (a-f); returns the launch counts of the int8 path (17b's
    counted forwards in both dtypes and every request of 17e; references,
    plain forms, warm-ups and 17d's timing left out)."""
    from distributedpytorch_tpu_torch.serve.quantize import quantize_predictor

    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    server = quantize_cli_start()
    try:
        image, clicks = synthetic_image()
        base = Predictor.fresh(512, "resnet101", seed=0, device="cuda")
        x1 = _crops(base, image, clicks, 1)
        qpred = quantize_build(torch, ca, base, x1)
        launches = quantize_forward(torch, ca, qpred, base, image, clicks)
        quantize_cli_finish(server, image, clicks)
    finally:
        proc = server[0]
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    quantize_latency(base, qpred, image, clicks)
    by_gen = quantize_swaps(torch, ca, base, qpred, InferenceService, image, clicks)
    del qpred
    gc.collect()
    # bf16 on the same weights: the float predictor computes in bf16 from
    # here on, and its int8 copy with it
    ref16 = Predictor(base.model, resolution=base.resolution, device="cuda",
                      dtype=torch.bfloat16)
    q16 = quantize_predictor(ref16)
    launches16 = quantize_forward(torch, ca, q16, ref16, image, clicks)
    total = {k: launches[k] + launches16[k] + sum(g[k] for g in by_gen.values())
             for k in TPU_KERNELS}
    log(f"quantize: launches f32 forwards {launches}, bf16 forwards {launches16}, "
        f"requests by generation {json.dumps(by_gen)}, total {total}")
    del base, ref16, q16
    gc.collect()
    torch.cuda.empty_cache()
    log(f"quantize: phase wall time {time.perf_counter() - t0:.1f} s")
    return {"quantize": total}


#: phase 18's ladder (max_batch 2) and its bound against the eager forward
#: (phase 3's)
AOT_BUCKETS = (1, 2)
AOT_TOL = 1e-3
#: the server of 18c and 18d; the cache directory is added
AOT_CLI = ["-m", "distributedpytorch_tpu_torch.serve", "--fresh-init",
           "512:resnet101:0", "--max-batch", "2", "--warmup", "--port", "0"]
#: 18d's fault: the first package read gets one byte flipped
AOT_CHAOS = {"name": "aot_rot", "faults": [
    {"site": "serve/aot_load", "kind": "bitflip", "offset": 1 << 20,
     "times": 1}]}
#: the device kernels a forward through the package must show
AOT_KERNEL_NAMES = ("pam_forward_kernel", "cam_gram_kernel", "cam_apply_kernel")
#: 18e runs while the script has been running less than this, each item
#: estimated at AOT_EXTRA_S (the bf16 build took 102.7 s on the H100 in a
#: whole run, which reaches phase 18 at ~750-800 s), so that a whole run
#: keeps its slack under the 1200 s limit; what is left out is printed
AOT_EXTRA_DEADLINE_S = 750.0
AOT_EXTRA_S = 110.0
#: when the script started
T_START = time.perf_counter()


def _device_used_mib(torch) -> float:
    """MiB in use on the card by every process (``cudaMemGetInfo``)."""
    free, total = torch.cuda.mem_get_info()
    return (total - free) / 2**20


def aot_server_start(cache_dir: str | None, env_extra: dict | None = None) -> dict:
    """A server of ``AOT_CLI`` (from ``cache_dir`` where given) started in a
    process group of its own, its output lines pumped to a queue."""
    import os
    import queue

    env = dict(os.environ, **(env_extra or {}))
    cmd = [sys.executable, *AOT_CLI] + (["--aot-cache", cache_dir] if cache_dir
                                        else [])
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=REPO, text=True, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            start_new_session=True)
    lines: queue.Queue = queue.Queue()

    def pump():
        for line in proc.stdout:
            lines.put(line)
        lines.put(None)

    threading.Thread(target=pump, daemon=True).start()
    return {"proc": proc, "lines": lines, "out": [], "t0": t0}


def aot_server_boot(server: dict) -> dict:
    """Wait for the server's boot line; returns its record (and keeps it
    and the seconds from the start to it in ``server``)."""
    out, t0 = server["out"], server["t0"]
    while True:
        line = server["lines"].get(timeout=max(1.0, 300 - (time.perf_counter() - t0)))
        if line is None:
            raise AssertionError("18: the server exited before its boot line: "
                                 + "".join(out[-30:]))
        out.append(line)
        if line.startswith('{"serving"'):
            server["boot"] = json.loads(line)
            server["boot_s"] = time.perf_counter() - t0
            return server["boot"]


def aot_server_stop(server: dict, what: str) -> list[str]:
    """SIGTERM: exit 0, its stopped line, no process of its group left;
    returns its output lines, the warm-up's logged."""
    import signal

    proc, lines, out = server["proc"], server["lines"], server["out"]
    try:
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    while (line := lines.get(timeout=30)) is not None:
        out.append(line)
    deadline = time.perf_counter() + 10
    while (left := group_members(proc.pid)) and time.perf_counter() < deadline:
        time.sleep(0.2)
    if rc != 0 or left or not any(ln.startswith('{"stopped"') for ln in out):
        raise AssertionError(f"18{what}: server exit {rc}, left {left}: "
                             + "".join(out[-20:]))
    return out


def aot_masks(url: str, image, clicks, want, what: str) -> float:
    """Each click set over HTTP against the in-process eager masks; returns
    the largest |diff|."""
    import numpy as np

    from distributedpytorch_tpu_torch.serve.client import ServeClient

    client = ServeClient(url, timeout_s=300)
    worst = 0.0
    for pts, ref in zip(clicks, want):
        mask = client.predict(image, pts)
        if mask.shape != image.shape[:2] or not np.isfinite(mask).all():
            raise AssertionError(f"18{what}: bad mask {mask.shape}")
        worst = max(worst, float(np.abs(mask - ref).max()))
    check(f"aot {what} HTTP masks vs the eager masks", worst, AOT_TOL)
    health = json.loads(urllib.request.urlopen(url + "/healthz", timeout=60).read())
    counts = health["stats"]["counts"]
    if not health["ok"] or health["unhealthy_reason"] is not None \
            or counts.get("retrace_failures", 0) != 0:
        raise AssertionError(f"18{what}: health {health}")
    return worst


def aot_build_start() -> dict:
    """18a's build, started before phase 12: ``python -m
    distributedpytorch_tpu_torch.serve.aot`` of the float32 stem ladder of
    DANet-R101 at 512², seed 0, ``max_batch=2``, at the lowest CPU priority
    (``nice -n 19``), so that it compiles on the cores phases 12-17 leave
    idle (their timed checks are the host's and the card's, and 16d's
    100 ms budget has a 3x margin)."""
    import tempfile

    cache_dir = tempfile.mkdtemp(prefix="chip_smoke_aot_")
    errors = open(cache_dir + ".log", "w")
    cmd = ["nice", "-n", "19", sys.executable, "-m",
           "distributedpytorch_tpu_torch.serve.aot", "--cache-dir", cache_dir,
           "--fresh-init", "512:resnet101:0", "--max-batch", str(max(AOT_BUCKETS))]
    proc = subprocess.Popen(cmd, cwd=REPO, text=True, stdout=subprocess.PIPE,
                            stderr=errors, start_new_session=True)
    return {"proc": proc, "dir": cache_dir, "errors": errors,
            "t0": time.perf_counter()}


def aot_build_stop(job: dict) -> None:
    """Kill the build if it still runs; remove its cache and log."""
    import shutil

    proc = job["proc"]
    if proc.poll() is None:
        proc.kill()
        proc.wait()
    job["errors"].close()
    shutil.rmtree(job["dir"], ignore_errors=True)
    Path(job["dir"] + ".log").unlink(missing_ok=True)


def aot_build_finish(job: dict) -> dict:
    """18a: wait for the build; its summary: each program's build seconds,
    the packages' bytes, and at least one Inductor compile a program on the
    build's CompileWatchdog."""
    t0 = time.perf_counter()
    out, _ = job["proc"].communicate(timeout=1200)
    waited = time.perf_counter() - t0
    if job["proc"].returncode != 0:
        job["errors"].flush()
        raise AssertionError(f"18a: the build exited {job['proc'].returncode}: "
                             + Path(job["dir"] + ".log").read_text()[-3000:])
    summary = json.loads(out)
    programs = summary["programs"]
    if programs != [f"forward_b{b}" for b in AOT_BUCKETS] \
            or summary["compiles"].get("inductor", 0) < len(programs):
        raise AssertionError(f"18a: programs {programs}, compiles {summary['compiles']}")
    log(f"aot (a): built {programs} in {time.perf_counter() - job['t0']:.1f} s from "
        f"its start before phase 12, {waited:.1f} s of it waited for here (per program, "
        f"export + compile + round trip: {json.dumps(summary['seconds'])}); packages "
        f"{summary['bytes']} bytes ({summary['bytes'] / len(programs) / 2**20:.1f} "
        f"MiB each); CompileWatchdog over the build {summary['compiles']}; "
        f"fingerprint device {summary['fingerprint']['device']!r}, dtype "
        f"{summary['fingerprint']['dtype']}")
    return summary


def _zero_weights(pred) -> None:
    """Zero every tensor of ``pred``'s eager model (parameters, BatchNorm
    statistics, int8 weights), so that only its installed packages can
    give its right output."""
    for t in pred.model.state_dict().values():
        t.zero_()


def aot_in_process(torch, ca, Predictor, cache_dir: str, base, image, clicks) -> dict:
    """18b: a fresh predictor with the packages installed against the eager
    forward; returns the launches of its counted forwards."""
    import numpy as np

    from distributedpytorch_tpu_torch.serve.aot import AotCache, cache_fingerprint

    cache = AotCache(cache_dir)
    fresh = Predictor.fresh(512, "resnet101", seed=0, device="cuda")
    fp = cache_fingerprint(fresh)
    allocated = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    for b in AOT_BUCKETS:
        fresh.install_aot(("forward", (b, 512, 512, 4)),
                          cache.load(f"forward_b{b}", fp))
    load_s = time.perf_counter() - t0
    # the packages' baked weights, as PyTorch's allocator sees them
    allocated = (torch.cuda.memory_allocated() - allocated) / 2**20
    # only the packages, which bake their own weights, can still give the
    # eager masks: the installed programs are what runs
    _zero_weights(fresh)
    total = dict.fromkeys(TPU_KERNELS, 0)

    def counted(x, what):
        before = dict(ca.launches)
        out = fresh.forward_prepared(x)
        torch.cuda.synchronize()
        launches = _launches_since(ca, before)
        if launches != dict.fromkeys(TPU_KERNELS, 1):
            raise AssertionError(f"18b: {what} launches {launches}")
        for k in total:
            total[k] += launches[k]
        return out

    for b in AOT_BUCKETS:
        x = _crops(base, image, clicks, b)
        with _uncounted(ca):
            want = base.forward_prepared(x)
        got = counted(x, f"B={b}")
        check(f"aot (b) B={b} package (eager weights zeroed) vs eager forward",
              float(np.abs(got - want).max()), AOT_TOL)
        again = counted(x, f"B={b} again")
        if not np.array_equal(got, again):
            raise AssertionError(f"18b: B={b}: two runs of the package differ")
    x1 = _crops(base, image, clicks, 1)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        counted(x1, "profiled B=1")
    names = {e.name for e in _device_events(prof)}
    missing = [k for k in AOT_KERNEL_NAMES if not any(k in n for n in names)]
    if missing:
        raise AssertionError(f"18b: the package's forward launched no {missing}")
    # p50 on the host's clock (prepared crops in, probabilities read back)
    x2 = _crops(base, image, clicks, 2)
    with _uncounted(ca):
        times = {}
        for name, pred, x in (("aot B=1", fresh, x1), ("eager B=1", base, x1),
                              ("aot B=2", fresh, x2), ("eager B=2", base, x2)):
            times[name] = _best_ms(lambda: pred.forward_prepared(x), 10)
    log(f"aot (b): {len(AOT_BUCKETS)} packages loaded and installed in {load_s:.2f} s "
        f"(torch.cuda.memory_allocated moved {allocated:.1f} MiB); "
        f"the eager model's weights zeroed; one launch of each kernel per forward "
        f"(counted over each of the {3 * len(AOT_BUCKETS) - 1}), the same bits twice; the "
        f"profiler's "
        f"device kernels name {list(AOT_KERNEL_NAMES)}; forward_prepared p50 ms "
        + ", ".join(f"{k} {v:.3f}" for k, v in times.items()))
    del fresh
    return total


def aot_warm_boots(torch, cache_dir: str, image, clicks, want) -> None:
    """18c: the warm boot from the cache and the eager boot, each a fresh
    process alone on the card, its seconds to the boot line and its MiB of
    the card."""
    base_mib = _device_used_mib(torch)
    results = {}
    for what, cache in (("c", cache_dir), ("c eager", None)):
        server = aot_server_start(cache)
        try:
            boot = aot_server_boot(server)
            mib = _device_used_mib(torch) - base_mib
            cold = boot["cold_start"]
            compiles = [ln for ln in server["out"]
                        if "compiles on the CompileWatchdog" in ln]
            if cache is not None and (cold["aot_cache"] != "hit"
                                      or cold["programs_loaded"] != len(AOT_BUCKETS)
                                      or not compiles
                                      or not compiles[-1].startswith(
                                          "serve/warmup: 0 compiles")):
                raise AssertionError(f"18c: warm boot {boot}: "
                                     + "".join(server["out"][-20:]))
            if cache is None and cold["aot_cache"] != "off":
                raise AssertionError(f"18c: eager boot {boot}")
            worst = aot_masks(boot["serving"], image, clicks, want, what)
        finally:
            out = aot_server_stop(server, what)
        for line in out:
            if line.startswith(("serve/warmup:", "serve/aot:")):
                log(f"aot ({what}) server: {line.rstrip()[:200]}")
        results[what] = (server["boot_s"], cold, mib, worst)
        log(f"aot ({what}): boot line after {server['boot_s']:.2f} s, cold_start "
            f"{json.dumps(cold)}, {compiles[-1].strip() if compiles else ''}; the "
            f"server's device memory {mib:.0f} MiB; {len(clicks)} HTTP masks within "
            f"{worst:.2e} of the eager masks; /healthz ok, retrace_failures 0; exit 0")
    warm, eager = results["c"], results["c eager"]
    log(f"aot (c): warm boot {warm[0]:.2f} s (warm-up {warm[1]['warmup_seconds']} s) "
        f"against the eager boot {eager[0]:.2f} s (warm-up "
        f"{eager[1]['warmup_seconds']} s); device MiB {warm[2]:.0f} against "
        f"{eager[2]:.0f} (each package bakes its own weights)")


def aot_chaos(server: dict, image, clicks, want) -> None:
    """18d: the server booted with a bitflip armed at serve/aot_load
    refuses the entry, warms it eagerly and serves."""
    try:
        boot = aot_server_boot(server)
        refused = [ln for ln in server["out"] if "REFUSING cache entry" in ln]
        if not refused or boot["cold_start"]["aot_cache"] not in ("partial", "miss"):
            raise AssertionError(f"18d: chaos boot {boot}: "
                                 + "".join(server["out"][-20:]))
        worst = aot_masks(boot["serving"], image, clicks, want, "d")
    finally:
        aot_server_stop(server, "d")
    log(f"aot (d): bitflip at serve/aot_load: {refused[0].strip()[:160]}...; "
        f"cold_start {json.dumps(boot['cold_start'])}; masks within {worst:.2e}")


def aot_verify_start(cache_dir: str) -> dict:
    """18d: ``--verify`` on a copy of the cache with one bit flipped in
    ``forward_b2``, started in the background."""
    import os
    import shutil
    import tempfile

    copy = tempfile.mkdtemp(prefix="chip_smoke_aot_flip_")
    shutil.copytree(cache_dir, copy, dirs_exist_ok=True)
    path = os.path.join(copy, "forward_b2.pt2")
    with open(path, "r+b") as f:
        f.seek(os.path.getsize(path) // 2)
        byte = f.read(1)
        f.seek(-1, 1)
        f.write(bytes([byte[0] ^ 0x01]))
    proc = subprocess.Popen([sys.executable, "-m", "distributedpytorch_tpu_torch.serve.aot",
                             "--cache-dir", copy, "--verify"], cwd=REPO, text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            start_new_session=True)
    return {"proc": proc, "dir": copy}


def aot_verify_finish(job: dict) -> None:
    """It exits 1 naming the entry."""
    import shutil

    try:
        out, err = job["proc"].communicate(timeout=300)
    finally:
        if job["proc"].poll() is None:
            job["proc"].kill()
            job["proc"].wait()
        shutil.rmtree(job["dir"], ignore_errors=True)
    rc = job["proc"].returncode
    if rc != 1 or "forward_b2" not in err or json.loads(out)["bad"] != ["forward_b2"]:
        raise AssertionError(f"18d: --verify rc {rc}: {err[-500:]}")
    log(f"aot (d): --verify on a copy with one bit flipped exits 1: "
        f"{err.strip().splitlines()[-1]}")


def aot_extra(torch, ca, Predictor, what: str) -> dict:
    """One 18e program at bucket 1 on DANet-R50 at 512² (ResNet-101's
    widths): built, loaded into a fresh predictor whose eager weights are
    then zeroed, held to its eager forward; returns the launches of the
    counted forward."""
    import shutil
    import tempfile

    import numpy as np

    from distributedpytorch_tpu_torch.serve.aot import AotCache, cache_fingerprint
    from distributedpytorch_tpu_torch.serve.quantize import quantize_predictor

    def make():
        inject = "head" if what == "split" else "stem"
        dtype = torch.bfloat16 if what == "bf16" else torch.float32
        pred = Predictor.fresh(512, "resnet50", seed=0, device="cuda", dtype=dtype,
                               guidance_inject=inject)
        return quantize_predictor(pred) if what == "int8" else pred

    tol = {"bf16": 2e-2, "int8": QUANT_PLAIN_TOL["float32"][1]}.get(what, AOT_TOL)
    image, clicks = synthetic_image()
    d = tempfile.mkdtemp(prefix=f"chip_smoke_aot_{what}_")
    try:
        base = make()
        t0 = time.perf_counter()
        with _uncounted(ca):
            summary = AotCache(d).build(base, (1,))
        build_s = time.perf_counter() - t0
        fresh = make()
        fp = cache_fingerprint(fresh)
        keys = {"encode_b1": ("encode", 1), "decode_b1": ("decode", 1),
                "forward_b1": ("forward", (1, 512, 512, 4))}
        for name in summary["programs"]:
            fresh.install_aot(keys[name], AotCache(d).load(name, fp))
        _zero_weights(fresh)
        x = _crops(base, image, clicks, 1)
        with _uncounted(ca):
            want = base.forward_prepared(x)
        before = dict(ca.launches)
        got = fresh.forward_prepared(x)
        torch.cuda.synchronize()
        launches = _launches_since(ca, before)
    finally:
        shutil.rmtree(d, ignore_errors=True)
    if launches != dict.fromkeys(TPU_KERNELS, 1):
        raise AssertionError(f"18e {what}: launches {launches}")
    check(f"aot (e) {what} package vs eager forward", float(np.abs(got - want).max()),
          tol)
    log(f"aot (e): {what} (DANet-R50 512², bucket 1): {summary['programs']} built in "
        f"{build_s:.1f} s ({summary['bytes']} bytes), one launch of each kernel")
    return launches


def phase_aot(torch, ca, Predictor, job: dict) -> dict:
    """Phase 18 (a-e) on the build ``job`` started before phase 12; returns
    the launch counts of the AOT path (18b's package forwards and 18e's;
    references, the build's round trips and the timing left out; the
    servers' launches are in their own processes)."""
    import shutil

    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    image, clicks = synthetic_image()
    aot_build_finish(job)
    # 18d's chaos server and --verify run beside 18b (whose p50s they
    # perturb; nothing of 18b's is gated on time); 18c's boots run alone
    chaos = aot_server_start(job["dir"], {"DPTPU_CHAOS_PLAN": json.dumps(AOT_CHAOS)})
    verify = None
    try:
        verify = aot_verify_start(job["dir"])
        base = Predictor.fresh(512, "resnet101", seed=0, device="cuda")
        total = aot_in_process(torch, ca, Predictor, job["dir"], base, image, clicks)
        with _uncounted(ca):
            want = base.predict_batch(image, clicks)
        aot_chaos(chaos, image, clicks, want)
        aot_verify_finish(verify)
    finally:
        for proc in (chaos["proc"], verify and verify["proc"]):
            if proc is not None and proc.poll() is None:
                proc.kill()
                proc.wait()
        if verify is not None:
            shutil.rmtree(verify["dir"], ignore_errors=True)
    del base
    gc.collect()
    torch.cuda.empty_cache()
    aot_warm_boots(torch, job["dir"], image, clicks, want)
    left_out = []
    for what in ("bf16", "split", "int8"):
        elapsed = time.perf_counter() - T_START
        if elapsed + AOT_EXTRA_S > AOT_EXTRA_DEADLINE_S:
            left_out.append(what)
            continue
        for k, n in aot_extra(torch, ca, Predictor, what).items():
            total[k] += n
        gc.collect()
        torch.cuda.empty_cache()
    if left_out:
        log(f"aot (e): left out {left_out}: the script had run "
            f"{time.perf_counter() - T_START:.0f} s, and each takes ~{AOT_EXTRA_S:.0f} s "
            f"against the {AOT_EXTRA_DEADLINE_S:.0f} s set for them")
    log(f"aot: launches {total}; phase wall time {time.perf_counter() - t0:.1f} s")
    return {"aot": total}


#: the phases of a whole run, in order
PHASES = ("kernels", "serve", "train", "host", "dist", "semantic", "trainer",
          "telemetry", "devdata", "sessions", "head_knobs", "host_data", "swap",
          "quantize", "aot")


def bytecode_cache() -> None:
    """Let this process and every process it starts keep compiled bytecode
    under ``build/pycache``.  The card's machine sets
    ``PYTHONDONTWRITEBYTECODE``, so each fresh interpreter otherwise
    compiles torch, its compiler stack and the port from source again:
    18.6 s to import them on the H100's machine, paid by every fit, rank
    and server this script starts."""
    import os

    prefix = REPO / "build" / "pycache"
    prefix.mkdir(parents=True, exist_ok=True)
    sys.dont_write_bytecode = False
    sys.pycache_prefix = str(prefix)
    os.environ.pop("PYTHONDONTWRITEBYTECODE", None)
    os.environ["PYTHONPYCACHEPREFIX"] = str(prefix)


def later_phases(torch, ca, phases: set, aot_job, Predictor, InferenceService,
                 make_server, ServeClient) -> dict:
    """Phases 12-18 (those in ``phases``), while 18a's build ``aot_job``
    compiles in the background; returns their paths' launch counts."""
    paths = {}
    if "devdata" in phases:
        paths.update(phase_devdata(torch, ca))
    if "sessions" in phases:
        paths.update(phase_sessions(torch, ca, Predictor, InferenceService,
                                    make_server, ServeClient))
    if "head_knobs" in phases:
        paths.update(phase_head_knobs(torch, ca, Predictor))
    if "host_data" in phases:
        paths.update(phase_host_data(torch, ca, Predictor))
    if "swap" in phases:
        paths.update(phase_swap(torch, ca, Predictor, InferenceService))
    if "quantize" in phases:
        paths.update(phase_quantize(torch, ca, Predictor, InferenceService))
    if "aot" in phases:
        paths.update(phase_aot(torch, ca, Predictor, aot_job))
    return paths


def main(argv: list[str] | None = None) -> int:
    import argparse

    if not (REPO / "distributedpytorch_tpu_torch").is_dir():
        print(f"chip_smoke: no distributedpytorch_tpu_torch beside {REPO}",
              file=sys.stderr)
        return 2
    bytecode_cache()
    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--phases", default=",".join(PHASES),
                        help="comma list of " + ", ".join(PHASES) + " (default: all)")
    phases = set(parser.parse_args(argv).phases.split(","))
    if not phases <= set(PHASES):
        parser.error(f"unknown phases {sorted(phases)}")
    log(environment_line())
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    from distributedpytorch_tpu_torch.ops import _build
    from distributedpytorch_tpu_torch.ops import attention as att
    from distributedpytorch_tpu_torch.ops import cuda_attention as ca
    from distributedpytorch_tpu_torch.predict import Predictor
    from distributedpytorch_tpu_torch.serve.__main__ import make_server
    from distributedpytorch_tpu_torch.serve.client import ServeClient
    from distributedpytorch_tpu_torch.serve.service import InferenceService

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("tf32: torch.backends.cuda.matmul.allow_tf32=False, "
        "torch.backends.cudnn.allow_tf32=False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    log(smi.stdout.strip().splitlines()[0])
    name = torch.cuda.get_device_name(0)
    variant, peaks = card_peaks(name)
    log(f"device: {name}, peaks of {variant}: {peaks[0] / 1e12:g} TFLOP/s "
        f"f32, {peaks[1] / 1e12:g} TFLOP/s bf16, {peaks[2] / 1e12:g} TFLOP/s "
        f"TF32, {peaks[3] / 1e12:g} TB/s; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}")

    t0 = time.perf_counter()
    ca.build()
    log(f"build: attention.cu in {time.perf_counter() - t0:.2f} s "
        f"(nvcc {_build.build_seconds})")

    if "kernels" in phases:
        records = phase_kernels(torch, ca, att, peaks)

    paths = {}
    if "serve" in phases:
        ca.reset_launches()
        pred, image, clicks = phase_predictor(torch, Predictor, ca)
        phase_service(pred, image, clicks, InferenceService)
        phase_http(pred, image, clicks, InferenceService, make_server, ServeClient)
        paths["serve"] = dict(ca.launches)
        del pred
    if "train" in phases:
        paths.update(phase_train(torch, ca, Predictor))
    if "host" in phases:
        paths.update(phase_host(torch, ca))
    if "dist" in phases:
        paths["dist"] = phase_dist(torch, train_dataset())
    if "semantic" in phases:
        phase_semantic(torch, ca)
    if "trainer" in phases:
        paths.update(phase_trainer(torch, ca))
    if "telemetry" in phases:
        paths.update(phase_telemetry(torch, ca, Predictor, InferenceService, make_server))
    # phase 18's build compiles in the background from here on
    aot_job = aot_build_start() if "aot" in phases else None
    try:
        paths.update(later_phases(torch, ca, phases, aot_job, Predictor,
                                  InferenceService, make_server, ServeClient))
    finally:
        if aot_job is not None:
            aot_build_stop(aot_job)
    for path, launches in paths.items():
        if not all(launches[k] > 0 for k in TPU_KERNELS
                   if k not in PATHS_WITHOUT.get(path, ())):
            raise AssertionError(f"a kernel never ran on the {path} path: {launches}")
    if phases != set(PHASES):
        log(f"partial run of phases {sorted(phases)}: no result")
        return 0

    log("margins: " + json.dumps({k: (None if math.isinf(v) else round(v, 4))
                                  for k, v in MARGINS.items()}))
    log(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": SOURCE, "replaces": TPU_KERNELS[k],
         "launches": sum(p[k] for p in paths.values()),
         "launches_by_path": {path: p[k] for path, p in paths.items()}, **r}
        for k, r in records.items()]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
