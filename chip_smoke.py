#!/usr/bin/env python3
"""Drive the PyTorch port's serving paths on one CUDA card and check them.

Run from the repository root with no arguments: `python3 chip_smoke.py`.
It imports only `torch`, numpy and `yolo_infer_tpu_torch`, builds the port's
CUDA kernels from `yolo_infer_tpu_torch/csrc/` with nvcc (in parallel), and
runs thirty-six phases, each printing one JSON line. Kernels A, C, F and G
are timed with L2 flushed before each call (`l2_cold`), as the path finds
them.

A live `Predictor` captures each serving signature into a CUDA graph on its
first call and replays it after (`core/graphs.py`); a replay calls no
kernel wrapper, so no Python launch counter ticks. A path that gives the
kernels line a row (phases 5, 10, 11, 15, 17, 20) reads its launches as
the line reports them from its own run: every count set to 0 just before
its first call (the capture: each kernel once per warm-up call and once
recorded into the graph) and read just after its last (`path_counters`).
That count must be (1 + WARMUP_CALLS) times one uncaptured call of the
predictor's serving body (`Predictor.serve_program`, what the graph
replays: `eager_run`, which also hands over the kernels' inputs "at the
path's own inputs"; `path_launches`). Replays show their kernels by name
in torch.profiler traces in phases 21, 24, 25 and 27:

  1. card    nvidia-smi name and power limit, kernel build times, ptxas info
             and each library's tensor-core instructions in its SASS
             (`cuobjdump -sass`: HMMA, IMMA); B's library must hold HMMA and
             E's IMMA; kernel F's SASS instructions per logit (each
             function's static count over the logits a thread decodes)
  2. nms     kernel A (`nms_keep`) vs its plain version on the card (and on
             the cpu up to K=1024), keep masks equal bit for bit: random
             candidates at B=32 K=384, 512, 1024 and 2048, B=4 K=4096 and
             B=2 K=8192,
             a valid prefix of 0..384 at K=384, boxes holding NaN, +-inf and
             zero-area entries at K=384 and 4096, and the 3-box suppression
             chain; device time of each split into the IoU bits pass and the
             walk; K=8193 raises
  3. attn    kernel B (`attention_qkv`) vs its plain version on the card: bf16
             (32, 400, 256) heads=2, (32, 400, 512) heads=4, (16, 1024, 256)
             heads=2 (the OBB shape) and (2, 37, 256) (a ragged key tile)
             within atol = rtol = 2e-2, f32 (32, 400, 256) and (2, 37, 256)
             within atol 1e-5, and a streamed-K/V case at N=1600 (1280 px)
  4. fp32    yolo11n fp32 `Predictor.predict` on two 480x640 frames at 640 px,
             on cuda and on cpu (TF32 off): equal num and classes, boxes within
             1e-2 px, scores within 1e-5; both launch counters rise
  5. bf16    the main path: yolo11n bf16 `Predictor.predict` at batch 32 on
             640x640 frames (captured, then replayed) with the launch
             counters reset just before, its body once uncaptured (A and B
             each >= 1 per call, the path's run 1 + WARMUP_CALLS times
             that), then timed: 20 calls end to end (host clock,
             median img/s) and the device part alone (CUDA events, frames
             already on the card); per-kernel device times (torch.profiler)
             at the shapes that run gave each kernel, beside the plain
             version's and, for B, `F.scaled_dot_product_attention`'s (a
             yardstick only); `*call_ms` are the same calls timed back to
             back with CUDA events, host launch overhead included
  6. profile device time by kernel and by copy over three main-path
             predicts, and the kernels' busy share of the wall time
             (torch.profiler; the run is slower than the untraced one)
  7. rnms    kernel C (`rotated_nms_keep`) vs its plain version on the card:
             B=16 random oriented candidates at K=1024, 37, 160, 2048, 4096
             and 8192 (15% invalid) and at K=4096 with a valid prefix of
             300..1500, keep masks equal bit for bit; device time of each
             split into the probIoU bits pass and the walk; the 3-box
             suppression chain; K=8193 raises
  8. mpack   kernel D (`upsample4x_threshold_pack`) vs its plain version on
             the card, packed bytes equal bit for bit: random (300, 160, 160),
             (37, 24, 40), (5, 17, 8) and (2, 6, 4096) soft masks (a band cut
             short, one word per row, a wide row), a dense uniform
             (9600, 160, 160)
             (timed beside its bound), and 0.5, nextafter(0.5, 1), -inf,
             +inf, NaN and negatives over zeros with all-zero instances;
             each case's share of zero-skipped steps
  9. tasks_fp32  yolo11n segment, obb (nc 15), pose and classify fp32
             `Predictor.predict` on two frames of different sizes (the host
             letterbox) at 640 px, on cuda and on cpu (TF32 off), on weights
             calibrated as in phase 4 (segment: mask logits at unit spread
             too): equal counts, detections paired as sets (same class), the
             pairs' boxes, obb and keypoints within 5e-2 px and scores within
             1e-4, mask pixels differing at most 1e-4, probs within 1e-5;
             each task's kernel counters rise; OBB again at pre_topk 2048
             (kernel C at K=2048)
 10. seg_bf16  the segment path: yolo11n-seg bf16 `predict` at batch 32 on
             640x640 frames, mask_mode "device": its body once uncaptured with
             the counters reset (A, B and D must each read >= 1), 20 timed calls and the
             device part as in phase 5, kernel D at the captured input
             (bit-equal to its plain version; times beside its bound, and
             the share of its steps that take the zero skip), and
             the device time by kernel over three predicts
 11. obb_bf16  the OBB path: yolo11n-obb (nc 15) bf16 `predict` at batch 16
             on 1024x1024 frames (the OBB models' input size): counters B,
             C and F >= 1 (OBB's full-grid decode runs F), timings as in
             phase 10, kernel C at the captured K=1024 input (bits pass and
             walk timed apart), kernel F at the captured (16, 21504, 64)
             slice of the 79-channel head slab (2-byte-aligned rows; within
             1e-5, timed cold beside its bound), and kernel B at
             its captured N=1024 input beside its bound, its plain version and
             `F.scaled_dot_product_attention`
 12. dfl     kernel F (`dfl_decode`) vs its plain version on the card, f32
             and bf16, within 1e-5, one launch each: random (16, 8400, 64)
             logits contiguous and as the slice of a (16, 8400, 144) head
             slab (detect), slices from channel 1, 2 and 4, the slices of
             (16, 21504, 79) (OBB nc 15) and (16, 8400, 65) (pose nc 1)
             slabs, a ragged A (8397, 37), and logits from N(0, 8) with one
             row in four spanning 80 across each side's bins, and B = 70000
             images (past the grid's y limit); every load width (16, 8, 4,
             2 bytes) must be taken
 13. gnms    kernel G (`greedy_nms_keep`) vs its plain version on the card,
             bit-equal: random sorted candidates' IoU at (16, 4096), K = 1000
             and 37 (not multiples of 32), an all-invalid image, (2, 8192),
             (16, 4096) with a valid prefix of 300..3000, and a 4096-box
             suppression chain (each box overlaps the next); device time of
             each split into the bits pass and the walk
 14. val_fp32  `YOLO11Validator.validate` of yolo11n detect, segment, pose
             and OBB (nc 15) (fp32, 640 px, the val defaults: batch 16, conf
             0.001, iou 0.6, multi-label, pre_topk 4096: OBB's pool is 4096
             of its (anchor, class) pairs, kernel C at K = 4096) on cuda and
             on cpu over seeded PNG datasets of 24 frames of two sizes (16,
             one batch, for segment and OBB) written with `save_image` and
             labelled with the cpu predictions
             at conf 0.25 (segment: each box's inscribed octagon as its
             polygon; OBB: each rotated box's corners): mAP50-95, mAP50 and mask and pose
             mAP within 1e-3, and (detect and pose; segment and OBB report
             them) each batch's detections with score >= 0.25 paired as sets
             (boxes within PX_TOL, scores within SCORE_TOL, keypoints within
             KPT_TOL); the launches of one batch's body: B,
             F and G (C for OBB) >= 1; and `evaluate_classifier` of
             yolo11n-cls (224 px, batch 64) over the same frames in a
             class-per-directory tree labelled with the cpu ranking (first,
             third, seventh class): top-1 and top-5 equal on both, B >= 1
 15. val_bf16  the validation path: yolo11n detect bf16 validation at 640
             px, batch 16, conf 0.001, iou 0.6, pre_topk 4096 over 64
             frames, run twice (one graph; one batch's body uncaptured with
             the counters reset: F and G must each read >= 1), the second
             timed: images/s and
             inference_ms_per_image from the validator, peak device
             memory, kernels F and G and the plain IoU build in front of G
             at the captured inputs (F within 1e-5, G bit-equal; device
             times, L2 flushed before each call, beside their bounds; F warm
             too), and the device time by kernel over three batches; then
             the same for segment b16/640 and OBB (nc 15) b16/1024 over 32
             frames each and classify b64/224 over 128 (`VAL_TIMED`):
             images/s, peak memory, launches (B, F, G; B, F, C; B), the
             kernels' busy share of one more run under torch.profiler, and
             the kernels at each path's own inputs: G on the segment path, C at
             K = 4096 (bit-equal to its plain version; cold, warm, bits pass
             and walk apart, bound) and F on the OBB path
 16. q8_fp32  yolo11s detect static8 (PTQ on the cpu, f32 compute) `predict`
             on two 480x640 frames at 640 px on cuda and on cpu (TF32 off):
             kernel E's counter rises, and at least Q8_PAIRED of the
             detections scoring >= 0.35 on either device have a partner on
             the other (same class, IoU >= 0.5, score within 0.1); the
             pairs' box and score errors are printed
 17. q8_bf16  the static8 path: yolo11s PTQ through `create_quantizer` on
             the card, then static8 `predict` at batch 32 on 640x640 frames,
             its body once uncaptured with the counters reset (E must read 48,
             A and B >= 1) and
             every E input captured (channel chunks keep their pixel pitch),
             then timed beside the bf16 yolo11s on the same frames and
             weights; E at each of its 48 inputs (bit-equal to its plain
             version; per-launch and summed device times beside their
             bounds), the device time by kernel, the copy kernels with the
             chunks read in place against the same path with every E input
             copied to a contiguous NHWC tensor first, and the
             fidelity gate: both models validated (single-label, iou 0.45)
             on the frames labelled by the bf16 model's detections at conf
             0.25; static8 mAP50 >= 0.9
 18. int8     kernel E (`int8_conv`) vs its plain version on the card at
             random int8 inputs for each (k, stride) in {1, 3} x {1, 2} and
             both epilogues: contiguous (32, 20, 20, 256) -> 128 and (3, 13,
             11, 130) -> 70, the channel chunk of the first 128 of 256
             channels (pixel pitch 256) -> 128, and (2, 9, 9, 512) -> 64 of
             large positive codes (int32 sums of up to ~6e7, which round on
             their way to f32); bit-equal (any ±1-code count printed)
 19. attn_packed  kernel H (`attention_packed`) vs its plain version on the
             card: bf16 (64, 400, 128) within 2e-2, f32 within 1e-5, bf16 at
             N=1600; and H on a head-major copy vs B on the same slab
 20. attn_pallas  the `YOLO_ATTN_IMPL=pallas` route: yolo11n bf16 `predict`
             at batch 32 on 640x640 frames (the knob is part of the cache key:
             a new capture), its run and its body uncaptured with the
             counters reset (H >= 1, B 0), Results equal to the default route's, timed as in phase
             5, and H at its captured input beside its bound
 21. many    `predict_many` at batch_size 32 over 150 seeded 640x640 frames
             (five chunks, the last padded) and 40 frames of two sizes,
             against `predict` on the same padded chunks: equal counts and
             classes, boxes within 1e-3 px, scores within 1e-5, one A and one
             B per chunk by name in a trace, no Python launch and no new
             cache entry (phase 5's b32 graph replays every chunk); segment
             `predict_many` over 64 frames, its masks
             (held on the host, read through `LazyMasks`) equal to
             `predict`'s bit for bit; img/s of `predict_many` against a loop
             of `predict` over the same frames (in turns); the ms of HtoD
             copy that overlap kernels in a torch.profiler trace of one
             `predict_many`; `predict_raw` of detect, segment,
             pose and OBB under `torch.cuda.set_sync_debug_mode("error")`:
             any host synchronisation fails the phase
 22. mask_modes  segment fp32 `predict` on two frames of different sizes,
             cuda vs cpu, for mask_mode "q8" and "exact" (soft masks within
             one q8 code, 1/255), "bits" and "auto" (binary, at most 1e-4 of
             the pixels differing, as phase 9); "auto" at 640 px equal to
             "device_half" on the card
 23. bench   `YOLO11Model("yolo11n").benchmark(imgsz=640, batch=32,
             runs=20, warmup=3)` with the JAX package's keys;
             `SpeedBenchmark.benchmark_throughput(duration_s=5)` with
             `ResourceMonitor` samples holding device memory;
             `benchmark_quantization(methods=("ptq",), batch=8)` with its
             speedup; beside the card's name and power limit
 24. exported  the exported serving program (`core/exported.py`): yolo11n
             detect bf16 at b32/640, exported on the card, loaded and
             captured into one CUDA graph; the replay equal bit for bit to
             the loaded program's eager run, to the live predictor's eager
             body (`serve_program`, the yardstick) and to live `predict_raw`
             (the live predictor's own graph) at two conf/iou pairs, (0.25,
             0.45) and (0.10, 0.60), from the one capture (the pairs'
             detections must differ; where live and replay differ, an f32
             artifact is held to phase 4's tolerances); a replay's result
             unchanged by the next replay on other frames; the eager run's
             launch counts (A, B), none from the replays; at b32 and at
             b1/640, replay, live `predict_raw` and the eager body: the host
             ms until the call returns, host-clock ms per call, CUDA-event ms
             over back-to-back calls and the kernels' summed device ms; A's
             and B's kernel functions in a torch.profiler trace of a replay
 25. exported_tasks  segment b8/640 (A, B, D; masks read after a later call
             unchanged), OBB b4/1024 (B, C, F), multi_label detect b8/640
             (F, G), static8 yolo11s b32/640 (E, 48 launches in the eager run
             and per replay) and the pallas route b8/640 (H): each artifact
             exported, loaded, captured, its replay equal bit for bit to its
             eager run; every kernel A-H by function name in some replay's
             trace (the Python counters do not tick on a replay)
 26. checkpoints  JAX-format `.msgpack` files written by the port from the
             phase 4 weights, fused bf16 and unfused f32, served on cuda
             against the same file on the cpu (f32 compute, TF32 off, phase
             4's tolerances); `save` -> `load` to identical state; a
             safetensors export read back equal
 27. live_graphs  the live program cache (LIVE_PATHS, bf16): detect b32/640
             and b1/640, multi_label detect b16/640 (pre_topk 4096), segment
             b32/640 "device" and b8 "q8", "bits", "exact", pose b16/640,
             OBB b16/1024 and its multi-label validation signature (pre_topk
             4096), classify b32/224, static8 yolo11s b32/640 and the
             pallas route b32/640, each captured by its first `predict_raw`
             (its launches (1 + WARMUP_CALLS) times the eager body's) and
             replayed at (0.25, 0.45) and (0.10, 0.60): equal bit for bit to
             the eager body, no Python launch; a result unchanged by the next
             call (the exported `predict_raw`'s in phase 24);
             `predict_many` over 150 frames equal to `predict` on the same
             chunks with one b32 cache entry; A-H by function name in live
             replay traces, each as often per replay as its path's eager
             body launches it (E 48); captured against eager
             (`call_times`) at detect b32 and b1 and static8 b32; capture
             seconds and reserved device memory per signature; b1 `predict`
             at 3 * PROGRAM_CACHE_SIZE frame sizes (`bounded_cache`): the
             cache keeps PROGRAM_CACHE_SIZE programs and the reserved memory
             stays within one program's share of the full cache's
 28. cli     the command line in process (`cli.YOLO11CLI().run`), yolo11n:
             the port's JPEG decoder on every fixture of tests/torch_jpeg/
             (OpenCV's pixel hashes from its manifest) and the decode
             seconds of assets/sample.jpg (640x480, 4:2:0); the encoder's
             bytes for the seeded frames `jpeg_frame(0..3)` against OpenCV's
             hashes and the PSNR of their round trip; then `info`; `demo`
             on the sample with the phase 4 weights written as a `.msgpack`
             by the port (bf16), and in f32 on cuda and on cpu (phase 4's
             tolerances); `demo` on a directory of 8 JPEGs the port's
             encoder wrote (host seconds per image: decode, predict, draw,
             encode); `val --batch 16` on 32 seeded JPEG frames labelled
             with the model's own f32 detections (a dataset YAML written by
             `create_dataset_config`), its metrics equal to
             `YOLO11Validator.validate` on the same files; `optimize --method
             ptq` and `demo` on its output (static8); `benchmark --type sizes`
             at 640, batch 1 and 32, 20 runs; `optimize --method qat`
             without data exits 1 (as `main.py`) and a missing input exits
             2. A, B, E, F
             and G must each launch in these runs
 29. train   detect training on the card (`TRAIN`): `YOLO11CLI().run(["train",
             "--model-size", "n", ...])` in process, 2 epochs at batch 16 and
             640 px (bf16, `TrainingConfig`'s defaults, robust) on a seeded
             PNG dataset of coloured rectangles with exact labels (96
             training and 32 validation frames of 640x480): exit 0, status
             "completed", no skipped step; F and G launch in every epoch's
             validation, B never inside a train step (wrappers around
             `make_train_step`'s step and `_validate_ema` read the counters);
             images/s and the loader's wait per step of each epoch and the
             validation seconds (the run's timing.json); the loader's host
             seconds per batch with mosaic on (the CLI run's 2 epochs are
             inside `close_mosaic`); then an fp32 step on
             the same weights and batch (b2, 640 px) on cuda and on cpu:
             loss within `TRAIN_LOSS_RTOL`, the parameter update within
             `TRAIN_UPDATE_RTOL` (norm of the difference over the cpu
             update's), batch-norm state within `TRAIN_BN_ATOL`; then 40
             steps on one fixed batch of 16 (no augmentation, no warmup,
             bf16): the mean loss of the last five below 0.8x the first
             five's, the median step ms (CUDA events), the peak device
             memory, and the ten largest kernels of one traced step
             (torch.profiler) with its kernels' device ms, whose share of the
             epoch's wall time per step is the device busy share of training
 30. optimize  every task trains and every optimize method runs (`OPT_*`):
             yolo11n segment, pose and OBB each `YOLO11Model.train` for one
             epoch at batch 16 and 640 px (bf16) on a seeded one-class PNG
             dataset with exact labels (`write_shapes_dataset`: filled
             hexagons, rectangles with 17 keypoints, filled rotated
             rectangles; 32 training and 16 validation frames): status
             "completed", no skipped step, B never inside a step, the
             epoch's validation launches G (segment, pose) or C and F (OBB),
             and an fp32 step of each (b2, 640 px) cuda against cpu within
             phase 29's tolerances; dynamic int8 yolo11n and yolo11s at
             b32/640 (bf16): the path's launches of E, E's float epilogue
             bit-equal to its plain version at every input of the path's
             body (the stem's Ci = 3 among them), its summed times and
             bound, img/s beside the bf16 and static8 models; yolo11n
             dynamic fp32 `predict` cuda against cpu (paired as phase 16);
             a model carrying 1-D (legacy static) scales serves through E;
             QAT (`create_quantizer("qat", ..., {"epochs": 1})`) trains and
             its int8 model serves; magnitude masks at 0.5 hit their target
             on the card, and a masked fine-tune keeps every pinned zero;
             channel surgery at 0.5: the slim model equals the zeroed one in
             fp32 within `SLIM_TOL`, its img/s against the dense model's, its
             exported program smaller than the dense one's and its replay
             equal to its eager run; distillation of a yolo11s teacher into
             a yolo11n student for one epoch, B launching inside every step
             (the teacher's attention). E's kernels-line row gains the
             dynamic paths' launches, times and bound under "dynamic"
 31. parallel  multi-device training and serving on torch.distributed
             (`yolo_infer_tpu_torch/parallel/`), ~60-90 s. (a) NCCL, a world
             of one on cuda:0 (a `FileStore` rendezvous, in this process):
             `MultiChipTrainer(device_ids=[0])` trains yolo11n (nc 3) for one
             epoch at b16/640 bf16 on phase 29's seeded PNGs (6 steps, each
             timed by CUDA events); an fp32 b2/640 meshed step against the
             unmeshed step from the same state (loss within 1e-5 relative,
             the update within `PAR_UPDATE_RTOL` of its norm, batch-norm state
             within 1e-5) with its count of all_reduce, all_gather and
             broadcast calls, and the unmeshed step on the batch's images
             swapped beside it (f32 rounding alone); bf16 b16/640 step ms,
             meshed against unmeshed, in turns, then one torch.profiler
             trace of each (kernels' device ms and launches, each op's self
             host ms, and the ops that hold the meshed step's extra host
             time); a meshed bf16 `Predictor` (phase 4's weights) at
             b32/640: A and B launched by its run, A's input (32, 384, 4)
             in an eager call (the one-process tail on the rank's slice),
             img/s beside the unmeshed predictor's in turns, and fp32
             meshed against unmeshed `predict` on two frames (counts
             equal, detections paired within 1e-2 px and 1e-5). (b) two gloo processes, both on cuda:0
             (`parallel/distributed.py launch`, a join limit: a rank that
             fails or hangs fails the phase and the other is killed): the
             fp32 DP step at 2 x 1 images of 640 px against the one-process
             step on both (as in (a); the ranks' states equal bit for bit),
             meshed fp32 `predict` at b32 (16 per rank), equal on both ranks
             and paired with the one-process result, a 1-epoch b16/640
             training run with validation whose run directory only rank 0
             writes (each rank's writers counted), and `dryrun_multichip(2)`
             (tp = 2) with its loss. gloo stages CUDA tensors through the
             host: (b)'s seconds time correctness plumbing, not NCCL
 32. video   the batched video demo (`DetectionDemo.detect_video`), ~40 s:
             the port's writer makes a motion-JPEG AVI of 30 seeded 640x480
             frames at 30 fps (no OpenCV on the card's machine); phase 4's
             weights, written as a `.msgpack`, run it at b8/640 bf16 with an
             output AVI. The path's run (its first batch captures the b8/640
             signature) counts A and B at (1 + WARMUP_CALLS) times one
             uncaptured body call; 30 frames out, every frame's detections
             (the boxes and scores drawn) equal to the same predictor's
             `predict_raw` on the frames the demo decoded (the first equal to
             the port's reader's), letterboxed on the host and batched as the
             demo batches them (counts and classes equal, boxes within 1e-3
             px, scores within 1e-5); the output read back by the port with 30 frames of 640x480, its
             first frame bit-equal to `decode_jpeg(encode_jpeg(...))` of the
             first annotated frame. A second run under torch.profiler: A and
             B once per batch by name, frames/s, the host seconds per frame
             by part (decode, letterbox, device wait, the rest of the
             pipeline, draw, encode; `DetectionDemo.last_timing`) and the
             kernels' busy share of its wall time, each on a line of its own
             beside the card's name and power limit. Then segment video
             frame by frame over 4 frames (`predict` and `draw_results` per
             frame): A, B and D launched
 33. formats every still-image format on the card's host, ~40 s: each
             fixture of `tests/torch_formats/` (since phase 36's slice also
             1-bit, CCITT and JPEG-in-TIFF and progressive JPEGs cut short)
             decodes to its manifest's
             hash of OpenCV's pixels and shape, and each refused file raises
             as listed; a seeded 480x640 frame written as `.bmp`, `.tiff`
             and `.webp` by the port reads back bit for bit; the host
             seconds to decode one 480x640 frame in each format (median of
             3) on a line beside the card's name and power limit; `val`
             through the CLI (yolo11n detect, b16/640 bf16, phase 4's
             weights) over 32 seeded frames stored as progressive JPEG,
             palette PNG, 16-bit PNG, LZW TIFF, lossless WebP, lossy WebP
             and 8-bit BMP (written here: no OpenCV on the card's machine;
             the lossy files are the key frames of phase 35's WebM in a
             RIFF), labelled with
             the model's own detections, then over the same frames as the
             port decoded them, saved as PNG: every metric equal, F and G
             launched; the demo on a progressive JPEG, a lossless and a
             lossy WebP of one frame: detections equal to the demo's on the PNG copy of each
             decode (1e-3 px, 1e-5; bit equality reported), A and B launched
 34. mpeg4   MPEG-4 Part 2 video on the card's host, ~60 s: each fixture of
             `tests/torch_video/` (OpenCV-written MP4, MOV, Matroska and
             XVID/FMP4/DIVX AVI with I- and P-VOPs, port-written files with
             AC prediction, raw I420 and IYUV AVIs, an odd width among them)
             decodes to its manifest's sha256 of every frame
             OpenCV decodes, and its info; each refused file (VP8 WebM, an
             `avc1` MP4, VOLs announcing B-VOPs, quarter-pel, interlace or
             MPEG quantisation, a truncated MP4, raw I420 of an odd height)
             raises as listed (its VP8
             WebM from OpenCV's writer now decodes to its hashes too); phase 32's
             30 seeded 640x480 frames written to `.mp4` by the port read back
             bit-equal to the encoder's reconstruction; `detect_video`
             (yolo11n, b8/640 bf16, phase 4's weights) over the committed
             24-frame 640x480 fixture with `.mp4` output: every frame's
             detections equal to `predict_raw` on the frames the demo decoded
             (boxes within 1e-3 px, scores within 1e-5), A and B launched,
             the output read back by the port (its first frame bit-equal to
             the encoder's reconstruction of the first annotated frame); a
             second run under torch.profiler: A and B once per batch by
             name, frames/s, host seconds per frame by part and the kernels'
             busy share; and the host seconds to decode one 640x480 I-VOP
             and one P-VOP and to encode one frame (median of 3), each on a
             line beside the card's name and power limit
 35. vp8     VP8 on the card's host, ~40 s: each WebM fixture of
             `tests/torch_vp8/` (OpenCV's `VP80` writer, 176x144 and the
             24-frame 640x480 demo file; libvpx's versions 1-3, 8 token
             partitions, error resilience, sharpness, an altref with hidden
             frames, an odd width) decodes to its manifest's sha256 of every
             frame OpenCV decodes, and its info; each refused file (an odd
             height, VP9, a truncated WebM) raises as listed; the host
             seconds to decode the demo file's key frame, its first inter
             frame and a 480x640 lossy WebP (that key frame in a RIFF, as the
             port has no VP8 encoder; median of 3); `detect_video` (yolo11n,
             b8/640 bf16) over the 640x480 WebM with `.mp4` output, checked
             as phase 34 checks its demo (`check_video_demo`: every frame's
             detections equal to `predict_raw`, A and B launched, and once
             per batch by name in a traced second run; frames/s, host
             seconds per frame by part, the kernels' busy share), the frames
             it drew on equal to the manifest's, the output read back
 36. scripts the repo's scripts as the port runs them
             (`yolo_infer_tpu_torch.scripts.*`, in this process), on phase
             4's weights saved as a checkpoint: `benchmark` yolo11n b32/640
             with `--int8` (the JAX script's JSON keys; A and B in the bf16
             run, E 72 times a call in the dynamic-int8 run, each run's
             launches (1 + WARMUP_CALLS) times one uncaptured body call);
             `export_dynamic` (the file reloaded serves as dynamic int8, and
             its `predict_raw` on the card equals the quantizer's own
             model's bit for bit); `val_matrix` at 640 over 480x640 frames
             in the kinds the port reads since this phase (1-bit PackBits
             TIFF, CCITT modified Huffman, T.4 one- and two-dimensional and
             T.6, YCbCr 4:2:0 JPEG-in-TIFF in strips, a progressive JPEG
             cut short), written here (the bilevel files decode to their
             bits exactly): metrics and `confusion_matrix.txt` equal to a
             direct `validate` in the same process, F and G launched;
             `train`: one QAT epoch at 640 on a small rectangle set writes
             its checkpoint, and the int8 file is refused before any step

Phase 15 also holds G's bits pass to the card's HBM rate (3.35 TB/s) over
the pairs of valid candidates it must read, with L2 flushed before each call,
on the path's IoU and on a fresh random one, beside torch's own read of as
many bytes (a sum) and the whole call timed by CUDA events (`g_read_check`).

Every torch.profiler time comes from a trace whose kernels each launched a
multiple of its calls and that kept some of its lead-in (`traced_rows` traces
again otherwise: the profiler loses the first records of a trace once a few
dozen traces have been taken, and the time then reads low); a line after the
phases lists the traces taken again.

Then it prints the card's name and power limit, the per-kernel JSON line (A
and B measured on the detect path, C on the OBB path, D on the segment path,
F and G on the validation path, E on the static8 path, H on the pallas
route; on each row `launches` from that path's own run and
`launches_per_call` from its uncaptured body) and, last, {"ok": true, "device": {...}}.
Any failed phase exits non-zero without that last line; so does a host
without CUDA or a directory without the port. Phase names given as
arguments (`python3 chip_smoke.py exported checkpoints`) run those phases
alone, after the card's phase, for a quick check; such a run lacks the
kernels line and exits non-zero.
"""

from __future__ import annotations

import collections
import copy
import faulthandler
import json
import os
import re
import shutil
import struct
import subprocess
import sys
import tempfile
import time
import traceback
import zlib
from pathlib import Path
from types import SimpleNamespace

import numpy as np

SEED = 0
H100_BYTES_PER_S = 3.35e12  # HBM3, SXM part (NVIDIA data sheet)
H100_F32_FLOPS = 67e12  # f32 outside the tensor cores, an FMA counted as two operations
# the same units without FMA: one f32 operation per lane and cycle. Kernels
# A, C and D are built with --fmad=false (each product and sum rounds apart,
# as the plain versions'), so their operation bounds divide by this rate
H100_F32_OPS_UNFUSED = H100_F32_FLOPS / 2
H100_BF16_FLOPS = 989e12  # dense bf16 tensor cores
H100_INT8_OPS = 1979e12  # dense int8 tensor cores
IOU_OPS = 14  # f32 operations for one IoU and its compare (ops/iou.py order)
# f32 operations for one probIoU and its compare (ops/rotated.py order): 9
# additions or subtractions, 12 products, 2 divisions, 2 square roots, one
# log, one exp, a negation, 4 clamp sides, one compare (ops per pair; each
# candidate's clamped determinant adds 4 ops per candidate)
PROBIOU_OPS = 38
# kernel D per output pixel: the W tap (2 products, 1 sum) and the compare;
# per upsampled row and source column: the H tap (2 products, 1 sum)
PACK_OPS_PER_PIXEL = 4
PACK_OPS_PER_HTAP = 3
# cuda vs cpu in f32 (phase 9): sums taken in another order through the 24
# layers move head outputs by ~1e-5 of their size; coordinates reach the
# frame's 640 px (keypoint offsets are also scaled by the stride, 32) and a
# logit of a few units moves its sigmoid by up to ~2e-5
PX_TOL = 5e-2
SCORE_TOL = 1e-4
# val_fp32 keypoints: a keypoint is (offset * 2 + anchor) * stride, so the
# head's cuda-vs-cpu difference reaches it 64x at stride 32, and the
# validation keeps ~9k pairs at score >= 0.25 (serving: ~600): 0.058 px seen
KPT_TOL = 0.1
SEG_SERVE = (32, 640)  # segment path: batch, imgsz
OBB_SERVE = (16, 1024)  # OBB path: batch, imgsz (the OBB models' input size)
# kernel F per logit: max, subtraction, exp, product and two sums; per side
# one division (exp counted as one operation)
DFL_OPS_PER_LOGIT = 6
# kernel F against its plain version: both sum in f32, in another order
DFL_TOL = 1e-5
VAL = dict(imgsz=640, batch=16, conf=0.001, iou=0.6, pre_topk=4096)  # the validator's defaults
VAL_FP32_FRAMES = 24
# segment and OBB validate half of each size's frames (one batch): their cpu
# runs (the (16, 4096, 4096) IoU or probIoU on the host) set phase 14's time
VAL_FP32_TASK_FRAMES = {"segment": 16, "obb": 16}
VAL_BF16_FRAMES = 64
Q8_SERVE = (32, 640)  # static8 path: yolo11s, batch, imgsz
ATTN_SERVE = (32, 640)  # YOLO_ATTN_IMPL=pallas route: yolo11n, batch, imgsz
Q8_E_LAUNCHES = 48  # static8 convs of yolo11s at b32/640 under the default eligibility
# q8_fp32: E equals its plain version, but a float op that rounds differently
# on the two devices (a bf16 exempted conv, an exp) moves an int8 code at a
# rounding edge, and each moved code is a whole quantization step at the next
# conv's input: the moved codes multiply layer by layer up to the int8 noise
# floor (~1% of the head maps, as between the port and the JAX package on the
# CPU), which reorders near-equal candidates in NMS. So the two devices are
# held as two int8 implementations are: detections paired by IoU and score,
# a share of them (the first run on the H100: 269 of 594 detections missed a
# partner within 1 px and 1e-2)
Q8_PAIRED = 0.9
Q8_CLS_SHARE = 2e-4  # (anchor, class) pairs scoring above 0.25 on the calibration frames
# B and H in bf16 against their plain versions: atol = rtol = 2e-2, as
# torch.testing.assert_close reads them (one bf16 ulp of an output in [4, 8)
# is 0.03125: the tensor cores sum p.v in another order than the plain f32
# product, so an output near a rounding edge may round the other way)
ATTN_BF16_TOL = 2e-2


def attn_tol_excess(got, want) -> float:
    """max(|got - want| - (atol + rtol * |want|)) at ATTN_BF16_TOL: <= 0 when within it."""
    g, w = got.float(), want.float()
    return float(((g - w).abs() - ATTN_BF16_TOL * (1 + w.abs())).max())


def bound(bytes_: float, ops: float, ops_per_s: float):
    """The least time for the work, in ms: the larger of the bytes over the
    memory rate and the operations over `ops_per_s`, and which of them it is."""
    by_bytes, by_ops = bytes_ / H100_BYTES_PER_S, ops / ops_per_s
    return {"bound_ms": 1e3 * max(by_bytes, by_ops), "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean device time of `fn` over `iters` back-to-back calls (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


RETRACES = []  # traces taken again, and why (printed after the phases)
HEAD_LOST = collections.Counter()  # lead-in records lost per trace -> traces (printed after the phases)
LEAD_IN = "spin_kernel"  # torch.cuda._sleep's kernel: the lead-in of every trace, left out of its rows
LEAD_INS = 64  # lead-in kernels of a trace at first; four times as many after a trace that kept none


def lead_in(n: int):
    """Launch `n` short sleep kernels and wait for them: the head of a trace.
    The profiler loses the first device records of a trace: none in a fresh
    process, but once a few dozen traces have been taken in it often 3 to
    13, now and then more (a lead-in of 8 kernels went whole, trace after
    trace, and the first kernels of the calls with it). The lead-in takes
    that loss."""
    import torch

    for _ in range(n):
        torch.cuda._sleep(1000)
    torch.cuda.synchronize()


def traced_rows(fn, calls: int, need=()):
    """[(key, device ms summed over the trace, events)] of each device
    activity over `calls` calls of `fn` under torch.profiler, and the wall ms
    per call. Each trace starts with a lead-in (`lead_in`), and is kept only
    if some of its lead-in records survive: the records lost at its head
    were then all lead-in. The profiler also now and then hands back no
    device events. A trace that kept no lead-in record (the next lead-in is
    four times as long), or has a kernel whose count is no multiple of
    `calls`, or lacks a kernel named in `need`, is taken again (five tries
    in all)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    lead = LEAD_INS
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            lead_in(lead)
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0) / calls
        device = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
        lead_kept = sum(e.count for e in device if LEAD_IN in e.key)
        HEAD_LOST[lead - lead_kept] += 1
        # device-side events only (CPU ops also carry their kernels' time); the
        # profiler's own buffer requests are not the program's work
        rows = [(e.key, e.self_device_time_total / 1e3, e.count) for e in device
                if e.self_device_time_total > 0 and e.key != "Activity Buffer Request" and LEAD_IN not in e.key]
        short = [(k[:80], n) for k, _, n in rows if n % calls and not k.startswith(("Memcpy", "Memset"))]
        missing = [sub for sub in need if not any(sub in k for k, _, _ in rows)]
        if rows and lead_kept and not short and not missing:
            return rows, wall_ms
        RETRACES.append({"calls": calls, "lead_in": lead, "lead_in_kept": lead_kept, "short": short[:4],
                         "missing": missing, "empty": not rows})
        if not lead_kept:
            lead *= 4
    raise AssertionError(f"torch.profiler lost kernel events in five traces: {RETRACES[-1]}")


def device_ms(fn, iters: int = 20) -> float:
    """Mean device time of the kernels one call of `fn` launches (torch.profiler),
    without the host's launch overhead between calls; copies excluded."""
    rows, _ = traced_rows(fn, iters)
    return sum(ms for k, ms, _ in rows if not k.startswith(("Memcpy", "Memset"))) / iters


def device_ms_each(fns, iters: int = 3):
    """Device time of each call in `fns` (median of `iters` rounds), by CUDA
    events around each call. Every launch is queued behind a sleep on the
    stream first, so the calls run back to back on the card and the host's
    launch overhead stays outside each event pair."""
    import torch

    for fn in fns:
        fn()
    torch.cuda.synchronize()
    marks = [[(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)) for _ in fns]
             for _ in range(iters)]
    torch.cuda._sleep(1_000_000_000)  # ~0.5 s of card cycles, longer than queueing the calls below
    t0 = time.perf_counter()
    for row in marks:
        for fn, (start, end) in zip(fns, row):
            start.record()
            fn()
            end.record()
    queued_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    if queued_s > 0.4:
        raise AssertionError(f"queueing the timed calls took {queued_s:.3f} s, longer than the sleep ahead of them")
    ms = np.array([[start.elapsed_time(end) for start, end in row] for row in marks])
    return [float(v) for v in np.median(ms, axis=0)]


def jpeg_frame(seed: int, h: int = 480, w: int = 640) -> np.ndarray:
    """A seeded RGB frame with a photo's structure in integer arithmetic
    only (the same pixels on any host): colour gradients, six flat boxes
    and noise of +-12. `tests/torch_jpeg/make_fixtures.py` hashes OpenCV's
    JPEG bytes of these frames into the fixtures' manifest."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    img = np.stack([x * 255 // w, y * 255 // h, (x + y) * 255 // (w + h)], axis=-1)
    for _ in range(6):
        x0, y0 = int(rng.integers(0, w)), int(rng.integers(0, h))
        img[y0: y0 + int(rng.integers(1, h // 3 + 2)), x0: x0 + int(rng.integers(1, w // 3 + 2))] = \
            rng.integers(0, 256, 3)
    img = img + rng.integers(-12, 13, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def random_candidates(rng, b: int, k: int):
    """Score-sorted random boxes in a 640 px frame, as in the JAX kernel tests."""
    cxy = rng.uniform(50, 590, (b, k, 2))
    wh = rng.uniform(10, 120, (b, k, 2))
    boxes = np.concatenate([cxy - wh / 2, cxy + wh / 2], -1).astype(np.float32)
    scores = -np.sort(-rng.uniform(0, 1, (b, k)).astype(np.float32), axis=1)
    return boxes, scores > 0.15


def smoke_weights(frames_u8: np.ndarray, task: str = "detect", nc: int = 80, size: str = "n",
                  calibrate_bn: bool = True):
    """Weights of yolo11`size` `task` for the device comparisons.

    The seeded init (`build_model`) with the class-head biases at 0, and each
    batch norm's statistics set to those of its conv's output on `frames_u8`.
    The plain init's activations fade through the graph (class logits near
    1e-4, so scores tie at f32 resolution and any rounding reorders them);
    with the statistics calibrated, every layer feeds the next at unit scale
    and the logits spread over O(1). For segment the mask-coefficient convs
    are then scaled so the mask logits (prototypes x coefficients) spread at
    unit standard deviation too: mask pixels sit at sigmoid 0.5 only rarely.

    With `calibrate_bn=False` (the int8 phases) the batch norms keep the
    seeded init instead: its activations fade, so the rounding that each
    int8 conv adds does not grow with depth (at unit-scale statistics a
    random net carries it on to the head: 15-54% mean head error against
    f32, `tests/torch_int8_drift.py`). The detect head's box and class projections are then
    rescaled so their logits spread at standard deviation 2, and the class
    bias set so that Q8_CLS_SHARE of (anchor, class) pairs score above 0.25
    on `frames_u8`.
    """
    import torch

    from yolo_infer_tpu_torch.models.blocks import Conv, Detect
    from yolo_infer_tpu_torch.models.yolo11 import build_model
    from yolo_infer_tpu_torch.ops.preprocess import preprocess_batch

    model, spec = build_model(task, size, nc=nc, seed=SEED)
    head = model.model[-1]
    x = preprocess_batch(torch.from_numpy(frames_u8), (640, 640))
    hooks = []
    with torch.no_grad():
        if not calibrate_bn:
            for branch in list(head.cv2) + list(head.cv3):
                branch[-1].bias.zero_()
            feats = torch.cat([f.reshape(-1, f.shape[-1]) for f in model(x)["feats"]])
            box, cls = feats[:, :4 * spec.reg_max], feats[:, 4 * spec.reg_max:]
            for branch in head.cv2:
                branch[-1].weight.mul_(2.0 / box.std())
            for branch in head.cv3:
                branch[-1].weight.mul_(2.0 / cls.std())
                branch[-1].bias.fill_(float(np.log(1 / 3) - np.quantile((cls * (2.0 / cls.std())).numpy(),
                                                                        1 - Q8_CLS_SHARE)))
            return model, spec
        if isinstance(head, Detect):
            for branch in head.cv3:
                branch[-1].bias.zero_()
        for m in model.modules():
            if isinstance(m, Conv):
                def calibrate(conv, inp, out, bn=m.bn):
                    bn.running_mean.copy_(out.mean((0, 2, 3)))
                    bn.running_var.copy_(out.var((0, 2, 3)))
                hooks.append(m.conv.register_forward_hook(calibrate))
        out = model(x)
        for h in hooks:
            h.remove()
        if task == "segment":
            b = x.shape[0]
            mc = torch.cat([m.reshape(b, -1, m.shape[-1]) for m in out["mc"]], 1)
            pick = torch.from_numpy(np.random.default_rng(SEED).choice(mc.shape[1], 256, replace=False))
            spread = torch.bmm(out["proto"].reshape(b, -1, mc.shape[-1]), mc[:, pick].transpose(1, 2)).std()
            for branch in head.cv4:
                branch[-1].weight.div_(spread)
                branch[-1].bias.div_(spread)
    return model, spec


def match_detections(a, b, box_tol: float, score_tol: float):
    """Pair the detections of `a` with partners in `b` (same class, box and
    score within tolerance; equal scores may come out in either order).
    Returns (number of `a` detections with no partner, [(i, j), ...])."""
    used = np.zeros(len(b), bool)
    missing, pairs = 0, []
    for i in range(len(a)):
        hit = np.nonzero(~used & (b.classes == a.classes[i])
                         & (np.abs(b.boxes - a.boxes[i]).max(axis=1) <= box_tol)
                         & (np.abs(b.scores - a.scores[i]) <= score_tol))[0]
        if len(hit):
            used[hit[0]] = True
            pairs.append((i, int(hit[0])))
        else:
            missing += 1
    return missing, pairs


def counters():
    """The eight kernel wrappers, by name (their `launches` attributes are the counts)."""
    from yolo_infer_tpu_torch.ops.kernels import (
        attention_fused,
        dfl_decode,
        greedy_nms,
        int8_conv,
        mask_pack,
        nms_fused,
        rotated_nms_fused,
    )

    return {"nms_keep": nms_fused.nms_keep, "attention_qkv": attention_fused.attention_qkv,
            "rotated_nms_keep": rotated_nms_fused.rotated_nms_keep,
            "upsample4x_threshold_pack": mask_pack.upsample4x_threshold_pack,
            "dfl_decode": dfl_decode.dfl_decode, "greedy_nms_keep": greedy_nms.greedy_nms_keep,
            "int8_conv": int8_conv.int8_conv, "attention_packed": attention_fused.attention_packed}


def reset_counters() -> None:
    for fn in counters().values():
        fn.launches = 0


def read_counters():
    return {name: fn.launches for name, fn in counters().items()}


def path_counters(run):
    """The launch counts of one path's own run, as the kernels line reads
    them: every count set to 0 just before `run()` (the path's calls, its
    first one capturing the signature) and read just after it."""
    import torch

    reset_counters()
    result = run()
    torch.cuda.synchronize()
    return read_counters(), result


# each kernel's functions in a torch.profiler trace; the first counts its
# launches (H launches B's function with heads = 1 on the pallas route, where
# B does not run)
KERNEL_FUNCTIONS = {"nms_keep": ("iou_bits_kernel", "greedy_walk_kernel"),
                    "attention_qkv": ("attn_qkv_mma_kernel",),
                    "rotated_nms_keep": ("probiou_bits_kernel", "greedy_walk_kernel"),
                    "upsample4x_threshold_pack": ("mask_pack_kernel",),
                    "int8_conv": ("int8_conv_kernel",),
                    "dfl_decode": ("dfl_decode_kernel",),
                    "greedy_nms_keep": ("suppression_bits_kernel", "greedy_walk_kernel"),
                    "attention_packed": ("attn_qkv_mma_kernel",)}


def path_launches(where: str, names, path, body):
    """Hold one path's launches of each kernel in `names`: the path's own
    run (`path`, from `path_counters`: its first call runs each kernel once
    per warm-up call and records it once into the graph; a replay calls no
    wrapper) counted (1 + WARMUP_CALLS) times the uncaptured body's one call
    (`body`, >= 1). Returns each kernel's fields for the kernels line; a
    replay's launches by kernel name are phase 27's to count."""
    from yolo_infer_tpu_torch.core.graphs import WARMUP_CALLS

    rows = {k: {"launches": path[k], "launches_per_call": body[k]} for k in names}
    bad = {k: r for k, r in rows.items()
           if r["launches"] != (1 + WARMUP_CALLS) * r["launches_per_call"] or r["launches_per_call"] < 1}
    if bad:
        raise AssertionError(f"{where}: the path's run and one body call do not agree "
                             f"(warm-up calls {WARMUP_CALLS}): {bad}")
    return rows


def eager_call(pred, frames_dev, imgsz: int, conf: float = 0.25, iou: float = 0.45, **kw):
    """One uncaptured call of `pred`'s serving body (`Predictor.serve_program`,
    what each of its CUDA graphs replays) on frames on the card: the eager
    yardstick of a replay. Does not wait for the card."""
    import torch

    with torch.inference_mode():
        return pred.serve_program(frames_dev, pred._dev_scalar(conf, pred.device), pred._dev_scalar(iou, pred.device),
                                  imgsz, **kw)


def eager_run(pred, frames, imgsz: int, conf: float = 0.25, iou: float = 0.45, **kw):
    """`eager_call` on numpy `frames` (an array, or a list that is
    host-letterboxed as `predict` does it), synchronised. The kernel
    wrappers count their launches and see their inputs here; a replay of a
    captured graph ticks no counter and calls no wrapper."""
    import torch

    if not isinstance(frames, np.ndarray):
        frames = np.stack(pred._batch(list(frames), imgsz)[0])
    out = eager_call(pred, torch.from_numpy(np.ascontiguousarray(frames)).to(pred.device), imgsz, conf, iou, **kw)
    torch.cuda.synchronize()
    return out


def kernel_profile(fn, calls: int = 3, named=()):
    """Device time by kernel and by copy over `calls` calls of `fn`
    (torch.profiler), and the kernels' busy share of the wall time; for each
    substring in `named`, the summed time and launches per call of the
    kernels whose names hold it."""
    rows, wall_ms = traced_rows(fn, calls, need=named)
    rows = [(k, ms / calls, n // calls) for k, ms, n in rows]
    rows.sort(key=lambda r: -r[1])
    copy_ms = sum(ms for k, ms, _ in rows if k.startswith(("Memcpy", "Memset")))
    kernel_ms = sum(ms for k, ms, _ in rows if not k.startswith(("Memcpy", "Memset")))
    out = {"wall_ms_per_predict": wall_ms, "kernel_ms_per_predict": kernel_ms,
           "copy_ms_per_predict": copy_ms, "kernel_busy_share": kernel_ms / wall_ms,
           "top": [{"name": k[:100], "ms": ms, "calls": n} for k, ms, n in rows[:15]]}
    if named:
        out["named"] = {sub: {"ms": sum(ms for k, ms, _ in rows if sub in k),
                              "calls": sum(n for k, _, n in rows if sub in k)} for sub in named}
    return out


def timed_serving(pred, frames, imgsz: int):
    """20 end-to-end `predict` calls (numpy frames in, Results out; host
    clock) and the device part alone (frames already on the card, dets left
    there; CUDA events)."""
    import torch

    times = []
    for _ in range(20):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pred.predict(frames, conf=0.25, imgsz=imgsz)
        times.append(time.perf_counter() - t0)
    times.sort()
    frames_dev = torch.from_numpy(frames).cuda()
    device = cuda_ms(lambda: pred.predict_raw(frames_dev, 0.25, 0.45, imgsz, 300), iters=20)
    median = times[len(times) // 2]
    b = frames.shape[0]
    return {"batch": int(b), "imgsz": imgsz, "calls": len(times), "img_per_s": b / median,
            "ms_per_batch_median": 1e3 * median, "ms_per_batch_min": 1e3 * times[0],
            "ms_per_batch_max": 1e3 * times[-1], "device_ms_per_batch": device,
            "device_img_per_s": 1e3 * b / device}


# the tensor-core instruction each redesigned library must hold in its SASS
TENSOR_CORE_SASS = {"attention_fused": "HMMA", "int8_conv": "IMMA"}


def sass_text(path: Path, cuobjdump: Path) -> str:
    return subprocess.run([str(cuobjdump), "-sass", str(path)], capture_output=True, text=True, timeout=120,
                          check=True).stdout


def sass_counts(sass: str):
    """Tensor-core instructions (HMMA, IMMA) in a built library's SASS."""
    return {op: len(re.findall(rf"\b{op}\b", sass)) for op in ("HMMA", "IMMA")}


SASS_INSTRUCTION = re.compile(r"^\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_.]*)")


def sass_instructions(sass: str, marker: str):
    """{function: instructions} of the functions in `cuobjdump -sass` output
    whose names hold `marker`: the static count (every path of the body,
    subroutines included), NOPs left out."""
    counts, name = {}, None
    for line in sass.splitlines():
        if "Function : " in line:
            name = line.split("Function : ")[1].strip()
            name = name if marker in name else None
            if name:
                counts[name] = 0
        elif name:
            op = SASS_INSTRUCTION.match(line)
            if op and op.group(1) != "NOP":
                counts[name] += 1
    return counts


# kernel F decodes one anchor row with 8 threads, so 8 logits a thread
DFL_LOGITS_PER_THREAD = 8


def dfl_sass(sass: str):
    """Kernel F's SASS instructions per logit: each function's static count
    over the logits one thread decodes (the body is straight-line code)."""
    return {"logits_per_thread": DFL_LOGITS_PER_THREAD,
            "kernels": {name: {"instructions": n, "per_logit": n / DFL_LOGITS_PER_THREAD}
                        for name, n in sass_instructions(sass, "dfl_decode_kernel").items()}}


def phase_card(report):
    from yolo_infer_tpu_torch.ops.kernels import _build

    line = card_line()
    t0 = time.perf_counter()
    built = _build.build(list(_build.KERNELS))
    report["card"] = line
    cuobjdump = Path(_build._nvcc()).parent / "cuobjdump"
    texts = {name: sass_text(_build.library_path(name), cuobjdump) for name in _build.KERNELS}
    sass = {name: sass_counts(text) for name, text in texts.items()}
    out = {"phase": "card", "card": line, "build_s": time.perf_counter() - t0, "kernels": built, "sass": sass,
           "dfl_sass": dfl_sass(texts["dfl_decode"])}
    if not out["dfl_sass"]["kernels"]:
        raise AssertionError("no dfl_decode_kernel function in kernel F's SASS")
    missing = {name: op for name, op in TENSOR_CORE_SASS.items() if sass[name][op] < 1}
    if missing:
        emit(out)
        raise AssertionError(f"no tensor-core instructions in {missing}")
    return out


def phase_nms(report):
    import torch

    from yolo_infer_tpu_torch.ops.kernels.nms_fused import nms_keep, nms_keep_reference

    rng = np.random.default_rng(SEED)
    out = {"phase": "nms", "cases": []}

    def check(case, bx, va, thr=0.45):
        got = nms_keep(bx, va, thr)
        # the plain version one image at a time: its (K, K) temporaries are 268 MB each at K = 8192
        want_dev = torch.cat([nms_keep_reference(bx[i:i + 1], va[i:i + 1], thr) for i in range(bx.shape[0])])
        want_cpu = nms_keep_reference(bx.cpu(), va.cpu(), thr) if bx.shape[1] <= 1024 else want_dev.cpu()
        torch.cuda.synchronize()
        ok = torch.equal(got, want_dev) and torch.equal(got.cpu(), want_cpu)
        out["cases"].append({"case": case, "B": bx.shape[0], "K": bx.shape[1], "valid": int(va.sum()),
                             "kept": int(got.sum()), "equal": ok, **a_time_split(bx, va, thr)})
        if not ok:
            raise AssertionError(f"keep mask differs ({case}, K={bx.shape[1]}): {int((got != want_dev).sum())} entries")
        return got

    for b, k in ((32, 384), (32, 512), (32, 1024), (32, 2048), (4, 4096), (2, 8192)):
        boxes, valid = random_candidates(rng, b, k)
        check("random", torch.from_numpy(boxes).cuda(), torch.from_numpy(valid).cuda())
    # the serving pool's shape: score-sorted, valid = score > 0, a prefix
    boxes, _ = random_candidates(rng, 32, 384)
    prefix = torch.arange(384)[None] < torch.tensor([[0], [1], [31], [32], [33], [200], [383], [384]]).repeat(4, 1)
    check("prefix", torch.from_numpy(boxes).cuda(), prefix.cuda())
    # NaN, +-inf and zero-area boxes among random ones, at K = 384 and 4096
    for b, k in ((32, 384), (4, 4096)):
        boxes, valid = random_candidates(rng, b, k)
        edge = np.array([np.nan, np.inf, -np.inf, 0.0, 640.0], np.float32)
        boxes = np.where(rng.uniform(0, 1, boxes.shape) < 0.1, edge[rng.integers(0, 5, boxes.shape)], boxes)
        boxes[:, ::9, 2:] = boxes[:, ::9, :2]  # zero area
        check("nan, inf, zero area", torch.from_numpy(boxes).cuda(), torch.from_numpy(valid).cuda())
    chain = torch.tensor([[[0, 0, 100, 100], [40, 0, 140, 100], [80, 0, 180, 100], [500, 500, 510, 510]]],
                         dtype=torch.float32, device="cuda")
    kept = nms_keep(chain, torch.tensor([[True, True, True, False]], device="cuda"), 0.3)
    if kept.cpu().tolist() != [[True, False, True, False]]:
        raise AssertionError(f"suppression chain: {kept.cpu().tolist()}")
    out["cases"].append({"chain": True, "equal": True})
    try:
        nms_keep(torch.zeros((1, 8193, 4), device="cuda"), torch.ones((1, 8193), dtype=torch.bool, device="cuda"), 0.45)
    except ValueError as exc:
        out["k_8193"] = str(exc)
    else:
        raise AssertionError("nms_keep took K = 8193")
    return out


def phase_attn(report):
    import torch

    from yolo_infer_tpu_torch.ops.kernels.attention_fused import attention_qkv, attention_qkv_reference

    rng = np.random.default_rng(SEED + 1)
    out = {"phase": "attn", "cases": []}
    cases = [(32, 400, 2, torch.bfloat16, 2e-2, 2e-2), (32, 400, 4, torch.bfloat16, 2e-2, 2e-2),
             (16, 1024, 2, torch.bfloat16, 2e-2, 2e-2), (2, 37, 2, torch.bfloat16, 2e-2, 2e-2),
             (32, 400, 2, torch.float32, 1e-5, 0.0), (2, 37, 2, torch.float32, 1e-5, 0.0),
             (4, 1600, 2, torch.bfloat16, 2e-2, 2e-2)]
    for b, n, heads, dtype, atol, rtol in cases:
        qkv = torch.from_numpy(rng.standard_normal((b, n, heads * 128)).astype(np.float32)).to("cuda", dtype)
        got = attention_qkv(qkv, heads, 32, 64)
        want = attention_qkv_reference(qkv, heads, 32, 64)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        out["cases"].append({"B": b, "N": n, "heads": heads, "dtype": str(dtype), "max_abs_err": err})
        torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)
    return out


def phase_fp32(report):
    import torch

    import yolo_infer_tpu_torch.ops.kernels.attention_fused as attn_mod
    import yolo_infer_tpu_torch.ops.kernels.nms_fused as nms_mod
    from yolo_infer_tpu_torch.core.predictor import Predictor

    rng = np.random.default_rng(SEED + 2)
    frames = rng.integers(0, 256, (2, 480, 640, 3), dtype=np.uint8)
    model, spec = smoke_weights(frames)
    report["weights"] = (model, spec)
    on_cpu = Predictor(model, spec, device="cpu", compute_dtype=torch.float32)
    on_gpu = Predictor(model, spec, device="cuda", compute_dtype=torch.float32)
    nms_mod.nms_keep.launches = attn_mod.attention_qkv.launches = 0
    torch.backends.cudnn.deterministic = True
    try:
        got = on_gpu.predict(list(frames), conf=0.001, iou=0.45, imgsz=640)
    finally:
        torch.backends.cudnn.deterministic = False
    launches = {"nms_keep": nms_mod.nms_keep.launches, "attention_qkv": attn_mod.attention_qkv.launches}
    want = on_cpu.predict(list(frames), conf=0.001, iou=0.45, imgsz=640)
    out = {"phase": "fp32", "launches": launches, "images": []}
    for g, w in zip(got, want):
        img = {"num_cuda": len(g), "num_cpu": len(w)}
        if len(g) == len(w):
            img["unmatched"] = match_detections(g, w, 1e-2, 1e-5)[0]
            img["classes_equal"] = bool(np.array_equal(np.sort(g.classes), np.sort(w.classes)))
        out["images"].append(img)
    if min(launches.values()) < 1:
        raise AssertionError(f"a kernel did not run in the fp32 predict: {launches}")
    for img in out["images"]:
        if img["num_cuda"] != img["num_cpu"] or img["unmatched"] or not img["classes_equal"]:
            emit(out)
            raise AssertionError("fp32 predict on cuda differs from cpu")
    return out


def phase_bf16(report):
    import torch

    import yolo_infer_tpu_torch.models.blocks as blocks_mod
    import yolo_infer_tpu_torch.ops.nms as nms_ops
    from yolo_infer_tpu_torch.core.predictor import Predictor
    from yolo_infer_tpu_torch.ops.kernels import attention_fused as attn_mod
    from yolo_infer_tpu_torch.ops.kernels import nms_fused as nms_mod

    model, spec = report["weights"]
    pred = Predictor(model, spec, device="cuda", compute_dtype=torch.bfloat16)
    rng = np.random.default_rng(SEED + 3)
    frames = rng.integers(0, 256, (32, 640, 640, 3), dtype=np.uint8)
    # the main path: the signature's capture (warm-up, cuDNN plans, kernel
    # loads), then a replay, with every count at 0 just before
    path, results = path_counters(lambda: (pred.predict(frames, conf=0.25), pred.predict(frames, conf=0.25))[1])

    # the main path's body, once, uncaptured, with counters at 0 and the
    # kernels' inputs captured (a replay calls no wrapper)
    seen = {}

    def capture(name, fn):
        def wrapped(*args):
            seen.setdefault(name, tuple(a.clone() if torch.is_tensor(a) else a for a in args))
            return fn(*args)
        return wrapped

    blocks_mod.attention_qkv = capture("attention_qkv", attn_mod.attention_qkv)
    nms_ops.nms_keep = capture("nms_keep", nms_mod.nms_keep)
    reset_counters()
    try:
        eager_run(pred, frames, 640)
    finally:
        blocks_mod.attention_qkv = attn_mod.attention_qkv
        nms_ops.nms_keep = nms_mod.nms_keep
    body = read_counters()
    frames_dev = torch.from_numpy(frames).cuda()
    counts = path_launches("main path", ("nms_keep", "attention_qkv"), path, body)
    launches = {k: r["launches"] for k, r in counts.items()}
    nums = [len(r) for r in results]
    for r in results:
        if not (np.isfinite(r.boxes).all() and np.isfinite(r.scores).all() and len(r) <= 300):
            raise AssertionError("non-finite or oversized detections")
        if len(r) and ((r.boxes < 0).any() or (r.boxes[:, [0, 2]] > 640).any() or (r.boxes[:, [1, 3]] > 640).any()):
            raise AssertionError("boxes outside the frame")

    # end to end (numpy frames in, Results out) per call, and the device part
    # alone (frames already on the card, dets left there) by CUDA events
    times = []
    for _ in range(20):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pred.predict(frames, conf=0.25)
        times.append(time.perf_counter() - t0)
    times.sort()
    batch_device_ms = cuda_ms(lambda: pred.predict_raw(frames_dev, 0.25, 0.45, 640, 300), iters=20)

    kernels = []
    # kernel B at the main path's input
    row_b = attention_b_row(*seen["attention_qkv"])
    kernels.append({
        "name": "attention_qkv", "route": "cuda", "source": "yolo_infer_tpu_torch/csrc/attention_fused.cu",
        "replaces": "yolo_infer_tpu/ops/pallas/attention_fused.py:114", "path": "detect b32 640 bf16",
        **counts["attention_qkv"], **row_b,
    })
    # kernel A at the main path's input
    cboxes, valid, thr = seen["nms_keep"]
    err_a = float((nms_mod.nms_keep(cboxes, valid, thr) != nms_mod.nms_keep_reference(cboxes, valid, thr)).sum())
    bk, kk, _ = cboxes.shape
    bytes_a, ops_a = a_work(cboxes, valid)
    kernel_a = lambda: nms_mod.nms_keep(cboxes, valid, thr)  # noqa: E731
    plain_a = lambda: nms_mod.nms_keep_reference(cboxes, valid, thr)  # noqa: E731
    kernels.append({
        "name": "nms_keep", "route": "cuda", "source": "yolo_infer_tpu_torch/csrc/nms_fused.cu",
        "replaces": "yolo_infer_tpu/ops/pallas/nms_fused.py:86", "path": "detect b32 640 bf16",
        **counts["nms_keep"],
        "max_abs_err": err_a,
        **a_time_split(cboxes, valid, thr), "plain_ms": device_ms(plain_a, iters=10),
        "call_ms": cuda_ms(kernel_a), "plain_call_ms": cuda_ms(plain_a, iters=10),
        **bound(bytes_a, ops_a, H100_F32_OPS_UNFUSED),
        "library_ms": None,
        "shape": [bk, kk, 4], "valid": int(valid.sum()),
    })
    if err_a != 0 or row_b["tol_excess"] > 0:
        raise AssertionError(f"main-path kernel outputs differ from the plain versions: A {err_a}, "
                             f"B {row_b['max_abs_err']} (beyond atol = rtol = {ATTN_BF16_TOL} by {row_b['tol_excess']})")
    report["kernels"] = kernels
    report["serving"] = (pred, frames)
    median = times[len(times) // 2]
    report["predict_img_per_s"] = frames.shape[0] / median
    return {"phase": "bf16", "batch": int(frames.shape[0]), "imgsz": 640, "calls": len(times),
            "img_per_s": frames.shape[0] / median, "ms_per_batch_median": 1e3 * median,
            "ms_per_batch_min": 1e3 * times[0], "ms_per_batch_max": 1e3 * times[-1],
            "device_ms_per_batch": batch_device_ms, "device_img_per_s": 1e3 * frames.shape[0] / batch_device_ms,
            "launches": launches, "launches_per_call": body, "detections_per_image": [min(nums), max(nums)]}


def attention_b_row(slab, heads: int, kd: int, hd: int):
    """Kernel B at one captured slab: its error against the plain version,
    device times (torch.profiler) beside its bound, the plain version and one
    `F.scaled_dot_product_attention` call on the same q, k, v (a yardstick
    only); `*call_ms` time the calls back to back with CUDA events."""
    import torch.nn.functional as F

    from yolo_infer_tpu_torch.ops.kernels import attention_fused as attn_mod

    ref = attn_mod.attention_qkv_reference(slab, heads, kd, hd)
    got = attn_mod.attention_qkv(slab, heads, kd, hd)
    err_b = float((got.float() - ref.float()).abs().max())
    b, n, d = slab.shape
    q, k, v = (slab.view(b, n, heads, 2 * kd + hd)[..., s].transpose(1, 2)
               for s in (slice(0, kd), slice(kd, 2 * kd), slice(2 * kd, None)))
    bytes_b = slab.numel() * slab.element_size() + b * n * heads * hd * slab.element_size()
    flops_b = 2 * b * heads * n * n * (kd + hd)
    kernel_b = lambda: attn_mod.attention_qkv(slab, heads, kd, hd)  # noqa: E731
    plain_b = lambda: attn_mod.attention_qkv_reference(slab, heads, kd, hd)  # noqa: E731
    library_b = lambda: F.scaled_dot_product_attention(q, k, v, scale=kd ** -0.5)  # noqa: E731
    return {"max_abs_err": err_b, "tol_excess": attn_tol_excess(got, ref), "max_abs_out": float(ref.float().abs().max()),
            "ms": device_ms(kernel_b), "plain_ms": device_ms(plain_b),
            **bound(bytes_b, flops_b, H100_BF16_FLOPS),
            "library_ms": device_ms(library_b),
            "call_ms": cuda_ms(kernel_b), "plain_call_ms": cuda_ms(plain_b), "library_call_ms": cuda_ms(library_b),
            "shape": [b, n, d], "dtype": str(slab.dtype)}


def phase_profile(report):
    """Device time by kernel over three main-path predicts (torch.profiler)."""
    pred, frames = report["serving"]
    return {"phase": "profile", **kernel_profile(lambda: pred.predict(frames, conf=0.25))}


def random_rotated(rng, b: int, k: int):
    """Random oriented candidates in a 640 px frame, as Gaussian terms, and a validity mask."""
    import torch

    from yolo_infer_tpu_torch.ops.rotated import gauss_terms

    rb = np.concatenate([rng.uniform(50, 590, (b, k, 2)), rng.uniform(10, 120, (b, k, 2)),
                         rng.uniform(-np.pi / 2, np.pi / 2, (b, k, 1))], -1).astype(np.float32)
    return gauss_terms(torch.from_numpy(rb).cuda()).contiguous(), torch.from_numpy(rng.uniform(0, 1, (b, k)) > 0.15).cuda()


def phase_rnms(report):
    import torch

    from yolo_infer_tpu_torch.ops.kernels.rotated_nms_fused import rotated_nms_keep, rotated_nms_keep_reference
    from yolo_infer_tpu_torch.ops.rotated import gauss_terms

    rng = np.random.default_rng(SEED + 4)
    out = {"phase": "rnms", "cases": []}
    # (K, valid): random flags, or a prefix of 300..1500 (the serving pool's shape)
    for k, kind in ((1024, "random"), (37, "random"), (160, "random"), (2048, "random"), (4096, "random"),
                    (8192, "random"), (4096, "prefix")):
        gauss, valid = random_rotated(rng, 16, k)
        if kind == "prefix":
            valid = torch.arange(k, device="cuda")[None] < torch.from_numpy(rng.integers(300, 1500, (16, 1))).cuda()
        got = rotated_nms_keep(gauss, valid, 0.45)
        # the plain version one image at a time: its (K, K) temporaries are 268 MB each at K = 8192
        want = torch.cat([rotated_nms_keep_reference(gauss[i:i + 1], valid[i:i + 1], 0.45) for i in range(16)])
        torch.cuda.synchronize()
        ok = torch.equal(got, want)
        out["cases"].append({"K": k, "B": 16, "valid": kind, "valid_count": int(valid.sum()), "kept": int(got.sum()),
                             "equal": ok, **c_time_split(gauss, valid, 0.45)})
        if not ok:
            raise AssertionError(f"rotated keep mask differs at K={k} ({kind}): {int((got != want).sum())} entries")
        del want
    chain = torch.tensor([[[50, 50, 100, 40, 0.3], [90, 50, 100, 40, 0.3], [130, 50, 100, 40, 0.3],
                           [400, 400, 20, 20, 0.0]]], dtype=torch.float32, device="cuda")
    kept = rotated_nms_keep(gauss_terms(chain).contiguous(), torch.tensor([[True, True, True, False]], device="cuda"), 0.3)
    if kept.cpu().tolist() != [[True, False, True, False]]:
        raise AssertionError(f"rotated suppression chain: {kept.cpu().tolist()}")
    out["cases"].append({"chain": True, "equal": True})
    try:
        rotated_nms_keep(torch.zeros((1, 8193, 5), device="cuda"), torch.ones((1, 8193), dtype=torch.bool, device="cuda"), 0.45)
    except ValueError as exc:
        out["k_8193"] = str(exc)
    else:
        raise AssertionError("rotated_nms_keep took K = 8193")
    return out


L2_FLUSH_BYTES = 128 << 20  # written between timed calls: more than the H100's 50 MB L2


def l2_cold(call):
    """`call` preceded by a write of L2_FLUSH_BYTES, so each call finds its
    inputs in HBM, not in L2, as on the path (a profile that sums named
    kernels leaves the fill kernel out). The write leaves L2 full of dirty
    lines, which the call's reads must write back to HBM as they come in."""
    import torch

    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")

    def run():
        flush.zero_()
        return call()
    return run


def keep_time_split(call, bits_kernel: str):
    """A keep-mask kernel's device time per call (torch.profiler over 10
    calls of `call`, L2 flushed before each: `l2_cold`), split into its two
    launches: the bits pass (the kernel named `bits_kernel`) and the walk of
    nms_walk.cuh."""
    named = kernel_profile(l2_cold(call), calls=10, named=(bits_kernel, "_walk_kernel"))["named"]
    bits_ms, walk_ms = named[bits_kernel]["ms"], named["_walk_kernel"]["ms"]
    return {"ms": bits_ms + walk_ms, "bits_ms": bits_ms, "walk_ms": walk_ms, "walk_share": walk_ms / (bits_ms + walk_ms)}


def valid_pairs(valid) -> int:
    """Pairs i < j of one image's candidates that are both valid, summed over
    the batch: the pairs any keep-mask implementation must compare."""
    nv = valid.sum(1).double()
    return int((nv * (nv - 1) / 2).sum())


def a_work(cboxes, valid):
    """Kernel A's bytes (boxes and valid flags read, keep flags written) and
    operations (an IoU and its compare for each pair of valid candidates)."""
    bk, kk, _ = cboxes.shape
    return cboxes.numel() * 4 + 2 * bk * kk, valid_pairs(valid) * IOU_OPS


def c_time_split(gauss, valid, thr):
    """Kernel C's split (`keep_time_split`): the probIoU bits pass and the walk."""
    from yolo_infer_tpu_torch.ops.kernels.rotated_nms_fused import rotated_nms_keep

    return keep_time_split(lambda: rotated_nms_keep(gauss, valid, thr), "probiou_bits_kernel")


def a_time_split(cboxes, valid, thr):
    """Kernel A's split (`keep_time_split`): the IoU bits pass and the walk."""
    from yolo_infer_tpu_torch.ops.kernels.nms_fused import nms_keep

    return keep_time_split(lambda: nms_keep(cboxes, valid, thr), "iou_bits_kernel")


def g_time_split(iou, valid, thr):
    """Kernel G's split (`keep_time_split`): the bits pass over the IoU and the walk."""
    from yolo_infer_tpu_torch.ops.kernels.greedy_nms import greedy_nms_keep

    return keep_time_split(lambda: greedy_nms_keep(iou, valid, thr), "suppression_bits_kernel")


def dfl_row(x, reg_max: int, launches: int, path: str):
    """Kernel F at a path's captured input (the strided slice of the decode's
    head slab): its error against the plain version (at most DFL_TOL), its
    device time with L2 flushed before each call (`l2_cold`: the val input,
    17 MB, fits in the 50 MB L2, and a warm reading could pass the HBM bound),
    the warm time beside it, and its bound."""
    from yolo_infer_tpu_torch.ops.kernels import dfl_decode as f_mod

    kernel_f = lambda: f_mod.dfl_decode(x, reg_max)  # noqa: E731
    plain_f = lambda: f_mod.dfl_decode_reference(x, reg_max)  # noqa: E731
    err = float((kernel_f() - plain_f()).abs().max())
    if not err <= DFL_TOL:
        raise AssertionError(f"kernel F differs from its plain version by {err} on the {path} path")
    b, a, c = x.shape
    bytes_f = b * a * c * x.element_size() + b * a * 4 * 4
    ops_f = b * a * c * DFL_OPS_PER_LOGIT + b * a * 4
    cold = kernel_profile(l2_cold(kernel_f), calls=20, named=("dfl_decode_kernel",))["named"]["dfl_decode_kernel"]
    if cold["calls"] != 1:
        raise AssertionError(f"kernel F launched {cold['calls']} kernels per call")
    return {"name": "dfl_decode", "route": "cuda", "source": "yolo_infer_tpu_torch/csrc/dfl_decode.cu",
            "replaces": "yolo_infer_tpu/ops/pallas/dfl_kernel.py:49", "path": path,
            "launches": launches, "max_abs_err": err, "ms": cold["ms"], "warm_ms": device_ms(kernel_f),
            "plain_ms": device_ms(plain_f), "call_ms": cuda_ms(kernel_f), "plain_call_ms": cuda_ms(plain_f),
            **bound(bytes_f, ops_f, H100_F32_FLOPS), "library_ms": None, "shape": [b, a, c],
            "strides": list(x.stride()), "dtype": str(x.dtype), "vec_bytes": f_mod.vector_bytes(x)}


def card_memory_clock() -> dict:
    """The card's memory clocks (nvidia-smi, MHz) and the HBM rate the
    maximum gives over the H100's 5120-bit bus at two transfers a clock."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.memory,clocks.mem", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60, check=True)
    max_mhz, now_mhz = (float(v) for v in out.stdout.strip().splitlines()[0].split(","))
    return {"max_mhz": max_mhz, "now_mhz": now_mhz, "bus_tb_per_s": max_mhz * 1e6 * 2 * 5120 / 8 / 1e12}


def g_read_check(iou, valid, thr):
    """G's bits pass against what the card reads, all with L2 flushed before
    each call: its profiled time on `iou` and on a fresh random IoU of the same
    shape (a data-dependent rate would show as a gap), the whole call by CUDA
    events beside the profile (the two clocks), and torch's own read, a sum
    over as many contiguous bytes as the bits pass must read."""
    import torch

    from yolo_infer_tpu_torch.ops.kernels.greedy_nms import greedy_nms_keep

    need = 4 * valid_pairs(valid)  # the IoU bytes above the diagonal between valid candidates
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda").zero_
    fresh = torch.rand(iou.shape, device="cuda", generator=torch.Generator("cuda").manual_seed(SEED))
    out = {"read_gb": need / 1e9, "memory_clock": card_memory_clock()}
    for name, m in (("path_iou", iou), ("fresh_random_iou", fresh)):
        split = g_time_split(m, valid, thr)
        events_ms = device_ms_each([flush, lambda m=m: greedy_nms_keep(m, valid, thr)], iters=5)[1]
        out[name] = {**split, "events_ms": events_ms, "bits_read_tb_per_s": need / (split["bits_ms"] * 1e-3) / 1e12}
    flat = fresh.view(-1)[:need // 4]
    named = kernel_profile(l2_cold(flat.sum), calls=5, named=("reduce_kernel",))["named"]
    out["torch_sum"] = {"profile_ms": named["reduce_kernel"]["ms"],
                        "events_ms": device_ms_each([flush, flat.sum], iters=5)[1],
                        "read_tb_per_s": need / (named["reduce_kernel"]["ms"] * 1e-3) / 1e12}
    return out


def d_skip_share(soft) -> float:
    """Share of kernel D's (instance, source row, packed word) steps that take
    its zero skip: no value above 0.5 in source rows i-1..i+1 and columns
    8c-1..8c+8, clamped at the edges (a warp computes when any lane does)."""
    import torch.nn.functional as F

    above = F.pad((soft > 0.5).float()[:, None], (1, 1, 1, 1), mode="replicate")
    return float(1 - F.max_pool2d(above, (3, 10), stride=(1, 8)).mean())


def d_bound(soft, packed):
    """Kernel D's bound at this input: each soft mask byte read and packed
    byte written once, against the operations of the steps that do not take
    the zero skip (the taps of a skipped step are not needed)."""
    n, h, w = soft.shape
    dense_ops = n * 4 * h * 4 * w * PACK_OPS_PER_PIXEL + n * 4 * h * w * PACK_OPS_PER_HTAP
    return bound(soft.numel() * 4 + packed.numel(), dense_ops * (1 - d_skip_share(soft)), H100_F32_OPS_UNFUSED)


def phase_mpack(report):
    import torch

    from yolo_infer_tpu_torch.ops.kernels.mask_pack import (
        upsample4x_threshold_pack,
        upsample4x_threshold_pack_reference,
    )

    rng = np.random.default_rng(SEED + 5)
    out = {"phase": "mpack", "cases": []}

    def check(case, soft, timed=False):
        got = upsample4x_threshold_pack(soft)
        want = upsample4x_threshold_pack_reference(soft)
        torch.cuda.synchronize()
        ok = torch.equal(got, want)
        popcount = torch.tensor([bin(v).count("1") for v in range(256)], dtype=torch.uint8, device=got.device)
        row = {"case": case, "shape": list(soft.shape),
               "ones_share": float(popcount[got.int()].sum(dtype=torch.int64)) / (8 * got.numel()),
               "skip_share": d_skip_share(soft), "equal": ok}
        if timed:
            row.update(ms=device_ms(lambda: upsample4x_threshold_pack(soft), iters=10), **d_bound(soft, got))
        out["cases"].append(row)
        if not ok:
            raise AssertionError(f"packed masks differ ({case}, {tuple(soft.shape)}): {int((got != want).sum())} bytes")
        return got

    for shape in ((300, 160, 160), (37, 24, 40), (5, 17, 8), (2, 6, 4096)):
        check("random", torch.from_numpy(rng.random(shape).astype(np.float32)).cuda())
    # the segment path's shape, dense: no step skips
    check("dense", torch.rand((9600, 160, 160), generator=torch.Generator("cuda").manual_seed(SEED), device="cuda"),
          timed=True)
    # values at the threshold and beyond it scattered over zeros, all-zero
    # instances, and 2 x 2 blocks just above 0.5 (a single such value sets no bit)
    up = np.nextafter(np.float32(0.5), np.float32(1))
    vals = np.array([0.5, up, -np.inf, np.inf, np.nan, 0.49, 0.75, -3.0], np.float32)
    soft = np.where(rng.random((64, 24, 40)) < 0.1, vals[rng.integers(0, 8, (64, 24, 40))], 0).astype(np.float32)
    soft[::4] = 0
    soft[1::4, 6:8, 8:10] = up
    got = check("edge values", torch.from_numpy(soft).cuda())
    if got[::4].any() or not got[1::4].any():
        raise AssertionError("edge values: an all-zero instance set a bit, or a block above 0.5 set none")
    return out


# the kernels each task's predict must launch
TASK_KERNELS = {"segment": ("nms_keep", "attention_qkv", "upsample4x_threshold_pack"),
                "obb": ("attention_qkv", "rotated_nms_keep", "dfl_decode"),
                "pose": ("nms_keep", "attention_qkv"),
                "classify": ("attention_qkv",)}
TASK_NC = {"segment": 80, "obb": 15, "pose": 1, "classify": 1000}


def phase_tasks_fp32(report):
    import torch

    import yolo_infer_tpu_torch.ops.rotated as rot_mod
    from yolo_infer_tpu_torch.core.predictor import Predictor

    rng = np.random.default_rng(SEED + 6)
    calib = rng.integers(0, 256, (2, 480, 640, 3), dtype=np.uint8)
    frames = [rng.integers(0, 256, (480, 640, 3), dtype=np.uint8), rng.integers(0, 256, (360, 500, 3), dtype=np.uint8)]
    out = {"phase": "tasks_fp32", "tasks": {}}
    failures = []
    report["task_weights"] = {}
    # OBB also at pre_topk 2048: kernel C past the 1024 of its one-block form
    for task, pre_topk in (("segment", 1024), ("obb", 1024), ("obb", 2048), ("pose", 1024), ("classify", 1024)):
        name = task if pre_topk == 1024 else f"{task} pre_topk {pre_topk}"
        if task not in report["task_weights"]:
            report["task_weights"][task] = smoke_weights(calib, task, TASK_NC[task])
        model, spec = report["task_weights"][task]
        on_cpu = Predictor(model, spec, device="cpu", compute_dtype=torch.float32, pre_topk=pre_topk)
        on_gpu = Predictor(model, spec, device="cuda", compute_dtype=torch.float32, pre_topk=pre_topk)
        seen = {}
        torch.backends.cudnn.deterministic = True
        try:
            got = on_gpu.predict(frames, conf=0.25, iou=0.45, imgsz=640)  # captured, then replayed
            # the launches and C's input from the body the graph replays
            restore = capture_inputs(rot_mod, "rotated_nms_keep", seen, clone=False)
            try:
                reset_counters()
                eager_run(on_gpu, frames, 640, conf=0.25, iou=0.45)
                launches = read_counters()
            finally:
                restore()
        finally:
            torch.backends.cudnn.deterministic = False
        want = on_cpu.predict(frames, conf=0.25, iou=0.45, imgsz=640)
        res = {"launches": launches, "images": []}
        if "rotated_nms_keep" in seen:
            res["rotated_nms_keep_shape"] = list(seen["rotated_nms_keep"][0].shape)
            if seen["rotated_nms_keep"][0].shape[1] != pre_topk:
                failures.append(f"{name}: kernel C ran at {res['rotated_nms_keep_shape']}")
        if min(launches[k] for k in TASK_KERNELS[task]) < 1:
            failures.append(f"{name}: a kernel did not run: {launches}")
        for g, w in zip(got, want):
            img = {"num_cuda": len(g), "num_cpu": len(w)}
            if task == "classify":
                img["probs_max_abs_err"] = float(np.abs(g.probs - w.probs).max())
                img["top5_equal"] = bool(np.array_equal(np.argsort(-g.probs)[:5], np.argsort(-w.probs)[:5]))
                if img["probs_max_abs_err"] > 1e-5:
                    failures.append(f"classify probs differ by {img['probs_max_abs_err']}")
            else:
                # pair detections loosely (same class, box within 1 px, score
                # within 1e-3), then hold the pairs to the tolerances
                missing, pairs = match_detections(g, w, 1.0, 1e-3)
                img["unmatched"] = missing + len(w) - len(pairs)
                errs = {}
                if pairs:
                    i, j = map(list, zip(*pairs))
                    errs["box_max_abs_err"] = float(np.abs(g.boxes[i] - w.boxes[j]).max())
                    errs["score_max_abs_err"] = float(np.abs(g.scores[i] - w.scores[j]).max())
                    if task == "obb":
                        errs["obb_max_abs_err"] = float(np.abs(g.obb[i] - w.obb[j]).max())
                    if task == "pose":
                        errs["kpts_max_abs_err"] = float(np.abs(g.keypoints[i] - w.keypoints[j]).max())
                    if task == "segment":
                        gm, wm = g.masks.numpy()[i], w.masks.numpy()[j]
                        img["mask_pixels"] = int(gm.size)
                        img["mask_ones_share"] = float(gm.mean())
                        img["mask_pixels_differing"] = int((gm != wm).sum())
                        if img["mask_pixels_differing"] > 1e-4 * gm.size:
                            failures.append(f"masks differ in {img['mask_pixels_differing']} of {gm.size} pixels")
                img.update(errs)
                for key, err in errs.items():
                    if err > (SCORE_TOL if key.startswith("score") else PX_TOL):
                        failures.append(f"{name}: {key} {err}")
                if len(g) != len(w) or img["unmatched"] or len(g) == 0:
                    failures.append(f"{name}: detections differ ({img})")
            res["images"].append(img)
        out["tasks"][name] = res
    if failures:
        emit(out)
        raise AssertionError("; ".join(failures))
    return out


def capture_inputs(module, name: str, seen: dict, clone: bool = True):
    """Wrap `module.<name>` (a kernel wrapper as the calling module sees it)
    so its first call's arguments are cloned into `seen[name]` (or kept as
    they are, strided views included, with `clone=False`: for arguments the
    path never writes to again); returns the function that restores it."""
    import torch

    fn = getattr(module, name)

    def wrapped(*args):
        seen.setdefault(name, tuple(a.clone() if clone and torch.is_tensor(a) else a for a in args))
        return fn(*args)

    setattr(module, name, wrapped)
    return lambda: setattr(module, name, fn)


def phase_seg_bf16(report):
    import torch

    import yolo_infer_tpu_torch.ops.masks as masks_mod
    from yolo_infer_tpu_torch.core.predictor import LazyMasks, Predictor
    from yolo_infer_tpu_torch.ops.kernels import mask_pack as mp_mod

    model, spec = report["task_weights"]["segment"]
    pred = Predictor(model, spec, device="cuda", compute_dtype=torch.bfloat16, mask_mode="device")
    batch, imgsz = SEG_SERVE
    frames = np.random.default_rng(SEED + 7).integers(0, 256, (batch, imgsz, imgsz, 3), dtype=np.uint8)
    # the path's run: the signature's capture, then a replay
    path, results = path_counters(lambda: (pred.predict(frames, conf=0.25, imgsz=imgsz),
                                           pred.predict(frames, conf=0.25, imgsz=imgsz))[1])

    # the launches per call and D's input from the body the graph replays
    seen = {}
    restore = capture_inputs(masks_mod, "upsample4x_threshold_pack", seen)
    reset_counters()
    try:
        eager_run(pred, frames, imgsz)
    finally:
        restore()
    body = read_counters()
    counts = path_launches("segment path", TASK_KERNELS["segment"], path, body)
    launches = {k: r["launches"] for k, r in counts.items()}
    nums = [len(r) for r in results]
    if min(nums) < 1 or max(nums) > 300:
        raise AssertionError(f"segment detections per image out of range: {min(nums)}..{max(nums)}")
    LazyMasks.prefetch(results[:2], np.uint8)  # one device-to-host copy for both
    for r in results[:2]:
        m = r.masks.numpy()
        if m.shape != (len(r), imgsz, imgsz) or not (np.isfinite(r.boxes).all() and np.isfinite(r.scores).all()):
            raise AssertionError(f"bad segment output: masks {m.shape}, {len(r)} detections")
    mask_ones = float(np.mean([r.masks.numpy().mean() for r in results[:2]]))
    timing = timed_serving(pred, frames, imgsz)

    (soft,) = seen["upsample4x_threshold_pack"]
    kernel_d = lambda: mp_mod.upsample4x_threshold_pack(soft)  # noqa: E731
    plain_d = lambda: mp_mod.upsample4x_threshold_pack_reference(soft)  # noqa: E731
    got, want = kernel_d(), plain_d()
    err_d = float((got != want).sum())
    if err_d:
        raise AssertionError(f"kernel D differs from its plain version on the segment path: {err_d} bytes")
    n, h, w = soft.shape
    report["kernels"].append({
        "name": "upsample4x_threshold_pack", "route": "cuda", "source": "yolo_infer_tpu_torch/csrc/mask_pack.cu",
        "replaces": "yolo_infer_tpu/ops/pallas/mask_pack.py:92", "path": f"segment b{batch} {imgsz} bf16",
        **counts["upsample4x_threshold_pack"], "max_abs_err": err_d,
        "ms": device_ms(kernel_d), "plain_ms": device_ms(plain_d, iters=5),
        "call_ms": cuda_ms(kernel_d, iters=20), "plain_call_ms": cuda_ms(plain_d, iters=5, warmup=1),
        **d_bound(soft, got),
        "library_ms": None, "shape": [n, h, w], "skip_share": d_skip_share(soft),
    })
    del soft, got, want, seen
    profile = kernel_profile(lambda: pred.predict(frames, conf=0.25, imgsz=imgsz))
    return {"phase": "seg_bf16", **timing, "launches": launches, "launches_per_call": body,
            "detections_per_image": [min(nums), max(nums)], "mask_ones_share": mask_ones, "profile": profile}


def phase_obb_bf16(report):
    import torch

    import yolo_infer_tpu_torch.models.blocks as blocks_mod
    import yolo_infer_tpu_torch.ops.decode as decode_mod
    import yolo_infer_tpu_torch.ops.rotated as rot_mod
    from yolo_infer_tpu_torch.core.predictor import Predictor
    from yolo_infer_tpu_torch.ops.kernels import rotated_nms_fused as rn_mod

    model, spec = report["task_weights"]["obb"]
    pred = Predictor(model, spec, device="cuda", compute_dtype=torch.bfloat16)
    batch, imgsz = OBB_SERVE
    frames = np.random.default_rng(SEED + 8).integers(0, 256, (batch, imgsz, imgsz, 3), dtype=np.uint8)
    # the path's run: the signature's capture, then a replay
    path, results = path_counters(lambda: (pred.predict(frames, conf=0.25, imgsz=imgsz),
                                           pred.predict(frames, conf=0.25, imgsz=imgsz))[1])

    # the launches per call and the kernels' inputs from the body the graph replays
    seen = {}
    restores = [capture_inputs(rot_mod, "rotated_nms_keep", seen), capture_inputs(blocks_mod, "attention_qkv", seen),
                capture_inputs(decode_mod, "dfl_decode", seen, clone=False)]
    reset_counters()
    try:
        eager_run(pred, frames, imgsz)
    finally:
        for restore in restores:
            restore()
    body = read_counters()
    counts = path_launches("OBB path", TASK_KERNELS["obb"], path, body)
    launches = {k: r["launches"] for k, r in counts.items()}
    nums = [len(r) for r in results]
    if min(nums) < 1:
        raise AssertionError("an image without oriented detections")
    for r in results:
        if not (np.isfinite(r.obb).all() and np.isfinite(r.scores).all() and len(r) <= 300):
            raise AssertionError("non-finite or oversized oriented detections")
    timing = timed_serving(pred, frames, imgsz)

    gauss, valid, thr = seen["rotated_nms_keep"]
    kernel_c = lambda: rn_mod.rotated_nms_keep(gauss, valid, thr)  # noqa: E731
    plain_c = lambda: rn_mod.rotated_nms_keep_reference(gauss, valid, thr)  # noqa: E731
    err_c = float((kernel_c() != plain_c()).sum())
    if err_c:
        raise AssertionError(f"kernel C differs from its plain version on the OBB path: {err_c} entries")
    b, k, _ = gauss.shape
    bytes_c = gauss.numel() * 4 + 2 * b * k
    # the pairs of valid candidates (the kernel skips every other pair)
    nv = valid.sum(1).double()
    ops_c = float((nv * (nv - 1) / 2).sum()) * PROBIOU_OPS + b * k * 4
    report["kernels"].append({
        "name": "rotated_nms_keep", "route": "cuda", "source": "yolo_infer_tpu_torch/csrc/rotated_nms_fused.cu",
        "replaces": "yolo_infer_tpu/ops/pallas/nms_fused.py:149", "path": f"obb b{batch} {imgsz} bf16",
        **counts["rotated_nms_keep"], "max_abs_err": err_c,
        **c_time_split(gauss, valid, thr), "plain_ms": device_ms(plain_c, iters=5),
        "call_ms": cuda_ms(kernel_c, iters=20), "plain_call_ms": cuda_ms(plain_c, iters=5, warmup=1),
        **bound(bytes_c, ops_c, H100_F32_OPS_UNFUSED),
        "library_ms": None, "shape": [b, k, 5], "valid": int(valid.sum()),
    })
    # kernel B at the OBB path's N = 1024 slab
    row_b = attention_b_row(*seen["attention_qkv"])
    if row_b["tol_excess"] > 0:
        raise AssertionError(f"kernel B differs from its plain version on the OBB path by {row_b['max_abs_err']}")
    # kernel F at the OBB path's (16, 21504, 64) slice of the 79-channel head slab
    row_f = {**dfl_row(*seen["dfl_decode"], launches["dfl_decode"], f"obb b{batch} {imgsz} bf16"),
             **counts["dfl_decode"]}
    profile = kernel_profile(lambda: pred.predict(frames, conf=0.25, imgsz=imgsz))
    return {"phase": "obb_bf16", **timing, "launches": launches, "launches_per_call": body,
            "detections_per_image": [min(nums), max(nums)], "attention_qkv": row_b, "dfl_decode": row_f,
            "profile": profile}

def dfl_spread_logits(rng, shape):
    """Logits drawn from N(0, 8), and in one row in four each side's 16 bins a
    shuffled ramp from -40 to 40 (a span of 80: exp(x - max) down to ~2e-35)."""
    x = rng.normal(0, 8, shape).astype(np.float32)
    sides = x[..., :64].reshape(-1, 4, 16)
    rows = rng.choice(sides.shape[0], sides.shape[0] // 4, replace=False)
    ramp = np.linspace(-40, 40, 16, dtype=np.float32)
    sides[rows] = rng.permuted(np.broadcast_to(ramp, (len(rows), 4, 16)), axis=-1)
    x[..., :64] = sides.reshape(*shape[:-1], 64)
    return x


def phase_dfl(report):
    import torch

    from yolo_infer_tpu_torch.ops.kernels import dfl_decode as f_mod

    rng = np.random.default_rng(SEED + 9)
    slabs = {c: torch.from_numpy(rng.normal(0, 3, (16, a, c)).astype(np.float32)).cuda()
             for c, a in ((144, 8400), (79, 21504), (65, 8400))}
    spread = torch.from_numpy(dfl_spread_logits(rng, (16, 2100, 79))).cuda()
    many = torch.from_numpy(rng.normal(0, 3, (70000, 3, 64)).astype(np.float32)).cuda()
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        s144, s79, s65, wide, images = (t.to(dtype) for t in (slabs[144], slabs[79], slabs[65], spread, many))
        cases += [("144 contiguous", s144[..., :64].contiguous()), ("144 slab slice (detect nc 80)", s144[..., :64]),
                  ("144 slab from channel 1", s144[..., 1:65]), ("144 slab from channel 2", s144[..., 2:66]),
                  ("144 slab from channel 4", s144[..., 4:68]), ("79 slab slice (obb nc 15)", s79[..., :64]),
                  ("65 slab slice (pose nc 1)", s65[..., :64]), ("ragged A 8397", s144[:3, :8397, :64]),
                  ("ragged A 37", s65[:2, :37, :64].contiguous()), ("wide spread", wide[..., :64].contiguous()),
                  ("wide spread, 79 slab slice", wide[..., :64]),
                  ("B 70000, past the grid's y limit", images)]
    out = {"phase": "dfl", "cases": []}
    for name, x in cases:
        before = f_mod.dfl_decode.launches
        got = f_mod.dfl_decode(x)
        want = f_mod.dfl_decode_reference(x)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        out["cases"].append({"case": name, "shape": list(x.shape), "dtype": str(x.dtype), "strides": list(x.stride()),
                             "vec_bytes": f_mod.vector_bytes(x), "max_abs_err": err})
        if f_mod.dfl_decode.launches != before + 1:
            raise AssertionError(f"kernel F did not launch once for {name} ({x.dtype})")
        if not err <= DFL_TOL:
            raise AssertionError(f"kernel F differs from its plain version by {err} ({name}, {x.dtype})")
    out["vec_bytes_taken"] = sorted({c["vec_bytes"] for c in out["cases"]})
    if out["vec_bytes_taken"] != [2, 4, 8, 16]:
        raise AssertionError(f"kernel F's cases took load widths {out['vec_bytes_taken']}, not all of 16, 8, 4, 2")
    return out


def phase_gnms(report):
    import torch

    from yolo_infer_tpu_torch.ops.iou import box_iou_matrix
    from yolo_infer_tpu_torch.ops.kernels.greedy_nms import greedy_nms_keep, greedy_nms_keep_reference

    rng = np.random.default_rng(SEED + 10)
    out = {"phase": "gnms", "cases": []}

    def check(case, iou, valid, thr):
        got = greedy_nms_keep(iou, valid, thr)
        # the plain version one image at a time: its (K, K) temporaries are 268 MB each at K = 8192
        want = torch.cat([greedy_nms_keep_reference(iou[i:i + 1], valid[i:i + 1], thr) for i in range(iou.shape[0])])
        torch.cuda.synchronize()
        ok = torch.equal(got, want)
        out["cases"].append({"case": case, "B": iou.shape[0], "K": iou.shape[1], "valid": int(valid.sum()),
                             "kept": int(got.sum()), "equal": ok, **g_time_split(iou, valid, thr)})
        if not ok:
            raise AssertionError(f"kernel G differs from its plain version ({case}): {int((got != want).sum())} entries")
        return got

    for b, k, case in ((16, 4096, "random"), (4, 1000, "random"), (3, 37, "random, image 1 all invalid"),
                       (2, 8192, "random"), (16, 4096, "prefix")):
        boxes, valid = random_candidates(rng, b, k)
        bx, va = torch.from_numpy(boxes).cuda(), torch.from_numpy(valid).cuda()
        if k == 37:
            va[1] = False  # an image with no valid candidate
        if case == "prefix":  # the pool's shape: score-sorted, valid = score > conf, a prefix of 300..3000
            va = torch.arange(k, device="cuda")[None] < torch.from_numpy(rng.integers(300, 3000, (b, 1))).cuda()
        check(case, box_iou_matrix(bx, bx), va, 0.6)
    # box i overlaps box i+1 at IoU 0.5 and box i+2 at 0.2: greedy keeps every other box
    x = torch.arange(4096, dtype=torch.float32, device="cuda")[:, None] * 10
    chain = torch.cat([x, torch.zeros_like(x), x + 30, torch.full_like(x, 10)], 1)[None]
    kept = check("chain", box_iou_matrix(chain, chain), torch.ones((1, 4096), dtype=torch.bool, device="cuda"), 0.3)
    if not torch.equal(kept[0], torch.arange(4096, device="cuda") % 2 == 0):
        raise AssertionError("suppression chain: kernel G did not keep every other box")
    return out


class _Recorder:
    """A predictor that records every `predict_raw` result on the host."""

    def __init__(self, pred):
        self.pred, self.spec, self.device, self.dets = pred, pred.spec, pred.device, []

    def predict_raw(self, *args, **kw):
        out = self.pred.predict_raw(*args, **kw)
        self.dets.append({k: v.cpu().numpy() for k, v in out.items()})
        return out


def box_octagon(box):
    """The octagon inscribed in an xyxy box (each corner cut a quarter of the
    way along its sides): a segment label with the box's extent and slanted
    edges. (The hull of a predicted mask makes a poor label for seeded
    weights: their masks are speckled, so the hull's extent misses the box.)"""
    x1, y1, x2, y2 = box
    qx, qy = (x2 - x1) / 4, (y2 - y1) / 4
    return np.array([[x1 + qx, y1], [x2 - qx, y1], [x2, y1 + qy], [x2, y2 - qy],
                     [x2 - qx, y2], [x1 + qx, y2], [x1, y2 - qy], [x1, y1 + qy]])


def obb_corners(cx, cy, w, h, r):
    """The four corners of a rotated box: an OBB label from a predicted box."""
    c, s = np.cos(r), np.sin(r)
    return np.array([[cx + dx * c - dy * s, cy + dx * s + dy * c]
                     for dx, dy in ((-w / 2, -h / 2), (w / 2, -h / 2), (w / 2, h / 2), (-w / 2, h / 2))])


def write_val_dataset(root: Path, frames, results, task: str, nc: int):
    """YOLO-format dataset of `frames` (PNG, `save_image`) labelled with
    `results` (normalized xywh; pose keypoints with visibility 2 where the
    predicted keypoint confidence exceeds 0.5, else 1; segment each box's
    inscribed octagon as its polygon; OBB each rotated box's corners;
    coordinates clipped to the frame), as a dict config."""
    from yolo_infer_tpu_torch.data.loader import save_image

    (root / "labels" / "val").mkdir(parents=True, exist_ok=True)
    for i, (frame, r) in enumerate(zip(frames, results)):
        save_image(root / "images" / "val" / f"f{i:03d}.png", frame, compress_level=1)
        h, w = frame.shape[:2]
        lines = []
        for j in range(len(r)):
            if task in ("segment", "obb"):
                pts = box_octagon(r.boxes[j]) if task == "segment" else obb_corners(*r.obb[j])
                pts = (np.asarray(pts, np.float64) / [w, h]).clip(0, 1)
                lines.append(f"{r.classes[j]} " + " ".join(f"{v:.6f}" for v in pts.ravel()))
                continue
            x1, y1, x2, y2 = (r.boxes[j] / [w, h, w, h]).clip(0, 1)
            line = f"{r.classes[j]} {(x1 + x2) / 2:.6f} {(y1 + y2) / 2:.6f} {x2 - x1:.6f} {y2 - y1:.6f}"
            if task == "pose":
                line += "".join(f" {x / w:.6f} {y / h:.6f} {2 if v > 0.5 else 1}" for x, y, v in r.keypoints[j])
            lines.append(line)
        (root / "labels" / "val" / f"f{i:03d}.txt").write_text("\n".join(lines) + "\n")
    return {"path": str(root), "val": "images/val", "names": {c: str(c) for c in range(nc)}}


def write_classify_tree(root: Path, frames, labels, nc: int):
    """A class-per-directory tree (val/cNNNN/, one directory per class, most
    empty) of `frames` (PNG) under their `labels`."""
    from yolo_infer_tpu_torch.data.loader import save_image

    for c in range(nc):
        (root / "val" / f"c{c:04d}").mkdir(parents=True, exist_ok=True)
    for i, (frame, label) in enumerate(zip(frames, labels)):
        save_image(root / "val" / f"c{label:04d}" / f"f{i:03d}.png", frame, compress_level=1)
    return root


def rank_labels(pred, frames, imgsz: int):
    """Labels from `pred`'s own ranking of each centre-cropped frame: its
    first, third and seventh class in turn, so top-1 and top-5 both fall
    between 0 and 1."""
    import torch

    from yolo_infer_tpu_torch.data.classify import _resize_center_crop

    crops = np.stack([_resize_center_crop(f, imgsz) for f in frames])
    probs = pred.predict_raw(torch.from_numpy(crops).to(pred.device), 0.0, 0.0, imgsz)["probs"].float().cpu().numpy()
    ranks = np.argsort(-probs, axis=-1)
    return [int(ranks[i, (0, 2, 6)[i % 3]]) for i in range(len(frames))]


class _Dets(SimpleNamespace):
    """One image's detections (boxes, scores, classes, kpts) for `match_detections`."""

    def __len__(self):
        return len(self.scores)


def pair_val_detections(got, want):
    """Pair each recorded batch's detections with score >= 0.25 as sets, in
    both directions (a partner may sit just below the cut). Returns
    (unpaired count, largest keypoint error of the pairs, detections seen,
    up to 4 unpaired as (score, rank among those >= 0.25, class, box))."""
    unpaired, kpt_err, seen, examples = 0, 0.0, 0, []
    for g, w in zip(got, want):
        for i in range(len(g["num"])):
            def dets(d, lo):
                k = int(d["num"][i])
                keep = d["scores"][i, :k] >= lo
                return _Dets(boxes=d["boxes"][i, :k][keep], scores=d["scores"][i, :k][keep],
                             classes=d["classes"][i, :k][keep], kpts=d["kpts"][i, :k][keep] if "kpts" in d else None)

            for a, b in ((dets(g, 0.25 + SCORE_TOL), dets(w, 0.25 - SCORE_TOL)),
                         (dets(w, 0.25 + SCORE_TOL), dets(g, 0.25 - SCORE_TOL))):
                missing, pairs = match_detections(a, b, PX_TOL, SCORE_TOL)
                unpaired += missing
                seen += len(a)
                if missing and len(examples) < 4:
                    paired = {p[0] for p in pairs}
                    examples += [(float(a.scores[j]), j, int(a.classes[j]), a.boxes[j].tolist())
                                 for j in range(len(a)) if j not in paired][:2]
                if pairs and a.kpts is not None:
                    ia, ib = map(list, zip(*pairs))
                    kpt_err = max(kpt_err, float(np.abs(a.kpts[ia] - b.kpts[ib]).max()))
    return unpaired, kpt_err, seen, examples


def phase_val_fp32(report):
    rng = np.random.default_rng(SEED + 11)
    half = VAL_FP32_FRAMES // 2
    frames = ([rng.integers(0, 256, (480, 640, 3), dtype=np.uint8) for _ in range(half)]
              + [rng.integers(0, 256, (360, 500, 3), dtype=np.uint8) for _ in range(half)])
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_val_"))
    try:
        return _val_fp32(report, frames, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)


VAL_TASK_KERNELS = {"detect": ("attention_qkv", "dfl_decode", "greedy_nms_keep"),
                    "segment": ("attention_qkv", "dfl_decode", "greedy_nms_keep"),
                    "pose": ("attention_qkv", "dfl_decode", "greedy_nms_keep"),
                    "obb": ("attention_qkv", "dfl_decode", "rotated_nms_keep"),
                    "classify": ("attention_qkv",)}
CLS_VAL = dict(imgsz=224, batch=64)  # evaluate_classifier's defaults


def _val_fp32(report, all_frames, root: Path):
    import torch

    from yolo_infer_tpu_torch.core.predictor import Predictor
    from yolo_infer_tpu_torch.core.validator import YOLO11Validator
    from yolo_infer_tpu_torch.data.classify import ClassifyDataset, _resize_center_crop, evaluate_classifier

    out = {"phase": "val_fp32", "frames": len(all_frames), "tasks": {}}
    failures = []
    for task in ("detect", "segment", "pose", "obb", "classify"):
        half, n = len(all_frames) // 2, VAL_FP32_TASK_FRAMES.get(task, len(all_frames)) // 2
        frames = all_frames[:n] + all_frames[half:half + n]
        model, spec = report["weights"] if task == "detect" else report["task_weights"][task]
        on_cpu = Predictor(model, spec, device="cpu", compute_dtype=torch.float32)
        on_gpu = Predictor(model, spec, device="cuda", compute_dtype=torch.float32)
        torch.backends.cudnn.deterministic = True
        try:
            if task == "classify":
                data = write_classify_tree(root / task, frames, rank_labels(on_cpu, frames, CLS_VAL["imgsz"]),
                                           spec.nc)
                got = evaluate_classifier(None, ClassifyDataset(data, "val"), predictor=on_gpu, **CLS_VAL)
                batch = np.stack([_resize_center_crop(f, CLS_VAL["imgsz"]) for f in frames[:CLS_VAL["batch"]]])
                reset_counters()
                eager_run(on_gpu, batch, CLS_VAL["imgsz"], 0.0, 0.0)
            else:
                labels = on_cpu.predict(frames, conf=0.25, iou=VAL["iou"], imgsz=VAL["imgsz"])
                data = write_val_dataset(root / task, frames, labels, task, spec.nc)
                gpu_rec, cpu_rec = _Recorder(on_gpu), _Recorder(on_cpu)
                got = YOLO11Validator(model=SimpleNamespace(predictor=gpu_rec), output_dir=root / f"{task}_cuda"
                                      ).validate(data, verbose=False, **VAL)
                # the launches of one validation batch, from the body the graph replays
                reset_counters()
                eager_run(on_gpu, frames[:VAL["batch"]], VAL["imgsz"], VAL["conf"], VAL["iou"], multi_label=True,
                          pre_topk=VAL["pre_topk"], mask_out="bits" if task == "segment" else None)
            launches = read_counters()
        finally:
            torch.backends.cudnn.deterministic = False
        if min(launches[k] for k in VAL_TASK_KERNELS[task]) < 1:
            failures.append(f"{task}: a kernel did not run in the cuda validation: {launches}")
        if task == "classify":
            want = evaluate_classifier(None, ClassifyDataset(data, "val"), predictor=on_cpu, **CLS_VAL)
            out["tasks"][task] = {"launches": launches, "cuda": got, "cpu": want}
            if got != want or not 0 < got["top1"] < got["top5"] < 1:
                failures.append(f"classify: top-1/top-5 differ between cuda and cpu or are degenerate: {got} {want}")
            continue
        want = YOLO11Validator(model=SimpleNamespace(predictor=cpu_rec), output_dir=root / f"{task}_cpu").validate(
            data, verbose=False, **VAL)
        unpaired, kpt_err, seen, examples = pair_val_detections(gpu_rec.dets, cpu_rec.dets)
        metrics = {"cuda": got["metrics"], "cpu": want["metrics"]}
        diffs = {k: abs(got["metrics"][k] - want["metrics"][k]) for k in ("mAP50-95", "mAP50")}
        task_key = {"segment": "mask_metrics", "pose": "pose_metrics"}.get(task)
        if task_key:
            metrics.update({f"{task_key}_cuda": got[task_key], f"{task_key}_cpu": want[task_key]})
            diffs.update({f"{task_key} {k}": abs(got[task_key][k] - want[task_key][k]) for k in ("mAP50-95", "mAP50")})
        out["tasks"][task] = {"launches": launches, "metrics": metrics, "max_metric_diff": max(diffs.values()),
                              "dets_score_ge_0.25": seen, "unpaired": unpaired, "unpaired_examples": examples,
                              "kpts_max_abs_err": kpt_err, "num_images": got["num_images"], "frames": len(frames)}
        if max(diffs.values()) > 1e-3:
            failures.append(f"{task}: metrics differ between cuda and cpu: {diffs}")
        # detect and pose are held to their detections as well (segment and
        # OBB to their metrics only: their unpaired detections are reported)
        if seen == 0 or kpt_err > KPT_TOL or (unpaired and task in ("detect", "pose")):
            failures.append(f"{task}: {unpaired} of {seen} detections unpaired, keypoints off by {kpt_err}")
        if not 0 < got["metrics"]["mAP50"] <= 1 or (task_key and not 0 < got[task_key]["mAP50"] <= 1):
            failures.append(f"{task}: mAP50 {got['metrics']['mAP50']}, {got.get(task_key)}")
    if failures:
        emit(out)
        raise AssertionError("; ".join(failures))
    return out


def phase_val_bf16(report):
    import torch

    from yolo_infer_tpu_torch.core.predictor import Predictor

    model, spec = report["weights"]
    pred = Predictor(model, spec, device="cuda", compute_dtype=torch.bfloat16)
    frames = np.random.default_rng(SEED + 12).integers(0, 256, (VAL_BF16_FRAMES, 480, 640, 3), dtype=np.uint8)
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_val_"))
    try:
        out = _val_bf16(report, pred, spec, frames, root)
        del pred
        out["tasks"] = {task: _task_val_bf16(report, task, root / task) for task in VAL_TIMED}
        return out
    finally:
        shutil.rmtree(root, ignore_errors=True)


# the other tasks' validation at full width: batch, imgsz, frames, frame (h, w)
VAL_TIMED = {"segment": (16, 640, 32, (480, 640)), "obb": (16, 1024, 32, (768, 1024)),
             "classify": (64, 224, 128, (480, 640))}


def _task_val_bf16(report, task: str, root: Path):
    """One task's validation path in bf16 (`VAL_TIMED`; segment and OBB at
    the val defaults through `YOLO11Validator.validate`, classify through
    `evaluate_classifier`) on PNG frames labelled with the model's own
    predictions: the path's run (its first batch captures the signature)
    with the counters reset, one batch's uncaptured body, a timed run
    (images/s, peak device memory), and the kernels at the path's own
    inputs: C (K = 4096) and F on the OBB path, G and the IoU build in front
    of it on the segment path."""
    import gc

    import torch

    import yolo_infer_tpu_torch.ops.decode as decode_mod
    import yolo_infer_tpu_torch.ops.nms as nms_ops
    import yolo_infer_tpu_torch.ops.rotated as rot_mod
    from yolo_infer_tpu_torch.core.predictor import Predictor
    from yolo_infer_tpu_torch.core.validator import YOLO11Validator
    from yolo_infer_tpu_torch.data.classify import ClassifyDataset, _resize_center_crop, evaluate_classifier
    from yolo_infer_tpu_torch.ops.kernels import greedy_nms as g_mod
    from yolo_infer_tpu_torch.ops.kernels import rotated_nms_fused as rn_mod
    from yolo_infer_tpu_torch.ops.letterbox import letterbox

    batch, imgsz, n, hw = VAL_TIMED[task]
    model, spec = report["task_weights"][task]
    pred = Predictor(model, spec, device="cuda", compute_dtype=torch.bfloat16)
    frames = np.random.default_rng(SEED + 13).integers(0, 256, (n,) + hw + (3,), dtype=np.uint8)
    path_name = f"{task} val b{batch} {imgsz} bf16"
    val = dict(VAL, imgsz=imgsz, batch=batch)
    if task == "classify":
        ds = ClassifyDataset(write_classify_tree(root, frames, rank_labels(pred, frames, imgsz), spec.nc), "val")
        run = lambda: evaluate_classifier(None, ds, imgsz=imgsz, batch=batch, predictor=pred)  # noqa: E731
    else:
        labels = pred.predict(frames, conf=0.25, iou=VAL["iou"], imgsz=imgsz)
        data = write_val_dataset(root, frames, labels, task, spec.nc)
        validator = YOLO11Validator(model=pred, output_dir=root / "out")
        run = lambda: validator.validate(data, verbose=False, **val)  # noqa: E731
    path, first = path_counters(run)
    seen = {}
    restores = [capture_inputs(decode_mod, "dfl_decode", seen, clone=False),
                capture_inputs(nms_ops, "box_iou_matrix", seen, clone=False),
                capture_inputs(nms_ops, "greedy_nms_keep", seen, clone=False),
                capture_inputs(rot_mod, "rotated_nms_keep", seen, clone=False)]
    reset_counters()
    try:
        if task == "classify":
            eager_run(pred, np.stack([_resize_center_crop(f, imgsz) for f in frames[:batch]]), imgsz, 0.0, 0.0)
        else:
            lb = np.stack([letterbox(f, imgsz)[0] for f in frames[:batch]])
            eager_run(pred, lb, imgsz, VAL["conf"], VAL["iou"], multi_label=True, pre_topk=VAL["pre_topk"],
                      mask_out="bits" if task == "segment" else None)
    finally:
        for restore in restores:
            restore()
    body = read_counters()
    counts = path_launches(f"{task} validation path", VAL_TASK_KERNELS[task], path, body)
    out = {"batch": batch, "imgsz": imgsz, "frames": n, "frame_hw": list(hw),
           "launches": {k: r["launches"] for k, r in counts.items()}, "launches_per_call": body}
    if task == "classify":
        if first["num_images"] != n or not 0 < first["top1"] < first["top5"] < 1:
            raise AssertionError(f"classify evaluation out of range: {first}")
    elif first["num_images"] != n or not 0 < first["metrics"]["mAP50"] <= 1:
        raise AssertionError(f"{task} validation out of range: {first['metrics']}, {first['num_images']} images")
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    timed = run()
    wall = time.perf_counter() - t0
    out["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    # one more run under torch.profiler: the kernels' busy share of its wall time
    out["run_profile"] = kernel_profile(run, calls=1)
    if task == "classify":
        out.update(images_per_s=n / wall, total_s=wall, first_run=first, result=timed)
        return out
    out.update(images_per_s=timed["speed"]["images_per_s"], inference_ms_per_image=timed["speed"]["inference_ms_per_image"],
               total_s=timed["speed"]["total_s"], first_run=first["speed"], metrics=timed["metrics"],
               mask_metrics=timed.get("mask_metrics"), kernels=[])
    if task == "obb":
        gauss, valid, thr = seen["rotated_nms_keep"]
        kernel_c = lambda: rn_mod.rotated_nms_keep(gauss, valid, thr)  # noqa: E731
        plain_c = lambda: rn_mod.rotated_nms_keep_reference(gauss, valid, thr)  # noqa: E731
        err_c = float((kernel_c() != plain_c()).sum())
        if err_c:
            raise AssertionError(f"kernel C differs from its plain version on the OBB validation path: {err_c}")
        b, k, _ = gauss.shape
        if k != VAL["pre_topk"]:
            raise AssertionError(f"kernel C ran at K = {k} on the OBB validation path, not {VAL['pre_topk']}")
        ops_c = valid_pairs(valid) * PROBIOU_OPS + b * k * 4
        out["kernels"] += [{
            "name": "rotated_nms_keep", "route": "cuda", "source": "yolo_infer_tpu_torch/csrc/rotated_nms_fused.cu",
            "replaces": "yolo_infer_tpu/ops/pallas/nms_fused.py:149", "path": path_name,
            **counts["rotated_nms_keep"], "max_abs_err": err_c, **c_time_split(gauss, valid, thr),
            "warm_ms": device_ms(kernel_c), "plain_ms": device_ms(plain_c, iters=3),
            "call_ms": cuda_ms(kernel_c, iters=20), "plain_call_ms": cuda_ms(plain_c, iters=3, warmup=1),
            **bound(gauss.numel() * 4 + 2 * b * k, ops_c, H100_F32_OPS_UNFUSED), "library_ms": None,
            "shape": [b, k, 5], "valid": int(valid.sum()), "valid_pairs": valid_pairs(valid)},
            {**dfl_row(*seen["dfl_decode"], counts["dfl_decode"]["launches"], path_name), **counts["dfl_decode"]}]
    else:
        iou, valid, thr = seen["greedy_nms_keep"]
        sup, _ = seen["box_iou_matrix"]
        kernel_g = lambda: g_mod.greedy_nms_keep(iou, valid, thr)  # noqa: E731
        plain_g = lambda: g_mod.greedy_nms_keep_reference(iou, valid, thr)  # noqa: E731
        err_g = float((kernel_g() != plain_g()).sum())
        if err_g:
            raise AssertionError(f"kernel G differs from its plain version on the segment validation path: {err_g}")
        bk, k, _ = iou.shape
        pairs_g = valid_pairs(valid)
        out["kernels"] += [{
            "name": "greedy_nms_keep", "route": "cuda", "source": "yolo_infer_tpu_torch/csrc/greedy_nms.cu",
            "replaces": "yolo_infer_tpu/ops/pallas/nms_kernel.py:48", "path": path_name,
            **counts["greedy_nms_keep"], "max_abs_err": err_g, **g_time_split(iou, valid, thr),
            "plain_ms": device_ms(plain_g, iters=3), "call_ms": cuda_ms(kernel_g, iters=20),
            "plain_call_ms": cuda_ms(plain_g, iters=3, warmup=1),
            **bound(4 * pairs_g + 2 * bk * k, pairs_g, H100_F32_FLOPS), "library_ms": None, "shape": [bk, k, k],
            "valid": int(valid.sum()), "box_iou_matrix_ms": device_ms(lambda: nms_ops.box_iou_matrix(sup, sup), iters=5)}]
    del seen, pred
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _val_bf16(report, pred, spec, frames, root: Path):
    import torch

    report.setdefault("kernels", [])  # phase 5 starts the list; this phase may run alone
    import yolo_infer_tpu_torch.ops.decode as decode_mod
    import yolo_infer_tpu_torch.ops.nms as nms_ops
    from yolo_infer_tpu_torch.core.validator import YOLO11Validator
    from yolo_infer_tpu_torch.ops.kernels import greedy_nms as g_mod
    from yolo_infer_tpu_torch.ops.letterbox import letterbox

    labels = pred.predict(frames, conf=0.25, iou=VAL["iou"], imgsz=VAL["imgsz"])
    data = write_val_dataset(root / "data", frames, labels, "detect", spec.nc)
    validator = YOLO11Validator(model=pred, output_dir=root / "out")

    # the path's run: the first batch captures the signature, the others
    # replay it, and the run's end releases it
    path, first = path_counters(lambda: validator.validate(data, verbose=False, **VAL))
    # one validation batch through the body the graph replays (the frames
    # host-letterboxed as the validator does), with counters at 0 and kernel
    # inputs captured
    seen = {}
    restores = [capture_inputs(decode_mod, "dfl_decode", seen, clone=False),
                capture_inputs(nms_ops, "box_iou_matrix", seen, clone=False),
                capture_inputs(nms_ops, "greedy_nms_keep", seen, clone=False)]
    reset_counters()
    try:
        batch = np.stack([letterbox(f, VAL["imgsz"])[0] for f in frames[:VAL["batch"]]])
        eager_run(pred, batch, VAL["imgsz"], VAL["conf"], VAL["iou"], multi_label=True, pre_topk=VAL["pre_topk"])
    finally:
        for restore in restores:
            restore()
    body = read_counters()
    counts = path_launches("validation path", ("attention_qkv", "dfl_decode", "greedy_nms_keep"), path, body)
    launches = {k: r["launches"] for k, r in counts.items()}
    if not 0 < first["metrics"]["mAP50"] <= 1 or first["num_images"] != VAL_BF16_FRAMES:
        raise AssertionError(f"validation result out of range: {first['metrics']}, {first['num_images']} images")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    timed = validator.validate(data, verbose=False, **VAL)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    # kernel G at the path's own input, and the plain IoU build in front of it
    iou, valid, thr = seen["greedy_nms_keep"]
    sup, _ = seen["box_iou_matrix"]
    kernel_g = lambda: g_mod.greedy_nms_keep(iou, valid, thr)  # noqa: E731
    plain_g = lambda: g_mod.greedy_nms_keep_reference(iou, valid, thr)  # noqa: E731
    iou_build = lambda: nms_ops.box_iou_matrix(sup, sup)  # noqa: E731
    err_g = float((kernel_g() != plain_g()).sum())
    bk, k, _ = iou.shape
    # what any implementation must read: the IoU of each pair of valid
    # candidates above the diagonal (a row's IoU with an invalid or lower
    # candidate is never used), plus the valid flags in and the keep flags out
    pairs_g = valid_pairs(valid)
    bytes_g = 4 * pairs_g + 2 * bk * k
    read_check = g_read_check(iou, valid, thr)
    if err_g:
        raise AssertionError(f"kernel G differs from its plain version on the validation path: {err_g}")
    val_path = f"detect val b{VAL['batch']} {VAL['imgsz']} bf16"
    # kernel F at the path's own input: the strided (16, 8400, 64) slice of the head slab
    report["kernels"] += [{**dfl_row(*seen["dfl_decode"], launches["dfl_decode"], val_path),
                           **counts["dfl_decode"]}, {
        "name": "greedy_nms_keep", "route": "cuda", "source": "yolo_infer_tpu_torch/csrc/greedy_nms.cu",
        "replaces": "yolo_infer_tpu/ops/pallas/nms_kernel.py:48", "path": val_path,
        **counts["greedy_nms_keep"], "max_abs_err": err_g,
        **g_time_split(iou, valid, thr), "plain_ms": device_ms(plain_g, iters=3),
        "call_ms": cuda_ms(kernel_g, iters=20), "plain_call_ms": cuda_ms(plain_g, iters=3, warmup=1),
        **bound(bytes_g, pairs_g, H100_F32_FLOPS),
        "library_ms": None, "shape": [bk, k, k], "valid": int(valid.sum()),
        "read_check": read_check, "gb": bytes_g / 1e9,
    }]
    f_row, g_row = report["kernels"][-2:]
    # the bits pass's read rate over the pairs it must read, on the path's IoU
    # and on a fresh random one, L2 flushed before each call: no reading may
    # pass the card's HBM rate (traces that had lost their first launches
    # read 3.35 and 3.9 TB/s)
    g_row["bits_read_tb_per_s"] = 4 * pairs_g / (g_row["bits_ms"] * 1e-3) / 1e12
    rates = [g_row["bits_read_tb_per_s"]] + [read_check[k]["bits_read_tb_per_s"]
                                             for k in ("path_iou", "fresh_random_iou")]
    if max(rates) > H100_BYTES_PER_S / 1e12:
        raise AssertionError(f"G's bits pass reads {max(rates):.4f} TB/s, above the card's "
                             f"{H100_BYTES_PER_S / 1e12} TB/s: {read_check}")
    frames_dev = torch.from_numpy(frames[:VAL["batch"]]).cuda()
    profile = kernel_profile(lambda: pred.predict_raw(frames_dev, VAL["conf"], VAL["iou"], VAL["imgsz"], 300,
                                                      multi_label=True, pre_topk=VAL["pre_topk"]))
    return {"phase": "val_bf16", "frames": VAL_BF16_FRAMES, "batch": VAL["batch"], "imgsz": VAL["imgsz"],
            "images_per_s": timed["speed"]["images_per_s"],
            "inference_ms_per_image": timed["speed"]["inference_ms_per_image"], "total_s": timed["speed"]["total_s"],
            "first_run": first["speed"], "metrics": timed["metrics"], "peak_memory_gb": peak_gb,
            "launches": launches, "launches_per_call": body,
            "per_batch_ms": {"dfl_decode": f_row["ms"], "greedy_nms_keep": g_row["ms"],
                             "box_iou_matrix": device_ms(iou_build, iters=5)},
            "bound_ms": {"dfl_decode": f_row["bound_ms"], "greedy_nms_keep": g_row["bound_ms"]},
            "iou_matrix_gb": iou.numel() * 4 / 1e9, "profile": profile}


def box_iou_np(a, b):
    lt, rb = np.maximum(a[:, None, :2], b[None, :, :2]), np.minimum(a[:, None, 2:], b[None, :, 2:])
    inter = np.prod(np.clip(rb - lt, 0, None), axis=-1)
    area = lambda z: np.prod(z[:, 2:] - z[:, :2], axis=-1)  # noqa: E731
    return inter / (area(a)[:, None] + area(b)[None] - inter)


def pair_share(got, want, lo: float = 0.35, score_tol: float = 0.1):
    """Both ways, the share of the detections scoring >= lo that have a
    partner in the other prediction (same class, IoU >= 0.5, score within
    score_tol), and the box and score errors of the best-IoU partners."""
    paired = seen = 0
    box_errs, score_errs = [], []
    for g, w in zip(got, want):
        for a, b in ((g, w), (w, g)):
            keep = a.scores >= lo
            if not keep.any() or not len(b):
                seen += int(keep.sum())
                continue
            iou = box_iou_np(a.boxes[keep], b.boxes)
            ok = (iou >= 0.5) & (a.classes[keep, None] == b.classes[None]) \
                & (np.abs(a.scores[keep, None] - b.scores[None]) <= score_tol)
            paired += int(ok.any(1).sum())
            seen += int(keep.sum())
            rows = np.nonzero(ok.any(1))[0]
            best = np.where(ok, iou, -1).argmax(1)[rows]
            box_errs += list(np.abs(a.boxes[keep][rows] - b.boxes[best]).max(1))
            score_errs += list(np.abs(a.scores[keep][rows] - b.scores[best]))
    q = lambda v: [float(np.quantile(v, p)) for p in (0.5, 0.9, 1.0)] if v else None  # noqa: E731
    return {"share": paired / max(seen, 1), "seen": seen, "box_err_p50_p90_max": q(box_errs),
            "score_err_p50_p90_max": q(score_errs)}


def phase_q8_fp32(report):
    import torch

    from yolo_infer_tpu_torch.core.model import YOLO11Model
    from yolo_infer_tpu_torch.optimization.quantization.quantizers import create_quantizer

    rng = np.random.default_rng(SEED + 13)
    calib = rng.integers(0, 256, (2, 640, 640, 3), dtype=np.uint8)
    model, spec = smoke_weights(calib, size="s", calibrate_bn=False)
    report["q8_weights"] = (model, spec)
    base = YOLO11Model.from_params(copy.deepcopy(model), task="detect", size="s", fused=False,
                                   compute_dtype=torch.float32, device="cpu")
    ptq = create_quantizer("ptq", base, {"imgsz": 640})
    ptq.set_calibration_data([calib])
    on_cpu = ptq.optimize()
    on_gpu = YOLO11Model.from_params(copy.deepcopy(on_cpu.deploy_model), task="detect", size="s", fused=True,
                                     quant_act_scales=on_cpu.quant_act_scales, compute_dtype=torch.float32)
    frames = rng.integers(0, 256, (2, 480, 640, 3), dtype=np.uint8)
    torch.backends.cudnn.deterministic = True
    try:
        got = on_gpu.predict(frames, conf=0.25)
        reset_counters()
        eager_run(on_gpu.predictor, frames, 640)  # the launches, from the body the graph replays
        launches = read_counters()
    finally:
        torch.backends.cudnn.deterministic = False
    want = on_cpu.predict(frames, conf=0.25)
    pairs = pair_share(got, want)
    out = {"phase": "q8_fp32", "launches": launches, "quantized_convs": len(on_cpu.quant_act_scales),
           "num_cuda": [len(r) for r in got], "num_cpu": [len(r) for r in want], "pairs": pairs}
    if launches["int8_conv"] < 1 or pairs["seen"] == 0 or pairs["share"] < Q8_PAIRED:
        emit(out)
        raise AssertionError("static8 predict on cuda differs from cpu (or kernel E did not run)")
    return out


def _e_work(args, kw):
    """Bytes kernel E must move (input, weights, scale and bias read once,
    output written once) and its int8 operations (a multiply and an add per
    MAC) at one captured launch."""
    x, w_q, scale, bias = args[:4]
    b, h, w, ci = x.shape
    co, k = w_q.shape[0], w_q.shape[1]
    s = kw.get("stride", 1)
    ho, wo = (h + 2 * (k // 2) - k) // s + 1, (w + 2 * (k // 2) - k) // s + 1
    nbytes = x.numel() + w_q.numel() + 4 * co * (2 if bias is not None else 1) + b * ho * wo * co
    return nbytes, 2 * b * ho * wo * co * ci * k * k, (b, h, w, ci, co, k, s)


def phase_q8_bf16(report):
    import torch

    import yolo_infer_tpu_torch.models.blocks as blocks_mod
    from yolo_infer_tpu_torch.core.model import YOLO11Model
    from yolo_infer_tpu_torch.core.validator import YOLO11Validator
    from yolo_infer_tpu_torch.ops.kernels import int8_conv as e_mod
    from yolo_infer_tpu_torch.optimization.quantization.quantizers import create_quantizer

    model, spec = report["q8_weights"]
    batch, imgsz = Q8_SERVE
    rng = np.random.default_rng(SEED + 14)
    calib = [rng.integers(0, 256, (8, imgsz, imgsz, 3), dtype=np.uint8) for _ in range(2)]
    frames = rng.integers(0, 256, (batch, imgsz, imgsz, 3), dtype=np.uint8)
    base = YOLO11Model.from_params(copy.deepcopy(model), task="detect", size="s", fused=False)  # bf16, cuda
    t0 = time.perf_counter()
    ptq = create_quantizer("ptq", base, {"imgsz": imgsz})
    ptq.set_calibration_data(calib)
    qmodel = ptq.optimize()
    torch.cuda.synchronize()
    ptq_s = time.perf_counter() - t0
    qpred, bpred = qmodel.predictor, base.predictor
    # the static8 path's run: the signature's capture, then a replay
    path, results = path_counters(lambda: (qmodel.predict(frames, conf=0.25, imgsz=imgsz),
                                           qmodel.predict(frames, conf=0.25, imgsz=imgsz))[1])
    bpred.predict(frames, conf=0.25, imgsz=imgsz)  # the bf16 yardstick's capture
    torch.cuda.synchronize()

    # the static8 path's body (what the graph replays), once, with counters
    # at 0 and every E input captured; a channel chunk is copied with its
    # pixel pitch, so E reads it as the path did
    seen = []
    e_fn = blocks_mod.int8_conv

    def keep_layout(t):
        return torch.empty_strided(t.size(), t.stride(), dtype=t.dtype, device=t.device).copy_(t)

    def capture(*args, **kw):
        seen.append((tuple(keep_layout(a) if torch.is_tensor(a) else a for a in args), kw))
        return e_fn(*args, **kw)

    blocks_mod.int8_conv = capture
    reset_counters()
    try:
        eager_run(qpred, frames, imgsz)
    finally:
        blocks_mod.int8_conv = e_fn
    body = read_counters()
    if body["int8_conv"] != Q8_E_LAUNCHES:
        raise AssertionError(f"static8 body launches {body}, expected {Q8_E_LAUNCHES} of kernel E")
    counts = path_launches("static8 path", ("int8_conv", "nms_keep", "attention_qkv"), path, body)
    launches = {k: r["launches"] for k, r in counts.items()}
    nums = [len(r) for r in results]
    for r in results:
        if not (np.isfinite(r.boxes).all() and np.isfinite(r.scores).all() and len(r) <= 300):
            raise AssertionError("non-finite or oversized static8 detections")
    timing_q8 = timed_serving(qpred, frames, imgsz)
    timing_bf16 = timed_serving(bpred, frames, imgsz)

    # kernel E at each of its 48 inputs on the path
    per, diff_codes, max_err = [], 0, 0
    bytes_e = ops_e = 0
    e_ms = device_ms_each([lambda a=args, k=kw: e_mod.int8_conv(*a, **k) for args, kw in seen])
    for (args, kw), ms in zip(seen, e_ms):
        got, want = e_mod.int8_conv(*args, **kw), e_mod.int8_conv_reference(*args, **kw)
        d = (got.int() - want.int()).abs()
        diff_codes += int((d > 0).sum())
        max_err = max(max_err, int(d.max()))
        nbytes, ops, shape = _e_work(args, kw)
        bytes_e, ops_e = bytes_e + nbytes, ops_e + ops
        per.append({"shape": list(shape), "epilogue": str(kw.get("epilogue_dtype")),
                    "ms": ms,
                    "call_ms": cuda_ms(lambda: e_mod.int8_conv(*args, **kw), iters=10, warmup=2),
                    "plain_ms": cuda_ms(lambda: e_mod.int8_conv_reference(*args, **kw), iters=2, warmup=1),
                    "bound_ms": 1e3 * max(nbytes / H100_BYTES_PER_S, ops / H100_INT8_OPS)})
    del got, want, d
    if max_err:
        raise AssertionError(f"kernel E differs from its plain version on the static8 path: {diff_codes} codes, "
                             f"up to {max_err}")
    own = [p for p in per if p["shape"][5] == 3 and p["shape"][6] == 1]
    chunks = [args[0] for args, _ in seen if not args[0].is_contiguous()]
    profile = kernel_profile(lambda: qpred.predict(frames, conf=0.25, imgsz=imgsz),
                             named=("int8_conv_kernel", "copy"))
    e_prof = profile["named"]["int8_conv_kernel"]
    # the same path with every E input copied to a contiguous NHWC tensor
    # first, chunks included: captured anew with the copies, and again after
    nhwc_input = blocks_mod.nhwc_input
    blocks_mod.nhwc_input = lambda x: x.permute(0, 2, 3, 1).contiguous()
    qpred.release_programs()
    try:
        copied = kernel_profile(lambda: qpred.predict(frames, conf=0.25, imgsz=imgsz),
                                named=("int8_conv_kernel", "copy"))
    finally:
        blocks_mod.nhwc_input = nhwc_input
        qpred.release_programs()
    in_place = {"e_inputs_read_in_place": len(chunks), "bytes_not_copied": sum(c.numel() for c in chunks),
                "copy_kernels_in_place": profile["named"]["copy"], "copy_kernels_copied": copied["named"]["copy"],
                "kernel_ms_per_predict_copied": copied["kernel_ms_per_predict"]}
    report["kernels"].append({
        "name": "int8_conv", "route": "cuda", "source": "yolo_infer_tpu_torch/csrc/int8_conv.cu",
        "replaces": "yolo_infer_tpu/ops/pallas/int8_conv.py:64", "path": f"yolo11s static8 b{batch} {imgsz} bf16",
        **counts["int8_conv"], "max_abs_err": float(max_err), "codes_differing": diff_codes,
        "ms": e_prof["ms"], "plain_ms": sum(p["plain_ms"] for p in per),
        "call_ms": sum(p["call_ms"] for p in per), "per_launch_ms_sum": sum(p["ms"] for p in per),
        **bound(bytes_e, ops_e, H100_INT8_OPS),
        "library_ms": None, "gb": bytes_e / 1e9, "gmac": ops_e / 2e9,
        "note": "ms, plain_ms and bound_ms are summed over the launches of one predict",
    })
    del seen

    # fidelity: the bf16 model's detections at conf 0.25 are the labels
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_q8_"))
    try:
        labels = bpred.predict(frames, conf=0.25, imgsz=imgsz)
        data = write_val_dataset(root / "data", frames, labels, "detect", spec.nc)
        fid = {}
        for name, m in (("bf16", base), ("static8", qmodel)):
            r = YOLO11Validator(model=m, output_dir=root / name).validate(
                data, imgsz=imgsz, batch=16, conf=0.001, iou=0.45, multi_label=False, verbose=False)
            fid[name] = r["metrics"]
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out = {"phase": "q8_bf16", "batch": batch, "imgsz": imgsz, "ptq_s": ptq_s,
           "calibration_batches": len(calib), "static8": timing_q8, "bf16": timing_bf16,
           "static8_vs_bf16_img_per_s": timing_q8["img_per_s"] / timing_bf16["img_per_s"],
           "static8_vs_bf16_device_ms": timing_q8["device_ms_per_batch"] / timing_bf16["device_ms_per_batch"],
           "launches": launches, "launches_per_call": body, "detections_per_image": [min(nums), max(nums)],
           "labels_per_image": [min(len(r) for r in labels), max(len(r) for r in labels)],
           "e_device_ms_per_predict": e_prof["ms"], "e_launches_profiled": e_prof["calls"],
           "e_call_ms_sum": sum(p["call_ms"] for p in per), "e_bound_ms_sum": report["kernels"][-1]["bound_ms"],
           "e_own_shape": own, "e_per_launch": per, "e_chunk_inputs": in_place, "fidelity": fid,
           "profile": profile}
    if not fid["static8"]["mAP50"] >= 0.9:
        emit(out)
        raise AssertionError(f"static8 fidelity mAP50 {fid['static8']['mAP50']} < 0.9 against the bf16 labels")
    return out


def phase_int8(report):
    import torch

    from yolo_infer_tpu_torch.ops.kernels.int8_conv import int8_conv, int8_conv_reference

    rng = np.random.default_rng(SEED + 15)
    out = {"phase": "int8", "cases": []}
    for k, stride in ((1, 1), (1, 2), (3, 1), (3, 2)):
        for b, h, w, ci, co, pitch in ((32, 20, 20, 256, 128, 256), (3, 13, 11, 130, 70, 130),
                                       (32, 20, 20, 128, 128, 256), (2, 9, 9, 512, 64, None)):
            if pitch is not None:  # the first ci channels of a (b, h, w, pitch) tensor, read in place
                x = torch.from_numpy(rng.integers(-127, 128, (b, h, w, pitch), dtype=np.int8)).cuda()[..., :ci]
                wq = torch.from_numpy(rng.integers(-127, 128, (co, k, k, ci), dtype=np.int8)).cuda()
                scale = rng.uniform(0.5, 1.5, co) / (127 * 60 * k * np.sqrt(ci))
            else:  # large positive codes: int32 sums in the millions (beyond 2^24 at k = 3: f32 rounds them)
                x = torch.from_numpy(rng.integers(100, 128, (b, h, w, ci), dtype=np.int8)).cuda()
                wq = torch.from_numpy(rng.integers(100, 128, (co, k, k, ci), dtype=np.int8)).cuda()
                scale = rng.uniform(0.5, 1.5, co) / (113.5 ** 2 * k * k * ci)
            scale = torch.from_numpy(scale.astype(np.float32)).cuda()
            bias = torch.from_numpy(rng.normal(0, 0.5, co).astype(np.float32)).cuda()
            for ed in (torch.float32, torch.bfloat16):
                got = int8_conv(x, wq, scale, bias, 1 / 0.02, stride=stride, epilogue_dtype=ed)
                want = int8_conv_reference(x, wq, scale, bias, 1 / 0.02, stride=stride, epilogue_dtype=ed)
                torch.cuda.synchronize()
                d = (got.int() - want.int()).abs()
                case = {"shape": [b, h, w, ci, co], "pitch": pitch, "k": k, "stride": stride, "epilogue": str(ed),
                        "codes_differing": int((d > 0).sum()), "max_code_diff": int(d.max()),
                        "mean_abs_code": float(got.float().abs().mean())}
                out["cases"].append(case)
                if case["max_code_diff"]:
                    emit(out)
                    raise AssertionError(f"kernel E differs from its plain version: {case}")
    return out


def phase_attn_packed(report):
    import torch

    from yolo_infer_tpu_torch.ops.kernels.attention_fused import (
        attention_packed,
        attention_packed_reference,
        attention_qkv,
    )

    rng = np.random.default_rng(SEED + 16)
    out = {"phase": "attn_packed", "cases": []}
    for g, n, dtype, atol, rtol in ((64, 400, torch.bfloat16, 2e-2, 2e-2), (64, 400, torch.float32, 1e-5, 0.0),
                                    (8, 1600, torch.bfloat16, 2e-2, 2e-2)):
        qg = torch.from_numpy(rng.standard_normal((g, n, 128)).astype(np.float32)).cuda().to(dtype)
        got, want = attention_packed(qg, 32, 64), attention_packed_reference(qg, 32, 64)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        out["cases"].append({"G": g, "N": n, "dtype": str(dtype), "max_abs_err": err})
        torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)
    # H on a head-major copy of a qkv slab against B reading the slab in place
    slab = torch.from_numpy(rng.standard_normal((32, 400, 256)).astype(np.float32)).cuda().to(torch.bfloat16)
    h_out = attention_packed(slab.view(32, 400, 2, 128).transpose(1, 2).reshape(64, 400, 128), 32, 64)
    b_out = attention_qkv(slab, 2, 32, 64).view(32, 400, 2, 64).transpose(1, 2).reshape(64, 400, 64)
    route_err = float((h_out.float() - b_out.float()).abs().max())
    out["h_vs_b_route"] = {"max_abs_err": route_err, "equal": bool(torch.equal(h_out, b_out))}
    if route_err > 2e-2:
        raise AssertionError(f"H's route differs from B's by {route_err}")
    return out


def phase_attn_pallas(report):
    import torch
    import torch.nn.functional as F

    import yolo_infer_tpu_torch.models.blocks as blocks_mod
    from yolo_infer_tpu_torch.core.predictor import Predictor
    from yolo_infer_tpu_torch.ops.kernels import attention_fused as attn_mod

    model, spec = report["weights"]
    pred = Predictor(model, spec, device="cuda", compute_dtype=torch.bfloat16)
    batch, imgsz = ATTN_SERVE
    frames = np.random.default_rng(SEED + 17).integers(0, 256, (batch, imgsz, imgsz, 3), dtype=np.uint8)
    want = pred.predict(frames, conf=0.25, imgsz=imgsz)  # the default route (B)
    seen = {}
    os.environ["YOLO_ATTN_IMPL"] = "pallas"  # part of the program-cache key: a new capture
    try:
        # the route's run: the signature's capture, then a replay
        path, got = path_counters(lambda: (pred.predict(frames, conf=0.25, imgsz=imgsz),
                                           pred.predict(frames, conf=0.25, imgsz=imgsz))[1])
        # the launches per call and H's input from the body the graph replays
        restore = capture_inputs(blocks_mod, "attention_packed", seen)
        reset_counters()
        try:
            eager_run(pred, frames, imgsz)
        finally:
            restore()
        body = read_counters()
        counts = path_launches("pallas route", ("attention_packed", "nms_keep"), path, body)
        launches = {k: r["launches"] for k, r in counts.items()}
        timing = timed_serving(pred, frames, imgsz)
    finally:
        del os.environ["YOLO_ATTN_IMPL"]
    if body["attention_qkv"] != 0 or path["attention_qkv"] != 0:
        raise AssertionError(f"the pallas route did not run kernel H alone: path {path}, body {body}")
    same = all(np.array_equal(g.boxes, w.boxes) and np.array_equal(g.scores, w.scores)
               and np.array_equal(g.classes, w.classes) for g, w in zip(got, want))
    if not same:
        raise AssertionError("the pallas route's Results differ from the default route's")
    qg, kd, hd = seen["attention_packed"]
    g, n, _ = qg.shape
    kernel_h = lambda: attn_mod.attention_packed(qg, kd, hd)  # noqa: E731
    plain_h = lambda: attn_mod.attention_packed_reference(qg, kd, hd)  # noqa: E731
    q, k, v = qg[..., :kd], qg[..., kd:2 * kd], qg[..., 2 * kd:]
    library_h = lambda: F.scaled_dot_product_attention(q, k, v, scale=kd ** -0.5)  # noqa: E731
    got_h, want_h = kernel_h(), plain_h()
    err_h, excess_h = float((got_h.float() - want_h.float()).abs().max()), attn_tol_excess(got_h, want_h)
    if excess_h > 0:
        raise AssertionError(f"kernel H differs from its plain version on the pallas route by {err_h}")
    bytes_h = qg.numel() * qg.element_size() + g * n * hd * qg.element_size()
    flops_h = 2 * g * n * n * (kd + hd)
    report["kernels"].append({
        "name": "attention_packed", "route": "cuda", "source": "yolo_infer_tpu_torch/csrc/attention_fused.cu",
        "replaces": "yolo_infer_tpu/ops/pallas/attention_fused.py:192", "path": f"detect b{batch} {imgsz} bf16 YOLO_ATTN_IMPL=pallas",
        **counts["attention_packed"], "max_abs_err": err_h, "tol_excess": excess_h,
        "ms": device_ms(kernel_h), "plain_ms": device_ms(plain_h),
        **bound(bytes_h, flops_h, H100_BF16_FLOPS),
        "library_ms": device_ms(library_h),
        "call_ms": cuda_ms(kernel_h), "plain_call_ms": cuda_ms(plain_h), "library_call_ms": cuda_ms(library_h),
        "shape": [g, n, qg.shape[-1]], "dtype": str(qg.dtype),
    })
    return {"phase": "attn_pallas", **timing, "launches": launches, "launches_per_call": body,
            "results_equal_default_route": same,
            "detections_per_image": [min(len(r) for r in got), max(len(r) for r in got)]}

MANY_FRAMES = 150  # predict_many: five chunks of 32, the last padded
SEG_MANY_FRAMES = 64


def htod_overlap(prof):
    """(ms of host-to-device copies, ms of them during which a kernel ran) in
    a torch.profiler trace (its chrome trace's `gpu_memcpy` and `kernel` events)."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        events = json.loads(Path(path).read_text())["traceEvents"]
    finally:
        os.unlink(path)
    copies = [(e["ts"], e["ts"] + e["dur"]) for e in events
              if e.get("cat") == "gpu_memcpy" and "HtoD" in e.get("name", "")]
    busy = []  # the union of kernel intervals
    for a, b in sorted((e["ts"], e["ts"] + e["dur"]) for e in events if e.get("cat") == "kernel"):
        if busy and a <= busy[-1][1]:
            busy[-1][1] = max(busy[-1][1], b)
        else:
            busy.append([a, b])
    overlap = sum(max(0.0, min(t, b) - max(s, a)) for s, t in copies for a, b in busy)
    return sum(t - s for s, t in copies) / 1e3, overlap / 1e3


def host_parts(pred, chunk):
    """Median host ms (5 tries) of the parts of one chunk of `predict_many`:
    stacking 32 frames into a reused pinned buffer, enqueueing `predict_raw`
    (the launches; the card runs behind), and building the Results."""
    import torch

    buf = torch.empty((len(chunk),) + chunk[0].shape, dtype=torch.uint8, pin_memory=True)
    frames_dev = buf.cuda()
    parts = {"stack": [], "launch": [], "results": []}
    for _ in range(5):
        t0 = time.perf_counter()
        np.stack(chunk, axis=0, out=buf.numpy())
        parts["stack"].append(time.perf_counter() - t0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dets = pred.predict_raw(frames_dev, 0.25, 0.45, 640)
        parts["launch"].append(time.perf_counter() - t0)
        dets = {k: v.cpu().numpy() for k, v in dets.items()}
        t0 = time.perf_counter()
        pred._postprocess(dets, None, [chunk[0].shape[:2]] * len(chunk), None, 640, chunk[0].shape[:2], 1.0)
        parts["results"].append(time.perf_counter() - t0)
    return {k: 1e3 * float(np.median(v)) for k, v in parts.items()}


def same_results(got, want, box_tol: float = 1e-3, score_tol: float = 1e-5):
    """Differences between two Results lists: per image, a count or class
    mismatch, or boxes / scores beyond the tolerances (empty when equal)."""
    bad = []
    for i, (g, w) in enumerate(zip(got, want)):
        if len(g) != len(w) or g.orig_shape != w.orig_shape or not np.array_equal(g.classes, w.classes):
            bad.append(f"image {i}: {len(g)} vs {len(w)} detections")
        elif len(g) and (np.abs(g.boxes - w.boxes).max() > box_tol or np.abs(g.scores - w.scores).max() > score_tol):
            bad.append(f"image {i}: boxes off by {np.abs(g.boxes - w.boxes).max()}, "
                       f"scores by {np.abs(g.scores - w.scores).max()}")
    if len(got) != len(want):
        bad.append(f"{len(got)} vs {len(want)} images")
    return bad


def padded_chunks(frames, batch: int):
    """`frames` in chunks of `batch`, the last padded with its last frame, as `predict_many` pads it."""
    return [frames[lo:lo + batch] + [frames[min(lo + batch, len(frames)) - 1]] * max(lo + batch - len(frames), 0)
            for lo in range(0, len(frames), batch)]


def phase_many(report):
    """`predict_many` on the card: Results equal to `predict` on the same
    chunks (uniform, mixed sizes, segment masks), img/s against a loop of
    `predict`, the upload's overlap with kernels, and every task's
    `predict_raw` with no host synchronisation."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from yolo_infer_tpu_torch.core.predictor import LazyMasks, Predictor

    pred, _ = report["serving"]
    rng = np.random.default_rng(SEED + 19)
    frames = list(rng.integers(0, 256, (MANY_FRAMES, 640, 640, 3), dtype=np.uint8))
    mixed = [rng.integers(0, 256, ((480, 640, 3) if i % 2 else (360, 500, 3)), dtype=np.uint8) for i in range(40)]
    out = {"phase": "many", "frames": MANY_FRAMES, "batch_size": 32}
    failures = []

    def loop(fr):
        return [r for c in padded_chunks(fr, 32) for r in pred.predict(c, conf=0.25)][:len(fr)]

    # every chunk replays the one graph of phase 5's b32 signature: the Python
    # counters stay at 0, one A and one B per chunk show by name in a trace
    torch.backends.cudnn.deterministic = True
    try:
        pred.predict_many(frames[:64], conf=0.25, batch_size=32)  # warm-up
        entries = len(pred._cache)
        for name, fr in (("uniform", frames), ("mixed", mixed)):
            reset_counters()
            got = pred.predict_many(fr, conf=0.25, batch_size=32)
            launches = read_counters()
            per_call = replay_names(lambda fr=fr: pred.predict_many(fr, conf=0.25, batch_size=32),
                                    ("iou_bits_kernel", "attn_qkv_mma_kernel"))
            bad = same_results(got, loop(fr))
            chunks = -(-len(fr) // 32)
            out[name] = {"images": len(got), "python_launches": launches, "replay_kernels": per_call,
                         "chunks": chunks, "cache_entries": len(pred._cache), "differences": bad[:5],
                         "detections": sum(len(r) for r in got)}
            if (bad or any(launches.values()) or per_call["iou_bits_kernel"] != chunks
                    or per_call["attn_qkv_mma_kernel"] != chunks or len(pred._cache) != entries):
                failures.append(f"{name}: {bad[:3]}, launches {launches}, per predict_many {per_call}, "
                                f"cache entries {len(pred._cache)} (was {entries})")
        # segment: the masks come to the host at drain time, read through LazyMasks
        model, spec = report["task_weights"]["segment"]
        seg = Predictor(model, spec, device="cuda", compute_dtype=torch.bfloat16, mask_mode="device")
        seg_frames = frames[:SEG_MANY_FRAMES]
        got = seg.predict_many(seg_frames, conf=0.25, batch_size=32)
        want = [r for c in padded_chunks(seg_frames, 32) for r in seg.predict(c, conf=0.25)][:len(seg_frames)]
        LazyMasks.prefetch(want, np.uint8)
        bad = same_results(got, want)
        mask_diff = sum(int((g.masks.numpy(np.uint8) != w.masks.numpy(np.uint8)).sum())
                        for g, w in zip(got, want) if len(g) == len(w) and len(g))
        host = all(isinstance(r.masks, LazyMasks) and not torch.is_tensor(r.masks._dev) for r in got if len(r))
        out["segment"] = {"images": len(got), "differences": bad[:5], "mask_pixels_differing": mask_diff,
                          "masks_held_on_host": host}
        if bad or mask_diff or not host:
            failures.append(f"segment: {bad[:3]}, {mask_diff} mask pixels differ, host-held {host}")
    finally:
        torch.backends.cudnn.deterministic = False

    # img/s: predict_many against a loop of predict over the same frames (turns: loop, many, many, loop)
    times = {"loop": [], "many": []}
    for name in ("loop", "many", "many", "loop", "loop", "many"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loop(frames) if name == "loop" else pred.predict_many(frames, conf=0.25, batch_size=32)
        times[name].append(time.perf_counter() - t0)
    for name, ts in times.items():
        out[f"{name}_img_per_s"] = MANY_FRAMES / float(np.median(ts))
        out[f"{name}_s"] = ts
    out["many_vs_loop"] = out["many_img_per_s"] / out["loop_img_per_s"]
    report["many_img_per_s"] = out["many_img_per_s"]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        lead_in(LEAD_INS)
        pred.predict_many(frames, conf=0.25, batch_size=32)
        torch.cuda.synchronize()
    htod_ms, overlap_ms = htod_overlap(prof)
    out.update(htod_ms=htod_ms, htod_overlapping_kernels_ms=overlap_ms,
               htod_overlap_share=overlap_ms / htod_ms if htod_ms else None)
    out["host_ms_per_chunk"] = host_parts(pred, frames[:32])

    # no host synchronisation inside predict_raw, on any serving tail
    syncs = {}
    frames_dev = torch.from_numpy(np.stack(frames[:8])).cuda()
    tails = [("detect", pred), ("segment", seg)]
    for task in ("pose", "obb"):
        tm, ts = report["task_weights"][task]
        tails.append((task, Predictor(tm, ts, device="cuda", compute_dtype=torch.bfloat16)))
    for name, p in tails:
        p.predict_raw(frames_dev, 0.25, 0.45, 640)  # warm-up outside the check
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            p.predict_raw(frames_dev, 0.25, 0.45, 640)
            syncs[name] = None
        except RuntimeError as exc:
            syncs[name] = str(exc)[:300]
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
    out["host_syncs"] = syncs
    failures += [f"{k} synchronises: {v}" for k, v in syncs.items() if v]
    if failures:
        emit(out)
        raise AssertionError("; ".join(failures))
    return out


MASK_TOL = {"bits": 1e-4, "auto": 1e-4}  # share of pixels that may differ, cuda vs cpu (as phase 9)
# soft masks ("q8", "exact"), cuda vs cpu: one q8 code. A mask logit is a sum
# of 32 prototype x coefficient products that reach ~1e2 in size, so the two
# devices' f32 convs, ~1e-5 apart relative to the products, move a logit near
# 0 by several 1e-3 and its sigmoid by a quarter of that; q8's rounding adds
# up to one code
SOFT_MASK_TOL = 1 / 255 + 1e-6
# "exact": each mask logit (proto @ coefs, the host's input) cuda vs cpu
# within this share of its instance's scale, the largest sum of product
# magnitudes sum_k |p_k c_k| over the instance's pixels: f32 head outputs
# differ by ~1e-5 of their size between the devices, and a bf16 network (a
# rounding is 2e-3 of the value) fails it
MASK_LOGIT_RTOL = 5e-4


def phase_mask_modes(report):
    """The host-finished mask modes, segment fp32 `predict` on cuda against
    the cpu on two frames of different sizes: detections paired as in phase
    9; of each pair, "bits" and "auto" binary masks differing in at most
    1e-4 of the pixels (a mask logit within rounding of 0 thresholds either
    way at prototype resolution), "q8" and "exact" soft masks within one q8
    code (SOFT_MASK_TOL); "exact"'s mask logits, from the prototypes and
    coefficients the host assembles them from, within MASK_LOGIT_RTOL of
    each instance's scale; and "auto" at 640 px equal to
    "device_half" on the card."""
    import torch

    import yolo_infer_tpu_torch.core.predictor as pred_mod
    from yolo_infer_tpu_torch.core.predictor import Predictor

    model, spec = report["task_weights"]["segment"]
    rng = np.random.default_rng(SEED + 20)
    frames = [rng.integers(0, 256, (480, 640, 3), dtype=np.uint8), rng.integers(0, 256, (360, 500, 3), dtype=np.uint8)]
    out = {"phase": "mask_modes", "modes": {}}
    failures = []
    cuda_auto = None
    for mode in ("q8", "bits", "exact", "auto"):
        on_cpu = Predictor(model, spec, device="cpu", compute_dtype=torch.float32, mask_mode=mode)
        on_gpu = Predictor(model, spec, device="cuda", compute_dtype=torch.float32, mask_mode=mode)
        hosted = {"cuda": [], "cpu": []}  # "exact": (proto, coefs) of each image, as the host assembles them
        assemble = pred_mod._assemble_masks

        def capture(side):
            def run(proto, coefs, *args, **kw):
                hosted[side].append((proto.astype(np.float64), coefs.astype(np.float64)))
                return assemble(proto, coefs, *args, **kw)
            return run

        torch.backends.cudnn.deterministic = True
        try:
            pred_mod._assemble_masks = capture("cuda")
            got = on_gpu.predict(frames, conf=0.25, iou=0.45, imgsz=640)
            pred_mod._assemble_masks = capture("cpu")
            want = on_cpu.predict(frames, conf=0.25, iou=0.45, imgsz=640)
        finally:
            torch.backends.cudnn.deterministic = False
            pred_mod._assemble_masks = assemble
        res = {"images": []}
        for k, (g, w) in enumerate(zip(got, want)):
            missing, pairs = match_detections(g, w, 1.0, 1e-3)
            img = {"num_cuda": len(g), "num_cpu": len(w), "unmatched": missing + len(w) - len(pairs)}
            if len(g) != len(w) or img["unmatched"] or not len(g):
                failures.append(f"{mode}: detections differ ({img})")
            elif pairs:
                i, j = map(list, zip(*pairs))
                gm, wm = np.asarray(g.masks)[i], np.asarray(w.masks)[j]
                img.update(mask_pixels=int(gm.size), max_abs_err=float(np.abs(gm - wm).max()),
                           mean_abs_err=float(np.abs(gm - wm).mean()), pixels_differing=int((gm != wm).sum()),
                           mean=float(gm.mean()))
                if mode in MASK_TOL:
                    if img["pixels_differing"] > MASK_TOL[mode] * gm.size:
                        failures.append(f"{mode}: {img['pixels_differing']} of {gm.size} mask pixels differ")
                elif img["max_abs_err"] > SOFT_MASK_TOL:
                    failures.append(f"{mode}: masks differ by {img['max_abs_err']}")
                if mode == "exact":  # the host assembles masks only for images with detections
                    pg, cg = hosted["cuda"][sum(1 for r in got[:k] if len(r))]
                    pw, cw = hosted["cpu"][sum(1 for r in want[:k] if len(r))]
                    lg = pg.reshape(-1, pg.shape[-1]) @ cg[i].T  # (Hm*Wm, pairs)
                    lw = pw.reshape(-1, pw.shape[-1]) @ cw[j].T
                    scale = (np.abs(pw.reshape(-1, pw.shape[-1])) @ np.abs(cw[j]).T).max(axis=0)  # per instance
                    ratio = np.abs(lg - lw) / np.maximum(scale, 1e-30)
                    img.update(logit_max_abs_err=float(np.abs(lg - lw).max()), logit_abs_max=float(np.abs(lw).max()),
                               logit_scale_min=float(scale.min()), logit_scale_max=float(scale.max()),
                               logit_err_share_max=float(ratio.max()), logit_err_share_mean=float(ratio.mean()))
                    if img["logit_err_share_max"] > MASK_LOGIT_RTOL:
                        failures.append(f"exact: mask logits differ by {img['logit_err_share_max']} of their "
                                        f"products' size")
            res["images"].append(img)
        out["modes"][mode] = res
        if mode == "auto":
            cuda_auto = got
    half = Predictor(model, spec, device="cuda", compute_dtype=torch.float32, mask_mode="device_half")
    torch.backends.cudnn.deterministic = True
    try:
        want = half.predict(frames, conf=0.25, iou=0.45, imgsz=640)
    finally:
        torch.backends.cudnn.deterministic = False
    same = not same_results(cuda_auto, want, 0.0, 0.0) and all(
        np.array_equal(a.masks.numpy(np.uint8), b.masks.numpy(np.uint8)) for a, b in zip(cuda_auto, want) if len(a))
    out["auto_equals_device_half"] = same
    if not same:
        failures.append("auto at 640 px differs from device_half")
    if failures:
        emit(out)
        raise AssertionError("; ".join(failures))
    return out


def phase_bench(report):
    """The speed benchmark on the card: `YOLO11Model.benchmark` (the JAX
    package's keys), `SpeedBenchmark.benchmark_throughput` with its resource
    samples, and `benchmark_quantization` with PTQ static8."""
    import torch

    from yolo_infer_tpu_torch.benchmarks.speed_benchmark import SpeedBenchmark
    from yolo_infer_tpu_torch.core.model import YOLO11Model

    keys = {"imgsz", "batch", "runs", "avg_time_s", "std_time_s", "window_avgs_ms", "min_time_s", "max_time_s",
            "latency_s", "latency_std_s", "fps", "throughput_imgs_per_s", "compile_time_s"}
    out = {"phase": "bench", "card": report["card"]}
    r = YOLO11Model("yolo11n").benchmark(imgsz=640, batch=32, runs=20, warmup=3)
    out["benchmark"] = r
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_bench_"))
    try:
        bench = SpeedBenchmark(output_dir=root, warmup_runs=3, benchmark_runs=20)
        thr = bench.benchmark_throughput("n", imgsz=640, batch=32, duration_s=5)
        quant = bench.benchmark_quantization("n", imgsz=640, batch=8, methods=("ptq",))
        report_text = bench.generate_report()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out["throughput"] = thr
    out["quantization"] = {k: {kk: v.get(kk) for kk in ("avg_time_s", "fps", "speedup", "error")}
                           for k, v in quant.items()}
    out["report_lines"] = len(report_text.splitlines())
    failures = []
    if not keys <= set(r) or r["device"] != torch.cuda.get_device_name(0) or not r["fps"] > 0:
        failures.append(f"benchmark keys {sorted(set(r))}")
    res = thr["resources"]
    if not (res.get("samples", 0) >= 3 and res.get("max_device_mem_used_gb", 0) > 0):
        failures.append(f"resource samples without device memory: {res}")
    if "speedup" not in quant.get("ptq", {}):
        failures.append(f"ptq: {quant.get('ptq')}")
    if failures:
        emit(out)
        raise AssertionError("; ".join(failures))
    return out


# the serving artifacts (core/exported.py): conf/iou pairs one capture serves
EXPORT_PAIRS = ((0.25, 0.45), (0.10, 0.60))
EXPORT_SERVE = (32, 640)  # the exported detect artifact: batch, imgsz
# the other artifacts, at smaller batches so the run keeps its time; static8
# at the static8 path's b32/640, where its 48 convs run int8 (the C = 64 convs
# quantize only from 400k input rows, `nn/quantize.py int8_c64_min_rows`)
EXPORT_TASKS = (("segment", 8, 640), ("obb", 4, 1024), ("multi_label", 8, 640), ("static8", 32, 640),
                ("pallas", 8, 640))
# the artifact whose replay trace must show each kernel's functions (KERNEL_FUNCTIONS)
REPLAY_KERNELS = {k: (a, KERNEL_FUNCTIONS[k]) for k, a in (
    ("nms_keep", "detect"), ("attention_qkv", "detect"), ("rotated_nms_keep", "obb"),
    ("upsample4x_threshold_pack", "segment"), ("int8_conv", "static8"), ("dfl_decode", "multi_label"),
    ("greedy_nms_keep", "multi_label"), ("attention_packed", "pallas"))}
E_LAUNCHES = 48  # kernel E launches of one yolo11s static8 call at b32/640 (phase 17)


def dets_equal(a, b) -> bool:
    return a.keys() == b.keys() and all(torch_equal(a[k], b[k]) for k in a)


def torch_equal(x, y) -> bool:
    import torch

    return bool(torch.equal(x, y))


def clone_dets(d):
    return {k: v.clone() for k, v in d.items()}


def call_times(fn, calls: int = 20):
    """Per call of `fn`: the host ms until it returns (the launch work), the
    host-clock ms until the card is done (median of `calls`, each after a
    synchronise), the device ms by CUDA events over back-to-back calls, and
    the kernels' summed device ms (torch.profiler)."""
    import torch

    host, total = [], []
    for _ in range(calls):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        host.append(t1 - t0)
        total.append(time.perf_counter() - t0)
    return {"host_ms": 1e3 * float(np.median(host)), "ms_per_call": 1e3 * float(np.median(total)),
            "ms_per_call_min": 1e3 * min(total), "event_ms": cuda_ms(fn, iters=calls),
            "kernel_ms": device_ms(fn, iters=10)}


def replay_names(fn, need):
    """The kernel functions of a torch.profiler trace of 3 calls of `fn`
    whose names hold one of `need`, with their launches per call."""
    rows, _ = traced_rows(fn, 3, need=need)
    return {sub: sum(n for k, _, n in rows if sub in k) // 3 for sub in need}


def phase_exported(report):
    """The exported detect program (core/exported.py) at b32/640 bf16: export
    on the card, load, one CUDA-graph capture; the replay equal to the
    loaded program's eager run bit for bit, to the live predictor's eager
    body (`serve_program`, the yardstick) and to live `predict_raw` (a replay
    of the live predictor's own graph), at two conf/iou pairs from the one
    capture; b32 and b1 timed against both; the kernels of a replay by name."""
    import torch

    from yolo_infer_tpu_torch.core.exported import ExportedPredictor, export_predictor
    from yolo_infer_tpu_torch.core.model import YOLO11Model

    model, spec = report["weights"]
    batch, imgsz = EXPORT_SERVE
    ym = YOLO11Model.from_params(copy.deepcopy(model), task="detect", size="n", fused=False)  # bf16, cuda
    live = ym.predictor
    frames = torch.from_numpy(np.random.default_rng(SEED + 21).integers(0, 256, (batch, imgsz, imgsz, 3),
                                                                         dtype=np.uint8)).cuda()
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_export_"))
    out = {"phase": "exported", "card": report["card"], "batch": batch, "imgsz": imgsz}
    failures = []
    try:
        t0 = time.perf_counter()
        path = export_predictor(ym, root / "detect_b32.pt2", batch=batch, imgsz=imgsz)
        out["export_s"] = time.perf_counter() - t0
        out["artifact_mb"] = path.stat().st_size / 2 ** 20
        t0 = time.perf_counter()
        ep = ExportedPredictor.load(path)
        out["load_s"] = time.perf_counter() - t0
        live.predict_raw(frames, *EXPORT_PAIRS[0], imgsz)  # the live signature's capture
        # the loaded program run eagerly: its kernels launch through the wrappers
        reset_counters()
        ep.run_eager(frames, *EXPORT_PAIRS[0])
        torch.cuda.synchronize()
        out["eager_launches"] = read_counters()
        if out["eager_launches"]["nms_keep"] < 1 or out["eager_launches"]["attention_qkv"] < 1:
            failures.append(f"the loaded program did not launch A and B: {out['eager_launches']}")
        t0 = time.perf_counter()
        reset_counters()
        ep.predict_raw(frames, *EXPORT_PAIRS[0])  # warm-up on a side stream, capture, replay
        torch.cuda.synchronize()
        out["capture_s"] = time.perf_counter() - t0
        program = ep._program
        reset_counters()
        pairs = []
        for conf, iou in EXPORT_PAIRS:
            rep = ep.predict_raw(frames, conf, iou)
            lv = live.predict_raw(frames, conf, iou, imgsz)
            replays = read_counters()  # the counters tick on the eager runs below only
            eager = ep.run_eager(frames, conf, iou)
            body = eager_call(live, frames, imgsz, conf, iou)
            torch.cuda.synchronize()
            pairs.append({"conf": conf, "iou": iou, "detections": int(rep["num"].sum()),
                          "replay_equals_eager": dets_equal(rep, eager),
                          "replay_equals_live_eager": dets_equal(rep, body),
                          "replay_equals_live": dets_equal(rep, lv), "replays_launched": replays})
            if not pairs[-1]["replay_equals_eager"]:
                failures.append(f"replay differs from the eager program at {conf}, {iou}")
            if any(replays.values()):
                failures.append(f"a replay launched kernels from Python: {replays}")
            reset_counters()
        out["pairs"] = pairs
        # a replay's result outlives the next replay, on other frames
        first = ep.predict_raw(frames, 0.25, 0.45)
        kept = clone_dets(first)
        second = ep.predict_raw(frames.roll(1, 0), 0.25, 0.45)
        torch.cuda.synchronize()
        out["outlives_next_call"] = dets_equal(first, kept) and not dets_equal(first, second)
        if not out["outlives_next_call"]:
            failures.append("a result changed after the next call (or two frame batches gave one result)")
        out["one_capture"] = ep._program is program
        if pairs[0]["detections"] == pairs[1]["detections"]:
            failures.append("the two threshold pairs gave the same detections: a threshold is baked in")
        if not all(p["replay_equals_live"] and p["replay_equals_live_eager"] for p in pairs):
            out["fp32"] = exported_fp32_check(model, frames[:8], root)
            failures += out["fp32"]["failures"]
        out["b32"] = {"replay": call_times(lambda: ep.predict_raw(frames, 0.25, 0.45)),
                      "live": call_times(lambda: live.predict_raw(frames, 0.25, 0.45, imgsz)),
                      "eager": call_times(lambda: eager_call(live, frames, imgsz))}
        path1 = export_predictor(ym, root / "detect_b1.pt2", batch=1, imgsz=imgsz)
        ep1 = ExportedPredictor.load(path1)
        one = frames[:1].contiguous()
        rep1 = ep1.predict_raw(one, 0.25, 0.45)
        out["b1_replay_equals_eager"] = dets_equal(rep1, ep1.run_eager(one, 0.25, 0.45))
        if not out["b1_replay_equals_eager"]:
            failures.append("b1: replay differs from the eager program")
        out["b1"] = {"replay": call_times(lambda: ep1.predict_raw(one, 0.25, 0.45)),
                     "live": call_times(lambda: live.predict_raw(one, 0.25, 0.45, imgsz)),
                     "eager": call_times(lambda: eager_call(live, one, imgsz))}
        for key in ("b32", "b1"):
            r, lv, eg = out[key]["replay"], out[key]["live"], out[key]["eager"]
            out[key]["replay_vs_eager_ms_per_call"] = eg["ms_per_call"] / r["ms_per_call"]
            out[key]["live_vs_eager_ms_per_call"] = eg["ms_per_call"] / lv["ms_per_call"]
            out[key]["host_ms_saved"] = eg["host_ms"] - r["host_ms"]
        need = sum((REPLAY_KERNELS[k][1] for k in ("nms_keep", "attention_qkv")), ())
        report.setdefault("replay_kernels", {})["detect"] = replay_names(lambda: ep.predict_raw(frames, 0.25, 0.45),
                                                                          need)
        out["replay_kernels"] = report["replay_kernels"]["detect"]
        results = ep.predict(list(frames[:4].cpu().numpy()), conf=0.25)
        out["predict_detections"] = [len(r) for r in results]
        if not all(np.isfinite(r.boxes).all() and len(r) <= 300 for r in results):
            failures.append("exported predict gave non-finite or oversized detections")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    if failures:
        emit(out)
        raise AssertionError("; ".join(failures))
    return out


def exported_fp32_check(model, frames, root: Path):
    """An f32 artifact against f32 live `predict_raw` (TF32 off), held to
    phase 4's tolerances: the bf16 replay did not equal live bit for bit,
    so the two differ in how they lay out some tensor; this shows by how much."""
    import torch

    from yolo_infer_tpu_torch.core.exported import ExportedPredictor, export_predictor
    from yolo_infer_tpu_torch.core.model import YOLO11Model

    ym = YOLO11Model.from_params(copy.deepcopy(model), task="detect", size="n", fused=False,
                                 compute_dtype=torch.float32)
    ep = ExportedPredictor.load(export_predictor(ym, root / "detect_f32.pt2", batch=frames.shape[0], imgsz=640))
    res = {"failures": [], "pairs": []}
    for conf, iou in EXPORT_PAIRS:
        rep = ep.predict_raw(frames, conf, iou)
        lv = ym.predictor.predict_raw(frames, conf, iou, 640)
        v = lv["valid"]
        row = {"bit_equal": dets_equal(rep, lv), "num_equal": torch_equal(rep["num"], lv["num"]),
               "classes_equal": torch_equal(rep["classes"], lv["classes"]),
               "box_err": float((rep["boxes"] - lv["boxes"])[v].abs().max()) if v.any() else 0.0,
               "score_err": float((rep["scores"] - lv["scores"])[v].abs().max()) if v.any() else 0.0}
        res["pairs"].append(row)
        if not (row["num_equal"] and row["classes_equal"] and row["box_err"] <= 1e-2 and row["score_err"] <= 1e-5):
            res["failures"].append(f"f32 replay vs live beyond phase 4's tolerances at {conf}, {iou}: {row}")
    return res


def export_artifact_model(report, name: str, imgsz: int):
    """The YOLO11Model an artifact of phase 25 exports, on the card in bf16
    (static8: yolo11s PTQ-calibrated at `imgsz`)."""
    from yolo_infer_tpu_torch.core.model import YOLO11Model
    from yolo_infer_tpu_torch.optimization.quantization.quantizers import create_quantizer

    if name in ("segment", "obb"):
        model, spec = report["task_weights"][name]
        return YOLO11Model.from_params(copy.deepcopy(model), task=name, size="n", nc=spec.nc, fused=False)
    if name == "static8":
        model, _ = report["q8_weights"]
        base = YOLO11Model.from_params(copy.deepcopy(model), task="detect", size="s", fused=False)
        rng = np.random.default_rng(SEED + 14)
        ptq = create_quantizer("ptq", base, {"imgsz": imgsz})
        ptq.set_calibration_data([rng.integers(0, 256, (8, imgsz, imgsz, 3), dtype=np.uint8) for _ in range(2)])
        return ptq.optimize()
    model, _ = report["weights"]
    return YOLO11Model.from_params(copy.deepcopy(model), task="detect", size="n", fused=False)


def phase_exported_tasks(report):
    """The other artifacts: segment (A, B, D), OBB (B, C, F), multi_label
    detect (F, G), static8 yolo11s (E) and the pallas attention route (H),
    each exported on the card, loaded and captured: the replay equal to the
    loaded program's eager run bit for bit, the eager run's launch counts,
    and its kernels by name in a replay trace. Segment's `LazyMasks` hold a
    copy, so masks read after a later call are the earlier call's."""
    import torch

    from yolo_infer_tpu_torch.core.exported import ExportedPredictor, export_predictor

    root = Path(tempfile.mkdtemp(prefix="chip_smoke_export_"))
    out = {"phase": "exported_tasks", "artifacts": {}}
    failures = []
    try:
        for name, batch, imgsz in EXPORT_TASKS:
            ym = export_artifact_model(report, name, imgsz)
            frames = torch.from_numpy(np.random.default_rng(SEED + 22).integers(
                0, 256, (batch, imgsz, imgsz, 3), dtype=np.uint8)).cuda()
            row = {"batch": batch, "imgsz": imgsz}
            if name == "pallas":
                os.environ["YOLO_ATTN_IMPL"] = "pallas"  # read when the attention is traced
            try:
                t0 = time.perf_counter()
                path = export_predictor(ym, root / f"{name}.pt2", batch=batch, imgsz=imgsz,
                                        multi_label=name == "multi_label")
                row["export_s"] = time.perf_counter() - t0
            finally:
                os.environ.pop("YOLO_ATTN_IMPL", None)
            ep = ExportedPredictor.load(path)
            reset_counters()
            eager = ep.run_eager(frames, 0.25, 0.45)
            torch.cuda.synchronize()
            row["eager_launches"] = {k: v for k, v in read_counters().items() if v}
            rep = ep.predict_raw(frames, 0.25, 0.45)
            torch.cuda.synchronize()
            row["replay_equals_eager"] = dets_equal(rep, eager)
            row["detections"] = int(rep["num"].sum()) if "num" in rep else None
            need = sum((subs for k, (art, subs) in REPLAY_KERNELS.items() if art == name), ())
            row["replay_kernels"] = replay_names(lambda: ep.predict_raw(frames, 0.25, 0.45), need)
            report.setdefault("replay_kernels", {})[name] = row["replay_kernels"]
            if not row["replay_equals_eager"]:
                failures.append(f"{name}: replay differs from the eager program")
            want = [k for k, (art, _) in REPLAY_KERNELS.items() if art == name]
            if any(row["eager_launches"].get(k, 0) < 1 for k in want):
                failures.append(f"{name}: the eager program did not launch {want}: {row['eager_launches']}")
            if name == "static8":
                per_call = row["replay_kernels"]["int8_conv_kernel"]
                if row["eager_launches"].get("int8_conv") != E_LAUNCHES or per_call != E_LAUNCHES:
                    failures.append(f"static8: {row['eager_launches'].get('int8_conv')} E launches eager and "
                                    f"{per_call} per replay, not {E_LAUNCHES}")
            if name == "pallas" and row["eager_launches"].get("attention_qkv"):
                failures.append("pallas: kernel B ran on the pallas route")
            if name == "segment":
                host = frames[:2].cpu().numpy()
                first = ep.predict(list(host), conf=0.25)
                ep.predict(list(host[::-1]), conf=0.25)  # overwrites the graph's outputs
                again = ep.predict(list(host), conf=0.25)
                row["masks_survive_next_call"] = all(
                    np.array_equal(a.masks.numpy(np.uint8), b.masks.numpy(np.uint8)) for a, b in zip(first, again)
                    if len(a))
                if not row["masks_survive_next_call"] or not any(len(r) for r in first):
                    failures.append("segment: LazyMasks changed after a later call (or no detections)")
            out["artifacts"][name] = row
            del ep
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    seen = report.get("replay_kernels", {})
    out["replay_kernels"] = {k: {sub: seen.get(art, {}).get(sub, 0) for sub in subs}
                             for k, (art, subs) in REPLAY_KERNELS.items()}
    missing = [k for k, subs in out["replay_kernels"].items() if min(subs.values()) < 1]
    if missing:
        failures.append(f"kernels absent from every replay trace: {missing}")
    if failures:
        emit(out)
        raise AssertionError("; ".join(failures))
    return out


# the live predictor's program cache: each path's signature captured into a
# CUDA graph on its first call; (name, weights, batch, imgsz, predict_raw
# keywords), grouped by the predictor that serves them
LIVE_PATHS = (("detect b32", "detect", 32, 640, {}), ("detect b1", "detect", 1, 640, {}),
              ("multi_label b16", "detect", 16, 640, {"multi_label": True, "pre_topk": 4096}),
              ("segment b32 device", "segment", 32, 640, {}),
              ("segment b8 q8", "segment", 8, 640, {"mask_out": "q8"}),
              ("segment b8 bits", "segment", 8, 640, {"mask_out": "bits"}),
              ("segment b8 exact", "segment", 8, 640, {"mask_out": "exact"}),
              ("pose b16", "pose", 16, 640, {}), ("obb b16", "obb", 16, 1024, {}),
              ("obb val b16", "obb", 16, 1024, {"multi_label": True, "pre_topk": 4096}),
              ("classify b32", "classify", 32, 224, {}), ("static8 b32", "static8", 32, 640, {}),
              ("pallas b32", "pallas", 32, 640, {}))
LIVE_TIMED = ("detect b32", "detect b1", "static8 b32")  # captured against eager, by `call_times`
# the live replay whose trace shows each kernel's functions (KERNEL_FUNCTIONS)
LIVE_KERNELS = {k: (path, KERNEL_FUNCTIONS[k]) for k, path in (
    ("nms_keep", "detect b32"), ("attention_qkv", "detect b32"), ("rotated_nms_keep", "obb b16"),
    ("upsample4x_threshold_pack", "segment b32 device"), ("int8_conv", "static8 b32"),
    ("dfl_decode", "multi_label b16"), ("greedy_nms_keep", "multi_label b16"), ("attention_packed", "pallas b32"))}


def live_predictor(report, weights: str):
    """The bf16 predictor on the card that serves one group of LIVE_PATHS."""
    import torch

    from yolo_infer_tpu_torch.core.predictor import Predictor

    if weights == "static8":
        return export_artifact_model(report, "static8", 640).predictor
    model, spec = report["weights"] if weights in ("detect", "pallas") else report["task_weights"][weights]
    return Predictor(model, spec, device="cuda", compute_dtype=torch.bfloat16,
                     attn_impl="pallas" if weights == "pallas" else "auto")


def dets_diff(a, b):
    """{key: largest |a - b|} of the keys where two dets dicts differ."""
    return {k: float((a[k].double() - b[k].double()).abs().max()) for k in a
            if k in b and not torch_equal(a[k], b[k])}


def live_path(pred, name: str, batch: int, imgsz: int, kw, failures):
    """One signature of the live cache: its first call captures (the
    launches counted: each kernel once per warm-up call and once into the
    graph, as the eager body launches it); replays at two conf/iou pairs
    from the one capture equal the eager body bit for bit and launch nothing
    from Python; a result outlives the next call on other frames."""
    import torch

    from yolo_infer_tpu_torch.core.graphs import WARMUP_CALLS

    rng = np.random.default_rng(SEED + 24)
    frames = [torch.from_numpy(rng.integers(0, 256, (batch, imgsz, imgsz, 3), dtype=np.uint8)).cuda() for _ in range(2)]
    row = {"batch": batch, "imgsz": imgsz, **kw}
    keys = set(pred._cache)
    torch.cuda.synchronize()
    reserved = torch.cuda.memory_reserved()
    reset_counters()
    t0 = time.perf_counter()
    pred.predict_raw(frames[0], *EXPORT_PAIRS[0], imgsz, **kw)
    torch.cuda.synchronize()
    row["first_call_s"] = time.perf_counter() - t0
    captured = read_counters()
    new = [k for k in pred._cache if k not in keys]
    if len(new) != 1:
        failures.append(f"{name}: the first call made {len(new)} cache entries")
        return row, frames
    row["capture_s"] = pred._cache[new[0]].capture_s
    row["reserved_gb"] = torch.cuda.memory_reserved() / 1e9
    row["reserved_added_gb"] = (torch.cuda.memory_reserved() - reserved) / 1e9
    reset_counters()
    eager_call(pred, frames[0], imgsz, *EXPORT_PAIRS[0], **kw)
    torch.cuda.synchronize()
    eager = read_counters()
    row["eager_launches"] = {k: v for k, v in eager.items() if v}
    row["capture_launches"] = {k: v for k, v in captured.items() if v}
    if not row["eager_launches"] or captured != {k: (1 + WARMUP_CALLS) * v for k, v in eager.items()}:
        failures.append(f"{name}: the capture launched {row['capture_launches']}, the eager body "
                        f"{row['eager_launches']} (warm-up calls {WARMUP_CALLS})")
    row["pairs"] = []
    reps = []
    for conf, iou in EXPORT_PAIRS:
        reset_counters()
        rep = pred.predict_raw(frames[0], conf, iou, imgsz, **kw)
        replays = read_counters()
        body = eager_call(pred, frames[0], imgsz, conf, iou, **kw)
        torch.cuda.synchronize()
        diff = dets_diff(rep, body)
        row["pairs"].append({"conf": conf, "iou": iou, "equal": not diff and rep.keys() == body.keys(),
                             "differing": diff, "python_launches": sum(replays.values()),
                             "detections": int(rep["num"].sum()) if "num" in rep else None})
        reps.append(rep)
        if diff or rep.keys() != body.keys() or any(replays.values()):
            failures.append(f"{name}: replay at {conf}, {iou} differs from the eager body {diff} or launched "
                            f"from Python {replays}")
    if "probs" not in reps[0] and dets_equal(*reps):
        failures.append(f"{name}: the two threshold pairs gave the same detections: a threshold is baked in")
    first = pred.predict_raw(frames[0], *EXPORT_PAIRS[0], imgsz, **kw)
    kept = clone_dets(first)
    second = pred.predict_raw(frames[1], *EXPORT_PAIRS[0], imgsz, **kw)
    torch.cuda.synchronize()
    row["outlives_next_call"] = dets_equal(first, kept) and not dets_equal(first, second)
    if not row["outlives_next_call"]:
        failures.append(f"{name}: a result changed after the next call (or two frame batches gave one result)")
    return row, frames


def bounded_cache(report):
    """A detect predictor served b1 frames of 3 * PROGRAM_CACHE_SIZE distinct
    sizes at 640 px (one signature each): the cache keeps PROGRAM_CACHE_SIZE
    programs, and the reserved device memory stays within one program's
    share of what the full cache reserved (`full + (full - base) /
    PROGRAM_CACHE_SIZE`); `release_programs` gives it back down to the same
    share above `base`."""
    import gc

    import torch

    from yolo_infer_tpu_torch.core.predictor import PROGRAM_CACHE_SIZE

    pred = live_predictor(report, "detect")
    rng = np.random.default_rng(SEED + 27)
    frame = rng.integers(0, 256, (480 + 8 * 3 * PROGRAM_CACHE_SIZE, 640, 3), dtype=np.uint8)
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_reserved()
    reserved, failures = [], []
    for i in range(3 * PROGRAM_CACHE_SIZE):
        pred.predict(frame[: 480 + 8 * i], conf=0.25)
        torch.cuda.synchronize()
        reserved.append(torch.cuda.memory_reserved())
    full = reserved[PROGRAM_CACHE_SIZE - 1]
    ceiling = full + (full - base) / PROGRAM_CACHE_SIZE
    entries = len(pred._cache)
    pred.release_programs()
    released = torch.cuda.memory_reserved()
    out = {"cache_size": PROGRAM_CACHE_SIZE, "signatures": 3 * PROGRAM_CACHE_SIZE, "entries": entries,
           "base_gb": base / 1e9, "full_gb": full / 1e9, "ceiling_gb": ceiling / 1e9,
           "max_after_full_gb": max(reserved[PROGRAM_CACHE_SIZE:]) / 1e9, "released_gb": released / 1e9,
           "reserved_gb": [r / 1e9 for r in reserved], "failures": failures}
    if entries != PROGRAM_CACHE_SIZE:
        failures.append(f"{entries} programs cached, not {PROGRAM_CACHE_SIZE}")
    if max(reserved[PROGRAM_CACHE_SIZE:]) > ceiling:
        failures.append(f"reserved memory grew past {ceiling / 1e9} GB with the cache full: {out['reserved_gb']}")
    if released > base + (full - base) / PROGRAM_CACHE_SIZE:
        failures.append(f"release_programs left {released / 1e9} GB reserved (base {base / 1e9})")
    del pred
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_live_graphs(report):
    """The live predictor's program cache on the card (`core/graphs.py`,
    `Predictor._get`): every path of LIVE_PATHS captured by its first
    `predict_raw` and held to the eager body (`serve_program`) bit for bit
    at two conf/iou pairs from the one capture; results outlive the next
    call; `predict_many` over 150 frames equals `predict` on the same chunks
    through one cache entry; A-H by function name in live replay traces;
    captured against eager timed at detect b32 and b1 and static8 b32;
    capture seconds and reserved device memory; the cache's bound."""
    import gc

    import torch

    from yolo_infer_tpu_torch.core.graphs import WARMUP_CALLS

    out = {"phase": "live_graphs", "card": report["card"], "warmup_calls": WARMUP_CALLS, "paths": {}, "times": {},
           "replay_kernels": {}}
    failures = []
    reserved_max = 0
    for weights in dict.fromkeys(w for _, w, _, _, _ in LIVE_PATHS):
        pred = live_predictor(report, weights)
        for name, w, batch, imgsz, kw in LIVE_PATHS:
            if w != weights:
                continue
            row, frames = live_path(pred, name, batch, imgsz, kw, failures)
            out["paths"][name] = row
            reserved_max = max(reserved_max, torch.cuda.memory_reserved())
            need = sum((subs for k, (path, subs) in LIVE_KERNELS.items() if path == name), ())
            if need:
                out["replay_kernels"][name] = replay_names(
                    lambda: pred.predict_raw(frames[0], *EXPORT_PAIRS[0], imgsz, **kw), need)
            if name in LIVE_TIMED:
                t = {"captured": call_times(lambda: pred.predict_raw(frames[0], *EXPORT_PAIRS[0], imgsz, **kw)),
                     "eager": call_times(lambda: eager_call(pred, frames[0], imgsz, *EXPORT_PAIRS[0], **kw))}
                t["eager_vs_captured_ms_per_call"] = t["eager"]["ms_per_call"] / t["captured"]["ms_per_call"]
                out["times"][name] = t
            del frames
        if weights == "detect":  # predict_many at b32 over 150 frames: the b32 entry serves every chunk
            rng = np.random.default_rng(SEED + 25)
            many_frames = list(rng.integers(0, 256, (MANY_FRAMES, 640, 640, 3), dtype=np.uint8))
            entries = len(pred._cache)
            got = pred.predict_many(many_frames, conf=0.25, batch_size=32)
            want = [r for c in padded_chunks(many_frames, 32) for r in pred.predict(c, conf=0.25)][:MANY_FRAMES]
            bad = same_results(got, want, 0.0, 0.0)
            b32 = [k for k in pred._cache if k[0] == 32]
            out["predict_many"] = {"frames": MANY_FRAMES, "differences": bad[:5], "cache_entries_b32": len(b32),
                                   "entries_added": len(pred._cache) - entries}
            if bad or len(b32) != 1 or len(pred._cache) != entries:
                failures.append(f"predict_many: {bad[:3]}, {len(b32)} b32 entries, "
                                f"{len(pred._cache) - entries} added")
        del pred
        gc.collect()
        torch.cuda.empty_cache()
    out["reserved_gb_max"] = reserved_max / 1e9

    out["bounded_cache"] = bounded_cache(report)
    if out["bounded_cache"]["failures"]:
        failures += out["bounded_cache"]["failures"]

    seen = {k: {sub: out["replay_kernels"].get(path, {}).get(sub, 0) for sub in subs}
            for k, (path, subs) in LIVE_KERNELS.items()}
    out["launches_per_live_replay"] = {k: {"path": LIVE_KERNELS[k][0], "launches": v[LIVE_KERNELS[k][1][0]]}
                                       for k, v in seen.items()}
    missing = [k for k, subs in seen.items() if min(subs.values()) < 1]
    if missing:
        failures.append(f"kernels absent from every live replay trace: {missing}")
    # each kernel as often per replay as the path's eager body launches it
    unequal = {k: (r["launches"], out["paths"].get(r["path"], {}).get("eager_launches", {}).get(k))
               for k, r in out["launches_per_live_replay"].items()}
    unequal = {k: v for k, v in unequal.items() if v[0] != v[1]}
    if unequal:
        failures.append(f"launches per replay against the eager body's, by kernel: {unequal}")
    if seen["int8_conv"]["int8_conv_kernel"] != Q8_E_LAUNCHES:
        failures.append(f"static8: {seen['int8_conv']['int8_conv_kernel']} E launches per replay, not {Q8_E_LAUNCHES}")
    out["predict_img_per_s"] = report.get("predict_img_per_s")  # phase 5, detect b32/640
    out["predict_many_img_per_s"] = report.get("many_img_per_s")  # phase 21, 150 frames at b32
    if failures:
        emit(out)
        raise AssertionError("; ".join(failures))
    return out


def phase_checkpoints(report):
    """Native checkpoints on the card: a JAX-format `.msgpack` written by the
    port's writer from seeded weights, fused bf16 and unfused f32, served
    on cuda equal to the same file served on the cpu (f32 compute, TF32
    off) within phase 4's tolerances; `save` -> `load` to identical state;
    a safetensors export read back equal."""
    import torch

    from yolo_infer_tpu_torch.core.model import YOLO11Model
    from yolo_infer_tpu_torch.models.convert import params_to_jax
    from yolo_infer_tpu_torch.utils.safetensors import load_file

    model, _ = report["weights"]
    rng = np.random.default_rng(SEED + 23)
    frames = [rng.integers(0, 256, (480, 640, 3), dtype=np.uint8), rng.integers(0, 256, (360, 500, 3), dtype=np.uint8)]
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_ckpt_"))
    out = {"phase": "checkpoints", "files": {}}
    failures = []
    try:
        for name, dtype, fused in (("fused_bf16", torch.bfloat16, True), ("unfused_f32", torch.float32, False)):
            src = YOLO11Model.from_params(copy.deepcopy(model), task="detect", size="n", fused=False,
                                          compute_dtype=dtype, device="cpu")
            path = src.save(root / f"{name}.msgpack", fused=fused)
            on_gpu = YOLO11Model(path, compute_dtype=torch.float32)
            on_cpu = YOLO11Model(path, compute_dtype=torch.float32, device="cpu")
            torch.backends.cudnn.deterministic = True
            try:
                reset_counters()
                got = on_gpu.predict(frames, conf=0.25, imgsz=640)
                launches = read_counters()
            finally:
                torch.backends.cudnn.deterministic = False
            want = on_cpu.predict(frames, conf=0.25, imgsz=640)
            row = {"bytes": path.stat().st_size, "launches": {k: v for k, v in launches.items() if v}, "images": []}
            for g, w in zip(got, want):
                img = {"num_cuda": len(g), "num_cpu": len(w), "unmatched": match_detections(g, w, 1e-2, 1e-5)[0],
                       "classes_equal": bool(np.array_equal(np.sort(g.classes), np.sort(w.classes)))}
                row["images"].append(img)
                if img["num_cuda"] != img["num_cpu"] or img["unmatched"] or not img["classes_equal"]:
                    failures.append(f"{name}: cuda differs from cpu ({img})")
            if not sum(len(r) for r in got) or launches["nms_keep"] < 1:
                failures.append(f"{name}: no detections or no kernel A launch")
            # save -> load: the same state
            again = YOLO11Model("yolo11n", compute_dtype=dtype).load(on_gpu.save(root / f"{name}_again.msgpack"))
            a, b = on_gpu.model.state_dict(), again.model.state_dict()
            row["save_load_identical"] = a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
            if not row["save_load_identical"]:
                failures.append(f"{name}: save -> load changed the state")
            out["files"][name] = row
        # safetensors: every deploy weight read back equal, under the JAX package's flat names
        src = YOLO11Model.from_params(copy.deepcopy(model), task="detect", size="n", fused=False, device="cpu")
        st = src.export(root / "deploy.safetensors", format="safetensors")
        tensors, meta = load_file(st)
        want = {}

        def flatten(tree, prefix):
            if isinstance(tree, dict):
                for k, v in tree.items():
                    flatten(v, f"{prefix}.{k}" if prefix else k)
            elif isinstance(tree, list):
                for i, v in enumerate(tree):
                    flatten(v, f"{prefix}.{i}")
            else:
                want[prefix] = tree.float().numpy() if torch.is_tensor(tree) else np.asarray(tree, np.float32)

        flatten(params_to_jax(src.deploy_model, src.spec, fused=True)[0], "")
        out["safetensors"] = {"tensors": len(tensors), "meta": meta, "bytes": st.stat().st_size,
                              "equal": tensors.keys() == want.keys()
                              and all(np.array_equal(tensors[k], want[k]) for k in want)}
        if not out["safetensors"]["equal"] or meta.get("task") != "detect":
            failures.append(f"safetensors export does not read back: {out['safetensors']}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    if failures:
        emit(out)
        raise AssertionError("; ".join(failures))
    return out


CLI_DIR_FRAMES = 8  # JPEGs of the directory demo
CLI_VAL_FRAMES = 32  # JPEG frames of the CLI's detect validation set
CLI_KERNELS = ("nms_keep", "attention_qkv", "int8_conv", "dfl_decode", "greedy_nms_keep")  # A, B, E, F, G


def run_cli(*argv):
    """`YOLO11CLI().run(argv)` in this process: (exit code, its stdout parsed
    as JSON where it is, host seconds, the kernel launches of the run, the
    CLI's error log)."""
    import contextlib
    import io
    import logging

    import torch

    from yolo_infer_tpu_torch.cli import YOLO11CLI

    records = []

    class Keep(logging.Handler):
        def emit(self, record):
            records.append(record.getMessage())

    cli_log = logging.getLogger("yolo_infer_tpu_torch.cli")
    keep = Keep(level=logging.ERROR)
    cli_log.addHandler(keep)
    buf = io.StringIO()
    reset_counters()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            rc = YOLO11CLI().run([str(a) for a in argv])
        torch.cuda.synchronize()
    finally:
        cli_log.removeHandler(keep)
    seconds = time.perf_counter() - t0
    text = buf.getvalue()
    try:
        parsed = json.loads(text)
    except ValueError:
        parsed = text
    return rc, parsed, seconds, {k: v for k, v in read_counters().items() if v}, records


def _dets(d):
    """A demo dict's detections as `match_detections` reads them."""
    return _Dets(boxes=np.asarray(d["boxes"], np.float64).reshape(-1, 4),
                 scores=np.asarray(d["confidences"], np.float64), classes=np.asarray(d["classes"]))


def phase_cli(report):
    """The command line on the card, in process (`cli.YOLO11CLI().run`):
    the JPEG decoder against the committed manifest (tests/torch_jpeg/),
    the encoder against OpenCV's bytes of the same seeded frames, then
    info, demo, val, optimize, benchmark and the error exits (see the
    module docstring, phase 28)."""
    import hashlib
    from statistics import median

    import torch

    from yolo_infer_tpu_torch.core.model import YOLO11Model
    from yolo_infer_tpu_torch.core.validator import YOLO11Validator
    from yolo_infer_tpu_torch.data.jpeg import decode_jpeg, encode_jpeg
    from yolo_infer_tpu_torch.data.loader import create_dataset_config, load_image, save_image

    here = Path(__file__).resolve().parent
    out = {"phase": "cli", "card": card_line()}
    failures = []
    # --- the decoder: every fixture and the sample, to OpenCV's pixel hashes
    manifest = json.loads((here / "tests" / "torch_jpeg" / "manifest.json").read_text())
    mismatched = []
    for name, entry in manifest["files"].items():
        img = load_image(here / "tests" / "torch_jpeg" / name, rgb=False)
        if (list(img.shape) != entry["shape"]
                or hashlib.sha256(np.ascontiguousarray(img).tobytes()).hexdigest() != entry["sha256"]):
            mismatched.append(name)
    sample = (here / "assets" / "sample.jpg").read_bytes()
    decode_s = []
    for _ in range(5):
        t0 = time.perf_counter()
        decode_jpeg(sample)
        decode_s.append(time.perf_counter() - t0)
    out["decode"] = {"files": len(manifest["files"]), "mismatched": mismatched,
                     "sample_640x480_420_s": median(decode_s), "sample_s_each": decode_s}
    if mismatched:
        failures.append(f"the decoder's pixels differ from OpenCV's for {mismatched}")
    # --- the encoder: OpenCV's bytes for the seeded frames, and the PSNR of a round trip
    enc = {"bytes_equal_opencv": [], "psnr_db": [], "encode_s": [], "decode_s": []}
    for seed, digest in enumerate(manifest["encoder"]["sha256"]):
        frame = jpeg_frame(seed)
        t0 = time.perf_counter()
        data = encode_jpeg(frame)
        t1 = time.perf_counter()
        back = decode_jpeg(data)
        t2 = time.perf_counter()
        mse = float(np.mean((back.astype(np.float64) - frame) ** 2))
        enc["bytes_equal_opencv"].append(hashlib.sha256(data).hexdigest() == digest)
        enc["psnr_db"].append(10 * np.log10(255.0 ** 2 / max(mse, 1e-12)))
        enc["encode_s"].append(t1 - t0)
        enc["decode_s"].append(t2 - t1)
    out["encode"] = enc
    if not all(enc["bytes_equal_opencv"]) or min(enc["psnr_db"]) < 30:
        failures.append(f"the encoder's bytes differ from OpenCV's or its round trip is poor: {enc}")

    model = report["weights"][0] if "weights" in report else smoke_weights(
        np.random.default_rng(SEED + 2).integers(0, 256, (2, 480, 640, 3), dtype=np.uint8))[0]
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_cli_"))
    launches = collections.Counter()
    runs = {}

    def cli(name, *argv, want_rc=0):
        rc, parsed, seconds, counts, errors = run_cli(*argv)
        launches.update(counts)
        runs[name] = {"rc": rc, "seconds": seconds, "launches": counts}
        if rc != want_rc:
            failures.append(f"{name}: exit {rc}, expected {want_rc} ({errors[-1:] or parsed})")
        return parsed, errors

    try:
        ckpt = YOLO11Model.from_params(copy.deepcopy(model), task="detect", size="n", fused=False,
                                       device="cpu").save(root / "smoke.msgpack")
        f32 = root / "f32.yaml"
        f32.write_text("model:\n  compute_dtype: float32\n")
        info, _ = cli("info", "info")
        runs["info"]["card"] = info.get("nvidia_smi") if isinstance(info, dict) else None
        # --- demo: the sample in bf16, then the same checkpoint in f32 on cuda and on cpu
        one, _ = cli("demo", "demo", "--input", here / "assets" / "sample.jpg", "--output", root / "out.jpg",
                     "--model-path", ckpt)
        if isinstance(one, dict):
            runs["demo"].update(num_detections=one["num_detections"], inference_time_s=one["inference_time_s"],
                                annotated=list(load_image(root / "out.jpg").shape))
        torch.backends.cudnn.deterministic = True
        try:
            on_gpu, _ = cli("demo_f32_cuda", "--config", f32, "demo", "--input", here / "assets" / "sample.jpg",
                            "--model-path", ckpt, "--conf", "0.25")
        finally:
            torch.backends.cudnn.deterministic = False
        on_cpu, _ = cli("demo_f32_cpu", "--config", f32, "demo", "--input", here / "assets" / "sample.jpg",
                        "--model-path", ckpt, "--conf", "0.25", "--device", "cpu")
        if isinstance(on_gpu, dict) and isinstance(on_cpu, dict):
            g, w = _dets(on_gpu), _dets(on_cpu)
            unmatched = match_detections(g, w, 1e-2, 1e-5)[0] if len(g) == len(w) else None
            runs["demo_f32_cuda"].update(num_cuda=len(g), num_cpu=len(w), unmatched=unmatched)
            if not len(g) or unmatched != 0:
                failures.append(f"f32 demo: cuda differs from cpu ({runs['demo_f32_cuda']})")
        # --- demo on a directory of JPEGs the port's encoder wrote
        for i in range(CLI_DIR_FRAMES):
            save_image(root / "dir" / f"f{i}.jpg", jpeg_frame(100 + i))
        many, _ = cli("demo_dir", "demo", "--input", root / "dir", "--output", root / "dir_out", "--model-path", ckpt)
        if isinstance(many, dict):
            parts = {k: median(im["host_s"][k] for im in many["images"][1:]) for k in many["host_s"]}
            runs["demo_dir"].update(images=many["num_images"], host_s_per_image_median=parts,
                                    host_s_first_image=many["images"][0]["host_s"],
                                    written=len(list((root / "dir_out").iterdir())))
            if many["num_images"] != CLI_DIR_FRAMES or runs["demo_dir"]["written"] != CLI_DIR_FRAMES:
                failures.append(f"directory demo: {runs['demo_dir']}")
        # --- val: a detect set of seeded JPEG frames labelled with the model's own f32 detections
        # (uniform noise, as in phase 14: the smoke weights' batch norms were set on such frames,
        # and on structured ones their boxes degenerate)
        images = root / "val" / "images" / "val"
        labels = root / "val" / "labels" / "val"
        labels.mkdir(parents=True)
        rng = np.random.default_rng(SEED + 28)
        for i in range(CLI_VAL_FRAMES):
            save_image(images / f"f{i:02d}.jpg", rng.integers(0, 256, (480, 640, 3), dtype=np.uint8))
        frames = [load_image(images / f"f{i:02d}.jpg") for i in range(CLI_VAL_FRAMES)]
        torch.backends.cudnn.deterministic = True
        try:
            labelled = YOLO11Model(ckpt, compute_dtype=torch.float32).predict(frames, conf=0.25, imgsz=640)
        finally:
            torch.backends.cudnn.deterministic = False
        for i, r in enumerate(labelled):
            h, w = r.orig_shape
            rows = [f"{c} {(b[0] + b[2]) / 2 / w:.6f} {(b[1] + b[3]) / 2 / h:.6f} {(b[2] - b[0]) / w:.6f} "
                    f"{(b[3] - b[1]) / h:.6f}" for b, c in zip(r.boxes.clip(0, [w, h, w, h]), r.classes)]
            (labels / f"f{i:02d}.txt").write_text("\n".join(rows) + "\n")
        data = create_dataset_config(root / "val" / "data.yaml", str(images), str(images),
                                     {c: str(c) for c in range(80)})
        val, _ = cli("val", "val", "--data", data, "--batch", 16, "--model-path", ckpt, "--output-dir", root / "vout")
        direct = YOLO11Validator(model=YOLO11Model(ckpt), output_dir=root / "vdirect").validate(
            str(data), imgsz=640, batch=16, conf=0.001, iou=0.6, verbose=False)
        if isinstance(val, dict):
            runs["val"].update(metrics=val["metrics"], direct_metrics=direct["metrics"],
                               labels=sum(len(r) for r in labelled), images=val["num_images"],
                               images_per_s=val["speed"]["images_per_s"],
                               images_per_s_wall=CLI_VAL_FRAMES / runs["val"]["seconds"])
            if ({k: float(v) for k, v in val["metrics"].items()} != {k: float(v) for k, v in direct["metrics"].items()}
                    or val["num_images"] != CLI_VAL_FRAMES):
                failures.append(f"val through the CLI differs from YOLO11Validator.validate: {runs['val']}")
        # --- optimize --method ptq, then the demo on the static8 model (kernel E)
        q = root / "q.msgpack"
        cli("optimize", "optimize", "--method", "ptq", "--model-path", ckpt, "--calibration-batches", 8,
            "--output", q)
        q_one, _ = cli("demo_static8", "demo", "--input", here / "assets" / "sample.jpg", "--model-path", q,
                       "--output", root / "q.jpg")
        if isinstance(q_one, dict):
            runs["demo_static8"]["num_detections"] = q_one["num_detections"]
        # --- benchmark: model sizes at 640, batch 1 and 32
        cli("benchmark", "benchmark", "--type", "sizes", "--model-sizes", "n", "--image-sizes", 640,
            "--batch-sizes", 1, 32, "--runs", 20, "--output-dir", root / "bench")
        sizes = json.loads((root / "bench" / "model_sizes_benchmark.json").read_text())
        runs["benchmark"]["fps"] = {k: v.get("fps") for k, v in sizes.items()}
        # --- the exits that are not 0
        _, errors = cli("qat_without_data", "optimize", "--method", "qat", "--model-path", ckpt, want_rc=1)
        if not any("QAT needs a dataset" in e for e in errors):
            failures.append(f"optimize --method qat without data: no 'QAT needs a dataset' message ({errors})")
        cli("missing_input", "demo", "--input", root / "missing.jpg", "--model-path", ckpt, want_rc=2)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out["runs"] = runs
    out["launches"] = {k: launches[k] for k in CLI_KERNELS}
    if min(out["launches"].values()) < 1:
        failures.append(f"a kernel of A, B, E, F, G did not run through the CLI: {out['launches']}")
    if failures:
        emit(out)
        raise AssertionError("; ".join(failures))
    return out


TRAIN = dict(batch=16, imgsz=640, epochs=2)  # the CLI's training run: TrainingConfig's defaults otherwise
TRAIN_FRAMES = (96, 32)  # training and validation frames of the seeded rectangle dataset
TRAIN_NC = 3
TRAIN_COLOURS = ((230, 40, 40), (40, 200, 60), (40, 60, 230))  # one per class
TRAIN_CHECK = (2, 640)  # the fp32 cuda-vs-cpu step: batch, imgsz
TRAIN_LOSS_RTOL = 1e-4
TRAIN_UPDATE_RTOL = 1e-3  # |u_cuda - u_cpu| / |u_cpu| over the whole parameter update
TRAIN_BN_ATOL = 1e-4
OVERFIT_STEPS = 40
TRAIN_DEVICE = "cuda"  # the card (a CPU rehearsal of the phase sets "cpu")


def write_rect_dataset(root: Path, seed: int, frames=TRAIN_FRAMES) -> Path:
    """A detect dataset of coloured rectangles on gray, 640x480 PNGs with
    their exact boxes as labels (a later rectangle may cover part of an
    earlier one, whose box stays as drawn); `frames` (train, val)."""
    from yolo_infer_tpu_torch.data.loader import create_dataset_config, save_image

    rng = np.random.default_rng(seed)
    for split, n in zip(("train", "val"), frames):
        images, labels = root / "images" / split, root / "labels" / split
        labels.mkdir(parents=True)
        for i in range(n):
            img = np.full((480, 640, 3), int(rng.integers(70, 190)), np.uint8)
            rows = []
            for _ in range(int(rng.integers(1, 5))):
                c = int(rng.integers(0, TRAIN_NC))
                w, h = int(rng.integers(40, 240)), int(rng.integers(40, 200))
                x0, y0 = int(rng.integers(0, 640 - w)), int(rng.integers(0, 480 - h))
                img[y0:y0 + h, x0:x0 + w] = TRAIN_COLOURS[c]
                rows.append(f"{c} {(x0 + w / 2) / 640:.6f} {(y0 + h / 2) / 480:.6f} {w / 640:.6f} {h / 480:.6f}")
            save_image(images / f"{i:03d}.png", img)
            (labels / f"{i:03d}.txt").write_text("\n".join(rows) + "\n")
    return create_dataset_config(root / "data.yaml", str(root / "images" / "train"), str(root / "images" / "val"),
                                 {c: f"rect{c}" for c in range(TRAIN_NC)})


def train_fp32_check(data: Path, task: str = "detect", nc: int = TRAIN_NC):
    """One fp32 step of yolo11n `task` (`TRAIN_CHECK`) on the same weights
    and batch on cuda and on cpu."""
    import torch

    from yolo_infer_tpu_torch.core.train_step import init_train_state, make_optimizer, make_train_step
    from yolo_infer_tpu_torch.data.dataset import YOLODataset
    from yolo_infer_tpu_torch.data.train_loader import TrainLoader
    from yolo_infer_tpu_torch.models.yolo11 import build_model

    b, imgsz = TRAIN_CHECK
    batch = next(iter(TrainLoader(YOLODataset(data, split="train", task=task), batch_size=b, imgsz=imgsz,
                                  seed=SEED).epoch_batches(0)))
    model, spec = build_model(task, "n", nc, seed=SEED)
    tx = make_optimizer(0.01, total_steps=10, warmup_steps=0)
    step = make_train_step(spec, tx, compute_dtype=torch.float32)
    got = {}
    for dev in (TRAIN_DEVICE, "cpu"):
        ts = init_train_state(model, tx, seed=SEED, device=dev)
        before = ts.params.detach().cpu().clone()
        ts, m = step(ts, {k: torch.from_numpy(v).to(dev) for k, v in batch.items()})
        got[dev] = (float(m["loss"]), ts.params.detach().cpu() - before, ts.bn_state.detach().cpu(), int(ts.skipped))
    (lc, uc, bc, sc), (lp, up, bp, sp) = got[TRAIN_DEVICE], got["cpu"]
    return {"batch": b, "imgsz": imgsz, "loss_cuda": lc, "loss_cpu": lp, "loss_rel": abs(lc - lp) / abs(lp),
            "update_rel": float((uc - up).norm() / up.norm()), "update_norm_cpu": float(up.norm()),
            "params_max_abs": float((uc - up).abs().max()), "bn_max_abs": float((bc - bp).abs().max()),
            "skipped": [sc, sp]}


def mosaic_loader_pace(data: Path, batches: int = 3):
    """Host seconds per batch of the training loader with mosaic on (the
    default augmentation: a 2-epoch CLI run closes mosaic from its first
    epoch, `close_mosaic` being 10), b16/640, the trainer's worker threads."""
    from yolo_infer_tpu_torch.core.trainer import LOADER_WORKERS
    from yolo_infer_tpu_torch.data.dataset import YOLODataset
    from yolo_infer_tpu_torch.data.train_loader import TrainLoader

    loader = TrainLoader(YOLODataset(data, split="train"), batch_size=TRAIN["batch"], imgsz=TRAIN["imgsz"],
                         seed=SEED, workers=LOADER_WORKERS, prefetch=1)
    it = iter(loader.epoch_batches(0))
    seconds = []
    for _ in range(batches):
        t0 = time.perf_counter()
        next(it)
        seconds.append(time.perf_counter() - t0)
    it.close()
    return {"workers": LOADER_WORKERS, "seconds_per_batch": seconds,
            "images_per_s": TRAIN["batch"] * len(seconds[1:]) / sum(seconds[1:])}


def train_overfit(data: Path):
    """`OVERFIT_STEPS` bf16 steps on one fixed batch of 16 at 640 px (no
    augmentation, no warmup): losses, step ms (CUDA events), peak memory and
    one traced step."""
    import torch

    from yolo_infer_tpu_torch.core.train_step import init_train_state, make_optimizer, make_train_step
    from yolo_infer_tpu_torch.data.dataset import YOLODataset
    from yolo_infer_tpu_torch.data.train_loader import TrainLoader
    from yolo_infer_tpu_torch.models.yolo11 import build_model

    off = dict(hsv_h=0.0, hsv_s=0.0, hsv_v=0.0, degrees=0.0, translate=0.0, scale=0.0, shear=0.0, fliplr=0.0,
               flipud=0.0, mosaic=0.0, mixup=0.0)
    loader = TrainLoader(YOLODataset(data, split="train"), batch_size=TRAIN["batch"], imgsz=TRAIN["imgsz"],
                         hyp=off, seed=SEED)
    batch = {k: torch.from_numpy(v).to(TRAIN_DEVICE) for k, v in next(iter(loader.epoch_batches(0))).items()}
    model, spec = build_model("detect", "n", TRAIN_NC, seed=SEED)
    tx = make_optimizer(0.01, total_steps=OVERFIT_STEPS, warmup_steps=0)
    step = make_train_step(spec, tx)
    ts = init_train_state(model, tx, seed=SEED, device=TRAIN_DEVICE)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    marks, losses = [], []
    for _ in range(OVERFIT_STEPS):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        ts, m = step(ts, batch)
        end.record()
        marks.append((start, end))
        losses.append(m["loss"])
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    losses = [float(v) for v in losses]
    ms = [a.elapsed_time(b) for a, b in marks]
    prof = kernel_profile(lambda: step(ts, batch), calls=1)
    return {"losses": losses, "first5": float(np.mean(losses[:5])), "last5": float(np.mean(losses[-5:])),
            "skipped": int(ts.skipped), "step_ms_each": ms, "step_ms_median": float(np.median(ms[5:])),
            "peak_memory_gb": peak / 1e9, "traced_step": {k: prof[k] for k in (
                "wall_ms_per_predict", "kernel_ms_per_predict", "copy_ms_per_predict", "kernel_busy_share")},
            "top10_kernels": prof["top"][:10]}


class StepWatch:
    """Wraps `make_train_step`'s steps and `_validate_ema` while a training
    run goes: each step's CUDA-event ms and kernel B's launches inside it,
    each validation's seconds and kernel launches."""

    def __init__(self):
        self.steps, self.vals = [], []

    def __enter__(self):
        import torch

        import yolo_infer_tpu_torch.core.train_step as train_step
        import yolo_infer_tpu_torch.core.trainer as trainer

        self._ts, self._tr = train_step, trainer
        self._make, self._val = train_step.make_train_step, trainer.YOLO11Trainer._validate_ema
        real_make, real_val, steps, vals = self._make, self._val, self.steps, self.vals

        def make_counted(*a, **kw):
            step = real_make(*a, **kw)

            def counted(ts, batch):
                b0 = counters()["attention_qkv"].launches
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
                result = step(ts, batch)
                end.record()
                steps.append((start, end, counters()["attention_qkv"].launches - b0))
                return result
            return counted

        def val_counted(trainer_self, ts, cfg):
            before, t0 = read_counters(), time.perf_counter()
            result = real_val(trainer_self, ts, cfg)
            torch.cuda.synchronize()
            after = read_counters()
            vals.append({"seconds": time.perf_counter() - t0, "metrics": result,
                         "launches": {k: after[k] - before[k] for k in after if after[k] - before[k]}})
            return result

        train_step.make_train_step, trainer.YOLO11Trainer._validate_ema = make_counted, val_counted
        return self

    def __exit__(self, *exc):
        self._ts.make_train_step, self._tr.YOLO11Trainer._validate_ema = self._make, self._val
        return False

    def summary(self):
        import torch

        torch.cuda.synchronize()
        ms = [a.elapsed_time(b) for a, b, _ in self.steps]
        return {"steps": len(ms), "step_ms": ms, "b_launches_in_steps": [n for _, _, n in self.steps],
                "validations": self.vals}


def phase_train(report):
    """Detect training on the card through the command line, an fp32 step
    cuda against cpu, and a fixed-batch run (see the module docstring,
    phase 29)."""
    out = {"phase": "train", "card": card_line()}
    failures = []
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_train_"))
    try:
        data = write_rect_dataset(root / "data", SEED + 29)
        with StepWatch() as watch:
            rc, parsed, seconds, launches, errors = run_cli(
                "train", "--model-size", "n", "--data", data, "--epochs", TRAIN["epochs"], "--batch", TRAIN["batch"],
                "--imgsz", TRAIN["imgsz"], "--project", root / "runs", "--name", "smoke")
        cli = {"rc": rc, "seconds": seconds, "launches": launches, **watch.summary()}
        vals = cli["validations"]
        if rc != 0 or not isinstance(parsed, dict):
            failures.append(f"train: exit {rc} ({errors[-1:] or parsed})")
        else:
            cli.update({k: parsed.get(k) for k in ("status", "skipped_steps", "epochs_completed", "best_fitness",
                                                   "training_time_s")})
            timing = json.loads((Path(parsed["run_dir"]) / "timing.json").read_text())
            cli["epochs"] = [{"images_per_s": t["images"] / t["train_s"],
                              "loader_wait_ms_per_step": 1e3 * t["loader_wait_s"] / t["steps"],
                              "train_s": t["train_s"], "val_s": t["val_s"], "steps": t["steps"]} for t in timing]
            if parsed.get("status") != "completed" or parsed.get("skipped_steps") != 0:
                failures.append(f"train: status {parsed.get('status')}, skipped {parsed.get('skipped_steps')}")
        want_steps = TRAIN["epochs"] * (TRAIN_FRAMES[0] // TRAIN["batch"])
        if cli["steps"] != want_steps or any(cli["b_launches_in_steps"]):
            failures.append(f"train: {cli['steps']} steps (want {want_steps}), B launched "
                            f"{cli['b_launches_in_steps']} times inside them")
        if len(vals) != TRAIN["epochs"] or any(min(v["launches"].get("dfl_decode", 0),
                                                   v["launches"].get("greedy_nms_keep", 0)) < 1 for v in vals):
            failures.append(f"train: F and G did not launch in every epoch's validation: "
                            f"{[v['launches'] for v in vals]}")
        out["cli"] = cli
        check = train_fp32_check(data)
        out["fp32_step"] = check
        if (check["loss_rel"] > TRAIN_LOSS_RTOL or check["update_rel"] > TRAIN_UPDATE_RTOL
                or check["bn_max_abs"] > TRAIN_BN_ATOL or any(check["skipped"])):
            failures.append(f"fp32 step: cuda differs from cpu: {check}")
        out["mosaic_loader"] = mosaic_loader_pace(data)
        fit = train_overfit(data)
        out["overfit"] = fit
        if not fit["last5"] < 0.8 * fit["first5"] or fit["skipped"]:
            failures.append(f"overfit: the loss went from {fit['first5']} to {fit['last5']} "
                            f"(skipped {fit['skipped']})")
        if "epochs" in cli:
            kernel_ms = fit["traced_step"]["kernel_ms_per_predict"]
            out["device_busy_share"] = [kernel_ms * e["steps"] / (1e3 * e["train_s"]) for e in cli["epochs"]]
    finally:
        shutil.rmtree(root, ignore_errors=True)
    if failures:
        emit(out)
        raise AssertionError("; ".join(failures))
    return out


OPT_TRAIN = dict(batch=16, imgsz=640, epochs=1)  # each training run of phase 30
OPT_FRAMES = (32, 16)  # training (two steps of 16) and validation frames of each phase-30 dataset
OPT_TASKS = ("segment", "pose", "obb")
# the validation kernels each task's per-epoch validation must launch
OPT_VAL_KERNELS = {"segment": ("dfl_decode", "greedy_nms_keep"), "pose": ("dfl_decode", "greedy_nms_keep"),
                   "obb": ("dfl_decode", "rotated_nms_keep")}
OPT_DYN = (32, 640)  # the dynamic int8 paths, yolo11n and yolo11s: batch, imgsz
SLIM_TOL = 1e-4  # slim against zeroed in fp32, of the largest head value
PRUNE_SPARSITY = 0.5


def write_shapes_dataset(root: Path, task: str, seed: int) -> Path:
    """A one-class dataset of `OPT_FRAMES` 640x480 PNGs on gray with exact
    labels: detect and pose rectangles (pose: 17 keypoints on a grid inside
    each, all visible), segment filled polygons (a hexagon in a box), OBB
    filled rotated rectangles (their corners)."""
    from yolo_infer_tpu_torch.data.loader import create_dataset_config, save_image
    from yolo_infer_tpu_torch.data.polygon import fill_poly

    rng = np.random.default_rng(seed)
    for split, n in zip(("train", "val"), OPT_FRAMES):
        (root / "labels" / split).mkdir(parents=True)
        for i in range(n):
            img = np.full((480, 640, 3), int(rng.integers(70, 190)), np.uint8)
            rows = []
            for _ in range(int(rng.integers(1, 4))):
                w, h = float(rng.uniform(60, 220)), float(rng.uniform(60, 180))
                cx, cy = float(rng.uniform(w / 2 + 20, 620 - w / 2)), float(rng.uniform(h / 2 + 20, 460 - h / 2))
                colour = tuple(int(c) for c in rng.integers(0, 256, 3))
                if task in ("segment", "obb"):
                    if task == "obb":
                        pts = obb_corners(cx, cy, w, h, float(rng.uniform(-np.pi / 2, np.pi / 2)))
                    else:
                        a = np.linspace(0, 2 * np.pi, 7)[:6] + float(rng.uniform(0, 1))
                        pts = np.stack([cx + w / 2 * np.cos(a), cy + h / 2 * np.sin(a)], -1)
                    pts = np.clip(pts, 0, [639, 479])
                    for ch in range(3):
                        fill_poly(img[..., ch], np.round(pts).astype(np.int32), colour[ch])
                    rows.append("0 " + " ".join(f"{v:.6f}" for v in (pts / [640, 480]).ravel()))
                    continue
                x0, y0 = int(cx - w / 2), int(cy - h / 2)
                img[y0:y0 + int(h), x0:x0 + int(w)] = colour
                row = f"0 {cx / 640:.6f} {cy / 480:.6f} {int(w) / 640:.6f} {int(h) / 480:.6f}"
                if task == "pose":
                    gx, gy = np.meshgrid(np.linspace(0.15, 0.85, 5), np.linspace(0.15, 0.85, 4))
                    kx, ky = x0 + gx.ravel()[:17] * int(w), y0 + gy.ravel()[:17] * int(h)
                    row += "".join(f" {x / 640:.6f} {y / 480:.6f} 2" for x, y in zip(kx, ky))
                rows.append(row)
            save_image(root / "images" / split / f"{i:03d}.png", img, compress_level=1)
            (root / "labels" / split / f"{i:03d}.txt").write_text("\n".join(rows) + "\n")
    return create_dataset_config(root / "data.yaml", str(root / "images" / "train"), str(root / "images" / "val"),
                                 {0: "shape"})


def _epoch_rates(run_dir):
    timing = json.loads((Path(run_dir) / "timing.json").read_text())
    return [{"images_per_s": t["images"] / t["train_s"], "train_s": t["train_s"], "val_s": t["val_s"],
             "steps": t["steps"]} for t in timing]


def _float_e_work(args, kw):
    """Bytes and int8 operations of one float-epilogue launch of kernel E
    (the output written once in the epilogue's dtype)."""
    x, w_q, scale, bias = args[:4]
    b, h, w, ci = x.shape
    co, k = w_q.shape[0], w_q.shape[1]
    s = kw.get("stride", 1)
    ho, wo = (h + 2 * (k // 2) - k) // s + 1, (w + 2 * (k // 2) - k) // s + 1
    out_bytes = 4 if str(kw.get("epilogue_dtype")) == "torch.float32" else 2
    nbytes = x.numel() + w_q.numel() + 4 * co * (2 if bias is not None else 1) + b * ho * wo * co * out_bytes
    return nbytes, 2 * b * ho * wo * co * ci * k * k, (b, h, w, ci, co, k, s)


def dynamic_path(size: str, frames, calib):
    """yolo11`size` dynamic int8 at `OPT_DYN`: the path's launches (its run
    and one uncaptured body), kernel E's float epilogue at every input of the
    body against its plain version, its times and bound, and img/s beside
    bf16 and static8 (PTQ on `calib`)."""
    import torch

    import yolo_infer_tpu_torch.nn.quantize as quant_mod
    from yolo_infer_tpu_torch.core.model import YOLO11Model
    from yolo_infer_tpu_torch.ops.kernels import int8_conv as e_mod
    from yolo_infer_tpu_torch.optimization.quantization.quantizers import create_quantizer

    batch, imgsz = OPT_DYN
    model, _ = smoke_weights(calib, size=size, calibrate_bn=False)
    base = YOLO11Model.from_params(copy.deepcopy(model), task="detect", size=size, fused=False)  # bf16, cuda
    dyn = create_quantizer("dynamic", base).optimize()
    pred = dyn.predictor
    path, results = path_counters(lambda: (dyn.predict(frames, conf=0.25, imgsz=imgsz),
                                           dyn.predict(frames, conf=0.25, imgsz=imgsz))[1])
    seen = []
    e_fn = quant_mod.int8_conv

    def capture(*args, **kw):
        seen.append((tuple(torch.empty_strided(a.size(), a.stride(), dtype=a.dtype, device=a.device).copy_(a)
                           if torch.is_tensor(a) else a for a in args), kw))
        return e_fn(*args, **kw)

    quant_mod.int8_conv = capture  # `quantized_conv2d`'s launch of E
    reset_counters()
    try:
        eager_run(pred, frames, imgsz)
    finally:
        quant_mod.int8_conv = e_fn
    body = read_counters()
    counts = path_launches(f"dynamic yolo11{size}", ("int8_conv",), path, body)
    mism, err, per, bytes_e, ops_e = 0, 0.0, [], 0, 0
    e_ms = device_ms_each([lambda a=args, k=kw: e_mod.int8_conv(*a, **k) for args, kw in seen])
    for (args, kw), ms in zip(seen, e_ms):
        got, want = e_mod.int8_conv(*args, **kw), e_mod.int8_conv_reference(*args, **kw)
        mism += int(not torch.equal(got, want))
        err = max(err, float((got.float() - want.float()).abs().max()))
        nbytes, ops, shape = _float_e_work(args, kw)
        bytes_e, ops_e = bytes_e + nbytes, ops_e + ops
        per.append({"shape": list(shape), "ms": ms,
                    "plain_ms": cuda_ms(lambda: e_mod.int8_conv_reference(*args, **kw), iters=1, warmup=1)})
    shapes = sorted({tuple(p["shape"][3:]) for p in per})
    ptq = create_quantizer("ptq", base, {"imgsz": imgsz})
    ptq.set_calibration_data([calib])
    static8 = ptq.optimize()
    finite = all(np.isfinite(r.boxes).all() and np.isfinite(r.scores).all() for r in results)
    return {"size": size, "launches": counts["int8_conv"], "e_inputs": len(seen), "e_mismatches": mism,
            "e_max_abs_err": err,
            "e_shapes_ci_co_k_s": [list(s) for s in shapes], "stem_ci3": any(s[0] == 3 for s in shapes),
            "e_ms_sum": sum(p["ms"] for p in per), "e_plain_ms_sum": sum(p["plain_ms"] for p in per),
            **{f"e_{k}": v for k, v in bound(bytes_e, ops_e, H100_INT8_OPS).items()},
            "finite": finite, "detections_per_image": [len(r) for r in results][:4],
            "dynamic": timed_serving(pred, frames, imgsz), "bf16": timed_serving(base.predictor, frames, imgsz),
            "static8": timed_serving(static8.predictor, frames, imgsz), "ptq_scales": static8.quant_act_scales}


def dynamic_fp32_check(frames, calib):
    """yolo11n dynamic int8 fp32 `predict` on cuda and on cpu: detections
    paired as phase 16 pairs static8's (`pair_share`)."""
    import torch

    from yolo_infer_tpu_torch.core.model import YOLO11Model
    from yolo_infer_tpu_torch.optimization.quantization.quantizers import create_quantizer

    model, _ = smoke_weights(calib, size="n", calibrate_bn=False)
    base = YOLO11Model.from_params(model, task="detect", size="n", fused=False, compute_dtype=torch.float32,
                                   device="cpu")
    on_cpu = create_quantizer("dynamic", base).optimize()
    on_gpu = YOLO11Model.from_params(copy.deepcopy(on_cpu.deploy_model), task="detect", size="n", fused=True,
                                     compute_dtype=torch.float32)
    torch.backends.cudnn.deterministic = True
    try:
        got = on_gpu.predict(frames, conf=0.25)
    finally:
        torch.backends.cudnn.deterministic = False
    return pair_share(got, on_cpu.predict(frames, conf=0.25))


def phase_optimize(report):
    """Every task trains and every optimize method runs on the card (see
    the module docstring, phase 30)."""
    import torch

    from yolo_infer_tpu_torch.core.exported import ExportedPredictor, export_predictor
    from yolo_infer_tpu_torch.core.model import YOLO11Model
    from yolo_infer_tpu_torch.optimization.distillation import create_distiller
    from yolo_infer_tpu_torch.optimization.pruning import apply_masks, create_pruner, magnitude_masks, sparsity_report
    from yolo_infer_tpu_torch.optimization.quantization.quantizers import create_quantizer
    from yolo_infer_tpu_torch.optimization.surgery import slim_model, zero_removed

    out = {"phase": "optimize", "card": card_line()}
    failures = []
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_optimize_"))
    kw = dict(OPT_TRAIN, project=str(root / "runs"))
    try:
        # --- segment, pose and OBB training through YOLO11Model.train
        tasks = {}
        for i, task in enumerate(OPT_TASKS):
            data = write_shapes_dataset(root / task, task, SEED + 30 + i)
            model = YOLO11Model(f"yolo11n-{ {'segment': 'seg'}.get(task, task)}", nc=1)
            t0 = time.perf_counter()
            with StepWatch() as watch:
                res = model.train(str(data), name=task, **kw)
            row = {"seconds": time.perf_counter() - t0, "status": res["status"],
                   "skipped_steps": res["skipped_steps"], **watch.summary(),
                   "epochs": _epoch_rates(res["run_dir"]), "loss": res["history"][-1].get("loss")}
            row["fp32_step"] = check = train_fp32_check(data, task, nc=1)
            tasks[task] = row
            if res["status"] != "completed" or res["skipped_steps"]:
                failures.append(f"{task} training: {res['status']}, skipped {res['skipped_steps']}")
            if row["steps"] != OPT_FRAMES[0] // OPT_TRAIN["batch"] or any(row["b_launches_in_steps"]):
                failures.append(f"{task} training: {row['steps']} steps, B inside them {row['b_launches_in_steps']}")
            if len(row["validations"]) != 1 or any(row["validations"][0]["launches"].get(k, 0) < 1
                                                   for k in OPT_VAL_KERNELS[task]):
                failures.append(f"{task} validation did not launch {OPT_VAL_KERNELS[task]}: {row['validations']}")
            if (check["loss_rel"] > TRAIN_LOSS_RTOL or check["update_rel"] > TRAIN_UPDATE_RTOL
                    or check["bn_max_abs"] > TRAIN_BN_ATOL or any(check["skipped"])):
                failures.append(f"{task} fp32 step: cuda differs from cpu: {check}")
        out["tasks"] = tasks

        # --- dynamic int8 (kernel E's float epilogue), legacy static
        batch, imgsz = OPT_DYN
        rng = np.random.default_rng(SEED + 30)
        calib = rng.integers(0, 256, (2, imgsz, imgsz, 3), dtype=np.uint8)
        frames = rng.integers(0, 256, (batch, imgsz, imgsz, 3), dtype=np.uint8)
        dyn = {}
        for size in ("n", "s"):
            d = dynamic_path(size, frames, calib)
            scales = d.pop("ptq_scales")
            dyn[size] = d
            if d["e_mismatches"] or not d["stem_ci3"] or not d["finite"]:
                failures.append(f"dynamic yolo11{size}: E float epilogue differs at {d['e_mismatches']} of "
                                f"{d['e_inputs']} inputs (stem Ci=3 seen: {d['stem_ci3']}), finite {d['finite']}")
        out["dynamic"] = dyn
        out["dynamic_fp32"] = pairs = dynamic_fp32_check(frames[:2, :480], calib)
        if pairs["seen"] == 0 or pairs["share"] < Q8_PAIRED:
            failures.append(f"dynamic fp32 predict: cuda differs from cpu {pairs}")
        e_row = next((k for k in report.get("kernels", ()) if k["name"] == "int8_conv"), None)
        dyn_row = {"path": f"dynamic yolo11n + yolo11s b{batch}/{imgsz} bf16 (float epilogue)",
                   "launches": sum(d["launches"]["launches"] for d in dyn.values()),
                   "launches_per_call": {s: d["launches"]["launches_per_call"] for s, d in dyn.items()},
                   "ms": sum(d["e_ms_sum"] for d in dyn.values()),
                   "plain_ms": sum(d["e_plain_ms_sum"] for d in dyn.values()),
                   "bound_ms": sum(d["e_bound_ms"] for d in dyn.values()),
                   "max_abs_err": max(d["e_max_abs_err"] for d in dyn.values()),
                   "bound_by": sorted({d["e_bound_by"] for d in dyn.values()})}
        out["e_dynamic_row"] = dyn_row
        if e_row is not None:
            e_row["dynamic"] = dyn_row
        # legacy static: the yolo11n dynamic model serving PTQ's input absmax as 1-D scales
        n_base, _ = smoke_weights(calib, size="n", calibrate_bn=False)
        nq = create_quantizer("dynamic", YOLO11Model.from_params(n_base, task="detect", size="n",
                                                                 fused=False)).optimize()
        ptq = create_quantizer("ptq", YOLO11Model.from_params(copy.deepcopy(n_base), task="detect", size="n",
                                                              fused=False), {"imgsz": imgsz})
        ptq.set_calibration_data([calib])
        legacy = YOLO11Model.from_params(nq.deploy_model, task="detect", size="n", fused=True,
                                         quant_act_scales=np.asarray(ptq.optimize().quant_act_scales)[:, 0])
        path, res = path_counters(lambda: legacy.predict(frames[:8], conf=0.25, imgsz=imgsz))
        out["legacy_static"] = {"mode": legacy.predictor.quant_mode, "launches": path["int8_conv"],
                                "finite": all(np.isfinite(r.boxes).all() for r in res),
                                "img_per_s": timed_serving(legacy.predictor, frames, imgsz)["img_per_s"]}
        if legacy.predictor.quant_mode != "static" or path["int8_conv"] < 1 or not out["legacy_static"]["finite"]:
            failures.append(f"legacy static: {out['legacy_static']}")

        # --- QAT, pruning and distillation on the detect shapes
        data = write_shapes_dataset(root / "detect", "detect", SEED + 33)
        with StepWatch() as watch:
            q = create_quantizer("qat", YOLO11Model("yolo11n", nc=1), {"epochs": 1})
            qmodel = q.optimize(data=str(data), **{k: v for k, v in kw.items() if k != "epochs"})
        path, res = path_counters(lambda: qmodel.predict(frames[:8], conf=0.25, imgsz=imgsz))
        out["qat"] = {**q.get_optimization_info(), **watch.summary(), "serve_mode": qmodel.predictor.quant_mode,
                      "serve_e_launches": path["int8_conv"]}
        if out["qat"]["train_status"] != "completed" or path["int8_conv"] < 1:
            failures.append(f"qat: {out['qat']['train_status']}, E launches serving {path['int8_conv']}")

        dense = YOLO11Model("yolo11n", nc=1)
        card_model = copy.deepcopy(dense.model).cuda()
        masks = magnitude_masks(card_model, PRUNE_SPARSITY)
        rep = sparsity_report(apply_masks(card_model, masks))
        want = int(PRUNE_SPARSITY * rep["prunable_params"]) / rep["prunable_params"]
        pruner = create_pruner(dense, {"method": "magnitude", "sparsity": PRUNE_SPARSITY})
        with StepWatch() as watch:
            pruner.optimize(data=str(data), name="prune", **kw)
        info = pruner.get_optimization_info()
        out["prune"] = {"masks_on_card": rep, "target": want, "after_fine_tune": info["after"],
                        "fine_tune": info["fine_tune"], **watch.summary()}
        if rep["prunable_sparsity"] != want or info["after"]["prunable_sparsity"] < want:
            failures.append(f"pruning: sparsity {rep['prunable_sparsity']} on the card, "
                            f"{info['after']['prunable_sparsity']} after the fine-tune (want {want})")

        # physical surgery: slim == zeroed in fp32, slim against dense img/s, the slim export
        calibrated, _ = smoke_weights(calib, size="n")
        slim, plan, srep = slim_model(calibrated, keep_frac=1 - PRUNE_SPARSITY)
        zeroed = zero_removed(calibrated, plan)
        x = torch.from_numpy(calib[:2].astype(np.float32) / 255).cuda()
        with torch.no_grad():
            a, z = slim.float().cuda().eval()(x), zeroed.float().cuda().eval()(x)
        slim_err = max(float((u - v).abs().max() / v.abs().max()) for u, v in zip(a["feats"], z["feats"]))
        slim_m = YOLO11Model.from_params(slim.cpu(), task="detect", size="n", fused=False)
        dense_m = YOLO11Model.from_params(copy.deepcopy(calibrated), task="detect", size="n", fused=False)
        eb = min(8, batch)
        ep_path = export_predictor(slim_m, root / "slim.pt2", batch=eb, imgsz=imgsz)
        dense_path = export_predictor(dense_m, root / "dense.pt2", batch=eb, imgsz=imgsz)
        ep = ExportedPredictor.load(ep_path)
        fd = torch.from_numpy(frames[:eb]).cuda()
        rep_out = clone_dets(ep.predict_raw(fd, 0.25, 0.45))
        rep_out = clone_dets(ep.predict_raw(fd, 0.25, 0.45))  # a replay of the captured graph
        eager = ep.run_eager(fd, 0.25, 0.45)
        out["surgery"] = {**srep, "slim_vs_zeroed_rel": slim_err, "slim_export_bytes": ep_path.stat().st_size,
                          "dense_export_bytes": dense_path.stat().st_size,
                          "export_replay_equals_eager": dets_equal(rep_out, eager),
                          "slim": timed_serving(slim_m.predictor, frames, imgsz),
                          "dense": timed_serving(dense_m.predictor, frames, imgsz)}
        out["surgery"]["slim_vs_dense_img_per_s"] = (out["surgery"]["slim"]["img_per_s"]
                                                     / out["surgery"]["dense"]["img_per_s"])
        if (slim_err > SLIM_TOL or not out["surgery"]["export_replay_equals_eager"]
                or out["surgery"]["slim_export_bytes"] >= out["surgery"]["dense_export_bytes"]):
            failures.append(f"surgery: slim vs zeroed {slim_err}, export replay equals eager "
                            f"{out['surgery']['export_replay_equals_eager']}, bytes "
                            f"{out['surgery']['slim_export_bytes']} vs {out['surgery']['dense_export_bytes']}")

        # distillation: a yolo11s teacher inside the yolo11n student's steps
        student, teacher = YOLO11Model("yolo11n", nc=1), YOLO11Model("yolo11s", nc=1, seed=SEED + 1)
        d = create_distiller(student, {"teacher": teacher})
        with StepWatch() as watch:
            d.optimize(str(data), name="distill", **kw)
        out["distill"] = {**d.get_optimization_info(), **watch.summary()}
        if out["distill"]["epochs_completed"] != 1 or not all(out["distill"]["b_launches_in_steps"]):
            failures.append(f"distillation: B launches inside the steps {out['distill']['b_launches_in_steps']}")
    except Exception:
        emit(out)  # what ran before the error
        raise
    finally:
        shutil.rmtree(root, ignore_errors=True)
    if failures:
        emit(out)
        raise AssertionError("; ".join(failures))
    return out


PAR_TRAIN = dict(batch=16, imgsz=640, epochs=1)  # MultiChipTrainer(device_ids=[0]) over phase 29's dataset: 6 steps
PAR_CHECK = (2, 640)  # the fp32 step, meshed against unmeshed: batch, imgsz (2 x 1 images over two ranks)
PAR_STEP = (16, 640)  # the timed bf16 steps: batch, imgsz
PAR_STEPS = 6  # timed steps of each form per turn (two turns: unmeshed, meshed, meshed, unmeshed)
PAR_SERVE = (32, 640)  # the meshed bf16 predict: batch, imgsz
PAR_LOSS_RTOL = 1e-5
# the update's bound: phase 29's cuda-vs-cpu one, for the same f32 step summed
# in other orders. An f32 step is not exact to 1e-5 of its update (its gradient
# differs from the f64 one by 7.0e-5 of its norm, tests/test_torch_parallel_train.py,
# where the meshed step equals the one-process step to 1e-12 in f64). On the
# CPU the meshed update differed from the one-process one by 5e-5 to 6e-4 of
# its norm over three batches (64-160 px), 4-7 times as much as the
# one-process step with its batch's images swapped, which the phase prints
# beside it (`swap_update_rel`)
PAR_UPDATE_RTOL = TRAIN_UPDATE_RTOL
PAR_BN_ATOL = 1e-5
PAR_RANKS = 2  # (b): gloo processes, both on cuda:0
PAR_RANK_TIMEOUT_S = 300  # the launch of (b): a rank that fails or hangs fails it, the other is killed
PAR_DEVICE, PAR_BACKEND = "cuda:0", "nccl"  # (a)'s card and backend (a CPU rehearsal of the phase sets "cpu", "gloo")


def fixed_batch(data: Path, batch: int, imgsz: int):
    """The first batch of the training loader with augmentation off (numpy)."""
    from yolo_infer_tpu_torch.data.dataset import YOLODataset
    from yolo_infer_tpu_torch.data.train_loader import TrainLoader

    off = dict(hsv_h=0.0, hsv_s=0.0, hsv_v=0.0, degrees=0.0, translate=0.0, scale=0.0, shear=0.0, fliplr=0.0,
               flipud=0.0, mosaic=0.0, mixup=0.0)
    loader = TrainLoader(YOLODataset(data, split="train"), batch_size=batch, imgsz=imgsz, hyp=off, seed=SEED)
    return next(iter(loader.epoch_batches(0)))


def step_result(model, spec, batch_np, device, mesh):
    """One fp32 step from `model` on `batch_np` (this rank's slice under a
    mesh): loss, the params' update and the batch-norm state (on the host),
    skipped."""
    import torch

    from yolo_infer_tpu_torch.core.train_step import init_train_state, make_optimizer, make_train_step
    from yolo_infer_tpu_torch.parallel.mesh import shard_batch

    tx = make_optimizer(0.01, total_steps=10, warmup_steps=0)
    ts = init_train_state(model, tx, seed=SEED, device=device)
    before = ts.params.detach().clone()
    step = make_train_step(spec, tx, compute_dtype=torch.float32, mesh=mesh)
    local = batch_np if mesh is None else shard_batch(batch_np, mesh)
    ts, m = step(ts, {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in local.items()})
    return float(m["loss"]), (ts.params - before).cpu(), ts.bn_state.cpu(), int(ts.skipped)


def step_diff(got, want):
    (lg, ug, bg, sg), (lw, uw, bw, sw) = got, want
    return {"loss": lg, "loss_ref": lw, "loss_rel": abs(lg - lw) / abs(lw),
            "update_rel": float((ug - uw).norm() / uw.norm()), "update_norm": float(uw.norm()),
            "bn_max_abs": float((bg - bw).abs().max()), "skipped": [sg, sw]}


def step_close(d) -> bool:
    return (d["loss_rel"] <= PAR_LOSS_RTOL and d["update_rel"] <= PAR_UPDATE_RTOL and d["bn_max_abs"] <= PAR_BN_ATOL
            and not any(d["skipped"]))


class CollectiveCount:
    """Counts the calls of `torch.distributed`'s all_reduce, all_gather and
    broadcast while it is entered (the port calls them through the module)."""

    NAMES = ("all_reduce", "all_gather", "broadcast")

    def __enter__(self):
        import torch.distributed as td

        self.counts = collections.Counter()
        self._td, self._real = td, {n: getattr(td, n) for n in self.NAMES}
        for n, fn in self._real.items():
            def counted(*a, _n=n, _fn=fn, **kw):
                self.counts[_n] += 1
                return _fn(*a, **kw)
            setattr(td, n, counted)
        return self

    def __exit__(self, *exc):
        for n, fn in self._real.items():
            setattr(self._td, n, fn)
        return False


def step_profile(fn, calls: int = 2):
    """`calls` calls of `fn` under torch.profiler, per call: the wall ms (the
    profiler's own cost included), the kernels' device ms and launches, and
    each op's self host ms and calls ({key: [ms, calls]}). A trace with no
    device events is taken again (three tries), as `traced_rows` does."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0) / calls
        events = prof.key_averages()
        kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
                   and e.self_device_time_total > 0 and e.key != "Activity Buffer Request"
                   and not e.key.startswith(("Memcpy", "Memset"))]
        if kernels:
            break
    host = {e.key: [e.self_cpu_time_total / 1e3 / calls, e.count / calls] for e in events
            if e.device_type == torch.autograd.DeviceType.CPU}
    return {"wall_ms": wall_ms, "device_ms": sum(e.self_device_time_total for e in kernels) / 1e3 / calls,
            "kernel_launches": sum(e.count for e in kernels) / calls,
            "host_self_ms": sum(ms for ms, _ in host.values()), "host_ops": host}


def step_gap_profile(fns, top: int = 14):
    """One trace of each step in `fns` ({"unmeshed": fn, "meshed": fn}), and
    the ops whose self host ms per step grew most from the unmeshed step to
    the meshed one: where the meshed step's extra time goes."""
    prof = {k: step_profile(fn) for k, fn in fns.items()}
    a, b = prof["unmeshed"]["host_ops"], prof["meshed"]["host_ops"]
    gap = sorted(((k, b.get(k, [0.0, 0])[0] - a.get(k, [0.0, 0])[0], a.get(k, [0.0, 0])[1], b.get(k, [0.0, 0])[1])
                  for k in set(a) | set(b)), key=lambda r: -r[1])
    out = {k: {f: v for f, v in p.items() if f != "host_ops"} for k, p in prof.items()}
    out["host_ms_gap_by_op"] = [{"op": k, "ms": ms, "calls": [ca, cb]} for k, ms, ca, cb in gap[:top]]
    out["unmeshed_top_host_ops"] = sorted(([k, *v] for k, v in a.items()), key=lambda r: -r[1])[:top]
    return out


def par_results(results):
    return [{"boxes": r.boxes, "scores": r.scores, "classes": r.classes} for r in results]


class _Dets(SimpleNamespace):
    def __len__(self) -> int:
        return len(self.scores)


def paired(got, want, box_tol: float, score_tol: float):
    """Per image: counts equal and every detection paired (same class, box and score within tolerance)."""
    bad = []
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = _Dets(**g), _Dets(**w)
        if len(g) != len(w) or match_detections(g, w, box_tol, score_tol)[0]:
            bad.append(i)
    return bad


def parallel_world_one(data: Path, root: Path, weights, failures):
    """(a) NCCL, a world of one: the trainer, the fp32 step and the step ms,
    the meshed predictor (see the module docstring, phase 31)."""
    import torch

    import yolo_infer_tpu_torch.ops.nms as nms_ops
    from yolo_infer_tpu_torch.core.model import YOLO11Model
    from yolo_infer_tpu_torch.core.predictor import SERVE_POOL, Predictor
    from yolo_infer_tpu_torch.core.train_step import init_train_state, make_optimizer, make_train_step
    from yolo_infer_tpu_torch.core.trainer import MultiChipTrainer, TrainingConfig
    from yolo_infer_tpu_torch.models.yolo11 import build_model
    from yolo_infer_tpu_torch.parallel.mesh import create_mesh

    out = {}
    dev = PAR_DEVICE
    mesh = create_mesh()
    cfg = TrainingConfig(data=str(data), project=str(root / "runs"), name="mc", val=False, **PAR_TRAIN)
    with StepWatch() as watch:
        trainer = MultiChipTrainer(model=YOLO11Model("yolo11n", nc=TRAIN_NC, device=dev), config=cfg,
                                   device=dev.split(":")[0], device_ids=[0])
        result = trainer.train()
    w = watch.summary()
    out["trainer"] = {"status": result["status"], "skipped_steps": result["skipped_steps"], "steps": w["steps"],
                      "step_ms": w["step_ms"], "b_launches_in_steps": w["b_launches_in_steps"],
                      "mesh": dict(trainer._mesh.shape), "loss": result["history"][-1].get("loss")}
    want_steps = TRAIN_FRAMES[0] // PAR_TRAIN["batch"]
    if result["status"] != "completed" or result["skipped_steps"] or w["steps"] != want_steps:
        failures.append(f"nccl: MultiChipTrainer(device_ids=[0]): {out['trainer']}")

    model, spec = build_model("detect", "n", TRAIN_NC, seed=SEED)
    batch2 = fixed_batch(data, *PAR_CHECK)
    with CollectiveCount() as cc:
        meshed = step_result(model, spec, batch2, dev, mesh)
    plain = step_result(model, spec, batch2, dev, None)
    check = step_diff(meshed, plain)
    check["collectives_per_step"] = dict(cc.counts)
    swapped = step_result(model, spec, {k: np.ascontiguousarray(v[::-1]) for k, v in batch2.items()}, dev, None)
    check["swap_update_rel"] = step_diff(swapped, plain)["update_rel"]  # f32 rounding alone, for scale
    out["fp32_step"] = check
    if not step_close(check):
        failures.append(f"nccl: the meshed fp32 step differs from the unmeshed one: {check}")

    batch16 = {k: torch.from_numpy(v).to(dev) for k, v in fixed_batch(data, *PAR_STEP).items()}
    runs = {}
    for name, m in (("unmeshed", None), ("meshed", mesh)):
        tx = make_optimizer(0.01, total_steps=100, warmup_steps=0)
        runs[name] = (init_train_state(model, tx, seed=SEED, device=dev), make_train_step(spec, tx, mesh=m))
        for _ in range(2):  # warm-up
            runs[name][1](runs[name][0], batch16)
    marks = {"unmeshed": [], "meshed": []}
    for name in ("unmeshed", "meshed", "meshed", "unmeshed"):
        ts, step = runs[name]
        for _ in range(PAR_STEPS):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            step(ts, batch16)
            end.record()
            marks[name].append((start, end))
    torch.cuda.synchronize()
    ms = {k: [a.elapsed_time(b) for a, b in v] for k, v in marks.items()}
    out["bf16_step_ms"] = {"batch": PAR_STEP[0], "imgsz": PAR_STEP[1], "each": ms,
                           **{f"{k}_median": float(np.median(v)) for k, v in ms.items()}}
    out["bf16_step_ms"]["meshed_over_unmeshed"] = (out["bf16_step_ms"]["meshed_median"]
                                                   / out["bf16_step_ms"]["unmeshed_median"])
    # what the step's all-reduces cost alone: as many calls on a 256-float tensor, back to back
    n = sum(cc.counts.values())
    t = torch.zeros(256, device=dev)
    for _ in range(3):
        torch.distributed.all_reduce(t, group=mesh.data_group)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        torch.distributed.all_reduce(t, group=mesh.data_group)
    end.record()
    host_ms = 1e3 * (time.perf_counter() - t0)
    torch.cuda.synchronize()
    out["bf16_step_ms"]["all_reduces_alone"] = {"calls": n, "host_ms": host_ms, "event_ms": start.elapsed_time(end)}
    out["bf16_step_profile"] = step_gap_profile({k: (lambda ts=ts, step=step: step(ts, batch16))
                                                 for k, (ts, step) in runs.items()})

    wmodel, wspec = weights
    b, imgsz = PAR_SERVE
    frames = np.random.default_rng(SEED + 31).integers(0, 256, (b, imgsz, imgsz, 3), dtype=np.uint8)
    pm = Predictor(wmodel, wspec, device=dev, mesh=mesh)
    ps = Predictor(wmodel, wspec, device=dev)
    launches, _ = path_counters(lambda: pm.predict(frames, conf=0.25, imgsz=imgsz))
    shapes, real_keep = [], nms_ops.nms_keep

    def seen(sup_boxes, *a, **kw):
        shapes.append(list(sup_boxes.shape))
        return real_keep(sup_boxes, *a, **kw)

    nms_ops.nms_keep = seen
    try:
        eager_run(pm, frames, imgsz)
    finally:
        nms_ops.nms_keep = real_keep
    times = {"meshed": [], "unmeshed": []}
    for name in ("meshed", "unmeshed", "unmeshed", "meshed"):
        pred = pm if name == "meshed" else ps
        pred.predict(frames, conf=0.25, imgsz=imgsz)  # the signature's capture (first turn) or a warm call
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pred.predict(frames, conf=0.25, imgsz=imgsz)
            times[name].append(time.perf_counter() - t0)
    img_s = {k: b / float(np.median(v)) for k, v in times.items()}
    out["predict_bf16"] = {"batch": b, "imgsz": imgsz, "launches": {k: v for k, v in launches.items() if v},
                           "nms_keep_inputs": shapes, "img_per_s": img_s,
                           "meshed_over_unmeshed": img_s["meshed"] / img_s["unmeshed"]}
    if launches["nms_keep"] < 1 or launches["attention_qkv"] < 1 or shapes != [[b, SERVE_POOL, 4]]:
        failures.append(f"nccl: the meshed predict did not run A at K={SERVE_POOL} and B: {out['predict_bf16']}")

    f2 = np.random.default_rng(SEED + 2).integers(0, 256, (2, 480, 640, 3), dtype=np.uint8)
    got = par_results(Predictor(wmodel, wspec, device=dev, compute_dtype=torch.float32, mesh=mesh).predict(
        list(f2), conf=0.001, iou=0.45, imgsz=PAR_CHECK[1]))
    want = par_results(Predictor(wmodel, wspec, device=dev, compute_dtype=torch.float32).predict(
        list(f2), conf=0.001, iou=0.45, imgsz=PAR_CHECK[1]))
    bad = paired(got, want, 1e-2, 1e-5)
    out["predict_fp32"] = {"num_meshed": [len(r["scores"]) for r in got], "num": [len(r["scores"]) for r in want],
                           "images_unpaired": bad}
    if bad or not sum(out["predict_fp32"]["num"]):
        failures.append(f"nccl: the meshed fp32 predict differs from the unmeshed one: {out['predict_fp32']}")
    return out


def parallel_rank(data: str, root: str, wmodel, device: str, sizes):
    """One of (b)'s gloo processes on `device` (cuda:0): the DP step at
    `sizes["check"]`, the meshed predict at `sizes["serve"]`, a 1-epoch
    training run at `sizes["train"]` and the dry run (see the module
    docstring, phase 31). The sizes come from the launching process (a
    spawned process imports this script anew)."""
    import torch

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    from yolo_infer_tpu_torch.core.model import YOLO11Model
    from yolo_infer_tpu_torch.core.predictor import Predictor
    from yolo_infer_tpu_torch.core.trainer import TrainingConfig, YOLO11Trainer
    from yolo_infer_tpu_torch.models.yolo11 import build_model
    from yolo_infer_tpu_torch.parallel import distributed as dist
    from yolo_infer_tpu_torch.parallel.dryrun import dryrun_multichip
    from yolo_infer_tpu_torch.parallel.mesh import create_mesh
    from yolo_infer_tpu_torch.utils.checkpoint import CheckpointManager

    rank, device = dist.process_index(), torch.device(device)
    mesh = create_mesh()
    out, seconds = {"rank": rank}, {}
    t0 = time.perf_counter()
    model, spec = build_model("detect", "n", TRAIN_NC, seed=SEED)
    batch2 = fixed_batch(Path(data), *sizes["check"])
    loss, update, bn, skipped = step_result(model, spec, batch2, device, mesh)
    out["dp_step"] = (loss, update, bn, skipped)
    if rank == 0:
        out["whole_step"] = step_result(model, spec, batch2, device, None)
    seconds["dp_step"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    b, imgsz = sizes["serve"]
    frames = np.random.default_rng(SEED + 32).integers(0, 256, (b, imgsz, imgsz, 3), dtype=np.uint8)
    kw = dict(device=device, compute_dtype=torch.float32)
    out["meshed_predict"] = par_results(Predictor(wmodel, wmodel.spec, mesh=mesh, **kw).predict(
        frames, conf=0.25, imgsz=imgsz))
    if rank == 0:
        out["single_predict"] = par_results(Predictor(wmodel, wmodel.spec, **kw).predict(frames, conf=0.25,
                                                                                         imgsz=imgsz))
    seconds["predict"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    writes = []
    spied = [(CheckpointManager, "save_checkpoint"), (YOLO11Trainer, "_write_summary"), (TrainingConfig, "save")]
    real = [getattr(owner, name) for owner, name in spied]
    for (owner, name), fn in zip(spied, real):
        def wrapped(*a, _fn=fn, _name=name, **kw):
            writes.append(_name)
            return _fn(*a, **kw)
        setattr(owner, name, wrapped)
    try:
        cfg = TrainingConfig(data=data, epochs=1, batch=sizes["train"]["batch"], imgsz=sizes["train"]["imgsz"],
                             project=str(Path(root) / f"rank{rank}"), name="run")
        trainer = YOLO11Trainer(model=YOLO11Model("yolo11n", nc=TRAIN_NC, device=str(device)), config=cfg,
                                device=str(device))
        result = trainer.train()
    finally:
        for (owner, name), fn in zip(spied, real):
            setattr(owner, name, fn)
    out["train"] = {"status": result["status"], "skipped_steps": result["skipped_steps"], "writes": writes,
                    "run_dir": str(trainer.run_dir), "mesh": dict(trainer._mesh.shape),
                    "val": {k: v for k, v in result["history"][-1].items() if k.startswith("val_")}}
    seconds["train"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["dryrun_loss"] = dryrun_multichip(PAR_RANKS, device=device.type)
    seconds["dryrun"] = time.perf_counter() - t0
    out["seconds"] = seconds
    return out


def parallel_two_ranks(data: Path, root: Path, weights, failures):
    """(b) two gloo processes on cuda:0 (see the module docstring, phase 31)."""
    from yolo_infer_tpu_torch.parallel.distributed import launch

    t0 = time.perf_counter()
    sizes = {"check": PAR_CHECK, "serve": PAR_SERVE, "train": TRAIN}
    r0, r1 = launch(parallel_rank, PAR_RANKS, backend="gloo", devices=[PAR_DEVICE] * PAR_RANKS,
                    args=(str(data), str(root), weights[0], PAR_DEVICE, sizes), timeout_s=PAR_RANK_TIMEOUT_S)
    out = {"launch_seconds": time.perf_counter() - t0, "rank_seconds": [r0["seconds"], r1["seconds"]]}
    step = step_diff(r0["dp_step"], r0["whole_step"])
    step["ranks_equal"] = bool(r0["dp_step"][1].equal(r1["dp_step"][1]) and r0["dp_step"][2].equal(r1["dp_step"][2]))
    out["dp_step"] = step
    if not step_close(step) or not step["ranks_equal"]:
        failures.append(f"gloo: the 2-rank fp32 step differs from the one-process step: {step}")
    same = all(all(np.array_equal(a[k], b[k]) for k in a) for a, b in zip(r0["meshed_predict"], r1["meshed_predict"]))
    bad = paired(r0["meshed_predict"], r0["single_predict"], 1e-2, 1e-5)
    out["predict"] = {"ranks_equal": same, "num": [len(r["scores"]) for r in r0["meshed_predict"]],
                      "images_unpaired": bad}
    if not same or bad or len(r0["meshed_predict"]) != PAR_SERVE[0] or not sum(out["predict"]["num"]):
        failures.append(f"gloo: the meshed predict: {out['predict']}")
    out["train"] = [r0["train"], r1["train"]]
    written = set(r0["train"]["writes"])
    if (r0["train"]["status"] != "completed" or r1["train"]["status"] != "completed" or r1["train"]["writes"]
            or not {"save", "save_checkpoint", "_write_summary"} <= written
            or r0["train"]["val"] != r1["train"]["val"] or (root / "rank1").exists()):
        failures.append(f"gloo: the 2-rank training run: {out['train']}")
    out["dryrun_loss"] = [r0["dryrun_loss"], r1["dryrun_loss"]]
    if not np.isfinite(r0["dryrun_loss"]) or r0["dryrun_loss"] != r1["dryrun_loss"]:
        failures.append(f"gloo: dryrun_multichip(2): {out['dryrun_loss']}")
    return out


def phase_parallel(report):
    """Multi-device training and serving on torch.distributed (see the
    module docstring, phase 31)."""
    import datetime

    import torch.distributed as td

    out = {"phase": "parallel", "card": card_line()}
    failures = []
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_parallel_"))
    try:
        data = write_rect_dataset(root / "data", SEED + 29)
        weights = report["weights"] if "weights" in report else smoke_weights(
            np.random.default_rng(SEED + 2).integers(0, 256, (2, 480, 640, 3), dtype=np.uint8))
        t0 = time.perf_counter()
        td.init_process_group(PAR_BACKEND, store=td.FileStore(str(root / "nccl_store"), 1), rank=0, world_size=1,
                              timeout=datetime.timedelta(seconds=120))
        try:
            out["nccl"] = parallel_world_one(data, root, weights, failures)
        finally:
            td.destroy_process_group()
        out["nccl"]["seconds"] = time.perf_counter() - t0
        out["gloo"] = parallel_two_ranks(data, root / "runs2", weights, failures)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    if failures:
        emit(out)
        raise AssertionError("; ".join(failures))
    return out


VIDEO_FRAMES = 30  # the video phase's input: seeded 640x480 frames at 30 fps, MJPEG AVI written by the port
VIDEO_SIZE = (480, 640)
VIDEO_SERVE = (8, 640)  # detect_video: batch, imgsz
VIDEO_SEG_FRAMES = 4  # the segment video, frame by frame
VIDEO_KERNELS = ("nms_keep", "attention_qkv")  # A, B on the batched detect path
VIDEO_SEG_KERNELS = ("nms_keep", "attention_qkv", "upsample4x_threshold_pack")  # A, B, D on the segment path


def video_source(root: Path) -> Path:
    """The phase's input video, written by the port's own writer."""
    from yolo_infer_tpu_torch.utils.visualization import create_video_writer

    h, w = VIDEO_SIZE
    writer = create_video_writer(root / "in.avi", 30, (w, h))
    try:
        for i in range(VIDEO_FRAMES):
            writer.write(jpeg_frame(300 + i, h, w)[..., ::-1])
    finally:
        writer.release()
    return root / "in.avi"


def video_reference(pred, frames, conf: float, iou: float):
    """Each frame's (boxes, scores, classes) from `pred.predict_raw` (the
    demo's captured program) on the decoded RGB `frames`, letterboxed on the
    host and batched as the demo batches them."""
    import torch

    from yolo_infer_tpu_torch.ops.letterbox import letterbox, letterbox_params, scale_boxes

    batch, imgsz = VIDEO_SERVE
    ratio, pad, _ = letterbox_params(frames[0].shape[:2], imgsz)
    lbs = [letterbox(f, imgsz)[0] for f in frames]
    out = []
    for chunk in padded_chunks(lbs, batch):
        with torch.inference_mode():
            dets = pred.predict_raw(torch.from_numpy(np.stack(chunk)).to(pred.device), conf, iou, imgsz)
        dets = {k: v.cpu().numpy() for k, v in dets.items()}
        for i in range(min(batch, len(frames) - len(out))):
            k = int(dets["num"][i])
            out.append((scale_boxes(dets["boxes"][i, :k], ratio, pad, frames[0].shape[:2]), dets["scores"][i, :k],
                        dets["classes"][i, :k].astype(np.int32)))
    return out, lbs


def check_video_demo(demo, src: Path, root: Path, suffix: str, n: int, where: str, prefix: str, failures: list):
    """The batched detect video demo over `src` (`n` frames), as phases 32
    and 34 check it: run 1, the path's own (counted; its first batch captures
    the b8/640 signature), writes `root/out{suffix}`, and every frame's
    detections must equal `predict_raw` on the frames the demo drew on;
    run 2, traced, writes `root/out2{suffix}` and shows where the time goes
    (A and B once per batch by name) and emits `{prefix}_frames_per_s`,
    `{prefix}_host_s_per_frame` and `{prefix}_device_busy_share`. Returns
    the record and what was drawn: (boxes, scores, classes, the first
    annotated frame, the decoded RGB frame) per frame."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from yolo_infer_tpu_torch.demos import detection_demo as demo_mod

    batch, imgsz = VIDEO_SERVE
    pred = demo.model.predictor
    drawn = []
    real_draw = demo_mod.draw_detections

    def record(frame, boxes, scores, classes, names=None):
        annotated = real_draw(frame, boxes, scores, classes, names)
        drawn.append((boxes, scores, classes, annotated if not drawn else None, frame))
        return annotated

    out = {}
    demo_mod.draw_detections = record
    torch.backends.cudnn.deterministic = True
    try:
        counts, first = path_counters(lambda: demo.detect_video(src, root / f"out{suffix}", batch_size=batch))
        # the frames the demo drew on are the ones it decoded: the reference
        # letterboxes and batches them itself
        want, lbs = video_reference(pred, [d[4] for d in drawn], demo.conf_threshold, demo.iou_threshold)
    finally:
        demo_mod.draw_detections = real_draw
        torch.backends.cudnn.deterministic = False
    reset_counters()
    eager_run(pred, np.stack(lbs[:batch]), imgsz, demo.conf_threshold, demo.iou_threshold)
    body = read_counters()
    out["run1"] = {k: first[k] for k in ("total_frames", "total_detections", "processing_time_s", "fps")}
    out["launches"] = path_launches(where, VIDEO_KERNELS, counts, body)
    bad = [i for i, ((b, s, c, _, _), (wb, ws, wc)) in enumerate(zip(drawn, want))
           if len(b) != len(wb) or not np.array_equal(c, wc)
           or (len(b) and (np.abs(b - wb).max() > 1e-3 or np.abs(s - ws).max() > 1e-5))]
    out["frames_differing_from_predict_raw"] = bad
    out["max_box_diff_px"] = max((float(np.abs(b - wb).max()) for (b, _, _, _, _), (wb, _, _) in zip(drawn, want)
                                  if len(b) == len(wb) and len(b)), default=0.0)
    if first["total_frames"] != n or len(drawn) != n or bad:
        failures.append(f"detect_video: {first['total_frames']} frames, {len(drawn)} drawn, frames {bad[:5]} "
                        "differ from predict_raw")
    if first["total_detections"] != sum(len(w[0]) for w in want) or not first["total_detections"]:
        failures.append(f"detect_video found {first['total_detections']} detections, predict_raw "
                        f"{sum(len(w[0]) for w in want)}")
    # --- run 2: the same video again (its graph replays), traced: where the time goes
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        lead_in(LEAD_INS)
        t0 = time.perf_counter()
        second = demo.detect_video(src, root / f"out2{suffix}", batch_size=batch)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    device = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    kernels = [e for e in device if e.self_device_time_total > 0 and LEAD_IN not in e.key
               and not e.key.startswith(("Memcpy", "Memset")) and e.key != "Activity Buffer Request"]
    kernel_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    chunks = -(-n // batch)
    by_name = {f: sum(e.count for e in kernels if f in e.key) for f in ("iou_bits_kernel", "attn_qkv_mma_kernel")}
    host = {k: v / n for k, v in demo.last_timing.items()}
    out["run2"] = {"frames_per_s": second["fps"], "processing_time_s": second["processing_time_s"],
                   "traced_wall_ms": wall_ms, "kernel_ms": kernel_ms, "device_busy_share": kernel_ms / wall_ms,
                   "kernels_by_name": by_name, "batches": chunks, "host_s_per_frame": host,
                   "lead_in_kept": sum(e.count for e in device if LEAD_IN in e.key)}
    if any(v != chunks for v in by_name.values()):
        failures.append(f"the traced run launched A and B {by_name}, not once per batch ({chunks})")
    card = card_line()
    emit({f"{prefix}_frames_per_s": second["fps"], "card": card})
    emit({f"{prefix}_host_s_per_frame": host, "card": card})
    emit({f"{prefix}_device_busy_share": kernel_ms / wall_ms, "card": card})
    return out, drawn


def phase_video(report):
    """The batched video demo on the card (phase 32): a port-written MJPEG
    AVI through `DetectionDemo.detect_video` at b8/640 bf16 (A, B), its
    detections against `predict_raw`, the output read back, segment video
    frame by frame (A, B, D), and where a run's time goes."""
    from yolo_infer_tpu_torch.core.model import YOLO11Model
    from yolo_infer_tpu_torch.data.avi import AviReader
    from yolo_infer_tpu_torch.data.jpeg import decode_jpeg, encode_jpeg
    from yolo_infer_tpu_torch.demos import detection_demo as demo_mod

    out = {"phase": "video", "card": card_line(), "frames": VIDEO_FRAMES, "size_hw": list(VIDEO_SIZE),
           "batch": VIDEO_SERVE[0], "imgsz": VIDEO_SERVE[1]}
    failures = []
    model = report["weights"][0] if "weights" in report else smoke_weights(
        np.random.default_rng(SEED + 2).integers(0, 256, (2, 480, 640, 3), dtype=np.uint8))[0]
    seg_model = (report.get("task_weights") or {}).get("segment", (None,))[0]
    if seg_model is None:
        seg_model = smoke_weights(np.random.default_rng(SEED + 6).integers(0, 256, (2, 480, 640, 3), dtype=np.uint8),
                                  "segment", TASK_NC["segment"])[0]
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_video_"))
    try:
        t0 = time.perf_counter()
        src = video_source(root)
        out["write_input_s"] = time.perf_counter() - t0
        out["input"] = AviReader(src).info()
        ckpts = {task: YOLO11Model.from_params(copy.deepcopy(m), task=task, size="n", fused=False,
                                               device="cpu").save(root / f"{task}.msgpack")
                 for task, m in (("detect", model), ("segment", seg_model))}
        imgsz = VIDEO_SERVE[1]
        demo = demo_mod.DetectionDemo(model_path=str(ckpts["detect"]), imgsz=imgsz)
        ran, drawn = check_video_demo(demo, src, root, ".avi", VIDEO_FRAMES, "video", "video", failures)
        out.update(ran)
        back = AviReader(root / "out.avi")
        n_back = sum(1 for _ in back.packets())
        first_back = next(back.read())
        out["first_frame_decoded_equal"] = bool(np.array_equal(drawn[0][4], next(AviReader(src).read())))
        out["output"] = {**back.info(), "frames_read": n_back,
                         "first_frame_equal": bool(np.array_equal(first_back, decode_jpeg(encode_jpeg(drawn[0][3]))))}
        if (n_back, back.frame_count, back.width, back.height) != (VIDEO_FRAMES, VIDEO_FRAMES, VIDEO_SIZE[1],
                                                                    VIDEO_SIZE[0]) \
                or not out["output"]["first_frame_equal"] or not out["first_frame_decoded_equal"]:
            failures.append(f"the output video read back: {out['output']}")
        # --- segment, frame by frame (predict and draw_results on each)
        seg = demo_mod.DetectionDemo(model_path=str(ckpts["segment"]), imgsz=imgsz)
        seg_counts, seg_run = path_counters(lambda: seg.detect_video(src, root / "seg.avi",
                                                                     max_frames=VIDEO_SEG_FRAMES))
        out["segment"] = {"frames": seg_run["total_frames"], "detections": seg_run["total_detections"],
                          "fps": seg_run["fps"], "launches": {k: seg_counts[k] for k in VIDEO_SEG_KERNELS},
                          "written": AviReader(root / "seg.avi").frame_count}
        if (seg_run["total_frames"] != VIDEO_SEG_FRAMES or out["segment"]["written"] != VIDEO_SEG_FRAMES
                or min(out["segment"]["launches"].values()) < 1):
            failures.append(f"segment video: {out['segment']}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    if failures:
        emit(out)
        raise AssertionError("; ".join(failures))
    return out


FORMATS_FRAMES = 32  # the mixed-format validation set: seeded 480x640 frames
FORMATS_SIZE = (480, 640)
FORMATS_SERVE = (16, 640)  # val: batch, imgsz (the demo at imgsz)
FORMATS_LEVELS = 6  # levels per channel of the frames' noise: 216 colours, so a palette holds them
FORMATS_KINDS = ("progressive.jpg", "palette.png", "rgb16.png", "lzw.tif", "lossless.webp", "lossy.webp",
                 "palette8.bmp")
FORMATS_VAL_KERNELS = ("dfl_decode", "greedy_nms_keep")  # F, G
FORMATS_DEMO_KERNELS = ("nms_keep", "attention_qkv")  # A, B


def formats_frame(seed: int) -> np.ndarray:
    """Uniform noise of FORMATS_LEVELS levels a channel (the smoke weights'
    batch norms were set on noise, as in phase 28), 480x640 RGB."""
    rng = np.random.default_rng(seed)
    return (rng.integers(0, FORMATS_LEVELS, FORMATS_SIZE + (3,)) * (255 // (FORMATS_LEVELS - 1))).astype(np.uint8)


def _packed_scan(codes, lengths) -> bytes:
    """Huffman-coded emits (code, bit length), most significant bit first,
    padded with 1 bits and byte-stuffed."""
    from yolo_infer_tpu_torch.data.jpeg import pack_msb_first, stuffed

    return stuffed(pack_msb_first(np.concatenate(codes), np.concatenate(lengths), pad_bit=1))


def progressive_jpeg(rgb: np.ndarray) -> bytes:
    """A progressive (SOF2) 4:2:0 JPEG of an RGB frame whose sides are
    multiples of 16: the port's encoder's quantised coefficients (quality
    95), sent as a DC first scan of the three components at Al = 1, its
    refine scan, and one AC scan (1..63) per component, with the Annex K
    tables. The card's machine has no OpenCV to write one."""
    from yolo_infer_tpu_torch.data import jpeg as J

    h, w = rgb.shape[:2]
    assert h % 16 == 0 and w % 16 == 0, (h, w)
    planes = J._rgb_to_ycc(rgb)
    coefs = []
    for i, (plane, qt) in enumerate(zip(planes, (J.LUMA_QT, J.CHROMA_QT, J.CHROMA_QT))):
        ds = J._downsample(plane, 1 if i == 0 else 2, w // (1 if i == 0 else 2))
        bh, bw = ds.shape[0] // 8, ds.shape[1] // 8
        blocks = (ds - 128).reshape(bh, 8, bw, 8).transpose(0, 2, 1, 3).reshape(-1, 8, 8)
        coefs.append(J._quantize(J._fdct_islow(blocks), qt).reshape(bh, bw, 64)[..., J.ZIGZAG])
    tabs = {k: J._code_table(k) for k in J.STD_HUFFMAN}
    mcuy, mcux = h // 16, w // 16
    # MCU order: four luma blocks (2x2), then Cb, then Cr
    y = coefs[0].reshape(mcuy, 2, mcux, 2, 64).transpose(0, 2, 1, 3, 4).reshape(mcuy * mcux, 4, 64)
    order = np.concatenate([y, coefs[1].reshape(-1, 1, 64), coefs[2].reshape(-1, 1, 64)], axis=1)
    comp = np.array([0, 0, 0, 0, 1, 2])
    dc = order[..., 0]
    scans = []
    # DC first, Al = 1: differences of dc >> 1 within each component, in MCU order
    first = dc >> 1
    codes, lengths = [], []
    diffs = np.empty_like(first)
    for c in range(3):
        seq = first[:, comp == c].reshape(-1)
        diffs[:, comp == c] = np.diff(seq, prepend=0).reshape(-1, int((comp == c).sum()))
    diffs = diffs.reshape(-1)
    size = J._bits_of(diffs)
    keys = np.tile(np.where(comp == 0, 0, 1), mcuy * mcux)
    dc_codes = np.where(keys == 0, tabs["dc_luma"][0][size], tabs["dc_chroma"][0][size])
    dc_lens = np.where(keys == 0, tabs["dc_luma"][1][size], tabs["dc_chroma"][1][size])
    codes.append((dc_codes << size) | ((diffs - (diffs < 0)) & ((1 << size) - 1)))
    lengths.append(dc_lens + size)
    scans.append((bytes([3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 0, 0x01]), _packed_scan(codes, lengths)))
    # DC refine, Ah = 1, Al = 0: the low bit of every DC, in MCU order
    low = (dc.reshape(-1) & 1).astype(np.int64)
    scans.append((bytes([3, 1, 0x00, 2, 0x00, 3, 0x00, 0, 0, 0x10]), _packed_scan([low], [np.ones_like(low)])))
    # AC first, 1..63, Al = 0, one component a scan in its own raster order: EOB0 ends a block
    for c, key in enumerate(("ac_luma", "ac_chroma", "ac_chroma")):
        zz = coefs[c].reshape(-1, 64)
        cd, ln = tabs[key]
        blk_e, slot_e, code_e, len_e = [], [], [], []
        b_idx, k_idx = np.nonzero(zz[:, 1:])
        k_idx = k_idx + 1
        vals = zz[b_idx, k_idx]
        start = np.ones(len(b_idx), bool)
        start[1:] = b_idx[1:] != b_idx[:-1]
        run = k_idx - np.where(start, 0, np.concatenate([[0], k_idx[:-1]])) - 1
        zrl = run // 16
        owner = np.repeat(np.arange(len(b_idx)), zrl)
        blk_e.append(b_idx[owner])
        slot_e.append(2 * k_idx[owner])
        code_e.append(np.full(len(owner), cd[0xF0]))
        len_e.append(np.full(len(owner), ln[0xF0]))
        size = J._bits_of(vals)
        sym = ((run % 16) << 4) | size
        blk_e.append(b_idx)
        slot_e.append(2 * k_idx + 1)
        code_e.append((cd[sym] << size) | ((vals - (vals < 0)) & ((1 << size) - 1)))
        len_e.append(ln[sym] + size)
        last = np.zeros(len(zz), np.int64)
        np.maximum.at(last, b_idx, k_idx)
        eob = np.flatnonzero(last < 63)
        blk_e.append(eob)
        slot_e.append(np.full(len(eob), 130))
        code_e.append(np.full(len(eob), cd[0x00]))
        len_e.append(np.full(len(eob), ln[0x00]))
        at = np.argsort(np.concatenate(blk_e) * 256 + np.concatenate(slot_e), kind="stable")
        scans.append((bytes([1, c + 1, 0x00 if c == 0 else 0x11, 1, 63, 0]),
                      _packed_scan([np.concatenate(code_e)[at]], [np.concatenate(len_e)[at]])))
    out = [b"\xff\xd8", J._segment(0xE0, b"JFIF\0" + bytes([1, 1, 0, 0, 1, 0, 1, 0, 0]))]
    for tq, qt in enumerate((J.LUMA_QT, J.CHROMA_QT)):
        out.append(J._segment(0xDB, bytes([tq]) + bytes(qt[J.ZIGZAG].astype(np.uint8).tolist())))
    sof = struct.pack(">BHHB", 8, h, w, 3) + bytes([1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1])
    out.append(J._segment(0xC2, sof))
    for tc, key in ((0x00, "dc_luma"), (0x10, "ac_luma"), (0x01, "dc_chroma"), (0x11, "ac_chroma")):
        counts, symbols = J.STD_HUFFMAN[key]
        out.append(J._segment(0xC4, bytes([tc]) + bytes.fromhex(counts) + bytes.fromhex(symbols)))
    for header, data in scans:
        out += [J._segment(0xDA, header), data]
    return b"".join(out + [b"\xff\xd9"])


def palette_of(rgb: np.ndarray):
    """(colours (n, 3), index of each pixel) of a frame of at most 256 colours."""
    packed = (rgb[..., 0].astype(np.int64) << 16) | (rgb[..., 1].astype(np.int64) << 8) | rgb[..., 2]
    keys, index = np.unique(packed.reshape(-1), return_inverse=True)
    assert len(keys) <= 256, len(keys)
    return np.stack([keys >> 16, (keys >> 8) & 255, keys & 255], axis=-1).astype(np.uint8), index


def palette_png(rgb: np.ndarray, depth16: bool = False) -> bytes:
    """An 8-bit palette PNG of a frame of at most 256 colours, or (with
    `depth16`) a 16-bit RGB PNG whose samples are v * 257 (read as v)."""
    from yolo_infer_tpu_torch.data.png import PNG_SIGNATURE, png_chunk

    h, w = rgb.shape[:2]
    if depth16:
        rows = (rgb.astype(np.uint16) * 257).astype(">u2").view(np.uint8).reshape(h, -1)
        head, extra = struct.pack(">IIBBBBB", w, h, 16, 2, 0, 0, 0), b""
    else:
        colours, index = palette_of(rgb)
        rows = index.reshape(h, w).astype(np.uint8)
        head, extra = struct.pack(">IIBBBBB", w, h, 8, 3, 0, 0, 0), png_chunk(b"PLTE", colours.tobytes())
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1).tobytes()
    return (PNG_SIGNATURE + png_chunk(b"IHDR", head) + extra + png_chunk(b"IDAT", zlib.compress(raw, 6))
            + png_chunk(b"IEND", b""))


def palette_bmp(rgb: np.ndarray) -> bytes:
    """An 8-bit palette BMP (BITMAPINFOHEADER, bottom-up) of a frame of at most 256 colours."""
    h, w = rgb.shape[:2]
    colours, index = palette_of(rgb)
    palette = np.zeros((len(colours), 4), np.uint8)
    palette[:, :3] = colours[:, ::-1]
    step = (w + 3) & ~3
    rows = np.zeros((h, step), np.uint8)
    rows[:, :w] = index.reshape(h, w)
    offset = 14 + 40 + palette.size
    return (b"BM" + struct.pack("<III", offset + rows.size, 0, offset)
            + struct.pack("<IiiHHIIiiII", 40, w, h, 1, 8, 0, rows.size, 0, 0, len(colours), 0)
            + palette.tobytes() + rows[::-1].tobytes())


def vp8_key_webp(index: int) -> bytes:
    """A lossy 480x640 WebP: key frame `index` (of 3, cyclically) of phase
    35's committed 640x480 WebM in a RIFF `VP8 ` chunk (the port has no VP8
    encoder, and the card's machine no OpenCV)."""
    from yolo_infer_tpu_torch.data.mkv import MkvReader

    keys = [p for p in MkvReader(VP8_FIXTURES / VP8_DEMO).packets() if not p[0] & 1]
    frame = keys[index % len(keys)]
    chunk = b"VP8 " + struct.pack("<I", len(frame)) + frame + b"\0" * (len(frame) & 1)
    return b"RIFF" + struct.pack("<I", 4 + len(chunk)) + b"WEBP" + chunk


def write_formats(path: Path, kind: str, rgb: np.ndarray, index: int = 0) -> None:
    """`rgb` in the format `kind`; a lossy WebP is `vp8_key_webp(index)`."""
    from yolo_infer_tpu_torch.data.loader import save_image

    path.parent.mkdir(parents=True, exist_ok=True)
    if kind == "lossy.webp":
        path.write_bytes(vp8_key_webp(index))
    elif kind == "progressive.jpg":
        path.write_bytes(progressive_jpeg(rgb))
    elif kind in ("palette.png", "rgb16.png"):
        path.write_bytes(palette_png(rgb, depth16=kind == "rgb16.png"))
    elif kind == "palette8.bmp":
        path.write_bytes(palette_bmp(rgb))
    else:
        save_image(path, rgb)  # the port's writers: LZW TIFF, lossless WebP


def phase_formats(report):
    """Every still-image format on the card's host (phase 33): the fixtures'
    manifest, the writers' round trips, `val` on a mixed-format dataset
    against its PNG copy (F, G) and the demo on progressive JPEG and
    lossless and lossy WebP against their PNG copies (A, B); the decoders'
    host seconds."""
    import hashlib
    from statistics import median

    import torch

    from yolo_infer_tpu_torch.core.model import YOLO11Model
    from yolo_infer_tpu_torch.data.loader import create_dataset_config, load_image, save_image

    here = Path(__file__).resolve().parent
    out = {"phase": "formats", "card": card_line()}
    failures = []
    # --- the decoders: every committed fixture to OpenCV's pixel hashes, and the refused kinds
    fixtures = here / "tests" / "torch_formats"
    manifest = json.loads((fixtures / "manifest.json").read_text())
    mismatched, wrong_error = [], []
    for name, entry in manifest["files"].items():
        img = load_image(fixtures / name, rgb=False)
        if (list(img.shape) != entry["shape"]
                or hashlib.sha256(np.ascontiguousarray(img).tobytes()).hexdigest() != entry["sha256"]):
            mismatched.append(name)
    for name, entry in manifest["raises"].items():
        try:
            load_image(fixtures / name)
            wrong_error.append((name, None))
        except (NotImplementedError, FileNotFoundError) as exc:
            if type(exc).__name__ != entry["error"]:
                wrong_error.append((name, type(exc).__name__))
    out["fixtures"] = {"files": len(manifest["files"]), "mismatched": mismatched, "refused": len(manifest["raises"]),
                       "wrong_error": wrong_error}
    if mismatched or wrong_error or len(manifest["files"]) < 60:
        failures.append(f"fixtures: {out['fixtures']}")
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_formats_"))
    launches = collections.Counter()
    runs = {}

    def cli(name, *argv):
        rc, parsed, seconds, counts, errors = run_cli(*argv)
        launches.update(counts)
        runs[name] = {"rc": rc, "seconds": seconds, "launches": counts}
        if rc != 0:
            failures.append(f"{name}: exit {rc} ({errors[-1:] or parsed})")
        return parsed

    try:
        # --- the writers: a seeded frame through .bmp, .tiff and .webp and back
        frame = formats_frame(SEED + 33)
        out["writers"] = {}
        for suffix in (".bmp", ".tiff", ".webp"):
            t0 = time.perf_counter()
            save_image(root / f"w{suffix}", frame)
            t1 = time.perf_counter()
            back = load_image(root / f"w{suffix}")
            out["writers"][suffix] = {"equal": bool(np.array_equal(back, frame)), "bytes": (root / f"w{suffix}").stat(
            ).st_size, "write_s": t1 - t0, "read_s": time.perf_counter() - t1}
        if not all(v["equal"] for v in out["writers"].values()):
            failures.append(f"writers' round trips: {out['writers']}")
        # --- decode times: one 480x640 frame in each format, median of 3
        decode_s = {}
        for kind in FORMATS_KINDS + ("baseline.jpg",):
            path = root / "timing" / f"f.{kind}"
            write_formats(path, kind, frame) if kind != "baseline.jpg" else save_image(path, frame)
            times = []
            for _ in range(3):
                t0 = time.perf_counter()
                load_image(path)
                times.append(time.perf_counter() - t0)
            decode_s[kind] = median(times)
        out["decode_s_480x640"] = decode_s
        emit({"formats_decode_s_480x640": decode_s, "card": out["card"]})
        # --- val: 32 frames in seven formats, then the same frames as the port decoded them, saved as PNG
        model = report["weights"][0] if "weights" in report else smoke_weights(
            np.random.default_rng(SEED + 2).integers(0, 256, (2, 480, 640, 3), dtype=np.uint8))[0]
        ckpt = YOLO11Model.from_params(copy.deepcopy(model), task="detect", size="n", fused=False,
                                       device="cpu").save(root / "smoke.msgpack")
        mixed, copy_dir = root / "mixed" / "images" / "val", root / "png" / "images" / "val"
        t0 = time.perf_counter()
        decoded, kinds = [], collections.Counter()
        for i in range(FORMATS_FRAMES):
            kind = FORMATS_KINDS[i % len(FORMATS_KINDS)]
            path = mixed / f"f{i:02d}{Path(kind).suffix}"
            write_formats(path, kind, formats_frame(SEED + 3300 + i), index=i)
            kinds[kind] += 1
        out["write_dataset_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        for path in sorted(mixed.iterdir()):
            img = load_image(path)
            decoded.append(img)
            save_image(copy_dir / f"{path.stem}.png", img, compress_level=1)
        out["decode_and_copy_s"] = time.perf_counter() - t0
        labelled = YOLO11Model(ckpt).predict(decoded, conf=0.25, imgsz=FORMATS_SERVE[1])
        for sub in ("mixed", "png"):
            labels = root / sub / "labels" / "val"
            labels.mkdir(parents=True)
            for path, r in zip(sorted(mixed.iterdir()), labelled):
                h, w = r.orig_shape
                rows = [f"{c} {(b[0] + b[2]) / 2 / w:.6f} {(b[1] + b[3]) / 2 / h:.6f} {(b[2] - b[0]) / w:.6f} "
                        f"{(b[3] - b[1]) / h:.6f}" for b, c in zip(r.boxes.clip(0, [w, h, w, h]), r.classes)]
                (labels / f"{path.stem}.txt").write_text("\n".join(rows) + "\n")
        vals = {}
        for sub in ("mixed", "png"):
            images = root / sub / "images" / "val"
            data = create_dataset_config(root / sub / "data.yaml", str(images), str(images),
                                         {c: str(c) for c in range(80)})
            vals[sub] = cli(f"val_{sub}", "val", "--data", data, "--batch", FORMATS_SERVE[0], "--imgsz",
                            FORMATS_SERVE[1], "--model-path", ckpt, "--output-dir", root / f"vout_{sub}")
        if all(isinstance(v, dict) for v in vals.values()):
            m, p = ({k: float(x) for k, x in vals[s]["metrics"].items()} for s in ("mixed", "png"))
            out["val"] = {"images": {s: vals[s]["num_images"] for s in vals}, "kinds": dict(kinds),
                          "labels": sum(len(r) for r in labelled), "metrics_mixed": m, "metrics_png": p,
                          "images_per_s_wall": {s: FORMATS_FRAMES / runs[f"val_{s}"]["seconds"] for s in vals},
                          "launches": {s: {k: runs[f"val_{s}"]["launches"].get(k, 0) for k in FORMATS_VAL_KERNELS}
                                       for s in vals}}
            if m != p or any(n != FORMATS_FRAMES for n in out["val"]["images"].values()):
                failures.append(f"val over the mixed formats differs from val over their PNG copies: {out['val']}")
            if min(out["val"]["launches"]["mixed"].values()) < 1:
                failures.append(f"val over the mixed formats launched F or G no time: {out['val']['launches']}")
        # --- demo: a progressive JPEG and a lossless and a lossy WebP of one frame, each against the PNG copy
        # of its decode
        demo_frame = formats_frame(SEED + 3399)
        out["demo"] = {}
        for kind in ("progressive.jpg", "lossless.webp", "lossy.webp"):
            src = root / "demo" / f"d.{kind}"
            write_formats(src, kind, demo_frame)
            save_image(root / "demo" / f"{kind}.png", load_image(src))
            got = cli(f"demo_{kind}", "demo", "--input", src, "--model-path", ckpt, "--imgsz", FORMATS_SERVE[1])
            want = cli(f"demo_{kind}_png", "demo", "--input", root / "demo" / f"{kind}.png", "--model-path", ckpt,
                       "--imgsz", FORMATS_SERVE[1])
            if isinstance(got, dict) and isinstance(want, dict):
                g, w = _dets(got), _dets(want)
                equal = len(g) == len(w) and bool(np.array_equal(g.boxes, w.boxes) and np.array_equal(
                    g.scores, w.scores) and np.array_equal(g.classes, w.classes))
                out["demo"][kind] = {"detections": len(g), "png_detections": len(w), "bit_equal": equal,
                                     "launches": {k: runs[f"demo_{kind}"]["launches"].get(k, 0)
                                                  for k in FORMATS_DEMO_KERNELS}}
                unmatched = match_detections(g, w, 1e-3, 1e-5)[0] if len(g) == len(w) else None
                if not len(g) or unmatched != 0:
                    failures.append(f"demo on {kind} differs from the demo on its PNG copy: {out['demo'][kind]}")
                if min(out["demo"][kind]["launches"].values()) < 1:
                    failures.append(f"demo on {kind} launched A or B no time: {out['demo'][kind]}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out["runs"] = runs
    out["launches"] = {k: launches[k] for k in FORMATS_VAL_KERNELS + FORMATS_DEMO_KERNELS}
    if failures:
        emit(out)
        raise AssertionError("; ".join(failures))
    return out


MPEG4_FIXTURES = Path(__file__).resolve().parent / "tests" / "torch_video"
MPEG4_DEMO = "mp4v_640x480_30.mp4"  # the committed 640x480 I- and P-VOP fixture the demo runs over
MPEG4_ROUND_TRIP = 30  # phase 32's seeded 640x480 frames, written to .mp4 by the port and read back


def median_s(fn, reps: int = 3) -> float:
    """Median host seconds of `fn()` over `reps` calls."""
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return sorted(times)[len(times) // 2]


def phase_mpeg4(report):
    """MPEG-4 Part 2 video on the card's host (phase 34): the committed
    fixtures against their manifest, the refused files, a port-written
    round trip, the batched detect video demo over a committed P-VOP file
    (A, B) with MP4 output, and the host's decode and encode seconds."""
    import hashlib

    from yolo_infer_tpu_torch.core.model import YOLO11Model
    from yolo_infer_tpu_torch.data.loader import get_video_info, load_video
    from yolo_infer_tpu_torch.data.mp4 import Mp4Reader
    from yolo_infer_tpu_torch.data.mpeg4 import Mpeg4Decoder, Mpeg4Encoder
    from yolo_infer_tpu_torch.data.video import open_video
    from yolo_infer_tpu_torch.demos import detection_demo as demo_mod
    from yolo_infer_tpu_torch.utils.visualization import create_video_writer

    out = {"phase": "mpeg4", "card": card_line()}
    failures = []
    manifest = json.loads((MPEG4_FIXTURES / "manifest.json").read_text())
    # --- the fixtures and the refused files
    t0 = time.perf_counter()
    for name, want in manifest["files"].items():
        reader = open_video(MPEG4_FIXTURES / name)
        hashes = [hashlib.sha256(f.tobytes()).hexdigest() for f in reader.read(rgb=False)]
        if hashes != want["frames"] or reader.info() != want["info"]:
            failures.append(f"{name}: {sum(a != b for a, b in zip(hashes, want['frames']))} frames differ, "
                            f"{len(hashes)} decoded of {len(want['frames'])}, info {reader.info()}")
    for name, want in manifest["raises"].items():
        for read in (get_video_info, load_video):
            try:
                read(MPEG4_FIXTURES / name)
                failures.append(f"{name}: {read.__name__} did not raise")
            except Exception as exc:  # noqa: BLE001 -- the manifest names the type
                if type(exc).__name__ != want["error"] or not re.search(want["match"], str(exc)):
                    failures.append(f"{name}: {read.__name__} raised {exc!r}, not {want['error']} "
                                    f"/{want['match']}/")
    out["fixtures"] = {"videos": len(manifest["files"]), "refused": len(manifest["raises"]),
                       "raw_i420": sorted(n for n in manifest["files"] if n.startswith(("i420", "iyuv"))),
                       "seconds": time.perf_counter() - t0}
    if len(out["fixtures"]["raw_i420"]) < 3:
        failures.append(f"the manifest lists {out['fixtures']['raw_i420']} raw I420 AVIs, not 3")
    # --- the host's decode and encode seconds at 640x480 (median of 3)
    demo_src = MPEG4_FIXTURES / MPEG4_DEMO
    reader = Mp4Reader(demo_src)
    first_two = list(reader.packets())[:2]
    times = {"i_vop": [], "p_vop": []}
    for _ in range(3):
        decoder = Mpeg4Decoder(reader.config)
        for kind, packet in zip(("i_vop", "p_vop"), first_two):
            t0 = time.perf_counter()
            decoder.decode(packet)
            times[kind].append(time.perf_counter() - t0)
    decode_s = {k: sorted(v)[1] for k, v in times.items()}
    frame = jpeg_frame(300, 480, 640)[..., ::-1].copy()
    encoder = Mpeg4Encoder(640, 480, 30)
    encode_s = median_s(lambda: encoder.encode(frame))
    out["host_s"] = {"decode_640x480": decode_s, "encode_640x480": encode_s}
    emit({"mpeg4_decode_s_640x480": decode_s, "card": out["card"]})
    emit({"mpeg4_encode_s_640x480": encode_s, "card": out["card"]})
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_mpeg4_"))
    try:
        # --- the round trip: the port writes .mp4, the port reads it back
        t0 = time.perf_counter()
        writer = create_video_writer(root / "rt.mp4", 30, (640, 480))
        recon = []
        for i in range(MPEG4_ROUND_TRIP):
            writer.write(jpeg_frame(300 + i, 480, 640)[..., ::-1])
            recon.append(writer.encoder.reconstruction)
        writer.release()
        back = list(load_video(root / "rt.mp4", rgb=False))
        differ = [i for i, (a, b) in enumerate(zip(back, recon)) if not np.array_equal(a, b)]
        out["round_trip"] = {**get_video_info(root / "rt.mp4"), "frames_read": len(back), "frames_differing": differ,
                             "bytes": (root / "rt.mp4").stat().st_size, "seconds": time.perf_counter() - t0}
        if differ or len(back) != MPEG4_ROUND_TRIP or out["round_trip"]["frame_count"] != MPEG4_ROUND_TRIP:
            failures.append(f"round trip: {out['round_trip']}")
        # --- the demo over the committed fixture, .mp4 out
        model = report["weights"][0] if "weights" in report else smoke_weights(
            np.random.default_rng(SEED + 2).integers(0, 256, (2, 480, 640, 3), dtype=np.uint8))[0]
        ckpt = YOLO11Model.from_params(copy.deepcopy(model), task="detect", size="n", fused=False,
                                       device="cpu").save(root / "detect.msgpack")
        demo = demo_mod.DetectionDemo(model_path=str(ckpt), imgsz=VIDEO_SERVE[1])
        n = manifest["files"][MPEG4_DEMO]["info"]["frame_count"]
        ran, drawn = check_video_demo(demo, demo_src, root, ".mp4", n, "mpeg4", "mpeg4_video", failures)
        out.update(ran)
        hashes = [hashlib.sha256(f[..., ::-1].tobytes()).hexdigest() for _, _, _, _, f in drawn]
        out["decoded_as_manifest"] = hashes == manifest["files"][MPEG4_DEMO]["frames"]
        reencode = Mpeg4Encoder(640, 480, 30)
        reencode.encode(np.ascontiguousarray(drawn[0][3][..., ::-1]))
        written = open_video(root / "out.mp4")
        out["output"] = {**written.info(), "frames_read": sum(1 for _ in written.read()),
                         "first_frame_equal": bool(np.array_equal(next(written.read(rgb=False)),
                                                                  reencode.reconstruction))}
        if (out["output"]["frames_read"], written.frame_count, written.width, written.height) != (n, n, 640, 480) \
                or not out["output"]["first_frame_equal"] or not out["decoded_as_manifest"]:
            failures.append(f"the output video read back: {out['output']}; decoded as the manifest: "
                            f"{out['decoded_as_manifest']}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    if failures:
        emit(out)
        raise AssertionError("; ".join(failures))
    return out


VP8_FIXTURES = Path(__file__).resolve().parent / "tests" / "torch_vp8"
VP8_DEMO = "vp8_640x480_30.webm"  # the committed 640x480 WebM the demo runs over (key frames 0, 12, 21)


def phase_vp8(report):
    """VP8 on the card's host (phase 35): the WebM fixtures against their
    manifest, the refused files, the host's decode seconds of a 640x480 key
    frame, an inter frame and a lossy WebP, and the batched detect video
    demo over the committed 640x480 WebM (A, B) with MP4 output."""
    import hashlib

    from yolo_infer_tpu_torch.core.model import YOLO11Model
    from yolo_infer_tpu_torch.data.loader import get_video_info, load_video
    from yolo_infer_tpu_torch.data.mkv import MkvReader
    from yolo_infer_tpu_torch.data.mpeg4 import Mpeg4Encoder
    from yolo_infer_tpu_torch.data.video import open_video
    from yolo_infer_tpu_torch.data.vp8 import Vp8Decoder
    from yolo_infer_tpu_torch.data.webp import decode_webp
    from yolo_infer_tpu_torch.demos import detection_demo as demo_mod

    out = {"phase": "vp8", "card": card_line()}
    failures = []
    manifest = json.loads((VP8_FIXTURES / "manifest.json").read_text())
    # --- the fixtures (the demo file decoded whole too) and the refused files
    out["fixtures"] = {}
    for name, want in manifest["files"].items():
        t0 = time.perf_counter()
        reader = open_video(VP8_FIXTURES / name)
        hashes = [hashlib.sha256(f.tobytes()).hexdigest() for f in reader.read(rgb=False)]
        seconds = time.perf_counter() - t0
        out["fixtures"][name] = {"frames": len(hashes), "seconds": seconds, "frames_per_s": len(hashes) / seconds}
        if hashes != want["frames"] or reader.info() != want["info"]:
            failures.append(f"{name}: {sum(a != b for a, b in zip(hashes, want['frames']))} frames differ, "
                            f"{len(hashes)} decoded of {len(want['frames'])}, info {reader.info()}")
    for name, want in manifest["raises"].items():
        for read in (get_video_info, load_video):
            try:
                read(VP8_FIXTURES / name)
                failures.append(f"{name}: {read.__name__} did not raise")
            except Exception as exc:  # noqa: BLE001 -- the manifest names the type
                if type(exc).__name__ != want["error"] or not re.search(want["match"], str(exc)):
                    failures.append(f"{name}: {read.__name__} raised {exc!r}, not {want['error']} "
                                    f"/{want['match']}/")
    out["refused"] = len(manifest["raises"])
    emit({"vp8_demo_file_decode_frames_per_s": out["fixtures"][VP8_DEMO]["frames_per_s"], "card": out["card"]})
    # --- the host's decode seconds at 640x480 (median of 3)
    demo_src = VP8_FIXTURES / VP8_DEMO
    first_two = list(MkvReader(demo_src).packets())[:2]
    times = {"key_frame": [], "inter_frame": []}
    for _ in range(3):
        decoder = Vp8Decoder()
        for kind, packet in zip(times, first_two):
            t0 = time.perf_counter()
            decoder.decode(packet)
            times[kind].append(time.perf_counter() - t0)
    decode_s = {k: sorted(v)[1] for k, v in times.items()}
    lossy = vp8_key_webp(0)
    decode_s["lossy_webp_480x640"] = median_s(lambda: decode_webp(lossy))
    out["host_s"] = {"decode_640x480": decode_s}
    emit({"vp8_decode_s_640x480": decode_s, "card": out["card"]})
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_vp8_"))
    try:
        # --- the demo over the committed 640x480 WebM, .mp4 out
        model = report["weights"][0] if "weights" in report else smoke_weights(
            np.random.default_rng(SEED + 2).integers(0, 256, (2, 480, 640, 3), dtype=np.uint8))[0]
        ckpt = YOLO11Model.from_params(copy.deepcopy(model), task="detect", size="n", fused=False,
                                       device="cpu").save(root / "detect.msgpack")
        demo = demo_mod.DetectionDemo(model_path=str(ckpt), imgsz=VIDEO_SERVE[1])
        n = manifest["files"][VP8_DEMO]["info"]["frame_count"]
        ran, drawn = check_video_demo(demo, demo_src, root, ".mp4", n, "vp8", "vp8_video", failures)
        out.update(ran)
        hashes = [hashlib.sha256(f[..., ::-1].tobytes()).hexdigest() for _, _, _, _, f in drawn]
        out["decoded_as_manifest"] = hashes == manifest["files"][VP8_DEMO]["frames"]
        reencode = Mpeg4Encoder(640, 480, 30)
        reencode.encode(np.ascontiguousarray(drawn[0][3][..., ::-1]))
        written = open_video(root / "out.mp4")
        out["output"] = {**written.info(), "frames_read": sum(1 for _ in written.read()),
                         "first_frame_equal": bool(np.array_equal(next(written.read(rgb=False)),
                                                                  reencode.reconstruction))}
        if (out["output"]["frames_read"], written.frame_count, written.width, written.height) != (n, n, 640, 480) \
                or not out["output"]["first_frame_equal"] or not out["decoded_as_manifest"]:
            failures.append(f"the output video read back: {out['output']}; decoded as the manifest: "
                            f"{out['decoded_as_manifest']}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    if failures:
        emit(out)
        raise AssertionError("; ".join(failures))
    return out


SCRIPTS_BENCH = (32, 640, 20)  # benchmark: batch, imgsz, runs a timing window (three windows a model)
SCRIPTS_VAL = (16, 640)  # val_matrix: batch, imgsz
SCRIPTS_KINDS = ("bilevel.tif", "ccitt_rle.tif", "ccitt_g3.tif", "ccitt_g3_2d.tif", "ccitt_g4.tif",
                 "jpeg_ycc.tif", "prog_cut.jpg")  # the still kinds the port reads since phase 36
SCRIPTS_FRAMES = 14  # val_matrix's 480x640 frames, two of each kind
SCRIPTS_TRAIN = (16, 640)  # train: batch, imgsz
SCRIPTS_TRAIN_FRAMES = (16, 8)  # train: rectangle frames (one b16 step, one validation batch)
SCRIPTS_VAL_KERNELS = ("dfl_decode", "greedy_nms_keep")  # F, G
DYNAMIC_E_LAUNCHES = 72  # kernel E launches of one dynamic-int8 yolo11n call (phase 30)


def run_script(name: str, *argv):
    """`python -m yolo_infer_tpu_torch.scripts.<name> argv` in this process:
    (exit code, stdout, host seconds, the kernel launches of the run)."""
    import contextlib
    import importlib
    import io

    import torch

    module = importlib.import_module(f"yolo_infer_tpu_torch.scripts.{name}")
    buf = io.StringIO()
    reset_counters()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = module.main([str(a) for a in argv])
    torch.cuda.synchronize()
    return rc, buf.getvalue(), time.perf_counter() - t0, {k: v for k, v in read_counters().items() if v}


def tiff_file(width: int, height: int, tags: dict, units) -> bytes:
    """A little-endian one-page TIFF: `tags` {tag: (type 3 or 4, values)};
    `units` the strips' bytes (their offsets and counts filled in)."""
    body, offsets = b"", []
    for u in units:
        offsets.append(8 + len(body))
        body += u + b"\0" * (len(u) & 1)
    tags = {256: (4, [width]), 257: (4, [height]), **tags, 273: (4, offsets), 279: (4, [len(u) for u in units])}
    entries = sorted(tags.items())
    ifd_at = 8 + len(body)
    extra_at = ifd_at + 2 + 12 * len(entries) + 4
    ifd, extra = struct.pack("<H", len(entries)), b""
    for tag, (typ, vals) in entries:
        packed = struct.pack("<" + {3: "H", 4: "I"}[typ] * len(vals), *vals)
        if len(packed) <= 4:
            ifd += struct.pack("<HHI", tag, typ, len(vals)) + packed.ljust(4, b"\0")
        else:
            ifd += struct.pack("<HHII", tag, typ, len(vals), extra_at + len(extra))
            extra += packed
    return b"II*\0" + struct.pack("<I", ifd_at) + body + ifd + struct.pack("<I", 0) + extra


def _changes(row) -> list:
    """A row of 0 (white) and 1 (black) -> its changing elements, then the
    row's width three times (T.4 4.2's b1, b2 past the end)."""
    w = len(row)
    return (np.flatnonzero(np.diff(np.concatenate([[0], row]).astype(np.int8))).tolist()) + [w] * 3


def _run_code(n: int, black: int, codes) -> str:
    """One run as T.4 codes it: make-up codes (2560 while more is left),
    then a terminating code."""
    out = []
    while n >= 2624:
        out.append(codes[black][2560])
        n -= 2560
    if n >= 64:
        out.append(codes[black][n // 64 * 64])
    return "".join(out) + codes[black][n % 64]


def ccitt_encode(bits: np.ndarray, compression: int, two_d: bool = False) -> bytes:
    """(h, w) bits (1 black) as one strip of CCITT compression 2 (rows
    one-dimensional from byte boundaries), 3 (an EOL before each row; with
    `two_d`, T4Options bit 0: a tag bit, every second row two-dimensional)
    or 4 (T.6: every row two-dimensional, EOFB last). The card's machine has
    no libtiff to write one."""
    from yolo_infer_tpu_torch.data.ccitt_tables import EOL, MODES, run_codes

    codes = [{v: k for k, v in run_codes(b).items()} for b in (False, True)]
    mode = {v: k for k, v in MODES.items()}
    out, ref = [], [bits.shape[1]] * 3
    for y, row in enumerate(bits):
        cur = _changes(row)
        w = len(row)
        one_d = compression == 2 or (compression == 3 and (not two_d or y % 2 == 0))
        if compression == 3:
            out.append(EOL + ("" if not two_d else "1" if one_d else "0"))
        if one_d:
            runs = np.diff([0] + [c for c in cur if c < w] + [w]).tolist()
            out.extend(_run_code(n, k & 1, codes) for k, n in enumerate(runs))
        else:
            a0, black = -1, 0
            while a0 < w:
                a1 = next(c for c in cur if c > a0) if a0 >= 0 else cur[0]
                a2 = next((c for c in cur if c > a1), w)
                j = next(i for i, c in enumerate(ref) if c > a0)
                i = j + ((j & 1) != black)
                b1, b2 = ref[i], ref[i + 1]
                if b2 < a1:
                    out.append(mode["P"])
                    a0 = b2
                elif abs(a1 - b1) <= 3:
                    out.append(mode[a1 - b1])
                    a0, black = a1, black ^ 1
                else:
                    out.append(mode["H"] + _run_code(a1 - max(a0, 0), black, codes)
                               + _run_code(a2 - a1, black ^ 1, codes))
                    a0 = a2
        if compression == 2:
            out.append("0" * (-sum(map(len, out)) % 8))
        ref = cur
    if compression == 4:
        out.append(EOL * 2)
    text = "".join(out)
    text += "0" * (-len(text) % 8)
    return int(text, 2).to_bytes(len(text) // 8, "big") if text else b""


def packbits(data: bytes) -> bytes:
    """PackBits (TIFF compression 32773)."""
    out, i = bytearray(), 0
    while i < len(data):
        n = 1
        while i + n < len(data) and data[i + n] == data[i] and n < 128:
            n += 1
        if n >= 2:
            out += bytes([257 - n, data[i]])
            i += n
            continue
        j = i
        while j < len(data) and j - i < 128 and not (j + 1 < len(data) and data[j] == data[j + 1]):
            j += 1
        out += bytes([j - i - 1]) + data[i:j]
        i = j
    return bytes(out)


def write_new_kind(path: Path, kind: str, rgb: np.ndarray):
    """`rgb` (480x640) in one of SCRIPTS_KINDS; returns the pixels the port
    must decode for a bilevel kind (exact), else None."""
    from yolo_infer_tpu_torch.data.jpeg import encode_jpeg

    h, w = rgb.shape[:2]
    path.parent.mkdir(parents=True, exist_ok=True)
    # bilevel: the frame's 4x4 blocks thresholded (runs for the fax codes)
    bits = (rgb[::4, ::4].mean(-1) > 127).repeat(4, 0).repeat(4, 1)[:h, :w].astype(np.uint8)
    if kind == "bilevel.tif":  # 1-bit min-is-black, PackBits
        rows = np.packbits(bits, axis=1)
        path.write_bytes(tiff_file(w, h, {258: (3, [1]), 259: (3, [32773]), 262: (3, [1]), 278: (4, [h])},
                                   [packbits(rows.tobytes())]))
        return np.repeat((bits * 255)[..., None], 3, -1)
    if kind.startswith("ccitt"):  # min-is-white: a set bit is black
        compression = {"ccitt_rle.tif": 2, "ccitt_g3.tif": 3, "ccitt_g3_2d.tif": 3, "ccitt_g4.tif": 4}[kind]
        two_d = kind == "ccitt_g3_2d.tif"
        tags = {258: (3, [1]), 259: (3, [compression]), 262: (3, [0]), 278: (4, [h])}
        if two_d:
            tags[292] = (4, [1])
        path.write_bytes(tiff_file(w, h, tags, [ccitt_encode(bits, compression, two_d)]))
        return np.repeat(((1 - bits) * 255)[..., None], 3, -1).astype(np.uint8)
    if kind == "jpeg_ycc.tif":  # strips of 16 rows, each a 4:2:0 JPEG stream of the port's encoder
        path.write_bytes(tiff_file(w, h, {258: (3, [8, 8, 8]), 259: (3, [7]), 262: (3, [6]), 277: (3, [3]),
                                          278: (4, [16]), 530: (3, [2, 2])},
                                   [encode_jpeg(rgb[y: y + 16]) for y in range(0, h, 16)]))
        return None
    full = progressive_jpeg(rgb)  # cut after its DC scans and the luma AC scan: the chroma smoothed
    sos = [i for i in range(len(full) - 1) if full[i: i + 2] == b"\xff\xda"]
    path.write_bytes(full[: sos[3]] + b"\xff\xd9")
    return None


def phase_scripts(report):
    """The repo's scripts as the port runs them (phase 36): benchmark with
    --int8, export_dynamic, val_matrix over the new still kinds, train (QAT)
    and its refusal of an int8 file; see the module docstring."""
    import torch

    from yolo_infer_tpu_torch.core.graphs import WARMUP_CALLS
    from yolo_infer_tpu_torch.core.model import YOLO11Model
    from yolo_infer_tpu_torch.core.validator import YOLO11Validator
    from yolo_infer_tpu_torch.data.loader import create_dataset_config, load_image
    from yolo_infer_tpu_torch.optimization.quantization.quantizers import DynamicQuantizer

    out = {"phase": "scripts", "card": card_line()}
    failures = []
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_scripts_"))
    cwd = os.getcwd()
    os.chdir(root)  # the scripts write validation_results/ and runs/ where they run
    try:
        model = report["weights"][0] if "weights" in report else smoke_weights(
            np.random.default_rng(SEED + 2).integers(0, 256, (2, 480, 640, 3), dtype=np.uint8))[0]
        ckpt = YOLO11Model.from_params(copy.deepcopy(model), task="detect", size="n", fused=False,
                                       device="cpu").save(root / "smoke.msgpack")
        batch, imgsz, runs = SCRIPTS_BENCH
        frames = np.random.default_rng(SEED + 36).integers(0, 256, (batch, imgsz, imgsz, 3), dtype=np.uint8)
        # --- benchmark: each model's run counted apart (the script benchmarks bf16, then dynamic int8)
        per_run = []
        benchmark = YOLO11Model.benchmark

        def counted(self, *args, **kwargs):
            reset_counters()
            result = benchmark(self, *args, **kwargs)
            torch.cuda.synchronize()
            per_run.append(read_counters())
            return result

        YOLO11Model.benchmark = counted
        try:
            rc, text, seconds, _ = run_script("benchmark", ckpt, "--imgsz", imgsz, "--batch", batch, "--runs", runs,
                                              "--int8")
        finally:
            YOLO11Model.benchmark = benchmark
        parsed = json.loads(text)
        bf16_model = YOLO11Model(ckpt)
        qmodel = DynamicQuantizer(YOLO11Model(ckpt)).optimize()
        body = {}
        for name, m in (("bf16", bf16_model), ("int8_dynamic", qmodel)):
            reset_counters()
            eager_run(m.predictor, frames, imgsz)
            body[name] = read_counters()
        out["benchmark"] = {
            "rc": rc, "keys": list(parsed), "seconds": seconds, "speedup": parsed.get("speedup"),
            "img_s": {k: parsed[k]["fps"] for k in ("bf16", "int8_dynamic") if k in parsed},
            "avg_time_ms": {k: parsed[k]["avg_time_s"] * 1e3 for k in ("bf16", "int8_dynamic") if k in parsed},
            "launches": {"bf16": {k: per_run[0][k] for k in ("nms_keep", "attention_qkv", "int8_conv")},
                         "int8_dynamic": {k: per_run[1][k] for k in ("nms_keep", "attention_qkv", "int8_conv")}},
            "launches_per_call": {"bf16": {k: body["bf16"][k] for k in ("nms_keep", "attention_qkv")},
                                  "int8_dynamic": body["int8_dynamic"]["int8_conv"]}}
        emit({"scripts_benchmark_b32_640": out["benchmark"], "card": out["card"]})
        if rc != 0 or list(parsed) != ["bf16", "int8_dynamic", "speedup"]:
            failures.append(f"benchmark: exit {rc}, keys {list(parsed)}")
        for k in ("nms_keep", "attention_qkv"):
            if not body["bf16"][k] or per_run[0][k] != (1 + WARMUP_CALLS) * body["bf16"][k]:
                failures.append(f"benchmark bf16: {k} {per_run[0][k]} launches, {body['bf16'][k]} a call")
        if (body["int8_dynamic"]["int8_conv"] != DYNAMIC_E_LAUNCHES or per_run[0]["int8_conv"]
                or per_run[1]["int8_conv"] != (1 + WARMUP_CALLS) * DYNAMIC_E_LAUNCHES):
            failures.append(f"benchmark int8: E {per_run[1]['int8_conv']} launches in the run, "
                            f"{body['int8_dynamic']['int8_conv']} a call, {per_run[0]['int8_conv']} in bf16's")
        # --- export_dynamic: the file reloaded serves as the quantizer's own model does, bit for bit
        rc, text, seconds, _ = run_script("export_dynamic", ckpt, "--output", root / "int8.msgpack")
        reloaded = YOLO11Model(root / "int8.msgpack")
        frames_dev = torch.from_numpy(frames).cuda()
        got = reloaded.predictor.predict_raw(frames_dev, 0.25, 0.45, imgsz)
        want = qmodel.predictor.predict_raw(frames_dev, 0.25, 0.45, imgsz)
        equal = got.keys() == want.keys() and all(torch.equal(got[k], want[k]) for k in want)
        out["export_dynamic"] = {"rc": rc, "printed": text.strip(), "seconds": seconds,
                                 "quant_mode": reloaded.predictor.quant_mode, "predict_raw_bit_equal": equal,
                                 "detections": int(want["num"].sum()),
                                 "info_json": (root / "int8.info.json").exists()}
        if (rc != 0 or not equal or reloaded.predictor.quant_mode != "dynamic" or not re.search(
                r"compression \d+\.\d\dx", text) or not out["export_dynamic"]["info_json"]):
            failures.append(f"export_dynamic: {out['export_dynamic']}")
        del reloaded, qmodel, bf16_model
        # --- val_matrix over the new still kinds, against a direct validate in this process
        images = root / "val" / "images" / "val"
        exact, decoded, kinds = [], [], collections.Counter()
        t0 = time.perf_counter()
        for i in range(SCRIPTS_FRAMES):
            kind = SCRIPTS_KINDS[i % len(SCRIPTS_KINDS)]
            path = images / f"f{i:02d}{Path(kind).suffix}"
            want_px = write_new_kind(path, kind, formats_frame(SEED + 3600 + i))
            kinds[kind] += 1
            img = load_image(path)
            decoded.append(img)
            if img.shape != (480, 640, 3) or (want_px is not None and not np.array_equal(img, want_px)):
                exact.append(path.name)
        out["write_and_decode_s"] = time.perf_counter() - t0
        labelled = YOLO11Model(ckpt).predict(decoded, conf=0.25, imgsz=SCRIPTS_VAL[1])
        labels = root / "val" / "labels" / "val"
        labels.mkdir(parents=True)
        for path, r in zip(sorted(images.iterdir()), labelled):
            h, w = r.orig_shape
            rows = [f"{c} {(b[0] + b[2]) / 2 / w:.6f} {(b[1] + b[3]) / 2 / h:.6f} {(b[2] - b[0]) / w:.6f} "
                    f"{(b[3] - b[1]) / h:.6f}" for b, c in zip(r.boxes.clip(0, [w, h, w, h]), r.classes)]
            (labels / f"{path.stem}.txt").write_text("\n".join(rows) + "\n")
        data = create_dataset_config(root / "val" / "data.yaml", str(images), str(images),
                                     {c: str(c) for c in range(80)})
        rc, text, seconds, launches = run_script("val_matrix", ckpt, "--data", data, "--imgsz", SCRIPTS_VAL[1],
                                                 "--batch", SCRIPTS_VAL[0])
        metrics = json.loads(text[: text.rindex("confusion matrix written")]) if rc == 0 else {}
        matrix = (root / "validation_results" / "confusion_matrix.txt").read_text() if rc == 0 else ""
        direct = YOLO11Validator(model_path=str(ckpt), output_dir=root / "direct").validate(
            data, imgsz=SCRIPTS_VAL[1], batch=SCRIPTS_VAL[0], confusion_matrix=True)
        out["val_matrix"] = {
            "rc": rc, "seconds": seconds, "images_per_s_wall": SCRIPTS_FRAMES / seconds, "kinds": dict(kinds),
            "labels": sum(len(r) for r in labelled), "metrics": metrics,
            "metrics_equal_direct": metrics == json.loads(json.dumps(direct["metrics"])),
            "matrix_equal_direct": matrix == (root / "direct" / "confusion_matrix.txt").read_text(),
            "decoded_wrong": exact, "launches": {k: launches.get(k, 0) for k in SCRIPTS_VAL_KERNELS}}
        v = out["val_matrix"]
        if rc != 0 or exact or not v["metrics_equal_direct"] or not v["matrix_equal_direct"] or not v["labels"]:
            failures.append(f"val_matrix: {v}")
        if min(v["launches"].values()) < 1:
            failures.append(f"val_matrix launched F or G no time: {v['launches']}")
        # --- train: one QAT epoch from the float file; the int8 file refused before any step
        data = write_rect_dataset(root / "rects", SEED + 36, SCRIPTS_TRAIN_FRAMES)
        argv = ("--data", data, "--epochs", 1, "--batch", SCRIPTS_TRAIN[0], "--imgsz", SCRIPTS_TRAIN[1])
        rc, text, seconds, launches = run_script("train", ckpt, *argv)
        summary = json.loads(text[text.index("{"):]) if rc == 0 else {}
        run_dir = Path(summary.get("run_dir", root / "missing"))
        out["train"] = {"rc": rc, "seconds": seconds, "summary": summary,
                        "checkpoints": sorted(p.name for p in (run_dir / "checkpoints").glob("*")),
                        "launches": {k: launches.get(k, 0) for k in SCRIPTS_VAL_KERNELS}}
        if (rc != 0 or summary.get("status") != "completed" or summary.get("epochs_completed") != 1
                or not out["train"]["checkpoints"] or "history" in summary):
            failures.append(f"train: {out['train']}")
        try:
            run_script("train", root / "int8.msgpack", *argv)
            out["train"]["int8_refused"] = None
        except ValueError as exc:
            out["train"]["int8_refused"] = str(exc)
        if "fused deploy checkpoint, int8" not in (out["train"]["int8_refused"] or ""):
            failures.append(f"train did not refuse the int8 file: {out['train']['int8_refused']}")
    finally:
        os.chdir(cwd)
        shutil.rmtree(root, ignore_errors=True)
    if failures:
        emit(out)
        raise AssertionError("; ".join(failures))
    return out


def main() -> int:
    faulthandler.enable(all_threads=True)  # a crash in native code prints where each thread was
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        import yolo_infer_tpu_torch  # noqa: F401
    except ImportError as exc:
        print(f"chip_smoke: the port is not importable here ({exc}); run from the repository root",
              file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False  # f32 convs and products in full f32 (bf16 is unaffected)
    torch.backends.cuda.matmul.allow_tf32 = False

    report = {}
    failed = []
    phases = (phase_card, phase_nms, phase_attn, phase_fp32, phase_bf16, phase_profile,
              phase_rnms, phase_mpack, phase_tasks_fp32, phase_seg_bf16, phase_obb_bf16,
              phase_dfl, phase_gnms, phase_val_fp32, phase_val_bf16, phase_q8_fp32, phase_q8_bf16,
              phase_int8, phase_attn_packed, phase_attn_pallas, phase_many, phase_mask_modes,
              phase_bench, phase_exported, phase_exported_tasks, phase_checkpoints, phase_live_graphs,
              phase_cli, phase_train, phase_optimize, phase_parallel, phase_video, phase_formats, phase_mpeg4,
              phase_vp8, phase_scripts)
    if len(sys.argv) > 1:  # a subset by name, for a quick check of some phases (the card's phase always runs)
        phases = tuple(p for p in phases if p is phase_card or p.__name__[len("phase_"):] in sys.argv[1:])
    for phase in phases:
        t0 = time.perf_counter()
        try:
            result = phase(report)
            result["seconds"] = time.perf_counter() - t0
            emit(result)
        except Exception as exc:  # report every phase, then fail the run
            failed.append(phase.__name__)
            emit({"phase": phase.__name__, "ok": False, "error": repr(exc)})
            traceback.print_exc()
            if phase is phase_card:
                break
    emit({"phase": "profiler", "retraces": RETRACES, "lead_in_lost": dict(sorted(HEAD_LOST.items()))})
    if failed or len(report.get("kernels", ())) != 8:
        print(f"chip_smoke: failed phases {failed}", file=sys.stderr)
        return 1
    print(report["card"])
    order = ("nms_keep", "attention_qkv", "rotated_nms_keep", "upsample4x_threshold_pack", "int8_conv", "dfl_decode",
             "greedy_nms_keep", "attention_packed")
    emit({"kernels": sorted(report["kernels"], key=lambda k: order.index(k["name"]))})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
