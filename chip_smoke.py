#!/usr/bin/env python3
"""Drive the PyTorch port on one CUDA card and hold each kernel against its plain version.

Run from the root of a checkout:  python3 chip_smoke.py

Phases, each printing one JSON line, each fatal when it fails:
  1. card      nvidia-smi name and power limit; torch's TF32 settings, left as
               torch sets them: the port holds its own f32 policy
               (utils.full_f32 around the network's forward, the device
               function and the plain bottleneck)
  2. build     both CUDA kernels built from csrc/ with nvcc and the host
               library (the JPEG decoder's body, the PNG row filters) with the
               host C++ compiler, all at once (build seconds, ptxas report);
               fails on any spill
  3. kernels   each kernel against its plain version on the card: the fused
               bottleneck on the trained, BN-folded weights of layers 6 and 8 at
               the activations the pipeline hands it, and at 32x40x40x128 on
               seeded weights; the greedy keep mask on the trained model's
               decoded predictions and on a random stress case at k = 512,
               1024, 2048
  4. pipeline  build_pipeline(ckpt, device="cuda") at 640 px on seeded synth
               frames (B, 360, 640, 1) for B = 1, 8, 32, with every launch count
               set to 0 just before and read just after; then the same pipeline
               on the CPU (plain versions) for 2 frames
  5. times     pipeline ms/batch, each kernel's time at its main-path shapes
               beside its bound, its plain version and (bottleneck) cuDNN, the
               kernel and cuDNN timed in turns; the bottleneck also at
               32x40x40x128; the NMS scan steps (kept boxes) per image
  6. profile   device kernel time by name, the port's own kernels' device
               time, and the device's busy share over five pipeline calls at
               B = 32 (torch.profiler)
  7. predict   YOLO(ckpt).predict on 4 seeded .npy IQ captures (640 frames
               each), one call each with the launch counts set to 0 just
               before and read just after (6 bottleneck, 1 NMS launches per
               call); 2 of them again through a CPU YOLO(..., device="cpu")
               (counts and classes equal, boxes within 1e-2 px); then
               .predict(32 mixed-size uint8 arrays, batch=32) the same way.
               The greedy keep kernel against its plain version at predict's
               k = 1024 on the trained model's candidates, and both kernels
               against their plain versions at B = 1 on the inputs the first
               capture's predict call handed them (the first bottleneck of
               layers 6 and 8, the (1, 1024) NMS candidates). Times: predict ms
               per capture at B = 1 and per image at batch 32, split into
               IQ -> frame, letterbox, device function and host postprocess,
               and the IQ path at batch 32 composed from the ported functions;
               the device function back to back at B = 1 and 32; last, how
               far the head's outputs move when the first capture's forward
               runs with TF32 on (what the f32 policy holds off)
  8. half      the bf16 path (half=True): build_pipeline(ckpt, half=True); the
               bf16 kernel against its plain version on the inputs that
               pipeline hands the first bottleneck of layers 6 and 8 at B = 32,
               and at 32x40x40x128 on seeded weights; the bf16 pipeline at
               B = 1, 8, 32 with the counts set to 0 just before and read just
               after (6 bf16 bottleneck and 1 NMS launches per call, no f32
               bottleneck launch); times: each bf16 pipeline beside the f32 one
               in turns, the kernel in turns with the cuDNN bf16 chain, its
               plain version and its bound, and the profile at B = 32; then
               YOLO(ckpt).predict(..., half=True) on the 4 captures at B = 1 and
               the 32 arrays at batch 32, counted the same way, timed and split
               by stage; the kernel at predict's B = 1 shapes; and on 2
               captures the card's bf16 against the CPU's bf16 and the card's
               f32 (decoded predictions of every anchor, and the detections)
  9. val       the port's generator writes the spectrogram_synth val split (32
               PNG at 640 px, the packaged YAML's settings) into a temporary
               directory; YOLO(ckpt).val(data=..., batch=32) on the card in f32
               and with half=True, each with the counts set to 0 just before and
               read just after (6 + 1 launches per batch; 6 bf16 + 1 with
               half=True), P, R, mAP50 and mAP50-95 of each; the card's f32
               results_dict against the CPU's on the first 4 images (within
               1e-4); the bf16 mAP50-95 beside the CPU's bf16 and the card's
               bf16 with the plain bottleneck, and the card's f32, bf16 and
               bf16 with the plain bottleneck on 256 images; the keep kernel
               against its plain version on the first batch's (32, 2048)
               multi-label candidates, with the valid candidates, kept boxes
               (scan steps) per image, its time, device time and bound; the val
               call's time per image, split into host read and decode,
               letterbox and H2D, device function and host stats
  10. images   JPEG frames: every committed fixture (tests/torch_data/jpeg/:
               the JAX generator's Spectrogram.yaml val split and one
               spectrogram_synth frame, small cv2 encodes of each decoder
               branch) decoded on the host to the SHA-256 and shape of
               cv2.imread's decode recorded beside them; YOLO(ckpt).predict on
               the fixture directory at batch 8 and on a glob of the small
               encodes (batch 1) at 320 px, and YOLO(ckpt).val on the fixture
               split at batch 8 in f32 and with half=True, each with the counts
               set to 0 just before and read just after (6 + 1 launches per
               batch; 6 bf16 + 1 with half=True), predict's counts, classes
               and frames equal to a CPU run's and boxes within 1e-2 px, the
               f32 results_dict within 1e-4 of the CPU's; each kernel against
               its plain version on the inputs the JPEG val handed it (global
               module hooks); decode ms per image (320 px, 640 px, 641 x 359)
               serially and in 8 threads, and predict ms per image from files
               at batch 8, split into read and decode, letterbox, device
               function and host postprocess
  11. serve    the KServe-v2 server (serve.py) on the card: InferenceServer on
               port 0 in f32 and with half=True; health, /v2 and the metadata
               document (its 64 px probe forward counted: 6 launches); 640 px
               letterboxed frames raw (UINT8, 3 channels) at B = 1, 3 (the
               4-bucket) and 32, each against a local AutoBackend(ckpt)
               forward of the same frames (boxes 1e-2 px, scores 1e-4); gray
               (1 channel), BYTES PNG (the port's encoder) and BYTES JPEG (the
               640 px fixture) each equal to the raw path on the pixels the
               server sees; a truncated BYTES payload gets a 400 and the
               server goes on; 32 client threads with one frame each, released
               together, in fewer than 32 dispatches (bottleneck launches / 6),
               each answer within the tolerance of its lone answer; one
               request with TF32 on for the process equal to one with it off;
               YOLO(url).predict(32 mixed-size arrays, batch=32) against
               YOLO(ckpt).predict (classes equal, boxes within 1e-3 px);
               YOLO(url).val on the 32-image synth split against YOLO(ckpt).val,
               f32 and through the bf16 server against val(half=True), per key
               within 1e-6; every call counted from 0 (6 bottleneck and 0 NMS
               launches per dispatch, bf16 on the half server; 1 NMS launch
               per client batch); each kernel on the server's own inputs (the
               first bottleneck of layers 6 and 8 at 640 and 64 px, f32 and
               bf16) and the keep kernel on the remote val's (32, 2048)
               candidates. Readings: requests/s and p50/p99 latency at
               concurrency 1, 8, 32 for raw UINT8 and BYTES JPEG (one 640 px
               frame per request; bf16 raw at 32) with the dispatches, from
               client threads in this process and from a client process of
               its own; a request's split (parse and decode, H2D, device,
               D2H, encode); the card's busy share over a concurrency-32 raw
               run from each
  12. train    the detect training step: the port's generator writes the
               synthetic split (128 train + 32 val PNG at 640 px) into a
               temporary directory; the trained model at 640 px, B = 16,
               amp=False, optimizer auto (AdamW) takes 20 steps
               (DetectionTrainer.train_step, do_step from the warmup ramp) on
               the train images through the val loader (a stand-in with no
               augmentation), counted (no kernel launches: training runs the
               bottlenecks unfused); then validate() of the EMA counted (6 +
               1 launches per val batch, no bf16 launch); each kernel on the
               inputs the first val batch gave it, against its plain version
               (the six bottlenecks at 16x40x40x32 and 16x20x20x64, also
               against BN folded from the EMA's weights now, so a stale fold
               fails; the keep kernel at (16, 2048)); and the card's val of
               the EMA against the CPU's on 4 images (within 1e-4).
               Readings: ms per step by CUDA events; train_step on 6 later
               steps, timed one by one with the split it records (forward,
               assigner + loss, backward, clip + update + EMA); the profile
               of 3 steps (busy share, top kernels,
               launches per step); peak memory; loss items per step; the same
               steps at B = 32 (or why not). Last, one accumulation step and
               one AdamW step at 160 px, B = 4, full width and depth, on the
               card with TF32 turned on for the process and on the CPU from the
               same weights and batch: loss items, grads, first moments,
               params, BN statistics and the EMA within the tolerances of
               tests/test_torch_train_step.py
  13. train_loop  YOLO(ckpt).train(data=<the synthetic split, 128 + 32 PNG at
               640 px>, epochs=3, batch=16, imgsz=640, amp=False,
               close_mosaic=1): the augmenting train loader (mosaic,
               warp, HSV and flips, the image half on the card by
               augment_batch), the epoch loop and each epoch's EMA val,
               counted from 0 around the call (no launch in the steps, 6 + 1
               per val batch) and per epoch by callbacks; augment_batch on the
               card against the CPU on the loader's first batch, and a
               sample's host cost serially; each kernel against its plain
               version on the first val's inputs; YOLO(best.ckpt).val against
               the metrics of the epoch best.ckpt was saved at (within 1e-4);
               a resume from last.ckpt as the first 2 epochs left it (epoch 2,
               the saved optimizer step and EMA updates). Readings: seconds per
               epoch, ms per step with the loader's wait, the wait, the split
               of train_step in epoch 1 (upload and augment among its parts, by
               CUDA events), the busy share over steps 3-5 of epoch 1 (the
               profiler's set-up lands in that epoch's time), val seconds, the
               final EMA's metrics, peak memory
  14. train_amp   bf16 training at amp=True, JAX's default: 20 steps of the
               trained model at 640 px, B = 16 on the val loader's batches
               (as phase train), counted (no launch: the training convs are
               cuDNN's); train_step's split on 6 later steps beside 6 of an
               f32 trainer; the profile of 3 steps of each (launches, device
               ms, busy share); peak memory; B = 32; the card's bf16 step
               against the CPU's at 160 px, B = 4, TF32 on, per quantity
               within 3 times the card's own bf16-to-f32 distance. Then
               YOLO(ckpt).train(epochs=2, batch=16, imgsz=640,
               close_mosaic=1) at the default amp, counted from 0 around the
               call and per epoch (each EMA val runs a bf16 copy of the EMA: 6
               bf16 bottleneck + 1 NMS launches per val batch, no f32
               bottleneck); each kernel against its plain version on the first
               val's inputs; last.ckpt's train_args.amp; the final EMA's bf16
               mAP beside the f32 loop's
  15. scratch  models from YAML: YOLO("yolo11n.yaml").train(epochs=2,
               batch=16, imgsz=640) at its defaults (amp, seed 0) on the
               synthetic split: the head rebuilt for nc 80 -> 2 with 366
               leaves grafted (JAX's count on the same pair), the loss
               items per epoch finite, counted from 0 around the call and
               per epoch (12 bf16 bottleneck + 2 NMS launches per EMA val, 0
               f32, 0 in the steps), each kernel against its plain version
               at the first EMA val's inputs; YOLO("spectrogram_yolo11n.yaml")
               .load(ckpt) with all 421 leaves transferred, its f32 val on the
               32-image split equal to YOLO(ckpt).val (6 + 1 launches, the
               kernels at its inputs), save -> YOLO(saved).val equal again;
               `python -m spectrogram_yolov11_torch detect val` in a
               subprocess printing the same metrics, and `detect train` for
               one epoch on a 16-image 320 px split exiting 0; info() of both
               YAML models on the card. Readings: seconds per epoch, ms per
               step with the loader's wait, val seconds, the subprocesses'
               seconds
  16. save     predict's saved output: the host JPEG encoder's bytes of frames
               decoded from tests/torch_data/jpeg/ held to cv2's committed
               encodes and their SHA-256 (tests/torch_data/jpeg_encode/);
               YOLO(ckpt).predict at its defaults (save=True) on the 32 arrays
               at batch 32 in f32 and with half=True, and on the JPEG fixture
               directory at batch 8, each counted from 0 (6 bottleneck, or 6
               bf16 with half=True, and 1 NMS launches per batch), every
               written <stem>.jpg equal to imencode(".jpg", r.plot()) of its
               Results and decoding by imread to imdecode of those bytes;
               each kernel against its plain version on the inputs the array
               predicts handed it (global module hooks); `python -m
               spectrogram_yolov11_torch detect predict` in a process of its
               own writing its image; one YOLO(url).predict over the BYTES
               JPEG wire (SYT_WIRE_ENCODE=jpg: quality 90, 6 + 1 launches),
               the server's answer to those bytes within the serve tolerance
               of the local forward of their decoded pixels. Readings: predict
               ms per image at batch 32 at its defaults (saved in 8 threads),
               saving serially (workers=0) and with save=False, in turns, f32
               and bf16; plot and encode ms per 640 x 360 frame, serially and
               in 8 threads; JPEG bytes per frame
  17. artifacts val and training artifacts on the 128 + 32 synth split at 640
               px: YOLO(ckpt).val at its defaults (plots=True) with
               save_json=True at batch 32, f32 and bf16, each counted from 0
               (6 bottleneck, or 6 bf16, and 1 NMS launches), the kernels at
               its inputs, the six charts at JAX's names and pixel sizes
               decoding through imread, predictions.json and annotations.json;
               the f32 val's confusion matrix and JSON row counts equal to the
               CPU's val, its results (the 12 metrics/coco_* keys among them)
               within 1e-4; YOLO(ckpt).embed of the 8 JPEG fixture frames (6
               launches per image) within EMBED_TOL of the CPU's;
               YOLO(ckpt).profile(imgsz=640) (5 runs of each layer: 30
               launches) with the CPU's params; YOLO(ckpt).train(epochs=1,
               batch=16) at its defaults (0 + 12 bf16 + 2 launches), each
               train_batch0..2.jpg equal to imencode(".jpg", images_mosaic(<the
               batch plot_images was handed>)) and results.png at JAX's size;
               profile=True on a quarter of the split writing a trace with the
               card's kernel events; batch=-1 choosing the batch whose probe
               peak fits 60 % of the card's memory, the next over it (or
               256). Readings: val seconds at the defaults with save_json
               against plots=False in turns; ms per chart; COCOeval ms at 32
               images; train_batch plot ms; embed ms per image; profile's
               sum of layer ms beside the forward at B = 1; AutoBatch's
               seconds, batch and probe peaks
  18. fork     the fork's model zoo: FORK_CONFIGS (12 configs that cover the
               registry's modules as far as 12 can: the SMSC family at l, P2
               and P6 heads, the BiFPN concats, the gate at C = 16 and 48),
               each from its YAML with init(0) at 640 px: the card's f32
               forward and its bf16 copy's at B = 1 against the CPU's, each
               counted from 0 (one launch per fused bottleneck, none for a
               gated one), the kernels at the inputs each forward handed
               them; the registry's other modules alone on the card against
               the CPU (fork_module_sweep); then YOLO(FORK_USER).train(epochs=2,
               batch=16, imgsz=640) at its defaults on the synth split,
               counted per epoch (bf16 launches in each EMA val, none in the
               steps), the kernels at the first EMA val's inputs,
               YOLO(last.ckpt).val in f32 and predict(32 arrays,
               save=False), counted, info() naming the gated bottlenecks.
               Readings: ms per forward at B = 32 in f32 and bf16 per
               config, ms per train step with the loader's wait, val seconds
  19. host_augment  host augmentation and the rest of the training data: the
               host library's warps, HSV conversions and drawing fills
               (csrc/warp.cpp, utils/plotting.py) on the seeded cases of
               tests/torch_data/host_augment/cv2_digests.json, each output's
               SHA-256 equal to cv2's recorded one; YOLO(ckpt).train(epochs=2,
               batch=16, imgsz=640, close_mosaic=1) at amp with
               device_augment=False, degrees=10, shear=2, perspective=5e-4,
               mixup=0.5, multi_scale=True on the synth split, counted per
               epoch (no launch in the steps, 6 bf16 bottleneck + 1 NMS per
               EMA val batch), the kernels at the first EMA val's inputs, the
               sizes multi_scale drew; the same call in device mode at the
               default hyps, counted alike; `python -m
               spectrogram_yolov11_torch train epochs=1 imgsz=320 batch=16
               cache=disk` with no data= (the shapes128.yaml default,
               generated at first use) printing its val mAP. Readings: ms per
               warp and per HSV jitter of a 640 px sample, a host-mode
               sample's ms split into read, composite, warp, HSV and mixup, ms
               per step with the loader's wait in host beside device mode
  20. predict_extras  predict's remaining model paths on the trained model at
               640 px: predict(augment=True) (TTA: passes at 640, 544 and 448
               px, one NMS) on 4 seeded IQ captures (B = 1) and the 32 arrays
               (batch 32) in f32 and with half=True, each call counted from 0
               (18 + 1 launches; 18 bf16 + 1), every bottleneck input the
               first capture's call hands the kernel (40x40, 34x34, 28x28 at
               C = 32; 20x20, 17x17, 14x14 at C = 64) against the plain
               version, the keep kernel at the 32 arrays' merged (32, 1024)
               candidates; on 2 captures the card's f32 against a CPU YOLO
               (counts and classes equal, boxes within 1e-2 px) and its bf16
               merged candidates within twice their distance from the card's
               f32 of the CPU's bf16; a weight ensemble YOLO([ckpt, the
               best.ckpt of phase train_loop]) (trained here for one epoch
               when the phase runs alone) on the 32 arrays and 2 captures,
               counted (12 + 1), against the CPU; predict(visualize=True) on
               one capture counted as one forward more (12 + 1), its feature
               PNGs named as the CPU's and within 1 of its pixels; the tables
               (to_json, to_sql twice; to_df/to_csv where pandas imports, else
               its ImportError); the training phases' args.json,
               metrics.jsonl rows and TensorBoard files (fault 21). Readings:
               ms per capture and per image with augment=True beside
               augment=False, in turns, f32 and bf16; the ensemble's ms per
               image beside one model's
  21. segment   the segment task: yolo11n-seg.yaml at 640 px on shapes128-seg
               (its packaged YAML, 64 train + 16 val JPEGs written at first
               use into a temporary directory). YOLO(yaml).train 3 epochs at
               batch 16 at its defaults (amp, device-augment mode), counted
               (6 bf16 bottleneck + 1 NMS launches per epoch's EMA val, none
               in the steps), seconds per epoch, ms per later step with the
               loader's wait, peak memory; 1 epoch in f32 in host mode with
               copy_paste=0.5, counted (6 + 1); the first f32 step's loss
               items (box, seg, cls, dfl) on the card against the CPU's on
               the same 2-image batch. best.ckpt validated on the split, then
               on a copy labelled with its own top 6 detections per image
               (rectangles: a model 12 steps old matches no drawn shape) on
               the card in f32 and bf16 (6 + 1 launches each) against the CPU
               (box and mask mAP50 and mAP50-95 within 1e-4 in f32; bf16
               within twice the CPU's own bf16-to-f32 distance plus 1e-4),
               once with save_json (bbox and segm stats); every bottleneck
               input of the first f32 val batch
               against the plain version and the keep kernel at the val's
               (16, 2048) single-label candidates (0 mismatches, scan steps).
               Predict on the 16 val images at batch 16, f32 and half=True,
               at the defaults (saving; each file equal to imencode(".jpg",
               r.plot())) and with save=False, counted (6 + 1 per call), ms
               per image in turns; at conf 0.001 and max_det 30 the card
               against the CPU in f32: counts and classes equal, boxes within
               1e-2 px, the share of unequal mask pixels at most 1e-4
  22. pose      the pose task: yolo11n-pose.yaml at 640 px on shapes128-pose
               (5 keypoints; its packaged YAML, 64 train + 16 val JPEGs
               written at first use into a temporary directory).
               YOLO(yaml).train 3 epochs at batch 16 at its defaults (amp,
               device-augment mode; the (17, 3) head rebuilt for the data's
               (5, 3)), counted (6 bf16 bottleneck + 1 NMS launches per
               epoch's EMA val, none in the steps), seconds per epoch, ms
               per later step with the loader's wait, peak memory; 1 epoch in
               f32 in host mode (device_augment=False), counted (6 + 1); 1
               epoch on coco8-pose.yaml (17 keypoints, the OKS_SIGMA
               branches), counted (6 bf16 + 1); the first f32 step's five
               loss items (box, pose, kobj, cls, dfl) on the card against the
               CPU's on the same 2-image batch (1e-4 relative). best.ckpt
               validated on the split, then on a copy labelled with its own
               top 6 detections per image, boxes and keypoints (a model 12
               steps old matches no drawn figure), on the card in f32 and
               bf16 (6 + 1 launches each) against the CPU (box and pose
               mAP50 and mAP50-95 within 1e-4 in f32; bf16 within twice the
               CPU's own bf16-to-f32 distance plus 1e-4), once with save_json
               (bbox and keypoints stats); every bottleneck input of the
               first EMA val of the amp train (bf16), of the f32 val and of
               the bf16 val of the self-labelled copy against the plain
               version, and the keep kernel at each of those vals' (16, 2048)
               single-label candidates (0 mismatches).
               Predict on the 16 val images at batch 16, f32 and half=True,
               at the defaults (saving; each file equal to imencode(".jpg",
               r.plot())) and with save=False, counted (6 + 1 per call), ms
               per image in turns; at conf 0.001 and max_det 30, saving (the
               keypoints drawn, each file equal as above, 6 + 1), the card
               against the CPU in f32: counts and classes equal, boxes and
               keypoints within 1e-2 px
  23. obb       the OBB task: yolo11n-obb.yaml at 640 px on shapes128-obb
               (64 + 16 JPEGs written by the port at first use, in a
               temporary directory). The port's polylines of the committed
               cases and box_points of 500 seeded boxes equal cv2's digests
               (tests/torch_data/obb/). YOLO("yolo11n-obb.yaml").train 3
               epochs at B = 16 at its defaults (amp, device-augment mode,
               plots=True: the train-batch mosaics of rotated boxes; the head
               rebuilt for nc 15 -> 2), counted (6 bf16 bottleneck launches
               per epoch's EMA val, none in the steps, and no keep kernel:
               rotated NMS is Fast-NMS over probiou in plain torch), seconds
               per epoch, ms per later step with the loader's wait; 1 epoch
               in f32 in host mode (device_augment=False), counted (6); 1
               epoch on dota8.yaml (15 classes), counted (6 bf16); the first
               f32 step's loss items (box, cls, dfl) on the card against the
               CPU's on the same 2-image batch (1e-4 relative). best.ckpt
               validated on the split, then on a copy labelled with its own
               top 6 rotated boxes per image (4-corner rows by box_points; a
               box with a side under 2 px left out, as the labels drop it), on
               the card in f32 and bf16 (6 launches each) against the CPU
               (mAP50 and mAP50-95 within 1e-4 in f32, mAP50-95 above 0.5;
               bf16 within twice the CPU's own bf16-to-f32 distance plus
               1e-4), once with save_json (no rows, as JAX's); every
               bottleneck input of the first EMA val (bf16), of the f32 val
               and of the bf16 val against the plain version; nms_rotated's
               ms at the f32 val's (16, 8400) predictions, k = 2048. Predict
               on the 16 val images at batch 16, f32 and half=True, at the
               defaults (saving; each file equal to imencode(".jpg",
               r.plot())) and with save=False, counted (6), ms per image in
               turns; at conf 0.001 and max_det 30 the card against the CPU
               in f32: counts and classes equal, xywh within 1e-2 px and the
               angle within 1e-4 rad
  24. classify  the classify task: the 3-class stand-in of imagenette160 (32
               train + 8 val 160 px JPEGs per class, written by the port into
               a temporary directory). YOLO("yolo11n-cls.yaml").train 3 epochs
               at its defaults (224 px, batch 16, f32 steps; the YAML's nc
               1000 kept, as JAX's facade keeps it), counted (4 bottleneck
               launches per batch of each epoch's EMA val: 8 per epoch, no
               keep kernel), seconds per epoch, ms per step with the loader's
               wait, peak memory; YOLO.save, then val (top-1, top-5) of the
               saved model at 224 px, batch 16, counted (8), equal to the
               CPU's; every bottleneck input of that val (16x14x14x32,
               16x7x7x64) against the plain version, and the kernel's time
               at each map beside the cuDNN chain, its plain version and its
               bound; predict on the 24 val images one per call, f32 and
               half=True, counted (4 per image; bf16 with half, its inputs
               against the plain version), ms per image, the f32 probs within
               1e-5 of the CPU's and the top-5 equal; the first f32 step's
               loss on the card against the CPU's on the same batch (1e-5
               relative); one epoch of yolo11-cls-resnet18.yaml (no kernel)
  25. serve_tasks  one server on the card holding the segment, pose and OBB
               phases' best.ckpt and the classify phase's saved model (each
               seeded from its YAML when its phase did not run); per task
               YOLO(url) (the metadata's task, kpt_shape for pose) predicts 8
               640 px shapes frames (224 px for the classifier) at batch 8,
               conf 0 (a seeded model's scores start near 1e-5), max_det 30, counted (6 bottleneck launches in the
               server per dispatch, 4 for the classifier; the client's keep
               kernel once for segment and pose, none for OBB and classify),
               against YOLO(ckpt).predict on the card (boxes, rotated boxes
               and keypoints within 1e-3 px, at most 1e-3 of the mask pixels
               unequal, probs within 1e-5 and the top-5 equal; the served
               probs within 1e-5 of the CPU's); each bottleneck input the
               server's forward took against the plain version and the keep
               kernel at the client's candidates; YOLO(url).val on the frames'
               labels, scored as JAX's BackendValidator scores a served model
               (its first output's columns past the boxes read as classes,
               ROADMAP §3.45), counted (the class-count probe and one batch:
               12 + 1), the client on the card against the client on the CPU
               (within 1e-4 per key); a served classifier's val raises
               ValueError; predict ms per image and one request's ms
  26. families  the YOLOv8 and YOLOv10 families. yolov10n and yolov8n from
               their YAMLs (scale n, nc 80 -> 2 rebuilt) each trained one
               epoch at YOLO.train's defaults (amp) on the 128 + 32 synth
               split at 640 px, B = 16, counted (each EMA val batch: 5 bf16
               bottleneck launches, the C = 16 one of layer 2 gated; the keep
               kernel once per batch for v8, never for v10's NMS-free head);
               then best.ckpt's f32 val and half=True val at batch 32 and a
               predict of 16 val images at batch 16, counted; the predict's
               rows at conf 0.001, max_det 30 against the CPU's on the same
               weights (classes equal, confidences within 1e-4, boxes within
               1e-2 px, rows paired by class and confidence, so two rows of
               nearly equal confidence may change places); one served request
               of 2 frames, its outputs equal to the local serving graph's on
               the card (v10: the NMS-free rows and n_valid). Every bottleneck
               input and keep call of those runs against its plain version.
               Then the fork's yolov10n_WCC_sand3_new and yolov8_sand3_new
               (P2 head, four levels) at 640 px, f32 and bf16, B = 1 and 32:
               forward and decode counted (one launch per fused bottleneck),
               the first image against the CPU's, the bottleneck inputs
               against the plain version, ms per call at B = 32. Every time is
               printed beside the card's name and power limit
Then the total time, the `kernels` line and, last, {"ok": true, "device":
{...}}. It exits non-zero, with no result line, when there is no card or the
port is missing.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
CKPT = ROOT / "runs_artifacts" / "spectrogram_yolo11n.ckpt"
# H100 SXM peaks (NVIDIA data sheet): f32 on the CUDA cores, TF32 on the
# tensor cores (dense), HBM3 bandwidth
PEAK_F32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12
TF32_PASSES = 3  # the bottleneck runs 3xTF32: three tensor-core products per f32 product
IOU_OPS = 14  # 4 min/max, 4 sub, 2 clamp, 1 mul, 2 add/sub, 1 div; the areas are per box
BATCHES = (1, 8, 32)
IQ_SAMPLES = 256 + 128 * 639  # one capture of 640 STFT frames at the IQ loader's n_fft 256, hop 128
ARRAY_SHAPES = ((360, 640, 1), (720, 1280, 3), (500, 333, 3))
PREDICT_BATCH = 32
VAL_BATCH = 32
VAL_TOL = 1e-4  # the card's results_dict against the CPU's, per key
JPEG_FIXTURES = ROOT / "tests" / "torch_data" / "jpeg"  # JAX-written JPEGs and cv2 encodes, cv2's digests beside them
IMAGES_IMGSZ = 320  # the fixture frames' own size: their scores lie 4e-4 or more from conf and iou there
IMAGES_BATCH = 8
TRAIN_IMGSZ, TRAIN_BATCH, TRAIN_STEPS = 640, 16, 20  # JAX's default imgsz and batch
TRAIN_CHECK, TRAIN_CHECK_BATCH = 160, 4  # the card's step against the CPU's
LOOP_EPOCHS = 3  # YOLO.train's epochs in phase train_loop, the last without mosaic
AMP_EPOCHS = 2  # YOLO.train's epochs at amp=True in phase train_amp, the last without mosaic
SCRATCH_EPOCHS = 2  # YOLO("yolo11n.yaml").train's epochs in phase scratch, at its defaults (close_mosaic=10: no mosaic)
SCRATCH_GRAFTED = 366  # leaves yolo11n (nc 80) grafts onto its nc = 2 rebuild: JAX's _intersect_variables on the
#                        same pair (tests/test_torch_scratch.py reads it from JAX)
LOAD_TRANSFERRED = 421  # every leaf of spectrogram_yolo11n: YOLO(yaml).load(ckpt) transfers them all
AMP_MULTIPLE = 3  # the card's bf16 step within this many times its bf16-to-f32 distance of the CPU's
SERVE_BATCHES = (1, 3, 32)  # raw requests' batches: 3 runs in the 4-bucket
SERVE_CONCURRENCY, SERVE_REQUESTS = (1, 8, 32), (40, 16, 8)  # client threads, and requests each sends back to back
# a served forward against the local one of the same frames at another batch (cuDNN picks its algorithm per
# batch): the port's forward tolerance of the CPU tests (tests/test_torch_pipeline.py)
SERVE_PX_TOL, SERVE_SCORE_TOL = 1e-2, 1e-4
SERVE_VAL_TOL = 1e-6  # remote val against local val on the card, per key: the same pixels through the same network
ENCODE_FIXTURES = ROOT / "tests" / "torch_data" / "jpeg_encode"  # cv2's encodes of decoded fixtures, and their SHA-256
SAVE_REPS = 3  # timed predict calls per setting in phase save
# YOLO.embed's vectors on the card against the CPU's, max abs: both run the f32 network in full f32 (3xTF32 in the
# bottleneck kernel), summing in other orders
EMBED_TOL = 1e-3
# the fork's zoo (phase fork): a set of configs that covers the registry's modules as far as 12 configs can (the
# 5 modules that one config each holds, the SMSC family at l, a P2 and a P6 head with the BiFPN concats, the gate at
# C = 16 and 48); fork_module_sweep takes the rest of the registry
FORK_CONFIGS = (
    ("yolo11_fusion_sand3_new_GC.yaml", "n"),  # C3k2GC (GlobalContext, BottleNect, FGM), DDWConv, Fusion; C = 16 gated
    ("yolo11_fusion_convmaxHCA_SMSC.yaml", "l"),  # C3MSCk2 (DenseCross), ConvHCA; fused at C = 32, 64, 128
    ("yolo11_p2_WCC_BiFPN_AKCBam_head.yaml", "n"),  # P2 head, AKCBAM (SAKAM, LDConv), BiFPN_WConcat2 and 3
    ("yolo11_p6_fusion.yaml", "n"),  # P6 head; C = 48 and 16 gated
    ("yolo11_fusion_sand3_new_OMN.yaml", "n"),  # C3x (MSCSpatialAttention)
    ("yolo11_CBam.yaml", "n"),  # CBAM
    ("yolo11_noP5_ghostconv_backbone_OMN.yaml", "n"),  # ConvOMN, GhostConv
    ("yolo11_noP5_ghostconvHCA_backbone.yaml", "n"),  # GhostConvHCA
    ("yolo11_recycleconv.yaml", "n"),  # RecycleConv
    ("yolo11_fusion_convmax_HCA.yaml", "n"),  # GhostConvMax, GhostMaxConv, HCoordAtt
    ("yolo11_fusion_maxconv_HCA_backbone_SPAF.yaml", "n"),  # MaxConvHCA, SAPF
    ("yolo11_fusion_sand3_Gconvmax_HCA_XCBAM.yaml", "n"),  # XCBAM2C2f (Faster_Block), MaxConv
)
FORK_USER = "yolo11_fusion_sand3_new_GC.yaml"  # the user path: scale n by JAX's name rule, 4 fused + 2 gated (C = 16)
FORK_EPOCHS = 2
FORK_TIMED_BATCH = 32
FORK_TOL = 1e-3  # f32 on the card against the CPU, relative to 1 + max|ref|: the forward tolerance of tests/test_torch_gpu.py
FORK_SWEEP_B, FORK_SWEEP_C, FORK_SWEEP_HW = 4, 64, 80  # the module sweep's input: a scale-n P3 map at 640 px
HOST_DIGESTS = ROOT / "tests" / "torch_data" / "host_augment" / "cv2_digests.json"  # seeded cases, cv2's SHA-256
HOST_AUG = dict(device_augment=False, degrees=10.0, shear=2.0, perspective=5e-4, mixup=0.5, multi_scale=True)
HOST_EPOCHS = 2  # YOLO.train's epochs in phase host_augment (close_mosaic=1: mosaic and mixup in the first)
HOST_SPLIT_SAMPLES = 24  # host-mode samples timed stage by stage


RUN_FILES: dict = {}  # what the training phases' run directories hold (fault 21), by phase
SEG_EPOCHS, SEG_BATCH = 3, 16  # phase segment: YOLO("yolo11n-seg.yaml").train at its defaults
SEG_MASK_SHARE = 1e-4  # phase segment: unequal mask pixels of the card's f32 predict against the CPU's, a share
SEG_CONF, SEG_MAX_DET = 0.001, 30  # phase segment: the card-vs-CPU predict, so a model 12 steps old keeps masks
POSE_EPOCHS, POSE_BATCH = 3, 16  # phase pose: YOLO("yolo11n-pose.yaml").train at its defaults
POSE_STEP_RTOL = 1e-4  # phase pose: the first f32 step's loss items on the card against the CPU's, relative
POSE_PX_TOL = 1e-2  # phase pose: the card's f32 predict against the CPU's, boxes and keypoints in px
OBB_EPOCHS, OBB_BATCH = 3, 16  # phase obb: YOLO("yolo11n-obb.yaml").train at its defaults
OBB_STEP_RTOL = 1e-4  # phase obb: the first f32 step's loss items on the card against the CPU's, relative
OBB_PX_TOL, OBB_RAD_TOL = 1e-2, 1e-4  # phase obb: the card's f32 predict against the CPU's, xywh in px, angle
OBB_DIGESTS = ROOT / "tests" / "torch_data" / "obb" / "polylines_digests.json"  # cv2's polylines and boxPoints
CLS_EPOCHS, CLS_BATCH = 3, 16  # phase classify: YOLO("yolo11n-cls.yaml").train at its defaults (batch 16)
CLS_VAL_IMAGES = 24  # the stand-in's val split: 8 per class
CLS_BOTTLENECKS = 4  # fused bottleneck launches per yolo11n-cls forward: layers 6 (C = 32) and 8 (C = 64), 2 each
CLS_PROB_TOL = 1e-5  # phase classify and serve_tasks: probs on the card against the CPU's (and served against local)
CLS_STEP_RTOL = 1e-5  # phase classify: the first f32 step's loss on the card against the CPU's, relative
SERVE_TASK_FRAMES = 8  # phase serve_tasks: the frames of each predict and val, one batch
SERVE_TASK_CONF = 0.0  # phase serve_tasks: every candidate, the top 30 kept (a model seeded from its YAML scores ~1e-5)
SERVE_TASK_PX_TOL = 1e-3  # phase serve_tasks: served boxes, rotated boxes and keypoints against local, px
SERVE_TASK_MASK_SHARE = 1e-3  # phase serve_tasks: unequal mask pixels, served against local, a share
TASK_CKPTS: dict = {}  # phases segment, pose, obb and classify: their trained checkpoints, for phase serve_tasks
SECOND_CKPT: list = []  # phase train_loop's best.ckpt, kept for the ensemble of phase predict_extras
KEEP_DIR: list = []  # a directory for SECOND_CKPT and TASK_CKPTS, removed when the script ends


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean milliseconds per call on the card, CUDA events around `iters` calls."""
    import torch

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


def phase_card():
    import torch

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit("card", nvidia_smi=smi, name=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
         torch=torch.__version__, cuda=torch.version.cuda,
         process_tf32={"cudnn": torch.backends.cudnn.allow_tf32, "matmul": torch.backends.cuda.matmul.allow_tf32},
         policy="left as torch sets them; the network's forward, the device function and the plain "
                "bottleneck run in full f32 (utils.full_f32), and so does the cuDNN chain timed as the library call")
    return smi


def phase_build():
    from spectrogram_yolov11_torch.utils import kernels

    t0 = time.perf_counter()
    secs = kernels.build_all(force=True)
    keys = ("Compiling entry function", "Used", "spill")  # kernel name, registers and shared memory, spills
    report = {name: [ln.strip() for ln in log.splitlines() if any(k in ln for k in keys)]
              for name, log in kernels.BUILD_LOG.items()}
    require(set(secs) == {*kernels.KERNELS, *kernels.HOST_LIBS}, f"not every library was built: {sorted(secs)}")
    spills = [ln for lines in report.values() for ln in lines if "spill" in ln and " 0 bytes spill stores" not in ln]
    require(not spills, f"ptxas reports spills: {spills}")
    emit("build", seconds={k: round(v, 2) for k, v in secs.items()}, wall_s=round(time.perf_counter() - t0, 2),
         ptxas=report)


def first_bottlenecks(model) -> dict:
    """The first fusable bottleneck of layers 6 and 8 (C3k widths 32 and 64)."""
    return {layer: next(m for m in model.model[layer].modules() if getattr(m, "fusable", False)) for layer in (6, 8)}


def keep_nhwc_input(captured: dict):
    """A forward pre-hook that keeps a module's first input as NHWC, once."""
    def hook(mod, args):  # returns None: the forward's input stays as it is
        captured.setdefault(mod, args[0].permute(0, 2, 3, 1).contiguous())
    return hook


def bf16_rounding_ties(x, w1, b1, w2, b2, got, idx) -> int:
    """How many of the output elements `idx` (rows of (b, h, w, c)) of the bf16
    bottleneck `got` are the plain computation correctly rounded with some of
    its bf16 intermediates rounded the other way, where a float32 sum can land
    on either side of a rounding midpoint. In float64, per image: z1 =
    conv(x, w1) + b1 with its float32 summation bound e1 = 9C * 2^-24 * (conv(|x|,
    |w1|) + |b1|); a y1 = silu(z1) whose bf16 rounding differs between z1 - 1.1
    e1 and z1 + 1.1 e1 may round either way (1.1 bounds silu's slope). z2 =
    conv(y1 in bf16, w2) + b2 then lies within e2 = 9C * 2^-24 * (conv(|y1|,
    |w2|) + |b2|) + conv(the flippable y1s' bf16 steps, |w2|); the admissible
    outputs are round_bf16(round_bf16(silu(z)) + x) for z in [z2 - e2, z2 +
    e2] (65 points, so every rounding of y2 in that range is met). An
    element explained here differs from the plain version only by where two
    sums of the same terms in other orders round."""
    import torch
    import torch.nn.functional as F

    bf, f8 = torch.bfloat16, torch.float64
    u, n = 2.0**-24, 9 * x.shape[-1]
    rb = lambda t: t.to(bf).to(f8)  # noqa: E731
    explained = 0
    for b in idx[:, 0].unique().tolist():
        rows = idx[idx[:, 0] == b]
        xi = x[b:b + 1].to(f8).permute(0, 3, 1, 2)
        k1, k2 = (w.to(f8).permute(3, 2, 0, 1) for w in (w1, w2))
        z1 = F.conv2d(xi, k1, b1.to(f8), padding=1)
        e1 = 1.1 * n * u * (F.conv2d(xi.abs(), k1.abs(), b1.to(f8).abs(), padding=1))
        lo1, hi1 = rb(F.silu(z1 - e1)), rb(F.silu(z1 + e1))
        y1 = rb(F.silu(z1))
        flip = (hi1 - lo1).abs()
        z2 = F.conv2d(y1, k2, b2.to(f8), padding=1)
        e2 = n * u * F.conv2d(y1.abs(), k2.abs(), b2.to(f8).abs(), padding=1) + F.conv2d(flip, k2.abs(), padding=1)
        for _, h, w, c in rows.tolist():
            zs = z2[0, c, h, w] + e2[0, c, h, w] * torch.linspace(-1, 1, 65, dtype=f8, device=z2.device)
            outs = rb(rb(F.silu(zs)) + xi[0, c, h, w])
            explained += bool((outs == got[b, h, w, c].to(f8)).any())
    return explained


def bottleneck_check(name: str, args) -> dict:
    """The fused bottleneck against its plain version on (x, w1 pack, b1, w2
    pack, b2), in x's dtype: f32 at 1e-4 abs/rel; bf16 with every element
    within max|ref| * 2^-7 (two bf16 steps of the largest magnitude) and at
    most 1 % of them unequal (a sum in another order flips the rounding of a
    few intermediates). A bf16 element past that tolerance passes only where
    bf16_rounding_ties shows it to be the plain computation with a rounding
    tie of its intermediates broken the other way (at most 64 such elements;
    counted in `over_tolerance`): a y2 rounded one step the other way, then
    the residual's sum rounding at a tie to the other even value, moves an
    output two steps of its own magnitude, more than max|ref| * 2^-7 where
    that magnitude is in the lower half of its binade."""
    import torch

    from spectrogram_yolov11_torch.ops.fused_conv import (
        bottleneck_reference,
        bottleneck_reference_bf16,
        fused_bottleneck,
        unpack_bottleneck_weights,
        unpack_bottleneck_weights_bf16,
    )

    x, p1, b1, p2, b2 = args
    bf16 = x.dtype == torch.bfloat16
    unpack, plain = ((unpack_bottleneck_weights_bf16, bottleneck_reference_bf16) if bf16
                     else (unpack_bottleneck_weights, bottleneck_reference))
    plain_args = (x, unpack(p1), b1, unpack(p2), b2)
    got, ref = fused_bottleneck(*args), plain(*plain_args)
    torch.cuda.synchronize()
    ok = got.dtype == x.dtype
    got, ref = got.float(), ref.float()
    err = (got - ref).abs()
    d = dict(shape=list(x.shape), max_abs_err=float(err.max()))
    if bf16:
        d.update(tolerance=float(ref.abs().max()) * 2.0**-7, unequal_share=float((err > 0).double().mean()))
        over = (err > d["tolerance"]).nonzero()
        if len(over):
            d["over_tolerance"] = len(over)
            d["over_tolerance_rounding_ties"] = bf16_rounding_ties(*plain_args, got, over) if len(over) <= 64 else 0
        ok = ok and d["unequal_share"] <= 0.01 and d.get("over_tolerance_rounding_ties", 0) == len(over)
    else:
        d["max_rel_err"] = float((err / ref.abs().clamp_min(1e-3)).max())
        ok = ok and bool((err <= 1e-4 + 1e-4 * ref.abs()).all())
    require(ok, f"fused bottleneck {name} ({x.dtype}) disagrees with its plain version: {d}")
    return dict(d, ok=ok, args=args, plain_args=plain_args)


def bottleneck_times(name: str, d: dict, launches_per_forward: int | None = None) -> dict:
    """The fused bottleneck (its form for x's dtype) on a check's inputs, in
    turns with the cuDNN chain in the same dtype (conv + bias + SiLU twice,
    + x, on the channels_last view the network holds); its plain version; and
    its bound: 3xTF32 (f32) or bf16 on the tensor cores, against each input
    read and each output written once."""
    import torch
    import torch.nn.functional as F

    from spectrogram_yolov11_torch.ops.fused_conv import (
        bottleneck_reference,
        bottleneck_reference_bf16,
        fused_bottleneck,
    )
    from spectrogram_yolov11_torch.utils import full_f32

    x, w1, b1, w2, b2 = d["plain_args"]
    bf16 = x.dtype == torch.bfloat16
    bsz, h, w, c = x.shape
    xc = x.permute(0, 3, 1, 2)  # channels_last NCHW view, as the network holds it
    w1o, w2o = w1.permute(3, 2, 0, 1).contiguous(), w2.permute(3, 2, 0, 1).contiguous()
    b1c, b2c = b1.to(x.dtype), b2.to(x.dtype)  # cuDNN takes the bias in x's dtype

    @full_f32()
    def cudnn_chain():
        y = F.silu(F.conv2d(xc, w1o, b1c, padding=1))
        return F.silu(F.conv2d(y, w2o, b2c, padding=1)) + xc

    def kernel():
        return fused_bottleneck(*d["args"])

    plain = bottleneck_reference_bf16 if bf16 else bottleneck_reference
    # the kernel and cuDNN in turns (cuDNN's algorithm choice varies between calls)
    turns = [cuda_ms(f, iters=50) for f in (kernel, cudnn_chain, cudnn_chain, kernel)]
    flops = 2 * 2 * 9 * bsz * h * w * c * c
    nbytes = x.element_size() * (2 * x.numel() + w1.numel() + w2.numel()) + 4 * (b1.numel() + b2.numel())
    tc_s = flops / PEAK_BF16_FLOPS if bf16 else TF32_PASSES * flops / PEAK_TF32_FLOPS
    bytes_s = nbytes / PEAK_HBM_BYTES
    ms = (turns[0] + turns[3]) / 2
    if launches_per_forward is None:
        launches_per_forward = {"layer6": 2, "layer8": 4, "c128": 0}[name]
    out = dict(shape=[bsz, h, w, c], launches_per_forward=launches_per_forward,
               ms=ms, library_ms=(turns[1] + turns[2]) / 2, turns_kernel_lib_lib_kernel=turns,
               plain_ms=cuda_ms(lambda: plain(*d["plain_args"]), iters=50), flops=flops, bytes=nbytes,
               bound_ms=max(tc_s, bytes_s) * 1e3,
               bound_by=f"operations, {'bf16' if bf16 else '3xTF32'} on the tensor cores" if tc_s >= bytes_s else "bytes")
    out["share_of_bound"] = out["bound_ms"] / ms
    if not bf16:  # f32 could run on the CUDA cores too
        f32_s = max(flops / PEAK_F32_FLOPS, bytes_s)
        out.update(bound_f32_cuda_cores_ms=f32_s * 1e3, share_of_f32_cuda_core_bound=f32_s * 1e3 / ms)
    if name == "c128" and launches_per_forward == 0:
        out["note"] = "the C3k width of scales s, m and l; not on the main path"
    return out


def layer_case(mod, x):
    """(x, w1 pack, b1, w2 pack, b2) of a folded bottleneck at input x; the
    f32 pack is stored (18, C, C), the bf16 one (9, C, C)."""
    import torch

    c = x.shape[-1]
    w1, w2 = (w.view(2, 9, c, c) if w.dtype == torch.float32 else w for w in (mod.w1, mod.w2))
    return x, w1, mod.b1, w2, mod.b2


def c128_case(dtype):
    """(x, w1 pack, b1, w2 pack, b2) at 32x40x40x128 (the C3k width of scales
    s, m and l) on seeded weights, x and the packs for the kernel of `dtype`."""
    import torch

    from spectrogram_yolov11_torch.ops.fused_conv import pack_bottleneck_weights, pack_bottleneck_weights_bf16

    g = torch.Generator(device="cuda").manual_seed(0)
    x, w1, b1, w2, b2 = (torch.randn(shape, generator=g, device="cuda") * scale for shape, scale in (
        ((32, 40, 40, 128), 1.0), ((3, 3, 128, 128), 0.05), ((128,), 0.1), ((3, 3, 128, 128), 0.05), ((128,), 0.1)))
    pack = pack_bottleneck_weights_bf16 if dtype == torch.bfloat16 else pack_bottleneck_weights
    return x.to(dtype), pack(w1), b1, pack(w2), b2


def phase_kernels(fn, model, frames_dev):
    import numpy as np
    import torch

    from spectrogram_yolov11_torch.ops.decode import decode_detections
    from spectrogram_yolov11_torch.ops.nms import nms_candidates
    from spectrogram_yolov11_torch.ops.nms_kernel import greedy_keep, greedy_keep_reference

    # the activations the pipeline hands the first bottleneck of layers 6 and 8, at B = 32
    captured = {}

    def keep_feats(mod, args, out):
        captured["feats"] = out

    firsts = first_bottlenecks(model)
    hooks = [m.register_forward_pre_hook(keep_nhwc_input(captured)) for m in firsts.values()]
    hooks.append(model.model[-1].register_forward_hook(keep_feats))
    fn(frames_dev)
    for h in hooks:
        h.remove()

    # (x, w1 pack, b1, w2 pack, b2): the layers' folded packs, and C = 128
    # (the scale s/m/l width) on seeded weights
    cases = {f"layer{layer}": layer_case(mod, captured[mod]) for layer, mod in firsts.items()}
    cases["c128"] = c128_case(torch.float32)
    bottleneck = {name: bottleneck_check(name, args) for name, args in cases.items()}
    require([bottleneck[n]["shape"] for n in ("layer6", "layer8", "c128")]
            == [[32, 40, 40, 32], [32, 20, 20, 64], [32, 40, 40, 128]],
            f"unexpected bottleneck shapes {[b['shape'] for b in bottleneck.values()]}")

    preds = decode_detections(captured["feats"], model.nc, model.stride)
    _, _, _, valid, offset_boxes = nms_candidates(preds, 0.25, model.nc, pre_nms_topk=512)
    nms_cases = {"trained_k512": (offset_boxes, valid)}
    rng = np.random.default_rng(0)
    for k, b in ((512, 32), (1024, 8), (2048, 8)):
        centers = rng.uniform(50, 600, (b, 24, 2))
        cxy = np.take_along_axis(centers, rng.integers(0, 24, (b, k))[..., None], 1) + rng.normal(0, 4, (b, k, 2))
        wh = rng.uniform(40, 60, (b, k, 2))
        cls = rng.integers(0, 2, (b, k, 1)) * 7680.0
        boxes = np.concatenate([cxy - wh / 2, cxy + wh / 2], -1) + cls
        nms_cases[f"stress_k{k}"] = (torch.from_numpy(boxes.astype(np.float32)).cuda(),
                                     torch.from_numpy(rng.uniform(size=(b, k)) > 0.1).cuda())
    nms = {}
    for name, (bx, vd) in nms_cases.items():
        got, ref = greedy_keep(bx, vd, 0.7), greedy_keep_reference(bx, vd, 0.7)
        torch.cuda.synchronize()
        mismatches = int((got != ref).sum())
        nms[name] = dict(shape=list(bx.shape), kept=int(got.sum()), valid=int(vd.sum()), mismatches=mismatches)
        require(mismatches == 0, f"greedy keep mask {name} differs from its plain version in {mismatches} entries")
    emit("kernels",
         fused_bottleneck={k: {n: v for n, v in d.items() if "args" not in n} for k, d in bottleneck.items()},
         greedy_keep=nms)
    return bottleneck, nms_cases["trained_k512"]


def phase_pipeline(fn, model, frames_dev, frames_np):
    import torch

    from spectrogram_yolov11_torch.engine.pipeline import build_pipeline
    from spectrogram_yolov11_torch.ops.fused_conv import fused_bottleneck, fused_bottleneck_bf16
    from spectrogram_yolov11_torch.ops.nms_kernel import greedy_keep

    fused_bottleneck.launches = fused_bottleneck_bf16.launches = greedy_keep.launches = 0
    results = {bs: fn(frames_dev[:bs]) for bs in BATCHES}
    torch.cuda.synchronize()
    launches = {"fused_bottleneck": fused_bottleneck.launches, "greedy_keep": greedy_keep.launches}
    require(fused_bottleneck_bf16.launches == 0, "the f32 pipeline launched the bf16 bottleneck kernel")
    per_image = {bs: n.tolist() for bs, (out, n) in results.items()}
    out_max, n_max = results[BATCHES[-1]]
    require(out_max.shape == (BATCHES[-1], 300, 6) and bool(torch.isfinite(out_max).all()), "pipeline output malformed")
    require(int(n_max.sum()) > 0, f"no detections on {BATCHES[-1]} seeded frames")
    require(launches["fused_bottleneck"] == 6 * len(BATCHES),
            f"fused_bottleneck launched {launches['fused_bottleneck']} times in {len(BATCHES)} forwards, expected 6 each")
    require(launches["greedy_keep"] == len(BATCHES),
            f"greedy_keep launched {launches['greedy_keep']} times in {len(BATCHES)} calls")

    fn_cpu, _, _, _ = build_pipeline(CKPT, device="cpu")
    out_c, n_c = fn_cpu(frames_np[:2])
    out_g, n_g = (t.cpu() for t in fn(frames_dev[:2]))
    box_err = float((out_c[..., :4] - out_g[..., :4]).abs().max())
    require(torch.equal(n_c, n_g), f"CPU and GPU pipelines disagree on counts: {n_c.tolist()} vs {n_g.tolist()}")
    require(torch.equal(out_c[..., 5], out_g[..., 5]) and box_err <= 1e-2,
            f"CPU and GPU pipelines disagree: classes or boxes (max {box_err} px)")
    emit("pipeline", launches=launches, detections_per_image=per_image, total_largest_batch=int(n_max.sum()),
         cpu_vs_gpu={"n_cpu": n_c.tolist(), "n_gpu": n_g.tolist(), "max_box_err_px": box_err})
    return launches


def phase_times(fn, frames_dev, bottleneck, nms_trained):
    from spectrogram_yolov11_torch.ops.nms_kernel import greedy_keep

    pipeline = {}
    for bs in BATCHES:
        x = frames_dev[:bs]
        ms = cuda_ms(lambda: fn(x), iters=20)
        pipeline[bs] = {"ms_per_batch": ms, "img_per_s": bs / ms * 1e3}

    shapes = {name: bottleneck_times(name, d) for name, d in bottleneck.items()}
    shapes["layer8"]["note"] = "layers 8 and 25 both run two bottlenecks at this shape"

    bx, vd = nms_trained
    nms = dict(nms_check(bx, vd), launches_per_call=1,
               scan_steps_per_image=greedy_keep(bx, vd, 0.7).sum(1).tolist())  # one scan step per kept box
    emit("times", pipeline=pipeline, fused_bottleneck=shapes, greedy_keep=nms,
         method="CUDA events over repeated calls after 3 warm-up calls; frames already on the card")
    return shapes, nms


def phase_profile(fn, frames_dev, calls: int = 5, name: str = "profile"):
    """Where the device time goes in `calls` pipeline calls at the largest batch:
    torch.profiler's CUDA kernel events, summed by kernel name; busy share =
    kernel time over the span from the first kernel's start to the last's end."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    x = frames_dev[: BATCHES[-1]]
    fn(x)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn(x)
        torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    busy = sum(by_name.values())
    span = (max(e.time_range.end for e in kernels) - min(e.time_range.start for e in kernels)) / 1e3 if kernels else 0.0
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:15]
    port = {}  # the port's own kernels, device time per pipeline call
    for kname, ms in by_name.items():
        for key in ("fused_bottleneck_kernel", "nms_mask_kernel", "nms_scan_kernel"):
            if key in kname:
                port[key] = port.get(key, 0.0) + ms / calls
    emit(name, batch=BATCHES[-1], calls=calls, kernel_launches=len(kernels), host_ms_under_profiler=host_ms,
         device_kernel_ms_per_call=busy / calls, device_span_ms_per_call=span / calls,
         busy_share=busy / span if span else None, port_kernels_device_ms_per_call=port,
         top_kernels_ms_per_call=[[kname[:90], ms / calls] for kname, ms in top])


def _mixed_arrays(n: int, seed: int):
    """n seeded uint8 BGR frames cycling through ARRAY_SHAPES: spectrogram
    content (data/synth.py), the 3-channel ones tinted so the batch is colour."""
    import numpy as np

    from spectrogram_yolov11_torch.data.synth import synth_frames

    out = []
    for i in range(n):
        h, w, c = ARRAY_SHAPES[i % len(ARRAY_SHAPES)]
        f = synth_frames(1, h, w, seed=seed + i)[0]
        out.append(f if c == 1 else (np.repeat(f, 3, -1) * np.array([1.0, 0.9, 0.8])).astype(np.uint8))
    return out


def nms_check(bx, vd):
    """The greedy keep kernel against its plain version on (boxes, valid), with
    its time, plain time and bound."""
    import torch

    from spectrogram_yolov11_torch.ops.nms_kernel import greedy_keep, greedy_keep_reference

    got, ref = greedy_keep(bx, vd, 0.7), greedy_keep_reference(bx, vd, 0.7)
    torch.cuda.synchronize()
    mismatches = int((got != ref).sum())
    require(mismatches == 0, f"greedy keep mask at k = {vd.shape[1]} differs from its plain version in {mismatches} entries")
    b, k = vd.shape
    nv = vd.sum(1).double()
    ops = float((nv * (nv - 1) / 2).sum()) * IOU_OPS
    nbytes = b * k * (16 + 1 + 1)
    d = dict(shape=[b, k], kept=int(got.sum()), valid=int(nv.sum()), mismatches=mismatches,
             scan_steps_mean=float(got.sum(1).double().mean()),
             ms=cuda_ms(lambda: greedy_keep(bx, vd, 0.7), iters=50),
             plain_ms=cuda_ms(lambda: greedy_keep_reference(bx, vd, 0.7), iters=5), library_ms=None,
             ops=ops, bytes=nbytes, bound_ms=max(ops / PEAK_F32_FLOPS, nbytes / PEAK_HBM_BYTES) * 1e3,
             bound_by="operations" if ops / PEAK_F32_FLOPS >= nbytes / PEAK_HBM_BYTES else "bytes")
    d["share_of_bound"] = d["bound_ms"] / d["ms"]
    return d


def launch_counters() -> dict:
    """Every kernel wrapper of the port, by the name the kernels line gives it."""
    from spectrogram_yolov11_torch.ops.fused_conv import fused_bottleneck, fused_bottleneck_bf16
    from spectrogram_yolov11_torch.ops.nms_kernel import greedy_keep

    return {"fused_bottleneck": fused_bottleneck, "fused_bottleneck_bf16": fused_bottleneck_bf16,
            "greedy_keep": greedy_keep}


def run_counted(fn, expect: dict, what: str):
    """fn() with every launch count set to 0 just before and read just after;
    fails unless the counts are `expect`. Returns (fn's result, the counts)."""
    import torch

    counters = launch_counters()
    for c in counters.values():
        c.launches = 0
    out = fn()
    torch.cuda.synchronize()
    got = {k: c.launches for k, c in counters.items()}
    require(got == expect, f"{what} launched {got}, expected {expect}")
    return out, got


def _split_ms(stages, reps: int) -> dict:
    """Mean ms of each (name, fn) stage, run in turn `reps` times, each handed
    the previous one's result: CUDA events around the stages that queue device
    work, the host clock around the stages named host_*; the card is idle at
    the start of every stage."""
    import torch

    totals = {name: 0.0 for name, _ in stages}
    for _ in range(reps):
        value = None
        for name, fn in stages:
            torch.cuda.synchronize()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            value = fn(value)
            end.record()
            torch.cuda.synchronize()
            totals[name] += (time.perf_counter() - t0) * 1e3 if name.startswith("host_") else start.elapsed_time(end)
    return {name: t / reps for name, t in totals.items()}


def predict_inputs():
    """The predict phases' inputs: PREDICT_BATCH seeded IQ captures (complex64)
    and as many seeded mixed-size uint8 arrays."""
    import numpy as np

    from spectrogram_yolov11_torch.data.synth import synth_iq

    rng = np.random.default_rng(0)
    return np.stack([synth_iq(rng, IQ_SAMPLES)[0] for _ in range(PREDICT_BATCH)]), _mixed_arrays(PREDICT_BATCH, seed=100)


def host_ms_per_call(fn, reps: int) -> float:
    """Mean host-clock ms of fn() after one warm call (fn ends in a D2H copy)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) * 1e3 / reps


def predict_stage_times(predictor, iq, arrays):
    """The predictor's stages composed from the ported functions as it runs
    them: ms per capture at B = 1 and per image at batch len(iq) from IQ and
    from the arrays (_split_ms), and its device function back to back (the
    queue stays full, as the pipeline is timed)."""
    import numpy as np
    import torch

    from spectrogram_yolov11_torch.data.augment import letterbox_batch
    from spectrogram_yolov11_torch.data.loaders import iq_frame

    dev, nb = torch.device("cuda"), len(iq)
    dev_fn = predictor._device_fn
    x1 = torch.from_numpy(np.stack([iq[0].real, iq[0].imag], -1)).to(dev)
    xb = torch.from_numpy(np.stack([iq.real, iq.imag], -1)).to(dev)

    def host_post(out_nv, frames):
        out, nv = out_nv
        return predictor.postprocess(out.cpu().numpy(), nv.cpu().numpy(), frames, ["x"] * len(frames), {})

    def stages(x):
        return [("iq_to_frame", lambda _: iq_frame(x)),
                ("letterbox", lambda f: (list(f), letterbox_batch(list(f), 640, dev))),
                ("device_fn", lambda fl: (fl[0], dev_fn(fl[1]))),
                ("host_postprocess", lambda fo: host_post(fo[1], fo[0]))]

    split_capture = _split_ms(stages(x1[None]), reps=10)
    split_iq = {k: v / nb for k, v in _split_ms(stages(xb), reps=5).items()}
    arr_stages = [("letterbox", lambda _: letterbox_batch(arrays, 640, dev)),
                  ("device_fn", lambda b: dev_fn(b)),
                  ("host_postprocess", lambda o: host_post(o, arrays))]
    split_arrays = {k: v / nb for k, v in _split_ms(arr_stages, reps=5).items()}
    frames1, lb = letterbox_batch(list(iq_frame(x1[None])), 640, dev), letterbox_batch(arrays, 640, dev)
    back_to_back = {"capture_b1_ms": cuda_ms(lambda: dev_fn(frames1), iters=20),
                    "arrays_batch32_ms_per_image": cuda_ms(lambda: dev_fn(lb), iters=20) / nb}
    return split_capture, split_iq, split_arrays, back_to_back


def phase_predict():
    """YOLO(ckpt).predict on .npy captures and on uint8 arrays, on the card."""
    import tempfile

    import numpy as np
    import torch

    from spectrogram_yolov11_torch import YOLO
    from spectrogram_yolov11_torch.data.augment import letterbox_batch
    from spectrogram_yolov11_torch.data.loaders import iq_frame
    from spectrogram_yolov11_torch.ops.decode import decode_detections
    from spectrogram_yolov11_torch.ops.nms import nms_candidates

    model = YOLO(CKPT)  # predict runs on the card by default
    dev = torch.device("cuda")
    nb = PREDICT_BATCH
    iq, arrays = predict_inputs()
    launches = {"fused_bottleneck": 0, "greedy_keep": 0}

    def counted(fn):
        out, got = run_counted(fn, {"fused_bottleneck": 6, "fused_bottleneck_bf16": 0, "greedy_keep": 1},
                               "one f32 predict batch")
        launches["fused_bottleneck"] += got["fused_bottleneck"]
        launches["greedy_keep"] += got["greedy_keep"]
        return out

    with tempfile.TemporaryDirectory() as tmp:
        paths = [str(Path(tmp) / f"capture{i}.npy") for i in range(4)]
        for p, capture in zip(paths, iq):
            np.save(p, capture)
        # the first call also keeps what it hands the kernels: the first bottleneck
        # of layers 6 and 8 its input, the NMS its (1, 1024) candidates (from the
        # Detect head's output, decoded and ranked as the device function does)
        net = model.model
        seen = {}

        def keep_feats(mod, args, out):
            seen["feats"] = out

        firsts = first_bottlenecks(net)
        hooks = [m.register_forward_pre_hook(keep_nhwc_input(seen)) for m in firsts.values()]
        hooks.append(net.model[-1].register_forward_hook(keep_feats))
        hooks.append(net.register_forward_pre_hook(lambda mod, args: seen.setdefault("x", args[0])))
        captures = [counted(lambda: model.predict(paths[0], save=False))[0]]
        for h in hooks:
            h.remove()
        captures += [counted(lambda: model.predict(p, save=False))[0] for p in paths[1:]]
        with torch.inference_mode():
            b1_bottleneck = {f"layer{layer}": bottleneck_check(f"layer{layer} at B = 1", layer_case(mod, seen[mod]))
                             for layer, mod in firsts.items()}
            require([d["shape"] for d in b1_bottleneck.values()] == [[1, 40, 40, 32], [1, 20, 20, 64]],
                    f"unexpected B = 1 bottleneck shapes {[d['shape'] for d in b1_bottleneck.values()]}")
            preds = decode_detections(seen["feats"], net.nc, net.stride)
            _, _, _, valid1, offset1 = nms_candidates(preds, model.predictor.args.conf, net.nc, pre_nms_topk=1024)
            require(valid1.shape == (1, 1024), f"B = 1 predict candidates {tuple(valid1.shape)}, expected (1, 1024)")
            nms_b1 = nms_check(offset1, valid1)
        require(all(r.boxes.data.shape[1] == 6 and np.isfinite(r.boxes.data).all() for r in captures)
                and all(r.orig_img.shape == (640, 640, 3) for r in captures), "capture results malformed")
        require(sum(map(len, captures)) > 0, "no detections on 4 seeded captures")

        cpu = YOLO(CKPT, device="cpu")
        cpu_vs_gpu = []
        for p, g in zip(paths[:2], captures[:2]):
            c = cpu.predict(p, save=False)[0]
            require(len(c) == len(g) and np.array_equal(c.boxes.cls, g.boxes.cls),
                    f"CPU and GPU predict disagree on {p}: {c.boxes.cls.tolist()} vs {g.boxes.cls.tolist()}")
            err = float(np.abs(c.boxes.xyxy - g.boxes.xyxy).max(initial=0.0))
            require(err <= 1e-2, f"CPU and GPU predict boxes differ by {err} px")
            cpu_vs_gpu.append(dict(n=len(g), classes=g.boxes.cls.tolist(), max_box_err_px=err,
                                   frame_pixels_differing=int((c.orig_img != g.orig_img).sum())))

        batch32 = counted(lambda: model.predict(arrays, batch=nb, save=False))
        require(len(batch32) == nb and all(r.orig_shape == a.shape[:2] for r, a in zip(batch32, arrays))
                and all(np.isfinite(r.boxes.data).all() for r in batch32), "array results malformed")
        lb_gpu = letterbox_batch(arrays, 640, dev)
        require(torch.equal(lb_gpu.cpu(), letterbox_batch(arrays, 640, torch.device("cpu"))),
                "the letterbox on the card differs from the CPU's")

        # times: whole predict calls, host clock
        predict_capture_ms = host_ms_per_call(lambda: [model.predict(p, save=False) for p in paths], 5) / len(paths)
        predict_array_ms = host_ms_per_call(lambda: model.predict(arrays, batch=nb, save=False), 5) / nb

    split_capture, split_iq32, split_arrays, device_fn_back_to_back = predict_stage_times(model.predictor, iq, arrays)
    x32 = torch.from_numpy(np.stack([iq.real, iq.imag], -1)).to(dev)

    # what the f32 policy holds off: the first capture's forward with TF32 on for cuDNN and matmul
    with torch.inference_mode():
        saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
        try:
            tf32_feats = type(net).forward.__wrapped__(net, seen["x"])
        finally:
            torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
    tf32_err = max(float((a - b).abs().max()) for lv, lt in zip(seen["feats"], tf32_feats) for a, b in zip(lv, lt))

    # greedy keep at predict's k = 1024 on the trained model's candidates (the 32 IQ frames)
    frames32 = letterbox_batch(list(iq_frame(x32)), 640, dev)
    with torch.inference_mode():
        rgb = frames32.expand(-1, -1, -1, 3).flip(-1).float() / 255.0
        preds = decode_detections(model.model(rgb.permute(0, 3, 1, 2)), model.model.nc, model.model.stride)
    _, _, _, valid, offset_boxes = nms_candidates(preds, 0.25, model.model.nc, pre_nms_topk=1024)
    require(valid.shape == (nb, 1024), f"predict candidates {tuple(valid.shape)}, expected ({nb}, 1024)")
    nms_k1024 = nms_check(offset_boxes, valid)

    emit("predict", launches=launches, detections_per_capture=[len(r) for r in captures],
         detections_arrays_batch32=sum(map(len, batch32)), cpu_vs_gpu=cpu_vs_gpu,
         predict_ms_per_capture_b1=predict_capture_ms, predict_ms_per_image_batch32=predict_array_ms,
         split_ms_per_capture_b1=split_capture, split_ms_per_image_iq_batch32=split_iq32,
         split_ms_per_image_arrays_batch32=split_arrays, device_fn_back_to_back=device_fn_back_to_back,
         greedy_keep_k1024=nms_k1024,
         b1_kernel_checks={"fused_bottleneck": {k: {n: v for n, v in d.items() if "args" not in n}
                                                for k, d in b1_bottleneck.items()},
                           "greedy_keep": nms_b1},
         tf32_on_head_max_abs_diff=tf32_err,
         method="whole predict calls on the host clock after one warm call; stages by CUDA events, each "
                "started on an idle card, host_postprocess (D2H of out and frames, scale_boxes, Results) by "
                "the host clock; device_fn_back_to_back by CUDA events over 20 calls in a row")
    return launches, nms_k1024, b1_bottleneck


def phase_half(fn_f32, frames_dev):
    """The bf16 pipeline (build_pipeline(half=True)) at 640 px: the kernel
    against its plain version on the inputs the pipeline hands it, the launch
    counts of B = 1, 8, 32, then times beside the f32 pipeline and cuDNN."""
    import torch

    from spectrogram_yolov11_torch.engine.pipeline import build_pipeline

    fn, model, _, _ = build_pipeline(CKPT, device="cuda", half=True)
    require(model.dtype == torch.bfloat16, f"build_pipeline(half=True) gave a {model.dtype} model")
    # the inputs the bf16 pipeline hands the first bottleneck of layers 6 and 8, at B = 32
    captured = {}
    firsts = first_bottlenecks(model)
    hooks = [m.register_forward_pre_hook(keep_nhwc_input(captured)) for m in firsts.values()]
    fn(frames_dev)
    for h in hooks:
        h.remove()
    cases = {f"layer{layer}": layer_case(mod, captured[mod]) for layer, mod in firsts.items()}
    cases["c128"] = c128_case(torch.bfloat16)
    checks = {name: bottleneck_check(name, args) for name, args in cases.items()}
    require([checks[n]["shape"] for n in ("layer6", "layer8", "c128")]
            == [[32, 40, 40, 32], [32, 20, 20, 64], [32, 40, 40, 128]],
            f"unexpected bf16 bottleneck shapes {[c['shape'] for c in checks.values()]}")

    # the main path: the bf16 pipeline at every batch, counts set to 0 just before
    results, launches = run_counted(lambda: {bs: fn(frames_dev[:bs]) for bs in BATCHES},
                                    {"fused_bottleneck": 0, "fused_bottleneck_bf16": 6 * len(BATCHES),
                                     "greedy_keep": len(BATCHES)}, "the bf16 pipeline")
    out_max, n_max = results[BATCHES[-1]]
    require(out_max.shape == (BATCHES[-1], 300, 6) and out_max.dtype == torch.float32
            and bool(torch.isfinite(out_max).all()), "bf16 pipeline output malformed")
    require(int(n_max.sum()) > 0, f"no bf16 detections on {BATCHES[-1]} seeded frames")
    n_f32 = fn_f32(frames_dev)[1]

    # times: each pipeline beside the f32 one, in turns
    pipeline = {}
    for bs in BATCHES:
        xb = frames_dev[:bs]
        turns = [cuda_ms(lambda f=f: f(xb), iters=10) for f in (fn_f32, fn, fn, fn_f32)]
        bf16_ms, f32_ms = (turns[1] + turns[2]) / 2, (turns[0] + turns[3]) / 2
        pipeline[bs] = {"bf16_ms_per_batch": bf16_ms, "f32_ms_per_batch": f32_ms, "bf16_img_per_s": bs / bf16_ms * 1e3,
                        "turns_f32_bf16_bf16_f32": turns}

    shapes = {name: bottleneck_times(name, d) for name, d in checks.items()}
    emit("half", launches=launches, detections_per_image_b32=n_max.tolist(), f32_detections_per_image_b32=n_f32.tolist(),
         kernel_checks={k: {n: v for n, v in d.items() if "args" not in n} for k, d in checks.items()},
         pipeline=pipeline, fused_bottleneck_bf16=shapes,
         method="CUDA events over repeated calls after 3 warm-up calls; the pipelines and the kernel against cuDNN "
                "in turns (f32, bf16, bf16, f32 and kernel, cuDNN, cuDNN, kernel); bound: bf16 at 989 TFLOP/s "
                "against each input read and each output written once at 3.35 TB/s")
    phase_profile(fn, frames_dev, name="profile_half")
    return launches, checks, shapes


def phase_predict_half():
    """YOLO(ckpt).predict(..., half=True) on the predict phase's captures and
    arrays: launch counts, the kernel at B = 1, times and the stage split, and
    on 2 captures the card's bf16 against the CPU's bf16 and the card's f32."""
    import tempfile

    import numpy as np
    import torch

    from spectrogram_yolov11_torch import YOLO
    from spectrogram_yolov11_torch.data.augment import letterbox_batch
    from spectrogram_yolov11_torch.data.loaders import iq_frame
    from spectrogram_yolov11_torch.ops.decode import decode_detections

    yolo, yolo_f32, cpu = YOLO(CKPT), YOLO(CKPT), YOLO(CKPT, device="cpu")
    dev, nb = torch.device("cuda"), PREDICT_BATCH
    iq, arrays = predict_inputs()
    launches = {"fused_bottleneck_bf16": 0, "greedy_keep": 0}

    def counted(fn):
        out, got = run_counted(fn, {"fused_bottleneck": 0, "fused_bottleneck_bf16": 6, "greedy_keep": 1},
                               "one bf16 predict batch")
        launches["fused_bottleneck_bf16"] += got["fused_bottleneck_bf16"]
        launches["greedy_keep"] += got["greedy_keep"]
        return out

    def decoded(net, frames):
        with torch.inference_mode():
            rgb = frames.expand(-1, -1, -1, 3).flip(-1).float() / 255.0
            return decode_detections(net(rgb.permute(0, 3, 1, 2)), net.nc, net.stride)

    with tempfile.TemporaryDirectory() as tmp:
        paths = [str(Path(tmp) / f"capture{i}.npy") for i in range(4)]
        for p, capture in zip(paths, iq):
            np.save(p, capture)
        captures = [counted(lambda p=p: yolo.predict(p, half=True, save=False))[0] for p in paths]
        net = yolo.predictor.model
        require(net.dtype == torch.bfloat16 and yolo.model.dtype == torch.float32,
                "predict(half=True) did not run a bf16 copy of the model")
        require(all(r.boxes.data.dtype == np.float32 and np.isfinite(r.boxes.data).all() for r in captures)
                and sum(map(len, captures)) > 0, "bf16 capture results malformed or empty")
        # the kernel at predict's B = 1 shapes, on the inputs the first capture's call hands it
        seen = {}
        firsts = first_bottlenecks(net)
        hooks = [m.register_forward_pre_hook(keep_nhwc_input(seen)) for m in firsts.values()]
        counted(lambda: yolo.predict(paths[0], half=True, save=False))
        for h in hooks:
            h.remove()
        with torch.inference_mode():
            b1_checks = {f"layer{layer}": bottleneck_check(f"layer{layer} at B = 1", layer_case(mod, seen[mod]))
                         for layer, mod in firsts.items()}
        require([d["shape"] for d in b1_checks.values()] == [[1, 40, 40, 32], [1, 20, 20, 64]],
                f"unexpected B = 1 bf16 bottleneck shapes {[d['shape'] for d in b1_checks.values()]}")

        # 2 captures: the card's bf16 against the CPU's bf16 and the card's f32, over every anchor
        # (decoded predictions) and in the detections
        compare = []
        for p, x in zip(paths[:2], iq[:2]):
            frame = letterbox_batch(list(iq_frame(torch.from_numpy(np.stack([x.real, x.imag], -1))[None].to(dev))),
                                    640, dev)
            g, c, f = (m.predict(p, half=h, save=False)[0] for m, h in ((yolo, True), (cpu, True), (yolo_f32, False)))
            pg = decoded(net, frame).cpu()
            pc = decoded(cpu.predictor.model, frame.cpu())
            pf = decoded(yolo_f32.predictor.model, frame).cpu()
            d_cpu = {k: float((pg[..., s] - pc[..., s]).abs().max()) for k, s in (("box_px", slice(0, 4)), ("score", slice(4, None)))}
            d_f32 = {k: float((pg[..., s] - pf[..., s]).abs().max()) for k, s in (("box_px", slice(0, 4)), ("score", slice(4, None)))}
            margin = float((pc[..., 4:].max(-1).values - 0.25).abs().min())
            require(all(d_cpu[k] <= 2 * d_f32[k] for k in d_cpu),
                    f"the card's bf16 lies {d_cpu} from the CPU's, more than twice its distance {d_f32} from the card's f32")
            if margin >= 3e-2:
                require(len(g) == len(c) and np.array_equal(g.boxes.cls, c.boxes.cls),
                        f"the card's and the CPU's bf16 predict disagree on {p}: {g.boxes.cls.tolist()} vs {c.boxes.cls.tolist()}")
            compare.append(dict(n_card_bf16=len(g), n_cpu_bf16=len(c), n_card_f32=len(f),
                                classes_card_bf16=g.boxes.cls.tolist(), classes_cpu_bf16=c.boxes.cls.tolist(),
                                classes_card_f32=f.boxes.cls.tolist(), best_score_margin_to_conf=margin,
                                counts_required_equal=margin >= 3e-2, max_diff_to_cpu_bf16=d_cpu,
                                max_diff_to_card_f32=d_f32))

        batch32 = counted(lambda: yolo.predict(arrays, batch=nb, half=True, save=False))
        require(len(batch32) == nb and all(r.orig_shape == a.shape[:2] for r, a in zip(batch32, arrays))
                and all(np.isfinite(r.boxes.data).all() for r in batch32), "bf16 array results malformed")
        predict_capture_ms = host_ms_per_call(lambda: [yolo.predict(p, half=True, save=False) for p in paths],
                                              5) / len(paths)
        predict_array_ms = host_ms_per_call(lambda: yolo.predict(arrays, batch=nb, half=True, save=False), 5) / nb

    split_capture, split_iq32, split_arrays, back_to_back = predict_stage_times(yolo.predictor, iq, arrays)
    emit("predict_half", launches=launches, detections_per_capture=[len(r) for r in captures],
         detections_arrays_batch32=sum(map(len, batch32)), card_bf16_vs_cpu_bf16_and_card_f32=compare,
         predict_ms_per_capture_b1=predict_capture_ms, predict_ms_per_image_batch32=predict_array_ms,
         split_ms_per_capture_b1=split_capture, split_ms_per_image_iq_batch32=split_iq32,
         split_ms_per_image_arrays_batch32=split_arrays, device_fn_back_to_back=back_to_back,
         b1_kernel_checks={k: {n: v for n, v in d.items() if "args" not in n} for k, d in b1_checks.items()},
         method="as the predict phase; the card's bf16 held within twice its distance from the card's f32 of the "
                "CPU's bf16 (decoded predictions of every anchor), detections equal where every best score is "
                "3e-2 or more from conf")
    return launches, b1_checks


def nms_device_ms(bx, vd, calls: int = 10) -> dict:
    """Device ms of one greedy keep call, its mask and scan kernels apart, by torch.profiler over `calls` calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from spectrogram_yolov11_torch.ops.nms_kernel import greedy_keep

    greedy_keep(bx, vd, 0.7)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            greedy_keep(bx, vd, 0.7)
        torch.cuda.synchronize()
    ms = {"mask": 0.0, "scan": 0.0}
    for e in prof.events():
        for part in ms:
            if e.device_type == torch.autograd.DeviceType.CUDA and f"nms_{part}_kernel" in e.name:
                ms[part] += e.time_range.elapsed_us() / 1e3 / calls
    return dict(ms, total=ms["mask"] + ms["scan"])


def phase_val():
    """YOLO(ckpt).val on the card on the spectrogram_synth val split: counted
    f32 and bf16 runs, the CPU on 4 images, the keep kernel at (32, 2048) on
    the first batch's candidates, and the time per image by stage."""
    import tempfile

    import torch

    import spectrogram_yolov11_torch.nn.modules.block as block
    from spectrogram_yolov11_torch import YOLO
    from spectrogram_yolov11_torch.data.augment import letterbox_batch
    from spectrogram_yolov11_torch.data.dataset import YOLODataset, check_det_dataset, find_dataset_yaml
    from spectrogram_yolov11_torch.ops.decode import decode_detections
    from spectrogram_yolov11_torch.ops.fused_conv import bottleneck_reference_bf16, unpack_bottleneck_weights_bf16
    from spectrogram_yolov11_torch.ops.nms import nms_candidates
    from spectrogram_yolov11_torch.ops.nms_kernel import greedy_keep
    from spectrogram_yolov11_torch.utils import yaml_load

    yolo, dev = YOLO(CKPT), torch.device("cuda")
    with tempfile.TemporaryDirectory() as tmp:
        # the packaged dataset's val split (its train split is not needed here)
        t0 = time.perf_counter()
        data = check_det_dataset(dict(yaml_load(find_dataset_yaml("spectrogram_synth.yaml")), path=tmp, n_train=0))
        generate_s = time.perf_counter() - t0
        ds = YOLODataset(data["val"], imgsz=640)
        require(len(ds) == VAL_BATCH, f"the val split has {len(ds)} images, expected {VAL_BATCH}")

        # the main path: one batch of 32 in f32, then with half=True, counts set to 0 just before each
        results, launches, speed = {}, {}, {}
        for name, half, expect in (("f32", False, {"fused_bottleneck": 6, "fused_bottleneck_bf16": 0, "greedy_keep": 1}),
                                   ("bf16", True, {"fused_bottleneck": 0, "fused_bottleneck_bf16": 6, "greedy_keep": 1})):
            results[name], launches[name] = run_counted(lambda h=half: yolo.val(plots=False, data=data, batch=VAL_BATCH, half=h),
                                                        expect, f"{name} val of one batch of {VAL_BATCH}")
            speed[name] = dict(yolo.validator.speed)
            require(list(results[name]) == ["metrics/precision(B)", "metrics/recall(B)", "metrics/mAP50(B)",
                                            "metrics/mAP50-95(B)", "fitness"]
                    and all(0.0 <= v <= 1.0 for v in results[name].values()), f"{name} val results malformed")
        require(results["f32"]["metrics/mAP50-95(B)"] > 0.5, f"f32 mAP50-95 {results['f32']} on the trained model")
        require(yolo.model.dtype == torch.float32, "val(half=True) changed the caller's f32 model")

        # the card's f32 against the CPU's on the first 4 images
        (Path(tmp) / "val4.txt").write_text("\n".join(ds.im_files[:4]))
        sub = dict(data, val=str(Path(tmp) / "val4.txt"))
        card4, cpu4 = yolo.val(plots=False, data=sub, batch=4), YOLO(CKPT, device="cpu").val(plots=False, data=sub, batch=4)
        diff4 = {k: abs(card4[k] - cpu4[k]) for k in card4}
        require(max(diff4.values()) <= VAL_TOL, f"the card's val on 4 images lies {diff4} from the CPU's")

        # where the card's bf16 mAP50-95 stands: beside the CPU's bf16 on the same 32 images and the card's bf16
        # with the plain bf16 bottleneck in the kernel's place (the module's name patched for those calls); then
        # f32, bf16 and bf16 with the plain bottleneck on 256 images of the same settings (the first 32 are the
        # split above), where a near-tie in one image weighs less
        key = "metrics/mAP50-95(B)"

        def plain_bottleneck_map(d) -> float:
            kernel = block.fused_bottleneck
            block.fused_bottleneck = lambda x, w1, b1, w2, b2: bottleneck_reference_bf16(
                x, unpack_bottleneck_weights_bf16(w1), b1, unpack_bottleneck_weights_bf16(w2), b2)
            try:
                return yolo.val(plots=False, data=d, batch=VAL_BATCH, half=True)[key]
            finally:
                block.fused_bottleneck = kernel

        bf16_readings = {"card": results["bf16"][key], "card_plain_bottleneck": plain_bottleneck_map(data),
                         "cpu": YOLO(CKPT, device="cpu").val(plots=False, data=data, batch=VAL_BATCH, half=True)[key]}
        wide = check_det_dataset(dict(data, path=Path(tmp) / "n256", train="images/train", val="images/val",
                                      n_val=8 * VAL_BATCH))
        map_256 = {"f32": yolo.val(plots=False, data=wide, batch=VAL_BATCH)[key],
                   "bf16": yolo.val(plots=False, data=wide, batch=VAL_BATCH, half=True)[key],
                   "bf16_plain_bottleneck": plain_bottleneck_map(wide)}

        # the keep kernel at (32, 2048) on the first batch's multi-label candidates
        with torch.inference_mode():
            frames = letterbox_batch([ds.load_image(i) for i in range(VAL_BATCH)], 640, dev, scaleup=False)
            rgb = frames.expand(-1, -1, -1, 3).flip(-1).float() / 255.0
            preds = decode_detections(yolo.model(rgb.permute(0, 3, 1, 2)), yolo.model.nc, yolo.model.stride)
            _, _, _, valid, offset_boxes = nms_candidates(preds, 0.001, yolo.model.nc, multi_label=True,
                                                          pre_nms_topk=2048)
            require(valid.shape == (VAL_BATCH, 2048), f"val candidates {tuple(valid.shape)}, expected ({VAL_BATCH}, 2048)")
            nms = nms_check(offset_boxes, valid)
            kept = greedy_keep(offset_boxes, valid, 0.7).sum(1).tolist()  # one scan step per kept box
            nms.update(valid_per_image=valid.sum(1).tolist(), kept_per_image=kept, scan_steps_per_image=kept,
                       device_ms_by_kernel=nms_device_ms(offset_boxes, valid))
            nms["device_ms"] = nms["device_ms_by_kernel"]["total"]

        # times: whole val calls (host clock) and the stages; host read and decode timed serially per image
        t0 = time.perf_counter()
        for i in range(len(ds)):
            ds.get_item(i)
        read_decode_ms = (time.perf_counter() - t0) * 1e3 / len(ds)
        times = {}
        for name, half in (("f32", False), ("bf16", True), ("bf16", True), ("f32", False)):
            t0 = time.perf_counter()
            yolo.val(plots=False, data=data, batch=VAL_BATCH, half=half)
            times.setdefault(name, []).append({"val_call_ms_per_image": (time.perf_counter() - t0) * 1e3 / len(ds),
                                               **{f"{k}_ms_per_image": v for k, v in yolo.validator.speed.items()}})
    emit("val", images=len(ds), generate_s=generate_s, results=results, launches=launches,
         first_call_speed_ms_per_image=speed, card_vs_cpu_4_images={"card": card4, "cpu": cpu4, "abs_diff": diff4},
         bf16_map50_95=bf16_readings, map50_95_256_images=map_256,
         greedy_keep_k2048=nms, host_read_decode_ms_per_image=read_decode_ms, times_f32_bf16_bf16_f32=times,
         method="whole val calls on the host clock (validator built, loader threads, letterbox, device function, "
                "stats), f32 and bf16 in turns; the validator's stages by the host clock with the card synchronised "
                "after the letterbox (preprocess: letterbox and H2D; inference: device function and D2H; "
                "postprocess: un-letterbox and TP matching); host read and decode: YOLODataset.get_item per image, "
                "serially; the keep kernel as the other phases, and its device time by torch.profiler")
    return launches, nms


def phase_images():
    """JPEG frames: every committed fixture decoded to cv2's recorded digest;
    YOLO(ckpt).predict from the fixture directory at batch 8 and from a glob,
    and YOLO(ckpt).val on the fixture split in f32 and bf16, each counted and
    held to the CPU; each kernel against its plain version on the inputs the
    JPEG val handed it; decode and predict-from-files times."""
    import hashlib
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    import torch

    from spectrogram_yolov11_torch import YOLO
    from spectrogram_yolov11_torch.data.augment import letterbox_batch
    from spectrogram_yolov11_torch.data.imageio import imread
    from spectrogram_yolov11_torch.engine.validator import VAL_PRE_NMS_TOPK
    from spectrogram_yolov11_torch.nn.modules.block import Bottleneck
    from spectrogram_yolov11_torch.nn.modules.head import Detect
    from spectrogram_yolov11_torch.ops.decode import decode_detections
    from spectrogram_yolov11_torch.ops.nms import nms_candidates

    # every fixture decodes to the shape and SHA-256 of cv2.imread's decode, recorded beside it
    recorded = json.loads((JPEG_FIXTURES / "cv2_decoded.json").read_text())["files"]
    listed = sorted(str(f.relative_to(JPEG_FIXTURES)) for f in JPEG_FIXTURES.rglob("*.jpg"))
    require(listed == sorted(recorded), f"fixtures {listed} are not those recorded {sorted(recorded)}")
    for name, d in recorded.items():
        img = imread(JPEG_FIXTURES / name)
        digest = hashlib.sha256(img.tobytes()).hexdigest()
        require(list(img.shape) == d["shape"] and digest == d["sha256"],
                f"{name} decodes to {img.shape} {digest}, cv2 to {d['shape']} {d['sha256']}")

    f32, bf16_expect = ({"fused_bottleneck": 6, "fused_bottleneck_bf16": 0, "greedy_keep": 1},
                        {"fused_bottleneck": 0, "fused_bottleneck_bf16": 6, "greedy_keep": 1})
    yolo, cpu = YOLO(CKPT), YOLO(CKPT, device="cpu")
    val_dir = JPEG_FIXTURES / "spectrogram" / "images" / "val"
    val_files = sorted(val_dir.glob("*.jpg"))
    glob_src = str(JPEG_FIXTURES / "*.jpg")  # the small encodes: samplings, restarts, 1 x 1 to 641 x 359, EXIF
    n_glob = len(list(JPEG_FIXTURES.glob("*.jpg")))
    predict_calls = {"directory_batch8": (str(val_dir), IMAGES_BATCH, f32),
                     "glob_batch1": (glob_src, 1, {k: n_glob * v for k, v in f32.items()})}
    predict, launches, cpu_vs_gpu = {}, {}, {}
    for key, (source, batch, expect) in predict_calls.items():
        predict[key], launches[f"predict_{key}"] = run_counted(
            lambda s=source, b=batch: yolo.predict(s, batch=b, imgsz=IMAGES_IMGSZ, save=False), expect,
            f"predict {key}")
        ref = cpu.predict(source, batch=batch, imgsz=IMAGES_IMGSZ, save=False)
        require(len(ref) == len(predict[key]) and [r.path for r in ref] == [g.path for g in predict[key]],
                f"predict {key}: the card's and the CPU's results are for other files")
        errs = []
        for g, c in zip(predict[key], ref):
            require(len(c) == len(g) and np.array_equal(c.boxes.cls, g.boxes.cls) and np.array_equal(c.orig_img, g.orig_img),
                    f"predict {key}: CPU and card disagree on {g.path}: {c.boxes.cls.tolist()} vs {g.boxes.cls.tolist()}")
            errs.append(float(np.abs(c.boxes.xyxy - g.boxes.xyxy).max(initial=0.0)))
        require(max(errs) <= 1e-2, f"predict {key}: CPU and card boxes differ by {max(errs)} px")
        cpu_vs_gpu[key] = {"images": len(ref), "detections": sum(map(len, ref)), "max_box_err_px": max(errs)}
    require(cpu_vs_gpu["directory_batch8"]["detections"] > 0, "no detections on the fixture directory")

    # val on the fixture split in f32 and bf16, counted; global hooks keep what each hands the kernels
    data = {"path": str(JPEG_FIXTURES / "spectrogram"), "val": "images/val", "names": {0: "LTE", 1: "RF"}}
    captured = {torch.float32: {}, torch.bfloat16: {}}

    def pre(mod, args):  # returns None: the input stays as it is
        if isinstance(mod, Bottleneck) and mod.fusable and not mod.training and args[0].dtype in captured:
            captured[args[0].dtype].setdefault(mod, args[0].permute(0, 2, 3, 1).contiguous())

    def post(mod, args, out):  # returns None: the output stays as it is
        if isinstance(mod, Detect) and not mod.training and out[0][0].dtype == torch.float32:
            captured[torch.float32].setdefault("feats", out)

    results = {}
    hooks = [torch.nn.modules.module.register_module_forward_pre_hook(pre),
             torch.nn.modules.module.register_module_forward_hook(post)]
    try:
        for name, half, expect in (("f32", False, f32), ("bf16", True, bf16_expect)):
            results[name], launches[f"val_{name}"] = run_counted(
                lambda h=half: yolo.val(plots=False, data=data, batch=IMAGES_BATCH, half=h), expect, f"{name} val of the JPEG split")
    finally:
        for h in hooks:
            h.remove()
    cpu_val = cpu.val(plots=False, data=data, batch=IMAGES_BATCH)
    diff = {k: abs(results["f32"][k] - cpu_val[k]) for k in cpu_val}
    require(max(diff.values()) <= VAL_TOL, f"the card's val of the JPEG split lies {diff} from the CPU's")
    require(results["f32"]["metrics/mAP50(B)"] > 0.5, f"f32 val of the JPEG split {results['f32']}")

    checks = {"fused_bottleneck": {}, "fused_bottleneck_bf16": {}}
    with torch.inference_mode():
        for dtype, key in ((torch.float32, "fused_bottleneck"), (torch.bfloat16, "fused_bottleneck_bf16")):
            for i, m in enumerate(m for m in captured[dtype] if m != "feats"):
                d = bottleneck_check(f"JPEG val {i}", layer_case(m, captured[dtype][m]))
                checks[key][f"bottleneck{i}"] = {k: v for k, v in d.items() if "args" not in k}
            shapes = sorted(c["shape"] for c in checks[key].values())
            require(shapes == [[IMAGES_BATCH, 20, 20, 64]] * 4 + [[IMAGES_BATCH, 40, 40, 32]] * 2,
                    f"{key}: JPEG val inputs {shapes}")
        preds = decode_detections(captured[torch.float32]["feats"], yolo.model.nc, yolo.model.stride)
        _, _, _, valid, offset_boxes = nms_candidates(preds, 0.001, yolo.model.nc, multi_label=True,
                                                      pre_nms_topk=VAL_PRE_NMS_TOPK)
        require(valid.shape == (IMAGES_BATCH, VAL_PRE_NMS_TOPK), f"JPEG val candidates {tuple(valid.shape)}")
        nms = nms_check(offset_boxes, valid)

    # readings: decode per image on the host, serially and in the loader's 8 threads; predict from files
    frame640 = JPEG_FIXTURES / "spectrogram_synth" / "images" / "val" / "00000.jpg"
    decode_ms = {}
    for key, files in (("320px", val_files), ("640px", [frame640]), ("641x359", [JPEG_FIXTURES / "641x359.jpg"])):
        reps = max(1, 64 // len(files))
        imread(files[0])
        t0 = time.perf_counter()
        for _ in range(reps):
            for f in files:
                imread(f)
        serial = (time.perf_counter() - t0) * 1e3 / (reps * len(files))
        with ThreadPoolExecutor(max_workers=8) as pool:
            t0 = time.perf_counter()
            list(pool.map(imread, files * (8 * reps)))
            threads8 = (time.perf_counter() - t0) * 1e3 / (8 * reps * len(files))
        decode_ms[key] = {"serial_ms_per_image": serial, "threads8_ms_per_image": threads8}
    predict_ms = host_ms_per_call(
        lambda: yolo.predict(str(val_dir), batch=IMAGES_BATCH, imgsz=IMAGES_IMGSZ, save=False), 10)
    predictor, dev = yolo.predictor, yolo.predictor.device

    def host_post(out_nv, frames):
        out, nv = out_nv
        return predictor.postprocess(out.cpu().numpy(), nv.cpu().numpy(), frames, [str(f) for f in val_files], {})

    stages = [("host_read_decode", lambda _: [imread(f) for f in val_files]),
              ("letterbox", lambda fr: (fr, letterbox_batch(fr, IMAGES_IMGSZ, dev))),
              ("device_fn", lambda fl: (fl[0], predictor._device_fn(fl[1]))),
              ("host_postprocess", lambda fo: host_post(fo[1], fo[0]))]
    split = {k: v / len(val_files) for k, v in _split_ms(stages, reps=10).items()}
    emit("images", fixtures_decoded_to_cv2_digest=len(recorded), launches=launches, predict_card_vs_cpu=cpu_vs_gpu,
         val_results=results, val_cpu_f32=cpu_val, val_abs_diff_f32=diff,
         kernel_checks={"fused_bottleneck": checks["fused_bottleneck"],
                        "fused_bottleneck_bf16": checks["fused_bottleneck_bf16"], "greedy_keep_k2048": nms},
         decode=decode_ms, predict_ms_per_image_from_files_batch8=predict_ms / len(val_files),
         split_ms_per_image_from_files_batch8=split, imgsz=IMAGES_IMGSZ,
         method="decode: imread of the fixtures on the host clock, serially and mapped over 8 threads (the "
                "loaders' pool), CPU readings of the card machine's host; predict: whole calls on the "
                "directory at batch 8 on the host clock after one warm call; the split by _split_ms (read and "
                "decode and host postprocess on the host clock, letterbox and device function by CUDA events)")
    return launches, checks, nms


def _post(url: str, head: dict, blob: bytes = b"") -> tuple:
    """POST a KServe v2 infer request -> (HTTP status, JSON header document)."""
    import urllib.error
    import urllib.request

    h = json.dumps(head).encode()
    req = urllib.request.Request(url, data=h + blob, method="POST",
                                 headers={"Content-Type": "application/json", "Inference-Header-Content-Length": str(len(h))})
    try:
        with urllib.request.urlopen(req, timeout=600) as r:
            payload, jlen = r.read(), r.headers.get("Inference-Header-Content-Length")
            return r.status, json.loads(payload[: int(jlen)] if jlen else payload)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _get_json(url: str) -> dict:
    import urllib.request

    with urllib.request.urlopen(url, timeout=600) as r:
        return json.loads(r.read())


def _forward_err(got, ref) -> dict:
    """Largest distance of decoded predictions (B, A, 4 + nc): boxes in px, scores."""
    import numpy as np

    require(got.shape == ref.shape and got.dtype == np.float32, f"served {got.dtype} {got.shape}, local {ref.shape}")
    return {"box_px": float(np.abs(got[..., :4] - ref[..., :4]).max()),
            "score": float(np.abs(got[..., 4:] - ref[..., 4:]).max())}


def _within_serve_tol(err: dict, what: str) -> dict:
    require(err["box_px"] <= SERVE_PX_TOL and err["score"] <= SERVE_SCORE_TOL,
            f"{what}: served predictions lie {err} from the local forward's")
    return err


def _load_run(send, clients: int, per_client: int) -> dict:
    """`clients` threads, released together by a barrier, each sending
    `per_client` requests back to back: requests/s over the wall time from the
    first start to the last reply, latency per request (host clock)."""
    import threading

    import numpy as np

    barrier, lat, errors, starts, ends = threading.Barrier(clients), [], [], [], []
    lock = threading.Lock()

    def client():
        try:
            barrier.wait()
            mine = []
            t_start = time.perf_counter()
            for _ in range(per_client):
                t0 = time.perf_counter()
                send()
                mine.append((time.perf_counter() - t0) * 1e3)
            with lock:
                lat.extend(mine)
                starts.append(t_start)
                ends.append(time.perf_counter())
        except Exception as e:  # reported below: a failed request fails the phase
            with lock:
                errors.append(repr(e))

    threads = [threading.Thread(target=client) for _ in range(clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    require(not errors and not any(t.is_alive() for t in threads), f"load run at concurrency {clients}: {errors[:3]}")
    wall = max(ends) - min(starts)
    return {"concurrency": clients, "requests": len(lat), "wall_s": wall, "requests_per_s": len(lat) / wall,
            "p50_ms": float(np.percentile(lat, 50)), "p99_ms": float(np.percentile(lat, 99)),
            "mean_ms": float(np.mean(lat))}


def serve_clients(url: str, payload: str, clients: int, per_client: int) -> None:
    """The client process of phase serve: `_load_run` of RemoteModel(url)
    requests carrying `payload` (a .npy frame batch sent raw, or an encoded
    image sent as BYTES); prints its result as one JSON line."""
    import numpy as np

    from spectrogram_yolov11_torch.serve import RemoteModel

    cli = RemoteModel(url)
    x = np.load(payload) if payload.endswith(".npy") else [Path(payload).read_bytes()]
    print(json.dumps(_load_run(lambda: cli(x), clients, per_client)), flush=True)


def _load_run_apart(url: str, payload: Path, clients: int, per_client: int) -> dict:
    """`serve_clients` in a process of its own (its own interpreter lock), stopped at its end or its time limit."""
    code = f"import chip_smoke as c; c.serve_clients({url!r}, {str(payload)!r}, {clients}, {per_client})"
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=600)
    require(out.returncode == 0, f"the client process failed ({out.returncode}): {out.stderr[-2000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def _busy(fn) -> dict:
    """The card's kernel time over fn() (torch.profiler, every thread's
    launches): busy share = kernel time over the span from the first kernel's
    start to the last's end."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    ks = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in ks) / 1e3
    span = (max(e.time_range.end for e in ks) - min(e.time_range.start for e in ks)) / 1e3 if ks else 0.0
    return {"kernels": len(ks), "device_kernel_ms": busy, "device_span_ms": span,
            "busy_share": busy / span if span else None, "run": out}


def phase_serve():
    """The KServe-v2 server on the card (f32 and half=True), its ingest paths,
    dynamic batching and YOLO(url) predict and val through it, counted; each
    kernel on the server's own inputs; request rates, latency, a request's
    split and the card's busy share under load."""
    import tempfile
    import threading

    import numpy as np
    import torch

    from spectrogram_yolov11_torch import YOLO
    from spectrogram_yolov11_torch.data.augment import letterbox_batch
    from spectrogram_yolov11_torch.data.dataset import check_det_dataset, find_dataset_yaml
    from spectrogram_yolov11_torch.data.imageio import imdecode
    from spectrogram_yolov11_torch.nn.autobackend import AutoBackend
    from spectrogram_yolov11_torch.ops.nms import nms_candidates
    from spectrogram_yolov11_torch.serve import (
        InferenceServer,
        RemoteModel,
        _encode_infer_response,
        _parse_infer_request,
        encode_images,
    )
    from spectrogram_yolov11_torch.utils import yaml_load

    f32_dispatch = {"fused_bottleneck": 6, "fused_bottleneck_bf16": 0, "greedy_keep": 0}
    bf16_dispatch = {"fused_bottleneck": 0, "fused_bottleneck_bf16": 6, "greedy_keep": 0}

    launches = {"serve": {}, "serve_half": {}}

    def counted(path: str, key: str, fn, expect: dict):
        out, got = run_counted(fn, expect, f"{path} {key}")
        launches[path][key] = got
        return out

    dev = torch.device("cuda")
    frames = letterbox_batch(_mixed_arrays(SERVE_BATCHES[-1], seed=300), 640, torch.device("cpu")).numpy()
    require(frames.shape == (SERVE_BATCHES[-1], 640, 640, 3), f"serve frames {frames.shape}")
    jpeg = (JPEG_FIXTURES / "spectrogram_synth" / "images" / "val" / "00000.jpg").read_bytes()
    jpeg_px = imdecode(jpeg)
    require(jpeg_px.shape == (640, 640, 3), f"the 640 px JPEG fixture decodes to {jpeg_px.shape}")
    local = AutoBackend(CKPT)  # the card, f32
    local_half = AutoBackend(CKPT, half=True)

    t0 = time.perf_counter()
    srv = InferenceServer({"spec": CKPT}, port=0).start()
    srv_half = InferenceServer({"spec": CKPT}, port=0, half=True).start()
    start_s = time.perf_counter() - t0
    try:
        base = f"http://127.0.0.1:{srv.port}"
        require(_get_json(base + "/v2/health/ready") == {} and _get_json(base + "/v2")["name"] == "spectrogram_yolov11_torch",
                "health or /v2 of the server")
        cli = counted("serve", "metadata_probe", lambda: RemoteModel(srv.url), f32_dispatch)
        cli_half = counted("serve_half", "metadata_probe", lambda: RemoteModel(srv_half.url), bf16_dispatch)
        md = _get_json(base + "/v2/models/spec")
        require(md["platform"] == "pytorch" and md["outputs"][0]["datatype"] == "FP32"
                and json.loads(md["parameters"]["metadata"])["names"] == {"0": "LTE", "1": "RF"}, f"metadata {md}")

        # raw UINT8 at B = 1, 3, 32 (3 runs in the 4-bucket), each against the local forward of the same frames
        errs = {}
        for b in SERVE_BATCHES:
            got = counted("serve", f"raw_b{b}", lambda b=b: cli(frames[:b])[0], f32_dispatch)
            errs[f"raw_b{b}"] = _within_serve_tol(_forward_err(got, local.forward(frames[:b]).cpu().numpy()), f"raw B={b}")
        raw32 = cli(frames)[0]
        # the other ingest paths, each against the raw path on the pixels the server sees
        b = SERVE_BATCHES[1]
        gray = np.ascontiguousarray(frames[:b, ..., :1])
        got = counted("serve", "gray_b3", lambda: cli(gray)[0], f32_dispatch)
        require(np.array_equal(got, cli(np.repeat(gray, 3, -1))[0]), "the gray upload differs from its 3-channel repeat")
        got = counted("serve", "bytes_png_b3", lambda: cli(encode_images(frames[:b], fmt=".png"))[0], f32_dispatch)
        require(np.array_equal(got, cli(frames[:b])[0]), "BYTES PNG differs from the raw path")
        got = counted("serve", "bytes_jpeg_b3", lambda: cli([jpeg] * b)[0], f32_dispatch)
        require(np.array_equal(got, cli(np.stack([jpeg_px] * b))[0]), "BYTES JPEG differs from the raw path on its pixels")
        got = counted("serve_half", f"raw_b{SERVE_BATCHES[-1]}", lambda: cli_half(frames)[0], bf16_dispatch)
        errs[f"half_raw_b{SERVE_BATCHES[-1]}"] = _within_serve_tol(_forward_err(got, local_half.forward(frames).cpu().numpy()),
                                                 "the bf16 server against the local bf16 forward")

        # a truncated BYTES payload gets a 400, and the server goes on
        pngs = encode_images(frames[:2], fmt=".png")
        blob = b"".join(len(x).to_bytes(4, "little") + x for x in pngs)
        head = {"inputs": [{"name": "images", "shape": [2], "datatype": "BYTES",
                            "parameters": {"binary_data_size": len(blob) - 100}}]}
        code, doc = counted("serve", "truncated_bytes", lambda: _post(f"{base}/v2/models/spec/infer", head, blob[:-100]),
                            {k: 0 for k in f32_dispatch})
        require(code == 400 and "ValueError" in doc.get("error", ""), f"a truncated BYTES payload got {code} {doc}")
        require(cli(encode_images(frames[:2], fmt=".png"))[0].shape == (2, 8400, 6),
                "the server stopped serving after a 400")

        # dynamic batching: 32 clients, one frame each, released together; fewer dispatches than requests
        lone = [cli(frames[i : i + 1])[0] for i in range(SERVE_BATCHES[-1])]
        barrier, answers = threading.Barrier(SERVE_BATCHES[-1]), [None] * SERVE_BATCHES[-1]

        def one(i):
            barrier.wait()
            answers[i] = cli(frames[i : i + 1])[0]

        def burst():
            threads = [threading.Thread(target=one, args=(i,)) for i in range(SERVE_BATCHES[-1])]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=600)

        counters = launch_counters()
        for c in counters.values():
            c.launches = 0
        burst()
        torch.cuda.synchronize()
        dyn = {k: c.launches for k, c in counters.items()}
        launches["serve"]["dynamic_32_clients"] = dyn
        dispatches = dyn["fused_bottleneck"] / 6
        require(dyn["fused_bottleneck_bf16"] == 0 and dyn["greedy_keep"] == 0 and dyn["fused_bottleneck"] % 6 == 0,
                f"32 concurrent requests launched {dyn}")
        require(dispatches < SERVE_BATCHES[-1], f"32 concurrent requests took {dispatches} dispatches")
        dyn_err = {"box_px": 0.0, "score": 0.0}
        for a, lo in zip(answers, lone):
            e = _within_serve_tol(_forward_err(a, lo), "a request served in a group against itself alone")
            dyn_err = {k: max(dyn_err[k], e[k]) for k in e}

        # TF32 on for the process: a request still runs in f32 (the dispatcher thread keeps the policy)
        saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
        try:
            torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
            tf32_on = cli(frames[:1])[0]
            torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
            tf32_off = cli(frames[:1])[0]
        finally:
            torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
        require(np.array_equal(tf32_on, tf32_off), f"TF32 on moves a served f32 request by {_forward_err(tf32_on, tf32_off)}")

        # YOLO(url).predict against YOLO(ckpt).predict on the card: 6 + 0 in the server, 1 NMS in the client
        arrays = _mixed_arrays(PREDICT_BATCH, seed=100)
        remote, yolo = YOLO(srv.url), YOLO(CKPT)
        got, launches["remote_predict"] = run_counted(lambda: remote.predict(arrays, batch=PREDICT_BATCH, save=False),
                                                      {"fused_bottleneck": 6, "fused_bottleneck_bf16": 0, "greedy_keep": 1},
                                                      "remote predict of 32 arrays")
        ref = yolo.predict(arrays, batch=PREDICT_BATCH, save=False)
        predict_err = 0.0
        for g, r in zip(got, ref):
            require(len(g) == len(r) and np.array_equal(g.boxes.cls, r.boxes.cls),
                    f"remote predict: {g.boxes.cls.tolist()} against local {r.boxes.cls.tolist()}")
            predict_err = max(predict_err, float(np.abs(g.boxes.xyxy - r.boxes.xyxy).max(initial=0.0)))
        require(predict_err <= 1e-3 and sum(map(len, ref)) > 0, f"remote predict boxes lie {predict_err} px from local")

        # val through each server against local val, on the 32-image synth split; the first remote val keeps
        # the decoded predictions its NMS takes
        with tempfile.TemporaryDirectory() as tmp:
            data = check_det_dataset(dict(yaml_load(find_dataset_yaml("spectrogram_synth.yaml")), path=tmp, n_train=0))
            seen, inner = [], remote.backend.forward
            remote.backend.forward = lambda x: seen.append(inner(x)) or seen[-1]
            try:
                rval, launches["remote_val"] = run_counted(
                    lambda: remote.val(plots=False, data=data, batch=VAL_BATCH),
                    {"fused_bottleneck": 6, "fused_bottleneck_bf16": 0, "greedy_keep": 1}, "remote val")
            finally:
                remote.backend.forward = inner
            lval = yolo.val(plots=False, data=data, batch=VAL_BATCH)
            rval_half, launches["remote_val_half"] = run_counted(
                lambda: YOLO(srv_half.url).val(plots=False, data=data, batch=VAL_BATCH),
                {"fused_bottleneck": 0, "fused_bottleneck_bf16": 6, "greedy_keep": 1}, "remote val on the bf16 server")
            lval_half = yolo.val(plots=False, data=data, batch=VAL_BATCH, half=True)
        val_diff = {k: abs(rval[k] - lval[k]) for k in lval}
        half_diff = {k: abs(rval_half[k] - lval_half[k]) for k in lval_half}
        require(max(val_diff.values()) <= SERVE_VAL_TOL and lval["metrics/mAP50-95(B)"] > 0.5,
                f"remote val {rval} against local {lval}")
        require(max(half_diff.values()) <= SERVE_VAL_TOL, f"bf16 remote val {rval_half} against local {lval_half}")

        # each kernel against its plain version on the server's own inputs: the first bottleneck of layers 6 and 8
        # in a 640 px dispatch of 32 and in a 64 px one (4x4 and 2x2 maps), f32 and bf16; the keep kernel on the
        # remote val's (32, 2048) multi-label candidates
        checks = {"fused_bottleneck": {}, "fused_bottleneck_bf16": {}}
        for key, server, c in (("fused_bottleneck", srv, cli), ("fused_bottleneck_bf16", srv_half, cli_half)):
            net = server.models["spec"].backend.model
            for size, x in (("640", frames), ("64", np.zeros((1, 64, 64, 3), np.uint8) + 90)):
                captured = {}
                hooks = [m.register_forward_pre_hook(keep_nhwc_input(captured)) for m in first_bottlenecks(net).values()]
                try:
                    c(x)
                finally:
                    for h in hooks:
                        h.remove()
                with torch.inference_mode():
                    for layer, mod in first_bottlenecks(net).items():
                        d = bottleneck_check(f"serve {size} px layer{layer}", layer_case(mod, captured[mod]))
                        checks[key][f"{size}px_layer{layer}"] = {k: v for k, v in d.items() if "args" not in k}
        require([checks["fused_bottleneck"][k]["shape"] for k in ("64px_layer6", "64px_layer8")]
                == [[1, 4, 4, 32], [1, 2, 2, 64]], f"64 px bottleneck inputs {checks['fused_bottleneck']}")
        with torch.inference_mode():
            preds = torch.tensor(seen[0], device=dev)
            _, _, _, valid, offset_boxes = nms_candidates(preds, 0.001, 2, multi_label=True, pre_nms_topk=2048)
            require(valid.shape == (VAL_BATCH, 2048), f"remote val candidates {tuple(valid.shape)}")
            nms = nms_check(offset_boxes, valid)

        # times: request rates and latency at concurrency 1, 8, 32 (raw UINT8 and BYTES JPEG, one 640 px frame
        # per request), dispatches counted; the bf16 server raw at 32
        one_raw, one_jpeg = frames[:1], [jpeg]
        loads = {}
        for name, c, payload in (("raw_uint8", cli, one_raw), ("bytes_jpeg", cli, one_jpeg), ("raw_uint8_half", cli_half, one_raw)):
            for conc, per in zip(SERVE_CONCURRENCY, SERVE_REQUESTS):
                if name == "raw_uint8_half" and conc != SERVE_CONCURRENCY[-1]:
                    continue
                for k in launch_counters().values():
                    k.launches = 0
                r = _load_run(lambda c=c, p=payload: c(p), conc, per)
                torch.cuda.synchronize()
                n = launch_counters()["fused_bottleneck"].launches + launch_counters()["fused_bottleneck_bf16"].launches
                r["dispatches"] = n / 6
                r["frames_per_dispatch"] = r["requests"] / max(n / 6, 1)
                loads[f"{name}_c{conc}"] = r

        # the split of one request (B = 1, 640 px) by stage, raw and JPEG: parse and decode, H2D, the device
        # forward, D2H, encode; the server's own functions in the order it runs them
        runner = srv.models["spec"]

        def body_of(inputs):
            specs, blobs = [], []
            for a in inputs:
                if isinstance(a, list):
                    bl = b"".join(len(x).to_bytes(4, "little") + x for x in a)
                    specs.append({"name": "images", "shape": [len(a)], "datatype": "BYTES", "parameters": {"binary_data_size": len(bl)}})
                else:
                    bl = a.tobytes()
                    specs.append({"name": "images", "shape": list(a.shape), "datatype": "UINT8", "parameters": {"binary_data_size": len(bl)}})
                blobs.append(bl)
            h = json.dumps({"inputs": specs, "outputs": [{"name": "output0", "parameters": {"binary_data": True}}]}).encode()
            return {"Inference-Header-Content-Length": str(len(h))}, h + b"".join(blobs)

        split = {}
        for name, payload in (("raw_uint8", one_raw), ("bytes_jpeg", one_jpeg)):
            hdrs, body = body_of([payload])
            stages = [("host_parse_decode", lambda _: runner._prep(_parse_infer_request(hdrs, bytearray(body))[1])),
                      ("h2d", lambda imgs: torch.from_numpy(imgs).to(dev)),
                      ("device", lambda x: runner.backend.forward(x.expand(-1, -1, -1, 3))),
                      ("d2h", lambda o: [o[:1].cpu().numpy()]),
                      ("host_encode", lambda outs: _encode_infer_response("spec", outs, True))]
            split[name] = _split_ms(stages, reps=20)
            split[name]["http_and_rest_ms"] = loads[f"{name}_c1"]["p50_ms"] - sum(split[name].values())
        busy = {"clients_in_process": _busy(lambda: _load_run(lambda: cli(one_raw), SERVE_CONCURRENCY[-1],
                                                                 SERVE_REQUESTS[-1]))}
        loads["raw_uint8_c32_profiled"] = busy["clients_in_process"].pop("run")

        # the same loads from a client process of its own: the server's capacity without the clients' Python work
        # under its interpreter lock (raw at 1 and 32 clients, JPEG at 32, 32 requests each at 32; raw at 32 profiled)
        with tempfile.TemporaryDirectory() as tmp:
            raw_path = Path(tmp) / "frame.npy"
            np.save(raw_path, one_raw)
            jpeg_path = JPEG_FIXTURES / "spectrogram_synth" / "images" / "val" / "00000.jpg"
            c_max, per_max = SERVE_CONCURRENCY[-1], 4 * SERVE_REQUESTS[-1]
            for name, payload, conc, per in (("raw_uint8", raw_path, 1, SERVE_REQUESTS[0]),
                                             ("raw_uint8", raw_path, c_max, per_max),
                                             ("bytes_jpeg", jpeg_path, c_max, per_max)):
                for k in launch_counters().values():
                    k.launches = 0
                r = _load_run_apart(srv.url, payload, conc, per)
                torch.cuda.synchronize()
                r["dispatches"] = launch_counters()["fused_bottleneck"].launches / 6
                r["frames_per_dispatch"] = r["requests"] / max(r["dispatches"], 1)
                loads[f"{name}_c{conc}_client_process"] = r
            busy["client_process"] = _busy(lambda: _load_run_apart(srv.url, raw_path, c_max, per_max))
            loads["raw_uint8_c32_client_process_profiled"] = busy["client_process"].pop("run")
    finally:
        srv.shutdown()
        srv_half.shutdown()
    emit("serve", server_start_s=start_s, launches=launches, dispatches_32_concurrent=dispatches,
         served_vs_local=errs, group_vs_alone=dyn_err, remote_predict_max_box_err_px=predict_err,
         remote_val=rval, local_val=lval, val_abs_diff=val_diff, remote_val_half=rval_half, local_val_half=lval_half,
         val_half_abs_diff=half_diff, kernel_checks={**checks, "greedy_keep_k2048": nms}, load=loads,
         split_ms_per_request=split, busy_c32=busy,
         method="requests through RemoteModel (a new HTTP connection each) from threads of this process to "
                "servers on 127.0.0.1; latency on the host clock per request; requests/s = requests over the "
                "wall time from the first client's start to the last reply; dispatches = bottleneck launches / 6; "
                "the split by _split_ms over the server's own functions (host_* on the host clock, H2D, device "
                "and D2H by CUDA events); busy share by torch.profiler over a concurrency-32 raw run; *_client_process: "
                "the clients in a process of their own (serve_clients), started after the server is up")
    return launches, checks, nms


def train_max_gt(ds) -> int:
    """The GT pad the JAX train loader sizes for a split (its data/dataset.py:157-165 with augment=True)."""
    most = max((len(lab["cls"]) for lab in ds.labels), default=0)
    return int(min(128, max(32, -(-int(most * 4 * 1.1) // 8) * 8)))


def train_batches(img_dir: str, imgsz: int, batch: int, device):
    """The train split as train batches (JAX's layout: img (B, S, S, 3) uint8 RGB,
    cls, bboxes normalised xywh, mask_gt) on `device`, through the port's val
    loader and the val letterbox: a stand-in with no augmentation until the
    train loader is ported."""
    import torch

    from spectrogram_yolov11_torch.data.augment import letterbox_batch
    from spectrogram_yolov11_torch.data.build import DataLoader
    from spectrogram_yolov11_torch.data.dataset import YOLODataset

    ds = YOLODataset(img_dir, imgsz=imgsz)
    ds = YOLODataset(img_dir, imgsz=imgsz, max_gt=train_max_gt(ds))
    out = []
    for b in DataLoader(ds, batch_size=batch, workers=8):
        if int(b["n_valid"]) < batch:  # drop_last, as the train loader
            break
        frames = letterbox_batch(b["img"], imgsz, device, scaleup=False)
        out.append({"img": frames.expand(-1, -1, -1, 3).flip(-1).contiguous(),
                    **{k: torch.from_numpy(b[k]).to(device) for k in ("cls", "bboxes", "mask_gt")}})
    return out


def timed_steps(trainer, batches, nis) -> dict:
    """train_step itself on `batches` at iterations `nis`, one by one: its ms
    by CUDA events around each call, and its split from the CUDA events
    train_step records between its parts (DetectionTrainer.split_events)."""
    import torch

    steps, split = [], {}
    for ni in nis:
        trainer.split_events = []
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        trainer.train_step(batches[ni % len(batches)], ni, trainer.step_due(ni))
        end.record()
        torch.cuda.synchronize()
        steps.append(start.elapsed_time(end))
        marks, trainer.split_events = trainer.split_events, None
        for (_, a), (name, b) in zip(marks, marks[1:]):
            split.setdefault(name, []).append(a.elapsed_time(b))
    return {"ms_per_step": steps, "split_ms_by_step": split}


def profile_steps(trainer, batches, ni0: int, n: int = 3, top: int = 12) -> dict:
    """n train steps under torch.profiler: kernel launches and device kernel
    ms per step, the device span per step, the busy share, the `top` kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for ni in range(ni0, ni0 + n):
            trainer.train_step(batches[ni % len(batches)], ni, trainer.step_due(ni))
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    busy = sum(by_name.values())
    span = (max(e.time_range.end for e in kernels) - min(e.time_range.start for e in kernels)) / 1e3
    return {"steps": n, "kernel_launches_per_step": len(kernels) / n, "device_kernel_ms_per_step": busy / n,
            "device_span_ms_per_step": span / n, "busy_share": busy / span,
            "top_kernels_ms_per_step": [[k[:90], ms / n]
                                        for k, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]]}


def new_trainer(data: dict, imgsz: int, batch: int, device: str, amp: bool = False):
    from spectrogram_yolov11_torch.engine.pipeline import load_model
    from spectrogram_yolov11_torch.engine.trainer import DetectionTrainer

    t = DetectionTrainer(load_model(CKPT)[0], {"data": data, "imgsz": imgsz, "batch": batch, "amp": amp,
                                               "optimizer": "auto", "device": device, "workers": 8})
    t.setup_model()
    t.setup_optimizer()
    return t


def train_card_vs_cpu(data: dict) -> dict:
    """One accumulation step and one AdamW step (ni 3 without, 4 with do_step;
    lr != 0 in the warmup) of the trained model at TRAIN_CHECK px, B =
    TRAIN_CHECK_BATCH, full width and depth, on the card with TF32 turned on for
    the process and on this machine's CPU, from the same weights and batch: the
    tolerances of tests/test_torch_train_step.py, which holds the CPU to JAX."""
    import numpy as np
    import torch

    from spectrogram_yolov11_torch.engine.optim import lr_at

    batch = train_batches(data["train"], TRAIN_CHECK, TRAIN_CHECK_BATCH, torch.device("cpu"))[0]
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    runs = {}
    try:
        for dev in ("cuda", "cpu"):
            t = new_trainer(dict(data), TRAIN_CHECK, TRAIN_CHECK_BATCH, dev)
            init = [p.detach().cpu().clone() for p in t.params]
            items, grads = [], None
            for ni, do_step in ((3, False), (4, True)):
                items.append(t.train_step(batch, ni, do_step)[1].cpu())
                if not do_step:
                    grads = [g.cpu().clone() for g in t.state["grad_buf"]]
            runs[dev] = (t, items, grads, init)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
    (tc, items_c, grads_c, init), (tp, items_p, grads_p, _) = runs["cuda"], runs["cpu"]
    items_err = max(float(((a - b).abs() / b.abs()).max()) for a, b in zip(items_c, items_p))
    require(items_err <= 1e-4, f"loss items on the card lie {items_err} (relative) from the CPU's")

    def leaf_errors(got, ref):
        top = max(float(r.abs().max()) for r in ref)
        worst = 0.0
        for g, r in zip(got, ref):
            scale, err = float(r.abs().max()), float((g.cpu() - r).abs().max())
            require(err <= (5e-4 * scale if scale >= 1e-6 * top else 1e-6 * top), f"leaf off by {err} (max {scale})")
            worst = max(worst, err / scale) if scale >= 1e-6 * top else worst
        return worst

    grads_err, mu_err = leaf_errors(grads_c, grads_p), leaf_errors(tc.state["opt"]["mu"], tp.state["opt"]["mu"])
    lr_main, lr_bias, _ = lr_at(tp.opt, 4)
    loose = total = 0
    for got, ref in ((tc.params, tp.params), (tc.state["ema"]["params"], tp.state["ema"]["params"])):
        for name, g, r, p0 in zip(tp.param_names, got, ref, init):
            r = r.detach()
            err = (g.detach().cpu() - r).abs()
            ulps = 4 * float(np.spacing(np.float32(r.abs().max())))
            lr = lr_bias if name.endswith("bias") else lr_main
            require(float(err.max()) <= 2 * lr + ulps, f"{name} on the card lies {float(err.max())} from the CPU's")
            loose += int((err > 1e-3 * float((r - p0).abs().max()) + ulps).sum())
            total += r.numel()
    require(loose <= 0.01 * total, f"{loose} of {total} parameter elements past the tight bound")
    stats_err = max(float((g.cpu() - r).abs().max() / r.abs().max()) for got, ref in (
        (tc.stats, tp.stats), (tc.state["ema"]["batch_stats"], tp.state["ema"]["batch_stats"])) for g, r in zip(got, ref))
    require(stats_err <= 1e-5, f"BN statistics on the card lie {stats_err} of their max from the CPU's")
    return dict(imgsz=TRAIN_CHECK, batch=TRAIN_CHECK_BATCH, process_tf32=True, items_card=[i.tolist() for i in items_c],
                items_cpu=[i.tolist() for i in items_p], items_max_rel_err=items_err,
                grads_worst_share_of_leaf_max=grads_err, mu_worst_share_of_leaf_max=mu_err,
                param_elements_past_tight_bound=loose, param_elements=total, bn_stats_worst_share_of_max=stats_err)


def phase_train():
    """The detect training step on the card: the trained model at TRAIN_IMGSZ px,
    B = TRAIN_BATCH, amp=False, optimizer auto (AdamW), on the synthetic
    split's train images; TRAIN_STEPS steps with do_step from the warmup ramp,
    counted (no kernel runs in training), then validate() of the EMA counted
    (6 + 1 launches per val batch); each kernel on the inputs the first val
    batch gave it, against its plain version (the bottlenecks also against BN
    folded from the EMA's weights now), and the card's val against the CPU's
    on 4 images; 6 later steps timed with their split, the profile of 3
    steps, B = 32; last the card's step against the CPU's at TRAIN_CHECK px
    with TF32 on."""
    import copy
    import tempfile

    import torch

    from spectrogram_yolov11_torch.data.dataset import check_det_dataset, find_dataset_yaml
    from spectrogram_yolov11_torch.engine.validator import VAL_PRE_NMS_TOPK, DetectionValidator
    from spectrogram_yolov11_torch.nn.modules.block import Bottleneck
    from spectrogram_yolov11_torch.ops.decode import decode_detections
    from spectrogram_yolov11_torch.ops.fused_conv import bottleneck_reference
    from spectrogram_yolov11_torch.ops.nms import nms_candidates
    from spectrogram_yolov11_torch.utils import yaml_load

    dev = torch.device("cuda")
    zero = {"fused_bottleneck": 0, "fused_bottleneck_bf16": 0, "greedy_keep": 0}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        data = check_det_dataset(dict(yaml_load(find_dataset_yaml("spectrogram_synth.yaml")), path=tmp))
        generate_s = time.perf_counter() - t0
        batches = train_batches(data["train"], TRAIN_IMGSZ, TRAIN_BATCH, dev)
        trainer = new_trainer(data, TRAIN_IMGSZ, TRAIN_BATCH, "cuda")
        opt = trainer.opt._asdict()
        require(opt["kind"] == "adamw" and len(batches) == opt["nb"] == 128 // TRAIN_BATCH,
                f"optimizer {opt}, {len(batches)} batches")

        # the main path: TRAIN_STEPS steps, counts set to 0 just before and read just after
        torch.cuda.reset_peak_memory_stats()

        def steps():
            out, start, end = [], torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for ni in range(TRAIN_STEPS):
                do_step = trainer.step_due(ni)
                out.append((ni, do_step, trainer.train_step(batches[ni % len(batches)], ni, do_step)))
            end.record()
            return out, start, end

        (done, start, end), launches = run_counted(steps, zero, f"{TRAIN_STEPS} train steps")
        steps_ms = start.elapsed_time(end)
        peak_gb = torch.cuda.max_memory_allocated() / 2**30
        losses = [[ni, do_step, float(loss), items.tolist()] for ni, do_step, (loss, items) in done]
        require(all(torch.isfinite(torch.tensor(r[3])).all() and r[2] > 0 for r in losses), f"losses {losses}")
        n_updates = trainer.state["ema_updates"]
        require(n_updates == sum(r[1] for r in losses) and n_updates >= 10, f"{n_updates} optimizer steps")

        # the EMA validated: 32 val images at batch TRAIN_BATCH, counted; hooks (which launch nothing) keep
        # what the first val batch hands each fused bottleneck and the head's output, the keep kernel's source
        n_val = len(list(Path(data["val"]).iterdir()))
        require(n_val % TRAIN_BATCH == 0, f"{n_val} val images")
        expect = {"fused_bottleneck": 6 * (n_val // TRAIN_BATCH), "fused_bottleneck_bf16": 0,
                  "greedy_keep": n_val // TRAIN_BATCH}
        model = trainer.ema_eval_model()  # the model validate() scores, made here so it can be hooked
        fused = {name: m for name, m in model.named_modules() if isinstance(m, Bottleneck) and m.fusable}
        captured = {}

        def keep_feats(mod, args, out):
            captured.setdefault("feats", out)

        hooks = [m.register_forward_pre_hook(keep_nhwc_input(captured)) for m in fused.values()]
        hooks.append(model.model[-1].register_forward_hook(keep_feats))
        t0 = time.perf_counter()
        results, val_launches = run_counted(trainer.validate, expect, "validate() of the EMA")
        val_s = time.perf_counter() - t0
        for h in hooks:
            h.remove()
        require(trainer.ema_model is model, "validate() scored another model than the hooked EMA model")
        require(all(0.0 <= v <= 1.0 for v in results.values()), f"EMA val results {results}")

        # each fused bottleneck at the input the EMA's val gave it: the kernel against its plain version on
        # the module's packs, and the module against the plain bottleneck on BN folded from the EMA's weights
        # now (a stale fold fails here)
        checks, fold_err = {}, 0.0
        with torch.inference_mode():
            for name, m in fused.items():
                nhwc = captured[m]
                checks[name] = {k: v for k, v in bottleneck_check(f"EMA {name}", layer_case(m, nhwc)).items()
                                if "args" not in k}
                (w1, b1), (w2, b2) = m.cv1.folded(), m.cv2.folded()
                ref = bottleneck_reference(nhwc, w1.permute(2, 3, 1, 0), b1, w2.permute(2, 3, 1, 0), b2)
                err = (m(nhwc.permute(0, 3, 1, 2)).permute(0, 2, 3, 1) - ref).abs()
                require(bool((err <= 1e-4 + 1e-4 * ref.abs()).all()), f"EMA bottleneck {name} runs stale weights")
                fold_err = max(fold_err, float(err.max()))
            shapes = sorted(c["shape"] for c in checks.values())
            require(shapes == [[TRAIN_BATCH, 20, 20, 64]] * 4 + [[TRAIN_BATCH, 40, 40, 32]] * 2,
                    f"EMA val bottleneck inputs {shapes}")

            # the keep kernel on the first val batch's candidates at the validator's settings
            preds = decode_detections(captured["feats"], model.nc, model.stride)
            _, _, _, valid, offset_boxes = nms_candidates(preds, 0.001, model.nc, multi_label=True,
                                                          pre_nms_topk=VAL_PRE_NMS_TOPK)
            require(valid.shape == (TRAIN_BATCH, VAL_PRE_NMS_TOPK), f"EMA val candidates {tuple(valid.shape)}")
            nms = nms_check(offset_boxes, valid)

        # the card's val of the EMA against the CPU's on the first 4 images
        (Path(tmp) / "val4.txt").write_text("\n".join(sorted(str(p) for p in Path(data["val"]).iterdir())[:4]))
        sub = dict(data, val=str(Path(tmp) / "val4.txt"))
        kw = {"data": sub, "imgsz": TRAIN_IMGSZ, "batch": 4}
        card4 = DetectionValidator(model, dict(kw, plots=False, device="cuda"))()
        cpu4 = DetectionValidator(copy.deepcopy(model).cpu(), dict(kw, plots=False, device="cpu"))()
        diff4 = {k: abs(card4[k] - cpu4[k]) for k in card4}
        require(max(diff4.values()) <= VAL_TOL, f"the EMA's val on 4 images: card {card4}, CPU {cpu4}")

        # train_step on 6 further steps, timed with its split
        later = timed_steps(trainer, batches, range(TRAIN_STEPS, TRAIN_STEPS + 6))

        # the profile of 3 steps: busy share, top kernels, launches per step
        prof = profile_steps(trainer, batches, TRAIN_STEPS + 6, top=15)

        # B = 32 if it fits
        b32 = {}
        del batches, trainer, model
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        try:
            t32 = new_trainer(data, TRAIN_IMGSZ, 2 * TRAIN_BATCH, "cuda")
            batches32 = train_batches(data["train"], TRAIN_IMGSZ, 2 * TRAIN_BATCH, dev)
            steps32 = timed_steps(t32, batches32, range(6))
            b32 = dict(ms_per_step=steps32["ms_per_step"][2:],
                       peak_memory_gib=torch.cuda.max_memory_allocated() / 2**30)
            del t32, batches32
        except torch.cuda.OutOfMemoryError as e:
            b32 = {"not_run": f"out of device memory at B = {2 * TRAIN_BATCH}: {str(e)[:200]}"}
        torch.cuda.empty_cache()
        check = train_card_vs_cpu(data)
    emit("train", imgsz=TRAIN_IMGSZ, batch=TRAIN_BATCH, steps=TRAIN_STEPS, generate_s=generate_s,
         optimizer=opt, launches=launches, ms_per_step=steps_ms / TRAIN_STEPS, later_steps=later,
         later_split_ms_mean={n: sum(v) / len(v) for n, v in later["split_ms_by_step"].items()},
         profile=prof,
         peak_memory_gib=peak_gb, loss_items_per_step=losses, optimizer_steps=n_updates,
         ema_val={"results": results, "launches": val_launches, "seconds": val_s,
                  "fused_bottleneck_checks": checks, "fold_max_abs_err": fold_err, "greedy_keep_k2048": nms,
                  "card_vs_cpu_4_images": {"card": card4, "cpu": cpu4, "abs_diff": diff4}},
         batch32=b32, card_vs_cpu=check,
         method="the main path's steps through DetectionTrainer.train_step, CUDA events around all of them; 6 "
                "later steps one by one, CUDA events around each train_step call and its split from the events "
                "train_step records between its parts; the profile over 3 steps by torch.profiler; batches from "
                "the val loader over the train split (no augmentation); the kernels checked on the inputs the "
                "EMA's first val batch gave them")
    return val_launches, checks, nms


def phase_train_loop():
    """YOLO(ckpt).train on the synthetic split (128 train + 32 val PNG at 640 px)
    at TRAIN_BATCH, amp=False, close_mosaic=1, for LOOP_EPOCHS epochs: the
    augmenting loader (mosaic, warp, HSV and flips; the image half on the
    card), the epoch loop and each epoch's EMA val. Counted from 0 just
    before the call and read just after (no launch in the steps, 6 + 1 per
    val batch), per epoch by callbacks; each kernel against its plain version
    on the first val's inputs; augment_batch on the card against the CPU on
    the first batch; YOLO(best.ckpt).val against the metrics of the epoch
    best.ckpt was saved at; a resume from last.ckpt as it stood after 2
    epochs. Readings: seconds per epoch, ms per step with the loader's wait,
    the wait, the split of train_step (upload and augment by CUDA events), the
    busy share over 3 steps, val seconds, the final EMA's mAP50-95."""
    import csv
    import shutil
    import tempfile

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from spectrogram_yolov11_torch import YOLO
    from spectrogram_yolov11_torch.cfg import DEFAULT_CFG_DICT, get_cfg
    from spectrogram_yolov11_torch.data.build import DataLoader
    from spectrogram_yolov11_torch.data.dataset import YOLODataset, check_det_dataset, find_dataset_yaml
    from spectrogram_yolov11_torch.engine.checkpoint import load_checkpoint
    from spectrogram_yolov11_torch.engine.validator import VAL_PRE_NMS_TOPK
    from spectrogram_yolov11_torch.nn.modules.block import Bottleneck
    from spectrogram_yolov11_torch.ops.decode import decode_detections
    from spectrogram_yolov11_torch.ops.device_augment import augment_batch
    from spectrogram_yolov11_torch.ops.nms import nms_candidates
    from spectrogram_yolov11_torch.utils import yaml_load

    counters = launch_counters()
    kw = dict(epochs=LOOP_EPOCHS, batch=TRAIN_BATCH, imgsz=TRAIN_IMGSZ, amp=False, close_mosaic=1, workers=8,
              exist_ok=True)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        data = check_det_dataset(dict(yaml_load(find_dataset_yaml("spectrogram_synth.yaml")), path=tmp))
        generate_s = time.perf_counter() - t0
        n_val = len(list(Path(data["val"]).iterdir()))
        per_val = {"fused_bottleneck": 6 * (n_val // TRAIN_BATCH), "fused_bottleneck_bf16": 0,
                   "greedy_keep": n_val // TRAIN_BATCH}

        # the first batch the loader gives: augment_batch on the card against the CPU
        ds = YOLODataset(data["train"], imgsz=TRAIN_IMGSZ, max_gt=0, augment=True,
                         hyp=get_cfg(DEFAULT_CFG_DICT, {"mode": "train", **kw}))
        first = next(iter(DataLoader(ds, TRAIN_BATCH, workers=8, shuffle=True, seed=0, drop_last=True)))
        args = [torch.from_numpy(first[k]) for k in ("aug_src", "aug_regions", "aug_pads", "aug_inv", "aug_hsv")]
        card_img = augment_batch(*(a.cuda() for a in args))
        cpu_img = augment_batch(*args)
        aug_unequal = int((card_img.cpu() != cpu_img).sum())
        require(aug_unequal == 0, f"augment_batch on the card differs from the CPU's at {aug_unequal} values")
        serial_ms = {}  # one thread, no training beside it: what a sample costs the host
        for label in ("mosaic", "single_image"):
            if label == "single_image":
                ds.close_mosaic()
            t0 = time.perf_counter()
            for i in range(8):
                ds.get_item(i, np.random.default_rng(i))
            serial_ms[label] = (time.perf_counter() - t0) / 8 * 1e3
        dev_args = [a.cuda() for a in args]
        aug_check = dict(shape=list(card_img.shape), unequal=aug_unequal, host_ms_per_sample_serial=serial_ms,
                         mosaic_samples=int(
            (first["aug_regions"][:, 1:] != 0).any((1, 2)).sum()), ms=cuda_ms(lambda: augment_batch(*dev_args), iters=5))
        del card_img, cpu_img, args, dev_args, first

        # callbacks: per-epoch counts, the kernels' inputs on the first val, the split of epoch 1's steps,
        # the profile of its steps 3-5, last.ckpt after 2 epochs
        len_epoch = 128 // TRAIN_BATCH
        profiled_steps = (3, 4, 5)
        rec = {"counts": [], "split": [], "captured": {}, "hooks": [], "step": 0}
        counts = lambda: {k: c.launches for k, c in counters.items()}  # noqa: E731

        def keep_feats(mod, args, out) -> None:  # returns None: the head's output stays as it is
            rec["captured"].setdefault("feats", out)

        def on_start(t):
            model = t.ema_eval_model()  # the model each validate() scores, made here so it can be hooked
            rec["fused"] = {n: m for n, m in model.named_modules() if isinstance(m, Bottleneck) and m.fusable}
            rec["model"] = model
            rec["hooks"] = [m.register_forward_pre_hook(keep_nhwc_input(rec["captured"])) for m in rec["fused"].values()]
            rec["hooks"].append(model.model[-1].register_forward_hook(keep_feats))

        def on_epoch_start(t):
            if t.epoch == 2:  # last.ckpt as the first 2 epochs left it
                shutil.copy(t.last, Path(tmp) / "last_after_2_epochs.ckpt")
            rec["counts"].append({"epoch": t.epoch, "start": counts()})
            t.split_events = [] if t.epoch == 1 else None

        def on_batch_end(t):
            rec["step"] += 1
            rec["counts"][-1]["steps"] = counts()
            if t.epoch == 1 and rec["step"] - t.epoch * len_epoch == profiled_steps[0] - 1:
                torch.cuda.synchronize()
                rec["prof"] = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
                rec["prof"].start()
            elif rec.get("prof") is not None and rec["step"] - t.epoch * len_epoch == profiled_steps[-1]:
                torch.cuda.synchronize()
                rec["prof"].stop()
                rec["profiled"], rec["prof"] = rec["prof"], None

        def on_fit_epoch_end(t):
            rec["counts"][-1]["val"] = counts()
            if t.split_events:
                marks, t.split_events = t.split_events, None
                steps = [marks[i : i + 7] for i in range(0, len(marks), 7)]
                rec["split"] = [{name: a.elapsed_time(b) for (_, a), (name, b) in zip(s, s[1:])} for s in steps]

        yolo = YOLO(CKPT)
        for event, fn in (("on_train_start", on_start), ("on_train_epoch_start", on_epoch_start),
                          ("on_train_batch_end", on_batch_end), ("on_fit_epoch_end", on_fit_epoch_end)):
            yolo.add_callback(event, fn)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        metrics, launches = run_counted(lambda: yolo.train(plots=False, data=data, project=tmp, name="loop", **kw),
                                        {k: LOOP_EPOCHS * v for k, v in per_val.items()}, "YOLO.train")
        train_s = time.perf_counter() - t0
        peak_gb = torch.cuda.max_memory_allocated() / 2**30
        for h in rec["hooks"]:
            h.remove()
        trainer = yolo.trainer
        require(trainer.ema_model is rec["model"], "validate() scored another model than the hooked EMA model")
        RUN_FILES["train_loop"] = run_files(trainer.save_dir, LOOP_EPOCHS)
        keep_checkpoint(trainer.best)
        by_epoch = []
        for c in rec["counts"]:
            steps = {k: c["steps"][k] - c["start"][k] for k in c["start"]}
            val = {k: c["val"][k] - c["steps"][k] for k in c["start"]}
            require(not any(steps.values()) and val == per_val, f"epoch {c['epoch']}: steps {steps}, val {val}")
            by_epoch.append({"epoch": c["epoch"], "steps": steps, "val": val})
        rows = list(csv.DictReader(open(trainer.csv)))
        require(len(rows) == LOOP_EPOCHS and all(np.isfinite([float(v) for v in r.values()]).all() for r in rows),
                f"results.csv {rows}")
        require(all(0.0 <= v <= 1.0 for v in metrics.values()), f"final EMA val {metrics}")

        # each kernel on the first val's inputs, against its plain version
        checks = {}
        with torch.inference_mode():
            for name, m in rec["fused"].items():
                checks[name] = {k: v for k, v in bottleneck_check(f"loop EMA {name}",
                                                                  layer_case(m, rec["captured"][m])).items()
                                if "args" not in k}
            model = rec["model"]
            preds = decode_detections(rec["captured"]["feats"], model.nc, model.stride)
            _, _, _, valid, offset_boxes = nms_candidates(preds, 0.001, model.nc, multi_label=True,
                                                          pre_nms_topk=VAL_PRE_NMS_TOPK)
            nms = nms_check(offset_boxes, valid)
        shapes = sorted(c["shape"] for c in checks.values())
        require(shapes == [[TRAIN_BATCH, 20, 20, 64]] * 4 + [[TRAIN_BATCH, 40, 40, 32]] * 2, f"val inputs {shapes}")

        # best.ckpt (stripped) validates to the metrics of the epoch it was saved at
        best_tree, best_meta = load_checkpoint(trainer.best)
        require(best_tree["ema"] is None and best_tree["opt_state"] is None, "best.ckpt is not stripped")
        best_row = {k: float(v) for k, v in rows[int(best_meta["epoch"])].items()}
        best_val = YOLO(trainer.best).val(plots=False, data=data, batch=TRAIN_BATCH, imgsz=TRAIN_IMGSZ)
        best_diff = {k: abs(best_val[k] - best_row[k]) for k in best_val}
        require(max(best_diff.values()) <= VAL_TOL, f"best.ckpt validates to {best_val}, its epoch {best_row}")

        # a resume from last.ckpt as it stood after 2 epochs
        saved_tree, saved_meta = load_checkpoint(Path(tmp) / "last_after_2_epochs.ckpt")
        seen = {}
        resumed = YOLO(CKPT)
        resumed.add_callback("on_train_start", lambda t: seen.update(
            start_epoch=t.start_epoch, step=t.state["opt"]["step"], ema_updates=t.state["ema_updates"]))
        resumed_metrics = resumed.train(plots=False, data=data, project=tmp, name="resumed",
                                        resume=str(Path(tmp) / "last_after_2_epochs.ckpt"), **kw)
        want = dict(start_epoch=2, step=int(saved_tree["opt_state"]["step"]), ema_updates=int(saved_meta["updates"]))
        require(seen == want and saved_meta["epoch"] == 1, f"resume started at {seen}, the checkpoint holds {want}")
        require(len(list(csv.DictReader(open(resumed.trainer.csv)))) == 1, "the resumed run trained another epoch count")

        # readings
        log = trainer.epoch_log
        unprofiled = [s for i, s in enumerate(rec["split"], 1) if i not in profiled_steps]
        split_mean = {k: float(np.mean([s[k] for s in unprofiled])) for k in unprofiled[0]}
        kernels = [e for e in rec["profiled"].events() if e.device_type == torch.autograd.DeviceType.CUDA]
        busy = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
        span = (max(e.time_range.end for e in kernels) - min(e.time_range.start for e in kernels)) / 1e3
    emit("train_loop", epochs=LOOP_EPOCHS, batch=TRAIN_BATCH, imgsz=TRAIN_IMGSZ, generate_s=generate_s,
         train_call_s=train_s, launches=launches, launches_by_epoch=by_epoch, peak_memory_gib=peak_gb,
         epochs_log=log,
         ms_per_step_with_wait=[(e["seconds"] - e["val_s"]) / e["steps"] * 1e3 for e in log],
         loader_wait_ms_per_step=[e["loader_wait_s"] / e["steps"] * 1e3 for e in log],
         val_s=[e["val_s"] for e in log],
         train_step_split_ms_epoch1={"mean_outside_the_profile": split_mean, "by_step": rec["split"]},
         profile_3_steps={"kernel_launches_per_step": len(kernels) / 3, "device_kernel_ms_per_step": busy / 3,
                          "span_ms_per_step": span / 3, "busy_share": busy / span},
         results_csv=rows, final_ema=metrics, augment_card_vs_cpu=aug_check,
         ema_val_checks={"fused_bottleneck": checks, "greedy_keep_k2048": nms},
         best_ckpt={"epoch": int(best_meta["epoch"]), "val": best_val, "abs_diff_to_its_epoch": best_diff},
         resume={"started": seen, "metrics": resumed_metrics},
         method="YOLO(ckpt).train through the augmenting loader; counts from 0 around the call and per epoch by "
                "callbacks; the split from the CUDA events train_step records (epoch 1); the profile over steps "
                "3-5 of epoch 1 (torch.profiler, loader waits included); epochs_log from the trainer's host clock")
    return launches, checks, nms, metrics


def amp_card_vs_cpu(data: dict) -> dict:
    """One accumulation step and one AdamW step (ni 3, 4) of the trained model
    at TRAIN_CHECK px, B = TRAIN_CHECK_BATCH, amp=True, on the card with TF32
    turned on for the process and on this machine's CPU, from the same weights
    and batch, with the card's f32 step beside them: per quantity (loss items,
    grads, params, both moments, BN statistics, their EMA) over all its
    leaves, ||card bf16 - CPU bf16|| within AMP_MULTIPLE times the card's own
    bf16-to-f32 distance ||card bf16 - card f32|| (tests/test_torch_train_amp.py
    says why 3), every state tensor f32."""
    import torch

    batch = train_batches(data["train"], TRAIN_CHECK, TRAIN_CHECK_BATCH, torch.device("cpu"))[0]
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    runs = {}
    try:
        for name, dev, amp in (("card_bf16", "cuda", True), ("cpu_bf16", "cpu", True), ("card_f32", "cuda", False)):
            t = new_trainer(dict(data), TRAIN_CHECK, TRAIN_CHECK_BATCH, dev, amp=amp)
            items, grads = [], None
            for ni, do_step in ((3, False), (4, True)):
                items.append(t.train_step(batch, ni, do_step)[1].cpu())
                if not do_step:
                    grads = [g.cpu().clone() for g in t.state["grad_buf"]]
            st = t.state
            runs[name] = {"items": items, "grads": grads, "params": t.params, "mu": st["opt"]["mu"],
                          "nu": st["opt"]["nu"], "batch_stats": t.stats, "ema_params": st["ema"]["params"],
                          "ema_batch_stats": st["ema"]["batch_stats"]}
            if amp:
                require(t.model.compute_dtype == torch.bfloat16 and all(
                    x.dtype == torch.float32 for k, v in runs[name].items() if k != "items" for x in v),
                    f"{name}: a state tensor is not f32")
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
    vec = lambda ts: torch.cat([t.detach().float().cpu().flatten() for t in ts])  # noqa: E731
    dist = {}
    for k in runs["card_bf16"]:
        a, b, f = (vec(runs[n][k]) for n in ("card_bf16", "cpu_bf16", "card_f32"))
        n = float(b.norm())
        err, yard = float((a - b).norm()) / n, float((a - f).norm()) / n
        require(err <= AMP_MULTIPLE * yard + 1e-6, f"amp step {k}: card bf16 lies {err} from the CPU's, "
                                                   f"the card's bf16-to-f32 distance is {yard}")
        dist[k] = {"card_bf16_vs_cpu_bf16": err, "card_bf16_vs_card_f32": yard}
    return dict(imgsz=TRAIN_CHECK, batch=TRAIN_CHECK_BATCH, process_tf32=True, multiple=AMP_MULTIPLE,
                relative_l2=dist, items={n: [i.tolist() for i in r["items"]] for n, r in runs.items()})


def phase_train_amp(f32_loop_final: dict):
    """bf16 training, amp=True (JAX's default): the trained model at TRAIN_IMGSZ
    px, B = TRAIN_BATCH, optimizer auto (AdamW), TRAIN_STEPS steps on the
    synthetic split's train images through the val loader (as phase train),
    counted (no kernel launches: the training convs are cuDNN's); 6 later
    steps timed with train_step's split, the profile of 3 steps beside 3 f32
    steps of an f32 trainer, peak memory, B = 32; the card's bf16 step
    against the CPU's at TRAIN_CHECK px with TF32 on. Then
    YOLO(ckpt).train(epochs=AMP_EPOCHS, batch=TRAIN_BATCH, imgsz=TRAIN_IMGSZ,
    close_mosaic=1) at the default amp, counted from 0 around the call and per
    epoch (each EMA val runs a bf16 copy of the EMA: 6 bf16 bottleneck + 1
    NMS launches per val batch, no f32 bottleneck); each kernel against its
    plain version on the inputs the first val gave it (global module hooks,
    which launch nothing); the final EMA's bf16 mAP beside the f32 loop's."""
    import tempfile

    import numpy as np
    import torch

    from spectrogram_yolov11_torch import YOLO
    from spectrogram_yolov11_torch.data.dataset import check_det_dataset, find_dataset_yaml
    from spectrogram_yolov11_torch.engine.checkpoint import load_checkpoint
    from spectrogram_yolov11_torch.utils import yaml_load

    dev, bf16 = torch.device("cuda"), torch.bfloat16
    zero = {"fused_bottleneck": 0, "fused_bottleneck_bf16": 0, "greedy_keep": 0}
    counters = launch_counters()
    with tempfile.TemporaryDirectory() as tmp:
        data = check_det_dataset(dict(yaml_load(find_dataset_yaml("spectrogram_synth.yaml")), path=tmp))
        batches = train_batches(data["train"], TRAIN_IMGSZ, TRAIN_BATCH, dev)
        trainer = new_trainer(data, TRAIN_IMGSZ, TRAIN_BATCH, "cuda", amp=True)
        require(trainer.model.compute_dtype == bf16 and trainer.opt.kind == "adamw", "the amp trainer's set-up")

        # the main path: TRAIN_STEPS steps, counts set to 0 just before and read just after
        torch.cuda.reset_peak_memory_stats()

        def steps():
            out, start, end = [], torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for ni in range(TRAIN_STEPS):
                do_step = trainer.step_due(ni)
                out.append((ni, do_step, trainer.train_step(batches[ni % len(batches)], ni, do_step)))
            end.record()
            return out, start, end

        (done, start, end), launches = run_counted(steps, zero, f"{TRAIN_STEPS} amp train steps")
        steps_ms = start.elapsed_time(end)
        peak_gb = torch.cuda.max_memory_allocated() / 2**30
        losses = [[ni, do_step, float(loss), items.tolist()] for ni, do_step, (loss, items) in done]
        require(all(np.isfinite(r[3]).all() and r[2] > 0 for r in losses), f"amp losses {losses}")
        st = trainer.state
        state = (*trainer.params, *trainer.stats, *st["grad_buf"], *st["opt"]["mu"], *st["opt"]["nu"],
                 *st["ema"]["params"], *st["ema"]["batch_stats"])
        require(all(x.dtype == torch.float32 for x in state), "an amp state tensor is not f32")

        # later steps timed with their split, the profile beside an f32 trainer's, in turns
        later = timed_steps(trainer, batches, range(TRAIN_STEPS, TRAIN_STEPS + 6))
        f32 = new_trainer(data, TRAIN_IMGSZ, TRAIN_BATCH, "cuda")
        later_f32 = timed_steps(f32, batches, range(TRAIN_STEPS, TRAIN_STEPS + 6))  # its first steps warm it up
        profile_steps(f32, batches, TRAIN_STEPS + 6, n=1)  # the profiler's own set-up lands here, not in a reading
        prof = profile_steps(trainer, batches, TRAIN_STEPS + 6)
        prof_f32 = profile_steps(f32, batches, TRAIN_STEPS + 7)
        prof_again = profile_steps(trainer, batches, TRAIN_STEPS + 9)
        del f32, batches, trainer
        torch.cuda.empty_cache()

        # B = 32 if it fits
        torch.cuda.reset_peak_memory_stats()
        try:
            t32 = new_trainer(data, TRAIN_IMGSZ, 2 * TRAIN_BATCH, "cuda", amp=True)
            batches32 = train_batches(data["train"], TRAIN_IMGSZ, 2 * TRAIN_BATCH, dev)
            b32 = dict(ms_per_step=timed_steps(t32, batches32, range(6))["ms_per_step"][2:],
                       peak_memory_gib=torch.cuda.max_memory_allocated() / 2**30)
            del t32, batches32
        except torch.cuda.OutOfMemoryError as e:
            b32 = {"not_run": f"out of device memory at B = {2 * TRAIN_BATCH}: {str(e)[:200]}"}
        torch.cuda.empty_cache()
        check = amp_card_vs_cpu(data)

        # YOLO.train at the default amp, counted; global hooks keep what the first val hands the bf16
        # bottlenecks and the head's output
        n_val = len(list(Path(data["val"]).iterdir()))
        per_val = {"fused_bottleneck": 0, "fused_bottleneck_bf16": 6 * (n_val // TRAIN_BATCH),
                   "greedy_keep": n_val // TRAIN_BATCH}
        rec = {"counts": []}
        counts = lambda: {k: c.launches for k, c in counters.items()}  # noqa: E731
        cap, stop = capture_val_inputs(bf16)

        def on_epoch_start(t):
            rec["counts"].append({"epoch": t.epoch, "start": counts()})

        def on_batch_end(t):
            rec["counts"][-1]["steps"] = counts()

        def on_fit_epoch_end(t):
            rec["counts"][-1]["val"] = counts()
            stop()  # the first val's inputs only

        yolo = YOLO(CKPT)
        for event, fn in (("on_train_epoch_start", on_epoch_start), ("on_train_batch_end", on_batch_end),
                          ("on_fit_epoch_end", on_fit_epoch_end)):
            yolo.add_callback(event, fn)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        try:
            metrics, loop_launches = run_counted(
                lambda: yolo.train(plots=False, data=data, project=tmp, name="amp", epochs=AMP_EPOCHS, batch=TRAIN_BATCH,
                                   imgsz=TRAIN_IMGSZ, close_mosaic=1, workers=8, exist_ok=True),
                {k: AMP_EPOCHS * v for k, v in per_val.items()}, "YOLO.train at amp=True")
        finally:
            stop()
        train_s = time.perf_counter() - t0
        loop_peak_gb = torch.cuda.max_memory_allocated() / 2**30
        tr = yolo.trainer
        require(tr.args.amp is True and yolo.model.compute_dtype == bf16, "YOLO.train did not run at amp=True")
        RUN_FILES["train_amp"] = run_files(tr.save_dir, AMP_EPOCHS)
        require(tr.validator.model.dtype == bf16, "the EMA's val did not run a bf16 copy")
        by_epoch = []
        for c in rec["counts"]:
            steps_c = {k: c["steps"][k] - c["start"][k] for k in c["start"]}
            val_c = {k: c["val"][k] - c["steps"][k] for k in c["start"]}
            require(not any(steps_c.values()) and val_c == per_val,
                    f"epoch {c['epoch']}: steps {steps_c}, val {val_c}")
            by_epoch.append({"epoch": c["epoch"], "steps": steps_c, "val": val_c})
        require(all(0.0 <= v <= 1.0 for v in metrics.values()), f"final amp EMA val {metrics}")
        ckpt_amp = load_checkpoint(tr.last)[1]["train_args"]["amp"]
        require(ckpt_amp is True, f"last.ckpt's train_args.amp is {ckpt_amp}")

        # each kernel on the first val's inputs, against its plain version
        checks, nms = kernels_at(cap, yolo.model.nc, yolo.model.stride, "amp EMA", TRAIN_BATCH, TRAIN_IMGSZ)
        log = tr.epoch_log
    emit("train_amp", imgsz=TRAIN_IMGSZ, batch=TRAIN_BATCH, steps=TRAIN_STEPS, launches=launches,
         ms_per_step=steps_ms / TRAIN_STEPS, later_steps=later,
         later_split_ms_mean={n: sum(v) / len(v) for n, v in later["split_ms_by_step"].items()},
         f32_later_steps=later_f32,
         f32_later_split_ms_mean={n: sum(v) / len(v) for n, v in later_f32["split_ms_by_step"].items()},
         profile=prof, profile_f32=prof_f32, profile_again=prof_again, peak_memory_gib=peak_gb,
         loss_items_per_step=losses, batch32=b32, card_vs_cpu=check,
         loop={"epochs": AMP_EPOCHS, "train_call_s": train_s, "launches": loop_launches,
               "launches_by_epoch": by_epoch, "epochs_log": log,
               "ms_per_step_with_wait": [(e["seconds"] - e["val_s"]) / e["steps"] * 1e3 for e in log],
               "loader_wait_ms_per_step": [e["loader_wait_s"] / e["steps"] * 1e3 for e in log],
               "val_s": [e["val_s"] for e in log], "peak_memory_gib": loop_peak_gb, "final_ema_bf16": metrics,
               "f32_loop_final_ema": f32_loop_final, "ckpt_train_args_amp": ckpt_amp,
               "ema_val_checks": {"fused_bottleneck_bf16": checks, "greedy_keep_k2048": nms}},
         method="train steps through DetectionTrainer.train_step at amp=True, CUDA events; 6 later steps one by one "
                "with the split train_step records, then 6 of an f32 trainer; the profiles over 3 steps each "
                "(torch.profiler, after a 1-step profile that takes its set-up), amp, f32, amp; YOLO(ckpt).train "
                "at its defaults counted from 0 around the call and per epoch by callbacks; the kernels checked on the first val's inputs (global module hooks)")
    return loop_launches, checks, nms


def capture_val_inputs(dtype):
    """Global module hooks that keep what the eval-mode forwards at `dtype`
    hand the fused bottlenecks (NHWC) and what the Detect head gives, the
    first of each; they launch nothing. Returns (captured, stop), stop()
    removing the hooks."""
    import torch

    from spectrogram_yolov11_torch.nn.modules.block import Bottleneck
    from spectrogram_yolov11_torch.nn.modules.head import Detect

    cap = {}

    def pre(mod, args):  # returns None: the input stays as it is
        if isinstance(mod, Bottleneck) and mod.fusable and not mod.training and args[0].dtype == dtype:
            cap.setdefault(mod, args[0].permute(0, 2, 3, 1).contiguous())

    def post(mod, args, out):  # returns None: the output stays as it is; an end2end head's dict is not kept
        if isinstance(mod, Detect) and not mod.training and not isinstance(out, dict) and out[0][0].dtype == dtype:
            cap.setdefault("feats", out)

    hooks = [torch.nn.modules.module.register_module_forward_pre_hook(pre),
             torch.nn.modules.module.register_module_forward_hook(post)]

    def stop():
        for h in hooks:
            h.remove()
        hooks.clear()

    return cap, stop


def kernels_at(cap: dict, nc: int, stride, what: str, batch: int, imgsz: int, multi_label: bool = True):
    """Each fused bottleneck and the keep kernel against their plain versions
    on the inputs `cap` kept (capture_val_inputs): (bottleneck checks, NMS
    check). The keep kernel at the validator's candidates: multi-label for
    detect, single-label for segment and pose (non_max_suppression_extras),
    k = 2048. Fails unless the six bottlenecks of a scale-n model at `batch`
    and `imgsz` were seen."""
    import torch

    from spectrogram_yolov11_torch.engine.validator import VAL_PRE_NMS_TOPK
    from spectrogram_yolov11_torch.ops.decode import decode_detections
    from spectrogram_yolov11_torch.ops.nms import nms_candidates

    checks = bottlenecks_at(cap, what, batch, imgsz)
    with torch.inference_mode():
        preds = decode_detections(cap["feats"], nc, stride)
        _, _, _, valid, offset_boxes = nms_candidates(preds, 0.001, nc, multi_label=multi_label,
                                                      pre_nms_topk=VAL_PRE_NMS_TOPK)
        nms = nms_check(offset_boxes, valid)
    return checks, nms


def phase_scratch():
    """Models from YAML on the synthetic split (128 train + 32 val PNG at 640
    px): YOLO("yolo11n.yaml").train(epochs=SCRATCH_EPOCHS, batch=TRAIN_BATCH,
    imgsz=TRAIN_IMGSZ) at its defaults (amp, seed 0) with the nc 80 -> 2
    rebuild, counted from 0 around the call and per epoch, the kernels at the
    first EMA val's inputs; YOLO("spectrogram_yolo11n.yaml").load(ckpt) and
    its f32 val against YOLO(ckpt).val, equal, counted, the kernels at its
    inputs; save and its val; the command line's detect val and detect
    train in subprocesses; info() of both YAML models on the card."""
    import csv
    import tempfile

    import numpy as np
    import torch

    from spectrogram_yolov11_torch import YOLO
    from spectrogram_yolov11_torch.data.dataset import check_det_dataset, find_dataset_yaml
    from spectrogram_yolov11_torch.utils import yaml_load

    bf16 = torch.bfloat16
    counters = launch_counters()
    counts = lambda: {k: c.launches for k, c in counters.items()}  # noqa: E731
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        data = check_det_dataset(dict(yaml_load(find_dataset_yaml("spectrogram_synth.yaml")), path=tmp))
        n_val = len(list(Path(data["val"]).iterdir()))
        per_val = {"fused_bottleneck": 0, "fused_bottleneck_bf16": 6 * (n_val // TRAIN_BATCH),
                   "greedy_keep": n_val // TRAIN_BATCH}

        # 1. from scratch: yolo11n (nc 80) on 2-class data, rebuilt, at the defaults
        yolo = YOLO("yolo11n.yaml")
        require(yolo.model.nc == 80 and yolo.model.yaml["scale"] == "n", "YOLO('yolo11n.yaml') is not yolo11 at n")
        rec = {"counts": []}
        cap, stop = capture_val_inputs(bf16)
        yolo.add_callback("on_train_epoch_start", lambda t: rec["counts"].append({"epoch": t.epoch, "start": counts()}))
        yolo.add_callback("on_train_batch_end", lambda t: rec["counts"][-1].update(steps=counts()))

        def on_fit_epoch_end(t):
            rec["counts"][-1]["val"] = counts()
            stop()  # the first EMA val's inputs only

        yolo.add_callback("on_fit_epoch_end", on_fit_epoch_end)
        t0 = time.perf_counter()
        try:
            metrics, launches = run_counted(
                lambda: yolo.train(plots=False, data=data, project=tmp, name="scratch", epochs=SCRATCH_EPOCHS, batch=TRAIN_BATCH,
                                   imgsz=TRAIN_IMGSZ, workers=8, exist_ok=True),
                {k: SCRATCH_EPOCHS * v for k, v in per_val.items()}, "YOLO('yolo11n.yaml').train")
        finally:
            stop()
        train_s = time.perf_counter() - t0
        tr = yolo.trainer
        require(tr.rebuilt == {"nc": (80, 2), "grafted": SCRATCH_GRAFTED}, f"the nc rebuild: {tr.rebuilt}")
        require(tr.args.amp is True and yolo.model.nc == 2 and tr.validator.model.dtype == bf16,
                "YOLO('yolo11n.yaml').train did not train the rebuilt model at amp=True")
        by_epoch = []
        for c in rec["counts"]:
            steps_c = {k: c["steps"][k] - c["start"][k] for k in c["start"]}
            val_c = {k: c["val"][k] - c["steps"][k] for k in c["start"]}
            require(not any(steps_c.values()) and val_c == per_val, f"epoch {c['epoch']}: steps {steps_c}, val {val_c}")
            by_epoch.append({"epoch": c["epoch"], "steps": steps_c, "val": val_c})
        rows = list(csv.DictReader(open(tr.csv)))
        losses = [[float(r[k]) for k in ("train/box_loss", "train/cls_loss", "train/dfl_loss")] for r in rows]
        require(len(rows) == SCRATCH_EPOCHS and np.isfinite(losses).all(), f"results.csv {rows}")
        require(all(0.0 <= v <= 1.0 for v in metrics.values()), f"the from-scratch EMA val {metrics}")
        checks, nms = kernels_at(cap, 2, yolo.model.stride, "scratch EMA", TRAIN_BATCH, TRAIN_IMGSZ)
        log = tr.epoch_log

        # 2. transfer: every leaf of the trained checkpoint into the YAML's model; val equal to the checkpoint's
        ref = YOLO(CKPT).val(plots=False, data=data, batch=VAL_BATCH)
        moved = YOLO("spectrogram_yolo11n.yaml").load(CKPT)
        require(moved.transferred == LOAD_TRANSFERRED, f"load transferred {moved.transferred} leaves")
        cap, stop = capture_val_inputs(torch.float32)
        try:
            loaded, load_launches = run_counted(
                lambda: moved.val(plots=False, data=data, batch=VAL_BATCH),
                {"fused_bottleneck": 6 * (n_val // VAL_BATCH), "fused_bottleneck_bf16": 0,
                 "greedy_keep": n_val // VAL_BATCH}, "YOLO(yaml).load(ckpt).val")
        finally:
            stop()
        require(loaded == ref, f"YOLO(yaml).load(ckpt).val {loaded} differs from YOLO(ckpt).val {ref}")
        load_checks, load_nms = kernels_at(cap, 2, moved.model.stride, "load val", VAL_BATCH, 640)
        moved.save(Path(tmp) / "saved.ckpt")
        resaved = YOLO(Path(tmp) / "saved.ckpt").val(plots=False, data=data, batch=VAL_BATCH)
        require(resaved == ref, f"YOLO(saved).val {resaved} differs from YOLO(ckpt).val {ref}")

        # 3. the command line, in subprocesses on the card
        yaml_path = Path(tmp) / "synth.yaml"
        yaml_path.write_text(f"path: {data['path']}\ntrain: images/train\nval: images/val\nnames:\n  0: LTE\n  1: RF\n")
        tiny = check_det_dataset({"path": str(Path(tmp) / "tiny"), "train": "images/train", "val": "images/val",
                                  "synthetic": "spectrogram", "n_train": 16, "n_val": 4, "gen_imgsz": 320,
                                  "seed": 1, "names": {0: "LTE", 1: "RF"}})
        tiny_yaml = Path(tmp) / "tiny.yaml"
        tiny_yaml.write_text(f"path: {tiny['path']}\ntrain: images/train\nval: images/val\nnames:\n  0: LTE\n  1: RF\n")
        cli = {}
        for verb, args in (("val", [f"model={CKPT}", f"data={yaml_path}", f"batch={VAL_BATCH}", "plots=False"]),
                           ("train", ["model=spectrogram_yolo11.yaml", f"data={tiny_yaml}", "epochs=1", "batch=8",
                                      "imgsz=320", "workers=4", f"project={tmp}", "name=cli", "exist_ok=True",
                                      "plots=False"])):
            t0 = time.perf_counter()
            r = subprocess.run([sys.executable, "-m", "spectrogram_yolov11_torch", "detect", verb, *args], cwd=ROOT,
                               capture_output=True, text=True, timeout=300)
            cli[verb] = {"rc": r.returncode, "seconds": time.perf_counter() - t0,
                         "last_line": (r.stdout.strip().splitlines() or [""])[-1]}
            require(r.returncode == 0, f"detect {verb} exited {r.returncode}: {r.stderr[-2000:]}")
        cli_val = json.loads(cli["val"]["last_line"])
        require(cli_val == ref, f"detect val printed {cli_val}, YOLO(ckpt).val gives {ref}")
        require((Path(tmp) / "cli" / "weights" / "last.ckpt").exists(), "detect train wrote no last.ckpt")

        # 4. info() on the card
        info = {}
        for name in ("yolo11n.yaml", "spectrogram_yolo11n.yaml"):
            m = YOLO(name)
            m.model.cuda()
            info[name] = m.info()
    emit("scratch", imgsz=TRAIN_IMGSZ, batch=TRAIN_BATCH, epochs=SCRATCH_EPOCHS, rebuilt=tr.rebuilt,
         launches=launches, launches_by_epoch=by_epoch, loss_items_by_epoch=losses, final_ema_bf16=metrics,
         epochs_log=log, train_call_s=train_s,
         ms_per_step_with_wait=[(e["seconds"] - e["val_s"]) / e["steps"] * 1e3 for e in log],
         loader_wait_ms_per_step=[e["loader_wait_s"] / e["steps"] * 1e3 for e in log],
         val_s=[e["val_s"] for e in log],
         ema_val_checks={"fused_bottleneck_bf16": checks, "greedy_keep_k2048": nms},
         load={"transferred": moved.transferred, "val": loaded, "ckpt_val": ref, "saved_val": resaved,
               "launches": load_launches, "checks": {"fused_bottleneck": load_checks, "greedy_keep_k2048": load_nms}},
         cli=cli, info=info, phase_s=time.perf_counter() - t_phase,
         method="YOLO('yolo11n.yaml').train at its defaults counted from 0 around the call and per epoch by "
                "callbacks; the kernels checked on the inputs of the first EMA val and of the load val (global "
                "module hooks); the command line in subprocesses (python -m spectrogram_yolov11_torch)")
    return launches, checks, nms, load_launches, load_checks, load_nms


def phase_save():
    """predict's saved output on the card: the host encoder against cv2's
    committed bytes; YOLO(ckpt).predict at its defaults (save=True) on the 32
    arrays in f32 and bf16 and on the JPEG fixture directory, counted, each
    written <stem>.jpg equal to the port's JPEG of the returned plot, the
    kernels at the arrays' inputs; `detect predict` in a process of its own;
    a YOLO(url) predict over the BYTES JPEG wire (SYT_WIRE_ENCODE=jpg).
    Readings: predict ms per image with save=True beside save=False, plot
    and encode ms per frame, serially and in 8 threads, bytes per frame."""
    import hashlib
    import os
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    import torch

    import spectrogram_yolov11_torch.serve as serve_module
    from spectrogram_yolov11_torch import YOLO
    from spectrogram_yolov11_torch.data.imageio import imdecode, imencode, imread
    from spectrogram_yolov11_torch.data.jpeg import encode_jpeg
    from spectrogram_yolov11_torch.nn.autobackend import AutoBackend
    from spectrogram_yolov11_torch.ops.decode import decode_detections
    from spectrogram_yolov11_torch.ops.nms import nms_candidates

    t_phase = time.perf_counter()
    # 1. the host encoder's bytes: cv2's committed encodes of frames decoded from the decoder's fixtures
    committed = json.loads((ENCODE_FIXTURES / "cv2_encoded.json").read_text())["files"]
    encoder = {}
    for name, d in committed.items():
        img = imread(JPEG_FIXTURES / d["source"])
        if d["crop"]:
            y0, y1, x0, x1 = d["crop"]
            img = img[y0:y1, x0:x1]
        data = encode_jpeg(np.ascontiguousarray(img[..., 0] if d["gray"] else img), d["quality"])
        digest = hashlib.sha256(data).hexdigest()
        require(digest == d["sha256"] and data == (ENCODE_FIXTURES / name).read_bytes(),
                f"{name}: the port's encode {digest} differs from cv2's {d['sha256']}")
        encoder[name] = {"bytes": len(data), "sha256": digest}

    def check_saved(results, save_dir: Path) -> int:
        """Every result's <stem>.jpg, and nothing else, each decoding to the
        port's JPEG of the result's plot; returns the files' bytes."""
        names = sorted(p.name for p in save_dir.iterdir())
        require(names == sorted(f"{Path(r.path).stem or 'image'}.jpg" for r in results),
                f"{save_dir} holds {names[:5]}... for {len(results)} results")
        total = 0
        for r in results:
            f = save_dir / f"{Path(r.path).stem or 'image'}.jpg"
            data = f.read_bytes()
            ref = imencode(".jpg", r.plot())
            want = imdecode(ref)
            want = np.repeat(want[..., None], 3, -1) if want.ndim == 2 else want
            require(data == ref and np.array_equal(imread(f), want), f"{f} is not the JPEG of its Results' plot")
            total += len(data)
        return total

    f32 = {"fused_bottleneck": 6, "fused_bottleneck_bf16": 0, "greedy_keep": 1}
    bf16 = {"fused_bottleneck": 0, "fused_bottleneck_bf16": 6, "greedy_keep": 1}
    arrays = _mixed_arrays(PREDICT_BATCH, seed=100)
    yolo = YOLO(CKPT)
    launches, checks, nms, saved_bytes, times = {}, {}, {}, {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        # 2. predict at its defaults on the 32 arrays, f32 and bf16, counted, the kernels at their inputs
        for key, half, expect, dtype in (("arrays_f32", False, f32, torch.float32),
                                         ("arrays_bf16", True, bf16, torch.bfloat16)):
            cap, stop = capture_val_inputs(dtype)
            try:
                results, launches[key] = run_counted(
                    lambda h=half, k=key: yolo.predict(arrays, batch=PREDICT_BATCH, half=h, project=tmp, name=k),
                    expect, f"predict {key} at its defaults")
            finally:
                stop()
            saved_bytes[key] = check_saved(results, Path(tmp) / key)
            net = yolo.predictor.model
            with torch.inference_mode():
                checks[key] = {}
                for i, m in enumerate(m for m in cap if m != "feats"):
                    d = bottleneck_check(f"save {key} {i}", layer_case(m, cap[m]))
                    checks[key][f"bottleneck{i}"] = {k: v for k, v in d.items() if "args" not in k}
                preds = decode_detections(cap["feats"], net.nc, net.stride)
                _, _, _, valid, offset_boxes = nms_candidates(preds, 0.25, net.nc, pre_nms_topk=1024)
                nms[key] = nms_check(offset_boxes, valid)
            shapes = sorted(c["shape"] for c in checks[key].values())
            require(shapes == [[PREDICT_BATCH, 20, 20, 64]] * 4 + [[PREDICT_BATCH, 40, 40, 32]] * 2,
                    f"save {key} bottleneck inputs {shapes}")
            require(valid.shape == (PREDICT_BATCH, 1024), f"save {key} NMS candidates {tuple(valid.shape)}")
            # predict ms per image in turns: save=True (the default, saved in `workers` = 8 threads), save=True
            # saved serially (workers=0, as JAX's loop), save=False; a YOLO per setting keeps its predictor (and
            # its bf16 copy), each warmed by one call
            settings = {"save_true": {}, "save_true_serial": {"workers": 0}, "save_false": {"save": False}}
            timed = {k: YOLO(CKPT) for k in settings}
            t = {k: [] for k in settings}
            for rep in range(SAVE_REPS + 1):
                for k, kw in settings.items():
                    t0 = time.perf_counter()
                    timed[k].predict(arrays, batch=PREDICT_BATCH, half=half, project=tmp, name=f"t{key}",
                                     exist_ok=True, **kw)
                    if rep:
                        t[k].append((time.perf_counter() - t0) * 1e3 / PREDICT_BATCH)
            times[key] = {k: {"median": float(np.median(v)), "all": v} for k, v in t.items()}

        # 3. the JPEG fixture directory at its defaults (batch 8)
        val_dir = JPEG_FIXTURES / "spectrogram" / "images" / "val"
        n_dir = len(list(val_dir.glob("*.jpg")))
        results, launches["jpeg_directory"] = run_counted(
            lambda: yolo.predict(str(val_dir), batch=IMAGES_BATCH, project=tmp, name="jpeg_directory"),
            {k: v * -(-n_dir // IMAGES_BATCH) for k, v in f32.items()}, "predict of the JPEG directory")
        saved_bytes["jpeg_directory"] = check_saved(results, Path(tmp) / "jpeg_directory")

        # 4. the command line in a process of its own: detect predict at its defaults writes the image
        source = JPEG_FIXTURES / "641x359.jpg"
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, "-m", "spectrogram_yolov11_torch", "detect", "predict", f"model={CKPT}",
                            f"source={source}", f"project={tmp}", "name=cli"], cwd=ROOT, capture_output=True,
                           text=True, timeout=300)
        cli = {"rc": r.returncode, "seconds": time.perf_counter() - t0,
               "stdout": (r.stdout.strip().splitlines() or [""])[-1]}
        require(r.returncode == 0, f"detect predict exited {r.returncode}: {r.stderr[-2000:]}")
        written = Path(tmp) / "cli" / "641x359.jpg"
        require(written.exists() and imread(written).shape == (359, 641, 3), f"detect predict wrote no {written}")
        cli["bytes"] = written.stat().st_size

        # 5. YOLO(url).predict over the BYTES JPEG wire: the server on the card, the frames JPEG at quality 90
        srv = serve_module.InferenceServer({"spec": CKPT}, port=0).start()
        sent = []
        real = serve_module.encode_images

        def recording(a, **k):
            sent.append((a.copy(), k, real(a, **k)))
            return sent[-1][2]

        saved_env = os.environ.get("SYT_WIRE_ENCODE")
        os.environ["SYT_WIRE_ENCODE"] = "jpg"
        serve_module.encode_images = recording
        try:
            wire_arrays = arrays[:8]
            remote = YOLO(srv.url)
            results, launches["wire_jpeg"] = run_counted(
                lambda: remote.predict(wire_arrays, batch=8, project=tmp, name="wire"),
                {"fused_bottleneck": 6, "fused_bottleneck_bf16": 0, "greedy_keep": 1}, "YOLO(url) predict, JPEG wire")
        finally:
            serve_module.encode_images = real
            if saved_env is None:
                os.environ.pop("SYT_WIRE_ENCODE")
            else:
                os.environ["SYT_WIRE_ENCODE"] = saved_env
        try:
            frames, kw, blobs = sent[-1]
            require(kw == {"fmt": ".jpg", "quality": 90} and len(blobs) == 8
                    and all(b[:3] == b"\xff\xd8\xff" for b in blobs), f"the wire sent {kw}, {len(blobs)} blobs")
            decoded = np.stack([imdecode(b) for b in blobs])
            served = serve_module.RemoteModel(srv.url)(blobs)[0]
            local = AutoBackend(CKPT).forward(decoded).cpu().numpy()
            wire_err = _within_serve_tol(_forward_err(served, local), "JPEG wire against the local forward")
        finally:
            srv.shutdown()
        require(len(results) == 8 and all(np.isfinite(r.boxes.data).all() for r in results), "wire results malformed")
        saved_bytes["wire_jpeg"] = check_saved(results, Path(tmp) / "wire")
        wire = {"frames": list(frames.shape), "bytes_per_frame": float(np.mean([len(b) for b in blobs])),
                "raw_bytes_per_frame": int(np.prod(frames.shape[1:])), "err": wire_err}

    # 6. plot and encode ms per 640 x 360 frame on the host, serially and in 8 threads
    frame = np.ascontiguousarray(arrays[0] if arrays[0].shape[-1] == 3 else np.repeat(arrays[0], 3, -1))
    res = yolo.predict(frame, save=False)[0]
    plots = [res.plot() for _ in range(8)]
    reps = 20
    t0 = time.perf_counter()
    for _ in range(reps):
        res.plot()
    plot_ms = (time.perf_counter() - t0) * 1e3 / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        encode_jpeg(plots[0])
    encode_ms = (time.perf_counter() - t0) * 1e3 / reps
    with ThreadPoolExecutor(8) as ex:
        list(ex.map(encode_jpeg, plots))
        t0 = time.perf_counter()
        for _ in range(reps // 4):
            list(ex.map(encode_jpeg, plots))
        encode_8t_ms = (time.perf_counter() - t0) * 1e3 / (reps // 4 * len(plots))
    emit("save", encoder=encoder, launches=launches, saved_bytes=saved_bytes, kernel_checks=checks,
         greedy_keep_k1024={k: {n: v for n, v in d.items() if n in ("shape", "ms", "plain_ms", "bound_ms", "mismatches",
                                                                        "scan_steps_mean")} for k, d in nms.items()},
         predict_ms_per_image_batch32=times, cli=cli, wire_jpeg=wire,
         host_640x360={"frame": list(frame.shape), "detections": len(res), "plot_ms": plot_ms,
                       "encode_ms_serial": encode_ms, "encode_ms_per_frame_8_threads": encode_8t_ms,
                       "jpeg_bytes": len(encode_jpeg(plots[0])), "host_cpus": os.cpu_count()},
         phase_s=time.perf_counter() - t_phase,
         method="predict at its defaults counted from 0 around each call; each saved file held to imencode of "
                "the returned plot; the kernels on the inputs the array predicts handed them (global module "
                "hooks); times on the host clock, the three settings in turns on a YOLO each, after a warm call, "
                "SAVE_REPS calls each")
    return launches, checks, nms


def phase_artifacts():
    """Val and training artifacts on the card, on the trained model at 640 px:
    YOLO(ckpt).val at its defaults (plots=True) with save_json=True on the
    32-image synth split in f32 and bf16, counted, the kernels at its inputs,
    the six charts and the two JSON files, the confusion matrix, row counts
    and COCO stats against the CPU's val; YOLO(ckpt).embed on the 8 JPEG
    fixture frames, counted per image, against the CPU's; YOLO(ckpt).profile
    at 640 against the CPU's params and beside the forward's time;
    YOLO(ckpt).train at its defaults (1 epoch, B = 16) writing
    train_batch0..2.jpg equal to the JPEG of the mosaic of each batch it drew
    and results.png; profile=True writing a trace with the card's kernels;
    batch=-1 (AutoBatch) on the card. Readings: val seconds at the defaults
    against plots=False, save_json=False in turns; ms per chart; COCOeval ms
    at 32 images; train_batch plot ms; embed ms per image; AutoBatch seconds,
    its batch and probes."""
    import tempfile

    import numpy as np
    import torch

    import spectrogram_yolov11_torch.utils.plotting as plotting
    from spectrogram_yolov11_torch import YOLO
    from spectrogram_yolov11_torch.data.dataset import check_det_dataset, find_dataset_yaml
    from spectrogram_yolov11_torch.data.imageio import imencode, imread
    from spectrogram_yolov11_torch.engine.trainer import DetectionTrainer
    from spectrogram_yolov11_torch.ops.cocoeval import COCOeval
    from spectrogram_yolov11_torch.utils import yaml_load

    t_phase = time.perf_counter()
    f32 = {"fused_bottleneck": 6, "fused_bottleneck_bf16": 0, "greedy_keep": 1}
    bf16 = {"fused_bottleneck": 0, "fused_bottleneck_bf16": 6, "greedy_keep": 1}
    charts = {"PR_curve.png": (900, 1050, 3), "F1_curve.png": (900, 1050, 3), "P_curve.png": (900, 1050, 3),
              "R_curve.png": (900, 1050, 3), "confusion_matrix_normalized.png": (1050, 1200, 3),
              "confusion_matrix.png": (1050, 1200, 3)}
    launches, checks, nms, out = {}, {}, {}, {}
    yolo = YOLO(CKPT)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        data = check_det_dataset(dict(yaml_load(find_dataset_yaml("spectrogram_synth.yaml")), path=tmp))
        out["generate_s"] = time.perf_counter() - t0

        # 1. val at its defaults with save_json=True, f32 and bf16, counted, the kernels at its inputs
        vals = {}
        for key, half, expect, dtype in (("val_f32", False, f32, torch.float32),
                                         ("val_bf16", True, bf16, torch.bfloat16)):
            cap, stop = capture_val_inputs(dtype)
            try:
                res, launches[key] = run_counted(
                    lambda h=half: yolo.val(data=data, batch=VAL_BATCH, half=h, save_json=True, project=tmp),
                    expect, f"val {key} at its defaults")
            finally:
                stop()
            v = yolo.validator
            checks[key], nms[key] = kernels_at(cap, 2, yolo.model.stride, f"artifacts {key}", VAL_BATCH, TRAIN_IMGSZ)
            files = {p.name: p for p in v.save_dir.iterdir()}
            require(set(files) == {*charts, "predictions.json", "annotations.json"},
                    f"val {key} wrote {sorted(files)}")
            for name, shape in charts.items():
                require(imread(files[name]).shape == shape, f"{name} of {key} is {imread(files[name]).shape}")
            rows = {n: len(json.loads(files[n].read_text())) for n in ("predictions.json", "annotations.json")}
            vals[key] = {"results": res, "matrix": v.confusion_matrix.matrix.copy(), "rows": rows, "validator": v}
        cpu_yolo = YOLO(CKPT, device="cpu")
        cpu = cpu_yolo.val(data=data, batch=VAL_BATCH, save_json=True, project=tmp)
        cpu_v = cpu_yolo.validator
        card = vals["val_f32"]
        require(np.array_equal(card["matrix"], cpu_v.confusion_matrix.matrix),
                f"confusion matrix: card {card['matrix'].tolist()}, CPU {cpu_v.confusion_matrix.matrix.tolist()}")
        cpu_rows = {"predictions.json": len(cpu_v.jdict), "annotations.json": len(cpu_v.gt_jdict)}
        require(card["rows"] == cpu_rows, f"JSON rows: card {card['rows']}, CPU {cpu_rows}")
        coco = {k: v for k, v in card["results"].items() if k.startswith("metrics/coco_")}
        require(len(coco) == 12, f"the val's COCO keys: {sorted(coco)}")
        coco_diff = {k: abs(v - cpu[k]) for k, v in card["results"].items()}
        require(max(coco_diff.values()) <= VAL_TOL, f"val f32 against the CPU: {coco_diff}")
        out["val"] = {k: {"results": d["results"], "json_rows": d["rows"], "confusion_matrix": d["matrix"].tolist()}
                      for k, d in vals.items()}
        out["val"]["cpu_max_diff"] = max(coco_diff.values())

        # readings: val seconds at the defaults against plots=False, save_json=False, in turns; charts and COCOeval
        t = {"defaults_save_json": [], "plots_false": []}
        for rep in range(3):
            for k, kw in (("defaults_save_json", {"save_json": True}), ("plots_false", {"plots": False})):
                t0 = time.perf_counter()
                yolo.val(data=data, batch=VAL_BATCH, project=tmp, **kw)
                t[k].append(time.perf_counter() - t0)
        out["val_seconds"] = {k: {"median": float(np.median(v)), "all": v} for k, v in t.items()}
        v = card["validator"]
        curves, names = v.metrics.curves_results, v.names
        x = np.linspace(0, 1, curves["p_curve"].shape[1])
        chart_ms = {}
        for name, fn in (("PR_curve", lambda d: plotting.plot_pr_curve(curves["p_curve"], curves["r_curve"],
                                                                         curves["ap"], names, d)),
                         ("F1_curve", lambda d: plotting.plot_mc_curve(x, curves["f1_curve"], names, d, "F1")),
                         ("confusion_matrix_normalized",
                          lambda d: plotting.plot_confusion_matrix(card["matrix"], names, d, True))):
            t0 = time.perf_counter()
            for _ in range(5):
                fn(Path(tmp) / "charts")
            chart_ms[name] = (time.perf_counter() - t0) * 1e3 / 5
        t0 = time.perf_counter()
        stats = COCOeval(v.gt_jdict, v.jdict).evaluate().stats
        out["charts_ms"], out["cocoeval_ms_32_images"] = chart_ms, (time.perf_counter() - t0) * 1e3
        out["detections"] = len(v.jdict)
        out["coco_stats"] = stats

        # 2. embed on the 8 JPEG fixture frames, counted per image, against the CPU's
        val_dir = JPEG_FIXTURES / "spectrogram" / "images" / "val"
        n_jpeg = len(list(val_dir.glob("*.jpg")))
        yolo.embed(str(val_dir))  # warm
        t0 = time.perf_counter()
        vecs, launches["embed"] = run_counted(lambda: yolo.embed(str(val_dir)),
                                              {"fused_bottleneck": 6 * n_jpeg, "fused_bottleneck_bf16": 0,
                                               "greedy_keep": 0}, "embed of the JPEG fixtures")
        embed_ms = (time.perf_counter() - t0) * 1e3 / n_jpeg
        cpu_vecs = YOLO(CKPT, device="cpu").embed(str(val_dir))
        embed_err = max(float(np.abs(a - b).max()) for a, b in zip(vecs, cpu_vecs))
        require(len(vecs) == n_jpeg and all(a.shape == b.shape and a.dtype == np.float32 for a, b in zip(vecs, cpu_vecs))
                and embed_err <= EMBED_TOL, f"embed on the card against the CPU: {embed_err}")
        out["embed"] = {"images": n_jpeg, "dim": int(vecs[0].shape[0]), "max_abs_err_vs_cpu": embed_err,
                        "tolerance": EMBED_TOL, "ms_per_image": embed_ms}

        # 3. profile at 640: params equal to the CPU's, ms per layer, their sum beside the forward's time
        rows, launches["profile"] = run_counted(lambda: yolo.profile(imgsz=TRAIN_IMGSZ),
                                                {"fused_bottleneck": 5 * 6, "fused_bottleneck_bf16": 0,
                                                 "greedy_keep": 0}, "profile at 640")
        cpu_rows = YOLO(CKPT, device="cpu").profile(imgsz=TRAIN_IMGSZ, timed=False)
        require([(r["i"], r["type"], r["params"]) for r in rows] == [(r["i"], r["type"], r["params"]) for r in cpu_rows],
                "profile rows on the card differ from the CPU's")
        net = yolo._network()
        xin = torch.zeros(1, 3, TRAIN_IMGSZ, TRAIN_IMGSZ, device="cuda").contiguous(memory_format=torch.channels_last)
        with torch.inference_mode():
            fwd_ms = cuda_ms(lambda: net(xin), iters=20)
        out["profile"] = {"layers": len(rows), "params": sum(r["params"] for r in rows),
                          "gflops": sum(r["gflops"] for r in rows), "sum_layer_ms": sum(r["ms"] for r in rows),
                          "forward_ms_b1": fwd_ms, "rows": [{k: r[k] for k in ("i", "type", "ms")} for r in rows]}

        # 4. training at its defaults: train_batch0..2.jpg equal to the JPEG of each mosaic, results.png
        drawn, inner = [], plotting.plot_images

        def record(batch, names, path, **kw):
            t0 = time.perf_counter()
            p = inner(batch, names, path, **kw)
            dt = time.perf_counter() - t0
            drawn.append((imencode(".jpg", plotting.images_mosaic(batch)), Path(p), dt))
            return p

        plotting.plot_images = record
        try:
            t0 = time.perf_counter()
            tr = YOLO(CKPT)
            _, launches["train"] = run_counted(
                lambda: tr.train(data=data, epochs=1, batch=TRAIN_BATCH, imgsz=TRAIN_IMGSZ, project=tmp, name="train"),
                {"fused_bottleneck": 0, "fused_bottleneck_bf16": 12, "greedy_keep": 2}, "train at its defaults")
            train_s = time.perf_counter() - t0
        finally:
            plotting.plot_images = inner
        run = Path(tmp) / "train"
        require([p for _, p, _ in drawn] == [run / f"train_batch{i}.jpg" for i in range(3)],
                f"train drew {[str(p) for _, p, _ in drawn]}")
        for ref, p, _ in drawn:
            require(p.read_bytes() == ref and imread(p).shape == (1920, 1920, 3), f"{p.name} is not its mosaic's JPEG")
        require(imread(run / "results.png").shape == (720, 2400, 3), "results.png missing or of another size")
        out["train"] = {"seconds": train_s, "plot_ms": [dt * 1e3 for _, _, dt in drawn],
                        "bytes": [len(ref) for ref, _, _ in drawn]}

        # 5. profile=True: a trace with the card's kernels
        t0 = time.perf_counter()
        tp = YOLO(CKPT)
        tp.train(data=data, epochs=1, batch=TRAIN_BATCH, imgsz=TRAIN_IMGSZ, fraction=0.25, plots=False, profile=True,
                 project=tmp, name="profiled")
        profiled_s = time.perf_counter() - t0
        trace_path = tp.trainer.trace_path
        events = json.loads(trace_path.read_text())["traceEvents"]
        kernels = [e for e in events if e.get("cat") == "kernel"]
        require(trace_path.parent == Path(tmp) / "profiled" / "profile" and len(kernels) > 1000,
                f"trace {trace_path} holds {len(kernels)} kernel events")
        out["profile_trace"] = {"seconds": profiled_s, "bytes": trace_path.stat().st_size, "events": len(events),
                                "kernel_events": len(kernels)}

        # 6. batch=-1: AutoBatch on the card
        # the trainer YOLO.train builds, kept here: at batch 256 the split's 128 train images make no batch
        ta = DetectionTrainer(YOLO(CKPT).model, {"data": data, "epochs": 1, "batch": -1, "imgsz": TRAIN_IMGSZ,
                                                 "plots": False, "project": tmp, "name": "autobatch"})
        try:
            ta.train()
        except ValueError as e:
            require(ta.batch_size == 256 and "too small for batch=256" in str(e), f"train(batch=-1): {e}")
        ab = ta.autobatch
        total = torch.cuda.get_device_properties(0).total_memory
        b, probes = ab["batch"], ab["probes"]
        nxt = probes.get(2 * b, "not probed")
        require(probes[b] is not None and probes[b] <= 0.6 * total
                and (b == 256 or nxt is None or (nxt != "not probed" and nxt > 0.6 * total)),
                f"AutoBatch chose {b} from {probes} of {total} bytes")
        out["autobatch"] = {"batch": b, "seconds": ab["seconds"], "probes_gib": {k: (v / 2**30 if v else v)
                                                                                for k, v in probes.items()},
                            "limit_gib": 0.6 * total / 2**30, "total_gib": total / 2**30}
    emit("artifacts", launches=launches,
         kernel_checks={k: {n: {m: d[m] for m in d if m != "ok"} for n, d in c.items()} for k, c in checks.items()},
         greedy_keep_k2048={k: {n: v for n, v in d.items() if n in ("shape", "ms", "plain_ms", "bound_ms", "mismatches",
                                                                        "scan_steps_mean")} for k, d in nms.items()},
         **out, phase_s=time.perf_counter() - t_phase,
         method="val, embed, profile and train counted from 0 around each call; the kernels on the val's inputs "
                "(global module hooks); the card's f32 val, embed and profile against the CPU's; the train_batch "
                "files held to imencode of images_mosaic of the batches plot_images was handed; times on the host "
                "clock (val in turns, 3 each), the forward by CUDA events")
    return launches, checks, nms


def fork_sweep_modules() -> dict:
    """The registry's modules that none of FORK_CONFIGS holds at top level (and
    the building blocks only reached inside others), each built alone at a
    P3-sized map of a scale-n model: name -> (constructor, number of inputs)."""
    from spectrogram_yolov11_torch.nn import modules as M

    c = FORK_SWEEP_C
    return {
        "ChannelAttention": (lambda: M.ChannelAttention(c), 1), "SpatialAttention": (lambda: M.SpatialAttention(7), 1),
        "C2f": (lambda: M.C2f(c, c, 1), 1), "C3": (lambda: M.C3(c, c, 1), 1), "C3GC": (lambda: M.C3GC(c, c, 1), 1),
        "SELayer": (lambda: M.SELayer(c), 1), "SaELayer": (lambda: M.SaELayer(c), 1), "GCT": (lambda: M.GCT(c), 1),
        "WeightedSpatialAttention": (lambda: M.WeightedSpatialAttention(7), 1),
        "SobelSpatialAttention": (lambda: M.SobelSpatialAttention(7), 1),
        "MSCSpatialAttention": (lambda: M.MSCSpatialAttention(c), 1), "ECAAttention": (lambda: M.ECAAttention(c), 1),
        "CoordAtt": (lambda: M.CoordAtt(c, c), 1), "MaxHCoordAtt": (lambda: M.MaxHCoordAtt(c, c), 1),
        "FilterMaxConv": (lambda: M.FilterMaxConv(c, c), 1), "LDConv": (lambda: M.LDConv(c, c // 2, 5), 1),
        "Cross_AKConv": (lambda: M.Cross_AKConv(c, c), 1), "BottleNect": (lambda: M.BottleNect(c), 1),
        "Mix_SPPF": (lambda: M.Mix_SPPF(c, c), 1), "PartialConvMax": (lambda: M.PartialConvMax(c, c), 1),
        "SelectChannel": (lambda: M.SelectChannel(c), 2), "BiFPN_WConcat": (lambda: M.BiFPN_WConcat((c, c)), 2),
        **{f"Fusion_{m}": ((lambda m=m: M.Fusion((c, c), m, c)), 2)
           for m in ("weight", "adaptive", "concat", "bifpn", "SChannel", "SChannel_new")},
        "GlobalContext": (lambda: M.GlobalContext(c), 1), "Faster_Block": (lambda: M.Faster_Block(c, c), 1),
        "DenseCross": (lambda: M.DenseCross(c, c, e=1.0), 1), "DualChannelHConv": (lambda: M.DualChannelHConv(c, c), 1),
        "MSBottleneck": (lambda: M.MSBottleneck(c, c), 1),
    }


def fork_bf16_tol(d_cpu: float, max_ref: float) -> float:
    """The card's bf16 forward against the CPU's bf16: twice the CPU's own
    bf16-to-f32 distance plus two bf16 steps of the largest output (max|ref|
    * 2^-7): cuDNN and cuFFT sum in other orders than the CPU's libraries,
    which flips the bf16 rounding of some intermediates by a step, and later
    bf16 ops carry the flip on (measured: BottleNect at 9.8e-4, where twice
    the distance was 9.5e-4 and its largest output under 0.125)."""
    return 2 * d_cpu + max_ref * 2.0**-7


def fork_module_sweep() -> dict:
    """Each module of fork_sweep_modules, with init_weights' draws (seeded), in
    eval mode: on the card and on the CPU from the same weights and inputs,
    f32 (in full f32, as the network's forward runs) within FORK_TOL, and its
    bf16 form (convs and dense layers cast as
    set_dtype casts them) within fork_bf16_tol of the CPU's bf16;
    ECAAttention refuses bf16 on the card as on the CPU."""
    import copy

    import torch

    from spectrogram_yolov11_torch.nn.modules import Bottleneck
    from spectrogram_yolov11_torch.nn.tasks import init_weights
    from spectrogram_yolov11_torch.utils import full_f32

    def to_bf16(mod):
        for m in mod.modules():
            if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear)):
                m.to(torch.bfloat16)
            if isinstance(m, Bottleneck) and m.fusable:
                m.fold(torch.bfloat16)
        return mod

    out = {}
    g = torch.Generator().manual_seed(0)
    for name, (make, n) in fork_sweep_modules().items():
        mod = make()
        init_weights(mod, g)
        mod.eval()
        for m in mod.modules():
            if isinstance(m, Bottleneck) and m.fusable:
                m.fold()
        xs = [torch.randn(FORK_SWEEP_B, FORK_SWEEP_C, FORK_SWEEP_HW, FORK_SWEEP_HW, generator=g) for _ in range(n)]
        arg = (lambda ts: ts if n > 1 else ts[0])
        card = copy.deepcopy(mod).cuda()
        xg = [x.cuda() for x in xs]
        with torch.inference_mode():
            with full_f32():  # the port's f32 policy, which the network's forward holds itself
                ref, got = mod(arg(xs)), card(arg(xg))
            torch.cuda.synchronize()
            err = float((got.cpu() - ref).abs().max())
            tol = FORK_TOL * (1 + float(ref.abs().max()))
            require(err <= tol, f"module {name}: the card's f32 forward lies {err} from the CPU's (tolerance {tol})")
            d = {"f32_max_abs_err": err, "f32_tolerance": tol}
            mod16, card16 = to_bf16(copy.deepcopy(mod)), to_bf16(card)
            if name == "ECAAttention":
                for m, x in ((mod16, xs[0]), (card16, xg[0])):
                    try:
                        m(x.bfloat16())
                        raise RuntimeError("ECAAttention ran at bf16")
                    except TypeError:
                        pass
                d["bf16"] = "refused (TypeError), as JAX's"
            else:
                ref16 = mod16(arg([x.bfloat16() for x in xs])).float()
                got16 = card16(arg([x.bfloat16() for x in xg])).float().cpu()
                d_cpu, err16 = float((ref16 - ref).abs().max()), float((got16 - ref16).abs().max())
                tol16 = fork_bf16_tol(d_cpu, float(ref16.abs().max()))
                require(err16 <= tol16, f"module {name}: the card's bf16 forward lies {err16} from the CPU's bf16 "
                                        f"(tolerance {tol16})")
                d.update(bf16_max_abs_err=err16, bf16_cpu_distance=d_cpu, bf16_tolerance=tol16)
        out[name] = d
    return out


def fork_bottleneck_checks(cap: dict, what: str) -> dict:
    """Each fused bottleneck input kept in `cap` (capture_val_inputs) against
    its plain version (bottleneck_check), by module."""
    import torch

    checks = {}
    with torch.inference_mode():
        for i, m in enumerate(k for k in cap if k != "feats"):
            d = bottleneck_check(f"{what} {i}", layer_case(m, cap[m]))
            checks[f"bottleneck{i}"] = {k: v for k, v in d.items() if "args" not in k}
    return checks


def fork_nms_at(cap: dict, nc: int, stride) -> dict:
    """The keep kernel against its plain version on the val's multi-label
    candidates of the head outputs `cap` kept."""
    import torch

    from spectrogram_yolov11_torch.engine.validator import VAL_PRE_NMS_TOPK
    from spectrogram_yolov11_torch.ops.decode import decode_detections
    from spectrogram_yolov11_torch.ops.nms import nms_candidates

    with torch.inference_mode():
        preds = decode_detections(cap["feats"], nc, stride)
        _, _, _, valid, offset_boxes = nms_candidates(preds, 0.001, nc, multi_label=True, pre_nms_topk=VAL_PRE_NMS_TOPK)
        return nms_check(offset_boxes, valid)


def scaled_bn(model, seed: int) -> None:
    """Seeded BN statistics (means N(0, 0.05), variances U(0.15, 0.25)) in
    place of init's 0 and 1, then eval mode (which folds the fused
    bottlenecks from them): a network from init(seed) keeps activations of
    0.05-0.9 standard deviation through its depth (about 0.02 with
    variance 1), and no BN divides by a small variance, which would grow the
    rounding of the sums before it."""
    import torch

    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.copy_(torch.randn(m.running_mean.shape, generator=g) * 0.05)
                m.running_var.copy_(torch.empty(m.running_var.shape).uniform_(0.15, 0.25, generator=g))
    model.eval()


def fork_config(name: str, scale: str) -> dict:
    """One fork config at 640 px: built from its YAML with init(0) on the host;
    the card's f32 forward and its bf16 copy's at B = 1, counted from 0 (one
    launch per fused bottleneck, in the form of the dtype; none for a gated
    one), against the CPU's forward (f32 within FORK_TOL, bf16 within
    fork_bf16_tol), with the BN statistics of scaled_bn; each fused
    bottleneck against its
    plain version at the inputs the card's forwards gave it; ms per forward
    at B = 32 in f32 and bf16 by CUDA events."""
    import copy

    import numpy as np
    import torch

    from spectrogram_yolov11_torch.nn.tasks import build_model, yaml_model_load

    d = yaml_model_load(name)
    d["scale"] = scale
    t0 = time.perf_counter()
    model = build_model(d).init(0)
    build_s = time.perf_counter() - t0
    b = model.bottlenecks()
    nf = len(b["fused"])
    x = torch.from_numpy(np.random.default_rng(len(name)).uniform(0, 1, (1, 3, 640, 640)).astype(np.float32))
    scaled_bn(model, 1)
    with torch.inference_mode():
        ref = [t for p in model(x) for t in p]
        ref16 = [t.float() for p in model.set_dtype(torch.bfloat16)(x) for t in p]
    card = copy.deepcopy(model).to("cuda", memory_format=torch.channels_last)
    card16 = card.set_dtype(torch.bfloat16)
    xg = x.cuda().contiguous(memory_format=torch.channels_last)
    out = {"scale": scale, "params": sum(p.numel() for p in model.parameters()), "levels": len(model.stride),
           "fused": [list(t) for t in b["fused"]], "gated": [list(t) for t in b["gated"]], "build_s": build_s}
    checks = {}
    for dtype, net, want, expect in (
            (torch.float32, card, ref, {"fused_bottleneck": nf, "fused_bottleneck_bf16": 0, "greedy_keep": 0}),
            (torch.bfloat16, card16, ref16, {"fused_bottleneck": 0, "fused_bottleneck_bf16": nf, "greedy_keep": 0})):
        tag = "f32" if dtype == torch.float32 else "bf16"
        cap, stop = capture_val_inputs(dtype)
        try:
            with torch.inference_mode():
                got, launches = run_counted(lambda: net(xg), expect, f"{name} {tag} forward")
        finally:
            stop()
        got = [t.float().cpu() for p in got for t in p]
        err = max(float((g - r).abs().max()) for g, r in zip(got, want))
        if dtype == torch.float32:
            tol = FORK_TOL * (1 + max(float(r.abs().max()) for r in want))
        else:
            tol = fork_bf16_tol(max(float((r16 - r).abs().max()) for r16, r in zip(ref16, ref)),
                                max(float(r.abs().max()) for r in ref16))
        require(err <= tol, f"{name} {tag}: the card's forward lies {err} from the CPU's (tolerance {tol})")
        require(len(cap) - ("feats" in cap) == nf, f"{name} {tag}: {len(cap)} bottleneck inputs kept, {nf} fused")
        checks[tag] = fork_bottleneck_checks(cap, f"{name} {tag}")
        xb = torch.rand(FORK_TIMED_BATCH, 3, 640, 640, device="cuda").contiguous(memory_format=torch.channels_last)
        with torch.inference_mode():
            ms = cuda_ms(lambda: net(xb), iters=5, warmup=2)
        out[tag] = {"launches": launches, "max_abs_err": err, "tolerance": tol, f"ms_b{FORK_TIMED_BATCH}": ms}
    del card, card16
    torch.cuda.empty_cache()
    return out, checks


def phase_fork():
    """The fork's model zoo on the card. FORK_CONFIGS, each at 640 px (scale n,
    the SMSC family at l) through fork_config; the rest of the registry
    through fork_module_sweep; then the user path on the 128 + 32 synth split:
    YOLO(FORK_USER).train(epochs=FORK_EPOCHS, batch=TRAIN_BATCH,
    imgsz=TRAIN_IMGSZ) at its defaults (amp), counted from 0 around the call
    and per epoch (its EMA vals run the bf16 copy: one bf16 launch per fused
    bottleneck and one NMS per val batch, none for the gated ones, none in the
    steps), the kernels at the first EMA val's inputs; YOLO(last.ckpt).val in
    f32 at batch 32 and .predict(32 arrays, batch=32, save=False), each
    counted, the kernels at the val's inputs. Readings: ms per forward at B =
    32 in f32 and bf16 per config, ms per train step with the loader's wait,
    val seconds."""
    import csv
    import tempfile

    import numpy as np
    import torch

    from spectrogram_yolov11_torch import YOLO
    from spectrogram_yolov11_torch.data.dataset import check_det_dataset, find_dataset_yaml
    from spectrogram_yolov11_torch.utils import yaml_load

    t_phase = time.perf_counter()
    configs, checks = {}, {}
    for name, scale in FORK_CONFIGS:
        configs[name], checks[name] = fork_config(name, scale)
    emit("fork_configs", configs=configs)
    sweep = fork_module_sweep()
    launches = {"configs": {n: {t: c[t]["launches"] for t in ("f32", "bf16")} for n, c in configs.items()}}
    bf16 = torch.bfloat16
    counters = launch_counters()
    counts = lambda: {k: c.launches for k, c in counters.items()}  # noqa: E731
    with tempfile.TemporaryDirectory() as tmp:
        data = check_det_dataset(dict(yaml_load(find_dataset_yaml("spectrogram_synth.yaml")), path=tmp))
        n_val = len(list(Path(data["val"]).iterdir()))
        yolo = YOLO(FORK_USER)
        nf = len(yolo.model.bottlenecks()["fused"])
        require(nf and yolo.model.bottlenecks()["gated"], f"{FORK_USER} holds no gated bottleneck")
        per_val = {"fused_bottleneck": 0, "fused_bottleneck_bf16": nf * (n_val // TRAIN_BATCH),
                   "greedy_keep": n_val // TRAIN_BATCH}
        rec = {"counts": []}
        cap, stop = capture_val_inputs(bf16)
        yolo.add_callback("on_train_epoch_start", lambda t: rec["counts"].append({"epoch": t.epoch, "start": counts()}))
        yolo.add_callback("on_train_batch_end", lambda t: rec["counts"][-1].update(steps=counts()))

        def on_fit_epoch_end(t):
            rec["counts"][-1]["val"] = counts()
            stop()  # the first EMA val's inputs only

        yolo.add_callback("on_fit_epoch_end", on_fit_epoch_end)
        t0 = time.perf_counter()
        try:
            metrics, launches["train"] = run_counted(
                lambda: yolo.train(plots=False, data=data, project=tmp, name="fork", epochs=FORK_EPOCHS,
                                   batch=TRAIN_BATCH, imgsz=TRAIN_IMGSZ, workers=8, exist_ok=True),
                {k: FORK_EPOCHS * v for k, v in per_val.items()}, f"YOLO('{FORK_USER}').train")
        finally:
            stop()
        train_s = time.perf_counter() - t0
        tr = yolo.trainer
        require(tr.args.amp is True and tr.validator.model.dtype == bf16 and tr.rebuilt["nc"] == (80, 2),
                f"YOLO('{FORK_USER}').train did not train the rebuilt model at amp=True: {tr.rebuilt}")
        by_epoch = []
        for c in rec["counts"]:
            steps_c = {k: c["steps"][k] - c["start"][k] for k in c["start"]}
            val_c = {k: c["val"][k] - c["steps"][k] for k in c["start"]}
            require(not any(steps_c.values()) and val_c == per_val, f"epoch {c['epoch']}: steps {steps_c}, val {val_c}")
            by_epoch.append({"epoch": c["epoch"], "steps": steps_c, "val": val_c})
        rows = list(csv.DictReader(open(tr.csv)))
        losses = [[float(r[k]) for k in ("train/box_loss", "train/cls_loss", "train/dfl_loss")] for r in rows]
        require(len(rows) == FORK_EPOCHS and np.isfinite(losses).all(), f"results.csv {rows}")
        require(all(0.0 <= v <= 1.0 for v in metrics.values()), f"the EMA val {metrics}")
        checks["train_ema_val"] = fork_bottleneck_checks(cap, "fork EMA val")
        nms = {"train_ema_val": fork_nms_at(cap, 2, yolo.model.stride)}
        log = tr.epoch_log

        # the checkpoint: val in f32, and predict, each counted
        last = YOLO(tr.last)
        cap, stop = capture_val_inputs(torch.float32)
        try:
            val, launches["val"] = run_counted(
                lambda: last.val(plots=False, data=data, batch=VAL_BATCH),
                {"fused_bottleneck": nf * (n_val // VAL_BATCH), "fused_bottleneck_bf16": 0,
                 "greedy_keep": n_val // VAL_BATCH}, "YOLO(last.ckpt).val")
        finally:
            stop()
        require(all(0.0 <= v <= 1.0 for v in val.values()), f"YOLO(last.ckpt).val {val}")
        checks["val"] = fork_bottleneck_checks(cap, "fork val")
        nms["val"] = fork_nms_at(cap, 2, last.model.stride)
        arrays = _mixed_arrays(PREDICT_BATCH, seed=100)
        res, launches["predict"] = run_counted(
            lambda: last.predict(arrays, batch=PREDICT_BATCH, save=False),
            {"fused_bottleneck": nf, "fused_bottleneck_bf16": 0, "greedy_keep": 1}, "YOLO(last.ckpt).predict")
        require(len(res) == PREDICT_BATCH and all(r.boxes.data.shape[1] == 6 for r in res), "predict's results")
        info = last.info()
        require(f"{nf} fused bottlenecks" in info and "gated (layer, C)" in info, f"info() {info}")
    emit("fork", configs=configs, module_sweep=sweep, launches=launches,
         kernel_checks={k: {t: {n: {m: v for m, v in d.items() if m != "ok"} for n, d in c.items()}
                            for t, c in v.items()} if k in configs else
                        {n: {m: v for m, v in d.items() if m != "ok"} for n, d in v.items()}
                        for k, v in checks.items()},
         greedy_keep_k2048={k: {n: v for n, v in d.items() if n in ("shape", "ms", "plain_ms", "bound_ms",
                                                                    "mismatches", "scan_steps_mean")}
                            for k, d in nms.items()},
         user={"model": FORK_USER, "rebuilt": tr.rebuilt, "launches_by_epoch": by_epoch, "loss_items_by_epoch": losses,
               "final_ema_bf16": metrics, "val_f32": val, "train_call_s": train_s, "info": info,
               "ms_per_step_with_wait": [(e["seconds"] - e["val_s"]) / e["steps"] * 1e3 for e in log],
               "loader_wait_ms_per_step": [e["loader_wait_s"] / e["steps"] * 1e3 for e in log],
               "val_s": [e["val_s"] for e in log]},
         phase_s=time.perf_counter() - t_phase,
         method="each config built from its YAML with init(0); its card forwards counted from 0 around each call "
                "against the CPU's; the kernels on the inputs each call handed them (global module hooks); "
                "forward times at B=32 by CUDA events; the user path counted from 0 around each call and per "
                "epoch by callbacks")
    return launches, checks, nms


def host_op_outputs() -> tuple:
    """The port's output for every case of HOST_DIGESTS, by name, and ms per
    call of the 640 px sample's ops (the mosaic canvas's warps, HSV jitter)."""
    import numpy as np

    from spectrogram_yolov11_torch.data import warp
    from spectrogram_yolov11_torch.utils.plotting import ellipse_filled, fill_poly

    spec, out, ms = json.loads(HOST_DIGESTS.read_text())["cases"], {}, {}
    for c in spec["warp"]:
        img = np.random.default_rng(c["seed"]).integers(0, 256, c["shape"], dtype=np.uint8)
        fn = warp.warp_affine_u8 if c["kind"] == "affine" else warp.warp_perspective_u8
        out[c["name"]] = fn(img, np.asarray(c["M"], np.float64), c["dsize"])
        if c["name"].endswith("mosaic640"):
            t0 = time.perf_counter()
            for _ in range(5):
                fn(img, np.asarray(c["M"], np.float64), c["dsize"])
            ms[f"warp_{c['kind']}_1280_to_640"] = (time.perf_counter() - t0) / 5 * 1e3
    v = np.arange(1 << 24, dtype=np.uint32)
    out["bgr_to_hsv_all"] = warp.bgr_to_hsv_u8(
        np.stack([(v >> 16) & 255, (v >> 8) & 255, v & 255], -1).astype(np.uint8).reshape(4096, 4096, 3))
    h, sat, val = np.meshgrid(np.arange(180), np.arange(256), np.arange(256), indexing="ij")
    triples = np.stack([h, sat, val], -1).astype(np.uint8)
    for width in (256, 1):
        out[f"hsv_to_bgr_all_w{width}"] = warp.hsv_to_bgr_u8(triples.reshape(-1, width, 3))
    for c in spec["augment_hsv"]:
        img = np.random.default_rng(c["seed"]).integers(0, 256, c["shape"], dtype=np.uint8)
        luts = np.asarray(c["luts"], np.uint8)
        warp.augment_hsv_u8(img, luts)
        out[c["name"]] = img.copy()  # the timing below goes on in place
        if c["shape"][0] == 640:
            t0 = time.perf_counter()
            for _ in range(5):
                warp.augment_hsv_u8(img, luts)
            ms["augment_hsv_640"] = (time.perf_counter() - t0) / 5 * 1e3
    for c in spec["draw"]:
        img = np.random.default_rng(c["seed"]).integers(0, 256, (c["size"], c["size"], 3), dtype=np.uint8)
        if c["kind"] == "ellipse":
            out[c["name"]] = ellipse_filled(img, c["center"], c["axes"], c["color"])
        else:
            out[c["name"]] = fill_poly(img, np.asarray(c["pts"], np.int32), c["color"])
    return out, ms


def host_sample_split(data: dict) -> dict:
    """ms per host-mode sample at TRAIN_IMGSZ with HOST_AUG's hyps, mosaic on,
    split by stage: read (the four images read and resized), composite (the
    canvas), warp, HSV and mixup (the blend; its partner's read, canvas and
    warp fall in those stages), each stage's function wrapped with a timer."""
    import numpy as np

    import spectrogram_yolov11_torch.data.augment as aug
    from spectrogram_yolov11_torch.cfg import DEFAULT_CFG_DICT, get_cfg
    from spectrogram_yolov11_torch.data.dataset import YOLODataset

    ds = YOLODataset(data["train"], imgsz=TRAIN_IMGSZ, max_gt=0, augment=True,
                     hyp=get_cfg(DEFAULT_CFG_DICT, {"mode": "train", **HOST_AUG}))
    require(not ds.transform.device_mode, "HOST_AUG's dataset is not in host mode")
    spent = {"read": 0.0, "composite": 0.0, "warp": 0.0, "hsv": 0.0, "mixup": 0.0}

    def timed(stage, fn):
        def run(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                spent[stage] += time.perf_counter() - t0
        return run

    saved = {k: getattr(aug, k) for k in ("mosaic4", "random_perspective", "augment_hsv", "mixup")}
    ds.load_sample = timed("read", ds.load_sample)
    for k, stage in (("mosaic4", "composite"), ("random_perspective", "warp"), ("augment_hsv", "hsv"),
                     ("mixup", "mixup")):
        setattr(aug, k, timed(stage, saved[k]))
    try:
        ds.get_item(0, np.random.default_rng(0))  # the host library's build and first calls
        for k in spent:
            spent[k] = 0.0
        t0 = time.perf_counter()
        for i in range(HOST_SPLIT_SAMPLES):
            ds.get_item(i % len(ds), np.random.default_rng(i))
        total = time.perf_counter() - t0
    finally:
        for k, fn in saved.items():
            setattr(aug, k, fn)
    per = {k: v / HOST_SPLIT_SAMPLES * 1e3 for k, v in spent.items()}
    per["other"] = total / HOST_SPLIT_SAMPLES * 1e3 - sum(per.values())
    per["total"] = total / HOST_SPLIT_SAMPLES * 1e3
    return per


def phase_host_augment():
    """Host augmentation on the card's machine (see the module docstring, 19)."""
    import hashlib
    import tempfile

    import numpy as np
    import torch

    from spectrogram_yolov11_torch import YOLO
    from spectrogram_yolov11_torch.data.augment import resolve_device_augment
    from spectrogram_yolov11_torch.data.dataset import check_det_dataset, find_dataset_yaml
    from spectrogram_yolov11_torch.utils import yaml_load

    t_phase = time.perf_counter()
    recorded = json.loads(HOST_DIGESTS.read_text())["sha256"]
    outputs, op_ms = host_op_outputs()
    got = {k: hashlib.sha256(np.ascontiguousarray(v).tobytes()).hexdigest() for k, v in outputs.items()}
    bad = sorted(k for k in recorded if got.get(k) != recorded[k])
    require(set(got) == set(recorded) and not bad, f"host ops differing from cv2's digests: {bad}")
    del outputs

    bf16 = torch.bfloat16
    counters = launch_counters()
    counts = lambda: {k: c.launches for k, c in counters.items()}  # noqa: E731
    runs, launches = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        data = check_det_dataset(dict(yaml_load(find_dataset_yaml("spectrogram_synth.yaml")), path=tmp))
        split = host_sample_split(data)
        n_val = len(list(Path(data["val"]).iterdir()))
        per_val = {"fused_bottleneck": 0, "fused_bottleneck_bf16": 6 * (n_val // TRAIN_BATCH),
                   "greedy_keep": n_val // TRAIN_BATCH}
        for mode, hyp in (("host", HOST_AUG), ("device", {})):
            rec = {"counts": []}
            cap, stop = capture_val_inputs(bf16)
            yolo = YOLO(CKPT)
            yolo.add_callback("on_train_epoch_start",
                              lambda t: rec["counts"].append({"epoch": t.epoch, "start": counts()}))
            yolo.add_callback("on_train_batch_end", lambda t: rec["counts"][-1].update(steps=counts()))

            def on_fit_epoch_end(t, rec=rec, stop=stop):
                rec["counts"][-1]["val"] = counts()
                stop()  # the first EMA val's inputs only

            yolo.add_callback("on_fit_epoch_end", on_fit_epoch_end)
            t0 = time.perf_counter()
            try:
                metrics, launches[mode] = run_counted(
                    lambda: yolo.train(plots=False, data=data, project=tmp, name=mode, epochs=HOST_EPOCHS,
                                       batch=TRAIN_BATCH, imgsz=TRAIN_IMGSZ, close_mosaic=1, workers=8,
                                       exist_ok=True, **hyp),
                    {k: HOST_EPOCHS * v for k, v in per_val.items()}, f"YOLO.train in {mode} mode")
            finally:
                stop()
            tr = yolo.trainer
            require(resolve_device_augment(tr.args) == (mode == "device") and tr.validator.model.dtype == bf16,
                    f"YOLO.train ran in the wrong mode or dtype ({mode})")
            by_epoch = []
            for c in rec["counts"]:
                steps_c = {k: c["steps"][k] - c["start"][k] for k in c["start"]}
                val_c = {k: c["val"][k] - c["steps"][k] for k in c["start"]}
                require(not any(steps_c.values()) and val_c == per_val,
                        f"{mode} epoch {c['epoch']}: steps {steps_c}, val {val_c}")
                by_epoch.append({"epoch": c["epoch"], "steps": steps_c, "val": val_c})
            require(all(0.0 <= v <= 1.0 for v in metrics.values()), f"{mode} EMA val {metrics}")
            checks, nms = kernels_at(cap, yolo.model.nc, yolo.model.stride, f"{mode} EMA", TRAIN_BATCH, TRAIN_IMGSZ)
            log = tr.epoch_log
            runs[mode] = {"train_call_s": time.perf_counter() - t0, "launches_by_epoch": by_epoch,
                          "final_ema_bf16": metrics, "checks": {"fused_bottleneck_bf16": checks,
                                                                "greedy_keep_k2048": nms},
                          "ms_per_step_with_wait": [(e["seconds"] - e["val_s"]) / e["steps"] * 1e3 for e in log],
                          "loader_wait_ms_per_step": [e["loader_wait_s"] / e["steps"] * 1e3 for e in log],
                          "val_s": [e["val_s"] for e in log], "multi_scale_sizes": tr.ms_sizes_drawn}
        ladder = sorted({max(32, int(round(TRAIN_IMGSZ * f / 32)) * 32) for f in (0.5, 0.75, 1.0, 1.25, 1.5)})
        drawn = runs["host"]["multi_scale_sizes"]
        rng = np.random.default_rng(0 + 1234)  # the seed's default, 0: JAX's draw per step
        require(drawn == [int(rng.choice(ladder)) for _ in drawn] and len(drawn) == HOST_EPOCHS * 128 // TRAIN_BATCH,
                f"multi_scale drew {drawn}")
        require(not runs["device"]["multi_scale_sizes"], "device mode drew multi_scale sizes")

        # the command line's default data (shapes128.yaml, generated at first use) with the disk cache
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, "-m", "spectrogram_yolov11_torch", "train", "epochs=1", "imgsz=320",
                            "batch=16", "cache=disk", "plots=False", f"project={tmp}", "name=cli", "exist_ok=True"],
                           cwd=ROOT, capture_output=True, text=True, timeout=300)
        require(r.returncode == 0, f"train with no data= exited {r.returncode}: {r.stderr[-2000:]}")
        cli_metrics = json.loads((r.stdout.strip().splitlines() or ["{}"])[-1])
        shapes = check_det_dataset("shapes128.yaml")  # written by the command line's run
        root = shapes["path"]
        sidecars = len(list(Path(shapes["train"]).glob("*.npy")))
        require("metrics/mAP50-95(B)" in cli_metrics and sidecars == shapes["n_train"],
                f"train with no data= printed {cli_metrics}, {sidecars} sidecars under {root}")
        cli = {"seconds": time.perf_counter() - t0, "metrics": cli_metrics, "data": str(root), "sidecars": sidecars}
    emit("host_augment", digests_equal=len(recorded), op_ms=op_ms, sample_split_ms=split, launches=launches,
         runs={m: {k: v for k, v in d.items() if k != "checks"} for m, d in runs.items()},
         kernel_checks={m: {n: {k: v for k, v in c.items() if k != "ok"}
                            for n, c in d["checks"]["fused_bottleneck_bf16"].items()} for m, d in runs.items()},
         greedy_keep_k2048={m: {k: d["checks"]["greedy_keep_k2048"][k] for k in (
             "shape", "ms", "plain_ms", "bound_ms", "mismatches")} for m, d in runs.items()},
         cli=cli, phase_s=time.perf_counter() - t_phase,
         method="host ops: SHA-256 of each output against cv2's recorded digest, ms by perf_counter over 5 calls; "
                "the sample split by timers around each stage's function over HOST_SPLIT_SAMPLES samples; "
                "YOLO.train counted from 0 around each call and per epoch by callbacks, the kernels at the first "
                "EMA val's inputs (global module hooks); ms per step = (epoch seconds - val seconds) / steps")
    return launches, {m: d["checks"] for m, d in runs.items()}


def run_files(save_dir, epochs: int) -> dict:
    """What a training run's directory holds of the logging integrations
    (utils/jsonl.py, utils/tb.py): fails unless args.json is there and
    metrics.jsonl holds one row per epoch with the losses and the metrics,
    and unless TensorBoard event files are there exactly when the
    tensorboard package is installed."""
    import importlib.util

    d = Path(save_dir)
    require((d / "args.json").exists() and (d / "metrics.jsonl").exists(), f"{d} lacks args.json or metrics.jsonl")
    args = json.loads((d / "args.json").read_text())
    rows = [json.loads(line) for line in (d / "metrics.jsonl").read_text().splitlines()]
    require([r["epoch"] for r in rows] == list(range(1, epochs + 1))
            and all({"time", "train/box_loss", "metrics/mAP50-95(B)", "fitness"} <= set(r) for r in rows),
            f"{d}/metrics.jsonl rows {rows}")
    tensorboard = importlib.util.find_spec("tensorboard") is not None
    events = sorted(p.name for p in d.glob("events.out.tfevents.*"))
    require(bool(events) == tensorboard, f"tensorboard installed: {tensorboard}, event files {events}")
    return {"args_json_keys": len(args), "args_epochs": args.get("epochs"), "metrics_rows": len(rows),
            "last_row": rows[-1], "tensorboard_installed": tensorboard, "event_files": len(events)}


def _keep_dir() -> Path:
    """KEEP_DIR's directory, made at first use and removed when the script ends."""
    import atexit
    import shutil
    import tempfile

    if not KEEP_DIR:
        KEEP_DIR.append(tempfile.mkdtemp(prefix="chip_smoke_"))
        atexit.register(shutil.rmtree, KEEP_DIR[0], True)
    return Path(KEEP_DIR[0])


def keep_checkpoint(path) -> None:
    """A copy of a checkpoint in KEEP_DIR, its path in SECOND_CKPT."""
    import shutil

    SECOND_CKPT[:] = [shutil.copy(path, _keep_dir() / "second.ckpt")]


def keep_task_checkpoint(task: str, path) -> None:
    """A copy of a task phase's trained checkpoint in KEEP_DIR, its path in TASK_CKPTS[task]."""
    import shutil

    TASK_CKPTS[task] = shutil.copy(path, _keep_dir() / f"{task}.ckpt")


def bottleneck_inputs(dtype):
    """A global module pre-hook that keeps every eval-mode fused bottleneck's
    NHWC input at `dtype` once per (module, shape); it launches nothing.
    Returns (captured, stop)."""
    import torch

    from spectrogram_yolov11_torch.nn.modules.block import Bottleneck

    cap = {}

    def pre(mod, args):  # returns None: the input stays as it is
        if isinstance(mod, Bottleneck) and mod.fusable and not mod.training and args[0].dtype == dtype:
            cap.setdefault((mod, tuple(args[0].shape)), args[0].permute(0, 2, 3, 1).contiguous())

    hook = torch.nn.modules.module.register_module_forward_pre_hook(pre)
    return cap, hook.remove


def phase_predict_extras():
    """Predict's remaining model paths on the card (see the module docstring, 20)."""
    import sqlite3
    import tempfile

    import numpy as np
    import torch

    from spectrogram_yolov11_torch import YOLO
    from spectrogram_yolov11_torch.data.augment import letterbox_batch
    from spectrogram_yolov11_torch.data.dataset import check_det_dataset, find_dataset_yaml
    from spectrogram_yolov11_torch.data.imageio import imread
    from spectrogram_yolov11_torch.data.loaders import iq_frame
    from spectrogram_yolov11_torch.engine.pipeline import normalize, tta_predictions
    from spectrogram_yolov11_torch.ops.nms import nms_candidates
    from spectrogram_yolov11_torch.utils import yaml_load

    t_phase = time.perf_counter()
    dev, nb, bf16 = torch.device("cuda"), PREDICT_BATCH, torch.bfloat16
    yolo, cpu = YOLO(CKPT), YOLO(CKPT, device="cpu")
    iq, arrays = predict_inputs()
    launches = {}

    def counted(path: str, fn, bottlenecks: int, kernel: str = "fused_bottleneck"):
        expect = {"fused_bottleneck": 0, "fused_bottleneck_bf16": 0, "greedy_keep": 1}
        expect[kernel] = bottlenecks
        out, got = run_counted(fn, expect, f"one {path} predict batch")
        launches[path] = {k: launches.get(path, {}).get(k, 0) + v for k, v in got.items()}
        return out

    def frame_of(x):
        return letterbox_batch(list(iq_frame(torch.from_numpy(np.stack([x.real, x.imag], -1))[None].to(dev))), 640, dev)

    def box_err(a, b) -> float:
        return float(np.abs(a.boxes.xyxy - b.boxes.xyxy).max(initial=0.0))

    with tempfile.TemporaryDirectory() as tmp:
        paths = [str(Path(tmp) / f"capture{i}.npy") for i in range(4)]
        for p, capture in zip(paths, iq):
            np.save(p, capture)

        # TTA in f32 and bf16: counted calls, the kernels at the first call's inputs, card against CPU
        tta, checks, nets = {}, {"fused_bottleneck": {}, "fused_bottleneck_bf16": {}}, {}
        for half in (False, True):
            path, kernel = ("tta_half", "fused_bottleneck_bf16") if half else ("tta", "fused_bottleneck")
            cap, stop = bottleneck_inputs(bf16 if half else torch.float32)
            try:
                caps = counted(path, lambda: yolo.predict(paths[0], augment=True, half=half, save=False), 18, kernel)
            finally:
                stop()
            nets[path] = yolo.predictor.model
            caps += [counted(path, lambda p=p: yolo.predict(p, augment=True, half=half, save=False)[0], 18, kernel)
                     for p in paths[1:]]
            require(nets[path].dtype == (bf16 if half else torch.float32) and sum(map(len, caps)) > 0
                    and all(np.isfinite(r.boxes.data).all() for r in caps), f"{path} capture results")
            with torch.inference_mode():
                for (mod, shape), x in cap.items():
                    d = bottleneck_check(f"{path} {tuple(shape)}", layer_case(mod, x))
                    checks[kernel][f"{id(mod):x}_{shape[2]}x{shape[3]}"] = {k: v for k, v in d.items()
                                                                           if "args" not in k}
            sizes = sorted({(shape[1], shape[2]) for _, shape in cap})
            require(sizes == [(32, 28), (32, 34), (32, 40), (64, 14), (64, 17), (64, 20)] and len(cap) == 18,
                    f"{path} bottleneck inputs {sizes}, {len(cap)} of them")
            batch32 = counted(path, lambda: yolo.predict(arrays, batch=nb, augment=True, half=half, save=False), 18,
                              kernel)
            require(len(batch32) == nb and all(r.orig_shape == a.shape[:2] for r, a in zip(batch32, arrays))
                    and all(np.isfinite(r.boxes.data).all() for r in batch32), f"{path} array results")
            tta[path] = {"captures": caps, "batch32": batch32}

        # the keep kernel at the merged candidates of the 32 arrays, (32, 1024)
        lb = letterbox_batch(arrays, 640, dev)
        with torch.inference_mode():
            merged = tta_predictions(nets["tta"], normalize(lb))
        require(merged.shape[1] == 8000 + 6069 + 980, f"TTA merged {tuple(merged.shape)} candidates")
        _, _, _, valid, offset_boxes = nms_candidates(merged, 0.25, yolo.model.nc, pre_nms_topk=1024)
        require(valid.shape == (nb, 1024), f"TTA candidates {tuple(valid.shape)}")
        nms = nms_check(offset_boxes, valid)

        # the card against the CPU on 2 captures: f32 detections, bf16 merged candidates by the bf16 rule
        compare = []
        for i, (p, x) in enumerate(zip(paths[:2], iq[:2])):
            c32 = cpu.predict(p, augment=True, save=False)[0]
            g32 = tta["tta"]["captures"][i]
            require(len(c32) == len(g32) and np.array_equal(c32.boxes.cls, g32.boxes.cls) and box_err(c32, g32) <= 1e-2,
                    f"TTA on the card and the CPU disagree on {p}: {g32.boxes.data.tolist()} vs {c32.boxes.data.tolist()}")
            cpu.predict(p, augment=True, half=True, save=False)
            frame = frame_of(x)
            with torch.inference_mode():
                pg = tta_predictions(nets["tta_half"], normalize(frame)).float().cpu()
                pc = tta_predictions(cpu.predictor.model, normalize(frame.cpu())).float()
                pf = tta_predictions(nets["tta"], normalize(frame)).cpu()
            parts = (("box_px", slice(0, 4)), ("score", slice(4, None)))
            d_cpu = {k: float((pg[..., sl] - pc[..., sl]).abs().max()) for k, sl in parts}
            d_f32 = {k: float((pg[..., sl] - pf[..., sl]).abs().max()) for k, sl in parts}
            require(all(d_cpu[k] <= 2 * d_f32[k] for k in d_cpu),
                    f"TTA bf16 on the card lies {d_cpu} from the CPU's, more than twice {d_f32} from the card's f32")
            compare.append({"n": len(g32), "classes": g32.boxes.cls.tolist(), "max_box_err_px": box_err(c32, g32),
                            "bf16_to_cpu_bf16": d_cpu, "bf16_to_card_f32": d_f32})

        # ms per capture and per image, augment=True beside augment=False, in turns
        times = {}
        for half in (False, True):
            tag = "bf16" if half else "f32"
            for aug in (False, True, True, False):
                key = f"{tag}_{'tta' if aug else 'plain'}"
                cap_ms = host_ms_per_call(lambda: [yolo.predict(p, augment=aug, half=half, save=False)
                                                   for p in paths], 3) / len(paths)
                arr_ms = host_ms_per_call(lambda: yolo.predict(arrays, batch=nb, augment=aug, half=half,
                                                               save=False), 3) / nb
                times.setdefault(key, {"ms_per_capture_b1": [], "ms_per_image_batch32": []})
                times[key]["ms_per_capture_b1"].append(cap_ms)
                times[key]["ms_per_image_batch32"].append(arr_ms)

        # a weight ensemble: the trained checkpoint with a second training run's best.ckpt
        trained_here = not SECOND_CKPT
        if trained_here:  # the phase alone: one epoch of the same detector
            data = check_det_dataset(dict(yaml_load(find_dataset_yaml("spectrogram_synth.yaml")), path=tmp))
            second = YOLO(CKPT)
            second.train(plots=False, data=data, project=tmp, name="second", epochs=1, batch=TRAIN_BATCH,
                         imgsz=TRAIN_IMGSZ, workers=8, exist_ok=True)
            RUN_FILES["predict_extras_second"] = run_files(second.trainer.save_dir, 1)
            keep_checkpoint(second.trainer.best)
        ens, ens_cpu = YOLO([CKPT, SECOND_CKPT[0]]), YOLO([CKPT, SECOND_CKPT[0]], device="cpu")
        ens_arrays = counted("ensemble", lambda: ens.predict(arrays, batch=nb, save=False), 12)
        require(len(ens_arrays) == nb and all(np.isfinite(r.boxes.data).all() for r in ens_arrays),
                "ensemble array results")
        ens_compare = []
        for p in paths[:2]:
            g = counted("ensemble", lambda p=p: ens.predict(p, save=False)[0], 12)
            c = ens_cpu.predict(p, save=False)[0]
            require(len(c) == len(g) and np.array_equal(c.boxes.cls, g.boxes.cls) and box_err(c, g) <= 1e-2,
                    f"the ensemble on the card and the CPU disagree on {p}: {g.boxes.data.tolist()} vs "
                    f"{c.boxes.data.tolist()}")
            ens_compare.append({"n": len(g), "classes": g.boxes.cls.tolist(), "max_box_err_px": box_err(c, g)})
        ens_ms = {}
        for key in ("one_model", "ensemble", "ensemble", "one_model"):
            m = ens if key == "ensemble" else yolo
            ens_ms.setdefault(key, []).append(host_ms_per_call(lambda m=m: m.predict(arrays, batch=nb, save=False), 3) / nb)

        # visualize=True on one capture: one forward more, the CPU's file names, pixels within 1
        vis_kw = dict(visualize=True, save=False, project=tmp, exist_ok=True)
        vis = counted("visualize", lambda: yolo.predict(paths[0], name="vis_card", **vis_kw), 12)
        cpu.predict(paths[0], name="vis_cpu", **vis_kw)
        card_files = sorted(q.name for q in (Path(tmp) / "vis_card" / "features").glob("*.png"))
        cpu_files = sorted(q.name for q in (Path(tmp) / "vis_cpu" / "features").glob("*.png"))
        require(card_files == cpu_files and len(card_files) > 20, f"feature maps {card_files} vs the CPU's {cpu_files}")
        worst, unequal, total = 0, 0, 0
        for name in card_files:
            a, b = (imread(Path(tmp) / d / "features" / name).astype(int) for d in ("vis_card", "vis_cpu"))
            require(a.shape == b.shape, f"{name}: {a.shape} vs {b.shape}")
            worst, unequal, total = max(worst, int(np.abs(a - b).max())), unequal + int((a != b).sum()), total + a.size
        require(worst <= 1, f"feature maps on the card differ from the CPU's by {worst}")
        require(len(vis) == 1, "visualize predict results")

        # the tables on the card's results
        r0 = max(tta["tta"]["captures"], key=len)
        db = str(Path(tmp) / "results.db")
        r0.to_sql(db_path=db)
        r0.to_sql(db_path=db)
        con = sqlite3.connect(db)
        rows = con.execute("SELECT * FROM results").fetchall()
        con.close()
        summary = r0.summary()
        want = [(d["name"], d["class"], d["confidence"], *(d["box"][k] for k in ("x1", "y1", "x2", "y2")))
                for d in summary]
        require(rows == want * 2 and json.loads(r0.to_json()) == summary, "to_sql rows or to_json")
        try:
            import pandas as pd
        except ImportError:
            pd = None
        if pd is None:
            try:
                r0.to_df()
                require(False, "to_df ran without pandas")
            except ImportError as e:
                tables = {"pandas": None, "to_df": f"ImportError: {e}"}
        else:
            require(r0.to_csv() == pd.DataFrame(summary).to_csv(), "to_csv")
            tables = {"pandas": pd.__version__, "to_csv_equal": True}
        tables.update(to_sql_rows=len(rows), detections=len(r0))

        # fault 21: the training phases' run directories
        require(RUN_FILES, "no training phase's run files were read")
    emit("predict_extras", launches=launches,
         tta={k: {"detections_per_capture": [len(r) for r in v["captures"]],
                  "detections_arrays_batch32": sum(map(len, v["batch32"]))} for k, v in tta.items()},
         kernel_checks={k: v for k, v in checks.items()}, greedy_keep_k1024=nms, card_vs_cpu=compare, times=times,
         ensemble={"second_checkpoint": "trained here (1 epoch)" if trained_here else "phase train_loop's best.ckpt",
                   "card_vs_cpu": ens_compare, "ms_per_image_batch32": ens_ms},
         visualize={"files": len(card_files), "max_pixel_diff": worst, "unequal_share": unequal / total},
         tables=tables, run_files=RUN_FILES, phase_s=time.perf_counter() - t_phase,
         method="whole predict calls on the host clock after one warm call, 3 calls each, in turns; counts from 0 "
                "around each call; the bottleneck inputs by a global module pre-hook on the first capture's call; "
                "the keep kernel at the arrays' merged candidates ranked as the device function ranks them")
    return launches, checks, nms


def phase_segment():
    """The segment task on the card (see the module docstring, 21)."""
    import tempfile

    import numpy as np
    import torch

    from spectrogram_yolov11_torch import YOLO
    from spectrogram_yolov11_torch.data.augment import resolve_device_augment
    from spectrogram_yolov11_torch.data.build import DataLoader
    from spectrogram_yolov11_torch.data.dataset import YOLODataset, check_det_dataset, find_dataset_yaml
    from spectrogram_yolov11_torch.data.imageio import imencode
    from spectrogram_yolov11_torch.engine.trainer import SegmentationTrainer
    from spectrogram_yolov11_torch.nn.tasks import build_model
    from spectrogram_yolov11_torch.utils import yaml_load

    t_phase = time.perf_counter()
    bf16, nb = torch.bfloat16, SEG_BATCH
    one_batch = lambda kernel: {"fused_bottleneck": 0, "fused_bottleneck_bf16": 0, "greedy_keep": 1,  # noqa: E731
                                kernel: 6}
    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        data = dict(yaml_load(find_dataset_yaml("shapes128-seg.yaml")), path=str(Path(tmp) / "shapes128-seg"))
        t0 = time.perf_counter()
        data = check_det_dataset(data)
        gen_s = time.perf_counter() - t0
        val_files = sorted(Path(data["val"]).glob("*.jpg"))
        require(len(sorted(Path(data["train"]).glob("*.jpg"))) == 64 and len(val_files) == 16,
                f"shapes128-seg split at {data['path']}")

        # YOLO(yaml).train at its defaults: amp, device-augment mode, counted per epoch's EMA val
        yolo, rec = YOLO("yolo11n-seg.yaml"), {"epochs": []}
        yolo.add_callback("on_train_epoch_start", lambda t: rec["epochs"].append(
            {k: c.launches for k, c in launch_counters().items()}))
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        metrics, launches["train"] = run_counted(
            lambda: yolo.train(data=data, epochs=SEG_EPOCHS, batch=nb, plots=False, project=tmp, name="seg"),
            {"fused_bottleneck": 0, "fused_bottleneck_bf16": 6 * SEG_EPOCHS, "greedy_keep": SEG_EPOCHS},
            "YOLO('yolo11n-seg.yaml').train")
        train_s, peak_gb = time.perf_counter() - t0, torch.cuda.max_memory_allocated() / 2**30
        tr = yolo.trainer
        require(list(metrics)[-1] == "fitness" and "metrics/mAP50-95(M)" in metrics
                and all(np.isfinite(list(metrics.values()))), f"segment train metrics {metrics}")
        require(tr.loss_names == ("box_loss", "seg_loss", "cls_loss", "dfl_loss") and tr.best.exists(),
                "segment trainer loss names or best.ckpt")
        RUN_FILES["segment"] = run_files(tr.save_dir, SEG_EPOCHS)
        epochs = [{"seconds": e["seconds"], "steps": e["steps"], "loader_wait_s": e["loader_wait_s"],
                   "val_s": e["val_s"], "ms_per_step_with_wait": (e["seconds"] - e["val_s"]) / e["steps"] * 1e3}
                  for e in tr.epoch_log]
        best = Path(tmp) / "best.ckpt"
        best.write_bytes(tr.best.read_bytes())
        keep_task_checkpoint("segment", best)

        # one f32 epoch in host mode with copy_paste
        host = YOLO("yolo11n-seg.yaml")
        t0 = time.perf_counter()
        host_metrics, launches["train_host"] = run_counted(
            lambda: host.train(data=data, epochs=1, batch=nb, amp=False, copy_paste=0.5, plots=False, project=tmp,
                               name="seg_host"), one_batch("fused_bottleneck"), "host-mode segment train")
        host_s = time.perf_counter() - t0
        require(not resolve_device_augment(host.trainer.args, "segment")
                and all(np.isfinite(list(host_metrics.values()))), "host-mode segment train")

        # the first f32 step's items on the card against the CPU's, same 2-image batch
        ds = YOLODataset(data["train"], imgsz=640, max_gt=0, augment=True, task="segment",
                         hyp=SegmentationTrainer(None, dict(data=data, amp=False, device="cpu")).args)
        batch = next(iter(DataLoader(ds, 2, workers=2, shuffle=True, seed=0, drop_last=True)))
        items = {}
        for dev in ("cuda", "cpu"):
            t = SegmentationTrainer(build_model("yolo11n-seg.yaml").init(0),
                                    dict(data=data, batch=2, amp=False, device=dev, plots=False))
            t.setup_model()
            t.setup_optimizer(32)
            items[dev] = t.train_step(batch, 0, False)[1].float().cpu().numpy()
        step_rel = float(np.abs(items["cuda"] - items["cpu"]).max() / np.abs(items["cpu"]).max())
        require(step_rel <= 1e-3 and (items["cpu"] > 0).all(),
                f"segment step items card {items['cuda'].tolist()} vs CPU {items['cpu'].tolist()}")

        # val of best.ckpt on the split and on a copy labelled with the card's own top 6 detections per image
        # (rectangles: a model 12 steps old matches no drawn shape, these give the comparisons matches to score):
        # card f32 and bf16 counted, the kernels at the first f32 batch, the CPU's as reference
        card, cpu = YOLO(str(best)), YOLO(str(best), device="cpu")
        v_split = card.val(data=data, batch=nb, plots=False)
        lab = Path(tmp) / "self_labelled"
        (lab / "images").mkdir(parents=True)
        (lab / "labels").mkdir()
        for r in card.predict(data["val"], batch=nb, conf=SEG_CONF, max_det=6, save=False):
            h, w = r.orig_shape
            (lab / "images" / Path(r.path).name).write_bytes(Path(r.path).read_bytes())
            rows = [f"{int(c)} " + " ".join(f"{v:.6f}" for v in (x1 / w, y1 / h, x2 / w, y1 / h, x2 / w, y2 / h,
                                                                    x1 / w, y2 / h))
                    for (x1, y1, x2, y2), c in zip(r.boxes.xyxy, r.boxes.cls)]
            (lab / "labels" / f"{Path(r.path).stem}.txt").write_text("\n".join(rows))
        kw = dict(data={"path": str(lab), "train": "images", "val": "images", "names": data["names"]}, batch=nb,
                  plots=False)
        cap, stop = capture_val_inputs(torch.float32)
        try:
            t0 = time.perf_counter()
            v32, launches["val"] = run_counted(lambda: card.val(**kw), one_batch("fused_bottleneck"), "segment val f32")
            val_s = time.perf_counter() - t0
        finally:
            stop()
        checks, nms = kernels_at(cap, card.model.nc, card.model.stride, "segment val", nb, 640,
                                 multi_label=False)
        v16, launches["val_half"] = run_counted(lambda: card.val(half=True, **kw), one_batch("fused_bottleneck_bf16"),
                                                "segment val bf16")
        c32, c16 = cpu.val(**kw), cpu.val(half=True, **kw)
        val_cmp = {}
        for key in ("metrics/mAP50-95(B)", "metrics/mAP50-95(M)", "metrics/mAP50(B)", "metrics/mAP50(M)"):
            d32, d16, own = abs(v32[key] - c32[key]), abs(v16[key] - c16[key]), abs(c16[key] - c32[key])
            require(d32 <= VAL_TOL and d16 <= 2 * own + VAL_TOL,
                    f"segment val {key}: card f32 {v32[key]} CPU {c32[key]}; card bf16 {v16[key]} CPU {c16[key]}")
            val_cmp[key] = {"card_f32": v32[key], "cpu_f32": c32[key], "card_bf16": v16[key], "cpu_bf16": c16[key]}
        vj, launches["val_save_json"] = run_counted(lambda: card.val(save_json=True, project=tmp, **kw),
                                                    one_batch("fused_bottleneck"), "segment val save_json")
        coco = {k: v for k, v in vj.items() if k.startswith("metrics/coco_")}
        require("metrics/coco_AP(M)" in coco and "metrics/coco_AP" in coco and v32["metrics/mAP50(B)"] > 0.5,
                f"segment COCO stats {sorted(coco)}, val {v32}")

        # predict on the 16 val images at batch 16: f32 and bf16, at the defaults (saving) and save=False
        imgs = data["val"]  # the directory: its 16 JPEGs in name order
        times, saved = {}, {}
        for half in (False, True):
            kernel = "fused_bottleneck_bf16" if half else "fused_bottleneck"
            tag = "bf16" if half else "f32"
            out, launches[f"predict_{tag}"] = run_counted(
                lambda: card.predict(imgs, batch=nb, half=half, project=tmp, name=f"pred_{tag}"), one_batch(kernel),
                f"segment predict {tag}")
            files = {f.stem: f for f in (Path(tmp) / f"pred_{tag}").glob("*.jpg")}
            require(len(files) == 16 and all(files[Path(r.path).stem].read_bytes() == imencode(".jpg", r.plot())
                                             for r in out), f"segment predict {tag} saved files")
            saved[tag] = {"files": len(files), "masks": sum(0 if r.masks is None else len(r.masks) for r in out)}
            for save in (True, False, False, True):
                key = f"{tag}_{'save' if save else 'nosave'}"
                t0 = time.perf_counter()
                card.predict(imgs, batch=nb, half=half, save=save, project=tmp, name=f"t_{key}")
                times.setdefault(key, []).append((time.perf_counter() - t0) / nb * 1e3)
        g = card.predict(imgs, batch=nb, conf=SEG_CONF, max_det=SEG_MAX_DET, save=False)
        c = cpu.predict(imgs, batch=nb, conf=SEG_CONF, max_det=SEG_MAX_DET, save=False)
        unequal = total = 0
        box_err = 0.0
        for a, b in zip(g, c):
            require(len(a) == len(b) and np.array_equal(a.boxes.cls, b.boxes.cls),
                    f"segment predict card {len(a)} vs CPU {len(b)} detections")
            if len(a):
                box_err = max(box_err, float(np.abs(a.boxes.xyxy - b.boxes.xyxy).max()))
                unequal += int((a.masks.data != b.masks.data).sum())
                total += a.masks.data.size
        share = unequal / max(total, 1)
        require(total > 0 and box_err <= 1e-2 and share <= SEG_MASK_SHARE,
                f"segment predict boxes {box_err} px, masks {share} of {total} pixels")
    emit("segment", seconds=time.perf_counter() - t_phase, dataset_gen_s=gen_s, train_s=train_s,
         train_epochs=epochs, peak_gb=peak_gb, train_metrics=metrics, host_train_s=host_s,
         host_metrics=host_metrics, first_step_items={"card": items["cuda"].tolist(), "cpu": items["cpu"].tolist(),
                                                      "max_rel": step_rel},
         val_split=v_split, val_s=val_s, val_self_labelled=val_cmp, coco=coco, bottleneck=checks,
         nms_val={k: nms[k] for k in ("shape", "ms", "plain_ms", "bound_ms", "bound_by", "scan_steps_mean",
                                      "mismatches")},
         predict_ms_per_image={k: sorted(v) for k, v in times.items()}, predict_saved=saved,
         predict_card_vs_cpu={"conf": SEG_CONF, "max_det": SEG_MAX_DET, "detections": sum(len(a) for a in g),
                              "max_box_err_px": box_err,
                              "unequal_mask_share": share, "mask_pixels": total},
         launches=launches)
    return launches, checks, nms


def phase_pose():
    """The pose task on the card (see the module docstring, 22)."""
    import tempfile

    import numpy as np
    import torch

    from spectrogram_yolov11_torch import YOLO
    from spectrogram_yolov11_torch.data.augment import resolve_device_augment
    from spectrogram_yolov11_torch.data.build import DataLoader
    from spectrogram_yolov11_torch.data.dataset import YOLODataset, check_det_dataset, find_dataset_yaml
    from spectrogram_yolov11_torch.data.imageio import imencode
    from spectrogram_yolov11_torch.engine.trainer import PoseTrainer
    from spectrogram_yolov11_torch.nn.tasks import build_model, yaml_model_load
    from spectrogram_yolov11_torch.utils import yaml_load

    t_phase = time.perf_counter()
    bf16, nb = torch.bfloat16, POSE_BATCH
    one_batch = lambda kernel: {"fused_bottleneck": 0, "fused_bottleneck_bf16": 0, "greedy_keep": 1,  # noqa: E731
                                kernel: 6}
    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        data = dict(yaml_load(find_dataset_yaml("shapes128-pose.yaml")), path=str(Path(tmp) / "shapes128-pose"))
        t0 = time.perf_counter()
        data = check_det_dataset(data)
        gen_s = time.perf_counter() - t0
        require(len(sorted(Path(data["train"]).glob("*.jpg"))) == 64 and len(sorted(Path(data["val"]).glob("*.jpg")))
                == 16 and data["kpt_shape"] == [5, 3], f"shapes128-pose split at {data['path']}")

        # YOLO(yaml).train at its defaults: amp, device-augment mode, counted per epoch's EMA val; the kernels'
        # inputs kept at the first EMA val (bf16)
        yolo = YOLO("yolo11n-pose.yaml")
        cap, stop = capture_val_inputs(bf16)
        yolo.add_callback("on_fit_epoch_end", lambda t: stop())  # the first EMA val's inputs only
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        try:
            metrics, launches["train"] = run_counted(
                lambda: yolo.train(data=data, epochs=POSE_EPOCHS, batch=nb, plots=False, project=tmp, name="pose"),
                {"fused_bottleneck": 0, "fused_bottleneck_bf16": 6 * POSE_EPOCHS, "greedy_keep": POSE_EPOCHS},
                "YOLO('yolo11n-pose.yaml').train")
        finally:
            stop()
        train_s, peak_gb = time.perf_counter() - t0, torch.cuda.max_memory_allocated() / 2**30
        tr = yolo.trainer
        require(tr.validator.model.dtype == bf16, "the pose EMA's val did not run a bf16 copy")
        checks, nms = {}, {}
        checks["ema_val"], nms["ema_val"] = kernels_at(cap, yolo.model.nc, yolo.model.stride, "pose EMA val", nb, 640,
                                                       multi_label=False)
        require(list(metrics)[-1] == "fitness" and "metrics/mAP50-95(P)" in metrics
                and all(np.isfinite(list(metrics.values()))), f"pose train metrics {metrics}")
        require(tr.loss_names == ("box_loss", "pose_loss", "kobj_loss", "cls_loss", "dfl_loss") and tr.best.exists()
                and tr.rebuilt == {"kpt_shape": ((17, 3), (5, 3))} and resolve_device_augment(tr.args, "pose"),
                f"pose trainer: loss names, best.ckpt, device mode, the head rebuilt ({tr.rebuilt})")
        RUN_FILES["pose"] = run_files(tr.save_dir, POSE_EPOCHS)
        epochs = [{"seconds": e["seconds"], "steps": e["steps"], "loader_wait_s": e["loader_wait_s"],
                   "val_s": e["val_s"], "ms_per_step_with_wait": (e["seconds"] - e["val_s"]) / e["steps"] * 1e3}
                  for e in tr.epoch_log]
        best = Path(tmp) / "best.ckpt"
        best.write_bytes(tr.best.read_bytes())
        keep_task_checkpoint("pose", best)

        # one f32 epoch in host mode
        host = YOLO("yolo11n-pose.yaml")
        t0 = time.perf_counter()
        host_metrics, launches["train_host"] = run_counted(
            lambda: host.train(data=data, epochs=1, batch=nb, amp=False, device_augment=False, plots=False,
                               project=tmp, name="pose_host"), one_batch("fused_bottleneck"), "host-mode pose train")
        host_s = time.perf_counter() - t0
        require(not resolve_device_augment(host.trainer.args, "pose")
                and all(np.isfinite(list(host_metrics.values()))), "host-mode pose train")

        # one epoch on coco8-pose (17 keypoints: the OKS_SIGMA branches of the loss and the validator)
        coco = check_det_dataset(dict(yaml_load(find_dataset_yaml("coco8-pose.yaml")),
                                      path=str(Path(tmp) / "coco8-pose")))
        c17 = YOLO("yolo11n-pose.yaml")
        t0 = time.perf_counter()
        coco_metrics, launches["train_coco8"] = run_counted(
            lambda: c17.train(data=coco, epochs=1, batch=nb, plots=False, project=tmp, name="pose_coco8"),
            one_batch("fused_bottleneck_bf16"), "coco8-pose train")
        coco_s = time.perf_counter() - t0
        require(c17.trainer.rebuilt is None and c17.model.kpt_shape == (17, 3)
                and all(np.isfinite(list(coco_metrics.values()))), f"coco8-pose train {coco_metrics}")

        # the first f32 step's items on the card against the CPU's, same 2-image batch
        hyp = PoseTrainer(None, dict(data=data, amp=False, device="cpu")).args
        ds = YOLODataset(data["train"], imgsz=640, max_gt=0, augment=True, task="pose", kpt_shape=(5, 3),
                         flip_idx=data["flip_idx"], hyp=hyp)
        batch = next(iter(DataLoader(ds, 2, workers=2, shuffle=True, seed=0, drop_last=True)))
        items = {}
        d5 = {**yaml_model_load("yolo11n-pose.yaml"), "kpt_shape": [5, 3]}
        for dev in ("cuda", "cpu"):
            t = PoseTrainer(build_model(dict(d5)).init(0), dict(data=data, batch=2, amp=False, device=dev, plots=False))
            t.setup_model()
            t.setup_optimizer(32)
            items[dev] = t.train_step(batch, 0, False)[1].float().cpu().numpy()
        step_rel = float((np.abs(items["cuda"] - items["cpu"]) / np.abs(items["cpu"])).max())
        require(step_rel <= POSE_STEP_RTOL and (items["cpu"] > 0).all(),
                f"pose step items card {items['cuda'].tolist()} vs CPU {items['cpu'].tolist()}")

        # val of best.ckpt on the split and on a copy labelled with the card's own top 6 detections per image,
        # boxes and keypoints: card f32 and bf16 counted, the kernels at the first f32 batch, the CPU's as reference
        card, cpu = YOLO(str(best)), YOLO(str(best), device="cpu")
        require(card.task == "pose" and card.model.kpt_shape == (5, 3), "best.ckpt reloads as a (5, 3) pose model")
        v_split = card.val(data=data, batch=nb, plots=False)
        lab = Path(tmp) / "self_labelled"
        (lab / "images").mkdir(parents=True)
        (lab / "labels").mkdir()
        for r in card.predict(data["val"], batch=nb, conf=SEG_CONF, max_det=6, save=False):
            h, w = r.orig_shape
            (lab / "images" / Path(r.path).name).write_bytes(Path(r.path).read_bytes())
            rows = [f"{int(c)} " + " ".join(f"{v:.6f}" for v in [*xywhn] + [u for x, y, _ in kp for u in
                                                                              (x / w, y / h, 2.0)])
                    for xywhn, c, kp in zip(r.boxes.xywhn, r.boxes.cls, r.keypoints.data)]
            (lab / "labels" / f"{Path(r.path).stem}.txt").write_text("\n".join(rows))
        kw = dict(data={"path": str(lab), "train": "images", "val": "images", "names": data["names"],
                        "kpt_shape": [5, 3]}, batch=nb, plots=False)
        cap, stop = capture_val_inputs(torch.float32)
        try:
            t0 = time.perf_counter()
            v32, launches["val"] = run_counted(lambda: card.val(**kw), one_batch("fused_bottleneck"), "pose val f32")
            val_s = time.perf_counter() - t0
        finally:
            stop()
        checks["val"], nms["val"] = kernels_at(cap, card.model.nc, card.model.stride, "pose val", nb, 640,
                                               multi_label=False)
        cap, stop = capture_val_inputs(bf16)
        try:
            v16, launches["val_half"] = run_counted(lambda: card.val(half=True, **kw),
                                                    one_batch("fused_bottleneck_bf16"), "pose val bf16")
        finally:
            stop()
        checks["val_half"], nms["val_half"] = kernels_at(cap, card.model.nc, card.model.stride, "pose val bf16", nb,
                                                         640, multi_label=False)
        c32, c16 = cpu.val(**kw), cpu.val(half=True, **kw)
        val_cmp = {}
        for key in ("metrics/mAP50-95(B)", "metrics/mAP50-95(P)", "metrics/mAP50(B)", "metrics/mAP50(P)"):
            d32, d16, own = abs(v32[key] - c32[key]), abs(v16[key] - c16[key]), abs(c16[key] - c32[key])
            require(d32 <= VAL_TOL and d16 <= 2 * own + VAL_TOL,
                    f"pose val {key}: card f32 {v32[key]} CPU {c32[key]}; card bf16 {v16[key]} CPU {c16[key]}")
            val_cmp[key] = {"card_f32": v32[key], "cpu_f32": c32[key], "card_bf16": v16[key], "cpu_bf16": c16[key]}
        vj, launches["val_save_json"] = run_counted(lambda: card.val(save_json=True, project=tmp, **kw),
                                                    one_batch("fused_bottleneck"), "pose val save_json")
        coco_stats = {k: v for k, v in vj.items() if k.startswith("metrics/coco_")}
        require("metrics/coco_AP(P)" in coco_stats and "metrics/coco_AP" in coco_stats
                and v32["metrics/mAP50(B)"] > 0.5 and v32["metrics/mAP50(P)"] > 0.5,
                f"pose COCO stats {sorted(coco_stats)}, val {v32}")

        # predict on the 16 val images at batch 16: f32 and bf16, at the defaults (saving) and save=False
        imgs = data["val"]
        times, saved = {}, {}
        for half in (False, True):
            kernel = "fused_bottleneck_bf16" if half else "fused_bottleneck"
            tag = "bf16" if half else "f32"
            out, launches[f"predict_{tag}"] = run_counted(
                lambda: card.predict(imgs, batch=nb, half=half, project=tmp, name=f"pose_pred_{tag}"),
                one_batch(kernel), f"pose predict {tag}")
            files = {f.stem: f for f in (Path(tmp) / f"pose_pred_{tag}").glob("*.jpg")}
            require(len(files) == 16 and all(files[Path(r.path).stem].read_bytes() == imencode(".jpg", r.plot())
                                             for r in out), f"pose predict {tag} saved files")
            saved[tag] = {"files": len(files), "keypoints": sum(len(r.keypoints.data) for r in out)}
            for save in (True, False, False, True):
                key = f"{tag}_{'save' if save else 'nosave'}"
                t0 = time.perf_counter()
                card.predict(imgs, batch=nb, half=half, save=save, project=tmp, name=f"pose_t_{key}")
                times.setdefault(key, []).append((time.perf_counter() - t0) / nb * 1e3)
        # at conf 0.001, max_det 30 (a model 12 steps old has no detection above 0.25 to draw): saving, with the
        # keypoints drawn, each file equal to imencode(".jpg", r.plot()); the CPU's as reference
        g, launches["predict_drawn"] = run_counted(
            lambda: card.predict(imgs, batch=nb, conf=SEG_CONF, max_det=SEG_MAX_DET, project=tmp,
                                 name="pose_pred_drawn"), one_batch("fused_bottleneck"), "pose predict drawn")
        files = {f.stem: f for f in (Path(tmp) / "pose_pred_drawn").glob("*.jpg")}
        saved["f32_conf0.001"] = {"files": len(files), "keypoints": sum(len(r.keypoints.data) for r in g)}
        require(len(files) == 16 and saved["f32_conf0.001"]["keypoints"] > 0
                and all(files[Path(r.path).stem].read_bytes() == imencode(".jpg", r.plot()) for r in g),
                "pose predict saved files with keypoints drawn")
        c = cpu.predict(imgs, batch=nb, conf=SEG_CONF, max_det=SEG_MAX_DET, save=False)
        box_err = kpt_err = 0.0
        for a, b in zip(g, c):
            require(len(a) == len(b) and np.array_equal(a.boxes.cls, b.boxes.cls),
                    f"pose predict card {len(a)} vs CPU {len(b)} detections")
            if len(a):
                box_err = max(box_err, float(np.abs(a.boxes.xyxy - b.boxes.xyxy).max()))
                kpt_err = max(kpt_err, float(np.abs(a.keypoints.xy - b.keypoints.xy).max()))
        require(sum(len(a) for a in g) > 0 and box_err <= POSE_PX_TOL and kpt_err <= POSE_PX_TOL,
                f"pose predict boxes {box_err} px, keypoints {kpt_err} px")
    emit("pose", seconds=time.perf_counter() - t_phase, dataset_gen_s=gen_s, train_s=train_s,
         train_epochs=epochs, peak_gb=peak_gb, train_metrics=metrics, host_train_s=host_s,
         host_metrics=host_metrics, coco8_train_s=coco_s, coco8_metrics=coco_metrics,
         first_step_items={"card": items["cuda"].tolist(), "cpu": items["cpu"].tolist(), "max_rel": step_rel},
         val_split=v_split, val_s=val_s, val_self_labelled=val_cmp, coco=coco_stats, bottleneck=checks,
         nms={p: {k: d[k] for k in ("shape", "ms", "plain_ms", "bound_ms", "bound_by", "scan_steps_mean", "mismatches")}
              for p, d in nms.items()},
         predict_ms_per_image={k: sorted(v) for k, v in times.items()}, predict_saved=saved,
         predict_card_vs_cpu={"conf": SEG_CONF, "max_det": SEG_MAX_DET, "detections": sum(len(a) for a in g),
                              "max_box_err_px": box_err, "max_keypoint_err_px": kpt_err},
         launches=launches)
    return launches, checks, nms


def bottlenecks_at(cap: dict, what: str, batch: int, imgsz: int) -> dict:
    """Each fused bottleneck input `cap` kept (capture_val_inputs) against its
    plain version; fails unless the six bottlenecks of a scale-n model at
    `batch` and `imgsz` were seen."""
    checks = fork_bottleneck_checks(cap, what)
    shapes = sorted(c["shape"] for c in checks.values())
    p4, p3 = imgsz // 32, imgsz // 16
    require(shapes == [[batch, p4, p4, 64]] * 4 + [[batch, p3, p3, 32]] * 2, f"{what} inputs {shapes}")
    return checks


def phase_obb():
    """The OBB task on the card (see the module docstring, 23)."""
    import hashlib
    import tempfile

    import numpy as np
    import torch

    from spectrogram_yolov11_torch import YOLO
    from spectrogram_yolov11_torch.data.augment import resolve_device_augment
    from spectrogram_yolov11_torch.data.build import DataLoader
    from spectrogram_yolov11_torch.data.dataset import YOLODataset, check_det_dataset, find_dataset_yaml
    from spectrogram_yolov11_torch.data.imageio import imencode
    from spectrogram_yolov11_torch.engine.trainer import OBBTrainer
    from spectrogram_yolov11_torch.nn.modules.head import OBB
    from spectrogram_yolov11_torch.nn.tasks import build_model, yaml_model_load
    from spectrogram_yolov11_torch.ops.boxes import box_points
    from spectrogram_yolov11_torch.ops.decode import decode_obb
    from spectrogram_yolov11_torch.ops.nms import nms_rotated
    from spectrogram_yolov11_torch.utils import yaml_load
    from spectrogram_yolov11_torch.utils.plotting import polylines

    t_phase = time.perf_counter()
    bf16, nb = torch.bfloat16, OBB_BATCH
    one_batch = lambda kernel: {"fused_bottleneck": 0, "fused_bottleneck_bf16": 0, "greedy_keep": 0,  # noqa: E731
                                kernel: 6}
    sha = lambda a: hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()  # noqa: E731

    # the drawing: polylines and box_points against cv2's committed digests
    blob = json.loads(OBB_DIGESTS.read_text())
    drawn = {c["name"]: sha(polylines(np.random.default_rng(c["seed"]).integers(0, 256, (*c["size"], 3),
                                                                                 dtype=np.uint8),
                                      np.asarray(c["pts"], np.int32), c["closed"], tuple(c["color"]),
                                      c["thickness"])) for c in blob["cases"]}
    rng, bp = np.random.default_rng(blob["box_points"]["seed"]), blob["box_points"]
    pts = np.stack([box_points(((c[0], c[1]), (wh[0], wh[1]), a)) for c, wh, a in
                    zip(rng.uniform(-50, 700, (bp["n"], 2)), rng.uniform(0, 300, (bp["n"], 2)),
                        rng.uniform(-360, 360, bp["n"]))])
    require(drawn == blob["sha256"] and sha(pts) == bp["sha256_f32"] and sha(pts.astype(np.int32)) == bp["sha256_i32"],
            "polylines or box_points differ from cv2's digests")

    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        data = dict(yaml_load(find_dataset_yaml("shapes128-obb.yaml")), path=str(Path(tmp) / "shapes128-obb"))
        t0 = time.perf_counter()
        data = check_det_dataset(data)
        gen_s = time.perf_counter() - t0
        require(len(sorted(Path(data["train"]).glob("*.jpg"))) == 64 and len(sorted(Path(data["val"]).glob("*.jpg")))
                == 16 and data["nc"] == 2, f"shapes128-obb split at {data['path']}")

        # YOLO(yaml).train at its defaults: amp, device-augment mode, plots=True, counted per epoch's EMA val; the
        # kernels' inputs kept at the first EMA val (bf16)
        yolo = YOLO("yolo11n-obb.yaml")
        cap, stop = capture_val_inputs(bf16)
        yolo.add_callback("on_fit_epoch_end", lambda t: stop())  # the first EMA val's inputs only
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        try:
            metrics, launches["train"] = run_counted(
                lambda: yolo.train(data=data, epochs=OBB_EPOCHS, batch=nb, project=tmp, name="obb"),
                {"fused_bottleneck": 0, "fused_bottleneck_bf16": 6 * OBB_EPOCHS, "greedy_keep": 0},
                "YOLO('yolo11n-obb.yaml').train")
        finally:
            stop()
        train_s, peak_gb = time.perf_counter() - t0, torch.cuda.max_memory_allocated() / 2**30
        tr = yolo.trainer
        require(tr.validator.model.dtype == bf16, "the obb EMA's val did not run a bf16 copy")
        checks = {"ema_val": bottlenecks_at(cap, "obb EMA val", nb, 640)}
        require(list(metrics)[-1] == "fitness" and all(np.isfinite(list(metrics.values()))),
                f"obb train metrics {metrics}")
        mosaics = sorted(p.name for p in Path(tr.save_dir).glob("train_batch*.jpg"))
        require(tr.loss_names == ("box_loss", "cls_loss", "dfl_loss") and tr.best.exists()
                and tr.rebuilt["nc"] == (15, 2) and resolve_device_augment(tr.args, "obb")
                and mosaics == ["train_batch0.jpg", "train_batch1.jpg", "train_batch2.jpg"],
                f"obb trainer: loss names, best.ckpt, device mode, the head rebuilt ({tr.rebuilt}), mosaics {mosaics}")
        RUN_FILES["obb"] = run_files(tr.save_dir, OBB_EPOCHS)
        epochs = [{"seconds": e["seconds"], "steps": e["steps"], "loader_wait_s": e["loader_wait_s"],
                   "val_s": e["val_s"], "ms_per_step_with_wait": (e["seconds"] - e["val_s"]) / e["steps"] * 1e3}
                  for e in tr.epoch_log]
        best = Path(tmp) / "best.ckpt"
        best.write_bytes(tr.best.read_bytes())
        keep_task_checkpoint("obb", best)

        # one f32 epoch in host mode
        host = YOLO("yolo11n-obb.yaml")
        t0 = time.perf_counter()
        host_metrics, launches["train_host"] = run_counted(
            lambda: host.train(data=data, epochs=1, batch=nb, amp=False, device_augment=False, plots=False,
                               project=tmp, name="obb_host"), one_batch("fused_bottleneck"), "host-mode obb train")
        host_s = time.perf_counter() - t0
        require(not resolve_device_augment(host.trainer.args, "obb")
                and all(np.isfinite(list(host_metrics.values()))), "host-mode obb train")

        # one epoch on dota8 (15 classes: the head kept at the YAML's nc)
        dota = check_det_dataset(dict(yaml_load(find_dataset_yaml("dota8.yaml")), path=str(Path(tmp) / "dota8")))
        d15 = YOLO("yolo11n-obb.yaml")
        t0 = time.perf_counter()
        dota_metrics, launches["train_dota8"] = run_counted(
            lambda: d15.train(data=dota, epochs=1, batch=nb, plots=False, project=tmp, name="obb_dota8"),
            one_batch("fused_bottleneck_bf16"), "dota8 train")
        dota_s = time.perf_counter() - t0
        require(d15.trainer.rebuilt is None and d15.model.nc == 15
                and all(np.isfinite(list(dota_metrics.values()))), f"dota8 train {dota_metrics}")

        # the first f32 step's items on the card against the CPU's, same 2-image batch
        hyp = OBBTrainer(None, dict(data=data, amp=False, device="cpu")).args
        ds = YOLODataset(data["train"], imgsz=640, max_gt=0, augment=True, task="obb", hyp=hyp)
        batch = next(iter(DataLoader(ds, 2, workers=2, shuffle=True, seed=0, drop_last=True)))
        items = {}
        d2 = {**yaml_model_load("yolo11n-obb.yaml"), "nc": 2}
        for dev in ("cuda", "cpu"):
            t = OBBTrainer(build_model(dict(d2)).init(0), dict(data=data, batch=2, amp=False, device=dev, plots=False))
            t.setup_model()
            t.setup_optimizer(32)
            items[dev] = t.train_step(batch, 0, False)[1].float().cpu().numpy()
        step_rel = float((np.abs(items["cuda"] - items["cpu"]) / np.abs(items["cpu"])).max())
        require(step_rel <= OBB_STEP_RTOL and (items["cpu"] > 0).all(),
                f"obb step items card {items['cuda'].tolist()} vs CPU {items['cpu'].tolist()}")

        # val of best.ckpt on the split and on a copy labelled with the card's own top 6 rotated boxes per image:
        # card f32 and bf16 counted, the kernels at each val's inputs, the CPU's as reference
        card, cpu = YOLO(str(best)), YOLO(str(best), device="cpu")
        require(card.task == "obb" and card.model.nc == 2, "best.ckpt reloads as a 2-class obb model")
        v_split = card.val(data=data, batch=nb, plots=False)
        lab = Path(tmp) / "self_labelled"
        (lab / "images").mkdir(parents=True)
        (lab / "labels").mkdir()
        for r in card.predict(data["val"], batch=nb, conf=SEG_CONF, max_det=6, save=False):
            h, w = r.orig_shape
            (lab / "images" / Path(r.path).name).write_bytes(Path(r.path).read_bytes())
            rows = [f"{int(c)} " + " ".join(f"{v:.6f}" for v in (box_points(((x, y), (bw, bh), float(np.degrees(a))))
                                                                 / np.asarray([w, h], np.float32)).reshape(-1))
                    for (x, y, bw, bh, a), c in zip(r.obb.xywhr, r.obb.cls) if min(bw, bh) >= 2]  # as format_sample
            (lab / "labels" / f"{Path(r.path).stem}.txt").write_text("\n".join(rows))
        kw = dict(data={"path": str(lab), "train": "images", "val": "images", "names": data["names"]}, batch=nb,
                  plots=False)
        heads = []
        grab = torch.nn.modules.module.register_module_forward_hook(
            lambda m, a, o: heads.append(o) if isinstance(m, OBB) and not heads else None)
        cap, stop = capture_val_inputs(torch.float32)
        try:
            t0 = time.perf_counter()
            v32, launches["val"] = run_counted(lambda: card.val(**kw), one_batch("fused_bottleneck"), "obb val f32")
            val_s = time.perf_counter() - t0
        finally:
            stop()
            grab.remove()
        checks["val"] = bottlenecks_at(cap, "obb val", nb, 640)
        with torch.inference_mode():
            preds = decode_obb(*heads[0], card.model.nc, card.model.stride)
            nms_ms = cuda_ms(lambda: nms_rotated(preds, 0.001, 0.7, card.model.nc, 300, 2048), iters=10)
        cap, stop = capture_val_inputs(bf16)
        try:
            v16, launches["val_half"] = run_counted(lambda: card.val(half=True, **kw),
                                                    one_batch("fused_bottleneck_bf16"), "obb val bf16")
        finally:
            stop()
        checks["val_half"] = bottlenecks_at(cap, "obb val bf16", nb, 640)
        c32, c16 = cpu.val(**kw), cpu.val(half=True, **kw)
        val_cmp = {}
        for key in ("metrics/mAP50-95(B)", "metrics/mAP50(B)"):
            d32, d16, own = abs(v32[key] - c32[key]), abs(v16[key] - c16[key]), abs(c16[key] - c32[key])
            require(d32 <= VAL_TOL and d16 <= 2 * own + VAL_TOL,
                    f"obb val {key}: card f32 {v32[key]} CPU {c32[key]}; card bf16 {v16[key]} CPU {c16[key]}")
            val_cmp[key] = {"card_f32": v32[key], "cpu_f32": c32[key], "card_bf16": v16[key], "cpu_bf16": c16[key]}
        vj, launches["val_save_json"] = run_counted(lambda: card.val(save_json=True, project=tmp, **kw),
                                                    one_batch("fused_bottleneck"), "obb val save_json")
        require(v32["metrics/mAP50-95(B)"] > 0.5 and not any(k.startswith("metrics/coco_") for k in vj)
                and not list(Path(tmp).rglob("predictions.json")), f"obb val {v32}, save_json {sorted(vj)}")

        # predict on the 16 val images at batch 16: f32 and bf16, at the defaults (saving) and save=False
        imgs = data["val"]
        times, saved = {}, {}
        for half in (False, True):
            kernel = "fused_bottleneck_bf16" if half else "fused_bottleneck"
            tag = "bf16" if half else "f32"
            out, launches[f"predict_{tag}"] = run_counted(
                lambda: card.predict(imgs, batch=nb, half=half, project=tmp, name=f"obb_pred_{tag}"),
                one_batch(kernel), f"obb predict {tag}")
            files = {f.stem: f for f in (Path(tmp) / f"obb_pred_{tag}").glob("*.jpg")}
            require(len(files) == 16 and all(files[Path(r.path).stem].read_bytes() == imencode(".jpg", r.plot())
                                             for r in out), f"obb predict {tag} saved files")
            saved[tag] = {"files": len(files), "rotated_boxes": sum(len(r) for r in out)}
            for save in (True, False, False, True):
                key = f"{tag}_{'save' if save else 'nosave'}"
                t0 = time.perf_counter()
                card.predict(imgs, batch=nb, half=half, save=save, project=tmp, name=f"obb_t_{key}")
                times.setdefault(key, []).append((time.perf_counter() - t0) / nb * 1e3)
        g, launches["predict_low_conf"] = run_counted(
            lambda: card.predict(imgs, batch=nb, conf=SEG_CONF, max_det=SEG_MAX_DET, save=False),
            one_batch("fused_bottleneck"), "obb predict conf 0.001")
        c = cpu.predict(imgs, batch=nb, conf=SEG_CONF, max_det=SEG_MAX_DET, save=False)
        px_err = rad_err = 0.0
        for a, b in zip(g, c):
            require(len(a) == len(b) and np.array_equal(a.obb.cls, b.obb.cls),
                    f"obb predict card {len(a)} vs CPU {len(b)} detections")
            if len(a):
                px_err = max(px_err, float(np.abs(a.obb.xywhr[:, :4] - b.obb.xywhr[:, :4]).max()))
                rad_err = max(rad_err, float(np.abs(a.obb.xywhr[:, 4] - b.obb.xywhr[:, 4]).max()))
        require(sum(len(a) for a in g) > 0 and px_err <= OBB_PX_TOL and rad_err <= OBB_RAD_TOL,
                f"obb predict xywh {px_err} px, angle {rad_err} rad")
    emit("obb", seconds=time.perf_counter() - t_phase, dataset_gen_s=gen_s, train_s=train_s,
         train_epochs=epochs, peak_gb=peak_gb, train_metrics=metrics, train_batch_mosaics=mosaics,
         host_train_s=host_s, host_metrics=host_metrics, dota8_train_s=dota_s, dota8_metrics=dota_metrics,
         first_step_items={"card": items["cuda"].tolist(), "cpu": items["cpu"].tolist(), "max_rel": step_rel},
         val_split=v_split, val_s=val_s, val_self_labelled=val_cmp, bottleneck=checks,
         nms_rotated={"shape": list(preds.shape), "k": 2048, "ms": nms_ms},
         predict_ms_per_image={k: sorted(v) for k, v in times.items()}, predict_saved=saved,
         predict_card_vs_cpu={"conf": SEG_CONF, "max_det": SEG_MAX_DET, "detections": sum(len(a) for a in g),
                              "max_xywh_err_px": px_err, "max_angle_err_rad": rad_err},
         drawing={"polylines_cases": len(drawn), "box_points": bp["n"]}, launches=launches)
    return launches, checks


def phase_classify():
    """The classify task on the card (see the module docstring, 24)."""
    import tempfile

    import numpy as np
    import torch

    from spectrogram_yolov11_torch import YOLO
    from spectrogram_yolov11_torch.data.build import DataLoader
    from spectrogram_yolov11_torch.data.dataset import check_cls_dataset
    from spectrogram_yolov11_torch.data.imageio import imread
    from spectrogram_yolov11_torch.engine.classify import ClassificationTrainer
    from spectrogram_yolov11_torch.nn.tasks import build_model

    t_phase = time.perf_counter()
    none = {"fused_bottleneck": 0, "fused_bottleneck_bf16": 0, "greedy_keep": 0}
    per_val = CLS_BOTTLENECKS * -(-CLS_VAL_IMAGES // CLS_BATCH)  # 4 bottlenecks per val batch, 2 batches
    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp) / "imagenette160"
        t0 = time.perf_counter()
        info = check_cls_dataset(str(root))
        gen_s = time.perf_counter() - t0
        val_files = sorted(Path(info["val"]).rglob("*.jpg"))
        require(info["nc"] == 3 and len(list(Path(info["train"]).rglob("*.jpg"))) == 96
                and len(val_files) == CLS_VAL_IMAGES, f"the classify stand-in at {root}: {info}")

        # YOLO("yolo11n-cls.yaml").train at its defaults: 224 px, batch 16, f32 steps, an EMA val per epoch
        yolo = YOLO("yolo11n-cls.yaml")
        require(yolo.model.bottlenecks() == {"fused": [(6, 32), (6, 32), (8, 64), (8, 64)], "gated": []},
                f"yolo11n-cls bottlenecks {yolo.model.bottlenecks()}")
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        metrics, launches["train"] = run_counted(lambda: yolo.train(data=str(root), epochs=CLS_EPOCHS),
                                                 dict(none, fused_bottleneck=per_val * CLS_EPOCHS),
                                                 "YOLO('yolo11n-cls.yaml').train")
        train_s, peak_gb = time.perf_counter() - t0, torch.cuda.max_memory_allocated() / 2**30
        tr = yolo.trainer
        require(tr.imgsz == 224 and tr.batch_size == CLS_BATCH and len(tr.epoch_log) == CLS_EPOCHS
                and list(metrics) == ["metrics/accuracy_top1", "metrics/accuracy_top5", "fitness"]
                and yolo.model.nc == 1000, f"classify trainer {tr.imgsz}, {tr.batch_size}, {metrics}")
        epochs = [dict(e, ms_per_step_with_wait=(e["seconds"] - e["val_s"]) / e["steps"] * 1e3) for e in tr.epoch_log]
        ckpt = Path(tmp) / "yolo11n-cls.ckpt"
        yolo.save(ckpt)
        keep_task_checkpoint("classify", ckpt)

        # val (top-1, top-5) counted, the kernel at its inputs (16x14x14x32, 16x7x7x64), against the CPU
        card, cpu = YOLO(str(ckpt)), YOLO(str(ckpt), device="cpu")
        kw = dict(data=str(root), imgsz=224, batch=CLS_BATCH)
        cap, stop = capture_val_inputs(torch.float32)
        try:
            t0 = time.perf_counter()
            v_card, launches["val"] = run_counted(lambda: card.val(**kw), dict(none, fused_bottleneck=per_val),
                                                  "classify val")
            val_s = time.perf_counter() - t0
        finally:
            stop()
        v_cpu = cpu.val(**kw)
        require(v_card == v_cpu, f"classify val card {v_card} vs CPU {v_cpu}")
        checks, times = {}, {}
        with torch.inference_mode():
            for i, m in enumerate(k for k in cap if k != "feats"):
                d = bottleneck_check(f"classify val {i}", layer_case(m, cap[m]))
                c = d["shape"][-1]
                if f"C{c}" not in times:  # the map of layer 6 (C = 32) and of layer 8 (C = 64), 2 launches each
                    times[f"C{c}"] = dict(bottleneck_times("layer6" if c == 32 else "layer8", d),
                                          launches_per_forward=2)
                checks[f"bottleneck{i}"] = {k: v for k, v in d.items() if "args" not in k}
        shapes = sorted(d["shape"] for d in checks.values())
        require(shapes == [[CLS_BATCH, 7, 7, 64]] * 2 + [[CLS_BATCH, 14, 14, 32]] * 2, f"classify val inputs {shapes}")

        # predict on the 24 val images, one per call as JAX's, f32 and half=True; the card against the CPU
        imgs = [imread(f) for f in val_files]
        out, times_pred, half_checks = {}, {}, {}
        for half in (False, True):
            tag, kernel = ("bf16", "fused_bottleneck_bf16") if half else ("f32", "fused_bottleneck")
            cap, stop = capture_val_inputs(torch.bfloat16) if half else ({}, lambda: None)
            try:
                out[tag], launches[f"predict_{tag}"] = run_counted(
                    lambda: card.predict(imgs, imgsz=224, half=half),
                    dict(none, **{kernel: CLS_BOTTLENECKS * len(imgs)}), f"classify predict {tag}")
            finally:
                stop()
            if half:
                with torch.inference_mode():
                    for i, m in enumerate(k for k in cap if k != "feats"):
                        d = bottleneck_check(f"classify predict bf16 {i}", layer_case(m, cap[m]))
                        half_checks[f"bottleneck{i}"] = {k: v for k, v in d.items() if "args" not in k}
            for _ in range(2):
                t0 = time.perf_counter()
                card.predict(imgs, imgsz=224, half=half)
                times_pred.setdefault(tag, []).append((time.perf_counter() - t0) / len(imgs) * 1e3)
        ref = cpu.predict(imgs, imgsz=224)
        prob_err = max(float(np.abs(a.probs.data - b.probs.data).max()) for a, b in zip(out["f32"], ref))
        top5_equal = all(a.probs.top5 == b.probs.top5 for a, b in zip(out["f32"], ref))
        require(prob_err <= CLS_PROB_TOL and top5_equal, f"classify predict probs {prob_err}, top-5 equal {top5_equal}")
        half_err = max(float(np.abs(a.probs.data - b.probs.data).max()) for a, b in zip(out["bf16"], out["f32"]))
        require(len(half_checks) == 4 and np.isfinite(half_err), f"classify bf16 predict: {len(half_checks)} inputs")

        # the first f32 step's loss on the card against the CPU's, same batch of 16
        items = {}
        batch = None
        for dev in ("cuda", "cpu"):
            t = ClassificationTrainer(build_model("yolo11n-cls.yaml", nc=3).init(0), dict(data=str(root), device=dev))
            ds = t.setup_data()
            t.setup_model()
            t.setup_optimizer(96 // CLS_BATCH)
            if batch is None:
                batch = next(iter(DataLoader(ds, CLS_BATCH, workers=2, shuffle=True, seed=0, drop_last=True)))
            items[dev] = t.train_step(batch, 0, True)[1].float().cpu().numpy()
        step_rel = float(np.abs(items["cuda"] - items["cpu"]).max() / np.abs(items["cpu"]).max())
        require(step_rel <= CLS_STEP_RTOL, f"classify step loss card {items['cuda']} vs CPU {items['cpu']}")

        # one epoch of yolo11-cls-resnet18 (the TorchVision stand-in: cuDNN, no fused bottleneck)
        resnet = YOLO("yolo11-cls-resnet18.yaml")
        t0 = time.perf_counter()
        resnet_metrics, launches["resnet18_train"] = run_counted(lambda: resnet.train(data=str(root), epochs=1), none,
                                                                 "YOLO('yolo11-cls-resnet18.yaml').train")
        resnet_s = time.perf_counter() - t0
        require(all(np.isfinite(list(resnet_metrics.values()))), f"resnet18 metrics {resnet_metrics}")
    emit("classify", seconds=time.perf_counter() - t_phase, dataset_gen_s=gen_s, train_s=train_s,
         train_epochs=epochs, peak_gb=peak_gb, train_metrics=metrics, val=v_card, val_s=val_s,
         val_ms_per_image=val_s / CLS_VAL_IMAGES * 1e3, bottleneck=checks, bottleneck_times=times,
         predict_ms_per_image={k: sorted(v) for k, v in times_pred.items()},
         predict_card_vs_cpu={"max_prob_err": prob_err, "top5_equal": top5_equal},
         predict_bf16_vs_f32_max_prob_err=half_err, predict_bf16_bottleneck=half_checks,
         first_step_loss={"card": items["cuda"].tolist(), "cpu": items["cpu"].tolist(), "rel": step_rel},
         resnet18={"train_s": resnet_s, "metrics": resnet_metrics}, launches=launches)
    return launches, checks, half_checks, times


def phase_serve_tasks():
    """Serving the segment, pose, OBB and classify models (see the module docstring, 25)."""
    import tempfile

    import numpy as np
    import torch

    from spectrogram_yolov11_torch import YOLO
    from spectrogram_yolov11_torch.data.dataset import check_det_dataset
    from spectrogram_yolov11_torch.data.imageio import imread
    from spectrogram_yolov11_torch.ops.decode import decode_detections
    from spectrogram_yolov11_torch.ops.nms import nms_candidates
    from spectrogram_yolov11_torch.serve import InferenceServer, RemoteModel

    t_phase = time.perf_counter()
    none = {"fused_bottleneck": 0, "fused_bottleneck_bf16": 0, "greedy_keep": 0}
    yamls = {"segment": "yolo11n-seg.yaml", "pose": "yolo11n-pose.yaml", "obb": "yolo11n-obb.yaml",
             "classify": "yolo11n-cls.yaml"}
    launches, checks, nms, rows = {}, {}, {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        ckpts, sources = {}, {}
        for task, yaml in yamls.items():  # the phases' trained checkpoints, else seeded models from their YAMLs
            if task in TASK_CKPTS:
                ckpts[task], sources[task] = str(TASK_CKPTS[task]), f"phase {task}"
            else:
                ckpts[task], sources[task] = str(Path(tmp) / f"{task}.ckpt"), f"{yaml}, seed 0"
                YOLO(yaml).save(ckpts[task])
        data = check_det_dataset({"path": str(Path(tmp) / "shapes"), "train": "images/train", "val": "images/val",
                                  "synthetic": "shapes", "n_train": 1, "n_val": SERVE_TASK_FRAMES, "gen_imgsz": 640,
                                  "names": {0: "rectangle", 1: "ellipse", 2: "triangle"}})
        frames = [imread(f) for f in sorted(Path(data["val"]).glob("*.jpg"))]
        require(len(frames) == SERVE_TASK_FRAMES, f"{len(frames)} frames at {data['val']}")
        t0 = time.perf_counter()
        srv = InferenceServer(ckpts, port=0).start()
        start_s = time.perf_counter() - t0
        try:
            for task in yamls:
                url = f"http://127.0.0.1:{srv.port}/{task}"
                t0 = time.perf_counter()
                remote, local = YOLO(url), YOLO(ckpts[task])  # the metadata's probe forward runs here
                attach_s = time.perf_counter() - t0
                md = remote.backend._remote.metadata
                require(remote.task == md["task"] == task and ("kpt_shape" in md) == (task == "pose"),
                        f"served {task} metadata {md}")
                n_b = CLS_BOTTLENECKS if task == "classify" else 6
                keep = int(task in ("segment", "pose"))
                kw = dict(save=False, batch=SERVE_TASK_FRAMES, **({"imgsz": 224} if task == "classify" else
                                                                  {"conf": SERVE_TASK_CONF, "max_det": 30}))
                want = dict(none, fused_bottleneck=n_b, greedy_keep=keep)
                cap, stop = capture_val_inputs(torch.float32)
                try:
                    got, launches[f"{task}_remote_predict"] = run_counted(lambda: remote.predict(frames, **kw), want,
                                                                          f"YOLO(url).predict, {task}")
                finally:
                    stop()
                ref, launches[f"{task}_local_predict"] = run_counted(lambda: local.predict(frames, **kw), want,
                                                                     f"YOLO(ckpt).predict, {task}")
                with torch.inference_mode():
                    checks[task] = {}
                    for i, m in enumerate(k for k in cap if k != "feats"):
                        d = bottleneck_check(f"served {task} {i}", layer_case(m, cap[m]))
                        checks[task][f"bottleneck{i}"] = {k: v for k, v in d.items() if "args" not in k}
                    require(len(checks[task]) == n_b, f"served {task}: {len(checks[task])} bottleneck inputs")
                    if keep:  # the client's candidates: each anchor's best class, predict's k = 1024
                        nc = remote.predictor.nc
                        preds = decode_detections(cap["feats"], nc, remote.stride)
                        _, _, _, valid, boxes = nms_candidates(preds, SERVE_TASK_CONF, nc, multi_label=False,
                                                               pre_nms_topk=1024)
                        nms[task] = nms_check(boxes, valid)
                err = {"max_box_err_px": 0.0, "detections": 0}
                for a, b in zip(got, ref):
                    if task == "classify":
                        require(a.probs.top5 == b.probs.top5, f"served classify top-5 {a.probs.top5} vs {b.probs.top5}")
                        err["max_prob_err"] = max(err.get("max_prob_err", 0.0),
                                                  float(np.abs(a.probs.data - b.probs.data).max()))
                        continue
                    da, db = (x.obb.data if task == "obb" else x.boxes.data for x in (a, b))
                    require(da.shape == db.shape, f"served {task}: {da.shape} vs local {db.shape}")
                    err["detections"] += len(da)
                    if len(da):
                        err["max_box_err_px"] = max(err["max_box_err_px"], float(np.abs(da - db).max()))
                    if task == "segment" and len(da):
                        err["unequal_mask_pixels"] = err.get("unequal_mask_pixels", 0) + int(
                            (a.masks.data != b.masks.data).sum())
                        err["mask_pixels"] = err.get("mask_pixels", 0) + a.masks.data.size
                    if task == "pose" and len(da):
                        err["max_kpt_err_px"] = max(err.get("max_kpt_err_px", 0.0),
                                                    float(np.abs(a.keypoints.data - b.keypoints.data).max()))
                if task == "classify":
                    cpu = YOLO(ckpts[task], device="cpu").predict(frames, **kw)
                    err["card_vs_cpu_max_prob_err"] = max(float(np.abs(a.probs.data - b.probs.data).max())
                                                          for a, b in zip(got, cpu))
                    require(err["max_prob_err"] <= CLS_PROB_TOL and err["card_vs_cpu_max_prob_err"] <= CLS_PROB_TOL
                            and all(a.probs.top5 == b.probs.top5 for a, b in zip(got, cpu)),
                            f"served classify probs {err}")
                else:
                    share = err.get("unequal_mask_pixels", 0) / max(err.get("mask_pixels", 1), 1)
                    require(err["detections"] > 0 and err["max_box_err_px"] <= SERVE_TASK_PX_TOL
                            and err.get("max_kpt_err_px", 0.0) <= SERVE_TASK_PX_TOL and share <= SERVE_TASK_MASK_SHARE,
                            f"served {task} against local: {err}")
                # YOLO(url).val: JAX's BackendValidator reading (ROADMAP §3.45), the client on the card and on the CPU
                if task == "classify":
                    try:
                        remote.val(data=data, batch=SERVE_TASK_FRAMES, plots=False)
                        raise RuntimeError("YOLO(url).val of a served classifier ran")
                    except ValueError as e:
                        val = {"raises": str(e)[:80]}
                else:
                    vkw = dict(data=data, batch=SERVE_TASK_FRAMES, plots=False)
                    v_card, launches[f"{task}_remote_val"] = run_counted(
                        lambda: remote.val(**vkw), dict(none, fused_bottleneck=12, greedy_keep=1),
                        f"YOLO(url).val, {task}")  # the class-count probe (6) and one batch (6), the client's NMS
                    v_cpu = YOLO(url, device="cpu").val(**vkw)
                    diff = max(abs(v_card[k] - v_cpu[k]) for k in v_card)
                    require(list(v_card) == list(v_cpu) and diff <= VAL_TOL, f"served {task} val {v_card} vs {v_cpu}")
                    val = {"card": v_card, "max_abs_diff_to_cpu_client": diff,
                           "classes_read": remote.validator.nc}
                # times: the predict call per image, and one 640 px (224 px) frame's request
                t_pred = []
                for _ in range(3):
                    t0 = time.perf_counter()
                    remote.predict(frames, **kw)
                    t_pred.append((time.perf_counter() - t0) / len(frames) * 1e3)
                cli, s = RemoteModel(url), 224 if task == "classify" else 640
                x = np.zeros((1, s, s, 3), np.uint8)
                t_req = []
                for _ in range(11):
                    t0 = time.perf_counter()
                    cli(x)
                    t_req.append((time.perf_counter() - t0) * 1e3)
                rows[task] = dict(source=sources[task], attach_s=attach_s, remote_vs_local=err, val=val,
                                  predict_ms_per_image=sorted(t_pred), request_ms_p50=float(np.median(t_req[1:])),
                                  request_ms_max=max(t_req[1:]))
        finally:
            srv.shutdown()
    emit("serve_tasks", seconds=time.perf_counter() - t_phase, server_start_s=start_s, tasks=rows,
         bottleneck={t: {"max_abs_err": max(d["max_abs_err"] for d in c.values()),
                         "shapes": sorted(d["shape"] for d in c.values())} for t, c in checks.items()},
         nms_client={t: {k: d[k] for k in ("shape", "ms", "plain_ms", "bound_ms", "bound_by", "scan_steps_mean",
                                           "mismatches")} for t, d in nms.items()},
         launches=launches)
    return launches, checks, nms



FAMILY_USERS = ("yolov10n.yaml", "yolov8n.yaml")  # phase families: trained from scratch, val, predict, served
FAMILY_FORK = ("yolov10n_WCC_sand3_new.yaml", "yolov8_sand3_new.yaml")  # phase families: forward and decode
FAMILY_FUSED = 5  # fused bottlenecks per yolov8n / yolov10n forward: C = 32 x 2, 64 x 2, 128 x 1 (layer 2's 16 gated)
FAMILY_CONF, FAMILY_MAX_DET = 0.001, 30  # phase families: the card's predict rows against the CPU's
FAMILY_CONF_TOL, FAMILY_PX_TOL = 1e-4, 1e-2


def rows_match(got, ref, what: str) -> float:
    """Detections (n, 6) [x1, y1, x2, y2, conf, cls] of the card against the
    CPU's: equal counts, each card row paired with an unused CPU row of its
    class whose confidence lies within FAMILY_CONF_TOL (the nearest box among
    them), boxes within FAMILY_PX_TOL. Returns the largest box error."""
    import numpy as np

    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    require(len(got) == len(ref), f"{what}: {len(got)} rows on the card, {len(ref)} on the CPU")
    used, err = np.zeros(len(ref), bool), 0.0
    for row in got:
        cand = np.nonzero(~used & (ref[:, 5] == row[5]) & (np.abs(ref[:, 4] - row[4]) <= FAMILY_CONF_TOL))[0]
        require(len(cand) > 0, f"{what}: no CPU row of class {row[5]} near confidence {row[4]}")
        d = np.abs(ref[cand, :4] - row[:4]).max(1)
        j = cand[int(d.argmin())]
        used[j], err = True, max(err, float(d.min()))
    require(err <= FAMILY_PX_TOL, f"{what}: boxes {err} px from the CPU's")
    return err


def family_forward_decode(net, x):
    """A v8 model's decoded predictions (xywh), a v10 model's one2one branch decoded (xyxy): (B, A, 4 + nc)."""
    from spectrogram_yolov11_torch.ops.decode import decode_detections, decode_e2e

    out = net(x)
    return decode_e2e(out["one2one"], net.nc, net.stride) if net.end2end else decode_detections(out, net.nc,
                                                                                                   net.stride)


def family_config(name: str) -> tuple:
    """A fork v8/v10 config at 640 px, init(0) with scaled_bn: forward and
    decode on the card in f32 and bf16 at B = 1 and 32, counted (one launch
    per fused bottleneck), the first image against the CPU's (f32 within
    FORK_TOL, bf16 within fork_bf16_tol), the bottleneck inputs against the
    plain version, ms per call at B = 32."""
    import copy

    import numpy as np
    import torch

    from spectrogram_yolov11_torch.nn.tasks import build_model, yaml_model_load

    model = build_model(yaml_model_load(name)).init(0)
    b = model.bottlenecks()
    nf = len(b["fused"])
    scaled_bn(model, 1)
    x = torch.from_numpy(np.random.default_rng(len(name)).uniform(0, 1, (32, 3, 640, 640)).astype(np.float32))
    with torch.inference_mode():
        ref = family_forward_decode(model, x[:1])
        ref16 = family_forward_decode(model.set_dtype(torch.bfloat16), x[:1])
    card = copy.deepcopy(model).to("cuda", memory_format=torch.channels_last)
    out = {"end2end": model.end2end, "levels": len(model.stride), "fused": [list(t) for t in b["fused"]],
           "gated": [list(t) for t in b["gated"]]}
    checks = {}
    for dtype, net, want in ((torch.float32, card, ref), (torch.bfloat16, card.set_dtype(torch.bfloat16), ref16)):
        tag = "f32" if dtype == torch.float32 else "bf16"
        kernel = "fused_bottleneck" if dtype == torch.float32 else "fused_bottleneck_bf16"
        if dtype == torch.float32:
            tol = FORK_TOL * (1 + float(want.abs().max()))
        else:
            tol = fork_bf16_tol(float((ref16 - ref).abs().max()), float(ref16.abs().max()))
        for nb in (1, 32):
            xg = x[:nb].cuda().contiguous(memory_format=torch.channels_last)
            cap, stop = capture_val_inputs(dtype)
            try:
                with torch.inference_mode():
                    got, launches = run_counted(lambda: family_forward_decode(net, xg),
                                                {"fused_bottleneck": 0, "fused_bottleneck_bf16": 0, "greedy_keep": 0,
                                                 kernel: nf}, f"{name} {tag} B={nb}")
            finally:
                stop()
            err = float((got[:1].float().cpu() - want).abs().max())
            require(err <= tol, f"{name} {tag} B={nb}: the card's decode lies {err} from the CPU's (tolerance {tol})")
            kept = len([k for k in cap if k != "feats"])
            require(kept == nf, f"{name} {tag} B={nb}: {kept} bottleneck inputs kept, {nf} fused")
            checks[f"{tag}_b{nb}"] = fork_bottleneck_checks(cap, f"{name} {tag} B={nb}")
            out[f"{tag}_b{nb}"] = {"launches": launches, "max_abs_err": err, "tolerance": tol}
        with torch.inference_mode():
            out[f"{tag}_b32"]["ms"] = cuda_ms(lambda: family_forward_decode(net, xg), iters=5, warmup=2)
    del card
    torch.cuda.empty_cache()
    return out, checks


def phase_families(smi: str):
    """The YOLOv8 and YOLOv10 families on the card (see the module docstring, 26)."""
    import tempfile

    import numpy as np
    import torch

    from spectrogram_yolov11_torch import YOLO
    from spectrogram_yolov11_torch.data.dataset import check_det_dataset, find_dataset_yaml
    from spectrogram_yolov11_torch.engine.exporter import build_inference_fn
    from spectrogram_yolov11_torch.engine.pipeline import eval_network
    from spectrogram_yolov11_torch.serve import RemoteModel, serve
    from spectrogram_yolov11_torch.utils import yaml_load

    t_phase = time.perf_counter()
    bf16, nb = torch.bfloat16, TRAIN_BATCH
    launches, checks, nms, users = {}, {"f32": {}, "bf16": {}}, {}, {}

    kernel_times = {}

    def counted(key: str, fn, dtype, fused: int, keep: int, nc: int = 2, stride=None, timed: bool = False):
        """fn() counted from 0, each bottleneck input and the keep kernel's candidates kept at `dtype` and held
        against the plain versions; with `timed`, the kernel at each input beside the cuDNN chain, its plain
        version and its bound (bottleneck_times)."""
        tag = "f32" if dtype == torch.float32 else "bf16"
        kernel = "fused_bottleneck" if dtype == torch.float32 else "fused_bottleneck_bf16"
        cap, stop = capture_val_inputs(dtype)
        try:
            out, launches[key] = run_counted(fn, {"fused_bottleneck": 0, "fused_bottleneck_bf16": 0,
                                                  "greedy_keep": keep, kernel: fused}, key)
        finally:
            stop()
        require(len([k for k in cap if k != "feats"]) == FAMILY_FUSED, f"{key}: bottleneck inputs {len(cap)}")
        checks[tag][key] = fork_bottleneck_checks(cap, key)
        if timed:
            with torch.inference_mode():
                kernel_times[key] = [
                    bottleneck_times(f"{key} {i}", bottleneck_check(f"{key} {i}", layer_case(m, cap[m])),
                                     launches_per_forward=1)
                    for i, m in enumerate(k for k in cap if k != "feats")]
        if keep:
            nms[key] = fork_nms_at(cap, nc, stride)
        return out

    with tempfile.TemporaryDirectory() as tmp:
        data = check_det_dataset(dict(yaml_load(find_dataset_yaml("spectrogram_synth.yaml")), path=tmp))
        n_val = len(list(Path(data["val"]).iterdir()))
        pred_dir = Path(tmp) / "predict16"  # the first 16 val images, one predict batch
        pred_dir.mkdir()
        for f in sorted(Path(data["val"]).iterdir())[:nb]:
            (pred_dir / f.name).write_bytes(f.read_bytes())
        for name in FAMILY_USERS:
            tag, v10 = Path(name).stem, "10" in name
            per_batch_keep = 0 if v10 else 1
            yolo = YOLO(name)
            require(yolo.model.end2end == v10 and yolo.model.nc == 80, f"YOLO({name!r}): end2end, nc")
            stamps = []  # each step's end, synchronised: later steps' ms with the loader's wait

            def step_end(t, stamps=stamps):
                torch.cuda.synchronize()
                stamps.append(time.perf_counter())

            yolo.add_callback("on_train_batch_end", step_end)
            t0 = time.perf_counter()
            metrics = counted(f"{tag}_train",
                              lambda: yolo.train(plots=False, data=data, project=tmp, name=tag, epochs=1, batch=nb,
                                                 imgsz=640, workers=8, exist_ok=True),
                              bf16, FAMILY_FUSED * (n_val // nb), per_batch_keep * (n_val // nb),
                              stride=yolo.model.stride)
            train_s = time.perf_counter() - t0
            tr = yolo.trainer
            require(tr.rebuilt is not None and tr.rebuilt["nc"] == (80, 2) and tr.args.amp is True
                    and tr.validator.model.dtype == bf16 and all(np.isfinite(list(metrics.values()))),
                    f"{name} train: rebuilt {tr.rebuilt}, metrics {metrics}")
            log = tr.epoch_log
            best = Path(tmp) / f"{tag}_best.ckpt"
            best.write_bytes(tr.best.read_bytes())
            card, cpu = YOLO(str(best)), YOLO(str(best), device="cpu")
            require(card.model.end2end == v10, f"{name} best.ckpt reloads end2end={card.model.end2end}")
            t0 = time.perf_counter()
            v32 = counted(f"{tag}_val", lambda: card.val(plots=False, data=data, batch=VAL_BATCH), torch.float32,
                          FAMILY_FUSED * (n_val // VAL_BATCH), per_batch_keep * (n_val // VAL_BATCH),
                          stride=card.model.stride, timed=True)
            val_s = time.perf_counter() - t0
            v16 = counted(f"{tag}_val_half", lambda: card.val(plots=False, data=data, batch=VAL_BATCH, half=True), bf16,
                          FAMILY_FUSED * (n_val // VAL_BATCH), per_batch_keep * (n_val // VAL_BATCH),
                          stride=card.model.stride)
            kw = dict(batch=nb, conf=FAMILY_CONF, max_det=FAMILY_MAX_DET, save=False)
            got = counted(f"{tag}_predict", lambda: card.predict(str(pred_dir), **kw), torch.float32,
                          FAMILY_FUSED, per_batch_keep, stride=card.model.stride)
            ref = cpu.predict(str(pred_dir), **kw)
            box_err = max(rows_match(g.boxes.data, r.boxes.data, f"{name} predict {Path(g.path).name}")
                          for g, r in zip(got, ref))
            require(sum(len(g) for g in got) > 0, f"{name} predict kept no rows")
            times = []
            for _ in range(3):
                t0 = time.perf_counter()
                card.predict(str(pred_dir), batch=nb, save=False)
                times.append((time.perf_counter() - t0) / nb * 1e3)

            # one served request of 2 frames: the outputs of the local serving graph on the card
            frames = np.random.default_rng(3).integers(0, 255, (2, 640, 640, 3), np.uint8)
            srv = serve({tag: str(best)}, port=0, block=False)
            try:
                remote = RemoteModel(f"http://127.0.0.1:{srv.port}/{tag}")
                remote(frames[:1])  # the warm-up dispatch
                t0 = time.perf_counter()
                served = counted(f"{tag}_served", lambda: remote(frames), torch.float32, FAMILY_FUSED, 0)
                request_ms = (time.perf_counter() - t0) * 1e3
            finally:
                srv.shutdown()
            local = build_inference_fn(eval_network(card.model, False, torch.device("cuda")))(
                torch.from_numpy(frames).cuda())
            local = [t.cpu().numpy() for t in (local if isinstance(local, tuple) else (local,))]
            require(len(served) == len(local) == (2 if v10 else 1), f"{name} served {len(served)} outputs")
            served_err = max(float(np.abs(np.asarray(a, np.float64) - b).max()) for a, b in zip(served, local))
            require(served_err <= 1e-4 * (1 + max(float(np.abs(b).max()) for b in local)),
                    f"{name}: served outputs lie {served_err} from the local graph's")
            users[tag] = {"train_s": train_s, "train_metrics": metrics, "rebuilt": tr.rebuilt,
                          "ms_per_step_with_wait": [(e["seconds"] - e["val_s"]) / e["steps"] * 1e3 for e in log],
                          "ms_per_later_step_with_wait": (np.diff(stamps) * 1e3).tolist(),
                          "loader_wait_ms_per_step": [e["loader_wait_s"] / e["steps"] * 1e3 for e in log],
                          "ema_val_s": [e["val_s"] for e in log], "val_f32": v32, "val_bf16": v16, "val_s": val_s,
                          "predict_rows": sum(len(g) for g in got), "predict_max_box_err_px": box_err,
                          "predict_ms_per_image": times, "served_max_abs_err": served_err,
                          "served_request_ms": request_ms, "served_n_valid": served[1].tolist() if v10 else None}
        forks = {}
        for name in FAMILY_FORK:
            forks[name], fchecks = family_config(name)
            for k, v in fchecks.items():
                checks[k.split("_")[0]][f"{Path(name).stem}_{k}"] = v
    per_forward = {key: {f: sum(t[f] for t in ts) for f in ("ms", "plain_ms", "library_ms", "bound_ms")}
                   for key, ts in kernel_times.items()}
    emit("families", card=smi, seconds=time.perf_counter() - t_phase, users=users, fork=forks,
         bottleneck_checks=checks,
         bottleneck_times={k: [{f: t[f] for f in ("shape", "ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
                                                  "share_of_bound")} for t in ts] for k, ts in kernel_times.items()},
         bottleneck_per_forward_b32=per_forward,
         nms={p: {k: d[k] for k in ("shape", "ms", "plain_ms", "bound_ms", "bound_by", "scan_steps_mean", "mismatches")}
              for p, d in nms.items()},
         launches=launches,
         method="each run counted from 0 around the call; every fused bottleneck input and the keep kernel's "
                "candidates of it kept by global module hooks and held against the plain versions")
    fork_launches = {f"{Path(n).stem}_{k}": v["launches"] for n, f in forks.items() for k, v in f.items()
                     if isinstance(v, dict) and "launches" in v}
    flat = {t: [d for c in checks[t].values() for d in c.values()] for t in ("f32", "bf16")}
    return {**launches, **fork_launches}, flat, nms


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False: this script needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    try:
        from spectrogram_yolov11_torch.data.synth import synth_frames
        from spectrogram_yolov11_torch.engine.pipeline import build_pipeline
    except ImportError as e:
        print(f"chip_smoke: the port is missing beside this script ({e})", file=sys.stderr)
        return 2
    require(CKPT.exists(), f"missing checkpoint {CKPT}")
    t_start = time.perf_counter()

    smi = phase_card()
    phase_build()
    fn, model, nh, nw = build_pipeline(CKPT, device="cuda")
    frames_np = synth_frames(max(BATCHES), nh, nw, seed=0)
    with torch.inference_mode():
        frames_dev = torch.from_numpy(frames_np).cuda()
        bottleneck, nms_trained = phase_kernels(fn, model, frames_dev)
        launches = phase_pipeline(fn, model, frames_dev, frames_np)
        shapes, nms = phase_times(fn, frames_dev, bottleneck, nms_trained)
        phase_profile(fn, frames_dev)
    predict_launches, nms_k1024, b1_bottleneck = phase_predict()
    with torch.inference_mode():
        half_launches, half_checks, half_shapes = phase_half(fn, frames_dev)
    predict_half_launches, b1_half = phase_predict_half()
    val_launches, nms_val = phase_val()
    images_launches, images_checks, nms_images = phase_images()
    serve_launches, serve_checks, nms_serve = phase_serve()
    train_val_launches, train_bottleneck, nms_train = phase_train()
    loop_launches, loop_bottleneck, nms_loop, loop_final = phase_train_loop()
    amp_launches, amp_bottleneck, nms_amp = phase_train_amp(loop_final)
    scratch_launches, scratch_bottleneck, nms_scratch, load_launches, load_bottleneck, nms_load = phase_scratch()
    save_launches, save_checks, nms_save = phase_save()
    art_launches, art_checks, nms_art = phase_artifacts()
    fork_launches, fork_checks, nms_fork = phase_fork()
    host_launches, host_checks = phase_host_augment()
    extras_launches, extras_checks, nms_extras = phase_predict_extras()
    seg_launches, seg_checks, nms_seg = phase_segment()
    pose_launches, pose_checks, nms_pose = phase_pose()
    obb_launches, obb_checks = phase_obb()
    cls_launches, cls_checks, cls_half_checks, cls_times = phase_classify()
    st_launches, st_checks, st_nms = phase_serve_tasks()
    fam_launches, fam_checks, fam_nms = phase_families(smi)

    def per_forward(key, shapes=shapes):
        return sum(shapes[n][key] * shapes[n]["launches_per_forward"] for n in ("layer6", "layer8"))

    def serve_paths(kernel: str, remote_val: int) -> dict:
        return {"serve": sum(v[kernel] for v in serve_launches["serve"].values()),
                "serve_half": sum(v[kernel] for v in serve_launches["serve_half"].values()),
                "remote_predict": serve_launches["remote_predict"][kernel], "remote_val": remote_val}

    def fork_paths(kernel: str) -> int:
        return (sum(v[t][kernel] for v in fork_launches["configs"].values() for t in ("f32", "bf16"))
                + sum(fork_launches[k][kernel] for k in ("train", "val", "predict")))

    fork_f32 = [d for n, _ in FORK_CONFIGS for d in fork_checks[n]["f32"].values()] + list(fork_checks["val"].values())
    fork_bf16 = ([d for n, _ in FORK_CONFIGS for d in fork_checks[n]["bf16"].values()]
                 + list(fork_checks["train_ema_val"].values()))
    host_bf16 = [d for c in host_checks.values() for d in c["fused_bottleneck_bf16"].values()]
    extras_f32, extras_bf16 = (list(extras_checks[k].values()) for k in ("fused_bottleneck", "fused_bottleneck_bf16"))
    pose_bf16 = [d for k in ("ema_val", "val_half") for d in pose_checks[k].values()]
    obb_bf16 = [d for k in ("ema_val", "val_half") for d in obb_checks[k].values()]

    def extras_paths(kernel: str) -> dict:
        return {path: got[kernel] for path, got in extras_launches.items()}

    def seg_paths(kernel: str) -> dict:
        return {f"segment_{path}": got[kernel] for path, got in seg_launches.items()}

    def pose_paths(kernel: str) -> dict:
        return {f"pose_{path}": got[kernel] for path, got in pose_launches.items()}

    def obb_paths(kernel: str) -> dict:
        return {f"obb_{path}": got[kernel] for path, got in obb_launches.items()}

    def cls_paths(kernel: str) -> dict:
        return {**{f"classify_{path}": got[kernel] for path, got in cls_launches.items()},
                **{f"serve_tasks_{path}": got[kernel] for path, got in st_launches.items()}}

    st_f32 = [d for c in st_checks.values() for d in c.values()]

    def fam_paths(kernel: str) -> dict:
        return {"families": sum(got[kernel] for got in fam_launches.values())}
    fb_ops_bound = TF32_PASSES * per_forward("flops") / PEAK_TF32_FLOPS >= per_forward("bytes") / PEAK_HBM_BYTES
    kernels_line = [
        dict(name="fused_bottleneck", route="cuda", source="spectrogram_yolov11_torch/csrc/fused_bottleneck.cu",
             replaces="spectrogram_yolov11_tpu/ops/pallas_fused_conv.py:67",
             launches=launches["fused_bottleneck"],
             launches_by_path={"pipeline": launches["fused_bottleneck"], "predict": predict_launches["fused_bottleneck"],
                               "val": val_launches["f32"]["fused_bottleneck"],
                               "images": sum(v["fused_bottleneck"] for v in images_launches.values()),
                               "train_ema_val": train_val_launches["fused_bottleneck"],
                               "train_loop": loop_launches["fused_bottleneck"],
                               "train_amp": amp_launches["fused_bottleneck"],
                               "scratch": scratch_launches["fused_bottleneck"],
                               "load_val": load_launches["fused_bottleneck"],
                               "save": sum(save_launches[k]["fused_bottleneck"]
                                           for k in ("arrays_f32", "jpeg_directory", "wire_jpeg")),
                               "artifacts": sum(v["fused_bottleneck"] for v in art_launches.values()),
                               "fork": fork_paths("fused_bottleneck"),
                               "host_augment": sum(v["fused_bottleneck"] for v in host_launches.values()),
                               **extras_paths("fused_bottleneck"), **seg_paths("fused_bottleneck"),
                               **pose_paths("fused_bottleneck"), **obb_paths("fused_bottleneck"),
                               **cls_paths("fused_bottleneck"), **fam_paths("fused_bottleneck"),
                               **serve_paths("fused_bottleneck", serve_launches["remote_val"]["fused_bottleneck"])},
             max_abs_err=max(d["max_abs_err"] for d in (*bottleneck.values(), *b1_bottleneck.values(),
                                                         *images_checks["fused_bottleneck"].values(),
                                                         *serve_checks["fused_bottleneck"].values(),
                                                         *train_bottleneck.values(), *loop_bottleneck.values(),
                                                         *load_bottleneck.values(),
                                                         *save_checks["arrays_f32"].values(),
                                                         *art_checks["val_f32"].values(), *fork_f32,
                                                         *extras_f32, *seg_checks.values(),
                                                         *pose_checks["val"].values(), *obb_checks["val"].values(),
                                                         *cls_checks.values(), *st_f32, *fam_checks["f32"])),
             families_max_abs_err=max(d["max_abs_err"] for d in fam_checks["f32"]),
             fork_max_abs_err=max(d["max_abs_err"] for d in fork_f32),
             predict_extras_max_abs_err=max(d["max_abs_err"] for d in extras_f32),
             segment_val_max_abs_err=max(d["max_abs_err"] for d in seg_checks.values()),
             pose_val_max_abs_err=max(d["max_abs_err"] for d in pose_checks["val"].values()),
             obb_val_max_abs_err=max(d["max_abs_err"] for d in obb_checks["val"].values()),
             classify_val_max_abs_err=max(d["max_abs_err"] for d in cls_checks.values()),
             serve_tasks_max_abs_err=max(d["max_abs_err"] for d in st_f32),
             classify_val_maps={k: {f: d[f] for f in ("shape", "launches_per_forward", "ms", "plain_ms", "bound_ms",
                                                      "bound_by", "library_ms", "share_of_bound")}
                                for k, d in cls_times.items()},
             ms=per_forward("ms"), plain_ms=per_forward("plain_ms"), bound_ms=per_forward("bound_ms"),
             bound_by="operations" if fb_ops_bound else "bytes", library_ms=per_forward("library_ms"),
             bound_f32_cuda_cores_ms=per_forward("bound_f32_cuda_cores_ms"),
             design="implicit GEMM, 3xTF32 wgmma (A in registers), TMA weight ring, persistent grid",
             note="times are per forward at B=32: 2 launches at 32x40x40x32 + 4 at 32x20x20x64; "
                  "bound_ms is 3xTF32 on the tensor cores"),
        dict(name="fused_bottleneck_bf16", route="cuda", source="spectrogram_yolov11_torch/csrc/fused_bottleneck.cu",
             replaces="spectrogram_yolov11_tpu/ops/pallas_fused_conv.py:67",
             launches=half_launches["fused_bottleneck_bf16"],
             launches_by_path={"pipeline_half": half_launches["fused_bottleneck_bf16"],
                               "predict_half": predict_half_launches["fused_bottleneck_bf16"],
                               "val_half": val_launches["bf16"]["fused_bottleneck_bf16"],
                               "images_val_half": images_launches["val_bf16"]["fused_bottleneck_bf16"],
                               "train_amp": amp_launches["fused_bottleneck_bf16"],
                               "scratch": scratch_launches["fused_bottleneck_bf16"],
                               "save_half": save_launches["arrays_bf16"]["fused_bottleneck_bf16"],
                               "artifacts": sum(v["fused_bottleneck_bf16"] for v in art_launches.values()),
                               "fork": fork_paths("fused_bottleneck_bf16"),
                               "host_augment": sum(v["fused_bottleneck_bf16"] for v in host_launches.values()),
                               **extras_paths("fused_bottleneck_bf16"), **seg_paths("fused_bottleneck_bf16"),
                               **pose_paths("fused_bottleneck_bf16"), **obb_paths("fused_bottleneck_bf16"),
                               **cls_paths("fused_bottleneck_bf16"), **fam_paths("fused_bottleneck_bf16"),
                               **serve_paths("fused_bottleneck_bf16",
                                             serve_launches["remote_val_half"]["fused_bottleneck_bf16"])},
             max_abs_err=max(d["max_abs_err"] for d in (*half_checks.values(), *b1_half.values(),
                                                         *images_checks["fused_bottleneck_bf16"].values(),
                                                         *amp_bottleneck.values(), *scratch_bottleneck.values(),
                                                         *serve_checks["fused_bottleneck_bf16"].values(),
                                                         *save_checks["arrays_bf16"].values(),
                                                         *art_checks["val_bf16"].values(), *fork_bf16,
                                                         *host_bf16, *extras_bf16, *pose_bf16, *obb_bf16,
                                                         *cls_half_checks.values(), *fam_checks["bf16"])),
             families_max_abs_err=max(d["max_abs_err"] for d in fam_checks["bf16"]),
             fork_max_abs_err=max(d["max_abs_err"] for d in fork_bf16),
             host_augment_max_abs_err=max(d["max_abs_err"] for d in host_bf16),
             predict_extras_max_abs_err=max(d["max_abs_err"] for d in extras_bf16),
             pose_ema_val={"shapes": sorted(d["shape"] for d in pose_checks["ema_val"].values()),
                           "max_abs_err": max(d["max_abs_err"] for d in pose_checks["ema_val"].values()),
                           "unequal_share_max": max(d["unequal_share"] for d in pose_checks["ema_val"].values())},
             pose_val_half_max_abs_err=max(d["max_abs_err"] for d in pose_checks["val_half"].values()),
             obb_ema_val={"shapes": sorted(d["shape"] for d in obb_checks["ema_val"].values()),
                          "max_abs_err": max(d["max_abs_err"] for d in obb_checks["ema_val"].values()),
                          "unequal_share_max": max(d["unequal_share"] for d in obb_checks["ema_val"].values())},
             obb_val_half_max_abs_err=max(d["max_abs_err"] for d in obb_checks["val_half"].values()),
             unequal_share_max=max(d["unequal_share"] for d in (*half_checks.values(), *b1_half.values(),
                                                                 *images_checks["fused_bottleneck_bf16"].values(),
                                                                 *amp_bottleneck.values(),
                                                                 *scratch_bottleneck.values(),
                                                                 *serve_checks["fused_bottleneck_bf16"].values(),
                                                                 *save_checks["arrays_bf16"].values(),
                                                                 *art_checks["val_bf16"].values(), *fork_bf16,
                                                                 *host_bf16, *extras_bf16, *pose_bf16,
                                                                 *obb_bf16, *cls_half_checks.values(),
                                                                 *fam_checks["bf16"])),
             train_amp_ema_val={"shapes": sorted(d["shape"] for d in amp_bottleneck.values()),
                                "max_abs_err": max(d["max_abs_err"] for d in amp_bottleneck.values()),
                                "tolerance_min": min(d["tolerance"] for d in amp_bottleneck.values())},
             ms=per_forward("ms", half_shapes), plain_ms=per_forward("plain_ms", half_shapes),
             bound_ms=per_forward("bound_ms", half_shapes),
             bound_by="operations" if per_forward("flops", half_shapes) / PEAK_BF16_FLOPS
             >= per_forward("bytes", half_shapes) / PEAK_HBM_BYTES else "bytes",
             library_ms=per_forward("library_ms", half_shapes),
             design="the f32 kernel's tiles and schedule; bf16 wgmma m64nCk16 (A in registers) summed in its f32 "
                    "accumulator; intermediate and output rounded to bf16 as Pallas",
             note="times are per forward at B=32 of the bf16 pipeline: 2 launches at 32x40x40x32 + 4 at "
                  "32x20x20x64; bound_ms is bf16 on the tensor cores or HBM; library_ms is the cuDNN bf16 chain; "
                  "max_abs_err is in bf16 steps of up to 2^-7 max|ref|"),
        dict(name="greedy_keep", route="cuda", source="spectrogram_yolov11_torch/csrc/greedy_nms.cu",
             replaces="spectrogram_yolov11_tpu/ops/pallas_nms.py:70",
             launches=launches["greedy_keep"],
             launches_by_path={"pipeline": launches["greedy_keep"], "predict": predict_launches["greedy_keep"],
                               "pipeline_half": half_launches["greedy_keep"],
                               "predict_half": predict_half_launches["greedy_keep"],
                               "val": val_launches["f32"]["greedy_keep"], "val_half": val_launches["bf16"]["greedy_keep"],
                               "images": sum(v["greedy_keep"] for v in images_launches.values()),
                               "train_ema_val": train_val_launches["greedy_keep"],
                               "train_loop": loop_launches["greedy_keep"], "train_amp": amp_launches["greedy_keep"],
                               "scratch": scratch_launches["greedy_keep"], "load_val": load_launches["greedy_keep"],
                               "save": sum(v["greedy_keep"] for v in save_launches.values()),
                               "artifacts": sum(v["greedy_keep"] for v in art_launches.values()),
                               "fork": fork_paths("greedy_keep"),
                               "host_augment": sum(v["greedy_keep"] for v in host_launches.values()),
                               **extras_paths("greedy_keep"), **seg_paths("greedy_keep"), **pose_paths("greedy_keep"),
                               **obb_paths("greedy_keep"), **cls_paths("greedy_keep"), **fam_paths("greedy_keep"),
                               **serve_paths("greedy_keep", serve_launches["remote_val"]["greedy_keep"]
                                             + serve_launches["remote_val_half"]["greedy_keep"])},
             max_abs_err=0.0,
             ms=nms["ms"], plain_ms=nms["plain_ms"], bound_ms=nms["bound_ms"], bound_by=nms["bound_by"],
             library_ms=None, design="IoU bitmask of valid rows + one-warp scan from survivor to survivor",
             scan_steps_mean=nms["scan_steps_mean"],
             predict_k1024={k: nms_k1024[k] for k in ("shape", "ms", "plain_ms", "bound_ms", "bound_by",
                                                      "scan_steps_mean", "mismatches")},
             val_k2048={k: nms_val[k] for k in ("shape", "ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
                                                 "scan_steps_mean", "mismatches")},
             images_val_k2048={k: nms_images[k] for k in ("shape", "ms", "plain_ms", "bound_ms", "bound_by",
                                                         "scan_steps_mean", "mismatches")},
             train_ema_val_k2048={k: nms_train[k] for k in ("shape", "ms", "plain_ms", "bound_ms", "bound_by",
                                                           "scan_steps_mean", "mismatches")},
             train_loop_k2048={k: nms_loop[k] for k in ("shape", "ms", "plain_ms", "bound_ms", "bound_by",
                                                        "scan_steps_mean", "mismatches")},
             train_amp_k2048={k: nms_amp[k] for k in ("shape", "ms", "plain_ms", "bound_ms", "bound_by",
                                                      "scan_steps_mean", "mismatches")},
             scratch_k2048={k: nms_scratch[k] for k in ("shape", "ms", "plain_ms", "bound_ms", "bound_by",
                                                     "scan_steps_mean", "mismatches")},
             load_val_k2048={k: nms_load[k] for k in ("shape", "ms", "plain_ms", "bound_ms", "bound_by",
                                                      "scan_steps_mean", "mismatches")},
             remote_val_k2048={k: nms_serve[k] for k in ("shape", "ms", "plain_ms", "bound_ms", "bound_by",
                                                       "scan_steps_mean", "mismatches")},
             save_k1024={p: {k: d[k] for k in ("shape", "ms", "plain_ms", "bound_ms", "bound_by", "scan_steps_mean",
                                                "mismatches")} for p, d in nms_save.items()},
             artifacts_val_k2048={p: {k: d[k] for k in ("shape", "ms", "plain_ms", "bound_ms", "bound_by",
                                                        "scan_steps_mean", "mismatches")} for p, d in nms_art.items()},
             fork_val_k2048={p: {k: d[k] for k in ("shape", "ms", "plain_ms", "bound_ms", "bound_by",
                                                   "scan_steps_mean", "mismatches")} for p, d in nms_fork.items()},
             host_augment_val_k2048={m: {k: c["greedy_keep_k2048"][k] for k in (
                 "shape", "ms", "plain_ms", "bound_ms", "bound_by", "scan_steps_mean", "mismatches")}
                 for m, c in host_checks.items()},
             predict_extras_tta_k1024={k: nms_extras[k] for k in ("shape", "ms", "plain_ms", "bound_ms", "bound_by",
                                                                  "scan_steps_mean", "mismatches")},
             segment_val_k2048={k: nms_seg[k] for k in ("shape", "ms", "plain_ms", "bound_ms", "bound_by",
                                                        "scan_steps_mean", "mismatches")},
             pose_k2048={p: {k: d[k] for k in ("shape", "ms", "plain_ms", "bound_ms", "bound_by", "scan_steps_mean",
                                               "mismatches")} for p, d in nms_pose.items()},
             serve_tasks_client_k1024={t: {k: d[k] for k in ("shape", "ms", "plain_ms", "bound_ms", "bound_by",
                                                             "scan_steps_mean", "mismatches")} for t, d in st_nms.items()},
             families_k2048={p: {k: d[k] for k in ("shape", "ms", "plain_ms", "bound_ms", "bound_by",
                                                   "scan_steps_mean", "mismatches")} for p, d in fam_nms.items()},
             note="one launch per pipeline, predict or val batch; times at B=32, k=512 on the trained model's "
                  "candidates (predict_k1024: predict's k on the 32 IQ captures' candidates; val_k2048: the "
                  "validator's multi-label k on the val split's first batch)"),
    ]
    emit("total", seconds=time.perf_counter() - t_start)
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels_line}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
