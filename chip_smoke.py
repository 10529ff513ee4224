#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``mxnet_tpu_torch``) on one CUDA card.

Run from the root of a checkout, on a machine with an NVIDIA H100 and
``nvcc``:

    python3 chip_smoke.py

Phases, each fatal on failure:

1. device: require CUDA; print the card's name and power limit.
2. build: compile every CUDA kernel of the port from ``ops/csrc`` with
   nvcc, one process per source, all at once.
3. kernels: each kernel against its plain PyTorch version on the card.
   Flash attention at the parity-test shapes, ragged lengths,
   ``sm_scale=0.5``, D in {16, 32, 64, 128}, the full-width layer shape
   (8, 12, 1024, 64) causal and the D-32 LM's (8, 8, 2048, 32), in fp32
   (TF32 off), bf16 and fp16, each case both contiguous and as the
   strided views the model's einsum makes (strides (S*H*D, D, H*D, 1)),
   through whichever kernel ``attention.design`` picks (the tensor cores
   at every D: bf16/fp16 as they are, fp32 split into three bf16 parts),
   and at D 48, which runs padded to 64;
   the flash-attention backward kernels' dq, dk and dv against
   ``chunked_attention_grads`` at the same cases, dtypes and layouts
   (``do`` strided too where q, k, v are), held to ``BWD_ATOL`` and
   ``BWD_ROW_RTOL``, the sharp cases (sm_scale ``SHARP_SCALE``) row by
   row against an fp64 reference instead, at a limit set by the plain
   version's own error (``test_utils.sharp_row_check``), through
   whichever kernel ``attention.design_backward`` picks by the same rule,
   each call repeated and held bit for bit;
   scale at numel 0, 1, 7, 64 x 128 (the MLP's), 1000003 (also
   misaligned by one element) and 8192 x 8192, alpha 0.5, 3.0, -1.25
   and two that fp32 cannot hold exactly (0.1, 1/3), bit for bit.
   Timings of each kernel, its plain version and one PyTorch call as a
   yardstick (``F.scaled_dot_product_attention``, its backward through
   ``torch.autograd.grad`` less its forward, ``torch.mul``; the port
   never calls any of them), and each attention kernel's bound; the
   attention kernels at ``MAIN_SHAPE`` (D 64) and at ``D32_SHAPE``.
4. LM inference at GPT-2 small widths (12 layers, d_model 768, 12 heads,
   d_ff 3072, vocab 50257, max_len 1024; seeded random weights): 4 batches
   of 8 x 1024 tokens scored to logits and mean next-token NLL, in fp32,
   bf16 and fp16, with the kernel's launch count read around each run.
5. parity: a small LM's logits and NLL on the card (through the kernel)
   against the same params on the CPU (through the plain version), in
   fp32 and in bf16, from three seeds each.
6. registration: ``rtc.register("pl_scale", ...)`` over the scale kernel;
   ``nd.pl_scale`` on a CUDA NDArray and ``sym.sum(sym.pl_scale(...))``
   bound on ``gpu(0)``: forward, backward gives the alpha gradient, one
   launch per forward.
7. MLP training: the MNIST MLP of ``examples/train_mnist.py``
   (784-128-64-10, MXNet's published widths) built with ``sym`` with
   ``pl_scale`` after the first activation, bound with ``simple_bind``,
   trained one epoch (64 steps of 64 synthetic digits) with
   SGD-momentum, then scored on the 1024 test images in fp32 and, with
   the trained weights cast, in bf16; the kernel's launches asserted.
8. MLP parity: 10 steps on the card (through the kernel) against the same
   init on the CPU (through the plain version), fp32, TF32 off.
Every training step of the port replays captured CUDA graphs on the
card (``mxnet_tpu_torch.capture``): Module's step one graph, the LM steps
one, a Gluon step three (forward, backward, update); a bound Executor's
``forward`` one, ``backward`` one (the second stage of its training
forward's program), ``forward_backward`` one.  ``capture.eager()``
runs them eagerly, the oracle of phase 17 and the "eager" figures of
phases 10, 11, 14 and 16.  A captured step warms up ``WARMUP_RUNS`` times
before it captures, and those runs launch the kernels too
(``expected_launches``).

9. ResNet parity: ``resnet50_v1`` (1000 classes) through ``Module`` at
   batch 2, 3 x 224 x 224, one Module on the card (captured: one capture,
   one replay a step, asserted) and one on the CPU from the same
   parameters, two ``_fit_step``s each (SGD lr 0.1, momentum 0.9, wd
   1e-4); the softmax outputs of each step, and the parameters and
   moving statistics after step 2, held to ``RESNET_PARITY_TOL``, in fp64
   and in fp32 (TF32 off).
10. ResNet-50 training at ``bench.py``'s configuration
   (``_module_train_rate``: the Gluon model lowered to a Symbol, ``Cast``
   to fp32, ``SoftmaxOutput``, ``Module`` at batch 32, Xavier, SGD lr
   0.1, momentum 0.9, wd 1e-4, one seeded batch) in fp32 (TF32 off) and
   bf16, captured and eager in turn: 5 warm-up and 30 timed
   ``_fit_step``s through ``CachedTrainStep`` each (the timed steps: 1
   replay and 1 program call a step captured, none eagerly, no capture),
   then 5 + 30 inference forwards; ms/step, img/s, peak memory and the
   share of the card's peak that 24.6 GFLOP per training image (8.2 per
   inference image) gives.  No hand-written kernel runs on this path:
   its convolutions and products are cuDNN's and cuBLAS's.
11. LM training at GPT-2 small widths (phase 4's configuration, not cut)
   on one seeded batch of 8 x 1024 tokens, in fp32 (TF32 off), bf16 and
   fp16, through ``make_train_step`` (SGD, lr 0.1) and
   ``make_train_step_zero1`` (momentum 0.9), captured and eager in turn:
   5 warm-up and 10 timed steps each (timed: 1 replay a step captured,
   no capture); ms/step, tokens/s, peak memory and the share of the
   card's peak at the FLOPs counted by ``lm_train_flops``; the loss must
   stay finite and fall, and every step must launch the forward and the
   backward kernel n_layers times each (plus n_layers for each warm-up
   run of a capture).
12. LM training parity: a small LM (2 layers, d_model 128, 2 heads, so
   D = 64; S = 200) trained 3 steps by each step builder on the card
   (captured, through both kernels) and on the CPU (through the plain
   versions) from one init, in fp32 (TF32 off) and bf16; the loss, the
   params and the momenta held to ``LM_TRAIN_PARITY_TOL`` after each
   step.
13. D-32 parity: phase 12's LM with 4 heads (D = 32) in fp32 and bf16,
   scored (held to ``PARITY_TOL``) and trained 3 steps by
   ``make_train_step`` (held to ``LM_TRAIN_PARITY_TOL``), card against
   CPU, with the kernels' launches counted.
14. The D-32 LM at Pythia-31M's published widths (``PYTHIA_31M``: 6
   layers, d_model 256, 8 heads, so D = 32; d_ff 1024, vocab 50304,
   max_len 2048; seeded random weights) on one seeded batch of 8 x 2048
   tokens, in fp32 (TF32 off), bf16 and fp16: 4 batches scored (ms/batch,
   tokens/s), then 5 warm-up and 10 timed ``make_train_step`` steps,
   captured and eager in turn (ms/step, tokens/s, peak memory, share of
   peak at ``lm_train_flops``); the loss must fall and every step launch
   each kernel n_layers times (as phase 11 counts them).
15. Gluon ResNet-50 parity (run after phase 10): ``resnet50_v1`` from the
   zoo, ``hybridize()``, ``SoftmaxCrossEntropyLoss`` and
   ``gluon.Trainer("sgd")`` at phase 10's hyper-parameters, 2 steps at
   batch 2 from phase 9's init, on the card and on the CPU, in fp64 (held
   to ``RESNET_PARITY_TOL``) and fp32 (TF32 off; step-1 outputs 1e-4),
   the card's steps three replays each after three captures (asserted);
   the fp64 card run's first step also against one Module step from the
   same init and batch (``GLUON_MODULE_TOL``); and, for each of the
   twelve optimizers with a fused update, 3 Trainer steps of a
   784-256-10 net through the fused step and through the per-parameter
   loop, weights and states bit for bit.
16. Gluon ResNet-50 training at batch 32, 224 x 224, in fp32 (TF32 off)
   and bf16 (the net cast, the logits cast to fp32 before the loss): 5
   warm-up and 30 timed steps (forward and loss under
   ``autograd.record()``, ``loss.backward()``, ``Trainer.step``),
   captured and eager in turn; ms/step, img/s, peak memory and share of
   peak beside phase 10's Module figures; the loss must be finite, a
   moving statistic must move, the timed steps must trace no graph, make
   one fused update each and replay three graphs a step (captured) or
   none (eager), with no capture.  No hand-written kernel runs on this
   path either.
17. Captured against eager (``capture.eager()``) on the card: the fused
   ``Trainer`` update of each of the twelve rules over Parameters of
   ResNet-50's shapes, 6 steps of a ``FactorScheduler`` that halves the
   lr each step, in fp32 and bf16, bit for bit, one capture and then
   none; a hybridized Dense called twice in each recording, and one
   unrolled three times on its own output, 3 Trainer steps, to
   ``SHARED_REL`` (a program for each call before the backward); both
   LM step builders, 3 steps of the parity LM in fp32 and bf16, to
   ``LM_TRAIN_PARITY_TOL`` (and whether bit for bit); ResNet-50 at batch
   2 in fp64 through ``Module``, captured against eager beside eager
   against eager, to ``RESNET_PARITY_TOL``.
18. ResNet-50 through ``Module`` at batch 32 with Nadam (whose update
   reads the momentum schedule the host derives from t each step) and
   with RMSProp, the lr lowered each step, fp32 (TF32 off)
   and bf16, captured and eager in turn: 5 warm-up and 10 timed steps
   each; ms/step and peak memory; the captured steps replay one program
   a step and capture none.
19. Checkpoint and resume (run after phase 18), cuDNN deterministic for
   this phase only: ResNet-50 at batch 32 in fp32 (TF32 off) and bf16,
   through ``Module`` with SGD momentum (phase 10's set-up) and through
   phase 16's hybridized net with ``Trainer("adam")``, 3 steps, a
   checkpoint with the optimizer states (``save_checkpoint``;
   ``Block.save_params`` and ``Trainer.save_states``), 3 more steps (run
   A); a fresh Module (``Module.load``, ``bind``, ``init_optimizer``) or
   net and Trainer loads the files and takes the same 3 batches; a
   second uninterrupted run (run C) gives the card's run-to-run spread.
   The parameters, moving statistics and optimizer states of the resume
   must equal run A's bit for bit, or lie within run C's distance from
   run A; the arrays reloaded from the files must equal the saved ones
   bit for bit; the resumed steps capture each program once and replay
   it, run A's steps after the checkpoint capture none.  The files'
   sizes and the save and load seconds are printed, and ``nd.save``/
   ``nd.load`` of GPT-2 small's parameters (``GPT2_SMALL``, 163M with
   its untied output projection) in fp32, bf16 and fp16 is timed and
   held bit for bit.

20. The vision zoo at full width (after phase 14): (a) Inception-v3
   (``get_model("inceptionv3")``, 1000 classes) traced on
   ``sym.Variable`` with ``SoftmaxOutput``, bound by ``Module`` as
   ``examples/train_inception_v3.py`` binds it (Xavier, SGD lr 0.05,
   momentum 0.9, wd 1e-4), batch 32 at 299 x 299, fp32 (TF32 off) and
   bf16, captured and eager in turn: 5 warm-up and 30 timed steps (1
   replay a step captured, no capture), its ``Dropout(0.5)`` live in the
   captured step; (b) AlexNet through Gluon (``hybridize()``,
   ``SoftmaxCrossEntropyLoss``, ``Trainer("sgd")``) at the reference's
   per-GPU batch of 512, 224 x 224, both ``Dropout(0.5)`` live, 3
   replays a timed step; two recorded forwards of one batch must differ
   and two predict forwards agree, and AlexNet's own Dropout block at
   the classifier's shape must draw a new mask on each replay, keep a
   fraction within 5 sigma of 0.5 and put its backward's zeros where its
   forward's are (whether an eager call and a captured replay from one
   generator state draw the same mask is printed); ms/step, img/s, peak
   memory and the share of peak at the FLOPs of ``ZOO_FWD_FLOPS``; (c)
   scoring at batch 32 (``ZOO_SCORE_MODELS``, median of 10), fp32 and
   bf16; (d) one model of each family (``ZOO_PARITY_MODELS``) card
   against CPU in fp64 at batch 2 from one init, every Dropout rate 0:
   the predict-mode logits and one SGD step's gradients, weights and
   moving statistics, held to ``ZOO_PARITY_TOL``.
21. The op sweep: every case of ``test_utils.op_cases`` (one or more for
   each op of the elemwise, reduce, matrix and nn modules) on the card
   against the CPU, forward and gradients, fp32 (TF32 off) at each
   case's tolerance and the unary, reduce, dot and batch_dot cases again
   in bf16; each random op's 10^6 draws on the card within 5 standard
   errors of its distribution's mean and variance.  Its cases include
   the fused ``RNN`` op: each mode, 1 and 2 layers, one and two
   directions, with and without the state outputs.
22. The RNN op on the card: whether the packed layout is cuDNN's weight
   buffer (``cudnn_layout_check``; it is not, so torch copies the
   weights into one at each call), and its dropout between layers in a
   captured Module step (``rnn_dropout_checks``): a new mask each
   replay, the kept share within 3 sigma of 0.5, an eager step and the
   captured one from one generator state drawing the same mask.
23. The PTB LSTM of MXNet's ``example/rnn/bucketing`` at its published
   widths (``PTB``: 2 x 200, batch 32, buckets 10-60, SGD lr 0.01 wd
   1e-5, ``Perplexity(ignore_label=0)``) through ``BucketingModule.fit``,
   with per-step ``LSTMCell``s and with ``FusedRNNCell``, on a seeded
   Zipf corpus over 10,000 words: captured and eager, one step on each
   bucket then 30 in the iterator's shuffled order (per-bucket ms/step,
   tokens/s, perplexity, 1 replay and no capture a timed step), the
   device's busy share, and the memory held with the buckets' captured
   steps in one graph pool (at most ``POOL_RATIO_LIMIT`` times that of
   the largest bucket alone) and, for comparison, in one a bucket.
24. The medium Gluon word LM (``WORD_LM``: 2 x 650, dropout 0.5, batch
   32, bptt 35) as ``examples/word_language_model.py`` trains it,
   captured (Embedding, Dense and loss hybridized; the fused Trainer
   update) and eager: ms/step, tokens/s, busy share, peak memory.
25. fp64 parity, the vocabulary cut to 1,000: (a) in both variants and
   (b) (dropout 0, no clipping) card against CPU over 3 steps, held to
   ``ZOO_PARITY_TOL``; (a) captured against eager over 8 steps of
   shuffled buckets, within ``CAPTURED_EAGER_TOL``.
26. The data path's loader: what the host offers for JPEG (``jpeg_probe``:
   libjpeg's header and the package's build of it, nvJPEG, PIL, cv2, the
   cores), a ``.rec`` of 2,048 seeded JPEGs as MXNet stores ImageNet
   (shorter side 256, quality 95; ``test_utils.synthetic_image``),
   encoded with libjpeg where it builds, else PIL; the resize kernel
   (``ops.image_nvjpeg``, one launch a round) bit for bit against its
   plain version, each of ``RESIZE_CASES`` alone and all in one ragged
   round with a failed record's hole, with and without the mean and the
   scale, and timed on a round of 32 (``RESIZE_ROUND``, past the L2
   cache) beside its bound, the plain version and ``F.interpolate``;
   ``ImageRecordIter`` (batch 32 at 224 x 224, shuffle, mirror) on the
   card, whose decoder is nvJPEG: img/s at ``preprocess_threads`` 1, 4,
   8 and the core count, the copy of a batch to the card from pageable
   and from pinned memory, the batch on the card equal to the host's bit
   for bit, the decoded pixels against the images before encoding
   (``LIBJPEG_ERR`` x ``NVJPEG_MARGIN``), ``mean_rgb`` and ``scale`` in
   the kernel bit for bit with numpy's on the same batch, and
   ``allow_corrupt`` over a file with ``CORRUPT_RECORDS`` not JPEGs
   (labels, order, pads and failures those of the CPU loader).  Phases
   26-28 launch the resize kernel once a round of the loader.
27. BASELINE #2 from that file: ResNet-50 through Gluon as
   ``examples/train_imagenet.py`` trains it (``hybridize``,
   ``SoftmaxCrossEntropyLoss``, ``Trainer("sgd")`` lr 0.1, momentum 0.9,
   wd 1e-4), batch 32, fp32 (TF32 off) and bf16 (cast on the card), fed
   by ``ImageRecordIter`` at 4 threads: 5 + 30 steps, ms/step and img/s
   beside phase 16's, the busy share, each timed step 3 replays, 0
   captures, 0 traces and 1 fused update; then ``Module.fit`` over 4
   batches of the same iterator.
28. BASELINE #1: idx files at MNIST's sizes (60,000 + 10,000 synthetic
   digits), ``examples/train_mnist.py``'s LeNet through ``Module.fit``
   over ``MNISTIter`` for one epoch at batch 64 (ms/step, test accuracy
   at least ``LENET_JAX_CPU_ACCURACY`` less 0.02), and a Gluon LeNet fed
   by ``DataLoader(vision.MNIST(...), num_workers=2)`` for 20 steps.
29. C.7 on the card's host (it has cv2): ``image.imresize`` against
   ``cv2.resize`` at tests/test_torch_image.py's sizes, interpolations 0-3,
   uint8 and float32, at that file's bars (nearest equal in uint8, the
   others within 1; float32 within 1e-4), then the resizing augmenters
   (``ResizeAug``, ``ForceResizeAug``, ``RandomSizedCropAug``, a resizing
   ``CenterCropAug``, ``CreateAugmenter(resize=...)``) against themselves
   with ``cv2.resize`` in place of the port's resize, from one
   ``random.seed``, within 1.  Fails where cv2 is missing.
30. The kvstore and several contexts: (a) BASELINE #4, Inception-v3 as
   ``examples/train_inception_v3.py`` trains it (phase 20a's module, every
   Dropout rate 0), batch 32, fp32 (TF32 off) and bf16, 3 steps with the
   update on ``mt.kv.create("device")`` held to the captured step without
   a store, cuDNN deterministic (bit for bit, or within two runs without
   a store), each step
   one push and one pull a parameter, then ms/step (median of 10 after
   3), img/s and peak memory on the store; the example's own set-up,
   ``Module`` on ``[gpu(0)]`` with ``fit(kvstore="device")``, one replay
   and no capture a step after the first; (b) phase 7's MLP through
   ``Module`` on ``[gpu(0), cpu(0)]`` (workload 3:1) under ``"device"``
   and ``"local"``, and through Gluon (``split_and_load``,
   ``Trainer(kvstore="device")``), 20 steps each, held to the same runs on
   ``[cpu(0), cpu(1)]`` at phase 8's bars; (c) ``push_pull_all`` over
   Inception-v3's gradient shapes, two copies on ``gpu(0)``, fp32 and
   bf16: bit for bit with the CPU store's, one reduce a bucket, timed
   against the per-key push/pull loop.
31. The op long tail (BASELINE #5): (a) the greedy-NMS kernels
   (``ops/csrc/nms.cu``) against their plain loop on the card, mask for
   mask, at example/ssd's SSD-300 head (8,732 anchors, batch 32, 21
   classes; ``nms_topk`` 400 and -1), at Proposal's pre-NMS 6000 and at
   ragged sizes (the 64-box tile edges, fp64, force, up to 12,000 boxes),
   with ms, the plain loop's ms and the bound, the longest image's kept
   boxes, and the pairs the mask kernel visits, its scratch bytes and the
   walk's steps; with the kernels' count then set to 0,
   (b) ``MultiBoxTarget`` and ``MultiBoxDetection`` at the SSD-300 head on
   the card against ``cpu()`` (classes, masks and row order equal, values
   within ``SSD_OP_TOL``), then both as one captured program whose replay
   equals the eager run bit for bit, eager and captured ms; (c)
   ``examples/train_ssd_toy.py``'s ``ToySSD`` at the example's settings,
   eager as the example runs and hybridized (forward and
   ``MultiBoxPrior`` replayed), each to a mean IoU of at least
   ``TOY_SSD_MIN_IOU``, then 3 steps card against CPU in fp64 at
   ``ZOO_PARITY_TOL``; the kernels' launches on (b) and (c) read; (d)
   ``Custom`` ops eager against the CPU with their gradients, a
   hybridized block holding one (run eagerly: one ``host_op_programs`` a
   call, no capture) and ``examples/numpy_ops_softmax.py``'s net through
   ``Module.fit``.  The op sweep of phase 21 holds the long tail's ops
   (spatial, linalg, SSD, R-CNN, contrib) card against CPU.
32. Sparse storage: (a) the CSR kernels (``ops/csrc/csr_dot.cu``:
   ``csr_dot``, ``csr_t_dot`` and the transposition by a stable radix
   sort) against their plain versions in fp32 and fp64, relative to each
   output's sum of |terms| (``CSR_TOL``), a second call bit for bit, on
   empty rows, nnz 0, a full row, the first and last columns and the
   path's shape (8192 rows of 16 zipf ids at K 1,000,001, N 1, 2, 8, 64),
   the transposition equal to a stable argsort; the path's shape timed
   (CUDA events, mean of 200) beside the plain versions, cuSPARSE
   (``torch.sparse.mm``) and the bound; ``csr_dot`` bit for bit against
   its plain version on the CPU over rows of 0, 1, 15, 16, 17, 33 and 100
   entries at N 1, 2, 8, 33, every kernel over capacity-padded parts bit
   for bit against unpadded ones, and ``csr_dot`` timed at the FM's
   shapes too; with the kernels' counts then set
   to 0, (b) ``examples/sparse_linear_classification.py``'s model at
   avazu-app's 1,000,001 features through ``Module``, batch 8192, SGD lr
   0.5, 3 epochs of 65,536 synthetic LibSVM lines read by
   ``LibSVMIter`` (``rescale_grad`` 1: ``SPARSE_OPT``), without a store
   and with ``kv.create("local")`` and
   ``row_sparse_pull`` (the loss must fall, accuracy above 0.5, no dense
   view built, peak memory under 1 GB, each step one replay of the
   executor's captured ``forward_backward``, one capture in all, so one
   ``csr_dot`` and one ``csr_t_dot`` a step and ``WARMUP_RUNS`` more; the
   first 24 steps bit for bit those under ``capture.eager()``; ms/step,
   samples/s, busy share), then 3 fp64 steps card against ``cpu()``
   (``SPARSE_PARITY_TOL``); (c) ``examples/factorization_machine.py``'s FM
   through ``_fit_step`` at its settings (last loss below half the first,
   accuracy above 0.8, one replay a step and one capture,
   ``sparse_eager_steps`` 0, 24 steps bit for bit the eager ones); (d)
   ``nd.save`` of both sparse types on the card byte for byte the CPU's,
   and a pickled CSR restored dense with its tag.
33. The Executor's programs (ROADMAP A.1): ``forward``, ``forward`` then
   ``backward`` and ``forward_backward`` (ones or given output
   gradients) in turns, captured against ``capture.eager()``: the MNIST
   MLP bit for bit with ``grad_req`` write and add, ResNet-50 at batch 2
   in fp64 to ``RESNET_PARITY_TOL``, one replay a forward and a backward;
   then ResNet-50 and Inception-v3 at batch 32 in fp32 timed through
   their executors, captured and eager, with each mode's peak memory.
34. The API surface (ROADMAP A.4, ``Monitor``, ``FeedForward``), with the
   hand kernels' counts set to 0 first: (a) ResNet-50 through
   ``Module.fit`` at batch 32 in fp32 (TF32 off, cuDNN deterministic)
   for 8 batches under a ``Monitor`` arming every 4th for the conv and
   FC outputs: the armed batches run node by node (no replay), the
   others replay the executor's ``forward_backward`` (one capture in
   all), no ``CachedTrainStep``; each row equal to ``mean(|x|)`` of an
   eager recompute (``API_ROW_RTOL``); the parameters held to the same
   loop unmonitored, bit for bit, else to ``RESNET_PARITY_TOL``; ms of
   the armed, unarmed and unmonitored batches; (b) ``FeedForward`` on the card's default
   context over phase 7's MLP (the scale kernel): fit, predict, score
   bit for bit ``Module.fit``'s, ``save``/``load`` the same predictions,
   the kernel's launches counted, and ``Module.fit`` under a monitor
   launching it once an armed batch; (c) a gradient penalty
   (``autograd.grad(create_graph=True)``) through a hybridized Dense
   stack against the block not hybridized and against the CPU
   (``API_PENALTY_TOL``, one ``create_graph_recomputes``), with a
   ``Dropout`` against the block run eagerly from the same generator
   state (the recompute draws the replay's mask), the same through
   ``dot`` of a CSR (the kernels run again; ``CSR_TOL`` of each
   array's largest value), and
   ``FlashAttention`` refusing ``create_graph``; (d) ``Orthogonal``,
   ``MSRAPrelu``, ``Bilinear`` and ``Mixed`` on the card bit for bit the
   CPU's; (e) ``get_symbol`` bound on the card bit for bit the recorded
   outputs, ``Symbol.eval`` on the card by default, ``zero_grad`` with
   ``grad_req="add"``, ``reset_ctx`` to the CPU and back (one capture
   anew), ``cpu_pinned`` arrays page-locked, and a host write straight
   after a copy to the card not reaching the copy.
35. The Module family, the predict API and JPEG on the card (ROADMAP
   A.6, A.5): (a) ResNet-50 as a ``SequentialModule`` (the zoo model's
   ``features``, then its classifier with ``SoftmaxOutput``) at batch 32
   fp32 for ``MF_STEPS`` steps against the single Module's one-call step
   from the same parameters (bit for bit, else ``RESNET_PARITY_TOL``; 4
   replays a step), then 3 fp64 steps card against ``cpu()``; (b) the
   body and classifier ending in a ``PythonLossModule`` (the reference
   test's softmax gradient), fp64 card against ``cpu()``; (c)
   ``Predictor.load`` of a ResNet-50 checkpoint at batch 32 and 1, bit
   for bit ``Module.forward(is_train=False)``, one capture a shape;
   (d) nvJPEG's ``imdecode`` (flags 1, 0, -1, grey JPEGs), ``ImageIter``
   over a ``.rec`` and a ``.lst`` (labels and order exact, pixels within
   ``LIBJPEG_FULL_ERR`` x ``NVJPEG_MARGIN`` of the same augmenters on the
   images), ``ImageDetIter`` at 300 x 300 into ``MultiBoxTarget`` and
   ``MultiBoxDetection`` (the NMS kernel), an ``ImageRecordDataset`` in a
   ``DataLoader``'s worker thread, refused bytes; (e) ``state_names`` in a
   ``Module`` and a ``BucketingModule``.
36. The parallel tier (ROADMAP A.8, first part): ``PAR_WORLD`` ranks, each
   a process on the card, in a gloo group (``test_utils.RankPool``; NCCL
   refuses two ranks on one device), GPT-2 small at 8 x 1024 tokens in
   fp32 (TF32 off) from one seeded init: (a) ``data 2 x model 2``, 3
   ``make_train_step`` steps against the one-card captured step, each
   rank's flash kernels on its 6 heads counted; (b) ``seq 2 x model 2``
   (ring attention), the forward's logits and one step, its P2P
   exchanges; (c) ``data 4``, 3 ``make_train_step_zero1`` steps against
   the one-card step, the momentum bytes a rank against
   ``zero.state_bytes``, the update bit for bit on one reduced gradient;
   (d) ``moe_ffn`` (8 experts over ``model 4``) and ``pipeline_apply``
   (four GPT-2-width MLP blocks over ``pipe 4``, 8 microbatches) against
   one card.  ms/step is of ranks that share one card, every collective
   through the host (``collective_host_staged``).

It prints the ResNet-50 numbers (Module and Gluon, captured and eager,
and phases 17's and 18's checks) as one ``{"resnet50": {...}}``
line, phase 19's as one ``{"checkpoint": {...}}`` line, phase 20's as
one ``{"zoo": {...}}`` line, phase 21's as one ``{"ops": {"held": n,
"worst": [...]}}`` line, phases 22-25's as one ``{"rnn": {...}}`` line,
phases 26-28's as one ``{"data": {...}}`` line, phase 29's as one
``{"cv2_resize": {...}}`` line, phase 30's as one ``{"kvstore": {...}}``
line, phase 31's as one ``{"long_tail": {...}}`` line, phase 32's as
one ``{"sparse": {...}, "sparse_kernels": {...}}`` line, phase 33's as
one ``{"executor": {...}}`` line, phase 34's as one ``{"api_surface":
{...}}`` line, phase 35's as one ``{"module_family": {...}}`` line,
phase 36's as one ``{"parallel": {...}}`` line, the
LM training numbers as one ``{"lm_train": {...}}`` line, the D-32 LM's as
one ``{"lm_d32": {...}}`` line and one ``{"kernels": [...]}`` line, then
as its last line
``{"ok": true, "device": {...}}``.  Without a card, or without the rest
of the repository beside it, it exits non-zero before printing either.
"""
from __future__ import annotations

import contextlib
import gc
import itertools
import json
import math
import os
import subprocess
import time

import numpy as np
import torch

# atol per dtype.  fp32: the kernel and the plain version both sum in fp32,
# in other orders, over at most 1024 keys.  bf16/fp16: the plain version
# keeps the probabilities P in fp32 and rounds once, at the output; the
# tensor-core kernel also rounds P to the input type before P@V (the form
# wgmma takes), so an output may differ by the two roundings together, a
# unit or two in the last place of outputs of magnitude below 4.  Measured
# on the H100 (PR 3): worst bf16 0.015625, one bf16 ulp at |o| in [2, 4);
# worst fp16 0.00195, one fp16 ulp there.
ATOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2, torch.float16: 4e-3}
# The atol is set by the early causal rows, where |o| reaches about 4; near
# row 1000 of MAIN_SHAPE |o| is about 0.05, so a kernel wrong only in late
# key tiles could stay under it.  So each row's max|err| is also held
# against that row's largest |ref|.  bf16/fp16: 4 units of roundoff u of
# the type (u = 2^-8 and 2^-11): the two output roundings differ by at most
# one ulp, at most 2u of the row's largest value, and P's rounding (u per
# probability, of no common sign) adds about u more.  fp32: 2^-16, far
# above the few 2^-24 of the summation orders and of expf.
ROW_RTOL = {torch.float32: 2.0 ** -16, torch.bfloat16: 2.0 ** -6,
            torch.float16: 2.0 ** -9}
DTYPE_NAME = {torch.float32: "fp32", torch.bfloat16: "bf16",
              torch.float16: "fp16"}
# H100 SXM published peaks (NVIDIA data sheet, dense): HBM bytes/s, and
# FLOP/s per input type (fp32 outside the tensor cores)
HBM_BPS = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12,
              torch.float16: 989e12}
MAIN_SHAPE = (8, 12, 1024, 64)
FLASH_CASES = [  # (shape, causal, sm_scale)
    ((2, 3, 64, 16), False, None), ((2, 3, 64, 16), True, None),
    ((1, 2, 48, 16), True, None), ((1, 2, 48, 16), False, None),
    ((1, 1, 16, 16), False, 0.5), ((2, 2, 77, 32), True, None),
    ((2, 4, 200, 64), False, None), ((2, 4, 200, 64), True, 0.5),
    ((1, 3, 130, 128), True, None), ((1, 3, 130, 128), False, None),
    ((1, 1, 1, 64), True, None), (MAIN_SHAPE, True, None),
]
# The D-32 LM's layer shape (phase 14: B 8, 8 heads, S 2048).
D32_SHAPE = (8, 8, 2048, 32)
# D 32 and 16, where the tiles are rows of 64 and 32 bytes in their own
# swizzles: the sharp case, ragged S, long S and D32_SHAPE.  Their inputs
# come from a generator of their own (``_narrow_gen``), so the cases above
# keep the inputs they had before these were added.
NARROW_CASES = [
    ((2, 4, 200, 32), True, 0.5), ((1, 3, 130, 16), True, None),
    ((1, 3, 130, 16), False, None), ((2, 4, 1024, 32), True, None),
    ((2, 4, 1024, 16), True, None), (D32_SHAPE, True, None),
]
FLASH_CASES += NARROW_CASES
GPT2_SMALL = dict(vocab=50257, d_model=768, n_heads=12, d_ff=3072,
                  n_layers=12, max_len=1024)
LM_BATCH, LM_SEQ, LM_REQUESTS = 8, 1024, 4
SCALE_SHAPES = [(0,), (1,), (7,), (64, 128), (1000003,), (8192, 8192)]
# the last two are not exact in fp32: the kernel gets alpha as a C float,
# the plain version multiplies by a Python float, and both must round it
# to fp32 once before the one multiply
SCALE_ALPHAS = (0.5, 3.0, -1.25, 0.1, 1.0 / 3.0)
SCALE_MAIN_SHAPE = (8192, 8192)
MLP_BATCH, MLP_STEPS, MLP_EVAL_BATCHES, MLP_PARITY_STEPS = 64, 64, 16, 10
MLP_LR, MLP_MOMENTUM, MLP_ALPHA = 0.1, 0.9, 0.5
# Test accuracy of the JAX package after the same 64 steps on the CPU,
# measured by tests/test_torch_mlp_train.py::test_jax_reference_accuracy.
JAX_CPU_ACCURACY = 1.0
# Test accuracy of the JAX package's LeNet after one epoch of 2,048 synthetic
# digits through MNISTIter at batch 64 on the CPU, measured by
# tests/test_torch_data_train.py::test_lenet_one_epoch_accuracy_against_jax;
# phase 28 holds the card's LeNet to it less 0.02.
LENET_JAX_CPU_ACCURACY = 1.0


def log(*args):
    print(*args, flush=True)


# -- captured steps (mxnet_tpu_torch.capture) ---------------------------------
# On the card every training step of the port replays captured CUDA graphs;
# ``capture.eager()`` is the eager oracle.  The counters of a step:
STEP_COUNTERS = ("graph_captures", "graph_replays", "program_calls")
STEP_MODES = ("captured", "eager")


def counter_snapshot():
    from mxnet_tpu_torch import profiler
    return profiler.counters()


def counter_delta(before):
    """What the step counters moved since ``before``."""
    from mxnet_tpu_torch import profiler
    now = profiler.counters()
    return {k: now.get(k, 0) - before.get(k, 0) for k in STEP_COUNTERS}


def step_mode(mode):
    """The context a step runs in: captured (the default) or eager."""
    from mxnet_tpu_torch import capture
    return capture.eager() if mode == "eager" else contextlib.nullcontext()


def free_card():
    """Drop what nothing holds any more (a captured program and its memory
    pool can sit in a reference cycle), then return the cached blocks."""
    gc.collect()
    torch.cuda.empty_cache()


def expected_launches(n_layers, steps, captures):
    """A hand kernel's launches in ``steps`` LM train steps that captured
    ``captures`` programs: n_layers a step, replayed or eager, and
    n_layers in each warm-up run before a capture."""
    from mxnet_tpu_torch import capture
    return n_layers * (steps + capture.WARMUP_RUNS * captures)


# The fp32 kernels take each product as six bf16 products (attention.design:
# "wgmma+bf16x3"), so fp32 attention has two floors: the function's
# operations at the fp32 CUDA-core peak, and the split design's six bf16
# products per product at the bf16 tensor-core peak.
SPLIT_PRODUCTS = 6
# H100 SXM exponentials per second on the special-function units, as the
# FlashAttention-3 paper gives it (Shah et al. 2024): 3.9 T/s.
SFU_EXPS = 3.9e12


def _attention_bounds(shape, dtype, causal, n_tensors, flops_per_pair):
    """(bound ms, what bounds it, {floor name: ms}): the least time on the
    H100 for ``n_tensors`` [B, H, S, D] tensors read or written once over
    HBM, ``flops_per_pair`` * D FLOPs and one exponential per (query, key)
    pair that the mask keeps; each floor is the largest of its bytes,
    operations and exponentials times, and names it ("bytes",
    "operations", "exps").  fp32 has the two floors above ("fp32",
    "bf16x3") and states the lesser, so that no kernel reads over 100% of
    its bound; bf16 and fp16 have one, at the tensor cores' peak."""
    b, h, s, d = shape
    elem = torch.empty((), dtype=dtype).element_size()
    t_bytes = n_tensors * b * h * s * d * elem / HBM_BPS
    pairs = (s * (s + 1) // 2 if causal else s * s) * b * h
    ops = flops_per_pair * d * pairs
    t_exps = pairs / SFU_EXPS
    rates = {DTYPE_NAME[dtype]: PEAK_FLOPS[dtype]}
    if dtype == torch.float32:
        rates["bf16x3"] = PEAK_FLOPS[torch.bfloat16] / SPLIT_PRODUCTS
    floors = {}
    for name, rate in rates.items():
        times = {"bytes": t_bytes, "operations": ops / rate,
                 "exps": t_exps}
        by = max(times, key=times.get)
        floors[name] = (1e3 * times[by], by)
    ms, by = min(floors.values())
    return ms, by, {name: f[0] for name, f in floors.items()}


def attention_bound_ms(shape, dtype, causal):
    """Bounds of the attention forward (``_attention_bounds``): q, k, v
    read and o written once, 4*D FLOPs per kept (query, key) pair."""
    return _attention_bounds(shape, dtype, causal, 4, 4)


# About 50 ms at the H100's clock: longer than the host takes to queue
# the timed launches of any cuda_ms call here.
QUEUE_SLEEP_CYCLES = 100_000_000


def cuda_ms(fn, iters=20, warmup=3):
    """Mean device time of ``fn()`` over ``iters`` runs, by CUDA events.
    A sleep kernel holds the stream until the host has queued every timed
    launch, so the events time the device's work back to back and a slow
    host does not stretch a short kernel's reading."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(QUEUE_SLEEP_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this script needs a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    log("torch %s, CUDA %s, %d device(s), running on %s"
        % (torch.__version__, torch.version.cuda, torch.cuda.device_count(),
           torch.cuda.get_device_name(0)))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return card


def kernel_stems():
    """The stem of every CUDA source the port's wrappers launch."""
    import os
    from mxnet_tpu_torch.ops import attention as att
    from mxnet_tpu_torch.ops import image_nvjpeg as nj
    from mxnet_tpu_torch.ops import nms as nm
    from mxnet_tpu_torch.ops import scale as sc
    from mxnet_tpu_torch.ops import sparse_dot as sd
    sources = (list(att.KERNEL_SOURCES.values())
               + list(att.BACKWARD_SOURCES.values())
               + [sc.KERNEL_SOURCE, nj.KERNEL_SOURCE, nm.KERNEL_SOURCE,
                  sd.KERNEL_SOURCE])
    return sorted({os.path.splitext(os.path.basename(src))[0]
                   for src in sources})


def ptxas_summary(log):
    """One line per kernel of an ``nvcc -Xptxas -v`` report: the entry
    (mangled, less its anonymous-namespace prefix), registers, spills."""
    import re
    lines, entry = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            entry = re.sub(r"^_ZN\d+_GLOBAL__N__\w+?_cu_[0-9a-f]{8}\d*", "",
                           m.group(1))
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and entry is not None:
            spills = m.group(1)
        m = re.search(r"Used (\d+) registers", line)
        if m and entry is not None:
            lines.append("  %-60s %3s registers, %s bytes spilled"
                         % (entry, m.group(1), spills))
            entry = None
    return "\n".join(lines)


def phase_build():
    from mxnet_tpu_torch.ops import _build
    t0 = time.perf_counter()
    seconds = _build.build_all(kernel_stems())
    log("build: %s in %.1f s wall" % (seconds, time.perf_counter() - t0))
    for stem in seconds:
        log("ptxas (%s):\n%s"
            % (stem, ptxas_summary(_build.build_info(stem)["log"])))


def _qkv(shape, dtype, gen, strided=False):
    """q, k, v [B, H, S, D]: contiguous, or strided as the model's einsum
    makes them (a [B, S, H, D] buffer seen as [B, H, S, D], strides
    (S*H*D, D, H*D, 1))."""
    b, h, s, d = shape
    if strided:
        return [torch.randn((b, s, h, d), generator=gen, device="cuda")
                .to(dtype).transpose(1, 2) for _ in range(3)]
    return [torch.randn(shape, generator=gen, device="cuda").to(dtype)
            for _ in range(3)]


def _narrow_gen(seed):
    """The generator of ``NARROW_CASES``' inputs."""
    return torch.Generator(device="cuda").manual_seed(100 + seed)


def check_padded_head_dim(att, shape):
    """A head dim between the kernels' widths (``shape[-1]``, not in
    ``HEAD_DIMS``): forward and backward, each dtype, contiguous and
    strided, against the plain versions at ``ATOL``/``ROW_RTOL`` and
    ``BWD_ATOL``/``BWD_ROW_RTOL``, each backward repeated bit for bit;
    one forward and one backward launch per call."""
    gen = torch.Generator(device="cuda").manual_seed(7)
    d = shape[-1]
    if d in att.HEAD_DIMS:
        raise AssertionError("D %d is a kernel width" % d)
    for dtype, strided in itertools.product(DTYPE_NAME, (False, True)):
        q, k, v = _qkv(shape, dtype, gen, strided)
        do = _qkv(shape, dtype, gen, strided)[0]
        att.reset_launch_count()
        att.reset_backward_launch_count()
        out = att.flash_attention(q, k, v, True)
        got = att.flash_attention_backward(q, k, v, do, True)
        launches = (att.launch_count(), att.backward_launch_count())
        again = att.flash_attention_backward(q, k, v, do, True)
        ref = att.flash_attention_reference(q, k, v, True)
        diff = (out.float() - ref.float()).abs()
        err = diff.max().item()
        rel = (diff.amax(-1) / ref.float().abs().amax(-1)
               .clamp_min(1e-30)).max().item()
        berr, brels = _grad_errors(got, att.chunked_attention_grads(
            q, k, v, do, True))
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        log("  D %d padded to %d, %s %s: forward max|err| %.3g, row-relative "
            "%.3g; backward max|err| %.3g, row-relative %.3g, repeat equal "
            "%s; launches %s"
            % (d, att.kernel_width(d), DTYPE_NAME[dtype],
               "strided" if strided else "contiguous", err, rel, berr,
               max(brels), same, launches))
        shapes_ok = out.shape == q.shape and all(g.shape == q.shape
                                                 for g in got)
        if not (shapes_ok and same and launches == (1, 1)
                and err <= ATOL[dtype] and rel <= ROW_RTOL[dtype]
                and berr <= BWD_ATOL.get(dtype, math.inf)
                and max(brels) <= BWD_ROW_RTOL[dtype]):
            raise AssertionError("flash attention at D %d (padded) disagrees"
                                 " with its plain versions (%s, strided=%s)"
                                 % (d, DTYPE_NAME[dtype], strided))


def phase_kernels():
    """Kernel against plain version at every case, contiguous and strided;
    timings at MAIN_SHAPE.  Returns {dtype: {"max_abs_err", "max_row_rel",
    "ms", "strided_ms", "plain_ms", "library_ms", "design", "by_design",
    "by_dim"}}: the errors of the design MAIN_SHAPE takes, every design's
    and every head dim's."""
    from mxnet_tpu_torch import MXNetError
    from mxnet_tpu_torch.ops import attention as att
    cases = FLASH_CASES
    gen = torch.Generator(device="cuda").manual_seed(0)
    narrow = _narrow_gen(0)
    results = {}
    with torch.inference_mode():
        for dtype in (torch.float32, torch.bfloat16, torch.float16):
            worst = {}  # design -> [max|err|, row-relative]
            by_dim = {}  # head dim -> [max|err|, row-relative]
            for case, strided in itertools.product(cases, (False, True)):
                shape, causal, scale = case
                q, k, v = _qkv(shape, dtype,
                               narrow if case in NARROW_CASES else gen,
                               strided)
                out = att.flash_attention(q, k, v, causal, scale)
                ref = att.flash_attention_reference(q, k, v, causal, scale)
                torch.cuda.synchronize()
                if out.dtype != dtype or out.shape != q.shape:
                    raise AssertionError("kernel output %s %s at %s"
                                         % (out.dtype, tuple(out.shape), shape))
                if not torch.isfinite(out).all():
                    raise AssertionError("non-finite kernel output at %s %s"
                                         % (shape, dtype))
                diff = (out.float() - ref.float()).abs()
                err = diff.max().item()
                # each row's max|err| over that row's largest |ref|
                rel = (diff.amax(-1) / ref.float().abs().amax(-1)
                       .clamp_min(1e-30)).max().item()
                for w in (worst.setdefault(att.design(dtype, shape[-1]),
                                           [0.0, 0.0]),
                          by_dim.setdefault(shape[-1], [0.0, 0.0])):
                    w[0], w[1] = max(w[0], err), max(w[1], rel)
                log("  %s %-18s %-10s causal=%-5s scale=%-4s %-9s max|err| "
                    "%.3g, row-relative %.3g"
                    % (DTYPE_NAME[dtype], shape,
                       "strided" if strided else "contiguous", causal, scale,
                       att.design(dtype, shape[-1]), err, rel))
                if err > ATOL[dtype] or rel > ROW_RTOL[dtype]:
                    raise AssertionError(
                        "kernel disagrees with plain version at %s %s causal=%s"
                        " scale=%s strided=%s: max|err| %.3g (atol %g), "
                        "row-relative %.3g (limit %g)"
                        % (shape, dtype, causal, scale, strided, err,
                           ATOL[dtype], rel, ROW_RTOL[dtype]))
            q, k, v = _qkv(MAIN_SHAPE, dtype, gen)
            qs, ks, vs = _qkv(MAIN_SHAPE, dtype, gen, strided=True)
            fns = {
                "ms": lambda: att.flash_attention(q, k, v, True),
                "strided_ms": lambda: att.flash_attention(qs, ks, vs, True),
                "plain_ms": lambda: att.flash_attention_reference(
                    q, k, v, True),
                "library_ms":
                    lambda: torch.nn.functional.scaled_dot_product_attention(
                        q, k, v, is_causal=True),
            }
            # three rounds, each timing every function once; the median of
            # each function's three readings, so one slow reading (a clock
            # that has not ramped up yet) decides nothing
            rounds = [{n: cuda_ms(fn) for n, fn in fns.items()}
                      for _ in range(3)]
            timings = {n: sorted(r[n] for r in rounds)[1] for n in fns}
            design = att.design(dtype, MAIN_SHAPE[-1])
            results[dtype] = dict(
                max_abs_err=worst[design][0], max_row_rel=worst[design][1],
                design=design, by_design=worst, by_dim=by_dim, **timings)
            log("%s at %s causal (%s): kernel %.4f ms (strided %.4f ms), "
                "plain %.4f ms, SDPA %.4f ms, kernel/SDPA %.2f (medians of "
                "rounds %s), worst [max|err|, row-relative] by design %s "
                "(atol %g, limit %g) over %d cases"
                % (DTYPE_NAME[dtype], MAIN_SHAPE, design, timings["ms"],
                   timings["strided_ms"], timings["plain_ms"],
                   timings["library_ms"],
                   timings["ms"] / timings["library_ms"],
                   [{n: "%.4f" % t for n, t in r.items()} for r in rounds],
                   worst, ATOL[dtype], ROW_RTOL[dtype], 2 * len(cases)))
        # a head dim between the kernels' widths runs padded (D 48 at 64)
        q, k, v = _qkv((1, 2, 64, 64), torch.bfloat16, gen)
        check_padded_head_dim(att, (2, 3, 100, 48))
        # the wrapper refuses what the kernels do not take
        offset = torch.empty(q.numel() + 1, dtype=q.dtype,
                             device="cuda")[1:].view(q.shape)
        wide = _qkv((1, 2, 64, 160), torch.bfloat16, gen)
        for bad in (lambda: att.flash_attention(q.transpose(2, 3), k, v),
                    lambda: att.flash_attention(offset, k, v),
                    lambda: att.flash_attention(*wide),
                    lambda: att.flash_attention(q.double(), k.double(),
                                                v.double())):
            try:
                bad()
            except MXNetError:
                continue
            raise AssertionError("flash_attention accepted an input it "
                                 "does not take")
    return results


# Backward: the kernel's dq, dk, dv against chunked_attention_grads on the
# card.  Both compute in fp32 from the same loaded values and round once to
# the input type at the end; they differ in the order of their sums (over
# at most 1024 queries or keys) and in where the scale is applied.
# fp32: held at tests/test_pallas.py's gradient atol of 1e-4 (|grads| reach
# about 16 here).  Row by row, each row's max|err| over its largest |ref|
# is held at 2^-8: where one key takes nearly all of a query's
# probability (sm_scale 0.5 spreads the scores 4 times wider), ds =
# p (dp - sum(p dp)) cancels and dq's row is small against the terms it
# sums, so the two summation orders part by up to 7.1e-4 of it (measured
# on the H100 at (2, 4, 200, 64) causal, sm_scale 0.5, with max|err|
# 8.3e-6; 3e-6 or less elsewhere); 2^-8 is five times that and still far
# below the O(1) of a row that a kernel got wrong.
# bf16/fp16: each side's fp32 value rounds once to the type; values that
# differ by that fp32 noise round to the same value or to neighbours one
# ulp apart, and one ulp is at most 2u of the row's largest |ref| (u =
# 2^-8 and 2^-11): row-relative 2^-7 and 2^-10, plus the fp32 rows'
# 2^-8.  Measured: bf16 7.75e-3, fp16 9.7e-4, both at MAIN_SHAPE (the SIMT
# kernel that preceded the tensor-core ones).
# bf16/fp16 go through the tensor-core kernel, which also
# rounds P and dS to the input type where they enter a product (p, dp,
# delta and ds stay fp32).  A CPU model of those two roundings against
# chunked_attention_grads (tools/torch_flash_bwd_cpu_model.py) reads at
# most bf16 0.0094 and fp16 0.0029 at (2, 4, 200, 64) causal sm_scale 0.5
# and (1, 3, 130, 128) causal over ten numpy seeds, under the same limits.
# fp16 rows whose largest |ref| lies below fp16's smallest normal, 2^-14,
# hold subnormal outputs with fewer than 11 bits, so a row's denominator is
# floored at torch.finfo(dtype).tiny (2^-14 for fp16; 1.2e-38 for fp32 and
# bf16, which changes nothing for them).
# The sharp cases (sm_scale SHARP_SCALE) are not held row by row against
# the plain version: there both fp32 computations lie up to 0.90 of a row
# from the exact gradient while agreeing with each other, so which draws
# passed depended on the draw (tools/torch_flash_sharp_rows.py).
# Their rows are held to an fp64 reference instead, each row's error
# taken against the size of the terms it sums, at SHARP_ROW_C times the
# plain version's own error plus BWD_ROW_RTOL
# (mxnet_tpu_torch/test_utils.py::sharp_row_check, where the measure and
# SHARP_ROW_C are argued); the atol and the bitwise check stay.
BWD_ATOL = {torch.float32: 1e-4}
BWD_ROW_RTOL = {torch.float32: 2.0 ** -8,
                torch.bfloat16: 2.0 ** -7 + 2.0 ** -8,
                torch.float16: 2.0 ** -10 + 2.0 ** -8}
SHARP_SCALE = 0.5


BWD_DESIGN_NOTE = {
    "wgmma+tma": "wgmma+tma, two launches (row statistics + dq, dk + dv)",
    "wgmma+bf16x3": "wgmma+bf16x3, fp32 as three bf16 parts, six products "
                    "each, two launches (row statistics + dq, dk + dv)",
}


def attention_bwd_bound_ms(shape, dtype, causal):
    """Bounds of the attention backward (``_attention_bounds``): q, k, v,
    do read and dq, dk, dv written once; the gradient's five products,
    10*D FLOPs per kept (query, key) pair."""
    return _attention_bounds(shape, dtype, causal, 7, 10)


def _grad_errors(got, ref):
    """Largest |err| over dq, dk, dv, and the largest row-relative error of
    each; a row's denominator is its largest |ref|, floored at the smallest
    normal of the grads' dtype (see BWD_ROW_RTOL)."""
    worst, rels = 0.0, []
    for g, r in zip(got, ref):
        diff = (g.float() - r.float()).abs()
        worst = max(worst, diff.max().item())
        floor = torch.finfo(r.dtype).tiny
        rels.append((diff.amax(-1) / r.float().abs().amax(-1)
                     .clamp_min(floor)).max().item())
    return worst, rels


def sdpa_backward_ms(q, k, v, do):
    """SDPA's backward alone, as a yardstick: the time of its forward and
    ``torch.autograd.grad`` together, less its forward's.  The port never
    calls SDPA."""
    F = torch.nn.functional
    qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))

    def both():
        out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True)
        torch.autograd.grad(out, (qg, kg, vg), do)

    def fwd():
        with torch.no_grad():
            F.scaled_dot_product_attention(qg, kg, vg, is_causal=True)
    return cuda_ms(both) - cuda_ms(fwd)


def phase_kernels_bwd():
    """The backward kernel that ``design_backward`` picks against its plain
    version at every flash case and dtype, q/k/v contiguous and as einsum
    views (do then strided too), and two calls on the same inputs bit for
    bit; timings at MAIN_SHAPE.  Returns {dtype:
    {"max_abs_err", "max_row_rel", "ms", "strided_ms", "plain_ms",
    "library_ms", "design", "by_design", "by_dim"}}, as ``phase_kernels``
    does."""
    from mxnet_tpu_torch import MXNetError
    from mxnet_tpu_torch.ops import attention as att
    from mxnet_tpu_torch.test_utils import (attention_grads_fp64,
                                            sharp_row_check)
    gen = torch.Generator(device="cuda").manual_seed(1)
    narrow = _narrow_gen(1)
    results = {}
    with torch.no_grad():
        for dtype in (torch.float32, torch.bfloat16, torch.float16):
            worst = {}  # design -> [max|err|, row-relative]
            by_dim = {}  # head dim -> [max|err|, row-relative]
            for case, strided in itertools.product(FLASH_CASES,
                                                   (False, True)):
                shape, causal, scale = case
                g = narrow if case in NARROW_CASES else gen
                q, k, v = _qkv(shape, dtype, g, strided)
                do = _qkv(shape, dtype, g, strided)[0]
                got = att.flash_attention_backward(q, k, v, do, causal, scale)
                ref = att.chunked_attention_grads(q, k, v, do, causal, scale)
                again = att.flash_attention_backward(q, k, v, do, causal,
                                                     scale)
                if not all(torch.equal(a, g) for a, g in zip(again, got)):
                    raise AssertionError(
                        "two backward calls on the same inputs differ at "
                        "%s %s causal=%s scale=%s strided=%s"
                        % (shape, dtype, causal, scale, strided))
                torch.cuda.synchronize()
                for g in got:
                    if g.dtype != dtype or g.shape != q.shape:
                        raise AssertionError("backward output %s %s at %s"
                                             % (g.dtype, tuple(g.shape),
                                                shape))
                    if not torch.isfinite(g).all():
                        raise AssertionError("non-finite backward output at "
                                             "%s %s" % (shape, dtype))
                err, rels = _grad_errors(got, ref)
                rel = max(rels)
                sharp = None
                if scale == SHARP_SCALE:
                    sharp = sharp_row_check(
                        got, ref, *attention_grads_fp64(q, k, v, do, causal,
                                                        scale),
                        BWD_ROW_RTOL[dtype])
                for w in (worst.setdefault(
                        att.design_backward(dtype, shape[-1]), [0.0, 0.0]),
                          by_dim.setdefault(shape[-1], [0.0, 0.0])):
                    w[0], w[1] = max(w[0], err), max(w[1], rel)
                log("  bwd %s %-18s %-10s causal=%-5s scale=%-4s %-9s max|err| "
                    "%.3g, row-relative %.3g (dq %.3g, dk %.3g, dv %.3g)%s"
                    % (DTYPE_NAME[dtype], shape,
                       "strided" if strided else "contiguous", causal, scale,
                       att.design_backward(dtype, shape[-1]), err, rel, *rels,
                       "" if sharp is None else
                       "; from fp64 against the terms: kernel %.3g, plain "
                       "%.3g, worst row at %.3g of its limit"
                       % (sharp["kernel"],
                                              sharp["plain"],
                                              sharp["worst"])))
                if sharp is not None:
                    row_bad = not sharp["ok"]
                else:
                    row_bad = rel > BWD_ROW_RTOL[dtype]
                if err > BWD_ATOL.get(dtype, math.inf) or row_bad:
                    raise AssertionError(
                        "backward kernel disagrees with plain version at %s "
                        "%s causal=%s scale=%s strided=%s: max|err| %.3g "
                        "(atol %g), row-relative %.3g (limit %g), sharp-row "
                        "check against fp64 %s"
                        % (shape, dtype, causal, scale, strided, err,
                           BWD_ATOL.get(dtype, math.inf), rel,
                           BWD_ROW_RTOL[dtype], sharp))
            q, k, v = _qkv(MAIN_SHAPE, dtype, gen)
            do = _qkv(MAIN_SHAPE, dtype, gen)[0]
            qs, ks, vs = _qkv(MAIN_SHAPE, dtype, gen, strided=True)
            fns = {
                "ms": lambda: att.flash_attention_backward(q, k, v, do, True),
                "strided_ms": lambda: att.flash_attention_backward(
                    qs, ks, vs, do, True),
                "plain_ms": lambda: att.chunked_attention_grads(
                    q, k, v, do, True),
            }
            rounds = [{n: cuda_ms(fn, iters=10) for n, fn in fns.items()}
                      for _ in range(3)]
            with torch.enable_grad():
                lib = sorted(sdpa_backward_ms(q, k, v, do)
                             for _ in range(3))
            timings = {n: sorted(r[n] for r in rounds)[1] for n in fns}
            timings["library_ms"] = lib[1]
            bound, bound_by, _ = attention_bwd_bound_ms(MAIN_SHAPE, dtype,
                                                        True)
            design = att.design_backward(dtype, MAIN_SHAPE[-1])
            results[dtype] = dict(
                max_abs_err=worst[design][0], max_row_rel=worst[design][1],
                design=design, by_design=worst, by_dim=by_dim, **timings)
            log("bwd %s at %s causal (%s): kernel %.4f ms (strided %.4f ms), "
                "plain %.4f ms, SDPA backward %.4f ms (readings %s), "
                "kernel/SDPA %.2f, bound %.4f ms (%s) (medians of rounds "
                "%s), worst [max|err|, row-relative] by design %s (atol %s, "
                "limit %g) over %d cases"
                % (DTYPE_NAME[dtype], MAIN_SHAPE, design, timings["ms"],
                   timings["strided_ms"], timings["plain_ms"],
                   timings["library_ms"], ["%.4f" % t for t in lib],
                   timings["ms"] / timings["library_ms"], bound, bound_by,
                   [{n: "%.4f" % t for n, t in r.items()} for r in rounds],
                   worst, BWD_ATOL.get(dtype, "-"), BWD_ROW_RTOL[dtype],
                   2 * len(FLASH_CASES)))
            del q, k, v, do, qs, ks, vs
        # the wrapper refuses what the kernels do not take
        q, k, v = _qkv((1, 2, 64, 64), torch.bfloat16, gen)
        for bad in (lambda: att.flash_attention_backward(q.transpose(2, 3),
                                                         k, v, q),
                    lambda: att.flash_attention_backward(q, k, v, q[:, :1]),
                    lambda: att.flash_attention_backward(
                        q.double(), k.double(), v.double(), q.double()),
                    lambda: att.flash_attention_backward(
                        *_qkv((1, 2, 64, 160), torch.bfloat16, gen, False),
                        _qkv((1, 2, 64, 160), torch.bfloat16, gen)[0]),
                    lambda: att.flash_attention_backward(q, k, v, q.cpu())):
            try:
                bad()
            except MXNetError:
                continue
            raise AssertionError("flash_attention_backward accepted an input "
                                 "it does not take")
    torch.cuda.empty_cache()
    return results


def phase_lm(dtype):
    """GPT-2-small-width LM inference; returns the kernel launch count of
    the scored run."""
    from mxnet_tpu_torch.models import transformer as tr
    from mxnet_tpu_torch.ops import attention as att
    cfg = tr.TransformerLMConfig(dtype=dtype, **GPT2_SMALL)
    gen = torch.Generator(device="cuda").manual_seed(0)
    model = tr.TransformerLM(cfg, tr.init_transformer_params(gen, cfg))
    n_params = sum(p.numel() for p in model.parameters())
    seqs = [torch.randint(0, cfg.vocab, (LM_BATCH, LM_SEQ + 1),
                          generator=gen, device="cuda")
            for _ in range(LM_REQUESTS)]
    with torch.inference_mode():
        # warm-up: cuBLAS handles, workspaces, the allocator's logits blocks
        tr.nll_from_logits(model(seqs[0][:, :-1]), seqs[0][:, 1:])
        torch.cuda.synchronize()
        att.reset_launch_count()
        times, nlls = [], []
        for seq in seqs:
            tokens, labels = seq[:, :-1], seq[:, 1:]
            t0 = time.perf_counter()
            logits = model(tokens)
            nll = tr.nll_from_logits(logits, labels)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            if logits.shape != (LM_BATCH, LM_SEQ, cfg.vocab):
                raise AssertionError("logits shape %s" % (tuple(logits.shape),))
            if not torch.isfinite(logits).all():
                raise AssertionError("non-finite logits (%s)" % dtype)
            nlls.append(nll.item())
        launches = att.launch_count()
    if not all(math.isfinite(x) for x in nlls):
        raise AssertionError("non-finite NLL %s" % nlls)
    want = cfg.n_layers * LM_REQUESTS
    if launches != want:
        raise AssertionError("flash_attention launched %d times, expected "
                             "n_layers x forwards = %d" % (launches, want))
    ms = 1e3 * sorted(times)[len(times) // 2]
    log("LM %s (%.1f M params, %d layers): %d batches of %dx%d, ms/batch %s"
        " median %.3f, tokens/s %.1f, NLL %s, %s kernel launches %d"
        % (DTYPE_NAME[dtype], n_params / 1e6, cfg.n_layers, LM_REQUESTS,
           LM_BATCH, LM_SEQ, ["%.3f" % (1e3 * t) for t in times], ms,
           LM_BATCH * LM_SEQ / (ms / 1e3), ["%.4f" % x for x in nlls],
           att.design(dtype, cfg.d_model // cfg.n_heads), launches))
    del model, seqs, logits
    torch.cuda.empty_cache()
    return launches


# Card against CPU, small LM (2 layers, S = 200), from each of PARITY_SEEDS:
# logits max|err| and NLL diff.  fp32: sums over d_model/d_ff in cuBLAS's
# order against the CPU's.  bf16: both sides round every activation to
# bf16, at places that differ (cuBLAS and the CPU round a matmul's fp32 sum
# once, but the kernel also rounds P to bf16 before P@V where the plain
# version keeps it in fp32), so a logit of magnitude about 4 may differ by a
# few of its 2^-6 ulps: the logits limit is 0.125, about three times the
# 0.039 measured on the H100 (PR 3).  The NLL averages 400 tokens' errors,
# which have no common sign: a few 1e-2 over sqrt(400) is about 5e-4, and
# the limit is about four times that.
PARITY_SEEDS = (1, 2, 3)
PARITY_TOL = {torch.float32: dict(logits=1e-3, nll=1e-4),
              torch.bfloat16: dict(logits=0.125, nll=2e-3)}


def phase_parity(dtype, seed):
    """Small LM on the card (kernel) against the CPU (plain version)."""
    from mxnet_tpu_torch.models import transformer as tr
    cfg = tr.TransformerLMConfig(vocab=512, d_model=128, n_heads=2, d_ff=256,
                                 n_layers=2, max_len=256, dtype=dtype)
    gen = torch.Generator().manual_seed(seed)
    cpu_params = tr.init_transformer_params(gen, cfg, device="cpu")
    cuda_params = {n: t.to("cuda") for n, t in cpu_params.items()}
    seq = torch.randint(0, cfg.vocab, (2, 201), generator=gen)
    tokens, labels = seq[:, :-1], seq[:, 1:]
    from mxnet_tpu_torch.ops import attention as att
    att.reset_launch_count()
    with torch.inference_mode():
        ref = tr.transformer_forward(cpu_params, tokens, cfg)
        out = tr.transformer_forward(cuda_params, tokens.cuda(), cfg).cpu()
        nll_ref = tr.nll_from_logits(ref, labels).item()
        nll_out = tr.nll_from_logits(out, labels).item()
    err = (out.float() - ref.float()).abs().max().item()
    tol = PARITY_TOL[dtype]
    log("parity (%s, seed %d, S=200, %s kernel, %d launches): logits "
        "max|err| %.3g (limit %g), NLL cuda %.6f cpu %.6f, |diff| %.3g "
        "(limit %g)"
        % (DTYPE_NAME[dtype], seed,
           att.design(dtype, cfg.d_model // cfg.n_heads), att.launch_count(),
           err, tol["logits"], nll_out, nll_ref, abs(nll_out - nll_ref),
           tol["nll"]))
    if att.launch_count() != cfg.n_layers:
        raise AssertionError("the card's forward launched %d kernels, not %d"
                             % (att.launch_count(), cfg.n_layers))
    if err > tol["logits"] or abs(nll_out - nll_ref) > tol["nll"]:
        raise AssertionError("LM on the card disagrees with the CPU (%s, "
                             "seed %d)" % (DTYPE_NAME[dtype], seed))


# -- LM training (make_train_step, make_train_step_zero1) --------------------
LM_TRAIN_WARMUP, LM_TRAIN_STEPS, LM_TRAIN_LR, LM_TRAIN_MOMENTUM = 5, 10, 0.1, 0.9
LM_TRAIN_DTYPES = (torch.float32, torch.bfloat16, torch.float16)
# Small LM trained on the card (through both kernels) and on the CPU
# (through the plain versions) from one init: D = 64, so bf16 takes the
# wgmma+tma forward; S = 200 is ragged against the kernels' 64-row tiles.
LM_TRAIN_PARITY = dict(vocab=256, d_model=128, n_heads=2, d_ff=512,
                       n_layers=2, max_len=256)
LM_TRAIN_PARITY_BATCH, LM_TRAIN_PARITY_SEQ, LM_TRAIN_PARITY_STEPS = 2, 200, 3
LM_TRAIN_PARITY_SEED = 4


def lm_train_parity_init(seed=LM_TRAIN_PARITY_SEED, config=LM_TRAIN_PARITY):
    """The parity LM's fp32 params and its batch, on the CPU."""
    from mxnet_tpu_torch.models import transformer as tr
    cfg = tr.TransformerLMConfig(**config)
    gen = torch.Generator().manual_seed(seed)
    params = tr.init_transformer_params(gen, cfg, device="cpu")
    seq = torch.randint(0, cfg.vocab, (LM_TRAIN_PARITY_BATCH,
                                       LM_TRAIN_PARITY_SEQ + 1),
                        generator=gen)
    return params, seq[:, :-1], seq[:, 1:]


def lm_train_run(device, dtype, builder, params, tokens, labels,
                 steps=LM_TRAIN_PARITY_STEPS, config=LM_TRAIN_PARITY):
    """``steps`` steps of the parity LM (or ``config``) on ``device`` in
    ``dtype`` from ``params`` (cast and copied) through ``builder``
    ("plain": ``make_train_step``, "zero1": ``make_train_step_zero1``);
    returns one {"loss", "params", "momenta"} per step, fp64 CPU copies."""
    from mxnet_tpu_torch.models import transformer as tr
    cfg = tr.TransformerLMConfig(dtype=dtype, **config)
    # copies: the steps update the params in place
    ps = {n: t.to(device=device, dtype=dtype, copy=True)
          for n, t in params.items()}
    tokens, labels = tr.place_batch(tokens, labels, device)
    if builder == "plain":
        step = tr.make_train_step(cfg, lr=LM_TRAIN_LR, device=device)
        momenta = {}
    else:
        step, momenta = tr.make_train_step_zero1(
            cfg, ps, lr=LM_TRAIN_LR, momentum=LM_TRAIN_MOMENTUM)
    out = []
    for _ in range(steps):
        if builder == "plain":
            ps, loss = step(ps, tokens, labels)
        else:
            ps, momenta, loss = step(ps, momenta, tokens, labels)
        out.append({"loss": loss.item(),
                    "params": {n: t.to("cpu", torch.float64, copy=True)
                               for n, t in ps.items()},
                    "momenta": {n: t.to("cpu", torch.float64, copy=True)
                                for n, t in momenta.items()}})
    return out


def lm_train_diffs(a, b):
    """Per step: |loss difference|, and the largest |difference| of the
    params and of the momenta, between two runs of ``lm_train_run``."""
    def largest(x, y):
        return max(((x[n] - y[n]).abs().max().item() for n in x),
                   default=0.0)
    return [{"loss": abs(sa["loss"] - sb["loss"]),
             "params": largest(sa["params"], sb["params"]),
             "momenta": largest(sa["momenta"], sb["momenta"])}
            for sa, sb in zip(a, b)]


# Card against CPU, the parity LM, 3 steps of each step builder.  On the
# CPU, before any card run (tools/torch_lm_cpu_spread.py), the port's
# runs lie from its fp64 run by at most: fp32 params 1.5e-7, momenta
# 5.3e-8, loss 0 (the loss is fp32 in both); bf16 params 8.9e-3 (about an
# ulp at |p| near 1), momenta 1.8e-3, loss 2.2e-2 (bf16 logits).  A card
# run as accurate as the CPU's lies as far from fp64, so the two lie at
# most twice that apart; the card also differs by its kernels' own
# roundings (the fp32 forward is within 3e-6 of its plain version at
# phase 3's shapes; the bf16 tensor-core forward rounds P to bf16 before
# P@V).  Limits: fp32 params 1e-6, momenta 5e-7, loss 4e-6 (8 ulps of a
# loss near 5.3); bf16 params 2^-5 (4 ulps at |p| in [1, 2)), momenta
# 8e-3, loss 0.1, about 4 times the spread.
LM_TRAIN_PARITY_TOL = {
    torch.float32: dict(loss=4e-6, params=1e-6, momenta=5e-7),
    torch.bfloat16: dict(loss=0.1, params=2.0 ** -5, momenta=8e-3),
}


def phase_lm_train_parity(dtype):
    """The parity LM trained on the card (kernels) and on the CPU (plain
    versions) from one init, 3 steps of each step builder; the loss, the
    params and the momenta held after each step.  Returns the worst
    differences by builder and the card's (forward, backward) launches."""
    from mxnet_tpu_torch.ops import attention as att
    flags = tf32_flags() if dtype == torch.float32 else DTYPE_NAME[dtype]
    params, tokens, labels = lm_train_parity_init()
    tol = LM_TRAIN_PARITY_TOL[dtype]
    n_layers = LM_TRAIN_PARITY["n_layers"]
    worst, totals = {}, [0, 0]
    for builder in ("plain", "zero1"):
        cpu = lm_train_run("cpu", dtype, builder, params, tokens, labels)
        att.reset_launch_count()
        att.reset_backward_launch_count()
        before = counter_snapshot()
        card = lm_train_run("cuda", dtype, builder, params, tokens, labels)
        steps = counter_delta(before)
        launches = (att.launch_count(), att.backward_launch_count())
        if steps["graph_captures"] != 1 \
                or steps["graph_replays"] != LM_TRAIN_PARITY_STEPS:
            raise AssertionError("LM train parity on the card did not "
                                 "replay one captured step a step: %s"
                                 % steps)
        want = expected_launches(n_layers, LM_TRAIN_PARITY_STEPS, 1)
        diffs = lm_train_diffs(card, cpu)
        for i, d in enumerate(diffs):
            log("LM train parity (%s, %s, S=%d, step %d): loss card %.6f cpu "
                "%.6f, |diff| %.3g (limit %g); params max|diff| %.3g (limit "
                "%g); momenta max|diff| %.3g (limit %g)"
                % (flags, builder, LM_TRAIN_PARITY_SEQ, i + 1,
                   card[i]["loss"], cpu[i]["loss"], d["loss"], tol["loss"],
                   d["params"], tol["params"], d["momenta"],
                   tol["momenta"]))
        if launches != (want, want):
            raise AssertionError("LM train parity on the card launched %s "
                                 "(forward, backward) kernels, not %d each"
                                 % (launches, want))
        bad = [(i + 1, k) for i, d in enumerate(diffs) for k in d
               if d[k] > tol[k]]
        if bad:
            raise AssertionError("LM training on the card disagrees with the "
                                 "CPU (%s, %s) at (step, quantity) %s"
                                 % (DTYPE_NAME[dtype], builder, bad))
        worst[builder] = {k: max(d[k] for d in diffs) for k in diffs[0]}
        totals = [t + n for t, n in zip(totals, launches)]
    torch.cuda.empty_cache()
    return worst, tuple(totals)


# The D-32 parity LM (phase 13): the parity LM with 4 heads, so D = 32, the
# width of the Pythia-31M LM of phase 14.
LM_D32 = dict(LM_TRAIN_PARITY, n_heads=4)


def phase_lm_d32_parity(dtype):
    """The D-32 parity LM on the card (kernels) against the CPU (plain
    versions) in ``dtype`` (fp32 with TF32 off, or bf16): scored once
    (``PARITY_TOL``), then 3 steps of ``make_train_step``
    (``LM_TRAIN_PARITY_TOL``).  Returns the card's (forward, backward)
    kernel launches."""
    from mxnet_tpu_torch.models import transformer as tr
    from mxnet_tpu_torch.ops import attention as att
    flags = tf32_flags() if dtype == torch.float32 else DTYPE_NAME[dtype]
    cfg = tr.TransformerLMConfig(dtype=dtype, **LM_D32)
    head_dim = cfg.d_model // cfg.n_heads
    design = att.design(dtype, head_dim)
    if head_dim != 32 or design not in ("wgmma+tma", "wgmma+bf16x3"):
        raise AssertionError("D %d takes %s" % (head_dim, design))
    params, tokens, labels = lm_train_parity_init(config=LM_D32)
    params = {n: t.to(dtype) for n, t in params.items()}
    att.reset_launch_count()
    with torch.inference_mode():
        ref = tr.transformer_forward(params, tokens, cfg)
        out = tr.transformer_forward({n: t.to("cuda") for n, t in
                                      params.items()}, tokens.cuda(),
                                     cfg).cpu()
        nll_diff = abs(tr.nll_from_logits(out, labels).item()
                       - tr.nll_from_logits(ref, labels).item())
    scored = att.launch_count()
    err = (out.float() - ref.float()).abs().max().item()
    cpu = lm_train_run("cpu", dtype, "plain", params, tokens, labels,
                       config=LM_D32)
    att.reset_launch_count()
    att.reset_backward_launch_count()
    before = counter_snapshot()
    card = lm_train_run("cuda", dtype, "plain", params, tokens, labels,
                        config=LM_D32)
    captures = counter_delta(before)["graph_captures"]
    launches = (scored + att.launch_count(), att.backward_launch_count())
    worst = {k: max(d[k] for d in lm_train_diffs(card, cpu))
             for k in ("loss", "params", "momenta")}
    tol, train_tol = PARITY_TOL[dtype], LM_TRAIN_PARITY_TOL[dtype]
    log("LM D=32 parity (%s, %s kernels, S=%d): logits max|err| %.3g (limit "
        "%g), NLL |diff| %.3g (limit %g); %d train steps, worst loss |diff| "
        "%.3g (limit %g), params %.3g (limit %g); launches %d forward, %d "
        "backward" % (flags, design, LM_TRAIN_PARITY_SEQ, err, tol["logits"],
                      nll_diff, tol["nll"], LM_TRAIN_PARITY_STEPS,
                      worst["loss"], train_tol["loss"], worst["params"],
                      train_tol["params"], *launches))
    n_layers = cfg.n_layers
    trained = expected_launches(n_layers, LM_TRAIN_PARITY_STEPS, captures)
    want = (n_layers + trained, trained)
    if launches != want or captures != 1:
        raise AssertionError("the D-32 LM launched %s (forward, backward) "
                             "kernels (want %s) in steps that captured %d "
                             "programs (want 1)" % (launches, want, captures))
    bad = [k for k in worst if worst[k] > train_tol[k]]
    if err > tol["logits"] or nll_diff > tol["nll"] or bad:
        raise AssertionError("the D-32 LM on the card disagrees with the CPU"
                             " (%s): logits %.3g, NLL %.3g, training %s"
                             % (DTYPE_NAME[dtype], err, nll_diff, bad))
    torch.cuda.empty_cache()
    return launches


def phase_d32_timing():
    """The attention kernels at D32_SHAPE causal in each dtype: forward and
    backward kernel, strided, plain and library times, medians of three
    rounds (their accuracy is held in phase 3).  Returns {dtype: {"fwd":
    {...}, "bwd": {...}}}."""
    from mxnet_tpu_torch.ops import attention as att
    F = torch.nn.functional
    gen = torch.Generator(device="cuda").manual_seed(3)
    out = {}
    for dtype in DTYPE_NAME:
        q, k, v = _qkv(D32_SHAPE, dtype, gen)
        do = _qkv(D32_SHAPE, dtype, gen)[0]
        qs, ks, vs = _qkv(D32_SHAPE, dtype, gen, strided=True)
        fns = {
            "fwd": {"ms": lambda: att.flash_attention(q, k, v, True),
                    "strided_ms": lambda: att.flash_attention(qs, ks, vs,
                                                              True),
                    "plain_ms": lambda: att.flash_attention_reference(
                        q, k, v, True),
                    "library_ms": lambda: F.scaled_dot_product_attention(
                        q, k, v, is_causal=True)},
            "bwd": {"ms": lambda: att.flash_attention_backward(q, k, v, do,
                                                               True),
                    "strided_ms": lambda: att.flash_attention_backward(
                        qs, ks, vs, do, True),
                    "plain_ms": lambda: att.chunked_attention_grads(
                        q, k, v, do, True)},
        }
        res = {}
        with torch.no_grad():
            for kind, group in fns.items():
                rounds = [{n: cuda_ms(fn, iters=10)
                           for n, fn in group.items()} for _ in range(3)]
                res[kind] = {n: sorted(r[n] for r in rounds)[1]
                             for n in group}
        with torch.enable_grad():
            res["bwd"]["library_ms"] = sorted(
                sdpa_backward_ms(q, k, v, do) for _ in range(3))[1]
        for kind, t in res.items():
            log("%s %s at %s causal (%s): kernel %.4f ms (strided %.4f ms), "
                "plain %.4f ms, SDPA%s %.4f ms"
                % (kind, DTYPE_NAME[dtype], D32_SHAPE,
                   att.design(dtype, D32_SHAPE[-1]), t["ms"],
                   t["strided_ms"], t["plain_ms"],
                   " backward" if kind == "bwd" else "", t["library_ms"]))
        out[dtype] = res
        del q, k, v, do, qs, ks, vs
        torch.cuda.empty_cache()
    return out


def lm_train_flops(cfg, batch, seq):
    """FLOPs of one training step, counted from the code: 6 x the params
    that enter matrix products (q, k, v, o, w1, w2 per layer and the
    output projection; the embeddings are gathers) x tokens, plus the
    attention: the forward's two products (4*D per (query, key) pair the
    causal mask keeps) and the backward's five (10*D), per head and layer.
    Returns (total, matmul part, attention part)."""
    d, f = cfg.d_model, cfg.d_ff
    matmul_params = cfg.n_layers * (4 * d * d + 2 * d * f) + d * cfg.vocab
    matmul = 6 * matmul_params * batch * seq
    pairs = seq * (seq + 1) // 2
    attn = 14 * (d // cfg.n_heads) * pairs * batch * cfg.n_heads \
        * cfg.n_layers
    return matmul + attn, matmul, attn


def lm_train_timed(step, cfg, what):
    """LM_TRAIN_WARMUP + LM_TRAIN_STEPS calls of ``step`` (returns the
    loss), each timed and holding each kernel to n_layers launches (and
    n_layers more for each warm-up run of a capture in that call).
    Returns (times, losses, timed steps' counters, (forward, backward)
    launches)."""
    from mxnet_tpu_torch.ops import attention as att
    times, losses, totals = [], [], [0, 0]
    for i in range(LM_TRAIN_WARMUP + LM_TRAIN_STEPS):
        if i == LM_TRAIN_WARMUP:
            timed = counter_snapshot()
        att.reset_launch_count()
        att.reset_backward_launch_count()
        before = counter_snapshot()
        t0 = time.perf_counter()
        losses.append(step())
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
        captures = counter_delta(before)["graph_captures"]
        launches = (att.launch_count(), att.backward_launch_count())
        want = expected_launches(cfg.n_layers, 1, captures)
        if launches != (want, want):
            raise AssertionError("%s step %d launched %s (forward, "
                                 "backward) kernels, not %d each (%d "
                                 "captures)" % (what, i, launches, want,
                                                captures))
        totals = [t + n for t, n in zip(totals, launches)]
    return times, [x.item() for x in losses], counter_delta(timed), \
        tuple(totals)


def lm_step_checks(what, mode, losses, counts):
    """The loss finite and falling; the timed steps one replay each
    (captured) or none (eager), and no capture."""
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError("non-finite loss (%s, %s): %s"
                             % (what, mode, losses))
    if not losses[-1] < losses[0]:
        raise AssertionError("the loss did not fall (%s, %s): %s"
                             % (what, mode, losses))
    replays = LM_TRAIN_STEPS if mode == "captured" else 0
    if counts["graph_captures"] != 0 or counts["graph_replays"] != replays:
        raise AssertionError("%s (%s) timed steps' counters %s, want 0 "
                             "captures and %d replays"
                             % (what, mode, counts, replays))


def phase_lm_train(dtype):
    """GPT-2-small-width LM training on the card through both step
    builders, each captured (one replay a step) and eager in turn:
    LM_TRAIN_WARMUP + LM_TRAIN_STEPS steps on one seeded batch of 8 x 1024;
    ms/step, tokens/s, share of peak and peak memory; the loss must stay
    finite and fall; n_layers forward and n_layers backward launches a
    step.  Returns {builder: {...captured..., "eager": {...}}} and the
    kernels' launches."""
    from mxnet_tpu_torch.models import transformer as tr
    from mxnet_tpu_torch.ops import attention as att
    flags = tf32_flags() if dtype == torch.float32 else DTYPE_NAME[dtype]
    cfg = tr.TransformerLMConfig(dtype=dtype, **GPT2_SMALL)
    gen = torch.Generator(device="cuda").manual_seed(0)
    seq = torch.randint(0, cfg.vocab, (LM_BATCH, LM_SEQ + 1),
                        generator=gen, device="cuda")
    tokens, labels = tr.place_batch(seq[:, :-1], seq[:, 1:])
    flops, matmul_flops, attn_flops = lm_train_flops(cfg, LM_BATCH, LM_SEQ)
    out, totals = {}, [0, 0]
    for builder, mode in itertools.product(("plain", "zero1"), STEP_MODES):
        params = tr.init_transformer_params(
            torch.Generator(device="cuda").manual_seed(0), cfg)
        # the steps update params (and momenta) in place
        if builder == "plain":
            step, momenta = tr.make_train_step(cfg, lr=LM_TRAIN_LR), None

            def run():
                return step(params, tokens, labels)[-1]
        else:
            step, momenta = tr.make_train_step_zero1(
                cfg, params, lr=LM_TRAIN_LR, momentum=LM_TRAIN_MOMENTUM)

            def run():
                return step(params, momenta, tokens, labels)[-1]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        what = "LM train step (%s, %s)" % (DTYPE_NAME[dtype], builder)
        with step_mode(mode):
            times, losses, counts, launches = lm_train_timed(run, cfg, what)
        totals = [t + n for t, n in zip(totals, launches)]
        ms = sorted(times[LM_TRAIN_WARMUP:])[LM_TRAIN_STEPS // 2]
        res = dict(step_ms_median=ms, step_ms_first=times[:LM_TRAIN_WARMUP],
                   tokens_s=LM_BATCH * LM_SEQ / ms * 1e3,
                   peak_share=flops / (ms / 1e3) / PEAK_FLOPS[dtype],
                   losses=losses, timed_counts=counts,
                   peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
        if mode == "captured":
            out[builder] = res
        else:
            out[builder]["eager"] = res
        log("LM train %s (%s), %s step, %s, %d layers, batch %dx%d: ms/step "
            "median of %d %.3f, first %d %s, %.1f tokens/s, %.2f%% of the %g "
            "TFLOP/s peak at %.4g TFLOP/step (matmul %.4g, attention fwd+bwd "
            "%.4g); loss %s; peak memory %.2f GB; timed steps' counters %s; "
            "launches per step %d forward, %d backward (%s)"
            % (DTYPE_NAME[dtype], flags, builder, mode, cfg.n_layers,
               LM_BATCH, LM_SEQ, LM_TRAIN_STEPS, ms, LM_TRAIN_WARMUP,
               ["%.1f" % t for t in times[:LM_TRAIN_WARMUP]],
               res["tokens_s"], 100 * res["peak_share"],
               PEAK_FLOPS[dtype] / 1e12, flops / 1e12, matmul_flops / 1e12,
               attn_flops / 1e12, ["%.4f" % x for x in losses],
               res["peak_mem_gb"], counts, cfg.n_layers, cfg.n_layers,
               att.design(dtype, cfg.d_model // cfg.n_heads)))
        lm_step_checks(what, mode, losses, counts)
        del params, momenta, step, run
        free_card()
    return out, tuple(totals)


# The D-32 LM (phase 14): EleutherAI's Pythia-31M published widths (hidden
# 256, 8 heads, so D = 32; intermediate 1024, 6 layers, vocab 50304, 2048
# positions) in this repo's architecture, seeded random weights, not cut.
PYTHIA_31M = dict(vocab=50304, d_model=256, n_heads=8, d_ff=1024,
                  n_layers=6, max_len=2048)
PYTHIA_BATCH, PYTHIA_SEQ = 8, 2048


def phase_lm_pythia(dtype):
    """The D-32 LM at Pythia-31M's widths on one seeded batch of 8 x 2048
    tokens: LM_REQUESTS batches scored (ms/batch, tokens/s; n_layers
    forward launches each), then LM_TRAIN_WARMUP + LM_TRAIN_STEPS steps of
    ``make_train_step`` from the same init, captured and then eager (lr
    LM_TRAIN_LR; ms/step, tokens/s, share of peak, peak memory; n_layers
    forward and backward launches a step; the loss must stay finite and
    fall).  Returns its numbers (the eager ones under "eager") and the
    (forward, backward) launches of the scored and trained runs."""
    from mxnet_tpu_torch.models import transformer as tr
    from mxnet_tpu_torch.ops import attention as att
    flags = tf32_flags() if dtype == torch.float32 else DTYPE_NAME[dtype]
    cfg = tr.TransformerLMConfig(dtype=dtype, **PYTHIA_31M)
    design = att.design(dtype, cfg.d_model // cfg.n_heads)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = tr.init_transformer_params(gen, cfg)
    n_params = sum(t.numel() for t in params.values())
    seq = torch.randint(0, cfg.vocab, (PYTHIA_BATCH, PYTHIA_SEQ + 1),
                        generator=gen, device="cuda")
    tokens, labels = tr.place_batch(seq[:, :-1], seq[:, 1:])
    tokens_per_batch = PYTHIA_BATCH * PYTHIA_SEQ
    with torch.inference_mode():
        # warm-up: cuBLAS handles, workspaces, the allocator's logits blocks
        tr.nll_from_logits(tr.transformer_forward(params, tokens, cfg),
                           labels)
        torch.cuda.synchronize()
        att.reset_launch_count()
        times, nlls = [], []
        for _ in range(LM_REQUESTS):
            t0 = time.perf_counter()
            logits = tr.transformer_forward(params, tokens, cfg)
            nll = tr.nll_from_logits(logits, labels)
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
            nlls.append(nll.item())
        scored = att.launch_count()
    if logits.shape != (PYTHIA_BATCH, PYTHIA_SEQ, cfg.vocab) \
            or not all(math.isfinite(x) for x in nlls):
        raise AssertionError("D-32 LM scoring (%s): logits %s, NLL %s"
                             % (DTYPE_NAME[dtype], tuple(logits.shape), nlls))
    if scored != cfg.n_layers * LM_REQUESTS:
        raise AssertionError("D-32 LM scoring launched %d forward kernels, "
                             "not %d" % (scored, cfg.n_layers * LM_REQUESTS))
    del logits
    score_ms = sorted(times)[len(times) // 2]
    flops, matmul_flops, attn_flops = lm_train_flops(cfg, PYTHIA_BATCH,
                                                     PYTHIA_SEQ)
    modes, totals = {}, [0, 0]
    for mode in STEP_MODES:
        # the step updates the params in place: each mode from the init
        ps = {n: t.clone() for n, t in params.items()}
        step = tr.make_train_step(cfg, lr=LM_TRAIN_LR)
        what = "D-32 LM step (%s)" % DTYPE_NAME[dtype]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with step_mode(mode):
            step_times, losses, counts, launches = lm_train_timed(
                lambda: step(ps, tokens, labels)[-1], cfg, what)
        totals = [t + n for t, n in zip(totals, launches)]
        ms = sorted(step_times[LM_TRAIN_WARMUP:])[LM_TRAIN_STEPS // 2]
        modes[mode] = dict(
            step_ms_median=ms, step_ms_first=step_times[:LM_TRAIN_WARMUP],
            tokens_s=tokens_per_batch / ms * 1e3,
            peak_share=flops / (ms / 1e3) / PEAK_FLOPS[dtype],
            losses=losses, timed_counts=counts,
            peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
        lm_step_checks(what, mode, losses, counts)
        del ps, step
        free_card()
    res = dict(dtype=DTYPE_NAME[dtype], flags=flags, design=design,
               params_m=n_params / 1e6, score_ms_median=score_ms,
               score_ms=times, score_tokens_s=tokens_per_batch / score_ms
               * 1e3, nll=nlls, **modes["captured"])
    res["eager"] = modes["eager"]
    for mode in STEP_MODES:
        r = modes[mode]
        log("LM D=32 %s (%s, %s kernels; Pythia-31M widths, %.1f M params, "
            "%d layers, batch %dx%d): scored ms/batch %s median %.3f, %.1f "
            "tokens/s, NLL %s; train %s ms/step median of %d %.3f, first %d "
            "%s, %.1f tokens/s, %.2f%% of the %g TFLOP/s peak at %.4g "
            "TFLOP/step (matmul %.4g, attention fwd+bwd %.4g); loss %s; peak "
            "memory %.2f GB; timed steps' counters %s; launches scored %d, "
            "per step %d forward, %d backward"
            % (DTYPE_NAME[dtype], flags, design, n_params / 1e6,
               cfg.n_layers, PYTHIA_BATCH, PYTHIA_SEQ,
               ["%.3f" % t for t in times], score_ms, res["score_tokens_s"],
               ["%.4f" % x for x in nlls], mode, LM_TRAIN_STEPS,
               r["step_ms_median"], LM_TRAIN_WARMUP,
               ["%.1f" % t for t in r["step_ms_first"]], r["tokens_s"],
               100 * r["peak_share"], PEAK_FLOPS[dtype] / 1e12,
               flops / 1e12, matmul_flops / 1e12, attn_flops / 1e12,
               ["%.4f" % x for x in r["losses"]], r["peak_mem_gb"],
               r["timed_counts"], scored, cfg.n_layers, cfg.n_layers))
    del params, tokens, labels, seq
    free_card()
    return res, (scored + totals[0], totals[1])


def scale_bound_ms(numel, dtype):
    """Least time for the scale: each element read once and written once
    over HBM (one multiply each is far below the operation bound)."""
    elem = torch.empty((), dtype=dtype).element_size()
    return 1e3 * 2 * numel * elem / HBM_BPS, "bytes"


def phase_scale_kernel():
    """The scale kernel against its plain version, bit for bit, at every
    case; timings at SCALE_MAIN_SHAPE.  Returns {dtype: {"max_abs_err",
    "ms", "plain_ms", "library_ms"}}."""
    from mxnet_tpu_torch import MXNetError
    from mxnet_tpu_torch.ops import scale as sc
    gen = torch.Generator(device="cuda").manual_seed(2)
    results = {}
    with torch.inference_mode():
        for dtype in (torch.float32, torch.bfloat16, torch.float16):
            worst, n_cases = 0.0, 0
            for shape in SCALE_SHAPES:
                base = torch.randn(shape, generator=gen, device="cuda")
                xs = [base.to(dtype)]
                if base.numel() == 1000003:  # 2 bytes or 4 off 16-byte
                    xs.append(xs[0].view(-1)[1:])
                for x in xs:
                    for alpha in SCALE_ALPHAS:
                        out = sc.scale(x, alpha)
                        ref = sc.scale_reference(x, alpha)
                        torch.cuda.synchronize()
                        if out.dtype != dtype or out.shape != x.shape:
                            raise AssertionError("scale output %s %s at %s"
                                                 % (out.dtype,
                                                    tuple(out.shape), shape))
                        err = (out.float() - ref.float()).abs().max().item() \
                            if x.numel() else 0.0
                        worst = max(worst, err)
                        if not torch.equal(out, ref):
                            raise AssertionError(
                                "scale kernel differs from its plain version"
                                " at %s %s alpha=%s: max|err| %.3g"
                                % (tuple(x.shape), DTYPE_NAME[dtype], alpha,
                                   err))
                        n_cases += 1
            x = torch.randn(SCALE_MAIN_SHAPE, generator=gen,
                            device="cuda").to(dtype)
            # the kernel and torch.mul are within 1% of each other: time
            # them in turns (kernel, mul, mul, kernel) and take the means
            turns = [cuda_ms(fn, iters=50) for fn in (
                lambda: sc.scale(x, MLP_ALPHA),
                lambda: torch.mul(x, MLP_ALPHA),
                lambda: torch.mul(x, MLP_ALPHA),
                lambda: sc.scale(x, MLP_ALPHA))]
            timings = {
                "ms": (turns[0] + turns[3]) / 2,
                "plain_ms": cuda_ms(lambda: sc.scale_reference(x, MLP_ALPHA)),
                "library_ms": (turns[1] + turns[2]) / 2,
            }
            results[dtype] = dict(max_abs_err=worst, **timings)
            log("scale %s: %d cases bitwise equal; at %s: kernel %.4f ms "
                "(turns %s), plain %.4f ms, torch.mul %.4f ms, bound %.4f ms"
                % (DTYPE_NAME[dtype], n_cases, SCALE_MAIN_SHAPE,
                   timings["ms"], ["%.4f" % t for t in turns],
                   timings["plain_ms"], timings["library_ms"],
                   scale_bound_ms(x.numel(), dtype)[0]))
            del x
        x = torch.randn((64, 128), generator=gen, device="cuda")
        for bad in (lambda: sc.scale(x.t(), 2.0),
                    lambda: sc.scale(x.double(), 2.0)):
            try:
                bad()
            except MXNetError:
                continue
            raise AssertionError("scale accepted an input it does not take")
    torch.cuda.empty_cache()
    return results


# -- the MNIST MLP through the registered kernel ------------------------------
def scale_grad(out_grads, inputs, outputs, attrs):
    """pl_scale's semantic gradient (tests/test_pallas_register.py:40-41)."""
    return (out_grads[0] * float(attrs.get("alpha", 2.0)),)


def register_pl_scale():
    """Register the scale kernel as the user kernel ``pl_scale``, as a user
    of ``rtc`` would: the kernel, or its plain body where the registry
    fills ``interpret=True`` (CPU and meta tensors)."""
    from mxnet_tpu_torch import rtc
    from mxnet_tpu_torch.ops.scale import scale, scale_reference

    def pl_scale(x, alpha=2.0, interpret=False):
        return scale_reference(x, alpha) if interpret else scale(x, alpha)
    return rtc.register("pl_scale", pl_scale, grad=scale_grad, force=True)


def build_mlp(S):
    """``examples/train_mnist.py::build_mlp`` (784-128-64-10) with the
    registered kernel after the first activation, in the namespace ``S``."""
    net = S.Flatten(S.Variable("data"))
    net = S.FullyConnected(net, num_hidden=128, name="fc1")
    net = S.Activation(net, act_type="relu")
    net = S.pl_scale(net, alpha=MLP_ALPHA)
    net = S.FullyConnected(net, num_hidden=64, name="fc2")
    net = S.Activation(net, act_type="relu")
    net = S.FullyConnected(net, num_hidden=10, name="fc3")
    return S.SoftmaxOutput(net, name="softmax")


def param_names(exe):
    return [n for n in exe.arg_names if n not in ("data", "softmax_label")]


def bind_mlp(ctx, dtype=torch.float32, grad_req="write"):
    from mxnet_tpu_torch import sym
    return build_mlp(sym).simple_bind(
        ctx, grad_req=grad_req, type_dict={"data": dtype},
        data=(MLP_BATCH, 784), softmax_label=(MLP_BATCH,))


def init_mlp(exe, seed=0):
    """Xavier (uniform, avg, magnitude 3) weights and zero biases, drawn
    from the executor's device generator after ``random.seed(seed)``."""
    import mxnet_tpu_torch as mt
    mt.random.seed(seed)
    init = mt.init.Xavier()
    for n in param_names(exe):
        init(mt.init.InitDesc(n), exe.arg_dict[n])


def _sync(exe):
    if exe.arg_dict["data"].context.device_type == "gpu":
        torch.cuda.synchronize()


def train_mlp(exe, x, y, steps):
    """``steps`` SGD-momentum steps over consecutive batches of the NDArrays
    x (N, 784) and y (N,): forward(is_train=True), backward(), one update
    per parameter, the loop ``Module.fit`` runs, and nothing else inside
    the clock.  Returns each step's softmax output (a tensor on the
    executor's device, made anew by each forward; ``batch_losses`` turns
    them into losses after the loop) and the seconds of each step (the
    clock stops after a synchronize)."""
    import mxnet_tpu_torch as mt
    upd = mt.optimizer.Updater(mt.optimizer.SGD(
        learning_rate=MLP_LR, momentum=MLP_MOMENTUM,
        rescale_grad=1.0 / MLP_BATCH))
    params = param_names(exe)
    probs, times = [], []
    for i in range(steps):
        t0 = time.perf_counter()
        sl = slice(i * MLP_BATCH, (i + 1) * MLP_BATCH)
        exe.forward(is_train=True, data=x[sl], softmax_label=y[sl])
        exe.backward()
        for j, n in enumerate(params):
            upd(j, exe.grad_dict[n], exe.arg_dict[n])
        probs.append(exe.outputs[0]._data)
        _sync(exe)
        times.append(time.perf_counter() - t0)
    return probs, times


def batch_losses(probs, y):
    """Mean negative log-likelihood of each step's batch, from the softmax
    outputs of ``train_mlp`` and the labels y (N,): a (steps,) tensor."""
    labels = y._data[:len(probs) * MLP_BATCH].long().view(len(probs), -1, 1)
    picked = torch.stack(probs).float().gather(2, labels).squeeze(2)
    return -torch.log(picked).mean(dim=1)


def eval_mlp(exe, x, y):
    """Accuracy over consecutive batches with forward(is_train=False)."""
    correct = 0
    n = x.shape[0] // MLP_BATCH
    for i in range(n):
        sl = slice(i * MLP_BATCH, (i + 1) * MLP_BATCH)
        prob = exe.forward(is_train=False, data=x[sl])[0]._data
        correct += (prob.argmax(dim=1) == y[sl]._data.long()).sum()
    return float(correct) / (n * MLP_BATCH)


def phase_registration():
    """rtc on the card: eager and bound calls launch the kernel once per
    forward, and the bound graph's backward gives the alpha gradient."""
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import nd, sym
    from mxnet_tpu_torch.ops import scale as sc
    register_pl_scale()
    gpu = mt.gpu(0)
    x = nd.array(torch.arange(6.0).reshape(2, 3).numpy(), ctx=gpu)
    sc.reset_launch_count()
    y = nd.pl_scale(x, alpha=3.0)
    if sc.launch_count() != 1 or not torch.equal(
            y._data, x._data * 3.0) or y.context != gpu:
        raise AssertionError("nd.pl_scale on the card: launches %d, %s"
                             % (sc.launch_count(), y.asnumpy()))
    ex = sym.sum(sym.pl_scale(sym.Variable("d"), alpha=5.0)).simple_bind(
        gpu, grad_req="write", d=(2, 3))
    ex.arg_dict["d"][:] = 1.0
    # the executor's programs: each captures with WARMUP_RUNS warm-ups
    # (which launch the kernel), then each replay launches it once
    warm = mt.capture.WARMUP_RUNS
    sc.reset_launch_count()
    out = ex.forward(is_train=True)[0]
    first = sc.launch_count()
    ex.forward(is_train=True)
    if first != 1 + warm or sc.launch_count() != 2 + warm:
        raise AssertionError("bound forward launched %d times, then %d"
                             % (first, sc.launch_count() - first))
    ex.backward()
    ex.forward(is_train=False)
    grad = ex.grad_dict["d"].asnumpy()
    if sc.launch_count() != 3 + 2 * warm or float(out.asnumpy()) != 30.0 \
            or not (grad == 5.0).all():
        raise AssertionError("bound pl_scale: launches %d, out %s, grad %s"
                             % (sc.launch_count(), out.asnumpy(), grad))
    log("registration: nd.pl_scale and sym.pl_scale on %s launch once per "
        "forward (and %d times in a capture's warm-ups); d/dx sum(5x) = %s"
        % (gpu, warm, grad.ravel().tolist()))


def _mnist_on(ctx):
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import nd
    blob = mt.test_utils.get_mnist()
    return [nd.array(blob[k].reshape(blob[k].shape[0], -1) if "data" in k
                     else blob[k], ctx=ctx)
            for k in ("train_data", "train_label", "test_data", "test_label")]


def phase_mlp():
    """One epoch of the MLP on the card through the scale kernel, then the
    test images scored in fp32 and in bf16.  Returns the kernel's
    launches in each dtype's run."""
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch.ops import scale as sc
    register_pl_scale()
    gpu = mt.gpu(0)
    x, y, xt, yt = _mnist_on(gpu)
    exe = bind_mlp(gpu)
    init_mlp(exe)
    sc.reset_launch_count()
    probs, times = train_mlp(exe, x, y, MLP_STEPS)
    acc = eval_mlp(exe, xt, yt)
    launches_fp32 = sc.launch_count()
    losses = batch_losses(probs, y).tolist()
    ms = sorted(1e3 * t for t in times)[len(times) // 2]
    log("MLP fp32 on %s: %d steps of %d, ms/step median %.3f, first 5 %s; "
        "loss at steps 1, 32, 64: %.6f %.6f %.6f; test accuracy %.4f "
        "(JAX on the CPU %.4f); scale launches %d"
        % (gpu, MLP_STEPS, MLP_BATCH, ms,
           ["%.3f" % (1e3 * t) for t in times[:5]], losses[0], losses[31],
           losses[63], acc, JAX_CPU_ACCURACY, launches_fp32))
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError("non-finite MLP loss %s" % losses)
    if not losses[-1] < losses[0]:
        raise AssertionError("the MLP loss did not fall: %s" % losses)
    if acc < JAX_CPU_ACCURACY - 0.02:
        raise AssertionError("MLP test accuracy %.4f below %.4f - 0.02"
                             % (acc, JAX_CPU_ACCURACY))
    # the training forward's program and the eval forward's each capture
    # once, their warm-ups launching the kernel WARMUP_RUNS times
    warm = mt.capture.WARMUP_RUNS
    want = MLP_STEPS + MLP_EVAL_BATCHES + 2 * warm
    if launches_fp32 != want:
        raise AssertionError("scale launched %d times, expected train "
                             "forwards + eval batches + 2 captures' "
                             "warm-ups = %d" % (launches_fp32, want))
    bf16 = bind_mlp(gpu, torch.bfloat16)
    bf16.copy_params_from({n: exe.arg_dict[n] for n in param_names(exe)})
    sc.reset_launch_count()
    acc_bf16 = eval_mlp(bf16, xt.astype(torch.bfloat16), yt)
    launches_bf16 = sc.launch_count()
    log("MLP bf16 scoring of the trained weights: test accuracy %.4f, "
        "scale launches %d" % (acc_bf16, launches_bf16))
    if launches_bf16 != MLP_EVAL_BATCHES + warm \
            or acc_bf16 < JAX_CPU_ACCURACY - 0.02:
        raise AssertionError("bf16 MLP scoring: accuracy %.4f, launches %d"
                             % (acc_bf16, launches_bf16))
    return {torch.float32: launches_fp32, torch.bfloat16: launches_bf16}


def phase_mlp_parity():
    """10 MLP steps on the card (kernel) against the CPU (plain version)
    from one init, fp32."""
    import mxnet_tpu_torch as mt
    register_pl_scale()
    runs, init = [], None
    for ctx in (mt.cpu(), mt.gpu(0)):
        exe = bind_mlp(ctx)
        if init is None:
            init_mlp(exe)
            init = {n: exe.arg_dict[n].copy() for n in param_names(exe)}
        else:
            exe.copy_params_from(init)
        x, y, _, _ = _mnist_on(ctx)
        probs, _ = train_mlp(exe, x, y, MLP_PARITY_STEPS)
        runs.append((exe, batch_losses(probs, y).cpu()))
    (cpu_exe, cpu_loss), (gpu_exe, gpu_loss) = runs
    loss_err = (gpu_loss - cpu_loss).abs().max().item()
    w_err = max((gpu_exe.arg_dict[n]._data.cpu()
                 - cpu_exe.arg_dict[n]._data).abs().max().item()
                for n in param_names(cpu_exe))
    log("MLP parity (fp32, %d steps): loss max|err| %.3g, weights max|err| "
        "%.3g" % (MLP_PARITY_STEPS, loss_err, w_err))
    # fp32 sums in cuBLAS's order against the CPU's, through 10 updates
    if loss_err > 1e-5 or w_err > 1e-4:
        raise AssertionError("MLP on the card disagrees with the CPU")


# -- ResNet-50 through Module (bench.py:107-152) ------------------------------
RESNET_BATCH, RESNET_IMAGE, RESNET_WARMUP, RESNET_STEPS = 32, 224, 5, 30
RESNET_LR, RESNET_MOMENTUM, RESNET_WD = 0.1, 0.9, 1e-4
# bench.py's analytic FLOPs per image: forward 2 x 4.1 GMAC, training 3x
RESNET_FWD_FLOPS, RESNET_TRAIN_FLOPS = 8.2e9, 24.6e9
RESNET_PARITY_BATCH = 2
# Card against CPU, two steps of ResNet-50 at batch 2 from one init.  One
# SGD step at lr 0.1 on a batch of 2 moves some weights by 4.7 and makes
# the second step's results depend on the first's rounding about 1e8
# times over.  On the CPU, before any run on the card
# (tools/torch_resnet_cpu_spread.py, largest |differences|: step-1
# outputs, step-2 outputs, parameters and moving statistics after step 2,
# relative to max(1, |v|)): the JAX package against this one in fp64
# 1.5e-15, 1.5e-8, 1.3e-7 and 5.7e-8; in fp32 3.4e-7, 0.039, 0.42 and
# 0.098; the JAX package's own fp32 against its fp64 5.9e-7, 0.20, 0.62
# and 0.10.  So:
# - fp64 holds the arithmetic: step 1's outputs (no update yet) 1e-10,
#   everything after an update 1e-5, about 100 times the CPU's fp64
#   spread, on the largest |difference|;
# - fp32 holds step 1's outputs to 1e-4: the forward before any update,
#   where TF32 or a dtype slip would show.  After an update an fp32 run
#   lands wherever its own rounding, amplified, puts it: the script
#   prints how far the card's and the CPU's fp32 runs each land from
#   their fp64 runs and from each other, and holds none of it: two fp32
#   runs as accurate as each other still land apart by whatever the
#   amplified roundings give (PERF.md has the card's readings).
RESNET_PARITY_TOL = {
    torch.float64: dict(out1=1e-10, params1=1e-5, out2=1e-5, params2=1e-5,
                        aux2=1e-5),
    torch.float32: dict(out1=1e-4),
}


def tf32_flags():
    """Turn TF32 off for an fp32 phase and say so."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return ("TF32 off (cuda.matmul.allow_tf32=%s, cudnn.allow_tf32=%s)"
            % (torch.backends.cuda.matmul.allow_tf32,
               torch.backends.cudnn.allow_tf32))


def resnet_symbol(dtype=torch.float32, model="resnet50_v1", classes=1000,
                  dropout=None, **model_kw):
    """``bench.py::_module_train_rate``'s model: the zoo model (cast to
    ``dtype``; every Dropout at rate ``dropout`` where given) lowered to a
    Symbol, ``Cast`` to fp32 (fp64 stays fp64),
    ``SoftmaxOutput(name="softmax")``."""
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import sym
    from mxnet_tpu_torch.test_utils import set_dropout
    with mt.name.NameManager():
        net = mt.gluon.model_zoo.vision.get_model(model, classes=classes,
                                                  **model_kw)
    if dropout is not None:
        set_dropout(net, dropout)
    if dtype != torch.float32:
        net.cast(str(dtype).replace("torch.", ""))
    out_dtype = "float64" if dtype == torch.float64 else "float32"
    out = sym.Cast(net(sym.Variable("data")), dtype=out_dtype)
    return sym.SoftmaxOutput(out, sym.Variable("softmax_label"),
                             name="softmax")


def resnet_module(ctx, batch, dtype=torch.float32, image=RESNET_IMAGE,
                  model="resnet50_v1", classes=1000, **model_kw):
    """``resnet_symbol``'s model in a ``Module`` on ``ctx`` bound at
    ``batch`` x 3 x image x image; no parameters yet."""
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch.io import DataDesc
    out_dtype = "float64" if dtype == torch.float64 else "float32"
    mod = mt.mod.Module(resnet_symbol(dtype, model, classes, **model_kw),
                        context=ctx)
    mod.bind(data_shapes=[DataDesc("data", (batch, 3, image, image),
                                   dtype=dtype)],
             label_shapes=[DataDesc("softmax_label", (batch,),
                                    dtype=out_dtype)])
    return mod


def resnet_train_setup(mod, params=None, optimizer="sgd",
                       optimizer_params=None):
    """Xavier init after ``random.seed(0)`` (or ``params``, a
    ``get_params()`` pair), then SGD lr 0.1, momentum 0.9, wd 1e-4 (or
    ``optimizer`` with ``optimizer_params``)."""
    import mxnet_tpu_torch as mt
    if params is None:
        mt.random.seed(0)
        mod.init_params(initializer=mt.initializer.Xavier())
    else:
        mod.set_params(*params)
    mod.init_optimizer(optimizer=optimizer, optimizer_params=(
        optimizer_params or (("learning_rate", RESNET_LR),
                             ("momentum", RESNET_MOMENTUM),
                             ("wd", RESNET_WD))))


def resnet_batch(ctx, batch, dtype, image=RESNET_IMAGE, classes=1000,
                 label_dtype=torch.float32, seed=0):
    """One ``DataBatch`` from ``RandomState(seed)``, as bench.py makes it
    (seed 0)."""
    import numpy as np
    from mxnet_tpu_torch import nd
    from mxnet_tpu_torch.io import DataBatch
    rng = np.random.RandomState(seed)
    return DataBatch(
        [nd.array(rng.rand(batch, 3, image, image).astype(np.float32),
                  ctx=ctx, dtype=dtype)],
        [nd.array(rng.randint(0, classes, (batch,)).astype(np.float32),
                  ctx=ctx, dtype=label_dtype)])


def _resnet_two_steps(ctx, dtype, params):
    """Two ``_fit_step``s at batch 2; returns {"out1", "params1", "out2",
    "params2", "aux2"}: each step's outputs and the parameters after it,
    and the moving statistics after step 2, as fp64 CPU tensors."""
    mod = resnet_module(ctx, RESNET_PARITY_BATCH, dtype)
    resnet_train_setup(mod, params)
    label_dt = torch.float64 if dtype == torch.float64 else torch.float32
    db = resnet_batch(ctx, RESNET_PARITY_BATCH, dtype, label_dtype=label_dt)
    res = {}
    for step in (1, 2):
        mod._fit_step(db)
        arg, aux = mod.get_params()
        res["out%d" % step] = mod.get_outputs()[0]._data.to("cpu",
                                                            torch.float64)
        res["params%d" % step] = {n: a._data.to(torch.float64)
                                  for n, a in arg.items()}
    res["aux2"] = {n: a._data.to(torch.float64) for n, a in aux.items()}
    if mod._cached_step is None:
        raise AssertionError("the parity steps did not take CachedTrainStep")
    return res


def _cast_params(params, dtype):
    from mxnet_tpu_torch import nd
    import mxnet_tpu_torch as mt
    return [{n: nd.NDArray(a._data.to(dtype), mt.cpu()) for n, a in d.items()}
            for d in params]


def _resnet_diffs(a, b, l2=False):
    """Distances between two runs of ``_resnet_two_steps``, the moving
    statistics relative to max(1, |v|): each the largest |a - b|, or with
    ``l2`` the root of its summed squares."""
    def dist(pairs):
        d = torch.cat([(u - v).flatten() for u, v in pairs])
        return (d.norm() if l2 else d.abs().max()).item()
    out = {}
    for key, va in a.items():
        vb = b[key]
        if key == "aux2":
            scale = {n: v.abs().clamp_min(1.0) for n, v in va.items()}
            va = {n: v / scale[n] for n, v in va.items()}
            vb = {n: v / scale[n] for n, v in vb.items()}
        pairs = [(va[n], vb[n]) for n in va] if isinstance(va, dict) \
            else [(va, vb)]
        out[key] = dist(pairs)
    return out


def phase_resnet_parity():
    """ResNet-50 through Module on the card against the CPU, two steps
    from one init, fp64 then fp32 (TF32 off).  Returns the distances and
    the init (a ``get_params()`` pair on the CPU)."""
    import mxnet_tpu_torch as mt
    flags = tf32_flags()
    init = mt.cpu()
    mod = resnet_module(init, RESNET_PARITY_BATCH)
    resnet_train_setup(mod)
    params = mod.get_params()
    runs, steps = {}, {}
    for dtype in (torch.float64, torch.float32):
        p = _cast_params(params, dtype)
        # (CPU, card); the card's two steps replay one captured program
        cpu = _resnet_two_steps(mt.cpu(), dtype, p)
        before = counter_snapshot()
        runs[dtype] = [cpu, _resnet_two_steps(mt.gpu(0), dtype, p)]
        name = str(dtype)[6:]
        steps[name] = counter_delta(before)
        if steps[name] != dict(graph_captures=1, graph_replays=2,
                               program_calls=2):
            raise AssertionError("ResNet-50 parity on the card (%s): %s, not "
                                 "one captured program replayed once a step"
                                 % (name, steps[name]))
        free_card()
    diffs = {dt: _resnet_diffs(r[1], r[0]) for dt, r in runs.items()}
    (cpu32, gpu32), (cpu64, gpu64) = runs[torch.float32], runs[torch.float64]
    fp32 = {"card-cpu": diffs[torch.float32],
            "card-card64": _resnet_diffs(gpu32, gpu64),
            "cpu-cpu64": _resnet_diffs(cpu32, cpu64)}
    fp32_l2 = {"card-cpu": _resnet_diffs(gpu32, cpu32, l2=True),
               "card-card64": _resnet_diffs(gpu32, gpu64, l2=True),
               "cpu-cpu64": _resnet_diffs(cpu32, cpu64, l2=True)}
    tol64, tol32 = RESNET_PARITY_TOL[torch.float64], \
        RESNET_PARITY_TOL[torch.float32]

    def fmt(d):
        return {k: "%.3g" % v for k, v in d.items()}
    log("ResNet-50 parity, batch %d, 2 steps, card (captured: %s) against "
        "CPU: fp64 largest |diff| %s (limits %s); fp32, %s: card against CPU "
        "step-1 outputs %.3g (limit %g)"
        % (RESNET_PARITY_BATCH, steps, fmt(diffs[torch.float64]), tol64,
           flags, diffs[torch.float32]["out1"], tol32["out1"]))
    for name in fp32:
        log("  fp32 %-11s largest |diff| %s, root-sum-square %s"
            % (name, fmt(fp32[name]), fmt(fp32_l2[name])))
    bad = [k for k, v in diffs[torch.float64].items() if v > tol64[k]]
    if diffs[torch.float32]["out1"] > tol32["out1"]:
        bad.append("fp32 out1")
    if bad:
        raise AssertionError("ResNet-50 on the card disagrees with the CPU: "
                             "%s" % bad)
    return dict(fp64=diffs[torch.float64], fp32=fp32, fp32_l2=fp32_l2,
                card_steps=steps), params

def _timed(fn, n):
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return times


def phase_resnet_train(dtype):
    """bench.py's ResNet-50 training step at batch 32 on the card, captured
    (one replay a step) and eager (``capture.eager()``) in turn: ms/step,
    img/s, peak memory and the step counters of the timed steps of each;
    inference img/s and the share of peak.  The captured figures are the
    result's top level, the eager ones under "eager"."""
    import mxnet_tpu_torch as mt
    flags = tf32_flags() if dtype == torch.float32 else "bf16"
    gpu = mt.gpu(0)
    peak = PEAK_FLOPS[dtype]
    modes = {}
    for mode in STEP_MODES:
        mod = resnet_module(gpu, RESNET_BATCH, dtype)
        resnet_train_setup(mod)
        db = resnet_batch(gpu, RESNET_BATCH, dtype)
        ex = mod._exec_group.execs[0]
        stat = next(n for n in ex.aux_names if n.endswith("running_mean"))
        before = ex.aux_dict[stat]._data.clone()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with step_mode(mode):
            warm = _timed(lambda: mod._fit_step(db), RESNET_WARMUP)
            if mod._cached_step is None:
                raise AssertionError("ResNet-50 step fell off "
                                     "CachedTrainStep")
            counts = counter_snapshot()
            times = _timed(lambda: mod._fit_step(db), RESNET_STEPS)
            counts = counter_delta(counts)
        prob = mod.get_outputs()[0]._data
        label = db.label[0]._data.long()
        loss = -torch.log(prob.float().gather(1, label[:, None])).mean() \
            .item()
        moved = (ex.aux_dict[stat]._data != before).any().item()
        ms = sorted(times)[len(times) // 2]
        modes[mode] = dict(
            step_ms_median=ms, step_ms_first5=warm,
            img_s=RESNET_BATCH / ms * 1e3,
            train_peak_share=RESNET_TRAIN_FLOPS * RESNET_BATCH / ms * 1e3
            / peak, loss=loss, peak_mem_gb=torch.cuda.max_memory_allocated()
            / 1e9, timed_counts=counts)
        want = dict(graph_captures=0, program_calls=RESNET_STEPS,
                    graph_replays=RESNET_STEPS if mode == "captured" else 0)
        log("ResNet-50 %s (%s) on %s, batch %d through CachedTrainStep, "
            "%s: %d timed steps, ms/step median %.3f, first 5 (warm-up) %s, "
            "%.1f img/s, %.2f%% of the %g TFLOP/s peak at 24.6 GFLOP/img; "
            "timed steps' counters %s; loss after %d steps %.4f; %s moved: "
            "%s; peak memory %.2f GB"
            % (DTYPE_NAME[dtype], flags, torch.cuda.get_device_name(0),
               RESNET_BATCH, mode, RESNET_STEPS, ms,
               ["%.1f" % t for t in warm], modes[mode]["img_s"],
               100 * modes[mode]["train_peak_share"], peak / 1e12, counts,
               RESNET_WARMUP + RESNET_STEPS, loss, stat, moved,
               modes[mode]["peak_mem_gb"]))
        if not math.isfinite(loss):
            raise AssertionError("non-finite ResNet-50 loss (%s, %s)"
                                 % (dtype, mode))
        if not moved:
            raise AssertionError("the BatchNorm moving statistics did not "
                                 "move (%s)" % mode)
        if counts != want:
            raise AssertionError("ResNet-50 %s steps: counters %s, want %s"
                                 % (mode, counts, want))
        if mode == "eager":
            # inference: the executor's eval forward, eager, then captured
            # (one replay a call after its capture)
            with step_mode("eager"):
                _timed(lambda: mod.forward(db, is_train=False),
                       RESNET_WARMUP)
                fwd_eager = _timed(lambda: mod.forward(db, is_train=False),
                                   RESNET_STEPS)
            _timed(lambda: mod.forward(db, is_train=False), RESNET_WARMUP)
            fwd_counts = counter_snapshot()
            fwd = _timed(lambda: mod.forward(db, is_train=False),
                         RESNET_STEPS)
            fwd_counts = counter_delta(fwd_counts)
            if fwd_counts != dict(graph_captures=0,
                                  graph_replays=RESNET_STEPS,
                                  program_calls=RESNET_STEPS):
                raise AssertionError("ResNet-50 inference counters %s"
                                     % fwd_counts)
        del mod, ex, db, prob
        free_card()
    fwd_ms = sorted(fwd)[len(fwd) // 2]
    res = dict(dtype=DTYPE_NAME[dtype], flags=flags, batch=RESNET_BATCH,
               infer_ms_median=fwd_ms,
               infer_eager_ms_median=sorted(fwd_eager)[len(fwd_eager) // 2],
               infer_img_s=RESNET_BATCH / fwd_ms * 1e3,
               infer_peak_share=RESNET_FWD_FLOPS * RESNET_BATCH / fwd_ms
               * 1e3 / peak, **modes["captured"])
    res["eager"] = modes["eager"]
    log("ResNet-50 %s inference median %.3f ms captured (eager %.3f), "
        "%.1f img/s (%.2f%% of peak at 8.2 GFLOP/img); captured step %.3f "
        "ms against eager %.3f"
        % (DTYPE_NAME[dtype], fwd_ms, res["infer_eager_ms_median"],
           res["infer_img_s"], 100 * res["infer_peak_share"],
           res["step_ms_median"], res["eager"]["step_ms_median"]))
    return res


# Gluon against Module (phase 15), fp64 on the card, from one init and one
# batch, after one step: Module's step-1 output is SoftmaxOutput's
# probabilities and Gluon's the logits, whose softmax the same fp64
# arithmetic gives to a few ulps; the parameters and moving statistics
# after the update differ by the two backwards' fp64 sums (Module's
# semantic p - onehot against autograd through log_softmax and pick)
# times lr 0.1, about 1e-15, held at 1e-5 as RESNET_PARITY_TOL holds
# everything after an update.
GLUON_MODULE_TOL = dict(prob1=1e-10, params1=1e-5, aux1=1e-5)


def gluon_resnet(ctx, dtype=torch.float32, params=None, model="resnet50_v1",
                 classes=1000, **model_kw):
    """The zoo model for Gluon training on ``ctx``: cast to ``dtype``,
    hybridized, its parameters and moving statistics from ``params`` (a
    ``Module.get_params()`` pair; the names are the same) or, without
    them, Xavier after ``random.seed(0)`` at the first forward."""
    import mxnet_tpu_torch as mt
    with mt.name.NameManager():
        net = mt.gluon.model_zoo.vision.get_model(model, classes=classes,
                                                  **model_kw)
    if dtype != torch.float32:
        net.cast(str(dtype).replace("torch.", ""))
    mt.random.seed(0)
    net.initialize(mt.initializer.Xavier(), ctx=ctx)
    if params is not None:
        values = dict(params[0], **params[1])
        for name, p in net.collect_params().items():
            p.set_data(mt.nd.NDArray(values[name]._data.to(ctx.torch_device,
                                                           dtype), ctx))
    net.hybridize()
    return net


def gluon_trainer(net):
    """``Trainer("sgd")`` at phase 10's hyper-parameters."""
    import mxnet_tpu_torch as mt
    return mt.gluon.Trainer(net.collect_params(), "sgd", {
        "learning_rate": RESNET_LR, "momentum": RESNET_MOMENTUM,
        "wd": RESNET_WD})


def gluon_step(net, trainer, loss_fn, db):
    """One Gluon training step on a ``DataBatch``: the forward and the
    loss under ``autograd.record()`` (logits cast to fp32 from bf16, as
    phase 10's symbol casts them), ``backward``, ``Trainer.step``.
    Returns the logits and the per-sample losses."""
    from mxnet_tpu_torch import autograd
    x, y = db.data[0], db.label[0]
    with autograd.record():
        out = net(x)
        if out._data.dtype == torch.bfloat16:
            out = out.astype("float32")
        loss = loss_fn(out, y)
    loss.backward()
    trainer.step(x.shape[0])
    return out, loss


def _gluon_steps(ctx, dtype, params, steps):
    """``steps`` Gluon steps of ResNet-50 at batch 2 from ``params``;
    returns {"out1", "params1", "aux1", ...} as ``_resnet_two_steps``
    does, the outputs as the softmax of the logits, fp64 on the CPU."""
    import mxnet_tpu_torch as mt
    net = gluon_resnet(ctx, dtype, params)
    trainer = gluon_trainer(net)
    loss_fn = mt.gluon.loss.SoftmaxCrossEntropyLoss()
    label_dt = torch.float64 if dtype == torch.float64 else torch.float32
    db = resnet_batch(ctx, RESNET_PARITY_BATCH, dtype, label_dtype=label_dt)
    res = {}
    for step in range(1, steps + 1):
        out, _ = gluon_step(net, trainer, loss_fn, db)
        res["out%d" % step] = torch.softmax(out._data.to("cpu",
                                                         torch.float64), -1)
        # copies: on the CPU a .to() that changes nothing returns the
        # tensor itself, which the next step updates in place
        res["params%d" % step] = {
            n: p.data()._data.to("cpu", torch.float64, copy=True)
            for n, p in net.collect_params().items() if p.grad_req != "null"}
        res["aux%d" % step] = {
            n: p.data()._data.to("cpu", torch.float64, copy=True)
            for n, p in net.collect_params().items() if p.grad_req == "null"}
    return res


def phase_gluon_parity(params):
    """ResNet-50 through Gluon (``hybridize``, ``SoftmaxCrossEntropyLoss``,
    ``Trainer``) on the card against the CPU, two steps from phase 9's
    init, fp64 and fp32 (TF32 off); and the fp64 card run's first step
    against one Module step from the same init and batch."""
    import mxnet_tpu_torch as mt
    flags = tf32_flags()
    runs, steps = {}, {}
    for dtype in (torch.float64, torch.float32):
        p = _cast_params(params, dtype)
        cpu = _gluon_steps(mt.cpu(), dtype, p, 2)
        # the card's steps: forward, backward and update graphs captured at
        # step 1, each replayed once a step
        before = counter_snapshot()
        runs[dtype] = [cpu, _gluon_steps(mt.gpu(0), dtype, p, 2)]
        name = str(dtype)[6:]
        steps[name] = counter_delta(before)
        if steps[name] != dict(graph_captures=3, graph_replays=6,
                               program_calls=6):
            raise AssertionError("Gluon ResNet-50 parity on the card (%s): "
                                 "%s, not three graphs replayed once a step"
                                 % (name, steps[name]))
        free_card()
    keys = ("out1", "params1", "out2", "params2", "aux2")
    diffs = {dt: _resnet_diffs({k: r[1][k] for k in keys},
                               {k: r[0][k] for k in keys})
             for dt, r in runs.items()}
    # one Module step on the card in fp64 from the same init and batch
    gpu = mt.gpu(0)
    mod = resnet_module(gpu, RESNET_PARITY_BATCH, torch.float64)
    resnet_train_setup(mod, _cast_params(params, torch.float64))
    mod._fit_step(resnet_batch(gpu, RESNET_PARITY_BATCH, torch.float64,
                               label_dtype=torch.float64))
    arg, aux = mod.get_params()
    gl = runs[torch.float64][1]
    vs_module = _resnet_diffs(
        {"prob1": gl["out1"], "params1": gl["params1"], "aux2": gl["aux1"]},
        {"prob1": mod.get_outputs()[0]._data.to("cpu", torch.float64),
         "params1": {n: a._data.to("cpu", torch.float64)
                     for n, a in arg.items()},
         "aux2": {n: a._data.to("cpu", torch.float64)
                  for n, a in aux.items()}})
    vs_module["aux1"] = vs_module.pop("aux2")
    tol64, tol32 = RESNET_PARITY_TOL[torch.float64], \
        RESNET_PARITY_TOL[torch.float32]

    def fmt(d):
        return {k: "%.3g" % v for k, v in d.items()}
    log("Gluon ResNet-50 parity (hybridize, SoftmaxCrossEntropyLoss, "
        "Trainer sgd), batch %d, 2 steps, card (captured: %s) against CPU: "
        "fp64 largest |diff| %s (limits %s); fp32, %s: step-1 outputs %.3g "
        "(limit %g); fp64 card, Gluon against Module after one step %s "
        "(limits %s)"
        % (RESNET_PARITY_BATCH, steps, fmt(diffs[torch.float64]), tol64,
           flags,
           diffs[torch.float32]["out1"], tol32["out1"], fmt(vs_module),
           GLUON_MODULE_TOL))
    bad = [k for k, v in diffs[torch.float64].items() if v > tol64[k]]
    if diffs[torch.float32]["out1"] > tol32["out1"]:
        bad.append("fp32 out1")
    bad += ["vs Module " + k for k, v in vs_module.items()
            if v > GLUON_MODULE_TOL[k]]
    if bad:
        raise AssertionError("Gluon ResNet-50 disagrees: %s" % bad)
    del mod
    free_card()
    return dict(fp64=diffs[torch.float64], fp32=diffs[torch.float32],
                vs_module=vs_module, card_steps=steps)


# Every optimizer with a fused update, in phase 15's bitwise check, with
# the hyper-parameters that give it state and exercise rescale and clip.
FUSED_CHECK_OPTIMIZERS = {
    "sgd": dict(momentum=0.9), "nag": dict(momentum=0.9), "adam": {},
    "adagrad": {}, "rmsprop": dict(centered=True), "adadelta": {},
    "ftrl": {}, "adamax": {}, "nadam": {}, "sgld": {},
    "dcasgd": dict(momentum=0.9), "signum": {}}


def gluon_fused_against_loop(ctx, name, fused, steps=3):
    """A Dense net (784-256-10, tanh, on digits-shaped data, Xavier after
    ``random.seed(0)``) trained ``steps`` Trainer steps with optimizer
    ``name`` (wd, rescale_grad and clip_gradient set), through the fused
    step or the per-parameter loop; returns its weights and states as
    tensors on the CPU."""
    import os
    import numpy as np
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch.gluon import fused_trainer
    from mxnet_tpu_torch.optimizer import _state_raw
    os.environ["MXNET_FUSED_TRAINER"] = "1" if fused else "0"
    fused_trainer.refresh_from_env()
    try:
        mt.random.seed(0)
        net = mt.gluon.nn.HybridSequential()
        # tanh, not relu: a unit dead for the whole batch has gradients of
        # exactly 0, where Adamax's rule divides 0 by 0 (in the JAX package
        # too)
        net.add(mt.gluon.nn.Dense(256, activation="tanh", in_units=784),
                mt.gluon.nn.Dense(10, in_units=256))
        net.initialize(mt.initializer.Xavier(), ctx=ctx)
        net.hybridize()
        trainer = mt.gluon.Trainer(net.collect_params(), name, dict(
            wd=1e-3, rescale_grad=2.0, clip_gradient=0.05,
            **FUSED_CHECK_OPTIMIZERS[name]))
        loss_fn = mt.gluon.loss.SoftmaxCrossEntropyLoss()
        rng = np.random.RandomState(0)
        for _ in range(steps):
            x = mt.nd.array(rng.rand(64, 784), ctx=ctx)
            y = mt.nd.array(rng.randint(0, 10, (64,)), ctx=ctx)
            with mt.autograd.record():
                loss = loss_fn(net(x), y)
            loss.backward()
            trainer.step(64)
        out = [p.data()._data.cpu() for p in net.collect_params().values()]
        for i in sorted(trainer._updater.states):
            raw = _state_raw(trainer._updater.states[i])
            for t in (raw if isinstance(raw, tuple) else (raw,)):
                if t is not None:
                    out.append(t.cpu())
        return out
    finally:
        os.environ.pop("MXNET_FUSED_TRAINER", None)
        fused_trainer.refresh_from_env()


def phase_gluon_fused_bitwise():
    """Each optimizer's fused Trainer step against its per-parameter loop
    on the card, weights and states after 3 steps, bit for bit (fp32,
    TF32 off)."""
    import mxnet_tpu_torch as mt
    tf32_flags()
    differ = []
    for name in FUSED_CHECK_OPTIMIZERS:
        a = gluon_fused_against_loop(mt.gpu(0), name, True)
        b = gluon_fused_against_loop(mt.gpu(0), name, False)
        if len(a) != len(b) or not all(torch.equal(x, y)
                                       for x, y in zip(a, b)):
            differ.append((name, max((x - y).abs().max().item()
                                     for x, y in zip(a, b))))
    log("Gluon Trainer on the card, fused step against the per-parameter "
        "loop, 3 steps of a 784-256-10 net, fp32: %d optimizers %s, "
        "bit for bit except %s" % (len(FUSED_CHECK_OPTIMIZERS),
                                   list(FUSED_CHECK_OPTIMIZERS), differ))
    if differ:
        raise AssertionError("fused Trainer step differs from the loop on "
                             "the card: %s" % differ)
    return len(FUSED_CHECK_OPTIMIZERS)


def phase_gluon_train(dtype, module_res):
    """ResNet-50 trained through Gluon at batch 32 on the card, captured
    (three replays a step: forward, backward, update) and eager in turn:
    ms/step, img/s, the share of peak and peak memory beside phase 10's
    Module figures (``module_res``); the loss must be finite, a moving
    statistic must move, the timed steps must trace nothing, make one
    fused update each and move the step counters as their mode does."""
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch.gluon import block, fused_trainer
    flags = tf32_flags() if dtype == torch.float32 else "bf16"
    gpu = mt.gpu(0)
    peak = PEAK_FLOPS[dtype]
    modes = {}
    for mode in STEP_MODES:
        net = gluon_resnet(gpu, dtype)
        trainer = gluon_trainer(net)
        loss_fn = mt.gluon.loss.SoftmaxCrossEntropyLoss()
        db = resnet_batch(gpu, RESNET_BATCH, dtype)
        res = {}

        def step():
            res["out"], res["loss"] = gluon_step(net, trainer, loss_fn, db)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with step_mode(mode):
            warm = _timed(step, RESNET_WARMUP)
            stat = next(p for n, p in net.collect_params().items()
                        if n.endswith("running_mean"))
            before = stat.data()._data.clone()
            block.reset_trace_count()
            fused_trainer.reset_update_counts()
            counts = counter_snapshot()
            times = _timed(step, RESNET_STEPS)
            counts = counter_delta(counts)
        traces = block.trace_count()
        fused = fused_trainer.fused_update_count()
        loop = fused_trainer.loop_update_count()
        loss = res["loss"]._data.float().mean().item()
        moved = (stat.data()._data != before).any().item()
        ms = sorted(times)[len(times) // 2]
        modes[mode] = dict(
            step_ms_median=ms, step_ms_first5=warm,
            img_s=RESNET_BATCH / ms * 1e3,
            train_peak_share=RESNET_TRAIN_FLOPS * RESNET_BATCH / ms * 1e3
            / peak, loss=loss, traces_timed=traces,
            fused_updates_per_step=fused / RESNET_STEPS, loop_updates=loop,
            peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
            timed_counts=counts)
        replays = 3 if mode == "captured" else 0
        want = dict(graph_captures=0,
                    graph_replays=replays * RESNET_STEPS,
                    program_calls=max(replays, 1) * RESNET_STEPS)
        log("Gluon ResNet-50 %s (%s) on %s, batch %d (hybridize, "
            "SoftmaxCrossEntropyLoss, Trainer sgd), %s: %d timed steps, "
            "ms/step median %.3f, first 5 (warm-up) %s, %.1f img/s, %.2f%% "
            "of the %g TFLOP/s peak at 24.6 GFLOP/img; Module (phase 10, "
            "%s) %.3f ms/step; timed steps' counters %s; loss after %d "
            "steps %.4f; %s moved: %s; traces in the timed steps %d; fused "
            "updates %d in %d steps, per-parameter updates %d; peak memory "
            "%.2f GB"
            % (DTYPE_NAME[dtype], flags, torch.cuda.get_device_name(0),
               RESNET_BATCH, mode, RESNET_STEPS, ms,
               ["%.1f" % t for t in warm], modes[mode]["img_s"],
               100 * modes[mode]["train_peak_share"], peak / 1e12, mode,
               (module_res if mode == "captured"
                else module_res["eager"])["step_ms_median"], counts,
               RESNET_WARMUP + RESNET_STEPS, loss, stat.name, moved, traces,
               fused, RESNET_STEPS, loop, modes[mode]["peak_mem_gb"]))
        if not math.isfinite(loss):
            raise AssertionError("non-finite Gluon ResNet-50 loss (%s, %s)"
                                 % (dtype, mode))
        if not moved:
            raise AssertionError("the Gluon BatchNorm moving statistics did "
                                 "not move (%s)" % mode)
        if traces != 0 or fused != RESNET_STEPS or loop != 0:
            raise AssertionError(
                "Gluon steps (%s): %d traces, %d fused updates and %d "
                "per-parameter updates in %d timed steps (want 0, %d, 0)"
                % (mode, traces, fused, loop, RESNET_STEPS, RESNET_STEPS))
        if counts != want:
            raise AssertionError("Gluon ResNet-50 %s steps: counters %s, "
                                 "want %s" % (mode, counts, want))
        del net, trainer, db, res, stat, step
        free_card()
    out = dict(dtype=DTYPE_NAME[dtype], flags=flags, batch=RESNET_BATCH,
               module_step_ms_median=module_res["step_ms_median"],
               module_img_s=module_res["img_s"], **modes["captured"])
    out["eager"] = modes["eager"]
    return out


# Captured against eager on one card (phase 17).  The fused update of every
# rule over Parameters of ResNet-50's shapes (the first convolution, a
# BatchNorm scale, a 1x1 convolution, the classifier), seeded gradients, lr
# halved each step by a FactorScheduler: the traced lr, wd, t and what the
# rules derive from them must replay one graph and round as the eager
# floats do.
CAPTURE_FUSED_STEPS = 6
CAPTURE_FUSED_SHAPES = ((64, 3, 7, 7), (64,), (2048, 512, 1, 1),
                        (1000, 2048), (1000,))
CAPTURE_FUSED_OPTIMIZERS = FUSED_CHECK_OPTIMIZERS
# A hybridized block called more than once in one recording: twice on two
# inputs (a shared-weight pair), or SHARED_UNROLL times on its own output
# (a cell over time steps).  Captured against eager, weights and
# gradients after SHARED_STEPS Trainer steps, to SHARED_REL, the fp32
# relative limit the port's Gluon Trainer is held to on the CPU
# (tests/test_torch_gluon_train.py).
SHARED_WIDTH, SHARED_BATCH, SHARED_UNROLL, SHARED_STEPS = 1024, 64, 3, 3
SHARED_REL = 1e-6


def fused_updates_run(dtype, name, mode):
    """CAPTURE_FUSED_STEPS ``Trainer.step``s of optimizer ``name`` in
    ``mode``; returns the weights and states after them and the captures
    of each step."""
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch.optimizer import _state_raw
    gen = torch.Generator(device="cuda").manual_seed(0)
    mt.random.seed(0)
    with mt.gpu(0):
        params = []
        for i, shape in enumerate(CAPTURE_FUSED_SHAPES):
            p = mt.gluon.Parameter("p%d_%s" % (i, "weight" if len(shape) > 1
                                              else "gamma"),
                                   shape=shape, dtype=dtype)
            p.initialize(mt.init.Xavier(), ctx=mt.gpu(0))
            params.append(p)
        sched = mt.lr_scheduler.FactorScheduler(step=1, factor=0.5)
        trainer = mt.gluon.Trainer(params, name, dict(
            learning_rate=0.1, wd=1e-4, lr_scheduler=sched,
            **CAPTURE_FUSED_OPTIMIZERS[name]))
        captures = []
        with step_mode(mode):
            for _ in range(CAPTURE_FUSED_STEPS):
                for p in params:
                    p.grad()._data.copy_(torch.randn(
                        p.shape, generator=gen, device="cuda").to(dtype))
                    p._fresh_grad = True
                before = counter_snapshot()
                trainer.step(RESNET_BATCH)
                captures.append(counter_delta(before)["graph_captures"])
        out = [p.data()._data.clone() for p in params]
        for i in sorted(trainer._updater.states):
            raw = _state_raw(trainer._updater.states[i])
            out += [t.clone() for t in (raw if isinstance(raw, tuple)
                                        else (raw,)) if t is not None]
    return out, captures


def shared_block_run(mode, unroll):
    """SHARED_STEPS Trainer steps of a hybridized Dense (tanh) called more
    than once in each recording, in ``mode``; returns the weights and
    gradients, the captures of each step and the block's program slots."""
    import mxnet_tpu_torch as mt
    gpu = mt.gpu(0)
    mt.random.seed(0)
    with mt.name.NameManager():
        net = mt.gluon.nn.HybridSequential()
        with net.name_scope():
            net.add(mt.gluon.nn.Dense(SHARED_WIDTH, activation="tanh",
                                      in_units=SHARED_WIDTH))
    net.initialize(mt.initializer.Xavier(), ctx=gpu)
    net.hybridize()
    params = list(net.collect_params().values())
    trainer = mt.gluon.Trainer(params, "sgd", {"learning_rate": 0.1})
    gen = torch.Generator(device="cuda").manual_seed(3)
    captures = []
    with step_mode(mode):
        for _ in range(SHARED_STEPS):
            x1, x2 = (mt.nd.NDArray(torch.randn(
                SHARED_BATCH, SHARED_WIDTH, generator=gen, device="cuda"), gpu)
                for _ in range(2))
            before = counter_snapshot()
            with mt.autograd.record():
                if unroll:
                    h = x1
                    for _ in range(SHARED_UNROLL):
                        h = net(h)
                    loss = (h * x2).sum()
                else:
                    loss = ((net(x1) - net(x2)) ** 2).sum()
            loss.backward()
            trainer.step(SHARED_BATCH)
            captures.append(counter_delta(before)["graph_captures"])
    out = [p.data()._data.clone() for p in params] \
        + [p.grad()._data.clone() for p in params]
    return out, captures, len(net._cached_op._programs)


def phase_capture_vs_eager(resnet_init):
    """Captured steps against ``capture.eager()`` on one card: the fused
    update of every rule bit for bit over CAPTURE_FUSED_STEPS scheduled
    steps (fp32 and bf16), one capture and then none; a block called
    more than once in one recording (a program a call, SHARED_REL); both LM
    step builders, 3 steps in fp32 and bf16, to ``LM_TRAIN_PARITY_TOL``
    (and whether bit for bit); ResNet-50 at batch 2 in fp64 through
    ``Module``, captured against eager beside eager against eager (cuDNN
    may sum with atomics), to ``RESNET_PARITY_TOL``."""
    tf32_flags()
    out, bad = {"fused": {}, "lm": {}}, []
    for dtype, name in itertools.product((torch.float32, torch.bfloat16),
                                         CAPTURE_FUSED_OPTIMIZERS):
        cap, caps = fused_updates_run(dtype, name, "captured")
        eag, _ = fused_updates_run(dtype, name, "eager")
        same = all(torch.equal(a, b) for a, b in zip(cap, eag))
        worst = max((a.double() - b.double()).abs().max().item()
                    for a, b in zip(cap, eag))
        key = "%s[%s]" % (name, DTYPE_NAME[dtype])
        out["fused"][key] = dict(bitwise=same, worst=worst, captures=caps)
        log("fused %s update, %d steps of a halving lr, captured against "
            "eager: bit for bit %s (largest |diff| %.3g); captures per step "
            "%s" % (key, CAPTURE_FUSED_STEPS, same, worst, caps))
        if not same or caps != [1] + [0] * (CAPTURE_FUSED_STEPS - 1):
            bad.append("fused " + key)
        free_card()
    out["shared_block"] = {}
    for unroll in (False, True):
        cap, caps, slots = shared_block_run("captured", unroll)
        eag, _, _ = shared_block_run("eager", unroll)
        rel = max(((a - b).abs().max() / b.abs().max()).item()
                  for a, b in zip(cap, eag))
        same = all(torch.equal(a, b) for a, b in zip(cap, eag))
        calls = SHARED_UNROLL if unroll else 2
        key = "unrolled x%d" % SHARED_UNROLL if unroll else "shared pair"
        # each call's forward and backward graphs, and the update
        want = [2 * calls + 1] + [0] * (SHARED_STEPS - 1)
        out["shared_block"][key] = dict(rel=rel, bitwise=same,
                                        captures=caps, slots=slots)
        log("Dense %d (tanh) called %d times in each recording (%s), %d "
            "Trainer steps, captured against eager: weights and gradients "
            "largest relative |diff| %.3g (limit %g), bit for bit %s; "
            "captures per step %s (want %s), program slots %d"
            % (SHARED_WIDTH, calls, key, SHARED_STEPS, rel, SHARED_REL,
               same, caps, want, slots))
        if rel > SHARED_REL or caps != want or slots != 2:
            bad.append("shared block " + key)
        free_card()
    params, tokens, labels = lm_train_parity_init()
    for dtype, builder in itertools.product(tuple(LM_TRAIN_PARITY_TOL),
                                            ("plain", "zero1")):
        cap = lm_train_run("cuda", dtype, builder, params, tokens, labels)
        with step_mode("eager"):
            eag = lm_train_run("cuda", dtype, builder, params, tokens,
                               labels)
        diffs = lm_train_diffs(cap, eag)
        worst = {k: max(d[k] for d in diffs) for k in diffs[0]}
        tol = LM_TRAIN_PARITY_TOL[dtype]
        key = "%s[%s]" % (builder, DTYPE_NAME[dtype])
        out["lm"][key] = dict(worst=worst,
                              bitwise=not any(worst.values()))
        log("LM step %s, %d steps, captured against eager: largest |diff| "
            "%s (limits %s), bit for bit %s"
            % (key, LM_TRAIN_PARITY_STEPS, worst, tol,
               out["lm"][key]["bitwise"]))
        bad += ["lm %s %s" % (key, k) for k in worst if worst[k] > tol[k]]
        free_card()
    import mxnet_tpu_torch as mt
    p64 = _cast_params(resnet_init, torch.float64)
    runs = {}
    for run in ("eager", "eager again", "captured"):
        with step_mode("eager" if run.startswith("eager") else "captured"):
            runs[run] = _resnet_two_steps(mt.gpu(0), torch.float64, p64)
        free_card()
    spread = _resnet_diffs(runs["eager again"], runs["eager"])
    diffs = _resnet_diffs(runs["captured"], runs["eager"])
    tol = RESNET_PARITY_TOL[torch.float64]
    out["resnet_fp64"] = dict(captured_eager=diffs, eager_eager=spread)
    log("ResNet-50 fp64, batch %d, 2 Module steps on the card: captured "
        "against eager %s, eager against eager %s (limits %s)"
        % (RESNET_PARITY_BATCH, diffs, spread, tol))
    bad += ["resnet fp64 " + k for k in diffs if diffs[k] > tol[k]]
    if bad:
        raise AssertionError("captured steps disagree with eager: %s" % bad)
    return out


# ResNet-50 through Module (phase 18) with rules other than SGD, whose
# fused updates read per-step scalars from the device table: Nadam (its
# momentum schedule, derived from t each step) and RMSProp (lr and wd
# only), lr lowered each step by a FactorScheduler: captured and eager,
# RULE_WARMUP then RULE_STEPS timed steps each, batch 32.
RULE_OPTIMIZERS = ("nadam", "rmsprop")
RULE_WARMUP, RULE_STEPS = 5, 10


def phase_resnet_rules(dtype):
    """ms/step, peak memory and the counters of the timed steps, captured
    against eager; the captured steps must replay one program a step and
    capture none, the loss stay finite."""
    import mxnet_tpu_torch as mt
    flags = tf32_flags() if dtype == torch.float32 else "bf16"
    gpu = mt.gpu(0)
    out = {}
    for name, mode in itertools.product(RULE_OPTIMIZERS, STEP_MODES):
        mod = resnet_module(gpu, RESNET_BATCH, dtype)
        sched = mt.lr_scheduler.FactorScheduler(step=1, factor=0.9)
        resnet_train_setup(mod, optimizer=name, optimizer_params=(
            ("learning_rate", 1e-3), ("wd", RESNET_WD),
            ("lr_scheduler", sched)))
        db = resnet_batch(gpu, RESNET_BATCH, dtype)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with step_mode(mode):
            warm = _timed(lambda: mod._fit_step(db), RULE_WARMUP)
            counts = counter_snapshot()
            times = _timed(lambda: mod._fit_step(db), RULE_STEPS)
            counts = counter_delta(counts)
        prob = mod.get_outputs()[0]._data
        label = db.label[0]._data.long()
        loss = -torch.log(prob.float().gather(1, label[:, None])).mean() \
            .item()
        ms = sorted(times)[len(times) // 2]
        res = out.setdefault(name, {})[mode] = dict(
            step_ms_median=ms, step_ms_first5=warm, loss=loss,
            peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
            timed_counts=counts)
        want = dict(graph_captures=0, program_calls=RULE_STEPS,
                    graph_replays=RULE_STEPS if mode == "captured" else 0)
        log("ResNet-50 %s (%s) through Module with %s, lr x0.9 a step, "
            "batch %d, %s: %d timed steps, ms/step median %.3f, first %d "
            "%s; timed steps' counters %s; loss %.4f; peak memory %.2f GB"
            % (DTYPE_NAME[dtype], flags, name, RESNET_BATCH, mode,
               RULE_STEPS, ms, RULE_WARMUP, ["%.1f" % t for t in warm],
               counts, loss, res["peak_mem_gb"]))
        if not math.isfinite(loss) or counts != want:
            raise AssertionError("ResNet-50 %s %s steps: loss %s, counters "
                                 "%s, want %s" % (name, mode, loss, counts,
                                                  want))
        del mod, db, prob
        free_card()
    return out


# -- phase 19: checkpoint and resume ------------------------------------------
# ResNet-50 trained CKPT_STEPS steps, checkpointed, trained CKPT_STEPS more
# (run A); a fresh Module or net and Trainer loads the checkpoint and trains
# the same CKPT_STEPS batches (the resume); a second uninterrupted run (run
# C) measures the card's own run-to-run spread.  The resume is held bit for
# bit to run A unless run C differs from run A too; then to run C's spread.
CKPT_STEPS = 3
CKPT_GLUON_ADAM = {"learning_rate": 1e-3, "wd": RESNET_WD}


def _host_copy(t):
    return t.detach().to("cpu", copy=True)


def _bit_gap(a, b):
    """Over the tensors of two {name: tensor} dicts: the elements whose bits
    differ, and the largest |a - b|."""
    ints = {2: torch.int16, 4: torch.int32, 8: torch.int64}
    differ, worst = 0, 0.0
    if sorted(a) != sorted(b):
        raise AssertionError("the runs hold different tensors: %s"
                             % sorted(set(a) ^ set(b))[:4])
    for k in a:
        x, y = a[k], b[k]
        if x.dtype != y.dtype or x.shape != y.shape:
            raise AssertionError("%s: %s %s against %s %s" % (
                k, x.dtype, tuple(x.shape), y.dtype, tuple(y.shape)))
        if not x.numel():
            continue
        it = ints[x.element_size()]
        differ += int((x.view(it) != y.view(it)).sum())
        worst = max(worst, float((x.double() - y.double()).abs().max()))
    return differ, worst


def module_train_state(mod):
    """Host copies of a Module's parameters, moving statistics and SGD
    momenta, by name."""
    arg, aux = mod.get_params()
    out = {"param:" + n: _host_copy(a._data) for n, a in arg.items()}
    out.update({"aux:" + n: _host_copy(a._data) for n, a in aux.items()})
    names = mod._exec_group.param_names
    if mod._update_on_kvstore:  # the store's Updater, keyed by name
        states = mod._kvstore._updater.states.items()
    else:
        states = ((names[i], s) for i, s in mod._updater.states.items())
    out.update({"momentum:" + n: _host_copy(s._data)
                for n, s in states if s is not None})
    return out


def gluon_train_state(net, trainer):
    """Host copies of a Gluon net's parameters and moving statistics and of
    its Trainer's states (Adam's mean and var), by name."""
    from mxnet_tpu_torch.optimizer import _state_raw, _state_tensors
    out = {("param:" if p.grad_req != "null" else "aux:") + n:
           _host_copy(p.data()._data)
           for n, p in net.collect_params().items()}
    for slot, state in trainer._updater.states.items():
        for j, t in enumerate(_state_tensors([_state_raw(state)])):
            out["state:%d.%d" % (slot, j)] = _host_copy(t)
    return out


def _steps(step, batches):
    """Run ``step`` on each batch; returns the step counters it moved."""
    before = counter_snapshot()
    for db in batches:
        step(db)
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return counter_delta(before)


def _timed_call(fn):
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def checkpoint_module_runs(ctx, dtype, tmp, batch=RESNET_BATCH,
                           image=RESNET_IMAGE, **model_kw):
    """Phase 19 (a): ResNet (``resnet_module``) through Module with SGD
    momentum, checkpointed after CKPT_STEPS steps with its optimizer
    states.  Returns the run A, resume and run C states, the reloaded
    files' arrays against the saved ones, the step counters after the
    checkpoint, the file sizes and the save and load seconds."""
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch.io import DataDesc
    classes = model_kw.get("classes", 1000)
    out_dtype = torch.float64 if dtype == torch.float64 else torch.float32
    batches = [resnet_batch(ctx, batch, dtype, image, classes, seed=s)
               for s in range(2 * CKPT_STEPS)]
    prefix = "%s/resnet-%s" % (tmp, DTYPE_NAME.get(dtype, str(dtype)))

    def fresh_run():
        mod = resnet_module(ctx, batch, dtype, image, **model_kw)
        resnet_train_setup(mod)
        return mod
    res = {}
    mod = fresh_run()
    _steps(mod._fit_step, batches[:CKPT_STEPS])
    _, res["save_s"] = _timed_call(lambda: mod.save_checkpoint(
        prefix, CKPT_STEPS, save_optimizer_states=True))
    saved = module_train_state(mod)
    names = list(mod._exec_group.param_names)
    res["counts_a"] = _steps(mod._fit_step, batches[CKPT_STEPS:])
    res["a"] = module_train_state(mod)
    del mod
    free_card_if_any()
    mod = fresh_run()
    _steps(mod._fit_step, batches)
    res["c"] = module_train_state(mod)
    del mod
    free_card_if_any()
    loaded, res["load_params_s"] = _timed_call(lambda: mt.mod.Module.load(
        prefix, CKPT_STEPS, load_optimizer_states=True, context=ctx))
    loaded.bind(data_shapes=[DataDesc("data", (batch, 3, image, image),
                                      dtype=dtype)],
                label_shapes=[DataDesc("softmax_label", (batch,),
                                       dtype=out_dtype)])
    _, res["load_states_s"] = _timed_call(lambda: loaded.init_optimizer(
        optimizer="sgd", optimizer_params=(
            ("learning_rate", RESNET_LR), ("momentum", RESNET_MOMENTUM),
            ("wd", RESNET_WD))))
    res["counts_resumed"] = _steps(loaded._fit_step, batches[CKPT_STEPS:])
    res["resumed"] = module_train_state(loaded)
    del loaded
    free_card_if_any()
    files = {ext: "%s-%04d.%s" % (prefix, CKPT_STEPS, ext)
             for ext in ("params", "states")}
    files["json"] = prefix + "-symbol.json"
    res["bytes"] = {k: os.path.getsize(f) for k, f in files.items()}
    back = {("param:" if k.startswith("arg:") else "aux:") + k[4:]:
            a._data for k, a in mt.nd.load(files["params"]).items()}
    upd = mt.optimizer.get_updater(mt.optimizer.SGD())
    with open(files["states"], "rb") as f:
        upd.set_states(f.read())
    back.update({"momentum:" + names[i]: s._data
                 for i, s in upd.states.items() if s is not None})
    res["file_gap"] = _bit_gap(saved, back)
    return res


def checkpoint_gluon_runs(ctx, dtype, tmp, batch=RESNET_BATCH,
                          image=RESNET_IMAGE, **model_kw):
    """Phase 19 (b): the hybridized ResNet of phase 16 (``gluon_resnet``)
    trained by ``Trainer("adam")``, checkpointed through
    ``Block.save_params`` and ``Trainer.save_states``, resumed in a fresh
    net and Trainer; returns what ``checkpoint_module_runs`` returns."""
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import _pickle
    classes = model_kw.get("classes", 1000)
    batches = [resnet_batch(ctx, batch, dtype, image, classes, seed=s)
               for s in range(2 * CKPT_STEPS)]
    loss_fn = mt.gluon.loss.SoftmaxCrossEntropyLoss()
    prefix = "%s/gluon-%s" % (tmp, DTYPE_NAME.get(dtype, str(dtype)))
    files = {"params": prefix + ".params", "states": prefix + ".states"}

    def fresh_run():
        net = gluon_resnet(ctx, dtype, **model_kw)
        return net, mt.gluon.Trainer(net.collect_params(), "adam",
                                     dict(CKPT_GLUON_ADAM))

    def stepper(net, trainer):
        return lambda db: gluon_step(net, trainer, loss_fn, db)
    res = {}
    net, trainer = fresh_run()
    _steps(stepper(net, trainer), batches[:CKPT_STEPS])

    def save():
        net.save_params(files["params"])
        trainer.save_states(files["states"])
    _, res["save_s"] = _timed_call(save)
    saved = gluon_train_state(net, trainer)
    strip = net.prefix
    res["counts_a"] = _steps(stepper(net, trainer), batches[CKPT_STEPS:])
    res["a"] = gluon_train_state(net, trainer)
    del net, trainer
    free_card_if_any()
    net, trainer = fresh_run()
    _steps(stepper(net, trainer), batches)
    res["c"] = gluon_train_state(net, trainer)
    del net, trainer
    free_card_if_any()
    net, trainer = fresh_run()
    _, res["load_params_s"] = _timed_call(
        lambda: net.load_params(files["params"]))
    _, res["load_states_s"] = _timed_call(
        lambda: trainer.load_states(files["states"]))
    if trainer._optimizer.num_update != CKPT_STEPS:
        raise AssertionError("the resumed Trainer's update count is %d, want "
                             "%d" % (trainer._optimizer.num_update,
                                     CKPT_STEPS))
    res["counts_resumed"] = _steps(stepper(net, trainer),
                                   batches[CKPT_STEPS:])
    res["resumed"] = gluon_train_state(net, trainer)
    del net, trainer
    free_card_if_any()
    res["bytes"] = {k: os.path.getsize(f) for k, f in files.items()}
    back = {}
    for k, a in mt.nd.load(files["params"]).items():
        kind = "param:" if "param:" + strip + k in saved else "aux:"
        back[kind + strip + k] = a._data
    with open(files["states"], "rb") as f:
        payload = _pickle.loads(f.read())
    upd = mt.optimizer.get_updater(mt.optimizer.Adam())
    upd.set_states(payload["updater"])
    from mxnet_tpu_torch.optimizer import _state_raw, _state_tensors
    for slot, state in upd.states.items():
        for j, t in enumerate(_state_tensors([_state_raw(state)])):
            back["state:%d.%d" % (slot, j)] = t
    res["file_gap"] = _bit_gap(saved, back)
    if payload["num_update"] != CKPT_STEPS:
        raise AssertionError("the states file holds num_update %s, want %d"
                             % (payload["num_update"], CKPT_STEPS))
    return res


def free_card_if_any():
    if torch.cuda.is_available():
        free_card()
    else:
        gc.collect()


def resume_verdict(what, res, replays_per_step):
    """Hold a resume (``checkpoint_*_runs``) to run A: bit for bit, or
    within run C's gap from run A where the card's own runs differ; the
    files' arrays bit for bit; the resumed steps one capture of each
    program then replays, run A's none.  Returns the summary."""
    resume_gap = _bit_gap(res["a"], res["resumed"])
    spread = _bit_gap(res["a"], res["c"])
    n = CKPT_STEPS * replays_per_step
    want_a = dict(graph_captures=0, graph_replays=n, program_calls=n)
    want_r = dict(graph_captures=replays_per_step, graph_replays=n,
                  program_calls=n)
    summary = dict(
        resume_bits_differ=resume_gap[0], resume_max_abs=resume_gap[1],
        rerun_bits_differ=spread[0], rerun_max_abs=spread[1],
        bitwise=resume_gap[0] == 0, file_bits_differ=res["file_gap"][0],
        counts_after_save=res["counts_a"],
        counts_resumed=res["counts_resumed"], bytes=res["bytes"],
        save_s=res["save_s"], load_params_s=res["load_params_s"],
        load_states_s=res["load_states_s"], tensors=len(res["a"]))
    log("%s: resumed against uninterrupted: %d elements differ in their "
        "bits (max |diff| %.3g); two uninterrupted runs: %d (%.3g); files "
        "against the saved arrays: %d; counters after the checkpoint %s, "
        "resumed %s; files %s bytes; save %.3f s, load params %.3f s, "
        "states %.3f s" % (
            what, resume_gap[0], resume_gap[1], spread[0], spread[1],
            res["file_gap"][0], res["counts_a"], res["counts_resumed"],
            res["bytes"], res["save_s"], res["load_params_s"],
            res["load_states_s"]))
    if res["file_gap"][0]:
        raise AssertionError("%s: %d elements reloaded from the files differ "
                             "from the saved ones" % (what,
                                                      res["file_gap"][0]))
    if resume_gap[0] and resume_gap[1] > spread[1]:
        raise AssertionError(
            "%s: the resumed run lies %.3g from the uninterrupted one, "
            "beyond the %.3g between two uninterrupted runs"
            % (what, resume_gap[1], spread[1]))
    graphs = capture_active()
    if graphs and (res["counts_a"] != want_a
                   or res["counts_resumed"] != want_r):
        raise AssertionError("%s: counters after the checkpoint %s (want "
                             "%s), resumed %s (want %s)" % (
                                 what, res["counts_a"], want_a,
                                 res["counts_resumed"], want_r))
    return summary


def capture_active():
    """Whether this run's steps capture (on the card, or on the CPU under
    ``capture.stand_in``)."""
    from mxnet_tpu_torch import capture
    return capture.graph_for("cuda" if torch.cuda.is_available()
                             else "cpu") is not None


def nd_save_load_timing(tmp, dtype):
    """GPT-2 small's parameters (``GPT2_SMALL``, seeded) on the card in
    ``dtype``: ``nd.save`` of them (each copied to the host once) and
    ``nd.load`` back to host arrays, timed, and the loaded bits against
    the saved ones."""
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch.models import transformer as tr
    cfg = tr.TransformerLMConfig(dtype=torch.float32, **GPT2_SMALL)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = {n: t.to(dtype) for n, t in
              tr.init_transformer_params(gen, cfg).items()}
    arrays = {n: mt.nd.NDArray(t, mt.gpu(0)) for n, t in params.items()}
    fname = "%s/gpt2-%s.params" % (tmp, DTYPE_NAME[dtype])
    _, save_s = _timed_call(lambda: mt.nd.save(fname, arrays))
    back, load_s = _timed_call(lambda: mt.nd.load(fname))
    gap = _bit_gap({n: t.cpu() for n, t in params.items()},
                   {n: a._data for n, a in back.items()})
    size = os.path.getsize(fname)
    os.remove(fname)
    res = dict(params=sum(t.numel() for t in params.values()), bytes=size,
               save_s=save_s, load_s=load_s, bits_differ=gap[0],
               save_gb_s=size / save_s / 1e9, load_gb_s=size / load_s / 1e9)
    log("nd.save / nd.load of GPT-2 small's %d parameters in %s (%d bytes) "
        "on %s: save %.3f s (%.2f GB/s), load %.3f s (%.2f GB/s); %d "
        "elements differ in their bits" % (
            res["params"], DTYPE_NAME[dtype], size,
            torch.cuda.get_device_name(0), save_s, res["save_gb_s"], load_s,
            res["load_gb_s"], gap[0]))
    if gap[0]:
        raise AssertionError("nd.load gave other bits than nd.save wrote "
                             "(%s)" % DTYPE_NAME[dtype])
    del params, arrays, back
    free_card()
    return res


def phase_checkpoint(card):
    """Phase 19: ResNet-50 Module (SGD momentum) and Gluon (Adam) resumed
    from a checkpoint on the card, in fp32 (TF32 off) and bf16, with
    cuDNN in its deterministic mode for this phase; the files' sizes and
    the save and load seconds; GPT-2 small's parameters through
    ``nd.save``/``nd.load`` in fp32, bf16 and fp16."""
    import tempfile
    import mxnet_tpu_torch as mt
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    out = {"card": card, "steps": CKPT_STEPS, "batch": RESNET_BATCH,
           "cudnn_deterministic": True}
    try:
        with tempfile.TemporaryDirectory() as tmp:
            for dtype in (torch.float32, torch.bfloat16):
                flags = tf32_flags() if dtype == torch.float32 else "bf16"
                for kind, runs, replays in (
                        ("module_sgd", checkpoint_module_runs, 1),
                        ("gluon_adam", checkpoint_gluon_runs, 3)):
                    what = "phase 19 ResNet-50 %s %s (%s), batch %d, on %s" \
                        % (kind, DTYPE_NAME[dtype], flags, RESNET_BATCH,
                           card)
                    res = runs(mt.gpu(0), dtype, tmp)
                    out.setdefault(kind, {})[DTYPE_NAME[dtype]] = \
                        resume_verdict(what, res, replays)
                    del res
                    free_card()
            out["nd_save_load"] = {DTYPE_NAME[dt]: nd_save_load_timing(
                tmp, dt) for dt in (torch.float32, torch.bfloat16,
                                    torch.float16)}
    finally:
        torch.backends.cudnn.deterministic = prev
    return out


# -- phase 20: the vision zoo at full width -----------------------------------
# The reference's published per-GPU training configurations
# (example/image-classification/README.md): Inception-v3 at batch 32
# (299 x 299) and AlexNet at batch 512 (224 x 224), 1000 classes.
# Inception-v3 goes through Module as examples/train_inception_v3.py
# builds it (SGD lr 0.05, momentum 0.9, wd 1e-4, Xavier), AlexNet through
# Gluon.  FLOPs counted from the graph's convolution and FC shapes (a
# multiply-add is two): forward 11.46 GFLOP/img for Inception-v3 and 1.43
# for AlexNet; a training step is three forwards.
INCEPTION_BATCH, INCEPTION_IMAGE, INCEPTION_LR = 32, 299, 0.05
ALEXNET_BATCH, ALEXNET_IMAGE = 512, 224
ZOO_WARMUP, ZOO_STEPS = 5, 30
ZOO_FWD_FLOPS = {"inceptionv3": 11.46e9, "alexnet": 1.43e9}
# scoring at batch 32, 224 x 224, median of 10 forwards after 3
ZOO_SCORE_MODELS = ("vgg16", "vgg16_bn", "densenet121", "squeezenet1.1",
                    "mobilenet1.0")
ZOO_SCORE_BATCH, ZOO_SCORE_RUNS = 32, 10
# card against CPU (d): one model of each family, batch 2, fp64, one init,
# every Dropout rate 0.  Each limit lies about two orders of magnitude
# above the largest difference of the sound runs on the H100 and far below
# what a fault reads.  The forward in predict mode, 1e-13 of
# max(1, |logit|) (read: at most 5.7e-16).  The gradients of one SGD
# step, relative to the largest gradient of their parameter, 1e-8 (read:
# at most 2.4e-10, fp64 sums in other orders amplified by BatchNorm over
# two samples).  The weights and the moving statistics after the step,
# 1e-10 of max(1, |value|) (read: at most 9.8e-13 and 3.7e-14); the
# weight-decay share of the step alone, lr * wd * |w|, is about 1e-6, and
# a moving statistic's share of the batch's is 0.1 of it.
ZOO_PARITY_MODELS = (("alexnet", 224), ("vgg11", 224),
                     ("inceptionv3", 299), ("densenet121", 224),
                     ("squeezenet1.1", 224), ("mobilenet1.0", 224))
ZOO_PARITY_TOL = dict(logits=1e-13, grads=1e-8, params=1e-10, aux=1e-10)


def _median(times):
    return sorted(times)[len(times) // 2]


def zoo_inception_train(card, dtype):
    """(a) Inception-v3 through Module at batch 32, captured and eager."""
    import mxnet_tpu_torch as mt
    flags = tf32_flags() if dtype == torch.float32 else "bf16"
    gpu = mt.gpu(0)
    peak = PEAK_FLOPS[dtype]
    train_flops = 3 * ZOO_FWD_FLOPS["inceptionv3"]
    modes = {}
    for mode in STEP_MODES:
        mod = resnet_module(gpu, INCEPTION_BATCH, dtype,
                            image=INCEPTION_IMAGE, model="inceptionv3")
        resnet_train_setup(mod, optimizer_params=(
            ("learning_rate", INCEPTION_LR), ("momentum", RESNET_MOMENTUM),
            ("wd", RESNET_WD)))
        db = resnet_batch(gpu, INCEPTION_BATCH, dtype,
                          image=INCEPTION_IMAGE)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with step_mode(mode):
            warm = _timed(lambda: mod._fit_step(db), ZOO_WARMUP)
            step = mod._cached_step
            if step is None or not step._draws:
                raise AssertionError("Inception-v3 step: CachedTrainStep %s, "
                                     "its Dropout not drawing"
                                     % ("missing" if step is None else "on"))
            counts = counter_snapshot()
            times = _timed(lambda: mod._fit_step(db), ZOO_STEPS)
            counts = counter_delta(counts)
        prob = mod.get_outputs()[0]._data
        label = db.label[0]._data.long()
        loss = -torch.log(prob.float().gather(1, label[:, None])).mean() \
            .item()
        ms = _median(times)
        modes[mode] = dict(
            step_ms_median=ms, step_ms_first5=warm,
            img_s=INCEPTION_BATCH / ms * 1e3,
            train_peak_share=train_flops * INCEPTION_BATCH / ms * 1e3 / peak,
            loss=loss, peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
            timed_counts=counts)
        want = dict(graph_captures=0, program_calls=ZOO_STEPS,
                    graph_replays=ZOO_STEPS if mode == "captured" else 0)
        log("phase 20a Inception-v3 %s (%s) on %s, batch %d at %d x %d "
            "through Module (SGD lr %g), %s: ms/step median %.3f, first 5 "
            "%s, %.1f img/s, %.2f%% of the %g TFLOP/s peak at %.1f "
            "GFLOP/img; timed steps' counters %s; loss %.4f; peak memory "
            "%.2f GB"
            % (DTYPE_NAME[dtype], flags, card, INCEPTION_BATCH,
               INCEPTION_IMAGE, INCEPTION_IMAGE, INCEPTION_LR, mode, ms,
               ["%.1f" % t for t in warm], modes[mode]["img_s"],
               100 * modes[mode]["train_peak_share"], peak / 1e12,
               train_flops / 1e9, counts, loss, modes[mode]["peak_mem_gb"]))
        if not math.isfinite(loss):
            raise AssertionError("non-finite Inception-v3 loss (%s, %s)"
                                 % (dtype, mode))
        if counts != want:
            raise AssertionError("Inception-v3 %s steps: counters %s, want "
                                 "%s" % (mode, counts, want))
        del mod, db, prob, step
        free_card()
    out = dict(dtype=DTYPE_NAME[dtype], flags=flags, batch=INCEPTION_BATCH,
               image=INCEPTION_IMAGE, **modes["captured"])
    out["eager"] = modes["eager"]
    return out


def _probe_masks(drop, x, mode):
    """One recorded call of the hybridized Dropout block ``drop`` on ``x``
    (which has a gradient buffer) and its backward with a head of ones:
    the output's zero pattern and the gradient's, as bool tensors."""
    import mxnet_tpu_torch as mt
    with step_mode(mode):
        with mt.autograd.record():
            y = drop(x)
        y.backward(mt.nd.ones(y.shape, ctx=x.context, dtype=x.dtype))
    return (y._data == 0), (x.grad._data == 0)


def zoo_dropout_checks(net, dtype):
    """(b)'s mask checks on AlexNet's own first Dropout block, called alone
    at the classifier's shape (batch x 4096) as a hybridized block: two
    consecutive replays draw different masks; the kept fraction lies
    within 5 sigma of 0.5; the forward's zeros are the backward's; and,
    from one generator state, whether the eager call and the captured
    replay draw the same mask."""
    import mxnet_tpu_torch as mt
    gpu = mt.gpu(0)
    drop = net.classifier[1]
    drop.hybridize()
    x = mt.nd.array(np.ones((ALEXNET_BATCH, 4096), np.float32), ctx=gpu,
                    dtype=dtype)
    x.attach_grad()
    gen = mt.random.generator(gpu)
    state = gen.get_state()
    eager_fwd, _ = _probe_masks(drop, x, "eager")
    gen.set_state(state)
    counts = counter_snapshot()
    first_fwd, first_bwd = _probe_masks(drop, x, "captured")
    second_fwd, second_bwd = _probe_masks(drop, x, "captured")
    counts = counter_delta(counts)
    n = first_fwd.numel()
    kept = 1.0 - first_fwd.float().mean().item()
    sigma = math.sqrt(0.25 / n)
    res = dict(
        shape=[ALEXNET_BATCH, 4096], kept_fraction=kept,
        kept_sigmas=abs(kept - 0.5) / sigma,
        replays_differ=bool((first_fwd != second_fwd).any().item()),
        fwd_zeros_are_bwd_zeros=bool(torch.equal(first_fwd, first_bwd)
                                     and torch.equal(second_fwd, second_bwd)),
        eager_equals_captured=bool(torch.equal(eager_fwd, first_fwd)),
        counts=counts)
    if not res["replays_differ"]:
        raise AssertionError("two replays of the captured Dropout drew the "
                             "same mask")
    if res["kept_sigmas"] > 5:
        raise AssertionError("Dropout kept %.5f of %d, %.1f sigma from 0.5"
                             % (kept, n, res["kept_sigmas"]))
    if not res["fwd_zeros_are_bwd_zeros"]:
        raise AssertionError("the captured Dropout's backward zeros are not "
                             "its forward's")
    return res


def zoo_alexnet_train(card, dtype):
    """(b) AlexNet through Gluon at batch 512, both Dropouts live, captured
    and eager; the mask checks; two recorded forwards of one batch differ
    (fresh masks in the whole net) and two predict-mode forwards do not."""
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch.gluon import block, fused_trainer
    flags = tf32_flags() if dtype == torch.float32 else "bf16"
    gpu = mt.gpu(0)
    peak = PEAK_FLOPS[dtype]
    train_flops = 3 * ZOO_FWD_FLOPS["alexnet"]
    modes = {}
    for mode in STEP_MODES:
        net = gluon_resnet(gpu, dtype, model="alexnet")
        trainer = gluon_trainer(net)
        loss_fn = mt.gluon.loss.SoftmaxCrossEntropyLoss()
        db = resnet_batch(gpu, ALEXNET_BATCH, dtype, image=ALEXNET_IMAGE)
        res = {}

        def step():
            res["out"], res["loss"] = gluon_step(net, trainer, loss_fn, db)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with step_mode(mode):
            warm = _timed(step, ZOO_WARMUP)
            block.reset_trace_count()
            fused_trainer.reset_update_counts()
            counts = counter_snapshot()
            times = _timed(step, ZOO_STEPS)
            counts = counter_delta(counts)
            traces = block.trace_count()
            fused = fused_trainer.fused_update_count()
            x = db.data[0]
            with mt.autograd.record():
                a = net(x)._data.clone()
            with mt.autograd.record():
                b = net(x)._data.clone()
            c, d = net(x)._data.clone(), net(x)._data.clone()
        loss = res["loss"]._data.float().mean().item()
        ms = _median(times)
        modes[mode] = dict(
            step_ms_median=ms, step_ms_first5=warm,
            img_s=ALEXNET_BATCH / ms * 1e3,
            train_peak_share=train_flops * ALEXNET_BATCH / ms * 1e3 / peak,
            loss=loss, peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
            timed_counts=counts, traces_timed=traces,
            fused_updates_per_step=fused / ZOO_STEPS,
            recorded_forwards_differ=bool((a != b).any().item()),
            predict_forwards_equal=bool(torch.equal(c, d)))
        replays = 3 if mode == "captured" else 0
        want = dict(graph_captures=0, graph_replays=replays * ZOO_STEPS,
                    program_calls=max(replays, 1) * ZOO_STEPS)
        log("phase 20b AlexNet %s (%s) on %s, batch %d at %d x %d through "
            "Gluon (hybridize, SoftmaxCrossEntropyLoss, Trainer sgd), "
            "Dropout live, %s: ms/step median %.3f, first 5 %s, %.1f img/s, "
            "%.2f%% of the %g TFLOP/s peak at %.2f GFLOP/img; timed steps' "
            "counters %s; traces %d; loss %.4f; two recorded forwards "
            "differ: %s, two predict forwards equal: %s; peak memory "
            "%.2f GB"
            % (DTYPE_NAME[dtype], flags, card, ALEXNET_BATCH, ALEXNET_IMAGE,
               ALEXNET_IMAGE, mode, ms, ["%.1f" % t for t in warm],
               modes[mode]["img_s"], 100 * modes[mode]["train_peak_share"],
               peak / 1e12, train_flops / 1e9, counts, traces, loss,
               modes[mode]["recorded_forwards_differ"],
               modes[mode]["predict_forwards_equal"],
               modes[mode]["peak_mem_gb"]))
        if not math.isfinite(loss):
            raise AssertionError("non-finite AlexNet loss (%s, %s)"
                                 % (dtype, mode))
        if counts != want or traces != 0 or fused != ZOO_STEPS:
            raise AssertionError(
                "AlexNet %s steps: counters %s (want %s), %d traces, %d "
                "fused updates in %d steps" % (mode, counts, want, traces,
                                               fused, ZOO_STEPS))
        if not modes[mode]["recorded_forwards_differ"] \
                or not modes[mode]["predict_forwards_equal"]:
            raise AssertionError("AlexNet's Dropout (%s): recorded forwards "
                                 "must differ and predict forwards agree"
                                 % mode)
        if mode == "captured":
            masks = zoo_dropout_checks(net, dtype)
            log("phase 20b AlexNet %s Dropout masks at %s: kept %.5f (%.2f "
                "sigma), replays differ %s, forward zeros are backward zeros "
                "%s, eager call and captured replay from one generator state "
                "draw the same mask: %s; counters %s"
                % (DTYPE_NAME[dtype], masks["shape"], masks["kept_fraction"],
                   masks["kept_sigmas"], masks["replays_differ"],
                   masks["fwd_zeros_are_bwd_zeros"],
                   masks["eager_equals_captured"], masks["counts"]))
        del net, trainer, db, res, step, a, b, c, d, x
        free_card()
    out = dict(dtype=DTYPE_NAME[dtype], flags=flags, batch=ALEXNET_BATCH,
               image=ALEXNET_IMAGE, masks=masks, **modes["captured"])
    out["eager"] = modes["eager"]
    return out


def zoo_scoring(card, dtype):
    """(c) Scoring at batch 32, 224 x 224: a hybridized net in predict mode,
    one captured forward a call; median of 10 after 3."""
    import mxnet_tpu_torch as mt
    flags = tf32_flags() if dtype == torch.float32 else "bf16"
    gpu = mt.gpu(0)
    out = {}
    for name in ZOO_SCORE_MODELS:
        net = gluon_resnet(gpu, dtype, model=name)
        x = resnet_batch(gpu, ZOO_SCORE_BATCH, dtype).data[0]
        _timed(lambda: net(x), 3)
        times = _timed(lambda: net(x), ZOO_SCORE_RUNS)
        logits = net(x)._data.float()
        ms = _median(times)
        out[name] = dict(ms_median=ms, img_s=ZOO_SCORE_BATCH / ms * 1e3,
                         finite=bool(torch.isfinite(logits).all().item()))
        log("phase 20c %s scoring %s (%s) on %s, batch %d at 224 x 224: "
            "%.3f ms/batch median of %d, %.1f img/s"
            % (name, DTYPE_NAME[dtype], flags, card, ZOO_SCORE_BATCH, ms,
               ZOO_SCORE_RUNS, out[name]["img_s"]))
        if not out[name]["finite"]:
            raise AssertionError("%s scored non-finite logits" % name)
        del net, x, logits
        free_card()
    return out


def _zoo_parity_run(ctx, name, size, params, x, y):
    """Predict-mode logits, then one SGD step's gradients and the weights
    and moving statistics after it, fp64 on the CPU."""
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch.test_utils import set_dropout
    net = gluon_resnet(ctx, torch.float64, params=params, model=name)
    set_dropout(net, 0.0)
    trainer = gluon_trainer(net)
    loss_fn = mt.gluon.loss.SoftmaxCrossEntropyLoss()
    xs = mt.nd.array(x, ctx=ctx, dtype="float64")
    ys = mt.nd.array(y, ctx=ctx, dtype="float64")
    logits = net(xs)._data.to("cpu", copy=True)
    with mt.autograd.record():
        loss = loss_fn(net(xs), ys)
    loss.backward()
    trainer.step(x.shape[0])
    ps = net.collect_params().items()
    return dict(
        logits=logits,
        grads={n: p.grad()._data.to("cpu", copy=True) for n, p in ps
               if p.grad_req != "null"},
        params={n: p.data()._data.to("cpu", copy=True) for n, p in ps
                if p.grad_req != "null"},
        aux={n: p.data()._data.to("cpu", copy=True) for n, p in ps
             if p.grad_req == "null"})


def zoo_card_vs_cpu(card):
    """(d) One model of each family, batch 2, fp64, card against CPU."""
    import mxnet_tpu_torch as mt
    out = {}
    for name, size in ZOO_PARITY_MODELS:
        rng = np.random.RandomState(0)
        x = rng.rand(2, 3, size, size)
        y = rng.randint(0, 1000, 2).astype(np.float64)
        with mt.name.NameManager():
            init = mt.gluon.model_zoo.vision.get_model(name, classes=1000)
        init.cast("float64")
        mt.random.seed(0)
        init.initialize(mt.initializer.Xavier(), ctx=mt.cpu())
        init(mt.nd.array(x, ctx=mt.cpu(), dtype="float64"))
        params = ({n: p.data() for n, p in init.collect_params().items()},
                  {})
        cpu = _zoo_parity_run(mt.cpu(), name, size, params, x, y)
        gpu = _zoo_parity_run(mt.gpu(0), name, size, params, x, y)

        def worst(key, relative=False):
            a, b = cpu[key], gpu[key]
            if not isinstance(a, dict):
                return ((a - b).abs().max()
                        / max(1.0, a.abs().max().item())).item()
            return max((((a[n] - b[n]).abs().max()
                         / (max(a[n].abs().max().item(), 1e-30) if relative
                            else max(1.0, a[n].abs().max().item()))).item()
                        for n in a), default=0.0)
        diffs = dict(logits=worst("logits"), grads=worst("grads", True),
                     params=worst("params"), aux=worst("aux"))
        out[name] = diffs
        log("phase 20d %s card against CPU, fp64, batch 2 at %d x %d, "
            "Dropout 0, on %s: %s (limits %s)"
            % (name, size, size, card,
               {k: "%.3g" % v for k, v in diffs.items()}, ZOO_PARITY_TOL))
        bad = [k for k, v in diffs.items() if not v <= ZOO_PARITY_TOL[k]]
        if bad:
            raise AssertionError("%s on the card disagrees with the CPU: %s"
                                 % (name, bad))
        del init, cpu, gpu, params
        free_card()
    return out


def phase_zoo(card):
    """Phase 20: (a) Inception-v3 through Module, (b) AlexNet through Gluon
    with live Dropout, (c) scoring, (d) card against CPU."""
    res = {"card": card}
    res["inceptionv3_module"] = {DTYPE_NAME[dt]: zoo_inception_train(card, dt)
                                 for dt in (torch.float32, torch.bfloat16)}
    res["alexnet_gluon"] = {DTYPE_NAME[dt]: zoo_alexnet_train(card, dt)
                            for dt in (torch.float32, torch.bfloat16)}
    res["scoring"] = {DTYPE_NAME[dt]: zoo_scoring(card, dt)
                      for dt in (torch.float32, torch.bfloat16)}
    res["card_vs_cpu_fp64"] = zoo_card_vs_cpu(card)
    return res


# -- phase 21: the op sweep ---------------------------------------------------
# Every op of the elemwise, reduce, matrix and nn modules on the card
# against the CPU from the same seeded inputs (test_utils.op_cases: the
# cases and their tolerances), fp32 with TF32 off, forward and gradients;
# the unary, reduce, dot and batch_dot cases again in bf16 (BF16_TOL).
# Each random op draws 10^6 samples on the card, whose mean and variance
# must lie within OP_RANDOM_K standard errors of the distribution's own.
OP_RANDOM_N, OP_RANDOM_K = 10 ** 6, 5.0


def _tol_ratio(got, want, tol):
    """The largest |got - want| / (atol + rtol |want|): 1 is the limit."""
    if got.shape != want.shape:
        return math.inf
    both_nan = np.isnan(got) & np.isnan(want)
    same_inf = np.isinf(want) & (got == want)
    with np.errstate(invalid="ignore"):
        err = np.where(both_nan | same_inf, 0.0, np.abs(got - want))
    lim = tol["atol"] + tol["rtol"] * np.where(np.isfinite(want),
                                                np.abs(want), 0.0)
    return float(np.max(err / lim)) if err.size else 0.0


def phase_op_sweep(card):
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import test_utils
    flags = tf32_flags()
    held, rows = 0, []
    t0 = time.perf_counter()
    for dtype in ("float32", "bfloat16"):
        for case in test_utils.op_cases():
            if dtype == "bfloat16" and not case["bf16"]:
                continue
            tol = case["tol"] if dtype == "float32" else test_utils.BF16_TOL
            cpu = test_utils.run_op_case(mt, case, mt.cpu(), dtype)
            gpu = test_utils.run_op_case(mt, case, mt.gpu(0), dtype)
            ratio = max([_tol_ratio(g, c, tol) for g, c in
                         zip(gpu[0] + gpu[1], cpu[0] + cpu[1])] or [0.0])
            if len(gpu[0]) != len(cpu[0]):
                ratio = math.inf
            rows.append(("%s %s" % (case["name"], dtype), ratio))
            held += int(ratio <= 1.0)
    random_rows = []
    for name, draw, mean, var in test_utils.random_cases():
        mt.random.seed(21)
        samples = draw(mt.nd, OP_RANDOM_N, mt.gpu(0))
        if samples.context != mt.gpu(0):
            raise AssertionError("%s drew on %s" % (name, samples.context))
        errs = [float(e) for e in test_utils.moment_errors(
            samples.asnumpy(), mean, var)]
        random_rows.append((name, errs))
        held += int(max(errs) <= OP_RANDOM_K)
    seconds = time.perf_counter() - t0
    rows.sort(key=lambda r: -r[1])
    bad = [r for r in rows if not r[1] <= 1.0] + [
        r for r in random_rows if not max(r[1]) <= OP_RANDOM_K]
    log("phase 21 op sweep on %s (%s): %d deterministic cases (fp32 and "
        "bf16) and %d random ops held, %.1f s; worst cases (error over "
        "limit) %s; random ops' mean and variance in standard errors %s"
        % (card, flags, len(rows), len(random_rows), seconds,
           [(n, "%.3g" % r) for n, r in rows[:5]],
           [(n, "%.2f" % e[0], "%.2f" % e[1]) for n, e in random_rows]))
    if bad:
        raise AssertionError("ops on the card disagree with the CPU: %s"
                             % bad)
    return dict(held=held, cases=len(rows), random=len(random_rows),
                seconds=seconds,
                worst=[[n, r] for n, r in rows[:5]],
                random_moments={n: list(e) for n, e in random_rows})



# -- phases 22-25: recurrent nets ---------------------------------------------
# The reference's PTB LSTM (BASELINE.json:9, workload #3) at its published
# widths.  (a) MXNet's example/rnn/bucketing/lstm_bucketing.py: 2 LSTMCells
# of 200 (``SequentialRNNCell``), Embedding 200, FullyConnected to the
# vocabulary + 1 (id 0 pads), SoftmaxOutput ignoring label 0, batch 32,
# buckets 10-60 through ``BucketSentenceIter(invalid_label=0)``,
# ``BucketingModule.fit`` with SGD lr 0.01, momentum 0, wd 1e-5, Xavier
# (factor "in", magnitude 2.34) and ``Perplexity(ignore_label=0)``; again
# with ``FusedRNNCell(200, num_layers=2)``, its cudnn_lstm_bucketing.py,
# whose packed vector is drawn piece by piece as the cells' weights are
# (``ptb_packed_init``).  (b) The medium word LM of MXNet's
# example/gluon/word_language_model (emsize 650, nhid 650, 2 layers,
# dropout 0.5) at batch 32 and bptt 35, built and trained as
# examples/word_language_model.py does: Embedding, ``gluon.rnn.LSTM``,
# Dense; SoftmaxCrossEntropyLoss, states detached between segments,
# ``clip_global_norm`` at 0.25 a token, ``Trainer("sgd")`` at lr 1.0.  The
# PTB text is not in the repository: the corpora are drawn from a seed
# over PTB's 10,000 words, Zipf over the words, sentence lengths uniform
# over 1-60 so that every bucket fills.
PTB = dict(vocab=10000, hidden=200, embed=200, layers=2, batch=32,
           buckets=(10, 20, 30, 40, 50, 60))
PTB_OPT = (("learning_rate", 0.01), ("momentum", 0.0), ("wd", 1e-5))
PTB_XAVIER = dict(factor_type="in", magnitude=2.34)
PTB_SENTENCES, PTB_STEPS, PTB_SEED = 1500, 30, 13
# the buckets' captured steps share one memory pool: the peak with all six
# captured may be at most this many times the peak with only the largest
POOL_RATIO_LIMIT = 1.25
WORD_LM = dict(vocab=10000, emsize=650, nhid=650, layers=2, dropout=0.5,
               batch=32, bptt=35)
WORD_LM_LR, WORD_LM_CLIP = 1.0, 0.25
WORD_LM_WARMUP, WORD_LM_STEPS, WORD_LM_SEED = 5, 30, 17
# fp64 card against CPU (phase 25): the vocabulary cut to 1000, 3 steps,
# held to ZOO_PARITY_TOL; captured against eager over the buckets in the
# iterator's shuffled order, bit for bit or within this of max(1, |w|)
RNN_PARITY_VOCAB, RNN_PARITY_STEPS, RNN_SHUFFLED_STEPS = 1000, 3, 8
CAPTURED_EAGER_TOL = 1e-12
# the RNN op's dropout check (phase 22): a 2-layer rnn_relu whose weights
# pass ones through, so that its output is 1/keep where the mask between
# the layers kept a unit and 0 where it dropped one
RNN_DROPOUT_SHAPE = (35, 32, 650)
RNN_DROPOUT_SIGMAS = 3.0


def ptb_corpus(seed, sentences, vocab, max_len):
    """Sentences of word ids 1..vocab (0 pads), Zipf over the words,
    lengths uniform over 1..max_len."""
    rng = np.random.RandomState(seed)
    p = 1.0 / np.arange(1, vocab + 1)
    lengths = rng.randint(1, max_len + 1, sentences)
    words = rng.choice(vocab, size=int(lengths.sum()), p=p / p.sum()) + 1
    return [s.tolist() for s in np.split(words, np.cumsum(lengths)[:-1])]


def ptb_sym_gen(pkg, cfg, fused):
    """(a)'s ``sym_gen`` in ``pkg`` (either package)."""
    vocab, hidden = cfg["vocab"] + 1, cfg["hidden"]

    def sym_gen(seq_len):
        data = pkg.sym.Variable("data")
        label = pkg.sym.Variable("softmax_label")
        embed = pkg.sym.Embedding(data, input_dim=vocab,
                                  output_dim=cfg["embed"], name="embed")
        if fused:
            cell = pkg.rnn.FusedRNNCell(hidden, num_layers=cfg["layers"],
                                        prefix="lstm_")
        else:
            cell = pkg.rnn.SequentialRNNCell()
            for i in range(cfg["layers"]):
                cell.add(pkg.rnn.LSTMCell(num_hidden=hidden,
                                          prefix="lstm_l%d_" % i))
        outputs, _ = cell.unroll(seq_len, inputs=embed, merge_outputs=True)
        pred = pkg.sym.Reshape(outputs, shape=(-1, hidden))
        pred = pkg.sym.FullyConnected(pred, num_hidden=vocab, name="pred")
        label = pkg.sym.Reshape(label, shape=(-1,))
        pred = pkg.sym.SoftmaxOutput(pred, label, use_ignore=True,
                                     ignore_label=0, name="softmax")
        return pred, ("data",), ("softmax_label",)
    return sym_gen


def ptb_packed_init(cfg, seed):
    """The fused cell's packed vector, each weight matrix drawn by the
    Xavier rule of the cells (U(-s, s), s = sqrt(2.34 / fan_in)) from a
    seeded numpy generator, the biases zero."""
    rng = np.random.RandomState(seed)
    h, pieces = cfg["hidden"], []
    for layer in range(cfg["layers"]):
        for fan_in in (cfg["embed"] if layer == 0 else h, h):
            s = math.sqrt(PTB_XAVIER["magnitude"] / fan_in)
            pieces.append(rng.uniform(-s, s, 4 * h * fan_in))
        pieces.append(np.zeros(8 * h))
    return np.concatenate(pieces)


def ptb_module(pkg, ctx, cfg, fused, dtype="float32", seed=0):
    """(a)'s ``BucketingModule`` bound at the largest bucket, its
    parameters initialized from ``seed`` and SGD ready."""
    top = max(cfg["buckets"])
    mod = pkg.mod.BucketingModule(ptb_sym_gen(pkg, cfg, fused),
                                  default_bucket_key=top, context=ctx)
    shape = (cfg["batch"], top)
    mod.bind(data_shapes=[pkg.io.DataDesc("data", shape, dtype)],
             label_shapes=[pkg.io.DataDesc("softmax_label", shape, dtype)])
    pkg.random.seed(seed)
    packed = {"lstm_parameters": pkg.nd.array(
        ptb_packed_init(cfg, seed), ctx=ctx, dtype=dtype)} if fused else None
    mod.init_params(pkg.init.Xavier(**PTB_XAVIER), arg_params=packed,
                    allow_missing=True)
    mod.init_optimizer(optimizer="sgd", optimizer_params=PTB_OPT)
    return mod


def ptb_batches(pkg, cfg, dtype="float32", sentences=PTB_SENTENCES,
                seed=PTB_SEED):
    """(the iterator's batches of one epoch in its shuffled order, the
    iterator); each batch's descriptions carry ``dtype``."""
    pkg.random.seed(seed)
    it = pkg.rnn.BucketSentenceIter(
        ptb_corpus(seed, sentences, cfg["vocab"], max(cfg["buckets"])),
        cfg["batch"], buckets=list(cfg["buckets"]), invalid_label=0,
        dtype=dtype)

    def typed(descs):
        return [pkg.io.DataDesc(d.name, d.shape, dtype) for d in descs]
    return [pkg.io.DataBatch(b.data, b.label, pad=0,
                             bucket_key=b.bucket_key,
                             provide_data=typed(b.provide_data),
                             provide_label=typed(b.provide_label))
            for b in it], it


class BatchList:
    """Given batches as the iterator ``fit`` takes."""

    def __init__(self, batches, like):
        self._batches = list(batches)
        self.provide_data, self.provide_label = like.provide_data, \
            like.provide_label

    def __iter__(self):
        return iter(self._batches)

    def reset(self):
        pass


def ptb_fit(mod, batches, like, metric, on_card):
    """``fit`` over ``batches`` for one epoch: per step (bucket, ms, the
    peak memory so far), read at each batch's end."""
    rec, last = [], [time.perf_counter()]

    def at_end(param):
        if on_card:
            torch.cuda.synchronize()
        now = time.perf_counter()
        rec.append((param.locals["batch"].bucket_key, 1e3 * (now - last[0]),
                    torch.cuda.max_memory_allocated() if on_card else 0))
        last[0] = now
    mod.fit(BatchList(batches, like), num_epoch=1, eval_metric=metric,
            batch_end_callback=at_end, optimizer="sgd",
            optimizer_params=PTB_OPT)
    return rec


def device_profile(fn, steps, top=5):
    """``fn`` under ``torch.profiler``: (device ms a step, wall ms a step,
    the ``top`` device operations that took longest, ms a step each)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0) / steps
    ops = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            ops[e.name()] = ops.get(e.name(), 0.0) \
                + e.duration_ns() / 1e6 / steps
    device = sum(ops.values())
    if device == 0:
        raise AssertionError("torch.profiler recorded no device time")
    ranked = sorted(ops.items(), key=lambda kv: -kv[1])[:top]
    return device, wall, [[n[:90], ms] for n, ms in ranked]


def _private_pools(mod):
    """Give each bucket of ``mod`` a graph-memory pool of its own (the
    comparison of phase 23's memory)."""
    from mxnet_tpu_torch import capture
    spawn = mod._spawn

    def own_pool(*args, **kwargs):
        bucket = spawn(*args, **kwargs)
        bucket._graph_pool = capture.MemoryPool()
        return bucket
    mod._spawn = own_pool
    mod._leader._graph_pool = capture.MemoryPool()


def _held_bytes():
    """What the process holds on the card once the unused cached blocks
    are returned: live tensors and the graphs' memory pools."""
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return torch.cuda.memory_reserved()


def ptb_memory(ctx, cfg, fused, batches, like, private):
    """The memory (a) holds, captured (``_held_bytes``): set up, after
    steps on the largest bucket alone (only its program captured), then
    after each other bucket's first step (its capture); and the peak of
    allocated bytes over the whole run.  A replay's temporaries live in
    the graphs' pools, which only the held bytes count."""
    import mxnet_tpu_torch as mt
    top = max(cfg["buckets"])
    first = {}
    for b in batches:
        first.setdefault(b.bucket_key, b)
    mod = ptb_module(mt, ctx, cfg, fused)
    if private:
        _private_pools(mod)
    metric = mt.metric.Perplexity(ignore_label=0)
    set_up = _held_bytes()
    torch.cuda.reset_peak_memory_stats()
    ptb_fit(mod, [first[top]] * 2, like, metric, True)
    out = dict(set_up=set_up, largest_only=_held_bytes(), per_bucket=[])
    for key, b in first.items():
        if key != top:
            ptb_fit(mod, [b], like, metric, True)
            out["per_bucket"].append([key, _held_bytes()])
    out["all_buckets"] = out["per_bucket"][-1][1]
    out["ratio"] = out["all_buckets"] / out["largest_only"]
    out["peak_allocated"] = torch.cuda.max_memory_allocated()
    del mod
    free_card()
    return out


def ptb_bucketing_run(ctx, fused, cfg=PTB, steps=PTB_STEPS,
                      sentences=PTB_SENTENCES):
    """(a) in one cell variant, captured and eager in turn: one step on
    each bucket (the captures), then ``steps`` timed steps in the
    iterator's shuffled order through ``BucketingModule.fit``; per-bucket
    ms/step medians, tokens/s (batch x bucket a step), the perplexity, the
    counters; on the card also the peak memory (one pool and one a
    bucket) and the device's busy share."""
    import mxnet_tpu_torch as mt
    on_card = ctx.device_type == "gpu"
    batches, it = ptb_batches(mt, cfg, sentences=sentences)
    first = {}
    for b in batches:
        first.setdefault(b.bucket_key, b)
    if sorted(first) != sorted(cfg["buckets"]) or len(batches) < steps:
        raise AssertionError("the corpus gave buckets %s and %d batches"
                             % (sorted(first), len(batches)))
    timed, out = batches[:steps], {}
    for mode in STEP_MODES:
        with step_mode(mode):
            mod = ptb_module(mt, ctx, cfg, fused)
            metric = mt.metric.Perplexity(ignore_label=0)
            if on_card:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
            ptb_fit(mod, list(first.values()), it, metric, on_card)
            metric.reset()
            counts = counter_snapshot()
            rec = ptb_fit(mod, timed, it, metric, on_card)
            counts = counter_delta(counts)
            res = dict(counts=counts, perplexity=metric.get()[1])
            per_bucket = {}
            for key, ms, _ in rec:
                per_bucket.setdefault(key, []).append(ms)
            total_ms = sum(ms for _, ms, _ in rec)
            res["ms_median_by_bucket"] = {k: _median(v) for k, v
                                          in sorted(per_bucket.items())}
            res["ms_mean"] = total_ms / len(rec)
            res["tokens_s"] = cfg["batch"] * sum(k for k, _, _ in rec) \
                / total_ms * 1e3
            if on_card:
                res["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9

                def one_each():
                    for b in first.values():
                        mod._fit_step(b)
                        mod.update_metric(metric, b.label)
                device, wall, top = device_profile(one_each, len(first))
                res.update(profiled_device_ms=device, profiled_wall_ms=wall,
                           busy_share=device / wall, top_device_ops=top)
        replays = steps if mode == "captured" else 0
        want = dict(graph_captures=0, graph_replays=replays,
                    program_calls=steps)
        if counts != want or not math.isfinite(res["perplexity"]):
            raise AssertionError("(a) %s %s: counters %s (want %s), "
                                 "perplexity %s" % (
                                     "fused" if fused else "cells", mode,
                                     counts, want, res["perplexity"]))
        out[mode] = res
        del mod
        if on_card:
            free_card()
    if on_card:
        out["memory"] = {
            "one_pool": ptb_memory(ctx, cfg, fused, batches, it, False),
            "a_pool_a_bucket": ptb_memory(ctx, cfg, fused, batches, it,
                                          True)}
    return out


def word_lm_model(pkg, ctx, cfg, dtype="float32", seed=WORD_LM_SEED):
    """(b)'s model, as examples/word_language_model.py builds it,
    initialized (Xavier) on ``ctx`` from ``seed``."""
    class RNNModel(pkg.gluon.HybridBlock):
        def __init__(self, **kwargs):
            super().__init__(**kwargs)
            with self.name_scope():
                self.embed = pkg.gluon.nn.Embedding(cfg["vocab"],
                                                    cfg["emsize"])
                self.rnn = pkg.gluon.rnn.LSTM(
                    cfg["nhid"], cfg["layers"], layout="TNC",
                    dropout=cfg["dropout"], input_size=cfg["emsize"])
                self.decoder = pkg.gluon.nn.Dense(
                    cfg["vocab"], flatten=False, in_units=cfg["nhid"])

        def hybrid_forward(self, F, x, *state):
            out, state = self.rnn(self.embed(x), list(state))
            return self.decoder(out), state
    with pkg.name.NameManager():
        model = RNNModel(prefix="model_")
    model.cast(dtype)
    pkg.random.seed(seed)
    model.collect_params().initialize(pkg.init.Xavier(), ctx=ctx)
    return model


def word_lm_data(cfg, segments, seed=WORD_LM_SEED):
    """A token stream (Zipf over the vocabulary) folded into (time,
    batch) columns, enough for ``segments`` segments of bptt."""
    rng = np.random.RandomState(seed)
    p = 1.0 / np.arange(1, cfg["vocab"] + 1)
    n = (segments * cfg["bptt"] + 1) * cfg["batch"]
    return rng.choice(cfg["vocab"], size=n, p=p / p.sum()) \
        .reshape(cfg["batch"], -1).T.astype(np.float64)


def word_lm_step(pkg, model, trainer, loss_fn, x, y, state, cfg,
                 grads_out=None, clip=WORD_LM_CLIP):
    """One truncated-BPTT step of examples/word_language_model.py; the
    gradients before clipping go to ``grads_out`` where given; no
    clipping where ``clip`` is None."""
    state = [s.detach() for s in state]
    with pkg.autograd.record():
        logits, state = model(x, *state)
        loss = loss_fn(logits.reshape((-1, cfg["vocab"])), y.reshape((-1,)))
    loss.backward()
    params = [p for p in model.collect_params().values()
              if p.grad_req != "null"]
    if grads_out is not None:
        grads_out.update({p.name: p.grad().asnumpy().copy()
                          for p in params})
    if clip is not None:
        pkg.gluon.utils.clip_global_norm([p.grad() for p in params],
                                         clip * cfg["bptt"] * cfg["batch"])
    trainer.step(cfg["bptt"] * cfg["batch"])
    return loss, state, logits


def word_lm_setup(pkg, ctx, cfg, dtype="float32"):
    model = word_lm_model(pkg, ctx, cfg, dtype)
    trainer = pkg.gluon.Trainer(model.collect_params(), "sgd",
                                {"learning_rate": WORD_LM_LR})
    loss_fn = pkg.gluon.loss.SoftmaxCrossEntropyLoss()
    state = model.rnn.begin_state(cfg["batch"], ctx=ctx, dtype=dtype)
    return model, trainer, loss_fn, state


def _segment(pkg, ctx, data, i, cfg, dtype):
    seg = data[i * cfg["bptt"]:(i + 1) * cfg["bptt"] + 1]
    return (pkg.nd.array(seg[:-1], ctx=ctx, dtype=dtype),
            pkg.nd.array(seg[1:], ctx=ctx, dtype=dtype))


def word_lm_run(ctx, cfg=WORD_LM, warmup=WORD_LM_WARMUP,
                steps=WORD_LM_STEPS):
    """(b) captured (the Embedding, the Dense and the loss hybridized; the
    Trainer's fused update) and eager: ms/step, tokens/s, the loss, the
    counters; on the card the peak memory and the busy share."""
    import mxnet_tpu_torch as mt
    on_card = ctx.device_type == "gpu"
    data = word_lm_data(cfg, warmup + steps)
    out = {}
    for mode in STEP_MODES:
        model, trainer, loss_fn, state = word_lm_setup(mt, ctx, cfg)
        for block in (model.embed, model.decoder, loss_fn):
            block.hybridize()
        box = {"state": state, "i": 0}

        def step():
            x, y = _segment(mt, ctx, data, box["i"] % (warmup + steps), cfg,
                            "float32")
            box["loss"], box["state"], _ = word_lm_step(
                mt, model, trainer, loss_fn, x, y, box["state"], cfg)
            box["i"] += 1
        if on_card:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        with step_mode(mode):
            for _ in range(warmup):
                step()
            counts = counter_snapshot()
            times = _timed(step, steps) if on_card else [
                _host_ms(step) for _ in range(steps)]
            counts = counter_delta(counts)
            loss = float(box["loss"].asnumpy().mean())
            ms = _median(times)
            res = dict(step_ms_median=ms, counts=counts, loss=loss,
                       tokens_s=cfg["batch"] * cfg["bptt"] / ms * 1e3)
            if on_card:
                res["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
                device, wall, top = device_profile(
                    lambda: [step() for _ in range(5)], 5)
                res.update(profiled_device_ms=device, profiled_wall_ms=wall,
                           busy_share=device / wall, top_device_ops=top)
        if counts["graph_captures"] or counts["program_calls"] < steps \
                or not math.isfinite(loss):
            raise AssertionError("(b) %s: counters %s, loss %s"
                                 % (mode, counts, loss))
        out[mode] = res
        del model, trainer, loss_fn, state, box
        if on_card:
            free_card()
    return out


def _host_ms(fn):
    t0 = time.perf_counter()
    fn()
    return 1e3 * (time.perf_counter() - t0)


CUDNN_MODES = {"rnn_relu": 0, "rnn_tanh": 1, "lstm": 2, "gru": 3}
# the fused RNN shapes the paths give the op: (a)'s FusedRNNCell and (b)'s
# LSTM, (mode, layers, input width, hidden, bidirectional)
RNN_LAYOUT_CASES = (("lstm", 2, 200, 200, False),
                    ("lstm", 2, 650, 650, False), ("gru", 2, 64, 64, True),
                    ("rnn_tanh", 1, 32, 48, True))


def cudnn_layout_check(dtype=torch.float32):
    """Whether the packed layout (``ops.nn.rnn_weights``) is cuDNN's own
    weight buffer: cuDNN flattens fresh weights of each case into its
    buffer (``torch._cudnn_rnn_flatten_weight``) and each must sit at the
    packed vector's offset, the buffer as long as the vector.  Where they
    do, torch hands the vector to cuDNN as it is; where not, it copies the
    weights into a buffer at every call."""
    from mxnet_tpu_torch.ops.nn import rnn_param_size, rnn_weights
    out = {}
    for mode, layers, width, hidden, bi in RNN_LAYOUT_CASES:
        size = rnn_param_size(layers, width, hidden, mode, bi)
        packed = torch.zeros(size, dtype=dtype, device="cuda")
        views = rnn_weights(packed, layers, width, hidden, mode, bi)
        fresh = [torch.zeros(v.shape, dtype=dtype, device="cuda")
                 for v in views]
        buf = torch._cudnn_rnn_flatten_weight(
            fresh, 4, width, CUDNN_MODES[mode], hidden, 0, layers, False, bi)
        item = packed.element_size()
        offsets = [(v.data_ptr() - packed.data_ptr()) // item for v in views]
        placed = [(f.data_ptr() - buf.data_ptr()) // item for f in fresh]
        out["%s %dx%d%s" % (mode, layers, hidden, " bi" if bi else "")] = \
            dict(same=buf.numel() == size and offsets == placed,
                 buffer=buf.numel(), packed=size, packed_at=offsets[:8],
                 cudnn_at=placed[:8])
    return out


def rnn_dropout_module(ctx, shape):
    """A Module over one ``RNN`` node (rnn_relu, 2 layers, p 0.5) whose
    weights pass its input through (identity input weights, zero
    recurrent weights, biases and state), under ``MakeLoss``, with SGD
    at lr 0 (the weights stay); fed ones, its output is 1/keep where the
    mask between the layers kept a unit and 0 where it dropped one."""
    import mxnet_tpu_torch as mt
    t, n, h = shape
    net = mt.sym.MakeLoss(mt.sym.RNN(
        mt.sym.Variable("data"), state_size=h, num_layers=2,
        mode="rnn_relu", p=0.5, name="rnn"))
    mod = mt.mod.Module(net, data_names=("data",), label_names=None,
                        context=ctx)
    mod.bind(data_shapes=[mt.io.DataDesc("data", shape)])
    eye = np.eye(h).ravel()
    zero = np.zeros(h * h + 2 * h)
    mod.init_params(arg_params={
        "rnn_parameters": mt.nd.array(np.concatenate([eye, zero] * 2),
                                      ctx=ctx),
        "rnn_state": mt.nd.zeros((2, n, h), ctx=ctx)})
    mod.init_optimizer(optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.0),))
    return mod, mt.io.DataBatch([mt.nd.ones(shape, ctx=ctx)], None)


def rnn_dropout_checks(ctx, shape=RNN_DROPOUT_SHAPE):
    """The RNN op's dropout in a captured step: a new mask at each replay,
    the kept share within RNN_DROPOUT_SIGMAS of 0.5, and an eager step and
    the captured one from one generator state drawing the same mask."""
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import capture
    mod, batch = rnn_dropout_module(ctx, shape)
    gen = mt.random.generator(ctx)
    state = gen.get_state()

    def kept():
        mod._fit_step(batch)
        return mod.get_outputs()[0]._data != 0
    with capture.eager():
        eager = kept()
    gen.set_state(state)
    counts = counter_snapshot()
    first, second = kept(), kept()
    counts = counter_delta(counts)
    n = first.numel()
    share = first.double().mean().item()
    res = dict(shape=list(shape), kept_share=share,
               kept_sigmas=abs(share - 0.5) / math.sqrt(0.25 / n),
               replays_differ=bool((first != second).any().item()),
               eager_equals_captured=bool(torch.equal(eager, first)),
               counts=counts)
    if not res["replays_differ"] or res["kept_sigmas"] > RNN_DROPOUT_SIGMAS \
            or not res["eager_equals_captured"]:
        raise AssertionError("the RNN op's dropout: %s" % res)
    return res


def _param_arrays(mod):
    arg, aux = mod.get_params()
    return {k: v.asnumpy().copy() for k, v in arg.items()}


def _gaps(a, b, relative=False):
    """The largest |a - b| over max(1, |a|) (or, ``relative``, over the
    largest |a| of each array) across the arrays of two dicts or lists."""
    pairs = zip(a.values(), b.values()) if isinstance(a, dict) \
        else zip(a, b)
    worst = 0.0
    for x, y in pairs:
        scale = max(np.abs(x).max(), 1e-30) if relative \
            else max(1.0, np.abs(x).max())
        worst = max(worst, float(np.abs(x - y).max() / scale))
    return worst


def ptb_parity_run(pkg, ctx, cfg, fused, batches, one_call=True):
    """(a) in fp64 from one init: step 1 as forward, backward and update
    (its gradients read), steps 2.. through the one-call step (or, not
    ``one_call``, as step 1); the outputs of each step, the gradients and
    the weights after."""
    mod = ptb_module(pkg, ctx, cfg, fused, dtype="float64")
    outs, grads = [], None
    for b in batches:
        if grads is None or not one_call:
            mod.forward(b, is_train=True)
            mod.backward()
            if grads is None:
                ex = mod._active._exec_group.execs[0]
                grads = {n: ex.grad_dict[n].asnumpy().copy()
                         for n in ex._grad_names}
            mod.update()
        else:
            mod._fit_step(b)
        outs.append(mod.get_outputs()[0].asnumpy().copy())
    return dict(outputs=outs, grads=grads, params=_param_arrays(mod))


def ptb_shuffled_run(ctx, cfg, fused, batches, mode):
    """(a) in fp64, ``_fit_step`` over ``batches`` (the buckets in the
    iterator's shuffled order) captured or eager: outputs and weights."""
    import mxnet_tpu_torch as mt
    with step_mode(mode):
        mod = ptb_module(mt, ctx, cfg, fused, dtype="float64")
        outs = []
        for b in batches:
            mod._fit_step(b)
            outs.append(mod.get_outputs()[0].asnumpy().copy())
    return dict(outputs=outs, params=_param_arrays(mod))


def word_lm_parity_run(pkg, ctx, cfg, steps):
    """(b) in fp64 with dropout 0 and no clipping from one init: the first
    step's logits and gradients, the weights after ``steps``.  (Both
    packages take ``clip_global_norm``'s norm in fp32; summed in other
    orders it moves each update by about 1e-8 of itself.)"""
    model, trainer, loss_fn, state = word_lm_setup(pkg, ctx, cfg, "float64")
    data = word_lm_data(cfg, steps)
    grads, logits = {}, None
    for i in range(steps):
        x, y = _segment(pkg, ctx, data, i, cfg, "float64")
        _, state, out = word_lm_step(pkg, model, trainer, loss_fn, x, y,
                                     state, cfg, grads if i == 0 else None,
                                     clip=None)
        logits = out.asnumpy().copy() if i == 0 else logits
    params = {n: p.data().asnumpy()
              for n, p in model.collect_params().items()}
    return dict(logits=logits, grads=grads, params=params)


def rnn_parity(card_ctx, cpu_ctx, ptb=None, lm=None, sentences=400):
    """Phase 25: fp64 card against CPU for (a), both cell variants, and
    (b) (by default at their widths, the vocabulary cut to
    RNN_PARITY_VOCAB, (b)'s dropout 0); (a) captured against eager over
    the buckets in the iterator's shuffled order."""
    import mxnet_tpu_torch as mt
    out = {}
    small = ptb or dict(PTB, vocab=RNN_PARITY_VOCAB)
    batches, _ = ptb_batches(mt, small, "float64", sentences=sentences)
    for fused in (False, True):
        name = "ptb_fused" if fused else "ptb_cells"
        runs = [ptb_parity_run(mt, c, small, fused,
                               batches[:RNN_PARITY_STEPS])
                for c in (cpu_ctx, card_ctx)]
        diffs = dict(logits=_gaps(runs[0]["outputs"], runs[1]["outputs"]),
                     grads=_gaps(runs[0]["grads"], runs[1]["grads"], True),
                     params=_gaps(runs[0]["params"], runs[1]["params"]))
        shuffled = [ptb_shuffled_run(card_ctx, small, fused,
                                     batches[:RNN_SHUFFLED_STEPS], m)
                    for m in STEP_MODES]
        diffs["captured_vs_eager"] = max(
            _gaps(shuffled[0]["params"], shuffled[1]["params"]),
            _gaps(shuffled[0]["outputs"], shuffled[1]["outputs"]))
        diffs["shuffled_buckets"] = [b.bucket_key for b
                                     in batches[:RNN_SHUFFLED_STEPS]]
        out[name] = diffs
    lm = lm or dict(WORD_LM, vocab=RNN_PARITY_VOCAB, dropout=0.0)
    runs = [word_lm_parity_run(mt, c, lm, RNN_PARITY_STEPS)
            for c in (cpu_ctx, card_ctx)]
    out["word_lm"] = dict(
        logits=_gaps([runs[0]["logits"]], [runs[1]["logits"]]),
        grads=_gaps(runs[0]["grads"], runs[1]["grads"], True),
        params=_gaps(runs[0]["params"], runs[1]["params"]))
    bad = [(k, n) for k, d in out.items() for n, v in d.items()
           if n in ZOO_PARITY_TOL and not v <= ZOO_PARITY_TOL[n]]
    bad += [(k, "captured_vs_eager") for k, d in out.items()
            if not d.get("captured_vs_eager", 0.0) <= CAPTURED_EAGER_TOL]
    if bad:
        raise AssertionError("recurrent nets: card against CPU or captured "
                             "against eager out of bounds: %s (%s)"
                             % (bad, out))
    return out


def phase_rnn(card):
    """Phases 22-25: the RNN op's dropout in a captured step, (a) in both
    cell variants, (b), and fp64 parity."""
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import profiler
    from mxnet_tpu_torch.ops import attention as att, scale as sc
    kernels = (att.FWD_COUNTER, att.BWD_COUNTER, sc.COUNTER)
    before = {k: profiler.counter(k) for k in kernels}
    flags = tf32_flags()
    gpu = mt.gpu(0)
    res = {"card": card, "flags": flags}
    t0 = time.perf_counter()
    res["cudnn_layout"] = {DTYPE_NAME.get(dt, "fp64"): cudnn_layout_check(dt)
                           for dt in (torch.float32, torch.float64)}
    log("phase 22 the packed layout against cuDNN's weight buffer: %s"
        % res["cudnn_layout"])
    res["dropout"] = rnn_dropout_checks(gpu)
    log("phase 22 RNN op dropout in a captured Module step at %s: %s"
        % (list(RNN_DROPOUT_SHAPE), res["dropout"]))
    for fused in (False, True):
        name = "ptb_fused" if fused else "ptb_cells"
        res[name] = ptb_bucketing_run(gpu, fused)
        for mode in STEP_MODES:
            r = res[name][mode]
            log("phase 23 (a) PTB LSTM %s %s on %s (%s), batch %d, buckets "
                "%s: ms/step by bucket %s, mean %.3f, %.0f tokens/s, "
                "perplexity %.1f, busy %.1f%%, peak %.3f GB, counters %s; "
                "top device ops %s"
                % ("FusedRNNCell" if fused else "LSTMCells", mode, card,
                   flags, PTB["batch"], list(PTB["buckets"]),
                   {k: "%.3f" % v for k, v
                    in r["ms_median_by_bucket"].items()}, r["ms_mean"],
                   r["tokens_s"], r["perplexity"], 100 * r["busy_share"],
                   r["peak_mem_gb"], r["counts"], r["top_device_ops"]))
        mem = res[name]["memory"]
        for pools, m in mem.items():
            log("phase 23 (a) %s memory held, %s: set up %d B, the largest "
                "bucket alone captured %d B, all six %d B (x%.3f), after "
                "each bucket %s; peak allocated %d B"
                % (name, pools.replace("_", " "), m["set_up"],
                   m["largest_only"], m["all_buckets"], m["ratio"],
                   m["per_bucket"], m["peak_allocated"]))
        if mem["one_pool"]["ratio"] > POOL_RATIO_LIMIT:
            raise AssertionError("(a) %s: all six buckets captured hold "
                                 "%.3f x the largest alone" % (
                                     name, mem["one_pool"]["ratio"]))
    res["word_lm"] = word_lm_run(gpu)
    for mode in STEP_MODES:
        r = res["word_lm"][mode]
        log("phase 24 (b) word LM 2 x 650 %s on %s (%s), batch %d, bptt %d: "
            "ms/step median %.3f, %.0f tokens/s, loss %.4f, busy %.1f%%, "
            "peak %.3f GB, counters %s; top device ops %s"
            % (mode, card, flags, WORD_LM["batch"], WORD_LM["bptt"],
               r["step_ms_median"], r["tokens_s"], r["loss"],
               100 * r["busy_share"], r["peak_mem_gb"], r["counts"],
               r["top_device_ops"]))
    res["parity_fp64"] = rnn_parity(gpu, mt.cpu())
    log("phase 25 fp64 card against CPU (vocabulary %d, %d steps; limits "
        "%s) and captured against eager over shuffled buckets (limit %g): "
        "%s" % (RNN_PARITY_VOCAB, RNN_PARITY_STEPS, ZOO_PARITY_TOL,
                CAPTURED_EAGER_TOL, res["parity_fp64"]))
    res["seconds"] = time.perf_counter() - t0
    # no hand-written kernel runs on these paths
    res["kernel_launches"] = {k: profiler.counter(k) - before[k]
                              for k in kernels}
    log("phases 22-25: %.1f s, hand-kernel launches %s"
        % (res["seconds"], res["kernel_launches"]))
    if any(res["kernel_launches"].values()):
        raise AssertionError("a hand-written kernel ran on the recurrent "
                             "paths: %s" % res["kernel_launches"])
    return res


# -- phases 26-28: the data path ----------------------------------------------
# Phase 26's .rec: ImageNet as MXNet stores it for training (im2rec --resize
# 256, quality 95), of seeded images (``test_utils.synthetic_image``): the
# real files are not in the repository.
DATA_IMAGES, DATA_SHORT, DATA_QUALITY = 2048, 256, 95
DATA_SHAPE, DATA_BATCH = (3, 224, 224), 32
DATA_READ_BATCHES = 20       # batches timed at each thread count
DATA_STEP_THREADS = 4        # examples/train_imagenet.py's preprocess_threads
# A libjpeg decode's error against the images before encoding, on their
# first 32 (x 255, 224 x 224, each resized by the plain formula), printed
# by tests/test_torch_image_record_iter.py::
# test_libjpeg_error_against_the_images.  The card's nvJPEG batch is held
# to it times NVJPEG_MARGIN: both decode the same quantized coefficients,
# and the decoders differ only in their IDCT and chroma upsampling, each a
# fraction of the quantization error itself.
LIBJPEG_ERR = {"mean": 3.3841, "rms": 4.4581}
NVJPEG_MARGIN = 1.25
# The resize kernel against its plain version: both make image_loader.cc's
# roundings and numpy's mean and scale one by one in fp32, so bit for bit.
RESIZE_ATOL = 0.0
RESIZE_CASES = [((256, 341), (224, 224), 3, False),
                ((256, 341), (224, 224), 3, True),
                ((341, 256), (224, 224), 3, True),
                ((37, 50), (64, 48), 4, False), ((1, 1), (5, 3), 3, True)]
# MXNet's ImageNet mean and the scale of its standard deviation, for the
# kernel's mean and scale and the iterator that passes them
DATA_MEAN_RGB, DATA_SCALE = (123.68, 116.779, 103.939), 1 / 58.393
# The timed round: the main path's batch of sources at the .rec's size.
RESIZE_ROUND = (DATA_BATCH,) + RESIZE_CASES[1][:3]
L2_BYTES = 50 * 2 ** 20
# phase 26's allow_corrupt file: failures in a round's middle and at its
# ends, each batch topped up, the last one short
CORRUPT_IMAGES, CORRUPT_RECORDS = 80, (0, 5, 31, 40, 63, 79)
# phase 28: examples/train_mnist.py's LeNet, one epoch over MNIST's sizes
LENET_BATCH, LENET_LR, LENET_MOMENTUM = 64, 0.1, 0.9
MNIST_TRAIN, MNIST_TEST = 60000, 10000
GLUON_LENET_STEPS = 20


def jpeg_probe():
    """What the host offers to code and decode JPEG: libjpeg's header and
    the package's build of it, nvJPEG's header, PIL, cv2, the cores."""
    import glob
    import importlib.util
    from mxnet_tpu_torch import _native, MXNetError
    cuda = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    probe = {
        "jpeglib_h": sorted(glob.glob("/usr/include/jpeglib.h")
                            + glob.glob("/usr/include/*/jpeglib.h")),
        "nvjpeg_h": os.path.exists(os.path.join(cuda, "include",
                                                "nvjpeg.h")),
        "PIL": importlib.util.find_spec("PIL") is not None,
        "cv2": importlib.util.find_spec("cv2") is not None,
        "nproc": os.cpu_count()}
    try:
        _native.image_lib()
        probe["libjpeg_build"] = "built"
    except MXNetError as e:
        lines = str(e).splitlines()
        probe["libjpeg_build"] = "failed: %s" % next(
            (ln for ln in lines if "error" in ln), lines[-1])[:200]
    return probe


def _round_sources(gen, shape, n):
    return [torch.randint(0, 256, shape + (3,), generator=gen,
                          dtype=torch.uint8).cuda() for _ in range(n)]


def resize_kernel_check(card):
    """The resize kernel (``ops.image_nvjpeg``) against its plain version
    on the card: each of RESIZE_CASES alone (a round of one image), then
    all their sources in one ragged round at each case's output shape,
    with a failed record's hole, with and without the mean and the scale,
    bit for bit; then its time on the main path's round (RESIZE_ROUND,
    rotating over enough buffers to pass the L2 cache) beside its bound,
    the plain version's and ``F.interpolate``'s on the float batch, and
    the time of a round of one image."""
    import torch.nn.functional as F
    from mxnet_tpu_torch.ops import image_nvjpeg as nj
    gen = torch.Generator().manual_seed(7)
    worst, rounds = 0.0, 0

    def held(got, want, what):
        nonlocal worst
        err = (got - want).abs().max().item()
        worst = max(worst, err)
        if not err <= RESIZE_ATOL:
            raise AssertionError("resize_rgb_chw disagrees with its plain "
                                 "version at %s: %g" % (what, err))
    srcs, mirrors = [], []
    for (sh, sw), (dh, dw), c, mirror in RESIZE_CASES:
        src = _round_sources(gen, (sh, sw), 1)[0]
        held(nj.resize_rgb_chw(src, dh, dw, c, mirror),
             nj.resize_rgb_chw_reference(src, dh, dw, c, mirror),
             (sh, sw, dh, dw, c, mirror))
        srcs.append(src)
        mirrors.append(mirror)
    srcs.insert(2, None)
    mirrors.insert(2, True)
    for (dh, dw, c), with_mean in itertools.product(
            sorted({(dh, dw, c) for _, (dh, dw), c, _ in RESIZE_CASES}),
            (False, True)):
        mean = scale = None
        if with_mean:   # of length c, or of length 1
            mean = np.float32(DATA_MEAN_RGB) / np.float32(255.0) if c == 3 \
                else np.float32([0.5])
            scale = DATA_SCALE
        held(nj.resize_rgb_chw_batch(srcs, dh, dw, c, mirrors, mean, scale),
             nj.resize_rgb_chw_batch_reference(srcs, dh, dw, c, mirrors,
                                               mean, scale),
             ("ragged round", dh, dw, c, with_mean))
        rounds += 1
    div_mismatches = nj.div255_mismatches("cuda")
    if div_mismatches:
        raise AssertionError("the kernel's division by 255 differs from a "
                             "true division on %d floats in [0, 256]"
                             % div_mismatches)
    n, (sh, sw), (dh, dw), c = RESIZE_ROUND
    nbytes = n * (sh * sw * 3 + c * dh * dw * 4)
    sets = []     # (table, out, sources), past twice the L2 cache
    while len(sets) * nbytes < 2 * L2_BYTES:
        sources = _round_sources(gen, (sh, sw), n)
        table = torch.from_numpy(nj.round_table(
            sources, dh, dw, [i % 2 == 0 for i in range(n)]).view(
                np.uint8)).cuda()
        sets.append((table, torch.empty((n, c, dh, dw), device="cuda"),
                     sources))
    turn = itertools.count()

    def one_round():
        table, out, _ = sets[next(turn) % len(sets)]
        nj.launch_round(table, n, out, c)
    first = sets[0][2]
    as_float = [torch.stack(s).permute(0, 3, 1, 2).float().contiguous()
                for s in (first, sets[1][2])]
    single_table = sets[0][0][:nj.DESC.itemsize]
    single_out = torch.empty((1, c, dh, dw), device="cuda")
    res = dict(
        max_abs_err=worst, cases=len(RESIZE_CASES), ragged_rounds=rounds,
        div255_mismatches=div_mismatches,
        ms=cuda_ms(one_round, 200),
        plain_ms=cuda_ms(lambda: nj.resize_rgb_chw_batch_reference(
            first, dh, dw, c, [i % 2 == 0 for i in range(n)]), 3, 1),
        library_ms=cuda_ms(lambda: F.interpolate(
            as_float[next(turn) % 2], size=(dh, dw), mode="bilinear",
            align_corners=False), 50),
        single_image_ms=cuda_ms(lambda: nj.launch_round(
            single_table, 1, single_out, c), 200),
        buffer_sets=len(sets))
    flops = n * c * dh * dw * 10          # 6 multiplies, 3 adds, 1 divide
    bound = {"bytes": nbytes / HBM_BPS * 1e3,
             "operations": flops / PEAK_FLOPS[torch.float32] * 1e3}
    res["bound_by"] = max(bound, key=bound.get)
    res["bound_ms"] = bound[res["bound_by"]]
    res["ms_per_image"] = res["ms"] / n
    res["shape"] = [n, sh, sw, dh, dw, c]
    log("phase 26 resize_rgb_chw on %s: %d cases alone and %d ragged rounds "
        "(a hole, with and without mean and scale) bit for bit against the "
        "plain version (max |err| %g), its division by 255 a true one on "
        "every float in [0, 256]; a round of %d x %dx%d -> %dx%d x %d, "
        "mirror every other, over %d buffer sets: kernel %.5f ms (%.6f an "
        "image), bound %.5f ms (%s, %.1f%%), plain %.3f, F.interpolate "
        "(float batch) %.5f; a round of one image %.5f ms"
        % (card, len(RESIZE_CASES), rounds, worst, n, sh, sw, dh, dw, c,
           len(sets), res["ms"], res["ms_per_image"], res["bound_ms"],
           res["bound_by"], 100 * res["bound_ms"] / res["ms"],
           res["plain_ms"], res["library_ms"], res["single_image_ms"]))
    del sets, as_float
    return res


def _read_rate(rec, threads):
    """img/s of ``ImageRecordIter`` on the card at ``threads`` (one batch
    after its start-up, then DATA_READ_BATCHES timed), and the decoder it
    ran."""
    import mxnet_tpu_torch as mt
    it = mt.image.ImageRecordIter(
        path_imgrec=rec, data_shape=DATA_SHAPE, batch_size=DATA_BATCH,
        shuffle=True, rand_mirror=True, preprocess_threads=threads)
    it.next()
    t0 = time.perf_counter()
    for _ in range(DATA_READ_BATCHES):
        it.next()
    seconds = time.perf_counter() - t0
    return DATA_BATCH * DATA_READ_BATCHES / seconds, it.decoder


def copy_times(batch, reps=20):
    """ms to copy one host batch to the card with ``as_in_context`` from
    the pinned buffer the card's loader writes it into, and from a
    pageable copy of it; and ms to copy it from pageable into pinned
    memory on the host (what pinning costs where a loader cannot write
    into pinned memory itself)."""
    pinned = batch.data[0]._data
    if not pinned.is_pinned():
        raise AssertionError("the card's loader gave a pageable batch")
    host = pinned.clone()

    def timed(fn):
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
        return sorted(times)[reps // 2]
    return dict(pageable_ms=timed(lambda: host.to("cuda")),
                pinned_ms=timed(lambda: pinned.to("cuda")),
                stage_into_pinned_ms=timed(lambda: pinned.clone().copy_(
                    host)),
                bytes=host.numel() * host.element_size())


def _pixel_errors(errs, factor=1.0, libjpeg=LIBJPEG_ERR):
    """Mean, rms and max of ``errs`` (|card - images| x 255), held to
    ``libjpeg`` (libjpeg's own error on the same measure) x NVJPEG_MARGIN
    x ``factor``."""
    err = torch.stack(errs)
    res = {"mean": err.mean().item(), "rms": err.pow(2).mean().sqrt().item(),
           "max": err.max().item(), "libjpeg": libjpeg,
           "margin": NVJPEG_MARGIN, "factor": factor}
    bad = [k for k in libjpeg if not res[k] <= libjpeg[k]
           * NVJPEG_MARGIN * factor]
    if bad:
        raise AssertionError("nvJPEG's pixels lie further from the images "
                             "than libjpeg's with the margin: %s" % res)
    return res


def nvjpeg_pixel_check(rec, n=32):
    """The card's decode of the first ``n`` records (no shuffle, no mirror)
    against the images before encoding, each resized by the plain formula:
    mean, rms and max |err| x 255, held to LIBJPEG_ERR x NVJPEG_MARGIN."""
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch.ops import image_nvjpeg as nj
    it = mt.image.ImageRecordIter(path_imgrec=rec, data_shape=DATA_SHAPE,
                                  batch_size=n)
    got = it.next().data[0]._data
    errs = []
    for i in range(n):
        _, img = mt.test_utils.synthetic_image(0, i, DATA_SHORT)
        want = nj.resize_rgb_chw_reference(torch.from_numpy(img),
                                           *DATA_SHAPE[1:])
        errs.append((got[i] - want).abs() * 255)
    return _pixel_errors(errs)


def mean_scale_check(rec, n=32):
    """``ImageRecordIter`` on the card with ``mean_rgb`` and ``scale`` (the
    kernel applies them): bit for bit the same iterator without them
    followed by the CPU route's numpy ``-=`` and ``*=``, and, against the
    images before encoding through the plain version with the mean and
    the scale, within LIBJPEG_ERR x NVJPEG_MARGIN x the scale."""
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch.ops import image_nvjpeg as nj
    kw = dict(path_imgrec=rec, data_shape=DATA_SHAPE, batch_size=n)
    got = mt.image.ImageRecordIter(mean_rgb=DATA_MEAN_RGB, scale=DATA_SCALE,
                                   **kw).next().data[0]._data
    host = mt.image.ImageRecordIter(**kw).next().data[0].asnumpy()
    mean = np.asarray(DATA_MEAN_RGB, np.float32) / 255.0
    host -= mean.reshape(1, -1, 1, 1)
    host *= np.float32(DATA_SCALE)
    if not np.array_equal(got.numpy(), host):
        raise AssertionError("the kernel's mean and scale differ from "
                             "numpy's on the same batch: max |err| %g"
                             % np.abs(got.numpy() - host).max())
    imgs = [torch.from_numpy(mt.test_utils.synthetic_image(
        0, i, DATA_SHORT)[1]) for i in range(n)]
    want = nj.resize_rgb_chw_batch_reference(imgs, *DATA_SHAPE[1:],
                                             DATA_SHAPE[0], None, mean,
                                             DATA_SCALE)
    res = _pixel_errors([(got[i] - want[i]).abs() * 255 for i in range(n)],
                        DATA_SCALE)
    res["bitwise_with_numpy"] = True
    return res


def corrupt_loader_check(tmp, encode):
    """``allow_corrupt`` on the card: a .rec of CORRUPT_IMAGES images whose
    CORRUPT_RECORDS are not JPEGs, read without shuffle.  Each batch's
    labels, order and ``pad`` and the count of failures are
    ``test_utils.loader_batches``'s, which tests/test_torch_resize_batch.py
    holds to the CPU loader and the JAX package's (and the CPU loader's
    here, where libjpeg builds); the tail is zeros; the pixels lie within
    LIBJPEG_ERR x NVJPEG_MARGIN of the images."""
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import MXNetError
    from mxnet_tpu_torch.ops import image_nvjpeg as nj
    prefix = os.path.join(tmp, "corrupt")
    mt.test_utils.write_image_rec(
        prefix, CORRUPT_IMAGES, seed=0, short=DATA_SHORT,
        quality=DATA_QUALITY, encode=encode, threads=os.cpu_count(),
        corrupt=CORRUPT_RECORDS)
    want = mt.test_utils.loader_batches(CORRUPT_IMAGES, DATA_BATCH,
                                        CORRUPT_RECORDS)
    kw = dict(path_imgrec=prefix + ".rec", data_shape=DATA_SHAPE,
              batch_size=DATA_BATCH, allow_corrupt=True)
    its = {"card": mt.image.ImageRecordIter(**kw)}
    try:
        its["cpu"] = mt.image.ImageRecordIter(ctx=mt.cpu(), **kw)
    except MXNetError:
        pass     # no libjpeg on this host: the model stands for it
    errs = []
    for records, pad in want:
        labels = np.float32([mt.test_utils.synthetic_image(
            0, i, DATA_SHORT)[0] for i in records] + [0] * pad)
        for name, it in its.items():
            b = it.next()
            if b.pad != pad or not np.array_equal(b.label[0].asnumpy(),
                                                  labels):
                raise AssertionError(
                    "allow_corrupt on %s: pad %d labels %s, want pad %d "
                    "labels %s" % (name, b.pad, b.label[0].asnumpy(), pad,
                                   labels))
            if name != "card":
                continue
            data = b.data[0]._data
            if pad and data[DATA_BATCH - pad:].abs().max().item() != 0:
                raise AssertionError("allow_corrupt on the card: the tail "
                                     "is not zero")
            for j, i in enumerate(records):
                img = mt.test_utils.synthetic_image(0, i, DATA_SHORT)[1]
                errs.append((data[j] - nj.resize_rgb_chw_reference(
                    torch.from_numpy(img), *DATA_SHAPE[1:])).abs() * 255)
    for name, it in its.items():
        try:
            it.next()
            raise AssertionError("allow_corrupt on %s: a batch past the "
                                 "data" % name)
        except StopIteration:
            pass
        if it.num_failed != len(CORRUPT_RECORDS):
            raise AssertionError("allow_corrupt on %s: num_failed %d, want "
                                 "%d" % (name, it.num_failed,
                                         len(CORRUPT_RECORDS)))
    res = _pixel_errors(errs)
    res.update(batches=len(want), pads=[p for _, p in want],
               num_failed=len(CORRUPT_RECORDS), held_to=sorted(its))
    return res


def phase_data_loader(card, tmp):
    """Phase 26: the probe, the .rec, the resize kernel, img/s of the card's
    loader by thread count, the copy to the card, its bits and its pixels."""
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import profiler
    from mxnet_tpu_torch.ops import image_nvjpeg as nj
    res = {"probe": jpeg_probe()}
    encode = mt._native.jpeg_encode if res["probe"]["libjpeg_build"] == \
        "built" else mt.test_utils.pil_jpeg
    res["encoder"] = "libjpeg" if encode is mt._native.jpeg_encode else "PIL"
    t0 = time.perf_counter()
    prefix = os.path.join(tmp, "train")
    res["jpeg_mean_bytes"] = mt.test_utils.write_image_rec(
        prefix, DATA_IMAGES, seed=0, short=DATA_SHORT, quality=DATA_QUALITY,
        encode=encode, threads=os.cpu_count())
    res["write_s"] = time.perf_counter() - t0
    rec = prefix + ".rec"
    res["rec_bytes"] = os.path.getsize(rec)
    res["resize_kernel"] = resize_kernel_check(card)
    profiler.reset_counters(nj.COUNTER, nj.ROUNDS_COUNTER)
    rates = {}
    for threads in sorted({1, 4, 8, os.cpu_count()}):
        rates[threads], res["decoder"] = _read_rate(rec, threads)
    res["img_s_by_threads"] = rates
    it = mt.image.ImageRecordIter(path_imgrec=rec, data_shape=DATA_SHAPE,
                                  batch_size=DATA_BATCH, shuffle=True,
                                  rand_mirror=True)
    batch = it.next()
    on_card = batch.data[0].as_in_context(mt.gpu(0))
    res["card_batch_bitwise"] = bool(torch.equal(on_card._data.cpu(),
                                                 batch.data[0]._data))
    if not res["card_batch_bitwise"]:
        raise AssertionError("the batch on the card differs from the host's")
    res["copy"] = copy_times(batch)
    res["pixels"] = nvjpeg_pixel_check(rec)
    res["mean_scale"] = mean_scale_check(rec)
    res["allow_corrupt"] = corrupt_loader_check(tmp, encode)
    log("phase 26 probe on %s: %s; decoder %s, files encoded with %s"
        % (card, res["probe"], res["decoder"], res["encoder"]))
    log("phase 26 .rec of %d images (shorter side %d, quality %d): %d bytes, "
        "mean JPEG %.0f bytes, written in %.1f s"
        % (DATA_IMAGES, DATA_SHORT, DATA_QUALITY, res["rec_bytes"],
           res["jpeg_mean_bytes"], res["write_s"]))
    log("phase 26 ImageRecordIter (%s) on %s, batch %d at %s, shuffle, "
        "mirror: img/s by preprocess_threads %s; copy of a %d-byte batch to "
        "the card %.3f ms pageable, %.3f ms pinned (+ %.3f ms staging into "
        "the pinned buffer); the batch on the card equals the host's bit for "
        "bit; pixels against the images (x 255) %s"
        % (res["decoder"], card, DATA_BATCH, list(DATA_SHAPE),
           {k: round(v, 1) for k, v in rates.items()}, res["copy"]["bytes"],
           res["copy"]["pageable_ms"], res["copy"]["pinned_ms"],
           res["copy"]["stage_into_pinned_ms"], res["pixels"]))
    log("phase 26 on %s: mean_rgb %s and scale %.6f in the kernel bit for "
        "bit with numpy's on the same batch, pixels (x 255) %s; "
        "allow_corrupt (%d of %d records not JPEGs) labels, order, pads %s "
        "and num_failed as %s, tails zero, pixels %s"
        % (card, DATA_MEAN_RGB, DATA_SCALE, res["mean_scale"],
           len(CORRUPT_RECORDS), CORRUPT_IMAGES,
           res["allow_corrupt"]["pads"],
           " and ".join(["test_utils.loader_batches"]
                        + [k + " loader" for k in
                           res["allow_corrupt"]["held_to"] if k != "card"]),
           {k: res["allow_corrupt"][k] for k in ("mean", "rms", "max")}))
    return res, rec


class _RecordBatches:
    """Batches of ``it`` moved to the card (``as_in_context``; bf16 cast
    there), the iterator reset at its end; the host ms each ``next`` took
    (``read_ms``: the loader's part of a step; the copy after it waits for
    the step before, whose batch it follows on the card's stream)."""

    def __init__(self, it, dtype):
        self.it, self.dtype, self.read_ms = it, dtype, []

    def next(self):
        import mxnet_tpu_torch as mt
        t0 = time.perf_counter()
        try:
            b = self.it.next()
        except StopIteration:
            self.it.reset()
            b = self.it.next()
        self.read_ms.append(1e3 * (time.perf_counter() - t0))
        gpu = mt.gpu(0)
        x = b.data[0].as_in_context(gpu)
        if self.dtype == torch.bfloat16:
            x = x.astype("bfloat16")
        y = b.label[0].as_in_context(gpu)
        return mt.io.DataBatch([x], [y])


def data_gluon_resnet(card, rec, dtype, gluon_res):
    """Phase 27: ResNet-50 through Gluon as examples/train_imagenet.py
    trains it, fed by ``ImageRecordIter`` over ``rec``: 5 + 30 steps,
    each timed step 3 replays, 0 captures, 0 traces, 1 fused update."""
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch.gluon import block, fused_trainer
    flags = tf32_flags() if dtype == torch.float32 else "bf16"
    it = mt.image.ImageRecordIter(
        path_imgrec=rec, data_shape=DATA_SHAPE, batch_size=DATA_BATCH,
        shuffle=True, rand_mirror=True, preprocess_threads=DATA_STEP_THREADS)
    feed = _RecordBatches(it, dtype)
    net = gluon_resnet(mt.gpu(0), dtype)
    trainer = gluon_trainer(net)
    loss_fn = mt.gluon.loss.SoftmaxCrossEntropyLoss()
    res, per_step = {}, []

    def step():
        res["out"], res["loss"] = gluon_step(net, trainer, loss_fn,
                                             feed.next())

    def checked_step():
        block.reset_trace_count()
        fused_trainer.reset_update_counts()
        before = counter_snapshot()
        step()
        per_step.append(dict(counter_delta(before),
                             traces=block.trace_count(),
                             fused=fused_trainer.fused_update_count()))
    _timed(step, RESNET_WARMUP)
    feed.read_ms.clear()
    # as a training loop runs: no synchronize between steps, so the next
    # batch is read while the card runs the step (the host keeps pace
    # with the card: each batch's copy to it waits for the step before)
    ends = [time.perf_counter()]
    for _ in range(RESNET_STEPS):
        checked_step()
        ends.append(time.perf_counter())
    torch.cuda.synchronize()
    times = [1e3 * (b - a) for a, b in zip(ends, ends[1:])]
    mean_ms = 1e3 * (time.perf_counter() - ends[0]) / RESNET_STEPS
    serial = _timed(step, RESNET_STEPS)
    want = dict(graph_captures=0, graph_replays=3, program_calls=3,
                traces=0, fused=1)
    bad = [s for s in per_step if s != want]
    if bad:
        raise AssertionError("phase 27 %s steps: %s, want %s each"
                             % (DTYPE_NAME[dtype], bad[:3], want))
    device, wall, top = device_profile(
        lambda: [step() for _ in range(5)], 5)
    loss = res["loss"]._data.float().mean().item()
    if not math.isfinite(loss):
        raise AssertionError("phase 27: non-finite loss (%s)" % dtype)
    ms = sorted(times)[len(times) // 2]
    reads = feed.read_ms[:RESNET_STEPS]
    wait = sorted(reads)[len(reads) // 2]
    synthetic = None if gluon_res is None else next(
        g for g in gluon_res
        if g["dtype"] == DTYPE_NAME[dtype])["step_ms_median"]
    serial_ms = sorted(serial)[len(serial) // 2]
    out = dict(dtype=DTYPE_NAME[dtype], flags=flags,
               step_ms_median=ms, img_s=DATA_BATCH / ms * 1e3,
               step_ms_mean=mean_ms, serial_step_ms_median=serial_ms,
               batch_read_ms_median=wait, loss=loss,
               busy_share=device / wall, device_ms=device,
               top_device_ops=top, per_step_counts=want,
               phase16_step_ms_median=synthetic)
    log("phase 27 Gluon ResNet-50 %s (%s) on %s fed by ImageRecordIter "
        "(%s, %d threads), batch %d: ms/step median %.3f over %d steps "
        "(mean %.3f), %.1f img/s; each step synchronized before the next "
        "batch is read: median %.3f; ImageRecordIter.next %.3f ms median; "
        "phase 16 (device batch) %s ms/step; busy %.1f%% (%.3f device ms "
        "a step); every timed step %s; loss %.4f"
        % (DTYPE_NAME[dtype], flags, card, it.decoder, DATA_STEP_THREADS,
           DATA_BATCH, ms, RESNET_STEPS, mean_ms, out["img_s"], serial_ms,
           wait,
           "not run" if synthetic is None else "%.3f" % synthetic,
           100 * out["busy_share"], device, want, loss))
    del net, trainer, res, feed, it
    free_card()
    return out


def data_module_fit(card, rec, steps=4):
    """Phase 27, the Module front end: ``Module.fit`` over ``steps``
    batches of the same iterator (fp32, SGD)."""
    import mxnet_tpu_torch as mt
    tf32_flags()
    it = mt.io.ResizeIter(mt.image.ImageRecordIter(
        path_imgrec=rec, data_shape=DATA_SHAPE, batch_size=DATA_BATCH,
        shuffle=True, rand_mirror=True, preprocess_threads=DATA_STEP_THREADS),
        steps)
    mod = mt.mod.Module(resnet_symbol(torch.float32), context=mt.gpu(0))
    seen = []
    mt.random.seed(0)
    t0 = time.perf_counter()
    mod.fit(it, num_epoch=1, initializer=mt.initializer.Xavier(),
            optimizer="sgd", optimizer_params=(
                ("learning_rate", RESNET_LR), ("momentum", RESNET_MOMENTUM),
                ("wd", RESNET_WD)),
            batch_end_callback=lambda p: seen.append(p.nbatch))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    probs = mod.get_outputs()[0]._data
    finite = bool(torch.isfinite(probs).all().item())
    log("phase 27 Module.fit ResNet-50 fp32 on %s over %d batches of "
        "ImageRecordIter: %.2f s (set-up and captures included), outputs "
        "finite: %s" % (card, len(seen), seconds, finite))
    if len(seen) != steps or not finite:
        raise AssertionError("phase 27 Module.fit: %d batches, finite %s"
                             % (len(seen), finite))
    del mod, it
    free_card()
    return dict(batches=len(seen), seconds=seconds)


def _train_mnist_example():
    import importlib.util
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "examples", "train_mnist.py")
    spec = importlib.util.spec_from_file_location("train_mnist_example",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def gluon_lenet(mt):
    """``build_lenet``'s net as Gluon layers."""
    nn = mt.gluon.nn
    net = nn.HybridSequential()
    with net.name_scope():
        net.add(nn.Conv2D(20, 5, activation="tanh"), nn.MaxPool2D(2, 2),
                nn.Conv2D(50, 5, activation="tanh"), nn.MaxPool2D(2, 2),
                nn.Flatten(), nn.Dense(500, activation="tanh"), nn.Dense(10))
    return net


def phase_data_lenet(card, tmp):
    """Phase 28: idx files at MNIST's sizes, LeNet through ``Module.fit``
    over ``MNISTIter`` for one epoch, then a Gluon LeNet fed by
    ``DataLoader(vision.MNIST(...), num_workers=2)``."""
    import mxnet_tpu_torch as mt
    tf32_flags()
    t0 = time.perf_counter()
    root = mt.test_utils.write_mnist_idx(os.path.join(tmp, "mnist"),
                                         MNIST_TRAIN, MNIST_TEST)
    files = [os.path.join(root, n) for n in mt.test_utils.MNIST_FILES]
    res = {"write_s": time.perf_counter() - t0}
    example = _train_mnist_example()
    mt.random.seed(0)
    train = mt.io.MNISTIter(image=files[0], label=files[1],
                            batch_size=LENET_BATCH, shuffle=True)
    val = mt.io.MNISTIter(image=files[2], label=files[3],
                          batch_size=LENET_BATCH, shuffle=False)
    mod = mt.mod.Module(example.build_lenet(mt), context=mt.gpu(0))
    stamps = []

    def at_end(_):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
    mod.fit(train, optimizer="sgd", initializer=mt.initializer.Xavier(),
            optimizer_params={"learning_rate": LENET_LR,
                              "momentum": LENET_MOMENTUM},
            num_epoch=1, batch_end_callback=at_end)
    gaps = sorted(1e3 * (b - a) for a, b in zip(stamps, stamps[1:]))
    res.update(steps=len(stamps), step_ms_median=gaps[len(gaps) // 2],
               epoch_s=stamps[-1] - stamps[0] if stamps else 0.0,
               accuracy=mod.score(val, "acc")[0][1])
    log("phase 28 LeNet (examples/train_mnist.py) through Module.fit over "
        "MNISTIter on %s (%s), %d x %d idx files written in %.1f s: %d steps "
        "at batch %d, ms/step median %.3f (synchronized at each step's end), "
        "epoch %.1f s; test accuracy %.4f (the JAX package's on the CPU at "
        "the test's size %.4f, bar %.4f)"
        % (card, tf32_flags(), MNIST_TRAIN, MNIST_TEST, res["write_s"],
           res["steps"], LENET_BATCH, res["step_ms_median"], res["epoch_s"],
           res["accuracy"], LENET_JAX_CPU_ACCURACY,
           LENET_JAX_CPU_ACCURACY - 0.02))
    if not res["accuracy"] >= LENET_JAX_CPU_ACCURACY - 0.02:
        raise AssertionError("phase 28: LeNet test accuracy %.4f"
                             % res["accuracy"])
    del mod
    # the Gluon front end on the same files
    gpu = mt.gpu(0)
    data = mt.gluon.data.vision.MNIST(
        root=root, train=True,
        transform=lambda x, y: (x.transpose((2, 0, 1)) / 255.0, y))
    loader = mt.gluon.data.DataLoader(data, batch_size=LENET_BATCH,
                                      shuffle=True, num_workers=2)
    net = gluon_lenet(mt)
    mt.random.seed(0)
    net.initialize(mt.initializer.Xavier(), ctx=gpu)
    net.hybridize()
    trainer = mt.gluon.Trainer(net.collect_params(), "sgd", {
        "learning_rate": LENET_LR, "momentum": LENET_MOMENTUM})
    loss_fn = mt.gluon.loss.SoftmaxCrossEntropyLoss()
    losses, stamps = [], []
    for i, (x, y) in enumerate(loader):
        if i == GLUON_LENET_STEPS:
            break
        x, y = x.as_in_context(gpu), y.as_in_context(gpu)
        with mt.autograd.record():
            loss = loss_fn(net(x), y)
        loss.backward()
        trainer.step(x.shape[0])
        losses.append(loss._data.mean().item())
        stamps.append(time.perf_counter())
    gaps = sorted(1e3 * (b - a) for a, b in zip(stamps, stamps[1:]))
    res["gluon"] = dict(steps=len(losses), first_loss=losses[0],
                        last_loss=losses[-1],
                        step_ms_median=gaps[len(gaps) // 2])
    log("phase 28 Gluon LeNet on %s fed by DataLoader(vision.MNIST, batch "
        "%d, num_workers 2): %d steps, loss %.4f -> %.4f, ms/step median "
        "%.3f" % (card, LENET_BATCH, len(losses), losses[0], losses[-1],
                  res["gluon"]["step_ms_median"]))
    if len(losses) != GLUON_LENET_STEPS or not all(
            math.isfinite(v) for v in losses):
        raise AssertionError("phase 28 Gluon LeNet: losses %s" % losses)
    return res


def phase_data(card, gluon_res):
    """Phases 26-28 in a scratch directory of their own; returns the
    ``{"data": ...}`` line's content and the resize kernel's launches on
    the main path (phase 26's reads and phase 27's steps)."""
    import tempfile
    from mxnet_tpu_torch import profiler
    from mxnet_tpu_torch.ops import attention as att, scale as sc
    from mxnet_tpu_torch.ops import image_nvjpeg as nj
    others = (att.FWD_COUNTER, att.BWD_COUNTER, sc.COUNTER)
    before = {k: profiler.counter(k) for k in others}
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=os.path.dirname(
            os.path.abspath(__file__))) as tmp:
        res, rec = phase_data_loader(card, tmp)
        res["resnet50"] = [data_gluon_resnet(card, rec, dt, gluon_res)
                           for dt in (torch.float32, torch.bfloat16)]
        res["module_fit"] = data_module_fit(card, rec)
        res["lenet"] = phase_data_lenet(card, tmp)
    launches = profiler.counter(nj.COUNTER)
    rounds = profiler.counter(nj.ROUNDS_COUNTER)
    res["card"] = card
    res["seconds"] = time.perf_counter() - t0
    res["resize_launches"] = launches
    res["loader_rounds"] = rounds
    res["other_kernel_launches"] = {k: profiler.counter(k) - before[k]
                                    for k in others}
    log("phases 26-28: %.1f s; resize_rgb_chw launches %d in the loader's "
        "%d rounds; the other hand kernels' %s"
        % (res["seconds"], launches, rounds, res["other_kernel_launches"]))
    if launches == 0 or launches != rounds:
        raise AssertionError("the card's loader launched its resize kernel "
                             "%d times in %d rounds, not once a round"
                             % (launches, rounds))
    if any(res["other_kernel_launches"].values()):
        raise AssertionError("a model kernel ran on the data paths: %s"
                             % res["other_kernel_launches"])
    return res, launches


# -- phase 29: the cv2-style resizes against cv2 (ROADMAP C.7) ----------------
# The sizes, image and bars of tests/test_torch_image.py:77-92: nearest equal
# for uint8, the other interpolations within 1 of 255 (cv2's fixed-point
# weights and its rounding of ties), float32 images within 1e-4; the
# resizing augmenters (tests/test_torch_image.py:194-251) within 1.
CV2_SIZES = [(10, 7), (60, 40), (90, 61), (13, 29), (45, 11)]
CV2_UINT8_ATOL = {0: 0, 1: 1, 2: 1, 3: 1}
CV2_FLOAT_ATOL = 1e-4
CV2_AUG_ATOL = 1.0
CV2_AUG_SEEDS = (0, 3, 7)


def cv2_imresize(src, w, h, interp=1):
    """The JAX package's ``imresize`` (``mxnet_tpu/image/image.py:73``):
    ``cv2.resize`` of the HWC image, a host NDArray of cv2's dtype."""
    import cv2
    from mxnet_tpu_torch.image import image as im
    out = cv2.resize(im._to_np(src), (w, h), interpolation=interp)
    return im._wrap(out[:, :, None] if out.ndim == 2 else out)


def cv2_augmenters(mt):
    """The resizing augmenters of tests/test_torch_image.py, and
    ``CreateAugmenter`` with ``resize``."""
    im = mt.image
    return {
        "ResizeAug": lambda: [im.ResizeAug(32, 1)],
        "ForceResizeAug": lambda: [im.ForceResizeAug((50, 30), 2)],
        "RandomSizedCropAug": lambda: [im.RandomSizedCropAug(
            (24, 24), 0.3, (0.75, 1.33), 1)],
        "CenterCropAug(resize)": lambda: [im.CenterCropAug((80, 50), 0)],
        "CreateAugmenter(resize=50)": lambda: im.CreateAugmenter(
            (3, 24, 24), resize=50, rand_crop=True, rand_resize=True,
            mean=True, std=True, brightness=0.1, contrast=0.1,
            saturation=0.1, pca_noise=0.1),
        "CreateAugmenter(resize=30)": lambda: im.CreateAugmenter(
            (3, 24, 24), resize=30, rand_mirror=True),
    }


def _augment(augs, img, seed):
    """Three draws of the augmenter list on ``img`` from one seed."""
    import random
    random.seed(seed)
    np.random.seed(seed)
    outs = []
    for _ in range(3):
        x = img
        for aug in augs:
            x = aug(x)[0]
        outs.append(np.asarray(x.asnumpy() if hasattr(x, "asnumpy") else x,
                               np.float64))
    return outs


def phase_cv2_resize(card):
    """Phase 29 on the card's host: ``image.imresize`` against
    ``cv2.resize`` at each size and interpolation, uint8 and float32, then
    the resizing augmenters against themselves with ``cv2.resize`` in
    place of the port's resize (the JAX package's resize), from one seed.
    Fails when cv2 is missing."""
    import importlib.util
    from unittest import mock
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch.image import image as im
    if importlib.util.find_spec("cv2") is None:
        raise AssertionError("phase 29: cv2 is not installed on this host; "
                             "C.7 cannot be checked")
    import cv2
    img = np.random.RandomState(0).randint(0, 256, (40, 60, 3)) \
        .astype(np.uint8)
    worst = {"uint8": {}, "float32": {}}
    bad = []
    for (w, h), interp in itertools.product(CV2_SIZES, range(4)):
        for src, kind in ((img, "uint8"), (img.astype(np.float32),
                                          "float32")):
            got = mt.image.imresize(src, w, h, interp).asnumpy()
            want = cv2_imresize(src, w, h, interp).asnumpy()
            if got.shape != want.shape or got.dtype != want.dtype:
                bad.append("imresize %s %s interp %d: %s %s against cv2's "
                           "%s %s" % (kind, (w, h), interp, got.dtype,
                                      got.shape, want.dtype, want.shape))
                continue
            err = float(np.abs(got.astype(np.float64) - want).max())
            worst[kind][interp] = max(worst[kind].get(interp, 0.0), err)
            limit = CV2_UINT8_ATOL[interp] if kind == "uint8" \
                else CV2_FLOAT_ATOL
            if err > limit:
                bad.append("imresize %s %s interp %d: max|diff| %g > %g"
                           % (kind, (w, h), interp, err, limit))
    augs = {}
    for name, make in cv2_augmenters(mt).items():
        err = 0.0
        for seed in CV2_AUG_SEEDS:
            src = mt.nd.array(img, ctx=mt.cpu(), dtype=np.uint8)
            got = _augment(make(), src, seed)
            with mock.patch.object(im, "imresize", cv2_imresize):
                want = _augment(make(), src, seed)
            for a, b in zip(got, want):
                if a.shape != b.shape:
                    bad.append("%s seed %d: shape %s against %s"
                               % (name, seed, a.shape, b.shape))
                    continue
                err = max(err, float(np.abs(a - b).max()))
        augs[name] = err
        if err > CV2_AUG_ATOL:
            bad.append("%s: max|diff| %g > %g" % (name, err, CV2_AUG_ATOL))
    out = dict(cv2=cv2.__version__, sizes=CV2_SIZES,
               imresize_max_abs_diff=worst, augmenters_max_abs_diff=augs,
               cases=len(CV2_SIZES) * 4 * 2, seeds=list(CV2_AUG_SEEDS))
    log("phase 29 on the host of %s: cv2 %s; imresize against cv2.resize at "
        "%d sizes x 4 interpolations: max|diff| uint8 %s, float32 %s; "
        "resizing augmenters with cv2.resize in place of the port's, seeds "
        "%s: %s" % (card, cv2.__version__, len(CV2_SIZES), worst["uint8"],
                    worst["float32"], list(CV2_AUG_SEEDS), augs))
    if bad:
        raise AssertionError("phase 29 (C.7): %s" % "; ".join(bad[:8]))
    return out


# -- phase 30: the kvstore and several contexts (ROADMAP A.7) -----------------
# (a) BASELINE #4, Inception-v3 data-parallel through a kvstore, at one card:
# examples/train_inception_v3.py's set-up (phase 20a's module), the update
# on a store (mt.kv.create("device")) against the captured step without a
# store, 3 steps from one init, every Dropout rate 0 so that the captured
# and the eager step draw nothing; then 10 timed steps on the store.
KV_PARITY_STEPS, KV_WARMUP, KV_TIMED = 3, 3, 10
KV_FIT_BATCHES = 6
# (b) the MLP of phase 7 on two devices, 20 steps, held to the same run on
# two CPU contexts at phase 8's bars (loss 1e-5, weights 1e-4: fp32 sums in
# cuBLAS's order against the CPU's, through the updates).
KV_MLP_STEPS, KV_MLP_WORKLOAD = 20, [3, 1]
KV_MLP_LOSS_TOL, KV_MLP_W_TOL = 1e-5, 1e-4
KV_BUCKET_TIMING_ITERS = 5


def _kv_module(sym, ctxs, batch, dtype, work_load_list=None):
    """A Module of ``sym`` bound on ``ctxs`` at ``batch`` x 3 x 299 x 299."""
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch.io import DataDesc
    mod = mt.mod.Module(sym, context=ctxs, work_load_list=work_load_list)
    mod.bind(data_shapes=[DataDesc("data", (batch, 3, INCEPTION_IMAGE,
                                            INCEPTION_IMAGE), dtype=dtype)],
             label_shapes=[DataDesc("softmax_label", (batch,),
                                    dtype="float32")])
    return mod


def _kv_inception_run(sym, init, dtype, kvstore, db, steps):
    """``steps`` fit steps of Inception-v3 from ``init`` on ``gpu(0)``
    under ``kvstore``: the module, its train state, and each step's
    counters."""
    import mxnet_tpu_torch as mt
    mod = _kv_module(sym, [mt.gpu(0)], INCEPTION_BATCH, dtype)
    mod.set_params(*init)
    mod.init_optimizer(kvstore=kvstore, optimizer="sgd", optimizer_params=(
        ("learning_rate", INCEPTION_LR), ("momentum", RESNET_MOMENTUM),
        ("wd", RESNET_WD)))
    counts = []
    for _ in range(steps):
        before = mt.profiler.counters()
        mod._fit_step(db)
        torch.cuda.synchronize()
        after = mt.profiler.counters()
        counts.append({k: after.get(k, 0) - before.get(k, 0) for k in
                       STEP_COUNTERS + ("kvstore_push", "kvstore_pull")})
    return mod, module_train_state(mod), counts


def kv_inception(card, dtype):
    """(a) at one dtype: the store run against two runs without a store,
    then the store's timed steps."""
    import mxnet_tpu_torch as mt
    flags = tf32_flags() if dtype == torch.float32 else "bf16"
    sym = resnet_symbol(dtype, "inceptionv3", dropout=0.0)
    mod = _kv_module(sym, [mt.gpu(0)], INCEPTION_BATCH, dtype)
    mt.random.seed(0)
    mod.init_params(initializer=mt.initializer.Xavier())
    init = mod.get_params()
    del mod
    db = resnet_batch(mt.gpu(0), INCEPTION_BATCH, dtype,
                      image=INCEPTION_IMAGE)
    states = {}
    # cuDNN's fp32 backward is not repeatable by default (two fp32 runs
    # without a store differ in every weight after 3 steps at lr 0.05), and
    # one pair of such runs is no bound for another: the parity runs take
    # its deterministic algorithms, as phase 19 does
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for run in ("a", "store", "c"):
            kv = mt.kv.create("device") if run == "store" else "device"
            m, states[run], counts = _kv_inception_run(
                sym, init, dtype, kv, db, KV_PARITY_STEPS)
            if run == "store":
                store_mod, store_counts = m, counts
            else:
                del m
                free_card()
    finally:
        torch.backends.cudnn.deterministic = prev
    n_params = sum(1 for g in store_mod._exec_group.grad_arrays
                   if g is not None)
    # the store's two-call step replays the executor's forward_backward:
    # one replay a step, captured at the first
    replays = [(c["graph_captures"], c["graph_replays"]) for c in store_counts]
    if replays != [(1, 1)] + [(0, 1)] * (len(replays) - 1):
        raise AssertionError("phase 30a %s: the store's steps (captures, "
                             "replays) %s" % (DTYPE_NAME[dtype], replays))
    per_step = {(c["kvstore_push"], c["kvstore_pull"]) for c in store_counts}
    if per_step != {(n_params, n_params)} or not store_mod._update_on_kvstore \
            or store_mod._cached_step is not None:
        raise AssertionError("phase 30a %s: pushes and pulls a step %s, want "
                             "%d each, on the store (%s)" % (
                                 DTYPE_NAME[dtype], sorted(per_step),
                                 n_params, store_mod._update_on_kvstore))
    gap = _bit_gap(states["a"], states["store"])
    spread = _bit_gap(states["a"], states["c"])
    del states
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = _timed(lambda: store_mod._fit_step(db), KV_WARMUP + KV_TIMED)
    ms = _median(times[KV_WARMUP:])
    out = dict(dtype=DTYPE_NAME[dtype], flags=flags, batch=INCEPTION_BATCH,
               cudnn_deterministic_parity=True,
               params=n_params, pushes_per_step=n_params,
               pulls_per_step=n_params, store_vs_no_store_bits_differ=gap[0],
               store_vs_no_store_max_abs=gap[1], rerun_bits_differ=spread[0],
               rerun_max_abs=spread[1], bitwise=gap[0] == 0,
               step_ms_median=ms, img_s=INCEPTION_BATCH / ms * 1e3,
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
               store_captures_replays=replays)
    log("phase 30a Inception-v3 %s (%s) on %s, batch %d, SGD lr %g through "
        "mt.kv.create('device') (update on the store, %d pushes and %d pulls "
        "a step): cuDNN deterministic, against the captured step without a "
        "store after %d steps "
        "%d elements differ in their bits (max |diff| %.3g); two runs without "
        "a store %d (%.3g); ms/step median of %d after %d: %.3f, %.1f img/s, "
        "peak memory %.2f GB" % (
            DTYPE_NAME[dtype], flags, card, INCEPTION_BATCH, INCEPTION_LR,
            n_params, n_params, KV_PARITY_STEPS, gap[0], gap[1], spread[0],
            spread[1], KV_TIMED, KV_WARMUP, ms, out["img_s"],
            out["peak_mem_gb"]))
    if gap[0] and gap[1] > spread[1]:
        raise AssertionError(
            "phase 30a %s: the store's run lies %.3g from the run without a "
            "store, beyond the %.3g between two runs without one"
            % (DTYPE_NAME[dtype], gap[1], spread[1]))
    del store_mod
    free_card()
    return out


def kv_inception_fit(card):
    """(a) examples/train_inception_v3.py:67-72 through the port: Module on
    the context list [gpu(0)], ``fit(kvstore="device")`` over an
    NDArrayIter of seeded images; each step after the first must be one
    replay and no capture (phase 20a's)."""
    import mxnet_tpu_torch as mt
    tf32_flags()
    rng = np.random.RandomState(0)
    n = INCEPTION_BATCH * KV_FIT_BATCHES
    x = rng.rand(n, 3, INCEPTION_IMAGE, INCEPTION_IMAGE).astype(np.float32)
    y = rng.randint(0, 1000, n).astype(np.float32)
    it = mt.io.NDArrayIter(x, y, batch_size=INCEPTION_BATCH,
                           label_name="softmax_label")
    mod = mt.mod.Module(resnet_symbol(torch.float32, "inceptionv3"),
                        context=[mt.gpu(0)])
    steps, last = [], [mt.profiler.counters()]

    def per_batch(param):
        torch.cuda.synchronize()
        now = mt.profiler.counters()
        steps.append({k: now.get(k, 0) - last[0].get(k, 0)
                      for k in STEP_COUNTERS})
        last[0] = now

    mt.random.seed(0)
    mod.fit(it, num_epoch=1, kvstore="device", optimizer="sgd",
            optimizer_params={"learning_rate": INCEPTION_LR,
                              "momentum": RESNET_MOMENTUM, "wd": RESNET_WD},
            initializer=mt.initializer.Xavier(), batch_end_callback=per_batch)
    timed = steps[1:]
    want = [dict(graph_captures=0, graph_replays=1, program_calls=1)] \
        * len(timed)
    log("phase 30a examples/train_inception_v3.py set-up on %s: Module on "
        "[gpu(0)], fit(kvstore='device') over %d batches: store %s, counters "
        "a step %s" % (card, len(steps), mod._kvstore, steps))
    if len(steps) != KV_FIT_BATCHES or timed != want \
            or mod._kvstore is not None:
        raise AssertionError("phase 30a fit: %d steps, counters %s, store %s"
                             % (len(steps), steps, mod._kvstore))
    del mod, it
    free_card()
    return dict(batches=len(steps), counters_per_step=steps)


def _kv_mlp_batches(mt):
    x, y, _, _ = _mnist_on(mt.cpu())
    from mxnet_tpu_torch.io import DataBatch
    return [DataBatch([x[i * MLP_BATCH:(i + 1) * MLP_BATCH]],
                      [y[i * MLP_BATCH:(i + 1) * MLP_BATCH]])
            for i in range(KV_MLP_STEPS)]


def kv_mlp_module(ctxs, kvstore, batches):
    """(b) phase 7's MLP through Module on ``ctxs`` (``KV_MLP_WORKLOAD``):
    each step's loss and the weights after the last, on the host."""
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import sym
    from mxnet_tpu_torch.io import DataDesc
    mod = mt.mod.Module(build_mlp(sym), context=ctxs,
                        work_load_list=KV_MLP_WORKLOAD)
    mod.bind([DataDesc("data", (MLP_BATCH, 784))],
             [DataDesc("softmax_label", (MLP_BATCH,))])
    mt.random.seed(0)
    mod.init_params(mt.init.Xavier())
    mod.init_optimizer(kvstore=kvstore, optimizer="sgd", optimizer_params=(
        ("learning_rate", MLP_LR), ("momentum", MLP_MOMENTUM)))
    losses = []
    for db in batches:
        mod._fit_step(db)
        prob = torch.cat([o._data.cpu() for o in mod.get_outputs(False)[0]])
        picked = prob.gather(1, db.label[0]._data.long().view(-1, 1))
        losses.append(float(-torch.log(picked).mean()))
    arg, _ = mod.get_params()
    return dict(losses=losses, weights={n: a._data.clone()
                                        for n, a in arg.items()},
                slices=[s.stop - s.start for s in mod._exec_group.slices],
                on_store=mod._update_on_kvstore)


def kv_mlp_gluon(ctxs, batches):
    """(b) the same MLP's widths through Gluon: ``split_and_load`` over
    ``ctxs``, one backward over the slices' losses, ``Trainer(kvstore=
    "device")``."""
    import mxnet_tpu_torch as mt
    nn = mt.gluon.nn
    net = nn.HybridSequential(prefix="kvmlp_")
    with net.name_scope():
        net.add(nn.Dense(128, activation="relu", in_units=784),
                nn.Dense(64, activation="relu", in_units=128),
                nn.Dense(10, in_units=64))
    mt.random.seed(0)
    net.initialize(mt.init.Xavier(), ctx=ctxs)
    trainer = mt.gluon.Trainer(net.collect_params(), "sgd", {
        "learning_rate": MLP_LR, "momentum": MLP_MOMENTUM}, kvstore="device")
    loss_fn = mt.gluon.loss.SoftmaxCrossEntropyLoss()
    losses = []
    for db in batches:
        xs = mt.gluon.utils.split_and_load(db.data[0], ctxs)
        ys = mt.gluon.utils.split_and_load(db.label[0], ctxs)
        with mt.autograd.record():
            parts = [loss_fn(net(x), y) for x, y in zip(xs, ys)]
        mt.autograd.backward(parts)
        trainer.step(MLP_BATCH)
        losses.append(float(sum(p._data.detach().double().sum().cpu()
                                for p in parts) / MLP_BATCH))
    return dict(losses=losses,
                weights={n: p.data()._data.detach().cpu().clone()
                         for n, p in net.collect_params().items()},
                store=trainer._kvstore.type)


def _kv_mlp_gaps(a, b):
    loss = max(abs(x - y) for x, y in zip(a["losses"], b["losses"]))
    w = max(float((a["weights"][n].cpu() - b["weights"][n].cpu()).abs()
                   .max()) for n in a["weights"])
    return loss, w


def kv_two_devices(card):
    """(b) ``[gpu(0), cpu(0)]`` against ``[cpu(0), cpu(1)]``: Module under
    "device" and "local" (workload 3:1), Gluon under "device"."""
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch.ops import scale as sc
    tf32_flags()
    register_pl_scale()
    batches = _kv_mlp_batches(mt)
    two = [mt.gpu(0), mt.cpu(0)]
    cpus = [mt.cpu(0), mt.cpu(1)]
    out, bad = {}, []
    for kv in ("device", "local"):
        sc.reset_launch_count()
        card_run = kv_mlp_module(two, kv, batches)
        launches = sc.launch_count()
        cpu_run = kv_mlp_module(cpus, kv, batches)
        loss, w = _kv_mlp_gaps(card_run, cpu_run)
        out["module_" + kv] = dict(
            loss_max_abs_err=loss, weights_max_abs_err=w,
            slices=card_run["slices"], on_store=card_run["on_store"],
            scale_launches=launches, first_loss=card_run["losses"][0],
            last_loss=card_run["losses"][-1])
        # the card's executor replays its captured forward_backward: the
        # steps' launches and its capture's warm-ups
        if loss > KV_MLP_LOSS_TOL or w > KV_MLP_W_TOL or \
                launches != KV_MLP_STEPS + mt.capture.WARMUP_RUNS \
                or not card_run["on_store"]:
            bad.append("Module %s: loss %.3g, weights %.3g, %d launches, on "
                       "the store %s" % (kv, loss, w, launches,
                                         card_run["on_store"]))
    card_run, cpu_run = kv_mlp_gluon(two, batches), kv_mlp_gluon(cpus,
                                                                  batches)
    loss, w = _kv_mlp_gaps(card_run, cpu_run)
    out["gluon_device"] = dict(loss_max_abs_err=loss, weights_max_abs_err=w,
                               first_loss=card_run["losses"][0],
                               last_loss=card_run["losses"][-1])
    if loss > KV_MLP_LOSS_TOL or w > KV_MLP_W_TOL:
        bad.append("Gluon: loss %.3g, weights %.3g" % (loss, w))
    log("phase 30b MLP (784-128-64-10, pl_scale) on [gpu(0), cpu(0)] "
        "against [cpu(0), cpu(1)], %d steps, fp32 (TF32 off), on %s: %s"
        % (KV_MLP_STEPS, card, out))
    if bad:
        raise AssertionError("phase 30b: %s" % "; ".join(bad))
    return out


def kv_bucketed_round(card, dtype):
    """(c) ``push_pull_all`` over Inception-v3's gradient shapes, two copies
    on ``gpu(0)``, against the CPU store's on the same inputs (bit for
    bit), one reduce a bucket; its ms against the per-key loop."""
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch.kvstore import _plan_buckets
    from mxnet_tpu_torch.base import dtype_name
    sym = resnet_symbol(dtype, "inceptionv3")
    args, _, _ = sym.infer_shape(data=(INCEPTION_BATCH, 3, INCEPTION_IMAGE,
                                       INCEPTION_IMAGE),
                                 softmax_label=(INCEPTION_BATCH,))
    shapes = [tuple(s) for n, s in zip(sym.list_arguments(), args)
              if n not in ("data", "softmax_label")]
    dev = mt.gpu(0).torch_device
    gen = torch.Generator(device=dev).manual_seed(30)
    copies = [[torch.randn(s, generator=gen, device=dev).to(dtype)
               for _ in range(2)] for s in shapes]
    keys = list(range(len(shapes)))

    def store(ctx, vals):
        kv = mt.kv.create("device")
        for k, s in zip(keys, shapes):
            kv.init(k, mt.nd.zeros(s, ctx=ctx, dtype=dtype))
        return kv, [[mt.nd.NDArray(t, ctx) for t in v] for v in vals]

    kv, vals = store(mt.gpu(0), copies)
    before = mt.profiler.counters()
    got = kv.push_pull_all(keys, vals)
    torch.cuda.synchronize()
    after = mt.profiler.counters()
    buckets = after.get("kvstore_bucket_reduce", 0) \
        - before.get("kvstore_bucket_reduce", 0)
    nbytes = [c[0].numel() * c[0].element_size() for c in copies]
    plan = _plan_buckets([((dtype_name(dtype), 2, mt.gpu(0)), b)
                          for b in nbytes])
    kv_cpu, vals_cpu = store(mt.cpu(), [[t.cpu() for t in v]
                                        for v in copies])
    want = kv_cpu.push_pull_all(keys, vals_cpu)
    differ = sum(int((g._data.cpu() != w._data).sum())
                 for g, w in zip(got, want))
    outs = [mt.nd.zeros(s, ctx=mt.gpu(0), dtype=dtype) for s in shapes]

    def per_key():
        for k, v, o in zip(keys, vals, outs):
            kv.push(k, v)
            kv.pull(k, out=o)

    bucketed_ms = cuda_ms(lambda: kv.push_pull_all(keys, vals, outs=outs),
                          iters=KV_BUCKET_TIMING_ITERS, warmup=1)
    per_key_ms = cuda_ms(per_key, iters=KV_BUCKET_TIMING_ITERS, warmup=1)
    total = sum(nbytes)
    res = dict(dtype=DTYPE_NAME[dtype], keys=len(keys), bytes=total,
               buckets=buckets, planned_buckets=len(plan),
               elements_differ_from_cpu=differ, bucketed_ms=bucketed_ms,
               per_key_ms=per_key_ms,
               bound_ms=3 * total / HBM_BPS * 1e3)
    log("phase 30c push_pull_all over Inception-v3's %d gradients (%s, %d "
        "bytes a copy, 2 copies on gpu(0)) on %s: %d bucket reduces (plan "
        "%d), %d elements differ from the CPU store's; %.3f ms with the "
        "broadcast into outs against %.3f ms for the per-key push/pull loop "
        "(bound to read two copies and write one: %.3f ms)"
        % (len(keys), DTYPE_NAME[dtype], total, card, buckets, len(plan),
           differ, bucketed_ms, per_key_ms, res["bound_ms"]))
    if differ or buckets != len(plan):
        raise AssertionError("phase 30c %s: %d elements differ, %d bucket "
                             "reduces for %d buckets" % (
                                 DTYPE_NAME[dtype], differ, buckets,
                                 len(plan)))
    del kv, vals, copies, got, outs
    free_card()
    return res


def phase_kvstore(card):
    """Phase 30: (a) BASELINE #4 through the store and the example's
    ``fit``, (b) two devices, (c) the bucketed round."""
    out = {"card": card}
    out["inception"] = {DTYPE_NAME[dt]: kv_inception(card, dt)
                        for dt in (torch.float32, torch.bfloat16)}
    out["inception_fit"] = kv_inception_fit(card)
    out["two_devices"] = kv_two_devices(card)
    out["bucketed_round"] = {DTYPE_NAME[dt]: kv_bucketed_round(card, dt)
                             for dt in (torch.float32, torch.bfloat16)}
    return out


# -- phase 31: the op long tail (ROADMAP A.9): SSD, NMS and Custom ops --------
# BASELINE #5 is example/ssd; the repo has its toy (examples/train_ssd_toy.py)
# and no SSD network, so the SSD ops are also driven at the head shapes of
# MXNet's example/ssd/symbol/symbol_factory.py (vgg16_reduced, data_shape
# 300): six feature maps, each with its anchor sizes, ratios and step, 8,732
# anchors in all; batch 32 and VOC's 21 classes; MultiBoxTarget and
# MultiBoxDetection at the example's settings; labels padded to 64 rows.
SSD300_MAPS = (38, 19, 10, 5, 3, 1)
SSD300_SIZES = ((0.1, 0.141), (0.2, 0.272), (0.37, 0.447), (0.54, 0.619),
                (0.71, 0.79), (0.88, 0.961))
SSD300_RATIOS = ((1.0, 2.0, 0.5),) + ((1.0, 2.0, 0.5, 3.0, 1.0 / 3.0),) * 3 \
    + ((1.0, 2.0, 0.5),) * 2
SSD300_STEPS = tuple(s / 300.0 for s in (8, 16, 32, 64, 100, 300))
SSD300_ANCHORS = 8732
SSD300_BATCH, SSD300_CLASSES, SSD300_LABEL_ROWS = 32, 21, 64
SSD300_TARGET = dict(overlap_threshold=0.5, ignore_label=-1.0,
                     negative_mining_ratio=3.0, negative_mining_thresh=0.5,
                     minimum_negative_samples=0,
                     variances=(0.1, 0.1, 0.2, 0.2))
SSD300_DETECT = dict(threshold=0.01, nms_threshold=0.45,
                     force_suppress=False, variances=(0.1, 0.1, 0.2, 0.2))
SSD300_NMS_TOPK = (400, -1)
# card against cpu(): the ops' values (decode, offsets) within 1e-6; the
# classes, masks and row order equal
SSD_OP_TOL = 1e-6
# Proposal at its default rpn_pre_nms_top_n (6000) on a Faster R-CNN VGG-16
# feature map (a 600 x 800 image at stride 16, 9 anchors a cell)
PROPOSAL_NMS = dict(shape=(2, 18, 38, 50), im_info=(600.0, 800.0, 1.0),
                    pre_n=6000, threshold=0.7, min_size=16,
                    scales=(8.0, 16.0, 32.0), ratios=(0.5, 1.0, 2.0),
                    stride=16)
# ragged kernel cases: (n, dtype, force_suppress, trip); the tile edges (n
# 63, 64, 65 and 129, trips no multiple of 64), then sizes up to 12,000
# (fp64 at 8,732 and fp32 at 12,000 past what a block's shared memory holds
# of the boxes)
NMS_RAGGED = ((1, torch.float32, False, 1), (7, torch.float32, True, 7),
              (63, torch.float32, False, 63), (64, torch.float64, True, 61),
              (65, torch.float32, True, 65), (65, torch.float64, False, 33),
              (129, torch.float32, False, 100),
              (129, torch.float64, True, 129),
              (129, torch.float32, True, 77),
              (1000, torch.float32, False, 500),
              (1025, torch.float32, True, 1025),
              (3001, torch.float64, False, 3001),
              (SSD300_ANCHORS, torch.float64, False, SSD300_ANCHORS),
              (12000, torch.float32, False, 12000))
NMS_ODD_CLASSES = (0.0, -0.0, 64.0, 128.0, -64.0, 1.0, 65.0, 0.5, 2.0 ** 31,
                   1e10, math.nan, 3.0)
# per IoU: 4 max/min, 6 subtractions, 6 clamps, 2 products, an add, a
# divide, the compare (nms.iou_row) -- fp32 work off the tensor cores
NMS_IOU_OPS = 21
NMS_TIMING_ITERS = 10
# examples/train_ssd_toy.py's settings
TOY_SSD = dict(n_train=256, img=32, epochs=4, batch=16, lr=0.01, n_val=64,
               sizes=(0.4, 0.6), ratios=(1.0, 2.0, 0.5), num_cls=1,
               overlap=0.5, threshold=0.01, nms_threshold=0.45)
TOY_SSD_MIN_IOU = 0.35
TOY_SSD_PARITY_STEPS = 3


def _ssd_example():
    import importlib.util
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "examples", "train_ssd_toy.py")
    spec = importlib.util.spec_from_file_location("train_ssd_toy_example",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def ssd300_anchors(pkg, ctx, dtype="float32"):
    """The SSD-300 head's anchors (1, 8732, 4): MultiBoxPrior on each map,
    concatenated."""
    nd = pkg.nd
    parts = [nd.contrib.MultiBoxPrior(
        nd.zeros((1, 1, m, m), ctx=ctx, dtype=dtype), sizes=s, ratios=r,
        steps=(st, st), offsets=(0.5, 0.5))
        for m, s, r, st in zip(SSD300_MAPS, SSD300_SIZES, SSD300_RATIOS,
                               SSD300_STEPS)]
    return nd.concatenate(parts, axis=1)


def ssd300_inputs(seed=31, dwdh=False):
    """Seeded host inputs at the head's shapes: labels (32, 64, 5) with
    1-20 VOC boxes an image, class predictions (32, 21, 8732), softmax
    probabilities and box offsets (32, 4 * 8732).  Without ``dwdh`` the
    width and height offsets are 0, so the decode is exact arithmetic on
    every device (exp(0) = 1) and the card can be held to the CPU row for
    row: with them, each device's exp rounds its own way, and a box whose
    IoU lies an ulp from the threshold may be kept on one and not the
    other."""
    rng = np.random.RandomState(seed)
    b, c, a = SSD300_BATCH, SSD300_CLASSES, SSD300_ANCHORS
    label = np.full((b, SSD300_LABEL_ROWS, 5), -1.0, np.float32)
    for i in range(b):
        n = rng.randint(1, 21)
        xy = rng.uniform(0.0, 0.8, (n, 2))
        wh = rng.uniform(0.05, 0.5, (n, 2))
        label[i, :n, 0] = rng.randint(0, c - 1, n)
        label[i, :n, 1:3] = xy
        label[i, :n, 3:5] = np.minimum(xy + wh, 1.0)
    cls_pred = rng.randn(b, c, a).astype(np.float32)
    logits = 2.0 * rng.randn(b, c, a)
    prob = np.exp(logits - logits.max(axis=1, keepdims=True))
    prob = (prob / prob.sum(axis=1, keepdims=True)).astype(np.float32)
    loc = 0.1 * rng.randn(b, a, 4)
    if not dwdh:
        loc[..., 2:] = 0.0
    return dict(label=label, cls_pred=cls_pred, cls_prob=prob,
                loc_pred=loc.reshape(b, -1).astype(np.float32))


def nms_bound_ms(boxes, classes, kept, force):
    """(bound ms, "bytes" or "operations", pairs): the sorted boxes, the
    class ids and the mask read once and the mask written once over HBM,
    or NMS_IOU_OPS fp32 operations for each IoU this run's data needs at
    the least: every (kept box, later kept box of its class) pair, which
    the walk cannot skip."""
    b, n = classes.shape
    elem = boxes.element_size()
    t_bytes = (b * n * 5 * elem + 2 * b * n) / HBM_BPS
    pairs = 0
    cls = classes.cpu().numpy()
    keep = kept.cpu().numpy()
    for i in range(b):
        c = cls[i][keep[i]]
        if force:
            pairs += len(c) * (len(c) - 1) // 2
        else:
            _, counts = np.unique(c, return_counts=True)
            pairs += int((counts * (counts - 1) // 2).sum())
    t_ops = pairs * NMS_IOU_OPS / PEAK_FLOPS[torch.float32]
    by = "bytes" if t_bytes >= t_ops else "operations"
    return 1e3 * max(t_bytes, t_ops), by, pairs


def nms_mask_pairs(classes, trip, force):
    """The pairs (i, j), i < trip and i < j, that ``mask_kernel`` visits
    in this run's images: every one with force; class-aware, those whose
    class buckets (``test_utils.nms_class_buckets``) agree, and every one
    of a row in bucket 64."""
    from mxnet_tpu_torch.test_utils import nms_class_buckets
    b, n = classes.shape
    rows = np.arange(trip)
    if force:
        return b * int((n - 1 - rows).sum())
    pairs = 0
    for key in nms_class_buckets(classes).cpu().numpy():
        for k in np.unique(key[:trip]):
            pos = np.flatnonzero(key == k)
            later = (n - 1 - pos if k == 64
                     else len(pos) - 1 - np.arange(len(pos)))
            pairs += int(later[pos < trip].sum())
    return pairs


def nms_tile_steps(n, trip):
    """``walk_kernel``'s steps, one barrier each: a tile up to ``trip``,
    and one more where a column tile follows (``steps`` in ``nms.cu``;
    ``test_utils.nms_tiled`` returns the same count)."""
    words, tiles = -(-n // 64), -(-trip // 64)
    return min(tiles + 1, words)


def nms_cases(dev):
    """The kernel's inputs: SSD-300 detection at both nms_topk, Proposal at
    its pre-NMS 6000, and the ragged cases."""
    from mxnet_tpu_torch.ops import rcnn, ssd
    import mxnet_tpu_torch as mt
    inp = ssd300_inputs(dwdh=True)
    anchors = ssd300_anchors(mt, mt.gpu(0))._data.to(dev)
    dets = ssd.detection_candidates(
        torch.tensor(inp["cls_prob"], device=dev),
        torch.tensor(inp["loc_pred"], device=dev), anchors, True,
        SSD300_DETECT["threshold"], 0, SSD300_DETECT["variances"])
    cases = []
    for topk in SSD300_NMS_TOPK:
        cases.append(dict(
            name="ssd300 nms_topk %d" % topk, boxes=dets[..., 2:6],
            classes=dets[..., 0], alive=dets[..., 0] >= 0,
            trip=ssd.nms_trip(topk, SSD300_ANCHORS),
            threshold=SSD300_DETECT["nms_threshold"], force=False))
    p = PROPOSAL_NMS
    rng = np.random.RandomState(32)
    n, a2, h, w = p["shape"]
    boxes, scores = rcnn.proposal_candidates(
        torch.tensor(rng.rand(n, a2, h, w), dtype=torch.float32, device=dev),
        torch.tensor(0.1 * rng.randn(n, 2 * a2, h, w), dtype=torch.float32,
                     device=dev),
        torch.tensor([p["im_info"]] * n, dtype=torch.float32, device=dev),
        p["pre_n"], p["min_size"], p["scales"], p["ratios"], p["stride"])
    cases.append(dict(name="proposal pre_nms_top_n %d" % p["pre_n"],
                      boxes=boxes, classes=torch.zeros_like(scores),
                      alive=scores > -math.inf, trip=p["pre_n"],
                      threshold=p["threshold"], force=True))
    for n_box, dt, force, trip in NMS_RAGGED:
        xy = rng.uniform(0, 0.8, (2, n_box, 2))
        wh = rng.uniform(0.02, 0.4, (2, n_box, 2))
        cases.append(dict(
            name="ragged n %d %s%s trip %d" % (
                n_box, DTYPE_NAME.get(dt, "fp64"), " force" if force else "",
                trip),
            boxes=torch.tensor(np.concatenate([xy, xy + wh], -1), dtype=dt,
                               device=dev),
            classes=torch.tensor(rng.randint(0, 4, (2, n_box)), dtype=dt,
                                 device=dev),
            alive=torch.tensor(rng.rand(2, n_box) < 0.9, device=dev),
            trip=trip, threshold=0.5, force=force))
    # classes that share the mask kernel's class buckets (c & 63) or fall
    # in its bucket of the rest (fractional, beyond 2**31, NaN)
    xy = rng.uniform(0, 0.8, (2, 300, 2))
    wh = rng.uniform(0.02, 0.4, (2, 300, 2))
    cases.append(dict(
        name="ragged n 300 fp32 odd classes trip 250",
        boxes=torch.tensor(np.concatenate([xy, xy + wh], -1),
                           dtype=torch.float32, device=dev),
        classes=torch.tensor(rng.choice(NMS_ODD_CLASSES, (2, 300)),
                             dtype=torch.float32, device=dev),
        alive=torch.tensor(rng.rand(2, 300) < 0.9, device=dev),
        trip=250, threshold=0.5, force=False))
    return cases


def nms_kernel_check(card):
    """31 (a): the NMS kernels against their plain version on the card, mask
    for mask; ms, the plain version's ms and the bound at the main
    shapes."""
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch.ops import nms as nm
    dev = mt.gpu(0).torch_device
    rows, bad = {}, []
    for c in nms_cases(dev):
        args = (c["boxes"], c["classes"], c["alive"], c["trip"],
                c["threshold"], c["force"])
        got = nm.nms(*args)
        want = nm.nms_reference(*args)
        torch.cuda.synchronize()
        again = nm.nms(*args)
        differ = int((got != want).sum())
        row = dict(shape=list(c["boxes"].shape), trip=c["trip"],
                   kept=int(got.sum()), alive_in=int(c["alive"].sum()),
                   masks_differ=differ, repeat_equal=bool(torch.equal(
                       got, again)))
        if differ or not row["repeat_equal"]:
            bad.append(c["name"])
        if not c["name"].startswith("ragged"):
            row["ms"] = cuda_ms(lambda: nm.nms(*args),
                                iters=NMS_TIMING_ITERS, warmup=2)
            row["plain_ms"] = cuda_ms(lambda: nm.nms_reference(*args),
                                      iters=1, warmup=1)
            row["bound_ms"], row["bound_by"], row["pairs"] = nms_bound_ms(
                c["boxes"], c["classes"], got, c["force"])
            # the longest image's kept boxes: a walk of one barrier a kept
            # box (the earlier one-block kernel) takes that many steps
            row["walk_steps"] = int(got[:, :c["trip"]].sum(dim=1).max())
            # the design's work, from this run's shapes and class ids: the
            # pairs mask_kernel visits, its scratch and the walk's steps
            b, n = c["alive"].shape
            row["mask_pairs"] = nms_mask_pairs(c["classes"], c["trip"],
                                               c["force"])
            row["scratch_bytes"] = 8 * math.prod(
                nm.scratch_shape(b, n, c["trip"]))
            row["tile_steps"] = nms_tile_steps(n, c["trip"])
        rows[c["name"]] = row
        log("phase 31 (a) nms %s on %s: %s" % (c["name"], card, row))
    if bad:
        raise AssertionError("phase 31 (a): the NMS kernels' masks differ "
                             "from the plain version's: %s" % bad)
    nm.reset_launch_count()
    return rows


def _ssd_arrays(mt, ctx, inp):
    return {k: mt.nd.array(v, ctx=ctx) for k, v in inp.items()}


def ssd300_ops(card):
    """31 (b): MultiBoxTarget and MultiBoxDetection at the SSD-300 head's
    shapes on the card against cpu(); then both captured as one program,
    its replays bit for bit with the eager run; eager and captured ms."""
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import capture
    from mxnet_tpu_torch.ops import registry
    inp = ssd300_inputs()
    res, bad = {}, []
    anchors = {c: ssd300_anchors(mt, c) for c in (mt.gpu(0), mt.cpu())}
    arrs = {c: _ssd_arrays(mt, c, inp) for c in anchors}
    res["anchors"] = list(anchors[mt.cpu()].shape)
    res["anchors_equal"] = bool(torch.equal(
        anchors[mt.gpu(0)]._data.cpu(), anchors[mt.cpu()]._data))
    out = {}
    for c in anchors:
        a = arrs[c]
        tgt = mt.nd.contrib.MultiBoxTarget(anchors[c], a["label"],
                                           a["cls_pred"], **SSD300_TARGET)
        dets = [mt.nd.contrib.MultiBoxDetection(
            a["cls_prob"], a["loc_pred"], anchors[c], nms_topk=k,
            **SSD300_DETECT) for k in SSD300_NMS_TOPK]
        out[c] = [t._data.cpu() for t in tgt] + [d._data.cpu() for d in dets]
    g, h = out[mt.gpu(0)], out[mt.cpu()]
    res["target"] = dict(
        loc_target_max_abs_err=float((g[0] - h[0]).abs().max()),
        loc_mask_equal=bool(torch.equal(g[1], h[1])),
        cls_target_equal=bool(torch.equal(g[2], h[2])),
        positives=int((h[2] > 0).sum()), negatives=int((h[2] == 0).sum()))
    if not (res["target"]["loc_mask_equal"] and res["target"]["cls_target_equal"]
            and res["target"]["loc_target_max_abs_err"] <= SSD_OP_TOL):
        bad.append("MultiBoxTarget %s" % res["target"])
    for k, gd, hd in zip(SSD300_NMS_TOPK, g[3:], h[3:]):
        row = dict(class_order_equal=bool(torch.equal(gd[..., 0], hd[..., 0])),
                   score_box_max_abs_err=float((gd[..., 1:] - hd[..., 1:])
                                               .abs().max()),
                   kept=int((hd[..., 0] >= 0).sum()))
        res["detection_topk_%d" % k] = row
        if not (row["class_order_equal"]
                and row["score_box_max_abs_err"] <= SSD_OP_TOL):
            bad.append("MultiBoxDetection nms_topk %d %s" % (k, row))
    # one captured program: target, then detection at nms_topk 400
    dev = mt.gpu(0).torch_device
    a = arrs[mt.gpu(0)]
    xs = [anchors[mt.gpu(0)]._data, a["label"]._data, a["cls_pred"]._data,
          a["cls_prob"]._data, a["loc_pred"]._data]
    target = registry.get_op("_contrib_MultiBoxTarget")
    detect = registry.get_op("_contrib_MultiBoxDetection")

    def stage(anc, lbl, cp, prob, loc):
        return list(target.apply((anc, lbl, cp), SSD300_TARGET)) + list(
            detect.apply((prob, loc, anc), dict(SSD300_DETECT, nms_topk=400)))

    with torch.no_grad():
        eager = [t.clone() for t in stage(*xs)]
    before = counter_snapshot()
    prog = capture.Program("ssd300 target+detection", capture.CudaGraph, dev,
                           [stage], xs, [])
    captures = counter_delta(before)["graph_captures"]
    replayed = prog.replay(0, xs)
    res["captured_equal_eager"] = all(torch.equal(r, e)
                                      for r, e in zip(replayed, eager))
    if not res["captured_equal_eager"]:
        bad.append("the captured program's replay differs from eager")
    before = counter_snapshot()
    times = {"captured": [], "eager": []}
    for _ in range(5):
        times["captured"].append(_host_ms(lambda: (prog.replay(0, xs),
                                                   torch.cuda.synchronize())))
        with torch.no_grad():
            times["eager"].append(_host_ms(lambda: (stage(*xs),
                                                    torch.cuda.synchronize())))
    replays = counter_delta(before)
    res["captures_at_capture"] = captures
    res["timed_counters"] = replays
    res["ms"] = {k: _median(v) for k, v in times.items()}
    if replays["graph_captures"] != 0 or replays["graph_replays"] != 5:
        bad.append("timed replays counted %s" % replays)
    log("phase 31 (b) SSD-300 head ops (batch %d, %d anchors, %d classes) "
        "on %s against cpu(): %s" % (SSD300_BATCH, SSD300_ANCHORS,
                                     SSD300_CLASSES, card, res))
    if bad:
        raise AssertionError("phase 31 (b): %s" % "; ".join(bad))
    del prog, arrs, anchors
    free_card()
    return res


def toy_ssd_net(pkg, prefix="toyssd_"):
    """``examples/train_ssd_toy.py``'s ``ToySSD`` with ``pkg``'s Gluon
    (either package), the reshape written with 0 for the batch so that it
    also traces as a Symbol."""
    gluon, cfg = pkg.gluon, TOY_SSD
    n_anchor = len(cfg["sizes"]) + len(cfg["ratios"]) - 1
    num_cls = cfg["num_cls"]

    class ToySSD(gluon.HybridBlock):
        def __init__(self, **kw):
            super().__init__(**kw)
            with self.name_scope():
                self.backbone = gluon.nn.HybridSequential(prefix="")
                for ch in (16, 32, 32):
                    self.backbone.add(gluon.nn.Conv2D(
                        ch, 3, padding=1, activation="relu"))
                    self.backbone.add(gluon.nn.MaxPool2D(2))
                self.cls_head = gluon.nn.Conv2D(n_anchor * (num_cls + 1), 3,
                                                padding=1)
                self.loc_head = gluon.nn.Conv2D(n_anchor * 4, 3, padding=1)

        def hybrid_forward(self, F, x):
            feat = self.backbone(x)
            anchors = F.contrib.MultiBoxPrior(feat, sizes=cfg["sizes"],
                                              ratios=cfg["ratios"])
            cls = F.transpose(self.cls_head(feat), axes=(0, 2, 3, 1))
            cls = F.reshape(cls, shape=(0, -1, num_cls + 1))
            cls = F.transpose(cls, axes=(0, 2, 1))
            loc = F.reshape(F.transpose(self.loc_head(feat),
                                        axes=(0, 2, 3, 1)), shape=(0, -1))
            return anchors, cls, loc

    return ToySSD(prefix=prefix)


def toy_ssd_losses(pkg):
    gluon = pkg.gluon
    return (gluon.loss.SoftmaxCrossEntropyLoss(axis=1),
            gluon.loss.HuberLoss())


def toy_ssd_step(pkg, net, trainer, loss_fns, x, y):
    """One step of the example's loop: forward, MultiBoxTarget under
    ``record()``, the two losses, backward, ``Trainer.step``; returns the
    summed loss (an NDArray, one per image) and the targets."""
    nd = pkg.nd
    with pkg.autograd.record():
        anchors, cls_preds, loc_preds = net(x)
        targets = nd.contrib.MultiBoxTarget(
            anchors, y, cls_preds, overlap_threshold=TOY_SSD["overlap"])
        loc_t, loc_m, cls_t = targets
        loss = loss_fns[0](cls_preds, cls_t) + loss_fns[1](loc_preds * loc_m,
                                                           loc_t)
    loss.backward()
    trainer.step(x.shape[0])
    return loss, targets


def toy_ssd_miou(pkg, net, ctx, dtype="float32"):
    """The example's evaluation: MultiBoxDetection on its 64 validation
    images, the mean IoU of each image's top detection with its box."""
    ex = _ssd_example()
    val_x, val_y = ex.synthetic_detection_set(
        TOY_SSD["n_val"], rng=np.random.RandomState(99))
    nd = pkg.nd
    anchors, cls_preds, loc_preds = net(nd.array(val_x, ctx=ctx, dtype=dtype))
    dets = nd.contrib.MultiBoxDetection(
        nd.softmax(cls_preds, axis=1), loc_preds, anchors,
        threshold=TOY_SSD["threshold"],
        nms_threshold=TOY_SSD["nms_threshold"]).asnumpy()
    ious = []
    for det, lab in zip(dets, val_y):
        valid = det[det[:, 0] >= 0]
        if not len(valid):
            ious.append(0.0)
            continue
        bx, gt = valid[np.argmax(valid[:, 1])][2:6], lab[0, 1:5]
        iw = max(min(bx[2], gt[2]) - max(bx[0], gt[0]), 0)
        ih = max(min(bx[3], gt[3]) - max(bx[1], gt[1]), 0)
        inter = iw * ih
        union = ((bx[2] - bx[0]) * (bx[3] - bx[1])
                 + (gt[2] - gt[0]) * (gt[3] - gt[1]) - inter)
        ious.append(inter / union if union > 0 else 0.0)
    return float(np.mean(ious))


def toy_ssd_train(pkg, ctx, hybridize=False, dtype="float32", epochs=None,
                  steps=None, batch=None, seed=0, params_file=None):
    """The example's training at its settings on ``ctx``: the mean loss of
    each epoch, the counters of each step, the net and its trainer.
    ``steps`` stops early (the parity runs); ``params_file`` loads the
    initial weights instead of the seeded Xavier draw."""
    cfg = TOY_SSD
    ex = _ssd_example()
    train_x, train_y = ex.synthetic_detection_set(cfg["n_train"])
    bs = batch or cfg["batch"]
    net = toy_ssd_net(pkg)
    pkg.random.seed(seed)
    if params_file is None:
        net.collect_params().initialize(pkg.init.Xavier(), ctx=ctx)
    else:
        net.load_params(params_file, ctx=ctx)
    if dtype != "float32":
        net.cast(dtype)
    if hybridize:
        net.hybridize()
    trainer = pkg.gluon.Trainer(net.collect_params(), "adam",
                                {"learning_rate": cfg["lr"]})
    loss_fns = toy_ssd_losses(pkg)
    epoch_losses, step_counts, step_losses, targets = [], [], [], []
    done = 0
    for _ in range(epochs or cfg["epochs"]):
        total, n = 0.0, 0
        for i in range(0, cfg["n_train"], bs):
            x = pkg.nd.array(train_x[i:i + bs], ctx=ctx, dtype=dtype)
            y = pkg.nd.array(train_y[i:i + bs], ctx=ctx, dtype=dtype)
            before = counter_snapshot() if pkg.__name__ == "mxnet_tpu_torch" \
                else None
            loss, tgt = toy_ssd_step(pkg, net, trainer, loss_fns, x, y)
            if before is not None:
                step_counts.append(counter_delta(before))
            value = loss.asnumpy().astype(np.float64)
            step_losses.append(value)
            targets.append([t.asnumpy() for t in tgt])
            total += float(value.mean())
            n += 1
            done += 1
            if steps is not None and done == steps:
                break
        epoch_losses.append(total / n)
        if steps is not None and done == steps:
            break
    return dict(net=net, trainer=trainer, epoch_losses=epoch_losses,
                step_counts=step_counts, step_losses=step_losses,
                targets=targets)


def _toy_state(net):
    ps = net.collect_params().items()
    return ({n: p.data()._data.detach().cpu().clone() for n, p in ps},
            {n: p.grad()._data.detach().cpu().clone() for n, p in ps
             if p.grad_req != "null"})


def toy_ssd_run(card):
    """31 (c): the toy SSD at the example's settings, eager as the example
    runs, then hybridized (its forward and MultiBoxPrior one captured
    program), then 3 steps card against CPU in fp64."""
    import mxnet_tpu_torch as mt
    res, bad = {}, []
    for mode in ("eager", "hybridized"):
        t0 = time.perf_counter()
        run = toy_ssd_train(mt, mt.gpu(0), hybridize=(mode == "hybridized"))
        seconds = time.perf_counter() - t0
        miou = toy_ssd_miou(mt, run["net"], mt.gpu(0))
        counts = run["step_counts"]
        row = dict(epoch_losses=run["epoch_losses"], mean_iou=miou,
                   seconds=seconds, steps=len(counts),
                   counters_first_step=counts[0],
                   counters_later_steps=sorted({tuple(sorted(c.items()))
                                                for c in counts[1:]}))
        res[mode] = row
        log("phase 31 (c) toy SSD (examples/train_ssd_toy.py: %d images at "
            "%d x %d, %d epochs at batch %d, Adam lr %g) %s on %s: losses "
            "%s, mean IoU of the top detection %.4f (bar %.2f), %.1f s, "
            "counters: first step %s, later steps %s"
            % (TOY_SSD["n_train"], TOY_SSD["img"], TOY_SSD["img"],
               TOY_SSD["epochs"], TOY_SSD["batch"], TOY_SSD["lr"], mode,
               card, ["%.4f" % v for v in run["epoch_losses"]], miou,
               TOY_SSD_MIN_IOU, seconds, counts[0],
               row["counters_later_steps"]))
        if not miou >= TOY_SSD_MIN_IOU or not all(
                math.isfinite(v) for v in run["epoch_losses"]):
            bad.append("%s: mean IoU %.4f, losses %s"
                       % (mode, miou, run["epoch_losses"]))
        # a hybridized step: the forward and the backward graph and the
        # fused update replay, nothing captures after the first step
        want = dict(graph_captures=0, graph_replays=3, program_calls=3) \
            if mode == "hybridized" else dict(graph_captures=0,
                                              graph_replays=1,
                                              program_calls=1)
        if any(c != want for c in counts[1:]):
            bad.append("%s step counters %s, want %s"
                       % (mode, row["counters_later_steps"], want))
        del run
        free_card()
    # fp64, card against CPU, from one init
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        init = toy_ssd_net(mt)
        mt.random.seed(0)
        init.collect_params().initialize(mt.init.Xavier(), ctx=mt.cpu())
        init(mt.nd.zeros((1, 1, TOY_SSD["img"], TOY_SSD["img"]),
                         ctx=mt.cpu()))
        path = os.path.join(tmp, "toyssd.params")
        init.save_params(path)
        runs = {c: toy_ssd_train(mt, c, dtype="float64",
                                 steps=TOY_SSD_PARITY_STEPS,
                                 params_file=path)
                for c in (mt.gpu(0), mt.cpu())}
    g, h = runs[mt.gpu(0)], runs[mt.cpu()]
    (gp, gg), (hp, hg) = _toy_state(g["net"]), _toy_state(h["net"])
    diffs = dict(
        logits=max(float(np.abs(a - b).max() / max(1.0, np.abs(b).max()))
                   for a, b in zip(g["step_losses"], h["step_losses"])),
        grads=max(float((gg[n] - hg[n]).abs().max()
                        / max(float(hg[n].abs().max()), 1e-30)) for n in hg),
        params=max(float((gp[n] - hp[n]).abs().max()
                         / max(1.0, float(hp[n].abs().max()))) for n in hp))
    # MultiBoxTarget's masks and classes equal; its offsets (a log each)
    # within SSD_OP_TOL
    targets_equal = all(np.array_equal(ta[k], tb[k]) for ta, tb in zip(
        g["targets"], h["targets"]) for k in (1, 2))
    loc_err = max(float(np.abs(ta[0] - tb[0]).max())
                  for ta, tb in zip(g["targets"], h["targets"]))
    res["fp64_card_vs_cpu"] = dict(diffs, targets_equal=targets_equal,
                                   loc_target_max_abs_err=loc_err,
                                   steps=TOY_SSD_PARITY_STEPS)
    log("phase 31 (c) toy SSD fp64 %d steps card against CPU on %s: %s "
        "(limits %s)" % (TOY_SSD_PARITY_STEPS, card,
                         res["fp64_card_vs_cpu"], ZOO_PARITY_TOL))
    if not targets_equal or not loc_err <= SSD_OP_TOL or any(
            not diffs[k] <= ZOO_PARITY_TOL[k] for k in diffs):
        bad.append("fp64 parity %s" % res["fp64_card_vs_cpu"])
    if bad:
        raise AssertionError("phase 31 (c): %s" % "; ".join(bad))
    del runs
    free_card()
    return res


def register_custom_ops(mt):
    """``tests/test_custom_op.py``'s sigmoid and two-input numpy softmax,
    and ``examples/numpy_ops_softmax.py``'s softmax, as ``chip_sigmoid``,
    ``chip_numpy_softmax`` (both registered with ``mt.operator``)."""
    op = mt.operator

    class Sigmoid(op.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            y = 1.0 / (1.0 + np.exp(-in_data[0].asnumpy()))
            self.assign(out_data[0], req[0], y)

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            y = out_data[0].asnumpy()
            self.assign(in_grad[0], req[0],
                        out_grad[0].asnumpy() * y * (1.0 - y))

    @op.register("chip_sigmoid")
    class SigmoidProp(op.CustomOpProp):
        def __init__(self):
            super().__init__(need_top_grad=True)

        def create_operator(self, ctx, shapes, dtypes):
            return Sigmoid()

    class NumpySoftmax(op.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            x = in_data[0].asnumpy()
            e = np.exp(x - x.max(axis=1, keepdims=True))
            self.assign(out_data[0], req[0], e / e.sum(axis=1, keepdims=True))

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            lbl = in_data[1].asnumpy().ravel().astype(np.int64)
            y = out_data[0].asnumpy().copy()
            y[np.arange(lbl.shape[0]), lbl] -= 1.0
            self.assign(in_grad[0], req[0], y)

    @op.register("chip_numpy_softmax")
    class NumpySoftmaxProp(op.CustomOpProp):
        def __init__(self):
            super().__init__(need_top_grad=False)

        def list_arguments(self):
            return ["data", "label"]

        def infer_shape(self, in_shape):
            return [in_shape[0], (in_shape[0][0],)], [in_shape[0]], []

        def create_operator(self, ctx, shapes, dtypes):
            return NumpySoftmax()


def _custom_eager(mt, ctx, x, label):
    """The sigmoid's output and gradient, and the softmax's output and data
    gradient, on ``ctx``."""
    nd = mt.nd
    out = {}
    a = nd.array(x, ctx=ctx)
    a.attach_grad()
    with mt.autograd.record():
        y = nd.Custom(a, op_type="chip_sigmoid")
        s = y.sum()
    s.backward()
    out["sigmoid"], out["sigmoid_grad"] = y.asnumpy(), a.grad.asnumpy()
    d = nd.array(x, ctx=ctx)
    d.attach_grad()
    with mt.autograd.record():
        p = nd.Custom(d, nd.array(label, ctx=ctx), op_type="chip_numpy_softmax")
    p.backward()
    out["softmax"], out["softmax_grad"] = p.asnumpy(), d.grad.asnumpy()
    return out


def custom_run(card):
    """31 (d): Custom ops on the card: eager against the CPU with their
    gradients; a hybridized block holding one runs eagerly (one
    ``host_op_programs`` a call, no capture); the numpy softmax head of
    ``examples/numpy_ops_softmax.py`` through ``Module.fit``."""
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import profiler
    register_custom_ops(mt)
    rng = np.random.RandomState(34)
    x = rng.randn(16, 10).astype(np.float32)
    label = rng.randint(0, 10, 16).astype(np.float32)
    g, h = _custom_eager(mt, mt.gpu(0), x, label), \
        _custom_eager(mt, mt.cpu(), x, label)
    res = {k: float(np.abs(g[k] - h[k]).max()) for k in g}
    bad = [k for k, v in res.items() if not v <= 1e-6]

    class Head(mt.gluon.HybridBlock):
        def __init__(self, **kw):
            super().__init__(**kw)
            with self.name_scope():
                self.dense = mt.gluon.nn.Dense(10, in_units=10)

        def hybrid_forward(self, F, x):
            return F.Custom(self.dense(x), op_type="chip_sigmoid")

    with mt.name.NameManager():
        net = Head(prefix="customhead_")
    net.initialize(mt.init.Xavier(), ctx=mt.gpu(0))
    net.hybridize()
    xs = mt.nd.array(x, ctx=mt.gpu(0))
    calls = []
    for _ in range(3):
        before = counter_snapshot()
        host_before = profiler.counter("host_op_programs")
        with mt.autograd.record():
            out = net(xs)
        out.backward()
        torch.cuda.synchronize()
        calls.append(dict(counter_delta(before), host_op_programs=profiler
                          .counter("host_op_programs") - host_before))
    res["hybridized_calls"] = calls
    want = dict(graph_captures=0, graph_replays=0, program_calls=0,
                host_op_programs=1)
    if any(c != want for c in calls):
        bad.append("hybridized block counters %s, want %s each"
                   % (calls, want))
    # examples/numpy_ops_softmax.py's net, its head the numpy softmax
    S = mt.sym
    data, lab = S.Variable("data"), S.Variable("softmax_label")
    hid = S.Activation(S.FullyConnected(data, num_hidden=128, name="fc1"),
                       act_type="relu")
    net_sym = S.Custom(S.FullyConnected(hid, num_hidden=10, name="fc2"), lab,
                       op_type="chip_numpy_softmax", name="softmax")
    train, val = mt.test_utils.get_mnist_iterator(64, flat=True)
    mod = mt.mod.Module(net_sym, context=mt.gpu(0))
    host_before = profiler.counter("host_op_programs")
    mt.random.seed(0)
    mod.fit(train, eval_data=val, eval_metric="acc", optimizer="sgd",
            optimizer_params={"learning_rate": 0.1},
            initializer=mt.init.Xavier(), num_epoch=1)
    res["module_fit_host_op_programs"] = profiler.counter(
        "host_op_programs") - host_before
    acc = mod.score(val, "acc")[0][1]
    res["module_fit_val_accuracy"] = acc
    if not acc > 0.5 or res["module_fit_host_op_programs"] < 1:
        bad.append("Module.fit: accuracy %.4f, host_op_programs %d"
                   % (acc, res["module_fit_host_op_programs"]))
    log("phase 31 (d) Custom ops on %s: %s" % (card, res))
    if bad:
        raise AssertionError("phase 31 (d): %s" % "; ".join(bad))
    return res


def phase_long_tail(card):
    """Phase 31: (a) the NMS kernels against their plain version, then,
    with the kernels' count set to 0, (b) the SSD-300 head ops and (c) the
    toy SSD, the slice's path, then (d) Custom ops."""
    from mxnet_tpu_torch.ops import nms as nm
    t0 = time.perf_counter()
    res, seconds = {"card": card}, {}

    def part(key, fn):
        t = time.perf_counter()
        res[key] = fn(card)
        seconds[key] = time.perf_counter() - t

    part("nms_kernel", nms_kernel_check)
    nm.reset_launch_count()
    part("ssd300_ops", ssd300_ops)
    part("toy_ssd", toy_ssd_run)
    res["nms_launches"] = nm.launch_count()
    part("custom", custom_run)
    res["seconds"] = dict(seconds, total=time.perf_counter() - t0)
    log("phase 31: %s s; nms launches on the path %d"
        % ({k: round(v, 1) for k, v in res["seconds"].items()},
           res["nms_launches"]))
    if res["nms_launches"] < 1:
        raise AssertionError("phase 31: the SSD path launched no NMS kernel")
    return res


# -- phase 32: sparse storage --------------------------------------------------
# examples/sparse_linear_classification.py's model (the reference's
# example/sparse/linear_classification) at avazu-app's 1,000,001 features
# and the example's batch 8192.  avazu-app is not in the repository, so the
# data is synthetic LibSVM at its width, written as the example writes it,
# with 16 ids a line (this repository's choice).
SPARSE_DIM = 1000001
SPARSE_BATCH = 8192
SPARSE_ROWS = 65536
SPARSE_NNZ = 16
SPARSE_EPOCHS = 3
# the example's lr, 0.5.  Its loss is already a batch mean (MakeLoss of
# mean), and Module's default rescale_grad of 1 / batch would make a step
# 1 / 8192 of that at this batch: 24 steps then leave the prediction to
# the initial draw (on the CPU, seeds 0-2 give accuracy 0.27, 0.57 and
# 0.83, the loss 0.0007 lower).  So the gradient is taken as it is.
SPARSE_OPT = (("learning_rate", 0.5), ("rescale_grad", 1.0))
SPARSE_POS_WEIGHT = 2.0
SPARSE_PARITY_STEPS = 3
# fp64 card against CPU: the products add in the same order on both routes;
# what differs is the card's log/exp against the CPU's, a few ulps
SPARSE_PARITY_TOL = 1e-10
SPARSE_PEAK_LIMIT = 1 << 30     # a dense batch would be 32.8 GB
# examples/factorization_machine.py at its own settings; the bars of
# tests/test_examples.py:218-227
FM = dict(dim=200, factor=8, batch=64, lr=0.05, epochs=8, rows=2048)
# a kernel against its plain version, relative to each output's sum of
# |terms|: the same roundings in the same order (csr_dot), or in row order
# by tiles of 32 (csr_t_dot), so the gap is the tiles' order and the plain
# version's own atomics on the card (index_add_ adds in any order)
CSR_TOL = {torch.float64: 1e-12, torch.float32: 1e-5}
CSR_TIMING_ITERS = 200
CSR_ORDER_MODEL_NNZ = 5000      # cases checked against t_dot_tiles_reference
CSR_PATH_N = 2                  # the linear model's classes
# csr_dot held bit for bit against its plain version on the CPU (the same
# roundings in the same order): rows of these lengths, shuffled, at these
# widths (N up to 4 takes csr_dot_kernel, a lane an entry; above,
# csr_dot_wide_kernel)
CSR_RAGGED_LENGTHS = (0, 1, 15, 16, 17, 33, 100)
CSR_RAGGED_WIDTHS = (1, 2, 8, 33)
FM_NNZ = 12                     # ids a line of the FM's data
CSR_CAPTURE_STEPS = 24          # phase 32b-c: captured against eager


def sparse_linear_symbol(mt, dim, dtype=None,
                         positive_cls_weight=SPARSE_POS_WEIGHT):
    """``examples/sparse_linear_classification.py``'s ``linear_model``
    (:51-71) through ``mt.sym``: a CSR ``data``, a (dim, 2) row_sparse
    weight (``Normal(0.01)``), a bias, the class-weighted cross-entropy
    through ``MakeLoss`` and ``BlockGrad(softmax)``; ``dtype`` types the
    parameters."""
    S = mt.sym
    typed = {} if dtype is None else {"dtype": dtype}
    x = S.Variable("data", stype="csr")
    weight = S.Variable("weight", shape=(dim, 2),
                        init=mt.initializer.Normal(sigma=0.01),
                        stype="row_sparse", **typed)
    bias = S.Variable("bias", shape=(2,), **typed)
    pred = S.broadcast_add(S.dot(x, weight), bias)
    y = S.Variable("softmax_label")
    logp = S.log_softmax(pred, axis=-1)
    onehot = S.one_hot(y, depth=2)
    cls_w = 1.0 + (positive_cls_weight - 1.0) * y
    nll = -S.sum(logp * onehot, axis=-1) * cls_w
    loss = S.MakeLoss(S.mean(nll), name="weighted_ce")
    return S.Group([loss, S.BlockGrad(S.softmax(pred), name="prob")])


def fm_symbol(mt, dim, factor, dtype=None):
    """``examples/factorization_machine.py``'s ``fm_model`` through
    ``mt.sym``; its ``x * x`` reads the CSR's dense view; ``dtype`` types
    the parameters."""
    S = mt.sym
    typed = {} if dtype is None else {"dtype": dtype}
    x = S.Variable("data", stype="csr")
    w = S.Variable("w", shape=(dim, 1),
                   init=mt.initializer.Normal(sigma=0.01), **typed)
    v = S.Variable("v", shape=(dim, factor),
                   init=mt.initializer.Normal(sigma=0.05), **typed)
    w0 = S.Variable("w0", shape=(1,), init=mt.initializer.Zero(), **typed)
    linear = S.dot(x, w)
    vx = S.dot(x, v)
    x2 = x * x
    v2 = v * v
    inter = 0.5 * (S.sum(vx * vx, axis=1, keepdims=True)
                   - S.sum(S.dot(x2, v2), axis=1, keepdims=True))
    score = S.broadcast_add(linear + inter, S.Reshape(w0, shape=(1, 1)))
    label = S.Variable("softmax_label")
    z = S.Reshape(score, shape=(-1,))
    loss = S.mean(S.relu(z) - z * label + S.log(1 + S.exp(-S.abs(z))))
    return S.Group([S.MakeLoss(loss, name="logloss"),
                    S.BlockGrad(S.sigmoid(z), name="prob")])


def sparse_module(mt, sym, ctx, provide_data, provide_label, optimizer,
                  optimizer_params, kv=None, params=None, seed=0):
    """A bound, initialized ``Module`` as the examples make it (``params``:
    (arg, aux) dicts to set instead of the initializer's draws)."""
    mt.random.seed(seed)
    mod = mt.mod.Module(sym, data_names=["data"],
                        label_names=["softmax_label"], context=ctx)
    mod.bind(data_shapes=provide_data, label_shapes=provide_label)
    if params is None:
        mod.init_params()
    else:
        mod.set_params(*params)
    mod.init_optimizer(kvstore=kv, optimizer=optimizer,
                       optimizer_params=optimizer_params)
    return mod


def sparse_linear_step(mod, batch, kv=None):
    """The example's step (:108-118): with a store, pull the weight rows
    the batch's CSR touches; forward, backward, update; the loss."""
    if kv is not None:
        slot = mod._exec_group.param_names.index("weight")
        kv.row_sparse_pull("weight", mod._exec_group.param_arrays[slot],
                           row_ids=[batch.data[0].indices], priority=-slot)
    mod.forward_backward(batch)
    mod.update()
    return float(mod.get_outputs()[0].asnumpy().sum())


def sparse_accuracy(mod, it, binary):
    """Held-in accuracy as the examples score it."""
    it.reset()
    correct = total = 0
    for batch in it:
        mod.forward(batch, is_train=False)
        prob = mod.get_outputs()[1].asnumpy()
        y = batch.label[0].asnumpy()
        pred = prob > 0.5 if binary else prob.argmax(axis=1)
        correct += int((pred == y).sum())
        total += len(y)
    return correct / max(total, 1)


def sparse_batch_as(mt, batch, dtype):
    """``batch`` with its CSR and labels in ``dtype``, on the host."""
    from mxnet_tpu_torch.ndarray.sparse import CSRNDArray
    csr = batch.data[0]._parts()
    return mt.io.DataBatch(
        [CSRNDArray(csr.to("cpu", dtype), mt.cpu())],
        [mt.nd.array(batch.label[0], ctx=mt.cpu(), dtype=dtype)],
        pad=batch.pad)


def sparse_linear_parity(mt, ctx, batches, init, kv_kind):
    """``SPARSE_PARITY_STEPS`` fp64 steps of the linear model on ``ctx``
    from ``init`` (numpy weight, bias): the losses and the parameters."""
    dim = init["weight"].shape[0]
    descs = ([mt.io.DataDesc("data", (SPARSE_BATCH, dim), np.float64)],
             [mt.io.DataDesc("softmax_label", (SPARSE_BATCH,), np.float64)])
    params = ({k: mt.nd.array(v, ctx=mt.cpu(), dtype=np.float64)
               for k, v in init.items()}, {})
    kv = mt.kv.create(kv_kind) if kv_kind else None
    mod = sparse_module(mt, sparse_linear_symbol(mt, dim, dtype="float64"),
                        ctx, *descs, "sgd", SPARSE_OPT, kv=kv, params=params)
    losses = [sparse_linear_step(mod, b, kv) for b in batches]
    arg, _ = mod.get_params()
    return losses, {k: v.asnumpy() for k, v in arg.items()}


def write_sparse_data(tmp, mt):
    """The avazu-width LibSVM file and the FM's, in ``tmp``."""
    path = os.path.join(tmp, "avazu_width.libsvm")
    mt.test_utils.synthetic_libsvm(path, n=SPARSE_ROWS, dim=SPARSE_DIM,
                                   nnz=SPARSE_NNZ)
    fm_path = os.path.join(tmp, "fm.libsvm")
    mt.test_utils.synthetic_fm_libsvm(fm_path, n=FM["rows"], dim=FM["dim"])
    return path, fm_path


def _csr_case_parts(rng, m, k, lengths, cols=None):
    """Host (indptr, indices) of ``m`` rows of ``lengths`` sorted distinct
    ids below ``k`` (each row ``cols`` where given)."""
    rows = []
    for n in lengths:
        if cols is not None:
            rows.append(np.asarray(cols, np.int64))
        else:
            rows.append(np.sort(rng.choice(k, size=int(n), replace=False)))
    indptr = np.concatenate([[0], np.cumsum([len(r) for r in rows])])
    idx = np.concatenate(rows) if rows else np.zeros(0)
    return indptr.astype(np.int64), idx.astype(np.int64)


def path_csr_parts(rng, m=SPARSE_BATCH, k=SPARSE_DIM, nnz=SPARSE_NNZ):
    """(indptr, indices) of ``m`` lines as the synthetic data draws them."""
    rows = [np.unique(rng.zipf(1.5, nnz * 2) % k)[:nnz] for _ in range(m)]
    indptr = np.concatenate([[0], np.cumsum([len(r) for r in rows])])
    return indptr.astype(np.int64), np.concatenate(rows).astype(np.int64)


def csr_kernel_cases(rng):
    """(name, m, k, (indptr, indices), widths N): the ragged edges and the
    path's shape, K 1,000,001 at N 1, 2, 8 and 64."""
    half = rng.randint(0, 9, 257)
    half[::2] = 0
    return [
        ("empty rows", 257, 1000, _csr_case_parts(rng, 257, 1000, half),
         (2, 40)),
        ("nnz 0", 33, 100, _csr_case_parts(rng, 33, 100, [0] * 33), (2, 40)),
        ("one full row", 5, 4099,
         _csr_case_parts(rng, 5, 4099, [0, 0, 4099, 0, 0]), (2, 40)),
        ("first and last column", 64, SPARSE_DIM,
         _csr_case_parts(rng, 64, SPARSE_DIM, [2] * 64,
                         cols=[0, SPARSE_DIM - 1]), (2, 40)),
        ("path", SPARSE_BATCH, SPARSE_DIM, path_csr_parts(rng), (1, 2, 8, 64)),
    ]


def csr_on(parts, m, k, dtype, dev, gen):
    from mxnet_tpu_torch.ops.sparse_dot import CSR
    indptr, indices = parts
    values = torch.randn(len(indices), generator=gen, dtype=torch.float64,
                         device=dev).to(dtype)
    return CSR(values, torch.from_numpy(indices).to(dev),
               torch.from_numpy(indptr).to(dev), (m, k))


def csr_errors(got, plain, scale):
    """(largest error relative to the sum of |terms|, largest absolute
    error); an output whose terms sum to 0 must be 0 on both."""
    diff = (got.double() - plain.double()).abs()
    empty = scale == 0
    if bool((diff[empty] != 0).any()):
        return float("inf"), float(diff.max())
    rel = diff[~empty] / scale[~empty].double()
    return (float(rel.max()) if rel.numel() else 0.0,
            float(diff.max()) if diff.numel() else 0.0)


def csr_bound_ms(kind, csr, n, itemsize):
    """Least time for one call on ``csr``'s data: the bytes it must move
    (the parts read once, the rows of the dense operand that its entries
    name read once, the output written once) at 3.35 TB/s against 2
    operations an entry and column at 67 TFLOP/s.  B's gradient
    (``csr_t_dot``) has one bound, A^T . G, and the transposition that it
    builds on the way is held to that same bound."""
    m, k = csr.shape
    parts = (m + 1) * 8 + csr.nnz * (8 + itemsize)
    if kind == "csr_dot":
        named = int(torch.unique(csr.indices).numel())    # rows of B read
        nbytes = parts + named * n * itemsize + m * n * itemsize
    else:   # csr_t_dot, csr_transpose: A^T . G
        named = int((csr.indptr.diff() > 0).sum())        # rows of G read
        nbytes = parts + named * n * itemsize + k * n * itemsize
    ops = 2.0 * csr.nnz * n
    t_bytes = 1e3 * nbytes / HBM_BPS
    t_ops = 1e3 * ops / PEAK_FLOPS[torch.float32]
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def other_dtype_refusals(dev):
    """A bf16 and an fp16 CSR on the card: ``dot`` raises ``MXNetError``
    and builds no dense view (for each, whether both held)."""
    from mxnet_tpu_torch import MXNetError, profiler
    from mxnet_tpu_torch.ops import sparse_dot as sd
    out = {}
    for dt in (torch.bfloat16, torch.float16):
        csr = sd.CSR(torch.ones(2, dtype=dt, device=dev),
                     torch.tensor([0, SPARSE_DIM - 1], device=dev),
                     torch.tensor([0, 1, 2], device=dev), (2, SPARSE_DIM))
        before = profiler.counter(sd.DENSIFY_COUNTER)
        try:
            sd.dot(csr, torch.ones((SPARSE_DIM, 2), dtype=dt, device=dev))
            raised = False
        except MXNetError:
            raised = True
        out[DTYPE_NAME.get(dt, str(dt))] = raised and csr._dense is None \
            and profiler.counter(sd.DENSIFY_COUNTER) == before
    return out


def csr_padded(csr, capacity):
    """``csr``'s parts in buffers of ``capacity`` slots, as a captured step
    holds a batch: values past nnz zero, column ids 0, the row pointers
    exact."""
    from mxnet_tpu_torch.ops.sparse_dot import CSR
    pad = capacity - csr.capacity
    return CSR(torch.cat([csr.values, csr.values.new_zeros(pad)]),
               torch.cat([csr.indices, csr.indices.new_zeros(pad)]),
               csr.indptr.clone(), csr.shape)


def csr_dot_ragged_check(dev, gen):
    """``csr_dot`` bit for bit against its plain version on the CPU (the
    same inputs copied there), rows of ``CSR_RAGGED_LENGTHS`` entries at N
    ``CSR_RAGGED_WIDTHS``, fp32 and fp64; (checks, failures)."""
    from mxnet_tpu_torch.ops import sparse_dot as sd
    rng = np.random.RandomState(35)
    lengths = np.repeat(CSR_RAGGED_LENGTHS, 7)
    rng.shuffle(lengths)
    k = 5000
    parts = _csr_case_parts(rng, len(lengths), k, lengths)
    checks, bad = 0, []
    for dt in (torch.float32, torch.float64):
        csr = csr_on(parts, len(lengths), k, dt, dev, gen)
        host = csr.to("cpu")
        for n in CSR_RAGGED_WIDTHS:
            b = torch.randn((k, n), generator=gen, dtype=torch.float64,
                            device=dev).to(dt)
            got = sd.csr_dot(csr, b).cpu()
            checks += 1
            if not torch.equal(got, sd.csr_dot_reference(host, b.cpu())):
                bad.append("ragged csr_dot %s N %d: not the plain version's "
                           "bits" % (dt, n))
    return checks, bad


def csr_padded_check(dev, gen, cases):
    """Each kernel over capacity-padded parts against the same CSR unpadded,
    bit for bit (the slots past nnz enter no sum, sort or tile); (checks,
    failures)."""
    from mxnet_tpu_torch.ops import sparse_dot as sd
    checks, bad = 0, []
    for name, csr in cases:
        cap = max(1, 1 << max(csr.capacity - 1, 0).bit_length())
        padded = csr_padded(csr, cap + 37)
        m, k = csr.shape
        mine, theirs = sd.transpose_parts(padded), sd.transpose_parts(csr)
        checks += 1
        if not all(torch.equal(x[:csr.nnz], y[:csr.nnz])
                   for x, y in zip(mine, theirs)):
            bad.append("%s: the padded transposition differs" % name)
        for n in (1, 2, 8):
            b = torch.randn((k, n), generator=gen, dtype=torch.float64,
                            device=dev).to(csr.dtype)
            g = torch.randn((m, n), generator=gen, dtype=torch.float64,
                            device=dev).to(csr.dtype)
            for kind, fn, x in (("csr_dot", sd.csr_dot, b),
                                ("csr_t_dot", sd.csr_t_dot, g)):
                checks += 1
                if not torch.equal(fn(padded, x), fn(csr, x)):
                    bad.append("%s %s N %d: padded differs" % (name, kind, n))
    return checks, bad


def launch_floor_ms():
    """A launch of the smallest kernel (one element incremented), CUDA
    events, mean of ``CSR_TIMING_ITERS``: the floor under any short
    kernel's time on this card's clock."""
    x = torch.zeros(1, device="cuda")
    return cuda_ms(lambda: x.add_(1), CSR_TIMING_ITERS, 10)


def csr_kernel_check(card):
    """32 (a): ``csr_dot``, ``csr_t_dot`` and the transposition against
    their plain versions in fp32 and fp64 on every case, a second call
    equal bit for bit; ``csr_dot`` bit for bit against the plain version
    on the CPU over ragged rows; every kernel over capacity-padded parts
    bit for bit against unpadded ones; then the path's shape and the FM's
    timed beside the plain versions and cuSPARSE (``torch.sparse.mm`` on
    a ``torch.sparse_csr_tensor`` of the same parts)."""
    from mxnet_tpu_torch.ops import sparse_dot as sd
    from mxnet_tpu_torch.ops.sparse_dot import CSR
    dev = torch.device("cuda")
    rng = np.random.RandomState(32)
    gen = torch.Generator(dev).manual_seed(32)
    rows, bad, worst, padded_cases = [], [], {}, []
    for name, m, k, parts, widths in csr_kernel_cases(rng):
        for dt in (torch.float32, torch.float64):
            csr = csr_on(parts, m, k, dt, dev, gen)
            if dt == torch.float32:
                padded_cases.append((name, csr))
            # csr_t_dot's order, bit for bit, where the model's loop is short
            order_model = csr.nnz <= CSR_ORDER_MODEL_NNZ
            mine = sd.transpose_parts(csr)
            plain_t = sd.transpose_parts_reference(csr)
            if not all(torch.equal(a[:csr.nnz], b)
                       for a, b in zip(mine, plain_t)):
                bad.append("%s %s: the transposition differs" % (name, dt))
            absolute = CSR(csr.values.abs(), csr.indices, csr.indptr,
                           csr.shape)
            for n in widths:
                for kind, fn, ref, rows_in in (
                        ("csr_dot", sd.csr_dot, sd.csr_dot_reference, k),
                        ("csr_t_dot", sd.csr_t_dot, sd.csr_t_dot_reference,
                         m)):
                    b = torch.randn((rows_in, n), generator=gen,
                                    dtype=torch.float64, device=dev).to(dt)
                    got = fn(csr, b)
                    again = fn(csr, b)
                    torch.cuda.synchronize()
                    plain = ref(csr, b)
                    scale = ref(absolute, b.abs())
                    rel, err = csr_errors(got, plain, scale)
                    same_order = None
                    if kind == "csr_t_dot" and order_model:
                        same_order = bool(torch.equal(
                            got, sd.t_dot_tiles_reference(csr, b)))
                        if not same_order:
                            bad.append("%s csr_t_dot %s N %d: not the tiles' "
                                       "order" % (name, dt, n))
                    key = (kind, DTYPE_NAME.get(dt, "fp64"))
                    worst[key] = max(worst.get(key, 0.0), rel)
                    rows.append(dict(case=name, kind=kind,
                                     dtype=str(dt).replace("torch.", ""),
                                     m=m, k=k, n=n, nnz=csr.nnz,
                                     rel_err=rel, max_abs_err=err,
                                     tiles_order=same_order,
                                     bitwise_again=bool(torch.equal(got,
                                                                    again))))
                    if rel > CSR_TOL[dt] or not torch.equal(got, again):
                        bad.append("%s %s %s N %d: rel %.3g (limit %g), "
                                   "again %s" % (name, kind, dt, n, rel,
                                                 CSR_TOL[dt],
                                                 torch.equal(got, again)))
    ragged_checks, ragged_bad = csr_dot_ragged_check(dev, gen)
    padded_checks, padded_bad = csr_padded_check(dev, gen, padded_cases)
    bad += ragged_bad + padded_bad
    log("phase 32 (a) csr kernels on %s: %d checks, worst relative error %s; "
        "csr_dot bit for bit against the CPU's plain version over rows of "
        "%s entries at N %s: %d checks; padded parts against unpadded: %d "
        "checks; %d failed" % (
            card, len(rows), {"%s %s" % k: v for k, v in worst.items()},
            CSR_RAGGED_LENGTHS, CSR_RAGGED_WIDTHS, ragged_checks,
            padded_checks, len(ragged_bad) + len(padded_bad)))
    refused = other_dtype_refusals(dev)
    log("phase 32 (a) a CSR of another dtype on %s: %s" % (card, refused))
    if not all(refused.values()):
        bad.append("a CSR of another dtype on the card: %s" % refused)
    if bad:
        raise AssertionError("phase 32 (a): %s" % "; ".join(bad[:8]))
    # the path's shape, fp32, N 2: ms against plain, cuSPARSE and the bound
    parts = path_csr_parts(np.random.RandomState(33))
    csr = csr_on(parts, SPARSE_BATCH, SPARSE_DIM, torch.float32, dev, gen)
    b = torch.randn((SPARSE_DIM, CSR_PATH_N), generator=gen, device=dev)
    g = torch.randn((SPARSE_BATCH, CSR_PATH_N), generator=gen, device=dev)
    lib = torch.sparse_csr_tensor(csr.indptr, csr.indices, csr.values,
                                  size=csr.shape)

    def library_t():
        return torch.sparse.mm(lib.t(), g)

    def library_ms(fn, kind):
        try:
            fn()
            return cuda_ms(fn, CSR_TIMING_ITERS, 10)
        except (RuntimeError, NotImplementedError) as e:
            log("phase 32 (a) %s: no library call (%s)" % (kind, e))
            return None

    timing = {}
    floor = launch_floor_ms()
    for kind, mine, plain, library in (
            ("csr_dot", lambda: sd.csr_dot(csr, b),
             lambda: sd.csr_dot_reference(csr, b),
             lambda: torch.sparse.mm(lib, b)),
            ("csr_t_dot", lambda: sd.csr_t_dot(csr, g),
             lambda: sd.csr_t_dot_reference(csr, g), library_t),
            ("csr_transpose", lambda: sd.transpose_parts(csr),
             lambda: sd.transpose_parts_reference(csr),
             lambda: lib.to_sparse_csc())):
        lib_ms = library_ms(library, kind)
        bound, by = csr_bound_ms(kind, csr, CSR_PATH_N, 4)
        timing[kind] = dict(
            ms=cuda_ms(mine, CSR_TIMING_ITERS, 10),
            plain_ms=cuda_ms(plain, CSR_TIMING_ITERS, 10),
            library_ms=lib_ms, bound_ms=bound, bound_by=by,
            launch_floor_ms=floor,
            shape=[SPARSE_BATCH, SPARSE_DIM, CSR_PATH_N], nnz=csr.nnz,
            max_abs_err=max((r["max_abs_err"] for r in rows
                             if r["case"] == "path" and r["n"] == CSR_PATH_N
                             and r["dtype"] == "float32"
                             and r["kind"] == kind), default=0.0))
        log("phase 32 (a) %s on %s, (%d x %d, nnz %d) . N %d fp32: %.5f ms "
            "(bound %.5f by %s; a launch alone %.5f), plain %.5f, library %s"
            % (kind, card, SPARSE_BATCH, SPARSE_DIM, csr.nnz, CSR_PATH_N,
               timing[kind]["ms"], bound, by, floor,
               timing[kind]["plain_ms"], lib_ms))
    # csr_dot at the FM's shapes: dot(x, w) at N 1, dot(x, v) at N 8
    fm = csr_on(_csr_case_parts(rng, FM["batch"], FM["dim"],
                                [FM_NNZ] * FM["batch"]), FM["batch"],
                FM["dim"], torch.float32, dev, gen)
    fm_lib = torch.sparse_csr_tensor(fm.indptr, fm.indices, fm.values,
                                     size=fm.shape)
    timing["csr_dot_fm"] = {}
    for n in (1, FM["factor"]):
        bf = torch.randn((FM["dim"], n), generator=gen, device=dev)
        bound, by = csr_bound_ms("csr_dot", fm, n, 4)
        timing["csr_dot_fm"][n] = dict(
            ms=cuda_ms(lambda: sd.csr_dot(fm, bf), CSR_TIMING_ITERS, 10),
            plain_ms=cuda_ms(lambda: sd.csr_dot_reference(fm, bf),
                             CSR_TIMING_ITERS, 10),
            library_ms=library_ms(lambda: torch.sparse.mm(fm_lib, bf),
                                  "csr_dot_fm"),
            bound_ms=bound, bound_by=by, launch_floor_ms=floor,
            shape=[FM["batch"], FM["dim"], n], nnz=fm.nnz)
    log("phase 32 (a) csr_dot at the FM's shapes on %s (%d x %d, nnz %d): %s"
        % (card, FM["batch"], FM["dim"], fm.nnz, timing["csr_dot_fm"]))
    # where B's gradient (the transposition included, as in every call)
    # spends its device time, operation by operation
    calls = 20
    device, wall, ops = device_profile(
        lambda: [sd.csr_t_dot(csr, g) for _ in range(calls)], calls, top=20)
    plain_device, _, plain_ops = device_profile(
        lambda: [sd.csr_t_dot_reference(csr, g) for _ in range(calls)],
        calls, top=20)
    timing["csr_t_dot"].update(device_ms=device, wall_ms=wall,
                               device_ops=ops, plain_device_ms=plain_device,
                               plain_device_ops=plain_ops)
    log("phase 32 (a) B's gradient on %s under the profiler: %.5f device "
        "ms, %.5f wall ms a call; %s; the plain version %.5f device ms a "
        "call; %s" % (card, device, wall, ops, plain_device, plain_ops))
    return dict(card=card, checks=rows, ragged_checks=ragged_checks,
                padded_checks=padded_checks,
                worst={"%s %s" % k: v for k, v in worst.items()},
                timing=timing)


def _state_of(mod, names):
    """Copies of the bound parameters ``names`` (the first context's)."""
    ex = mod._exec_group.execs[0]
    return {n: ex.arg_dict[n]._data.detach().clone() for n in names}


def _bits_equal(a, b):
    return all(torch.equal(a[k], b[k]) for k in a)


def sparse_linear_run(mt, path, kv_kind, mode, steps):
    """``steps`` steps of the example's loop from the seeded init, in
    ``mode`` (captured or eager): the losses and the parameters after."""
    it = mt.io.LibSVMIter(data_libsvm=path, data_shape=(SPARSE_DIM,),
                          batch_size=SPARSE_BATCH)
    kv = mt.kv.create(kv_kind) if kv_kind else None
    mod = sparse_module(mt, sparse_linear_symbol(mt, SPARSE_DIM),
                        mt.gpu(0), it.provide_data, it.provide_label, "sgd",
                        SPARSE_OPT, kv=kv)
    losses = []
    with step_mode(mode):
        while len(losses) < steps:
            it.reset()
            for batch, _ in zip(it, range(steps - len(losses))):
                losses.append(sparse_linear_step(mod, batch, kv))
    state = _state_of(mod, ("weight", "bias"))
    del mod
    free_card()
    return losses, state


def sparse_linear_train(mt, card, path, kv_kind):
    """32 (b): the linear model through ``Module`` at avazu-app's width,
    ``SPARSE_EPOCHS`` epochs of the example's loop, each step one replay
    of the executor's captured ``forward_backward`` (no capture after the
    first), with the kernels' counts, ``sparse_densify`` and the peak
    memory read over the steps; the first ``CSR_CAPTURE_STEPS`` held bit
    for bit against the same steps under ``capture.eager()``."""
    from mxnet_tpu_torch import capture, profiler
    from mxnet_tpu_torch.ops import sparse_dot as sd
    free_card()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    it = mt.io.LibSVMIter(data_libsvm=path, data_shape=(SPARSE_DIM,),
                          batch_size=SPARSE_BATCH)
    kv = mt.kv.create(kv_kind) if kv_kind else None
    mod = sparse_module(mt, sparse_linear_symbol(mt, SPARSE_DIM),
                        mt.gpu(0), it.provide_data, it.provide_label, "sgd",
                        SPARSE_OPT, kv=kv)
    names = list(sd.COUNTERS.values()) + [sd.DENSIFY_COUNTER]
    profiler.reset_counters(*names)
    epochs, step_ms, per_step, losses = [], [], [], []
    state = None
    for _ in range(SPARSE_EPOCHS):
        it.reset()
        epoch = []
        for batch in it:
            before = counter_snapshot()
            t0 = time.perf_counter()
            epoch.append(sparse_linear_step(mod, batch, kv))
            torch.cuda.synchronize()
            step_ms.append(1e3 * (time.perf_counter() - t0))
            per_step.append(counter_delta(before))
            if len(step_ms) == CSR_CAPTURE_STEPS:
                state = _state_of(mod, ("weight", "bias"))
        losses += epoch
        epochs.append(sum(epoch) / len(epoch))
    counts = {n: profiler.counter(n) for n in names}
    peak = torch.cuda.max_memory_allocated() - base
    steps = len(step_ms)
    captures = sum(c["graph_captures"] for c in per_step)
    cap = mod._exec_group.execs[0].arg_dict["data"]._parts().capacity
    it.reset()
    batches = [b for b, _ in zip(it, range(3))]

    def window():
        for b in batches:
            sparse_linear_step(mod, b, kv)
    device, wall, top = device_profile(window, len(batches))
    acc = sparse_accuracy(mod, it, binary=False)
    ms = float(np.median(step_ms[1:]))
    del mod
    eager_losses, eager_state = sparse_linear_run(
        mt, path, kv_kind, "eager", CSR_CAPTURE_STEPS)
    bitwise = eager_losses == losses[:CSR_CAPTURE_STEPS] \
        and _bits_equal(state, eager_state)
    res = dict(store=kv_kind, epoch_losses=epochs, accuracy=acc, steps=steps,
               ms_per_step=ms, step_ms=step_ms,
               samples_per_s=SPARSE_BATCH / ms * 1e3,
               busy=device / wall, device_ms=device, wall_ms=wall,
               top_device_ops=top, peak_bytes=peak, counts=counts,
               capacity=cap, captures=captures, first_step=per_step[0],
               later_steps=sorted({tuple(sorted(c.items()))
                                   for c in per_step[1:]}),
               captured_equals_eager=bitwise)
    log("phase 32 (b) linear model at %d features on %s, batch %d, %s: "
        "epoch losses %s, accuracy %.4f, %.3f ms/step (median of %d), "
        "%.0f samples/s, busy %.1f%%, peak %.1f MB above the phase's start; "
        "counts %s; capacity %d; step counters: first %s, later %s; "
        "captured equal to eager over %d steps: %s"
        % (SPARSE_DIM, card, SPARSE_BATCH,
           "store %s" % kv_kind if kv_kind else "no store",
           ["%.5f" % v for v in epochs], acc, ms, steps - 1,
           res["samples_per_s"], 100 * res["busy"], peak / 1e6, counts, cap,
           per_step[0], res["later_steps"], CSR_CAPTURE_STEPS, bitwise))
    bad = []
    if not epochs[-1] < epochs[0] or not acc > 0.5:
        bad.append("loss %s, accuracy %.4f" % (epochs, acc))
    if counts[sd.DENSIFY_COUNTER]:
        bad.append("%d dense views built" % counts[sd.DENSIFY_COUNTER])
    if peak >= SPARSE_PEAK_LIMIT:
        bad.append("peak %d bytes" % peak)
    # one forward_backward replay a step, captured once (its warm-ups
    # launch each kernel WARMUP_RUNS times more)
    one = dict(graph_captures=0, graph_replays=1)
    if any({k: c[k] for k in one} != one for c in per_step[1:]) \
            or per_step[0]["graph_replays"] != 1 or captures != 1:
        bad.append("step counters: first %s, later %s"
                   % (per_step[0], res["later_steps"]))
    launches = steps + capture.WARMUP_RUNS * captures
    want = {sd.COUNTERS["csr_dot"]: launches,
            sd.COUNTERS["csr_t_dot"]: launches}
    if any(counts[k] != v for k, v in want.items()):
        bad.append("launches %s, want %s" % (counts, want))
    if not bitwise:
        bad.append("the captured steps differ from capture.eager()'s")
    if bad:
        raise AssertionError("phase 32 (b): %s" % "; ".join(bad))
    return res


def sparse_linear_card_vs_cpu(mt, card, path):
    """32 (b): ``SPARSE_PARITY_STEPS`` fp64 steps on the card and on the
    ``cpu()`` route from one init, with and without a store."""
    it = mt.io.LibSVMIter(data_libsvm=path, data_shape=(SPARSE_DIM,),
                          batch_size=SPARSE_BATCH)
    batches = [sparse_batch_as(mt, b, torch.float64)
               for b, _ in zip(it, range(SPARSE_PARITY_STEPS))]
    rng = np.random.RandomState(320)
    init = {"weight": rng.normal(0, 0.01, (SPARSE_DIM, 2)),
            "bias": np.zeros(2)}
    res = {}
    for kv_kind in (None, "local"):
        card_run = sparse_linear_parity(mt, mt.gpu(0), batches, init,
                                        kv_kind)
        cpu_run = sparse_linear_parity(mt, mt.cpu(), batches, init, kv_kind)
        gaps = dict(loss=float(np.max(np.abs(np.subtract(card_run[0],
                                                         cpu_run[0])))))
        for k in init:
            gaps[k] = float(np.max(np.abs(card_run[1][k] - cpu_run[1][k])))
        res[kv_kind or "no store"] = gaps
    log("phase 32 (b) fp64 card against cpu() on %s, %d steps at batch %d: "
        "%s (limit %g)" % (card, SPARSE_PARITY_STEPS, SPARSE_BATCH, res,
                           SPARSE_PARITY_TOL))
    worst = max(v for g in res.values() for v in g.values())
    if not worst <= SPARSE_PARITY_TOL:
        raise AssertionError("phase 32 (b) card against CPU: %s" % res)
    return res


def fm_steps(mt, path, mode, epochs, on_step=None):
    """The FM through ``Module._fit_step`` at the example's settings for
    ``epochs`` epochs in ``mode`` (captured or eager): the module, each
    step's loss, and ``on_step(step)``'s value at each step."""
    it = mt.io.LibSVMIter(data_libsvm=path, data_shape=(FM["dim"],),
                          batch_size=FM["batch"])
    mod = sparse_module(mt, fm_symbol(mt, FM["dim"], FM["factor"]),
                        mt.gpu(0), it.provide_data, it.provide_label,
                        "adam", (("learning_rate", FM["lr"]),))
    losses, seen = [], []
    with step_mode(mode):
        for _ in range(epochs):
            it.reset()
            for batch in it:
                before = counter_snapshot()
                t0 = time.perf_counter()
                mod._fit_step(batch)
                losses.append(float(mod.get_outputs()[0].asnumpy()))
                ms = 1e3 * (time.perf_counter() - t0)
                if on_step is not None:
                    seen.append(on_step(counter_delta(before), ms))
    return mod, it, losses, seen


def fm_train(mt, card, path):
    """32 (c): the FM through ``Module._fit_step`` at the example's
    settings, each step one replay of ``CachedTrainStep``'s program with
    its CSR a static input (``sparse_eager_steps`` 0); its first
    ``CSR_CAPTURE_STEPS`` steps held bit for bit against the same steps
    under ``capture.eager()``."""
    from mxnet_tpu_torch import profiler
    profiler.reset_counters("sparse_eager_steps")
    t0 = time.perf_counter()
    mod, it, losses, seen = fm_steps(mt, path, "captured", FM["epochs"],
                                     lambda c, ms: (c, ms))
    seconds = time.perf_counter() - t0
    per_step = [c for c, _ in seen]
    step_ms = float(np.median([ms for _, ms in seen[1:]]))
    steps = len(losses)
    nb = steps // FM["epochs"]
    epochs = [sum(losses[i:i + nb]) / nb for i in range(0, steps, nb)]
    eager = profiler.counter("sparse_eager_steps")
    captures = sum(c["graph_captures"] for c in per_step)
    replays = sum(c["graph_replays"] for c in per_step)
    acc = sparse_accuracy(mod, it, binary=True)
    del mod
    free_card()
    ok = {}
    for mode in STEP_MODES:
        m, _, ok[mode], _ = fm_steps(mt, path, mode, 1)
        ok[mode] = (ok[mode][:CSR_CAPTURE_STEPS],
                    _state_of(m, ("w", "v", "w0")))
        del m
    bitwise = ok["captured"][0] == ok["eager"][0] \
        and _bits_equal(ok["captured"][1], ok["eager"][1])
    free_card()
    log("phase 32 (c) FM (%d features, factor %d) on %s, batch %d, Adam lr "
        "%g: losses %.4f -> %.4f, accuracy %.4f, %d steps in %.2f s with the "
        "set-up and the data (a step and its loss's read %.3f ms, median "
        "after the first), eager %d, replays %d, captures %d; captured "
        "equal to eager over %d steps: %s"
        % (FM["dim"], FM["factor"], card, FM["batch"], FM["lr"], epochs[0],
           epochs[-1], acc, steps, seconds, step_ms, eager, replays,
           captures, CSR_CAPTURE_STEPS, bitwise))
    if not epochs[-1] < 0.5 * epochs[0] or not acc > 0.8 or eager \
            or replays != steps or captures != 1 or not bitwise:
        raise AssertionError("phase 32 (c) FM: losses %s, accuracy %.4f, "
                             "eager steps %d, replays %d and captures %d in "
                             "%d steps, captured equal to eager %s"
                             % (epochs, acc, eager, replays, captures, steps,
                                bitwise))
    return dict(epoch_losses=epochs, accuracy=acc, steps=steps,
                seconds=seconds, ms_per_step=step_ms,
                eager_steps=eager, replays=replays, captures=captures,
                captured_equals_eager=bitwise)


def sparse_files_check(mt, card):
    """32 (d): ``nd.save`` of a CSR and a row_sparse array on the card, the
    same bytes as on the CPU; a pickled CSR restored dense with its tag."""
    import pickle
    rng = np.random.RandomState(34)
    dense = rng.rand(6, 9).astype(np.float32)
    dense[dense < 0.6] = 0

    def arrays(ctx):
        return {"csr": mt.nd.csr_matrix(dense, ctx=ctx),
                "rsp": mt.nd.row_sparse_array((dense[[1, 4]], [1, 4]),
                                              shape=(6, 9), ctx=ctx)}
    on_card = mt.nd.save_to_bytes(arrays(mt.gpu(0)))
    on_cpu = mt.nd.save_to_bytes(arrays(mt.cpu()))
    back = pickle.loads(pickle.dumps(arrays(mt.gpu(0))["csr"]))
    ok = dict(save_bytes_equal=on_card == on_cpu, save_bytes=len(on_card),
              pickle_stype=back.stype, pickle_context=str(back.context),
              pickle_equal=bool(np.array_equal(back.asnumpy(), dense)))
    log("phase 32 (d) sparse files on %s: %s" % (card, ok))
    if not (ok["save_bytes_equal"] and ok["pickle_equal"]
            and back.stype == "csr" and back.context == mt.gpu(0)):
        raise AssertionError("phase 32 (d): %s" % ok)
    return ok


def phase_sparse(card):
    """Phase 32: (a) the CSR kernels against their plain versions, then,
    with their counts set to 0, (b) the linear model at avazu-app's width
    (the slice's path), its fp64 steps card against CPU, (c) the FM, (d)
    the sparse files."""
    import tempfile
    import mxnet_tpu_torch as mt
    t0 = time.perf_counter()
    res, seconds = {"card": card}, {}

    def part(key, fn, *args):
        t = time.perf_counter()
        res[key] = fn(*args)
        seconds[key] = time.perf_counter() - t

    part("kernels", csr_kernel_check, card)
    with tempfile.TemporaryDirectory(dir=os.path.dirname(
            os.path.abspath(__file__))) as tmp:
        part("data", lambda: dict(zip(("path", "fm_path"),
                                      write_sparse_data(tmp, mt))))
        path = res["data"]["path"]
        part("linear", sparse_linear_train, mt, card, path, None)
        part("linear_kv", sparse_linear_train, mt, card, path, "local")
        part("card_vs_cpu", sparse_linear_card_vs_cpu, mt, card, path)
        part("fm", fm_train, mt, card, res["data"]["fm_path"])
    part("files", sparse_files_check, mt, card)
    del res["data"]
    res["seconds"] = dict(seconds, total=time.perf_counter() - t0)
    log("phase 32: %s s" % {k: round(v, 1) for k, v in
                            res["seconds"].items()})
    return res


# -- phase 33: the Executor's programs (ROADMAP A.1) --------------------------
# The JAX package jits every path through a bound Executor
# (mxnet_tpu/executor.py:139-181, :436-475); the port replays captured
# programs: a forward; a training forward and its backward as the two
# stages of one program; forward_backward as one, with ones or with given
# output gradients.  Each entry point in turns (EXEC_CALLS), captured
# against capture.eager(), from one init over the same batches: the MNIST
# MLP of phase 7 (fp32, TF32 off) bit for bit with grad_req write and add,
# ResNet-50 at batch 2 in fp64 from phase 9's init to RESNET_PARITY_TOL
# (outputs to out1, gradients to params1, relative to max(1, |g|)).  Then
# at batch 32 in fp32, ResNet-50 and Inception-v3: forward then backward,
# forward_backward and the eval forward timed captured and eager (median
# of EXEC_TIMED after EXEC_WARMUP), with the peak memory of each mode.
EXEC_CALLS = ("two", "fb", "eval", "fb_og", "two", "fb", "fb_og", "eval")
EXEC_WARMUP, EXEC_TIMED = 3, 10
# replays and captures of each kind of call: forward then backward replays
# the two stages of one program
EXEC_REPLAYS = dict(two=2, fb=1, fb_og=1, eval=1)


def exec_call(exe, call, feed, og):
    if call == "two":
        exe.forward(is_train=True, **feed)
        exe.backward()
    elif call == "fb":
        exe.forward_backward(**feed)
    elif call == "fb_og":
        exe.forward_backward(out_grads=og, **feed)
    else:
        exe.forward(is_train=False, **feed)


def exec_calls_run(exe, feeds, og, mode):
    """``EXEC_CALLS`` on ``exe`` over ``feeds`` in ``mode``: after each
    call its outputs and the gradients (host fp64 copies), and the step
    counters of each call."""
    outs, counts = [], []
    with step_mode(mode):
        for call, feed in zip(EXEC_CALLS, feeds):
            before = counter_snapshot()
            exec_call(exe, call, feed, og)
            torch.cuda.synchronize()
            counts.append(counter_delta(before))
            outs.append([o._data.detach().to("cpu", torch.float64)
                         for o in exe.outputs]
                        + [exe.grad_dict[n]._data.detach().to(
                            "cpu", torch.float64) for n in exe._grad_names])
    return outs, counts


def exec_counts_ok(counts):
    """Each captured call one replay of each stage it runs, and a capture
    only at the first call of its kind."""
    seen = set()
    for call, c in zip(EXEC_CALLS, counts):
        first = call not in seen
        seen.add(call)
        want = dict(graph_replays=EXEC_REPLAYS[call],
                    program_calls=EXEC_REPLAYS[call],
                    graph_captures=EXEC_REPLAYS[call] if first else 0)
        if c != want:
            return False
    return True


def exec_mlp(card, grad_req):
    """The MLP's executor: captured against eager over ``EXEC_CALLS``, bit
    for bit; (bitwise, captured counters)."""
    import mxnet_tpu_torch as mt
    register_pl_scale()
    gpu = mt.gpu(0)
    x, y, _, _ = _mnist_on(gpu)
    feeds = [dict(data=x[i * MLP_BATCH:(i + 1) * MLP_BATCH],
                  softmax_label=y[i * MLP_BATCH:(i + 1) * MLP_BATCH])
             for i in range(len(EXEC_CALLS))]
    gen = torch.Generator(device="cuda").manual_seed(33)
    og = mt.nd.NDArray(torch.rand((MLP_BATCH, 10), generator=gen,
                                  device="cuda"), gpu)
    runs, init = {}, None
    for mode in STEP_MODES:
        exe = bind_mlp(gpu, grad_req=grad_req)
        if init is None:
            init_mlp(exe)
            init = {n: exe.arg_dict[n].copy() for n in param_names(exe)}
        else:
            exe.copy_params_from(init)
        runs[mode] = exec_calls_run(exe, feeds, og, mode)
        del exe
    bitwise = all(torch.equal(a, b) for u, v in zip(runs["captured"][0],
                                                   runs["eager"][0])
                  for a, b in zip(u, v))
    return bitwise, runs["captured"][1]


def exec_resnet_fp64(card, init):
    """ResNet-50 at batch 2 in fp64 from ``init``: captured against eager
    over ``EXEC_CALLS``; the largest distances of the outputs and of the
    gradients (relative to max(1, |g|)), and the captured counters."""
    import mxnet_tpu_torch as mt
    gpu = mt.gpu(0)
    db = resnet_batch(gpu, RESNET_PARITY_BATCH, torch.float64,
                      label_dtype=torch.float64)
    feed = dict(data=db.data[0], softmax_label=db.label[0])
    og = mt.nd.NDArray(torch.full((RESNET_PARITY_BATCH, 1000), 0.5,
                                  dtype=torch.float64, device="cuda"), gpu)
    runs = {}
    for mode in STEP_MODES:
        mod = resnet_module(gpu, RESNET_PARITY_BATCH, torch.float64)
        resnet_train_setup(mod, _cast_params(init, torch.float64))
        runs[mode] = exec_calls_run(mod._exec_group.execs[0],
                                    [feed] * len(EXEC_CALLS), og, mode)
        del mod
        free_card()
    out_gap = grad_gap = 0.0
    for u, v in zip(runs["captured"][0], runs["eager"][0]):
        out_gap = max(out_gap, float((u[0] - v[0]).abs().max()))
        for a, b in zip(u[1:], v[1:]):
            grad_gap = max(grad_gap, float(((a - b).abs()
                                            / b.abs().clamp_min(1.0)).max()))
    return out_gap, grad_gap, runs["captured"][1]


def exec_timing(card, model, batch, image):
    """``model`` at ``batch`` in fp32 (TF32 off) through its executor:
    forward then backward, forward_backward and the eval forward, median
    ms of ``EXEC_TIMED`` after ``EXEC_WARMUP``, captured and eager, and
    each mode's peak memory."""
    import mxnet_tpu_torch as mt
    gpu = mt.gpu(0)
    db = resnet_batch(gpu, batch, torch.float32, image=image)
    feed = dict(data=db.data[0], softmax_label=db.label[0])
    res = {}
    for mode in STEP_MODES:
        mod = resnet_module(gpu, batch, torch.float32, image=image,
                            model=model)
        resnet_train_setup(mod)
        exe = mod._exec_group.execs[0]
        free_card()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        res[mode] = {}
        with step_mode(mode):
            for call in ("two", "fb", "eval"):
                times = _timed(lambda: exec_call(exe, call, feed, None),
                               EXEC_WARMUP + EXEC_TIMED)
                res[mode][call + "_ms"] = _median(times[EXEC_WARMUP:])
        res[mode]["peak_gb"] = (torch.cuda.max_memory_allocated()
                                - base) / 1e9
        res[mode]["reserved_gb"] = torch.cuda.memory_reserved() / 1e9
        del mod, exe
        free_card()
    return res


def phase_executor_programs(card, resnet_init):
    """Phase 33: the Executor's captured programs against eager on the MLP
    (write and add) and fp64 ResNet-50, with their replays counted; then
    their times and peak memory at batch 32."""
    t0 = time.perf_counter()
    tf32_flags()
    res, bad = {"card": card}, []
    for req in ("write", "add"):
        bitwise, counts = exec_mlp(card, req)
        res["mlp_" + req] = dict(bitwise=bitwise, counters=counts)
        if not bitwise or not exec_counts_ok(counts):
            bad.append("MLP grad_req %s: bit for bit %s, counters %s"
                       % (req, bitwise, counts))
    out_gap, grad_gap, counts = exec_resnet_fp64(card, resnet_init)
    tol = RESNET_PARITY_TOL[torch.float64]
    res["resnet50_fp64"] = dict(outputs_max_abs=out_gap,
                                grads_max_rel=grad_gap, counters=counts,
                                limits=dict(outputs=tol["out1"],
                                            grads=tol["params1"]))
    if not out_gap <= tol["out1"] or not grad_gap <= tol["params1"] \
            or not exec_counts_ok(counts):
        bad.append("ResNet-50 fp64: outputs %.3g, gradients %.3g, counters "
                   "%s" % (out_gap, grad_gap, counts))
    for model, batch, image in (("resnet50_v1", RESNET_BATCH, RESNET_IMAGE),
                                ("inceptionv3", INCEPTION_BATCH,
                                 INCEPTION_IMAGE)):
        res[model] = exec_timing(card, model, batch, image)
    res["seconds"] = time.perf_counter() - t0
    log("phase 33 the Executor's programs on %s: %s" % (card, res))
    if bad:
        raise AssertionError("phase 33: %s" % "; ".join(bad))
    return res


# -- phase 34: the API surface (ROADMAP A.4, Monitor, FeedForward) ---------
# (a) ResNet-50 through Module.fit at batch 32, fp32 with TF32 off, under a
# Monitor that arms every API_INTERVAL-th batch for the conv and dense
# outputs, against the same two-call loop without a monitor.  cuDNN is
# set deterministic for the phase, so that an armed batch (run node by
# node) and a captured one can agree bit for bit.
API_BATCHES, API_INTERVAL = 8, 4
API_PATTERN = r"^(convolution|fullyconnected)\d+_output$"
# where the monitored run is not bit for bit the unmonitored one, it is
# held to RESNET_PARITY_TOL: the first batch's outputs to its fp32 limit,
# the parameters to its limit after an update
# a row is the statistic's fp32 text: the eager recompute gives the same
# number within this (relative)
API_ROW_RTOL = 1e-5
# (c) the gradient penalty: hybridized against not and card against CPU,
# fp32, largest |difference| over max(1, |value|)
API_PENALTY_TOL = 1e-5
API_PENALTY_ROWS, API_PENALTY_IN, API_PENALTY_WIDTH = 256, 64, 128
API_PENALTY_DROPOUT = 0.5
# (e) a page-locked array this large is copied to the card and written
# on the host straight after: the copy must hold the values before
API_PINNED_BYTES = 256 << 20
API_FLASH_SHAPE = (2, 4, 256, 64)
# (b) the MLP's monitored fit arms every API_MLP_INTERVAL-th batch
API_MLP_INTERVAL = 16


def api_kernel_counts():
    """The hand kernels' counts that phase 34 reads, by name."""
    from mxnet_tpu_torch import profiler
    from mxnet_tpu_torch.ops import sparse_dot as sd
    names = ["scale_launches", "flash_attn_fwd_launches",
             "flash_attn_bwd_launches"] + sorted(sd.COUNTERS.values())
    return {n: profiler.counter(n) for n in names}


def checked_monitor(exe, **kw):
    """A ``Monitor`` that also keeps, for each armed batch, ``exe``'s
    arguments as the batch met them (copies on the card) and its rows,
    so that each row can be recomputed eagerly afterwards."""
    import mxnet_tpu_torch as mt

    class Checked(mt.Monitor):
        def tic(self):
            if self.step % self.interval == 0:   # in argument order
                self.snapshots.append({n: exe.arg_dict[n]._data.clone()
                                       for n in exe.arg_names})
            super().tic()

        def toc(self):
            rows = super().toc()
            if rows:   # the batch's inputs, as the forward read them
                for n in ("data", "softmax_label"):
                    self.snapshots[-1][n] = exe.arg_dict[n]._data.clone()
                self.rows.append(rows)
            return rows
    mon = Checked(**kw)
    mon.snapshots, mon.rows = [], []
    return mon


def api_resnet_iter(batches=API_BATCHES):
    """``batches`` seeded ResNet-50 batches of 32 in an ``NDArrayIter`` on
    the host, the way ``fit`` is fed."""
    import mxnet_tpu_torch as mt
    rng = np.random.RandomState(34)
    n = batches * RESNET_BATCH
    x = rng.rand(n, 3, RESNET_IMAGE, RESNET_IMAGE).astype(np.float32)
    y = rng.randint(0, 1000, (n,)).astype(np.float32)
    return mt.io.NDArrayIter(x, y, batch_size=RESNET_BATCH)


def api_resnet_run(it, monitored):
    """ResNet-50 over ``it`` (one epoch) from Xavier after
    ``random.seed(0)``, SGD lr 0.1, momentum 0.9, wd 1e-4: through
    ``Module.fit`` under a :func:`checked_monitor`, or the loop that
    ``fit`` runs under a monitor (forward_backward, update, the metric)
    without one.  Returns (module, monitor or None, [(ms, step
    counters)] a batch, the parameters and the first batch's outputs as
    fp64 host tensors)."""
    import mxnet_tpu_torch as mt
    mod = resnet_module(mt.gpu(0), RESNET_BATCH, torch.float32,
                        image=RESNET_IMAGE)
    mon = checked_monitor(mod._exec_group.execs[0], interval=API_INTERVAL,
                          pattern=API_PATTERN) if monitored else None
    record, first, clock = [], [], {}

    def mark():
        torch.cuda.synchronize()
        clock.update(t=time.perf_counter(), c=counter_snapshot())

    def on_batch(_):
        torch.cuda.synchronize()
        if not first:
            first.append(mod.get_outputs()[0]._data.to("cpu", torch.float64))
        record.append((1e3 * (time.perf_counter() - clock["t"]),
                       counter_delta(clock["c"])))
        mark()
    it.reset()
    if monitored:
        mt.random.seed(0)
        mark()
        mod.fit(it, num_epoch=1, monitor=mon, batch_end_callback=on_batch,
                initializer=mt.initializer.Xavier(), optimizer="sgd",
                optimizer_params=(("learning_rate", RESNET_LR),
                                  ("momentum", RESNET_MOMENTUM),
                                  ("wd", RESNET_WD)))
    else:
        resnet_train_setup(mod)
        metric = mt.metric.create("acc")
        mark()
        for batch in it:
            mod.forward_backward(batch)
            mod.update()
            mod.update_metric(metric, batch.label)
            on_batch(None)
    arg, _ = mod.get_params()
    params = {n: a._data.to("cpu", torch.float64) for n, a in arg.items()}
    return mod, mon, record, params, first[0]


def api_recompute_rows(mon):
    """Each armed batch's rows against mean(|x|) of the same outputs of
    an eager training forward of a fresh Module over the kept arguments
    (the same graph, its names counted on: matched in order):
    (largest relative difference, rows checked)."""
    import re
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import capture
    pattern = re.compile(API_PATTERN)
    worst, checked = 0.0, 0
    for snap, rows in zip(mon.snapshots, mon.rows):
        mod = resnet_module(mt.gpu(0), RESNET_BATCH, torch.float32,
                            image=RESNET_IMAGE)
        resnet_train_setup(mod)
        exe = mod._exec_group.execs[0]
        seen = []   # in the order of the forward, as the rows are
        exe.set_monitor_callback(
            lambda name, arr: seen.append(arr._data.abs().mean())
            if pattern.match(name) else None)
        with capture.eager():
            exe.forward(is_train=True, **{n: mt.nd.NDArray(t, mt.gpu(0))
                                          for n, t in zip(
                                              exe.arg_names,
                                              snap.values())})
        if len(seen) != len(rows):
            return float("inf"), checked
        for (_, _, text), want in zip(rows, seen):
            want = float(want)
            worst = max(worst, abs(float(text) - want) / abs(want))
            checked += 1
        del mod, exe, seen
        free_card()
    return worst, checked


def _gap(a, b, per="entry"):
    """Largest |a - b| over sequences of tensors, each difference over
    max(1, |b|) entry by entry (``per="entry"``) or over its array's
    largest |b| (``per="array"``: the second order of a sparse product
    sums terms far larger than the entries where they cancel)."""
    def scale(v):
        return v.abs().clamp_min(1.0) if per == "entry" else v.abs().max()
    return max(float(((u - v).abs() / scale(v)).max()) for u, v in zip(a, b))


def api_resnet_monitor(card):
    """Phase 34a: ResNet-50's monitored ``fit`` against the unmonitored
    two-call loop; (results, faults)."""
    tf32 = tf32_flags()
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    it = api_resnet_iter()
    try:
        mod, mon, rec_m, params_m, out_m = api_resnet_run(it, True)
        cached = mod._cached_step
        del mod
        free_card()
        mod, _, rec_u, params_u, out_u = api_resnet_run(it, False)
        del mod
        free_card()
        worst_row, n_rows = api_recompute_rows(mon)
    finally:
        torch.backends.cudnn.deterministic = prev
    names = sorted(params_u)
    armed = [i for i in range(API_BATCHES) if i % API_INTERVAL == 0]
    unarmed = [i for i in range(API_BATCHES) if i not in armed]
    counts = [c for _, c in rec_m]
    bitwise = torch.equal(out_m, out_u) and all(
        torch.equal(params_m[n], params_u[n]) for n in params_m)
    res = dict(
        card=card, tf32=tf32, cudnn_deterministic=True, batch=RESNET_BATCH,
        batches=API_BATCHES, interval=API_INTERVAL, pattern=API_PATTERN,
        held="bit for bit" if bitwise else "RESNET_PARITY_TOL",
        bitwise=bitwise, params_max_rel=_gap([params_m[n] for n in names],
                                             [params_u[n] for n in names]),
        first_outputs_max_abs=float((out_m - out_u).abs().max()),
        cached_train_step_built=cached is not None,
        replays=[c["graph_replays"] for c in counts],
        captures=[c["graph_captures"] for c in counts],
        rows_per_armed_batch=[len(r) for r in mon.rows],
        rows_checked=n_rows, rows_max_rel=worst_row,
        monitored_armed_ms=[rec_m[i][0] for i in armed],
        monitored_unarmed_ms_median=_median(
            [rec_m[i][0] for i in unarmed[1:]]),
        unmonitored_ms_median=_median([t for t, _ in rec_u[1:]]))
    bad = []
    # one capture in all, at the first unarmed batch
    if cached is not None or any(counts[i]["graph_replays"] for i in armed) \
            or any(counts[i]["graph_replays"] != 1 for i in unarmed) \
            or [bool(c) for c in res["captures"]] != [
                i == unarmed[0] for i in range(API_BATCHES)]:
        bad.append("step path: CachedTrainStep built %s, replays %s, "
                   "captures %s" % (cached is not None, res["replays"],
                                    res["captures"]))
    if len(mon.rows) != len(armed) or not n_rows \
            or not worst_row <= API_ROW_RTOL:
        bad.append("monitor rows: %d armed batches with rows, %d rows, "
                   "max rel %.3g against the eager recompute"
                   % (len(mon.rows), n_rows, worst_row))
    limit = RESNET_PARITY_TOL[torch.float64]["params1"]
    if not bitwise and not (
            res["first_outputs_max_abs"]
            <= RESNET_PARITY_TOL[torch.float32]["out1"]
            and res["params_max_rel"] <= limit):
        bad.append("monitored against unmonitored: first outputs %.3g, "
                   "parameters %.3g (limit %.3g)"
                   % (res["first_outputs_max_abs"], res["params_max_rel"],
                      limit))
    return res, bad


# (b) the MNIST MLP (phase 7's network, through the scale kernel)
def api_mlp_feedforward(card):
    """Phase 34b: ``FeedForward`` on the card's default context: fit,
    predict and score against ``Module.fit`` with the same initializer
    and data, bit for bit, ``save``/``load``, the scale kernel's launches
    counted; then ``Module.fit`` under a monitor.  (results, faults)."""
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import sym
    from mxnet_tpu_torch.ops import scale as sc
    import tempfile
    register_pl_scale()
    blob = mt.test_utils.get_mnist()
    x = blob["train_data"].reshape(-1, 784)[:MLP_STEPS * MLP_BATCH]
    y = blob["train_label"][:MLP_STEPS * MLP_BATCH]
    xt = blob["test_data"].reshape(-1, 784)
    yt = blob["test_label"]
    warm = mt.capture.WARMUP_RUNS
    opt = dict(learning_rate=MLP_LR, momentum=MLP_MOMENTUM)
    bad, res = [], {"card": card}

    def launches(fn):
        before = sc.launch_count()
        out = fn()
        torch.cuda.synchronize()
        return out, sc.launch_count() - before
    mt.random.seed(0)
    with mt.name.NameManager():
        model = mt.model.FeedForward(build_mlp(sym), num_epoch=1,
                                     numpy_batch_size=MLP_BATCH,
                                     initializer=mt.init.Xavier(), **opt)
    if model.ctx != [mt.gpu(0)]:
        bad.append("FeedForward's default context %s" % model.ctx)
    _, fit_n = launches(lambda: model.fit(x, y))
    eval_it = mt.io.NDArrayIter(xt, yt, batch_size=MLP_BATCH)
    mt.random.seed(1)
    pred, pred_n = launches(lambda: model.predict(xt))
    acc, score_n = launches(lambda: model.score(eval_it))
    # the same through Module.fit
    mt.random.seed(0)
    it = mt.io.NDArrayIter(x, y, batch_size=MLP_BATCH, shuffle=True)
    with mt.name.NameManager():
        mod = mt.mod.Module(build_mlp(sym), context=mt.gpu(0))
    mod.fit(it, num_epoch=1, optimizer="sgd", optimizer_params=opt,
            initializer=mt.init.Xavier())
    arg, _ = mod.get_params()
    same = all(torch.equal(model.arg_params[n]._data, arg[n]._data)
               for n in arg)
    mt.random.seed(1)
    mod_pred = mod.predict(mt.io.NDArrayIter(xt, None, batch_size=MLP_BATCH,
                                             shuffle=True)).asnumpy()
    same_pred = np.array_equal(pred, mod_pred)
    with tempfile.TemporaryDirectory() as tmp:
        prefix = os.path.join(tmp, "mlp")
        model.save(prefix)
        loaded = mt.model.FeedForward.load(prefix, 1,
                                           numpy_batch_size=MLP_BATCH)
        mt.random.seed(1)
        again, load_n = launches(lambda: loaded.predict(xt))
    round_trip = np.array_equal(again, pred)
    n_train, n_eval = MLP_STEPS, xt.shape[0] // MLP_BATCH
    want = dict(fit=n_train + warm, predict=n_eval + warm, score=n_eval,
                load_predict=n_eval + warm)
    got = dict(fit=fit_n, predict=pred_n, score=score_n, load_predict=load_n)
    res.update(feedforward_equals_module=same, predict_equal=same_pred,
               save_load_equal=round_trip, accuracy=acc,
               scale_launches=got, scale_launches_expected=want)
    if not (same and same_pred and round_trip) or got != want \
            or acc < JAX_CPU_ACCURACY - 0.02:
        bad.append("FeedForward: equal to Module %s, predictions %s, "
                   "save/load %s, accuracy %.4f, scale launches %s (want %s)"
                   % (same, same_pred, round_trip, acc, got, want))
    # Module.fit under a monitor: each armed batch launches the kernel once
    # (node by node), the others replay the executor's program
    mt.random.seed(0)
    it.reset()
    with mt.name.NameManager():
        mod = mt.mod.Module(build_mlp(sym), context=mt.gpu(0))
    per_batch = []
    last = [sc.launch_count()]

    def on_batch(_):
        torch.cuda.synchronize()
        per_batch.append(sc.launch_count() - last[0])
        last[0] = sc.launch_count()
    mon = mt.Monitor(interval=API_MLP_INTERVAL, pattern=r".*pl_scale.*")
    mod.fit(it, num_epoch=1, optimizer="sgd", optimizer_params=opt,
            initializer=mt.init.Xavier(), monitor=mon,
            batch_end_callback=on_batch)
    armed = list(range(0, MLP_STEPS, API_MLP_INTERVAL))
    first_unarmed = 1
    want_batches = [1 + (warm if i == first_unarmed else 0)
                    for i in range(MLP_STEPS)]
    res["monitored_fit_launches"] = sum(per_batch)
    res["monitored_armed_launches"] = [per_batch[i] for i in armed]
    if per_batch != want_batches or mod._cached_step is not None:
        bad.append("MLP under a monitor: launches a batch %s, CachedTrainStep "
                   "%s" % (per_batch, mod._cached_step is not None))
    return res, bad


# (c) second order on the card
def api_penalty(mt, ctx, net, x):
    """The gradient penalty sum((|d net(x)/dx| - 1)^2) on ``ctx`` and its
    gradients: [penalty, d/dx, each parameter's] as fp64 host tensors."""
    x = mt.nd.array(x, ctx=ctx)
    x.attach_grad()
    with mt.autograd.record():
        y = net(x)
        (gx,) = mt.autograd.grad(y, [x], create_graph=True)
        pen = (((gx * gx).sum(axis=1).sqrt() - 1.0) ** 2).sum()
    pen.backward()
    return [t.detach().to("cpu", torch.float64) for t in
            [pen._data, x.grad._data]
            + [p.grad()._data for p in net.collect_params().values()]]


def api_dense_net(mt, ctx, seed=34, dropout=None):
    """Phase 34's Dense stack (a ``Dropout`` of rate ``dropout`` before
    the last layer, if given)."""
    mt.random.seed(seed)
    net = mt.gluon.nn.HybridSequential(prefix="gp_")
    with net.name_scope():
        net.add(mt.gluon.nn.Dense(API_PENALTY_WIDTH, activation="tanh",
                                  in_units=API_PENALTY_IN),
                mt.gluon.nn.Dense(API_PENALTY_WIDTH, activation="tanh",
                                  in_units=API_PENALTY_WIDTH))
        if dropout is not None:
            net.add(mt.gluon.nn.Dropout(dropout))
        net.add(mt.gluon.nn.Dense(1, in_units=API_PENALTY_WIDTH))
    net.initialize(mt.init.Xavier(), ctx=ctx)
    return net


def api_dropout_penalty(mt, gpu, x):
    """Phase 34c with a ``Dropout`` in the stack: the hybridized block's
    penalty (its call replayed, the recompute under ``create_graph``)
    against the block run eagerly from the generator state the replay
    began at, and the generator left where the eager run leaves it; a
    third run from another state must differ, so that the mask is seen
    to matter.  (results, faults)"""
    from mxnet_tpu_torch import profiler
    eager_net = api_dense_net(mt, gpu, dropout=API_PENALTY_DROPOUT)
    net = api_dense_net(mt, gpu, dropout=API_PENALTY_DROPOUT)
    net.hybridize()
    gen = mt.random.generator(gpu)
    with mt.autograd.record():  # captures the call's program
        loss = net(mt.nd.array(x, ctx=gpu)).sum()
    loss.backward()
    net.collect_params().zero_grad()
    start = gen.get_state()
    before = profiler.counter("create_graph_recomputes")
    hyb = api_penalty(mt, gpu, net, x)
    recomputes = profiler.counter("create_graph_recomputes") - before
    end = gen.get_state()
    gen.set_state(start)
    eager = api_penalty(mt, gpu, eager_net, x)
    res = dict(rate=API_PENALTY_DROPOUT, recomputes=recomputes,
               hybridized_vs_eager=_gap(hyb, eager),
               generator_left_alike=bool(torch.equal(gen.get_state(), end)),
               other_mask_gap=_gap(api_penalty(mt, gpu, eager_net, x), hyb))
    bad = []
    if recomputes != 1 or not res["generator_left_alike"] \
            or res["hybridized_vs_eager"] > API_PENALTY_TOL \
            or not res["other_mask_gap"] > API_PENALTY_TOL:
        bad.append("gradient penalty through Dropout: %s" % res)
    return res, bad


def api_second_order(card):
    """Phase 34c: a gradient penalty through a hybridized Dense stack
    (the recompute), ``dot`` of a CSR through the kernels and
    ``FlashAttention`` under ``create_graph``.  (results, faults)."""
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import profiler
    from mxnet_tpu_torch.ops import attention as att
    from mxnet_tpu_torch.ops import sparse_dot as sd
    tf32_flags()
    gpu = mt.gpu(0)
    x = np.random.RandomState(34).randn(API_PENALTY_ROWS,
                                        API_PENALTY_IN).astype(np.float32)
    eager = api_penalty(mt, gpu, api_dense_net(mt, gpu), x)
    net = api_dense_net(mt, gpu)
    net.hybridize()
    before = profiler.counter("create_graph_recomputes")
    caps = profiler.counter("graph_captures")
    hyb = api_penalty(mt, gpu, net, x)
    recomputes = profiler.counter("create_graph_recomputes") - before
    captured = profiler.counter("graph_captures") - caps
    # a first-order backward of the same block replays its graph
    before = counter_snapshot()
    with mt.autograd.record():
        loss = net(mt.nd.array(x, ctx=gpu)).sum()
    loss.backward()
    first_order = counter_delta(before)
    first_recomputes = profiler.counter("create_graph_recomputes") \
        - before.get("create_graph_recomputes", 0)
    with mt.cpu():
        cpu = api_penalty(mt, mt.cpu(), api_dense_net(mt, mt.cpu()), x)
    res = dict(card=card, recomputes=recomputes, captures=captured,
               first_order=first_order,
               first_order_recomputes=first_recomputes,
               hybridized_vs_eager=_gap(hyb, eager),
               card_vs_cpu=_gap(hyb, cpu), tol=API_PENALTY_TOL)
    bad = []
    if recomputes != 1 or captured < 1 or first_recomputes \
            or first_order["graph_replays"] != 2 \
            or res["hybridized_vs_eager"] > API_PENALTY_TOL \
            or res["card_vs_cpu"] > API_PENALTY_TOL \
            or not all(float(t.abs().max()) > 0 for t in hyb[2:-1]):
        bad.append("gradient penalty: %s" % res)
    res["dropout"], faults = api_dropout_penalty(mt, gpu, x)
    bad += faults
    # dot of a CSR: the second-order backward runs the kernels again
    rng = np.random.RandomState(35)
    dense = (rng.randn(512, 1024) * (rng.rand(512, 1024) < 0.02)).astype(
        np.float32)
    w0 = rng.randn(1024, 16).astype(np.float32)
    csr_res = []
    for ctx in (gpu, mt.cpu()):
        csr = mt.nd.array(dense, ctx=ctx).tostype("csr")
        w = mt.nd.array(w0, ctx=ctx)
        w.attach_grad()
        counts = {k: profiler.counter(v) for k, v in sd.COUNTERS.items()}
        with mt.autograd.record():
            o = mt.nd.dot(csr, w)
            (gw,) = mt.autograd.grad((o * o).sum(), [w], create_graph=True)
            pen = (gw * gw).sum()
        pen.backward()
        csr_res.append((
            [gw._data.detach().to("cpu", torch.float64),
             w.grad._data.to("cpu", torch.float64)],
            {k: profiler.counter(v) - counts[k]
             for k, v in sd.COUNTERS.items()}))
    (card_grads, res["csr_launches"]), (cpu_grads, _) = csr_res
    res["csr_card_vs_cpu"] = _gap(card_grads, cpu_grads, per="array")
    if res["csr_card_vs_cpu"] > CSR_TOL[torch.float32] \
            or res["csr_launches"]["csr_dot"] < 2 \
            or res["csr_launches"]["csr_t_dot"] < 2:
        bad.append("dot(csr) second order: gap %.3g, launches %s"
                   % (res["csr_card_vs_cpu"], res["csr_launches"]))
    # flash attention: first order runs the backward kernel; under
    # create_graph it refuses, as the JAX package's kernel cannot be
    # differentiated twice
    dev = gpu.torch_device
    gen = torch.Generator(device=dev).manual_seed(34)
    q, k, v = (torch.randn(API_FLASH_SHAPE, generator=gen, device=dev,
                           requires_grad=True) for _ in range(3))
    fwd0, bwd0 = att.launch_count(), att.backward_launch_count()
    (gq,) = torch.autograd.grad((att.flash_attention(q, k, v) ** 2).sum(),
                                [q])
    refused = False
    try:
        torch.autograd.grad((att.flash_attention(q, k, v) ** 2).sum(), [q],
                            create_graph=True)
    except mt.MXNetError:
        refused = True
    torch.cuda.synchronize()
    res["flash"] = dict(first_order_finite=bool(torch.isfinite(gq).all()),
                        create_graph_refused=refused,
                        fwd_launches=att.launch_count() - fwd0,
                        bwd_launches=att.backward_launch_count() - bwd0)
    if not (refused and res["flash"]["first_order_finite"]) \
            or res["flash"]["bwd_launches"] != 1:
        bad.append("flash attention under create_graph: %s" % res["flash"])
    return res, bad


# (d) initializers on the card
def api_initializers(card):
    """Phase 34d: ``Orthogonal``, ``MSRAPrelu``, ``Bilinear`` and ``Mixed
    ([Bilinear, Xavier])`` on ``gpu(0)`` bit for bit the CPU's."""
    import mxnet_tpu_torch as mt
    cases = {
        "orthogonal": (lambda: mt.init.Orthogonal(), [("w_weight",
                                                       (256, 512))]),
        "msra_prelu": (lambda: mt.init.MSRAPrelu(), [("c_weight",
                                                      (64, 3, 7, 7))]),
        "bilinear": (lambda: mt.init.Bilinear(), [("up_weight",
                                                   (21, 21, 64, 64))]),
        "mixed": (lambda: mt.initializer.Mixed(
            ["(score2|score4|bigscore)_weight", ".*"],
            [mt.initializer.Bilinear(), mt.initializer.Xavier()]),
            [("score2_weight", (3, 3, 4, 4)), ("conv_1_weight", (16, 3, 3, 3)),
             ("bigscore_weight", (3, 3, 16, 16))]),
    }
    res, bad = {}, []
    for name, (make, arrays) in cases.items():
        got = []
        for ctx in (mt.gpu(0), mt.cpu()):
            mt.random.seed(34)
            init = make()
            out = []
            for pname, shape in arrays:
                arr = mt.nd.zeros(shape, ctx=ctx)
                init(mt.init.InitDesc(pname), arr)
                out.append(arr._data.cpu())
            got.append(out)
        res[name] = all(torch.equal(a, b) for a, b in zip(*got))
        if not res[name]:
            bad.append("%s on the card differs from the CPU" % name)
    return res, bad


# (e) symbols and parameters on the card
def api_symbols_params(card):
    """Phase 34e: ``get_symbol`` of a recorded computation bound and run on
    the card, ``Symbol.eval`` on the card by default, ``zero_grad`` with
    ``grad_req="add"`` on a hybridized block, ``reset_ctx`` to the CPU and
    back, ``cpu_pinned``.  (results, faults)."""
    import mxnet_tpu_torch as mt
    gpu = mt.gpu(0)
    res, bad = {}, []
    rng = np.random.RandomState(36)
    x = mt.nd.array(rng.randn(8, 32).astype(np.float32), ctx=gpu)
    w = mt.nd.array(rng.randn(16, 32).astype(np.float32), ctx=gpu)
    x.attach_grad()
    with mt.autograd.record():
        h = mt.nd.FullyConnected(x, w, num_hidden=16, no_bias=True)
        out = mt.nd.Activation(h * 0.5 + 1.0, act_type="tanh").sum(axis=1)
    s = mt.autograd.get_symbol(out)
    args = s.list_arguments()
    got = s.bind(gpu, {args[0]: x.detach(), args[1]: w}).forward()[0]
    res["get_symbol_bitwise"] = bool(torch.equal(got._data, out._data))
    ev = (mt.sym.var("x") * 2.0).eval(x=x.detach())[0]
    res["eval_context"] = str(ev.context)
    if not res["get_symbol_bitwise"] or ev.context != gpu:
        bad.append("get_symbol/eval on the card: %s" % res)

    def grads(net):
        return [p.grad()._data.clone() for p in net.collect_params().values()]

    def backward(net, xb):
        with mt.autograd.record():
            loss = (net(xb) ** 2).sum()
        loss.backward()
    xb = mt.nd.array(rng.randn(64, API_PENALTY_IN).astype(np.float32),
                     ctx=gpu)
    net = api_dense_net(mt, gpu)
    net.collect_params().setattr("grad_req", "add")
    net.hybridize()
    backward(net, xb)
    backward(net, xb)
    net.collect_params().zero_grad()
    backward(net, xb)
    once = api_dense_net(mt, gpu)
    once.collect_params().setattr("grad_req", "add")
    once.hybridize()
    backward(once, xb)
    res["zero_grad_bitwise"] = all(torch.equal(a, b) for a, b in
                                   zip(grads(net), grads(once)))
    if not res["zero_grad_bitwise"]:
        bad.append("zero_grad on the card: two backwards, zero_grad, one "
                   "backward differs from one backward")
    before = net(xb)._data.clone()
    caps = counter_snapshot()
    net.collect_params().reset_ctx(mt.cpu())
    on_cpu = net(mt.nd.array(xb.asnumpy(), ctx=mt.cpu()))._data
    net.collect_params().reset_ctx(gpu)
    after = net(xb)._data
    moved = counter_delta(caps)
    res["reset_ctx"] = dict(card_bitwise=bool(torch.equal(before, after)),
                            cpu_max_abs=float((on_cpu - before.cpu())
                                              .abs().max()),
                            captures=moved["graph_captures"])
    if not res["reset_ctx"]["card_bitwise"] or moved["graph_captures"] != 1 \
            or res["reset_ctx"]["cpu_max_abs"] > API_PENALTY_TOL:
        bad.append("reset_ctx to the CPU and back: %s" % res["reset_ctx"])
    pinned = mt.nd.array(rng.randn(4, 4).astype(np.float32),
                         ctx=mt.cpu_pinned())
    to_card = pinned.copyto(gpu)
    res["cpu_pinned"] = dict(is_pinned=bool(pinned._data.is_pinned()),
                             copy_equal=bool(torch.equal(
                                 to_card._data.cpu(), pinned._data)))
    # a host write straight after the copy waits for it
    big = mt.nd.full((API_PINNED_BYTES // 4,), 1.0, ctx=mt.cpu_pinned())
    big_on_card = big.copyto(gpu)
    big[:] = 2.0
    res["cpu_pinned"]["write_after_copy_held"] = bool(
        (big_on_card._data == 1.0).all())
    if not all(res["cpu_pinned"].values()):
        bad.append("cpu_pinned: %s" % res["cpu_pinned"])
    return res, bad


def phase_api_surface(card):
    """Phase 34: the API surface on the card (ROADMAP A.4 with Monitor and
    FeedForward): (a) ResNet-50's monitored ``Module.fit``, (b)
    ``FeedForward`` on the MLP through the scale kernel, (c) second-order
    gradients, (d) initializers, (e) symbols and parameters.  The hand
    kernels' counts are set to 0 first and read at the end."""
    from mxnet_tpu_torch import profiler
    t0 = time.perf_counter()
    profiler.reset_counters(*api_kernel_counts())
    res, bad = {"card": card}, []
    for key, fn in (("resnet50_monitor", api_resnet_monitor),
                    ("mlp_feedforward", api_mlp_feedforward),
                    ("second_order", api_second_order),
                    ("initializers", api_initializers),
                    ("symbols_params", api_symbols_params)):
        t = time.perf_counter()
        res[key], faults = fn(card)
        res[key]["seconds"] = time.perf_counter() - t
        bad += ["%s: %s" % (key, f) for f in faults]
        free_card()
    res["launches"] = api_kernel_counts()
    res["seconds"] = time.perf_counter() - t0
    log("phase 34 the API surface on %s: %s" % (card, res))
    if bad:
        raise AssertionError("phase 34: %s" % "; ".join(bad))
    return res


# -- phase 35: the Module family, the predict API, JPEG on the card ---------
# (ROADMAP A.6, A.5).  (a) ResNet-50 as a SequentialModule: the body (the
# zoo model's ``features``, up to its global pool, where MXNet's symbol
# script has ``flatten0``) as a Module with ``label_names=()`` and
# ``auto_wiring``, then the head (the classifier Dense, MXNet's ``fc1``,
# with SoftmaxOutput) with ``take_labels``: MF_STEPS batches of 32 in fp32
# (TF32 off, cuDNN deterministic), SGD with momentum, from the single
# Module's initial parameters, against the single Module's one-call step.
# Bit for bit is the aim; else RESNET_PARITY_TOL (params after an update).
MF_STEPS, MF_WARMUP = 8, 3
# fp64 card against cpu(), batch 2 (RESNET_PARITY_TOL), for (a) and (b)
MF_PARITY_STEPS = 3
# (c) Predictor.load of a checkpoint Module.save_checkpoint wrote, at these
# batches; ms/batch the median of MF_PREDICT_TIMED after MF_PREDICT_WARMUP
MF_PREDICT_BATCHES = (32, 1)
MF_PREDICT_WARMUP, MF_PREDICT_TIMED = 3, 10
# (d) phase 26's images (shorter side DATA_SHORT, quality DATA_QUALITY):
# MF_JPEGS of them in a .rec, in a .lst of files and, with 1-4 boxes each,
# in a .rec of detection records; MF_GREY_JPEGS encoded as grey.
MF_JPEGS, MF_GREY_JPEGS = 64, 4
MF_ITER_SEED = 35
MF_ITER_AUG = dict(resize=DATA_SHORT, rand_crop=True, rand_mirror=True,
                   mean=True)
MF_DET_SHAPE = (3, 300, 300)
# ImageIter's crops are at the decode's full resolution (a resize of a
# shorter side already DATA_SHORT changes nothing), where libjpeg's own
# error against the images before encoding is larger than LIBJPEG_ERR's,
# which was read after a resize to 224 x 224: on phase 26's first 32
# images, PIL-encoded, mean 5.4423 and rms 7.0601 (x 255 scale, printed by
# tests/test_torch_image_route.py::test_libjpeg_error_at_full_resolution).
LIBJPEG_FULL_ERR = {"mean": 5.4423, "rms": 7.0601}


def mf_kernel_counts():
    """Every hand kernel's count, by name (phase 35 reads them)."""
    from mxnet_tpu_torch import profiler
    from mxnet_tpu_torch.ops import image_nvjpeg as nj
    from mxnet_tpu_torch.ops import nms as nm
    names = list(api_kernel_counts()) + [nm.COUNTER, nj.COUNTER]
    return {n: profiler.counter(n) for n in names}


def mf_resnet_symbols(dtype, model="resnet50_v1", classes=1000, **model_kw):
    """ResNet cut in two, from one zoo model (so one set of parameter
    names): (whole, body, head, logits).  ``whole`` is ``resnet_symbol``'s
    graph, ``body`` the model's ``features``, ``head`` its classifier
    Dense then ``Cast`` and ``SoftmaxOutput`` on a ``data`` variable,
    ``logits`` the whole model without the softmax (35b)."""
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import sym
    with mt.name.NameManager():
        net = mt.gluon.model_zoo.vision.get_model(model, classes=classes,
                                                  **model_kw)
    if dtype != torch.float32:
        net.cast(str(dtype).replace("torch.", ""))
    out_dtype = "float64" if dtype == torch.float64 else "float32"

    def classify(x):
        return sym.Cast(net.output(x), dtype=out_dtype)

    def softmax(x):
        return sym.SoftmaxOutput(x, sym.Variable("softmax_label"),
                                 name="softmax")
    whole = softmax(classify(net.features(sym.Variable("data"))))
    body = net.features(sym.Variable("data"))
    head = softmax(classify(sym.Variable("data")))
    logits = classify(net.features(sym.Variable("data")))
    return whole, body, head, logits


def mf_descs(batch, dtype, image):
    from mxnet_tpu_torch.io import DataDesc
    label_dt = torch.float64 if dtype == torch.float64 else torch.float32
    return ([DataDesc("data", (batch, 3, image, image), dtype=dtype)],
            [DataDesc("softmax_label", (batch,), dtype=label_dt)])


def mf_opt_params():
    return (("learning_rate", RESNET_LR), ("momentum", RESNET_MOMENTUM),
            ("wd", RESNET_WD))


def mf_single(ctx, sym_, batch, dtype, image, init=None):
    """``sym_`` in one Module on ``ctx``: Xavier after ``random.seed(0)``
    (or ``init``), SGD with momentum."""
    import mxnet_tpu_torch as mt
    mod = mt.mod.Module(sym_, context=ctx)
    mod.bind(*mf_descs(batch, dtype, image))
    resnet_train_setup(mod, init)
    return mod


def mf_softmax_grad(scores, labels):
    """The reference test's softmax gradient
    (``tests/test_module.py:207-212``), kept in the scores' dtype."""
    import mxnet_tpu_torch as mt
    s = scores.asnumpy()
    e = np.exp(s - s.max(axis=1, keepdims=True))
    p = e / e.sum(axis=1, keepdims=True)
    p[np.arange(p.shape[0]), labels.asnumpy().astype(np.int64)] -= 1.0
    return mt.nd.array(p / p.shape[0], ctx=scores.context, dtype=s.dtype)


def mf_chain(ctx, first, second, batch, dtype, image, init):
    """A SequentialModule on ``ctx``: ``first`` (a Symbol, no labels,
    auto-wired), then ``second`` (a Symbol, or a module) taking the
    labels; bound, its parameters ``init`` (a ``get_params()`` pair),
    SGD with momentum."""
    import mxnet_tpu_torch as mt
    seq = mt.mod.SequentialModule()
    seq.add(mt.mod.Module(first, label_names=(), context=ctx),
            auto_wiring=True)
    if not isinstance(second, mt.mod.BaseModule):
        second = mt.mod.Module(second, context=ctx)
    seq.add(second, take_labels=True)
    seq.bind(*mf_descs(batch, dtype, image))
    seq.init_params(arg_params=init[0], aux_params=init[1])
    seq.init_optimizer(optimizer="sgd", optimizer_params=mf_opt_params())
    return seq


def _host_params(mod):
    arg, aux = mod.get_params()
    return {n: a._data.to("cpu", torch.float64, copy=True)
            for n, a in list(arg.items()) + list(aux.items())}


def mf_steps(mod, batches, on_card=True):
    """``_fit_step`` over ``batches``: [(ms, step counters)], the last
    outputs and the parameters (with the moving statistics) as fp64 host
    tensors, and the first outputs."""
    record, first = [], None
    for b in batches:
        if on_card:
            torch.cuda.synchronize()
        t0, c0 = time.perf_counter(), counter_snapshot()
        mod._fit_step(b)
        if on_card:
            torch.cuda.synchronize()
        record.append((1e3 * (time.perf_counter() - t0), counter_delta(c0)))
        if first is None:
            first = mod.get_outputs()[0]._data.to("cpu", torch.float64,
                                                  copy=True)
    last = mod.get_outputs()[0]._data.to("cpu", torch.float64, copy=True)
    return record, first, last, _host_params(mod)


def mf_resnet_chain(card, model="resnet50_v1", batch=RESNET_BATCH,
                    image=RESNET_IMAGE, steps=MF_STEPS, warmup=MF_WARMUP,
                    **model_kw):
    """35a: the chain against the single Module at ``batch`` fp32;
    (results, faults)."""
    import mxnet_tpu_torch as mt
    gpu = mt.gpu(0)
    tf32 = tf32_flags()
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        whole, body, head, _ = mf_resnet_symbols(torch.float32, model,
                                                 **model_kw)
        batches = [resnet_batch(gpu, batch, torch.float32, image=image,
                                classes=model_kw.get("classes", 1000),
                                seed=i) for i in range(steps)]
        single = mf_single(gpu, whole, batch, torch.float32, image)
        arg, aux = single.get_params()
        init = ({n: a.copy() for n, a in arg.items()},
                {n: a.copy() for n, a in aux.items()})
        rec_s, first_s, last_s, params_s = mf_steps(single, batches)
        one_call = single._cached_step is not None
        del single
        free_card()
        seq = mf_chain(gpu, body, head, batch, torch.float32, image, init)
        rec_c, first_c, last_c, params_c = mf_steps(seq, batches)
        chain_one_call = [m._cached_step for m in seq._modules]
        del seq
        free_card()
    finally:
        torch.backends.cudnn.deterministic = prev
    names = sorted(params_s)
    differ = sum(int((params_s[n] != params_c[n]).sum()) for n in names)
    total = sum(params_s[n].numel() for n in names)
    bitwise = differ == 0 and torch.equal(first_s, first_c) \
        and torch.equal(last_s, last_c)
    res = dict(
        card=card, tf32=tf32, cudnn_deterministic=True, batch=batch,
        image=image, steps=steps, model=model,
        cut="features | output Dense + SoftmaxOutput",
        bitwise=bitwise, param_elements=total, param_elements_differing=differ,
        params_max_rel=_gap([params_c[n] for n in names],
                            [params_s[n] for n in names]),
        first_outputs_max_abs=float((first_c - first_s).abs().max()),
        last_outputs_max_abs=float((last_c - last_s).abs().max()),
        chain_ms_median=_median([t for t, _ in rec_c[warmup:]]),
        single_ms_median=_median([t for t, _ in rec_s[warmup:]]),
        chain_ms=[t for t, _ in rec_c], single_ms=[t for t, _ in rec_s],
        chain_replays=[c["graph_replays"] for _, c in rec_c],
        chain_captures=[c["graph_captures"] for _, c in rec_c],
        single_replays=[c["graph_replays"] for _, c in rec_s],
        single_captures=[c["graph_captures"] for _, c in rec_s],
        single_one_call_step=one_call)
    res["held"] = "bit for bit" if bitwise else "RESNET_PARITY_TOL"
    bad = []
    # the chain: each stage's training forward and backward are the two
    # stages of one program: 4 replays a step, 4 captures at the first
    if not one_call or any(s is not None for s in chain_one_call):
        bad.append("step path: the single Module's one-call step %s, the "
                   "chain's members' %s" % (one_call, chain_one_call))
    if res["chain_replays"][1:] != [4] * (steps - 1) \
            or res["chain_captures"] != [4] + [0] * (steps - 1) \
            or res["single_replays"][1:] != [1] * (steps - 1) \
            or res["single_captures"] != [1] + [0] * (steps - 1):
        bad.append("replays/captures a step: chain %s/%s, single %s/%s"
                   % (res["chain_replays"], res["chain_captures"],
                      res["single_replays"], res["single_captures"]))
    if not bitwise and not (
            res["first_outputs_max_abs"]
            <= RESNET_PARITY_TOL[torch.float32]["out1"]
            and res["params_max_rel"]
            <= RESNET_PARITY_TOL[torch.float64]["params1"]):
        bad.append("chain against the single Module: first outputs %.3g, "
                   "parameters %.3g" % (res["first_outputs_max_abs"],
                                        res["params_max_rel"]))
    return res, bad


def mf_parity(card, chain_of, model="resnet50_v1", image=RESNET_IMAGE,
              steps=MF_PARITY_STEPS, **model_kw):
    """``chain_of(ctx, symbols, init)`` run ``steps`` fp64 steps at batch
    RESNET_PARITY_BATCH on the card and on ``cpu()`` from one init;
    (results, faults) against RESNET_PARITY_TOL."""
    import mxnet_tpu_torch as mt
    dt = torch.float64
    symbols = mf_resnet_symbols(dt, model, **model_kw)
    init_mod = mf_single(mt.cpu(), symbols[0], RESNET_PARITY_BATCH, dt,
                         image)
    arg, aux = init_mod.get_params()
    init = ({n: a.copy() for n, a in arg.items()},
            {n: a.copy() for n, a in aux.items()})
    del init_mod
    runs = []
    for ctx in (mt.gpu(0), mt.cpu()):
        batches = [resnet_batch(ctx, RESNET_PARITY_BATCH, dt, image=image,
                                classes=model_kw.get("classes", 1000),
                                label_dtype=dt, seed=i)
                   for i in range(steps)]
        seq = chain_of(ctx, symbols, init)
        outs = []
        for b in batches:
            seq._fit_step(b)
            outs.append(seq.get_outputs()[0]._data.to("cpu", dt, copy=True))
        runs.append((outs, _host_params(seq)))
        del seq
    free_card()
    (og, pg), (oc, pc) = runs
    names = sorted(pc)
    tol = RESNET_PARITY_TOL[dt]
    res = dict(card=card, dtype="fp64", batch=RESNET_PARITY_BATCH,
               steps=steps, out1=_gap(og[:1], oc[:1]),
               out_later=_gap(og[1:], oc[1:]),
               params=_gap([pg[n] for n in names], [pc[n] for n in names]),
               tol=dict(out1=tol["out1"], out_later=tol["out2"],
                        params=tol["params2"]))
    bad = [] if res["out1"] <= tol["out1"] and res["out_later"] \
        <= tol["out2"] and res["params"] <= tol["params2"] \
        else ["fp64 card against cpu(): %s" % res]
    return res, bad


def mf_resnet_parity(card, **kw):
    """35a's fp64 parity: the body and head chain."""
    return mf_parity(card, lambda ctx, s, init: mf_chain(
        ctx, s[1], s[2], RESNET_PARITY_BATCH, torch.float64,
        kw.get("image", RESNET_IMAGE), init), **kw)


def mf_python_loss(card, **kw):
    """35b: ResNet-50's body + classifier, then a PythonLossModule with
    the reference test's softmax gradient, fp64 card against cpu()."""
    import mxnet_tpu_torch as mt

    def chain(ctx, s, init):
        loss = mt.mod.PythonLossModule(grad_func=mf_softmax_grad,
                                       context=ctx)
        return mf_chain(ctx, s[3], loss, RESNET_PARITY_BATCH, torch.float64,
                        kw.get("image", RESNET_IMAGE), init)
    return mf_parity(card, chain, **kw)


def mf_predictor(card, tmp, model="resnet50_v1", image=RESNET_IMAGE,
                 batches=MF_PREDICT_BATCHES, warmup=MF_PREDICT_WARMUP,
                 timed=MF_PREDICT_TIMED, **model_kw):
    """35c: ``Predictor.load`` of a checkpoint ``Module.save_checkpoint``
    wrote, on the card's default context, against
    ``Module.forward(is_train=False)`` on the same parameters."""
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch.io import DataBatch
    gpu = mt.gpu(0)
    whole = mf_resnet_symbols(torch.float32, model, **model_kw)[0]
    prefix = os.path.join(tmp, "predict")
    src = mf_single(gpu, whole, batches[0], torch.float32, image)
    src.save_checkpoint(prefix, 0)
    params = src.get_params()
    del src
    res, bad = {"card": card, "model": model}, []
    for b in batches:
        mod = mt.mod.Module(whole, context=gpu)
        mod.bind(*mf_descs(b, torch.float32, image), for_training=False)
        mod.set_params(*params)
        x = resnet_batch(gpu, b, torch.float32, image=image,
                         classes=model_kw.get("classes", 1000), seed=b)
        mod.forward(DataBatch(x.data, x.label), is_train=False)
        want = mod.get_outputs()[0]._data.clone()
        del mod
        pred = mt.Predictor.load(prefix, 0, {"data": x.data[0].shape})
        counts, times = [], []
        for _ in range(warmup + timed):
            torch.cuda.synchronize()
            t0, c0 = time.perf_counter(), counter_snapshot()
            out = pred.forward(data=x.data[0])[0]
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
            counts.append(counter_delta(c0))
        row = dict(batch=b, bitwise=bool(torch.equal(out._data, want)),
                   max_abs=float((out._data - want).abs().max()),
                   device=str(out._data.device),
                   captures=[c["graph_captures"] for c in counts],
                   replays=[c["graph_replays"] for c in counts],
                   ms_median=_median(times[warmup:]), ms_first=times[0])
        res["batch_%d" % b] = row
        if not row["bitwise"] or not row["device"].startswith("cuda") \
                or row["captures"] != [1] + [0] * (warmup + timed - 1) \
                or row["replays"] != [1] * (warmup + timed):
            bad.append("Predictor at batch %d: %s" % (b, row))
        del pred
        free_card()
    return res, bad


def mf_write_jpegs(tmp, encode, n=MF_JPEGS):
    """Phase 26's first ``n`` images as JPEG: a .rec/.idx, a .lst of files
    and a .rec of detection records (1-4 seeded boxes an image); returns
    {"rec", "lst", "root", "det", "boxes", "labels"}."""
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import recordio
    prefix = os.path.join(tmp, "mf")
    mt.test_utils.write_image_rec(prefix, n, seed=0, short=DATA_SHORT,
                                  quality=DATA_QUALITY, encode=encode,
                                  threads=os.cpu_count())
    root = os.path.join(tmp, "mf_files")
    os.makedirs(root, exist_ok=True)
    rng = np.random.RandomState(35)
    det = recordio.MXIndexedRecordIO(prefix + "_det.idx",
                                     prefix + "_det.rec", "w")
    labels, boxes = [], []
    with open(prefix + ".lst", "w") as lst:
        for i in range(n):
            label, img = mt.test_utils.synthetic_image(0, i, DATA_SHORT)
            buf = encode(img, DATA_QUALITY)
            with open(os.path.join(root, "%d.jpg" % i), "wb") as f:
                f.write(buf)
            lst.write("%d\t%f\t%d.jpg\n" % (i, label, i))
            k = rng.randint(1, 5)
            xy = rng.uniform(0.0, 0.6, (k, 2))
            b = np.concatenate([rng.randint(0, 20, (k, 1)), xy,
                                xy + rng.uniform(0.1, 0.4, (k, 2))], axis=1)
            b = b.astype(np.float32)
            det.write_idx(i, recordio.pack(recordio.IRHeader(
                0, b.ravel(), i, 0), buf))
            labels.append(label)
            boxes.append(b)
    det.close()
    return dict(rec=prefix + ".rec", lst=prefix + ".lst", root=root,
                det=prefix + "_det.rec", labels=labels, boxes=boxes)


def mf_imdecode_check(files, encode, n=DATA_BATCH):
    """``imdecode`` on the card over the first ``n`` JPEGs, flag 1, 0 and
    -1, each resized by the plain formula against the image before
    encoding (flag 0 against its BT.601 luma), within LIBJPEG_ERR x
    NVJPEG_MARGIN; flag -1 bit for bit flag 1; grey JPEGs: -1 one
    channel, 1 that channel three times, both bit for bit flag 0."""
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch.ops import image_nvjpeg as nj
    luma = np.array([0.299, 0.587, 0.114])
    errs = {1: [], 0: []}
    same_as_flag1 = True
    for i in range(n):
        _, img = mt.test_utils.synthetic_image(0, i, DATA_SHORT)
        with open(os.path.join(files["root"], "%d.jpg" % i), "rb") as f:
            buf = f.read()
        dec = {flag: mt.image.imdecode(buf, flag).asnumpy()
               for flag in (1, 0, -1)}
        same_as_flag1 &= np.array_equal(dec[-1], dec[1])
        grey = np.rint(img.astype(np.float64) @ luma).astype(np.uint8)
        for flag, got, want in ((1, dec[1], img),
                                (0, np.repeat(dec[0], 3, 2),
                                 np.repeat(grey[:, :, None], 3, 2))):
            a = nj.resize_rgb_chw_reference(torch.from_numpy(got),
                                            *DATA_SHAPE[1:])
            b = nj.resize_rgb_chw_reference(torch.from_numpy(want),
                                            *DATA_SHAPE[1:])
            errs[flag].append((a - b).abs() * 255)
    grey_ok = True
    for i in range(MF_GREY_JPEGS):
        _, img = mt.test_utils.synthetic_image(0, i, DATA_SHORT)
        buf = encode(np.ascontiguousarray(img[:, :, 0]), DATA_QUALITY)
        g = {flag: mt.image.imdecode(buf, flag).asnumpy()
             for flag in (1, 0, -1)}
        grey_ok &= g[0].shape[2] == 1 and np.array_equal(g[-1], g[0]) \
            and np.array_equal(g[1], np.repeat(g[0], 3, 2))
    res = {"flag1": _pixel_errors(errs[1]), "flag0_luma":
           _pixel_errors(errs[0]), "flag_minus1_equals_flag1":
           bool(same_as_flag1), "grey_jpegs_ok": bool(grey_ok),
           "images": n, "grey_images": MF_GREY_JPEGS,
           "decoded": profiler_counter(nj.DECODE_COUNTER)}
    bad = [] if same_as_flag1 and grey_ok else [
        "imdecode flags: -1 equals 1 %s, grey JPEGs %s" % (same_as_flag1,
                                                           grey_ok)]
    return res, bad


def profiler_counter(name):
    from mxnet_tpu_torch import profiler
    return profiler.counter(name)


def mf_iter_reference(records):
    """The augmenter chain of MF_ITER_AUG on the images before encoding,
    in ``records``' order, drawing from ``random.seed(MF_ITER_SEED)``:
    (n, 3, 224, 224) float32."""
    import random
    import mxnet_tpu_torch as mt
    random.seed(MF_ITER_SEED)
    augs = mt.image.CreateAugmenter(DATA_SHAPE, **MF_ITER_AUG)
    out = []
    for i in records:
        img = mt.nd.array(mt.test_utils.synthetic_image(0, i, DATA_SHORT)[1],
                          ctx=mt.cpu(), dtype=np.uint8)
        for aug in augs:
            img = aug(img)[0]
        out.append(img.asnumpy().transpose(2, 0, 1))
    return np.stack(out)


def mf_image_iter_check(files):
    """``ImageIter`` on the card's default context over the .rec and over
    the .lst of files, batch DATA_BATCH at 224 x 224 with MF_ITER_AUG:
    labels and order the written records', pixels within
    LIBJPEG_FULL_ERR x NVJPEG_MARGIN of :func:`mf_iter_reference`."""
    import random
    import mxnet_tpu_torch as mt
    res, bad = {}, []
    want = mf_iter_reference(range(len(files["labels"])))
    labels = np.float32(files["labels"])
    for kind, kw in (("rec", dict(path_imgrec=files["rec"])),
                     ("lst", dict(path_imglist=files["lst"],
                                  path_root=files["root"]))):
        random.seed(MF_ITER_SEED)
        it = mt.image.ImageIter(DATA_BATCH, DATA_SHAPE, **kw, **MF_ITER_AUG)
        t0 = time.perf_counter()
        batches = list(it)
        seconds = time.perf_counter() - t0
        got = np.concatenate([b.data[0].asnumpy() for b in batches])
        got_labels = np.concatenate([b.label[0].asnumpy() for b in batches])
        errs = [torch.from_numpy(np.abs(g - w)) for g, w in zip(got, want)]
        row = dict(batches=len(batches), images=len(got),
                   labels_equal=bool(np.array_equal(got_labels, labels)),
                   contexts=sorted({str(b.data[0].context) for b in batches}),
                   img_per_s=len(got) / seconds)
        try:
            row["pixels"] = _pixel_errors(errs, libjpeg=LIBJPEG_FULL_ERR)
        except AssertionError as e:
            bad.append("ImageIter over the %s: %s" % (kind, e))
        if not row["labels_equal"] or len(got) != len(labels):
            bad.append("ImageIter over the %s: labels or order %s" % (kind,
                                                                      row))
        res[kind] = row
    return res, bad


def mf_det_check(card, files):
    """``ImageDetIter`` over the .rec of detection records at SSD-300's
    300 x 300, batch DATA_BATCH (labels the written boxes, padded with
    -1 rows), into MultiBoxTarget and MultiBoxDetection on the card
    against cpu() (phase 31b's bars): the NMS kernel runs there."""
    import mxnet_tpu_torch as mt
    res, bad, rows = {}, [], []
    it = mt.image.ImageDetIter(DATA_BATCH, MF_DET_SHAPE,
                               path_imgrec=files["det"])
    inp = ssd300_inputs(seed=35)
    ctxs = (mt.gpu(0), mt.cpu())
    anchors = [ssd300_anchors(mt, c) for c in ctxs]
    for k, batch in enumerate(it):
        label = batch.label[0].asnumpy()
        boxes = files["boxes"][k * DATA_BATCH:(k + 1) * DATA_BATCH]
        width = max(len(b) for b in boxes)
        want = np.full((len(boxes), width, 5), -1.0, np.float32)
        for i, b in enumerate(boxes):
            want[i, :len(b)] = b
        data = batch.data[0].asnumpy()
        row = dict(labels_equal=bool(np.array_equal(label, want)),
                   data_shape=list(data.shape),
                   finite=bool(np.isfinite(data).all()))
        out = []
        for c, anc in zip(ctxs, anchors):
            lbl = mt.nd.array(label, ctx=c)
            cls_pred = mt.nd.array(inp["cls_pred"], ctx=c)
            tgt = mt.nd.contrib.MultiBoxTarget(anc, lbl, cls_pred,
                                               **SSD300_TARGET)
            det = mt.nd.contrib.MultiBoxDetection(
                mt.nd.array(inp["cls_prob"], ctx=c),
                mt.nd.array(inp["loc_pred"], ctx=c), anc, nms_topk=400,
                **SSD300_DETECT)
            out.append([t._data.cpu() for t in tgt] + [det._data.cpu()])
        g, h = out
        row.update(
            loc_target_max_abs_err=float((g[0] - h[0]).abs().max()),
            masks_classes_equal=bool(torch.equal(g[1], h[1])
                                     and torch.equal(g[2], h[2])),
            positives=int((h[2] > 0).sum()),
            detection_order_equal=bool(torch.equal(g[3][..., 0],
                                                   h[3][..., 0])),
            detection_max_abs_err=float((g[3][..., 1:] - h[3][..., 1:])
                                        .abs().max()))
        rows.append(row)
        if not (row["labels_equal"] and row["finite"]
                and row["data_shape"] == [DATA_BATCH] + list(MF_DET_SHAPE)
                and row["masks_classes_equal"]
                and row["detection_order_equal"]
                and row["loc_target_max_abs_err"] <= SSD_OP_TOL
                and row["detection_max_abs_err"] <= SSD_OP_TOL
                and row["positives"] > 0):
            bad.append("ImageDetIter batch %d: %s" % (k, row))
    res["batches"] = rows
    return res, bad


def mf_loader_check(files):
    """``ImageRecordDataset`` built on the card's default context, read
    through ``DataLoader(num_workers=2)``: its worker thread decodes on
    the card with a decoder of its own, bit for bit the main thread's
    ``imdecode`` of the same records."""
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import recordio
    from mxnet_tpu_torch.ops import image_nvjpeg as nj
    ds = mt.gluon.data.vision.ImageRecordDataset(files["rec"])
    before = profiler_counter(nj.DECODERS_COUNTER)
    loader = mt.gluon.data.DataLoader(ds, batch_size=8, num_workers=2,
                                      batchify_fn=list)
    items = [s for b in loader for s in b]
    made = profiler_counter(nj.DECODERS_COUNTER) - before
    rec = recordio.MXIndexedRecordIO(files["rec"][:-4] + ".idx",
                                     files["rec"], "r")
    same = True
    for i, (img, label) in enumerate(items):
        _, raw = recordio.unpack(rec.read_idx(i))
        same &= np.array_equal(img.asnumpy(),
                               mt.image.imdecode(raw).asnumpy()) \
            and label == files["labels"][i]
    rec.close()
    res = dict(items=len(items), decoders_made_in_workers=made,
               bitwise_main_thread=bool(same))
    bad = [] if same and made >= 1 and len(items) == len(files["labels"]) \
        else ["ImageRecordDataset through DataLoader: %s" % res]
    return res, bad


def mf_refusals():
    """Bytes that are not a JPEG, and bytes nvJPEG refuses, raise
    MXNetError("Decoding image failed: ...") on the card."""
    import mxnet_tpu_torch as mt
    res = {}
    for name, buf in (("jpeg_head_garbage", b"\xff\xd8\xff garbage"),
                      ("not_an_image", b"not an image at all")):
        try:
            mt.image.imdecode(buf)
            res[name] = "decoded"
        except mt.MXNetError as e:
            res[name] = str(e)
    bad = [k for k, v in res.items()
           if not v.startswith("Decoding image failed")]
    return res, ["refusals: %s" % {k: res[k] for k in bad}] if bad else []


def mf_decode(card, tmp):
    """35d: JPEG decoding on the card."""
    import mxnet_tpu_torch as mt
    probe = jpeg_probe()
    encode = mt._native.jpeg_encode if probe["libjpeg_build"] == "built" \
        else mt.test_utils.pil_jpeg
    files = mf_write_jpegs(tmp, encode)
    res = {"card": card, "encoder": "libjpeg" if encode is
           mt._native.jpeg_encode else "PIL", "images": MF_JPEGS}
    bad = []
    for key, fn in (("imdecode", lambda: mf_imdecode_check(files, encode)),
                    ("image_iter", lambda: mf_image_iter_check(files)),
                    ("image_det_iter", lambda: mf_det_check(card, files)),
                    ("record_dataset_loader", lambda: mf_loader_check(files)),
                    ("refusals", mf_refusals)):
        t = time.perf_counter()
        res[key], faults = fn()
        res[key + "_seconds"] = time.perf_counter() - t
        bad += ["%s: %s" % (key, f) for f in faults]
    return res, bad


def mf_state_names(card):
    """35e: a Module and a BucketingModule with a ``state_names`` entry
    bind, train one step on the card and return the JAX package's
    ``get_states()`` (``[]``: the names are kept among the parameters,
    ``mxnet_tpu/module/module.py:66-79``, ``base_module.py:280-285``)."""
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch.io import DataBatch

    def sym_gen(key):
        x = mt.sym.FullyConnected(mt.sym.Variable("data"), num_hidden=4,
                                  name="sn_fc")
        out = x + mt.sym.Variable("sn_state", shape=(8, 4))
        return (mt.sym.SoftmaxOutput(out, name="softmax"), ("data",),
                ("softmax_label",))
    gpu = mt.gpu(0)
    rng = np.random.RandomState(35)
    batch = DataBatch([mt.nd.array(rng.rand(8, 6), ctx=gpu)],
                      [mt.nd.array(rng.randint(0, 4, 8), ctx=gpu)],
                      bucket_key=6)
    res, bad = {}, []
    for kind in ("module", "bucketing"):
        if kind == "module":
            mod = mt.mod.Module(sym_gen(6)[0], context=gpu,
                                state_names=["sn_state"])
        else:
            mod = mt.mod.BucketingModule(sym_gen, default_bucket_key=6,
                                         context=gpu,
                                         state_names=["sn_state"])
        mod.bind([("data", (8, 6))], [("softmax_label", (8,))])
        mod.init_params(initializer=mt.init.Xavier(), allow_missing=True,
                        arg_params={"sn_state": mt.nd.zeros((8, 4),
                                                            ctx=gpu)})
        mod.init_optimizer(optimizer_params=(("learning_rate", 0.1),))
        mod.forward_backward(batch)
        mod.update()
        states = mod.get_states()
        mod.set_states(value=0)
        arg, _ = mod.get_params()
        out = mod.get_outputs()[0]
        res[kind] = dict(states=states, state_among_params="sn_state" in arg,
                         finite=bool(torch.isfinite(out._data).all()),
                         device=str(out._data.device))
        if states != [] or "sn_state" not in arg or not res[kind]["finite"]:
            bad.append("%s: %s" % (kind, res[kind]))
    return res, bad


def phase_module_family(card):
    """Phase 35: the Module family and the predict API (ROADMAP A.6) and
    JPEG decoding on the card (A.5): (a) ResNet-50 as a SequentialModule,
    (b) a PythonLossModule ending a chain, (c) Predictor, (d) nvJPEG's
    imdecode, ImageIter, ImageDetIter (the NMS kernel through
    MultiBoxDetection) and a record dataset in DataLoader workers, (e)
    state_names.  The hand kernels' counts are set to 0 first and read at
    the end."""
    import tempfile
    from mxnet_tpu_torch import profiler
    t0 = time.perf_counter()
    profiler.reset_counters(*mf_kernel_counts())
    res, bad = {"card": card}, []
    with tempfile.TemporaryDirectory() as tmp:
        for key, fn in (("resnet50_sequential", mf_resnet_chain),
                        ("resnet50_sequential_fp64", mf_resnet_parity),
                        ("python_loss_fp64", mf_python_loss),
                        ("predictor", lambda c: mf_predictor(c, tmp)),
                        ("decode", lambda c: mf_decode(c, tmp)),
                        ("state_names", mf_state_names)):
            t = time.perf_counter()
            res[key], faults = fn(card)
            res[key]["seconds"] = time.perf_counter() - t
            log("phase 35 %s: %s" % (key, res[key]))
            bad += ["%s: %s" % (key, f) for f in faults]
            free_card()
    res["launches"] = mf_kernel_counts()
    res["seconds"] = time.perf_counter() - t0
    from mxnet_tpu_torch.ops import nms as nm
    if res["launches"][nm.COUNTER] < 2:
        bad.append("the NMS kernel was not launched: %s" % res["launches"])
    log("phase 35 the Module family, Predictor and JPEG on %s: %s"
        % (card, res))
    if bad:
        raise AssertionError("phase 35: %s" % "; ".join(bad))
    return res



# -- phase 36: the parallel tier (ROADMAP A.8, first part) --------------------
#
# Every rank is a process on the one card, in a gloo group of
# ``test_utils.RankPool`` (NCCL refuses two ranks on one device): each
# rank's compute runs on the card, each collective through the host.  The
# ms/step read here is that of PAR_WORLD processes sharing one card, and
# says nothing of speed across cards.
PAR_WORLD = 4
PAR_STEPS = 3
PAR_SEED = 36
PAR_LR = 0.1
PAR_MOMENTUM = 0.9
# fp32 (TF32 off) sharded against the one-card step: the JAX package's own
# sharded-against-unsharded bars (tests/test_models.py:31-32, :76-80):
# logits and parameters 2e-4, the loss 1e-5.  The sums differ in order
# only: the tensor-parallel halves of each product are added by an
# all-reduce, the data blocks' gradients by another.
PAR_TOL = dict(logits=2e-4, params=2e-4, loss=1e-5)
# MoE (36d): GPT-2 small's widths, 8 experts over model 4, on 8 x 1024
# tokens, the JAX package's capacity factor; tests/test_moe.py's bars.
PAR_MOE = dict(d_model=768, d_ff=3072, experts=8, batch=8, seq=1024,
               capacity_factor=1.25)
PAR_MOE_TOL = dict(rtol=1e-4, atol=1e-5)
# The pipeline (36d): four GPT-2-width MLP blocks (x + gelu(x w1 + b1) w2,
# d 768, d_ff 3072) over pipe 4, 8 microbatches of 1024 of the LM batch's
# 8 x 1024 token rows, against the stages in sequence on the whole batch.
# Both are fp32 sums of the same terms in other orders (a weight's
# gradient sums 8192 rows, by microbatch in the pipeline, in one product
# in sequence), so each is held to an fp64 run of the stages in sequence:
# the pipeline's largest error may be PAR_PIPE_FACTOR times the
# sequential fp32 run's.  (tests/test_pipeline.py's absolute bars, rtol
# 1e-5 / atol 1e-6 and 1e-4 / 1e-5, are for 6 features and 8 rows: at
# this width the two fp32 runs part by 9.5e-6 in the output and up to
# 1.1e-3 in a gradient of magnitude in the hundreds, as measured on one
# H100.)  The factor: the two orders' error bounds are of one size; 4
# leaves room for the larger constant of either.
PAR_PIPE = dict(stages=4, micro=8, rows=8 * 1024, d_model=768, d_ff=3072)
PAR_PIPE_FACTOR = 4
PAR_CALL_TIMEOUT_S = 600
PAR_COUNTERS = ("flash_attn_fwd_launches", "flash_attn_bwd_launches",
                "collective_p2p", "collective_host_staged",
                "collective_host_staged_bytes", "program_calls")


def par_batch(vocab, batch, seq, seed=PAR_SEED):
    """The phase's token batch and labels (numpy, from ``seed``)."""
    rng = np.random.RandomState(seed)
    toks = rng.randint(0, vocab, (batch, seq + 1)).astype(np.int64)
    return toks[:, :-1], toks[:, 1:]


def par_init(cfg, device, mesh=None, seed=PAR_SEED):
    """The LM's params from ``seed`` (every rank draws the same global
    params on its device and keeps its shard)."""
    from mxnet_tpu_torch.models import transformer as tr
    dev = mesh.device if mesh is not None else torch.device(device)
    return tr.init_transformer_params(
        torch.Generator(device=dev).manual_seed(seed), cfg,
        device=None if mesh is not None else dev, mesh=mesh)


def par_reference(cfg, batch, seq, device, ref_dir, steps=PAR_STEPS):
    """The one-card steps the ranks are held to: ``make_train_step`` and
    ``make_train_step_zero1`` (captured on the card), ``steps`` each from
    the phase's init; their params (and momenta) are saved under
    ``ref_dir`` after step 1 and the last.  Returns each builder's losses
    and ms of the steps after the first (the capture)."""
    from mxnet_tpu_torch.models import transformer as tr
    tokens, labels = tr.place_batch(*par_batch(cfg.vocab, batch, seq),
                                    device=device)
    out = {}
    for builder in ("plain", "zero1"):
        params = par_init(cfg, device)
        if builder == "plain":
            step = tr.make_train_step(cfg, lr=PAR_LR, device=device)
        else:
            step, momenta = tr.make_train_step_zero1(
                cfg, params, lr=PAR_LR, momentum=PAR_MOMENTUM)
        losses, times = [], []
        for i in range(steps):
            t = time.perf_counter()
            if builder == "plain":
                params, loss = step(params, tokens, labels)
            else:
                params, momenta, loss = step(params, momenta, tokens, labels)
            losses.append(loss.item())
            times.append(1e3 * (time.perf_counter() - t))
            if i in (0, steps - 1):
                saved = {n: t.cpu() for n, t in params.items()}
                if builder == "zero1":
                    saved.update({"momentum:" + n: t.cpu()
                                  for n, t in momenta.items()})
                torch.save(saved, os.path.join(
                    ref_dir, "%s_%d.pt" % (builder, i + 1)))
        out[builder] = dict(losses=losses, ms=times[1:])
        del params, step
        if builder == "zero1":
            del momenta
        free_card_if_any()
    return out


def _par_rank(device):
    """A phase-36 rank's set-up: fp32 products without TF32."""
    if torch.device(device).type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False


def _par_reset():
    """Set this rank's phase-36 counts to 0 (just before a run)."""
    from mxnet_tpu_torch import profiler
    profiler.reset_counters(*PAR_COUNTERS)


def _par_counts():
    """This rank's phase-36 counts (just after a run)."""
    from mxnet_tpu_torch import profiler
    return {n: profiler.counter(n) for n in PAR_COUNTERS}


def _par_sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _par_gap(block, ref, mesh, spec):
    """Largest |block - this rank's block of the global ``ref``|."""
    from mxnet_tpu_torch.parallel import mesh as mm
    want = mm.shard_put(ref, mesh, spec).to(block.dtype)
    return (block.detach() - want).abs().max().item()


def _par_steps(step, state, tokens, labels, device, steps):
    """``steps`` calls of ``step`` (state: (params,) or (params, momenta)):
    the losses, each step's ms (host clock, synchronized), the counters
    the steps moved, and the final state."""
    losses, times = [], []
    _par_reset()
    for _ in range(steps):
        _par_sync(device)
        t = time.perf_counter()
        *state, loss = step(*state, tokens, labels)
        losses.append(loss.item())
        times.append(1e3 * (time.perf_counter() - t))
    return losses, times, _par_counts(), state


def par_tensor_data(config, batch, seq, device, ref_dir, steps=PAR_STEPS):
    """36a (a rank): ``make_train_step`` on ``data 2 x model 2`` from the
    phase's init, ``steps`` steps; the parameters' largest gap to the
    one-card step's after the last."""
    from mxnet_tpu_torch.models import transformer as tr
    from mxnet_tpu_torch.parallel import mesh as mm
    _par_rank(device)
    cfg = tr.TransformerLMConfig(**config)
    mesh = mm.make_mesh({"data": 2, "model": 2}, device=device)
    params = par_init(cfg, device, mesh)
    tokens, labels = tr.place_batch(*par_batch(cfg.vocab, batch, seq),
                                    mesh=mesh)
    step = tr.make_train_step(cfg, lr=PAR_LR, mesh=mesh)
    losses, times, counts, (params,) = _par_steps(
        step, (params,), tokens, labels, device, steps)
    ref = torch.load(os.path.join(ref_dir, "plain_%d.pt" % steps),
                     mmap=True)
    gap = max(_par_gap(params[n], ref[n], mesh, tr.param_spec(n, cfg, mesh))
              for n in params)
    return dict(coordinate=mesh.coordinate, losses=losses, ms=times,
                counts=counts, params_gap=gap,
                heads=params["layer0_wq"].shape[1])


def par_sequence(config, batch, seq, device, ref_dir):
    """36b (a rank): ``seq 2 x model 2``, the ring on every layer: the
    forward's logits against the one-card forward's (this rank's block),
    then one ``make_train_step`` step, its parameters against the one-card
    step's and its P2P exchanges."""
    from mxnet_tpu_torch.models import transformer as tr
    from mxnet_tpu_torch.parallel import mesh as mm
    _par_rank(device)
    cfg = tr.TransformerLMConfig(**config)
    mesh = mm.make_mesh({"seq": 2, "model": 2}, device=device)
    tokens, labels = par_batch(cfg.vocab, batch, seq)
    full = par_init(cfg, device)
    spec = mm.filter_spec(("data", "seq", None), mesh)
    with torch.no_grad():
        ref = tr.transformer_forward(
            full, torch.as_tensor(tokens, device=mesh.device), cfg)
        ref = ref[mm.block_slices(ref.shape, mesh, spec)].clone()
    params = {n: mm.shard_put(t, mesh, tr.param_spec(n, cfg, mesh))
              for n, t in full.items()}
    del full
    tok, lab = tr.place_batch(tokens, labels, mesh=mesh)
    _par_reset()
    with torch.no_grad():
        logits = tr.transformer_forward(params, tok, cfg, mesh=mesh)
    fwd_counts = _par_counts()
    logits_gap = (logits - ref).abs().max().item()
    del logits, ref
    step = tr.make_train_step(cfg, lr=PAR_LR, mesh=mesh)
    losses, times, counts, (params,) = _par_steps(
        step, (params,), tok, lab, device, 1)
    ref = torch.load(os.path.join(ref_dir, "plain_1.pt"), mmap=True)
    gap = max(_par_gap(params[n], ref[n], mesh, tr.param_spec(n, cfg, mesh))
              for n in params)
    return dict(coordinate=mesh.coordinate, logits_gap=logits_gap,
                forward_counts=fwd_counts, losses=losses, ms=times,
                counts=counts, params_gap=gap)


def par_momentum_sgd(ps, gs, ms, hyper):
    """The ZeRO-1 LM step's update (``make_train_step_zero1``), in place."""
    torch._foreach_mul_(ms, PAR_MOMENTUM)
    torch._foreach_add_(ms, gs)
    torch._foreach_sub_(ps, torch._foreach_mul(ms, PAR_LR))
    return ps, ms


def par_zero1(config, batch, seq, device, ref_dir, steps=PAR_STEPS):
    """36c (a rank): ``make_train_step_zero1`` on ``data 4``, ``steps``
    steps against the one-card step's parameters and momenta; each rank's
    momentum bytes against ``zero.state_bytes``' per-device figure; then
    the update alone on one reduced gradient (rank 0 holds it, the others
    zeros, so every sum is exact) against the replicated update, bit for
    bit."""
    from mxnet_tpu_torch.models import transformer as tr
    from mxnet_tpu_torch.parallel import mesh as mm
    from mxnet_tpu_torch.parallel import multihost, zero
    _par_rank(device)
    cfg = tr.TransformerLMConfig(**config)
    mesh = mm.make_mesh({"data": PAR_WORLD}, device=device)
    n = mesh.shape["data"]
    params = par_init(cfg, device, mesh)
    tokens, labels = tr.place_batch(*par_batch(cfg.vocab, batch, seq),
                                    mesh=mesh)
    step, momenta = tr.make_train_step_zero1(
        cfg, params, lr=PAR_LR, momentum=PAR_MOMENTUM, mesh=mesh)
    losses, times, counts, (params, momenta) = _par_steps(
        step, (params, momenta), tokens, labels, device, steps)
    sharded = {k: tuple(m.shape) != tuple(params[k].shape)
               for k, m in momenta.items()}
    ref = torch.load(os.path.join(ref_dir, "zero1_%d.pt" % steps), mmap=True)
    gap = max(_par_gap(params[k], ref[k], mesh, ()) for k in params)
    mgap = max(_par_gap(m, ref["momentum:" + k], mesh,
                        ("data",) if sharded[k] else ())
               for k, m in momenta.items())
    per_rank, whole = zero.state_bytes(
        [(tuple(p.shape), "float32", sharded[k]) for k, p in params.items()],
        n)
    held = sum(m.numel() * m.element_size() for m in momenta.values())
    # the update alone, on one reduced gradient
    gen = torch.Generator(device=mesh.device).manual_seed(PAR_SEED + 1)
    names = list(params)
    grads = [torch.randn(params[k].shape, generator=gen,
                         device=mesh.device) for k in names]
    mine = [g if multihost.rank() == 0 else torch.zeros_like(g)
            for g in grads]
    ms_full = [ref["momentum:" + k].to(mesh.device) for k in names]
    group = mesh.group("data")
    new_p, new_m = zero.sharded_update(
        par_momentum_sgd, [params[k].clone() for k in names], mine,
        [zero.sharded_state(m.clone(), group) if sharded[k] else m.clone()
         for k, m in zip(names, ms_full)], {}, group)
    ref_p, ref_m = par_momentum_sgd([params[k].clone() for k in names],
                                    grads, [m.clone() for m in ms_full], {})
    differ = sum(int((a != b).sum()) for a, b in zip(new_p, ref_p))
    differ += sum(int((a != zero.sharded_state(b, group if sharded[k]
                                               else None)).sum())
                  for k, a, b in zip(names, new_m, ref_m))
    return dict(coordinate=mesh.coordinate, losses=losses, ms=times,
                counts=counts, params_gap=gap, momenta_gap=mgap,
                momentum_bytes=held, state_bytes_per_rank=per_rank,
                state_bytes_whole=whole,
                sharded=sum(sharded.values()), weights=len(sharded),
                update_elements_differing=differ)


def par_moe(moe, device, seed=PAR_SEED):
    """36d (a rank): ``moe_ffn`` with ``moe["experts"]`` experts over
    ``model 4`` against the same params on one card: the largest gap,
    and the dropped tokens (all-zero output rows) of both."""
    from mxnet_tpu_torch.models import moe as tm
    from mxnet_tpu_torch.parallel import mesh as mm
    _par_rank(device)
    mesh = mm.make_mesh({"model": PAR_WORLD}, device=device)
    args = (moe["d_model"], moe["d_ff"], moe["experts"])
    gen = torch.Generator(device=mesh.device).manual_seed(seed)
    full = tm.init_moe_params(gen, *args, device=mesh.device)
    params = {n: mm.shard_put(t, mesh, mm.filter_spec(spec, mesh))
              for n, (_, spec) in tm.moe_param_specs(*args).items()
              for t in [full[n]]}
    x = torch.randn((moe["batch"], moe["seq"], moe["d_model"]),
                    generator=gen, device=mesh.device)
    _par_reset()
    _par_sync(device)
    t = time.perf_counter()
    with torch.no_grad():
        out = tm.moe_ffn(x, params, moe["capacity_factor"], mesh=mesh)
    _par_sync(device)
    ms = 1e3 * (time.perf_counter() - t)
    counts = _par_counts()
    with torch.no_grad():
        ref = tm.moe_ffn(x, full, moe["capacity_factor"])
    dropped = out.abs().amax(-1) == 0
    ref_dropped = ref.abs().amax(-1) == 0
    return dict(coordinate=mesh.coordinate, ms=ms, counts=counts,
                max_abs=(out - ref).abs().max().item(),
                max_ref=ref.abs().max().item(),
                within=bool(torch.allclose(out, ref, **PAR_MOE_TOL)),
                dropped=int(dropped.sum()),
                dropped_same=bool(torch.equal(dropped, ref_dropped)),
                experts_here=params["expert_w1"].shape[0])


def par_mlp_stage(p, x):
    """A GPT-2-width MLP block: x + gelu(x w1 + b1) w2."""
    import torch.nn.functional as F
    return x + F.gelu(x @ p["w1"] + p["b1"], approximate="tanh") @ p["w2"]


def _par_mlp_sequence(stacked, x, dy, dtype):
    """The MLP stages applied in sequence to ``x`` in ``dtype``: the
    output, the gradients of ``sum(out * dy)`` by stage, and ``x``'s."""
    full = {n: t.to(dtype, copy=True).requires_grad_()
            for n, t in stacked.items()}
    xr = x.to(dtype, copy=True).requires_grad_()
    h = xr
    for i in range(next(iter(stacked.values())).shape[0]):
        h = par_mlp_stage({n: t[i] for n, t in full.items()}, h)
    (h * dy.to(dtype)).sum().backward()
    return h.detach(), {n: t.grad for n, t in full.items()}, xr.grad


def par_pipeline(pipe, device, seed=PAR_SEED):
    """36d (a rank): ``pipeline_apply`` of ``pipe["stages"]`` MLP blocks
    over ``pipe``, ``pipe["micro"]`` microbatches, against the stages
    applied in sequence on the whole batch: the output, this rank's
    stage's gradients and the input's, each held to an fp64 run beside
    the fp32 sequence's own error (``PAR_PIPE_FACTOR``).  Two calls: the
    first is timed apart (a process's first ``autograd.grad`` inside a
    backward imports torch's symbolic-shape module, and each stage waits
    for the next)."""
    from mxnet_tpu_torch.parallel import mesh as mm, pipeline
    _par_rank(device)
    s, d, f = pipe["stages"], pipe["d_model"], pipe["d_ff"]
    mesh = mm.make_mesh({"pipe": s}, device=device)
    dev = mesh.device
    gen = torch.Generator(device=dev).manual_seed(seed)
    stacked = {"w1": torch.randn((s, d, f), generator=gen, device=dev)
               / math.sqrt(d),
               "b1": torch.randn((s, f), generator=gen, device=dev) * 0.1,
               "w2": torch.randn((s, f, d), generator=gen, device=dev)
               / math.sqrt(f)}
    x = torch.randn((pipe["rows"], d), generator=gen, device=dev)
    dy = torch.randn((pipe["rows"], d), generator=gen, device=dev)
    times = []
    for _ in range(2):
        block = {n: mm.shard_put(t, mesh, ("pipe",)).requires_grad_()
                 for n, t in stacked.items()}
        xb = x.clone().requires_grad_()
        _par_reset()
        _par_sync(device)
        t = time.perf_counter()
        out = pipeline.pipeline_apply(par_mlp_stage, block, xb, mesh,
                                      pipe["micro"])
        (out * dy).sum().backward()
        _par_sync(device)
        times.append(1e3 * (time.perf_counter() - t))
        counts = _par_counts()
    i = mesh.coordinate["pipe"]
    got = (out.detach(), {n: b.grad[0] for n, b in block.items()}, xb.grad)
    runs = {dt: _par_mlp_sequence(stacked, x, dy, dt)
            for dt in (torch.float32, torch.float64)}

    def errors(run):
        o, g, dx = run
        return {"out": (o.double() - runs[torch.float64][0]).abs().max()
                .item(),
                "grads": max((g[n].double() - runs[torch.float64][1][n][i])
                             .abs().max().item() for n in g),
                "dx": (dx.double() - runs[torch.float64][2]).abs().max()
                .item()}
    seq32 = runs[torch.float32]
    pipe_err = errors(got)
    seq_err = errors((seq32[0], {n: g[i] for n, g in seq32[1].items()},
                      seq32[2]))
    return dict(coordinate=mesh.coordinate, ms_first=times[0],
                ms=times[1], counts=counts, errors=pipe_err,
                sequential_fp32_errors=seq_err,
                within=all(pipe_err[k] <= PAR_PIPE_FACTOR * seq_err[k]
                           for k in pipe_err))


def par_checks(res, ref, cfg, device, steps=PAR_STEPS):
    """What phase 36 holds its runs to; the faults, as strings."""
    bad = []
    on_card = torch.device(device).type == "cuda"
    want = cfg.n_layers * steps
    for r, a in enumerate(res["tensor_data"]):
        gap = max(abs(x - y) for x, y in zip(a["losses"],
                                             ref["plain"]["losses"]))
        if gap > PAR_TOL["loss"] or a["params_gap"] > PAR_TOL["params"]:
            bad.append("36a rank %d: loss gap %.3g, params gap %.3g"
                       % (r, gap, a["params_gap"]))
        launches = (a["counts"]["flash_attn_fwd_launches"],
                    a["counts"]["flash_attn_bwd_launches"])
        if on_card and launches != (want, want):
            bad.append("36a rank %d launched %s flash kernels (forward, "
                       "backward), want %d each" % (r, launches, want))
    for r, b in enumerate(res["sequence"]):
        if b["logits_gap"] > PAR_TOL["logits"] \
                or b["params_gap"] > PAR_TOL["params"] \
                or abs(b["losses"][0] - ref["plain"]["losses"][0]) \
                > PAR_TOL["loss"]:
            bad.append("36b rank %d: logits gap %.3g, params gap %.3g, "
                       "loss %r" % (r, b["logits_gap"], b["params_gap"],
                                    b["losses"]))
        # the ring: 1 exchange a layer forward, 2 backward
        if b["counts"]["collective_p2p"] != 3 * cfg.n_layers:
            bad.append("36b rank %d: %d P2P exchanges a step, want %d"
                       % (r, b["counts"]["collective_p2p"],
                          3 * cfg.n_layers))
    for r, c in enumerate(res["zero1"]):
        gap = max(abs(x - y) for x, y in zip(c["losses"],
                                             ref["zero1"]["losses"]))
        if gap > PAR_TOL["loss"] or c["params_gap"] > PAR_TOL["params"] \
                or c["momenta_gap"] > PAR_TOL["params"]:
            bad.append("36c rank %d: loss gap %.3g, params gap %.3g, "
                       "momenta gap %.3g" % (r, gap, c["params_gap"],
                                             c["momenta_gap"]))
        if c["momentum_bytes"] != c["state_bytes_per_rank"] \
                or c["update_elements_differing"] or not c["sharded"]:
            bad.append("36c rank %d: %s" % (r, c))
        if on_card and c["counts"]["flash_attn_fwd_launches"] != want:
            bad.append("36c rank %d: %s flash launches" % (r, c["counts"]))
    for r, m in enumerate(res["moe"]):
        if not (m["within"] and m["dropped_same"]):
            bad.append("36d MoE rank %d: %s" % (r, m))
    for r, p in enumerate(res["pipeline"]):
        if not p["within"]:
            bad.append("36d pipeline rank %d: %s" % (r, p))
    return bad


def phase_parallel(card, config=GPT2_SMALL, batch=LM_BATCH, seq=LM_SEQ,
                   moe=PAR_MOE, pipe=PAR_PIPE, device="cuda"):
    """Phase 36: the parallel tier (ROADMAP A.8's first part) on
    ``PAR_WORLD`` ranks sharing the card over gloo (``RankPool``), the LM
    at ``config``'s widths (GPT-2 small), fp32 with TF32 off: (a) tensor
    and data parallel (``data 2 x model 2``, the flash kernels on each
    rank's 6 heads), 3 SGD steps against the one-card captured
    ``make_train_step``; (b) sequence parallel (``seq 2 x model 2``, the
    ring), the forward's logits and one step; (c) ZeRO-1 (``data 4``), 3
    steps of ``make_train_step_zero1`` against the one-card step, the
    momentum bytes and the update bit for bit on one reduced gradient;
    (d) MoE over ``model 4`` and the GPipe pipeline over ``pipe 4``.
    Each rank sets its counters' baseline just before its run and reports
    what they moved.  Returns the results and the flash kernels' launches
    summed over the ranks."""
    import shutil
    import tempfile
    from mxnet_tpu_torch.models import transformer as tr
    from mxnet_tpu_torch.test_utils import RankPool
    t0 = time.perf_counter()
    cfg = tr.TransformerLMConfig(**config)
    ref_dir = tempfile.mkdtemp(prefix="phase36-")
    res = {"card": card, "world": PAR_WORLD, "backend": "gloo",
           "ranks_share_one_card": torch.device(device).type == "cuda"}
    try:
        t = time.perf_counter()
        ref = par_reference(cfg, batch, seq, device, ref_dir)
        res["reference"] = dict(ref, seconds=time.perf_counter() - t)
        with RankPool(PAR_WORLD, backend="gloo", device=device,
                      timeout=PAR_CALL_TIMEOUT_S) as pool:
            for key, fn, args in (
                    ("tensor_data", par_tensor_data,
                     (config, batch, seq, device, ref_dir)),
                    ("sequence", par_sequence,
                     (config, batch, seq, device, ref_dir)),
                    ("zero1", par_zero1,
                     (config, batch, seq, device, ref_dir)),
                    ("moe", par_moe, (moe, device)),
                    ("pipeline", par_pipeline, (pipe, device))):
                t = time.perf_counter()
                res[key] = pool.run(fn, *args)
                res[key + "_seconds"] = time.perf_counter() - t
                log("phase 36 %s: %s" % (key, res[key]))
    finally:
        shutil.rmtree(ref_dir, ignore_errors=True)
    res["ms_per_step"] = {
        "tensor_data": _median([_median(a["ms"][1:] or a["ms"])
                                for a in res["tensor_data"]]),
        "zero1": _median([_median(c["ms"][1:] or c["ms"])
                          for c in res["zero1"]]),
        "one_card_plain": _median(ref["plain"]["ms"]),
        "one_card_zero1": _median(ref["zero1"]["ms"])}
    launches = tuple(sum(r["counts"][k] for part in ("tensor_data", "zero1")
                         for r in res[part])
                     for k in ("flash_attn_fwd_launches",
                               "flash_attn_bwd_launches"))
    res["flash_launches"] = launches
    res["host_staged"] = {k: [r["counts"]["collective_host_staged"]
                              for r in res[k]]
                          for k in ("tensor_data", "sequence", "zero1",
                                    "moe", "pipeline")}
    res["seconds"] = time.perf_counter() - t0
    log("phase 36 the parallel tier on %s, %d ranks sharing %s over gloo: "
        "ms/step %s (ranks sharing one card, collectives through the "
        "host); flash launches (forward, backward) %s; host-staged calls "
        "%s; %.1f s" % (card, PAR_WORLD, device, res["ms_per_step"],
                        launches, res["host_staged"], res["seconds"]))
    bad = par_checks(res, ref, cfg, device)
    if bad:
        raise AssertionError("phase 36: %s" % "; ".join(bad))
    return res, launches


def main():
    card = phase_device()
    phase_build()
    kern = phase_kernels()
    kern_bwd = phase_kernels_bwd()
    d32_timing = phase_d32_timing()
    scale_kern = phase_scale_kernel()
    launches = {dt: phase_lm(dt) for dt in DTYPE_NAME}
    for dt, seed in itertools.product((torch.float32, torch.bfloat16),
                                      PARITY_SEEDS):
        phase_parity(dt, seed)
    phase_registration()
    scale_launches = phase_mlp()
    phase_mlp_parity()
    parity, resnet_init = phase_resnet_parity()
    resnet = [phase_resnet_train(dt) for dt in (torch.float32,
                                                torch.bfloat16)]
    gluon_parity = phase_gluon_parity(resnet_init)
    gluon_parity["fused_bitwise_optimizers"] = phase_gluon_fused_bitwise()
    gluon = [phase_gluon_train(dt, r) for dt, r in zip(
        (torch.float32, torch.bfloat16), resnet)]
    captured_vs_eager = phase_capture_vs_eager(resnet_init)
    captured_vs_eager["rules"] = {
        DTYPE_NAME[dt]: phase_resnet_rules(dt)
        for dt in (torch.float32, torch.bfloat16)}
    checkpoint = phase_checkpoint(card)
    lm_train, train_launches = {}, {}
    for dt in LM_TRAIN_DTYPES:
        lm_train[dt], train_launches[dt] = phase_lm_train(dt)
    train_parity, parity_launches = {}, {}
    for dt in LM_TRAIN_PARITY_TOL:
        train_parity[dt], parity_launches[dt] = phase_lm_train_parity(dt)
    d32_parity = {dt: phase_lm_d32_parity(dt)
                  for dt in (torch.float32, torch.bfloat16)}
    pythia, pythia_launches = {}, {}
    for dt in DTYPE_NAME:
        pythia[dt], pythia_launches[dt] = phase_lm_pythia(dt)
    zoo = phase_zoo(card)
    ops = phase_op_sweep(card)
    rnn = phase_rnn(card)
    data, resize_launches = phase_data(card, gluon)
    cv2_resize = phase_cv2_resize(card)
    kvstore = phase_kvstore(card)
    long_tail = phase_long_tail(card)
    sparse = phase_sparse(card)
    executor = phase_executor_programs(card, resnet_init)
    api = phase_api_surface(card)
    api_launches = api["launches"]
    module_family = phase_module_family(card)
    parallel, par_launches = phase_parallel(card)
    from mxnet_tpu_torch.ops import attention as att
    from mxnet_tpu_torch.ops import image_nvjpeg as nj
    from mxnet_tpu_torch.ops import scale as sc
    n_layers = GPT2_SMALL["n_layers"]
    entries = []
    for dt in DTYPE_NAME:
        bound_ms, bound_by, bounds = attention_bound_ms(MAIN_SHAPE, dt, True)
        entries.append({
            "name": "flash_attn_fwd[%s]" % DTYPE_NAME[dt],
            "route": "cuda",
            "design": kern[dt]["design"],
            "source": att.KERNEL_SOURCES[kern[dt]["design"]],
            "replaces": "mxnet_tpu/ops/pallas_kernels.py:41",
            "launches": launches[dt] + train_launches[dt][0]
            + (api_launches["flash_attn_fwd_launches"] + par_launches[0]
               if dt == torch.float32 else 0),
            "inference_launches": launches[dt],
            "parallel_launches": par_launches[0]
            if dt == torch.float32 else 0,
            "api_surface_launches": api_launches["flash_attn_fwd_launches"]
            if dt == torch.float32 else 0,
            "train_launches": train_launches[dt][0],
            "train_launches_per_step": n_layers,
            "train_parity_launches": parity_launches.get(dt, (0, 0))[0],
            "max_abs_err": kern[dt]["max_abs_err"],
            "max_row_rel_err": kern[dt]["max_row_rel"],
            "ms": kern[dt]["ms"],
            "strided_ms": kern[dt]["strided_ms"],
            "plain_ms": kern[dt]["plain_ms"],
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "bounds_ms": bounds,
            "library_ms": kern[dt]["library_ms"],
            "shape": list(MAIN_SHAPE),
            "causal": True,
        })
    for dt in DTYPE_NAME:
        bound_ms, bound_by, bounds = attention_bwd_bound_ms(MAIN_SHAPE, dt,
                                                            True)
        entries.append({
            "name": "flash_attn_bwd[%s]" % DTYPE_NAME[dt],
            "route": "cuda",
            "design": BWD_DESIGN_NOTE[kern_bwd[dt]["design"]],
            "source": att.BACKWARD_SOURCES[kern_bwd[dt]["design"]],
            "replaces": "mxnet_tpu/ops/pallas_kernels.py:198",
            "launches": train_launches[dt][1]
            + (api_launches["flash_attn_bwd_launches"] + par_launches[1]
               if dt == torch.float32 else 0),
            "parallel_launches": par_launches[1]
            if dt == torch.float32 else 0,
            "api_surface_launches": api_launches["flash_attn_bwd_launches"]
            if dt == torch.float32 else 0,
            "train_launches_per_step": n_layers,
            "train_parity_launches": parity_launches.get(dt, (0, 0))[1],
            "max_abs_err": kern_bwd[dt]["max_abs_err"],
            "max_row_rel_err": kern_bwd[dt]["max_row_rel"],
            "ms": kern_bwd[dt]["ms"],
            "strided_ms": kern_bwd[dt]["strided_ms"],
            "plain_ms": kern_bwd[dt]["plain_ms"],
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "bounds_ms": bounds,
            "library_ms": kern_bwd[dt]["library_ms"],
            "shape": list(MAIN_SHAPE),
            "causal": True,
        })
    # D 32: the D-32 LM's launches (phase 14, and phase 13 in fp32/bf16)
    for (kind, bound_fn, replaces, sources), dt in itertools.product((
            ("fwd", attention_bound_ms, "mxnet_tpu/ops/pallas_kernels.py:41",
             att.KERNEL_SOURCES),
            ("bwd", attention_bwd_bound_ms,
             "mxnet_tpu/ops/pallas_kernels.py:198", att.BACKWARD_SOURCES)),
            DTYPE_NAME):
        i = 0 if kind == "fwd" else 1
        bound_ms, bound_by, bounds = bound_fn(D32_SHAPE, dt, True)
        design = att.design(dt, D32_SHAPE[-1])
        t = d32_timing[dt][kind]
        entries.append({
            "name": "flash_attn_%s_d32[%s]" % (kind, DTYPE_NAME[dt]),
            "route": "cuda",
            "design": design if kind == "fwd" else BWD_DESIGN_NOTE[design],
            "source": sources[design],
            "replaces": replaces,
            "replaced_design": "simt (flash_attn_%s.cu)" % kind,
            "launches": pythia_launches[dt][i]
            + d32_parity.get(dt, (0, 0))[i],
            "lm_launches": pythia_launches[dt][i],
            "parity_launches": d32_parity.get(dt, (0, 0))[i],
            "max_abs_err": (kern if kind == "fwd" else kern_bwd)[dt][
                "by_dim"][D32_SHAPE[-1]][0],
            "ms": t["ms"],
            "strided_ms": t["strided_ms"],
            "plain_ms": t["plain_ms"],
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "bounds_ms": bounds,
            "library_ms": t["library_ms"],
            "shape": list(D32_SHAPE),
            "causal": True,
        })
    for dt in (torch.float32, torch.bfloat16):
        bound_ms, bound_by = scale_bound_ms(math.prod(SCALE_MAIN_SHAPE), dt)
        entries.append({
            "name": "scale[%s]" % DTYPE_NAME[dt],
            "route": "cuda",
            "design": "simt, one 16-byte vector a thread, blocks of 1024",
            "source": sc.KERNEL_SOURCE,
            "replaces": "tests/test_pallas_register.py:25",
            "launches": scale_launches[dt]
            + (api_launches["scale_launches"] if dt == torch.float32 else 0),
            "kvstore_mlp_launches": kvstore["two_devices"][
                "module_device"]["scale_launches"]
            + kvstore["two_devices"]["module_local"]["scale_launches"]
            if dt == torch.float32 else 0,
            "api_surface_launches": api_launches["scale_launches"]
            if dt == torch.float32 else 0,
            "max_abs_err": scale_kern[dt]["max_abs_err"],
            "ms": scale_kern[dt]["ms"],
            "plain_ms": scale_kern[dt]["plain_ms"],
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "library_ms": scale_kern[dt]["library_ms"],
            "shape": list(SCALE_MAIN_SHAPE),
        })
    rk = data["resize_kernel"]
    entries.append({
        "name": "resize_rgb_chw[fp32]",
        "route": "cuda",
        "design": "simt, one launch a round over every image it decoded "
                  "(grid y an image, from a table of ragged sources; failed "
                  "records compacted, the data's tail blank); a thread 4 "
                  "pixels of a row in every channel, 16-byte stores; "
                  "nvJPEG's RGB in, the mean and the scale in the kernel",
        "source": nj.KERNEL_SOURCE,
        "replaces": "native/image_loader.cc:86 (host C++ resize_to_chw; "
                    "no Pallas kernel)",
        "launches": resize_launches,
        "loader_rounds": data["loader_rounds"],
        "max_abs_err": rk["max_abs_err"],
        "ms": rk["ms"],
        "ms_per_image": rk["ms_per_image"],
        "single_image_ms": rk["single_image_ms"],
        "plain_ms": rk["plain_ms"],
        "bound_ms": rk["bound_ms"],
        "bound_by": rk["bound_by"],
        "library_ms": rk["library_ms"],
        "shape": rk["shape"],
    })
    nk = long_tail["nms_kernel"]["ssd300 nms_topk -1"]
    from mxnet_tpu_torch.ops import nms as nm
    entries.append({
        "name": "nms[fp32]",
        "route": "cuda",
        "design": "two launches: suppression bits over 64-box tiles "
                  "across the card (a block of 64 a row tile and two column "
                  "tiles of the upper triangle, columns by class bucket); "
                  "then a block of 1024 an image walks one barrier a tile "
                  "(one warp resolves a tile in rounds, 31 OR the kept rows "
                  "on from words loaded a step ahead)",
        "source": nm.KERNEL_SOURCE,
        "replaces": "mxnet_tpu/ops/ssd.py:237, mxnet_tpu/ops/rcnn.py:91 "
                    "(lax.fori_loop; no Pallas kernel)",
        "launches": long_tail["nms_launches"]
        + module_family["launches"][nm.COUNTER],
        "long_tail_launches": long_tail["nms_launches"],
        "module_family_launches": module_family["launches"][nm.COUNTER],
        "max_abs_err": float(nk["masks_differ"]),
        "ms": nk["ms"],
        "plain_ms": nk["plain_ms"],
        "bound_ms": nk["bound_ms"],
        "bound_by": nk["bound_by"],
        "library_ms": None,
        "shape": nk["shape"],
        "walk_steps": nk["walk_steps"],
        "other_shapes": {k: {f: v[f] for f in ("ms", "plain_ms", "bound_ms",
                                               "bound_by", "shape")}
                         for k, v in long_tail["nms_kernel"].items()
                         if "ms" in v and k != "ssd300 nms_topk -1"},
    })
    from mxnet_tpu_torch.ops import sparse_dot as sd
    for kind, design in (
            ("csr_dot", "simt (redesigned, PR 21): at N up to 4 16 lanes a "
             "row and a lane an entry, so a row's index, value and B loads "
             "are all in flight, the products then added in stored order "
             "by shuffles (a longer row in chunks of 16 with the carry); "
             "wider N a lane an output column, 8 gathers in flight; "
             "products and sums rounded apart; nnz read on the card"),
            ("csr_t_dot", "simt, a warp a tile of 32 column-sorted "
             "entries, each run of a column summed in row order; a second "
             "kernel adds a run's partial sums over the tiles it crosses "
             "in tile order; the output zeroed first; one call with the "
             "transposition, whose time ms includes"),
            ("csr_transpose", "one call: a warp a row (rows, sort keys), "
             "then a stable LSD radix sort by column, digits of up to 10 "
             "bits (2 passes at 1,000,001 columns), a histogram, a "
             "prefix over the blocks and a match_any scatter a pass, 2048 "
             "entries a block; held to the gradient's bound")):
        t = sparse["kernels"]["timing"][kind]
        launches = sum(sparse[run]["counts"][sd.COUNTERS[kind]]
                       for run in ("linear", "linear_kv"))
        api_csr = api_launches[sd.COUNTERS[kind]]
        entries.append({
            "name": "%s[fp32]" % kind,
            "route": "cuda",
            "design": design,
            "source": sd.KERNEL_SOURCE,
            "replaces": "mxnet_tpu/ops/matrix.py:189 (jnp.tensordot on a "
                        "CSR's dense backing; no Pallas kernel)",
            "launches": launches + api_csr,
            "api_surface_launches": api_csr,
            "max_abs_err": t["max_abs_err"],
            "ms": t["ms"],
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
            "shape": t["shape"],
            "nnz": t["nnz"],
            "launch_floor_ms": t["launch_floor_ms"],
            **{k: t[k] for k in ("device_ms", "device_ops",
                                 "plain_device_ms") if k in t},
            **({"fm_shapes": sparse["kernels"]["timing"]["csr_dot_fm"]}
               if kind == "csr_dot" else {}),
        })
    log(card)
    print(json.dumps({"resnet50": {
        "card": card, "parity": parity, "train": resnet,
        "gluon_parity": gluon_parity, "gluon_train": gluon,
        "captured_vs_eager": {k: captured_vs_eager[k]
                              for k in ("fused", "shared_block",
                                        "resnet_fp64", "rules")}}}))
    print(json.dumps({"lm_train": {
        "card": card, "batch": LM_BATCH, "seq": LM_SEQ,
        "train": {DTYPE_NAME[dt]: r for dt, r in lm_train.items()},
        "parity": {DTYPE_NAME[dt]: r for dt, r in train_parity.items()},
        "captured_vs_eager": captured_vs_eager["lm"]}}))
    print(json.dumps({"lm_d32": {
        "card": card, "config": PYTHIA_31M, "batch": PYTHIA_BATCH,
        "seq": PYTHIA_SEQ,
        "runs": {DTYPE_NAME[dt]: r for dt, r in pythia.items()}}}))
    print(json.dumps({"checkpoint": checkpoint}))
    print(json.dumps({"zoo": zoo}))
    print(json.dumps({"ops": ops}))
    print(json.dumps({"rnn": rnn}))
    print(json.dumps({"data": data}))
    print(json.dumps({"cv2_resize": cv2_resize}))
    print(json.dumps({"kvstore": kvstore}))
    print(json.dumps({"long_tail": long_tail}))
    print(json.dumps({"sparse": {k: v for k, v in sparse.items()
                                 if k != "kernels"},
                      "sparse_kernels": {k: v for k, v in
                                         sparse["kernels"].items()
                                         if k != "checks"}}))
    print(json.dumps({"executor": executor}))
    print(json.dumps({"api_surface": api}))
    print(json.dumps({"module_family": module_family}))
    print(json.dumps({"parallel": parallel}))
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
