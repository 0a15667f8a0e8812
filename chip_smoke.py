#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (mxnet_tpu_torch) on one NVIDIA GPU and
check it end to end. Run from the root of a checkout:

    python3 chip_smoke.py

Phases, each printing one line of its own (any failure exits non-zero;
every phase line carries ``at_s``, the script's wall seconds when it
was printed):

1. environment: torch/CUDA versions, the card's name and power limit
   (``nvidia-smi``), and the NVRTC and driver versions ``rtc`` compiles
   with and loads into; TF32 off for matmuls and cuDNN, so fp32 stays
   fp32;
2. build: every kernel of the served, training and detection paths,
   compiled with nvcc from the sources in this checkout, and the host
   image codec with the host C++ compiler (one build per source, all
   started together);
3. kernels: each kernel's wrapper against its plain PyTorch version on
   the card, at the shapes the main path gives it (the one-row decode
   kernel on decode ticks and 32- and 64-row prefill chunks; the
   multi-query verify kernel on ragged speculative ticks, with GQA, and
   at W=1 against the one-row kernel; the flash-attention and NMS
   kernels as set out below), with CUDA-event times of the
   kernel, the plain version and a PyTorch library call doing the same
   function (``library_ms``, a yardstick the port never calls);
4. serve: ``DecodeEngine`` at the full width of the decode bench model
   (``TinyDecoder(vocab_size=1024, num_layers=4, num_heads=8,
   head_dim=64)``, 16 slots, max_seq_len 1152, prefill ladder 8/16/32,
   prefix cache on) answers 32 requests, some sharing a 32-token system
   prompt; every output must equal the port's no-cache oracle on the
   card, and every kernel of the path must have launched. The engine
   serves from CUDA graphs captured at ``warmup()`` (the decode tick,
   each prefill and chunk rung, the CoW copy): the phase fails unless
   ``steady_state_recompiles`` is 0 and the traffic ran graph replays,
   whose kernel launches the engine counts from each graph's capture; a
   traced wave (``tick_profile``) holds those counts against the kernels
   the profiler saw and reads the device's busy share and the host's
   launches per tick. spec_serve and chunked_serve are held to the same;
5. spec_serve: the decode bench's speculative phase (the JAX package's
   bench.py, BENCH_DECODE): 32 repetitive-motif prompts, 48 tokens each,
   buckets 8/16, served with speculation off, with k=4 and the
   accept-all ``model`` draft, and with k=4 and ``prompt_lookup``; all
   three must give identical outputs equal to the oracle, accept-all
   must commit more than one token per slot-tick, and the verify kernel
   must launch at least once per verify tick and layer;
6. chunked_serve: the bench's shared-prefix phase with chunked prefill:
   96 requests over 8 system prompts of 512 tokens, ``prefill_chunk=64``,
   buckets 16/32, prefix cache on, 16 output tokens; outputs must equal
   the oracle and prefill must have run in chunks;
7. train: the training slice's main path, the port's
   ``example/transformer/train_gpt.py`` at its defaults (dim 64, 4 heads,
   2 layers, batch 32, Adam 3e-3, 3 epochs x 64 steps) on the card: it
   must learn (test perplexity below 0.2 x 128, the example's own bar)
   and the flash-attention kernel must launch at least steps x layers
   times; steps/s, tokens/s and the perplexities are printed;
8. train_parity: one training step of the full-width GPT from the same
   weights, run twice, first through the kernel, then with the
   registered op's fcompute swapped for the plain version: losses and
   gradients must agree;
9. train_profile: torch.profiler device time of 10 training steps.

10. ssd_train: the detection slice's main path, the port's
    ``example/ssd/train_ssd.py`` at its defaults (3 epochs x 8 batches of
    8 images, side 64, 3 classes, SGD 0.01 with momentum 0.9 and wd 5e-4)
    through the symbolic Module API on the card: the last epoch's loss
    must be below the first's (the example's own criterion), and the NMS
    kernel must launch at least once per forward pass (24 training steps
    and one inference pass); the losses, img/s and the detections on
    image 0 are printed;
11. ssd_parity: one forward and backward of the full-size SSD from the
    same weights on the same batch, run twice, first through the kernel,
    then with the detection ops' NMS swapped for the plain version: the
    detection outputs must be equal, cls_prob, loc_loss and the
    gradients must agree within 1e-4;
12. ssd_profile: torch.profiler device time of 5 SSD training steps.

13. rtc_check: the extension slice's kernel route, ``rtc.CudaModule``
    (NVRTC to a CUBIN for the card, launched with ``cuLaunchKernel``): the
    runtime-compilation spec in CUDA-C (``example/rtc_spec.py``: axpy,
    axpy with by-value scalars over a grid, rows scaled by blockIdx, two
    outputs, a template exported as ``fwd<float>`` and ``fwd<__half>``,
    64 KiB of dynamic shared memory), each against its plain version;
    then source that does not compile, a kernel not exported, a bad
    signature, a wrong argument count, a grid of 0, a CPU array, a wrong
    output dtype and a block of 2048 threads must each raise MXNetError;
14. custom_softmax: the port's ``example/numpy_ops/custom_softmax.py``
    (a gluon MLP trained through a numpy CustomOp) at its defaults on the
    card: it must print LEARNED (test accuracy above 0.9);
15. custom_rtc: the slice's main path, ``custom_softmax_rtc.py``: a
    symbolic MLP ending in ``sym.Custom`` whose forward (row softmax) and
    backward ((prob - onehot) / n) are CUDA-C kernels launched through
    ``rtc.CudaModule``, trained by ``Module.fit`` (2 epochs, ``acc``,
    ``Speedometer``) on the module plane (``trainplane.module_plane``:
    one CUDA graph a step, the rtc kernels inside it; one capture, a
    graph step a batch, no optimizer dispatch, no demotion), then
    ``score`` and ``predict``; the same graph with the numpy op from the
    same seed must demote (``module-trace: MXNetError``: it reads back
    to the host) and agree within 1e-5 after the first batch, both must
    reach accuracy above 0.9, and the rtc kernels must launch at least
    2 x training batches + test batches times, graph replays counted
    (the launches a capture recorded, added at each replay); the
    launches counted over RTC_TRACE_STEPS plane steps must equal the
    profiler's; the rtc op's eager step (``MXNET_TRAINSTEP=0``) is timed
    beside the graph step;
    module_plane_parity: a LeNet-style symbolic net with BatchNorm
    (batch 64): 10 module-plane steps against 10 eager
    ``forward_backward`` + ``update`` steps from the same weights, with
    cuDNN's deterministic algorithms: weights, momentum and moving
    statistics bit for bit (PLANE_TOL at most), one capture; the same
    with cuDNN's default algorithms, and two eager runs, printed beside;
16. rtc_time: the softmax-forward kernel through ``Kernel.launch`` at
    (64, 10) and (8192, 1024): host and device time, bound, plain version
    and ``torch.softmax`` (host and device time; at (64, 10) also its
    device time replayed inside a CUDA graph, as the module plane runs the
    kernel).

17. fused_apply: the fused optimizer apply (``fastpath``) on resnet50_v1's
    193 trainable parameters (25.58 M values) with random gradients, SGD
    (momentum 0.9, wd 1e-4) and Adam: two fused applies must equal two
    passes of the per-parameter loop (what ``MXNET_FASTPATH=0`` runs) bit
    for bit; each path's device kernels and device ms an apply
    (profiler) and host ms an apply;
18. resnet_parity: the slice's main path, the JAX package's bench.py
    training headline (resnet50_v1, batch 32, 224 x 224, 1000 classes,
    SGD 0.05 with momentum 0.9, data from RandomState(0)): one step of
    ``parallel.TrainStep`` captured as a CUDA graph against the same step
    run eagerly (``capture=False``) from the same weights: the loss, every
    weight, the momentum states and the BatchNorm moving statistics
    within 1e-4; then ``InferStep``'s captured output against the net's
    eager inference forward; it counts the step's FLOPs
    (``torch.utils.flop_counter``);
19. resnet_train: ``TrainStep.multi_call`` at K = 16 (bench.py's
    configuration): a warm call (the capture), then calls for 5 s; img/s,
    ms a step, ``compile_count`` (1) and ``steady_state_recompiles`` (0),
    graph replays, each call's mean loss (all finite, the last below the
    first), peak device memory and the step's fp32 bound (its FLOPs over
    67 TFLOP/s); then ``InferStep.multi_call`` at K = 16 (img/s);
20. resnet_profile: torch.profiler over 5 steps of the eager path
    (``autograd.record``, ``backward``, ``Trainer.step`` through the fused
    apply), of the captured ``TrainStep``, and of the captured
    ``TrainStep`` of the net cast to bfloat16: wall and device-busy ms a
    step, busy share, device operations and host launches a step, the top
    device operations;
21. resnet_bf16_parity: the same net cast to bfloat16 (``Block.cast``):
    one captured bf16 ``TrainStep`` step against the same step run
    eagerly from the same weights (loss, every weight, momentum and BN
    statistic within BF16_RTOL of the tensor's largest magnitude), then
    one step of ``trainplane.TrainPlane`` under ``MXNET_TRAIN_DTYPE=bf16``
    on its graph plane against the same step on its eager plane
    (``MXNET_TRAINSTEP=0``): per-sample losses, weights and the float32
    masters, the same tolerance;
22. resnet_bf16_train: bench.py's ``train_bf16``, ``TrainStep.multi_call``
    of the bf16 net at K = 16, batch 32, timed as resnet_train and held to
    the same checks: ms a step, img/s, the share of the step's bf16 bound
    (its FLOPs over 989 TFLOP/s), peak memory; then
    resnet_bf16_infer: ``InferStep.multi_call`` in bf16 (img/s);
23. resnet_percall: bench.py's ``train_percall`` and
    ``infer_fp32_percall``, ``TrainStep.__call__`` and
    ``InferStep.__call__`` at batch 32, fp32 (img/s);
24. resnet_fused_opt: bench.py's ``train_fused_opt``, the hybridized net
    under the eager record / backward / ``Trainer.step`` loop at batch 32:
    img/s and ``OPT_DISPATCHES`` a step (exactly one fused dispatch a
    step, or the phase fails);
25. train_plane_bf16: bench.py's ``mfu_train_bf16``, ``TrainPlane`` under
    ``MXNET_TRAIN_DTYPE=bf16`` (fp32 master weights) at batches 32, 64,
    128 and 256: img/s, the share of the bf16 bound (22.91 GFLOP an image,
    counted in resnet_parity, at 989 TFLOP/s) and peak memory a batch;
    bench's gate fails the run unless the plane is ``graph``, the timed
    window counts exactly one ``STEP_DISPATCHES{plane="graph"}`` a step
    and no ``OPT_DISPATCHES``, no demotion was counted, the weights are
    bf16 and the masters fp32;
26. remat_memory: ``TrainStep(remat=False)`` and ``TrainStep(remat=True)``
    on the same fp32 net and batch: ``memory_analysis()``'s
    ``temp_size_in_bytes`` of each (the step's peak above what was
    resident, measured in the eager pass before the capture) and their
    losses, which must agree within RESNET_TOL.

27. zoo_score: ``benchmark_score.py``'s networks (alexnet, vgg16,
    squeezenet1_0, densenet121, inception_v3 at 299 x 299, mobilenet1_0,
    mobilenet_v2_1_0, resnet152_v1) in fp32 at batches 32 and 1, and the
    script's default sweep in bf16 at batch 32: img/s of the eager
    hybridized forward (the script's build and timed loop) and of
    ``parallel.InferStep``, whose output must agree with the eager one
    (fp32: ZOO_TOL of the largest logit's magnitude, at least 1; bf16:
    one bf16 step), GFLOP an image (``torch.utils.flop_counter``), the
    share of the fp32 or bf16 bound, peak memory, and at fp32 batch 32
    the top device operations of one InferStep call.

28. ckpt_resnet: bench.py's resnet50_v1 (batch 32, 224 x 224, SGD 0.05
    with momentum 0.9, RandomState(0) data) through ``TrainPlane``, in
    fp32 and in bf16 mode with float32 masters, with cuDNN's deterministic
    algorithms: 3 steps, ``save_parameters`` and ``Trainer.save_states``,
    3 more steps (run A); a fresh net of other weights and a fresh Trainer
    load both files and take the same 3 steps (run B); the live net and
    Trainer of A load them again and take the 3 steps once more, through
    the graph A captured (no new capture, the same addresses). B and the
    rewind must equal A bit for bit (losses, weights, moving statistics,
    momentum, masters); bytes, save and load seconds and MB/s are printed;
29. ckpt_module_rtc: the custom_rtc path (the rtc kernels inside the
    module plane's graph) at its defaults: one epoch with
    ``callback.module_checkpoint(..., save_optimizer_states=True)``, then
    ``Module.load(prefix, 1, load_optimizer_states=True)`` and
    ``fit(begin_epoch=1, num_epoch=2)``: weights and momentum bit for bit
    those of an uninterrupted 2-epoch fit (deterministic cuDNN), one
    capture, two rtc launches a replay, counted and seen by the profiler
    alike;
30. ckpt_ssd: ssd_train's module checkpointed after its last epoch by
    ``callback.do_checkpoint``; ``mx.load_checkpoint`` of that epoch
    into a new Module bound for inference, whose ``predict`` over the
    dataset must equal the trained module's bit for bit, the detections
    through the NMS kernel included.

31. rnn_op_check: the word language model slice's ``RNN`` op on the
    card, cuDNN (through ``torch._VF``) against its plain version (the
    step loop of the JAX op's arithmetic, MXNet's gate order) on the card:
    ``lstm``, ``gru``, ``rnn_tanh`` and ``rnn_relu``, 2 layers,
    unidirectional and bidirectional, (T, N, C) = (35, 32, 650), hidden
    650; the outputs, the final states and the gradients of the data, the
    flat parameters and the initial states, each within RNN_OP_TOL of the
    tensor's largest magnitude (at least 1; rnn_relu's gradients in
    float64, RNN_OP_TOL_F64); device and CUDA-event ms of a forward and
    backward of each path at the unidirectional LSTM case, and of
    ``torch.nn.LSTM`` with its weights flattened (cuDNN without the op's
    copy of its weight views), beside the bound of its matmuls;
32. word_lm_parity: the port's word LM (``example/gluon/
    word_language_model/train.py``: width 650, 2 layers, tied, dropout 0,
    vocabulary 2,000) from the same weights, 3 of the example's own
    training steps on the card and on the CPU: losses, the gradient norms
    ``clip_global_norm`` returns and every final weight within
    WORD_LM_TOL;
33. word_lm: upstream MXNet's "medium" PTB command (``--tied --nhid 650
    --emsize 650 --dropout 0.5``; lr 20, clip 0.25, batch 32, bptt 35, 2
    layers) through the example's ``run`` on a synthetic Zipf corpus of
    400,000 tokens at PTB's vocabulary of 10,000, 2 epochs: validation
    perplexity must fall from epoch 1 to epoch 2 and stay below 10,000;
    tokens/s, ms a step and peak memory; then torch.profiler over 10 more
    steps: busy share, host launches a step and the top device operations;
34. word_lm_example: ``python3 mxnet_tpu_torch/example/gluon/
    word_language_model/train.py`` at its defaults, on the card, as a user
    runs it: it must exit 0;
35. nd_ops_card: every name of the port's ``ops/tensor.py`` and
    ``ops/random_ops.py``, the ``Sequence*`` ops, ``_rnn_param_concat``
    and ``RNN`` on the card, at the small shapes of the CPU sweep
    (``tests/torch_op_cases.py``), against the same op in the port on the
    CPU: forward and gradients in float32 (ND_OPS_TOL; the RNN op, cuDNN
    against the loop, RNN_OP_TOL of each tensor's largest magnitude),
    int32 wherever the JAX op takes it (exact); the samplers by their
    moments at 10,000 draws and by replay after ``mx.random.set_state``;
    the count of ops checked.

36. mnist_parity: the MNIST slice (BASELINE workload 1), 5 steps of the
    example's Module (mlp, SGD 0.05 with momentum 0.9 and wd 1e-4, He
    init) through a ``KVStoreLocal`` with ``update_on_kvstore`` on the
    card against the same on the CPU, from the same seed and batches:
    outputs, weights and the store's momentum within MNIST_TOL;
37. mnist: ``example/image_classification/train_mnist.py`` at its
    defaults on the card (mlp, 60,000 synthetic examples, 2 epochs,
    batch 64: 1,876 steps through ``common/fit.py``'s ``Module.fit`` with
    a ``local`` KVStore object): validation accuracy of each epoch (the
    last at least MNIST_ACC), img/s and ms a step, exactly one
    ``module-config`` demotion and kvstore push and pull counts of steps
    x 6 keys; torch.profiler over 10 more steps (busy share, device
    operations, host launches, top device operations);
38. mnist_plane: the same net, data and schedule through ``Module.fit(
    kvstore="local")`` (one device: no store), every step on the module
    plane (graph steps = steps), img/s beside mnist's, and a trace;
39. mnist_lenet: ``--network lenet``, 1 epoch: img/s and accuracy;
40. mnist_idx: the synthetic set written as MNIST idx files, plain and
    ``.gz``; ``MNISTIter``'s batches against the arrays written, then
    one epoch of the example reading the ``.gz`` files;
41. mnist_options: ``--monitor 50`` (2 rows of ``softmax_output`` over
    100 batches), ``--gc-type 2bit``, ``--model-prefix`` then
    ``--load-epoch 1`` (the resumed run's first batch equals the
    uninterrupted run's second epoch's first, by the monitor's
    statistic), ``--test-io 1`` (no training);
42. optimizers_card: each of the 17 optimizers (RMSProp plain and
    centered): 3 updates on the card against the CPU (SGLD, whose noise
    is each device's draw, excepted), fused against per-parameter bit
    for bit, bf16 under ``multi_precision`` (weights the float32 masters
    cast back), a captured ``TrainStep`` against eager ``Trainer`` steps
    where the class has ``pure_step``; the 12 update ops on the card
    against the CPU; then ``train_mnist --optimizer <name>`` on 6,000
    examples, 1 epoch: finite weights that moved, and for sgd the
    accuracy bar.

43. sparse_lc: slice 18's sparse path, ``example/sparse/
    linear_classification.py`` at its defaults (2,000 features, 512
    samples, batch 64, 12 epochs; ``LibSVMIter``'s CSR batches and
    ``sparse.dot``): ``IMPROVED``; 3 steps on the card against the CPU
    (losses, w, b within TAIL_TOL); a trace of TAIL_TRACE_STEPS steps
    (busy share, device operations, host launches);
44. sparse_lc_avazu: the same example on an Avazu-shaped LibSVM file the
    phase writes from a planted separator (seed 0; AVAZU: 1,000,000
    features, 15 values a row, 65,536 rows) at ``--feature-dim 1000000
    --batch-size 8192 --epochs 2``, as MXNet 1.3 runs Avazu: ms a step,
    samples/s, a trace, and the phase's peak ``max_memory_allocated``,
    which must stay under 1 GiB (a batch made dense would take 32.8 GB);
    3 steps card against CPU;
45. sparse_fm: ``example/sparse/fm.py`` with SGD (FM_SGD_ARGS: at the
    defaults SGD diverges in both packages) and with AdaGrad at its
    defaults: ``IMPROVED`` both; 3 steps card against CPU each (the loss a
    sample and the weights; SGD within TAIL_TOL, AdaGrad FM_ADAGRAD_TOL);
    a trace;
46. ctc_ocr: ``example/ctc/lstm_ocr.py`` at its defaults (6 epochs, batch
    64, 4,096 examples; cuDNN's bidirectional LSTM and the CTC op's
    recursion): ``ocr LEARNED``; one step card against CPU (loss within
    TAIL_TOL, weights TAIL_GRAD_TOL); the CTC op against ``F.ctc_loss``
    (a yardstick the port does not call) on feasible labels at CTC_SHAPE,
    losses, gradients and both times; a trace;
47. svm_mnist: ``example/svm_mnist/svm_mnist.py`` at its defaults:
    ``svm heads ALL LEARNED``; a trace of the L2-SVM head's step;
48. ops_tail_card: every name slice 18 registers (``ops/linalg.py``,
    ``ops/misc_tail.py``, ``ops/sparse.py``, the new ``nn`` names), at
    the CPU sweep's cases (``tests/torch_tail_cases.py``), forward and
    gradients on the card against the port on the CPU (TAIL_TOL,
    gradients TAIL_GRAD_TOL, integers exactly; ``syevd`` and ``gelqf``
    through sign-invariant forms), PNG decoding, the sparse ex path
    (``dot`` with its gradient, ``cast_storage``, ``retain``,
    ``_square_sum``, row_sparse add/sub, the scatter ops,
    ``row_sparse_pull``), one Module SGD step of a small NHWC
    Convolution/Pooling/Deconvolution net on the card against the CPU,
    and that net's ms a step in NHWC and NCHW.

49. gluon_resnet: BASELINE workload 2, the port's
    ``example/gluon/train_resnet.py`` at its defaults (resnet50_v1, batch
    32, 224 x 224, 1000 classes, SGD 0.05 with momentum 0.9 and wd 1e-4,
    one captured ``TrainStep``) for GLUON_RESNET_BATCHES batches: ms a
    step with its spread and img/s beside PERF.md's TrainStep figure,
    one capture; its ``--save-prefix`` export (file sizes, seconds); the
    export's ``SymbolBlock.imports`` on the card against the trained
    net's inference output on one batch (GLUON_EXPORT_TOL of the largest
    magnitude); a trace of the script's loop body (busy share, host
    launches and copies a step);
50. gluon_export_cross: a small Conv/BatchNorm/Dense net exported on the
    card: the files imported on the card give the net's output and the
    CPU import's, the ``.params`` split ``arg:``/``aux:``;
51. gluon_loader: an ImageFolderDataset of GLUON_LOADER_IMAGES PNGs the
    phase writes, through RandomResizedCrop(224), a flip, ToTensor and
    Normalize, ``DataLoader`` batches of 32 pinned: img/s with 0 and 4
    worker threads (and with no worker on one torch thread), each
    stage's ms, then resnet50_v1's captured step fed by the loader (0
    and 4 workers) and by ``NDArrayIter`` (img/s, busy share); a
    measurement, not a bar; then Resize, CenterCrop and
    RandomResizedCrop on one decoded image on the card against the host
    (GLUON_TRANSFORM_TOL of the largest magnitude, the output on the
    card, ms an image on each);
52. gluon_dcgan: ``example/gluon/dcgan.py`` at its defaults (it checks
    its own adversarial mechanics), its first epoch on the CPU from the
    same seed: each player's first step within GLUON_EXAMPLE_TOL;
53. gluon_style: ``example/gluon/neural_style.py`` at its defaults
    (IMPROVED), the CPU run's first GLUON_STYLE_STEPS losses within
    GLUON_EXAMPLE_TOL;
54. gluon_contrib: the nine conv-RNN cells and ``LSTMPCell`` unrolled 3
    steps, card against CPU (GLUON_CONTRIB_TOL forward,
    GLUON_CONTRIB_GRAD_TOL gradients), and the 8 new initializers, card
    against CPU exactly. Each line carries the card's ``nvidia-smi``
    name and power limit.

55. bucketing_lstm: the port's ``example/rnn/bucketing_lstm.py`` at its
    defaults (20 epochs over 40 batches of 16 in buckets 8/16/24, an
    LSTM of 32 on cuDNN, SGD 0.5 with momentum 0.9): it must improve,
    bind 3 buckets, and every parameter's argument, gradient and
    auxiliary arrays must be one memory across the buckets' executors;
    seq/s, ms a batch, and a trace of GRAPH_TRACE_BATCHES batches
    (device operations and host launches a batch, busy share);
56. bucketing_wide: the same model at the word LM's medium widths
    (BUCKETING_WIDE: hidden 650, embed 650, batch 32): one batch a
    bucket on the card against the CPU from the same weights, outputs
    and weights within BUCKETING_TOL of each tensor's largest magnitude;
    the same readings;
57. sequential_module: a two-module ``SequentialModule`` (the second
    taking the labels, wired to the first's output), 3 steps of forward,
    backward through the chain and update, card against CPU within
    GRAPH_TOL;
58. control_flow_card: a foreach RNN, a while_loop and a cond on each
    branch (one whose untaken branch is non-finite) forward and
    backward, card against CPU within GRAPH_TOL; then ``Module.fit``
    over a foreach + cond symbol on the module plane: one capture, a
    graph step a batch, no demotion, weights within GRAPH_PLANE_TOL of
    the eager fit's;
59. subgraph_card: an MLP partitioned into one ``_subgraph_op`` against
    the whole graph on the card, outputs and gradients (bit-equal
    expected; the largest difference printed);
60. memonger: the port's ``example/memcost/memonger.py`` at its defaults
    (depth 32, width 256, batch 2048): both findings' MB and the ratio
    (the JAX gate's verdict printed, not a bar); the scan's gradients
    with and without remat within MEMONGER_GRAD_TOL.

61. fleet_serve (run after chunked_serve): ``FleetRouter`` over
    FLEET_REPLICAS replicas of the decode bench's engine (MODEL, SLOTS,
    MAX_SEQ, PAGE; prefix cache, monolithic prefill, verify width SPEC_K
    + 1), N_REQ requests over FLEET_SYSTEMS system prompts of
    FLEET_SYS_LEN tokens with OUT_MIX (FLEET_DUPS repeat a prompt whole)
    and FLEET_SPEC_N prompt-lookup requests of the one tenant whose
    speculation cap is SPEC_K (``configure_speculation``). One engine
    serves the traffic first (the baseline); then run A (sampling off)
    and, after a rolling swap to the same weights that flushes the prefix
    indexes, run B with ``tracing`` and ``devprof`` sampling at 1.0, the
    main path whose launches the kernels line counts: both runs equal the
    one engine's outputs, B the oracle's; the fleet's prefix hit ratio
    equals the one engine's; every request of a system prompt lands on
    one replica; every trace runs submit -> ... -> complete; devprof has
    all four decode sites read by CUDA events, each timed tick's device
    ms within its host wall; kernel 2 launched >= ticks x layers and
    kernel 1 >= prefill chunks x layers; nothing recaptured. Then a
    rolling swap under load, a replica killed under load and rebuilt
    (every request answered once, ``memory_reserved`` within
    FLEET_MEM_TOL of before), ``/metrics``, ``/healthz`` and
    ``/debug/state`` over httpd, and each device path of one replica
    replayed DEVPROF_REPLAYS times under torch.profiler: a site's event
    ms at least DEVPROF_FLOOR of the profiler's kernel ms and at most the
    replays' wall. Prints tokens/s of the one engine and of the fleet at
    sampling 0 and 1.0, and ms a replica tick at each;
62. hbm_governor: a 2 GiB allocation over an allocator capped with
    ``set_per_process_memory_fraction`` raises ``torch.OutOfMemoryError``
    (``classify``: ``device``); ``oom_survival`` latches red, /healthz
    answers 503 and the latch releases after ``MXNET_HBM_RED_HOLD``
    observations; a decode soak of HBM_SOAK_N requests under chaos
    HBM_SOAK_SPEC stays oracle-exact (failed requests resubmitted with
    chaos off) with the governed admit, red seen; a ``TrainPlane`` step
    under chaos ``action=oom`` at ``jit.compile`` leaves a flight-recorder
    dump (in a temporary directory) and demotes to eager. The
    fraction is restored to 1.0 in a ``finally``.

63. block_serve (run after phase 60): the JAX package's bench.py serving
    mode (``BENCH_SERVING=1``) at its full configuration:
    ``resnet18_v1(classes=100)`` at 3 x 64 x 64 behind ``serving.Server``
    over ``serving.BlockEngine`` (one CUDA graph a bucket), buckets
    1/4/16, a 2 ms window, queue depth 4096, no request timeout; 8 client
    threads offer 1024 requests, against 150 sequential single-request
    ``engine.run`` calls. Prints req/s, the sequential req/s and the
    speedup, p50/p99 ms, batch fill, bucket counts, the device's busy
    share over a second, profiled window of the same load, and the
    sentinel's verdict of the line (``extra.device_kind`` names the
    card), and one single-request ``engine.run`` split into its lock, staging copy,
    replay and copy back, beside the replay's device time. Fails on a
    client error or an unanswered request in any window of the load
    (the profiled ones too), a capture after warmup, a served row off
    InferStep on the same block by more than BLOCK_SERVE_TOL of the
    largest logit, a ``refresh_params`` that does not serve the new
    weights (the old ones overwritten in place at once), or a
    ``serve_stablehlo`` round trip of the block's
    ``aot.export_model(poly_batch=True)`` artifact, with the block behind
    it as fallback, off the block by more than BLOCK_AOT_TOL of the
    largest magnitude (or served by the fallback).

64. rcnn_proposal (run after phase 63): Faster R-CNN's test-time RPN at
    MXNet 1.3's ``example/rcnn`` settings for VGG-16 (a 600 x 1000 image,
    the 37 x 62 conv5_3 map, 9 anchors a cell: 20,646, 6000 before NMS,
    300 after, threshold 0.7, min size 16 at scale 1.6), seeded scores
    and deltas: ``nd.contrib.Proposal`` (one image) and
    ``MultiProposal`` (two) through the NMS kernels, which must launch
    once an image, against the same calls with the plain NMS on the
    card, RoIs and scores exactly equal; then ``ROIPooling`` (exactly)
    and ``ROIAlign`` (within RCNN_ALIGN_TOL) over the 300 RoIs on a
    (1, 512, 37, 62) map against the port on the CPU. Prints Proposal's
    CUDA-event and wall ms, its device ms, the NMS kernels' device ms
    inside it, and the RoI ops' ms and peak memory;
65. vision_card: every name of the slice (``tests/torch_vision_cases.py``:
    ops/vision.py's 25, ROIAlign and bipartite_matching, the 7 int8 ops),
    forward and gradient on the card against the port on the CPU,
    integers exactly;
66. quant_resnet: resnet50_v1 (seed-0 weights) exported to a symbol and
    quantized by ``contrib.quantization.quantize_model`` (naive, 2
    batches of 32 at 224 x 224, on the card): 54 int8 layers; the float
    and int8 forwards at batch 32 timed, their relative error and top-1
    agreement; the int32 accumulators of the stem (K = 147), a 3 x 3
    layer at 512 channels (K = 4608) and the dense layer bit-equal on the
    card and the CPU; every node of the int8 symbol on the card from the
    CPU's inputs against the CPU's outputs (int32 exactly, int8 within 1
    step on at most QUANT_STEP_SHARE of the values, floats within
    QUANT_FLOAT_TOL); the int8 logits on the card against the CPU's run
    of the same symbol within QUANT_MAX_STEPS steps of the output's grid,
    and nearer on average than int8 is to the float net;
67. quantize_example: ``python3 mxnet_tpu_torch/example/quantization/
    quantize_model.py --num-calib 128`` on the card exits 0
    (ENTROPY_BEATS_NAIVE).
68. imgcodec: the port's JPEG codec and resampler as a host library
    (``ops/csrc/imgcodec.cc``, built by the host C++ compiler in the build
    phase) against the plain numpy version on a seeded corpus (gray,
    4:4:4, 4:2:2, 4:2:0, 4:4:0, restart intervals, sizes 1 x 1 to
    375 x 500, qualities 50, 75 and 95): encode byte for byte, decode and
    Pillow's bilinear resample pixel for pixel; then the library's host
    ms of a 500 x 375 4:2:0 q95 decode, a resize to short side 256 and to
    224 x 224, and an encode, beside the plain version's, with the host's
    CPU model and core count;
69. imagenet_rec: IMAGENET_IMAGES seeded smooth-noise images at
    ImageNet-like sizes (IMAGENET_SIZES) packed by the port's ``im2rec``
    at quality 95 (timed); ``ImageRecordIter`` at (3, 224, 224),
    ``resize=256``, ``rand_crop``, ``rand_mirror`` and ImageNet's mean and
    std with 1 worker process (IMAGENET_ONE_WORKER_BATCHES batches) and
    all host cores (an epoch, which must hand out every record once,
    every image through the library): img/s and the seconds to the first
    batch; the first batch of the one-worker run must equal, bit
    for bit, the same batch built by the pipeline's worker function on
    the plain codec (the master's shuffle and the worker's draws
    replayed);
70. imagenet_train: ``example/gluon/train_resnet.py --rec`` (resnet50_v1,
    batch 32, 224 x 224, its ``ImageRecordIter`` call: 4 worker
    processes stretching each image) for two epochs of that .rec (40
    batches, finite losses, one capture, every image decoded and resized
    by the library): each epoch's img/s and the share of a step's wall
    time spent waiting for the batch (the second epoch's headline; each
    wait printed), beside the same captured step fed by the
    example's ``NDArrayIter``; torch.profiler's device busy share over
    IMAGENET_PROFILE_STEPS steps of ``NDArrayIter`` and over
    IMAGENET_REC_PROFILE's steps of the record loop's second epoch
    (after the batches its workers had prefetched).
71. device_infeed: ``io.DevicePrefetchIter`` to the card over a host
    ``NDArrayIter`` (8 batches of (32, 3, 64, 64)): every batch staged
    through pinned memory on its side stream lands on the card equal to
    the host's; ``set_state`` resumes after 5; a batch already on the
    card passes through.

After the distributed phases (``--dist``), the sharded-state and elastic
slice (``--elastic`` runs only these; no nvcc build):

72. zero_resnet: resnet50_v1 through ``dist_sync`` on 2 ranks sharing the
    card (one ``--dist-rank zero`` job), SGD and Adam at ``MXNET_ZERO=1``
    and bf16 SGD with ``multi_precision`` at ``MXNET_ZERO=2``, each
    against the same job's ``MXNET_ZERO=0`` run: final weights and
    materialized states bit for bit, the ranks' hashes after every step,
    0 fallbacks, 1 materialization, the states a rank at most the
    replicated figure over the ranks plus padding; ms a step, the
    gather's ms and bytes, staged bytes, peak memory.
73. zero_ckpt: the sharded save in the same job (0 materializations, a
    shard file a rank), restores on 2 ranks and in this process equal to
    the materialized states, torn-write and drop-shard falling back.
74. elastic_resume: ``trainplane.fit(checkpoint=)`` of resnet50_v1 in
    this process killed at a step boundary and resumed by
    ``run_elastic``, bit for bit against the uninterrupted run; the zero
    job's run preempted through a file only rank 0 watches, resumed by a
    new 2-rank job (``--dist-rank resume``) bit for bit.
75. elastic_kill: ``tests/nightly/torch_dist_elastic_kill.py`` on 3
    ranks, every marker (this job and the resume job run beside the fit
    runs of phase 74).

Slice 28 (several contexts, the sharded plane, the pipeline;
``--multi-device`` runs the ring job, the zero job and phase 78 only):

76. pipeline: in dist_ring's job, ``parallel.pipeline_apply`` over the 2
    ranks (PIPE_WIDTH, PIPE_MICRO, PIPE_ROWS) within PIPE_TOL of the
    stages applied in turn to each microbatch on one rank; ms a call,
    both ways, and staged bytes a call.
77. zero_plane: in the zero job, ``TrainPlane`` across the 2 ranks at
    ``MXNET_ZERO`` 1 and 2 against the replicated plane on dist_resnet's
    global batches, in float64 within ZERO_PLANE_TOL, the float32
    distance a reading; state bytes, peak bytes, ms, collectives and
    staged bytes a step. (dist_planes' 1-rank NCCL plane also checks
    that ``MXNET_ZERO=1`` declines there with the "1-device mesh"
    reason, counted.)
78. multi_context: the card beside the host in one process (MC_TOL):
    train_mnist.py's mlp through ``Module(context=[gpu(0), cpu(0)])``,
    the gluon ``Trainer`` over both, ``matrix_factorization.py`` at its
    defaults, each against its one-device run; ms a step and the bytes
    copied across the card/host edge a step.

``python3 chip_smoke.py --imagenet`` runs phases 68-71 only (the host
compiler builds the codec; no nvcc build).
``python3 chip_smoke.py --fleet`` runs phases 61-62 only,
``--block-serve`` phase 63 only (no nvcc build), ``--vision`` phases
64-67 only (building only the NMS kernel).
``python3 chip_smoke.py --word-lm`` runs phases 31-35 only,
``--mnist`` phases 36-42 only, ``--ops-tail`` phases 43-48 only,
``--gluon`` phases 49-54 only, and ``--graph`` phases 55-60 only (no
nvcc build: the paths run no hand-written kernel).

``python3 chip_smoke.py --resnet`` runs phases 17-26 only; ``--ckpt``
runs phases 28-30 only (building the NMS kernel, training the SSD example
first); ``--zoo``
runs zoo_score only; ``--module-plane`` runs custom_rtc and
module_plane_parity only (no nvcc build);
``--profiles`` builds the kernels and runs train_profile and ssd_profile
only (to compare two checkouts in one call, copy the script into each
and run it there). ``--profiler-empties`` only counts the torch.profiler
sessions that record no CUDA event, over short and long sessions of
graph replays and of eager kernels (why ``_profiled_us`` and the devprof
cross-check run an empty session again).

The training phases' optimizer updates (train_profile, ssd_profile) run
through the fused apply; their lines count the optimizer dispatches of
the traced steps (``opt_dispatches``).

The flash-attention kernel is checked (phase 3) against its plain
version on the GPT shape, ragged and long shapes (S = 1, 63, 65, 129,
1000 and 2048 around its 128-row q tiles and 64-token kv tiles), head
dims 6 (the cp.async route), 8, 24, 64, 100, 128 and 256, both
maskings, bf16 inputs (also at (4, 8, 2048, 64); within one bf16
rounding step of the plain version), and through its autograd
Function's gradients, and timed at the GPT shape and at (4, 8, 2048, 64)
beside SDPA's host and device time, with two bounds: the tensor cores
(fp32 inputs at fp32 accuracy, bf16 at the bf16 rate: ``bound_ms``) and
the fp32 rate outside them (``bound_simt_ms``); at the GPT shape the
wrapper's host time is split from its entry point's, with and without
the tensor maps' encoding. The build phase fails if ptxas reports a
spill in the flash kernel at D = 64. NMS is three kernels a call
(compaction with the small-image path, mask pass, scan; the build phase
fails if ptxas reports a spill in any of them). They are checked
against the plain version, whose keep masks they must equal exactly, at
the SSD shape (B = 8, N = 3840, 3 classes, top-100 valid), with every box
valid, under force_suppress, at N = 1, 77, 1000 and 6000 (``Proposal``'s
default pre-NMS count), on duplicated boxes, on integer boxes whose IoU
is exactly the threshold (either side of the cap ``nms.CAP``), at valid
counts around the 64-box groups and the cap with invalid boxes between
the valid ones (with and without force_suppress), on a batch whose
images fall on both sides of the cap, on interleaved valid boxes at
N = 3000, and at N = 10000 (more far tiles a scan step than its
registers hold); then ``MultiBoxDetection`` through the kernels against
the same op with the plain version; then one call at the SSD shape
captured in a CUDA graph and replayed on new boxes and counts
(``nms_graph_replay``: the call reads nothing back on the host); then
timed at the SSD shape, at B = 1, N = 6000 and at the SSD shape with
every box valid, the device time of each kernel its mean over the
launches a session recorded. ``python3 chip_smoke.py --nms-sweep``
builds the NMS source with caps 128, 256 and 512 and times each at the
SSD shape with 100 to 500 valid boxes an image; ``--nms-time`` builds
only ``nms.cu`` and times the three shapes through ``nms_keep_cuda``
(to compare two checkouts in one call, copy the script into each and
run it there).

In every serving and training phase the kernels' launch counts are set
to 0 just before the phase drives the path and read just after.

Kernel 1 (paged attention) is two kernels, a split kernel over spans of
positions and a merge kernel, launched only where a row may pass one
span: its device times sum both and print each
(``device_ms_by_kernel``), and the build phase fails if ptxas reports a
spill in either. It is checked on decode ticks (ragged, GQA, causal,
lengths and causal bounds at its span boundaries) and on prefill chunks
(the 32-row prefix-hit tail, the 64-row chunk, a first chunk shorter
than its rung, a chunk starting mid-page, GQA 8/2, and row tiles that
straddle a span boundary, run ``STRADDLE_REPS`` times), padding rows
exact zeros, and timed on the decode bench, every slot at max_seq_len, a
young batch (every slot under 90 positions) and both chunks. ``wrapper_host`` prints the host time of one call of each
paged wrapper; ``python3 chip_smoke.py --wrapper-host`` prints only
that line.

Kernel 2 (the verify step) is one kernel that splits each slot over spans
of positions and merges a row's spans in its last span block to arrive:
the build phase fails if ptxas reports a spill in any instance of it. It
is checked on ragged verify ticks (H = KH and GQA 8/2), on rows whose
limits straddle a span boundary inside one slot (W = 5 at limits
k * SPAN - 2 .. k * SPAN + 2, and GQA 8/2 at W = 5; blocks of
two spans hold those rows, so they run ``STRADDLE_REPS`` times), at W = 9
with 4 query heads per kv head (36 rows, five row chunks), on rows of
limit 0 beside live ones (which must be exact zeros), at head dims 6
(4-byte staging), 32, 80, 128 and 256, and at W = 1 against kernel 1;
then timed on the spec bench and with every slot at max_seq_len (both
sets of figures in its entry of the kernels line).

The line before the last is a JSON object ``{"kernels": [...]}``; the
last line is ``{"ok": true, "device": {...}}``. Without a CUDA device, or
without the rest of the checkout beside it, the script exits non-zero
and prints no result.
"""
import gc
import hashlib
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

T_START = time.perf_counter()

# H100 SXM published peaks (NVIDIA data sheet; dense, at the full 700 W)
PEAK_BYTES_S = 3.35e12
PEAK_FP32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12  # tensor cores
PEAK_BF16_FLOPS = 989e12  # tensor cores

# the decode bench model and plane (the JAX package's bench.py,
# BENCH_DECODE full configuration)
MODEL = dict(vocab_size=1024, num_layers=4, num_heads=8, head_dim=64)
SLOTS, MAX_SEQ, PAGE = 16, 1152, 16
MAX_PAGES = MAX_SEQ // PAGE
N_REQ, OUT_CAP, SYSTEM_LEN = 32, 256, 32
OUT_MIX = [16] * 3 + [64] * 2 + [256, 512, 1024]
KERNEL_TOL = 1e-4  # fp32, another summation order than the plain einsum
STRADDLE_REPS = 50  # runs of each case whose rows blocks of two spans share
# bf16 outputs: both versions round an fp32 result to bf16 (8 significant
# bits), and their two summation orders can tip that rounding by one step,
# at most 2^-7 of the value; the atol covers outputs near 0
BF16_RTOL, BF16_ATOL = 2.0 ** -7, 1e-5
# the kernels' device-side names, as the profiler reports them
# kernel 1 is two kernels, paged_attention_split_kernel and
# paged_attention_merge_kernel: its readings sum both; kernel 2 is
# paged_spec_attention_kernel (every instance)
KERNEL_1, KERNEL_2 = "paged_attention_", "paged_spec_attention_"
KERNEL_3 = "flash_attention_kernel"
# NMS is three kernels a call: nms_keep_compact_kernel, nms_keep_mask_kernel
# and nms_keep_scan_kernel
KERNEL_4 = "nms_keep_"
NMS_KERNELS = ("nms_keep_compact_kernel", "nms_keep_mask_kernel",
               "nms_keep_scan_kernel")
# the detection slice: the SSD example's NMS (batch 8, 3 x (32 x 32 +
# 16 x 16) anchors at side 64, threshold 0.45, top 100), and Proposal's
# default (6000 boxes before NMS, threshold 0.7, one class)
SSD_NMS = (8, 3840, 0.45, 100)
PROPOSAL_NMS = (1, 6000, 0.7)
# fp32, the kernel and the plain version in one call on the same weights:
# only the suppression differs, and it must decide alike
SSD_TOL = 1e-4
# the training slice: the GPT example's shape (batch 32, 4 heads, SEQ 64,
# head_dim 64 / 4) and a long shape
GPT_ATT = (32, 4, 64, 16)
LONG_ATT = (4, 8, 2048, 64)
# the extension slice: the rtc spec kernels are fp32 elementwise work
# whose only rounding difference from the plain version is NVRTC's fused
# multiply-add (one ulp); the softmax kernels differ from it in expf and
# the order of the row's sum; the rtc op and the numpy op of the
# custom_rtc phase must agree within 1e-5 after the first batch
RTC_TOL = 1e-5
SOFTMAX_TOL = 1e-6
CUSTOM_TOL = 1e-5
# the softmax-forward kernel: the custom_rtc path's shape and a large one
RTC_SHAPES = ((64, 10), (8192, 1024))
KERNEL_5 = "softmax_fwd"
# the bench's speculative phase (32 motif prompts x 48 tokens, k = 4) and
# shared-prefix phase (96 requests over 8 system prompts of 512 tokens)
SPEC_K, SPEC_N, SPEC_OUT = 4, 32, 48
SP_SYSTEMS, SP_SYS_LEN, SP_N, SP_OUT, SP_CHUNK = 8, 512, 96, 16, 64
# the ResNet slice: the JAX package's bench.py training headline
# (resnet50_v1, batch 32, 224 x 224, 1000 classes, SGD 0.05 with momentum
# 0.9, K = 16 steps a multi_call, data from RandomState(0))
RESNET_BATCH, RESNET_SIDE, RESNET_CLASSES, RESNET_K = 32, 224, 1000, 16
RESNET_SGD = {"learning_rate": 0.05, "momentum": 0.9}
# a captured step against the same step run eagerly, fp32: the same torch
# calls in the same order, but cuDNN may pick other algorithms (other
# summation orders) inside a capture, and its weight-gradient kernels may
# accumulate with atomics
RESNET_TOL = 1e-4
RESNET_TRAIN_S, RESNET_INFER_S = 2.5, 1.0
# bf16: one bfloat16 rounding step, of the compared tensor's largest
# magnitude (a captured step may run other cuDNN algorithms than the eager
# one, so a weight may round the other way)
BF16_RTOL = 2.0 ** -7
RESNET_PERCALL_S = 1.5
PLANE_BATCHES, PLANE_S = (32, 64, 128, 256), 1.0
# the module plane: the rtc kernels' names as the profiler reports them,
# and the plane steps traced to hold the counted launches against them
RTC_KERNELS = ("softmax_fwd", "softmax_ce_bwd")
RTC_TRACE_STEPS = 4
# module_plane_parity: a LeNet-style symbolic net with BatchNorm (batch 64,
# 1 x 28 x 28, 10 classes, SGD 0.1 with momentum 0.9 and wd 1e-4), 10 graph
# steps against 10 eager ones; fp32 with TF32 off gives the same bits,
# unless cuDNN runs another algorithm inside the capture, which may move a
# value by at most PLANE_TOL
PLANE_STEPS, PLANE_BATCH, PLANE_TOL = 10, 64, 1e-5
PLANE_SGD = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4}
# zoo_score: benchmark_score.py's networks on the card, fp32 (TF32 off) at
# batches 32 and 1, and bf16 at batch 32 for its default sweep; seed-0
# weights, RandomState(0) data, 1000 classes, 224 x 224 (Inception v3 299 x
# 299); He-initialized weights (Xavier, gaussian, fan-in, magnitude 2), so
# the logits keep a scale through the depth (the gluon default's Uniform(0.07)
# brings MobileNet's to 1e-24); InferStep's captured forward within ZOO_TOL
# of the eager one in fp32, of the largest logit's magnitude where above 1
ZOO_NETS = ("alexnet", "vgg16", "squeezenet1_0", "densenet121",
            "inception_v3", "mobilenet1_0", "mobilenet_v2_1_0",
            "resnet152_v1")
# batch 1 in fp32 for the small nets only, to keep the full script inside
# its time limit (zoo_score is the first depth to cut)
ZOO_BATCH1 = ("squeezenet1_0", "mobilenet1_0", "mobilenet_v2_1_0")
ZOO_TOL = 1e-4
ZOO_S = 0.2  # the time budget of each timed loop
# the checkpoint phases: ckpt_resnet saves after CKPT_STEPS TrainPlane
# steps, then a resumed run and a rewound one repeat the next CKPT_STEPS
CKPT_STEPS = 3
# the word language model slice: the RNN op's check at the medium PTB
# model's shape, (T, N, C) and hidden 650, 2 layers; cuDNN against the
# step loop in fp32 with TF32 off, each tensor within RNN_OP_TOL of its
# largest magnitude (at least 1): 35 recurrent steps and two summation
# orders of every product. rnn_relu's gradient jumps where a unit's
# pre-activation crosses 0, and fp32 rounding moves a few units across
# between the two orders (its fp32 gradients differed by up to 4 % of
# their largest value on the card), so its gradients are held in float64,
# where RNN_OP_TOL_F64 applies to every tensor
RNN_OP_SHAPE, RNN_OP_HIDDEN, RNN_OP_TOL = (35, 32, 650), 650, 1e-4
RNN_OP_TOL_F64 = 1e-9
# word_lm: upstream MXNet 1.3's medium PTB command on PTB's vocabulary
WORD_LM_ARGS = ["--tied", "--nhid", "650", "--emsize", "650", "--dropout",
                "0.5", "--lr", "20", "--epochs", "2"]
WORD_LM_CORPUS = dict(synth_tokens=400000, synth_vocab=10000)
WORD_LM_PROFILE_STEPS = 10
# word_lm_parity: card against CPU, 3 steps from the same weights
WORD_LM_PARITY_VOCAB, WORD_LM_TOL = 2000, 1e-4
# nd_ops_card: the port's ops on the card against the port on the CPU
ND_OPS_TOL = 1e-5


def fail(msg):
    """Print why on both streams (a caller that keeps only the end of
    one of them still reads it) and exit 1."""
    line = "chip_smoke FAILED: %s" % msg
    print(line, flush=True)
    print(line, file=sys.stderr, flush=True)
    sys.exit(1)


def phase(name, **fields):
    """One phase line; ``at_s`` is the script's wall seconds when it was
    printed, so a run's lines give each phase's seconds."""
    print(json.dumps({"phase": name, **fields,
                      "at_s": time.perf_counter() - T_START}), flush=True)


def time_ms(fn, iters=50, warm=3):
    """Mean time of ``fn()`` over ``iters`` back-to-back runs, CUDA
    events: the device's time per call, or the host's where issuing a
    call takes longer than running it."""
    import torch

    for _ in range(warm):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def host_ms(fn, iters=200, warm=3):
    """Mean host time to issue ``fn()`` over ``iters`` back-to-back calls
    (``time.perf_counter``, no synchronisation inside the loop)."""
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / iters * 1e3


def _profiled_us(fn, iters, keep, per_call=None):
    """{event name: [device microseconds, events]} of the CUDA events
    that ``keep(name)`` accepts in one torch.profiler session over
    ``iters`` runs of ``fn()``. A session that recorded no device time of
    them (or, given ``per_call``, events of another number of kernels
    than ``per_call``) is run again after a pause, five sessions at most:
    the profiler has come back empty, three times running once. Empty if
    all five were."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    out = {}
    for attempt in range(5):
        if attempt:
            time.sleep(0.2)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        out = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA and keep(e.name):
                rec = out.setdefault(e.name, [0.0, 0])
                rec[0] += e.time_range.elapsed_us()
                rec[1] += 1
        if sum(us for us, _ in out.values()) > 0.0 and \
                per_call in (None, len(out)):
            return out
    return {}


def profiler_empties(short=(500, 20), long=(20, 2000)):
    """How often a torch.profiler session (device activity only) records
    no CUDA event: ``short[0]`` sessions of ``short[1]`` runs and
    ``long[0]`` of ``long[1]``, each session ending in a synchronisation,
    of four runs: a captured graph's replay and the same work eager, of
    one kernel (``y = 2x``) and of two (``y = 2x + 1``). Prints each
    kind's sessions, empty sessions and the fewest and most events a
    session recorded, against the kernels its runs launched."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    x = torch.full((1 << 20,), 1.5, device="cuda")
    y = torch.empty_like(x)
    works = {1: lambda: torch.mul(x, 2.0, out=y),
             2: lambda: torch.add(torch.mul(x, 2.0), 1.0, out=y)}
    runs = {}
    for kernels, work in works.items():
        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            work()
        torch.cuda.current_stream().wait_stream(stream)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            work()
        runs[("graph", kernels)] = graph.replay
        runs[("eager", kernels)] = work
    torch.cuda.synchronize()
    for sessions, n in (short, long):
        for (kind, kernels), fn in runs.items():
            counts = []
            for _ in range(sessions):
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    for _ in range(n):
                        fn()
                    torch.cuda.synchronize()
                counts.append(sum(e.device_type == DeviceType.CUDA
                                  for e in prof.events()))
            phase("profiler_empties", kind=kind, kernels_a_run=kernels,
                  runs_a_session=n, sessions=sessions,
                  empty=counts.count(0), fewest_events=min(counts),
                  most_events=max(counts), launched=n * kernels,
                  card=CARD)


def device_ms_by_kernel(fn, kernel, iters=20, per_call=None):
    """Mean device duration per call of each kernel whose name contains
    ``kernel`` while ``fn()`` runs ``iters`` times, from torch.profiler:
    {short kernel name: ms}, the kernels alone, without their wrapper's
    host work (which bounds ``time_ms`` at small shapes). ``per_call``:
    the kernels a call launches, each once, which every session must
    show; each kernel's reading is then its mean over the launches the
    session recorded (sessions have come back one launch short of those
    they ran, which a mean over the calls would read low)."""
    out = {}
    for name, (us, count) in _profiled_us(fn, iters, lambda n: kernel in n,
                                          per_call).items():
        # "(anonymous namespace)::nms_keep_scan_kernel(...)" -> the
        # kernel's own name
        name = name[name.find(kernel):].split("(")[0]
        out[name] = out.get(name, 0.0) + \
            us / 1e3 / (count if per_call else iters)
    if not out:
        fail("the profiler saw no device time of %s" % kernel)
    return out


def kernel_device_ms(fn, kernel, iters=20, per_call=None):
    """Mean device duration per call of all kernels whose name contains
    ``kernel``: the sum of ``device_ms_by_kernel`` (with ``per_call``, of
    each kernel's mean over the launches a session recorded)."""
    return sum(device_ms_by_kernel(fn, kernel, iters, per_call).values())


def call_device_ms(fn, iters=20):
    """Mean device duration per call of everything ``fn()`` runs on the
    card (every kernel, copy and fill), from torch.profiler: a library
    call's device time, whatever its kernels are named."""
    total = sum(us for us, _ in _profiled_us(
        fn, iters, lambda n: True).values()) / 1e3 / iters
    if total <= 0.0:
        fail("the profiler saw no device time of the library call")
    return total


def ptxas_entries(log):
    """What ``ptxas -v`` said of each kernel entry in an nvcc log:
    {mangled name: {"registers", "spill_stores", "spill_loads", "line"}}."""
    import re

    out, cur = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            cur = out.setdefault(m.group(1), {"line": []})
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m:
            cur["spill_stores"] = int(m.group(1))
            cur["spill_loads"] = int(m.group(2))
            cur["line"].append(ln.strip())
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            cur["registers"] = int(m.group(1))
            cur["line"].append(ln.strip())
    return out


def flash_ptxas(log):
    """The flash kernel's instances at D = 64 (fp32 and bf16), from the
    build's ptxas report; fails on a spill or a missing report."""
    import re

    found = {}
    for name, info in ptxas_entries(log).items():
        m = re.search(r"flash_attention_kernelI(f|13__nv_bfloat16)Li(\d+)E",
                      name)
        if m and m.group(2) == "64":
            found["float32" if m.group(1) == "f" else "bfloat16"] = info
    if sorted(found) != ["bfloat16", "float32"]:
        fail("build: no ptxas report of the flash kernel at D = 64 "
             "(found %s)" % sorted(found))
    for dt, info in found.items():
        if info.get("spill_stores", 1) or info.get("spill_loads", 1):
            fail("build: the flash kernel at D = 64 (%s) spills: %s"
                 % (dt, info["line"]))
    return {dt: " | ".join(info["line"]) for dt, info in found.items()}


def spill_free_ptxas(log, kernels):
    """Every instance of each of ``kernels`` (names as the source gives
    them) from a build's ptxas report; fails on a spill or a missing
    report."""
    found = {}
    for name, info in ptxas_entries(log).items():
        for kind in kernels:
            if kind in name:
                found.setdefault(kind, []).append(info)
    if sorted(found) != sorted(kernels):
        fail("build: no ptxas report of %s (found %s)"
             % (", ".join(kernels), sorted(found)))
    for kind, infos in found.items():
        for info in infos:
            if info.get("spill_stores", 1) or info.get("spill_loads", 1):
                fail("build: %s spills: %s" % (kind, info["line"]))
    return {kind: [" | ".join(info["line"]) for info in infos]
            for kind, infos in found.items()}


def build_all():
    """Start one build per source (nvcc a kernel, the host compiler the
    codec), all together, and wait."""
    from concurrent.futures import ThreadPoolExecutor

    from mxnet_tpu_torch.ops import _build

    names = sorted(os.path.splitext(f)[0] for f in os.listdir(
        os.path.dirname(_build.source_path("x"))) if f.endswith((".cu", ".cc")))
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        list(pool.map(_build.load, names))
    secs = time.perf_counter() - t0
    ptxas = {n: [ln.strip() for ln in _build.build_log(n).splitlines()
                 if "registers" in ln or "spill" in ln] for n in names}
    return names, secs, ptxas


def _attention_case(rng, s, h, kh, d, seq_lens, q_pos=None):
    """Inputs of one paged-attention call on the card: q, pools sized like
    the engine's (S*max_pages + 1 pages), a page table of distinct pages
    per slot padded with the null page past each slot's end."""
    import torch

    n_pages = s * MAX_PAGES + 1
    dev = torch.device("cuda")
    q = torch.tensor(rng.randn(s, h, d).astype(np.float32), device=dev)
    kp = torch.tensor(rng.randn(n_pages, PAGE, kh, d).astype(np.float32),
                      device=dev)
    vp = torch.tensor(rng.randn(n_pages, PAGE, kh, d).astype(np.float32),
                      device=dev)
    perm = rng.permutation(np.arange(1, n_pages)).astype(np.int32)
    pt = perm[:s * MAX_PAGES].reshape(s, MAX_PAGES).copy()
    for i, n in enumerate(seq_lens):
        pt[i, -(-int(n) // PAGE):] = 0
    args = [q, kp, vp, torch.tensor(pt, device=dev),
            torch.tensor(np.asarray(seq_lens, np.int32), device=dev)]
    qp = (None if q_pos is None
          else torch.tensor(np.asarray(q_pos, np.int32), device=dev))
    return args, qp


def _bound(rows, h, kh, d, row_limits, table_tokens=None):
    """Least time (ms) for the work these inputs need: each input byte
    read once, each output written once, on the card's peak rates.

    ``rows`` query rows attend ``row_limits`` positions each;
    ``table_tokens`` are the positions each page-table row covers (its
    K/V read ONCE however many rows share the row): the row limits
    themselves when every row has its own table row (the decode tick),
    the largest limit of a slot's rows when W rows share it (a verify
    tick, a prefill chunk)."""
    row_limits = np.asarray(row_limits, np.int64)
    kv = row_limits if table_tokens is None else \
        np.asarray(table_tokens, np.int64)
    pages = int(np.sum(-(-kv // PAGE)))
    nbytes = (2 * rows * h * d * 4                # q in, out
              + int(np.sum(kv)) * kh * d * 4 * 2  # the K and V rows read
              + pages * 4 + rows * 4 * 2)         # page ids, seq_lens/q_pos
    flops = 4 * d * h * int(np.sum(row_limits))   # q.k and p.v, per row
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, flops / PEAK_FP32_FLOPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def _chunk_case(rng, c, start, n, h, kh):
    """One prefill chunk on the card: q (C, H, D) at positions start ..
    start + C - 1 (rows at or past n are padding), the pools, the
    sequence's page row, and the plain version's operands (the row
    repeated per query row, per-row seq_lens, and q_pos)."""
    import torch

    args, _ = _attention_case(rng, 1, h, kh, 64, [start + n])
    dev = args[0].device
    q = torch.tensor(rng.randn(c, h, 64).astype(np.float32), device=dev)
    row = args[3][0]
    idx = torch.arange(c, dtype=torch.int32, device=dev)
    plain = (q, args[1], args[2], row[None].expand(c, -1).contiguous(),
             torch.where(idx < n, idx + start + 1, torch.zeros_like(idx)))
    return q, row, plain, idx + start


def chunk_graph_replay(rng):
    """The device-scalar chunk entry point captured once in a CUDA graph,
    as the engine captures its chunk rung, then replayed for chunks at
    other positions and lengths of the same shape (the (start, length)
    pair rewritten in place between replays): each replay against the
    plain version at those values. Returns the largest error."""
    import torch

    from mxnet_tpu_torch.ops import paged_attention as pa

    q, row, plain, _qpos = _chunk_case(rng, SP_CHUNK, 0, SP_CHUNK, 8, 8)
    kp, vp = plain[1], plain[2]
    sl = torch.tensor([0, SP_CHUNK], dtype=torch.int32, device=q.device)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        pa.paged_prefill_attention(q, kp, vp, row, sl[0], sl[1])
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        out = pa.paged_prefill_attention(q, kp, vp, row, sl[0], sl[1])
    worst = 0.0
    c = q.shape[0]
    idx = torch.arange(c, dtype=torch.int32, device=q.device)
    for start, n in ((0, SP_CHUNK), (pa.SPAN - 3, SP_CHUNK), (500, 37),
                     (MAX_SEQ - SP_CHUNK, SP_CHUNK), (64, 1)):
        sl.copy_(torch.tensor([start, n], dtype=torch.int32))
        graph.replay()
        torch.cuda.synchronize()
        lens = torch.where(idx < n, idx + start + 1, torch.zeros_like(idx))
        want = pa.paged_attention_reference(q, kp, vp, plain[3], lens,
                                            q_pos=idx + start)
        err = float((out - want).abs().max())
        if not torch.allclose(out, want, atol=KERNEL_TOL, rtol=KERNEL_TOL) \
                or not bool((out[n:] == 0).all()):
            fail("chunk graph replayed at start %d, length %d disagrees "
                 "with the plain version: max abs err %.3g" % (start, n, err))
        worst = max(worst, err)
        phase("kernel_check", case="prefill_chunk_graph_replay",
              start=start, length=n, max_abs_err=err, tol=KERNEL_TOL)
    return worst


def wrapper_host_ms():
    """Host time to issue one call of each paged wrapper (the shared
    ``_launch``, the checks, the allocations): kernel 1 at the decode
    bench, kernel 2 at the spec bench."""
    from mxnet_tpu_torch.ops import paged_attention as pa

    rng = np.random.RandomState(3)
    args, _ = _attention_case(rng, SLOTS, 8, 8, 64, [MAX_SEQ // 2] * SLOTS)
    lens = _verify_lens(rng, 10, 10 + SPEC_OUT - SPEC_K - 1, ragged=False)
    spec_args, _ = _spec_case(rng, SLOTS, SPEC_K + 1, 8, 8, 64, lens)
    return {"paged_attention": host_ms(
                lambda: pa.ragged_paged_attention(*args)),
            "paged_spec_attention": host_ms(
                lambda: pa.ragged_spec_attention(*spec_args))}


def check_kernels():
    """Each paged-attention shape of the main path: the kernel against
    the plain version on the same inputs, then timed."""
    import torch
    import torch.nn.functional as F

    from mxnet_tpu_torch.ops import paged_attention as pa

    rng = np.random.RandomState(0)
    ragged = [0, 1, 15, 16, 17, 31, 32, 33, 47, 100, 255, 256, 257, 600,
              1151, 1152]
    # lengths at the kernel's span boundaries: k * SPAN - 1, k * SPAN,
    # k * SPAN + 1 (the last span one token short, full, one token into
    # the next)
    edges = [k * pa.SPAN + e for k in range(1, 6) for e in (-1, 0, 1)]
    cases = [
        ("decode_bench", 8, 8, ragged, None),
        ("decode_gqa_8_over_2", 8, 2, ragged, None),
        ("decode_causal_q_pos", 8, 8, ragged,
         [max(0, n - 1 - (7 * i) % 13) for i, n in enumerate(ragged)]),
        ("decode_span_edges", 8, 8, edges + [MAX_SEQ], None),
        ("decode_span_edges_causal", 8, 8, [MAX_SEQ] * SLOTS,
         [n - 1 for n in edges] + [MAX_SEQ - 1]),
    ]
    results = {}
    worst = 0.0
    for name, h, kh, lens, qpos in cases:
        args, qp = _attention_case(rng, SLOTS, h, kh, 64, lens, qpos)
        got = pa.ragged_paged_attention(*args, q_pos=qp)
        torch.cuda.synchronize()
        want = pa.paged_attention_reference(*args, q_pos=qp)
        err = float((got - want).abs().max())
        worst = max(worst, err)
        if not torch.allclose(got, want, atol=KERNEL_TOL, rtol=KERNEL_TOL):
            fail("kernel %s disagrees with the plain version: max abs "
                 "err %.3g" % (name, err))
        results[name] = (args, qp, lens, h, kh, err)
        phase("kernel_check", case=name, max_abs_err=err, tol=KERNEL_TOL)

    # prefill chunks of one sequence over its own page row, causal: the
    # prefix-hit tail (a 32-row chunk, the top prefill rung, at positions
    # 32..51), a chunked-prefill chunk (64 rows at positions 512..575), a
    # first chunk shorter than its rung, one starting mid-page, GQA, and
    # chunks whose row tiles (8 rows; 2 at GQA 8/2) straddle position
    # SPAN with a start no multiple of the tile: two blocks hold those
    # rows, so they run STRADDLE_REPS times to give a race its chances
    chunks = {}
    for name, c, start, n, h, kh in (
            ("prefill_chunk_32", 32, 32, 20, 8, 8),
            ("prefill_chunk_%d" % SP_CHUNK, SP_CHUNK, 512, SP_CHUNK, 8, 8),
            ("prefill_chunk_start_0", SP_CHUNK, 0, 37, 8, 8),
            ("prefill_chunk_mid_page", SP_CHUNK, PAGE * 2 + PAGE // 2,
             SP_CHUNK, 8, 8),
            ("prefill_chunk_gqa_8_over_2", SP_CHUNK, 512, SP_CHUNK, 8, 2),
            ("prefill_chunk_straddles_span", SP_CHUNK, pa.SPAN - 3,
             SP_CHUNK, 8, 8),
            ("prefill_chunk_straddles_span_gqa_8_over_2", SP_CHUNK,
             pa.SPAN - 27, SP_CHUNK - 4, 8, 2)):
        q, row, plain, qpos = _chunk_case(rng, c, start, n, h, kh)
        want = pa.paged_attention_reference(*plain, q_pos=qpos)
        # the entry point with (start, n) as launch arguments, then the
        # one the engine's captured chunk replays, which reads them on
        # the card and always launches the merge
        dev_sl = torch.tensor([start, n], dtype=torch.int32,
                              device=q.device)
        for case, sl in ((name, (start, n)),
                         (name + "_device_scalars", (dev_sl[0], dev_sl[1]))):
            err = 0.0
            for _ in range(STRADDLE_REPS if "straddles" in name else 1):
                got = pa.paged_prefill_attention(q, plain[1], plain[2], row,
                                                 *sl)
                torch.cuda.synchronize()
                err = max(err, float((got - want).abs().max()))
                if not torch.allclose(got, want, atol=KERNEL_TOL,
                                      rtol=KERNEL_TOL):
                    fail("prefill-chunk kernel %s disagrees with the plain "
                         "version: max abs err %.3g" % (case, err))
                if not bool((got[n:] == 0).all()):
                    fail("prefill-chunk kernel %s: a padding row is not "
                         "exact zeros" % case)
            worst = max(worst, err)
            phase("kernel_check", case=case, max_abs_err=err,
                  tol=KERNEL_TOL, rows=c, start=start, length=n)
        chunks[name] = (q, row, plain, qpos, start, n)
    worst = max(worst, chunk_graph_replay(rng))

    def record(case, run, plain_run, library_run, bound, library,
               max_limit):
        ms = time_ms(run)
        # the split kernel, and the merge where a row may pass one span
        by_kernel = device_ms_by_kernel(run, KERNEL_1,
                                        per_call=1 + (max_limit > pa.SPAN))
        plain_ms = time_ms(plain_run)
        library_ms = time_ms(library_run)
        library_device_ms = call_device_ms(library_run)
        bound_ms, bound_by = bound
        phase("kernel_time", case=case, ms=ms,
              device_ms=sum(by_kernel.values()),
              device_ms_by_kernel=by_kernel, plain_ms=plain_ms,
              library_ms=library_ms, library_device_ms=library_device_ms,
              bound_ms=bound_ms, bound_by=bound_by, library=library)
        return dict(ms=ms, device_ms=sum(by_kernel.values()),
                    plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                    library_ms=library_ms,
                    library_device_ms=library_device_ms)

    def times(case, args, lens, h, kh):
        q, kp, vp, pt, sl = args
        t = MAX_PAGES * PAGE
        kg = kp[pt.long()].reshape(SLOTS, t, kh, 64).transpose(1, 2)
        vg = vp[pt.long()].reshape(SLOTS, t, kh, 64).transpose(1, 2)
        kg, vg = kg.contiguous(), vg.contiguous()
        mask = (torch.arange(t, device=q.device)[None, :]
                < sl[:, None].long())
        mask = mask[:, None, None, :]
        qs = q[:, :, None, :]
        return record(
            case, lambda: pa.ragged_paged_attention(*args),
            lambda: pa.paged_attention_reference(*args),
            lambda: F.scaled_dot_product_attention(qs, kg, vg,
                                                   attn_mask=mask),
            _bound(SLOTS, h, kh, 64, lens),
            "scaled_dot_product_attention over K/V gathered beforehand "
            "(gather not timed)", t)

    # times at the decode bench shape (the JSON line's numbers), then with
    # every slot at max_seq_len: the most bytes one tick's layer can read
    args, _qp, lens, h, kh, _err = results["decode_bench"]
    bench = times("decode_bench", args, lens, h, kh)
    full = [MAX_SEQ] * SLOTS
    args, _ = _attention_case(rng, SLOTS, 8, 8, 64, full)
    times("decode_full_%d" % MAX_SEQ, args, full, 8, 8)
    # and the young batch tick_profile traces: 4..24-token prompts, up to
    # 64 tokens out, so every slot within one span
    short = [int(n) for n in rng.randint(5, 89, SLOTS)]
    args, _ = _attention_case(rng, SLOTS, 8, 8, 64, short)
    times("decode_short", args, short, 8, 8)

    # the chunks of the main path: each K/V tile is read once per tile of
    # chunk rows; the bound counts the sequence's pages once. The engine's
    # captured chunk runs the device-scalar entry point, which launches
    # the merge at every chunk (the table holds more than SPAN positions)
    for name, dev in (("prefill_chunk_%d" % SP_CHUNK, False),
                      ("prefill_chunk_32", False),
                      ("prefill_chunk_%d" % SP_CHUNK, True),
                      ("prefill_chunk_32", True)):
        q, row, plain, qpos, start, n = chunks[name]
        sl = torch.tensor([start, n], dtype=torch.int32, device=q.device)
        sl = (sl[0], sl[1]) if dev else (start, n)
        c = q.shape[0]
        kp, vp = plain[1], plain[2]
        t = MAX_PAGES * PAGE
        kg = kp[row[None].long()].reshape(1, t, 8, 64).transpose(1, 2)
        vg = vp[row[None].long()].reshape(1, t, 8, 64).transpose(1, 2)
        kg, vg = kg.contiguous(), vg.contiguous()
        pos = torch.arange(t, device=q.device)[None, :]
        mask = ((pos < plain[4][:, None].long())
                & (pos <= qpos[:, None].long()))
        qs = q.transpose(0, 1)[None]
        record(name + ("_device_scalars" if dev else ""),
               lambda: pa.paged_prefill_attention(q, kp, vp, row, *sl),
               lambda: pa.paged_attention_reference(*plain, q_pos=qpos),
               lambda: F.scaled_dot_product_attention(
                   qs, kg, vg, attn_mask=mask[None, None]),
               _bound(c, 8, 8, 64, plain[4].cpu().numpy(), [start + n]),
               "scaled_dot_product_attention, %d queries over the "
               "sequence's K/V gathered beforehand (gather not timed)" % c,
               t if dev else start + n)
    phase("wrapper_host", **{k + "_host_ms": v
                             for k, v in wrapper_host_ms().items()})
    return {"name": "paged_attention", "route": "cuda",
            "source": "mxnet_tpu_torch/ops/csrc/paged_attention.cu",
            "replaces": "mxnet_tpu/ops/pallas_kernels.py:292",
            "max_abs_err": worst, **bench}


def _spec_case(rng, s, w, h, kh, d, row_lens):
    """Inputs of one verify-step call on the card: q (S, W, H, D), pools
    sized like the engine's, one page table row per slot padded with the
    null page past the slot's largest row limit, per-row seq_lens."""
    import torch

    dev = torch.device("cuda")
    row_lens = np.asarray(row_lens, np.int32).reshape(s, w)
    n_pages = s * MAX_PAGES + 1
    q = torch.tensor(rng.randn(s, w, h, d).astype(np.float32), device=dev)
    kp = torch.tensor(rng.randn(n_pages, PAGE, kh, d).astype(np.float32),
                      device=dev)
    vp = torch.tensor(rng.randn(n_pages, PAGE, kh, d).astype(np.float32),
                      device=dev)
    perm = rng.permutation(np.arange(1, n_pages)).astype(np.int32)
    pt = perm[:s * MAX_PAGES].reshape(s, MAX_PAGES).copy()
    for i in range(s):
        pt[i, -(-int(row_lens[i].max()) // PAGE):] = 0
    return [q, kp, vp, torch.tensor(pt, device=dev),
            torch.tensor(row_lens.ravel(), device=dev)], row_lens


def _verify_lens(rng, base_lo, base_hi, ragged):
    """Per-row limits of one verify tick: slot s at committed length L
    has rows L, L+1, .. (its token and drafts). Ragged: every fourth slot
    inactive (all rows 0) and the others with a random number of draft
    rows, the rest padded with 0 — what acceptance and the draft clamps
    leave in a real tick."""
    lens = np.zeros((SLOTS, SPEC_K + 1), np.int32)
    for i in range(SLOTS):
        base = int(rng.randint(base_lo, base_hi + 1))
        live = (int(rng.randint(1, SPEC_K + 2)) if i % 4 else 0) \
            if ragged else SPEC_K + 1
        for j in range(live):
            lens[i, j] = min(base + j, MAX_SEQ)
    return lens


def check_spec_kernel():
    """The verify step's multi-query kernel against its plain version
    (the cases set out in the module's docstring), then timed at the spec
    bench's lengths and with every slot at max_seq_len."""
    import torch
    import torch.nn.functional as F

    from mxnet_tpu_torch.ops import paged_attention as pa

    rng = np.random.RandomState(1)
    w = SPEC_K + 1
    worst = 0.0

    def check(name, h, kh, d, lens, reps=1):
        lens = np.asarray(lens, np.int32).reshape(SLOTS, -1)
        width = lens.shape[1]
        args, lens = _spec_case(rng, SLOTS, width, h, kh, d, lens)
        q = args[0]
        want = pa.paged_spec_attention_reference(
            q.reshape(SLOTS * width, h, d), *args[1:]).reshape(q.shape)
        zero = torch.tensor(lens == 0, device=q.device)
        err = 0.0
        for _ in range(reps):
            got = pa.ragged_spec_attention(*args)
            torch.cuda.synchronize()
            err = max(err, float((got - want).abs().max()))
            if not torch.allclose(got, want, atol=KERNEL_TOL,
                                  rtol=KERNEL_TOL):
                fail("spec kernel %s disagrees with the plain version: max "
                     "abs err %.3g" % (name, err))
            if not bool((got[zero] == 0).all()):
                fail("spec kernel %s: a row with limit 0 is not exact zeros"
                     % name)
        phase("kernel_check", case=name, max_abs_err=err, tol=KERNEL_TOL,
              rows_per_slot=width, heads=h, kv_heads=kh, head_dim=d,
              rows_with_limit_0=int((lens == 0).sum()), runs=reps)
        return err

    for name, h, kh in (("spec_bench", 8, 8), ("spec_gqa_8_over_2", 8, 2)):
        worst = max(worst, check(name, h, kh, 64, _verify_lens(
            rng, 1, MAX_SEQ - SPEC_K, ragged=True)))
    # every slot's W = 5 rows at limits k * SPAN - 2 .. k * SPAN + 2: the
    # rows of one slot end in two spans, so blocks of both spans hold them
    # and the last to arrive merges; run STRADDLE_REPS times
    straddle = np.asarray([[(1 + i % (MAX_SEQ // pa.SPAN - 1)) * pa.SPAN
                            - 2 + j for j in range(w)]
                           for i in range(SLOTS)], np.int32)
    for name, h, kh in (("spec_straddles_span", 8, 8),
                        ("spec_straddles_span_gqa_8_over_2", 8, 2)):
        worst = max(worst, check(name, h, kh, 64, straddle,
                                 reps=STRADDLE_REPS))
    # W = 9 with 4 query heads per kv head: 36 rows a kv head, five row
    # chunks; the rows past each slot's live ones have limit 0
    wide = np.zeros((SLOTS, 9), np.int32)
    for i in range(SLOTS):
        base, live = int(rng.randint(1, MAX_SEQ - 8)), int(rng.randint(0, 10))
        wide[i, :live] = base + np.arange(live)
    worst = max(worst, check("spec_w9_groups_4", 8, 2, 64, wide))
    # rows of limit 0 beside live ones: a dead slot, padded drafts, and a
    # live row between dead ones
    mixed = _verify_lens(rng, 1, MAX_SEQ - SPEC_K, ragged=False)
    mixed[0] = 0
    mixed[1, 1:] = 0
    mixed[2, ::2] = 0
    worst = max(worst, check("spec_limit_0_rows", 8, 8, 64, mixed))
    # head dims of every instance: 4-byte staging at 6, then 32, 80, 128
    # and 256
    for d in (6, 32, 80, 128, 256):
        worst = max(worst, check("spec_head_dim_%d" % d, 8, 8, d,
                                 _verify_lens(rng, 1, MAX_SEQ - SPEC_K,
                                              ragged=True)))

    # W = 1: the same function as the one-row kernel on the same inputs
    lens = _verify_lens(rng, 0, MAX_SEQ, ragged=False)[:, :1]
    args, _ = _spec_case(rng, SLOTS, 1, 8, 8, 64, lens)
    got = pa.ragged_spec_attention(*args)
    one = pa.ragged_paged_attention(args[0][:, 0].contiguous(), *args[1:])
    torch.cuda.synchronize()
    err = float((got[:, 0] - one).abs().max())
    worst = max(worst, err)
    if not torch.allclose(got[:, 0], one, atol=KERNEL_TOL, rtol=KERNEL_TOL):
        fail("spec kernel at W=1 disagrees with the one-row kernel: max abs "
             "err %.3g" % err)
    phase("kernel_check", case="spec_w1_vs_paged_attention",
          max_abs_err=err, tol=KERNEL_TOL)

    def times(case, base_lo, base_hi):
        lens = _verify_lens(rng, base_lo, base_hi, ragged=False)
        args, lens = _spec_case(rng, SLOTS, w, 8, 8, 64, lens)
        q, kp, vp, pt, sl = args
        ms = time_ms(lambda: pa.ragged_spec_attention(*args))
        # one launch a call: every session must show each
        by_kernel = device_ms_by_kernel(
            lambda: pa.ragged_spec_attention(*args), KERNEL_2, per_call=1)
        qf = q.reshape(SLOTS * w, 8, 64)
        plain_ms = time_ms(lambda: pa.paged_spec_attention_reference(
            qf, kp, vp, pt, sl))
        t = MAX_PAGES * PAGE
        kg = kp[pt.long()].reshape(SLOTS, t, 8, 64).transpose(1, 2)
        vg = vp[pt.long()].reshape(SLOTS, t, 8, 64).transpose(1, 2)
        kg, vg = kg.contiguous(), vg.contiguous()
        mask = (torch.arange(t, device=q.device)[None, None, :]
                < sl.reshape(SLOTS, w)[:, :, None].long())[:, None]
        qs = q.transpose(1, 2)  # (S, H, W, D)
        library_ms = time_ms(lambda: F.scaled_dot_product_attention(
            qs, kg, vg, attn_mask=mask))
        library_device_ms = call_device_ms(
            lambda: F.scaled_dot_product_attention(qs, kg, vg,
                                                   attn_mask=mask))
        bound_ms, bound_by = _bound(SLOTS * w, 8, 8, 64, lens.ravel(),
                                    lens.max(axis=1))
        device_ms = sum(by_kernel.values())
        phase("kernel_time", case=case, ms=ms, device_ms=device_ms,
              device_ms_by_kernel=by_kernel, plain_ms=plain_ms,
              library_ms=library_ms, library_device_ms=library_device_ms,
              bound_ms=bound_ms, bound_by=bound_by, rows_per_slot=w,
              slot_lens=[int(lens.min()), int(lens.max())],
              library="scaled_dot_product_attention, W queries per slot "
                      "with a per-row mask over K/V gathered beforehand "
                      "(gather not timed)")
        return dict(ms=ms, device_ms=device_ms, plain_ms=plain_ms,
                    bound_ms=bound_ms, bound_by=bound_by,
                    library_ms=library_ms,
                    library_device_ms=library_device_ms)

    # the spec bench's verify ticks: 10-token prompts + up to 48 tokens;
    # then every slot at max_seq_len, the most bytes a verify tick reads
    bench = times("spec_bench", 10, 10 + SPEC_OUT - w)
    full = times("spec_full_%d" % MAX_SEQ, MAX_SEQ - SPEC_K,
                 MAX_SEQ - SPEC_K)
    return {"name": "paged_spec_attention", "route": "cuda",
            "source": "mxnet_tpu_torch/ops/csrc/paged_spec_attention.cu",
            "replaces": "mxnet_tpu/ops/pallas_kernels.py:516",
            "max_abs_err": worst, **bench,
            "full_%d" % MAX_SEQ: full}


def _flash_bound(b, h, s, d, causal, itemsize):
    """Least time (ms) of one attention forward: q, k, v read once and the
    output written once; 2 * D flops for q.k and as many for p.v per
    (row, key) pair, of which causal keeps S (S + 1) / 2 per (b, h).
    Returns ``(bound_ms, bound_by, bound_simt_ms)``: the operations on the
    tensor cores (fp32 inputs at fp32 accuracy: 3 TF32 products per fp32
    product at 495 TFLOP/s; bf16 inputs: the two products at the bf16
    rate, 989 TFLOP/s), against the bytes; and, comparable with the
    earlier rows, the operations at the 67 TFLOP/s fp32 rate outside the
    tensor cores, against the bytes."""
    nbytes = 4 * b * h * s * d * itemsize
    pairs = s * (s + 1) // 2 if causal else s * s
    flops = 4 * d * b * h * pairs
    t_bytes = nbytes / PEAK_BYTES_S
    if itemsize == 4:
        t_tc = 3 * flops / PEAK_TF32_FLOPS
    else:
        t_tc = flops / PEAK_BF16_FLOPS
    t_simt = flops / PEAK_FP32_FLOPS
    return (max(t_bytes, t_tc) * 1e3,
            "bytes" if t_bytes >= t_tc else "operations",
            max(t_bytes, t_simt) * 1e3)


def check_flash_kernel():
    """The fused attention forward kernel against its plain version on
    the training path's shape and on ragged, long, non-causal and bf16
    cases, its autograd Function's gradients, then timed."""
    import torch
    import torch.nn.functional as F

    from mxnet_tpu_torch.ops import _build
    from mxnet_tpu_torch.ops import flash_attention as fa

    rng = np.random.RandomState(3)
    dev = torch.device("cuda")

    def qkv(shape, dtype=torch.float32):
        return [torch.tensor(rng.randn(*shape).astype(np.float32) * 0.5,
                             device=dev).to(dtype) for _ in range(3)]

    cases = [("gpt", GPT_ATT, True, torch.float32),
             ("2x2x64x16", (2, 2, 64, 16), False, torch.float32),
             ("1x2x100x32", (1, 2, 100, 32), True, torch.float32),
             ("1x1x9x8", (1, 1, 9, 8), True, torch.float32),
             ("d64_s1000", (1, 2, 1000, 64), True, torch.float32),
             ("d64_s1000", (1, 2, 1000, 64), False, torch.float32),
             ("d128_s1000", (1, 2, 1000, 128), True, torch.float32),
             ("d128_s1000", (1, 2, 1000, 128), False, torch.float32),
             # the widest head_dim, and one that is not a multiple of 4
             # (no 16-byte staging loads)
             ("d256_s300", (1, 2, 300, 256), True, torch.float32),
             ("d6_s77", (2, 2, 77, 6), False, torch.float32),
             ("bf16_gpt", GPT_ATT, True, torch.bfloat16),
             ("bf16_2x4x200x64", (2, 4, 200, 64), False, torch.bfloat16)]
    # the tensor-core tiling: q tiles of 128 rows, kv tiles of 64, two
    # stages: one row, one tile minus or plus one, two tiles plus one, and
    # a long sequence; head_dims of one, three and thirteen 8-column
    # steps; D = 6 (24-byte rows) on the cp.async route; bf16 at the long
    # shape
    for causal in (True, False):
        for s in (1, 63, 65, 129, 2048):
            cases.append(("d64_s%d" % s, (2, 2, s, 64), causal,
                          torch.float32))
        for d in (8, 24, 100):
            cases.append(("d%d_s200" % d, (2, 2, 200, d), causal,
                          torch.float32))
        cases.append(("d6_s200", (2, 2, 200, 6), causal, torch.float32))
        cases.append(("bf16_long", LONG_ATT, causal, torch.bfloat16))
    worst = 0.0
    for name, shape, causal, dtype in cases:
        q, k, v = qkv(shape, dtype)
        route = fa.flash_plan(shape[-1], q.element_size()).route
        if (route == "tma") != (shape[-1] * q.element_size() % 16 == 0):
            fail("flash %s: staged through %s" % (name, route))
        got = fa.flash_attention_forward(q, k, v, causal=causal)
        torch.cuda.synchronize()
        want = fa.flash_attention_reference(q, k, v, causal=causal)
        rtol, atol = ((KERNEL_TOL, KERNEL_TOL) if dtype == torch.float32
                      else (BF16_RTOL, BF16_ATOL))
        err = float((got.float() - want.float()).abs().max())
        if dtype == torch.float32:
            worst = max(worst, err)
        if got.dtype != dtype or not torch.allclose(
                got.float(), want.float(), atol=atol, rtol=rtol):
            fail("flash kernel %s (causal=%s, %s) disagrees with the plain "
                 "version: max abs err %.3g" % (name, causal, dtype, err))
        phase("kernel_check", case="flash_%s_%s" % (
            name, "causal" if causal else "full"), dtype=str(dtype),
            route=route, max_abs_err=err, max_abs_want=float(
                want.float().abs().max()), rtol=rtol, atol=atol)

    # the autograd Function (kernel forward, dense-recompute backward)
    # against torch.autograd.grad of the plain version
    q, k, v = qkv(GPT_ATT)
    w = torch.tensor(rng.randn(*GPT_ATT).astype(np.float32), device=dev)
    grads = []
    for fn in (fa.flash_attention, fa.flash_attention_reference):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        out = fn(*leaves, causal=True)
        grads.append(torch.autograd.grad((out * w).sum(), leaves))
    err = max(float((a - b).abs().max()) for a, b in zip(*grads))
    if not all(torch.allclose(a, b, atol=KERNEL_TOL, rtol=KERNEL_TOL)
               for a, b in zip(*grads)):
        fail("flash autograd gradients disagree with the plain version: "
             "max abs err %.3g" % err)
    phase("kernel_check", case="flash_autograd_gradients", max_abs_err=err,
          tol=KERNEL_TOL)

    entry = None
    for shape, dtype in ((GPT_ATT, torch.float32), (LONG_ATT, torch.float32),
                         (LONG_ATT, torch.bfloat16)):
        q, k, v = qkv(shape, dtype)
        for causal in (True, False):
            ms = time_ms(lambda: fa.flash_attention_forward(
                q, k, v, causal=causal), iters=20)
            device_ms = kernel_device_ms(lambda: fa.flash_attention_forward(
                q, k, v, causal=causal), KERNEL_3, per_call=1)
            plain_ms = time_ms(lambda: fa.flash_attention_reference(
                q, k, v, causal=causal), iters=20)
            library_ms = time_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=causal), iters=20)
            library_device_ms = call_device_ms(
                lambda: F.scaled_dot_product_attention(q, k, v,
                                                       is_causal=causal))
            bound_ms, bound_by, bound_simt_ms = _flash_bound(
                *shape, causal, q.element_size())
            phase("kernel_time", case="flash_%s%s_%s" % (
                "bf16_" if dtype == torch.bfloat16 else "",
                "x".join(map(str, shape)), "causal" if causal else "full"),
                ms=ms, device_ms=device_ms, plain_ms=plain_ms,
                library_ms=library_ms, library_device_ms=library_device_ms,
                bound_ms=bound_ms, bound_by=bound_by,
                bound_simt_ms=bound_simt_ms,
                library="scaled_dot_product_attention(is_causal=%s)" % causal)
            if entry is None:  # the training path's shape and masking
                entry = dict(ms=ms, device_ms=device_ms, plain_ms=plain_ms,
                             bound_ms=bound_ms, bound_by=bound_by,
                             bound_simt_ms=bound_simt_ms,
                             library_ms=library_ms,
                             library_device_ms=library_device_ms)
    # the wrapper's host work at the training path's shape: the whole
    # wrapper, then its entry point alone on the same tensors, staged
    # through TMA (three tensor maps encoded a call) and through cp.async
    # (none); host time to issue a call, the device left to run behind
    q, k, v = qkv(GPT_ATT)
    out = torch.empty_like(q)
    b, h, s, d = GPT_ATT
    plan = fa.flash_plan(d, 4)
    fn = fa._bind(_build.load("flash_attention"), "flash_attention_f32")
    stream = torch.cuda.current_stream().cuda_stream

    def call_entry(vec):
        return lambda: fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                          out.data_ptr(), b * h, s, d, 1, 0.25, stream,
                          plan.rows, plan.kv_tile, plan.stages, vec,
                          plan.smem_bytes)

    if call_entry(0)() != 0 or call_entry(16)() != 0:
        fail("flash entry point refused the GPT shape")
    phase("kernel_time", case="flash_gpt_host", host_ms=dict(
        wrapper=host_ms(lambda: fa.flash_attention_forward(
            q, k, v, causal=True)),
        entry_tma=host_ms(call_entry(0)),
        entry_cp_async=host_ms(call_entry(16))))
    # the same long shape staged through cp.async: views 8 bytes into
    # their buffers are not 16-byte aligned, which TMA needs
    q, k, v = qkv(LONG_ATT)
    n = q.numel()
    qa, ka, va = (torch.empty(n + 2, device=dev)[2:].view(LONG_ATT)
                  .copy_(t) for t in (q, k, v))
    route = fa.flash_plan(LONG_ATT[-1], 4, qa.data_ptr() & 15).route
    for causal in (True, False):
        got = fa.flash_attention_forward(qa, ka, va, causal=causal)
        torch.cuda.synchronize()
        want = fa.flash_attention_forward(q, k, v, causal=causal)
        err = float((got - want).abs().max())
        if route != "cp.async" or not err <= KERNEL_TOL:
            fail("flash through %s at %s: max abs err %.3g against TMA"
                 % (route, LONG_ATT, err))
        phase("kernel_time", case="flash_%s_%s_cp.async" % (
            "x".join(map(str, LONG_ATT)), "causal" if causal else "full"),
            route=route, max_abs_err_vs_tma=err,
            device_ms=kernel_device_ms(lambda: fa.flash_attention_forward(
                qa, ka, va, causal=causal), KERNEL_3, per_call=1),
            tma_device_ms=kernel_device_ms(lambda: fa.flash_attention_forward(
                q, k, v, causal=causal), KERNEL_3, per_call=1))
    return {"name": "flash_attention", "route": "cuda",
            "source": "mxnet_tpu_torch/ops/csrc/flash_attention.cu",
            "replaces": "mxnet_tpu/ops/pallas_kernels.py:137",
            "max_abs_err": worst, **entry}


def _nms_inputs(rng, b, n, n_valid=None, ncls=3, side=1.0, dup=False,
                integer=False, counts=None):
    """Boxes sorted as the detection ops hand them to NMS: (B, N, 4)
    corner boxes, classes, and the first ``n_valid`` of each image valid
    (all when None); or, given ``counts``, counts[i] boxes of image i
    valid at random places, invalid boxes between them."""
    import torch

    if integer:  # 2x2 boxes on a unit grid: IoU exactly 1/7 or 1/3
        xy = rng.randint(0, 6, (b, n, 2)).astype(np.float32)
        wh = np.full((b, n, 2), 2.0, np.float32)
    else:
        xy = rng.rand(b, n, 2) * side * 0.8
        wh = (0.05 + rng.rand(b, n, 2) * 0.35) * side
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    if dup:  # every odd box repeats the box before it
        boxes[:, 1::2] = boxes[:, 0:n - 1:2]
    cls = rng.randint(0, ncls, (b, n)).astype(np.float32)
    valid = np.zeros((b, n), bool)
    if counts is None:
        valid[:, :n if n_valid is None else n_valid] = True
    else:
        for img, c in enumerate(counts):
            valid[img, rng.permutation(n)[:c]] = True
    dev = torch.device("cuda")
    return [torch.tensor(a, device=dev) for a in (boxes, cls, valid)]


def _nms_bound(boxes, cls, valid, keep, force):
    """Least time (ms) of one NMS call on these inputs: 21 bytes a box
    read (4 coordinates, a class, a valid byte) and a keep byte written;
    operations: 5 a box for its area, and 15 for each (kept i, later
    valid j) pair the greedy walk must test (same class, or any under
    force_suppress): 4 min/max, 2 subtractions and 2 clamps for the
    overlap, a product, an add, a subtract, a clamp, a division, a
    comparison, a class test."""
    b, n = keep.shape
    k, v = keep.cpu().numpy(), valid.cpu().numpy()
    c = cls.cpu().numpy()
    pairs = 0
    for img in range(b):
        later = np.cumsum(v[img][::-1])[::-1]  # valid boxes at j >= i
        for i in np.nonzero(k[img])[0]:
            if force:
                pairs += int(later[i]) - 1
            else:
                pairs += int(np.sum(v[img, i + 1:] & (c[img, i + 1:]
                                                      == c[img, i])))
    nbytes = b * n * (21 + 1)
    ops = 5 * b * n + 15 * pairs
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, ops / PEAK_FP32_FLOPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", pairs)


def check_nms_kernel():
    """The NMS kernels against their plain version, keep masks exactly
    equal, then MultiBoxDetection through the kernels against the same op
    with the plain version, then one call captured in a CUDA graph and
    replayed on new boxes, then timed."""
    import torch

    from mxnet_tpu_torch.ops import detection, nms
    from mxnet_tpu_torch.ops.registry import get_op

    rng = np.random.RandomState(4)
    b, n, thr, topk = SSD_NMS
    cases = [("ssd", _nms_inputs(rng, b, n, topk), thr, False),
             ("ssd_all_valid", _nms_inputs(rng, b, n), thr, False),
             ("force_suppress", _nms_inputs(rng, 2, n), thr, True),
             ("n1", _nms_inputs(rng, 3, 1), 0.5, False),
             ("n77", _nms_inputs(rng, 3, 77), 0.5, False),
             ("n1000", _nms_inputs(rng, 2, 1000), 0.3, False),
             ("n6000", _nms_inputs(rng, 1, 6000, side=600.0), 0.7, True),
             ("duplicates", _nms_inputs(rng, 2, 700, dup=True), 0.5, False)]
    for t in (1.0 / 7.0, 1.0 / 3.0):
        cases.append(("iou_on_threshold_%.4f" % t,
                      _nms_inputs(rng, 2, 300, ncls=1, integer=True), t,
                      False))
    # valid counts at the 64-box groups and around the cap, one image
    # each, invalid boxes between the valid ones; a batch on both sides
    # of the cap (own seed: the timed inputs below stay as before)
    rng2 = np.random.RandomState(40)
    cap = nms.CAP
    edges = (0, 1, 63, 64, 65, 127, 128, 129, cap - 1, cap, cap + 1,
             2 * cap + 64)
    cases += [
        ("count_edges", _nms_inputs(rng2, len(edges), 700, counts=edges),
         0.45, False),
        ("count_edges_force", _nms_inputs(rng2, len(edges), 700,
                                          counts=edges), 0.45, True),
        ("mixed_ssd", _nms_inputs(rng2, b, n, counts=(
            100, n, 40, cap, cap + 1, 1500, 0, 100)), thr, False),
        ("interleaved", _nms_inputs(rng2, 4, 3000, counts=(
            700, 2000, 90, 3000)), 0.5, False),
        # more far tiles a scan step than its registers hold (N > 7808)
        ("n10000", _nms_inputs(rng2, 1, 10000, side=600.0), 0.7, True),
        ("iou_on_threshold_small", _nms_inputs(rng2, 2, cap - 56, ncls=1,
                                               integer=True), 1.0 / 3.0,
         False)]
    worst = 0.0  # largest |kernel - plain| over every case, keep as 0/1
    for name, (bx, c, v), t, force in cases:
        got = nms.nms_keep_cuda(bx, c, v, t, force)
        torch.cuda.synchronize()
        want = nms.nms_keep_reference(bx, c, v, t, force)
        worst = max(worst, float((got.float() - want.float()).abs().max()))
        if not torch.equal(got, want):
            fail("nms kernel case %s: %d of %d keep decisions differ from "
                 "the plain version" % (name, int((got != want).sum()),
                                        got.numel()))
        phase("kernel_check", case="nms_" + name, shape=list(v.shape),
              kept=int(got.sum()), valid=int(v.sum()),
              valid_per_image=v.sum(1).tolist(), equal=True)

    # the whole op: decode, per-class sort, top-k cut and NMS
    op = get_op("_contrib_MultiBoxDetection")
    attrs = op.parse_attrs({"nms_threshold": thr, "nms_topk": topk})
    logits = torch.tensor(rng.randn(b, 4, n).astype(np.float32) * 3,
                          device="cuda")
    prob = torch.softmax(logits, dim=1)
    loc = torch.tensor(rng.randn(b, n * 4).astype(np.float32) * 0.5,
                       device="cuda")
    anchors = _nms_inputs(rng, 1, n)[0]
    outs = []
    try:
        for plain in (False, True):
            if plain:
                detection.nms_keep = nms.nms_keep_reference
            nms.nms_keep_cuda.launches = 0
            outs.append(op.fcompute(attrs, prob, loc, anchors))
            torch.cuda.synchronize()
            outs.append(nms.nms_keep_cuda.launches)
    finally:
        detection.nms_keep = nms.nms_keep
    worst = max(worst, float((outs[0] - outs[2]).abs().max()))
    if outs[1] != 1 or outs[3] != 0 or not torch.equal(outs[0], outs[2]):
        fail("MultiBoxDetection through the kernel differs from the plain "
             "version (launches %d / %d)" % (outs[1], outs[3]))
    phase("kernel_check", case="nms_multibox_detection", shape=[b, n, 6],
          detections=int((outs[0][..., 0] >= 0).sum()), equal=True)

    worst = max(worst, nms_graph_replay())

    entry = nms_time(rng, per_call=len(NMS_KERNELS))
    return {"name": "nms_keep", "route": "cuda",
            "source": "mxnet_tpu_torch/ops/csrc/nms.cu",
            "replaces": "mxnet_tpu/ops/pallas_kernels.py:52",
            "max_abs_err": worst, **entry}


def nms_time(rng, per_call):
    """NMS timed through ``nms_keep_cuda`` at the SSD shape, ``Proposal``'s
    and the SSD shape with every box valid: CUDA-event and device ms (each
    of the ``per_call`` kernels a call launches: its mean over the
    launches a session recorded), the plain version, the bound. Returns
    the SSD shape's figures."""
    from mxnet_tpu_torch.ops import nms

    b, n, thr, topk = SSD_NMS
    entry = None
    for case, (bx, c, v), t, force in (
            ("ssd_%dx%d" % (b, n), _nms_inputs(rng, b, n, topk), thr, False),
            ("proposal_%dx%d" % PROPOSAL_NMS[:2],
             _nms_inputs(rng, *PROPOSAL_NMS[:2], ncls=1, side=600.0),
             PROPOSAL_NMS[2], True),
            ("ssd_all_valid_%dx%d" % (b, n), _nms_inputs(rng, b, n), thr,
             False)):
        def run():
            return nms.nms_keep_cuda(bx, c, v, t, force)

        ms = time_ms(run, iters=50)
        by_kernel = device_ms_by_kernel(run, KERNEL_4, per_call=per_call)
        device_ms = sum(by_kernel.values())
        plain_ms = time_ms(lambda: nms.nms_keep_reference(bx, c, v, t,
                                                          force),
                           iters=3, warm=1)
        bound_ms, bound_by, pairs = _nms_bound(bx, c, v, run(), force)
        phase("kernel_time", case="nms_" + case, ms=ms, device_ms=device_ms,
              device_ms_by_kernel=by_kernel, plain_ms=plain_ms,
              bound_ms=bound_ms, bound_by=bound_by,
              iou_pairs=pairs, valid=int(v.sum()), library_ms=None,
              library="none: no PyTorch call computes greedy NMS "
                      "(torchvision is not on the card's machine)")
        if entry is None:  # the SSD path's shape
            entry = dict(ms=ms, device_ms=device_ms, plain_ms=plain_ms,
                         bound_ms=bound_ms, bound_by=bound_by,
                         library_ms=None)
    return entry


def nms_graph_replay(replays=3):
    """One ``nms_keep_cuda`` call at the SSD shape captured in a CUDA
    graph, then replayed on new boxes written into its static inputs,
    each replay's keep mask against the plain version: a call reads no
    count on the host and plans from its shape alone. Returns the largest
    |graph - plain| (keep as 0/1)."""
    import torch

    from mxnet_tpu_torch.ops import nms

    rng = np.random.RandomState(5)
    b, n, thr, topk = SSD_NMS
    bx, c, v = _nms_inputs(rng, b, n, topk)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm up off the capture stream
        nms.nms_keep_cuda(bx, c, v, thr, False)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    before = nms.nms_keep_cuda.launches
    with torch.cuda.graph(graph):
        keep = nms.nms_keep_cuda(bx, c, v, thr, False)
    if nms.nms_keep_cuda.launches != before + 1:
        fail("nms_graph: the captured call counted %d launches"
             % (nms.nms_keep_cuda.launches - before))
    worst = 0.0
    # new boxes, another number valid in each image on each replay (the
    # last replay puts images above the cap: the mask pass and the scan)
    for rep, counts in enumerate(((topk,) * b, (3, 60, 100, 0, 1, 64, 65,
                                                99),
                                  (100, 500, n, 0, 257, 64, 1000, 2))):
        nb, nc, nv = _nms_inputs(rng, b, n, counts=counts)
        bx.copy_(nb)
        c.copy_(nc)
        v.copy_(nv)
        graph.replay()
        torch.cuda.synchronize()
        want = nms.nms_keep_reference(bx, c, v, thr, False)
        worst = max(worst, float((keep.float() - want.float()).abs().max()))
        if not torch.equal(keep, want):
            fail("nms_graph: replay %d differs from the plain version in %d "
                 "of %d keep decisions" % (rep, int((keep != want).sum()),
                                           keep.numel()))
        phase("kernel_check", case="nms_graph_replay_%d" % rep,
              shape=[b, n], valid_per_image=list(counts),
              kept=int(keep.sum()), equal=True)
    del graph
    return worst


def nms_sweep(caps=(128, 256, 512)):
    """The cap C (images of at most C valid boxes finish in the
    compaction block) by measurement: a copy of ``nms.cu`` with its
    ``kCap`` line rewritten, built once per cap (all nvcc started
    together), each checked against the plain version and timed (device
    ms by kernel) at the SSD shape with 100, 200, 300, 400 and 500 valid
    boxes an image, and every box valid."""
    import ctypes
    from concurrent.futures import ThreadPoolExecutor

    import torch

    from mxnet_tpu_torch.ops import _build, nms

    with open(_build.source_path("nms")) as f:
        source = f.read()
    line = "constexpr int kCap = %d;" % nms.CAP
    if line not in source:
        fail("nms_sweep: no line %r in nms.cu" % line)
    os.makedirs(_build._OUT, exist_ok=True)

    def build(cap):
        src = os.path.join(_build._OUT, "nms_sweep_cap%d.cu" % cap)
        with open(src, "w") as f:
            f.write(source.replace(line, "constexpr int kCap = %d;" % cap))
        out = src[:-3] + ".so"
        proc = subprocess.run([_build._nvcc(), *_build.FLAGS, "-o", out,
                               src], capture_output=True, text=True)
        if proc.returncode:
            fail("nms_sweep: nvcc at cap %d failed:\n%s%s"
                 % (cap, proc.stdout, proc.stderr))
        spill_free_ptxas(proc.stdout + proc.stderr, NMS_KERNELS)
        return ctypes.CDLL(out)

    with ThreadPoolExecutor(max_workers=len(caps)) as pool:
        libs = dict(zip(caps, pool.map(build, caps)))
    rng = np.random.RandomState(41)
    b, n, thr, _ = SSD_NMS
    cases = [("valid_%d" % k, _nms_inputs(rng, b, n, k))
             for k in (100, 200, 300, 400, 500)]
    cases.append(("all_valid", _nms_inputs(rng, b, n)))
    built, cap0 = nms._build.load("nms"), nms.CAP
    try:
        for cap in caps:
            nms._build._loaded["nms"], nms.CAP = libs[cap], cap
            row = {}
            for name, (bx, c, v) in cases:
                def run():
                    return nms.nms_keep_cuda(bx, c, v, thr, False)

                got = run()
                torch.cuda.synchronize()
                if not torch.equal(got, nms.nms_keep_reference(bx, c, v, thr,
                                                               False)):
                    fail("nms_sweep: cap %d differs from the plain version "
                         "at %s" % (cap, name))
                by = device_ms_by_kernel(run, KERNEL_4,
                                         per_call=len(NMS_KERNELS))
                row[name] = [sum(by.values()), by]
            phase("nms_sweep", cap=cap, device_ms=row)
    finally:
        nms._build._loaded["nms"], nms.CAP = built, cap0


def _ssd_rec():
    """The SSD example's synthetic dataset, in a fresh temporary
    directory (removed by the caller)."""
    import tempfile

    from mxnet_tpu_torch.example.ssd import train_ssd

    tmp = tempfile.mkdtemp(prefix="chip_smoke_ssd_")
    return tmp, train_ssd.make_dataset(os.path.join(tmp, "shapes"))


def ssd_train():
    """The detection slice's main path: the port's train_ssd example at
    its defaults on the card; it must learn and run the NMS kernel on
    every forward pass. Returns the NMS launches and the example's
    readings."""
    import shutil

    from mxnet_tpu_torch.example.ssd import train_ssd
    from mxnet_tpu_torch.ops import nms

    tmp, rec = _ssd_rec()
    try:
        args = train_ssd.parse_args(["--rec", rec])  # the defaults: the card
        _reset_launches()
        res = train_ssd.run(args)
        launches = nms.nms_keep_cuda.launches
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if not res["improved"]:
        fail("ssd_train: loss %.4f -> %.4f did not improve"
             % (res["first_loss"], res["last_loss"]))
    if launches < res["steps"] + 1:
        fail("ssd_train: NMS kernel launched %d times for %d training "
             "steps and one inference pass" % (launches, res["steps"]))
    phase("ssd_train", steps=res["steps"], batch=args.batch_size,
          side=args.side, epochs=res["epochs"], train_s=res["train_s"],
          img_per_s=res["img_per_s"], first_loss=res["first_loss"],
          last_loss=res["last_loss"], det_shape=list(res["det_shape"]),
          detections_image0=res["detections"],
          best_score_image0=res["best_score"], nms_launches=launches)
    return launches, res


def _ssd_on_card(rec):
    """The SSD example's module on the card, seed-11 weights, bound and
    with its optimizer, and its iterator."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.example.ssd import train_ssd

    mx.random.seed(11)
    it = mx.image.ImageDetIter(batch_size=8, data_shape=(3, 64, 64),
                               path_imgrec=rec, shuffle=True, mean=True,
                               std=True, rand_mirror=True)
    mod = mx.module.Module(train_ssd.get_symbol_train(train_ssd.NUM_CLASSES),
                           data_names=("data",), label_names=("label",))
    mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
    mod.init_params(mx.initializer.Xavier())
    mod.init_optimizer(optimizer="sgd", optimizer_params={
        "learning_rate": 0.01, "momentum": 0.9, "wd": 5e-4})
    return it, mod


def ssd_parity():
    """One forward and backward from the same weights on the same batch,
    through the kernel and with the plain version swapped in."""
    import shutil

    import torch

    from mxnet_tpu_torch.ops import detection, nms

    tmp, rec = _ssd_rec()
    try:
        it, mod = _ssd_on_card(rec)
        batch = next(iter(it))
        ex = mod._exec_group.execs[0]
        runs = []
        try:
            for plain in (False, True):
                if plain:
                    detection.nms_keep = nms.nms_keep_reference
                _reset_launches()
                mod.forward(batch, is_train=True)
                mod.backward()
                torch.cuda.synchronize()
                runs.append(([o.asnumpy() for o in mod.get_outputs()],
                             {k: g.asnumpy() for k, g in ex.grad_dict.items()},
                             nms.nms_keep_cuda.launches))
        finally:
            detection.nms_keep = nms.nms_keep
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    (o_k, g_k, n_k), (o_p, g_p, n_p) = runs
    if n_k != 1 or n_p != 0:
        fail("ssd_parity: %d kernel launches in the kernel run, %d in the "
             "plain run" % (n_k, n_p))
    errs = [float(np.abs(a - b).max()) for a, b in zip(o_k[:3], o_p[:3])]
    grad_err = max(float(np.abs(g_k[k] - g_p[k]).max()) for k in g_k)
    if not np.array_equal(o_k[3], o_p[3]):
        fail("ssd_parity: the detection outputs differ")
    if max(errs) > SSD_TOL or grad_err > SSD_TOL:
        fail("ssd_parity: output errs %s, gradient err %.3g"
             % (errs, grad_err))
    phase("ssd_parity", detections_equal=True,
          cls_prob_max_abs_err=errs[0], loc_loss_max_abs_err=errs[1],
          grad_max_abs_err=grad_err, tol=SSD_TOL, params=len(g_k),
          detections=int((o_k[3][..., 0] >= 0).sum()), kernel_launches=n_k)


def ssd_profile(steps=5):
    """Where an SSD training step's time goes: 5 steps traced with
    torch.profiler (device activity only)."""
    import shutil

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    tmp, rec = _ssd_rec()
    try:
        it, mod = _ssd_on_card(rec)
        batches = [b for _, b in zip(range(steps + 2), it)]
        for batch in batches[:2]:  # warm up
            mod.forward_backward(batch)
            mod.update()
        torch.cuda.synchronize()
        before = _opt_dispatches()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for batch in batches[2:]:
                mod.forward_backward(batch)
                mod.update()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        after = _opt_dispatches()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    by_name = {}  # device op name -> [ms, launches]
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            row = by_name.setdefault(e.name, [0.0, 0])
            row[0] += e.time_range.elapsed_us() / 1e3
            row[1] += 1
    busy_ms = sum(ms for ms, _ in by_name.values())
    if busy_ms <= 0.0:
        fail("the profiler saw no device time in the traced SSD steps")
    nms_ms = sum(ms for k, (ms, _) in by_name.items() if KERNEL_4 in k)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    phase("ssd_profile", steps=steps, wall_ms=wall_ms,
          per_step_wall_ms=wall_ms / steps, device_busy_ms=busy_ms,
          per_step_busy_ms=busy_ms / steps,
          device_busy_share=busy_ms / wall_ms, nms_ms=nms_ms,
          nms_share_of_busy=nms_ms / busy_ms,
          device_ops_per_step=sum(n for _, n in by_name.values()) / steps,
          opt_dispatches={k: after[k] - before[k] for k in after},
          top_device_ms=[[k[:140], ms, n] for k, (ms, n) in top])


def rtc_check():
    """The rtc spec in CUDA-C (``example/rtc_spec.py``), each case held
    against its plain version with a synchronise after it, then every
    error a user can meet: each must raise MXNetError."""
    import torch

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import rtc
    from mxnet_tpu_torch.example import rtc_spec
    from mxnet_tpu_torch.ndarray.ndarray import NDArray

    dev = torch.device("cuda", torch.cuda.current_device())
    t0 = time.perf_counter()
    mod = rtc.CudaModule(rtc_spec.SOURCE, exports=rtc_spec.EXPORTS)
    phase("rtc_check", case="compile", seconds=time.perf_counter() - t0,
          exports=list(rtc_spec.EXPORTS))
    worst = 0.0
    for case in rtc_spec.cases(np.random.RandomState(5)):
        outs, want, _ = rtc_spec.launch_case(mod, case, dev)
        torch.cuda.synchronize()
        err = max(float((o.float() - w.float()).abs().max())
                  for o, w in zip(outs, want))
        if not err <= RTC_TOL:
            fail("rtc kernel %s (%s) disagrees with its plain version: max "
                 "abs err %.3g" % (case.name, case.kernel, err))
        worst = max(worst, err)
        phase("rtc_check", case=case.name, kernel=case.kernel,
              grid=list(case.grid), block=list(case.block),
              shared_mem=case.shared_mem, max_abs_err=err, tol=RTC_TOL)

    def on_card(a, dtype=torch.float32):
        return NDArray(torch.as_tensor(a, dtype=dtype, device=dev))

    n = 1000
    x, y = on_card(np.ones(n)), on_card(np.ones(n))
    out = on_card(np.zeros(n))
    axpy_n = mod.get_kernel("axpy_n", "float alpha, const float *x, "
                            "const float *y, float *out, int n")
    grid = ((n + 255) // 256, 1, 1)
    for what, match, call in (
            ("source_does_not_compile", "does not compile", lambda: rtc.
             CudaModule('extern "C" __global__ void broken( {}')),
            ("not_exported", "not exported", lambda: mod.get_kernel(
                "missing", "const float *x, float *o")),
            ("bad_signature", "signature", lambda: mod.get_kernel(
                "axpy", "float *& bad sig")),
            ("argument_count", "args for", lambda: axpy_n.launch(
                (1.0, x, y), grid_dims=grid, block_dims=(256, 1, 1))),
            ("grid_of_zero", "invalid grid_dims", lambda: axpy_n.launch(
                (1.0, x, y, out, n), grid_dims=(0, 1, 1))),
            ("cpu_ndarray", "is on cpu", lambda: axpy_n.launch(
                (1.0, NDArray(torch.ones(n)), y, out, n), grid_dims=grid,
                block_dims=(256, 1, 1))),
            ("output_dtype", "must be a contiguous", lambda: axpy_n.launch(
                (1.0, x, y, on_card(np.zeros(n), torch.float64), n),
                grid_dims=grid, block_dims=(256, 1, 1))),
            ("block_of_2048", "cuLaunchKernel", lambda: axpy_n.launch(
                (1.0, x, y, out, n), grid_dims=(1, 1, 1),
                block_dims=(2048, 1, 1)))):
        try:
            call()
        except mx.MXNetError as e:
            if match not in str(e):
                fail("rtc error case %s raised without %r: %s"
                     % (what, match, e))
            if what == "source_does_not_compile" and "error" not in str(e):
                fail("rtc: the compile error carries no NVRTC log: %s" % e)
            phase("rtc_check", case="raises_" + what,
                  message=str(e)[:300])
            continue
        fail("rtc error case %s did not raise" % what)
    torch.cuda.synchronize()  # the refused launch left no fault behind
    return worst


def custom_softmax():
    """The port's numpy-op example (gluon MLP, numpy CustomOp) at its
    defaults on the card: it must print LEARNED."""
    from mxnet_tpu_torch.example.numpy_ops import custom_softmax as cs

    res = cs.run(cs.parse_args([]))  # the defaults: the card
    if not res["learned"]:
        fail("custom_softmax: test accuracy %.3f is not above 0.9"
             % res["test_acc"])
    print("custom-op training LEARNED", flush=True)
    phase("custom_softmax", steps=res["steps"], step_ms=res["step_ms"],
          train_acc=res["train_acc"], test_acc=res["test_acc"],
          verdict="LEARNED")


def _plane_counts():
    """(demotions by reason, graph steps, optimizer dispatches) so far."""
    from mxnet_tpu_torch.telemetry import (OPT_DISPATCHES, STEP_DISPATCHES,
                                           TRAINPLANE_FALLBACKS)

    return ({r["labels"]["reason"]: r["value"]
             for r in TRAINPLANE_FALLBACKS.series()},
            STEP_DISPATCHES.value(plane="graph"),
            sum(OPT_DISPATCHES.value(path=p) for p in ("fused", "perparam")))


def _planes_made():
    """Wrap ``trainplane.module_plane`` so the planes ``Module.fit`` makes
    are kept in the returned list (None where it declined)."""
    from mxnet_tpu_torch import trainplane

    made, orig = [], trainplane.module_plane

    def keep(module):
        plane = orig(module)
        made.append(plane)
        return plane

    trainplane.module_plane = keep
    return made, orig


def _fit_custom(args):
    """``custom_softmax_rtc.run(args)``; returns its readings, the planes
    its fit made, and the plane counters' moves during it."""
    from mxnet_tpu_torch import trainplane
    from mxnet_tpu_torch.example.numpy_ops import custom_softmax_rtc as cr

    before = _plane_counts()
    made, orig = _planes_made()
    try:
        res = cr.run(args)
    finally:
        trainplane.module_plane = orig
    after = _plane_counts()
    demoted = {k: v - before[0].get(k, 0.0) for k, v in after[0].items()
               if v != before[0].get(k, 0.0)}
    return res, made, demoted, after[1] - before[1], after[2] - before[2]


def custom_rtc():
    """The extension slice's main path: the symbolic MLP with the rtc
    softmax op, through Module.fit on the module plane (one captured step
    a batch, the rtc kernels inside the graph), score and predict on the
    card; then the same graph with the numpy op from the same seed, which
    must demote at its first pass (it reads back to the host): the first
    batch's outputs and updated weights must agree, both must learn, and
    the rtc kernels must launch on every pass, counted through the graph
    replays. The counted launches of a few plane steps are held against
    the profiler's; the rtc op's eager step (MXNET_TRAINSTEP=0, the path
    before the plane) is timed beside it."""
    import torch

    from mxnet_tpu_torch import rtc
    from mxnet_tpu_torch.example.numpy_ops import custom_softmax_rtc as cr

    cr.kernels(torch.device("cuda", torch.cuda.current_device()))  # compile
    args = cr.parse_args([])  # the defaults: the card, the rtc op
    _reset_launches()
    res, made, demoted, graph_steps, opt = _fit_custom(args)
    launches = rtc.Kernel.total_launches
    plane = made[0] if made else None
    if plane is None or demoted or graph_steps != res["train_batches"] \
            or opt != 0 or plane.compile_count != 1:
        fail("custom_rtc: the rtc op's fit did not run on the graph plane: "
             "plane %s, demotions %s, %d graph steps for %d batches, %d "
             "optimizer dispatches, %s captures"
             % (plane, demoted, graph_steps, res["train_batches"], opt,
                plane and plane.compile_count))
    ref, ref_made, ref_demoted, _, _ = _fit_custom(
        cr.parse_args(["--op", "np_softmax_ce"]))
    if ref_made != [None] or \
            ref_demoted != {"module-trace: MXNetError": 1.0}:
        fail("custom_rtc: the numpy op did not demote with its reason: "
             "planes %s, demotions %s" % (ref_made, ref_demoted))
    errs = {"prob": float(np.abs(res["first"]["prob"]
                                 - ref["first"]["prob"]).max())}
    for name, v in res["first"]["params"].items():
        errs[name] = float(np.abs(v - ref["first"]["params"][name]).max())
    worst = max(errs.values())
    if not worst <= CUSTOM_TOL:
        fail("custom_rtc: the rtc op and the numpy op differ after the "
             "first batch: %s" % errs)
    for r in (res, ref):
        if not r["learned"]:
            fail("custom_rtc: %s reached accuracy %.3f, not above 0.9"
                 % (r["op"], r["score"]))
    need = 2 * res["train_batches"] + res["test_batches"]
    if launches < need:
        fail("custom_rtc: rtc kernels launched %d times for %d training and "
             "%d test batches" % (launches, res["train_batches"],
                                  res["test_batches"]))
    batch = next(iter(_rtc_train_iter(args)))
    counted, sessions, prof = _traced_rtc_steps(plane, batch, "custom_rtc")
    os.environ["MXNET_TRAINSTEP"] = "0"
    try:
        eager, eager_made, _, _, _ = _fit_custom(args)
    finally:
        del os.environ["MXNET_TRAINSTEP"]
    if eager_made != [None]:
        fail("custom_rtc: MXNET_TRAINSTEP=0 made a plane")
    phase("custom_rtc", plane="graph", train_batches=res["train_batches"],
          test_batches=res["test_batches"], graph_steps=graph_steps,
          opt_dispatches=opt, captures=plane.compile_count,
          rtc_launches=launches, launches_per_replay={
              k._name: v for k, v in plane._paths[
                  next(iter(plane._paths))].launches.items()},
          traced_steps=RTC_TRACE_STEPS, traced_launches_counted=counted,
          traced_launches_seen=sessions,
          numpy_demoted=ref_demoted,
          first_batch_max_abs_err=worst, tol=CUSTOM_TOL,
          rtc_score=res["score"], numpy_score=ref["score"],
          rtc_predict_acc=res["pred_acc"], numpy_predict_acc=ref["pred_acc"],
          rtc_step_ms=res["step_ms"], numpy_step_ms=ref["step_ms"],
          rtc_eager_step_ms=eager["step_ms"], rtc_eager_score=eager["score"],
          plane_profile={k: v for k, v in prof.items()
                         if k != "kernel_events"})
    return launches, prof["kernel_device_ms_per_step"]


def _traced_rtc_steps(plane, batch, what):
    """The rtc launches counted over RTC_TRACE_STEPS steps of the module
    ``plane`` on ``batch``, against the profiler's kernel events over
    those steps; each session first runs one plane step of its own, not
    read (a session has come back one kernel event short, the first rtc
    kernel's, PERF.md), and a short session is traced again, five at
    most. Returns (launches counted, the sessions' events, the last
    profile)."""
    from mxnet_tpu_torch import rtc

    sessions = []
    for _ in range(5):
        marks = []
        prof = _device_profile(
            lambda: plane.step(batch), RTC_TRACE_STEPS, count=RTC_KERNELS,
            warm=1, mark=lambda: marks.append(rtc.Kernel.total_launches))
        counted = rtc.Kernel.total_launches - marks[0]
        sessions.append(prof["kernel_events"])
        if counted != 2 * RTC_TRACE_STEPS:
            fail("%s: %d plane steps counted %d rtc launches"
                 % (what, RTC_TRACE_STEPS, counted))
        if sum(prof["kernel_events"].values()) == counted:
            return counted, sessions, prof
    fail("%s: %d plane steps counted %d rtc launches, the profiler saw %s"
         % (what, RTC_TRACE_STEPS, counted, sessions))


def _rtc_train_iter(args):
    """The example's training iterator over its own data (the first
    batch is what the traced plane steps replay)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.example.numpy_ops import custom_softmax

    with mx.gpu(0):
        rs = np.random.RandomState(19)
        xtr, ytr = custom_softmax.make_data(args.train_size, rs)
        return mx.io.NDArrayIter(xtr, ytr, args.batch_size)


def _lenet_symbol():
    """Convolution, BatchNorm, relu, max pool, FullyConnected(10),
    SoftmaxOutput."""
    from mxnet_tpu_torch import sym

    net = sym.Convolution(sym.var("data"), kernel=(5, 5), num_filter=20,
                          name="conv1")
    net = sym.BatchNorm(net, name="bn1")
    net = sym.Activation(net, act_type="relu", name="relu1")
    net = sym.Pooling(net, kernel=(2, 2), stride=(2, 2), pool_type="max",
                      name="pool1")
    net = sym.FullyConnected(net, num_hidden=10, name="fc1")
    return sym.SoftmaxOutput(net, name="softmax")


def module_plane_parity():
    """PLANE_STEPS steps of the module plane (one captured step a batch)
    against as many eager forward_backward + update steps from the same
    weights on the same batches, on the card, with cuDNN's deterministic
    algorithms (its default weight-gradient kernels accumulate with
    atomics, so two eager runs differ): weights, momentum and the
    BatchNorm moving statistics bit for bit (or within PLANE_TOL, with
    the largest difference printed); one capture and no recapture. The
    same two runs with cuDNN's default algorithms are printed beside,
    with two eager runs for scale."""
    import torch

    deterministic = torch.backends.cudnn.deterministic
    try:
        torch.backends.cudnn.deterministic = False
        default = dict(graph_vs_eager=_plane_runs(True),
                       eager_vs_eager=_plane_runs(False))
        torch.backends.cudnn.deterministic = True
        out = _plane_runs(True)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    plane, errs, equal, steps, opt = out
    if max(errs.values()) > PLANE_TOL or plane.compile_count != 1 or \
            steps != PLANE_STEPS or opt != 0:
        fail("module_plane_parity: max errors %s, %d captures, %d graph "
             "steps, %d optimizer dispatches"
             % (errs, plane.compile_count, steps, opt))
    phase("module_plane_parity", steps=PLANE_STEPS, batch=PLANE_BATCH,
          cudnn_deterministic=True, bitwise_equal=equal, max_abs_err=errs,
          tol=PLANE_TOL, captures=plane.compile_count, graph_steps=steps,
          cudnn_default={k: {"bitwise_equal": v[2], "max_abs_err": v[1]}
                         for k, v in default.items()})


def _plane_runs(graph):
    """PLANE_STEPS steps of two modules from the same weights on the same
    batches: the first on the module plane if ``graph``, else eagerly,
    the second eagerly. Returns (the plane or None, the largest
    differences by kind, whether every tensor is equal, graph steps,
    optimizer dispatches of the first)."""
    import torch

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import io, trainplane

    rs = np.random.RandomState(0)
    xs = rs.rand(PLANE_STEPS * PLANE_BATCH, 1, 28, 28).astype(np.float32)
    ys = rs.randint(0, 10, PLANE_STEPS * PLANE_BATCH).astype(np.float32)
    mods, src = [], (None, None)
    for _ in range(2):  # the second module copies the first's weights
        with mx.gpu(0):
            it = io.NDArrayIter(xs, ys, PLANE_BATCH)
            mod = mx.module.Module(_lenet_symbol())
            mod.bind(it.provide_data, it.provide_label)
            mx.random.seed(0)
            mod.init_params(mx.initializer.Xavier(), arg_params=src[0],
                            aux_params=src[1])
            mod.init_optimizer(optimizer="sgd",
                               optimizer_params=dict(PLANE_SGD))
            src = mod.get_params()
        mods.append((mod, it))
    plane = None
    if graph:
        os.environ["MXNET_TRAINSTEP"] = "1"  # a demotion logs its error
        try:
            before = _plane_counts()
            plane = trainplane.module_plane(mods[0][0])
        finally:
            del os.environ["MXNET_TRAINSTEP"]
        if plane is None:
            fail("module_plane_parity: the plane declined the module: %s"
                 % {k: v - before[0].get(k, 0.0)
                    for k, v in _plane_counts()[0].items()
                    if v != before[0].get(k, 0.0)})
    before = _plane_counts()
    for batch in mods[0][1]:
        if plane is not None:
            plane.step(batch)
        else:
            mods[0][0].forward_backward(batch)
            mods[0][0].update()
    after = _plane_counts()
    mod_e = mods[1][0]
    for batch in mods[1][1]:
        mod_e.forward_backward(batch)
        mod_e.update()
    torch.cuda.synchronize()
    errs = {"weights": 0.0, "momentum": 0.0, "moving_stats": 0.0}
    equal = True
    (ga, gx), (ea, ex) = mods[0][0].get_params(), mod_e.get_params()
    pairs = [("weights", ga[k]._data, ea[k]._data) for k in ga]
    pairs += [("moving_stats", gx[k]._data, ex[k]._data) for k in gx]
    for i, st in mods[0][0]._updater.states.items():
        pairs.append(("momentum", st, mod_e._updater.states[i]))
    for key, a, b in pairs:
        equal = equal and torch.equal(a, b)
        errs[key] = max(errs[key], float((a - b).abs().max()))
    return (plane, errs, equal, after[1] - before[1],
            after[2] - before[2] - (0 if graph else PLANE_STEPS))


def _flops_per_image(net, x):
    """The forward's FLOPs an image (convolutions and products, counted
    by torch.utils.flop_counter from their shapes)."""
    from torch.utils.flop_counter import FlopCounterMode

    from mxnet_tpu_torch import autograd

    counter = FlopCounterMode(display=False)
    with counter, autograd.pause():
        net(x)
    return counter.get_total_flops() / x.shape[0]


def zoo_score():
    """benchmark_score.py's networks on the card: for each, in fp32 at
    batch 32 (and 1 for ZOO_BATCH1's nets; in bf16 at 32 for the script's
    default sweep),
    img/s of the eager hybridized forward (the script's own build and
    timed loop) and of parallel.InferStep (a CUDA graph a shape), whose
    output must agree with the eager forward's (fp32: ZOO_TOL; bf16: one
    bf16 step of the largest output); GFLOP an image, the share of the
    bound and the peak memory of each; the top device operations of one
    fp32 InferStep call at batch 32."""
    import torch

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd, parallel
    from mxnet_tpu_torch.example.image_classification import (
        benchmark_score as bs)

    ctx = mx.gpu(0)
    runs = [(n, "float32", b) for n in ZOO_NETS
            for b in ((32, 1) if n in ZOO_BATCH1 else (32,))]
    runs += [(n, "bfloat16", 32) for n in bs.DEFAULT_NETS]
    gflop = {}
    t_phase = time.perf_counter()
    for name, dtype, batch in runs:
        side = 299 if name == "inception_v3" else 224
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        mx.random.seed(0)
        net, x = bs.build(name, batch, (3, side, side), dtype, ctx,
                          init=mx.initializer.Xavier(
                              rnd_type="gaussian", factor_type="in",
                              magnitude=2))
        if name not in gflop:
            gflop[name] = _flops_per_image(net, x) / 1e9
        eager_ips = bs.score_net(net, x, ZOO_S, ctx)
        with autograd.pause():
            want = net(x)._data.float()
        infer = parallel.InferStep(net, parallel.device_mesh(1))
        got = infer(x)._data.float()
        err = float((got - want).abs().max())
        scale = float(want.abs().max())
        tol = ZOO_TOL * max(1.0, scale) if dtype == "float32" \
            else BF16_RTOL * scale
        if not np.isfinite(scale) or not err <= tol or \
                tuple(got.shape) != (batch, 1000):
            fail("zoo_score %s %s batch %d: InferStep against eager: max "
                 "abs err %.3g (tol %.3g), shape %s"
                 % (name, dtype, batch, err, tol, tuple(got.shape)))
        calls, secs = bs.timed(lambda: infer(x), ZOO_S, ctx)
        infer_ips = calls * batch / secs
        peak = torch.cuda.max_memory_allocated()
        peak_flops = PEAK_FP32_FLOPS if dtype == "float32" \
            else PEAK_BF16_FLOPS
        bound_ms = gflop[name] * 1e9 * batch / peak_flops * 1e3
        fields = {}
        if dtype == "float32" and batch == 32:
            prof = _device_profile(lambda: infer(x), 3)
            fields = dict(busy_share=prof["device_busy_share"],
                          device_ops=prof["device_ops_per_step"],
                          top_device_ms=prof["top_device_ms"][:5])
        phase("zoo_score", model=name, dtype=dtype, batch=batch, side=side,
              eager_img_per_s=eager_ips, inferstep_img_per_s=infer_ips,
              inferstep_max_abs_err=err, output_max_abs=scale, tol=tol,
              gflop_per_img=gflop[name], bound_ms=bound_ms,
              eager_bound_share=bound_ms * eager_ips / batch / 1e3,
              inferstep_bound_share=bound_ms * infer_ips / batch / 1e3,
              peak_memory_gb=peak / 1e9,
              seconds=time.perf_counter() - t0, **fields)
        del net, x, infer, want, got
    phase("zoo_score", runs=len(runs),
          seconds=time.perf_counter() - t_phase)


def rtc_time():
    """The softmax-forward user kernel through Kernel.launch at the
    path's shape and a large one, fp32: host time per launch (CUDA
    events over back-to-back launches), device time (profiler), the
    bound, the plain version and torch.softmax."""
    import torch

    from mxnet_tpu_torch.example.numpy_ops import custom_softmax_rtc as cr
    from mxnet_tpu_torch.ndarray.ndarray import NDArray

    gen = torch.Generator(device="cuda").manual_seed(3)
    entry, worst = None, 0.0
    for rows, cols in RTC_SHAPES:
        x = NDArray(torch.randn(rows, cols, device="cuda", generator=gen))
        y = NDArray(torch.empty(rows, cols, device="cuda"))

        def run():
            cr.softmax_forward(x, y)

        run()
        torch.cuda.synchronize()
        err = float((y._data - cr.softmax_forward_plain(x._data)).abs()
                    .max())
        if not err <= SOFTMAX_TOL:
            fail("softmax_fwd (%d, %d) disagrees with its plain version: max "
                 "abs err %.3g" % (rows, cols, err))
        worst = max(worst, err)
        ms = time_ms(run, iters=200)
        device_ms = kernel_device_ms(run, KERNEL_5, per_call=1)
        plain_ms = time_ms(lambda: cr.softmax_forward_plain(x._data))
        library_ms = time_ms(lambda: torch.softmax(x._data, 1))
        library_device_ms = call_device_ms(lambda: torch.softmax(x._data, 1))
        # read x once, write y once; ~5 fp32 operations an element
        bytes_ms = 2 * rows * cols * 4 / PEAK_BYTES_S * 1e3
        ops_ms = 5 * rows * cols / PEAK_FP32_FLOPS * 1e3
        bound_ms = max(bytes_ms, ops_ms)
        bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
        phase("rtc_time", case="softmax_fwd_%dx%d" % (rows, cols), ms=ms,
              device_ms=device_ms, plain_ms=plain_ms, library_ms=library_ms,
              library_device_ms=library_device_ms, bound_ms=bound_ms,
              bound_by=bound_by, max_abs_err=err, block=cr.fwd_block(cols),
              library="torch.softmax(x, 1)")
        if entry is None:  # the custom_rtc path's shape
            # torch.softmax inside a CUDA graph, as the module plane runs
            # the rtc kernel: the device time of one replay
            torch.softmax(x._data, 1)
            torch.cuda.synchronize()
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                held = torch.softmax(x._data, 1)
            graph.replay()
            torch.cuda.synchronize()
            if not torch.allclose(held, torch.softmax(x._data, 1)):
                fail("torch.softmax in a CUDA graph gave another result")
            library_graph_device_ms = call_device_ms(graph.replay)
            phase("rtc_time", case="softmax_fwd_%dx%d_library_in_graph"
                  % (rows, cols), library_graph_device_ms=(
                      library_graph_device_ms), bound_ms=bound_ms)
            entry = dict(ms=ms, device_ms=device_ms, plain_ms=plain_ms,
                         bound_ms=bound_ms, bound_by=bound_by,
                         library_ms=library_ms,
                         library_device_ms=library_device_ms,
                         library_graph_device_ms=library_graph_device_ms)
    return {"name": "rtc", "route": "nvrtc",
            "source": "mxnet_tpu_torch/example/numpy_ops/"
                      "custom_softmax_rtc.py",
            "replaces": "mxnet_tpu/rtc.py:88", "max_abs_err": worst,
            **entry}


def _reset_launches():
    from mxnet_tpu_torch.ops import flash_attention as fa
    from mxnet_tpu_torch.ops import nms
    from mxnet_tpu_torch.ops import paged_attention as pa

    from mxnet_tpu_torch import rtc

    pa.ragged_paged_attention.launches = 0
    pa.ragged_spec_attention.launches = 0
    fa.flash_attention_forward.launches = 0
    nms.nms_keep_cuda.launches = 0
    rtc.Kernel.total_launches = 0


def _read_launches():
    from mxnet_tpu_torch.ops import paged_attention as pa

    return (pa.ragged_paged_attention.launches,
            pa.ragged_spec_attention.launches)


def _check_oracle(model, params, reqs, outs, what):
    """Every output equals the no-cache oracle on the card. On a
    mismatch, print the oracle's top-2 logit gap at the first divergent
    position (a near-tie there points at rounding, a wide gap at a bug)
    and fail."""
    import torch

    bad = []
    for i, ((p, m), got) in enumerate(zip(reqs, outs)):
        ref = model.reference_generate(params, p, m)
        if got.shape == ref.shape and np.array_equal(got, ref):
            continue
        bad.append(i)
        if len(bad) == 1:
            n = min(len(got), len(ref))
            j = next((k for k in range(n) if got[k] != ref[k]), n)
            logits = model.reference_logits(
                params, np.concatenate([p, ref[:j]]))[-1]
            top = torch.topk(logits, 2).values.tolist()
            print("first divergence: request %d position %d: got %s, oracle "
                  "%s, oracle top-2 logit gap %.6g"
                  % (i, j, got[j:j + 1].tolist(), ref[j:j + 1].tolist(),
                     top[0] - top[1]), flush=True)
    if bad:
        fail("%s: %d of %d outputs differ from the oracle (requests %s)"
             % (what, len(bad), len(reqs), bad[:8]))


def serve(contract=True):
    """The main path: submit -> admission -> prefill -> ticks -> fetch.
    ``contract=False`` only measures (no oracle, graph or floor check):
    what ``--serve-time`` runs against another checkout's package."""
    import torch

    from mxnet_tpu_torch import serving

    model = serving.TinyDecoder(**MODEL)
    params = model.init_params(0)  # no device given: the card
    rng = np.random.RandomState(0)
    system = rng.randint(1, MODEL["vocab_size"], SYSTEM_LEN)
    reqs = []
    for i in range(N_REQ):
        p = rng.randint(1, MODEL["vocab_size"], int(rng.randint(4, 24)))
        if i % 3 == 1:  # a third of the traffic shares a system prompt
            p = np.concatenate([system, p])
        reqs.append((p.astype(np.int32), min(OUT_MIX[i % len(OUT_MIX)],
                                             OUT_CAP)))
    wave = [rng.randint(1, MODEL["vocab_size"], int(rng.randint(4, 24)))
            for _ in range(SLOTS)]
    outs, stats, wall, (launches, _spec), ticks, graphs, prof = _serve_run(
        model, params, reqs, "chip_smoke", ("decode", wave, 64), contract,
        prefill_buckets=(8, 16, 32), prefix_cache=True)
    if stats["device"].split(":")[0] != "cuda":
        fail("the engine ran on %s, not the card" % stats["device"])
    hits = stats["kvcache"]["prefix_hits"]  # warmup hits nothing
    if contract:
        if launches < ticks * MODEL["num_layers"]:
            fail("paged-attention kernel launched %d times for %d ticks x "
                 "%d layers" % (launches, ticks, MODEL["num_layers"]))
        if hits < 1 or stats["prefill_chunks"] < 1:
            fail("no prefix-cache hit ran the q_pos kernel path")
        _check_oracle(model, params, reqs, outs, "serve")
    tokens = int(sum(len(o) for o in outs))
    phase("serve", requests=len(reqs), tokens=tokens, wall_s=wall,
          tokens_per_s=tokens / wall, ttft_p50_ms=stats["ttft_p50_ms"],
          tpot_p50_ms=stats["tpot_p50_ms"], ticks=ticks,
          kernel_launches=launches, prefix_hits=hits,
          prefill_chunks=stats["prefill_chunks"],
          outputs_equal_oracle=contract or None, max_mem_gib=torch.cuda.
          max_memory_allocated() / 2 ** 30, **graphs, **prof)
    return launches


def _serve_run(model, params, reqs, name, profile, contract=True, **kw):
    """One engine over ``reqs``: warm up, set the kernels' counts to 0,
    serve every request, read the counts; then, unless ``profile`` is
    None, trace one more wave, ``profile`` = (case, prompts, new tokens).
    Returns (outputs, stats, wall seconds, (paged_attention launches, spec
    launches), ticks, the fields of ``_graph_fields`` (none without
    ``contract``), the traced wave's fields)."""
    from mxnet_tpu_torch import serving

    eng = serving.DecodeEngine(
        model, params, num_slots=SLOTS, max_seq_len=MAX_SEQ,
        page_size=PAGE, timeout_ms=0, name=name, **kw)
    try:
        warm = eng.warmup()
        before = eng.stats()
        _reset_launches()
        t0 = time.perf_counter()
        outs = [f.result(timeout=600)
                for f in [eng.submit(p, m) for p, m in reqs]]
        wall = time.perf_counter() - t0
        launches = _read_launches()
        stats = eng.stats()
        prof = {}
        if profile is not None:
            case, prompts, new_tokens = profile
            prof = profile_ticks(eng, prompts, new_tokens=new_tokens,
                                 case=case)
    finally:
        eng.close()
    graphs = _graph_fields(name, warm, before, stats) if contract else {}
    return (outs, stats, wall, launches, stats["ticks"] - before["ticks"],
            graphs, prof)


def _graph_fields(what, warm, before, stats):
    """The compile-once contract of one served run: every device path was
    captured at warmup (``compile_count`` still ``warm``, no
    steady-state recompile) and the traffic ran from graph replays."""
    replays = stats["graph_replays"] - before["graph_replays"]
    steady = stats.get("steady_state_recompiles")
    if steady != 0 or stats["compile_count"] != warm:
        fail("%s: %s steady-state recompiles (compile_count %d, %d at "
             "warmup)" % (what, steady, stats["compile_count"], warm))
    if replays < 1:
        fail("%s: the traffic ran no CUDA graph replay" % what)
    return dict(compile_count=stats["compile_count"],
                steady_state_recompiles=steady, graph_replays=replays)


def spec_serve(model, params, contract=True):
    """The bench's speculative phase at full width, served three ways
    (``contract=False``: measured only, as in ``serve``)."""
    rng = np.random.RandomState(2)
    reqs = []
    for _ in range(SPEC_N):
        # repetitive-motif prompts: the traffic prompt lookup is built for
        motif = rng.randint(1, MODEL["vocab_size"], 4).astype(np.int32)
        reqs.append((np.concatenate([motif, motif, motif[:2]]), SPEC_OUT))
    layers = MODEL["num_layers"]
    runs = {}
    spec_launches = 0
    for key, k, draft in (("spec_off", 0, None),
                          ("accept_all", SPEC_K, "model"),
                          ("prompt_lookup", SPEC_K, "prompt_lookup")):
        # accept-all is not traced: its draft re-runs the dense model on
        # the host, about 10^4 launches a tick, so a trace measures the
        # draft, not the engine, and the profiler drops records of such
        # a session (36 of 40 kernel-2 launches in two runs)
        outs, st, wall, (one, spec), ticks, graphs, prof = _serve_run(
            model, params, reqs, "chip_smoke_" + key,
            None if key == "accept_all" else
            (key, [p for p, _m in reqs[:SLOTS]], SPEC_OUT), contract,
            prefill_buckets=(8, 16), spec_k=k, spec_draft=draft)
        sp = st["speculative"]
        if k and spec < ticks * layers:
            fail("%s: spec kernel launched %d times for %d verify ticks x "
                 "%d layers" % (key, spec, ticks, layers))
        if not k and one < ticks * layers:
            fail("%s: paged-attention kernel launched %d times for %d ticks "
                 "x %d layers" % (key, one, ticks, layers))
        spec_launches += spec
        tokens = int(sum(len(o) for o in outs))
        runs[key] = outs
        phase("spec_serve", run=key, k=k, draft=draft, requests=len(reqs),
              tokens=tokens, wall_s=wall, tokens_per_s=tokens / wall,
              ttft_p50_ms=st["ttft_p50_ms"], tpot_p50_ms=st["tpot_p50_ms"],
              ticks=ticks, acceptance_rate=sp["acceptance_rate"],
              accepted_per_tick=sp["accepted_per_tick"],
              proposed_tokens=sp["proposed_tokens"],
              paged_attention_launches=one, spec_kernel_launches=spec,
              **graphs, **prof)
        if key == "accept_all" and not sp["accepted_per_tick"] > 1.0:
            fail("accept_all committed %.3f tokens per slot-tick (> 1 "
                 "expected)" % sp["accepted_per_tick"])
    for key in ("accept_all", "prompt_lookup"):
        diff = [i for i, (a, b) in enumerate(zip(runs["spec_off"],
                                                 runs[key]))
                if not np.array_equal(a, b)]
        if diff:
            fail("%s outputs differ from spec_off (requests %s)"
                 % (key, diff[:8]))
    if contract:
        _check_oracle(model, params, reqs, runs["spec_off"], "spec_serve")
    phase("spec_serve", outputs_equal_across_runs=True,
          outputs_equal_oracle=contract or None)
    return spec_launches


def chunked_serve(model, params, contract=True):
    """The bench's shared-prefix phase with chunked prefill at full
    width: outputs equal the oracle, prefill runs in 64-token chunks
    (``contract=False``: measured only, as in ``serve``)."""
    rng = np.random.RandomState(1)
    systems = [rng.randint(1, MODEL["vocab_size"], SP_SYS_LEN).astype(
        np.int32) for _ in range(SP_SYSTEMS)]
    reqs = []
    for i in range(SP_N):
        suffix = rng.randint(1, MODEL["vocab_size"],
                             int(rng.randint(2, 6))).astype(np.int32)
        reqs.append((np.concatenate([systems[i % SP_SYSTEMS], suffix]),
                     SP_OUT))
    outs, st, wall, (one, spec), ticks, graphs, prof = _serve_run(
        model, params, reqs, "chip_smoke_chunked",
        ("chunked", [p for p, _m in reqs[:SLOTS]], SP_OUT), contract,
        prefill_buckets=(16, 32), prefix_cache=True, prefill_chunk=SP_CHUNK)
    layers = MODEL["num_layers"]
    if st["prefill_chunks"] < 1:
        fail("chunked_serve ran no prefill chunk")
    if one < (ticks + st["prefill_chunks"]) * layers:
        fail("chunked_serve: paged-attention kernel launched %d times for "
             "%d ticks + %d chunks x %d layers"
             % (one, ticks, st["prefill_chunks"], layers))
    if contract:
        _check_oracle(model, params, reqs, outs, "chunked_serve")
    tokens = int(sum(len(o) for o in outs))
    phase("chunked_serve", requests=len(reqs), tokens=tokens, wall_s=wall,
          tokens_per_s=tokens / wall, ttft_p50_ms=st["ttft_p50_ms"],
          ttft_p99_ms=st["ttft_p99_ms"], tpot_p50_ms=st["tpot_p50_ms"],
          ticks=ticks, prefill_chunks=st["prefill_chunks"],
          prefix_hits=st["kvcache"]["prefix_hits"],
          paged_attention_launches=one, spec_kernel_launches=spec,
          outputs_equal_oracle=contract or None, **graphs, **prof)


def train():
    """The training slice's main path: the port's train_gpt example at its
    defaults on the card; it must learn and run the flash kernel."""
    from mxnet_tpu_torch.example.transformer import train_gpt
    from mxnet_tpu_torch.ops import flash_attention as fa

    args = train_gpt.parse_args([])  # the defaults: the card
    _reset_launches()
    res = train_gpt.run(args)
    launches = fa.flash_attention_forward.launches
    if not res["learned"]:
        fail("train: test perplexity %.2f is not below 0.2 x %d"
             % (res["test_ppl"], train_gpt.VOCAB))
    if launches < res["steps"] * args.layers:
        fail("train: flash kernel launched %d times for %d steps x %d "
             "layers" % (launches, res["steps"], args.layers))
    phase("train", steps=res["steps"], layers=args.layers,
          batch=args.batch_size, train_s=res["train_s"],
          steps_per_s=res["steps_per_s"], tokens_per_s=res["tokens_per_s"],
          epoch_train_ppl=res["epoch_train_ppl"], test_ppl=res["test_ppl"],
          uniform_ppl=res["uniform_ppl"], flash_launches=launches)
    return launches


def _gpt_on_card(layers=2):
    """The example's full-width GPT on the card with seed-7 weights, its
    deferred shapes resolved, and the first training batch."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import nd
    from mxnet_tpu_torch.example.transformer import train_gpt

    mx.random.seed(7)
    net = train_gpt.GPT(layers=layers)
    net.initialize(mx.initializer.Xavier())  # no ctx given: the card
    x, y = train_gpt.make_corpus(32, np.random.RandomState(29))
    pos = np.broadcast_to(np.arange(train_gpt.SEQ, dtype=np.int32),
                          (32, train_gpt.SEQ)).copy()
    batch = (nd.array(x), nd.array(y), nd.array(pos))
    net(batch[0], batch[2])
    return net, batch


def _train_step(net, lossfn, batch, trainer=None):
    from mxnet_tpu_torch import autograd

    x, y, pos = batch
    with autograd.record():
        loss = lossfn(net(x, pos), y)
    loss.backward()
    if trainer is not None:
        trainer.step(1)
    return loss


def train_parity():
    """One step from the same weights, through the kernel and then with
    the registered op's fcompute swapped for the plain version."""
    import torch

    from mxnet_tpu_torch.gluon import loss as gloss
    from mxnet_tpu_torch.ops import flash_attention as fa
    from mxnet_tpu_torch.ops.registry import get_op

    net, batch = _gpt_on_card()
    lossfn = gloss.SoftmaxCrossEntropyLoss(axis=2)
    params = list(net.collect_params().values())
    op = get_op("_contrib_flash_attention")
    runs = []
    kernel_fcompute = op.fcompute
    try:
        for plain in (False, True):
            if plain:
                op.fcompute = lambda attrs, q, k, v: \
                    fa.flash_attention_reference(q, k, v, attrs.scale,
                                                 attrs.causal)
            _reset_launches()
            loss = _train_step(net, lossfn, batch)
            torch.cuda.synchronize()
            runs.append((loss.asnumpy(), [p.grad().asnumpy()
                                          for p in params],
                         fa.flash_attention_forward.launches))
    finally:
        op.fcompute = kernel_fcompute
    (l_k, g_k, n_k), (l_p, g_p, n_p) = runs
    if n_k < 2 or n_p != 0:
        fail("train_parity: %d kernel launches in the kernel run, %d in the "
             "plain run" % (n_k, n_p))
    loss_err = float(np.abs(l_k - l_p).max())
    grad_err = max(float(np.abs(a - b).max()) for a, b in zip(g_k, g_p))
    # fp32, the kernel's and the plain version's sums in other orders:
    # the CPU parity tests' tolerances (loss 2e-5, gradients 1e-4)
    if loss_err > 2e-5 or grad_err > 1e-4:
        fail("train_parity: loss err %.3g, gradient err %.3g"
             % (loss_err, grad_err))
    phase("train_parity", loss=float(l_k.mean()), loss_max_abs_err=loss_err,
          grad_max_abs_err=grad_err, loss_tol=2e-5, grad_tol=1e-4,
          kernel_launches=n_k, params=len(params))


def train_profile(steps=10):
    """Where a training step's time goes: 10 steps of the full-width GPT
    traced with torch.profiler (device activity only)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from mxnet_tpu_torch.gluon import Trainer, loss as gloss

    net, batch = _gpt_on_card()
    lossfn = gloss.SoftmaxCrossEntropyLoss(axis=2)
    trainer = Trainer(net.collect_params(), "adam", {"learning_rate": 3e-3})
    for _ in range(3):  # warm up
        _train_step(net, lossfn, batch, trainer)
    torch.cuda.synchronize()
    before = _opt_dispatches()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            _train_step(net, lossfn, batch, trainer)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    after = _opt_dispatches()
    by_name = {}  # device op name -> [ms, launches]
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            row = by_name.setdefault(e.name, [0.0, 0])
            row[0] += e.time_range.elapsed_us() / 1e3
            row[1] += 1
    busy_ms = sum(ms for ms, _ in by_name.values())
    if busy_ms <= 0.0:
        fail("the profiler saw no device time in the traced steps")
    flash_ms = sum(ms for k, (ms, _) in by_name.items() if KERNEL_3 in k)
    if flash_ms <= 0.0:
        fail("train_profile: the profiler saw no device time of %s in the "
             "traced steps" % KERNEL_3)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    phase("train_profile", steps=steps, wall_ms=wall_ms,
          per_step_wall_ms=wall_ms / steps, device_busy_ms=busy_ms,
          per_step_busy_ms=busy_ms / steps,
          device_busy_share=busy_ms / wall_ms, flash_ms=flash_ms,
          flash_share_of_busy=flash_ms / busy_ms,
          device_kernels_per_step=sum(n for _, n in by_name.values())
          / steps,
          opt_dispatches={k: after[k] - before[k] for k in after},
          # [name (long enough to show the functor), ms, launches]
          top_device_ms=[[k[:140], ms, n] for k, (ms, n) in top])


def profile_ticks(eng, reqs, new_tokens=64, case="decode"):
    """Where a tick's time goes: one wave of requests that fills every
    slot, traced with torch.profiler (device activity, and the CUDA
    runtime calls the host made). Prints the wave's wall time, tokens/s,
    the device's busy time (the kernels and copies of one stream do not
    overlap, so their durations add up), the attention kernels' share of
    it, and the host's launches per tick (kernel and graph launches, then
    copies and fills, as the runtime recorded them); the engine's TPOT
    p50 is over its whole life. Cross-checks the launch counts the wrappers
    and graph replays kept in the wave against the kernels the profiler
    saw: it fails if the profiler shows no launch of a kernel that was
    counted (the profiler does not see inside graph replays), more than
    were counted, or fewer by more than it has been seen to lose in a
    session (one launch in 20). Returns the fields the serving phase
    prints."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    ticks0 = eng.stats()["ticks"]
    counted0 = _read_launches()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        tokens = sum(len(f.result(timeout=600)) for f in
                     [eng.submit(p, new_tokens) for p in reqs])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    stats = eng.stats()
    ticks = stats["ticks"] - ticks0
    counted = [a - b for a, b in zip(_read_launches(), counted0)]
    by_name, seen, host = {}, [0, 0], {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + \
                e.time_range.elapsed_us() / 1e3
            # one split kernel a kernel-1 launch; kernel 2 is one kernel
            seen[0] += "paged_attention_split_kernel" in e.name
            seen[1] += KERNEL_2 in e.name
        elif e.name.startswith("cu"):  # a CUDA API call of the host
            host[e.name] = host.get(e.name, 0) + 1
    busy_ms = sum(by_name.values())
    if busy_ms <= 0.0:
        fail("the profiler saw no device time in the traced wave")
    for kernel, n_seen, n_counted in zip(("kernel 1", "kernel 2"), seen,
                                         counted):
        if n_counted and not n_seen:
            fail("%s: the profiler shows no %s launch of the %d counted in "
                 "the traced wave's graph replays" % (case, kernel,
                                                      n_counted))
        if n_seen > n_counted or n_seen < n_counted - max(1, n_counted // 20):
            fail("%s: the profiler saw %d %s launches, the counts say %d"
                 % (case, n_seen, kernel, n_counted))
    paged_by_kernel = {}
    for k, v in by_name.items():
        if KERNEL_1 in k:
            k = k[k.find(KERNEL_1):].split("(")[0]
            paged_by_kernel[k] = paged_by_kernel.get(k, 0.0) + v
    paged_ms = sum(paged_by_kernel.values())
    spec_ms = sum(v for k, v in by_name.items() if KERNEL_2 in k)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    launches = sum(n for k, n in host.items() if "Launch" in k)
    copies = sum(n for k, n in host.items()
                 if "Memcpy" in k or "Memset" in k)
    per_tick = max(ticks, 1)
    out = dict(device_busy_share=busy_ms / wall_ms,
               host_launches_per_tick=launches / per_tick if host else None,
               host_copies_per_tick=copies / per_tick if host else None)
    phase("tick_profile", case=case, requests=len(reqs), ticks=ticks,
          tokens=tokens, tokens_per_s=tokens / wall_ms * 1e3,
          tpot_p50_ms=stats["tpot_p50_ms"], wall_ms=wall_ms,
          device_busy_ms=busy_ms, **out,
          host_calls=dict(sorted(host.items(), key=lambda kv: -kv[1])[:8]),
          kernel_launches_counted=counted, kernel_launches_seen=seen,
          paged_attention_ms=paged_ms,
          paged_attention_share_of_busy=paged_ms / busy_ms,
          paged_attention_ms_by_kernel=paged_by_kernel,
          spec_attention_ms=spec_ms,
          spec_attention_share_of_busy=spec_ms / busy_ms,
          per_tick_wall_ms=wall_ms / per_tick,
          per_tick_busy_ms=busy_ms / per_tick,
          top_device_ms=[[k[:60], v] for k, v in top])
    return out


def _opt_dispatches():
    """The optimizer-update calls so far by path; empty for a package
    from before the fused apply (``--profiles`` in an older checkout)."""
    try:
        from mxnet_tpu_torch.telemetry import OPT_DISPATCHES
    except ImportError:
        return {}
    return {p: OPT_DISPATCHES.value(path=p) for p in ("fused", "perparam")}


def _device_profile(run, steps, count=(), warm=0, mark=None):
    """torch.profiler (device activity and the host's CUDA runtime calls)
    over ``steps`` runs of ``run()``: wall ms, device busy ms, device
    operations, host launches and copies, each per step, the top device
    operations [name, ms a step, launches a step], and with ``count`` the
    device events whose name contains each of its strings. With ``warm``,
    that many runs go first inside the same session, followed by a
    synchronisation and ``mark()``, and only the device events that start
    after them are read (the first rtc kernel of a session has gone
    unrecorded: PERF.md §7)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    # the host's activity too when a range must mark the traced steps
    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if warm else [])
    with profile(activities=acts) as prof:
        for _ in range(warm):
            run()
        torch.cuda.synchronize()
        if mark is not None:
            mark()
        with record_function("chip_smoke.traced_steps"):
            t0 = time.perf_counter()
            for _ in range(steps):
                run()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.events()
    start = min((e.time_range.start for e in events
                 if e.name == "chip_smoke.traced_steps"), default=None)
    if warm and start is None:
        fail("the profiler recorded no range of the traced steps")
    by_name, host = {}, {}
    for e in events:
        if warm and e.time_range.start < start:
            continue
        if e.device_type == DeviceType.CUDA:
            row = by_name.setdefault(e.name, [0.0, 0])
            row[0] += e.time_range.elapsed_us() / 1e3
            row[1] += 1
        elif e.name.startswith("cu"):  # a CUDA API call of the host
            host[e.name] = host.get(e.name, 0) + 1
    busy_ms = sum(ms for ms, _ in by_name.values())
    if busy_ms <= 0.0:
        fail("the profiler saw no device time in the traced steps")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    counted = {c: sum(n for k, (_, n) in by_name.items() if c in k)
               for c in count}
    counted_ms = {c: sum(ms for k, (ms, _) in by_name.items() if c in k)
                  / steps for c in count}
    return dict(**({"kernel_events": counted,
                    "kernel_device_ms_per_step": counted_ms}
                   if count else {}),
        steps=steps, per_step_wall_ms=wall_ms / steps,
        per_step_busy_ms=busy_ms / steps, device_busy_share=busy_ms / wall_ms,
        device_ops_per_step=sum(n for _, n in by_name.values()) / steps,
        host_launches_per_step=sum(
            n for k, n in host.items() if "Launch" in k) / steps,
        host_copies_per_step=sum(
            n for k, n in host.items()
            if "Memcpy" in k or "Memset" in k) / steps,
        top_device_ms=[[k[:120], ms / steps, n / steps]
                       for k, (ms, n) in top])


def _resnet50(seed=0):
    """resnet50_v1 on the card, Uniform weights drawn after
    ``mx.random.seed(seed)``, its deferred shapes resolved."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import nd
    from mxnet_tpu_torch.gluon.model_zoo import vision

    mx.random.seed(seed)
    net = vision.resnet50_v1(classes=RESNET_CLASSES)
    net.initialize()  # no ctx given: the card
    net(nd.array(np.zeros((1, 3, 64, 64), np.float32)))
    return net


def _resnet_data(k):
    """bench.py's data: K batches of images and labels from
    RandomState(0)."""
    rng = np.random.RandomState(0)
    xs = rng.rand(k, RESNET_BATCH, 3, RESNET_SIDE,
                  RESNET_SIDE).astype(np.float32)
    ys = rng.randint(0, RESNET_CLASSES, (k, RESNET_BATCH))
    return xs, ys


def fused_apply():
    """The fused optimizer apply on resnet50_v1's trainable parameters
    with random gradients, for SGD (momentum 0.9, wd 1e-4) and Adam: two
    fused applies and two passes of the per-parameter loop (what
    MXNET_FASTPATH=0 runs) from the same state must give the same bits;
    each path's device kernels and device ms an apply (profiler) and host
    ms an apply."""
    import torch

    from mxnet_tpu_torch import fastpath, optimizer as opt
    from mxnet_tpu_torch.ndarray.ndarray import NDArray

    net = _resnet50()
    params = list(net.collect_params().values())
    train_params = [p for p in params if p.grad_req != "null"]
    gen = torch.Generator(device="cuda").manual_seed(5)
    grads = [torch.randn(p.shape, device="cuda", generator=gen)
             for p in train_params]
    fields = dict(params=len(params), trainable=len(train_params),
                  values=sum(p.data().size for p in train_params))
    for name, kw in (("sgd", dict(learning_rate=0.05, momentum=0.9,
                                  wd=1e-4)),
                     ("adam", dict(learning_rate=1e-3, wd=1e-4))):
        runs = {}
        for path in ("fused", "perparam"):
            upd = opt.get_updater(opt.create(name, **kw))
            ws = [NDArray(p.data()._data.detach().clone())
                  for p in train_params]
            triples = [(i, NDArray(g), w)
                       for i, (g, w) in enumerate(zip(grads, ws))]
            if path == "fused":
                def apply(upd=upd, triples=triples):
                    fastpath.apply_updater(upd, triples)
            else:
                def apply(upd=upd, triples=triples):
                    for t in triples:
                        upd(*t)
            apply()
            apply()
            torch.cuda.synchronize()
            leaves = [w._data for w in ws]
            for i in range(len(ws)):
                s = upd.states[i]
                leaves += list(s) if isinstance(s, tuple) else [s]
            runs[path] = (leaves, apply)
        for a, b in zip(runs["fused"][0], runs["perparam"][0]):
            if not torch.equal(a, b):
                fail("fused_apply %s: the fused apply and the per-parameter "
                     "loop differ (max %.3g)"
                     % (name, float((a - b).abs().max())))
        for path, (_, apply) in runs.items():
            events = _profiled_us(apply, 5, lambda n: True)
            fields["%s_%s" % (name, path)] = dict(
                device_kernels=sum(n for _, n in events.values()) / 5,
                device_ms=sum(us for us, _ in events.values()) / 1e3 / 5,
                host_ms=host_ms(apply, iters=20))
    phase("fused_apply", bitwise_equal=True, **fields)


def resnet_parity():
    """One captured TrainStep step of resnet50_v1 at bench.py's shapes
    against the same step run eagerly (``capture=False``) from the same
    weights: loss, every weight, the momentum states and the BatchNorm
    moving statistics within RESNET_TOL; then InferStep's captured output
    against the net's eager inference forward. Returns the eager step's
    FLOPs (convolutions and products, forward and backward, counted by
    torch.utils.flop_counter from their shapes)."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from mxnet_tpu_torch import autograd, gluon, nd, parallel

    xs, ys = _resnet_data(1)
    x, y = nd.array(xs[0]), nd.array(ys[0])
    steps = [parallel.TrainStep(
        _resnet50(), gluon.loss.SoftmaxCrossEntropyLoss(), "sgd",
        parallel.device_mesh(1), optimizer_params=dict(RESNET_SGD),
        capture=capture) for capture in (True, False)]
    loss_g = float(steps[0](x, y).asnumpy())
    counter = FlopCounterMode(display=False)
    with counter:
        loss_e = float(steps[1](x, y).asnumpy())
    flops = counter.get_total_flops()
    if steps[0].compile_count != 1 or steps[0].graph_replays != 1:
        fail("resnet_parity: %d captures, %d replays"
             % (steps[0].compile_count, steps[0].graph_replays))
    errs = {"weights": 0.0, "momentum": 0.0, "moving_stats": 0.0}
    # the two nets' names differ in their prefix only: same order
    for (n, v), w in zip(steps[0].params.items(),
                         steps[1].params.values()):
        key = "moving_stats" if n.endswith(("running_mean", "running_var")) \
            else "weights"
        errs[key] = max(errs[key], float((v - w).detach().abs().max()))
    for a, b in zip(steps[0]._states, steps[1]._states):
        errs["momentum"] = max(errs["momentum"], float((a - b).abs().max()))
    loss_err = abs(loss_g - loss_e)
    if not np.isfinite(loss_g) or loss_err > RESNET_TOL or \
            max(errs.values()) > RESNET_TOL:
        fail("resnet_parity: loss %.6g vs %.6g, max errors %s"
             % (loss_g, loss_e, errs))
    net = steps[1].copy_to_net()
    del steps
    infer = parallel.InferStep(net, parallel.device_mesh(1))
    got = infer(x).asnumpy()
    with autograd.pause():
        want = net(x).asnumpy()
    infer_err = float(np.abs(got - want).max())
    if infer_err > RESNET_TOL or infer.compile_count != 1:
        fail("resnet_parity: InferStep differs from the net's forward by "
             "%.3g (%d captures)" % (infer_err, infer.compile_count))
    torch.cuda.synchronize()
    phase("resnet_parity", model="resnet50_v1", batch=RESNET_BATCH,
          side=RESNET_SIDE, classes=RESNET_CLASSES, loss=loss_g,
          loss_abs_err=loss_err, max_abs_err=errs, infer_max_abs_err=infer_err,
          tol=RESNET_TOL, step_gflop=flops / 1e9)
    return flops


def resnet_train(flops):
    """bench.py's headline on the card: TrainStep.multi_call at K = 16,
    batch 32, SGD 0.05 with momentum 0.9; a warm call (the capture), then
    calls for RESNET_TRAIN_S seconds ending in a synchronize. Every call's
    mean loss must be finite and the last below the first (the 16 batches
    come back every call), with one capture and no recapture; then
    InferStep.multi_call at K = 16. The bound is the step's FLOPs over
    the card's fp32 rate (TF32 is off)."""
    import torch

    from mxnet_tpu_torch import gluon, nd, parallel

    xs, ys = _resnet_data(RESNET_K)
    data, labels = nd.array(xs), nd.array(ys)
    del xs
    net = _resnet50()
    step = parallel.TrainStep(net, gluon.loss.SoftmaxCrossEntropyLoss(),
                              "sgd", parallel.device_mesh(1),
                              optimizer_params=dict(RESNET_SGD))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    losses = [step.multi_call(data, labels)]
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    calls = 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < RESNET_TRAIN_S:
        losses.append(step.multi_call(data, labels))
        calls += 1
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    means = [float(v.asnumpy().mean()) for v in losses]
    if step.compile_count != 1 or step.steady_state_recompiles != 0:
        fail("resnet_train: %d captures, %d steady-state recompiles"
             % (step.compile_count, step.steady_state_recompiles))
    if step.graph_replays != RESNET_K * (calls + 1):
        fail("resnet_train: %d graph replays for %d calls"
             % (step.graph_replays, calls + 1))
    if not all(np.isfinite(means)) or not means[-1] < means[0]:
        fail("resnet_train: call mean losses %s" % means)
    step_ms = wall * 1e3 / (calls * RESNET_K)
    bound_ms = flops / PEAK_FP32_FLOPS * 1e3
    phase("resnet_train", model="resnet50_v1", batch=RESNET_BATCH,
          side=RESNET_SIDE, k=RESNET_K, calls=calls, wall_s=wall,
          img_per_s=RESNET_K * RESNET_BATCH * calls / wall, step_ms=step_ms,
          warm_call_s=warm_s, compile_count=step.compile_count,
          steady_state_recompiles=step.steady_state_recompiles,
          graph_replays=step.graph_replays, call_mean_losses=means,
          peak_memory_gb=peak / 1e9, step_gflop=flops / 1e9,
          fp32_bound_ms=bound_ms, bound_share=bound_ms / step_ms)
    step.copy_to_net()
    del step
    infer = parallel.InferStep(net, parallel.device_mesh(1))
    infer.multi_call(data)
    torch.cuda.synchronize()
    calls = 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < RESNET_INFER_S:
        out = infer.multi_call(data)
        calls += 1
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if not np.isfinite(out.asnumpy()).all() or \
            infer.steady_state_recompiles != 0:
        fail("resnet_train: InferStep output not finite, or recaptured")
    phase("resnet_infer", model="resnet50_v1", batch=RESNET_BATCH, k=RESNET_K,
          calls=calls, wall_s=wall,
          img_per_s=RESNET_K * RESNET_BATCH * calls / wall,
          compile_count=infer.compile_count)


def resnet_profile(steps=5):
    """Where a resnet50_v1 training step's time goes at bench.py's shapes,
    traced with torch.profiler: (a) the eager path, autograd.record,
    backward and Trainer.step through the fused apply; (b) the captured
    TrainStep; (c) the captured TrainStep of the net cast to bf16."""
    from mxnet_tpu_torch import autograd, gluon, nd, parallel

    xs, ys = _resnet_data(1)
    x, y = nd.array(xs[0]), nd.array(ys[0])
    lossfn = gluon.loss.SoftmaxCrossEntropyLoss()
    net = _resnet50()
    trainer = gluon.Trainer(net.collect_params(), "sgd", dict(RESNET_SGD))

    def eager():
        with autograd.record():
            loss = lossfn(net(x), y)
        loss.backward()
        trainer.step(RESNET_BATCH)

    for _ in range(3):  # warm up
        eager()
    before = _opt_dispatches()
    out = {"eager": _device_profile(eager, steps)}
    after = _opt_dispatches()
    out["eager"]["opt_dispatches"] = {k: after[k] - before[k] for k in after}
    if out["eager"]["opt_dispatches"]["fused"] != steps:
        fail("resnet_profile: the eager steps did not run the fused apply "
             "once a step: %s" % out["eager"]["opt_dispatches"])
    del trainer, net
    step = parallel.TrainStep(_resnet50(), lossfn, "sgd",
                              parallel.device_mesh(1),
                              optimizer_params=dict(RESNET_SGD))
    for _ in range(3):
        step(x, y)
    out["captured"] = _device_profile(lambda: step(x, y), steps)
    del step
    xb = x.astype("bfloat16")
    step = parallel.TrainStep(_resnet50_bf16(), lossfn, "sgd",
                              parallel.device_mesh(1),
                              optimizer_params=dict(RESNET_SGD))
    for _ in range(3):
        step(xb, y)
    out["captured_bf16"] = _device_profile(lambda: step(xb, y), steps)
    phase("resnet_profile", model="resnet50_v1", batch=RESNET_BATCH, **out)


def _swap_env(env):
    """Set ``env``; returns what to give :func:`_restore_env`."""
    prev = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    return prev


def _restore_env(prev):
    for k, v in prev.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v


def _bf16_err(a, b):
    """max |a - b| over max |b|, as float32."""
    a, b = a.detach().float(), b.detach().float()
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)


def _resnet50_bf16(seed=0):
    net = _resnet50(seed)
    net.cast("bfloat16")
    return net


def _plane_run(batch, graph, xs, ys, steps=0, seconds=0.0):
    """A fresh resnet50_v1 through ``TrainPlane`` under
    MXNET_TRAIN_DTYPE=bf16 (``graph`` False: MXNET_TRAINSTEP=0): one step
    (the activation and capture), then ``steps`` steps or steps for
    ``seconds``; returns (plane, the first step's loss, steps timed, wall
    s)."""
    import torch

    from mxnet_tpu_torch import gluon, nd, trainplane

    prev = _swap_env({"MXNET_TRAIN_DTYPE": "bf16",
                      "MXNET_TRAINSTEP": "1" if graph else "0"})
    try:
        net = _resnet50()
        trainer = gluon.Trainer(net.collect_params(), "sgd",
                                dict(RESNET_SGD))
        plane = trainplane.TrainPlane(net, gluon.loss.SoftmaxCrossEntropyLoss(),
                                      trainer)
        x, y = nd.array(xs[:batch]), nd.array(ys[:batch])
        first = plane.step(x, y)
        torch.cuda.synchronize()
        n = 0
        t0 = time.perf_counter()
        while n < steps or time.perf_counter() - t0 < seconds:
            plane.step(x, y)
            n += 1
        torch.cuda.synchronize()
        return plane, first, n, time.perf_counter() - t0
    finally:
        _restore_env(prev)


def resnet_bf16_parity():
    """bf16 (``Block.cast``): one captured TrainStep step against the
    same step run eagerly from the same weights; then the training
    plane's graph step against its eager plane in bf16 mode."""
    import torch

    from mxnet_tpu_torch import gluon, nd, parallel

    xs, ys = _resnet_data(1)
    x, y = nd.array(xs[0]).astype("bfloat16"), nd.array(ys[0])
    steps = [parallel.TrainStep(
        _resnet50_bf16(), gluon.loss.SoftmaxCrossEntropyLoss(), "sgd",
        parallel.device_mesh(1), optimizer_params=dict(RESNET_SGD),
        capture=capture) for capture in (True, False)]
    losses = [s(x, y)._data for s in steps]
    if steps[0].compile_count != 1 or steps[0].graph_replays != 1:
        fail("resnet_bf16_parity: %d captures, %d replays"
             % (steps[0].compile_count, steps[0].graph_replays))
    errs = {"loss": _bf16_err(losses[0], losses[1]), "weights": 0.0,
            "momentum": 0.0, "moving_stats": 0.0}
    dtypes = set()
    for (n, v), w in zip(steps[0].params.items(),
                         steps[1].params.values()):
        key = "moving_stats" if n.endswith(("running_mean", "running_var")) \
            else "weights"
        errs[key] = max(errs[key], _bf16_err(v, w))
        dtypes.add(str(v.dtype))
    for a, b in zip(steps[0]._states, steps[1]._states):
        errs["momentum"] = max(errs["momentum"], _bf16_err(a, b))
        dtypes.add("state " + str(a.dtype))
    loss = float(losses[0].float())
    del steps
    if not np.isfinite(loss) or max(errs.values()) > BF16_RTOL or \
            dtypes != {"torch.bfloat16", "state torch.float32"}:
        fail("resnet_bf16_parity: TrainStep captured vs eager: loss %.6g, "
             "relative errors %s, dtypes %s" % (loss, errs, dtypes))
    runs = [_plane_run(RESNET_BATCH, graph, xs[0], ys[0])
            for graph in (True, False)]
    (pg, lg, _, _), (pe, le, _, _) = runs
    if pg.plane != "graph" or pe.plane != "eager":
        fail("resnet_bf16_parity: planes %s / %s" % (pg.plane, pe.plane))
    plane_errs = {"loss": _bf16_err(lg._data, le._data), "weights": 0.0,
                  "masters": 0.0}
    for pa, pb in zip(pg._net.collect_params().values(),
                      pe._net.collect_params().values()):
        plane_errs["weights"] = max(plane_errs["weights"], _bf16_err(
            pa.data()._data, pb.data()._data))
    sg, se = pg._trainer._updater.states, pe._trainer._updater.states
    for i in sg:
        plane_errs["masters"] = max(plane_errs["masters"],
                                    _bf16_err(sg[i][0], se[i][0]))
    if max(plane_errs.values()) > BF16_RTOL:
        fail("resnet_bf16_parity: TrainPlane graph vs eager: relative "
             "errors %s" % plane_errs)
    del runs, pg, pe
    torch.cuda.synchronize()
    phase("resnet_bf16_parity", model="resnet50_v1", batch=RESNET_BATCH,
          loss=loss, trainstep_rel_err=errs, plane_rel_err=plane_errs,
          tol=BF16_RTOL)


def _timed_calls(fn, seconds):
    """Call ``fn`` for ``seconds`` (after one warm call), ending in a
    synchronize; returns (calls, wall s, the last result)."""
    import torch

    out = fn()
    torch.cuda.synchronize()
    calls = 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        out = fn()
        calls += 1
    torch.cuda.synchronize()
    return calls, time.perf_counter() - t0, out


def resnet_bf16_train(flops):
    """bench.py's train_bf16 and infer_bf16: the bf16 net's
    TrainStep.multi_call at K = 16, batch 32, and InferStep.multi_call,
    as resnet_train runs the fp32 one."""
    import torch

    from mxnet_tpu_torch import gluon, nd, parallel

    xs, ys = _resnet_data(RESNET_K)
    data, labels = nd.array(xs).astype("bfloat16"), nd.array(ys)
    del xs
    net = _resnet50_bf16()
    step = parallel.TrainStep(net, gluon.loss.SoftmaxCrossEntropyLoss(),
                              "sgd", parallel.device_mesh(1),
                              optimizer_params=dict(RESNET_SGD))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    losses = [step.multi_call(data, labels)]
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    calls = 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < RESNET_TRAIN_S:
        losses.append(step.multi_call(data, labels))
        calls += 1
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    means = [float(v._data.float().mean()) for v in losses]
    if step.compile_count != 1 or step.steady_state_recompiles != 0:
        fail("resnet_bf16_train: %d captures, %d steady-state recompiles"
             % (step.compile_count, step.steady_state_recompiles))
    if not all(np.isfinite(means)) or not means[-1] < means[0]:
        fail("resnet_bf16_train: call mean losses %s" % means)
    if any(v.dtype != torch.bfloat16 for v in step.params.values()):
        fail("resnet_bf16_train: a weight left bfloat16")
    step_ms = wall * 1e3 / (calls * RESNET_K)
    bound_ms = flops / PEAK_BF16_FLOPS * 1e3
    phase("resnet_bf16_train", model="resnet50_v1", batch=RESNET_BATCH,
          side=RESNET_SIDE, k=RESNET_K, calls=calls, wall_s=wall,
          img_per_s=RESNET_K * RESNET_BATCH * calls / wall, step_ms=step_ms,
          warm_call_s=warm_s, compile_count=step.compile_count,
          steady_state_recompiles=step.steady_state_recompiles,
          graph_replays=step.graph_replays, call_mean_losses=means,
          peak_memory_gb=peak / 1e9, step_gflop=flops / 1e9,
          bf16_bound_ms=bound_ms, bound_share=bound_ms / step_ms)
    step.copy_to_net()
    del step
    infer = parallel.InferStep(net, parallel.device_mesh(1))
    calls, wall, out = _timed_calls(lambda: infer.multi_call(data),
                                    RESNET_INFER_S)
    if out._data.dtype != torch.bfloat16 or \
            not torch.isfinite(out._data).all() or \
            infer.steady_state_recompiles != 0:
        fail("resnet_bf16_infer: output not bfloat16 and finite, or "
             "recaptured")
    phase("resnet_bf16_infer", model="resnet50_v1", batch=RESNET_BATCH,
          k=RESNET_K, calls=calls, wall_s=wall,
          img_per_s=RESNET_K * RESNET_BATCH * calls / wall,
          compile_count=infer.compile_count)


def resnet_percall():
    """bench.py's train_percall and infer_fp32_percall: one
    TrainStep.__call__ and one InferStep.__call__ a batch, fp32."""
    from mxnet_tpu_torch import gluon, nd, parallel

    xs, ys = _resnet_data(1)
    x, y = nd.array(xs[0]), nd.array(ys[0])
    net = _resnet50()
    step = parallel.TrainStep(net, gluon.loss.SoftmaxCrossEntropyLoss(),
                              "sgd", parallel.device_mesh(1),
                              optimizer_params=dict(RESNET_SGD))
    t_calls, t_wall, loss = _timed_calls(lambda: step(x, y),
                                         RESNET_PERCALL_S)
    if step.steady_state_recompiles != 0 or \
            not np.isfinite(float(loss.asnumpy())):
        fail("resnet_percall: the step recaptured or its loss is not "
             "finite")
    step.copy_to_net()
    del step
    infer = parallel.InferStep(net, parallel.device_mesh(1))
    i_calls, i_wall, _ = _timed_calls(lambda: infer(x), RESNET_PERCALL_S)
    phase("resnet_percall", model="resnet50_v1", batch=RESNET_BATCH,
          train_calls=t_calls, train_img_per_s=RESNET_BATCH * t_calls
          / t_wall, train_step_ms=t_wall * 1e3 / t_calls,
          infer_calls=i_calls,
          infer_img_per_s=RESNET_BATCH * i_calls / i_wall)


def resnet_fused_opt():
    """bench.py's train_fused_opt: the hybridized fp32 net under the eager
    loop (record, backward, Trainer.step) at batch 32; exactly one fused
    optimizer dispatch a step."""
    from mxnet_tpu_torch import autograd, gluon, nd

    xs, ys = _resnet_data(1)
    x, y = nd.array(xs[0]), nd.array(ys[0])
    lossfn = gluon.loss.SoftmaxCrossEntropyLoss()
    net = _resnet50()
    net.hybridize()
    trainer = gluon.Trainer(net.collect_params(), "sgd", dict(RESNET_SGD),
                            kvstore="device")
    steps = [0]

    def step():
        steps[0] += 1
        with autograd.record():
            loss = lossfn(net(x), y)
        loss.backward()
        trainer.step(RESNET_BATCH)
        return loss

    step()
    before = _opt_dispatches()
    steps[0] = 0
    calls, wall, loss = _timed_calls(step, RESNET_PERCALL_S)
    after = _opt_dispatches()
    per_step = {k: (after[k] - before[k]) / steps[0] for k in after}
    if per_step != {"fused": 1.0, "perparam": 0.0}:
        fail("resnet_fused_opt: optimizer dispatches a step %s" % per_step)
    if not np.isfinite(loss.asnumpy()).all():
        fail("resnet_fused_opt: loss not finite")
    phase("resnet_fused_opt", model="resnet50_v1", batch=RESNET_BATCH,
          steps=calls, wall_s=wall, img_per_s=RESNET_BATCH * calls / wall,
          step_ms=wall * 1e3 / calls, opt_dispatches_per_step=per_step)


def train_plane_bf16(flops):
    """bench.py's mfu_train_bf16: TrainPlane in bf16 mode (fp32 master
    weights) at batches 32, 64, 128 and 256, with bench's gate
    (``bench.py:2458-2470``): the graph plane, exactly one step dispatch
    a step and no optimizer dispatch in the timed window."""
    import torch

    from mxnet_tpu_torch import telemetry

    gflop_img = flops / RESNET_BATCH / 1e9
    rng = np.random.RandomState(0)
    xs = rng.rand(max(PLANE_BATCHES), 3, RESNET_SIDE,
                  RESNET_SIDE).astype(np.float32)
    ys = rng.randint(0, RESNET_CLASSES, (max(PLANE_BATCHES),))
    sweep = []
    for batch in PLANE_BATCHES:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fb0 = sum(r["value"] for r in
                  telemetry.TRAINPLANE_FALLBACKS.series())
        g0 = telemetry.STEP_DISPATCHES.value(plane="graph")
        o0 = _opt_dispatches()
        plane, first, n, wall = _plane_run(batch, True, xs, ys,
                                           steps=3, seconds=PLANE_S)
        graph_steps = telemetry.STEP_DISPATCHES.value(plane="graph") - g0
        o1 = _opt_dispatches()
        opt_steps = sum(o1[k] - o0[k] for k in o1)
        fb = sum(r["value"] for r in
                 telemetry.TRAINPLANE_FALLBACKS.series()) - fb0
        states = plane._trainer._updater.states
        weights_bf16 = all(p.data()._data.dtype == torch.bfloat16
                           for p in plane._net.collect_params().values())
        masters_fp32 = all(s[0].dtype == torch.float32
                           for s in states.values())
        entry = dict(batch=batch, steps=n, wall_s=wall,
                     img_per_s=batch * n / wall,
                     step_ms=wall * 1e3 / n, plane=plane.plane,
                     dispatches_per_step=(graph_steps - 1) / n,
                     opt_dispatches=opt_steps, fallbacks=fb,
                     compile_count=plane.compile_count,
                     first_loss=float(first._data.float().mean()),
                     peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
        bound_ms = gflop_img * batch / (PEAK_BF16_FLOPS / 1e9) * 1e3
        entry.update(bf16_bound_ms=bound_ms,
                     bound_share=bound_ms / entry["step_ms"])
        sweep.append(entry)
        del plane, states
        if entry["plane"] != "graph" or entry["dispatches_per_step"] != 1.0 \
                or opt_steps != 0 or fb != 0 or entry["compile_count"] != 1 \
                or not (weights_bf16 and masters_fp32) \
                or not np.isfinite(entry["first_loss"]):
            fail("train_plane_bf16: bench's gate at batch %d: %s (weights "
                 "bf16 %s, masters fp32 %s)"
                 % (batch, entry, weights_bf16, masters_fp32))
    best = max(sweep, key=lambda e: e["img_per_s"])
    phase("train_plane_bf16", model="resnet50_v1", gflop_per_img=gflop_img,
          sweep=sweep, best_batch=best["batch"],
          best_img_per_s=best["img_per_s"])


def remat_memory():
    """TrainStep(remat=False) against TrainStep(remat=True) on the same
    fp32 net and batch: memory_analysis()'s temp of each and the
    losses."""
    import torch

    from mxnet_tpu_torch import gluon, nd, parallel

    xs, ys = _resnet_data(1)
    x, y = nd.array(xs[0]), nd.array(ys[0])
    out = {}
    for remat in (False, True):
        step = parallel.TrainStep(
            _resnet50(), gluon.loss.SoftmaxCrossEntropyLoss(), "sgd",
            parallel.device_mesh(1), optimizer_params=dict(RESNET_SGD),
            remat=remat)
        loss = float(step(x, y).asnumpy())
        stats = step.memory_analysis()
        out[remat] = dict(loss=loss, temp_gb=stats.temp_size_in_bytes / 1e9,
                          argument_gb=stats.argument_size_in_bytes / 1e9,
                          alias_gb=stats.alias_size_in_bytes / 1e9)
        del step
        torch.cuda.synchronize()
    err = abs(out[True]["loss"] - out[False]["loss"])
    if err > RESNET_TOL or not np.isfinite(out[False]["loss"]):
        fail("remat_memory: losses %s" % out)
    phase("remat_memory", model="resnet50_v1", batch=RESNET_BATCH,
          no_remat=out[False], remat=out[True], loss_abs_err=err,
          temp_ratio=out[True]["temp_gb"] / out[False]["temp_gb"])


def _max_err(xs, ys):
    """The largest |x - y| over two lists of tensors, as float32."""
    return max(float((x.detach().float() - y.detach().float()).abs().max())
               for x, y in zip(xs, ys))


def _ckpt_resnet_run(mode):
    """One ``ckpt_resnet`` run in ``mode`` (``fp32`` or ``bf16``, the
    MXNET_TRAIN_DTYPE of TrainPlane); returns its readings."""
    import shutil
    import tempfile

    import torch

    from mxnet_tpu_torch import gluon, nd, trainplane

    prev = _swap_env({"MXNET_TRAIN_DTYPE": mode, "MXNET_TRAINSTEP": "1"})
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        xs, ys = _resnet_data(2 * CKPT_STEPS)
        batches = [(nd.array(x), nd.array(y)) for x, y in zip(xs, ys)]
        del xs, ys
        files = {k: os.path.join(tmp, "resnet50." + k)
                 for k in ("params", "states")}

        def make(seed):
            net = _resnet50(seed)
            trainer = gluon.Trainer(net.collect_params(), "sgd",
                                    dict(RESNET_SGD))
            return trainplane.TrainPlane(
                net, gluon.loss.SoftmaxCrossEntropyLoss(), trainer)

        def steps(plane, lo):
            losses = [plane.step(*batches[k])._data
                      for k in range(lo, lo + CKPT_STEPS)]
            torch.cuda.synchronize()
            return losses

        def held(plane):
            return [t.detach().clone() for t in plane._held()]

        def timed(*calls):
            out = []
            for fn, path in calls:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn(path)
                torch.cuda.synchronize()
                out.append(time.perf_counter() - t0)
            return out

        # run A: 3 steps, save, 3 steps
        a = make(0)
        steps(a, 0)
        save_s = timed((a._net.save_parameters, files["params"]),
                       (a._trainer.save_states, files["states"]))
        loss_a = steps(a, CKPT_STEPS)
        held_a = held(a)
        # run B: a fresh net of other weights and a fresh trainer load
        # both files, then take the same 3 steps
        b = make(1)
        load_s = timed((b._net.load_parameters, files["params"]),
                       (b._trainer.load_states, files["states"]))
        loss_b = steps(b, CKPT_STEPS)
        held_b = held(b)
        # the live plane rewound by the same files: in place, no capture
        captures, ptrs = a.compile_count, a._ptrs()
        rewind_s = timed((a._net.load_parameters, files["params"]),
                         (a._trainer.load_states, files["states"]))
        same_ptrs = a._ptrs() == ptrs
        loss_r = steps(a, CKPT_STEPS)
        held_r = held(a)
        nbytes = {k: os.path.getsize(f) for k, f in files.items()}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        _restore_env(prev)
    equal_b = all(torch.equal(x, y) for x, y in zip(loss_a + held_a,
                                                    loss_b + held_b))
    equal_r = all(torch.equal(x, y) for x, y in zip(loss_a + held_a,
                                                    loss_r + held_r))
    total = sum(nbytes.values())
    out = dict(
        plane_a=a.plane, plane_b=b.plane, held_tensors=len(held_a),
        bytes_params=nbytes["params"], bytes_states=nbytes["states"],
        save_params_s=save_s[0], save_states_s=save_s[1],
        save_mb_per_s=total / sum(save_s) / 1e6,
        load_fresh_params_s=load_s[0], load_fresh_states_s=load_s[1],
        load_fresh_mb_per_s=total / sum(load_s) / 1e6,
        load_live_params_s=rewind_s[0], load_live_states_s=rewind_s[1],
        load_live_mb_per_s=total / sum(rewind_s) / 1e6,
        captures_a=captures, captures_b=b.compile_count,
        captures_after_rewind=a.compile_count, same_ptrs=same_ptrs,
        resumed_bitwise_equal=equal_b, rewound_bitwise_equal=equal_r,
        resumed_max_abs_err=_max_err(loss_a + held_a, loss_b + held_b),
        rewound_max_abs_err=_max_err(loss_a + held_a, loss_r + held_r),
        losses=[float(x.float().mean()) for x in loss_a])
    if not (equal_b and equal_r and same_ptrs and captures == 1
            and b.compile_count == 1 and a.compile_count == captures
            and a.plane == b.plane == "graph"
            and len(held_a) == len(held_b)):
        fail("ckpt_resnet (%s): %s" % (mode, out))
    return out


def ckpt_resnet():
    """bench.py's resnet50_v1 through TrainPlane (fp32, then bf16 with
    float32 masters), with deterministic cuDNN: CKPT_STEPS steps,
    ``save_parameters`` and ``save_states``, CKPT_STEPS more (run A); a
    fresh net of other weights and a fresh Trainer load both files and
    take the same steps (run B), and so does the live plane of A after
    loading them again (in place: the same addresses, no new capture).
    B and the rewound run must equal A bit for bit: losses, weights,
    moving statistics, states and masters."""
    import torch

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        runs = {mode: _ckpt_resnet_run(mode) for mode in ("fp32", "bf16")}
    finally:
        torch.backends.cudnn.deterministic = deterministic
    phase("ckpt_resnet", model="resnet50_v1", batch=RESNET_BATCH,
          side=RESNET_SIDE, steps=CKPT_STEPS, cudnn_deterministic=True,
          **runs)


def _rtc_ckpt_fit(args, prefix, num_epoch, begin_epoch=0, resume=False):
    """The custom_rtc path's ``Module.fit`` (the example's data, seed,
    optimizer and initializer) for epochs ``begin_epoch`` to
    ``num_epoch``: a new module, checkpointing every epoch to ``prefix``
    (with its states) if given, or with ``resume`` the module of ``prefix``'s
    checkpoint at ``begin_epoch`` with its states. Returns the module."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.example.numpy_ops import custom_softmax
    from mxnet_tpu_torch.example.numpy_ops import custom_softmax_rtc as cr

    with mx.gpu(0):
        mx.random.seed(7)
        rs = np.random.RandomState(19)
        xtr, ytr = custom_softmax.make_data(args.train_size, rs)
        train = mx.io.NDArrayIter(xtr, ytr, args.batch_size, shuffle=True)
        callback = None
        if resume:
            mod = mx.module.Module.load(prefix, begin_epoch,
                                        load_optimizer_states=True)
        else:
            mod = mx.module.Module(cr.get_symbol(args.op))
            if prefix is not None:
                callback = mx.callback.module_checkpoint(
                    mod, prefix, save_optimizer_states=True)
        mod.fit(train, eval_metric="acc", optimizer="sgd",
                optimizer_params={"learning_rate": 0.2, "momentum": 0.9,
                                  "rescale_grad": 1.0},
                initializer=mx.initializer.Xavier(), begin_epoch=begin_epoch,
                num_epoch=num_epoch, epoch_end_callback=callback)
    return mod


def _module_tensors(mod):
    """A module's weights, auxiliary states and optimizer states."""
    args, aux = mod.get_params()
    out = [args[k]._data for k in sorted(args)]
    out += [aux[k]._data for k in sorted(aux)]
    for i in sorted(mod._updater.states):
        st = mod._updater.states[i]
        out += list(st) if isinstance(st, (tuple, list)) else [st]
    return out


def ckpt_module_rtc():
    """The custom_rtc path (the rtc kernels inside the module plane's
    graph) at its defaults, with deterministic cuDNN: one epoch with
    ``callback.module_checkpoint(..., save_optimizer_states=True)``, then
    ``Module.load(prefix, 1, load_optimizer_states=True)`` and
    ``fit(begin_epoch=1, num_epoch=2)``; the resumed module must equal an
    uninterrupted 2-epoch fit bit for bit (weights and momentum), its
    plane must capture once, and each replay must launch the two rtc
    kernels, counted and seen by the profiler alike."""
    import shutil
    import tempfile

    import torch

    from mxnet_tpu_torch import rtc, trainplane
    from mxnet_tpu_torch.example.numpy_ops import custom_softmax_rtc as cr

    cr.kernels(torch.device("cuda", torch.cuda.current_device()))  # compile
    args = cr.parse_args([])  # the defaults: the card, the rtc op
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    prefix = os.path.join(tmp, "rtc")
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    made, orig = _planes_made()
    try:
        _reset_launches()
        whole = _rtc_ckpt_fit(args, None, 2)
        _rtc_ckpt_fit(args, prefix, 1)
        files = sorted(os.listdir(tmp))
        resumed = _rtc_ckpt_fit(args, prefix, 2, begin_epoch=1, resume=True)
        torch.cuda.synchronize()
        launches = rtc.Kernel.total_launches
        plane = made[-1]
        if plane is None or any(p is None for p in made):
            fail("ckpt_module_rtc: a fit did not run on the module plane: "
                 "%s" % made)
        per_replay = {k._name: v for k, v in plane._paths[
            next(iter(plane._paths))].launches.items()}
        a, b = _module_tensors(whole), _module_tensors(resumed)
        equal = len(a) == len(b) and all(torch.equal(x, y)
                                         for x, y in zip(a, b))
        err = _max_err(a, b)
        batch = next(iter(_rtc_train_iter(args)))
        counted, sessions, _ = _traced_rtc_steps(plane, batch,
                                                 "ckpt_module_rtc")
    finally:
        trainplane.module_plane = orig
        torch.backends.cudnn.deterministic = deterministic
        shutil.rmtree(tmp, ignore_errors=True)
    want = ["rtc-0001.params", "rtc-0001.states", "rtc-symbol.json"]
    if not equal or plane.compile_count != 1 \
            or sum(per_replay.values()) != 2 \
            or not set(want) <= set(files):
        fail("ckpt_module_rtc: resumed equal %s (max abs err %.3g), %d "
             "captures, launches a replay %s, files %s"
             % (equal, err, plane.compile_count, per_replay, files))
    phase("ckpt_module_rtc", epochs=2, resumed_at=1,
          batch=args.batch_size, samples=args.train_size, files=want,
          resumed_bitwise_equal=equal, max_abs_err=err, tensors=len(a),
          cudnn_deterministic=True, captures=plane.compile_count,
          launches_per_replay=per_replay, rtc_launches=launches,
          traced_steps=RTC_TRACE_STEPS, traced_launches_counted=counted,
          traced_launches_seen=sessions)
    return launches


def ckpt_ssd(res):
    """The SSD module that ssd_train trained, checkpointed after its last
    epoch by ``callback.do_checkpoint``: ``mx.load_checkpoint`` of that
    epoch, a new Module bound for inference, and ``predict`` over the
    dataset (in order, no augmentation) beside the trained module's
    ``predict``, with deterministic cuDNN: every output, the detections
    from the NMS kernel among them, must be equal bit for bit."""
    import shutil

    import torch

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ops import nms

    tmp, rec = _ssd_rec()
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        trained = res["module"]
        prefix, epoch = os.path.join(tmp, "ssd"), len(res["epochs"])
        mx.callback.do_checkpoint(prefix)(epoch - 1, trained.symbol,
                                          *trained.get_params())
        it = mx.image.ImageDetIter(batch_size=8, data_shape=(3, 64, 64),
                                   path_imgrec=rec, mean=True, std=True)
        sym, arg_params, aux_params = mx.load_checkpoint(prefix, epoch)
        loaded = mx.module.Module(sym, data_names=("data",),
                                  label_names=("label",))
        loaded.bind(data_shapes=it.provide_data,
                    label_shapes=it.provide_label, for_training=False)
        loaded.set_params(arg_params, aux_params)
        _reset_launches()
        outs_t = trained.predict(it)
        outs_l = loaded.predict(it)
        torch.cuda.synchronize()
        launches = nms.nms_keep_cuda.launches
        it.reset()
        batches = sum(1 for _ in it)
    finally:
        torch.backends.cudnn.deterministic = deterministic
        shutil.rmtree(tmp, ignore_errors=True)
    equal = [torch.equal(x._data, y._data) for x, y in zip(outs_t, outs_l)]
    det = outs_l[3].asnumpy()
    if not all(equal) or launches < 2 * batches:
        fail("ckpt_ssd: outputs equal %s, %d NMS launches for 2 x %d "
             "batches" % (equal, launches, batches))
    phase("ckpt_ssd", epoch=epoch, batches=batches,
          outputs_bitwise_equal=equal, det_shape=list(det.shape),
          detections=int((det[..., 0] >= 0).sum()),
          cudnn_deterministic=True, nms_launches=launches)
    return launches


def ckpt_phases(ssd_res):
    """The checkpoint phases, ``ssd_res`` being ssd_train's readings.
    Returns the NMS and rtc launches of the phases."""
    ckpt_resnet()
    rtc_launches = ckpt_module_rtc()
    return ckpt_ssd(ssd_res), rtc_launches


def resnet_phases():
    """Every ResNet phase, old and new."""
    fused_apply()
    flops = resnet_parity()
    resnet_train(flops)
    resnet_profile()
    resnet_bf16_parity()
    resnet_bf16_train(flops)
    resnet_percall()
    resnet_fused_opt()
    train_plane_bf16(flops)
    remat_memory()


# ---------------------------------------------------------------------------
# the word language model slice
# ---------------------------------------------------------------------------


def _rel_err(a, b, floor=1.0):
    """max |a - b| over the larger of ``floor`` and b's largest magnitude
    (tensors or numpy arrays)."""
    import torch

    a, b = (v if torch.is_tensor(v) else torch.as_tensor(np.asarray(v))
            for v in (a, b))
    a, b = a.double(), b.double()
    return float((a - b).abs().max()) / max(floor, float(b.abs().max()))


def _rnn_op_run(impl, mode, bidir, ins, heads):
    """One forward and backward of the RNN op through ``impl``: the
    outputs, then the gradients of the data, the flat parameters and the
    initial states under the ``heads`` weighting."""
    import torch

    from mxnet_tpu_torch.ops import nn as ops_nn

    leaves = [t.detach().clone().requires_grad_(True) for t in ins]
    out, ht, ct = ops_nn.rnn_forward(
        mode, leaves[0], leaves[1], leaves[2],
        leaves[3] if mode == "lstm" else None, 2, RNN_OP_HIDDEN,
        bidirectional=bidir, p_dropout=0.0, train=True, impl=impl)
    outs = [out, ht] + ([ct] if mode == "lstm" else [])
    loss = sum((o * w).sum() for o, w in zip(outs, heads))
    return [o.detach() for o in outs] + list(torch.autograd.grad(loss,
                                                                 leaves))


def rnn_op_check():
    """cuDNN's RNN against the plain loop on the card, every mode, uni-
    and bidirectional, then the two paths' times at the LSTM case."""
    import torch

    from mxnet_tpu_torch.ops import nn as ops_nn

    t, n, c = RNN_OP_SHAPE
    h = RNN_OP_HIDDEN
    gen = torch.Generator(device="cuda").manual_seed(16)
    worst = 0.0
    timed = None
    for mode in ("lstm", "gru", "rnn_tanh", "rnn_relu"):
        for bidir in (False, True):
            d = 2 if bidir else 1
            size = ops_nn.rnn_param_size(mode, c, h, 2, bidir)
            k = 1.0 / h ** 0.5

            def rnd(*shape, scale=1.0):
                return torch.randn(*shape, device="cuda",
                                   generator=gen) * scale

            ins = [rnd(t, n, c),
                   (torch.rand(size, device="cuda", generator=gen) * 2
                    - 1) * k, rnd(2 * d, n, h, scale=0.5)]
            if mode == "lstm":
                ins.append(rnd(2 * d, n, h, scale=0.5))
            heads = [rnd(t, n, d * h), rnd(2 * d, n, h)] + (
                [rnd(2 * d, n, h)] if mode == "lstm" else [])
            got = _rnn_op_run("cudnn", mode, bidir, ins, heads)
            want = _rnn_op_run("plain", mode, bidir, ins, heads)
            names = ["out", "h_n"] + (["c_n"] if mode == "lstm" else []) \
                + ["d_data", "d_params", "d_state"] + (
                    ["d_state_cell"] if mode == "lstm" else [])
            errs = {k2: _rel_err(g, w) for k2, g, w in zip(names, got,
                                                          want)}
            held = {k2: v for k2, v in errs.items()
                    if mode != "rnn_relu" or not k2.startswith("d_")}
            fields = {}
            if mode == "rnn_relu":
                # the units whose sign differs between the two forwards
                fields["out_sign_flips"] = int(((got[0] > 0)
                                                != (want[0] > 0)).sum())
                dbl = [x.double() for x in ins]
                hdbl = [x.double() for x in heads]
                errs64 = {k2: _rel_err(g, w) for k2, g, w in zip(
                    names, _rnn_op_run("cudnn", mode, bidir, dbl, hdbl),
                    _rnn_op_run("plain", mode, bidir, dbl, hdbl))}
                fields["errs_float64"] = errs64
                if not max(errs64.values()) <= RNN_OP_TOL_F64:
                    fail("RNN op %s (bidirectional %s): cuDNN and the "
                         "plain loop disagree in float64: %s"
                         % (mode, bidir, errs64))
            err = max(held.values())
            phase("rnn_op_check", mode=mode, bidirectional=bidir,
                  shape=[t, n, c], hidden=h, layers=2, max_rel_err=err,
                  errs=errs, tol=RNN_OP_TOL, **fields)
            if not err <= RNN_OP_TOL:
                fail("RNN op %s (bidirectional %s): cuDNN and the plain "
                     "loop disagree: %s" % (mode, bidir, errs))
            worst = max(worst, err)
            if mode == "lstm" and not bidir:
                timed = (ins, heads)
    ins, heads = timed
    fields = {}
    for impl in ("cudnn", "plain"):
        def run(impl=impl):
            _rnn_op_run(impl, "lstm", False, ins, heads)

        fields[impl + "_ms"] = time_ms(run, iters=5, warm=1)
        fields[impl + "_device_ms"] = call_device_ms(run, iters=3)
    # the same forward and backward through torch.nn.LSTM, whose weights
    # are one buffer in cuDNN's layout (flatten_parameters): what the
    # op's copy of its weight views into such a buffer costs, a call
    lstm = torch.nn.LSTM(c, h, 2).cuda()
    with torch.no_grad():
        packs = ops_nn._unpack_rnn("lstm", ins[1], c, h, 2, 1)
        for layer, pack in enumerate(packs):
            for name, w in zip(("weight_ih", "weight_hh", "bias_ih",
                                "bias_hh"), pack[0]):
                getattr(lstm, "%s_l%d" % (name, layer)).copy_(w)
    lstm.flatten_parameters()

    def run_flat():
        x = ins[0].detach().clone().requires_grad_(True)
        out, (ht, ct) = lstm(x, (ins[2], ins[3]))
        loss = (out * heads[0]).sum() + (ht * heads[1]).sum() \
            + (ct * heads[2]).sum()
        torch.autograd.grad(loss, [x] + list(lstm.parameters()))

    fields["library_ms"] = time_ms(run_flat, iters=5, warm=1)
    fields["library_device_ms"] = call_device_ms(run_flat, iters=3)
    # the matmuls of a forward and backward: 2 x (input and recurrent
    # products) a layer, forward once and backward twice
    flops = 3 * sum(2 * t * n * 4 * h * ((c if layer == 0 else h) + h)
                    for layer in range(2))
    fields["bound_ms"] = flops / PEAK_FP32_FLOPS * 1e3
    phase("rnn_op_time", mode="lstm", shape=[t, n, c], hidden=h, layers=2,
          what="forward and backward", gflop=flops / 1e9,
          bound_by="operations", library="torch.nn.LSTM, flattened weights",
          **fields)
    return worst


def _word_lm_parity_run(ctx, ids, weights=None, steps=3):
    """The example's model (width 650, tied, dropout 0) on ``ctx``:
    ``steps`` of the example's training steps; returns the mean losses,
    the gradient norms and the final weights (numpy, in parameter
    order)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import gluon
    from mxnet_tpu_torch.example.gluon.word_language_model import train as wlm

    bptt, batch = 35, 32
    with ctx:
        mx.random.seed(0)
        model = wlm.RNNModel(WORD_LM_PARITY_VOCAB, 650, 650, 2, 0.0, True)
        model.initialize(mx.initializer.Xavier())
        params = list(model.collect_params().values())
        if weights is not None:
            for p, w in zip(params, weights):
                p.set_data(w)
        trainer = gluon.Trainer(model.collect_params(), "sgd",
                                {"learning_rate": 1.0, "momentum": 0,
                                 "wd": 0})
        loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
        data = wlm.batchify(ids, batch)
        hidden = model.begin_state(func=mx.nd.zeros, batch_size=batch)
        first = [p.data().asnumpy() for p in params]
        losses, norms = [], []
        for step in range(steps):
            x, y = wlm.get_batch(data, step * bptt, bptt)
            loss, hidden, norm = wlm.train_step(model, trainer, loss_fn, x,
                                                y, hidden, 0.25, batch,
                                                bptt)
            losses.append(float(loss.mean().asscalar()))
            norms.append(norm)
        return losses, norms, first, [p.data().asnumpy() for p in params]


def word_lm_parity():
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.example.gluon.word_language_model import train as wlm

    ids, _ = wlm.load_corpus(None, synth_tokens=32 * 35 * 4,
                             synth_vocab=WORD_LM_PARITY_VOCAB)
    t0 = time.perf_counter()
    l_cpu, n_cpu, w0, w_cpu = _word_lm_parity_run(mx.cpu(), ids)
    cpu_s = time.perf_counter() - t0
    l_gpu, n_gpu, _, w_gpu = _word_lm_parity_run(mx.gpu(0), ids, w0)
    loss_err = max(abs(a - b) for a, b in zip(l_gpu, l_cpu))
    norm_err = max(abs(a - b) / max(1.0, abs(b))
                   for a, b in zip(n_gpu, n_cpu))
    w_err = max(float(np.abs(a - b).max()) / max(1.0, float(np.abs(b).max()))
                for a, b in zip(w_gpu, w_cpu))
    phase("word_lm_parity", steps=3, width=650, vocab=WORD_LM_PARITY_VOCAB,
          tied=True, losses_card=l_gpu, losses_cpu=l_cpu,
          grad_norms_card=n_gpu, grad_norms_cpu=n_cpu,
          loss_max_abs_err=loss_err, grad_norm_max_rel_err=norm_err,
          weight_max_rel_err=w_err, tol=WORD_LM_TOL, cpu_s=cpu_s)
    if not max(loss_err, norm_err, w_err) <= WORD_LM_TOL:
        fail("word LM: the card and the CPU disagree (losses %.3g, norms "
             "%.3g, weights %.3g)" % (loss_err, norm_err, w_err))


def word_lm():
    """The medium PTB model through the example's run, then a profile of
    WORD_LM_PROFILE_STEPS more training steps."""
    import torch

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.example.gluon.word_language_model import train as wlm

    args = wlm.parse_args(WORD_LM_ARGS)
    torch.cuda.reset_peak_memory_stats()
    mx.random.seed(0)
    corpus = wlm.load_corpus(None, **WORD_LM_CORPUS)
    res = wlm.run(args, corpus=corpus)
    ppl = res["val_ppl"]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if not (ppl[1] < ppl[0] and max(ppl) < 10000):
        fail("word_lm: validation perplexity %s does not fall below 10,000"
             % (ppl,))
    model, trainer = res["model"], res["trainer"]
    data = res["train_data"]
    state = {"hidden": model.begin_state(func=mx.nd.zeros,
                                         batch_size=args.batch_size),
             "i": 0}

    def step():
        with mx.gpu(0):
            x, y = wlm.get_batch(data, state["i"] * args.bptt, args.bptt)
            loss, state["hidden"], _ = wlm.train_step(
                model, trainer, res["loss_fn"], x, y, state["hidden"],
                args.clip, args.batch_size, args.bptt)
            float(mx.nd.sum(loss).asnumpy())  # the example's own read
            state["i"] += 1

    prof = _device_profile(step, WORD_LM_PROFILE_STEPS)
    phase("word_lm", config="medium PTB: tied, 650/650, 2 layers, dropout "
          "0.5, lr 20, clip 0.25", vocab=res["vocab"],
          corpus_tokens=WORD_LM_CORPUS["synth_tokens"], epochs=args.epochs,
          batch=args.batch_size, bptt=args.bptt, steps=res["steps"],
          train_s=res["train_s"], tokens_per_s=res["tokens_per_s"],
          step_ms=res["step_ms"], val_ppl=ppl, peak_gb=peak_gb,
          profile=prof)


def word_lm_example():
    """The example at its defaults, as a user runs it."""
    here = os.path.dirname(os.path.abspath(__file__))
    script = os.path.join("mxnet_tpu_torch", "example", "gluon",
                          "word_language_model", "train.py")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, script], cwd=here,
                          capture_output=True, text=True, timeout=600)
    secs = time.perf_counter() - t0
    lines = proc.stdout.strip().splitlines()
    phase("word_lm_example", rc=proc.returncode, seconds=secs,
          last=lines[-1] if lines else "")
    if proc.returncode != 0:
        fail("word_lm_example exited %d: %s" % (proc.returncode,
                                               proc.stderr[-2000:]))


def _op_run(op, inputs, attrs, dev, grad, squares=False):
    """The port's op on numpy ``inputs`` on ``dev``: the outputs and the
    gradients of the float inputs under a fixed random weighting of the
    outputs (of their squares with ``squares``: a head that does not
    depend on the signs a solver picks)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd, nd

    ctx = mx.cpu() if dev == "cpu" else mx.gpu(0)
    with ctx:
        arrs = [nd.array(a, dtype=a.dtype) for a in inputs]
        diff = [a for a, x in zip(arrs, inputs)
                if grad and x.dtype == np.float32]
        for a in diff:
            a.attach_grad()
        with autograd.record():
            out = nd.invoke(op, *arrs, **attrs)
            outs = out if isinstance(out, (list, tuple)) else [out]
            head = None
            for k, o in enumerate(outs):
                if not diff or o.dtype != np.float32:
                    continue
                w = nd.array(np.asarray(np.random.RandomState(100 + k)
                                        .randn(*o.shape), np.float32))
                term = ((o * o if squares else o) * w).sum()
                head = term if head is None else head + term
        if head is not None:
            head.backward()
        return [o.asnumpy() for o in outs] + (
            [a.grad.asnumpy() for a in diff] if head is not None else [])


def _op_agree(got, want, rel_tol=None):
    """Whether the card's outputs equal the CPU's: integers exactly,
    floats within ND_OPS_TOL (``rel_tol``: within it of each tensor's
    largest magnitude, at least 1, for cuDNN's RNN against the loop)."""
    for g, w in zip(got, want):
        if g.shape != w.shape or g.dtype != w.dtype:
            return False
        if rel_tol is not None:
            scale = max(1.0, float(np.abs(w).max()))
            if not float(np.abs(g - w).max()) <= rel_tol * scale:
                return False
        elif np.issubdtype(w.dtype, np.floating):
            if not np.allclose(g, w, rtol=ND_OPS_TOL, atol=ND_OPS_TOL,
                               equal_nan=True):
                return False
        elif not np.array_equal(g, w):
            return False
    return len(got) == len(want)


def nd_ops_card():
    """Every name of the slice's op families on the card against the
    port on the CPU, then the samplers."""
    import inspect

    import torch

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import nd
    from mxnet_tpu_torch.ops.registry import OP_REGISTRY

    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "tests"))
    import torch_op_cases as cases

    table = dict(cases.CASES, **cases.NN_CASES)
    for mode in ("lstm", "gru", "rnn_tanh", "rnn_relu"):
        ins, attrs = cases.rnn_case(mode, mode == "gru")
        table["RNN_" + mode] = ("RNN", ins, attrs,
                                {"int": False, "grad": True})
    modules = {"mxnet_tpu_torch.ops.tensor"}
    names = sorted(n for n, o in OP_REGISTRY.items()
                   if inspect.getmodule(o.fcompute).__name__ in modules)
    names += ["SequenceMask", "SequenceLast", "SequenceReverse",
              "_rnn_param_concat", "RNN"]
    by_op = {}
    for key in sorted(table):
        by_op.setdefault(id(OP_REGISTRY[table[key][0]]), []).append(key)
    checked, bad = 0, []
    for name in names:
        for key in by_op.get(id(OP_REGISTRY[name]), []):
            _, specs, attrs, flags = table[key]
            int_form = flags["int"] and any(
                not isinstance(sp, np.ndarray) and sp[0] not in ("idx", "fidx")
                for sp in specs)
            for dtype in ["float32"] + (["int32"] if int_form else []):
                inputs = cases.make_inputs(specs, dtype, seed=11)
                grad = flags["grad"] and dtype == "float32"
                got = _op_run(name, inputs, attrs, "cuda", grad)
                want = _op_run(name, inputs, attrs, "cpu", grad)
                checked += 1
                if not _op_agree(got, want, RNN_OP_TOL if name == "RNN"
                                 else None):
                    bad.append("%s[%s, %s]: max abs err %s" % (
                        name, key, dtype,
                        [float(np.abs(np.asarray(g, np.float64) - w).max())
                         if g.shape == w.shape else "shape"
                         for g, w in zip(got, want)]))
            if name != table[key][0]:
                break  # an alias runs its op's first case
    # the samplers: moments at RANDOM_N draws, replay through the state
    sampled = 0
    with mx.gpu(0):
        for op, (arrays, attrs, _, _) in sorted(cases.RANDOM_CASES.items()):
            params = [nd.array(a) for a in arrays]
            shape = (cases.RANDOM_N,)
            state = mx.random.get_state()
            out = nd.invoke(op, *params, shape=shape, **attrs)
            out = out[0] if isinstance(out, list) else out
            vals = out.asnumpy()
            mx.random.set_state(state)
            again = nd.invoke(op, *params, shape=shape, **attrs)
            again = again[0] if isinstance(again, list) else again
            if not np.array_equal(vals, again.asnumpy()):
                bad.append("%s: no replay after set_state" % op)
            if out._data.device.type != "cuda":
                bad.append("%s: drawn off the card" % op)
            try:
                cases.check_support(op, vals)
                cases.check_moments(op, vals.reshape(-1, cases.RANDOM_N)
                                    if arrays else vals[None])
            except AssertionError as e:
                bad.append("%s: %s" % (op, e))
            sampled += 1
        probs = nd.array(cases.MULTINOMIAL_P)
        draws = nd.random.multinomial(probs, shape=(cases.RANDOM_N,))
        freq = np.stack([(draws.asnumpy() == j).mean(axis=1)
                         for j in range(3)], axis=1)
        if not np.allclose(freq, cases.MULTINOMIAL_P, atol=0.02):
            bad.append("_sample_multinomial: frequencies %s" % freq)
        perm = nd.random.shuffle(nd.arange(1000)).asnumpy()
        if not np.array_equal(np.sort(perm), np.arange(1000)):
            bad.append("_shuffle: not a permutation")
        sampled += 2
    phase("nd_ops_card", names=len(names), checks=checked,
          samplers=sampled, tol=ND_OPS_TOL, failed=bad,
          generator_device=str(mx.random.generator("cuda").device))
    if bad:
        fail("nd_ops_card: the card disagrees with the CPU: %s" % bad)
    return checked


def word_lm_phases():
    rnn_op_check()
    word_lm_parity()
    word_lm()
    word_lm_example()
    nd_ops_card()


# -- the MNIST slice (BASELINE workload 1) ------------------------------------

MNIST_TOL = 1e-5           # the card against the CPU, fp32 with TF32 off
MNIST_ACC = 0.98           # validation accuracy after the default 2 epochs
MNIST_PARITY_STEPS = 5
MNIST_TRACE_STEPS = 10
MNIST_SHORT = ["--num-examples", "6400", "--num-epochs", "1"]
MNIST_OPT_EXAMPLES = 6000
MNIST_OPTIMIZERS = (
    ("sgd", {"momentum": 0.9}), ("ccsgd", {"momentum": 0.9}), ("adam", {}),
    ("nag", {"momentum": 0.9}), ("rmsprop", {"centered": True}),
    ("rmsprop", {}), ("ftrl", {}), ("adadelta", {}), ("adagrad", {}),
    ("adamax", {}), ("ftml", {}), ("nadam", {}), ("sgld", {}),
    ("signum", {"momentum": 0.9}), ("signsgd", {}),
    ("dcasgd", {"momentum": 0.9}), ("lbsgd", {"momentum": 0.9}),
    ("test", {}))
MNIST_OPS = {  # op -> (state inputs after weight and grad, attrs)
    "sgd_update": (0, {"lr": 0.1, "wd": 0.01}),
    "sgd_mom_update": (1, {"lr": 0.1, "momentum": 0.9}),
    "mp_sgd_update": (1, {"lr": 0.1}),
    "mp_sgd_mom_update": (2, {"lr": 0.1, "momentum": 0.9}),
    "adam_update": (2, {"lr": 0.01, "wd": 0.01, "clip_gradient": 0.5}),
    "ftml_update": (3, {"lr": 0.1, "t": 2}),
    "ftrl_update": (2, {"lr": 0.1}),
    "rmsprop_update": (1, {"lr": 0.01}),
    "rmspropalex_update": (3, {"lr": 0.01}),
    "signsgd_update": (0, {"lr": 0.1}),
    "signum_update": (1, {"lr": 0.1, "momentum": 0.9, "wd_lh": 0.01}),
    "_sparse_adagrad_update": (1, {"lr": 0.1}),
}


class _LogLines(object):
    """Collects the root logger's INFO lines while open."""

    def __enter__(self):
        import logging

        self.lines = []
        lines = self.lines

        class _H(logging.Handler):
            def emit(self, record):
                lines.append(record.getMessage())

        self._h = _H(logging.INFO)
        root = logging.getLogger()
        self._level = root.level
        root.addHandler(self._h)
        root.setLevel(logging.INFO)
        return self

    def __exit__(self, *exc):
        import logging

        root = logging.getLogger()
        root.removeHandler(self._h)
        root.setLevel(self._level)
        return False

    def epochs(self, what):
        """``Epoch[k] <what>=v`` values in epoch order."""
        return [float(line.rsplit("=", 1)[1]) for line in self.lines
                if line.startswith("Epoch[") and ("] %s=" % what) in line]

    def monitor_rows(self):
        return [line for line in self.lines if line.startswith("Batch:")]


def _mnist_counts():
    from mxnet_tpu_torch.kvstore import OPS
    from mxnet_tpu_torch.telemetry import STEP_DISPATCHES, TRAINPLANE_FALLBACKS

    return (OPS.value(op="push"), OPS.value(op="pull"),
            TRAINPLANE_FALLBACKS.value(reason="module-config"),
            STEP_DISPATCHES.value(plane="graph"))


def _mnist_main(argv, seed=0):
    """The example's ``main`` on the card (its default device), seeded;
    returns (module, log lines, wall seconds, counter moves)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.example.image_classification import train_mnist

    mx.random.seed(seed)
    before = _mnist_counts()
    with _LogLines() as log:
        t0 = time.perf_counter()
        mod = train_mnist.main(list(argv))
        secs = time.perf_counter() - t0
    after = _mnist_counts()
    moved = dict(zip(("push", "pull", "module_config", "graph_steps"),
                     (a - b for a, b in zip(after, before))))
    return mod, log, secs, moved


def _mnist_batches(n, seed=7, batch=64):
    from mxnet_tpu_torch.example.image_classification import train_mnist

    img, lab = train_mnist._synthetic_mnist(n, seed)
    return [(img[i:i + batch], lab[i:i + batch])
            for i in range(0, n, batch)]


def _mnist_parity_run(ctx, batches, seed=0):
    """MNIST_PARITY_STEPS of the example's Module (mlp, SGD 0.05, momentum
    0.9, wd 1e-4, He init) through a ``KVStoreLocal`` with
    ``update_on_kvstore`` on ``ctx``: the outputs, the weights and the
    store's momentum, as numpy."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.example.image_classification.symbols import mlp

    with ctx:
        mx.random.seed(seed)
        mod = mx.mod.Module(mlp.get_symbol(10), context=ctx)
        mod.bind(data_shapes=[("data", (64, 1, 28, 28))],
                 label_shapes=[("softmax_label", (64,))])
        mod.init_params(mx.initializer.Xavier(
            rnd_type="gaussian", factor_type="in", magnitude=2))
        kv = mx.kv.create("local")
        mod.init_optimizer(kvstore=kv, optimizer="sgd", optimizer_params={
            "learning_rate": 0.05, "momentum": 0.9, "wd": 1e-4})
        outs = []
        for x, y in batches:
            batch = mx.io.DataBatch([mx.nd.array(x)], [mx.nd.array(y)])
            mod.forward_backward(batch)
            mod.update()
            outs.append(mod.get_outputs()[0].asnumpy())
        args, _ = mod.get_params()
        return (outs, {k: v.asnumpy() for k, v in args.items()},
                {k: s.cpu().numpy() for k, s in kv._updater.states.items()},
                mod._update_on_kvstore)


def mnist_parity():
    import mxnet_tpu_torch as mx

    batches = _mnist_batches(64 * MNIST_PARITY_STEPS)
    o_cpu, w_cpu, m_cpu, _ = _mnist_parity_run(mx.cpu(), batches)
    o_gpu, w_gpu, m_gpu, on_kv = _mnist_parity_run(mx.gpu(0), batches)
    err = {
        "outputs": max(float(np.abs(a - b).max())
                       for a, b in zip(o_gpu, o_cpu)),
        "weights": max(float(np.abs(w_gpu[k] - w_cpu[k]).max())
                       for k in w_cpu),
        "momentum": max(float(np.abs(m_gpu[k] - m_cpu[k]).max())
                        for k in m_cpu)}
    phase("mnist_parity", steps=MNIST_PARITY_STEPS, update_on_kvstore=on_kv,
          keys=len(m_cpu), max_abs_err=err, tol=MNIST_TOL)
    if not on_kv or len(m_cpu) != 6:
        fail("mnist_parity: the store did not take the update (%s, %d keys)"
             % (on_kv, len(m_cpu)))
    if not max(err.values()) <= MNIST_TOL:
        fail("mnist_parity: the card and the CPU disagree: %s" % err)


def _mnist_trace(mod, plane=None, n=MNIST_TRACE_STEPS):
    """torch.profiler over ``n`` training steps of the fitted ``mod`` as
    ``fit`` runs them: the eager pair (or ``plane.step``), then the
    metric's update."""
    import mxnet_tpu_torch as mx

    with mx.gpu(0):
        batches = [mx.io.DataBatch([mx.nd.array(x)], [mx.nd.array(y)])
                   for x, y in _mnist_batches(64 * (n + 2), seed=11)]
        metric = mx.metric.create("accuracy")
    state = {"i": 0}

    def step():
        batch = batches[state["i"] % len(batches)]
        state["i"] += 1
        if plane is not None:
            plane.step(batch)
        else:
            mod.forward_backward(batch)
            mod.update()
        mod.update_metric(metric, batch.label)

    step()
    step()
    return _device_profile(step, n)


def _mnist_rates(log, steps_per_epoch, batch=64):
    costs = log.epochs("Time cost")
    return dict(epoch_s=costs,
                img_per_s=[steps_per_epoch * batch / c for c in costs],
                ms_per_step=[1e3 * c / steps_per_epoch for c in costs])


def mnist():
    """The example at its defaults (mlp, 60,000 synthetic examples, 2
    epochs, batch 64, SGD 0.05 momentum 0.9 wd 1e-4, ``--kv-store
    local``) on the card, then a trace of MNIST_TRACE_STEPS of its steps."""
    mod, log, secs, moved = _mnist_main([])
    per_epoch = -(-60000 // 64)
    steps = 2 * per_epoch
    acc = log.epochs("Validation-accuracy")
    rates = _mnist_rates(log, per_epoch)
    prof = _mnist_trace(mod)
    phase("mnist", config="mlp 784-128-64-10, batch 64, 60,000 synthetic "
          "examples, 2 epochs, SGD lr 0.05 momentum 0.9 wd 1e-4, "
          "kv-store local (update_on_kvstore)", steps=steps, seconds=secs,
          val_accuracy=acc, train_accuracy=log.epochs("Train-accuracy"),
          demotions_module_config=moved["module_config"],
          kvstore_push=moved["push"], kvstore_pull=moved["pull"],
          graph_steps=moved["graph_steps"], profile=prof, **rates)
    if len(acc) != 2 or not acc[-1] >= MNIST_ACC:
        fail("mnist: validation accuracy %s below %.2f" % (acc, MNIST_ACC))
    if moved["module_config"] != 1:
        fail("mnist: %s module-config demotions, not 1"
             % moved["module_config"])
    if moved["push"] != steps * 6 or moved["pull"] != steps * 6:
        fail("mnist: kvstore push %s / pull %s, not %d each"
             % (moved["push"], moved["pull"], steps * 6))
    return rates


def mnist_plane(store_rates):
    """The same net, data and schedule through ``Module.fit(kvstore=
    "local")``: one device, so no store, and every step on the module
    plane."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import trainplane
    from mxnet_tpu_torch.example.image_classification import train_mnist

    args = train_mnist.parse_args([])
    made, orig = _planes_made()
    before = _mnist_counts()
    try:
        with mx.gpu(0), _LogLines() as log:
            mx.random.seed(0)
            train, val = train_mnist.get_mnist_iter(args, None)
            mod = mx.mod.Module(train_mnist.get_symbol(args),
                                context=mx.gpu(0))
            sched = mx.lr_scheduler.MultiFactorScheduler(
                step=[(60000 // 64) * 10], factor=0.1)
            t0 = time.perf_counter()
            mod.fit(train, eval_data=val, eval_metric=["accuracy"],
                    kvstore="local", optimizer="sgd",
                    optimizer_params={"learning_rate": 0.05, "wd": 1e-4,
                                      "momentum": 0.9,
                                      "lr_scheduler": sched},
                    initializer=mx.initializer.Xavier(
                        rnd_type="gaussian", factor_type="in", magnitude=2),
                    batch_end_callback=[mx.callback.Speedometer(64, 100)],
                    num_epoch=2)
            secs = time.perf_counter() - t0
    finally:
        trainplane.module_plane = orig
    after = _mnist_counts()
    per_epoch = -(-60000 // 64)
    graph_steps = after[3] - before[3]
    acc = log.epochs("Validation-accuracy")
    rates = _mnist_rates(log, per_epoch)
    plane = made[0] if made else None
    prof = _mnist_trace(mod, plane=plane) if plane is not None else None
    phase("mnist_plane", steps=2 * per_epoch, seconds=secs,
          graph_steps=graph_steps, val_accuracy=acc,
          img_per_s_store=store_rates["img_per_s"], profile=prof, **rates)
    if plane is None or graph_steps != 2 * per_epoch:
        fail("mnist_plane: %s graph steps, not %d" % (graph_steps,
                                                      2 * per_epoch))
    if not acc[-1] >= MNIST_ACC:
        fail("mnist_plane: validation accuracy %s" % (acc,))


def mnist_lenet():
    """``--network lenet``, one epoch: img/s and accuracy, unbarred (at
    the example's defaults, lr 0.05 with momentum 0.9, the JAX example's
    LeNet does not learn this set either)."""
    per_epoch = -(-60000 // 64)
    mod, log, secs, moved = _mnist_main(["--network", "lenet",
                                         "--num-epochs", "1"])
    acc = log.epochs("Validation-accuracy")
    finite = all(np.isfinite(v.asnumpy()).all()
                 for v in mod.get_params()[0].values())
    phase("mnist_lenet", steps=per_epoch, seconds=secs, val_accuracy=acc,
          train_accuracy=log.epochs("Train-accuracy"), finite=finite,
          kvstore_push=moved["push"], **_mnist_rates(log, per_epoch))
    if not acc:
        fail("mnist_lenet: no validation accuracy was logged")
    if moved["push"] != per_epoch * 8:
        fail("mnist_lenet: %s pushes, not %d" % (moved["push"],
                                                 per_epoch * 8))


def _write_idx(d, name, img8, lab8, gz):
    import gzip
    import struct

    suffix = ".gz" if gz else ""

    def opener(path):
        return gzip.open(path, "wb", compresslevel=1) if gz \
            else open(path, "wb")

    paths = (os.path.join(d, "%s-images-idx3-ubyte%s" % (name, suffix)),
             os.path.join(d, "%s-labels-idx1-ubyte%s" % (name, suffix)))
    with opener(paths[0]) as f:
        f.write(struct.pack(">IIII", 2051, len(img8), 28, 28))
        f.write(img8.tobytes())
    with opener(paths[1]) as f:
        f.write(struct.pack(">II", 2049, len(lab8)))
        f.write(lab8.tobytes())
    return paths


def mnist_idx():
    """The synthetic set written as MNIST idx files, plain and ``.gz``:
    ``MNISTIter``'s batches against the arrays written, then one epoch of
    the example reading the ``.gz`` files."""
    import tempfile

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.example.image_classification import train_mnist

    sets = {}
    for name, n, seed in (("train", 60000, 7), ("t10k", 10000, 8)):
        img, lab = train_mnist._synthetic_mnist(n, seed)
        sets[name] = (np.clip(img[:, 0] / img.max() * 255.0, 0, 255)
                      .astype(np.uint8), lab.astype(np.uint8))
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        checked = 0
        for gz in (False, True):
            d = os.path.join(tmp, "gz" if gz else "plain")
            os.makedirs(d)
            for name, (img8, lab8) in sets.items():
                paths = _write_idx(d, name, img8, lab8, gz)
            img8, lab8 = sets["t10k"]
            with mx.gpu(0):
                it = mx.io.MNISTIter(image=paths[0], label=paths[1],
                                     batch_size=64, shuffle=False)
                for k, batch in enumerate(it):
                    rows = np.arange(k * 64, (k + 1) * 64) % len(lab8)
                    if not (np.array_equal(
                            batch.data[0].asnumpy()[:, 0],
                            img8[rows].astype(np.float32) / 255.0)
                            and np.array_equal(batch.label[0].asnumpy(),
                                               lab8[rows].astype(np.float32))):
                        fail("mnist_idx: batch %d of %s differs from the "
                             "arrays written" % (k, d))
                    checked += 1
        write_s = time.perf_counter() - t0
        mod, log, secs, moved = _mnist_main([
            "--data-dir", os.path.join(tmp, "gz"), "--num-epochs", "1"])
    acc = log.epochs("Validation-accuracy")
    per_epoch = -(-60000 // 64)
    phase("mnist_idx", batches_checked=checked, write_and_check_s=write_s,
          train_s=secs, val_accuracy=acc, kvstore_push=moved["push"],
          used_mnist_iter=not any("synthetic" in line for line in log.lines),
          **_mnist_rates(log, per_epoch))
    if any("synthetic" in line for line in log.lines):
        fail("mnist_idx: the example did not read the idx files")
    if not acc or not acc[-1] >= MNIST_ACC:
        fail("mnist_idx: validation accuracy %s" % (acc,))


def mnist_options():
    """``--monitor 50``, ``--gc-type 2bit``, ``--model-prefix`` then
    ``--load-epoch 1``, and ``--test-io 1``, each a short run."""
    import tempfile

    import torch

    out = {}
    _, log, secs, _ = _mnist_main(MNIST_SHORT + ["--monitor", "50"])
    rows = log.monitor_rows()
    out["monitor"] = dict(rows=len(rows), first=rows[:1], seconds=secs)
    if len(rows) != 2 or not all("softmax_output" in r for r in rows):
        fail("mnist_options: --monitor 50 over 100 batches logged %s"
             % rows)
    mod, log, secs, moved = _mnist_main(MNIST_SHORT + ["--gc-type", "2bit"])
    acc = log.epochs("Validation-accuracy")
    finite = all(np.isfinite(v.asnumpy()).all()
                 for v in mod.get_params()[0].values())
    out["gc_2bit"] = dict(val_accuracy=acc, finite=finite, seconds=secs,
                          push=moved["push"])
    if not finite or not acc:
        fail("mnist_options: --gc-type 2bit: %s" % out["gc_2bit"])
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        with tempfile.TemporaryDirectory() as tmp:
            prefix = os.path.join(tmp, "mnist")
            two = ["--num-examples", "6400", "--num-epochs", "2",
                   "--model-prefix", prefix, "--monitor", "100"]
            _, whole, _, _ = _mnist_main(two)
            _, resumed, _, _ = _mnist_main(two + ["--load-epoch", "1"])
    finally:
        torch.backends.cudnn.deterministic = deterministic
    w_rows = [r.split()[-1] for r in whole.monitor_rows()]
    r_rows = [r.split()[-1] for r in resumed.monitor_rows()]
    out["resume"] = dict(whole_first_batches=w_rows,
                         resumed_first_batch=r_rows)
    if len(w_rows) != 2 or len(r_rows) != 1 or r_rows[0] != w_rows[1]:
        fail("mnist_options: the resumed run's first batch %s is not the "
             "uninterrupted run's %s" % (r_rows, w_rows))
    mod, log, secs, moved = _mnist_main(MNIST_SHORT + ["--test-io", "1"])
    out["test_io"] = dict(returned=mod, seconds=secs, push=moved["push"])
    if mod is not None or moved["push"]:
        fail("mnist_options: --test-io 1 trained")
    phase("mnist_options", **out)


def _opt_run(name, kw, dev, path="perparam", dtype=None, steps=3, seed=5):
    """``steps`` updates of optimizer ``name`` over three parameters on
    ``dev``: the weights and the updater."""
    import torch

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import fastpath, optimizer as opt
    from mxnet_tpu_torch.ndarray.ndarray import NDArray

    dtype = dtype or torch.float32
    rs = np.random.RandomState(0)
    shapes = [(128, 784), (64,), (10, 64)]
    wv = [rs.randn(*s).astype(np.float32) for s in shapes]
    gv = [[(rs.randn(*s) + 0.1 * np.sign(rs.randn(*s))).astype(np.float32)
           for s in shapes] for _ in range(steps)]
    o = opt.create(name, learning_rate=0.05, wd=0.01, **kw)
    upd = opt.get_updater(o)
    ws = [NDArray(torch.from_numpy(w).to(dev, dtype)) for w in wv]
    mx.random.seed(seed)
    for s in range(steps):
        gs = [NDArray(torch.from_numpy(g).to(dev, dtype)) for g in gv[s]]
        if path == "fused":
            fastpath.apply_updater(upd, [(i, gs[i], ws[i])
                                         for i in range(len(ws))])
        else:
            for i in range(len(ws)):
                upd(i, gs[i], ws[i])
    return ws, upd


def _opt_err(a, b):
    """Largest |difference| of weights and states over the larger of 1
    and the tensor's largest magnitude."""
    from mxnet_tpu_torch.optimizer import _state_leaves

    (wa, ua), (wb, ub) = a, b
    pairs = [(x._data, y._data) for x, y in zip(wa, wb)]
    for i in ua.states:
        pairs += list(zip(_state_leaves(ua.states[i]),
                          _state_leaves(ub.states[i])))
    return max(float((x.float().cpu() - y.float().cpu()).abs().max())
               / max(1.0, float(y.float().abs().max())) for x, y in pairs)


def _opt_bitwise(a, b):
    from mxnet_tpu_torch.optimizer import _state_leaves

    (wa, ua), (wb, ub) = a, b
    pairs = [(x._data, y._data) for x, y in zip(wa, wb)]
    for i in ua.states:
        pairs += list(zip(_state_leaves(ua.states[i]),
                          _state_leaves(ub.states[i])))
    return all(bool((x == y).all()) for x, y in pairs)


def _opt_trainstep(name, kw):
    """A captured ``TrainStep`` of a small net against eager ``Trainer``
    steps from the same weights: the largest weight difference."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd, gluon, nd, parallel

    rs = np.random.RandomState(1)
    xs = rs.randn(3, 64, 20).astype(np.float32)
    ys = xs[:, :, :10].argmax(-1).astype(np.float32)
    params = dict(kw, learning_rate=0.05, wd=0.01)
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()

    def net():
        mx.random.seed(3)
        n = gluon.nn.HybridSequential()
        n.add(gluon.nn.Dense(32, activation="tanh", in_units=20),
              gluon.nn.Dense(10, in_units=32))
        n.initialize(mx.initializer.Xavier())
        return n

    with mx.gpu(0):
        eager = net()
        trainer = gluon.Trainer(eager.collect_params(), name, dict(params))
        for x, y in zip(xs, ys):
            with autograd.record():
                loss = loss_fn(eager(nd.array(x)), nd.array(y))
            loss.backward()
            trainer.step(len(x))
        graph = net()
        step = parallel.TrainStep(graph, loss_fn, name, parallel.device_mesh(
            1, devices=[mx.gpu(0)]), optimizer_params=params)
        for x, y in zip(xs, ys):
            step(nd.array(x), nd.array(y))
        step.copy_to_net()
        captured = step.compile_count
    err = max(float(np.abs(a.data().asnumpy() - b.data().asnumpy()).max())
              for a, b in zip(eager.collect_params().values(),
                              graph.collect_params().values()))
    return err, captured


def _op_inputs(name, n_state, dev):
    import torch

    rs = np.random.RandomState(len(name))
    shape = (128, 784)
    w = rs.randn(*shape).astype(np.float32)
    g = (rs.randn(*shape) + 0.2 * np.sign(rs.randn(*shape))) \
        .astype(np.float32)
    states = [np.abs(rs.randn(*shape)).astype(np.float32) + 0.5
              for _ in range(n_state)]
    if name == "rmspropalex_update":
        states[1] *= 0.1
    arrays = [w, g] + states
    tensors = [torch.from_numpy(a).to(dev) for a in arrays]
    if name.startswith("mp_"):
        tensors[0] = tensors[0].half()
        tensors[1] = tensors[1].half()
    return tensors


def optimizers_card():
    """Every optimizer and update op on the card: 3 updates against the
    port on the CPU, fused against per-parameter bit for bit, bf16 under
    ``multi_precision``, a captured ``TrainStep`` against eager ``Trainer``
    steps (where the class has ``pure_step``); the 12 ops against the
    CPU; then ``train_mnist --optimizer <name>`` on 6,000 examples."""
    import torch

    from mxnet_tpu_torch import optimizer as opt
    from mxnet_tpu_torch.ndarray.ndarray import NDArray, invoke

    cuda, cpu = torch.device("cuda", 0), torch.device("cpu")
    rows, bad = [], []
    t0 = time.perf_counter()
    for name, kw in MNIST_OPTIMIZERS:
        row = {"name": name, "kw": kw}
        card = _opt_run(name, kw, cuda)
        if name != "sgld":  # the noise comes from each device's generator
            row["card_vs_cpu"] = _opt_err(card, _opt_run(name, kw, cpu))
            if not row["card_vs_cpu"] <= MNIST_TOL:
                bad.append("%s card vs cpu %.3g" % (name,
                                                     row["card_vs_cpu"]))
        row["fused_bitwise"] = _opt_bitwise(card, _opt_run(name, kw, cuda,
                                                           "fused"))
        if not row["fused_bitwise"]:
            bad.append("%s fused differs from per-parameter" % name)
        ws, upd = _opt_run(name, dict(kw, multi_precision=True), cuda,
                           dtype=torch.bfloat16)
        masters = [upd.states[i][0] for i in range(len(ws))]
        row["bf16_mp"] = all(w._data.dtype == torch.bfloat16
                             and m.dtype == torch.float32
                             and torch.equal(w._data, m.to(torch.bfloat16))
                             and bool(torch.isfinite(m).all())
                             for w, m in zip(ws, masters))
        if not row["bf16_mp"]:
            bad.append("%s bf16 multi_precision" % name)
        if type(opt.create(name)).pure_step is not opt.Optimizer.pure_step:
            err, captured = _opt_trainstep(name, kw)
            row["trainstep_vs_trainer"] = err
            row["captures"] = captured
            if not err <= 1e-4 or captured != 1:
                bad.append("%s TrainStep vs Trainer %.3g (%d captures)"
                           % (name, err, captured))
        rows.append(row)
    op_err = {}
    for op, (n_state, attrs) in MNIST_OPS.items():
        outs = []
        for dev in (cuda, cpu):
            res = invoke(op, *[NDArray(t) for t in _op_inputs(op, n_state,
                                                                dev)],
                         **attrs)
            res = res if isinstance(res, (list, tuple)) else [res]
            outs.append([r._data.float().cpu() for r in res])
        op_err[op] = max(float((a - b).abs().max()) / max(1.0, float(
            b.abs().max())) for a, b in zip(*outs))
        if not op_err[op] <= MNIST_TOL:
            bad.append("op %s card vs cpu %.3g" % (op, op_err[op]))
    check_s = time.perf_counter() - t0
    trained = {}
    for name, _kw in MNIST_OPTIMIZERS:
        if name in trained:
            continue
        argv = ["--optimizer", name, "--num-examples",
                str(MNIST_OPT_EXAMPLES), "--num-epochs", "1"]
        start = _mnist_initial(argv)
        mod, log, secs, _ = _mnist_main(argv)
        args, _ = mod.get_params()
        final = {k: v.asnumpy() for k, v in args.items()}
        acc = log.epochs("Validation-accuracy")
        moved = max(float(np.abs(final[k] - start[k]).max()) for k in start)
        finite = all(np.isfinite(v).all() for v in final.values())
        trained[name] = dict(val_accuracy=acc[-1] if acc else None,
                             moved=moved, finite=finite, seconds=secs)
        if not finite or not moved > 0:
            bad.append("train_mnist --optimizer %s: finite %s, moved %.3g"
                       % (name, finite, moved))
        if name == "sgd" and not (acc and acc[-1] >= MNIST_ACC):
            bad.append("train_mnist --optimizer sgd: accuracy %s" % acc)
    phase("optimizers_card", optimizers=rows, ops_max_rel_err=op_err,
          check_s=check_s, train_mnist=trained, tol=MNIST_TOL)
    if bad:
        fail("optimizers_card: %s" % "; ".join(bad))


def _mnist_initial(argv, seed=0):
    """The weights ``_mnist_main(argv, seed)`` starts from: the same draws
    in the same order (the iterator's shuffle, then the initializer)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.example.image_classification import train_mnist

    args = train_mnist.parse_args(argv)
    with mx.gpu(0):
        mx.random.seed(seed)
        train, _ = train_mnist.get_mnist_iter(args, None)
        mod = mx.mod.Module(train_mnist.get_symbol(args), context=mx.gpu(0))
        mod.bind(data_shapes=train.provide_data,
                 label_shapes=train.provide_label)
        mod.init_params(mx.initializer.Xavier(
            rnd_type="gaussian", factor_type="in", magnitude=2))
        args_, _ = mod.get_params()
        return {k: v.asnumpy() for k, v in args_.items()}


def mnist_phases():
    mnist_parity()
    rates = mnist()
    mnist_plane(rates)
    mnist_lenet()
    mnist_idx()
    mnist_options()
    optimizers_card()


# -- slice 18: sparse storage and the operator tail ---------------------------

TAIL_TOL, TAIL_GRAD_TOL = 1e-5, 1e-4   # the card against the CPU, fp32
TAIL_TRACE_STEPS = 5
# MXNet 1.3's example/sparse/linear_classification on Avazu: 1,000,000
# features, about 15 stored values a row, batch 8192; 65,536 rows here
AVAZU = dict(features=1000000, nnz=15, rows=65536, batch=8192, epochs=2)
AVAZU_PEAK_BYTES = 1 << 30
# fm with SGD diverges at its defaults in both packages; the JAX package's
# own test runs it at these (tests/test_sparse_ops.py)
FM_SGD_ARGS = ["--optimizer", "sgd", "--epochs", "12", "--num-samples",
               "192", "--feature-dim", "300"]
# fm's V gradient is a difference of two products, x (x V) - x^2 V, that
# cancels, and AdaGrad scales each step by the root of its own history,
# so the last bit of such a gradient (index_add's order on the card)
# moves a weight by up to lr times its relative error: AdaGrad's 3 steps
# are held to this, SGD's to TAIL_TOL
FM_ADAGRAD_TOL = 1e-4
CTC_SHAPE = (64, 16, 6, 3)  # the OCR example's batch, steps, classes, label
NHWC_NET = dict(batch=32, side=32, channels=16)
NHWC_TIME_STEPS = 20


def _tail_err(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    if a.shape != b.shape:
        return float("inf")
    return float(np.abs(a - b).max()) if a.size else 0.0


def _tail_close(got, want, tol):
    """Integers exactly, floats within ``tol`` (absolute and relative)."""
    got, want = np.asarray(got), np.asarray(want)
    if got.shape != want.shape:
        return False
    if not np.issubdtype(want.dtype, np.floating):
        return np.array_equal(got, want)
    return bool(np.allclose(got, want, rtol=tol, atol=tol, equal_nan=True))


def _write_avazu(path, seed=0):
    """An Avazu-shaped LibSVM file from a planted separator: AVAZU's rows,
    each with AVAZU['nnz'] distinct features out of AVAZU['features'],
    normal values, the label the separator's sign."""
    rs = np.random.RandomState(seed)
    n, k, d = AVAZU["rows"], AVAZU["nnz"], AVAZU["features"]
    w_true = rs.randn(d)
    idx = np.sort(rs.randint(0, d, (n, k)), axis=1)
    dup = np.where((np.diff(idx, axis=1) == 0).any(axis=1))[0]
    for r in dup:  # a few rows draw the same feature twice: redraw them
        idx[r] = np.sort(rs.choice(d, k, replace=False))
    val = rs.randn(n, k)
    label = ((val * w_true[idx]).sum(axis=1) > 0).astype(int)
    with open(path, "w") as f:
        for r in range(n):
            f.write("%d %s\n" % (label[r], " ".join(
                "%d:%.4f" % kv for kv in zip(idx[r], val[r]))))


def _lc_parity(argv):
    """3 steps of linear_classification on the card and on the CPU: every
    step's log loss a sample (the example's reading), w and b, their
    largest difference."""
    from mxnet_tpu_torch.example.sparse import linear_classification as lc

    runs = {}
    for dev in ("gpu", "cpu"):
        args = lc.parse_args(argv + ["--device", dev])
        res = lc.run(args, max_steps=3)
        runs[dev] = (np.asarray(res["losses"]) / args.batch_size,
                     res["model"].w.asnumpy(), res["model"].b.asnumpy())
    return {name: _tail_err(g, c) for name, g, c in zip(
        ("losses", "w", "b"), runs["gpu"], runs["cpu"])}


def _lc_trace(res):
    """The example's step (with its read back) over TAIL_TRACE_STEPS
    batches of its iterator: the profile, and how many of those CSR
    batches built their dense value (none should)."""
    import mxnet_tpu_torch as mx

    it, model = res["iter"], res["model"]
    it.reset()
    batches = [b for _, b in zip(range(TAIL_TRACE_STEPS + 1), it)]
    state = {"i": 0}

    def step():
        with mx.gpu(0):
            loss = model.step(batches[state["i"] % len(batches)])
            float(loss.asnumpy())
        state["i"] += 1

    step()
    prof = _device_profile(step, TAIL_TRACE_STEPS)
    return prof, sum(b.data[0].densified for b in batches)


def sparse_lc():
    """linear_classification at its defaults on the card (IMPROVED), 3
    steps on the card against the CPU, a trace of its step."""
    from mxnet_tpu_torch.example.sparse import linear_classification as lc

    res = lc.run(lc.parse_args([]))
    errs = _lc_parity([])
    prof, densified = _lc_trace(res)
    phase("sparse_lc", logloss=[res["first"], res["last"]],
          improved=res["improved"], steps=res["steps"],
          step_ms=res["step_ms"], epoch_step_ms=res["epoch_step_ms"],
          samples_per_s=res["samples_per_s"],
          card_vs_cpu_max_abs_err=errs, tol=TAIL_TOL,
          densified_batches=densified, profile=prof)
    if not res["improved"]:
        fail("sparse_lc: log loss %.4f -> %.4f is not IMPROVED"
             % (res["first"], res["last"]))
    if not max(errs.values()) <= TAIL_TOL:
        fail("sparse_lc: the card and the CPU disagree: %s" % errs)


def sparse_lc_avazu():
    """The example on an Avazu-shaped file (AVAZU), as MXNet 1.3 runs
    Avazu: ms a step, samples/s, a trace, the phase's peak memory (under
    AVAZU_PEAK_BYTES: no batch was made dense); 3 steps card against
    CPU."""
    import tempfile

    import torch

    from mxnet_tpu_torch.example.sparse import linear_classification as lc

    path = os.path.join(tempfile.mkdtemp(), "avazu_shape.libsvm")
    t0 = time.perf_counter()
    _write_avazu(path)
    write_s = time.perf_counter() - t0
    argv = ["--data", path, "--feature-dim", str(AVAZU["features"]),
            "--batch-size", str(AVAZU["batch"]), "--epochs",
            str(AVAZU["epochs"])]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    res = lc.run(lc.parse_args(argv))
    run_s = time.perf_counter() - t0
    prof, densified = _lc_trace(res)
    peak = torch.cuda.max_memory_allocated()
    errs = _lc_parity(argv)
    phase("sparse_lc_avazu", rows=AVAZU["rows"], features=AVAZU["features"],
          nnz_per_row=AVAZU["nnz"], batch=AVAZU["batch"],
          epochs=AVAZU["epochs"], write_s=write_s, run_s=run_s,
          logloss=[res["first"], res["last"]], steps=res["steps"],
          step_ms=res["step_ms"], epoch_step_ms=res["epoch_step_ms"],
          samples_per_s=res["samples_per_s"],
          peak_bytes=peak, resident_at_start_bytes=base,
          peak_limit=AVAZU_PEAK_BYTES,
          densified_batches=densified, card_vs_cpu_max_abs_err=errs,
          tol=TAIL_TOL, profile=prof)
    os.remove(path)
    if densified or not peak - base < AVAZU_PEAK_BYTES:
        fail("sparse_lc_avazu: peak memory %d bytes above the %d resident "
             "at the start (limit %d), %d batches made dense"
             % (peak - base, base, AVAZU_PEAK_BYTES, densified))
    if not max(errs.values()) <= TAIL_TOL:
        fail("sparse_lc_avazu: the card and the CPU disagree: %s" % errs)


def sparse_fm():
    """fm.py with SGD (at FM_SGD_ARGS) and with AdaGrad (at its defaults)
    on the card: IMPROVED both; 3 steps card against CPU each; a trace of
    the AdaGrad step."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.example.sparse import fm

    out, bad = {}, []
    for name, argv, tol in (("sgd", FM_SGD_ARGS, TAIL_TOL),
                            ("adagrad", ["--optimizer", "adagrad"],
                             FM_ADAGRAD_TOL)):
        res = fm.run(fm.parse_args(argv))
        runs = {}
        for dev in ("gpu", "cpu"):
            args = fm.parse_args(argv + ["--device", dev])
            r = fm.run(args, max_steps=3)
            runs[dev] = [np.asarray(r["losses"]) / args.batch_size] + [
                p.asnumpy() for p in r["model"].params]
        errs = {k: _tail_err(g, c) for k, g, c in zip(
            ("losses", "w1", "b", "v"), runs["gpu"], runs["cpu"])}
        out[name] = dict(mse=[res["mse"][0], res["mse"][-1]],
                         improved=res["improved"], steps=res["steps"],
                         step_ms=res["step_ms"],
                         epoch_step_ms=res["epoch_step_ms"],
                         card_vs_cpu_max_abs_err=errs, tol=tol)
        if not res["improved"]:
            bad.append("%s: mse %s not IMPROVED" % (name, res["mse"]))
        if not max(errs.values()) <= tol:
            bad.append("%s: card against CPU %s" % (name, errs))
    model, batches = res["model"], res["batches"]
    state = {"i": 0}

    def step():
        with mx.gpu(0):
            x, y = batches[state["i"] % len(batches)]
            float(model.step(x, y).asnumpy())
        state["i"] += 1

    step()
    prof = _device_profile(step, TAIL_TRACE_STEPS)
    phase("sparse_fm", sgd_args=FM_SGD_ARGS, profile=prof, **out)
    if bad:
        fail("sparse_fm: %s" % bad)


def _ocr_step_parity():
    """One step of the OCR example's net from the same seeded weights on
    the card and on the CPU: the loss and every weight after it."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import nd
    from mxnet_tpu_torch.example.ctc import lstm_ocr

    x, y = lstm_ocr.make_data(64, np.random.RandomState(21))
    runs = {}
    for dev, ctx in (("card", mx.gpu(0)), ("cpu", mx.cpu())):
        with ctx:
            mx.random.seed(7)
            net, lossfn, trainer = lstm_ocr.build()
            loss = lstm_ocr.train_step(net, lossfn, trainer, nd.array(x),
                                       nd.array(y))
            runs[dev] = [loss.asnumpy()] + [
                p.data().asnumpy() for p in net.collect_params().values()]
    errs = [_tail_err(g, c) for g, c in zip(runs["card"], runs["cpu"])]
    return {"loss": errs[0], "weights": max(errs[1:])}


def _ctc_against_library():
    """The CTC op against ``F.ctc_loss`` (a yardstick the port does not
    call) at the OCR example's shape on feasible labels: the losses and
    the data's gradients, and each one's forward + backward time."""
    import torch
    import torch.nn.functional as F

    from mxnet_tpu_torch.ops.nn import ctc_loss
    from mxnet_tpu_torch.ops.registry import get_op

    b, t, c, lab_len = CTC_SHAPE
    rs = np.random.RandomState(3)
    data = torch.tensor(rs.randn(b, t, c), dtype=torch.float32,
                        device="cuda", requires_grad=True)
    lab = torch.tensor(rs.randint(1, c, (b, lab_len)), device="cuda")
    attrs = get_op("CTCLoss").parse_attrs({})
    lengths = torch.full((b,), lab_len, dtype=torch.int64, device="cuda")
    steps = torch.full((b,), t, dtype=torch.int64, device="cuda")

    def ours():
        loss = ctc_loss(attrs, data, lab.to(torch.float32))
        return loss, torch.autograd.grad(loss.sum(), data)[0]

    def library():
        logp = torch.log_softmax(data, -1).transpose(0, 1)
        loss = F.ctc_loss(logp, lab, steps, lengths, blank=0,
                          reduction="none")
        return loss, torch.autograd.grad(loss.sum(), data)[0]

    (l1, g1), (l2, g2) = ours(), library()
    return dict(shape=CTC_SHAPE,
                loss_max_abs_err=_tail_err(l1.detach().cpu(),
                                           l2.detach().cpu()),
                grad_max_abs_err=_tail_err(g1.cpu(), g2.cpu()),
                op_ms=time_ms(ours, iters=20),
                f_ctc_loss_ms=time_ms(library, iters=20))


def ctc_ocr():
    """lstm_ocr.py at its defaults on the card (ocr LEARNED), one step
    card against CPU, the CTC op against F.ctc_loss, a trace of its
    step."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import nd
    from mxnet_tpu_torch.example.ctc import lstm_ocr

    res = lstm_ocr.run(lstm_ocr.parse_args([]))
    errs = _ocr_step_parity()
    lib = _ctc_against_library()
    x, y = lstm_ocr.make_data(64, np.random.RandomState(5))
    with mx.gpu(0):
        net, lossfn, trainer = lstm_ocr.build()
        data, label = nd.array(x), nd.array(y)

    def step():
        with mx.gpu(0):
            loss = lstm_ocr.train_step(net, lossfn, trainer, data, label)
            float(loss.mean().asscalar())

    step()
    prof = _device_profile(step, TAIL_TRACE_STEPS)
    phase("ctc_ocr", loss=[res["loss"][0], res["loss"][-1]],
          per_char=res["per_char"], exact=res["exact"], steps=res["steps"],
          step_ms=res["step_ms"], epoch_step_ms=res["epoch_step_ms"],
          card_vs_cpu_max_abs_err=errs,
          tol=TAIL_TOL, grad_tol=TAIL_GRAD_TOL, ctc_vs_f_ctc_loss=lib,
          profile=prof)
    if not res["ok"]:
        fail("ctc_ocr: per-char accuracy %.3f, not LEARNED"
             % res["per_char"])
    if not (errs["loss"] <= TAIL_TOL and errs["weights"] <= TAIL_GRAD_TOL):
        fail("ctc_ocr: the card and the CPU disagree: %s" % errs)
    if not (lib["loss_max_abs_err"] <= 1e-4
            and lib["grad_max_abs_err"] <= 1e-4):
        fail("ctc_ocr: the op and F.ctc_loss disagree on feasible labels: "
             "%s" % lib)


def svm_mnist():
    """svm_mnist.py at its defaults on the card (svm heads ALL LEARNED),
    then a trace of the L2-SVM head's step."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import nd
    from mxnet_tpu_torch.example.svm_mnist import svm_mnist as svm

    res = svm.run(svm.parse_args([]))
    rs = np.random.RandomState(31)
    x, y = svm.make_data(64, rs)
    with mx.gpu(0):
        net, lossfn, _, trainer = svm.build("l2svm")
        data, label = nd.array(x), nd.array(svm.one_hot_pm1(y))

    def step():
        with mx.gpu(0):
            svm.train_step(net, lossfn, trainer, data, label)

    step()
    prof = _device_profile(step, TAIL_TRACE_STEPS)
    phase("svm_mnist", accuracy=res["accuracy"], steps=res["steps"],
          seconds=res["seconds"], step_ms=res["step_ms"], profile=prof)
    if not res["ok"]:
        fail("svm_mnist: test accuracy %s, not ALL LEARNED"
             % res["accuracy"])


def _tail_sparse_checks():
    """The sparse ex path on the card against the CPU: name -> (card's
    arrays, CPU's arrays)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd, nd
    from mxnet_tpu_torch.ndarray import sparse as mxs

    rs = np.random.RandomState(17)
    a = (rs.randn(12, 8) * (rs.rand(12, 8) < 0.3)).astype(np.float32)
    a[4] = 0
    dense = rs.randn(8, 5).astype(np.float32)
    dense_t = rs.randn(12, 5).astype(np.float32)
    vec = rs.randn(8).astype(np.float32)
    ids = rs.randint(0, 12, (3, 4)).astype(np.int64)
    w_emb = rs.randn(12, 6).astype(np.float32)
    div = rs.uniform(0.5, 2.0, (12, 8)).astype(np.float32)

    def parts(x):
        if x.stype == "default":
            return [x.asnumpy()]
        out = [x.data.asnumpy(), x.indices.asnumpy()]
        return out + ([x.indptr.asnumpy()] if x.stype == "csr" else [])

    def dot_grad(transpose_a):
        csr = mxs.csr_matrix(a)
        w = nd.array(dense_t if transpose_a else dense)
        w.attach_grad()
        with autograd.record():
            y = mxs.dot(csr, w, transpose_a=transpose_a)
            (y * y).sum().backward()
        return [y.asnumpy(), w.grad.asnumpy(),
                np.asarray(csr.densified)]

    def embedding():
        w = nd.array(w_emb)
        w.attach_grad()
        with autograd.record():
            e = nd.invoke("_contrib_SparseEmbedding", nd.array(ids), w,
                          input_dim=12, output_dim=6)
            (e * e).sum().backward()
        return [e.asnumpy(), w.grad.asnumpy()]

    def rsp_ops():
        ra = mxs.cast_storage(nd.array(a), "row_sparse")
        rb = mxs.cast_storage(nd.array(np.flipud(a).copy()), "row_sparse")
        out = []
        for r in (nd.invoke("elemwise_add", ra, rb),
                  nd.invoke("elemwise_sub", ra, rb),
                  mxs.retain(ra, [0, 4, 7]),
                  nd.invoke("_square_sum", ra, axis=(1,), keepdims=True),
                  nd.invoke("_square_sum", ra, axis=(0,)),
                  nd.invoke("_square_sum", ra)):
            out += parts(r)
        return out

    def scatter():
        out = []
        for stype in ("row_sparse", "csr"):
            s = mxs.cast_storage(nd.array(a), stype)
            for r in (nd.invoke("_scatter_plus_scalar", s, scalar=1.5),
                      nd.invoke("_scatter_minus_scalar", s, scalar=0.5),
                      nd.invoke("_scatter_elemwise_div", s, nd.array(div))):
                out += parts(r)
        return out

    def pull():
        kv = mx.kv.create("local")
        kv.init("w", nd.array(w_emb))
        out = mxs.zeros("row_sparse", (12, 6))
        kv.row_sparse_pull("w", out=out, row_ids=nd.array([7, 2, 7],
                                                          dtype="int64"))
        return parts(out)

    cases = {
        "cast_storage": lambda: parts(mxs.cast_storage(nd.array(a), "csr"))
        + parts(mxs.cast_storage(nd.array(a), "row_sparse"))
        + parts(mxs.cast_storage(mxs.csr_matrix(a), "row_sparse")),
        "dot_csr_dense": lambda: dot_grad(False),
        "dot_csr_t_dense": lambda: dot_grad(True),
        "dot_csr_vector": lambda: [mxs.dot(mxs.csr_matrix(a),
                                           nd.array(vec)).asnumpy()],
        "row_sparse_ops": rsp_ops, "scatter_sparse": scatter,
        "SparseEmbedding": embedding, "row_sparse_pull": pull,
    }
    out = {}
    for name, fn in cases.items():
        with mx.gpu(0):
            got = fn()
        with mx.cpu():
            want = fn()
        out[name] = (got, want)
    return out


def _tail_net(layout):
    """Convolution, relu, max pool, Deconvolution, FullyConnected(10),
    SoftmaxOutput, in ``layout``."""
    from mxnet_tpu_torch import sym

    y = sym.Convolution(sym.var("data"), kernel=(3, 3), pad=(1, 1),
                        num_filter=16, layout=layout, name="conv")
    y = sym.Activation(y, act_type="relu", name="relu")
    y = sym.Pooling(y, kernel=(2, 2), stride=(2, 2), pool_type="max",
                    layout=layout, name="pool")
    y = sym.Deconvolution(y, kernel=(2, 2), stride=(2, 2), num_filter=8,
                          layout=layout, name="deconv")
    y = sym.FullyConnected(y, num_hidden=10, name="fc")
    return sym.SoftmaxOutput(y, name="softmax")


def _tail_module(ctx, layout, seed=0):
    import mxnet_tpu_torch as mx

    n, s, c = NHWC_NET["batch"], NHWC_NET["side"], NHWC_NET["channels"]
    shape = (n, s, s, c) if layout == "NHWC" else (n, c, s, s)
    with ctx:
        mx.random.seed(seed)
        mod = mx.mod.Module(_tail_net(layout), context=ctx)
        mod.bind(data_shapes=[("data", shape)],
                 label_shapes=[("softmax_label", (n,))])
        mod.init_params(mx.initializer.Xavier())
        mod.init_optimizer(optimizer="sgd", optimizer_params={
            "learning_rate": 0.1, "momentum": 0.9})
        rs = np.random.RandomState(seed + 1)
        batch = mx.io.DataBatch([mx.nd.array(rs.rand(*shape))],
                                [mx.nd.array(rs.randint(0, 10, n))])
    return mod, batch


def _nhwc_module_checks():
    """One Module SGD step of the NHWC net on the card against the CPU,
    and the net's ms a step in NHWC and NCHW on the card."""
    import torch

    import mxnet_tpu_torch as mx

    runs = {}
    for dev, ctx in (("card", mx.gpu(0)), ("cpu", mx.cpu())):
        mod, batch = _tail_module(ctx, "NHWC")
        with ctx:
            mod.forward_backward(batch)
            mod.update()
            args, _ = mod.get_params()
            runs[dev] = (mod.get_outputs()[0].asnumpy(),
                         {k: v.asnumpy() for k, v in args.items()})
    errs = {"outputs": _tail_err(runs["card"][0], runs["cpu"][0]),
            "weights": max(_tail_err(runs["card"][1][k], runs["cpu"][1][k])
                           for k in runs["cpu"][1])}
    ms = {}
    for layout in ("NHWC", "NCHW"):
        mod, batch = _tail_module(mx.gpu(0), layout)

        def step():
            with mx.gpu(0):
                mod.forward_backward(batch)
                mod.update()

        for _ in range(3):
            step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(NHWC_TIME_STEPS):
            step()
        torch.cuda.synchronize()
        ms[layout] = (time.perf_counter() - t0) * 1e3 / NHWC_TIME_STEPS
    return errs, ms


def ops_tail_card():
    """Every name slice 18 registers, forward and gradient on the card
    against the port on the CPU (tests/torch_tail_cases.py), the sparse
    ex path, PNG decoding, and the NHWC Module step."""
    import inspect

    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "tests"))
    import torch_tail_cases as cases

    from mxnet_tpu_torch import image
    from mxnet_tpu_torch.ops.registry import OP_REGISTRY

    bad, checked, names = [], 0, set()

    def compare(label, got, want, grad_from=None):
        nonlocal checked
        checked += 1
        for k, (g, w) in enumerate(zip(got, want)):
            tol = TAIL_GRAD_TOL if grad_from is not None and k >= grad_from \
                else TAIL_TOL
            if not _tail_close(g, w, tol):
                bad.append("%s[%d]: max abs err %s" % (label, k,
                                                       _tail_err(g, w)))
        if len(got) != len(want):
            bad.append("%s: %d arrays against %d" % (label, len(got),
                                                     len(want)))

    def run_case(name, op, specs, attrs, flags):
        from torch_op_cases import make_inputs

        inputs = make_inputs(specs, "float32", seed=11)
        sign_free = op in ("_linalg_syevd", "_linalg_gelqf")
        got = _op_run(name, inputs, attrs, "cuda", flags["grad"], sign_free)
        want = _op_run(name, inputs, attrs, "cpu", flags["grad"], sign_free)
        n_out = len(want) - sum(flags["grad"] and x.dtype == np.float32
                                for x in inputs)
        if sign_free:  # the solver's signs: compare invariants
            outs = cases.sign_invariant(op, want[:n_out])
            got = cases.sign_invariant(op, got[:n_out]) + got[n_out:]
            want, n_out = outs + want[n_out:], len(outs)
        compare(name if name == op else "%s(%s)" % (name, op), got, want,
                grad_from=n_out)
        names.add(name)

    for key in sorted(cases.TAIL_CASES):
        op, specs, attrs, flags = cases.TAIL_CASES[key]
        run_case(op, op, specs, attrs, flags)
    for key, (op, inputs) in sorted(cases.SIGN_CASES.items()):
        run_case(op, op, inputs, {}, {"grad": True})
    for alias in sorted(n for v in cases.ALIASES.values() for n in v):
        run_case(alias, *cases.canonical(alias, OP_REGISTRY))
    # decoding: PNG bytes written by the port's encoder, and the file
    import tempfile

    img = np.random.RandomState(4).randint(0, 256, (9, 7, 3)).astype(
        np.uint8)
    raw = np.frombuffer(image.imencode(img, ".png"), np.uint8)
    path = os.path.join(tempfile.mkdtemp(), "img.png")
    with open(path, "wb") as f:
        f.write(raw.tobytes())
    for name in ("_cvimdecode", "imdecode_op"):
        for flag in (0, 1):
            compare("%s(flag=%d)" % (name, flag),
                    _op_run(name, [raw], {"flag": flag}, "cuda", False),
                    _op_run(name, [raw], {"flag": flag}, "cpu", False))
        names.add(name)
    compare("_cvimread", _op_run("_cvimread", [], {"filename": path},
                                 "cuda", False), [img])
    names.add("_cvimread")
    os.remove(path)
    sparse = _tail_sparse_checks()
    for label, (got, want) in sparse.items():
        compare("sparse:" + label, got, want, grad_from=1)
    names |= {"_sparse_retain"}
    errs, layout_ms = _nhwc_module_checks()
    mods = {"mxnet_tpu_torch.ops.linalg", "mxnet_tpu_torch.ops.misc_tail",
            "mxnet_tpu_torch.ops.sparse"}
    registered = {n for n, o in OP_REGISTRY.items()
                  if inspect.getmodule(o.fcompute).__name__ in mods}
    missing = sorted((registered | set(cases.NN_NAMES)) - names)
    phase("ops_tail_card", names=len(names), checks=checked,
          tol=TAIL_TOL, grad_tol=TAIL_GRAD_TOL, failed=bad,
          unchecked=missing, nhwc_module_step_max_abs_err=errs,
          module_step_ms=layout_ms, nhwc_net=NHWC_NET)
    if bad or missing:
        fail("ops_tail_card: the card disagrees with the CPU: %s; not "
             "checked: %s" % (bad, missing))
    if not (errs["outputs"] <= TAIL_TOL and errs["weights"]
            <= TAIL_GRAD_TOL):
        fail("ops_tail_card: the NHWC Module step disagrees: %s" % errs)


def tail_phases():
    sparse_lc()
    sparse_lc_avazu()
    sparse_fm()
    ctc_ocr()
    svm_mnist()
    ops_tail_card()


# -- slice 19: the rest of gluon -------------------------------------------
# the card's nvidia-smi line (name, power limit), printed beside every number
# of the slice's phases
CARD = None
# gluon_resnet: the port's example/gluon/train_resnet.py at its defaults
# (resnet50_v1, batch 32, 224 x 224, 1000 classes, SGD 0.05 with momentum
# 0.9 and wd 1e-4) for GLUON_RESNET_BATCHES batches, then its export; the
# export's SymbolBlock on the card against the trained net's own inference
# output within GLUON_EXPORT_TOL of the largest magnitude (fp32, TF32 off:
# the same cuDNN calls, Symbol.eval_nd against the eager layers). PERF.md's
# TrainStep figure for the same net and step (fp32, §5), so the script's
# own overhead shows beside it
GLUON_RESNET_BATCHES, GLUON_PROFILE_STEPS = 20, 5
GLUON_EXPORT_TOL = 1e-5
GLUON_TRAINSTEP_IMG_S = [559, 562]
# gluon_loader: an ImageFolderDataset of GLUON_LOADER_IMAGES synthetic PNGs
# (4 classes, sides 240-320) through RandomResizedCrop(224), a flip,
# ToTensor and Normalize, DataLoader batches of 32 with pin_memory
GLUON_LOADER_IMAGES, GLUON_LOADER_WORKERS = 128, (0, 4)
# and the resizing transforms on one decoded image on the card against the
# same on the host, seeded alike, of the largest magnitude (fp32, TF32 off)
GLUON_TRANSFORM_TOL = 1e-5
GLUON_MEAN, GLUON_STD = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)
# gluon_dcgan / gluon_style: the examples at their defaults on the card; the
# first step of each player (dcgan) and the first GLUON_STYLE_STEPS steps
# (neural_style) against the same run on the CPU, relative
GLUON_EXAMPLE_TOL, GLUON_STYLE_STEPS = 1e-4, 3
# gluon_contrib: card against CPU, forward of the largest magnitude and
# gradients
GLUON_CONTRIB_TOL, GLUON_CONTRIB_GRAD_TOL = 1e-5, 1e-4


def _spread_ms(seconds):
    ms = sorted(1e3 * s for s in seconds)
    return {"median": float(np.median(ms)), "min": ms[0], "max": ms[-1],
            "p10": float(np.percentile(ms, 10)),
            "p90": float(np.percentile(ms, 90))}


def gluon_resnet():
    """The port's train_resnet.py at its defaults on the card, its export,
    and the export's SymbolBlock against the trained net."""
    import tempfile

    import torch

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import gluon, nd
    from mxnet_tpu_torch.example.gluon import train_resnet as tr

    prefix = os.path.join(tempfile.mkdtemp(prefix="chip_smoke_gluon_"),
                          "resnet50_v1")
    mx.random.seed(0)
    args = tr.parse_args(["--num-batches", str(GLUON_RESNET_BATCHES),
                          "--save-prefix", prefix])
    t0 = time.perf_counter()
    res = tr.run(args)
    run_s = time.perf_counter() - t0
    net, step, losses = res["net"], res["step"], res["losses"]
    if not np.isfinite(losses).all():
        fail("gluon_resnet: losses %s" % losses)
    if step.compile_count != 1 or step.steady_state_recompiles != 0:
        fail("gluon_resnet: %d captures, %d steady-state recompiles"
             % (step.compile_count, step.steady_state_recompiles))
    steady = res["step_s"][1:]  # the first step captures
    spread = _spread_ms(steady)
    sizes = {f: os.path.getsize(prefix + f)
             for f in ("-symbol.json", "-0000.params")}
    # the export on the card against the trained net, inference mode
    t0 = time.perf_counter()
    sb = gluon.SymbolBlock.imports(prefix + "-symbol.json", "data",
                                   prefix + "-0000.params")
    torch.cuda.synchronize()
    import_s = time.perf_counter() - t0
    x = nd.array(np.random.RandomState(5).rand(
        args.batch_size, 3, args.image_size, args.image_size).astype(
        np.float32))
    want = net(x).asnumpy()
    got = sb(x).asnumpy()
    err = _rel_err(got, want, floor=1e-30)
    sb_ms = time_ms(lambda: sb(x), iters=5, warm=1)
    net_ms = time_ms(lambda: net(x), iters=5, warm=1)
    # the script's own loop body (a batch from its NDArrayIter, the step,
    # the loss metric's read-back) under the profiler
    args.num_batches = GLUON_PROFILE_STEPS + 1
    batches = iter(tr.data_iter(args))
    metric = mx.metric.Loss()

    def one():
        batch = next(batches)
        metric.update(None, [step(batch.data[0], batch.label[0])])

    prof = _device_profile(one, GLUON_PROFILE_STEPS)
    phase("gluon_resnet", card=CARD, model=args.model, batch=args.batch_size,
          side=args.image_size, classes=args.num_classes,
          batches=len(losses), run_s=run_s, capture_step_s=res["step_s"][0],
          step_ms=spread, img_per_s=args.batch_size * 1e3
          / spread["median"], losses_first_last=[losses[0], losses[-1]],
          compile_count=step.compile_count,
          trainstep_img_per_s_perf_md=GLUON_TRAINSTEP_IMG_S,
          export_s=res["export_s"], export_bytes=sizes,
          import_s=import_s, import_max_rel_err=err, tol=GLUON_EXPORT_TOL,
          symbolblock_forward_ms=sb_ms, net_forward_ms=net_ms,
          profile=prof)
    if not err <= GLUON_EXPORT_TOL:
        fail("gluon_resnet: the export's SymbolBlock differs from the net "
             "by %.3g of the largest magnitude" % err)


def _bn_net(mx):
    nn = mx.gluon.nn
    net = nn.HybridSequential()
    with net.name_scope():
        net.add(nn.Conv2D(8, 3, padding=1, in_channels=3),
                nn.BatchNorm(in_channels=8), nn.Activation("relu"),
                nn.Flatten(), nn.Dense(16, in_units=8 * 16 * 16),
                nn.BatchNorm(center=False, in_channels=16),
                nn.Dense(10, in_units=16))
    return net


def gluon_export_cross():
    """A small Conv/BatchNorm/Dense net exported on the card: its files
    imported on the card give the net's output and the output of the same
    files imported on the CPU."""
    import tempfile

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd, gluon, nd

    prefix = os.path.join(tempfile.mkdtemp(prefix="chip_smoke_export_"),
                          "bn")
    mx.random.seed(3)
    net = _bn_net(mx)
    net.initialize(mx.initializer.Xavier())
    xs = np.random.RandomState(4).rand(8, 3, 16, 16).astype(np.float32)
    x = nd.array(xs)
    with autograd.record():  # the moving statistics move
        net(x)
    net.export(prefix)
    files = (prefix + "-symbol.json", "data", prefix + "-0000.params")
    want = net(x).asnumpy()
    got = gluon.SymbolBlock.imports(*files)(x).asnumpy()
    with mx.cpu():
        cpu = gluon.SymbolBlock.imports(*files)(nd.array(xs)).asnumpy()
    keys = sorted(mx.nd.load(files[2]))
    errs = {"card_import_vs_net": _rel_err(got, want, floor=1e-30),
            "card_vs_cpu": _rel_err(got, cpu, floor=1e-30)}
    phase("gluon_export_cross", card=CARD, params=keys,
          max_rel_err=errs, tol=GLUON_EXPORT_TOL)
    if not max(errs.values()) <= GLUON_EXPORT_TOL:
        fail("gluon_export_cross: %s" % errs)
    if sum(k.startswith("aux:") for k in keys) != 5:  # 4 stats, 1 beta
        fail("gluon_export_cross: arg/aux split %s" % keys)


def gluon_loader():
    """The loader's img/s alone (0 and 4 worker threads, pinned), then
    resnet50_v1's TrainStep fed by it (0 and 4 workers) against the same
    step fed by NDArrayIter, each with its busy share. A measurement, not
    a bar; then the resizing transforms, card against host."""
    import tempfile

    import torch

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import gluon, image, nd, parallel
    from mxnet_tpu_torch.gluon.data.vision import ImageFolderDataset
    from mxnet_tpu_torch.gluon.data.vision import transforms as T

    root = tempfile.mkdtemp(prefix="chip_smoke_loader_")
    rng = np.random.RandomState(0)
    t0 = time.perf_counter()
    for i in range(GLUON_LOADER_IMAGES):
        d = os.path.join(root, "class%d" % (i % 4))
        os.makedirs(d, exist_ok=True)
        h, w = rng.randint(240, 321, 2)
        with open(os.path.join(d, "%04d.png" % i), "wb") as f:
            f.write(image.imencode(rng.randint(0, 256, (h, w, 3)).astype(
                np.uint8), ".png"))
    write_s = time.perf_counter() - t0
    mx.random.seed(0)
    ds = ImageFolderDataset(root).transform_first(T.Compose([
        T.RandomResizedCrop(224), T.RandomFlipLeftRight(), T.ToTensor(),
        T.Normalize(GLUON_MEAN, GLUON_STD)]))
    rates = {}

    def loader(workers):
        return gluon.data.DataLoader(ds, batch_size=RESNET_BATCH,
                                     shuffle=True, num_workers=workers,
                                     pin_memory=True, last_batch="discard")

    stages = _loader_stages(ds, tf_parts=(
        T.RandomResizedCrop(224), T.RandomFlipLeftRight(),
        T.Compose([T.ToTensor(), T.Normalize(GLUON_MEAN, GLUON_STD)])))
    threads = torch.get_num_threads()
    for workers, one_thread in [(w, False) for w in GLUON_LOADER_WORKERS] \
            + [(0, True)]:
        if one_thread:  # does the host's torch thread pool cost the ops?
            torch.set_num_threads(1)
        n = 0
        t0 = time.perf_counter()
        for data, label in loader(workers):
            n += data.shape[0]
        torch.cuda.synchronize()
        rates["workers_%d%s" % (workers, "_one_torch_thread" if one_thread
                                else "")] = n / (time.perf_counter() - t0)
        torch.set_num_threads(threads)
        if data.shape != (RESNET_BATCH, 3, 224, 224) or \
                not data._data.is_cuda or \
                not np.isfinite(data.asnumpy()).all():
            fail("gluon_loader: a batch %s on %s" % (data.shape,
                                                     data.context))
    net = _resnet50()
    step = parallel.TrainStep(net, gluon.loss.SoftmaxCrossEntropyLoss(),
                              "sgd", parallel.device_mesh(1),
                              optimizer_params=dict(RESNET_SGD))
    def from_loader(batches):
        data, label = next(batches)
        # float labels, as NDArrayIter's: one captured path for both feeds
        step(data, label.astype("float32"))

    from_loader(iter(loader(GLUON_LOADER_WORKERS[-1])))  # the capture
    steps = GLUON_LOADER_IMAGES // RESNET_BATCH - 1
    by_loader = {}
    for workers in GLUON_LOADER_WORKERS:
        fed = iter(loader(workers))
        by_loader["dataloader_%d_workers" % workers] = _device_profile(
            lambda: from_loader(fed), steps)
    xs, ys = _resnet_data(steps)
    it = iter(mx.io.NDArrayIter(xs.reshape((-1, 3, RESNET_SIDE,
                                            RESNET_SIDE)),
                                ys.reshape(-1).astype(np.float32),
                                RESNET_BATCH))

    def from_iter():
        batch = next(it)
        step(batch.data[0], batch.label[0])

    by_iter = _device_profile(from_iter, steps)
    if step.steady_state_recompiles != 0:
        fail("gluon_loader: the step recaptured")
    by_feed = dict(by_loader, ndarrayiter=by_iter)
    tf_errs, tf_ms = _transforms_card_vs_host(ds._data.items[0][0])
    phase("gluon_loader", card=CARD, images=len(ds), write_s=write_s,
          loader_img_per_s=rates, stage_ms_no_worker=stages,
          transform_card_vs_host_max_rel_err=tf_errs,
          transform_tol=GLUON_TRANSFORM_TOL, transform_ms_an_image=tf_ms,
          torch_threads=threads, steps=steps,
          trainstep_img_per_s={
              k: RESNET_BATCH * 1e3 / p["per_step_wall_ms"]
              for k, p in by_feed.items()},
          busy_share={k: p["device_busy_share"]
                      for k, p in by_feed.items()},
          profiles=by_feed)
    if not max(tf_errs.values()) <= GLUON_TRANSFORM_TOL:
        fail("gluon_loader: a transform on the card differs from the host "
             "by %s" % tf_errs)


def _transforms_card_vs_host(path):
    """Resize, CenterCrop (through its resize up) and RandomResizedCrop
    on the image at ``path`` on the card against the same on the host,
    seeded alike; fails unless the card's output stays on the card. The
    errors of the largest magnitude, and ms an image on each side."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import image, nd
    from mxnet_tpu_torch.gluon.data.vision import transforms as T

    host = image.imread(path)
    card = nd.array(host.asnumpy(), dtype=host.dtype)
    errs, ms = {}, {}
    for name, tf in (("Resize", T.Resize(224)),
                     ("CenterCrop", T.CenterCrop(352)),
                     ("RandomResizedCrop", T.RandomResizedCrop(224))):
        outs = []
        for img in (card, host):
            mx.random.seed(7)
            out = tf(img)
            if out.context != img.context:
                fail("gluon_loader: %s moved an image from %s to %s"
                     % (name, img.context, out.context))
            outs.append(out.asnumpy())
            ms["%s_%s" % (name, img.context.device_type)] = time_ms(
                lambda: tf(img), iters=10, warm=2)
        errs[name] = _rel_err(outs[0], outs[1], floor=1e-30)
    return errs, ms


def _loader_stages(ds, tf_parts, n=32):
    """Where the loader's time goes, one thread, over the first ``n``
    images: ms an image to read and decode, to crop and resize, to flip,
    to make the normalized tensor; ms a batch of ``n`` to stack, pin and
    copy to the card."""
    import torch

    from mxnet_tpu_torch import image
    from mxnet_tpu_torch.gluon.data import dataloader

    files = [f for f, _ in ds._data.items[:n]]
    out, t = {}, time.perf_counter()
    for i in range(n):  # the whole sample, as a loader's worker takes it
        ds[i]
    out["sample_ms"] = (time.perf_counter() - t) * 1e3 / n
    t = time.perf_counter()
    imgs = [image.imread(f) for f in files]
    out["decode_ms"] = (time.perf_counter() - t) * 1e3 / n
    for name, tf in zip(("crop_resize_ms", "flip_ms", "tensor_ms"),
                        tf_parts):
        t = time.perf_counter()
        imgs = [tf(i) for i in imgs]
        out[name] = (time.perf_counter() - t) * 1e3 / n
    t = time.perf_counter()
    batch = dataloader.default_batchify_fn(imgs)
    out["stack_ms_a_batch"] = (time.perf_counter() - t) * 1e3
    t = time.perf_counter()
    pinned = batch._data.pin_memory()
    out["pin_ms_a_batch"] = (time.perf_counter() - t) * 1e3
    t = time.perf_counter()
    pinned.to("cuda", non_blocking=True)
    torch.cuda.synchronize()
    out["copy_ms_a_batch"] = (time.perf_counter() - t) * 1e3
    return out


def gluon_dcgan():
    """dcgan.py at its defaults on the card (the adversarial mechanics it
    asserts itself), its first epoch on the CPU from the same seed: the
    first step of each player within GLUON_EXAMPLE_TOL."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.example.gluon import dcgan

    mx.random.seed(0)
    card = dcgan.run(dcgan.parse_args([]))
    mx.random.seed(0)
    cpu = dcgan.run(dcgan.parse_args(["--device", "cpu", "--epochs", "1"]))
    n = len(cpu["d_losses"])
    d_err = [abs(a - b) / abs(b) for a, b in zip(card["d_losses"][:n],
                                                 cpu["d_losses"])]
    g_err = [abs(a - b) / abs(b) for a, b in zip(card["g_losses"][:n],
                                                 cpu["g_losses"])]
    phase("gluon_dcgan", card=CARD, steps=len(card["d_losses"]),
          img_per_s=card["img_per_s"],
          d_loss_first_last=[card["d_losses"][0], card["d_losses"][-1]],
          g_loss_first_last=[card["g_losses"][0], card["g_losses"][-1]],
          sample_range=card["sample_range"],
          first_step_rel_err=[d_err[0], g_err[0]],
          epoch1_max_rel_err=[max(d_err), max(g_err)],
          tol=GLUON_EXAMPLE_TOL)
    if not max(d_err[0], g_err[0]) <= GLUON_EXAMPLE_TOL:
        fail("gluon_dcgan: the first step differs from the CPU's by %s"
             % [d_err[0], g_err[0]])


def gluon_style():
    """neural_style.py at its defaults on the card (IMPROVED), and on the
    CPU from the same seed: the first GLUON_STYLE_STEPS losses within
    GLUON_EXAMPLE_TOL."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.example.gluon import neural_style

    mx.random.seed(0)
    t0 = time.perf_counter()
    card = neural_style.run(neural_style.parse_args([]))
    card_s = time.perf_counter() - t0
    mx.random.seed(0)
    cpu = neural_style.run(neural_style.parse_args(["--device", "cpu"]))
    errs = [abs(a - b) / abs(b) for a, b in zip(card["losses"],
                                                cpu["losses"])]
    phase("gluon_style", card=CARD, iters=len(card["losses"]),
          run_s=card_s, ms_per_iter=card_s * 1e3 / len(card["losses"]),
          loss_first_last=[card["losses"][0], card["losses"][-1]],
          improved=card["improved"],
          first_steps_rel_err=errs[:GLUON_STYLE_STEPS],
          all_steps_max_rel_err=max(errs), tol=GLUON_EXAMPLE_TOL)
    if not card["improved"]:
        fail("gluon_style: NOT IMPROVED on the card")
    if not max(errs[:GLUON_STYLE_STEPS]) <= GLUON_EXAMPLE_TOL:
        fail("gluon_style: the first steps differ from the CPU's by %s"
             % errs[:GLUON_STYLE_STEPS])


def _cell_run(mx, make, xs, seed):
    """``make()`` built after ``seed``, unrolled 3 steps on ``xs`` under a
    fixed weighting of its outputs and states: outputs, the input's and
    every weight's gradient (numpy)."""
    from mxnet_tpu_torch import autograd, nd

    mx.random.seed(seed)
    cell = make()
    cell.initialize(mx.initializer.Xavier())
    x = nd.array(xs)
    x.attach_grad()
    with autograd.record():
        outs, states = cell.unroll(xs.shape[1], x, merge_outputs=True)
        flat = [outs] + list(states)
        head = None
        for k, o in enumerate(flat):
            w = nd.array(np.random.RandomState(40 + k).randn(
                *o.shape).astype(np.float32))
            term = (o * w).sum()
            head = term if head is None else head + term
    head.backward()
    return ([o.asnumpy() for o in flat],
            [x.grad.asnumpy()] + [p.grad().asnumpy() for p in
                                  cell.collect_params().values()])


def gluon_contrib():
    """The nine conv-RNN cells and LSTMPCell, card against CPU; the eight
    new initializers, card against CPU."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import initializer as init
    from mxnet_tpu_torch.gluon.contrib import rnn

    cases = {}
    for dims, spatial in ((1, (32,)), (2, (16, 16)), (3, (6, 8, 8))):
        for kind in ("RNN", "LSTM", "GRU"):
            cls = getattr(rnn, "Conv%dD%sCell" % (dims, kind))
            cases["conv%dd_%s" % (dims, kind.lower())] = (
                lambda cls=cls, spatial=spatial: cls(
                    (8,) + spatial, 16, 3, 3, i2h_pad=1), (4, 3, 8) + spatial)
    cases["lstmp"] = (lambda: rnn.LSTMPCell(64, 32), (8, 3, 48))
    errs = {}
    for name, (make, shape) in cases.items():
        xs = np.random.RandomState(1).randn(*shape).astype(np.float32)
        outs, grads = _cell_run(mx, make, xs, 2)
        with mx.cpu():
            c_outs, c_grads = _cell_run(mx, make, xs, 2)
        errs[name] = [max(_rel_err(a, b, floor=1e-30)
                          for a, b in zip(outs, c_outs)),
                      max(_rel_err(a, b, floor=1e-30)
                          for a, b in zip(grads, c_grads))]
    inits = {"constant": init.Constant(0.5), "orthogonal": init.Orthogonal(),
             "msraprelu": init.MSRAPrelu(), "bilinear": init.Bilinear(),
             "lstmbias": init.LSTMBias(), "fusedrnn": init.FusedRNN(
                 init.Uniform(), 64, 1, "lstm"),
             "load": init.Load({"x_weight": np.arange(
                 4096, dtype=np.float32).reshape(64, 64)}),
             "mixed": init.Mixed([".*"], [init.Orthogonal()])}
    init_errs = {}
    for name, ini in inits.items():
        vals = []
        for ctx in (mx.gpu(0), mx.cpu()):
            mx.random.seed(7)
            arr = mx.nd.zeros((64, 64, 2, 2) if name == "bilinear"
                              else (64, 64), ctx=ctx)
            desc = init.InitDesc("x_weight") if name != "lstmbias" else \
                init.InitDesc("x_bias", {"__init__": ini.dumps()})
            (ini if name != "lstmbias" else init.Uniform())(desc, arr)
            if arr.context != ctx:
                fail("gluon_contrib: %s left %s" % (name, ctx))
            vals.append(arr.asnumpy())
        init_errs[name] = float(np.abs(vals[0] - vals[1]).max())
    phase("gluon_contrib", card=CARD, cells_fwd_grad_max_rel_err=errs,
          initializers_max_abs_err=init_errs, tol=GLUON_CONTRIB_TOL,
          grad_tol=GLUON_CONTRIB_GRAD_TOL)
    bad = {k: v for k, v in errs.items() if v[0] > GLUON_CONTRIB_TOL
           or v[1] > GLUON_CONTRIB_GRAD_TOL}
    if bad or any(v != 0.0 for v in init_errs.values()):
        fail("gluon_contrib: the card disagrees with the CPU: %s %s"
             % (bad, init_errs))


def gluon_phases():
    gluon_resnet()
    gluon_export_cross()
    gluon_loader()
    gluon_dcgan()
    gluon_style()
    gluon_contrib()


# ---------------------------------------------------------------------------
# the bucketing and graph slice (slice 20)
# ---------------------------------------------------------------------------

# bucketing_wide: example/rnn/bucketing_lstm.py's model at the word LM's
# medium widths (PR 16); card against CPU over one batch a bucket from the
# same weights, each tensor within BUCKETING_TOL of its largest magnitude
# (at least 1): the RNN op's bar (cuDNN against the step loop, fp32, TF32
# off)
BUCKETING_WIDE = ["--num-hidden", "650", "--num-embed", "650",
                  "--batch-size", "32"]
BUCKETING_TOL = RNN_OP_TOL
GRAPH_TRACE_BATCHES = 9  # traced batches: three rounds of the 3 buckets
# control_flow_card / sequential_module: card against CPU, of the largest
# magnitude (at least 1); the module plane's fit against the eager fit
GRAPH_TOL, GRAPH_PLANE_TOL = 1e-5, 1e-6
GRAPH_PLANE_BATCHES, GRAPH_PLANE_EPOCHS = 8, 2
# memonger: the scan's gradients with and without remat
MEMONGER_GRAD_TOL = 1e-6


def _bucket_batches(bl, batch_size, ctx, seed=1):
    """One batch a bucket (8, 16, 24), drawn as the example draws its
    batches, on ``ctx``."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.io import DataBatch, DataDesc

    rs = np.random.RandomState(seed)
    out = []
    for bucket in bl.BUCKETS:
        length = rs.randint(bucket // 2 + 1, bucket + 1)
        seqs = rs.randint(1, bl.VOCAB, (batch_size, bucket)).astype(
            np.float32)
        seqs[:, length:] = 0
        labels = (seqs == 7).any(axis=1).astype(np.float32)
        out.append(DataBatch(
            data=[mx.nd.array(seqs, ctx=ctx)],
            label=[mx.nd.array(labels, ctx=ctx)],
            provide_data=[DataDesc("data", (batch_size, bucket))],
            provide_label=[DataDesc("softmax_label", (batch_size,))],
            bucket_key=bucket))
    return out


def _bucket_sharing(mod):
    """(buckets bound, parameter names whose argument, gradient or
    auxiliary arrays are not one memory across the buckets' executors)."""
    execs = [m._exec_group.execs[0] for m in mod._buckets.values()]
    default = mod._buckets[mod._default_bucket_key]
    apart = []
    for name in default._param_names + default._aux_names:
        for d in ("arg_dict", "grad_dict", "aux_dict"):
            held = [getattr(e, d)[name] for e in execs
                    if name in getattr(e, d)]
            if held and len({a._data.data_ptr() for a in held}) != 1:
                apart.append("%s:%s" % (d, name))
    return len(execs), apart


def _bucket_trace(bl, mod, batch_size):
    """A trace of GRAPH_TRACE_BATCHES batches of the example's loop body,
    the buckets in turn."""
    import mxnet_tpu_torch as mx

    import itertools

    batches = _bucket_batches(bl, batch_size, mx.gpu(0), seed=2)
    metric = mx.metric.Accuracy()
    turn = itertools.cycle(batches)

    def step():
        bl.train_batch(mod, next(turn), metric)

    for b in batches:  # every bucket bound before the trace
        bl.train_batch(mod, b, metric)
    return _device_profile(step, GRAPH_TRACE_BATCHES)


def bucketing_lstm():
    """The port's example/rnn/bucketing_lstm.py at its defaults on the
    card: improved, 3 buckets bound, every parameter one memory."""
    from mxnet_tpu_torch.example.rnn import bucketing_lstm as bl

    args = bl.parse_args([])
    res = bl.main([])
    buckets, apart = _bucket_sharing(res["module"])
    prof = _bucket_trace(bl, res["module"], args.batch_size)
    steady = res["seconds"][1:] or res["seconds"]
    phase("bucketing_lstm", card=CARD, epochs=args.epochs,
          batches=res["batches"], batch=args.batch_size,
          hidden=args.num_hidden, embed=args.num_embed,
          accuracy_first=res["accuracy"][0], accuracy_last=res["accuracy"][-1],
          improved=res["improved"], buckets=res["buckets"],
          first_epoch_s=res["seconds"][0],
          seq_per_s_median=float(np.median(res["seq_per_s"][1:]
                                           or res["seq_per_s"])),
          ms_per_batch_median=1e3 * float(np.median(steady))
          / res["batches"], profile=prof)
    if not res["improved"] or buckets != 3 or apart:
        fail("bucketing_lstm: improved %s, %d buckets bound, arrays apart "
             "across buckets %s" % (res["improved"], buckets, apart))


def _wide_run(bl, ctx, start=None):
    """bucketing_lstm's model at BUCKETING_WIDE on ``ctx``: one batch a
    bucket, forward_backward and update; (the initial weights, each
    batch's output, the final weights), numpy, by name."""
    import mxnet_tpu_torch as mx

    args = bl.parse_args(BUCKETING_WIDE + ["--device", "cpu"])
    mx.random.seed(0)
    mod = bl.build(args, ctx)
    if start is not None:
        mod.set_params({k: mx.nd.array(v, ctx=ctx) for k, v in
                        start.items()}, {})
    first = {k: v.asnumpy() for k, v in mod.get_params()[0].items()}
    metric = mx.metric.Accuracy()
    outs = []
    for batch in _bucket_batches(bl, args.batch_size, ctx):
        bl.train_batch(mod, batch, metric)
        outs.append(mod.get_outputs()[0].asnumpy())
    return mod, first, outs, {k: v.asnumpy()
                              for k, v in mod.get_params()[0].items()}


def bucketing_wide():
    """The bucketed LSTM at the word LM's medium widths: card against CPU
    over one batch a bucket, then a trace on the card."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.example.rnn import bucketing_lstm as bl

    _, start, out_cpu, w_cpu = _wide_run(bl, mx.cpu())
    mod, _, out_gpu, w_gpu = _wide_run(bl, mx.gpu(0), start)
    out_err = max(_rel_err(a, b) for a, b in zip(out_gpu, out_cpu))
    w_err = max(_rel_err(w_gpu[k], w_cpu[k]) for k in w_cpu)
    buckets, apart = _bucket_sharing(mod)
    args = bl.parse_args(BUCKETING_WIDE)
    prof = _bucket_trace(bl, mod, args.batch_size)
    phase("bucketing_wide", card=CARD, hidden=args.num_hidden,
          embed=args.num_embed, batch=args.batch_size, buckets=buckets,
          output_max_rel_err=out_err, weight_max_rel_err=w_err,
          tol=BUCKETING_TOL, profile=prof,
          ms_per_batch=prof["per_step_wall_ms"],
          seq_per_s=args.batch_size * 1e3 / prof["per_step_wall_ms"])
    if max(out_err, w_err) > BUCKETING_TOL or buckets != 3 or apart:
        fail("bucketing_wide: card against CPU %.3g / %.3g, %d buckets, "
             "arrays apart %s" % (out_err, w_err, buckets, apart))


def _chain(ctx, start=None):
    """Two modules chained (FullyConnected + tanh, then FullyConnected +
    SoftmaxOutput wired to its output), bound with input gradients."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import sym

    net1 = sym.Activation(sym.FullyConnected(sym.var("data"), name="fc1",
                                             num_hidden=512),
                          act_type="tanh", name="act1")
    net2 = sym.SoftmaxOutput(sym.FullyConnected(sym.var("data"), name="fc2",
                                                num_hidden=10),
                             name="softmax")
    mod = mx.module.SequentialModule()
    mod.add(mx.module.Module(net1, label_names=None, context=ctx))
    mod.add(mx.module.Module(net2, context=ctx), take_labels=True,
            auto_wiring=True)
    mod.bind(data_shapes=[("data", (64, 256))],
             label_shapes=[("softmax_label", (64,))], inputs_need_grad=True)
    mx.random.seed(0)
    mod.init_params(mx.initializer.Xavier())
    if start is not None:
        for m in mod._modules:
            names = m._param_names
            m.set_params({k: mx.nd.array(start[k], ctx=ctx) for k in names},
                         {})
    mod.init_optimizer(optimizer="sgd", optimizer_params={
        "learning_rate": 0.1, "momentum": 0.9})
    return mod


def _chain_run(ctx, start=None, steps=3):
    import mxnet_tpu_torch as mx

    mod = _chain(ctx, start)
    first = {k: v.asnumpy() for k, v in mod.get_params()[0].items()}
    rs = np.random.RandomState(0)
    got = []
    for _ in range(steps):
        batch = mx.io.DataBatch(
            data=[mx.nd.array(rs.randn(64, 256).astype(np.float32),
                              ctx=ctx)],
            label=[mx.nd.array(rs.randint(0, 10, 64).astype(np.float32),
                               ctx=ctx)])
        mod.forward(batch, is_train=True)
        mod.backward()
        got += [mod.get_outputs()[0].asnumpy(),
                mod.get_input_grads()[0].asnumpy()]
        mod.update()
    got += [v.asnumpy() for _, v in sorted(mod.get_params()[0].items())]
    return first, got


def sequential_module():
    """A two-module chain, 3 steps of forward, backward through the chain
    and update, card against CPU from the same weights."""
    import mxnet_tpu_torch as mx

    start, cpu = _chain_run(mx.cpu())
    _, gpu = _chain_run(mx.gpu(0), start)
    err = max(_rel_err(a, b) for a, b in zip(gpu, cpu))
    phase("sequential_module", card=CARD, steps=3, max_rel_err=err,
          tol=GRAPH_TOL)
    if not err <= GRAPH_TOL:
        fail("sequential_module: card against CPU %.3g" % err)


def _cf_symbols():
    """name -> (symbol, numpy inputs): a foreach RNN, the reference's
    while_loop over tensors, and a cond on each side, one with a
    non-finite untaken branch."""
    from mxnet_tpu_torch import sym

    rs = np.random.RandomState(0)
    T, B, I, H = 16, 32, 64, 256
    data, h0 = sym.var("data"), sym.var("h0")
    wx, wh = sym.var("wx"), sym.var("wh")

    def cell(x_t, states):
        h = sym.tanh(sym.dot(x_t, wx) + sym.dot(states[0], wh))
        return h, [h]

    outs, _ = sym.contrib.foreach(cell, data, [h0])
    rnn = sym.sum(outs)
    rnn_in = {"data": rs.randn(T, B, I), "h0": np.zeros((B, H)),
              "wx": rs.randn(I, H) * 0.1, "wh": rs.randn(H, H) * 0.05}
    i0, s0 = sym.var("i0"), sym.var("s0")
    w_outs, w_st = sym.contrib.while_loop(
        lambda i, s: sym.sum(i) <= 5 * 64,
        lambda i, s: ([i + s], [i + 1, s * 0.5 + i]), [i0, s0],
        max_iterations=10)
    loop = sym.Group([w_outs[0], w_st[0], w_st[1]])
    loop_in = {"i0": np.zeros(64), "s0": rs.randn(64)}
    x = sym.var("x")
    cond = sym.contrib.cond(sym.sum(x) > 0, lambda: sym.log(x) * 3,
                            lambda: x * x)
    cases = {"foreach_rnn": (rnn, rnn_in), "while_loop": (loop, loop_in),
             "cond_then": (cond, {"x": rs.rand(128) + 0.5}),
             "cond_else_non_finite": (cond, {"x": -rs.rand(128)})}
    return {k: (s, {n: v.astype(np.float32) for n, v in vals.items()})
            for k, (s, vals) in cases.items()}


def _cf_run(ctx, symbol, values):
    ex = symbol.simple_bind(ctx, **{k: v.shape for k, v in values.items()})
    for k, v in values.items():
        ex.arg_dict[k][:] = v
    outs = [o.asnumpy() for o in ex.forward(is_train=True)]
    ex.backward()
    return outs + [ex.grad_dict[k].asnumpy() for k in sorted(values)]


def _cf_plane_symbol():
    """A foreach RNN over the batch's time axis whose last state goes
    through a cond into FullyConnected + SoftmaxOutput."""
    from mxnet_tpu_torch import sym

    tbi = sym.transpose(sym.var("data"), axes=(1, 0, 2))
    wx = sym.var("rnn_wx_weight", shape=(32, 128))
    wh = sym.var("rnn_wh_weight", shape=(128, 128))

    def cell(x_t, states):
        h = sym.tanh(sym.dot(x_t, wx) + sym.dot(states[0], wh))
        return h, [h]

    _, states = sym.contrib.foreach(cell, tbi, [sym.zeros((64, 128))])
    h = states[0]
    g = sym.contrib.cond(sym.sum(h) > 0, lambda: sym.log(sym.abs(h) + 1),
                         lambda: h * 2)
    return sym.SoftmaxOutput(sym.FullyConnected(g, num_hidden=4, name="fc"),
                             name="softmax")


def _cf_fit(plane_on):
    """Module.fit over _cf_plane_symbol on the card; (module, the planes
    its fit made, graph steps, demotions by reason during it)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import trainplane

    rs = np.random.RandomState(3)
    n = GRAPH_PLANE_BATCHES * 64
    xs = rs.randn(n, 12, 32).astype(np.float32)
    ys = rs.randint(0, 4, n).astype(np.float32)
    made, orig = _planes_made()
    prev = os.environ.get("MXNET_TRAINSTEP")
    os.environ["MXNET_TRAINSTEP"] = "1" if plane_on else "0"
    try:
        with mx.gpu(0):
            it = mx.io.NDArrayIter(xs, ys, 64)
            mod = mx.mod.Module(_cf_plane_symbol())
            mx.random.seed(0)
            before = _plane_counts()
            mod.fit(it, num_epoch=GRAPH_PLANE_EPOCHS,
                    initializer=mx.initializer.Xavier(), optimizer="sgd",
                    optimizer_params={"learning_rate": 0.1,
                                      "momentum": 0.9})
            after = _plane_counts()
    finally:
        trainplane.module_plane = orig
        if prev is None:
            del os.environ["MXNET_TRAINSTEP"]
        else:
            os.environ["MXNET_TRAINSTEP"] = prev
    demoted = {k: v - before[0].get(k, 0.0) for k, v in after[0].items()
               if v != before[0].get(k, 0.0)}
    return mod, made, after[1] - before[1], demoted


def control_flow_card():
    """foreach, while_loop and cond forward and backward, card against
    CPU; then a Module.fit over a foreach + cond symbol on the module
    plane (one capture, a replay a batch, no demotion) against the eager
    fit."""
    import torch

    import mxnet_tpu_torch as mx

    errs = {}
    for name, (symbol, values) in _cf_symbols().items():
        cpu = _cf_run(mx.cpu(), symbol, values)
        gpu = _cf_run(mx.gpu(0), symbol, values)
        if not all(np.isfinite(a).all() for a in gpu):
            fail("control_flow_card: %s gave non-finite values" % name)
        errs[name] = max(_rel_err(a, b) for a, b in zip(gpu, cpu))
    graph, made, steps, demoted = _cf_fit(True)
    eager, _, eager_steps, _ = _cf_fit(False)
    torch.cuda.synchronize()
    (ga, _), (ea, _) = graph.get_params(), eager.get_params()
    plane_err = max(float((ga[k]._data - ea[k]._data).abs().max())
                    for k in ga)
    plane = made[0] if made else None
    captures = plane.compile_count if plane is not None else 0
    want = GRAPH_PLANE_BATCHES * GRAPH_PLANE_EPOCHS
    phase("control_flow_card", card=CARD, max_rel_err=errs, tol=GRAPH_TOL,
          plane_captures=captures, plane_graph_steps=steps,
          plane_batches=want, plane_demotions=demoted,
          eager_graph_steps=eager_steps,
          plane_vs_eager_max_abs_err=plane_err, plane_tol=GRAPH_PLANE_TOL)
    if max(errs.values()) > GRAPH_TOL or captures != 1 or steps != want \
            or demoted or eager_steps != 0 or plane_err > GRAPH_PLANE_TOL:
        fail("control_flow_card: errors %s, %d captures, %d graph steps "
             "of %d, demotions %s, plane against eager %.3g"
             % (errs, captures, steps, want, demoted, plane_err))


def subgraph_card():
    """An MLP partitioned into one _subgraph_op against the whole graph
    on the card: outputs and gradients (bit-equal expected: the fused
    node runs the same ops in the same order)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import subgraph, sym

    data, w1, w2 = sym.var("data"), sym.var("w1"), sym.var("w2")
    h = sym.Activation(sym.FullyConnected(data, weight=w1, no_bias=True,
                                          num_hidden=512, name="fc1"),
                       act_type="relu", name="act1")
    whole = sym.FullyConnected(h, weight=w2, no_bias=True, num_hidden=10,
                               name="fc2")
    part = subgraph.partition_graph(whole, ["FullyConnected", "Activation"])
    rs = np.random.RandomState(4)
    values = {"data": rs.randn(256, 1024), "w1": rs.randn(512, 1024) * 0.03,
              "w2": rs.randn(10, 512) * 0.05}
    values = {k: v.astype(np.float32) for k, v in values.items()}
    got = {name: _cf_run(mx.gpu(0), s, values)
           for name, s in (("whole", whole), ("partitioned", part))}
    diff = max(float(np.abs(a - b).max())
               for a, b in zip(got["partitioned"], got["whole"]))
    equal = all(np.array_equal(a, b)
                for a, b in zip(got["partitioned"], got["whole"]))
    ops = [n.op for n in part._topo_nodes() if not n.is_var()]
    phase("subgraph_card", card=CARD, ops=ops, bitwise_equal=equal,
          max_abs_diff=diff)
    if ops != ["_subgraph_op"] or diff > GRAPH_TOL:
        fail("subgraph_card: ops %s, partitioned against whole %.3g"
             % (ops, diff))


def memonger():
    """The port's example/memcost/memonger.py at its defaults on the card:
    both findings' MB and the ratio; bars only on the scan's gradients
    with and without remat agreeing."""
    from mxnet_tpu_torch.example.memcost import memonger as mem

    args = mem.parse_args([])
    res = mem.main([])
    mb = 2.0 ** 20
    phase("memonger", card=CARD, depth=args.depth, width=args.width,
          batch=args.batch_size,
          trainstep_mb={k: v / mb for k, v in res["trainstep_bytes"].items()},
          scan_mb={k: v / mb for k, v in res["scan_bytes"].items()},
          scan_seconds=res["scan_seconds"], ratio=res["ratio"],
          jax_gate_sublinear=res["sublinear"],
          grad_max_abs_diff=res["grad_max_abs_diff"],
          tol=MEMONGER_GRAD_TOL)
    if not res["grad_max_abs_diff"] <= MEMONGER_GRAD_TOL:
        fail("memonger: the scan's gradients with and without remat "
             "differ by %.3g" % res["grad_max_abs_diff"])


def graph_phases():
    bucketing_lstm()
    bucketing_wide()
    sequential_module()
    control_flow_card()
    subgraph_card()
    memonger()


# ---------------------------------------------------------------------------
# slice 21: the replica fleet and the HBM pressure governor
# ---------------------------------------------------------------------------

# fleet_serve: 2 replicas of the decode bench's engine (MODEL, SLOTS,
# MAX_SEQ, PAGE), N_REQ requests over FLEET_SYSTEMS system prompts of
# FLEET_SYS_LEN tokens (the last FLEET_DUPS repeat an earlier prompt whole:
# their partial page is copied on write) and FLEET_SPEC_N prompt-lookup
# requests of the tenant "spec", the only one speculating (k = SPEC_K)
FLEET_REPLICAS, FLEET_SYSTEMS, FLEET_SYS_LEN = 2, 4, 64
FLEET_DUPS, FLEET_SPEC_N = 4, 8
FLEET_BUCKETS = (16, 32, 64, 128)
FLEET_MEM_TOL = 64 * 2 ** 20  # memory_reserved after a rebuild vs before
DEVPROF_FLOOR = 0.9  # event ms over the profiler's kernel ms, at least
DEVPROF_REPLAYS = 20  # replays of each path in the per-site cross-check
DEVPROF_SITES = {"step": "serving.decode_step",
                 "prefill": "serving.decode_prefill",
                 "chunk": "serving.decode_prefill_chunk",
                 "cow": "serving.decode_cow"}
# hbm_governor: the decode soak under chaos action=oom at prefill
HBM_SOAK_N = 24
HBM_SOAK_SPEC = "seed=5,site=serving.decode.prefill,p=0.15,action=oom"


def _fleet_traffic():
    """(prompt, max_new, tenant, system prompt index or None) of the
    fleet's traffic, from RandomState(3)."""
    rng = np.random.RandomState(3)
    vocab = MODEL["vocab_size"]
    systems = [rng.randint(1, vocab, FLEET_SYS_LEN).astype(np.int32)
               for _ in range(FLEET_SYSTEMS)]
    reqs = []
    for i in range(N_REQ - FLEET_DUPS):
        suffix = rng.randint(1, vocab, int(rng.randint(4, 24)))
        reqs.append((np.concatenate([systems[i % FLEET_SYSTEMS],
                                     suffix]).astype(np.int32),
                     min(OUT_MIX[i % len(OUT_MIX)], OUT_CAP), None,
                     i % FLEET_SYSTEMS))
    for i in range(FLEET_DUPS):
        prompt, _m, _t, system = reqs[i]
        reqs.append((prompt, 16, None, system))
    for _ in range(FLEET_SPEC_N):
        motif = rng.randint(1, vocab, 4).astype(np.int32)
        reqs.append((np.concatenate([motif, motif, motif[:2]]), SPEC_OUT,
                     "spec", None))
    return reqs


def _fleet_engine(model, params, name):
    """One replica: the decode bench's engine, speculating at SPEC_K with
    prompt lookup for the tenant that asks (every other tenant's cap is
    0), prefix cache on, monolithic prefill."""
    from mxnet_tpu_torch import serving

    eng = serving.DecodeEngine(
        model, params, num_slots=SLOTS, max_seq_len=MAX_SEQ,
        page_size=PAGE, timeout_ms=0, name=name,
        prefill_buckets=FLEET_BUCKETS, prefix_cache=True, spec_k=SPEC_K,
        spec_draft="prompt_lookup")
    eng.set_tenant_spec_k("default", 0)
    eng.set_tenant_spec_k("spec", SPEC_K)
    return eng


def _submit_all(door, reqs):
    t0 = time.perf_counter()
    futs = [door.submit(p, m, tenant=t) for p, m, t, _s in reqs]
    outs = [f.result(timeout=600) for f in futs]
    return outs, time.perf_counter() - t0


def _ticks(stats_doc):
    """Decode ticks of an engine's or a fleet's stats."""
    if "replicas" in stats_doc:
        return sum(s.get("ticks", 0) for s in stats_doc["replicas"].values())
    return stats_doc["ticks"]


def _http_get(port, path):
    """GET ``path`` from the local httpd: (status, body). Straight to
    127.0.0.1, never through a proxy the environment names."""
    import urllib.error
    import urllib.request

    opener = urllib.request.build_opener(urllib.request.ProxyHandler({}))
    try:
        with opener.open("http://127.0.0.1:%d%s" % (port, path),
                         timeout=30) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _devprof_cross_check(eng):
    """Each device path of ``eng`` replayed DEVPROF_REPLAYS times under
    torch.profiler with devprof sampling every replay: a site's summed
    CUDA-event ms must be at least DEVPROF_FLOOR of the profiler's summed
    kernel time for the same replays (an event pair spans the kernels
    and the gaps between them), and no more than the replays' host wall.
    The replays run on the engine's worker, after the traffic (the paths
    replay their last operands, whose writes land in pages no live
    sequence holds); the profiler runs on this thread. A session in
    which the profiler recorded no kernel is run again after a pause,
    five sessions at most, as in ``_profiled_us``: the three readings
    of a path come from one session."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from mxnet_tpu_torch.telemetry import devprof

    def replays(path, site):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(DEVPROF_REPLAYS):
            eng._replay(path, site)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    def session(path, site):
        for attempt in range(5):
            if attempt:
                time.sleep(0.2)
            before = devprof.DEVICE_SECONDS.value(site=site)
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                wall_ms = eng._on_worker(lambda: replays(path, site))
            event_ms = (devprof.DEVICE_SECONDS.value(site=site)
                        - before) * 1e3
            kernel_ms = sum(e.time_range.elapsed_us() / 1e3
                            for e in prof.events()
                            if e.device_type == DeviceType.CUDA)
            if kernel_ms > 0.0:
                break
        return event_ms, kernel_ms, wall_ms, attempt + 1

    sites = {}
    devprof.set_sample(1.0)
    try:
        for key, path in list(eng._paths.items()):
            if path.graph is None:
                continue
            site = DEVPROF_SITES[key[0]]
            event_ms, kernel_ms, wall_ms, tries = session(path, site)
            if kernel_ms <= 0.0:
                fail("devprof cross-check %s: the profiler saw no kernel "
                     "of the %s path in five sessions" % (site, key))
            row = sites.setdefault(site, [0.0, 0.0, 0.0, 0])
            row[0] += event_ms
            row[1] += kernel_ms
            row[2] += wall_ms
            row[3] += tries
    finally:
        devprof.set_sample(0.0)
    for site, (event_ms, kernel_ms, wall_ms, _n) in sites.items():
        if event_ms < DEVPROF_FLOOR * kernel_ms:
            fail("devprof cross-check %s: CUDA events read %.4f ms, under "
                 "%.0f%% of the profiler's %.4f ms of kernels"
                 % (site, event_ms, DEVPROF_FLOOR * 100, kernel_ms))
        if event_ms > wall_ms:
            fail("devprof cross-check %s: CUDA events read %.4f ms, more "
                 "than the replays' host wall %.4f ms"
                 % (site, event_ms, wall_ms))
    return {site: {"event_ms": e, "profiler_kernel_ms": k, "wall_ms": w,
                   "event_over_kernel": e / k, "profiler_sessions": n}
            for site, (e, k, w, n) in sites.items()}


def fleet_serve():
    """Two replicas behind ``FleetRouter`` at the decode bench's width:
    oracle-exact outputs, prefix affinity, traces, devprof's CUDA-event
    sites, a rolling swap, a replica killed and rebuilt, httpd. Returns
    the main run's launches of kernels 1 and 2."""
    import torch

    from mxnet_tpu_torch import serving, telemetry
    from mxnet_tpu_torch.telemetry import devprof, tracing

    model = serving.TinyDecoder(**MODEL)
    params = model.init_params(0)  # no device given: the card
    reqs = _fleet_traffic()
    layers = MODEL["num_layers"]

    # one engine on the same traffic: the baseline of tokens/s and of the
    # prefix hit ratio
    eng = _fleet_engine(model, params, "chip_smoke_fleet_single")
    try:
        eng.warmup()
        single0 = eng.stats()
        single_outs, single_wall = _submit_all(eng, reqs)
        single = eng.stats()
        single_ticks = single["ticks"] - single0["ticks"]
    finally:
        eng.close()
        eng.release()
    single_tokens = int(sum(len(o) for o in single_outs))

    os.environ["MXNET_FLEET_SPILL_DEPTH"] = str(10 * len(reqs))  # no spill
    fleet = serving.FleetRouter(
        lambda name: _fleet_engine(model, params, name),
        replicas=FLEET_REPLICAS, name="chip_smoke_fleet")
    server = None
    orig_note = devprof.note_decode_tick
    ticks_seen = []
    try:
        for rep in fleet._replicas:
            if rep.engine.device.type != "cuda":
                fail("fleet replica %s runs on %s, not the card"
                     % (rep.name, rep.engine.device))
        warm = fleet.warmup()
        fleet.configure_speculation("default", 0)
        fleet.configure_speculation("spec", SPEC_K)
        st0 = fleet.stats()
        # run A: cold caches, sampling off
        outs_a, wall_a = _submit_all(fleet, reqs)
        st_a = fleet.stats()
        ticks_a = _ticks(st_a) - _ticks(st0)
        if st_a["prefix_hit_ratio"] != single["prefix_hit_ratio"]:
            fail("fleet prefix hit ratio %.6f != one replica's %.6f on the "
                 "same traffic" % (st_a["prefix_hit_ratio"],
                                   single["prefix_hit_ratio"]))
        # a rolling swap to the same weights flushes every prefix index:
        # run B starts as cold as run A
        swapped = fleet.rolling_swap(params, variant="same")
        # run B, the main path: tracing and devprof sampling every request
        # and every tick
        tracing.clear()
        tracing.set_sample(1.0)
        devprof.reset()
        devprof.set_sample(1.0)

        def note(server_name, wall_ms, tokens=0):
            device = sum(devprof.tick_device_ms().values())
            ticks_seen.append((wall_ms, device))
            orig_note(server_name, wall_ms, tokens)

        devprof.note_decode_tick = note
        st1 = fleet.stats()
        _reset_launches()
        outs_b, wall_b = _submit_all(fleet, reqs)
        launches = _read_launches()
        devprof.note_decode_tick = orig_note
        devprof.set_sample(0.0)
        tracing.set_sample(0.0)
        st_b = fleet.stats()
        ticks_b = _ticks(st_b) - _ticks(st1)
        chunks_b = sum(s["prefill_chunks"]
                       for s in st_b["replicas"].values()) \
            - sum(s["prefill_chunks"] for s in st1["replicas"].values())
        for what, outs in (("fleet run A", outs_a), ("fleet run B", outs_b)):
            diff = [i for i, (a, b) in enumerate(zip(single_outs, outs))
                    if not np.array_equal(a, b)]
            if diff:
                fail("%s outputs differ from one engine's (requests %s)"
                     % (what, diff[:8]))
        _check_oracle(model, params, [(p, m) for p, m, _t, _s in reqs],
                      outs_b, "fleet_serve")
        if st_b["steady_state_recompiles"] != 0 or \
                sum(s["compile_count"] for s in st_b["replicas"].values()) \
                != warm:
            fail("fleet recaptured a path after warmup (a rolling swap "
                 "included): steady %s" % st_b["steady_state_recompiles"])
        # placement and traces
        fleet_traces = []
        for tid in tracing.trace_ids():
            t = telemetry.get_trace(tid)
            kinds = [e["kind"] for e in t["events"]]
            if kinds[0] != "submit" or kinds[-1] != "complete" or \
                    not t["done"]:
                fail("trace %s (%s) runs %s, not submit -> ... -> complete"
                     % (tid, t["plane"], kinds))
            if t["plane"] == "fleet":
                ev = t["events"]
                fleet_traces.append((ev[0]["rid"], next(
                    e["replica"] for e in ev if e["kind"] == "replica_route")))
        planes = {telemetry.get_trace(t)["plane"]
                  for t in tracing.trace_ids()}
        if len(fleet_traces) != len(reqs) or planes != {"fleet", "decode"}:
            fail("%d fleet traces for %d requests (planes %s)"
                 % (len(fleet_traces), len(reqs), sorted(planes)))
        fleet_traces.sort()
        placed = {}
        for (_rid, replica), (_p, _m, _t, system) in zip(fleet_traces, reqs):
            if system is not None:
                placed.setdefault(system, set()).add(replica)
        split = {s: sorted(r) for s, r in placed.items() if len(r) > 1}
        if split:
            fail("system prompts placed on several replicas: %s" % split)
        # devprof: all four sites, read by CUDA events, each tick's device
        # time within its host wall
        sites = {row["labels"]["site"]: row
                 for row in devprof.DEVICE_TIME_MS.series()}
        missing = sorted(set(DEVPROF_SITES.values()) - set(sites))
        if missing:
            fail("devprof recorded no %s in the sampled run" % missing)
        for site, row in sites.items():
            if not row["count"] or row["sum"] <= 0.0:
                fail("devprof %s: %d readings summing %.6f ms"
                     % (site, row["count"], row["sum"]))
        over = [(w, d) for w, d in ticks_seen if d > w]
        if not ticks_seen or over:
            fail("devprof: %d timed ticks, %d with device ms above their "
                 "host wall (first %s)" % (len(ticks_seen), len(over),
                                           over[:1]))
        if launches[1] < ticks_b * layers or \
                launches[0] < chunks_b * layers or not launches[0]:
            fail("fleet run B: kernel 1 launched %d times for %d prefill "
                 "chunks, kernel 2 %d times for %d ticks, x %d layers"
                 % (launches[0], chunks_b, launches[1], ticks_b, layers))
        # a rolling swap under load drops nothing and recaptures nothing
        load = [fleet.submit(p, m, tenant=t) for p, m, t, _s in reqs[:SLOTS]]
        swapped += fleet.rolling_swap(params, variant="under_load")
        got = [f.result(timeout=600) for f in load]
        for i, o in enumerate(got):
            if not np.array_equal(o, single_outs[i]):
                fail("rolling swap under load changed request %d" % i)
        # a replica killed under load: every request answered once, the
        # rebuild captures its own graphs, the dead one's memory returns
        # (both readings after a collection: an unreachable engine of an
        # earlier phase holds its pools until the collector runs)
        torch.cuda.synchronize()
        gc.collect()
        torch.cuda.empty_cache()
        reserved_before = torch.cuda.memory_reserved()
        done0 = fleet.stats()["router"]
        load = [fleet.submit(p, m, tenant=t) for p, m, t, _s in reqs]
        fleet.kill_replica(0, restart=True)
        got = [f.result(timeout=600) for f in load]
        for i, o in enumerate(got):
            if not np.array_equal(o, single_outs[i]):
                fail("kill_replica: request %d's output changed" % i)
        deadline = time.time() + 300
        while fleet.debug_state()["replicas"]["chip_smoke_fleet.r0"][
                "state"] != "live":
            if time.time() > deadline:
                fail("the killed replica was not rebuilt in 300 s")
            time.sleep(0.1)
        done1 = fleet.stats()["router"]
        answered = done1["completed"] - done0["completed"]
        if answered != len(reqs) or done1["failed"] != done0["failed"]:
            fail("kill_replica: %d of %d requests completed, %d failed"
                 % (answered, len(reqs),
                    done1["failed"] - done0["failed"]))
        after_kill = fleet.stats()
        rebuilt = after_kill["replicas"]["chip_smoke_fleet.r0"]
        if rebuilt.get("steady_state_recompiles") != 0:
            fail("the rebuilt replica recaptured after its warmup: %s"
                 % rebuilt.get("steady_state_recompiles"))
        torch.cuda.synchronize()
        gc.collect()
        torch.cuda.empty_cache()
        reserved_after = torch.cuda.memory_reserved()
        if abs(reserved_after - reserved_before) > FLEET_MEM_TOL:
            fail("memory_reserved %d before the kill, %d after the rebuild"
                 % (reserved_before, reserved_after))
        # httpd
        server = telemetry.start_httpd(port=0)
        port = server.server_address[1]
        code_m, body_m = _http_get(port, "/metrics")
        code_h, body_h = _http_get(port, "/healthz")
        code_s, body_s = _http_get(port, "/debug/state")
        health = json.loads(body_h)
        state = json.loads(body_s)
        if code_m != 200 or b"mxnet_fleet_replicas" not in body_m or \
                code_h not in (200, 503) or "status" not in health or \
                code_s != 200 or "chip_smoke_fleet" not in state.get(
                    "fleet", {}):
            fail("httpd: /metrics %d, /healthz %d %s, /debug/state %d"
                 % (code_m, code_h, health.get("status"), code_s))
        cross = _devprof_cross_check(fleet._replicas[1].engine)
    finally:
        devprof.note_decode_tick = orig_note
        devprof.set_sample(0.0)
        tracing.set_sample(0.0)
        if server is not None:
            telemetry.stop_httpd()
        fleet.close()
        for rep in fleet._replicas:
            rep.engine.release()
        os.environ.pop("MXNET_FLEET_SPILL_DEPTH", None)
    tokens = int(sum(len(o) for o in outs_b))
    phase("fleet_serve", replicas=FLEET_REPLICAS, requests=len(reqs),
          tokens=tokens, outputs_equal_oracle=True,
          one_engine_tokens_per_s=single_tokens / single_wall,
          one_engine_ticks=single_ticks,
          one_engine_ms_per_tick=single_wall * 1e3 / max(single_ticks, 1),
          fleet_tokens_per_s_sampling_0=tokens / wall_a,
          fleet_tokens_per_s_sampling_1=tokens / wall_b,
          ticks_sampling_0=ticks_a, ticks_sampling_1=ticks_b,
          ms_per_replica_tick_sampling_0=wall_a * 1e3 * FLEET_REPLICAS
          / max(ticks_a, 1),
          ms_per_replica_tick_sampling_1=wall_b * 1e3 * FLEET_REPLICAS
          / max(ticks_b, 1),
          prefix_hit_ratio=st_a["prefix_hit_ratio"],
          one_engine_prefix_hit_ratio=single["prefix_hit_ratio"],
          placement={str(s): sorted(r) for s, r in placed.items()},
          traces=len(tracing.trace_ids()), rolling_swaps=swapped,
          devprof_sites={s: {"readings": r["count"], "ms": r["sum"]}
                         for s, r in sites.items()},
          timed_ticks=len(ticks_seen), devprof_cross_check=cross,
          kill_answered=answered, reserved_before=reserved_before,
          reserved_after=reserved_after, healthz=[code_h,
                                                   health.get("status")],
          kernel_launches=list(launches), prefill_chunks=chunks_b,
          card=CARD)
    return launches


def hbm_governor():
    """The pressure governor on the card: a real allocation over a capped
    allocator raises ``torch.OutOfMemoryError``, which ``classify`` calls
    ``device``; ``oom_survival`` latches red (/healthz 503) and the latch
    releases after ``MXNET_HBM_RED_HOLD`` observations; a decode soak
    under chaos ``action=oom`` at prefill stays oracle-exact with the
    governed admit; a ``TrainPlane`` step that OOMs leaves a dump and
    demotes to eager."""
    import torch

    from mxnet_tpu_torch import gluon, nd, serving, telemetry, trainplane
    from mxnet_tpu_torch.resilience import chaos, hbm
    from mxnet_tpu_torch.telemetry import flightrec

    out_dir = tempfile.mkdtemp(prefix="chip_smoke_hbm_")
    os.environ["MXNET_FLIGHTREC_PATH"] = os.path.join(out_dir,
                                                      "flightrec_hbm.json")
    hbm.reset()
    gov = hbm.governor()
    server = telemetry.start_httpd(port=0)
    port = server.server_address[1]
    fields = {}
    try:
        # a real OOM
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        free, total = torch.cuda.mem_get_info()
        cap = torch.cuda.memory_reserved() + 256 * 2 ** 20
        torch.cuda.set_per_process_memory_fraction(cap / total)
        try:
            torch.empty(2 * 2 ** 30, dtype=torch.uint8, device="cuda")
        except torch.OutOfMemoryError as exc:
            oom = exc
        else:
            fail("a 2 GiB allocation under a %d-byte cap did not raise"
                 % cap)
        finally:
            torch.cuda.set_per_process_memory_fraction(1.0)
        kind = hbm.classify(oom)
        if kind != "device":
            fail("classify(torch.OutOfMemoryError) = %r" % kind)
        if not hbm.oom_survival("chip_smoke.hbm", oom, dump=True):
            fail("oom_survival did not take the real OOM")
        code, body = _http_get(port, "/healthz")
        health = json.loads(body)
        if code != 503 or not health["pressure"]["latched"]:
            fail("/healthz %d %s after the OOM latch" % (code, health))
        holds = 0
        while gov.latched:
            gov.observe(source="chip_smoke")
            holds += 1
            if holds > 100:
                fail("the red latch held past 100 observations")
        code, body = _http_get(port, "/healthz")
        health = json.loads(body)
        if health["pressure"]["latched"] or health["pressure"]["tier"] \
                == "red" or holds != gov.red_hold:
            fail("the latch released after %d observations (hold %d): %s"
                 % (holds, gov.red_hold, health["pressure"]))
        report = gov.oom_report()
        fields.update(real_oom_kind=kind, latch_released_after=holds,
                      healthz_after_release=[code, health["status"]],
                      capacity_bytes=report["capacity_bytes"],
                      device_memory=report["device_memory"])
        # the decode soak under chaos action=oom at prefill
        model = serving.TinyDecoder(**MODEL)
        params = model.init_params(0)
        rng = np.random.RandomState(6)
        reqs = [(rng.randint(1, MODEL["vocab_size"],
                             int(rng.randint(4, 40))).astype(np.int32),
                 int(rng.choice([16, 32, 64]))) for _ in range(HBM_SOAK_N)]
        # the OOMs are request-level failures that feed the tenant's
        # breaker; held shut here so every request meets the governor
        prev = _swap_env({"MXNET_TENANT_BREAKER_THRESHOLD": "1000000"})
        eng = serving.DecodeEngine(
            model, params, num_slots=SLOTS, max_seq_len=MAX_SEQ,
            page_size=PAGE, timeout_ms=0, name="chip_smoke_hbm_soak",
            prefill_buckets=(16, 32, 64), prefix_cache=True)
        try:
            warm = eng.warmup()
            chaos.configure(HBM_SOAK_SPEC)
            try:
                futs = [eng.submit(p, m) for p, m in reqs]
                outs, failed = {}, []
                for i, f in enumerate(futs):
                    try:
                        outs[i] = f.result(timeout=600)
                    except Exception as exc:  # noqa: BLE001 - tallied
                        if hbm.classify(exc) is None:
                            raise
                        failed.append(i)
            finally:
                chaos.disable()
            mid = eng.stats()
            for i in failed:  # the recovery wave, chaos off
                outs[i] = eng.submit(*reqs[i]).result(timeout=600)
            st = eng.stats()
        finally:
            eng.close()
            eng.release()
            _restore_env(prev)
        _check_oracle(model, params, reqs, [outs[i] for i in range(len(reqs))],
                      "hbm_governor soak")
        if not failed or "red" not in gov.tiers_seen() or \
                mid["hbm"]["oom_count"] < 1:
            fail("the soak saw %d OOM failures, tiers %s, oom_count %d"
                 % (len(failed), gov.tiers_seen(), mid["hbm"]["oom_count"]))
        if st["hbm"]["latched"] or st["hbm"]["tier"] == "red" or \
                st.get("steady_state_recompiles") != 0 or \
                st["compile_count"] != warm:
            fail("after the soak: %s, steady %s" % (st["hbm"],
                 st.get("steady_state_recompiles")))
        fields.update(soak_requests=len(reqs), soak_oom_failures=len(failed),
                      soak_evictions=st["evictions"],
                      soak_tiers_seen=gov.tiers_seen(),
                      soak_oom_count=st["hbm"]["oom_count"])
        # a TrainPlane step that OOMs (chaos action=oom at the jit.compile
        # site the graph step passes): a dump, and the eager plane
        net = gluon.nn.HybridSequential()
        net.add(gluon.nn.Dense(64, activation="relu"), gluon.nn.Dense(4))
        net.initialize()
        trainer = gluon.Trainer(net.collect_params(), "sgd",
                                {"learning_rate": 0.1})
        plane = trainplane.TrainPlane(
            net, gluon.loss.SoftmaxCrossEntropyLoss(), trainer)
        xs = np.random.RandomState(7).randn(32, 16).astype(np.float32)
        ys = xs[:, :4].argmax(1).astype(np.float32)
        dumps0 = flightrec.last_dump_path()
        chaos.configure("seed=1,site=jit.compile,p=1.0,max=1,action=oom")
        try:
            loss = plane.step(nd.array(xs), nd.array(ys))
        finally:
            chaos.disable()
        loss = float(np.asarray(loss.asnumpy()).mean())
        path = flightrec.last_dump_path()
        with open(path) as f:
            doc = json.load(f)
        if not np.isfinite(loss) or plane.plane != "eager" or \
                not doc["reason"].startswith("hbm oom at trainplane.step") \
                or not any(e["kind"] == "hbm.oom" for e in doc["events"]):
            fail("TrainPlane OOM: loss %s, plane %s, dump %s (%s)"
                 % (loss, plane.plane, path, doc.get("reason")))
        while gov.latched:
            gov.observe(source="chip_smoke")
        fields.update(trainplane_plane=plane.plane, trainplane_loss=loss,
                      trainplane_dump_events=len(doc["events"]),
                      trainplane_reason=plane._why_eager,
                      dumps_before=dumps0 is not None)
    finally:
        torch.cuda.set_per_process_memory_fraction(1.0)
        torch.cuda.empty_cache()
        telemetry.stop_httpd()
        chaos.disable()
        os.environ.pop("MXNET_FLIGHTREC_PATH", None)
        shutil.rmtree(out_dir, ignore_errors=True)
    phase("hbm_governor", card=CARD, **fields)


def fleet_phases():
    """The slice's two phases (``--fleet``): the paged kernels build at
    first use."""
    launches = fleet_serve()
    hbm_governor()
    return launches


# ---------------------------------------------------------------------------
# slice 22: request-granularity serving (bench.py's BENCH_SERVING=1 mode)
# ---------------------------------------------------------------------------

# block_serve: bench.py's full serving configuration, nothing cut:
# resnet18_v1(classes=100) at 3 x 64 x 64 behind serving.Server over
# serving.BlockEngine, buckets 1/4/16, a 2 ms window, queue depth 4096, no
# per-request timeout; 8 client threads offer 1024 requests drawn from 64
# rows of RandomState(0); the baseline is 150 sequential engine.run calls
# of one request
BLOCK_SERVE_SAMPLE = (3, 64, 64)
BLOCK_SERVE_BUCKETS = (1, 4, 16)
BLOCK_SERVE_CLIENTS, BLOCK_SERVE_REQS, BLOCK_SERVE_SEQ = 8, 1024, 150
BLOCK_SERVE_ROWS = 64
# served rows against InferStep on the same block (fp32, of the largest
# logit, as zoo_score holds InferStep), and the serve_stablehlo round trip
# of the block's torch.export artifact against the block (of the largest
# magnitude)
BLOCK_SERVE_TOL, BLOCK_AOT_TOL = 1e-4, 1e-5


def _offered_load(srv, reqs, clients, n_req):
    """bench.py's offered-load protocol: ``clients`` threads each submit
    ``n_req // clients`` rows of ``reqs`` as fast as the server accepts
    them, then wait for every answer. Returns (seconds, {request index:
    (row, result)}, client errors)."""
    import threading

    per_client = n_req // clients
    results, errors = {}, []

    def client(cid):
        futures = []
        try:
            for i in range(per_client):
                row = (cid + i * clients) % len(reqs)
                futures.append((cid * per_client + i, row,
                                srv.submit(reqs[row])))
            for k, row, f in futures:
                results[k] = (row, f.result(timeout=120))
        except Exception as e:  # noqa: BLE001 - a check fails on it below
            errors.append(repr(e))

    threads = [threading.Thread(target=client, args=(c,))
               for c in range(clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return time.perf_counter() - t0, results, errors


def _window_busy(run):
    """torch.profiler (device activity) over one ``run()``: (device busy
    ms, wall ms, device events, sessions, what ``run()`` returned in each
    session). An empty session is run again after a pause, five sessions
    at most (PERF.md §7)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    got = []
    for attempt in range(5):
        if attempt:
            time.sleep(0.2)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            got.append(run())
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        busy = sum(e.time_range.elapsed_us() for e in dev) / 1e3
        if busy > 0.0:
            return busy, wall_ms, len(dev), attempt + 1, got
    fail("block_serve: five profiler sessions of the offered load recorded "
         "no device time")


def _engine_run_split(engine, reqs, n):
    """One single-request ``engine.run`` taken apart: ``run``'s own steps
    over the captured bucket-1 path, each timed on the host
    (``time.perf_counter``): the lock taken and the engine's stream
    ordered after the caller's (``lock_ms``), the copy into the pinned
    staging buffer and its upload issued (``stage_ms``), the replay
    issued (``replay_ms``), the one batched copy back with its wait for
    the device (``fetch_ms``); ``device_ms`` is the replay's device time
    (CUDA events on the engine's stream) and ``whole_ms`` one plain
    ``engine.run`` of the same row, alternating with the split one.
    Means over ``n`` rows."""
    import torch
    from mxnet_tpu_torch.serving.engine import _host

    path = engine._paths[(1,) + BLOCK_SERVE_SAMPLE]
    keys = ("whole_ms", "lock_ms", "stage_ms", "replay_ms", "fetch_ms",
            "device_ms")
    sums = dict.fromkeys(keys, 0.0)
    ev0 = torch.cuda.Event(enable_timing=True)
    ev1 = torch.cuda.Event(enable_timing=True)
    for i in range(n):
        row = reqs[i % len(reqs):i % len(reqs) + 1]
        t0 = time.perf_counter()
        engine.run(row)
        t1 = time.perf_counter()
        with engine._lock:
            engine._after_caller()
            with engine._on_stream():
                t2 = time.perf_counter()
                engine._stage(path, row)
                ev0.record(engine._stream)
                t3 = time.perf_counter()
                path.graph.replay()
                t4 = time.perf_counter()
                ev1.record(engine._stream)
                _host(path.out)
                t5 = time.perf_counter()
        for k, dt in zip(keys, (t1 - t0, t2 - t1, t3 - t2, t4 - t3,
                                t5 - t4)):
            sums[k] += dt * 1e3
        sums["device_ms"] += ev0.elapsed_time(ev1)
    return {k: v / n for k, v in sums.items()}


def block_serve():
    """bench.py's serving mode on the card: the offered-load throughput of
    serving.Server over serving.BlockEngine (a CUDA graph a bucket) against
    150 sequential single-request runs, p50/p99, batch fill, bucket counts,
    steady-state recompiles and the device's busy share over a second,
    profiled offered-load window; every served row against InferStep on
    the same block; then the block exported with aot.export_model
    (poly_batch) and served by serve_stablehlo with a BlockEngine of the
    same block as its fallback, against the block. Fails on a client
    error, a recompile after warmup, or a row out of tolerance."""
    import torch

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import aot, autograd, nd, parallel, serving
    from mxnet_tpu_torch.gluon.model_zoo import vision
    from mxnet_tpu_torch.telemetry import regress

    t_phase = time.perf_counter()
    sample, buckets = BLOCK_SERVE_SAMPLE, BLOCK_SERVE_BUCKETS
    mx.random.seed(0)
    with mx.gpu(0):
        net = vision.resnet18_v1(classes=100)
        net.initialize(mx.initializer.Xavier(
            rnd_type="gaussian", factor_type="in", magnitude=2))
        net(nd.array(np.zeros((1,) + sample, np.float32)))
    engine = serving.BlockEngine(net)  # no device given: the card
    reqs = np.random.RandomState(0).rand(
        BLOCK_SERVE_ROWS, *sample).astype(np.float32)

    # the sequential single-request baseline
    engine.run(reqs[:1])  # captures bucket 1
    t0 = time.perf_counter()
    for i in range(BLOCK_SERVE_SEQ):
        engine.run(reqs[i % BLOCK_SERVE_ROWS:i % BLOCK_SERVE_ROWS + 1])
    seq_rate = BLOCK_SERVE_SEQ / (time.perf_counter() - t0)
    run_split = _engine_run_split(engine, reqs, BLOCK_SERVE_SEQ)

    srv = serving.Server(engine, sample, buckets=buckets, max_delay_ms=2.0,
                         queue_depth=4096, timeout_ms=0, name="block_serve")
    t0 = time.perf_counter()
    srv.warmup()
    warm_s = time.perf_counter() - t0
    compiles_warm = engine.compile_count
    replays0 = engine.graph_replays
    elapsed, results, errors = _offered_load(
        srv, reqs, BLOCK_SERVE_CLIENTS, BLOCK_SERVE_REQS)
    stats = srv.stats()
    replays = engine.graph_replays - replays0
    # the device's busy share over a second window of the same load
    busy_ms, wall_ms, dev_events, sessions, windows = _window_busy(
        lambda: _offered_load(srv, reqs, BLOCK_SERVE_CLIENTS,
                              BLOCK_SERVE_REQS))
    stats_after = srv.stats()
    srv.close()
    recompiles = engine.compile_count - compiles_warm
    rate = stats["completed"] / elapsed
    # every window's load is checked, a profiler session run again too
    loads = [(elapsed, results, errors)] + windows
    for i, (_, answers, errs) in enumerate(loads):
        label = "the timed window" if i == 0 else "profiled session %d" % i
        if errs:
            fail("block_serve: %d client error(s) in %s: %s"
                 % (len(errs), label, errs[:3]))
        if len(answers) != BLOCK_SERVE_REQS:
            fail("block_serve: %d of %d requests answered in %s"
                 % (len(answers), BLOCK_SERVE_REQS, label))
    if stats["completed"] != BLOCK_SERVE_REQS or \
            stats_after["completed"] != len(loads) * BLOCK_SERVE_REQS:
        fail("block_serve: the server completed %d, then %d requests (want "
             "%d, then %d)" % (stats["completed"], stats_after["completed"],
                               BLOCK_SERVE_REQS,
                               len(loads) * BLOCK_SERVE_REQS))
    if recompiles != 0 or stats.get("steady_state_recompiles") != 0 or \
            stats_after.get("steady_state_recompiles") != 0:
        fail("block_serve: steady-state recompiles %d (stats %s, then %s)"
             % (recompiles, stats.get("steady_state_recompiles"),
                stats_after.get("steady_state_recompiles")))
    if compiles_warm != len(buckets) or replays < stats["batches"]:
        fail("block_serve: %d captures after warmup (want %d), %d replays "
             "for %d batches" % (compiles_warm, len(buckets), replays,
                                 stats["batches"]))

    # every served row against InferStep on the same block
    infer = parallel.InferStep(net, parallel.device_mesh(1))
    want = infer(nd.array(reqs))._data.float().cpu().numpy()
    scale = float(np.abs(want).max())
    err = max(float(np.abs(np.asarray(out) - want[row]).max())
              for _, answers, _ in loads for row, out in answers.values())
    tol = BLOCK_SERVE_TOL * max(1.0, scale)
    if not np.isfinite(scale) or not err <= tol or \
            np.asarray(results[0][1]).shape != (100,):
        fail("block_serve: served rows against InferStep: max abs err %.3g "
             "(tol %.3g), output shape %s" % (err, tol,
                                             np.asarray(results[0][1]).shape))

    # refresh_params on the card: the last layer's weight doubled, the
    # snapshot refreshed, the weight then overwritten in place on this
    # thread's stream at once; the engine must serve the doubled weight,
    # and capture nothing
    fc = net.output.weight.data()._data
    orig = fc.detach().clone()
    with torch.no_grad():
        fc.mul_(2.0)
    with autograd.pause():
        want2 = net(nd.array(reqs[:16]))._data.float().cpu().numpy()
    compiles = engine.compile_count
    engine.refresh_params()
    with torch.no_grad():
        fc.fill_(float("nan"))
    got2 = np.asarray(engine.run(reqs[:16]))
    with torch.no_grad():
        fc.copy_(orig)
    engine.refresh_params()
    got3 = np.asarray(engine.run(reqs[:16]))
    refresh_err = float(np.abs(got2 - want2).max())
    refresh_tol = BLOCK_SERVE_TOL * max(1.0, float(np.abs(want2).max()))
    restore_err = float(np.abs(got3 - want[:16]).max())
    if not refresh_err <= refresh_tol or not restore_err <= tol or \
            engine.compile_count != compiles:
        fail("block_serve: refresh_params: max abs err %.3g (tol %.3g), "
             "%.3g after the weight was put back (tol %.3g), %d captures"
             % (refresh_err, refresh_tol, restore_err, tol,
                engine.compile_count - compiles))

    # the artifact round trip: export, then serve with the block behind it
    out_dir = tempfile.mkdtemp(prefix="block_serve_aot_")
    try:
        t0 = time.perf_counter()
        manifest = aot.export_model(net, (1,) + sample, out_dir,
                                    save_tf=False, poly_batch=True)
        export_s = time.perf_counter() - t0
        asrv = serving.serve_stablehlo(
            out_dir, fallback_block=net, buckets=buckets, max_delay_ms=2.0,
            queue_depth=4096, timeout_ms=0, name="block_serve_aot")
        aot_warm = asrv.warmup()
        futs = [asrv.submit(reqs[i]) for i in range(BLOCK_SERVE_ROWS)]
        got = np.stack([f.result(timeout=120) for f in futs])
        astats = asrv.stats()
        asrv.close()
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    with autograd.pause():
        block_out = net(nd.array(reqs))._data.float().cpu().numpy()
    ascale = float(np.abs(block_out).max())
    aerr = float(np.abs(got - block_out).max())
    atol = BLOCK_AOT_TOL * ascale
    if not np.isfinite(ascale) or not aerr <= atol or \
            manifest["output_shape"] != ["b", 100]:
        fail("block_serve: the exported artifact against the block: max abs "
             "err %.3g (tol %.3g), output shape %s"
             % (aerr, atol, manifest["output_shape"]))
    if aot_warm != len(buckets) or astats["fallbacks"] or \
            astats["breakers"] != {"primary": "closed",
                                   "fallback": "closed"} or \
            astats.get("steady_state_recompiles") != 0:
        fail("block_serve: the artifact server: %d captures, %d fallbacks, "
             "breakers %s, steady-state recompiles %s"
             % (aot_warm, astats["fallbacks"], astats["breakers"],
                astats.get("steady_state_recompiles")))

    kind = torch.cuda.get_device_name(0)
    line = {
        "metric": "serving offered-load throughput (resnet18_v1@64, "
                  "buckets %s, %d clients)"
                  % ("/".join(map(str, buckets)), BLOCK_SERVE_CLIENTS),
        "value": rate, "unit": "req/s", "vs_baseline": rate / seq_rate,
        "extra": {"device_kind": kind, "mode": "serving",
                  "requests": BLOCK_SERVE_REQS, "card": CARD},
    }
    verdict = regress.stamp_line(
        line, store=regress.build_store(regress.default_paths()))
    phase("block_serve", **line, perf_verdict=verdict,
          sequential_req_s=seq_rate, speedup_vs_sequential=rate / seq_rate,
          run_split=run_split,
          p50_ms=stats["p50_ms"], p99_ms=stats["p99_ms"],
          batch_fill=stats["batch_fill"],
          bucket_counts=stats["bucket_counts"], batches=stats["batches"],
          completed=stats["completed"], shed=stats["shed"],
          timeouts=stats["timeouts"], steady_state_recompiles=recompiles,
          warm_compile_count=compiles_warm, warmup_s=warm_s,
          graph_replays=replays, busy_share=busy_ms / wall_ms,
          busy_ms=busy_ms, profiled_wall_ms=wall_ms,
          profiled_req_s=BLOCK_SERVE_REQS / (wall_ms / 1e3),
          device_events=dev_events, profiler_sessions=sessions,
          inferstep_max_abs_err=err, output_max_abs=scale, tol=tol,
          refresh_max_abs_err=refresh_err, restore_max_abs_err=restore_err,
          aot_export_s=export_s, aot_compile_count=aot_warm,
          aot_max_abs_err=aerr, aot_tol=atol,
          aot_batch_fill=astats["batch_fill"], aot_breakers=astats["breakers"],
          seconds=time.perf_counter() - t_phase)
    del net, engine, infer


# ---------------------------------------------------------------------------
# slice 23: the last ops (Proposal through the NMS kernel, the RoI and
# vision tail, int8 quantization)
# ---------------------------------------------------------------------------

# rcnn_proposal: Faster R-CNN's test-time RPN at MXNet 1.3's example/rcnn
# settings for VGG-16 (Ren et al., 2015): a 600 x 1000 image, feature
# stride 16 (conv5_3 is 37 x 62 after four floor-mode poolings), scales
# 8/16/32 and ratios 0.5/1/2 (A = 9, 20,646 anchors), 6000 boxes before
# NMS, 300 after, threshold 0.7, min size 16 at im_info's scale 1.6
RCNN_MAP, RCNN_IMAGE = (37, 62), (600.0, 1000.0, 1.6)
RCNN_ATTRS = {"feature_stride": 16, "scales": (8.0, 16.0, 32.0),
              "ratios": (0.5, 1.0, 2.0), "rpn_pre_nms_top_n": 6000,
              "rpn_post_nms_top_n": 300, "threshold": 0.7,
              "rpn_min_size": 16}
# the RoI ops over Proposal's 300 RoIs on a (1, 512, 37, 62) conv5_3 map:
# 7 x 7 bins at 1/16; ROIPooling exactly the CPU's (a max), ROIAlign
# within RCNN_ALIGN_TOL
RCNN_FEAT, RCNN_POOL, RCNN_ALIGN_TOL = 512, (7, 7), 2e-5
# quant_resnet: resnet50_v1 (1000 classes, seed-0 weights), naive
# calibration on QUANT_CALIB batches of QUANT_BATCH at 224 x 224, the
# float and int8 symbols at batch QUANT_BATCH on the card, and the int8
# symbol on the card against the CPU at batch QUANT_CPU_BATCH. Node by
# node, each op of the int8 symbol runs on the card from the CPU's values
# of its inputs (teacher forcing: no difference carries from one node to
# the next), and its outputs must match the CPU's: int32 exactly, int8 at
# most 1 step off on at most QUANT_STEP_SHARE of the values, floats within
# QUANT_FLOAT_TOL of the largest magnitude among the node's inputs and
# outputs (at least 1). End to end, where a float layer's rounding may tip
# one value across the next quantize's edge and the step cascades, the
# card's int8 logits must be within QUANT_MAX_STEPS steps of the output's
# grid (the last requantize's range over 127) of the CPU's everywhere,
# and nearer the CPU's on average than the CPU's int8 logits are to its
# float logits (PERF.md, slice 23)
QUANT_BATCH, QUANT_CALIB, QUANT_CPU_BATCH = 32, 2, 2
QUANT_STEP_SHARE, QUANT_FLOAT_TOL, QUANT_MAX_STEPS = 1e-4, 1e-5, 4.0


def _rcnn_inputs(b, seed):
    """Seeded RPN outputs at the test shape: cls_prob (B, 18, 37, 62) as a
    softmax over each anchor's (background, foreground) pair, bbox_pred
    (B, 36, 37, 62) at scale 0.1, im_info (B, 3)."""
    h, w = RCNN_MAP
    rs = np.random.RandomState(seed)
    logits = rs.randn(b, 2, 9, h, w).astype(np.float32) * 2.0
    e = np.exp(logits - logits.max(axis=1, keepdims=True))
    cls = (e / e.sum(axis=1, keepdims=True)).reshape(b, 18, h, w)
    bbox = (rs.randn(b, 36, h, w) * 0.1).astype(np.float32)
    info = np.tile(np.asarray(RCNN_IMAGE, np.float32), (b, 1))
    return [cls.astype(np.float32), bbox, info]


def _peak_mb(fn):
    """fn()'s result and the device memory it allocated above what was
    allocated when it started, at its peak (MB)."""
    import torch

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    return out, (torch.cuda.max_memory_allocated() - base) / 2 ** 20


def rcnn_proposal():
    """Proposal through the NMS kernel at Faster R-CNN's test shape against
    the same op with the plain NMS on the card (RoIs exactly equal), then
    MultiProposal at B = 2 the same way, then ROIPooling and ROIAlign over
    the 300 RoIs against the port on the CPU; timed. Returns the kernel
    launches of the path's run (the B = 1 and B = 2 calls)."""
    import torch

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import nd
    from mxnet_tpu_torch.ops import nms, vision

    t_phase = time.perf_counter()
    one = [nd.array(a, ctx=mx.gpu(0)) for a in _rcnn_inputs(1, 23)]
    two = [nd.array(a, ctx=mx.gpu(0)) for a in _rcnn_inputs(2, 24)]

    def proposal(ins):
        return nd.contrib.Proposal(*ins, output_score=True, **RCNN_ATTRS)

    _reset_launches()  # the path: one image, then two
    rois1, scores1 = proposal(one)
    rois2, scores2 = nd.contrib.MultiProposal(*two, output_score=True,
                                              **RCNN_ATTRS)
    torch.cuda.synchronize()
    launches = nms.nms_keep_cuda.launches
    if launches != 3:
        fail("rcnn_proposal: %d NMS kernel launches for one image and two "
             "(3 expected)" % launches)
    try:
        vision.nms_keep = nms.nms_keep_reference
        plain1 = proposal(one)
        plain2 = nd.contrib.MultiProposal(*two, output_score=True,
                                          **RCNN_ATTRS)
        torch.cuda.synchronize()
    finally:
        vision.nms_keep = nms.nms_keep
    if nms.nms_keep_cuda.launches != 3:
        fail("rcnn_proposal: the plain run launched the kernel")
    for what, got, want in (("B=1", (rois1, scores1), plain1),
                            ("B=2", (rois2, scores2), plain2)):
        for g, w in zip(got, want):
            if not torch.equal(g._data, w._data):
                fail("rcnn_proposal %s: the kernel's RoIs or scores differ "
                     "from the plain NMS's" % what)
    r1 = rois1.asnumpy()
    if r1.shape != (300, 5) or not np.isfinite(r1).all():
        fail("rcnn_proposal: RoIs of shape %s" % (r1.shape,))
    boxes = r1[:, 1:]
    if (boxes[:, 2] < boxes[:, 0]).any() or boxes.min() < 0 or \
            (boxes[:, [0, 2]] > RCNN_IMAGE[1] - 1).any() or \
            (boxes[:, [1, 3]] > RCNN_IMAGE[0] - 1).any():
        fail("rcnn_proposal: a RoI outside the image or inverted")

    # the NMS call inside Proposal (one image): its inputs and keep mask
    # give the kernel's bound at this run's data; the plain NMS's time
    seen = []

    def recording(boxes, cls, valid, thresh, force):
        keep = nms.nms_keep(boxes, cls, valid, thresh, force)
        seen.append((boxes, cls, valid, keep, thresh, force))
        return keep

    try:
        vision.nms_keep = recording
        proposal(one)
    finally:
        vision.nms_keep = nms.nms_keep
    bx, c, v, keep, thresh, force = seen[0]
    bound_ms, bound_by, pairs = _nms_bound(bx, c, v, keep, force)
    plain_nms_ms = time_ms(lambda: nms.nms_keep_reference(
        bx, c, v, thresh, force), iters=2, warm=1)

    ms = time_ms(lambda: proposal(one), iters=20)
    t0 = time.perf_counter()
    for _ in range(20):
        proposal(one)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / 20
    nms_ms = device_ms_by_kernel(lambda: proposal(one), KERNEL_4,
                                 per_call=len(NMS_KERNELS))
    all_ms = call_device_ms(lambda: proposal(one))

    # the RoI ops over those RoIs: card against the port on the CPU
    feat = np.random.RandomState(25).randn(
        1, RCNN_FEAT, *RCNN_MAP).astype(np.float32)
    f_card = nd.array(feat, ctx=mx.gpu(0))
    roi_fields = {}
    for op, attrs in (("ROIPooling", {"pooled_size": RCNN_POOL,
                                      "spatial_scale": 1.0 / 16}),
                      ("ROIAlign", {"pooled_size": RCNN_POOL,
                                    "spatial_scale": 1.0 / 16,
                                    "sample_ratio": 2})):
        out, peak = _peak_mb(lambda: nd.invoke(op, f_card, rois1, **attrs))
        got = out.asnumpy()
        with mx.cpu():
            want = nd.invoke(op, nd.array(feat), nd.array(r1),
                             **attrs).asnumpy()
        err = float(np.abs(got - want).max())
        bad = not np.array_equal(got, want) if op == "ROIPooling" \
            else not err <= RCNN_ALIGN_TOL
        if bad or got.shape != (300, RCNN_FEAT) + RCNN_POOL:
            fail("rcnn_proposal: %s on the card against the CPU: max abs "
                 "err %.3g, shape %s" % (op, err, got.shape))
        roi_fields[op] = {"max_abs_err": err, "peak_mb": peak,
                          "ms": time_ms(lambda: nd.invoke(
                              op, f_card, rois1, **attrs), iters=10)}
    phase("rcnn_proposal", card=CARD, anchors=RCNN_MAP[0] * RCNN_MAP[1] * 9,
          pre_nms=RCNN_ATTRS["rpn_pre_nms_top_n"],
          post_nms=RCNN_ATTRS["rpn_post_nms_top_n"],
          rois_equal_plain_nms=True, kernel_launches=launches,
          distinct_rois=int(np.unique(boxes, axis=0).shape[0]),
          proposal_ms=ms, proposal_wall_ms=wall_ms,
          proposal_device_ms=all_ms, nms_device_ms=sum(nms_ms.values()),
          nms_device_ms_by_kernel=nms_ms, nms_boxes=int(v.shape[1]),
          nms_valid=int(v.sum()), nms_kept=int(keep.sum()),
          nms_bound_ms=bound_ms, nms_bound_by=bound_by,
          nms_iou_pairs=pairs, nms_plain_ms=plain_nms_ms,
          roi_ops=roi_fields,
          align_tol=RCNN_ALIGN_TOL,
          seconds=time.perf_counter() - t_phase)
    return launches


def vision_card():
    """Every name of the slice (tests/torch_vision_cases.py: the 25 of
    ops/vision.py, ROIAlign and bipartite_matching, the 7 quantization
    ops), forward and gradient on the card against the port on the CPU;
    integers exactly."""
    import inspect

    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "tests"))
    import torch_vision_cases as cases

    from mxnet_tpu_torch.ops.registry import OP_REGISTRY

    t_phase = time.perf_counter()
    bad, checked, names = [], 0, set()

    def run_case(name, op, specs, attrs, flags):
        nonlocal checked
        from torch_op_cases import make_inputs

        inputs = make_inputs(specs, "float32", seed=11)
        got = _op_run(name, inputs, attrs, "cuda", flags["grad"])
        want = _op_run(name, inputs, attrs, "cpu", flags["grad"])
        n_out = len(want) - sum(flags["grad"] and x.dtype == np.float32
                                for x in inputs)
        checked += 1
        for k, (g, w) in enumerate(zip(got, want)):
            tol = TAIL_GRAD_TOL if k >= n_out else TAIL_TOL
            if g.dtype != w.dtype or not _tail_close(g, w, tol):
                bad.append("%s[%d]: %s against %s, max abs err %s"
                           % (name, k, g.dtype, w.dtype, _tail_err(g, w)))
        if len(got) != len(want):
            bad.append("%s: %d arrays against %d" % (name, len(got),
                                                     len(want)))
        names.add(name)

    for key in sorted(cases.VISION_CASES):
        op, specs, attrs, flags = cases.VISION_CASES[key]
        run_case(op, op, specs, attrs, flags)
    for alias in sorted(n for v in cases.ALIASES.values() for n in v):
        run_case(alias, *cases.canonical(alias, OP_REGISTRY))
    mods = {"mxnet_tpu_torch.ops.vision", "mxnet_tpu_torch.ops.quantization"}
    slice_names = {n for n, o in OP_REGISTRY.items()
                   if inspect.getmodule(o.fcompute).__name__ in mods} | {
        "ROIAlign", "_contrib_ROIAlign", "_contrib_bipartite_matching"}
    missing = sorted(slice_names - names)
    phase("vision_card", card=CARD, names=len(names & slice_names),
          checks=checked, tol=TAIL_TOL, grad_tol=TAIL_GRAD_TOL, failed=bad,
          unchecked=missing, seconds=time.perf_counter() - t_phase)
    if bad or missing or len(slice_names) != 35:
        fail("vision_card: the card disagrees with the CPU: %s; not "
             "checked: %s (of %d names)" % (bad, missing, len(slice_names)))


def _quant_layer_checks(qarg, sym):
    """quantized_conv's and quantized_fully_connected's int32 accumulators
    on the same int8 inputs on the card and the CPU: the stem (K = 147),
    a 3 x 3 layer at 512 channels (K = 4608) and the dense layer (2048 ->
    1000), with the quantized net's own int8 weights. Bit-equal or
    fail."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import nd

    nodes = json.loads(sym.tojson())["nodes"]
    layers = {}
    for n in nodes:
        a = n.get("attrs", {})
        if n["op"] == "_contrib_quantized_fully_connected":
            key = "dense_2048_1000"
        elif n["op"] != "_contrib_quantized_conv":
            continue
        elif a.get("kernel") == "(7, 7)":
            key = "stem_k147"
        elif a.get("kernel") == "(3, 3)" and a.get("num_filter") == "512":
            key = "conv3x3_512_k4608"
        else:
            continue
        # the weight: the layer's second input, a variable
        layers.setdefault(key, (n["name"], n, nodes[n["inputs"][1][0]]
                                ["name"]))
    if len(layers) != 3:
        fail("quant_resnet: the quantized net lacks a checked layer: %s"
             % sorted(layers))
    rs = np.random.RandomState(26)
    out = {}
    for key, (name, n, wname) in sorted(layers.items()):
        w = qarg[wname].asnumpy()
        if key == "dense_2048_1000":
            x = rs.randint(-127, 128, (QUANT_BATCH, 2048)).astype(np.int8)
            attrs = {"num_hidden": 1000, "no_bias": True}
            op = "_contrib_quantized_fully_connected"
        else:
            c = w.shape[1]
            side, batch = (224, 4) if key == "stem_k147" else (7, 8)
            x = rs.randint(-127, 128, (batch, c, side, side)).astype(np.int8)
            a = n["attrs"]
            attrs = {"kernel": a["kernel"], "stride": a.get("stride"),
                     "pad": a.get("pad"), "num_filter": a["num_filter"],
                     "no_bias": True}
            op = "_contrib_quantized_conv"
        ranges = [np.asarray([v], np.float32) for v in (-1.0, 1.0, -1.0,
                                                        1.0)]
        ins = [x, w] + ranges
        res = []
        for ctx in (mx.gpu(0), mx.cpu()):
            with ctx:
                res.append(nd.invoke(op, *[nd.array(v, dtype=v.dtype)
                                           for v in ins], **attrs)[0]
                           .asnumpy())
        card, cpu = res
        if card.dtype != np.int32 or not np.array_equal(card, cpu):
            fail("quant_resnet: %s's int32 accumulator on the card differs "
                 "from the CPU's in %d places" % (key, int((card != cpu)
                                                          .sum())))
        out[key] = {"layer": name, "shape": list(card.shape),
                    "k": int(np.prod(w.shape[1:])), "bit_equal": True,
                    "max_abs_acc": int(np.abs(card).max())}
    return out


def _quantized_resnet50():
    """resnet50_v1 (seed-0 weights) exported and loaded as a symbol, then
    quantized by contrib.quantization.quantize_model with naive
    calibration on the card: (float triple, int8 triple, an input batch,
    the quantization's seconds)."""
    import tempfile

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import io as mxio
    from mxnet_tpu_torch import nd
    from mxnet_tpu_torch.contrib import quantization

    net = _resnet50(0)
    net.hybridize()
    shape = (QUANT_BATCH, 3, RESNET_SIDE, RESNET_SIDE)
    rs = np.random.RandomState(27)
    x = rs.rand(*shape).astype(np.float32)
    net(nd.array(x))
    prefix = os.path.join(tempfile.mkdtemp(prefix="chip_smoke_quant_"),
                          "resnet50_v1")
    net.export(prefix)
    del net
    sym = mx.sym.load(prefix + "-symbol.json")
    params = mx.nd.load(prefix + "-0000.params")
    arg = {k[4:]: v for k, v in params.items() if k.startswith("arg:")}
    aux = {k[4:]: v for k, v in params.items() if k.startswith("aux:")}
    calib = rs.rand(QUANT_CALIB * QUANT_BATCH, *shape[1:]).astype(np.float32)
    t0 = time.perf_counter()
    quantized = quantization.quantize_model(
        sym, arg, aux, calib_mode="naive",
        calib_data=mxio.NDArrayIter(calib, np.zeros(len(calib), np.float32),
                                    batch_size=QUANT_BATCH),
        num_calib_examples=len(calib))  # ctx=None: the card
    return (sym, arg, aux), quantized, x, time.perf_counter() - t0


def _quant_exec(sym, arg, aux, ctx, batch):
    """An executor of ``sym`` at batch ``batch`` of 224 x 224 images on
    ``ctx``, with the params (a bias the rewrite dropped stays unused)."""
    ex = sym.simple_bind(ctx, data=(batch, 3, RESNET_SIDE, RESNET_SIDE),
                         grad_req="null")
    ex.copy_params_from(arg, aux, allow_extra_params=True)
    return ex


def _quant_forward(ex, data):
    ex.copy_params_from({"data": data})
    return ex.forward(is_train=False)


def quant_resnet():
    """The port's zoo resnet50_v1 exported to a symbol and quantized by
    contrib.quantization.quantize_model (naive calibration on the card),
    the float and int8 symbols forward at batch 32 on the card; the int32
    accumulators of three layers bit-equal on the card and the CPU; the
    int8 logits on the card against the port's CPU run of the same
    symbol within the bar."""
    import torch

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import nd

    t_phase = time.perf_counter()
    (sym, arg, aux), (qsym, qarg, qaux), x, quantize_s = \
        _quantized_resnet50()
    n_q = sum(n["op"].startswith("_contrib_quantized_")
              for n in json.loads(qsym.tojson())["nodes"])
    if n_q != 54:  # 53 convolutions and the dense layer
        fail("quant_resnet: %d quantized layers (54 expected)" % n_q)
    xin = nd.array(x)
    f_ex = _quant_exec(sym, arg, aux, mx.gpu(0), QUANT_BATCH)
    q_ex = _quant_exec(qsym, qarg, qaux, mx.gpu(0), QUANT_BATCH)
    ref = _quant_forward(f_ex, xin)[0].asnumpy()
    got = _quant_forward(q_ex, xin)[0].asnumpy()
    f_ms = time_ms(lambda: _quant_forward(f_ex, xin), iters=5, warm=1)
    q_ms = time_ms(lambda: _quant_forward(q_ex, xin), iters=5, warm=1)
    torch.cuda.synchronize()
    if not (np.isfinite(got).all() and got.shape == (QUANT_BATCH, 1000)):
        fail("quant_resnet: int8 logits of shape %s, finite %s"
             % (got.shape, bool(np.isfinite(got).all())))
    rel = float(np.abs(got - ref).mean() / (np.abs(ref).mean() + 1e-9))
    agree = float((got.argmax(1) == ref.argmax(1)).mean())
    layers = _quant_layer_checks(qarg, qsym)

    # the same int8 symbol node by node (card from the CPU's inputs), then
    # end to end, at batch QUANT_CPU_BATCH
    xs = x[:QUANT_CPU_BATCH]
    forced, cpu = _quant_teacher_forced(qsym, qarg, qaux, xs,
                                        torch.device("cuda"))
    card = _quant_forward(
        _quant_exec(qsym, qarg, qaux, mx.gpu(0), QUANT_CPU_BATCH),
        nd.array(xs))[0].asnumpy()
    with mx.cpu():
        f_cpu = _quant_forward(
            _quant_exec(sym, arg, aux, mx.cpu(), QUANT_CPU_BATCH),
            nd.array(xs))[0].asnumpy()
    last = [n for n in json.loads(qsym.tojson())["nodes"]
            if n["op"] == "_contrib_requantize"][-1]
    step = float(last["attrs"]["max_calib_range"]) / 127.0
    diff = np.abs(card - cpu)
    own = float(np.abs(cpu - f_cpu).mean())
    phase("quant_resnet", card=CARD, model="resnet50_v1", batch=QUANT_BATCH,
          calib_batches=QUANT_CALIB, calib_mode="naive",
          quantized_layers=n_q, quantize_s=quantize_s,
          float_forward_ms=f_ms, int8_forward_ms=q_ms,
          int8_vs_float_rel_err=rel, int8_vs_float_top1_agreement=agree,
          accumulators=layers, cpu_batch=QUANT_CPU_BATCH,
          teacher_forced=forced, step_share_bar=QUANT_STEP_SHARE,
          float_tol=QUANT_FLOAT_TOL, output_step=step,
          card_vs_cpu_max_steps=float(diff.max() / step),
          card_vs_cpu_mean_abs=float(diff.mean()),
          int8_vs_float_cpu_mean_abs=own, max_steps_bar=QUANT_MAX_STEPS,
          seconds=time.perf_counter() - t_phase)
    if forced["failed"]:
        fail("quant_resnet: teacher-forced nodes off the CPU: %s"
             % forced["failed"][:10])
    if not (diff.max() <= QUANT_MAX_STEPS * step and diff.mean() < own):
        fail("quant_resnet: the int8 logits on the card are %.3g steps "
             "(mean %.3g) from the CPU's; the bar is %s steps, and a mean "
             "below int8's own %.3g from the float net"
             % (diff.max() / step, diff.mean(), QUANT_MAX_STEPS, own))


def _quant_teacher_forced(qsym, qarg, qaux, x, device):
    """Each node of the int8 symbol on ``device`` from the CPU's values of
    its inputs, against the CPU's outputs of that node: int32 exactly, int8
    and uint8 at most 1 step off on at most QUANT_STEP_SHARE of the
    values, floats within QUANT_FLOAT_TOL of the largest magnitude among
    the node's inputs and outputs (at least 1). Returns (the worst reading
    of each kind with its node, the counts and the failed nodes; the CPU's
    logits)."""
    import torch

    from mxnet_tpu_torch import autograd
    from mxnet_tpu_torch.ops.registry import OP_REGISTRY

    graph = json.loads(qsym.tojson())
    bound = {k: v.asnumpy() for k, v in list(qarg.items())
             + list(qaux.items())}
    bound["data"] = x
    vals, failed = {}, []
    worst = {"int32_values_off": [0, None], "int8_max_steps": [0, None],
             "int8_share_off": [0.0, None], "float_err_of_scale": [0.0, None]}
    counts = {"nodes": 0, "int32": 0, "int8": 0, "float": 0}

    def note(kind, value, name):
        if value > worst[kind][0]:
            worst[kind] = [value, name]

    with autograd.predict_mode(), torch.no_grad():
        for i, n in enumerate(graph["nodes"]):
            if n["op"] == "null":
                vals[(i, 0)] = torch.as_tensor(bound[n["name"]])
                continue
            opdef = OP_REGISTRY[n["op"]]
            ins = [vals[(j, k)] for j, k, *_ in n["inputs"]]
            outs = []
            for dev, args in ((torch.device("cpu"), ins),
                              (device, [v.to(device) for v in ins])):
                attrs = opdef.parse_attrs(n.get("attrs", {}))
                if not args and not attrs.get("ctx"):
                    # a constant: made on the side's device, as the
                    # executor does (Symbol.eval_torch)
                    attrs["__device__"] = dev
                out = opdef.fcompute(attrs, *args)
                outs.append(out if isinstance(out, (tuple, list))
                            else (out,))
            cpu, card = outs
            counts["nodes"] += 1
            scale = max([1.0] + [float(v.abs().max()) for v in ins
                                 if v.is_floating_point() and v.numel()])
            for k, (a, b) in enumerate(zip(cpu, card)):
                vals[(i, k)] = a
                b = b.cpu()
                name = "%s:%d" % (n["name"], k)
                if a.dtype != b.dtype or a.shape != b.shape:
                    failed.append((name, "dtype/shape"))
                elif a.dtype == torch.int32:
                    counts["int32"] += 1
                    off = int((a != b).sum())
                    note("int32_values_off", off, name)
                    if off:
                        failed.append((name, "int32", off))
                elif a.dtype in (torch.int8, torch.uint8):
                    counts["int8"] += 1
                    d = (a.to(torch.int32) - b.to(torch.int32)).abs()
                    steps = int(d.max()) if d.numel() else 0
                    share = float((d > 0).float().mean()) if d.numel() \
                        else 0.0
                    note("int8_max_steps", steps, name)
                    note("int8_share_off", share, name)
                    if steps > 1 or share > QUANT_STEP_SHARE:
                        failed.append((name, "int8", steps, share))
                else:
                    counts["float"] += 1
                    err = float((a - b).abs().max()) if a.numel() else 0.0
                    top = max(scale, float(a.abs().max()) if a.numel()
                              else 0.0)
                    note("float_err_of_scale", err / top, name)
                    if not err <= QUANT_FLOAT_TOL * top:
                        failed.append((name, "float", err, top))
    head = graph["heads"][0]
    return (dict(worst, failed=failed, **counts),
            vals[(head[0], head[1])].numpy())


def quantize_example():
    """The port's example/quantization/quantize_model.py on the card
    (--num-calib 128): it exits 0 only on ENTROPY_BEATS_NAIVE."""
    here = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, os.path.join(here, "mxnet_tpu_torch", "example",
                                      "quantization", "quantize_model.py"),
         "--num-calib", "128"], capture_output=True, text=True, timeout=600)
    lines = proc.stdout.strip().splitlines()
    phase("quantize_example", card=CARD, rc=proc.returncode,
          seconds=time.perf_counter() - t0, lines=lines)
    if proc.returncode != 0 or not lines or \
            lines[-1] != "ENTROPY_BEATS_NAIVE":
        fail("quantize_example: rc %d, %s" % (proc.returncode,
                                              proc.stderr[-2000:]))


def vision_phases():
    """The slice's four phases (``--vision``); returns rcnn_proposal's NMS
    kernel launches."""
    launches = rcnn_proposal()
    vision_card()
    quant_resnet()
    quantize_example()
    return launches



# the ImageNet input path: the port's JPEG codec (host library against
# the plain version), im2rec, MPImageRecordIter and train_resnet.py --rec
IMAGENET_SIZES = ((375, 500), (500, 375), (333, 500), (480, 640),
                  (375, 499), (281, 500), (500, 353), (427, 640))  # (h, w)
IMAGENET_IMAGES = 640  # 20 batches of 32: one epoch of train_resnet --rec
IMAGENET_BATCH = 32
IMAGENET_SHAPE = (3, 224, 224)
IMAGENET_NORM = dict(mean_r=123.68, mean_g=116.28, mean_b=103.53,
                     std_r=58.395, std_g=57.12, std_b=57.375)
IMAGENET_ONE_WORKER_BATCHES = 8  # one worker is timed over these only
IMAGENET_PROFILE_STEPS = 10
# the --rec loop's profile skips the batches its workers prefetched
# while the run was elsewhere, then reads a data-bound stretch
IMAGENET_REC_PROFILE = dict(skip=8, steps=10)
IMAGENET_SEED = 24


def _host_cpu():
    """The host's CPU model (as /proc/cpuinfo names it) and core count."""
    model = "unknown"
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    model = line.split(":", 1)[1].strip()
                    break
    except OSError:
        pass
    return {"model": model, "cores": os.cpu_count()}


def _imagenet_like(rs, h, w, noise):
    """A seeded smooth-noise RGB image: a 4 x 5 colour grid stretched by
    the resampler, plus a slice of a shared noise pool."""
    from mxnet_tpu_torch import _imgcodec

    grid = rs.randint(0, 256, (4, 5, 3)).astype(np.uint8)
    base = _imgcodec.resize_bilinear(grid, w, h, lib=True).astype(np.int16)
    off = rs.randint(0, noise.size - h * w * 3)
    return np.clip(base + noise[off:off + h * w * 3].reshape(h, w, 3), 0,
                   255).astype(np.uint8)


def _codec_host_ms(fn, iters):
    fn()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) / iters * 1e3


def imgcodec():
    """The host library against the plain codec on a seeded corpus:
    encode byte for byte, decode and resample pixel for pixel; then the
    library's host ms at ImageNet's size."""
    from mxnet_tpu_torch import _imgcodec as C
    from mxnet_tpu_torch.ops import _build

    t0 = time.perf_counter()
    C.library()
    build_s = time.perf_counter() - t0
    rs = np.random.RandomState(IMAGENET_SEED)
    noise = rs.randint(-24, 25, 1 << 21).astype(np.int16)
    cases = []
    for h, w in ((1, 1), (7, 9), (17, 33), (40, 56), (64, 48), (375, 500)):
        big = h * w > 64 * 64
        for q in (95,) if big else (50, 75, 95):
            for sub, restart in ((None, 0), ("444", 0), ("422", 0),
                                 ("420", 0), ("440", 0), ("420", 3),
                                 (None, 2)):
                img = _imagenet_like(rs, max(h, 2), max(w, 2), noise)[:h, :w]
                cases.append((img[..., :1] if sub is None else img, q, sub,
                              restart))
    n_enc = n_dec = n_res = 0
    for img, q, sub, restart in cases:
        what = "%s q%d %s restart %d" % (img.shape, q, sub, restart)
        plain = C.encode_plain(img, q, sub, restart)
        if C.encode(img, q, sampling=sub, restart=restart, lib=True) != plain:
            fail("imgcodec: the library's JPEG bytes differ from the plain "
                 "encoder's (%s)" % what)
        n_enc += 1
        dec = C.decode_plain(plain)
        if not np.array_equal(C.decode(plain, lib=True), dec):
            fail("imgcodec: the library's decode differs (%s)" % what)
        n_dec += 1
        if dec.shape[2] == 3:
            h, w = dec.shape[:2]
            for ow, oh in ((224, 224), (2 * w + 1, 3 * h),
                           (max(1, w * 256 // max(1, min(h, w))),
                            max(1, h * 256 // max(1, min(h, w))))):
                if not np.array_equal(C.resize_bilinear(dec, ow, oh, lib=True),
                                      C.resize_plain(dec, ow, oh)):
                    fail("imgcodec: the library's resample differs (%s to "
                         "%dx%d)" % (what, ow, oh))
                n_res += 1
    img = _imagenet_like(rs, 375, 500, noise)
    jpg = C.encode(img, 95, lib=True)
    dec = C.decode(jpg, lib=True)
    t0 = time.perf_counter()
    C.decode_plain(jpg)
    plain_decode_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    C.resize_plain(dec, 341, 256)
    plain_resize_ms = (time.perf_counter() - t0) * 1e3
    phase("imgcodec", card=CARD, host_cpu=_host_cpu(), build_s=build_s,
          build_log=_build.build_log("imgcodec")[-400:],
          encode_cases=n_enc, decode_cases=n_dec, resample_cases=n_res,
          jpeg_bytes_500x375_q95=len(jpg),
          decode_500x375_q95_420_host_ms=_codec_host_ms(
              lambda: C.decode(jpg, lib=True), 100),
          resize_to_short_256_host_ms=_codec_host_ms(
              lambda: C.resize_bilinear(dec, 341, 256, lib=True), 100),
          resize_to_224x224_host_ms=_codec_host_ms(
              lambda: C.resize_bilinear(dec, 224, 224, lib=True), 100),
          encode_500x375_q95_host_ms=_codec_host_ms(
              lambda: C.encode(img, 95, lib=True), 50),
          plain_decode_host_ms=plain_decode_ms,
          plain_resize_host_ms=plain_resize_ms)


def _imagenet_dataset():
    """IMAGENET_IMAGES seeded images at ImageNet-like sizes, written as
    JPEG files, then packed by the port's im2rec at quality 95: (.rec
    path, pack seconds, .rec bytes). Record i's label is i % 1000."""
    from concurrent.futures import ThreadPoolExecutor

    from mxnet_tpu_torch import _imgcodec
    from mxnet_tpu_torch.tools import im2rec

    d = tempfile.mkdtemp(prefix="chip_smoke_imagenet_")
    src = os.path.join(d, "src")
    os.makedirs(src)
    rs = np.random.RandomState(IMAGENET_SEED)
    noise = rs.randint(-24, 25, 1 << 22).astype(np.int16)
    plan = [(i, IMAGENET_SIZES[i % len(IMAGENET_SIZES)],
             int(rs.randint(0, 2 ** 31 - 1))) for i in range(IMAGENET_IMAGES)]

    def write(item):
        i, (h, w), seed = item
        img = _imagenet_like(np.random.RandomState(seed), h, w, noise)
        with open(os.path.join(src, "%05d.jpg" % i), "wb") as f:
            f.write(_imgcodec.encode(img, 100, lib=True))

    with ThreadPoolExecutor(max_workers=os.cpu_count()) as pool:
        list(pool.map(write, plan))
    prefix = os.path.join(d, "train")
    with open(prefix + ".lst", "w") as f:
        for i in range(IMAGENET_IMAGES):
            f.write("%d\t%f\t%05d.jpg\n" % (i, float(i % 1000), i))
    t0 = time.perf_counter()
    rc = im2rec.main([prefix, src, "--quality", "95", "--num-thread",
                      str(os.cpu_count())])
    pack_s = time.perf_counter() - t0
    if rc != 0:
        fail("imagenet_rec: im2rec exited %d" % rc)
    shutil.rmtree(src)
    return prefix + ".rec", pack_s, os.path.getsize(prefix + ".rec")


def _epoch(it, batches=None):
    """(labels handed out, seconds to the first batch, seconds of the
    rest, batches): one epoch of ``it``, or its first ``batches``."""
    labels, n = [], 0
    t0 = time.perf_counter()
    first = None
    for batch in it:
        if not batch.data[0]._data.is_cuda:
            fail("imagenet_rec: a batch is not on the card")
        keep = IMAGENET_BATCH - batch.pad
        labels += batch.label[0].asnumpy()[:keep].tolist()
        n += 1
        if first is None:
            first = time.perf_counter() - t0
            t1 = time.perf_counter()
        if batches is not None and n >= batches:
            break
    return labels, first, time.perf_counter() - t1, n


def _plain_first_batch(rec, aug, seed):
    """The first batch a one-worker MPImageRecordIter (``seed``) makes,
    built here by the pipeline's own worker function on the plain codec:
    (data, labels)."""
    from mxnet_tpu_torch import recordio
    from mxnet_tpu_torch.image_pipeline import _decode_augment

    idx = os.path.splitext(rec)[0] + ".idx"
    reader = recordio.MXIndexedRecordIO(idx, rec, "r")
    order = list(reader.keys)
    np.random.RandomState(seed).shuffle(order)  # the master's epoch plan
    rng = np.random.RandomState(seed + 101)  # worker 0's draws
    cfg = {"data_shape": aug["data_shape"], "rand_crop": aug["rand_crop"],
           "rand_mirror": aug["rand_mirror"], "resize": aug["resize"],
           "mean": np.asarray([aug["mean_r"], aug["mean_g"], aug["mean_b"]],
                              np.float32),
           "std": np.asarray([aug["std_r"], aug["std_g"], aug["std_b"]],
                             np.float32)}
    data, labels = [], []
    for key in order[:aug["batch_size"]]:
        img, lab = _decode_augment(reader.read_idx(key), cfg, rng, lib=False)
        data.append(img)
        labels.append(lab[0])
    reader.close()
    return np.stack(data), np.asarray(labels, np.float32)


def imagenet_rec():
    """The record pipeline at 1 worker and at all host cores, and its
    first batch against the plain codec's; returns the .rec path."""
    import collections

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.image_pipeline import MPImageRecordIter

    rec, pack_s, rec_bytes = _imagenet_dataset()
    aug = dict(data_shape=IMAGENET_SHAPE, batch_size=IMAGENET_BATCH,
               shuffle=True, resize=256, rand_crop=True, rand_mirror=True,
               prefetch_buffer=4, **IMAGENET_NORM)
    want = collections.Counter(float(i % 1000)
                               for i in range(IMAGENET_IMAGES))
    rates = {}
    first_lib = None
    for n in (1, os.cpu_count()):
        if n == 1:
            it = MPImageRecordIter(rec, preprocess_threads=1,
                                   seed=IMAGENET_SEED, **aug)
        else:  # io's rule picks the worker processes here
            it = mx.io.ImageRecordIter(path_imgrec=rec, preprocess_threads=n,
                                       seed=IMAGENET_SEED + n, **aug)
            if not isinstance(it, MPImageRecordIter):
                fail("imagenet_rec: ImageRecordIter chose %s"
                     % type(it).__name__)
        try:
            if n == 1:
                first_lib = it.next()
            labels, first_s, rest_s, batches = _epoch(
                it, IMAGENET_ONE_WORKER_BATCHES if n == 1 else None)
            calls = dict(it.lib_calls)
        finally:
            it.close()
        if n != 1 and collections.Counter(labels) != want:
            fail("imagenet_rec: an epoch at %d workers did not hand out "
                 "each record once" % n)
        if calls["decode"] < len(labels):
            fail("imagenet_rec: %d library decodes for %d images"
                 % (calls["decode"], len(labels)))
        rates[n] = {"workers": n, "first_batch_s": first_s,
                    "img_per_s": (len(labels) - IMAGENET_BATCH) / rest_s,
                    "batches": batches, "lib_calls": calls}
    t0 = time.perf_counter()
    plain_data, plain_labels = _plain_first_batch(rec, aug, IMAGENET_SEED)
    plain_s = time.perf_counter() - t0
    same = np.array_equal(first_lib.data[0].asnumpy(), plain_data) and \
        np.array_equal(first_lib.label[0].asnumpy(), plain_labels)
    phase("imagenet_rec", card=CARD, host_cpu=_host_cpu(),
          images=IMAGENET_IMAGES, sizes=IMAGENET_SIZES, quality=95,
          im2rec_pack_s=pack_s, im2rec_img_per_s=IMAGENET_IMAGES / pack_s,
          rec_bytes=rec_bytes, data_shape=IMAGENET_SHAPE, resize=256,
          pipeline=[rates[k] for k in sorted(rates)],
          first_batch_equals_plain_codec=same,
          plain_codec_first_batch_s=plain_s)
    if not same:
        fail("imagenet_rec: the first batch through the host library differs "
             "from the plain codec's")
    return rec


def imagenet_train(rec):
    """train_resnet.py --rec at resnet50_v1's full width for two epochs of
    the .rec (80 batches), beside the same step fed by NDArrayIter."""
    import torch

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.example.gluon import train_resnet as tr
    from mxnet_tpu_torch.image_pipeline import MPImageRecordIter

    mx.random.seed(0)
    args = tr.parse_args(["--rec", rec, "--num-epochs", "2"])
    with mx.gpu(0):
        # the example's own call, made here so that its workers serve the
        # profiled steps after the run too (one spawn, not two)
        it = tr.data_iter(args)
    if not isinstance(it, MPImageRecordIter):
        fail("imagenet_train: --rec did not run the worker pipeline (%s)"
             % type(it).__name__)
    made = []
    record_iter = mx.io.ImageRecordIter

    def recording(**kw):
        if made:  # the example makes the iterator again each epoch
            it.reset()
        made.append(kw)
        return it

    it.close = lambda: None  # the run's end must not stop the workers
    mx.io.ImageRecordIter = recording
    try:
        t0 = time.perf_counter()
        res = tr.run(args)
        run_s = time.perf_counter() - t0
    finally:
        mx.io.ImageRecordIter = record_iter
        del it.close  # the class's close again
    losses, step, ctx = res["losses"], res["step"], res["ctx"]
    calls = dict(it.lib_calls)
    per_epoch = IMAGENET_IMAGES // IMAGENET_BATCH
    if len(made) != args.num_epochs:
        fail("imagenet_train: the example made %d record iterators"
             % len(made))
    if len(losses) != args.num_epochs * per_epoch \
            or not np.isfinite(losses).all():
        fail("imagenet_train: losses %s" % losses)
    if calls["decode"] < len(losses) * IMAGENET_BATCH \
            or calls["resize"] < len(losses) * IMAGENET_BATCH:
        fail("imagenet_train: library calls %s for %d images"
             % (calls, len(losses) * IMAGENET_BATCH))
    skip = 3  # the workers' start-up, the capture and the first replays
    epochs = []
    for e, lo in enumerate((skip, per_epoch)):
        w = res["wait_s"][lo:(e + 1) * per_epoch]
        b = res["step_s"][lo:(e + 1) * per_epoch]
        epochs.append({"epoch": e + 1, "batches": len(b),
                       "img_per_s": IMAGENET_BATCH * len(b)
                       / (sum(w) + sum(b)),
                       "data_wait_share": sum(w) / (sum(w) + sum(b)),
                       "wait_ms": _spread_ms(w), "step_ms": _spread_ms(b),
                       "wait_ms_each": [round(1e3 * x, 1) for x in w]})
    # the same captured step fed by NDArrayIter (the example's synthetic
    # set), the same loop: wait for the batch, step, read the loss
    nd_args = tr.parse_args(["--num-batches", str(
        2 * (IMAGENET_PROFILE_STEPS + skip))])
    with ctx:
        nd_iter = tr.data_iter(nd_args)
        nd_wait, nd_busy = [], []
        for i, batch in enumerate(tr._timed(nd_iter, nd_wait)):
            t0 = time.perf_counter()
            float(step(batch.data[0], batch.label[0]).asnumpy())
            nd_busy.append(time.perf_counter() - t0)
            if i + 1 == IMAGENET_PROFILE_STEPS + skip:
                break
        nd_wall = sum(nd_wait[skip:]) + sum(nd_busy[skip:])
        nd_rate = IMAGENET_BATCH * len(nd_busy[skip:]) / nd_wall
        it.reset()
        profiles = {}
        try:
            for name, source, warm, steps in (
                    ("rec", it, IMAGENET_REC_PROFILE["skip"],
                     IMAGENET_REC_PROFILE["steps"]),
                    ("ndarray", nd_iter, skip, IMAGENET_PROFILE_STEPS)):
                batches = iter(source)

                def one():
                    batch = next(batches)
                    float(step(batch.data[0], batch.label[0]).asnumpy())

                for _ in range(warm):
                    one()
                profiles[name] = _device_profile(one, steps)
        finally:
            it.close()
    phase("imagenet_train", card=CARD, host_cpu=_host_cpu(),
          model=args.model, batch=args.batch_size, side=args.image_size,
          batches=len(losses), workers=len(it._workers), run_s=run_s,
          loss_first_last=[losses[0], losses[-1]],
          rec_img_per_s=epochs[-1]["img_per_s"],
          rec_data_wait_share=epochs[-1]["data_wait_share"],
          rec_epochs=epochs, ndarray_img_per_s=nd_rate,
          ndarray_data_wait_share=sum(nd_wait[skip:]) / nd_wall,
          rec_device_busy_share=profiles["rec"]["device_busy_share"],
          ndarray_device_busy_share=profiles["ndarray"]["device_busy_share"],
          profile=profiles, lib_calls=calls,
          compile_count=step.compile_count)
    if step.compile_count != 1:
        fail("imagenet_train: %d captures" % step.compile_count)
    torch.cuda.synchronize()


def device_infeed():
    """DevicePrefetchIter on the card: host batches staged through pinned
    memory on its side stream equal the host's, land on the card, and a
    resume skips on the host; a batch already there passes through."""
    import torch

    import mxnet_tpu_torch as mx

    rs = np.random.RandomState(IMAGENET_SEED)
    x = rs.rand(8 * IMAGENET_BATCH, 3, 64, 64).astype(np.float32)
    y = rs.randint(0, 1000, 8 * IMAGENET_BATCH).astype(np.float32)
    with mx.cpu():
        want = [(b.data[0].asnumpy(), b.label[0].asnumpy())
                for b in mx.io.NDArrayIter(x, y, IMAGENET_BATCH)]
        base = mx.io.NDArrayIter(x, y, IMAGENET_BATCH)
    it = mx.io.DevicePrefetchIter(base, ctx=mx.gpu(0), depth=2)
    t0 = time.perf_counter()
    got = [b for b in it]
    torch.cuda.synchronize()
    staged_s = time.perf_counter() - t0
    on_card = all(b.data[0]._data.is_cuda and b.label[0]._data.is_cuda
                  for b in got)
    same = len(got) == len(want) and all(
        np.array_equal(b.data[0].asnumpy(), d)
        and np.array_equal(b.label[0].asnumpy(), lab)
        for b, (d, lab) in zip(got, want))
    it.set_state({"delivered": 5})
    resumed = [b.label[0].asnumpy() for b in it]
    resume_ok = len(resumed) == 3 and all(
        np.array_equal(r, want[5 + i][1]) for i, r in enumerate(resumed))
    with mx.gpu(0):
        card_base = mx.io.NDArrayIter(x[:64], y[:64], IMAGENET_BATCH)
    first = card_base.next()
    card_base.reset()
    on_card_it = mx.io.DevicePrefetchIter(card_base, ctx=mx.gpu(0))
    passed = on_card_it.next()
    # no staging stream was made: nothing was copied
    through = on_card_it._stream is None and np.array_equal(
        passed.data[0].asnumpy(), first.data[0].asnumpy())
    phase("device_infeed", batches=len(got), shape=list(x.shape[1:]),
          staged_s=staged_s, on_card=on_card, equal=same,
          resume_equal=resume_ok, pass_through_equal=through)
    if not (on_card and same and resume_ok and through):
        fail("device_infeed: staged batches wrong (on card %s, equal %s, "
             "resume %s, pass-through %s)" % (on_card, same, resume_ok,
                                              through))


def imagenet_phases():
    """The slice's four phases (``--imagenet``)."""
    imgcodec()
    imagenet_train(imagenet_rec())
    device_infeed()


# ---------------------------------------------------------------------------
# the distributed slice: jobs through the port's launcher on the card
# ---------------------------------------------------------------------------
# every job starts as `python mxnet_tpu_torch/tools/launch.py -n N -- ...`
# from this checkout (the launcher by path: it imports only the standard
# library); a rank that fails makes its launcher exit non-zero,
# and the phase fails the script. One card: a 1-rank job is NCCL, a 2-rank
# job gloo with both ranks on the card and their exchanges staged through
# pinned host memory
DIST_SYNC_MARKERS = ("DIST_KVSTORE_OK", "DIST_TRAINER_OK",
                     "DIST_HEARTBEAT_OK", "DIST_RING_ATTENTION_OK")
DIST_BRANCH_MARKERS = (
    "BRANCH_PER_DEVICE_SUM_OK", "BRANCH_PER_DEVICE_MEAN_OK",
    "BRANCH_PER_DEVICE_MAXMIN_OK", "BRANCH_PREREDUCE_SUM_OK",
    "BRANCH_PREREDUCE_MEAN_OK", "BRANCH_PREREDUCE_MAX_OK",
    "BRANCH_PREREDUCE_MIN_OK")
DIST_ASYNC_MARKERS = ("ASYNC_PUSHPULL_OK", "ASYNC_UPDATER_REJECTED_OK")
# dist_ring: ring and Ulysses over 2 ranks at a long-context shape, fp32,
# against the plain attention and its autograd gradients on the card at
# the JAX test's bound (tests/test_sequence_parallel.py)
DIST_RING_SHAPE = (1, 8, 8192, 64)
DIST_RING_TOL = dict(rtol=2e-4, atol=2e-5)
DIST_RING_ITERS = 3
# pipeline: parallel.pipeline_apply over the ring job's 2 ranks (a stage a
# rank), tanh(x @ w) stages of width PIPE_WIDTH, PIPE_MICRO microbatches
# of PIPE_ROWS rows, against both stages applied in turn on one rank to
# each microbatch (the same GEMM shapes: cuBLAS picks another kernel for
# the whole stream at once, 6e-6 off)
PIPE_WIDTH, PIPE_MICRO, PIPE_ROWS, PIPE_ITERS = 4096, 8, 256, 3
PIPE_TOL = dict(rtol=1e-5, atol=1e-6)
# dist_resnet: BASELINE workload 5's model (resnet50_v1, 224 x 224, 1000
# classes, fp32, batch 32 a rank, SGD 0.05 with momentum 0.9 through a
# dist_sync Trainer), 3 compared steps on seeded data (the full script's
# time limit); the 2-rank weights
# against one process that sums both shards' gradients in rank order,
# within DIST_RESNET_TOL of each tensor's largest magnitude (bit for bit
# expected: two summands add alike in any order)
DIST_RESNET_STEPS, DIST_RESNET_TOL = 3, 1e-5
DIST_RESNET_SGD = {"learning_rate": 0.05, "momentum": 0.9}
# dist_planes: the captured training planes across the job's ranks, inside
# dist_resnet's two jobs at the same width (resnet50_v1, 224 x 224, 1000
# classes, SGD 0.05 with momentum 0.9, deterministic cuDNN, TF32 off), on
# DIST_RESNET_STEPS global batches of 2 x 32 (dist_resnet's two shards
# together). The 1-rank job runs the single-process plane (before it joins
# the job) and the plane in its 1-rank NCCL group, captured: bit-equal.
# The 2-rank job (gloo, ranks sharing the card) runs InferStep, TrainStep
# and TrainPlane on the same global batches: hashes equal every step, each
# rank's loss vectors the whole batch's, InferStep's logits and step 0's
# float32 loss vectors within DIST_PLANES_TOL of the single-process
# plane's. The global BatchNorm's formula is not cuDNN's, and this net at
# its seeded start turns a float32 rounding difference into percents of a
# tensor within one step: so the 2-rank TrainStep and TrainPlane are held
# to DIST_PLANES_TOL of the single-process plane and TrainStep in float64
# on the same global batches: the plane all DIST_RESNET_STEPS steps (the
# weights, the moving statistics and the loss vectors), TrainStep its
# first (its optimizer states stay float32), its float32 run bit-equal to
# the plane's at every step; their float32 runs' distance from the
# single-process plane after the last step is a reading. A tensor whose
# largest magnitude is under DIST_PLANES_FLOOR is held against the floor
# (the convolutions' biases before a BatchNorm have no gradient in exact
# arithmetic: rounding noise only). The 1-rank planes also time DIST_PLANES_TIMED steps at batch 32.
DIST_PLANES_TOL, DIST_PLANES_FLOOR, DIST_PLANES_TIMED = 1e-4, 1e-2, 5
# ring_prefill_serve: the serve traffic with prompts of at least this many
# tokens routed through the ring prefill (the system-prompt third reaches
# 36-56 tokens, the rest 4-24)
RING_PREFILL_LEN = 40


def _dist_env():
    env = dict(os.environ)
    for k in ("MXNET_COORDINATOR_ADDR", "MXNET_NUM_WORKERS",
              "MXNET_WORKER_RANK", "MXNET_JOB_TOKEN", "LOCAL_RANK"):
        env.pop(k, None)
    return env


def _dist_start(n, argv):
    """Start ``argv`` on ``n`` ranks through the port's launcher from this
    checkout; returns the job for :func:`_dist_wait`."""
    here = os.path.dirname(os.path.abspath(__file__))
    # the launcher by path: it imports only the standard library
    proc = subprocess.Popen(
        [sys.executable, os.path.join("mxnet_tpu_torch", "tools",
                                      "launch.py"), "-n", str(n), "--"] +
        list(argv), cwd=here, env=_dist_env(), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    return proc, time.perf_counter()


def _dist_wait(what, n, job, timeout=900):
    """Wait for a job of :func:`_dist_start`; fail (printing the job's
    tail) unless it exits 0 within ``timeout`` seconds of its start.
    Returns (stdout, wall seconds)."""
    proc, t0 = job
    try:
        out, err = proc.communicate(
            timeout=max(1.0, timeout - (time.perf_counter() - t0)))
    except subprocess.TimeoutExpired:
        _dist_stop(job)
        fail("%s: the %d-rank job ran past %d s" % (what, n, timeout))
    secs = time.perf_counter() - t0
    if proc.returncode != 0:
        print(out[-6000:], flush=True)
        print(err[-3000:], file=sys.stderr, flush=True)
        fail("%s: the %d-rank job exited %d" % (what, n, proc.returncode))
    return out, secs


def _dist_stop(job):
    """End a job of :func:`_dist_start` that is still running: SIGINT, on
    which the launcher ends its ranks' process groups, then SIGKILL."""
    import signal

    proc, _t0 = job
    if proc.poll() is None:
        proc.send_signal(signal.SIGINT)
        try:
            proc.communicate(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.communicate()


def _dist_job(what, n, argv, timeout=900):
    """Run ``argv`` on ``n`` ranks (:func:`_dist_start`,
    :func:`_dist_wait`); returns (stdout, wall seconds)."""
    return _dist_wait(what, n, _dist_start(n, argv), timeout)


def _rank_lines(out, n, tag, each=1):
    """Each rank's ``rank <r>: <tag> {json}`` readings, in rank order: one
    a rank, or with ``each`` > 1 a list of that many a rank, in the order
    printed."""
    got = {}
    for line in out.splitlines():
        m = re.search(r"rank (\d+): %s (\{.*\})$" % tag, line)
        if m:
            got.setdefault(int(m.group(1)), []).append(json.loads(
                m.group(2)))
    if sorted(got) != list(range(n)) or \
            any(len(v) != each for v in got.values()):
        fail("%s readings %s from ranks of %d (%d a rank expected)"
             % (tag, {r: len(v) for r, v in got.items()}, n, each))
    return [got[r] if each > 1 else got[r][0] for r in range(n)]


def _expected_backend(n):
    import torch

    return "nccl" if n <= torch.cuda.device_count() else "gloo"


DIST_NIGHTLY = (("torch_dist_sync_kvstore.py", DIST_SYNC_MARKERS),
                ("torch_dist_allreduce_branches.py", DIST_BRANCH_MARKERS),
                ("torch_dist_async_kvstore.py", DIST_ASYNC_MARKERS))


def dist_kvstore():
    """The port's three nightly scripts: dist_sync alone at 1 rank (NCCL),
    then all three in one 2-rank job (gloo on one card; each rank imports
    the package once and runs the scripts in turn, ``--dist-rank
    nightly``). Every rank prints every marker; each script's backend
    must be the topology's, with staged bytes 0 under NCCL and above 0
    under gloo (the card tensors went through host memory)."""
    jobs = []
    for n, scripts in ((1, DIST_NIGHTLY[:1]), (2, DIST_NIGHTLY)):
        names = [name for name, _ in scripts]
        if n == 1:
            argv = [sys.executable, os.path.join("tests", "nightly",
                                                 names[0])]
        else:
            argv = [sys.executable, "chip_smoke.py", "--dist-rank",
                    "nightly"] + names
        out, secs = _dist_job("dist_kvstore", n, argv)
        readings = _rank_lines(out, n, "JOB", each=len(scripts))
        want = _expected_backend(n)
        staged_before = [0] * n
        for i, (script, markers) in enumerate(scripts):
            for r in range(n):
                for marker in markers:
                    if "rank %d: %s" % (r, marker) not in out:
                        print(out[-4000:], flush=True)
                        fail("%s: rank %d printed no %s"
                             % (script, r, marker))
            rds = [readings[r][i] if len(scripts) > 1 else readings[r]
                   for r in range(n)]
            staged = []
            for r, rd in enumerate(rds):
                if rd["backend"] != want or rd["world"] != n or \
                        not rd["device"].startswith("cuda"):
                    fail("%s: rank reading %s, expected %s on the card"
                         % (script, rd, want))
                # the group's count is the process's: this script's part
                staged.append(rd["staged_bytes"] - staged_before[r])
                staged_before[r] = rd["staged_bytes"]
                if (staged[-1] == 0) != (want == "nccl"):
                    fail("%s: %d staged bytes under %s"
                         % (script, staged[-1], want))
            jobs.append(dict(script=script, ranks=n, backend=want,
                             rank_s=[rd["seconds"] for rd in rds],
                             staged_bytes=staged,
                             markers=len(markers) * n))
        jobs[-1]["job_s"] = secs
    phase("dist_kvstore", jobs=jobs)


def _plain_attention(q, k, v, causal):
    import torch

    scores = torch.einsum("bhqd,bhkd->bhqk", q, k) / float(
        np.sqrt(q.shape[-1]))
    if causal:
        s = scores.shape[-1]
        mask = torch.ones((s, s), dtype=torch.bool,
                          device=q.device).tril()
        scores = scores.masked_fill(~mask, float("-inf"))
    return torch.einsum("bhqk,bhkd->bhqd", torch.softmax(scores, -1), v)


def _rank_ring():
    """A rank of dist_ring: ring and Ulysses, causal and full, on this
    rank's block of DIST_RING_SHAPE, against the plain attention on the
    card; the job's gradients (summed over the ranks) against autograd
    through the plain attention. Raises (the rank fails) past the bound."""
    import torch

    from mxnet_tpu_torch import _dist, parallel, sequence_parallel as sp

    grp = _dist.group()
    r, n, dev = grp.rank, grp.world, grp.device
    b, h, s, d = DIST_RING_SHAPE
    rs = np.random.RandomState(5)
    base = [torch.from_numpy(rs.randn(b, h, s, d).astype(np.float32) *
                             0.5).to(dev) for _ in range(3)]
    mesh = sp.sequence_mesh()
    rows = slice(r * s // n, (r + 1) * s // n)
    res = {}
    for causal in (False, True):
        q, k, v = (x.clone().requires_grad_() for x in base)
        ref = _plain_attention(q, k, v, causal)
        (ref ** 2).sum().backward()
        ref_out = ref.detach()[:, :, rows].clone()
        ref_g = [x.grad for x in (q, k, v)]
        del ref, q, k, v
        with torch.no_grad():
            plain_ms = time_ms(lambda: _plain_attention(*base, causal),
                               iters=DIST_RING_ITERS, warm=1)
        for name, fn in (("ring", sp.ring_attention),
                         ("ulysses", sp.ulysses_attention)):
            q, k, v = (x.clone().requires_grad_() for x in base)
            staged = grp.staged_bytes
            out = fn(q, k, v, mesh=mesh, causal=causal)
            (out ** 2).sum().backward()
            call_staged = grp.staged_bytes - staged
            grads = [parallel.all_reduce([x.grad], "sum")
                     for x in (q, k, v)]
            torch.cuda.synchronize(dev)
            err = float((out.detach() - ref_out).abs().max())
            np.testing.assert_allclose(out.detach().cpu().numpy(),
                                       ref_out.cpu().numpy(),
                                       **DIST_RING_TOL)
            gerr = []
            for g, want, nm in zip(grads, ref_g, "qkv"):
                gerr.append(float((g - want).abs().max()))
                np.testing.assert_allclose(
                    g.cpu().numpy(), want.cpu().numpy(), **DIST_RING_TOL,
                    err_msg="%s causal=%s d%s" % (name, causal, nm))
            del out, grads, q, k, v
            with torch.no_grad():
                fwd_ms = time_ms(lambda: fn(*base, mesh=mesh,
                                            causal=causal),
                                 iters=DIST_RING_ITERS, warm=1)
            res["%s_%s" % (name, "causal" if causal else "full")] = dict(
                max_abs_err=err, grad_max_abs_err=max(gerr),
                fwd_ms=fwd_ms, plain_fwd_ms=plain_ms,
                staged_bytes_fwd_bwd=call_staged)
        del ref_out, ref_g
        torch.cuda.empty_cache()
    print("rank %d: RING %s" % (r, json.dumps(dict(
        backend=grp.backend, world=n, cases=res))), flush=True)
    print("rank %d: PIPE %s" % (r, json.dumps(_rank_pipeline(grp))),
          flush=True)


def _rank_pipeline(grp):
    """A rank of the pipeline phase: ``pipeline_apply`` of the job's
    stages on the card against the stages applied in turn here (raises
    past PIPE_TOL); ms a call, both ways, and staged bytes a call."""
    import torch

    from mxnet_tpu_torch import parallel

    n, dev = grp.world, grp.device
    rs = np.random.RandomState(9)
    ws = torch.from_numpy((rs.randn(n, PIPE_WIDTH, PIPE_WIDTH) /
                           np.sqrt(PIPE_WIDTH)).astype(np.float32)).to(dev)
    xs = torch.from_numpy(rs.randn(PIPE_MICRO, PIPE_ROWS, PIPE_WIDTH)
                          .astype(np.float32)).to(dev)
    mesh = parallel.device_mesh(axis_names=("pp",))

    def stage(w, x):
        return torch.tanh(x @ w)

    def sequential():
        outs = []
        for x in xs:
            for s in range(n):
                x = stage(ws[s], x)
            outs.append(x)
        return torch.stack(outs)

    staged = grp.staged_bytes
    out = parallel.pipeline_apply(stage, ws, xs, mesh)
    staged = grp.staged_bytes - staged
    ref = sequential()
    err = float((out - ref).abs().max())
    np.testing.assert_allclose(out.cpu().numpy(), ref.cpu().numpy(),
                               **PIPE_TOL)
    with torch.no_grad():
        ms = time_ms(lambda: parallel.pipeline_apply(stage, ws, xs, mesh),
                     iters=PIPE_ITERS, warm=1)
        seq_ms = time_ms(sequential, iters=PIPE_ITERS, warm=1)
    return dict(backend=grp.backend, world=n, shape=list(xs.shape),
                max_abs_err=err, bit_equal=bool(torch.equal(out, ref)),
                ms=ms, sequential_ms=seq_ms, staged_bytes_a_call=staged)


def dist_ring():
    """Ring and Ulysses attention across 2 ranks at DIST_RING_SHAPE
    (``_rank_ring``): within DIST_RING_TOL of the plain attention and its
    gradients; ms a call and staged bytes a forward and backward. Then
    the pipeline phase in the same job (``_rank_pipeline``)."""
    out, secs = _dist_job("dist_ring", 2, [
        sys.executable, "chip_smoke.py", "--dist-rank", "ring"])
    ranks = _rank_lines(out, 2, "RING")
    phase("dist_ring", shape=list(DIST_RING_SHAPE), job_s=secs,
          backend=ranks[0]["backend"], tol=DIST_RING_TOL,
          rank0=ranks[0]["cases"], rank1=ranks[1]["cases"])
    pipe = _rank_lines(out, 2, "PIPE")
    phase("pipeline", stages=2, width=PIPE_WIDTH, microbatches=PIPE_MICRO,
          rows=PIPE_ROWS, tol=PIPE_TOL, card=CARD, job_s=secs,
          rank0=pipe[0], rank1=pipe[1])


def dist_cifar():
    """``cifar10_dist.py`` at its defaults (3 epochs, batch 32 a rank, 512
    synthetic samples) on 2 ranks of the card: the job's loss (the ranks'
    mean) falls from the first epoch to the last, and both ranks end with
    the same weights (sha256)."""
    out, secs = _dist_job("dist_cifar", 2, [
        sys.executable, "-m",
        "mxnet_tpu_torch.example.distributed_training.cifar10_dist"])
    losses, speeds, shas = {}, {}, {}
    for line in out.splitlines():
        m = re.search(r"\[worker (\d+) epoch (\d+)\] loss ([0-9.]+) .*\(([0-9.]+)"
                      r" img/s\)", line)
        if m:
            losses.setdefault(int(m.group(1)), []).append(float(m.group(3)))
            speeds.setdefault(int(m.group(1)), []).append(float(m.group(4)))
        m = re.search(r"worker (\d+) params sha256 ([0-9a-f]{64})", line)
        if m:
            shas[int(m.group(1))] = m.group(2)
    if sorted(shas) != [0, 1] or sorted(losses) != [0, 1] or \
            any(len(v) != 3 for v in losses.values()):
        print(out[-4000:], flush=True)
        fail("dist_cifar: readings missing (%s, %s)" % (sorted(shas),
                                                       sorted(losses)))
    if shas[0] != shas[1]:
        fail("dist_cifar: the ranks' weights differ (%s, %s)"
             % (shas[0], shas[1]))
    job = [float(np.mean([losses[r][e] for r in (0, 1)])) for e in range(3)]
    if not job[-1] < job[0]:
        fail("dist_cifar: the job's loss did not fall: %s" % job)
    phase("dist_cifar", job_s=secs, job_loss=job, rank_loss=losses,
          img_per_s_a_rank=speeds, sha256_equal=True,
          backend=_expected_backend(2))


def _resnet_net(ctx, kvstore):
    from mxnet_tpu_torch import gluon
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon.model_zoo import vision

    with ctx:
        mx.random.seed(0)
        net = vision.resnet50_v1(classes=RESNET_CLASSES)
        net.initialize(mx.initializer.Xavier(rnd_type="gaussian",
                                             factor_type="in", magnitude=2))
        net(mx.nd.zeros((1, 3, RESNET_SIDE, RESNET_SIDE)))
        trainer = gluon.Trainer(net.collect_params(), "sgd",
                                dict(DIST_RESNET_SGD), kvstore=kvstore)
    return net, trainer


def _resnet_batch(step):
    """Step ``step``'s two-shard batch, as numpy."""
    rs = np.random.RandomState(1000 + step)
    x = rs.rand(2 * RESNET_BATCH, 3, RESNET_SIDE, RESNET_SIDE).astype(
        np.float32)
    y = rs.randint(0, RESNET_CLASSES, 2 * RESNET_BATCH).astype(np.float32)
    return x, y


def _resnet_shard(step, shard, ctx, rows=None, dtype="float32"):
    """The rows of shard ``shard`` of step ``step``'s two-shard batch (or
    ``rows`` of it)."""
    import mxnet_tpu_torch as mx

    x, y = _resnet_batch(step)
    if rows is None:
        rows = slice(shard * RESNET_BATCH, (shard + 1) * RESNET_BATCH)
    return (mx.nd.array(x[rows], ctx=ctx, dtype=dtype),
            mx.nd.array(y[rows], ctx=ctx, dtype=dtype))


def _trainable(net):
    return [(k, p) for k, p in net.collect_params().items()
            if p.grad_req != "null"]


def _aux(net):
    return [(k, p) for k, p in net.collect_params().items()
            if p.grad_req == "null"]


def _resnet_arrays(net):
    """The trainable parameters (``p<i>``) and the moving statistics
    (``a<i>``) in the net's order: two nets built alike name their
    parameters with different prefixes."""
    out = {"p%d" % i: np.array(p.data()._data.detach().cpu())
           for i, (_k, p) in enumerate(_trainable(net))}
    out.update({"a%d" % i: np.array(p.data()._data.detach().cpu())
                for i, (_k, p) in enumerate(_aux(net))})
    return out


def _sha(net):
    h = hashlib.sha256()
    for _k, p in _trainable(net):
        h.update(p.data()._data.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def _busy_share(fn, dev):
    """The device's busy share over one run of ``fn()``: the CUDA events
    of one torch.profiler session over the run's wall time (one session:
    every rank runs the same steps, so no rank may retry alone); None
    where the session recorded no device event."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
    busy = sum(e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == DeviceType.CUDA) / 1e6
    return busy / wall if busy else None


def _rank_resnet(out_dir, planes_ref=None):
    """A rank of dist_resnet: DIST_RESNET_STEPS dist_sync steps on its
    shard, a weight hash after each, readings of the exchange, then the
    planes across the job (:func:`_rank_planes`), then (in a 1-rank job)
    the single-process reference: both shards' gradients on the same
    weights, summed in rank order, one step, each shard with its own
    BatchNorm moving statistics. Writes the final weights and moving
    statistics for the parent to compare."""
    import torch

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import _dist, autograd, gluon
    from mxnet_tpu_torch.fastpath import bucketing

    torch.backends.cudnn.deterministic = True
    grp = _dist.group()
    r, n, dev = grp.rank, grp.world, grp.device
    ctx = mx.current_context()
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    net, trainer = _resnet_net(ctx, "dist_sync")
    hashes, step_ms, ex_ms = [], [], []
    with ctx:
        for step in range(DIST_RESNET_STEPS + 2):
            x, y = _resnet_shard(step, r, ctx)
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            with autograd.record():
                loss = loss_fn(net(x), y)
            loss.backward()
            torch.cuda.synchronize(dev)
            t1 = time.perf_counter()
            trainer.allreduce_grads()
            torch.cuda.synchronize(dev)
            t2 = time.perf_counter()
            trainer.update(RESNET_BATCH * n)
            torch.cuda.synchronize(dev)
            t3 = time.perf_counter()
            if step < DIST_RESNET_STEPS:
                hashes.append(_sha(net))
                if step == DIST_RESNET_STEPS - 1:
                    final = _resnet_arrays(net)
            if step:
                step_ms.append((t3 - t0) * 1e3)
                ex_ms.append((t2 - t1) * 1e3)
        # the device's busy share over one more step (every rank runs it)
        x, y = _resnet_shard(0, r, ctx)

        def one_step():
            with autograd.record():
                step_loss = loss_fn(net(x), y)
            step_loss.backward()
            trainer.step(RESNET_BATCH * n)

        busy_share = _busy_share(one_step, dev)
    grads = [p.grad()._data for _k, p in _trainable(net)]
    nbytes = sum(g.numel() * g.element_size() for g in grads)
    plan = bucketing.plan_for(grads)
    if n > 1:  # the reference runs in the 1-rank job
        np.savez(os.path.join(out_dir, "resnet_n%d_rank%d.npz" % (n, r)),
                 **final)
    staged = grp.staged_bytes
    del net, trainer, grads
    gc.collect()
    torch.cuda.empty_cache()
    planes = _rank_planes(grp, ctx, loss_fn, out_dir, planes_ref)
    reading = dict(backend=grp.backend, world=n, hashes=hashes,
                   step_ms=float(np.mean(step_ms)),
                   exchange_ms=float(np.mean(ex_ms)), exchange_bytes=nbytes,
                   exchange_groups=plan.n_out if plan else len(grads),
                   buckets=len(plan.buckets) if plan else 0,
                   exchange_gb_s=nbytes / (np.mean(ex_ms) / 1e3) / 1e9,
                   device_busy_share=busy_share,
                   staged_bytes=staged, planes=planes)
    if n == 1:
        reading["reference_hashes"] = _resnet_reference(out_dir, ctx,
                                                        loss_fn)
    print("rank %d: RESNET %s" % (r, json.dumps(reading)), flush=True)


def _plane_ms(plane, ctx, dev):
    """ms a step of ``plane`` at batch RESNET_BATCH (the first 32 rows of
    step 0's batch, a path of its own), over DIST_PLANES_TIMED steps after
    its first."""
    import torch

    x, y = _resnet_shard(0, 0, ctx)
    plane.step(x, y)
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    for _ in range(DIST_PLANES_TIMED):
        plane.step(x, y)
    torch.cuda.synchronize(dev)
    return (time.perf_counter() - t0) / DIST_PLANES_TIMED * 1e3


def _float64_steps(ctx, loss_fn, kind):
    """DIST_RESNET_STEPS steps in float64 on the global batches from the
    seeded weights: ``kind`` ``plane`` (TrainPlane) or ``trainstep``;
    returns the weights and the moving statistics after the last step
    and, of the plane, the loss vector of every step (``losses``), of
    TrainStep also after the first step (``first/``: its optimizer
    states stay float32, as the JAX step's, so from the second step on
    its momentum carries float32 rounding)."""
    import torch

    from mxnet_tpu_torch import parallel, trainplane

    net, trainer = _resnet_net(ctx, None)
    with ctx:
        net.cast("float64")
        batches = [_resnet_shard(step, 0, ctx, rows=slice(None),
                                 dtype="float64")
                   for step in range(DIST_RESNET_STEPS)]
        if kind == "plane":
            plane = trainplane.TrainPlane(net, loss_fn, trainer)
            losses = np.stack([plane.step(x, y).asnumpy()
                               for x, y in batches])
            out = dict(_resnet_arrays(net), losses=losses)
            del plane
        else:
            step = parallel.TrainStep(net, loss_fn, "sgd",
                                      optimizer_params=dict(DIST_RESNET_SGD))

            def arrays():
                return dict(
                    {"p%d" % i: np.array(step.params[k].detach().cpu())
                     for i, (k, _p) in enumerate(_trainable(net))},
                    **{"a%d" % i: np.array(step.params[k].detach().cpu())
                       for i, (k, _p) in enumerate(_aux(net))})

            for i, (x, y) in enumerate(batches):
                step(x, y)
                if i == 0:
                    first = arrays()
            out = dict(arrays(), **{"first/" + k: v
                                    for k, v in first.items()})
            del step
    del net, trainer, batches
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _planes_reference(out_dir):
    """The single-process plane (this process has not joined a job yet):
    InferStep on step 0's global batch with the seeded initial weights,
    then TrainPlane for DIST_RESNET_STEPS steps on the global batches, a
    hash after each, then its ms a step at batch 32; then the same steps
    in float64, of the plane and of TrainStep. Writes the logits, the loss vectors, the weights and the
    moving statistics (and the float64 run's); returns the readings and
    the arrays (for the 1-rank job's bit comparison)."""
    import torch

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import gluon, parallel, trainplane

    torch.backends.cudnn.deterministic = True
    t0 = time.perf_counter()
    ctx = mx.current_context()
    dev = ctx.torch_device()
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    net, trainer = _resnet_net(ctx, None)
    with ctx:
        x0, _ = _resnet_shard(0, 0, ctx, rows=slice(None))
        logits = parallel.InferStep(net)(x0).asnumpy()
        plane = trainplane.TrainPlane(net, loss_fn, trainer)
        losses, hashes = [], []
        for step in range(DIST_RESNET_STEPS):
            x, y = _resnet_shard(step, 0, ctx, rows=slice(None))
            losses.append(plane.step(x, y).asnumpy())
            hashes.append(_sha(net))
        arrays = _resnet_arrays(net)
        ms = _plane_ms(plane, ctx, dev)
        plane_captures = plane.compile_count
    del plane, net, trainer
    gc.collect()
    torch.cuda.empty_cache()
    f64 = _float64_steps(ctx, loss_fn, "plane")
    f64ts = _float64_steps(ctx, loss_fn, "trainstep")
    np.savez(os.path.join(out_dir, "planes_reference.npz"), logits=logits,
             losses=np.stack(losses), **arrays,
             **{"f64/" + k: v for k, v in f64.items()},
             **{"f64ts/" + k: v for k, v in f64ts.items()})
    reading = dict(hashes=hashes, ms_a_step_32=ms,
                   captures=plane_captures,
                   seconds=time.perf_counter() - t0)
    return reading, arrays


def _traced_plane_step(plane, x, y, dev):
    """The CUDA kernels one traced step of a captured plane ran: their
    count, NCCL's (``nccl*``, and ``oneRankReduce``, what NCCL runs for a
    collective over one rank) and cuDNN's (``cudnn``, ``xmma``,
    convolution kernels); a session that recorded nothing runs again,
    three at most."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    names = []
    for _ in range(3):
        torch.cuda.synchronize(dev)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            plane.step(x, y)
            torch.cuda.synchronize(dev)
        names = [e.name for e in prof.events()
                 if e.device_type == DeviceType.CUDA]
        if names:
            break
    low = [n.lower() for n in names]
    nccl = sorted({n for n, lo in zip(names, low)
                   if "nccl" in lo or "onerank" in lo})
    return dict(kernels=len(names), nccl_kernels=nccl,
                cudnn_kernels=sum(1 for lo in low if "cudnn" in lo
                                  or "xmma" in lo or "conv" in lo))


def _rank_planes(grp, ctx, loss_fn, out_dir, ref):
    """A rank's dist_planes: on a fresh seeded net, InferStep on step 0's
    global batch; in the 2-rank job TrainStep for DIST_RESNET_STEPS steps
    (a hash after each); then TrainPlane for DIST_RESNET_STEPS steps (a
    hash and the loss vector after each); in the 2-rank job then the same
    steps of each in float64, in the 1-rank job the plane's ms a step at
    batch 32, one traced step and the bits against the single-process
    plane (``ref``, run before the job)."""
    import torch

    from mxnet_tpu_torch import parallel, telemetry, trainplane

    r, n, dev = grp.rank, grp.world, grp.device
    t0 = time.perf_counter()
    net, trainer = _resnet_net(ctx, None)
    saved = {}
    with ctx:
        x0, _ = _resnet_shard(0, 0, ctx, rows=slice(None))
        saved["logits"] = parallel.InferStep(net)(x0).asnumpy()
        ts_hashes = []
        if n > 1:
            ts = parallel.TrainStep(net, loss_fn, "sgd",
                                    optimizer_params=dict(DIST_RESNET_SGD))
            for step in range(DIST_RESNET_STEPS):
                x, y = _resnet_shard(step, 0, ctx, rows=slice(None))
                ts(x, y)
                ts_hashes.append(_digest([ts.params[k] for k, _p in
                                          _trainable(net)]))
            for i, (k, _p) in enumerate(_trainable(net)):
                saved["ts/p%d" % i] = np.array(ts.params[k].detach().cpu())
            for i, (k, _p) in enumerate(_aux(net)):
                saved["ts/a%d" % i] = np.array(ts.params[k].detach().cpu())
            del ts
        plane = trainplane.TrainPlane(net, loss_fn, trainer)
        g0 = telemetry.STEP_DISPATCHES.value(plane="graph")
        losses, hashes, step_ms, staged = [], [], [], 0
        for step in range(DIST_RESNET_STEPS):
            x, y = _resnet_shard(step, 0, ctx, rows=slice(None))
            before = grp.staged_bytes
            torch.cuda.synchronize(dev)
            t1 = time.perf_counter()
            loss = plane.step(x, y)
            torch.cuda.synchronize(dev)
            if step:  # the first step of a path runs its first pass too
                step_ms.append((time.perf_counter() - t1) * 1e3)
                staged = grp.staged_bytes - before
            losses.append(loss.asnumpy())
            hashes.append(_sha(net))
        arrays = _resnet_arrays(net)
        reading = dict(
            plane=plane.plane, uncaptured_reason=plane.uncaptured_reason,
            hashes=hashes, ts_hashes=ts_hashes,
            loss_shape=list(losses[0].shape),
            collectives_a_step=plane.collectives_a_step,
            ms_a_step_64=float(np.mean(step_ms)),
            staged_bytes_a_step=staged)
        if n > 1:
            reading["trainstep_bit_equal_plane"] = ts_hashes == hashes
        else:
            # the step at TrainStep's batch (resnet_train's 32 rows)
            reading["ms_a_step_32"] = _plane_ms(plane, ctx, dev)
            reading["trace"] = _traced_plane_step(plane, x, y, dev)
            reading["bit_equal_reference"] = sorted(arrays) == sorted(
                ref[1]) and all(np.array_equal(arrays[k], ref[1][k])
                                for k in arrays)
            reading["hashes_equal_reference"] = hashes == ref[0]["hashes"]
            reading["reference"] = {k: v for k, v in ref[0].items()
                                    if k != "hashes"}
            reading["zero_one_rank"] = _zero_one_rank(plane, ctx)
        reading.update(
            captures=plane.compile_count, paths=len(plane._paths),
            graph_replays=plane.graph_replays,
            steps=telemetry.STEP_DISPATCHES.value(plane="graph") - g0,
            seconds=time.perf_counter() - t0)
    del plane, net, trainer
    gc.collect()
    torch.cuda.empty_cache()
    if n > 1:
        saved.update(arrays)
        saved["losses"] = np.stack(losses)
        for kind in ("plane", "trainstep"):
            saved.update({"f64/%s/%s" % (kind, k): v for k, v in
                          _float64_steps(ctx, loss_fn, kind).items()})
        np.savez(os.path.join(out_dir, "planes_n2_rank%d.npz" % r), **saved)
        reading["seconds"] = time.perf_counter() - t0
    return reading


def _zero_one_rank(plane, ctx):
    """One more step of the 1-rank NCCL plane at MXNET_ZERO=1: sharding
    over one rank is a no-op, so the step declines with the "1-device
    mesh" reason, counted once, and replays its graph replicated."""
    from mxnet_tpu_torch.fastpath import zero

    reason = "1-device mesh (sharding is a no-op)"
    f0 = zero.FALLBACKS.value(reason=reason)
    r0 = plane.graph_replays
    x, y = _resnet_shard(0, 0, ctx)
    os.environ["MXNET_ZERO"] = "1"
    try:
        plane.step(x, y)
    finally:
        os.environ.pop("MXNET_ZERO")
    got = dict(fallbacks=zero.FALLBACKS.value(reason=reason) - f0,
               replays=plane.graph_replays - r0,
               sharded=zero.plane_of(plane._trainer._updater) is not None)
    if got != dict(fallbacks=1, replays=1, sharded=False):
        fail("dist_planes: MXNET_ZERO=1 on the 1-rank NCCL plane gave %s"
             % got)
    return dict(got, reason=reason)


def _scaled_err(got, want):
    """The largest difference over the largest magnitude of ``want`` (at
    least DIST_PLANES_FLOOR)."""
    return float(np.abs(got - want).max()) / max(
        float(np.abs(want).max()), DIST_PLANES_FLOOR)


def _planes_compare(tmp, two, one):
    """dist_planes' checks (:func:`_rank_planes`): the 1-rank NCCL plane
    captured (one capture a path, every step a replay), NCCL's kernels in
    its traced step, bit-equal to the single-process plane at every step;
    the 2-rank plane and TrainStep with equal hashes every step, each
    rank's loss vectors the whole batch's, the float32 TrainStep's
    hashes the plane's; InferStep, step 0's float32 loss vectors and the
    float64 plane's every step within DIST_PLANES_TOL of the
    single-process plane's, the float64 TrainStep's first step of the
    single-process TrainStep's; the ranks' float64 runs equal. Returns the
    worst scaled differences and the float32 readings."""
    p1 = one["planes"]
    if p1["plane"] != "graph" or p1["uncaptured_reason"] is not None:
        fail("dist_planes: the 1-rank NCCL plane was not captured: %s"
             % {k: p1[k] for k in ("plane", "uncaptured_reason")})
    if p1["captures"] != p1["paths"] or \
            p1["graph_replays"] != p1["steps"]:
        fail("dist_planes: 1-rank plane captures %d for %d paths, %d "
             "replays for %d steps" % (p1["captures"], p1["paths"],
                                       p1["graph_replays"], p1["steps"]))
    if not p1["trace"]["nccl_kernels"]:
        fail("dist_planes: no NCCL kernel in the 1-rank plane's traced "
             "step (%d kernels)" % p1["trace"]["kernels"])
    if not (p1["bit_equal_reference"] and p1["hashes_equal_reference"]):
        fail("dist_planes: the 1-rank NCCL plane differs from the "
             "single-process plane")
    for key in ("hashes", "ts_hashes"):
        if two[0]["planes"][key] != two[1]["planes"][key]:
            fail("dist_planes: the 2 ranks' %s differ" % key)
    for r in (0, 1):
        pr = two[r]["planes"]
        if pr["plane"] != "graph" or pr["uncaptured_reason"] != "gloo" \
                or pr["captures"] != 0:
            fail("dist_planes: rank %d's plane %s" % (r, pr))
        if pr["loss_shape"] != [2 * RESNET_BATCH]:
            fail("dist_planes: rank %d's loss vector %s, not the whole "
                 "batch's" % (r, pr["loss_shape"]))
    ref = np.load(os.path.join(tmp, "planes_reference.npz"))
    got = [np.load(os.path.join(tmp, "planes_n2_rank%d.npz" % r))
           for r in (0, 1)]
    if not np.array_equal(got[0]["losses"], got[1]["losses"]):
        fail("dist_planes: the ranks' loss vectors differ")
    fp32 = [k for k in ref.files if k[0] in "pa"]
    f64 = [k for k in ref.files if k.startswith("f64/") and k != "f64/losses"]
    for k in got[0].files:
        if k.startswith("f64/") and not np.array_equal(got[0][k], got[1][k]):
            fail("dist_planes: the ranks' float64 %s differ" % k)
    held = {"inferstep": max(_scaled_err(g["logits"], ref["logits"])
                             for g in got),
            "float32_step0_losses": max(_scaled_err(
                g["losses"][0], ref["losses"][0]) for g in got),
            "float64_plane_losses": max(_scaled_err(
                g["f64/plane/losses"], ref["f64/losses"]) for g in got)}
    # each executor against itself in one process (TrainStep's update
    # rounds its learning rate otherwise than the plane's fused kernel);
    # TrainStep's float32 states hold it to its first step, and its
    # float32 run to the plane's bits at every step
    held["float64_plane"] = max(_scaled_err(
        g["f64/plane/" + k[4:]], ref[k]) for g in got for k in f64)
    held["float64_trainstep_first_step"] = max(_scaled_err(
        g["f64/trainstep/first/" + k[4:]], ref["f64ts/first/" + k[4:]])
        for g in got for k in f64)
    for r in (0, 1):
        if not two[r]["planes"]["trainstep_bit_equal_plane"]:
            fail("dist_planes: rank %d's float32 TrainStep differs from "
                 "its plane" % r)
    readings = {
        "float32_plane": max(_scaled_err(got[0][k], ref[k]) for k in fp32),
        "float32_trainstep": max(_scaled_err(got[0]["ts/" + k], ref[k])
                                 for k in fp32),
        "float32_losses_by_step": [_scaled_err(g, w) for g, w in zip(
            got[0]["losses"], ref["losses"])],
        "float64_trainstep_last_step": max(_scaled_err(
            g["f64/trainstep/" + k[4:]], ref["f64ts/" + k[4:]])
            for g in got for k in f64),
        "float64_trainstep_from_plane": max(_scaled_err(
            ref["f64ts/" + k[4:]], ref[k]) for k in f64)}
    bad = {k: v for k, v in held.items() if v > DIST_PLANES_TOL}
    if bad:
        fail("dist_planes: 2-rank readings beyond %g of the largest "
             "magnitude: %s (float32 readings %s)"
             % (DIST_PLANES_TOL, bad, readings))
    return held, readings


def _resnet_reference(out_dir, ctx, loss_fn):
    """One process, both shards: each shard's forward and backward on the
    same weights with its own moving statistics, the gradients summed in
    rank order, one SGD step over the two-shard batch."""
    import torch

    from mxnet_tpu_torch import autograd

    net, trainer = _resnet_net(ctx, "device")  # one context: no store
    params = _trainable(net)
    stats = [[p.data()._data.detach().clone() for _k, p in _aux(net)]
             for _ in range(2)]
    hashes = []
    with ctx:
        for step in range(DIST_RESNET_STEPS):
            total = None
            for shard in (0, 1):
                with torch.no_grad():
                    for (_k, p), v in zip(_aux(net), stats[shard]):
                        p.data()._data.copy_(v)
                x, y = _resnet_shard(step, shard, ctx)
                with autograd.record():
                    loss = loss_fn(net(x), y)
                loss.backward()
                with torch.no_grad():
                    for (_k, p), v in zip(_aux(net), stats[shard]):
                        v.copy_(p.data()._data)
                g = [p.grad()._data.detach().clone() for _k, p in params]
                total = g if total is None else [a + b for a, b in
                                                 zip(total, g)]
            with torch.no_grad():
                for (_k, p), g in zip(params, total):
                    p.grad()._data.copy_(g)
            trainer.step(2 * RESNET_BATCH)
            hashes.append(_sha(net))
    ref = {k: v for k, v in _resnet_arrays(net).items()
           if k.startswith("p")}
    for shard in (0, 1):
        ref.update({"shard%d/a%d" % (shard, i): np.array(v.cpu())
                    for i, v in enumerate(stats[shard])})
    np.savez(os.path.join(out_dir, "resnet_reference.npz"), **ref)
    return hashes


def _resnet_compare(tmp, two):
    """The 2-rank job against the reference: the ranks hash alike after
    every step, each rank's moving statistics equal the reference's for
    its shard, and the weights lie within DIST_RESNET_TOL of the
    reference's (of each tensor's largest magnitude). Returns (the worst
    relative difference, whether every weight is bit-equal)."""
    if two[0]["hashes"] != two[1]["hashes"]:
        fail("dist_resnet: the ranks' weights differ at steps %s" % [
            i for i, (a, b) in enumerate(zip(two[0]["hashes"],
                                             two[1]["hashes"])) if a != b])
    ref = np.load(os.path.join(tmp, "resnet_reference.npz"))
    worst, bits = 0.0, True
    for r in (0, 1):
        got = np.load(os.path.join(tmp, "resnet_n2_rank%d.npz" % r))
        for k in got.files:
            if ("shard%d/%s" % (r, k)) in ref.files:  # moving statistics
                if not np.array_equal(got[k], ref["shard%d/%s" % (r, k)]):
                    fail("dist_resnet: rank %d's %s differs from the "
                         "reference's shard %d" % (r, k, r))
                continue
            want = ref[k]
            scale = max(float(np.abs(want).max()), 1e-30)
            worst = max(worst, float(np.abs(got[k] - want).max()) / scale)
            bits = bits and np.array_equal(got[k], want)
    if worst > DIST_RESNET_TOL:
        fail("dist_resnet: 2-rank weights %.3g of a tensor's largest value "
             "from the reference" % worst)
    return worst, bits


def dist_resnet():
    """BASELINE workload 5's model through dist_sync on the card: a 2-rank
    job (gloo, ranks sharing the card) whose ranks hash alike after every
    step, and a 1-rank job (NCCL) that also runs the single-process
    two-shard reference; the 2-rank weights within DIST_RESNET_TOL of the
    reference's (of each tensor's largest magnitude), each rank's moving
    statistics equal to the reference's for its shard."""
    with tempfile.TemporaryDirectory() as tmp:
        out2, secs2 = _dist_job("dist_resnet", 2, [
            sys.executable, "chip_smoke.py", "--dist-rank", "resnet", tmp])
        out1, secs1 = _dist_job("dist_resnet", 1, [
            sys.executable, "chip_smoke.py", "--dist-rank", "resnet", tmp])
        two = _rank_lines(out2, 2, "RESNET")
        one = _rank_lines(out1, 1, "RESNET")[0]
        worst, bits = _resnet_compare(tmp, two)
        planes_held, planes_fp32 = _planes_compare(tmp, two, one)
    phase("dist_resnet", steps=DIST_RESNET_STEPS, batch_a_rank=RESNET_BATCH,
          worst_rel_err=worst, bit_equal=bits,
          hashes_equal_reference=two[0]["hashes"] ==
          one["reference_hashes"],
          two_ranks={k: v for k, v in two[0].items()
                     if k not in ("hashes", "planes")},
          two_ranks_job_s=secs2,
          one_rank={k: v for k, v in one.items()
                    if k not in ("hashes", "reference_hashes", "planes")},
          one_rank_job_s=secs1)
    p1, p2 = one["planes"], [t["planes"] for t in two]
    drop = ("hashes", "ts_hashes", "reference")
    import torch

    phase("dist_planes", card=CARD, torch=torch.__version__,
          nccl=".".join(map(str, torch.cuda.nccl.version())),
          steps=DIST_RESNET_STEPS,
          global_batch=2 * RESNET_BATCH, worst_scaled_err=planes_held,
          float32_scaled_err=planes_fp32,
          one_rank_nccl={k: v for k, v in p1.items() if k not in drop},
          single_process_plane=p1["reference"],
          two_ranks_gloo=[{k: v for k, v in p.items() if k not in drop}
                          for p in p2],
          eager_dist_sync_ms_a_step=one["step_ms"],
          phase_s=p1["seconds"] + p1["reference"]["seconds"] +
          max(p["seconds"] for p in p2))


def ring_prefill_serve():
    """The serve traffic at BENCH_DECODE width with prompts of at least
    RING_PREFILL_LEN tokens on the ring prefill route: every stream equals
    the oracle, no capture after warmup, every ring prompt took the eager
    prefill and skipped the prefix cache, and the prefix hits came from
    short prompts only."""
    import torch

    from mxnet_tpu_torch import serving

    model = serving.TinyDecoder(**MODEL)
    params = model.init_params(0)  # no device given: the card
    rng = np.random.RandomState(0)
    system = rng.randint(1, MODEL["vocab_size"], SYSTEM_LEN)
    reqs = []
    for i in range(N_REQ):
        p = rng.randint(1, MODEL["vocab_size"], int(rng.randint(4, 24)))
        if i % 3 == 1:
            p = np.concatenate([system, p])
        reqs.append((p.astype(np.int32), min(OUT_MIX[i % len(OUT_MIX)],
                                             OUT_CAP)))
    eng = serving.DecodeEngine(
        model, params, num_slots=SLOTS, max_seq_len=MAX_SEQ,
        page_size=PAGE, timeout_ms=0, name="chip_smoke_ring",
        prefill_buckets=(8, 16, 32, 64), prefix_cache=True,
        ring_prefill_len=RING_PREFILL_LEN)
    seen, ring_runs = [], [0]
    prefill, ring_prefill = eng._prefill, eng._run_ring_prefill

    def watch_prefill(req, slot):
        seen.append((int(req.prompt.size), req.match is not None and
                     req.match.matched > 0))
        return prefill(req, slot)

    def watch_ring(pre, length):
        ring_runs[0] += 1
        return ring_prefill(pre, length)

    eng._prefill, eng._run_ring_prefill = watch_prefill, watch_ring
    try:
        warm = eng.warmup()
        before = eng.stats()
        t0 = time.perf_counter()
        outs = [f.result(timeout=600)
                for f in [eng.submit(p, m) for p, m in reqs]]
        wall = time.perf_counter() - t0
        stats = eng.stats()
    finally:
        eng.close()
    graphs = _graph_fields("ring_prefill_serve", warm, before, stats)
    _check_oracle(model, params, reqs, outs, "ring_prefill_serve")
    long_n = sum(1 for p, _m in reqs if p.size >= RING_PREFILL_LEN)
    if long_n < 1 or long_n == len(reqs):
        fail("ring_prefill_serve: %d of %d prompts cross the ring length"
             % (long_n, len(reqs)))
    if ring_runs[0] != long_n:
        fail("ring_prefill_serve: %d ring prefills for %d long prompts"
             % (ring_runs[0], long_n))
    if any(hit for size, hit in seen if size >= RING_PREFILL_LEN):
        fail("ring_prefill_serve: a ring prompt matched the prefix cache")
    hits = sum(1 for _size, hit in seen if hit)
    if stats["kvcache"]["prefix_hits"] != hits:
        fail("ring_prefill_serve: %d prefix hits counted, %d seen"
             % (stats["kvcache"]["prefix_hits"], hits))
    tokens = int(sum(len(o) for o in outs))
    phase("ring_prefill_serve", requests=len(reqs), ring_prompts=long_n,
          ring_prefills=ring_runs[0], short_prefix_hits=hits, tokens=tokens,
          wall_s=wall, tokens_per_s=tokens / wall,
          ttft_p50_ms=stats["ttft_p50_ms"], outputs_equal_oracle=True,
          max_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30, **graphs)


def dist_phases():
    """The distributed slice's phases (no kernel of the five runs on
    these paths)."""
    import torch

    torch.cuda.empty_cache()  # the ranks share the card with this process
    dist_kvstore()
    dist_ring()
    dist_cifar()
    dist_resnet()
    ring_prefill_serve()


# -- the optimizer states sharded over the ranks, elastic training -------
# zero_resnet: dist_resnet's configuration (resnet50_v1, 224 x 224, 1000
# classes, batch 32 a rank, dist_sync on 2 ranks sharing the card,
# deterministic cuDNN, TF32 off, DIST_RESNET_STEPS steps on the same
# shards), each case at MXNET_ZERO=0 and at its level in the same job; the
# sharded run's weights and materialized states must equal the replicated
# run's bit for bit
ZERO_CASES = (
    ("sgd_zero1", "sgd", {"learning_rate": 0.05, "momentum": 0.9}, 1,
     None),
    ("adam_zero1", "adam", {"learning_rate": 0.001}, 1, None),
    ("sgd_bf16_zero2", "sgd", {"learning_rate": 0.05, "momentum": 0.9,
                               "multi_precision": True}, 2, "bfloat16"))
# zero_ckpt: the sharded save after ZERO_CKPT_STEPS steps of the SGD case;
# the preemption case trains PREEMPT_STEPS steps, the notice (a file only
# rank 0 watches) written after step PREEMPT_AT
ZERO_CKPT_STEPS, PREEMPT_STEPS, PREEMPT_AT = 2, 4, 1
# elastic_resume: trainplane.fit on one rank, ELASTIC_EPOCHS epochs of
# ELASTIC_BATCHES batches of 32, chaos kill at the ELASTIC_KILL_AT-th step
# boundary (entering the third step)
ELASTIC_EPOCHS, ELASTIC_BATCHES, ELASTIC_KILL_AT = 3, 2, 4
# zero_plane: TrainPlane across the zero job's 2 ranks (gloo, uncaptured)
# on dist_resnet's global batches (2 x 32 rows, SGD 0.05 momentum 0.9,
# deterministic cuDNN, TF32 off), ZERO_PLANE_STEPS steps at MXNET_ZERO 0
# (the replicated plane), 1 and 2. The sharded step is held to the
# replicated one in float64 (this net turns float32 rounding into
# percents of a tensor within a step, PR 27's R1-R2): each tensor within
# ZERO_PLANE_TOL of its largest magnitude (at least DIST_PLANES_FLOOR),
# the loss vectors alike; the float32 runs at levels 0 and 1 give the
# readings and their distance
ZERO_PLANE_STEPS, ZERO_PLANE_TOL = 3, 1e-9


def _zero_net(ctx, opt, params, cast, kvstore="dist_sync"):
    from mxnet_tpu_torch import gluon
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon.model_zoo import vision

    with ctx:
        mx.random.seed(0)
        net = vision.resnet50_v1(classes=RESNET_CLASSES)
        net.initialize(mx.initializer.Xavier(rnd_type="gaussian",
                                             factor_type="in", magnitude=2))
        net(mx.nd.zeros((1, 3, RESNET_SIDE, RESNET_SIDE)))
        if cast:
            net.cast(cast)
        trainer = gluon.Trainer(net.collect_params(), opt, dict(params),
                                kvstore=kvstore)
    return net, trainer


def _zero_step(net, trainer, step, r, n, ctx, loss_fn, cast):
    from mxnet_tpu_torch import autograd

    with ctx:
        x, y = _resnet_shard(step, r, ctx)
        if cast:
            x = x.astype(cast)
        with autograd.record():
            loss = loss_fn(net(x), y)
        loss.backward()
        trainer.step(RESNET_BATCH * n)


def _digest(tensors):
    """sha256 of the tensors' bytes, in order (bfloat16 as its bits)."""
    import torch

    h = hashlib.sha256()
    for t in tensors:
        t = t.detach()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        h.update(t.cpu().numpy().tobytes())
    return h.hexdigest()


def _bits_equal(xs, ys):
    """Whether two tensor lists are equal bit for bit (a NaN equals
    itself)."""
    import torch

    ints = {2: torch.int16, 4: torch.int32, 8: torch.int64}
    return len(xs) == len(ys) and all(
        a.dtype == b.dtype and a.shape == b.shape and torch.equal(
            a.view(ints[a.element_size()]), b.view(ints[b.element_size()]))
        for a, b in zip(xs, ys))


def _states_of(trainer):
    from mxnet_tpu_torch.optimizer import _state_leaves

    states = trainer._updater.states
    return [t for i in sorted(states) for t in _state_leaves(states[i])]


def _zero_counts():
    from mxnet_tpu_torch.fastpath import zero

    return (sum(s["value"] for s in zero.FALLBACKS.series()),
            zero.MATERIALIZATIONS.value())


def _zero_case(grp, ctx, loss_fn, opt, params, level, cast):
    """One run of DIST_RESNET_STEPS steps at MXNET_ZERO=level: at a level
    above 0 a weight hash after every step, and the readings (the last
    step's all-gather timed by itself); returns (readings, weights,
    materialized states)."""
    import torch

    from mxnet_tpu_torch import _dist
    from mxnet_tpu_torch.fastpath import zero

    r, n, dev = grp.rank, grp.world, grp.device
    os.environ["MXNET_ZERO"] = str(level)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    net, tr = _zero_net(ctx, opt, params, cast)
    f0, m0 = _zero_counts()
    staged0 = grp.staged_bytes
    gather0 = _dist.STAGED_BYTES.value(op="all_gather")
    hashes, step_ms, gather_ms = [], [], []
    for step in range(DIST_RESNET_STEPS):
        plane = zero.plane_of(tr._updater)
        if level and step == DIST_RESNET_STEPS - 1:
            inner = plane.gather_weights

            def timed(weights, inner=inner):
                torch.cuda.synchronize(dev)
                t = time.perf_counter()
                inner(weights)
                torch.cuda.synchronize(dev)
                gather_ms.append((time.perf_counter() - t) * 1e3)

            plane.gather_weights = timed
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        _zero_step(net, tr, step, r, n, ctx, loss_fn, cast)
        torch.cuda.synchronize(dev)
        if 0 < step < DIST_RESNET_STEPS - 1:
            step_ms.append((time.perf_counter() - t0) * 1e3)
        if level:
            hashes.append(_digest([p.data()._data
                                   for _k, p in _trainable(net)]))
    upd = tr._updater
    plane = zero.plane_of(upd)
    if level and (plane is None or plane.dp != n or plane.level != level):
        fail("zero_resnet: MXNET_ZERO=%d ran no plane over %d ranks"
             % (level, n))
    reading = dict(
        step_ms=float(np.mean(step_ms)),
        state_bytes=zero.state_bytes_on(dev, upd),
        max_memory_allocated=torch.cuda.max_memory_allocated(dev),
        staged_bytes=grp.staged_bytes - staged0,
        hashes=hashes)
    if level:
        reading.update(
            gather_ms=gather_ms[0], gather_bytes=plane.gather_bytes(),
            gather_staged_bytes=_dist.STAGED_BYTES.value(op="all_gather")
            - gather0,
            padded_elements=sum(
                plane.plan.bucket_layout(b)[1] -
                sum(plane.plan.bucket_layout(b)[0])
                for b in range(len(plane.plan.buckets))))
        zero.materialize_updater(upd)
    f1, m1 = _zero_counts()
    reading["fallbacks"], reading["materializations"] = f1 - f0, m1 - m0
    if f1 != f0:
        fail("zero_resnet: %d ZeRO fallbacks at MXNET_ZERO=%d"
             % (f1 - f0, level))
    if m1 - m0 != (1 if level else 0):
        fail("zero_resnet: %d materializations at MXNET_ZERO=%d (the "
             "phase's own: %d)" % (m1 - m0, level, 1 if level else 0))
    weights = [p.data()._data.detach().clone() for _k, p in _trainable(net)]
    states = [t.detach().clone() for t in _states_of(tr)]
    del net, tr
    os.environ.pop("MXNET_ZERO")
    return reading, weights, states


def _zero_plane_run(grp, ctx, loss_fn, level, dtype):
    """zero_plane's run of TrainPlane at MXNET_ZERO=level in ``dtype``:
    its readings (from the second step on) and its weights, moving
    statistics and loss vectors."""
    import torch

    from mxnet_tpu_torch import trainplane
    from mxnet_tpu_torch.fastpath import zero

    dev = grp.device
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    os.environ["MXNET_ZERO"] = str(level)
    try:
        net, trainer = _resnet_net(ctx, None)
        with ctx:
            if dtype != "float32":
                net.cast(dtype)
            plane = trainplane.TrainPlane(net, loss_fn, trainer)
            f0 = _zero_counts()[0]
            losses, ms, staged = [], [], 0
            for step in range(ZERO_PLANE_STEPS):
                x, y = _resnet_shard(step, 0, ctx, rows=slice(None),
                                     dtype=dtype)
                before = grp.staged_bytes
                torch.cuda.synchronize(dev)
                t0 = time.perf_counter()
                losses.append(plane.step(x, y).asnumpy())
                torch.cuda.synchronize(dev)
                if step:  # the first step runs its first pass too
                    ms.append((time.perf_counter() - t0) * 1e3)
                    staged = grp.staged_bytes - before
        upd = trainer._updater
        zp = zero.plane_of(upd)
        reading = dict(
            level=level, dtype=dtype, plane=plane.plane,
            uncaptured_reason=plane.uncaptured_reason,
            sharded=zp is not None and all(
                zero.is_sharded(st) for st in upd.states.values()),
            buckets=len(zp.plan.buckets) if zp is not None else 0,
            ms_a_step=float(np.mean(ms)),
            collectives_a_step=plane.collectives_a_step,
            staged_bytes_a_step=staged,
            state_bytes=zero.state_bytes_on(dev, upd),
            peak_bytes=torch.cuda.max_memory_allocated(dev),
            fallbacks=_zero_counts()[0] - f0,
            hash=_sha(net))
        arrays = dict(_resnet_arrays(net), losses=np.stack(losses))
        if zp is not None:
            zero.materialize_updater(upd)
    finally:
        os.environ.pop("MXNET_ZERO")
    del plane, net, trainer
    gc.collect()
    torch.cuda.empty_cache()
    return reading, arrays


def _rank_zero_plane(grp, ctx, loss_fn):
    """A rank's zero_plane: the float64 runs at MXNET_ZERO 0, 1 and 2 (the
    sharded against the replicated: fails the rank past ZERO_PLANE_TOL),
    then the float32 runs at 0 and 1 (readings, and their distance)."""
    runs, errs = {}, {}
    ref = None
    for dtype, levels in (("float64", (0, 1, 2)), ("float32", (0, 1))):
        for level in levels:
            reading, arrays = _zero_plane_run(grp, ctx, loss_fn, level,
                                              dtype)
            if level == 0:
                ref = arrays
            else:
                if sorted(arrays) != sorted(ref):
                    fail("zero_plane: MXNET_ZERO=%d %s gave other arrays"
                         % (level, dtype))
                err = max(_scaled_err(arrays[k], ref[k]) for k in arrays)
                reading["bit_equal_replicated"] = all(
                    np.array_equal(arrays[k], ref[k]) for k in arrays)
                reading["max_scaled_err"] = err
                errs["%s_zero%d" % (dtype, level)] = err
                if not reading["sharded"] or reading["fallbacks"]:
                    fail("zero_plane: MXNET_ZERO=%d %s ran %s (%d fallbacks)"
                         % (level, dtype, "sharded" if reading["sharded"]
                            else "replicated", reading["fallbacks"]))
                if dtype == "float64" and not err <= ZERO_PLANE_TOL:
                    fail("zero_plane: MXNET_ZERO=%d float64 stands %.3g "
                         "from the replicated plane (tol %g)"
                         % (level, err, ZERO_PLANE_TOL))
            runs["%s_zero%d" % (dtype, level)] = reading
    return dict(runs=runs, errs=errs)


def _rank_zero(out_dir):
    """A rank of the zero job: zero_resnet's three cases, zero_ckpt's
    saves and restores, the preemption case's uninterrupted and
    preempted runs, and zero_plane's runs. Prints ``rank <r>: ZERO
    {json}``; fails the rank on a mismatch."""
    import torch

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import _dist, gluon

    torch.backends.cudnn.deterministic = True
    grp = _dist.group()
    ctx = mx.current_context()
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    cases = {}
    for name, opt, params, level, cast in ZERO_CASES:
        rep, w0, s0 = _zero_case(grp, ctx, loss_fn, opt, params, 0, cast)
        got, w1, s1 = _zero_case(grp, ctx, loss_fn, opt, params, level, cast)
        if len(s0) != len(s1) or not _bits_equal(w0 + s0, w1 + s1):
            fail("zero_resnet %s: MXNET_ZERO=%d differs from MXNET_ZERO=0"
                 % (name, level))
        del w0, s0, w1, s1
        cases[name] = dict(level=level, replicated=rep, sharded=got)
    res = dict(backend=grp.backend, world=grp.world, cases=cases,
               ckpt=_rank_zero_ckpt(grp, ctx, loss_fn, out_dir),
               preempt=_rank_preempt(grp, ctx, loss_fn, out_dir),
               plane=_rank_zero_plane(grp, ctx, loss_fn))
    print("rank %d: ZERO %s" % (grp.rank, json.dumps(res)), flush=True)


def _rank_zero_ckpt(grp, ctx, loss_fn, out_dir):
    """The sharded save of the SGD case after ZERO_CKPT_STEPS steps (sync,
    then async), the 2-rank restore, and torn-write then drop-shard saves
    of the newest epoch, each restore falling back to epoch 1."""
    import torch

    from mxnet_tpu_torch import elastic, telemetry
    from mxnet_tpu_torch.fastpath import zero
    from mxnet_tpu_torch.resilience import chaos

    r, n, dev = grp.rank, grp.world, grp.device
    _name, opt, params, _lv, _cast = ZERO_CASES[0]
    os.environ["MXNET_ZERO"] = "1"
    torch.cuda.empty_cache()
    net, tr = _zero_net(ctx, opt, params, None)
    for step in range(ZERO_CKPT_STEPS):
        _zero_step(net, tr, step, r, n, ctx, loss_fn, None)
    d = os.path.join(out_dir, "ckpt")
    cm = elastic.CheckpointManager(d, max_keep=0)
    m0 = zero.MATERIALIZATIONS.value()
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    with ctx:
        cm.save_training(0, net=net, trainer=tr)
    sync_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    with ctx:
        cm.save_training(1, net=net, trainer=tr, async_save=True)
    async_ms = (time.perf_counter() - t0) * 1e3
    cm.wait()
    async_total_ms = (time.perf_counter() - t0) * 1e3
    if zero.MATERIALIZATIONS.value() != m0:
        fail("zero_ckpt: the sharded save materialized the states")
    manifest = json.load(open(cm._manifest_path(1)))
    shard_files = sorted(s["file"] for s in manifest["shards"])
    if shard_files != ["ckpt-0001.shard%d-of-%d" % (i, n)
                       for i in range(n)] or not all(
            os.path.isfile(os.path.join(d, f)) for f in shard_files):
        fail("zero_ckpt: shard files %s" % shard_files)
    shard_bytes = os.path.getsize(cm._shard_path(1, r, n))
    zero.materialize_updater(tr._updater)
    want = _digest(_states_of(tr))
    net2, tr2 = _zero_net(ctx, opt, params, None)
    t0 = time.perf_counter()
    with ctx:
        epoch = cm.restore_training(net=net2, trainer=tr2)
    restore_ms = (time.perf_counter() - t0) * 1e3
    if epoch != 1 or _digest(_states_of(tr2)) != want:
        fail("zero_ckpt: the 2-rank restore (epoch %d) differs" % epoch)
    falls = {}
    _zero_step(net, tr, ZERO_CKPT_STEPS, r, n, ctx, loss_fn, None)
    for e, action in ((2, "torn-write"), (3, "drop-shard")):
        with ctx, chaos.active("site=ckpt.shard,at=1,action=%s" % action):
            cm.save_training(e, net=net, trainer=tr)
        c0 = telemetry.CKPT_CORRUPTION.value()
        with ctx:
            got = cm.restore_training(net=net2, trainer=tr2)
        falls[action] = dict(restored=got, latest=cm.latest_epoch(),
                             corruption=telemetry.CKPT_CORRUPTION.value()
                             - c0)
        if got != 1 or falls[action]["corruption"] < 1 or \
                _digest(_states_of(tr2)) != want:
            fail("zero_ckpt: %s of epoch %d restored epoch %d (%s)"
                 % (action, e, got, falls[action]))
    os.environ.pop("MXNET_ZERO")
    del net, tr, net2, tr2
    return dict(dir=d, states_sha256=want, save_sync_ms=sync_ms,
                save_async_caller_ms=async_ms,
                save_async_total_ms=async_total_ms, restore_ms=restore_ms,
                shard_bytes=shard_bytes, materializations_in_save=0,
                fallbacks=falls)


def _preempt_train_fn(grp, ctx, loss_fn, flag=None):
    """PREEMPT_STEPS steps of the SGD case at MXNET_ZERO=1 from the newest
    committed step of the manager; with ``flag``, rank 0 writes the
    preemption notice after step PREEMPT_AT. Returns the final digests."""
    from mxnet_tpu_torch import elastic
    from mxnet_tpu_torch.fastpath import zero

    r, n = grp.rank, grp.world
    _name, opt, params, _lv, _cast = ZERO_CASES[0]

    def train_fn(start_epoch, manager):
        net, tr = _zero_net(ctx, opt, params, None)
        with ctx:
            manager.restore_training(net=net, trainer=tr)
        extra = manager.last_restored_extra or {}
        first = extra.get("step", -1) + 1
        for step in range(first, PREEMPT_STEPS):
            def save(s=step - 1):
                with ctx:
                    manager.save_training(s, net=net, trainer=tr,
                                          extra={"step": s})

            elastic.step_boundary(manager=manager, save_fn=save)
            _zero_step(net, tr, step, r, n, ctx, loss_fn, None)
            if flag and r == 0 and step == PREEMPT_AT:
                open(flag, "w").close()
        zero.materialize_updater(tr._updater)
        aux = [p.data()._data for _k, p in _aux(net)]
        return dict(weights=_digest([p.data()._data
                                     for _k, p in _trainable(net)]),
                    states=_digest(_states_of(tr)), aux=_digest(aux),
                    num_update=tr._optimizer.num_update)

    return train_fn


def _rank_preempt(grp, ctx, loss_fn, out_dir):
    """The uninterrupted run, then the run whose notice reaches rank 0
    only: every rank must commit the same step and raise Preempted."""
    from mxnet_tpu_torch import elastic

    os.environ["MXNET_ZERO"] = "1"
    ref = elastic.run_elastic(
        _preempt_train_fn(grp, ctx, loss_fn),
        elastic.CheckpointManager(os.path.join(out_dir, "preempt_ref")),
        max_restarts=0, restart_delay=0)
    d = os.path.join(out_dir, "preempt")
    cm = elastic.CheckpointManager(d)
    flag = os.path.join(out_dir, "evict-notice")
    if grp.rank == 0:
        os.environ["MXNET_PREEMPTION_FILE"] = flag
    try:
        elastic.run_elastic(_preempt_train_fn(grp, ctx, loss_fn, flag), cm,
                            max_restarts=0, restart_delay=0)
        fail("preempt: the run finished without the notice")
    except elastic.Preempted:
        pass
    os.environ.pop("MXNET_PREEMPTION_FILE", None)
    os.environ.pop("MXNET_ZERO")
    elastic.clear_preemption()
    grp.barrier()
    if grp.rank == 0:
        os.remove(flag)
    return dict(ref=ref, dir=d, committed=cm.latest_epoch())


def _rank_resume(ckpt_dir):
    """A rank of the resume job: the preempted run of the zero job
    resumed from its committed step to PREEMPT_STEPS."""
    import torch

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import _dist, elastic, gluon

    torch.backends.cudnn.deterministic = True
    grp = _dist.group()
    os.environ["MXNET_ZERO"] = "1"
    cm = elastic.CheckpointManager(ckpt_dir)
    start = cm.latest_epoch()
    got = elastic.run_elastic(
        _preempt_train_fn(grp, mx.current_context(),
                          gluon.loss.SoftmaxCrossEntropyLoss()),
        cm, max_restarts=0, restart_delay=0)
    got["resumed_after"] = start
    print("rank %d: RESUME %s" % (grp.rank, json.dumps(got)), flush=True)


def zero_resnet(ranks, secs):
    """The zero job's cases: the ranks hash alike after every step, the
    readings of both levels, and each rank's states at most the replicated
    figure over the ranks plus the padding."""
    cases = {}
    for name, _opt, _p, level, cast in ZERO_CASES:
        per = [rk["cases"][name] for rk in ranks]
        if per[0]["sharded"]["hashes"] != per[1]["sharded"]["hashes"] or \
                len(per[0]["sharded"]["hashes"]) != DIST_RESNET_STEPS:
            fail("zero_resnet %s: the ranks' weights differ" % name)
        for rk in per:
            # every state slot of the three cases is float32, at most two
            # a bucket; the padding is under one element a rank a bucket
            rep, sh = rk["replicated"]["state_bytes"], \
                rk["sharded"]["state_bytes"]
            bound = rep / len(ranks) + rk["sharded"]["padded_elements"] * 8
            if sh > bound:
                fail("zero_resnet %s: %d state bytes a rank against %d "
                     "replicated" % (name, sh, rep))
        cases[name] = dict(
            level=level, dtype=cast or "float32",
            bit_equal_to_replicated=True, hashes_equal_across_ranks=True,
            **{"rank%d" % i: {lv: {k: v for k, v in rk[lv].items()
                                   if k != "hashes"}
                              for lv in ("replicated", "sharded")}
               for i, rk in enumerate(per)})
    phase("zero_resnet", steps=DIST_RESNET_STEPS, batch_a_rank=RESNET_BATCH,
          ranks=len(ranks), backend=ranks[0]["backend"], job_s=secs,
          card=CARD, cases=cases)


def zero_ckpt(ranks, secs):
    """The zero job's sharded checkpoint: the save moved no
    materialization, each rank's restore and fallbacks passed (checked in
    the ranks), and a restore in this process (one rank, no plane) gives
    the materialized states' digest."""
    import torch

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import elastic

    ck = [rk["ckpt"] for rk in ranks]
    if ck[0]["states_sha256"] != ck[1]["states_sha256"]:
        fail("zero_ckpt: the ranks' materialized states differ")
    _name, opt, params, _lv, _cast = ZERO_CASES[0]
    ctx = mx.current_context()
    net, tr = _zero_net(ctx, opt, params, None, kvstore="device")
    cm = elastic.CheckpointManager(ck[0]["dir"], max_keep=0)
    t0 = time.perf_counter()
    with ctx:
        epoch = cm.restore_training(net=net, trainer=tr)
    one_ms = (time.perf_counter() - t0) * 1e3
    if epoch != 1 or _digest(_states_of(tr)) != ck[0]["states_sha256"]:
        fail("zero_ckpt: the 1-rank restore (epoch %d) differs" % epoch)
    del net, tr
    torch.cuda.empty_cache()
    phase("zero_ckpt", ranks=len(ranks), job_s=secs, card=CARD,
          one_rank_restore_ms=one_ms, one_rank_restore_equal=True,
          two_rank_restore_equal=True,
          **{"rank%d" % i: {k: v for k, v in c.items() if k != "dir"}
             for i, c in enumerate(ck)})


def zero_plane(ranks, secs):
    """zero_plane's checks across the ranks (each rank held its sharded
    runs to its replicated ones): the ranks' weights equal in every run;
    the sharded float32 run's state bytes a rank at most half the
    replicated plus the padding. Prints each run's readings beside the
    card's name and power limit."""
    per = [rk["plane"] for rk in ranks]
    for key in per[0]["runs"]:
        if per[0]["runs"][key]["hash"] != per[1]["runs"][key]["hash"]:
            fail("zero_plane %s: the ranks' weights differ" % key)
    for rk in per:
        rep = rk["runs"]["float32_zero0"]["state_bytes"]
        sh = rk["runs"]["float32_zero1"]["state_bytes"]
        # a bucket's padding is under one element a rank, two slots a
        # bucket (the momentum: one)
        if sh > rep / len(ranks) + 8 * rk["runs"]["float32_zero1"][
                "buckets"]:
            fail("zero_plane: %d state bytes a rank against %d replicated"
                 % (sh, rep))
    phase("zero_plane", net="resnet50_v1 224x224, 1000 classes",
          steps=ZERO_PLANE_STEPS, batch_a_rank=RESNET_BATCH,
          ranks=len(ranks), backend=ranks[0]["backend"], job_s=secs,
          card=CARD, tol_float64=ZERO_PLANE_TOL,
          **{"rank%d" % i: {k: {f: v for f, v in r.items() if f != "hash"}
                            for k, r in rk["runs"].items()}
             for i, rk in enumerate(per)},
          float32_distance={k: max(rk["errs"][k] for rk in per)
                            for k in per[0]["errs"]})


def _fit_run(ckpt_dir, kill):
    """trainplane.fit(checkpoint=) of resnet50_v1 at batch 32 on this
    process under run_elastic; with ``kill``, chaos kill at the
    ELASTIC_KILL_AT-th step boundary. Returns the final digests, each
    attempt's steps and captures (``mxnet_recompiles_total`` of the
    plane's site) and the restarts."""
    import torch

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import elastic, gluon, telemetry, trainplane
    from mxnet_tpu_torch.resilience import chaos

    ctx = mx.current_context()
    n = ELASTIC_BATCHES * RESNET_BATCH
    rs = np.random.RandomState(7)
    xs = rs.rand(n, 3, RESNET_SIDE, RESNET_SIDE).astype(np.float32)
    ys = rs.randint(0, RESNET_CLASSES, n).astype(np.float32)
    cm = elastic.CheckpointManager(ckpt_dir)
    site = trainplane.TrainPlane._site
    attempts, final = [], {}

    def train_fn(start_epoch, manager):
        net, tr = _zero_net(ctx, "sgd", DIST_RESNET_SGD, None,
                            kvstore="device")
        with ctx:
            it = mx.io.NDArrayIter(xs, ys, batch_size=RESNET_BATCH)
        steps = []
        c0 = telemetry.RECOMPILES.value(site=site)
        try:
            with ctx:
                plane = trainplane.fit(
                    net, gluon.loss.SoftmaxCrossEntropyLoss(), tr, it,
                    epochs=ELASTIC_EPOCHS, checkpoint=manager,
                    batch_end_callback=lambda *a: steps.append(1))
        finally:
            attempts.append(dict(
                start_epoch=start_epoch, steps=len(steps),
                captures=telemetry.RECOMPILES.value(site=site) - c0))
        attempts[-1]["plane"] = plane.plane
        final.update(net=net, tr=tr, it=it)
        return "done"

    r0 = telemetry.ELASTIC_RESTARTS.value(reason="exception")
    t0 = time.perf_counter()
    if kill:
        with chaos.active("site=elastic.step,at=%d,action=kill"
                          % ELASTIC_KILL_AT):
            elastic.run_elastic(train_fn, cm, max_restarts=2,
                                restart_delay=0)
    else:
        elastic.run_elastic(train_fn, cm, max_restarts=0, restart_delay=0)
    wall = time.perf_counter() - t0
    net, tr, it = final["net"], final["tr"], final["it"]
    got = dict(weights=_digest([p.data()._data for _k, p in _trainable(net)]),
               aux=_digest([p.data()._data for _k, p in _aux(net)]),
               states=_digest(_states_of(tr)), cursor=int(it.cursor),
               num_update=tr._optimizer.num_update,
               counts=sorted(tr._optimizer._index_update_count.items()),
               restarts=telemetry.ELASTIC_RESTARTS.value(
                   reason="exception") - r0,
               goodput=telemetry.ELASTIC_GOODPUT.value(),
               attempts=attempts, latest=cm.latest_epoch(), wall_s=wall)
    del net, tr, final
    torch.cuda.empty_cache()
    return got


def elastic_resume(tmp):
    """fit(checkpoint=) on one rank: killed at a step boundary and resumed
    by run_elastic, bit for bit against the uninterrupted run (weights,
    moving statistics, states, cursor, counters), one restart, the goodput
    gauge set, one capture an attempt; then the preemption case's resume
    job against its uninterrupted run."""
    import torch

    old = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        ref = _fit_run(os.path.join(tmp, "fit_ref"), kill=False)
        got = _fit_run(os.path.join(tmp, "fit_kill"), kill=True)
    finally:
        torch.backends.cudnn.deterministic = old
    for k in ("weights", "aux", "states", "cursor", "num_update", "counts",
              "latest"):
        if got[k] != ref[k]:
            fail("elastic_resume: %s differs after the resume (%s, %s)"
                 % (k, got[k], ref[k]))
    if ref["restarts"] != 0 or got["restarts"] != 1:
        fail("elastic_resume: %d restarts (1 expected)" % got["restarts"])
    if not 0.0 < got["goodput"] <= 1.0:
        fail("elastic_resume: goodput gauge %r" % got["goodput"])
    tries = got["attempts"] + ref["attempts"]
    if len(tries) != 3 or any(a["captures"] != 1 for a in tries) or \
            any(a.get("plane", "graph") != "graph" for a in tries):
        fail("elastic_resume: one capture an attempt on the graph plane "
             "expected: %s" % tries)
    return ref, got


def _preempted(zero_ranks):
    """The zero job's preempted run: both ranks committed step
    PREEMPT_AT; returns each rank's readings."""
    pre = [rk["preempt"] for rk in zero_ranks]
    if pre[0]["committed"] != pre[1]["committed"] or \
            pre[0]["committed"] != PREEMPT_AT:
        fail("preempt: the ranks committed steps %s (%d expected)"
             % ([p["committed"] for p in pre], PREEMPT_AT))
    return pre


def elastic_preempt_resume(pre, job):
    """The zero job's preempted run resumed by a new 2-rank job (``job``,
    started on ``pre[0]["dir"]``), against the uninterrupted run of the
    zero job (trainable weights, states and counters on both ranks; rank
    0's moving statistics, which the checkpoint holds)."""
    out, secs = _dist_wait("elastic_resume", 2, job)
    resumed = _rank_lines(out, 2, "RESUME")
    for r, (got, p) in enumerate(zip(resumed, pre)):
        keys = ("weights", "states", "num_update") + (("aux",) if r == 0
                                                      else ())
        for k in keys:
            if got[k] != p["ref"][k]:
                fail("preempt: rank %d's %s differs after the resume"
                     % (r, k))
        if got["resumed_after"] != PREEMPT_AT:
            fail("preempt: rank %d resumed after step %d" % (
                r, got["resumed_after"]))
    return dict(committed_step=pre[0]["committed"], resume_job_s=secs,
                bit_equal=True)


def elastic_kill(job):
    """The nightly kill script on 3 ranks sharing the card (``job``): rank
    2 dies, every survivor detects it and resumes through run_elastic."""
    out, secs = _dist_wait("elastic_kill", 3, job)
    want = ["rank 2: DYING_NOW"] + [
        "rank %d: %s" % (r, m) for r in (0, 1)
        for m in ("DEAD_NODE_DETECTED", "ELASTIC_RESUME_OK")]
    missing = [m for m in want if m not in out]
    if missing:
        print(out[-4000:], flush=True)
        fail("elastic_kill: no %s" % missing)
    phase("elastic_kill", ranks=3, job_s=secs, markers=len(want),
          backend=_expected_backend(3), card=CARD)


def zero_job(tmp):
    """The zero job (2 ranks): zero_resnet, zero_ckpt and zero_plane;
    returns the preempted run's readings."""
    out, secs = _dist_job("zero_resnet", 2, [
        sys.executable, "chip_smoke.py", "--dist-rank", "zero", tmp])
    ranks = _rank_lines(out, 2, "ZERO")
    zero_resnet(ranks, secs)
    zero_ckpt(ranks, secs)
    zero_plane(ranks, secs)
    return _preempted(ranks)


def elastic_phases():
    """The sharded-state and elastic slice's phases (no kernel of the
    five runs on these paths): one 2-rank job for zero_resnet, zero_ckpt,
    zero_plane and the preempted run; then the resume job and the 3-rank
    kill job run beside fit under run_elastic in this process (the
    script's time limit: a job spends 13-22 s starting)."""
    import torch

    torch.cuda.empty_cache()  # the ranks share the card with this process
    with tempfile.TemporaryDirectory() as tmp:
        pre = zero_job(tmp)
        resume_job = _dist_start(2, [
            sys.executable, "chip_smoke.py", "--dist-rank", "resume",
            pre[0]["dir"]])
        kill_job = _dist_start(3, [
            sys.executable, os.path.join("tests", "nightly",
                                         "torch_dist_elastic_kill.py")])
        try:
            ref, got = elastic_resume(tmp)
            preempt = elastic_preempt_resume(pre, resume_job)
            phase("elastic_resume", batch=RESNET_BATCH,
                  epochs=ELASTIC_EPOCHS, batches_an_epoch=ELASTIC_BATCHES,
                  kill_at_boundary=ELASTIC_KILL_AT, bit_equal=True,
                  restarts=got["restarts"], goodput=got["goodput"],
                  attempts=got["attempts"], steady_state_recompiles=0,
                  killed_wall_s=got["wall_s"],
                  uninterrupted_wall_s=ref["wall_s"], preempt=preempt,
                  card=CARD)
            elastic_kill(kill_job)
        finally:  # a failed check stops the jobs it left running
            _dist_stop(resume_job)
            _dist_stop(kill_job)


# -- several contexts in one process (slice 28) -------------------------------
# multi_context: the card beside the host, the one layout of several
# contexts a one-card machine has. train_mnist.py's mlp (784-128-64-10,
# batch 64, SGD 0.05 momentum 0.9 wd 1e-4) on MC_MNIST_EXAMPLES synthetic
# examples through Module(context=[gpu(0), cpu(0)]) (a local store,
# update_on_kvstore) against Module(context=gpu(0)); the gluon Trainer
# over [gpu(0), cpu(0)] (kvstore="device") on the same net against one
# context, MC_TRAINER_STEPS steps; matrix_factorization.py at its
# defaults (embed_user on the host, embed_item on the card) against both
# groups on the card. Each pair sums its batch slices in another order,
# so they are held within MC_TOL of each tensor's largest magnitude (the
# losses and rmse relatively), not bit for bit.
MC_MNIST_EXAMPLES, MC_TRAINER_STEPS, MC_TOL = 6400, 20, 1e-3


def _cross_bytes():
    from mxnet_tpu_torch.telemetry import registry

    m = registry.REGISTRY.get("mxnet_cross_device_bytes_total")
    return sum(s["value"] for s in m.series()) if m is not None else 0


def _mc_close(what, got, want):
    err = max(float(np.abs(np.asarray(g) - np.asarray(w)).max()) /
              max(float(np.abs(np.asarray(w)).max()), 1e-6)
              for g, w in zip(got, want))
    if len(got) != len(want) or not err <= MC_TOL:
        fail("multi_context %s: %.3g of the largest magnitude from the "
             "one-context run (tol %g)" % (what, err, MC_TOL))
    return err


def _mc_module(contexts):
    """train_mnist.py's mlp through Module over ``contexts``: the running
    cross-entropy after every batch, the weights, ms a step and the bytes
    copied between the card and the host a step."""
    import torch

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.example.image_classification import train_mnist

    args = train_mnist.parse_args(["--num-examples",
                                   str(MC_MNIST_EXAMPLES)])
    losses = []
    with mx.gpu(0):
        mx.random.seed(0)
        train, _val = train_mnist.get_mnist_iter(args, None)
        mod = mx.mod.Module(train_mnist.get_symbol(args), context=contexts)
        cross = _cross_bytes()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mod.fit(train, eval_metric="ce", kvstore="local", optimizer="sgd",
                optimizer_params={"learning_rate": 0.05, "wd": 1e-4,
                                  "momentum": 0.9},
                initializer=mx.initializer.Xavier(
                    rnd_type="gaussian", factor_type="in", magnitude=2),
                batch_end_callback=[lambda p: losses.append(
                    float(p.eval_metric.get()[1]))], num_epoch=1)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        args_, _aux = mod.get_params()
        weights = [args_[k].asnumpy() for k in sorted(args_)]
        train.reset()
        top = _mc_host_top(mod, next(iter(train))) if len(contexts) > 1 \
            else None
    steps = len(losses)
    return dict(losses=losses, weights=weights, steps=steps, host_top=top,
                ms_a_step=secs / steps * 1e3,
                cross_bytes_a_step=(_cross_bytes() - cross) / steps,
                executors=len(mod._exec_group.execs),
                store=type(mod._kvstore).__name__)


def _mc_host_top(mod, batch, steps=5):
    """The host's costliest operations (self CPU ms a step) over ``steps``
    more forward, backward and update steps of ``mod``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            mod.forward_backward(batch)
            mod.update()
        torch.cuda.synchronize()
    rows = sorted(prof.key_averages(), key=lambda e: e.self_cpu_time_total,
                  reverse=True)[:6]
    return [[e.key, e.count // steps, e.self_cpu_time_total / steps / 1e3]
            for e in rows]


def _mc_trainer(contexts):
    """The same mlp in gluon over ``contexts`` (split_and_load, a
    ``device`` store), MC_TRAINER_STEPS steps on the synthetic set's
    first batches: the weights of every context's copy, ms a step, bytes
    across the card/host edge a step."""
    import torch

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd, gluon
    from mxnet_tpu_torch.example.image_classification import train_mnist
    from mxnet_tpu_torch.gluon.utils import split_and_load

    x, y = train_mnist._synthetic_mnist(64 * MC_TRAINER_STEPS, seed=7)
    x = x.reshape(len(x), -1)
    with mx.gpu(0):
        mx.random.seed(0)
        net = gluon.nn.HybridSequential()
        net.add(gluon.nn.Dense(128, activation="relu"),
                gluon.nn.Dense(64, activation="relu"), gluon.nn.Dense(10))
        net.initialize(mx.initializer.Xavier(rnd_type="gaussian",
                                             factor_type="in", magnitude=2),
                       ctx=contexts)
        with autograd.pause():
            net(mx.nd.array(x[:2]))
        tr = gluon.Trainer(net.collect_params(), "sgd",
                           {"learning_rate": 0.05, "momentum": 0.9},
                           kvstore="device")
        loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
        cross, ms = _cross_bytes(), []
        for step in range(MC_TRAINER_STEPS):
            rows = slice(64 * step, 64 * (step + 1))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            data = split_and_load(mx.nd.array(x[rows]), contexts)
            label = split_and_load(mx.nd.array(y[rows]), contexts)
            with autograd.record():
                losses = [loss_fn(net(d), lab) for d, lab in zip(data,
                                                                  label)]
            for loss in losses:
                loss.backward()
            tr.step(64)
            torch.cuda.synchronize()
            if step:
                ms.append((time.perf_counter() - t0) * 1e3)
        copies = [[d.asnumpy() for d in p.list_data()]
                  for p in net.collect_params().values()]
    return dict(copies=copies, ms_a_step=float(np.mean(ms)),
                cross_bytes_a_step=(_cross_bytes() - cross) /
                MC_TRAINER_STEPS,
                store=type(tr._kvstore).__name__ if tr._kvstore else None)


def _mc_factorization(argv):
    import torch

    from mxnet_tpu_torch.example.model_parallel import matrix_factorization

    args = matrix_factorization.parse_args(argv)
    cross = _cross_bytes()
    res = matrix_factorization.run(args)
    torch.cuda.synchronize()
    return dict(rmse=res["rmse"], improved=res["improved"],
                ms_a_step=res["seconds"] / res["steps"] * 1e3,
                cross_bytes_a_step=(_cross_bytes() - cross) / res["steps"],
                group2ctx={k: str(v) for k, v in
                           matrix_factorization.group2ctx(args).items()})


def multi_context():
    """Several contexts in one process on the card and the host: Module,
    gluon Trainer and group2ctx (matrix_factorization.py), each against
    its one-device run (see MC_TOL's note)."""
    import mxnet_tpu_torch as mx

    mix = [mx.gpu(0), mx.cpu(0)]
    mod2, mod1 = _mc_module(mix), _mc_module([mx.gpu(0)])
    if mod2["executors"] != 2 or mod2["cross_bytes_a_step"] <= 0:
        fail("multi_context module: %d executors, %s card/host bytes a "
             "step" % (mod2["executors"], mod2["cross_bytes_a_step"]))
    mod_err = dict(losses=_mc_close("module losses", [mod2["losses"]],
                                    [mod1["losses"]]),
                   weights=_mc_close("module weights", mod2["weights"],
                                     mod1["weights"]))
    tr2, tr1 = _mc_trainer(mix), _mc_trainer([mx.gpu(0)])
    tr_err = _mc_close("trainer weights", [c[0] for c in tr2["copies"]],
                       [c[0] for c in tr1["copies"]])
    copies_err = _mc_close("trainer host copies",
                           [c[1] for c in tr2["copies"]],
                           [c[0] for c in tr2["copies"]])
    mf_mix = _mc_factorization([])
    mf_card = _mc_factorization(["--user-ctx", "gpu", "--item-ctx", "gpu"])
    if not mf_mix["improved"] or mf_mix["group2ctx"]["embed_user"] != \
            "cpu(0)":
        fail("matrix_factorization at its defaults: %s" % mf_mix)
    mf_err = _mc_close("matrix_factorization rmse", [mf_mix["rmse"]],
                       [mf_card["rmse"]])
    for run in (mod1, mod2):
        del run["weights"]
        run["losses"] = run["losses"][:1] + run["losses"][-1:]
    for run in (tr1, tr2):
        del run["copies"]
    phase("multi_context", card=CARD, tol=MC_TOL,
          module=dict(config="train_mnist.py's mlp, batch 64, %d synthetic "
                      "examples, 1 epoch, SGD 0.05 momentum 0.9 wd 1e-4"
                      % MC_MNIST_EXAMPLES, card_host=mod2, card=mod1,
                      scaled_err=mod_err),
          trainer=dict(steps=MC_TRAINER_STEPS, card_host=tr2, card=tr1,
                       scaled_err=tr_err, host_copy_scaled_err=copies_err),
          matrix_factorization=dict(card_host=mf_mix, card=mf_card,
                                    scaled_err=mf_err))


def dist_rank(argv):
    """``chip_smoke.py --dist-rank nightly SCRIPT... | ring | resnet
    OUT_DIR | zero OUT_DIR | resume CKPT_DIR``: one rank of a
    dist_kvstore, dist_ring, dist_resnet, zero or resume job, started by
    the port's launcher."""
    from mxnet_tpu_torch import kvstore

    planes_ref = None
    if argv[0] == "resnet" and os.environ.get("MXNET_NUM_WORKERS") == "1":
        # dist_planes' single-process plane, before this process joins
        # the job
        planes_ref = _planes_reference(argv[1])
    if not kvstore.init_distributed():
        fail("--dist-rank: no launcher environment")
    if argv[0] == "nightly":
        # the nightly scripts in turn, in this one process (the group
        # joined above; each script's init_distributed finds it)
        import runpy

        here = os.path.dirname(os.path.abspath(__file__))
        for name in argv[1:]:
            sys.argv = [name]
            runpy.run_path(os.path.join(here, "tests", "nightly", name),
                           run_name="__main__")
    elif argv[0] == "ring":
        _rank_ring()
    elif argv[0] == "resnet":
        _rank_resnet(argv[1], planes_ref)
    elif argv[0] == "zero":
        _rank_zero(argv[1])
    elif argv[0] == "resume":
        _rank_resume(argv[1])
    else:
        fail("--dist-rank: unknown job %r" % argv[0])
    return 0


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "mxnet_tpu_torch")):
        print("chip_smoke: mxnet_tpu_torch/ is not beside this script; run "
              "it from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, here)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if sys.argv[1:2] == ["--dist-rank"]:
        return dist_rank(sys.argv[2:])
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(smi, flush=True)
    global CARD
    CARD = smi
    if sys.argv[1:] == ["--wrapper-host"]:
        # only the paged wrappers' host time, of the package beside this
        # file: to compare two checkouts in one call, copy the script into
        # each and run it there
        phase("wrapper_host", **{k + "_host_ms": v
                                 for k, v in wrapper_host_ms().items()})
        return 0
    from mxnet_tpu_torch import MXNetError, rtc

    try:
        rtc_versions = rtc.versions()
    except MXNetError as e:
        fail("rtc: %s" % e)
    phase("environment", torch=torch.__version__, cuda=torch.version.cuda,
          device=torch.cuda.get_device_name(0), nvidia_smi=smi,
          tf32_matmul=False, tf32_cudnn=False, **rtc_versions)

    if sys.argv[1:] == ["--serve-time"]:
        # only the serving runs, measured (no oracle, graph or floor
        # check), through the package beside this file: to compare two
        # checkouts in one call, copy the script into each and run it
        # there
        from mxnet_tpu_torch import serving

        serve(contract=False)
        model = serving.TinyDecoder(**MODEL)
        params = model.init_params(0)
        spec_serve(model, params, contract=False)
        chunked_serve(model, params, contract=False)
        return 0
    if sys.argv[1:] == ["--zoo"]:
        # only the vision zoo's inference phase (no kernel is built: the
        # path runs none)
        zoo_score()
        return 0
    if sys.argv[1:] == ["--module-plane"]:
        # only the module plane's phases (the rtc kernels compile through
        # NVRTC; nvcc builds nothing)
        custom_rtc()
        module_plane_parity()
        return 0
    if sys.argv[1:] == ["--mnist"]:
        # only the MNIST slice's phases (no kernel is built: the path runs
        # none)
        mnist_phases()
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return 0
    if sys.argv[1:] == ["--ops-tail"]:
        # only slice 18's phases (no kernel is built: the paths run none)
        tail_phases()
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return 0
    if sys.argv[1:] == ["--gluon"]:
        # only slice 19's phases (no kernel is built: the paths run none)
        gluon_phases()
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return 0
    if sys.argv[1:] == ["--graph"]:
        # only slice 20's phases (no kernel is built: the paths run none)
        graph_phases()
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return 0
    if sys.argv[1:] == ["--fleet"]:
        # only slice 21's phases (the two paged kernels build at first use)
        fleet_phases()
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return 0
    if sys.argv[1:] == ["--block-serve"]:
        # only slice 22's phase (no kernel is built: the path runs none)
        block_serve()
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return 0
    if sys.argv[1:] == ["--dist"]:
        # only the distributed slice's phases (no kernel is built: the
        # paths run none)
        dist_phases()
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return 0
    if sys.argv[1:] == ["--dist-planes"]:
        # only dist_resnet's two jobs, with the planes across the ranks
        # (no kernel is built: the paths run none)
        torch.cuda.empty_cache()
        dist_resnet()
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return 0
    if sys.argv[1:] == ["--multi-device"]:
        # only this slice's phases and their two jobs' others: dist_ring
        # with pipeline, the zero job (zero_resnet, zero_ckpt, zero_plane),
        # multi_context (no kernel is built: the paths run none)
        torch.cuda.empty_cache()
        dist_ring()
        with tempfile.TemporaryDirectory() as tmp:
            zero_job(tmp)
        multi_context()
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return 0
    if sys.argv[1:] == ["--elastic"]:
        # only the sharded-state and elastic phases (no kernel is built:
        # the paths run none)
        elastic_phases()
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return 0
    if sys.argv[1:] == ["--imagenet"]:
        # only slice 24's phases (the host compiler builds the codec; no
        # nvcc build: the path runs no CUDA kernel)
        imagenet_phases()
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return 0
    if sys.argv[1:] == ["--vision"]:
        # only slice 23's phases (nvcc builds the NMS kernel, which
        # Proposal runs)
        from mxnet_tpu_torch.ops import _build

        t0 = time.perf_counter()
        _build.load("nms")
        phase("build", kernels=["nms"], seconds=time.perf_counter() - t0)
        vision_phases()
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return 0
    if sys.argv[1:] == ["--word-lm"]:
        # only the word language model slice's phases (no kernel is
        # built: the path runs none)
        word_lm_phases()
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return 0
    if sys.argv[1:] == ["--resnet"]:
        # only the ResNet slices' phases (no kernel is built: the path
        # runs none)
        resnet_phases()
        return 0
    if sys.argv[1:] == ["--ckpt"]:
        # only the checkpoint phases (nvcc builds the NMS kernel, which
        # ckpt_ssd runs; the rtc kernels compile through NVRTC)
        from mxnet_tpu_torch.ops import _build

        t0 = time.perf_counter()
        _build.load("nms")
        phase("build", kernels=["nms"], seconds=time.perf_counter() - t0)
        ckpt_phases(ssd_train()[1])
        return 0
    if sys.argv[1:] == ["--profiler-empties"]:
        profiler_empties()
        return 0
    if sys.argv[1:] == ["--nms-time"]:
        # only the NMS times, through the public wrapper of the package
        # beside this file: to compare two checkouts in one call, copy the
        # script into each and run it there
        from mxnet_tpu_torch.ops import _build

        _build.load("nms")
        kernels = [k for k in ptxas_entries(_build.build_log("nms"))
                   if KERNEL_4 in k]
        phase("build", kernels=["nms"], nms_kernels=len(kernels))
        nms_time(np.random.RandomState(44), per_call=len(kernels))
        return 0
    names, secs, ptxas = build_all()
    if sys.argv[1:] == ["--profiles"]:
        # only the GPT and SSD training steps' profiles, of the package
        # beside this file: to compare two checkouts in one call, copy the
        # script into each and run it there
        phase("build", kernels=names, seconds=secs)
        train_profile()
        ssd_profile()
        return 0
    from mxnet_tpu_torch.ops import _build

    phase("build", kernels=names, seconds=secs, ptxas=ptxas,
          flash_d64_ptxas=flash_ptxas(_build.build_log("flash_attention")),
          paged_attention_ptxas=spill_free_ptxas(
              _build.build_log("paged_attention"),
              ("paged_attention_split_kernel",
               "paged_attention_merge_kernel")),
          paged_spec_attention_ptxas=spill_free_ptxas(
              _build.build_log("paged_spec_attention"),
              ("paged_spec_attention_kernel",)),
          nms_ptxas=spill_free_ptxas(_build.build_log("nms"), NMS_KERNELS))

    if sys.argv[1:] == ["--nms-sweep"]:
        nms_sweep()
        return 0
    entry = check_kernels()
    spec_entry = check_spec_kernel()
    flash_entry = check_flash_kernel()
    nms_entry = check_nms_kernel()
    entry["launches"] = serve()
    from mxnet_tpu_torch import serving

    model = serving.TinyDecoder(**MODEL)
    params = model.init_params(0)  # no device given: the card
    spec_entry["launches"] = spec_serve(model, params)
    chunked_serve(model, params)
    fleet_one, fleet_spec = fleet_phases()
    entry["launches"] += fleet_one
    spec_entry["launches"] += fleet_spec
    flash_entry["launches"] = train()
    train_parity()
    train_profile()
    nms_launches, ssd_res = ssd_train()
    ssd_parity()
    ssd_profile()
    resnet_phases()
    rtc_err = rtc_check()
    custom_softmax()
    rtc_launches, rtc_plane_ms = custom_rtc()
    module_plane_parity()
    ckpt_nms, ckpt_rtc = ckpt_phases(ssd_res)
    nms_entry["launches"] = nms_launches + ckpt_nms
    rtc_entry = rtc_time()
    rtc_entry["launches"] = rtc_launches + ckpt_rtc
    # the two kernels' device ms a step inside the module plane's graph
    rtc_entry["graph_device_ms"] = rtc_plane_ms
    # the least time of each in-graph kernel at the path's (64, 10): its
    # bytes once (forward: x read, y written; backward: prob and label
    # read, dx written) over the card's memory rate
    rows, cols = RTC_SHAPES[0]
    rtc_entry["graph_bound_ms"] = {
        "softmax_fwd": 2 * rows * cols * 4 / PEAK_BYTES_S * 1e3,
        "softmax_ce_bwd": (2 * rows * cols + rows) * 4 / PEAK_BYTES_S * 1e3}
    rtc_entry["max_abs_err"] = max(rtc_entry["max_abs_err"], rtc_err)
    zoo_score()
    word_lm_phases()
    mnist_phases()
    tail_phases()
    gluon_phases()
    graph_phases()
    block_serve()
    nms_entry["launches"] += vision_phases()
    imagenet_phases()
    dist_phases()
    elastic_phases()
    multi_context()
    print(json.dumps({"kernels": [entry, spec_entry, flash_entry,
                                  nms_entry, rtc_entry]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
