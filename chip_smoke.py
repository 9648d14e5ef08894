#!/usr/bin/env python3
"""Smoke run of mxnet_tpu_torch on one CUDA card.

    python3 chip_smoke.py            # every phase, one card (or more)

Phases, each failing loudly (exit code 1, no result line):

1. device: CUDA must be present; prints the card's name and power limit
   (nvidia-smi) and turns TF32 off for every fp32 comparison.
2. build: compiles the port's CUDA kernels from mxnet_tpu_torch/csrc with
   nvcc and prints the build time and ptxas' register/smem report.
3. kernels, at the shapes each main path gives them: fused_conv_unit's
   CUDA kernel against its plain PyTorch version at the 20 fused-unit
   configurations of ResNet-50 v1 at 224x224 in bf16, at N=32 without
   statistics (a served batch) and at N=256 with them and a random shift
   (a training step); then two fp32 configurations, a 3x3 stride-2 one
   (BasicBlockV1) at N=32 and bf16 edge cases: M off every tile (N=3 at
   7x7), Co=72, Ci=40, 3x3 stride 2 with in_bias -1.5 and +2.0 (padding
   after the affine), N=1 at 56x56.  Two launches must give bit-identical
   y, s1 and s2 (a training shape with two reduction passes and three
   extras), and bf16 Ci=12 must raise without a launch.  One line per
   configuration: the output tile, kernel_ms (the launch step, conv
   kernel and statistics reduction, on OHWI weights, replayed from a
   CUDA graph: device time), op_ms (the whole wrapper call), ref_ms (the
   plain version), library_ms (F.conv2d on the pre-activated input, a
   yardstick the port never calls) and bound_ms (max of FLOPs over peak
   and bytes over 3.35 TB/s, where x counts only the pixels the taps
   read).
   Tolerances:
     fp32: y within atol/rtol 1e-4; s1/s2 within rtol 1e-4 of sum|.|
     bf16: |y - y_ref| <= 1 bf16 ulp of y_ref on >= 99.9% of elements and
           <= 2 ulp everywhere, each plus 4*sqrt(K)*2^-24*sum|u*w|, the
           spread of two fp32 summation orders over K products (without
           it an output that cancels to near zero would be held to an ulp
           of itself); the share within 1 ulp without that slack is
           printed beside it ("1ulp bare"); s1/s2 within rtol 2e-3 of
           sum|.|
     want_stats=False: s1/s2 exactly 0.
   Then fused_conv_unit_bwd's CUDA kernel (kernel 2: the dy fold, dgrad,
   split-K wgrad and their reductions) against its plain version at the
   14 stride-1 configurations of ResNet-50 v1 (N=256, bf16, want_stats
   on), then one fp32 and one want_stats-off configuration (N=32) and
   bf16 edge cases: M off every tile (N=3 at 7x7), Co=72 and Co=20 (dy's
   padded pitch, with and without statistics), Ci=40, 3x3 with in_bias
   -1.5 and +2.0 (padding after the affine), N=1 at 56x56, and several
   wgrad splits with two gscale reduction passes; y from the forward
   kernel, random cotangents.  Two launches must give bit-identical gx,
   dw, gscale and gbias (a training shape and four edge cases), and bf16
   Ci=12 must raise without a launch.  kernel_ms is the launch step
   replayed from a CUDA graph (device time), op_ms the whole wrapper
   call; each training configuration prints torch.profiler's split of
   the launch step into fold, dgrad, wgrad and reductions (shares only).
   library_ms is PyTorch's dgrad + wgrad convolutions
   (torch.nn.grad.conv2d_input + conv2d_weight) on the same tensors;
   bound_ms is max(2x the forward FLOPs / peak, bytes of x, y, gy, gx, w,
   dw / 3.35 TB/s).  Tolerances: gx and dw as y above (bf16: 1 ulp +
   4*sqrt(K)*2^-24*sum|terms| on >= 99.9%, <= 2 ulp + slack everywhere;
   fp32: 2^-23 relative + the slack), K = kh*kw*Co for gx and N*Ho*Wo for
   dw; gscale and gbias within 1e-4 of sum|terms|; without act_in
   exactly 0.
   Then the attention kernel (dot_product_attention, kernel 5) against its
   plain version at BERT-base serving shapes: (B*H, S, D) = (384, 128, 64)
   bf16 through `attend` and the packed (32, 128, 768) projections through
   the op as the main path calls it, valid lengths from a seed in
   [1, 128] with one row at 0, two launches bit-identical; then one fp32
   case, S = 200 with lengths [200, 77] (two passes), causal with S = 40
   and Sk = 72, D = 128, D = 72 (S = Sk = 300, causal, two passes), D =
   8, and the head-split layout.  kernel_ms is the wrapper's launch step
   replayed from a CUDA graph (device time; "events" beside it times the
   same launches by CUDA events around the host's calls), op_ms the
   whole op call, ref_ms the plain version, library_ms
   F.scaled_dot_product_attention on the same tensors, replayed the same
   way (a yardstick the port never calls), bound_ms max(4*BH*S*Sk*D /
   peak, bytes of q, k, v, out and mask / 3.35 TB/s).  Tolerances: bf16
   |o - o_ref| <= 2 bf16 ulps of o_ref + 2^-8 * sum_k p_k |v_k|; fp32 <=
   1e-5 * sum_k p_k |v_k|; fully masked rows at the mean of v over the
   real keys.
4. main path, serving: full-width ResNet-50 v1 (random weights from a
   seed), bf16, NHWC, 224x224, exported with export_model, served through
   ModelRepository -> InferenceServer with MXNET_FUSED_CONVBN=1 to
   requests from several threads.  Every request must be answered, the
   kernel launch count must rise by exactly 52 per launched batch, and
   the answers must match a direct forward with MXNET_FUSED_CONVBN=0
   (op-granular, no kernel) to relative L2 error < 2e-2; then the same
   with an fp32 copy of the net, bound 1e-4.
4b. main path, BERT serving: full-width BERT-base (bert_12_768_12,
   Normal(0.02) weights from a seed), exported with dynamic_batch=True in
   bf16 and fp32 and served through ModelRepository -> InferenceServer
   (max_batch_size 32, batch_timeout_ms 2) to single-sequence requests of
   128 tokens (valid lengths from a seed in [16, 128]) from several
   threads.  Every request must be answered with its (seq, pooled) pair,
   the attention kernel must launch exactly 12 times per launched batch,
   and the answers of 16 requests must match the port's fp32 forward of
   the same weights on the CPU (plain versions) to relative L2 < 2e-2
   (bf16) and < 1e-4 (fp32 served on the card).  Scrambling the tokens at
   and past valid_length must not change a valid position.  Then req/s,
   p50/p99, a direct batch-32 forward time and its torch.profiler
   breakdown (the kernel's share, the idle share).  The HTTP part
   (bert_http; before the server shuts down), over the same repository
   and server behind serving.serve_http(server, port=0): (a) 64 predicts
   as JSON from 8 client threads over urllib, every answer 200 with its
   (seq, pooled), 12 kernel-5 launches a launched batch, the first 16
   within 2e-2 relative L2 of the CPU fp32 forward, kernel 5 against its
   plain version at each bucket the batches ran at (with those batches'
   valid lengths; the kernel line's bert_http entry sums these checks
   over (a)'s launches), req/s and p50/p99 at the client beside the
   in-process figures; (b) /metrics parses as
   Prometheus text and counts every request sent to the model,
   /v1/models, /v1/metrics, /healthz 200, /statusz renders; (c) chaos
   faults at serving.execute (every attempt of the retry policy) open
   the bf16 model's circuit breaker: it answers 503 ModelUnavailable,
   the fp32 model 200 and /healthz 200, no kernel launches while
   faulted, and after the cooldown one probe closes the breaker; (d)
   version 2 of the bf16 artifact, pinned out of traffic, then rollover
   with v1's requests in flight: none fails, later version-less requests
   land on v2, and v1's release frees at least its parameter bytes of
   device memory; (e) shutdown(drain=True) with requests queued behind a
   hung batch: /healthz, /statusz and a predict answer 503 while every
   accepted request is answered, and a predict after it 503.  One
   `serving_http: {...}` line.
5. main path, training (bench.py's configuration): make_mesh(dp=1) +
   SPMDTrainer(SoftmaxCrossEntropyLoss, sgd lr 0.1 momentum 0.9 wd 1e-4)
   on full-width ResNet-50 v1, bf16, NHWC, 224x224, batch 256, a fixed
   synthetic batch, with MXNET_FUSED_CONVBN=1 and MXNET_FUSED_CONVBN_BWD=1.
   Every step must launch the forward kernel exactly 52 times and the
   backward kernel 46 times, and give a finite loss.  One step from
   identical weights (running means warm) is held against the
   op-granular step (both knobs off, cuDNN), and both against a step of
   a higher-precision copy (fp32 at batch 8 against float64; bf16 at
   batch 256 against fp32), leaf by leaf (step_agreement): on every
   leaf where op-granular lands within 25% of the reference, the fused
   update w1 - w0, and the logits of a training-mode forward, must lie
   within 2x (fp32) / 1.25x (bf16) the op-granular distance, or the
   witness's where larger, plus 1e-4 (fp32) / 2e-2 (bf16) of the
   reference; the loss within 1e-5 (fp32) / 2e-2 (bf16) relative of
   op-granular's.  The fp32 witness is the float64 step with inputs and
   weights moved by 2^-24 relative: at random weights it lands ~0.7%
   away, so no fp32 step can be held to 1e-3 over all weights.  Then
   each mode trains its own copy of the net, in turns, timed and
   profiled (with the fused step's kernel-2 time split into fold, dgrad,
   wgrad and reductions, as shares).
6. main path, data-parallel training: kernels 1 (with statistics) and 2
   checked as in phase 3 at the per-rank shapes (N = 256 / 2), then
   bench.py's step over 2 rank processes of this script (spawned, never
   forked; `--dp-rank r` runs one), each calling dist.init() from the
   DMLC_* environment -> make_mesh(dp=2) -> SPMDTrainer(...).step on
   phase 5's weights and global batches: fp32 at batch 8 and bf16 at
   batch 256, fused with the fused backward and op-granular.  With one
   card both ranks run on cuda:0 over gloo; with two or more, rank r on
   cuda:r over NCCL; every time is printed beside that mode.  Every
   fused step must launch 52 forward and 46 backward kernels on each
   rank; after every step the ranks must hold bit-identical parameters,
   running statistics and momenta (hashes; under ZeRO, the default,
   each momentum gathered to full size); rank 0's update and the
   loss are held against phase 5's reference of the same step by phase
   5's per-leaf rule (fp32 against float64 with its witness, bf16
   against fp32).  Then 2 timed steps a mode and a profile of a fused
   step on rank 0 (kernel time, kernel 2's split as in phase 5, the
   collectives' host and device time).
   A rank that fails or outlives its time makes the parent kill every
   rank and fail.
7. the probe path (row 6): kernel 6 (candidate_tap, the tap-accumulation
   unit with an explicit batch tile nb) against its plain version by
   phase 3's tolerances: (a) at the probe's four cases (N=4, nb=2, bf16,
   the probe's own inputs), one fp32 case, one want_stats-off and one
   act_in-off case, a 3x3 stride-2 case at nb 1 and 4, Co=72 with Ci=40,
   and N=6 at nb=4 and bf16 Co=20, which must raise without a launch;
   (b) at the nine batch-256 layers of the probe's time mode for each nb
   in {1, 16, 256}, with kernel 1's launch step on the same inputs, the
   sweep of each beside the other, and two launches bit-identical at nb
   1 and 256 (and equal across them) on the 7x7 3x3 layer.  kernel_ms is
   the launch step replayed from a CUDA graph, op_ms the whole wrapper
   call, library_ms F.conv2d on the pre-activated input replayed the same
   way, bound_ms phase 3's.  (c) The
   probe's entry point, mxnet_tpu_torch.tools.convbn_probe.main(argv),
   in check mode and in time mode on cuda:0, with the launch counters of
   kernels 1 and 6 set to 0 just before: both must return 0, kernel 6
   must launch once per call the probe made (4 + 9 x 3 x 12) and kernel
   1 once per timed call (9 x 12).  Prints the probe's per-layer table
   (kernel 1, the op-granular unit, kernel 6 by nb, F.conv2d, the bound)
   and its ratios, then a torch.profiler split of kernels 1 and 6 (at
   each nb) into the conv kernel and the statistics reduction over one
   sweep of the nine layers, and of kernel 1 per layer.
8. main path, MXNet's imperative training loop (nd, autograd.record(),
   loss.backward(), gluon.Trainer.step), in this process after phase 7:
   (a) mxnet_tpu_torch.examples.mnist.run(epochs=1, batch_size=100) on
   cuda:0 and the synthetic MNIST set: 81 steps, val accuracy > 0.9, and
   every parameter, gradient and optimizer state on cuda:0; samples/s
   printed with the card.  (b) fp32 ResNet-50 v1 at batch 8 from phase
   5's weights and batch: one gluon.Trainer("sgd", lr 0.1, momentum
   0.9, wd 1e-4).step(8) after backward of the per-sample loss, against
   the fused SPMDTrainer step from the same start: on each of phase 5's
   checked leaves the momentum (the update) and w1 within 1e-5 relative
   L2, the loss within 1e-5 (the summed loss rescaled by 1/8 and the
   mean loss differ by a power of two; the spread of two SPMDTrainer
   steps from the same start is printed beside it).  (c) bf16 at batch
   256, hybridized, MXNET_FUSED_CONVBN=1 and MXNET_FUSED_CONVBN_BWD=1:
   the same against the fused SPMDTrainer step, within phase 5's
   per-leaf bounds (1.25 x max(op-granular's distance to the fp32 step)
   + 2e-2 on phase 5's checked leaves, the loss within 2e-2), and 52
   forward and 46 backward kernel launches in the step; then 2 timed
   steps of each trainer in turns (gluon, SPMD, SPMD, gluon) after a
   warm-up step each, 52/46 launches a step held, their ratio printed,
   and a torch.profiler idle share of each; the
   host time of autograd's walk from the loss to its leaves.  Then the
   captured hybridized loop (the CachedOp's forward and backward graphs
   and the captured update) against the same loop under no_capture: 4
   steps from one state bit for bit (every parameter, buffer, momentum
   and loss), 52/46 launches a step on both, exactly one forward/backward
   build (the first step is the signature's eager warm-up), none after
   set_learning_rate, and after load_parameters one build and one
   eviction; ms a step of each in turns beside SPMDTrainer's, idle
   shares, capture s and pool GiB.  (d)
   The same net not hybridized: one step, 0 kernel launches.  (e)
   net(x) outside record(): inference, the running statistics
   bit-identical, finite logits, no graph.
9. main path, the transformer models (bench_all.py's configs 3 and 5 on
   the port's bench_steps blocks, make_mesh(dp=1) + SPMDTrainer with
   Adam, the kernel counters set to 0 just before each path and read
   just after).  First kernel 5 against its plain version at the greedy
   decode's shapes by phase 3c's rule (bf16, 64 sources, 8 heads of 64,
   packed: the encoder's S = Sk = 64, cross attention at S = 1..31 over
   Sk = 64, causal self-attention at S = Sk = 1..31).  (a) BERT-base MLM
   + NSP pretraining exactly at config 3: bert_12_768_12, vocab 30522,
   max_length 512, batch 32 x 128, Normal(0.02) from seed 0, one warm
   forward, bf16, Adam lr 1e-4, dropout 0.1, inputs from RandomState(0):
   one warm-up and 5 timed steps (samples/s, ms a step, finite and
   falling losses, a torch.profiler idle share) and no kernel launch
   (dropout takes the plain attention, as in the JAX package).  (b) The
   same step at dropout 0 from the same weights: 12 kernel-5 launches,
   held against the same step with the attention by its plain version
   and both against an fp32 step (plain): both Adam moments leaf by leaf
   by phase 5's rule with its bf16 bounds, the update w1 - w0 over all
   leaves by the same rule, and every updated leaf bit for bit the Adam
   step from w0 and its own moments; the tied word embedding is one trained leaf whose first moment and
   update match one Adam step on its summed gradient (2e-2 relative L2);
   the recompute backward's ms beside F.scaled_dot_product_attention's
   forward + backward at (32, 12, 128, 64), for the record.  (c)
   Transformer-base at config 5: vocab 32000, batch 64, a (64, 64)
   bucket, Xavier, bf16, Adam lr 3e-4, dropout 0.1: as (a) in tokens/s,
   no kernel launch.  (d) Transformer-base's greedy_decode of 64 sources
   of 64 tokens (src_valid from a seed in [16, 64]), max_len 32, bf16,
   from (c)'s weights: 6 + 12 x steps kernel-5 launches; teacher-forced
   decode_logits on the decoded tokens, kernel against plain, within
   relative L2 2e-2, and the tokens equal to the plain path's argmax
   wherever its top-2 margin exceeds 4x the row's largest kernel-plain
   logit distance;
   an fp32 decode at batch 4 gives identical tokens with the kernel and
   the plain version.

10. main path, SSD-300-ResNet50 (bench_all.py's config 4) on the port's
   entry points, with the fused-unit knobs on (its NCHW backbone never
   takes kernels 1-2; kernels 1, 2, 5 and 6 must launch 0 times in every
   part): (a) bench_steps.ssd_step("full") (ssd_300_resnet50_v1(classes
   =20) with SSDMultiBoxLoss, Xavier from seed 0, 30,391,648 values),
   cast to bf16, ssd_batch("full") (RandomState(0): batch 32 at 300x300,
   the images cast to bf16, 2078 anchors' random targets), make_mesh(dp=
   1) + SPMDTrainer with sgd lr 0.01, momentum 0.9, wd 5e-4: one warm-up
   and 3 timed captured steps (img/s, ms a step, finite losses, an idle
   share, the capture's seconds and the pool's GiB); (b) 3 replays
   against 3 eager steps from one state, bit for bit (as phase 5); (d)
   the trained net's hybridized inference forward at batch 32 in bf16,
   captured against eager bit for bit, then softmax (fp32) and
   MultiBoxDetection at nms_topk 100 and -1 (K = 2078, the row-recompute
   NMS branch), each against the port's CPU run of the same op on the
   same inputs: class ids, scores and kept rows identical, boxes within
   1e-6, the NMS loop's own ms beside the op's and the count of candidate
   pairs whose IoU lies within 1e-6 of the threshold; (c) the fp32 step
   at batch 4 on cuda:0 (TF32 off) against the same step on the CPU from
   the same weights and batch: the loss within 1e-4 relative, each
   leaf's update (its first momentum) within 1e-3 relative L2 plus twice
   the step's own sensitivity (the card step from weights moved by
   2^-24 relative), the number of leaves past 1e-3 and of anchors whose
   hard-negative keep differs printed; then the bf16 card step against
   the fp32 one, loss within 2e-2; (e) mxnet_tpu_torch.examples
   .ssd_train.main(--batch-size 8 --steps 3) on cuda:0 with the
   ResNet-50 network: finite losses, every parameter, gradient and
   optimizer state on cuda:0.  The phase's seconds are printed.
11. main path, MXNet's symbolic API: (a) ResNet-50 v1 written with mx.sym
   in the layer layout of gluon's resnet50_v1 (resnet50_v1_sym below:
   NCHW fp32 at 224x224, 1000 classes, a SoftmaxOutput head; 25,557,032
   parameters), trained through Module(context=gpu(0)).fit over an
   NDArrayIter of seeded synthetic images (numpy's default_rng(0), batch
   64, no shuffle) with sgd lr 0.1, momentum 0.9, wd 1e-4 and
   rescale_grad 1/64 (MXNet's own Module default): one epoch of 4
   batches, then 3 timed captured steps (forward_backward + update:
   the executor's train step and FusedUpdater's update, each one CUDA
   graph) and 3 eager ones (_graphs.no_capture), ms a step, img/s, an
   idle share of each, the captures' seconds and pools' GiB; cuDNN's
   default fp32 algorithms are not deterministic (the count of tensors
   in which two eager steps from one state differ is printed), so a
   second Module from the trained weights is captured under
   cudnn.deterministic and its replayed step held against its eager
   step from one state, bit for bit (outputs, every gradient, moving
   statistics, updated weights, momenta), with no new build; one
   batch-8 step on cuda:0 against the same step of the port on the CPU
   from the same weights and batch: in fp32 (TF32 off) the outputs and
   all leaves' updates together within 1e-4 / 1e-3 relative L2 plus
   twice the step's own sensitivity (the larger of two card steps'
   distance from one state, cuDNN's default fp32 algorithms not being
   deterministic, and of the card step from weights moved by 2^-24
   relative), each leaf's fp32 distance printed; in float64 the outputs
   and each leaf's update within 1e-9 (one fp32 rounding moves a leaf
   of this step by up to ~2e-3); save_checkpoint -> Module.load ->
   predict over 128 images equal to the prediction before saving. (b)
   sym.dot_product_attention at BERT-base's shapes (32 x 12 heads, 128
   tokens, D 64, bf16, packed, valid lengths from a seed), bound and run
   forward 3 times: each output equal to
   ops.attention.dot_product_attention on the same inputs bit for bit,
   kernel 5 launched once a forward.  (c) a graph of one sym.FusedConvUnit
   node at ResNet-50's 3x3 64->64 layer (N 32, 56x56, bf16 NHWC, act_in,
   statistics) bound with gradients, 3 train steps (forward(is_train=
   True) + backward()): y, s1, s2 and the gradients of data, weight,
   in_scale and in_bias equal to a direct fused_conv_unit call with ones
   cotangents bit for bit, kernels 1 and 2 launched once a step each.
   The phase's seconds are printed.
12. main path, Gluon as MXNet users write it (the hybridized training
   forward and backward captured per signature): (a) BERT-base (phase
   9's nets and batch, from its weights) through examples/bert_pretrain.py's
   loop, net.hybridize(), gluon.Trainer with Adam lr 1e-4, at dropout 0
   and 0.1: 4 captured steps (the net and its two heads, each its own
   CachedOp: three builds after the warm-up step) against 4 under
   no_capture from one state and one generator state, bit for bit (every
   parameter, buffer, Adam state and loss), 12 kernel-5 launches a step
   at dropout 0 on both; at 0.1 two generator states give two losses.
   (b) Mirror: phase 5's ResNet-50 at batch 256, one captured step with
   hybridize(mirror=True) against the same step without it, from phase
   5's weights: every gradient, weight, momentum and running statistic
   bit for bit (again under cudnn.deterministic where cuDNN's default
   algorithms break that), the running means advanced once; each pair's
   pool GiB, the peak allocated memory over its warm-up, build and step,
   the kernel-1 launches a step, the ms a step of 3 more captured steps.
   (c) The same net at batch 32 called
   twice under one record() (a siamese loss): gradients and running
   statistics bit for bit the eager ones, two pairs built, a second
   backward through the consumed pairs raises.  (d) The reference MNIST
   network (deferred shapes) through Estimator.fit on cuda:0, one epoch:
   val accuracy > 0.9, shapes (128, 784), (64, 128), (10, 64), every
   parameter, gradient and state on the card.  (e) examples/ssd_train.py
   at batch 8 with hybridize(static_alloc=True), captured and under
   no_capture (cudnn.deterministic): losses bit for bit, ms a step of
   each.  The phase's seconds are printed.
13. main path, every optimizer of the port (ROADMAP queue A item 4):
   (a) the 15 cases of the JAX package's tests/test_fused_step.py (sgd
   with and without momentum, nag, adam, adagrad, adadelta, adamax,
   nadam, rmsprop plain and centred, ftrl, signum, signsgd, lamb, test)
   over the trained tensors of phase 8's ResNet-50 v1 (193, 25,575,912
   values; random from a seed), in bf16 with multi_precision and in
   fp32: 2 updates of optimizer.FusedUpdater.update_all (the first runs
   eagerly and captures, the second replays) against 2 of the eager
   per-parameter Updater from the same state, bit for bit (weights,
   masters, states; one build), and the card's eager update against the
   port's CPU update of the same inputs: every fp32 tensor within 1e-5 of
   its largest magnitude, every bf16 weight within one bf16 ulp; then 3
   captured updates timed (ms an update).  (b) BERT-base MLM+NSP (phase 9's
   dropout-0 net and batch, from its weights) through phase 12 (a)'s
   hybridized gluon.Trainer loop with LAMB (lr 1e-3, multi_precision):
   4 captured steps against 4 under no_capture from one state, bit for
   bit, 12 kernel-5 launches a step on both, three builds; ms a step
   beside phase 12's Adam step, the idle share of a captured step, the
   captures' seconds.  (c) phase 8's ResNet-50 v1 (bf16, NHWC, batch
   256, fused units) through SPMDTrainer with centred RMSProp (lr 1e-3,
   wd 1e-4, multi_precision: three states and an fp32 master a bf16
   weight, three states an fp32 BatchNorm parameter):
   phase 5's hold of 3 captured steps against 3 eager ones, bit for bit,
   52 + 46 kernel launches a step; ms a step beside phase 5's SGD step.
   The phase's seconds and the whole script's are printed.
14. MXNet's imperative op surface (ROADMAP queue A item 3(a)-(e)), with
   TF32 off: (a) every registered op name (338) on the card against the
   same call on CPU tensors, on mxnet_tpu_torch.tools.op_sweep's seeded
   inputs, forward and (differentiable ops) the gradient under a seeded
   cotangent: index, selection and data-movement ops the same bits; the
   elementwise ops within 16 ulps of the CPU's (the ulp taken at no less
   than 2^-10 of the output's largest magnitude); sums, products,
   normalisations and series (lgamma, digamma) within 2^-24 * n * S plus
   a rounding (S the terms' magnitudes, or the output's largest); the
   kernel ops, the update ops, MultiBox* and Dropout named as held by
   phases 3, 9-13; the draws held by (c).  One line of counts per class
   and the worst error of each.  (b) take of a 30522x768 table by 32x128
   ids, one_hot of 32x128 at depth 30522, batch_dot 384x128x64 by
   384x64x128, dot 4096x768 by 768x3072 (fp32), SequenceMask over
   128x32x768, split of a 4096x4096 block into 4 (views) and
   nd.random.normal of ResNet-50 v1's 25,557,032 values: ms by CUDA
   events beside the larger of bytes / 3.35 TB/s and FLOPs / 67
   TFLOP/s, each held against its CPU result (the draw by its moments),
   beside the card's name and power limit.  (c) every _random_* and
   _sample_* distribution, 2^22 draws on the card from its generator:
   mean and variance within 6 standard errors of the analytic values
   (the variance's from the fourth moment); one seed gives the same bits
   twice; _shuffle is a permutation; _sample_multinomial's get_prob is
   the log of the chosen probability; a CUDA graph around
   nd.random.normal with the generator registered replays, K = 3 times,
   the bits of 3 eager draws from the same state.  (d) a sigmoid written
   with autograd.Function, recorded on the card: its gradient within 1
   ulp of the built-in sigmoid's and within 2^-22 |dy| + 4 ulps of the
   CPU's (the two sigmoids may put y two ulps apart near 1).
15. MXNet's recurrent path (ROADMAP queue A item 6), TF32 off: (a) the
   RNN op, all four modes, bidirectional, 2 layers, T = 30, batch 32,
   width 200, given states: outputs and the gradients of data,
   parameters and states on the card against the CPU, fp32 and bf16,
   each tensor's distance to the float64 CPU run within twice the CPU
   run's in the same dtype plus 2^-20 (fp32) / 2^-8 (bf16) of
   (1 + max|ref|); dropout at p = 0.3 between two layers built to pass
   it through: the kept share within 6 standard errors of 0.7, the kept
   values y / 0.7, one generator state the same bits twice, the next new
   draws.  (b) mxnet_tpu_torch/examples/rnn_bucketing.py at its default
   widths (batch 32, width 200, 2 LSTM layers, buckets 10-60, 2000
   synthetic lines, Adam): 2 epochs over the fused op, 1 over the
   legacy cells; final perplexity < 3.0, one training and one scoring
   capture per bucket and no eviction, one updater and one captured
   update for every bucket, each bucket's captured step bit for bit its
   step under no_capture from the same state; ms a step per bucket,
   captured and eager, median [min, max] of 10 calls.  (c) the same LM
   written with gluon.rnn.LSTM(200, num_layers=2) through the hybridized
   gluon.Trainer loop: 4 steps captured against 4 under no_capture, bit
   for bit, one training build.  (d) CTCLoss at T = 100, batch 32,
   alphabet 30, labels of 1-20: loss and gradient against the CPU as in
   (a) (2^-20); ms beside F.ctc_loss (the record only).  (e)
   contrib.amp: init("float16"), convert_hybrid_block on (c)'s net, one
   bf16 step through scale_loss/unscale: every parameter bf16 and
   changed, the loss finite.  (f) the op (LSTM, 2 layers) beside
   torch.nn.LSTM (cuDNN) at the example's T = 60 and Zaremba et al.'s
   medium PTB LSTM (T = 35, width 650), batch 32, fp32 and bf16, forward
   and forward + backward, ms by graph replay; for PERF.md only.
16. the core runtime on the card (phase_core; alone: python -c "import
   chip_smoke as c; c.phase_core(c.phase_device())"): (a) Context:
   gpu(0).device_type == "gpu", `with mx.gpu(0):` puts nd.zeros,
   nd.array and nd.sparse.zeros on cuda:0, `with mx.cpu():` inside it on
   the CPU, current_context() restored on exit.  (b) a sparse logistic
   regression at the width of LIBSVM's avazu-app (1,000,000 features):
   32,768 synthetic rows of 20 Zipf-drawn features from the seed,
   labels from a planted weight vector, written to a libsvm file and
   read by io.LibSVMIter at batch 8192; a step is kv.row_sparse_pull of
   the batch's columns, nd.sparse.dot(csr, w) + b, the logistic gradient
   dot(csr, r, transpose_a=True).tostype("row_sparse") and kv.push into
   a local store with lazy SGD (momentum 0.9); 5 epochs.  Held: the
   loss falls from ln 2 (each epoch's mean below the last, the last
   below ln 2 - 0.05); moving each CSR batch to the card takes at most
   1.1x its compact bytes (the allocator's peak, in a memory pool of
   its own); the rows no batch touched are their initial bits after step
   1 and at the end; the card's weights after epoch 1 within
   2^-20 (of their largest magnitude) of a CPU run of the port.  Prints
   ms a step and the share of the run spent parsing.  (c) lazy updates
   on a 1,000,000 x 64 fp32 table: the row-sparse gradient of 8192 x 20
   Zipf ids through lazy SGD-momentum (untouched rows bit for bit,
   touched rows within one ulp of the dense sgd_mom_update restricted
   to them), SGD with lazy_update=False and Adam (both bit for bit the
   dense update on the dense view); ms by CUDA events against the dense
   update, beside the bound (the bytes each must move over 3.35 TB/s).
   (d) every linalg name on the card against float64 on the CPU: 8 x
   2048^2 fp32 for potrf, potri, trsm, trmm, syrk, gemm, gemm2, 8 x 512^2
   for syevd, gelqf, inverse, det, slogdet, solve (and the aliases), the
   copies bit for bit against the CPU's fp32 op, moments over ResNet-50
   stage-1 activations (256 x 56 x 56 x 256 bf16, axes 0-2); products
   within 2^-22 k of their terms' magnitudes, decompositions within
   8 n 2^-24 normwise (inputs built with condition numbers below 2),
   syevd's eigenvectors by reconstruction and orthogonality; ms by CUDA
   events against the bound (FLOPs at the 67 TFLOP/s fp32 peak, bytes
   at 3.35 TB/s).  (e) MXNET_ENGINE_TYPE=NaiveEngine in a child process
   of this script (--naive-engine, spawned as phase 6 spawns its
   ranks): after each op outside engine.bulk the stream is idle
   (torch.cuda.current_stream().query()); inside bulk(15) it is busy
   after each op and idle at the scope's exit; the default engine's
   stream is busy after the same op.
17. the vision training path (phase_vision; it needs phase 2's build):
   (a) resnet50_v2 (classes 1000, bf16, NHWC, 224², batch 256, no fused
   path) through SPMDTrainer (SGD lr 0.1, momentum 0.9, wd 1e-4): three
   captured steps against three eager ones bit for bit (as in phase 5),
   their ms and idle shares, then 5 steps on the fixed batch with the
   loss falling.  (b) remat=True against remat=False, 3 steps from the
   same weights by fresh trainers, on ResNet-50 V1 fused (52 + 46
   launches a step both ways) and on resnet50_v2: every parameter,
   buffer and momentum bit for bit (again under cudnn.deterministic if
   cuDNN's algorithm choice breaks that); the graph pool, peak and ms of
   each.  (c) under cudnn.deterministic: 3 steps of resnet50_v2, save
   the checkpoint, 2 more; a fresh trainer loads it and takes 2 steps,
   bit for bit the uninterrupted run; loaded into the first trainer in
   place, its captured step builds nothing and gives the same bits;
   the save and load seconds and the bytes.  (d) ZeRO at dp = 2 on
   ResNet-50 V1 fused (bf16, batch 256, 128 a rank): 2 rank processes
   of this script (--zero-rank r, spawned as phase 6 spawns its ranks;
   gloo on one card, NCCL on two or more) take 2 steps with
   MXNET_ZERO_STATES on and off from the same weights: a rank's
   optimizer-state bytes within 0.45-0.55 of the replicated ones, the
   weights, running statistics and full momenta bit for bit ZeRO-off's
   and the other rank's, 52 + 46 launches a step a rank; the rank ms a
   step both ways.  (e) SGD with multi_precision on the bf16 ResNet-50
   V1, fused and captured: a replayed step's fp32 masters and momenta
   bit for bit sgd_mom_update on fp32 values (the step's gradient,
   computed eagerly from the same state under cudnn.deterministic), the
   bf16 weight the master rounded; its ms against phase 5's captured
   step.  (f) the 21 zoo constructors besides ResNet V1 and MobileNet:
   fp32 eval forwards on the card within 2e-4 of max|CPU| of the CPU's
   at batch 1, then bf16 at batch 32 (inception at 299²) hybridized, the
   captured forward's ms against eager; resnet50_v2 and vgg16 served through
   export_model -> ModelRepository -> InferenceServer, 8 requests each,
   within 2e-2 (relative L2) of the direct forward.  (g)
   resnet18_v2(thumbnail=True, classes=10) on synthetic CIFAR-10
   through DataLoader(num_workers=2, worker_pool="process") with
   RandomFlipLeftRight -> ToTensor -> Normalize and the hybridized
   gluon.Trainer loop (SGD lr 0.05, momentum 0.9), one epoch at batch
   128: the batches bit for bit those of num_workers=0 under the same
   seed, samples/s, the share of the epoch spent waiting for data, and
   the loss of the last 4 batches under the first 4's.
18. the image data path (phase_imagenet; it needs phase 2's build):
   the card machine's OpenCV headers and libraries, its cores and the
   native libraries' build (mxnet_tpu_torch/native, g++ into
   build/torch_native; the route and the build's error are printed
   either way).  (a) examples/imagenet_train.py's flow at full width:
   its synthetic tree (1000 classes x 3 JPEGs of 256², quality 90, seed
   0) packed by the port's im2rec (short edge 240, every core), then
   the example itself: ResNet-50 v1 (1000 classes, bf16, NHWC, fused,
   captured) through SPMDTrainer (SGD lr 0.1, momentum 0.9, wd 1e-4)
   fed by ImageRecordIter (batch 256, 224² random crops of the short
   edge resized to 232, random mirror, the example's mean and std,
   shuffled through the .idx, preprocess_threads = the cores), 2 epochs
   of 12 steps (the last batch pads 72): the route is the native
   pipeline where the image library built, 52 + 46 launches a step,
   finite losses with the second epoch's mean under the first's, the
   second epoch in another order; images/s end to end, ms a step beside
   phase 5's captured step, the data-wait share (the host clock inside
   next()) and the host-to-card copy's ms a batch (CUDA events around
   the copy, permute and cast).  A batch of 16 from ImageRecordIter
   (centre crops, no resize or mirror) is bit for bit the Python
   route's host decode of the same records.  (b) bench_pipeline's
   measurement on 512 of those records: images/s at 1, 2, 4, ...
   threads up to the cores through the native pipeline and through the
   Python route.  (c) examples/ssd_train.py --rec (SSD-300 ResNet-50,
   batch 8) over 64 synthetic JPEGs with 1-3 boxes each packed by
   im2rec --pack-label: 8 steps with finite losses, each batch's boxes
   those of its records (or mirrored).  (d) brightness, contrast and
   saturation at fixed factors on the card against the CPU (one uint8
   step; float32 within 2^-24 * 4 * S, S the blend's terms), and the
   random image ops' coins and factors over 512 calls on the card's
   generator.  It prints its seconds.
19. int8 quantization and the contrib vision ops (phase_quant; it needs
   phase 2's build, phase 10's detection inputs and phase 11's trained
   weights): (a) the int8 kernel (csrc/int8_conv.cu) against its plain
   version (the convolution in float64 on the card, cast to int32) bit for
   bit at each of the 20 distinct convolutions of resnet50_v1_sym (53
   layers) at batch 64 and 224², NCHW, and at its FC (64 x 2048 -> 1000,
   a 1x1 convolution over a 1x1 image; torch._int_mm beside it, equal),
   two launches bit-identical, then Ci = 3 7x7/2, num_group 32, depthwise,
   dilation 2, NHWC and a ragged shape; kernel_ms from CUDA-graph replays
   of the launch alone, op_ms the whole wrapper call, bound_ms max(2·M·Co·K
   / 1979 TOP/s, bytes of x, w and the int32 y / 3.35 TB/s), no library
   call for a convolution (PyTorch has no int8 convolution on CUDA).
   (b) the NMS kernel (csrc/nms.cu): MultiBoxDetection on phase 10's
   batch-32 inputs at nms_topk 100 and -1 through the op (one kernel
   launch and no run of the Python loop on CUDA tensors a detection; its
   ms beside the Python loop's), and the keep masks of the kernel, the plain
   loop on the card and the plain loop on the CPU identical there, at
   Proposal's 6000 candidates (force_suppress, the +1 IoU), and in
   float16, bfloat16 and float64 (K 300 and 1100; SSD's detection in
   float16 beside its float32 class ids).  (c) the
   ResNet-50 phase 11 trained, quantized by contrib.quantization
   (53 convolutions and the FC; entropy calibration over 1 batch of 64,
   naive if that takes over 60 s) and bound with sym.bind: 53
   convolution and 1 FC kernel launches a captured forward to the logits,
   each counted on its own, captured against eager bit for bit, its ms
   against the fp32 forward's.  On 8 of the eval images the quantized
   graph runs node by node on the CPU from the card's inputs of each node
   (integer outputs within one step, float outputs within 1e-5 of their
   scale), and whole on the CPU (logits within 5% of their largest
   magnitude; the int8 activations' steps apart counted); top-1 agreement
   and the logits' relative L2 error against fp32 printed, with no bound
   (naive's beside it).  The same quantize_model calls on the CPU give
   the same graph node for node and the same int8 weights bit for bit;
   naive's ranges and entropy's calibration samples within 1e-5 of each
   tensor's largest magnitude (entropy's ranges printed: a flat KL
   minimum moves with the last bits of the activations).  (d)
   examples/quantize_model.py
   at its full size in each calibration mode, each within its own 5%
   accuracy limit.  (e) MultiProposal at batch 2 on a 38 x 63 map (a 600
   x 1000 image at stride 16), 12 anchors, 6000 -> 300, card against CPU
   (scores and kept rows equal, boxes within 1e-5 relative); its rois
   (16 of each image) into ROIAlign (14x14, 1024 channels, 1/16, sample
   ratio 2), ROIPooling (7x7) and PSROIPooling (21 classes, group 7),
   AdaptiveAvgPooling2D to 1, 2, 3, 6 over 2048 x 60 x 60,
   BilinearResize2D, fft and ifft: forward and gradient card against CPU
   within 1e-5 of the CPU's largest magnitude; boolean_mask equal; ROIAlign
   over all 600 rois timed.  It prints its seconds.
20. custom_onnx (user-defined operators, control flow and ONNX; no kernel
   of its own, and no kernel of an earlier path on it): (a) phase 11's
   ResNet-50 v1 symbol (its trained weights, or seeded ones when phase
   11 did not run) exported to ONNX (bytes and seconds printed), checked
   by torch._C._check_onnx_proto, read by get_model_metadata, imported
   (parameters on cpu()) and bound by Module(for_training=False) on the
   card: its captured batch-64 forward within 1e-6 relative L2 of the
   original symbol's and the same argmax, both timed.  (b) The same
   network with sym.Custom(fc, softmax_label, op_type="softmax") as its
   head (reference MXNet's custom softmax, nd ops on the card,
   need_top_grad=False) through Module.fit, 3 batches of 64; then 3
   eager steps from one state against the SoftmaxOutput net, all
   leaves' updates within twice the step's own sensitivity (the larger
   of two SoftmaxOutput runs' distance and of a run from weights moved
   by 2^-24 relative); every Custom step an eager entry (custom_eager)
   with one user forward; its ms beside the SoftmaxOutput step's
   captured and eager ms; the host-style sigmoid in a hybridized block,
   forward and backward, and three SPMDTrainer steps over it (each an
   eager entry), card against CPU within 1e-5.  (c) The
   PTB-medium LM (2 x 650 LSTM, 35 steps, vocabulary 10,000, batch 20)
   as two LSTMCells unrolled by contrib.foreach, against
   gluon.rnn.LSTM (the fused RNN op) on the same weights: loss within
   1e-5 and every gradient within 1e-4 relative L2; its hybridized
   gluon.Trainer loop captured bit for bit its eager loop; both steps'
   ms.  (d) while_loop (false on entry too) and cond on array
   predicates, eagerly, under record() and in a hybridized block (an
   eager entry, counted), card against CPU within 1e-5.  It prints its
   seconds and one `custom_onnx: {...}` line.
21. item9 (runtime, storage, initialize, rtc, the profiler, Monitor,
   visualization, test_utils and the two NLP example scripts; no kernel
   of its own; alone: `python -c "import chip_smoke as c; card =
   c.phase_device(); c.phase_build(); c.phase_item9(card)"`, which
   quantizes its own int8 forward when phase 19 did not run): (a)
   runtime.Features()
   (CUDA, CUDNN, NCCL and DIST_KVSTORE on, the whole table printed),
   storage.memory_info(gpu(0)) against torch.cuda.mem_get_info,
   live_array_bytes up and down by a 256 MiB NDArray, storage.configure
   refused after CUDA's initialisation, signal_handlers_enabled() against
   MXNET_USE_SIGNAL_HANDLER, mx.rtc.CudaModule refused; a child process
   with MXNET_GPU_MEM_POOL_RESERVE=25 and storage.configure(preallocate=
   True) holds at its first CUDA use between half and 75% of the card
   reserved, serves a half-card tensor without growing it, and is
   refused 80% of the card.  (b) The
   profiler: 5 rounds of 7 nd calls give dumps() rows of exactly 5 each
   and a dump() of 35 events; start_xla_trace around 2 replays of phase
   4's served batch-32 ResNet-50 forward (rebuilt from its seed and
   captured) with the op records on: the trace names kernel 1 104 times
   (also counted by replay) and holds none of start_xla_trace's warm-up
   kernels, nothing is built again and the outputs
   equal the untraced replay's bit for bit; then phase 19 (c)'s
   captured int8 forward: its ms by CUDA events over 5 replays, the
   device time of one traced replay by kernel name (shares only), and one
   eager forward traced with each graph op in a profiler range, its
   device time split into kernel 7, the rest of the int8 convolution's
   wrapper (the activations' NCHW->NHWC permute, the weight layout),
   quantize, requantize, dequantize and the rest.  (c) Module.fit of
   phase 11's ResNet-50 symbol (seeded weights, 4 batches of 64, SGD as
   phase 11) under cudnn.deterministic with Monitor(interval=2) and
   without: the final weights bit for bit, the same builds, every stat
   finite and equal to stat_func on the array read after its step;
   print_summary's total against the inferred shapes and plot_network's
   DOT holding every non-parameter node.  (d) test_utils.check_consistency
   over [gpu(0), cpu(0)] (rtol 1e-4, atol 1e-4 of the case's largest
   CPU magnitude; besides, one run on each context made the same way
   gives each compared array's largest error, held to 2e-4 of that
   array's largest magnitude): sym.FusedConvUnit's outputs (kernel 1)
   and its nd form with the fused backward (kernels 1 and 2) at the 3x3
   64->64 layer (N 4, 56x56, act_in, statistics), Convolution,
   BatchNorm in training, LayerNorm and
   softmax at ResNet-50's and BERT-base's shapes (BatchNorm's and
   softmax's outputs projected on a fixed random tensor, since the
   gradients of their plain sums are zero), dot_product_attention
   at BERT-base's head shape in fp32 (kernel 5), each case's largest
   error printed; check_numeric_gradient of FullyConnected -> tanh on
   gpu(0).  (e) examples.bert_pretrain.main([]) (BERT-base, vocabulary
   30,522, batch 8 x 128, 8 steps, fp32, fixed batch: the last loss below
   the first) and examples.transformer_nmt.main(["--epochs", "1"])
   (Transformer-base, batch 32, buckets 16-128, 6 steps) in process:
   finite losses, every parameter and optimizer state on cuda:0, each
   step's ms and tokens/s printed.  It prints its seconds and one
   `item9: {...}` line.
22. MXNet's data-parallel API (ROADMAP queue A item 7, cut (a); no
   kernel of its own; alone: `python -c "import chip_smoke as c; card =
   c.phase_device(); c.phase_build(); c.phase_kvstore(card)"`).  (a) Two
   ranks started by the port's launcher (`mxnet_tpu_torch/tools/launch.py
   -n 2 --launcher local`; gloo with both on
   cuda:0 on one card, NCCL on cuda:0..1 on two or more), started once
   for phases 22-24 (kv_shard_rank: kv_rank's work, then shard_rank's,
   each part's exit code in its record; the launch is timed as its own
   step, "22-24 ranks", and each phase adds its part's seconds to its
   own for its limit), train
   full-width ResNet-50 v1 (fused, bf16, NHWC, a rank's batch 32, SGD lr
   0.1, momentum 0.9, wd 1e-4, build_net's seeded weights) through
   gluon.Trainer(kvstore='dist_sync') in five cases, one warm-up and 2
   counted steps each, in the same two processes: the update on the
   store (the default), update_on_kvstore=False (pushpull_fused),
   spmd=True (ZeRO-1, each rank half of every large state), 2-bit
   compression (threshold 0.5), spmd=True with MXNET_COMM_QUANT=int8 and
   error feedback.  Per case a rank's ms a step (and their spread), its
   launches of kernels 1 and 2 (52 + 46 a step), its optimizer-state and
   residual bytes.  This process then computes each case's reference on
   the card from the same weights and half-batches: each half's forward
   and backward apart, the two gradients summed (each through the plain
   2-bit or int8 round trip, with its residual, where the case has one),
   one eager SGD update (and the int8 weight leg); every weight bit for
   bit the reference's, each rank's running statistics bit for bit its
   half's, the ranks' weights bit-identical, and cases 1-3 bit for bit
   each other.  (b) Replicas in one process: with two or more cards,
   ResNet-50 on [gpu(0), gpu(1)] through split_and_load and
   Trainer(kvstore='device') bit for bit (a)'s pushpull_fused weights;
   with one card, examples/mnist.py's MLP on [gpu(0), cpu(0)] within
   1e-5 relative L2 of the same steps on [cpu(0), cpu(1)].  It prints
   its seconds (limit 90 s) and one `kvstore: {...}` line; kernels 1 and
   2 are then checked at the per-rank shapes (N = 32, with statistics).
23. Sharded meshes (ROADMAP queue A item 7, cut (b); no kernel of its
   own; alone: `python -c "import chip_smoke as c; card =
   c.phase_device(); c.phase_build(); c.phase_sharded(card,
   c.phase_kernels_attention(card))"`, which also runs phase 22's rank
   work).  The two ranks phase 22 started (gloo on cuda:0 with one card,
   NCCL on cuda:0..1 with two or more) run, after phase 22's work: (c)
   SPMDTrainer.forward of BERT-base (bf16, Normal(0.02) weights from a
   seed) at dp = 2, each rank its 16
   rows, which must come back as the global batch of 32 and lie within
   2e-2 relative L2 of this process's dp = 1 forward; (a) config 3's
   BERT-base step (bf16, batch 32 x 128, Adam lr 1e-4, dropout 0)
   through SPMDTrainer with DEFAULT_RULES under make_mesh(fsdp=2) and
   under make_mesh(tp=2): step 1's loss (relative) and the updated
   word_embed, layer 0's query and ffn_2 weights and their Adam means
   (relative L2; the mean catches an n-fold gradient) within 2e-2 of a
   dp = 1 step of the same weights and batch in this process; then 2
   counted steps with the kernel counters at 0, 12 kernel-5 launches a
   step on each rank; ms a step, each rank's trained-parameter bytes
   (fsdp: 0.45-0.55 of dp = 1's; every split tensor exactly halved),
   optimizer-state bytes and peak memory; (b) the long-context LM of
   mxnet_tpu_torch/examples/long_context_lm.py at its width (64 units, 4
   heads, 2 layers, vocabulary 512, batch 4) at L = 8192 on dp = 1 x
   sp = 2 (4096 tokens a rank), by ring and by Ulysses, 10 Adam steps:
   step 0's loss within 1e-4 of an sp = 1 step of the same weights in
   this process, the loss falling, the ranks' losses equal; ms a step and
   peak memory.  Kernel 5 is checked at the fsdp ranks' shape (batch
   16).  It prints its seconds (limit 90 s, phase 24's work in its ranks
   left out) and one `sharded: {...}` line, and adds kernel 5's
   launches on both paths to the kernels line.
24. Expert and pipeline parallelism (ROADMAP queue A item 7, cut (c); no
   kernel of its own; it needs phase 23, whose two ranks run its cases
   (a)-(c) after their own work, and whose parent leaves it BERT-base).
   (a) parallel.pipeline_apply at pp = 2: BERT-base's 12 encoder layers
   (bf16, the phase-23 weights) as two stages of six, config 3's batch
   of 32 x 128 (seeded hidden states, every key valid) as 4
   microbatches of 8, dropout 0; the forward and the gradients of the
   stacked parameters and of the input for a seeded cotangent within
   2e-2 relative L2 of this process's run of the two stages one after
   the other, both ranks bit for bit alike, 30 kernel-5 launches a call
   on each rank (6 layers x the 5 GPipe ticks, the bubble ticks
   included); ms a call and peak memory a rank.  (b) parallel.moe_apply
   with eight BERT-base FFN experts (768 -> 3072, GELU, -> 768, bf16,
   Normal(0.02)) on 4096 seeded hidden states, gate logits from a seeded
   768 -> 8 router whose Normal(1) bias overfills some experts, capacity
   factor 1.25 (capacity 640): at ep = 2 (four experts a rank) and at
   dp = 2 (2048 rows a rank), y and the gradients of x, the logits and
   the stacked weights within 2e-2 relative L2 of an ep = 1 call here
   (under dp = 2 each rank's rows, the weights' gradients summed over the
   ranks), dropped_frac in (0, 1) and equal; ms a call.  (c)
   config 5's Transformer-base step (bf16, Xavier, Adam, dropout 0) at
   dp = 2 on batch 64 x 64 with the target lengths drawn per row: step
   1's loss and the updated tied embedding, layer 0's query and ffn_1
   weights and their Adam means within 2e-2 of a dp = 1 step here;
   kernel 5's launches a step on each rank those of dp = 1; ms a step.
   (d) parallel.HeteroPipeline in this process: ResNet-50 v1 (bf16,
   NHWC, fused units with the fused backward) cut into three stages at
   its features children (stem and stage 1; stages 2-3; stage 4 and the
   head), each a pure torch.func.functional_call of its blocks in
   training mode (running statistics read, never written), on cuda:0 or
   round-robin over the cards; batch 256 as 4 microbatches of 64:
   pipe(x) against the unsplit net on the same microbatches,
   value_and_grad of softmax cross-entropy against a plain loop over
   them (whether bit for bit is printed), 208 kernel-1 launches in the
   forward, 416 kernel-1 (the recompute's included) and 184 kernel-2
   launches in value_and_grad, the running statistics unchanged.
   Kernel 5 is checked at (a)'s and (c)'s shapes and kernels 1 and 2 at
   N = 64.  It prints its seconds (its rank work included; limit 60 s)
   and one `parallel_c: {...}` line, and adds its launches of kernels 5,
   1 and 2 to the kernels line.

The compiled paths (mxnet_tpu_torch._graphs): every SPMDTrainer step on one
device, every hybridized forward in inference and under record() (a
forward and a backward graph) and gluon.Trainer's update run from CUDA
graphs captured once per signature, so the main
paths above are the captured ones (their launch counters count each
replay's launches); single steps of fresh trainers that only feed a
comparison run eagerly (_graphs.no_capture).  Each compiled path
is then held against its eager path in the same call:
  4/4b. the direct batch-32 ResNet-50 and BERT-base forwards: outputs bit
     for bit, 52 kernel-1 and 12 kernel-5 launches a call on both;
  5. the fused (52 + 46 launches a step) and the op-granular bf16 batch
     256 SPMDTrainer steps, 3 replays from one state against 3
     `_step_eager` steps from it: losses, parameters, running
     statistics, momenta and the generator state bit for bit, no build
     after set_learning_rate; then load_parameters moves every
     parameter's storage: one counted new capture, one eviction, and its
     steps equal eager steps;
  8. gluon.Trainer's captured update against fuse_step=False, 4 steps
     from phase 5's weights: every parameter, buffer, momentum and loss
     bit for bit, 52/46 launches a step, one build; the hybridized
     forward and backward (the CachedOp's training-mode pair) against
     no_capture, as above;
  9. BERT-base at dropout 0.1 and 0 (12 kernel-5 launches a step) and
     Transformer-base at dropout 0.1, as in 5, and with dropout two
     replays from two generator states give two losses.
The fused ResNet-50 step of 5 and the dropout-0 BERT step of 9 then
each replay once more with mx.profiler running: the same launches (52 +
46, 12), no new build and no new graph.
Each prints the captured and the eager ms, the idle share of each (one
profiled call), the captures' seconds and the graph pools' GiB, beside
the card's name and power limit.

The line before the last is the kernel summary {"kernels": [...]}, one
entry per kernel and main path (kernel 1 served, trained, trained
through gluon.Trainer in phase 8 and per rank under dp, kernel 2
trained, trained through gluon.Trainer and per rank under dp, kernel 5
on the BERT serving path, on phase 9's dropout-0 BERT step and on its
greedy decode, kernel 6 on the probe path: summed over the 27
configurations of one time sweep, with ms_by_nb; kernels 1 and 2 on
phase 8's captured hybridized gluon.Trainer loop and kernel 5 on phase
12's BERT-base gluon loop at dropout 0; kernel 5 on phase 13's LAMB
BERT-base step and kernels 1 and 2 on its centred-RMSProp ResNet-50
step; kernels 1, 2 and 5 through phase 11's sym nodes, one call each;
kernels 1 and 2 under phase 17's remat, ZeRO at dp = 2 and
multi_precision steps and on phase 18's ImageNet-format training; the
int8 kernel on phase 19's quantized ResNet-50 (its convolutions and its
FC) and the NMS kernel on SSD's detection at both caps and on
MultiProposal; kernels 1 and 2 on a rank of phase 22's
gluon.Trainer(kvstore='dist_sync') step), from the checks at that path's
shapes; the last line is
{"ok": true, "device": {"platform": "gpu", ...}}.
"""
from __future__ import annotations

import contextlib
import json
import math
import os
import subprocess
import sys
import threading
import time

import torch
import torch.nn.functional as F

PEAK_BF16 = 989e12     # dense bf16 tensor-core FLOP/s, H100 SXM
PEAK_FP32 = 67e12      # fp32 FLOP/s outside the tensor cores
PEAK_BYTES = 3.35e12   # HBM3 bytes/s
BATCH = 32
REQUESTS, THREADS = 128, 8   # single-image requests, client threads
KERNEL = {"name": "fused_conv_unit", "route": "cuda",
          "source": "mxnet_tpu_torch/csrc/fused_convbn.cu",
          "replaces": "mxnet_tpu/ops/pallas_convbn.py:156"}
# phase 3's extra kernel-1 cases, all with statistics: name, N, hw, Ci,
# Co, k, s, p, act_in, dtype, in_bias (None: random); the edge cases hold
# M off every tile (N=3 at 7x7), Co and Ci off 64, padding after a
# strongly negative and a positive affine, and one image at 56x56
UNIT_EXTRAS = [
    ("fp32.s2.conv2", BATCH, 28, 128, 128, 3, 1, 1, True, torch.float32,
     None),
    ("fp32.s3.conv1.first", BATCH, 28, 512, 256, 1, 2, 0, False,
     torch.float32, None),
    ("basic.3x3s2", BATCH, 56, 64, 128, 3, 2, 1, True, torch.bfloat16, None),
    ("edge.n3.7x7", 3, 7, 512, 512, 3, 1, 1, True, torch.bfloat16, None),
    ("edge.co72", 8, 14, 64, 72, 1, 1, 0, True, torch.bfloat16, None),
    ("edge.ci40", 8, 14, 40, 64, 3, 1, 1, True, torch.bfloat16, None),
    ("edge.3x3s2.bias-1.5", 8, 28, 64, 128, 3, 2, 1, True, torch.bfloat16,
     -1.5),
    ("edge.3x3s2.bias+2.0", 8, 28, 64, 128, 3, 2, 1, True, torch.bfloat16,
     2.0),
    ("edge.n1.56x56", 1, 56, 64, 64, 3, 1, 1, True, torch.bfloat16, None)]
DETERMINISM_CASES = ("basic.3x3s2", "edge.n3.7x7", "edge.ci40")
KERNEL_TAP = {"name": "candidate_tap", "route": "cuda",
              "source": "mxnet_tpu_torch/csrc/convbn_tap.cu",
              "replaces": "tools/scratch_convbn_probe.py:17"}
KERNEL_BWD = {"name": "fused_conv_unit_bwd", "route": "cuda",
              "source": "mxnet_tpu_torch/csrc/fused_convbn_bwd.cu",
              "replaces": "mxnet_tpu/ops/pallas_convbn.py:283"}
TRAIN_BATCH, TRAIN_STEPS = 256, 2     # bench.py's batch; timed steps a mode
TRAIN_FP32_BATCH = 8
TRAIN_OPT = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4}
FWD_PER_STEP, BWD_PER_STEP = 52, 46   # fused units; the stride-1 ones
# one step, fused against op-granular and a higher-precision reference
# (see step_agreement): a leaf's update is checked where op-granular lands
# within LEAF_POWER of the reference
LEAF_POWER = 0.25
TRAIN_BOUNDS_FP32 = dict(loss=1e-5, rel=2.0, abs=1e-4)
TRAIN_BOUNDS_BF16 = dict(loss=2e-2, rel=1.25, abs=2e-2)
# phase 8: an fp32 gluon.Trainer step against the fused SPMDTrainer step
# from the same start, per checked leaf (relative L2)
TRAIN_IMPERATIVE_FP32 = 1e-5
KERNEL_ATT = {"name": "dot_product_attention", "route": "cuda",
              "source": "mxnet_tpu_torch/csrc/attention.cu",
              "replaces": "mxnet_tpu/ops/pallas_attention.py:102"}
# BERT-base serving (bench_all.py's sequence length): one kernel launch
# per encoder layer and served batch
BERT_SEQ, BERT_LAYERS, BERT_HEADS, BERT_UNITS = 128, 12, 12, 768
BERT_VOCAB = 30522
BERT_CHECKED = 16            # requests held against the CPU fp32 forward
BERT_HTTP_REQUESTS = 64      # 4b (a): predict requests over HTTP
BERT_HTTP_ROLLOVER = 48      # 4b (d): requests in flight across the swap
BERT_HTTP_DRAIN = 24         # 4b (e): requests queued when the drain starts
BERT_HTTP_HANG_S = 1.5       # 4b (e): the first batch's hang (chaos)
BERT_BOUNDS = {"bf16": 2e-2, "fp32": 1e-4}
# phase 6: bench.py's step data parallel over DP ranks; rows 3-4 of the
# TPU kernel table are kernels 1-2 per rank plus the sums over the ranks
DP = 2
DP_TIMEOUT = 480.0             # s, the ranks' whole run
DP_COLLECTIVE_TIMEOUT = 180.0  # s, one collective
# the device functions of kernels 1, 6, 5 and 2 as torch.profiler names them
KERNEL1_NAMES = ("::conv_unit_wgmma_kernel<", "::stats_reduce_kernel<0>(")
KERNEL6_NAMES = ("::tap_unit_wgmma_kernel<", "::stats_reduce_kernel<2>(")
# kernel 5's device functions: bf16, fp32
KERNEL5_NAMES = ("::attention_wgmma_kernel<", "::attention_fma_kernel(")
# kernel 2's device functions by part of its launch step (bf16; fp32 runs
# dgrad_fma_kernel and wgrad_fma_kernel)
KERNEL2_PARTS = {"fold": ("::fold_dy_kernel(",),
                 "dgrad": ("::dgrad_wgmma_kernel<", "::dgrad_fma_kernel("),
                 "wgrad": ("::wgrad_wgmma_kernel<", "::wgrad_fma_kernel("),
                 "reductions": ("::stats_reduce_kernel<1>(",
                                "::wgrad_reduce_kernel<")}
KERNEL2_NAMES = tuple(n for names in KERNEL2_PARTS.values() for n in names)
# phase 3's extra kernel-2 cases, bf16 unless noted: name, N, hw, Ci, Co,
# k, p, act_in, want_stats, dtype, in_bias (None: random); the edge cases
# hold M off every tile, Co off 8 and 64 (dy_tot's padded pitch, folded
# and copied), Ci off 64, padding after a strongly negative and a positive
# affine, one image at 56x56, and several wgrad splits with two gscale
# reduction passes
BWD_EXTRAS = [
    ("fp32.s2.conv2", BATCH, 28, 128, 128, 3, 1, True, True, torch.float32,
     None),
    ("nostats.s3.conv3", BATCH, 14, 256, 1024, 1, 0, True, False,
     torch.bfloat16, None),
    ("edge.n3.7x7", 3, 7, 512, 512, 3, 1, True, True, torch.bfloat16, None),
    ("edge.co72", 8, 14, 64, 72, 1, 0, True, True, torch.bfloat16, None),
    ("edge.co20", 8, 14, 64, 20, 3, 1, True, True, torch.bfloat16, None),
    ("edge.co20.nostats", 8, 14, 64, 20, 3, 1, True, False, torch.bfloat16,
     None),
    ("edge.ci40", 8, 14, 40, 64, 3, 1, True, True, torch.bfloat16, None),
    ("edge.bias-1.5", 8, 28, 64, 128, 3, 1, True, True, torch.bfloat16,
     -1.5),
    ("edge.bias+2.0", 8, 28, 64, 128, 3, 1, True, True, torch.bfloat16, 2.0),
    ("edge.n1.56x56", 1, 56, 64, 64, 3, 1, True, True, torch.bfloat16, None),
    ("edge.splits.passes", 16, 28, 128, 128, 3, 1, True, True,
     torch.bfloat16, None)]
BWD_DETERMINISM_CASES = ("s1.conv2", "edge.n3.7x7", "edge.co20",
                         "edge.ci40", "edge.splits.passes")
# phase 9: bench_all.py's configs 3 (BERT-base pretraining) and 5
# (Transformer-base NMT) trained with Adam through SPMDTrainer, then
# Transformer-base's greedy decoding (one encoder launch per layer, one
# causal and one cross launch per decoder layer and step)
BERT_TRAIN_LR, NMT_TRAIN_LR = 1e-4, 3e-4
TRAIN_TIMED_STEPS = 5            # after one warm-up step
NMT_LAYERS, NMT_HEADS, NMT_UNITS = 6, 8, 512
DECODE_BATCH, DECODE_SRC, DECODE_MAX_LEN = 64, 64, 32
DECODE_FP32_BATCH = 4
KERNEL_ATT_BERT = dict(KERNEL_ATT, name="dot_product_attention/bert_train")
KERNEL_ATT_DECODE = dict(KERNEL_ATT,
                         name="dot_product_attention/greedy_decode")
# phase 10: bench_all.py's config 4 (SSD-300-ResNet50) through SPMDTrainer
# (sgd lr 0.01, momentum 0.9, wd 5e-4), its detection and the example
SSD_TIMED_STEPS = 3              # captured, after one warm-up step
SSD_CHECK_BATCH = 4              # (c): the fp32 card step against the cpu
SSD_BOUNDS = dict(loss=1e-4, leaf=1e-3, bf16_loss=2e-2)
SSD_NMS_TOPK = (100, -1)         # the example's cap; the op's default
SSD_DET_TOL = 1e-6
SSD_EXAMPLE_ARGS = ["--batch-size", "8", "--steps", "3"]
# phase 11: MXNet's symbolic API (Module.fit of ResNet-50 v1 over mx.sym;
# the kernels through sym.dot_product_attention and sym.FusedConvUnit)
SYM_BATCH, SYM_FIT_BATCHES, SYM_TIMED_STEPS = 64, 4, 3
SYM_OPT = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4,
           "rescale_grad": 1.0 / 64}
SYM_CHECK_BATCH = 8
SYM_BOUNDS = dict(out=1e-4, all=1e-3, leaf=1e-3, leaf64=1e-9)
SYM_PREDICT = 128
SYM_CALLS = 3                    # forwards (b) and train steps (c)
SYM_UNIT = (32, 56, 64, 64, 3)   # N, hw, Ci, Co, k of (c)
KERNEL_DP = dict(KERNEL, name="fused_conv_unit/dp",
                 replaces="mxnet_tpu/ops/pallas_convbn.py:618")
KERNEL_BWD_DP = dict(KERNEL_BWD, name="fused_conv_unit_bwd/dp",
                     replaces="mxnet_tpu/ops/pallas_convbn.py:406")

# phase 14: the op surface; (c)'s distributions: attrs (the parameter
# rows of a _sample_* op under "params") and each row's analytic mean and
# variance
RESNET50_V1_PARAMS = 25557032
RANDOM_DRAWS = 1 << 22
RANDOM_DISTRIBUTIONS = {
    "_random_uniform": ({"low": -1.0, "high": 3.0}, [(1.0, 16 / 12)]),
    "_random_normal": ({"loc": 0.5, "scale": 2.0}, [(0.5, 4.0)]),
    "_random_randint": ({"low": -3, "high": 7}, [(1.5, 8.25)]),
    "_random_gamma": ({"alpha": 2.5, "beta": 0.7}, [(1.75, 1.225)]),
    "_random_exponential": ({"lam": 2.0}, [(0.5, 0.25)]),
    "_random_poisson": ({"lam": 3.5}, [(3.5, 3.5)]),
    "_random_bernoulli": ({"p": 0.3}, [(0.3, 0.21)]),
    "_random_gumbel": ({"loc": 0.5, "scale": 2.0},
                       [(0.5 + 2 * 0.5772156649015329, math.pi ** 2 / 1.5)]),
    "_random_laplace": ({"loc": -0.5, "scale": 1.5}, [(-0.5, 4.5)]),
    "_random_negative_binomial": ({"k": 3, "p": 0.4}, [(4.5, 11.25)]),
    "_sample_uniform": ({"params": [[-1.0, 2.0], [3.0, 2.5]]},
                        [(1.0, 16 / 12), (2.25, 0.25 / 12)]),
    "_sample_normal": ({"params": [[0.0, -3.0], [1.0, 0.5]]},
                       [(0.0, 1.0), (-3.0, 0.25)]),
    "_sample_gamma": ({"params": [[1.5, 4.0], [2.0, 0.5]]},
                      [(3.0, 6.0), (2.0, 1.0)]),
    "_sample_exponential": ({"params": [[0.5, 4.0]]},
                            [(2.0, 4.0), (0.25, 0.0625)]),
    "_sample_poisson": ({"params": [[1.5, 9.0]]}, [(1.5, 1.5), (9.0, 9.0)]),
    "_sample_negative_binomial": ({"params": [[2.0, 5.0], [0.5, 0.25]]},
                                  [(2.0, 4.0), (15.0, 60.0)]),
    "_sample_generalized_negative_binomial": (
        {"params": [[2.0, 4.0], [0.5, 0.25]]}, [(2.0, 4.0), (4.0, 8.0)]),
}

FAILURES = []
T_START = time.perf_counter()


def fail(msg):
    FAILURES.append(msg)
    print(f"FAIL: {msg}", flush=True)


# ---------------------------------------------------------------------------
# phase 1: device
# ---------------------------------------------------------------------------

def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False — "
                         "this script runs on a CUDA card only")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() \
        else f"{torch.cuda.get_device_name(0)}, power limit unknown"
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return card


# ---------------------------------------------------------------------------
# phase 2: build
# ---------------------------------------------------------------------------

def phase_build():
    from mxnet_tpu_torch import _kernels

    t0 = time.perf_counter()
    _kernels.build(force=True)
    _kernels.load()
    info = _kernels.last_build()
    if not info.get("built"):
        fail("build: the kernel library was not compiled in this run")
        return
    print(f"build: nvcc {info['seconds']:.2f} s, load "
          f"{time.perf_counter() - t0:.2f} s total -> {info['path']}",
          flush=True)
    for line in info.get("log", "").splitlines():
        if "registers" in line or "smem" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}", flush=True)


# ---------------------------------------------------------------------------
# phase 3: kernel against its plain version
# ---------------------------------------------------------------------------

def resnet50_unit_configs():
    """The 20 distinct fused-unit configurations of ResNet-50 v1 at 224x224
    with how often one forward launches each (16 bottlenecks x 3 convs +
    4 downsample convs = 52)."""
    cfgs = []
    in_c, hw = 64, 56
    for stage, (blocks, c) in enumerate(zip([3, 4, 6, 3],
                                            [256, 512, 1024, 2048]), 1):
        s = 1 if stage == 1 else 2
        ho = (hw - 1) // s + 1
        mid = c // 4
        cfgs += [
            (f"s{stage}.conv1.first", hw, in_c, mid, 1, s, 0, False, 1),
            (f"s{stage}.downsample", hw, in_c, c, 1, s, 0, False, 1),
            (f"s{stage}.conv2", ho, mid, mid, 3, 1, 1, True, blocks),
            (f"s{stage}.conv3", ho, mid, c, 1, 1, 0, True, blocks),
            (f"s{stage}.conv1.later", ho, c, mid, 1, 1, 0, False,
             blocks - 1),
        ]
        in_c, hw = c, ho
    return cfgs


def time_ms(fn, iters=10, warmup=2):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def graph_ms(fn, launches=10, reps=3):
    """Device time of one call of `fn`: CUDA events around replays of a
    CUDA graph that holds `launches` calls, so the host's time to enqueue
    them drops out."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    # torch.cuda.graph's capture, without the empty_cache it makes
    # before each one (about 23 ms, a few hundred times a run)
    cap = torch.cuda.Stream()
    with torch.cuda.stream(cap):
        g.capture_begin()
        try:
            for _ in range(launches):
                fn()
        finally:
            g.capture_end()
    torch.cuda.current_stream().wait_stream(cap)
    g.replay()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        g.replay()
    b.record()
    torch.cuda.synchronize()
    del g
    return a.elapsed_time(b) / (reps * launches)


def bf16_ordered(t):
    """bf16 bit patterns as integers ordered like the values."""
    i = t.contiguous().view(torch.int16).to(torch.int32)
    return torch.where(i < 0, -(i & 0x7FFF), i)


def bf16_ulp(t):
    """The spacing of bf16 numbers at |t| (fp32 tensor)."""
    a = t.abs().clamp_min(2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(a)) - 7)


def hold_unit(name, x, w, sc, bi, k, s, p, act_in, want_stats, got, ref):
    """A fused unit's (y, s1, s2) against its plain version's, by the
    tolerances of the docstring; w is (Co, Ci, k, k).  Returns (ok,
    max_abs_err, note)."""
    y, s1, s2 = got
    yr, s1r, s2r = ref
    ok = True
    err = (y.float() - yr.float()).abs()
    max_abs = float(err.max())
    if x.dtype == torch.bfloat16:
        u = (x.float() * sc + bi).clamp_min(0).to(x.dtype) if act_in else x
        mag = F.conv2d(u.permute(0, 3, 1, 2).float().abs(), w.float().abs(),
                       stride=(s, s), padding=(p, p)).permute(0, 2, 3, 1)
        slack = 4.0 * math.sqrt(k * k * x.shape[-1]) * 2.0 ** -24 * mag
        ulp = bf16_ulp(yr.float())
        frac1 = float((err <= ulp + slack).float().mean())
        # the same share held to 1 ulp without the slack, reported only
        frac1_bare = float((err <= ulp).float().mean())
        worst = float(((err - slack) / ulp).max())
        ulps = (bf16_ordered(y) - bf16_ordered(yr)).abs()
        if frac1 < 0.999 or worst > 2.0:
            ok = False
            fail(f"{name}: y within 1 ulp on {frac1:.5f} (< 0.999) or worst "
                 f"{worst:.2f} ulp (> 2)")
        ytol = (f"1ulp+slack {frac1 * 100:.3f}% 1ulp bare "
                f"{frac1_bare * 100:.4f}% worst {worst:.2f}ulp "
                f"maxbits {int(ulps.max())}")
        stat_rtol = 2e-3
    else:
        bad = err > 1e-4 + 1e-4 * yr.float().abs()
        if bool(bad.any()):
            ok = False
            fail(f"{name}: fp32 y off by {max_abs:.3g} on "
                 f"{int(bad.sum())} elements")
        ytol = f"max_abs {max_abs:.3g}"
        stat_rtol = 1e-4
    if want_stats:
        yf = yr.float()
        ref_abs1 = yf.abs().sum(dim=(0, 1, 2))
        d1 = (s1 - s1r).abs() / ref_abs1.clamp_min(1e-30)
        d2 = (s2 - s2r).abs() / s2r.abs().clamp_min(1e-30)
        if float(d1.max()) > stat_rtol or float(d2.max()) > stat_rtol:
            ok = False
            fail(f"{name}: stats rel err s1 {float(d1.max()):.3g} s2 "
                 f"{float(d2.max()):.3g} > {stat_rtol}")
    elif bool(s1.any()) or bool(s2.any()):
        ok = False
        fail(f"{name}: want_stats=False but s1/s2 are not all zero")
    return ok, max_abs, ytol


def check_unit(name, x, w, sc, bi, sh, k, s, p, act_in, want_stats):
    """Kernel vs plain version on one configuration; returns a record."""
    from mxnet_tpu_torch.ops import fused_convbn as fcb
    from mxnet_tpu_torch.tools.convbn_probe import unit_bound

    kernel, stride, pad = (k, k), (s, s), (p, p)
    args = (x, w, sc, bi, sh)
    kw = dict(kernel=kernel, stride=stride, pad=pad, act_in=act_in,
              want_stats=want_stats)
    got = fcb.fused_conv_unit(*args, **kw)
    torch.cuda.synchronize()
    ref = fcb.fused_conv_unit_ref(*args, kernel, stride, pad, act_in,
                                  want_stats)
    ok, max_abs, ytol = hold_unit(name, x, w, sc, bi, k, s, p, act_in,
                                  want_stats, got, ref)
    n, h, wd, ci = x.shape
    co = w.shape[0]
    bm, bn, _ = fcb.launch_plan(x.shape, co, kernel, stride, pad, x.dtype)
    # timings: kernel_ms the launch step (conv kernel and statistics
    # reduction) on OHWI weights, replayed from a CUDA graph, so the device
    # and not the host sets it; op_ms the whole wrapper call as the main
    # path makes it; the plain version and the library call on the same
    # inputs
    w_ohwi = fcb.weight_ohwi(w)
    kernel_ms = graph_ms(lambda: fcb._launch(x, w_ohwi, sc, bi, sh, kernel,
                                             stride, pad, act_in,
                                             want_stats))
    op_ms = time_ms(lambda: fcb.fused_conv_unit(*args, **kw))
    ref_ms = time_ms(lambda: fcb.fused_conv_unit_ref(
        *args, kernel, stride, pad, act_in, want_stats))
    u = (x.float() * sc + bi).clamp_min(0).to(x.dtype) if act_in else x
    u_nchw = u.permute(0, 3, 1, 2)
    library_ms = time_ms(lambda: F.conv2d(u_nchw, w, stride=stride,
                                          padding=pad))
    # the bound: x counts only the pixels some tap reads (a strided 1x1
    # conv skips 1 - 1/s^2 of them), each once
    rec = dict(name=name, dtype=str(x.dtype).replace("torch.", ""),
               shape=[n, h, wd, ci], co=co, k=k, s=s, p=p, act_in=act_in,
               want_stats=want_stats, ok=ok, max_abs_err=max_abs, tile=[bm, bn],
               kernel_ms=kernel_ms, op_ms=op_ms, ref_ms=ref_ms,
               library_ms=library_ms,
               **unit_bound(x.shape, co, kernel, stride, pad, x.dtype,
                            want_stats))
    print(f"  {name:<22} {rec['dtype']:<8} x{rec['shape']} co={co} k{k}s{s}"
          f"p{p} act={int(act_in)} stats={int(want_stats)} tile {bm}x{bn} | "
          f"kernel_ms={kernel_ms:.4f} op_ms={op_ms:.4f} ref_ms={ref_ms:.4f} "
          f"library_ms={library_ms:.4f} bound_ms={rec['bound_ms']:.4f} "
          f"({rec['bound_by']}) | {ytol} | {'ok' if ok else 'FAIL'}",
          flush=True)
    return rec


def make_unit_inputs(gen, n, hw, ci, co, k, dtype, dev):
    """Random inputs of one unit, drawn on the card from `gen`."""
    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)
    x = randn(n, hw, hw, ci).to(dtype)
    w = (randn(co, ci, k, k) / math.sqrt(ci * k * k)).to(dtype)
    sc = torch.rand(ci, generator=gen, device=dev) + 0.5
    bi = randn(ci) * 0.5
    sh = randn(co) * 0.1
    return x, w, sc, bi, sh


def phase_kernels():
    """Kernel 1 at the shapes each main path gives it: the 20 ResNet-50
    configurations at N=BATCH without statistics (a served batch) and at
    N=TRAIN_BATCH with them (a training step); then two fp32
    configurations and a 3x3 stride-2 one at N=BATCH."""
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(1234)
    recs = []
    for n, want_stats, path in ((BATCH, False, "serve"),
                                (TRAIN_BATCH, True, "train")):
        print(f"kernel vs plain version, N={n}, want_stats={want_stats} "
              f"({path}):", flush=True)
        for (name, hw, ci, co, k, s, p, act_in, count) \
                in resnet50_unit_configs():
            x, w, sc, bi, sh = make_unit_inputs(gen, n, hw, ci, co, k,
                                                torch.bfloat16, dev)
            rec = check_unit(name, x, w, sc, bi, sh, k, s, p, act_in,
                             want_stats)
            recs.append(dict(rec, count=count, path=path))
            if want_stats and name == "s1.conv2":  # two reduction passes
                check_deterministic(f"{path}.{name}", x, w, sc, bi, sh, k, s,
                                    p, act_in)
            del x, w
        torch.cuda.empty_cache()
    print("kernel vs plain version, extras and edge cases:", flush=True)
    for (name, n, hw, ci, co, k, s, p, act_in, dt, bias) in UNIT_EXTRAS:
        x, w, sc, bi, sh = make_unit_inputs(gen, n, hw, ci, co, k, dt, dev)
        if bias is not None:
            bi = torch.full_like(bi, bias)
        rec = check_unit(name, x, w, sc, bi, sh, k, s, p, act_in, True)
        recs.append(dict(rec, count=0, path="extra"))
        if name in DETERMINISM_CASES:
            check_deterministic(name, x, w, sc, bi, sh, k, s, p, act_in)
    check_refuses_ci()
    torch.cuda.empty_cache()
    return recs


def same_bits(outs_a, outs_b):
    """[bit-identical?] for each pair of output tensors of two launches."""
    torch.cuda.synchronize()
    return [torch.equal(u.view(torch.int16 if u.element_size() == 2
                               else torch.int32),
                        v.view(torch.int16 if v.element_size() == 2
                               else torch.int32))
            for u, v in zip(outs_a, outs_b)]


def check_deterministic(name, x, w, sc, bi, sh, k, s, p, act_in):
    """Two launches on the same inputs give bit-identical y, s1 and s2."""
    from mxnet_tpu_torch.ops import fused_convbn as fcb

    kw = dict(kernel=(k, k), stride=(s, s), pad=(p, p), act_in=act_in,
              want_stats=True)
    bits = same_bits(fcb.fused_conv_unit(x, w, sc, bi, sh, **kw),
                     fcb.fused_conv_unit(x, w, sc, bi, sh, **kw))
    print(f"  {name}: two launches bit-identical y {bits[0]} s1 {bits[1]} "
          f"s2 {bits[2]}", flush=True)
    if not all(bits):
        fail(f"{name}: two launches differ (y, s1, s2 identical: {bits})")


def check_refuses_ci():
    """bf16 with Ci % 8 != 0 raises MXNetError and launches nothing."""
    from mxnet_tpu_torch.base import MXNetError
    from mxnet_tpu_torch.ops import fused_convbn as fcb

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(5)
    x, w, sc, bi, sh = make_unit_inputs(gen, 2, 8, 12, 64, 3, torch.bfloat16,
                                        dev)
    before = fcb.launch_count()
    try:
        fcb.fused_conv_unit(x, w, sc, bi, sh, kernel=(3, 3), pad=(1, 1),
                            act_in=True)
        fail("fused_conv_unit: bf16 Ci=12 did not raise")
    except MXNetError as e:
        print(f"  bf16 Ci=12 raises: {e}", flush=True)
    if fcb.launch_count() != before:
        fail("fused_conv_unit: the refused call launched the kernel")


def kernel_summary(kernel, recs, path, launches):
    """One record of the `kernels` line for one kernel on one main path:
    times and bounds summed over the launches of one forward (served
    batch of BATCH) or one training step (batch TRAIN_BATCH), from the
    checks at that path's shapes, each configuration weighted by how
    often the path launches it.  `launches` is the count of the path's
    counted run."""
    main = [r for r in recs if r["path"] == path and r["count"]]
    tot = {k: sum(r[k] * r["count"] for r in main)
           for k in ("kernel_ms", "ref_ms", "library_ms", "bound_ms")}
    by_ops = sum(r["bound_ms"] * r["count"] for r in main
                 if r["bound_by"] == "operations")
    rec = dict(kernel, path=path, batch=main[0]["shape"][0],
               launches=launches,
               max_abs_err=max(r["max_abs_err"] for r in main),
               ms=tot["kernel_ms"], plain_ms=tot["ref_ms"],
               bound_ms=tot["bound_ms"],
               bound_by="operations" if by_ops >= tot["bound_ms"] / 2
               else "bytes",
               library_ms=tot["library_ms"])
    if all("op_ms" in r for r in main):  # kernel 1: the whole wrapper call
        rec["op_ms"] = sum(r["op_ms"] * r["count"] for r in main)
    return rec


def bwd_split(rows):
    """Kernel 2's device time in a profile's rows, by part of its launch
    step: {part: ms} over KERNEL2_PARTS."""
    return {part: sum(ms for ms, _, k in rows
                      if any(n in k for n in names))
            for part, names in KERNEL2_PARTS.items()}


def print_bwd_shares(tag, split, card):
    total = sum(split.values())
    if total <= 0:
        print(f"profile {tag}: kernel 2 not measured (no device time)",
              flush=True)
        return
    print(f"profile {tag}: kernel 2 " + ", ".join(
        f"{part} {ms / total:.1%}" for part, ms in split.items())
        + f" of its profiled time (shares only) [{card}]", flush=True)


def check_unit_bwd(name, x, w, sc, bi, sh, k, p, act_in, want_stats, gen,
                   card=None):
    """Backward kernel vs its plain version on one stride-1
    configuration; y comes from the forward kernel, the cotangents from
    `gen`.  With `card`, also the profiler's split of the launch step into
    its parts (shares).  Returns a record."""
    from mxnet_tpu_torch.ops import fused_convbn as fcb

    kernel, pad = (k, k), (p, p)
    dev = x.device
    y, _, _ = fcb.fused_conv_unit(x, w, sc, bi, sh, kernel=kernel, pad=pad,
                                  act_in=act_in, want_stats=True)
    co = w.shape[0]
    gy = (torch.randn(y.shape, generator=gen, device=dev)
          / math.sqrt(y.numel())).to(x.dtype)
    gs1 = torch.randn(co, generator=gen, device=dev) * 1e-4
    gs2 = torch.randn(co, generator=gen, device=dev) * 1e-4
    args = (x, w, sc, bi, sh, y, gy, gs1, gs2)
    kw = dict(kernel=kernel, stride=(1, 1), pad=pad, act_in=act_in,
              want_stats=want_stats)
    got = fcb.fused_conv_unit_bwd(*args, **kw)
    torch.cuda.synchronize()
    ref = fcb.fused_conv_unit_bwd_ref(*args, kernel, (1, 1), pad, act_in,
                                      want_stats)
    # Σ|terms| of each sum: the conv gradients of |dy| and |u|, |w| in fp32
    dy_abs = fcb._fold_dy(y, gy, sh, gs1, gs2, want_stats).float().abs()
    u_abs = fcb._affine_in(x, sc, bi, act_in).float().abs()
    du_mag, dw_mag = fcb._conv_grads(u_abs, w.float().abs(), dy_abs, (1, 1),
                                     pad, torch.float32)
    n, h, wd, ci = x.shape
    m_out = y.shape[0] * y.shape[1] * y.shape[2]
    sc_abs = sc.abs() if act_in else torch.ones_like(sc)
    ok, notes, max_abs = True, [], 0.0
    for tag, a, b, mag, klen in (
            ("gx", got[0], ref[0], du_mag * sc_abs, k * k * co),
            ("dw", got[1], ref[1], dw_mag, m_out)):
        a, b = a.float(), b.float()
        err = (a - b).abs()
        max_abs = max(max_abs, float(err.max()))
        slack = 4.0 * math.sqrt(klen) * 2.0 ** -24 * mag
        if x.dtype == torch.bfloat16:
            ulp = bf16_ulp(b)
            frac = float((err <= ulp + slack).float().mean())
            worst = float(((err - slack) / ulp).max())
            notes.append(f"{tag} 1ulp+slack {frac * 100:.3f}% worst "
                         f"{worst:.2f}ulp")
            if frac < 0.999 or worst > 2.0:
                ok = False
                fail(f"bwd {name}: {tag} within 1 ulp on {frac:.5f} (< 0.999)"
                     f" or worst {worst:.2f} ulp (> 2)")
        else:
            bad = err > 2.0 ** -23 * b.abs() + slack
            notes.append(f"{tag} max_abs {float(err.max()):.3g}")
            if bool(bad.any()):
                ok = False
                fail(f"bwd {name}: fp32 {tag} off on {int(bad.sum())} "
                     f"elements (max abs {float(err.max()):.3g})")
    if act_in:
        scale_x = (du_mag * x.float().abs()).sum(dim=(0, 1, 2))
        scale_1 = du_mag.sum(dim=(0, 1, 2))
        for tag, a, b, s in (("gscale", got[2], ref[2], scale_x),
                             ("gbias", got[3], ref[3], scale_1)):
            rel = float(((a - b).abs() / s.clamp_min(1e-30)).max())
            notes.append(f"{tag} rel {rel:.2g}")
            if rel > 1e-4:
                ok = False
                fail(f"bwd {name}: {tag} rel err {rel:.3g} > 1e-4")
    elif bool(got[2].any()) or bool(got[3].any()):
        ok = False
        fail(f"bwd {name}: act_in=False but gscale/gbias are not zero")
    # timings: kernel_ms the launch step (fold, dgrad, wgrad and the
    # reductions) replayed from a CUDA graph, so the device and not the
    # host sets it; op_ms the whole wrapper call as the main path makes it
    cargs = tuple(t.contiguous() for t in args)
    kernel_ms = graph_ms(lambda: fcb._launch_bwd(*cargs, kernel, pad, act_in,
                                                 want_stats))
    op_ms = time_ms(lambda: fcb.fused_conv_unit_bwd(*args, **kw))
    ref_ms = time_ms(lambda: fcb.fused_conv_unit_bwd_ref(
        *args, kernel, (1, 1), pad, act_in, want_stats))
    # yardstick: PyTorch's dgrad + wgrad convolutions on the same tensors
    u_nchw = fcb._affine_in(x, sc, bi, act_in).permute(0, 3, 1, 2)
    dy_nchw = fcb._fold_dy(y, gy, sh, gs1, gs2, want_stats).permute(
        0, 3, 1, 2)

    def library():
        torch.nn.grad.conv2d_input(u_nchw.shape, w, dy_nchw, padding=pad)
        torch.nn.grad.conv2d_weight(u_nchw, w.shape, dy_nchw, padding=pad)
    library_ms = time_ms(library)
    flops = 2.0 * (2.0 * m_out * co * k * k * ci)
    item = x.element_size()
    nbytes = (x.numel() * 2 + y.numel() * 2 + w.numel() * 2) * item
    peak = PEAK_BF16 if x.dtype == torch.bfloat16 else PEAK_FP32
    t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    plan = fcb.bwd_launch_plan(x.shape, co, kernel, pad, x.dtype, want_stats)
    shares = None
    if card is not None:
        with contextlib.redirect_stdout(None):
            prof = profile_device(lambda: fcb._launch_bwd(
                *cargs, kernel, pad, act_in, want_stats), name, "call", card,
                1.0, iters=3, top=0)
        if prof is not None:
            split = bwd_split(prof["rows"])
            total = sum(split.values())
            if total > 0:
                shares = {part: ms / total for part, ms in split.items()}
    rec = dict(name=name, dtype=str(x.dtype).replace("torch.", ""),
               shape=[n, h, wd, ci], co=co, k=k, p=p, act_in=act_in,
               want_stats=want_stats, ok=ok, max_abs_err=max_abs,
               kernel_ms=kernel_ms, op_ms=op_ms, ref_ms=ref_ms,
               library_ms=library_ms, bound_ms=max(t_ops, t_bytes),
               bound_by="operations" if t_ops >= t_bytes else "bytes",
               gflop=flops / 1e9, mbytes=nbytes / 1e6,
               dgrad_tile=list(plan.dgrad_tile),
               wgrad_tile=list(plan.wgrad_tile), splits=plan.splits,
               shares=shares)
    share_txt = "" if shares is None else " | " + " ".join(
        f"{part} {v:.0%}" for part, v in shares.items())
    print(f"  bwd {name:<18} {rec['dtype']:<8} x{rec['shape']} co={co} k{k}"
          f"p{p} act={int(act_in)} stats={int(want_stats)} dgrad "
          f"{plan.dgrad_tile[0]}x{plan.dgrad_tile[1]} wgrad "
          f"{plan.wgrad_tile[0]}x{plan.wgrad_tile[1]}/{plan.splits} | "
          f"kernel_ms={kernel_ms:.4f} op_ms={op_ms:.4f} ref_ms={ref_ms:.4f} "
          f"library_ms={library_ms:.4f} bound_ms={rec['bound_ms']:.4f} "
          f"({rec['bound_by']}){share_txt} | {'; '.join(notes)} | "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if name in BWD_DETERMINISM_CASES:
        check_deterministic_bwd(name, args, kw)
    return rec


def check_deterministic_bwd(name, args, kw):
    """Two launches on the same inputs give bit-identical gx, dw, gscale
    and gbias."""
    from mxnet_tpu_torch.ops import fused_convbn as fcb

    bits = same_bits(fcb.fused_conv_unit_bwd(*args, **kw),
                     fcb.fused_conv_unit_bwd(*args, **kw))
    print(f"  bwd {name}: two launches bit-identical gx {bits[0]} dw "
          f"{bits[1]} gscale {bits[2]} gbias {bits[3]}", flush=True)
    if not all(bits):
        fail(f"bwd {name}: two launches differ (gx, dw, gscale, gbias "
             f"identical: {bits})")


def check_refuses_ci_bwd():
    """bf16 with Ci % 8 != 0 raises MXNetError and launches nothing."""
    from mxnet_tpu_torch.base import MXNetError
    from mxnet_tpu_torch.ops import fused_convbn as fcb

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(6)
    x, w, sc, bi, sh = make_unit_inputs(gen, 2, 8, 12, 64, 3, torch.bfloat16,
                                        dev)
    y = torch.randn(2, 8, 8, 64, generator=gen, device=dev).to(x.dtype)
    before = fcb.bwd_launch_count()
    try:
        fcb.fused_conv_unit_bwd(x, w, sc, bi, sh, y, y.clone(),
                                kernel=(3, 3), pad=(1, 1), act_in=True)
        fail("fused_conv_unit_bwd: bf16 Ci=12 did not raise")
    except MXNetError as e:
        print(f"  bwd bf16 Ci=12 raises: {e}", flush=True)
    if fcb.bwd_launch_count() != before:
        fail("fused_conv_unit_bwd: the refused call launched the kernel")


def phase_kernels_bwd(card):
    """The backward kernel at the 14 stride-1 configurations of ResNet-50
    v1 at the training step's shapes (N=TRAIN_BATCH, bf16, want_stats
    on), each with the profiler's split of its launch step, then the
    extras and edge cases of BWD_EXTRAS."""
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(4321)
    recs = []
    cfgs = [c for c in resnet50_unit_configs() if c[5] == 1]
    if len(cfgs) != 14 or sum(c[8] for c in cfgs) != BWD_PER_STEP:
        fail(f"bwd: {len(cfgs)} stride-1 configurations launched "
             f"{sum(c[8] for c in cfgs)} times (want 14 and {BWD_PER_STEP})")
    print(f"backward kernel vs plain version, N={TRAIN_BATCH} (train), "
          f"then extras and edge cases:", flush=True)
    cases = [(name, TRAIN_BATCH, hw, ci, co, k, p, act_in, True,
              torch.bfloat16, None, count)
             for (name, hw, ci, co, k, s, p, act_in, count) in cfgs]
    cases += [c + (0,) for c in BWD_EXTRAS]
    for (name, n, hw, ci, co, k, p, act_in, stats, dt, bias, count) in cases:
        x, w, sc, bi, sh = make_unit_inputs(gen, n, hw, ci, co, k, dt, dev)
        if bias is not None:
            bi = torch.full_like(bi, bias)
        rec = check_unit_bwd(name, x, w, sc, bi, sh, k, p, act_in, stats,
                             gen, card=card if count else None)
        recs.append(dict(rec, count=count, path="train" if count else "extra"))
        del x, w
        torch.cuda.empty_cache()
    check_refuses_ci_bwd()
    return recs


# ---------------------------------------------------------------------------
# phase 3c: the attention kernel against its plain version
# ---------------------------------------------------------------------------

def key_mask(gen, rows, sk, lengths=None, zero_rows=0):
    """(rows, sk) 1/0 key mask: valid lengths from `gen` in [1, sk] (or
    the given ones), the first `zero_rows` rows at length 0."""
    if lengths is None:
        lengths = torch.randint(1, sk + 1, (rows,), generator=gen)
    lengths = torch.as_tensor(lengths).clone()
    lengths[:zero_rows] = 0
    return (torch.arange(sk)[None, :] < lengths[:, None]).float()


def check_attention(name, q, k, v, mask, causal, card, heads=None,
                    quiet=False):
    """The attention kernel against its plain version on one case.

    With `heads`, q/k/v are BERT's packed (B, S, heads*D) projections and
    the op runs as the main path calls it (mask (B, Sk)); else they are
    (BH, S, D) and `attend` runs (mask (BH, Sk)).  Tolerances: bf16
    |o - o_ref| <= 2 bf16 ulps of o_ref + 2^-8 * sum_k p_k |v_k| (one bf16
    rounding of each probability); fp32 <= 1e-5 * sum_k p_k |v_k|; a row
    whose keys are all masked is the mean of v over the real keys.
    Returns a record; `quiet` leaves the printing to the caller."""
    from mxnet_tpu_torch.ops import attention as att

    if heads is None:
        bh, s, d = q.shape
        qf, kf, vf, maskf = q, k, v, mask
        scale = 1.0 / math.sqrt(d)

        def run():
            return att.attend(q, k, v, mask, scale, causal)
    else:
        b, s, u = q.shape
        d = u // heads
        bh = b * heads

        def flat(x):
            return x.reshape(b, x.shape[1], heads, d).permute(
                0, 2, 1, 3).reshape(bh, x.shape[1], d)
        qf, kf, vf = flat(q), flat(k), flat(v)
        maskf = mask.repeat_interleave(heads, dim=0)
        scale = 1.0 / math.sqrt(d)

        def run():
            return att.dot_product_attention(q, k, v, mask, num_heads=heads,
                                             causal=causal)
    sk = kf.shape[1]
    out = run()
    torch.cuda.synchronize()
    if heads is not None:
        out = flat(out)
    ref = att.dot_product_attention_ref(qf, kf, vf, maskf.to(q.dtype), scale,
                                        causal)
    p = att._softmax(att._scores(qf, kf, maskf, scale, causal))
    spread = torch.matmul(p, vf.float().abs())
    o, r = out.float(), ref.float()
    err = (o - r).abs()
    if q.dtype == torch.bfloat16:
        lim = 2.0 * bf16_ulp(r) + 2.0 ** -8 * spread
    else:
        lim = 1e-5 * spread
    ok = bool(torch.isfinite(o).all()) and bool((err <= lim).all())
    worst = float((err / lim.clamp_min(1e-30)).max())
    dead = maskf.sum(dim=1) == 0
    dead_txt = ""
    if bool(dead.any()):
        mean_v = vf.float()[dead].mean(dim=1, keepdim=True)
        dev = float((o[dead] - mean_v).abs().max())
        dlim = (2.0 * bf16_ulp(mean_v) + 2.0 ** -8 * vf.float()[dead].abs()
                .mean(dim=1, keepdim=True)) if q.dtype == torch.bfloat16 \
            else 1e-5 * vf.float()[dead].abs().mean(dim=1, keepdim=True)
        dead_ok = bool(((o[dead] - mean_v).abs() <= dlim).all())
        ok = ok and dead_ok
        dead_txt = (f" | {int(dead.sum())} fully masked rows at the mean of "
                    f"v: max dev {dev:.3g} {'ok' if dead_ok else 'FAIL'}")
    if not ok:
        fail(f"attention {name}: kernel vs plain version off (worst "
             f"{worst:.3f} of the bound, max abs {float(err.max()):.3g})"
             f"{dead_txt}")
    # the kernel: launches through the wrapper's launch step on prepared
    # (B, H, S, D) views, so the device and not the op's Python sets the
    # pace; op_ms is the whole op call as the main path makes it
    if heads is None:
        q4, k4, v4 = qf[:, None], kf[:, None], vf[:, None]
        m4 = (maskf > 0)[:, None, None, :]
    else:
        q4, k4, v4 = (x.reshape(b, x.shape[1], heads, d).permute(0, 2, 1, 3)
                      for x in (q, k, v))
        m4 = (mask > 0)[:, None, None, :]
    out4 = att._out_buffer(q4, heads is not None)
    mk = mask.to(q.dtype)
    plan = att.launch_plan(*q4.shape[:3], sk, d, q.dtype)
    # kernel_ms: the launch step replayed from a CUDA graph (device time);
    # events_ms: the same launches timed by CUDA events around host calls,
    # where the host's pace shows
    kernel_ms = graph_ms(lambda: att._launch(q4, k4, v4, mk, scale, causal,
                                             out4))
    events_ms = time_ms(lambda: att._launch(q4, k4, v4, mk, scale, causal,
                                            out4), iters=20)
    op_ms = time_ms(run)
    ref_ms = time_ms(lambda: att.dot_product_attention_ref(
        qf, kf, vf, maskf.to(q.dtype), scale, causal))
    # yardstick the port never calls: PyTorch's fused attention on the
    # same (B, H, S, D) views, the key mask as a boolean (B, 1, 1, Sk),
    # and with `causal` the kernel's causal mask (last query on the last
    # key) as a boolean (S, Sk) folded into it
    if causal:
        qpos = torch.arange(s, device=q.device)[:, None] + (sk - s)
        m4 = m4 & (qpos >= torch.arange(sk, device=q.device)[None, :])
    library_ms = graph_ms(lambda: F.scaled_dot_product_attention(
        q4, k4, v4, attn_mask=m4))
    library_events_ms = time_ms(lambda: F.scaled_dot_product_attention(
        q4, k4, v4, attn_mask=m4))
    item = q.element_size()
    nbytes = (2 * bh * s * d + 2 * bh * sk * d) * item + mask.numel() * item
    flops = 4.0 * bh * s * sk * d
    peak = PEAK_BF16 if q.dtype == torch.bfloat16 else PEAK_FP32
    t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    rec = dict(name=name, dtype=str(q.dtype).replace("torch.", ""),
               bh=bh, s=s, sk=sk, d=d, causal=causal,
               layout="packed" if heads else "(BH,S,D)", ok=ok,
               max_abs_err=float(err.max()), worst_of_bound=worst,
               passes=plan.passes, kernel_ms=kernel_ms, events_ms=events_ms,
               op_ms=op_ms, ref_ms=ref_ms, library_ms=library_ms,
               library_events_ms=library_events_ms,
               bound_ms=max(t_ops, t_bytes),
               bound_by="operations" if t_ops >= t_bytes else "bytes",
               gflop=flops / 1e9, mbytes=nbytes / 1e6)
    if quiet:
        return rec
    print(f"  {name:<18} {rec['dtype']:<8} BH={bh} S={s} Sk={sk} D={d} "
          f"causal={int(causal)} {rec['layout']} passes={plan.passes} | "
          f"kernel_ms={kernel_ms:.4f} (events {events_ms:.4f}) op_ms="
          f"{op_ms:.4f} ref_ms={ref_ms:.4f} library_ms={library_ms:.4f} "
          f"(events {library_events_ms:.4f}) bound_ms={rec['bound_ms']:.4f} "
          f"({rec['bound_by']}) | max_abs {rec['max_abs_err']:.3g}, worst "
          f"{worst:.3f} of the bound{dead_txt} | {'ok' if ok else 'FAIL'} "
          f"[{card}]", flush=True)
    return rec


def check_attention_deterministic(name, q, k, v, mask, heads):
    """Two launches of the op on the same inputs give bit-identical
    outputs."""
    from mxnet_tpu_torch.ops import attention as att

    def run():
        return att.dot_product_attention(q, k, v, mask, num_heads=heads)
    same = same_bits([run()], [run()])[0]
    print(f"  {name}: two launches bit-identical {same}", flush=True)
    if not same:
        fail(f"attention {name}: two launches differ")


def phase_kernels_attention(card):
    """Kernel 5 at the BERT-base serving shapes (B*H = 32*12, S = Sk =
    128, D = 64, bf16; valid lengths from a seed in [1, 128], one row at
    0), as `attend` takes it and as the main path calls it (packed
    (B, S, 768) projections, a (B, Sk) mask), with two-launch bit
    identity; then one fp32 case, S = 200 with lengths [200, 77] (several
    query tiles, two passes, Sk not a multiple of 8), causal with S = 40,
    Sk = 72, D = 128, D = 72 (S = Sk = 300, causal) and D = 8, and the
    head-split layout."""
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(99)
    recs = {}

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(*shape, generator=gen).to(dev, dtype)
    print("attention kernel vs plain version:", flush=True)
    bh = BATCH * BERT_HEADS
    d = BERT_UNITS // BERT_HEADS
    s = BERT_SEQ
    q, k, v = (randn(bh, s, d) for _ in range(3))
    m = key_mask(gen, bh, s, zero_rows=1).to(dev)
    recs["bert.(BH,S,D)"] = check_attention("bert.(BH,S,D)", q, k, v, m,
                                            False, card)
    q, k, v = (randn(BATCH, s, BERT_UNITS) for _ in range(3))
    m = key_mask(gen, BATCH, s, zero_rows=1).to(dev)
    recs["bert.packed"] = check_attention("bert.packed", q, k, v, m, False,
                                          card, heads=BERT_HEADS)
    check_attention_deterministic("bert.packed", q, k, v, m, BERT_HEADS)
    q, k, v = (randn(48, s, d, dtype=torch.float32) for _ in range(3))
    m = key_mask(gen, 48, s, zero_rows=1).to(dev)
    recs["fp32"] = check_attention("fp32", q, k, v, m, False, card)
    q, k, v = (randn(2, 200, d) for _ in range(3))
    m = key_mask(gen, 2, 200, lengths=[200, 77]).to(dev)
    recs["s200"] = check_attention("s200.lens200,77", q, k, v, m, False,
                                   card)
    q = randn(8, 40, d)
    k, v = randn(8, 72, d), randn(8, 72, d)
    m = key_mask(gen, 8, 72).to(dev)
    recs["causal"] = check_attention("causal.s40.sk72", q, k, v, m, True,
                                     card)
    # the head widths the op takes besides BERT's 64: 128 and 72 (two
    # 64-column boxes, the second zero past D; 72 also with two passes
    # over Sk = 300, causal) and 8 (zero columns 8..15 of the one k16 step)
    for name, bh_, s_, sk_, d_, causal in (
            ("d128.s128", 16, 128, 128, 128, False),
            ("d72.s300.causal", 4, 300, 300, 72, True),
            ("d8.s128", 16, 128, 128, 8, False)):
        q = randn(bh_, s_, d_)
        k, v = randn(bh_, sk_, d_), randn(bh_, sk_, d_)
        m = key_mask(gen, bh_, sk_, zero_rows=1).to(dev)
        recs[name] = check_attention(name, q, k, v, m, causal, card)
    # head-split (B, H, S, D) input through the op
    from mxnet_tpu_torch.ops import attention as att

    q4, k4, v4 = (randn(4, BERT_HEADS, s, d) for _ in range(3))
    m = key_mask(gen, 4, s).to(dev)
    out = att.dot_product_attention(q4, k4, v4, m)
    torch.cuda.synchronize()
    ref = att.dot_product_attention_ref(
        *(x.reshape(-1, s, d) for x in (q4, k4, v4)),
        m.to(q4.dtype).repeat_interleave(BERT_HEADS, dim=0), 1 / math.sqrt(d))
    e = float((out.reshape(-1, s, d).float() - ref.float()).abs().max())
    same = bool(torch.equal(out.reshape(-1, s, d), att.attend(
        *(x.reshape(-1, s, d) for x in (q4, k4, v4)),
        m.repeat_interleave(BERT_HEADS, dim=0), 1 / math.sqrt(d))))
    print(f"  head-split (B,H,S,D) {tuple(q4.shape)}: max abs vs plain "
          f"{e:.3g}; bit-equal to the (BH,S,D) call: {same}", flush=True)
    if not same or not e < 0.05:
        fail(f"attention head-split layout: max abs {e:.3g}, equal to the "
             f"(BH,S,D) call: {same}")
    return recs


# ---------------------------------------------------------------------------
# phase 4: the main path — serve ResNet-50 v1
# ---------------------------------------------------------------------------

def rel_l2(a, b):
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def direct_forward(net, xs, fused, bs=BATCH):
    os.environ["MXNET_FUSED_CONVBN"] = "1" if fused else "0"
    outs = []
    with torch.inference_mode():
        for i in range(0, xs.shape[0], bs):
            outs.append(net(xs[i:i + bs]))
    torch.cuda.synchronize()
    return torch.cat(outs)


def build_net(dtype, seed, dev=None):
    from mxnet_tpu_torch import gpu, init
    from mxnet_tpu_torch.gluon.model_zoo import vision

    net = vision.resnet50_v1(classes=1000, layout="NHWC")
    net.initialize(init.Xavier(), ctx=dev or gpu(0), seed=seed)
    net.cast(dtype)
    net.hybridize()
    net.eval()
    return net


def serve(server, model, inputs, threads):
    """Submit one request per row of `inputs` (a tensor, or a list of
    tensors that share the row count) from `threads` client threads;
    returns (answers in row order, per-request latencies in s, wall s,
    errors).  A latency runs from submit to the future's completion."""
    xs = list(inputs) if isinstance(inputs, (list, tuple)) else [inputs]
    n = xs[0].shape[0]
    answers, t_sub, t_done = [None] * n, [0.0] * n, [0.0] * n
    errors = []

    def client(idx):
        futs = []
        for i in idx:
            t_sub[i] = time.perf_counter()
            f = server.submit(model, [x[i:i + 1] for x in xs])
            f.add_done_callback(
                lambda _f, i=i: t_done.__setitem__(i, time.perf_counter()))
            futs.append((i, f))
        for i, f in futs:
            try:
                answers[i] = f.result(timeout=300)
            except Exception as e:  # noqa: BLE001 — reported below
                errors.append(f"request {i}: {type(e).__name__}: {e}")

    chunks = [list(range(t, n, threads)) for t in range(threads)]
    t0 = time.perf_counter()
    ts = [threading.Thread(target=client, args=(c,)) for c in chunks]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    wall = time.perf_counter() - t0
    lat = sorted(d - s for s, d in zip(t_sub, t_done) if d)
    return answers, lat, wall, errors


def percentile_ms(sorted_s, q):
    if not sorted_s:
        return None
    return sorted_s[min(len(sorted_s) - 1,
                        int(round(q * (len(sorted_s) - 1))))] * 1e3


def phase_main(card, n_requests, threads):
    from mxnet_tpu_torch import serving
    from mxnet_tpu_torch.contrib import deploy
    from mxnet_tpu_torch.ops import fused_convbn as fcb

    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(7)
    images_f32 = torch.rand(n_requests, 224, 224, 3, generator=gen)
    result = {}
    # artifacts go under build/ in the checkout (listed in .gitignore)
    tmp = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                       "chip_smoke_deploy")
    repo = serving.ModelRepository()
    models = {}
    for dtype, tag in (("bfloat16", "bf16"), ("float32", "fp32")):
        net = build_net(dtype, seed=0)
        wdt = net.features[0].weight.data()._data.dtype
        ex = images_f32[:1].to(dev, wdt)
        path = os.path.join(tmp, tag)
        deploy.export_model(net, path, [ex], dynamic_batch=True)
        repo.add(f"resnet50_v1_{tag}", path)
        models[tag] = net
    server = serving.InferenceServer(
        repo, serving.ServingConfig(max_batch_size=BATCH,
                                    batch_timeout_ms=2))
    try:
        for tag, bound, n_req in (("bf16", 2e-2, n_requests),
                                  ("fp32", 1e-4, BATCH)):
            net = models[tag]
            dt = net.features[0].weight.data()._data.dtype
            imgs = images_f32[:n_req].to(dt)
            model = f"resnet50_v1_{tag}"
            # warm the served model (first launches, allocator, cuDNN,
            # and the capture of the full bucket, which the timed
            # requests fill)
            os.environ["MXNET_FUSED_CONVBN"] = "1"
            serve(server, model, imgs[:4], 2)
            repo.get(model).execute(BATCH, [imgs[:BATCH]])
            m = repo.get(model).metrics
            b0 = m.value("batches")
            fcb.reset_launch_count()
            answers, lat, wall, errors = serve(server, model, imgs, threads)
            launches = fcb.launch_count()
            batches = m.value("batches") - b0
            for e in errors[:5]:
                fail(f"{tag}: {e}")
            if any(a is None for a in answers):
                fail(f"{tag}: {sum(a is None for a in answers)} of {n_req} "
                     f"requests unanswered")
                continue
            if launches != 52 * batches:
                fail(f"{tag}: {launches} kernel launches for {batches} "
                     f"batches (want 52 per batch)")
            got = torch.cat([a.float() for a in answers]).to(dev)
            ref = direct_forward(net, imgs.to(dev), fused=False).float()
            err = rel_l2(got, ref)
            row_err = max(rel_l2(got[i], ref[i]) for i in range(n_req))
            finite = bool(torch.isfinite(got).all())
            shape_ok = tuple(got.shape) == (n_req, 1000)
            print(f"main path {tag}: {n_req} requests from {threads} threads"
                  f" in {batches} batches, {launches} kernel launches; "
                  f"served vs unfused rel L2 {err:.3g} (worst row "
                  f"{row_err:.3g}, bound {bound}); finite={finite} "
                  f"shape={tuple(got.shape)}", flush=True)
            if not (err < bound and row_err < bound and finite and shape_ok):
                fail(f"{tag}: served answers disagree with the unfused "
                     f"forward (rel L2 {err:.3g}, worst row {row_err:.3g}, "
                     f"bound {bound}, finite {finite}, shape "
                     f"{tuple(got.shape)})")
            p50, p99 = percentile_ms(lat, 0.50), percentile_ms(lat, 0.99)
            result[tag] = dict(requests=n_req, batches=batches,
                               launches=launches, wall_s=wall,
                               req_per_s=n_req / wall, p50_ms=p50,
                               p99_ms=p99, rel_l2=err,
                               worst_row_rel_l2=row_err)
            if tag == "bf16":
                result["launches"] = launches
            print(f"serving {tag}: {n_req / wall:.2f} requests/s, p50 "
                  f"{p50:.3f} ms, p99 {p99:.3f} ms (submit to answer), "
                  f"{n_req / max(batches, 1):.1f} rows per batch [{card}]",
                  flush=True)
    finally:
        server.shutdown(drain=True)
    # direct batch-32 forward throughput, fused and unfused, in turns
    net = models["bf16"]
    xb = images_f32[:BATCH].to(dev, torch.bfloat16)
    for fused in (True, False):
        direct_forward(net, xb, fused)
    rates = {True: [], False: []}
    for fused in (True, False, False, True):
        os.environ["MXNET_FUSED_CONVBN"] = "1" if fused else "0"
        with torch.inference_mode():
            ms = time_ms(lambda: net(xb), iters=5, warmup=1)
        rates[fused].append(BATCH / ms * 1e3)
    for fused in (True, False):
        print(f"direct forward bf16 batch {BATCH} "
              f"{'fused' if fused else 'unfused'}: "
              f"{' '.join(f'{r:.1f}' for r in rates[fused])} img/s "
              f"[{card}]", flush=True)
    result["img_per_s"] = {"fused": rates[True], "unfused": rates[False]}
    result["profile"] = {
        tag: profile_forward(net, xb, fused, card,
                             BATCH / (sum(rates[fused]) / 2) * 1e3)
        for tag, fused in (("fused", True), ("unfused", False))}
    os.environ["MXNET_FUSED_CONVBN"] = "1"
    result["compiled"] = hold_captured_forward(
        f"compiled: served forward resnet-50 bf16 batch {BATCH}", net, [xb],
        card, {"k1": 52})
    return result


def profile_forward(net, xb, fused, card, wall_ms, iters=3):
    """Device time by kernel over `iters` direct forwards."""
    os.environ["MXNET_FUSED_CONVBN"] = "1" if fused else "0"

    def run():
        with torch.inference_mode():
            net(xb)
    return profile_device(run, f"{'fused' if fused else 'unfused'} bf16 "
                          f"batch {xb.shape[0]}", "forward", card, wall_ms,
                          iters)


def profile_device(run, tag, what, card, wall_ms, iters=3, top=10,
                   host_prefix=None):
    """Device time by kernel over `iters` calls of `run` (torch.profiler).
    The profiler slows the host, so the idle share is taken against
    `wall_ms`, the time of one call measured without it.  With
    `host_prefix`, also the host time per call inside the ranges whose
    name starts with it.  A call that fails fails the run; a profiler
    that cannot start, stop or show device time prints "not measured"."""
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    try:
        prof.start()
    except Exception as e:  # noqa: BLE001 — auxiliary measurement
        print(f"profile {tag}: not measured ({type(e).__name__}: {e})",
              flush=True)
        return None
    stop_error = None
    try:
        for _ in range(iters):
            run()
        torch.cuda.synchronize()
    finally:
        try:
            prof.stop()
        except Exception as e:  # noqa: BLE001 — auxiliary measurement
            stop_error = e
    if stop_error is not None:
        print(f"profile {tag}: not measured ({type(stop_error).__name__}: "
              f"{stop_error})", flush=True)
        return None
    try:
        rows, host = [], [0.0, 0]
        for e in prof.key_averages():
            mine = bool(host_prefix) and e.key.startswith(host_prefix)
            # device-side events only (kernels, copies); CPU ops carry the
            # same time attributed to them and would count it twice, and
            # the device span of a named range repeats its kernels' time
            if not str(getattr(e, "device_type", "")).endswith("CUDA"):
                if mine:
                    host[0] += e.cpu_time_total / 1e3 / iters
                    host[1] += e.count // iters
                continue
            if mine:
                continue
            dev = getattr(e, "self_device_time_total", None)
            if dev is None:
                dev = getattr(e, "self_cuda_time_total", 0.0)
            if dev > 0:
                rows.append((dev / 1e3 / iters, e.count // iters, e.key))
        rows.sort(reverse=True)
        busy = sum(r[0] for r in rows)
        if busy <= 0:
            print(f"profile {tag}: device time not measured (profiler "
                  f"shows none)", flush=True)
            return None
        print(f"profile {tag}: device busy {busy:.3f} ms/{what}; against "
              f"the un-profiled {wall_ms:.3f} ms {what} the idle share is "
              f"{1 - busy / wall_ms:.1%} [{card}]", flush=True)
        for ms, n, key in rows[:top]:
            print(f"    {ms:8.3f} ms  x{n:<4d} {key[:90]}", flush=True)
        out = {"wall_ms": wall_ms, "busy_ms": busy,
               "top": [[ms, n, key[:120]] for ms, n, key in rows[:12]],
               "rows": rows}
        if host_prefix:
            out["host_ms"], out["host_calls"] = host
            print(f"profile {tag}: host time in {host_prefix}* "
                  f"{host[0]:.3f} ms/{what} in {host[1]} calls", flush=True)
        return out
    except Exception as e:  # noqa: BLE001 — auxiliary measurement
        print(f"profile {tag}: not measured ({type(e).__name__}: {e})",
              flush=True)
        return None


# ---------------------------------------------------------------------------
# phase 4b: the main path — serve BERT-base
# ---------------------------------------------------------------------------

def bert_requests(n, seed):
    """n single-sequence requests of BERT_SEQ tokens: ids from a seed,
    token types 0 then 1 from a random split, valid lengths in [16, 128]."""
    gen = torch.Generator().manual_seed(seed)
    tok = torch.randint(0, BERT_VOCAB, (n, BERT_SEQ), generator=gen,
                        dtype=torch.int32)
    split = torch.randint(1, BERT_SEQ, (n, 1), generator=gen)
    types = (torch.arange(BERT_SEQ)[None, :] >= split).to(torch.int32)
    vlen = torch.randint(16, BERT_SEQ + 1, (n,), generator=gen).float()
    return [tok, types, vlen]


def bert_forward(net, inputs, dev, bs=BATCH):
    """(seq, pooled) of a direct forward over `inputs`, `bs` rows at a
    time, on `dev`."""
    seqs, pooled = [], []
    with torch.inference_mode():
        for i in range(0, inputs[0].shape[0], bs):
            a, b = net(*[x[i:i + bs].to(dev) for x in inputs])
            seqs.append(a)
            pooled.append(b)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return torch.cat(seqs), torch.cat(pooled)


def http_call(base, path, body=None):
    """(status, body) of one request to a front end on localhost (no
    proxy from the environment); JSON bodies parsed."""
    import urllib.error
    import urllib.request

    opener = urllib.request.build_opener(urllib.request.ProxyHandler({}))
    data = None if body is None else json.dumps(body).encode()
    try:
        with opener.open(urllib.request.Request(base + path, data=data),
                         timeout=300) as r:
            code, raw, ctype = r.status, r.read(), r.headers["Content-Type"]
    except urllib.error.HTTPError as e:
        code, raw, ctype = e.code, e.read(), e.headers["Content-Type"]
    if ctype.startswith("application/json"):
        return code, json.loads(raw)
    return code, raw.decode()


def bert_body(reqs, i):
    """The predict body of request i: one row of each input, as JSON."""
    return {"inputs": [x[i:i + 1].tolist() for x in reqs]}


def parse_prometheus(text):
    """{(name, ((label, value), ...)): value} of a text exposition
    (format 0.0.4); raises ValueError on a line that is neither a
    comment nor a sample."""
    import re

    sample = re.compile(r'^([a-zA-Z_:][a-zA-Z0-9_:]*)(?:\{(.*)\})? (\S+)$')
    label = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')
    out = {}
    for line in text.splitlines():
        if not line or line.startswith("# HELP ") \
                or line.startswith("# TYPE "):
            continue
        m = sample.match(line)
        if m is None:
            raise ValueError(f"not a Prometheus sample: {line!r}")
        labels = tuple(label.findall(m.group(2) or ""))
        out[(m.group(1), labels)] = float(m.group(3))
    return out


def http_predicts(base, path, reqs, idx, threads, on_answer):
    """POST one predict body per request index in `idx` from `threads`
    client threads, `on_answer(i, status, body)` in the client thread;
    returns the sorted client latencies in s and the wall s."""
    lat = {}

    def client(chunk):
        for i in chunk:
            t0 = time.perf_counter()
            code, body = http_call(base, path, bert_body(reqs, i))
            lat[i] = time.perf_counter() - t0
            on_answer(i, code, body)

    t0 = time.perf_counter()
    ts = [threading.Thread(target=client, args=(idx[t::threads],))
          for t in range(threads)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    return sorted(lat.values()), time.perf_counter() - t0


def bert_http(card, repo, server, paths, reqs, ref, inproc, threads):
    """Phase 4b's HTTP part: BERT-base behind serving.serve_http, over
    the phase's repository and server.  (a) BERT_HTTP_REQUESTS predicts
    as JSON from `threads` client threads: every answer 200 with (seq,
    pooled), 12 kernel-5 launches a launched batch, the first
    BERT_CHECKED answers within 2e-2 rel L2 of the CPU fp32 forward,
    kernel 5 against its plain version at each bucket the batches ran
    at (returned under "attention", weighted by launches);
    (b) /metrics parses and counts every request sent, /v1/models,
    /v1/metrics, /healthz, /statusz; (c) chaos faults at serving.execute
    open the bf16 model's breaker: it answers 503 ModelUnavailable, the
    fp32 model 200, /healthz 200, and after the cooldown one probe
    closes it; (d) version 2 of the bf16 artifact, rollover with
    requests in flight: none fails, new requests land on v2, and v1's
    release frees at least its parameter bytes; (e) shutdown(drain=True)
    with requests queued: /healthz and /statusz 503 while every accepted
    request is answered, a predict after it 503."""
    import gc

    import numpy as np

    from mxnet_tpu_torch import serving
    from mxnet_tpu_torch.ops import attention as att
    from mxnet_tpu_torch.resilience import chaos

    ref_seq, ref_pooled = ref
    dev = torch.device("cuda", 0)
    t_http = time.perf_counter()
    httpd = serving.serve_http(server, port=0)
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    bf16 = "/v1/models/bert_bf16:predict"
    rec = {"card": card}
    try:
        # (a) predicts over HTTP
        m1 = repo.get("bert_bf16").metrics
        b0, r0, c0 = (m1.value(k) for k in ("batches", "requests",
                                             "completed"))
        seqs, pools = [None] * BERT_CHECKED, [None] * BERT_CHECKED
        bad = []

        def keep(i, code, body):
            if code != 200:
                bad.append(f"request {i}: {code} {body}")
                return
            outs = body["outputs"]
            seq = torch.tensor(np.asarray(outs[0], np.float32))
            pooled = torch.tensor(np.asarray(outs[1], np.float32))
            if tuple(seq.shape) != (1, BERT_SEQ, BERT_UNITS) \
                    or tuple(pooled.shape) != (1, BERT_UNITS) \
                    or not (torch.isfinite(seq).all()
                            and torch.isfinite(pooled).all()):
                bad.append(f"request {i}: shapes {tuple(seq.shape)} "
                           f"{tuple(pooled.shape)} or not finite")
            if i < BERT_CHECKED:
                seqs[i], pools[i] = seq[0], pooled[0]

        # the buckets (a)'s batches ran at: each bucket's count and the
        # valid lengths of its first batch (pad rows at 0), seen at the
        # entry's execute, which the batcher calls once a batch
        entry = repo.get("bert_bf16")
        execute, served = entry.execute, {}

        def tally(bucket, xs, seed=0):
            n, lengths = served.get(bucket, (0, xs[2].clone()))
            served[bucket] = (n + 1, lengths)
            return execute(bucket, xs, seed)

        entry.execute = tally
        att.reset_attention_launch_count()
        try:
            lat, wall = http_predicts(base, bf16, reqs,
                                      list(range(BERT_HTTP_REQUESTS)),
                                      threads, keep)
        finally:
            launches = att.attention_launch_count()
            del entry.execute
        batches = m1.value("batches") - b0
        for b in bad[:5]:
            fail(f"bert http (a): {b}")
        if launches != BERT_LAYERS * batches or not batches \
                or sum(n for n, _ in served.values()) != batches:
            fail(f"bert http (a): {launches} attention launches for "
                 f"{batches} batches (want {BERT_LAYERS} per batch; "
                 f"buckets {({b: n for b, (n, _) in served.items()})})")
        # kernel 5 against its plain version at each bucket (a) served,
        # with that bucket's valid lengths; weighted by its launches
        gen = torch.Generator().manual_seed(2177)
        checks = []
        print("bert http (a): kernel 5 at the buckets served:", flush=True)
        for b in sorted(served):
            n, lengths = served[b]
            q, k, v = (torch.randn(b, BERT_SEQ, BERT_UNITS, generator=gen)
                       .to(dev, torch.bfloat16) for _ in range(3))
            m = key_mask(gen, b, BERT_SEQ, lengths=lengths).to(dev)
            checks.append((check_attention(f"bert.packed.b{b}", q, k, v, m,
                                           False, card, heads=BERT_HEADS),
                           BERT_LAYERS * n))
        e_seq = e_pool = row = float("inf")
        if all(s is not None for s in seqs):
            seq, pooled = torch.stack(seqs), torch.stack(pools)
            e_seq, e_pool = rel_l2(seq, ref_seq), rel_l2(pooled, ref_pooled)
            row = max(rel_l2(seq[i], ref_seq[i]) for i in range(BERT_CHECKED))
        bound = BERT_BOUNDS["bf16"]
        if not (e_seq < bound and e_pool < bound and row < bound):
            fail(f"bert http (a): answers vs the CPU fp32 forward: seq "
                 f"{e_seq:.3g}, worst row {row:.3g}, pooled {e_pool:.3g} "
                 f"(bound {bound})")
        p50, p99 = percentile_ms(lat, 0.50), percentile_ms(lat, 0.99)
        ip = inproc.get("bf16", {})
        rec.update(requests=BERT_HTTP_REQUESTS, threads=threads,
                   batches=batches, launches=launches,
                   buckets={str(b): served[b][0] for b in sorted(served)},
                   req_per_s=BERT_HTTP_REQUESTS / wall, p50_ms=p50,
                   p99_ms=p99, rel_l2_seq=e_seq, rel_l2_pooled=e_pool,
                   worst_row=row, errors=len(bad),
                   in_process=dict(req_per_s=ip.get("req_per_s"),
                                   p50_ms=ip.get("p50_ms"),
                                   p99_ms=ip.get("p99_ms")))
        print(f"bert http (a): {BERT_HTTP_REQUESTS} predicts as JSON from "
              f"{threads} threads in {batches} batches, {launches} "
              f"attention launches (want {BERT_LAYERS * batches}); {len(bad)} "
              f"bad answers; vs the CPU fp32 forward ({BERT_CHECKED} "
              f"requests) rel L2 seq {e_seq:.3g} (worst row {row:.3g}) "
              f"pooled {e_pool:.3g} (bound {bound}) [{card}]", flush=True)
        print(f"serving bert bf16 over HTTP: "
              f"{BERT_HTTP_REQUESTS / wall:.2f} requests/s, p50 {p50:.3f} "
              f"ms, p99 {p99:.3f} ms at the client (in process, 4b: "
              f"{ip.get('req_per_s', 0):.2f} requests/s, p50 "
              f"{ip.get('p50_ms') or 0:.3f} ms, p99 "
              f"{ip.get('p99_ms') or 0:.3f} ms) [{card}]", flush=True)

        # (b) the other routes
        key = (("model", "bert_bf16"), ("version", "1"))
        code, text = http_call(base, "/metrics")
        try:
            prom = parse_prometheus(text) if code == 200 else {}
        except ValueError as e:
            prom = {}
            fail(f"bert http (b): /metrics: {e}")
        sent = r0 + BERT_HTTP_REQUESTS
        got = (prom.get(("mx_serving_requests_total", key)),
               prom.get(("mx_serving_completed_total", key)))
        if got != (sent, c0 + BERT_HTTP_REQUESTS) or r0 != c0 \
                or m1.value("requests") != sent:
            fail(f"bert http (b): /metrics counts {got} requests/"
                 f"completed, want {sent} ({r0} in process + "
                 f"{BERT_HTTP_REQUESTS} over HTTP)")
        models = http_call(base, "/v1/models")
        snap = http_call(base, "/v1/metrics")
        health = http_call(base, "/healthz")
        status = http_call(base, "/statusz")
        by_model = {m["model"]: m for m in snap[1].get("models", [])}
        routes_ok = (
            models == (200, {"models": {"bert_bf16": [1],
                                        "bert_fp32": [1]}})
            and snap[0] == 200 and snap[1]["pending"] == 0
            and by_model["bert_bf16"]["requests"] == sent
            and health == (200, {"status": "serving"})
            and status[0] == 200 and "bert_bf16 v1: req" in status[1])
        print(f"bert http (b): /metrics {code}, {len(prom)} samples, "
              f"mx_serving_requests_total{{bert_bf16 v1}} {got[0]} = "
              f"{r0} in process + {BERT_HTTP_REQUESTS} over HTTP; "
              f"/v1/models {models}; /v1/metrics {snap[0]}; /healthz "
              f"{health}; /statusz {status[0]}:", flush=True)
        for line in str(status[1]).splitlines():
            print(f"  | {line}", flush=True)
        if not routes_ok:
            fail("bert http (b): a route answered wrong")
        rec["metrics_samples"] = len(prom)

        # (c) the circuit breaker of one model
        one = [x[:1] for x in reqs]
        brk = repo.get("bert_bf16").breaker
        codes = []
        n0 = att.attention_launch_count()
        with chaos.inject("serving.execute", times=10 ** 6) as plan:
            while len(codes) < 8 and (not codes or codes[-1] != 503):
                c, body = http_call(base, bf16, bert_body(reqs, 0))
                codes.append(c)
            opened = brk.state()
            faults = plan.fired
        unavailable = http_call(base, bf16, bert_body(reqs, 1))
        fp32 = http_call(base, "/v1/models/bert_fp32:predict",
                         bert_body(reqs, 2))[0]
        healthz = http_call(base, "/healthz")[0]
        during = att.attention_launch_count() - n0
        time.sleep(brk.snapshot()["cooldown_s"] + 0.05)
        probe = http_call(base, bf16, bert_body(reqs, 3))[0]
        closed = brk.state()
        probe_launches = att.attention_launch_count() - n0 - during
        rec["breaker"] = dict(codes=codes, faults=faults, state=opened,
                              unavailable=unavailable[0], fp32=fp32,
                              healthz=healthz, probe=probe,
                              state_after=closed, launches_during=during,
                              probe_launches=probe_launches)
        print(f"bert http (c): serving.execute faults ({faults} fired, "
              f"each attempt of the retry policy) gave {codes}, the "
              f"breaker {opened}; bf16 then {unavailable[0]} "
              f"({str(unavailable[1].get('error', ''))[:60]}...), fp32 "
              f"{fp32}, /healthz {healthz}; {during} attention launches "
              f"while faulted (the fp32 answer's); after the cooldown the "
              f"probe {probe} ({probe_launches} launches), the breaker "
              f"{closed} [{card}]", flush=True)
        if not (codes[-1] == 503 and all(c == 400 for c in codes[:-1])
                and opened == "open" and unavailable[0] == 503
                and "circuit breaker" in unavailable[1].get("error", "")
                and fp32 == 200 and healthz == 200 and probe == 200
                and closed == "closed" and during == BERT_LAYERS
                and probe_launches == BERT_LAYERS):
            fail(f"bert http (c): breaker {rec['breaker']}")

        # (d) rollover with requests in flight
        repo.rollover("bert_bf16", 1)  # pin v1: the add must not move
        repo.add("bert_bf16", paths["bf16"], version=2)  # traffic yet
        e1, e2 = repo.get("bert_bf16", 1), repo.get("bert_bf16", 2)
        for b in server.config.ladder():  # v2's graphs, before the baseline
            e2.execute(b, [x[:b] for x in reqs])
        server.infer("bert_bf16", one, version=2)  # and its batcher
        v1_bytes = sum(p.numel() * p.element_size()
                       for p in e1.served.net.parameters())
        gc.collect()
        torch.cuda.synchronize()
        mem0 = torch.cuda.memory_allocated()
        q1, q2 = e1.metrics.value("requests"), e2.metrics.value("requests")
        futs, errors = [], []
        # v1's first batch hangs (chaos), so the swap lands with v1's
        # requests in flight
        with chaos.inject("serving.execute", at=1, action="hang",
                          duration=0.5):
            for i in range(BERT_HTTP_ROLLOVER):
                futs.append(server.submit("bert_bf16",
                                          [x[i:i + 1] for x in reqs]))
                if i == BERT_HTTP_ROLLOVER // 2:
                    inflight = e1.inflight()
                    repo.rollover("bert_bf16", 2)
                    retired_inflight = (e1.retired,
                                        e1._served is not None)
            for i, f in enumerate(futs):
                try:
                    shape = tuple(f.result(timeout=300)[0].shape)
                    if shape != (1, BERT_SEQ, BERT_UNITS):
                        errors.append(f"request {i}: shape {shape}")
                except Exception as e:  # noqa: BLE001 — reported below
                    errors.append(f"request {i}: {type(e).__name__}: {e}")
        del futs
        on1 = e1.metrics.value("requests") - q1
        on2 = e2.metrics.value("requests") - q2
        after = [http_call(base, bf16, bert_body(reqs, i))[0]
                 for i in range(4)]
        landed = e2.metrics.value("requests") - q2 - on2
        released = (e1.retired, e1.inflight(), e1._served is None)
        gc.collect()
        torch.cuda.synchronize()
        freed = mem0 - torch.cuda.memory_allocated()
        rec["rollover"] = dict(requests=BERT_HTTP_ROLLOVER, errors=len(errors),
                               on_v1=on1, on_v2=on2,
                               v1_inflight_at_swap=inflight,
                               after=after, after_on_v2=landed,
                               v1_param_bytes=v1_bytes, freed_bytes=freed,
                               default=repo.default_version("bert_bf16"))
        print(f"bert http (d): rollover v1 -> v2 with {inflight} requests "
              f"in flight on v1 (retired {retired_inflight[0]}, kept its "
              f"model {retired_inflight[1]}); {BERT_HTTP_ROLLOVER} requests, "
              f"{len(errors)} failed, {on1} on v1 and {on2} on v2; "
              f"version-less requests after it {after}, {landed} on v2; v1 "
              f"retired/in flight/released {released}; device memory freed "
              f"{freed / 2 ** 20:.1f} MiB (v1's parameters "
              f"{v1_bytes / 2 ** 20:.1f} MiB) [{card}]", flush=True)
        for e in errors[:5]:
            fail(f"bert http (d): {e}")
        if not (after == [200] * 4 and landed == 4 and on2 > 0
                and released == (True, 0, True) and freed >= v1_bytes
                and retired_inflight == (True, True)):
            fail(f"bert http (d): rollover {rec['rollover']}")

        # (e) the drain
        m2 = e2.metrics
        bd0 = m2.value("batches")
        n0 = att.attention_launch_count()
        with chaos.inject("serving.execute", at=1, action="hang",
                          duration=BERT_HTTP_HANG_S):
            futs = [server.submit("bert_bf16", [x[i:i + 1] for x in reqs])
                    for i in range(BERT_HTTP_DRAIN)]
            time.sleep(0.3)  # the first batch is inside its hang
            closer = threading.Thread(
                target=lambda: server.shutdown(drain=True))
            closer.start()
            time.sleep(0.1)
            during = [http_call(base, "/healthz")[0],
                      http_call(base, "/statusz")[0],
                      http_call(base, bf16, bert_body(reqs, 0))[0]]
            pending = server.pending()
            closer.join(timeout=300)
        answered = 0
        for f in futs:
            try:
                answered += tuple(f.result(timeout=1)[0].shape) \
                    == (1, BERT_SEQ, BERT_UNITS)
            except Exception as e:  # noqa: BLE001 — reported below
                fail(f"bert http (e): a queued request failed: {e}")
        del futs
        after = http_call(base, bf16, bert_body(reqs, 0))[0]
        dl = att.attention_launch_count() - n0
        db = m2.value("batches") - bd0
        rec["drain"] = dict(queued=BERT_HTTP_DRAIN, pending_at_probe=pending,
                            during=during, answered=answered, after=after,
                            batches=db, launches=dl)
        print(f"bert http (e): shutdown(drain=True) with {pending} of "
              f"{BERT_HTTP_DRAIN} requests still pending: /healthz, "
              f"/statusz, predict answered {during}; {answered} of "
              f"{BERT_HTTP_DRAIN} queued requests answered in {db} batches "
              f"({dl} attention launches); a predict after it {after} "
              f"[{card}]", flush=True)
        if not (during == [503, 503, 503] and pending > 0
                and answered == BERT_HTTP_DRAIN and after == 503
                and dl == BERT_LAYERS * db and not closer.is_alive()):
            fail(f"bert http (e): drain {rec['drain']}")
    finally:
        httpd.shutdown()
        httpd.server_close()
    rec["seconds"] = time.perf_counter() - t_http
    print("serving_http: " + json.dumps(rec), flush=True)
    rec["attention"] = checks
    return rec


def phase_bert(card, n_requests, threads):
    """Full-width BERT-base (Normal(0.02) weights from a seed, as
    bench_all.py initialises it), exported with dynamic_batch=True in
    bf16 and fp32, served through ModelRepository -> InferenceServer to
    single-sequence requests from several threads.  Every request must
    be answered, the attention kernel must launch exactly BERT_LAYERS
    times per launched batch, and the answers (seq and pooled) of
    BERT_CHECKED requests must match the port's fp32 forward of the same
    weights on the CPU (plain versions): relative L2 < 2e-2 (bf16) and
    < 1e-4 (fp32 served on the card).  Positions at or past valid_length
    must not move the valid ones."""
    import gc

    from mxnet_tpu_torch import cpu, gpu, init, serving
    from mxnet_tpu_torch.contrib import deploy
    from mxnet_tpu_torch.gluon import load_numpy_params
    from mxnet_tpu_torch.gluon.model_zoo import bert
    from mxnet_tpu_torch.ops import attention as att

    gc.collect()
    torch.cuda.empty_cache()
    dev = torch.device("cuda", 0)
    result = {}
    tmp = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                       "chip_smoke_deploy")
    t0 = time.perf_counter()
    net = bert.get_bert_model("bert_12_768_12", vocab_size=BERT_VOCAB,
                              max_length=512, dropout=0.1)
    net.initialize(init.Normal(0.02), ctx=gpu(0), seed=3)
    net.hybridize()
    net.eval()
    w32 = {k: v.detach().cpu().clone()
           for k, v in net.state_dict(keep_vars=True).items()}
    reqs = bert_requests(n_requests, seed=21)
    example = [x[:1].to(dev) for x in reqs]
    paths = {"fp32": deploy.export_model(net, os.path.join(tmp, "bert_fp32"),
                                         example, dynamic_batch=True)}
    net.cast("bfloat16")
    paths["bf16"] = deploy.export_model(net, os.path.join(tmp, "bert_bf16"),
                                        example, dynamic_batch=True)
    print(f"bert: built, initialised and exported BERT-base "
          f"({sum(v.numel() for v in net.parameters()) / 1e6:.1f} M "
          f"parameters) in {time.perf_counter() - t0:.1f} s", flush=True)
    # the reference: the port's fp32 forward of the same weights on the CPU
    ref_net = bert.get_bert_model("bert_12_768_12", vocab_size=BERT_VOCAB,
                                  max_length=512, dropout=0.1)
    ref_net.initialize(ctx=cpu())
    load_numpy_params(ref_net, w32)
    ref_net.eval()
    t0 = time.perf_counter()
    checked = [x[:BERT_CHECKED] for x in reqs]
    ref_seq, ref_pooled = bert_forward(ref_net, checked, torch.device("cpu"))
    print(f"bert: CPU fp32 reference forward of {BERT_CHECKED} sequences in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    del ref_net
    repo = serving.ModelRepository()
    for tag, path in paths.items():
        repo.add(f"bert_{tag}", path)
    server = serving.InferenceServer(
        repo, serving.ServingConfig(max_batch_size=BATCH,
                                    batch_timeout_ms=2))
    try:
        for tag, n_req in (("bf16", n_requests), ("fp32", BATCH)):
            model = f"bert_{tag}"
            xs = [x[:n_req] for x in reqs]
            serve(server, model, [x[:4] for x in xs], 2)  # warm
            repo.get(model).execute(BATCH, [x[:BATCH] for x in xs])
            m = repo.get(model).metrics
            b0 = m.value("batches")
            att.reset_attention_launch_count()
            answers, lat, wall, errors = serve(server, model, xs, threads)
            launches = att.attention_launch_count()
            batches = m.value("batches") - b0
            for e in errors[:5]:
                fail(f"bert {tag}: {e}")
            if any(a is None for a in answers):
                fail(f"bert {tag}: {sum(a is None for a in answers)} of "
                     f"{n_req} requests unanswered")
                continue
            if launches != BERT_LAYERS * batches:
                fail(f"bert {tag}: {launches} attention launches for "
                     f"{batches} batches (want {BERT_LAYERS} per batch)")
            shapes_ok = all(
                isinstance(a, tuple) and len(a) == 2
                and tuple(a[0].shape) == (1, BERT_SEQ, BERT_UNITS)
                and tuple(a[1].shape) == (1, BERT_UNITS) for a in answers)
            seq = torch.cat([a[0].float().cpu() for a in answers])
            pooled = torch.cat([a[1].float().cpu() for a in answers])
            finite = bool(torch.isfinite(seq).all()
                          and torch.isfinite(pooled).all())
            e_seq = rel_l2(seq[:BERT_CHECKED], ref_seq)
            e_pool = rel_l2(pooled[:BERT_CHECKED], ref_pooled)
            row = max(rel_l2(seq[i], ref_seq[i]) for i in range(BERT_CHECKED))
            bound = BERT_BOUNDS[tag]
            print(f"bert {tag}: {n_req} requests from {threads} threads in "
                  f"{batches} batches, {launches} attention launches; vs the "
                  f"CPU fp32 forward ({BERT_CHECKED} requests) rel L2 seq "
                  f"{e_seq:.3g} (worst row {row:.3g}) pooled {e_pool:.3g} "
                  f"(bound {bound}); finite={finite} shapes={shapes_ok}",
                  flush=True)
            if not (e_seq < bound and e_pool < bound and row < bound
                    and finite and shapes_ok):
                fail(f"bert {tag}: served answers disagree with the CPU "
                     f"fp32 forward (seq {e_seq:.3g}, worst row {row:.3g}, "
                     f"pooled {e_pool:.3g}, bound {bound}, finite {finite},"
                     f" shapes {shapes_ok})")
            p50, p99 = percentile_ms(lat, 0.50), percentile_ms(lat, 0.99)
            result[tag] = dict(requests=n_req, batches=batches,
                               launches=launches, wall_s=wall,
                               req_per_s=n_req / wall, p50_ms=p50,
                               p99_ms=p99, rel_l2_seq=e_seq,
                               rel_l2_pooled=e_pool, worst_row=row)
            if tag == "bf16":
                result["launches"] = launches
            print(f"serving bert {tag}: {n_req / wall:.2f} requests/s, p50 "
                  f"{p50:.3f} ms, p99 {p99:.3f} ms (submit to answer), "
                  f"{n_req / max(batches, 1):.1f} rows per batch [{card}]",
                  flush=True)
        result["http"] = bert_http(card, repo, server, paths, reqs,
                                   (ref_seq, ref_pooled), result, threads)
    finally:
        server.shutdown(drain=True)
    # padding invariance on the card: scramble tokens and token types at
    # and past valid_length
    xs = [x[:8].clone() for x in reqs]
    tok2, typ2 = xs[0].clone(), xs[1].clone()
    past = torch.arange(BERT_SEQ)[None, :] >= xs[2][:, None]
    tok2[past] = (tok2[past] + 7919) % BERT_VOCAB
    typ2[past] = 1 - typ2[past]
    a, _ = bert_forward(net, xs, dev)
    b, _ = bert_forward(net, [tok2, typ2, xs[2]], dev)
    keep = (~past).to(dev)
    moved = float((a.float() - b.float()).abs()[keep].max())
    print(f"bert bf16 padding invariance: max change of a valid position "
          f"{moved:.3g} after scrambling the padding", flush=True)
    if moved != 0.0:
        fail(f"bert: valid positions moved by {moved:.3g} when the padding "
             f"changed")
    result["padding_max_change"] = moved
    # direct batch-32 forward and its profile
    xb = [x[:BATCH].to(dev) for x in reqs]
    with torch.inference_mode():
        fwd_ms = [time_ms(lambda: net(*xb), iters=5, warmup=2)
                  for _ in range(2)]
    print(f"direct forward bert bf16 batch {BATCH}: "
          f"{' '.join(f'{t:.3f}' for t in fwd_ms)} ms, "
          f"{' '.join(f'{BATCH / t * 1e3:.1f}' for t in fwd_ms)} seq/s "
          f"[{card}]", flush=True)
    result["forward_ms"] = fwd_ms

    def run():
        with torch.inference_mode():
            net(*xb)
    prof = profile_device(run, f"bert bf16 batch {BATCH}", "forward", card,
                          sum(fwd_ms) / len(fwd_ms), iters=3, top=12)
    if prof is not None:
        kern = sum(ms for ms, _, key in prof["top"]
                   if any(n in key for n in KERNEL5_NAMES))
        print(f"profile bert: attention kernel {kern:.3f} ms of "
              f"{prof['busy_ms']:.3f} ms busy ({kern / prof['busy_ms']:.1%})"
              f" [{card}]", flush=True)
        prof["attention_ms"] = kern
    result["profile"] = prof
    result["compiled"] = hold_captured_forward(
        f"compiled: served forward bert-base bf16 batch {BATCH}", net, xb,
        card, {"k5": BERT_LAYERS})
    del net
    gc.collect()
    torch.cuda.empty_cache()
    return result


# ---------------------------------------------------------------------------
# the compiled step: each captured path against its eager path
# ---------------------------------------------------------------------------

CAPTURE_K = 3  # captured steps held bit for bit against as many eager ones


def graph_costs(entries):
    """(seconds the captures took, GiB their pools reserved) of cache
    entries (_graphs.Graphed)."""
    g = [e for e in entries if getattr(e, "graph", None) is not None]
    return sum(e.capture_s for e in g), sum(e.pool_bytes for e in g) / 2 ** 30


def idle_of(prof):
    return None if prof is None else 1 - prof["busy_ms"] / prof["wall_ms"]


def pct(v):
    return "not measured" if v is None else f"{v:.1%}"


def trainer_state(tr):
    """Copies of what a step writes: every parameter and buffer (the
    BatchNorm running statistics), the optimizer state, the generator
    state and the step count."""
    from mxnet_tpu_torch import random as mrandom

    return ({k: v.detach().clone()
             for k, v in tr.block.state_dict(keep_vars=True).items()},
            {k: tuple(s.clone() for s in v) for k, v in tr.opt_state.items()},
            mrandom.generator(tr.device).get_state(), tr._t)


def set_trainer_state(tr, st, gen_state=None):
    """Write `st` back in place (a captured step keeps its addresses)."""
    from mxnet_tpu_torch import random as mrandom

    with torch.no_grad():
        for k, v in tr.block.state_dict(keep_vars=True).items():
            v.copy_(st[0][k])
        for k, v in tr.opt_state.items():
            for a, b in zip(v, st[1][k]):
                a.copy_(b)
    mrandom.generator(tr.device).set_state(
        st[2] if gen_state is None else gen_state)
    tr._t = st[3]


def state_mismatch(a, b):
    bad = [k for k in a[0] if not torch.equal(a[0][k], b[0][k])]
    bad += [f"{k} (optimizer state)" for k in a[1]
            if not all(torch.equal(x, y) for x, y in zip(a[1][k], b[1][k]))]
    if not torch.equal(a[2], b[2]):
        bad.append("generator state")
    return bad


def hold_captured_steps(tag, tr, batch, card, want, dropout=False):
    """CAPTURE_K steps of `tr` replayed from its CUDA graph, from one
    state, against CAPTURE_K eager steps (`_step_eager`) from the same
    state: the losses, every parameter and buffer, the optimizer state
    and the generator state bit for bit, `want` kernel launches a step on
    both paths.  With dropout, two replays from one weight state and two
    generator states draw two masks.  A set_learning_rate builds
    nothing.  Then each path timed (host clock around CAPTURE_K
    synchronised steps) and profiled; the capture's seconds and its
    pool's GiB."""
    from mxnet_tpu_torch import _graphs as graphs
    from mxnet_tpu_torch.parallel import spmd

    tr.step(*batch)  # the build, if this signature has none yet
    torch.cuda.synchronize()
    s0 = trainer_state(tr)
    runs = {}
    for mode in ("captured", "eager"):
        set_trainer_state(tr, s0)
        step = tr.step if mode == "captured" else tr._step_eager
        torch.cuda.synchronize()
        reset_kernel_counts()
        t0 = time.perf_counter()
        losses = [step(*batch) for _ in range(CAPTURE_K)]
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) / CAPTURE_K
        runs[mode] = (losses, kernel_counts(), dt, trainer_state(tr))
    lc, cc, dc, sc = runs["captured"]
    le, ce, de, se = runs["eager"]
    bad = state_mismatch(sc, se) + [f"loss {i}" for i in range(CAPTURE_K)
                                    if not torch.equal(lc[i], le[i])]
    if bad:
        fail(f"{tag}: {len(bad)} of the captured path's tensors differ "
             f"from the eager path's after {CAPTURE_K} steps: {bad[:6]}")
    per = {k: v / CAPTURE_K for k, v in cc.items()}
    if cc != ce or any(per[k] != want.get(k, 0) for k in per):
        fail(f"{tag}: launches a step captured {per}, eager "
             f"{ {k: v / CAPTURE_K for k, v in ce.items()} } (want {want})")
    masks = None
    if dropout:
        set_trainer_state(tr, s0)
        a = tr.step(*batch)
        set_trainer_state(tr, s0, gen_state=sc[2])
        b = tr.step(*batch)
        masks = not torch.equal(a, b)
        if not masks:
            fail(f"{tag}: two replays from two generator states gave one "
                 f"loss (the dropout mask repeated)")
    n0 = spmd.step_compile_stats()["count"]
    lr = tr.learning_rate
    tr.set_learning_rate(lr * 0.5)
    tr.step(*batch)
    tr.set_learning_rate(lr)
    tr.step(*batch)
    torch.cuda.synchronize()
    rebuilt = spmd.step_compile_stats()["count"] - n0
    if rebuilt:
        fail(f"{tag}: set_learning_rate built {rebuilt} new step(s)")
    prof_c = profile_device(lambda: tr.step(*batch), f"{tag} captured",
                            "step", card, dc * 1e3, iters=1, top=6)
    with graphs.no_capture():
        prof_e = profile_device(lambda: tr.step(*batch), f"{tag} eager",
                                "step", card, de * 1e3, iters=1, top=6)
    cap_s, gib = graph_costs(tr.graphs())
    res = dict(captured_ms=dc * 1e3, eager_ms=de * 1e3,
               idle_captured=idle_of(prof_c), idle_eager=idle_of(prof_e),
               busy_captured_ms=None if prof_c is None else prof_c["busy_ms"],
               busy_eager_ms=None if prof_e is None else prof_e["busy_ms"],
               capture_s=cap_s, pool_gib=gib, identical=not bad,
               launches_per_step=per, masks_differ=masks,
               rebuilt_after_set_learning_rate=rebuilt,
               losses=[float(v) for v in lc])
    print(f"{tag}: captured {dc * 1e3:.2f} ms/step, eager {de * 1e3:.2f} "
          f"ms/step ({de / dc:.2f}x), idle captured "
          f"{pct(res['idle_captured'])} eager {pct(res['idle_eager'])}; "
          f"capture {cap_s:.2f} s, graph pool {gib:.2f} GiB; {CAPTURE_K} "
          f"steps bit-identical {not bad} ({len(sc[0])} parameters and "
          f"buffers, {len(sc[1])} optimizer states, generator); launches a "
          f"step {per}; masks differ across replays {masks}; rebuilt "
          f"after set_learning_rate {rebuilt} [{card}]", flush=True)
    return res


def profiled_step(tag, tr, batch, card, want):
    """One more replay of `tr`'s captured step (hold_captured_steps
    captured it) with the port's profiler (mx.profiler.start) running:
    `want` kernel launches, no new build or capture, and the host op
    records it took (a replay runs no op's Python)."""
    from mxnet_tpu_torch import profiler
    from mxnet_tpu_torch.parallel import spmd

    torch.cuda.synchronize()
    n0, g0 = spmd.step_compile_stats()["count"], len(tr.graphs())
    reset_kernel_counts()
    profiler.start()
    try:
        loss = tr.step(*batch)
        torch.cuda.synchronize()
    finally:
        profiler.stop()
    records = profiler.num_events()
    d = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(d, exist_ok=True)
    profiler.dump(finished=True,
                  filename=os.path.join(d, "chip_smoke_profiled_step.json"))
    counts = {k: v for k, v in kernel_counts().items() if v}
    built = spmd.step_compile_stats()["count"] - n0
    graphs = len(tr.graphs()) - g0
    finite = bool(torch.isfinite(loss.float()).all())
    print(f"{tag} with mx.profiler on: launches {counts} (want {want}), new "
          f"builds {built}, new graphs {graphs}, host op records {records}, "
          f"loss finite {finite} [{card}]", flush=True)
    if counts != want or built or graphs or not finite:
        fail(f"{tag} with mx.profiler on: launches {counts} (want {want}), "
             f"builds {built}, graphs {graphs}, finite {finite}")
    return dict(launches=counts, builds=built, graphs=graphs,
                host_records=records)


def hold_moved_storage(tag, tr, batch, card):
    """load_parameters between two steps moves every parameter's storage:
    the next step builds a counted new capture, and that step and a
    replay of it equal two eager steps from the same state, bit for
    bit."""
    from mxnet_tpu_torch.parallel import spmd

    d = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                     "chip_smoke_params")
    os.makedirs(d, exist_ok=True)
    f = os.path.join(d, "moved.params")
    tr.block.save_parameters(f)
    before = {k: v.data_ptr()
              for k, v in tr.block.state_dict(keep_vars=True).items()}
    tr.block.load_parameters(f)
    moved = sum(v.data_ptr() != before[k]
                for k, v in tr.block.state_dict(keep_vars=True).items())
    s1 = trainer_state(tr)
    n0 = spmd.step_compile_stats()
    lc = [tr.step(*batch) for _ in range(2)]
    n1 = spmd.step_compile_stats()
    sc = trainer_state(tr)
    set_trainer_state(tr, s1)
    le = [tr._step_eager(*batch) for _ in range(2)]
    se = trainer_state(tr)
    bad = state_mismatch(sc, se) + [f"loss {i}" for i in range(2)
                                    if not torch.equal(lc[i], le[i])]
    built = n1["count"] - n0["count"]
    evicted = n1["evictions"] - n0["evictions"]
    print(f"{tag}: load_parameters moved {moved} tensors; the next step "
          f"built {built} capture(s), evicted {evicted}; its 2 steps "
          f"bit-identical to eager {not bad} [{card}]", flush=True)
    if built != 1 or evicted != 1 or bad or not moved:
        fail(f"{tag}: after load_parameters {built} build(s), {evicted} "
             f"eviction(s), {moved} tensors moved, mismatches {bad[:6]}")
    return dict(moved=moved, built=built, evicted=evicted,
                identical=not bad)


def hold_captured_forward(tag, net, inputs, card, want):
    """The hybridized inference forward replayed from its CUDA graph
    against the same forward run eagerly (no_capture): the outputs bit
    for bit, `want` kernel launches a call on both; each path timed by
    CUDA events and profiled; the captures' seconds and pools."""
    from mxnet_tpu_torch.gluon import block as gblock
    from mxnet_tpu_torch import _graphs as graphs

    def run():
        with torch.inference_mode():
            return net(*inputs)

    def leaves(o):
        return [o] if isinstance(o, torch.Tensor) else list(o)

    run()  # the build, if this shape has none yet
    outs, counts, ms, prof = {}, {}, {}, {}
    for mode in ("captured", "eager"):
        with contextlib.ExitStack() as stack:
            if mode == "eager":
                stack.enter_context(graphs.no_capture())
            torch.cuda.synchronize()
            reset_kernel_counts()
            outs[mode] = leaves(run())
            torch.cuda.synchronize()
            counts[mode] = kernel_counts()
            ms[mode] = time_ms(run, iters=5, warmup=1)
            prof[mode] = profile_device(run, f"{tag} {mode}", "forward",
                                        card, ms[mode], iters=3, top=6)
    same = len(outs["captured"]) == len(outs["eager"]) and all(
        torch.equal(a, b) for a, b in zip(outs["captured"], outs["eager"]))
    if not same:
        fail(f"{tag}: the captured forward's outputs differ from the eager "
             f"forward's")
    if counts["captured"] != counts["eager"] or any(
            counts["captured"][k] != want.get(k, 0)
            for k in counts["captured"]):
        fail(f"{tag}: launches captured {counts['captured']}, eager "
             f"{counts['eager']} (want {want})")
    cap_s, gib = graph_costs(gblock._FWD_CACHE.entries(net))
    res = dict(captured_ms=ms["captured"], eager_ms=ms["eager"],
               idle_captured=idle_of(prof["captured"]),
               idle_eager=idle_of(prof["eager"]), capture_s=cap_s,
               pool_gib=gib, identical=same, launches=counts["captured"])
    print(f"{tag}: captured {ms['captured']:.3f} ms, eager "
          f"{ms['eager']:.3f} ms ({ms['eager'] / ms['captured']:.2f}x), "
          f"idle captured {pct(res['idle_captured'])} eager "
          f"{pct(res['idle_eager'])}; captures of this net {cap_s:.2f} s, "
          f"graph pools {gib:.2f} GiB; outputs bit-identical {same}; "
          f"launches a call {counts['captured']} [{card}]", flush=True)
    return res


# ---------------------------------------------------------------------------
# phase 5: the training main path — SPMDTrainer on ResNet-50 v1
# ---------------------------------------------------------------------------

def set_knobs(fused, bwd):
    os.environ["MXNET_FUSED_CONVBN"] = "1" if fused else "0"
    os.environ["MXNET_FUSED_CONVBN_BWD"] = "1" if bwd else "0"


def new_trainer(net, mesh=None):
    from mxnet_tpu_torch import parallel
    from mxnet_tpu_torch.gluon import loss as gloss

    return parallel.SPMDTrainer(net, gloss.SoftmaxCrossEntropyLoss(), "sgd",
                                dict(TRAIN_OPT),
                                mesh=mesh or parallel.make_mesh(dp=1))


def counted_steps(trainer, xb, yb, steps):
    """`steps` training steps with the launch counters reset just before
    and read just after; returns (losses, fwd launches, bwd launches,
    seconds per step by the host clock around synchronised steps)."""
    from mxnet_tpu_torch.ops import fused_convbn as fcb

    torch.cuda.synchronize()
    fcb.reset_launch_count()
    fcb.reset_bwd_launch_count()
    t0 = time.perf_counter()
    losses = [trainer.step(xb, yb) for _ in range(steps)]
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / steps
    return ([float(v) for v in losses], fcb.launch_count(),
            fcb.bwd_launch_count(), dt)


def warm_running_means(net, xb):
    """Set every BatchNorm running mean to its layer's mean over `xb`
    (one op-granular train forward from zero means leaves 0.1 x the batch
    mean in them), as in training past its first steps.  From cold zero
    means the single-pass shifted variance cancels catastrophically, and
    the fused and op-granular paths, which sum in different orders, then
    differ by percents in fp32 already."""
    from mxnet_tpu_torch.gluon import ActiveTrace

    set_knobs(False, False)
    with torch.no_grad():
        for k, v in net.state_dict(keep_vars=True).items():
            if k.endswith("running_mean"):
                v.zero_()
        with ActiveTrace(train=True):
            net(xb)
        for k, v in net.state_dict(keep_vars=True).items():
            if k.endswith("running_mean"):
                v.div_(0.1)


def restore(net, w0):
    with torch.no_grad():
        for k, v in net.state_dict(keep_vars=True).items():
            v.copy_(w0[k])


def one_step(net, w0, xb, yb, fused):
    """One step of a fresh trainer from the weights `w0`; returns (loss,
    fwd launches, bwd launches, {trainable leaf: update}).  The update is
    read as the step computes it, before w1 is rounded to the weight's
    dtype: the new momentum, which SGD's first step sets to w1 - w0 (a
    bf16 weight would round most of a 0.1·g step away)."""
    from mxnet_tpu_torch import _graphs as graphs

    restore(net, w0)
    set_knobs(fused, fused)
    trainer = new_trainer(net)
    with graphs.no_capture():  # one step of a fresh trainer: no capture
        losses, fwd, bwd, _ = counted_steps(trainer, xb, yb, 1)
    return losses[0], fwd, bwd, {k: s[0] for k, s in trainer.opt_state.items()}


def train_logits(net, w0, xb, fused):
    """The logits of a training-mode forward (batch statistics) from the
    weights `w0`."""
    from mxnet_tpu_torch.gluon import ActiveTrace

    restore(net, w0)
    set_knobs(fused, fused)
    with torch.no_grad(), ActiveTrace(train=True):
        return net(xb).float()


@contextlib.contextmanager
def exact_var():
    """MXNET_BN_EXACT_VAR=1 (the two-pass variance) inside the block; the
    port reads the knob once per process, so the cached read is
    dropped on the way in and out."""
    from mxnet_tpu_torch.ops import nn as onn

    os.environ["MXNET_BN_EXACT_VAR"] = "1"
    onn._BN_EXACT_VAR = None
    try:
        yield
    finally:
        os.environ["MXNET_BN_EXACT_VAR"] = "0"
        onn._BN_EXACT_VAR = None


def perturb(t, rel, gen):
    """`t` with each element moved by a relative amount drawn uniformly
    from [-rel, rel]."""
    u = torch.rand(t.shape, generator=gen, device=t.device, dtype=t.dtype)
    return t * (1.0 + rel * (2.0 * u - 1.0))


def leaf_rel(a, b):
    """Relative L2 of a[k] - b[k] for each tensor of b, in float64."""
    out = {}
    for k, bk in b.items():
        bk = bk.double()
        out[k] = float((a[k].to(bk.device).double() - bk).norm()
                       / bk.norm().clamp_min(1e-300))
    return out


def rel_l2_all(a, b):
    """Relative L2 of a - b over all tensors of b together."""
    num = sum(float((a[k].to(b[k].device).double() - b[k].double()).norm())
              ** 2 for k in b)
    den = sum(float(b[k].double().norm()) ** 2 for k in b)
    return math.sqrt(num / max(den, 1e-300))


def leaf_check(e, e_op, e_wit, checked, bounds):
    """The per-leaf bound of step_agreement: e[k] <= bounds["rel"] x
    max(e_op[k], e_wit[k]) + bounds["abs"] on each checked leaf.
    Returns (the worst leaf's share of its bound, [(share, leaf, e,
    bound) over it])."""
    rows = []
    for k in checked:
        lim = bounds["rel"] * max(e_op[k], e_wit.get(k, 0.0)) + bounds["abs"]
        rows.append((e[k] / lim, k, e[k], lim))
    worst = max(r[0] for r in rows)
    return worst, [r for r in rows if not r[0] <= 1.0]


LEAF_GROUPS = ("stem", "stage1", "stage2", "stage3", "stage4", "output")


def leaf_group(name):
    if name.startswith("output"):
        return "output"
    i = int(name.split(".")[1])
    return "stem" if i < 4 else f"stage{i - 3}"


def print_leaf_table(tag, errs, checked):
    """Per group of leaves: the median and the largest relative L2 of
    each comparison over the leaves the check holds."""
    cols = list(errs)
    print(f"  {tag}: per-leaf update rel L2, median / max over the checked "
          f"leaves of each group", flush=True)
    print("    " + f"{'group':<8}{'leaves':>7}  "
          + "  ".join(f"{c:>22}" for c in cols), flush=True)
    for g in LEAF_GROUPS:
        ks = [k for k in checked if leaf_group(k) == g]
        if not ks:
            continue
        cells = []
        for c in cols:
            v = sorted(errs[c][k] for k in ks)
            cells.append(f"{v[len(v) // 2]:.3g} / {v[-1]:.3g}")
        print("    " + f"{g:<8}{len(ks):>7}  "
              + "  ".join(f"{s:>22}" for s in cells), flush=True)


def step_agreement(net, xb, yb, tag, ref_dtype, bounds, witness):
    """One step from identical weights (running means warm), fused with
    the fused backward against op-granular (cuDNN), each held against an
    op-granular step of a `ref_dtype` copy of the net, leaf by leaf.

    A leaf is checked where the op-granular update lands within
    LEAF_POWER of the reference: there the comparison can tell a right
    update from a wrong one (a conv bias that a BatchNorm follows has a
    gradient of rounding noise only).  On each checked leaf the fused
    update must lie within bounds["rel"] x max(op-granular's distance,
    the witness's) + bounds["abs"] of the reference, and so must the
    logits of a training-mode forward.  With `witness`, the reference
    step and forward are repeated with the inputs and every weight moved
    by up to 2^-24 relative (less than one fp32 rounding): how far that
    moves a float64 step is how far the function itself lets any fp32
    step land.  The op-granular step is then also repeated with the
    exact two-pass variance (MXNET_BN_EXACT_VAR=1), against a float64
    step that uses it too.  The loss is held to bounds["loss"] of the
    op-granular loss.  Returns the record, and what phase 6 needs to hold
    a step against the same reference (on the host)."""
    import copy

    dev = xb.device
    w0 = {k: v.detach().clone()
          for k, v in net.state_dict(keep_vars=True).items()}
    ref_net = copy.deepcopy(net).to(ref_dtype)
    w_ref = {k: v.to(ref_dtype) for k, v in w0.items()}
    x_ref = xb.to(ref_dtype)
    z_ref = train_logits(ref_net, w_ref, x_ref, False)
    l_ref, _, _, d_ref = one_step(ref_net, w_ref, x_ref, yb, False)
    errs, z_errs = {}, {}
    if witness:
        gen = torch.Generator(device=dev).manual_seed(5)
        w_p = {k: perturb(v, 2.0 ** -24, gen) for k, v in w_ref.items()}
        x_p = perturb(x_ref, 2.0 ** -24, gen)
        z_errs["witness"] = rel_l2(train_logits(ref_net, w_p, x_p, False),
                                   z_ref)
        errs["witness"] = leaf_rel(one_step(ref_net, w_p, x_p, yb,
                                            False)[3], d_ref)
        with exact_var():
            d_ref_x = one_step(ref_net, w_ref, x_ref, yb, False)[3]
            d_u_x = one_step(net, w0, xb, yb, False)[3]
        errs["exact var"] = leaf_rel(d_u_x, d_ref_x)
    del ref_net
    torch.cuda.empty_cache()
    z_u = train_logits(net, w0, xb, False)
    z_f = train_logits(net, w0, xb, True)
    l_u, _, _, d_u = one_step(net, w0, xb, yb, False)
    l_f, fwd, bwd, d_f = one_step(net, w0, xb, yb, True)
    restore(net, w0)
    e_u, e_f = leaf_rel(d_u, d_ref), leaf_rel(d_f, d_ref)
    errs = {"op-granular": e_u, "fused": e_f,
            "fused vs op-granular": leaf_rel(d_f, d_u), **errs}
    z_errs.update({"op-granular": rel_l2(z_u, z_ref),
                   "fused": rel_l2(z_f, z_ref),
                   "fused vs op-granular": rel_l2(z_f, z_u)})
    e_w = errs.get("witness", {})
    checked = [k for k in d_ref if e_u[k] <= LEAF_POWER]
    # the worst checked leaf, 1 = at its bound
    ratio, bad = leaf_check(e_f, e_u, e_w, checked, bounds)
    z_lim = bounds["rel"] * max(z_errs["op-granular"],
                                z_errs.get("witness", 0.0)) + bounds["abs"]
    dl = abs(l_f - l_u) / max(abs(l_u), 1e-30)
    ref_name = str(ref_dtype).replace("torch.", "")
    bound_txt = (f"{bounds['rel']} x max(op-granular"
                 f"{', witness' if witness else ''}) + {bounds['abs']}")
    print(f"train {tag} batch {xb.shape[0]}: one step, loss fused "
          f"{l_f:.7f} op-granular {l_u:.7f} (rel {dl:.3g}, bound "
          f"{bounds['loss']}) {ref_name} {l_ref:.7f}; launches fwd {fwd} "
          f"bwd {bwd}", flush=True)
    print(f"  train {tag} logits of a training-mode forward, rel L2 to the "
          f"{ref_name} forward: "
          + ", ".join(f"{c} {v:.4g}" for c, v in z_errs.items())
          + f" (fused bound {bound_txt} = {z_lim:.4g})", flush=True)
    print(f"  train {tag} update over all leaves, rel L2 to the {ref_name} "
          f"step: op-granular {rel_l2_all(d_u, d_ref):.4g}, fused "
          f"{rel_l2_all(d_f, d_ref):.4g}; fused vs op-granular "
          f"{rel_l2_all(d_f, d_u):.4g}; {len(checked)} of {len(d_ref)} "
          f"leaves checked (op-granular within {LEAF_POWER}), bound per "
          f"leaf {bound_txt}, worst leaf at {ratio:.3f} of its bound, "
          f"{len(bad)} over it", flush=True)
    print_leaf_table(f"train {tag}", errs, checked)
    unchecked = sorted(set(d_ref) - set(checked))
    print(f"  train {tag}: unchecked leaves by group: "
          + ", ".join(f"{g} {sum(leaf_group(k) == g for k in unchecked)}"
                      for g in LEAF_GROUPS), flush=True)
    for r, k, e, lim in sorted(bad, reverse=True)[:5]:
        print(f"    over: {k} fused {e:.4g} > {lim:.4g}", flush=True)
    if not all(math.isfinite(v) for v in (l_f, l_u, l_ref)):
        fail(f"train {tag}: loss not finite ({l_f}, {l_u}, {l_ref})")
    if dl > bounds["loss"] or not z_errs["fused"] <= z_lim:
        fail(f"train {tag}: fused forward disagrees (loss rel {dl:.3g} > "
             f"{bounds['loss']} or logits rel L2 {z_errs['fused']:.4g} > "
             f"{z_lim:.4g})")
    if bad or "output.weight" not in checked:
        fail(f"train {tag}: fused update off on {len(bad)} of "
             f"{len(checked)} checked leaves (output layer checked: "
             f"{'output.weight' in checked})")
    if (fwd, bwd) != (FWD_PER_STEP, BWD_PER_STEP):
        fail(f"train {tag}: {fwd} forward / {bwd} backward kernel launches "
             f"in one step (want {FWD_PER_STEP} / {BWD_PER_STEP})")
    groups = {c: {g: max([v[k] for k in checked if leaf_group(k) == g],
                         default=None) for g in LEAF_GROUPS}
              for c, v in errs.items()}
    rec = dict(loss_fused=l_f, loss_unfused=l_u, loss_ref=l_ref,
               loss_rel=dl, logits_rel_l2=z_errs, leaves=len(d_ref),
               leaves_checked=len(checked), leaves_over=len(bad),
               worst_leaf_of_bound=ratio,
               update_err_unfused=rel_l2_all(d_u, d_ref),
               update_err_fused=rel_l2_all(d_f, d_ref),
               update_fused_vs_unfused=rel_l2_all(d_f, d_u),
               group_max=groups)
    # what phase 6 holds its data-parallel steps against, on the host
    cpu = lambda d: {k: v.detach().cpu() for k, v in d.items()}
    ref = dict(w0=cpu(w0), x=xb.cpu(), y=yb.cpu(), d_ref=cpu(d_ref),
               e_u=e_u, e_w=e_w, checked=checked, l_u=l_u, l_ref=l_ref,
               bounds=bounds, ref_dtype=ref_name)
    return rec, ref


def phase_train(card):
    """bench.py's configuration through the port's entry points:
    make_mesh(dp=1) + SPMDTrainer(SoftmaxCrossEntropyLoss, sgd lr 0.1,
    momentum 0.9, wd 1e-4) on full-width ResNet-50 v1, bf16, NHWC, 224²,
    batch 256, one fixed synthetic batch."""
    import copy
    import gc

    gc.collect()
    torch.cuda.empty_cache()
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(11)
    result = {}
    # fp32 first, at a smaller batch (TF32 is off since phase 1), against
    # float64
    net = build_net("float32", seed=1)
    xb = torch.rand(TRAIN_FP32_BATCH, 224, 224, 3, generator=gen).to(dev)
    yb = torch.randint(0, 1000, (TRAIN_FP32_BATCH,), generator=gen).to(dev)
    warm_running_means(net, xb)
    refs = {}
    result["fp32"], refs["fp32"] = step_agreement(
        net, xb, yb, "fp32", torch.float64, TRAIN_BOUNDS_FP32, witness=True)
    del net, xb, yb
    gc.collect()
    torch.cuda.empty_cache()

    net = build_net("bfloat16", seed=0)
    xb = torch.rand(TRAIN_BATCH, 224, 224, 3, generator=gen).to(
        dev, torch.bfloat16)
    yb = torch.randint(0, 1000, (TRAIN_BATCH,), generator=gen).to(dev)
    warm_running_means(net, xb)
    result["bf16"], refs["bf16"] = step_agreement(
        net, xb, yb, "bf16", torch.float32, TRAIN_BOUNDS_BF16, witness=False)
    gc.collect()
    torch.cuda.empty_cache()
    # the main path: fused with the fused backward, then op-granular, in
    # turns (fused, unfused, unfused, fused), each after one warm-up step;
    # each mode trains its own copy of the net from the same weights
    nets = {True: net, False: copy.deepcopy(net)}
    trainers = {}
    for fused in (True, False):
        set_knobs(fused, fused)
        trainers[fused] = new_trainer(nets[fused])
        counted_steps(trainers[fused], xb, yb, 1)
    runs = {True: [], False: []}
    launches = {"fwd": 0, "bwd": 0}
    for fused in (True, False, False, True):
        set_knobs(fused, fused)
        losses, fwd, bwd, dt = counted_steps(trainers[fused], xb, yb,
                                             TRAIN_STEPS)
        tag = "fused" if fused else "unfused"
        if not all(math.isfinite(v) for v in losses):
            fail(f"train {tag}: loss not finite: {losses}")
        want = (FWD_PER_STEP * TRAIN_STEPS, BWD_PER_STEP * TRAIN_STEPS) \
            if fused else (0, 0)
        if (fwd, bwd) != want:
            fail(f"train {tag}: {fwd} forward / {bwd} backward kernel "
                 f"launches in {TRAIN_STEPS} steps (want {want})")
        if fused:
            launches["fwd"] += fwd
            launches["bwd"] += bwd
        runs[fused].append(dt)
        print(f"train bf16 batch {TRAIN_BATCH} {tag}: {dt * 1e3:.1f} ms/step"
              f", {TRAIN_BATCH / dt:.1f} img/s over {TRAIN_STEPS} steps, "
              f"losses {' '.join(f'{v:.4f}' for v in losses)}, launches "
              f"fwd {fwd} bwd {bwd} [{card}]", flush=True)
    result["ms_per_step"] = {"fused": [t * 1e3 for t in runs[True]],
                             "unfused": [t * 1e3 for t in runs[False]]}
    result["profile"] = {}
    for fused in (True, False):
        set_knobs(fused, fused)
        tag = "fused" if fused else "unfused"
        result["profile"][tag] = profile_device(
            lambda: trainers[fused].step(xb, yb),
            f"train {tag} bf16 batch {TRAIN_BATCH}", "step", card,
            sum(runs[fused]) / len(runs[fused]) * 1e3, iters=2, top=24)
        if fused and result["profile"][tag] is not None:
            print_bwd_shares(f"train fused bf16 batch {TRAIN_BATCH}",
                             bwd_split(result["profile"][tag]["rows"]), card)
    result["launches"] = launches
    result["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"train peak device memory {result['peak_gib']:.1f} GiB", flush=True)
    # the compiled step against the eager step, fused then op-granular
    # (one trainer's graphs at a time), and a reload's new capture
    set_knobs(True, True)
    result["compiled"] = {"fused": hold_captured_steps(
        f"compiled: train bf16 batch {TRAIN_BATCH} fused", trainers[True],
        (xb, yb), card, {"k1": FWD_PER_STEP, "k2": BWD_PER_STEP})}
    result["profiled"] = profiled_step(
        f"compiled: train bf16 batch {TRAIN_BATCH} fused", trainers[True],
        (xb, yb), card, {"k1": FWD_PER_STEP, "k2": BWD_PER_STEP})
    result["moved_storage"] = hold_moved_storage(
        f"compiled: train bf16 batch {TRAIN_BATCH} fused", trainers[True],
        (xb, yb), card)
    del trainers[True]
    gc.collect()
    torch.cuda.empty_cache()
    set_knobs(False, False)
    result["compiled"]["unfused"] = hold_captured_steps(
        f"compiled: train bf16 batch {TRAIN_BATCH} op-granular",
        trainers[False], (xb, yb), card, {})
    set_knobs(True, True)
    return result, refs


# ---------------------------------------------------------------------------
# phase 6: the data-parallel training main path — dp=2 over two ranks
# ---------------------------------------------------------------------------

def kernels_at(n, seed, path, what):
    """Kernels 1 (with statistics) and 2 at ResNet-50's configurations at
    batch ``n``, with phase 3's checks: (forward records, backward
    records), each of path ``path``."""
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(seed)
    fwd, bwd = [], []
    print(f"kernels at {what} ({path}):", flush=True)
    for (name, hw, ci, co, k, s, p, act_in, count) in resnet50_unit_configs():
        x, w, sc, bi, sh = make_unit_inputs(gen, n, hw, ci, co, k,
                                            torch.bfloat16, dev)
        fwd.append(dict(check_unit(name, x, w, sc, bi, sh, k, s, p, act_in,
                                   True), count=count, path=path))
        if s == 1:
            bwd.append(dict(check_unit_bwd(name, x, w, sc, bi, sh, k, p,
                                           act_in, True, gen),
                            count=count, path=path))
        del x, w
    torch.cuda.empty_cache()
    return fwd, bwd


def phase_kernels_dp():
    """Kernels 1 (with statistics) and 2 at the per-rank shapes of the
    data-parallel step (N = TRAIN_BATCH / DP), with phase 3's checks."""
    n = TRAIN_BATCH // DP
    return kernels_at(n, 2468, "train_dp",
                      f"the per-rank shapes of dp={DP}, N={n}")


def full_momentum(trainer):
    """{name: momentum at full size}: under ZeRO (dp > 1) each rank holds
    a block, gathered here (every rank calls it, in the same order)."""
    return {k: trainer.state_full(k)[0] for k in sorted(trainer.opt_state)}


def tensor_digest(t):
    import hashlib

    b = t.detach().contiguous().reshape(-1).view(torch.uint8).cpu()
    return hashlib.sha256(b.numpy().tobytes()).hexdigest()[:20]


def state_digest(net, trainer, momentum=None):
    """{name: sha256 of the bytes} of every parameter, running statistic
    and momentum tensor (full size): equal digests are bit-identical
    states."""
    out = {k: tensor_digest(v)
           for k, v in sorted(net.state_dict(keep_vars=True).items())}
    momentum = full_momentum(trainer) if momentum is None else momentum
    out.update({f"momentum:{k}": tensor_digest(v)
                for k, v in momentum.items()})
    return out


def dp_rank(rank, out_dir, backend, devices):
    """One rank of phase 6 (a process of its own): join the group from
    the DMLC_* environment, run the checked steps and the timed ones,
    write rank<r>.json (and rank 0 its updates).  Exits non-zero on any
    failure."""
    import gc

    from mxnet_tpu_torch import parallel

    dev = torch.device(devices[rank])
    torch.cuda.set_device(dev)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    parallel.dist.init(backend=backend, timeout=DP_COLLECTIVE_TIMEOUT)
    mesh = parallel.make_mesh(dp=DP, devices=devices)
    mode = (f"{DP} ranks, backend {parallel.dist.backend()}, devices "
            f"{','.join(devices)}")
    print(f"rank {rank}/{parallel.dist.num_workers()} on "
          f"{mesh.local_device} ({mode})", flush=True)
    res = {"rank": rank, "mode": mode, "steps": {}}
    for tag, dtype, seed in (("fp32", "float32", 1), ("bf16", "bfloat16", 0)):
        data = torch.load(os.path.join(out_dir, f"{tag}.pt"))
        net = build_net(dtype, seed, dev)
        xb, yb = data["x"].to(dev), data["y"].to(dev)
        if tag == "bf16":
            torch.cuda.reset_peak_memory_stats(dev)
        for fused in (True, False):
            restore(net, data["w0"])
            set_knobs(fused, fused)
            trainer = new_trainer(net, mesh)
            losses, fwd, bwd, _ = counted_steps(trainer, xb, yb, 1)
            case = f"{tag}.{'fused' if fused else 'unfused'}"
            mom = full_momentum(trainer)
            res["steps"][case] = dict(loss=losses[0], fwd=fwd, bwd=bwd,
                                      digest=state_digest(net, trainer,
                                                          mom))
            if rank == 0:
                torch.save({k: v.detach().cpu() for k, v in mom.items()},
                           os.path.join(out_dir, f"update.{case}.pt"))
            print(f"step {case} global batch {xb.shape[0]} "
                  f"({xb.shape[0] // DP} a rank): loss {losses[0]:.7f}, "
                  f"launches fwd {fwd} bwd {bwd}", flush=True)
            del trainer
        if tag == "fp32":
            del net, data, xb, yb
            gc.collect()
            torch.cuda.empty_cache()
    # timed steps, fused with the fused backward then op-granular, each
    # after one warm-up step, the ranks started together
    trainers, res["timed"] = {}, {}
    for fused in (True, False):
        restore(net, data["w0"])
        set_knobs(fused, fused)
        trainers[fused] = new_trainer(net, mesh)
        counted_steps(trainers[fused], xb, yb, 1)
        parallel.dist.barrier()
        losses, fwd, bwd, dt = counted_steps(trainers[fused], xb, yb,
                                             TRAIN_STEPS)
        tag = "fused" if fused else "unfused"
        res["timed"][tag] = dict(ms=dt * 1e3, losses=losses, fwd=fwd,
                                 bwd=bwd)
        print(f"train_dp bf16 {tag}: {dt * 1e3:.1f} ms/step on this rank, "
              f"{TRAIN_BATCH / dt:.1f} img/s global (batch {TRAIN_BATCH}, "
              f"{TRAIN_BATCH // DP} a rank) over {TRAIN_STEPS} steps, losses "
              f"{' '.join(f'{v:.4f}' for v in losses)}, launches fwd {fwd} "
              f"bwd {bwd} [{mode}]", flush=True)
    res["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    # the profile of a fused step on rank 0; rank 1 takes the same steps
    set_knobs(True, True)
    parallel.dist.barrier()
    iters = 2
    step = lambda: trainers[True].step(xb, yb)
    if rank == 0:
        prof = profile_device(step, f"train_dp fused bf16 rank 0 [{mode}]",
                              "step", mode, res["timed"]["fused"]["ms"],
                              iters=iters, top=16,
                              host_prefix="mxnet_tpu_torch.dist.")
        if prof is not None:
            rows = prof.pop("rows")
            prof["kernel1_ms"] = sum(ms for ms, _, k in rows
                                     if any(n in k for n in KERNEL1_NAMES))
            prof["kernel2_ms"] = sum(ms for ms, _, k in rows
                                     if any(n in k for n in KERNEL2_NAMES))
            print_bwd_shares(f"train_dp fused bf16 rank 0 [{mode}]",
                             bwd_split(rows), mode)
            prof["collective_device_ms"] = sum(
                ms for ms, _, k in rows
                if "nccl" in k.lower() or k.startswith("Memcpy"))
            print(f"profile train_dp rank 0: kernel 1 {prof['kernel1_ms']:.3f}"
                  f" ms, kernel 2 {prof['kernel2_ms']:.3f} ms, collectives "
                  f"on the device (NCCL kernels, copies) "
                  f"{prof['collective_device_ms']:.3f} ms, host time in the "
                  f"collective calls {prof.get('host_ms', 0.0):.3f} ms of "
                  f"{res['timed']['fused']['ms']:.3f} ms a step [{mode}]",
                  flush=True)
        res["profile"] = prof
    else:
        for _ in range(iters + 1):
            step()
        torch.cuda.synchronize()
    parallel.dist.barrier()
    parallel.dist.shutdown()
    res["jax_imported"] = sorted(m for m in sys.modules
                                 if m == "jax" or m.startswith("jax.")
                                 or m.split(".")[0] == "mxnet_tpu")
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    print(f"peak device memory {res['peak_gib']:.1f} GiB on this rank; "
          f"JAX modules loaded: {len(res['jax_imported'])}", flush=True)
    return 1 if FAILURES or res["jax_imported"] else 0


def free_port():
    import socket

    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as sk:
        sk.bind(("127.0.0.1", 0))
        return sk.getsockname()[1]


def spawn_ranks(out_dir, backend, devices, flag="--dp-rank"):
    """Start DP rank processes of this script (spawned, never forked),
    `flag` naming the rank's part (phase 6's, or phase 17 (d)'s); wait
    for all, killing every rank when one fails or DP_TIMEOUT runs out;
    print their logs.  Returns the list of failures."""
    port = free_port()
    env = dict(os.environ, DMLC_PS_ROOT_URI="127.0.0.1",
               DMLC_PS_ROOT_PORT=str(port), DMLC_NUM_WORKER=str(DP))
    logs = [open(os.path.join(out_dir, f"rank{r}.log"), "w")
            for r in range(DP)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), flag, str(r),
         "--dp-dir", out_dir, "--dp-backend", backend, "--dp-devices",
         ",".join(devices)], env=dict(env, DMLC_WORKER_ID=str(r)),
        stdout=logs[r], stderr=subprocess.STDOUT) for r in range(DP)]
    t0 = time.monotonic()
    errors = []
    try:
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs):
                break
            if time.monotonic() - t0 > DP_TIMEOUT:
                errors.append(f"ranks still running after {DP_TIMEOUT} s")
                break
            time.sleep(0.5)
    finally:
        for r, p in enumerate(procs):
            if p.poll() is None:
                p.kill()
                errors.append(f"rank {r} killed")
            p.wait()
            logs[r].close()
    for r, p in enumerate(procs):
        if p.returncode != 0:
            errors.append(f"rank {r} exited with {p.returncode}")
        with open(os.path.join(out_dir, f"rank{r}.log")) as f:
            for line in f.read().splitlines()[-400:]:
                print(f"  [rank {r}] {line}", flush=True)
    print(f"dp: ranks done in {time.monotonic() - t0:.1f} s", flush=True)
    return errors


def hold_dp_update(case, d, loss, ref):
    """A data-parallel step's update and loss against phase 5's
    reference for the same weights and batch, by phase 5's rule."""
    bounds = ref["bounds"]
    e = leaf_rel(d, ref["d_ref"])
    worst, bad = leaf_check(e, ref["e_u"], ref["e_w"], ref["checked"],
                            bounds)
    dl = abs(loss - ref["l_u"]) / max(abs(ref["l_u"]), 1e-30)
    print(f"train_dp {case}: loss {loss:.7f} vs phase 5's op-granular "
          f"{ref['l_u']:.7f} (rel {dl:.3g}, bound {bounds['loss']}); update "
          f"over all leaves rel L2 {rel_l2_all(d, ref['d_ref']):.4g} to the "
          f"{ref['ref_dtype']} step; {len(ref['checked'])} leaves checked, "
          f"worst at {worst:.3f} of its bound, {len(bad)} over it",
          flush=True)
    for r, k, ek, lim in sorted(bad, reverse=True)[:5]:
        print(f"    over: {k} {ek:.4g} > {lim:.4g}", flush=True)
    if not math.isfinite(loss) or dl > bounds["loss"] or bad \
            or "output.weight" not in ref["checked"]:
        fail(f"train_dp {case}: loss rel {dl:.3g} (bound {bounds['loss']}),"
             f" {len(bad)} of {len(ref['checked'])} leaves over their bound")
    return dict(loss=loss, loss_rel=dl, worst_leaf_of_bound=worst,
                leaves_over=len(bad),
                update_err=rel_l2_all(d, ref["d_ref"]))


def phase_dp(card, refs):
    """bench.py's step data parallel: DP ranks, each calling
    dist.init() -> make_mesh(dp=DP) -> SPMDTrainer(...).step on the
    global batch, from phase 5's weights and batches.  With fewer than
    DP cards both ranks share cuda:0 over gloo, else rank r runs on
    cuda:r over NCCL."""
    import gc
    import shutil

    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "build", "chip_smoke_dp")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    for tag, ref in refs.items():
        torch.save(dict(w0=ref["w0"], x=ref["x"], y=ref["y"]),
                   os.path.join(out_dir, f"{tag}.pt"))
    gc.collect()
    torch.cuda.empty_cache()
    if torch.cuda.device_count() >= DP:
        backend, devices = "nccl", [f"cuda:{r}" for r in range(DP)]
    else:
        backend, devices = "gloo", ["cuda:0"] * DP
    mode = f"{DP} ranks, backend {backend}, devices {','.join(devices)}"
    print(f"train_dp: {mode} [{card}]", flush=True)
    errors = spawn_ranks(out_dir, backend, devices)
    for e in errors:
        fail(f"train_dp: {e}")
    if errors:
        return {"launches": {"fwd": 0, "bwd": 0}, "mode": mode}
    ranks = []
    for r in range(DP):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    result = {"mode": mode, "backend": backend, "ranks": DP, "steps": {}}
    for case, step0 in ranks[0]["steps"].items():
        fused = case.endswith(".fused")
        want = (FWD_PER_STEP, BWD_PER_STEP) if fused else (0, 0)
        for r, rk in enumerate(ranks):
            got = (rk["steps"][case]["fwd"], rk["steps"][case]["bwd"])
            if got != want:
                fail(f"train_dp {case}: rank {r} launched {got} kernels "
                     f"(want {want} per step)")
        differ = sorted(k for k, v in step0["digest"].items()
                        if any(rk["steps"][case]["digest"][k] != v
                               for rk in ranks[1:]))
        print(f"train_dp {case}: ranks bit-identical after the step on "
              f"{len(step0['digest']) - len(differ)} of "
              f"{len(step0['digest'])} tensors (parameters, running "
              f"statistics, momentum)", flush=True)
        if differ or any(rk["steps"][case]["loss"] != step0["loss"]
                         for rk in ranks[1:]):
            fail(f"train_dp {case}: ranks differ on {len(differ)} tensors "
                 f"(first: {differ[:3]}) or in the loss")
        d = torch.load(os.path.join(out_dir, f"update.{case}.pt"))
        result["steps"][case] = hold_dp_update(case, d, step0["loss"],
                                               refs[case.split(".")[0]])
    for rk in ranks:
        if rk["jax_imported"]:
            fail(f"train_dp: rank {rk['rank']} loaded {rk['jax_imported']}")
    timed = ranks[0]["timed"]
    want = (FWD_PER_STEP * TRAIN_STEPS, BWD_PER_STEP * TRAIN_STEPS)
    for r, rk in enumerate(ranks):
        got = (rk["timed"]["fused"]["fwd"], rk["timed"]["fused"]["bwd"])
        if got != want:
            fail(f"train_dp timed fused: rank {r} launched {got} (want "
                 f"{want})")
    result["ms_per_step"] = {t: [rk["timed"][t]["ms"] for rk in ranks]
                             for t in ("fused", "unfused")}
    result["peak_gib"] = [rk["peak_gib"] for rk in ranks]
    result["profile"] = ranks[0].get("profile")
    result["launches"] = {"fwd": timed["fused"]["fwd"],
                          "bwd": timed["fused"]["bwd"]}
    print(f"train_dp: ms/step per rank fused {result['ms_per_step']['fused']}"
          f", op-granular {result['ms_per_step']['unfused']}; peak GiB per "
          f"rank {[round(g, 2) for g in result['peak_gib']]} [{mode}] "
          f"[{card}]", flush=True)
    return result


# ---------------------------------------------------------------------------
# phase 7: the probe path (row 6) — kernel 6 and the probe's entry point
# ---------------------------------------------------------------------------

def check_tap(name, x, w_taps, sc, bi, sh, k, s, p, act_in, want_stats, nbs,
              with_kernel1=False):
    """Kernel 6 against its plain version on one configuration, once for
    each batch tile in `nbs`, by phase 3's tolerances; one record each.
    kernel_ms is the launch step (conv kernel and statistics reduction)
    replayed from a CUDA graph, op_ms the whole wrapper call, library_ms
    F.conv2d replayed the same way; with `with_kernel1`, k1_ms is kernel
    1's launch step on the same inputs (OHWI weights), in the same way."""
    from mxnet_tpu_torch.ops import convbn_tap as ct
    from mxnet_tpu_torch.ops import fused_convbn as fcb
    from mxnet_tpu_torch.tools.convbn_probe import unit_bound

    kernel, stride, pad = (k, k), (s, s), (p, p)
    args = (x, w_taps, sc, bi, sh)
    kw = dict(kernel=kernel, stride=stride, pad=pad, act_in=act_in,
              want_stats=want_stats)
    w = w_taps.permute(3, 2, 0, 1)
    u = (x.float() * sc + bi).clamp_min(0).to(x.dtype) if act_in else x
    u_nchw = u.permute(0, 3, 1, 2)
    library_ms = graph_ms(lambda: F.conv2d(u_nchw, w, stride=stride,
                                           padding=pad))
    k1_ms = None
    if with_kernel1:
        w_ohwi = fcb.weight_ohwi(w.contiguous())
        k1_ms = graph_ms(lambda: fcb._launch(x, w_ohwi, sc, bi, sh, kernel,
                                             stride, pad, act_in, want_stats))
    bound = unit_bound(x.shape, w_taps.shape[-1], kernel, stride, pad,
                       x.dtype, want_stats)
    recs = []
    for nb in nbs:
        got = ct.candidate_tap(*args, nb=nb, **kw)
        torch.cuda.synchronize()
        ref = ct.candidate_tap_ref(*args, kernel, stride, pad, act_in,
                                   want_stats, nb)
        if got[1].shape != (1, w_taps.shape[-1]):
            fail(f"{name} nb={nb}: s1 shape {tuple(got[1].shape)}")
        ok, max_abs, ytol = hold_unit(
            f"{name} nb={nb}", x, w, sc, bi, k, s, p, act_in, want_stats,
            (got[0], got[1].reshape(-1), got[2].reshape(-1)),
            (ref[0], ref[1].reshape(-1), ref[2].reshape(-1)))
        del got, ref
        bm, bn, _ = ct.launch_plan(x.shape, w_taps.shape[-1], kernel, stride,
                                   pad, x.dtype, nb)
        kernel_ms = graph_ms(lambda: ct._launch(
            x, w_taps, sc, bi, sh, kernel, stride, pad, act_in, want_stats,
            nb))
        op_ms = time_ms(lambda: ct.candidate_tap(*args, nb=nb, **kw))
        ref_ms = time_ms(lambda: ct.candidate_tap_ref(
            *args, kernel, stride, pad, act_in, want_stats, nb), iters=3,
            warmup=1)
        rec = dict(name=name, nb=nb, dtype=str(x.dtype).replace("torch.", ""),
                   shape=list(x.shape), co=w_taps.shape[-1], k=k, s=s, p=p,
                   act_in=act_in, want_stats=want_stats, ok=ok,
                   max_abs_err=max_abs, tile=[bm, bn], kernel_ms=kernel_ms,
                   op_ms=op_ms, ref_ms=ref_ms, library_ms=library_ms,
                   k1_ms=k1_ms, **bound)
        recs.append(rec)
        k1 = "" if k1_ms is None else f" k1_ms={k1_ms:.4f}"
        print(f"  tap {name:<16} nb={nb:<3} {rec['dtype']:<8} x{rec['shape']}"
              f" co={rec['co']} k{k}s{s}p{p} act={int(act_in)} "
              f"stats={int(want_stats)} tile {bm}x{bn} | kernel_ms="
              f"{kernel_ms:.4f} op_ms={op_ms:.4f}{k1} ref_ms={ref_ms:.4f} "
              f"library_ms={library_ms:.4f} bound_ms={bound['bound_ms']:.4f} "
              f"({bound['bound_by']}) | {ytol} | {'ok' if ok else 'FAIL'}",
              flush=True)
    return recs


def check_tap_deterministic(name, x, w_taps, sc, bi, sh, k, s, p, nbs):
    """Two launches at each nb in `nbs` give bit-identical y, s1 and s2,
    and so do the launches at different nb: the kernel's tiles and its
    summation order do not depend on nb."""
    from mxnet_tpu_torch.ops import convbn_tap as ct

    kw = dict(kernel=(k, k), stride=(s, s), pad=(p, p), act_in=True,
              want_stats=True)
    first = None
    for nb in nbs:
        a = ct.candidate_tap(x, w_taps, sc, bi, sh, nb=nb, **kw)
        bits = same_bits(a, ct.candidate_tap(x, w_taps, sc, bi, sh, nb=nb,
                                             **kw))
        across = same_bits(a, first) if first is not None else [True] * 3
        first = a if first is None else first
        print(f"  tap {name} nb={nb}: two launches bit-identical y {bits[0]} "
              f"s1 {bits[1]} s2 {bits[2]}; equal to nb={nbs[0]}: "
              f"{all(across)}", flush=True)
        if not all(bits) or not all(across):
            fail(f"tap {name} nb={nb}: launches differ (two launches "
                 f"{bits}, against nb={nbs[0]} {across})")


def check_tap_refuses(x, w_taps, sc, bi, sh, kernel, nb, what):
    """A kernel-6 call that must raise MXNetError and launch nothing."""
    from mxnet_tpu_torch.base import MXNetError
    from mxnet_tpu_torch.ops import convbn_tap as ct

    before = ct.launch_count()
    try:
        ct.candidate_tap(x, w_taps, sc, bi, sh, kernel=kernel, stride=(1, 1),
                         pad=(kernel[0] // 2,) * 2, act_in=True,
                         want_stats=True, nb=nb)
        fail(f"tap: {what} did not raise")
    except MXNetError as e:
        print(f"  tap {what} raises: {e}", flush=True)
    if ct.launch_count() != before:
        fail(f"tap: the refused call ({what}) launched the kernel")


def phase_kernels_tap():
    """Kernel 6 against its plain version: (a) the probe's four cases
    (N=4, nb=2, bf16, the probe's own inputs), an fp32 case, a
    want_stats-off and an act_in-off case, a 3x3 stride-2 case at nb 1
    and 4, Co=72 with Ci=40 (off 64, on 8), and an indivisible batch and
    a bf16 Co=20 that must raise without a launch; (b) the nine batch-256 layers of the probe's time
    mode at each nb of its TAP_NB, beside kernel 1 on the same inputs,
    with two-launch bit identity at nb 1 and 256 on the 7x7 3x3 layer."""
    import numpy as np

    from mxnet_tpu_torch.ops import convbn_tap as ct
    from mxnet_tpu_torch.tools import convbn_probe as probe

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(1357)
    recs = []
    print("kernel 6 (candidate_tap) vs plain version, probe cases and "
          "extras:", flush=True)
    rng = np.random.RandomState(0)
    for i, (shape, co, kernel, stride, pad) in enumerate(probe.CASES):
        inputs = probe.case_inputs(rng, shape, co, kernel, dev)
        recs += [dict(r, path="extra") for r in check_tap(
            f"probe.case{i}", *inputs, kernel[0], stride[0], pad[0], True,
            True, (probe.CHECK_NB,))]
    extra = [  # name, N, hw, Ci, Co, k, s, p, act_in, stats, dtype, nbs
        ("fp32.28.3x3", 8, 28, 128, 128, 3, 1, 1, True, True,
         torch.float32, (2,)),
        ("nostats.14.1x1", 8, 14, 256, 1024, 1, 1, 0, True, False,
         torch.bfloat16, (4,)),
        ("noact.56.1x1s2", 8, 56, 64, 256, 1, 2, 0, False, True,
         torch.bfloat16, (2,)),
        ("bf16.56.3x3s2", 8, 56, 64, 128, 3, 2, 1, True, True,
         torch.bfloat16, (1, 4)),
        ("edge.co72.ci40", 4, 14, 40, 72, 3, 1, 1, True, True,
         torch.bfloat16, (2,))]
    for name, n, hw, ci, co, k, s, p, act_in, stats, dt, nbs in extra:
        x, w, sc, bi, sh = make_unit_inputs(gen, n, hw, ci, co, k, dt, dev)
        recs += [dict(r, path="extra") for r in check_tap(
            name, x, ct.weight_taps(w), sc, bi, sh, k, s, p, act_in, stats,
            nbs)]
    x, w, sc, bi, sh = make_unit_inputs(gen, 6, 14, 64, 64, 1,
                                        torch.bfloat16, dev)
    check_tap_refuses(x, ct.weight_taps(w), sc, bi, sh, (1, 1), 4,
                      "N=6 nb=4")
    x, w, sc, bi, sh = make_unit_inputs(gen, 4, 14, 64, 20, 3,
                                        torch.bfloat16, dev)
    check_tap_refuses(x, ct.weight_taps(w), sc, bi, sh, (3, 3), 2,
                      "bf16 Co=20")
    print(f"kernel 6 vs plain version at the probe's batch-{TRAIN_BATCH} "
          f"layers, nb in {probe.TAP_NB}:", flush=True)
    for shape, co, kernel, stride, pad in probe.LAYERS:
        n, hw, _, ci = shape
        x, w, sc, bi, sh = make_unit_inputs(gen, n, hw, ci, co, kernel[0],
                                            torch.bfloat16, dev)
        name = f"{hw}x{hw}.{ci}-{co}"
        recs += [dict(r, path="probe", count=1) for r in check_tap(
            name, x, ct.weight_taps(w), sc, bi, sh, kernel[0], stride[0],
            pad[0], True, True, probe.TAP_NB, with_kernel1=True)]
        # the layer whose images fill the fewest rows of a tile at nb=1
        if (hw, kernel) == (7, (3, 3)):
            check_tap_deterministic(name, x, ct.weight_taps(w), sc, bi, sh,
                                    kernel[0], stride[0], pad[0],
                                    (1, probe.TAP_NB[-1]))
        del x, w
        torch.cuda.empty_cache()
    probe_recs = [r for r in recs if r["path"] == "probe"]
    k1 = sum(r["k1_ms"] for r in probe_recs) / len(probe.TAP_NB)
    for nb in probe.TAP_NB:
        k6 = sum(r["kernel_ms"] for r in probe_recs if r["nb"] == nb)
        lib = sum(r["library_ms"] for r in probe_recs if r["nb"] == nb)
        print(f"kernel 6 sweep of the nine layers at nb={nb}: {k6:.4f} ms, "
              f"kernel 1's {k1:.4f} ms on the same inputs ({k6 / k1:.3f}x), "
              f"F.conv2d {lib:.4f} ms ({k6 / lib:.3f}x); launch steps "
              f"replayed from CUDA graphs", flush=True)
    return recs


def profile_probe_layers(card):
    """Device time of kernel 1 and of kernel 6 at each nb over one sweep
    of the nine layers, split into the conv kernel and its statistics
    reduction(s) (torch.profiler)."""
    from mxnet_tpu_torch.ops import convbn_tap as ct
    from mxnet_tpu_torch.ops import fused_convbn as fcb
    from mxnet_tpu_torch.tools import convbn_probe as probe

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(97)
    layers = []
    for shape, co, kernel, stride, pad in probe.LAYERS:
        x, w, sc, bi, sh = probe.layer_inputs(gen, shape, co, kernel)
        layers.append((x, w, ct.weight_taps(w), sc, bi, sh,
                       dict(kernel=kernel, stride=stride, pad=pad,
                            act_in=True, want_stats=True)))
    out = {}
    runs = [("kernel 1", KERNEL1_NAMES, lambda L: fcb.fused_conv_unit(
        L[0], L[1], *L[3:6], **L[6]))]
    runs += [(f"kernel 6 nb={nb}", KERNEL6_NAMES,
              lambda L, nb=nb: ct.candidate_tap(L[0], *L[2:6], nb=nb, **L[6]))
             for nb in probe.TAP_NB]
    for tag, names, call in runs:
        def sweep():
            for L in layers:
                call(L)
        wall = time_ms(sweep, iters=2, warmup=1)
        prof = profile_device(sweep, f"probe layers, {tag}", "sweep", card,
                              wall, iters=2, top=4)
        if prof is None:
            continue
        conv = sum(ms for ms, _, k in prof["rows"] if names[0] in k)
        stats = sum(ms for ms, _, k in prof["rows"]
                    if any(n in k for n in names[1:]))
        out[tag] = dict(wall_ms=wall, conv_ms=conv, stats_ms=stats)
        print(f"profile probe layers, {tag}: conv kernel {conv:.3f} ms, "
              f"statistics reduction {stats:.3f} ms a sweep of nine layers "
              f"[{card}]", flush=True)
    # kernel 1's split per layer: its conv kernel against its statistics
    # reduction (torch.profiler, over 3 calls of each layer), and, by CUDA
    # events, the launch step with statistics against the same without
    # (the epilogue's column sums plus the reduction)
    out["kernel 1 by layer"] = {}
    for (shape, co, kernel, stride, pad), L in zip(probe.LAYERS, layers):
        name = f"{shape[1]}x{shape[2]}.{shape[3]}-{co}.k{kernel[0]}"
        w_ohwi = fcb.weight_ohwi(L[1])
        ms = {st: graph_ms(lambda st=st: fcb._launch(
            L[0], w_ohwi, *L[3:6], kernel, stride, pad, True, st))
            for st in (True, False)}
        with contextlib.redirect_stdout(None):
            prof = profile_device(lambda: runs[0][2](L), name, "call", card,
                                  1.0, iters=3, top=0)
        conv = stats = None
        if prof is not None:
            conv = sum(t for t, _, k in prof["rows"] if KERNEL1_NAMES[0] in k)
            stats = sum(t for t, _, k in prof["rows"]
                        if KERNEL1_NAMES[1] in k)
        out["kernel 1 by layer"][name] = dict(
            conv_ms=conv, stats_ms=stats, with_stats_ms=ms[True],
            without_stats_ms=ms[False])
        split = "not measured" if conv is None else (
            f"conv {conv:.4f} ms, statistics reduction {stats:.4f} ms "
            f"({stats / max(conv + stats, 1e-9):.1%})")
        print(f"probe layer {name}, kernel 1: profiler {split}; CUDA events "
              f"{ms[True]:.4f} ms with statistics, {ms[False]:.4f} without "
              f"({(ms[True] - ms[False]) / ms[True]:.1%} for statistics) a "
              f"call [{card}]", flush=True)
    return out


def phase_probe(card):
    """The probe path: the probe's check mode and time mode through its
    main(argv) on cuda:0, with the launch counters of kernels 1 and 6 set
    to 0 just before and read just after."""
    from mxnet_tpu_torch.ops import convbn_tap as ct
    from mxnet_tpu_torch.ops import fused_convbn as fcb
    from mxnet_tpu_torch.tools import convbn_probe as probe

    calls, rcs = {}, {}
    per_call = probe.WARMUP + probe.ITERS
    want = {"check": {"candidate_tap": len(probe.CASES)},
            "time": {"candidate_tap": len(probe.LAYERS) * len(probe.TAP_NB)
                     * per_call,
                     "fused_conv_unit": len(probe.LAYERS) * per_call}}
    print(f"probe: python -m mxnet_tpu_torch.tools.convbn_probe [--time] "
          f"--device cuda:0 [{card}]", flush=True)
    t0 = time.perf_counter()
    ct.reset_launch_count()
    fcb.reset_launch_count()
    try:
        for mode, argv in (("check", ["--device", "cuda:0"]),
                           ("time", ["--time", "--device", "cuda:0"])):
            report = {}
            rcs[mode] = probe.main(argv, report)
            calls[mode] = report["calls"]
            if mode == "check":
                check_launches = ct.launch_count()
    except Exception as e:  # noqa: BLE001 — the phase fails, the run goes on
        fail(f"probe: {type(e).__name__}: {e}")
        return {"launches": {"tap": 0, "fused": 0}}
    launches = {"tap": ct.launch_count(), "fused": fcb.launch_count()}
    dt = time.perf_counter() - t0
    print(f"probe: rc check {rcs['check']} time {rcs['time']}; calls "
          f"{calls}; launches kernel 6 {launches['tap']} (check "
          f"{check_launches}), kernel 1 {launches['fused']}; {dt:.1f} s",
          flush=True)
    if rcs != {"check": 0, "time": 0}:
        fail(f"probe: main returned {rcs}")
    if calls != want:
        fail(f"probe: calls {calls} != {want}")
    if check_launches != calls["check"].get("candidate_tap") \
            or launches["tap"] != sum(c.get("candidate_tap", 0)
                                      for c in calls.values()) \
            or launches["fused"] != calls["time"].get("fused_conv_unit"):
        fail(f"probe: launches {launches} (check {check_launches}) do not "
             f"match the calls {calls}")
    records = report["records"]
    print(f"probe per-layer, batch {TRAIN_BATCH}, bf16 [{card}]:", flush=True)
    print(f"  {'layer':<20} {'fused/lib':>9} {'fused/bnd':>9} "
          f"{'tap1/tap256':>11} {'tap16/fused':>11} {'comp/lib':>8}",
          flush=True)
    for r in records:
        print(f"  {r['layer']:<20} {r['fused_ms'] / r['library_ms']:9.2f} "
              f"{r['fused_ms'] / r['bound_ms']:9.2f} "
              f"{r['tap_ms'][1] / r['tap_ms'][256]:11.2f} "
              f"{r['tap_ms'][16] / r['fused_ms']:11.2f} "
              f"{r['composed_ms'] / r['library_ms']:8.2f}", flush=True)
    return {"launches": launches, "calls": calls, "records": records,
            "seconds": dt}


# ---------------------------------------------------------------------------
# phase 8: MXNet's imperative training loop (nd, autograd, gluon.Trainer)
# ---------------------------------------------------------------------------

def gluon_steps(net, trainer, xb, yb, steps):
    """`steps` steps of MXNet's imperative loop -- net(x) under
    autograd.record(), the per-sample loss, loss.backward(),
    trainer.step(batch) -- with the launch counters reset just before
    and read just after; returns (mean losses, fwd launches, bwd
    launches, seconds per step by the host clock around synchronised
    steps)."""
    from mxnet_tpu_torch import autograd, gluon, nd
    from mxnet_tpu_torch.ops import fused_convbn as fcb

    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    x, y = nd.NDArray(xb), nd.NDArray(yb)
    torch.cuda.synchronize()
    fcb.reset_launch_count()
    fcb.reset_bwd_launch_count()
    t0 = time.perf_counter()
    losses = []
    for _ in range(steps):
        with autograd.record():
            loss = loss_fn(net(x), y)
        loss.backward()
        trainer.step(xb.shape[0])
        losses.append(loss.mean())
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / steps
    return ([float(v.asscalar()) for v in losses], fcb.launch_count(),
            fcb.bwd_launch_count(), dt)


def gluon_trainer(net, fuse_step=None):
    from mxnet_tpu_torch import gluon

    return gluon.Trainer(net.collect_params(), "sgd", dict(TRAIN_OPT),
                         fuse_step=fuse_step)


def hold_fused_update(tag, net, w0, xb, yb, card):
    """gluon.Trainer's captured update (the default, FusedUpdater) against
    its eager per-parameter loop (fuse_step=False), each from `w0` with
    fresh optimizer state: 1 + CAPTURE_K steps, then every parameter,
    buffer and momentum and every loss bit for bit, 52/46 launches a
    step on both, one build.  Then the two trainers step the same net in
    turns (captured, eager, eager, captured), CAPTURE_K steps a turn (ms
    by the host clock around synchronised steps), and one profiled step
    each gives its idle share; the update's capture seconds and pool."""
    from mxnet_tpu_torch.optimizer import fused

    runs, trainers = {}, {}
    for fuse in (True, False):
        restore(net, w0)
        tr = trainers[fuse] = gluon_trainer(net, fuse_step=fuse)
        n0 = fused.compile_stats()["count"]
        first = gluon_steps(net, tr, xb, yb, 1)
        losses, fwd, bwd, _ = gluon_steps(net, tr, xb, yb, CAPTURE_K)
        moms = {i: st._data.clone() for i, st in tr._updater.states.items()}
        runs[fuse] = dict(
            losses=first[0] + losses, launches=(fwd, bwd),
            state=snapshot(net), moms=moms,
            built=fused.compile_stats()["count"] - n0,
            cost=graph_costs(fused._FUSED_CACHE.entries(tr._updater)))
    f, e = runs[True], runs[False]
    bad = [k for k in f["state"] if not torch.equal(f["state"][k],
                                                    e["state"][k])]
    bad += [f"momentum {i}" for i in f["moms"]
            if not torch.equal(f["moms"][i], e["moms"][i])]
    bad += [] if f["losses"] == e["losses"] else ["losses"]
    want = (FWD_PER_STEP * CAPTURE_K, BWD_PER_STEP * CAPTURE_K)
    if bad or f["built"] != 1 or e["built"] != 0 \
            or f["launches"] != want or e["launches"] != want:
        fail(f"{tag}: the captured update differs from the eager loop "
             f"({bad[:6]}), builds {f['built']}/{e['built']}, launches "
             f"{f['launches']}/{e['launches']} (want {want})")
    ms = {True: [], False: []}
    for fuse in (True, False, False, True):
        ms[fuse].append(gluon_steps(net, trainers[fuse], xb, yb,
                                    CAPTURE_K)[3] * 1e3)
    ms = {k: sum(v) / len(v) for k, v in ms.items()}
    idle = {fuse: idle_of(profile_device(
        lambda: gluon_steps(net, trainers[fuse], xb, yb, 1),
        f"{tag} {'captured update' if fuse else 'eager loop'}", "step",
        card, ms[fuse], iters=1, top=4)) for fuse in (True, False)}
    print(f"{tag}: captured update {ms[True]:.1f} ms/step, eager loop "
          f"{ms[False]:.1f} ms/step ({ms[False] / ms[True]:.3f}x), idle "
          f"captured {pct(idle[True])} eager {pct(idle[False])}; update "
          f"built {f['built']} time(s), capture {f['cost'][0]:.3f} s, pool "
          f"{f['cost'][1]:.3f} GiB; {1 + CAPTURE_K} steps bit-identical "
          f"{not bad} ({len(f['state'])} parameters and buffers, "
          f"{len(f['moms'])} momenta); launches {f['launches']} and "
          f"{e['launches']} in {CAPTURE_K} steps [{card}]", flush=True)
    return dict(captured_ms=ms[True], eager_ms=ms[False],
                idle_captured=idle[True], idle_eager=idle[False],
                built=f["built"], capture_s=f["cost"][0],
                pool_gib=f["cost"][1], identical=not bad)


def gluon_state(net, trainer):
    """Copies of what a gluon.Trainer step writes: every parameter and
    buffer and every optimizer state."""
    st = snapshot(net)
    for j, t in enumerate(flat_states(trainer._updater.states)):
        st[f"state {j}"] = t.clone()
    return st


def drop_cached_op(net):
    """Forget `net`'s CachedOp entries (and their graph pools), so the
    next run of it starts from nothing."""
    from mxnet_tpu_torch import _graphs as graphs
    from mxnet_tpu_torch.gluon import block as gblock

    gblock._FWD_CACHE.drop_owner(graphs.owner_token(net))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def train_pairs(net):
    """The captured forward/backward pairs of `net`'s CachedOp."""
    from mxnet_tpu_torch import _graphs as graphs
    from mxnet_tpu_torch.gluon import block as gblock

    return [p for p in gblock._FWD_CACHE.entries(net)
            if isinstance(p, graphs.TrainPair)]


def captured_loop(tag, net, w0, xb, yb, steps, card, opt=None):
    """`steps` steps of the hybridized gluon.Trainer loop from `w0` with
    a fresh trainer, the CachedOp captured (after its warm-up call) and
    then under no_capture, from one state and one generator state: every
    parameter, buffer, optimizer state and loss bit for bit.  Returns
    ({mode: (losses, launches, builds, state)}, trainers, mismatches)."""
    from mxnet_tpu_torch import _graphs as graphs
    from mxnet_tpu_torch import random as mrandom
    from mxnet_tpu_torch.gluon import block as gblock

    gen = mrandom.generator(xb.device)
    g0 = gen.get_state()
    runs, trainers = {}, {}
    for mode in ("captured", "eager"):
        restore(net, w0)
        gen.set_state(g0)
        tr = trainers[mode] = opt() if opt else gluon_trainer(net)
        n0 = gblock.cached_op_stats()["count"]
        torch.cuda.synchronize()
        reset_kernel_counts()
        with contextlib.ExitStack() as stack:
            if mode == "eager":
                stack.enter_context(graphs.no_capture())
            losses = gluon_steps(net, tr, xb, yb, steps)[0]
        torch.cuda.synchronize()
        runs[mode] = (losses, kernel_counts(),
                      gblock.cached_op_stats()["count"] - n0,
                      gluon_state(net, tr))
    c, e = runs["captured"], runs["eager"]
    bad = [k for k in c[3] if not torch.equal(c[3][k], e[3][k])]
    bad += [] if c[0] == e[0] else ["losses"]
    if bad:
        fail(f"{tag}: the captured loop differs from the eager one after "
             f"{steps} steps: {bad[:6]}")
    return runs, trainers, bad


def hold_captured_train(tag, net, w0, xb, yb, card, spmd_ms):
    """The hybridized gluon.Trainer loop with its CachedOp captured
    (forward and backward graphs) against the same loop under
    no_capture: 1 + CAPTURE_K steps from one state bit for bit, 52/46
    launches a step on both, exactly one forward/backward build (the
    first step is the signature's eager warm-up), none after
    set_learning_rate; a second trainer after load_parameters moved
    every parameter: one counted build, one eviction.  Then each path
    timed in turns and profiled; the capture's seconds and pool."""
    from mxnet_tpu_torch import _graphs as graphs
    from mxnet_tpu_torch.gluon import block as gblock
    from mxnet_tpu_torch.optimizer import fused

    drop_cached_op(net)
    steps = 1 + CAPTURE_K
    runs, trainers, bad = captured_loop(tag, net, w0, xb, yb, steps, card)
    c, e = runs["captured"], runs["eager"]
    want = {"k1": FWD_PER_STEP * steps, "k2": BWD_PER_STEP * steps,
            "k5": 0, "k6": 0}
    pairs = train_pairs(net)
    if c[1] != want or e[1] != want or c[2] != 1 or e[2] != 0 \
            or len(pairs) != 1:
        fail(f"{tag}: launches captured {c[1]} eager {e[1]} (want {want}), "
             f"builds {c[2]}/{e[2]} (want 1/0), {len(pairs)} pairs")
    tr = trainers["captured"]
    n0 = (gblock.cached_op_stats()["count"], fused.compile_stats()["count"])
    lr = tr.learning_rate
    tr.set_learning_rate(lr * 0.5)
    gluon_steps(net, tr, xb, yb, 1)
    tr.set_learning_rate(lr)
    gluon_steps(net, tr, xb, yb, 1)
    rebuilt = (gblock.cached_op_stats()["count"] - n0[0],
               fused.compile_stats()["count"] - n0[1])
    if rebuilt != (0, 0):
        fail(f"{tag}: set_learning_rate built {rebuilt} (forward/backward, "
             f"update)")
    # timed in turns (captured, eager, eager, captured), one profile each
    ms = {"captured": [], "eager": []}
    for mode in ("captured", "eager", "eager", "captured"):
        with contextlib.ExitStack() as stack:
            if mode == "eager":
                stack.enter_context(graphs.no_capture())
            ms[mode].append(gluon_steps(net, tr, xb, yb,
                                        CAPTURE_K)[3] * 1e3)
    ms = {k: sum(v) / len(v) for k, v in ms.items()}
    idle = {}
    for mode in ("captured", "eager"):
        with contextlib.ExitStack() as stack:
            if mode == "eager":
                stack.enter_context(graphs.no_capture())
            idle[mode] = idle_of(profile_device(
                lambda: gluon_steps(net, tr, xb, yb, 1), f"{tag} {mode}",
                "step", card, ms[mode], iters=1, top=6))
    cap_s, gib = graph_costs(pairs)
    # load_parameters moves every parameter: one build, one eviction
    d = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                     "chip_smoke_params")
    os.makedirs(d, exist_ok=True)
    f = os.path.join(d, "gluon_moved.params")
    net.save_parameters(f)
    s0 = gblock.cached_op_stats()
    net.load_parameters(f)
    tr2 = gluon_trainer(net)
    gluon_steps(net, tr2, xb, yb, 2)
    s1 = gblock.cached_op_stats()
    moved = (s1["count"] - s0["count"], s1["evictions"] - s0["evictions"])
    if moved != (1, 1):
        fail(f"{tag}: after load_parameters {moved[0]} build(s) and "
             f"{moved[1]} eviction(s) (want 1 and 1)")
    per = {k: v / steps for k, v in c[1].items()}
    print(f"{tag}: captured forward/backward {ms['captured']:.2f} ms/step, "
          f"eager {ms['eager']:.2f} ms/step ({ms['eager'] / ms['captured']:.3f}"
          f"x), phase 8's captured SPMDTrainer step {spmd_ms:.2f} ms/step; "
          f"idle captured {pct(idle['captured'])} eager {pct(idle['eager'])}"
          f"; capture {cap_s:.2f} s, graph pool {gib:.2f} GiB; {steps} steps "
          f"bit-identical {not bad} ({len(c[3])} tensors); "
          f"launches a step {per}; builds {c[2]}; rebuilt after "
          f"set_learning_rate {rebuilt}; after load_parameters {moved[0]} "
          f"build, {moved[1]} eviction [{card}]", flush=True)
    return dict(captured_ms=ms["captured"], eager_ms=ms["eager"],
                spmd_ms=spmd_ms, idle_captured=idle["captured"],
                idle_eager=idle["eager"], capture_s=cap_s, pool_gib=gib,
                launches={"fwd": c[1]["k1"], "bwd": c[1]["k2"]},
                steps=steps, builds=c[2], moved=moved)


def gluon_one_step(net, w0, xb, yb):
    """One step of a fresh gluon.Trainer from the weights `w0`; returns
    (loss, fwd launches, bwd launches, {leaf: momentum}, {leaf: w1})."""
    restore(net, w0)
    trainer = gluon_trainer(net)
    losses, fwd, bwd, _ = gluon_steps(net, trainer, xb, yb, 1)
    states = trainer._updater.states
    mom = {p.name: states[i]._data for i, p in enumerate(trainer._params)
           if states.get(i) is not None}
    return losses[0], fwd, bwd, mom, snapshot(net)


def snapshot(net):
    return {k: v.detach().clone()
            for k, v in net.state_dict(keep_vars=True).items()}


def spmd_one_step(net, w0, xb, yb):
    """Phase 5's fused SPMDTrainer step from `w0`: (loss, fwd, bwd,
    {leaf: momentum}, {leaf: w1})."""
    loss, fwd, bwd, mom = one_step(net, w0, xb, yb, True)
    return loss, fwd, bwd, mom, snapshot(net)


def hold_against_spmd(tag, g, s, ref, bounds=None):
    """The gluon.Trainer step `g` against the fused SPMDTrainer step `s`
    (loss, fwd, bwd, momenta, weights) from the same start, leaf by leaf
    over phase 5's checked leaves: each leaf's relative L2 distance of
    the momentum (the update) and of w1 within phase 5's bound for that
    leaf, rel x max(op-granular, witness) + abs against the reference
    (or a flat relative `bounds` where given); the loss within phase
    5's loss bound.  Returns the record."""
    checked = ref["checked"]
    e_m, e_w = leaf_rel(g[3], s[3]), leaf_rel(g[4], s[4])
    if bounds is None:
        rows = leaf_check(e_m, ref["e_u"], ref["e_w"], checked,
                          ref["bounds"])
        rows_w = leaf_check(e_w, ref["e_u"], ref["e_w"], checked,
                            ref["bounds"])
        lim_txt = (f"{ref['bounds']['rel']} x max(op-granular, witness) + "
                   f"{ref['bounds']['abs']}")
    else:
        flat = {k: 0.0 for k in checked}
        rows = leaf_check(e_m, flat, {}, checked, dict(rel=1.0, abs=bounds))
        rows_w = leaf_check(e_w, flat, {}, checked, dict(rel=1.0,
                                                         abs=bounds))
        lim_txt = f"{bounds} relative"
    (worst, bad), (worst_w, bad_w) = rows, rows_w
    dl = abs(g[0] - s[0]) / max(abs(s[0]), 1e-30)
    print(f"imperative {tag}: gluon.Trainer step vs SPMDTrainer fused step "
          f"from the same start: loss {g[0]:.7f} vs {s[0]:.7f} (rel "
          f"{dl:.3g}, bound {ref['bounds']['loss']}); momentum over all "
          f"leaves rel L2 {rel_l2_all(g[3], s[3]):.4g}, w1 "
          f"{rel_l2_all(g[4], s[4]):.4g}; {len(checked)} leaves checked, "
          f"bound per leaf {lim_txt}: worst momentum at {worst:.3g}, w1 "
          f"at {worst_w:.3g} of it, {len(bad) + len(bad_w)} over; "
          f"launches fwd {g[1]} bwd {g[2]}", flush=True)
    unchecked = sorted(set(g[3]) - set(checked))
    if unchecked:
        print(f"  imperative {tag}: {len(unchecked)} unchecked leaves, "
              f"momentum rel L2 to SPMD max "
              f"{max(e_m[k] for k in unchecked):.3g}", flush=True)
    for r, k, e, lim in sorted(bad + bad_w, reverse=True)[:5]:
        print(f"    over: {k} {e:.4g} > {lim:.4g}", flush=True)
    finite = all(bool(torch.isfinite(v.float()).all()) for v in g[4].values())
    if bad or bad_w or dl > ref["bounds"]["loss"] or not finite \
            or set(g[3]) != set(s[3]):
        fail(f"imperative {tag}: gluon.Trainer step off the SPMDTrainer "
             f"step ({len(bad)} momenta, {len(bad_w)} weights over their "
             f"bound, loss rel {dl:.3g}, finite {finite})")
    if (g[1], g[2]) != (FWD_PER_STEP, BWD_PER_STEP):
        fail(f"imperative {tag}: {g[1]} forward / {g[2]} backward kernel "
             f"launches in one gluon.Trainer step (want {FWD_PER_STEP} / "
             f"{BWD_PER_STEP})")
    return dict(loss=g[0], loss_spmd=s[0], loss_rel=dl,
                worst_momentum_of_bound=worst, worst_w1_of_bound=worst_w,
                leaves_over=len(bad) + len(bad_w),
                momentum_rel_l2=rel_l2_all(g[3], s[3]),
                w1_rel_l2=rel_l2_all(g[4], s[4]))


def graph_walk_ms(net, xb, yb, reps=5):
    """Host ms of autograd's walk from the loss to the leaves it reaches
    (what backward() adds to torch.autograd.grad), on one recorded
    forward; returns (ms, leaves)."""
    from mxnet_tpu_torch import autograd, gluon, nd

    with autograd.record():
        loss = gluon.loss.SoftmaxCrossEntropyLoss()(net(nd.NDArray(xb)),
                                                    nd.NDArray(yb))
    t0 = time.perf_counter()
    for _ in range(reps):
        leaves = autograd._leaves([loss.data])
    ms = (time.perf_counter() - t0) / reps * 1e3
    loss.backward()
    return ms, len(leaves)


def phase_imperative(card, refs, dev=torch.device("cuda", 0)):
    """MXNet's imperative surface on the card: the MNIST MLP example,
    then full-width ResNet-50 v1 trained through autograd.record() ->
    loss.backward() -> gluon.Trainer.step, hybridized (kernels 1-2) and
    not, from phase 5's weights and batches."""
    import copy
    import gc

    from mxnet_tpu_torch import nd
    from mxnet_tpu_torch.examples import mnist
    from mxnet_tpu_torch.ops import fused_convbn as fcb

    res = {}
    # (1) the MNIST MLP, as the example runs it, on cuda:0
    keep = {}
    t0 = time.perf_counter()
    acc = mnist.run(epochs=1, ctx=dev, batch_size=100, keep=keep)
    wall = time.perf_counter() - t0
    on_card = [p.data().data.device == dev and p.grad().data.device == dev
               for p in keep["net"].collect_params().values()]
    states = [s for st in keep["trainer"]._updater.states.values()
              for s in (st if isinstance(st, tuple) else (st,))]
    on_card += [s.data.device == dev for s in states]
    res["mnist"] = dict(val_accuracy=acc, steps=keep["steps"],
                        samples_per_s=keep["samples_per_s"], wall_s=wall,
                        states=len(states))
    print(f"imperative mnist: val accuracy {acc:.4f} after "
          f"{keep['steps']} steps of 100, {keep['samples_per_s']:.0f} "
          f"samples/s in the epoch, {wall:.2f} s with the data and val; "
          f"{len(on_card)} parameters, gradients and states, "
          f"{sum(on_card)} on {dev} [{card}]", flush=True)
    if not acc > 0.9 or keep["steps"] != 81 or not all(on_card) \
            or len(states) != 6:
        fail(f"imperative mnist: accuracy {acc:.4f} (want > 0.9), "
             f"{keep['steps']} steps (want 81), {len(states)} states, "
             f"{len(on_card) - sum(on_card)} tensors off {dev}")
    del keep
    gc.collect()
    torch.cuda.empty_cache()

    # (2) fp32 at batch 8: one gluon.Trainer step against the fused
    # SPMDTrainer step from phase 5's weights (TF32 off since phase 1)
    ref = refs["fp32"]
    net = build_net("float32", seed=1, dev=dev)
    set_knobs(True, True)
    w0 = {k: v.to(dev) for k, v in ref["w0"].items()}
    xb, yb = ref["x"].to(dev), ref["y"].to(dev)
    s = spmd_one_step(net, w0, xb, yb)
    s2 = spmd_one_step(net, w0, xb, yb)
    spread = max(leaf_rel(s2[3], s[3])[k] for k in ref["checked"])
    print(f"imperative fp32: two SPMDTrainer fused steps from the same "
          f"start differ by up to {spread:.3g} (rel L2 of a checked "
          f"leaf's momentum)", flush=True)
    g = gluon_one_step(net, w0, xb, yb)
    res["fp32"] = dict(hold_against_spmd(f"fp32 batch {TRAIN_FP32_BATCH}",
                                         g, s, ref,
                                         bounds=TRAIN_IMPERATIVE_FP32),
                       spmd_spread=spread)
    del net, s, s2, g
    gc.collect()
    torch.cuda.empty_cache()

    # (3) bf16 at batch 256, hybridized, fused forward and backward
    ref = refs["bf16"]
    net = build_net("bfloat16", seed=0, dev=dev)
    w0 = {k: v.to(dev) for k, v in ref["w0"].items()}
    xb, yb = ref["x"].to(dev), ref["y"].to(dev)
    s = spmd_one_step(net, w0, xb, yb)
    g = gluon_one_step(net, w0, xb, yb)
    res["bf16"] = hold_against_spmd(f"bf16 batch {TRAIN_BATCH}", g, s, ref)
    del s, g
    res["walk_ms"], n_leaves = graph_walk_ms(net, xb, yb)
    print(f"imperative bf16: the walk from the loss to its {n_leaves} "
          f"leaves takes {res['walk_ms']:.3f} ms of host time a backward "
          f"[{card}]", flush=True)
    # the main path's counted run: one warm-up step each, then TRAIN_STEPS
    # timed steps a mode in turns (gluon, SPMD, SPMD, gluon), each mode on
    # its own copy of the net from the same weights
    restore(net, w0)
    nets = {"gluon": net, "spmd": copy.deepcopy(net)}
    trainers = {"gluon": gluon_trainer(nets["gluon"]),
                "spmd": new_trainer(nets["spmd"])}

    def steps(mode, n):
        if mode == "gluon":
            return gluon_steps(nets[mode], trainers[mode], xb, yb, n)
        return counted_steps(trainers[mode], xb, yb, n)
    for mode in ("gluon", "spmd"):
        steps(mode, 1)
    runs = {"gluon": [], "spmd": []}
    launches = {"fwd": 0, "bwd": 0}
    for mode in ("gluon", "spmd", "spmd", "gluon"):
        losses, fwd, bwd, dt = steps(mode, TRAIN_STEPS)
        if not all(math.isfinite(v) for v in losses):
            fail(f"imperative {mode}: loss not finite: {losses}")
        if (fwd, bwd) != (FWD_PER_STEP * TRAIN_STEPS,
                          BWD_PER_STEP * TRAIN_STEPS):
            fail(f"imperative {mode}: {fwd} forward / {bwd} backward "
                 f"kernel launches in {TRAIN_STEPS} steps")
        if mode == "gluon":
            launches["fwd"] += fwd
            launches["bwd"] += bwd
        runs[mode].append(dt * 1e3)
        print(f"imperative bf16 batch {TRAIN_BATCH} {mode}: "
              f"{dt * 1e3:.1f} ms/step, {TRAIN_BATCH / dt:.1f} img/s over "
              f"{TRAIN_STEPS} steps, losses "
              f"{' '.join(f'{v:.4f}' for v in losses)}, launches fwd {fwd} "
              f"bwd {bwd} [{card}]", flush=True)
    ratio = [a / b for a, b in zip(runs["gluon"], reversed(runs["spmd"]))]
    print(f"imperative: gluon.Trainer (captured forward, backward and "
          f"update) / SPMDTrainer fused step (captured) "
          f"{' '.join(f'{r:.3f}' for r in ratio)} [{card}]", flush=True)
    res["ms_per_step"] = runs
    res["ratio"] = ratio
    res["launches"] = launches
    res["profile"] = {}
    for mode in ("gluon", "spmd"):
        prof = profile_device(
            lambda: steps(mode, 1), f"imperative {mode} bf16 batch "
            f"{TRAIN_BATCH}", "step", card,
            sum(runs[mode]) / len(runs[mode]), iters=2, top=12)
        res["profile"][mode] = None if prof is None else dict(
            busy_ms=prof["busy_ms"], wall_ms=prof["wall_ms"],
            idle=1 - prof["busy_ms"] / prof["wall_ms"])
    del nets, trainers
    gc.collect()
    torch.cuda.empty_cache()
    res["captured"] = hold_captured_train(
        f"compiled: imperative bf16 batch {TRAIN_BATCH} gluon.Trainer "
        f"hybridized", net, w0, xb, yb, card,
        sum(runs["spmd"]) / len(runs["spmd"]))
    gc.collect()
    torch.cuda.empty_cache()
    res["compiled"] = hold_fused_update(
        f"compiled: imperative bf16 batch {TRAIN_BATCH} gluon.Trainer", net,
        w0, xb, yb, card)
    gc.collect()
    torch.cuda.empty_cache()

    # (4) not hybridized: op-granular, no kernel launch
    net.hybridize(False)
    restore(net, w0)
    losses, fwd, bwd, dt = gluon_steps(net, gluon_trainer(net), xb, yb, 1)
    res["not_hybridized"] = dict(loss=losses[0], fwd=fwd, bwd=bwd,
                                 ms=dt * 1e3)
    print(f"imperative bf16 not hybridized: loss {losses[0]:.4f}, launches "
          f"fwd {fwd} bwd {bwd}, {dt * 1e3:.1f} ms (one step)", flush=True)
    if (fwd, bwd) != (0, 0) or not math.isfinite(losses[0]):
        fail(f"imperative not hybridized: {fwd} / {bwd} kernel launches "
             f"(want 0 / 0), loss {losses[0]}")

    # (5) inference outside record(): the running statistics stay
    net.hybridize()
    restore(net, w0)
    before = snapshot(net)
    fcb.reset_launch_count()
    out = net(nd.NDArray(xb))
    torch.cuda.synchronize()
    after = snapshot(net)
    same = all(torch.equal(before[k], after[k]) for k in before
               if "running" in k)
    finite = bool(torch.isfinite(out.data.float()).all())
    res["inference"] = dict(stats_unchanged=same, launches=fcb.launch_count(),
                            finite=finite)
    print(f"imperative inference: net(x) outside record(): running "
          f"statistics bit-identical {same}, output {tuple(out.shape)} "
          f"finite {finite}, forward launches {fcb.launch_count()}, "
          f"graph {out.data.requires_grad}", flush=True)
    if not same or not finite or out.shape != (TRAIN_BATCH, 1000) \
            or out.data.requires_grad:
        fail("imperative inference: net(x) outside record() changed the "
             "running statistics or gave no finite logits")
    del out
    drop_cached_op(net)
    KEEP["resnet"] = dict(net=net, w0=w0, x=xb, y=yb)  # phase 12 (b), (c)
    del net
    gc.collect()
    torch.cuda.empty_cache()
    print("imperative: " + json.dumps(res), flush=True)
    return res


# ---------------------------------------------------------------------------
# phase 9: the transformer path — BERT-base and Transformer-base trained
# with Adam through SPMDTrainer, Transformer-base's greedy decoding
# ---------------------------------------------------------------------------

def kernel_counts():
    """The launch counters of kernels 1, 2, 5 and 6."""
    from mxnet_tpu_torch.ops import attention as att
    from mxnet_tpu_torch.ops import convbn_tap as tap
    from mxnet_tpu_torch.ops import fused_convbn as fcb

    return {"k1": fcb.launch_count(), "k2": fcb.bwd_launch_count(),
            "k5": att.attention_launch_count(), "k6": tap.launch_count()}


def reset_kernel_counts():
    from mxnet_tpu_torch.ops import attention as att
    from mxnet_tpu_torch.ops import convbn_tap as tap
    from mxnet_tpu_torch.ops import fused_convbn as fcb

    fcb.reset_launch_count()
    fcb.reset_bwd_launch_count()
    att.reset_attention_launch_count()
    tap.reset_launch_count()


@contextlib.contextmanager
def plain_attention():
    """Kernel 5's launch step replaced by its plain version, for the
    comparison runs of phase 9 only: the op keeps its surface and its
    recompute backward, and the launch counter does not move."""
    from mxnet_tpu_torch.ops import attention as att

    real = att._launch

    def plain(q, k, v, mask, scale, causal, out):
        out.copy_(att._per_head(att.dot_product_attention_ref, q, k, v, mask,
                                scale, causal))
        return out
    att._launch = plain
    try:
        yield
    finally:
        att._launch = real


def decode_src_valid():
    """The decode's source lengths, from a seed in [16, DECODE_SRC]."""
    gen = torch.Generator().manual_seed(61)
    return torch.randint(16, DECODE_SRC + 1, (DECODE_BATCH,), generator=gen)


def phase_kernels_decode(card):
    """Kernel 5 against its plain version at the shapes greedy decoding
    gives it (bf16, B = DECODE_BATCH, 8 heads of 64, packed as the model
    calls it): the encoder's (S = Sk = 64, the sources' key mask), cross
    attention at S = 1..31 over Sk = 64, and causal self-attention at
    S = Sk = 1..31; phase 3c's tolerances.  S = 1 and S < 8 put the TMA
    maps' row bound inside the first 8 rows."""
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(43)
    b, h, u = DECODE_BATCH, NMT_HEADS, NMT_UNITS

    def randn(*shape):
        return torch.randn(*shape, generator=gen).to(dev, torch.bfloat16)
    src_mask = key_mask(gen, b, DECODE_SRC,
                        lengths=decode_src_valid()).to(dev)
    print("attention kernel vs plain version at the decode's shapes:",
          flush=True)
    recs = {"encoder": check_attention(
        "decode.encoder", *(randn(b, DECODE_SRC, u) for _ in range(3)),
        src_mask, False, card, heads=h)}
    for s in range(1, DECODE_MAX_LEN):
        recs[("cross", s)] = check_attention(
            f"decode.cross.s{s}", randn(b, s, u), randn(b, DECODE_SRC, u),
            randn(b, DECODE_SRC, u), src_mask, False, card, heads=h,
            quiet=True)
        recs[("causal", s)] = check_attention(
            f"decode.causal.s{s}", *(randn(b, s, u) for _ in range(3)),
            torch.ones(b, s, device=dev), True, card, heads=h, quiet=True)
    for kind, sk in (("cross", "64"), ("causal", "S")):
        rs = [recs[(kind, s)] for s in range(1, DECODE_MAX_LEN)]
        print(f"  decode.{kind:<6} S=1..{DECODE_MAX_LEN - 1} Sk={sk}: "
              f"{sum(r['ok'] for r in rs)}/{len(rs)} ok, worst "
              f"{max(r['worst_of_bound'] for r in rs):.3f} of the bound, "
              f"max abs {max(r['max_abs_err'] for r in rs):.3g}; summed "
              f"over S: kernel_ms={sum(r['kernel_ms'] for r in rs):.4f} "
              f"ref_ms={sum(r['ref_ms'] for r in rs):.4f} library_ms="
              f"{sum(r['library_ms'] for r in rs):.4f} bound_ms="
              f"{sum(r['bound_ms'] for r in rs):.4f} [{card}]", flush=True)
        print("    kernel_ms by S: " + " ".join(
            f"{s}:{recs[(kind, s)]['kernel_ms'] * 1e3:.1f}us"
            for s in range(1, DECODE_MAX_LEN)), flush=True)
    return recs


def timed_steps(trainer, batch, steps):
    """`steps` training steps with every kernel counter set to 0 just
    before and read just after; returns (losses, counts, s a step)."""
    torch.cuda.synchronize()
    reset_kernel_counts()
    t0 = time.perf_counter()
    losses = [trainer.step(*batch) for _ in range(steps)]
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / steps
    return [float(v) for v in losses], kernel_counts(), dt


def adam_step_state(step, w0, batch, lr):
    """One step of a fresh Adam SPMDTrainer from the weights `w0`:
    (loss, counts, {leaf: updated weight}, {leaf: first moment},
    {leaf: second moment})."""
    from mxnet_tpu_torch.examples import bench_steps as bs

    from mxnet_tpu_torch import _graphs as graphs

    restore(step, w0)
    tr = bs.spmd_trainer(step, lr)
    with graphs.no_capture():  # one step of a fresh trainer: no capture
        losses, counts, _ = timed_steps(tr, batch, 1)
    names = tr._trainable
    return (losses[0], counts,
            {n: tr.params[n].detach().clone() for n in names},
            {n: tr.opt_state[n][0].clone() for n in names},
            {n: tr.opt_state[n][1].clone() for n in names})


def adam_from_moments(w0, m1, v1, lr, t=1, beta1=0.9, beta2=0.999,
                      eps=1e-8):
    """The weight one functional Adam step writes from `w0` given the
    step's own new moments: w' = w0 - m/(sqrt(v) + eps) in w0's dtype,
    then w0 + (w' - w0) * lr * coef in fp32, coef from the int step on
    the device, cast back (the op order of spmd.py's Adam)."""
    from mxnet_tpu_torch.ops.optimizer_ops import _adam_step

    tt = torch.tensor(t, dtype=torch.int32, device=w0.device).float()
    coef = torch.sqrt(1.0 - beta2 ** tt) / (1.0 - beta1 ** tt)
    nw = _adam_step(w0, m1, v1, 1.0, eps)
    return (w0.float() + (nw - w0).float() * (coef * lr)).to(w0.dtype)


def bert_agreement(step, w0, batch, card):
    """(b): the dropout-0 step with kernel 5 against the same step with
    attention by the plain version (both bf16), each against an fp32 step
    by the plain version from the same weights.  The Adam moments (the
    gradient) leaf by leaf by phase 5's rule with TRAIN_BOUNDS_BF16: on
    each leaf where the plain bf16 step lands within LEAF_POWER of the
    fp32 one, the kernel step's lies within rel x the plain step's
    distance + abs.  The updated weights: each leaf bit for bit the Adam
    step from w0 and the step's own moments, and the update w1 - w0 over
    all leaves together within the same rule (Adam moves every element
    by about lr whatever its gradient, so a leaf of few elements whose
    gradients are near 0 has no per-leaf scale to hold it to)."""
    import copy

    l_k, counts, w_k, m_k, v_k = adam_step_state(step, w0, batch,
                                                 BERT_TRAIN_LR)
    names = list(w_k)
    with plain_attention():
        l_p, counts_p, w_p, m_p, v_p = adam_step_state(step, w0, batch,
                                                       BERT_TRAIN_LR)
        ref = copy.deepcopy(step)
        ref.cast("float32")
        w0_32 = {k: v.float() for k, v in w0.items()}
        l_r, _, w_r, m_r, v_r = adam_step_state(ref, w0_32, batch,
                                                BERT_TRAIN_LR)
        del ref, w0_32
    restore(step, w0)
    torch.cuda.empty_cache()
    bounds = TRAIN_BOUNDS_BF16
    worst_all, checked_all, bad_all = {}, {}, []
    for what, a, p, r in (("mean", m_k, m_p, m_r), ("var", v_k, v_p, v_r)):
        e_k, e_p = leaf_rel(a, r), leaf_rel(p, r)
        checked = [n for n in names if e_p[n] <= LEAF_POWER]
        worst, bad = leaf_check(e_k, e_p, {}, checked, bounds)
        worst_all[what], checked_all[what] = worst, len(checked)
        bad_all += [(what,) + tuple(b_) for b_ in bad]
        print(f"  bert dropout 0, Adam {what}: kernel vs fp32 rel L2 over "
              f"all leaves {rel_l2_all(a, r):.4g}, plain "
              f"{rel_l2_all(p, r):.4g}; {len(checked)} of {len(names)} "
              f"leaves checked, worst at {worst:.3f} of its bound "
              f"({bounds['rel']} x plain + {bounds['abs']}), {len(bad)} "
              f"over it [{card}]", flush=True)
    from_moments = [n for n in names if not torch.equal(
        w_k[n], adam_from_moments(w0[n], m_k[n], v_k[n], BERT_TRAIN_LR))]

    def upd(w):
        return {n: w[n].float() - w0[n].float() for n in names}
    e_uk = rel_l2_all(upd(w_k), upd(w_r))
    e_up = rel_l2_all(upd(w_p), upd(w_r))
    u_lim = bounds["rel"] * e_up + bounds["abs"]
    print(f"  bert dropout 0, update w1 - w0 over all leaves: kernel vs "
          f"fp32 rel L2 {e_uk:.4g}, plain {e_up:.4g} (bound {u_lim:.4g}); "
          f"leaves not bit for bit the Adam step from their own moments: "
          f"{len(from_moments)} of {len(names)} [{card}]", flush=True)
    dl = abs(l_k - l_p) / max(abs(l_p), 1e-30)
    print(f"bert pretrain dropout 0: one step from the same weights, loss "
          f"kernel {l_k:.6f} plain {l_p:.6f} (rel {dl:.3g}, bound "
          f"{bounds['loss']}) fp32 {l_r:.6f}; launches {counts} (plain "
          f"{counts_p}) [{card}]", flush=True)
    if counts != {"k1": 0, "k2": 0, "k5": BERT_LAYERS, "k6": 0} \
            or counts_p["k5"] != 0:
        fail(f"bert dropout 0: launches {counts} in one step (want kernel "
             f"5 {BERT_LAYERS} only), {counts_p} with the plain version "
             f"(want none)")
    if not all(math.isfinite(x) for x in (l_k, l_p, l_r)) \
            or dl > bounds["loss"]:
        fail(f"bert dropout 0: losses {l_k}, {l_p}, {l_r} (rel {dl:.3g})")
    if bad_all or not all(checked_all.values()):
        fail(f"bert dropout 0: kernel step's moments off on {len(bad_all)} "
             f"checked leaves ({bad_all[:3]}), checked {checked_all}")
    if from_moments or not e_uk <= u_lim:
        fail(f"bert dropout 0: update rel L2 {e_uk:.4g} (bound "
             f"{u_lim:.4g}); leaves off their moments' Adam step: "
             f"{from_moments[:3]}")
    res = dict(loss_kernel=l_k, loss_plain=l_p, loss_fp32=l_r,
               launches=counts["k5"], worst_of_bound=worst_all,
               leaves_checked=checked_all, leaves=len(names),
               update_rel_l2={"kernel": e_uk, "plain": e_up},
               leaves_off_their_moments=len(from_moments))
    return res, w_k, m_k


def check_tied_once(step, w0, batch, w_k, m_k, card):
    """The tied word embedding is one trained leaf, updated once a step:
    its first moment and its update equal one Adam step on its gradient
    summed over both uses (from a separate forward and backward of the
    same step; bf16, so the comparison allows the run-to-run spread of
    the summation orders, 2e-2 relative L2)."""
    from mxnet_tpu_torch import optimizer, parallel, random
    from mxnet_tpu_torch.gluon import ActiveTrace

    word, dec = "bert.word_embed.weight", "bert.mlm_decoder.embed_weight"
    params = step.state_dict(keep_vars=True)
    restore(step, w0)
    with ActiveTrace(train=True, generator=random.generator(
            torch.device("cuda", 0))):
        g = torch.autograd.grad(step(*batch), params[word])[0]
    fo = parallel.functional_optimizer(
        optimizer.create("adam", learning_rate=BERT_TRAIN_LR))
    with torch.no_grad():
        w_exp, (m_exp, _) = fo.apply(w0[word], g, fo.init(w0[word]),
                                     BERT_TRAIN_LR, 1)
    restore(step, w0)
    one = word in w_k and dec not in w_k
    e_m = rel_l2(m_k[word].float(), m_exp.float())
    d_exp = w_exp.to(w0[word].dtype).float() - w0[word].float()
    e_w = rel_l2(w_k[word].float() - w0[word].float(), d_exp)
    twice = rel_l2(m_exp.float() * 1.9, m_exp.float())
    ok = one and e_m <= 2e-2 and e_w <= 2e-2
    print(f"  bert tied embedding: one trained leaf ({word} in the "
          f"trainer, {dec} not: {one}); first moment vs one Adam step on "
          f"the summed gradient rel L2 {e_m:.3g} (a second update would "
          f"put it {twice:.3g} off), update {e_w:.3g}; "
          f"{'ok' if ok else 'FAIL'} [{card}]", flush=True)
    if not ok:
        fail(f"bert tied embedding: one leaf {one}, moment rel {e_m:.3g}, "
             f"update rel {e_w:.3g}")
    return {"one_leaf": one, "first_moment_rel_l2": e_m,
            "update_rel_l2": e_w}


def recompute_timing(card):
    """The attention backward (the recompute through the plain version)
    at BERT-base's training shape, beside PyTorch's fused attention
    forward + backward on the same q, k and v (for the record only)."""
    from mxnet_tpu_torch.ops import attention as att

    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(47)
    b, s, h, d = BATCH, BERT_SEQ, BERT_HEADS, BERT_UNITS // BERT_HEADS
    q, k, v = (torch.randn(b, s, h * d, generator=gen).to(
        dev, torch.bfloat16).requires_grad_() for _ in range(3))
    mask = key_mask(gen, b, s).to(dev)
    ct = torch.randn(b, s, h * d, generator=gen).to(dev, torch.bfloat16)
    out = att.dot_product_attention(q, k, v, mask, num_heads=h)
    fwd_ms = time_ms(lambda: att.dot_product_attention(q, k, v, mask,
                                                       num_heads=h))
    bwd_ms = time_ms(lambda: torch.autograd.grad(out, (q, k, v), ct,
                                                 retain_graph=True))

    def ours():
        o = att.dot_product_attention(q, k, v, mask, num_heads=h)
        torch.autograd.grad(o, (q, k, v), ct)
    ours_ms = time_ms(ours)

    def split(x):
        return x.detach().reshape(b, s, h, d).permute(0, 2, 1, 3)
    q4, k4, v4 = (split(x).contiguous().requires_grad_() for x in (q, k, v))
    ct4 = split(ct).contiguous()
    m4 = (mask > 0)[:, None, None, :]

    def sdpa():
        o = F.scaled_dot_product_attention(q4, k4, v4, attn_mask=m4)
        torch.autograd.grad(o, (q4, k4, v4), ct4)
    sdpa_ms = time_ms(sdpa)
    print(f"  attention backward at BERT-base's training shape (B={b}, "
          f"H={h}, S=Sk={s}, D={d}, bf16): recompute {bwd_ms:.4f} ms, "
          f"kernel forward {fwd_ms:.4f} ms, the two {ours_ms:.4f} ms; "
          f"F.scaled_dot_product_attention forward + backward {sdpa_ms:.4f}"
          f" ms (record only) [{card}]", flush=True)
    return {"recompute_ms": bwd_ms, "forward_ms": fwd_ms,
            "forward_backward_ms": ours_ms,
            "sdpa_forward_backward_ms": sdpa_ms}


def decode_agreement(net, tokens, src, sv, card):
    """Teacher-forced decode_logits on the decoded tokens, kernel
    against plain (relative L2 within BERT_BOUNDS["bf16"]), and the
    decoded tokens against the plain path's argmax wherever its top-2
    margin exceeds 4x the largest distance between the kernel's and the
    plain logits in that row (past 2x no logit can overtake another; the
    rest allows the decode-time logits, from GEMMs of other shapes, to
    sit as far again); a row stops counting once it has emitted eos (id
    2)."""
    from mxnet_tpu_torch import nd

    b, t_len = tokens.shape
    tv = nd.full((b,), t_len, ctx=src.ctx)
    mem, mask = net.encode(src, sv)
    z_k = net.decode_logits(tokens, tv, mem, mask)._data.float()
    with plain_attention():
        mem_p, mask_p = net.encode(src, sv)
        z_p = net.decode_logits(tokens, tv, mem_p, mask_p)._data.float()
    e = rel_l2(z_k, z_p)
    tol = BERT_BOUNDS["bf16"]
    tok = tokens._data.long()
    top2 = z_p[:, :-1].topk(2, dim=-1).values
    margin = top2[..., 0] - top2[..., 1]
    delta = (z_k - z_p)[:, :-1].abs().amax(dim=-1)
    held = margin > 4.0 * delta
    held &= ~(torch.cumsum((tok[:, :-1] == 2).long(), dim=1) > 0)
    agree = z_p[:, :-1].argmax(dim=-1) == tok[:, 1:]
    n_held, n_bad = int(held.sum()), int((held & ~agree).sum())
    print(f"  decode teacher-forced logits, kernel vs plain: rel L2 {e:.4g}"
          f" (bound {tol}), largest distance in a row "
          f"{float(delta.max()):.3g}, median top-2 margin "
          f"{float(margin.median()):.3g}; tokens held where the plain top-2 "
          f"margin > 4x the row's distance: {n_held} of {held.numel()}, "
          f"{n_bad} differ; all positions agree {int(agree.sum())} of "
          f"{agree.numel()} [{card}]", flush=True)
    if not e <= tol or n_bad:
        fail(f"decode: teacher-forced logits rel L2 {e:.4g} (bound {tol}) "
             f"or {n_bad} held tokens differ")
    return {"logits_rel_l2": e, "tokens_held": n_held, "tokens_differ": n_bad,
            "tokens_agree_all": int(agree.sum())}


def train_phase9(tag, trainer, batch, units, unit_name, card):
    """One warm-up step, TRAIN_TIMED_STEPS timed steps with every kernel
    counter read (none may launch: dropout 0.1 takes the plain
    attention), then a profiled pair for the idle share."""
    warm = timed_steps(trainer, batch, 1)[0]
    losses, counts, dt = timed_steps(trainer, batch, TRAIN_TIMED_STEPS)
    print(f"{tag}: {dt * 1e3:.1f} ms/step, {units / dt:.1f} {unit_name}/s "
          f"over {TRAIN_TIMED_STEPS} steps; losses {warm[0]:.4f} (warm-up) "
          + " ".join(f"{v:.4f}" for v in losses)
          + f"; launches {counts} [{card}]", flush=True)
    if not all(math.isfinite(v) for v in warm + losses) \
            or not losses[-1] < warm[0]:
        fail(f"{tag}: losses not finite or not falling: {warm + losses}")
    if any(counts.values()):
        fail(f"{tag}: kernel launches {counts} (want none)")
    prof = profile_device(lambda: trainer.step(*batch), tag, "step", card,
                          dt * 1e3, iters=2, top=12)
    return {"ms_per_step": dt * 1e3, f"{unit_name}_per_s": units / dt,
            "losses": warm + losses, "launches": counts,
            "idle": None if prof is None
            else 1 - prof["busy_ms"] / prof["wall_ms"]}


def phase_transformer(card):
    """bench_all.py's configs 3 and 5 on the card through the port's
    entry points (bench_steps' step blocks, SPMDTrainer with Adam), then
    Transformer-base's greedy decoding through kernel 5."""
    import copy
    import gc

    from mxnet_tpu_torch import gpu, init, nd
    from mxnet_tpu_torch.examples import bench_steps as bs

    gc.collect()
    torch.cuda.empty_cache()
    res = {}
    # (a) config 3 exactly: dropout 0.1, no kernel launch (the plain
    # attention with dropout, as the JAX package takes it in training)
    t0 = time.perf_counter()
    batch = bs.bert_batch("full", seed=0, ctx=gpu(0))
    step = bs.init_step(bs.bert_step("full", dropout=0.1), init.Normal(0.02),
                        ctx=gpu(0), seed=0, dtype="bfloat16", warm=batch[:3])
    w0 = snapshot(step)
    print(f"bert-base pretrain: built, initialised and cast in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    bsz = batch[0].shape[0]
    tr = bs.spmd_trainer(step, BERT_TRAIN_LR)
    res["bert"] = train_phase9(
        f"bert-base pretrain (config 3) bf16 batch {bsz} x {BERT_SEQ}, Adam "
        f"lr {BERT_TRAIN_LR}, dropout 0.1", tr, batch, bsz, "samples", card)
    res["bert"]["compiled"] = hold_captured_steps(
        "compiled: bert-base pretrain dropout 0.1", tr, batch, card, {},
        dropout=True)
    # phase 12 (a) trains both nets through gluon.Trainer from w0
    KEEP["bert"] = dict(dropout=step, w0=w0, batch=batch)
    del step, tr
    gc.collect()
    torch.cuda.empty_cache()
    # (b) the same step at dropout 0: 12 kernel-5 launches in the forward,
    # the recompute in the backward; held against the plain version and an
    # fp32 step, the tie checked
    step0 = bs.init_step(bs.bert_step("full", dropout=0.0),
                         init.Normal(0.02), ctx=gpu(0), seed=0,
                         dtype="bfloat16")
    res["bert_dropout0"], w_k, m_k = bert_agreement(step0, w0, batch, card)
    res["bert_dropout0"]["tie"] = check_tied_once(step0, w0, batch, w_k, m_k,
                                                  card)
    del w_k, m_k
    restore(step0, w0)
    tr = bs.spmd_trainer(step0, BERT_TRAIN_LR)
    res["bert_dropout0"]["compiled"] = hold_captured_steps(
        "compiled: bert-base pretrain dropout 0", tr, batch, card,
        {"k5": BERT_LAYERS})
    res["bert_dropout0"]["profiled"] = profiled_step(
        "compiled: bert-base pretrain dropout 0", tr, batch, card,
        {"k5": BERT_LAYERS})
    KEEP["bert"]["dropout0"] = step0
    del step0, w0, batch, tr
    gc.collect()
    torch.cuda.empty_cache()
    res["bert_dropout0"]["backward"] = recompute_timing(card)
    # (c) config 5: Transformer-base, Xavier, bf16, Adam, dropout 0.1
    tbatch = bs.transformer_batch("full", seed=0, ctx=gpu(0))
    nmt = bs.init_step(bs.transformer_step("full", dropout=0.1),
                       init.Xavier(), ctx=gpu(0), seed=0, dtype="bfloat16",
                       warm=tbatch[:4])
    tr = bs.spmd_trainer(nmt, NMT_TRAIN_LR)
    res["nmt"] = train_phase9(
        f"transformer-base NMT (config 5) bf16 batch {tbatch[0].shape[0]}, "
        f"bucket ({tbatch[0].shape[1]}, {tbatch[1].shape[1]}), Adam lr "
        f"{NMT_TRAIN_LR}, dropout 0.1", tr, tbatch, tbatch[1].numel(),
        "tokens", card)
    res["nmt"]["compiled"] = hold_captured_steps(
        "compiled: transformer-base NMT dropout 0.1", tr, tbatch, card, {},
        dropout=True)
    del tbatch, tr
    gc.collect()
    torch.cuda.empty_cache()
    # (d) greedy decoding of DECODE_BATCH sources through kernel 5, from
    # the weights (c) trained
    net = nmt.net
    gen = torch.Generator().manual_seed(67)
    src = nd.array(torch.randint(4, 32000, (DECODE_BATCH, DECODE_SRC),
                                 generator=gen).float(), ctx=gpu(0))
    sv = nd.array(decode_src_valid().float(), ctx=gpu(0))
    net.greedy_decode(src, sv, max_len=4)  # warm-up
    torch.cuda.synchronize()
    reset_kernel_counts()
    t0 = time.perf_counter()
    tokens = net.greedy_decode(src, sv, max_len=DECODE_MAX_LEN)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernel_counts()
    steps = tokens.shape[1] - 1
    want = NMT_LAYERS + 2 * NMT_LAYERS * steps
    print(f"transformer-base greedy decode bf16: {DECODE_BATCH} sources of "
          f"{DECODE_SRC} tokens, max_len {DECODE_MAX_LEN}: {steps} steps in "
          f"{wall * 1e3:.1f} ms ({DECODE_BATCH * steps / wall:.1f} tokens/s)"
          f"; launches {counts} (want kernel 5 {want} = {NMT_LAYERS} + "
          f"{2 * NMT_LAYERS} x {steps}) [{card}]", flush=True)
    if counts != {"k1": 0, "k2": 0, "k5": want, "k6": 0}:
        fail(f"decode: launches {counts}, want kernel 5 {want} only")
    if not (tokens.shape[0] == DECODE_BATCH
            and bool((tokens._data[:, 0] == 1).all())
            and bool(((tokens._data >= 0) & (tokens._data < 32000)).all())):
        fail("decode: tokens of the wrong shape, out of the vocabulary or "
             "not starting with bos")
    res["decode"] = dict(steps=steps, ms=wall * 1e3, launches=counts["k5"],
                         **decode_agreement(net, tokens, src, sv, card))
    # fp32 at batch DECODE_FP32_BATCH: the kernel's tokens are the plain
    # version's
    net32 = copy.deepcopy(net)
    net32.cast("float32")
    s4, v4 = src[:DECODE_FP32_BATCH], sv[:DECODE_FP32_BATCH]
    tok_k = net32.greedy_decode(s4, v4, max_len=DECODE_MAX_LEN).asnumpy()
    with plain_attention():
        tok_p = net32.greedy_decode(s4, v4, max_len=DECODE_MAX_LEN).asnumpy()
    same = tok_k.shape == tok_p.shape and bool((tok_k == tok_p).all())
    print(f"  decode fp32 batch {DECODE_FP32_BATCH}: kernel tokens identical "
          f"to the plain version's: {same} ({tok_k.shape[1] - 1} steps) "
          f"[{card}]", flush=True)
    if not same:
        fail("decode fp32: the kernel's tokens differ from the plain "
             "version's")
    res["decode"]["fp32_identical"] = same
    del net32, nmt, net
    gc.collect()
    torch.cuda.empty_cache()
    print("transformer: " + json.dumps(res), flush=True)
    return res


# ---------------------------------------------------------------------------
# phase 10: SSD-300-ResNet50 (bench_all.py's config 4) — trained through
# SPMDTrainer, decoded with MultiBoxDetection, and examples/ssd_train.py
# ---------------------------------------------------------------------------

def ssd_keep(step, w, batch):
    """The anchors SSDMultiBoxLoss keeps (positives and hard negatives)
    in a training-mode forward of `step` from the weights `w` on `batch`;
    the weights and statistics are restored after."""
    from mxnet_tpu_torch import ops
    from mxnet_tpu_torch.gluon import ActiveTrace

    restore(step, w)
    with torch.no_grad(), ActiveTrace(train=True):
        cls_p = step.ssd(batch[0])[0]
        keep = step.loss.mine(ops, cls_p, batch[1])[1] > 0
    restore(step, w)
    return keep.cpu()


def ssd_one_step(step, w, batch, dev):
    """One eager step of a fresh SPMDTrainer (config 4's SGD) on `dev`
    from the weights `w`: (loss, {trained leaf: its new momentum, the
    update}) on the host."""
    from mxnet_tpu_torch import _graphs as graphs
    from mxnet_tpu_torch import parallel
    from mxnet_tpu_torch.examples import bench_steps as bs

    restore(step, w)
    tr = bs.spmd_trainer(step, mesh=parallel.make_mesh(dp=1, devices=[dev]),
                         **bs.SSD_OPT)
    with graphs.no_capture():
        loss = float(tr.step(*batch))
    return loss, {n: tr.opt_state[n][0].detach().float().cpu()
                  for n in tr._trainable}


def ssd_numerics(step32, w32, step16, batch32, card):
    """(c): the fp32 config-4 step at batch SSD_CHECK_BATCH on cuda:0
    (TF32 off) against the same step by the port on the CPU, from the
    same weights and batch; then the bf16 step on the card against the
    fp32 one."""
    import copy

    from mxnet_tpu_torch import cpu, gpu

    dev = torch.device("cuda", 0)
    b = tuple(t[:SSD_CHECK_BATCH].float() for t in batch32)
    host = copy.deepcopy(step32).to("cpu")
    w_host = {k: v.cpu() for k, v in w32.items()}
    b_host = tuple(t.cpu() for t in b)
    t0 = time.perf_counter()
    l_card, m_card = ssd_one_step(step32, w32, b, gpu(0))
    l_host, m_host = ssd_one_step(host, w_host, b_host, cpu())
    # the step's own sensitivity: the card step from weights moved by
    # 2^-24 relative
    gen = torch.Generator().manual_seed(71)
    w_wit = {k: perturb(v.cpu(), 2.0 ** -24, gen) for k, v in w32.items()}
    _, m_wit = ssd_one_step(step32, w_wit, b, gpu(0))
    keep_card = ssd_keep(step32, w32, b)
    keep_host = ssd_keep(host, w_host, b_host)
    rel = {n: rel_l2(m_card[n], m_host[n]) for n in m_card}
    wit = {n: rel_l2(m_wit[n], m_card[n]) for n in m_card}
    over = sorted((r, n) for n, r in rel.items()
                  if r > SSD_BOUNDS["leaf"] + 2 * wit[n])
    loss_rel = abs(l_card - l_host) / abs(l_host)
    keep_diff = int((keep_card != keep_host).sum())
    worst = max(rel.items(), key=lambda kv: kv[1])
    med = sorted(rel.values())[len(rel) // 2]
    print(f"ssd numerics fp32 batch {SSD_CHECK_BATCH}: card loss "
          f"{l_card:.7f} cpu {l_host:.7f} (rel {loss_rel:.3g}, bound "
          f"{SSD_BOUNDS['loss']}); update rel L2 card vs cpu: worst "
          f"{worst[1]:.3g} ({worst[0]}), median {med:.3g} (the witness's "
          f"median {sorted(wit.values())[len(wit) // 2]:.3g}), "
          f"{sum(r > SSD_BOUNDS['leaf'] for r in rel.values())}/{len(rel)} "
          f"leaves over {SSD_BOUNDS['leaf']}, {len(over)} over it plus 2x "
          f"the step's own sensitivity (worst witness "
          f"{max(wit.values()):.3g}); hard-negative keep differs on "
          f"{keep_diff} of {keep_card.numel()} anchors; "
          f"{time.perf_counter() - t0:.1f} s [{card}]", flush=True)
    if loss_rel > SSD_BOUNDS["loss"] or over:
        fail(f"ssd numerics: fp32 card step vs cpu: loss rel {loss_rel:.3g}"
             f", leaves over the bound {over[-5:]}")
    # bf16 on the card against the fp32 card step, from the same weights
    b16 = (b[0].to(torch.bfloat16),) + b[1:]
    l16, _ = ssd_one_step(step16, w32, b16, gpu(0))
    rel16 = abs(l16 - l_card) / abs(l_card)
    print(f"ssd numerics bf16 batch {SSD_CHECK_BATCH}: loss {l16:.5f} "
          f"against fp32 {l_card:.5f} (rel {rel16:.3g}, bound "
          f"{SSD_BOUNDS['bf16_loss']}) [{card}]", flush=True)
    if not rel16 <= SSD_BOUNDS["bf16_loss"]:
        fail(f"ssd numerics: bf16 loss {l16} vs fp32 {l_card}")
    return dict(loss_card=l_card, loss_cpu=l_host, loss_rel=loss_rel,
                worst_leaf=worst, median_leaf=med, leaves_over_1e3=sum(
                    r > SSD_BOUNDS["leaf"] for r in rel.values()),
                leaves_over_bound=len(over),
                worst_witness=max(wit.values()),
                keep_differs=keep_diff, bf16_loss=l16, bf16_rel=rel16)


def ssd_detection(net, x, card):
    """(d): the hybridized inference forward captured against eager, then
    softmax (fp32) and MultiBoxDetection at each of SSD_NMS_TOPK on the
    card, each held against the port's CPU run of the same op on the same
    inputs; the NMS loop's share of the detection time."""
    from mxnet_tpu_torch import ops
    from mxnet_tpu_torch.ops import contrib

    net.eval()
    net.hybridize()
    bsz = x.shape[0]
    res = {"forward": hold_captured_forward(
        f"compiled: ssd300-resnet50 inference forward bf16 batch {bsz}",
        net, (x,), card, {})}
    reset_kernel_counts()
    with torch.inference_mode():
        cls_p, box_p, anchors = net(x)
    prob = ops.softmax(cls_p.float(), axis=-1)
    prob_host = ops.softmax(cls_p.float().cpu(), axis=-1)
    sm_err = float((prob.cpu() - prob_host).abs().max())
    prob = prob.transpose(1, 2).contiguous()
    loc = box_p.float().reshape(bsz, -1)
    args_host = (prob.cpu(), loc.cpu(), anchors.cpu())
    thr = contrib._f32(0.5)
    for k in SSD_NMS_TOPK:
        run = lambda: ops.MultiBoxDetection(prob, loc, anchors, nms_topk=k)
        out = run().cpu()
        ms = time_ms(run, iters=3, warmup=1)
        ref = ops.MultiBoxDetection(*args_host, nms_topk=k)
        sb, ss, si = contrib.decode_sorted(prob, loc, anchors)
        n = sb.shape[1]
        cap = min(k, n) if k > 0 else n
        nms_ms = time_ms(lambda: contrib.greedy_nms_keep(
            sb[:, :cap], ss[:, :cap], si[:, :cap], thr, False), iters=3,
            warmup=1)
        iou = contrib._corner_iou(sb[:, :cap], sb[:, :cap])
        pair = (si[:, :cap, None] == si[:, None, :cap]) & torch.ones(
            cap, cap, dtype=torch.bool, device=iou.device).triu(1)
        near = int(((iou - thr).abs() < SSD_DET_TOL)[pair].sum())
        del iou, pair
        kept = out[..., 0] >= 0
        same = torch.equal(kept, ref[..., 0] >= 0) and torch.equal(
            out[..., :2], ref[..., :2])
        err = float((out - ref).abs().max())
        counts = kernel_counts()
        print(f"ssd detection nms_topk={k} (K={cap}): {ms:.2f} ms for "
              f"batch {bsz}, greedy NMS {nms_ms:.2f} ms of it "
              f"({nms_ms / ms:.1%}); {int(kept.sum())} rows kept; class "
              f"ids, scores and kept rows identical to the cpu op {same}, "
              f"max abs diff {err:.3g}; candidate pairs with IoU within "
              f"{SSD_DET_TOL} of {thr}: {near}; launches {counts} [{card}]",
              flush=True)
        if not same or err > SSD_DET_TOL or any(counts.values()):
            fail(f"ssd detection nms_topk={k}: identical {same}, max abs "
                 f"diff {err}, launches {counts}")
        res[f"nms_topk={k}"] = dict(ms=ms, nms_ms=nms_ms, kept=int(
            kept.sum()), identical=same, max_abs_diff=err, near=near)
    KEEP["ssd_detection"] = args_host  # phase 19 (b)'s NMS inputs
    print(f"ssd detection softmax fp32: card vs cpu max abs {sm_err:.3g} "
          f"[{card}]", flush=True)
    if sm_err > SSD_DET_TOL:
        fail(f"ssd detection: softmax card vs cpu {sm_err}")
    res["softmax_max_abs"] = sm_err
    return res


def ssd_example(card, dev=torch.device("cuda", 0)):
    """(e): examples/ssd_train.py's loop on cuda:0 with the full
    ResNet-50 network."""
    from mxnet_tpu_torch.examples import ssd_train

    keep = {}
    reset_kernel_counts()
    t0 = time.perf_counter()
    losses = ssd_train.main(SSD_EXAMPLE_ARGS, keep=keep)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernel_counts()
    params = keep["net"].collect_params().values()
    on_card = [p.data().data.device == dev for p in params]
    on_card += [p.grad().data.device == dev for p in params
                if p.grad_req != "null"]
    states = [s for st in keep["trainer"]._updater.states.values()
              for s in (st if isinstance(st, tuple) else (st,))]
    on_card += [s.data.device == dev for s in states]
    steps = len(losses)
    print(f"ssd example {' '.join(SSD_EXAMPLE_ARGS)} on {dev}: losses "
          + " ".join(f"{v:.4f}" for v in losses)
          + f"; {wall / steps:.2f} s a step with the build and the decode; "
          f"{len(on_card)} parameters, gradients and states, "
          f"{sum(on_card)} on {dev}; detections "
          f"{tuple(keep['detections'].shape)}; launches {counts} [{card}]",
          flush=True)
    if not all(math.isfinite(v) for v in losses) or not all(on_card) \
            or not states or any(counts.values()):
        fail(f"ssd example: losses {losses}, {len(on_card) - sum(on_card)} "
             f"tensors off {dev}, {len(states)} states, launches {counts}")
    return dict(losses=losses, s_per_step=wall / steps,
                tensors=len(on_card), states=len(states))


def phase_ssd(card):
    """bench_all.py's config 4 on the card through the port's entry
    points, with the fused-unit knobs on (SSD's NCHW backbone never takes
    kernels 1-2), then its detection and the imperative example."""
    import copy
    import gc

    from mxnet_tpu_torch import gpu, init
    from mxnet_tpu_torch.examples import bench_steps as bs

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    set_knobs(True, True)
    res = {}
    # (a) config 4 exactly: Xavier from seed 0, bf16, batch 32 at 300x300
    t0 = time.perf_counter()
    step = bs.init_step(bs.ssd_step("full"), init.Xavier(), ctx=gpu(0),
                        seed=0)
    w32 = snapshot(step)
    step32 = copy.deepcopy(step)
    step.cast("bfloat16")
    batch = bs.ssd_batch("full", seed=0, ctx=gpu(0), dtype="bfloat16")
    bsz = batch[0].shape[0]
    n_values = sum(v.numel() for v in step.state_dict().values())
    print(f"ssd300-resnet50 (config 4): {n_values} parameters and "
          f"statistics, {batch[1].shape[1]} anchors; built, initialised "
          f"and cast in {time.perf_counter() - t0:.1f} s", flush=True)
    tr = bs.spmd_trainer(step, **bs.SSD_OPT)
    warm = timed_steps(tr, batch, 1)[0]
    losses, counts, dt = timed_steps(tr, batch, SSD_TIMED_STEPS)
    prof = profile_device(lambda: tr.step(*batch), "ssd train captured",
                          "step", card, dt * 1e3, iters=2, top=12)
    cap_s, gib = graph_costs(tr.graphs())
    print(f"ssd300-resnet50 train (config 4) bf16 batch {bsz} at 300x300, "
          f"sgd lr 0.01 momentum 0.9 wd 5e-4, captured: {dt * 1e3:.2f} "
          f"ms/step, {bsz / dt:.1f} img/s over {SSD_TIMED_STEPS} steps; "
          f"losses {warm[0]:.4f} (warm-up) "
          + " ".join(f"{v:.4f}" for v in losses)
          + f"; idle {pct(idle_of(prof))}; capture {cap_s:.2f} s, graph "
          f"pool {gib:.2f} GiB; launches {counts} [{card}]", flush=True)
    if not all(math.isfinite(v) for v in warm + losses):
        fail(f"ssd train: losses not finite: {warm + losses}")
    if any(counts.values()):
        fail(f"ssd train: kernel launches {counts} (want none)")
    res["train"] = dict(ms_per_step=dt * 1e3, img_per_s=bsz / dt,
                        losses=warm + losses, launches=counts,
                        idle=idle_of(prof), capture_s=cap_s, pool_gib=gib)
    # (b) captured against eager from one state, bit for bit
    res["train"]["compiled"] = hold_captured_steps(
        "compiled: ssd300-resnet50 train bf16", tr, batch, card, {})
    del tr
    gc.collect()
    torch.cuda.empty_cache()
    # (d) the trained net's inference forward and detection
    res["detection"] = ssd_detection(step.ssd, batch[0], card)
    step.ssd.hybridize(False)
    gc.collect()
    torch.cuda.empty_cache()
    # (c) fp32 card step against the cpu step, bf16 against fp32
    res["numerics"] = ssd_numerics(step32, w32, step, batch, card)
    del step, step32, w32, batch
    gc.collect()
    torch.cuda.empty_cache()
    # (e) the example's loop
    res["example"] = ssd_example(card)
    gc.collect()
    torch.cuda.empty_cache()
    res["seconds"] = time.perf_counter() - t_phase
    print(f"ssd phase: {res['seconds']:.1f} s [{card}]", flush=True)
    print("ssd: " + json.dumps(res, default=str), flush=True)
    return res


# ---------------------------------------------------------------------------
# phase 11: MXNet's symbolic API
# ---------------------------------------------------------------------------

def resnet50_v1_sym(sym, classes=1000):
    """ResNet-50 v1 in mx.sym, the layer layout of gluon's resnet50_v1:
    a 7x7/2 stem and a 3x3/2 max pool, bottleneck blocks of (3, 4, 6, 3)
    with the stride on the first 1x1 and a 1x1 projection on each stage's
    first block, global average pooling and a 1000-way FullyConnected
    under a SoftmaxOutput; convolutions without bias, BatchNorm eps 1e-5
    and momentum 0.9 with a learned gamma."""
    def conv_bn(x, ch, k, stride, pad, name, relu=True):
        x = sym.Convolution(x, num_filter=ch, kernel=(k, k),
                            stride=(stride, stride), pad=(pad, pad),
                            no_bias=True, name=f"{name}_conv")
        x = sym.BatchNorm(x, fix_gamma=False, eps=1e-5, momentum=0.9,
                          name=f"{name}_bn")
        return sym.Activation(x, act_type="relu", name=f"{name}_relu") \
            if relu else x

    x = conv_bn(sym.var("data"), 64, 7, 2, 3, "stem")
    x = sym.Pooling(x, kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                    pool_type="max", name="stem_pool")
    for si, (blocks, ch) in enumerate(zip((3, 4, 6, 3),
                                          (256, 512, 1024, 2048))):
        for b in range(blocks):
            name = f"stage{si + 1}_unit{b + 1}"
            stride = 2 if b == 0 and si > 0 else 1
            h = conv_bn(x, ch // 4, 1, stride, 0, f"{name}_a")
            h = conv_bn(h, ch // 4, 3, 1, 1, f"{name}_b")
            h = conv_bn(h, ch, 1, 1, 0, f"{name}_c", relu=False)
            sc = conv_bn(x, ch, 1, stride, 0, f"{name}_proj", relu=False) \
                if b == 0 else x
            x = sym.Activation(h + sc, act_type="relu", name=f"{name}_out")
    x = sym.Pooling(x, global_pool=True, pool_type="avg", kernel=(1, 1),
                    name="pool")
    x = sym.FullyConnected(sym.Flatten(x, name="flat"), num_hidden=classes,
                           name="fc")
    return sym.SoftmaxOutput(x, name="softmax")


def sym_images(n, seed):
    """(n, 3, 224, 224) fp32 images and labels in [0, 1000), seeded."""
    import numpy as np

    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, 3, 224, 224), dtype=np.float32)
    return x, rng.integers(0, 1000, n).astype(np.float32)


def module_state(mod):
    """Copies of what a Module step writes: the executor's arguments and
    aux states, and the optimizer's states."""
    ex = mod._exec_group.execs[0]
    return ([a._data.clone() for a in ex.arg_arrays],
            [a._data.clone() for a in ex.aux_arrays],
            {i: st._data.clone() for i, st in mod._updater.states.items()
             if st is not None})


def set_module_state(mod, st):
    """Write `st` back in place (the captured steps keep their
    addresses)."""
    ex = mod._exec_group.execs[0]
    with torch.no_grad():
        for a, v in zip(ex.arg_arrays, st[0]):
            a._data.copy_(v)
        for a, v in zip(ex.aux_arrays, st[1]):
            a._data.copy_(v)
        for i, v in st[2].items():
            mod._updater.states[i]._data.copy_(v)


def module_step(mod, batch):
    """One forward_backward + update; copies of the output, every
    gradient, the aux states, the updated arguments and the momenta."""
    mod.forward_backward(batch)
    mod.update()
    ex = mod._exec_group.execs[0]
    args, aux, mom = module_state(mod)
    return ([ex.outputs[0]._data.clone()]
            + [g._data.clone() for g in ex.grad_arrays if g is not None]
            + aux + args + [mom[i] for i in sorted(mom)])


def timed_module_steps(mod, batches, steps):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(steps):
        mod.forward_backward(batches[i % len(batches)])
        mod.update()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / steps


def sym_module(net, ctx, batch, args, aux):
    """A Module of `net` on `ctx` bound for training at `batch` from the
    parameters `args`/`aux` (NDArrays), with SYM_OPT's sgd."""
    from mxnet_tpu_torch.io import DataDesc
    from mxnet_tpu_torch.module import Module

    mod = Module(net, context=ctx)
    mod.bind([DataDesc("data", (batch, 3, 224, 224))],
             [DataDesc("softmax_label", (batch,))])
    mod.init_params(arg_params=args, aux_params=aux)
    mod.init_optimizer(optimizer="sgd", optimizer_params=dict(
        SYM_OPT, rescale_grad=1.0 / batch))
    return mod


def sym_numerics(net, w_args, w_aux, card):
    """(a): one batch-8 step on the card against the port's step on the
    CPU from the same weights and batch.  In fp32 (TF32 off): the outputs
    within SYM_BOUNDS["out"] and the updates of all leaves together
    within SYM_BOUNDS["all"], each plus twice the card step's own
    sensitivity (the larger of two card steps' distance from the same
    weights, cuDNN's default fp32 algorithms not being deterministic, and
    of the card step from weights moved by 2^-24 relative); each leaf's
    fp32 distance is printed.  A leaf at a time the step is held in
    float64: at batch 8 BatchNorm over stage 4's 7x7 maps amplifies one
    fp32 rounding up to ~3e4-fold, so one fp32 leaf lands past any bound
    drawn from a second noisy sample of the same rounding; in float64
    the outputs and each leaf's update lie within SYM_BOUNDS["leaf64"]."""
    from mxnet_tpu_torch import _graphs as mxg
    from mxnet_tpu_torch import cpu, gpu
    from mxnet_tpu_torch.context import resolve
    from mxnet_tpu_torch.io import DataBatch
    from mxnet_tpu_torch.ndarray import NDArray

    x, y = sym_images(SYM_CHECK_BATCH, 3)

    def run(ctx, args, dtype=torch.float32):
        dev = resolve(ctx)
        mod = sym_module(
            net, ctx, SYM_CHECK_BATCH,
            {k: NDArray(v.to(dev, dtype)) for k, v in args.items()},
            {k: NDArray(v.to(dev, dtype)) for k, v in w_aux.items()})
        with mxg.no_capture():
            mod.forward_backward(DataBatch(
                [NDArray(torch.from_numpy(x).to(dtype))],
                [NDArray(torch.from_numpy(y).to(dtype))]))
            mod.update()
        ex = mod._exec_group.execs[0]
        out = ex.outputs[0]._data.detach().cpu().double()
        upd = {k: (ex.arg_dict[k]._data.detach().cpu().double()
                   - args[k].cpu().to(dtype).double()) for k in args}
        return out, upd

    t0 = time.perf_counter()
    out_c, upd_c = run(cpu(), w_args)
    cpu_s = time.perf_counter() - t0
    out_g, upd_g = run(gpu(0), w_args)
    out_n, upd_n = run(gpu(0), w_args)
    g = torch.Generator().manual_seed(5)
    out_w, upd_w = run(gpu(0), {k: perturb(v, 2.0 ** -24, g)
                                for k, v in w_args.items()})
    t0 = time.perf_counter()
    out_c64, upd_c64 = run(cpu(), w_args, torch.float64)
    cpu64_s = time.perf_counter() - t0
    out_g64, upd_g64 = run(gpu(0), w_args, torch.float64)

    def rel(a, b):
        return float((a - b).norm() / b.norm().clamp_min(1e-300))
    e_out = rel(out_g, out_c)
    s_out = max(rel(out_w, out_g), rel(out_n, out_g))
    e_all = rel_l2_all(upd_g, upd_c)
    s_all = max(rel_l2_all(upd_w, upd_g), rel_l2_all(upd_n, upd_g))
    e = {k: rel(upd_g[k], upd_c[k]) for k in upd_c}
    nondet = sum(not torch.equal(upd_n[k], upd_g[k]) for k in upd_c)
    past = sum(v > SYM_BOUNDS["leaf"] for v in e.values())
    med = sorted(e.values())[len(e) // 2]
    e_out64 = rel(out_g64, out_c64)
    e64 = {k: rel(upd_g64[k], upd_c64[k]) for k in upd_c64}
    over64 = sorted(k for k, v in e64.items() if v > SYM_BOUNDS["leaf64"])
    worst64 = max(e64.items(), key=lambda kv: kv[1])
    print(f"sym numerics: fp32 batch {SYM_CHECK_BATCH} step, card vs cpu "
          f"(cpu step {cpu_s:.1f} s): outputs rel L2 {e_out:.3g} "
          f"(sensitivity {s_out:.3g}, bound {SYM_BOUNDS['out']} + 2x), all "
          f"{len(e)} leaves' updates together {e_all:.3g} (sensitivity "
          f"{s_all:.3g}, bound {SYM_BOUNDS['all']} + 2x), a leaf at a "
          f"time: median {med:.3g}, worst {max(e.values()):.3g}, {past} "
          f"past {SYM_BOUNDS['leaf']} (two card steps from one state "
          f"differ on {nondet} leaves); float64 (cpu step {cpu64_s:.1f} "
          f"s): outputs {e_out64:.3g}, worst leaf {worst64[1]:.3g} "
          f"({worst64[0]}), {len(over64)} past {SYM_BOUNDS['leaf64']} "
          f"[{card}]", flush=True)
    if e_out > SYM_BOUNDS["out"] + 2 * s_out \
            or e_all > SYM_BOUNDS["all"] + 2 * s_all \
            or e_out64 > SYM_BOUNDS["leaf64"] or over64:
        fail(f"sym numerics: fp32 outputs {e_out} (sensitivity {s_out}), "
             f"updates {e_all} (sensitivity {s_all}); float64 outputs "
             f"{e_out64}, leaves past {SYM_BOUNDS['leaf64']} {over64[:5]}")
    return dict(out_rel=e_out, out_sensitivity=s_out, all_rel=e_all,
                all_sensitivity=s_all, leaf_median=med,
                leaf_worst=max(e.values()), leaves_past=past,
                nondeterministic_leaves=nondet, cpu_s=cpu_s,
                out_rel64=e_out64, leaf_worst64=worst64[1],
                leaves_over64=len(over64), cpu64_s=cpu64_s)


def sym_train(card):
    """(a): ResNet-50 v1 over mx.sym through Module.fit, then the timed
    captured and eager steps, the bit-for-bit comparison, the checkpoint
    round trip and the card-vs-cpu step."""
    import gc

    import numpy as np

    from mxnet_tpu_torch import _graphs as mxg
    from mxnet_tpu_torch import gpu, init, sym
    from mxnet_tpu_torch.io import NDArrayIter
    from mxnet_tpu_torch.module import Module
    from mxnet_tpu_torch.optimizer import fused

    net = resnet50_v1_sym(sym)
    arg_shapes = net.infer_shape(data=(SYM_BATCH, 3, 224, 224))[0]
    n_params = sum(int(np.prod(s)) for n, s in zip(net.list_arguments(),
                                                    arg_shapes)
                   if n not in ("data", "softmax_label"))
    x, y = sym_images(SYM_BATCH * SYM_FIT_BATCHES, 0)
    it = NDArrayIter(x, y, batch_size=SYM_BATCH, shuffle=False)
    mod = Module(net, context=gpu(0))
    t0 = time.perf_counter()
    mod.fit(it, num_epoch=1, optimizer="sgd", optimizer_params=SYM_OPT,
            initializer=init.Xavier(rnd_type="gaussian", factor_type="in",
                                    magnitude=2), eval_metric="acc")
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    it.reset()
    batches = list(it)
    builds = sym.executor_stats()["count"]
    cap_ms = timed_module_steps(mod, batches, SYM_TIMED_STEPS) * 1e3
    with mxg.no_capture():
        eager_ms = timed_module_steps(mod, batches, SYM_TIMED_STEPS) * 1e3
    finite = bool(torch.isfinite(mod.get_outputs()[0]._data).all())

    def step():
        mod.forward_backward(batches[0])
        mod.update()
    prof = profile_device(step, "sym train captured", "step", card, cap_ms,
                          iters=2, top=8)
    with mxg.no_capture():
        prof_e = profile_device(step, "sym train eager", "step", card,
                                eager_ms, iters=1, top=0)
    cap_s, gib = graph_costs(mod._exec_group.execs[0].graphs()
                             + fused._FUSED_CACHE.entries(mod._updater))
    print(f"sym resnet50_v1 ({n_params} parameters) Module.fit fp32 batch "
          f"{SYM_BATCH} at 224x224, sgd lr 0.1 momentum 0.9 wd 1e-4: one "
          f"epoch of {SYM_FIT_BATCHES} batches in {fit_s:.2f} s with the "
          f"captures; captured {cap_ms:.2f} ms/step, "
          f"{SYM_BATCH / cap_ms * 1e3:.1f} img/s, idle {pct(idle_of(prof))};"
          f" eager {eager_ms:.2f} ms/step, idle {pct(idle_of(prof_e))}; "
          f"capture {cap_s:.2f} s, graph pool {gib:.2f} GiB; outputs "
          f"finite {finite} [{card}]", flush=True)
    if not finite:
        fail("sym train: outputs not finite")
    res = dict(parameters=n_params, fit_s=fit_s, captured_ms=cap_ms,
               eager_ms=eager_ms, img_per_s=SYM_BATCH / cap_ms * 1e3,
               idle=idle_of(prof), idle_eager=idle_of(prof_e),
               capture_s=cap_s, pool_gib=gib)
    # a replayed step against an eager step from one state, bit for bit.
    # cuDNN's default fp32 algorithms are not deterministic (two eager
    # steps from one state differ), so a second Module from these weights
    # is built, captured and compared under cudnn.deterministic
    st = module_state(mod)
    with mxg.no_capture():
        first = module_step(mod, batches[1])
        set_module_state(mod, st)
        again = module_step(mod, batches[1])
    set_module_state(mod, st)
    nondet = len(first) - sum(same_bits(first, again))
    del first, again, st
    w_args, w_aux = mod.get_params()
    torch.backends.cudnn.deterministic = True
    try:
        det = sym_module(net, gpu(0), SYM_BATCH, w_args, w_aux)
        for b in batches[:2]:  # builds the step and the update, replays
            det.forward_backward(b)
            det.update()
        builds = sym.executor_stats()["count"]
        st = module_state(det)
        got = module_step(det, batches[1])
        rebuilt = sym.executor_stats()["count"] - builds
        set_module_state(det, st)
        with mxg.no_capture():
            want = module_step(det, batches[1])
        same = same_bits(got, want)
        det_ms = timed_module_steps(det, batches, SYM_TIMED_STEPS) * 1e3
    finally:
        torch.backends.cudnn.deterministic = False
    print(f"compiled: sym resnet50_v1 Module step fp32 batch {SYM_BATCH}: "
          f"two eager steps from one state with cuDNN's default algorithms "
          f"differ in {nondet} of {len(same)} tensors; under "
          f"cudnn.deterministic ({det_ms:.2f} ms/step captured) replayed "
          f"vs eager from one state, {len(same)} tensors (output, "
          f"gradients, moving statistics, weights, momenta) bit-identical "
          f"{sum(same)}/{len(same)}; builds during it {rebuilt} [{card}]",
          flush=True)
    if not all(same) or rebuilt:
        fail(f"sym compiled step: {len(same) - sum(same)} tensors differ, "
             f"{rebuilt} builds")
    res["compiled"] = dict(tensors=len(same), identical=sum(same),
                           builds=rebuilt, eager_vs_eager_differ=nondet,
                           deterministic_captured_ms=det_ms)
    del det
    del got, want, st
    # save_checkpoint -> Module.load -> predict
    pit = NDArrayIter(x[:SYM_PREDICT], y[:SYM_PREDICT],
                      batch_size=SYM_BATCH)
    before = mod.predict(pit)._data
    prefix = os.path.join("build", "chip_smoke_sym", "resnet50_v1")
    os.makedirs(os.path.dirname(prefix), exist_ok=True)
    mod.save_checkpoint(prefix, 1)
    loaded = Module.load(prefix, 1, context=gpu(0))
    loaded.bind(pit.provide_data, pit.provide_label, for_training=False)
    after = loaded.predict(pit)._data
    diff = float((after - before).abs().max())
    print(f"sym checkpoint: save_checkpoint -> Module.load -> predict over "
          f"{SYM_PREDICT} images: max abs diff {diff:.3g}, bit-identical "
          f"{torch.equal(after, before)} [{card}]", flush=True)
    if diff > 0:
        fail(f"sym checkpoint: predictions differ by {diff}")
    res["checkpoint_max_abs"] = diff
    w_args, w_aux = mod.get_params()
    w_args = {k: v._data.cpu() for k, v in w_args.items()}
    w_aux = {k: v._data.cpu() for k, v in w_aux.items()}
    KEEP["sym_resnet50"] = (w_args, w_aux)  # phases 19 (c) and 20 use it
    del mod, loaded, batches, before, after
    gc.collect()
    torch.cuda.empty_cache()
    res["numerics"] = sym_numerics(net, w_args, w_aux, card)
    return res


def sym_attention(card, rec_att):
    """(b): sym.dot_product_attention at BERT-base's shapes against the op
    it wraps, bit for bit, kernel 5 once a forward."""
    from mxnet_tpu_torch import gpu, sym
    from mxnet_tpu_torch.ndarray import NDArray
    from mxnet_tpu_torch.ops import attention as att

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(11)
    shape = (BATCH, BERT_SEQ, BERT_UNITS)
    q, k, v = (torch.randn(*shape, generator=gen, device=dev)
               .to(torch.bfloat16) for _ in range(3))
    lengths = torch.randint(1, BERT_SEQ + 1, (BATCH,), generator=gen,
                            device=dev)
    m = (torch.arange(BERT_SEQ, device=dev)[None] < lengths[:, None]) \
        .to(torch.bfloat16)
    node = sym.dot_product_attention(sym.var("q"), sym.var("k"),
                                     sym.var("v"), valid_mask=sym.var("m"),
                                     num_heads=BERT_HEADS, name="att")
    ex = node.bind(gpu(0), {n: NDArray(t) for n, t in
                            zip("qkvm", (q, k, v, m))}, grad_req="null")
    ref = att.dot_product_attention(q, k, v, valid_mask=m,
                                    num_heads=BERT_HEADS)
    torch.cuda.synchronize()
    reset_kernel_counts()
    same = [torch.equal(ex.forward()[0]._data, ref)
            for _ in range(SYM_CALLS)]
    torch.cuda.synchronize()
    counts = kernel_counts()
    sym_ms = time_ms(lambda: ex.forward())
    print(f"sym attention ({BATCH} x {BERT_HEADS} heads, {BERT_SEQ} tokens, "
          f"D {BERT_UNITS // BERT_HEADS}, bf16): {SYM_CALLS} bound forwards "
          f"bit-identical to the op {sum(same)}/{SYM_CALLS}; launches "
          f"{counts}; a forward {sym_ms:.4f} ms by CUDA events (the "
          f"kernel's launch step {rec_att['kernel_ms']:.4f}) [{card}]",
          flush=True)
    if not all(same) or counts != {"k1": 0, "k2": 0, "k5": SYM_CALLS,
                                   "k6": 0}:
        fail(f"sym attention: identical {same}, launches {counts}")
    return dict(identical=sum(same), launches=counts["k5"], ms=sym_ms)


def sym_fused_unit(card):
    """(c): a sym.FusedConvUnit node's train steps against a direct
    fused_conv_unit call with ones cotangents, bit for bit, kernels 1
    and 2 once a step; then the two kernels' checks at this shape."""
    from mxnet_tpu_torch import gpu, sym
    from mxnet_tpu_torch.ndarray import NDArray
    from mxnet_tpu_torch.ops import fused_convbn as fcb

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(12)
    n, hw, ci, co, k = SYM_UNIT
    x, w, sc, bi, sh = make_unit_inputs(gen, n, hw, ci, co, k,
                                        torch.bfloat16, dev)
    names = ("data", "weight", "in_scale", "in_bias", "shift")
    kw = dict(kernel=(k, k), stride=(1, 1), pad=(1, 1), act_in=True)
    node = sym.FusedConvUnit(*[sym.var(nm) for nm in names], name="unit",
                             **kw)
    ex = node.bind(gpu(0), {nm: NDArray(t) for nm, t in
                            zip(names, (x, w, sc, bi, sh))},
                   grad_req={nm: "write" for nm in names[:4]})
    leaves = [t.detach().clone().requires_grad_() for t in (x, w, sc, bi)]
    outs = fcb.fused_conv_unit(*leaves, sh, **kw)
    grads = torch.autograd.grad(outs, leaves,
                                [torch.ones_like(o) for o in outs])
    want = [o.detach() for o in outs] + list(grads)
    torch.cuda.synchronize()
    reset_kernel_counts()
    same = []
    for _ in range(SYM_CALLS):
        got = [o._data for o in ex.forward(is_train=True)]
        ex.backward()
        got += [ex.grad_dict[nm]._data for nm in names[:4]]
        same.append(all(same_bits(got, want)))
    torch.cuda.synchronize()
    counts = kernel_counts()
    print(f"sym fused unit (N {n}, {hw}x{hw}, {ci}->{co}, {k}x{k}, bf16 "
          f"NHWC, statistics): {SYM_CALLS} train steps, y/s1/s2 and 4 "
          f"gradients bit-identical to a direct fused_conv_unit call with "
          f"ones cotangents {sum(same)}/{SYM_CALLS}; launches {counts} "
          f"[{card}]", flush=True)
    if not all(same) or counts != {"k1": SYM_CALLS, "k2": SYM_CALLS,
                                   "k5": 0, "k6": 0}:
        fail(f"sym fused unit: identical {same}, launches {counts}")
    print("kernels 1 and 2 vs their plain versions at the sym node's shape:",
          flush=True)
    rec1 = check_unit("sym.unit", x, w, sc, bi, sh, k, 1, 1, True, True)
    rec2 = check_unit_bwd("sym.unit", x, w, sc, bi, sh, k, 1, True, True,
                          gen)
    return dict(identical=sum(same), launches_k1=counts["k1"],
                launches_k2=counts["k2"]), rec1, rec2


def sym_kernel_record(kernel, rec, launches):
    """The `kernels` record of kernel 1 or 2 on phase 11's sym node: one
    call at its shape."""
    return dict(kernel, path="sym_fused_unit", batch=rec["shape"][0],
                launches=launches, max_abs_err=rec["max_abs_err"],
                ms=rec["kernel_ms"], op_ms=rec["op_ms"],
                plain_ms=rec["ref_ms"], bound_ms=rec["bound_ms"],
                bound_by=rec["bound_by"], library_ms=rec["library_ms"])


def phase_symbolic(card, recs_att):
    """MXNet's symbolic API on the card: (a) Module.fit of ResNet-50 v1,
    (b) attention and (c) the fused unit through their sym nodes.
    Returns (results, the three `kernels` records)."""
    import gc

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    set_knobs(True, True)
    res = {"train": sym_train(card)}
    gc.collect()
    torch.cuda.empty_cache()
    res["attention"] = sym_attention(card, recs_att["bert.packed"])
    res["unit"], rec1, rec2 = sym_fused_unit(card)
    res["seconds"] = time.perf_counter() - t_phase
    print(f"symbolic phase: {res['seconds']:.1f} s [{card}]", flush=True)
    print("symbolic: " + json.dumps(res, default=str), flush=True)
    kernels = [
        sym_kernel_record(dict(KERNEL, name="fused_conv_unit/sym"), rec1,
                          res["unit"]["launches_k1"]),
        sym_kernel_record(dict(KERNEL_BWD, name="fused_conv_unit_bwd/sym"),
                          rec2, res["unit"]["launches_k2"]),
        attention_path_summary(
            dict(KERNEL_ATT, name="dot_product_attention/sym"),
            "sym_attention", [(recs_att["bert.packed"], 1)],
            res["attention"]["launches"], BATCH)]
    return res, kernels


# ---------------------------------------------------------------------------
# phase 12: Gluon as MXNet users write it — the captured hybridized
# training loop on BERT-base, gradient mirroring, two forwards in flight,
# deferred shapes through Estimator.fit, the SSD example
# ---------------------------------------------------------------------------

KEEP = {}  # nets and batches of earlier phases that later phases reuse
MIRROR_BATCH = 256
INFLIGHT_BATCH = 32
SSD_GLUON_ARGS = ["--batch-size", "8", "--steps", "4"]


def bert_gluon_steps(net, trainer, batch, steps):
    """examples/bert_pretrain.py's loop (its lines 196-209): the
    hybridized net and its two heads under record(), the masked MLM loss
    and the NSP loss, backward, trainer.step(batch)."""
    from mxnet_tpu_torch import autograd, gluon, nd

    tokens, segments, vlen, mlm_y, mlm_w, nsp_y = (nd.NDArray(t)
                                                   for t in batch)
    b, s = batch[0].shape
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    losses = []
    for _ in range(steps):
        with autograd.record():
            seq, pooled = net(tokens, segments, vlen)
            mlm_scores = net.decode_mlm(seq)
            nsp_scores = net.classify_nsp(pooled)
            per_sample = loss_fn(mlm_scores, mlm_y, mlm_w.expand_dims(-1))
            denom = nd.maximum(mlm_w.sum(), nd.ones((1,), ctx=mlm_w.ctx))
            mlm_l = per_sample.sum() * float(s) / denom
            loss = mlm_l + loss_fn(nsp_scores, nsp_y).mean()
        loss.backward()
        trainer.step(b)
        losses.append(loss.data.detach().clone())
    return losses


def bert_gluon_case(tag, net, w0, batch, card, want_k5, dropout,
                    opt="adam", opt_params=None, profile=False):
    """BERT-base through the hybridized gluon.Trainer loop (Adam lr
    BERT_TRAIN_LR unless `opt` and `opt_params` are given), captured
    against eager from one state and one generator state (1 + CAPTURE_K
    steps each, fresh trainers); with dropout, two generator states give
    two losses; with `profile`, the idle share of one captured step."""
    from mxnet_tpu_torch import _graphs as graphs
    from mxnet_tpu_torch import gluon
    from mxnet_tpu_torch import random as mrandom
    from mxnet_tpu_torch.gluon import block as gblock

    net.hybridize()
    for blk in (net, net.mlm_decoder, net.classifier):
        drop_cached_op(blk)  # an earlier run's entries of the net and heads
    gen = mrandom.generator(batch[0].device)
    g0 = gen.get_state()
    steps = 1 + CAPTURE_K
    runs, ms = {}, {}
    for mode in ("captured", "eager"):
        restore(net, w0)
        gen.set_state(g0)
        tr = gluon.Trainer(net.collect_params(), opt, dict(
            opt_params or {"learning_rate": BERT_TRAIN_LR}))
        n0 = gblock.cached_op_stats()["count"]
        torch.cuda.synchronize()
        reset_kernel_counts()
        with contextlib.ExitStack() as stack:
            if mode == "eager":
                stack.enter_context(graphs.no_capture())
            losses = bert_gluon_steps(net, tr, batch, steps)
            torch.cuda.synchronize()
            counts = kernel_counts()
            t0 = time.perf_counter()
            bert_gluon_steps(net, tr, batch, CAPTURE_K)
            torch.cuda.synchronize()
            ms[mode] = (time.perf_counter() - t0) / CAPTURE_K * 1e3
        runs[mode] = (losses, counts, gblock.cached_op_stats()["count"] - n0,
                      gluon_state(net, tr), tr)
    c, e = runs["captured"], runs["eager"]
    bad = [k for k in c[3] if not torch.equal(c[3][k], e[3][k])]
    bad += [f"loss {i}" for i in range(steps)
            if not torch.equal(c[0][i], e[0][i])]
    want = {"k1": 0, "k2": 0, "k5": want_k5 * steps, "k6": 0}
    # the net and its two hybridized heads: three CachedOps, each one
    # forward/backward build after its warm-up
    if bad or c[1] != want or e[1] != want or c[2] != 3 or e[2] != 0:
        fail(f"{tag}: captured vs eager {bad[:6]}, launches {c[1]} / "
             f"{e[1]} (want {want}), builds {c[2]}/{e[2]} (want 3/0)")
    masks = None
    if dropout:
        tr = c[4]
        restore(net, w0)
        gen.set_state(g0)
        a = bert_gluon_steps(net, tr, batch, 1)[0]
        restore(net, w0)
        b = bert_gluon_steps(net, tr, batch, 1)[0]
        masks = not torch.equal(a, b)
        if not masks:
            fail(f"{tag}: two generator states gave one loss")
    idle = None
    if profile:
        idle = idle_of(profile_device(
            lambda: bert_gluon_steps(net, c[4], batch, 1), f"{tag} captured",
            "step", card, ms["captured"], iters=1, top=6))
    pairs = [p for blk in (net, net.mlm_decoder, net.classifier)
             for p in train_pairs(blk)]
    cap_s, gib = graph_costs(pairs)
    print(f"{tag}: captured {ms['captured']:.2f} ms/step (idle "
          f"{pct(idle)}), eager "
          f"{ms['eager']:.2f} ms/step ({ms['eager'] / ms['captured']:.3f}x); "
          f"{steps} steps bit-identical {not bad} ({len(c[3])} tensors); "
          f"launches in {steps} steps {c[1]}; builds {c[2]}; capture "
          f"{cap_s:.2f} s, graph pools {gib:.2f} GiB; losses "
          f"{' '.join(f'{float(v):.4f}' for v in c[0])}; masks differ "
          f"across generator states {masks} [{card}]", flush=True)
    return dict(captured_ms=ms["captured"], eager_ms=ms["eager"],
                identical=not bad, launches=c[1]["k5"], steps=steps,
                capture_s=cap_s, pool_gib=gib, masks_differ=masks,
                idle_captured=idle)


def mirror_case(net, w0, xb, yb, card):
    """(b) ResNet-50 at batch MIRROR_BATCH: one captured step of the
    hybridized gluon.Trainer loop with hybridize(mirror=True) against
    the same step without mirror, from w0: every gradient, updated
    weight, momentum and running statistic bit for bit (where cuDNN's
    algorithm choice breaks that, again under cudnn.deterministic); the
    pool, the peak memory over the warm-up, the build and the step, and
    the ms a step of CAPTURE_K more captured steps of each; kernel-1
    launches a step."""
    res = {}
    for det in (False, True):
        old_det = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = det
        try:
            for mirror in (False, True):
                net.hybridize(mirror=mirror)
                drop_cached_op(net)
                torch.cuda.reset_peak_memory_stats()
                tr = gluon_trainer(net)
                restore(net, w0)
                gluon_steps(net, tr, xb, yb, 2)  # warm-up, build
                restore(net, w0)
                tr = gluon_trainer(net)
                torch.cuda.synchronize()
                reset_kernel_counts()
                loss = gluon_steps(net, tr, xb, yb, 1)[0][0]
                torch.cuda.synchronize()
                counts = kernel_counts()
                st = gluon_state(net, tr)
                for k, p in net.collect_params().items():
                    if p.grad_req != "null":
                        st[f"grad {k}"] = p.grad()._data.clone()
                peak = torch.cuda.max_memory_allocated() / 2 ** 30
                dt = gluon_steps(net, tr, xb, yb, CAPTURE_K)[3]
                res[mirror] = dict(
                    state=st, loss=loss, counts=counts, peak_gib=peak,
                    pool_gib=graph_costs(train_pairs(net))[1], ms=dt * 1e3)
        finally:
            torch.backends.cudnn.deterministic = old_det
        a, b = res[False], res[True]
        bad = [k for k in a["state"]
               if not torch.equal(a["state"][k], b["state"][k])]
        if not bad or det:
            break
        print(f"mirror: {len(bad)} tensors differ under cuDNN's default "
              f"algorithms ({bad[:3]}); again under cudnn.deterministic",
              flush=True)
    moved = [k for k in a["state"] if k.endswith("running_mean")
             and not torch.equal(a["state"][k], w0[k])]
    print(f"mirror ResNet-50 bf16 batch {xb.shape[0]}: one step with "
          f"mirror bit-identical to the plain captured step {not bad} "
          f"({len(a['state'])} tensors: gradients, weights, momenta, running "
          f"statistics{', cudnn.deterministic' if det else ''}); pool "
          f"{a['pool_gib']:.2f} GiB plain, {b['pool_gib']:.2f} GiB mirror; "
          f"peak allocated over warm-up, build and step {a['peak_gib']:.2f} "
          f"/ {b['peak_gib']:.2f} GiB; {CAPTURE_K} more captured steps "
          f"{a['ms']:.2f} / {b['ms']:.2f} ms a step; "
          f"launches a step plain {a['counts']} mirror {b['counts']}; "
          f"{len(moved)} running means advanced [{card}]", flush=True)
    if bad or not moved or b["counts"]["k1"] < FWD_PER_STEP \
            or b["counts"]["k2"] != BWD_PER_STEP:
        fail(f"mirror: {len(bad)} tensors differ ({bad[:6]}), "
             f"{len(moved)} running means advanced, launches "
             f"{b['counts']}")
    net.hybridize(mirror=False)
    drop_cached_op(net)
    return dict(identical=not bad, deterministic=det,
                pool_gib={"plain": a["pool_gib"], "mirror": b["pool_gib"]},
                peak_gib={"plain": a["peak_gib"], "mirror": b["peak_gib"]},
                ms={"plain": a["ms"], "mirror": b["ms"]},
                k1_per_step=b["counts"]["k1"])


def inflight_case(net, w0, xb, yb, card):
    """(c) The net called twice under one record() (a siamese loss) at
    batch INFLIGHT_BATCH, captured against eager: the gradients and
    running statistics bit for bit, two pairs built; a second backward
    through the consumed pairs raises."""
    from mxnet_tpu_torch import _graphs as graphs
    from mxnet_tpu_torch import autograd, gluon, nd
    from mxnet_tpu_torch.base import MXNetError
    from mxnet_tpu_torch.gluon import block as gblock

    n = INFLIGHT_BATCH
    x1, x2 = nd.NDArray(xb[:n]), nd.NDArray(xb[n:2 * n])
    y1, y2 = nd.NDArray(yb[:n]), nd.NDArray(yb[n:2 * n])
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    drop_cached_op(net)
    restore(net, w0)
    gluon_steps(net, gluon_trainer(net), xb[:n], yb[:n], 1)  # warm-up

    def pair_loss():
        with autograd.record():
            loss = loss_fn(net(x1), y1).sum() + loss_fn(net(x2), y2).sum()
        return loss

    res = {}
    for mode in ("captured", "eager"):
        restore(net, w0)
        n0 = gblock.cached_op_stats()["count"]
        reset_kernel_counts()
        with contextlib.ExitStack() as stack:
            if mode == "eager":
                stack.enter_context(graphs.no_capture())
            loss = pair_loss()
            loss.backward(retain_graph=True)
        torch.cuda.synchronize()
        st = snapshot(net)
        for k, p in net.collect_params().items():
            if p.grad_req != "null":
                st[f"grad {k}"] = p.grad()._data.clone()
        raised = None
        if mode == "captured":
            try:
                loss.backward()
                raised = False
            except MXNetError:
                raised = True
        res[mode] = (st, kernel_counts(),
                     gblock.cached_op_stats()["count"] - n0, raised,
                     float(loss.asnumpy()))
    c, e = res["captured"], res["eager"]
    bad = [k for k in c[0] if not torch.equal(c[0][k], e[0][k])]
    print(f"in flight: two calls of ResNet-50 bf16 batch {n} under one "
          f"record(): gradients and running statistics bit-identical to "
          f"eager {not bad} ({len(c[0])} tensors); pairs built {c[2]}; "
          f"launches {c[1]} / eager {e[1]}; a second backward through the "
          f"consumed pairs raised {c[3]}; loss {c[4]:.4f} [{card}]",
          flush=True)
    if bad or c[2] != 2 or c[3] is not True or c[1] != e[1]:
        fail(f"in flight: {bad[:6]} differ, {c[2]} builds (want 2), "
             f"second backward raised {c[3]}, launches {c[1]} / {e[1]}")
    drop_cached_op(net)
    return dict(identical=not bad, builds=c[2], second_backward_raised=c[3],
                launches=c[1])


def estimator_case(card, dev=torch.device("cuda", 0)):
    """(d) The reference MNIST network (deferred shapes) trained by
    Estimator.fit on cuda:0 for one epoch, as the example's --estimator
    path runs it."""
    from mxnet_tpu_torch.examples import mnist

    keep = {}
    t0 = time.perf_counter()
    acc = mnist.run(epochs=1, ctx=dev, batch_size=100, keep=keep,
                    estimator=True)
    wall = time.perf_counter() - t0
    params = keep["net"].collect_params()
    shapes = [p.shape for k, p in params.items() if k.endswith("weight")]
    on_card = [p.data().data.device == dev and p.grad().data.device == dev
               for p in params.values()]
    states = [s for st in keep["trainer"]._updater.states.values()
              for s in (st if isinstance(st, tuple) else (st,))]
    on_card += [s.data.device == dev for s in states]
    print(f"estimator mnist: val accuracy {acc:.4f} after {keep['steps']} "
          f"steps of 100 through Estimator.fit, {keep['samples_per_s']:.0f} "
          f"samples/s, {wall:.2f} s; resolved shapes {shapes}; "
          f"{sum(on_card)} of {len(on_card)} parameters, gradients and "
          f"states on {dev} [{card}]", flush=True)
    if not acc > 0.9 or not all(on_card) \
            or shapes != [(128, 784), (64, 128), (10, 64)]:
        fail(f"estimator mnist: accuracy {acc:.4f}, shapes {shapes}, "
             f"{len(on_card) - sum(on_card)} tensors off {dev}")
    return dict(val_accuracy=acc, shapes=shapes, wall_s=wall,
                samples_per_s=keep["samples_per_s"])


def ssd_gluon_case(card):
    """(e) examples/ssd_train.py at batch 8 with
    hybridize(static_alloc=True), captured and under no_capture, under
    cudnn.deterministic (its NCHW fp32 backbone's default cuDNN
    algorithms are not deterministic): the losses bit for bit, the ms a
    step of each."""
    from mxnet_tpu_torch import _graphs as graphs
    from mxnet_tpu_torch import random as mrandom
    from mxnet_tpu_torch.examples import ssd_train

    old = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    runs = {}
    try:
        for mode in ("captured", "eager"):
            mrandom.seed(0)
            keep = {}
            with contextlib.ExitStack() as stack:
                if mode == "eager":
                    stack.enter_context(graphs.no_capture())
                losses = ssd_train.main(SSD_GLUON_ARGS, keep=keep)
            torch.cuda.synchronize()
            runs[mode] = (losses, keep["step_s"], train_pairs(keep["net"]))
            del keep
    finally:
        torch.backends.cudnn.deterministic = old
    (lc, sc, pc), (le, se, _) = runs["captured"], runs["eager"]
    ms = {m: sum(r[1][2:]) / len(r[1][2:]) * 1e3 for m, r in runs.items()}
    print(f"ssd example batch 8 hybridize(static_alloc=True): losses "
          f"captured {lc} eager {le}, identical {lc == le}; after the "
          f"warm-up and build steps {ms['captured']:.1f} ms/step captured, "
          f"{ms['eager']:.1f} ms/step eager (cudnn.deterministic); "
          f"{len(pc)} captured pairs [{card}]", flush=True)
    if lc != le or not pc:
        fail(f"ssd example: captured losses {lc} != eager {le} or no "
             f"captured pair ({len(pc)})")
    return dict(losses=lc, identical=lc == le, ms=ms)


def phase_gluon(card):
    """Phase 12 (see the module docstring)."""
    import gc

    t0 = time.perf_counter()
    res = {}
    bert = KEEP["bert"]  # phase 13 (b) trains its dropout-0 net again
    for dropout, step in (("0", bert["dropout0"]), ("0.1", bert["dropout"])):
        res[f"bert_dropout{dropout}"] = bert_gluon_case(
            f"gluon bert-base dropout {dropout} bf16 batch "
            f"{bert['batch'][0].shape[0]} x {BERT_SEQ}", step.bert,
            {k[len("bert."):]: v for k, v in bert["w0"].items()},
            bert["batch"], card, BERT_LAYERS if dropout == "0" else 0,
            dropout != "0")
        drop_cached_op(step.bert)
    del bert, step
    gc.collect()
    torch.cuda.empty_cache()
    r50 = KEEP["resnet"]  # and phase 13 (c) this one
    net, w0, xb, yb = r50["net"], r50["w0"], r50["x"], r50["y"]
    res["mirror"] = mirror_case(net, w0, xb[:MIRROR_BATCH],
                                yb[:MIRROR_BATCH], card)
    res["inflight"] = inflight_case(net, w0, xb, yb, card)
    del net, r50
    gc.collect()
    torch.cuda.empty_cache()
    res["estimator"] = estimator_case(card)
    res["ssd"] = ssd_gluon_case(card)
    res["seconds"] = time.perf_counter() - t0
    print(f"gluon (phase 12): {res['seconds']:.1f} s; " + json.dumps(res),
          flush=True)
    return res


# ---------------------------------------------------------------------------
# phase 13: every optimizer on the card — the captured update of each at
# ResNet-50's parameter list, BERT-base with LAMB through gluon.Trainer,
# ResNet-50 with centred RMSProp through SPMDTrainer
# ---------------------------------------------------------------------------

# the JAX package's tests/test_fused_step.py CASES
OPT_CASES = [("sgd", {"momentum": 0.9, "wd": 0.01}), ("sgd", {}),
             ("nag", {"momentum": 0.9}), ("adam", {}), ("adagrad", {}),
             ("adadelta", {}), ("adamax", {}), ("nadam", {}),
             ("rmsprop", {}), ("rmsprop", {"centered": True}), ("ftrl", {}),
             ("signum", {"momentum": 0.9}), ("signsgd", {}), ("lamb", {}),
             ("test", {})]
OPT_STEPS, OPT_TIMED = 2, 3   # steps held (3 before phase 21, the
# script's time); captured updates timed after
OPT_RESCALE = 0.5
OPT_BOUND = 1e-5   # card vs CPU, of each fp32 tensor's largest magnitude
LAMB_OPT = {"learning_rate": 1e-3, "multi_precision": True}
RMSPROP_OPT = {"learning_rate": 1e-3, "centered": True, "wd": 1e-4,
               "multi_precision": True}


def flat_states(states):
    """An Updater's states as one list of tensors, in index order."""
    out = []

    def walk(s):
        if s is None:
            return
        if isinstance(s, tuple):
            for x in s:
                walk(x)
        else:
            out.append(s._data)
    for i in sorted(states):
        walk(states[i])
    return out


def optimizer_run(name, kw, mp, ws, gs, dev, captured):
    """OPT_STEPS updates of every weight from `ws` with the gradients
    `gs` (one list a step): FusedUpdater.update_all (captured on the
    card after its first, eager, call) or the eager per-parameter
    Updater; the gradient buffers keep their addresses, as a Trainer's
    do.  Returns (weights, flat states, updater, its inputs)."""
    from mxnet_tpu_torch import nd, optimizer

    upd = optimizer.FusedUpdater(optimizer.create(
        name, **dict(kw, rescale_grad=OPT_RESCALE, multi_precision=mp)))
    w = [nd.NDArray(t.to(dev).clone()) for t in ws]
    g = [nd.NDArray(torch.empty_like(t, device=dev)) for t in gs[0]]
    idx = list(range(len(w)))
    for step in gs:
        with torch.no_grad():
            for b, t in zip(g, step):
                b._data.copy_(t)
        if captured:
            upd.update_all(idx, g, w)
        else:
            for i in idx:
                upd(i, g[i], w[i])
    return [t._data for t in w], flat_states(upd.states), upd, (idx, g, w)


def optimizer_case(name, kw, mp, shapes, card, dev=None):
    """(a) one case at ResNet-50's parameter list: captured against eager
    on the card, bit for bit; the card against the port's CPU update of
    the same inputs (fp32 tensors within OPT_BOUND of their largest
    magnitude, bf16 weights within one bf16 ulp); then the captured
    update timed."""
    from mxnet_tpu_torch.optimizer import fused as ofused

    dev = dev or torch.device("cuda", 0)
    # drawn on the card (the CPU's generator took seconds a case), the
    # CPU run gets copies of the same values
    gen = torch.Generator(device=dev).manual_seed(13)
    dt = torch.bfloat16 if mp else torch.float32
    ws = [torch.randn(s, generator=gen, device=dev).to(dt) for s in shapes]
    gs = [[(0.1 * torch.randn(s, generator=gen, device=dev)).to(dt)
           for s in shapes] for _ in range(OPT_STEPS)]
    gs_cpu = [[t.cpu() for t in step] for step in gs]
    n0 = ofused.compile_stats()["count"]
    cw, cs, upd, args = optimizer_run(name, kw, mp, ws, gs, dev, True)
    builds = ofused.compile_stats()["count"] - n0
    ew, es, _, _ = optimizer_run(name, kw, mp, ws, gs, dev, False)
    pw, ps, _, _ = optimizer_run(name, kw, mp, ws, gs_cpu,
                                 torch.device("cpu"), False)
    bad = [i for i, (a, b) in enumerate(zip(cw + cs, ew + es))
           if not torch.equal(a, b)]
    worst, same = 0.0, 0
    for a, b in zip(ew + es, pw + ps):
        a = a.cpu()
        same += int(torch.equal(a, b))
        if a.dtype == torch.bfloat16:
            a32, b32 = a.float(), b.float()
            over = ((a32 - b32).abs() > bf16_ulp(torch.maximum(
                a32.abs(), b32.abs()))).sum().item()
            worst = max(worst, float("inf") if over else 0.0)
        else:
            mag = b.abs().max().item()
            d = (a - b).abs().max().item()
            worst = max(worst, d / mag if mag else d)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(OPT_TIMED):
        upd.update_all(*args)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / OPT_TIMED * 1e3
    tag = f"{name}{'(centered)' if kw.get('centered') else ''}" \
        f"{' ' + str(kw) if kw and not kw.get('centered') else ''}"
    prec = "bf16 multi_precision" if mp else "fp32"
    print(f"optimizer {tag} {prec}: captured update {ms:.3f} ms over "
          f"{len(shapes)} tensors ({sum(t.numel() for t in ws)} values); "
          f"{OPT_STEPS} steps captured vs eager bit-identical {not bad} "
          f"({len(cw + cs)} tensors, {builds} build); card vs cpu worst "
          f"{worst:.3g} of the largest magnitude, {same}/{len(pw + ps)} "
          f"tensors bit-identical [{card}]", flush=True)
    if bad or builds != 1:
        fail(f"optimizer {tag} {prec}: captured vs eager differ in tensors "
             f"{bad[:6]}, builds {builds} (want 1)")
    if worst > OPT_BOUND:
        fail(f"optimizer {tag} {prec}: the card's update is {worst:.3g} of "
             f"the largest magnitude from the cpu's (bound {OPT_BOUND}; inf: "
             f"a bf16 weight more than one ulp off)")
    return dict(name=name, kwargs=kw, dtype=prec, captured_ms=ms,
                identical=not bad, card_vs_cpu=worst,
                bit_identical_tensors=same, tensors=len(pw + ps))


def phase_optimizers(card, train_res, gluon_res):
    """Phase 13 (see the module docstring)."""
    import gc

    from mxnet_tpu_torch import parallel
    from mxnet_tpu_torch.gluon import loss as gloss

    t0 = time.perf_counter()
    res = {"updates": []}
    r50 = KEEP.pop("resnet")
    net, w0, xb, yb = r50["net"], r50["w0"], r50["x"], r50["y"]
    shapes = [tuple(p.shape) for p in net.collect_params().values()
              if p.grad_req != "null"]
    # (a) every optimizer's update on the card
    for name, kw in OPT_CASES:
        for mp in (True, False):
            res["updates"].append(optimizer_case(name, kw, mp, shapes, card))
            gc.collect()
    torch.cuda.empty_cache()
    # (b) BERT-base MLM+NSP with LAMB through the hybridized gluon loop
    bert = KEEP.pop("bert")
    step0 = bert["dropout0"]
    res["bert_lamb"] = bert_gluon_case(
        f"gluon bert-base LAMB dropout 0 bf16 batch "
        f"{bert['batch'][0].shape[0]} x {BERT_SEQ}", step0.bert,
        {k[len("bert."):]: v for k, v in bert["w0"].items()}, bert["batch"],
        card, BERT_LAYERS, False, opt="lamb", opt_params=LAMB_OPT,
        profile=True)
    adam_ms = gluon_res["bert_dropout0"]["captured_ms"]
    print(f"gluon bert-base: LAMB {res['bert_lamb']['captured_ms']:.2f} ms a "
          f"captured step, Adam (phase 12) {adam_ms:.2f} ms [{card}]",
          flush=True)
    drop_cached_op(step0.bert)
    del bert, step0
    gc.collect()
    torch.cuda.empty_cache()
    # (c) ResNet-50 v1 through SPMDTrainer with centred RMSProp
    drop_cached_op(net)
    restore(net, w0)
    set_knobs(True, True)
    tr = parallel.SPMDTrainer(net, gloss.SoftmaxCrossEntropyLoss(),
                              "rmsprop", dict(RMSPROP_OPT),
                              mesh=parallel.make_mesh(dp=1))
    # bf16 weights: three states and an fp32 master; the fp32 BatchNorm
    # parameters: three states
    n_state = {(str(tr.params[n].dtype), len(s))
               for n, s in tr.opt_state.items()}
    if n_state != {("torch.bfloat16", 4), ("torch.float32", 3)}:
        fail(f"rmsprop centered multi_precision: (dtype, state tensors) a "
             f"weight {n_state} (want 4 for bf16, 3 for fp32)")
    res["resnet_rmsprop"] = hold_captured_steps(
        f"compiled: train bf16 batch {TRAIN_BATCH} fused, centred RMSProp "
        "multi_precision", tr, (xb, yb), card,
        {"k1": FWD_PER_STEP, "k2": BWD_PER_STEP})
    sgd_ms = train_res["compiled"]["fused"]["captured_ms"]
    print(f"train bf16 batch {TRAIN_BATCH} fused: centred RMSProp "
          f"{res['resnet_rmsprop']['captured_ms']:.2f} ms a captured step, "
          f"SGD momentum (phase 5) {sgd_ms:.2f} ms [{card}]", flush=True)
    del tr, net, r50
    gc.collect()
    torch.cuda.empty_cache()
    res["seconds"] = time.perf_counter() - t0
    print(f"optimizers (phase 13): {res['seconds']:.1f} s; "
          + json.dumps(res), flush=True)
    return res


# ---------------------------------------------------------------------------
# phase 14: MXNet's imperative op surface on the card
# ---------------------------------------------------------------------------

def ops_sweep(dev):
    """(a) every registered op name on the card against the CPU
    (op_sweep.CASES's seeded inputs): forward and gradient, held by
    class; one line of counts per class and the worst error of each."""
    from mxnet_tpu_torch.ops.registry import list_ops
    from mxnet_tpu_torch.tools import op_sweep

    t0 = time.perf_counter()
    results = op_sweep.sweep(dev)
    counts, worst = op_sweep.summary(results)
    for name, r in sorted(results.items()):
        if not r["ok"]:
            fail(f"ops sweep: {name} ({r['kind']}) does not hold on the "
                 f"card: {r}")
    where = {}
    for name, check in op_sweep.ELSEWHERE.items():
        where.setdefault(check, []).append(name)
    print(f"ops sweep: {len(results)} op names of {len(list_ops())} "
          f"registered: held {counts['held']}, failed {counts['failed']}; "
          f"exact {counts['exact']}, bounded "
          f"{counts['ulp'] + counts['sum']} (elementwise {counts['ulp']}, "
          f"sums and products {counts['sum']}), named as held elsewhere "
          f"{counts['elsewhere']}, random draws held by (c) "
          f"{counts['random']} ({time.perf_counter() - t0:.1f} s)",
          flush=True)
    print(f"ops sweep: worst elementwise {worst['ulp'][0]:.1f} ulps "
          f"({worst['ulp'][1]}; bound {op_sweep.ULP_BOUND}); worst sum "
          f"{worst['sum'][0]:.3f} of its bound 2^-24*n*S ({worst['sum'][1]})",
          flush=True)
    for check, names in where.items():
        print(f"ops sweep: held by {check}: {len(names)} names "
              f"({', '.join(sorted(names)[:6])}"
              f"{', ...' if len(names) > 6 else ''})", flush=True)
    return {"counts": counts, "worst": worst}


def _model_shape(tag, fn, cpu_fn, nbytes, flops, card, hold, iters=20):
    """One op at a model's shape: CUDA-event time over `iters` calls,
    beside the larger of bytes / 3.35 TB/s and flops / the fp32 peak,
    held against the same op on the CPU by `hold(card_out, cpu_out)`."""
    ms = time_ms(fn, iters=iters, warmup=3)
    out = fn()
    torch.cuda.synchronize()
    ok, what = hold(out, cpu_fn())
    if not ok:
        fail(f"ops shape: {tag}: {what}")
    b_ms, f_ms = nbytes / PEAK_BYTES * 1e3, flops / PEAK_FP32 * 1e3
    bound = max(b_ms, f_ms)
    by = "bytes" if b_ms >= f_ms else "operations"
    print(f"ops shape: {tag}: {ms:.4f} ms, bound {bound:.4f} ms by {by} "
          f"({nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP); {what} "
          f"[{card}]", flush=True)
    return dict(ms=ms, bound_ms=bound, bound_by=by, ok=ok)


def _same_bits(a, b):
    ok = torch.equal(a.cpu(), b)
    return ok, "same bits as the cpu" if ok else "differs from the cpu"


def ops_model_shapes(dev, card):
    """(b) the ops at BERT-base's and ResNet-50's shapes."""
    from mxnet_tpu_torch import nd
    from mxnet_tpu_torch.ops import tensor

    gen = torch.Generator().manual_seed(1401)
    res = {}
    table = torch.randn(BERT_VOCAB, BERT_UNITS, generator=gen)
    ids = torch.randint(0, BERT_VOCAB, (BATCH, BERT_SEQ),
                        generator=gen).float()
    t_d, i_d = table.to(dev), ids.to(dev)
    rows = BATCH * BERT_SEQ
    res["take"] = _model_shape(
        f"take {BERT_VOCAB}x{BERT_UNITS} by {BATCH}x{BERT_SEQ}",
        lambda: tensor.take(t_d, i_d), lambda: tensor.take(table, ids),
        4 * (rows + 2 * rows * BERT_UNITS), 0, card, _same_bits)
    res["one_hot"] = _model_shape(
        f"one_hot {BATCH}x{BERT_SEQ} at depth {BERT_VOCAB}",
        lambda: tensor.one_hot(i_d, depth=BERT_VOCAB),
        lambda: tensor.one_hot(ids, depth=BERT_VOCAB),
        4 * (rows + rows * BERT_VOCAB), 0, card, _same_bits, iters=5)
    bh, s, d = BATCH * BERT_HEADS, BERT_SEQ, BERT_UNITS // BERT_HEADS
    a = torch.randn(bh, s, d, generator=gen)
    b = torch.randn(bh, d, s, generator=gen)
    a_d, b_d = a.to(dev), b.to(dev)

    def held_sum(fn_abs, n):
        def hold(out, want):
            s_terms = fn_abs().double()
            err = (out.double() - want.double().to(dev)).abs()
            bound = 2.0 ** -24 * (n * s_terms + want.double().to(dev).abs())
            r = float((err / bound).max())
            return r <= 1.0, f"{r:.3f} of the bound 2^-24*{n}*S vs the cpu"
        return hold

    res["batch_dot"] = _model_shape(
        f"batch_dot {bh}x{s}x{d} by {bh}x{d}x{s} fp32",
        lambda: tensor.batch_dot(a_d, b_d), lambda: tensor.batch_dot(a, b),
        4 * (2 * bh * s * d + bh * s * s), 2 * bh * s * s * d, card,
        held_sum(lambda: tensor.batch_dot(a_d.abs().double(),
                                          b_d.abs().double()), d))
    m, k, n = BATCH * BERT_SEQ, BERT_UNITS, 4 * BERT_UNITS
    x = torch.randn(m, k, generator=gen)
    w = torch.randn(k, n, generator=gen)
    x_d, w_d = x.to(dev), w.to(dev)
    res["dot"] = _model_shape(
        f"dot {m}x{k} by {k}x{n} fp32",
        lambda: tensor.dot(x_d, w_d), lambda: tensor.dot(x, w),
        4 * (m * k + k * n + m * n), 2 * m * k * n, card,
        held_sum(lambda: tensor.dot(x_d.abs().double(), w_d.abs().double()),
                 k), iters=10)
    seq = torch.randn(BERT_SEQ, BATCH, BERT_UNITS, generator=gen)
    lens = torch.randint(1, BERT_SEQ + 1, (BATCH,), generator=gen).float()
    seq_d, lens_d = seq.to(dev), lens.to(dev)
    res["SequenceMask"] = _model_shape(
        f"SequenceMask over {BERT_SEQ}x{BATCH}x{BERT_UNITS}",
        lambda: tensor.sequence_mask(seq_d, lens_d, use_sequence_length=True),
        lambda: tensor.sequence_mask(seq, lens, use_sequence_length=True),
        4 * (2 * seq.numel() + BATCH), 0, card, _same_bits)
    gates = torch.randn(4096, 4096, generator=gen)
    g_d = gates.to(dev)

    def hold_split(out, want):
        ok = all(torch.equal(p.cpu(), q) for p, q in zip(out, want))
        views = all(p.data_ptr() - g_d.data_ptr() == i * 1024 * 4
                    for i, p in enumerate(out))
        return ok and views, (f"same bits as the cpu {ok}; four views of "
                              f"the block, no copy {views}")

    res["split"] = _model_shape(
        "split of a 4096x4096 gate block into 4 along axis 1",
        lambda: tensor.split(g_d, num_outputs=4, axis=1),
        lambda: tensor.split(gates, num_outputs=4, axis=1), 0, 0, card,
        hold_split)
    count = RESNET50_V1_PARAMS

    def hold_normal(out, _):
        v = out._data.double()
        mean, var = float(v.mean()), float(v.var())
        se_m, se_v = math.sqrt(1 / count), math.sqrt(2 / count)
        ok = abs(mean) <= 6 * se_m and abs(var - 1) <= 6 * se_v \
            and out.data.device == dev and out.shape == (count,)
        return ok, (f"on {out.ctx}, mean {mean:.2e} var {var:.6f} within "
                    f"6 standard errors of N(0, 1) {ok}")

    res["random.normal"] = _model_shape(
        f"nd.random.normal of {count} values (ResNet-50 v1's parameters)",
        lambda: nd.random.normal(shape=(count,), ctx=dev), lambda: None,
        4 * count, 0, card, hold_normal)
    return res


def _moments(x):
    v = x.double().reshape(-1)
    m = v.mean()
    c = v - m
    var = (c * c).mean()
    m4 = (c ** 4).mean()
    return float(m), float(var), float(m4), v.numel()


def ops_random(dev, card):
    """(c) every _random_* and _sample_* distribution on the card: 2^22
    draws, mean and variance within 6 standard errors of the analytic
    values; one seed, the same bits twice; _shuffle a permutation;
    _sample_multinomial's get_prob the log of the chosen probability; a
    CUDA graph around nd.random.normal replayed K times against K eager
    draws from the same generator state."""
    from mxnet_tpu_torch import nd
    from mxnet_tpu_torch import random as mrandom
    from mxnet_tpu_torch.ops.registry import invoke

    g = mrandom.generator(dev)
    n = RANDOM_DRAWS
    worst, checked = 0.0, 0
    for name, (attrs, rows) in RANDOM_DISTRIBUTIONS.items():
        params = [nd.array(p, ctx=dev) for p in attrs.get("params", [])]
        kw = {k: v for k, v in attrs.items() if k != "params"}
        shape = (n // len(rows),) if params else (n,)
        g.manual_seed(1402)
        out = invoke(name, g, *params, shape=shape, **kw)._data
        g.manual_seed(1402)
        again = invoke(name, g, *params, shape=shape, **kw)._data
        if not torch.equal(out, again):
            fail(f"ops random: {name}: one seed gave two draws")
        if out.device != dev:
            fail(f"ops random: {name} drew on {out.device}")
        for r, (mean, var) in enumerate(rows):
            m, v, m4, cnt = _moments(out[r] if params else out)
            zm = abs(m - mean) / math.sqrt(var / cnt)
            zv = abs(v - var) / math.sqrt(max(m4 - v * v, 1e-300) / cnt)
            worst = max(worst, zm, zv)
            checked += 1
            if zm > 6 or zv > 6:
                fail(f"ops random: {name} row {r}: mean {m} var {v} against "
                     f"{mean} {var} ({zm:.1f}, {zv:.1f} standard errors)")
    perm = invoke("_shuffle", g, nd.arange(1 << 20, ctx=dev))._data
    is_perm = torch.equal(perm.sort().values,
                          torch.arange(1 << 20, device=dev,
                                       dtype=perm.dtype))
    if not is_perm:
        fail("ops random: _shuffle is not a permutation")
    probs = torch.rand(8, 50, device=dev, generator=g) + 0.01
    draw, logp = invoke("_sample_multinomial", g, nd.NDArray(probs),
                        shape=(4096,), get_prob=True)
    want = (probs / probs.sum(-1, keepdim=True)).log().gather(
        -1, draw._data.long())
    lp_err = float((logp._data - want).abs().max())
    if lp_err > 1e-5:
        fail(f"ops random: get_prob differs from the log probability by "
             f"{lp_err}")
    replay = ops_random_graph(dev)
    print(f"ops random: {len(RANDOM_DISTRIBUTIONS)} distributions, "
          f"{checked} rows of {n} draws on the card, worst {worst:.2f} "
          f"standard errors (bound 6); each seed's draws bit-identical twice; "
          f"_shuffle of 2^20 a permutation {is_perm}; multinomial get_prob "
          f"within {lp_err:.1e} of log p; graph replay {replay} [{card}]",
          flush=True)
    return dict(worst_se=worst, rows=checked, permutation=is_perm,
                get_prob_err=lp_err, graph=replay)


def ops_random_graph(dev, k=CAPTURE_K, count=1 << 20):
    """nd.random.normal captured in a CUDA graph with the port's
    generator registered: K replays from one generator state give the
    bits of K eager draws from it, and no two replays repeat."""
    from mxnet_tpu_torch import nd
    from mxnet_tpu_torch import random as mrandom

    g = mrandom.generator(dev)
    g.manual_seed(1403)
    graph = torch.cuda.CUDAGraph()
    mrandom.register_graph(graph, g)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        nd.random.normal(shape=(count,), ctx=dev)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    with torch.cuda.graph(graph):
        static = nd.random.normal(shape=(count,), ctx=dev)._data
    s0 = g.get_state()
    replays = []
    for _ in range(k):
        graph.replay()
        replays.append(static.clone())
    g.set_state(s0)
    eager = [nd.random.normal(shape=(count,), ctx=dev)._data
             for _ in range(k)]
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(replays, eager))
    differ = not any(torch.equal(replays[i], replays[i + 1])
                     for i in range(k - 1))
    if not (same and differ):
        fail(f"ops random: {k} graph replays of nd.random.normal: the eager "
             f"draws' bits {same}, each replay new {differ}")
    del graph
    return f"{k} replays = {k} eager draws {same}, each new {differ}"


def ops_function(dev, card):
    """(d) a custom sigmoid written with autograd.Function, recorded on
    the card: its gradient against the built-in sigmoid's on the card (1
    ulp) and against the CPU's, within 2^-22·|dy| + 4 ulps: the card's
    and the CPU's sigmoid are each within an ulp of the truth, so their
    y may lie two ulps (2^-23 near 1) apart, which moves dy·(1 - y)·y by
    up to dy·2^-23; the bound is twice that."""
    import numpy as np

    from mxnet_tpu_torch import autograd, nd
    from mxnet_tpu_torch.tools import op_sweep

    class Sigmoid(autograd.Function):
        def forward(self, x):
            y = x.sigmoid()
            self.save_for_backward(y)
            return y

        def backward(self, dy):
            (y,) = self.saved_tensors
            return dy * (1 - y) * y

    gen = torch.Generator().manual_seed(1404)
    x0 = torch.randn(1 << 16, generator=gen) * 4
    ct = torch.randn(1 << 16, generator=gen)

    def grad(device, custom):
        x = nd.NDArray(x0.to(device))
        x.attach_grad()
        with autograd.record():
            y = Sigmoid()(x) if custom else x.sigmoid()
        y.backward(nd.NDArray(ct.to(device)))
        return x.grad._data.cpu().numpy()

    card_g, cpu_g, builtin_g = grad(dev, True), grad("cpu", True), \
        grad(dev, False)
    bound = 2.0 ** -22 * ct.abs().numpy() + 4 * np.spacing(np.abs(cpu_g))
    r_cpu = float((np.abs(card_g - cpu_g) / bound).max())
    u_builtin = op_sweep.ulps(card_g, builtin_g)
    if r_cpu > 1 or u_builtin > 1:
        fail(f"ops function: the custom sigmoid's gradient is {r_cpu:.3f} "
             f"of its bound from the cpu's and {u_builtin} ulps from the "
             f"built-in's")
    print(f"ops function: custom sigmoid (autograd.Function) recorded on "
          f"the card, gradient {r_cpu:.3f} of 2^-22*|dy| + 4 ulps from the "
          f"cpu's, {u_builtin:.1f} ulps from the built-in sigmoid's (bound "
          f"1) [{card}]", flush=True)
    return dict(bound_share_cpu=r_cpu, ulps_builtin=u_builtin)


def phase_ops(card):
    """Phase 14: the op surface on the card ((a) to (d))."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    res = dict(sweep=ops_sweep(dev), shapes=ops_model_shapes(dev, card),
               random=ops_random(dev, card), function=ops_function(dev, card))
    print(f"ops: phase 14 took {time.perf_counter() - t0:.1f} s", flush=True)
    return res


# ---------------------------------------------------------------------------
# phase 15: the recurrent path
# ---------------------------------------------------------------------------

RNN_MODES = ("lstm", "gru", "rnn_tanh", "rnn_relu")
LM_WIDTH, LM_LAYERS, LM_SEQ = 200, 2, 30   # the example's widths, one bucket
LM_VOCAB = 11                              # the example's synthetic corpus
ZAREMBA = (35, 650)                        # medium PTB LSTM: steps, width
CTC_SHAPE = (100, 32, 30, 20)              # T, batch, alphabet, longest label


def witness_share(got, cpu, ref, slack):
    """The card's largest distance to a float64 reference over twice the
    CPU run's in the same dtype plus `slack` * (1 + max|ref|): at most 1
    when the card is no further from the truth than twice the CPU."""
    ref = ref.double()
    e_card = float((got.double().cpu() - ref).abs().max())
    e_cpu = float((cpu.double() - ref).abs().max())
    return e_card / (2 * e_cpu + slack * (1 + float(ref.abs().max())))


def rnn_inputs(mode, gen, t, n, width, layers, bi):
    from mxnet_tpu_torch.ops.rnn import rnn_param_size

    d = 2 if bi else 1
    size = rnn_param_size(mode, width, width, layers, bi)
    x = torch.randn(t, n, width, generator=gen)
    w = (torch.rand(size, generator=gen) * 2 - 1) / math.sqrt(width)
    h0 = torch.randn(layers * d, n, width, generator=gen) * 0.5
    c0 = torch.randn(layers * d, n, width, generator=gen) * 0.5 \
        if mode == "lstm" else None
    return [x, w, h0, c0]


def rnn_run(inputs, cts, dev, dtype, kw):
    """The RNN op's outputs and the gradients of its data, parameters and
    states on `dev` in `dtype`, under the cotangents `cts`."""
    from mxnet_tpu_torch.ops.rnn import rnn

    leaves = [None if t is None else t.to(dev, dtype).requires_grad_()
              for t in inputs]
    outs = rnn(*leaves, **kw)
    grads = torch.autograd.grad(outs, [t for t in leaves if t is not None],
                                [c.to(dev, dtype) for c in cts])
    return [o.detach() for o in outs] + [g.detach() for g in grads]


def rnn_dropout_check(dev):
    """Dropout at p = 0.3 between two rnn_relu layers made so that the
    second passes its input through (identity i2h, zero h2h and biases)
    and the first's output is positive: the output is y * mask / 0.7,
    so its zeros are the dropped share.  One generator state gives the
    same bits twice; the next state gives other draws."""
    from mxnet_tpu_torch import random as mrandom
    from mxnet_tpu_torch.ops.rnn import rnn

    h, t, n, keep = LM_WIDTH, LM_SEQ, BATCH, 0.7
    gen = torch.Generator().manual_seed(1502)
    x = torch.rand(t, n, h, generator=gen).to(dev)
    w = torch.cat([torch.rand(h * h, generator=gen) * 0.01,
                   torch.zeros(h * h), torch.eye(h).reshape(-1),
                   torch.zeros(h * h), torch.full((h,), 0.1),
                   torch.zeros(3 * h)]).to(dev)
    kw = dict(state_size=h, num_layers=2, mode="rnn_relu",
              state_outputs=False)
    y = rnn(x, w, **kw)
    g = mrandom.generator(dev)
    g.manual_seed(1503)
    s0 = g.get_state()
    a = rnn(x, w, None, None, g, p=1 - keep, train=True, **kw)
    g.set_state(s0)
    b = rnn(x, w, None, None, g, p=1 - keep, train=True, **kw)
    c = rnn(x, w, None, None, g, p=1 - keep, train=True, **kw)
    kept = a != 0
    share = float(kept.double().mean())
    se = abs(share - keep) / math.sqrt(keep * (1 - keep) / a.numel())
    scale_err = float(((a - y / keep).abs() / (y / keep)).where(
        kept, torch.zeros_like(a)).max())
    same, new = torch.equal(a, b), not torch.equal(a, c)
    if se > 6 or scale_err > 1e-6 or not same or not new \
            or not bool((y > 0).all()):
        fail(f"rnn op dropout: kept share {share} ({se:.1f} standard "
             f"errors), kept values {scale_err} from y/0.7, same state "
             f"same bits {same}, next state new draws {new}")
    return dict(kept=share, se=se, scale_err=scale_err, same=same, new=new)


def rnn_op_checks(dev, card):
    """(a) every mode, bidirectional and 2 layers, at the example's width
    (T = 30, batch 32, width 200): outputs and gradients on the card
    against the CPU in fp32 and bf16, each held by witness_share against
    the float64 CPU run (slack 2^-20 in fp32, 2^-8 in bf16); then
    dropout at p = 0.3."""
    from mxnet_tpu_torch.ops.rnn import rnn

    gen = torch.Generator().manual_seed(1501)
    worst = {"float32": 0.0, "bfloat16": 0.0}
    for mode in RNN_MODES:
        kw = dict(state_size=LM_WIDTH, num_layers=2, mode=mode,
                  bidirectional=True)
        inputs = rnn_inputs(mode, gen, LM_SEQ, BATCH, LM_WIDTH, 2, True)
        with torch.no_grad():
            outs = rnn(*[None if t is None else t.double()
                         for t in inputs], **kw)
        cts = [torch.randn(o.shape, generator=gen) for o in outs]
        ref = rnn_run(inputs, cts, "cpu", torch.float64, kw)
        for dt, slack in ((torch.float32, 2.0 ** -20),
                          (torch.bfloat16, 2.0 ** -8)):
            name = str(dt).replace("torch.", "")
            got = rnn_run(inputs, cts, dev, dt, kw)
            cpu = rnn_run(inputs, cts, "cpu", dt, kw)
            for i, (g, c, r) in enumerate(zip(got, cpu, ref)):
                share = witness_share(g, c, r, slack)
                worst[name] = max(worst[name], share)
                if not share <= 1.0:
                    fail(f"rnn op: {mode} {name} tensor {i} is "
                         f"{share:.3f} of its bound")
    drop = rnn_dropout_check(dev)
    print(f"rnn op: 4 modes x bidirectional x 2 layers at T={LM_SEQ} "
          f"batch {BATCH} width {LM_WIDTH}, outputs and the gradients of "
          f"data, parameters and states: worst fp32 {worst['float32']:.3f}, "
          f"bf16 {worst['bfloat16']:.3f} of the bound (the card's distance "
          f"to the float64 cpu run <= 2x the cpu's in the same dtype + "
          f"2^-20 / 2^-8 (1 + max|ref|)); dropout p=0.3: kept "
          f"{drop['kept']:.5f} ({drop['se']:.2f} standard errors from 0.7), "
          f"kept values {drop['scale_err']:.1e} from y/0.7, one generator "
          f"state the same bits {drop['same']}, the next new draws "
          f"{drop['new']} [{card}]", flush=True)
    return dict(worst=worst, dropout=drop)


def bucket_state(model):
    """Copies of what a BucketingModule step writes: the shared
    parameters, the optimizer's states and its update counts."""
    default = model._buckets[model._default_bucket_key]
    ex = default._exec_group.execs[0]
    upd = default._updater
    opt = default._optimizer
    return ([ex.arg_dict[n]._data.clone() for n in default._param_names],
            [t.clone() for t in flat_states(upd.states)],
            dict(opt._index_update_count), opt.num_update)


def set_bucket_state(model, st):
    default = model._buckets[model._default_bucket_key]
    ex = default._exec_group.execs[0]
    with torch.no_grad():
        for n, v in zip(default._param_names, st[0]):
            ex.arg_dict[n]._data.copy_(v)
        for t, v in zip(flat_states(default._updater.states), st[1]):
            t.copy_(v)
    default._optimizer._index_update_count = dict(st[2])
    default._optimizer.num_update = st[3]


def bucket_batches(it):
    """The first batch of each bucket."""
    it.reset()
    out = {}
    for b in it:
        out.setdefault(b.bucket_key, b)
    return out


def bucket_step(model, batch):
    model.forward_backward(batch)
    model.update()


def bucket_bits(model, batches):
    """Each bucket's captured step against its step under no_capture
    from the same weights and optimizer state: outputs, gradients,
    weights and optimizer states bit for bit.  The state is put back
    after each."""
    from mxnet_tpu_torch import _graphs as graphs

    bad = []
    for key, batch in sorted(batches.items()):
        s0 = bucket_state(model)
        runs = []
        for eager in (False, True):
            set_bucket_state(model, s0)
            with contextlib.ExitStack() as stack:
                if eager:
                    stack.enter_context(graphs.no_capture())
                bucket_step(model, batch)
            ex = model._buckets[key]._exec_group.execs[0]
            st = bucket_state(model)
            runs.append([o._data.clone() for o in ex.outputs]
                        + [g._data.clone() for g in ex.grad_arrays
                           if g is not None] + st[0] + st[1])
        set_bucket_state(model, s0)
        if not all(torch.equal(a, b) for a, b in zip(*runs)):
            bad.append(key)
    return bad


def bucket_times(model, batches, calls=5):
    """ms of one step (forward_backward + update, host clock around a
    synchronised call) per bucket, captured and under no_capture in
    turns (captured, eager, eager, captured): median, min and max."""
    from mxnet_tpu_torch import _graphs as graphs

    s0 = bucket_state(model)
    out = {}
    for key, batch in sorted(batches.items()):
        ms = {False: [], True: []}
        for eager in (False, True, True, False):
            with contextlib.ExitStack() as stack:
                if eager:
                    stack.enter_context(graphs.no_capture())
                for _ in range(calls):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    bucket_step(model, batch)
                    torch.cuda.synchronize()
                    ms[eager].append((time.perf_counter() - t0) * 1e3)
        out[key] = {("eager" if e else "captured"): dict(
            median=sorted(v)[len(v) // 2], min=min(v), max=max(v))
            for e, v in ms.items()}
    set_bucket_state(model, s0)
    return out


def lm_example(card):
    """(b) examples/rnn_bucketing.py at its default widths (batch 32,
    width 200, 2 layers, buckets 10-60, 2000 synthetic lines, Adam lr
    0.01): 2 epochs over the fused RNN op, 1 over the legacy cells.
    final perplexity < 3.0 (the JAX example's bar), one training capture
    and one scoring capture per bucket and no eviction, one updater and
    one captured update for every bucket, each bucket's captured step
    bit for bit its eager step; ms a step per bucket."""
    from mxnet_tpu_torch import _graphs as graphs
    from mxnet_tpu_torch.examples import rnn_bucketing
    from mxnet_tpu_torch.optimizer import fused
    from mxnet_tpu_torch.symbol import executor as sx

    res = {}
    for tag, argv in (("fused", ["--epochs", "2"]),
                      ("cells", ["--epochs", "1", "--cells"])):
        x0, u0 = sx.executor_stats(), fused.compile_stats()["count"]
        t0 = time.perf_counter()
        run = rnn_bucketing.main(argv)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        model = run["model"]
        x1 = sx.executor_stats()
        slots = {}
        for key, mod in model._buckets.items():
            tok = graphs.owner_token(mod._exec_group.execs[0])
            with sx._EXEC_CACHE.lock:
                mine = [k[1] for k in sx._EXEC_CACHE.data if k[0] == tok]
            slots[key] = (sum(1 for s in mine if s[0] and s[1]),
                          sum(1 for s in mine if not s[0]))
        updaters = {id(m._updater) for m in model._buckets.values()}
        updates = fused.compile_stats()["count"] - u0
        batches = bucket_batches(run["iter"])
        bad = bucket_bits(model, batches)
        times = bucket_times(model, batches)
        ok = (run["perplexity"] < 3.0 and len(slots) == 5
              and all(v == (1, 1) for v in slots.values())
              and x1["evictions"] == x0["evictions"] and len(updaters) == 1
              and updates == 1 and not bad)
        if not ok:
            fail(f"lm example ({tag}): final perplexity "
                 f"{run['perplexity']:.3f} (bar 3.0), (train, score) "
                 f"captures per bucket {slots}, evictions "
                 f"{x1['evictions'] - x0['evictions']}, updaters "
                 f"{len(updaters)}, captured updates {updates}, buckets "
                 f"whose captured step differs from eager {bad}")
        per = "; ".join(
            f"{k}: captured {v['captured']['median']:.2f} "
            f"[{v['captured']['min']:.2f}, {v['captured']['max']:.2f}] "
            f"eager {v['eager']['median']:.2f} [{v['eager']['min']:.2f}, "
            f"{v['eager']['max']:.2f}]" for k, v in sorted(times.items()))
        print(f"lm example ({tag}): {argv}: final perplexity "
              f"{run['perplexity']:.3f} (bar 3.0) in {secs:.1f} s; "
              f"(train, score) captures per bucket {slots}, "
              f"{x1['count'] - x0['count']} executor captures "
              f"({x1['seconds_total'] - x0['seconds_total']:.2f} s), "
              f"{len(updaters)} updater, {updates} captured update; "
              f"captured step bit for bit its eager step in "
              f"{len(batches) - len(bad)}/{len(batches)} buckets", flush=True)
        print(f"lm example ({tag}): ms a step by bucket length, median "
              f"[min, max] of 10 calls: {per} [{card}]", flush=True)
        res[tag] = dict(perplexity=run["perplexity"], seconds=secs,
                        captures=slots, updates=updates, bits_bad=bad,
                        ms=times)
        del run, model
    return res


def lm_net(vocab, dev):
    from mxnet_tpu_torch import gluon, init
    from mxnet_tpu_torch.gluon import nn, rnn

    net = nn.HybridSequential()
    net.add(nn.Embedding(vocab, LM_WIDTH),
            rnn.LSTM(LM_WIDTH, num_layers=LM_LAYERS, layout="NTC"),
            nn.Dense(vocab, flatten=False))
    net.initialize(init.Xavier(), ctx=dev)
    net.hybridize()
    return net


def lm_gluon(card, dev):
    """(c) gluon.rnn.LSTM(200, num_layers=2) as the same LM (Embedding,
    LSTM over NTC, Dense) through the hybridized gluon.Trainer loop,
    batch 32 x 30 tokens: 1 + CAPTURE_K steps with the CachedOp captured
    against as many under no_capture from one state, every parameter,
    optimizer state and loss bit for bit, one training build."""
    from mxnet_tpu_torch import nd

    gen = torch.Generator().manual_seed(1504)
    xb = torch.randint(1, LM_VOCAB, (BATCH, LM_SEQ), generator=gen)
    yb = torch.roll(xb, -1, 1)
    xb, yb = xb.float().to(dev), yb.float().to(dev)
    net = lm_net(LM_VOCAB, dev)
    net(nd.NDArray(xb))  # resolves the LSTM's input width
    w0 = snapshot(net)
    runs, _, bad = captured_loop("lm gluon", net, w0, xb, yb,
                                 1 + CAPTURE_K, card)
    c = runs["captured"]
    if c[2] != 1:
        fail(f"lm gluon: {c[2]} training builds, want 1")
    print(f"lm gluon: LSTM({LM_WIDTH}, num_layers={LM_LAYERS}) LM through "
          f"the hybridized gluon.Trainer loop, {1 + CAPTURE_K} steps "
          f"captured (builds {c[2]}) bit for bit the eager ones {not bad}; "
          f"losses {[round(v, 4) for v in c[0]]} [{card}]", flush=True)
    return net, xb, yb, dict(builds=c[2], identical=not bad,
                             losses=c[0])


def ctc_inputs(gen, dev=None):
    t, n, alphabet, longest = CTC_SHAPE
    x = torch.randn(t, n, alphabet, generator=gen)
    lens = torch.randint(1, longest + 1, (n,), generator=gen)
    lab = torch.randint(1, alphabet, (n, longest), generator=gen)
    lab = torch.where(torch.arange(longest) < lens[:, None], lab, 0)
    return x, lab.float(), lens


def ctc_checks(card, dev):
    """(d) CTCLoss (blank first, 0 padding) at T = 100, batch 32,
    alphabet 30, labels of 1 to 20: the loss and its gradient on the card
    against the CPU, held by witness_share against float64 (slack
    2^-20); ms of the op's forward and backward beside F.ctc_loss on the
    same log-probabilities (the record only: it is not the op)."""
    from mxnet_tpu_torch.ops.nn import ctc_loss, log_softmax

    gen = torch.Generator().manual_seed(1505)
    x, lab, lens = ctc_inputs(gen)
    ct = torch.rand(x.shape[1], generator=gen)

    def run(d, dt):
        xd = x.to(d, dt).requires_grad_()
        loss = ctc_loss(xd, lab.to(d))
        (g,) = torch.autograd.grad(loss, [xd], [ct.to(d, loss.dtype)])
        return loss.detach(), g
    ref = run("cpu", torch.float64)
    got = run(dev, torch.float32)
    cpu = run("cpu", torch.float32)
    shares = [witness_share(g, c, r, 2.0 ** -20)
              for g, c, r in zip(got, cpu, ref)]
    if not max(shares) <= 1.0 or not bool(torch.isfinite(got[0]).all()):
        fail(f"ctc: loss/gradient {shares} of the bound")
    xd = x.to(dev).requires_grad_()
    lab_d, ct_d = lab.to(dev), ct.to(dev)

    def port():
        loss = ctc_loss(xd, lab_d)
        torch.autograd.grad(loss, [xd], [ct_d])

    logp = log_softmax(xd.detach(), axis=-1).requires_grad_()
    il = torch.full((x.shape[1],), x.shape[0], dtype=torch.long,
                    device=dev)
    tl = lens.to(dev)
    tgt = lab.long().to(dev)

    def library():
        loss = F.ctc_loss(logp, tgt, il, tl, blank=0, reduction="none")
        torch.autograd.grad(loss, [logp], [ct_d])
    port_ms, lib_ms = time_ms(port, iters=5), time_ms(library, iters=5)
    print(f"ctc: T={CTC_SHAPE[0]} batch {CTC_SHAPE[1]} alphabet "
          f"{CTC_SHAPE[2]} labels 1-{CTC_SHAPE[3]}: loss "
          f"{shares[0]:.3f}, gradient {shares[1]:.3f} of the bound; "
          f"forward + backward {port_ms:.3f} ms, F.ctc_loss "
          f"{lib_ms:.3f} ms (the record only) [{card}]", flush=True)
    return dict(shares=shares, ms=port_ms, library_ms=lib_ms)


def lm_amp(card, net, xb, yb):
    """(e) contrib.amp on (c)'s net: init("float16") selects bfloat16,
    convert_hybrid_block casts every parameter (none is a normalisation
    one), then one gluon.Trainer step (sgd) through scale_loss/unscale
    at scale 1: every parameter bf16 and changed, the loss finite."""
    from mxnet_tpu_torch import autograd, gluon, nd
    from mxnet_tpu_torch.contrib import amp

    amp.init("float16")
    amp.convert_hybrid_block(net)
    dtypes = {str(v.dtype) for v in net.state_dict().values()}
    w0 = snapshot(net)
    trainer = gluon.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": 0.1})
    amp.init_trainer(trainer)
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    x, y = nd.NDArray(xb), nd.NDArray(yb)
    with autograd.record():
        loss = loss_fn(net(x), y)
        with amp.scale_loss(loss, trainer) as scaled:
            scaled.backward()
    amp.unscale(trainer)
    trainer.step(xb.shape[0])
    value = float(loss.mean().asscalar())
    changed = all(not torch.equal(w0[k], v)
                  for k, v in net.state_dict().items())
    after = {str(v.dtype) for v in net.state_dict().values()}
    ok = dtypes == after == {"torch.bfloat16"} and changed \
        and math.isfinite(value)
    if not ok:
        fail(f"lm amp: dtypes {dtypes} -> {after}, every parameter "
             f"changed {changed}, loss {value}")
    print(f"lm amp: convert_hybrid_block -> {sorted(after)}, one bf16 step "
          f"through scale_loss/unscale: loss {value:.4f}, every parameter "
          f"changed {changed} [{card}]", flush=True)
    return dict(loss=value, dtypes=sorted(after), changed=changed)


def rnn_timings(card, dev):
    """(f) the port's RNN op (LSTM, 2 layers) against torch.nn.LSTM
    (cuDNN) at the example's largest bucket (T = 60, batch 32, width
    200) and Zaremba et al. (2014)'s medium PTB LSTM (T = 35, batch 32,
    width 650), fp32 and bf16, forward and forward + backward: ms a call
    by replays of a CUDA graph of 3 calls (graph_ms).  For PERF.md only:
    a yardstick, no claim."""
    from mxnet_tpu_torch.ops.rnn import rnn, rnn_param_size

    gen = torch.Generator().manual_seed(1506)
    rows = []
    for tag, (t, h) in (("example", (60, LM_WIDTH)),
                        ("zaremba_medium", ZAREMBA)):
        for dt in (torch.float32, torch.bfloat16):
            x = torch.randn(t, BATCH, h, generator=gen).to(dev, dt)
            w = ((torch.rand(rnn_param_size("lstm", h, h, 2, False),
                             generator=gen) * 2 - 1) / math.sqrt(h)).to(
                                 dev, dt)
            lstm = torch.nn.LSTM(h, h, num_layers=2).to(dev, dt)
            lstm.flatten_parameters()
            ct = torch.randn(t, BATCH, h, generator=gen).to(dev, dt)
            xg, wg = x.clone().requires_grad_(), w.clone().requires_grad_()
            xc = x.clone().requires_grad_()
            kw = dict(state_size=h, num_layers=2, mode="lstm",
                      state_outputs=False)
            cudnn_params = list(lstm.parameters())
            rec = dict(shape=tag, T=t, batch=BATCH, width=h,
                       dtype=str(dt).replace("torch.", ""))
            rec["port_fwd_ms"] = graph_ms(lambda: rnn(x, w, **kw), 3)
            rec["port_fwd_bwd_ms"] = graph_ms(lambda: torch.autograd.grad(
                rnn(xg, wg, **kw), [xg, wg], [ct]), 3)
            with torch.no_grad():
                rec["cudnn_fwd_ms"] = graph_ms(lambda: lstm(x), 3)
            rec["cudnn_fwd_bwd_ms"] = graph_ms(
                lambda: torch.autograd.grad(lstm(xc)[0],
                                            [xc] + cudnn_params, [ct]), 3)
            rows.append(rec)
            print(f"rnn timing: {tag} T={t} batch {BATCH} width {h} "
                  f"{rec['dtype']}: port forward {rec['port_fwd_ms']:.3f} "
                  f"ms, forward+backward {rec['port_fwd_bwd_ms']:.3f} ms; "
                  f"torch.nn.LSTM (cuDNN) {rec['cudnn_fwd_ms']:.3f} / "
                  f"{rec['cudnn_fwd_bwd_ms']:.3f} ms [{card}]", flush=True)
    return rows


def phase_rnn(card):
    """Phase 15: the recurrent path on the card ((a) to (f))."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    res = dict(op=rnn_op_checks(dev, card), example=lm_example(card))
    net, xb, yb, res["gluon"] = lm_gluon(card, dev)
    res["ctc"] = ctc_checks(card, dev)
    res["amp"] = lm_amp(card, net, xb, yb)
    res["timings"] = rnn_timings(card, dev)
    res["seconds"] = time.perf_counter() - t0
    print(f"rnn: phase 15 took {res['seconds']:.1f} s", flush=True)
    return res


# ---------------------------------------------------------------------------
# phase 16: the core runtime (Context, sparse arrays, the local kvstore,
# LibSVMIter, lazy updates, linalg, the engine)
# ---------------------------------------------------------------------------

AVAZU_FEATURES = 1_000_000   # LIBSVM avazu-app's width
LINEAR_ROWS, LINEAR_NNZ, LINEAR_BATCH, LINEAR_EPOCHS = 32768, 20, 8192, 5
LINEAR_OPT = {"learning_rate": 1.0, "momentum": 0.9, "wd": 1e-4}
ZIPF_S = 1.1
LAZY_TABLE = (1_000_000, 64)
LINALG_B, LINALG_BIG, LINALG_SMALL = 8, 2048, 512
LINALG_CHECKED = (0, LINALG_B - 1)   # batch entries held against float64
MOMENTS_SHAPE = (256, 56, 56, 256)   # ResNet-50 stage-1 activations, NHWC
PEAK_FP32 = 67e12                    # H100 SXM fp32 outside the tensor cores


def zipf_ids(rng, shape, n, s=ZIPF_S):
    """Ids in [0, n) drawn with P(rank r) proportional to (r + 1)^-s,
    the ranks scattered over the ids by a fixed permutation."""
    import numpy as np

    cdf = np.cumsum(1.0 / np.arange(1, n + 1, dtype=np.float64) ** s)
    cdf /= cdf[-1]
    ranks = np.minimum(np.searchsorted(cdf, rng.random_sample(shape)), n - 1)
    return np.random.RandomState(7).permutation(n)[ranks]


def core_context(dev):
    """(a) Context and its scope on the card."""
    import numpy as np

    import mxnet_tpu_torch as mt

    ok = (mt.gpu(0).device_type == "gpu" and mt.gpu(0).device_id == 0
          and repr(mt.gpu(0)) == "gpu(0)")
    with mt.gpu(0):
        made = [mt.nd.zeros((2,)), mt.nd.array(np.ones(3)),
                mt.nd.sparse.zeros("row_sparse", (4, 2))]
        on_card = all(a._data.device == dev and a.ctx == mt.gpu(0)
                      for a in made)
        with mt.cpu():
            made = [mt.nd.zeros((2,)), mt.nd.array(np.ones(3)),
                    mt.nd.sparse.zeros("csr", (4, 2))]
            on_cpu = all(a.ctx == mt.cpu() for a in made) \
                and mt.current_context() == mt.cpu()
        restored = mt.current_context() == mt.gpu(0)
    default = mt.current_context() == mt.gpu(0)
    print(f"core (a): gpu(0).device_type {mt.gpu(0).device_type!r}, "
          f"with gpu(0): on cuda:0 {on_card}; nested with cpu(): on the "
          f"CPU {on_cpu}; restored {restored}, default {default}",
          flush=True)
    if not (ok and on_card and on_cpu and restored and default):
        fail("core (a): Context or its with-scope misplaced an array")
    return dict(ok=ok and on_card and on_cpu and restored and default)


def linear_data(rng, rows, nnz, feats):
    """Rows of `nnz` distinct Zipf-drawn features (value 1), labels drawn
    from a planted weight vector; returns (features, labels)."""
    import numpy as np

    cand = zipf_ids(rng, (rows, 3 * nnz), feats)
    out = np.empty((rows, nnz), np.int64)
    for i in range(rows):
        u, first = np.unique(cand[i], return_index=True)
        while u.size < nnz:  # rare: draw the row again
            u, first = np.unique(zipf_ids(rng, (3 * nnz,), feats),
                                 return_index=True)
        out[i] = np.sort(u[np.argsort(first)][:nnz])
    w_star = rng.standard_normal(feats) * 0.8
    logit = w_star[out].sum(1) - 0.2
    labels = (rng.random_sample(rows) < 1 / (1 + np.exp(-logit))).astype(
        np.int64)
    return out, labels


def write_libsvm(path, feats, labels):
    with open(path, "w") as f:
        f.write("\n".join(f"{y} " + " ".join(f"{c}:1" for c in row)
                          for row, y in zip(feats.tolist(), labels.tolist())))
        f.write("\n")


def linear_train(path, dev, epochs, w0, feats=AVAZU_FEATURES,
                 batch=LINEAR_BATCH):
    """The sparse logistic regression through the port's entry points on
    `dev`: LibSVMIter -> kv.row_sparse_pull -> sparse.dot + b -> the
    logistic gradient as row_sparse -> kv.push (lazy SGD).  Returns the
    losses, step seconds, parse seconds, each batch's (added device
    bytes, compact bytes) and the weights after step 1, epoch 1 and the
    last step (on the host)."""
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch.ndarray import sparse

    ctx = mt.context.as_context(dev)
    cuda = dev.type == "cuda"
    t0 = time.perf_counter()
    it = mt.io.LibSVMIter(data_libsvm=path, data_shape=(feats,),
                          batch_size=batch)
    parse_s = time.perf_counter() - t0
    kv = mt.kv.create("local")
    kv.set_optimizer(mt.optimizer.SGD(rescale_grad=1.0 / batch,
                                      lazy_update=True, **LINEAR_OPT))
    kv.init("w", mt.nd.array(w0, ctx=ctx))
    kv.init("b", mt.nd.zeros((1,), ctx=ctx))
    w_rsp = sparse.zeros("row_sparse", (feats, 1), ctx=ctx)
    b = mt.nd.zeros((1,), ctx=ctx)
    w_full = mt.nd.zeros((feats, 1), ctx=ctx)
    losses, step_s, nbytes, snaps = [], [], [], {}
    for ep in range(epochs):
        it.reset()
        ep_losses = []
        for batch_ in it:
            if cuda:
                torch.cuda.synchronize()
            t = time.perf_counter()
            csr = batch_.data[0].as_in_context(ctx)
            y = batch_.label[0].as_in_context(ctx)._data.reshape(-1)
            kv.row_sparse_pull("w", out=w_rsp, row_ids=csr.indices)
            kv.pull("b", out=b)
            z = (sparse.dot(csr, w_rsp) + b)._data.reshape(-1)
            loss = F.binary_cross_entropy_with_logits(z, y)
            r = mt.nd.NDArray((torch.sigmoid(z) - y).reshape(-1, 1))
            kv.push("w", sparse.dot(csr, r, transpose_a=True)
                    .tostype("row_sparse"))
            kv.push("b", mt.nd.NDArray(r._data.sum().reshape(1)))
            ep_losses.append(float(loss))
            step_s.append(time.perf_counter() - t)
            if "step1" not in snaps:
                kv.pull("w", out=w_full)
                snaps["step1"] = w_full._data.detach().cpu().clone()
        losses.append(ep_losses)
        if ep == 0:
            kv.pull("w", out=w_full)
            snaps["epoch1"] = w_full._data.detach().cpu().clone()
    kv.pull("w", out=w_full)
    snaps["last"] = w_full._data.detach().cpu().clone()
    if cuda:
        # each batch's bytes on the card: the peak the allocator holds
        # for its move there, in a memory pool of its own (a cached block
        # larger than the request would count whole, and an emptied
        # cache still keeps the free blocks of segments that other live
        # tensors hold, so the figure moved with the earlier phases)
        it.reset()
        for batch_ in it:
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            pool = torch.cuda.MemPool()
            torch.cuda.reset_peak_memory_stats()
            before = torch.cuda.memory_allocated()
            with torch.cuda.use_mem_pool(pool):
                csr = batch_.data[0].as_in_context(ctx)
            nbytes.append((torch.cuda.max_memory_allocated() - before,
                           csr.nbytes_compact()))
            del csr, pool
    return dict(losses=losses, step_s=step_s, parse_s=parse_s,
                nbytes=nbytes, snaps=snaps)


def core_linear(card, dev):
    """(b) the sparse linear classifier at avazu-app's width."""
    import tempfile

    import numpy as np

    rng = np.random.RandomState(1600)
    t0 = time.perf_counter()
    feats, labels = linear_data(rng, LINEAR_ROWS, LINEAR_NNZ,
                                AVAZU_FEATURES)
    w0 = (rng.standard_normal((AVAZU_FEATURES, 1)) * 0.01).astype(
        np.float32)
    touched = np.zeros(AVAZU_FEATURES, bool)
    touched[feats.reshape(-1)] = True
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "avazu_like.libsvm")
        write_libsvm(path, feats, labels)
        gen_s = time.perf_counter() - t0
        card_run = linear_train(path, dev, LINEAR_EPOCHS, w0)
        cpu_run = linear_train(path, torch.device("cpu"), 1, w0)
    ep_mean = [float(np.mean(x)) for x in card_run["losses"]]
    falls = all(b < a for a, b in zip(ep_mean, ep_mean[1:])) \
        and abs(card_run["losses"][0][0] - math.log(2)) < 5e-3 \
        and card_run["losses"][-1][-1] < math.log(2) - 0.05
    ratio = max(a / c for a, c in card_run["nbytes"])
    w0t = torch.from_numpy(w0)
    untouched = torch.from_numpy(~touched)
    kept = all(torch.equal(card_run["snaps"][k][untouched], w0t[untouched])
               for k in ("step1", "last"))
    moved = int((card_run["snaps"]["last"] != w0t).sum())
    w_card, w_cpu = card_run["snaps"]["epoch1"], cpu_run["snaps"]["epoch1"]
    rel = float((w_card - w_cpu).abs().max() / w_cpu.abs().max())
    steps = sorted(card_run["step_s"])
    step_ms = steps[len(steps) // 2] * 1e3
    train_s = sum(card_run["step_s"])
    parse_share = card_run["parse_s"] / (card_run["parse_s"] + train_s)
    print(f"core (b): {LINEAR_ROWS} rows x {LINEAR_NNZ} Zipf features of "
          f"{AVAZU_FEATURES}, batch {LINEAR_BATCH}, {LINEAR_EPOCHS} epochs "
          f"(data made and written in {gen_s:.2f} s): epoch mean losses "
          f"{[round(x, 5) for x in ep_mean]}, first {card_run['losses'][0][0]:.6f}"
          f" (ln 2 = {math.log(2):.6f}), last {card_run['losses'][-1][-1]:.5f}"
          f"; falls {falls}", flush=True)
    print(f"core (b): CSR batch bytes added on the card / compact bytes: "
          f"max {ratio:.4f} (bound 1.1); rows no batch touched "
          f"({int(untouched.sum())}) bit for bit their initial values after "
          f"step 1 and at the end {kept} ({moved} rows moved); card vs "
          f"CPU weights after epoch 1: {rel:.3e} of their largest "
          f"magnitude (bound 2^-20 = {2.0 ** -20:.3e})", flush=True)
    print(f"core (b): {step_ms:.3f} ms a step (median of "
          f"{len(steps)}, min {steps[0] * 1e3:.3f}, max "
          f"{steps[-1] * 1e3:.3f}); LibSVMIter parse {card_run['parse_s']:.3f}"
          f" s = {parse_share:.3f} of parse + training [{card}]",
          flush=True)
    if not falls:
        fail(f"core (b): the loss did not fall from ln 2: {ep_mean}")
    if ratio > 1.1:
        fail(f"core (b): a CSR batch took {ratio:.3f}x its compact bytes")
    if not kept:
        fail("core (b): a row no batch touched moved")
    if not rel <= 2.0 ** -20:
        fail(f"core (b): card and CPU weights after epoch 1 differ by "
             f"{rel:.3e}")
    return dict(ep_mean=ep_mean, step_ms=step_ms, parse_s=card_run[
        "parse_s"], parse_share=parse_share, bytes_ratio=ratio, rel=rel)


def ulp_close(got, want):
    """|got - want| within one fp32 ulp of want, elementwise."""
    a = want.abs()
    ulp = torch.nextafter(a, torch.full_like(a, math.inf)) - a
    return bool(((got - want).abs() <= ulp).all())


def core_lazy(card, dev):
    """(c) lazy SGD-momentum, SGD with lazy_update=False and Adam on a
    row-sparse gradient of a 1,000,000 x 64 table."""
    import numpy as np

    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import ops
    from mxnet_tpu_torch.ndarray.sparse import RowSparseNDArray

    n, d = LAZY_TABLE
    gen = torch.Generator(device=dev).manual_seed(1601)
    w0 = torch.randn(n, d, generator=gen, device=dev)
    ids = zipf_ids(np.random.RandomState(1601), (LINEAR_BATCH, LINEAR_NNZ),
                   n)
    rows = torch.unique(torch.from_numpy(ids).to(dev))
    u = rows.numel()
    g_dense = torch.zeros(n, d, device=dev)
    g_dense.index_copy_(0, rows, torch.randn(u, d, generator=gen,
                                             device=dev))
    grad = RowSparseNDArray(g_dense, rows)
    hyper = dict(learning_rate=0.1, wd=1e-4)
    res = {"rows": u}
    mask = torch.zeros(n, dtype=torch.bool, device=dev)
    mask[rows] = True
    # lazy SGD with momentum, two updates
    opt = mt.optimizer.SGD(momentum=0.9, lazy_update=True, **hyper)
    w = mt.nd.NDArray(w0.clone())
    st = opt.create_state(0, w)
    w_ref, m_ref = w0.clone(), torch.zeros_like(w0)
    for _ in range(2):
        opt.update(0, w, grad, st)
        w_ref, m_ref = ops.sgd_mom_update(w_ref, g_dense, m_ref, lr=0.1,
                                          momentum=0.9, wd=1e-4)
    lazy_ok = torch.equal(w._data[~mask], w0[~mask]) \
        and bool((st._data[~mask] == 0).all()) \
        and ulp_close(w._data[mask], w_ref[mask]) \
        and ulp_close(st._data[mask], m_ref[mask])
    # SGD with lazy_update=False and Adam: the dense update on the view
    dense_ok = {}
    for name, o_kw in (("sgd_dense", dict(lazy_update=False)),
                       ("adam", dict(lazy_update=True))):
        make = (lambda: mt.optimizer.SGD(**o_kw, **hyper)) \
            if name == "sgd_dense" else \
            (lambda: mt.optimizer.Adam(**o_kw, **hyper))
        o1, o2 = make(), make()
        a, b_ = mt.nd.NDArray(w0.clone()), mt.nd.NDArray(w0.clone())
        s1, s2 = o1.create_state(0, a), o2.create_state(0, b_)
        o1.update(0, a, grad, s1)
        o2.update(0, b_, mt.nd.NDArray(g_dense), s2)
        dense_ok[name] = torch.equal(a._data, b_._data) \
            and not torch.equal(a._data[~mask], w0[~mask])
    # times: each update as called, against the dense update
    wt, mt_ = mt.nd.NDArray(w0.clone()), mt.nd.NDArray(torch.zeros_like(w0))
    opt_t = mt.optimizer.SGD(momentum=0.9, lazy_update=True, **hyper)
    opt_d = mt.optimizer.SGD(lazy_update=False, **hyper)
    opt_a = mt.optimizer.Adam(**hyper)
    sa = opt_a.create_state(0, wt)
    w_d, m_d = w0.clone(), torch.zeros_like(w0)
    row_b, full_b = u * d * 4, n * d * 4
    cases = [
        ("lazy sgd_mom (rows)", lambda: opt_t.update(0, wt, grad, mt_),
         5 * row_b + u * 8),
        ("dense sgd_mom_update", lambda: ops.sgd_mom_update(
            w_d, g_dense, m_d, lr=0.1, momentum=0.9, wd=1e-4), 5 * full_b),
        ("sgd lazy_update=False", lambda: opt_d.update(0, wt, grad, None),
         3 * full_b),
        ("adam (lazy_update ignored)", lambda: opt_a.update(0, wt, grad, sa),
         7 * full_b)]
    res["ms"] = {}
    for tag, fn, nbytes in cases:
        ms = time_ms(fn, iters=10, warmup=2)
        bound = nbytes / PEAK_BYTES * 1e3
        res["ms"][tag] = dict(ms=ms, bound_ms=bound)
        print(f"core (c): {tag}: {ms:.4f} ms, bound {bound:.4f} ms "
              f"(bytes; {nbytes / 1e6:.1f} MB), {nbytes / ms / 1e6:.1f} "
              f"GB/s [{card}]", flush=True)
    print(f"core (c): {n} x {d} fp32 table, gradient rows {u} of "
          f"{LINEAR_BATCH} x {LINEAR_NNZ} Zipf ids: lazy SGD-momentum "
          f"(2 updates) untouched rows bit for bit, touched within one ulp "
          f"of the dense update {lazy_ok}; lazy_update=False and Adam bit "
          f"for bit the dense update, untouched rows moved "
          f"{dense_ok}", flush=True)
    if not lazy_ok:
        fail("core (c): the lazy SGD-momentum update moved an untouched "
             "row or missed the dense update on a touched one")
    if not all(dense_ok.values()):
        fail(f"core (c): a dense update on the sparse gradient differs "
             f"from the dense one: {dense_ok}")
    res.update(lazy_ok=lazy_ok, dense_ok=dense_ok)
    del w0, g_dense, grad, w, st, w_ref, m_ref, wt, mt_, sa, w_d, m_d
    torch.cuda.empty_cache()
    return res


def _fro(t):
    return float(torch.linalg.vector_norm(t.double()))


def core_linalg(card, dev):
    """(d) every linalg name on the card against float64 on the CPU."""
    from mxnet_tpu_torch.ops import registry as reg

    def op(name):
        return reg.get_op(name).fn

    B, N, n = LINALG_B, LINALG_BIG, LINALG_SMALL
    gen = torch.Generator(device=dev).manual_seed(1602)
    u32 = 2.0 ** -24
    rows = []

    def check(name, args, ref_args, ms_flops, nbytes, cmp, cpu_fn=None,
              iters=3):
        """Run `name` on the card, time it, and hold it with `cmp(got,
        ref)` against the float64 CPU op on the checked batch entries
        (or against `cpu_fn`, the CPU fp32 op, for the copies)."""
        fn = op(name)
        got = fn(*args)
        ms = time_ms(lambda: fn(*args), iters=iters, warmup=1)
        if cpu_fn is None:
            ref = fn(*ref_args)
        else:
            ref = cpu_fn()
        ok, err = cmp(got, ref)
        bound = max(ms_flops / PEAK_FP32, nbytes / PEAK_BYTES) * 1e3
        by = "operations" if ms_flops / PEAK_FP32 >= nbytes / PEAK_BYTES \
            else "bytes"
        rows.append(dict(name=name, ms=ms, bound_ms=bound, bound_by=by,
                         err=err, ok=ok))
        print(f"core (d): {name}: {ms:.3f} ms, bound {bound:.4f} ms ({by})"
              f", {bound / ms:.3f} of it; error {err:.3e} held {ok} "
              f"[{card}]", flush=True)
        if not ok:
            fail(f"core (d): {name} off its float64 reference ({err:.3e})")

    chk = list(LINALG_CHECKED)

    def sel(t):
        return t[chk].cpu()

    def normwise(k):
        def cmp(got, ref):
            got = got if isinstance(got, (tuple, list)) else (got,)
            ref = ref if isinstance(ref, (tuple, list)) else (ref,)
            errs = [_fro(sel(g).double() - r) / max(_fro(r), 1e-300)
                    for g, r in zip(got, ref)]
            return max(errs) <= 8 * k * u32, max(errs)
        return cmp

    def exact(got, ref):
        got = got if isinstance(got, (tuple, list)) else (got,)
        ref = ref if isinstance(ref, (tuple, list)) else (ref,)
        same = all(torch.equal(g.cpu(), r) for g, r in zip(got, ref))
        return same, 0.0 if same else 1.0

    # ---- 8 x 2048^2 fp32 ---------------------------------------------------
    m = torch.randn(B, N, N, generator=gen, device=dev)
    a64 = torch.eye(N, device=dev, dtype=torch.float64) \
        + (m.double() @ m.double().transpose(-1, -2)) / (4 * N)
    a = a64.float()
    l32 = torch.linalg.cholesky(a64).float()   # the factor potri reads
    rhs = torch.randn(B, N, N, generator=gen, device=dev)
    c = torch.randn(B, N, N, generator=gen, device=dev)
    n3, n2 = B * N ** 3, B * N * N * 4

    def prod(k, mags):
        """Products: ||E||_F <= 2^-22 k sum of ||A||_F ||B||_F terms."""
        def cmp(got, ref):
            err = _fro(sel(got).double() - ref)
            return err <= 2.0 ** -22 * k * mags, err / max(_fro(ref), 1e-300)
        return cmp

    def f64(*ts):
        return [sel(t).double() for t in ts]

    check("linalg_potrf", (a,), f64(a), n3 / 3, 2 * n2, normwise(N))
    check("linalg_potri", (l32,), f64(l32), 2 * n3 / 3, 2 * n2, normwise(N))
    check("linalg_trsm", (l32, rhs), f64(l32, rhs), n3, 3 * n2,
          normwise(N))
    fa, fm, fr, fc = (_fro(sel(t)) for t in (l32, m, rhs, c))
    check("linalg_trmm", (l32, rhs), f64(l32, rhs), n3, 3 * n2,
          prod(N, fa * fr))
    check("linalg_syrk", (m,), f64(m), n3, 2 * n2, prod(N, fm * fm))
    check("linalg_gemm", (m, rhs, c), f64(m, rhs, c), 2 * n3, 4 * n2,
          prod(N + 1, fm * fr + fc))
    check("linalg_gemm2", (m, rhs), f64(m, rhs), 2 * n3, 3 * n2,
          prod(N, fm * fr))
    check("linalg_sumlogdiag", (l32,), f64(l32), B * N, n2,
          normwise(N))
    check("linalg_extractdiag", (a,), None, 0, n2 + B * N * 4, exact,
          cpu_fn=lambda: op("linalg_extractdiag")(a.cpu()))
    del a64, a, l32, rhs, c, m
    torch.cuda.empty_cache()

    # ---- 8 x 512^2 ---------------------------------------------------------
    m = torch.randn(B, n, n, generator=gen, device=dev)
    s64 = torch.eye(n, device=dev, dtype=torch.float64) \
        + (m.double() @ m.double().transpose(-1, -2)) / (4 * n)
    sym = s64.float()
    g32 = (2 * torch.eye(n, device=dev) + m / (2 * math.sqrt(n)))
    # det: scaled so that |det| is near 1 (fp32 holds it)
    logdet = torch.linalg.slogdet(g32.double())[1]
    d32 = g32 * torch.exp(-logdet / n).float()[:, None, None]
    rhs = torch.randn(B, n, 64, generator=gen, device=dev)
    s3, s2 = B * n ** 3, B * n * n * 4

    def syevd_cmp(got, ref):
        u_, w_ = got
        w64 = ref[1]
        ew = _fro(sel(w_).double() - w64) / _fro(w64)
        uc = sel(u_).double()
        rec = uc.transpose(-1, -2) @ torch.diag_embed(sel(w_).double()) @ uc
        er = _fro(rec - sel(sym).double()) / _fro(sel(sym).double())
        eo = _fro(uc @ uc.transpose(-1, -2) - torch.eye(n, dtype=torch.float64))
        bound = 8 * n * u32
        print(f"core (d): linalg_syevd: eigenvalues {ew:.3e}, "
              f"reconstruction {er:.3e}, orthogonality {eo:.3e} "
              f"(/sqrt(n) {eo / math.sqrt(n):.3e})", flush=True)
        return ew <= bound and er <= bound and eo <= bound * math.sqrt(n), \
            max(ew, er, eo / math.sqrt(n))

    def lq_canon(lo, q):
        sgn = torch.sign(torch.diagonal(lo, dim1=-2, dim2=-1))
        return lo * sgn[..., None, :], q * sgn[..., :, None]

    def gelqf_cmp(got, ref):
        lo, q = lq_canon(*(sel(t).double() for t in got))
        lr, qr = lq_canon(*ref)
        errs = [_fro(lo - lr) / _fro(lr), _fro(q - qr) / _fro(qr)]
        return max(errs) <= 8 * n * u32, max(errs)

    def det_cmp(got, ref):
        err = float(((sel(got).double() - ref).abs() / ref.abs()).max())
        return err <= 8 * n * u32, err

    def slogdet_cmp(got, ref):
        sg, lg = got
        same = torch.equal(sel(sg).double(), ref[0])
        err = float((sel(lg).double() - ref[1]).abs().max())
        return same and err <= 8 * n * u32, err

    check("linalg_syevd", (sym,), f64(sym), 9 * s3, 3 * s2 + B * n * 4,
          syevd_cmp)
    check("linalg_gelqf", (g32,), f64(g32), 4 * s3 / 3, 3 * s2, gelqf_cmp)
    for name in ("linalg_inverse", "inverse"):
        check(name, (g32,), f64(g32), 2 * s3, 2 * s2, normwise(n))
    for name in ("linalg_det", "det"):
        check(name, (d32,), f64(d32), 2 * s3 / 3, s2, det_cmp)
    for name in ("linalg_slogdet", "slogdet"):
        check(name, (g32,), f64(g32), 2 * s3 / 3, s2, slogdet_cmp)
    for name in ("linalg_solve", "solve"):
        check(name, (g32, rhs), f64(g32, rhs),
              2 * s3 / 3 + 2 * B * n * n * 64, s2 + 2 * B * n * 64 * 4,
              normwise(n))
    vec = torch.randn(B, n, generator=gen, device=dev)
    check("linalg_makediag", (vec,), None, 0, B * n * 4 + s2, exact,
          cpu_fn=lambda: op("linalg_makediag")(vec.cpu()))
    tri = op("linalg_extracttrian")(sym)
    check("linalg_extracttrian", (sym,), None, 0, s2 + tri.numel() * 4,
          exact, cpu_fn=lambda: op("linalg_extracttrian")(sym.cpu()))
    check("linalg_maketrian", (tri,), None, 0, s2 + tri.numel() * 4,
          exact, cpu_fn=lambda: op("linalg_maketrian")(tri.cpu()))
    ka = torch.randn(256, 512, generator=gen, device=dev)
    kb = torch.randn(128, 512, generator=gen, device=dev)
    check("khatri_rao", (ka, kb), None, 256 * 128 * 512,
          (256 + 128 + 256 * 128) * 512 * 4, exact,
          cpu_fn=lambda: op("khatri_rao")(ka.cpu(), kb.cpu()))
    del m, s64, sym, g32, d32, rhs, vec, tri, ka, kb
    torch.cuda.empty_cache()

    # ---- moments over ResNet-50 stage-1 activations ------------------------
    x = torch.relu(torch.randn(*MOMENTS_SHAPE, generator=gen,
                               device=dev)).to(torch.bfloat16)

    def moments_cmp(got, ref):
        errs = []
        for g, r in zip(got, ref):
            gf = g.cpu().double()
            slack = bf16_ulp(r.float()).double() + 2.0 ** -16 * r.abs()
            errs.append(float(((gf - r).abs() / slack).max()))
        return max(errs) <= 1.0, max(errs)

    def moments_ref():
        xd = x.cpu().double()
        mean = xd.mean(dim=(0, 1, 2))
        return mean, ((xd - mean) ** 2).mean(dim=(0, 1, 2))

    check("moments", (x, (0, 1, 2)), None, 3 * x.numel(),
          x.numel() * 2 + 4 * x.shape[-1], moments_cmp, cpu_fn=moments_ref)
    del x
    torch.cuda.empty_cache()
    return rows


def naive_engine_child():
    """(e)'s child: run under MXNET_ENGINE_TYPE=NaiveEngine, print one
    JSON line."""
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import engine
    from mxnet_tpu_torch.ops import registry as reg

    torch.backends.cuda.matmul.allow_tf32 = False
    x = mt.nd.random.normal(shape=(4096, 4096), ctx=mt.gpu(0))
    torch.cuda.synchronize()
    stream = torch.cuda.current_stream()
    idle_after_op = []
    for _ in range(3):
        mt.nd.dot(x, x)
        idle_after_op.append(stream.query())
    busy_in_bulk = []
    with engine.bulk(15):
        for _ in range(3):
            mt.nd.dot(x, x)
            busy_in_bulk.append(not stream.query())
    idle_at_exit = stream.query()
    print(json.dumps(dict(engine=engine.current_engine_type(),
                          naive=reg._NAIVE, idle_after_op=idle_after_op,
                          busy_in_bulk=busy_in_bulk,
                          idle_at_exit=idle_at_exit)), flush=True)
    return 0


def core_engine(card, dev):
    """(e) NaiveEngine in a child process against the default engine in
    this one."""
    import mxnet_tpu_torch as mt

    res = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--naive-engine"],
        env=dict(os.environ, MXNET_ENGINE_TYPE="NaiveEngine"),
        capture_output=True, text=True, timeout=300)
    child = {}
    try:
        child = json.loads(res.stdout.strip().splitlines()[-1])
    except (ValueError, IndexError):
        pass
    x = mt.nd.random.normal(shape=(4096, 4096), ctx=mt.gpu(0))
    torch.cuda.synchronize()
    mt.nd.dot(x, x)
    busy_default = not torch.cuda.current_stream().query()
    torch.cuda.synchronize()
    ok = (res.returncode == 0 and child.get("engine") == "NaiveEngine"
          and child.get("naive") is True
          and all(child.get("idle_after_op", [False]))
          and all(child.get("busy_in_bulk", [False]))
          and child.get("idle_at_exit") is True)
    print(f"core (e): NaiveEngine child (exit {res.returncode}): {child}; "
          f"default engine busy after the op {busy_default}; held {ok}",
          flush=True)
    if not ok:
        for line in (res.stdout + res.stderr).splitlines()[-40:]:
            print(f"  [naive] {line}", flush=True)
        fail("core (e): NaiveEngine did not synchronise as it should")
    if not busy_default:
        fail("core (e): the default engine waited for the op")
    return dict(child=child, busy_default=busy_default, ok=ok)


def phase_core(card):
    """Phase 16: the core runtime on the card ((a) to (e))."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    res = dict(context=core_context(dev))
    res["linear"] = core_linear(card, dev)
    res["lazy"] = core_lazy(card, dev)
    res["linalg"] = core_linalg(card, dev)
    res["engine"] = core_engine(card, dev)
    res["seconds"] = time.perf_counter() - t0
    print(f"core: phase 16 took {res['seconds']:.1f} s", flush=True)
    return res


# ---------------------------------------------------------------------------
# phase 17: the vision training path
# ---------------------------------------------------------------------------

VISION_STEPS = 5                  # (a): steps the loss must fall over
REMAT_STEPS = 3                   # (b): steps held bit for bit
CKPT_AT, CKPT_MORE = 3, 2         # (c): steps before the save, after it
ZERO_BATCH = TRAIN_BATCH           # (d): phase 6's shapes, 128 a rank
ZERO_STEPS = 2
ZOO_BATCH, ZOO_CHECK_BATCH = 32, 1  # 2 before phase 21 (the script's time)
ZOO_BOUND = 2e-4                  # (f): fp32 card vs CPU, of max|CPU|
ZOO_NEW = ("resnet18_v2", "resnet34_v2", "resnet50_v2", "resnet101_v2",
           "resnet152_v2", "vgg11", "vgg13", "vgg16", "vgg19", "vgg11_bn",
           "vgg13_bn", "vgg16_bn", "vgg19_bn", "alexnet", "squeezenet1.0",
           "squeezenet1.1", "densenet121", "densenet161", "densenet169",
           "densenet201", "inceptionv3")
ZOO_SERVED = ("resnet50_v2", "vgg16")
CIFAR_BATCH, CIFAR_WORKERS = 128, 2
CIFAR_OPT = {"learning_rate": 0.05, "momentum": 0.9, "wd": 1e-4}
CIFAR_MEAN, CIFAR_STD = (0.4914, 0.4822, 0.4465), (0.2470, 0.2435, 0.2616)


def vision_net(name, dtype, seed, dev, **kw):
    from mxnet_tpu_torch import init
    from mxnet_tpu_torch.gluon.model_zoo import vision

    net = vision.get_model(name, classes=1000, layout="NHWC", **kw)
    net.initialize(init.Xavier(), ctx=dev, seed=seed)
    net.cast(dtype)
    return net


def vision_trainer(net, remat=False, **opt):
    from mxnet_tpu_torch import parallel
    from mxnet_tpu_torch.gluon import loss as gloss

    return parallel.SPMDTrainer(net, gloss.SoftmaxCrossEntropyLoss(), "sgd",
                                dict(TRAIN_OPT, **opt),
                                mesh=parallel.make_mesh(dp=1), remat=remat)


def vision_resnet50_v2(card, dev, gen):
    """(a) resnet50_v2 (bf16, NHWC, 224², batch 256) through SPMDTrainer:
    the captured step against eager (bit for bit, ms, idle share), then
    VISION_STEPS captured steps on the fixed batch, the loss falling."""
    net = vision_net("resnet50_v2", "bfloat16", 3, dev)
    xb = torch.rand(TRAIN_BATCH, 224, 224, 3, generator=gen).to(
        dev, torch.bfloat16)
    yb = torch.randint(0, 1000, (TRAIN_BATCH,), generator=gen).to(dev)
    w0 = {k: v.detach().clone() for k, v in net.state_dict().items()}
    set_knobs(True, True)  # V2 has no fused path: no launch either way
    tr = vision_trainer(net)
    res = hold_captured_steps(f"vision (a): resnet50_v2 bf16 batch "
                              f"{TRAIN_BATCH}", tr, (xb, yb), card, {})
    restore(net, w0)
    tr = vision_trainer(net)
    losses, fwd, bwd, dt = counted_steps(tr, xb, yb, VISION_STEPS)
    falls = all(math.isfinite(v) for v in losses) and losses[-1] < losses[0]
    print(f"vision (a): resnet50_v2 {VISION_STEPS} steps on one batch "
          f"(the first builds the capture): losses "
          f"{' '.join(f'{v:.4f}' for v in losses)}, falling {falls}; "
          f"launches {fwd}/{bwd} [{card}]", flush=True)
    if not falls or fwd or bwd:
        fail(f"vision (a): losses {losses}, launches {fwd}/{bwd}")
    res.update(losses_fixed_batch=losses, falls=falls)
    return res, net, w0, (xb, yb)


def remat_runs(tag, net, w0, batch, card, want):
    """REMAT_STEPS steps with and without remat from `w0` (fresh
    trainers, captured after the first step), then REMAT_STEPS timed;
    both states bit for bit (again under cudnn.deterministic where
    cuDNN's algorithm choice breaks that)."""
    res = {}
    for det in (False, True):
        old_det = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = det
        try:
            for remat in (False, True):
                restore(net, w0)
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
                tr = vision_trainer(net, remat=remat)
                reset_kernel_counts()
                losses = counted_steps(tr, *batch, REMAT_STEPS)[0]
                counts = kernel_counts()
                st = trainer_state(tr)
                peak = torch.cuda.max_memory_allocated() / 2 ** 30
                dt = counted_steps(tr, *batch, REMAT_STEPS)[3]
                res[remat] = dict(
                    state=st, losses=losses, peak_gib=peak, ms=dt * 1e3,
                    pool_gib=graph_costs(tr.graphs())[1],
                    per_step={k: v / REMAT_STEPS for k, v in counts.items()})
                del tr
        finally:
            torch.backends.cudnn.deterministic = old_det
        a, b = res[False], res[True]
        bad = state_mismatch(a["state"], b["state"]) + [
            "losses" for _ in [0] if a["losses"] != b["losses"]]
        if not bad or det:
            break
        print(f"{tag}: {len(bad)} tensors differ under cuDNN's default "
              f"algorithms ({bad[:3]}); again under cudnn.deterministic",
              flush=True)
    print(f"{tag}: {REMAT_STEPS} steps with remat bit-identical to "
          f"without {not bad} ({len(a['state'][0])} parameters and buffers, "
          f"{len(a['state'][1])} optimizer states"
          f"{', cudnn.deterministic' if det else ''}); graph pool "
          f"{a['pool_gib']:.2f} / {b['pool_gib']:.2f} GiB, peak allocated "
          f"{a['peak_gib']:.2f} / {b['peak_gib']:.2f} GiB, "
          f"{a['ms']:.2f} / {b['ms']:.2f} ms a step (without / with remat); "
          f"launches a step without {a['per_step']} with {b['per_step']} "
          f"[{card}]", flush=True)
    if bad or any(b["per_step"][k] != want.get(k, 0) for k in b["per_step"]) \
            or a["per_step"] != b["per_step"]:
        fail(f"{tag}: {len(bad)} tensors differ ({bad[:6]}), launches "
             f"{a['per_step']} / {b['per_step']} (want {want})")
    return dict(identical=not bad, deterministic=det,
                pool_gib=[a["pool_gib"], b["pool_gib"]],
                peak_gib=[a["peak_gib"], b["peak_gib"]],
                ms=[a["ms"], b["ms"]], per_step=b["per_step"],
                launches=int(b["per_step"]["k1"] * REMAT_STEPS),
                launches_bwd=int(b["per_step"]["k2"] * REMAT_STEPS))


def vision_checkpoint(net, w0, batch, card):
    """(c) CKPT_AT steps, save, CKPT_MORE more: the uninterrupted run.  A
    fresh trainer loads the checkpoint and takes CKPT_MORE steps: bit
    for bit the uninterrupted run.  The first trainer loads it too, in
    place: its captured step replays, nothing is built."""
    import shutil

    from mxnet_tpu_torch.parallel import spmd

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "build", "chip_smoke_ckpt")
    shutil.rmtree(path, ignore_errors=True)
    old_det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        restore(net, w0)
        tr = vision_trainer(net)
        counted_steps(tr, *batch, CKPT_AT)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tr.save_checkpoint(path)
        save_s = time.perf_counter() - t0
        nbytes = sum(os.path.getsize(os.path.join(path, f))
                     for f in os.listdir(path))
        counted_steps(tr, *batch, CKPT_MORE)
        want = trainer_state(tr)
        restore(net, w0)
        fresh = vision_trainer(net)
        t0 = time.perf_counter()
        fresh.load_checkpoint(path)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        counted_steps(fresh, *batch, CKPT_MORE)
        got = trainer_state(fresh)
        bad = state_mismatch(got, want)
        n0 = spmd.step_compile_stats()["count"]
        tr.load_checkpoint(path)
        counted_steps(tr, *batch, CKPT_MORE)
        built = spmd.step_compile_stats()["count"] - n0
        bad_inplace = state_mismatch(trainer_state(tr), want)
    finally:
        torch.backends.cudnn.deterministic = old_det
    print(f"vision (c): checkpoint after step {CKPT_AT} of resnet50_v2, "
          f"{nbytes / 2 ** 20:.1f} MiB in {save_s:.3f} s, loaded in "
          f"{load_s:.3f} s; a fresh trainer's {CKPT_MORE} steps from it "
          f"bit-identical to the uninterrupted run {not bad} (cudnn."
          f"deterministic); loaded into the capturing trainer: "
          f"{built} step(s) built, bit-identical {not bad_inplace} [{card}]",
          flush=True)
    if bad or bad_inplace or built:
        fail(f"vision (c): resumed run differs on {bad[:4]}, in place on "
             f"{bad_inplace[:4]}, {built} builds after an in-place load")
    shutil.rmtree(path, ignore_errors=True)
    return dict(save_s=save_s, load_s=load_s, bytes=nbytes,
                identical=not bad, rebuilt=built)


def zero_rank(rank, out_dir, backend, devices):
    """One rank of phase 17 (d): ResNet-50 V1 fused, bf16, at dp = 2,
    ZERO_STEPS steps with MXNET_ZERO_STATES on and off from the same
    weights; the state bytes a rank holds, the digests of the weights
    and full momenta, the launches and the ms a step."""
    from mxnet_tpu_torch import parallel

    dev = torch.device(devices[rank])
    torch.cuda.set_device(dev)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    parallel.dist.init(backend=backend, timeout=DP_COLLECTIVE_TIMEOUT)
    mesh = parallel.make_mesh(dp=DP, devices=devices)
    gen = torch.Generator().manual_seed(17)
    xb = torch.rand(ZERO_BATCH, 224, 224, 3, generator=gen).to(
        dev, torch.bfloat16)
    yb = torch.randint(0, 1000, (ZERO_BATCH,), generator=gen).to(dev)
    net = build_net("bfloat16", 0, dev)
    w0 = {k: v.detach().clone() for k, v in net.state_dict().items()}
    set_knobs(True, True)
    res = {"rank": rank, "runs": {}}
    for zero in ("1", "0"):
        os.environ["MXNET_ZERO_STATES"] = zero
        restore(net, w0)
        tr = new_trainer(net, mesh)
        state_bytes = sum(s.numel() * s.element_size()
                          for st in tr.opt_state.values() for s in st)
        split = sum(1 for n in tr.opt_state if n in tr._zero_dims)
        losses, fwd, bwd, _ = counted_steps(tr, xb, yb, ZERO_STEPS)
        digest = state_digest(net, tr)
        parallel.dist.barrier()
        dt = counted_steps(tr, xb, yb, ZERO_STEPS)[3]
        res["runs"][zero] = dict(losses=losses, fwd=fwd, bwd=bwd,
                                 digest=digest, state_bytes=state_bytes,
                                 split=split, tensors=len(tr.opt_state),
                                 ms=dt * 1e3)
        print(f"zero rank {rank} MXNET_ZERO_STATES={zero}: optimizer state "
              f"{state_bytes / 2 ** 20:.2f} MiB on this rank ({split} of "
              f"{len(tr.opt_state)} tensors split), losses {losses}, "
              f"launches {fwd}/{bwd}, {dt * 1e3:.1f} ms a step", flush=True)
        del tr
    os.environ.pop("MXNET_ZERO_STATES", None)
    parallel.dist.barrier()
    parallel.dist.shutdown()
    res["jax_imported"] = sorted(m for m in sys.modules
                                 if m == "jax" or m.startswith("jax.")
                                 or m.split(".")[0] == "mxnet_tpu")
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    return 1 if FAILURES or res["jax_imported"] else 0


def vision_zero(card):
    """(d) ZeRO at dp = 2 on ResNet-50 V1 fused: the ranks spawned as in
    phase 6 (gloo on one card, NCCL on two or more)."""
    import shutil

    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "build", "chip_smoke_zero")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    if torch.cuda.device_count() >= DP:
        backend, devices = "nccl", [f"cuda:{r}" for r in range(DP)]
    else:
        backend, devices = "gloo", ["cuda:0"] * DP
    mode = f"{DP} ranks, backend {backend}, devices {','.join(devices)}"
    errors = spawn_ranks(out_dir, backend, devices, flag="--zero-rank")
    for e in errors:
        fail(f"vision (d): {e}")
    if errors:
        return {"launches": {"fwd": 0, "bwd": 0}, "mode": mode}
    ranks = []
    for r in range(DP):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    on = [rk["runs"]["1"] for rk in ranks]
    off = [rk["runs"]["0"] for rk in ranks]
    want = (FWD_PER_STEP * ZERO_STEPS, BWD_PER_STEP * ZERO_STEPS)
    bad = []
    for r in range(DP):
        for tag, run in (("on", on[r]), ("off", off[r])):
            if (run["fwd"], run["bwd"]) != want:
                bad.append(f"rank {r} {tag} launches {run['fwd']}/"
                           f"{run['bwd']} (want {want})")
        differ = [k for k, v in off[r]["digest"].items()
                  if on[r]["digest"][k] != v]
        if differ or on[r]["losses"] != off[r]["losses"]:
            bad.append(f"rank {r}: ZeRO on differs from off on "
                       f"{len(differ)} tensors ({differ[:3]}) or the losses")
        if on[r]["digest"] != on[0]["digest"]:
            bad.append(f"rank {r} differs from rank 0")
        if ranks[r]["jax_imported"]:
            bad.append(f"rank {r} loaded {ranks[r]['jax_imported']}")
    share = [on[r]["state_bytes"] / off[r]["state_bytes"] for r in range(DP)]
    print(f"vision (d): ZeRO dp={DP} ResNet-50 V1 fused bf16 batch "
          f"{ZERO_BATCH}: optimizer state a rank {on[0]['state_bytes']} B "
          f"against {off[0]['state_bytes']} B replicated, share "
          f"{' '.join(f'{s:.6f}' for s in share)} ({on[0]['split']} of "
          f"{on[0]['tensors']} tensors split, the rest replicated); weights "
          f"and momenta after {ZERO_STEPS} steps bit-identical to ZeRO off "
          f"{not bad}; rank ms a step ZeRO on "
          f"{[round(o['ms'], 2) for o in on]} off "
          f"{[round(o['ms'], 2) for o in off]} [{mode}] [{card}]",
          flush=True)
    if bad or not all(0.45 < s < 0.55 for s in share):
        fail(f"vision (d): {bad[:4]}, state share {share}")
    return dict(mode=mode, backend=backend, share=share,
                state_bytes=[on[0]["state_bytes"], off[0]["state_bytes"]],
                split=on[0]["split"], tensors=on[0]["tensors"],
                ms_on=[o["ms"] for o in on], ms_off=[o["ms"] for o in off],
                identical=not bad,
                launches={"fwd": on[0]["fwd"], "bwd": on[0]["bwd"]})


def vision_multi_precision(card, net, w0, batch, train_res):
    """(e) SGD with multi_precision on the bf16 ResNet-50 V1, fused and
    captured: one replayed step's fp32 master and momentum against
    sgd_mom_update on fp32 values (the master before the step, the
    step's gradient in fp32), bit for bit; its ms against phase 5's
    captured step and this phase's plain captured step."""
    from mxnet_tpu_torch import ops
    from mxnet_tpu_torch.gluon import ActiveTrace
    from mxnet_tpu_torch.gluon import loss as gloss

    old_det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        set_knobs(True, True)
        restore(net, w0)
        tr = vision_trainer(net, multi_precision=True)
        s0 = trainer_state(tr)
        tr.step(*batch)  # the build
        # the step's gradient, eagerly, from the same state
        set_trainer_state(tr, s0)
        names = tr._trainable
        with ActiveTrace(train=True):
            loss = gloss.SoftmaxCrossEntropyLoss()(net(batch[0]),
                                                   batch[1]).mean()
        grads = dict(zip(names, torch.autograd.grad(
            loss, [tr.params[n] for n in names])))
        set_trainer_state(tr, s0)
        reset_kernel_counts()
        tr.step(*batch)
        torch.cuda.synchronize()
        counts = kernel_counts()
        worst, bad = 0.0, []
        masters = 0
        for n in names:
            # bf16 weights carry (momentum, fp32 master); the fp32 ones
            # (BatchNorm's) only the momentum and update in place
            mp = len(s0[1][n]) == 2
            mom0 = s0[1][n][0]
            w32 = s0[1][n][1] if mp else s0[0][n]
            want_w, want_m = ops.sgd_mom_update(
                w32, grads[n].float(), mom0, lr=TRAIN_OPT["learning_rate"],
                momentum=TRAIN_OPT["momentum"], wd=TRAIN_OPT["wd"])
            got_m = tr.opt_state[n][0]
            got_w = tr.opt_state[n][1] if mp else tr.params[n]
            masters += mp
            err = max(float((got_w - want_w).abs().max()),
                      float((got_m - want_m).abs().max()))
            worst = max(worst, err)
            if err or not torch.equal(tr.params[n], got_w.to(
                    tr.params[n].dtype)):
                bad.append(n)
        dt = counted_steps(tr, *batch, CAPTURE_K)[3]
    finally:
        torch.backends.cudnn.deterministic = old_det
    p5 = train_res.get("compiled", {}).get("fused", {}).get("captured_ms")
    print(f"vision (e): multi_precision SGD on the bf16 ResNet-50 V1, fused "
          f"and captured: {masters} fp32 masters (and {len(names) - masters}"
          f" fp32 BatchNorm weights) with their momenta against "
          f"sgd_mom_update on fp32 values, max abs err {worst:.3g}, "
          f"{len(bad)} differ; the bf16 weight is the master rounded; "
          f"launches a step {counts}; {dt * 1e3:.2f} ms a step against "
          f"phase 5's captured {p5 if p5 is None else round(p5, 2)} ms "
          f"[{card}]", flush=True)
    if bad or counts["k1"] != FWD_PER_STEP or counts["k2"] != BWD_PER_STEP:
        fail(f"vision (e): {len(bad)} masters differ ({bad[:4]}), "
             f"launches {counts}")
    return dict(max_abs_err=worst, differ=len(bad), masters=masters,
                ms=dt * 1e3, phase5_ms=p5, launches={"fwd": counts["k1"],
                                        "bwd": counts["k2"]})


def vision_zoo(card, dev, gen):
    """(f) the 21 new zoo constructors: fp32 on the card against the CPU
    at batch ZOO_CHECK_BATCH (eval forward, within ZOO_BOUND of the
    CPU's largest magnitude), then bf16 at batch ZOO_BATCH hybridized:
    the captured forward's ms against eager; a V2 net and a VGG served
    through export_model -> ModelRepository -> InferenceServer."""
    import copy

    from mxnet_tpu_torch import _graphs as graphs
    from mxnet_tpu_torch import cpu, init
    from mxnet_tpu_torch.gluon.model_zoo import vision

    rows, bad, keep = [], [], {}
    for name in ZOO_NEW:
        size = 299 if name.startswith("inception") else 224
        x = torch.rand(ZOO_BATCH, 3, size, size, generator=gen)
        net = vision.get_model(name, classes=1000)
        net.initialize(init.Xavier(), ctx=cpu(), seed=5)
        net.hybridize()
        net.eval()
        with torch.no_grad():
            want = net(x[:ZOO_CHECK_BATCH])
        card_net = copy.deepcopy(net).to(dev)
        with torch.no_grad():
            got = card_net(x[:ZOO_CHECK_BATCH].to(dev)).cpu()
        err = float((got - want).abs().max() / want.abs().max())
        card_net.cast("bfloat16")
        xb = x.to(dev, torch.bfloat16)

        def fwd():
            with torch.no_grad():
                return card_net(xb)
        out = fwd()  # the eager first call, then the capture
        fwd()
        cap = time_ms(fwd, iters=3, warmup=1)
        with graphs.no_capture():
            eag = time_ms(fwd, iters=3, warmup=1)
        finite = bool(torch.isfinite(out.float()).all())
        rows.append(dict(name=name, err=err, captured_ms=cap, eager_ms=eag,
                         finite=finite))
        print(f"vision (f): {name} fp32 batch {ZOO_CHECK_BATCH} card vs CPU "
              f"{err:.3g} of max|CPU| (bound {ZOO_BOUND}); bf16 batch "
              f"{ZOO_BATCH} at {size}² captured {cap:.2f} ms, eager "
              f"{eag:.2f} ms ({eag / cap:.2f}x) [{card}]", flush=True)
        if not err <= ZOO_BOUND or not finite or tuple(out.shape) != (
                ZOO_BATCH, 1000):
            bad.append(name)
        if name in ZOO_SERVED:
            keep[name] = (card_net, xb)
        else:
            del card_net
        del net
        torch.cuda.empty_cache()
    served = {n: zoo_serve(n, *keep[n], card) for n in ZOO_SERVED}
    if bad or not all(s["ok"] for s in served.values()):
        fail(f"vision (f): {bad} off their bound or not finite; served "
             f"{ {n: s['ok'] for n, s in served.items()} }")
    return dict(rows=rows, served=served)


def zoo_serve(name, net, xb, card, n=8):
    """A zoo net through export_model -> ModelRepository ->
    InferenceServer: `n` single-image requests, each answer within 2e-2
    (relative L2) of the direct forward's row."""
    import shutil

    from mxnet_tpu_torch import gpu, serving
    from mxnet_tpu_torch.contrib import deploy

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        f"chip_smoke_zoo_{name}")
    shutil.rmtree(path, ignore_errors=True)
    with torch.no_grad():
        direct = net(xb[:n]).float()
    deploy.export_model(net, path, [xb[:1]], dynamic_batch=True)
    repo = serving.ModelRepository(ctx=gpu(0))
    repo.add(name, path)
    server = serving.InferenceServer(repo, serving.ServingConfig(
        max_batch_size=8, batch_timeout_ms=20))
    try:
        answers, _, wall, errors = serve(server, name, xb[:n], 4)
    finally:
        server.shutdown(drain=True)
    errs = [rel_l2(a.float().reshape(-1), direct[i]) for i, a in
            enumerate(answers) if a is not None]
    ok = not errors and len(errs) == n and max(errs) < 2e-2
    print(f"vision (f): {name} bf16 served through export_model -> "
          f"ModelRepository -> InferenceServer: {len(errs)}/{n} answered in "
          f"{wall * 1e3:.1f} ms, worst rel L2 to the direct forward "
          f"{max(errs, default=float('nan')):.3g} [{card}]", flush=True)
    shutil.rmtree(path, ignore_errors=True)
    return dict(ok=ok, answered=len(errs), worst=max(errs, default=None))


def cifar_loader(num_workers, seed, **kw):
    from mxnet_tpu_torch.gluon.data import DataLoader
    from mxnet_tpu_torch.gluon.data.vision import CIFAR10
    from mxnet_tpu_torch.gluon.data.vision import transforms as T

    tf = T.Compose([T.RandomFlipLeftRight(), T.ToTensor(),
                    T.Normalize(CIFAR_MEAN, CIFAR_STD)])
    ds = CIFAR10(root=os.path.join("build", "no_cifar"),
                 train=True).transform_first(tf)
    import numpy as np

    np.random.seed(seed)
    return DataLoader(ds, batch_size=CIFAR_BATCH, shuffle=True,
                      last_batch="discard", num_workers=num_workers, **kw)


def vision_cifar(card, dev):
    """(g) resnet18_v2(thumbnail=True, classes=10) on synthetic CIFAR-10
    through DataLoader(num_workers=CIFAR_WORKERS, worker_pool="process")
    with RandomFlipLeftRight -> ToTensor -> Normalize, the hybridized
    gluon.Trainer loop, one epoch: the batches bit for bit those of
    num_workers=0 under the same seed; samples/s, the data-wait share,
    the loss falling."""
    from mxnet_tpu_torch import autograd, gluon, gpu, init
    from mxnet_tpu_torch.gluon.model_zoo import vision

    t0 = time.perf_counter()
    serial = [(x.asnumpy(), y.asnumpy()) for x, y in cifar_loader(0, 21)]
    serial_s = time.perf_counter() - t0
    net = vision.resnet18_v2(thumbnail=True, classes=10)
    net.initialize(init.Xavier(), ctx=gpu(0), seed=4)
    net.hybridize()
    trainer = gluon.Trainer(net.collect_params(), "sgd", dict(CIFAR_OPT))
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    loader = cifar_loader(CIFAR_WORKERS, 21, worker_pool="process")
    losses, same, wait = [], True, 0.0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    it = iter(loader)
    batch = next(it)  # the pool's start (spawned children) and batch 0
    start_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    for i in range(len(loader)):
        if i:
            tw = time.perf_counter()
            batch = next(it)
            wait += time.perf_counter() - tw
        x, y = batch
        same = same and all(
            a.shape == b.shape and (a == b).all()
            for a, b in zip((x.asnumpy(), y.asnumpy()), serial[i]))
        x, y = x.as_in_context(gpu(0)), y.as_in_context(gpu(0))
        with autograd.record():
            loss = loss_fn(net(x), y)
        loss.backward()
        trainer.step(CIFAR_BATCH)
        losses.append(loss.mean())
    losses = [float(v.asscalar()) for v in losses]
    steady = time.perf_counter() - t1
    wall = time.perf_counter() - t0
    n = len(losses) * CIFAR_BATCH
    head, tail = sum(losses[:4]) / 4, sum(losses[-4:]) / 4
    print(f"vision (g): resnet18_v2 thumbnail on synthetic CIFAR-10, one "
          f"epoch ({len(losses)} batches of {CIFAR_BATCH}) through "
          f"DataLoader(num_workers={CIFAR_WORKERS}, worker_pool='process'):"
          f" batches bit-identical to num_workers=0 {same}; the pool's "
          f"start and batch 0 {start_s:.2f} s, then "
          f"{(n - CIFAR_BATCH) / steady:.1f} samples/s with the data wait "
          f"{wait / steady:.1%} of it ({n / wall:.1f} samples/s over the "
          f"whole epoch); loss of the first 4 batches {head:.4f}, of the "
          f"last 4 {tail:.4f}; the serial loader alone {n / serial_s:.1f} "
          f"samples/s [{card}]", flush=True)
    if not same or not tail < head or len(serial) != len(losses):
        fail(f"vision (g): batches equal {same}, loss {head} -> {tail}")
    return dict(same=same, start_s=start_s,
                samples_per_s=(n - CIFAR_BATCH) / steady,
                epoch_samples_per_s=n / wall, wait_share=wait / steady,
                loss_head=head, loss_tail=tail,
                serial_samples_per_s=n / serial_s)


def phase_vision(card, train_res):
    """Phase 17: the vision training path, (a) to (g)."""
    import gc

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(1717)
    t0 = time.perf_counter()
    res, marks = {}, [("start", t0)]
    res["v2"], v2, v2_w0, v2_batch = vision_resnet50_v2(card, dev, gen)
    marks.append(("a", time.perf_counter()))
    set_knobs(True, True)
    v1 = build_net("bfloat16", 0)
    v1_w0 = {k: v.detach().clone() for k, v in v1.state_dict().items()}
    v1_batch = v2_batch
    warm_running_means(v1, v1_batch[0])
    v1_w0 = {k: v.detach().clone() for k, v in v1.state_dict().items()}
    set_knobs(True, True)
    res["remat_v1"] = remat_runs("vision (b): remat on ResNet-50 V1 fused",
                                 v1, v1_w0, v1_batch, card,
                                 {"k1": FWD_PER_STEP, "k2": BWD_PER_STEP})
    res["remat_v2"] = remat_runs("vision (b): remat on resnet50_v2", v2,
                                 v2_w0, v2_batch, card, {})
    marks.append(("b", time.perf_counter()))
    res["checkpoint"] = vision_checkpoint(v2, v2_w0, v2_batch, card)
    marks.append(("c", time.perf_counter()))
    del v2
    gc.collect()
    torch.cuda.empty_cache()
    res["mp"] = vision_multi_precision(card, v1, v1_w0, v1_batch, train_res)
    marks.append(("e", time.perf_counter()))
    del v1, v1_batch, v2_batch
    gc.collect()
    torch.cuda.empty_cache()
    res["zero"] = vision_zero(card)
    marks.append(("d", time.perf_counter()))
    res["zoo"] = vision_zoo(card, dev, gen)
    marks.append(("f", time.perf_counter()))
    gc.collect()
    torch.cuda.empty_cache()
    res["cifar"] = vision_cifar(card, dev)
    marks.append(("g", time.perf_counter()))
    set_knobs(True, True)
    res["seconds"] = time.perf_counter() - t0
    print(f"vision: phase 17 took {res['seconds']:.1f} s ("
          + ", ".join(f"({b[0]}) {b[1] - a[1]:.1f} s"
                      for a, b in zip(marks, marks[1:])) + ")", flush=True)
    return res


# ---------------------------------------------------------------------------
# phase 18: the image data path (im2rec, RecordIO, the native decode
# pipeline, ImageRecordIter) into ResNet-50 v1 training, the decode rate,
# SSD on a packed detection .rec, the image ops on the card
# ---------------------------------------------------------------------------

IMAGE_DIR = os.path.join("build", "chip_smoke_imagenet")
IMAGENET_CLASSES, IMAGENET_PER_CLASS = 1000, 3   # 3000 images, 256² q90
IMAGENET_HW, IMAGENET_BATCH, IMAGENET_EPOCHS = 224, 256, 2
IMAGENET_LR = 0.1
DECODE_IMAGES, DECODE_BATCH = 512, 64   # the decode-rate shard
DET_IMAGES, DET_BATCH = 64, 8
IMAGE_OPS_CALLS = 512    # (d): calls of a random image op on the card


def _phase18_part(tag, fn, *args):
    """Run one part of phase 18; an exception fails the run with its
    traceback and the phase goes on to its next part."""
    import traceback

    try:
        return fn(*args)
    except Exception as e:  # noqa: BLE001 — reported, the run fails
        traceback.print_exc()
        fail(f"imagenet ({tag}): {type(e).__name__}: {e}")
        return None


def image_machine():
    """The card machine's OpenCV and cores, as the native build sees
    them, and the image library's build."""
    import cv2

    from mxnet_tpu_torch import lib

    inc = "/usr/include/opencv4"
    heads = sorted(os.listdir(inc)) if os.path.isdir(inc) else None
    try:
        ldc = subprocess.run(["ldconfig", "-p"], capture_output=True,
                             text=True, timeout=60).stdout
    except OSError as e:
        ldc = f"ldconfig: {e}"
    libs = sorted({ln.split()[0] for ln in ldc.splitlines()
                   if any(f"opencv_{m}." in ln
                          for m in ("core", "imgproc", "imgcodecs"))})
    t0 = time.perf_counter()
    ok = lib.available() and lib.image_available()
    print(f"imagenet: machine: {os.cpu_count()} cores, cv2 "
          f"{cv2.__version__}, {inc}: "
          f"{heads if heads is not None else 'absent'}, ldconfig's OpenCV "
          f"libraries: {libs or 'none'}; native libraries built and "
          f"loaded in {time.perf_counter() - t0:.2f} s: core "
          f"{lib.native_error() or 'ok'}, image "
          f"{(lib.image_error() or 'ok').splitlines()[0]}", flush=True)
    if not ok:
        print(f"imagenet: the image library's build:\n{lib.image_error()}",
              flush=True)
    return dict(cores=os.cpu_count(), cv2=cv2.__version__,
                opencv_headers=heads is not None, opencv_libs=libs,
                image_library=lib.image_available())


def imagenet_shards(card):
    """The example's synthetic tree at full width (1000 classes x 3
    JPEGs of 256², quality 90, from seed 0) packed by the port's im2rec
    (a shuffled list, the short edge resized to 240, every core)."""
    import shutil

    from mxnet_tpu_torch.examples import imagenet_train as ex

    shutil.rmtree(IMAGE_DIR, ignore_errors=True)
    root = os.path.join(IMAGE_DIR, "train")
    t0 = time.perf_counter()
    ex.make_synthetic_imagenet(root, IMAGENET_CLASSES, IMAGENET_PER_CLASS,
                               IMAGENET_HW + 32)
    t1 = time.perf_counter()
    prefix = os.path.join(IMAGE_DIR, "imagenet")
    ex.pack_with_im2rec(prefix, root, IMAGENET_HW + 16, os.cpu_count() or 1)
    t2 = time.perf_counter()
    n = len(open(prefix + ".idx").read().splitlines())
    print(f"imagenet (a): tree of {IMAGENET_CLASSES} x {IMAGENET_PER_CLASS} "
          f"JPEGs in {t1 - t0:.2f} s; im2rec packed {n} records "
          f"({os.path.getsize(prefix + '.rec') / 2 ** 20:.1f} MiB) on "
          f"{os.cpu_count()} threads in {t2 - t1:.2f} s", flush=True)
    if n != IMAGENET_CLASSES * IMAGENET_PER_CLASS:
        fail(f"imagenet (a): im2rec packed {n} records")
    return prefix


def imagenet_training(card, prefix, train_res):
    """examples/imagenet_train.py at full width: ResNet-50 v1 (1000
    classes, bf16, NHWC, fused, captured) through SPMDTrainer (SGD lr
    0.1, momentum 0.9, wd 1e-4) fed by ImageRecordIter (batch 256, 224²
    crops of the short edge resized to 232, random mirror, shuffled
    through the .idx), 2 epochs of 12 steps, counters reset just before
    and read just after."""
    import numpy as np

    from mxnet_tpu_torch import lib
    from mxnet_tpu_torch.examples import imagenet_train as ex
    from mxnet_tpu_torch.ops import fused_convbn as fcb

    set_knobs(True, True)
    keep = {}
    torch.cuda.synchronize()
    fcb.reset_launch_count()
    fcb.reset_bwd_launch_count()
    epochs = ex.main(
        ["--rec-prefix", prefix, "--classes", str(IMAGENET_CLASSES),
         "--image-size", str(IMAGENET_HW), "--batch-size",
         str(IMAGENET_BATCH), "--epochs", str(IMAGENET_EPOCHS), "--lr",
         str(IMAGENET_LR), "--dtype", "bfloat16", "--preprocess-threads",
         str(os.cpu_count() or 1)], keep=keep)
    torch.cuda.synchronize()
    fwd, bwd = fcb.launch_count(), fcb.bwd_launch_count()
    it = keep["iter"]
    steps = sum(e["steps"] for e in epochs)
    print(f"imagenet (a): route {it.route}"
          + (f" ({it.route_reason})" if it.route_reason else "")
          + f"; {steps} steps, launches fwd {fwd} bwd {bwd} "
          f"({FWD_PER_STEP} + {BWD_PER_STEP} a step expected)", flush=True)
    if lib.image_available() and it.route != "native_pipeline":
        fail(f"imagenet (a): the image library loads but the route is "
             f"{it.route}")
    if (fwd, bwd) != (FWD_PER_STEP * steps, BWD_PER_STEP * steps):
        fail(f"imagenet (a): {fwd} / {bwd} launches in {steps} steps")
    n_batches = -(-IMAGENET_CLASSES * IMAGENET_PER_CLASS // IMAGENET_BATCH)
    if [e["steps"] for e in epochs] != [n_batches] * IMAGENET_EPOCHS:
        fail(f"imagenet (a): steps an epoch {[e['steps'] for e in epochs]}")
    means = [float(np.mean(e["losses"])) for e in epochs]
    if not all(np.isfinite(e["losses"]).all() for e in epochs) \
            or not means[-1] < means[0]:
        fail(f"imagenet (a): epoch mean losses {means}")
    if np.array_equal(epochs[0]["labels"], epochs[1]["labels"]):
        fail("imagenet (a): the second epoch came in the first's order")
    step5 = train_res.get("compiled", {}).get("fused", {}).get(
        "captured_ms")
    res = dict(route=it.route, route_reason=it.route_reason,
               launches={"fwd": fwd, "bwd": bwd}, steps=steps,
               loss_means=means, epochs=[])
    for i, e in enumerate(epochs):
        copy = sorted(e["copy_ms"])
        rec = dict(images_per_s=e["images"] / e["seconds"],
                   ms_per_step=e["seconds"] / e["steps"] * 1e3,
                   wait_share=e["wait_s"] / e["seconds"],
                   copy_ms_median=copy[len(copy) // 2],
                   copy_ms_max=copy[-1])
        res["epochs"].append(rec)
        print(f"imagenet (a): epoch {i}: {e['images']} images in "
              f"{e['seconds']:.2f} s, {rec['images_per_s']:.1f} images/s end "
              f"to end, {rec['ms_per_step']:.1f} ms a step (phase 5's "
              f"captured step on a fixed batch: "
              f"{'not measured' if step5 is None else f'{step5:.1f} ms'}), "
              f"data wait {rec['wait_share']:.1%} (host clock inside "
              f"next()), host-to-card copy with the permute and bf16 cast "
              f"{rec['copy_ms_median']:.2f} ms a batch median, "
              f"{rec['copy_ms_max']:.2f} max (CUDA events), mean loss "
              f"{means[i]:.4f} [{card}]", flush=True)
    del keep
    return res


def imagenet_decode_check(card, prefix):
    """One batch from ImageRecordIter (centre crops, no resize, no
    mirror) against the Python route's decode of the same 16 records on
    the host: bit for bit."""
    import numpy as np

    from mxnet_tpu_torch import recordio
    from mxnet_tpu_torch.examples import imagenet_train as ex
    from mxnet_tpu_torch.io import ImageRecordIter

    n = 16
    it = ImageRecordIter(
        path_imgrec=prefix + ".rec", data_shape=(3, IMAGENET_HW,
                                                 IMAGENET_HW),
        batch_size=n, mean_r=ex.MEAN[0], mean_g=ex.MEAN[1],
        mean_b=ex.MEAN[2], std_r=ex.STD[0], std_g=ex.STD[1],
        std_b=ex.STD[2], preprocess_threads=os.cpu_count() or 1)
    batch = it.next()
    data, labels = batch.data[0].asnumpy(), batch.label[0].asnumpy()
    r = recordio.MXRecordIO(prefix + ".rec", "r")
    same = 0
    for i in range(n):
        img, lab = it.decode_record(r.read())
        same += int(np.array_equal(data[i], img) and labels[i] == lab[0])
    r.close()
    print(f"imagenet (a): {same} of {n} images from the {it.route} route "
          f"bit for bit the Python route's host decode of the same "
          f"records [{card}]", flush=True)
    if same != n:
        fail(f"imagenet (a): {n - same} of {n} decoded images differ")
    return same == n


def imagenet_decode_rate(card, prefix):
    """tools/bench_pipeline.py's measurement on the first 512 records of
    the shard: images/s of one epoch at batch 64 (224² random crops of
    the short edge resized to 232, random mirror) through the native
    pipeline (where it built) and the Python route at 1, 2, 4, ...
    threads up to the cores."""
    from mxnet_tpu_torch import lib, recordio
    from mxnet_tpu_torch.tools import bench_pipeline as bp

    src = recordio.MXIndexedRecordIO(prefix + ".idx", prefix + ".rec", "r")
    sub = os.path.join(IMAGE_DIR, "decode")
    dst = recordio.MXIndexedRecordIO(sub + ".idx", sub + ".rec", "w")
    for k in src.keys[:DECODE_IMAGES]:
        dst.write_idx(k, src.read_idx(k))
    src.close()
    dst.close()
    cores = os.cpu_count() or 1
    threads = sorted({min(2 ** i, cores) for i in range(8)} | {cores})
    native = lib.image_available()
    rates = bp.measure(sub + ".rec", sub + ".idx", DECODE_BATCH,
                       IMAGENET_HW, threads, True, native=native,
                       resize=IMAGENET_HW + 8)
    print("imagenet (b): decode + augment images/s over "
          f"{DECODE_IMAGES} records by route and threads: "
          + ", ".join(f"{k} {v:.1f}" for k, v in rates.items())
          + ("" if native else "; the native pipeline did not build")
          + f" ({cores} cores) [{card}]", flush=True)
    return rates


def imagenet_detection(card):
    """examples/ssd_train.py --rec at its defaults (SSD-300 ResNet-50,
    batch 8) on a .rec of 64 synthetic JPEGs with 1-3 boxes each, packed
    by im2rec --pack-label: one epoch (8 steps), finite losses, each
    batch's boxes those of its records (or mirrored)."""
    import cv2
    import numpy as np

    from mxnet_tpu_torch import recordio
    from mxnet_tpu_torch.examples import ssd_train
    from mxnet_tpu_torch.tools import im2rec

    root = os.path.join(IMAGE_DIR, "det")
    os.makedirs(root, exist_ok=True)
    rs = np.random.RandomState(18)
    rows = []
    for i in range(DET_IMAGES):
        img = rs.randint(0, 255, (288 + 16 * (i % 5), 320, 3), np.uint8)
        cv2.imwrite(os.path.join(root, f"{i}.jpg"),
                    cv2.GaussianBlur(img, (5, 5), 2),
                    [cv2.IMWRITE_JPEG_QUALITY, 90])
        k = 1 + i % 3
        xy = rs.uniform(0.05, 0.5, (k, 2))
        objs = np.concatenate([rs.randint(0, 20, (k, 1)), xy,
                               xy + rs.uniform(0.1, 0.45, (k, 2))], 1)
        label = "\t".join(f"{v:.4f}" for v in [2, 5] + list(objs.ravel()))
        rows.append(f"{i}\t{label}\t{i}.jpg\n")
    prefix = os.path.join(IMAGE_DIR, "det")
    with open(prefix + ".lst", "w") as f:
        f.writelines(rows)
    if im2rec.main([prefix, root, "--pack-label", "--num-thread",
                    str(os.cpu_count() or 1)]) != 0:
        fail("imagenet (c): im2rec --pack-label failed")
        return None
    keep = {}
    t0 = time.perf_counter()
    losses = ssd_train.main(["--rec", prefix + ".rec", "--batch-size",
                             str(DET_BATCH)], keep=keep)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    r = recordio.MXIndexedRecordIO(prefix + ".idx", prefix + ".rec", "r")
    bad = 0
    for b, got in enumerate(keep["rec_labels"]):
        for row in range(DET_BATCH):
            h, _ = recordio.unpack(r.read_idx(b * DET_BATCH + row))
            objs = np.asarray(h.label[2:], np.float32).reshape(-1, 5)
            mirror = objs.copy()
            mirror[:, 1], mirror[:, 3] = 1 - objs[:, 3], 1 - objs[:, 1]
            k = objs.shape[0]
            ok = (np.array_equal(got[row, :k], objs)
                  or np.allclose(got[row, :k], mirror, atol=1e-6)) \
                and (got[row, k:] == -1).all()
            bad += int(not ok)
    r.close()
    n_steps = DET_IMAGES // DET_BATCH
    print(f"imagenet (c): ssd_train --rec: {len(losses)} steps in {dt:.2f} "
          f"s (the first builds the hybridized net), losses "
          f"{' '.join(f'{v:.4f}' for v in losses)}; images whose boxes are "
          f"not their records' {bad} of {DET_IMAGES} [{card}]", flush=True)
    if len(losses) != n_steps or not np.isfinite(losses).all() or bad:
        fail(f"imagenet (c): {len(losses)} steps, losses {losses}, {bad} "
             "images with other boxes")
    return dict(steps=len(losses), losses=losses, seconds=dt, bad=bad)


def image_ops_card(card):
    """(d) the image ops on the card: brightness, contrast and
    saturation at fixed factors against the CPU on a batch of 64 uint8
    224² images (one uint8 step) and its float32 copy (2^-24 * 4 * S, S
    the magnitudes of the blend's terms); contrast at the card's mean
    luminance, which holds within 1e-5 of float64's; the random flips'
    coins (share 0.5) and the random factors' mean (1.0) over 512 calls
    on the card's generator."""
    import numpy as np

    from mxnet_tpu_torch import gpu, nd
    from mxnet_tpu_torch.ops import image_ops
    from mxnet_tpu_torch.tools import op_sweep

    gen = torch.Generator().manual_seed(1818)
    x8 = torch.randint(0, 256, (64, 224, 224, 3), generator=gen,
                       dtype=torch.uint8)
    dev = torch.device("cuda", 0)
    worst = {"uint8_steps": 0, "float32_of_bound": 0.0, "gray_rel": 0.0}
    coef = torch.tensor([0.299, 0.587, 0.114])
    gray64 = float(torch.tensordot(x8.double(), coef.double(),
                                   dims=([-1], [0])).mean())
    for kind in ("brightness", "contrast", "saturation"):
        for f in (0.7, 1.3):
            ft = torch.tensor(f)
            for x in (x8, x8.float()):
                xd = x.to(dev)
                got = getattr(image_ops, kind)(xd, ft.to(dev)).cpu()
                if kind == "contrast":
                    # the mean over 3.2 M pixels sums in another order on
                    # the card: hold the blend at the card's mean, and
                    # the mean against float64
                    gray = torch.tensordot(xd.float(), coef.to(dev),
                                           dims=([-1], [0])).mean().cpu()
                    worst["gray_rel"] = max(worst["gray_rel"], abs(
                        float(gray) - gray64) / gray64)
                    want = image_ops._cast_to(
                        gray * (1.0 - ft) + x.float() * ft, x.dtype)
                else:
                    want = getattr(image_ops, kind)(x, ft)
                if x.dtype == torch.uint8:
                    d = int((got.int() - want.int()).abs().max())
                    worst["uint8_steps"] = max(worst["uint8_steps"], d)
                else:
                    # a blend of gray (a sum of 3 products, or their mean)
                    # and x: 2^-24 * 4 * S, S the terms' magnitudes
                    terms = (255.0 * abs(1.0 - f) + x.abs() * f).numpy()
                    err = (got.double() - want.double()).abs().numpy()
                    bound = op_sweep.sum_bound(want.numpy(), 4, terms)
                    worst["float32_of_bound"] = max(
                        worst["float32_of_bound"], float((err / bound).max()))
    one = nd.ones((1, 1, 2, 1), ctx=gpu(0))
    ramp = nd.array(np.arange(2, dtype=np.float32).reshape(1, 1, 2, 1),
                    ctx=gpu(0))
    flips = sum(int(nd.image.random_flip_left_right(ramp).asnumpy()[
        0, 0, 0, 0] == 1.0) for _ in range(IMAGE_OPS_CALLS))
    factors = np.array([float(nd.image.random_brightness(one).asnumpy()[
        0, 0, 0, 0]) for _ in range(IMAGE_OPS_CALLS)])
    n = IMAGE_OPS_CALLS
    share = flips / n
    ok_draws = (abs(share - 0.5) < 4 * math.sqrt(0.25 / n)
                and factors.min() >= 0.5 and factors.max() < 1.5
                and abs(factors.mean() - 1.0) < 4 / math.sqrt(12 * n))
    print(f"imagenet (d): image ops on the card against the CPU at fixed "
          f"factors: uint8 within {worst['uint8_steps']} step(s), float32 "
          f"within {worst['float32_of_bound']:.3f} of 2^-24*4*S (contrast "
          f"at the card's mean luminance, {worst['gray_rel']:.2e} relative "
          f"from float64's); over {n} calls on the card's generator the "
          f"flip share {share:.3f}, brightness "
          f"factors in [{factors.min():.3f}, {factors.max():.3f}] with mean "
          f"{factors.mean():.4f} [{card}]", flush=True)
    if worst["uint8_steps"] > 1 or worst["float32_of_bound"] > 1.0 \
            or worst["gray_rel"] > 1e-5 or not ok_draws:
        fail(f"imagenet (d): image ops {worst}, flip share {share}, "
             f"factors {factors.min()}..{factors.max()}")
    return dict(worst, flip_share=share, factor_mean=float(factors.mean()))


def phase_imagenet(card, train_res):
    """Phase 18: the image data path, (a) to (d)."""
    import gc
    import shutil

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    marks = [("start", t0)]
    res = {"launches": {"fwd": 0, "bwd": 0}}
    res["machine"] = _phase18_part("machine", image_machine)
    prefix = _phase18_part("a", imagenet_shards, card)
    marks.append(("shards", time.perf_counter()))
    if prefix is not None:
        train = _phase18_part("a", imagenet_training, card, prefix,
                              train_res)
        if train is not None:
            res.update(train)
        marks.append(("train", time.perf_counter()))
        res["decode_check"] = _phase18_part("a", imagenet_decode_check,
                                            card, prefix)
        res["decode_rate"] = _phase18_part("b", imagenet_decode_rate, card,
                                           prefix)
        marks.append(("decode", time.perf_counter()))
    gc.collect()
    torch.cuda.empty_cache()
    res["detection"] = _phase18_part("c", imagenet_detection, card)
    marks.append(("detection", time.perf_counter()))
    res["image_ops"] = _phase18_part("d", image_ops_card, card)
    marks.append(("ops", time.perf_counter()))
    shutil.rmtree(IMAGE_DIR, ignore_errors=True)
    set_knobs(True, True)
    res["seconds"] = time.perf_counter() - t0
    print(f"imagenet: phase 18 took {res['seconds']:.1f} s ("
          + ", ".join(f"{b[0]} {b[1] - a[1]:.1f} s"
                      for a, b in zip(marks, marks[1:])) + ")", flush=True)
    return res


# ---------------------------------------------------------------------------
# phase 19: int8 quantization and the contrib vision ops
# ---------------------------------------------------------------------------

PEAK_INT8 = 1979e12    # dense int8 tensor-core op/s, H100 SXM
KERNEL_INT8 = {"name": "int8_conv", "route": "cuda",
               "source": "mxnet_tpu_torch/csrc/int8_conv.cu",
               "replaces": "mxnet_tpu/ops/quantization.py:136 and :165 "
                           "(lax at int32; no TPU kernel)"}
KERNEL_NMS = {"name": "greedy_nms", "route": "cuda",
              "source": "mxnet_tpu_torch/csrc/nms.cu",
              "replaces": "mxnet_tpu/ops/contrib.py:215 (lax.fori_loop; "
                          "no TPU kernel)"}
Q_BATCH = 64
Q_CALIB_BATCHES = 1      # 2 before phase 21 (the script's time)
Q_FORWARDS = 3           # (c): captured int8 forwards of the counted run
Q_CPU_ROWS = 8           # (c): eval images the CPU's quantized graph runs
# (c): the card's int8 forward against the same graph and parameters on
# the CPU, node by node: each op of the quantized graph run on the CPU from
# the card's values of its inputs; integer outputs at most Q_NODE_STEPS
# apart (a product at a rounding half may round the other way), float
# outputs within Q_NODE_TOL of the CPU output's largest magnitude
Q_NODE_STEPS = 1
Q_NODE_TOL = 1e-5
# and end to end: the card's logits within this share of the CPU logits'
# largest magnitude.  Flips at rounding halves grow through the layers
# (high-gain BatchNorm channels of a net trained on random labels):
# measured 0 on a ResNet-50 trained 2 epochs of 4 batches, 0.0119 on
# phase 11's (1699419 of 81100800 int8 activations apart, up to 28 steps)
Q_CPU_TOL = 0.05
Q_ENTROPY_LIMIT_S = 60.0
# (c): calibration, card against cpu, relative to each tensor's largest
# magnitude: naive's ranges (min/max) and entropy's samples (the
# histogram's input) differ in the last bits of the activations.
# Entropy's ranges are not bounded: its KL curve can be flat over many
# histogram bins, so last-bit changes move the minimum (0.0792 relative
# apart on one run of phase 11's net, 1.33e-6 on another)
Q_RANGE_REL = 1e-5
NMS_FLOPS_PER_PAIR = 14  # the IoU and its comparison, fp32
PEAK_FP64 = 34e12        # fp64 FLOP/s outside the tensor cores, H100 SXM
# the detection's ms on this card when greedy NMS was the Python loop
# (PERF.md section 5), printed beside the kernel's
LOOP_DETECTION_MS = {100: "9.37-10.82", -1: "1156.6-1670.8"}
RCNN_MAP = (2, 38, 63)   # batch, feature map of a 600 x 1000 image at /16
RCNN_CHECKED = 16        # rois a image held against the CPU in (e)
RCNN_TOL = 1e-5          # (e): of the CPU's largest magnitude
INT8_RAGGED = [
    # name, x (NCHW unless nhwc), w, stride, pad, dilate, groups, nhwc
    ("ci3.7x7s2.n8", (8, 3, 224, 224), (64, 3, 7, 7), (2, 2), (3, 3),
     (1, 1), 1, False),
    ("groups32", (8, 256, 28, 28), (256, 8, 3, 3), (1, 1), (1, 1), (1, 1),
     32, False),
    ("depthwise", (8, 64, 56, 56), (64, 1, 3, 3), (1, 1), (1, 1), (1, 1),
     64, False),
    ("dilate2", (8, 256, 28, 28), (256, 256, 3, 3), (1, 1), (2, 2),
     (2, 2), 1, False),
    ("nhwc.3x3", (8, 28, 28, 128), (128, 128, 3, 3), (1, 1), (1, 1),
     (1, 1), 1, True),
    ("ragged.co70.s2x1", (3, 40, 9, 11), (70, 40, 3, 3), (2, 1), (1, 0),
     (1, 1), 1, False)]


def resnet50_conv_layers(batch):
    """The distinct convolution layers of `resnet50_v1_sym` at `batch` and
    224x224 (53 layers in all): (input shape, weight shape, stride, pad,
    count)."""
    from mxnet_tpu_torch import sym

    net = resnet50_v1_sym(sym)
    inner = net.get_internals()
    shapes = dict(zip(inner.list_outputs(), inner.infer_shape_partial(
        data=(batch, 3, 224, 224))[1]))
    layers = {}
    for node in net._topo():
        if node.op != "Convolution":
            continue
        src, idx = node.inputs[0]
        xs = (batch, 3, 224, 224) if src.op is None else shapes[
            f"{src.name}_output" if src.num_outputs == 1
            else f"{src.name}_output{idx}"]
        a = node.attrs
        key = (tuple(xs), (a["num_filter"], xs[1]) + tuple(a["kernel"]),
               tuple(a.get("stride", (1, 1))), tuple(a.get("pad", (0, 0))))
        layers[key] = layers.get(key, 0) + 1
    return [k + (n,) for k, n in layers.items()]


def _rand_i8(gen, shape, dev):
    return torch.randint(-127, 128, shape, device=dev, generator=gen,
                         dtype=torch.int32).to(torch.int8)


def int8_case(name, xs, ws, stride, pad, dilate, groups, nhwc, gen, dev,
              count=0, timed=True):
    """The int8 kernel against its plain version (float64 on the card,
    cast to int32) bit for bit, and two launches against each other;
    timed: kernel_ms (the launch alone, CUDA-graph replays), op_ms (the
    whole wrapper call), ref_ms, bound_ms."""
    from mxnet_tpu_torch.ops import quantized_conv as qc

    x, w = _rand_i8(gen, xs, dev), _rand_i8(gen, ws, dev)
    args = (stride, pad, dilate, groups, nhwc)
    y = qc.int8_conv(x, w, *args)
    y2 = qc.int8_conv(x, w, *args)
    ref = qc.int8_conv_ref(x, w, *args)
    torch.cuda.synchronize()
    same, det = torch.equal(y, ref), torch.equal(y, y2)
    rec = dict(name=name, path="quantized_resnet50" if count else "check",
               shape=list(xs), weight=list(ws), count=count, identical=same,
               deterministic=det,
               max_abs_err=float((y.double() - ref.double()).abs().max()))
    if not (same and det):
        fail(f"int8 {name}: identical to the plain version {same}, two "
             f"launches identical {det}")
    if timed:
        xh = x.contiguous() if nhwc else x.permute(0, 2, 3, 1).contiguous()
        wl, kpad = qc.weight_layout(w, groups)
        yk = torch.empty_like(y)
        kern = tuple(ws[2:])
        rec["kernel_ms"] = graph_ms(lambda: qc.launch(
            xh, wl, kpad, yk, nhwc, kern, stride, pad, dilate, groups))
        rec["op_ms"] = time_ms(lambda: qc.int8_conv(x, w, *args), iters=5)
        rec["ref_ms"] = time_ms(lambda: qc.int8_conv_ref(x, w, *args),
                                iters=2, warmup=1)
        k = math.prod(ws[1:])
        ops = 2.0 * y.numel() * k
        nbytes = x.numel() + w.numel() + 4 * y.numel()
        t_ops, t_bytes = ops / PEAK_INT8, nbytes / PEAK_BYTES
        rec.update(bound_ms=max(t_ops, t_bytes) * 1e3,
                   bound_by="operations" if t_ops >= t_bytes else "bytes",
                   library_ms=None)
    return rec


def quant_kernel_checks(card, dev):
    """(a): every distinct convolution of the symbolic ResNet-50 at batch
    64 and its FC, then the ragged cases."""
    from mxnet_tpu_torch.ops import quantized_conv as qc

    gen = torch.Generator(device=dev)
    gen.manual_seed(19)
    recs = []
    for xs, ws, st, pd, n in resnet50_conv_layers(Q_BATCH):
        name = f"{ws[2]}x{ws[3]}/{st[0]} {xs[1]}->{ws[0]} at {xs[2]}"
        recs.append(int8_case(name, xs, ws, st, pd, (1, 1), 1, False, gen,
                              dev, count=n))
    # the FC: a 1x1 convolution over a 1x1 image, as quantized_fully_
    # connected runs it; its library call is torch._int_mm
    fc = int8_case("fc 2048->1000", (Q_BATCH, 1, 1, 2048),
                   (1000, 2048, 1, 1), (1, 1), (0, 0), (1, 1), 1, True, gen,
                   dev, count=1)
    x = _rand_i8(gen, (Q_BATCH, 2048), dev)
    w = _rand_i8(gen, (1000, 2048), dev)
    mine = qc.int8_conv(x.reshape(Q_BATCH, 1, 1, 2048),
                        w.reshape(1000, 2048, 1, 1), channels_last=True)
    lib = torch._int_mm(x, w.t())
    fc["library_ms"] = graph_ms(lambda: torch._int_mm(x, w.t()))
    fc["library_identical"] = torch.equal(mine.reshape(Q_BATCH, 1000), lib)
    if not fc["library_identical"]:
        fail("int8 fc: the kernel and torch._int_mm differ")
    fc["path"] = "quantized_resnet50_fc"
    recs.append(fc)
    for case in INT8_RAGGED:
        recs.append(int8_case(*case, gen, dev, timed=False))
    for r in recs:
        t = (f"kernel {r['kernel_ms']:.4f} ms, op {r['op_ms']:.4f}, plain "
             f"{r['ref_ms']:.3f}, bound {r['bound_ms']:.4f} "
             f"({r['bound_by']})"
             + (f", library {r['library_ms']:.4f} (torch._int_mm)"
                if r.get("library_ms") else "")
             if "kernel_ms" in r else "checked")
        print(f"int8 {r['name']} x{r['count']} {r['shape']}: identical "
              f"{r['identical']}, deterministic {r['deterministic']}; {t} "
              f"[{card}]", flush=True)
    main = [r for r in recs if r["count"]]
    n_layers = sum(r["count"] for r in main if r["path"] ==
                   "quantized_resnet50")
    if n_layers != 53:
        fail(f"int8: {n_layers} convolution layers (want 53)")
    return recs


def nms_hold(tag, boxes, scores, ids, thr, force, off, card):
    """The kernel's keep mask against the plain loop on the card and on
    the CPU, identical; its launch step's ms (graph replays), the plain
    loop's ms on the card, the bound."""
    from mxnet_tpu_torch.ops import contrib

    got = contrib.greedy_nms_keep(boxes, scores, ids, thr, force, off)
    t0 = time.perf_counter()
    plain = contrib.greedy_nms_keep_ref(boxes, scores, ids, thr, force,
                                        off)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    cpu = contrib.greedy_nms_keep_ref(
        boxes.cpu(), scores.cpu(), None if ids is None else ids.cpu(), thr,
        force, off)
    same = torch.equal(got, plain) and torch.equal(got.cpu(), cpu)
    kernel_ms = graph_ms(lambda: contrib._nms_launch(
        boxes, scores, ids, thr, force, off), launches=5)
    b, k = scores.shape
    valid = (scores > 0).to(torch.float64)
    pairs = float((valid * (k - 1 - torch.arange(
        k, device=scores.device, dtype=torch.float64))).sum())
    nbytes = b * k * (5 * boxes.element_size() + 1 + (
        0 if force else ids.element_size()))
    t_ops = pairs * NMS_FLOPS_PER_PAIR / (
        PEAK_FP64 if boxes.dtype == torch.float64 else PEAK_FP32)
    t_bytes = nbytes / PEAK_BYTES
    rec = dict(name=tag, batch=b, K=k, kept=int(got.sum()), identical=same,
               kernel_ms=kernel_ms, ref_ms=plain_ms,
               bound_ms=max(t_ops, t_bytes) * 1e3,
               bound_by="operations" if t_ops >= t_bytes else "bytes",
               library_ms=None, max_abs_err=0.0 if same else 1.0)
    print(f"nms {tag} (batch {b}, K {k}, force {force}, off {off}): keep "
          f"masks of the kernel, the plain loop on the card and on the cpu "
          f"identical {same}, {rec['kept']} kept; kernel {kernel_ms:.4f} ms "
          f"(bound {rec['bound_ms']:.4f}, {rec['bound_by']}), the plain "
          f"loop on the card {plain_ms:.1f} ms [{card}]", flush=True)
    if not same:
        fail(f"nms {tag}: the keep masks differ")
    return rec


def quant_nms(card, dev):
    """(b): SSD's detection (phase 10's inputs) at nms_topk 100 and -1,
    then Proposal's 6000 candidates with force_suppress and off = 1."""
    from mxnet_tpu_torch import ops
    from mxnet_tpu_torch.ops import contrib

    prob, loc, anchors = (t.to(dev) for t in KEEP["ssd_detection"])
    thr = contrib._f32(0.5)
    recs = {}
    for k in SSD_NMS_TOPK:
        run = lambda: ops.MultiBoxDetection(prob, loc, anchors, nms_topk=k)
        run()
        torch.cuda.synchronize()
        contrib.reset_nms_loop_runs()
        contrib.reset_nms_launch_count()
        out = run()
        torch.cuda.synchronize()
        loops, launches = contrib.nms_loop_runs(), contrib.nms_launch_count()
        ms = time_ms(run, iters=5, warmup=1)
        sb, ss, si = contrib.decode_sorted(prob, loc, anchors)
        n = sb.shape[1]
        cap = min(k, n) if k > 0 else n
        rec = nms_hold(f"ssd_topk{k}", *(t[:, :cap].contiguous()
                                          for t in (sb, ss, si)), thr,
                       False, 0.0, card)
        rec.update(detection_ms=ms, share=rec["kernel_ms"] / ms,
                   launches=launches, loop_runs_cuda=loops.get("cuda", 0))
        print(f"nms ssd detection nms_topk={k}: {ms:.3f} ms for batch "
              f"{prob.shape[0]} (with the Python loop: "
              f"{LOOP_DETECTION_MS[k]} ms), the kernel {rec['share']:.1%} "
              f"of it; {launches} kernel launch(es) and "
              f"{loops.get('cuda', 0)} runs of the Python loop on CUDA "
              f"tensors in one detection (phase 10 (d) holds the "
              f"detection against the cpu op) [{card}]", flush=True)
        if loops.get("cuda", 0) or launches != 1 or not bool(
                torch.isfinite(out).all()):
            fail(f"nms ssd nms_topk={k}: loop runs {loops}, launches "
                 f"{launches}")
        recs[k] = rec
    return recs


# (b): the kernel in its other element types, each against the plain loop
# on the card and on the cpu: (dtype, K, force, off); K 300 takes the
# loop's matrix branch, 1100 its row branch
NMS_DTYPE_CASES = [(dt, k, force, off)
                   for dt in (torch.float16, torch.bfloat16, torch.float64)
                   for k, force, off in ((300, False, 0.0),
                                         (1100, True, 1.0))]


def quant_nms_dtypes(card, dev):
    """(b): float16, bfloat16 and float64 candidates (pixel boxes whose
    coarse types give many equal IoUs, tied scores, zeros, 3 classes), and
    SSD's detection in float16 (its float32 class ids beside float16
    boxes)."""
    from mxnet_tpu_torch import ops
    from mxnet_tpu_torch.ops import contrib

    gen = torch.Generator().manual_seed(22)
    recs = {}
    for dt, k, force, off in NMS_DTYPE_CASES:
        xy = torch.rand(2, k, 2, generator=gen) * 30
        boxes = torch.cat(
            [xy, xy + 5 + torch.rand(2, k, 2, generator=gen) * 20], -1)
        scores = (torch.rand(2, k, generator=gen) * 6).round() / 6
        scores = scores.sort(dim=1, descending=True, stable=True)[0]
        ids = torch.randint(0, 3, (2, k), generator=gen).float()
        tag = f"{str(dt).split('.')[-1]}_K{k}"
        recs[tag] = nms_hold(tag, boxes.to(dev, dt), scores.to(dev, dt),
                             None if force else ids.to(dev, dt),
                             contrib._f32(0.4), force, off, card)
    prob, loc, anchors = (t.to(dev, torch.float16)
                          for t in KEEP.pop("ssd_detection"))
    contrib.reset_nms_loop_runs()
    contrib.reset_nms_launch_count()
    out = ops.MultiBoxDetection(prob, loc, anchors, nms_topk=100)
    torch.cuda.synchronize()
    launches, loops = contrib.nms_launch_count(), contrib.nms_loop_runs()
    sb, ss, si = contrib.decode_sorted(prob, loc, anchors)
    recs["ssd_float16"] = nms_hold(
        "ssd_topk100_float16", *(t[:, :100].contiguous() for t in (sb, ss, si)),
        contrib._f32(0.5), False, 0.0, card)
    print(f"nms ssd detection in float16 (ids {si.dtype}): {launches} kernel "
          f"launch(es), {loops.get('cuda', 0)} runs of the Python loop on "
          f"CUDA tensors, output {out.dtype} finite "
          f"{bool(torch.isfinite(out).all())} [{card}]", flush=True)
    if launches != 1 or loops.get("cuda", 0) or not bool(
            torch.isfinite(out).all()):
        fail(f"nms ssd float16: launches {launches}, loops {loops}")
    return recs


def rcnn_inputs(dev, seed=19):
    """MultiProposal's inputs at R-CNN's shapes: batch 2, a 38 x 63 map
    (600 x 1000 at stride 16), 12 anchors (scales 4-32, ratios 0.5-2)."""
    b, h, w = RCNN_MAP
    gen = torch.Generator(device="cpu")
    gen.manual_seed(seed)
    cls = torch.rand(b, 24, h, w, generator=gen)
    bbox = torch.randn(b, 48, h, w, generator=gen) * 0.2
    info = torch.tensor([[600.0, 1000.0, 1.0]] * b)
    return cls.to(dev), bbox.to(dev), info.to(dev)


def quant_proposal_nms(card, dev):
    from mxnet_tpu_torch.ops import contrib

    cls, bbox, info = rcnn_inputs(dev)
    boxes, scores = contrib.proposal_candidates(cls, bbox, info, 6000)
    return nms_hold("proposal_6000", boxes.contiguous(),
                    scores.contiguous(), None, contrib._f32(0.7), True, 1.0,
                    card)


def _same_qgraph(a, b):
    """(structure identical, worst relative distance of the calibrated
    ranges): nodes, inputs and every attribute but the ranges equal."""
    ja, jb = json.loads(a.tojson()), json.loads(b.tojson())
    if ja["heads"] != jb["heads"] or len(ja["nodes"]) != len(jb["nodes"]):
        return False, math.inf
    worst = 0.0
    for x, y in zip(ja["nodes"], jb["nodes"]):
        if (x["op"], x["name"], x["inputs"]) != (y["op"], y["name"],
                                                 y["inputs"]):
            return False, math.inf
        ax, ay = x.get("attrs", {}), y.get("attrs", {})
        if set(ax) != set(ay):
            return False, math.inf
        for k in ax:
            if k.endswith("_calib_range"):
                u, v = float(ax[k]), float(ay[k])
                worst = max(worst, abs(u - v) / max(abs(u), 1e-30))
            elif ax[k] != ay[k]:
                return False, math.inf
    return True, worst


def quant_resnet(card, dev):
    """(c): the symbolic ResNet-50 phase 11 trained, quantized (53
    convolutions and the FC) with entropy calibration over 1 batch of 64
    (naive beside it), its int8 logits captured against eager and against
    fp32; the same quantize_model calls on the CPU."""
    import numpy as np

    from mxnet_tpu_torch import _graphs as mxg
    from mxnet_tpu_torch import cpu, nd, sym
    from mxnet_tpu_torch.contrib.quantization import quantize_model
    from mxnet_tpu_torch.ops import quantized_conv as qc

    w_args, w_aux = KEEP["sym_resnet50"]  # phase 20 pops it
    net = resnet50_v1_sym(sym)
    xs, _ = sym_images(Q_BATCH * (Q_CALIB_BATCHES + 1), 19)
    calib = [xs[i * Q_BATCH:(i + 1) * Q_BATCH]
             for i in range(Q_CALIB_BATCHES)]

    samples = {"card": {}, "cpu": {}}  # entropy calibration's, by device

    def quantize(mode, ctx):
        args = {k: nd.array(v, ctx=ctx) for k, v in w_args.items()}
        aux = {k: nd.array(v, ctx=ctx) for k, v in w_aux.items()}
        t0 = time.perf_counter()
        with keep_calib_samples(samples["card" if ctx is dev else "cpu"]):
            out = quantize_model(net, args, aux, calib_mode=mode,
                                 calib_data=[nd.array(c, ctx=ctx)
                                             for c in calib])
        torch.cuda.synchronize()
        return out, args, aux, time.perf_counter() - t0

    modes = ["entropy", "naive"]
    (qsym, qargs, qaux), args, aux, calib_s = quantize("entropy", dev)
    print(f"quant resnet50: quantize_model with entropy calibration over "
          f"{Q_CALIB_BATCHES} batch(es) of {Q_BATCH} took {calib_s:.1f} s "
          f"[{card}]", flush=True)
    if calib_s > Q_ENTROPY_LIMIT_S:
        print(f"quant resnet50: entropy calibration took over "
              f"{Q_ENTROPY_LIMIT_S:.0f} s, so the main run is naive",
              flush=True)
        modes = ["naive"]
        (qsym, qargs, qaux), args, aux, calib_s = quantize("naive", dev)
    mode = modes[0]
    xeval = nd.array(xs[-Q_BATCH:], ctx=dev)
    n_q = sum(1 for n in qsym._topo() if n.op in (
        "_contrib_quantized_conv", "_contrib_quantized_fully_connected"))
    qexe = qsym.get_internals()["fc_output"].bind(
        dev, dict(qargs, data=xeval), grad_req="null", aux_states=qaux)
    fexe = net.get_internals()["fc_output"].bind(
        dev, dict(args, data=xeval), grad_req="null", aux_states=aux)
    qc.reset_int8_conv_launch_count()
    for _ in range(Q_FORWARDS):
        q = qexe.forward()[0]._data
    torch.cuda.synchronize()
    launches = {s: qc.int8_conv_launch_count(s) for s in ("conv", "fc")}
    q = q.clone()
    with mxg.no_capture():
        q_eager = qexe.forward()[0]._data.clone()
    f = fexe.forward()[0]._data.clone()

    def timed(exe, n=5):
        exe.forward()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(n):
            exe.forward()
        torch.cuda.synchronize()
        return (time.perf_counter() - t) / n * 1e3

    q_ms, f_ms = timed(qexe), timed(fexe)
    same = torch.equal(q, q_eager)

    def agreement(logits):
        return (float((logits.argmax(1) == f.argmax(1)).float().mean()),
                float((logits - f).norm() / f.norm()))

    # informational only: the net was trained for a few steps on random
    # labels, so its fp32 argmax may fall on a few classes
    top1, rel = agreement(q)
    n_cls = int(f.argmax(1).unique().numel())
    res = dict(mode=mode, calib_s=calib_s, int8_ms=q_ms, fp32_ms=f_ms,
               launches=launches, forwards=Q_FORWARDS, identical=same,
               top1=top1, fp32_classes=n_cls, rel_l2=rel, layers=n_q)
    print(f"quant resnet50 int8 ({mode}, {n_q} quantized layers) fp32 NCHW "
          f"batch {Q_BATCH}: {q_ms:.2f} ms a captured forward to the "
          f"logits against fp32's {f_ms:.2f} ms; int8 kernel launches in "
          f"{Q_FORWARDS} forwards: {launches['conv']} by the convolutions "
          f"({launches['conv'] / Q_FORWARDS:.0f} a forward), "
          f"{launches['fc']} by the FC ({launches['fc'] / Q_FORWARDS:.0f} a "
          f"forward); captured against eager bit-identical {same}; against "
          f"fp32 (no bound: weights from a few steps on random labels): "
          f"top-1 agreement {top1:.4f} over {n_cls} distinct fp32 classes, "
          f"logits relative L2 error {rel:.4f} [{card}]", flush=True)
    ok = same and n_q == 54 and launches == {
        "conv": 53 * Q_FORWARDS, "fc": Q_FORWARDS} and bool(
        torch.isfinite(q).all())
    KEEP["int8_forward"] = qexe  # phase 21 profiles its replay
    del qexe
    # each mode's call on the card against the same call on the CPU: the
    # graph node for node, the int8 weights bit for bit, naive's ranges
    # and entropy's samples within Q_RANGE_REL (their activations differ
    # in the last bits between the card's and the CPU's convolutions)
    for m in modes:
        if m != mode:
            (qsym, qargs, qaux), _, _, _ = quantize(m, dev)
            qexe = qsym.get_internals()["fc_output"].bind(
                dev, dict(qargs, data=xeval), grad_req="null",
                aux_states=qaux)
            res[f"{m}_top1"], res[f"{m}_rel_l2"] = agreement(
                qexe.forward()[0]._data)
            del qexe
            print(f"quant resnet50 int8 ({m}): top-1 agreement with fp32 "
                  f"{res[f'{m}_top1']:.4f}, logits relative L2 error "
                  f"{res[f'{m}_rel_l2']:.4f} [{card}]", flush=True)
        (csym, cargs, caux), _, _, cpu_s = quantize(m, cpu())
        structure, worst = _same_qgraph(qsym, csym)
        if m == mode:
            res["cpu_forward"] = quant_cpu_forward(
                qsym, qargs, qaux, csym, cargs, caux, q, xs[-Q_BATCH:], dev,
                card)
            ok = ok and res["cpu_forward"]["ok"]
        same_args = set(qargs) == set(cargs) and all(
            torch.equal(qargs[k]._data.cpu(), cargs[k]._data)
            for k in qargs)
        n8 = sum(1 for k in qargs if qargs[k].dtype == np.int8)
        bound = f"bound {Q_RANGE_REL}" if m == "naive" else "no bound"
        print(f"quant resnet50 ({m}): the same quantize_model call on the "
              f"cpu ({cpu_s:.1f} s): graph node for node {structure}, "
              f"calibrated ranges at most {worst:.3g} relative apart "
              f"({bound}), {len(qargs)} parameters ({n8} int8) bit for bit "
              f"{same_args} [{card}]", flush=True)
        ok = ok and structure and same_args
        if m == "naive":
            ok = ok and worst <= Q_RANGE_REL
        else:
            res["entropy_samples_rel"] = quant_entropy_samples(
                samples["card"], samples["cpu"], card)
            ok = ok and res["entropy_samples_rel"] <= Q_RANGE_REL
        res[f"{m}_cpu"] = dict(seconds=cpu_s, graph_same=structure,
                               range_rel=worst, args_same=same_args)
    if not ok:
        fail(f"quant resnet50: {json.dumps(res, default=str)}")
    return res


@contextlib.contextmanager
def keep_calib_samples(store):
    """quantize_model's entropy calibration with each calibrated tensor's
    samples (the strided subsample its histogram is built from) kept in
    `store`."""
    from mxnet_tpu_torch.contrib import quantization as cq

    real = cq.calib_thresholds

    def keeping(*args, **kw):
        if kw.get("calib_mode") == "entropy":
            kw["samples_out"] = store
        return real(*args, **kw)
    cq.calib_thresholds = keeping
    try:
        yield store
    finally:
        cq.calib_thresholds = real


def quant_entropy_samples(card_s, cpu_s, card):
    """(c): entropy calibration's samples of every calibrated tensor (the
    inputs and outputs of the 53 convolutions and the FC, the strided
    subsample the histogram is built from), kept from the quantize_model
    calls on the card and on the CPU; returns the worst distance
    relative to each tensor's largest magnitude."""
    if not cpu_s or set(card_s) != set(cpu_s):
        return math.inf
    worst = 0.0
    for k, want in cpu_s.items():
        have = card_s[k]
        if have.shape != want.shape:
            worst = math.inf
            break
        sc = float(abs(want).max()) or 1.0
        worst = max(worst, float(abs(have - want).max()) / sc)
    n = sum(a.size for a in cpu_s.values())
    print(f"quant resnet50 (entropy): calibration samples of {len(cpu_s)} "
          f"tensors ({n} values), card against cpu, at most {worst:.3g} of "
          f"each tensor's largest magnitude apart (bound {Q_RANGE_REL}) "
          f"[{card}]", flush=True)
    return worst


def quant_cpu_forward(qsym, qargs, qaux, csym, cargs, caux, q, xeval, dev,
                      card):
    """(c): the card's int8 forward held against the CPU's on the first
    Q_CPU_ROWS eval images.  Node by node: every op of the quantized graph
    run on the CPU from the card's values of its inputs, against the
    card's output.  End to end: the card's quantized graph and parameters
    run on the CPU (int8_conv_ref and the fp32 ops there), its logits and
    the int8 activations of every quantize node against the card's; the
    CPU's own quantize_model result, whose entropy ranges may sit some
    histogram bins from the card's, beside them."""
    from mxnet_tpu_torch import cpu, nd, sym
    from mxnet_tpu_torch.ops.registry import get_op
    from mxnet_tpu_torch.symbol.symbol import (TRAIN_AWARE_OPS, Symbol,
                                                op_attrs)

    x = xeval[:Q_CPU_ROWS]

    def bind(s, args, aux, ctx):
        args = {k: v.as_in_context(ctx) for k, v in args.items()}
        aux = {k: v.as_in_context(ctx) for k, v in aux.items()}
        return s.bind(ctx, dict(args, data=nd.array(x, ctx=ctx)),
                      grad_req="null", aux_states=aux)

    # node by node
    t0 = time.perf_counter()
    graph = qsym.get_internals()["fc_output"]
    topo = graph._topo()
    heads = [(n, i) for n in topo if n.op is not None
             for i in range(n.num_outputs)]
    vals = dict(zip([(id(n), i) for n, i in heads],
                    (o._data.cpu() for o in bind(
                        Symbol(heads), qargs, qaux, dev).forward())))
    given = dict(qargs, **qaux)
    for n in topo:
        if n.op is None:
            vals[(id(n), 0)] = torch.from_numpy(x) if n.name == "data" \
                else given[n.name]._data.cpu()
    worst = {"int": 0, "float": 0.0}
    moved, checked = 0, 0
    for n in topo:
        if n.op is None:
            continue
        kw = op_attrs(n)
        if n.op in TRAIN_AWARE_OPS:
            kw["train"] = False
        out = get_op(n.op).fn(*(vals[(id(i), ix)] for i, ix in n.inputs),
                              **kw)
        outs = out if isinstance(out, (tuple, list)) else [out]
        for i, o in enumerate(outs[:n.num_outputs]):
            card_o = vals[(id(n), i)]
            checked += 1
            if o.dtype.is_floating_point:
                sc = float(o.abs().max()) if o.numel() else 0.0
                d = float((card_o - o).abs().max()) if o.numel() else 0.0
                worst["float"] = max(worst["float"], d / (sc or 1.0))
            else:
                d = (card_o.long() - o.long()).abs()
                moved += int((d > 0).sum())
                worst["int"] = max(worst["int"], int(d.max()))
    node_s = time.perf_counter() - t0
    node_ok = worst["int"] <= Q_NODE_STEPS and worst["float"] <= Q_NODE_TOL
    print(f"quant resnet50: the card's int8 graph node by node ({checked} "
          f"outputs of {len(topo)} nodes, {Q_CPU_ROWS} images), each op on "
          f"the cpu from the card's inputs: integer outputs at most "
          f"{worst['int']} steps apart (bound {Q_NODE_STEPS}, {moved} "
          f"elements moved), float outputs {worst['float']:.3g} of their "
          f"scale (bound {Q_NODE_TOL}); {node_s:.1f} s [{card}]", flush=True)

    # end to end
    names = [n for n in qsym.get_internals().list_outputs()
             if n.endswith("_quantize_output0")]

    def run(s, args, aux, ctx, heads):
        inner = s.get_internals()
        g = sym.Group([inner[n] for n in heads])
        return [o._data.cpu() for o in bind(g, args, aux, ctx).forward()]

    t0 = time.perf_counter()
    want = run(qsym, qargs, qaux, cpu(), ["fc_output"] + names)
    cpu_s = time.perf_counter() - t0
    got = run(qsym, qargs, qaux, dev, names)
    own = run(csym, cargs, caux, cpu(), ["fc_output"])[0]
    mine = q[:Q_CPU_ROWS].cpu()
    logits = want[0]
    scale = float(logits.abs().max())
    err = float((mine - logits).abs().max())
    err_own = float((mine - own).abs().max())
    steps = [(a.int() - b.int()).abs() for a, b in zip(got, want[1:])]
    flips = sum(int((d == 1).sum()) for d in steps)
    apart = sum(int((d > 0).sum()) for d in steps)
    total = sum(d.numel() for d in steps)
    far = max(int(d.max()) for d in steps)
    ok = node_ok and bool(torch.isfinite(logits).all()) and \
        err <= Q_CPU_TOL * scale
    print(f"quant resnet50: the card's int8 forward against the same graph "
          f"and parameters on the cpu ({Q_CPU_ROWS} images, {cpu_s:.1f} s "
          f"there): logits max abs diff {err:.4g} of scale {scale:.4g} "
          f"({err / scale:.4g}; bound {Q_CPU_TOL}); of {total} int8 "
          f"activations of the {len(names)} quantize nodes {flips} one "
          f"step apart, {apart - flips} more, at most {far} steps; against "
          f"the cpu's own quantize_model result (no bound) {err_own:.4g} "
          f"({err_own / scale:.4g} of scale) [{card}]", flush=True)
    return dict(ok=ok, rows=Q_CPU_ROWS, node_outputs=checked,
                node_max_step=worst["int"], node_moved=moved,
                node_float_rel=worst["float"], node_s=node_s, max_abs=err,
                scale=scale, flips=flips, apart=apart, activations=total,
                max_step=far, cpu_s=cpu_s, own_max_abs=err_own)


def quant_example(card):
    """(d): examples/quantize_model.py's flow at its full size in each
    calibration mode, within its own 5% limit."""
    from mxnet_tpu_torch.examples import quantize_model as ex
    from mxnet_tpu_torch.ops import quantized_conv as qc

    res = {}
    for mode in ("none", "naive", "entropy"):
        qc.reset_int8_conv_launch_count()
        t0 = time.perf_counter()
        try:
            r = ex.main(["--calib-mode", mode])
        except SystemExit as e:
            fail(f"quant example {mode}: {e}")
            continue
        r.update(seconds=time.perf_counter() - t0,
                 launches=qc.int8_conv_launch_count())
        print(f"quant example --calib-mode {mode}: fp32 accuracy "
              f"{r['fp32_acc']:.4f}, int8 {r['int8_acc']:.4f} (drop "
              f"{r['drop']:.4f}, limit 0.05); scoring fp32 "
              f"{r['fp32_s']:.3f} s, int8 {r['int8_s']:.3f} s; "
              f"{r['launches']} int8 kernel launches; {r['seconds']:.1f} s "
              f"[{card}]", flush=True)
        if r["drop"] > 0.05 or not r["launches"]:
            fail(f"quant example {mode}: drop {r['drop']}, launches "
                 f"{r['launches']}")
        res[mode] = r
    return res


def _rcnn_hold(tag, fn, inputs, grad_of, card, dev):
    """fn on the card and on the CPU: outputs and the gradients of
    `grad_of` (input indices) under a seeded cotangent within RCNN_TOL of
    the CPU's largest magnitude; the card's forward + backward ms."""
    def run(dev):
        ins = [t.to(dev).detach().requires_grad_(i in grad_of)
               for i, t in enumerate(inputs)]
        out = fn(*ins)
        gen = torch.Generator(device="cpu")
        gen.manual_seed(1)
        ct = torch.randn(out.shape, generator=gen).to(dev)
        grads = torch.autograd.grad(out, [ins[i] for i in grad_of], ct) \
            if grad_of else []
        return [out.detach()] + [g.detach() for g in grads]

    got = run(dev)
    want = run(torch.device("cpu"))
    worst = 0.0
    for g, w in zip(got, want):
        scale = float(w.abs().max()) or 1.0
        worst = max(worst, float((g.cpu() - w).abs().max()) / scale)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run(dev)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    print(f"rcnn {tag}: card against cpu, forward and gradient, at most "
          f"{worst:.3g} of the cpu's largest magnitude (tolerance "
          f"{RCNN_TOL}); card forward + backward {ms:.2f} ms [{card}]",
          flush=True)
    if not worst <= RCNN_TOL:
        fail(f"rcnn {tag}: {worst} of scale")
    return dict(rel=worst, ms=ms)


def quant_rcnn(card, dev):
    """(e): MultiProposal at R-CNN's shapes, its rois into ROIAlign and
    ROIPooling over 1024 channels, PSROIPooling at R-FCN's 21 classes and
    group 7, AdaptiveAvgPooling2D, BilinearResize2D, fft/ifft and
    boolean_mask, each card against CPU."""
    from mxnet_tpu_torch.ops import contrib

    res = {}
    cls, bbox, info = rcnn_inputs(dev)
    kw = dict(rpn_pre_nms_top_n=6000, rpn_post_nms_top_n=300,
              output_score=True)
    contrib.reset_nms_loop_runs()
    contrib.reset_nms_launch_count()
    rois, sc = contrib.proposal(cls, bbox, info, **kw)
    torch.cuda.synchronize()
    launches, loops = contrib.nms_launch_count(), contrib.nms_loop_runs()
    t0 = time.perf_counter()
    contrib.proposal(cls, bbox, info, **kw)
    torch.cuda.synchronize()
    prop_ms = (time.perf_counter() - t0) * 1e3
    c_rois, c_sc = contrib.proposal(cls.cpu(), bbox.cpu(), info.cpu(), **kw)
    kept = rois[:, 1:].abs().sum(1) > 0
    same = torch.equal(sc.cpu(), c_sc) and torch.equal(
        kept.cpu(), c_rois[:, 1:].abs().sum(1) > 0)
    box_err = float(((rois.cpu() - c_rois).abs()
                     / c_rois.abs().clamp_min(1.0)).max())
    print(f"rcnn MultiProposal batch {RCNN_MAP[0]}, map {RCNN_MAP[1]}x"
          f"{RCNN_MAP[2]}, 12 anchors, 6000 -> 300: {prop_ms:.2f} ms on the "
          f"card, {int(kept.sum())} rois kept; scores and kept rows "
          f"identical to the cpu {same}, boxes within {box_err:.3g} "
          f"relative (tolerance {RCNN_TOL}); NMS kernel launches "
          f"{launches}, Python loop runs on CUDA "
          f"{loops.get('cuda', 0)} [{card}]", flush=True)
    if not same or box_err > RCNN_TOL or launches != 1 \
            or loops.get("cuda", 0):
        fail(f"rcnn MultiProposal: identical {same}, boxes {box_err}, "
             f"launches {launches}, loops {loops}")
    res["proposal"] = dict(ms=prop_ms, kept=int(kept.sum()),
                           identical=same, box_rel=box_err,
                           launches=launches)
    gen = torch.Generator(device="cpu")
    gen.manual_seed(20)
    b, h, w = RCNN_MAP
    feat = torch.randn(b, 1024, h, w, generator=gen)
    post = 300
    sel = torch.cat([torch.arange(RCNN_CHECKED) + i * post
                     for i in range(b)])
    r_sub = rois[sel].cpu()
    scale = 1.0 / 16
    res["roi_align"] = _rcnn_hold(
        "ROIAlign 14x14 1024 ch scale 1/16 sample 2 "
        f"({len(sel)} rois)", lambda d, r: contrib.roi_align(
            d, r, (14, 14), scale, 2), [feat, r_sub], (0,), card, dev)
    res["roi_pooling"] = _rcnn_hold(
        f"ROIPooling 7x7 1024 ch ({len(sel)} rois)",
        lambda d, r: contrib.roi_pooling(d, r, (7, 7), scale),
        [feat, r_sub], (0,), card, dev)
    ps = torch.randn(b, 21 * 49, h, w, generator=gen)
    res["psroi"] = _rcnn_hold(
        f"PSROIPooling 21 classes group 7 ({len(sel)} rois)",
        lambda d, r: contrib.psroi_pooling(d, r, scale, 21, 7),
        [ps, r_sub], (0,), card, dev)
    # every roi of both images through the card, timed
    feat_d = feat.to(dev).requires_grad_()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = contrib.roi_align(feat_d, rois, (14, 14), scale, 2)
    out.backward(torch.ones_like(out))
    torch.cuda.synchronize()
    res["roi_align_all_ms"] = (time.perf_counter() - t0) * 1e3
    del out, feat_d
    print(f"rcnn ROIAlign over all {rois.shape[0]} rois: forward + "
          f"backward {res['roi_align_all_ms']:.1f} ms [{card}]", flush=True)
    big = torch.randn(2, 2048, 60, 60, generator=gen)
    for s in (1, 2, 3, 6):
        res[f"adaptive{s}"] = _rcnn_hold(
            f"AdaptiveAvgPooling2D 2048x60x60 -> {s}",
            lambda d, s=s: contrib.adaptive_avg_pooling2d(d, (s, s)),
            [big], (0,), card, dev)
    res["resize"] = _rcnn_hold(
        "BilinearResize2D 256x38x63 -> 76x126",
        lambda d: contrib.bilinear_resize2d(d, height=76, width=126),
        [torch.randn(2, 256, h, w, generator=gen)], (0,), card, dev)
    sig = torch.randn(64, 1024, generator=gen)
    res["fft"] = _rcnn_hold("fft 64 x 1024", contrib.fft, [sig], (0,), card, dev)
    res["ifft"] = _rcnn_hold(
        "ifft 64 x 2048", contrib.ifft,
        [torch.randn(64, 2048, generator=gen)], (0,), card, dev)
    data = torch.randn(6000, 4, generator=gen)
    mask = (torch.rand(6000, generator=gen) > 0.5).float()
    got = contrib.boolean_mask(data.to(dev), mask.to(dev)).cpu()
    want = contrib.boolean_mask(data, mask)
    res["boolean_mask"] = torch.equal(got, want)
    print(f"rcnn boolean_mask 6000 x 4: card identical to cpu "
          f"{res['boolean_mask']} ({got.shape[0]} rows) [{card}]",
          flush=True)
    if not res["boolean_mask"]:
        fail("rcnn boolean_mask: card and cpu differ")
    return res


def int8_summary(recs, path, launches):
    main = [r for r in recs if r["path"] == path]
    tot = {k: sum(r[k] * r["count"] for r in main)
           for k in ("kernel_ms", "op_ms", "ref_ms", "bound_ms")}
    lib = [r["library_ms"] for r in main]
    by_ops = sum(r["bound_ms"] * r["count"] for r in main
                 if r["bound_by"] == "operations")
    return dict(KERNEL_INT8, name="int8_conv/" + path, path=path,
                batch=Q_BATCH, launches=launches,
                max_abs_err=max(r["max_abs_err"] for r in main),
                ms=tot["kernel_ms"], op_ms=tot["op_ms"],
                plain_ms=tot["ref_ms"], bound_ms=tot["bound_ms"],
                bound_by="operations" if by_ops >= tot["bound_ms"] / 2
                else "bytes",
                library_ms=None if None in lib else sum(
                    x * r["count"] for x, r in zip(lib, main)))


def nms_summary(rec, path, launches):
    return dict(KERNEL_NMS, name="greedy_nms/" + path, path=path,
                batch=rec["batch"], K=rec["K"], launches=launches,
                max_abs_err=rec["max_abs_err"], ms=rec["kernel_ms"],
                plain_ms=rec["ref_ms"], bound_ms=rec["bound_ms"],
                bound_by=rec["bound_by"], library_ms=None)


def phase_quant(card):
    """Phase 19: (a) the int8 kernel, (b) the NMS kernel, (c) the
    quantized symbolic ResNet-50, (d) the example, (e) the R-CNN ops.
    Returns (results, the `kernels` records)."""
    import gc

    gc.collect()
    torch.cuda.empty_cache()
    dev = torch.device("cuda", 0)
    if "ssd_detection" not in KEEP or "sym_resnet50" not in KEEP:
        fail("quant: phase 19 needs phase 10's detection inputs and phase "
             "11's trained ResNet-50")
        return {}, []
    t0 = time.perf_counter()
    marks = [("start", t0)]
    res = {}
    recs = quant_kernel_checks(card, dev)
    marks.append(("a", time.perf_counter()))
    res["nms"] = quant_nms(card, dev)
    res["nms"]["proposal"] = quant_proposal_nms(card, dev)
    res["nms"]["dtypes"] = quant_nms_dtypes(card, dev)
    marks.append(("b", time.perf_counter()))
    gc.collect()
    torch.cuda.empty_cache()
    res["resnet"] = quant_resnet(card, dev)
    marks.append(("c", time.perf_counter()))
    gc.collect()
    torch.cuda.empty_cache()
    res["example"] = quant_example(card)
    marks.append(("d", time.perf_counter()))
    res["rcnn"] = quant_rcnn(card, dev)
    marks.append(("e", time.perf_counter()))
    gc.collect()
    torch.cuda.empty_cache()
    res["seconds"] = time.perf_counter() - t0
    print(f"quant: phase 19 took {res['seconds']:.1f} s ("
          + ", ".join(f"{b[0]} {b[1] - a[1]:.1f} s"
                      for a, b in zip(marks, marks[1:])) + ")", flush=True)
    fwd = res["resnet"]["launches"]
    kernels = [
        int8_summary(recs, "quantized_resnet50", fwd["conv"]),
        int8_summary(recs, "quantized_resnet50_fc", fwd["fc"]),
        nms_summary(res["nms"][100], "ssd_detection_topk100",
                    res["nms"][100]["launches"]),
        nms_summary(res["nms"][-1], "ssd_detection_all",
                    res["nms"][-1]["launches"]),
        nms_summary(res["nms"]["proposal"], "multiproposal",
                    res["rcnn"]["proposal"]["launches"])]
    return res, kernels


# ---------------------------------------------------------------------------
# phase 20: user-defined operators, control flow and ONNX
# ---------------------------------------------------------------------------

CO = dict(batch=64, hw=224, classes=1000, fit_batches=3, steps=3, timed=3,
          windows=4, sig_rows=64, sig_width=1024,
          # PTB "medium" (Zaremba et al. 2014): 2 x 650 LSTM, 35 steps,
          # vocabulary 10,000, batch 20; no dropout (the bit-for-bit check)
          lm_steps=35, lm_vocab=10000, lm_batch=20, lm_hidden=650,
          lm_train=1 + CAPTURE_K, loop_width=512)
CO_ONNX_REL = 1e-6        # (a): imported forward against the original
CO_LM_BOUNDS = dict(loss=1e-5, grad=1e-4)  # (c): foreach against RNN
CO_CARD_CPU = 1e-5        # (b), (d): card against the CPU, relative L2
CUSTOM_OPS = {}


def register_custom_ops():
    """(b)'s user ops, registered once: reference MXNet's custom softmax
    (example/numpy-ops/custom_softmax.py, need_top_grad=False) with nd
    ops on the op's device, and the JAX package's tests' host-style
    sigmoid (.asnumpy(), numpy, assign); each class counts its
    forwards."""
    if CUSTOM_OPS:
        return CUSTOM_OPS
    import numpy as np

    from mxnet_tpu_torch import nd, operator

    class Softmax(operator.CustomOp):
        forwards = 0

        def forward(self, is_train, req, in_data, out_data, aux):
            type(self).forwards += 1
            x = in_data[0]
            e = nd.exp(x - x.max(axis=1, keepdims=True))
            self.assign(out_data[0], req[0], e / e.sum(axis=1, keepdims=True))

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            y = out_data[0]
            self.assign(in_grad[0], req[0],
                        y - nd.one_hot(in_data[1], depth=y.shape[1]))

    @operator.register("softmax")
    class SoftmaxProp(operator.CustomOpProp):
        def __init__(self):
            super().__init__(need_top_grad=False)

        def list_arguments(self):
            return ["data", "label"]

        def infer_shape(self, in_shape):
            return [in_shape[0], (in_shape[0][0],)], [in_shape[0]], []

        def create_operator(self, ctx, shapes, dtypes):
            return Softmax()

    class Sigmoid(operator.CustomOp):
        forwards = 0

        def forward(self, is_train, req, in_data, out_data, aux):
            type(self).forwards += 1
            x = in_data[0].asnumpy()
            self.assign(out_data[0], req[0], 1.0 / (1.0 + np.exp(-x)))

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            y = out_data[0].asnumpy()
            self.assign(in_grad[0], req[0],
                        out_grad[0].asnumpy() * y * (1 - y))

    @operator.register("host_sigmoid")
    class SigmoidProp(operator.CustomOpProp):
        def create_operator(self, ctx, shapes, dtypes):
            return Sigmoid()

    CUSTOM_OPS.update(softmax=Softmax, sigmoid=Sigmoid)
    return CUSTOM_OPS


def co_weights(net):
    """Phase 11's trained ResNet-50 (CPU tensors) when it is alive, else
    weights from a seed (He-normal convolutions and FC, BatchNorm at
    gamma 1, beta 0, mean 0, variance 1)."""
    if "sym_resnet50" in KEEP:
        return KEEP.pop("sym_resnet50") + ("phase 11's",)
    import numpy as np

    shapes = dict(data=(CO["batch"], 3, CO["hw"], CO["hw"]))
    arg_shapes, _, aux_shapes = net.infer_shape(**shapes)
    gen = torch.Generator().manual_seed(2023)
    w_args = {}
    for n, s in zip(net.list_arguments(), arg_shapes):
        if n in ("data", "softmax_label"):
            continue
        if n.endswith("gamma"):
            w_args[n] = torch.ones(s)
        elif n.endswith(("beta", "bias")):
            w_args[n] = torch.zeros(s)
        else:
            fan_in = int(np.prod(s[1:]))
            w_args[n] = torch.randn(s, generator=gen) * (2.0 / fan_in) ** 0.5
    w_aux = {n: torch.ones(s) if n.endswith("var") else torch.zeros(s)
             for n, s in zip(net.list_auxiliary_states(), aux_shapes)}
    return w_args, w_aux, "seeded"


def co_images(n, seed):
    import numpy as np

    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, 3, CO["hw"], CO["hw"]), dtype=np.float32)
    return x, rng.integers(0, CO["classes"], n).astype(np.float32)


def co_module(net, args, aux, for_training=True, labels=True):
    """A Module of `net` on gpu(0) bound at CO's batch from `args`/`aux`
    (CPU tensors), with SYM_OPT's sgd when it trains."""
    from mxnet_tpu_torch import gpu
    from mxnet_tpu_torch.io import DataDesc
    from mxnet_tpu_torch.module import Module
    from mxnet_tpu_torch.ndarray import NDArray

    b = CO["batch"]
    mod = Module(net, context=gpu(0),
                 label_names=("softmax_label",) if labels else None)
    mod.bind([DataDesc("data", (b, 3, CO["hw"], CO["hw"]))],
             [DataDesc("softmax_label", (b,))] if labels else None,
             for_training=for_training)
    mod.init_params(arg_params={k: NDArray(v) for k, v in args.items()},
                    aux_params={k: NDArray(v) for k, v in aux.items()})
    if for_training:
        mod.init_optimizer(optimizer="sgd", optimizer_params=dict(
            SYM_OPT, rescale_grad=1.0 / b))
    return mod


def co_onnx(card, net, w_args, w_aux):
    """(a): the symbolic ResNet-50 to ONNX and back: export (bytes,
    seconds), torch._C._check_onnx_proto, get_model_metadata,
    import_model (parameters on cpu()), a Module(for_training=False) of
    the import on the card, its captured forward against the original's
    from the same weights (relative L2 within CO_ONNX_REL, the same
    argmax in every row), both forwards timed."""
    from mxnet_tpu_torch import cpu
    from mxnet_tpu_torch.contrib import onnx as onnx_mx
    from mxnet_tpu_torch.io import DataBatch
    from mxnet_tpu_torch.ndarray import NDArray

    b = CO["batch"]
    path = os.path.join("build", "chip_smoke_onnx", "resnet50_v1.onnx")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    t0 = time.perf_counter()
    onnx_mx.export_model(net, {**w_args, **w_aux},
                         [(b, 3, CO["hw"], CO["hw"]), (b,)], path)
    export_s = time.perf_counter() - t0
    nbytes = os.path.getsize(path)
    with open(path, "rb") as f:
        torch._C._check_onnx_proto(f.read())
    meta = onnx_mx.get_model_metadata(path)
    t0 = time.perf_counter()
    s2, a2, x2 = onnx_mx.import_model(path)
    import_s = time.perf_counter() - t0
    os.remove(path)
    on_cpu = all(v.ctx == cpu() for v in list(a2.values())
                 + list(x2.values()))
    x, y = co_images(b, 20)
    batch = DataBatch([NDArray(torch.from_numpy(x))],
                      [NDArray(torch.from_numpy(y))])
    outs, ms = {}, {}
    for tag, sym, args, aux, labels in (
            ("original", net, w_args, w_aux, True),
            ("imported", s2, {k: v._data for k, v in a2.items()},
             {k: v._data for k, v in x2.items()}, False)):
        mod = co_module(sym, args, aux, for_training=False, labels=labels)
        # the warm-up call builds the captured forward
        ms[tag] = time_ms(lambda: mod.forward(batch, is_train=False),
                          iters=CO["timed"], warmup=1)
        outs[tag] = mod.get_outputs()[0]._data.detach().cpu()
        del mod
    o, i = outs["original"], outs["imported"]
    rel = rel_l2(i, o)
    same_argmax = bool(torch.equal(i.argmax(1), o.argmax(1)))
    print(f"custom_onnx (a): resnet50_v1 ({len(w_args)} arguments) exported "
          f"to ONNX opset 13: {nbytes} bytes in {export_s:.2f} s, passes "
          f"torch._C._check_onnx_proto, metadata inputs "
          f"{meta['input_tensor_data']} outputs "
          f"{meta['output_tensor_data']}; imported in {import_s:.2f} s "
          f"(parameters on cpu() {on_cpu}); batch-{b} captured forward "
          f"{ms['imported']:.2f} ms imported against {ms['original']:.2f} "
          f"ms original, relative L2 {rel:.3g} (bound {CO_ONNX_REL}), argmax "
          f"equal {same_argmax} [{card}]", flush=True)
    if not (rel <= CO_ONNX_REL and same_argmax and on_cpu
            and i.shape == (b, CO["classes"])):
        fail(f"custom_onnx (a): relative L2 {rel}, argmax equal "
             f"{same_argmax}, parameters on cpu {on_cpu}")
    return dict(bytes=nbytes, export_s=export_s, import_s=import_s,
                rel_l2=rel, argmax_equal=same_argmax,
                imported_ms=ms["imported"], original_ms=ms["original"])


def co_steps(mod, batches, steps):
    """`steps` eager Module steps; the outputs and the weights after."""
    from mxnet_tpu_torch import _graphs as mxg

    with mxg.no_capture():
        timed_module_steps(mod, batches, steps)
    ex = mod._exec_group.execs[0]
    return (ex.outputs[0]._data.detach().double().cpu(),
            {n: ex.arg_dict[n]._data.detach().double().cpu()
             for n in mod._param_names})


def co_windows(run):
    """ms a step of CO["windows"] windows of CO["timed"] steps each:
    `run(steps)` returns seconds a step."""
    return [run(CO["timed"]) * 1e3 for _ in range(CO["windows"])]


def co_span(ms):
    return f"{min(ms):.2f}-{max(ms):.2f}"


def co_custom(card, net, w_args, w_aux):
    """(b): ResNet-50 with a Custom softmax head through Module.fit, then
    CO["steps"] eager steps from one state against the SoftmaxOutput net
    (the updates of all leaves together within twice the step's own
    sensitivity: the larger of two SoftmaxOutput runs' distance and of a
    run from weights moved by 2^-24 relative), the Custom step never
    captured (custom_eager counts every step) and the user forward once
    a step; its step's ms beside the SoftmaxOutput net's captured and
    eager ones, each over CO["windows"] windows of CO["timed"] steps.
    Then the host-style sigmoid in a hybridized block, forward and
    backward, card against CPU."""
    import gc

    from mxnet_tpu_torch import _graphs as mxg
    from mxnet_tpu_torch import gpu, sym
    from mxnet_tpu_torch.io import NDArrayIter
    from mxnet_tpu_torch.module import Module
    from mxnet_tpu_torch.ndarray import NDArray

    ops = register_custom_ops()
    b = CO["batch"]
    fc = net.get_internals()["fc_output"]
    head = sym.Custom(fc, sym.var("softmax_label"), op_type="softmax",
                      name="softmax")
    x, y = co_images(b * CO["fit_batches"], 21)
    it = NDArrayIter(x, y, batch_size=b, shuffle=False)
    stats = sym.executor_stats
    c0, f0 = stats()["custom_eager"], ops["softmax"].forwards
    mod = Module(head, context=gpu(0))
    t0 = time.perf_counter()
    mod.fit(it, num_epoch=1, optimizer="sgd", arg_params={
        k: NDArray(v) for k, v in w_args.items()}, aux_params={
        k: NDArray(v) for k, v in w_aux.items()},
        optimizer_params=dict(SYM_OPT, rescale_grad=1.0 / b),
        eval_metric="acc")
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    fit_calls = (stats()["custom_eager"] - c0,
                 ops["softmax"].forwards - f0)
    it.reset()
    batches = list(it)
    c0, f0 = stats()["custom_eager"], ops["softmax"].forwards

    def windows(m):
        return co_windows(lambda n: timed_module_steps(m, batches[:1], n))
    custom_ms = windows(mod)
    timed = CO["timed"] * CO["windows"]
    timed_calls = (stats()["custom_eager"] - c0,
                   ops["softmax"].forwards - f0)
    finite = bool(torch.isfinite(mod.get_outputs()[0]._data).all())
    wa, wx = mod.get_params()
    wa = {k: v._data.detach().cpu() for k, v in wa.items()}
    wx = {k: v._data.detach().cpu() for k, v in wx.items()}
    del mod
    gc.collect()
    steps = CO["steps"]
    runs, starts = {}, {}
    g = torch.Generator().manual_seed(20)
    for tag, s, args in (
            ("custom", head, wa), ("softmax", net, wa),
            ("again", net, wa),
            ("witness", net, {k: perturb(v, 2.0 ** -24, g)
                              for k, v in wa.items()})):
        m = co_module(s, args, wx)
        starts[tag] = args
        runs[tag] = co_steps(m, batches, steps)
        if tag == "softmax":
            timed_module_steps(m, batches[:1], 1)  # builds the captured step
            so_ms = windows(m)
            with mxg.no_capture():
                timed_module_steps(m, batches[:1], 1)  # first eager calls
                so_eager_ms = windows(m)
        del m
        gc.collect()
    upd = {t: {k: v - starts[t][k].double() for k, v in r[1].items()}
           for t, r in runs.items()}
    e = rel_l2_all(upd["custom"], upd["softmax"])
    s = max(rel_l2_all(upd["again"], upd["softmax"]),
            rel_l2_all(upd["witness"], upd["softmax"]))
    e_out = rel_l2(runs["custom"][0], runs["softmax"][0])
    ok = e <= 2 * s and finite \
        and fit_calls == (CO["fit_batches"], CO["fit_batches"]) \
        and timed_calls == (timed, timed)
    print(f"custom_onnx (b): resnet50_v1 with sym.Custom(op_type='softmax') "
          f"(nd ops on the card, need_top_grad=False) through Module.fit, "
          f"{CO['fit_batches']} batches of {b} in {fit_s:.2f} s; Custom "
          f"step {co_span(custom_ms)} ms over {CO['windows']} windows of "
          f"{CO['timed']} steps (eager by the rule: custom_eager "
          f"{fit_calls[0]} + {timed_calls[0]}, user forwards {fit_calls[1]} "
          f"+ {timed_calls[1]} for {CO['fit_batches']} + {timed} steps); "
          f"SoftmaxOutput step captured {co_span(so_ms)} ms, eager "
          f"{co_span(so_eager_ms)} ms; {steps} steps from one state, all "
          f"{len(wa)} leaves' updates Custom against SoftmaxOutput "
          f"{e:.3g} (bound 2 x sensitivity {s:.3g}), outputs {e_out:.3g}; "
          f"finite {finite} [{card}]", flush=True)
    if not ok:
        fail(f"custom_onnx (b): updates {e} (sensitivity {s}), calls "
             f"{fit_calls} {timed_calls}, finite {finite}")
    res = dict(fit_s=fit_s, custom_ms=custom_ms, softmax_captured_ms=so_ms,
               softmax_eager_ms=so_eager_ms, updates_rel=e, sensitivity=s,
               outputs_rel=e_out, custom_eager=fit_calls[0] + timed_calls[0],
               user_forwards=fit_calls[1] + timed_calls[1])
    res["sigmoid_block"] = co_sigmoid_block(card, ops)
    return res


def co_sigmoid_block(card, ops):
    """(b): the host-style sigmoid between two Dense layers of a
    hybridized block, forward and backward on the card against the same
    block on the CPU (relative L2 within CO_CARD_CPU), then three
    SPMDTrainer steps over it (losses against the CPU's); the user
    forward once a call or step, and each counted in custom_eager."""
    from mxnet_tpu_torch import autograd, cpu, gluon, gpu, init, nd, parallel
    from mxnet_tpu_torch.gluon import block as gblock
    from mxnet_tpu_torch.gluon import load_numpy_params

    w = CO["sig_width"]

    class Net(gluon.HybridBlock):
        def __init__(self):
            super().__init__()
            self.fc = gluon.nn.Dense(w, in_units=w)
            self.out = gluon.nn.Dense(10, in_units=w)

        def hybrid_forward(self, F, x):
            return self.out(F.Custom(self.fc(x), op_type="host_sigmoid"))

    gen = torch.Generator().manual_seed(22)
    x = torch.randn(CO["sig_rows"], w, generator=gen)
    vals = None
    got = {}
    for tag, ctx in (("cpu", cpu()), ("card", gpu(0))):
        net = Net()
        net.initialize(init.Xavier(), ctx=ctx, seed=5)
        if vals is None:
            vals = {k: t.detach().clone() for k, t in
                    net.state_dict().items()}
        # copies: the trainer below updates the block's tensors in place
        load_numpy_params(net, {k: v.to(ctx.torch_device, copy=True)
                                for k, v in vals.items()})
        net.hybridize()
        xn = nd.NDArray(x.to(ctx.torch_device))
        c0, f0 = gblock.cached_op_stats()["custom_eager"], \
            ops["sigmoid"].forwards
        y = net(xn)
        with autograd.record():
            loss = (net(xn) ** 2).sum()
        loss.backward()
        got[tag] = (
            y._data.cpu(), net.fc.weight.grad()._data.cpu(),
            gblock.cached_op_stats()["custom_eager"] - c0,
            ops["sigmoid"].forwards - f0)
        # SPMDTrainer's step over the same block: every step eager
        tr = parallel.SPMDTrainer(
            net, gluon.loss.SoftmaxCrossEntropyLoss(), "sgd",
            {"learning_rate": 0.1},
            mesh=parallel.make_mesh(dp=1, devices=[ctx.torch_device]))
        labels = (torch.arange(CO["sig_rows"]) % 10).float()
        c0, f0 = parallel.spmd.step_compile_stats()["custom_eager"], \
            ops["sigmoid"].forwards
        losses = [float(tr.step(x.to(ctx.torch_device),
                                labels.to(ctx.torch_device)))
                  for _ in range(3)]
        got[tag] += (losses,
                     parallel.spmd.step_compile_stats()["custom_eager"] - c0,
                     ops["sigmoid"].forwards - f0)
    (yc, gc_, nc, fc_, lc, sc, sfc), (yh, gh, nh, fh, lh, sh, sfh) = \
        got["card"], got["cpu"]
    ey = rel_l2(yc, yh)
    eg = rel_l2(gc_, gh)
    el = max(abs(a - b) / abs(b) for a, b in zip(lc, lh))
    print(f"custom_onnx (b): host-style sigmoid (.asnumpy(), numpy, assign) "
          f"in a hybridized block ({CO['sig_rows']} x {w}): card against "
          f"cpu forward {ey:.3g}, weight gradient {eg:.3g} (bound "
          f"{CO_CARD_CPU}); custom_eager {nc}, user forwards {fc_} for 2 "
          f"calls; SPMDTrainer 3 steps, losses {[round(v, 5) for v in lc]} "
          f"{el:.3g} from the cpu's, custom_eager {sc}, user forwards {sfc} "
          f"[{card}]", flush=True)
    if not (ey <= CO_CARD_CPU and eg <= CO_CARD_CPU and el <= CO_CARD_CPU
            and (nc, fc_, nh, fh) == (2, 2, 2, 2)
            and (sc, sfc, sh, sfh) == (3, 3, 3, 3)):
        fail(f"custom_onnx (b) sigmoid block: {ey} {eg} {el} counts "
             f"{(nc, fc_, nh, fh, sc, sfc, sh, sfh)}")
    return dict(forward_rel=ey, grad_rel=eg, custom_eager=nc,
                spmd_loss_rel=el, spmd_custom_eager=sc)


def co_lm_nets():
    """(c): the PTB-medium LM twice on one set of seeded weights on
    gpu(0): Embedding -> two gluon.rnn.LSTMCell unrolled by
    contrib.foreach -> Dense, and Embedding -> gluon.rnn.LSTM(num_layers=2)
    (the fused RNN op) -> Dense; both hybridized."""
    from mxnet_tpu_torch import gluon, gpu, init
    from mxnet_tpu_torch.gluon import load_numpy_params, nn, rnn

    v, h = CO["lm_vocab"], CO["lm_hidden"]

    class ForeachLM(gluon.HybridBlock):
        def __init__(self):
            super().__init__()
            self.embed = nn.Embedding(v, h)
            self.cell0 = rnn.LSTMCell(h, input_size=h)
            self.cell1 = rnn.LSTMCell(h, input_size=h)
            self.out = nn.Dense(v, in_units=h, flatten=False)

        def hybrid_forward(self, F, tokens):
            x = self.embed(tokens)  # (T, N, h)
            z = x.new_zeros((x.shape[1], h))

            def step(xt, states):
                o0, s0 = self.cell0(xt, states[:2])
                o1, s1 = self.cell1(o0, states[2:])
                return o1, list(s0) + list(s1)

            outs, _ = F.contrib.foreach(step, x, [z, z, z, z])
            return self.out(outs)

    class FusedLM(gluon.HybridBlock):
        def __init__(self):
            super().__init__()
            self.embed = nn.Embedding(v, h)
            self.rnn = rnn.LSTM(h, num_layers=2, input_size=h)
            self.out = nn.Dense(v, in_units=h, flatten=False)

        def hybrid_forward(self, F, tokens):
            return self.out(self.rnn(self.embed(tokens)))

    fe = ForeachLM()
    fe.initialize(init.Xavier(), ctx=gpu(0), seed=23)
    fu = FusedLM()
    fu.initialize(ctx=gpu(0))
    w = {k: t.detach() for k, t in fe.state_dict().items()}
    fused_w = {}
    for k, t in w.items():
        if k.startswith("cell"):
            layer, name = k[4], k.split(".", 1)[1]
            fused_w[f"rnn.l{layer}_{name}"] = t
        else:
            fused_w[k] = t
    load_numpy_params(fu, fused_w)
    fe.hybridize()
    fu.hybridize()
    return fe, fu


def co_grads(net, x, y):
    """One eager forward and backward: (mean loss, {leaf: gradient})."""
    from mxnet_tpu_torch import _graphs as mxg
    from mxnet_tpu_torch import autograd, gluon, nd

    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    with mxg.no_capture():
        with autograd.record():
            loss = loss_fn(net(nd.NDArray(x)), nd.NDArray(y))
        loss.backward()
    return (float(loss.mean().asscalar()),
            {k: p.grad()._data.detach().cpu()
             for k, p in net.collect_params().items()})


def co_lm(card):
    """(c): the foreach LM against the fused RNN LM from one set of
    weights (the loss within CO_LM_BOUNDS["loss"] and every gradient's
    relative L2 within CO_LM_BOUNDS["grad"]); then the foreach LM through
    the hybridized gluon.Trainer loop (SGD), its captured steps bit for
    bit its eager steps from one state (captured_loop), and the captured
    step's ms beside the fused LM's, each over CO["windows"] windows of
    CO["timed"] steps."""
    t, n, v = CO["lm_steps"], CO["lm_batch"], CO["lm_vocab"]
    gen = torch.Generator().manual_seed(2014)
    xb = torch.randint(0, v, (t + 1, n), generator=gen)
    dev = torch.device("cuda", 0)
    xb, yb = xb[:-1].float().to(dev), xb[1:].float().to(dev)
    fe, fu = co_lm_nets()
    loss_e, g_e = co_grads(fe, xb, yb)
    loss_f, g_f = co_grads(fu, xb, yb)
    e_loss = abs(loss_e - loss_f) / abs(loss_f)
    e_grad = {}
    for k, g in g_e.items():
        fk = k if not k.startswith("cell") else \
            f"rnn.l{k[4]}_{k.split('.', 1)[1]}"
        e_grad[k] = rel_l2(g, g_f[fk])
    worst = max(e_grad.items(), key=lambda kv: kv[1])
    w0 = snapshot(fe)
    runs, trainers, bad = captured_loop("custom_onnx (c) foreach lm", fe, w0,
                                        xb, yb, CO["lm_train"], card)
    tr = trainers["captured"]
    restore(fe, w0)
    ms_foreach = co_windows(lambda k: gluon_steps(fe, tr, xb, yb, k)[3])
    ftr = gluon_trainer(fu)
    gluon_steps(fu, ftr, xb, yb, 2)  # warm-up and build
    ms_fused = co_windows(lambda k: gluon_steps(fu, ftr, xb, yb, k)[3])
    builds = runs["captured"][2]
    losses = runs["captured"][0]
    print(f"custom_onnx (c): PTB-medium LM (2 x {CO['lm_hidden']} LSTM, "
          f"{t} steps, vocabulary {v}, batch {n}; synthetic tokens) with "
          f"two LSTMCells unrolled by contrib.foreach against "
          f"gluon.rnn.LSTM (the fused RNN op) on the same weights: loss "
          f"{loss_e:.6f} vs {loss_f:.6f} ({e_loss:.3g}, bound "
          f"{CO_LM_BOUNDS['loss']}), worst of {len(e_grad)} gradients "
          f"{worst[1]:.3g} ({worst[0]}; bound {CO_LM_BOUNDS['grad']}); "
          f"the hybridized gluon.Trainer loop, {CO['lm_train']} steps "
          f"captured (builds {builds}) bit for bit the eager ones "
          f"{not bad}, losses {[round(x, 4) for x in losses]}; step "
          f"captured {co_span(ms_foreach)} ms foreach against "
          f"{co_span(ms_fused)} ms fused over {CO['windows']} windows of "
          f"{CO['timed']} steps [{card}]", flush=True)
    if e_loss > CO_LM_BOUNDS["loss"] or worst[1] > CO_LM_BOUNDS["grad"] \
            or bad or builds != 1:
        fail(f"custom_onnx (c): loss {e_loss}, gradient {worst}, "
             f"mismatches {bad[:4]}, builds {builds}")
    del fe, fu, trainers, tr, ftr
    return dict(loss_rel=e_loss, grad_worst=worst[1], grad_worst_leaf=worst[0],
                identical=not bad, builds=builds, losses=losses,
                foreach_ms=ms_foreach, fused_ms=ms_fused)


def co_loops(card):
    """(d): while_loop and cond with array predicates on the card against
    the CPU: eagerly on NDArrays (and false on entry), under record() with
    the gradient, and in a hybridized block, where each call is an eager
    entry counted in custom_eager; relative L2 within CO_CARD_CPU."""
    from mxnet_tpu_torch import autograd, cpu, gluon, gpu, nd
    from mxnet_tpu_torch.contrib import ndarray as C
    from mxnet_tpu_torch.gluon import block as gblock

    w = CO["loop_width"]

    class Loops(gluon.HybridBlock):
        def __init__(self):
            super().__init__()
            self.fc = gluon.nn.Dense(w, in_units=w)

        def hybrid_forward(self, F, x):
            outs, fin = F.contrib.while_loop(
                lambda h, i: i < 3,
                lambda h, i: (self.fc(h), (F.tanh(self.fc(h)), i + 1)),
                [x, x.new_zeros((1,))], max_iterations=5)
            return F.contrib.cond(fin[0].sum() > 0,
                                  lambda: outs.sum(0) + fin[0],
                                  lambda: outs.sum(0) - fin[0])

    gen = torch.Generator().manual_seed(24)
    x = torch.randn(8, w, generator=gen)
    ref = Loops()
    ref.initialize(ctx=cpu(), seed=6)
    vals = {k: t.detach().clone() for k, t in ref.state_dict().items()}
    got = {}
    for tag, ctx in (("card", gpu(0)), ("cpu", cpu())):
        xs = nd.NDArray(x.to(ctx.torch_device))
        i0 = nd.NDArray(torch.zeros(1, device=ctx.torch_device))
        outs, fin = C.while_loop(lambda i: i < 4, lambda i: (i * 2, i + 1),
                                 [i0], max_iterations=6)
        e_outs, e_fin = C.while_loop(lambda i: i < 0,
                                     lambda i: (xs * i, i + 1), [i0],
                                     max_iterations=3)
        picked = C.cond(xs.sum() > 0, lambda: xs * 2, lambda: xs * 3)
        net = Loops()
        net.initialize(ctx=ctx)
        gluon.load_numpy_params(net, {k: v.to(ctx.torch_device, copy=True)
                                      for k, v in vals.items()})
        with autograd.record():
            eager = net(xs)
            (eager ** 2).sum().backward()
        g_eager = net.fc.weight.grad()._data.detach().double().cpu()
        net.hybridize()
        c0 = gblock.cached_op_stats()["custom_eager"]
        hy = net(xs)
        with autograd.record():
            hy2 = net(xs)
            (hy2 ** 2).sum().backward()
        counted = gblock.cached_op_stats()["custom_eager"] - c0
        got[tag] = {k: v._data.detach().double().cpu() for k, v in dict(
            outs=outs, fin=fin[0], empty=e_outs, empty_fin=e_fin[0],
            picked=picked, eager=eager, hybrid=hy, hybrid_rec=hy2,
            grad_hybrid=net.fc.weight.grad()).items()}
        got[tag].update(grad=g_eager, counted=counted)
    c, h = got["card"], got["cpu"]
    worst = 0.0
    for k in ("outs", "fin", "empty", "empty_fin", "picked", "eager",
              "hybrid", "hybrid_rec", "grad", "grad_hybrid"):
        # all-zero references (the false-on-entry buffers) by the norm
        worst = max(worst, rel_l2(c[k], h[k]) if h[k].any()
                    else float(c[k].norm()))
    exact = c["outs"].flatten().tolist() == [0, 2, 4, 6, 0, 0] \
        and c["fin"].tolist() == [4.0] and not c["empty"].any() \
        and c["empty"].shape == (3, 8, w) and c["empty_fin"].tolist() == [0.0]
    print(f"custom_onnx (d): while_loop (4 of max 6 iterations, and false on "
          f"entry: zero rows, the loop variable unchanged) and cond on "
          f"array predicates, eagerly, under record() and in a hybridized "
          f"block ({w} wide): card against cpu worst relative L2 "
          f"{worst:.3g} (bound {CO_CARD_CPU}); the padded rows and the "
          f"false-on-entry case exact {exact}; custom_eager {c['counted']} "
          f"for 2 hybridized calls [{card}]", flush=True)
    if worst > CO_CARD_CPU or not exact or c["counted"] != 2 \
            or h["counted"] != 2:
        fail(f"custom_onnx (d): worst {worst}, exact {exact}, counted "
             f"{c['counted']} / {h['counted']}")
    return dict(worst_rel=worst, exact=exact, custom_eager=c["counted"])


def phase_custom_onnx(card):
    """Phase 20: (a) the symbolic ResNet-50 through ONNX and back, (b) a
    Custom softmax head at full width and a host-style Custom op in a
    hybridized block, (c) the PTB-medium foreach LSTM against the fused
    RNN op, (d) while_loop and cond on the card."""
    import gc

    from mxnet_tpu_torch import sym

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    marks = [("start", t0)]
    net = resnet50_v1_sym(sym, classes=CO["classes"])
    w_args, w_aux, origin = co_weights(net)
    res = {"weights": origin}
    res["onnx"] = co_onnx(card, net, w_args, w_aux)
    marks.append(("a", time.perf_counter()))
    res["custom"] = co_custom(card, net, w_args, w_aux)
    marks.append(("b", time.perf_counter()))
    del w_args, w_aux
    gc.collect()
    torch.cuda.empty_cache()
    res["lm"] = co_lm(card)
    marks.append(("c", time.perf_counter()))
    gc.collect()
    res["loops"] = co_loops(card)
    marks.append(("d", time.perf_counter()))
    gc.collect()
    torch.cuda.empty_cache()
    res["seconds"] = time.perf_counter() - t0
    print(f"custom_onnx: phase 20 took {res['seconds']:.1f} s ("
          + ", ".join(f"{b[0]} {b[1] - a[1]:.1f} s"
                      for a, b in zip(marks, marks[1:])) + ")", flush=True)
    print(f"custom_onnx: {json.dumps(res, default=str)}", flush=True)
    return res


# ---------------------------------------------------------------------------
# phase 21: runtime, storage, initialize, rtc, the profiler and its device
# trace, Monitor, visualization, test_utils, and the BERT and
# Transformer-NMT example scripts
# ---------------------------------------------------------------------------

I9 = dict(live_mib=256, op_reps=5, trace_replays=2, fit_batch=64,
          fit_batches=4, monitor_interval=2, int8_timed=5)
I9_RTOL = 1e-4       # (d): check_consistency's rtol (the JAX default) ...
I9_REL_ATOL = 1e-4   # ... and atol, of the case's largest |CPU|:
# fp32 sums over 12,544 positions (a weight gradient at 56x56, N 4) move
# by about 1e-5 of that magnitude between two summation orders
I9_OPS = ("broadcast_add", "broadcast_mul", "relu", "dot", "softmax", "exp",
          "sum")
I9_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                      "chip_smoke_item9")
I9_POOL_RESERVE = 25  # (a): the child's MXNET_GPU_MEM_POOL_RESERVE
# (a): a process that keeps I9_POOL_RESERVE percent of the card out of the
# caching allocator through the knob and preallocates the rest through
# storage.configure, then makes one NDArray on the card
I9_POOL_CHILD = """
import json, torch
from mxnet_tpu_torch import gpu, nd, storage
storage.configure(preallocate=True)
x = nd.ones((4,), ctx=gpu(0))
total = torch.cuda.mem_get_info(0)[1]
reserved = torch.cuda.memory_reserved(0)
y = torch.empty(total // 2, dtype=torch.uint8, device="cuda:0")
grown = torch.cuda.memory_reserved(0) - reserved
del y
try:
    torch.empty(total * 4 // 5, dtype=torch.uint8, device="cuda:0")
    refused = False
except torch.OutOfMemoryError:
    refused = True
print(json.dumps(dict(total=total, reserved=reserved, grown=grown,
                      refused=refused, x=float(x.sum().asscalar()))))
"""


def i9_runtime(card):
    """(a): Features, memory_info against torch.cuda.mem_get_info,
    live_array_bytes around a 256 MiB NDArray, configure after CUDA's
    initialisation, the signal-handler knob, mx.rtc."""
    from mxnet_tpu_torch import MXNetError, gpu, initialize, nd, rtc, runtime
    from mxnet_tpu_torch import storage
    from mxnet_tpu_torch.util import env

    feats = {k: f.enabled for k, f in runtime.Features().items()}
    mib = 1 << 20
    free, total = storage.memory_info(gpu(0))
    tfree, ttotal = torch.cuda.mem_get_info(0)
    _, b0 = storage.live_array_bytes(gpu(0))
    x = nd.zeros((I9["live_mib"] * mib // 4,), ctx=gpu(0))
    _, b1 = storage.live_array_bytes(gpu(0))
    del x
    _, b2 = storage.live_array_bytes(gpu(0))
    raised = {}
    for what, call in (
            ("configure", lambda: storage.configure(pool_reserve_pct=10)),
            ("rtc", lambda: rtc.CudaModule(
                'extern "C" __global__ void k() {}'))):
        try:
            call()
            raised[what] = False
        except MXNetError:
            raised[what] = True
    sig = initialize.signal_handlers_enabled()
    knob = env.get_bool("MXNET_USE_SIGNAL_HANDLER")
    t0 = time.perf_counter()
    child = subprocess.run(
        [sys.executable, "-c", I9_POOL_CHILD], capture_output=True,
        text=True, timeout=300, cwd=os.path.dirname(os.path.abspath(__file__)),
        env=dict(os.environ, MXNET_GPU_MEM_POOL_RESERVE=str(I9_POOL_RESERVE)))
    pool = json.loads(child.stdout.strip().splitlines()[-1]) \
        if child.returncode == 0 else {"rc": child.returncode,
                                       "stderr": child.stderr[-2000:]}
    pool["seconds"] = time.perf_counter() - t0
    limit = (100 - I9_POOL_RESERVE) * ttotal // 100
    pool_ok = (child.returncode == 0 and pool["total"] == ttotal
               and ttotal // 2 <= pool["reserved"] <= limit
               and pool["grown"] == 0 and pool["refused"] and pool["x"] == 4)
    res = dict(features=feats, memory_info=(free, total),
               mem_get_info=(tfree, ttotal), live_rise=b1 - b0,
               live_fall=b1 - b2, raised=raised, signal_handlers=sig,
               knob=knob, pool=pool)
    print(f"item9 (a): Features {json.dumps(feats)}", flush=True)
    print(f"item9 (a): memory_info(gpu(0)) free {free} / total {total} "
          f"bytes, torch.cuda.mem_get_info {tfree} / {ttotal}; "
          f"live_array_bytes +{(b1 - b0) / mib:.1f} MiB for a "
          f"{I9['live_mib']} MiB NDArray, -{(b1 - b2) / mib:.1f} MiB after "
          f"del; configure after CUDA init raised {raised['configure']}; "
          f"rtc.CudaModule raised {raised['rtc']}; signal handlers {sig} "
          f"(MXNET_USE_SIGNAL_HANDLER {knob}) [{card}]", flush=True)
    print(f"item9 (a): a child with MXNET_GPU_MEM_POOL_RESERVE="
          f"{I9_POOL_RESERVE} and storage.configure(preallocate=True) "
          f"({pool['seconds']:.1f} s): {json.dumps(pool)}; reserved at its "
          f"first CUDA use within [total / 2, {100 - I9_POOL_RESERVE}% of "
          f"total = {limit}], a half-card tensor served from it, "
          f"{4 / 5:.0%} of the card refused: {pool_ok} [{card}]", flush=True)
    ok = (pool_ok and feats["CUDA"] and feats["CUDNN"] and feats["NCCL"]
          and feats["DIST_KVSTORE"] and total == ttotal
          and abs(free - tfree) <= 2 * mib
          and b1 - b0 >= I9["live_mib"] * mib
          and b1 - b2 >= I9["live_mib"] * mib
          and all(raised.values()) and sig == knob)
    if not ok:
        fail(f"item9 (a): {json.dumps(res, default=str)}")
    return res


def i9_trace_kernels(path):
    """The events and the kernel events of a chrome trace written by
    stop_xla_trace."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return events, [e for e in events if e.get("cat") == "kernel"]


@contextlib.contextmanager
def i9_trace(name, out):
    """profiler.start_xla_trace into I9_DIR/name around the work it
    holds; out["path"] is the file stop_xla_trace wrote."""
    from mxnet_tpu_torch import profiler

    profiler.start_xla_trace(os.path.join(I9_DIR, name))
    try:
        yield
    finally:
        out["path"] = profiler.stop_xla_trace()


def i9_by_range(events, kernels, prefix):
    """{range name: its kernels} for the profiler ranges named prefix +
    name: each kernel goes to the range its launch (the CUDA runtime or
    driver call of the same correlation id) was issued in; "" holds the
    kernels of no such range."""
    import bisect

    launch = {e["args"]["correlation"]: e["ts"] for e in events
              if e.get("cat") in ("cuda_runtime", "cuda_driver")
              and "correlation" in e.get("args", {})}
    spans = sorted((e["ts"], e["ts"] + e["dur"], e["name"][len(prefix):])
                   for e in events if e.get("cat") == "user_annotation"
                   and e.get("name", "").startswith(prefix))
    starts = [sp[0] for sp in spans]
    out = {}
    for k in kernels:
        t = launch.get(k.get("args", {}).get("correlation"))
        i = bisect.bisect_right(starts, t) - 1 if t is not None else -1
        name = spans[i][2] if i >= 0 and t <= spans[i][1] else ""
        out.setdefault(name, []).append(k)
    return out


@contextlib.contextmanager
def i9_op_ranges(exe):
    """Each op of a bound executor's graph runs inside a profiler range
    named after it ("op::<name>"), for the device-time split of (b)."""
    ops = {id(op): op for _, op, _ in exe._plan if op is not None}
    saved = {k: op.fn for k, op in ops.items()}
    for op in ops.values():
        def ranged(*a, _fn=op.fn, _name=op.name, **kw):
            with torch.profiler.record_function(f"op::{_name}"):
                return _fn(*a, **kw)
        op.fn = ranged
    try:
        yield
    finally:
        for k, op in ops.items():
            op.fn = saved[k]


def i9_split_by_op(events, kernels):
    """Device ms of the int8 forward's kernels by the op they ran for:
    kernel 7 apart from the rest of quantized_conv (the activations'
    NCHW->NHWC permute and the weight layout), then quantize, requantize,
    dequantize and the rest."""
    split = {}
    for op, ks in i9_by_range(events, kernels, "op::").items():
        for k in ks:
            if "int8_conv" in k["name"]:
                cat = "kernel 7"
            elif "requantize" in op:
                cat = "requantize"
            elif "dequantize" in op:
                cat = "dequantize"
            elif "quantized_conv" in op or "quantized_fully" in op:
                cat = "int8 conv wrapper (permute, weight layout)"
            elif "quantize" in op:
                cat = "quantize"
            else:
                cat = "rest"
            split[cat] = split.get(cat, 0.0) + k["dur"] / 1e3
    return split


def i9_int8_forward(dev):
    """Phase 19 (c)'s captured int8 forward, or (phase 21 alone) phase
    11's ResNet-50 from seeded weights quantized with naive calibration
    over one batch of 64."""
    exe = KEEP.pop("int8_forward", None)
    if exe is not None:
        return exe, "phase 19's"
    from mxnet_tpu_torch import nd, sym
    from mxnet_tpu_torch.contrib.quantization import quantize_model

    net = resnet50_v1_sym(sym)
    w_args, w_aux, _ = co_weights(net)
    xs, _ = sym_images(Q_BATCH, 19)
    args = {k: nd.array(v.numpy(), ctx=dev) for k, v in w_args.items()}
    aux = {k: nd.array(v.numpy(), ctx=dev) for k, v in w_aux.items()}
    qsym, qargs, qaux = quantize_model(net, args, aux, calib_mode="naive",
                                       calib_data=[nd.array(xs, ctx=dev)])
    exe = qsym.get_internals()["fc_output"].bind(
        dev, dict(qargs, data=nd.array(xs, ctx=dev)), grad_req="null",
        aux_states=qaux)
    return exe, "seeded, naive"


def i9_profiler(card, dev):
    """(b): the op records of a fixed list of nd calls; the device trace
    around phase 4's captured ResNet-50 forward (kernel 1 named 104
    times) with the host records on; the int8 ResNet-50's device time by
    kernel (one captured replay) and by op (one eager forward)."""
    from mxnet_tpu_torch import _graphs as mxg
    from mxnet_tpu_torch import nd, profiler
    from mxnet_tpu_torch.gluon import block as gblock

    os.makedirs(I9_DIR, exist_ok=True)
    res = {}
    profiler.set_config(filename=os.path.join(I9_DIR, "ops.json"))
    gen = torch.Generator(device=dev).manual_seed(21)
    a = nd.NDArray(torch.randn(1024, 1024, device=dev, generator=gen))
    profiler.start()
    for _ in range(I9["op_reps"]):
        nd.exp(nd.softmax(nd.dot(nd.relu((a + a) * a), a))).sum()
    profiler.stop()
    torch.cuda.synchronize()
    rows = {ln.split()[0]: int(ln.split()[1])
            for ln in profiler.dumps(reset=True).splitlines()[1:]}
    with open(profiler.dump(finished=True)) as f:
        n_events = len(json.load(f)["traceEvents"])
    ok = rows == {n: I9["op_reps"] for n in I9_OPS} \
        and n_events == len(I9_OPS) * I9["op_reps"] \
        and profiler.num_events() == 0
    res["ops"] = dict(rows=rows, events=n_events)
    print(f"item9 (b): {I9['op_reps']} x {len(I9_OPS)} nd calls on the "
          f"card: dumps() rows {rows}; dump() JSON {n_events} events",
          flush=True)

    # phase 4's served net from its seed (a net kept on the card since
    # phase 4 would change the allocator's layout under later phases'
    # byte counts), captured anew
    net = build_net("bfloat16", seed=0)
    xb = torch.rand(BATCH, 224, 224, 3, generator=torch.Generator(
        ).manual_seed(7)).to(dev, torch.bfloat16)
    os.environ["MXNET_FUSED_CONVBN"] = "1"

    def fwd():
        with torch.inference_mode():
            return net(xb)
    ref = fwd()
    fwd()
    torch.cuda.synchronize()
    builds0 = gblock.cached_op_stats()["count"]
    reset_kernel_counts()
    profiler.start()
    trace, outs = {}, []
    with i9_trace("served", trace):
        for i in range(I9["trace_replays"]):
            with torch.profiler.record_function(f"replay::{i}"):
                outs.append(fwd())
    path = trace["path"]
    profiler.stop()
    host_records = profiler.num_events()
    profiler.dump(finished=True)
    launches = kernel_counts()["k1"]
    builds = gblock.cached_op_stats()["count"] - builds0
    events, kern = i9_trace_kernels(path)
    named = sum(1 for e in kern if "conv_unit_" in e["name"])
    warm = sum(1 for e in kern if "spin_kernel" in e["name"])
    per = {k: (len(v), sum(1 for e in v if "conv_unit_" in e["name"]))
           for k, v in sorted(i9_by_range(events, kern,
                                          "replay::").items())}
    same = all(torch.equal(o, ref) for o in outs)
    want = 52 * I9["trace_replays"]
    res["served"] = dict(trace=path, k1_named=named, k1_launches=launches,
                         builds=builds, host_records=host_records,
                         identical=same, kernels=len(kern),
                         by_replay=per, warm_up_kernels=warm)
    print(f"item9 (b): start_xla_trace around {I9['trace_replays']} "
          f"replays of phase 4's served resnet-50 bf16 batch {BATCH} "
          f"forward (rebuilt from its seed, captured; host records on): "
          f"{len(kern)} kernel events, kernel 1 named {named} times "
          f"(counter {launches}, want {want}); (kernels, kernel 1) by "
          f"replay {per} (\"\" = outside them); warm-up kernels left "
          f"in the file {warm}; new builds {builds}; host op records "
          f"during replays {host_records}; "
          f"outputs bit for bit the untraced replay's {same} -> {path}",
          flush=True)
    ok = ok and named == want and launches == want and builds == 0 \
        and same and warm == 0
    del net, xb, outs, ref

    qexe, qorigin = i9_int8_forward(dev)
    qexe.forward()
    torch.cuda.synchronize()
    q_ms = time_ms(lambda: qexe.forward(), iters=I9["int8_timed"],
                   warmup=1)
    trace = {}
    with i9_trace("int8", trace):
        qexe.forward()
    _, kern = i9_trace_kernels(trace["path"])
    busy = sum(e["dur"] for e in kern) / 1e3
    by_name = {}
    for e in kern:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"] / 1e3
    k7 = sum(v for k, v in by_name.items() if "int8_conv" in k)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    busy = busy or math.nan  # a trace without device time prints nan
    print(f"item9 (b): {qorigin} int8 resnet-50 batch {Q_BATCH}: "
          f"{q_ms:.2f} ms a captured forward (CUDA events over "
          f"{I9['int8_timed']} replays); one traced replay: {len(kern)} "
          f"kernels, {busy:.2f} ms device time (names and shares only, "
          f"ROADMAP B item 6), kernel 7 {k7 / busy:.1%} [{card}]",
          flush=True)
    for k, v in top:
        print(f"    {v / busy:6.1%} {v:8.3f} ms  {k[:100]}", flush=True)
    with i9_op_ranges(qexe), mxg.no_capture():
        qexe.forward()
        torch.cuda.synchronize()
        with i9_trace("int8_eager", trace):
            qexe.forward()
    events, kern = i9_trace_kernels(trace["path"])
    split = i9_split_by_op(events, kern)
    ebusy = sum(split.values()) or math.nan
    print(f"item9 (b): the same forward eagerly, device time by op "
          f"({ebusy:.2f} ms in {len(kern)} kernels): " + ", ".join(
              f"{k} {v:.3f} ms ({v / ebusy:.1%})" for k, v in sorted(
                  split.items(), key=lambda kv: -kv[1])) + f" [{card}]",
          flush=True)
    res["int8"] = dict(origin=qorigin, captured_ms=q_ms, replay_busy_ms=busy,
                       kernel7_share=k7 / busy, top=top, eager_split=split,
                       eager_busy_ms=ebusy)
    ok = ok and k7 > 0 and all(k in split for k in (
        "kernel 7", "quantize", "requantize", "dequantize"))
    del qexe
    if not ok:
        fail(f"item9 (b): {json.dumps(res, default=str)}")
    return res


def i9_monitor(card, dev):
    """(c): Module.fit of phase 11's ResNet-50 symbol (SGD as phase 11,
    batch 64, 4 batches) under cudnn.deterministic with and without
    Monitor(interval=2): final weights bit for bit, no more builds, every
    stat finite and equal to stat_func on the array read right after its
    step; print_summary's total and plot_network's nodes."""
    import gc
    import io as _io
    import re

    import numpy as np

    from mxnet_tpu_torch import gpu, monitor, sym, visualization
    from mxnet_tpu_torch.io import NDArrayIter
    from mxnet_tpu_torch.module import Module
    from mxnet_tpu_torch.ndarray import NDArray
    from mxnet_tpu_torch.optimizer import fused

    class Held(monitor.Monitor):
        """Keeps toc's rows; after each tapped step, every stat against
        stat_func applied to the executor's own array."""

        def __init__(self, interval):
            super().__init__(interval)
            self.rows, self.held = [], []

        def toc_print(self):
            rows = self.toc()
            if rows:
                mod = self._modules[0]
                ex = mod._exec_group.execs[0]
                direct = dict(ex.arg_dict)
                direct.update((n + "_grad", g) for n, g in
                              zip(ex.arg_names, ex.grad_arrays)
                              if g is not None)
                direct.update(zip(mod.output_names, ex.outputs))
                self.held.append(all(
                    str(self.stat_func(direct[k]).asnumpy()) == v
                    for _, k, v in rows))
            self.rows.extend(rows)

    net = resnet50_v1_sym(sym)
    w_args, w_aux, origin = co_weights(net)
    b = I9["fit_batch"]
    x, y = co_images(b * I9["fit_batches"], 24)
    runs = {}
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for tag in ("plain", "monitored"):
            mon = Held(I9["monitor_interval"]) if tag == "monitored" \
                else None
            mod = Module(net, context=gpu(0))
            e0 = sym.executor_stats()["count"]
            f0 = fused.compile_stats()["count"]
            t0 = time.perf_counter()
            mod.fit(NDArrayIter(x, y, batch_size=b, shuffle=False),
                    num_epoch=1, optimizer="sgd",
                    optimizer_params=dict(SYM_OPT, rescale_grad=1.0 / b),
                    arg_params={k: NDArray(v) for k, v in w_args.items()},
                    aux_params={k: NDArray(v) for k, v in w_aux.items()},
                    monitor=mon)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            wa, wx = mod.get_params()
            runs[tag] = dict(
                seconds=secs, mon=mon,
                builds=(sym.executor_stats()["count"] - e0,
                        fused.compile_stats()["count"] - f0),
                weights={k: v._data.clone() for k, v in
                         list(wa.items()) + list(wx.items())})
            del mod, wa, wx
            gc.collect()
    finally:
        torch.backends.cudnn.deterministic = det
    mon = runs["monitored"]["mon"]
    wp, wm = runs["plain"]["weights"], runs["monitored"]["weights"]
    same = sorted(wp) == sorted(wm) and all(torch.equal(wp[k], wm[k])
                                            for k in wp)
    finite = bool(mon.rows) and all(np.isfinite(float(v))
                                    for _, _, v in mon.rows)
    steps = sorted({n for n, _, _ in mon.rows})
    n_params = sum(1 for n in net.list_arguments()
                   if n not in ("data", "softmax_label"))
    rows_ok = len(mon.rows) == len(steps) * (2 * n_params + 1) \
        and steps == [1, 3]
    builds = {t: r["builds"] for t, r in runs.items()}
    res = dict(weights=origin, seconds={t: r["seconds"]
                                        for t, r in runs.items()},
               builds=builds, identical=same, finite=finite,
               rows=len(mon.rows), steps=steps, held=mon.held)
    print(f"item9 (c): resnet50_v1 symbol ({origin} weights) Module.fit, "
          f"{I9['fit_batches']} batches of {b}, cudnn.deterministic: "
          f"{runs['plain']['seconds']:.2f} s plain, "
          f"{runs['monitored']['seconds']:.2f} s with "
          f"Monitor(interval={I9['monitor_interval']}) ({len(mon.rows)} "
          f"stats at steps {steps}, all finite {finite}, equal to stat_func "
          f"on the array read after the step {mon.held}); final weights "
          f"bit for bit {same}; builds (executor, update) {builds} "
          f"[{card}]", flush=True)
    ok = same and finite and rows_ok and mon.held == [True, True] \
        and builds["monitored"] == builds["plain"]

    shape = {"data": (b, 3, 224, 224)}
    buf = _io.StringIO()
    with contextlib.redirect_stdout(buf):
        visualization.print_summary(net, shape=shape)
    m = re.search(r"Total params: (\d+)", buf.getvalue())
    total = int(m.group(1)) if m else None
    arg_shapes, _, aux_shapes = net.infer_shape(**shape)
    sizes = {n: int(np.prod(s)) for n, s in
             zip(net.list_arguments() + net.list_auxiliary_states(),
                 arg_shapes + aux_shapes)}
    trained = sum(sizes[n] for n in net.list_arguments()
                  if n not in ("data", "softmax_label"))
    want = sum(v for n, v in sizes.items() if n != "data")
    dot = visualization.plot_network(net, title="resnet50_v1")
    dot = dot if isinstance(dot, str) else dot.source
    nodes = json.loads(net.tojson())["nodes"]
    shown = [n["name"] for n in nodes if n["op"] != "null" or not
             n["name"].endswith(("_weight", "_bias", "_gamma", "_beta",
                                 "_moving_mean", "_moving_var", "_label"))]
    missing = [n for n in shown if f'"{n}" [label=' not in dot]
    res["summary"] = dict(total=total, want=want, trained=trained,
                          dot_nodes=len(shown), missing=missing)
    print(f"item9 (c): print_summary total {total} (the inferred shapes' "
          f"parameters, moving statistics and label: {want}; trained "
          f"parameters {trained:,}); plot_network DOT ({len(dot)} chars) "
          f"has all {len(shown)} non-parameter nodes: {not missing}",
          flush=True)
    ok = ok and total == want and trained == 25_557_032 and not missing
    if not ok:
        fail(f"item9 (c): {json.dumps(res, default=str)}")
    return res


def i9_card_cpu(f, loc, grad):
    """The arrays check_consistency compares, from one run on gpu(0) and
    one on cpu(0) made the same way (the outputs and, with `grad`, the
    inputs' gradients of outs[0].sum() in training mode): each array's
    largest |card - CPU| over its largest |CPU|, and the largest |CPU| of
    them all."""
    import numpy as np

    from mxnet_tpu_torch import autograd, cpu, gpu, nd
    from mxnet_tpu_torch import test_utils as tu

    runs = []
    for ctx in (gpu(0), cpu(0)):
        args = [nd.array(a, ctx=ctx) for a in loc]
        if grad:
            for a in args:
                a.attach_grad()
            with autograd.record():
                outs, _ = tu._run_forward(f, args, train=True)
                loss = outs[0].sum()
            loss.backward()
            arrays = outs + [a.grad for a in args if a.grad is not None]
        else:
            arrays = tu._run_forward(f, args)[0]
        runs.append([tu._as_numpy(a).astype(np.float64) for a in arrays])
    errs, scale = [], 0.0
    for a, b in zip(*runs):
        mag = float(np.abs(b).max()) if b.size else 0.0
        d = float(np.abs(a - b).max()) if b.size else 0.0
        errs.append(d / mag if mag else d)
        scale = max(scale, mag)
    return errs, scale


def i9_consistency(card):
    """(d): check_consistency over [gpu(0), cpu(0)] at ResNet-50 and
    BERT-base shapes (kernels 1, 2 and 5 against their plain versions on
    the CPU), check_numeric_gradient on gpu(0)."""
    import numpy as np

    from mxnet_tpu_torch import cpu, gpu, nd, sym
    from mxnet_tpu_torch import test_utils as tu

    rng = np.random.default_rng(25)

    def r(*shape, loc=0.0, scale=1.0):
        return (loc + scale * rng.standard_normal(shape)).astype(np.float32)

    n, hw, c = 4, 56, 64
    he = (2.0 / (9 * c)) ** 0.5
    unit = dict(kernel=(3, 3), pad=(1, 1), act_in=True, want_stats=True)

    def unit_loc():
        return [r(n, hw, hw, c), r(c, c, 3, 3, scale=he),
                r(c, loc=1.0, scale=0.1), r(c, scale=0.1)]

    # BatchNorm's and softmax's outputs sum to constants of gamma, beta
    # and the input, so their gradients under check_consistency's head,
    # outs[0].sum(), are zero up to rounding: these cases project their
    # output on a fixed random tensor first
    proj_bn, proj_sm = r(n, 256, hw, hw), r(8, 12, 128, 128)

    def bn(x, g, bb):
        ch = x.shape[1]
        y = nd.BatchNorm(x, g, bb, nd.zeros(ch, ctx=x.ctx),
                         nd.ones(ch, ctx=x.ctx))
        return y * nd.array(proj_bn, ctx=x.ctx)

    def softmax(x):
        return nd.softmax(x) * nd.array(proj_sm, ctx=x.ctx)
    cases = [
        # a symbol's executor takes its gradients inside the training
        # forward, which check_consistency does not compare: its outputs
        # only, from the inference forward (kernel 1)
        ("FusedConvUnit (sym)", sym.FusedConvUnit(
            sym.var("data"), sym.var("weight"), sym.var("in_scale"),
            sym.var("in_bias"), sym.var("shift"), **unit),
         unit_loc() + [r(c, scale=0.1)], False, {"k1"}),
        ("FusedConvUnit (nd, backward)",
         lambda x, w, s, bb: nd.FusedConvUnit(x, w, s, bb, **unit),
         unit_loc(), True, {"k1", "k2"}),
        ("Convolution", lambda x, w: nd.Convolution(
            x, w, kernel=(3, 3), pad=(1, 1), num_filter=c, no_bias=True),
         [r(n, c, hw, hw), r(c, c, 3, 3, scale=he)], True, set()),
        ("BatchNorm (train)", bn, [r(n, 256, hw, hw), r(256, loc=1.0,
                                                          scale=0.1),
                                   r(256, scale=0.1)], True, set()),
        ("LayerNorm", lambda x, g, bb: nd.LayerNorm(x, g, bb),
         [r(8, 128, 768), r(768, loc=1.0, scale=0.1), r(768, scale=0.1)],
         True, set()),
        ("softmax", softmax, [r(8, 12, 128, 128)], True, set()),
        ("dot_product_attention", lambda q, k, v: nd.dot_product_attention(
            q, k, v, num_heads=12), [r(4, 128, 768) for _ in range(3)],
         True, {"k5"}),
    ]
    res, ok = {}, True
    bwd = os.environ.get("MXNET_FUSED_CONVBN_BWD")
    os.environ["MXNET_FUSED_CONVBN_BWD"] = "1"
    try:
        for tag, f, loc, grad, want in cases:
            errs, scale = i9_card_cpu(f, loc, grad)
            atol = I9_REL_ATOL * scale
            reset_kernel_counts()
            try:
                tu.check_consistency(f, [gpu(0), cpu(0)], loc, rtol=I9_RTOL,
                                     atol=atol, grad=grad)
                passed = True
            except AssertionError as e:
                passed = False
                print(f"item9 (d): {tag}: {e}", flush=True)
            counts = {k: v for k, v in kernel_counts().items() if v}
            worst = max(errs)
            res[tag] = dict(passed=passed, worst=worst, compared=len(errs),
                            atol=atol, launches=counts)
            print(f"item9 (d): check_consistency {tag} [gpu(0), cpu(0)] at "
                  f"{[a.shape for a in loc]} (rtol {I9_RTOL}, atol {atol:.3g}"
                  f" = {I9_REL_ATOL} of the CPU's largest magnitude): passed "
                  f"{passed}; of {len(errs)} arrays the largest error "
                  f"{worst:.3g} of that array's largest |CPU| (bound "
                  f"{I9_RTOL + I9_REL_ATOL}); card launches {counts} "
                  f"[{card}]", flush=True)
            ok = ok and passed and worst <= I9_RTOL + I9_REL_ATOL \
                and set(counts) == want
    finally:
        if bwd is None:
            del os.environ["MXNET_FUSED_CONVBN_BWD"]
        else:
            os.environ["MXNET_FUSED_CONVBN_BWD"] = bwd
    np.random.seed(26)
    try:
        tu.check_numeric_gradient(
            lambda x, w, bb: nd.tanh(nd.FullyConnected(x, w, bb,
                                                       num_hidden=6)),
            [r(4, 8), r(6, 8, scale=0.3), r(6, scale=0.1)], ctx=gpu(0))
        passed = True
    except AssertionError as e:
        passed = False
        print(f"item9 (d): check_numeric_gradient: {e}", flush=True)
    res["numeric_gradient"] = dict(passed=passed)
    print(f"item9 (d): check_numeric_gradient FullyConnected -> tanh on "
          f"gpu(0) (its rtol 1e-2): passed {passed} [{card}]", flush=True)
    ok = ok and passed
    if not ok:
        fail(f"item9 (d): {json.dumps(res, default=str)}")
    return res


def i9_state_tensors(tree):
    from mxnet_tpu_torch.ndarray import NDArray

    if isinstance(tree, NDArray):
        return [tree._data]
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (list, tuple)):
        return [t for s in tree for t in i9_state_tensors(s)]
    if isinstance(tree, dict):
        return [t for s in tree.values() for t in i9_state_tensors(s)]
    return []


def i9_examples(card, dev):
    """(e): examples/bert_pretrain.py at its defaults (BERT-base, batch 8
    x 128, 8 steps, fp32) and examples/transformer_nmt.py for one epoch
    (Transformer-base, batch 32, buckets 16-128, 6 steps), in process."""
    import gc

    from mxnet_tpu_torch.examples import bert_pretrain, transformer_nmt

    res, ok = {}, True
    for tag, script, argv, steps in (
            ("bert_pretrain", bert_pretrain, [], 8),
            ("transformer_nmt", transformer_nmt, ["--epochs", "1"], 6)):
        t0 = time.perf_counter()
        out = script.main(argv)
        secs = time.perf_counter() - t0
        params = [p.data()._data for p in out["net"].collect_params(
            ).values()]
        states = i9_state_tensors(out["trainer"]._updater.states)
        on_card = all(t.device == dev for t in params + states)
        losses = out["losses"]
        finite = len(losses) == steps and all(math.isfinite(v)
                                              for v in losses)
        tok = out["tokens_per_s"]
        res[tag] = dict(seconds=secs, losses=losses, step_ms=out["step_ms"],
                        tokens_per_s=tok, params=len(params),
                        states=len(states), on_card=on_card, finite=finite)
        print(f"item9 (e): {tag} {' '.join(argv)}: {len(losses)} steps in "
              f"{secs:.1f} s, losses {['%.4f' % v for v in losses]}, ms a "
              f"step {['%.1f' % v for v in out['step_ms']]}, tokens/s {tok}; "
              f"{len(params)} parameters and {len(states)} optimizer state "
              f"tensors all on {dev}: {on_card} [{card}]", flush=True)
        ok = ok and on_card and finite and bool(states)
        if tag == "bert_pretrain":
            ok = ok and losses[-1] < losses[0]
        del out, params, states
        gc.collect()
        torch.cuda.empty_cache()
    if not ok:
        fail(f"item9 (e): {json.dumps(res, default=str)}")
    return res


def phase_item9(card):
    """Phase 21: (a) runtime, storage, initialize, rtc; (b) the profiler
    and its device trace; (c) Monitor and visualization at ResNet-50's
    width; (d) test_utils on the card; (e) the example scripts."""
    import gc

    dev = torch.device("cuda", 0)
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    marks = [("start", t0)]
    res = {}
    for part, fn in (("a", lambda: i9_runtime(card)),
                     ("b", lambda: i9_profiler(card, dev)),
                     ("c", lambda: i9_monitor(card, dev)),
                     ("d", lambda: i9_consistency(card)),
                     ("e", lambda: i9_examples(card, dev))):
        res[part] = fn()
        marks.append((part, time.perf_counter()))
        gc.collect()
        torch.cuda.empty_cache()
    res["seconds"] = time.perf_counter() - t0
    print(f"item9: phase 21 took {res['seconds']:.1f} s ("
          + ", ".join(f"{b[0]} {b[1] - a[1]:.1f} s"
                      for a, b in zip(marks, marks[1:])) + ")", flush=True)
    print(f"item9: {json.dumps(res, default=str)}", flush=True)
    return res


# ---------------------------------------------------------------------------
# phase 22: MXNet's data-parallel API — gluon.Trainer(kvstore='dist_sync')
# ---------------------------------------------------------------------------

KV_BATCH = 32          # a rank's images
KV_STEPS = 2           # timed steps a case, after one warm-up
KV_TIMEOUT = 240.0     # s, the ranks' phase-22 work, their start included
KV_SECONDS = 90.0      # the phase's limit (ranks, reference, (b))
KV_2BIT = 0.5
# case -> (Trainer keywords besides kvstore='dist_sync', environment)
KV_CASES = {
    "update_on_kvstore": ({}, {}),
    "pushpull_fused": ({"update_on_kvstore": False}, {}),
    "spmd": ({"spmd": True, "update_on_kvstore": False}, {}),
    "2bit": ({"compression_params": {"type": "2bit",
                                     "threshold": KV_2BIT}}, {}),
    "spmd_int8": ({"spmd": True, "update_on_kvstore": False},
                  {"MXNET_COMM_QUANT": "int8", "MXNET_COMM_QUANT_EF": "1"}),
}
KV_EXACT = ("update_on_kvstore", "pushpull_fused", "spmd")
KV_MNIST_STEPS = 5
KV_MNIST_BOUND = 1e-5  # (b) one card: rel L2 of the weights, card vs CPU


def kv_batch(dev):
    """Phase 22's global batch: DP ranks x KV_BATCH images, seeded."""
    gen = torch.Generator().manual_seed(22)
    x = torch.rand(DP * KV_BATCH, 224, 224, 3, generator=gen)
    y = torch.randint(0, 1000, (DP * KV_BATCH,), generator=gen)
    return x.to(dev, torch.bfloat16), y.to(dev)


def kv_snapshot(net):
    return {k: v.detach().clone() for k, v in net.state_dict().items()}


def kv_restore(net, snap):
    with torch.no_grad():
        for k, v in net.state_dict().items():
            v.copy_(snap[k])


def kv_is_stat(k):
    return k.endswith(("running_mean", "running_var"))


def kv_gluon_step(net, trainer, x, y):
    """One step of MXNet's loop on a rank's half-batch; the gradients
    are rescaled by the global batch, as the sum runs over the ranks."""
    from mxnet_tpu_torch import autograd, gluon

    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    with autograd.record():
        loss = loss_fn(net(x), y)
    loss.backward()
    trainer.step(DP * KV_BATCH)


def kv_tree_bytes(s):
    if s is None:
        return 0
    if isinstance(s, (tuple, list)):
        return sum(kv_tree_bytes(x) for x in s)
    t = getattr(s, "_data", s)
    return t.numel() * t.element_size()


def kv_state_bytes(tr):
    """The optimizer-state bytes this rank holds (fp32 masters included)
    and, apart, the bytes of the residuals of compression or of
    MXNET_COMM_QUANT's error feedback."""
    u = tr._spmd_updater
    if u is not None:
        res = sum(x.numel() * x.element_size() for pairs in
                  u._qstate.values() for pr in pairs for x in pr)
        return dict(state_bytes=u.state_bytes(local=True),
                    residual_bytes=res, shard_factor=u.shard_factor())
    upd = tr._kvstore._updater if tr._update_on_kvstore else tr._updater
    comp = tr._kvstore._compression
    res = sum(r.numel() * r.element_size()
              for r in comp._residual.values()) if comp else 0
    return dict(state_bytes=sum(kv_tree_bytes(s) for k, s in
                                upd.states.items() if not isinstance(k, str)),
                residual_bytes=res, shard_factor=1)


def kv_plan(tr):
    u = tr._spmd_updater
    return dict(indices=list(u._plan_indices), nshard=u.nshard,
                buckets=[dict(pos=list(b.pos), offsets=list(b.offsets),
                              sizes=list(b.sizes), total=b.total)
                         for b in u._plan.buckets])


def kv_rank(out_dir, devices):
    """Phase 22's work in one rank of kv_shard_rank (its rank from
    DMLC_WORKER_ID, its process group joined): full-width ResNet-50 v1
    fused, bf16, from
    build_net's seeded weights, trained on its half of the global batch
    through gluon.Trainer(kvstore='dist_sync') in each case of KV_CASES:
    one warm-up, then KV_STEPS steps with the launch counters reset just
    before and read just after; ms a step, launches, state bytes; rank 0
    saves its weights and statistics, rank 1 its statistics and the
    digests of its weights."""
    from mxnet_tpu_torch import gluon, nd, parallel

    rank = int(os.environ["DMLC_WORKER_ID"])
    dev = torch.device(devices[rank])
    torch.backends.cudnn.deterministic = True
    set_knobs(True, True)
    net = build_net("bfloat16", 0, dev)
    snap = kv_snapshot(net)
    xg, yg = kv_batch(dev)
    half = slice(rank * KV_BATCH, (rank + 1) * KV_BATCH)
    x, y = nd.NDArray(xg[half].contiguous()), nd.NDArray(yg[half].contiguous())
    res = {"rank": rank, "cases": {}}
    for name, (kw, env) in KV_CASES.items():
        os.environ.update(env)
        kv_restore(net, snap)
        tr = gluon.Trainer(net.collect_params(), "sgd", dict(TRAIN_OPT),
                           kvstore="dist_sync", **kw)
        kv_gluon_step(net, tr, x, y)
        torch.cuda.synchronize()
        reset_kernel_counts()
        ms = []
        for _ in range(KV_STEPS):
            t0 = time.perf_counter()
            kv_gluon_step(net, tr, x, y)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        counts = kernel_counts()
        rec = dict(ms=ms, fwd=counts["k1"], bwd=counts["k2"],
                   spmd=tr._spmd_updater is not None,
                   on_kvstore=bool(tr._update_on_kvstore),
                   kvstore=tr._kvstore.type,
                   workers=tr._kvstore.num_workers, **kv_state_bytes(tr))
        if tr._spmd_updater is not None:
            rec["plan"] = kv_plan(tr)
        state = {k: v.detach().cpu() for k, v in net.state_dict().items()}
        rec["digest"] = {k: tensor_digest(v) for k, v in state.items()
                         if not kv_is_stat(k)}
        keep = state if rank == 0 else {k: v for k, v in state.items()
                                        if kv_is_stat(k)}
        torch.save(keep, os.path.join(out_dir, f"{name}.rank{rank}.pt"))
        res["cases"][name] = rec
        print(f"kvstore rank {rank} {name}: ms a step "
              f"{[round(m, 2) for m in ms]}, launches {rec['fwd']}/"
              f"{rec['bwd']}, state {rec['state_bytes']} B (residuals "
              f"{rec['residual_bytes']} B, split {rec['shard_factor']} "
              f"ways)", flush=True)
        for k in env:
            os.environ.pop(k, None)
        del tr
        parallel.dist.barrier()
    res["jax_imported"] = sorted(m for m in sys.modules
                                 if m == "jax" or m.startswith("jax.")
                                 or m.split(".")[0] == "mxnet_tpu")
    res["rc"] = 1 if FAILURES or res["jax_imported"] else 0
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    return res["rc"]


def kv_shard_rank(out_dir, backend, devices):
    """One rank of phases 22 and 23 (and 24's (a)-(c)), started once by
    the port's tools/launch.py: one torch import, one CUDA context and
    one process group a rank serve kv_rank's work (files in
    ``out_dir/kv``) and then shard_rank's (``out_dir/shard``).  The
    seconds of shard_rank's part go into its record, so that each phase
    is charged its own."""
    from mxnet_tpu_torch import parallel

    rank = int(os.environ["DMLC_WORKER_ID"])
    torch.cuda.set_device(torch.device(devices[rank]))
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    parallel.dist.init(backend=backend, timeout=DP_COLLECTIVE_TIMEOUT)
    rc = kv_rank(os.path.join(out_dir, "kv"), devices)
    gc_cuda()
    parallel.dist.barrier()
    t0 = time.perf_counter()
    rc = shard_rank(os.path.join(out_dir, "shard"), devices, t0) or rc
    parallel.dist.shutdown()
    return rc


def launch_ranks(flag, out_dir, backend, devices, timeout):
    """The ranks, started as an MXNet user starts a dist job: the port's
    tools/launch.py -n len(devices) --launcher local (which ends every
    rank when one fails; run by its path, so the launcher itself imports
    no torch), each rank this script with ``flag``; killed, with every
    process of its session, at ``timeout``.  Returns the launcher's exit
    code (None: timed out)."""
    import signal

    env = {k: v for k, v in os.environ.items()
           if not k.startswith("DMLC_")}
    here = os.path.dirname(os.path.abspath(__file__))
    cmd = [sys.executable, os.path.join(here, "mxnet_tpu_torch", "tools",
                                        "launch.py"), "-n",
           str(len(devices)), "--launcher", "local", sys.executable,
           os.path.abspath(__file__), flag, "--dp-dir", out_dir,
           "--dp-backend", backend, "--dp-devices", ",".join(devices)]
    log_path = os.path.join(out_dir, "launch.log")
    with open(log_path, "w") as log:
        p = subprocess.Popen(cmd, env=env, cwd=here, stdout=log,
                             stderr=subprocess.STDOUT,
                             start_new_session=True)
        try:
            rc = p.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            rc = None
        finally:
            try:
                os.killpg(p.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
            p.wait()
    with open(log_path) as f:
        for line in f.read().splitlines()[-400:]:
            print(f"  [launch] {line}", flush=True)
    return rc


def kv_plain_int8(x):
    """The plain int8 round trip of MXNET_COMM_QUANT: per row of ``x``
    (fp32), per block of 512, scale max|.| / 127, round to nearest even,
    clip to +-127, times the scale.  The scale divides by a tensor: on
    the card a Python scalar divides through its reciprocal, which is
    not the JAX package's division."""
    rows, n = x.shape
    nb = -(-n // 512)
    xb = F.pad(x, (0, nb * 512 - n)).reshape(rows, nb, 512)
    scale = torch.clamp_min(xb.abs().amax(dim=-1, keepdim=True), 1e-30) \
        / torch.tensor(127.0, dtype=torch.float32, device=x.device)
    q = torch.clamp(torch.round(xb / scale), -127.0, 127.0)
    return (q * scale).reshape(rows, nb * 512)[:, :n]


def kv_padded_cat(tensors, sizes):
    return torch.cat([F.pad(t.reshape(-1), (0, s - t.numel()))
                      for t, s in zip(tensors, sizes)]).float()


def kv_reference_sum(case, grads, train, state, plan):
    """The gradient sum of one step, plainly: the two halves added, or
    each rank's plain 2-bit codes (its residual per key) summed in rank
    order, or each rank's bucket rows through the plain int8 round trip
    (its residual per bucket) summed in rank order."""
    out = {i: grads[0][i] + grads[1][i] for i, _ in train}
    if case == "2bit":
        for i, _ in train:
            total = None
            for r in range(DP):
                acc = grads[r][i].float().reshape(-1) \
                    + state.get(("2bit", r, i), 0.0)
                sent = torch.where(acc >= KV_2BIT, KV_2BIT,
                                   torch.where(acc <= -KV_2BIT, -KV_2BIT,
                                               0.0))
                state[("2bit", r, i)] = acc - sent
                total = sent if total is None else total + sent
            out[i] = total.view(grads[0][i].shape).to(grads[0][i].dtype)
    elif case == "spmd_int8":
        idx = plan["indices"]
        for bi, b in enumerate(plan["buckets"]):
            keys = [idx[p] for p in b["pos"]]
            total = None
            for r in range(DP):
                row = kv_padded_cat([grads[r][i] for i in keys], b["sizes"])
                acc = row + state.get(("g", bi, r), 0.0)
                dec = kv_plain_int8(acc[None])[0]
                state[("g", bi, r)] = acc - dec
                total = dec if total is None else total + dec
            for i, off in zip(keys, b["offsets"]):
                g = grads[0][i]
                out[i] = total[off:off + g.numel()].view(g.shape).to(g.dtype)
    return out


def kv_reference_weights(plan, weights, old, state):
    """The int8 weight leg, plainly: each shard's block of a bucket's
    delta to the old weights (plus its residual) through the plain int8
    round trip, added to the old weights."""
    idx = plan["indices"]
    for bi, b in enumerate(plan["buckets"]):
        keys = [idx[p] for p in b["pos"]]
        old_flat = kv_padded_cat([old[i] for i in keys], b["sizes"])
        new_flat = kv_padded_cat([weights[i] for i in keys], b["sizes"])
        acc = (new_flat - old_flat).view(plan["nshard"], -1) \
            + state.get(("w", bi), 0.0)
        dec = kv_plain_int8(acc)
        state[("w", bi)] = acc - dec
        full = old_flat + dec.reshape(-1)
        with torch.no_grad():
            for i, off in zip(keys, b["offsets"]):
                w = weights[i]
                w.copy_(full[off:off + w.numel()].view(w.shape))


def kv_reference(net, snap, xg, yg, case, plan):
    """What the two ranks compute, in this process on the same weights
    and half-batches: each half's forward and backward apart (each with
    its rank's running statistics), the plain sum of the two gradients
    (kv_reference_sum), one eager SGD update, for the warm-up and the
    KV_STEPS steps.  Returns (weights, [statistics of each half])."""
    from mxnet_tpu_torch import autograd, gluon, nd
    from mxnet_tpu_torch import optimizer as opt_mod
    from mxnet_tpu_torch.gluon.parameter import _unique

    kv_restore(net, snap)
    params = _unique(list(net.collect_params().values()))
    train = [(i, p) for i, p in enumerate(params) if p.grad_req != "null"]
    sd = net.state_dict()
    stat_keys = [k for k in sd if kv_is_stat(k)]
    stats = [{k: sd[k].clone() for k in stat_keys} for _ in range(DP)]
    opt = opt_mod.create("sgd", param_dict=dict(enumerate(params)),
                         **TRAIN_OPT)
    opt.rescale_grad = 1.0 / (DP * KV_BATCH)
    upd = opt_mod.Updater(opt)
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    state = {}
    for _ in range(1 + KV_STEPS):
        grads = []
        for r in range(DP):
            with torch.no_grad():
                for k in stat_keys:
                    sd[k].copy_(stats[r][k])
            half = slice(r * KV_BATCH, (r + 1) * KV_BATCH)
            x = nd.NDArray(xg[half].contiguous())
            y = nd.NDArray(yg[half].contiguous())
            with autograd.record():
                loss = loss_fn(net(x), y)
            loss.backward()
            grads.append({i: p.grad()._data.clone() for i, p in train})
            stats[r] = {k: sd[k].clone() for k in stat_keys}
        g = kv_reference_sum(case, grads, train, state, plan)
        old = {i: p.data()._data.clone() for i, p in train}
        for i, p in train:
            upd(i, nd.NDArray(g[i]), p.data())
        if case == "spmd_int8":
            kv_reference_weights(plan, {i: p.data()._data for i, p in train},
                                 old, state)
    weights = {k: v.detach().clone() for k, v in net.state_dict().items()
               if not kv_is_stat(k)}
    return weights, stats


def kv_compare(got, want, base):
    """(bit-identical tensors, tensors, max |got - want|, rel L2 of the
    difference to the update want - base)."""
    same = sum(torch.equal(got[k], want[k].cpu()) for k in want)
    diff = max(float((got[k].float() - want[k].cpu().float()).abs().max())
               for k in want)
    num = sum(float((got[k].float() - want[k].cpu().float()).square().sum())
              for k in want)
    den = sum(float((want[k].cpu().float() - base[k].cpu().float())
                    .square().sum()) for k in want)
    return same, len(want), diff, math.sqrt(num / max(den, 1e-30))


def kv_replicas_card(card, ranks_w):
    """(b) with DP cards: ResNet-50 on [gpu(0), gpu(1)] in this process,
    split_and_load and Trainer(kvstore='device') on the same weights and
    batches, held against the ranks' pushpull_fused weights."""
    from mxnet_tpu_torch import autograd, gluon, gpu, init, nd
    from mxnet_tpu_torch.gluon.model_zoo import vision

    ctx = [gpu(r) for r in range(DP)]
    net = vision.resnet50_v1(classes=1000, layout="NHWC")
    net.initialize(init.Xavier(), ctx=ctx, seed=0)
    net.cast("bfloat16")
    net.hybridize()
    tr = gluon.Trainer(net.collect_params(), "sgd", dict(TRAIN_OPT))
    xg, yg = kv_batch(torch.device("cuda", 0))
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    reset_kernel_counts()
    for _ in range(1 + KV_STEPS):
        xs = gluon.utils.split_and_load(nd.NDArray(xg), ctx)
        ys = gluon.utils.split_and_load(nd.NDArray(yg), ctx)
        with autograd.record():
            losses = [loss_fn(net(a), b) for a, b in zip(xs, ys)]
        for loss in losses:
            loss.backward()
        tr.step(DP * KV_BATCH)
    torch.cuda.synchronize()
    counts = kernel_counts()
    got = [{k: d._data.detach().cpu() for k, p in net.collect_params().items()
            for d in [p.list_data()[r]] if not kv_is_stat(k)}
           for r in range(DP)]
    rows = [kv_compare(g, ranks_w, ranks_w) for g in got]
    ok = all(r[0] == r[1] for r in rows)
    print(f"kvstore (b): ResNet-50 on {ctx} through Trainer(kvstore="
          f"'device'), {1 + KV_STEPS} steps: each replica's weights bit for "
          f"bit the dist ranks' pushpull_fused weights on "
          f"{[r[0] for r in rows]} of {rows[0][1]} tensors (max |diff| "
          f"{max(r[2] for r in rows):.3g}); launches {counts['k1']}/"
          f"{counts['k2']} [{card}]", flush=True)
    if not ok:
        fail(f"kvstore (b): replicas differ from the dist ranks: {rows}")
    return dict(ran="resnet50_two_cards", identical=ok,
                launches=[counts["k1"], counts["k2"]])


def kv_replicas_mnist(card):
    """(b) with one card: the MNIST example's MLP on [gpu(0), cpu(0)]
    (split_and_load, Trainer(kvstore='device'): the sum on the card, each
    replica's update on its device) against the same steps on [cpu(0),
    cpu(1)], from the same seeded weights and batches."""
    import numpy as np

    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import autograd, gluon
    from mxnet_tpu_torch.examples import mnist

    rs = np.random.RandomState(22)
    xs_np = rs.rand(KV_MNIST_STEPS, 100, 784).astype(np.float32)
    ys_np = rs.randint(0, 10, (KV_MNIST_STEPS, 100)).astype(np.float32)
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    out = {}
    for tag, ctx in (("card", [mt.gpu(0), mt.cpu(0)]),
                     ("cpu", [mt.cpu(0), mt.cpu(1)])):
        net = mnist.build_net()
        net.initialize(mt.initializer.Xavier(magnitude=2.24), ctx=ctx,
                       seed=0)
        net.hybridize()
        tr = gluon.Trainer(net.collect_params(), "sgd",
                           {"learning_rate": 0.1, "momentum": 0.9})
        for step in range(KV_MNIST_STEPS):
            xs = gluon.utils.split_and_load(
                mt.nd.array(xs_np[step], ctx=ctx[0]), ctx)
            ys = gluon.utils.split_and_load(
                mt.nd.array(ys_np[step], ctx=ctx[0]), ctx)
            with autograd.record():
                losses = [loss_fn(net(a), b) for a, b in zip(xs, ys)]
            for loss in losses:
                loss.backward()
            tr.step(100)
        out[tag] = {k: [d.asnumpy() for d in p.list_data()]
                    for k, p in net.collect_params().items()}
        if tag == "card":
            placed = [[str(d._data.device) for d in p.list_data()]
                      for p in net.collect_params().values()]
    c, h = out["card"], out["cpu"]
    num = sum(float(((c[k][r] - h[k][r]) ** 2).sum()) for k in h
              for r in range(2))
    den = sum(float((h[k][r] ** 2).sum()) for k in h for r in range(2))
    rel = math.sqrt(num / den)
    between = max(float(np.abs(c[k][0] - c[k][1]).max()) for k in c)
    on = all(p == ["cuda:0", "cpu"] for p in placed)
    print(f"kvstore (b): one card, so examples/mnist.py's MLP on [gpu(0), "
          f"cpu(0)], {KV_MNIST_STEPS} steps of 2 x 50 through "
          f"Trainer(kvstore='device'): weights against the same steps on "
          f"[cpu(0), cpu(1)] rel L2 {rel:.3g} (bound {KV_MNIST_BOUND}); "
          f"the card's and the CPU's replica differ by at most "
          f"{between:.3g}; replicas placed on cuda:0 and the CPU {on} "
          f"[{card}]", flush=True)
    if not (rel <= KV_MNIST_BOUND and on):
        fail(f"kvstore (b): mnist replicas rel {rel} placed {placed}")
    return dict(ran="mnist_card_and_cpu", rel_l2=rel, between=between)


def launch_kv_shard(card):
    """Start the ranks of phases 22-24 once (kv_shard_rank, through
    launch_ranks; main times it as its own step) and keep the record in
    KEEP["ranks"]; a later call returns it.  The ranks' seconds split
    three ways, each phase adding its share to its own: ``kv_s`` (the
    start and phase 22's part), ``shard_s`` (phase 23's part) and
    ``pc_s`` (phase 24's cases, run in phase 23's part)."""
    import shutil

    if "ranks" in KEEP:
        return KEEP["ranks"]
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "build", "chip_smoke_ranks")
    shutil.rmtree(root, ignore_errors=True)
    for sub in ("kv", "shard"):
        os.makedirs(os.path.join(root, sub))
    gc_cuda()
    if torch.cuda.device_count() >= DP:
        backend, devices = "nccl", [f"cuda:{r}" for r in range(DP)]
    else:
        backend, devices = "gloo", ["cuda:0"] * DP
    mode = f"{DP} ranks, backend {backend}, devices {','.join(devices)}"
    print(f"ranks of phases 22-24: {mode}; phase 22 ResNet-50 v1 fused "
          f"bf16, a rank's batch {KV_BATCH}, SGD {TRAIN_OPT}; phase 23 "
          f"BERT-base bf16 batch {BATCH} at fsdp=2 and tp=2, the LM at "
          f"dp=1 x sp=2, L={SHARD_LM['seq']} [{card}]", flush=True)
    t0 = time.perf_counter()
    rc = launch_ranks("--kv-shard-rank", root, backend, devices,
                      KV_TIMEOUT + SHARD_TIMEOUT)
    t_ranks = time.perf_counter() - t0
    part_s, pc_s = 0.0, 0.0
    for r in range(DP):
        path = os.path.join(root, "shard", f"rank{r}.json")
        if os.path.exists(path):
            with open(path) as f:
                rk = json.load(f)
            part_s = max(part_s, rk["seconds"])
            pc_s = max(pc_s, sum(rk["pc"][c]["seconds"]
                                 for c in ("pipeline", "moe", "nmt")))
    KEEP["ranks"] = dict(rc=rc, kv=os.path.join(root, "kv"),
                         shard=os.path.join(root, "shard"), backend=backend,
                         devices=devices, mode=mode, t_ranks=t_ranks,
                         kv_s=t_ranks - part_s, shard_s=part_s - pc_s,
                         pc_s=pc_s)
    return KEEP["ranks"]


def phase_kvstore(card):
    """Phase 22: MXNet's data-parallel API on the card (ROADMAP queue A
    item 7, cut (a)).  (a) The DP ranks of launch_kv_shard (the port's
    tools/launch.py) train full-width ResNet-50 v1 (fused, bf16, a rank's
    batch KV_BATCH) through gluon.Trainer(kvstore='dist_sync') in the
    five cases of KV_CASES; each case's weights and each rank's running
    statistics against this process's plain reference.  (b) replicas in
    one process."""
    import gc

    launch = launch_kv_shard(card)
    t0 = time.perf_counter()
    out_dir, backend, mode = launch["kv"], launch["backend"], launch["mode"]
    t_ranks = launch["kv_s"]  # the ranks' start and phase-22 part
    res = {"mode": mode, "backend": backend, "ranks": DP, "cases": {},
           "launches": {"fwd": 0, "bwd": 0}}
    if not all(os.path.exists(os.path.join(out_dir, f"rank{r}.json"))
               for r in range(DP)):
        fail(f"kvstore: the launcher exited {launch['rc']} before the "
             f"ranks recorded phase 22")
        return res
    ranks = []
    for r in range(DP):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
        if ranks[-1]["rc"]:
            fail(f"kvstore: rank {r}'s phase-22 part exited "
                 f"{ranks[-1]['rc']}")
    dev = torch.device("cuda", 0)
    net = build_net("bfloat16", 0, dev)
    snap = kv_snapshot(net)
    w0 = {k: v for k, v in snap.items() if not kv_is_stat(k)}
    xg, yg = kv_batch(dev)
    set_knobs(True, True)
    want_launch = (FWD_PER_STEP * KV_STEPS, BWD_PER_STEP * KV_STEPS)
    weights = {}
    for name, (kw, env) in KV_CASES.items():
        recs = [rk["cases"][name] for rk in ranks]
        plan = recs[0].get("plan")
        ref_w, ref_stats = kv_reference(net, snap, xg, yg, name, plan)
        got = torch.load(os.path.join(out_dir, f"{name}.rank0.pt"))
        weights[name] = {k: v for k, v in got.items() if not kv_is_stat(k)}
        same, n, diff, rel = kv_compare(weights[name], ref_w, w0)
        st = []
        for r in range(DP):
            s = torch.load(os.path.join(out_dir, f"{name}.rank{r}.pt"))
            st.append(kv_compare({k: s[k] for k in ref_stats[r]},
                                 ref_stats[r], {k: torch.zeros_like(v)
                                                for k, v in
                                                ref_stats[r].items()}))
        ranks_same = recs[1]["digest"] == recs[0]["digest"]
        ms = [m for rec in recs for m in rec["ms"]]
        bad = [f"rank {r} launched {rec['fwd']}/{rec['bwd']}"
               for r, rec in enumerate(recs)
               if (rec["fwd"], rec["bwd"]) != want_launch]
        bad += [f"rank {r} ran spmd={rec['spmd']} on_kvstore="
                f"{rec['on_kvstore']} on a {rec['kvstore']} store of "
                f"{rec['workers']}" for r, rec in enumerate(recs)
                if rec["spmd"] != bool(kw.get("spmd"))
                or rec["kvstore"] != "dist_sync" or rec["workers"] != DP]
        if not ranks_same:
            bad.append("the ranks' weights differ")
        if same != n or any(s[0] != s[1] for s in st):
            bad.append("not bit for bit the reference")
        res["cases"][name] = dict(
            ms=[rec["ms"] for rec in recs], identical=same == n,
            max_abs=diff, rel_l2=rel, stats_identical=[s[0] == s[1]
                                                       for s in st],
            stats_max_abs=[s[2] for s in st],
            state_bytes=[rec["state_bytes"] for rec in recs],
            residual_bytes=[rec["residual_bytes"] for rec in recs],
            shard_factor=recs[0]["shard_factor"],
            launches=[[rec["fwd"], rec["bwd"]] for rec in recs])
        print(f"kvstore {name}: ms a step per rank "
              f"{[[round(m, 2) for m in rec['ms']] for rec in recs]} "
              f"(spread {max(ms) - min(ms):.2f}); launches per rank "
              f"{[[rec['fwd'], rec['bwd']] for rec in recs]} (want "
              f"{list(want_launch)}); optimizer state per rank "
              f"{[rec['state_bytes'] for rec in recs]} B, residuals "
              f"{[rec['residual_bytes'] for rec in recs]} B, split "
              f"{recs[0]['shard_factor']} ways; weights vs the plain "
              f"reference: {same} of {n} tensors bit for bit, max |diff| "
              f"{diff:.3g}, rel L2 to the update {rel:.3g}; running "
              f"statistics rank r vs half r: "
              f"{[f'{s[0]}/{s[1]}' for s in st]} bit for bit, max |diff| "
              f"{[round(s[2], 8) for s in st]}; ranks bit-identical "
              f"{ranks_same} [{mode}] [{card}]", flush=True)
        for b in bad:
            fail(f"kvstore {name}: {b}")
    for a in KV_EXACT[1:]:
        same = sum(torch.equal(weights[a][k], weights[KV_EXACT[0]][k])
                   for k in weights[a])
        print(f"kvstore: {a} against {KV_EXACT[0]}: {same} of "
              f"{len(weights[a])} tensors bit for bit", flush=True)
        if same != len(weights[a]):
            fail(f"kvstore: {a} differs from {KV_EXACT[0]}")
    for rk in ranks:
        if rk["jax_imported"]:
            fail(f"kvstore: rank {rk['rank']} loaded {rk['jax_imported']}")
    first = ranks[0]["cases"]["update_on_kvstore"]
    res["launches"] = {"fwd": first["fwd"], "bwd": first["bwd"]}
    del net, snap
    gc.collect()
    torch.cuda.empty_cache()
    t_b = time.perf_counter()
    res["b"] = kv_replicas_card(card, weights["pushpull_fused"]) \
        if torch.cuda.device_count() >= DP else kv_replicas_mnist(card)
    res["seconds"] = time.perf_counter() - t0 + t_ranks
    print(f"kvstore: phase 22 took {res['seconds']:.1f} s (ranks "
          f"{t_ranks:.1f} s, reference {t_b - t0:.1f} s, (b) "
          f"{time.perf_counter() - t_b:.1f} s; limit {KV_SECONDS:.0f} s; "
          f"the ranks' phase 23 and 24 parts not counted here) [{card}]",
          flush=True)
    if res["seconds"] > KV_SECONDS:
        fail(f"kvstore: phase 22 took {res['seconds']:.1f} s")
    print(f"kvstore: {json.dumps(res, default=str)}", flush=True)
    return res


def phase_kernels_kv():
    """Kernels 1 (with statistics) and 2 at phase 22's per-rank shapes
    (N = KV_BATCH), with phase 3's checks."""
    return kernels_at(KV_BATCH, 2222, "train_kv",
                      f"phase 22's per-rank shapes, N={KV_BATCH}")


def attention_path_summary(kernel, path, rows, launches, batch):
    """The `kernels` record of kernel 5 on one phase-9 path: each check
    record in `rows` (record, launches) weighted by its launches in one
    unit of the path's work."""
    tot = {k: sum(r[k] * n for r, n in rows)
           for k in ("kernel_ms", "op_ms", "ref_ms", "library_ms",
                     "bound_ms")}
    by_ops = sum(r["bound_ms"] * n for r, n in rows
                 if r["bound_by"] == "operations")
    return dict(kernel, path=path, batch=batch, launches=launches,
                max_abs_err=max(r["max_abs_err"] for r, _ in rows),
                ms=tot["kernel_ms"], op_ms=tot["op_ms"],
                plain_ms=tot["ref_ms"], bound_ms=tot["bound_ms"],
                bound_by="operations" if by_ops >= tot["bound_ms"] / 2
                else "bytes", library_ms=tot["library_ms"])


def http_summary(http):
    """The `kernels` record of kernel 5 on phase 4b's HTTP path: the
    checks at each bucket that (a)'s batches ran at, each weighted by its
    launches there, so ms and the bounds are those of all of (a)'s
    launches; `batch` lists the buckets, `batches_by_bucket` their
    counts."""
    rows = http.get("attention") or []
    if not rows:
        return dict(KERNEL_ATT, name="dot_product_attention/bert_http",
                    path="serve_bert_http", launches=0)
    return dict(attention_path_summary(
        dict(KERNEL_ATT, name="dot_product_attention/bert_http"),
        "serve_bert_http", rows, http["launches"],
        [r["bh"] // BERT_HEADS for r, _ in rows]),
        batches_by_bucket=http["buckets"], unit="all of (a)'s launches")


def tap_summary(recs, launches):
    """The `kernels` record of kernel 6 on the probe path: times and
    bounds summed over the 27 configurations of one time sweep of the
    probe (nine layers x TAP_NB), from phase 7's checks at those shapes;
    `ms_by_nb` splits the kernel's time by batch tile."""
    rec = kernel_summary(KERNEL_TAP, recs, "probe", launches)
    rec["ms_by_nb"] = {}
    for r in recs:
        if r["path"] == "probe":
            rec["ms_by_nb"][r["nb"]] = rec["ms_by_nb"].get(r["nb"], 0.0) \
                + r["kernel_ms"]
    rec["kernel1_sweep_ms"] = sum(r["k1_ms"] for r in recs
                                  if r["path"] == "probe") / len(
        rec["ms_by_nb"])
    return rec


def attention_summary(recs, launches):
    """The `kernels` record of the attention kernel on the BERT serving
    path: times and bound of the packed check at the path's shapes, summed
    over the BERT_LAYERS launches of one served batch of BATCH."""
    r = recs["bert.packed"]
    return dict(attention_path_summary(KERNEL_ATT, "serve_bert",
                                       [(r, BERT_LAYERS)], launches, BATCH),
                events_ms=r["events_ms"] * BERT_LAYERS)


# ---------------------------------------------------------------------------
# phase 23: sharded meshes (ROADMAP queue A item 7, cut (b))
# ---------------------------------------------------------------------------

SHARD_RANKS = 2
SHARD_SEED = 26
SHARD_STEPS = 2        # counted BERT steps a case, after one (step 1)
SHARD_CASES = ("fsdp", "tp")
# the tensors held against the dp = 1 step: weights after step 1 and
# their Adam means (the mean catches an n-fold gradient, which Adam's
# first step, about lr * sign(g), would not show in the weights)
SHARD_TRACKED = ("bert.word_embed.weight",
                 "bert.encoder.layers.0.attention.query.weight",
                 "bert.encoder.layers.0.ffn.ffn_2.weight")
SHARD_BOUND = 2e-2     # bf16: rel of step 1's loss, rel L2 of each tensor
SHARD_LM = dict(units=64, heads=4, layers=2, vocab=512, batch=4, seq=8192)
SHARD_LM_STEPS = 10
SHARD_LM_BOUND = 1e-4  # fp32: step 0's loss, ring / Ulysses vs sp = 1
SHARD_TIMEOUT = 420.0  # s, the ranks' phase-23 work (phase 24's too)
SHARD_SECONDS = 90.0   # the phase's limit, phase 24's rank work left out


def shard_bert(dev, batch):
    """Config 3's BERT-base step at dropout 0, Normal(0.02) weights from
    SHARD_SEED, warmed on the batch's model inputs, bf16, on ``dev``;
    with a snapshot of its state to restore between cases."""
    from mxnet_tpu_torch import init
    from mxnet_tpu_torch.examples import bench_steps as bs

    step = bs.init_step(bs.bert_step("full", dropout=0.0), init.Normal(0.02),
                        ctx=dev, seed=SHARD_SEED, dtype="bfloat16",
                        warm=batch[:3])
    return step, snapshot(step)


def shard_restore(step, w0):
    """The snapshot back in ``step``, whole tensors where a sharded
    trainer left blocks."""
    with torch.no_grad():
        for k, v in step.state_dict(keep_vars=True).items():
            if tuple(v.shape) != tuple(w0[k].shape):
                v.data = w0[k].clone()
            else:
                v.copy_(w0[k])


def shard_tracked(tr, names=SHARD_TRACKED):
    """{name: (weight, Adam mean)} of ``names`` as global tensors (a
    collective over the trainer's mesh)."""
    return {n: (tr.value_full(tr.params[n]).cpu().clone(),
                tr.state_full(n)[0].cpu().clone()) for n in names}


def shard_rank(out_dir, devices, t_start):
    """Phase 23's work in one rank of kv_shard_rank, begun at ``t_start``:
    (c) SPMDTrainer.forward of BERT-base at dp = 2; (a) BERT-base trained at
    fsdp = 2 and at tp = 2 (step 1, then SHARD_STEPS counted steps with
    the kernel counters set to 0 just before and read just after); (b)
    the long-context LM at dp = 1 x sp = 2, ring and Ulysses; then phase
    24's cases (a)-(c) (pc_rank_pipeline, pc_rank_moe, pc_rank_nmt).
    Rank 0 saves its tensors of phase 23, each rank its tensors of phase
    24; both write their records, each with the part's exit code (1 on a
    failure recorded in this part or a JAX module loaded)."""
    from mxnet_tpu_torch import parallel
    from mxnet_tpu_torch.examples import bench_steps as bs
    from mxnet_tpu_torch.examples import long_context_lm as lm

    rank = int(os.environ["DMLC_WORKER_ID"])
    dev = torch.device(devices[rank])
    n_failed = len(FAILURES)  # phase 22's part's failures are its own
    res = {"rank": rank, "cases": {}, "lm": {}, "pc": {}}
    saved, pc_saved = {}, {}
    batch = bs.bert_batch("full", seed=0, ctx=dev)
    step, w0 = shard_bert(dev, batch)
    dense = sum(p.numel() * p.element_size()
                for n, p in step.named_parameters())
    # (c) the forward at dp = 2: each rank its 16 rows, gathered
    mesh = parallel.make_mesh(dp=SHARD_RANKS, devices=devices)
    tr = parallel.SPMDTrainer(step.bert, bs.Identity(), "adam",
                              {"learning_rate": BERT_TRAIN_LR}, mesh=mesh,
                              n_labels=0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    seq, pooled = tr.forward(*batch[:3])
    torch.cuda.synchronize()
    res["forward"] = dict(ms=(time.perf_counter() - t0) * 1e3,
                          shapes=[list(seq.shape), list(pooled.shape)])
    saved["forward"] = (seq.cpu(), pooled.cpu())
    del tr, seq, pooled
    # (a) BERT-base at fsdp = 2 and at tp = 2 with DEFAULT_RULES
    for case in SHARD_CASES:
        shard_restore(step, w0)
        gc_cuda()
        torch.cuda.reset_peak_memory_stats(dev)
        mesh = parallel.make_mesh({case: SHARD_RANKS}, devices=devices)
        tr = bs.spmd_trainer(step, BERT_TRAIN_LR, mesh=mesh)
        loss1 = float(tr.step(*batch))
        saved[case] = shard_tracked(tr)
        torch.cuda.synchronize()
        reset_kernel_counts()
        ms = []
        for _ in range(SHARD_STEPS):
            t0 = time.perf_counter()
            float(tr.step(*batch))
            ms.append((time.perf_counter() - t0) * 1e3)
        counts = kernel_counts()
        split = list(tr._specs)
        res["cases"][case] = dict(
            loss1=loss1, ms=ms, launches=counts,
            param_bytes=sum(p.numel() * p.element_size()
                            for p in tr.params.values()),
            dense_bytes=dense,
            split=len(split),
            split_bytes=sum(tr.params[n].numel() * tr.params[n].element_size()
                            for n in split),
            split_full_bytes=sum(math.prod(tr._shapes[n])
                                 * tr.params[n].element_size()
                                 for n in split),
            state_bytes=sum(s.numel() * s.element_size()
                            for st in tr.opt_state.values() for s in st),
            peak_bytes=torch.cuda.max_memory_allocated(dev),
            specs={n: repr(tr._specs[n]) for n in SHARD_TRACKED
                   if n in tr._specs})
        del tr
    shard_restore(step, w0)
    gc_cuda()
    pc_rank_pipeline(step, dev, devices, res["pc"], pc_saved)
    del step, w0
    gc_cuda()
    # (b) the long-context LM at dp = 1 x sp = 2
    c = SHARD_LM
    tokens, labels = lm.lm_data(c["batch"], c["seq"], c["vocab"])
    mesh = parallel.make_mesh(dp=1, sp=SHARD_RANKS, devices=devices)
    for method in ("ring", "ulysses"):
        gc_cuda()
        torch.cuda.reset_peak_memory_stats(dev)
        net = lm.build_lm(method, c["units"], c["heads"], c["vocab"],
                          c["layers"], ctx=dev, seed=0)
        tr = lm.trainer_for(net, mesh)
        losses, ms = [], []
        for _ in range(SHARD_LM_STEPS):
            t0 = time.perf_counter()
            losses.append(float(tr.step(tokens, labels)))
            ms.append((time.perf_counter() - t0) * 1e3)
        res["lm"][method] = dict(losses=losses, ms=ms,
                                 peak_bytes=torch.cuda.max_memory_allocated(
                                     dev))
        del net, tr
    gc_cuda()
    pc_rank_moe(dev, devices, res["pc"], pc_saved)
    gc_cuda()
    pc_rank_nmt(dev, devices, res["pc"], pc_saved)
    res["jax_imported"] = sorted(
        m for m in sys.modules if m == "jax" or m.startswith("jax.")
        or m == "mxnet_tpu" or m.startswith("mxnet_tpu."))
    if rank == 0:
        torch.save(saved, os.path.join(out_dir, "rank0.pt"))
    torch.save(pc_saved, os.path.join(out_dir, f"rank{rank}_pc.pt"))
    parallel.dist.barrier()
    res["seconds"] = time.perf_counter() - t_start
    res["rc"] = 1 if FAILURES[n_failed:] or res["jax_imported"] else 0
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    return res["rc"]


def gc_cuda():
    import gc

    gc.collect()
    torch.cuda.empty_cache()


def phase_sharded(card, recs_att):
    """Phase 23: sharded meshes on the card (ROADMAP queue A item 7, cut
    (b)).  The two ranks of launch_kv_shard (gloo on one card; NCCL when
    there are two) run shard_rank after phase 22's work; this process
    holds their results against dp = 1 and sp = 1 runs of the same weights, and
    kernel 5 at the fsdp ranks' shape (batch 16) against its plain
    version."""
    from mxnet_tpu_torch import _graphs as graphs
    from mxnet_tpu_torch import parallel
    from mxnet_tpu_torch.examples import bench_steps as bs
    from mxnet_tpu_torch.examples import long_context_lm as lm

    launch = launch_kv_shard(card)  # started once for phases 22-24
    t0 = time.perf_counter()
    out_dir, backend, mode = (launch["shard"], launch["backend"],
                              launch["mode"])
    t_ranks = launch["shard_s"]
    res = {"mode": mode, "backend": backend, "ranks": SHARD_RANKS,
           "launches": {c: 0 for c in SHARD_CASES}}
    if not all(os.path.exists(os.path.join(out_dir, f"rank{r}.json"))
               for r in range(SHARD_RANKS)):
        fail(f"sharded: the launcher exited {launch['rc']} before the "
             f"ranks recorded phase 23")
        return res, []
    ranks = []
    for r in range(SHARD_RANKS):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
        if ranks[-1]["rc"]:
            fail(f"sharded: rank {r}'s phase-23 part exited "
                 f"{ranks[-1]['rc']}")
    if launch["rc"] and not any(rk["rc"] for rk in ranks):
        # both parts recorded success: the ranks failed after them
        fail(f"sharded: the launcher exited {launch['rc']} after the ranks "
             f"recorded phases 22 and 23")
    saved = torch.load(os.path.join(out_dir, "rank0.pt"))
    for rk in ranks:
        if rk["jax_imported"]:
            fail(f"sharded: rank {rk['rank']} loaded {rk['jax_imported']}")
    dev = torch.device("cuda", 0)
    batch = bs.bert_batch("full", seed=0, ctx=dev)
    step, w0 = shard_bert(dev, batch)
    # (c) the dp = 1 forward of the same weights
    tr = parallel.SPMDTrainer(step.bert, bs.Identity(), "adam",
                              {"learning_rate": BERT_TRAIN_LR},
                              mesh=parallel.make_mesh(dp=1), n_labels=0)
    seq, pooled = (t.cpu() for t in tr.forward(*batch[:3]))
    del tr
    got = saved["forward"]
    fwd_err = [rel_l2(got[0], seq), rel_l2(got[1], pooled)]
    shapes = ranks[0]["forward"]["shapes"]
    res["forward"] = dict(rel_l2=fwd_err, shapes=shapes,
                          ms=[rk["forward"]["ms"] for rk in ranks])
    print(f"sharded (c): SPMDTrainer.forward at dp=2 gives {shapes} "
          f"(global batch {BATCH}); rel L2 to the dp=1 forward: seq "
          f"{fwd_err[0]:.3g}, pooled {fwd_err[1]:.3g} (bound "
          f"{BERT_BOUNDS['bf16']}); ms {[round(rk['forward']['ms'], 2) for rk in ranks]} "
          f"[{card}]", flush=True)
    if shapes != [[BATCH, BERT_SEQ, BERT_UNITS], [BATCH, BERT_UNITS]] \
            or max(fwd_err) > BERT_BOUNDS["bf16"]:
        fail("sharded (c): the dp=2 forward is not the dp=1 forward")
    # (a) the dp = 1 step of the same weights and batch
    tr = bs.spmd_trainer(step, BERT_TRAIN_LR)
    with graphs.no_capture():
        loss_ref = float(tr.step(*batch))
    ref = shard_tracked(tr)
    dense_trained = sum(p.numel() * p.element_size()
                        for p in tr.params.values())
    KEEP["shard_bert"] = (step, w0)  # phase 24 (a)'s stages
    del tr, step, w0
    gc_cuda()
    for case in SHARD_CASES:
        recs = [rk["cases"][case] for rk in ranks]
        rec = recs[0]
        dl = abs(rec["loss1"] - loss_ref) / abs(loss_ref)
        errs, same = {}, 0
        for n in SHARD_TRACKED:
            w, m = saved[case][n]
            errs[n] = (rel_l2(w, ref[n][0]), rel_l2(m, ref[n][1]))
            same += int(torch.equal(w, ref[n][0]))
        want = BERT_LAYERS * SHARD_STEPS
        ratio = [r_["param_bytes"] / dense_trained for r_ in recs]
        split_ratio = [r_["split_bytes"] / max(r_["split_full_bytes"], 1)
                       for r_ in recs]
        res[case] = dict(
            loss1=rec["loss1"], loss_ref=loss_ref, loss_rel=dl,
            rel_l2={n: list(e) for n, e in errs.items()},
            bit_identical=same, ms=[r_["ms"] for r_ in recs],
            launches=[r_["launches"] for r_ in recs],
            param_bytes=[r_["param_bytes"] for r_ in recs],
            dense_param_bytes=dense_trained, param_ratio=ratio,
            split_tensors=rec["split"], split_ratio=split_ratio,
            state_bytes=[r_["state_bytes"] for r_ in recs],
            peak_gib=[r_["peak_bytes"] / 2 ** 30 for r_ in recs],
            specs=rec["specs"])
        res["launches"][case] = rec["launches"]["k5"]
        print(f"sharded (a) {case}=2: step 1 loss {rec['loss1']:.6f} vs "
              f"dp=1 {loss_ref:.6f} (rel {dl:.3g}); weight / Adam mean rel "
              f"L2 to dp=1 "
              f"{ {n.split('.')[-2]: [round(x, 6) for x in e] for n, e in errs.items()} } "
              f"(bound {SHARD_BOUND}), {same} of {len(SHARD_TRACKED)} "
              f"weights bit for bit; specs {rec['specs']}; {rec['split']} "
              f"tensors split; ms a step per rank "
              f"{[[round(x, 2) for x in r_['ms']] for r_ in recs]}; kernel 5 "
              f"launches per rank {[r_['launches']['k5'] for r_ in recs]} "
              f"(want {want}); trained-parameter bytes per rank "
              f"{[r_['param_bytes'] for r_ in recs]} = "
              f"{[round(x, 4) for x in ratio]} of dp=1's {dense_trained}; "
              f"split tensors at {[round(x, 4) for x in split_ratio]} of "
              f"their size; optimizer state "
              f"{[r_['state_bytes'] for r_ in recs]} B; peak "
              f"{[round(r_['peak_bytes'] / 2 ** 30, 2) for r_ in recs]} GiB "
              f"[{mode}] [{card}]", flush=True)
        if dl > SHARD_BOUND or any(max(e) > SHARD_BOUND
                                   for e in errs.values()):
            fail(f"sharded (a) {case}: step 1 differs from dp=1")
        for r_ in recs:
            if r_["launches"] != {"k1": 0, "k2": 0, "k5": want, "k6": 0}:
                fail(f"sharded (a) {case}: launches {r_['launches']}")
            if abs(r_["split_bytes"] * SHARD_RANKS
                   - r_["split_full_bytes"]) or not r_["split"]:
                fail(f"sharded (a) {case}: split tensors not halved")
        if case == "fsdp" and not all(0.45 < x < 0.55 for x in ratio):
            fail(f"sharded (a) fsdp: parameter bytes {ratio} of dp=1's")
    # (b) the LM: step 0 of the same weights at sp = 1
    c = SHARD_LM
    tokens, labels = lm.lm_data(c["batch"], c["seq"], c["vocab"])
    net = lm.build_lm("ring", c["units"], c["heads"], c["vocab"],
                      c["layers"], ctx=dev, seed=0)
    tr = lm.trainer_for(net, parallel.make_mesh(dp=1))
    torch.cuda.reset_peak_memory_stats(dev)
    with graphs.no_capture():
        t1 = time.perf_counter()
        l0 = float(tr.step(tokens, labels))
        ms1 = (time.perf_counter() - t1) * 1e3
    peak1 = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    del net, tr
    gc_cuda()
    res["lm"] = {"sp1": dict(loss0=l0, ms=ms1, peak_gib=peak1)}
    for method in ("ring", "ulysses"):
        recs = [rk["lm"][method] for rk in ranks]
        losses = recs[0]["losses"]
        d0 = abs(losses[0] - l0) / abs(l0)
        res["lm"][method] = dict(
            losses=losses, loss0_rel=d0, ms=[r_["ms"] for r_ in recs],
            peak_gib=[r_["peak_bytes"] / 2 ** 30 for r_ in recs])
        print(f"sharded (b) LM {method} dp=1 x sp=2, L={c['seq']} "
              f"({c['seq'] // SHARD_RANKS} tokens a rank), batch "
              f"{c['batch']}: loss {losses[0]:.6f} -> {losses[-1]:.6f} over "
              f"{len(losses)} steps; step 0 vs sp=1 {l0:.6f} (rel {d0:.3g}, "
              f"bound {SHARD_LM_BOUND}); ms a step per rank "
              f"{[[round(x, 1) for x in r_['ms']] for r_ in recs]}; peak "
              f"{[round(r_['peak_bytes'] / 2 ** 30, 2) for r_ in recs]} GiB "
              f"(sp=1: {ms1:.1f} ms, {peak1:.2f} GiB) [{mode}] [{card}]",
              flush=True)
        if d0 > SHARD_LM_BOUND or not losses[-1] < losses[0] \
                or recs[1]["losses"] != losses:
            fail(f"sharded (b) {method}: loss {losses} (sp=1 step 0 {l0}; "
                 f"rank 1 {recs[1]['losses']})")
    # kernel 5 at the fsdp ranks' shape: 16 sequences a rank
    gen = torch.Generator().manual_seed(2323)
    half = BATCH // SHARD_RANKS
    q, k, v = (torch.randn(half, BERT_SEQ, BERT_UNITS, generator=gen).to(
        dev, torch.bfloat16) for _ in range(3))
    m = key_mask(gen, half, BERT_SEQ, zero_rows=1).to(dev)
    rec16 = check_attention(f"bert.packed.b{half}", q, k, v, m, False, card,
                            heads=BERT_HEADS)
    summaries = [
        dict(attention_path_summary(
            dict(KERNEL_ATT, name="dot_product_attention/bert_fsdp2"),
            "bert_fsdp2", [(rec16, BERT_LAYERS)], res["launches"]["fsdp"],
            half), backend=backend, ranks=SHARD_RANKS),
        dict(attention_path_summary(
            dict(KERNEL_ATT, name="dot_product_attention/bert_tp2"),
            "bert_tp2", [(recs_att["bert.packed"], BERT_LAYERS)],
            res["launches"]["tp"], BATCH), backend=backend,
            ranks=SHARD_RANKS)]
    res["seconds"] = time.perf_counter() - t0 + t_ranks
    res["out_dir"] = out_dir
    print(f"sharded: phase 23 took {res['seconds']:.1f} s (its part in the "
          f"ranks {t_ranks:.1f} s; phase 24's cases there, "
          f"{launch['pc_s']:.1f} s, not counted here; limit "
          f"{SHARD_SECONDS:.0f} s) [{card}]", flush=True)
    print("sharded: " + json.dumps(res), flush=True)
    if res["seconds"] > SHARD_SECONDS:
        fail(f"sharded: phase 23 took {res['seconds']:.1f} s, over "
             f"{SHARD_SECONDS:.0f} s")
    return res, summaries



# ---------------------------------------------------------------------------
# phase 24: expert and pipeline parallelism (ROADMAP queue A item 7, cut (c))
# ---------------------------------------------------------------------------

PC_SEED = 27
PC_STAGES, PC_MICRO = 2, 4     # (a): pp ranks of six layers; microbatches
PC_EXPERTS, PC_TOKENS, PC_CF, PC_FFN = 8, 4096, 1.25, 3072   # (b)
PC_CAPACITY = math.ceil(PC_TOKENS / PC_EXPERTS * PC_CF)
PC_NMT_SIZE, PC_NMT_BATCH = "full", 64   # (c): config 5's 64 x 64 tokens
# (c): the tensors held against the dp = 1 step, weights and Adam means
# (the tied source/target/output embedding trains as net.tied_weight)
PC_NMT_TRACKED = ("net.tied_weight",
                  "net.encoder.layers.0.attention.query.weight",
                  "net.encoder.layers.0.ffn.ffn_1.weight")
PC_HETERO_BATCH, PC_HETERO_MICRO = 256, 4   # (d)
PC_HETERO_CUTS = (5, 7)        # (d): ResNet-50's features children a stage
PC_BOUND = 2e-2                # bf16: rel L2 (relative for a loss)
PC_SECONDS = 60.0              # the phase's limit, its rank work included


def pc_bert_stage(layers):
    """pipeline_apply's stage over BERT-base encoder layers: each layer
    with p's '<slot>.<name>' tensors swapped in (functional_call), every
    key valid (config 3's lengths are all 128)."""
    from mxnet_tpu_torch.gluon.block import ActiveTrace

    def stage(p, x):
        mask = torch.ones(x.shape[0], x.shape[1], device=x.device)
        with ActiveTrace(train=True):
            for s, layer in enumerate(layers):
                pre = f"{s}."
                x = torch.func.functional_call(
                    layer, {k[len(pre):]: v for k, v in p.items()
                            if k.startswith(pre)}, (x, mask))
        return x
    return stage


def pc_bert_stacked(layers):
    """The encoder's layers as PC_STAGES stages' stacked parameters,
    leaves that require grad."""
    from mxnet_tpu_torch.parallel import stack_stage_params

    per = len(layers) // PC_STAGES
    stacked = stack_stage_params([
        {f"{s}.{k}": v.detach() for s in range(per)
         for k, v in layers[i * per + s].state_dict().items()}
        for i in range(PC_STAGES)])
    return {k: v.requires_grad_() for k, v in stacked.items()}


def pc_seeded(dev, seed, *shapes, scale=1.0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return [(torch.randn(*s, generator=gen, device=dev) * scale).to(
        torch.bfloat16) for s in shapes]


def pc_pipe_call(stage, stacked, x, c, mesh):
    """(y, {key: grad of the stacked parameter}, grad of x) of one
    pipeline_apply call (mesh None: the two stages one after the other)
    for the cotangent c."""
    from mxnet_tpu_torch import parallel

    x = x.detach().requires_grad_()
    if mesh is None:
        y = x
        for i in range(PC_STAGES):
            y = stage({k: v[i] for k, v in stacked.items()}, y)
    else:
        y = parallel.pipeline_apply(stage, stacked, x, PC_MICRO, mesh=mesh)
    keys = list(stacked)
    g = torch.autograd.grad((y.float() * c.float()).sum(),
                            [stacked[k] for k in keys] + [x])
    return y.detach(), dict(zip(keys, g[:-1])), g[-1]


def pc_moe_data(dev):
    """(x [T, 768], the gate logits [T, E] of a 768 -> E router, the
    experts' stacked FFN weights, the cotangents of y and of the gate
    probabilities), the weights Normal(0.02) as BERT-base's.  The
    router's bias is Normal(1), so that some experts get more tokens
    than their capacity and drop some (with balanced experts none
    would, and the capacity would go unchecked)."""
    x, cy, cp, bias = pc_seeded(
        dev, PC_SEED + 1, (PC_TOKENS, BERT_UNITS), (PC_TOKENS, BERT_UNITS),
        (PC_TOKENS, PC_EXPERTS), (PC_EXPERTS,))
    router, w1, b1, w2, b2 = pc_seeded(
        dev, PC_SEED + 2, (BERT_UNITS, PC_EXPERTS),
        (PC_EXPERTS, BERT_UNITS, PC_FFN), (PC_EXPERTS, PC_FFN),
        (PC_EXPERTS, PC_FFN, BERT_UNITS), (PC_EXPERTS, BERT_UNITS),
        scale=0.02)
    return x, x @ router + bias, {"w1": w1, "b1": b1, "w2": w2,
                                  "b2": b2}, cy, cp.float()


def pc_expert(p, tok):
    """One expert: BERT-base's FFN, 768 -> 3072, GELU, -> 768."""
    return F.gelu(tok @ p["w1"] + p["b1"]) @ p["w2"] + p["b2"]


def pc_moe_call(x, gl, params, cy, cp, mesh):
    """(y, dropped_frac, {x, gl, w1, b1, w2, b2: grad}) of one moe_apply
    call for sum(y * cy) + sum(gate_probs * cp)."""
    from mxnet_tpu_torch import parallel

    x, gl = x.detach().requires_grad_(), gl.detach().requires_grad_()
    ps = {k: v.detach().requires_grad_() for k, v in params.items()}
    y, aux = parallel.moe_apply(pc_expert, ps, x, gl,
                                capacity_factor=PC_CF, mesh=mesh)
    loss = (y.float() * cy.float()).sum() + (aux["gate_probs"] * cp).sum()
    keys = ["x", "gl"] + list(ps)
    g = torch.autograd.grad(loss, [x, gl] + list(ps.values()))
    return y.detach(), float(aux["dropped_frac"]), dict(zip(keys, g))


def pc_nmt_batch(dev):
    """Config 5's batch (bench_steps.transformer_batch, 64 x 64) with the
    target lengths drawn per row in [1, 64] from PC_SEED."""
    from mxnet_tpu_torch.examples import bench_steps as bs

    src, tgt_in, sv, _tv, tgt_out = bs.transformer_batch(PC_NMT_SIZE, seed=0,
                                                         ctx=dev)
    gen = torch.Generator().manual_seed(PC_SEED + 3)
    tv = torch.randint(1, src.shape[1] + 1, (src.shape[0],), generator=gen)
    return src, tgt_in, sv, tv.float().to(dev), tgt_out


def pc_nmt_step(dev, batch):
    """Config 5's Transformer-base step at dropout 0, Xavier weights from
    PC_SEED, warmed on the batch's model inputs, bf16, on ``dev``."""
    from mxnet_tpu_torch import init
    from mxnet_tpu_torch.examples import bench_steps as bs

    return bs.init_step(bs.transformer_step(PC_NMT_SIZE, dropout=0.0),
                        init.Xavier(), ctx=dev, seed=PC_SEED,
                        dtype="bfloat16", warm=batch[:4])


def pc_timed(fn):
    """fn() between synchronisations, with the kernel counters set to 0
    just before and read just after: (result, ms, counts)."""
    torch.cuda.synchronize()
    reset_kernel_counts()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3, kernel_counts()


def pc_rank_pipeline(step, dev, devices, res, saved):
    """Phase 24 (a) in a rank of phase 23: BERT-base's 12 encoder layers
    as two stages of six at pp = 2, config 3's batch as PC_MICRO
    microbatches; one warm call, then one counted and timed call."""
    from mxnet_tpu_torch import parallel

    t0 = time.perf_counter()
    layers = list(step.bert.encoder.layers._modules.values())
    stage = pc_bert_stage(layers[:len(layers) // PC_STAGES])
    stacked = pc_bert_stacked(layers)
    x, c = pc_seeded(dev, PC_SEED, (BATCH, BERT_SEQ, BERT_UNITS),
                     (BATCH, BERT_SEQ, BERT_UNITS))
    mesh = parallel.make_mesh(pp=PC_STAGES, devices=devices)
    pc_pipe_call(stage, stacked, x, c, mesh)
    gc_cuda()
    torch.cuda.reset_peak_memory_stats(dev)
    (y, g, gx), ms, counts = pc_timed(
        lambda: pc_pipe_call(stage, stacked, x, c, mesh))
    res["pipeline"] = dict(
        ms=ms, launches=counts, peak_bytes=torch.cuda.max_memory_allocated(
            dev), digest=[tensor_digest(y), tensor_digest(gx)] + [
                tensor_digest(g[k]) for k in sorted(g)])
    saved["pipeline"] = (y.cpu(), gx.cpu(), {k: v.cpu() for k, v in
                                             g.items()})
    res["pipeline"]["seconds"] = time.perf_counter() - t0


def pc_rank_moe(dev, devices, res, saved):
    """Phase 24 (b) in a rank: moe_apply at ep = 2 (four experts a rank)
    and at dp = 2 (2048 rows a rank); one warm and one timed call each."""
    from mxnet_tpu_torch import parallel

    t0 = time.perf_counter()
    x, gl, params, cy, cp = pc_moe_data(dev)
    res["moe"] = {}
    for case, axes in (("ep2", {"ep": SHARD_RANKS}),
                       ("dp2", {"dp": SHARD_RANKS})):
        mesh = parallel.make_mesh(axes, devices=devices)
        xs, gls, cys, cps = (parallel.shard_batch(t, mesh)
                             for t in (x, gl, cy, cp))
        pc_moe_call(xs, gls, params, cys, cps, mesh)
        (y, dropped, g), ms, counts = pc_timed(
            lambda: pc_moe_call(xs, gls, params, cys, cps, mesh))
        res["moe"][case] = dict(ms=ms, launches=counts, dropped=dropped,
                                rows=int(y.shape[0]))
        saved[f"moe/{case}"] = (y.cpu(), {k: v.cpu() for k, v in g.items()})
    res["moe"]["seconds"] = time.perf_counter() - t0


def pc_rank_nmt(dev, devices, res, saved):
    """Phase 24 (c) in a rank: config 5's Transformer-base step at dp = 2,
    dropout 0, target lengths per row from a seed: step 1 kept, then
    SHARD_STEPS counted and timed steps."""
    from mxnet_tpu_torch import parallel
    from mxnet_tpu_torch.examples import bench_steps as bs

    t0 = time.perf_counter()
    batch = pc_nmt_batch(dev)
    step = pc_nmt_step(dev, batch)
    mesh = parallel.make_mesh(dp=SHARD_RANKS, devices=devices)
    tr = bs.spmd_trainer(step, NMT_TRAIN_LR, mesh=mesh)
    loss1 = float(tr.step(*batch))
    saved["nmt"] = shard_tracked(tr, PC_NMT_TRACKED)
    torch.cuda.synchronize()
    reset_kernel_counts()
    ms = []
    for _ in range(SHARD_STEPS):
        t1 = time.perf_counter()
        float(tr.step(*batch))
        ms.append((time.perf_counter() - t1) * 1e3)
    res["nmt"] = dict(loss1=loss1, ms=ms, launches=kernel_counts(),
                      seconds=time.perf_counter() - t0)
    del tr, step
    gc_cuda()


def pc_pure_stage(blocks):
    """A pure stage of Gluon blocks run in order: (fn, parameters), fn(p,
    x) the blocks in training mode (batch statistics, the fused units)
    with p swapped in by torch.func.functional_call and each running
    statistic given as a copy, so a call reads the running statistics
    and writes none."""
    from mxnet_tpu_torch.gluon.block import ActiveTrace

    seq = torch.nn.Sequential(*blocks)
    bufs = dict(seq.named_buffers())

    def fn(p, x):
        with ActiveTrace(train=True):
            return torch.func.functional_call(
                seq, {**p, **{k: b.clone() for k, b in bufs.items()}}, (x,))
    return fn, {k: v.detach() for k, v in seq.named_parameters()}


def pc_hetero(card, dev):
    """Phase 24 (d): HeteroPipeline over ResNet-50 v1 (bf16, NHWC, fused
    units with the fused backward) cut at its features children into
    three stages, batch PC_HETERO_BATCH as PC_HETERO_MICRO microbatches,
    against the unsplit net on the same microbatches."""
    from mxnet_tpu_torch import init, parallel
    from mxnet_tpu_torch.gluon.model_zoo import vision

    set_knobs(True, True)
    net = vision.resnet50_v1(classes=1000, layout="NHWC")
    net.initialize(init.Xavier(), ctx=dev, seed=PC_SEED)
    net.cast("bfloat16")
    kids = list(net.features._modules.values())
    cuts = (0,) + PC_HETERO_CUTS + (len(kids),)
    groups = [kids[a:b] for a, b in zip(cuts, cuts[1:])]
    groups[-1] = groups[-1] + [net.output]
    stages = [pc_pure_stage(g) for g in groups]
    count = torch.cuda.device_count() if dev.type == "cuda" else 1
    devs = [torch.device(dev.type, i % count) for i in range(len(stages))]
    pipe = parallel.HeteroPipeline([f for f, _ in stages],
                                   [p for _, p in stages], devices=devs)
    whole, wp = pc_pure_stage(kids + [net.output])
    buffers0 = snapshot(net)
    gen = torch.Generator(device=dev).manual_seed(PC_SEED + 4)
    x = torch.rand(PC_HETERO_BATCH, 224, 224, 3, generator=gen,
                   device=dev).to(torch.bfloat16)
    labels = torch.randint(0, 1000, (PC_HETERO_BATCH,), generator=gen,
                           device=dev)
    m = PC_HETERO_BATCH // PC_HETERO_MICRO
    micro = [slice(j * m, (j + 1) * m) for j in range(PC_HETERO_MICRO)]

    def loss_fn(y, t):
        return F.cross_entropy(y.float(), t)

    # forward: the pipe against the unsplit net, microbatch by microbatch
    y, fwd_ms, fwd_counts = pc_timed(
        lambda: pipe(x, n_microbatch=PC_HETERO_MICRO))
    with torch.no_grad():
        ref = torch.cat([whole(wp, x[s]) for s in micro])
    out = dict(forward=dict(ms=fwd_ms, launches=fwd_counts,
                            rel_l2=rel_l2(y.float(), ref.float()),
                            bit_identical=torch.equal(y, ref)))
    # value_and_grad: GPipe with recompute against a plain loop
    pipe.value_and_grad(loss_fn, x, labels, n_microbatch=PC_HETERO_MICRO)
    (loss, grads), ms, counts = pc_timed(lambda: pipe.value_and_grad(
        loss_fn, x, labels, n_microbatch=PC_HETERO_MICRO))
    leaves = {k: v.detach().requires_grad_() for k, v in wp.items()}
    ref_g = {k: torch.zeros_like(v) for k, v in wp.items()}
    ref_loss = 0.0
    for s in micro:
        lv = loss_fn(whole(leaves, x[s]), labels[s])
        for k, gk in zip(leaves, torch.autograd.grad(lv, list(
                leaves.values()))):
            ref_g[k] = ref_g[k] + gk
        ref_loss += float(lv.detach())
    ref_loss /= PC_HETERO_MICRO
    got_g = {}
    for i, g in enumerate(grads):
        for k, v in g.items():
            j, rest = k.split(".", 1)
            got_g[f"{cuts[i] + int(j)}.{rest}"] = v.to(dev)
    ref_g = {k: v * (1.0 / PC_HETERO_MICRO) for k, v in ref_g.items()}
    same = sum(int(torch.equal(got_g[k], ref_g[k])) for k in ref_g)
    flat = lambda d: torch.cat([d[k].float().reshape(-1) for k in sorted(d)])
    out["grad"] = dict(
        ms=ms, launches=counts, loss=loss, loss_ref=ref_loss,
        loss_rel=abs(loss - ref_loss) / abs(ref_loss),
        rel_l2=rel_l2(flat(got_g), flat(ref_g)),
        bit_identical=same, tensors=len(ref_g),
        keys_match=sorted(got_g) == sorted(ref_g))
    out["running_stats_unchanged"] = all(
        torch.equal(v, buffers0[k]) for k, v in snapshot(net).items())
    out["devices"] = [str(d) for d in devs]
    out["stages"] = [len(g) for g in groups]
    del net, pipe, stages, whole, wp, leaves, grads, ref_g, got_g, x
    gc_cuda()
    return out


def pc_attention_checks(card):
    """Kernel 5 at phase 24's shapes: (a) a microbatch of 8 x 128 of
    BERT-base (12 heads of 64, every key valid); (c) a dp = 2 rank's 32
    rows of Transformer-base at 64 tokens (8 heads of 64): the encoder's
    self-attention, the decoder's causal self-attention and its cross
    attention, key masks from the rank's lengths."""
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(PC_SEED + 5)

    def randn(*shape):
        return torch.randn(*shape, generator=gen).to(dev, torch.bfloat16)
    mb = BATCH // PC_MICRO
    recs = {"pipe": check_attention(
        f"pipe.bert.b{mb}", *(randn(mb, BERT_SEQ, BERT_UNITS)
                              for _ in range(3)),
        torch.ones(mb, BERT_SEQ, device=dev), False, card,
        heads=BERT_HEADS)}
    rows, s = PC_NMT_BATCH // SHARD_RANKS, 64
    tv = pc_nmt_batch(torch.device("cpu"))[3][:rows]
    tmask = key_mask(gen, rows, s, lengths=tv.long()).to(dev)
    smask = torch.ones(rows, s, device=dev)
    for name, mask, causal in (("enc", smask, False),
                               ("causal", tmask, True),
                               ("cross", smask, False)):
        recs[name] = check_attention(
            f"nmt.dp2.{name}", *(randn(rows, s, NMT_UNITS) for _ in range(3)),
            mask, causal, card, heads=NMT_HEADS)
    return recs


def phase_parallel_c(card, out_dir, backend, recs_pc):
    """Phase 24: expert and pipeline parallelism (ROADMAP queue A item 7,
    cut (c)).  Cases (a)-(c) ran in phase 23's two ranks (pc_rank_*);
    this process holds them against one-process runs of the same seeded
    weights, and runs (d) itself."""
    from mxnet_tpu_torch import _graphs as graphs
    from mxnet_tpu_torch import parallel
    from mxnet_tpu_torch.examples import bench_steps as bs

    t0 = time.perf_counter()
    step, w0 = KEEP.pop("shard_bert")
    dev = next(step.parameters()).device
    ranks = []
    for r in range(SHARD_RANKS):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            ranks.append(json.load(f)["pc"])
    saved = [torch.load(os.path.join(out_dir, f"rank{r}_pc.pt"))
             for r in range(SHARD_RANKS)]
    rank_s = KEEP["ranks"]["pc_s"]
    res = {"rank_seconds": rank_s}
    # (a) pipeline_apply at pp = 2 against the stages one after the other
    shard_restore(step, w0)
    layers = list(step.bert.encoder.layers._modules.values())
    stage = pc_bert_stage(layers[:len(layers) // PC_STAGES])
    stacked = pc_bert_stacked(layers)
    x, c = pc_seeded(dev, PC_SEED, (BATCH, BERT_SEQ, BERT_UNITS),
                     (BATCH, BERT_SEQ, BERT_UNITS))
    (y, g, gx), ms1, counts1 = pc_timed(
        lambda: pc_pipe_call(stage, stacked, x, c, None))
    del step, w0, layers, stage, stacked
    gc_cuda()
    gy, ggx, gg = saved[0]["pipeline"]
    flat = lambda d: torch.cat([d[k].float().reshape(-1) for k in sorted(d)])
    errs = {"y": rel_l2(gy.float(), y.float().cpu()),
            "x_grad": rel_l2(ggx.float(), gx.float().cpu()),
            "param_grads": rel_l2(flat(gg), flat(g).cpu())}
    worst = max(((rel_l2(gg[k].float(), g[k].float().cpu()), k)
                 for k in g if float(g[k].float().norm()) > 0),
                key=lambda t: t[0])
    want_k5 = BERT_LAYERS // PC_STAGES * (PC_MICRO + PC_STAGES - 1)
    recs = [rk["pipeline"] for rk in ranks]
    res["pipeline"] = dict(
        rel_l2=errs, worst_tensor=list(worst),
        ranks_agree=recs[0]["digest"] == recs[1]["digest"],
        ms=[r_["ms"] for r_ in recs], pp1_ms=ms1,
        launches=[r_["launches"] for r_ in recs], pp1_launches=counts1,
        peak_gib=[r_["peak_bytes"] / 2 ** 30 for r_ in recs])
    print(f"parallel_c (a) pipeline_apply, BERT-base's 12 layers as "
          f"{PC_STAGES} stages at pp={PC_STAGES}, batch {BATCH} x {BERT_SEQ} "
          f"as {PC_MICRO} microbatches: rel L2 to the stages in one process "
          f"{ {k: round(v, 6) for k, v in errs.items()} } (bound {PC_BOUND}; "
          f"worst tensor {worst[1]} {worst[0]:.4g}); ranks agree "
          f"{res['pipeline']['ranks_agree']}; ms a call per rank "
          f"{[round(r_['ms'], 1) for r_ in recs]} (pp=1 {ms1:.1f}); kernel "
          f"5 launches per rank {[r_['launches']['k5'] for r_ in recs]} "
          f"(want {want_k5}); peak "
          f"{[round(r_['peak_bytes'] / 2 ** 30, 2) for r_ in recs]} GiB "
          f"[{card}]", flush=True)
    if max(errs.values()) > PC_BOUND or not res["pipeline"]["ranks_agree"]:
        fail("parallel_c (a): pipeline_apply differs from the stages")
    for r_ in recs:
        if r_["launches"] != {"k1": 0, "k2": 0, "k5": want_k5, "k6": 0}:
            fail(f"parallel_c (a): launches {r_['launches']}")
    del y, g, gx, gy, ggx, gg
    # (b) moe_apply at ep = 2 and dp = 2 against one call at ep = 1
    xm, gl, params, cy, cp = pc_moe_data(dev)
    (y1, drop1, g1), ms1, _ = pc_timed(
        lambda: pc_moe_call(xm, gl, params, cy, cp, None))
    res["moe"] = {"ep1": dict(ms=ms1, dropped=drop1)}
    half = PC_TOKENS // SHARD_RANKS
    for case in ("ep2", "dp2"):
        recs = [rk["moe"][case] for rk in ranks]
        got = [s_[f"moe/{case}"] for s_ in saved]
        if case == "ep2":
            y2, g2 = got[0]
        else:
            y2 = torch.cat([got_[0] for got_ in got])
            g2 = {k: (torch.cat([got_[1][k] for got_ in got])
                      if k in ("x", "gl") else
                      sum(got_[1][k].float() for got_ in got))
                  for k in g1}
        errs = {"y": rel_l2(y2.float(), y1.float().cpu())}
        errs.update({f"grad_{k}": rel_l2(g2[k].float(), g1[k].float().cpu())
                     for k in g1})
        res["moe"][case] = dict(
            rel_l2=errs, y_bit_identical=torch.equal(y2, y1.cpu()),
            dropped=[r_["dropped"] for r_ in recs],
            ms=[r_["ms"] for r_ in recs], rows=[r_["rows"] for r_ in recs])
        print(f"parallel_c (b) moe_apply {case}: {PC_EXPERTS} BERT-base FFN "
              f"experts, T={PC_TOKENS}, capacity {PC_CAPACITY}: dropped_frac "
              f"{[r_['dropped'] for r_ in recs]} (ep=1 {drop1:.6f}); rel L2 "
              f"to ep=1 { {k: round(v, 6) for k, v in errs.items()} } "
              f"(bound {PC_BOUND}), y bit for bit "
              f"{res['moe'][case]['y_bit_identical']}; rows a rank "
              f"{[r_['rows'] for r_ in recs]}; ms a call per rank "
              f"{[round(r_['ms'], 2) for r_ in recs]} (ep=1 {ms1:.2f}) "
              f"[{card}]", flush=True)
        if max(errs.values()) > PC_BOUND or not 0 < drop1 < 1 or any(
                r_["dropped"] != drop1 for r_ in recs) or \
                [r_["rows"] for r_ in recs] != (
                    [PC_TOKENS] * 2 if case == "ep2" else [half] * 2):
            fail(f"parallel_c (b) {case}: moe_apply differs from ep=1")
    got = saved[0]["nmt"]
    del xm, gl, params, cy, cp, y1, g1, saved
    gc_cuda()
    # (c) Transformer-base at dp = 2 against a dp = 1 step
    batch = pc_nmt_batch(dev)
    step = pc_nmt_step(dev, batch)
    tr = bs.spmd_trainer(step, NMT_TRAIN_LR,
                         mesh=parallel.make_mesh(dp=1, devices=[dev]))
    with graphs.no_capture():
        loss_ref, ms1, counts1 = pc_timed(lambda: float(tr.step(*batch)))
    ref = shard_tracked(tr, PC_NMT_TRACKED)
    del tr, step
    gc_cuda()
    rec = ranks[0]["nmt"]
    dl = abs(rec["loss1"] - loss_ref) / abs(loss_ref)
    errs = {n: (rel_l2(got[n][0], ref[n][0]), rel_l2(got[n][1], ref[n][1]))
            for n in PC_NMT_TRACKED}
    res["nmt"] = dict(loss1=rec["loss1"], loss_ref=loss_ref, loss_rel=dl,
                      rel_l2={n: list(e) for n, e in errs.items()},
                      ms=[rk["nmt"]["ms"] for rk in ranks],
                      launches=[rk["nmt"]["launches"] for rk in ranks],
                      dp1_ms=ms1, dp1_launches=counts1)
    want = {"k1": 0, "k2": 0, "k5": counts1["k5"] * SHARD_STEPS, "k6": 0}
    print(f"parallel_c (c) transformer-base (config 5) dp=2, batch "
          f"{PC_NMT_BATCH} x 64, target lengths "
          f"{int(batch[3][:PC_NMT_BATCH // 2].sum())} + "
          f"{int(batch[3][PC_NMT_BATCH // 2:].sum())} tokens on the ranks: "
          f"step 1 loss {rec['loss1']:.6f} vs dp=1 {loss_ref:.6f} (rel "
          f"{dl:.3g}); weight / Adam mean rel L2 to dp=1 "
          f"{ {n.split('.')[-2]: [round(v, 6) for v in e] for n, e in errs.items()} } "
          f"(bound {PC_BOUND}); ms a step per rank "
          f"{[[round(v, 1) for v in rk['nmt']['ms']] for rk in ranks]} "
          f"(dp=1 eager {ms1:.1f}); launches per rank "
          f"{[rk['nmt']['launches'] for rk in ranks]} (want {want}: dp=1's "
          f"{counts1['k5']} a step) [{card}]", flush=True)
    if dl > PC_BOUND or any(max(e) > PC_BOUND for e in errs.values()):
        fail("parallel_c (c): the dp=2 step differs from dp=1")
    if not counts1["k5"] or any(rk["nmt"]["launches"] != want
                                for rk in ranks):
        fail(f"parallel_c (c): launches {res['nmt']['launches']}, want "
             f"{want}")
    # (d) HeteroPipeline in this process
    res["hetero"] = h = pc_hetero(card, dev)
    want_fwd = FWD_PER_STEP * PC_HETERO_MICRO
    want = {"k1": 2 * want_fwd, "k2": BWD_PER_STEP * PC_HETERO_MICRO,
            "k5": 0, "k6": 0}
    print(f"parallel_c (d) HeteroPipeline, ResNet-50 v1 bf16 NHWC fused in "
          f"{len(h['stages'])} stages of {h['stages']} features children on "
          f"{h['devices']}, batch {PC_HETERO_BATCH} as {PC_HETERO_MICRO} "
          f"microbatches: pipe(x) vs the unsplit net rel L2 "
          f"{h['forward']['rel_l2']:.3g} (bit for bit "
          f"{h['forward']['bit_identical']}), {h['forward']['ms']:.1f} ms, "
          f"launches {h['forward']['launches']}; value_and_grad loss "
          f"{h['grad']['loss']:.6f} vs the plain loop {h['grad']['loss_ref']:.6f}"
          f", gradients rel L2 {h['grad']['rel_l2']:.3g}, "
          f"{h['grad']['bit_identical']} of {h['grad']['tensors']} tensors bit "
          f"for bit; {h['grad']['ms']:.1f} ms, launches "
          f"{h['grad']['launches']} (want {want}, the recompute's included); "
          f"running statistics unchanged {h['running_stats_unchanged']} "
          f"[{card}]", flush=True)
    if h["forward"]["rel_l2"] > PC_BOUND or h["grad"]["rel_l2"] > PC_BOUND \
            or h["grad"]["loss_rel"] > PC_BOUND \
            or not h["grad"]["keys_match"] \
            or not h["running_stats_unchanged"]:
        fail("parallel_c (d): HeteroPipeline differs from the unsplit net")
    if h["forward"]["launches"] != dict(want, k1=want_fwd, k2=0) \
            or h["grad"]["launches"] != want:
        fail(f"parallel_c (d): launches {h['forward']['launches']}, "
             f"{h['grad']['launches']}")
    rows = BATCH // PC_MICRO
    summaries = [
        dict(attention_path_summary(
            dict(KERNEL_ATT, name="dot_product_attention/pipeline_pp2"),
            "bert_pipeline_pp2", [(recs_pc["att"]["pipe"], 6 * (
                PC_MICRO + PC_STAGES - 1))],
            res["pipeline"]["launches"][0]["k5"], rows),
            backend=backend, ranks=SHARD_RANKS),
        dict(attention_path_summary(
            dict(KERNEL_ATT, name="dot_product_attention/nmt_dp2"),
            "transformer_dp2", [(recs_pc["att"][k], NMT_LAYERS)
                                for k in ("enc", "causal", "cross")],
            res["nmt"]["launches"][0]["k5"], PC_NMT_BATCH // SHARD_RANKS),
            backend=backend, ranks=SHARD_RANKS),
        dict(kernel_summary(dict(KERNEL, name="fused_conv_unit/hetero"),
                            recs_pc["k1"], "train_pipe",
                            h["grad"]["launches"]["k1"]),
             path="train_hetero_pipeline"),
        dict(kernel_summary(dict(KERNEL_BWD,
                                 name="fused_conv_unit_bwd/hetero"),
                            recs_pc["k2"], "train_pipe",
                            h["grad"]["launches"]["k2"]),
             path="train_hetero_pipeline")]
    res["seconds"] = time.perf_counter() - t0 + rank_s
    print(f"parallel_c: phase 24 took {res['seconds']:.1f} s (its rank work "
          f"{rank_s:.1f} s in phase 23's ranks; limit {PC_SECONDS:.0f} s) "
          f"[{card}]", flush=True)
    print("parallel_c: " + json.dumps(res), flush=True)
    if res["seconds"] > PC_SECONDS:
        fail(f"parallel_c: phase 24 took {res['seconds']:.1f} s, over "
             f"{PC_SECONDS:.0f} s")
    return res, summaries


def phase_kernels_pc(card):
    """Phase 24's kernel checks at its paths' shapes: kernel 5 (see
    pc_attention_checks), kernels 1 (with statistics) and 2 at (d)'s
    microbatch of N = PC_HETERO_BATCH / PC_HETERO_MICRO."""
    n = PC_HETERO_BATCH // PC_HETERO_MICRO
    k1, k2 = kernels_at(n, 2424, "train_pipe",
                        f"phase 24 (d)'s microbatch, N={n}")
    return {"att": pc_attention_checks(card), "k1": k1, "k2": k2}


PHASE_SECONDS = {}


def timed(label, fn, *args):
    """``fn(*args)``, its seconds printed as ``phase <label>: <s> s`` and
    kept in PHASE_SECONDS (printed together at the end)."""
    t0 = time.perf_counter()
    try:
        return fn(*args)
    finally:
        PHASE_SECONDS[label] = time.perf_counter() - t0
        print(f"phase {label}: {PHASE_SECONDS[label]:.1f} s", flush=True)


def main():
    if "--naive-engine" in sys.argv:
        return naive_engine_child()
    for flag, part in (("--kv-shard-rank", kv_shard_rank),):
        if flag not in sys.argv:
            continue
        import argparse

        ap = argparse.ArgumentParser()
        ap.add_argument(flag, action="store_true")
        ap.add_argument("--dp-dir", required=True)
        ap.add_argument("--dp-backend", required=True)
        ap.add_argument("--dp-devices", required=True)
        a = ap.parse_args()
        return part(a.dp_dir, a.dp_backend, a.dp_devices.split(","))
    for flag, part in (("--dp-rank", dp_rank), ("--zero-rank", zero_rank)):
        if flag in sys.argv:
            import argparse

            ap = argparse.ArgumentParser()
            ap.add_argument(flag, type=int, required=True, dest="rank")
            ap.add_argument("--dp-dir", required=True)
            ap.add_argument("--dp-backend", required=True)
            ap.add_argument("--dp-devices", required=True)
            a = ap.parse_args()
            return part(a.rank, a.dp_dir, a.dp_backend,
                        a.dp_devices.split(","))
    card = timed("1 device", phase_device)
    timed("2 build", phase_build)
    recs = timed("3 kernels", phase_kernels)
    recs_bwd = timed("3 kernels_bwd", phase_kernels_bwd, card)
    recs_att = timed("3 kernels_attention", phase_kernels_attention, card)
    main_res = timed("4 serve", phase_main, card, REQUESTS, THREADS)
    bert_res = timed("4b bert", phase_bert, card, REQUESTS, THREADS)
    train_res, train_refs = timed("5 train", phase_train, card)
    recs_dp, recs_bwd_dp = timed("6 kernels_dp", phase_kernels_dp)
    dp_res = timed("6 dp", phase_dp, card, train_refs)
    recs_tap = timed("7 kernels_tap", phase_kernels_tap)
    probe_res = timed("7 probe", phase_probe, card)
    timed("7 profile", profile_probe_layers, card)
    imp_res = timed("8 imperative", phase_imperative, card, train_refs)
    recs_dec = timed("9 kernels_decode", phase_kernels_decode, card)
    tf_res = timed("9 transformer", phase_transformer, card)
    timed("10 ssd", phase_ssd, card)
    _, sym_kernels = timed("11 symbolic", phase_symbolic, card, recs_att)
    gluon_res = timed("12 gluon", phase_gluon, card)
    opt_res = timed("13 optimizers", phase_optimizers, card, train_res,
                    gluon_res)
    timed("14 ops", phase_ops, card)
    timed("15 rnn", phase_rnn, card)
    timed("16 core", phase_core, card)
    vis = timed("17 vision", phase_vision, card, train_res)
    img = timed("18 imagenet", phase_imagenet, card, train_res)
    _, quant_kernels = timed("19 quant", phase_quant, card)
    timed("20 custom_onnx", phase_custom_onnx, card)
    timed("21 item9", phase_item9, card)
    timed("22-24 ranks", launch_kv_shard, card)
    kv_res = timed("22 kvstore", phase_kvstore, card)
    recs_kv, recs_bwd_kv = timed("22 kernels_kv", phase_kernels_kv)
    shard_res, shard_kernels = timed("23 sharded", phase_sharded, card,
                                     recs_att)
    recs_pc = timed("24 kernels_pc", phase_kernels_pc, card)
    pc_kernels = []
    if "out_dir" in shard_res:  # phase 23's ranks ran phase 24's (a)-(c)
        _, pc_kernels = timed("24 parallel_c", phase_parallel_c, card,
                              shard_res["out_dir"], shard_res["backend"],
                              recs_pc)
    dec_steps = tf_res["decode"]["steps"]
    dp_keys = dict(backend=dp_res.get("backend"), ranks=DP)
    # kernel 1 once for each main path (its shapes and launches), kernel 2
    # for each training path
    summaries = [
        kernel_summary(KERNEL, recs, "serve", main_res.get("launches", 0)),
        kernel_summary(dict(KERNEL, name="fused_conv_unit/train"), recs,
                       "train", train_res["launches"]["fwd"]),
        kernel_summary(KERNEL_BWD, recs_bwd, "train",
                       train_res["launches"]["bwd"]),
        dict(kernel_summary(dict(KERNEL, name="fused_conv_unit/gluon"),
                            recs, "train", imp_res["launches"]["fwd"]),
             path="train_gluon"),
        dict(kernel_summary(dict(KERNEL_BWD,
                                 name="fused_conv_unit_bwd/gluon"),
                            recs_bwd, "train", imp_res["launches"]["bwd"]),
             path="train_gluon"),
        attention_summary(recs_att, bert_res.get("launches", 0)),
        # phase 4b's HTTP part: the same served forward behind serve_http,
        # at the buckets its batches ran at, summed over all of (a)
        http_summary(bert_res.get("http", {})),
        dict(kernel_summary(KERNEL_DP, recs_dp, "train_dp",
                            dp_res["launches"]["fwd"]), **dp_keys),
        dict(kernel_summary(KERNEL_BWD_DP, recs_bwd_dp, "train_dp",
                            dp_res["launches"]["bwd"]), **dp_keys),
        tap_summary(recs_tap, probe_res["launches"]["tap"]),
        attention_path_summary(
            KERNEL_ATT_BERT, "bert_pretrain_dropout0",
            [(recs_att["bert.packed"], BERT_LAYERS)],
            tf_res["bert_dropout0"]["launches"], BATCH),
        attention_path_summary(
            KERNEL_ATT_DECODE, "transformer_greedy_decode",
            [(recs_dec["encoder"], NMT_LAYERS)]
            + [(recs_dec[(kind, s)], NMT_LAYERS)
               for s in range(1, dec_steps + 1)
               for kind in ("causal", "cross")],
            tf_res["decode"]["launches"], DECODE_BATCH),
        # the captured gluon.Trainer path (phase 8) and BERT-base through
        # the hybridized gluon.Trainer loop at dropout 0 (phase 12 (a))
        dict(kernel_summary(dict(KERNEL, name="fused_conv_unit/gluon_graph"),
                            recs, "train", imp_res["captured"]["launches"][
                                "fwd"]), path="train_gluon_captured"),
        dict(kernel_summary(dict(KERNEL_BWD,
                                 name="fused_conv_unit_bwd/gluon_graph"),
                            recs_bwd, "train",
                            imp_res["captured"]["launches"]["bwd"]),
             path="train_gluon_captured"),
        attention_path_summary(
            dict(KERNEL_ATT, name="dot_product_attention/bert_gluon"),
            "bert_gluon_dropout0", [(recs_att["bert.packed"], BERT_LAYERS)],
            gluon_res["bert_dropout0"]["launches"], BATCH),
        # phase 13: BERT-base with LAMB through the gluon loop, ResNet-50
        # with centred RMSProp through SPMDTrainer
        attention_path_summary(
            dict(KERNEL_ATT, name="dot_product_attention/bert_lamb"),
            "bert_gluon_lamb", [(recs_att["bert.packed"], BERT_LAYERS)],
            opt_res["bert_lamb"]["launches"], BATCH),
        dict(kernel_summary(dict(KERNEL, name="fused_conv_unit/rmsprop"),
                            recs, "train", int(opt_res["resnet_rmsprop"][
                                "launches_per_step"]["k1"] * CAPTURE_K)),
             path="train_rmsprop_centered"),
        dict(kernel_summary(dict(KERNEL_BWD,
                                 name="fused_conv_unit_bwd/rmsprop"),
                            recs_bwd, "train", int(opt_res["resnet_rmsprop"][
                                "launches_per_step"]["k2"] * CAPTURE_K)),
             path="train_rmsprop_centered")] + sym_kernels + [
        # phase 17: under remat (b), under ZeRO at dp = 2 (d, the per-rank
        # shapes of phase 6), with multi_precision (e)
        dict(kernel_summary(dict(KERNEL, name="fused_conv_unit/remat"),
                            recs, "train", vis["remat_v1"]["launches"]),
             path="train_remat"),
        dict(kernel_summary(dict(KERNEL_BWD,
                                 name="fused_conv_unit_bwd/remat"),
                            recs_bwd, "train",
                            vis["remat_v1"]["launches_bwd"]),
             path="train_remat"),
        dict(kernel_summary(dict(KERNEL_DP, name="fused_conv_unit/zero_dp2"),
                            recs_dp, "train_dp",
                            vis["zero"]["launches"]["fwd"]),
             path="train_zero_dp2", backend=vis["zero"].get("backend"),
             ranks=DP),
        dict(kernel_summary(dict(KERNEL_BWD_DP,
                                 name="fused_conv_unit_bwd/zero_dp2"),
                            recs_bwd_dp, "train_dp",
                            vis["zero"]["launches"]["bwd"]),
             path="train_zero_dp2", backend=vis["zero"].get("backend"),
             ranks=DP),
        dict(kernel_summary(dict(KERNEL,
                                 name="fused_conv_unit/multi_precision"),
                            recs, "train", vis["mp"]["launches"]["fwd"]),
             path="train_multi_precision"),
        dict(kernel_summary(dict(KERNEL_BWD,
                                 name="fused_conv_unit_bwd/multi_precision"),
                            recs_bwd, "train", vis["mp"]["launches"]["bwd"]),
             path="train_multi_precision"),
        # phase 18: ResNet-50 fed from a .rec by ImageRecordIter
        dict(kernel_summary(dict(KERNEL, name="fused_conv_unit/imagenet_rec"),
                            recs, "train", img["launches"]["fwd"]),
             path="train_imagenet_rec"),
        dict(kernel_summary(dict(KERNEL_BWD,
                                 name="fused_conv_unit_bwd/imagenet_rec"),
                            recs_bwd, "train", img["launches"]["bwd"]),
             path="train_imagenet_rec")] + quant_kernels + [
        # phase 22: a rank of gluon.Trainer(kvstore='dist_sync')
        dict(kernel_summary(dict(KERNEL, name="fused_conv_unit/kvstore"),
                            recs_kv, "train_kv", kv_res["launches"]["fwd"]),
             path="train_kvstore_dist_sync", backend=kv_res.get("backend"),
             ranks=DP),
        dict(kernel_summary(dict(KERNEL_BWD,
                                 name="fused_conv_unit_bwd/kvstore"),
                            recs_bwd_kv, "train_kv",
                            kv_res["launches"]["bwd"]),
             path="train_kvstore_dist_sync", backend=kv_res.get("backend"),
             ranks=DP)] + shard_kernels + pc_kernels
    print(f"chip_smoke: {time.perf_counter() - T_START:.1f} s", flush=True)
    print("phase_seconds: " + json.dumps(
        {k: round(v, 1) for k, v in PHASE_SECONDS.items()}), flush=True)
    if FAILURES:
        print(f"chip_smoke: {len(FAILURES)} failure(s)", flush=True)
        return 1
    print(f"card: {card}", flush=True)
    print(json.dumps({"kernels": summaries}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
