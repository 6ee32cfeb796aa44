#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``distributed_tpu_torch``) on one card.

    python3 chip_smoke.py

Needs one NVIDIA card (Hopper: the kernels are built for sm_90a) and
``nvcc``. It drives the port only and imports nothing of JAX or of the JAX
package. Phases, in order; any failure exits non-zero:

a. Build every kernel source in ``distributed_tpu_torch/csrc`` with
   ``nvcc``, one process per source, all at once; print the build time,
   ptxas's register and spill report, and the card's name and power limit.
   For the Hopper kernels (wgmma: the flash forward, dQ and dK/dV in bf16
   and f16 at widths 64, 128 and 256, and the 1x1-conv GEMM), one line
   each: registers, spills, the dynamic shared memory a block asks for, and
   the count of HGMMA instructions in their SASS (``cuobjdump``, where the
   toolkit has it; none exits).
b. Paged attention: each kernel against its plain PyTorch version on the
   card, at the serving shapes (S=8 slots, H=12 heads, hd=64, block 16, 64
   table entries), f32/bf16 and int8 pools, kw 1 and 4, and (a
   speculative verify's query rows, past the kernel's row group of 8)
   bf16 and int8 at kw 8 and 12, mixed positions with trash-table slots,
   and a full server (8 slots at position 1,023, each on its own table)
   in f32, bf16 and int8; max abs error against the stated tolerance. At
   both shapes, bf16 kw 1: per-launch time (CUDA events, pools rotated
   past the 50 MB L2) beside the plain version's time and the bound, with
   the share of the bound; at the mixed positions also kw 4 and 12 (one
   launch each). Then every head
   width class: hd 8, 24 and 256 (in place, no copy of the pools; 8 and 24
   read element by element from int8 pools), bf16, f16 and int8 pools,
   each against its plain version.
c. Engine at full width: the GPT-2-small LM (vocab 32768, 12 layers,
   d_model 768, 12 heads, max_len 1024, bf16 layers, random weights from
   seed 0) served by ``Engine(max_slots=8, block_size=16, max_len=1024)``
   with ``decode_kernel="fused"``: 16 greedy requests, prompts of 32-512
   tokens, 64-128 new tokens. Launch counts are zeroed just before and
   read just after. The same requests again with ``"reference"``: the
   first tokens (from prefill) must match; the agreement share is printed.
d. The same width at 2 layers in f32 with TF32 off: fused and reference
   must be token-exact.
e. int8 KV at full width, fused (counts zeroed before, read after):
   tokens/s and the agreement share with phase c.
f. Fused cross-entropy: both kernels against their plain versions at the
   LM head's N=32768 rows of C=32768 bf16 logits (losses to 1e-4, every
   dlogit to one bf16 ulp of its own value), then timed on the same
   inputs (each launch after an L2 flush) beside the plain version,
   ``F.cross_entropy`` (the library yardstick, timed only) and the bound.
g. Flash attention: forward, dQ and dK/dV against the plain versions at
   B=32, T=1024, H=12, D=64, causal, bf16 and f32, and at B=8, T=1024,
   H=6, D=128 in bf16: every entry of O, dQ, dK, dV within ``FLASH_TOL``,
   O's relative L2 error within ``O_REL_L2``, ``m`` within 1e-5. Timed in bf16 beside the plain versions and
   ``F.scaled_dot_product_attention``'s forward and whole backward in the
   same call, with each kernel's TFLOP/s and the bound; dQ + dK/dV summed
   against SDPA's backward. Then every head width and f16: the three
   kernels at D 8, 24 and 256 in bf16 and f16, and at D 64 in f16 (B 2, T
   1000, H 4, causal, inputs on a 1/8 grid; f16 limits atol 5e-4 + rtol
   5e-3; O's entries may also differ by one ulp of each 16-bit
   probability times |v|), each against its plain version; every 16-bit
   launch of the phase on the wgmma route (dQ included).
h. Training at full width: the GPT-2-small LM (bf16 layers) compiled with
   ``Adam(1e-4)``, the pallas loss and accuracy, batch 32 x 1024 tokens
   from ``numpy.random.default_rng(0)``; 2 warm-up steps, then 5 timed
   steps through ``fit`` (counts zeroed just before, read just after):
   per-step losses (finite, falling on the repeated batch), steps/s,
   tokens/s, MFU, launches per step (the flash forward, dQ and dK/dV all on
   their wgmma route) and peak memory.
i. The kernel path against the plain path: a 2-layer f32 LM (TF32 off),
   3 Adam steps with ``flash=True`` and the pallas loss against
   ``flash=False`` and the stock loss; per-step losses must agree to 1e-5
   relative.
j. Fused Adam (K11) against its plain version on GPT-2-small's own
   parameter tree (every leaf and shape), gradients from a seeded
   generator: 3 ``fused_adam`` updates (wd 0) and 3 ``fused_adamw``
   updates (wd 0.01); parameters and both moments must be bit-identical.
   Then timed per update (after an L2 flush) beside the plain ``foreach``
   walk, ``torch.optim.AdamW(fused=True)`` (the library yardstick, timed
   only) and the bytes bound.
k. The reference workload: ``cluster.initialize()`` from a one-worker
   DTPU_CONFIG (an NCCL group of world 1) and a ``DataParallel()`` scope;
   ``mnist_cnn`` as the JAX package's ``bench_mnist`` configures it
   (synthetic images, global batch 256, ``SGD(0.001)``; 10 warm-up and
   100 timed steps) and ``cifar_cnn`` as ``bench_cifar`` does (batch 256
   from ``default_rng(0)``, ``SGD(0.01, momentum=0.9)``; 5 + 50 steps),
   both through ``fit`` with TF32 off: steps/s, images/s, finite losses.
   Then 5 mnist steps under ``DataParallel`` (world 1) and under
   ``SingleDevice`` from the same parameters, cuDNN deterministic: the
   losses must be equal.
l. GPT-2-small under the same ``DataParallel`` scope with
   ``fused_adamw(3e-4, weight_decay=0.01)``, otherwise phase h's
   configuration: 2 warm-up and 5 timed steps (counts zeroed just before,
   read just after): steps/s, tokens/s, MFU, peak memory, launches per
   step of K11 and K3-K10. Then 3 steps with ``fused_adamw`` and 3 with
   the plain ``AdamW`` from the same parameters and batch: the losses
   must be equal. The process group is destroyed at the end.
m. ResNet-50's kernels against their plain versions at the model's own
   shapes, batch 256 at 224x224 (read from the built model): K12 at the 17
   distinct (M, K, N) of a step's 72 products (the 36 1x1 convolutions'
   forwards and their dX products (M, N) @ (N, K)), K13 and K14 at the 12
   distinct (M, C) of its 53 BatchNorms, in bf16, and each at one shape in
   f32; K12 also at (3136, 64, 36) in bf16, N zero-padded to 40. K12: every entry within one bf16 ulp of the plain version's plus
   the f32 sums' rounding bound 2 K 2^-24 sum|x||w| (f32: 2e-5 of that
   sum); K13/K14: rtol 1e-5 plus 1e-5 times the sum of the terms'
   magnitudes (summed in another order), and the same bits on a second
   call. Each launch is timed after an L2 flush beside the plain version,
   the bound and a library call that computes the same function, timed
   only (``torch.matmul``; ``torch.batch_norm_stats`` and
   ``torch.batch_norm_backward_reduce`` on an NCHW view), with each
   call's share of its bound (and K12's TFLOP/s); K13, K14, their plain
   versions and the library calls on the device clock (the host queues
   every call first), with each K13/K14 call's host cost on the enqueue
   clock; every bf16 product on K12's wgmma route, f32 on its CUDA-core
   route; the JSON row holds per-step totals over the 72 products (the 53
   calls).
n. ResNet-50 training as the JAX package's ``bench_resnet50`` configures
   it (``resnet(50, 1000, dtype="bfloat16")``, ``bn_shift="running"``,
   ``stem="conv7"``; ``SGD(0.1, momentum=0.9)``, sparse cross-entropy,
   accuracy; global batch 256 at 224x224x3 from ``default_rng(0)``
   normals, labels in [0, 1000)) under phase k's ``DataParallel``: 3
   warm-up steps, then 20 timed steps through ``fit`` (counts zeroed just
   before, read just after): per-step losses and the BN buffers (finite),
   steps/s, images/s, MFU (8.17 GFLOP forward per image, 2 x 4.09 G
   multiply-adds), peak memory and launches per step: exactly 72 of K12
   (36 forward, 36 dX), all on its wgmma route, and 53 calls of K13 and of
   K14 (``LAUNCHES_PER_CALL`` launches each: one).
o. A small f32 ResNet (``resnet(50, 10, small_inputs=True, stage_blocks=
   (1, 1, 1, 1), width=16)``, 32x32, batch 32), TF32 off, 3 momentum-SGD
   steps from the same parameters on the card (kernels) and on the CPU
   (plain versions): losses within 1e-4 relative. Then, cuDNN
   deterministic, world-1 ``DataParallel`` and ``SingleDevice`` on the
   card: equal losses and equal BN buffers. The process group is
   destroyed at the end.
p. K15, the launch probe, against ``x * 1.0001`` on an (8, 128) f32 tile,
   bit for bit. Then the host's cost of a launch through the binding,
   piece by piece, in 5 rounds that take the pieces in turn (medians
   printed): K15's wrapper and K1's at phase b's bf16 decode shape whole,
   their packed ctypes call alone, the stream read (PyTorch's ``Stream``
   object, and the raw handle), ``torch.empty_like``, K15's plain version
   and ``torch.mul(x, 1.0001)``, each by the differential clock (host
   clock, 10 and 60 launches, each run ending in a synchronize) and the
   enqueue clock (the host's time to issue 50 calls); K15's time over
   ``torch.mul``'s, the library call's, printed as a ratio.
q. float16, which the reference takes wherever these kernels run: K9/K10
   at the LM head's vocabulary (4 x 1024 rows of 32768 f16 logits; losses
   to 1e-4, dlogits to one f16 ulp), K12 at (50176, 256, 1024) and at
   (3136, 64, 36) (N zero-padded to 40; one f16 ulp plus the f32 sums'
   bound), K13/K14 at (200704, 128) and at (100003, 3) (the per-element
   route; phase m's limits, the same bits on a second call), each against
   its plain version with its launches counted; then a small f16 ResNet
   (phase o's, ``dtype="float16"``, the pallas loss) through 3 ``fit``
   steps: finite losses, and every one of K9, K10, K12, K13 and K14
   launched (counts zeroed just before, read just after).
r. Checkpoints, resumed mid-``fit`` under a world-1 ``DataParallel``
   (NCCL): ResNet-50 as phase n configures it, and a 2-layer bf16 LM (d
   128, 2 heads, flash, the pallas loss, ``fused_adamw``; batch 8 x 256).
   Each: run A fits 4 steps with ``ModelCheckpoint(save_freq=2,
   async_save=True)`` and copies params, state and optimizer state to the
   host right after the save; two uninterrupted runs, the first with a
   synchronous save at step 2; run B, a fresh model with
   ``ModelCheckpoint(restore=True)``, resumes at step 2 and runs steps 3-4
   (counts zeroed just before, read just after) from a directory holding
   A's step-2 file, as a run that died before its step-4 save would leave
   it. The async file, B's
   restored tensors and A's step-2 copy must be bit-identical, B's step-3
   loss A's bit for bit, B's step-4 loss within the uninterrupted runs'
   spread (at least 4 f32 ulps), and K12, K13 and K14 (ResNet-50) and
   K3-K5, K9-K11 (the LM) launched in B's steps. npz only (no ``h5py``
   on the card's machine). Printed: the save's blocking time in the loop,
   sync and async, the restore time and the file size.
s. Speculative serving and weight hot-swap through ``Engine``.
   (s1) Phase c's GPT-2-small (bf16 layers, seed 0) and a truncated-depth
   draft (its first 6 blocks plus the embedding, positional table, final
   norm and head, copied by layer name, as ``bench.py``'s serving bench
   builds it), ``Engine(max_slots=8, block_size=16, max_len=1024,
   decode_kernel="fused", draft_model=draft, spec_k=4)`` serving phase
   c's 16 greedy requests (counts zeroed just before, read just after);
   then the same with the target as its own draft. Printed: tokens/s,
   TTFT p50/p99, accept rate, tokens per verify, K1's launches by kw (the
   draft's decodes at kw 1, the verify at kw 4), the host ms a round of
   the draft chain and of the verify (each ending with its tokens on the
   host), and the share of tokens that agree with phase c's fused run;
   the engine's snapshot of the weights in device memory. (s2) Phase d's
   2-layer f32 model, TF32 off: self-draft and a 1-layer truncated draft
   at ``spec_k`` 4 and 12, and int8 KV at 4, each token-exact against the
   same engine without a draft, every K1/K2 launch counted and kw 12
   launched. (s3) ``update_weights`` mid-run through ``on_decode_step``:
   at full width (the blocking time for 136.2M parameters, the
   ``weights_versions`` spans), and on (s2)'s model, where a request
   admitted after the swap must match a fresh engine on the new weights.
t. The fit loop at full width. A kernel's wrapper counts where it
   launches; a CUDA graph's replay runs the kernels without their
   wrappers, so the profiler's trace counts those by name. (t1)
   GPT-2-small (bf16 layers, ``fused_adam(1e-4)``, the pallas loss, batch
   32 x 1024): (a) ``fit(grad_accum=4)`` against the same batches whole,
   2 steps each (losses within bf16 rtol 2e-2; the updates' relative L2
   difference within ``ACCUM_UPDATE_REL`` after each step; K3-K5 and
   K9/K10 launched 4 times a step); (b) ``compile(steps_per_execution=
   4)``, 8 steps with each step's forward and backward replayed from a
   CUDA graph, against K=1 eager from the same start (losses within 2e-2,
   parameters bit-identical; the capturing fit's launches: one warm-up
   and one capture of each step kernel, the eager update's K11); then 8
   replayed steps, counts zeroed just before and read just after: in the
   trace K3-K5, K9-K11 run per step as eager, and the wrappers count K11
   only. Then ms a step in interleaved runs of 8 steps and the card's
   busy share (the trace's union of device ranges against the median
   run's wall); (c) ``fit`` from an iterator at ``prefetch=2``: the
   ``input_wait`` share. (t2) ResNet-50 (bf16, ``SGD(0.1,
   momentum=0.9)``, batch 256, SingleDevice): K=4 against K=1 from the
   same start, 4 steps on cuDNN's deterministic algorithms (parameters
   and BatchNorm buffers bit-identical); K=4 fed by a
   ``data.Pipeline`` of uint8 images at ``prefetch=2`` (the capturing
   fit's launches, then 8 replayed steps: K12-K14 run per step as phase
   n, no wrapper counts), against the K=1 loop on a float array with
   inline staging, K=4 on that array, and the Pipeline staged by
   ``next()`` and ``np.stack`` (fit's path for other iterators), in
   interleaved runs of 8 steps (two an arm) with the busy share; the host-to-device
   copy of a batch and of a K=4 stack, pageable and pinned, on the device
   clock. (t2b) mnist_cnn (phase k's: world-1 NCCL ``DataParallel``,
   batch 256, cuDNN's deterministic algorithms): K=8 against K=1 from the
   same start (losses, parameters bit-identical), then ms a step in
   interleaved runs of 32 steps with the busy share. (t3) ``generate`` at
   GPT-2-small width in f32: 8 prompts of 128 tokens plus 128 greedy ones
   (tokens/s; agreement with the Engine's greedy tokens for the same
   prompts and weights, every first token equal), and a sampled run
   (temperature 0.8, top_k 40) with its tokens in range.
u. The LM's precision and memory options at full width. (u1) Long
   context, as the JAX package's ``bench_longctx`` configures it (vocab
   32768, 12 layers, d 768, 12 heads, bf16 layers, ``max_len=T``,
   ``Adam(1e-4)``, the pallas loss, ``default_rng(0)`` batches; one warm-up
   and 2 timed steps a run, counts zeroed just before the timed steps and
   read just after, each run's peak memory its own): (a) 2 x 4096 with
   and without ``remat=True, remat_policy="dots_with_no_batch_dims_
   saveable"`` from the same start, and with remat as CUDA graphs (K=2):
   ms a step, the device work of one more profiled step, peak memory,
   flash launches a step (K3 twice a layer with remat), parameters after
   3 steps bit-identical; (b) 2 x 4096 with ``compile(head_chunks=8)``
   against without: losses within bf16 rtol 2e-2, K9 and K10 8 launches a
   step, the peak's drop at least the bf16 (tokens x vocab) logits'
   bytes; (c) 1 x 65,536 with remat and ``head_chunks=8``, then 1 x 8192
   and 1 x 16,384 with remat: finite losses, tokens/s, MFU (3 x
   ``_lm_fwd_flops_per_token`` at 989 TFLOP/s), peak memory. (u2) Phase
   h's LM with no ``dtype=`` on its layers and ``fused_adam(1e-4)`` (K11
   over the f32 masters), batch 32 x 1024, under no policy (f32), ``mixed_bfloat16`` and ``mixed_float16``: losses against
   the f32 run (rtol 2e-2), ms a step, MFU, flash launches by dtype and
   route (f16 on the wgmma kernels under ``mixed_float16``), the loss
   scale (2^15, halved once for each skipped step); a forced overflow
   (scale 2^60): parameters, moments and Adam's count unchanged, the
   scale exactly 2^59; ``mixed_float16`` with ``steps_per_execution=4`` (CUDA graphs)
   against K=1, 8 steps: parameters and scale bit-identical. (u3) Phase
   c's GPT-2-small with ``quant.quantize_model``, serving phase c's 16
   greedy requests through ``Engine(decode_kernel="fused")``: K1 once a
   layer and decode step, token and first-token agreement with phase c,
   the snapshot's bytes against the unquantized parameters', tokens/s;
   ``update_weights`` takes the quantized tree and refuses f32 leaves.
v. Weight-stacked blocks (``nn.ScannedBlocks``), each model against its
   unrolled twin given the same parameters restacked (launch counts
   zeroed before each scanned run and read after it): (v1) phase h's
   GPT-2-small LM with ``scan=True``: parameters after 3 eager steps bit
   for bit (or the first leaf that differs named, failing past the bf16
   tolerance), K3-K5 12 times and K9/K10 once a step in both, ms a step
   in interleaved pairs with the busy share, the count of parameter
   tensors and the device operations of one optimizer update; then
   ``scan=True, remat=True`` with ``dots_with_no_batch_dims_saveable`` at
   K=2 graphs against K=1 eager, bit for bit, ms a step and peak memory.
   (v2) Both served the first 8 of phase c's 16 greedy requests plus two
   repeats of a 256-token prompt (copy-on-write in the prefix cache),
   fused, bf16 and int8 KV: token-exact, tokens/s, K1/K2 once a layer
   and decode step on the vector read path at every block's pool slice;
   both again with ``spec_k=4`` and each its own draft: scanned
   token-exact against unrolled (in bf16 a verify's rows round apart
   from one-row decodes, so against plain only the agreement is printed).
   (v3) ResNet-50 ``scan_stages=True`` (bf16, SGD(0.1, momentum=0.9),
   batch 256, cuDNN deterministic): losses, parameters and BatchNorm
   buffers after 3 steps (the first difference named), K12/K13/K14
   72/53/53 a step, ms a step. (v4) K9/K10 at (128, 1000) bf16 against
   their plain versions, then ``vit_base(scan=True)`` (bf16 layers,
   ``fused_adamw(1e-3)``, the pallas loss, 128 uint8 images): parameters
   after 2 steps, K9/K10/K11 once a step, images/s, MFU (3 x
   ``vit_fwd_flops`` at 989 TFLOP/s), peak memory. (v5) Dropout(0.1)
   after each of 2 scanned GPT-2-small-width blocks: the mask drawn on
   the card equals the CPU's, and K=4 graphs equal K=1 eager bit for bit
   after 8 steps.
w. The sharded data-parallel strategies over an NCCL group of world 1
   (launch counts zeroed before each run and read after it). (w1) Phase
   l's GPT-2-small (bf16 layers, ``fused_adamw(3e-4, weight_decay=0.01)``,
   the pallas loss, batch 32 x 1024) under ``DataParallel``,
   ``ZeroDataParallel`` and ``FSDP`` from seed 0, 3 steps each:
   parameters and optimizer state bit for bit against DataParallel's,
   K3-K5 12 times and K9/K10/K11 once a step (K11 over the blocks of the
   shard path), the model-state bytes a card, ms a step in interleaved
   runs of 2 steps with the busy share. (w2) ``scan=True`` under FSDP
   with ``scan_overlap="require"`` against ``"off"``: bit for bit after
   3 steps, the overlap report active over 12 layers (1/12 exposed), ms
   a step in interleaved runs. (w3) Phase u2's LM (no ``dtype=`` on the
   layers, ``fused_adam(1e-4)``, batch 8 x 1024) under FSDP, one step
   under ``mixed_bfloat16`` and one in f32: the gathers move bf16 and f32
   respectively, and ``gathered_param_bytes_per_device`` halves.
   (w4) ``ShardedCheckpointer`` on w1's FSDP LM at batch 8 x 1024: a
   save after 2 steps, sync and async (blocking ms, MB on disk, the
   restore's seconds); a fresh model restores it and runs steps 3-4 bit
   for bit as the uninterrupted run; a DataParallel model restores the
   async directory bit for bit.
x. Tensor and sequence parallelism over the same NCCL group of world 1.
   (x1) Phase l's GPT-2-small (bf16 layers, ``fused_adamw``, the pallas
   loss, batch 32 x 1024) under ``DataParallel``,
   ``DataTensorParallel(model_parallel=1)`` and ``DataSeqParallel(
   seq_parallel=1)`` with ring and with Ulysses attention, from seed 0,
   3 steps each: parameters and optimizer state bit for bit against
   DataParallel's, K3-K5 12 times and K9/K10/K11 once a step, ms a step
   in interleaved runs of 2 steps with the busy share. (x2)
   ``ops.ring_attention`` (B 2, T 4,096, H 12, D 64, f32, causal and not)
   and its q, k, v gradients against the plain dense attention over the
   world-1 group, with both forwards' ms, and the Ulysses exchange's
   round trip bit for bit.
y. Pipeline and expert parallelism over the same NCCL group of world 1.
   (y1) The MoE LM at GPT-2-small widths (``moe_experts=8, moe_every=2``:
   6 MoE blocks, top-2, capacity factor 1.25, groups of 1,024; bf16
   layers, ``fused_adamw``, the pallas loss, batch 8 x 1024, seed 0) under
   ``DataParallel`` and ``DataExpertParallel(expert_parallel=1)``, 3
   steps each: parameters and optimizer state bit for bit, the loss, the
   aux loss and the share of dropped choices, K3-K5 12 times and
   K9/K10/K11 once a step, the f/g calls over the one-rank expert line
   (12 ``copy_to_group``, 6 ``reduce_from_group`` a step under EP, none
   under DP), ms a step in interleaved runs with the busy share, and the
   device ms of the 6 MoE layers (one timed alone, forward and backward)
   against the attention kernels' in a traced step. Then ``generate`` 8
   prompts and serve them with 8 more through the Engine and K1 (the
   token agreement printed: bf16 near-ties); a 2-layer f32 twin at
   capacity factor 4 (no drop in the Engine's prefill) served
   token-exact to ``generate``. (y2) GPT-2-small with ``pipeline=True``
   under ``DataPipelineParallel(pipeline_parallel=1)`` (the sequential
   scan, as JAX at pipe 1) at batch 32 x 1024: bit for bit its
   ``scan=True`` twin under ``DataParallel`` after 3 steps, the launches,
   ms a step; the Engine serves it off the pipe mesh through K1 with the
   twin's tokens. (y3) ``CompositeParallel({"data": 1})`` bit for bit
   ``DataParallel`` on phase l's LM. One card cannot run the live
   schedule or split the experts: ``scripts/torch_dp_scaling.py`` does,
   on 4 cards.
z. The auto-shard planner and the gang launcher's restart and liveness.
   (z1) Phase l's GPT-2-small (bf16 layers, ``fused_adamw``, the pallas
   loss, batch 32 x 1024) compiled with ``strategy="auto"``: each
   candidate's label and estimated seconds a step, the pruned ones, the
   choice and its tie-break; 3 steps (counts zeroed just before, read
   just after), bit for bit the same configuration set by hand
   (strategy, precision, ``steps_per_execution``, ``fit(grad_accum=)``);
   the state a card holds against the plan's bytes less the optimizer
   scalars the port keeps on the host (named). Then ``measure=True,
   top_k=3``: each shortlisted candidate's measured seconds a step beside
   its estimate, and the committed one the fastest measured; an
   ``hbm_cap_bytes`` below the card's state raises ``ValueError`` naming
   the pruned labels. (z2) ``scripts/torch_restart.py`` on this card:
   the 2-block LM at GPT-2-small width (batch 8 x 1024) under
   ``run_with_restart``, its one worker dying with ``os._exit`` at step
   5, resumed by ``ModelCheckpoint(restore=True)`` bit for bit the
   uninterrupted run, with the restore's seconds and the seconds from
   the relaunch to the first step; then a worker that stops itself
   (SIGSTOP) after its first beats, killed by ``liveness_timeout``, with
   the seconds from the stop to the kill. (z3)
   ``scripts/torch_restart.py --supervise`` on this card (its three
   cases at once, one script each): the same LM under ``python -m
   distributed_tpu_torch.launch --supervise`` with
   ``ModelCheckpoint(sharded=True, restore=True, save_freq=3, buddy=)``
   (the asynchronous refresh: a snapshot on the card, the copy to the
   host on the writer thread), a ``PreemptionHandler`` and
   ``FaultInjector.from_env()``, the buddy store a ``ram_dir`` under ``/dev/shm`` (its free space and the bytes
   the store holds printed): a kill at step 5 resumed from the buddy
   tier at step 5 with 0 disk block reads, a SIGTERM that exits 75 and
   restarts without spending budget, a corrupt checkpoint (buddy tier
   off) that falls back to the previous disk step, each bit for bit the
   uninterrupted run (z2's); the ``recovery`` rows (detect, gang re-form,
   restore, first step) and the postmortem of the kill's event log
   (``python -m distributed_tpu_torch.obs.cli``, the flight dump's tail);
   the kill's resumed worker's launches of K3-K5 and K9-K11. z2 and z3,
   then z8, z9, z10a and z10b (each in a process of its own,
   ``child_phase``), run one after another on a thread from phase r on,
   beside phases r-y, since they spend much of their time starting
   processes; each prints its lines at its place, and each process group
   they start is killed if the run stops first. (z4) The
   serving fleet: phase c's GPT-2-small (bf16 layers, seed 0) behind
   ``EnginePrograms(model, decode_kernel="fused")`` shared by a
   ``ServingFleet`` of 2 decode replicas (8 slots, block 16, max_len
   1,024) and 1 prefill replica with ``transfer="blocks"``, serving
   phase c's 16 greedy requests in bursts of 4, 0.05 fleet-seconds
   apart: tokens/s and TTFT on the fleet's virtual clock, handoffs
   installed and fallen back, payload bytes, K1's launches (counted from
   zero, one per layer and decode step), every first token equal to
   phase c's and the agreement share; one 512-token prompt's handoff
   packed and installed into another pool (bytes, ms) and, bf16, bit for
   bit (z4c); a spawned replica killed and another retired, with
   ``torch.cuda.memory_allocated`` back by a pool's bytes. (z4b) At phase
   d's 2 layers in f32, each fleet token-exact against the fused Engine:
   with transfer, with ``transfer="none"``, with ``decode-1`` killed by
   ``FaultInjector(mode="replica_kill")``, gossiping on requests that
   share a 64-token prefix (adoptions > 0), and after ``update_weights``
   with moved weights against a fresh Engine on them. (z5) The serving
   service: ``ServeService`` of a GPT-2-small-width LM in f32
   (``ServeSpec(device=None)``: its workers build on this card) with 2
   decode and 1 prefill worker processes and ``transport="shm"`` on 8
   greedy requests: each worker's spawn-to-hello seconds, tokens/s and
   TTFT on the wall clock, the payloads' bytes and ``/dev/shm``'s peak,
   the streamed tokens equal to an in-process fleet built from the same
   spec; then ``decode-1`` killed mid-run (``kill_replica``), recovered
   token-exact, its flight dump's tail printed, and every worker exiting
   0 at ``stop()``. (z6) Online post-training: ``rl.PostTrainer`` on
   phase c's GPT-2-small (bf16 layers, seed 0) over
   ``Engine(max_slots=16, block_size=16, max_len=1024, temperature=1.0,
   decode_kernel="fused")`` with ``kl_coef=AdaptiveKLCoef()`` and
   ``optimizer=fused_adam(1e-5)``: 8 prompts of 32-64 tokens x 4 samples
   x 64 new tokens, 2 iterations at the default ``train_len`` (1,024, so
   ``fit`` takes the flash kernels); each iteration's row (reward, loss,
   measured KL, kl_coef, rollout tokens/s, train s, weight-sync ms,
   version); its 32 rollouts against a fresh Engine of the reference
   read path on the same snapshot and seeds (each must be token-exact,
   or part at a bf16 rounding tie of the sampling score, which one f32
   forward of the common prefix checks for every rollout that parts);
   ``weights_version`` rising by one; the KL finite; the launches of K1,
   K3-K5 and K11 (counted around the iterations only) and peak memory.
   Then ``bench.py:bench_rl``'s own configuration (``lm_l4_d256``, f32,
   4 iterations), whose reward must rise every iteration. (z7)
   ``rl.DraftDistiller`` on phase s's target and its 6-layer truncated
   draft in a greedy speculative Engine (spec_k 4, fused): the accept
   rate on phase c's 16 prompts before and after ``fit(rounds=2,
   epochs=8)``, each round's loss falling, the draft's staleness back to
   0; then phase d's f32 2-layer model with a 1-layer draft distilled the
   same way, its speculative tokens equal to plain greedy decode's. (z8)
   The data tiers: a ``FileSource`` of 2,560 random 224x224x3 images
   (385 MB) under a temporary directory; ``Pipeline(dir)`` on the native
   C++ ring (``is_native``) against the Python path, 10 batches of 256
   bit for bit; ``scripts/torch_imagenet_resnet.py``'s model (RandomCrop
   + RandomFlip + bf16 ResNet-50, its SGD-cosine and top-5 metric) for
   10 steps at batch 256 from ``Pipeline(dir, prefetch=8,
   num_threads=4)``: images/s, ``input_stall_fraction``, K12-K14's
   launches, the augmentation's device ms against the step; then
   ``mnist_cnn`` from 8,192 zlib-compressed records at
   ``decode_workers`` 0 and 4: steps/s and the stall share, the two
   streams bit-identical. (z9) The port's linter (``dtt-lint``, every
   rule) over ``distributed_tpu_torch/``, which must find nothing; then
   the port's R binding: ``r/distributedtputorch/examples/local.R`` on the
   simulated R runtime of ``tests/torch_r_sim.py`` with device = NULL,
   so ``mnist_cnn`` trains its 15 steps on this card, its losses held to
   the same script on the CPU (relative 1e-4), with the card's busy time
   and the launches of the port's kernels it reached; then
   ``utils.profiler``'s hooks (allocator stats, ``trace()`` around an
   ``annotate``d predict) in this process and in a fresh one, whose trace
   must hold the card's kernels.
z10. Configurations the port ran only on the CPU before. (z10a)
   Pythia-160M's widths (EleutherAI's ``pythia-160m``: 12 layers, d 768,
   12 heads, d_ff 3,072, vocab 50,304) with GPT-NeoX's parallel residual,
   ``Residual(main=Residual(MLP), shortcut=Sequential([LayerNorm,
   MultiHeadAttention]))``, so K1/K2 read the shortcut's pool (cut: a
   learned positional table of 1,024 rows in place of rotary; random
   weights from seed 0): in f32 the fused Engine token-exact against
   ``Model.generate`` on 8 requests of 128 + 128 tokens; in bf16 layers
   phase c's 16 requests with bf16 and int8 KV (tokens/s, TTFT, the pool's
   bytes and the shortcut's share); ``spec_k=4`` with its first 6 blocks
   as the draft, token-exact against the f32 run. (z10b) Phase v1's LM
   with ``fused_adam(1e-4)``, its scanned template wrapping each residual
   in ``Remat`` (the default policy, then ``dots_with_no_batch_dims_
   saveable``): one warm-up and 3 timed steps, losses and every parameter
   bit for bit against the unrolled ``remat=True`` LM from the same
   weights; ms a step and peak memory beside the scanned twin with one
   ``Remat`` around the whole block. (z10c) ResNet-50 (bf16) under
   ``DataParallel`` (NCCL, world 1) predicting 1,024 images at batch 256
   from ``Pipeline(shard="auto")``, bit for bit the predict of the same
   rows as a host array, K12 counted: a world-1 predict from a pipeline,
   which at one process reads whole (no shard), so ``predict``'s gather
   over the batch group does not run here; ``scripts/torch_dp_scaling.py
   --predict`` on 4 cards checks that. (z10d) Dropout's slice-only draws
   (``threefry.bernoulli_block``) at 8 x 1024 x 768 for every rank of 2
   and of 4: TP's column block and the ring's and Ulysses' token chunk
   through ``nn.Dropout``, the zigzag schedule's two chunks through the
   draw itself, each bit for bit its slice of the full-shape mask.
z11. The strategy compositions (NCCL, world 1): phase y1's MoE LM
   (GPT-2-small widths, 8 experts every second block, bf16 layers,
   ``fused_adamw``, the pallas loss, batch 8 x 1024, seed 0; cut to 4
   blocks, ``Z11_LAYERS``) under
   ``DataParallel``, ``DataSeqParallel(seq_parallel=1)`` with ring and
   with Ulysses, and ``CompositeParallel``'s pairs seq x model, fsdp x
   seq, expert x model, expert x seq, expert x fsdp and expert x pipe at
   sizes 1: 3 steps each, parameters, optimizer state and aux losses bit
   for bit against ``DataParallel``'s, with the losses, the aux loss, the
   dropped share and the launches a step (K3-K5 4, K9/K10 1, K11 one a
   64 leaves). Then a ``Pipeline(shard="auto")`` built in a
   ``DataTensorParallel(model_parallel=1)`` scope feeds 3 steps of phase
   l's LM at the same depth (uint8 tokens
   below 256, each position labelled with its row's label), bit for bit
   the same steps from host arrays; at world 1 the row line is the whole
   group, so "auto" reads whole (the 4-card runs of
   ``scripts/torch_dp_scaling.py --shard-auto`` shard it).
z12. The Engine under tensor parallelism (NCCL, world 1): phase c's
   GPT-2-small (bf16 layers, random weights from seed 0) built under
   ``DataTensorParallel(model_parallel=1)`` and under ``DataParallel``,
   served by ``Engine(8 slots, block 16, max_len 1024, "fused")`` on phase
   c's 16 requests with bf16 and int8 KV pools, then after
   ``quant.quantize_model``: tokens and logprobs bit for bit DP's; every
   hinted leaf served is a marked block of its one-rank line (nothing
   gathered); the paged paths call Megatron's ``copy_to_group`` and
   ``reduce_from_group`` 2 times a block and dispatch each; K1 (K2 with
   int8 KV) once a layer and decode step. Tokens/s, TTFT p50/p99, the
   served parameter and pool bytes. (``scripts/torch_tp_serve.py`` runs
   model_parallel 2 and 4 on 4 cards.)
Then each phase's seconds from its header to the next (``phase
seconds``; every header also prints the seconds since the run began),
the kernel table as one JSON line (each row also names the CUDA
kernel of the main path, ``kernel``, and carries its launches in phase r's
resumed steps, ``launches_resumed``, in phase t's fits that captured a
graph, ``launches_fit``, and its runs in their 8 replayed steps from the
trace, ``replayed_fit``; K1/K2 also their launches in phase
s's speculative runs, ``launches_spec``, and their time by kw, ``ms_by_kw``;
and its launches in phase u's sub-phases, ``launches_u1``-``launches_u3``,
in phase v's scanned runs, ``launches_v``, in phase w's sharded runs,
``launches_w``, in phase x1's tensor- and sequence-parallel runs,
``launches_x``, in phase y's MoE, pipelined and composite runs,
``launches_y``, in phase z1's auto-compiled run, ``launches_z``, in
phase z3's resumed worker, ``launches_z3``, K1 in phase z4's
full-width fleet, ``launches_z4``, and in phases z6-z12,
``launches_z6``-``launches_z12``, where any),
the card's name and power limit, and ``{"ok": true, "device": {...}}`` as
the last line.
"""

import concurrent.futures
import contextlib
import json
import math
import os
import re
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

# H100 SXM, NVIDIA's data sheet: HBM bandwidth and dense peak rates.
HBM_BYTES_PER_S = 3.35e12
ROOT = os.path.dirname(os.path.abspath(__file__))
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
# Phase t1(a): GPT-2-small's update after fit(grad_accum=4) against the
# whole batch's, relative L2 over all parameters: 0.017 and 0.015 after
# steps 1 and 2 on an H100. A skipped or doubled update reads 1 after the
# first step (0.5 after the second).
ACCUM_UPDATE_REL = 0.05
# Flash attention, (atol, rtol) per entry. bf16: rtol 2e-2 is 2.5 ulps at
# worst (the two sides may round one output a last bit apart); atol 2e-3
# covers entries near zero, where the bf16 probabilities' rounding at
# other running maxima (forward) adds up in absolute terms.
# f16: the bf16 limits scaled by the ratio of the two types' ulps (2^-10 /
# 2^-7) and doubled.
FLASH_TOL = {"float32": (2e-5, 2e-5), "bfloat16": (2e-3, 2e-2),
             "float16": (5e-4, 5e-3)}
# O's relative L2 error: bf16 reads 1.29e-3 to 1.32e-3 at D 8-256 and f16
# 1.6e-4 (PERF.md); a kernel that left a kv tile out of P V would read
# several percent.
O_REL_L2 = {"float32": 1e-6, "bfloat16": 3e-3, "float16": 4e-4}
# One ulp of a 16-bit probability in [1/2, 1), relative: 2^-8 in bf16,
# 2^-11 in f16 (each side rounds p to v's dtype, at its own row maximum).
PROB_ULP = {"bfloat16": 2.0 ** -8, "float16": 2.0 ** -11}
# The flash kernels replace the lane-packed variants too (flash_attention.py
# :384, :448, :490): one strided kernel family reads both layouts.
REPLACES = {
    "paged_attention": "distributed_tpu/ops/paged_attention.py:93",
    "paged_attention_int8": "distributed_tpu/ops/paged_attention.py:151",
    "xent_fwd": "distributed_tpu/ops/pallas_kernels.py:35",
    "xent_bwd": "distributed_tpu/ops/pallas_kernels.py:46",
    "flash_fwd": "distributed_tpu/ops/flash_attention.py:83",
    "flash_dq": "distributed_tpu/ops/flash_attention.py:199",
    "flash_dkv": "distributed_tpu/ops/flash_attention.py:238",
    "fused_adam": "distributed_tpu/ops/fused_update.py:82",
    "conv1x1": "examples/pallas_conv1x1.py:33",
    "bn_stats": "examples/bn_pallas.py:80",
    "bn_bwd_reduce": "examples/bn_pallas.py:119",
    "launch_probe": "examples/profile_op_floor.py:92",
}
KERNELS = {  # the CUDA kernel each row's main path launches
    "paged_attention": "paged_decode_kernel<T, false, kVec, kCpl, kKw>",
    "paged_attention_int8": "paged_decode_kernel<T, true, kVec, kCpl, kKw>",
    "xent_fwd": "xent_fwd_kernel", "xent_bwd": "xent_bwd_kernel",
    "flash_fwd": "flash_fwd_wgmma_kernel<bf16, 64>",
    "flash_dq": "flash_dq_wgmma_kernel<bf16, 64>",
    "flash_dkv": "flash_dkv_wgmma_kernel<bf16, 64>",
    "fused_adam": "fused_adam_kernel", "conv1x1": "conv1x1_wgmma_kernel<bf16>",
    "bn_stats": "bn_reduce_kernel<bf16, 8, false>",
    "bn_bwd_reduce": "bn_reduce_kernel<bf16, 8, true>",
    "launch_probe": "launch_probe_kernel",
}
# Each counted kernel's name in the profiler's trace (demangled), for the
# kernels a CUDA graph's replay runs without their wrappers (phase t).
TRACE_NAMES = {
    "xent_fwd": r"\bxent_fwd_kernel\b", "xent_bwd": r"\bxent_bwd_kernel\b",
    "flash_fwd": r"\bflash_fwd_wgmma_kernel\b",
    "flash_dq": r"\bflash_dq_wgmma_kernel\b",
    "flash_dkv": r"\bflash_dkv_wgmma_kernel\b",
    "fused_adam": r"\bfused_adam_kernel\b",
    "conv1x1": r"\bconv1x1_wgmma_kernel\b",
    "bn_stats": r"\bbn_reduce_kernel<[^>]*\bfalse>",
    "bn_bwd_reduce": r"\bbn_reduce_kernel<[^>]*\btrue>",
}
SOURCES = {
    "paged_attention": "paged_attention", "paged_attention_int8":
    "paged_attention", "xent_fwd": "xent", "xent_bwd": "xent",
    "flash_fwd": "flash_attention", "flash_dq": "flash_attention",
    "flash_dkv": "flash_attention", "fused_adam": "fused_adam",
    "conv1x1": "conv1x1", "bn_stats": "bn_reduce", "bn_bwd_reduce":
    "bn_reduce", "launch_probe": "launch_probe",
}

LM = dict(num_layers=12, d_model=768, num_heads=12, max_len=1024)
VOCAB = 32768


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, iters):
    """Mean device ms per call over ``iters`` calls of ``fn(i)``, after
    warm-up, between CUDA events. The card first spins for ~50 ms so the
    host can queue every call before the first starts: the events then
    time the calls back to back, not the host's launch overhead."""
    for i in range(3):
        fn(i)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)
    start.record()
    for i in range(iters):
        fn(i)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ------------------------------------------------------------------ phase a
def sass_opcode_counts(lib_path, opcode):
    """{kernel: count of ``opcode`` in its SASS} by ``cuobjdump -sass``, or
    None where the toolkit has no cuobjdump."""
    exe = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if not os.path.exists(exe):
        return None
    sass = subprocess.run([exe, "-sass", str(lib_path)], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[-1].strip()
            counts[fn] = 0
        elif fn and opcode in line:
            counts[fn] += 1
    return counts


def wgmma_report(fa, conv_ops, built):
    """The Hopper kernels (wgmma): registers and spills as ptxas reported
    them (``built``: a fresh build's output per source), the dynamic
    shared memory a block asks for, and the HGMMA instructions in their
    SASS; exits if a kernel has none."""
    for source in ("flash_attention", "conv1x1"):
        lib_path, log = built[source]
        entries, cur = {}, None
        for line in log.splitlines():
            if "Compiling entry function" in line:
                cur = line.split("'")[1]
                entries[cur] = []
            elif cur and ("registers" in line or "spill" in line):
                entries[cur].append(line.split("ptxas info    :")[-1].strip())
        hgmma = sass_opcode_counts(lib_path, "HGMMA")
        for mangled in sorted(m for m in set(entries) | set(hgmma or {})
                              if "wgmma_kernel" in m):
            hit = re.search(r"(flash_(fwd|dq|dkv)_wgmma_kernel)I(13__nv_bfloat16"
                            r"|6__half)Li(\d+)E", mangled)
            if hit:
                kind = "bf16" if "bfloat16" in hit.group(3) else "f16"
                width = int(hit.group(4))
                name = f"{hit.group(1)}<{kind}, {width}>"
                smem = fa.wgmma_smem_bytes(f"flash_{hit.group(2)}", width)
            elif "conv1x1_wgmma_kernel" in mangled:
                kind = "bf16" if "bfloat16" in mangled else "f16"
                name = f"conv1x1_wgmma_kernel<{kind}>"
                smem = conv_ops.wgmma_smem_bytes()
            else:
                continue
            n = "no cuobjdump" if hgmma is None else hgmma.get(mangled, 0)
            print(f"  {name}: {'; '.join(entries.get(mangled, []))}; {smem} B "
                  f"dynamic shared memory; HGMMA in SASS: {n}")
            if hgmma is not None and not hgmma.get(mangled):
                raise SystemExit(f"{name}: no HGMMA in its SASS")


# ------------------------------------------------------------------ phase b
def kernel_inputs(torch, dev, dtype, kw, int8, seed, hd=64, full=False):
    """Serving-shaped inputs: 8 slots, 6 with disjoint tables at mixed
    positions (0 included), 2 on the all-trash table at position 0, as
    the engine's free slots are. ``full``: a full server at ``max_len``
    instead, every slot on its own table at the last position."""
    s, h, bs, nb = 8, 12, 16, 64
    g = torch.Generator(device=dev).manual_seed(seed)
    nblocks = s * nb + 1
    kp = torch.randn((nblocks, bs, h, hd), generator=g, device=dev)
    vp = torch.randn((nblocks, bs, h, hd), generator=g, device=dev)
    q = torch.randn((s, kw, h, hd), generator=g, device=dev).to(dtype)
    tables = (1 + torch.arange(s * nb, device=dev).reshape(s, nb)).int()
    if full:
        positions = torch.full((s,), nb * bs - kw, dtype=torch.int32,
                               device=dev)
    else:
        tables[6:] = 0
        positions = torch.tensor([0, 17, 255, 511, 700, 1024 - kw, 0, 0],
                                 dtype=torch.int32, device=dev)
    if int8:
        def quant(pool):
            amax = pool.abs().amax(dim=-1, keepdim=True)
            scale = torch.where(amax > 0, amax / 127.0, 1.0)
            qv = torch.clamp(torch.round(pool / scale), -127, 127)
            return {"q": qv.to(torch.int8), "scale": scale}
        kp, vp = quant(kp), quant(vp)
    else:
        kp, vp = kp.to(dtype), vp.to(dtype)
    return q, kp, vp, tables, positions


def bound(q, kp, tables, positions):
    """(bound_ms, bound_by, bytes, flops): the least time for this call's
    work on the card — bytes it must move (q read, out written, the
    visible K/V rows and their scales, the table entries they need) over
    HBM bandwidth, against its flops over the peak rate of q's dtype."""
    s, kw, h, hd = q.shape
    int8 = isinstance(kp, dict)
    pool = kp["q"] if int8 else kp
    bs, nb = pool.shape[1], tables.shape[1]
    vis = [min(int(p) + kw, nb * bs) for p in positions.tolist()]
    row_bytes = h * hd * pool.element_size() + (h * 4 if int8 else 0)
    nbytes = (2 * q.numel() * q.element_size() + 2 * sum(vis) * row_bytes
              + 4 * sum(-(-v // bs) for v in vis) + 4 * s)
    flops = sum(4 * h * hd * min(int(p) + r + 1, nb * bs)
                for p in positions.tolist() for r in range(kw))
    dtype = str(q.dtype).split(".")[-1]
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations", nbytes, flops)


def time_paged(torch, paged_ops, name, dtype, int8, full, kw=1):
    """Per-launch device time of the kernel at ``kw`` query rows a slot,
    rotating 4 copies of the pools past the 50 MB L2, beside the plain
    version's and the bound; prints the share of the bound. Returns (ms,
    plain_ms, bound_ms, bound_by)."""
    dev = torch.device("cuda")
    copies = [kernel_inputs(torch, dev, dtype, kw, int8, seed=100 + c,
                            full=full) for c in range(4)]
    ms = cuda_ms(torch, lambda j: paged_ops.paged_attention(
        *copies[j % 4]), 200)
    plain_ms = cuda_ms(torch, lambda j: paged_ops.paged_attention_ref(
        *copies[j % 4]), 20)
    b_ms, b_by, nbytes, flops = bound(*copies[0][:2], *copies[0][3:])
    shape = "8 slots at 1023" if full else "mixed positions"
    shape += f", kw {kw}" if kw > 1 else ""
    print(f"  {name:22s} {shape}: {ms * 1e3:.1f} us/launch, plain "
          f"{plain_ms * 1e3:.1f} us, bound {b_ms * 1e3:.2f} us "
          f"({b_by}: {nbytes / 1e6:.2f} MB at "
          f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s, {flops / 1e6:.1f} "
          f"MFLOP), {b_ms / ms:.1%} of bound")
    return ms, plain_ms, b_ms, b_by


def phase_kernels(torch, paged_ops):
    dev = torch.device("cuda")
    cases = [  # (name, q dtype, kw, int8, full server)
        ("paged_attention", torch.float32, 1, False, False),
        ("paged_attention", torch.float32, 4, False, False),
        ("paged_attention", torch.bfloat16, 1, False, False),
        ("paged_attention", torch.bfloat16, 4, False, False),
        ("paged_attention_int8", torch.bfloat16, 1, True, False),
        ("paged_attention_int8", torch.bfloat16, 4, True, False),
        ("paged_attention_int8", torch.float32, 1, True, False),
        ("paged_attention", torch.bfloat16, 8, False, False),
        ("paged_attention", torch.bfloat16, 12, False, False),
        ("paged_attention_int8", torch.bfloat16, 8, True, False),
        ("paged_attention_int8", torch.bfloat16, 12, True, False),
        ("paged_attention", torch.bfloat16, 1, False, True),
        ("paged_attention", torch.float32, 1, False, True),
        ("paged_attention_int8", torch.bfloat16, 1, True, True),
    ]
    rows = {}
    for i, (name, dtype, kw, int8, full) in enumerate(cases):
        args = kernel_inputs(torch, dev, dtype, kw, int8, seed=i, full=full)
        got = paged_ops.paged_attention(*args)
        want = paged_ops.paged_attention_ref(*args)
        torch.cuda.synchronize()
        dname = str(dtype).split(".")[-1]
        err = (got.float() - want.float()).abs().max().item()
        tol = TOL[dname]
        ok = bool(torch.allclose(got.float(), want.float(), atol=tol,
                                 rtol=tol))
        shape = "8 slots at 1023" if full else "mixed"
        print(f"  {name:22s} q={dname:8s} kw={kw} {shape:15s} max_abs_err="
              f"{err:.3e} tol={tol:g} (atol=rtol) {'ok' if ok else 'MISMATCH'}")
        if not ok:
            raise SystemExit(f"{name}: kernel disagrees with its plain "
                             f"version (q {dname}, kw {kw}, {shape})")
        row = rows.setdefault(name, {"max_abs_err": 0.0, "ms_by_kw": {}})
        row["max_abs_err"] = max(row["max_abs_err"], err)
        if dtype == torch.bfloat16 and (kw == 1 or (kw in (4, 12) and not full)):
            # The main path's shapes (bf16 layers): decode at the engine's
            # mixed positions (the row's time) and a full server; a
            # speculative verify's kw 4 and 12 at the mixed positions.
            ms, plain_ms, b_ms, b_by = time_paged(torch, paged_ops, name,
                                                  dtype, int8, full, kw)
            if not full:
                row["ms_by_kw"][kw] = ms
            if kw == 1 and not full:
                row.update(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                           bound_by=b_by)
    # Every head width class, read in place: 16-byte chunks where a pool
    # row is whole chunks (bf16/f16 24 and 256), element by element
    # otherwise (int8 8 and 24); 256 runs the 256-thread blocks.
    tol = {torch.float32: 2e-5, torch.bfloat16: 2e-2, torch.float16: 5e-3}
    for hd in (8, 24, 256):
        for dtype, kw, int8 in ((torch.bfloat16, 1, False),
                                (torch.float16, 4, False),
                                (torch.bfloat16, 1, True),
                                (torch.float16, 1, True)):
            args = kernel_inputs(torch, dev, dtype, kw, int8, hd, hd=hd)
            got = paged_ops.paged_attention(*args)
            want = paged_ops.paged_attention_ref(*args)
            torch.cuda.synchronize()
            err = max_err(got, want)
            ok = bool(torch.allclose(got.float(), want.float(), atol=tol[dtype],
                                     rtol=tol[dtype]))
            name = "paged_attention_int8" if int8 else "paged_attention"
            dname = str(dtype).split(".")[-1]
            print(f"  {name:22s} hd={hd:<3d} q={dname:8s} kw={kw} max_abs_err="
                  f"{err:.3e} tol={tol[dtype]:g} {'ok' if ok else 'MISMATCH'}")
            if not ok:
                raise SystemExit(f"{name}: kernel disagrees with its plain "
                                 f"version (hd {hd}, q {dname}, kw {kw})")
            rows[name]["max_abs_err"] = max(rows[name]["max_abs_err"], err)
    return rows


# ---------------------------------------------------------------- phase c-e
def requests(n, p_range, m_range, seed=0):
    rng = np.random.default_rng(seed)
    plen = rng.integers(p_range[0], p_range[1] + 1, n)
    news = rng.integers(m_range[0], m_range[1] + 1, n)
    return [(rng.integers(0, VOCAB, (int(p),)).astype(np.int32), int(m))
            for p, m in zip(plen, news)]


def serve(dtt, model, reqs, **kw):
    engine = dtt.serving.Engine(model, max_slots=8, block_size=16,
                                max_len=LM["max_len"], **kw)
    t = time.perf_counter()
    outs = engine.run([dtt.serving.Request(p, m) for p, m in reqs])
    wall = time.perf_counter() - t
    tel = engine.last_run_telemetry
    del engine
    return outs, tel, wall


def check_outputs(outs, reqs, vocab):
    for o, (p, m) in zip(outs, reqs):
        if o.shape != (p.size + m,) or not np.array_equal(o[:p.size], p):
            raise SystemExit(f"bad output shape {o.shape} for prompt "
                             f"{p.size} + {m}")
        if o.min() < 0 or o.max() >= vocab:
            raise SystemExit("generated token outside the vocabulary")


def agreement(a, b, reqs):
    """Share of generated positions where two runs chose the same token,
    and whether every first generated token (from prefill) matched."""
    same = total = 0
    first = True
    for x, y, (p, m) in zip(a, b, reqs):
        gx, gy = x[p.size:], y[p.size:]
        same += int(np.sum(gx == gy))
        total += m
        first &= bool(gx[0] == gy[0])
    return same / total, first


def report(tag, tel, wall):
    ttft = tel["time_to_first_token"]
    print(f"  {tag}: {tel['generated_tokens']} tokens in {wall:.3f} s, "
          f"{tel['tokens_per_sec']:.1f} tokens/s, TTFT p50 "
          f"{ttft['p50'] * 1e3:.1f} ms p99 {ttft['p99'] * 1e3:.1f} ms, "
          f"decode steps {tel['decode_steps']}, preemptions "
          f"{tel['preemptions']}, kv util mean "
          f"{tel['kv_utilization']['mean']:.3f}")


# ------------------------------------------------------------ phase f, g
def cuda_ms_flushed(torch, fn, iters, ahead=False, clean=False):
    """Mean device ms of ``fn(i)`` over ``iters`` launches, each timed
    between its own CUDA events right after a 128 MB write that evicts the
    50 MB L2, so every launch reads its inputs from HBM. ``ahead``: the
    card first spins ~50 ms so the host queues every call before the
    first starts, and the events time the device, not the host's
    preparation of a call that launches many kernels. ``clean``: evict by
    a 128 MB read instead, so the L2 holds clean lines and the timed call
    does not also pay for writing the flush's dirty lines back."""
    flush = torch.empty(32 << 20, dtype=torch.float32, device="cuda")
    if clean:
        flush.zero_()
    fn(0)
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    if ahead:
        torch.cuda._sleep(100_000_000)
    for i, (a, b) in enumerate(ev):
        if clean:
            flush.sum()
        else:
            flush.zero_()
        a.record()
        fn(i)
        b.record()
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in ev) / iters


def bound_ms(nbytes, flops, dtype):
    """(bound_ms, bound_by): the larger of bytes over HBM bandwidth and
    operations over the peak rate of ``dtype``."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def max_err(got, want):
    return (got.float() - want.float()).abs().max().item()


def phase_xent(torch, xent):
    import torch.nn.functional as F

    dev = torch.device("cuda")
    rows = {}
    g = torch.Generator(device=dev).manual_seed(11)

    def inputs(n):
        logits = (2 * torch.randn((n, VOCAB), generator=g, device=dev)).to(
            torch.bfloat16)
        labels = torch.randint(0, VOCAB, (n,), generator=g, device=dev)
        gout = torch.full((n,), 1.0 / n, device=dev)
        return logits, labels, gout

    # The LM head's rows at the main path's batch: 32 x 1024 tokens.
    n = 32 * LM["max_len"]
    logits, labels, gout = inputs(n)
    loss = xent.xent_fwd(logits, labels)
    want = xent.xent_fwd_ref(logits, labels)
    torch.cuda.synchronize()
    # f32 losses of about 12: sums of 32768 exponentials in another order.
    err = max_err(loss, want)
    print(f"  xent_fwd   N={n} C={VOCAB} bf16 max_abs_err={err:.3e} "
          f"(limit 1e-04) {'ok' if err <= 1e-4 else 'MISMATCH'}")
    rows["xent_fwd"] = {"max_abs_err": err}
    failed = err > 1e-4
    del loss, want
    dl = xent.xent_bwd(logits, labels, gout)
    want = xent.xent_bwd_ref(logits, labels, gout)
    torch.cuda.synchronize()
    # dlogits: one bf16 ulp of each reference entry. Both sides round one
    # f32 value once to bf16; a last-bit difference before the rounding
    # can move it by one ulp, and nothing more.
    diff = (dl.float() - want.float()).abs()
    ulp = torch.exp2(torch.floor(torch.log2(
        want.float().abs().clamp_min(1e-30))) - 7)
    worst = (diff / ulp).max().item()
    err = diff.max().item()
    print(f"  xent_bwd   N={n} C={VOCAB} bf16 max_abs_err={err:.3e}, worst "
          f"entry {worst:.2f} of its own bf16 ulp (limit 1) "
          f"{'ok' if worst <= 1 else 'MISMATCH'}")
    rows["xent_bwd"] = {"max_abs_err": err}
    failed |= worst > 1
    del dl, want, diff, ulp
    torch.cuda.empty_cache()
    if failed:
        raise SystemExit("xent: a kernel disagrees with its plain version")

    lf = logits.float().requires_grad_(True)
    lib_out = F.cross_entropy(lf, labels, reduction="none")
    logit_bytes = logits.numel() * logits.element_size()
    timings = {  # bytes: each input read once, each output written once
        "xent_fwd": dict(
            kernel=lambda i: xent.xent_fwd(logits, labels),
            plain=lambda i: xent.xent_fwd_ref(logits, labels),
            library=lambda i: F.cross_entropy(logits.float(), labels,
                                              reduction="none"),
            nbytes=logit_bytes + 8 * n + 4 * n, flops=3 * logits.numel()),
        "xent_bwd": dict(
            kernel=lambda i: xent.xent_bwd(logits, labels, gout),
            plain=lambda i: xent.xent_bwd_ref(logits, labels, gout),
            library=lambda i: torch.autograd.grad(lib_out, lf, gout,
                                                  retain_graph=True),
            nbytes=2 * logit_bytes + 8 * n + 4 * n,
            flops=5 * logits.numel()),
    }
    for name, t in timings.items():
        ms = cuda_ms_flushed(torch, t["kernel"], 20)
        plain_ms = cuda_ms_flushed(torch, t["plain"], 3)
        library_ms = cuda_ms_flushed(torch, t["library"], 5)
        b_ms, b_by = bound_ms(t["nbytes"], t["flops"], "float32")
        rows[name].update(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                          bound_ms=b_ms, bound_by=b_by)
        print(f"  {name:10s} N={n} C={VOCAB} bf16: {ms * 1e3:.1f} us/launch, "
              f"plain {plain_ms * 1e3:.1f} us, F.cross_entropy "
              f"{library_ms * 1e3:.1f} us, bound {b_ms * 1e3:.1f} us "
              f"({b_by}: {t['nbytes'] / 1e9:.3f} GB), {b_ms / ms:.1%} of bound")
    del logits, labels, gout, lf, lib_out
    torch.cuda.empty_cache()
    return rows


def flash_bounds(b, t, h, d, causal, elem):
    """{kernel: (bytes, flops)} of one call: each input read once, each
    output written once; products over the (i, j) pairs the mask keeps
    (2*D operations per pair and product: 2 in the forward, 3 for dQ, 4
    for dK/dV)."""
    pairs = b * h * (t * (t + 1) // 2 if causal else t * t)
    tensor = b * t * h * d * elem
    stats = b * h * t * 4
    return {
        "flash_fwd": (4 * tensor + 2 * stats, 4 * d * pairs),
        "flash_dq": (5 * tensor + 3 * stats, 6 * d * pairs),
        "flash_dkv": (6 * tensor + 3 * stats, 8 * d * pairs),
    }


def check_flash(torch, fa, q, k, v, do, causal, rows, prob_bound=False):
    """Forward, dQ and dK/dV against the plain versions on the same inputs:
    every entry of O, dQ, dK, dV within ``FLASH_TOL``, O's relative L2
    error within ``O_REL_L2`` and ``m`` within 1e-5 (+ 1e-5 relative).
    ``prob_bound``: O's entries may also differ by one 16-bit ulp of each
    probability times |v|, ``PROB_ULP * (P @ |V|)``, the most that rounding
    the probabilities at other running maxima can move them (over a long
    row of grid values it moves an output near 0 past ``FLASH_TOL``).
    Updates each kernel's ``max_abs_err`` in ``rows``; exits if any
    disagrees."""
    b, t, h, d = q.shape
    dname = str(q.dtype).split(".")[-1]
    o, m, l = fa.flash_fwd(q, k, v, causal)
    delta = fa.flash_delta(do, o)
    dq, dk, dv = fa.flash_bwd(q, k, v, do, m, l, delta, causal)
    o_ref, m_ref, _ = fa.flash_fwd_ref(q, k, v, causal)
    refs = fa.flash_bwd_ref(q, k, v, do, m, l, delta, causal)
    torch.cuda.synchronize()
    failed = []
    m_err = max_err(m, m_ref)
    m_worst = ((m - m_ref).abs() / (1e-5 + 1e-5 * m_ref.abs())).max().item()
    print(f"  flash m  B={b} T={t} H={h} D={d} {dname:8s} max_abs_err={m_err:.3e}"
          f", worst {m_worst:.3f} of 1e-5 + 1e-5 * |ref| (limit 1) "
          f"{'ok' if m_worst <= 1 else 'MISMATCH'}")
    if m_worst > 1:
        failed.append("m")
    for name, got, want in (("o", o, o_ref), ("dq", dq, refs[0]),
                            ("dk", dk, refs[1]), ("dv", dv, refs[2])):
        atol, rtol = FLASH_TOL[dname]
        got, want = got.float(), want.float()
        diff = (got - want).abs()
        err = diff.max().item()
        # Elementwise: every entry within atol + rtol * |its reference|.
        limit = atol + rtol * want.abs()
        if name == "o" and prob_bound:
            limit += PROB_ULP[dname] * fa.flash_fwd_ref(
                q.float(), k.float(), v.float().abs(), causal)[0]
        worst = (diff / limit).max().item()
        rel_l2 = (torch.linalg.vector_norm(got - want)
                  / torch.linalg.vector_norm(want)).item()
        ok = worst <= 1 and (name != "o" or rel_l2 <= O_REL_L2[dname])
        print(f"  flash {name:2s} B={b} T={t} H={h} D={d} causal {dname:8s} "
              f"max_abs_err={err:.3e}, worst entry {worst:.3f} of atol "
              f"{atol:g} + rtol {rtol:g} * |ref|"
              f"{' + ulp * (P @ |V|)' if name == 'o' and prob_bound else ''} "
              f"(limit 1), relative L2 {rel_l2:.2e}"
              f"{f' (limit {O_REL_L2[dname]:g})' if name == 'o' else ''} "
              f"{'ok' if ok else 'MISMATCH'}")
        if not ok:
            failed.append(name)
        kernel = {"o": "flash_fwd", "dq": "flash_dq"}.get(name, "flash_dkv")
        row = rows.setdefault(kernel, {"max_abs_err": 0.0})
        row["max_abs_err"] = max(row["max_abs_err"], err)
        del got, want, diff
    del o_ref, refs
    torch.cuda.empty_cache()
    if failed:
        raise SystemExit(f"flash {failed} ({dname}, D={d}): kernels disagree "
                         "with their plain versions")
    return m, l, o


def phase_flash(torch, fa):
    import torch.nn.functional as F

    dev = torch.device("cuda")
    b, t, h, d = 32, LM["max_len"], LM["num_heads"], LM["d_model"] // LM["num_heads"]
    rows = {}
    # bf16 at D = 128 (the wgmma kernels' other width), at full length.
    g = torch.Generator(device=dev).manual_seed(17)
    wide = [torch.randn((8, t, 6, 128), generator=g, device=dev).to(
        torch.bfloat16) for _ in range(4)]
    check_flash(torch, fa, *wide, True, rows)
    del wide
    g = torch.Generator(device=dev).manual_seed(13)
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[-1]
        q, k, v, do = (torch.randn((b, t, h, d), generator=g, device=dev).to(dtype)
                       for _ in range(4))
        m, l, o = check_flash(torch, fa, q, k, v, do, True, rows)
        if dtype != torch.bfloat16:
            continue
        delta = fa.flash_delta(do, o)
        # The main path's dtype: time each kernel, the plain versions, and
        # PyTorch's SDPA forward and whole backward (dQ, dK and dV in one
        # call) on the same inputs.
        qt, kt, vt = (x.transpose(1, 2).requires_grad_(True) for x in (q, k, v))
        lib_o = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
        do_t = do.transpose(1, 2)
        bwd_plain = cuda_ms_flushed(
            torch, lambda i: fa.flash_bwd_ref(q, k, v, do, m, l, delta, True), 3)
        lib_bwd = cuda_ms_flushed(torch, lambda i: torch.autograd.grad(
            lib_o, (qt, kt, vt), do_t, retain_graph=True), 10)
        timings = {
            "flash_fwd": (lambda i: fa.flash_fwd(q, k, v, True),
                          cuda_ms_flushed(torch, lambda i: fa.flash_fwd_ref(
                              q, k, v, True), 3),
                          cuda_ms_flushed(torch, lambda i: F.scaled_dot_product_attention(
                              qt, kt, vt, is_causal=True), 10)),
            "flash_dq": (lambda i: fa._flash_dq_cuda(q, k, v, do, m, l, delta,
                                                      True),
                         bwd_plain, lib_bwd),
            "flash_dkv": (lambda i: fa._flash_dkv_cuda(q, k, v, do, m, l,
                                                        delta, True),
                          bwd_plain, lib_bwd),
        }
        bounds = flash_bounds(b, t, h, d, True, q.element_size())
        for name, (fn, plain_ms, library_ms) in timings.items():
            ms = cuda_ms_flushed(torch, fn, 20)
            nbytes, flops = bounds[name]
            b_ms, b_by = bound_ms(nbytes, flops, dname)
            rows[name].update(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                              bound_ms=b_ms, bound_by=b_by)
            print(f"  {name:10s} bf16: {ms * 1e3:.1f} us/launch "
                  f"({flops / ms / 1e9:.1f} TFLOP/s), plain "
                  f"{plain_ms * 1e3:.1f} us, SDPA {library_ms * 1e3:.1f} us, "
                  f"bound {b_ms * 1e3:.1f} us ({b_by}: {nbytes / 1e6:.1f} MB, "
                  f"{flops / 1e9:.1f} GFLOP), {b_ms / ms:.1%} of bound")
        bwd = rows["flash_dq"]["ms"] + rows["flash_dkv"]["ms"]
        bwd_flops = bounds["flash_dq"][1] + bounds["flash_dkv"][1]
        print(f"  backward, dQ + dK/dV: {bwd * 1e3:.1f} us "
              f"({bwd_flops / bwd / 1e9:.1f} TFLOP/s) against SDPA's whole "
              f"backward {lib_bwd * 1e3:.1f} us: {bwd / lib_bwd:.2f}x; dQ "
              f"alone {rows['flash_dq']['ms'] / lib_bwd:.2f}x")
        del qt, kt, vt, lib_o
        torch.cuda.empty_cache()
    check_flash_widths(torch, fa, rows)
    return rows


def check_flash_widths(torch, fa, rows):
    """The three kernels at every head width class and in f16 against the
    plain versions (B 2, T 1000, H 4, causal): D 8 and 24 pad to the
    64-column tile, 256 fills the widest (each block one 128-column half
    of the outputs); inputs on a 1/8 grid, whose scores and dO . v are
    exact in f32, so no bf16 rounding tie of dS separates the two sides.
    O is held with ``prob_bound`` (see :func:`check_flash`). Every launch
    must take the wgmma route."""
    dev = torch.device("cuda")
    cases = [(torch.bfloat16, d) for d in (8, 24, 256)]
    cases += [(torch.float16, d) for d in (8, 24, 64, 256)]
    before = dict(fa.route_launches)
    for dtype, d in cases:
        g = torch.Generator(device=dev).manual_seed(d)
        q, k, v, do = (
            (torch.round(torch.randn((2, 1000, 4, d), generator=g, device=dev)
                         * 8).clamp(-32, 32) / 8).to(dtype) for _ in range(4))
        check_flash(torch, fa, q, k, v, do, True, rows, prob_bound=True)
        del q, k, v, do
    grown = {k: n - before[k] for k, n in fa.route_launches.items()}
    want = {k: len(cases) if k.endswith("/wgmma") else 0 for k in grown}
    print(f"  routes of the width checks {grown}")
    if grown != want:
        raise SystemExit(f"flash routes {grown}, expected {want}")


# ------------------------------------------------------------ phase h, i
def lm_fwd_flops_per_token(num_layers, d_model, seq_len, vocab):
    """Analytic matmul FLOPs per token, forward (the formula of the JAX
    package's LM bench): per block qkv+proj (8 d^2) + MLP (2 d d_ff * 2,
    d_ff = 4d) + attention scores/values (4 s d); LM head (2 d V)."""
    d_ff = 4 * d_model
    return (num_layers * (8 * d_model ** 2 + 4 * d_model * d_ff
                          + 4 * seq_len * d_model)
            + 2 * d_model * vocab)


def lm_batch(batch, seq_len, seed=0):
    """Next-token batch as the JAX package's LM bench makes it."""
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, VOCAB, (batch, seq_len + 1), dtype=np.int64)
    return tok[:, :-1].astype(np.int32), tok[:, 1:].astype(np.int32)


def phase_train(torch, dtt, kernel_mods, batch=32, warmup=2, steps=5):
    t_len = LM["max_len"]
    x, y = lm_batch(batch, t_len)
    model = dtt.Model(dtt.models.transformer_lm(VOCAB, dtype="bfloat16", **LM))
    model.compile(optimizer=dtt.optim.Adam(1e-4),
                  loss="pallas_sparse_categorical_crossentropy",
                  metrics=["accuracy"])
    model.build((t_len,), seed=0)
    t = time.perf_counter()
    model.fit(x, y, batch_size=batch, epochs=warmup, steps_per_epoch=1,
              shuffle=False, verbose=0)
    torch.cuda.synchronize()
    print(f"  {model.num_params / 1e6:.1f}M params; {warmup} warm-up steps "
          f"in {time.perf_counter() - t:.2f} s")
    torch.cuda.reset_peak_memory_stats()
    for mod in kernel_mods:
        mod.reset_launch_counts()
    t = time.perf_counter()
    hist = model.fit(x, y, batch_size=batch, epochs=steps, steps_per_epoch=1,
                     shuffle=False, verbose=0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = {}
    for mod in kernel_mods:
        launches.update(mod.launches)
    losses = hist.history["loss"]
    sps = steps / wall
    tokens = batch * t_len
    fwd = lm_fwd_flops_per_token(LM["num_layers"], LM["d_model"], t_len, VOCAB)
    mfu = 3 * fwd * tokens * sps / PEAK_FLOPS["bfloat16"]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"  losses {[round(v, 5) for v in losses]}, accuracy "
          f"{hist.history['accuracy'][-1]:.5f}")
    print(f"  {steps} steps in {wall:.3f} s: {sps:.3f} steps/s, "
          f"{sps * tokens:.0f} tokens/s, MFU {mfu:.4f} (3 x {fwd / 1e6:.1f} "
          f"MFLOP/token at 989 TFLOP/s), peak memory {peak_gb:.2f} GB")
    per_step = {k: v / steps for k, v in launches.items()
                if not k.startswith("paged")}
    print(f"  launches per step {per_step}")
    if not all(np.isfinite(losses)) or not all(
            b < a for a, b in zip(losses, losses[1:])):
        raise SystemExit(f"training losses not finite and falling: {losses}")
    want = {"xent_fwd": 1, "xent_bwd": 1, "flash_fwd": LM["num_layers"],
            "flash_dq": LM["num_layers"], "flash_dkv": LM["num_layers"]}
    if per_step != want:
        raise SystemExit(f"launches per step {per_step}, expected {want}")
    routes = {k: v / steps for mod in kernel_mods
              for k, v in getattr(mod, "route_launches", {}).items() if v}
    print(f"  flash routes per step {routes}")
    want_routes = {"flash_fwd/wgmma": want["flash_fwd"],
                   "flash_dq/wgmma": want["flash_dq"],
                   "flash_dkv/wgmma": want["flash_dkv"]}
    if routes != want_routes:
        raise SystemExit(f"flash routes per step {routes}, expected "
                         f"{want_routes}")
    del model
    torch.cuda.empty_cache()
    return {k: launches[k] for k in want}


def phase_kernel_vs_plain(torch, dtt, batch=4, steps=3):
    t_len = LM["max_len"]
    x, y = lm_batch(batch, t_len, seed=1)

    def train(flash, loss):
        model = dtt.Model(dtt.models.transformer_lm(
            VOCAB, flash=flash, **dict(LM, num_layers=2)))
        model.compile(optimizer=dtt.optim.Adam(1e-4), loss=loss,
                      metrics=["accuracy"])
        model.build((t_len,), seed=1)
        hist = model.fit(x, y, batch_size=batch, epochs=steps,
                         steps_per_epoch=1, shuffle=False, verbose=0)
        return hist.history["loss"], dtt.interop.params_to_numpy(model.params)

    kern_losses, kern_params = train(True, "pallas_sparse_categorical_crossentropy")
    plain_losses, plain_params = train(False, "sparse_categorical_crossentropy")
    rel = max(abs(a - b) / abs(b) for a, b in zip(kern_losses, plain_losses))
    dparam = max(float(np.abs(kern_params[p] - plain_params[p]).max())
                 for p in kern_params)
    print(f"  kernels {kern_losses}\n  plain   {plain_losses}\n  max "
          f"relative loss difference {rel:.3e} (limit 1e-5), max parameter "
          f"difference {dparam:.3e}")
    if rel > 1e-5:
        raise SystemExit("the kernel path's losses disagree with the plain path")


# ------------------------------------------------------------------ phase j
def phase_fused_adam(torch, dtt, adam_ops, lr=3e-4, wd=0.01):
    dev = torch.device("cuda")
    lm = dtt.Model(dtt.models.transformer_lm(VOCAB, dtype="bfloat16", **LM))
    lm.build((LM["max_len"],), seed=0)
    base = [p.detach() for p in lm.params.values()]
    n = sum(p.numel() for p in base)
    g = torch.Generator(device=dev).manual_seed(17)
    grads = [torch.randn(p.shape, generator=g, device=dev) * 1e-2 for p in base]
    per_update = math.ceil(len(base) / adam_ops.MAX_LEAVES)
    print(f"  {len(base)} leaves, {n / 1e6:.1f}M f32 entries: {per_update} "
          f"launches per update ({adam_ops.MAX_LEAVES} leaves per launch)")
    err, failed = 0.0, []
    for fused, plain in (("fused_adam", "adam"), ("fused_adamw", "adamw")):
        runs = []
        for name in (fused, plain):
            opt = dtt.optim.get(name, learning_rate=lr)
            params = [p.clone() for p in base]
            state = opt.init(params)
            for _ in range(3):
                opt.update(params, grads, state)
            runs.append(params + state["mu"] + state["nu"])
        torch.cuda.synchronize()
        bad = sum(int((a.view(torch.int32) != b.view(torch.int32)).sum())
                  for a, b in zip(*runs))
        e = max(max_err(a, b) for a, b in zip(*runs))
        err = max(err, e)
        print(f"  {fused:11s} vs {plain:5s} (plain), 3 updates: {bad} of "
              f"{3 * n} p/m/v entries differ in any bit, max_abs_err "
              f"{e:.3e} (limit: bit-identical) {'ok' if not bad else 'MISMATCH'}")
        if bad:
            failed.append(fused)
        del runs
    if failed:
        raise SystemExit(f"{failed}: the fused Adam kernel disagrees with its "
                         "plain version")

    def f32(v):
        return float(torch.tensor(v, dtype=torch.float32))

    s = adam_ops.AdamScalars(
        neg_lr=-f32(lr), b1=f32(0.9), b2=f32(0.999), c1=f32(1 - f32(0.9)),
        c2=f32(1 - f32(0.999)), eps=f32(1e-8), wd=f32(wd),
        bc1=f32(1 - f32(0.9) ** 4), bc2=f32(1 - f32(0.999) ** 4))
    p = [x.clone() for x in base]
    m = [torch.zeros_like(x) for x in base]
    v = [torch.zeros_like(x) for x in base]
    ms = cuda_ms_flushed(torch, lambda i: adam_ops.adam_update(p, grads, m, v, s),
                         20, ahead=True)
    plain_ms = cuda_ms_flushed(
        torch, lambda i: adam_ops.adam_update_ref(p, grads, m, v, s), 5,
        ahead=True)
    lib_params = [torch.nn.Parameter(x.clone()) for x in base]
    for q, gr in zip(lib_params, grads):
        q.grad = gr
    lib = torch.optim.AdamW(lib_params, lr=lr, weight_decay=wd, fused=True)
    library_ms = cuda_ms_flushed(torch, lambda i: lib.step(), 5, ahead=True)
    # Each entry reads p, g, m, v and writes p, m, v (f32); 16 operations
    # (7 in the moments, 5 in the normalised step, 2 each for the decay
    # and the apply).
    nbytes, flops = 28 * n, 16 * n
    b_ms, b_by = bound_ms(nbytes, flops, "float32")
    print(f"  fused_adamw update: {ms * 1e3:.1f} us ({per_update} launches), "
          f"plain foreach {plain_ms * 1e3:.1f} us, torch.optim.AdamW(fused="
          f"True) {library_ms * 1e3:.1f} us, bound {b_ms * 1e3:.1f} us "
          f"({b_by}: {nbytes / 1e9:.3f} GB, {flops / 1e9:.2f} GFLOP), "
          f"{b_ms / ms:.1%} of bound")
    del lm, base, grads, p, m, v, lib, lib_params
    torch.cuda.empty_cache()
    return {"fused_adam": dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                               library_ms=library_ms, bound_ms=b_ms,
                               bound_by=b_by)}


# ------------------------------------------------------------------ phase k
def fit_timed(torch, model, x, y, batch, warmup, steps):
    """(mean loss of the timed steps, wall s): ``warmup`` steps, then
    ``steps`` steps as one epoch of ``fit`` on the repeated batch (one
    host sync at its end)."""
    model.fit(x, y, batch_size=batch, epochs=1, steps_per_epoch=warmup,
              shuffle=False, verbose=0)
    torch.cuda.synchronize()
    t = time.perf_counter()
    hist = model.fit(x, y, batch_size=batch, epochs=1, steps_per_epoch=steps,
                     shuffle=False, verbose=0)
    torch.cuda.synchronize()
    return hist.history["loss"][0], time.perf_counter() - t


def phase_cnn(torch, dtt, batch=256):
    port = dtt.cluster.free_port()
    os.environ["DTPU_CONFIG"] = dtt.cluster.ClusterSpec(
        workers=[f"127.0.0.1:{port}"], index=0).to_json()
    spec = dtt.cluster.initialize(timeout=120)
    strategy = dtt.DataParallel()
    print(f"  cluster: {spec.num_processes} worker(s), process group "
          f"{torch.distributed.get_backend()} of world "
          f"{strategy.num_replicas_in_sync}, device {strategy.device}")
    loss = "sparse_categorical_crossentropy"
    x, y = dtt.data.synthetic_images(batch, (28, 28), 10, 0)
    x = x[..., None].astype(np.float32) / 255.0

    def mnist(strat, seed=0):
        with strat.scope():
            m = dtt.Model(dtt.models.mnist_cnn())
            m.compile(optimizer=dtt.optim.SGD(0.001), loss=loss,
                      metrics=["accuracy"])
        m.build((28, 28, 1), seed=seed)
        return m

    rng = np.random.default_rng(0)
    cx = rng.standard_normal((batch, 32, 32, 3), dtype=np.float32)
    cy = rng.integers(0, 10, (batch,), dtype=np.int64).astype(np.int32)
    with strategy.scope():
        cifar = dtt.Model(dtt.models.cifar_cnn())
        cifar.compile(optimizer=dtt.optim.SGD(0.01, momentum=0.9), loss=loss,
                      metrics=["accuracy"])
    cifar.build((32, 32, 3))
    for name, model, xs, ys, warmup, steps in (
            ("mnist_cnn", mnist(strategy), x, y, 10, 100),
            ("cifar_cnn", cifar, cx, cy, 5, 50)):
        mean_loss, wall = fit_timed(torch, model, xs, ys, batch, warmup, steps)
        sps = steps / wall
        print(f"  {name} ({model.num_params} params), global batch {batch}, "
              f"TF32 off: {steps} steps in {wall:.3f} s after {warmup} warm-up: "
              f"{sps:.2f} steps/s, {sps * batch:.0f} images/s, mean loss "
              f"{mean_loss:.5f}")
        if not np.isfinite(mean_loss):
            raise SystemExit(f"{name}: training loss not finite")
    torch.backends.cudnn.deterministic = True
    try:
        runs = []
        for strat in (strategy, dtt.SingleDevice()):
            hist = mnist(strat, seed=1).fit(x, y, batch_size=batch, epochs=5,
                                            steps_per_epoch=1, shuffle=False,
                                            verbose=0)
            runs.append(hist.history["loss"])
    finally:
        torch.backends.cudnn.deterministic = False
    print(f"  DataParallel (world 1) {runs[0]}\n  SingleDevice           "
          f"{runs[1]}: {'equal' if runs[0] == runs[1] else 'DIFFER'}")
    if runs[0] != runs[1]:
        raise SystemExit("DataParallel over one rank and SingleDevice differ")
    return strategy


# ------------------------------------------------------------------ phase l
def phase_dp_lm(torch, dtt, strategy, kernel_mods, batch=32, warmup=2,
                steps=5):
    t_len = LM["max_len"]
    x, y = lm_batch(batch, t_len)

    def lm(optimizer):
        with strategy.scope():
            model = dtt.Model(dtt.models.transformer_lm(
                VOCAB, dtype="bfloat16", **LM))
            model.compile(optimizer=optimizer,
                          loss="pallas_sparse_categorical_crossentropy",
                          metrics=["accuracy"])
        model.build((t_len,), seed=0)
        return model

    model = lm(dtt.optim.fused_adamw(3e-4, weight_decay=0.01))
    model.fit(x, y, batch_size=batch, epochs=warmup, steps_per_epoch=1,
              shuffle=False, verbose=0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for mod in kernel_mods:
        mod.reset_launch_counts()
    t = time.perf_counter()
    hist = model.fit(x, y, batch_size=batch, epochs=steps, steps_per_epoch=1,
                     shuffle=False, verbose=0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = {}
    for mod in kernel_mods:
        launches.update(mod.launches)
    losses = hist.history["loss"]
    sps = steps / wall
    tokens = batch * t_len
    fwd = lm_fwd_flops_per_token(LM["num_layers"], LM["d_model"], t_len, VOCAB)
    mfu = 3 * fwd * tokens * sps / PEAK_FLOPS["bfloat16"]
    print(f"  losses {[round(v, 5) for v in losses]}")
    print(f"  {steps} steps in {wall:.3f} s: {sps:.3f} steps/s, "
          f"{sps * tokens:.0f} tokens/s, MFU {mfu:.4f}, peak memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    per_step = {k: v / steps for k, v in launches.items()
                if not k.startswith("paged")}
    print(f"  launches per step {per_step}")
    leaves = len(model.params)
    want = {"xent_fwd": 1, "xent_bwd": 1, "flash_fwd": LM["num_layers"],
            "flash_dq": LM["num_layers"], "flash_dkv": LM["num_layers"],
            "fused_adam": math.ceil(leaves / 64)}
    if per_step != want:
        raise SystemExit(f"launches per step {per_step}, expected {want}")
    if not all(np.isfinite(losses)) or not all(
            b < a for a, b in zip(losses, losses[1:])):
        raise SystemExit(f"training losses not finite and falling: {losses}")
    del model
    torch.cuda.empty_cache()
    runs = []
    for opt in (dtt.optim.fused_adamw(3e-4, weight_decay=0.01),
                dtt.optim.AdamW(3e-4, weight_decay=0.01)):
        model = lm(opt)
        runs.append(model.fit(x, y, batch_size=batch, epochs=3,
                              steps_per_epoch=1, shuffle=False,
                              verbose=0).history["loss"])
        del model
        torch.cuda.empty_cache()
    rel = max(abs(a - b) / abs(b) for a, b in zip(*runs))
    print(f"  fused_adamw {runs[0]}\n  AdamW       {runs[1]}\n  "
          f"{'identical' if runs[0] == runs[1] else 'not identical'}, max "
          f"relative difference {rel:.3e} (limit 1e-5)")
    if rel > 1e-5:
        raise SystemExit("fused_adamw and AdamW losses disagree")
    return launches["fused_adam"]


# ------------------------------------------------------------------ phase m
RESNET_BATCH = 256
# Forward FLOPs of ResNet-50 per 224x224 image: 4.09 G multiply-adds, 2
# FLOPs each (bench.py's 4.089e9 counts multiply-adds as FLOPs).
RESNET50_FWD_FLOPS = 8.17e9


def resnet50_shapes(torch, dtt, batch=RESNET_BATCH):
    """{(M, K, N): count} of ResNet-50's 1x1 convolutions and {(M, C):
    count} of its BatchNorms at ``batch`` images of 224x224, read from the
    layers of a built model."""
    module = dtt.models.resnet50(1000)
    module.build((224, 224, 3), torch.Generator().manual_seed(0))
    convs, bns = {}, {}
    for layer in module.modules():
        if isinstance(layer, dtt.nn.Conv2D) and layer.kernel_size == (1, 1):
            h, w, cin = layer.input_shape
            sh, sw = layer.strides
            key = (batch * -(-h // sh) * -(-w // sw), cin, layer.filters)
            convs[key] = convs.get(key, 0) + 1
        elif isinstance(layer, dtt.nn.BatchNorm):
            h, w, c = layer.input_shape
            bns[(batch * h * w, c)] = bns.get((batch * h * w, c), 0) + 1
    return convs, bns


def check_conv1x1(torch, conv_ops, x, w):
    """(max_abs_err, worst, ok) of K12 against its plain version."""
    got = conv_ops.conv1x1(x, w)
    want = conv_ops.conv1x1_ref(x, w)
    bound = x.float().abs() @ w.float().abs()
    torch.cuda.synchronize()
    err = max_err(got, want)
    if x.dtype == torch.float32:
        limit = 2e-5 * bound
    else:  # one bf16 ulp of each entry plus the f32 sums' rounding bound
        want = want.float()
        limit = (torch.exp2(torch.floor(torch.log2(
            want.abs().clamp_min(1e-30))) - 7)
            + 2 * x.shape[1] * 2.0 ** -24 * bound)
    worst = ((got.float() - want).abs() / (limit + 1e-30)).max().item()
    del got, want, bound, limit
    return err, worst, worst <= 1


def check_sums(got, want, magnitude):
    """(max_abs_err, worst, ok): (2, C) sums within rtol 1e-5 plus 1e-5 x
    ``magnitude``, each sum's sum of |terms| (a sum of signed terms can
    cancel to near 0; the order of the additions moves it by a share of
    the terms' magnitudes)."""
    atol = 1e-5 * magnitude
    worst = ((got - want).abs() / (1e-5 * want.abs() + atol + 1e-30)).max().item()
    return (got - want).abs().max().item(), worst, worst <= 1


def library_ms_or_none(torch, fn, iters, what):
    """A library yardstick's time, or None (printed) when it does not take
    these inputs; only the yardstick is optional, never a kernel."""
    try:
        return cuda_ms_flushed(torch, fn, iters, ahead=True)
    except RuntimeError as e:
        print(f"    {what}: no library time ({str(e).splitlines()[0][:120]})")
        return None


def phase_resnet_kernels(torch, dtt, conv_ops, bn_ops):
    dev = torch.device("cuda")
    convs, bns = resnet50_shapes(torch, dtt)
    print(f"  ResNet-50 at batch {RESNET_BATCH}: {sum(convs.values())} 1x1 "
          f"convolutions at {len(convs)} forward shapes, {sum(bns.values())} "
          f"BatchNorms at {len(bns)} shapes")
    g = torch.Generator(device=dev).manual_seed(19)
    failed = []
    totals = {name: dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0,
                         nbytes=0, flops=0, max_abs_err=0.0)
              for name in ("conv1x1", "bn_stats", "bn_bwd_reduce")}

    def add(name, count, err, ms, plain_ms, lib_ms, nbytes, flops, dtype):
        t = totals[name]
        t["max_abs_err"] = max(t["max_abs_err"], err)
        if dtype != torch.bfloat16 or not count:  # timed: a step's bf16 calls
            return
        b_ms, _ = bound_ms(nbytes, flops, "float32" if name != "conv1x1"
                           else "bfloat16")
        for k, v in (("ms", ms), ("plain_ms", plain_ms), ("bound_ms", b_ms),
                     ("library_ms", lib_ms)):
            t[k] = None if v is None or t[k] is None else t[k] + count * v
        t["nbytes"] += count * nbytes
        t["flops"] += count * flops

    # K12: x @ w at every shape of a training step in bf16, one shape in
    # f32, and one bf16 shape whose N is not a multiple of 8 (the wrapper
    # zero-pads it to 40 for the same kernel). A step runs each 1x1
    # convolution's forward (M, K) @ (K, N) and its dX, (M, N) @ (N, K)
    # with W^T made contiguous. Each check's launch must take its dtype's
    # route.
    products = {}
    for (m, k, n), count in convs.items():
        for shape in ((m, k, n), (m, n, k)):
            products[shape] = products.get(shape, 0) + count
    cases = [(shape, torch.bfloat16) for shape in sorted(products)]
    cases += [((3136, 64, 36), torch.bfloat16), ((50176, 256, 1024), torch.float32)]
    for (m, k, n), dtype in cases:
        x = torch.randn((m, k), generator=g, device=dev).to(dtype)
        w = (torch.randn((k, n), generator=g, device=dev) / k ** 0.5).to(dtype)
        conv_ops.reset_launch_counts()
        err, worst, ok = check_conv1x1(torch, conv_ops, x, w)
        route = "wgmma" if dtype == torch.bfloat16 else "cuda_core"
        routes = {r: c for r, c in conv_ops.route_launches.items() if c}
        dname = str(dtype).split(".")[-1]
        count = products.get((m, k, n), 0) if dtype == torch.bfloat16 else 0
        line = (f"  conv1x1 ({m:>7}, {k:>4}, {n:>4}) {dname:8s} x{count}: "
                f"max_abs_err {err:.3e}, worst {worst:.3f} of its limit "
                f"{'ok' if ok else 'MISMATCH'}, route {routes}")
        if not ok:
            failed.append(f"conv1x1 {(m, k, n)} {dname}")
        if routes != {f"conv1x1/{route}": 1}:
            failed.append(f"conv1x1 {(m, k, n)} {dname} routes {routes}, "
                          f"expected one launch on {route}")
        e = x.element_size()
        nbytes, flops = (m * k + k * n + m * n) * e, 2 * m * k * n
        ms = plain_ms = lib_ms = None
        if count:
            ms = cuda_ms_flushed(torch, lambda i: conv_ops.conv1x1(x, w), 10)
            plain_ms = cuda_ms_flushed(
                torch, lambda i: conv_ops.conv1x1_ref(x, w), 3)
            lib_ms = cuda_ms_flushed(torch, lambda i: torch.matmul(x, w), 10)
            b_ms, b_by = bound_ms(nbytes, flops, "bfloat16")
            line += (f"; {ms * 1e3:.1f} us ({flops / ms / 1e9:.1f} TFLOP/s), "
                     f"plain {plain_ms * 1e3:.1f}, torch.matmul "
                     f"{lib_ms * 1e3:.1f}, bound {b_ms * 1e3:.1f} ({b_by}), "
                     f"{b_ms / ms:.1%} of bound (torch.matmul "
                     f"{b_ms / lib_ms:.1%})")
        print(line)
        add("conv1x1", count, err, ms, plain_ms, lib_ms, nbytes, flops, dtype)
        del x, w
    torch.cuda.empty_cache()

    # K13 and K14 at every BatchNorm shape in bf16, one shape in f32.
    host_us = {"bn_stats": 0.0, "bn_bwd_reduce": 0.0}
    cases = [(shape, torch.bfloat16) for shape in sorted(bns)]
    cases.append(((50176, 256), torch.float32))
    for (m, c), dtype in cases:
        x = (torch.randn((m, c), generator=g, device=dev) * 2 + 1).to(dtype)
        dy = torch.randn((m, c), generator=g, device=dev).to(dtype)
        shift = torch.randn((c,), generator=g, device=dev) * 0.5
        mean = torch.randn((c,), generator=g, device=dev) * 0.5
        inv = torch.rand((c,), generator=g, device=dev) + 0.5
        count = bns.get((m, c), 0) if dtype == torch.bfloat16 else 0
        dname = str(dtype).split(".")[-1]
        stats = bn_ops.bn_stats(x, shift)
        again = bn_ops.bn_stats(x, shift)
        bwd = bn_ops.bn_bwd_reduce(dy, x, mean, inv)
        bwd_again = bn_ops.bn_bwd_reduce(dy, x, mean, inv)
        xc = x.float() - shift
        mag = torch.stack([xc.abs().sum(0), xc.square().sum(0)])
        del xc
        s_err, s_worst, s_ok = check_sums(stats, bn_ops.bn_stats_ref(x, shift),
                                          mag)
        dyf = dy.float()
        mag = torch.stack([dyf.abs().sum(0),
                           (dyf * (x.float() - mean) * inv).abs().sum(0)])
        del dyf
        b_err, b_worst, b_ok = check_sums(
            bwd, bn_ops.bn_bwd_reduce_ref(dy, x, mean, inv), mag)
        del mag
        same = torch.equal(stats, again) and torch.equal(bwd, bwd_again)
        ok = s_ok and b_ok and same
        line = (f"  bn ({m:>7}, {c:>4}) {dname:8s} x{count}: bn_stats "
                f"max_abs_err {s_err:.3e} worst {s_worst:.3f}, bn_bwd_reduce "
                f"{b_err:.3e} worst {b_worst:.3f}, repeat calls "
                f"{'bit-identical' if same else 'DIFFER'} "
                f"{'ok' if ok else 'MISMATCH'}")
        if not ok:
            failed.append(f"bn {(m, c)} {dname}")
        e = x.element_size()
        s_bytes, s_flops = m * c * e + 12 * c, 4 * m * c
        b_bytes, b_flops = 2 * m * c * e + 16 * c, 5 * m * c
        times = {"bn_stats": (None,) * 3, "bn_bwd_reduce": (None,) * 3}
        if dtype == torch.bfloat16:
            # The library's reductions on the NCHW view of the same rows
            # (mean/invstd and the backward's sums, in another form).
            # Device clock (ahead=True: the host queues every call first),
            # and each call's host cost on the enqueue clock.
            x4, dy4 = x.view(m, c, 1, 1), dy.view(m, c, 1, 1)
            weight = torch.ones((c,), device=dev)
            calls = {
                "bn_stats": (
                    lambda i: bn_ops.bn_stats(x, shift),
                    lambda i: bn_ops.bn_stats_ref(x, shift),
                    lambda i: torch.batch_norm_stats(x4, 1e-5),
                    "torch.batch_norm_stats"),
                "bn_bwd_reduce": (
                    lambda i: bn_ops.bn_bwd_reduce(dy, x, mean, inv),
                    lambda i: bn_ops.bn_bwd_reduce_ref(dy, x, mean, inv),
                    lambda i: torch.batch_norm_backward_reduce(
                        dy4, x4, mean, inv, weight, True, True, True),
                    "torch.batch_norm_backward_reduce"),
            }
            for name, (kernel, plain, library, what) in calls.items():
                times[name] = (
                    cuda_ms_flushed(torch, kernel, 10, ahead=True),
                    cuda_ms_flushed(torch, plain, 3, ahead=True),
                    library_ms_or_none(torch, library, 10, what))
                host_us[name] += count * 1e6 * enqueue_s(
                    torch, lambda: kernel(0))
            for name, (ms, plain_ms, lib_ms) in times.items():
                nb, fl = (s_bytes, s_flops) if name == "bn_stats" else (b_bytes, b_flops)
                b_ms, b_by = bound_ms(nb, fl, "float32")
                lib = "none" if lib_ms is None else f"{lib_ms * 1e3:.1f}"
                line += (f"\n      {name:13s} {ms * 1e3:.1f} us ("
                         f"{bn_ops.LAUNCHES_PER_CALL} launch), plain "
                         f"{plain_ms * 1e3:.1f}, library {lib}, bound "
                         f"{b_ms * 1e3:.1f} ({b_by}), {b_ms / ms:.1%} of bound")
        print(line)
        add("bn_stats", count, s_err, *times["bn_stats"], s_bytes, s_flops, dtype)
        add("bn_bwd_reduce", count, b_err, *times["bn_bwd_reduce"], b_bytes,
            b_flops, dtype)
        del x, dy, stats, again, bwd, bwd_again
    torch.cuda.empty_cache()
    if failed:
        raise SystemExit(f"{failed}: kernels disagree with their plain versions")
    rows = {}
    for name, t in totals.items():
        what = ("72 products, 36 forward and 36 dX" if name == "conv1x1"
                else "53 calls")
        b_ms, b_by = bound_ms(t["nbytes"], t["flops"],
                              "bfloat16" if name == "conv1x1" else "float32")
        lib = "none" if t["library_ms"] is None else f"{t['library_ms']:.3f}"
        host = (f"; host {host_us[name] / 1e3:.3f} ms (enqueue clock)"
                if name in host_us else "")
        print(f"  {name:13s} per step ({what}): {t['ms']:.3f} ms, plain "
              f"{t['plain_ms']:.3f}, library {lib}, bound {b_ms:.3f} ms "
              f"({b_by}: {t['nbytes'] / 1e9:.2f} GB, {t['flops'] / 1e9:.1f} "
              f"GFLOP), {b_ms / t['ms']:.1%} of bound{host}")
        rows[name] = dict(max_abs_err=t["max_abs_err"], ms=t["ms"],
                          plain_ms=t["plain_ms"], bound_ms=b_ms, bound_by=b_by,
                          library_ms=t["library_ms"])
    return rows


# ------------------------------------------------------------------ phase n
def resnet_batch(batch, size=224, classes=1000, seed=0):
    """``bench_resnet50``'s batch: normals and labels from default_rng."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((batch, size, size, 3), dtype=np.float32)
    y = rng.integers(0, classes, (batch,), dtype=np.int64).astype(np.int32)
    return x, y


def phase_resnet_train(torch, dtt, strategy, conv_ops, bn_ops, warmup=3,
                       steps=20):
    batch = RESNET_BATCH
    x, y = resnet_batch(batch)
    with strategy.scope():
        model = dtt.Model(dtt.models.resnet(50, 1000, dtype="bfloat16"))
        model.compile(optimizer=dtt.optim.SGD(0.1, momentum=0.9),
                      loss="sparse_categorical_crossentropy",
                      metrics=["accuracy"])
    model.build((224, 224, 3), seed=0)
    t = time.perf_counter()
    model.fit(x, y, batch_size=batch, epochs=1, steps_per_epoch=warmup,
              shuffle=False, verbose=0)
    torch.cuda.synchronize()
    print(f"  {model.num_params} params in {len(model.params)} leaves, "
          f"{len(model.state)} BN buffers; {warmup} warm-up steps in "
          f"{time.perf_counter() - t:.2f} s")
    torch.cuda.reset_peak_memory_stats()
    conv_ops.reset_launch_counts()
    bn_ops.reset_launch_counts()
    t = time.perf_counter()
    hist = model.fit(x, y, batch_size=batch, epochs=steps, steps_per_epoch=1,
                     shuffle=False, verbose=0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = dict(conv_ops.launches, **bn_ops.launches)
    losses = hist.history["loss"]
    sps = steps / wall
    mfu = 3 * RESNET50_FWD_FLOPS * batch * sps / PEAK_FLOPS["bfloat16"]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"  losses {[round(v, 5) for v in losses]}, accuracy "
          f"{hist.history['accuracy'][-1]:.5f}")
    print(f"  {steps} steps in {wall:.3f} s: {sps:.3f} steps/s, "
          f"{sps * batch:.1f} images/s, MFU {mfu:.4f} (3 x 8.17 GFLOP/image "
          f"at 989 TFLOP/s), peak memory {peak_gb:.2f} GB")
    per_call = bn_ops.LAUNCHES_PER_CALL
    per_step = {k: v / steps for k, v in launches.items()}
    print(f"  launches per step {per_step} (K13/K14: {per_call} per call)")
    buffers = all(bool(torch.isfinite(b).all()) for b in model.state.values())
    print(f"  BN buffers finite: {buffers}; running var of the stem BN "
          f"{model.state['batch_norm/var'][:4].tolist()}")
    want = {"conv1x1": 72, "bn_stats": 53 * per_call,
            "bn_bwd_reduce": 53 * per_call}
    if per_step != want:
        raise SystemExit(f"launches per step {per_step}, expected {want}")
    routes = {k: v / steps for k, v in conv_ops.route_launches.items() if v}
    print(f"  conv1x1 routes per step {routes}")
    if routes != {"conv1x1/wgmma": 72}:
        raise SystemExit(f"conv1x1 routes per step {routes}, expected all 72 "
                         "on wgmma")
    if not all(np.isfinite(losses)) or not buffers:
        raise SystemExit(f"ResNet-50 losses or BN buffers not finite: {losses}")
    del model
    torch.cuda.empty_cache()
    return launches


# ------------------------------------------------------------------ phase o
def phase_resnet_kernel_vs_plain(torch, dtt, strategy, batch=32, steps=3):
    x, y = resnet_batch(batch, size=32, classes=10, seed=1)
    tiny = dict(small_inputs=True, stage_blocks=(1, 1, 1, 1), width=16)
    compile_kw = dict(loss="sparse_categorical_crossentropy",
                      metrics=["accuracy"])

    def train(strat):
        with strat.scope():
            model = dtt.Model(dtt.models.resnet(50, 10, **tiny))
            model.compile(optimizer=dtt.optim.SGD(0.01, momentum=0.9),
                          **compile_kw)
        model.build((32, 32, 3), seed=1)
        hist = model.fit(x, y, batch_size=batch, epochs=steps,
                         steps_per_epoch=1, shuffle=False, verbose=0)
        return hist.history["loss"], dtt.interop.state_to_numpy(model.state)

    card, _ = train(dtt.SingleDevice())
    cpu, _ = train(dtt.SingleDevice("cpu"))
    rel = max(abs(a - b) / abs(b) for a, b in zip(card, cpu))
    print(f"  card (kernels) {card}\n  CPU (plain)    {cpu}\n  max relative "
          f"loss difference {rel:.3e} (limit 1e-4)")
    if rel > 1e-4:
        raise SystemExit("the kernel path's losses disagree with the plain path")
    torch.backends.cudnn.deterministic = True
    try:
        (dp, dp_state), (single, single_state) = (train(strategy),
                                                  train(dtt.SingleDevice()))
    finally:
        torch.backends.cudnn.deterministic = False
    same_state = all(np.array_equal(dp_state[k], single_state[k])
                     for k in single_state)
    print(f"  DataParallel (world 1) {dp}\n  SingleDevice           {single}: "
          f"losses {'equal' if dp == single else 'DIFFER'}, BN buffers "
          f"{'equal' if same_state else 'DIFFER'}")
    if dp != single or not same_state:
        raise SystemExit("DataParallel over one rank and SingleDevice differ")


# ------------------------------------------------------------------ phase p
def differential_s(torch, fn, n1=10, n2=60, warmup=3):
    """Seconds per call of ``fn()`` by the difference of two run lengths,
    each ending in a synchronize (the JAX package's profile_op_floor
    method): the fixed cost of a run (the sync) cancels."""
    def run(n):
        t = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    run(n1)
    t1 = run(n1)
    t2 = run(n2)
    return max(t2 - t1, 1e-9) / (n2 - n1)


def enqueue_s(torch, fn, n=50, warmup=3):
    """Host seconds per call of ``fn()`` over ``n`` calls made back to
    back after a synchronize, read before the closing synchronize: the
    host's cost to issue a call, whatever the device's time."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(n):
        fn()
    host = time.perf_counter() - t
    torch.cuda.synchronize()
    return host / n


def launch_costs(torch, probe_ops, paged_ops, x, rounds=5):
    """The host's cost of one launch through the port's binding, piece by
    piece: K15's wrapper on ``x`` and K1's at phase b's bf16 decode shape,
    each whole, then their packed ctypes call alone (output and scratch
    preallocated, the stream handle read once, the arguments packed on
    each call; K15's also with n = 0, where the launcher returns before
    launching), the stream read (PyTorch's ``Stream`` object, and the raw
    handle the binding reads), the output's allocation, K15's plain
    version and ``torch.mul(x, 1.0001)``. Each by the differential clock
    (``differential_s``) and the enqueue clock (``enqueue_s``), in
    ``rounds`` rounds that take the pieces in turn, so a drift of the
    host's speed reaches every piece alike; prints the median of the
    rounds and returns the differential medians in us by piece."""
    from distributed_tpu_torch.ops import _build

    dev = torch.device("cuda")
    out = torch.empty_like(x)
    st = _build.stream(dev)
    lib = probe_ops._LIB.get()
    pack = probe_ops._ARGS.pack
    xp, op, n = x.data_ptr(), out.data_ptr(), x.numel()
    args = kernel_inputs(torch, dev, torch.bfloat16, 1, False, seed=0)
    q, kp, vp, tables, positions = args
    s, kw, h, hd = q.shape
    bs, nb = kp.shape[1], tables.shape[1]
    cb = paged_ops.chunk_blocks(s, h, nb, bs, paged_ops._sm_count(0))
    counters, partials = paged_ops._workspace(
        dev, st, s * h, s * h * -(-nb // cb) * kw * (2 + hd))
    pout = torch.empty_like(q)
    plib = paged_ops._LIB.get()
    ppack = paged_ops._ARGS.pack
    pargs = (q.data_ptr(), kp.data_ptr(), vp.data_ptr(), 0, 0,
             tables.data_ptr(), positions.data_ptr(), pout.data_ptr(),
             partials.data_ptr(), counters.data_ptr(), st,
             _build.FLOAT_CODES[q.dtype], 0, 1, s, kw, h, hd, bs, nb, cb)
    pieces = [
        ("K15 launch_probe(x), whole", lambda: probe_ops.launch_probe(x)),
        ("K15 packed ctypes call alone",
         lambda: lib.dtt_launch_probe(pack(xp, op, st, n))),
        ("K15 packed ctypes call, n = 0 (returns, no launch)",
         lambda: lib.dtt_launch_probe(pack(xp, op, st, 0))),
        ("K1 paged_attention(...), whole",
         lambda: paged_ops.paged_attention(*args)),
        ("K1 packed ctypes call alone",
         lambda: plib.dtt_paged_attention(ppack(*pargs))),
        ("torch.cuda.current_stream(dev).cuda_stream",
         lambda: torch.cuda.current_stream(dev).cuda_stream),
        ("_build.raw_stream(0)", lambda: _build.raw_stream(0)),
        ("torch.empty_like(x)", lambda: torch.empty_like(x)),
        ("torch.empty_like(q)", lambda: torch.empty_like(q)),
        ("K15 plain version, x * 1.0001",
         lambda: probe_ops.launch_probe_ref(x)),
        ("torch.mul(x, 1.0001)", lambda: torch.mul(x, 1.0001)),
    ]
    diff = {name: [] for name, _ in pieces}
    enq = {name: [] for name, _ in pieces}
    for _ in range(rounds):
        for name, fn in pieces:
            diff[name].append(1e6 * differential_s(torch, fn))
            enq[name].append(1e6 * enqueue_s(torch, fn))
    med = {name: float(np.median(v)) for name, v in diff.items()}
    for name, _ in pieces:
        print(f"  {name:50s} {med[name]:8.2f} us differential, "
              f"{float(np.median(enq[name])):8.2f} us enqueue (median of "
              f"{rounds}; differential {min(diff[name]):.2f}-"
              f"{max(diff[name]):.2f})")
    return med


def phase_launch_probe(torch, probe_ops, paged_ops):
    dev = torch.device("cuda")
    x = torch.randn(probe_ops.SHAPE, generator=torch.Generator(
        device=dev).manual_seed(23), device=dev)
    probe_ops.reset_launch_counts()
    got = probe_ops.launch_probe(x)
    want = probe_ops.launch_probe_ref(x)
    torch.cuda.synchronize()
    same = torch.equal(got.view(torch.int32), want.view(torch.int32))
    print(f"  launch_probe {tuple(x.shape)} f32 vs x * 1.0001: "
          f"{'bit-identical' if same else 'DIFFER'}")
    if not same:
        raise SystemExit("launch_probe disagrees with its plain version")
    us = launch_costs(torch, probe_ops, paged_ops, x)
    ms = 1e-3 * us["K15 launch_probe(x), whole"]
    plain_ms = 1e-3 * us["K15 plain version, x * 1.0001"]
    library_ms = 1e-3 * us["torch.mul(x, 1.0001)"]
    launches = probe_ops.launches["launch_probe"]
    nbytes = 2 * x.numel() * 4
    b_ms, b_by = bound_ms(nbytes, x.numel(), "float32")
    print(f"  per launch (differential, 10 vs 60 calls, median of 5 rounds): "
          f"{ms * 1e3:.2f} us; plain version {plain_ms * 1e3:.2f} us; "
          f"torch.mul(x, 1.0001) {library_ms * 1e3:.2f} us; bound "
          f"{b_ms * 1e6:.2f} ns ({b_by}: {nbytes} bytes); {launches} launches")
    print(f"  K15 / torch.mul(x, 1.0001) per launch: {ms / library_ms:.3f}")
    return {"launch_probe": dict(max_abs_err=max_err(got, want), ms=ms,
                                 plain_ms=plain_ms, bound_ms=b_ms,
                                 bound_by=b_by, library_ms=library_ms,
                                 launches=launches)}


# ------------------------------------------------------------------ phase q
def close_in_ulps(torch, got, want, dtype, extra=0.0):
    """(max_abs_err, worst, ok): every entry within one ulp of ``dtype``
    (bf16 2^-7, f16 2^-10 of its binade; f16 2^-24 below its normal range)
    of the plain version's, plus ``extra``."""
    want = want.float()
    bits = 7 if dtype == torch.bfloat16 else 10
    ulp = torch.exp2(torch.floor(torch.log2(want.abs().clamp_min(1e-30))) - bits)
    if bits == 10:
        ulp = ulp.clamp_min(2.0 ** -24)
    diff = (got.float() - want).abs()
    worst = (diff / (ulp + extra)).max().item()
    return diff.max().item(), worst, worst <= 1


def phase_f16(torch, dtt, xent_ops, conv_ops, bn_ops):
    """The f16 repair: K9/K10, K12 and K13/K14 on f16 tensors against their
    plain versions, then a small f16 ResNet through ``fit``."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(29)
    failed = []

    def report(what, err, worst, ok, extra=""):
        print(f"  {what}: max_abs_err {err:.3e}, worst {worst:.3f} of its "
              f"limit{extra} {'ok' if ok else 'MISMATCH'}")
        if not ok:
            failed.append(what)

    # K9/K10 at the LM head's vocabulary, 4 x 1024 rows.
    n = 4 * LM["max_len"]
    logits = (2 * torch.randn((n, VOCAB), generator=g, device=dev)).half()
    labels = torch.randint(0, VOCAB, (n,), generator=g, device=dev)
    gout = torch.full((n,), 1.0 / n, device=dev)
    before = dict(xent_ops.launches)
    loss = xent_ops.xent_fwd(logits, labels)
    dl = xent_ops.xent_bwd(logits, labels, gout)
    torch.cuda.synchronize()
    err = max_err(loss, xent_ops.xent_fwd_ref(logits, labels))
    report(f"xent_fwd (N={n}, C={VOCAB}) f16, limit 1e-4", err, err / 1e-4,
           err <= 1e-4)
    report(f"xent_bwd (N={n}, C={VOCAB}) f16, one f16 ulp",
           *close_in_ulps(torch, dl, xent_ops.xent_bwd_ref(logits, labels,
                                                           gout), torch.float16))
    if {k: xent_ops.launches[k] - before[k] for k in before} != {
            "xent_fwd": 1, "xent_bwd": 1}:
        failed.append("xent f16 launches")
    del logits, labels, gout, loss, dl

    # K12 at a ResNet-50 shape and with N not a multiple of 8.
    for m, k, nn in ((50176, 256, 1024), (3136, 64, 36)):
        x = torch.randn((m, k), generator=g, device=dev).half()
        w = (torch.randn((k, nn), generator=g, device=dev) / k ** 0.5).half()
        conv_ops.reset_launch_counts()
        got = conv_ops.conv1x1(x, w)
        bound = 2 * k * 2.0 ** -24 * (x.float().abs() @ w.float().abs())
        report(f"conv1x1 ({m}, {k}, {nn}) f16, one f16 ulp + 2K 2^-24 "
               f"sum|x||w|", *close_in_ulps(torch, got,
                                          conv_ops.conv1x1_ref(x, w),
                                          torch.float16, bound),
               f", routes {dict(conv_ops.route_launches)}")
        if conv_ops.route_launches != {"conv1x1/cuda_core": 0,
                                       "conv1x1/wgmma": 1}:
            failed.append(f"conv1x1 f16 route {conv_ops.route_launches}")
        del x, w, got, bound

    # K13/K14 at a ResNet-50 shape and a ragged one (the per-element route).
    for m, c in ((200704, 128), (100003, 3)):
        x = (torch.randn((m, c), generator=g, device=dev) * 2 + 1).half()
        dy = torch.randn((m, c), generator=g, device=dev).half()
        shift = torch.randn((c,), generator=g, device=dev) * 0.5
        mean = torch.randn((c,), generator=g, device=dev) * 0.5
        inv = torch.rand((c,), generator=g, device=dev) + 0.5
        bn_ops.reset_launch_counts()
        stats = [bn_ops.bn_stats(x, shift) for _ in range(2)]
        bwd = [bn_ops.bn_bwd_reduce(dy, x, mean, inv) for _ in range(2)]
        xc = x.float() - shift
        err, worst, ok = check_sums(stats[0], bn_ops.bn_stats_ref(x, shift),
                                    torch.stack([xc.abs().sum(0),
                                                 xc.square().sum(0)]))
        dyf = dy.float()
        b_err, b_worst, b_ok = check_sums(
            bwd[0], bn_ops.bn_bwd_reduce_ref(dy, x, mean, inv),
            torch.stack([dyf.abs().sum(0),
                         (dyf * (x.float() - mean) * inv).abs().sum(0)]))
        same = torch.equal(stats[0], stats[1]) and torch.equal(bwd[0], bwd[1])
        report(f"bn ({m}, {c}) f16: bn_stats, then bn_bwd_reduce {b_err:.3e} "
               f"worst {b_worst:.3f}; repeat calls "
               f"{'bit-identical' if same else 'DIFFER'}", err,
               max(worst, b_worst), ok and b_ok and same,
               f", launches {dict(bn_ops.launches)}")
        if dict(bn_ops.launches) != {"bn_stats": 2, "bn_bwd_reduce": 2}:
            failed.append(f"bn f16 launches {dict(bn_ops.launches)}")
        del x, dy, xc, dyf, stats, bwd
    torch.cuda.empty_cache()

    # A small f16 ResNet, 3 fit steps, every repaired kernel on its path.
    batch = 32
    x, y = resnet_batch(batch, size=32, classes=10, seed=3)
    model = dtt.Model(dtt.models.resnet(
        50, 10, small_inputs=True, stage_blocks=(1, 1, 1, 1), width=16,
        dtype="float16"))
    model.compile(optimizer=dtt.optim.SGD(0.01, momentum=0.9),
                  loss="pallas_sparse_categorical_crossentropy",
                  metrics=["accuracy"])
    model.build((32, 32, 3), seed=3)
    for ops in (xent_ops, conv_ops, bn_ops):
        ops.reset_launch_counts()
    hist = model.fit(x, y, batch_size=batch, epochs=3, steps_per_epoch=1,
                     shuffle=False, verbose=0)
    torch.cuda.synchronize()
    launches = dict(xent_ops.launches, **conv_ops.launches, **bn_ops.launches)
    losses = hist.history["loss"]
    print(f"  resnet(50, 10, small_inputs, stage_blocks (1, 1, 1, 1), width "
          f"16, float16), 32x32, batch {batch}, 3 steps: losses "
          f"{[round(v, 5) for v in losses]}, launches {launches}")
    if not all(np.isfinite(losses)):
        failed.append(f"f16 ResNet losses {losses}")
    if not all(launches.values()):
        failed.append(f"f16 ResNet launched none of some kernel: {launches}")
    if failed:
        raise SystemExit(f"{failed}: the f16 checks failed")


# ------------------------------------------------------------------ phase r
def host_state(dtt, model):
    """``{path: numpy}`` of a model's params, state and optimizer state,
    copied to the host now, under the checkpoint's own paths."""
    from distributed_tpu_torch.checkpoint import core as ckpt
    return ckpt.flatten_tree({
        "params": model.params, "state": model.state,
        "opt_state": model._opt_tree("full")})


def differing(a, b):
    """The paths where two ``{path: array}`` differ in presence, dtype,
    shape or any bit."""
    return sorted(p for p in set(a) | set(b)
                  if p not in a or p not in b or a[p].dtype != b[p].dtype
                  or a[p].shape != b[p].shape
                  or a[p].tobytes() != b[p].tobytes())


def resume_run(torch, dtt, tag, make, x, y, batch, kernel_mods, tmp):
    """Run A fits 4 steps (one per epoch) with an async ``ModelCheckpoint``
    every 2 steps and a host copy right after the step-2 save; two
    uninterrupted runs (the first with a synchronous save at step 2) give
    the spread of step 4; run B, a fresh model, restores through
    ``ModelCheckpoint(restore=True)`` from a directory that holds A's
    step-2 file (as a run that died before its step-4 save would leave)
    and runs steps 3-4 with the launch counts zeroed just before and read
    just after. Returns B's launches; raises on any disagreement."""
    from distributed_tpu_torch.checkpoint import core as ckpt
    cb = dtt.callbacks
    fit = dict(batch_size=batch, epochs=4, steps_per_epoch=1, shuffle=False,
               seed=0, verbose=0)
    times, copies = {}, {}

    def stall(key):
        """Callbacks around a save at step 2: host time to return, and to
        the end of the device work it queued."""
        def before(m, step, logs):
            if step == 2:
                torch.cuda.synchronize()
                times[key] = [time.perf_counter()]

        def after(m, step, logs):
            if step == 2:
                times[key].append(time.perf_counter())
                torch.cuda.synchronize()
                times[key].append(time.perf_counter())
        return (cb.LambdaCallback(on_batch_end=before),
                cb.LambdaCallback(on_batch_end=after))

    def losses_of(model, callbacks):
        out = model.fit(x, y, callbacks=callbacks, **fit).history["loss"]
        torch.cuda.synchronize()
        del model
        torch.cuda.empty_cache()
        return out

    pre, post = stall("sync")
    u1 = losses_of(make(), [pre, cb.ModelCheckpoint(tmp / "sync", save_freq=2),
                            post])
    u2 = losses_of(make(), [])
    pre, post = stall("async")
    snap = cb.LambdaCallback(on_batch_end=lambda m, s, logs: s == 2 and (
        copies.setdefault("A step 2", host_state(dtt, m))))
    a = losses_of(make(), [pre, cb.ModelCheckpoint(
        tmp / "async", save_freq=2, async_save=True), post, snap])
    copies["async file"], meta = ckpt._load_flat(tmp / "async" / "ckpt-2.npz")
    (tmp / "died").mkdir()
    shutil.copy(tmp / "async" / "ckpt-2.npz", tmp / "died")

    def restore_begin(m):
        torch.cuda.synchronize()
        times["restore"] = time.perf_counter()

    def restore_end(m):
        torch.cuda.synchronize()
        times["restore"] = time.perf_counter() - times["restore"]
        copies["B restored"] = host_state(dtt, m)

    for mod in kernel_mods:
        mod.reset_launch_counts()
    model_b = make()
    b = model_b.fit(x, y, callbacks=[
        cb.LambdaCallback(on_train_begin=restore_begin),
        cb.ModelCheckpoint(tmp / "died", save_freq=100, restore=True),
        cb.LambdaCallback(on_train_begin=restore_end)], **fit).history["loss"]
    torch.cuda.synchronize()
    launches = {}
    for mod in kernel_mods:
        launches.update(mod.launches)
    step_b = model_b.step
    del model_b
    torch.cuda.empty_cache()

    size = (tmp / "async" / "ckpt-2.npz").stat().st_size
    n_leaves = len(copies["async file"])
    print(f"  {tag}: checkpoint {size / 1e6:.1f} MB, {n_leaves} leaves, "
          f"meta {meta}; save at step 2, blocking the train loop: sync "
          f"{times['sync'][1] - times['sync'][0]:.4f} s; async "
          f"{times['async'][1] - times['async'][0]:.4f} s on the host, "
          f"{times['async'][2] - times['async'][0]:.4f} s to its device "
          f"copies' end; restore (load, checks, copies to the card) "
          f"{times['restore']:.4f} s | {card_line()}")
    bad = {f"{p} vs {q}": differing(copies[p], copies[q])
           for p, q in (("async file", "A step 2"),
                        ("B restored", "A step 2"))}
    print(f"  async file, B's restored tensors, A's step-2 copy: "
          + ", ".join(f"{k} {'bit-identical' if not v else f'DIFFER at {v[:3]}'}"
                      for k, v in bad.items()))
    ulp = float(np.spacing(np.float32(a[3])))
    runs = [u1[3], u2[3], a[3]]
    spread = max(max(runs) - min(runs), 4 * ulp)
    lo, hi = min(runs) - spread, max(runs) + spread
    print(f"  losses: A {a}, B {b} (resumed at step {step_b - len(b)}); "
          f"uninterrupted step 4 {u1[3]!r}, {u2[3]!r}; B step 3 "
          f"{'bit-identical' if b[0] == a[2] else 'DIFFERS'}; B step 4 "
          f"{b[1]!r} in [{lo!r}, {hi!r}] (the runs' spread, at least 4 "
          f"ulps of f32)")
    print(f"  launches in B's 2 steps {launches}")
    failed = [k for k, v in bad.items() if v]
    if step_b != 4 or len(b) != 2:
        failed.append(f"B ran to step {step_b} in {len(b)} epochs")
    if b[0] != a[2]:
        failed.append(f"B's step-3 loss {b[0]!r} != A's {a[2]!r}")
    if not lo <= b[1] <= hi:
        failed.append(f"B's step-4 loss {b[1]!r} outside [{lo!r}, {hi!r}]")
    if not all(np.isfinite(a + b + u1 + u2)):
        failed.append("losses not finite")
    if not launches or not all(launches.values()):
        failed.append(f"a kernel was not launched in B's steps: {launches}")
    if failed:
        raise SystemExit(f"{tag}: {failed}")
    return launches


def phase_resume(torch, dtt, conv_ops, bn_ops, lm_mods):
    import tempfile
    from pathlib import Path
    strategy = dtt.DataParallel()
    root = Path(tempfile.mkdtemp(prefix="dtt-resume-"))
    try:
        x, y = resnet_batch(RESNET_BATCH)

        def resnet50():
            with strategy.scope():
                m = dtt.Model(dtt.models.resnet(50, 1000, dtype="bfloat16"))
                m.compile(optimizer=dtt.optim.SGD(0.1, momentum=0.9),
                          loss="sparse_categorical_crossentropy",
                          metrics=["accuracy"])
            return m.build((224, 224, 3), seed=0)

        launches = resume_run(
            torch, dtt, f"ResNet-50 bf16, batch {RESNET_BATCH}", resnet50, x,
            y, RESNET_BATCH, (conv_ops, bn_ops), root / "resnet")
        del x, y
        t_len, lm_batch_rows = 256, 8
        x, y = lm_batch(lm_batch_rows, t_len, seed=2)

        def small_lm():
            with strategy.scope():
                m = dtt.Model(dtt.models.transformer_lm(
                    VOCAB, num_layers=2, d_model=128, num_heads=2,
                    max_len=t_len, dtype="bfloat16", flash=True))
                m.compile(optimizer=dtt.optim.fused_adamw(
                              1e-3, weight_decay=0.01),
                          loss="pallas_sparse_categorical_crossentropy",
                          metrics=["accuracy"])
            return m.build((t_len,), seed=0)

        launches.update(resume_run(
            torch, dtt, f"LM 2 layers d 128 bf16, fused_adamw, batch "
            f"{lm_batch_rows} x {t_len}", small_lm, x, y, lm_batch_rows,
            lm_mods, root / "lm"))
    finally:
        shutil.rmtree(root, ignore_errors=True)
        dtt.cluster.shutdown()
    return launches


# ------------------------------------------------------------------ phase s
def truncated_draft(dtt, target, layers, dtype=None, seed=0):
    """The target's first ``layers`` blocks plus its embedding, positional
    table, final norm and head, copied by layer name (``bench.py``'s
    free-draft construction)."""
    draft = dtt.Model(dtt.models.transformer_lm(
        VOCAB, dtype=dtype, **dict(LM, num_layers=layers)))
    draft.build((LM["max_len"],), seed=seed)
    own = target.params
    draft.load_params({k: own[k] for k in draft.params})
    return draft


def launches_by_kw(paged_ops):
    return {f"{name}/kw{kw}": n
            for (name, kw), n in sorted(paged_ops.launches_by_kw.items())}


def snapshot_bytes(served):
    return sum(t.numel() * t.element_size() for t in served.params.values())


def spec_full_width(torch, dtt, paged_ops, target, draft, label, reqs,
                    fused_c):
    """(s1) One speculative run at full width (counts zeroed just before,
    read just after); returns K1's launches and the target's snapshot
    bytes."""
    engine = dtt.serving.Engine(
        target, max_slots=8, block_size=16, max_len=LM["max_len"],
        decode_kernel="fused", draft_model=draft, spec_k=4)
    snap = snapshot_bytes(engine._target)
    snap_draft = snapshot_bytes(engine._draft_served)
    paged_ops.reset_launch_counts()
    t = time.perf_counter()
    outs = engine.run([dtt.serving.Request(p, m) for p, m in reqs])
    wall = time.perf_counter() - t
    by_kw = launches_by_kw(paged_ops)
    launches = paged_ops.launches["paged_attention"]
    tel = engine.last_run_telemetry
    check_outputs(outs, reqs, VOCAB)
    spec = tel["speculative"]
    rounds = spec["rounds"]
    report(label, tel, wall)
    share, first = agreement(outs, fused_c, reqs)
    draft_layers = sum(1 for k in draft.params if k.endswith("/wq"))
    print(f"  {label}: accept rate {spec['accept_rate']:.4f}, tokens per "
          f"verify {spec['tokens_per_dispatch']:.3f} (8 slots), rounds "
          f"{rounds}; host ms a round: draft chain "
          f"{tel['draft'] / rounds * 1e3:.2f} (3 decodes), verify "
          f"{tel['decode'] / rounds * 1e3:.2f}; prefill {tel['prefill']:.3f}"
          f" s in all")
    print(f"  {label}: K1 launches by kw {by_kw}; agreement with phase c's "
          f"fused run {share:.4f} (first tokens "
          f"{'match' if first else 'DIFFER'}); engine snapshots in device "
          f"memory: target {snap / 1e6:.1f} MB, draft {snap_draft / 1e6:.1f}"
          " MB")
    want = {"paged_attention/kw1": draft_layers * 3 * rounds,
            "paged_attention/kw4": LM["num_layers"] * rounds}
    if by_kw != want:
        raise SystemExit(f"{label}: K1 launches {by_kw}, expected {want} "
                         "(one per layer and pass)")
    del engine
    torch.cuda.empty_cache()
    return launches, snap


def spec_exact(dtt, paged_ops, small, sreqs):
    """(s2) Token-exact speculation at f32 through K1/K2 (counts zeroed
    just before each run, read just after); returns K2's launches in the
    int8 run."""
    drafts = {"self-draft": small,
              "1-layer draft": truncated_draft(dtt, small, 1, seed=3)}
    plain = {}
    int8_launches = 0
    for draft, k, kv in [("self-draft", 4, None), ("self-draft", 12, None),
                         ("1-layer draft", 4, None),
                         ("1-layer draft", 12, None),
                         ("self-draft", 4, "int8")]:
        if kv not in plain:
            plain[kv], _, _ = serve(dtt, small, sreqs, decode_kernel="fused",
                                    kv_dtype=kv)
        paged_ops.reset_launch_counts()
        got, tel, _ = serve(dtt, small, sreqs, decode_kernel="fused",
                            kv_dtype=kv, draft_model=drafts[draft], spec_k=k)
        by_kw = launches_by_kw(paged_ops)
        name = "paged_attention_int8" if kv else "paged_attention"
        launched = paged_ops.launches[name]
        exact = all(np.array_equal(x, y) for x, y in zip(got, plain[kv]))
        spec = tel["speculative"]
        label = f"{draft}{', int8 KV' if kv else ''} spec_k={k}"
        print(f"  {label}: token-exact {exact}, accept rate "
              f"{spec['accept_rate']:.4f}, tokens per verify "
              f"{spec['tokens_per_dispatch']:.3f}, rounds {spec['rounds']}, "
              f"{tel['tokens_per_sec']:.1f} tokens/s; launches {by_kw}")
        if not exact:
            raise SystemExit(f"{label}: speculative tokens differ from plain "
                             "decode's")
        if by_kw.get(f"{name}/kw{k}", 0) != 2 * tel["decode_steps"]:
            raise SystemExit(f"{label}: the verify did not launch {name} at "
                             f"kw {k} once per layer and round")
        if kv:
            int8_launches = launched
    return int8_launches


def swap_hook(at, tree, seen):
    def hook(engine, step):
        if step == at:
            t = time.perf_counter()
            engine.update_weights(tree)
            seen.append(time.perf_counter() - t)
    return hook


def moved(torch, params, by):
    """A copy of ``params`` with each leaf moved by ``by`` times its mean
    magnitude, on the card."""
    with torch.no_grad():
        return {k: v + by * v.abs().mean() for k, v in params.items()}


def phase_spec(torch, dtt, paged_ops, reqs, fused_c, small, sreqs):
    print("  (s1) GPT-2-small, 8 slots, spec_k 4, fused")
    target = dtt.Model(dtt.models.transformer_lm(
        VOCAB, dtype="bfloat16", **LM))
    target.build((LM["max_len"],), seed=0)
    draft = truncated_draft(dtt, target, LM["num_layers"] // 2,
                            dtype="bfloat16", seed=1)
    serve(dtt, target, requests(2, (8, 16), (4, 4), seed=1),
          decode_kernel="fused", draft_model=draft, spec_k=4)  # warm-up
    k1, snap = spec_full_width(torch, dtt, paged_ops, target, draft,
                               f"{LM['num_layers'] // 2}-layer draft", reqs,
                               fused_c)
    k1_self, _ = spec_full_width(torch, dtt, paged_ops, target, target,
                                 "self-draft", reqs, fused_c)
    del draft
    torch.cuda.empty_cache()

    print("  (s2) 2 layers, f32, TF32 off: speculation must be token-exact")
    k2 = spec_exact(dtt, paged_ops, small, sreqs)

    print("  (s3) update_weights mid-run through on_decode_step")
    engine = dtt.serving.Engine(target, max_slots=8, block_size=16,
                                max_len=LM["max_len"], decode_kernel="fused")
    new = moved(torch, target.params, 0.01)
    seen = []
    engine.run([dtt.serving.Request(p, m) for p, m in reqs[:8]],
               on_decode_step=swap_hook(8, new, seen))
    tel = engine.last_run_telemetry
    n_params = sum(t.numel() for t in new.values())
    spans = sorted({json.dumps(r["weights_versions"])
                    for r in tel["requests"]})
    print(f"  GPT-2-small: update_weights of {n_params / 1e6:.1f}M parameters "
          f"({snap / 1e6:.1f} MB) blocked {seen[0] * 1e3:.2f} ms (the copy "
          f"into the snapshot, then a synchronize); weights_versions spans "
          f"{spans}; weight_swaps {tel['weight_swaps']}")
    if tel["weight_swaps"] != 1 or len(seen) != 1:
        raise SystemExit("the full-width swap did not happen once")
    del engine, new, target
    torch.cuda.empty_cache()
    # A request admitted after the swap (one slot: it waits for the first
    # to finish) against a fresh engine on the new weights.
    first, later = sreqs[0], sreqs[1]
    new = moved(torch, small.params, 0.02)
    engine = dtt.serving.Engine(small, max_slots=1, block_size=16,
                                max_len=LM["max_len"], decode_kernel="fused")
    seen = []
    outs = engine.run([dtt.serving.Request(p, m) for p, m in (first, later)],
                      on_decode_step=swap_hook(3, new, seen))
    rows = engine.last_run_telemetry["requests"]
    fresh_model = dtt.Model(dtt.models.transformer_lm(
        VOCAB, **dict(LM, num_layers=2)))
    fresh_model.build((LM["max_len"],), seed=1)
    fresh_model.load_params(new)
    fresh = dtt.serving.Engine(
        fresh_model, max_slots=1, block_size=16, max_len=LM["max_len"],
        decode_kernel="fused").run([dtt.serving.Request(*later)])
    match = np.array_equal(outs[1], fresh[0])
    print(f"  2-layer f32: spans {rows[0]['weights_versions']} then "
          f"{rows[1]['weights_versions']}; the request admitted after the "
          f"swap equals a fresh engine's on the new weights: {match}")
    if not match or rows[1]["weights_versions"] != [
            {"version": 1, "tokens": later[1]}]:
        raise SystemExit("a request admitted after the swap did not serve "
                         "the new weights")
    return k1 + k1_self, k2


# ------------------------------------------------------------------ phase t
def launch_counts(mods):
    return {name: n for mod in mods for name, n in mod.launches.items()}


def reset_counts(mods):
    for mod in mods:
        mod.reset_launch_counts()


def wall_s(torch, run):
    """Host seconds of ``run()``, from a synchronized card to its end."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    run()
    torch.cuda.synchronize()
    return time.perf_counter() - t


def device_trace(torch, run):
    """[(name, start us, end us)] of every kernel, copy and set on the
    card in ``run()`` under ``torch.profiler`` (CUPTI; a graph replay's
    kernels included). The spans' ``record_function`` ranges also appear
    on the card's timeline, over the kernels they hold, so user
    annotations are left out."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        run()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    return [(e.name, e.time_range.start, e.time_range.end)
            for e in prof.events() if e.device_type == cuda
            and not getattr(e, "is_user_annotation", False)
            and e.name not in ("input_wait", "dispatch", "checkpoint_wait")]


def busy_ms(torch, run):
    """(the card's busy ms in ``run()``, its operations): the union of the
    time ranges of ``device_trace``."""
    ranges = sorted((a, b) for _, a, b in device_trace(torch, run))
    busy_us, end = 0.0, -math.inf
    for start, stop in ranges:
        if stop > end:
            busy_us += stop - max(start, end)
            end = stop
    return busy_us / 1e3, len(ranges)


def kernel_runs(torch, run, names):
    """{name: how often its kernel ran on the card in ``run()``}, counted
    by ``TRACE_NAMES`` in ``device_trace``."""
    ops = [op for op, _, _ in device_trace(torch, run)]
    return {n: sum(bool(re.search(TRACE_NAMES[n], op)) for op in ops)
            for n in names}


def interleaved(torch, arms, pairs):
    """{arm: [ms a step of each run]}: the arms' runs in turn, ``pairs``
    times (``arms``: {name: (run, steps)})."""
    out = {name: [] for name in arms}
    for _ in range(pairs):
        for name, (run, steps) in arms.items():
            out[name].append(1e3 * wall_s(torch, run) / steps)
    return out


def report_arms(torch, arms, ms):
    """Print each arm's ms a step (runs, median) and its busy share: the
    profiled run's device ms against the median run's wall; returns
    {arm: (median ms, busy share)}."""
    out = {}
    for name, (run, steps) in arms.items():
        med = float(np.median(ms[name]))
        dev, n = busy_ms(torch, run)
        share = dev / steps / med
        out[name] = (med, share)
        print(f"  {name}: ms a step {[round(v, 3) for v in ms[name]]} "
              f"(median {med:.3f}); busy {dev / steps:.3f} ms a step in "
              f"{n / steps:.0f} device operations = {share:.1%}")
    return out


def lm_rows(n, t_len, seed=0):
    """``n`` rows of next-token data (the phase h generator, more rows)."""
    tok = np.random.default_rng(seed).integers(0, VOCAB, (n, t_len + 1),
                                               dtype=np.int64)
    return tok[:, :-1].astype(np.int32), tok[:, 1:].astype(np.int32)


def phase_fit_lm(torch, dtt, mods, batch=32):
    """t1: GPT-2-small's fit loop (bf16 layers, fused_adam(1e-4), pallas
    loss, flash): (a) grad_accum=4 against the same batches whole, (b) K=4
    (CUDA graphs) against K=1 eager from the same start, timed in
    interleaved pairs, (c) fit from an iterator with prefetch=2."""
    t_len = LM["max_len"]
    x, y = lm_rows(8 * batch, t_len)
    loss = "pallas_sparse_categorical_crossentropy"

    def lm(**kw):
        m = dtt.Model(dtt.models.transformer_lm(VOCAB, dtype="bfloat16",
                                                **LM))
        m.compile(optimizer=dtt.optim.fused_adam(1e-4), loss=loss,
                  metrics=["accuracy"], **kw)
        return m.build((t_len,), seed=0)

    def fit(m, steps, **kw):
        return m.fit(x, y, batch_size=batch, epochs=1, steps_per_epoch=steps,
                     shuffle=False, verbose=0, **kw).history["loss"]

    one, acc = lm(), lm()
    start = {p: v.detach().float().clone() for p, v in one.params.items()}

    def update_rel():
        """||acc's update - one's|| / ||one's||, over every parameter from
        the common start."""
        num = den = 0.0
        with torch.no_grad():
            for p, s0 in start.items():
                dw = one.params[p].float() - s0
                num += float(((acc.params[p].float() - s0 - dw) ** 2).sum())
                den += float((dw ** 2).sum())
        return math.sqrt(num / den)

    whole, accum, rel = [], [], []
    per_step_whole, per_step_acc = {}, {}
    for _ in range(2):
        for m, losses, counts, kw in ((one, whole, per_step_whole, {}),
                                      (acc, accum, per_step_acc,
                                       {"grad_accum": 4})):
            reset_counts(mods)
            losses.append(fit(m, 1, **kw)[0])
            for k, v in launch_counts(mods).items():
                counts[k] = counts.get(k, 0) + v / 2
        rel.append(update_rel())
    del start
    print(f"  (a) grad_accum=4 losses {accum} against the whole batches' "
          f"{whole}; the updates' relative L2 difference after each step "
          f"{rel}; launches a step {per_step_acc} (whole: "
          f"{per_step_whole})")
    if not np.allclose(accum, whole, rtol=TOL["bfloat16"]):
        raise SystemExit("grad_accum=4 losses differ from the whole batch's")
    if max(rel) > ACCUM_UPDATE_REL:
        raise SystemExit(f"grad_accum=4 updates differ from the whole "
                         f"batch's by {max(rel)} > {ACCUM_UPDATE_REL}")
    want = {"xent_fwd": 4, "xent_bwd": 4, "flash_fwd": 4 * LM["num_layers"],
            "flash_dq": 4 * LM["num_layers"],
            "flash_dkv": 4 * LM["num_layers"], "fused_adam": 4}
    if per_step_acc != want:
        raise SystemExit(f"grad_accum launches a step {per_step_acc}, "
                         f"expected {want}")
    del one, acc
    torch.cuda.empty_cache()

    # (b): both from seed 0. The wrappers count where they launch: in the
    # K=4 fit that captures, its warm-up and its capture (each one step's
    # kernels) and the eager update; in a fit of replays, the update only,
    # while the profiler's trace counts every kernel the replays run.
    ref, graph = lm(), lm(steps_per_execution=4)
    eager_losses = fit(ref, 8)
    reset_counts(mods)
    graph_losses = fit(graph, 8)  # the first dispatch captures the graph
    captured = launch_counts(mods)
    with torch.no_grad():
        diff = max(float((a - b).abs().max()) for a, b in zip(
            ref.params.values(), graph.params.values()))
    print(f"  (b) K=4, graph-replayed: epoch loss {graph_losses[0]!r} over 8 "
          f"steps against K=1 eager {eager_losses[0]!r}; parameters after "
          f"8 steps {'bit-identical' if diff == 0 else f'differ by {diff}'}; "
          f"{len(graph._graphs)} captured graph(s); launches in the fit "
          f"that captured {captured}")
    if not np.allclose(graph_losses, eager_losses, rtol=TOL["bfloat16"]):
        raise SystemExit("K=4 graph losses differ from K=1 eager")
    if diff != 0:
        raise SystemExit("K=4 graph parameters differ from K=1 eager's")
    n_l = LM["num_layers"]
    per_step = {"xent_fwd": 1, "xent_bwd": 1, "flash_fwd": n_l,
                "flash_dq": n_l, "flash_dkv": n_l}
    want = dict({k: 2 * v for k, v in per_step.items()}, fused_adam=32)
    if captured != want:
        raise SystemExit(f"the capturing fit launched {captured}, expected "
                         f"{want}")
    reset_counts(mods)
    runs = kernel_runs(torch, lambda: fit(graph, 8), want)  # replays only
    counted = launch_counts(mods)
    print(f"  8 more graph-replayed steps: kernels run (profiler trace) "
          f"{runs}; the wrappers' counts {counted}")
    want = dict({k: 8 * v for k, v in per_step.items()}, fused_adam=32)
    if runs != want:
        raise SystemExit(f"8 replayed steps ran {runs}, expected {want}")
    if counted != dict({k: 0 for k in per_step}, fused_adam=32):
        raise SystemExit(f"an eager launch in the replayed steps: {counted}")
    # Runs of 8 steps: 2 dispatches at K=4, so the prefetch thread stages
    # the second while the first runs, as in a long fit.
    arms = {"K=1 eager": (lambda: fit(ref, 8), 8),
            "K=4 graph": (lambda: fit(graph, 8), 8)}
    timing = report_arms(torch, arms, interleaved(torch, arms, 3))
    del graph
    torch.cuda.empty_cache()

    # (c): a plain iterator of host batches (a Pipeline feeds uint8
    # images; tokens come as int arrays), staged two dispatches ahead.
    def batches():
        while True:
            for i in range(0, x.shape[0], batch):
                yield x[i:i + batch], y[i:i + batch]

    ref.fit(batches(), epochs=1, steps_per_epoch=8, verbose=0, prefetch=2)
    tel = ref.last_fit_telemetry
    print(f"  (c) iterator, prefetch=2, 8 steps: input_wait "
          f"{tel['input_wait']:.4f} s = {tel['input_wait_fraction']:.2%} "
          f"of {tel['total_seconds']:.3f} s; dispatch "
          f"{tel['dispatch_fraction']:.2%}; peak memory "
          f"{tel['device_memory']['peak_bytes_in_use'] / 1e9:.2f} GB")
    del ref
    torch.cuda.empty_cache()
    return captured, runs, timing


def h2d_ms(torch, a, pinned):
    """Device ms of copying the host array ``a`` to the card: pageable
    (``torch.from_numpy(a).to(card)``), or from a pinned buffer with
    ``non_blocking`` on a side stream, the copy ``data.DeviceStager``
    makes; the median of 3 copies, each between CUDA events on its
    stream."""
    src = torch.from_numpy(a)
    stream = torch.cuda.current_stream()
    if pinned:
        src, stream = src.pin_memory(), torch.cuda.Stream()
    times = []
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        with torch.cuda.stream(stream):
            start.record(stream)
            src.to("cuda", non_blocking=pinned)
            end.record(stream)
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def max_diffs(torch, a, b):
    """(the largest |difference| of the two models' parameters, of their
    buffers)."""
    with torch.no_grad():
        return tuple(max((float((u[k].float() - v[k].float()).abs().max())
                          for k in u), default=0.0)
                     for u, v in ((a.params, b.params), (a.state, b.state)))


def phase_fit_resnet(torch, dtt, mods, batch=RESNET_BATCH, size=224):
    """t2: ResNet-50 (bf16, SGD(0.1, momentum=0.9), SingleDevice): K=4
    against K=1 from the same start (parameters and BatchNorm buffers,
    cuDNN's deterministic algorithms); K=4 fed by a Pipeline of uint8
    images with prefetch=2, against the K=1 loop on a float array with
    inline staging, in interleaved runs; K=4 on the float array (the
    graphs without the Pipeline's host cost); and the Pipeline staged by
    next() and np.stack (fit's path for other iterators) against
    next_k(out=) into the pinned buffers."""
    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, (2 * batch, size, size, 3), dtype=np.uint8)
    labels = rng.integers(0, 1000, 2 * batch).astype(np.int32)
    x2 = images.astype(np.float32) / 255.0
    xf, yf = x2[:batch], labels[:batch]
    pipe = dtt.data.Pipeline(images, labels, batch_size=batch, seed=0)

    def resnet(**kw):
        m = dtt.Model(dtt.models.resnet(50, 1000, dtype="bfloat16"))
        m.compile(optimizer=dtt.optim.SGD(0.1, momentum=0.9),
                  loss="sparse_categorical_crossentropy", **kw)
        return m.build((size, size, 3), seed=0)

    cudnn = torch.backends.cudnn
    deterministic, cudnn.deterministic = cudnn.deterministic, True
    try:
        pair = [resnet(), resnet(steps_per_execution=4)]
        same = [m.fit(x2, labels, batch_size=batch, epochs=1,
                      steps_per_epoch=4, shuffle=False, verbose=0,
                      prefetch=0).history["loss"] for m in pair]
        pdiff, sdiff = max_diffs(torch, *pair)
    finally:
        cudnn.deterministic = deterministic
    print(f"  K=4 against K=1 from the same start, 4 steps on 2 batches "
          f"(deterministic cuDNN): loss {same[1]} against {same[0]}; "
          f"parameters differ by {pdiff}, BN buffers by {sdiff}")
    if pdiff or sdiff:
        raise SystemExit("ResNet-50 K=4 differs from K=1 from the same "
                         "start")
    del pair
    torch.cuda.empty_cache()

    loop, fused = resnet(), resnet(steps_per_execution=4)

    def run_loop(steps=4):
        return loop.fit(xf, yf, batch_size=batch, epochs=1,
                        steps_per_epoch=steps, shuffle=False, verbose=0,
                        prefetch=0).history["loss"]

    def run_fused(steps=4):
        return fused.fit(pipe, epochs=1, steps_per_epoch=steps, verbose=0,
                         prefetch=2).history["loss"]

    def by_next(source, k, stacked, accum_m):
        pairs = [next(source) for _ in range(k)]
        return fused._stage_batch(
            {"x": np.stack([p[0] for p in pairs]),
             "y": np.stack([p[1] for p in pairs])}, stacked, accum_m, True)

    def run_fused_next(steps):
        fused._stage_pipeline = by_next
        try:
            return run_fused(steps)
        finally:
            del fused._stage_pipeline

    run_loop(2)
    reset_counts(mods)
    run_fused(4)  # captures the step's graph
    captured = launch_counts(mods)
    per_call = mods[1].LAUNCHES_PER_CALL
    per_step = {"conv1x1": 72, "bn_stats": 53 * per_call,
                "bn_bwd_reduce": 53 * per_call}
    reset_counts(mods)
    losses = []
    runs = kernel_runs(torch, lambda: losses.extend(run_fused(8)),
                       per_step)  # replays only
    counted = launch_counts(mods)
    tel = fused.last_fit_telemetry
    buffers = all(bool(torch.isfinite(b).all()) for b in fused.state.values())
    print(f"  K=4 + Pipeline (prefetch=2): launches in the fit that "
          f"captured {captured}; 8 replayed steps: loss {losses}, kernels "
          f"run (profiler trace) {runs}, the wrappers' counts {counted}, BN "
          f"buffers finite {buffers}, input_wait "
          f"{tel['input_wait_fraction']:.2%} of {tel['total_seconds']:.3f} s")
    want = {k: 2 * v for k, v in per_step.items()}
    if captured != want:
        raise SystemExit(f"the capturing fit launched {captured}, expected "
                         f"{want}")
    want = {k: 8 * v for k, v in per_step.items()}
    if runs != want:
        raise SystemExit(f"8 replayed steps ran {runs}, expected {want}")
    if any(counted.values()):
        raise SystemExit(f"an eager launch in the replayed steps: {counted}")
    if not (np.all(np.isfinite(losses)) and buffers):
        raise SystemExit("ResNet-50 K=4 losses or BN buffers not finite")

    def run_fused_arrays(steps=4):
        return fused.fit(xf, yf, batch_size=batch, epochs=1,
                         steps_per_epoch=steps, shuffle=False, verbose=0,
                         prefetch=2).history["loss"]

    # Runs of 8 steps: at K=4 the prefetch thread stages dispatch 2 while
    # 1 runs (a fit of one dispatch stages it inline); two runs an arm.
    arms = {"K=1 loop (arrays, inline staging)": (lambda: run_loop(8), 8),
            "K=4 + Pipeline, prefetch=2": (lambda: run_fused(8), 8),
            "K=4 + Pipeline by next() and np.stack, prefetch=2":
                (lambda: run_fused_next(8), 8),
            "K=4, arrays, prefetch=2": (lambda: run_fused_arrays(8), 8)}
    timing = report_arms(torch, arms, interleaved(torch, arms, 2))
    copies = {}
    stacked = np.stack([xf] * 4)
    for name, a in (("batch", xf), ("K=4 stack", stacked)):
        for pinned in (False, True):
            copies[(name, pinned)] = h2d_ms(torch, a, pinned)
        mb = a.nbytes / 1e6
        print(f"  host-to-device copy of the {name} ({mb:.1f} MB): pageable "
              f"{copies[(name, False)]:.3f} ms, pinned on the side stream "
              f"{copies[(name, True)]:.3f} ms (device clock)")
    del loop, fused, stacked
    torch.cuda.empty_cache()
    return captured, runs, timing, copies


def phase_fit_mnist(torch, dtt):
    """t2b: mnist_cnn (phase k's configuration: a world-1 DataParallel
    group, formed in-process) at K=8 against K=1, both on cuDNN's
    deterministic algorithms (the parameters must agree bit for bit)."""
    cudnn = torch.backends.cudnn
    deterministic, cudnn.deterministic = cudnn.deterministic, True
    try:
        return fit_mnist(torch, dtt)
    finally:
        cudnn.deterministic = deterministic
        dtt.cluster.shutdown()


def fit_mnist(torch, dtt, batch=256, steps=32):
    strategy = dtt.DataParallel()
    x, y = dtt.data.synthetic_images(batch, (28, 28), 10, 0)
    x = x[..., None].astype(np.float32) / 255.0

    def mnist(**kw):
        with strategy.scope():
            m = dtt.Model(dtt.models.mnist_cnn())
            m.compile(optimizer=dtt.optim.SGD(0.001),
                      loss="sparse_categorical_crossentropy",
                      metrics=["accuracy"], **kw)
        return m.build((28, 28, 1), seed=0)

    one, eight = mnist(), mnist(steps_per_execution=8)

    def run(m):
        return lambda: m.fit(x, y, batch_size=batch, epochs=1,
                             steps_per_epoch=steps, shuffle=False, verbose=0)

    ref, got = (m.fit(x, y, batch_size=batch, epochs=1, steps_per_epoch=16,
                      shuffle=False, verbose=0).history["loss"]
                for m in (one, eight))
    pdiff, _ = max_diffs(torch, one, eight)
    print(f"  16 steps from the same start: K=8 loss "
          f"{got[0]!r}, K=1 {ref[0]!r} "
          f"({'bit-identical' if got == ref else 'differ'}); parameters "
          f"{'bit-identical' if pdiff == 0 else f'differ by {pdiff}'}")
    if not np.allclose(got, ref, rtol=TOL["float32"]):
        raise SystemExit("mnist_cnn K=8 losses differ from K=1")
    if pdiff != 0:
        raise SystemExit("mnist_cnn K=8 parameters differ from K=1's")
    arms = {"K=1": (run(one), steps), "K=8": (run(eight), steps)}
    return report_arms(torch, arms, interleaved(torch, arms, 3))


def phase_generate(torch, dtt, n=8, t_p=128, new=128):
    """t3: Model.generate at GPT-2-small width in f32, against the Engine's
    greedy tokens for the same prompts and weights; tokens/s; a sampled
    run's tokens in range."""
    m = dtt.Model(dtt.models.transformer_lm(VOCAB, **LM)).build(
        (LM["max_len"],), seed=0)
    prompts = np.random.default_rng(5).integers(0, VOCAB, (n, t_p)).astype(
        np.int32)
    m.generate(prompts[:, :4], 2, temperature=0.0)  # warm-up
    t = time.perf_counter()
    greedy = m.generate(prompts, new, temperature=0.0)
    wall = time.perf_counter() - t
    reqs = [(p, new) for p in prompts]
    outs, _, _ = serve(dtt, m, reqs, decode_kernel="fused")
    share, first = agreement(list(greedy), outs, reqs)
    sampled = m.generate(prompts, new, temperature=0.8, top_k=40, seed=1)
    in_range = bool(sampled.min() >= 0 and sampled.max() < VOCAB)
    print(f"  greedy: {n} x ({t_p} + {new}) tokens in {wall:.3f} s, "
          f"{n * new / wall:.1f} tokens/s; agreement with the Engine's "
          f"greedy tokens {share:.4f} (first tokens "
          f"{'match' if first else 'DIFFER'}); sampled (0.8, top_k 40): "
          f"shape {sampled.shape}, tokens in range {in_range}")
    if greedy.shape != (n, t_p + new) or not in_range or not np.array_equal(
            greedy[:, :t_p], prompts):
        raise SystemExit("generate returned bad tokens")
    if not first:
        raise SystemExit("generate's first tokens differ from the Engine's")
    del m
    torch.cuda.empty_cache()
    return n * new / wall, share


# ------------------------------------------------------------------ phase u
REMAT_POLICY = "dots_with_no_batch_dims_saveable"
PALLAS = "pallas_sparse_categorical_crossentropy"


def flash_per_step(flash_ops, steps):
    return {k: v / steps for k, v in flash_ops.launches.items()}


def lm_run(torch, dtt, mods, x, y, batch, steps, t_len, *, remat=False,
           head_chunks=None, dtype="bfloat16", precision=None,
           optimizer=None, k=None, metrics=(), tag="", busy=False):
    """Build ``bench_longctx``'s LM at ``t_len`` (seed 0), fit one warm-up
    step, then ``steps`` timed steps on the same batch with the launch
    counts zeroed just before and read just after. The peak is the run's
    own: the allocator's peak from the build on, less what was allocated
    before it. ``busy``: then one more step under the profiler, whose
    device ms (the union of the trace's ranges) is printed beside the
    timed step's. Returns (model, losses, ms a step, peak GB,
    launches)."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    model = dtt.Model(dtt.models.transformer_lm(
        VOCAB, dtype=dtype, remat=remat,
        remat_policy=REMAT_POLICY if remat else None,
        **dict(LM, max_len=t_len)))
    model.compile(optimizer=optimizer or dtt.optim.Adam(1e-4), loss=PALLAS,
                  metrics=list(metrics), head_chunks=head_chunks,
                  precision=precision, steps_per_execution=k)
    model.build((t_len,), seed=0)
    fit = dict(batch_size=batch, steps_per_epoch=1, shuffle=False,
               verbose=0)
    losses = model.fit(x, y, epochs=1, **fit).history["loss"]
    reset_counts(mods)
    torch.cuda.synchronize()
    t = time.perf_counter()
    losses += model.fit(x, y, epochs=steps, **fit).history["loss"]
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t) / steps
    peak = (torch.cuda.max_memory_allocated() - base) / 1e9
    counts = launch_counts(mods)
    print(f"  {tag}: losses {[round(v, 5) for v in losses]}, {ms:.1f} ms a "
          f"step, peak memory {peak:.2f} GB, launches a step "
          f"{ {n: c / steps for n, c in counts.items() if c} }")
    if busy:
        dev, n = busy_ms(torch, lambda: model.fit(x, y, epochs=1, **fit))
        print(f"    device work {dev:.1f} ms in {n} operations a step: "
              f"{dev / ms:.1%} of the timed step")
    if not all(np.isfinite(losses)):
        raise SystemExit(f"{tag}: losses not finite: {losses}")
    return model, losses, ms, peak, counts


def same_params(a, b):
    """Paths whose parameters differ in any bit between two models."""
    pa, pb = a.params, b.params
    return [n for n in pa if not bool((pa[n] == pb[n]).all())]


def mfu_of(ms, tokens, t_len):
    fwd = lm_fwd_flops_per_token(LM["num_layers"], LM["d_model"], t_len,
                                 VOCAB)
    return 3 * fwd * tokens / (ms / 1e3) / PEAK_FLOPS["bfloat16"]


def phase_longctx(torch, dtt, mods):
    """u1: bench_longctx's LM (vocab 32768, 12 layers, d 768, bf16 layers,
    Adam(1e-4), the pallas loss): (a) remat against none at 2 x 4096, (b)
    head_chunks=8 against none at 2 x 4096, (c) 1 x 65,536 with both.
    Returns the (c) run's launches."""
    steps = 2
    x, y = lm_batch(2, 4096)
    tokens = x.size
    plain, l_plain, ms_plain, pk_plain, c_plain = lm_run(
        torch, dtt, mods, x, y, 2, steps, 4096, tag="2x4096", busy=True)
    remat, l_remat, ms_remat, pk_remat, c_remat = lm_run(
        torch, dtt, mods, x, y, 2, steps, 4096, remat=True,
        tag=f"2x4096 remat ({REMAT_POLICY})", busy=True)
    n = LM["num_layers"]
    for tag, c, fwd in (("plain", c_plain, n), ("remat", c_remat, 2 * n)):
        got = {k: c[k] / steps for k in ("flash_fwd", "flash_dq",
                                         "flash_dkv")}
        if got != {"flash_fwd": fwd, "flash_dq": n, "flash_dkv": n}:
            raise SystemExit(f"u1(a) {tag}: flash launches a step {got}")
    diff = same_params(plain, remat)
    print(f"  (a) remat: {ms_remat / ms_plain:.3f}x the step time, peak "
          f"{pk_remat:.2f} GB against {pk_plain:.2f} GB; parameters after "
          f"{1 + steps} steps bit-identical: {not diff}")
    if diff or l_plain != l_remat:
        raise SystemExit(f"u1(a): remat changed the result ({len(diff)} "
                         f"leaves differ; losses {l_plain} vs {l_remat})")
    del remat
    # Selective checkpointing intercepts every operator on the host; a
    # step captured as a CUDA graph (K=2) replays without that cost.
    graphed, _, ms_graph, _, _ = lm_run(
        torch, dtt, mods, x, y, 2, steps, 4096, remat=True, k=2,
        tag="2x4096 remat, steps_per_execution=2 (CUDA graphs)", busy=True)
    diff = same_params(plain, graphed)
    print(f"  (a) remat as CUDA graphs: {ms_graph / ms_plain:.3f}x the eager "
          f"plain step time; parameters bit-identical: {not diff}")
    if diff:
        raise SystemExit(f"u1(a): remat under graphs differs ({len(diff)})")
    del graphed
    chunk, l_chunk, ms_chunk, pk_chunk, c_chunk = lm_run(
        torch, dtt, mods, x, y, 2, steps, 4096, head_chunks=8,
        tag="2x4096 head_chunks=8", busy=True)
    logits_gb = tokens * VOCAB * 2 / 1e9
    drop = pk_plain - pk_chunk
    rel = max(abs(a - b) / abs(b) for a, b in zip(l_chunk, l_plain))
    print(f"  (b) head_chunks=8: peak {pk_chunk:.2f} GB against "
          f"{pk_plain:.2f} GB, a drop of {drop:.2f} GB = {drop / logits_gb:.2f}"
          f" x the bf16 (tokens x vocab) logits ({logits_gb:.3f} GB); "
          f"losses within {rel:.2e} (rtol {TOL['bfloat16']}); "
          f"{ms_chunk / ms_plain:.3f}x the step time")
    xent = {k: c_chunk[k] / steps for k in ("xent_fwd", "xent_bwd")}
    if xent != {"xent_fwd": 8, "xent_bwd": 8}:
        raise SystemExit(f"u1(b): K9/K10 launches a step {xent}, expected 8")
    if rel > TOL["bfloat16"] or drop < logits_gb:
        raise SystemExit(f"u1(b): losses off by {rel:.2e} or the peak fell "
                         f"by {drop:.2f} GB only")
    del plain, chunk
    torch.cuda.empty_cache()
    rows = [(1, 65536, 8), (1, 8192, None), (1, 16384, None)]
    out = None
    for batch, t_len, hc in rows:
        xb, yb = lm_batch(batch, t_len)
        model, losses, ms, peak, counts = lm_run(
            torch, dtt, mods, xb, yb, batch, steps, t_len, remat=True,
            head_chunks=hc, tag=f"{batch}x{t_len} remat"
            + (f" head_chunks={hc}" if hc else ""))
        tps = batch * t_len / (ms / 1e3)
        print(f"  (c) {batch} x {t_len}: {tps:.0f} tokens/s, MFU "
              f"{mfu_of(ms, batch * t_len, t_len):.4f} (3 x _lm_fwd_flops_"
              f"per_token at 989 TFLOP/s), peak {peak:.2f} GB")
        if out is None:
            out = counts
        del model
        torch.cuda.empty_cache()
    return out


def phase_precision(torch, dtt, mods, flash_ops, batch=32, steps=2):
    """u2: phase h's LM with no dtype= on its layers, fused_adam(1e-4)
    (K11 over the f32 masters), under no policy, mixed_bfloat16 and
    mixed_float16; a forced non-finite step; K=4 graphs against K=1 under
    mixed_float16. Returns the f16 run's launches."""
    t_len = LM["max_len"]
    x, y = lm_batch(batch, t_len)
    runs = {}
    for pol in (None, "mixed_bfloat16", "mixed_float16"):
        model, losses, ms, peak, counts = lm_run(
            torch, dtt, mods, x, y, batch, steps, t_len, dtype=None,
            precision=pol, optimizer=dtt.optim.fused_adam(1e-4),
            metrics=["accuracy"], tag=f"precision={pol}")
        dtypes = {k: v / steps for k, v in flash_ops.dtype_launches.items()
                  if v}
        routes = {k: v / steps for k, v in flash_ops.route_launches.items()
                  if v}
        scale = dtt.optim.loss_scale_value(model.opt_state)
        print(f"    {ms:.1f} ms a step, MFU "
              f"{mfu_of(ms, batch * t_len, t_len):.4f}; flash launches a "
              f"step by dtype {dtypes}, by route {routes}; loss scale "
              f"{None if scale is None else float(scale)}")
        runs[pol] = (model, losses, counts)
        if pol == "mixed_float16":
            n = LM["num_layers"]
            want = {f"{k}/float16": n for k in ("flash_fwd", "flash_dq",
                                                 "flash_dkv")}
            want_r = {f"{k}/wgmma": n for k in ("flash_fwd", "flash_dq",
                                                 "flash_dkv")}
            if dtypes != want or routes != want_r:
                raise SystemExit(f"u2: f16 flash launches {dtypes} "
                                 f"{routes}, expected {want} {want_r}")
            # 2^15, halved once for each step skipped (Adam's count stays).
            skipped = 1 + steps - model.opt_state.inner_state["count"]
            if float(scale) != 2.0 ** (15 - skipped):
                raise SystemExit(f"u2: loss scale {float(scale)} after "
                                 f"{skipped} skipped steps")
        if pol is not None:
            base = runs[None][1]
            rel = max(abs(a - b) / abs(b) for a, b in zip(losses, base))
            print(f"    losses against the policy-free f32 run: within "
                  f"{rel:.2e} (rtol {TOL['bfloat16']})")
            if rel > TOL["bfloat16"]:
                raise SystemExit(f"u2: {pol} losses off by {rel:.2e}")
        if pol != "mixed_float16":
            del model
            runs[pol] = (None, losses, counts)
        torch.cuda.empty_cache()
    f16, _, f16_counts = runs.pop("mixed_float16")
    # A forced non-finite step: a scale of 2^60 overflows the f16
    # gradients; the step must leave the parameters and moments as they
    # were and halve the scale.
    state = f16.opt_state
    state.scale.fill_(2.0 ** 60)
    before = [t.clone() for t in f16._param_list()]
    inner = state.inner_state
    moments = [t.clone() for t in inner["mu"] + inner["nu"]]
    count = inner["count"]
    hist = f16.fit(x, y, batch_size=batch, epochs=1, steps_per_epoch=1,
                   shuffle=False, verbose=0)
    kept = all(bool((a == b).all()) for a, b in
               zip(before + moments,
                   f16._param_list() + inner["mu"] + inner["nu"]))
    print(f"  forced overflow (scale 2^60): loss {hist.history['loss'][0]:.5f}"
          f", parameters and moments unchanged: {kept}, Adam count "
          f"{inner['count']} (was {count}), scale now 2^"
          f"{math.log2(float(state.scale)):g}")
    if not kept or inner["count"] != count or float(state.scale) != 2.0 ** 59:
        raise SystemExit("u2: the non-finite step was not skipped exactly")
    del f16, runs
    torch.cuda.empty_cache()
    # K=4 as CUDA graphs against K=1, mixed_float16, 8 steps.
    xs, ys = lm_rows(8 * batch, t_len)
    done = {}
    for k in (1, 4):
        model = dtt.Model(dtt.models.transformer_lm(VOCAB, **LM))
        model.compile(optimizer=dtt.optim.fused_adam(1e-4), loss=PALLAS,
                      metrics=["accuracy"], precision="mixed_float16",
                      steps_per_execution=k)
        model.build((t_len,), seed=0)
        hist = model.fit(xs, ys, batch_size=batch, epochs=1,
                         steps_per_epoch=8, shuffle=False, verbose=0)
        done[k] = (model, hist.history["loss"][0],
                   float(model.opt_state.scale))
    diff = same_params(done[1][0], done[4][0])
    print(f"  mixed_float16, 8 steps: K=4 (CUDA graphs) against K=1: epoch "
          f"loss {done[4][1]:.6f} vs {done[1][1]:.6f}, scale {done[4][2]} vs "
          f"{done[1][2]}, parameters bit-identical: {not diff}")
    if diff or done[4][2] != done[1][2]:
        raise SystemExit(f"u2: K=4 differs from K=1 ({len(diff)} leaves)")
    del done
    torch.cuda.empty_cache()
    return f16_counts


def phase_quant_serve(torch, dtt, paged_ops, reqs, fused_c):
    """u3: phase c's GPT-2-small quantized to int8 weights, served with
    the fused decode (K1) against phase c's unquantized tokens; the
    snapshot's bytes; update_weights' dtype checks. Returns K1's
    launches."""
    model = dtt.Model(dtt.models.transformer_lm(
        VOCAB, dtype="bfloat16", **LM))
    model.build((LM["max_len"],), seed=0)
    before = sum(t.numel() * t.element_size() for t in model.params.values())
    dtt.quant.quantize_model(model)
    serve(dtt, model, requests(2, (8, 16), (4, 4), seed=1))  # warm-up
    paged_ops.reset_launch_counts()
    engine = dtt.serving.Engine(model, max_slots=8, block_size=16,
                                max_len=LM["max_len"], decode_kernel="fused")
    t = time.perf_counter()
    outs = engine.run([dtt.serving.Request(p, m) for p, m in reqs])
    wall = time.perf_counter() - t
    launches = dict(paged_ops.launches)
    tel = engine.last_run_telemetry
    report("int8 weights", tel, wall)
    check_outputs(outs, reqs, VOCAB)
    if launches["paged_attention"] != tel["decode_steps"] * LM["num_layers"]:
        raise SystemExit(f"u3: K1 launches {launches}")
    share, first = agreement(outs, fused_c, reqs)
    after = snapshot_bytes(engine._target)
    print(f"  int8 weights vs phase c's bf16-layer model: token agreement "
          f"{share:.4f}, first tokens {'all' if first else 'not all'} "
          f"equal; snapshot {after / 1e6:.1f} MB against {before / 1e6:.1f} "
          f"MB unquantized ({before / after:.3f}x); K1 launches "
          f"{launches['paged_attention']}")
    engine.update_weights(dict(model.params))
    bad = {k: (v.to(torch.float32) if v.dtype == torch.int8 else v)
           for k, v in model.params.items()}
    try:
        engine.update_weights(bad)
    except ValueError as e:
        print(f"  update_weights: the quantized tree swaps in; f32 leaves "
              f"raise ({str(e)[:70]}...)")
    else:
        raise SystemExit("u3: update_weights took f32 leaves for int8 ones")
    del engine, model
    torch.cuda.empty_cache()
    return launches["paged_attention"]


# ------------------------------------------------------------- phase v
def restack_blocks(tree, num_layers):
    """An unrolled LM's or ViT's ``{path: tensor}`` tree as its
    ``scan=True`` twin's: ``residual_{2i}``/``residual_{2i+1}`` stacked
    into ``scanned_blocks/blocks/residual`` and ``.../residual_1``."""
    import torch

    out, per = {}, {}
    for path, t in tree.items():
        head, _, rest = path.partition("/")
        if not head.startswith("residual"):
            out[path] = t
            continue
        i = 0 if head == "residual" else int(head.split("_")[1])
        slot = "residual" if i % 2 == 0 else "residual_1"
        per.setdefault(f"scanned_blocks/blocks/{slot}/{rest}", {})[
            i // 2] = t
    for path, d in per.items():
        out[path] = torch.stack([d[i] for i in range(num_layers)])
    return out


def restack_resnet(tree, blocks=(3, 4, 6, 3)):
    """An unrolled ResNet's tree as ``scan_stages=True``'s: stage s's first
    block ``residual_{first}`` becomes ``residual_{s}`` and its tail blocks
    stack into ``scanned_blocks_{s}/blocks``."""
    import torch

    def name(base, i):
        return base if i == 0 else f"{base}_{i}"

    out, per, first = {}, {}, 0
    where = {}
    for s, n in enumerate(blocks):
        where[first] = (name("residual", s), None)
        for j in range(1, n):
            where[first + j] = (name("scanned_blocks", s) + "/blocks", j - 1)
        first += n
    for path, t in tree.items():
        head, _, rest = path.partition("/")
        if not head.startswith("residual"):
            out[path] = t
            continue
        i = 0 if head == "residual" else int(head.split("_")[1])
        new, j = where[i]
        if j is None:
            out[f"{new}/{rest}"] = t
        else:
            per.setdefault(f"{new}/{rest}", {})[j] = t
    for path, d in per.items():
        out[path] = torch.stack([d[j] for j in range(len(d))])
    return out


def first_difference(torch, a, b):
    """(path, largest |difference|) of the first leaf, in ``a``'s order,
    where two ``{path: tensor}`` trees differ in any bit; None when none
    does."""
    with torch.no_grad():
        for path, t in a.items():
            u = b[path]
            if not torch.equal(t, u):
                return path, float((t.float() - u.float()).abs().max())
    return None


def say_same(tag, diff):
    print(f"  {tag}: " + ("bit-identical" if diff is None else
                          f"first difference at {diff[0]}, largest "
                          f"|difference| {diff[1]:.3e}"))


def phase_scan_lm(torch, dtt, mods, paged_ops, reqs, batch=32, steps=3):
    """v1 and v2: bench_transformer_lm's LM (GPT-2-small width, bf16
    layers, Adam(1e-4), the pallas loss, batch 32 x 1024), scan=True
    against the unrolled LM given the same parameters restacked: 3 eager
    steps, timed in interleaved pairs; parameter tensors and the
    optimizer's launches a step; then both served (v2), and scan=True
    with remat at K=2 graphs against eager. Returns the scanned runs'
    launches."""
    t_len, layers = LM["max_len"], LM["num_layers"]
    x, y = lm_batch(batch, t_len)
    fit = dict(batch_size=batch, steps_per_epoch=1, shuffle=False,
               verbose=0)

    def make(scan, k=None, **kw):
        m = dtt.Model(dtt.models.transformer_lm(
            VOCAB, dtype="bfloat16", scan=scan, **kw, **LM))
        m.compile(optimizer=dtt.optim.Adam(1e-4), loss=PALLAS,
                  metrics=["accuracy"], steps_per_execution=k)
        return m.build((t_len,), seed=0)

    un, sc = make(False), make(True)
    sc.load_params(restack_blocks(un.params, layers))
    reset_counts(mods)
    lu = un.fit(x, y, epochs=steps, **fit).history["loss"]
    cu = launch_counts(mods)
    reset_counts(mods)
    ls = sc.fit(x, y, epochs=steps, **fit).history["loss"]
    counts = launch_counts(mods)
    print(f"  losses unrolled {lu}, scanned {ls}")
    diff = first_difference(torch, restack_blocks(un.params, layers),
                            sc.params)
    say_same(f"parameters after {steps} eager steps, scanned against "
             "unrolled", diff)
    per_step = {n: c / steps for n, c in counts.items() if c}
    print(f"  launches a step: scanned {per_step}, unrolled "
          f"{ {n: c / steps for n, c in cu.items() if c} }")
    want = {"xent_fwd": 1, "xent_bwd": 1, "flash_fwd": layers,
            "flash_dq": layers, "flash_dkv": layers}
    if per_step != want or cu != counts:
        raise SystemExit(f"v1: launches a step {per_step}, expected {want}")
    if diff is not None and diff[1] > TOL["bfloat16"]:
        raise SystemExit("v1: scanned and unrolled parameters part")
    arms = {"unrolled": (lambda: un.fit(x, y, epochs=2, **fit), 2),
            "scanned": (lambda: sc.fit(x, y, epochs=2, **fit), 2)}
    report_arms(torch, arms, interleaved(torch, arms, 3))

    grads = {}
    for tag, m in (("unrolled", un), ("scanned", sc)):
        ps = m._param_list()
        grads[tag] = [torch.zeros_like(p) for p in ps]
    print(f"  parameter tensors: unrolled {len(un.params)}, scanned "
          f"{len(sc.params)}")

    print("phase v2: the scanned LM served against the unrolled one, "
          "Engine(8 slots, block 16), fused, prefix cache")
    sc.load_params(restack_blocks(un.params, layers))
    # A 256-token prompt (16 whole blocks) first and again last: the last
    # adopts its cached blocks and copies the 16th on write. Between them
    # the first half of phase c's requests.
    head = np.random.default_rng(7).integers(0, VOCAB, t_len // 4).astype(
        np.int32)
    vreqs = [(head, 32)] + list(reqs[:len(reqs) // 2]) + [(head.copy(), 40)]
    for kv in (None, "int8"):
        outs = {}
        for tag, m in (("unrolled", un), ("scanned", sc)):
            paged_ops.reset_launch_counts()
            eng = dtt.serving.Engine(m, max_slots=8, block_size=16,
                                     max_len=t_len, decode_kernel="fused",
                                     prefix_cache=True, kv_dtype=kv)
            t = time.perf_counter()
            outs[tag] = eng.run([dtt.serving.Request(p, n)
                                 for p, n in vreqs])
            wall = time.perf_counter() - t
            tel = eng.last_run_telemetry
            key = "paged_attention_int8" if kv else "paged_attention"
            launched = paged_ops.launches[key]
            report(f"{tag} {kv or 'bf16'} KV", tel, wall)
            print(f"    {key} {launched / tel['decode_steps']:.1f} launches "
                  f"a decode step, by read path "
                  f"{dict(paged_ops.launches_by_path)}, copy-on-write "
                  f"{eng.kv.cow_copies}")
            if tag == "scanned":
                counts[key] = counts.get(key, 0) + launched
                pool = eng.kv.caches["scanned_blocks"]["stacked"][
                    "residual"]["main"]["multi_head_attention"]["k"]
                pool = pool["q"] if isinstance(pool, dict) else pool
                row = pool.shape[-1] * pool.element_size()
                paths = ["vector" if pool[i].data_ptr() % 16 == 0
                         and row % 16 == 0 else "scalar"
                         for i in range(layers)]
                print(f"    the read path of each block's pool slice: "
                      f"{paths}")
                if (eng.kv.cow_copies == 0 or launched
                        != tel["decode_steps"] * layers
                        or ("scalar" in {p for _, p in
                                         paged_ops.launches_by_path})):
                    raise SystemExit("v2: no copy-on-write, or K1/K2 not "
                                     "once a layer and step on the vector "
                                     "path")
            check_outputs(outs[tag], vreqs, VOCAB)
            del eng
        exact = all(np.array_equal(a, b)
                    for a, b in zip(outs["unrolled"], outs["scanned"]))
        print(f"  {kv or 'bf16'} KV: scanned token-exact against unrolled: "
              f"{exact}")
        if not exact:
            raise SystemExit(f"v2: scanned serving differs ({kv} KV)")
        if kv is None:
            plain = outs["scanned"]
    # In bf16 a verify's K rows round apart from K one-row decodes (other
    # GEMM shapes), so greedy speculative tokens may part from plain ones
    # at a near-tie; the scanned LM's must equal the unrolled LM's.
    spec_outs = {}
    for tag, m in (("unrolled", un), ("scanned", sc)):
        paged_ops.reset_launch_counts()
        spec = dtt.serving.Engine(m, max_slots=8, block_size=16,
                                  max_len=t_len, decode_kernel="fused",
                                  draft_model=m, spec_k=4)
        t = time.perf_counter()
        spec_outs[tag] = spec.run([dtt.serving.Request(p, n)
                                   for p, n in vreqs])
        wall = time.perf_counter() - t
        tel = spec.last_run_telemetry
        share, _ = agreement(spec_outs[tag], plain, vreqs)
        print(f"  {tag} spec_k 4, self-draft: {tel['generated_tokens']} "
              f"tokens in {wall:.3f} s, accept rate "
              f"{tel['speculative']['accept_rate']}, launches by kw "
              f"{launches_by_kw(paged_ops)}; token agreement with the "
              f"scanned plain run {share:.4f}")
        if tag == "scanned":
            counts["paged_attention"] += paged_ops.launches["paged_attention"]
        del spec
    exact = all(np.array_equal(a, b) for a, b in zip(spec_outs["unrolled"],
                                                     spec_outs["scanned"]))
    print(f"  speculative: scanned token-exact against unrolled: {exact}")
    if not exact:
        raise SystemExit("v2: speculative scanned serving differs")

    for tag, m in (("unrolled", un), ("scanned", sc)):
        ps = m._param_list()
        ops = device_trace(torch, lambda: m.tx.update(ps, grads[tag],
                                                      m.opt_state))
        print(f"  {tag}: the optimizer's update is {len(ops)} device "
              f"operations a step over {len(ps)} parameter tensors")
    del un, sc, grads
    torch.cuda.empty_cache()

    print("  scan=True, remat=True, remat_policy=dots_with_no_batch_dims_"
          "saveable: K=2 graphs against K=1 eager, 4 steps")
    eager = make(True, remat=True, remat_policy=REMAT_POLICY)
    eager.fit(x, y, epochs=4, **fit)
    params_eager = {k: v.clone() for k, v in eager.params.items()}
    del eager
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    graph = make(True, k=2, remat=True, remat_policy=REMAT_POLICY)
    reset_counts(mods)
    graph.fit(x, y, epochs=1, batch_size=batch, steps_per_epoch=4,
              shuffle=False, verbose=0)
    for n, c in launch_counts(mods).items():
        counts[n] = counts.get(n, 0) + c
    diff = first_difference(torch, params_eager, graph.params)
    say_same("remat K=2 graphs against K=1 eager", diff)
    ms = 1e3 * wall_s(torch, lambda: graph.fit(
        x, y, epochs=1, batch_size=batch, steps_per_epoch=4, shuffle=False,
        verbose=0)) / 4
    peak = (torch.cuda.max_memory_allocated() - base) / 1e9
    print(f"  remat K=2: {ms:.1f} ms a step, MFU "
          f"{mfu_of(ms, batch * t_len, t_len):.4f}, peak memory {peak:.2f} GB")
    if diff is not None:
        raise SystemExit("v1: remat graphs differ from eager")
    del graph, params_eager
    torch.cuda.empty_cache()
    return counts


def phase_scan_resnet(torch, dtt, mods, batch=RESNET_BATCH, size=224,
                      steps=3):
    """v3: ResNet-50 (bf16, SGD(0.1, momentum=0.9), SingleDevice) with
    scan_stages=True against the unrolled ResNet-50 given the same
    parameters and BatchNorm state restacked, cuDNN deterministic: losses,
    parameters and buffers after 3 steps, ms a step, K12-K14 launches."""
    x, y = resnet_batch(batch, size)
    fit = dict(batch_size=batch, steps_per_epoch=1, shuffle=False,
               verbose=0, prefetch=0)

    def make(**kw):
        m = dtt.Model(dtt.models.resnet(50, 1000, dtype="bfloat16", **kw))
        m.compile(optimizer=dtt.optim.SGD(0.1, momentum=0.9),
                  loss="sparse_categorical_crossentropy")
        return m.build((size, size, 3), seed=0)

    cudnn = torch.backends.cudnn
    deterministic, cudnn.deterministic = cudnn.deterministic, True
    try:
        un, sc = make(), make(scan_stages=True)
        sc.load_params(restack_resnet(un.params))
        sc.load_state(restack_resnet(un.state))
        lu = un.fit(x, y, epochs=steps, **fit).history["loss"]
        reset_counts(mods)
        ls = sc.fit(x, y, epochs=steps, **fit).history["loss"]
        counts = launch_counts(mods)
    finally:
        cudnn.deterministic = deterministic
    print(f"  losses unrolled {lu}, scanned {ls}")
    say_same("parameters", first_difference(
        torch, restack_resnet(un.params), sc.params))
    diff = first_difference(torch, restack_resnet(un.state), sc.state)
    say_same("BatchNorm buffers", diff)
    per_step = {n: c / steps for n, c in counts.items() if c}
    print(f"  launches a step {per_step}; parameter tensors unrolled "
          f"{len(un.params)}, scanned {len(sc.params)}")
    if per_step != {"conv1x1": 72, "bn_stats": 53, "bn_bwd_reduce": 53}:
        raise SystemExit(f"v3: K12/K13/K14 launches a step {per_step}")
    if not np.allclose(ls, lu, rtol=TOL["bfloat16"]):
        raise SystemExit("v3: scanned and unrolled losses part")
    arms = {"unrolled": (lambda: un.fit(x, y, epochs=2, **fit), 2),
            "scanned": (lambda: sc.fit(x, y, epochs=2, **fit), 2)}
    ms = interleaved(torch, arms, 2)
    for name, runs in ms.items():
        print(f"  {name}: ms a step {[round(v, 2) for v in runs]} (median "
              f"{float(np.median(runs)):.2f}), "
              f"{batch / float(np.median(runs)) * 1e3:.0f} images/s")
    del un, sc
    torch.cuda.empty_cache()
    return counts


def vit_fwd_flops(d, layers, tokens, patch, classes):
    """Matmul FLOPs of one ViT forward per image: the patch embedding
    (2 x patch^2 x 3 x d a token), per block qkv and the projection
    (8 d^2 a token), the MLP (16 d^2, d_ff = 4d) and attention's scores
    and values (4 x tokens x d a token), and the head (2 d classes)."""
    per_token = 2 * patch * patch * 3 * d + layers * (
        24 * d * d + 4 * tokens * d)
    return tokens * per_token + 2 * d * classes


def phase_scan_vit(torch, dtt, mods, xent_ops, batch=128, steps=2):
    """v4: K9/K10 at (128, 1000) against their plain versions, then
    vit_base(scan=True) (ViT-B/16, 224, bf16 layers, fused_adamw(1e-3),
    the pallas loss) on 128 seeded uint8 images against the unrolled
    ViT-B/16 restacked: parameters after 2 steps, images/s, peak memory,
    MFU."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(13)
    logits = (2 * torch.randn((batch, 1000), generator=g, device=dev)).to(
        torch.bfloat16)
    labels = torch.randint(0, 1000, (batch,), generator=g, device=dev)
    gout = torch.full((batch,), 1.0 / batch, device=dev)
    errf = max_err(xent_ops.xent_fwd(logits, labels),
                   xent_ops.xent_fwd_ref(logits, labels))
    want = xent_ops.xent_bwd_ref(logits, labels, gout).float()
    diff = (xent_ops.xent_bwd(logits, labels, gout).float() - want).abs()
    ulp = torch.exp2(torch.floor(torch.log2(want.abs().clamp_min(1e-30)))
                     - 7)
    worst = float((diff / ulp).max())
    print(f"  K9 at (128, 1000) bf16: max_abs_err {errf:.3e} (limit 1e-4); "
          f"K10: worst entry {worst:.2f} of its own bf16 ulp (limit 1)")
    if errf > 1e-4 or worst > 1:
        raise SystemExit("v4: K9/K10 disagree with their plain versions at "
                         "1,000 classes")
    rng = np.random.default_rng(0)
    x = rng.integers(0, 256, (batch, 224, 224, 3), dtype=np.uint8)
    y = rng.integers(0, 1000, (batch,)).astype(np.int32)
    fit = dict(batch_size=batch, steps_per_epoch=1, shuffle=False,
               verbose=0)

    def make(scan):
        m = dtt.Model(dtt.models.vit_base(1000, dtype="bfloat16",
                                          scan=scan))
        m.compile(optimizer=dtt.optim.fused_adamw(1e-3), loss=PALLAS,
                  metrics=["accuracy"])
        return m.build((224, 224, 3), seed=0)

    un, sc = make(False), make(True)
    sc.load_params(restack_blocks(un.params, 12))
    lu = un.fit(x, y, epochs=steps, **fit).history["loss"]
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(mods)
    ls = sc.fit(x, y, epochs=steps, **fit).history["loss"]
    counts = launch_counts(mods)
    peak = (torch.cuda.max_memory_allocated() - base) / 1e9
    print(f"  losses unrolled {lu}, scanned {ls}")
    diff = first_difference(torch, restack_blocks(un.params, 12), sc.params)
    say_same(f"parameters after {steps} steps, scanned against unrolled",
             diff)
    per_step = {n: c / steps for n, c in counts.items() if c}
    print(f"  launches a step {per_step}; parameter tensors unrolled "
          f"{len(un.params)}, scanned {len(sc.params)}")
    if per_step != {"xent_fwd": 1, "xent_bwd": 1, "fused_adam": 1}:
        raise SystemExit(f"v4: launches a step {per_step}")
    if diff is not None and diff[1] > TOL["bfloat16"]:
        raise SystemExit("v4: scanned and unrolled parameters part")
    arms = {"unrolled": (lambda: un.fit(x, y, epochs=2, **fit), 2),
            "scanned": (lambda: sc.fit(x, y, epochs=2, **fit), 2)}
    res = report_arms(torch, arms, interleaved(torch, arms, 3))
    flops = vit_fwd_flops(768, 12, 196, 16, 1000)
    for name, (ms, _) in res.items():
        ips = batch / (ms / 1e3)
        print(f"  {name}: {ips:.0f} images/s, MFU "
              f"{3 * flops * ips / PEAK_FLOPS['bfloat16']:.4f} (3 x "
              f"{flops / 1e9:.2f} GFLOP an image at 989 TFLOP/s)")
    print(f"  scanned peak memory {peak:.2f} GB")
    del un, sc
    torch.cuda.empty_cache()
    return counts


def phase_scan_dropout(torch, dtt, mods, batch=8, steps=8):
    """v5: a 2-block ScannedBlocks of GPT-2-small-width transformer blocks,
    each followed by Dropout(0.1), trained by fit: the mask drawn on the
    card against the CPU's, K=4 graphs against K=1 eager bit for bit."""
    threefry = dtt.utils.threefry
    key = threefry.fold_in(threefry.PRNGKey(1), 3)
    shape = (batch, LM["max_len"], LM["d_model"])
    card = threefry.bernoulli(threefry.device_key(key, "cuda"), 0.9, shape,
                              "cuda")
    cpu = threefry.bernoulli(key, 0.9, shape, "cpu")
    same = bool(torch.equal(card.cpu(), cpu))
    print(f"  mask of {card.numel()} elements on the card equals the CPU's: "
          f"{same}; kept {float(card.float().mean()):.5f} (keep 0.9)")
    if not same:
        raise SystemExit("v5: the card's dropout mask differs from the CPU's")
    nn = dtt.nn
    d, heads = LM["d_model"], LM["num_heads"]

    def make(k):
        blocks = nn.ScannedBlocks(lambda: nn.Sequential(
            dtt.models.transformer_block(d, heads, 4 * d, dtype="bfloat16")
            + [nn.Dropout(0.1)]), 2)
        module = nn.Sequential([
            nn.Embedding(VOCAB, d, dtype="bfloat16"),
            nn.PositionalEmbedding(LM["max_len"]), blocks, nn.LayerNorm(),
            nn.Dense(VOCAB, dtype="bfloat16")])
        m = dtt.Model(module)
        m.compile(optimizer=dtt.optim.Adam(1e-4), loss=PALLAS,
                  steps_per_execution=k)
        return m.build((LM["max_len"],), seed=0)

    x, y = lm_batch(batch, LM["max_len"])
    x = np.concatenate([x] * 2)
    y = np.concatenate([y] * 2)
    fit = dict(batch_size=batch, epochs=1, steps_per_epoch=steps,
               shuffle=True, seed=0, verbose=0)
    eager, graph = make(None), make(4)
    le = eager.fit(x, y, **fit).history["loss"]
    reset_counts(mods)
    lg = graph.fit(x, y, **fit).history["loss"]
    counts = launch_counts(mods)
    diff = first_difference(torch, eager.params, graph.params)
    print(f"  epoch loss K=1 {le}, K=4 {lg}")
    say_same(f"parameters after {steps} steps, K=4 graphs against K=1 eager",
             diff)
    if diff is not None:
        raise SystemExit("v5: dropout under graphs differs from eager")
    del eager, graph
    torch.cuda.empty_cache()
    return counts


# ------------------------------------------------------------------ phase w
def nccl_world1(dtt):
    """Phase k's NCCL group of world 1, from a one-worker DTPU_CONFIG."""
    port = dtt.cluster.free_port()
    os.environ["DTPU_CONFIG"] = dtt.cluster.ClusterSpec(
        workers=[f"127.0.0.1:{port}"], index=0).to_json()
    return dtt.cluster.initialize(timeout=120)


def full_state(dtt, model):
    """``{path: tensor}`` clones of a model's whole parameters and
    optimizer state (gathered where a strategy shards them), on the card
    (the optimizer's host scalars as CPU tensors)."""
    import torch

    out = {f"params/{k}": v.detach().clone()
           for k, v in model.params.items()}
    for k, v in dtt.interop.iter_leaf_paths(model._opt_tree("full")):
        out[f"opt_state/{k}"] = (v.detach().clone()
                                 if isinstance(v, torch.Tensor)
                                 else torch.as_tensor(np.asarray(v)))
    return out


def w_lm(dtt, strategy, batch_len, optimizer=None, precision=None, **kw):
    """Phase l's GPT-2-small LM (bf16 layers unless ``kw`` says other)
    under ``strategy``, ``fused_adamw(3e-4, weight_decay=0.01)``, the
    pallas loss, built from seed 0."""
    lm_kw = dict(LM, dtype="bfloat16")
    lm_kw.update(kw)
    with strategy.scope():
        model = dtt.Model(dtt.models.transformer_lm(VOCAB, **lm_kw))
        model.compile(optimizer=optimizer or dtt.optim.fused_adamw(
            3e-4, weight_decay=0.01), loss=PALLAS, metrics=[],
            precision=precision)
    return model.build((batch_len,), seed=0)


def w_fit(model, x, y, batch, steps):
    return model.fit(x, y, batch_size=batch, epochs=steps, steps_per_epoch=1,
                     shuffle=False, verbose=0).history["loss"]


def phase_sharded(torch, dtt, mods, batch=32, steps=3):
    """w1 and w2: GPT-2-small (bf16 layers, fused_adamw, the pallas loss,
    batch 32 x 1024) under DataParallel, ZeroDataParallel and FSDP over an
    NCCL group of world 1, from the same seed: parameters and optimizer
    state bit for bit after 3 steps, the launches of those steps (counts
    zeroed just before, read just after), ms a step in interleaved runs
    of 2 steps with the busy share, and each one's model-state bytes; then
    scan=True under FSDP with scan_overlap "require" against "off"."""
    t_len = LM["max_len"]
    x, y = lm_batch(batch, t_len)
    names = ("DataParallel", "ZeroDataParallel", "FSDP")
    strategies = [dtt.DataParallel(), dtt.ZeroDataParallel(), dtt.FSDP()]
    models, states, counts, bytes_ = {}, {}, {}, {}
    for name, strategy in zip(names, strategies):
        model = w_lm(dtt, strategy, t_len)
        reset_counts(mods)
        losses = w_fit(model, x, y, batch, steps)
        torch.cuda.synchronize()
        counts[name] = launch_counts(mods)
        tel = model.last_fit_telemetry
        bytes_[name] = tel["model_state_bytes_per_device"]
        print(f"  {name}: losses {[round(v, 5) for v in losses]}, model "
              f"state {bytes_[name] / 1e9:.4f} GB a card, comm estimate "
              f"{tel['comm_bytes_estimate']}")
        if not all(np.isfinite(losses)):
            raise SystemExit(f"{name}: losses not finite: {losses}")
        states[name] = full_state(dtt, model)
        models[name] = model
    for name in names[1:]:
        diff = first_difference(torch, states["DataParallel"], states[name])
        say_same(f"{name} against DataParallel, params and optimizer state",
                 diff)
        if diff is not None:
            raise SystemExit(f"{name} differs from DataParallel at world 1")
    states.clear()
    leaves = len(models["FSDP"].live_params())
    per_update = math.ceil(leaves / 64)
    want = {"xent_fwd": 1, "xent_bwd": 1, "flash_fwd": LM["num_layers"],
            "flash_dq": LM["num_layers"], "flash_dkv": LM["num_layers"],
            "fused_adam": per_update}
    for name in names:
        per_step = {k: counts[name][k] / steps for k in want}
        print(f"  {name}: launches a step {per_step} (K11 over {leaves} "
              f"{'blocks' if name != 'DataParallel' else 'leaves'})")
        if per_step != want:
            raise SystemExit(f"{name}: launches a step {per_step}, "
                             f"expected {want}")
    arms = {name: (lambda m=models[name]: w_fit(m, x, y, batch, 2), 2)
            for name in names}
    report_arms(torch, arms, interleaved(torch, arms, 3))
    launches = counts["FSDP"]
    models.clear()
    torch.cuda.empty_cache()

    print("phase w2: scan=True under FSDP, scan_overlap 'require' against "
          "'off', 3 steps")
    fsdp = strategies[2]
    scanned = {mode: w_lm(dtt, fsdp, t_len, scan=True, scan_overlap=mode)
               for mode in ("require", "off")}
    traces = {}
    for mode, model in scanned.items():
        reset_counts(mods)
        w_fit(model, x, y, batch, steps)
        torch.cuda.synchronize()
        c = launch_counts(mods)
        for k, v in c.items():
            launches[k] = launches.get(k, 0) + v
        traces[mode] = model.last_fit_telemetry["overlap"]
        print(f"  {mode}: overlap report {traces[mode]}, flash_fwd "
              f"{c['flash_fwd'] / steps:.0f} a step")
    diff = first_difference(torch, full_state(dtt, scanned["require"]),
                            full_state(dtt, scanned["off"]))
    say_same("overlapped scan against plain scan after 3 steps", diff)
    layers = LM["num_layers"]
    if diff is not None or traces["require"] != {
            "overlap": True, "exposed_comm_fraction": round(1 / layers, 6),
            "layers": layers} or traces["off"]["overlap"]:
        raise SystemExit("the overlapped scan differs from the plain one, "
                         "or its overlap report is wrong")
    arms = {f"scan_overlap={mode}": (lambda m=m: w_fit(m, x, y, batch, 2), 2)
            for mode, m in scanned.items()}
    report_arms(torch, arms, interleaved(torch, arms, 3))
    scanned.clear()
    torch.cuda.empty_cache()
    return launches, bytes_


def phase_sharded_bf16(torch, dtt, mods, batch=8):
    """w3: phase u2's LM (no dtype= on the layers, fused_adam(1e-4))
    under FSDP, one step under mixed_bfloat16 and one in f32: the dtypes
    the gathers move, and the estimate's gathered bytes."""
    from distributed_tpu_torch.parallel import collectives

    t_len = LM["max_len"]
    x, y = lm_batch(batch, t_len)
    fsdp = dtt.FSDP()
    seen, est = {}, {}
    orig = collectives._gather_into
    counts = {}
    for policy in ("mixed_bfloat16", None):
        dtypes = set()

        def spy(t, layout, async_op=False, dtypes=dtypes):
            dtypes.add(str(t.dtype).replace("torch.", ""))
            return orig(t, layout, async_op)

        model = w_lm(dtt, fsdp, t_len, dtype=None, precision=policy,
                     optimizer=dtt.optim.fused_adam(1e-4))
        collectives._gather_into = spy
        reset_counts(mods)
        try:
            losses = w_fit(model, x, y, batch, 1)
        finally:
            collectives._gather_into = orig
        for k, v in launch_counts(mods).items():
            counts[k] = counts.get(k, 0) + v
        tag = policy or "float32"
        seen[tag] = sorted(dtypes)
        est[tag] = model.last_fit_telemetry["comm_bytes_estimate"][
            "gathered_param_bytes_per_device"]
        print(f"  {tag}: loss {losses[0]:.5f}, gathers move {seen[tag]}, "
              f"gathered_param_bytes_per_device {est[tag]}")
        del model
        torch.cuda.empty_cache()
    if seen["mixed_bfloat16"] != ["bfloat16"] or seen["float32"] != [
            "float32"] or 2 * est["mixed_bfloat16"] != est["float32"]:
        raise SystemExit("mixed_bfloat16 under FSDP does not gather bf16 "
                         "or does not halve the gathered bytes")
    return counts


def dir_mb(path):
    return sum(f.stat().st_size for f in path.rglob("*") if f.is_file()) / 1e6


def phase_sharded_ckpt(torch, dtt, mods, batch=8):
    """w4: ShardedCheckpointer on the FSDP LM (phase w1's, batch 8 x 1024)
    mid-fit: run A fits 2 steps, saves (sync, then async: the blocking
    ms of each, the MB on disk), fits 2 more; run B restores A's step 2
    (seconds) and fits steps 3-4 (counts zeroed just before, read just
    after): bit for bit A's; a DataParallel model restores the same
    directory: A's step-2 state bit for bit."""
    import tempfile
    from pathlib import Path

    t_len = LM["max_len"]
    x, y = lm_batch(batch, t_len, seed=2)
    fsdp = dtt.FSDP()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        a = w_lm(dtt, fsdp, t_len)
        w_fit(a, x, y, batch, 2)
        at2 = full_state(dtt, a)
        ck = dtt.ShardedCheckpointer(tmp / "sync")
        block = {}
        block["sync"] = 1e3 * wall_s(torch, lambda: ck.save(a))
        ack = dtt.ShardedCheckpointer(tmp / "async", async_save=True)
        block["async"] = 1e3 * wall_s(torch, lambda: ack.save(a))
        t = time.perf_counter()
        ack.wait()
        drain = time.perf_counter() - t
        mb = dir_mb(tmp / "sync" / "ckpt-2")
        a.fit(x, y, batch_size=batch, epochs=4, steps_per_epoch=1,
              initial_epoch=2, shuffle=False, verbose=0)
        end_a = full_state(dtt, a)
        del a
        torch.cuda.empty_cache()
        b = w_lm(dtt, fsdp, t_len)
        restore_s = wall_s(torch, lambda: ck.restore_into(b))
        restored = first_difference(torch, at2, full_state(dtt, b))
        reset_counts(mods)
        b.fit(x, y, batch_size=batch, epochs=4, steps_per_epoch=1,
              initial_epoch=2, shuffle=False, verbose=0)
        torch.cuda.synchronize()
        counts = launch_counts(mods)
        resumed = first_difference(torch, end_a, full_state(dtt, b))
        del b
        torch.cuda.empty_cache()
        c = w_lm(dtt, dtt.DataParallel(), t_len)
        dtt.ShardedCheckpointer(tmp / "async").restore_into(c)
        into_dp = first_difference(torch, at2, full_state(dtt, c))
        del c
        torch.cuda.empty_cache()
    print(f"  save at step 2: {mb:.1f} MB on disk (one rank's blocks and "
          f"the manifest); blocking ms sync {block['sync']:.1f}, async "
          f"{block['async']:.1f} (the writer then {drain:.2f} s to its "
          f"commit); restore {restore_s:.2f} s")
    say_same("restored state against A's step 2", restored)
    say_same("resumed steps 3-4 against the uninterrupted run", resumed)
    say_same("the async save restored under DataParallel against A's step "
             "2", into_dp)
    if restored is not None or resumed is not None or into_dp is not None:
        raise SystemExit("the sharded checkpoint did not resume bit for bit")
    return counts


# ------------------------------------------------------------------ phase x
def phase_tp_sp(torch, dtt, mods, batch=32, steps=3):
    """x1: phase l's GPT-2-small (bf16 layers, fused_adamw, the pallas
    loss, batch 32 x 1024) under DataParallel, DataTensorParallel(
    model_parallel=1) and DataSeqParallel(seq_parallel=1), ring and
    ulysses, over an NCCL group of world 1, from seed 0: parameters and
    optimizer state bit for bit against DataParallel's after 3 steps,
    the launches of those steps (counts zeroed just before, read just
    after), and ms a step in interleaved runs of 2 steps with the busy
    share. DataTensorParallel(1) must store every hinted leaf as a block
    of its one-rank model line and call Megatron's pair over it (the
    layers reach ``copy_to_group``/``reduce_from_group`` through their
    module, where they are counted here); at seq 1 attention takes the
    flash branch, as JAX's ``_ring_config`` sends a seq axis of size 1.
    Returns the launches of the tensor- and sequence-parallel runs."""
    from distributed_tpu_torch.parallel.collectives import layout_of

    t_len = LM["max_len"]
    x, y = lm_batch(batch, t_len)
    with megatron_pair_counted() as pair:
        return tp_sp_runs(torch, dtt, mods, x, y, batch, steps, pair,
                          layout_of)


@contextlib.contextmanager
def megatron_pair_counted():
    """Count the calls of Megatron's f/g pair (``copy_to_group``,
    ``reduce_from_group``), which the layers reach through their module:
    yields ``{name: calls}``, the module's functions wrapped until the
    block ends."""
    from distributed_tpu_torch.parallel import collectives

    pair = {"copy_to_group": 0, "reduce_from_group": 0}
    originals = {k: getattr(collectives, k) for k in pair}

    def counted(name):
        def call(*args, **kw):
            pair[name] += 1
            return originals[name](*args, **kw)
        return call

    for k in pair:
        setattr(collectives, k, counted(k))
    try:
        yield pair
    finally:
        for k, fn in originals.items():
            setattr(collectives, k, fn)


def tp_sp_runs(torch, dtt, mods, x, y, batch, steps, pair, layout_of):
    """Phase x1's runs (``phase_tp_sp``), ``pair`` the Megatron calls."""
    t_len = LM["max_len"]
    strategies = {
        "DataParallel": dtt.DataParallel(),
        "DataTensorParallel(1)": dtt.DataTensorParallel(model_parallel=1),
        "DataSeqParallel(1, ring)": dtt.DataSeqParallel(seq_parallel=1),
        "DataSeqParallel(1, ulysses)": dtt.DataSeqParallel(
            seq_parallel=1, attention="ulysses"),
    }
    models, counts, launches, base = {}, {}, {}, None
    for name, strategy in strategies.items():
        model = w_lm(dtt, strategy, t_len)
        lays = [layout_of(p) for p in model.live_params().values()]
        blocks = sum(lay is not None and lay.axis == "model" and lay.n == 1
                     for lay in lays)
        for k in pair:
            pair[k] = 0
        reset_counts(mods)
        losses = w_fit(model, x, y, batch, steps)
        torch.cuda.synchronize()
        counts[name] = launch_counts(mods)
        calls = {k: v / steps for k, v in pair.items()}
        # Each layer: wq/wk/wv, bq/bk/bv, wo, the MLP's col kernel and
        # bias and its row kernel; attention's and the MLP's inputs
        # copied to the line, wo's and the row kernel's outputs reduced.
        tp = name.startswith("DataTensorParallel")
        want_blocks = 10 * LM["num_layers"] if tp else 0
        want_calls = 2 * LM["num_layers"] if tp else 0
        print(f"  {name}: {blocks} leaves stored as blocks of a one-rank "
              f"model line, Megatron calls a step {calls}")
        if blocks != want_blocks or set(calls.values()) != {want_calls}:
            raise SystemExit(
                f"{name}: {blocks} model-line blocks and Megatron calls "
                f"{calls} a step, expected {want_blocks} and {want_calls}")
        if name != "DataParallel":
            for k, v in counts[name].items():
                launches[k] = launches.get(k, 0) + v
        tel = model.last_fit_telemetry
        print(f"  {name}: losses {[round(v, 5) for v in losses]}, model "
              f"state {tel['model_state_bytes_per_device'] / 1e9:.4f} GB a "
              f"card, mesh {getattr(strategy, 'axis_sizes', None)}")
        if not all(np.isfinite(losses)):
            raise SystemExit(f"{name}: losses not finite: {losses}")
        state = full_state(dtt, model)
        if base is None:
            base = state
        else:
            diff = first_difference(torch, base, state)
            say_same(f"{name} against DataParallel, params and optimizer "
                     "state", diff)
            if diff is not None:
                raise SystemExit(f"{name} differs from DataParallel at "
                                 "world 1")
        models[name] = model
    base = None
    leaves = len(models["DataParallel"].live_params())
    want = {"xent_fwd": 1, "xent_bwd": 1, "flash_fwd": LM["num_layers"],
            "flash_dq": LM["num_layers"], "flash_dkv": LM["num_layers"],
            "fused_adam": math.ceil(leaves / 64)}
    for name in strategies:
        per_step = {k: counts[name][k] / steps for k in want}
        print(f"  {name}: launches a step {per_step}")
        if per_step != want:
            raise SystemExit(f"{name}: launches a step {per_step}, "
                             f"expected {want}")
    arms = {name: (lambda m=models[name]: w_fit(m, x, y, batch, 2), 2)
            for name in strategies}
    report_arms(torch, arms, interleaved(torch, arms, 3))
    models.clear()
    torch.cuda.empty_cache()
    return launches


def phase_ring_ops(torch, dtt, b=2, t=4096, h=12, d=64):
    """x2: ``ops.ring_attention`` (naive and the causal default) and the
    Ulysses exchange on CUDA tensors over the NCCL world-1 group: the
    ring's output and its q, k, v gradients against the plain dense
    attention (f32, atol 2e-5 per entry), the exchange's round trip bit
    for bit, and the ring's ms against the dense path's."""
    from distributed_tpu_torch.ops.flash_attention import dense_attention
    from distributed_tpu_torch.ops.ring_attention import ring_attention
    from distributed_tpu_torch.parallel import collectives

    mesh = dtt.parallel.make_mesh({"data": 1, "seq": 1})
    group = mesh.get_group("seq")
    g = torch.Generator(device="cuda").manual_seed(0)
    q, k, v, cot = (torch.randn((b, t, h, d), device="cuda", generator=g)
                    for _ in range(4))
    for causal in (False, True):
        qs, ks, vs = (a.clone().requires_grad_() for a in (q, k, v))
        out = ring_attention(qs, ks, vs, mesh=mesh, causal=causal)
        (out * cot).sum().backward()
        qd, kd, vd = (a.clone().requires_grad_() for a in (q, k, v))
        ref = dense_attention(qd, kd, vd, causal)
        (ref * cot).sum().backward()
        errs = [max_err(out, ref)] + [max_err(a.grad, r.grad) for a, r in
                                      ((qs, qd), (ks, kd), (vs, vd))]
        with torch.no_grad():
            ring_ms = cuda_ms(torch, lambda i: ring_attention(
                q, k, v, mesh=mesh, causal=causal), 5)
            dense_ms = cuda_ms(torch, lambda i: dense_attention(
                q, k, v, causal), 5)
        print(f"  ring (1 rank) causal={causal}: max |out - dense| "
              f"{errs[0]:.3e}, grads {[f'{e:.3e}' for e in errs[1:]]}; "
              f"{ring_ms:.3f} ms forward against dense {dense_ms:.3f} ms "
              f"(B={b}, T={t}, H={h}, D={d}, f32)")
        if max(errs) > TOL["float32"]:
            raise SystemExit(f"ring attention differs from dense: {errs}")
        del qs, ks, vs, qd, kd, vd, out, ref
    heads = collectives.ulysses_to_heads(q, group)
    back = collectives.ulysses_to_seq(heads, group)
    torch.cuda.synchronize()
    same = bool(torch.equal(heads, q) and torch.equal(back, q))
    print(f"  Ulysses exchange over the world-1 NCCL group: (B, T, H, D) "
          f"round trip bit for bit: {same}")
    if not same:
        raise SystemExit("the Ulysses exchange changed its input")
    torch.cuda.empty_cache()


# ------------------------------------------------------------------ phase y
MOE = dict(moe_experts=8, moe_every=2)


def moe_routing(dtt, model):
    """(share of the routed choices dropped by capacity, the aux loss
    summed over the MoE layers) of a model's last training forward."""
    layers = [m for m in model.module.modules()
              if isinstance(m, dtt.nn.MoE)]
    kept = sum(float(m.routed[0]) for m in layers)
    total = sum(float(m.routed[1]) for m in layers)
    aux = sum(float(v) for k, v in model.state.items()
              if k.endswith("aux_loss"))
    return 1.0 - kept / max(total, 1.0), aux


def moe_layer_ms(torch, dtt, batch, t_len):
    """Device ms of one of y1's MoE layers (bf16, 8 experts, hidden
    3,072), forward and backward on a (batch, T, 768) input, alone."""
    d = LM["d_model"]
    layer = dtt.nn.MoE(8, 4 * d, dtype="bfloat16")
    layer.build((t_len, d), torch.Generator().manual_seed(0))
    layer.to("cuda").train()
    x = torch.randn(batch, t_len, d, device="cuda", dtype=torch.bfloat16,
                    requires_grad=True)

    def step(_):
        layer(x).float().sum().backward()

    return cuda_ms(torch, step, 5)


def per_step_want(model, layers=LM["num_layers"]):
    leaves = len(model.live_params())
    return {"xent_fwd": 1, "xent_bwd": 1, "flash_fwd": layers,
            "flash_dq": layers, "flash_dkv": layers,
            "fused_adam": math.ceil(leaves / 64)}


def check_per_step(name, counts, want, steps):
    per_step = {k: counts[k] / steps for k in want}
    print(f"  {name}: launches a step {per_step}")
    if per_step != want:
        raise SystemExit(f"{name}: launches a step {per_step}, expected "
                         f"{want}")


def phase_moe(torch, dtt, mods, paged_ops, batch=8, steps=3):
    """y1 (see the module docstring). Returns the launches of the EP run,
    the generate and the Engine's."""
    with megatron_pair_counted() as pair:
        return moe_runs(torch, dtt, mods, paged_ops, batch, steps, pair)


def moe_runs(torch, dtt, mods, paged_ops, batch, steps, pair):
    """Phase y1's runs (``phase_moe``), ``pair`` the f/g calls."""
    t_len = LM["max_len"]
    x, y = lm_batch(batch, t_len)
    n_moe = LM["num_layers"] // MOE["moe_every"]
    strategies = {
        "DataParallel": dtt.DataParallel(),
        "DataExpertParallel(1)": dtt.DataExpertParallel(expert_parallel=1),
    }
    models, counts, base = {}, {}, None
    for name, strategy in strategies.items():
        model = w_lm(dtt, strategy, t_len, **MOE)
        if base is None:
            n = sum(math.prod(s) for s in model._param_shapes().values())
            moe = next(m for m in model.module.modules()
                       if isinstance(m, dtt.nn.MoE))
            print(f"  {n / 1e6:.1f}M parameters, {n_moe} MoE blocks, "
                  f"capacity {moe._capacity(1024)} a group of 1,024")
        for k in pair:
            pair[k] = 0
        reset_counts(mods)
        losses = w_fit(model, x, y, batch, steps)
        torch.cuda.synchronize()
        counts[name] = launch_counts(mods)
        calls = {k: v / steps for k, v in pair.items()}
        ep = name.startswith("DataExpert")
        want_calls = ({"copy_to_group": 2 * n_moe,
                       "reduce_from_group": n_moe} if ep else
                      {"copy_to_group": 0, "reduce_from_group": 0})
        dropped, aux = moe_routing(dtt, model)
        print(f"  {name}: losses {[round(v, 5) for v in losses]}, aux loss "
              f"{aux:.6f}, dropped {dropped:.4f} of the routed choices, "
              f"f/g calls over the expert line a step {calls}")
        if calls != want_calls:
            raise SystemExit(f"{name}: f/g calls {calls}, expected "
                             f"{want_calls}")
        if not all(np.isfinite(losses)) or not np.isfinite(aux):
            raise SystemExit(f"{name}: losses {losses}, aux {aux}")
        state = full_state(dtt, model)
        state.update({f"state/{k}": v.detach().clone()
                      for k, v in model.state.items()})
        if base is None:
            base = state
        else:
            diff = first_difference(torch, base, state)
            say_same(f"{name} against DataParallel, params, optimizer "
                     "state and aux losses", diff)
            if diff is not None:
                raise SystemExit(f"{name} differs from DataParallel")
        models[name] = model
        check_per_step(name, counts[name], per_step_want(model), steps)
    base = None
    arms = {name: (lambda m=models[name]: w_fit(m, x, y, batch, 2), 2)
            for name in strategies}
    report_arms(torch, arms, interleaved(torch, arms, 3))
    dp = models["DataParallel"]
    trace = device_trace(torch, lambda: w_fit(dp, x, y, batch, 1))
    attn = sum(b - a for op, a, b in trace
               if re.search(r"flash_(fwd|dq|dkv)_wgmma_kernel", op)) / 1e3
    step_ms = sum(b - a for _, a, b in trace) / 1e3
    moe_ms = n_moe * moe_layer_ms(torch, dtt, batch, t_len)
    print(f"  a traced step: device {step_ms:.3f} ms, attention kernels "
          f"{attn:.3f} ms; the {n_moe} MoE layers (one timed alone, "
          f"forward and backward) {moe_ms:.3f} ms")
    models.clear()
    prompts = np.random.default_rng(5).integers(0, VOCAB, (8, 64)).astype(
        np.int32)
    t = time.perf_counter()
    gen = dp.generate(prompts, 64, temperature=0.0)
    print(f"  generate: 8 x (64 + 64) tokens in "
          f"{time.perf_counter() - t:.2f} s")
    reqs = ([(prompts[i], 64) for i in range(8)]
            + requests(8, (32, 256), (32, 64), seed=6))
    paged_ops.reset_launch_counts()
    outs, tel, wall = serve(dtt, dp, reqs, decode_kernel="fused")
    k1 = paged_ops.launches["paged_attention"]
    report("MoE LM, fused", tel, wall)
    check_outputs(outs, reqs, VOCAB)
    if k1 != tel["decode_steps"] * LM["num_layers"]:
        raise SystemExit(f"K1 launched {k1} times in {tel['decode_steps']} "
                         "decode steps")
    share, _ = agreement([np.asarray(g) for g in gen], outs[:8], reqs[:8])
    print(f"  Engine vs generate (bf16): token agreement {share:.4f}; K1 "
          f"launches {k1}")
    del dp
    torch.cuda.empty_cache()
    small = dtt.Model(dtt.models.transformer_lm(
        VOCAB, **dict(LM, num_layers=2), **MOE))
    small.build((t_len,), seed=1)
    for m in small.module.modules():
        if isinstance(m, dtt.nn.MoE):
            m.capacity_factor = m.num_experts / m.top_k  # nothing drops
    sp = prompts[:4, :32]
    sgen = small.generate(sp, 32, temperature=0.0)
    souts, _, _ = serve(dtt, small, [(sp[i], 32) for i in range(4)],
                        decode_kernel="fused")
    exact = all(np.array_equal(np.asarray(a), b) for a, b in zip(sgen, souts))
    print(f"  2 layers, f32: Engine token-exact to generate: {exact}")
    if not exact:
        raise SystemExit("the f32 MoE LM's Engine and generate differ")
    out = dict(counts["DataExpertParallel(1)"])
    out["paged_attention"] = k1
    return out


def phase_pipe(torch, dtt, mods, paged_ops, reqs, batch=32, steps=3):
    """y2 (see the module docstring). Returns the pipelined run's
    launches and the Engine's K1 launches."""
    t_len = LM["max_len"]
    x, y = lm_batch(batch, t_len)
    runs = {
        "DataPipelineParallel(1)": (
            dtt.DataPipelineParallel(pipeline_parallel=1),
            dict(pipeline=True)),
        "scan=True twin, DataParallel": (dtt.DataParallel(), dict(scan=True)),
    }
    models, counts, base = {}, {}, None
    for name, (strategy, kw) in runs.items():
        model = w_lm(dtt, strategy, t_len, **kw)
        reset_counts(mods)
        losses = w_fit(model, x, y, batch, steps)
        torch.cuda.synchronize()
        counts[name] = launch_counts(mods)
        print(f"  {name}: losses {[round(v, 5) for v in losses]}")
        if not all(np.isfinite(losses)):
            raise SystemExit(f"{name}: losses not finite: {losses}")
        state = {k.replace("pipelined_blocks/", "scanned_blocks/"): v
                 for k, v in full_state(dtt, model).items()}
        if base is None:
            base = state
        else:
            diff = first_difference(torch, base, state)
            say_same("the pipelined LM against its scan twin, params and "
                     "optimizer state", diff)
            if diff is not None:
                raise SystemExit("the pipelined LM differs from its scan "
                                 "twin at pipe 1")
        check_per_step(name, counts[name], per_step_want(model), steps)
        models[name] = model
    base = None
    arms = {name: (lambda m=models[name]: w_fit(m, x, y, batch, 2), 2)
            for name in runs}
    report_arms(torch, arms, interleaved(torch, arms, 3))
    served = {}
    for name, model in models.items():
        paged_ops.reset_launch_counts()
        served[name], tel, wall = serve(dtt, model, reqs[:8],
                                        decode_kernel="fused")
        k1 = paged_ops.launches["paged_attention"]
        report(name, tel, wall)
        check_outputs(served[name], reqs[:8], VOCAB)
        if name.startswith("DataPipeline"):
            out = dict(counts[name])
            out["paged_attention"] = k1
    same = all(np.array_equal(a, b) for a, b in zip(*served.values()))
    print(f"  the Engine serves the pipelined LM off the pipe mesh with the "
          f"twin's tokens: {same}; K1 launches {out['paged_attention']}")
    if not same:
        raise SystemExit("the pipelined LM's Engine tokens differ from the "
                         "scan twin's")
    models.clear()
    torch.cuda.empty_cache()
    return out


def phase_composite(torch, dtt, mods, batch=32, steps=3):
    """y3: ``CompositeParallel({"data": 1})`` against ``DataParallel`` on
    phase l's LM, bit for bit after 3 steps. Returns its launches."""
    t_len = LM["max_len"]
    x, y = lm_batch(batch, t_len)
    states, counts = {}, {}
    for name, strategy in (("DataParallel", dtt.DataParallel()),
                           ('CompositeParallel({"data": 1})',
                            dtt.CompositeParallel({"data": 1}))):
        model = w_lm(dtt, strategy, t_len)
        reset_counts(mods)
        losses = w_fit(model, x, y, batch, steps)
        torch.cuda.synchronize()
        counts[name] = launch_counts(mods)
        print(f"  {name}: losses {[round(v, 5) for v in losses]}")
        check_per_step(name, counts[name], per_step_want(model), steps)
        states[name] = full_state(dtt, model)
        del model
    diff = first_difference(torch, *states.values())
    say_same("CompositeParallel against DataParallel, params and optimizer "
             "state", diff)
    if diff is not None:
        raise SystemExit("CompositeParallel differs from DataParallel")
    states.clear()
    torch.cuda.empty_cache()
    return counts['CompositeParallel({"data": 1})']


# ------------------------------------------------------------------ phase z
def host_leaves(plan):
    """{optax path: bytes} of the optimizer leaves the plan prices (as the
    JAX planner does) that the port holds as no tensor: its counts (host
    integers) and the hyperparameters it fixes."""
    return {path: int(np.asarray(leaf).itemsize)
            for path, leaf in plan._ctx["abstracts"]["opt"]
            if isinstance(leaf, np.generic)}


def held_bytes(dtt, model):
    from distributed_tpu_torch.utils.profiler import tree_bytes_per_device

    return tree_bytes_per_device(model._param_list(),
                                 list(model.state.values()),
                                 model.opt_state)["max_bytes_per_device"]


def phase_auto(torch, dtt, mods, batch=32, steps=3):
    """z1: compile(strategy="auto") on phase l's LM; returns its launches."""
    t_len = LM["max_len"]
    x, y = lm_batch(batch, t_len)

    def lm(**compile_kw):
        model = dtt.Model(dtt.models.transformer_lm(
            VOCAB, dtype="bfloat16", **LM))
        model.compile(optimizer=dtt.optim.fused_adamw(3e-4, weight_decay=0.01),
                      loss=PALLAS, metrics=[], **compile_kw)
        return model

    auto = lm(strategy="auto", auto_options=dict(batch_size=batch))
    t = time.perf_counter()
    auto.build((t_len,), seed=0)
    plan = auto.last_plan
    print(f"  planned and built in {time.perf_counter() - t:.2f} s: "
          f"{plan.devices} device(s), backend {plan.backend}, "
          f"{plan.n_params} params")
    for row in plan.candidates:
        print(f"    {row['label']:36s} est {row['est_step_seconds']:.6f} s a "
              f"step, state {row['state_bytes_per_device']} B, "
              f"activations {row['activation_bytes_per_device']} B")
    for row in plan.pruned:
        print(f"    pruned {row['label']}: {row['reason']}")
    cfg = plan.chosen["config"]
    print(f"  chose {plan.chosen['label']} (tie_break {plan.tie_break})")
    if plan.backend != "gpu" or cfg["strategy"] != "single_device":
        raise SystemExit(f"one card: expected a single_device plan for the "
                         f"card, got {plan.chosen['label']} on "
                         f"{plan.backend}")
    host = host_leaves(plan)
    held = held_bytes(dtt, auto)
    print(f"  state a card: held {held} B, planned "
          f"{plan.chosen['state_bytes_per_device']} B, of which {host} "
          f"({sum(host.values())} B) the port keeps on the host")
    if plan.chosen["state_bytes_per_device"] - sum(host.values()) != held:
        raise SystemExit("the committed model's state differs from the plan")
    reset_counts(mods)
    losses = auto.fit(x, y, batch_size=batch, epochs=1, steps_per_epoch=steps,
                      shuffle=False, verbose=0).history["loss"]
    torch.cuda.synchronize()
    counts = launch_counts(mods)
    print(f"  auto: losses {losses}, launches {counts}")
    if auto.last_fit_telemetry["plan"]["chosen"]["label"] != \
            plan.chosen["label"]:
        raise SystemExit("last_fit_telemetry lacks the plan")
    for name in ("flash_fwd", "flash_dq", "flash_dkv", "xent_fwd", "xent_bwd",
                 "fused_adam"):
        if not counts.get(name):
            raise SystemExit(f"the auto-compiled fit never launched {name}")
    state = full_state(dtt, auto)
    del auto
    torch.cuda.empty_cache()
    k = cfg["steps_per_execution"]
    with dtt.SingleDevice().scope():
        hand = lm(precision=cfg["precision"],
                  steps_per_execution=k if k > 1 else None)
    hand.build((t_len,), seed=0)
    hand_losses = hand.fit(
        x, y, batch_size=batch, epochs=1, steps_per_epoch=steps,
        shuffle=False, verbose=0,
        grad_accum=cfg["grad_accum"] if cfg["grad_accum"] > 1 else None,
    ).history["loss"]
    diff = first_difference(torch, state, full_state(dtt, hand))
    say_same(f"auto against the same configuration by hand (losses "
             f"{hand_losses}), params and optimizer state", diff)
    if diff is not None or hand_losses != losses:
        raise SystemExit("the auto-compiled model differs from the hand one")
    del hand
    torch.cuda.empty_cache()

    measured = lm(strategy="auto", measure=True,
                  auto_options=dict(batch_size=batch, top_k=3))
    t = time.perf_counter()
    measured.build((t_len,), seed=0)
    mplan = measured.last_plan
    est = {r["label"]: r["est_step_seconds"] for r in mplan.candidates}
    print(f"  measure=True, top_k=3: planned in "
          f"{time.perf_counter() - t:.1f} s, tie_break {mplan.tie_break}")
    for row in mplan.measured:
        print(f"    {row['label']:36s} measured {row['seconds_per_step']} s a "
              f"step, estimated {est[row['label']]:.6f} s")
    timed = [r for r in mplan.measured if r["seconds_per_step"] is not None]
    fastest = min(timed, key=lambda r: r["seconds_per_step"])
    print(f"  committed {mplan.chosen['label']}")
    if mplan.tie_break != "measured" or len(mplan.measured) != 3 or \
            mplan.chosen["config"] != fastest["config"]:
        raise SystemExit("measure=True did not commit the fastest measured "
                         "candidate")
    del measured
    torch.cuda.empty_cache()

    cap = plan.chosen["state_bytes_per_device"] // 2
    try:
        lm(strategy="auto", hbm_cap_bytes=cap,
           auto_options=dict(batch_size=batch)).build((t_len,), seed=0)
    except ValueError as e:
        print(f"  hbm_cap_bytes={cap}: ValueError: {str(e)[:240]}...")
        if "single_device" not in str(e):
            raise SystemExit("the cap's error names no pruned label")
    else:
        raise SystemExit(f"hbm_cap_bytes={cap} committed a plan")
    torch.cuda.empty_cache()
    return counts


CHILDREN = []  # the background's processes, each its own process group


def run_child(argv, timeout, cwd=None):
    """``subprocess.run(argv, capture_output=True, text=True, cwd=cwd)`` in a
    process group of its own, kept in ``CHILDREN`` until it ends, so that
    ``stop_children`` can end it and the gangs it started."""
    proc = subprocess.Popen(argv, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, cwd=cwd,
                            start_new_session=True)
    CHILDREN.append(proc)
    try:
        out, err = proc.communicate(timeout=timeout)
    finally:
        stop_children([proc])
        CHILDREN.remove(proc)
    return subprocess.CompletedProcess(argv, proc.returncode, out, err)


def stop_children(procs=None):
    """Kill each process group of ``procs`` (all of ``CHILDREN``) that is
    still there."""
    for proc in list(CHILDREN if procs is None else procs):
        with contextlib.suppress(ProcessLookupError, PermissionError):
            os.killpg(proc.pid, signal.SIGKILL)
        with contextlib.suppress(Exception):
            proc.wait(timeout=30)


def phase_restart(torch, say=print):
    """z2: scripts/torch_restart.py on this card, restart and liveness at
    once."""
    script = os.path.join(ROOT, "scripts", "torch_restart.py")
    out = {}
    modes = ([], ["--liveness"])
    with concurrent.futures.ThreadPoolExecutor(len(modes)) as pool:
        runs = list(pool.map(lambda mode: run_child(
            [sys.executable, script, "--num-workers", "1", "--timeout",
             "300", *mode], timeout=600), modes))
    for mode, run in zip(modes, runs):
        lines = run.stdout.strip().splitlines()
        for line in lines[:-1]:
            say(f"  {line}")
        if run.returncode != 0 or not lines:
            say(run.stderr[-3000:])
            raise SystemExit(f"scripts/torch_restart.py {' '.join(mode)} "
                             f"failed ({run.returncode})")
        out.update(json.loads(lines[-1]))
    return out


def phase_supervise(torch, reference, say=print):
    """z3: scripts/torch_restart.py --supervise on this card, held to z2's
    uninterrupted run (``reference``: its result values; the same LM,
    data and optimizer); returns the kill case's resumed worker's kernel
    launches."""
    script = os.path.join(ROOT, "scripts", "torch_restart.py")
    fd, ref_path = tempfile.mkstemp(suffix=".json")
    with os.fdopen(fd, "w") as f:
        json.dump(reference, f)
    cases = ("kill", "preempt", "corrupt")
    with concurrent.futures.ThreadPoolExecutor(len(cases)) as pool:
        runs = list(pool.map(lambda case: run_child(
            [sys.executable, script, "--supervise", "--num-workers", "1",
             "--timeout", "300", "--reference", ref_path, "--cases", case],
            timeout=600), cases))
    os.unlink(ref_path)
    out = {}
    for case, run in zip(cases, runs):
        lines = run.stdout.strip().splitlines()
        for line in lines[:-1]:
            say(f"  {line}")
        if run.returncode != 0 or not lines:
            say(run.stderr[-3000:])
            raise SystemExit(f"scripts/torch_restart.py --supervise --cases "
                             f"{case} failed ({run.returncode})")
        out.update(json.loads(lines[-1])["supervise"]["cases"])
    counts = out["kill"]["launches"]
    for name in ("flash_fwd", "flash_dq", "flash_dkv", "xent_fwd", "xent_bwd",
                 "fused_adam"):
        if not counts.get(name):
            raise SystemExit(f"the supervised worker never launched {name}")
    return counts


#: phases that run in a process of their own (``child_phase``), on the
#: thread of ``start_background`` after z2 and z3
CHILD_PHASES = ("z8", "z9", "z10a", "z10b")


def child_phase(sub):
    """Phase ``sub`` (one of ``CHILD_PHASES``) in this process, which
    ``run_phase_child`` started: its lines, then ``CHILD`` and the JSON
    of its launches."""
    import torch

    import distributed_tpu_torch as dtt
    from distributed_tpu_torch.ops import bn_reduce as bn_ops
    from distributed_tpu_torch.ops import conv1x1 as conv_ops
    from distributed_tpu_torch.ops import flash_attention as flash_ops
    from distributed_tpu_torch.ops import fused_update as adam_ops
    from distributed_tpu_torch.ops import launch_probe as probe_ops
    from distributed_tpu_torch.ops import paged_attention as paged_ops
    from distributed_tpu_torch.ops import pallas_kernels as xent_ops

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if sub == "z8":
        counts = phase_data_tiers(torch, dtt, (conv_ops, bn_ops))
    elif sub == "z9":
        counts = phase_lint_and_r(torch, (
            paged_ops, xent_ops, flash_ops, adam_ops, conv_ops, bn_ops,
            probe_ops))
    elif sub == "z10a":
        counts = phase_parallel_residual(torch, dtt, paged_ops,
                                         requests(16, (32, 512), (64, 128)))
    else:
        counts = phase_inner_remat(torch, dtt, (xent_ops, flash_ops,
                                                adam_ops))
    print("CHILD " + json.dumps(counts), flush=True)


def run_phase_child(sub, say):
    """``child_phase(sub)`` in a new process: says its lines, returns its
    launches."""
    run = run_child([sys.executable, "-c", "import chip_smoke; "
                     f"chip_smoke.child_phase({sub!r})"], timeout=900,
                    cwd=ROOT)
    lines = run.stdout.rstrip().splitlines()
    for line in lines:
        if not line.startswith("CHILD "):
            say(line)
    tagged = [ln for ln in lines if ln.startswith("CHILD ")]
    if run.returncode != 0 or not tagged:
        say(run.stderr[-4000:])
        raise SystemExit(f"phase {sub} failed in its process "
                         f"({run.returncode})")
    return json.loads(tagged[-1][len("CHILD "):])


def start_background(torch):
    """Phases z2 and z3, then each of ``CHILD_PHASES`` in a process of its
    own, one after another on a thread, beside the phases from r on: they
    spend much of their time starting processes. Returns the box that
    ``join_background`` reads."""
    subs = ("z2", "z3") + CHILD_PHASES
    box = {"lines": {sub: [] for sub in subs}, "result": {}, "seconds": {},
           "done": {sub: threading.Event() for sub in subs}, "error": None}

    def step(sub, fn):
        t = time.perf_counter()
        box["result"][sub] = fn(box["lines"][sub].append)
        box["seconds"][sub] = time.perf_counter() - t
        box["done"][sub].set()

    def run():
        sub = "z2"
        try:
            step(sub, lambda say: phase_restart(torch, say))
            sub = "z3"
            step(sub, lambda say: phase_supervise(
                torch, box["result"]["z2"]["restart"]["uninterrupted"], say))
            for sub in CHILD_PHASES:
                step(sub, lambda say, sub=sub: run_phase_child(sub, say))
        except BaseException as e:  # raised again by the join
            box["error"] = (sub, e)
        finally:
            for done in box["done"].values():
                done.set()

    box["thread"] = threading.Thread(target=run, name="dtpu-smoke-bg",
                                     daemon=True)
    box["thread"].start()
    return box


def join_background(box, sub):
    """Wait for ``start_background``'s phase ``sub``, print its lines and
    raise what it (or a phase before it on the thread) raised; returns
    its result."""
    box["done"][sub].wait()
    for line in box["lines"][sub]:
        print(line)
    if sub in box["seconds"]:
        print(f"  ({sub} ran beside the phases from r on: "
              f"{box['seconds'][sub]:.1f} s)")
        return box["result"][sub]
    raise box["error"][1]


# ----------------------------------------------------------------- phase z4
def fleet_run(dtt, model, programs, reqs, arrivals=None, **kw):
    """One ``ServingFleet`` over ``reqs`` at phase c's serving shapes;
    returns (fleet, outputs, host seconds)."""
    fl = dtt.fleet.ServingFleet(
        model, programs=programs, max_slots=8, block_size=16,
        max_len=LM["max_len"], **{"decode_replicas": 2,
                                  "prefill_replicas": 1, **kw})
    t = time.perf_counter()
    outs = fl.run([dtt.serving.Request(p, m) for p, m in reqs],
                  arrival_times=arrivals)
    return fl, outs, time.perf_counter() - t


def fleet_report(tag, tel, wall):
    ttft = tel["time_to_first_token"]
    ho = tel["handoffs"]
    print(f"  {tag}: {tel['generated_tokens']} tokens, virtual clock "
          f"{tel['tokens_per_sec']:.1f} tokens/s, TTFT p50 "
          f"{ttft['p50'] * 1e3:.1f} ms p99 {ttft['p99'] * 1e3:.1f} ms "
          f"(virtual), makespan {tel['makespan_s']:.3f} s (virtual), host "
          f"{wall:.2f} s; handoffs installed {ho['installed']} fallen back "
          f"{ho['fallback_reprefill']}, payload bytes {ho['bytes_shipped']}, "
          f"decode steps {tel['decode_steps']}, lost "
          f"{tel['lost_requests']}")


def pool_bytes(kv):
    return kv.bytes_per_block() * kv.num_blocks


def handoff_timing(torch, dtt, model, programs, prompt_len=512):
    """(z4, z4c) One 512-token prompt prefilled by a prefill replica at
    full width: ``pack_kv`` and ``install_kv`` into another pool timed
    (device synchronized), the payload's bytes, and the installed blocks
    bit for bit the source pool's (the bf16 bits and the payload's)."""
    from distributed_tpu_torch.fleet import handoff

    rng = np.random.default_rng(7)
    prompt = rng.integers(0, VOCAB, prompt_len).astype(np.int32)
    src = dtt.fleet.PrefillReplica("prefill-t", programs, block_size=16,
                                   max_len=LM["max_len"])
    seq = dtt.serving.Sequence(dtt.serving.Request(prompt, 4))
    assert src.kv.reserve(0, prompt_len)
    seq.slot = 0
    with torch.inference_mode():
        src._run_prefill_chunk(seq, 0, prompt_len, prompt_len - 1)
    dst = dtt.fleet.DecodeReplica("decode-t", programs, max_slots=8,
                                  block_size=16, max_len=LM["max_len"])
    assert dst.kv.reserve(3, 160) and dst.kv.reserve(0, prompt_len)
    pack, install = [], []
    for _ in range(5):
        torch.cuda.synchronize()
        t = time.perf_counter()
        payload = handoff.pack_kv(src.kv, 0, prompt_len, tokens=prompt)
        pack.append(time.perf_counter() - t)
        t = time.perf_counter()
        handoff.install_kv(dst.kv, 0, payload)
        torch.cuda.synchronize()
        install.append(time.perf_counter() - t)
    sids = src.kv._slot_blocks[0]
    dids = dst.kv._slot_blocks[0][:len(sids)]
    same = all(torch.equal(a[sids].view(torch.int16),
                           b[dids].view(torch.int16))
               for (_, a), (_, b) in zip(
                   dtt.interop.iter_leaf_paths(src.kv.caches),
                   dtt.interop.iter_leaf_paths(dst.kv.caches)))
    back, dtype = handoff._gather(dst.kv, dids)
    bits = (dtype == payload.dtype == "bfloat16"
            and all(np.array_equal(back[k], v)
                    for k, v in payload.blocks.items()))
    mb = payload.nbytes / 1e6
    print(f"  (z4) handoff of one {prompt_len}-token prompt: "
          f"{len(payload.blocks)} leaves x {len(sids)} blocks, "
          f"{payload.nbytes} bytes ({payload.dtype} as uint16 bits), pack "
          f"median {np.median(pack) * 1e3:.2f} ms ({mb / np.median(pack):.0f}"
          f" MB/s), install median {np.median(install) * 1e3:.2f} ms "
          f"({mb / np.median(install):.0f} MB/s), host clock around a "
          f"synchronized card, 5 rounds")
    print(f"  (z4c) bf16 payload installed into other blocks of another "
          f"full-width pool: bit for bit {same}; payload bits round-trip "
          f"{bits}")
    if not (same and bits):
        raise SystemExit("a bf16 handoff changed the blocks' bits")
    return payload.nbytes, float(np.median(pack)), float(np.median(install))


def fleet_memory(torch, dtt, fl):
    """(z4) A spawned replica killed and another retired: the device
    memory the pools held is returned (the caching allocator's
    ``memory_allocated``, which counts live tensors)."""
    import gc

    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    rep = fl._spawn(0.0)
    one = pool_bytes(rep.kv)
    spawned = torch.cuda.memory_allocated()
    rep.kill(0.0)
    fl._retire(rep.name, 0.0)
    del rep
    gc.collect()
    killed = torch.cuda.memory_allocated()
    fl._configured_decode = len(fl.decode_pool) - 1
    fl._reconcile(0.0)
    gc.collect()
    retired = torch.cuda.memory_allocated()
    print(f"  (z4) device memory: {before} B before the spawn, {spawned} B "
          f"after it (a pool is {one} B), {killed} B after the kill, "
          f"{retired} B after a retire")
    if abs(killed - before) >= one or before - retired < one // 2:
        raise SystemExit("a killed or retired replica's pool stayed on the "
                         "card")


def gossip_requests(n=3, shared_len=64, seed=11):
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, VOCAB, shared_len).astype(np.int32)
    return [(np.concatenate([shared, rng.integers(0, VOCAB, 8 + i).astype(
        np.int32)]), 24) for i in range(n + 1)]


def phase_fleet(torch, dtt, paged_ops, reqs, fused_c, small, sreqs,
                small_fused):
    """z4: the serving fleet at full width through K1, exact runs at 2
    layers, a bf16 handoff's bits, and the pools' memory; returns K1's
    launches in the full-width run."""
    model = dtt.Model(dtt.models.transformer_lm(
        VOCAB, dtype="bfloat16", **LM))
    model.build((LM["max_len"],), seed=0)
    programs = dtt.fleet.EnginePrograms(model, decode_kernel="fused")
    fleet_run(dtt, model, programs, requests(2, (8, 16), (4, 4), seed=1))
    arrivals = [0.05 * (i // 4) for i in range(len(reqs))]
    paged_ops.reset_launch_counts()
    fl, outs, wall = fleet_run(dtt, model, programs, reqs, arrivals)
    k1 = paged_ops.launches["paged_attention"]
    tel = fl.last_run_telemetry
    fleet_report("GPT-2-small fleet (2 decode + 1 prefill replicas, fused)",
                 tel, wall)
    check_outputs(outs, reqs, VOCAB)
    share, first = agreement(outs, fused_c, reqs)
    print(f"  K1 launches {k1} (decode steps {tel['decode_steps']} x "
          f"{LM['num_layers']} layers); agreement with phase c's Engine "
          f"{share:.4f}, first tokens {'match' if first else 'DIFFER'}")
    if not first:
        raise SystemExit("the fleet's first tokens differ from phase c's")
    if k1 == 0 or k1 != tel["decode_steps"] * LM["num_layers"]:
        raise SystemExit("the fleet did not launch K1 once per layer and "
                         "decode step")
    if (tel["lost_requests"] or tel["handoffs"]["installed"] != len(reqs)
            or tel["handoffs"]["fallback_reprefill"]):
        raise SystemExit("the fleet lost a request or a handoff")
    handoff_timing(torch, dtt, model, programs)
    fleet_memory(torch, dtt, fl)
    del fl, model, programs
    torch.cuda.empty_cache()

    print("  (z4b) 2 layers, f32, TF32 off: each fleet token-exact against "
          "the fused Engine")
    sprog = dtt.fleet.EnginePrograms(small, decode_kernel="fused")
    runs = [("transfer", {}), ("transfer='none'", dict(transfer="none")),
            ("replica_kill decode-1 at step 3", dict(
                fault=dtt.resilience.FaultInjector(
                    "replica_kill", replica="decode-1", at_step=3)))]
    for label, kw in runs:
        fl, got, _ = fleet_run(dtt, small, sprog, sreqs, **kw)
        exact = all(np.array_equal(x, y) for x, y in zip(got, small_fused))
        tel = fl.last_run_telemetry
        print(f"    {label}: token-exact {exact}, handoffs installed "
              f"{tel['handoffs']['installed']} fallen back "
              f"{tel['handoffs']['fallback_reprefill']}, kills "
              f"{len(tel['decode_pool']['kills'])}, lost "
              f"{tel['lost_requests']}")
        if not exact or tel["lost_requests"]:
            raise SystemExit(f"fleet ({label}) differs from the Engine")
        if "fault" in kw and len(tel["decode_pool"]["kills"]) != 1:
            raise SystemExit("the replica kill did not fire")
    greqs = gossip_requests()
    want, _, _ = serve(dtt, small, greqs, decode_kernel="fused")
    fl = dtt.fleet.ServingFleet(
        small, programs=sprog, decode_replicas=2, prefill_replicas=0,
        max_slots=8, block_size=16, max_len=LM["max_len"],
        prefix_cache=True, prefix_gossip=True)
    got = list(fl.run([dtt.serving.Request(*greqs[0])]))
    got += fl.run([dtt.serving.Request(p, m) for p, m in greqs[1:]])
    g = fl.last_run_telemetry["gossip"]
    exact = all(np.array_equal(x, y) for x, y in zip(got, want))
    print(f"    prefix gossip (a warm request, then 3 sharing its 64-token "
          f"prefix): token-exact {exact}, adoptions {g['adoptions']} "
          f"({g['adopted_blocks']} blocks), stale {g['stale_rejected']}")
    if not exact or g["adoptions"] == 0:
        raise SystemExit("the gossiping fleet differs or never adopted")
    old = {k: v.clone() for k, v in small.params.items()}
    fl = dtt.fleet.ServingFleet(small, programs=sprog, decode_replicas=2,
                                prefill_replicas=1, max_slots=8,
                                block_size=16, max_len=LM["max_len"])
    version = fl.update_weights(moved(torch, old, 0.02))
    got = fl.run([dtt.serving.Request(p, m) for p, m in sreqs])
    want, _, _ = serve(dtt, small, sreqs, decode_kernel="fused")
    small.load_params(old)
    exact = all(np.array_equal(x, y) for x, y in zip(got, want))
    moved_share, _ = agreement(got, small_fused, sreqs)
    print(f"    update_weights (version {version}): token-exact against a "
          f"fresh Engine on the moved weights {exact} (agreement with the "
          f"old weights' tokens {moved_share:.4f})")
    if not exact:
        raise SystemExit("update_weights: the fleet differs from a fresh "
                         "Engine on the same weights")
    torch.cuda.empty_cache()
    return k1


# ----------------------------------------------------------------- phase z5
SERVE_MODEL = dict(vocab_size=VOCAB, **LM)


def dir_bytes(path):
    total = 0
    for root, _, files in os.walk(path):
        for f in files:
            try:
                total += os.path.getsize(os.path.join(root, f))
            except OSError:
                pass
    return total


def phase_service(torch, dtt):
    """z5: ServeService at GPT-2-small width (f32 layers) on this card: 2
    decode workers, 1 prefill worker, KV over /dev/shm; the streamed
    tokens against an in-process fleet built from the same spec; a decode
    worker killed mid-run; every worker gone at ``stop()``."""
    from distributed_tpu_torch.obs import cli as obs_cli
    from distributed_tpu_torch.serve_service import ServeService, ServeSpec
    from distributed_tpu_torch.utils.events import read_events

    spec = ServeSpec(model=dict(SERVE_MODEL), build_len=LM["max_len"],
                     max_slots=8, block_size=16, max_len=LM["max_len"])
    sreqs = requests(8, (32, 256), (32, 64), seed=5)

    def batch():
        return [dtt.serving.Request(p, m, seed=0) for p, m in sreqs]

    model = dtt.Model(dtt.models.transformer_lm(**spec.model))
    model.compile(optimizer=spec.optimizer, loss=spec.loss)
    model.build((spec.build_len,), seed=0)
    programs = dtt.fleet.EnginePrograms(model, seed=spec.seed)
    ref = dtt.fleet.ServingFleet(
        model, programs=programs, decode_replicas=2, prefill_replicas=1,
        max_slots=spec.max_slots, block_size=spec.block_size,
        max_len=spec.max_len).run(batch())
    del model, programs
    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="chip-z5-")
    log = os.path.join(tmp, "events.jsonl")
    os.environ["DTPU_EVENT_LOG"] = log
    peak = [0]

    def sample(svc):
        if svc._shm_root is not None:
            peak[0] = max(peak[0], dir_bytes(svc._shm_root))

    svc = ServeService(spec, decode_replicas=2, prefill_replicas=1,
                       transport="shm", log_dir=tmp)
    try:
        t = time.perf_counter()
        svc.start()
        print(f"  3 workers ready in {time.perf_counter() - t:.1f} s; spawn "
              f"to hello: " + ", ".join(
                  f"{h.name} {h.spinup_s:.1f} s"
                  for h in sorted(svc._handles.values(),
                                  key=lambda h: h.name)))
        res = svc.run(batch(), on_pump=sample, deadline_s=300)
        tel = res.telemetry
        ttft = tel["time_to_first_token"]
        exact = all(np.array_equal(x, y) for x, y in zip(res, ref))
        stats = svc.collect_stats()
        installed = sum(s.get("handoffs_installed", 0)
                        for s in stats.values())
        payload = sum(-(-p.size // 16) for p, _ in sreqs) * 16 * (
            2 * LM["num_layers"] * LM["d_model"] * 4)
        print(f"  8 requests over shm: {tel['generated_tokens']} tokens in "
              f"{tel['wall_s']:.2f} s wall, {tel['tokens_per_sec']:.1f} "
              f"tokens/s (wall clock), TTFT p50 {ttft['p50_s'] * 1e3:.0f} ms "
              f"p99 {ttft['p99_s'] * 1e3:.0f} ms (wall); handoffs installed "
              f"{installed}; payloads {payload} B in all, /dev/shm peak "
              f"{peak[0]} B; token-exact against the in-process fleet "
              f"{exact}")
        if not exact or installed != len(sreqs) or tel["lost_requests"]:
            raise SystemExit("the service's tokens differ from the fleet's, "
                             "or a handoff or request was lost")
        killed = []
        base = svc.streamed_tokens

        def kill_once(svc):
            if not killed and svc.streamed_tokens >= base + 40:
                svc.kill_replica("decode-1")
                killed.append(svc.streamed_tokens - base)

        res = svc.run(batch(), on_pump=kill_once, deadline_s=300)
        exact = all(np.array_equal(x, y) for x, y in zip(res, ref))
        svc.wait_ready()  # the replacement's hello, if the run outpaced it
        procs = [h.proc for h in svc._handles.values()]
        respawned = sorted(f"{h.name} {h.spinup_s:.1f} s"
                           for h in svc._handles.values()
                           if h.name not in ("decode-0", "decode-1",
                                             "prefill-0"))
        print(f"  decode-1 killed after {killed[0] if killed else 0} "
              f"streamed tokens: token-exact {exact}, kills {svc.kills}, "
              f"lost {res.telemetry['lost_requests']}, respawned "
              f"{respawned}")
        svc.stop()
        codes = [p.wait(timeout=30) for p in procs]
        print(f"  stop(): worker exit codes {codes}")
        if not exact or svc.kills != 1 or res.telemetry["lost_requests"]:
            raise SystemExit("the killed worker's requests were not "
                             "recovered token-exact")
        if any(c != 0 for c in codes):
            raise SystemExit("a worker did not exit cleanly at stop()")
        post = obs_cli.summarize(read_events(log))
        dumps = post["flight_dumps"]
        if not dumps or not dumps[0]["readable"]:
            raise SystemExit("the killed worker left no readable flight "
                             "dump")
        print(f"  decode-1's flight dump (reason {dumps[0]['reason']!r}, "
              f"{len(dumps[0]['records'])} records), its last 3:")
        for rec in dumps[0]["records"][-3:]:
            print(f"    {json.dumps(rec, sort_keys=True)}")
    finally:
        svc.stop()
        os.environ.pop("DTPU_EVENT_LOG", None)
        shutil.rmtree(tmp, ignore_errors=True)


# ------------------------------------------------------------ phases z6-z8
def recording(engine, outs):
    """``engine`` with its ``run`` outputs appended to ``outs``."""
    run = engine.run

    def wrapped(reqs, **kw):
        got = run(reqs, **kw)
        outs.append(got)
        return got

    engine.run = wrapped
    return engine


def counted(mods, counts, run):
    """``run()``, its wrappers' launches added to ``counts``."""
    before = launch_counts(mods)
    out = run()
    for k, v in launch_counts(mods).items():
        counts[k] = counts.get(k, 0) + v - before.get(k, 0)
    return out


def sample_tie(torch, module, engine_seed, req, got, want):
    """Where two sampled rollouts of ``req`` first part: the engine's
    sampling score ``logits / T + gumbel`` (T = 1) of both tokens there,
    from one f32-logit forward of the common prefix through ``module``
    (eval, this card) and the token's own noise (the engine's key for
    it). Returns (position, the score gap, whether the two are the top
    two, whether the gap is within bf16's ``TOL`` of the logit: a
    rounding tie, not a fault)."""
    from distributed_tpu_torch.serving import engine as engine_lib
    from distributed_tpu_torch.utils import threefry

    pos = int(np.nonzero(got != want)[0][0])
    prefix = torch.from_numpy(want[None, :pos].astype(np.int64)).cuda()
    with torch.inference_mode():
        logits = module(prefix)[0, -1].float()
    key = engine_lib._token_key(engine_lib._mix_seed(engine_seed, req.seed),
                                pos - req.prompt.size)
    score = logits + threefry.gumbel_from_bits(threefry.row_bits(
        key[None], logits.shape[-1], logits.device))[0]
    a, b = int(want[pos]), int(got[pos])
    top2 = set(torch.topk(score, 2).indices.tolist()) == {a, b}
    gap = abs(float(score[a] - score[b]))
    return pos, gap, top2, gap <= TOL["bfloat16"] * max(
        1.0, abs(float(logits[a])))


def phase_posttrain(torch, dtt, mods, iterations=2):
    """z6: PostTrainer at GPT-2-small width (bf16 layers) over a sampling
    Engine through K1, ``fused_adam`` (K11), ``AdaptiveKLCoef``; the
    default ``train_len`` (1,024) takes the flash kernels in ``fit``.
    Each iteration's rollouts against a fresh reference-read-path Engine
    on the same snapshot and requests; then ``bench.py:bench_rl``'s own
    small configuration, whose reward must rise every iteration."""
    from distributed_tpu_torch import rl
    from distributed_tpu_torch.rl.loop import request_seed

    torch.cuda.reset_peak_memory_stats()
    model = dtt.Model(dtt.models.transformer_lm(VOCAB, dtype="bfloat16",
                                                **LM))
    model.build((LM["max_len"],), seed=0)
    kw = dict(max_slots=16, block_size=16, max_len=LM["max_len"],
              temperature=1.0)
    outs = []
    engine = recording(dtt.serving.Engine(model, decode_kernel="fused",
                                          **kw), outs)
    pt = rl.PostTrainer(model, engine, kl_coef=dtt.optim.AdaptiveKLCoef(),
                        optimizer=dtt.optim.fused_adam(1e-5))
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, VOCAB, (int(n),)).astype(np.int32)
               for n in rng.integers(32, 65, 8)]
    samples, new = 4, 64
    counts, rows = {}, []
    for it in range(1, iterations + 1):
        reqs = [dtt.serving.Request(p, new, seed=request_seed(
            pt.seed, pt.iteration + 1, pi, si))
            for pi, p in enumerate(prompts) for si in range(samples)]
        ref = dtt.serving.Engine(model, decode_kernel="reference", **kw)
        want = ref.run(reqs)
        row = counted(mods, counts, lambda: pt.iterate(
            prompts, num_samples=samples, max_new_tokens=new))
        got = outs[-1]
        same = [np.array_equal(a, b) for a, b in zip(got, want)]
        # Every rollout that differs is held to the sampling score where
        # it parts: the reference engine's snapshot holds the weights both
        # sampled from (the model has moved on).
        ties = {i: sample_tie(torch, ref._target.module, engine.seed,
                              reqs[i], got[i], want[i])
                for i, ok in enumerate(same) if not ok}
        del ref
        rows.append(row)
        print(f"  iteration {it}: reward {row['reward_mean']:.6f}, loss "
              f"{row['loss']:.6f}, KL {row['kl']:.3e}, kl_coef "
              f"{row['kl_coef']:.5f}, rollout {row['rollout_tokens_per_sec']:.1f}"
              f" tokens/s, train {row['train_s']:.3f} s, weight sync "
              f"{row['weight_sync_s'] * 1e3:.1f} ms, version "
              f"{row['weights_version']}; rollouts token-exact against the "
              f"reference read path: first {same[0]}, {sum(same)} of "
              f"{len(same)}; the {len(ties)} that part, each at a bf16 "
              f"tie of its sampling score: "
              f"{sum(t[2] and t[3] for t in ties.values())}")
        for i, (pos, gap, top2, tie) in ties.items():
            print(f"    rollout {i} parts at position {pos}: score gap "
                  f"{gap:.3e}, both the top two {top2}, a bf16 tie {tie}")
            if not (top2 and tie):
                raise SystemExit(f"iteration {it}: rollout {i} differs "
                                 "from the reference read path's at a "
                                 "token that is no rounding tie")
        if row["weights_version"] != it or not math.isfinite(row["kl"]):
            raise SystemExit(f"iteration {it}: weights_version "
                             f"{row['weights_version']}, KL {row['kl']}")
    peak = torch.cuda.max_memory_allocated() / 1e9
    print(f"  launches in the {iterations} iterations {counts}; peak memory "
          f"{peak:.2f} GB")
    for name in ("paged_attention", "flash_fwd", "flash_dq", "flash_dkv",
                 "fused_adam"):
        if not counts.get(name):
            raise SystemExit(f"post-training never launched {name}")
    del pt, engine, model, outs
    torch.cuda.empty_cache()

    # bench.py:bench_rl's configuration (lm_l4_d256, f32, the reference
    # read path, Adam(1e-3), kl 0.01, 4 iterations).
    small = dtt.Model(dtt.models.transformer_lm(
        512, num_layers=4, d_model=256, num_heads=8, max_len=128))
    small.compile(optimizer="adam", loss="sparse_categorical_crossentropy")
    small.build((32,))
    eng = dtt.serving.Engine(small, 8, 16, max_len=128, temperature=1.0,
                             seed=0)
    bench = rl.PostTrainer(small, eng,
                           reward_fn=rl.length_penalized_logprob(0.0),
                           learning_rate=1e-3, kl_coef=0.01, seed=0)
    brng = np.random.default_rng(0)
    bprompts = [brng.integers(0, 512, (8,)).astype(np.int32)
                for _ in range(8)]
    brows = bench.train(bprompts, iterations=4, num_samples=4,
                        max_new_tokens=32)
    rewards = [r["reward_mean"] for r in brows]
    print(f"  bench_rl's configuration: rewards {rewards}, rollout "
          f"tokens/s {[r['rollout_tokens_per_sec'] for r in brows]}, weight "
          f"sync ms {[round(r['weight_sync_s'] * 1e3, 2) for r in brows]}")
    if any(b <= a for a, b in zip(rewards, rewards[1:])):
        raise SystemExit(f"bench_rl: the reward did not rise every "
                         f"iteration: {rewards}")
    del bench, eng, small
    torch.cuda.empty_cache()
    return counts


def distill_round(dtt, engine, draft, prompts, new, lr):
    """Acceptance before, ``DraftDistiller.fit(rounds=2, epochs=8)``,
    acceptance after; returns (rows, before, after, tokens after)."""
    from distributed_tpu_torch import rl

    def accept():
        outs = engine.run([dtt.serving.Request(p, new) for p in prompts])
        return outs, engine.last_run_telemetry["speculative"]["accept_rate"]

    _, before = accept()
    rows = rl.DraftDistiller(engine, draft, learning_rate=lr).fit(
        prompts, max_new_tokens=new, rounds=2, epochs=8)
    outs, after = accept()
    return rows, before, after, outs


def phase_distill(torch, dtt, mods, reqs, small):
    """z7: DraftDistiller on phase s's GPT-2-small target (bf16) and its
    6-layer truncated draft in a greedy speculative Engine (spec_k 4,
    fused): accept rate on phase c's 16 prompts before and after 2 rounds
    of 8 epochs; then the same at phase d's f32 2-layer width with a
    1-layer draft, whose tokens must equal plain greedy decode's."""
    target = dtt.Model(dtt.models.transformer_lm(VOCAB, dtype="bfloat16",
                                                 **LM))
    target.build((LM["max_len"],), seed=0)
    draft = truncated_draft(dtt, target, LM["num_layers"] // 2,
                            dtype="bfloat16", seed=1)
    engine = dtt.serving.Engine(target, max_slots=8, block_size=16,
                                max_len=LM["max_len"], decode_kernel="fused",
                                draft_model=draft, spec_k=4)
    prompts = [p for p, _ in reqs]
    counts = {}
    t = time.perf_counter()
    rows, before, after, outs = counted(mods, counts, lambda: distill_round(
        dtt, engine, draft, prompts, 64, 3e-4))
    wall = time.perf_counter() - t
    plain, _, _ = serve(dtt, target, [(p, 64) for p in prompts],
                        decode_kernel="fused")
    share, _ = agreement(outs, plain, [(p, 64) for p in prompts])
    for r in rows:
        print(f"  round {r['round']}: loss {r['loss_first']:.4f} -> "
              f"{r['loss_last']:.4f} over {r['epochs']} epochs of "
              f"{r['num_rollouts']} rollouts, train {r['train_s']:.2f} s")
    print(f"  accept rate {before:.4f} before, {after:.4f} after; draft "
          f"staleness {engine._draft_staleness}; agreement with plain "
          f"greedy (bf16) {share:.4f}; {wall:.1f} s; launches {counts}")
    if any(r["loss_last"] >= r["loss_first"] for r in rows):
        raise SystemExit("distillation did not lower the draft's loss")
    if engine._draft_staleness != 0:
        raise SystemExit("the draft is stale after the distiller's sync")
    del engine, draft, target
    torch.cuda.empty_cache()

    sdraft = truncated_draft(dtt, small, 1, seed=3)
    sengine = dtt.serving.Engine(small, max_slots=8, block_size=16,
                                 max_len=LM["max_len"], decode_kernel="fused",
                                 draft_model=sdraft, spec_k=4)
    sprompts = [p for p, _ in requests(8, (32, 256), (16, 32), seed=2)]
    srows, sbefore, safter, souts = distill_round(dtt, sengine, sdraft,
                                                  sprompts, 32, 1e-3)
    splain, _, _ = serve(dtt, small, [(p, 32) for p in sprompts],
                         decode_kernel="fused")
    exact = all(np.array_equal(a, b) for a, b in zip(souts, splain))
    print(f"  2 layers, f32: loss {srows[0]['loss_first']:.4f} -> "
          f"{srows[-1]['loss_last']:.4f}, accept rate {sbefore:.4f} -> "
          f"{safter:.4f}, token-exact against plain greedy decode {exact}")
    if not exact or srows[-1]["loss_last"] >= srows[0]["loss_first"]:
        raise SystemExit("f32 distilled speculation is not token-exact, or "
                         "its loss did not fall")
    return counts


def write_image_shards(dtt, path, n=2560, size=224, classes=1000, seed=0):
    """``n`` random uint8 images (size x size x 3) and labels as a
    FileSource shard set, 512 rows a shard; returns the bytes written."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 256, (n, size, size, 3), dtype=np.uint8)
    y = rng.integers(0, classes, n).astype(np.int32)
    dtt.data.write_shards(path, x, y, rows_per_shard=512)
    return x.nbytes


def same_stream(a, b, steps):
    """True when two pipelines emit the same bytes for ``steps`` batches."""
    for _ in range(steps):
        (xa, ya), (xb, yb) = next(a), next(b)
        if xa.tobytes() != xb.tobytes() or ya.tobytes() != yb.tobytes():
            return False
    return True


def zlib_records(dtt, path, n=8192, seed=0):
    """mnist-sized images (28 x 28, a label byte first) as zlib-compressed
    records; returns the decoder."""
    import zlib

    x, y = dtt.data.synthetic_images(n, (28, 28), 10, seed)
    dtt.data.write_records(path, (zlib.compress(bytes([int(c)]) + r.tobytes())
                                  for r, c in zip(x, y)),
                           records_per_shard=2048)

    def decode(b):
        raw = zlib.decompress(b)
        return (np.frombuffer(raw, np.uint8, offset=1).reshape(28, 28, 1)
                .astype(np.float32), raw[0])

    return decode


def phase_data_tiers(torch, dtt, mods, batch=256, steps=10):
    """z8: scripts/torch_imagenet_resnet.py's model (RandomCrop + RandomFlip
    + bf16 ResNet-50) fitted from ``Pipeline(dir)`` on the native ring over
    a FileSource of 2,560 224x224x3 images (the stream held to the Python
    path's), then mnist_cnn from zlib records at decode_workers 0 and 4."""
    from distributed_tpu_torch.utils import threefry

    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import torch_imagenet_resnet as recipe

    tmp = tempfile.mkdtemp(prefix="chip-z8-")
    try:
        t = time.perf_counter()
        nbytes = write_image_shards(dtt, os.path.join(tmp, "images"))
        print(f"  FileSource of {nbytes // (224 * 224 * 3)} images, "
              f"{nbytes} B in 5 shards, "
              f"written in {time.perf_counter() - t:.1f} s")
        shard_dir = os.path.join(tmp, "images")
        ring = dtt.data.Pipeline(shard_dir, batch_size=batch, prefetch=8,
                                 num_threads=4)
        plain = dtt.data.Pipeline(shard_dir, batch_size=batch,
                                  use_native=False)
        t = time.perf_counter()
        bits = same_stream(ring, plain, steps)
        cmp_s = time.perf_counter() - t
        print(f"  the ring (is_native {ring.is_native}) against the Python "
              f"path: {steps} batches bit-identical {bits} ({cmp_s:.1f} s "
              f"for both)")
        if not (ring.is_native and bits):
            raise SystemExit("the native ring did not run, or its stream "
                             "differs from the Python path's")
        ring.close()
        plain.close()
        model = recipe.compile_recipe(
            dtt.Model(recipe.augmented_resnet50()), batch=batch, epochs=1,
            steps_per_epoch=steps)
        model.build((224, 224, 3))
        source = dtt.data.Pipeline(shard_dir, batch_size=batch, prefetch=8,
                                   num_threads=4)
        model.fit(source, epochs=1, steps_per_epoch=2, verbose=0)  # warm-up
        counts = {}
        secs = wall_s(torch, lambda: counted(mods, counts, lambda: model.fit(
            source, epochs=1, steps_per_epoch=steps, verbose=0)))
        tel = model.last_fit_telemetry
        crop, flip = model.module.layers[:2]
        xb = torch.from_numpy(next(source)[0]).cuda()
        key = threefry.device_key(threefry.PRNGKey(1), "cuda")
        crop.train()
        flip.train()
        with dtt.nn.rng_scope(key):
            aug_ms = cuda_ms(torch, lambda i: flip(crop(xb)), 10)
        step_ms = secs / steps * 1e3
        print(f"  {steps} steps at batch {batch}: {batch * steps / secs:.1f} "
              f"images/s, {step_ms:.1f} ms a step, input_stall_fraction "
              f"{tel['input_stall_fraction']}, augmentation {aug_ms:.3f} ms "
              f"of device time a batch ({aug_ms / step_ms:.2%} of the "
              f"step); launches {counts}")
        for name in ("conv1x1", "bn_stats", "bn_bwd_reduce"):
            if not counts.get(name):
                raise SystemExit(f"the recipe never launched {name}")
        source.close()
        del model, xb
        torch.cuda.empty_cache()

        decode = zlib_records(dtt, os.path.join(tmp, "records"))
        src = dtt.data.RecordSource(os.path.join(tmp, "records"), decode)
        streams = [dtt.data.Pipeline(src, batch_size=batch, scale=1 / 255,
                                     decode_workers=w) for w in (0, 4)]
        bits = same_stream(*streams, 32)
        for s in streams:
            s.close()
        for w in (0, 4):
            m = dtt.Model(dtt.models.mnist_cnn())
            m.compile(optimizer=dtt.optim.SGD(0.001),
                      loss="sparse_categorical_crossentropy")
            m.build((28, 28, 1), seed=0)
            pipe = dtt.data.Pipeline(src, batch_size=batch, scale=1 / 255,
                                     decode_workers=w)
            m.fit(pipe, epochs=1, steps_per_epoch=2, verbose=0)
            secs = wall_s(torch, lambda: m.fit(pipe, epochs=1,
                                               steps_per_epoch=32, verbose=0))
            print(f"  mnist_cnn from zlib records, decode_workers {w}: "
                  f"{32 / secs:.1f} steps/s, input_stall_fraction "
                  f"{m.last_fit_telemetry['input_stall_fraction']}")
            pipe.close()
        print(f"  decode_workers 0 and 4: 32 batches bit-identical {bits}")
        if not bits:
            raise SystemExit("the record streams differ between worker "
                             "counts")
        src.close()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return counts


# ------------------------------------------------------------------ phase z9
def r_local_losses(torch_r_sim, device=None):
    """``r/distributedtputorch/examples/local.R`` in a fresh simulated R
    session (``tests/torch_r_sim.py``) on ``device`` (None: the R option
    unset, device = NULL, this card); returns (the Python model, the
    epoch losses that came back to R)."""
    interp = torch_r_sim.TorchInterp(device=device)
    hist = interp.run_file(os.path.join(torch_r_sim.EXAMPLES, "local.R"))
    interp.global_env.define("hist", hist)
    losses = interp.run_source("hist$metrics$loss").values
    return interp.global_env.lookup("model").value._obj, list(losses)


def profiler_hooks(torch, model):
    """``utils.profiler`` on the card: the allocator's stats, then a
    ``trace()`` around an ``annotate`` region that holds a predict of
    ``model`` on 64 images. Returns (the stats, the trace files written,
    whether the annotation is in them, their kernel events)."""
    from distributed_tpu_torch.utils import profiler as prof

    stats = prof.device_memory_stats()
    tmp = tempfile.mkdtemp(prefix="chip-z9-")
    try:
        with prof.trace(tmp):
            with prof.annotate("z9-predict"):
                model.predict(np.zeros((64, 28, 28, 1), np.float32),
                              batch_size=64)
        texts = [open(os.path.join(tmp, f)).read() for f in os.listdir(tmp)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return (stats, len(texts), any("z9-predict" in t for t in texts),
            sum(t.count('"cat": "kernel"') for t in texts))


def profiler_hooks_fresh():
    """:func:`profiler_hooks` in a process of its own, on local.R's
    model (``mnist_cnn``, compiled as local.R compiles it, seed 0)."""
    import torch

    import distributed_tpu_torch as dtt

    model = dtt.Model(dtt.models.mnist_cnn(10))
    model.compile(optimizer=dtt.optim.get("sgd", learning_rate=0.001),
                  loss="sparse_categorical_crossentropy",
                  metrics=["accuracy"])
    model.build((28, 28, 1), seed=0)
    return profiler_hooks(torch, model)


def phase_lint_and_r(torch, mods):
    """z9: the port's linter (``dtt-lint``) over ``distributed_tpu_torch/``
    on this machine, which must find nothing; then the port's R binding:
    ``local.R`` through the simulated R runtime with device = NULL, so
    mnist_cnn trains its 15 steps on this card, held to the same script on
    the CPU (TF32 off: the same weights from seed 0, the same batches);
    then ``utils.profiler``'s hooks on the card (:func:`profiler_hooks`)
    in this process and in a fresh one, whose trace must hold kernel
    events. Returns the launches of every kernel the card's run
    reached."""
    from distributed_tpu_torch.analysis import cli as lint_cli
    from distributed_tpu_torch.analysis import core as lint_core

    t = time.perf_counter()
    rc = lint_cli.main([os.path.join(ROOT, "distributed_tpu_torch")])
    print(f"  {len(lint_core.rule_names())} rules "
          f"({', '.join(lint_core.rule_names())}); exit code {rc}; "
          f"{time.perf_counter() - t:.2f} s with the interpreter's imports")
    if rc != 0:
        raise SystemExit("the port's linter found violations in "
                         "distributed_tpu_torch/")
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import torch_r_sim

    counts, out = {}, {}
    t = time.perf_counter()
    busy, ops = busy_ms(torch, lambda: counted(
        mods, counts, lambda: out.update(card=r_local_losses(torch_r_sim))))
    card_s = time.perf_counter() - t
    model, losses = out["card"]
    print(f"  local.R on the card: {card_s:.1f} s (the data, the session and "
          f"15 steps, under the profiler), the card busy {busy:.1f} ms over "
          f"{ops} operations; device {model.device}, step {model.step}; "
          f"losses {losses}; launches of the port's kernels "
          f"{ {k: n for k, n in counts.items() if n} or 'none'}")
    t = time.perf_counter()
    cpu_model, cpu_losses = r_local_losses(torch_r_sim, device="cpu")
    print(f"  local.R on the CPU: {time.perf_counter() - t:.1f} s; losses "
          f"{cpu_losses}")
    gap = max(abs(a - b) / abs(b) for a, b in zip(losses, cpu_losses))
    print(f"  card against CPU: largest relative loss gap {gap:.3e} "
          f"(limit 1e-4)")
    if (model.device.type != "cuda" or model.step != 15
            or cpu_model.step != 15 or len(losses) != 3
            or not all(math.isfinite(v) for v in losses) or gap > 1e-4):
        raise SystemExit("local.R did not train its 15 steps on the card, "
                         "or its losses differ from the CPU's")
    stats, files, annotated, kernels = profiler_hooks(torch, model)
    print(f"  utils.profiler in this process: device_memory_stats {stats}; "
          f"trace() wrote {files} file(s), the annotation "
          f"{'in it' if annotated else 'MISSING'}, {kernels} kernel events")
    if not (stats and 0 < stats["bytes_in_use"] <= stats["peak_bytes_in_use"]
            < stats["bytes_limit"] and files == 1 and annotated):
        raise SystemExit("the profiler hooks did not read the card or "
                         "write the trace")
    # Where the card's kernel stamps lag the host clock more as a process
    # ages (a gVisor sandbox), the profiler drops a short block's kernels
    # late in a long run as earlier than the capture (see
    # scripts/torch_profiler_clock.py): a fresh process must keep them.
    run = subprocess.run(
        [sys.executable, "-c", "import json, chip_smoke; print('Z9PROF', "
         "json.dumps(chip_smoke.profiler_hooks_fresh()))"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    line = [ln for ln in run.stdout.splitlines() if ln.startswith("Z9PROF ")]
    if run.returncode != 0 or not line:
        raise SystemExit(f"the fresh process's profiler check failed "
                         f"(exit {run.returncode}):\n{run.stderr[-4000:]}")
    stats, files, annotated, kernels = json.loads(line[0][len("Z9PROF "):])
    print(f"  utils.profiler in a fresh process: device_memory_stats "
          f"{stats}; trace() wrote {files} file(s), the annotation "
          f"{'in it' if annotated else 'MISSING'}, {kernels} kernel events")
    if not (stats and 0 < stats["bytes_in_use"] <= stats["peak_bytes_in_use"]
            < stats["bytes_limit"] and files == 1 and annotated
            and kernels > 0):
        raise SystemExit("trace() did not record the card's kernels in a "
                         "fresh process")
    del model, cpu_model
    torch.cuda.empty_cache()
    return counts


# ----------------------------------------------------------------- phase z10
#: Pythia-160M's widths (EleutherAI's ``pythia-160m`` config).
PYTHIA = dict(vocab=50304, num_layers=12, d_model=768, num_heads=12,
              d_ff=3072)


def pythia_lm(dtt, num_layers=PYTHIA["num_layers"], dtype=None):
    """Pythia-160M's widths with GPT-NeoX's parallel residual
    (``use_parallel_residual``), ``x + attn(ln1(x)) + mlp(ln2(x))``, from
    the repo's layers: ``Residual(main=Residual(Sequential([LayerNorm,
    Dense(gelu, col), Dense(row)])), shortcut=Sequential([LayerNorm,
    MultiHeadAttention]))``, the attention in the shortcut, so its KV pool
    is the shortcut's. Cut: a learned ``PositionalEmbedding`` of
    ``LM["max_len"]`` (1,024) rows in place of rotary (the repo has no
    rotary layer; Pythia reaches 2,048)."""
    nn = dtt.nn
    d = PYTHIA["d_model"]
    layers = [nn.Embedding(PYTHIA["vocab"], d, dtype=dtype),
              nn.PositionalEmbedding(LM["max_len"])]
    for _ in range(num_layers):
        mlp = nn.Sequential([
            nn.LayerNorm(),
            nn.Dense(PYTHIA["d_ff"], activation="gelu", shard="col",
                     dtype=dtype),
            nn.Dense(d, shard="row", dtype=dtype)])
        attn = nn.Sequential([
            nn.LayerNorm(),
            nn.MultiHeadAttention(PYTHIA["num_heads"], causal=True,
                                  dtype=dtype)])
        layers.append(nn.Residual(nn.Residual(mlp), shortcut=attn))
    return nn.Sequential(layers + [nn.LayerNorm(),
                                   nn.Dense(PYTHIA["vocab"], dtype=dtype)])


def first_token_difference(a, b):
    """(request, position) of the first token where two runs differ, or
    None."""
    for i, (x, y) in enumerate(zip(a, b)):
        if not np.array_equal(x, y):
            n = min(len(x), len(y))
            where = np.nonzero(x[:n] != y[:n])[0]
            return i, int(where[0]) if where.size else n
    return None


def shortcut_bytes(caches, under=False):
    """Bytes of the paged pool's leaves that sit below a ``shortcut``
    key."""
    if isinstance(caches, dict):
        return sum(shortcut_bytes(v, under or k == "shortcut")
                   for k, v in caches.items())
    return caches.numel() * caches.element_size() if under else 0


def phase_parallel_residual(torch, dtt, paged_ops, reqs, n=8, t_p=128,
                            new=128):
    """z10a: the Pythia-width parallel-residual LM served by the paged
    Engine, its attention's pool under the residual's shortcut. (i) f32:
    ``Engine(decode_kernel="fused")`` token-exact against ``Model.
    generate`` (the dense cache) on 8 requests of 128 + 128 tokens; (ii)
    bf16 layers: phase c's 16 requests through K1, then with int8 KV
    through K2 (tokens/s, TTFT, the pool's bytes with the shortcut's
    share); (iii) f32, ``spec_k=4`` with the first 6 blocks as the draft,
    4 requests, token-exact against (i). Returns K1's and K2's
    launches."""
    counts = {}
    f32 = dtt.Model(pythia_lm(dtt)).build((LM["max_len"],), seed=0)
    n_params = sum(p.numel() for p in f32.params.values())
    prompts = np.random.default_rng(5).integers(
        0, PYTHIA["vocab"], (n, t_p)).astype(np.int32)
    t = time.perf_counter()
    greedy = f32.generate(prompts, new, temperature=0.0)
    gen_s = time.perf_counter() - t
    ireqs = [(p, new) for p in prompts]
    paged_ops.reset_launch_counts()
    outs, tel, wall = serve(dtt, f32, ireqs, decode_kernel="fused")
    counts["paged_attention"] = paged_ops.launches["paged_attention"]
    diff = first_token_difference(list(greedy), outs)
    print(f"  (i) f32, {n_params / 1e6:.1f}M params: generate {n} x ({t_p} "
          f"+ {new}) in {gen_s:.2f} s; Engine (fused) "
          f"{tel['tokens_per_sec']:.1f} tokens/s, K1 launches "
          f"{counts['paged_attention']} ({tel['decode_steps']} decode steps"
          f" x {PYTHIA['num_layers']} layers); token-exact against "
          f"generate: {diff is None}"
          + ("" if diff is None else f" (first difference: request "
             f"{diff[0]}, position {diff[1]})"))
    if diff is not None:
        raise SystemExit("z10a (i): the Engine's greedy tokens differ from "
                         "generate's")
    if counts["paged_attention"] != tel["decode_steps"] * PYTHIA[
            "num_layers"]:
        raise SystemExit("z10a (i): K1 did not read the shortcut's pool "
                         "once per layer and decode step")
    draft = dtt.Model(pythia_lm(dtt, num_layers=PYTHIA["num_layers"] // 2))
    draft.build((LM["max_len"],), seed=1)
    own = f32.params
    draft.load_params({k: own[k] for k in draft.params})
    paged_ops.reset_launch_counts()
    souts, stel, _ = serve(dtt, f32, ireqs[:4], decode_kernel="fused",
                           draft_model=draft, spec_k=4)
    by_kw = launches_by_kw(paged_ops)
    counts["paged_attention"] += paged_ops.launches["paged_attention"]
    diff = first_token_difference(outs[:4], souts)
    spec = stel["speculative"]
    print(f"  (iii) f32 spec_k=4, 6-block draft: accept rate "
          f"{spec['accept_rate']:.4f}, rounds {spec['rounds']}, "
          f"{stel['tokens_per_sec']:.1f} tokens/s; K1 by kw {by_kw}; "
          f"token-exact against (i): {diff is None}")
    if diff is not None or not spec["rounds"]:
        raise SystemExit("z10a (iii): speculative tokens differ from (i)")
    if by_kw.get("paged_attention/kw4", 0) != PYTHIA["num_layers"] * spec[
            "rounds"]:
        raise SystemExit("z10a (iii): the verify did not read the "
                         "shortcut's pool at kw 4 once per layer and round")
    del f32, draft
    torch.cuda.empty_cache()

    bf = dtt.Model(pythia_lm(dtt, dtype="bfloat16")).build(
        (LM["max_len"],), seed=0)
    ref = None
    for kv, name in ((None, "paged_attention"),
                     ("int8", "paged_attention_int8")):
        engine = dtt.serving.Engine(
            bf, max_slots=8, block_size=16, max_len=LM["max_len"],
            decode_kernel="fused", kv_dtype=kv)
        paged_ops.reset_launch_counts()
        t = time.perf_counter()
        got = engine.run([dtt.serving.Request(p, m) for p, m in reqs])
        wall = time.perf_counter() - t
        launched = paged_ops.launches[name]
        counts[name] = counts.get(name, 0) + launched
        tel = engine.last_run_telemetry
        pool, sc = pool_bytes(engine.kv), shortcut_bytes(engine.kv.caches)
        check_outputs(got, reqs, PYTHIA["vocab"])
        report(f"(ii) bf16 layers, {kv or 'bf16'} KV", tel, wall)
        share = "" if ref is None else (
            f"; agreement with bf16 KV {agreement(got, ref, reqs)[0]:.4f}")
        print(f"    pool {pool / 1e6:.1f} MB, of it under 'shortcut' "
              f"{sc / 1e6:.1f} MB; {name} launches {launched}{share}")
        if launched != tel["decode_steps"] * PYTHIA["num_layers"] or \
                sc != pool or not sc:
            raise SystemExit(f"z10a (ii): {name} did not read the "
                             "shortcut's pool once per layer and step")
        ref = got if ref is None else ref
        del engine
    del bf
    torch.cuda.empty_cache()
    return counts


def inner_remat_lm(dtt, policy):
    """GPT-2-small (LM, bf16 layers) with ``scan=True``'s tree, its
    template's attention residual and MLP residual each wrapped in
    ``nn.Remat(policy=)`` (no ``Remat`` around the whole block)."""
    nn = dtt.nn
    d = LM["d_model"]

    def make_block():
        return nn.Sequential([
            nn.Remat(r, policy=policy) for r in
            dtt.models.transformer.transformer_block(
                d, LM["num_heads"], 4 * d, dtype="bfloat16")])

    return nn.Sequential([
        nn.Embedding(VOCAB, d, dtype="bfloat16"),
        nn.PositionalEmbedding(LM["max_len"]),
        nn.ScannedBlocks(make_block, LM["num_layers"]),
        nn.LayerNorm(), nn.Dense(VOCAB, dtype="bfloat16")],
        name="transformer_lm")


def phase_inner_remat(torch, dtt, mods, batch=32, steps=3):
    """z10b: phase v1's LM (GPT-2-small, bf16 layers, the pallas loss,
    batch 32 x 1024) with ``fused_adam(1e-4)`` (Adam through K11), for the
    default policy and ``dots_with_no_batch_dims_saveable``: the scanned
    template with a ``Remat`` around each residual against the unrolled
    ``transformer_lm(remat=True, remat_policy=)`` from the same weights
    (restacked), one warm-up and 3 timed steps each, losses and every
    parameter bit for bit; beside them the scanned twin with one ``Remat``
    around the whole block. ms a step and peak memory of each; the inner
    template's launches. Returns those launches."""
    t_len, layers = LM["max_len"], LM["num_layers"]
    x, y = lm_batch(batch, t_len)
    fit = dict(batch_size=batch, steps_per_epoch=1, shuffle=False,
               verbose=0)
    total = {}
    for policy in (None, REMAT_POLICY):
        un = None
        rows = {}
        for arm in ("unrolled", "inner", "outer"):
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            module = (inner_remat_lm(dtt, policy) if arm == "inner" else
                      dtt.models.transformer_lm(
                          VOCAB, dtype="bfloat16", remat=True,
                          remat_policy=policy, scan=arm == "outer", **LM))
            m = dtt.Model(module)
            m.compile(optimizer=dtt.optim.fused_adam(1e-4), loss=PALLAS,
                      metrics=[])
            m.build((t_len,), seed=0)
            if arm == "unrolled":
                un = m
                start = {k: v.detach().clone() for k, v in restack_blocks(
                    m.params, layers).items()}
            else:
                m.load_params(start)
            losses = m.fit(x, y, epochs=1, **fit).history["loss"]
            reset_counts(mods)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t = time.perf_counter()
            losses += m.fit(x, y, epochs=steps, **fit).history["loss"]
            torch.cuda.synchronize()
            ms = 1e3 * (time.perf_counter() - t) / steps
            peak = (torch.cuda.max_memory_allocated() - base) / 1e9
            counts = launch_counts(mods)
            rows[arm] = (losses, ms, peak, counts)
            if arm == "inner":
                for name, c in counts.items():
                    total[name] = total.get(name, 0) + c
            if arm != "unrolled":
                diff = first_difference(
                    torch, restack_blocks(un.params, layers), m.params)
                rows[arm] += (diff,)
                del m
            torch.cuda.empty_cache()
        del un
        torch.cuda.empty_cache()
        label = policy or "default"
        for arm, row in rows.items():
            losses, ms, peak, counts = row[:4]
            print(f"  {label}, {arm}: losses {[round(v, 5) for v in losses]},"
                  f" {ms:.1f} ms a step, peak {peak:.2f} GB, launches a step "
                  f"{ {k: c / steps for k, c in counts.items() if c} }")
        for arm in ("inner", "outer"):
            same = rows[arm][0] == rows["unrolled"][0]
            say_same(f"{label}, {arm} against unrolled: losses "
                     f"{'equal' if same else 'DIFFER'}; parameters",
                     rows[arm][4])
            if arm == "inner" and (not same or rows[arm][4] is not None):
                raise SystemExit("z10b: the inner-Remat template parts from "
                                 "the unrolled remat LM")
        want = {"flash_fwd", "flash_dq", "flash_dkv", "xent_fwd", "xent_bwd",
                "fused_adam"}
        if not all(rows["inner"][3].get(k) for k in want):
            raise SystemExit(f"z10b: launches {rows['inner'][3]} miss one of "
                             f"{sorted(want)}")
    return total


def phase_pipeline_predict(torch, dtt, conv_ops, n=1024, batch=256):
    """z10c: ResNet-50 (bf16) under ``DataParallel`` (NCCL, world 1)
    predicts 1,024 random uint8 images at batch 256 from ``Pipeline(
    shard="auto")``; the result must equal ``predict`` of the same rows as
    a host array bit for bit. At world 1 the pipeline reads whole (its
    ``shard`` is None), so this is the world-1 predict from a pipeline,
    not the gather of a sharded one (``scripts/torch_dp_scaling.py
    --predict``, 4 cards). Returns K12's launches."""
    nccl_world1(dtt)
    try:
        with dtt.DataParallel().scope():
            m = dtt.Model(dtt.models.resnet(50, 1000, dtype="bfloat16"))
        m.build((224, 224, 3), seed=0)
        x8 = np.random.default_rng(9).integers(
            0, 256, (n, 224, 224, 3), dtype=np.uint8)
        y = np.zeros((n,), np.int32)
        kw = dict(shuffle=False, use_native=False)
        with dtt.data.Pipeline(x8, y, batch, shard="auto", **kw) as pipe:
            shard = pipe.shard
            conv_ops.reset_launch_counts()
            torch.cuda.synchronize()
            t = time.perf_counter()
            got = m.predict(pipe)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            k12 = conv_ops.launches["conv1x1"]
        with dtt.data.Pipeline(x8, y, batch, **kw) as pipe:
            host = np.concatenate([next(pipe)[0] for _ in range(n // batch)])
        want = m.predict(host, batch_size=batch)
        same = bool(np.array_equal(got, want))
        print(f"  shard {shard or '(0, 1): one shard, read whole'}; logits "
              f"{got.shape} in {wall:.2f} s ({n / wall:.1f} images/s, the "
              f"pipeline's reads included); K12 launches {k12}; equal to "
              f"the host array's predict bit for bit: {same}")
        if not same or got.shape != (n, 1000) or not k12:
            raise SystemExit("z10c: predict from the pipeline differs from "
                             "the host array's")
    finally:
        dtt.cluster.shutdown()
    del m
    torch.cuda.empty_cache()
    return {"conv1x1": k12}


def phase_dropout_slices(torch, dtt, shape=(8, 1024, 768), keep=0.9,
                         dev="cuda"):
    """z10d: on the card, each rank's slice-only Dropout draw against its
    slice of the full-shape ``threefry.bernoulli`` mask, bit for bit, at
    phase v5's shape, for n = 2 and 4 ranks: TP's column block (through
    ``nn.Dropout`` paired after a column ``Dense``), the contiguous token
    chunk of the ring and of Ulysses (through ``nn.Dropout`` under a
    sequence split), and the zigzag schedule's two chunks (rank i's
    chunks i and 2n-1-i, through ``threefry.bernoulli_block``)."""
    from distributed_tpu_torch.parallel import collectives
    from distributed_tpu_torch.parallel.strategy import Strategy
    from distributed_tpu_torch.utils import threefry

    dev = torch.device(dev)
    key = threefry.device_key(threefry.PRNGKey(7), dev)
    full = threefry.bernoulli(key, keep, shape, dev)
    b, t_len, d = shape

    class Split(Strategy):
        """Rank ``r`` of ``n`` on a sequence or model line, no group."""

        def __init__(self, n, r, seq):
            self.n, self.r, self.seq, self.device = n, r, seq, dev

        @property
        def num_batch_shards(self):
            return self.n if self.seq else 1

        def seq_offset(self, t_local):
            return self.r * t_local

        def computes_block(self, layout):
            return True

    def layer_mask(layer, local, st):
        layer.train()
        with st.scope(), dtt.nn.rng_scope(key), torch.no_grad():
            return layer(torch.ones(local, device=dev)) != 0

    checks, slice_ms = 0, {}
    for n in (2, 4):
        for r in range(n):
            st = Split(n, r, seq=True)
            tl = t_len // n
            got = layer_mask(dtt.nn.Dropout(1 - keep), (b, tl, d), st)
            ok = torch.equal(got, full[:, r * tl:(r + 1) * tl])
            col = dtt.nn.Dense(d, shard="col")
            col.build((d,), torch.Generator().manual_seed(0))
            w = d // n
            col.kernel = torch.nn.Parameter(torch.empty((d, w), device=dev))
            collectives.mark(col.kernel, collectives.Layout(
                (d, d), 1, n, r, None, "model"))
            drop = dtt.nn.Dropout(1 - keep)
            dtt.nn.Sequential([col, drop, dtt.nn.Dense(d, shard="row")])
            got = layer_mask(drop, (b, t_len, w), Split(n, r, seq=False))
            ok &= torch.equal(got, full[..., r * w:(r + 1) * w])
            c = t_len // (2 * n)
            idx = torch.cat([torch.arange(r * c, (r + 1) * c, device=dev),
                             torch.arange((2 * n - 1 - r) * c,
                                          (2 * n - r) * c, device=dev)])
            got = threefry.bernoulli_block(key, keep, shape,
                                           [None, idx, None], dev)
            ok &= torch.equal(got, full[:, idx])
            checks += 3
            if not ok:
                raise SystemExit(f"z10d: rank {r} of {n}: a slice-only draw "
                                 "differs from the full mask's slice")
        tl = t_len // n
        idx = [None, torch.arange(0, tl, device=dev), None]
        slice_ms[n] = cuda_ms(torch, lambda i: threefry.bernoulli_block(
            key, keep, shape, idx, dev), 10)
    full_ms = cuda_ms(torch, lambda i: threefry.bernoulli(key, keep, shape,
                                                          dev), 10)
    print(f"  {checks} slices (TP columns, ring/Ulysses tokens, zigzag "
          f"chunks; n = 2 and 4) equal to the full mask's, bit for bit; "
          f"kept share {float(full.float().mean()):.5f}; device ms: full "
          f"{shape} draw {full_ms:.3f}, one rank's slice at n = 2 "
          f"{slice_ms[2]:.3f}, at n = 4 {slice_ms[4]:.3f}")


# ----------------------------------------------------------------- phase z11
#: z11's strategies: each new composition at world 1, its split axes of
#: size 1 (``CompositeParallel``'s pairs) or the sequence split of 1.
Z11 = {
    "DataSeqParallel(1, ring)": ("DataSeqParallel", {"seq_parallel": 1}),
    "DataSeqParallel(1, ulysses)": ("DataSeqParallel", {
        "seq_parallel": 1, "attention": "ulysses"}),
    "seq x model": ("CompositeParallel", {"axes": {
        "data": 1, "seq": 1, "model": 1}}),
    "fsdp x seq": ("CompositeParallel", {"axes": {"fsdp": 1, "seq": 1}}),
    "expert x model": ("CompositeParallel", {"axes": {
        "data": 1, "expert": 1, "model": 1}}),
    "expert x seq": ("CompositeParallel", {"axes": {
        "data": 1, "expert": 1, "seq": 1}}),
    "expert x fsdp": ("CompositeParallel", {"axes": {
        "fsdp": 1, "expert": 1}}),
    "expert x pipe": ("CompositeParallel", {"axes": {
        "data": 1, "expert": 1, "pipe": 1}}),
}


#: z11's depth: phase y1's MoE LM cut from 12 blocks to 4 (2 of them MoE)
Z11_LAYERS = 4


def phase_compositions(torch, dtt, mods, batch=8, steps=3):
    """z11: phase y1's MoE LM (GPT-2-small widths, 8 experts every second
    block, bf16 layers, fused_adamw, the pallas loss, batch 8 x 1024, seed
    0) at ``Z11_LAYERS`` blocks under ``DataParallel`` and each of ``Z11``
    over an NCCL group of world 1: 3 steps each, parameters, optimizer state and the aux losses
    bit for bit against ``DataParallel``'s, with the losses, the aux loss,
    the dropped share and the launches a step (counts zeroed just before
    each run, read just after). Then a ``Pipeline(shard="auto")`` built
    in a ``DataTensorParallel(model_parallel=1)`` scope feeds 3 steps of
    the LM (uint8 tokens below 256, each position's label its row's),
    bit for bit the same steps from the host arrays: at world 1 the row
    line is the whole group, so "auto" reads whole. Returns the launches
    of every run but ``DataParallel``'s."""
    t_len = LM["max_len"]
    x, y = lm_batch(batch, t_len)
    launches, base = {}, None
    nccl_world1(dtt)
    try:
        for name, (cls, kw) in [("DataParallel", ("DataParallel", {}))] + \
                list(Z11.items()):
            strategy = getattr(dtt, cls)(**kw)
            model = w_lm(dtt, strategy, t_len, num_layers=Z11_LAYERS,
                         **MOE)
            reset_counts(mods)
            losses = w_fit(model, x, y, batch, steps)
            torch.cuda.synchronize()
            counts = launch_counts(mods)
            dropped, aux = moe_routing(dtt, model)
            print(f"  {name}: losses {[round(v, 5) for v in losses]}, aux "
                  f"loss {aux:.6f}, dropped {dropped:.4f} of the routed "
                  f"choices")
            if not all(np.isfinite(losses)) or not np.isfinite(aux):
                raise SystemExit(f"z11 {name}: losses {losses}, aux {aux}")
            check_per_step(name, counts, per_step_want(model, Z11_LAYERS),
                           steps)
            state = full_state(dtt, model)
            state.update({f"state/{k}": v.detach().clone()
                          for k, v in model.state.items()})
            if base is None:
                base = state
            else:
                diff = first_difference(torch, base, state)
                say_same(f"{name} against DataParallel, params, optimizer "
                         "state and aux losses", diff)
                if diff is not None:
                    raise SystemExit(f"z11: {name} differs from "
                                     "DataParallel at world 1")
                for k, v in counts.items():
                    launches[k] = launches.get(k, 0) + v
            del model, state
            torch.cuda.empty_cache()
        base = None
        for k, v in pipeline_fit(torch, dtt, mods, batch, steps).items():
            launches[k] = launches.get(k, 0) + v
    finally:
        dtt.cluster.shutdown()
    torch.cuda.empty_cache()
    return launches


def pipeline_fit(torch, dtt, mods, batch, steps):
    """z11's ``Pipeline(shard="auto")`` fit (``phase_compositions``)."""
    t_len = LM["max_len"]
    rng = np.random.default_rng(11)
    x8 = rng.integers(0, 256, (batch * steps, t_len), dtype=np.uint8)
    y = rng.integers(0, VOCAB, (batch * steps,), dtype=np.int32)
    pallas = dtt.ops.losses.get(PALLAS)

    def loss(logits, labels):
        return pallas(logits, labels[:, None].expand(logits.shape[:2]))

    runs = {}
    for name in ("Pipeline(shard=\"auto\")", "host arrays"):
        strategy = dtt.DataTensorParallel(model_parallel=1)
        with strategy.scope():
            model = dtt.Model(dtt.models.transformer_lm(
                VOCAB, **dict(LM, dtype="bfloat16",
                              num_layers=Z11_LAYERS)))
            model.compile(optimizer=dtt.optim.fused_adamw(
                3e-4, weight_decay=0.01), loss=loss, metrics=[])
            pipe = (dtt.data.Pipeline(x8, y, batch, shard="auto",
                                      shuffle=False, scale=1.0,
                                      use_native=False)
                    if name.startswith("Pipeline") else None)
        model.build((t_len,), seed=0)
        reset_counts(mods)
        if pipe is not None:
            shard = pipe.shard
            losses = model.fit(pipe, epochs=1, verbose=0).history["loss"]
            pipe.close()
            counts = launch_counts(mods)
        else:
            losses = model.fit(x8.astype(np.int32), y, batch_size=batch,
                               epochs=1, steps_per_epoch=steps,
                               shuffle=False, verbose=0).history["loss"]
        torch.cuda.synchronize()
        runs[name] = (losses, full_state(dtt, model))
        del model
    (got, a), (want, b) = runs.values()
    diff = first_difference(torch, a, b)
    print(f"  Pipeline(shard=\"auto\") under DataTensorParallel(1): shard "
          f"{shard or '(0, 1): one row shard, read whole'}, epoch loss "
          f"{got}; launches {counts}")
    say_same("the pipeline's fit against the host arrays', params and "
             "optimizer state", diff)
    if diff is not None or got != want or not counts["xent_fwd"]:
        raise SystemExit("z11: the Pipeline(shard=\"auto\") fit differs "
                         "from the host arrays'")
    runs.clear()
    return counts


# ------------------------------------------------------------ phase z12
def tp_lm(dtt, strategy):
    """Phase c's GPT-2-small (bf16 layers, seed 0) built under
    ``strategy``."""
    with strategy.scope():
        model = dtt.Model(dtt.models.transformer_lm(
            VOCAB, dtype="bfloat16", **LM))
    return model.build((LM["max_len"],), seed=0)


def tp_served(dtt, engine):
    """(parameter bytes, pool bytes) the engine holds on this card, and
    the hinted leaves it serves whole (none under tensor parallelism)."""
    from distributed_tpu_torch.parallel.collectives import layout_of
    from distributed_tpu_torch.parallel.strategy import role_of

    hints = engine.model.module.sharding_hints()
    whole = []
    for path, t in engine._target.params.items():
        weight, _, leaf = path.rpartition("/")
        role = (dtt.quant.leaf_role(leaf, role_of(weight, hints))
                if leaf in ("q", "scale") else role_of(path, hints))
        lay = layout_of(t)
        if role is not None and (lay is None or lay.local_shape
                                 != tuple(t.shape)):
            whole.append(path)
    return snapshot_bytes(engine._target), pool_bytes(engine.kv), whole


def tp_serve_arm(torch, dtt, paged_ops, model, reqs, **kw):
    """One Engine run of ``model`` on ``reqs`` (fused, logprobs kept):
    (tokens, logprobs, telemetry, wall s, K1/K2 launches, Megatron pair
    calls, served bytes), the counts zeroed just before the run."""
    engine = dtt.serving.Engine(model, max_slots=8, block_size=16,
                                max_len=LM["max_len"],
                                decode_kernel="fused", **kw)
    paged_ops.reset_launch_counts()
    with megatron_pair_counted() as pair:
        t = time.perf_counter()
        outs = engine.run([dtt.serving.Request(p, m) for p, m in reqs],
                          return_logprobs=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    launches = {k: v for k, v in paged_ops.launches.items() if v}
    served = tp_served(dtt, engine)
    tel = engine.last_run_telemetry
    del engine
    logps = [np.asarray(r["logprobs"]) for r in tel["requests"]]
    return outs, logps, tel, wall, launches, dict(pair), served


def phase_tp_serve(torch, dtt, paged_ops, reqs):
    """z12: phase c's LM served under ``DataTensorParallel(
    model_parallel=1)`` against the same weights under ``DataParallel``
    (NCCL, world 1): bf16 and int8 KV, then int8 weights; tokens and
    logprobs bit for bit, the served leaves blocks of the one-rank line,
    Megatron's pair reached by the paged paths (2 calls each a block and
    dispatch), K1/K2 once a layer and decode step. Returns the launches of
    the tensor-parallel runs."""
    nccl_world1(dtt)
    launches = {}
    try:
        models = {"DataParallel": tp_lm(dtt, dtt.DataParallel()),
                  "DataTensorParallel(1)": tp_lm(
                      dtt, dtt.DataTensorParallel(model_parallel=1))}
        arms = (("bf16 KV", {}), ("int8 KV", {"kv_dtype": "int8"}),
                ("int8 weights", {}))
        for arm, kw in arms:
            if arm == "int8 weights":
                for model in models.values():
                    dtt.quant.quantize_model(model)
            runs = {name: tp_serve_arm(torch, dtt, paged_ops, model, reqs,
                                       **kw)
                    for name, model in models.items()}
            (dt, dl, dtel, dwall, *_), (tt, tl, tel, wall, n, pair,
                                         served) = runs.values()
            report(f"{arm}, DataParallel", dtel, dwall)
            check_outputs(tt, reqs, VOCAB)
            same = (all(np.array_equal(a, b) for a, b in zip(dt, tt))
                    and all(np.array_equal(a, b) for a, b in zip(dl, tl)))
            name = "paged_attention_int8" if kw else "paged_attention"
            dispatches = tel["decode_steps"] + tel["prefill_dispatches"]
            want_pair = 2 * LM["num_layers"] * dispatches
            params_b, pool_b, whole = served
            report(f"{arm}, DataTensorParallel(1)", tel, wall)
            print(f"  {arm}: host ms a decode step, DataParallel "
                  f"{1e3 * dtel['decode'] / dtel['decode_steps']:.3f}, "
                  f"DataTensorParallel(1) "
                  f"{1e3 * tel['decode'] / tel['decode_steps']:.3f}")
            print(f"  {arm}: tokens and logprobs "
                  f"{'bit for bit' if same else 'DIFFER from'} "
                  f"DataParallel's; served parameters {params_b / 1e6:.1f} "
                  f"MB, pools {pool_b / 1e6:.1f} MB; hinted leaves served "
                  f"whole {len(whole)}; Megatron pair {pair} over "
                  f"{dispatches} dispatches (want {want_pair} each); "
                  f"launches {n}")
            if not same:
                raise SystemExit(f"z12 {arm}: the TP engine differs from "
                                 "DP's at world 1")
            if whole:
                raise SystemExit(f"z12 {arm}: hinted leaves served whole: "
                                 f"{whole[:4]}")
            if any(v != want_pair for v in pair.values()):
                raise SystemExit(f"z12 {arm}: Megatron pair {pair}, want "
                                 f"{want_pair} each")
            if n.get(name) != tel["decode_steps"] * LM["num_layers"]:
                raise SystemExit(f"z12 {arm}: {name} launches {n}")
            launches[name] = launches.get(name, 0) + n[name]
        del models
    finally:
        dtt.cluster.shutdown()
    torch.cuda.empty_cache()
    return launches


PHASE_SECONDS = {}  # each phase's seconds, from its header to the next
_PHASE = {"name": None, "t": None, "t0": time.perf_counter()}


def phase(title):
    """Print phase ``title``'s header with the seconds since the run
    began, and close the phase before it in ``PHASE_SECONDS`` (``None``
    closes the last)."""
    now = time.perf_counter()
    if _PHASE["name"] is not None:
        PHASE_SECONDS[_PHASE["name"]] = round(now - _PHASE["t"], 1)
    if title is not None:
        print(f"{title} [{now - _PHASE['t0']:.1f} s]")
        _PHASE["name"], _PHASE["t"] = title.split(":")[0].split()[1], now


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs "
              "an NVIDIA card", file=sys.stderr)
        return 2
    import distributed_tpu_torch as dtt
    from distributed_tpu_torch.ops import _build
    from distributed_tpu_torch.ops import bn_reduce as bn_ops
    from distributed_tpu_torch.ops import conv1x1 as conv_ops
    from distributed_tpu_torch.ops import flash_attention as flash_ops
    from distributed_tpu_torch.ops import fused_update as adam_ops
    from distributed_tpu_torch.ops import launch_probe as probe_ops
    from distributed_tpu_torch.ops import paged_attention as paged_ops
    from distributed_tpu_torch.ops import pallas_kernels as xent_ops

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} | {card}")

    phase("phase a: build")
    t = time.perf_counter()
    built = _build.build(*sorted(set(SOURCES.values())))
    print(f"  built {', '.join(p.name for p, _ in built.values())} in "
          f"{time.perf_counter() - t:.1f} s (one nvcc per source, in parallel)")
    for _, log in built.values():
        for line in log.splitlines():
            if "Compiling entry" in line:
                print(f"    {line.split('Compiling entry function')[-1].strip()}")
            elif "registers" in line or "spill" in line:
                print(f"      {line.strip()}")
    wgmma_report(flash_ops, conv_ops, built)

    phase("phase b: kernels vs plain versions, S=8 H=12 hd=64 bs=16 nb=64")
    print('kernels: ["paged_attention (K1)", "paged_attention_int8 (K2)"]')
    rows = phase_kernels(torch, paged_ops)

    phase("phase c: GPT-2-small LM, bf16 layers, Engine(8 slots, block 16, "
          "max_len 1024), fused")
    model = dtt.Model(dtt.models.transformer_lm(
        VOCAB, dtype="bfloat16", **LM))
    t = time.perf_counter()
    model.build((LM["max_len"],), seed=0)
    n_params = sum(p.numel() for p in model.params.values())
    print(f"  built {n_params / 1e6:.1f}M params in "
          f"{time.perf_counter() - t:.1f} s")
    reqs = requests(16, (32, 512), (64, 128))
    serve(dtt, model, requests(2, (8, 16), (4, 4), seed=1))  # warm-up
    paged_ops.reset_launch_counts()
    fused, tel, wall = serve(dtt, model, reqs, decode_kernel="fused")
    launches = dict(paged_ops.launches)
    report("fused", tel, wall)
    print(f"  launches {launches}")
    if launches["paged_attention"] != tel["decode_steps"] * LM["num_layers"]:
        raise SystemExit("the fused run did not launch the kernel once per "
                         "layer and decode step")
    check_outputs(fused, reqs, VOCAB)
    rows["paged_attention"]["launches"] = launches["paged_attention"]
    ref, tel_ref, wall_ref = serve(dtt, model, reqs,
                                   decode_kernel="reference")
    report("reference", tel_ref, wall_ref)
    share, first = agreement(fused, ref, reqs)
    print(f"  fused vs reference: token agreement {share:.4f}, first tokens "
          f"{'match' if first else 'DIFFER'}")
    if not first:
        raise SystemExit("first tokens (prefill) differ between engines")

    phase("phase d: 2 layers, f32, TF32 off: fused must be token-exact")
    small = dtt.Model(dtt.models.transformer_lm(
        VOCAB, **dict(LM, num_layers=2)))
    small.build((LM["max_len"],), seed=1)
    sreqs = requests(8, (32, 256), (16, 32), seed=2)
    small_fused, _, _ = serve(dtt, small, sreqs, decode_kernel="fused")
    b, _, _ = serve(dtt, small, sreqs, decode_kernel="reference")
    exact = all(np.array_equal(x, y) for x, y in zip(small_fused, b))
    print(f"  token-exact: {exact}")
    if not exact:
        raise SystemExit("f32 fused and reference runs differ")
    torch.cuda.empty_cache()

    phase("phase e: int8 KV at full width, fused")
    paged_ops.reset_launch_counts()
    q8, tel8, wall8 = serve(dtt, model, reqs, kv_dtype="int8",
                            decode_kernel="fused")
    launches = dict(paged_ops.launches)
    report("int8 KV", tel8, wall8)
    print(f"  launches {launches}")
    if launches["paged_attention_int8"] == 0:
        raise SystemExit("the int8 run never launched the int8 kernel")
    check_outputs(q8, reqs, VOCAB)
    rows["paged_attention_int8"]["launches"] = launches["paged_attention_int8"]
    share8, _ = agreement(q8, fused, reqs)
    print(f"  int8 vs bf16 KV: token agreement {share8:.4f}")
    del model
    torch.cuda.empty_cache()

    phase(f"phase f: fused cross-entropy kernels vs plain (C={VOCAB}, bf16)")
    rows.update(phase_xent(torch, xent_ops))

    phase("phase g: flash-attention kernels vs plain (B=32, T=1024, H=12, "
          "D=64, causal)")
    rows.update(phase_flash(torch, flash_ops))

    phase("phase h: GPT-2-small LM training, bf16 layers, Adam(1e-4), pallas "
          "loss, batch 32 x 1024")
    train_launches = phase_train(torch, dtt, (xent_ops, flash_ops))
    for name, n in train_launches.items():
        rows[name]["launches"] = n

    phase("phase i: 2 layers, f32, TF32 off: kernel path vs plain path, 3 "
          "Adam steps")
    phase_kernel_vs_plain(torch, dtt)

    phase("phase j: fused Adam kernel vs plain, GPT-2-small's parameter tree")
    rows.update(phase_fused_adam(torch, dtt, adam_ops))

    phase("phase k: mnist_cnn and cifar_cnn under DataParallel (NCCL, world 1)")
    strategy = phase_cnn(torch, dtt)

    phase("phase l: GPT-2-small under DataParallel, fused_adamw(3e-4, wd "
          "0.01), pallas loss, batch 32 x 1024")
    rows["fused_adam"]["launches"] = phase_dp_lm(
        torch, dtt, strategy, (xent_ops, flash_ops, adam_ops))

    phase("phase m: K12, K13, K14 vs plain at ResNet-50's shapes (batch 256, "
          "224x224)")
    rows.update(phase_resnet_kernels(torch, dtt, conv_ops, bn_ops))

    phase("phase n: ResNet-50 training under DataParallel, bf16, SGD(0.1, "
          "momentum=0.9), batch 256 x 224x224")
    resnet_launches = phase_resnet_train(torch, dtt, strategy, conv_ops,
                                         bn_ops)
    for name in ("conv1x1", "bn_stats", "bn_bwd_reduce"):
        rows[name]["launches"] = resnet_launches[name]

    phase("phase o: small f32 ResNet, TF32 off: card vs CPU, then "
          "DataParallel (world 1) vs SingleDevice")
    phase_resnet_kernel_vs_plain(torch, dtt, strategy)
    dtt.cluster.shutdown()

    phase("phase p: the launch probe (K15) vs x * 1.0001; the host's cost "
          "of a launch")
    rows.update(phase_launch_probe(torch, probe_ops, paged_ops))

    phase("phase q: float16 through K9/K10, K12 and K13/K14, and a small "
          "f16 ResNet")
    phase_f16(torch, dtt, xent_ops, conv_ops, bn_ops)

    background = start_background(torch)
    phase("phase r: checkpoints: ResNet-50 and a small LM resumed mid-fit "
          "under DataParallel (NCCL, world 1)")
    for name, n in phase_resume(torch, dtt, conv_ops, bn_ops,
                                (xent_ops, flash_ops, adam_ops)).items():
        rows[name]["launches_resumed"] = n

    phase("phase s: speculative serving and weight hot-swap through Engine")
    k1, k2 = phase_spec(torch, dtt, paged_ops, reqs, fused, small, sreqs)
    rows["paged_attention"]["launches_spec"] = k1
    rows["paged_attention_int8"]["launches_spec"] = k2

    phase("phase t1: GPT-2-small's fit loop: grad_accum, steps_per_execution "
          "as CUDA graphs, an iterator with prefetch")
    t1_captured, t1_runs, _ = phase_fit_lm(torch, dtt,
                                           (xent_ops, flash_ops, adam_ops))
    phase("phase t2: ResNet-50, K=4 + a Pipeline with prefetch=2 against the "
          "K=1 loop (SingleDevice)")
    t2_captured, t2_runs, _, _ = phase_fit_resnet(torch, dtt,
                                                  (conv_ops, bn_ops))
    phase("phase t2b: mnist_cnn under DataParallel (NCCL, world 1), K=8 "
          "against K=1")
    phase_fit_mnist(torch, dtt)
    phase("phase t3: Model.generate at GPT-2-small width, f32, against the "
          "Engine")
    phase_generate(torch, dtt)
    phase("phase u1: long context at GPT-2-small width: remat, head_chunks, "
          "T up to 65,536")
    u_counts = {"u1": phase_longctx(torch, dtt, (xent_ops, flash_ops))}
    phase("phase u2: precision policies on phase h's LM (no dtype= on the "
          "layers), batch 32 x 1024")
    u_counts["u2"] = phase_precision(torch, dtt, (xent_ops, flash_ops,
                                                  adam_ops), flash_ops)
    phase("phase u3: int8 weights served through Engine (fused)")
    u_counts["u3"] = {"paged_attention": phase_quant_serve(
        torch, dtt, paged_ops, reqs, fused)}
    v_mods = (xent_ops, flash_ops, adam_ops, conv_ops, bn_ops, paged_ops)
    phase("phase v1: GPT-2-small LM, scan=True against unrolled, bf16 "
          "layers, Adam(1e-4), pallas loss, batch 32 x 1024")
    v = phase_scan_lm(torch, dtt, v_mods, paged_ops, reqs)
    phase("phase v3: ResNet-50 scan_stages=True against unrolled, bf16, "
          "SGD(0.1, momentum=0.9), batch 256 x 224x224")
    more = [phase_scan_resnet(torch, dtt, v_mods)]
    phase("phase v4: ViT-B/16 scan=True against unrolled, bf16 layers, "
          "fused_adamw(1e-3), pallas loss, batch 128 x 224x224 uint8")
    more.append(phase_scan_vit(torch, dtt, v_mods, xent_ops))
    phase("phase v5: Dropout(0.1) after each of 2 scanned GPT-2-small "
          "blocks: the card's mask, K=4 graphs against K=1")
    more.append(phase_scan_dropout(torch, dtt, v_mods))
    for counts in more:
        for name, n in counts.items():
            v[name] = v.get(name, 0) + n
    u_counts["v"] = v
    w_mods = (xent_ops, flash_ops, adam_ops)
    phase(f"phase w1: GPT-2-small under DataParallel, ZeroDataParallel and "
          f"FSDP (NCCL, world 1), bf16 layers, fused_adamw, batch 32 x "
          f"1024 | {card_line()}")
    nccl_world1(dtt)
    w, _ = phase_sharded(torch, dtt, w_mods)
    phase("phase w3: phase u2's LM under FSDP, mixed_bfloat16 against "
          "float32: the gathers' dtype and bytes")
    more = [phase_sharded_bf16(torch, dtt, w_mods)]
    phase("phase w4: ShardedCheckpointer on the FSDP LM mid-fit, batch 8 x "
          "1024")
    more.append(phase_sharded_ckpt(torch, dtt, w_mods))
    for counts in more:
        for name, n in counts.items():
            w[name] = w.get(name, 0) + n
    u_counts["w"] = w
    phase(f"phase x1: GPT-2-small under DataTensorParallel(model_parallel=1)"
          f" and DataSeqParallel(seq_parallel=1), ring and ulysses, against "
          f"DataParallel (NCCL, world 1), batch 32 x 1024 | {card_line()}")
    u_counts["x"] = phase_tp_sp(torch, dtt, w_mods)
    phase("phase x2: ring attention and the Ulysses exchange on CUDA tensors "
          "over the world-1 group, against dense attention")
    phase_ring_ops(torch, dtt)
    y_mods = (xent_ops, flash_ops, adam_ops)
    phase(f"phase y1: the MoE LM at GPT-2-small widths (8 experts every 2nd "
          f"block) under DataParallel and DataExpertParallel(1) (NCCL, world "
          f"1), bf16 layers, fused_adamw, batch 8 x 1024 | {card_line()}")
    y = phase_moe(torch, dtt, y_mods, paged_ops)
    phase("phase y2: GPT-2-small pipeline=True under DataPipelineParallel(1) "
          "against its scan=True twin, batch 32 x 1024; the Engine off the "
          "pipe mesh")
    more = [phase_pipe(torch, dtt, y_mods, paged_ops, reqs)]
    phase('phase y3: CompositeParallel({"data": 1}) against DataParallel on '
          "phase l's LM")
    more.append(phase_composite(torch, dtt, y_mods))
    for counts in more:
        for name, n in counts.items():
            y[name] = y.get(name, 0) + n
    u_counts["y"] = y
    dtt.cluster.shutdown()
    z_mods = (xent_ops, flash_ops, adam_ops)
    phase(f"phase z1: compile(strategy=\"auto\") on phase l's GPT-2-small, "
          f"batch 32 x 1024: the plan, 3 steps against the same configuration "
          f"by hand, measure=True, a cap | {card_line()}")
    u_counts["z"] = phase_auto(torch, dtt, z_mods)
    phase("phase z2: run_with_restart and liveness on this card "
          "(scripts/torch_restart.py --num-workers 1)")
    join_background(background, "z2")
    phase(f"phase z3: the supervisor, the buddy tier, preemption and a "
          f"corrupt checkpoint on this card (scripts/torch_restart.py "
          f"--supervise --num-workers 1) | {card_line()}")
    u_counts["z3"] = join_background(background, "z3")
    phase(f"phase z4: the serving fleet: GPT-2-small (bf16 layers) behind "
          f"EnginePrograms(decode_kernel=\"fused\"), 2 decode + 1 prefill "
          f"replicas, 16 requests in bursts of 4 | {card_line()}")
    u_counts["z4"] = {"paged_attention": phase_fleet(
        torch, dtt, paged_ops, reqs, fused, small, sreqs, small_fused)}
    phase(f"phase z5: ServeService at GPT-2-small width (f32 layers): 2 "
          f"decode + 1 prefill worker processes, KV over /dev/shm | "
          f"{card_line()}")
    phase_service(torch, dtt)
    phase(f"phase z6: PostTrainer at GPT-2-small width (bf16 layers): "
          f"Engine(16 slots, temperature 1.0, fused), fused_adam(1e-5), "
          f"AdaptiveKLCoef, 8 prompts x 4 samples x 64 tokens, 2 iterations "
          f"| {card_line()}")
    u_counts["z6"] = phase_posttrain(torch, dtt, (paged_ops, flash_ops,
                                                  adam_ops, xent_ops))
    phase(f"phase z7: DraftDistiller on phase s's target and 6-layer draft "
          f"(greedy, spec_k 4, fused), 2 rounds of 8 epochs | {card_line()}")
    u_counts["z7"] = phase_distill(torch, dtt, (paged_ops, flash_ops,
                                                adam_ops, xent_ops), reqs,
                                   small)
    phase(f"phase z8: the data tiers: scripts/torch_imagenet_resnet.py's "
          f"model from a FileSource on the native ring, mnist_cnn from zlib "
          f"records | {card_line()}")
    u_counts["z8"] = join_background(background, "z8")
    phase(f"phase z9: dtt-lint over distributed_tpu_torch/, and the port's R "
          f"binding: r/distributedtputorch/examples/local.R with device = "
          f"NULL (mnist_cnn, SGD(0.001), 3 epochs x 5 steps of 64) | "
          f"{card_line()}")
    u_counts["z9"] = join_background(background, "z9")
    phase(f"phase z10a: Pythia-160M's widths with GPT-NeoX's parallel "
          f"residual (the attention in the Residual's shortcut) served by "
          f"the paged Engine: f32 against generate, bf16 and int8 KV, "
          f"spec_k=4 | {card_line()}")
    z10 = join_background(background, "z10a")
    phase(f"phase z10b: a Remat around each residual inside the scanned "
          f"template of phase v1's LM (fused_adam(1e-4)), against the "
          f"unrolled remat=True LM and the whole-block Remat twin | "
          f"{card_line()}")
    more = [join_background(background, "z10b")]
    phase(f"phase z10c: ResNet-50 (bf16) under DataParallel (NCCL, world 1)"
          f" predicting 1,024 images from Pipeline(shard=\"auto\") | "
          f"{card_line()}")
    more.append(phase_pipeline_predict(torch, dtt, conv_ops))
    phase("phase z10d: Dropout's slice-only draws against the full-shape "
          "mask at 8 x 1024 x 768, 2 and 4 ranks")
    phase_dropout_slices(torch, dtt)
    for counts in more:
        for name, c in counts.items():
            z10[name] = z10.get(name, 0) + c
    u_counts["z10"] = z10
    phase(f"phase z11: phase y1's MoE LM (4 blocks) under DataSeqParallel(1),"
          f" ring and ulysses, and CompositeParallel's new pairs at sizes 1 "
          f"against DataParallel (NCCL, world 1); a Pipeline(shard=\"auto\") "
          f"fit under DataTensorParallel(1) | {card_line()}")
    u_counts["z11"] = phase_compositions(torch, dtt,
                                         (xent_ops, flash_ops, adam_ops))
    phase(f"phase z12: the Engine under DataTensorParallel(model_parallel=1)"
          f" (NCCL, world 1): phase c's LM and requests, fused, bf16 and "
          f"int8 KV, int8 weights, against DataParallel | {card_line()}")
    u_counts["z12"] = phase_tp_serve(torch, dtt, paged_ops, reqs)
    for sub, counts in u_counts.items():
        for name, n in counts.items():
            if n:
                rows[name][f"launches_{sub}"] = n
    for name, n in dict(t1_captured, **t2_captured).items():
        rows[name]["launches_fit"] = n
    for name, n in dict(t1_runs, **t2_runs).items():
        rows[name]["replayed_fit"] = n

    kernels = [
        {"name": name, "route": "cuda",
         "kernel": KERNELS[name],
         "source": f"distributed_tpu_torch/csrc/{SOURCES[name]}.cu",
         "replaces": REPLACES[name], "launches": r["launches"],
         "max_abs_err": r["max_abs_err"], "ms": r["ms"],
         "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
         "bound_by": r["bound_by"], "library_ms": r.get("library_ms"),
         "launches_resumed": r.get("launches_resumed"),
         "launches_fit": r.get("launches_fit"),
         "replayed_fit": r.get("replayed_fit"),
         **{f"launches_{sub}": r[f"launches_{sub}"]
            for sub in ("u1", "u2", "u3", "v", "w", "x", "y", "z", "z3",
                        "z4", "z6", "z7", "z8", "z9", "z10", "z11",
                        "z12")
            if f"launches_{sub}" in r},
         **({"launches_spec": r["launches_spec"], "ms_by_kw": r["ms_by_kw"]}
            if "ms_by_kw" in r else {})}
        for name, r in rows.items()
    ]
    phase(None)
    print(f"phase seconds: {json.dumps(PHASE_SECONDS)}")
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    finally:
        stop_children()
