#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py            # all phases; needs one CUDA device

Phases, one JSON line each:
  1. device  — card name and power limit (nvidia-smi), torch and CUDA versions;
  2. build   — nvcc builds every kernel source under src/repro_torch/csrc;
  3. kernels — each hand-written kernel against its plain torch version at the
               shapes its path gives it, with kernel / plain / library times
               (CUDA events; the serving kernels in CUDA graphs of many
               launches with operands rotated past the 50 MB L2) and the
               bound from bytes and operations: 3a fixedpoint_matmul at
               internlm2's 7 projections (M 4 in bf16 and fp32, M 128 in
               fp32, the prefill buckets M 32..512 in bf16), 3b
               paged_attention (and, timed only, its internlm2 decode
               shape at rows of about 64, 300 and 500 cached tokens), 3c
               symog_update on every quantizable leaf
               shape of internlm2-1.8b plus an odd n, half-step ties, the
               clip and a misaligned operand, and with a Δ per leading
               group: olmoe's 6-layer expert leaf (6, 64, 2048, 1024), f
               (6, 64); deepseek-v3's MTP expert stack (256, 7168, 2048), f
               (256,), 45 GB of operands drawn and checked chunk by chunk;
               a ragged (3, 5, 7, 9), f (3, 5): each bit-identical to the
               plain version on two calls, 3d fixedpoint_matmul_experts
               on olmoe-1b-7b's expert stacks (64 experts, one f each, C = 4
               and 80 in bf16 and fp32, the prefill capacities C = 5, 20, 80
               in bf16, 2 and 4 bits) and fixedpoint_matmul at olmoe's
               packed head (M 4, K 2048, N 50304, fp32); both again at
               deepseek-v3's shapes, 2-bit: every 2-D projection of its path
               (the MLA layer's, the dense MLP, the shared expert, the
               129,280-row head; M 4 and 128 in bf16 and fp32, M 512 in bf16)
               and one MoE layer's three 256-expert stacks (C 4 in bf16 and
               fp32, C 2, 10, 20 in bf16); every bf16 case holds its rule's
               kernel (forced: the decode kernel up to 8 rows, the tensor
               cores above) to the plain version, bit-identical over two
               calls, and times it beside the streaming kernel; the bf16
               C = 4 stacks take ``rows`` from a top-8 routing of 4 random
               tokens (the occupied count, the bound at occupied bytes and
               at every expert's, and the same kernel reading every expert,
               which must give the same bits); 3g the three kernels at
               2..16 rows (internlm2's gate_proj, olmoe's gate stack): the
               route rule must not sit on the wrong side of a measured
               crossover; fixedpoint_matmul again at gemma3-4b's 7
               projections (M 4 and 512) and its 262,144-row head as a
               packed (2560, 262144) matrix (M 4); 3b also at the dense
               configs' decode shapes (gemma3's head_dim 256 under its
               1,024 window, granite's K 1 G 48, gemma2's softcap 50 under
               its 4,096 window) and at the speculative verify's (B 4, T 5,
               ragged rows of ~300 tokens, the last row's queries past its
               table's end), every case bit-identical over two calls;
               3e
               paged attention over int8 and int4 SYMOG pools (olmoe's and
               internlm2's decode shapes, exponents over [-8, 4], a window
               + softcap case, an fp32 case; timed only, olmoe's int4 decode
               shape at rows of about 64, 300 and 500 cached tokens; the
               tail-prefill launches of gemma3's admission, B 1, T 32, 512
               and 2048 from position 0 and T 512 from 1000, int4; phase
               11a's chunks, T 256 from 1,024 and from 1,000, and its
               prefix-hit tail, T 32 from 1,000), 3f
               the absorbed MLA decode (``paged_attention_mla``) at
               deepseek-v3's shape (128 heads, rank 512, rope 64) over bf16
               / fp32, KV_F int8 and SYMOG int8 / int4 pools (one exponent
               per block over [-8, 4]), T 1 and 3, a row at position 0, and
               the verify's T 5 over bf16 and int4 pools:
               every bf16 case through both kernels (the tensor-core
               ``mla_decode_tc``, which the rule picks and which must be the
               faster, and ``mla_partial``), the tensor-core kernel also at
               4 and 8 ranks beside the rule's; fp32 cases on
               ``mla_partial``; and an fp64 conditioning check;
  4. parity  — internlm2-1.8b, gemma2-27b, granite-34b and olmoe-1b-7b at
               full width, 4 layers (gemma3-4b 6, from an int4 pool through
               the tail-prefill admission, its writes held array_equal to
               the same writes on the CPU), fp32
               compute, 2-bit packed: prefill + 4 teacher-forced paged decode
               steps through the kernels vs through the plain paths; logits
               must agree; olmoe a second time from an int4 SYMOG pool
               (quantizing admission held array_equal to the same writes on
               the CPU, quantized decode writes, the quantized kernel vs
               ``_paged_read``, packed matmuls through the kernels on both
               routes so that both write the same words; the SYMOG
               exponents and words written on the card array_equal to the
               CPU's where the exponent steps); deepseek-v3 (3
               dense + 1 MoE layer, 256 experts, built layer by layer) from a
               bf16 and from an int4 MLA pool, the matmuls through the
               kernels on both routes (MLA's fp32 queries on
               ``mla_partial``), argmax agreement 1.0; the two pools'
               logits compared row by row (top-1 - top-2 margin beside the
               largest logit gap, the int4 pool's c_kv / k_rope error);
  5. serve   — internlm2-1.8b at full width, 8 of its 24 layers, 2-bit
               ``ServeEngine.from_symog``, bf16, 4 slots, 8 requests of
               24..400 prompt tokens and 32 new tokens each through the
               continuous-batching scheduler; each admission (bucketed
               prefill) and decode step timed; every kernel's launch count,
               split by matmul route, must equal the count the path implies;
  6. profile — a few decode steps of that engine under cProfile (host
               functions) and torch.profiler (device busy time, top kernels,
               the matmul kernels' device time by route and form);
  7. train   — SYMOG training of internlm2-1.8b at full width and all 24
               layers (fp32 master weights, bf16 compute, 4 x 512 tokens):
               the Δ search, step 1's fused update against the composed one
               leaf by leaf, 6 steps through ``make_train_step`` on the fused
               route (8 symog_update launches per step), then the trained
               weights packed and served (remat off, so that its step ms and
               peak stay comparable with earlier runs);
 7b. olmoe   — SYMOG training of olmoe-1b-7b at every published width, 6 of
     train     its 16 layers (2.72 B parameters; one Δ per (layer, expert)):
               two backward passes of step 1 bit-identical; step 1 fused
               vs composed leaf by leaf, the fused update repeated
               identical; 6 fused steps with remat on (JAX's default), 9
               launches a step, then 3 with remat off, step ms and peak
               bytes each way, ce / aux / z per step; the trained weights
               packed and served from an int4 pool (rows 1b and 3);
 7c. deepseek — reduced deepseek-v3 with its MTP loss, 3 steps at fp32:
     reduced   the card's fused route against the CPU's composed one, every
               loss term and param (``phase_train_reduced``, which 16b
               runs on four more archs);
  8. olmoe   — olmoe-1b-7b at full width and 8 of its 16 layers
               (``SERVE_LAYERS``), 2-bit packed
               with one Δ per expert (``symog_init`` timed), served as in
               phase 5 (same traffic and checks) from an int4 SYMOG KV pool;
               the same requests again must give identical tokens; a bf16
               pool's greedy agreement is printed; then its decode profile;
  9. deepseek — deepseek-v3 at full width, 5 layers (its 3 dense layers and
               2 MoE layers of 256 experts top-8 + a shared expert, vocab
               129,280), 2-bit packed with one Δ per (layer, expert), built
               one layer at a time (``build_layerwise``: the fp32 tree of
               198.5 GB never exists), served as in phase 8 from an int4 MLA
               pool; the bf16-pool serve gates the float MLA kernel's
               launches (both serves: every MLA launch on the tensor-core
               kernel, one a call); then its decode profile (MLA device
               ms a step by kernel) under the parent's MLA route rule
               (every call on ``mla_partial`` + ``attn_combine``) and under
               this one, in turns (parent, this, this, parent);
 10. gemma3  — gemma3-4b at full width and 12 of its 34 layers (two of
               its global layers; ``SERVE_LAYERS``: the depth cut keeps the
               script inside its time limit), vocab 262,144, head_dim 256,
               2-bit packed,
               served from an int4 SYMOG KV pool (max_len 2048, prompts of
               24..1,800 tokens: buckets 32..2048, the window binding),
               every admission a tail prefill: launch counts by route (12
               tail-prefill launches an admission), the greedy serve repeated token-identical, the
               sampled serve (temperature 0.7, top-k 50, seed 123) identical
               again, with 3 slots and with staggered arrivals; a bf16
               pool's greedy agreement; then its decode profile;
 11. prefix  — (a) that gemma3 engine serving 8 requests of one shared
     cache,    1,000-token prefix (62 blocks + 8 tokens) plus 24..400-token
     chunks,   tails four ways: plain, ``prefix_cache``, ``prefill_chunk``
     specu-    256, both, each twice: hits, copies on write and chunks as
     lation    the arrival order implies, launches by route, repeats
               identical; (b) gemma3 at 6 layers, fp32, a float pool: a
               prefix-hit admission from 1,000 (its copy on write) and a
               chunked one against the one-shot admission, logits and pool;
               (c) internlm2-1.8b at full width and 8 of its 24 layers
               (``SPEC_LAYERS``), bf16 pool, phase 5's traffic, k = 4
               adaptive, the 2-bit ``pack_tree`` draft
               against a ``quantize_tree`` twin target and the float
               target: repeats identical, launches as the rounds imply
               (the GQA kernel at T = k + 1 on every verify), acceptance,
               tokens a round and decode tokens/s beside the vanilla serve;
               sampled streams on the twin identical over a rerun, 3 slots,
               staggered arrivals; (d) internlm2 at 4 layers, fp32:
               ``decode_verify_lm`` through the kernels (an inactive row, a
               row past max_len) against sequential ``decode_lm`` steps and
               the plain path;
 12. CNNs    — (a) LeNet-5, VGG-7/11/16 and DenseNet-76 at full width, fp32:
               logits and BN stats on the card against the CPU, train and
               eval mode; (b) LeNet-5 under tests/test_system.py's recipe
               (120 float steps, 220 SYMOG steps, batch 64, data seed 1):
               the relative quantization error, conv2 trimodal, clipping's
               switch rate, the three accuracies printed; (c) VGG7 at full
               width, batch 128 of 32x32x3, the same recipe: step ms,
               launches a step, quantization error, accuracies;
 13. front   — phase 5's internlm2 engine and traffic (after phase 6):
     end       (a) ``serve_async`` streams (``tokens()``, per-request
               ``on_token``, each timeline's token events) equal to the
               sync serve, launches through the decode kernels, and a late
               submission that joins the live batch; (b) a request
               cancelled mid-decode: ``cancelled``, its blocks back in the
               pool (the free count as before its admission, net of the
               survivors' growth), survivors token-identical, and the
               queued / unknown / finished cancels JAX's tests expect;
               (c) a high-priority late arrival admitted before older FIFO
               peers, and under a 32-block pool the lowest-priority request
               the only preemption victim (from ``events``); (d) a traced
               serve: the Chrome trace's admit / decode spans, the
               registry's counters against the completions and the step
               count, the snapshot printed, decode step ms with tracing
               off, on, on, off; (e) the packed params saved by
               ``CheckpointManager``, restored onto the card and served:
               tokens identical, bytes and seconds; (f) the launcher
               ``python -m repro_torch.launch.serve`` at full width (packed,
               int4 pool, 8 requests, metrics JSON, trace, profiler window
               of 4 steps) as a subprocess: exit 0, JAX's metric names, the
               trace parses, the profiler trace names fpmm_decode and
               gqa_decode;
 14. recur-  — (a) fixedpoint_matmul at one mamba2-2.7b layer's 6
     rent      projections (N 5120, 128, 80; K 5120 for out_proj) and one
               recurrentgemma-2b RG-LRU layer's 6 and local-attention
               layer's 7, M 4 and 512, bf16, 2-bit (rule's kernel vs plain,
               streaming, ``torch.matmul``, bound); (b) paged_attention at
               recurrentgemma's decode shape (B 4, K 1, G 10, hd 256,
               window 2,048 over ~3,000 tokens) from a bf16 and a KV_F
               int8 pool, vs plain and SDPA; (c) kernel route vs plain
               route, full width, fp32: recurrentgemma 5 layers (an RRL
               unit + the RR tail), mamba2 4 layers, the engine's own
               admission step, logits within PARITY_ATOL, argmax 1.0,
               launches as the layers give them; (d) full-width 2-bit
               bf16 serves of mamba2-2.7b (4 of its 64 layers) and
               recurrentgemma-2b
               (8 of 26 layers, bf16 pool and again under int8_fp) on phase 5's
               traffic: launches by route (6 packed matmuls an SSD or
               RG-LRU layer, 7 a local-attention layer, a call; gqa_decode
               8 a decode step for recurrentgemma, none for mamba2),
               repeats identical, pool bytes paged and resident, one
               recurrent layer's decode step beside its projections, with
               and without its state's write-back, the tied head's
               dequantize, a profiled decode window; (e)
               reduced mamba2 and recurrentgemma served greedy on the card
               and on the CPU under a preempting pool: token-identical;
 15. encdec  — (a) fixedpoint_matmul at one whisper-large-v3 decoder
     and vlm   layer's 10 biased projections (self and cross q / k / v / o,
               fc1 1280 -> 5120, fc2) at M 4 and its encoder layer's 6 at
               M 1,500, and one paligemma-3b layer's 7 (MQA k / v 2048 ->
               256, gate / up 2048 -> 16384) at M 4 and 256 + 512, bf16,
               2-bit (rule's kernel vs plain, streaming, ``torch.matmul``,
               bound); (b) paged_attention at whisper's decode shape (MHA:
               B 4, K 20, G 1, hd 64, ~300 tokens) and paligemma's (MQA: K
               1, G 8, hd 256, 256 + ~300 tokens), bf16 and KV_F int8
               pools, vs plain and SDPA; (c) kernel route vs plain route,
               full width, fp32: whisper with 4 encoder + 4 decoder layers,
               paligemma with 4, the engine's own admission (frames /
               patches in the batch), then teacher-forced paged decode
               steps: logits within PARITY_ATOL, argmax 1.0, launches as
               the layers give them; (d) full-width 2-bit bf16 serves of
               whisper-large-v3 (2 + 2 of its 32 + 32 layers) and
               paligemma-3b (9 of 18
               layers) on phase 5's traffic (max_len 512, + 256 for
               paligemma), each request with its own seeded frames /
               patches, from a bf16 pool and again under int8_fp: launches
               by route (whisper 512 packed matmuls an admission, 256 and
               32 gqa_decode a decode step; paligemma 126, 126 and 18),
               repeats identical, pool bytes paged and resident (whisper's
               cross-kv), admission seconds with the encoder's share, the
               tied head's dequantize, a profiled decode window; (e)
               reduced whisper and paligemma served greedy on the card and
               on the CPU under a preempting pool: token-identical;
 16. train   — (a) SYMOG training of mamba2-2.7b (4 of its 64 layers),
     other     recurrentgemma-2b (8 of 26), whisper-large-v3 (2 + 2 of 32 +
     families  32) and paligemma-3b (9 of 18) at every published width (the
               four depth cuts, ``FAMILY_TRAIN_LAYERS``, keep the script
               inside its time limit; a depth is also cut where the
               printed reckoning of peak bytes passes the card's 80 GB):
               fp32 masters, bf16 compute through a bf16 copy
               (``cast_params``), 2-bit, remat on, 4 x 512 tokens
               (whisper 4 x 448 with its frames (4, 1500, 1280), paligemma
               with its patches (4, 256, 2048)); step 1 from one set of
               grads, the fused update against the composed one leaf by
               leaf at TRAIN_TOL, and the kernel against its plain version
               on the largest leaf, both timed; 3 fused steps, each with
               its ms, peak bytes, loss / ce, λ and ``symog_update``
               launches (one a quantizable leaf: 8, 44, 17, 8); gates:
               grad norm, params and momentum finite; mamba2 first prints
               the SSD decay's largest exponent above the diagonal (past
               fp32's exp limit of 88.72 the JAX order's backward gives
               NaN); each trained tree then ``pack_tree``-d and served, one
               greedy request of 64 prompt tokens and 16 new from a bf16
               pool, launches as the route rule gives them, the tokens
               identical on a repeat; (b) the four reduced configs, 3 fp32
               steps at the default λ schedule, the card's fused route
               against the CPU's composed one (as 7c): every loss term and
               param at TRAIN_TOL.
 17. launcher, — the training launcher (``launch/train.py``'s ``run``, the
     examples,  JAX launcher's optimizer ``chain(clip_by_global_norm(1.0),
     experi-    sgd(nesterov=True))``): (a) internlm2-1.8b at full width
     ments      and depth, 4 SYMOG steps of 8 x 128, bf16 compute, no
               checkpoint: step 1 from one set of grads, the fused clipped
               update (a ``symog_sqnorm`` norm pass and a ``symog_update``
               scaled by the clip on the card) against the composed chain
               leaf by leaf at TRAIN_TOL, the clip scales compared; then
               the run, gated on finite losses and the norm pass and the
               update each launched once a quantizable leaf a step (8),
               with each step's ms, clip scale and the peak bytes; (b) 2
               layers at full width through the same function: 4 steps
               straight against 2 + ``--resume`` 2 from a temporary
               directory, params and momentum bit for bit; the
               checkpoint's bytes and its save / restore seconds; (c) the
               two new forms on internlm2's largest leaf against their plain
               versions: the norm pass and the clip-scaled update, each
               bit-identical on two calls, timed beside their byte bounds;
               (d) the paper's five experiments as written
               (``repro_torch.experiments``), ``run_symog_protocol`` on
               VGG7 at full width on CIFAR-shaped data, and
               ``examples/serve_quantized``'s path on reduced internlm2:
               every emitted line printed, gated on the claims the JAX
               package's own CPU run of the same module passes (C1, the
               collapsed modes of Figure 3, C3), the packed serve
               token-identical to the hard-quantized one, and
               ``symog_update`` launched once a quantizable leaf a SYMOG
               step in every clipped (clip=True) arm.
 18. distri- — on the one card, ranks over gloo (two ranks cannot share a
     bution    card under NCCL): (a) the serve launcher under
               ``torch.distributed.run`` on 2 ranks with phase 13's flags
               and ``--mesh 1x2`` (full depth, bf16): exit 0, the ranks'
               streams equal, the capacity line at 2 model shards, packed
               vs quantized agreement printed; (b) 2 spawned ranks, mesh
               (1, 2): internlm2-1.8b at full width and ``TP_LAYERS`` of
               24, 2-bit, fp32, from a bf16 and an int4 pool, greedy
               streams and every launch count equal to the 1-rank serve,
               4 of 8 KV heads a rank, pool bytes against
               ``pool_bytes_per_device(model_shards=2)`` (the exponents
               co-sharded with their heads), a bf16-compute serve's
               first-step logits within BF16_LOGIT_FACTOR of bf16's own
               distance from fp32 and its identical-token share; (c) that
               engine on a 1-rank NCCL group: streams and launch counts
               equal to the unsharded serve; (d) olmoe-1b-7b at full width
               and ``EP_LAYERS``, ``moe_impl='ep'``, 32 local experts a
               rank: fp32 streams equal to the 1-rank dispatch serve, and
               one full-width layer's ``moe_apply_ep`` (dropless) within
               EP_TOL of ``moe_apply``, grads finite and nonzero; (e) the
               training launcher under ``torch.distributed.run`` at
               ``--mesh 2x1`` (full depth, a step of 8 x 128, the clipped
               fused chain): equal losses on both ranks; in the spawned
               ranks, ``DP_LAYERS`` at full width, fp32: step 1's params
               within DP_RTOL of the 1-rank step on the whole batch, and
               ``compressed_psum_int8`` on one full-width leaf's local
               gradients within JAX's bounds.  The ranks load the kernels
               this process built; each group of ranks is joined within
               DIST_TIMEOUT and killed past it.
 19. TP and  — tensor-parallel and FSDP SYMOG training, two ranks on the
     FSDP      card over gloo: (a) the training launcher under
     training  ``torch.distributed.run`` at ``--mesh 1x2``, internlm2-1.8b
               at full width and depth, bf16, the clipped chain, 2 steps of
               8 x 128: exit 0, the ranks' losses equal, losses and grad
               norms finite; every rank's step ms and peak bytes (beside
               the reckoned state) and the collectives a step printed;
               (b)–(d) spawned ranks, fp32, the launcher's optimizer, one
               step of 8 x 128 from the seeded init, rank 0 taking the
               1-rank step first: (b) internlm2 at ``TPT_LAYERS`` of 24,
               ``dp_tp`` at (1, 2), fused and composed; (c) olmoe at
               ``EPT_LAYERS`` of 16, ``moe_impl='ep'``, capacity factor 8
               (neither route drops), 32 local experts and their f; (d)
               gemma2-27b at ``FSDP_LAYERS`` of 46, ``fsdp_tp`` at (2, 1)
               (the ``embed`` dims split over 'data').  Gates: every leaf
               gathered to rank 0 within TRAIN_RTOL (of its max) of the
               1-rank step, loss and clip scale equal on both ranks, loss
               and grad norm within TRAIN_RTOL of 1 rank, ``symog_update``
               and ``symog_sqnorm`` launched once a quantizable leaf (fused;
               none composed), and on each rank's shard of one leaf (an
               expert slice, a Δ per (layer, expert), in (c)) with the
               whole leaf's λ_eff: the update bit-identical to its plain
               version and the norm pass within SQNORM_RTOL of its plain
               version, each the same bits on two calls; their times
               beside the byte bounds, the step's ms, peak bytes, and the
               gloo share of the step (collectives timed) printed.
 20. family  — tensor-parallel forms of mamba2, recurrentgemma, whisper
     TP        and paligemma, in phase 19's two spawned ranks (after
               19b–19d; its seconds are phase 19's, the ranks' own
               seconds for 20a / 20b in this row), each family at full
               width and ``FAMILY_TP_LAYERS`` deep: (a) the
               2-bit packed artifact served at fp32 on a (1, 2) mesh, 4
               slots, 4 requests of 24..400 prompt tokens (each with its
               own frames / patches), 16 new each: streams token-identical
               to rank 0's 1-rank serve of the same artifact, every
               launch count equal to it, a repeat identical, the plan's
               pieces (SSD heads, RG-LRU heads and MLP, whisper's
               attention and MLP, paligemma's MLP, every vocab-parallel
               embedding), each rank's resident state / cross-kv / paged
               pool bytes beside one rank's, decode step ms and the gloo
               share of a serve; (b) one fp32 step of the launcher's
               clipped chain per family at ``dp_tp`` (1, 2), 8 x 128
               tokens (whisper's frames and paligemma's patches the
               training launcher's stubs), fused: every leaf within
               TRAIN_RTOL of the 1-rank step, loss and clip scale equal
               on both ranks, ``symog_update`` / ``symog_sqnorm`` once a
               quantizable leaf; (c) ``fixedpoint_matmul`` at one rank's
               projections of each family (M 4 and 512, bf16, 2-bit; the
               column-parallel biases of whisper on, its row-parallel ones
               off) and ``gqa_decode`` at whisper's 10 local heads, each
               against its plain version, timed beside its bound and
               ``torch.matmul`` / SDPA.
 21. dry run — ``launch/dryrun.py`` held to the card: (a) internlm2-1.8b
               training at full width and depth, 8 x 128 tokens, bf16
               ``cast_params``, remat on, the composed update: the step
               traced on fake tensors of the card at one rank, then run
               for real on the same routes; gated: ``op_cost``'s flops and
               dot_bytes of the real run equal the trace's, and
               ``max_memory_allocated`` (reset after the state is built)
               within 10% of the traced peak; the fused route's real peak,
               step ms and launches printed, and the card's total memory;
               (b) its 2-bit packed serve at 8 of its 24 layers
               (``SERVE_LAYERS``), a prefill of 4 x 512 and 32 decode
               steps on dense caches: the same two gates on the
               'unpack' route, the kernel route's peak and launches
               printed; (c) the dry-run CLI, a subprocess a cell, all
               started before phase 18 at niceness 10 (host cores only;
               phase 21 reads their records): internlm2 ``train_4k``, ``prefill_32k``,
               ``decode_32k`` and ``decode_32k --quantized``, mamba2
               ``long_500k`` and whisper ``long_500k`` at 16x16; gated:
               every status ``OK`` or ``SKIP`` as ``cell_supported``
               says; per-rank peak GB, dominant term and trace seconds
               printed.
Each serving and training path zeroes every kernel's launch count just
before it runs and reads them just after.
Then each phase's seconds and the total, the ``kernels`` summary line (the
seven kernels, the tensor-core and decode routes of both matmul forms,
MLA's tensor-core route for float and quantized pools, and the clipped
SYMOG update's two forms; each kernel's launches a rank in phases 18,
19 and 20, phase 20's per-rank kernel cases, and phase 21's launches), the nvidia-smi line, and the last line
``{"ok": true, "device": {...}}``.  Any failure exits non-zero before it.
The script imports no jax and nothing of the JAX package.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import subprocess
import sys
import tempfile
import time

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}  # dense, no sparsity
FPMM_SHAPES = [  # internlm2-1.8b per-layer projections, K x N
    ("q_proj", 2048, 2048), ("k_proj", 2048, 1024), ("v_proj", 2048, 1024),
    ("o_proj", 2048, 2048), ("gate_proj", 2048, 8192), ("up_proj", 2048, 8192),
    ("down_proj", 8192, 2048),
]
TOL = {  # kernel vs plain version
    "float32": dict(rtol=1e-5, atol=1e-5),  # tests/test_kernels.py bar
    "bfloat16": dict(rtol=1e-2, atol=1e-2),  # one bf16 rounding of the fp32 result
}
# attention: fp32 as tests/test_paged_attention.py; bf16 is a few output ulps
# (kernel and plain version both reduce in fp32 and round to bf16 once)
ATTN_TOL = {"float32": dict(rtol=2e-4, atol=2e-5), "bfloat16": dict(rtol=1e-2, atol=1e-2)}
PARITY_ATOL = 1e-3  # fp32 logits, 4 layers: same math, other summation orders
# the MLA launch counts: every launch of rows 4 / 5 (float / quantized pools),
# then the tensor-core route's alone
MLA_COUNTS = ("paged_attention_mla", "paged_attention_mla_quant", "paged_attention_mla_tc",
              "paged_attention_mla_tc_quant")
# rows 2 / 3 on the tensor-core prefill route alone (``paged_attention`` /
# ``paged_attention_quant`` count every launch of rows 2 / 3 on either route)
PREFILL_COUNTS = ("paged_attention_prefill", "paged_attention_prefill_quant")
PARITY_LAYERS = 4
SPEC_K = 4  # draft tokens a speculative round (phase 11c)
# depth cuts of earlier host-bound paths, so that the script stays inside its
# time limit: full width, the kernels' shapes unchanged, launches as
# the layers give them; an encoder-decoder's encoder cut with its decoder
SERVE_LAYERS = {"internlm2-1.8b": 8, "gemma3-4b": 12, "mamba2-2.7b": 4,
                "recurrentgemma-2b": 8, "whisper-large-v3": 2, "paligemma-3b": 9,
                "olmoe-1b-7b": 8}
# not below 12 / 8: shallower random-weight gemma3 / internlm2 sample their
# greedy streams at temperature 0.7, top-k 50 (phases 10 and 11c gate on a
# difference)
SPEC_LAYERS = 8  # internlm2's 24 in phase 11c
FAMILY_TRAIN_LAYERS = {"mamba2-2.7b": 4, "recurrentgemma-2b": 8,  # phase 16a
                       "whisper-large-v3": 2, "paligemma-3b": 9}
# the JAX package's serve metrics (src/repro/serve/scheduler.py:401-473):
# phase 13's launcher JSON must hold every one of them
SERVE_METRICS = tuple("serve_" + k for k in (
    "decode_steps", "idle_steps", "prefill_only_steps", "prefills", "prefill_chunks",
    "chunked_admissions", "admissions", "evictions", "preemptions", "cancellations",
    "tokens_emitted", "admission_traces", "admission_trace_compiles", "chunk_trace_compiles",
    "decode_trace_compiles", "peak_live_slots", "prefix_hits", "prefix_misses",
    "prefix_hit_tokens", "prefix_cow_copies", "prefix_evicted_blocks", "queue_wait_steps",
    "ttft_steps", "itl_seconds", "accepted_per_step", "live_slots", "queue_depth",
    "pool_live_blocks", "pool_free_blocks", "pool_cached_free_blocks",
    "step_time_ewma_seconds", "straggler_fraction", "pool_bytes", "pool_bytes_per_device"))
VERIFY_T = SPEC_K + 1  # the verify's query rows a batch row


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


class Failed(Exception):
    pass


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "unavailable"


def timed(fn, args_list, torch, reps: int = 5) -> float:
    """ms per call: a CUDA graph of ``len(args_list)`` (>= 16) calls rotating
    over the operand copies, replayed ``reps`` times between CUDA events."""
    n = max(16, len(args_list))
    for a in args_list[:2]:
        fn(*a)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for i in range(n):
            fn(*args_list[i % len(args_list)])
    g.replay()
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        g.replay()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / (reps * n)


def copies_for(nbytes: int) -> int:
    """Operand copies whose total exceeds the 50 MB L2 (cold reads, as in
    serving, where each layer's weights are read once per step)."""
    return max(2, min(64, math.ceil(128e6 / max(nbytes, 1))))


def bound(nbytes: int, flops: int, dtype_name: str):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# phase 3a: fixedpoint_matmul
# ---------------------------------------------------------------------------
ROUTE_KEY = {"streaming": "stream", "tensor_core": "tc", "decode": "dec"}  # row key prefixes


def _bf16_routes(dt, rows: int):
    """The routes a bf16 case forces, checks and times beside the streaming
    kernel: the decode kernel up to its row limit, else the tensor cores
    (prefill sizes); none for fp32 (streaming only)."""
    from repro_torch.kernels.fixedpoint_matmul import ops as fops

    if str(dt) != "torch.bfloat16":
        return ()
    return ("decode",) if rows <= fops.DECODE_MAX_ROWS else ("tensor_core",)


def _routes(torch, row, call, ref, route, args, slow, check):
    """A bf16 case: each route of ``check`` forced, held to the plain
    version at the bf16 bar and bit-identical over two calls; when ``args``
    are given, those routes and the streaming kernel timed (``ms`` is the
    route the rule picks; a ``slow`` streaming call is timed with CUDA events
    over single calls).  Returns False if a check failed."""
    ok = True
    for r in check:
        key = ROUTE_KEY[r]
        yt = [call(r, *args[0]) if args else call(r) for _ in range(2)]
        torch.cuda.synchronize()
        row[f"{key}_max_abs_err"] = (yt[0].float() - ref.float()).abs().max().item()
        row[f"{key}_bit_identical"] = bool(torch.equal(yt[0], yt[1]))
        ok = (ok and bool(torch.allclose(yt[0].float(), ref.float(), **TOL["bfloat16"]))
              and row[f"{key}_bit_identical"])
        del yt
    row["route"] = route
    if args:
        for r in dict.fromkeys(check + ("streaming",)):
            if r == "streaming" and slow:
                row["stream_ms"] = events_ms(lambda: call("streaming", *args[0]), 3, torch)
                row["stream_timing"] = "CUDA events, single calls"
            else:
                row[f"{ROUTE_KEY[r]}_ms"] = timed(lambda *a, r=r: call(r, *a), args, torch)
        row["ms"] = row[f"{ROUTE_KEY[route]}_ms"]
    return ok


def _fpmm_case(torch, gen, dev, name, K, N, M, dt, n_bits, *, with_bias, timing, routes=(),
               plain=True, library=True):
    """One 2-D case: Gaussian weights packed with their optimal f, x (M, K)
    of ``dt``, the kernel the route rule picks held to its plain version;
    timed (kernel, plain, ``torch.matmul`` on the dequantized weight) when
    ``timing``.  ``routes`` (bf16): those kernels forced, checked and timed
    beside the streaming one (``_routes``).  A plain version whose fp32
    unpacked weight exceeds 1 GB is timed with CUDA events over single calls
    (a graph of 16 would hold 16 sets of its temporaries)."""
    from repro_torch.core import optimal_f, unpack_int
    from repro_torch.kernels.fixedpoint_matmul import ops as fops
    from repro_torch.kernels.fixedpoint_matmul.ref import fixedpoint_matmul_ref

    dname = str(dt).split(".")[-1]
    w = torch.randn((K, N), generator=gen, device=dev) / math.sqrt(K)
    f, _ = optimal_f(w, n_bits)
    f = f.to(torch.int32)
    pw = fops.pack_weight(w, f, n_bits)
    del w
    x = torch.randn((M, K), generator=gen, device=dev).to(dt)
    bias = torch.randn((N,), generator=gen, device=dev) * 0.1 if with_bias else None
    y = fops.fixedpoint_matmul(x, pw, f, bias, n_bits=n_bits, n_out=N)
    ref = fixedpoint_matmul_ref(x, pw, f, bias, n_bits=n_bits, n_out=N).to(dt)
    torch.cuda.synchronize()
    err = (y.float() - ref.float()).abs().max().item()
    tol = TOL[dname]
    ok = bool(torch.allclose(y.float(), ref.float(), **tol))
    del y
    wbytes = pw.numel()
    io = x.numel() * x.element_size() + wbytes + 4 + M * N * x.element_size()
    io += 0 if bias is None else N * 4
    b_ms, b_by = bound(io, 2 * M * K * N, dname)
    row = {"phase": "kernel", "kernel": "fixedpoint_matmul", "proj": name, "M": M, "K": K,
           "N": N, "n_bits": n_bits, "dtype": dname, "bias": bias is not None,
           "route": fops._pick_route(dt, M, True), "max_abs_err": err, "tol": tol}

    def call(route, a=x, b=pw):
        return fops.fixedpoint_matmul(a, b, f, bias, n_bits=n_bits, n_out=N, _route=route)

    args = None
    if timing:
        n = copies_for(wbytes)
        args = list(zip([x.clone() for _ in range(n)], [pw.clone() for _ in range(n)]))
    if routes:
        ok = _routes(torch, row, call, ref, row["route"], args, 2 * M * K * N > 1e11,
                     routes) and ok
    del ref
    row["pass"] = ok
    if timing:
        if not routes:
            row["ms"] = timed(lambda a, b: call(None, a, b), args, torch)
        if plain and K * N * 4 > 1e9:
            row["plain_ms"] = events_ms(lambda: fixedpoint_matmul_ref(
                args[0][0], args[0][1], f, bias, n_bits=n_bits, n_out=N), 5, torch)
            row["plain_timing"] = "CUDA events, single calls"
        elif plain:
            row["plain_ms"] = timed(lambda a, b: fixedpoint_matmul_ref(a, b, f, bias,
                                                                       n_bits=n_bits, n_out=N),
                                    args, torch)
        if library:
            wd = (unpack_int(pw, n_bits, N).float() * torch.exp2(-f.float())).to(dt)
            nl = copies_for(wd.numel() * wd.element_size())
            wds = [wd] + [wd.clone() for _ in range(nl - 1)]
            del wd
            row["library_ms"] = timed(lambda a, b: torch.matmul(a, b),
                                      [(args[i % len(args)][0], wds[i]) for i in range(nl)],
                                      torch)
            del wds
        row["bound_ms"], row["bound_by"] = b_ms, b_by
        row["achieved_GBps"] = io / (row["ms"] * 1e-3) / 1e9
        row["achieved_TFLOPs"] = 2 * M * K * N / (row["ms"] * 1e-3) / 1e12
        del args
    return row


PREFILL_M = (32, 64, 128, 256, 512)  # the serve's prompt buckets


def _err(row):
    return max([row["max_abs_err"]] + [row[f"{k}_max_abs_err"] for k in ROUTE_KEY.values()
                                       if f"{k}_max_abs_err" in row])


def _bound_by(rows) -> str:
    """What bounds a sum of cases: the bound that bounds the most of its time."""
    t = {"bytes": 0.0, "operations": 0.0}
    for r in rows:
        t[r["bound_by"]] += r["bound_ms"]
    return max(t, key=t.get)


def _route_err(rows, route: str) -> float:
    """Largest error of one kernel over ``rows``: the calls the rule sent
    to ``route``, and the calls forced onto it."""
    key = f"{ROUTE_KEY[route]}_max_abs_err"
    errs = [r["max_abs_err"] for r in rows if r["route"] == route]
    return max(errs + [r[key] for r in rows if key in r])


def phase_fpmm(torch, dev):
    """Row 1 at internlm2-1.8b's 7 projections: M = 4 (decode) in bf16 and
    fp32, 2 and 4 bits, M = 128 in fp32, and the prefill buckets M = 32..512
    in bf16 at 2 bits (plus M = 128 at 4 bits); every bf16 case checks and
    times its rule's kernel (decode at M = 4, the tensor cores at prefill)
    beside the streaming one.  Returns the rows and the sums over one layer
    at M = 4 and at M = 512 (bf16, 2-bit)."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    rows = []
    decode = {"ms": 0.0, "stream_ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0}
    prefill = {"ms": 0.0, "stream_ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0}
    bf16, fp32 = torch.bfloat16, torch.float32
    cases = []  # (n_bits, M, dtype, timed)
    for n_bits in (2, 4):
        cases += [(n_bits, 4, bf16, True), (n_bits, 4, fp32, True),
                  (n_bits, 128, fp32, n_bits == 2)]
    cases += [(2, M, bf16, True) for M in PREFILL_M] + [(4, 128, bf16, False)]
    for n_bits, M, dt, timing in cases:
        for name, K, N in FPMM_SHAPES:
            row = _fpmm_case(torch, gen, dev, name, K, N, M, dt, n_bits, with_bias=M >= 128,
                             timing=timing, routes=_bf16_routes(dt, M))
            if n_bits == 2 and dt == bf16 and M in (4, 512):
                acc = decode if M == 4 else prefill
                for k in acc:
                    acc[k] += row[k]
            emit(row)
            rows.append(row)
            if not row["pass"]:
                raise Failed(f"fixedpoint_matmul {name} M={M} bits={n_bits} {row['dtype']}: "
                             f"err {_err(row)}")
    prefill["bound_by"] = _bound_by(r for r in rows if r["M"] == 512)
    return rows, decode, prefill


# deepseek-v3's 2-D packed projections, K x N: the MLA layer's (kv_b_k /
# kv_b_v, 512 x 16384 each, run through the kernel at prefill only; decode
# absorbs them), the dense layers' MLP, the shared expert, the untied head
DEEPSEEK_FPMM_SHAPES = [
    ("q_a_proj", 7168, 1536), ("q_b_proj", 1536, 24576), ("kv_a_proj", 7168, 512),
    ("k_rope_proj", 7168, 64), ("kv_b_k_proj", 512, 16384), ("o_proj", 16384, 7168),
    ("mlp gate_proj", 7168, 18432), ("mlp down_proj", 18432, 7168),
    ("shared gate_proj", 7168, 2048), ("shared down_proj", 2048, 7168),
    ("lm_head", 7168, 129280),
]
# one MoE layer's 2-D matmuls at decode: 5 MLA projections, the shared expert's 3
DEEPSEEK_DECODE_LAYER = {"q_a_proj": 1, "q_b_proj": 1, "kv_a_proj": 1, "k_rope_proj": 1,
                         "o_proj": 1, "shared gate_proj": 2, "shared down_proj": 1}


def phase_fpmm_deepseek(torch, dev):
    """Row 1 at deepseek-v3's 2-D shapes, 2-bit (the serve phase's width),
    M = 4 (decode) and 128 in bf16 (serve) and fp32 (parity), and M = 512
    in bf16; every bf16 case checks and times its rule's kernel beside the
    streaming one (the plain version at M = 4 and 128).  Returns the rows
    and the sums over one MoE layer's decode matmuls at M = 4 bf16."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    rows = []
    layer = {"ms": 0.0, "stream_ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0}
    bf16, fp32 = torch.bfloat16, torch.float32
    for name, K, N in DEEPSEEK_FPMM_SHAPES:
        for M, dt in ((4, bf16), (4, fp32), (128, bf16), (128, fp32), (512, bf16)):
            row = _fpmm_case(torch, gen, dev, name, K, N, M, dt, 2, with_bias=False,
                             timing=True, routes=_bf16_routes(dt, M), plain=M < 512)
            row["arch"] = DEEPSEEK
            if M == 4 and dt == bf16 and name in DEEPSEEK_DECODE_LAYER:
                for k in layer:
                    layer[k] += DEEPSEEK_DECODE_LAYER[name] * row[k]
            emit(row)
            rows.append(row)
            if not row["pass"]:
                raise Failed(f"fixedpoint_matmul deepseek {name} M={M} {row['dtype']}: "
                             f"err {_err(row)}")
        torch.cuda.empty_cache()
    return rows, layer


# gemma3-4b's 2-D packed projections, K x N: one layer's 7, and the tied
# 262,144-row read-out as a (d, vocab) matrix
GEMMA3_FPMM_SHAPES = [
    ("q_proj", 2560, 2048), ("k_proj", 2560, 1024), ("v_proj", 2560, 1024),
    ("o_proj", 2048, 2560), ("gate_proj", 2560, 10240), ("up_proj", 2560, 10240),
    ("down_proj", 10240, 2560), ("head", 2560, 262144),
]


def phase_fpmm_gemma3(torch, dev):
    """Row 1 at gemma3-4b's shapes, 2-bit, bf16: one layer's 7 projections
    at M = 4 (decode) and 512 (a prefill bucket), and the 262,144-row head
    at M = 4; each holds its rule's kernel to the plain version and times it
    beside the streaming kernel, ``torch.matmul`` and the bound.  (The serve
    reads the tied head through ``embed_logits``, which dequantizes the
    table, as the JAX package does: the phase times that too.)  Also the
    layer at phase 11a's tail buckets: M = 256 (a chunk) and 32 (a prefix
    hit's tail).  Returns the rows, the layer's sums at M = 4, the head's
    row and the layer's sums at M = 32 and 256."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(8)
    rows = []
    keys = ("ms", "stream_ms", "plain_ms", "library_ms", "bound_ms")
    layer = dict.fromkeys(keys, 0.0)
    tails = {M: dict.fromkeys(keys, 0.0) for M in (32, 256)}
    head = None
    for name, K, N in GEMMA3_FPMM_SHAPES:
        for M in ((4,) if name == "head" else (4, 32, 256, 512)):
            row = _fpmm_case(torch, gen, dev, name, K, N, M, torch.bfloat16, 2,
                             with_bias=False, timing=True,
                             routes=_bf16_routes(torch.bfloat16, M))
            row["arch"] = "gemma3-4b"
            if name == "head":
                head = row
            elif M == 4:
                for k in layer:
                    layer[k] += row[k]
            elif M in tails:
                for k in keys:
                    tails[M][k] += row[k]
            emit(row)
            rows.append(row)
            if not row["pass"]:
                raise Failed(f"fixedpoint_matmul gemma3 {name} M={M}: err {_err(row)}")
        torch.cuda.empty_cache()
    return rows, layer, head, tails


# ---------------------------------------------------------------------------
# phase 3b: paged attention
# ---------------------------------------------------------------------------
def _attn_case(torch, gen, dev, *, B, K, G, hd, block, max_blocks, T, dt, int8, q_mult,
               pos_last=(280, 320)):
    n_phys = B * max_blocks + 1
    perm = torch.randperm(n_phys - 1, generator=gen, device=dev)[: B * max_blocks] + 1
    bt = perm.reshape(B, max_blocks).to(torch.int32)
    pos_last = torch.randint(*pos_last, (B,), generator=gen, device=dev)
    pos0 = (pos_last - (T - 1)).to(torch.int32)
    shape = (n_phys, block, K, hd)
    kp = torch.randn(shape, generator=gen, device=dev)
    vp = torch.randn(shape, generator=gen, device=dev)
    if int8:
        kp = torch.clamp(torch.round(kp * 0.5 * 32), -127, 127).to(torch.int8)
        vp = torch.clamp(torch.round(vp * 0.5 * 32), -127, 127).to(torch.int8)
    else:
        kp, vp = kp.to(dt), vp.to(dt)
    q = (torch.randn((B, T, K, G, hd), generator=gen, device=dev) * q_mult).to(dt)
    return q, kp, vp, bt, pos0


def _sdpa_ms(torch, q, kl, vl, pos0, window) -> float:
    """The library yardstick of a paged-attention case: one
    ``scaled_dot_product_attention`` over the gathered logical cache (kl, vl
    (B, S, K, hd), already dequantized, in q's dtype) under the causal /
    window mask, its K/V copies rotated past the L2.  Timed only."""
    import torch.nn.functional as F

    B, T, K, G, hd = q.shape
    dev = q.device
    kv_pos = torch.arange(kl.shape[1], device=dev)
    q_pos = pos0.long()[:, None] + torch.arange(T, device=dev)[None]
    mask = kv_pos[None, None] <= q_pos[:, :, None]
    if window is not None:
        mask = mask & (q_pos[:, :, None] - kv_pos[None, None] < window)
    qs = q.reshape(B, T, K * G, hd).transpose(1, 2)
    ks = kl.transpose(1, 2).repeat_interleave(G, dim=1)
    vs = vl.transpose(1, 2).repeat_interleave(G, dim=1)
    n = copies_for(ks.numel() * ks.element_size() * 2)
    args = [(qs, ks.clone(), vs.clone()) for _ in range(n)]
    return timed(lambda a, b, c: F.scaled_dot_product_attention(a, b, c, attn_mask=mask[:, None]),
                 args, torch)


SWEEP_TOKENS = (64, 300, 500)  # about this many cached tokens a row


def _attn_length_sweep(torch, dev, gen, *, quant: bool):
    """Timed only: the phase's main decode shape (internlm2: bf16 pool, K 8,
    G 2; olmoe: int4 pool, K 16, G 1; B 4, T 1, bf16 queries) with rows of
    about 64, 300 and 500 cached tokens: the kernel, SDPA, the byte bound
    and the rate the kernel reached."""
    from repro_torch.kernels.paged_attention import ops as aops
    from repro_torch.kernels.paged_attention.ref import dequant_logical, gather_logical

    hd, block, max_blocks, B, T, dt = 128, 16, 32, 4, 1, torch.bfloat16
    K, G = (16, 1) if quant else (8, 2)
    rows = []
    for tokens in SWEEP_TOKENS:
        span = (tokens - 8, min(tokens + 8, max_blocks * block))
        shape = dict(B=B, K=K, G=G, hd=hd, block=block, max_blocks=max_blocks, T=T, dt=dt,
                     q_mult=1.0, pos_last=span)
        if quant:
            q, kp, vp, ke, ve, bt, pos0 = _attn_quant_case(torch, gen, dev, bits=4, wide=True,
                                                           **shape)
            kw = dict(k_scale_exp=ke, v_scale_exp=ve, kv_bits=4)
            args = [(kp.clone(), vp.clone(), ke.clone(), ve.clone())
                    for _ in range(copies_for((kp.numel() + ke.numel() * 4) * 2))]
            kl, vl = (dequant_logical(p, e, bt, kv_bits=4).to(dt) for p, e in ((kp, ke), (vp, ve)))
            per_block = block * K * kp.shape[-1] + 4 * K
        else:
            q, kp, vp, bt, pos0 = _attn_case(torch, gen, dev, int8=False, **shape)
            kw = {}
            args = [(kp.clone(), vp.clone(), None, None)
                    for _ in range(copies_for(kp.numel() * kp.element_size() * 2))]
            kl, vl = gather_logical(kp, bt), gather_logical(vp, bt)
            per_block = block * K * hd * kp.element_size()
        kw = dict(kw, scale=hd**-0.5)
        vis_blocks = ((pos0.long() + T - 1) // block + 1).sum().item()
        io = 2 * q.numel() * q.element_size() + 2 * vis_blocks * per_block + bt.numel() * 4 + B * 4
        b_ms, b_by = bound(io, 4 * (pos0.long() + T).sum().item() * T * K * G * hd, "bfloat16")

        def call(a, b, e, f):
            ekw = dict(kw, k_scale_exp=e, v_scale_exp=f) if quant else kw
            return aops.paged_attention(q, a, b, bt, pos0, **ekw)

        ms = timed(call, args, torch)
        row = {"phase": "kernel_sweep", "kernel": "paged_attention_quant" if quant
               else "paged_attention", "B": B, "K": K, "G": G, "hd": hd, "block": block, "T": T,
               "pool": "int4" if quant else "bfloat16", "q_dtype": "bfloat16",
               "mean_cached_tokens": (pos0.float() + T).mean().item(), "ms": ms,
               "library_ms": _sdpa_ms(torch, q, kl, vl, pos0, None), "bound_ms": b_ms,
               "bound_by": b_by, "achieved_GBps": io / (ms * 1e-3) / 1e9}
        del args, kl, vl
        emit(row)
        rows.append(row)
    return rows


def _ptxas(kernel: str):
    """Registers, spill stores / loads and stack of each instantiation of
    ``kernel`` in the last build's ptxas report (``build.build_log``)."""
    import re

    from repro_torch.kernels import build

    out, name = {}, None
    for line in build.build_log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?([\w$]+)", line)
        if m:
            t = re.search(kernel + r"ILi(\d+)ELi(\d+)E", m.group(1))  # <pool code, max hd>
            name = f"pool {t.group(1)}, hd <= {t.group(2)}" if t else None
            continue
        if name is None:
            continue
        rec = out.setdefault(name, {})
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill "
                      r"loads", line)
        if m:
            rec.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            rec["registers"] = int(m.group(1))
    return out


def _case_entry(row):
    """A kernel case's shape, times and bound, for the ``kernels`` line."""
    keys = ("arch", "B", "K", "G", "hd", "T", "pos0", "window", "cap", "q_mult", "M", "N",
            "mean_cached_tokens", "max_abs_err", "ms", "plain_ms", "library_ms", "bound_ms",
            "bound_by", "bytes_bound_ms", "achieved_GBps", "achieved_TFLOPs")
    return {k: row[k] for k in keys if k in row}


def _sweep_entry(row):
    return {k: row[k] for k in ("mean_cached_tokens", "ms", "library_ms", "bound_ms",
                                "achieved_GBps")}


def _visible_blocks(pos0, T: int, window, block: int, max_blocks: int = None) -> int:
    """Blocks the query rows of each batch row can see, summed over rows:
    from the first row's window start to the last row's position, which
    the kernel clamps to the table's last slot (``max_blocks``)."""
    hi = (pos0.long() + T - 1) // block
    if max_blocks is not None:
        hi = hi.clamp(max=max_blocks - 1)
    lo = 0 if window is None else (pos0.long() - window + 1).clamp(min=0) // block
    return int((hi - lo + 1).sum().item())


def _visible_keys(pos0, T: int, window, max_keys: int = None) -> int:
    """Keys the T query rows of each batch row attend, summed: query t of
    row b sees min(pos0[b] + t + 1, window) keys (and no more than the
    table holds, ``max_keys``)."""
    import torch

    t = pos0.long()[:, None] + torch.arange(1, T + 1, device=pos0.device)[None]
    if max_keys is not None:
        t = t.clamp(max=max_keys)
    if window is not None:
        t = t.clamp(max=window)
    return int(t.sum().item())


# the decode shapes of the dense configs (bf16 queries and pool): gemma3's
# head_dim 256 under its 1,024-token window, granite's MQA (K 1, G 48),
# gemma2's softcap 50 under its 4,096-token window; rows long enough that
# each window binds
DENSE_ATTN_CASES = [
    dict(arch="gemma3-4b", B=4, K=4, G=2, hd=256, max_blocks=128, pos_last=(1500, 1900),
         window=1024, cap=0.0, scale=256**-0.5),
    dict(arch="granite-34b", B=4, K=1, G=48, hd=128, max_blocks=32, pos_last=(280, 320),
         window=None, cap=0.0, scale=128**-0.5),
    dict(arch="gemma2-27b", B=4, K=16, G=2, hd=128, max_blocks=320, pos_last=(4400, 5000),
         window=4096, cap=50.0, scale=144.0**-0.5),
]


def phase_attn(torch, dev):
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    base = dict(B=4, K=8, G=2, hd=128, block=16, max_blocks=32, pos_last=(280, 320))
    # The int8 case scales q so that |logit|/cap is about 1 and keeps the window
    # to 4-5 blocks: with the plain version on the same inputs, dropping the
    # softcap moves the output by > 1 and a window off by one by ~0.08, both far
    # outside the bf16 tolerance.
    cases = [
        dict(T=1, dt=torch.bfloat16, int8=False, window=None, cap=0.0, q_mult=1.0),
        dict(T=4, dt=torch.bfloat16, int8=False, window=None, cap=0.0, q_mult=1.0),
        dict(T=1, dt=torch.bfloat16, int8=True, window=64, cap=2.0, q_mult=4.0),
        dict(T=1, dt=torch.float32, int8=False, window=None, cap=0.0, q_mult=1.0),
    ]
    cases += [dict(T=1, dt=torch.bfloat16, int8=False, q_mult=1.0,
                   shape={k: c[k] for k in ("B", "K", "G", "hd", "max_blocks", "pos_last")},
                   **{k: c[k] for k in ("arch", "window", "cap", "scale")})
              for c in DENSE_ATTN_CASES]
    # the speculative verify (phase 11c's launch: internlm2, bf16 pool, B 4,
    # T = k + 1 = 5, ragged pos0 of ~300), with the last row's queries
    # running past the table's end, where the kernel clamps them
    cases.append(dict(T=VERIFY_T, dt=torch.bfloat16, int8=False, window=None, cap=0.0,
                      q_mult=1.0, verify=True))
    rows, main = [], None
    for c in cases:
        row = _attn_dense_case(torch, gen, dev, dict(base, **c.get("shape", {})), c)
        rows.append(row)
        main = main or row
    main["length_sweep"] = _attn_length_sweep(torch, dev, gen, quant=False)
    return rows, max(r["max_abs_err"] for r in rows), main


def _attn_dense_case(torch, gen, dev, shape, c):
    """One case of the float / KV_F int8 GQA kernel (phase 3b and 14b): the
    kernel against its plain version, bit-identical over two calls, timed
    beside the plain version and SDPA, with its bound.  Emits the row and
    fails the phase on a miss."""
    from repro_torch.kernels.paged_attention import ops as aops
    from repro_torch.kernels.paged_attention.ref import gather_logical, paged_attention_ref

    T, dt, int8 = c["T"], c["dt"], c["int8"]
    B, K, G, hd, block = (shape[k] for k in ("B", "K", "G", "hd", "block"))
    dname = str(dt).split(".")[-1]
    q, kp, vp, bt, pos0 = _attn_case(torch, gen, dev, T=T, dt=dt, int8=int8,
                                     q_mult=c["q_mult"], **shape)
    mb = shape["max_blocks"]
    if c.get("verify"):
        pos0[-1] = mb * block - 2  # positions mb·block - 2 .. + 2: past the table
    kv_scale = 2.0**-5 if int8 else 1.0
    kw = dict(scale=c.get("scale", hd**-0.5), cap=c["cap"], window=c["window"],
              kv_scale=kv_scale)
    rule = aops._gqa_route(dt, aops._pool_code(kp.dtype, 0), kv_scale, hd, block, T * G)
    n0 = aops.prefill_launches
    out = aops.paged_attention(q, kp, vp, bt, pos0, **kw)
    again = aops.paged_attention(q, kp, vp, bt, pos0, **kw)
    ref = paged_attention_ref(q, kp, vp, bt, pos0, **kw)
    torch.cuda.synchronize()
    on_route = aops.prefill_launches - n0 == (2 if rule == "prefill" else 0)
    err = (out.float() - ref.float()).abs().max().item()
    tol = ATTN_TOL[dname]
    same = bool(torch.equal(out, again))
    ok = bool(torch.allclose(out.float(), ref.float(), **tol)) and same and on_route
    # bytes this run's data needs: the blocks each row can see, once
    kv_bytes = 2 * _visible_blocks(pos0, T, c["window"], block, mb) * block * K * hd * \
        kp.element_size()
    io = 2 * q.numel() * q.element_size() + kv_bytes + bt.numel() * 4 + B * 4
    flops = 4 * _visible_keys(pos0, T, c["window"], mb * block) * K * G * hd
    b_ms, b_by = bound(io, flops, dname)
    n = copies_for(kp.numel() * kp.element_size() * 2)
    pools = [(kp.clone(), vp.clone()) for _ in range(n)]
    args = [(q, a, b) for a, b in pools]
    row = {"phase": "kernel", "kernel": "paged_attention", "arch": c.get("arch"), "B": B,
           "K": K, "G": G, "hd": hd, "block": block, "T": T,
           "kv_dtype": str(kp.dtype).split(".")[-1], "q_dtype": dname,
           "window": c["window"], "cap": c["cap"], "q_mult": c["q_mult"],
           "verify": c.get("verify", False), "of": c.get("of"), "pos0": pos0.tolist(),
           "mean_cached_tokens": (pos0.float() + T).mean().item(), "max_abs_err": err,
           "tol": tol, "bit_identical": same, "route": rule, "launched_on_route": on_route,
           "pass": ok}
    row["ms"] = timed(lambda a, b, cc: aops.paged_attention(a, b, cc, bt, pos0, **kw),
                      args, torch)
    if rule == "prefill":  # the decode kernel on the same inputs, for the record
        row["decode_route_ms"] = timed(lambda a, b, cc: aops.paged_attention(
            a, b, cc, bt, pos0, _route="decode", **kw), args, torch)
    row["plain_ms"] = timed(lambda a, b, cc: paged_attention_ref(a, b, cc, bt, pos0, **kw),
                            args, torch)
    # library yardstick: SDPA over the gathered (logical) cache; timed
    # only, and without the softcap, which SDPA does not compute
    if c["cap"] and "arch" not in c:
        row["library_ms"] = None
    else:
        row["library_ms"] = _sdpa_ms(
            torch, q, gather_logical(kp, bt).to(dt) * kv_scale,
            gather_logical(vp, bt).to(dt) * kv_scale, pos0, c["window"])
        if c["cap"]:
            row["library_note"] = "SDPA without the softcap (it has none)"
    row["bound_ms"], row["bound_by"] = b_ms, b_by
    row["achieved_GBps"] = io / (row["ms"] * 1e-3) / 1e9
    del pools, args
    emit(row)
    if not ok:
        raise Failed(f"paged_attention case {c}: err {err}, bit-identical {same}, "
                     f"route {rule} launched {on_route}")
    return row


# ---------------------------------------------------------------------------
# phase 3d: fixedpoint_matmul_experts (olmoe's expert stacks, one f per expert)
# ---------------------------------------------------------------------------
OLMOE_EXPERT_SHAPES = [  # olmoe-1b-7b per-layer expert stacks, E x K x N
    ("gate_proj", 2048, 1024), ("up_proj", 2048, 1024), ("down_proj", 1024, 2048),
]
N_EXPERTS = 64


def _experts_stack(torch, gen, dev, E, K, N, n_bits):
    """(words, f, sc): Gaussian weights, expert e scaled by 2^s_e, packed
    with one f per expert; the stack is drawn and scaled in place (one fp32
    copy: 15 GB for a deepseek-v3 stack)."""
    from repro_torch.core import optimal_f, pack

    sc = torch.exp2(torch.randint(-2, 3, (E, 1, 1), generator=gen, device=dev).float())
    w = torch.randn((E, K, N), generator=gen, device=dev).mul_(sc / math.sqrt(K))
    f = torch.stack([optimal_f(w[e], n_bits)[0] for e in range(E)]).to(torch.int32)
    words = pack(w, f, n_bits).data
    del w
    return words, f, sc


TOP_K, DECODE_TOKENS = 8, 4  # both MoE models route top-8; the serves decode 4 slots
# one layer's 3 stacks at a decode step: the decode kernel reading the
# occupied experts, the same kernel and the streaming one reading all
DECODE_SUMS = ("ms", "dec_all_ms", "stream_ms", "plain_ms", "library_ms", "bound_ms",
               "bound_all_ms", "occupied")


def _routing(torch, gen, dev, E):
    """rows (E,) int32: each expert's assignments under a top-8 routing of 4
    random tokens, as ``moe_apply`` counts them at a decode step."""
    idx = torch.randn((DECODE_TOKENS, E), generator=gen, device=dev).topk(TOP_K, dim=-1)[1]
    idx = idx.reshape(-1)
    return torch.zeros(E, dtype=torch.int32, device=dev).scatter_add_(
        0, idx, torch.ones_like(idx, dtype=torch.int32))


def _experts_case(torch, gen, dev, name, words, f, sc, C, dt, n_bits, N, *, timing,
                  routes=(), plain=True, routed=False):
    """One experts case: x (E, C, K) of ``dt`` with expert e's rows scaled
    by 2^-s_e, the kernel the route rule picks held to its plain version;
    timed (kernel, plain, ``torch.bmm`` on the dequantized stack) when
    ``timing``; ``routes`` (bf16): those kernels forced, checked and timed
    beside the streaming one (``_routes``).  ``routed`` (a decode step):
    the rows of x a top-8 routing of 4 tokens fills (the rest zero) and
    their count per expert passed as ``rows``; the output must equal, bit
    for bit, the same kernel computing every expert, and ``bound_ms``
    counts the occupied experts' bytes (``bound_all_ms`` every expert's).
    A stack whose fp32 unpacking exceeds 1 GB is timed with CUDA events
    over single calls of the plain version and ``torch.bmm`` (a graph of 16
    plain calls would hold 16 sets of its temporaries)."""
    from repro_torch.core import unpack_int
    from repro_torch.kernels.fixedpoint_matmul import ops as fops
    from repro_torch.kernels.fixedpoint_matmul.ref import fixedpoint_matmul_experts_ref

    E, K = words.shape[0], words.shape[1]
    dname = str(dt).split(".")[-1]
    x = torch.randn((E, C, K), generator=gen, device=dev) / sc
    kw, occ = {}, E
    if routed:
        rows = _routing(torch, gen, dev, E)
        x[torch.arange(C, device=dev)[None, :] >= rows[:, None]] = 0.0
        kw = dict(rows=rows, max_active=min(E, DECODE_TOKENS * TOP_K))
        occ = int((rows > 0).sum().item())
    x = x.to(dt)
    y = fops.fixedpoint_matmul_experts(x, words, f, n_bits=n_bits, n_out=N, **kw)
    ref = fixedpoint_matmul_experts_ref(x, words, f, n_bits=n_bits, n_out=N,
                                        rows=kw.get("rows")).to(dt)
    torch.cuda.synchronize()
    err = (y.float() - ref.float()).abs().max().item()
    tol = TOL[dname]
    ok = bool(torch.allclose(y.float(), ref.float(), **tol))
    wbytes = words.numel()
    out_b = E * C * N * x.element_size()
    io = x.numel() * x.element_size() + wbytes + 4 * E + out_b
    b_ms, b_by = bound(io, 2 * E * C * K * N, dname)
    row = {"phase": "kernel", "kernel": "fixedpoint_matmul_experts", "proj": name,
           "E": E, "C": C, "K": K, "N": N, "n_bits": n_bits, "dtype": dname,
           "route": fops._pick_route(dt, C, True),
           "f_range": [int(f.min()), int(f.max())], "max_abs_err": err,
           "tol": tol, "bound_ms": b_ms, "bound_by": b_by}
    if routed:
        # what this run's data needs: the occupied experts' x and words, f
        # and rows, and every expert's output (+0 for the empty ones)
        io_occ = (x.numel() * x.element_size() + wbytes) * occ // E + 8 * E + out_b
        row.update(occupied=occ, max_active=kw["max_active"], bound_all_ms=b_ms,
                   bound_all_by=b_by)
        row["bound_ms"], row["bound_by"] = bound(io_occ, 2 * occ * C * K * N, dname)
        every = fops.fixedpoint_matmul_experts(x, words, f, n_bits=n_bits, n_out=N,
                                               max_active=kw["max_active"])
        row["equal_to_every_expert"] = bool(torch.equal(y, every))
        ok = ok and row["equal_to_every_expert"]
        del every
    del y

    def call(route, a=x, b=words, **extra):
        return fops.fixedpoint_matmul_experts(a, b, f, n_bits=n_bits, n_out=N, _route=route,
                                              **{**kw, **extra})

    args = [(x.clone(), words.clone()) for _ in range(copies_for(wbytes * occ // E))] \
        if timing else None
    if routes:
        ok = _routes(torch, row, call, ref, row["route"], args, False, routes) and ok
    del ref
    row["pass"] = ok
    if timing:
        if not routes:
            row["ms"] = timed(lambda a, b: call(None, a, b), args, torch)
        if routed:  # the same kernel reading every expert's words
            row["dec_all_ms"] = timed(lambda a, b: call("decode", a, b, rows=None), args, torch)
        big = wbytes * (8 // n_bits) * 4 > 1e9
        if plain and big:
            row["plain_ms"] = events_ms(lambda: fixedpoint_matmul_experts_ref(
                x, words, f, n_bits=n_bits, n_out=N), 3, torch)
        elif plain:
            row["plain_ms"] = timed(lambda a, b: fixedpoint_matmul_experts_ref(
                a, b, f, n_bits=n_bits, n_out=N), args, torch)
        del args
        wd = unpack_int(words, n_bits, N).to(dt).mul_(torch.exp2(-f.to(dt))[:, None, None])
        if big:
            row["plain_timing"] = row["library_timing"] = "CUDA events, single calls"
            row["library_ms"] = events_ms(lambda: torch.bmm(x, wd), 5, torch)
        else:
            nl = copies_for(wd.numel() * wd.element_size())
            largs = [(x, wd)] + [(x.clone(), wd.clone()) for _ in range(nl - 1)]
            row["library_ms"] = timed(lambda a, b: torch.bmm(a, b), largs, torch)
            del largs
        del wd
        row["achieved_GBps"] = io / (row["ms"] * 1e-3) / 1e9
        if routed:
            row["achieved_GBps_occupied"] = io_occ / (row["ms"] * 1e-3) / 1e9
    return row


def phase_fpmm_experts(torch, dev):
    """Stacks as SYMOG makes them: Gaussian weights, expert e scaled by 2^s_e
    (s_e in [-2, 2]) so that its own optimal f differs, packed with one f
    per expert; the expert's rows of x scaled by 2^-s_e keep every output
    at unit scale, where the fp32 bar of the 2-D phase applies.  C = 4
    (decode) in bf16 and fp32 and C = 80 in fp32, 2 and 4 bits; the olmoe
    prefill capacities C = 5, 20, 80 (buckets 32, 128, 512) in bf16 at 2
    bits (and C = 80 at 4 bits).  Every bf16 case checks and times its
    rule's kernel beside the streaming one; the bf16 C = 4 cases run a
    decode step's routing (``routed``).  Returns the rows and the sums over
    one layer's 3 stacks at C = 4 and at C = 80 (bf16, 2-bit)."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    E = N_EXPERTS
    rows = []
    decode = dict.fromkeys(DECODE_SUMS, 0.0)
    prefill = {"ms": 0.0, "stream_ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0}
    bf16, fp32 = torch.bfloat16, torch.float32
    for n_bits in (2, 4):
        cases = [(4, bf16, True), (4, fp32, True), (80, fp32, n_bits == 2)]
        cases += [(C, bf16, True) for C in (5, 20, 80)] if n_bits == 2 else [(80, bf16, False)]
        for name, K, N in OLMOE_EXPERT_SHAPES:
            words, f, sc = _experts_stack(torch, gen, dev, E, K, N, n_bits)
            for C, dt, timing in cases:
                row = _experts_case(torch, gen, dev, name, words, f, sc, C, dt, n_bits, N,
                                    timing=timing, routes=_bf16_routes(dt, C),
                                    routed=dt == bf16 and C == 4)
                if n_bits == 2 and dt == bf16 and C in (4, 80):
                    acc = decode if C == 4 else prefill
                    for k in acc:
                        acc[k] += row[k]
                emit(row)
                rows.append(row)
                if not row["pass"]:
                    raise Failed(f"fixedpoint_matmul_experts {name} C={C} bits={n_bits} "
                                 f"{row['dtype']}: err {_err(row)}")
            del words
    torch.cuda.empty_cache()
    prefill["bound_by"] = _bound_by(r for r in rows if r["C"] == 80 and r["dtype"] == "bfloat16"
                                    and r["n_bits"] == 2)
    return rows, decode, prefill


DEEPSEEK_EXPERT_SHAPES = [  # deepseek-v3 per-MoE-layer expert stacks, E x K x N
    ("gate_proj", 7168, 2048), ("up_proj", 7168, 2048), ("down_proj", 2048, 7168),
]
DEEPSEEK_EXPERTS = 256


def phase_fpmm_experts_deepseek(torch, dev):
    """Row 1b at one deepseek-v3 MoE layer's three 2-bit stacks (256
    experts, one f each, 940 MB of words a stack): C = 4 (decode, 4 slots)
    in bf16 (serve: a decode step's routing, ``routed``) and fp32 (parity),
    and the prefill capacities C = 2, 10, 20 (buckets 32, 256, 512:
    ceil(1.25*bucket*8/256)) in bf16, each bf16 case checking and timing
    its rule's kernel beside the streaming one, every case timed.  Returns
    the rows and the sums over the layer's 3 stacks at C = 4 and at C = 20."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(6)
    rows = []
    decode = dict.fromkeys(DECODE_SUMS, 0.0)
    prefill = {"ms": 0.0, "stream_ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0}
    bf16 = torch.bfloat16
    for name, K, N in DEEPSEEK_EXPERT_SHAPES:
        words, f, sc = _experts_stack(torch, gen, dev, DEEPSEEK_EXPERTS, K, N, 2)
        for C, dt in ((4, bf16), (4, torch.float32), (2, bf16), (10, bf16), (20, bf16)):
            row = _experts_case(torch, gen, dev, name, words, f, sc, C, dt, 2, N, timing=True,
                                routes=_bf16_routes(dt, C), plain=C in (4, 20),
                                routed=dt == bf16 and C == 4)
            row["arch"] = DEEPSEEK
            if dt == bf16 and C in (4, 20):
                acc = decode if C == 4 else prefill
                for k in acc:
                    acc[k] += row[k]
            emit(row)
            rows.append(row)
            if not row["pass"]:
                raise Failed(f"fixedpoint_matmul_experts deepseek {name} C={C} "
                             f"{row['dtype']}: err {_err(row)}")
        del words, f, sc
        torch.cuda.empty_cache()
    prefill["bound_by"] = _bound_by(r for r in rows if r["C"] == 20)
    return rows, decode, prefill


CROSSOVER_ROWS = (2, 3, 4, 5, 8, 16)


def _crossover(rows, fast: str, slow: str, up: bool = True):
    """Fewest rows from which ``fast``'s kernel is faster than ``slow``'s at
    every larger swept count (``up``), or most rows up to which it is faster
    at every smaller swept count (not ``up``); None: it never is."""
    best = None
    for r in sorted(rows, key=lambda r: r["rows"], reverse=up):
        if fast not in r or slow not in r:
            continue
        if r[fast] >= r[slow]:
            break
        best = r["rows"]
    return best


def phase_crossover(torch, dev):
    """Phase 3g: the three kernels at 2..16 rows in bf16, 2-bit, at
    internlm2's gate_proj (2048 x 8192, M rows) and olmoe's gate stack (64
    x 2048 x 1024, C rows per expert), each checked (bf16 bar,
    bit-identical) and timed (the decode kernel up to its 8 rows).  The
    route rule must not sit on the wrong side of a measured crossover: the
    decode kernel must beat both others at every swept count up to
    DECODE_MAX_ROWS, and the tensor cores must beat the streaming kernel
    at every swept count they take."""
    from repro_torch.kernels.fixedpoint_matmul import ops as fops

    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    bf16 = torch.bfloat16
    out = {"phase": "crossover", "tc_min_rows": fops.TC_MIN_ROWS,
           "decode_max_rows": fops.DECODE_MAX_ROWS}
    rows = []

    def sweep_entry(row, n):
        e = dict(rows=n, tc_ms=row["tc_ms"], stream_ms=row["stream_ms"])
        if "dec_ms" in row:
            e["dec_ms"] = row["dec_ms"]
            e["dec_best"] = row["dec_ms"] < min(row["tc_ms"], row["stream_ms"])
        return e

    def routes(n):
        return ("decode", "tensor_core") if n <= fops.DECODE_MAX_ROWS else ("tensor_core",)

    sweep = []
    for M in CROSSOVER_ROWS:
        row = _fpmm_case(torch, gen, dev, "gate_proj", 2048, 8192, M, bf16, 2, with_bias=False,
                         timing=True, routes=routes(M), plain=False, library=False)
        row["sweep"] = "crossover"
        emit(row)
        rows.append(row)
        sweep.append(sweep_entry(row, M))
    out["2d"] = {"shape": "internlm2 gate_proj 2048 x 8192", "cases": sweep}
    words, f, sc = _experts_stack(torch, gen, dev, N_EXPERTS, 2048, 1024, 2)
    sweep = []
    for C in CROSSOVER_ROWS:
        row = _experts_case(torch, gen, dev, "gate_proj", words, f, sc, C, bf16, 2, 1024,
                            timing=True, routes=routes(C), plain=False)
        row["sweep"] = "crossover"
        emit(row)
        rows.append(row)
        sweep.append(sweep_entry(row, C))
    del words
    torch.cuda.empty_cache()
    out["experts"] = {"shape": "olmoe gate_proj stack 64 x 2048 x 1024", "cases": sweep}
    ok = all(r["pass"] for r in rows)
    for k in ("2d", "experts"):
        cases = out[k]["cases"]
        out[k]["crossover_rows"] = _crossover(cases, "tc_ms", "stream_ms")
        # decode's last row count below both other kernels (swept upwards)
        dec_vs = [dict(c, best_other=min(c["tc_ms"], c["stream_ms"])) for c in cases
                  if "dec_ms" in c]
        out[k]["decode_crossover_rows"] = _crossover(dec_vs, "dec_ms", "best_other", up=False)
        tc_ok = all(c["tc_ms"] < c["stream_ms"] for c in cases
                    if c["rows"] >= fops.TC_MIN_ROWS)
        dec_ok = all(c["dec_best"] for c in cases if c["rows"] <= fops.DECODE_MAX_ROWS)
        out[k]["rule_ok"] = tc_ok and dec_ok
        ok = ok and tc_ok and dec_ok
    out["pass"] = ok
    emit(out)
    if not out["pass"]:
        raise Failed(f"route rule against the crossover: {out}")
    return rows, out


def phase_fpmm_head(torch, dev):
    """Row 1 at olmoe's packed untied head: M = 4 decode rows, fp32 x,
    K 2048 -> N 50304, 2-bit."""
    from repro_torch.core import optimal_f, unpack_int
    from repro_torch.kernels.fixedpoint_matmul import ops as fops
    from repro_torch.kernels.fixedpoint_matmul.ref import fixedpoint_matmul_ref

    gen = torch.Generator(device=dev)
    gen.manual_seed(4)
    M, K, N, n_bits = 4, 2048, 50304, 2
    w = torch.randn((K, N), generator=gen, device=dev) / math.sqrt(K)
    f = optimal_f(w, n_bits)[0].to(torch.int32)
    pw = fops.pack_weight(w, f, n_bits)
    del w
    x = torch.randn((M, K), generator=gen, device=dev)
    y = fops.fixedpoint_matmul(x, pw, f, n_bits=n_bits, n_out=N)
    ref = fixedpoint_matmul_ref(x, pw, f, n_bits=n_bits, n_out=N)
    torch.cuda.synchronize()
    err = (y - ref).abs().max().item()
    tol = TOL["float32"]
    ok = bool(torch.allclose(y, ref, **tol))
    io = x.numel() * 4 + pw.numel() + 4 + M * N * 4
    b_ms, b_by = bound(io, 2 * M * K * N, "float32")
    n = copies_for(pw.numel())
    args = [(x.clone(), pw.clone()) for _ in range(n)]
    wd = unpack_int(pw, n_bits, N).float() * torch.exp2(-f.float())
    largs = [(x, wd.clone()) for _ in range(copies_for(wd.numel() * 4))]
    row = {"phase": "kernel", "kernel": "fixedpoint_matmul", "proj": "olmoe lm_head", "M": M,
           "K": K, "N": N, "n_bits": n_bits, "dtype": "float32", "route": "streaming", "max_abs_err": err, "tol": tol,
           "pass": ok, "bound_ms": b_ms, "bound_by": b_by,
           "ms": timed(lambda a, b: fops.fixedpoint_matmul(a, b, f, n_bits=n_bits, n_out=N),
                       args, torch),
           "plain_ms": timed(lambda a, b: fixedpoint_matmul_ref(a, b, f, n_bits=n_bits, n_out=N),
                             args, torch),
           "library_ms": timed(lambda a, b: torch.matmul(a, b), largs, torch)}
    row["achieved_GBps"] = io / (row["ms"] * 1e-3) / 1e9
    emit(row)
    del args, largs, wd
    if not ok:
        raise Failed(f"fixedpoint_matmul at the olmoe head shape: err {err}")
    return row


# ---------------------------------------------------------------------------
# phase 3e: paged attention over SYMOG-quantized int8 / int4 pools
# ---------------------------------------------------------------------------
def _attn_quant_case(torch, gen, dev, *, B, K, G, hd, block, max_blocks, T, dt, bits, q_mult,
                     wide, pos_last=(280, 320)):
    """Quantized pools over ~300 cached tokens a row.  ``wide``: random
    mantissas under per-(block, head) exponents spread over [-8, 4];
    otherwise the pools a paged write makes of unit-scale k/v (values
    N(0,1)·2^s, s in [-3, 1] per (block, head), exponents from each block's
    first token)."""
    from repro_torch.models.attention import KV_QMAX, block_scale_exp, pack_int4, quantize_fixed

    n_phys = B * max_blocks + 1
    perm = torch.randperm(n_phys - 1, generator=gen, device=dev)[: B * max_blocks] + 1
    bt = perm.reshape(B, max_blocks).to(torch.int32)
    pos_last = torch.randint(*pos_last, (B,), generator=gen, device=dev)
    pos0 = (pos_last - (T - 1)).to(torch.int32)
    qmax = KV_QMAX[bits]
    pools, exps = [], []
    for _ in range(2):
        if wide:
            m = torch.randint(-qmax, qmax + 1, (n_phys, block, K, hd), generator=gen,
                              device=dev).to(torch.int8)
            e = torch.randint(-8, 5, (n_phys, K), generator=gen, device=dev).to(torch.int32)
        else:
            s = torch.randint(-3, 2, (n_phys, 1, K, 1), generator=gen, device=dev).float()
            x = torch.randn((n_phys, block, K, hd), generator=gen, device=dev) * torch.exp2(s)
            e = block_scale_exp(x[:, 0], qmax)
            m = quantize_fixed(x, e[:, None], qmax)
        pools.append(pack_int4(m) if bits == 4 else m)
        exps.append(e)
    q = (torch.randn((B, T, K, G, hd), generator=gen, device=dev) * q_mult).to(dt)
    return q, pools[0], pools[1], exps[0], exps[1], bt, pos0


# the tail-prefill launches of row 3 (gemma3's admission to an int4 pool:
# B 1, T = the tail bucket, K 4, G 2, hd 256): from position 0 under the
# local layers' window of 1,024 (it binds at T 2048) and the global layers'
# none, and a tail that starts mid-sequence.  Over 1,000-2,000 keys unit
# queries give outputs of a few 1e-2, which a dropped key tile or a window
# off by a block moves by less than the bf16 bar; so two more cases, built
# like 3b's windowed int8 case, scale q by 4 (logits of a few units, a
# softcap of 2 on one) under a window of 64 that binds on every row past
# the first 64, at T 2048 from 0 and from 1,000: on those the plain version
# with its window one block wider, or its causal horizon one key later,
# must fail the bar (``faults_caught``)
TAIL_PREFILL_CASES = [dict(T=32, pos0=0, window=1024), dict(T=512, pos0=0, window=1024),
                      dict(T=2048, pos0=0, window=1024), dict(T=2048, pos0=0, window=None),
                      dict(T=512, pos0=1000, window=1024),
                      dict(T=2048, pos0=0, window=64, q_mult=4.0),
                      dict(T=2048, pos0=1000, window=64, cap=2.0, q_mult=4.0),
                      # phase 11a's launches: chunks of 256 from a block boundary
                      # and from mid-block, and a prefix hit's tail after the
                      # shared 1,000 tokens
                      dict(T=256, pos0=1024, window=1024, of="chunk"),
                      dict(T=256, pos0=1000, window=1024, of="chunk"),
                      dict(T=32, pos0=1000, window=1024, of="prefix_hit")]


def phase_attn_quant(torch, dev):
    from repro_torch.kernels.paged_attention import ops as aops
    from repro_torch.kernels.paged_attention.ref import dequant_logical, paged_attention_ref

    gen = torch.Generator(device=dev)
    gen.manual_seed(6)
    base = dict(B=4, hd=128, block=16, max_blocks=32, pos_last=(280, 320))
    # olmoe decode (16 MHA heads, G = 1) and internlm2's GQA (8 KV heads, G = 2), int4 and
    # int8, bf16 queries (the serving dtype); one window-64 softcap-2 case on which, with the
    # plain version on the same inputs, a dropped softcap or a window off by one fails the
    # bf16 tolerance; one fp32 case on unit-scale pools at the fp32 tolerance.
    cases = [dict(K=16, G=1, bits=4, dt=torch.bfloat16, window=None, cap=0.0, wide=True),
             dict(K=16, G=1, bits=8, dt=torch.bfloat16, window=None, cap=0.0, wide=True),
             dict(K=8, G=2, bits=4, dt=torch.bfloat16, window=None, cap=0.0, wide=True),
             dict(K=8, G=2, bits=8, dt=torch.bfloat16, window=None, cap=0.0, wide=True),
             dict(K=16, G=1, bits=4, dt=torch.bfloat16, window=64, cap=2.0, wide=True),
             dict(K=16, G=1, bits=4, dt=torch.float32, window=None, cap=0.0, wide=False)]
    # the tail-prefill launches, on the pools a paged write makes of unit-scale k/v
    cases += [dict(K=4, G=2, bits=4, dt=torch.bfloat16, window=c["window"],
                   cap=c.get("cap", 0.0), q_mult=c.get("q_mult", 1.0), wide=False, T=c["T"],
                   tail_prefill=True, of=c.get("of", "admission"),
                   shape=dict(B=1, hd=256, max_blocks=max(128, -(-(c["pos0"] + c["T"]) // 16)),
                              pos_last=(c["pos0"] + c["T"] - 1, c["pos0"] + c["T"])))
              for c in TAIL_PREFILL_CASES]
    rows, worst, main = [], 0.0, None
    for c in cases:
        K, G, bits, dt, T = c["K"], c["G"], c["bits"], c["dt"], c.get("T", 1)
        shape = dict(base, **c.get("shape", {}))
        B, hd, block = shape["B"], shape["hd"], shape["block"]
        dname = str(dt).split(".")[-1]
        q, kp, vp, ke, ve, bt, pos0 = _attn_quant_case(
            torch, gen, dev, K=K, G=G, T=T, dt=dt, bits=bits, q_mult=c.get("q_mult", 1.0),
            wide=c["wide"], **shape)
        kw = dict(scale=hd**-0.5, cap=c["cap"], window=c["window"], kv_bits=bits)
        rule = aops._gqa_route(dt, aops._QUANT_CODE[bits], 1.0, hd, block, T * G)
        n0 = aops.prefill_quant_launches
        out = aops.paged_attention(q, kp, vp, bt, pos0, k_scale_exp=ke, v_scale_exp=ve, **kw)
        again = aops.paged_attention(q, kp, vp, bt, pos0, k_scale_exp=ke, v_scale_exp=ve, **kw)
        ref = paged_attention_ref(q, kp, vp, bt, pos0, k_scale_exp=ke, v_scale_exp=ve, **kw)
        torch.cuda.synchronize()
        on_route = aops.prefill_quant_launches - n0 == (2 if rule == "prefill" else 0)
        err = (out.float() - ref.float()).abs().max().item()
        tol = ATTN_TOL[dname]
        same = bool(torch.equal(out, again))
        ok = bool(torch.allclose(out.float(), ref.float(), **tol)) and same and on_route
        worst = max(worst, err)
        caught = None
        if c.get("tail_prefill") and c.get("q_mult", 1.0) != 1.0:
            # the bar's power: faults the case must see, as the plain version
            # makes them (each must fail the bar that the kernel passes)
            faults = {"window_plus_block": (pos0, dict(kw, window=c["window"] + block)),
                      "window_minus_block": (pos0, dict(kw, window=c["window"] - block)),
                      "horizon_plus_one": (pos0 + 1, kw)}
            caught = {}
            for fname, (p0, fkw) in faults.items():
                bad = paged_attention_ref(q, kp, vp, bt, p0, k_scale_exp=ke, v_scale_exp=ve,
                                          **fkw)
                caught[fname] = {"max_abs_diff": (bad.float() - out.float()).abs().max().item(),
                                 "fails_bar": not torch.allclose(out.float(), bad.float(), **tol)}
                del bad
            ok = ok and all(f["fails_bar"] for f in caught.values())
        del out, again, ref
        # bytes this run's data needs: the words and exponents of the blocks each row sees
        kv_bytes = 2 * _visible_blocks(pos0, T, c["window"], block) * \
            (block * K * kp.shape[-1] + 4 * K)
        io = 2 * q.numel() * q.element_size() + kv_bytes + bt.numel() * 4 + B * 4
        b_ms, b_by = bound(io, 4 * _visible_keys(pos0, T, c["window"]) * K * G * hd, dname)
        n = copies_for((kp.numel() + ke.numel() * 4) * 2)
        args = [(q, kp.clone(), vp.clone(), ke.clone(), ve.clone()) for _ in range(n)]
        row = {"phase": "kernel", "kernel": "paged_attention_quant", "B": B, "K": K, "G": G,
               "hd": hd, "block": block, "T": T, "pos0": int(pos0.min()) if B == 1 else None,
               "kv_bits": bits, "q_dtype": dname, "window": c["window"], "cap": c["cap"],
               "tail_prefill": c.get("tail_prefill", False), "of": c.get("of"),
               "wide_exponents": c["wide"],
               "exp_range": [int(min(ke.min(), ve.min())), int(max(ke.max(), ve.max()))],
               "q_mult": c.get("q_mult", 1.0), "faults_caught": caught,
               "max_abs_err": err, "tol": tol, "bit_identical": same, "route": rule,
               "launched_on_route": on_route, "pass": ok}
        row["ms"] = timed(lambda a, b, cc, d, e: aops.paged_attention(
            a, b, cc, bt, pos0, k_scale_exp=d, v_scale_exp=e, **kw), args, torch)
        if rule == "prefill":  # the decode kernel on the same inputs, for the record
            row["decode_route_ms"] = timed(lambda a, b, cc, d, e: aops.paged_attention(
                a, b, cc, bt, pos0, k_scale_exp=d, v_scale_exp=e, _route="decode", **kw),
                args, torch)
        row["plain_ms"] = timed(lambda a, b, cc, d, e: paged_attention_ref(
            a, b, cc, bt, pos0, k_scale_exp=d, v_scale_exp=e, **kw), args, torch)
        # library yardstick: SDPA over the gathered, dequantized cache; timed only
        row["library_ms"] = None if c["cap"] else _sdpa_ms(
            torch, q, dequant_logical(kp, ke, bt, kv_bits=bits).to(dt),
            dequant_logical(vp, ve, bt, kv_bits=bits).to(dt), pos0, c["window"])
        row["bound_ms"], row["bound_by"] = b_ms, b_by
        row["bytes_bound_ms"] = io / HBM_BYTES_PER_S * 1e3
        row["achieved_GBps"] = io / (row["ms"] * 1e-3) / 1e9
        row["achieved_TFLOPs"] = 4 * _visible_keys(pos0, T, c["window"]) * K * G * hd / \
            (row["ms"] * 1e-3) / 1e12
        del args
        emit(row)
        rows.append(row)
        if main is None:
            main = row
        if not ok:
            raise Failed(f"paged_attention_quant case {c}: err {err}, bit-identical {same}, "
                         f"route {rule} launched {on_route}")
    main["length_sweep"] = _attn_length_sweep(torch, dev, gen, quant=True)
    # the prefill route over bf16 pools: gemma3's admission, internlm2's, the verify
    for c in PREFILL_BF16_CASES:
        row = _attn_dense_case(torch, gen, dev, c["shape"],
                               dict(c, dt=torch.bfloat16, int8=False, q_mult=1.0))
        rows.append(row)
        worst = max(worst, row["max_abs_err"])
    return rows, worst, main


# the prefill route over bf16 pools (bf16 queries): gemma3's admission at T
# 2048 under its window of 1,024 (B 1, K 4, G 2, hd 256), internlm2's at T
# 512 (K 8, G 2, hd 128), and the speculative verify (B 4, T = k + 1, ~300
# cached tokens a row, the last row's queries past its table)
PREFILL_BF16_CASES = [
    dict(arch="gemma3-4b", T=2048, window=1024, cap=0.0, scale=256**-0.5, of="admission",
         shape=dict(B=1, K=4, G=2, hd=256, block=16, max_blocks=128, pos_last=(2047, 2048))),
    dict(arch="internlm2-1.8b", T=512, window=None, cap=0.0, scale=128**-0.5, of="admission",
         shape=dict(B=1, K=8, G=2, hd=128, block=16, max_blocks=32, pos_last=(511, 512))),
    dict(arch="internlm2-1.8b", T=VERIFY_T, window=None, cap=0.0, scale=128**-0.5,
         verify=True, of="verify",
         shape=dict(B=4, K=8, G=2, hd=128, block=16, max_blocks=32, pos_last=(280, 320)))]


# the crossover of the two GQA kernels over T·G (bf16 queries): gemma3's
# shape (B 1, K 4, G 2, hd 256, int4 pool, window 1,024) and internlm2's (B
# 4, K 8, G 2, hd 128, bf16 pool), ~1,000 / ~300 cached tokens a row
CROSSOVER_TG = (8, 10, 16, 32, 64, 128, 512)


def phase_prefill_crossover(torch, dev):
    """Both GQA routes timed at each T·G of CROSSOVER_TG (the prefill kernel
    forced below the rule's threshold too), each held to the plain version
    at the bf16 bar: where the prefill kernel starts to win is where the
    rule's PREFILL_MIN_ROWS comes from.  Emits one row."""
    from repro_torch.kernels.paged_attention import ops as aops
    from repro_torch.kernels.paged_attention.ref import paged_attention_ref

    gen = torch.Generator(device=dev)
    gen.manual_seed(8)
    shapes = {"gemma3-4b": dict(B=1, K=4, G=2, hd=256, block=16, max_blocks=128, bits=4,
                                window=1024, pos_last=(1000, 1032)),
              "internlm2-1.8b": dict(B=4, K=8, G=2, hd=128, block=16, max_blocks=32, bits=0,
                                     window=None, pos_last=(280, 320))}
    out = {"phase": "prefill_crossover", "rule_min_rows": aops.PREFILL_MIN_ROWS, "shapes": {},
           "tol": ATTN_TOL["bfloat16"]}
    ok = True
    floor = aops.PREFILL_MIN_ROWS
    aops.PREFILL_MIN_ROWS = 1  # the prefill kernel forced below the threshold
    try:
        for name, sh in shapes.items():
            pts = []
            for TG in CROSSOVER_TG:
                T = TG // sh["G"]
                common = dict(B=sh["B"], K=sh["K"], G=sh["G"], hd=sh["hd"], block=sh["block"],
                              max_blocks=sh["max_blocks"], T=T, dt=torch.bfloat16, q_mult=1.0,
                              pos_last=sh["pos_last"])
                if sh["bits"]:
                    q, kp, vp, ke, ve, bt, pos0 = _attn_quant_case(torch, gen, dev, bits=4,
                                                                   wide=False, **common)
                    kw = dict(k_scale_exp=ke, v_scale_exp=ve, kv_bits=4)
                else:
                    q, kp, vp, bt, pos0 = _attn_case(torch, gen, dev, int8=False, **common)
                    kw = {}
                kw.update(scale=sh["hd"]**-0.5, window=sh["window"])
                ref = paged_attention_ref(q, kp, vp, bt, pos0, **kw).float()
                pt = {"TG": TG, "T": T}
                for route in aops.GQA_ROUTES:
                    got = aops.paged_attention(q, kp, vp, bt, pos0, _route=route, **kw).float()
                    good = bool(torch.allclose(got, ref, **ATTN_TOL["bfloat16"]))
                    ok = ok and good
                    pt[route + "_ms"] = timed(lambda: aops.paged_attention(
                        q, kp, vp, bt, pos0, _route=route, **kw), [()], torch)
                    pt[route + "_max_abs_err"] = (got - ref).abs().max().item()
                pts.append(pt)
            wins = [p["TG"] for p in pts if p["prefill_ms"] <= p["decode_ms"]]
            # the least T·G from which the prefill kernel wins at every larger point
            cross = next((p["TG"] for i, p in enumerate(pts)
                          if all(q["prefill_ms"] <= q["decode_ms"] for q in pts[i:])), None)
            out["shapes"][name] = {"points": pts, "prefill_wins_at": wins, "crossover_TG": cross}
    finally:
        aops.PREFILL_MIN_ROWS = floor
    crosses = [v["crossover_TG"] for v in out["shapes"].values()]
    out["crossover_TG"] = None if None in crosses else max(crosses)
    # where the rule sits against this run's crossover (timed, so printed: not a gate)
    out["rule_at_or_past_crossover"] = (out["crossover_TG"] is not None
                                        and floor >= out["crossover_TG"])
    out["pass"] = ok
    emit(out)
    if not ok:
        raise Failed("prefill crossover: a route missed the bf16 bar")
    return out


PREFILL_MODEL_LENS = (300, 1100, 1800)  # gemma3's window of 1,024 binds on the last two


def phase_prefill_route_model(torch, dev, layers: int = 6):
    """gemma3-4b at ``layers`` layers (its global layer among them), full
    width, bf16 compute, a bf16 pool: each prompt's tail-prefill admission
    (start 0, T = its bucket) with the rule's route (``gqa_prefill`` in
    every layer) against the same admission with the decode route forced
    (the rule replaced), and an fp32-compute admission (fp32 queries:
    ``gqa_decode``).  Bar: the two bf16 routes' last-position logits differ
    by no more than twice the bf16 decode route's own distance from fp32
    (the kernels round differently inside bf16 compute; a wrong key, mask or
    scale moves the logits far past bf16's noise); argmax agreement is
    reported."""
    from repro_torch import configs
    from repro_torch.core import SymogConfig, pack_tree, symog_init
    from repro_torch.kernels.paged_attention import ops as aops
    from repro_torch.models import init_lm, prefill_prefix_lm
    from repro_torch.serve import ServeConfig, ServeEngine
    from repro_torch.serve.scheduler import Scheduler

    cfg = dataclasses.replace(configs.get_config("gemma3-4b"), n_layers=layers,
                              kv_cache_dtype="bf16")
    params = init_lm(13, cfg, device=dev)
    scfg = SymogConfig(n_bits=2)
    packed = pack_tree(params, symog_init(params, scfg), scfg)
    del params
    max_len, block = 2048, 16
    gen = torch.Generator(device="cpu")
    gen.manual_seed(5)
    prompts = [torch.randint(0, cfg.vocab_size, (L,), generator=gen) for L in PREFILL_MODEL_LENS]
    bt = torch.arange(1, max_len // block + 1, dtype=torch.int32, device=dev)

    def admit(compute_dtype):
        eng = ServeEngine(cfg, packed, max_len=max_len, compute_dtype=compute_dtype, device=dev)
        out = []
        zero_counts()
        for pr in prompts:
            caches = Scheduler(eng, ServeConfig(n_slots=1, block_size=block)).caches
            L = int(pr.shape[0])
            tokens = torch.zeros((1, 1 << (L - 1).bit_length()), dtype=torch.int32, device=dev)
            tokens[0, :L] = pr.to(dev)
            lg, _ = eng._with_backend(prefill_prefix_lm, eng.params, {"tokens": tokens}, caches,
                                      bt, 0, cfg, seq_len=L, compute_dtype=compute_dtype)
            out.append(lg[0, -1].float())
            del caches
        torch.cuda.synchronize()
        counts = read_counts()
        del eng
        return torch.stack(out), {k: counts[k]
                                  for k in ("paged_attention", "paged_attention_prefill")}

    rule, rule_counts = admit(torch.bfloat16)
    inner = aops._gqa_route
    aops._gqa_route = lambda *a, **k: "decode"
    try:
        dec, dec_counts = admit(torch.bfloat16)
    finally:
        aops._gqa_route = inner
    f32, _ = admit(torch.float32)
    diff = (rule - dec).abs().max().item()
    own = (dec - f32).abs().max().item()
    n = layers * len(prompts)
    row = {"phase": "prefill_route_model", "arch": cfg.name, "layers": layers,
           "compute": "bfloat16", "kv_cache_dtype": "bf16", "prompt_lens": list(PREFILL_MODEL_LENS),
           "rule_launches": rule_counts, "decode_forced_launches": dec_counts,
           "max_abs_logit_diff_routes": diff, "bf16_own_max_abs_diff_from_fp32": own,
           "bar": 2 * own, "logit_scale": dec.abs().max().item(),
           "argmax_agreement_routes": (rule.argmax(-1) == dec.argmax(-1)).float().mean().item(),
           "argmax_agreement_rule_vs_fp32": (rule.argmax(-1) == f32.argmax(-1)).float().mean()
           .item(),
           "finite": bool(torch.isfinite(rule).all() and torch.isfinite(dec).all())}
    row["pass"] = (row["finite"] and diff <= 2 * own
                   and rule_counts == {"paged_attention": n, "paged_attention_prefill": n}
                   and dec_counts == {"paged_attention": n, "paged_attention_prefill": 0})
    del packed
    torch.cuda.empty_cache()
    emit(row)
    if not row["pass"]:
        raise Failed(f"prefill route model check: {row}")
    return row


# ---------------------------------------------------------------------------
# phase 3c: symog_update
# ---------------------------------------------------------------------------
SYMOG_TOL = dict(rtol=1e-6, atol=1e-7)  # tests/test_kernels.py:22-23
SYMOG_FLOPS = 16  # per element: div, rint, 4 min/max, 5 mul, 5 add/sub


def symog_leaf_shapes(cfg):
    """Every quantizable leaf of internlm2-1.8b: the tied embedding and the
    7 projections, each stacked over the layer axis (one f per leaf)."""
    L, D, H, K, hd, F = (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                         cfg.d_ff)
    return [("embed", (cfg.vocab_size, D)), ("q_proj", (L, D, H, hd)),
            ("k_proj", (L, D, K, hd)), ("v_proj", (L, D, K, hd)), ("o_proj", (L, H, hd, D)),
            ("gate_proj", (L, D, F)), ("up_proj", (L, D, F)), ("down_proj", (L, F, D))]


def events_ms(fn, reps: int, torch) -> float:
    """ms per call of ``fn`` (work of 100s of MB per call: cold operands, no
    graph needed), CUDA events around ``reps`` calls after one warm-up."""
    fn()
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / reps


def _symog_operands(torch, gen, dev, shape, n_bits, case):
    """(w, g, v, kw): weights at init scale with their own Δ, gradients and
    momentum of training scale, λ_eff = λ_end·2/M_l; or a case cut to fail on
    a wrong kernel: 'ties' (half of w exactly on (k+½)Δ, g = v = 0,
    λ_eff = 1, so a wrong rounding moves v' by Δ), 'clip' (a third of |w|
    far above Δ·qmax), 'misaligned' (4 bytes off 16: the scalar path)."""
    from repro_torch.core import optimal_f

    n = math.prod(shape)
    fan_in = shape[-2] if len(shape) >= 2 else 1
    w = torch.randn(shape, generator=gen, device=dev) / math.sqrt(fan_in)
    f, delta = optimal_f(w, n_bits)
    delta = delta.to(dev, torch.float32)
    d, q = float(delta), 2 ** (n_bits - 1) - 1
    g = torch.randn(shape, generator=gen, device=dev) * 1e-4
    v = torch.randn(shape, generator=gen, device=dev) * 1e-4
    kw = dict(delta=delta, lam_eff=10.0 * math.exp(9.0) * 2.0 / n, lr=0.01, mu=0.9,
              n_bits=n_bits)
    flat = w.view(-1)
    if case == "ties":
        k = torch.randint(-q - 1, q + 1, (n // 2,), generator=gen, device=dev)
        flat[: n // 2] = (k.float() + 0.5) * d
        g.zero_()
        v.zero_()
        kw.update(lam_eff=1.0, lr=1e-3)
    elif case == "clip":
        sign = torch.randint(0, 2, (n // 3,), generator=gen, device=dev).float() * 2 - 1
        flat[: n // 3] = sign * (q + 3) * d
    elif case == "misaligned":
        w, g, v = (torch.cat([torch.zeros(1, device=dev), t.reshape(-1)])[1:] for t in (w, g, v))
    return w, g, v, kw


def phase_symog(torch, dev, cfg):
    from repro_torch.kernels.symog_update import ops as sops
    from repro_torch.kernels.symog_update.ref import symog_update_ref

    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    cases = [(name, shape, 2, "random") for name, shape in symog_leaf_shapes(cfg)]
    cases += [("gate_proj", symog_leaf_shapes(cfg)[5][1], 4, "random"),
              ("odd_n", (1_000_003,), 2, "random"), ("ties", (1 << 24,), 2, "ties"),
              ("ties_4bit", (1_000_003,), 4, "ties"), ("clip", (1 << 24,), 2, "clip"),
              ("misaligned", (1_000_003,), 2, "misaligned")]
    rows, worst = [], 0.0
    full = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "elements": 0}
    for name, shape, n_bits, case in cases:
        w, g, v, kw = _symog_operands(torch, gen, dev, shape, n_bits, case)
        w_ref, v_ref = symog_update_ref(w, g, v, **kw)
        sops.symog_update(w, g, v, **kw)
        torch.cuda.synchronize()
        err = max((w - w_ref).abs().max().item(), (v - v_ref).abs().max().item())
        ok = bool(torch.allclose(w, w_ref, **SYMOG_TOL) and torch.allclose(v, v_ref, **SYMOG_TOL))
        worst = max(worst, err)
        del w_ref, v_ref
        n = w.numel()
        b_ms, b_by = bound(20 * n, SYMOG_FLOPS * n, "float32")
        row = {"phase": "kernel", "kernel": "symog_update", "leaf": name, "shape": list(shape),
               "n": n, "n_bits": n_bits, "case": case, "max_abs_err": err, "tol": SYMOG_TOL,
               "pass": ok, "bound_ms": b_ms, "bound_by": b_by}
        if case == "random" and n_bits == 2 and name != "odd_n":  # one full update
            row["ms"] = events_ms(lambda: sops.symog_update(w, g, v, **kw), 5, torch)
            row["plain_ms"] = events_ms(lambda: symog_update_ref(w, g, v, **kw), 3, torch)
            row["achieved_GBps"] = 20 * n / (row["ms"] * 1e-3) / 1e9
            for k in ("ms", "plain_ms", "bound_ms"):
                full[k] += row[k]
            full["elements"] += n
        emit(row)
        rows.append(row)
        del w, g, v
        if not ok:
            raise Failed(f"symog_update {name} {shape} bits={n_bits} {case}: err {err}")
    torch.cuda.empty_cache()
    grouped = [_grouped_case(torch, dev, name, shape, lead)
               for name, shape, lead in SYMOG_GROUPED_CASES]
    rows += grouped
    worst = max([worst] + [r["max_abs_err"] for r in grouped])
    return rows, worst, full


# a Δ per leading group: (name, shape, leading dims that carry f)
SYMOG_GROUPED_CASES = [
    ("olmoe_experts_6_layers", (6, 64, 2048, 1024), 2),  # a stacked (L, E, D, F) leaf
    ("deepseek_mtp_experts", (256, 7168, 2048), 1),  # the MTP block's unstacked (E, D, F)
    ("ragged", (3, 5, 7, 9), 2),  # groups of 63: the scalar path
]
SYMOG_CHUNK = 1 << 28  # elements of one chunk of the plain version's check


def _grouped_operands(torch, dev, shape, lead: int, seed: int):
    """(w, g, v) as (G, group) fp32 on the card, Δ (G,), and ``fill(rows)``,
    which redraws the three operands' rows ``rows`` from per-chunk seeds:
    a chunk of the inputs can be made again after the kernel overwrote w
    and v, so the plain version is checked chunk by chunk in little memory
    (the deepseek case's operands are 45 GB)."""
    G = math.prod(shape[:lead])
    group = math.prod(shape[lead:])
    f = 2 + torch.arange(G, device=dev) % 4  # Δ 2^-2 .. 2^-5
    delta = torch.exp2(-f.to(torch.float32)).reshape(shape[:lead])
    step = max(1, SYMOG_CHUNK // group)
    chunks = [(r, min(G, r + step)) for r in range(0, G, step)]
    gen = torch.Generator(device=dev)

    def draw(c):
        r0, r1 = chunks[c]
        gen.manual_seed(seed * 100_003 + c)
        d = delta.reshape(G, 1)[r0:r1]
        w = torch.empty((r1 - r0, group), device=dev).normal_(generator=gen).mul_(1.3 * d)
        g = torch.empty_like(w).normal_(generator=gen).mul_(1e-4)
        v = torch.empty_like(w).normal_(generator=gen).mul_(1e-4)
        return w, g, v

    w, g, v = (torch.empty((G, group), device=dev) for _ in range(3))

    def fill():
        for c, (r0, r1) in enumerate(chunks):
            for dst, src in zip((w, g, v), draw(c)):
                dst[r0:r1] = src

    fill()
    return w, g, v, delta, chunks, draw, fill


def _grouped_case(torch, dev, name, shape, lead, n_bits=2):
    """One grouped-Δ case: the kernel twice from the same inputs, each time
    held bit for bit to the plain version chunk by chunk; timed (5 calls)
    against its bound (20 B an element + the Δ gather)."""
    from repro_torch.kernels.symog_update import ops as sops
    from repro_torch.kernels.symog_update.ref import symog_update_ref

    w, g, v, delta, chunks, draw, fill = _grouped_operands(torch, dev, shape, lead, seed=7)
    n, G = w.numel(), delta.numel()
    kw = dict(lam_eff=10.0 * math.exp(9.0) * 2.0 / n, lr=0.01, mu=0.9, n_bits=n_bits)
    equal, plain_ms, worst = [], 0.0, 0.0
    for call in range(2):
        if call:
            fill()
        sops.symog_update(w.view(shape), g.view(shape), v.view(shape), delta=delta, **kw)
        torch.cuda.synchronize()
        for c, (r0, r1) in enumerate(chunks):
            w0, g0, v0 = draw(c)
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            rw, rv = symog_update_ref(w0, g0, v0, delta=delta.reshape(-1)[r0:r1].contiguous(),
                                      **kw)
            t1.record()
            t1.synchronize()
            if call == 0:
                plain_ms += t0.elapsed_time(t1)
            equal.append(bool(torch.equal(w[r0:r1], rw) and torch.equal(v[r0:r1], rv)))
            worst = max(worst, (w[r0:r1] - rw).abs().max().item(),
                        (v[r0:r1] - rv).abs().max().item())
            del w0, g0, v0, rw, rv
    ms = events_ms(lambda: sops.symog_update(w.view(shape), g.view(shape), v.view(shape),
                                              delta=delta, **kw), 5, torch)
    b_ms, b_by = bound(20 * n + 4 * G, SYMOG_FLOPS * n, "float32")
    group = n // G
    row = {"phase": "kernel", "kernel": "symog_update", "leaf": name, "shape": list(shape),
           "f_shape": list(delta.shape), "group": group,
           "path": "vector" if group % 4 == 0 else "scalar", "n": n, "n_bits": n_bits,
           "case": "grouped_delta", "chunks": len(chunks), "max_abs_err": worst,
           "bit_identical_both_calls": all(equal), "pass": all(equal), "ms": ms,
           "plain_ms": plain_ms, "plain_note": f"the plain version over {len(chunks)} "
                                                f"chunk(s) of whole groups, summed",
           "bound_ms": b_ms, "bound_by": b_by, "achieved_GBps": 20 * n / (ms * 1e-3) / 1e9}
    emit(row)
    del w, g, v
    torch.cuda.empty_cache()
    if not row["pass"]:
        raise Failed(f"symog_update grouped {name} {shape}: not bit-identical to its plain "
                     f"version (max err {worst})")
    return row


# ---------------------------------------------------------------------------
# phase 4: full-width parity, kernels vs plain paths
# ---------------------------------------------------------------------------
# amaxes at which the port's SYMOG exponent once differed from the JAX
# package's jitted one (tests/test_torch_kv_exponent.py), by qmax
KV_EXP_AMAXES = {127: [63.5, 127.0, 254.0, 508.0, 65024.0, 130048.0], 7: [3.5]}


def _kv_exponent_card_vs_cpu(torch, dev):
    """The exponents and words a quantized pool's writes make on the card
    against the CPU's (which tests/test_torch_kv_exponent.py holds to jitted
    JAX), array_equal: at the amaxes above, qmax·2^k for k in -12..12, every
    step point of the exponent, and the fp32 neighbours of each; and the
    arithmetic behind the step points (``jitted_exponent``) on those amaxes."""
    from repro_torch.models.attention import block_scale_exp, quantize_fixed
    from repro_torch.models.kv_exponent import exponent_thresholds, jitted_exponent

    out = {}
    for qmax in (127, 7):
        vals = torch.tensor(KV_EXP_AMAXES[qmax] + [qmax * 2.0**k for k in range(-12, 13)])
        vals = torch.cat([vals, exponent_thresholds(qmax)])
        a = torch.cat([vals, torch.nextafter(vals, torch.zeros(())),
                       torch.nextafter(vals, vals * 2)])
        x = a[:, None] * torch.tensor([1.0, -0.5, 0.25])  # entries whose amax is a
        e_cpu, e_dev = block_scale_exp(x, qmax), block_scale_exp(x.to(dev), qmax).cpu()
        w_cpu = quantize_fixed(x, e_cpu, qmax)
        w_dev = quantize_fixed(x.to(dev), e_dev.to(dev), qmax).cpu()
        j_cpu, j_dev = jitted_exponent(a, qmax), jitted_exponent(a.to(dev), qmax).cpu()
        out[qmax] = {"amaxes": int(a.numel()), "exponents_equal": torch.equal(e_dev, e_cpu),
                     "words_equal": torch.equal(w_dev, w_cpu),
                     "arithmetic_equal": torch.equal(j_dev, j_cpu),
                     "arithmetic_equals_steps": torch.equal(j_cpu, e_cpu)}
    return out


def _past_trash(t, group: str, groups, tail: bool):
    """A pool leaf without its trash block (physical row 0) when ``tail``."""
    if not tail:
        return t
    stacked = next(g for g in groups if g.name == group).stacked
    return t[:, 1:] if stacked else t[1:]


def _record_paged_writes(torch, log, forced=None):
    """Wrap the model's paged write (``attention._paged_write``, the one
    every admission and decode step of a paged pool makes): append each
    call's (names, k/v entries written, flat indices, the route's own
    entries) to ``log``.  With ``forced`` (the kernel route's log) each
    call writes that route's entries at the same indices in place of its
    own, so the plain route attends the kernel route's very pool words.
    Returns the function that restores the model's write."""
    from repro_torch.models import attention as attn_mod

    inner = attn_mod._paged_write

    def write(cache, names, news, idx):
        own = list(news)
        if forced is not None:
            i = len(log)
            if i >= len(forced) or forced[i][0] != names or not torch.equal(forced[i][2], idx):
                raise Failed(f"paged write {i} {names}: not the kernel route's write")
            news = forced[i][1]
        log.append((names, [n.detach().clone() for n in news], idx.clone(), own))
        return inner(cache, names, news, idx)

    write.inner = inner
    attn_mod._paged_write = write
    return lambda: setattr(attn_mod, "_paged_write", inner)


def _tail_admission(torch, eng, caches, host, prompt, bt_row, groups, log):
    """One request's tail-prefill admission (start 0) through the engine's
    backends, under ``_record_paged_writes``: the paged writes it made
    (each layer's k/v entries and flat indices, in layer order) are made
    again on the CPU into ``host``.  Returns the last real position's
    logits."""
    from repro_torch.models import attention as attn_mod
    from repro_torch.models import prefill_prefix_lm

    L = int(prompt.shape[0])
    bucket = 1 << (L - 1).bit_length()
    tokens = torch.zeros((1, bucket), dtype=torch.int32, device=eng.device)
    tokens[0, :L] = prompt.to(eng.device)
    n0 = len(log)
    lg, _ = eng._with_backend(prefill_prefix_lm, eng.params, {"tokens": tokens}, caches,
                              bt_row, 0, eng.cfg, seq_len=L, compute_dtype=torch.float32)
    writes = log[n0:]
    layer_views = []
    for g in groups:
        hp = host[g.name]
        layer_views += ([{n: t[i] for n, t in hp.items()} for i in range(g.count)]
                        if g.stacked else [hp])
    if len(writes) != len(layer_views):
        raise Failed(f"tail prefill made {len(writes)} paged writes for {len(layer_views)} layers")
    real_write = attn_mod._paged_write.inner
    for view, (names, news, idx, _) in zip(layer_views, writes):
        real_write(view, names, [n.cpu() for n in news], idx.cpu())
    return lg[0, -1]


def phase_parity(torch, dev, layers: int, arch: str = "internlm2-1.8b",
                 kv_cache_dtype: str = "bf16", build=None, plain_packed: str = "unpack",
                 tail=None):
    """Logits through the kernels against the plain paths.  With a quantized
    ``kv_cache_dtype`` the pools hold int8 / int4 words and one exponent per
    (block, KV head) (per block for MLA's c_kv / k_rope): admission
    quantizes through ``_scatter_blocks_quant``, each decode step writes
    through ``paged_quant_update``, and the fused route reads with the
    quantized kernel, the composed one with ``_paged_read``.  Both routes
    then run the packed matmuls through the kernels (held to the plain
    version by the float-pool run): rounding a decode token's k/v to the
    pool's grid is discontinuous, so the ~1e-6 between the matmul routes
    flips int4 words and moves logits well past ``PARITY_ATOL``: the two
    routes must write the same words for their logits to be comparable.
    ``plain_packed="kernel"`` keeps the matmul kernels on the plain route
    of a float pool too (deepseek-v3: unpacking a 256-expert stack to fp32
    takes 15 GB).  ``build(cfg)`` returns the packed artifact (default:
    ``init_lm`` + ``symog_init`` + ``pack_tree`` of the whole tree).

    The admission is the scheduler's: the tail prefill for a quantized
    pool of an all-attention decoder (``tail=True`` forces it on a float
    pool too), each layer's writes held array_equal to the same writes made
    on the CPU.  A tail prefill attends the pool inside the admission, so
    on a quantized pool the two routes' ~1e-6 apart k/v of every layer
    past the first would round to different words there.  So on that run
    the plain route writes the kernel route's k/v entries in place of its
    own (``_record_paged_writes``): both attend the same words, the logits
    are held to ``PARITY_ATOL``, and the entries each route computed for
    itself to the same bar."""
    from repro_torch import configs
    from repro_torch.core import SymogConfig, pack_tree, symog_init
    from repro_torch.kernels import dispatch
    from repro_torch.models import decode_lm, init_lm, prefill_lm
    from repro_torch.models.lm import PAGED_CACHE_LEAVES, scan_groups
    from repro_torch.serve import ServeConfig, ServeEngine
    from repro_torch.serve.engine import _scatter_blocks, _scatter_blocks_quant
    from repro_torch.serve.scheduler import Scheduler

    cfg = dataclasses.replace(configs.get_config(arch), n_layers=layers,
                              kv_cache_dtype=kv_cache_dtype)
    if build is None:
        params = init_lm(11, cfg, device=dev)
        scfg = SymogConfig(n_bits=2)
        packed = pack_tree(params, symog_init(params, scfg), scfg)
        del params
    else:
        packed = build(cfg)
    max_len, block, steps = 128, 16, 4
    gen = torch.Generator(device="cpu")
    gen.manual_seed(3)
    lens = [37, 70]
    prompts = [torch.randint(0, cfg.vocab_size, (L,), generator=gen) for L in lens]
    forced = torch.randint(0, cfg.vocab_size, (steps, len(lens)), generator=gen)
    # the attention kernels of this family: float pools, quantized pools
    names = (MLA_COUNTS if cfg.use_mla else ("paged_attention", "paged_attention_quant"))
    logits, attn_launches, admission_equal, final, mm_launches = {}, {}, {}, {}, {}
    plain_pb = plain_packed if kv_cache_dtype == "bf16" else "kernel"
    quant = kv_cache_dtype != "bf16"
    logs = {}  # the paged writes of each route of a tail-prefill run
    for path, (pb, ab) in {"kernels": ("kernel", "fused"), "plain": (plain_pb, "composed")}.items():
        dispatch.set_packed_backend(pb)
        dispatch.set_attention_backend(ab)
        eng = ServeEngine(cfg, packed, max_len=max_len, compute_dtype=torch.float32, device=dev)
        dispatch.set_packed_backend("auto")
        dispatch.set_attention_backend("auto")
        nb = max_len // block
        # the scheduler's pool layout for two slots: (n_phys, block, ...) per
        # paged leaf (a leading layer axis per stacked group), exponent leaves
        # for a quantized pool; and its admission route (the tail prefill
        # for a quantized pool of an all-attention decoder)
        sched = Scheduler(eng, ServeConfig(n_slots=len(lens), block_size=block))
        caches = sched.caches
        tail = sched._quant_admit if tail is None else tail
        del sched
        groups = scan_groups(cfg)
        bt = (torch.arange(len(lens) * nb, device=dev, dtype=torch.int32) + 1).reshape(len(lens), nb)
        # the admission on the card (quantizing, for a quantized pool), held
        # array_equal to the same writes made on the CPU from the same caches
        host = {g.name: {n: t.new_zeros(t.shape, device="cpu")
                         for n, t in caches[g.name]["sub0"].items()} for g in groups}
        zero_counts()
        outs = []
        # a tail-prefill run records its paged writes; on a quantized pool
        # the plain route writes the kernel route's entries (see above)
        log = logs.setdefault(path, [])
        restore = _record_paged_writes(
            torch, log, logs["kernels"] if quant and path == "plain" else None) if tail \
            else (lambda: None)
        try:
            for b, pr in enumerate(prompts):
                if tail:
                    outs.append(_tail_admission(torch, eng, caches, host, pr, bt[b], groups, log))
                    continue
                lg, one = eng._with_backend(prefill_lm, eng.params,
                                            {"tokens": pr[None].to(dev)}, cfg,
                                            max_len=max_len, compute_dtype=torch.float32)
                outs.append(lg[0, -1])
                for g in groups:
                    axis = 1 if g.stacked else 0
                    pool, hp = caches[g.name]["sub0"], host[g.name]
                    for n, src in one[g.name]["sub0"].items():
                        if n not in PAGED_CACHE_LEAVES:
                            continue
                        if n + "_scale" in pool:
                            _scatter_blocks_quant(pool[n], pool[n + "_scale"], src, bt[b], axis, nb)
                            _scatter_blocks_quant(hp[n], hp[n + "_scale"], src.cpu(), bt[b].cpu(),
                                                  axis, nb)
                        else:
                            _scatter_blocks(pool[n], src, bt[b], axis, nb)
                            _scatter_blocks(hp[n], src.cpu(), bt[b].cpu(), axis, nb)
            # (a tail prefill's pad rows all write into the trash block, physical
            # row 0, in an order the card does not define: it is left out)
            admission_equal[path] = all(
                torch.equal(_past_trash(t.cpu(), g, groups, tail),
                            _past_trash(host[g][n], g, groups, tail))
                for g in host for n, t in caches[g]["sub0"].items())
            pos = torch.tensor(lens, dtype=torch.int32, device=dev)
            active = torch.ones(len(lens), dtype=torch.bool, device=dev)
            for s in range(steps):
                lg, caches = eng._with_backend(decode_lm, eng.params, caches,
                                               forced[s].to(dev)[:, None].to(torch.int32), pos, cfg,
                                               compute_dtype=torch.float32, active=active,
                                               block_tables=bt)
                outs.extend(lg[:, 0])
                pos = pos + 1
        finally:
            restore()
        logits[path] = torch.stack(outs)
        final[path] = caches
        counts = read_counts()
        attn_launches[path] = {n: counts[n] for n in names}
        mm_launches[path] = {n: c for n, c in counts.items() if n.startswith("fixedpoint")}
        del eng, caches
    torch.cuda.synchronize()
    words_differing = {f"{g}/{n}": int((_past_trash(t, g, groups, tail) != _past_trash(
        final["plain"][g]["sub0"][n], g, groups, tail)).sum().item())
        for g in final["kernels"] for n, t in final["kernels"][g]["sub0"].items()}
    del final, packed
    torch.cuda.empty_cache()
    a, b = logits["kernels"], logits["plain"]
    err = (a - b).abs().max().item()
    agree = (a.argmax(-1) == b.argmax(-1)).float().mean().item()
    finite = bool(torch.isfinite(a).all().item())
    # the fused route must have read the pool with the family's kernel for
    # its pool (quantized or not) at every decode step of every layer, the
    # plain route never
    exponents = _kv_exponent_card_vs_cpu(torch, dev) if quant else None
    # (fp32 queries: MLA on mla_partial, its tensor-core counts 0)
    # (a tail-prefill admission launches the pool's kernel once a layer)
    n_attn = layers * (steps + (len(lens) if tail else 0))
    want = {"kernels": {names[0]: 0 if quant else n_attn, names[1]: n_attn if quant else 0},
            "plain": dict.fromkeys(names, 0)}
    # a quantized tail-prefill run's plain route wrote the kernel route's
    # entries: the pools must be equal, and the entries each route computed
    # for itself within the logits' bar
    shared = bool(tail and quant)
    kv_err = max(((o.float() - w.float()).abs().max().item() for _, ws, _, owns in logs["plain"]
                  for o, w in zip(owns, ws)), default=0.0) if shared else None
    want["kernels"].update(dict.fromkeys(names[2:], 0))
    row = {"phase": "parity", "arch": arch, "layers": layers, "n_bits": 2,
           "kv_cache_dtype": kv_cache_dtype, "compute": "float32", "prompts": lens,
           "decode_steps": steps, "logit_rows": int(a.shape[0]), "max_abs_logit_err": err,
           "atol": PARITY_ATOL, "plain_route_writes_kernel_entries": shared,
           "own_kv_entries_max_abs_err": kv_err,
           "logit_scale": a.abs().max().item(), "argmax_agreement": agree,
           "finite": finite, "attention_launches": attn_launches, "matmul_launches": mm_launches,
           "expected_attention_launches": want,
           "admission": "tail prefill" if tail else "bucketed prefill + block scatter",
           "admission_pool_equal_cpu": admission_equal, "plain_packed_backend": plain_pb,
           "pool_words_differing_after_decode": words_differing,
           "kv_exponent_card_equal_cpu": exponents,
           "pass": (finite and err <= PARITY_ATOL and agree == 1.0
                    and (not shared or (kv_err <= PARITY_ATOL
                                        and not any(words_differing.values())))
                    and attn_launches == want
                    and all(admission_equal.values())
                    and (exponents is None or all(v for e in exponents.values()
                                                  for k, v in e.items() if k != "amaxes")))}
    emit(row)
    if not row["pass"]:
        raise Failed(f"parity {arch} {kv_cache_dtype}: {row}")
    return row


# ---------------------------------------------------------------------------
# launch counts: every wrapper counts its own kernel's launches
# ---------------------------------------------------------------------------
def _counters():
    from repro_torch.kernels.fixedpoint_matmul import ops as fops
    from repro_torch.kernels.paged_attention import ops as aops
    from repro_torch.kernels.symog_update import ops as sops

    return {"fixedpoint_matmul": (fops, "launches"),
            "fixedpoint_matmul_tc": (fops, "tc_launches"),
            "fixedpoint_matmul_decode": (fops, "decode_launches"),
            "fixedpoint_matmul_experts": (fops, "experts_launches"),
            "fixedpoint_matmul_experts_tc": (fops, "tc_experts_launches"),
            "fixedpoint_matmul_experts_decode": (fops, "decode_experts_launches"),
            "paged_attention": (aops, "launches"),
            "paged_attention_quant": (aops, "quant_launches"),
            "paged_attention_prefill": (aops, "prefill_launches"),
            "paged_attention_prefill_quant": (aops, "prefill_quant_launches"),
            "paged_attention_mla": (aops, "mla_launches"),
            "paged_attention_mla_quant": (aops, "mla_quant_launches"),
            "paged_attention_mla_tc": (aops, "mla_tc_launches"),
            "paged_attention_mla_tc_quant": (aops, "mla_tc_quant_launches"),
            "symog_update": (sops, "launches")}


def zero_counts() -> None:
    for mod, attr in _counters().values():
        setattr(mod, attr, 0)


def read_counts():
    return {name: getattr(mod, attr) for name, (mod, attr) in _counters().items()}


def _prefill_route_calls(cfg, rows, pool_code: int) -> int:
    """How many of the bf16 GQA calls of ``rows`` query positions each (a
    tail prefill's bucket, a verify's k + 1) the rule sends to the prefill
    kernel, over a pool of ``pool_code`` (1 bf16, 4 SYMOG int4 words)."""
    import torch
    from repro_torch.kernels.paged_attention import ops as aops

    G = cfg.n_heads // cfg.n_kv_heads
    return sum(aops._gqa_route(torch.bfloat16, pool_code, 1.0, cfg.head_dim, 16, T * G)
               == "prefill" for T in rows)


def _capacity(cfg, bucket: int) -> int:
    """Rows per expert of a bucketed prefill (``moe_apply``'s C)."""
    return max(1, int(math.ceil(cfg.capacity_factor * bucket * cfg.top_k / cfg.n_experts)))


MATMUL_KERNEL = {"streaming": "fixedpoint_matmul", "tensor_core": "fixedpoint_matmul_tc",
                 "decode": "fixedpoint_matmul_decode"}


def _matmul_counts(n_2d: int, n_experts: int, decode_steps: int, buckets, cfg=None, *,
                   head: bool = False, decode_2d: int = None):
    """Launches of the matmul kernels on a serve path, each bf16 call on
    the kernel the route rule picks for its rows: per decode step
    ``decode_2d`` (default ``n_2d``) 2-D launches at M = 4 slots and
    ``n_experts`` experts launches at C = 4; per admission of ``bucket``
    tokens ``n_2d`` 2-D launches at M = bucket and ``n_experts`` at C =
    ``_capacity``.  ``head``: the fp32 head adds one streaming launch per
    decode step (M = 4) and per admission (M = 1)."""
    import torch
    from repro_torch.kernels.fixedpoint_matmul import ops as fops

    out = dict.fromkeys(list(MATMUL_KERNEL.values()) +
                        [k.replace("matmul", "matmul_experts") for k in MATMUL_KERNEL.values()], 0)

    def add(n, rows, experts=False):
        name = MATMUL_KERNEL[fops._pick_route(torch.bfloat16, rows, True)]
        out[name.replace("matmul", "matmul_experts") if experts else name] += n

    add((n_2d if decode_2d is None else decode_2d) * decode_steps, DECODE_TOKENS)
    if n_experts:
        add(n_experts * decode_steps, DECODE_TOKENS, experts=True)
    for b in buckets:
        add(n_2d, b)
        if n_experts:
            add(n_experts, _capacity(cfg, b), experts=True)
    if head:
        out["fixedpoint_matmul"] += decode_steps + len(buckets)
    return out


def _record_admissions(torch, fns):
    """Wrap the scheduler's admission steps (the bucketed prefill + block
    scatter, and the tail prefill), each with its first token, as
    ``timed_decode`` wraps decode: host clock between synchronizations, each
    admission's bucket and ms.  Returns (record, restore)."""
    inner = {k: getattr(fns, k) for k in ("admit_step", "admit_prefix_step")}
    rec = {"buckets": [], "ms": [], "params": []}

    def wrap(make):
        def admit(bucket, block_size):
            fn = make(bucket, block_size)

            def run(*args):
                torch.cuda.synchronize()
                t = time.perf_counter()
                out = fn(*args)
                torch.cuda.synchronize()
                rec["ms"].append((time.perf_counter() - t) * 1e3)
                rec["buckets"].append(int(bucket))
                rec["params"].append(args[0])  # whose weights: a draft mirrors admissions
                return out

            return run

        return admit

    for k, make in inner.items():
        setattr(fns, k, wrap(make))
    return rec, lambda: [setattr(fns, k, make) for k, make in inner.items()]


# ---------------------------------------------------------------------------
# phase 5: full-width serve through the scheduler
# ---------------------------------------------------------------------------
def stub_extras(cfg, rng):
    """A request's stub frontend output, N(0, 0.01) from ``rng``: whisper's
    frame embeddings (1, encoder_len, d_model), paligemma's patch
    embeddings (1, prefix_len, d_model); None for the other families (and
    ``rng`` untouched)."""
    import numpy as np

    n = {"encdec": ("frames", cfg.encoder_len), "vlm": ("patches", cfg.prefix_len)}.get(
        cfg.family)
    if n is None:
        return None
    return {n[0]: (rng.standard_normal((1, n[1], cfg.d_model), dtype=np.float32) * 0.1)}


def train_batches(torch, dev, cfg, seq: int, n: int, seed: int):
    """``n`` training batches of TRAIN_BATCH rows on ``dev``: SyntheticLM
    tokens from ``seed`` and, for whisper and paligemma, each row's stub
    frontend output (``stub_extras``) from a numpy generator of ``seed``,
    stacked along B."""
    import numpy as np
    from repro_torch.data import SyntheticLM, SyntheticLMConfig

    data = SyntheticLM(SyntheticLMConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                                         global_batch=TRAIN_BATCH, seed=seed))
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        batch = next(data)
        rows = [stub_extras(cfg, rng) for _ in range(TRAIN_BATCH)]
        if rows[0] is not None:
            batch.update({k: np.concatenate([r[k] for r in rows]) for k in rows[0]})
        out.append({k: torch.as_tensor(v, device=dev) for k, v in batch.items()})
    return out


def phase_serve(torch, dev, arch: str, kv_cache_dtype: str, seed: int, expected,
                layers: int = 0, build=None, max_len: int = 512, lens=None,
                new_tokens: int = 32):
    """Serve the seeded traffic (4 slots, block 16, max_len 512, 8 requests
    of 24..400 prompt tokens, or of ``lens`` tokens under ``max_len``, 32
    new tokens each, or ``new_tokens``) through the
    continuous-batching scheduler from a 2-bit packed artifact of ``arch``
    at full width and all its layers (``layers`` > 0 cuts the depth, an
    encoder-decoder's encoder as well as its decoder), made
    on the card from random weights (``seed``) by ``symog_init`` +
    ``pack_tree`` (``build(cfg, seed)`` -> (artifact, n_params, seconds by
    step) instead, for a model too large to hold in fp32).
    ``expected(cfg, stats, buckets)`` gives every kernel's launch count on
    this path (``buckets``: each admission's prompt bucket, in order): the
    counts are zeroed just before the serve and read just after.  Each
    admission is timed as each decode step is.
    Returns the row (emitted by the caller, which may add to it), the
    engine, the requests, the serve config and the tokens."""
    import numpy as np
    from repro_torch import configs
    from repro_torch.core import SymogConfig, symog_init
    from repro_torch.kernels.fixedpoint_matmul import ops as fops
    from repro_torch.models import init_lm
    from repro_torch.nn.tree import tree_leaves
    from repro_torch.serve import Request, ServeConfig, ServeEngine

    cfg = dataclasses.replace(configs.get_config(arch), kv_cache_dtype=kv_cache_dtype)
    if layers:  # an encoder-decoder's encoder too
        cfg = dataclasses.replace(cfg, n_layers=layers, **(
            {"n_encoder_layers": layers} if cfg.n_encoder_layers else {}))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    if build is not None:
        tree, n_params, secs = build(cfg, seed)
        eng = ServeEngine(cfg, tree, max_len=max_len, compute_dtype=torch.bfloat16, device=dev)
        del tree
    else:
        t_init = time.perf_counter()
        params = init_lm(seed, cfg, device=dev)
        torch.cuda.synchronize()
        t_symog = time.perf_counter()
        n_params = sum(t.numel() for t in tree_leaves(params))
        scfg = SymogConfig(n_bits=2)
        state = symog_init(params, scfg)
        torch.cuda.synchronize()
        t_pack = time.perf_counter()
        eng = ServeEngine.from_symog(cfg, params, state, scfg, max_len=max_len,
                                     compute_dtype=torch.bfloat16, device=dev)
        torch.cuda.synchronize()
        t_done = time.perf_counter()
        del params, state
        secs = {"init_s": t_symog - t_init, "symog_init_s": t_pack - t_symog,
                "pack_s": t_done - t_pack}
    build_peak = torch.cuda.max_memory_allocated(dev)
    torch.cuda.empty_cache()

    rng = np.random.default_rng(0)
    lens = rng.integers(24, 401, size=8) if lens is None else np.asarray(lens)
    reqs = [Request(tokens=rng.integers(0, cfg.vocab_size, size=int(L)),
                    max_new_tokens=new_tokens, extras=stub_extras(cfg, rng))
            for L in lens]
    sc = ServeConfig(n_slots=4, block_size=16)
    fns = eng.scheduler_fns(greedy=True, top_k=0)
    inner = fns.decode_step
    dec = {"s": 0.0, "rows": 0, "steps": 0, "ms": []}

    def timed_decode(params, caches, tokens, pos, active, *rest):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = inner(params, caches, tokens, pos, active, *rest)
        torch.cuda.synchronize()
        dec["ms"].append((time.perf_counter() - t) * 1e3)
        dec["s"] += dec["ms"][-1] / 1e3
        dec["rows"] += int(active.sum().item())
        dec["steps"] += 1
        return out

    fns.decode_step = timed_decode
    adm, restore = _record_admissions(torch, fns)
    zero_counts()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    comps, sched = eng.serve(reqs, sc, return_scheduler=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    fns.decode_step = inner
    restore()
    peak = torch.cuda.max_memory_allocated(dev)
    st = sched.stats
    want = expected(cfg, st, adm["buckets"])
    prefill_s = sum(adm["ms"]) / 1e3
    tokens = [list(map(int, c.tokens)) for c in comps]
    reasons = sorted({c.finish_reason for c in comps})
    lengths_ok = all(len(c.tokens) == new_tokens or c.finish_reason == "eos" for c in comps)
    tokens_ok = all(0 <= t < cfg.vocab_size for a in tokens for t in a)
    row = {
        "phase": "serve", "arch": arch, "layers": cfg.n_layers, "params": n_params, "n_bits": 2,
        "kv_cache_dtype": kv_cache_dtype, "compute": "bfloat16", "n_slots": 4, "block_size": 16,
        "max_len": max_len, "requests": len(reqs), "prompt_lens": [int(x) for x in lens],
        "new_tokens": new_tokens, **secs, "build_peak_device_bytes": build_peak,
        "wall_s": wall, "decode_steps": st["decode_steps"],
        "prefills": st["prefills"], "preemptions": st["preemptions"],
        "admitted_mid_run": sum(1 for c in comps if c.admitted_step > 0),
        "finish_reasons": reasons, "tokens_emitted": st["tokens_emitted"],
        "decode_tokens_per_s": dec["rows"] / dec["s"] if dec["s"] else None,
        "decode_step_ms": dec["s"] / max(dec["steps"], 1) * 1e3,
        "decode_step_ms_p50_max": [float(np.percentile(dec["ms"], 50)), max(dec["ms"])]
        if dec["ms"] else None,
        "end_to_end_tokens_per_s": st["tokens_emitted"] / wall,
        "prefill_s": prefill_s, "prefill_share_of_wall": prefill_s / wall,
        "prefill_ms": [[b, ms] for b, ms in zip(adm["buckets"], adm["ms"])],
        "tc_min_rows": fops.TC_MIN_ROWS, "decode_max_rows": fops.DECODE_MAX_ROWS,
        "kv_pool_bytes": sched.cache_bytes(), "kv_pool_paged_bytes": sched.paged_pool_bytes(),
        "weight_bytes": eng.weight_bytes(),
        "peak_device_bytes": peak, "launches": counts, "expected_launches": want,
    }
    # every kernel the path runs must have launched, each exactly as often
    # as the path implies (so every bf16 matmul ran on the kernel the rule
    # picks for its rows: decode steps and small admissions on the decode
    # kernel, larger admissions on the tensor cores; the fp32 head on the
    # streaming kernel)
    row["pass"] = (set(reasons) <= {"length", "eos"} and lengths_ok and tokens_ok
                   and len(adm["buckets"]) == st["prefills"]
                   and counts == want and all(counts[k] > 0 for k, n in want.items() if n))
    return row, eng, reqs, sc, tokens


def report(row):
    emit(row)
    if not row["pass"]:
        raise Failed(f"{row['phase']} {row['arch']} failed: {row}")
    return row


def phase_serve_internlm2(torch, dev):
    from repro_torch.models.layers import embed_logits

    def expected(cfg, st, buckets):
        # every packed projection of every layer, once per decode step and
        # once per admission prefill (the prefill cache reuses attention's k/v)
        return {**_matmul_counts(7 * cfg.n_layers, 0, st["decode_steps"], buckets),
                "paged_attention": cfg.n_layers * st["decode_steps"],
                "paged_attention_quant": 0, **dict.fromkeys(MLA_COUNTS + PREFILL_COUNTS, 0),
                "symog_update": 0}

    row, eng, reqs, _, tokens = phase_serve(torch, dev, "internlm2-1.8b", "bf16", 7, expected,
                                            layers=SERVE_LAYERS["internlm2-1.8b"])
    # the tied head: the packed 92544x2048 table is dequantized on every call
    h = torch.randn((4, 1, eng.cfg.d_model), device=dev, dtype=torch.bfloat16)
    row["head_dequant_matmul_ms"] = timed(lambda a: embed_logits(eng.params["embed"], a), [(h,)],
                                          torch)
    row["head_dequant_matmul_ms_rows_unpadded"] = _unpadded(
        lambda: timed(lambda a: embed_logits(eng.params["embed"], a), [(h,)], torch))
    return report(row), eng, reqs, tokens


def _unpadded(fn):
    """``fn()`` with the float matmuls at their own row count (``ROW_TILE``
    1, as before batch-invariant rows): the padding's cost, timed beside."""
    from repro_torch.models import layers

    tile, layers.ROW_TILE = layers.ROW_TILE, 1
    try:
        return fn()
    finally:
        layers.ROW_TILE = tile


def kernel_times(evs):
    """[(name, device us, count)] of the device-side entries of a profiler's
    ``key_averages()`` (kernels, copies, memsets), largest first.  An
    operator's entry (``aten::mm``) repeats the device time of the kernels
    it launched, so summing every entry would count each kernel twice."""
    from torch.autograd import DeviceType

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    out = [(e.key, dev_us(e), e.count) for e in evs if e.device_type == DeviceType.CUDA]
    return sorted((k for k in out if k[1] > 0), key=lambda k: k[1], reverse=True)


# ---------------------------------------------------------------------------
# phase 6: where a decode step's time goes (host profile + device busy share)
# ---------------------------------------------------------------------------
# the matmul kernels by route and form, as the profiler names them
MATMUL_GROUPS = {"decode_experts": ("fpmm_decode", "true>"),
                 "decode_2d": ("fpmm_decode", "false>"),
                 "tensor_core": ("fpmm_tc", ""), "streaming": ("fpmm_", "")}


# the MLA kernels, as the profiler names them
MLA_GROUPS = {"tensor_core": "mla_decode_tc", "partial": "mla_partial",
              "combine": "attn_combine"}


def _mla_groups(kern, steps: int):
    """Device ms a step of the MLA kernels by route (``attn_combine`` is
    mla_partial's second launch)."""
    return {g: sum(us for name, us, _ in kern if k in name) / steps / 1e3
            for g, k in MLA_GROUPS.items()}


def _matmul_groups(kern, steps: int):
    """Device ms a step by matmul group (first match wins, in the order of
    MATMUL_GROUPS; the streaming group is fpmm_partial + fpmm_finish)."""
    out = dict.fromkeys(MATMUL_GROUPS, 0.0)
    for name, us, _ in kern:
        for g, (a, b) in MATMUL_GROUPS.items():
            if a in name and b in name:
                out[g] += us / steps / 1e3
                break
    return out


def _parent_mla_route(*args) -> str:
    """The MLA route rule before the tensor-core kernel: every call on
    ``mla_partial`` + ``attn_combine``."""
    return "partial"


def phase_profile(torch, dev, eng, steps: int = 4, mla_rule=None):
    """A few decode steps of ``eng``: step ms, host functions (cProfile),
    device busy time and top kernels (torch.profiler), the matmul kernels'
    device ms by route and form, and (MLA models) the MLA kernels' device
    ms.  ``mla_rule`` replaces the MLA route rule for this phase only (the
    parent's rule, to measure the step as it was in one run with the
    change)."""
    from repro_torch.kernels.paged_attention import ops as aops

    if mla_rule is None:
        return _profile(torch, dev, eng, steps)
    inner = aops._mla_route
    aops._mla_route = mla_rule
    try:
        row = _profile(torch, dev, eng, steps, rule=mla_rule.__name__)
    finally:
        aops._mla_route = inner
    return row


def _profile(torch, dev, eng, steps: int, rule: str = "_mla_route"):
    import cProfile
    import pstats

    import numpy as np
    from repro_torch.serve import Request, Scheduler, ServeConfig

    rng = np.random.default_rng(1)
    sched = Scheduler(eng, ServeConfig(n_slots=4, block_size=16))
    for _ in range(4):
        sched.submit(Request(tokens=rng.integers(0, eng.cfg.vocab_size, size=300),
                             max_new_tokens=64, extras=stub_extras(eng.cfg, rng)))
    for _ in range(3):  # admit all four, then two warm decode steps
        sched.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        sched.step()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / steps * 1e3
    row = {"phase": "profile", "arch": eng.cfg.name, "layers": eng.cfg.n_layers,
           "kv_cache_dtype": eng.cfg.kv_cache_dtype, "live_slots": sched._n_live,
           "route_rule": rule, "decode_step_ms": step_ms}
    prof = cProfile.Profile()
    prof.enable()
    for _ in range(steps):
        sched.step()
    torch.cuda.synchronize()
    prof.disable()
    st = pstats.Stats(prof)
    top = sorted(st.stats.items(), key=lambda kv: kv[1][2], reverse=True)[:12]
    row["host_top_tottime_ms_per_step"] = [
        [f"{os.path.basename(k[0])}:{k[1]}:{k[2]}", v[2] / steps * 1e3] for k, v in top
    ]
    # Only the profiler's own calls may fail softly (it is untried on some
    # machines); an error raised by the port's steps fails the script.
    tp = None
    try:
        from torch.profiler import ProfilerActivity, profile

        tp = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        tp.start()
    except Exception as e:
        row["device_busy_ms_per_step"] = f"not measured ({type(e).__name__}: {e})"
        tp = None
    t0 = time.perf_counter()
    for _ in range(steps):
        sched.step()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if tp is not None:
        try:
            tp.stop()
            evs = tp.key_averages()
        except Exception as e:
            row["device_busy_ms_per_step"] = f"not measured ({type(e).__name__}: {e})"
            evs = None
        if evs is not None:
            kern = kernel_times(evs)
            busy_us = sum(us for _, us, _ in kern)
            row["profiled_step_ms"] = wall / steps * 1e3
            row["device_busy_ms_per_step"] = busy_us / steps / 1e3
            row["device_idle_share"] = 1.0 - busy_us / 1e6 / wall if wall else None
            row["device_top_ms_per_step"] = [[k[:60], us / steps / 1e3, n // steps]
                                             for k, us, n in kern[:10]]
            row["matmul_device_ms_per_step"] = _matmul_groups(kern, steps)
            if eng.cfg.use_mla:
                row["mla_device_ms_per_step"] = _mla_groups(kern, steps)
    emit(row)
    return row


# ---------------------------------------------------------------------------
# phase 7: SYMOG training at full width and depth, then serve the result
# ---------------------------------------------------------------------------
TRAIN_STEPS = 6
TRAIN_TOL = dict(rtol=1e-5, atol=1e-7)  # fused vs composed, tests/test_kernels.py:56-57


def _profiled_step(torch, step, state, batch):
    """One train step under torch.profiler: (state, metrics, symog_update
    device ms, {device busy ms, idle share, GEMM ms, top kernels}, wall ms);
    the two middle fields say "not measured" / None if the trace fails."""
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.start()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, m = step(state, batch)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    prof.stop()
    try:
        evs = prof.key_averages()
    except Exception as e:  # the profiler's own failure only
        return state, m, f"not measured ({type(e).__name__}: {e})", None, wall

    kern = kernel_times(evs)
    busy = sum(us for _, us, _ in kern) / 1e3
    upd = sum(us for k, us, _ in kern if "symog_update" in k) / 1e3
    gemm = sum(us for k, us, _ in kern
               if any(t in k.lower() for t in ("gemm", "nvjet", "xmma", "cutlass"))) / 1e3
    return state, m, upd, {"busy_ms": busy, "idle_share": 1.0 - busy / wall, "gemm_ms": gemm,
                           "top": [[k[:60], us / 1e3, n] for k, us, n in kern[:12]]}, wall


def _step1_fused_vs_composed(torch, state, grads, scfg, tx, *, lam, lr, arch, repeat=False):
    """Step 1 from one set of grads, leaf by leaf on copies: the fused update
    (``symog_update``, a Δ per (layer, expert) on expert stacks) against the
    composed one at TRAIN_TOL; with ``repeat`` the fused update runs twice
    and must give the same bits."""
    from repro_torch import core
    from repro_torch.nn.tree import flatten_with_paths
    from repro_torch.train import composed_update, fused_update

    g_by, v_by, f_by = (dict(flatten_with_paths(t)) for t in (grads, state.opt_state,
                                                                state.symog.f))
    rows, worst, all_ok, same = [], 0.0, True, True
    for path, w in flatten_with_paths(state.params):
        sub = core.SymogState(f={"w": f_by[path]}, mask={"w": state.symog.mask[path]})
        g = {"w": g_by[path]}
        fp, fv = fused_update({"w": w.clone()}, g, {"w": v_by[path].clone()}, sub, scfg, tx,
                              lr=lr, lam=lam)
        if repeat:
            fp2, fv2 = fused_update({"w": w.clone()}, g, {"w": v_by[path].clone()}, sub, scfg,
                                    tx, lr=lr, lam=lam)
            same = same and bool(torch.equal(fp["w"], fp2["w"]) and torch.equal(fv["w"], fv2["w"]))
            del fp2, fv2
        cp, cv = composed_update({"w": w}, g, {"w": v_by[path]}, sub, scfg, tx, lr=lr, lam=lam)
        errs = [(fp["w"] - cp["w"]).abs().max().item(), (fv["w"] - cv["w"]).abs().max().item()]
        ok = bool(torch.allclose(fp["w"], cp["w"], **TRAIN_TOL)
                  and torch.allclose(fv["w"], cv["w"], **TRAIN_TOL))
        rows.append([path, list(w.shape), list(f_by[path].shape), errs[0], errs[1], ok])
        worst, all_ok = max(worst, *errs), all_ok and ok
        del fp, fv, cp, cv
    row = {"phase": "train_step1_fused_vs_composed", "arch": arch, "tol": TRAIN_TOL,
           "leaves": rows, "max_abs_err": worst, "pass": all_ok and same}
    if repeat:
        row["fused_repeat_bit_identical"] = same
    emit(row)
    if not row["pass"]:
        raise Failed(f"train {arch}: fused and composed step-1 updates disagree, or the fused "
                     "update does not repeat")
    return row


def phase_train(torch, dev):
    import numpy as np
    from repro_torch import configs, core, optim
    from repro_torch.data import SyntheticLM, SyntheticLMConfig
    from repro_torch.kernels.symog_update import ops as sops
    from repro_torch.models import init_lm, lm_train_loss
    from repro_torch.nn.tree import tree_leaves
    from repro_torch.serve import Request, ServeConfig, ServeEngine
    from repro_torch.train import init_train_state, make_train_step
    from repro_torch.train.trainer import _accum_grads

    # full width, all 24 layers; remat off, as this phase has always run (its step
    # ms and peak stay comparable with earlier runs)
    cfg = dataclasses.replace(configs.get_config("internlm2-1.8b"), remat=False)
    torch.cuda.reset_peak_memory_stats(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(12)
    params = init_lm(gen, cfg, device=dev)  # fp32 master weights
    n_params = sum(t.numel() for t in tree_leaves(params))
    tx = optim.sgd(momentum=0.9)
    scfg = core.SymogConfig(n_bits=2, total_steps=TRAIN_STEPS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = init_train_state(params, tx, scfg)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    quant_paths = [p for p, m in state.symog.mask.items() if m]
    rqe_before = core.quant_error_metrics(state.params, state.symog, scfg)["rel_quant_error"].item()
    data = SyntheticLM(SyntheticLMConfig(vocab_size=cfg.vocab_size, seq_len=512, global_batch=4,
                                         seed=0))
    batches = [{k: torch.as_tensor(v, device=dev) for k, v in next(data).items()}
               for _ in range(TRAIN_STEPS)]
    lr_fn = core.linear_lr(0.01, 0.001, TRAIN_STEPS)

    # step 1 from one set of grads, fused vs composed, leaf by leaf (copies)
    def loss_fn(p, b):
        return lm_train_loss(p, b, cfg, compute_dtype=torch.bfloat16)

    _, _, grads = _accum_grads(loss_fn, state.params, batches[0], 1)
    _step1_fused_vs_composed(torch, state, grads, scfg, tx, lam=core.lambda_at(scfg, 0),
                             lr=lr_fn(0), arch="internlm2-1.8b")
    del grads
    torch.cuda.empty_cache()

    # the main path: TRAIN_STEPS fused steps through make_train_step
    step = make_train_step(cfg, tx, lr_fn, symog_cfg=scfg, compute_dtype=torch.bfloat16)
    losses, step_ms, per_step_launches = [], [], []
    prof = None
    zero_counts()
    for i, batch in enumerate(batches):
        before = sops.launches
        if i == TRAIN_STEPS - 1:
            state, m, upd_ms, prof, wall = _profiled_step(torch, step, state, batch)
        else:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step(state, batch)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
            step_ms.append(wall)
        per_step_launches.append(sops.launches - before)
        losses.append(m["loss"].item())
        emit({"phase": "train_step", "step": i, "loss": losses[-1], "ce": m["ce"].item(),
              "grad_norm": m["grad_norm"].item(), "lr": m["lr"],
              "symog_lambda": m["symog_lambda"], "ms": wall,
              "symog_update_launches": per_step_launches[-1]})
    n_launch = sops.launches
    peak = torch.cuda.max_memory_allocated(dev)
    rqe_after = core.quant_error_metrics(state.params, state.symog, scfg)["rel_quant_error"].item()
    median_ms = float(np.median(step_ms[1:]))  # step 0 warms allocator and kernels
    row = {"phase": "train", "arch": "internlm2-1.8b", "layers": cfg.n_layers,
           "d_model": cfg.d_model, "params": n_params, "quantizable_leaves": len(quant_paths),
           "batch": [4, 512], "compute": "bfloat16", "master": "float32", "n_bits": 2,
           "optimizer": "sgd nesterov 0.9, linear_lr 0.01->0.001, SYMOG lambda0 10 alpha 9",
           "symog_init_s": init_s, "losses": losses, "step_ms": step_ms,
           "median_step_ms": median_ms, "symog_update_launches": n_launch,
           "launches_per_step": per_step_launches, "profiled_step_ms": wall,
           "update_device_ms": upd_ms, "profile": prof,
           "update_share_of_step": (upd_ms / median_ms if isinstance(upd_ms, float) else None),
           "peak_device_bytes": peak, "rel_quant_error_before": rqe_before,
           "rel_quant_error_after": rqe_after}
    row["pass"] = (all(math.isfinite(x) for x in losses)
                   and per_step_launches == [len(quant_paths)] * TRAIN_STEPS
                   and len(quant_paths) == 8)
    emit(row)
    if not row["pass"]:
        raise Failed(f"train phase failed: {row}")

    # serve the trained weights, packed, through the kernels
    eng = ServeEngine.from_symog(cfg, state.params, state.symog, scfg, max_len=128,
                                 compute_dtype=torch.bfloat16, device=dev)
    del state, params
    torch.cuda.empty_cache()
    rng = np.random.default_rng(2)
    reqs = [Request(tokens=rng.integers(0, cfg.vocab_size, size=L), max_new_tokens=8)
            for L in (40, 100)]
    comps = eng.serve(reqs, ServeConfig(n_slots=2, block_size=16))
    srow = {"phase": "train_serve", "requests": len(reqs),
            "tokens": [list(map(int, c.tokens)) for c in comps],
            "finish_reasons": [c.finish_reason for c in comps]}
    srow["pass"] = all(len(c.tokens) == 8 and c.finish_reason == "length" for c in comps)
    emit(srow)
    if not srow["pass"]:
        raise Failed(f"serving the trained model failed: {srow}")
    del eng
    torch.cuda.empty_cache()
    return row


# ---------------------------------------------------------------------------
# phase 7b: SYMOG training of olmoe-1b-7b at full width, 6 of its 16 layers
# (one Δ per (layer, expert)), then the trained weights served packed;
# 7c: reduced deepseek-v3 with its MTP loss, the card against the CPU
# ---------------------------------------------------------------------------
OLMOE_TRAIN_LAYERS = 6  # 2.72 B parameters: ~54 GB of masters, momentum, grads
REMAT_OFF_STEPS = 3


def _timed_step(torch, step, state, batch):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, m = step(state, batch)
    torch.cuda.synchronize()
    return state, m, (time.perf_counter() - t0) * 1e3


def phase_train_olmoe(torch, dev, cfg=None, steps: int = TRAIN_STEPS, seq: int = 512,
                      max_len: int = 128):
    """``cfg``, ``steps``, ``seq`` and ``max_len`` shrink the phase for a CPU
    rehearsal only; the card runs the defaults."""
    import numpy as np
    from repro_torch import configs, core, optim
    from repro_torch.data import SyntheticLM, SyntheticLMConfig
    from repro_torch.kernels.symog_update import ops as sops
    from repro_torch.models import init_lm, lm_train_loss
    from repro_torch.nn.tree import flatten_with_paths, tree_leaves
    from repro_torch.serve import Request, ServeConfig, ServeEngine
    from repro_torch.train import init_train_state, make_train_step
    from repro_torch.train.trainer import _accum_grads

    if cfg is None:  # every published width, depth 16 -> 6; JAX's remat default (on)
        cfg = dataclasses.replace(configs.get_config("olmoe-1b-7b"), n_layers=OLMOE_TRAIN_LAYERS)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(21)
    params = init_lm(gen, cfg, device=dev)  # fp32 master weights
    n_params = sum(t.numel() for t in tree_leaves(params))
    tx = optim.sgd(momentum=0.9)
    scfg = core.SymogConfig(n_bits=2, total_steps=steps)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = init_train_state(params, tx, scfg)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    quant = [p for p, m in state.symog.mask.items() if m]
    f_shapes = {p: list(f.shape) for p, f in flatten_with_paths(state.symog.f)
                if state.symog.mask[p] and f.ndim}
    rqe_before = core.quant_error_metrics(state.params, state.symog, scfg)["rel_quant_error"].item()
    data = SyntheticLM(SyntheticLMConfig(vocab_size=cfg.vocab_size, seq_len=seq, global_batch=4,
                                         seed=1))
    batches = [{k: torch.as_tensor(v, device=dev) for k, v in next(data).items()}
               for _ in range(steps + REMAT_OFF_STEPS)]
    lr_fn = core.linear_lr(0.01, 0.001, steps)

    # step 1 twice from one state: grads bit-identical (the MoE gathers'
    # slot-order backward); then fused vs composed leaf by leaf, expert
    # stacks included, the fused update itself repeated
    def loss_fn(p, b):
        return lm_train_loss(p, b, cfg, compute_dtype=torch.bfloat16)

    l1, m1, g1 = _accum_grads(loss_fn, state.params, batches[0], 1)
    l2, m2, g2 = _accum_grads(loss_fn, state.params, batches[0], 1)
    grads_same = bool(torch.equal(l1, l2) and all(torch.equal(m1[k], m2[k]) for k in m1)
                      and all(torch.equal(a, b) for a, b in zip(tree_leaves(g1),
                                                                 tree_leaves(g2))))
    del g2
    torch.cuda.empty_cache()
    emit({"phase": "train_step1_repeat", "arch": cfg.name, "loss": l1.item(),
          "grads_bit_identical": grads_same, "pass": grads_same})
    if not grads_same:
        raise Failed("train olmoe: two backward passes from one state differ")
    cmp = _step1_fused_vs_composed(torch, state, g1, scfg, tx, lam=core.lambda_at(scfg, 0),
                                   lr=lr_fn(0), arch=cfg.name, repeat=True)
    del g1
    torch.cuda.empty_cache()

    # the main path: fused steps through make_train_step, remat on (JAX's
    # default for this config); then a few more with remat off
    step = make_train_step(cfg, tx, lr_fn, symog_cfg=scfg, compute_dtype=torch.bfloat16)
    losses, step_ms, per_step, metrics = [], [], [], []
    torch.cuda.reset_peak_memory_stats(dev)
    zero_counts()
    upd_ms = prof = prof_wall = None
    for i in range(steps):
        before = sops.launches
        if i == steps - 1 and steps > 2:  # the last step under torch.profiler
            state, m, upd_ms, prof, wall = _profiled_step(torch, step, state, batches[i])
            prof_wall = wall
        else:
            state, m, wall = _timed_step(torch, step, state, batches[i])
            step_ms.append(wall)
        per_step.append(sops.launches - before)
        row_m = {k: (v.item() if hasattr(v, "item") else v) for k, v in m.items()}
        metrics.append(row_m)
        losses.append(row_m["loss"])
        emit({"phase": "train_step", "arch": cfg.name, "step": i, **row_m, "ms": wall,
              "symog_update_launches": per_step[-1]})
    counts_on = read_counts()
    peak_on = torch.cuda.max_memory_allocated(dev)
    off_cfg = dataclasses.replace(cfg, remat=False)
    step_off = make_train_step(off_cfg, tx, lr_fn, symog_cfg=scfg, compute_dtype=torch.bfloat16)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    off_ms, off_losses = [], []
    for i in range(REMAT_OFF_STEPS):
        state, m, wall = _timed_step(torch, step_off, state, batches[steps + i])
        off_ms.append(wall)
        off_losses.append(m["loss"].item())
    peak_off = torch.cuda.max_memory_allocated(dev)
    rqe_after = core.quant_error_metrics(state.params, state.symog, scfg)["rel_quant_error"].item()
    finite = all(math.isfinite(x) for r in metrics for x in
                 (r["loss"], r["ce"], r["moe_aux_loss"], r["moe_z_loss"])) and all(
        math.isfinite(x) for x in off_losses)
    row = {"phase": "train", "arch": cfg.name, "layers": cfg.n_layers,
           "reduced": f"depth {configs.get_config('olmoe-1b-7b').n_layers} -> {cfg.n_layers}",
           "d_model": cfg.d_model, "experts": [cfg.n_experts, cfg.top_k, cfg.d_ff_expert],
           "vocab": cfg.vocab_size, "params": n_params, "quantizable_leaves": len(quant),
           "per_expert_f_shapes": f_shapes, "batch": [4, seq], "compute": "bfloat16",
           "master": "float32", "n_bits": 2,
           "optimizer": "sgd nesterov 0.9, linear_lr 0.01->0.001, SYMOG lambda0 10 alpha 9",
           "symog_init_s": init_s, "losses": losses,
           "ce": [r["ce"] for r in metrics], "moe_aux_loss": [r["moe_aux_loss"] for r in metrics],
           "moe_z_loss": [r["moe_z_loss"] for r in metrics],
           "remat_on": {"step_ms": step_ms, "median_step_ms": float(np.median(step_ms[1:])),
                        "peak_device_bytes": peak_on, "profiled_step_ms": prof_wall,
                        "update_device_ms": upd_ms, "profile": prof},
           "remat_off": {"step_ms": off_ms, "median_step_ms": float(np.median(off_ms[1:])),
                         "peak_device_bytes": peak_off, "losses": off_losses},
           "symog_update_launches": counts_on["symog_update"], "launches_per_step": per_step,
           "step1_max_abs_err": cmp["max_abs_err"], "rel_quant_error_before": rqe_before,
           "rel_quant_error_after": rqe_after}
    row["pass"] = (finite and per_step == [len(quant)] * steps
                   and counts_on["symog_update"] == len(quant) * steps
                   and all(v == 0 for k, v in counts_on.items() if k != "symog_update")
                   and len(f_shapes) == 3)
    emit(row)
    if not row["pass"]:
        raise Failed(f"train phase {cfg.name} failed: {row}")

    # serve the trained weights, packed (one Δ per expert), from an int4 pool
    eng = ServeEngine.from_symog(dataclasses.replace(cfg, kv_cache_dtype="int4_fp"), state.params,
                                 state.symog, scfg, max_len=max_len,
                                 compute_dtype=torch.bfloat16, device=dev)
    del state, params
    torch.cuda.empty_cache()
    rng = np.random.default_rng(3)
    reqs = [Request(tokens=rng.integers(0, cfg.vocab_size, size=L), max_new_tokens=8)
            for L in (40, 100)]
    zero_counts()
    comps = eng.serve(reqs, ServeConfig(n_slots=2, block_size=16))
    counts = read_counts()
    experts = sum(counts[k] for k in counts if k.startswith("fixedpoint_matmul_experts"))
    srow = {"phase": "train_serve", "arch": cfg.name, "requests": len(reqs),
            "tokens": [list(map(int, c.tokens)) for c in comps],
            "finish_reasons": [c.finish_reason for c in comps], "launches": counts,
            "expert_matmul_launches": experts}
    srow["pass"] = (all(len(c.tokens) == 8 and c.finish_reason == "length" for c in comps)
                    and experts > 0 and counts["paged_attention_quant"] > 0
                    and counts["paged_attention"] == 0 and counts["symog_update"] == 0)
    emit(srow)
    if not srow["pass"]:
        raise Failed(f"serving the trained {cfg.name} failed: {srow}")
    del eng
    torch.cuda.empty_cache()
    row["serve_launches"] = counts
    return row


def phase_train_reduced(torch, dev, arch: str = None, steps: int = 3):
    """A reduced config (by default deepseek-v3: MLA, a dense layer, a
    shared expert, the MTP module; phase 16b: mamba2, recurrentgemma,
    whisper with its frames, paligemma with its patches), fp32 compute,
    SYMOG 2-bit at the default 1,000-step λ schedule: ``steps`` steps on the
    card (the fused route) and on the CPU (the composed one) from the same
    init and batches; every loss term (``lm_train_loss``'s metrics) and
    every param at TRAIN_TOL."""
    import numpy as np
    from repro_torch import configs, core, optim
    from repro_torch.models import init_lm
    from repro_torch.nn.tree import flatten_with_paths, tree_to
    from repro_torch.train import init_train_state, make_train_step

    cfg = configs.get_reduced(arch or DEEPSEEK)
    batches = train_batches(torch, "cpu", cfg, 16, steps, 4)
    out = {}
    for where in ("cpu", dev):
        tx = optim.sgd(momentum=0.9)
        scfg = core.SymogConfig(n_bits=2)
        st = init_train_state(tree_to(init_lm(0, cfg, device="cpu"), where), tx, scfg)
        step = make_train_step(cfg, tx, core.linear_lr(0.01, 0.001, steps), symog_cfg=scfg,
                               compute_dtype=torch.float32)
        zero_counts()
        ms = []
        for b in batches:
            st, m = step(st, b)
            ms.append({k: (v.item() if hasattr(v, "item") else v) for k, v in m.items()})
        out[str(where)] = (st, ms, read_counts()["symog_update"])
    (cs, cm), (gs, gm) = out["cpu"][:2], out[str(dev)][:2]
    c_launch, g_launch = out["cpu"][2], out[str(dev)][2]
    # the loss terms the config must report, on both routes
    keys = (["loss", "ce"] + (["moe_aux_loss", "moe_z_loss"] if cfg.moe else [])
            + (["mtp_ce"] if cfg.use_mtp else []))
    terms = {"cpu": set(cm[0]) - {"grad_norm", "lr", "symog_lambda"},
             "card": set(gm[0]) - {"grad_norm", "lr", "symog_lambda"}}
    metric_ok = (all(t == set(keys) for t in terms.values())
                 and all(np.allclose(g[k], c[k], rtol=TRAIN_TOL["rtol"], atol=0)
                         for g, c in zip(gm, cm) for k in keys))
    worst, params_ok = 0.0, True
    for (path, a), (_, b) in zip(flatten_with_paths(gs.params), flatten_with_paths(cs.params)):
        a = a.cpu()
        worst = max(worst, (a - b).abs().max().item())
        params_ok = params_ok and bool(torch.allclose(a, b, **TRAIN_TOL))
    n_quant = sum(gs.symog.mask.values())
    row = {"phase": "train_reduced", "arch": cfg.name, "family": cfg.family, "steps": steps,
           "compute": "float32", "tol": TRAIN_TOL, "loss_keys": keys,
           "reported_terms": {k: sorted(v) for k, v in terms.items()}, "card": gm, "cpu": cm,
           "max_abs_param_err": worst, "symog_update_launches": g_launch,
           "quantizable_leaves": n_quant, "cpu_launches": c_launch}
    row["pass"] = metric_ok and params_ok and g_launch == n_quant * steps and c_launch == 0
    emit(row)
    if not row["pass"]:
        raise Failed(f"{cfg.name} training, card vs CPU: {row}")
    return row


# ---------------------------------------------------------------------------
# phase 12: the paper's CNNs — every arch's forward at full width against the
# CPU; LeNet-5 under tests/test_system.py's recipe and gates; VGG7 at full
# width on CIFAR-shaped synthetic images
# ---------------------------------------------------------------------------
CNN_FWD_TOL = dict(rtol=1e-4, atol=1e-4)  # logits, tests/test_torch_lm.py
# torch seed of the LeNet init.  The recipe's float stage dies (loss at chance)
# for about a draw in four, from the JAX package's init as from the port's
# (scripts/lenet_float_seeds.py, scripts/lenet_float_seeds_jax.py); seed 0's
# draw is one of them
LENET_SEED = 1


def phase_cnn_parity(torch, dev, batch: int = 8):
    """Every ``PAPER_CNNS`` arch at full width, fp32, train and eval mode:
    logits and new BN stats on the card against the CPU."""
    import numpy as np
    from repro_torch.data import SyntheticImages, SyntheticImagesConfig
    from repro_torch.models import PAPER_CNNS, cnn_apply, cnn_init
    from repro_torch.nn.tree import flatten_with_paths, tree_leaves, tree_to

    rows = []
    for name, cfg in PAPER_CNNS.items():
        params, bn = cnn_init(0, cfg, device="cpu")
        data = SyntheticImages(SyntheticImagesConfig(n_classes=cfg.n_classes, hw=cfg.input_hw,
                                                     channels=cfg.in_channels,
                                                     global_batch=batch, seed=2))
        x = torch.from_numpy(next(data)["images"])
        gp, gbn = tree_to(params, dev), tree_to(bn, dev)
        worst, ok = 0.0, True
        for train in (True, False):
            with torch.no_grad():
                cl, cbn = cnn_apply(params, bn, x, cfg, train=train)
                gl, g_bn = cnn_apply(gp, gbn, x.to(dev), cfg, train=train)
            pairs = [(gl, cl)] + [(a, b) for (_, a), (_, b) in
                                  zip(flatten_with_paths(g_bn), flatten_with_paths(cbn))]
            for a, b in pairs:
                a = a.cpu()
                worst = max(worst, (a - b).abs().max().item())
                ok = ok and bool(torch.allclose(a, b, **CNN_FWD_TOL))
            bn, gbn = cbn, g_bn  # eval reads the stats the train pass wrote
        row = {"phase": "cnn_parity", "arch": name, "params": sum(t.numel()
                                                                  for t in tree_leaves(params)),
               "input": [batch, cfg.input_hw, cfg.input_hw, cfg.in_channels],
               "n_classes": cfg.n_classes, "tol": CNN_FWD_TOL, "max_abs_err": worst,
               "finite": bool(np.isfinite(gl.cpu().numpy()).all()), "pass": ok}
        row["pass"] = ok and row["finite"]
        emit(row)
        rows.append(row)
        if not row["pass"]:
            raise Failed(f"cnn forward {name}: card and CPU disagree")
    return rows


def _cnn_recipe(torch, dev, cfg, *, seed: int, batch: int, snr: float, data_seed: int,
                float_steps: int = 120, symog_steps: int = 220):
    """tests/test_system.py's two stages: float pretrain (SGD-Nesterov,
    linear lr 0.02 -> 0.002 over the SYMOG steps), then SYMOG 2-bit finetune
    from the float weights; per-step launches and host ms of the SYMOG stage;
    the three accuracies on 10 held-out batches."""
    import numpy as np
    from repro_torch import core, optim
    from repro_torch.data import SyntheticImages, SyntheticImagesConfig
    from repro_torch.kernels.symog_update import ops as sops
    from repro_torch.models import cnn_init
    from repro_torch.nn.tree import tree_leaves, tree_map
    from repro_torch.train import CNNTrainState, make_cnn_eval, make_cnn_train_step

    data = SyntheticImages(SyntheticImagesConfig(n_classes=cfg.n_classes, hw=cfg.input_hw,
                                                 channels=cfg.in_channels, global_batch=batch,
                                                 snr=snr, seed=data_seed))
    params, bn = cnn_init(seed, cfg, device=dev)
    tx = optim.sgd(momentum=0.9, nesterov=True)
    lr = core.linear_lr(0.02, 0.002, symog_steps)
    step_f = make_cnn_train_step(cfg, tx, lr)
    st = CNNTrainState(params, bn, tx.init(params), None, 0)
    float_loss = []
    for _ in range(float_steps):
        st, m = step_f(st, next(data))
        float_loss.append(m["loss"])
    float_st = st
    scfg = core.SymogConfig(n_bits=2, total_steps=symog_steps)
    sst = core.symog_init(float_st.params, scfg)
    n_quant = sum(sst.mask.values())
    step_s = make_cnn_train_step(cfg, tx, lr, symog_cfg=scfg)
    p = tree_map(torch.clone, float_st.params)  # the fused route updates in place
    st2 = CNNTrainState(p, float_st.bn_state, tx.init(p), sst, 0)
    per_step, ms, losses = [], [], []
    zero_counts()
    for _ in range(symog_steps):
        before = sops.launches
        st2, m, wall = _timed_step(torch, step_s, st2, next(data))
        per_step.append(sops.launches - before)
        ms.append(wall)
        losses.append(m["loss"])
    counts = read_counts()
    ev = make_cnn_eval(cfg)

    def acc(params, bn_state):
        return float(np.mean([ev(params, bn_state, data.peek(50_000 + i)).item()
                              for i in range(10)]))

    naive_sst = core.symog_init(float_st.params, scfg)
    qm = core.quant_error_metrics(st2.params, sst, scfg)["rel_quant_error"].item()
    qm0 = core.quant_error_metrics(float_st.params, naive_sst, scfg)["rel_quant_error"].item()
    res = {"params": sum(t.numel() for t in tree_leaves(params)), "quantizable_leaves": n_quant,
           "batch": batch, "float_steps": float_steps, "symog_steps": symog_steps,
           "float_loss_last": float(float_loss[-1]), "symog_loss_last": float(losses[-1]),
           "losses_finite": bool(all(math.isfinite(float(x)) for x in float_loss + losses)),
           "launches_per_step": sorted(set(per_step)), "symog_update_launches":
               counts["symog_update"], "other_launches": {k: v for k, v in counts.items()
                                                          if k != "symog_update" and v},
           "step_ms_median": float(np.median(ms[1:])), "step_ms_first": ms[0],
           "rel_quant_error": qm, "rel_quant_error_float": qm0,
           "acc_float": acc(float_st.params, float_st.bn_state),
           "acc_symog_2bit": acc(core.quantize_tree(st2.params, sst, scfg), st2.bn_state),
           "acc_naive_postquant": acc(core.quantize_tree(float_st.params, naive_sst, scfg),
                                      float_st.bn_state)}
    res["launches_ok"] = (per_step == [n_quant] * symog_steps
                          and counts["symog_update"] == n_quant * symog_steps
                          and not res["other_launches"])
    return res, float_st, st2, sst, scfg, data, tx


def phase_cnn_lenet(torch, dev):
    """LeNet-5 under tests/test_system.py's recipe (batch 64, snr 0.6, data
    seed 1): the gates the JAX suite asserts, the accuracies printed."""
    from repro_torch import core
    from repro_torch.models import PAPER_CNNS
    from repro_torch.nn.tree import flatten_with_paths, tree_map
    from repro_torch.train import CNNTrainState, make_cnn_train_step

    import numpy as np

    cfg = PAPER_CNNS["lenet5"]
    res, float_st, st2, sst, scfg, data, tx = _cnn_recipe(torch, dev, cfg, seed=LENET_SEED,
                                                          batch=64, snr=0.6, data_seed=1)
    w, f = st2.params["conv2"]["kernel"], sst.f["conv2"]["kernel"]
    delta = float(core.delta_from_f(f))
    stats = core.mode_stats(w, delta, 2)
    counts, stds = stats["count"].cpu().tolist(), stats["std"].cpu().tolist()

    def switch_rate(clip: bool, steps=50):
        scfg_c = core.SymogConfig(n_bits=2, total_steps=200, clip=clip)
        s_c = core.symog_init(float_st.params, scfg_c)
        step = make_cnn_train_step(cfg, tx, core.constant(0.02), symog_cfg=scfg_c)
        p = tree_map(torch.clone, float_st.params)
        stc = CNNTrainState(p, float_st.bn_state, tx.init(p), s_c, 0)
        prev, rates = core.mode_tree(stc.params, s_c, scfg_c), []
        for _ in range(steps):
            stc, _ = step(stc, next(data))
            cur = core.mode_tree(stc.params, s_c, scfg_c)
            rates.append(np.mean([v.item() for _, v in
                                  flatten_with_paths(core.tree_switch_rates(prev, cur))]))
            prev = cur
        return float(np.mean(rates))

    rate_clip, rate_noclip = switch_rate(True), switch_rate(False)
    row = {"phase": "cnn_lenet5", "arch": "lenet5", "seed": LENET_SEED, **res,
           "conv2_delta": delta, "conv2_mode_counts": counts, "conv2_mode_std": stds,
           "switch_rate_clip": rate_clip, "switch_rate_noclip": rate_noclip,
           "gates": {"rel_quant_error<0.05": res["rel_quant_error"] < 0.05,
                     "10x_below_float": res["rel_quant_error_float"] > 10 * res[
                         "rel_quant_error"],
                     "trimodal": sum(counts) == w.numel() and all(c > 0 for c in counts),
                     "std<delta/8": all(x < delta / 8 for x in stds),
                     "clip_raises_switch_rate": rate_clip > rate_noclip}}
    row["pass"] = all(row["gates"].values()) and res["launches_ok"] and res["losses_finite"]
    emit(row)
    if not row["pass"]:
        raise Failed(f"LeNet-5 recipe failed: {row}")
    return row


def phase_cnn_vgg7(torch, dev, batch: int = 128):
    """VGG7 at full width on CIFAR-shaped synthetic images (32x32x3, 10
    classes, snr 0.6), the same two stages; timed and counted, not gated on
    accuracy."""
    from repro_torch.models import PAPER_CNNS

    res, *_ = _cnn_recipe(torch, dev, PAPER_CNNS["vgg7"], seed=0, batch=batch, snr=0.6,
                          data_seed=1)
    row = {"phase": "cnn_vgg7", "arch": "vgg7", "input": [batch, 32, 32, 3], **res}
    row["pass"] = res["launches_ok"] and res["losses_finite"]
    emit(row)
    if not row["pass"]:
        raise Failed(f"VGG7 recipe failed: {row}")
    return row


# ---------------------------------------------------------------------------
# phase 8: olmoe-1b-7b at full width (8 of its 16 layers), 2-bit packed with one Δ per
# expert, served from an int4 SYMOG KV pool
# ---------------------------------------------------------------------------
def phase_serve_olmoe(torch, dev):
    from repro_torch.serve import ServeEngine

    def expected(cfg, st, buckets):
        # every packed projection of every layer per decode step and per
        # prefill: q, k, v, o (+ the lm_head: M = 4 slots at decode, M = 1 at
        # prefill), the experts' gate, up, down
        L = cfg.n_layers
        return {**_matmul_counts(4 * L, 3 * L, st["decode_steps"], buckets, cfg, head=True),
                "paged_attention": 0,  # the pool is int4: every decode read is quantized
                "paged_attention_quant": cfg.n_layers * st["decode_steps"],
                **dict.fromkeys(MLA_COUNTS + PREFILL_COUNTS, 0), "symog_update": 0}

    row, eng, reqs, sc, tokens = phase_serve(torch, dev, "olmoe-1b-7b", "int4_fp", 17, expected,
                                             layers=SERVE_LAYERS["olmoe-1b-7b"])
    cfg = eng.cfg
    f_gate = eng.params["layers0"]["sub0"]["moe"]["experts"]["gate_proj"]["kernel"].f
    per_expert = tuple(f_gate.shape) == (cfg.n_layers, cfg.n_experts)
    again = [list(map(int, c.tokens)) for c in eng.serve(reqs, sc)]
    # the same requests from a bf16 pool of the same artifact: greedy agreement, no gate
    eng16 = ServeEngine(dataclasses.replace(cfg, kv_cache_dtype="bf16"), eng.params, max_len=512,
                        compute_dtype=torch.bfloat16, device=dev)
    comps16, sched16 = eng16.serve(reqs, sc, return_scheduler=True)
    same = total = 0
    for a, c in zip(tokens, comps16):
        same += sum(int(x == y) for x, y in zip(a, c.tokens))
        total += max(len(a), len(c.tokens))
    row.update({"per_expert_f": per_expert, "expert_f_range": [int(f_gate.min()), int(f_gate.max())],
                "kv_pool_bytes_bf16": sched16.cache_bytes(),
                "repeat_tokens_identical": again == tokens,
                "greedy_agreement_vs_bf16_pool": same / max(total, 1)})
    row["pass"] = row["pass"] and per_expert and again == tokens
    del eng16, sched16
    torch.cuda.empty_cache()
    return report(row), eng


# ---------------------------------------------------------------------------
# phase 3f: the absorbed MLA decode kernel (deepseek-v3's shape)
# ---------------------------------------------------------------------------
MLA_SHAPE = dict(B=4, H=128, r=512, rope=64, block=16, max_blocks=32)  # deepseek-v3 decode


def _mla_case(torch, gen, dev, *, B, H, r, rope, block, max_blocks, T, dt, pool, pos_zero,
              q_mult=None):
    """Operands over ~300 cached tokens a row.  ``pool``: 'float' (the
    compute dtype), 'kv_f' (int8 x 2^-5), 'q8'/'q4' (random SYMOG words under
    one exponent per physical block over [-8, 4]) or 'q8w'/'q4w' (the words a
    paged write makes of unit-scale c_kv / k_rope: N(0,1) x 2^s, s in
    [-3, 1] per block, exponents from each block's first token).
    ``pos_zero``: row 0 starts at position 0.  ``q_mult``: the queries'
    scale (default: 1, or 1 / the pool's largest value for 'q8'/'q4')."""
    from repro_torch.models.attention import KV_QMAX, block_scale_exp, pack_int4, quantize_fixed

    n_phys = B * max_blocks + 1
    perm = torch.randperm(n_phys - 1, generator=gen, device=dev)[: B * max_blocks] + 1
    bt = perm.reshape(B, max_blocks).to(torch.int32)
    pos0 = (torch.randint(280, 320, (B,), generator=gen, device=dev) - (T - 1)).to(torch.int32)
    if pos_zero:
        pos0[0] = 0
    # queries scaled by the pool's largest value for the wide spread, so that
    # logits stay O(1) as in serving: with |c_kv| up to 127 x 2^4 and unit
    # queries the logits reach ~1e3, where fp32 summation order alone moves
    # a near-tied softmax (checked against fp64 below)
    if q_mult is None:
        q_mult = 1.0 / (KV_QMAX[4 if pool == "q4" else 8] * 2**4) if pool in ("q8", "q4") else 1.0
    q_eff = (torch.randn((B, T, H, r), generator=gen, device=dev) * q_mult).to(dt)
    q_rope = (torch.randn((B, T, H, rope), generator=gen, device=dev) * q_mult).to(dt)
    kw = dict(scale=(128 + 64) ** -0.5)  # deepseek-v3: (qk_nope + qk_rope)^-0.5
    pools, exps = [], []
    for w in (r, rope):
        x = torch.randn((n_phys, block, w), generator=gen, device=dev)
        if pool == "float":
            pools.append(x.to(dt))
        elif pool == "kv_f":
            pools.append(torch.clamp(torch.round(x * 0.5 * 32), -127, 127).to(torch.int8))
        else:
            bits = 4 if pool.startswith("q4") else 8
            qmax = KV_QMAX[bits]
            if pool.endswith("w"):
                s = torch.randint(-3, 2, (n_phys, 1, 1), generator=gen, device=dev).float()
                x = x * torch.exp2(s)
                e = block_scale_exp(x[:, 0], qmax)
                m = quantize_fixed(x, e[:, None], qmax)
            else:
                m = torch.randint(-qmax, qmax + 1, (n_phys, block, w), generator=gen,
                                  device=dev).to(torch.int8)
                e = torch.randint(-8, 5, (n_phys,), generator=gen, device=dev).to(torch.int32)
            pools.append(pack_int4(m) if bits == 4 else m)
            exps.append(e)
    if pool == "kv_f":
        kw["kv_scale"] = 2.0**-5
    elif exps:
        kw.update(ckv_scale_exp=exps[0], kr_scale_exp=exps[1],
                  kv_bits=4 if pool.startswith("q4") else 8)
    return q_eff, q_rope, pools[0], pools[1], bt, pos0, kw, q_mult


def _mla_ref64(qe, qr, cp, kp, bt, pos0, *, scale, ckv_scale_exp, kr_scale_exp, kv_bits):
    """``paged_attention_mla_ref`` of a quantized pool in fp64 (float64 for
    the conditioning check only)."""
    import torch

    from repro_torch.kernels.paged_attention.ref import dequant_logical

    c = dequant_logical(cp, ckv_scale_exp, bt, kv_bits=kv_bits).double()
    k = dequant_logical(kp, kr_scale_exp, bt, kv_bits=kv_bits).double()
    T, S = qe.shape[1], c.shape[1]
    q_pos = pos0.long()[:, None] + torch.arange(T, device=qe.device)[None]
    mask = torch.arange(S, device=qe.device)[None, None, None] <= q_pos[:, None, :, None]
    lg = (torch.einsum("bthr,bsr->bhts", qe.double(), c)
          + torch.einsum("bthr,bsr->bhts", qr.double(), k)) * scale
    lg = torch.where(mask, lg, torch.full_like(lg, -1e30))
    return torch.einsum("bhts,bsr->bthr", torch.softmax(lg, dim=-1), c)


def phase_attn_mla(torch, dev):
    """Rows 4 and 5 at deepseek-v3's decode shape (B 4, T 1, 128 heads, r
    512, rope 64, block 16, ~300 tokens a row), also T = 3 with a row at
    position 0: bf16 queries on every pool code, the SYMOG ones with the
    wide exponent spread (queries scaled to O(1) logits), at the bf16 bar,
    through both kernels (forced: the tensor-core ``mla_decode_tc`` and
    ``mla_partial``), each bit-identical over two calls; the rule sends
    every bf16 case to the tensor cores, which must be faster there.  fp32
    queries on float / KV_F pools and on the words a paged write makes at
    the fp32 bar (as phase 3e), on ``mla_partial`` (the rule's choice).
    Then the conditioning check of the wide int8 spread at unit queries
    against fp64."""
    import torch.nn.functional as F
    from repro_torch.kernels import build
    from repro_torch.kernels.paged_attention import ops as aops
    from repro_torch.kernels.paged_attention.ref import (dequant_logical, gather_logical,
                                                         paged_attention_mla_ref)

    gen = torch.Generator(device=dev)
    gen.manual_seed(8)
    sh = MLA_SHAPE
    B, H, r, rope, block = sh["B"], sh["H"], sh["r"], sh["rope"], sh["block"]
    bf, f32 = torch.bfloat16, torch.float32
    cases = [(1, bf, "float", False), (1, bf, "q4", False), (1, bf, "q8", False),
             (1, bf, "kv_f", False), (3, bf, "q4", True), (3, bf, "float", True),
             (3, bf, "q8", True), (3, bf, "kv_f", True),
             (1, f32, "float", False), (1, f32, "kv_f", False), (1, f32, "q8w", False),
             (1, f32, "q4w", False), (3, f32, "q4w", True), (3, f32, "float", True),
             # the speculative verify's shape, T = k + 1 = 5 (no eligible serve:
             # deepseek is MoE; the kernel case alone)
             (VERIFY_T, bf, "float", False), (VERIFY_T, bf, "q4", False)]
    rows, main = [], {}
    worst = dict.fromkeys(("partial_float", "partial_quant", "tc_float", "tc_quant"), 0.0)
    for T, dt, pool, pos_zero in cases:
        dname = str(dt).split(".")[-1]
        qe, qr, cp, kp, bt, pos0, kw, q_mult = _mla_case(torch, gen, dev, T=T, dt=dt, pool=pool,
                                                         pos_zero=pos_zero, **sh)
        quant = "kv_bits" in kw
        kind = "quant" if quant else "float"
        rule = aops._mla_route(dt, cp.dtype, kw.get("kv_bits", 0), kw.get("kv_scale", 1.0), r,
                               rope)
        ref = paged_attention_mla_ref(qe, qr, cp, kp, bt, pos0, **kw)
        tol = ATTN_TOL[dname]
        # bytes this run's data needs: q in, out, and each visible block's
        # c_kv and k_rope words (and exponents) once; operations: every query
        # row against every visible key, logits over r + rope and p . c_kv over r
        vis_blocks = ((pos0.long() + T - 1) // block + 1).sum().item()
        blk_bytes = block * (cp.shape[-1] + kp.shape[-1]) * cp.element_size() + (8 if quant else 0)
        io = (2 * qe.numel() + qr.numel()) * qe.element_size() + vis_blocks * blk_bytes \
            + bt.numel() * 4 + B * 4
        keys = (pos0.long()[:, None] + torch.arange(T, device=dev)[None] + 1).sum().item()
        flops = keys * H * 2 * (2 * r + rope)
        b_ms, b_by = bound(io, flops, dname)
        n = copies_for(cp.numel() * cp.element_size() + kp.numel() * kp.element_size())
        qk = ("ckv_scale_exp", "kr_scale_exp")
        args = [(cp.clone(), kp.clone()) + tuple(kw[k].clone() for k in qk if k in kw)
                for _ in range(n)]
        rest = {k: v for k, v in kw.items() if k not in qk}

        def call(fn, **extra):
            return lambda c, k, *e: fn(qe, qr, c, k, bt, pos0, **rest, **dict(zip(qk, e)),
                                       **extra)

        row = {"phase": "kernel", "kernel": "paged_attention_mla" + ("_quant" if quant else ""),
               "B": B, "T": T, "H": H, "r": r, "rope": rope, "block": block, "pool": pool,
               "pool_dtype": str(cp.dtype).split(".")[-1], "q_dtype": dname,
               "row_at_position_0": pos_zero, "q_mult": q_mult, "route": rule, "tol": tol}
        if quant:
            e_all = torch.cat([kw["ckv_scale_exp"], kw["kr_scale_exp"]])
            row["exp_range"] = [int(e_all.min()), int(e_all.max())]
        # each route that takes the call: launched once, counted under its
        # route, within the bar, the same bits on a second call
        ok = True
        for route in (["tc", "partial"] if rule == "tc" else ["partial"]):
            zero_counts()
            out = aops.paged_attention_mla(qe, qr, cp, kp, bt, pos0, **kw, _route=route)
            again = aops.paged_attention_mla(qe, qr, cp, kp, bt, pos0, **kw, _route=route)
            torch.cuda.synchronize()
            got = {k: v for k, v in read_counts().items() if k in MLA_COUNTS and v}
            fam = "paged_attention_mla" + ("_quant" if quant else "")
            want = {fam: 2}
            if route == "tc":
                want["paged_attention_mla_tc" + ("_quant" if quant else "")] = 2
            err = (out.float() - ref.float()).abs().max().item()
            same = bool(torch.equal(out, again))
            r_ok = (bool(torch.allclose(out.float(), ref.float(), **tol)) and got == want
                    and same and out.dtype == dt)
            ok = ok and r_ok
            row[f"{route}_max_abs_err"] = err
            row[f"{route}_bit_identical"] = same
            row[f"{route}_ms"] = timed(call(aops.paged_attention_mla, _route=route), args, torch)
            worst[f"{route}_{kind}"] = max(worst[f"{route}_{kind}"], err)
            if not r_ok:
                row["launches"] = got
        row["max_abs_err"] = row[f"{rule}_max_abs_err"]
        row["ms"] = row[f"{rule}_ms"]
        if rule == "tc":  # the rule's ranks beside 4 and 8 (one cluster each)
            auto = aops._mla_tc_split(B, -(-T * H // aops.MLA_TC_ROWS), bt.shape[1], block,
                                      build.sm_count(dev))
            row["tc_split"] = auto
            row["tc_ms_by_split"] = {s: timed(call(aops.paged_attention_mla, _route="tc",
                                                   _split=s), args, torch)
                                     for s in sorted({4, 8} - {auto})}
            row["tc_faster_than_partial"] = row["tc_ms"] < row["partial_ms"]
            ok = ok and row["tc_faster_than_partial"]
        row["pass"] = ok
        row["plain_ms"] = timed(call(paged_attention_mla_ref), args, torch)
        # library yardstick: SDPA over the gathered (dequantized) cache, one
        # shared key / value head against the H query heads; timed only
        if quant:
            cl = dequant_logical(cp, kw["ckv_scale_exp"], bt, kv_bits=kw["kv_bits"]).to(dt)
            kl = dequant_logical(kp, kw["kr_scale_exp"], bt, kv_bits=kw["kv_bits"]).to(dt)
        else:
            scl = kw.get("kv_scale", 1.0)
            cl = (gather_logical(cp, bt).float() * scl).to(dt)
            kl = (gather_logical(kp, bt).float() * scl).to(dt)
        S = cl.shape[1]
        q_pos = pos0.long()[:, None] + torch.arange(T, device=dev)[None]
        mask = (torch.arange(S, device=dev)[None, None] <= q_pos[:, :, None])[:, None]
        qs = torch.cat([qe, qr], dim=-1).transpose(1, 2)  # (B, H, T, r + rope)
        ks = torch.cat([cl, kl], dim=-1)[:, None]  # (B, 1, S, r + rope)
        vs = cl[:, None]  # (B, 1, S, r)
        nl = copies_for(ks.numel() * ks.element_size() * 2)
        largs = [(qs, ks.clone(), vs.clone()) for _ in range(nl)]
        row["library_ms"] = timed(lambda a, b, c: F.scaled_dot_product_attention(
            a, b, c, attn_mask=mask, scale=kw["scale"], enable_gqa=True), largs, torch)
        row["bound_ms"], row["bound_by"] = b_ms, b_by
        row["achieved_GFLOPs"] = flops / (row["ms"] * 1e-3) / 1e9
        del args, largs
        emit(row)
        rows.append(row)
        if T == 1 and dt == bf and pool in ("float", "q4") and kind not in main:
            main[kind] = row
        if not ok:
            raise Failed(f"{row['kernel']} case T={T} {dname} {pool}: {row}")
    # conditioning: the wide int8 spread with unit queries (logits ~1e3): the
    # kernel and the fp32 plain version each against fp64; the kernel's error
    # may not exceed twice the plain version's
    qe, qr, cp, kp, bt, pos0, kw, _ = _mla_case(torch, gen, dev, T=1, dt=f32, pool="q8",
                                                pos_zero=False, q_mult=1.0, **sh)
    r64 = _mla_ref64(qe, qr, cp, kp, bt, pos0, **kw)
    k_err = (aops.paged_attention_mla(qe, qr, cp, kp, bt, pos0, **kw).double() - r64).abs().max()
    p_err = (paged_attention_mla_ref(qe, qr, cp, kp, bt, pos0, **kw).double() - r64).abs().max()
    row = {"phase": "kernel", "kernel": "paged_attention_mla_quant", "check": "conditioning",
           "pool": "q8", "q_dtype": "float32", "q_mult": 1.0,
           "kernel_max_abs_err_vs_fp64": k_err.item(), "plain_max_abs_err_vs_fp64": p_err.item(),
           "out_max_abs": r64.abs().max().item(), "pass": bool(k_err <= 2 * p_err)}
    emit(row)
    rows.append(row)
    if not row["pass"]:
        raise Failed(f"paged_attention_mla_quant conditioning check: {row}")
    return rows, worst, main


# ---------------------------------------------------------------------------
# phase 9: deepseek-v3 at full width, 5 layers (3 dense + 2 MoE), 2-bit
# packed with one Δ per (layer, expert), served from an int4 MLA pool
# ---------------------------------------------------------------------------
DEEPSEEK = "deepseek-v3-671b"
DEEPSEEK_LAYERS = 5  # the 3 leading dense layers and 2 MoE layers (a depth cut)


def build_layerwise(torch, dev, cfg, seed: int):
    """The 2-bit SYMOG artifact of ``cfg`` built one layer at a time: each
    layer is drawn on the card (``block_init``), gets its own Δ per leaf
    (per expert on the routed stacks) from ``symog_init``, is packed by
    ``pack_tree`` and freed, and its packed leaves are copied into the
    group's stacked leaves.  Peak: one layer's fp32 weights (46 GB for a
    deepseek-v3 MoE layer) beside what is packed so far; the whole fp32
    tree (198.5 GB at 7 layers) never exists.  The embedding, final norm
    and head come from ``init_lm`` at zero layers; the MTP module, which
    serving does not read, is left out.  Returns (artifact, parameter
    count, seconds by step)."""
    from repro_torch.core import Packed, SymogConfig, pack_tree, symog_init
    from repro_torch.models import init_lm, scan_groups
    from repro_torch.models.blocks import block_init
    from repro_torch.nn.tree import tree_leaves, tree_map

    scfg = SymogConfig(n_bits=2)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    secs = {"init_s": 0.0, "symog_init_s": 0.0, "pack_s": 0.0}
    n_params = 0

    def pack_part(make):
        nonlocal n_params
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        part = make()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        n_params += sum(t.numel() for t in tree_leaves(part))
        st = symog_init(part, scfg)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        packed = pack_tree(part, st, scfg)
        del part, st
        torch.cuda.synchronize()
        secs["init_s"] += t1 - t0
        secs["symog_init_s"] += t2 - t1
        secs["pack_s"] += time.perf_counter() - t2
        return packed

    top = dataclasses.replace(cfg, n_layers=0, use_mtp=False)
    tree = pack_part(lambda: init_lm(gen, top, device=dev))
    for g in scan_groups(cfg):
        stacked = None
        for i in range(g.count):
            layer = pack_part(lambda: block_init(gen, cfg, g.unit[0]))
            if not g.stacked:
                stacked = layer
                break
            if stacked is None:  # the group's leaves, filled layer by layer
                stacked = tree_map(
                    lambda x: Packed(x.data.new_empty((g.count,) + tuple(x.data.shape)),
                                     x.n_bits, x.f.new_empty((g.count,) + tuple(x.f.shape)))
                    if isinstance(x, Packed) else x.new_empty((g.count,) + tuple(x.shape)),
                    layer)

            def put(dst, src, i=i):
                if isinstance(src, Packed):
                    dst.data[i] = src.data
                    dst.f[i] = src.f
                else:
                    dst[i] = src

            tree_map(put, stacked, layer)
            del layer
        tree[g.name] = {"sub0": stacked}
        torch.cuda.empty_cache()
    return tree, n_params, secs


def _probe_first_decode(torch, eng):
    """Have the engine's first decode step keep what it reads: the logits of
    every active row and, per layer, the cached c_kv / k_rope as its pool
    holds them before the step writes (dequantized to fp32, the rows'
    valid positions only).  The step runs ``decode_lm`` once, as the
    engine's own step does.  Returns (box, restore)."""
    from repro_torch.kernels.paged_attention.ref import dequant_logical, gather_logical
    from repro_torch.models import decode_lm
    from repro_torch.serve.engine import _greedy

    fns = eng.scheduler_fns(greedy=True, top_k=0)
    inner = fns.decode_step
    box = {"c_kv": [], "k_rope": []}

    def step(params, caches, tokens, pos, active, seed0, bt, *sample):
        if "logits" in box:
            return inner(params, caches, tokens, pos, active, seed0, bt, *sample)
        rows = active.nonzero()[:, 0]
        S = int(pos[rows].max())
        valid = torch.arange(S, device=pos.device)[None] < pos[rows, None]
        for g in sorted(caches):
            sub = caches[g]["sub0"]
            for n in box:
                pool = sub[n]
                stacked = pool.dim() == 4
                for i in range(pool.shape[0] if stacked else 1):
                    p = pool[i] if stacked else pool
                    if n + "_scale" in sub:
                        e = sub[n + "_scale"][i] if stacked else sub[n + "_scale"]
                        v = dequant_logical(p, e, bt[rows], kv_bits=eng.kv_quant_bits)
                    else:
                        v = gather_logical(p, bt[rows]).float()
                    box[n].append(v[:, :S][valid])
        logits, caches = decode_lm(params, caches, tokens[:, None], pos, eng.cfg,
                                   compute_dtype=eng.compute_dtype, active=active,
                                   block_tables=bt)
        box["logits"] = logits[rows, -1].float()
        return _greedy(logits[:, -1, :]), pos + active.to(torch.int32), caches

    fns.decode_step = step
    return box, lambda: setattr(fns, "decode_step", inner)


def _first_step_gap(torch, box4, box16):
    """The int4 and bf16 pools at the first decode step, where both serves
    hold the same prompts and feed the same tokens: per active row the
    bf16 pool's top-1 - top-2 logit margin beside the largest logit gap
    between the pools (a greedy token flips only where the gap reaches the
    margin), the logit spread, and the int4 pool's error against the bf16
    pool's values (RMS error over RMS value, and the largest error)."""
    a, b = box16["logits"], box4["logits"]
    top2 = a.topk(2, dim=-1).values
    out = {"rows": int(a.shape[0]),
           "top1_minus_top2_bf16_pool": (top2[:, 0] - top2[:, 1]).tolist(),
           "max_abs_logit_gap": (a - b).abs().max(-1).values.tolist(),
           "argmax_differs": (a.argmax(-1) != b.argmax(-1)).tolist(),
           "logit_std_bf16_pool": a.std(-1).tolist()}
    for n in ("c_kv", "k_rope"):
        ref, q = torch.cat(box16[n]), torch.cat(box4[n])
        d = q - ref
        out[f"{n}_int4_rel_rms_err"] = (d.square().mean().sqrt()
                                        / ref.square().mean().sqrt()).item()
        out[f"{n}_int4_max_abs_err"] = d.abs().max().item()
        out[f"{n}_max_abs_value"] = ref.abs().max().item()
    return out


def phase_serve_deepseek(torch, dev):
    from repro_torch.serve import ServeEngine

    def expected(cfg, st, buckets):
        # per MLA layer: q_a, q_b, kv_a, k_rope, kv_b_k, kv_b_v and o at prefill;
        # at decode kv_b_k / kv_b_v are absorbed through as_dense (no kernel);
        # per layer also the dense MLP's or the shared expert's 3; + the head
        # (M = 4 slots at decode, M = 1 at prefill)
        L, n_moe = cfg.n_layers, cfg.n_layers - cfg.n_dense_layers
        return {**_matmul_counts(10 * L, 3 * n_moe, st["decode_steps"], buckets, cfg,
                                 head=True, decode_2d=8 * L),
                "paged_attention": 0, "paged_attention_quant": 0,
                **dict.fromkeys(PREFILL_COUNTS, 0),
                # the pool is int4: every decode read is quantized, each on the
                # tensor-core kernel (bf16 queries), one launch a call
                "paged_attention_mla": 0, "paged_attention_mla_tc": 0,
                "paged_attention_mla_quant": L * st["decode_steps"],
                "paged_attention_mla_tc_quant": L * st["decode_steps"], "symog_update": 0}

    row, eng, reqs, sc, tokens = phase_serve(
        torch, dev, DEEPSEEK, "int4_fp", 23, expected, layers=DEEPSEEK_LAYERS,
        build=lambda cfg, seed: build_layerwise(torch, dev, cfg, seed))
    cfg = eng.cfg
    moe = eng.params["layers1"]["sub0"]["moe"]
    f_gate = moe["experts"]["gate_proj"]["kernel"].f
    n_moe = cfg.n_layers - cfg.n_dense_layers
    per_expert = (tuple(f_gate.shape) == (n_moe, cfg.n_experts)
                  and tuple(moe["shared"]["gate_proj"]["kernel"].f.shape) == (n_moe,))
    box4, restore = _probe_first_decode(torch, eng)
    again = [list(map(int, c.tokens)) for c in eng.serve(reqs, sc)]
    restore()
    # the same requests from a bf16 MLA pool of the same artifact: the float
    # kernel on every decode read (counts gated), greedy agreement printed
    eng16 = ServeEngine(dataclasses.replace(cfg, kv_cache_dtype="bf16"), eng.params, max_len=512,
                        compute_dtype=torch.bfloat16, device=dev)
    box16, restore16 = _probe_first_decode(torch, eng16)
    adm16, restore_adm16 = _record_admissions(torch, eng16.scheduler_fns(greedy=True, top_k=0))
    zero_counts()
    comps16, sched16 = eng16.serve(reqs, sc, return_scheduler=True)
    torch.cuda.synchronize()
    counts16 = read_counts()
    restore16()
    restore_adm16()
    first_step = _first_step_gap(torch, box4, box16)
    del box4, box16
    steps16 = sched16.stats["decode_steps"]
    want16 = dict(expected(cfg, sched16.stats, adm16["buckets"]),
                  paged_attention_mla=cfg.n_layers * steps16,
                  paged_attention_mla_tc=cfg.n_layers * steps16,
                  paged_attention_mla_quant=0, paged_attention_mla_tc_quant=0)
    same = total = 0
    for a, c in zip(tokens, comps16):
        same += sum(int(x == y) for x, y in zip(a, c.tokens))
        total += max(len(a), len(c.tokens))
    row.update({"per_expert_f": per_expert,
                "expert_f_range": [int(f_gate.min()), int(f_gate.max())],
                "kv_pool_bytes_bf16": sched16.cache_bytes(),
                "kv_bytes_per_token_layer": {"bf16": 2 * (cfg.kv_lora_rank + cfg.qk_rope_dim),
                                             "int4": (cfg.kv_lora_rank + cfg.qk_rope_dim) // 2},
                "repeat_tokens_identical": again == tokens,
                "greedy_agreement_vs_bf16_pool": same / max(total, 1),
                "first_decode_step_vs_bf16_pool": first_step,
                "bf16_pool_launches": counts16, "bf16_pool_expected_launches": want16})
    row["pass"] = row["pass"] and per_expert and again == tokens and counts16 == want16
    del eng16, sched16
    torch.cuda.empty_cache()
    return report(row), eng


# ---------------------------------------------------------------------------
# phase 10: gemma3-4b at full width and depth, 2-bit packed, served from an
# int4 SYMOG KV pool through the tail-prefill admission, greedy and sampled
# ---------------------------------------------------------------------------
# prompt lengths: buckets 32..2048, and the 1,024-token window of the local
# layers binds in admission and in decode for the two longest
GEMMA3_LENS = [400, 24, 1800, 100, 900, 1300, 50, 200]
GEMMA3_MAX_LEN = 2048
GEMMA3_SAMPLING = dict(temperature=0.7, top_k=50, seed=123)


def phase_serve_gemma3(torch, dev):
    from repro_torch.models.layers import embed_logits
    from repro_torch.serve import ServeConfig, ServeEngine

    def expected(cfg, st, buckets):
        # every packed projection of every layer once per decode step and once
        # per admission (the tied head dequantizes the table: no kernel); the
        # int4 pool's kernel once per layer and decode step and once per
        # layer and admission (the tail prefill attends the pool, on the
        # tensor-core prefill kernel where the rule sends its bucket)
        L = cfg.n_layers
        return {**_matmul_counts(7 * L, 0, st["decode_steps"], buckets),
                "paged_attention": 0,
                "paged_attention_quant": L * (st["decode_steps"] + len(buckets)),
                "paged_attention_prefill": 0,
                "paged_attention_prefill_quant": L * _prefill_route_calls(cfg, buckets, 4),
                **dict.fromkeys(MLA_COUNTS, 0), "symog_update": 0}

    row, eng, reqs, sc, tokens = phase_serve(torch, dev, "gemma3-4b", "int4_fp", 29, expected,
                                             layers=SERVE_LAYERS["gemma3-4b"],
                                             max_len=GEMMA3_MAX_LEN, lens=GEMMA3_LENS)
    cfg = eng.cfg
    L = cfg.n_layers
    row["tail_prefill_launches"] = L * row["prefills"]
    row["tail_prefill_launches_by_route"] = {
        "prefill": row["launches"]["paged_attention_prefill_quant"],
        "decode": L * row["prefills"] - row["launches"]["paged_attention_prefill_quant"]}
    again = [list(map(int, c.tokens)) for c in eng.serve(reqs, sc)]

    def streams(rs, n_slots):
        return [list(map(int, c.tokens)) for c in eng.serve(
            rs, ServeConfig(n_slots=n_slots, block_size=16, **GEMMA3_SAMPLING))]

    t0 = time.perf_counter()
    sampled = {"4_slots": streams(reqs, 4), "4_slots_again": streams(reqs, 4),
               "3_slots": streams(reqs, 3),
               "staggered": streams([dataclasses.replace(r, arrival=4 * i)
                                     for i, r in enumerate(reqs)], 4)}
    sampled_s = time.perf_counter() - t0
    base = sampled["4_slots"]
    sampled_same = all(v == base for v in sampled.values())
    # the same requests from a bf16 pool of the same artifact: bucketed
    # admissions, the float kernel on every decode read (counts gated)
    eng16 = ServeEngine(dataclasses.replace(cfg, kv_cache_dtype="bf16"), eng.params,
                        max_len=GEMMA3_MAX_LEN, compute_dtype=torch.bfloat16, device=dev)
    adm16, restore_adm16 = _record_admissions(torch, eng16.scheduler_fns(greedy=True, top_k=0))
    zero_counts()
    comps16, sched16 = eng16.serve(reqs, sc, return_scheduler=True)
    torch.cuda.synchronize()
    counts16 = read_counts()
    restore_adm16()
    steps16 = sched16.stats["decode_steps"]
    want16 = dict(expected(cfg, sched16.stats, adm16["buckets"]),
                  paged_attention=L * steps16, paged_attention_quant=0,
                  paged_attention_prefill_quant=0)
    same = total = 0
    for a, c in zip(tokens, comps16):
        same += sum(int(x == y) for x, y in zip(a, c.tokens))
        total += max(len(a), len(c.tokens))
    h = torch.randn((4, 1, cfg.d_model), device=dev, dtype=torch.bfloat16)
    row.update({"windows_binding": sum(int(n) > cfg.window for n in GEMMA3_LENS),
                "repeat_tokens_identical": again == tokens,
                "sampling": GEMMA3_SAMPLING, "sampled_runs_s": sampled_s,
                "sampled_streams_identical": {k: v == base for k, v in sampled.items()},
                "sampled_differs_from_greedy": base != tokens,
                "kv_pool_bytes_bf16": sched16.cache_bytes(),
                "bf16_pool_prefill_ms": [[b, ms] for b, ms in zip(adm16["buckets"],
                                                                  adm16["ms"])],
                "greedy_agreement_vs_bf16_pool": same / max(total, 1),
                "bf16_pool_launches": counts16, "bf16_pool_expected_launches": want16,
                # the tied 262,144-row read-out as the serve runs it: the
                # packed table dequantized to fp32, then torch.matmul
                "head_dequant_matmul_ms": events_ms(lambda: embed_logits(eng.params["embed"], h),
                                                    5, torch),
                "head_dequant_matmul_ms_rows_unpadded": _unpadded(lambda: events_ms(
                    lambda: embed_logits(eng.params["embed"], h), 5, torch))})
    row["pass"] = (row["pass"] and again == tokens and sampled_same and base != tokens
                   and counts16 == want16)
    del eng16, sched16
    torch.cuda.empty_cache()
    return report(row), eng


# ---------------------------------------------------------------------------
# phase 11: the prefix cache with copy-on-write, chunked prefill and
# self-speculative decoding on the fully-paged tier
# ---------------------------------------------------------------------------
PREFIX_TOKENS = 1000  # = 62 blocks of 16 + 8 tokens: every hit ends inside a block
PREFIX_CHUNK = 256


def _prefix_requests(cfg, seed: int, n: int = 8, new_tokens: int = 32):
    """``n`` requests of one shared ``PREFIX_TOKENS``-token system prefix
    plus each its own tail of 24..400 tokens, from ``seed``."""
    import numpy as np
    from repro_torch.serve import Request

    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, cfg.vocab_size, size=PREFIX_TOKENS)
    tails = rng.integers(24, 401, size=n)
    return [Request(tokens=np.concatenate([prefix, rng.integers(0, cfg.vocab_size, size=int(t))]),
                    max_new_tokens=new_tokens) for t in tails]


def _expected_prefix_admissions(comps, lens, prefix: bool, chunk: int):
    """What the arrival order implies, per request in admission order: the
    tokens a prefix hit reuses (``PREFIX_TOKENS`` once an earlier prompt's
    blocks are indexed: a one-shot admission indexes at its own step, before
    later admissions of that step; a chunked one after its final chunk, so
    from the next step) and the chunks its tail takes."""
    order = sorted(range(len(comps)), key=lambda i: (comps[i].admitted_step, i))
    indexed_at = []  # the step from which each admitted prompt is indexed
    hits, chunks = {}, {}
    for i in order:
        adm = comps[i].admitted_step
        hit = PREFIX_TOKENS if prefix and any(s <= adm for s in indexed_at) else 0
        tail = lens[i] - hit
        chunked = bool(chunk) and tail > chunk
        hits[i], chunks[i] = hit, (-(-tail // chunk) if chunked else 0)
        indexed_at.append(comps[i].first_token_step + 1 if chunked else adm)
    return hits, chunks


def phase_prefix_chunks(torch, dev, eng):
    """11a: phase 10's full-width 2-bit gemma3-4b over its int4 pool (max_len
    2048), 4 slots, block 16, 8 requests of a shared 1,000-token prefix plus
    a 24..400-token tail, 32 new tokens each, served four ways: plain, with
    the prefix cache, in chunks of 256, and both; each way twice.  Gates:
    hits, hit tokens, copies on write and chunks as the arrival order
    implies; every kernel's launches by route (row 3 once a layer per
    tail-prefill call, chunk and decode step); a repeat token-identical.
    Reported: greedy agreement with the plain serve, admission seconds, ms a
    chunk, pool blocks."""
    import numpy as np
    from repro_torch.serve import ServeConfig, latency_stats

    cfg = eng.cfg
    L = cfg.n_layers
    reqs = _prefix_requests(cfg, 31)
    lens = [len(r.tokens) for r in reqs]
    fns = eng.scheduler_fns(greedy=True, top_k=0)
    ways = {"plain": {}, "prefix_cache": dict(prefix_cache=True),
            "chunked": dict(prefill_chunk=PREFIX_CHUNK),
            "prefix_cache_and_chunked": dict(prefix_cache=True, prefill_chunk=PREFIX_CHUNK)}
    rows, base = {}, None
    for name, kw in ways.items():
        sc = ServeConfig(n_slots=4, block_size=16, **kw)
        runs = []
        for _ in range(2):
            adm, restore = _record_admissions(torch, fns)
            zero_counts()
            t0 = time.perf_counter()
            comps, sched = eng.serve(reqs, sc, return_scheduler=True)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = read_counts()
            restore()
            runs.append((comps, sched, adm, counts, wall))
        comps, sched, adm, counts, wall = runs[0]
        st = sched.stats
        tokens = [list(map(int, c.tokens)) for c in comps]
        if base is None:
            base = tokens
        hits, chunks = _expected_prefix_admissions(comps, lens, bool(kw.get("prefix_cache")),
                                                   kw.get("prefill_chunk", 0))
        n_hits = sum(1 for h in hits.values() if h)
        n_chunked = sum(1 for c in chunks.values() if c)
        want_stats = {"prefix_hits": n_hits, "prefix_hit_tokens": sum(hits.values()),
                      "prefix_cow_copies": n_hits * int(PREFIX_TOKENS % 16 != 0),
                      "prefix_misses": len(reqs) - n_hits if kw.get("prefix_cache") else 0,
                      "chunked_admissions": n_chunked, "prefill_chunks": sum(chunks.values()),
                      "prefills": len(reqs)}
        got_stats = {k: st[k] for k in want_stats}
        # one tail-prefill call per one-shot admission and per chunk, each
        # launching row 3 once a layer, the matmuls at M = its bucket
        calls = len(reqs) - n_chunked + st["prefill_chunks"]
        want = {**_matmul_counts(7 * L, 0, st["decode_steps"], adm["buckets"]),
                "paged_attention": 0,
                "paged_attention_quant": L * (st["decode_steps"] + calls),
                "paged_attention_prefill": 0,
                "paged_attention_prefill_quant": L * _prefill_route_calls(cfg, adm["buckets"],
                                                                          4),
                **dict.fromkeys(MLA_COUNTS, 0), "symog_update": 0}
        same = total = 0
        for a, b in zip(base, tokens):
            same += sum(int(x == y) for x, y in zip(a, b))
            total += max(len(a), len(b))
        occ = sched.pool.occupancy()
        row = {"phase": "prefix_chunks", "arch": cfg.name,
               "way": name, "layers": L, "kv_cache_dtype": cfg.kv_cache_dtype,
               "prompt_lens": lens, "shared_prefix": PREFIX_TOKENS, "new_tokens": 32,
               "stats": got_stats, "expected_stats": want_stats,
               "hit_tokens_by_request": [hits[i] for i in range(len(reqs))],
               "decode_steps": st["decode_steps"], "prefill_only_steps": st["prefill_only_steps"],
               "tail_prefill_calls": calls, "wall_s": wall,
               "prefill_s": sum(adm["ms"]) / 1e3,
               "prefill_ms": [[b, ms] for b, ms in zip(adm["buckets"], adm["ms"])],
               "ms_per_tail_call_mean": float(np.mean(adm["ms"])),
               "ttft_steps": latency_stats(comps)["ttft_steps"],
               "pool_blocks_allocated": occ["total_allocs"], "pool_peak_live_blocks":
               occ["peak_live"], "greedy_agreement_vs_plain": same / max(total, 1),
               "repeat_tokens_identical": all([list(map(int, c.tokens)) for c in r[0]] == tokens
                                              for r in runs[1:]),
               "launches": counts, "expected_launches": want}
        row["pass"] = (got_stats == want_stats and counts == want
                       and row["repeat_tokens_identical"]
                       and all(runs[1][1].stats[k] == st[k] for k in want_stats))
        emit(row)
        rows[name] = row
        if not row["pass"]:
            raise Failed(f"prefix_chunks {name}: {row}")
        del runs, comps, sched
    return rows


def _capture_admission_logits(torch, eng_mod):
    """Wrap the serve engine's prefill functions and its block scatter:
    every admission's last-position logits and the table row it wrote
    through, in call order.  Returns (record, restore)."""
    rec = {"logits": [], "rows": []}
    inner = {k: getattr(eng_mod, k) for k in ("prefill_lm", "prefill_prefix_lm",
                                               "_scatter_blocks")}

    def prefill(*a, **kw):
        lg, c = inner["prefill_lm"](*a, **kw)
        rec["logits"].append(lg[0, -1].detach().clone())
        return lg, c

    def prefill_prefix(params, batch, caches, bt_row, *a, **kw):
        rec["rows"].append(bt_row.detach().clone())
        lg, c = inner["prefill_prefix_lm"](params, batch, caches, bt_row, *a, **kw)
        rec["logits"].append(lg[0, -1].detach().clone())
        return lg, c

    def scatter(pool, src, bt_row, *a, **kw):
        if rec.get("scattered_through") is not bt_row:  # once an admission, not once a leaf
            rec["scattered_through"] = bt_row
            rec["rows"].append(bt_row.detach().clone())
        return inner["_scatter_blocks"](pool, src, bt_row, *a, **kw)

    eng_mod.prefill_lm, eng_mod.prefill_prefix_lm = prefill, prefill_prefix
    eng_mod._scatter_blocks = scatter
    return rec, lambda: [setattr(eng_mod, k, f) for k, f in inner.items()]


def _logical_pool(torch, caches, groups, row, n: int):
    """Each paged leaf's first ``n`` positions through table ``row``, per
    layer: {(group, leaf): (layers, n, ...)}."""
    from repro_torch.models.attention import paged_gather

    out = {}
    for g in groups:
        for name, leaf in caches[g.name]["sub0"].items():
            layers = leaf if g.stacked else leaf[None]
            out[g.name, name] = torch.stack([paged_gather(t, row[None])[0, :n] for t in layers])
    return out


def phase_prefix_parity(torch, dev):
    """11b: gemma3-4b at 6 layers, 2-bit packed (phase 4's build), fp32
    compute, a float pool (max_len 2048, block 16): one request of the shared
    1,000-token prefix plus a 200-token tail admitted three ways through the
    scheduler -- one-shot (bucketed prefill + block scatter), as a prefix hit
    from start 1,000 after another request of the same prefix (the copy on
    write of block 62 included), and in chunks of 256 -- with the kernels.
    The hit's and the chunked admission's logits must agree with the
    one-shot's within ``PARITY_ATOL`` (argmax equal) and their pools, read
    through each one's table row over the prompt's 1,200 positions, within
    the attention bar."""
    import numpy as np
    from repro_torch import configs
    from repro_torch.core import SymogConfig, pack_tree, symog_init
    from repro_torch.models import init_lm
    from repro_torch.models.lm import scan_groups
    from repro_torch.serve import Request, ServeConfig, ServeEngine
    from repro_torch.serve import engine as eng_mod

    cfg = dataclasses.replace(configs.get_config("gemma3-4b"), n_layers=6, kv_cache_dtype="bf16")
    params = init_lm(11, cfg, device=dev)
    scfg = SymogConfig(n_bits=2)
    packed = pack_tree(params, symog_init(params, scfg), scfg)
    del params
    eng = ServeEngine(cfg, packed, max_len=GEMMA3_MAX_LEN, compute_dtype=torch.float32,
                      device=dev)
    groups = scan_groups(cfg)
    rng = np.random.default_rng(5)
    prefix = rng.integers(0, cfg.vocab_size, size=PREFIX_TOKENS)
    other = Request(tokens=np.concatenate([prefix, rng.integers(0, cfg.vocab_size, size=24)]),
                    max_new_tokens=1)
    req = Request(tokens=np.concatenate([prefix, rng.integers(0, cfg.vocab_size, size=200)]),
                  max_new_tokens=1)
    n = len(req.tokens)
    ways = {"one_shot": ([req], {}), "prefix_hit": ([other, req], dict(prefix_cache=True)),
            "chunked": ([req], dict(prefill_chunk=PREFIX_CHUNK))}
    out, stats = {}, {}
    for name, (rs, kw) in ways.items():
        rec, restore = _capture_admission_logits(torch, eng_mod)
        try:
            _, sched = eng.serve(rs, ServeConfig(n_slots=1, block_size=16, **kw),
                                 return_scheduler=True)
        finally:
            restore()
        torch.cuda.synchronize()
        stats[name] = {k: sched.stats[k] for k in ("prefix_hits", "prefix_hit_tokens",
                                                    "prefix_cow_copies", "prefill_chunks")}
        out[name] = (rec["logits"][-1], _logical_pool(torch, sched.caches, groups,
                                                      rec["rows"][-1], n))
        del sched
    ref_lg, ref_pool = out["one_shot"]
    tol = ATTN_TOL["float32"]
    row = {"phase": "prefix_parity", "arch": "gemma3-4b", "layers": 6, "compute": "float32",
           "kv_cache_dtype": "bf16 (a float pool at the compute dtype)", "prompt_len": n,
           "shared_prefix": PREFIX_TOKENS, "chunk": PREFIX_CHUNK, "stats": stats,
           "atol": PARITY_ATOL, "pool_tol": tol, "logit_scale": ref_lg.abs().max().item()}
    ok = (stats["prefix_hit"]["prefix_hit_tokens"] == PREFIX_TOKENS
          and stats["prefix_hit"]["prefix_cow_copies"] == 1
          and stats["chunked"]["prefill_chunks"] == -(-n // PREFIX_CHUNK))
    for name in ("prefix_hit", "chunked"):
        lg, pool = out[name]
        err = (lg - ref_lg).abs().max().item()
        pool_err = max((pool[k] - ref_pool[k]).abs().max().item() for k in ref_pool)
        pool_ok = all(torch.allclose(pool[k], ref_pool[k], **tol) for k in ref_pool)
        argmax = bool(lg.argmax() == ref_lg.argmax())
        row[name] = {"max_abs_logit_err": err, "argmax_equal": argmax,
                     "pool_max_abs_err": pool_err, "pool_within_bar": pool_ok}
        ok = ok and err <= PARITY_ATOL and argmax and pool_ok
    row["pass"] = ok
    emit(row)
    del eng, packed, out
    torch.cuda.empty_cache()
    if not ok:
        raise Failed(f"prefix_parity: {row}")
    return row


def _margin_at(torch, eng, prompt, out, j: int) -> float:
    """The target's top-1 - top-2 logit margin after ``prompt`` + out[:j]."""
    toks = torch.as_tensor(list(map(int, prompt)) + list(out[:j]), dtype=torch.int32,
                           device=eng.device)[None]
    lg, _ = eng.prefill({"tokens": toks})
    top = torch.topk(lg[0, -1].float(), 2).values
    return (top[0] - top[1]).item()


def phase_speculative(torch, dev):
    """11c: internlm2-1.8b at full width and SPEC_LAYERS of its 24 layers,
    bf16, a bf16 pool, phase 5's traffic (4 slots, block 16, max_len 512, 8
    requests of 24..400 tokens, 32 new each), k = 4, adaptive; the draft is the 2-bit
    ``pack_tree`` engine of a SYMOG state, the target in turn the
    ``quantize_tree`` of that state (an exact twin in values) and the
    unquantized params (a disagreeing draft).  Gates (greedy): a repeat
    identical, rounds run, every kernel's launches as the rounds imply (the
    draft's ``fpmm_decode`` 7 x L a draft step, k_r + 1 draft steps a
    round; the GQA kernel L x (k_r + 2) a round; the draft's mirrored
    admissions' matmuls by bucket; the target's dense layers and bucketed
    admissions run no kernel).  Reported: acceptance, tokens a round, decode
    tokens/s beside the target's vanilla serve, agreement with it and the
    target's top-1 - top-2 margin at the first difference.  Then sampled
    (0.7, top-k 50, seed 123) on the twin: identical over a rerun, with 3
    slots and with staggered arrivals."""
    import numpy as np
    from repro_torch import configs
    from repro_torch.core import SymogConfig, pack_tree, quantize_tree, symog_init
    from repro_torch.models import init_lm
    from repro_torch.serve import Request, ServeConfig, ServeEngine, SpeculativeConfig

    cfg = dataclasses.replace(configs.get_config("internlm2-1.8b"), n_layers=SPEC_LAYERS)
    L = cfg.n_layers
    params = init_lm(7, cfg, device=dev)
    scfg = SymogConfig(n_bits=2)
    state = symog_init(params, scfg)
    draft = ServeEngine(cfg, pack_tree(params, state, scfg), max_len=512,
                        compute_dtype=torch.bfloat16, device=dev)
    targets = {"twin": ServeEngine(cfg, quantize_tree(params, state, scfg), max_len=512,
                                   compute_dtype=torch.bfloat16, device=dev),
               "float": ServeEngine(cfg, params, max_len=512, compute_dtype=torch.bfloat16,
                                    device=dev)}
    del state
    rng = np.random.default_rng(0)
    lens = rng.integers(24, 401, size=8)
    reqs = [Request(tokens=rng.integers(0, cfg.vocab_size, size=int(n)), max_new_tokens=32)
            for n in lens]
    spec = SpeculativeConfig(draft=draft, k=SPEC_K)
    rows = {}
    for tname, eng in targets.items():
        fns = eng.scheduler_fns(greedy=True, top_k=0)
        sfns = eng.speculative_fns(greedy=True, top_k=0)

        def serve(config):
            adm, restore = _record_admissions(torch, fns)
            depths, verify = [], sfns.verify_step

            def verify_step(k):
                depths.append(int(k))
                return verify(k)

            sfns.verify_step = verify_step
            zero_counts()
            t0 = time.perf_counter()
            try:
                comps, sched = eng.serve(reqs, config, return_scheduler=True)
                torch.cuda.synchronize()
            finally:
                del sfns.verify_step
                restore()
            wall = time.perf_counter() - t0
            return comps, sched, adm, depths, read_counts(), wall

        comps, sched, adm, depths, counts, wall = serve(ServeConfig(n_slots=4, block_size=16,
                                                                    speculative=spec))
        again = serve(ServeConfig(n_slots=4, block_size=16, speculative=spec))[0]
        v_comps, v_sched, v_adm, _, _, v_wall = serve(ServeConfig(n_slots=4, block_size=16))
        # the vanilla serve again with the float matmuls at their own row
        # counts (before batch-invariant rows): what the padding costs
        u_comps, u_sched, u_adm, _, _, u_wall = _unpadded(
            lambda: serve(ServeConfig(n_slots=4, block_size=16)))
        st = sched.stats
        tokens = [list(map(int, c.tokens)) for c in comps]
        vanilla = [list(map(int, c.tokens)) for c in v_comps]
        draft_buckets = [b for b, p in zip(adm["buckets"], adm["params"]) if p is draft.params]
        draft_steps = sum(k + 1 for k in depths)
        # each round: k + 1 draft decode steps and one verify of k + 1 rows,
        # the verify on the prefill kernel where the rule sends it
        want = {**_matmul_counts(7 * L, 0, draft_steps, draft_buckets),
                "paged_attention": L * sum(k + 2 for k in depths), "paged_attention_quant": 0,
                "paged_attention_prefill": L * _prefill_route_calls(
                    cfg, [k + 1 for k in depths], 1),
                "paged_attention_prefill_quant": 0,
                **dict.fromkeys(MLA_COUNTS, 0), "symog_update": 0}
        prefill_s, v_prefill_s = sum(adm["ms"]) / 1e3, sum(v_adm["ms"]) / 1e3
        dec_tok = st["tokens_emitted"] - st["prefills"]
        v_dec_tok = v_sched.stats["tokens_emitted"] - v_sched.stats["prefills"]
        same = total = 0
        first_diff = None
        for i, (a, b) in enumerate(zip(tokens, vanilla)):
            same += sum(int(x == y) for x, y in zip(a, b))
            total += max(len(a), len(b))
            j = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y), None)
            if j is not None and first_diff is None:
                first_diff = {"request": i, "token": j,
                              "target_top1_minus_top2": _margin_at(torch, eng, reqs[i].tokens,
                                                                   a, j)}
        row = {"phase": "speculative", "arch": "internlm2-1.8b", "layers": L, "target": tname,
               "target_params": "quantize_tree (2-bit values, bf16 compute)" if tname == "twin"
               else "unquantized float", "draft": "pack_tree 2-bit", "k": SPEC_K,
               "adaptive": True, "kv_cache_dtype": "bf16", "prompt_lens": lens.tolist(),
               "rounds": st["spec_steps"], "depths": depths,
               "draft_steps": draft_steps, "verify_rows_T": sorted({k + 1 for k in depths}),
               "acceptance": st["spec_accepted"] / max(st["spec_drafted"], 1),
               "tokens_per_row_round": st["spec_emitted"] / max(st["spec_row_rounds"], 1),
               "stats": {k: st[k] for k in ("spec_steps", "spec_row_rounds", "spec_drafted",
                                            "spec_accepted", "spec_emitted", "preemptions")},
               "wall_s": wall, "prefill_s": prefill_s,
               "decode_tokens_per_s": dec_tok / max(wall - prefill_s, 1e-9),
               "vanilla_wall_s": v_wall, "vanilla_decode_steps": v_sched.stats["decode_steps"],
               "vanilla_decode_tokens_per_s": v_dec_tok / max(v_wall - v_prefill_s, 1e-9),
               "vanilla_decode_tokens_per_s_rows_unpadded": (
                   u_sched.stats["tokens_emitted"] - u_sched.stats["prefills"])
               / max(u_wall - sum(u_adm["ms"]) / 1e3, 1e-9),
               "rows_unpadded_tokens_equal_vanilla": [list(map(int, c.tokens))
                                                      for c in u_comps] == vanilla,
               "agreement_vs_vanilla": same / max(total, 1), "first_difference": first_diff,
               "repeat_tokens_identical": [list(map(int, c.tokens)) for c in again] == tokens,
               "launches": counts, "expected_launches": want}
        row["pass"] = (row["repeat_tokens_identical"] and st["spec_steps"] > 0
                       and counts == want and all(len(t) == 32 for t in tokens))
        if tname == "twin":
            def sampled(rs, n):
                return [list(map(int, c.tokens)) for c in eng.serve(rs, ServeConfig(
                    n_slots=n, block_size=16, speculative=spec, **GEMMA3_SAMPLING))]

            t0 = time.perf_counter()
            runs = {"4_slots": sampled(reqs, 4), "4_slots_again": sampled(reqs, 4),
                    "3_slots": sampled(reqs, 3),
                    "staggered": sampled([dataclasses.replace(r, arrival=4 * i)
                                          for i, r in enumerate(reqs)], 4)}
            b0 = runs["4_slots"]
            row.update({"sampling": GEMMA3_SAMPLING, "sampled_runs_s": time.perf_counter() - t0,
                        "sampled_streams_identical": {k: v == b0 for k, v in runs.items()},
                        "sampled_differs_from_greedy": b0 != tokens})
            row["pass"] = row["pass"] and all(v == b0 for v in runs.values()) and b0 != tokens
        emit(row)
        rows[tname] = row
        if not row["pass"]:
            raise Failed(f"speculative {tname}: {row}")
    del targets, draft, params
    torch.cuda.empty_cache()
    return rows


def phase_verify_parity(torch, dev):
    """11d: internlm2-1.8b at 4 layers, 2-bit packed, fp32, a float pool
    (max_len 512, block 16) of random unit-scale k/v: ``decode_verify_lm``
    at T = k + 1 for four rows -- ~300 and ~100 tokens, one inactive, one
    at 509 whose last two positions pass max_len (``valid`` masked) --
    through the kernels, held to k + 1 sequential ``decode_lm`` steps
    through the kernels (the masked positions' rows off) and to the verify
    on the plain path: logits of the live positions within ``PARITY_ATOL``,
    argmax equal, the pools outside the trash block within the attention
    bar; the GQA kernel launched once a layer by the verify, T times by the
    steps."""
    from repro_torch import configs
    from repro_torch.core import SymogConfig, pack_tree, symog_init
    from repro_torch.kernels import dispatch
    from repro_torch.models import decode_lm, decode_verify_lm, init_lm
    from repro_torch.models.lm import scan_groups
    from repro_torch.serve import ServeConfig, ServeEngine
    from repro_torch.serve.scheduler import Scheduler

    layers, max_len, block, T = 4, 512, 16, VERIFY_T
    cfg = dataclasses.replace(configs.get_config("internlm2-1.8b"), n_layers=layers)
    params = init_lm(11, cfg, device=dev)
    scfg = SymogConfig(n_bits=2)
    packed = pack_tree(params, symog_init(params, scfg), scfg)
    del params
    gen = torch.Generator(device="cpu")
    gen.manual_seed(4)
    pos0 = torch.tensor([300, 97, 0, max_len - 3], dtype=torch.int32)
    active = torch.tensor([True, True, False, True])
    B, mb = len(pos0), max_len // block
    bt = torch.zeros((B, mb), dtype=torch.int32)
    ids = torch.randperm(B * mb, generator=gen) + 1
    for b in range(B):
        if active[b]:
            n_own = min(mb, (int(pos0[b]) + T - 1) // block + 1)
            bt[b, :n_own] = ids[b * mb: b * mb + n_own].to(torch.int32)
    tokens = torch.randint(0, cfg.vocab_size, (B, T), generator=gen, dtype=torch.int32)
    positions = pos0[:, None] + torch.arange(T, dtype=torch.int32)[None]
    valid = positions <= max_len - 1
    live = (valid & active[:, None]).to(dev)
    pools, results = None, {}
    for path, (pb, ab) in {"kernels": ("kernel", "fused"), "plain": ("unpack", "composed")}.items():
        dispatch.set_packed_backend(pb)
        dispatch.set_attention_backend(ab)
        eng = ServeEngine(cfg, packed, max_len=max_len, compute_dtype=torch.float32, device=dev)
        dispatch.set_packed_backend("auto")
        dispatch.set_attention_backend("auto")
        if pools is None:
            pools = Scheduler(eng, ServeConfig(n_slots=B, block_size=block)).caches
            for sub in pools.values():
                for leaf in sub["sub0"].values():
                    leaf.copy_(torch.randn(leaf.shape, generator=gen).to(dev, leaf.dtype))

        def clone():
            return {g: {"sub0": {n: t.clone() for n, t in sub["sub0"].items()}}
                    for g, sub in pools.items()}

        d = dict(compute_dtype=torch.float32)
        zero_counts()
        lg_v, c_v = eng._with_backend(decode_verify_lm, eng.params, clone(), tokens.to(dev),
                                      pos0.to(dev), cfg, block_tables=bt.to(dev),
                                      active=active.to(dev), valid=valid.to(dev), **d)
        torch.cuda.synchronize()
        n_verify = read_counts()["paged_attention"]
        res = {"verify": (lg_v, c_v), "verify_launches": n_verify}
        if path == "kernels":
            c_s, outs = clone(), []
            for t in range(T):
                act = active & valid[:, t]
                lg, c_s = eng._with_backend(decode_lm, eng.params, c_s, tokens[:, t:t + 1].to(dev),
                                            (pos0 + t).to(dev), cfg, active=act.to(dev),
                                            block_tables=(bt * act[:, None]).to(dev), **d)
                outs.append(lg[:, 0])
            torch.cuda.synchronize()
            res["steps"] = (torch.stack(outs, 1), c_s)
            res["step_launches"] = read_counts()["paged_attention"] - n_verify
        results[path] = res
        del eng
    groups = scan_groups(cfg)
    kv, (ks_lg, ks_pool) = results["kernels"]["verify"], results["kernels"]["steps"]
    pv = results["plain"]["verify"]
    tol = ATTN_TOL["float32"]

    def cmp(a, b):
        la, lb = a[0][live], b[0][live]
        pool_ok, pool_err = True, 0.0
        for g in a[1]:
            for n, t in a[1][g]["sub0"].items():  # the trash block aside
                x = _past_trash(t, g, groups, True)
                y = _past_trash(b[1][g]["sub0"][n], g, groups, True)
                pool_ok = pool_ok and bool(torch.allclose(x, y, **tol))
                pool_err = max(pool_err, (x - y).abs().max().item())
        return {"max_abs_logit_err": (la - lb).abs().max().item(),
                "argmax_agreement": (la.argmax(-1) == lb.argmax(-1)).float().mean().item(),
                "pool_max_abs_err": pool_err, "pool_within_bar": pool_ok}

    vs_steps, vs_plain = cmp(kv, (ks_lg, ks_pool)), cmp(kv, pv)
    want = {"kernels_verify": layers, "kernels_steps": layers * T, "plain_verify": 0}
    got = {"kernels_verify": results["kernels"]["verify_launches"],
           "kernels_steps": results["kernels"]["step_launches"],
           "plain_verify": results["plain"]["verify_launches"]}
    row = {"phase": "verify_parity", "arch": "internlm2-1.8b", "layers": layers,
           "compute": "float32", "T": T, "pos0": pos0.tolist(), "active": active.tolist(),
           "valid_positions": int(valid.sum()), "live_positions": int(live.sum()),
           "atol": PARITY_ATOL, "pool_tol": tol, "vs_sequential_decode": vs_steps,
           "vs_plain_verify": vs_plain, "logit_scale": kv[0][live].abs().max().item(),
           "attention_launches": got, "expected_attention_launches": want}
    row["pass"] = (got == want and all(
        r["max_abs_logit_err"] <= PARITY_ATOL and r["argmax_agreement"] == 1.0
        and r["pool_within_bar"] for r in (vs_steps, vs_plain)))
    emit(row)
    del results, pools, packed
    torch.cuda.empty_cache()
    if not row["pass"]:
        raise Failed(f"verify_parity: {row}")
    return row


# ---------------------------------------------------------------------------
# phase 13: the async front end, cancellation, priority, telemetry,
# checkpoints and the launcher, on phase 5's engine
# ---------------------------------------------------------------------------
def _decode_ms(sched):
    """Run ``sched`` to the end and return (completions, each decode step's
    host ms as the scheduler times it: dispatch through the step's sync)."""
    steps = []
    observe = sched._observe_step_time

    def record(dt):
        steps.append(dt * 1e3)
        observe(dt)

    sched._observe_step_time = record
    return sched.run(), steps


def _front_async(torch, eng, sc, reqs, want, row, gate):
    """(a): every request submitted at once, then a late submission."""
    import asyncio

    streamed = {}

    async def collect(agen):
        return [t async for t in agen]

    async def at_once():
        async with eng.serve_async(sc) as srv:
            ids = [srv.submit(r, on_token=lambda i, t: streamed.setdefault(i, []).append(int(t)))
                   for r in reqs]
            streams = await asyncio.gather(*[collect(srv.tokens(i)) for i in ids])
            return ids, streams, await srv.drain()

    async def late():
        async with eng.serve_async(sc) as srv:
            ids = [srv.submit(r) for r in reqs[:-1]]
            first = []
            async for t in srv.tokens(ids[0]):
                first.append(t)
                if len(first) == 2:
                    break
            idx = srv.submit(reqs[-1])
            live = srv.scheduler._n_live
            return idx, live, await srv.drain()

    zero_counts()
    ids, streams, comps = asyncio.run(at_once())
    torch.cuda.synchronize()
    counts = read_counts()
    got = [list(map(int, c.tokens)) for c in comps]
    gate("async_tokens_equal_sync", got == want)
    gate("async_streams_equal_sync", [list(map(int, s)) for s in streams] == want)
    gate("async_on_token_equal_sync", [streamed.get(i) for i in ids] == want)
    gate("async_timeline_tokens", all(
        [e for e, _ in c.timeline].count("token") == len(c.tokens) for c in comps))
    gate("async_ran_the_kernels", counts["fixedpoint_matmul_decode"] > 0
         and counts["paged_attention"] > 0)
    idx, live, comps = asyncio.run(late())
    lc = comps[idx]
    others = [c for c in comps if c.index != idx]
    gate("late_submission_joins_live_batch", live > 0 and lc.timeline[0][1] > 0
         and lc.admitted_step < max(c.finished_step for c in others))
    gate("late_submission_tokens_equal_sync", list(map(int, lc.tokens)) == want[-1])
    row["async"] = {"launches": {k: v for k, v in counts.items() if v},
                    "late": {"submitted_step": lc.timeline[0][1], "live_at_submit": live,
                             "admitted_step": lc.admitted_step,
                             "finished_step": lc.finished_step}}


def _front_cancel(eng, sc, reqs, want, row, gate):
    """(b): request 3 arrives alone at step 2 and is cancelled after its
    fourth token; three requests live beside it."""
    from repro_torch.serve import Request, Scheduler

    sched = Scheduler(eng, sc)
    ids = [sched.submit(r) for r in reqs[:3]]
    vr = reqs[3]
    victim = sched.submit(Request(tokens=vr.tokens, max_new_tokens=vr.max_new_tokens, arrival=2))
    sched.step()
    sched.step()
    free0 = sched.pool.n_free  # the step boundary before the victim's admission
    held0 = sum(len(s.blocks) for s in sched._slots if s is not None)

    def vstate():
        return next((s for s in sched._slots if s is not None and s.index == victim), None)

    while vstate() is None or len(vstate().out) < 4:
        sched.step()
    vblocks = len(vstate().blocks)
    ok = sched.cancel(victim)
    free1 = sched.pool.n_free
    held = sum(len(s.blocks) for s in sched._slots if s is not None)
    gate("cancel_returns_true", ok)
    gate("cancel_frees_blocks", free1 == free0 - (held - held0)
         and sched.pool.n_live == held)
    sched.pool.check([s.blocks for s in sched._slots if s is not None])
    queued = sched.submit(reqs[4])
    returns = [sched.cancel(queued), sched.cancel(queued), sched.cancel(10_000)]
    comps = {c.index: c for c in sched.run()}
    returns.append(sched.cancel(ids[0]))  # finished
    gate("cancel_queued_unknown_finished", returns == [True, False, False, False])
    vc = comps[victim]
    gate("cancelled_reason", vc.finish_reason == "cancelled" and vc.timeline[-1][0] == "cancel"
         and comps[queued].finish_reason == "cancelled" and comps[queued].slot == -1)
    gate("cancelled_prefix_equal_sync", list(map(int, vc.tokens)) == want[3][:len(vc.tokens)])
    gate("survivors_equal_sync", [list(map(int, comps[i].tokens)) for i in ids] == want[:3])
    sched.pool.check()
    row["cancel"] = {"victim_tokens": len(vc.tokens), "victim_blocks": vblocks,
                     "free_before_admission": free0, "free_after_cancel": free1,
                     "survivor_growth_blocks": held - held0, "returns": returns}


def _front_priority(eng, sc, reqs, row, gate):
    """(c): admission order under priority, and the preemption victim."""
    import numpy as np
    from repro_torch.serve import Request, Scheduler, ServeConfig

    sched = Scheduler(eng, sc)
    ids = [sched.submit(Request(tokens=r.tokens, max_new_tokens=8)) for r in reqs[:6]]
    hp = sched.submit(Request(tokens=reqs[6].tokens, max_new_tokens=8, arrival=1, priority=1))
    sched.run()
    admits = [i for _, kind, i, _ in sched.events if kind == "admit"]
    gate("priority_admits_first", admits == ids[:4] + [hp] + ids[4:])
    rng = np.random.default_rng(13)
    low, high = (Request(tokens=rng.integers(0, eng.cfg.vocab_size, size=200), max_new_tokens=80,
                         priority=p) for p in (0, 5))
    sched = Scheduler(eng, ServeConfig(n_slots=2, block_size=16, n_blocks=32))
    id_low, id_high = sched.submit(low), sched.submit(high)
    comps = sched.run()
    preempted = [i for _, kind, i, _ in sched.events if kind == "preempt"]
    gate("preemption_victim_lowest_priority", preempted and set(preempted) == {id_low}
         and all(c.finish_reason == "length" for c in comps))
    row["priority"] = {"admit_order": admits, "high_priority_index": hp,
                       "preemptions": sched.stats["preemptions"], "preempted": preempted}


def _front_telemetry(torch, eng, sc, reqs, want, row, gate, tmp):
    """(d): a traced serve, then decode step ms with tracing off / on."""
    from repro_torch.serve import Scheduler, TelemetryConfig

    on = dataclasses.replace(sc, telemetry=TelemetryConfig(trace=True))
    sched = Scheduler(eng, on)
    for r in reqs:
        sched.submit(r)
    comps = sched.run()
    path = os.path.join(tmp, "serve_trace.json")
    sched.tracer.export_chrome(path)
    with open(path) as f:
        doc = json.load(f)
    names = {e["name"] for e in doc["traceEvents"]}
    n_decode = sum(1 for s in sched.tracer.spans if s[0] == "decode")
    snap = sched.registry.snapshot()
    gate("trace_spans", {"admit", "decode"} <= names)
    gate("registry_tokens", snap["serve_tokens_emitted"] == sum(len(c.tokens) for c in comps))
    gate("registry_decode_steps", snap["serve_decode_steps"] == n_decode == sched.monitor.count
         and n_decode > 0)
    gate("traced_tokens_equal_sync", [list(map(int, c.tokens)) for c in comps] == want)
    print("\n".join("  " + ln for ln in sched.registry.render_text()), flush=True)
    row["snapshot"] = snap
    row["trace_events"] = len(doc["traceEvents"])
    ms = []
    for tele in (sc, on, on, sc):  # tracing off, on, on, off
        s = Scheduler(eng, tele)
        for r in reqs:
            s.submit(r)
        c, steps = _decode_ms(s)
        torch.cuda.synchronize()
        gate("timed_tokens_equal_sync", [list(map(int, x.tokens)) for x in c] == want)
        ms.append({"trace": tele.telemetry.trace, "decode_steps": len(steps),
                   "decode_step_ms_mean": sum(steps) / len(steps),
                   "decode_step_ms_median": sorted(steps)[len(steps) // 2]})
    row["decode_step_ms_trace_off_on_on_off"] = ms


def _front_checkpoint(torch, dev, eng, sc, reqs, want, row, gate, tmp):
    """(e): save the packed params, restore them onto the card, serve."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.nn.tree import flatten_with_paths
    from repro_torch.serve import ServeEngine

    mgr = CheckpointManager(os.path.join(tmp, "ckpt"))
    t = time.perf_counter()
    mgr.save(1, eng.params, metadata={"arch": eng.cfg.name})
    mgr.wait()
    save_s = time.perf_counter() - t
    d = mgr.path(1)
    nbytes = sum(os.path.getsize(os.path.join(d, n)) for n in os.listdir(d))
    t = time.perf_counter()
    tree, meta, step = mgr.restore(eng.params, device=dev)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t
    same = all(
        (torch.equal(a.data, b.data) and torch.equal(a.f, b.f) and a.n_bits == b.n_bits)
        if hasattr(a, "n_bits") else torch.equal(a, b)
        for (_, a), (_, b) in zip(flatten_with_paths(tree), flatten_with_paths(eng.params)))
    restored = ServeEngine(eng.cfg, tree, max_len=eng.max_len, compute_dtype=eng.compute_dtype,
                           device=dev)
    comps = restored.serve(reqs, sc)
    gate("checkpoint_leaves_equal", same and step == 1 and meta == {"arch": eng.cfg.name})
    gate("checkpoint_tokens_equal", [list(map(int, c.tokens)) for c in comps] == want)
    row["checkpoint"] = {"bytes": nbytes, "files": len(os.listdir(d)), "save_s": save_s,
                         "restore_s": restore_s, "weight_bytes": eng.weight_bytes()}
    del restored, tree


def _front_launcher(row, gate, tmp):
    """(f): the serve launcher at full width, as a subprocess."""
    here = os.path.dirname(os.path.abspath(__file__))
    mj, tr, pd = (os.path.join(tmp, n) for n in ("metrics.json", "trace.json", "prof"))
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "internlm2-1.8b",
           "--packed", "--kv-bits", "4", "--continuous", "--requests", "8", "--slots", "4",
           "--metrics-json", mj, "--trace-out", tr, "--profile-dir", pd, "--profile-steps", "4"]
    env = dict(os.environ, PYTHONPATH=os.path.join(here, "src"))
    t = time.perf_counter()
    proc = subprocess.run(cmd, cwd=here, env=env, capture_output=True, text=True, timeout=400)
    row["launcher"] = {"rc": proc.returncode, "seconds": time.perf_counter() - t,
                       "stdout_tail": proc.stdout.splitlines()[-24:]}
    gate("launcher_exit_0", proc.returncode == 0)
    if proc.returncode:
        print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr, flush=True)
        return
    ok_names = ok_trace = True
    for path in (mj, mj.replace(".json", ".packed.json")):
        with open(path) as f:
            metrics = json.load(f)["metrics"]
        ok_names &= set(SERVE_METRICS) <= set(metrics)
        row["launcher"][os.path.basename(path)] = {
            k: metrics[k] for k in ("serve_decode_steps", "serve_tokens_emitted",
                                    "serve_admissions", "serve_pool_bytes")}
    for path in (tr, tr.replace(".json", ".packed.json")):
        with open(path) as f:
            ok_trace &= {"admit", "decode"} <= {e["name"] for e in json.load(f)["traceEvents"]}
    found = []  # per profiler trace (float run, packed run): our kernels it names
    for name in sorted(os.listdir(pd)):
        with open(os.path.join(pd, name)) as f:
            names = {e.get("name", "") for e in json.load(f)["traceEvents"]
                     if e.get("cat") == "kernel"}
        found.append(sorted(k for k in ("fpmm_decode", "fpmm_tc", "gqa_decode")
                            if any(k in n for n in names)))
    gate("launcher_metric_names", ok_names)
    gate("launcher_trace_parses", ok_trace)
    gate("launcher_profile_names_kernels", any({"fpmm_decode", "gqa_decode"} <= set(k)
                                               for k in found))
    row["launcher"]["profile_kernels"] = found


def phase_front_end(torch, dev, eng, reqs, want):
    """Phase 13 (module docstring): the async front end, cancellation,
    priority, telemetry, checkpoints and the launcher on phase 5's
    internlm2 engine (8 layers, 2-bit packed, bf16 pool and compute) and
    traffic; ``want`` is phase 5's tokens.  Every gate raises."""
    import shutil
    import tempfile

    from repro_torch.serve import ServeConfig

    sc = ServeConfig(n_slots=4, block_size=16)
    row = {"phase": "front_end", "arch": "internlm2-1.8b", "gates": {}, "seconds": {}}

    def gate(name, ok):
        row["gates"][name] = bool(ok) and row["gates"].get(name, True)

    tmp = tempfile.mkdtemp(prefix="symog_front_end_")
    try:
        for name, fn, args in (
                ("a_async", _front_async, (torch, eng, sc, reqs, want, row, gate)),
                ("b_cancel", _front_cancel, (eng, sc, reqs, want, row, gate)),
                ("c_priority", _front_priority, (eng, sc, reqs, row, gate)),
                ("d_telemetry", _front_telemetry, (torch, eng, sc, reqs, want, row, gate, tmp)),
                ("e_checkpoint", _front_checkpoint,
                 (torch, dev, eng, sc, reqs, want, row, gate, tmp)),
                ("f_launcher", _front_launcher, (row, gate, tmp))):
            t = time.perf_counter()
            fn(*args)
            torch.cuda.synchronize()
            row["seconds"][name] = time.perf_counter() - t
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    row["pass"] = all(row["gates"].values())
    emit(row)
    if not row["pass"]:
        raise Failed(f"front_end failed: {[k for k, v in row['gates'].items() if not v]}")
    return row


# ---------------------------------------------------------------------------
# phase 14: the recurrent families (mamba2's SSD, recurrentgemma's RG-LRU
# with local attention): rows 1 and 2 at their shapes, kernel vs plain
# route, full-width serves, card vs CPU
# ---------------------------------------------------------------------------
MAMBA2_FPMM_SHAPES = [  # one mamba2-2.7b layer's packed projections, K x N
    ("in_proj_z", 2560, 5120), ("in_proj_x", 2560, 5120), ("in_proj_B", 2560, 128),
    ("in_proj_C", 2560, 128), ("in_proj_dt", 2560, 80), ("out_proj", 5120, 2560),
]
RGEMMA_MLP_SHAPES = [("gate_proj", 2560, 7680), ("up_proj", 2560, 7680),
                     ("down_proj", 7680, 2560)]
RECURRENT_FPMM_LAYERS = {  # recurrentgemma-2b: an RG-LRU layer and a local-attention layer
    "mamba2-2.7b M": MAMBA2_FPMM_SHAPES,
    "recurrentgemma-2b R": [("in_proj_x", 2560, 2560), ("in_proj_y", 2560, 2560),
                            ("out_proj", 2560, 2560)] + RGEMMA_MLP_SHAPES,
    "recurrentgemma-2b A": [("q_proj", 2560, 2560), ("k_proj", 2560, 256),
                            ("v_proj", 2560, 256), ("o_proj", 2560, 2560)] + RGEMMA_MLP_SHAPES,
}
RECURRENT_FPMM_M = (4, 512)  # a decode step of 4 slots; the serve's largest prompt bucket
PACKED_PER_KIND = {"M": 6, "R": 6, "A": 7}  # packed matmul launches a layer and call
# recurrentgemma-2b's local attention at decode: MQA (K 1, G 10), head_dim
# 256, rows of ~3,000 cached tokens so that its 2,048-token window binds
RGEMMA_ATTN_SHAPE = dict(B=4, K=1, G=10, hd=256, block=16, max_blocks=200,
                         pos_last=(2900, 3100))
RECURRENT_PARITY_LAYERS = {"recurrentgemma-2b": 5, "mamba2-2.7b": 4}  # RRL + RR; 4 x M


def phase_fpmm_recurrent(torch, dev):
    """Row 1 at the recurrent families' shapes, 2-bit, bf16: one mamba2
    layer's 6 projections (N 80 and 128 among them), one recurrentgemma
    RG-LRU layer's 6 and one local-attention layer's 7, at M = 4 and 512;
    each holds its rule's kernel to the plain version and times it beside
    the streaming kernel, ``torch.matmul`` and the bound.  Returns the rows
    and each layer's sums by M."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(14)
    keys = ("ms", "stream_ms", "plain_ms", "library_ms", "bound_ms")
    rows, sums = [], {}
    for layer, shapes in RECURRENT_FPMM_LAYERS.items():
        for M in RECURRENT_FPMM_M:
            acc = sums[f"{layer} M={M}"] = dict.fromkeys(keys, 0.0)
            for name, K, N in shapes:
                row = _fpmm_case(torch, gen, dev, name, K, N, M, torch.bfloat16, 2,
                                 with_bias=False, timing=True,
                                 routes=_bf16_routes(torch.bfloat16, M))
                row["arch"] = layer
                for k in keys:
                    acc[k] += row[k]
                emit(row)
                rows.append(row)
                if not row["pass"]:
                    raise Failed(f"fixedpoint_matmul {layer} {name} M={M}: err {_err(row)}")
            acc["route"] = rows[-1]["route"]
            acc["bound_by"] = _bound_by(rows[-len(shapes):])
        torch.cuda.empty_cache()
    return rows, sums


def phase_attn_recurrent(torch, dev):
    """Row 2 at recurrentgemma-2b's decode shape (B 4, MQA K 1 G 10, hd 256,
    window 2,048 over ~3,000 cached tokens), from a bf16 pool and from a
    KV_F int8 pool (one global Δ = 2^-5: the pool an ``int8_fp`` engine of a
    non-decoder family serves from), against the plain version and SDPA."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(15)
    return [_attn_dense_case(torch, gen, dev, dict(RGEMMA_ATTN_SHAPE),
                             dict(T=1, dt=torch.bfloat16, int8=int8, q_mult=1.0, window=2048,
                                  cap=0.0, scale=256**-0.5, arch="recurrentgemma-2b"))
            for int8 in (False, True)]


def _recurrent_packed(torch, dev, cfg, seed: int):
    from repro_torch.core import SymogConfig, pack_tree, symog_init
    from repro_torch.models import init_lm

    params = init_lm(seed, cfg, device=dev)
    scfg = SymogConfig(n_bits=2)
    return pack_tree(params, symog_init(params, scfg), scfg)


def _resident(caches, groups):
    """{path: leaf} of the resident (not paged) leaves of a serving pool."""
    from repro_torch.models.lm import PAGED_CACHE_LEAVES

    return {f"{g.name}/sub{j}/{n}": t for g in groups for j, paged in enumerate(g.paged)
            for n, t in caches[g.name][f"sub{j}"].items()
            if not (paged and n in PAGED_CACHE_LEAVES)}


def phase_parity_recurrent(torch, dev, arch: str, layers: int):
    """Logits through the kernels against the plain paths, at full width and
    ``layers`` deep, fp32 compute, 2-bit packed, a bf16 pool: two prompts
    admitted by the engine's own admission step (bucketed prefill, the
    attention k/v scattered into the pool, the recurrent / SSD states and
    conv windows copied into the slot rows), then 4 teacher-forced paged
    decode steps.  The kernel route runs every packed projection on the
    streaming kernel (fp32 x) and the local attention on the GQA kernel;
    the plain route neither.  The two routes' resident states after the
    last step are compared too."""
    from repro_torch import configs
    from repro_torch.kernels import dispatch
    from repro_torch.models import decode_lm
    from repro_torch.serve import ServeConfig, ServeEngine
    from repro_torch.serve import engine as eng_mod
    from repro_torch.serve.scheduler import Scheduler

    cfg = dataclasses.replace(configs.get_config(arch), n_layers=layers)
    packed = _recurrent_packed(torch, dev, cfg, 11)
    max_len, block, steps = 128, 16, 4
    gen = torch.Generator(device="cpu")
    gen.manual_seed(3)
    lens = [37, 70]
    prompts = [torch.randint(0, cfg.vocab_size, (L,), generator=gen) for L in lens]
    forced = torch.randint(0, cfg.vocab_size, (steps, len(lens)), generator=gen)
    kinds = cfg.layer_kinds()
    n_mm, n_attn = sum(PACKED_PER_KIND[k] for k in kinds), kinds.count("A")
    logits, launches, states = {}, {}, {}
    for path, (pb, ab) in {"kernels": ("kernel", "fused"), "plain": ("unpack", "composed")}.items():
        dispatch.set_packed_backend(pb)
        dispatch.set_attention_backend(ab)
        eng = ServeEngine(cfg, packed, max_len=max_len, compute_dtype=torch.float32, device=dev)
        dispatch.set_packed_backend("auto")
        dispatch.set_attention_backend("auto")
        sched = Scheduler(eng, ServeConfig(n_slots=len(lens), block_size=block))
        caches, groups = sched.caches, sched._groups
        del sched
        nb = max_len // block
        bt = (torch.arange(len(lens) * nb, device=dev, dtype=torch.int32) + 1).reshape(len(lens),
                                                                                       nb)
        fns = eng.scheduler_fns(greedy=True, top_k=0)
        zero_counts()
        rec, restore = _capture_admission_logits(torch, eng_mod)
        try:
            for b, pr in enumerate(prompts):
                L = int(pr.shape[0])
                bucket = 1 << (L - 1).bit_length()
                tokens = torch.zeros((1, bucket), dtype=torch.int32, device=dev)
                tokens[0, :L] = pr.to(dev)
                _, caches = eng._with_backend(fns.admit_step(bucket, block), eng.params,
                                              {"tokens": tokens}, L, caches, bt[b], b, 0, 0, 1.0)
        finally:
            restore()
        outs = list(rec["logits"])
        pos = torch.tensor(lens, dtype=torch.int32, device=dev)
        active = torch.ones(len(lens), dtype=torch.bool, device=dev)
        for s in range(steps):
            lg, caches = eng._with_backend(decode_lm, eng.params, caches,
                                           forced[s].to(dev)[:, None].to(torch.int32), pos, cfg,
                                           compute_dtype=torch.float32, active=active,
                                           block_tables=bt)
            outs.extend(lg[:, 0])
            pos = pos + 1
        torch.cuda.synchronize()
        logits[path] = torch.stack(outs)
        counts = read_counts()
        launches[path] = {k: v for k, v in counts.items() if v}
        states[path] = _resident(caches, groups)
        del eng, caches
    a, b = logits["kernels"], logits["plain"]
    err = (a - b).abs().max().item()
    agree = (a.argmax(-1) == b.argmax(-1)).float().mean().item()
    finite = bool(torch.isfinite(a).all().item())
    want = {"kernels": {k: v for k, v in (("fixedpoint_matmul", n_mm * (len(lens) + steps)),
                                          ("paged_attention", n_attn * steps)) if v},
            "plain": {}}
    state_err = {p: (t.float() - states["plain"][p].float()).abs().max().item()
                 for p, t in states["kernels"].items()}
    del packed, states
    torch.cuda.empty_cache()
    row = {"phase": "parity", "arch": arch, "layers": layers, "kinds": "".join(kinds),
           "n_bits": 2, "kv_cache_dtype": "bf16", "compute": "float32", "prompts": lens,
           "decode_steps": steps, "logit_rows": int(a.shape[0]), "max_abs_logit_err": err,
           "atol": PARITY_ATOL, "logit_scale": a.abs().max().item(), "argmax_agreement": agree,
           "finite": finite, "launches": launches, "expected_launches": want,
           "resident_state_max_abs_err": state_err,
           "admission": "bucketed prefill + block scatter + slot-row copy",
           "pass": finite and err <= PARITY_ATOL and agree == 1.0 and launches == want}
    emit(row)
    if not row["pass"]:
        raise Failed(f"parity {arch}: {row}")
    return row


def _recurrent_expected(cfg, st, buckets):
    """Launches of a recurrent model's bf16 serve: every packed projection
    once a decode step (4 slots: the decode kernel) and once an admission
    (by its bucket's rows); the local attention layers' GQA kernel once a
    layer and decode step, over a bf16 or a KV_F int8 pool alike (bucketed
    admissions attend in the prefill, not the pool).  The tied head
    dequantizes its table: no launch."""
    kinds = cfg.layer_kinds()
    return {**_matmul_counts(sum(PACKED_PER_KIND[k] for k in kinds), 0, st["decode_steps"],
                             buckets),
            "paged_attention": kinds.count("A") * st["decode_steps"], "paged_attention_quant": 0,
            **dict.fromkeys(MLA_COUNTS + PREFILL_COUNTS, 0), "symog_update": 0}


def _layer_decode_ms(torch, dev, eng, kind: str):
    """One decode step of a ``kind`` layer at the serve's 4 slots, bf16: a
    CUDA graph over 16 layers of the stack, each with its own state (2-bit
    words and states rotated past the L2), ms a layer.  Two times: the
    block alone, which returns its new state and writes nothing, and the
    block followed by the write-back ``decode_lm`` does in the serve
    (``torch.where`` of new against old state under an ``active`` mask
    with one slot idle, then ``copy_`` into the cache)."""
    from repro_torch.models.blocks import block_cache_init, block_decode
    from repro_torch.models.lm import _write_back, scan_groups
    from repro_torch.models.quantized import scan_ready, unstack_layers

    cfg = eng.cfg
    g = next(g for g in scan_groups(cfg) if g.stacked and kind in g.unit)
    j = g.unit.index(kind)
    layers = [u[f"sub{j}"] for u in unstack_layers(scan_ready(eng.params[g.name], g.count),
                                                   g.count)][:16]
    args = [(p, block_cache_init(4, 1, cfg, kind, torch.bfloat16, dev)) for p in layers]
    x = torch.randn((4, 1, cfg.d_model), device=dev, dtype=torch.bfloat16)
    active = torch.tensor([True, True, True, False], device=dev)

    def alone(p, c):
        return block_decode(p, x, c, 0, cfg=cfg, kind=kind, compute_dtype=torch.bfloat16)[0]

    def written(p, c):
        y, new = block_decode(p, x, c, 0, cfg=cfg, kind=kind, compute_dtype=torch.bfloat16)
        _write_back(c, new, active)
        return y

    return timed(alone, args, torch), timed(written, args, torch)


def phase_serve_recurrent(torch, dev, fp_sums):
    """Phase 5's traffic (4 slots, block 16, max_len 512, 8 requests of
    24..400 prompt tokens, 32 new tokens each) through full-width, 2-bit,
    bf16 mamba2-2.7b (4 of its 64 SSD layers) and recurrentgemma-2b (8 of
    its 26 layers: 2 RRL units + an RR tail; ``SERVE_LAYERS``), the latter
    from a bf16 pool and again,
    same artifact, under ``int8_fp`` (KV_F int8 attention pools).  Gates:
    launches by route as the layer counts give them, each serve repeated
    token-identical.  Beside each: pool bytes paged and resident, one
    recurrent layer's decode step against its projections' share (14a),
    with and without the write-back of its state,
    the tied head's dequantize + matmul, and a profiled decode window."""
    from repro_torch.models.layers import embed_logits

    out, eng = {}, None
    for arch, kv, seed in (("mamba2-2.7b", "bf16", 41), ("recurrentgemma-2b", "bf16", 43),
                           ("recurrentgemma-2b", "int8_fp", 43)):
        build = None
        if eng is not None and eng.cfg.name == arch:  # the same artifact, another pool
            art = (eng.params, out[f"{arch} bf16"]["params"], {})
            build = lambda cfg, s, art=art: art  # noqa: E731
        if eng is not None and build is None:
            del eng
            torch.cuda.empty_cache()
        row, eng, reqs, sc, tokens = phase_serve(torch, dev, arch, kv, seed, _recurrent_expected,
                                                 layers=SERVE_LAYERS.get(arch, 0), build=build)
        cfg = eng.cfg
        again = [list(map(int, c.tokens)) for c in eng.serve(reqs, sc)]
        row.update({"kinds": "".join(cfg.layer_kinds()), "repeat_tokens_identical": again == tokens,
                    "kv_pool_resident_bytes": row["kv_pool_bytes"] - row["kv_pool_paged_bytes"]})
        if kv == "bf16":  # the artifact's own numbers, once
            kind = "M" if cfg.family == "ssm" else "R"
            layer_ms, written_ms = _layer_decode_ms(torch, dev, eng, kind)
            proj = fp_sums[f"{arch} {kind} M=4"]["ms"]
            h = torch.randn((4, 1, cfg.d_model), device=dev, dtype=torch.bfloat16)
            row.update({
                f"{kind}_layer_decode_ms": layer_ms, f"{kind}_layer_projections_ms": proj,
                f"{kind}_layer_decode_ms_outside_projections": layer_ms - proj,
                f"{kind}_layer_decode_with_write_back_ms": written_ms,
                f"{kind}_layer_write_back_ms": written_ms - layer_ms,
                "head_dequant_matmul_ms": events_ms(
                    lambda: embed_logits(eng.params["embed"], h), 5, torch)})
        row["pass"] = row["pass"] and again == tokens
        out[f"{arch} {kv}"] = report(row)
        if kv == "bf16":
            row["profile"] = phase_profile(torch, dev, eng)
    del eng
    torch.cuda.empty_cache()
    return out


def phase_recurrent_card_vs_cpu(torch, dev):
    """Reduced mamba2 and recurrentgemma, 2-bit packed, fp32: a greedy serve
    on the card (the streaming matmul kernel, the GQA kernel) against the
    same serve on the CPU (the plain versions), under a pool that preempts:
    token-identical, and the kernels launched."""
    import numpy as np
    from repro_torch import configs
    from repro_torch.serve import Request, ServeConfig, ServeEngine

    rows = []
    for arch in RECURRENT_PARITY_LAYERS:
        cfg = configs.get_reduced(arch)
        packed = _recurrent_packed(torch, "cpu", cfg, 0)
        rng = np.random.default_rng(9)
        reqs = [Request(tokens=rng.integers(0, cfg.vocab_size, size=L), max_new_tokens=b)
                for L, b in ((14, 10), (13, 12), (11, 7), (5, 9))]
        sc = ServeConfig(n_slots=2, block_size=4, n_blocks=8)
        cpu, sched_cpu = ServeEngine(cfg, packed, max_len=32, compute_dtype=torch.float32,
                                     device="cpu").serve(reqs, sc, return_scheduler=True)
        zero_counts()
        card = ServeEngine(cfg, packed, max_len=32, compute_dtype=torch.float32,
                           device=dev).serve(reqs, sc)
        torch.cuda.synchronize()
        counts = {k: v for k, v in read_counts().items() if v}
        same = [c.tokens for c in card] == [c.tokens for c in cpu]
        row = {"phase": "card_vs_cpu", "arch": cfg.name, "tokens_identical": same,
               "preemptions": sched_cpu.stats["preemptions"], "launches": counts,
               "pass": (same and sched_cpu.stats["preemptions"] > 0
                        and counts.get("fixedpoint_matmul", 0) > 0
                        and (cfg.family == "ssm") == ("paged_attention" not in counts))}
        emit(row)
        if not row["pass"]:
            raise Failed(f"card vs cpu {arch}: {row}")
        rows.append(row)
    return rows


# ---------------------------------------------------------------------------
# phase 15: the encoder-decoder and VLM families (whisper's encoder and
# per-slot cross-kv, paligemma's image prefix under a prefix-LM mask): rows
# 1 and 2 at their shapes, kernel vs plain route, full-width serves, card
# vs CPU
# ---------------------------------------------------------------------------
WHISPER_ATTN = [(n, 1280, 1280) for n in ("q_proj", "k_proj", "v_proj", "o_proj")]
WHISPER_MLP = [("fc1", 1280, 5120), ("fc2", 5120, 1280)]
ENCDEC_VLM_FPMM = {  # (layer, M): its packed projections, K x N
    ("whisper-large-v3 decoder", 4): WHISPER_ATTN + [
        ("cross_q_proj", 1280, 1280), ("cross_k_proj", 1280, 1280),
        ("cross_v_proj", 1280, 1280), ("cross_o_proj", 1280, 1280)] + WHISPER_MLP,
    ("whisper-large-v3 encoder", 1500): WHISPER_ATTN + WHISPER_MLP,
    ("paligemma-3b", 4): [("q_proj", 2048, 2048), ("k_proj", 2048, 256), ("v_proj", 2048, 256),
                          ("o_proj", 2048, 2048), ("gate_proj", 2048, 16384),
                          ("up_proj", 2048, 16384), ("down_proj", 16384, 2048)],
}
ENCDEC_VLM_FPMM[("paligemma-3b", 256 + 512)] = ENCDEC_VLM_FPMM[("paligemma-3b", 4)]
ENCDEC_VLM_ATTN = {  # decode shapes, ~300 text tokens a row (+ paligemma's 256 patches)
    "whisper-large-v3": dict(B=4, K=20, G=1, hd=64, block=16, max_blocks=32,
                             pos_last=(280, 320)),
    "paligemma-3b": dict(B=4, K=1, G=8, hd=256, block=16, max_blocks=48, pos_last=(536, 576)),
}
ENCDEC_VLM_PARITY = {"whisper-large-v3": 4, "paligemma-3b": 4}
# packed matmul launches: whisper's admission runs the encoder's 6 a layer at
# M 1,500 and the decoder's 10 a layer (self q / k / v / o, cross q / o at the
# bucket's rows, cross k / v at 1,500, fc1, fc2); a decode step the decoder's
# 8 (no cross k / v: the cross-kv is resident); paligemma 7 a layer both ways
PACKED_ENC_LAYER, PACKED_DEC_ADMIT, PACKED_DEC_STEP, PACKED_VLM_LAYER = 6, 10, 8, 7


def _encdec_vlm_counts(cfg):
    """(packed matmuls an admission, a decode step) of ``cfg``."""
    if cfg.family == "encdec":
        return (PACKED_ENC_LAYER * cfg.n_encoder_layers + PACKED_DEC_ADMIT * cfg.n_layers,
                PACKED_DEC_STEP * cfg.n_layers)
    return PACKED_VLM_LAYER * cfg.n_layers, PACKED_VLM_LAYER * cfg.n_layers


def phase_fpmm_encdec_vlm(torch, dev):
    """Row 1 at the new families' shapes, 2-bit, bf16: whisper's decoder
    layer (its 10 projections, biased) at M 4 and its encoder layer (6,
    biased) at M 1,500; paligemma's layer (7) at M 4 and at 256 + 512 (the
    image prefix and the serve's largest bucket).  Each holds its rule's
    kernel to the plain version and times it beside the streaming kernel,
    ``torch.matmul`` and the bound.  Returns the rows and each layer's sums."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(16)
    keys = ("ms", "stream_ms", "plain_ms", "library_ms", "bound_ms")
    rows, sums = [], {}
    for (layer, M), shapes in ENCDEC_VLM_FPMM.items():
        acc = sums[f"{layer} M={M}"] = dict.fromkeys(keys, 0.0)
        for name, K, N in shapes:
            row = _fpmm_case(torch, gen, dev, name, K, N, M, torch.bfloat16, 2,
                             with_bias=layer.startswith("whisper"), timing=True,
                             routes=_bf16_routes(torch.bfloat16, M))
            row["arch"] = layer
            for k in keys:
                acc[k] += row[k]
            emit(row)
            rows.append(row)
            if not row["pass"]:
                raise Failed(f"fixedpoint_matmul {layer} {name} M={M}: err {_err(row)}")
        acc["route"] = rows[-1]["route"]
        acc["bound_by"] = _bound_by(rows[-len(shapes):])
        torch.cuda.empty_cache()
    return rows, sums


def phase_attn_encdec_vlm(torch, dev):
    """Row 2 at whisper's decode shape (MHA, hd 64) and paligemma's (MQA,
    G 8, hd 256, over the image prefix and the text), each from a bf16 pool
    and from a KV_F int8 pool (the pool an ``int8_fp`` engine of a
    non-decoder family serves from), against the plain version and SDPA."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(17)
    return [_attn_dense_case(torch, gen, dev, dict(shape),
                             dict(T=1, dt=torch.bfloat16, int8=int8, q_mult=1.0, window=None,
                                  cap=0.0, scale=shape["hd"]**-0.5, arch=arch))
            for arch, shape in ENCDEC_VLM_ATTN.items() for int8 in (False, True)]


def phase_parity_encdec_vlm(torch, dev, arch: str, layers: int):
    """Logits through the kernels against the plain paths, at full width
    and ``layers`` deep (whisper: as many encoder layers too), fp32, 2-bit
    packed, a bf16 pool: two prompts, each with its own frames / patches,
    admitted by the engine's own admission step (bucketed prefill, the
    self-attention k/v scattered into the pool from the image prefix on,
    whisper's cross-kv copied into the slot rows), then 4 teacher-forced
    paged decode steps.  The kernel route runs every packed projection on
    the streaming kernel (fp32 x) and the decode self-attention on the GQA
    kernel; the plain route neither.  The two routes' cross-kv rows are
    compared too."""
    import numpy as np
    from repro_torch import configs
    from repro_torch.kernels import dispatch
    from repro_torch.models import decode_lm
    from repro_torch.serve import ServeConfig, ServeEngine
    from repro_torch.serve import engine as eng_mod
    from repro_torch.serve.scheduler import Scheduler

    cfg = dataclasses.replace(configs.get_config(arch), n_layers=layers)
    if cfg.family == "encdec":
        cfg = dataclasses.replace(cfg, n_encoder_layers=layers)
    from repro_torch.models.lm import image_prefix_len

    packed = _recurrent_packed(torch, dev, cfg, 12)
    off = image_prefix_len(cfg)
    max_len, block, steps = 128 + off, 16, 4
    gen = torch.Generator(device="cpu")
    gen.manual_seed(4)
    lens = [37, 70]
    prompts = [torch.randint(0, cfg.vocab_size, (L,), generator=gen) for L in lens]
    forced = torch.randint(0, cfg.vocab_size, (steps, len(lens)), generator=gen)
    rng = np.random.default_rng(4)
    extras = [stub_extras(cfg, rng) for _ in lens]
    n_admit, n_step = _encdec_vlm_counts(cfg)
    logits, launches, cross = {}, {}, {}
    for path, (pb, ab) in {"kernels": ("kernel", "fused"), "plain": ("unpack", "composed")}.items():
        dispatch.set_packed_backend(pb)
        dispatch.set_attention_backend(ab)
        eng = ServeEngine(cfg, packed, max_len=max_len, compute_dtype=torch.float32, device=dev)
        dispatch.set_packed_backend("auto")
        dispatch.set_attention_backend("auto")
        sched = Scheduler(eng, ServeConfig(n_slots=len(lens), block_size=block))
        caches, groups = sched.caches, sched._groups
        del sched
        nb = -(-max_len // block)
        bt = (torch.arange(len(lens) * nb, device=dev, dtype=torch.int32) + 1).reshape(len(lens),
                                                                                       nb)
        fns = eng.scheduler_fns(greedy=True, top_k=0)
        zero_counts()
        rec, restore = _capture_admission_logits(torch, eng_mod)
        try:
            for b, pr in enumerate(prompts):
                L = int(pr.shape[0])
                bucket = 1 << (L - 1).bit_length()
                tokens = torch.zeros((1, bucket), dtype=torch.int32, device=dev)
                tokens[0, :L] = pr.to(dev)
                batch = {"tokens": tokens, **{k: torch.from_numpy(v).to(dev)
                                              for k, v in extras[b].items()}}
                _, caches = eng._with_backend(fns.admit_step(bucket, block), eng.params, batch, L,
                                              caches, bt[b], b, 0, 0, 1.0)
        finally:
            restore()
        outs = list(rec["logits"])
        pos = torch.tensor(lens, dtype=torch.int32, device=dev) + off
        active = torch.ones(len(lens), dtype=torch.bool, device=dev)
        for s in range(steps):
            lg, caches = eng._with_backend(decode_lm, eng.params, caches,
                                           forced[s].to(dev)[:, None].to(torch.int32), pos, cfg,
                                           compute_dtype=torch.float32, active=active,
                                           block_tables=bt)
            outs.extend(lg[:, 0])
            pos = pos + 1
        torch.cuda.synchronize()
        logits[path] = torch.stack(outs)
        launches[path] = {k: v for k, v in read_counts().items() if v}
        cross[path] = {p: t for p, t in _resident(caches, groups).items() if "cross" in p}
        del eng, caches
    a, b = logits["kernels"], logits["plain"]
    err = (a - b).abs().max().item()
    agree = (a.argmax(-1) == b.argmax(-1)).float().mean().item()
    finite = bool(torch.isfinite(a).all().item())
    want = {"kernels": {"fixedpoint_matmul": n_admit * len(lens) + n_step * steps,
                        "paged_attention": cfg.n_layers * steps}, "plain": {}}
    cross_err = {p: (t.float() - cross["plain"][p].float()).abs().max().item()
                 for p, t in cross["kernels"].items()}
    del packed, cross
    torch.cuda.empty_cache()
    row = {"phase": "parity", "arch": arch, "layers": layers,
           "encoder_layers": cfg.n_encoder_layers if cfg.family == "encdec" else 0,
           "n_bits": 2, "kv_cache_dtype": "bf16", "compute": "float32", "prompts": lens,
           "decode_steps": steps, "logit_rows": int(a.shape[0]), "max_abs_logit_err": err,
           "atol": PARITY_ATOL, "logit_scale": a.abs().max().item(), "argmax_agreement": agree,
           "finite": finite, "launches": launches, "expected_launches": want,
           "cross_kv_max_abs_err": cross_err,
           "admission": "bucketed prefill + block scatter + slot-row copy",
           "pass": finite and err <= PARITY_ATOL and agree == 1.0 and launches == want}
    emit(row)
    if not row["pass"]:
        raise Failed(f"parity {arch}: {row}")
    return row


def _encdec_vlm_expected(cfg, st, buckets):
    """Launches of a bf16 serve of whisper or paligemma: every packed
    projection once an admission (all at tensor-core rows: the buckets are
    >= 32, whisper's encoder and cross k / v at 1,500) and once a decode
    step (4 slots: the decode kernel; whisper's cross k / v not at all),
    the GQA kernel once a layer and decode step over a bf16 or a KV_F int8
    pool alike.  The tied heads dequantize their tables: no launch."""
    n_admit, n_step = _encdec_vlm_counts(cfg)
    return {**_matmul_counts(n_admit, 0, st["decode_steps"], buckets, decode_2d=n_step),
            "paged_attention": cfg.n_layers * st["decode_steps"], "paged_attention_quant": 0,
            **dict.fromkeys(MLA_COUNTS + PREFILL_COUNTS, 0), "symog_update": 0}


def _timed_encoder(torch):
    """Wrap ``models.lm._run_encoder`` with a synchronised host clock: the
    encoder's ms in each admission.  Returns (record, restore)."""
    from repro_torch.models import lm

    inner, rec = lm._run_encoder, []

    def run(*a, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = inner(*a, **kw)
        torch.cuda.synchronize()
        rec.append((time.perf_counter() - t) * 1e3)
        return out

    lm._run_encoder = run
    return rec, lambda: setattr(lm, "_run_encoder", inner)


def phase_serve_encdec_vlm(torch, dev):
    """Phase 5's traffic (4 slots, block 16, 8 requests of 24..400 prompt
    tokens, 32 new tokens each; each request its own frames / patches)
    through full-width, 2-bit, bf16 whisper-large-v3 (``SERVE_LAYERS``: 2
    of its 32 encoder and 2 of its 32 decoder layers, max_len 512) and
    paligemma-3b (9 of its 18 layers, max_len 512
    + 256), each from a bf16 pool and again, same artifact, under
    ``int8_fp`` (KV_F int8 pools: the non-decoder rule).  Gates: launches
    by route as the layer counts give them, each serve repeated
    token-identical.  Beside each: pool bytes paged and resident (whisper's
    cross-kv, layers x 2 x 1,500 x 1,280 x 2 B a slot), admission seconds and
    the encoder's share of them, the tied head's dequantize + matmul, and
    a profiled decode window."""
    from repro_torch.models.layers import embed_logits

    out, eng = {}, None
    for arch, kv, seed in (("whisper-large-v3", "bf16", 51), ("whisper-large-v3", "int8_fp", 51),
                           ("paligemma-3b", "bf16", 53), ("paligemma-3b", "int8_fp", 53)):
        build = None
        if eng is not None and eng.cfg.name == arch:  # the same artifact, another pool
            art = (eng.params, out[f"{arch} bf16"]["params"], {})
            build = lambda cfg, s, art=art: art  # noqa: E731
        if eng is not None and build is None:
            del eng
            torch.cuda.empty_cache()
        max_len = 512 + (256 if arch == "paligemma-3b" else 0)  # paligemma's prefix
        enc, restore = _timed_encoder(torch)
        try:
            row, eng, reqs, sc, tokens = phase_serve(torch, dev, arch, kv, seed,
                                                     _encdec_vlm_expected, build=build,
                                                     layers=SERVE_LAYERS.get(arch, 0),
                                                     max_len=max_len)
        finally:
            restore()
        cfg = eng.cfg
        again = [list(map(int, c.tokens)) for c in eng.serve(reqs, sc)]
        row.update({"repeat_tokens_identical": again == tokens,
                    "kv_pool_resident_bytes": row["kv_pool_bytes"] - row["kv_pool_paged_bytes"]})
        if cfg.family == "encdec":
            row["encoder_ms"] = enc[: row["prefills"]]
            row["encoder_share_of_prefill"] = sum(row["encoder_ms"]) / 1e3 / row["prefill_s"]
            row["cross_kv_bytes_per_slot"] = row["kv_pool_resident_bytes"] // 4
        if kv == "bf16":
            h = torch.randn((4, 1, cfg.d_model), device=dev, dtype=torch.bfloat16)
            row["head_dequant_matmul_ms"] = events_ms(
                lambda: embed_logits(eng.params["embed"], h), 5, torch)
        row["pass"] = row["pass"] and again == tokens
        out[f"{arch} {kv}"] = report(row)
        if kv == "bf16":
            row["profile"] = phase_profile(torch, dev, eng)
    del eng
    torch.cuda.empty_cache()
    return out


def phase_encdec_vlm_card_vs_cpu(torch, dev):
    """Reduced whisper and paligemma, 2-bit packed, fp32, each request with
    its own frames / patches: a greedy serve on the card (the streaming
    matmul kernel, the GQA kernel) against the same serve on the CPU (the
    plain versions), under a pool that preempts: token-identical, and the
    kernels launched."""
    import numpy as np
    from repro_torch import configs
    from repro_torch.models.lm import image_prefix_len
    from repro_torch.serve import Request, ServeConfig, ServeEngine

    rows = []
    for arch in ENCDEC_VLM_PARITY:
        cfg = configs.get_reduced(arch)
        packed = _recurrent_packed(torch, "cpu", cfg, 0)
        rng = np.random.default_rng(10)
        off = image_prefix_len(cfg)
        shape = ((6, 14), (5, 16), (7, 10), (3, 9)) if off else ((14, 10), (13, 12), (11, 7),
                                                                (5, 9))
        reqs = [Request(tokens=rng.integers(0, cfg.vocab_size, size=L), max_new_tokens=b,
                        extras=stub_extras(cfg, rng)) for L, b in shape]
        max_len = 32 + off
        sc = ServeConfig(n_slots=2, block_size=4, n_blocks=max_len // 4)
        cpu, sched_cpu = ServeEngine(cfg, packed, max_len=max_len, compute_dtype=torch.float32,
                                     device="cpu").serve(reqs, sc, return_scheduler=True)
        zero_counts()
        card = ServeEngine(cfg, packed, max_len=max_len, compute_dtype=torch.float32,
                           device=dev).serve(reqs, sc)
        torch.cuda.synchronize()
        counts = {k: v for k, v in read_counts().items() if v}
        same = [c.tokens for c in card] == [c.tokens for c in cpu]
        row = {"phase": "card_vs_cpu", "arch": cfg.name, "tokens_identical": same,
               "preemptions": sched_cpu.stats["preemptions"], "launches": counts,
               "pass": (same and sched_cpu.stats["preemptions"] > 0
                        and counts.get("fixedpoint_matmul", 0) > 0
                        and counts.get("paged_attention", 0) > 0)}
        emit(row)
        if not row["pass"]:
            raise Failed(f"card vs cpu {arch}: {row}")
        rows.append(row)
    return rows


# ---------------------------------------------------------------------------
# phase 16: SYMOG training of the recurrent, encoder-decoder and VLM
# families at full width, each trained tree packed and served; the reduced
# configs card vs CPU
# ---------------------------------------------------------------------------
FAMILY_TRAIN_SEQ = {"mamba2-2.7b": 512, "recurrentgemma-2b": 512, "whisper-large-v3": 448,
                    "paligemma-3b": 512}  # whisper's decoder takes 448 positions
FAMILY_TRAIN_STEPS = 3
TRAIN_BATCH = 4
CARD_BYTES = 80e9
FP32_EXP_LIMIT = 88.72  # log of fp32's largest value: exp overflows past it


def _peak_reckoning(cfg, n_params: int, seq: int) -> int:
    """Peak device bytes a SYMOG step should need, reckoned before it runs:
    20 B a parameter (fp32 master, its grad and momentum, the bf16 copy and
    that copy's grad) and, with each layer recomputed in the backward, the
    head's fp32 logits three times (logits, log-softmax, their grad) and
    whisper's encoder scores of one layer three times."""
    act = 3 * TRAIN_BATCH * seq * cfg.vocab_size * 4
    if cfg.family == "encdec":
        act += 3 * TRAIN_BATCH * cfg.n_heads * cfg.encoder_len ** 2 * 4
    return 20 * n_params + act


def _n_params(torch, cfg) -> int:
    """The parameter count from shapes alone (``FakeTensorMode``: nothing
    allocated)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.models import init_lm
    from repro_torch.nn.tree import tree_leaves

    with FakeTensorMode():
        return sum(t.numel() for t in tree_leaves(init_lm(0, cfg, device="cpu")))


def _bf16_copy(torch, params):
    """The training step's compute copy (``make_train_step``'s
    ``cast_params``): every fp32 leaf of rank >= 1 in bf16."""
    from repro_torch.nn.tree import tree_map

    return tree_map(lambda p: p.to(torch.bfloat16)
                    if p.dtype == torch.float32 and p.ndim >= 1 else p, params)


def _family_leaf_timing(torch, state, grads, scfg, *, lam, lr, arch):
    """The largest quantizable leaf of a trained tree: ``symog_update`` on
    copies of its weights and momentum against the plain version
    (``symog_update_ref``) at SYMOG_TOL, then both timed on it (CUDA events),
    with the leaf's byte bound."""
    from repro_torch.core.quantizer import delta_from_f
    from repro_torch.kernels.symog_update import ops as sops
    from repro_torch.kernels.symog_update.ref import symog_update_ref
    from repro_torch.nn.tree import flatten_with_paths

    g_by, v_by, f_by = (dict(flatten_with_paths(t)) for t in (grads, state.opt_state,
                                                                state.symog.f))
    path, w = max(((p, w) for p, w in flatten_with_paths(state.params) if state.symog.mask[p]),
                  key=lambda pw: pw[1].numel())
    n = w.numel()
    g, v = g_by[path].contiguous(), v_by[path]
    kw = dict(delta=delta_from_f(f_by[path], device=w.device), lam_eff=lam * 2.0 / n, lr=lr,
              mu=0.9, n_bits=scfg.n_bits)
    wk, vk = w.clone(), v.clone()
    sops.symog_update(wk, g, vk, **kw)
    w_ref, v_ref = symog_update_ref(w, g, v, **kw)
    err = max((wk - w_ref).abs().max().item(), (vk - v_ref).abs().max().item())
    ok = bool(torch.allclose(wk, w_ref, **SYMOG_TOL) and torch.allclose(vk, v_ref, **SYMOG_TOL))
    del w_ref, v_ref
    b_ms, b_by = bound(20 * n, SYMOG_FLOPS * n, "float32")
    row = {"phase": "kernel", "kernel": "symog_update", "case": "family_leaf", "arch": arch,
           "leaf": path, "shape": list(w.shape), "f_shape": list(f_by[path].shape), "n": n,
           "n_bits": scfg.n_bits, "max_abs_err": err, "tol": SYMOG_TOL,
           "ms": events_ms(lambda: sops.symog_update(wk, g, vk, **kw), 5, torch),
           "plain_ms": events_ms(lambda: symog_update_ref(w, g, v, **kw), 3, torch),
           "bound_ms": b_ms, "bound_by": b_by, "pass": ok}
    row["achieved_GBps"] = 20 * n / (row["ms"] * 1e-3) / 1e9
    emit(row)
    del wk, vk
    if not ok:
        raise Failed(f"symog_update at {arch}'s {path} {list(w.shape)}: err {err}")
    return row


def _ssd_upper_exponents(torch, params, cfg, batch):
    """The SSD decay's largest exponent above the diagonal, cum_0 - cum_{Q-1}
    = Σ dt·|A| over a chunk's last Q - 1 steps, in a no-grad forward of
    ``batch`` under the training step's bf16 copy: (the largest over every
    layer, chunk and head; the layers whose largest passes fp32's exp
    limit; the layers)."""
    from repro_torch.models import lm_train_loss
    from repro_torch.models import ssd as ssd_mod

    inner, tops = ssd_mod.ssd_scan_ref, []

    def probe(x, dt, A, Bm, Cm, *, chunk):
        B, T, H = dt.shape
        cum = torch.cumsum((dt.to(torch.float32) * A).reshape(B, T // chunk, chunk, H), dim=2)
        tops.append((cum[:, :, 0] - cum[:, :, -1]).max())
        return inner(x, dt, A, Bm, Cm, chunk=chunk)

    ssd_mod.ssd_scan_ref = probe
    try:
        with torch.no_grad():
            lm_train_loss(_bf16_copy(torch, params), batch, cfg, compute_dtype=torch.bfloat16)
    finally:
        ssd_mod.ssd_scan_ref = inner
    vals = [float(t) for t in tops]
    return max(vals), sum(v > FP32_EXP_LIMIT for v in vals), len(vals)


def _all_finite(torch, tree) -> bool:
    from repro_torch.nn.tree import tree_leaves

    return bool(torch.stack([torch.isfinite(t).all() for t in tree_leaves(tree)]).all())


def phase_train_family(torch, dev, arch: str, seed: int):
    """SYMOG training of ``arch`` at every published width and all its
    layers but ``FAMILY_TRAIN_LAYERS``' cuts (cut further only where
    ``_peak_reckoning`` passes the card's 80 GB; the cut and the reckoning
    are printed): fp32 master weights, bf16 compute
    through a bf16 copy (``cast_params``), 2-bit, remat on, 4 rows of
    FAMILY_TRAIN_SEQ tokens (whisper with its frames, paligemma with its
    patches).  Step 1 first from one set of grads: the fused update against
    the composed one leaf by leaf at TRAIN_TOL (``_step1_fused_vs_composed``),
    and on the largest quantizable leaf the kernel against its plain version,
    both timed (``_family_leaf_timing``).  Then FAMILY_TRAIN_STEPS fused
    steps through ``make_train_step``
    (the last under torch.profiler: device busy ms, idle share, GEMM ms,
    ``symog_update``'s ms, top kernels), each with its ms, peak bytes,
    loss / ce, λ and ``symog_update`` launches (one a quantizable leaf);
    gate: grad norm, every param and every momentum leaf finite.  mamba2
    first prints the SSD decay's
    largest exponent above the diagonal.  Then the trained tree goes
    through ``pack_tree`` into a bf16-pool engine: one greedy request of 64
    prompt tokens and 16 new, launches as the route rule gives them, the
    tokens identical on a repeat."""
    from repro_torch import configs, core, optim
    from repro_torch.core import pack_tree
    from repro_torch.kernels.symog_update import ops as sops
    from repro_torch.models import init_lm, lm_train_loss
    from repro_torch.models.lm import image_prefix_len
    from repro_torch.nn.tree import flatten_with_paths
    from repro_torch.train import init_train_state, make_train_step
    from repro_torch.train.trainer import _accum_grads

    full = cfg = configs.get_config(arch)
    seq = FAMILY_TRAIN_SEQ[arch]
    if arch in FAMILY_TRAIN_LAYERS:  # an encoder-decoder's encoder with its decoder
        n = FAMILY_TRAIN_LAYERS[arch]
        cfg = dataclasses.replace(cfg, n_layers=n, **(
            {"n_encoder_layers": n} if cfg.n_encoder_layers else {}))
    while _peak_reckoning(cfg, _n_params(torch, cfg), seq) > CARD_BYTES:
        cfg = dataclasses.replace(cfg, n_layers=cfg.n_layers - 1)
    n_params = _n_params(torch, cfg)
    cut = f"depth {full.n_layers} -> {cfg.n_layers}" if cfg is not full else None
    emit({"phase": "train_family_plan", "arch": arch, "params": n_params,
          "reckoned_peak_bytes_full_depth": _peak_reckoning(full, _n_params(torch, full), seq),
          "reckoned_peak_bytes": _peak_reckoning(cfg, n_params, seq), "card_bytes": CARD_BYTES,
          "layers": cfg.n_layers, "encoder_layers": cfg.n_encoder_layers or None, "cut": cut})

    torch.cuda.empty_cache()
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    params = init_lm(gen, cfg, device=dev)  # fp32 master weights
    tx = optim.sgd(momentum=0.9)
    scfg = core.SymogConfig(n_bits=2, total_steps=FAMILY_TRAIN_STEPS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = init_train_state(params, tx, scfg)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    del params
    n_quant = sum(state.symog.mask.values())
    quant_shapes = {p: list(w.shape) for p, w in flatten_with_paths(state.params)
                    if state.symog.mask[p]}
    batches = train_batches(torch, dev, cfg, seq, FAMILY_TRAIN_STEPS, seed)
    probe = None
    if cfg.family == "ssm":
        top, over, calls = _ssd_upper_exponents(torch, state.params, cfg, batches[0])
        probe = {"max_upper_exponent": top, "layers_past_fp32_exp_limit": over,
                 "layers": calls, "fp32_exp_limit": FP32_EXP_LIMIT}
        emit({"phase": "ssd_decay_exponent", "arch": arch, **probe})
        torch.cuda.empty_cache()

    # step 1 from one set of grads (through the step's bf16 copy): the fused
    # update against the composed one leaf by leaf at these leaf shapes, then
    # the kernel against its plain version, both timed, on the largest leaf
    lr_fn = core.linear_lr(0.01, 0.001, FAMILY_TRAIN_STEPS)

    def loss_fn(p, b):
        return lm_train_loss(_bf16_copy(torch, p), b, cfg, compute_dtype=torch.bfloat16)

    _, _, grads = _accum_grads(loss_fn, state.params, batches[0], 1)
    cmp = _step1_fused_vs_composed(torch, state, grads, scfg, tx, lam=core.lambda_at(scfg, 0),
                                   lr=lr_fn(0), arch=arch)
    torch.cuda.empty_cache()
    leaf = _family_leaf_timing(torch, state, grads, scfg, lam=core.lambda_at(scfg, 0),
                               lr=lr_fn(0), arch=arch)
    del grads
    torch.cuda.empty_cache()

    step = make_train_step(cfg, tx, lr_fn, symog_cfg=scfg, compute_dtype=torch.bfloat16,
                           cast_params=True)
    rows, finite, prof = [], True, None
    zero_counts()
    for i, batch in enumerate(batches):
        before = sops.launches
        torch.cuda.reset_peak_memory_stats(dev)
        if i == len(batches) - 1:  # the last step under torch.profiler
            state, m, upd_ms, prof, wall = _profiled_step(torch, step, state, batch)
            prof = {"update_device_ms": upd_ms, **(prof or {})}
        else:
            state, m, wall = _timed_step(torch, step, state, batch)
        ok = (math.isfinite(m["grad_norm"].item()) and _all_finite(torch, state.params)
              and _all_finite(torch, state.opt_state))
        finite = finite and ok
        rows.append({"step": i, "ms": wall, "profiled": prof is not None,
                     "peak_device_bytes": torch.cuda.max_memory_allocated(dev),
                     "loss": m["loss"].item(), "ce": m["ce"].item(),
                     "grad_norm": m["grad_norm"].item(), "symog_lambda": m["symog_lambda"],
                     "lr": m["lr"], "symog_update_launches": sops.launches - before,
                     "finite": ok})
        emit({"phase": "train_step", "arch": arch, **rows[-1]})
    counts = read_counts()
    row = {"phase": "train_family", "arch": arch, "family": cfg.family, "layers": cfg.n_layers,
           "encoder_layers": cfg.n_encoder_layers or None, "cut": cut, "d_model": cfg.d_model,
           "vocab": cfg.vocab_size, "params": n_params, "quantizable_leaves": n_quant,
           "quantizable_shapes": quant_shapes, "batch": [TRAIN_BATCH, seq],
           "extras": {k: list(v.shape) for k, v in batches[0].items() if k != "tokens"},
           "compute": "bfloat16 (cast_params)", "master": "float32", "n_bits": 2,
           "remat": cfg.remat,
           "optimizer": "sgd nesterov 0.9, linear_lr 0.01->0.001, SYMOG lambda0 10 alpha 9",
           "symog_init_s": init_s, "steps": rows,
           "step_ms": [r["ms"] for r in rows],
           "peak_device_bytes": max(r["peak_device_bytes"] for r in rows),
           "reckoned_peak_bytes": _peak_reckoning(cfg, n_params, seq),
           "symog_update_launches": counts["symog_update"], "ssd_probe": probe,
           "step1_fused_vs_composed_max_abs_err": cmp["max_abs_err"],
           "largest_leaf_update": {k: leaf[k] for k in ("leaf", "shape", "f_shape", "ms",
                                                        "plain_ms", "bound_ms", "bound_by",
                                                        "achieved_GBps", "max_abs_err")},
           "profile": prof}
    row["pass"] = (finite and all(r["symog_update_launches"] == n_quant for r in rows)
                   and counts["symog_update"] == n_quant * FAMILY_TRAIN_STEPS
                   and all(v == 0 for k, v in counts.items() if k != "symog_update"))
    emit(row)
    if not row["pass"]:
        raise Failed(f"train {arch} failed: {row}")

    # the trained tree, packed, served from a bf16 pool; the request again
    packed = pack_tree(state.params, state.symog, scfg)
    del state, batches, step
    torch.cuda.empty_cache()
    expected = _recurrent_expected if cfg.family in ("ssm", "hybrid") else _encdec_vlm_expected
    srow, eng, reqs, sc, tokens = phase_serve(
        torch, dev, arch, "bf16", seed, expected,
        layers=cfg.n_layers if cut else 0,
        build=lambda c, s: (packed, n_params, {}), max_len=128 + image_prefix_len(cfg),
        lens=[64], new_tokens=16)
    del packed
    again = [list(map(int, c.tokens)) for c in eng.serve(reqs, sc)]
    serve = {"phase": "train_serve", "arch": arch, "tokens": tokens,
             "repeat_tokens_identical": again == tokens, "launches": srow["launches"],
             "expected_launches": srow["expected_launches"],
             "decode_step_ms": srow["decode_step_ms"], "prefill_ms": srow["prefill_ms"],
             "weight_bytes": srow["weight_bytes"]}
    serve["pass"] = srow["pass"] and serve["repeat_tokens_identical"]
    emit(serve)
    del eng
    torch.cuda.empty_cache()
    if not serve["pass"]:
        raise Failed(f"serving the trained {arch} failed: {serve}")
    row["serve_launches"] = srow["launches"]
    return row


# ---------------------------------------------------------------------------
# phase 17: the training launcher with the clipped optimizer, its checkpoints,
# the clipped update's kernel forms, and the paper's experiments and examples
# ---------------------------------------------------------------------------
LAUNCH_ARGS = ["--arch", "internlm2-1.8b", "--steps", "4", "--batch", "8", "--seq", "128",
               "--symog", "--log-every", "1"]
SQNORM_FLOPS = 11  # per element: div, rint, 2 min/max, 3 mul, sub, add, the square's mul, add
# the norm pass against its plain version: both sum 4e8 fp32 terms, in other
# orders (each within ~1e-7 of the fp64 sum at internlm2's largest leaf)
SQNORM_RTOL = 1e-5
CLIPPED_FLOPS = SYMOG_FLOPS + 1  # the update and its ×s


def _launch_args(extra=()):
    from repro_torch.launch import train as tlaunch

    return tlaunch.build_parser().parse_args(LAUNCH_ARGS + list(extra))


def _step1_clipped_fused_vs_composed(torch, dev, cfg, args):
    """The launcher's first step from its own init and first batch: the fused
    clipped update over the whole tree (on copies) against the composed
    chain, leaf by leaf: g + λ·r, the clip's scale over every leaf in path
    order, SGD-Nesterov, ``apply_updates``, ``clip_tree``, as JAX's
    ``tx.update`` composes them (whole-tree temporaries would not fit)."""
    from repro_torch import core, optim
    from repro_torch.data import SyntheticLM, SyntheticLMConfig
    from repro_torch.models import init_lm, lm_train_loss
    from repro_torch.nn.tree import flatten_with_paths, tree_map
    from repro_torch.train import fused_update, init_train_state
    from repro_torch.train.trainer import _accum_grads, _clip_scale

    tx = optim.chain(optim.clip_by_global_norm(1.0), optim.sgd(momentum=0.9, nesterov=True))
    sgd = optim.sgd(momentum=0.9, nesterov=True)
    scfg = core.SymogConfig(n_bits=args.n_bits, total_steps=args.steps)
    state = init_train_state(init_lm(args.seed, cfg, device=dev), tx, scfg)
    data = SyntheticLM(SyntheticLMConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                                         global_batch=args.batch, seed=args.seed))
    batch = {k: torch.as_tensor(v, device=dev) for k, v in next(data).items()}
    _, _, grads = _accum_grads(
        lambda p, b: lm_train_loss(p, b, cfg, compute_dtype=torch.bfloat16), state.params,
        batch, 1)
    lam, lr = core.lambda_at(scfg, 0), core.linear_lr(args.lr, args.lr / 10, args.steps)(0)
    fp, fv = tree_map(torch.clone, state.params), tree_map(torch.clone, state.opt_state[1])
    stats = {}
    fused_update(fp, grads, ((), fv), state.symog, scfg, tx, lr=lr, lam=lam, stats=stats)
    torch.cuda.synchronize()

    g_by, v_by, fp_by, fv_by = (dict(flatten_with_paths(t)) for t in (
        grads, state.opt_state[1], fp, fv))
    f_by = dict(flatten_with_paths(state.symog.f))

    def total(path, w):  # g + λ·∂R/∂w of one leaf, as composed_update forms it
        sub = core.SymogState(f={"w": f_by[path]}, mask={"w": state.symog.mask[path]})
        return g_by[path] + lam * core.reg_grad({"w": w}, sub, scfg)["w"], sub

    with torch.no_grad():
        sq = sum(torch.sum(torch.square(total(p, w)[0])) for p, w in
                 flatten_with_paths(state.params))
        scale = _clip_scale(1.0, torch.sqrt(sq))
        rows, worst, all_ok = [], 0.0, True
        for path, w in flatten_with_paths(state.params):
            t, sub = total(path, w)
            upd, v_new = sgd.update({"w": t * scale}, {"w": v_by[path]}, {"w": w}, lr=lr)
            w_new = optim.apply_updates({"w": w}, upd)
            if sub.mask["w"]:
                w_new = core.clip_tree(w_new, sub, scfg)
            errs = [(fp_by[path] - w_new["w"]).abs().max().item(),
                    (fv_by[path] - v_new["w"]).abs().max().item()]
            ok = bool(torch.allclose(fp_by[path], w_new["w"], **TRAIN_TOL)
                      and torch.allclose(fv_by[path], v_new["w"], **TRAIN_TOL))
            rows.append([path, list(w.shape), errs[0], errs[1], ok])
            worst, all_ok = max(worst, *errs), all_ok and ok
            del t, upd, v_new, w_new
    s_fused, s_comp = stats["clip_scale"].item(), scale.item()
    row = {"phase": "launcher_step1_clipped_fused_vs_composed", "arch": cfg.name,
           "tol": TRAIN_TOL, "leaves": rows, "max_abs_err": worst, "clip_scale_fused": s_fused,
           "clip_scale_composed": s_comp,
           "pass": all_ok and s_fused < 1.0 and math.isclose(s_fused, s_comp, rel_tol=1e-5)}
    emit(row)
    del state, grads, fp, fv, g_by, v_by, fp_by, fv_by
    torch.cuda.empty_cache()
    if not row["pass"]:
        raise Failed("launcher: the fused clipped step 1 disagrees with the composed chain, or "
                     f"the clip was not active: scales {s_fused} / {s_comp}")
    return row


def phase_launcher(torch, dev):
    """17a: the launcher's main path at internlm2's full width and depth."""
    from repro_torch import configs
    from repro_torch.kernels.symog_update import ops as sops
    from repro_torch.launch import train as tlaunch

    cfg = configs.get_config("internlm2-1.8b")
    args = _launch_args()
    step1 = _step1_clipped_fused_vs_composed(torch, dev, cfg, args)
    per_step = []

    def on_step(i, state, metrics):
        per_step.append((sops.sqnorm_launches, sops.launches))

    torch.cuda.reset_peak_memory_stats(dev)
    zero_counts()
    sops.sqnorm_launches = 0
    out = tlaunch.run(cfg, args, on_step=on_step)
    counts = dict(read_counts(), symog_sqnorm=sops.sqnorm_launches)
    peak = torch.cuda.max_memory_allocated(dev)
    n_quant = sum(out["state"].symog.mask.values())
    steps = len(out["losses"])
    launches = [(a - pa, b - pb) for (a, b), (pa, pb) in zip(per_step, [(0, 0)] + per_step)]
    row = {"phase": "launcher", "arch": cfg.name, "layers": cfg.n_layers, "argv": LAUNCH_ARGS,
           "compute": "bfloat16", "optimizer": "chain(clip_by_global_norm(1.0), "
           "sgd(momentum=0.9, nesterov=True)), linear_lr 0.01->0.001, SYMOG 2-bit",
           "losses": out["losses"], "clip_scales": out["clip_scales"],
           "step_ms": [s * 1e3 for s in out["step_s"]],
           "warm_step_ms": min(out["step_s"][1:]) * 1e3, "peak_device_bytes": peak,
           "quantizable_leaves": n_quant, "launches_per_step": launches,
           "launches": {k: v for k, v in counts.items() if v},
           "step1_max_abs_err": step1["max_abs_err"]}
    row["pass"] = (steps == 4 and all(math.isfinite(x) for x in out["losses"])
                   and n_quant == 8 and launches == [(n_quant, n_quant)] * steps
                   and counts["symog_update"] == counts["symog_sqnorm"] == n_quant * steps
                   and not [k for k, v in counts.items()
                            if v and k not in ("symog_update", "symog_sqnorm")])
    emit(row)
    del out
    torch.cuda.empty_cache()
    if not row["pass"]:
        raise Failed(f"launcher phase failed: {row}")
    return row


def _tree_equal(torch, a, b) -> bool:
    from repro_torch.nn.tree import flatten_with_paths

    fa, fb = flatten_with_paths(a), flatten_with_paths(b)
    return ([p for p, _ in fa] == [p for p, _ in fb]
            and all(torch.equal(x, y) for (_, x), (_, y) in zip(fa, fb)))


def phase_launcher_resume(torch, dev, tmp):
    """17b: 2 layers at full width through the launcher's function: 4 steps
    straight against 2 + --resume 2; the checkpoint's bytes and seconds."""
    import shutil

    from repro_torch import configs
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.launch import train as tlaunch

    cfg = dataclasses.replace(configs.get_config("internlm2-1.8b"), n_layers=2)
    ck = os.path.join(tmp, "launcher_ckpt")
    straight = tlaunch.run(cfg, _launch_args())
    tlaunch.run(cfg, _launch_args(["--ckpt-dir", ck, "--ckpt-every", "2"]))
    shutil.rmtree(os.path.join(ck, "ckpt_4"))
    resumed = tlaunch.run(cfg, _launch_args(["--ckpt-dir", ck, "--resume"]))
    a, b = straight["state"], resumed["state"]
    same = (a.step == b.step == 4 and _tree_equal(torch, a.params, b.params)
            and _tree_equal(torch, a.opt_state[1], b.opt_state[1]))
    d = os.path.join(ck, "ckpt_2")
    nbytes = sum(os.path.getsize(os.path.join(d, f)) for f in os.listdir(d))
    mgr = CheckpointManager(os.path.join(tmp, "launcher_timed"))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mgr.save(4, b, metadata={"data": {"step": 4}}, blocking=True)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    back, _, _ = mgr.restore(b, device=dev)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    restored = _tree_equal(torch, back.params, b.params) and back.step == 4
    row = {"phase": "launcher_resume", "arch": cfg.name, "layers": cfg.n_layers,
           "losses_straight": straight["losses"], "losses_resumed": resumed["losses"],
           "resumed_from": resumed["start"], "bit_identical": same,
           "checkpoint_bytes": nbytes, "save_s": save_s, "restore_s": restore_s,
           "restore_exact": restored}
    row["pass"] = (same and restored and resumed["start"] == 2
                   and resumed["losses"] == straight["losses"][2:])
    emit(row)
    shutil.rmtree(ck, ignore_errors=True)
    shutil.rmtree(os.path.join(tmp, "launcher_timed"), ignore_errors=True)
    del straight, resumed, a, b, back
    torch.cuda.empty_cache()
    if not row["pass"]:
        raise Failed(f"launcher resume phase failed: {row}")
    return row


def phase_symog_clipped(torch, dev, cfg):
    """17c: the norm pass and the clip-scaled update on internlm2's largest
    leaf against their plain versions: bit identity on two calls, the update
    bit-identical to its plain version, the norm within SQNORM_RTOL of its
    plain version and of the fp64 sum; times beside the byte bounds (8 and
    20 B an element)."""
    from repro_torch.kernels.symog_update import ops as sops
    from repro_torch.kernels.symog_update.ref import (_total_grad, symog_sqnorm_ref,
                                                      symog_update_ref)

    name, shape = max(symog_leaf_shapes(cfg), key=lambda e: math.prod(e[1]))
    gen = torch.Generator(device=dev)
    gen.manual_seed(17)
    w, g, v, kw = _symog_operands(torch, gen, dev, shape, 2, "random")
    s = torch.tensor(0.41, dtype=torch.float32, device=dev)
    nkw = {k: kw[k] for k in ("delta", "lam_eff", "n_bits")}
    n = w.numel()
    sq = [sops.symog_sqnorm(w, g, **nkw) for _ in range(2)]
    sq64 = torch.sum(torch.square(_total_grad(w, g, kw["delta"], kw["lam_eff"], 2)[2]
                                  .double())).item()
    sq_plain = symog_sqnorm_ref(w, g, **nkw).item()
    w_ref, v_ref = symog_update_ref(w, g, v, gscale=s, **kw)
    outs = []
    for _ in range(2):
        w2, v2 = w.clone(), v.clone()
        sops.symog_update(w2, g, v2, gscale=s, **kw)
        outs.append((w2, v2))
    torch.cuda.synchronize()
    upd_same = all(torch.equal(a, w_ref) and torch.equal(b, v_ref) for a, b in outs)
    upd_err = max((outs[0][0] - w_ref).abs().max().item(), (outs[0][1] - v_ref).abs().max().item())
    del outs, w_ref, v_ref
    sq_ms = events_ms(lambda: sops.symog_sqnorm(w, g, **nkw), 5, torch)
    sq_plain_ms = events_ms(lambda: symog_sqnorm_ref(w, g, **nkw), 3, torch)
    up_ms = events_ms(lambda: sops.symog_update(w, g, v, gscale=s, **kw), 5, torch)
    up_plain_ms = events_ms(lambda: symog_update_ref(w, g, v, gscale=s, **kw), 3, torch)
    sq_bound, sq_by = bound(8 * n, SQNORM_FLOPS * n, "float32")
    up_bound, up_by = bound(20 * n, CLIPPED_FLOPS * n, "float32")
    rel = abs(sq[0].item() - sq64) / sq64
    rel_plain = abs(sq[0].item() - sq_plain) / sq_plain
    rows = {
        "symog_sqnorm": {"phase": "kernel", "kernel": "symog_sqnorm", "leaf": name,
                         "shape": list(shape), "n": n, "ms": sq_ms, "plain_ms": sq_plain_ms,
                         "bound_ms": sq_bound, "bound_by": sq_by, "library_ms": None,
                         "max_abs_err": abs(sq[0].item() - sq_plain), "rel_err": rel_plain,
                         "rel_err_vs_fp64": rel,
                         "plain_rel_err_vs_fp64": abs(sq_plain - sq64) / sq64,
                         "tol": {"rtol_vs_plain": SQNORM_RTOL, "rtol_vs_fp64": SQNORM_RTOL},
                         "bit_identical_both_calls": bool(torch.equal(sq[0], sq[1])),
                         "achieved_GBps": 8 * n / (sq_ms * 1e-3) / 1e9},
        "symog_update_clipped": {"phase": "kernel", "kernel": "symog_update_clipped",
                                 "leaf": name, "shape": list(shape), "n": n, "gscale": 0.41,
                                 "ms": up_ms, "plain_ms": up_plain_ms, "bound_ms": up_bound,
                                 "bound_by": up_by, "library_ms": None, "max_abs_err": upd_err,
                                 "tol": "bit-identical to the plain version",
                                 "bit_identical_both_calls": upd_same,
                                 "achieved_GBps": 20 * n / (up_ms * 1e-3) / 1e9}}
    rows["symog_sqnorm"]["pass"] = (rows["symog_sqnorm"]["bit_identical_both_calls"]
                                    and rel_plain < SQNORM_RTOL and rel < SQNORM_RTOL)
    rows["symog_update_clipped"]["pass"] = upd_same
    for r in rows.values():
        emit(r)
    del w, g, v
    torch.cuda.empty_cache()
    if not all(r["pass"] for r in rows.values()):
        raise Failed(f"clipped symog_update forms disagree with their plain versions: {rows}")
    return rows


def _quant_leaves(cfg) -> int:
    from repro_torch import core
    from repro_torch.models import cnn_init

    params, _ = cnn_init(0, cfg, device="cpu")
    return sum(core.symog_init(params, core.SymogConfig(n_bits=2)).mask.values())


def _claims(lines):
    """The claims the JAX package's own CPU run of the same modules passes."""
    got = {n: d for n, _, d in lines}
    return {"table1_mnist_claim_C1": "pass=True" in got.get("table1_mnist_claim_C1", ""),
            "fig3_modes_collapsed": "pass=True" in got.get("fig3_modes_collapsed", ""),
            "fig4_claim_C3": "clip_gt_noclip=True" in got.get("fig4_claim_C3", "")}


def phase_experiments(torch, dev):
    """17d: the five experiments as written, the protocol on full-width VGG7
    and serve_quantized's path, each with its launches."""
    import importlib

    from repro_torch.data import SyntheticImagesConfig
    from repro_torch.examples import serve_quantized
    from repro_torch.experiments import common
    from repro_torch.kernels.symog_update import ops as sops
    from repro_torch.models.cnn import PAPER_CNNS, reduced_cnn

    lenet, vgg11 = _quant_leaves(PAPER_CNNS["lenet5"]), _quant_leaves(reduced_cnn("vgg11", 0.125))
    expected = {  # symog_update launches of the clipped arms: leaves x SYMOG steps
        "table1_mnist": lenet * 250,
        "table1_cifar10": (_quant_leaves(reduced_cnn("vgg7", 0.0625)) * 160
                           + _quant_leaves(reduced_cnn("densenet", 1.0)) * 320),
        "table1_cifar100": vgg11 * 320,
        "fig3_distributions": lenet * 300,
        "fig4_adaptation": vgg11 * 120,  # the clip=False arm composes
    }
    rows, lines = {}, []
    for name, want in expected.items():
        mod = importlib.import_module(f"repro_torch.experiments.{name}")
        del common.EMITTED[:]
        zero_counts()
        t0 = time.perf_counter()
        mod.run()
        torch.cuda.synchronize()
        counts = read_counts()
        rows[name] = {"seconds": time.perf_counter() - t0, "lines": list(common.EMITTED),
                      "symog_update_launches": counts["symog_update"], "expected": want}
        rows[name]["launches_ok"] = counts["symog_update"] == want
        lines += common.EMITTED
    claims = _claims(lines)
    # the protocol on VGG7 at full width, table1_cifar10's settings
    cfg = PAPER_CNNS["vgg7"]
    zero_counts()
    t0 = time.perf_counter()
    r = common.run_symog_protocol(cfg, data_cfg=SyntheticImagesConfig(
        n_classes=10, hw=32, channels=3, global_batch=16, snr=0.8, seed=21),
        pretrain_steps=100, symog_steps=160, lr0=0.01)
    vgg = {k: v for k, v in r.items() if not k.startswith("losses")}
    vgg.update(seconds_wall=time.perf_counter() - t0, loss_last=r["losses_symog"][-1],
               symog_update_launches=read_counts()["symog_update"],
               expected=_quant_leaves(cfg) * 160)
    vgg["launches_ok"] = vgg["symog_update_launches"] == vgg["expected"]
    # serve_quantized's path: SYMOG QAT with the clipped chain, then float /
    # quantized / packed serves of reduced internlm2 on the card
    zero_counts()
    sops.sqnorm_launches = 0
    t0 = time.perf_counter()
    sq = serve_quantized.main([])
    torch.cuda.synchronize()
    counts = dict(read_counts(), symog_sqnorm=sops.sqnorm_launches)
    serve = {"seconds": time.perf_counter() - t0, "loss": sq["loss"],
             "rel_quant_error": sq["rel_quant_error"], "tf_agree": sq["tf_agree"],
             "agree": sq["agree"], "packed_exact": sq["packed_exact"],
             "weight_bytes": list(sq["weight_bytes"]),
             "launches": {k: v for k, v in counts.items() if v}}
    serve["pass"] = (sq["packed_exact"] == 1.0 and counts["symog_update"] == 8 * 300
                     and counts["symog_sqnorm"] == 8 * 300
                     and counts["fixedpoint_matmul"] + counts["fixedpoint_matmul_decode"] > 0
                     and counts["paged_attention"] > 0)
    row = {"phase": "experiments", "modules": rows, "claims": claims, "vgg7_full_width": vgg,
           "serve_quantized": serve}
    row["pass"] = (all(claims.values()) and all(r["launches_ok"] for r in rows.values())
                   and vgg["launches_ok"] and serve["pass"])
    emit(row)
    if not row["pass"]:
        raise Failed(f"experiments phase failed: {row}")
    return row


# ---------------------------------------------------------------------------
# phase 18: distribution on torch.distributed, on the one card
# ---------------------------------------------------------------------------
# depth cuts of phase 18's spawned paths (full width; the launcher runs,
# 18a and 18e, are full depth: the launchers have no depth flag)
TP_LAYERS, EP_LAYERS, DP_LAYERS = 8, 1, 1
TP_SEED, EP_SEED, DP_SEED = 181, 184, 185
# 18b: a bf16-compute serve's first-step logits, 2 model shards vs 1 rank:
# relative L2 distance at most this many times the 1-rank bf16 logits'
# own distance from the 1-rank fp32 ones (the sharded sums round in other
# places: noise of bf16's own size)
BF16_LOGIT_FACTOR = 2.0
EP_TOL = 1e-5  # 18d: moe_apply_ep vs moe_apply, fp32, no drops
DP_RTOL = 1e-6  # 18e: a 2-rank step vs the 1-rank step on the whole batch (the tree's max)
COMPRESS_ROUNDS = 20
DIST_TIMEOUT = 600  # each spawned or torchrun group of ranks


def _dist_traffic(cfg):
    """Phase 5's traffic: 8 requests of 24..400 prompt tokens, 32 new each."""
    import numpy as np
    from repro_torch.serve import Request

    rng = np.random.default_rng(0)
    lens = rng.integers(24, 401, size=8)
    return [Request(tokens=rng.integers(0, cfg.vocab_size, size=int(L)), max_new_tokens=32)
            for L in lens]


def _dist_artifact(torch, dev, cfg, seed):
    """The 2-bit ``pack_tree`` artifact of ``cfg`` from the seeded fp32 init
    (the same bits on every process of the card)."""
    from repro_torch.core import SymogConfig, pack_tree, symog_init
    from repro_torch.models import init_lm

    params = init_lm(seed, cfg, device=dev)
    scfg = SymogConfig(n_bits=2)
    tree = pack_tree(params, symog_init(params, scfg), scfg)
    del params
    torch.cuda.empty_cache()
    return tree


def _dist_serve(torch, eng, reqs):
    """(tokens, launches, scheduler, wall s) of a greedy serve, the counts
    zeroed just before and read just after."""
    from repro_torch.serve import ServeConfig

    torch.cuda.synchronize()
    zero_counts()
    t = time.perf_counter()
    comps, sched = eng.serve(reqs, ServeConfig(n_slots=4, block_size=16), return_scheduler=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    return [list(map(int, c.tokens)) for c in comps], read_counts(), sched, wall


def _tp_cfg(kv: str = "bf16"):
    from repro_torch import configs

    return dataclasses.replace(configs.get_config("internlm2-1.8b"), n_layers=TP_LAYERS,
                               kv_cache_dtype=kv)


def _ep_cfg():
    """olmoe at EP_LAYERS, ``moe_impl='ep'``, capacity factor 8: neither the
    capacity dispatch nor the EP buffers drop an assignment at phase 5's
    prompts (as the reduced configs, whose factor is 8 for the same
    reason), so the two routes' streams are comparable token for token."""
    from repro_torch import configs

    return dataclasses.replace(configs.get_config("olmoe-1b-7b"), n_layers=EP_LAYERS,
                               moe_impl="ep", capacity_factor=8.0)


def _prompt_logits(torch, eng, reqs):
    """The first request's first-step (prefill) logits, fp32 on the host."""
    logits, _ = eng.prefill({"tokens": torch.as_tensor(reqs[0].tokens[None])})
    return logits[0, -1].float().cpu()


def _rank_tp(torch, dev, mesh, ref):
    """18b on one rank of the (1, 2) mesh."""
    from repro_torch.models.lm import PAGED_CACHE_LEAVES
    from repro_torch.serve import ServeEngine
    from repro_torch.serve.sharding import pool_bytes_per_device

    cfg = _tp_cfg()
    tree = _dist_artifact(torch, dev, cfg, TP_SEED)
    reqs = _dist_traffic(cfg)
    out = {}
    for kv in ("bf16", "int4_fp"):
        eng = ServeEngine(_tp_cfg(kv), tree, max_len=512, compute_dtype=torch.float32,
                          device=dev, mesh=mesh)
        tokens, counts, sched, wall = _dist_serve(torch, eng, reqs)
        heads, scale = set(), 0
        for gname, g in sched.caches.items():
            for sub in g.values():
                for name, leaf in sub.items():
                    if name in PAGED_CACHE_LEAVES:
                        heads.add(int(leaf.shape[-2]))
                    elif name.removesuffix("_scale") in PAGED_CACHE_LEAVES:
                        scale += leaf.numel() * leaf.element_size()
        total, per_dev = pool_bytes_per_device(eng, 16, sched.n_blocks, model_shards=2)
        out[kv] = {"tokens_equal_1_rank": tokens == ref[kv], "launches": counts,
                   "plan": {k: getattr(eng.tp, k) for k in ("attn", "mlp", "embed", "head")},
                   "kv_heads_local": sorted(heads), "paged_pool_bytes": sched.paged_pool_bytes(),
                   "pool_bytes_per_device": per_dev, "pool_bytes_total": total,
                   "scale_bytes_local": scale, "wall_s": wall,
                   "decode_steps": sched.stats["decode_steps"],
                   "weight_bytes_local": eng.weight_bytes()}
        del eng, sched
    eng = ServeEngine(_tp_cfg(), tree, max_len=512, compute_dtype=torch.bfloat16, device=dev,
                      mesh=mesh)
    lg = _prompt_logits(torch, eng, reqs)
    want = torch.load(ref["bf16_logits"])
    tokens, _, _, _ = _dist_serve(torch, eng, reqs)
    pairs = [(a, b) for x, y in zip(tokens, ref["bf16_tokens"]) for a, b in zip(x, y)]
    out["bf16_compute"] = {
        "first_step_logits_rel_l2": float(torch.linalg.vector_norm(lg - want)
                                          / torch.linalg.vector_norm(want)),
        "first_step_argmax_equal": int(lg.argmax()) == int(want.argmax()),
        "identical_token_share": sum(a == b for a, b in pairs) / max(1, len(pairs))}
    del eng, tree
    torch.cuda.empty_cache()
    return out


def _rank_ep(torch, dev, mesh, ref):
    """18d on one rank of the (1, 2) mesh: the olmoe serve, then one
    full-width MoE layer, moe_apply_ep vs moe_apply in fp32, no drops."""
    from repro_torch.models.blocks import _moe_cfg
    from repro_torch.models.moe import moe_apply, moe_init
    from repro_torch.models.moe_ep import moe_apply_ep
    from repro_torch.serve import ServeEngine

    cfg = _ep_cfg()
    tree = _dist_artifact(torch, dev, cfg, EP_SEED)
    eng = ServeEngine(cfg, tree, max_len=512, compute_dtype=torch.float32, device=dev, mesh=mesh)
    del tree
    tokens, counts, sched, wall = _dist_serve(torch, eng, _dist_traffic(cfg))
    # the expert axis: dim -3 of the words (E, K, N/per) under any stacked lead
    local = eng.params["layers0"]["sub0"]["moe"]["experts"]["gate_proj"]["kernel"].data.shape[-3]
    out = {"tokens_equal_1_rank": tokens == ref["tokens"], "launches": counts,
           "local_experts": int(local), "ep_moe": bool(eng.capabilities()["ep_moe"]),
           "plan": {k: getattr(eng.tp, k) for k in ("attn", "mlp", "embed", "head", "ep")},
           "wall_s": wall, "decode_steps": sched.stats["decode_steps"]}
    del eng, sched
    torch.cuda.empty_cache()
    mcfg = _moe_cfg(cfg)
    gen = torch.Generator(device=dev).manual_seed(EP_SEED + 1)
    p = moe_init(gen, mcfg, torch.float32)
    x = (torch.randn((4, 8, cfg.d_model), generator=gen, device=dev) * 0.5).requires_grad_(True)
    leaves = [p["experts"][k]["kernel"] for k in ("gate_proj", "up_proj", "down_proj")]
    for t in leaves:
        t.requires_grad_(True)
    y, _ = moe_apply_ep(p, x, cfg=mcfg, compute_dtype=torch.float32, ep_axes=("model",),
                        dp_axes=(), dropless=True, mesh=mesh)
    with torch.no_grad():  # capacity N·k: no expert can drop
        want, _ = moe_apply(p, x, cfg=dataclasses.replace(mcfg, capacity_factor=float(
            mcfg.n_experts)), compute_dtype=torch.float32)
    torch.sum(y ** 2).backward()
    grads = [x.grad] + [t.grad for t in leaves]
    out["layer"] = {"max_abs_err": float((y.detach() - want).abs().max()),
                    "grads_finite": all(bool(torch.isfinite(g).all()) for g in grads),
                    "grads_nonzero": all(float(g.abs().sum()) > 0 for g in grads),
                    "shape": list(x.shape), "experts": mcfg.n_experts}
    del p, x, y, want, grads, leaves
    torch.cuda.empty_cache()
    return out


def _rank_dp(torch, dev, mesh, rank):
    """18e's parity on one rank of the (2, 1) mesh: the launcher's optimizer
    (the clipped fused chain, SYMOG 2-bit) at full width and DP_LAYERS,
    fp32, step 1 on this rank's half of 8 x 128 tokens with the gradients
    mean-reduced vs the 1-rank step on all of them; then rounds of
    compressed_psum_int8 on one full-width leaf's local gradients."""
    from repro_torch import configs, core, optim
    from repro_torch.data import SyntheticLM, SyntheticLMConfig
    from repro_torch.distributed.collectives import all_reduce
    from repro_torch.distributed import CompressionState, compressed_psum_int8
    from repro_torch.kernels.symog_update import ops as sops
    from repro_torch.models import init_lm
    from repro_torch.models.lm import lm_train_loss
    from repro_torch.nn.tree import flatten_with_paths
    from repro_torch.train import init_train_state, make_train_step
    from repro_torch.train.trainer import _loss_and_grads, _my_rows

    cfg = dataclasses.replace(configs.get_config("internlm2-1.8b"), n_layers=DP_LAYERS)
    tx = optim.chain(optim.clip_by_global_norm(1.0), optim.sgd(momentum=0.9, nesterov=True))
    scfg = core.SymogConfig(n_bits=2, total_steps=200)
    lr = core.linear_lr(0.01, 0.001, 200)
    data = SyntheticLM(SyntheticLMConfig(vocab_size=cfg.vocab_size, seq_len=128, global_batch=8,
                                         seed=DP_SEED))
    batch = {k: torch.as_tensor(v, device=dev) for k, v in next(data).items()}
    out = {}
    runs = {}
    for name, m in (("2_ranks", mesh), ("1_rank", None)):
        state = init_train_state(init_lm(DP_SEED, cfg, device=dev), tx, scfg)
        step = make_train_step(cfg, tx, lr, symog_cfg=scfg, compute_dtype=torch.float32, mesh=m)
        zero_counts()
        sops.sqnorm_launches = 0
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
        runs[name] = (state, float(metrics["loss"]))
        out[name] = {"step_s": time.perf_counter() - t, "loss": float(metrics["loss"]),
                     "symog_update": sops.launches, "symog_sqnorm": sops.sqnorm_launches}
    (a, la), (b, lb) = runs["2_ranks"], runs["1_rank"]
    # the tree's largest difference over its largest value; per leaf too: a
    # leaf initialized to zero (the norm scales) is one update, whose
    # relative error is the gradient's (fp32 sums over 512 vs 1,024 rows)
    pairs = list(zip(flatten_with_paths(a.params), flatten_with_paths(b.params)))
    out["params_rel_by_leaf"] = {
        path: float((u - v).abs().max() / v.abs().max().clamp_min(1e-30))
        for (path, u), (_, v) in pairs}
    out["params_max_rel"] = (max(float((u - v).abs().max()) for (_, u), (_, v) in pairs)
                             / max(float(v.abs().max()) for _, (_, v) in pairs))
    out["quantizable_leaves"] = int(sum(a.symog.mask.values()))
    del runs, a, b
    torch.cuda.empty_cache()
    # one full-width leaf's local gradients (this rank's rows), compressed
    params = init_lm(DP_SEED, cfg, device=dev)
    _, _, grads = _loss_and_grads(lambda p, bt: lm_train_loss(p, bt, cfg,
                                                              compute_dtype=torch.float32),
                                  params, _my_rows(batch, 2, rank))
    g = grads["layers0"]["sub0"]["attn"]["k_proj"]["kernel"]
    del params, grads
    group = mesh.group("data")
    exact = all_reduce(g, group) / 2
    st = CompressionState(err={"w": torch.zeros_like(g)})
    acc_c, acc_x, one = torch.zeros_like(g), torch.zeros_like(g), 0.0
    for _ in range(COMPRESS_ROUNDS):
        mean, st = compressed_psum_int8({"w": g}, st, group)
        acc_c += mean["w"]
        acc_x += exact
        one = max(one, float((mean["w"] - exact).abs().max() / exact.abs().max()))
    out["compressed"] = {"leaf": "layers0/sub0/attn/k_proj/kernel", "shape": list(g.shape),
                         "rounds": COMPRESS_ROUNDS, "one_round_rel": one,
                         "accum_rel": float((acc_c - acc_x).abs().max() / acc_x.abs().max())}
    return out


def _dist_rank(rank, world, port, ref, out_path):
    """One spawned rank of 18b, 18d and 18e's parity (gloo: both ranks share
    the card).  Writes its results as JSON; a failure writes the traceback."""
    import datetime
    import traceback

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "src"))
    import torch
    import torch.distributed as dist

    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.cuda.set_device(0)
        dev = torch.device("cuda", 0)
        from repro_torch.nn.sharding import Mesh, choose_backend

        backend = choose_backend(dev, world)
        dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                                world_size=world, timeout=datetime.timedelta(seconds=300))
        out = {"backend": dist.get_backend(), "seconds": {}}
        t = time.perf_counter()
        tp_mesh = Mesh((1, 2), ("data", "model"))
        out["tp"] = _rank_tp(torch, dev, tp_mesh, ref["tp"])
        out["seconds"]["18b"] = time.perf_counter() - t
        t = time.perf_counter()
        out["ep"] = _rank_ep(torch, dev, tp_mesh, ref["ep"])
        out["seconds"]["18d"] = time.perf_counter() - t
        t = time.perf_counter()
        out["dp"] = _rank_dp(torch, dev, Mesh((2, 1), ("data", "model")), rank)
        out["seconds"]["18e"] = time.perf_counter() - t
        with open(out_path, "w") as f:
            json.dump(out, f)
        dist.barrier()
        dist.destroy_process_group()
    except BaseException:
        with open(out_path + ".err", "w") as f:
            f.write(traceback.format_exc())
        os._exit(1)


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn_ranks(world: int, ref, tmp, target=None, phase: str = "18"):
    """Run ``target`` (default ``_dist_rank``) on ``world`` spawned
    processes; every one is joined within DIST_TIMEOUT and killed past it."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    port = _free_port()
    paths = [os.path.join(tmp, f"rank{r}.json") for r in range(world)]
    procs = [ctx.Process(target=target or _dist_rank, args=(r, world, port, ref, paths[r]))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + DIST_TIMEOUT
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
        p.join(10)
    errs = []
    for r, (p, path) in enumerate(zip(procs, paths)):
        if os.path.exists(path + ".err"):
            errs.append(f"rank {r}:\n" + open(path + ".err").read())
        elif p.exitcode != 0 or not os.path.exists(path):
            errs.append(f"rank {r}: exit code {p.exitcode}")
    if alive or errs:
        raise Failed(f"phase {phase} ranks failed ({len(alive)} killed at {DIST_TIMEOUT} s):\n"
                     + "\n".join(errs))
    return [json.load(open(path)) for path in paths]


def _torchrun(args, timeout: int):
    """``python -m torch.distributed.run --standalone --nproc-per-node 2``
    with ``args``; its whole process group is killed past ``timeout``."""
    import signal

    here = os.path.dirname(os.path.abspath(__file__))
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
           "2", *args]
    env = dict(os.environ, PYTHONPATH=os.path.join(here, "src"), OMP_NUM_THREADS="1")
    t = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=here, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, start_new_session=True)
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, err = proc.communicate()
        return 124, out, err, time.perf_counter() - t
    return proc.returncode, out, err, time.perf_counter() - t


def phase_dist(torch, dev):
    """Phase 18 (module docstring).  Every gate raises."""
    import torch.distributed as dist
    from repro_torch.nn.sharding import Mesh
    from repro_torch.serve import ServeEngine

    row = {"phase": "dist", "gates": {}, "seconds": {}}

    def gate(name, ok):
        row["gates"][name] = bool(ok)

    # 18a: the serve launcher on 2 ranks
    t = time.perf_counter()
    rc, out, err, secs = _torchrun(
        ["-m", "repro_torch.launch.serve", "--arch", "internlm2-1.8b", "--packed", "--kv-bits",
         "4", "--continuous", "--requests", "8", "--slots", "4", "--mesh", "1x2"], DIST_TIMEOUT)
    lines = out.splitlines()
    row["18a"] = {"rc": rc, "seconds": secs, "stdout_tail": lines[-30:],
                  "capacity": [ln for ln in lines if "sharded pool" in ln],
                  "agreement": [ln for ln in lines if "token agreement" in ln]}
    gate("18a_exit_0", rc == 0)
    gate("18a_streams_equal", "ranks' token streams equal: True" in out)
    gate("18a_capacity_2_shards", any("at 2 model shards" in ln for ln in lines))
    gate("18a_agreement_printed", any("packed vs quantized token agreement" in ln
                                      for ln in lines))
    gate("18a_gloo", "backend gloo, 2 ranks" in out)
    if rc:
        print(out[-4000:], err[-6000:], file=sys.stderr, flush=True)
    row["seconds"]["18a"] = time.perf_counter() - t

    # references on one rank (this process), then 18b / 18d / 18e's parity
    t = time.perf_counter()
    tree = _dist_artifact(torch, dev, _tp_cfg(), TP_SEED)
    reqs = _dist_traffic(_tp_cfg())
    ref = {"tp": {}, "ep": {}}
    counts1 = {}
    for kv in ("bf16", "int4_fp"):
        eng = ServeEngine(_tp_cfg(kv), tree, max_len=512, compute_dtype=torch.float32,
                          device=dev)
        ref["tp"][kv], counts1[kv], _, _ = _dist_serve(torch, eng, reqs)
        if kv == "bf16":
            l32 = _prompt_logits(torch, eng, reqs)
        del eng
    eng16 = ServeEngine(_tp_cfg(), tree, max_len=512, compute_dtype=torch.bfloat16, device=dev)
    logits = _prompt_logits(torch, eng16, reqs)
    ref["tp"]["bf16_own_rel_l2"] = float(torch.linalg.vector_norm(logits - l32)
                                         / torch.linalg.vector_norm(l32))
    ref["tp"]["bf16_tokens"] = _dist_serve(torch, eng16, reqs)[0]
    del eng16
    tmp = tempfile.mkdtemp(prefix="phase18_")
    ref["tp"]["bf16_logits"] = os.path.join(tmp, "logits.pt")
    torch.save(logits, ref["tp"]["bf16_logits"])
    ep_tree = _dist_artifact(torch, dev, _ep_cfg(), EP_SEED)
    eng = ServeEngine(_ep_cfg(), ep_tree, max_len=512, compute_dtype=torch.float32, device=dev)
    del ep_tree
    ref["ep"]["tokens"], ep_counts1, _, _ = _dist_serve(torch, eng, _dist_traffic(_ep_cfg()))
    ep_cap_off = eng.capabilities()["ep_moe"].reason
    del eng
    torch.cuda.empty_cache()
    row["seconds"]["references"] = time.perf_counter() - t
    t = time.perf_counter()
    ranks = _spawn_ranks(2, ref, tmp)
    row["seconds"]["spawned_ranks"] = time.perf_counter() - t
    r0 = ranks[0]
    row["rank_seconds"] = [r["seconds"] for r in ranks]
    row["backend_spawned"] = [r["backend"] for r in ranks]
    gate("18_spawned_gloo", all(r["backend"] == "gloo" for r in ranks))

    # 18b
    tp = {kv: r0["tp"][kv] for kv in ("bf16", "int4_fp")}
    row["18b"] = {"layers": TP_LAYERS, "ranks": [r["tp"] for r in ranks],
                  "launches_1_rank": counts1}
    for kv in ("bf16", "int4_fp"):
        for r in ranks:
            x = r["tp"][kv]
            gate(f"18b_{kv}_tokens_equal_1_rank", x["tokens_equal_1_rank"])
            gate(f"18b_{kv}_4_of_8_kv_heads", x["kv_heads_local"] == [4])
            gate(f"18b_{kv}_plan_sharded", all(x["plan"].values()))
            data_bytes = x["paged_pool_bytes"] - x["scale_bytes_local"]
            # data leaves: half of each; the exponents co-sharded with them
            # (counted replicated by pool_bytes_per_device)
            gate(f"18b_{kv}_pool_bytes", data_bytes + 2 * x["scale_bytes_local"]
                 == x["pool_bytes_per_device"])
            attn = "paged_attention" if kv == "bf16" else "paged_attention_quant"
            # every kernel launches on the local shards as often as on 1 rank
            gate(f"18b_{kv}_launches_equal_1_rank", x["launches"] == counts1[kv]
                 and x["launches"][attn] > 0 and x["launches"]["fixedpoint_matmul"] > 0)
    bc = [r["tp"]["bf16_compute"] for r in ranks]
    row["18b"]["bf16_compute"] = bc
    row["18b"]["bf16_vs_fp32_rel_l2_1_rank"] = ref["tp"]["bf16_own_rel_l2"]
    gate("18b_bf16_logits", all(x["first_step_logits_rel_l2"]
                                <= BF16_LOGIT_FACTOR * ref["tp"]["bf16_own_rel_l2"] for x in bc))

    # 18c: the 18b engine on an NCCL group of one rank
    t = time.perf_counter()
    port = _free_port()
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}", rank=0,
                            world_size=1, device_id=dev)
    try:
        mesh = Mesh((1, 1), ("data", "model"))
        eng = ServeEngine(_tp_cfg(), tree, max_len=512, compute_dtype=torch.float32, device=dev,
                          mesh=mesh)
        toks, counts, _, _ = _dist_serve(torch, eng, reqs)
        probe = torch.arange(4, dtype=torch.float32, device=dev)
        dist.all_reduce(probe)
        torch.cuda.synchronize()
        row["18c"] = {"backend": mesh.backend, "tokens_equal_unsharded": toks == ref["tp"]["bf16"],
                      "launches_equal_unsharded": counts == counts1["bf16"],
                      "all_reduce_on_card": probe.tolist()}
        print(f"18c: backend {mesh.backend}, 1 rank", flush=True)
        gate("18c_nccl", mesh.backend == "nccl")
        gate("18c_tokens", toks == ref["tp"]["bf16"])
        gate("18c_launches", counts == counts1["bf16"])
        del eng
    finally:
        dist.destroy_process_group()
    del tree
    torch.cuda.empty_cache()
    row["seconds"]["18c"] = time.perf_counter() - t

    # 18d
    row["18d"] = {"layers": EP_LAYERS, "ranks": [r["ep"] for r in ranks],
                  "launches_1_rank": ep_counts1, "ep_moe_off_mesh": ep_cap_off}
    for r in ranks:
        x = r["ep"]
        gate("18d_tokens_equal_1_rank", x["tokens_equal_1_rank"])
        gate("18d_32_local_experts", x["local_experts"] == 32)
        gate("18d_ep_moe_on", x["ep_moe"] and x["plan"]["ep"])
        gate("18d_experts_launched", x["launches"]["fixedpoint_matmul_experts"] > 0)
        gate("18d_layer_err", x["layer"]["max_abs_err"] < EP_TOL)
        gate("18d_layer_grads", x["layer"]["grads_finite"] and x["layer"]["grads_nonzero"])
    gate("18d_off_mesh_reason", "no mesh" in ep_cap_off)

    # 18e: the training launcher on 2 ranks, then the spawned parity
    t = time.perf_counter()
    rc, out, err, secs = _torchrun(["-m", "repro_torch.launch.train"] + LAUNCH_ARGS[:2]
                                   + ["--steps", "1", "--batch", "8", "--seq", "128", "--symog",
                                      "--log-every", "1", "--mesh", "2x1"], DIST_TIMEOUT)
    lines = out.splitlines()
    losses = [float(ln.split()[3]) for ln in lines if ln.startswith("step ")]
    row["18e"] = {"launcher": {"rc": rc, "seconds": secs, "stdout_tail": lines[-12:],
                               "losses": losses},
                  "ranks": [r["dp"] for r in ranks]}
    gate("18e_launcher_exit_0", rc == 0)
    gate("18e_launcher_losses_equal", "ranks' losses equal: True" in out and len(losses) == 1
         and all(math.isfinite(v) for v in losses))
    if rc:
        print(out[-4000:], err[-6000:], file=sys.stderr, flush=True)
    for r in ranks:
        x = r["dp"]
        gate("18e_params_within_1e-6", x["params_max_rel"] < DP_RTOL)
        gate("18e_loss_equal", abs(x["2_ranks"]["loss"] - x["1_rank"]["loss"])
             <= 1e-6 * abs(x["1_rank"]["loss"]))
        gate("18e_update_launches", x["2_ranks"]["symog_update"] == x["quantizable_leaves"]
             == x["2_ranks"]["symog_sqnorm"])
        gate("18e_compressed_one_round", x["compressed"]["one_round_rel"] < 0.05)
        gate("18e_compressed_accum", x["compressed"]["accum_rel"] < 0.02)
    gate("18e_ranks_same_loss", ranks[0]["dp"]["2_ranks"]["loss"]
         == ranks[1]["dp"]["2_ranks"]["loss"])
    row["seconds"]["18e_launcher"] = time.perf_counter() - t
    row["pass"] = all(row["gates"].values())
    emit(row)
    if not row["pass"]:
        raise Failed(f"phase 18 failed: {[k for k, v in row['gates'].items() if not v]}")
    return row


# ---------------------------------------------------------------------------
# phase 19: tensor-parallel and FSDP SYMOG training, two ranks on the one card
# ---------------------------------------------------------------------------
# depth cuts of phase 19's spawned paths (full width; 19a's launcher runs
# internlm2 at full depth)
TPT_LAYERS, EPT_LAYERS, FSDP_LAYERS = 1, 1, 1
TPT_SEED, EPT_SEED, FSDP_SEED = 191, 193, 194
TRAIN_RTOL = 1e-5  # a sharded step vs the 1-rank step: every leaf's max |diff| / max |value|
TRAIN_ATOL = 1e-7  # phase 20: beside TRAIN_RTOL of the leaf's max |value|
LAUNCH19_ARGS = ["--arch", "internlm2-1.8b", "--steps", "2", "--batch", "8", "--seq", "128",
                 "--symog", "--log-every", "1", "--mesh", "1x2"]
UPDATE_BYTES, SQNORM_BYTES = 20, 8  # a fused update / norm pass, per element (fp32)


def _tpt_cfg():
    from repro_torch import configs

    return dataclasses.replace(configs.get_config("internlm2-1.8b"), n_layers=TPT_LAYERS)


def _ept_cfg():
    """olmoe at EPT_LAYERS, ``moe_impl='ep'``, capacity factor 8: neither the
    1-rank capacity dispatch nor the EP buffers drop an assignment."""
    from repro_torch import configs

    return dataclasses.replace(configs.get_config("olmoe-1b-7b"), n_layers=EPT_LAYERS,
                               moe_impl="ep", capacity_factor=8.0)


def _fsdp_cfg():
    from repro_torch import configs

    return dataclasses.replace(configs.get_config("gemma2-27b"), n_layers=FSDP_LAYERS)


def _train_bytes(cfg, split: int):
    """(whole-state bytes, this rank's state bytes): fp32 params + momentum,
    every leaf of rank >= 2 cut ``split`` ways (the reckoning, before the run)."""
    from repro_torch.train.sharding import param_shapes

    shapes = param_shapes(cfg).values()
    whole = sum(math.prod(s) for s in shapes)
    local = sum(math.prod(s) // (split if len(s) >= 2 else 1) for s in shapes)
    return 8 * whole, 8 * local


def _shard_kernels(torch, dev, state, layout, path, scfg, seed):
    """This rank's shard of ``path`` after the step: ``symog_update`` and
    ``symog_sqnorm`` with the whole leaf's λ_eff, two calls each, against
    their plain versions, and their times beside the byte bounds."""
    from repro_torch.core import lambda_at
    from repro_torch.core.quantizer import delta_from_f
    from repro_torch.kernels.symog_update import ops as sops
    from repro_torch.kernels.symog_update.ref import symog_sqnorm_ref, symog_update_ref
    from repro_torch.nn.tree import flatten_with_paths

    w = dict(flatten_with_paths(state.params))[path].detach().clone().contiguous()
    f = dict(flatten_with_paths(state.symog.f))[path]
    gen = torch.Generator(device=dev).manual_seed(seed + 7)
    g = torch.randn(w.shape, generator=gen, device=dev) * 1e-4
    v = torch.randn(w.shape, generator=gen, device=dev) * 1e-4
    lam_eff = lambda_at(scfg, scfg.total_steps) * 2.0 / layout.numel(path)
    kw = dict(delta=delta_from_f(f, device=dev), lam_eff=lam_eff, n_bits=scfg.n_bits)
    ukw = dict(kw, lr=0.01, mu=0.9)
    want_w, want_v = symog_update_ref(w, g, v, **ukw)
    before = (sops.launches, sops.sqnorm_launches)
    outs, sqs = [], []
    for _ in range(2):
        w2, v2 = w.clone(), v.clone()
        sqs.append(sops.symog_sqnorm(w2, g, **kw))
        sops.symog_update(w2, g, v2, **ukw)
        outs.append((w2, v2))
    torch.cuda.synchronize()
    launched = (sops.launches - before[0], sops.sqnorm_launches - before[1])
    sq_plain = float(symog_sqnorm_ref(w, g, **kw))
    n = w.numel()
    w2, v2 = w.clone(), v.clone()  # updated in place call after call
    up_ms = events_ms(lambda: sops.symog_update(w2, g, v2, **ukw), 5, torch)
    up_plain_ms = events_ms(lambda: symog_update_ref(w, g, v, **ukw), 3, torch)
    sq_ms = events_ms(lambda: sops.symog_sqnorm(w, g, **kw), 5, torch)
    sq_plain_ms = events_ms(lambda: symog_sqnorm_ref(w, g, **kw), 3, torch)
    up_bound, up_by = bound(UPDATE_BYTES * n, SYMOG_FLOPS * n, "float32")
    sq_bound, sq_by = bound(SQNORM_BYTES * n, SQNORM_FLOPS * n, "float32")
    groups = int(kw["delta"].numel())
    out = {"leaf": path, "shard_shape": list(w.shape), "whole_numel": layout.numel(path),
           "groups": groups, "lam_eff": lam_eff,
           "update": {"bit_identical_both_calls": all(torch.equal(a, want_w)
                                                      and torch.equal(b, want_v)
                                                      for a, b in outs),
                      "max_abs_err": max(float((outs[0][0] - want_w).abs().max()),
                                         float((outs[0][1] - want_v).abs().max())),
                      "ms": up_ms, "plain_ms": up_plain_ms, "bound_ms": up_bound,
                      "bound_by": up_by},
           "sqnorm": {"bit_identical_both_calls": bool(torch.equal(sqs[0], sqs[1])),
                      "rel_err_vs_plain": abs(float(sqs[0]) - sq_plain) / sq_plain,
                      "max_abs_err": abs(float(sqs[0]) - sq_plain),
                      "ms": sq_ms, "plain_ms": sq_plain_ms, "bound_ms": sq_bound,
                      "bound_by": sq_by},
           "launches": list(launched)}
    out["pass"] = (out["update"]["bit_identical_both_calls"]
                   and out["sqnorm"]["bit_identical_both_calls"]
                   and out["sqnorm"]["rel_err_vs_plain"] < SQNORM_RTOL and launched == (2, 2))
    del w, g, v, w2, v2, outs, want_w, want_v
    return out


def _rank_train_case(torch, dev, rank, mesh, cfg, seed, routes, kernel_leaf, refs_at_once):
    """One of 19b–19d on one rank, per update route: each rank takes the
    1-rank step from the seeded init (its params kept on the host; both at
    once with ``refs_at_once``, else in turns), then both ranks the sharded
    step from the same init, the launches and the
    collectives counted around it alone; each rank then holds its pieces to
    its slices of the 1-rank leaves (nothing crosses gloo to check them)."""
    import torch.distributed as dist
    from repro_torch import core, optim
    from repro_torch.data import SyntheticLM, SyntheticLMConfig
    from repro_torch.distributed import collectives
    from repro_torch.kernels import dispatch
    from repro_torch.kernels.symog_update import ops as sops
    from repro_torch.models import init_lm
    from repro_torch.nn.sharding import slice_for
    from repro_torch.nn.tree import flatten_with_paths
    from repro_torch.train import init_train_state, make_train_step
    from repro_torch.train.sharding import shard_train_state, train_layout

    tx = optim.chain(optim.clip_by_global_norm(1.0), optim.sgd(momentum=0.9, nesterov=True))
    scfg = core.SymogConfig(n_bits=2, total_steps=200)
    lr = core.linear_lr(0.01, 0.001, 200)
    data = SyntheticLM(SyntheticLMConfig(vocab_size=cfg.vocab_size, seq_len=128, global_batch=8,
                                         seed=seed))
    from repro_torch.launch.train import _frontend_stub

    batch = {k: torch.as_tensor(v, device=dev)
             for k, v in _frontend_stub(cfg, next(data), seed + 1).items()}
    res = {}
    for route in routes:
        dispatch.set_update_backend(route)
        out, ref = {}, None
        for turn in range(1 if refs_at_once else dist.get_world_size()):
            if refs_at_once or rank == turn:
                state = init_train_state(init_lm(seed, cfg, device=dev), tx, scfg)
                step = make_train_step(cfg, tx, lr, symog_cfg=scfg, compute_dtype=torch.float32)
                torch.cuda.reset_peak_memory_stats(dev)
                torch.cuda.synchronize()
                t = time.perf_counter()
                state, m = step(state, batch)
                torch.cuda.synchronize()
                out["one_rank"] = {"step_ms": (time.perf_counter() - t) * 1e3,
                                   "loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
                                   "clip_scale": float(m["clip_scale"]),
                                   "peak_bytes": torch.cuda.max_memory_allocated(dev)}
                ref = {p: v.cpu() for p, v in flatten_with_paths(state.params)}
                del state, step, m
                torch.cuda.empty_cache()
            dist.barrier()
        torch.cuda.reset_peak_memory_stats(dev)
        whole = init_train_state(init_lm(seed, cfg, device=dev), tx, scfg)
        layout = train_layout(cfg, mesh)
        state = shard_train_state(whole, layout)
        del whole
        torch.cuda.empty_cache()
        out["init_peak_bytes"] = torch.cuda.max_memory_allocated(dev)
        out["local_state_bytes"] = sum(v.numel() * v.element_size() for _, v in
                                       flatten_with_paths({"p": state.params,
                                                           "m": state.opt_state[1]}))
        torch.cuda.reset_peak_memory_stats(dev)
        step = make_train_step(cfg, tx, lr, symog_cfg=scfg, compute_dtype=torch.float32,
                               mesh=mesh)
        sops.launches = sops.sqnorm_launches = 0
        collectives.reset_stats()
        collectives.timing = True
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        out["step_ms"] = (time.perf_counter() - t) * 1e3
        collectives.timing = False
        out["launches"] = {"symog_update": sops.launches, "symog_sqnorm": sops.sqnorm_launches}
        out["collectives"] = {k: dict(c) for k, c in collectives.stats.items()}
        out["gloo_share"] = sum(collectives.stats["seconds"].values()) * 1e3 / out["step_ms"]
        out["step_peak_bytes"] = torch.cuda.max_memory_allocated(dev)
        out["metrics"] = {k: float(v) for k, v in m.items()}
        out["quantizable_leaves"] = int(sum(state.symog.mask.values()))
        out["plan"] = {k: getattr(layout.plan, k) for k in ("attn", "mlp", "embed", "head", "ep",
                                                             "ssd", "rglru")}
        out["fsdp_leaves"] = len(layout.plan.fsdp or {})
        out["split_leaves"] = sum(1 for s in layout.specs.values() if s)
        rel, miss = {}, {}
        for path, leaf in flatten_with_paths(state.params):
            want = slice_for(mesh, ref[path], layout.specs[path]).to(dev)
            diff, scale = float((leaf - want).abs().max()), float(want.abs().max())
            rel[path] = diff / max(scale, 1e-30)
            # past TRAIN_RTOL of the leaf's scale and TRAIN_ATOL: a leaf whose
            # true grad is 0 (whisper's k biases: softmax ignores a shift
            # of a row's logits) holds only rounding noise, whatever its rel
            miss[path] = diff - TRAIN_RTOL * scale - TRAIN_ATOL
            del want
        out["params_rel_by_leaf"] = rel
        out["params_max_rel"] = max(rel.values())
        out["params_worst_miss"] = max(miss.values())
        if route == "fused" and kernel_leaf:  # in turns: the other rank leaves the card
            for turn in range(dist.get_world_size()):
                if rank == turn:
                    out["kernels"] = _shard_kernels(torch, dev, state, layout, kernel_leaf,
                                                    scfg, seed)
                dist.barrier()
        del state, step, ref
        torch.cuda.empty_cache()
        res[route] = out
    dispatch.set_update_backend("auto")
    return res


def _train_rank(rank, world, port, ref, out_path):
    """One spawned rank of 19b–19d, then of 20a–20b (gloo: both ranks share
    the card).  The groups are the mesh's, made with their timeout
    (``nn.sharding.Mesh``)."""
    import datetime
    import traceback

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "src"))
    import torch
    import torch.distributed as dist

    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.cuda.set_device(0)
        dev = torch.device("cuda", 0)
        from repro_torch.nn.sharding import Mesh

        dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                                world_size=world, timeout=datetime.timedelta(seconds=300))
        out = {"backend": dist.get_backend(), "seconds": {}}
        # (case, mesh, config, seed, routes, the leaf whose shard the kernels
        # are held on, whether two 1-rank steps fit on the card at once)
        cases = (("19b", (1, 2), _tpt_cfg(), TPT_SEED, ("fused", "composed"),
                  "layers0/sub0/mlp/gate_proj/kernel", True),
                 ("19c", (1, 2), _ept_cfg(), EPT_SEED, ("fused",),
                  "layers0/sub0/moe/experts/gate_proj/kernel", True),
                 ("19d", (2, 1), _fsdp_cfg(), FSDP_SEED, ("fused",),
                  "layers0/sub0/mlp/gate_proj/kernel", False))
        for name, shape, cfg, seed, routes, leaf, at_once in cases:
            t = time.perf_counter()
            mesh = Mesh(shape, ("data", "model"))
            out[name] = _rank_train_case(torch, dev, rank, mesh, cfg, seed, routes, leaf,
                                         at_once)
            out["seconds"][name] = time.perf_counter() - t
        # phase 20's 20a and 20b in the same pair (the processes, their
        # groups and their warm card reused)
        t = time.perf_counter()
        out["20"] = _family_rank_work(torch, dev, rank, Mesh((1, 2), ("data", "model")))
        out["seconds"]["20 (reported in phase 20)"] = time.perf_counter() - t
        with open(out_path, "w") as f:
            json.dump(out, f)
        dist.barrier()
        dist.destroy_process_group()
    except BaseException:
        with open(out_path + ".err", "w") as f:
            f.write(traceback.format_exc())
        os._exit(1)


def phase_train_tp(torch, dev):
    """Phase 19 (module docstring).  Every gate raises."""
    row = {"phase": "train_tp", "gates": {}, "seconds": {}}

    def gate(name, ok):
        row["gates"][name] = bool(ok)

    # 19a: the training launcher on 2 ranks at --mesh 1x2, full width and depth
    t = time.perf_counter()
    rc, out, err, secs = _torchrun(["-m", "repro_torch.launch.train"] + LAUNCH19_ARGS,
                                   DIST_TIMEOUT)
    lines = out.splitlines()
    steps = [ln.split() for ln in lines if ln.startswith("step ")]
    losses = [float(s[3]) for s in steps]
    gnorms = [float(s[5]) for s in steps]

    def printed(prefix):
        got = [ln[len(prefix):] for ln in lines if ln.startswith(prefix)]
        return json.loads(got[0]) if got else None

    from repro_torch import configs

    whole_b, local_b = _train_bytes(configs.get_config("internlm2-1.8b"), 2)
    row["19a"] = {"rc": rc, "seconds": secs, "stdout_tail": lines[-14:], "losses": losses,
                  "grad_norms": gnorms, "step_ms_by_rank": printed("ranks' step ms: "),
                  "peak_bytes_by_rank": printed("ranks' peak bytes: "),
                  "collectives_per_step": printed("collectives per step: "),
                  "reckoned_bytes": {"whole_state_fp32": whole_b, "rank_state_fp32": local_b,
                                     "note": "params + momentum; the whole state is built "
                                             "on every rank before the cut"}}
    gate("19a_exit_0", rc == 0)
    gate("19a_losses_equal", "ranks' losses equal: True" in out and len(losses) == 2)
    gate("19a_finite", all(math.isfinite(x) for x in losses + gnorms) and len(gnorms) == 2)
    gate("19a_gloo", "backend gloo, 2 ranks" in out)
    if rc:
        print(out[-4000:], err[-6000:], file=sys.stderr, flush=True)
    row["seconds"]["19a"] = time.perf_counter() - t

    # 19b-19d: spawned ranks
    t = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="phase19_")
    ranks = _spawn_ranks(2, {}, tmp, target=_train_rank, phase="19")
    row["seconds"]["spawned_ranks"] = time.perf_counter() - t
    row["rank_seconds"] = [r["seconds"] for r in ranks]
    gate("19_spawned_gloo", all(r["backend"] == "gloo" for r in ranks))
    reckon = {"19b": (_tpt_cfg(), 2), "19c": (_ept_cfg(), 2), "19d": (_fsdp_cfg(), 2)}
    for case in ("19b", "19c", "19d"):
        cfg, split = reckon[case]
        whole_b, local_b = _train_bytes(cfg, split)
        row[case] = {"layers": cfg.n_layers, "arch": cfg.name,
                     "reckoned_bytes": {"whole_state_fp32": whole_b, "rank_state_fp32": local_b},
                     "ranks": [r[case] for r in ranks]}
        routes = list(ranks[0][case])
        for route in routes:
            r0, rs = ranks[0][case][route], [r[case][route] for r in ranks]
            one = r0["one_rank"]
            g = f"{case}_{route}"
            gate(f"{g}_params_within_{TRAIN_RTOL}", all(x["params_max_rel"] < TRAIN_RTOL
                                                        for x in rs))
            gate(f"{g}_losses_equal", rs[0]["metrics"]["loss"] == rs[1]["metrics"]["loss"]
                 and rs[0]["metrics"]["clip_scale"] == rs[1]["metrics"]["clip_scale"])
            gate(f"{g}_loss_vs_1_rank", abs(r0["metrics"]["loss"] - one["loss"])
                 <= TRAIN_RTOL * abs(one["loss"]))
            gate(f"{g}_grad_norm", math.isfinite(r0["metrics"]["grad_norm"])
                 and abs(r0["metrics"]["grad_norm"] - one["grad_norm"])
                 <= TRAIN_RTOL * one["grad_norm"])
            n_q = rs[0]["quantizable_leaves"]
            want = n_q if route == "fused" else 0
            gate(f"{g}_launches", all(x["launches"] == {"symog_update": want,
                                                       "symog_sqnorm": want} for x in rs))
            if route == "fused":
                for x in rs:
                    k = x["kernels"]
                    gate(f"{g}_shard_kernels", k["pass"])
    b, c, d = (ranks[0][k][list(ranks[0][k])[0]] for k in ("19b", "19c", "19d"))
    gate("19b_sharded", all(b["plan"][k] for k in ("attn", "mlp", "embed", "head")))
    gate("19c_ep", c["plan"]["ep"] and c["kernels"]["groups"] == EPT_LAYERS * 32)
    gate("19d_fsdp", d["fsdp_leaves"] > 0 and not d["plan"]["attn"])
    row["pass"] = all(row["gates"].values())
    emit(row)
    if not row["pass"]:
        raise Failed(f"phase 19 failed: {[k for k, v in row['gates'].items() if not v]}")
    return row, [r["20"] for r in ranks]


# ---------------------------------------------------------------------------
# phase 20: the tensor-parallel forms of mamba2, recurrentgemma, whisper and
# paligemma, two ranks on the one card
# ---------------------------------------------------------------------------
# depth cuts (full width): mamba2 2 of 64, recurrentgemma one RRL unit of 26,
# whisper 2 + 2 of 32 + 32, paligemma 2 of 18
FAMILY_TP_LAYERS = {"mamba2-2.7b": 2, "recurrentgemma-2b": 3, "whisper-large-v3": 2,
                    "paligemma-3b": 2}
FAMILY_TP_SEED = 200
FTP_NEW_TOKENS = 16
# the plan's pieces a family splits at m = 2 (the rest whole on both ranks)
FTP_PIECES = {"mamba2-2.7b": {"ssd", "embed", "head"},
              "recurrentgemma-2b": {"rglru", "mlp", "embed", "head"},
              "whisper-large-v3": {"attn", "mlp", "embed", "head"},
              "paligemma-3b": {"mlp", "embed", "head"}}
# 20c: one rank's packed projections of each family at m = 2, (name, K, N,
# bias): whisper's column-parallel biases go to the kernel, its row-parallel
# ones are added after the reduce
FTP_FPMM = {
    "mamba2-2.7b": [("in_proj_z", 2560, 2560, False), ("in_proj_x", 2560, 2560, False),
                    ("in_proj_B", 2560, 128, False), ("in_proj_C", 2560, 128, False),
                    ("in_proj_dt", 2560, 40, False), ("out_proj", 2560, 2560, False)],
    "recurrentgemma-2b": [("in_proj_x", 2560, 1280, False), ("in_proj_y", 2560, 1280, False),
                          ("out_proj", 1280, 2560, False), ("gate_proj", 2560, 3840, False),
                          ("up_proj", 2560, 3840, False), ("down_proj", 3840, 2560, False)],
    "whisper-large-v3": [(n, 1280, 640, True) for n in ("q_proj", "k_proj", "v_proj")]
    + [("o_proj", 640, 1280, False), ("fc1", 1280, 2560, True), ("fc2", 2560, 1280, False)],
    "paligemma-3b": [("q_proj", 2048, 2048, False), ("k_proj", 2048, 256, False),
                     ("v_proj", 2048, 256, False), ("o_proj", 2048, 2048, False),
                     ("gate_proj", 2048, 8192, False), ("up_proj", 2048, 8192, False),
                     ("down_proj", 8192, 2048, False)],
}
FTP_FPMM_M = (4, 512)
# 20a's two serves of each artifact: fp32 (the streaming matmul; gated
# token-identical to one rank) and bf16 (the decode and tensor-core matmul
# kernels at one rank's shapes; launches gated equal to one rank's)
FTP_COMPUTE = {"fp32": "float32", "bf16": "bfloat16"}
FTP_ATTN = dict(B=4, K=10, G=1, hd=64, block=16, max_blocks=32, pos_last=(280, 320))


def _ftp_cfg(arch):
    from repro_torch import configs

    cfg = configs.get_config(arch)
    n = FAMILY_TP_LAYERS[arch]
    return dataclasses.replace(cfg, n_layers=n,
                               **({"n_encoder_layers": n} if cfg.n_encoder_layers else {}))


def _ftp_artifact(torch, dev, arch):
    """(config, the family's 2-bit artifact from the seeded fp32 init: the
    same bits on every process of the card, max_len)."""
    cfg = _ftp_cfg(arch)
    seed = FAMILY_TP_SEED + list(FAMILY_TP_LAYERS).index(arch)
    return cfg, _dist_artifact(torch, dev, cfg, seed), 512 + (
        cfg.prefix_len if cfg.family == "vlm" else 0)


def _same_share(a, b) -> float:
    """The share of tokens two sets of streams agree on, position by position."""
    pairs = [(x, y) for s, t in zip(a, b) for x, y in zip(s, t)]
    return sum(x == y for x, y in pairs) / max(1, len(pairs))


def _ftp_traffic(cfg):
    """4 requests of 24..400 prompt tokens, 16 new each, each with its own
    frames / patches."""
    import numpy as np
    from repro_torch.serve import Request

    rng = np.random.default_rng(20)
    lens = rng.integers(24, 401, size=4)
    return [Request(tokens=rng.integers(0, cfg.vocab_size, size=int(L)),
                    max_new_tokens=FTP_NEW_TOKENS, extras=stub_extras(cfg, rng)) for L in lens]


def _ftp_serve(torch, eng, timing: bool = False):
    """A greedy serve of ``_ftp_traffic`` (4 slots, block 16), the launch
    counts zeroed just before and read just after; each decode step's host
    ms (dispatch through its sync); with ``timing`` every collective timed
    (a device sync before each), giving gloo's share of the serve."""
    import numpy as np
    from repro_torch.distributed import collectives
    from repro_torch.models.lm import CROSS_CACHE_LEAVES
    from repro_torch.serve import ServeConfig
    from repro_torch.serve.scheduler import Scheduler

    reqs = _ftp_traffic(eng.global_cfg)
    sched = Scheduler(eng, ServeConfig(n_slots=4, block_size=16).resolve(eng, reqs))
    for r in reqs:
        sched.submit(r)
    torch.cuda.synchronize()
    collectives.reset_stats()
    collectives.timing = timing
    zero_counts()
    t = time.perf_counter()
    try:
        comps, steps = _decode_ms(sched)
        torch.cuda.synchronize()
    finally:
        collectives.timing = False
    wall = time.perf_counter() - t
    counts = read_counts()
    gloo_s = sum(collectives.stats["seconds"].values())
    cross = sum(leaf.numel() * leaf.element_size() for g in sched.caches.values()
                for sub in g.values() for n, leaf in sub.items() if n in CROSS_CACHE_LEAVES)
    resident = sched.cache_bytes() - sched.paged_pool_bytes()
    return {"tokens": [list(map(int, c.tokens)) for c in comps], "launches": counts,
            "wall_s": wall, "decode_steps": len(steps),
            "decode_step_ms_p50": float(np.percentile(steps, 50)) if steps else None,
            "decode_step_ms_mean": float(np.mean(steps)) if steps else None,
            "gloo_s": gloo_s if timing else None,
            "gloo_share_of_serve": gloo_s / wall if timing else None,
            "collective_calls": dict(collectives.stats["calls"]),
            "collective_bytes": dict(collectives.stats["bytes"]),
            "pool_bytes": sched.cache_bytes(), "paged_pool_bytes": sched.paged_pool_bytes(),
            "resident_bytes": resident, "cross_kv_bytes": cross,
            "resident_state_bytes": resident - cross, "weight_bytes": eng.weight_bytes()}


def _family_rank_work(torch, dev, rank, mesh):
    """20a and 20b on one rank of phase 19's spawned pair, after 19b–19d.
    Each family's 1-rank serve runs on rank 0 alone (rank 1 waits), and its
    streams and counts go to both ranks; then both serve the same artifact
    on ``mesh``, twice (the second with every collective timed), and take
    one sharded step (``_rank_train_case``, rank 0's 1-rank step first)."""
    import torch.distributed as dist

    from repro_torch.serve import ServeEngine

    out = {"seconds": {}, "serve": {}, "train": {}, "one_rank": {}}
    for arch in FAMILY_TP_LAYERS:
        t = time.perf_counter()
        cfg, tree, max_len = _ftp_artifact(torch, dev, arch)

        def engine(dt, m=None):
            return ServeEngine(cfg, tree, max_len=max_len, compute_dtype=getattr(torch, dt),
                               device=dev, mesh=m)

        box = [None]
        if rank == 0:
            box[0] = {name: _ftp_serve(torch, engine(dt)) for name, dt in FTP_COMPUTE.items()}
            torch.cuda.empty_cache()
        dist.broadcast_object_list(box, src=0)
        one = box[0]
        if rank == 0:
            out["one_rank"][arch] = {n: {k: v for k, v in x.items() if k != "tokens"}
                                     for n, x in one.items()}
        res = {}
        for name, dt in FTP_COMPUTE.items():
            eng = engine(dt, mesh)
            first = _ftp_serve(torch, eng)
            first.update(
                tokens_equal_1_rank=first["tokens"] == one[name]["tokens"],
                identical_token_share=_same_share(first["tokens"], one[name]["tokens"]),
                launches_equal_1_rank=first["launches"] == one[name]["launches"])
            if name == "fp32":
                again = _ftp_serve(torch, eng, timing=True)
                first.update(
                    repeat_identical=again["tokens"] == first["tokens"],
                    gloo_s=again["gloo_s"], gloo_share_of_serve=again["gloo_share_of_serve"],
                    timed_wall_s=again["wall_s"],
                    plan={k: getattr(eng.tp, k) for k in ("attn", "mlp", "embed", "head",
                                                           "ssd", "rglru")},
                    local={k: getattr(eng.cfg, k) for k in ("n_heads", "n_kv_heads",
                                                            "d_inner", "ssm_heads", "d_rnn",
                                                            "rnn_heads")})
            del first["tokens"], eng
            res[name] = first
        out["serve"][arch] = res
        del tree
        torch.cuda.empty_cache()
        out["seconds"][f"20a {arch}"] = time.perf_counter() - t
    for arch in FAMILY_TP_LAYERS:
        t = time.perf_counter()
        seed = FAMILY_TP_SEED + 10 + list(FAMILY_TP_LAYERS).index(arch)
        out["train"][arch] = _rank_train_case(torch, dev, rank, mesh, _ftp_cfg(arch), seed,
                                              ("fused",), None, True)
        out["seconds"][f"20b {arch}"] = time.perf_counter() - t
    return out


def phase_family_tp(torch, dev, ranks):
    """Phase 20 (module docstring) from ``ranks``, the 20a / 20b results of
    phase 19's spawned pair, then 20c here.  Every gate raises."""
    row = {"phase": "family_tp", "gates": {}, "seconds": {}, "layers": FAMILY_TP_LAYERS,
           "rank_seconds": [r["seconds"] for r in ranks]}

    def gate(name, ok):
        row["gates"][name] = bool(ok)

    row["20a"] = {}
    for arch in FAMILY_TP_LAYERS:
        ones = ranks[0]["one_rank"][arch]
        o, rs = ones["fp32"], [r["serve"][arch]["fp32"] for r in ranks]
        b16 = [r["serve"][arch]["bf16"] for r in ranks]
        cfg = _ftp_cfg(arch)
        row["20a"][arch] = {"one_rank": ones, "ranks": [r["serve"][arch] for r in ranks]}
        g = f"20a_{arch}"
        gate(f"{g}_tokens_equal_1_rank", all(x["tokens_equal_1_rank"] for x in rs))
        gate(f"{g}_repeat_identical", all(x["repeat_identical"] for x in rs))
        gate(f"{g}_launches_equal_1_rank", all(x["launches_equal_1_rank"] for x in rs + b16))
        attn = cfg.family == "ssm" or o["launches"]["paged_attention"] > 0
        gate(f"{g}_kernels_launched", o["launches"]["fixedpoint_matmul"] > 0 and attn)
        gate(f"{g}_bf16_kernels_launched",
             all(x["launches"]["fixedpoint_matmul_decode"] > 0
                 and x["launches"]["fixedpoint_matmul_tc"] > 0 for x in b16))
        gate(f"{g}_pieces", all({k for k, v in x["plan"].items() if v} == FTP_PIECES[arch]
                                for x in rs))
        if arch == "whisper-large-v3":  # cross-kv and self-attention pool at K/2 heads
            gate(f"{g}_cross_kv_half", all(2 * x["cross_kv_bytes"] == o["cross_kv_bytes"]
                                           for x in rs))
            gate(f"{g}_pool_half", all(2 * x["paged_pool_bytes"] == o["paged_pool_bytes"]
                                       for x in rs))
        elif arch in ("mamba2-2.7b", "recurrentgemma-2b"):  # state at H/2 heads
            gate(f"{g}_state_split", all(x["resident_state_bytes"] < o["resident_state_bytes"]
                                         for x in rs))
    row["20b"] = {}
    for arch in FAMILY_TP_LAYERS:
        rs = [r["train"][arch]["fused"] for r in ranks]
        one_step = rs[0]["one_rank"]
        row["20b"][arch] = {"layers": FAMILY_TP_LAYERS[arch], "ranks": rs}
        g = f"20b_{arch}"
        gate(f"{g}_params_within_{TRAIN_RTOL}_{TRAIN_ATOL}",
             all(x["params_worst_miss"] <= 0 for x in rs))
        gate(f"{g}_losses_equal", rs[0]["metrics"]["loss"] == rs[1]["metrics"]["loss"]
             and rs[0]["metrics"]["clip_scale"] == rs[1]["metrics"]["clip_scale"]
             and rs[0]["metrics"]["grad_norm"] == rs[1]["metrics"]["grad_norm"])
        gate(f"{g}_loss_vs_1_rank", abs(rs[0]["metrics"]["loss"] - one_step["loss"])
             <= TRAIN_RTOL * abs(one_step["loss"]))
        n_q = rs[0]["quantizable_leaves"]
        gate(f"{g}_launches", all(x["launches"] == {"symog_update": n_q, "symog_sqnorm": n_q}
                                  for x in rs))
        gate(f"{g}_pieces", all({k for k, v in x["plan"].items() if v and k != "ep"}
                                == FTP_PIECES[arch] for x in rs))

    # 20c: the kernels at one rank's shapes
    t = time.perf_counter()
    gen = torch.Generator(device=dev)
    gen.manual_seed(20)
    keys = ("ms", "stream_ms", "plain_ms", "library_ms", "bound_ms")
    cases = []
    for arch, shapes in FTP_FPMM.items():
        for M in FTP_FPMM_M:
            acc = dict.fromkeys(keys, 0.0)
            set_rows = []
            for name, K, N, bias in shapes:
                r = _fpmm_case(torch, gen, dev, name, K, N, M, torch.bfloat16, 2,
                               with_bias=bias, timing=True,
                               routes=_bf16_routes(torch.bfloat16, M))
                r.update(arch=f"{arch} rank of 2")
                emit(r)
                for k in keys:
                    acc[k] += r[k]
                set_rows.append(r)
                gate(f"20c_{arch}_{name}_M{M}", r["pass"])
            cases.append(dict(acc, kernel=MATMUL_KERNEL[set_rows[-1]["route"]], arch=arch, M=M,
                              route=set_rows[-1]["route"],
                              max_abs_err=max(x["max_abs_err"] for x in set_rows),
                              bound_by=_bound_by(set_rows), projections=len(shapes)))
        torch.cuda.empty_cache()
    for int8 in (False, True):
        a = _attn_dense_case(torch, gen, dev, dict(FTP_ATTN),
                             dict(T=1, dt=torch.bfloat16, int8=int8, q_mult=1.0, window=None,
                                  cap=0.0, scale=64**-0.5, arch="whisper-large-v3 rank of 2"))
        gate(f"20c_gqa_decode_{'int8' if int8 else 'bf16'}", a["pass"])
        cases.append({"kernel": "paged_attention", "arch": "whisper-large-v3", "shape": FTP_ATTN,
                      "pool": "kv_f int8" if int8 else "bf16",
                      **{k: a.get(k) for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                                               "bound_by", "max_abs_err")}})
    row["20c"] = cases
    row["seconds"]["20c"] = time.perf_counter() - t
    row["pass"] = all(row["gates"].values())
    emit(row)
    if not row["pass"]:
        raise Failed(f"phase 20 failed: {[k for k, v in row['gates'].items() if not v]}")
    return row


# ---------------------------------------------------------------------------
# 21. the dry run (launch/dryrun.py) calibrated against the card: its fake
# trace of a step against the same step run for real
# ---------------------------------------------------------------------------
DRYRUN_MEM_RTOL = 0.10  # the card's peak within ±10% of the traced peak
DRYRUN_TRAIN = (8, 128)  # 21a: rows x tokens
DRYRUN_SERVE = (4, 512, 32)  # 21b: rows x prompt tokens, decode steps
# 21c: (arch, shape, --quantized) cells of the dry-run CLI at 16x16
DRYRUN_CELLS = (("internlm2-1.8b", "train_4k", False), ("internlm2-1.8b", "prefill_32k", False),
                ("internlm2-1.8b", "decode_32k", False), ("internlm2-1.8b", "decode_32k", True),
                ("mamba2-2.7b", "long_500k", False), ("whisper-large-v3", "long_500k", False))
DRYRUN_CLI_TIMEOUT = 240  # phase 21's wait for the 21c subprocesses still running


def _free_card(torch) -> None:
    import gc

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def _real_step(torch, dev, build, counted: bool = True):
    """Build ``(state, run)`` on the card and run it once: the run's
    op_cost (when ``counted``), its peak above the memory in use before the
    build (``torch.cuda.max_memory_allocated``, reset after the build), the
    state's bytes and the run's ms."""
    from repro_torch.launch.op_cost import OpCounter

    _free_card(torch)
    base = torch.cuda.memory_allocated(dev)
    state, run = build()
    torch.cuda.synchronize()
    state_bytes = torch.cuda.memory_allocated(dev) - base
    torch.cuda.reset_peak_memory_stats(dev)
    ops = OpCounter()
    t = time.perf_counter()
    with ops if counted else contextlib.nullcontext():
        run()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t) * 1e3
    peak = torch.cuda.max_memory_allocated(dev) - base
    del state, run
    _free_card(torch)
    return {"logical": dict(ops.totals) if counted else None, "peak_bytes": peak,
            "state_bytes": state_bytes, "ms": ms}


def _traced(torch, dev, build):
    """``build()``'s run traced on fake tensors of the card (``dryrun.measure``)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.launch import dryrun

    with FakeTensorMode():
        state, run = build()
        out = dryrun.measure(run, state, dev)
    del out["records"]
    return out


def _calibrate(torch, dev, name, build):
    """One 21a / 21b case on the plain routes: the trace and the real run,
    and the two gates (counts equal; real peak within DRYRUN_MEM_RTOL of the
    traced peak)."""
    from repro_torch.launch import dryrun

    with dryrun.plain_routes():
        tr = _traced(torch, dev, build)
        real = _real_step(torch, dev, build)
    rel = (real["peak_bytes"] - tr["peak_bytes"]) / tr["peak_bytes"]
    return {"case": name, "traced": tr, "real": real, "peak_rel_diff": rel,
            "gates": {"counts_equal": real["logical"] == tr["logical"],
                      "peak_within_10pct": abs(rel) <= DRYRUN_MEM_RTOL}}


def _dryrun_train_build(torch, dev, cfg):
    from repro_torch.configs import ShapeCell
    from repro_torch.launch import dryrun
    from repro_torch.nn.sharding import Mesh

    rows, seq = DRYRUN_TRAIN
    cell = ShapeCell("train", "train", seq, rows)
    mesh = Mesh((1, 1), ("data", "model"))
    return lambda: dryrun.train_case(cfg, cell, mesh, 1, dev)


def _dryrun_serve_build(torch, dev, cfg):
    """A 2-bit packed prefill of rows x prompt tokens, then the decode steps
    on its dense caches, each step's token the argmax of the last logits."""
    from repro_torch.launch import dryrun
    from repro_torch.models.lm import decode_lm, prefill_lm
    from repro_torch.nn.sharding import Mesh

    rows, prompt, steps = DRYRUN_SERVE
    mesh = Mesh((1, 1), ("data", "model"))

    def build():
        plan, lcfg, params = dryrun.serve_params(cfg, mesh, True, dev, shapes_only=False)
        tokens = torch.zeros((rows, prompt), dtype=torch.int32, device=dev)

        def serve():
            logits, caches = prefill_lm(params, {"tokens": tokens}, lcfg, max_len=prompt + steps)
            tok = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
            for i in range(steps):
                logits, caches = decode_lm(params, caches, tok, prompt + i, lcfg)
                tok = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
            return tok

        return (params, tokens), dryrun.served(plan, mesh, serve)

    return build


def _dryrun_cli_start():
    """21c: the dry-run CLI, one subprocess a cell, all started at once (16x16,
    rank 0 on fake tensors of the card; host CPU only, at niceness 10: they
    trace on the host's spare cores while phases 18-20 run)."""
    from repro_torch.launch import dryrun

    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.path.join(here, "src"), OMP_NUM_THREADS="1")
    procs = []
    for arch, shape, q in DRYRUN_CELLS:
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
               "--shape", shape] + (["--quantized"] if q else [])
        path = dryrun._result_path(arch, shape, False, q)
        if os.path.exists(path):
            os.remove(path)
        err = tempfile.TemporaryFile("w+")  # not a pipe: nothing blocks unread
        proc = subprocess.Popen(cmd, cwd=here, env=env, stdout=subprocess.DEVNULL, stderr=err,
                                text=True, start_new_session=True,
                                preexec_fn=lambda: os.nice(10))
        procs.append((arch, shape, q, path, proc, err))
    return procs


def _dryrun_cli_finish(procs):
    """21c's records, waiting at most DRYRUN_CLI_TIMEOUT for the subprocesses
    still running (those left then are killed)."""
    from repro_torch.configs import cell_supported, get_config

    t0 = time.perf_counter()
    cells = []
    for arch, shape, q, path, proc, err_file in procs:
        try:
            proc.wait(timeout=max(1.0, DRYRUN_CLI_TIMEOUT - (time.perf_counter() - t0)))
        except subprocess.TimeoutExpired:
            _dryrun_cli_stop([(arch, shape, q, path, proc, err_file)])
        err_file.seek(0)
        err = err_file.read()
        rec = {"status": "NO RECORD"}
        if os.path.exists(path):
            with open(path) as f:
                rec = json.load(f)
        want = "OK" if cell_supported(get_config(arch), shape)[0] else "SKIP"
        mem = rec.get("memory", {})
        cells.append({
            "arch": arch, "shape": shape, "quantized": q, "rc": proc.returncode,
            "status": rec.get("status"), "want": want, "site": rec.get("site"),
            "trace_s": rec.get("trace_s"), "trace_device": rec.get("trace_device"),
            "peak_GB": mem.get("peak_bytes", 0) / 1e9 if mem else None,
            "state_GB": mem.get("state_bytes", 0) / 1e9 if mem else None,
            "fits_80GB": mem.get("fits"),
            "dominant": rec.get("roofline", {}).get("dominant"),
            "roofline_s": {k: rec["roofline"][k] for k in ("compute_s", "memory_s",
                                                          "collective_s")}
            if "roofline" in rec else None,
            "collective_total_bytes": rec.get("collectives", {}).get("total_bytes"),
            "stderr_tail": (err or "")[-400:] if rec.get("status") != want else ""})
    return cells, time.perf_counter() - t0


def _dryrun_cli_stop(procs) -> None:
    """Kill every 21c subprocess still running (and its process group)."""
    import signal

    for *_, proc, _err in procs:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()


def phase_dryrun(torch, dev, cli_procs):
    """Phase 21 (module docstring); ``cli_procs`` from ``_dryrun_cli_start``,
    started before phase 18.  Every gate raises."""
    row = {"phase": "dryrun", "gates": {}, "seconds": {},
           "total_memory_bytes": torch.cuda.get_device_properties(0).total_memory}
    _dryrun_calibration(torch, dev, row)
    cells, secs = _dryrun_cli_finish(cli_procs)
    row["21c"] = cells
    row["seconds"]["21c_wait"] = secs
    row["gates"]["21c statuses as cell_supported says"] = all(
        c["status"] == c["want"] for c in cells)
    row["pass"] = all(row["gates"].values())
    emit(row)
    if not row["pass"]:
        raise Failed(f"phase 21 failed: {[k for k, v in row['gates'].items() if not v]}")
    return row


def _dryrun_calibration(torch, dev, row):
    """21a and 21b into ``row``."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import dispatch

    cfg = dataclasses.replace(get_config("internlm2-1.8b"), remat=True)
    t = time.perf_counter()
    train_build = _dryrun_train_build(torch, dev, cfg)
    a = _calibrate(torch, dev, "21a train", train_build)
    # the fused route's step, the kernel counted
    prev = dispatch.get_update_backend()
    dispatch.set_update_backend("fused")
    try:
        zero_counts()
        fused = _real_step(torch, dev, train_build, counted=False)
        fused["launches"] = {k: v for k, v in read_counts().items() if v}
    finally:
        dispatch.set_update_backend(prev)
    a["fused_real"] = fused
    row["21a"] = a
    row["seconds"]["21a"] = time.perf_counter() - t
    t = time.perf_counter()
    serve_cfg = dataclasses.replace(cfg, n_layers=SERVE_LAYERS["internlm2-1.8b"])
    row["21b_layers"] = serve_cfg.n_layers
    serve_build = _dryrun_serve_build(torch, dev, serve_cfg)
    b = _calibrate(torch, dev, "21b serve", serve_build)
    prev = dispatch.get_packed_backend()
    dispatch.set_packed_backend("kernel")
    try:
        zero_counts()
        kern = _real_step(torch, dev, serve_build, counted=False)
        kern["launches"] = {k: v for k, v in read_counts().items() if v}
    finally:
        dispatch.set_packed_backend(prev)
    b["kernel_route_real"] = kern
    row["21b"] = b
    row["seconds"]["21b"] = time.perf_counter() - t
    for case in ("21a", "21b"):
        for g, ok in row[case]["gates"].items():
            row["gates"][f"{case} {g}"] = ok
    row["gates"]["21a fused route launched symog_update"] = (
        fused["launches"].get("symog_update", 0) > 0)
    row["gates"]["21b kernel route launched the matmul kernels"] = (
        kern["launches"].get("fixedpoint_matmul_decode", 0) > 0
        and kern["launches"].get("fixedpoint_matmul_tc", 0) > 0)


def main() -> int:
    argparse.ArgumentParser(description=__doc__.split("\n")[0]).parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.join(here, "src"))
    try:
        from repro_torch import configs
        from repro_torch.kernels import build
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here ({e})", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False  # fp32 references stay fp32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()
    smi = nvidia_smi()
    emit({"phase": "device", "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count()})
    t0 = time.perf_counter()
    build.library()
    regs = [ln.strip() for ln in build.build_log.splitlines() if "registers" in ln]
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "hash": build.source_hash(),
          "ptxas": regs[:40]})

    seconds = {}

    def run(name, fn, *args, **kw):
        t = time.perf_counter()
        out = fn(*args, **kw)
        torch.cuda.synchronize()
        seconds[name] = seconds.get(name, 0.0) + time.perf_counter() - t
        return out

    try:
        fp_rows, fp_decode, fp_prefill = run("3a fixedpoint_matmul", phase_fpmm, torch, dev)
        attn_rows, at_err, at_main = run("3b paged_attention", phase_attn, torch, dev)
        sy_rows, sy_err, sy_full = run("3c symog_update", phase_symog, torch, dev,
                                       configs.get_config("internlm2-1.8b"))
        fe_rows, fe_decode, fe_prefill = run("3d fixedpoint_matmul_experts",
                                             phase_fpmm_experts, torch, dev)
        head = run("3d fixedpoint_matmul_experts", phase_fpmm_head, torch, dev)
        fpd_rows, fpd_layer = run("3a fixedpoint_matmul deepseek", phase_fpmm_deepseek,
                                  torch, dev)
        fed_rows, fed_decode, fed_prefill = run("3d fixedpoint_matmul_experts deepseek",
                                                phase_fpmm_experts_deepseek, torch, dev)
        fpg_rows, fpg_layer, fpg_head, fpg_tails = run("3a fixedpoint_matmul gemma3",
                                                       phase_fpmm_gemma3, torch, dev)
        cx_rows, cross = run("3g crossover", phase_crossover, torch, dev)
        aq_rows, aq_err, aq_main = run("3e paged_attention_quant", phase_attn_quant, torch, dev)
        pf_cross = run("3e prefill crossover", phase_prefill_crossover, torch, dev)
        mla_rows, mla_err, mla_main = run("3f paged_attention_mla", phase_attn_mla, torch, dev)
        run("4 parity internlm2", phase_parity, torch, dev, PARITY_LAYERS)
        for arch in ("gemma2-27b", "granite-34b"):
            run("4 parity " + arch, phase_parity, torch, dev, PARITY_LAYERS, arch=arch)
        # gemma3 admitted through the tail prefill, from a bf16 pool and from
        # an int4 pool (its writes held to the CPU's, the plain route reading
        # the kernel route's words), logits held to the plain path both
        # times; 6 layers so that its global layer (rope base 1e6, no window)
        # is among them
        run("4 parity gemma3-4b", phase_parity, torch, dev, 6, arch="gemma3-4b", tail=True)
        par_g3 = run("4 parity gemma3-4b", phase_parity, torch, dev, 6, arch="gemma3-4b",
                     kv_cache_dtype="int4_fp")
        pf_model = run("4 prefill route gemma3-4b", phase_prefill_route_model, torch, dev)
        par_olmoe = run("4 parity olmoe", phase_parity, torch, dev, PARITY_LAYERS,
                        arch="olmoe-1b-7b")
        run("4 parity olmoe", phase_parity, torch, dev, PARITY_LAYERS, arch="olmoe-1b-7b",
            kv_cache_dtype="int4_fp")
        # deepseek-v3, 3 dense + 1 MoE layer: one layer-by-layer artifact, served
        # from a bf16 and from an int4 MLA pool
        art = {}

        def ds_build(cfg):
            if "tree" not in art:
                art["tree"] = build_layerwise(torch, dev, cfg, 11)[0]
            return art["tree"]

        par_ds = {kv: run("4 parity deepseek", phase_parity, torch, dev, PARITY_LAYERS,
                          arch=DEEPSEEK, kv_cache_dtype=kv, build=ds_build, plain_packed="kernel")
                  for kv in ("bf16", "int4_fp")}
        del art
        torch.cuda.empty_cache()
        serve, eng, fe_reqs, fe_tokens = run("5 serve internlm2", phase_serve_internlm2, torch,
                                             dev)
        run("6 profile internlm2", phase_profile, torch, dev, eng)
        run("13 front end", phase_front_end, torch, dev, eng, fe_reqs, fe_tokens)
        del eng
        torch.cuda.empty_cache()
        train = run("7 train internlm2", phase_train, torch, dev)
        train_moe = run("7b train olmoe", phase_train_olmoe, torch, dev)
        train_ds = run("7c train deepseek reduced", phase_train_reduced, torch, dev)
        olmoe, eng = run("8 serve olmoe", phase_serve_olmoe, torch, dev)
        run("8 profile olmoe", phase_profile, torch, dev, eng)
        del eng
        torch.cuda.empty_cache()
        deepseek, eng = run("9 serve deepseek", phase_serve_deepseek, torch, dev)
        # the decode step under the parent's MLA route rule and under this
        # one, in turns (parent, this, this, parent): host time spreads widely
        for rule in (_parent_mla_route, None, None, _parent_mla_route):
            run("9 profile deepseek", phase_profile, torch, dev, eng, mla_rule=rule)
        del eng
        torch.cuda.empty_cache()
        gemma3, eng = run("10 serve gemma3", phase_serve_gemma3, torch, dev)
        run("10 profile gemma3", phase_profile, torch, dev, eng)
        prefix = run("11a prefix cache and chunks", phase_prefix_chunks, torch, dev, eng)
        del eng
        torch.cuda.empty_cache()
        run("11b prefix and chunk parity", phase_prefix_parity, torch, dev)
        spec = run("11c speculative", phase_speculative, torch, dev)
        verify = run("11d verify parity", phase_verify_parity, torch, dev)
        run("12a cnn parity", phase_cnn_parity, torch, dev)
        lenet = run("12b cnn lenet5", phase_cnn_lenet, torch, dev)
        vgg7 = run("12c cnn vgg7", phase_cnn_vgg7, torch, dev)
        rec_fp_rows, rec_fp = run("14a fixedpoint_matmul recurrent", phase_fpmm_recurrent,
                                  torch, dev)
        rec_attn = run("14b paged_attention recurrentgemma", phase_attn_recurrent, torch, dev)
        for arch, n in RECURRENT_PARITY_LAYERS.items():
            run("14c parity " + arch, phase_parity_recurrent, torch, dev, arch, n)
        rec_serves = run("14d serve recurrent", phase_serve_recurrent, torch, dev, rec_fp)
        run("14e recurrent card vs cpu", phase_recurrent_card_vs_cpu, torch, dev)
        ev_fp_rows, ev_fp = run("15a fixedpoint_matmul encdec vlm", phase_fpmm_encdec_vlm,
                                torch, dev)
        ev_attn = run("15b paged_attention encdec vlm", phase_attn_encdec_vlm, torch, dev)
        for arch, n in ENCDEC_VLM_PARITY.items():
            run("15c parity " + arch, phase_parity_encdec_vlm, torch, dev, arch, n)
        ev_serves = run("15d serve encdec vlm", phase_serve_encdec_vlm, torch, dev)
        run("15e encdec vlm card vs cpu", phase_encdec_vlm_card_vs_cpu, torch, dev)
        fam_train = {arch: run("16a train " + arch, phase_train_family, torch, dev, arch,
                               60 + i) for i, arch in enumerate(FAMILY_TRAIN_SEQ)}
        fam_reduced = {arch: run("16b train reduced " + arch, phase_train_reduced, torch, dev,
                                 arch) for arch in FAMILY_TRAIN_SEQ}
        launcher = run("17a launcher", phase_launcher, torch, dev)
        with tempfile.TemporaryDirectory() as tmp:
            run("17b launcher resume", phase_launcher_resume, torch, dev, tmp)
        clipped = run("17c symog_update clipped", phase_symog_clipped, torch, dev,
                      configs.get_config("internlm2-1.8b"))
        run("17d experiments", phase_experiments, torch, dev)
        # 21c's dry-run CLI cells trace on the host's spare cores (no device
        # work) while phases 18-20 run; phase 21 reads their records
        cli21 = _dryrun_cli_start()
        try:
            dist18 = run("18 distribution", phase_dist, torch, dev)
            train19, ranks20 = run("19 tp and fsdp training", phase_train_tp, torch, dev)
            fam20 = run("20 family tp", phase_family_tp, torch, dev, ranks20)
            dry21 = run("21 dry run", phase_dryrun, torch, dev, cli21)
        finally:
            _dryrun_cli_stop(cli21)
    except Failed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    emit({"phase": "seconds", "by_phase": seconds,
          "total_s": time.perf_counter() - t_start})
    mm_rows = (fp_rows + fpd_rows + fpg_rows + rec_fp_rows + ev_fp_rows + [head]
               + [r for r in cx_rows if "M" in r])
    ex_rows = fe_rows + fed_rows + [r for r in cx_rows if "C" in r]
    # at every case the rule sends to the tensor cores, they must be faster
    tc_cases = [r for r in mm_rows + ex_rows if r["route"] == "tensor_core" and "stream_ms" in r]
    tc_faster = all(r["tc_ms"] < r["stream_ms"] for r in tc_cases)
    # and at every timed case the rule sends to the decode kernel, it must
    # beat the streaming kernel it replaces there
    dec_cases = [r for r in mm_rows + ex_rows if r["route"] == "decode" and "stream_ms" in r]
    dec_faster = all(r["dec_ms"] < r["stream_ms"] for r in dec_cases)
    # the streaming kernels now serve fp32 calls only: the MoE serves' fp32
    # head, and (experts form) the fp32 parity phases
    fe_fp32 = {k: sum(r[k] for r in fe_rows if r["dtype"] == "float32" and r["C"] == 4
                      and r["n_bits"] == 2) for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
    par_ex = par_olmoe["matmul_launches"]["kernels"]["fixedpoint_matmul_experts"]
    summary = [
        {"name": "fixedpoint_matmul", "route": "cuda",
         "source": "src/repro_torch/csrc/fixedpoint_matmul.cu",
         "replaces": "src/repro/kernels/fixedpoint_matmul/kernel.py:30",
         "launches": olmoe["launches"]["fixedpoint_matmul"],
         "max_abs_err": _route_err(mm_rows, "streaming"),
         "ms": head["ms"], "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
         "bound_by": head["bound_by"], "library_ms": head["library_ms"],
         "work": "olmoe's packed head (the MoE serves' fp32 head) at M=4, K 2048, N 50304, "
                 "2-bit, fp32 x",
         "launches_from": "olmoe-1b-7b serve: the fp32 head, once a decode step and admission",
         "internlm2_decode_layer_streaming_ms": fp_decode["stream_ms"],
         "pass": all(r["pass"] for r in fp_rows + fpd_rows)},
        {"name": "paged_attention", "route": "cuda",
         "source": "src/repro_torch/csrc/paged_attention.cu",
         "replaces": "src/repro/kernels/paged_attention/kernel.py:89",
         "launches": serve["launches"]["paged_attention"],
         "max_abs_err": at_err, "ms": at_main["ms"], "plain_ms": at_main["plain_ms"],
         "bound_ms": at_main["bound_ms"], "bound_by": at_main["bound_by"],
         "library_ms": at_main["library_ms"],
         "work": "B=4 K=8 G=2 hd=128 block=16 T=1 bf16, ~300 cached tokens a row",
         "length_sweep": [_sweep_entry(r) for r in at_main["length_sweep"]],
         "dense_decode_cases": [_case_entry(r) for r in attn_rows if r.get("arch")],
         "launches_gemma3_bf16_pool_serve": gemma3["bf16_pool_launches"]["paged_attention"],
         "verify_cases": [_case_entry(r) for r in attn_rows if r.get("verify")],
         "launches_speculative_serves": {t: r["launches"]["paged_attention"]
                                         for t, r in spec.items()},
         "launches_verify_parity": verify["attention_launches"],
         "recurrentgemma_decode_cases": [dict(_case_entry(r), kv_dtype=r["kv_dtype"])
                                         for r in rec_attn],
         "launches_recurrentgemma_serves": {
             k: r["launches"]["paged_attention"] for k, r in rec_serves.items()},
         "encdec_vlm_decode_cases": [dict(_case_entry(r), kv_dtype=r["kv_dtype"])
                                     for r in ev_attn],
         "launches_encdec_vlm_serves": {
             k: r["launches"]["paged_attention"] for k, r in ev_serves.items()},
         "pass": all(r["pass"] for r in attn_rows + rec_attn + ev_attn)},
        {"name": "symog_update", "route": "cuda",
         "source": "src/repro_torch/csrc/symog_update.cu",
         "replaces": "src/repro/kernels/symog_update/kernel.py:25",
         "launches": train["symog_update_launches"],
         "max_abs_err": sy_err, "ms": sy_full["ms"], "plain_ms": sy_full["plain_ms"],
         "bound_ms": sy_full["bound_ms"], "bound_by": "bytes", "library_ms": None,
         "library_note": "no single PyTorch call computes the SYMOG step (quantize, "
                         "regularizer gradient, Nesterov momentum and clip)",
         "work": f"one full-width internlm2-1.8b update: the 8 quantizable leaves, "
                 f"{sy_full['elements']} fp32 elements, 20 B each (one Δ a leaf)",
         "launches_from": "internlm2-1.8b train (24 layers, 6 steps x 8 leaves)",
         "grouped_delta_cases": [
             {k: r[k] for k in ("leaf", "shape", "f_shape", "group", "path", "ms", "plain_ms",
                                "bound_ms", "bound_by", "max_abs_err",
                                "bit_identical_both_calls")}
             for r in sy_rows if r["case"] == "grouped_delta"],
         "launches_olmoe_train": train_moe["symog_update_launches"],
         "launches_deepseek_reduced_train": train_ds["symog_update_launches"],
         "launches_lenet5_symog": lenet["symog_update_launches"],
         "launches_vgg7_symog": vgg7["symog_update_launches"],
         "launches_family_train": {a: r["symog_update_launches"] for a, r in fam_train.items()},
         "family_train_leaves": {a: r["quantizable_leaves"] for a, r in fam_train.items()},
         "family_largest_leaf_cases": {a: r["largest_leaf_update"]
                                       for a, r in fam_train.items()},
         "launches_family_reduced_train": {a: r["symog_update_launches"]
                                           for a, r in fam_reduced.items()},
         "pass": all(r["pass"] for r in sy_rows) and train_moe["symog_update_launches"] > 0
         and all(r["symog_update_launches"] > 0 for r in fam_train.values())},
        {"name": "fixedpoint_matmul_experts", "route": "cuda",
         "source": "src/repro_torch/csrc/fixedpoint_matmul.cu",
         "replaces": "src/repro/kernels/fixedpoint_matmul/ops.py:81",
         "launches": par_ex, "max_abs_err": _route_err(ex_rows, "streaming"),
         "ms": fe_fp32["ms"], "plain_ms": fe_fp32["plain_ms"], "bound_ms": fe_fp32["bound_ms"],
         "bound_by": "bytes", "library_ms": fe_fp32["library_ms"],
         "work": "one olmoe layer's 3 expert stacks (64 experts, one f each) at C=4, 2-bit, "
                 "fp32 x",
         "launches_from": "olmoe-1b-7b fp32 parity (phase 4, kernels path): every bf16 call "
                          "of the serves takes the decode or tensor-core kernel",
         "pass": par_ex > 0 and all(r["pass"] for r in fe_rows + fed_rows)},
        {"name": "paged_attention_quant", "route": "cuda",
         "source": "src/repro_torch/csrc/paged_attention.cu",
         "replaces": "src/repro/kernels/paged_attention/kernel.py:131",
         "launches": olmoe["launches"]["paged_attention_quant"],
         "max_abs_err": aq_err, "ms": aq_main["ms"], "plain_ms": aq_main["plain_ms"],
         "bound_ms": aq_main["bound_ms"], "bound_by": aq_main["bound_by"],
         "library_ms": aq_main["library_ms"],
         "work": "int4 pool, B=4 K=16 G=1 hd=128 block=16 T=1 bf16, ~300 cached tokens a row",
         "length_sweep": [_sweep_entry(r) for r in aq_main["length_sweep"]],
         "tail_prefill_cases": [_case_entry(r) for r in aq_rows
                                if r.get("tail_prefill") and r["of"] == "admission"],
         "chunk_and_prefix_hit_cases": [dict(_case_entry(r), of=r["of"]) for r in aq_rows
                                        if r.get("tail_prefill") and r["of"] != "admission"],
         "launches_gemma3_prefix_chunk_serves": {w: r["launches"]["paged_attention_quant"]
                                                 for w, r in prefix.items()},
         "launches_gemma3_serve": gemma3["launches"]["paged_attention_quant"],
         "tail_prefill_launches_gemma3_serve": gemma3["tail_prefill_launches"],
         "launches_gemma3_parity": par_g3["attention_launches"]["kernels"][
             "paged_attention_quant"],
         "pass": all(r["pass"] for r in aq_rows)},
    ]
    # rows 2 and 3 at T·G >= PREFILL_MIN_ROWS: the tensor-core prefill kernel
    pf_rows = [r for r in aq_rows if r.get("route") == "prefill"]
    pf_main = next(r for r in pf_rows if r["T"] == 2048 and r["window"] == 1024
                   and r["kernel"] == "paged_attention_quant")
    summary.append(
        {"name": "gqa_prefill", "route": "cuda", "source": "src/repro_torch/csrc/gqa_prefill.cu",
         "replaces": "src/repro/kernels/paged_attention/kernel.py:89 (_attn_kernel) and :131 "
                     "(_attn_kernel_quant) at T·G >= the rule's threshold",
         "launches": gemma3["launches"]["paged_attention_prefill_quant"],
         "max_abs_err": max(r["max_abs_err"] for r in pf_rows), "ms": pf_main["ms"],
         "plain_ms": pf_main["plain_ms"], "bound_ms": pf_main["bound_ms"],
         "bound_by": pf_main["bound_by"], "library_ms": pf_main["library_ms"],
         "decode_route_ms": pf_main["decode_route_ms"],
         "work": "gemma3-4b's admission: int4 pool, B=1 K=4 G=2 hd=256 T=2048 from 0 under "
                 "the window of 1,024, bf16 q",
         "launches_from": "gemma3-4b serve (phase 10): one tail-prefill call a layer and "
                          "admission on the prefill route",
         "cases": [dict(_case_entry(r), kernel=r["kernel"], of=r.get("of"),
                        decode_route_ms=r.get("decode_route_ms")) for r in pf_rows],
         "rule_min_rows": pf_cross["rule_min_rows"], "crossover_TG": pf_cross["crossover_TG"],
         "launches_gemma3_prefix_chunk_serves": {
             w: r["launches"]["paged_attention_prefill_quant"] for w, r in prefix.items()},
         "launches_speculative_serves": {t: r["launches"]["paged_attention_prefill"]
                                         for t, r in spec.items()},
         "model_check": {k: pf_model[k] for k in (
             "max_abs_logit_diff_routes", "bar", "argmax_agreement_routes", "rule_launches")},
         "ptxas": _ptxas("gqa_prefill"),
         "pass": gemma3["launches"]["paged_attention_prefill_quant"] > 0
         and all(r["pass"] for r in pf_rows) and pf_model["pass"]})
    # rows 4 and 5: the tensor-core kernel takes every bf16 call of the
    # serves; mla_partial the fp32 ones (the 4-layer parities)
    for quant in (False, True):
        sfx = "_quant" if quant else ""
        m = mla_main["quant" if quant else "float"]
        kind = "quant" if quant else "float"
        par = par_ds["int4_fp" if quant else "bf16"]["attention_launches"]["kernels"]
        serve16 = deepseek["bf16_pool_launches"] if not quant else deepseek["launches"]
        work = (f"{'int4' if quant else 'bf16'} pool, B=4 T=1 H=128 r=512 rope=64 block=16 "
                "bf16 q, ~300 cached tokens a row")
        mla_rows_k = [r for r in mla_rows if r["kernel"] == "paged_attention_mla" + sfx]
        summary.append(
            {"name": "paged_attention_mla_tc" + sfx, "route": "cuda",
             "source": "src/repro_torch/csrc/paged_attention.cu",
             "replaces": "src/repro/kernels/paged_attention/kernel.py:" + ("273" if quant
                                                                          else "234"),
             "launches": serve16["paged_attention_mla_tc" + sfx],
             "max_abs_err": mla_err["tc_" + kind], "ms": m["tc_ms"], "plain_ms": m["plain_ms"],
             "bound_ms": m["bound_ms"], "bound_by": m["bound_by"],
             "library_ms": m["library_ms"], "partial_kernel_ms": m["partial_ms"],
             "split": m["tc_split"], "ms_by_split": m["tc_ms_by_split"], "work": work,
             "verify_T5_cases": [dict(_case_entry(r), tc_ms=r["tc_ms"], partial_ms=r["partial_ms"],
                                      split=r["tc_split"])
                                 for r in mla_rows_k if r.get("T") == VERIFY_T],
             "launches_from": f"deepseek-v3 serve from a{' bf16' if not quant else 'n int4'} MLA "
                              "pool (7 layers x decode steps): every MLA launch",
             "pass": all(r["pass"] for r in mla_rows_k)})
        summary.append(
            {"name": "paged_attention_mla" + sfx, "route": "cuda",
             "source": "src/repro_torch/csrc/paged_attention.cu",
             "replaces": "src/repro/kernels/paged_attention/kernel.py:" + ("273" if quant
                                                                          else "234"),
             "launches": par["paged_attention_mla" + sfx],
             "max_abs_err": mla_err["partial_" + kind], "ms": m["partial_ms"],
             "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"], "bound_by": m["bound_by"],
             "library_ms": m["library_ms"],
             "serve_launches": serve16["paged_attention_mla" + sfx]
             - serve16["paged_attention_mla_tc" + sfx],
             "work": work + " (mla_partial + attn_combine, forced)",
             "launches_from": f"deepseek-v3 4-layer fp32 parity from a "
                              f"{'int4' if quant else 'bf16'} MLA pool (phase 4, kernels path): "
                              "fp32 queries; no bf16 call of the serves takes it",
             "pass": par["paged_attention_mla" + sfx] > 0 and all(r["pass"] for r in mla_rows_k)})
    for name, serve_row, rows, pre, work, pre2, work2 in (
            ("fixedpoint_matmul_tc", serve, mm_rows, fp_prefill,
             "one internlm2 layer's 7 projections at M=512 (a 512-token prefill), 2-bit, bf16",
             None, None),
            ("fixedpoint_matmul_experts_tc", olmoe, ex_rows, fed_prefill,
             "one deepseek-v3 MoE layer's 3 expert stacks (256 experts) at C=20 (a 512-token "
             "prefill), 2-bit, bf16", fe_prefill,
             "one olmoe layer's 3 expert stacks (64 experts) at C=80 (a 512-token prefill)")):
        base = name[: -len("_tc")]
        entry = {"name": name, "route": "cuda",
                 "source": "src/repro_torch/csrc/fixedpoint_matmul.cu",
                 "replaces": "src/repro/kernels/fixedpoint_matmul/kernel.py:30"
                 if base == "fixedpoint_matmul"
                 else "src/repro/kernels/fixedpoint_matmul/ops.py:81",
                 "launches": serve_row["launches"][name],
                 "max_abs_err": _route_err(rows, "tensor_core"), "ms": pre["ms"],
                 "plain_ms": pre["plain_ms"], "bound_ms": pre["bound_ms"],
                 "bound_by": pre["bound_by"], "library_ms": pre["library_ms"],
                 "streaming_kernel_ms": pre["stream_ms"], "work": work,
                 "launches_deepseek_serve": deepseek["launches"][name],
                 "tc_min_rows": cross["tc_min_rows"],
                 "crossover_rows": cross["2d" if base == "fixedpoint_matmul"
                                         else "experts"]["crossover_rows"],
                 "tc_faster_at_every_routed_case": tc_faster,
                 "pass": tc_faster and all(r["pass"] for r in rows)}
        entry["launches_olmoe_serve"] = olmoe["launches"][name]
        entry["launches_gemma3_serve"] = gemma3["launches"][name]
        if base == "fixedpoint_matmul":
            entry["launches_gemma3_prefix_chunk_serves"] = {w: r["launches"][name]
                                                            for w, r in prefix.items()}
            entry["gemma3_tail_layers"] = {
                f"M={M}": dict(v, work=f"one gemma3-4b layer's 7 projections at M={M} (a "
                                       f"{'chunk' if M == 256 else 'prefix-hit tail'}), bf16")
                for M, v in fpg_tails.items()}
            entry["launches_speculative_draft_admissions"] = {t: r["launches"][name]
                                                              for t, r in spec.items()}
            entry["recurrent_prefill_layers"] = {
                k: dict(v, work=f"one {k.split(' M=')[0]} layer's packed projections at M=512, "
                                "2-bit, bf16")
                for k, v in rec_fp.items() if k.endswith("M=512")}
            entry["launches_recurrent_serves"] = {k: r["launches"][name]
                                                  for k, r in rec_serves.items()}
            entry["encdec_vlm_prefill_layers"] = {
                k: dict(v, work=f"one {k.split(' M=')[0]} layer's packed projections at "
                                f"M={k.split(' M=')[1]}, 2-bit, bf16")
                for k, v in ev_fp.items() if not k.endswith("M=4")}
            entry["launches_encdec_vlm_serves"] = {k: r["launches"][name]
                                                   for k, r in ev_serves.items()}
        if pre2 is not None:
            entry["olmoe_prefill_layer"] = dict(pre2, work=work2)
        summary.append(entry)
    summary[0]["launches_deepseek_serve"] = deepseek["launches"]["fixedpoint_matmul"]
    dec_rows = [r for r in mm_rows if r["route"] == "decode" or "dec_max_abs_err" in r]
    dex_rows = [r for r in ex_rows if r["route"] == "decode" or "dec_max_abs_err" in r]
    summary.append(
        {"name": "fixedpoint_matmul_decode", "route": "cuda",
         "source": "src/repro_torch/csrc/fixedpoint_matmul.cu",
         "replaces": "src/repro/kernels/fixedpoint_matmul/kernel.py:30",
         "launches": serve["launches"]["fixedpoint_matmul_decode"],
         "max_abs_err": _route_err(mm_rows, "decode"),
         "ms": fp_decode["ms"], "plain_ms": fp_decode["plain_ms"],
         "bound_ms": fp_decode["bound_ms"], "bound_by": "bytes",
         "library_ms": fp_decode["library_ms"], "streaming_kernel_ms": fp_decode["stream_ms"],
         "work": "one internlm2 layer's 7 projections at M=4, 2-bit, bf16",
         "deepseek_decode_layer": dict(
             fpd_layer, work="one deepseek-v3 MoE layer's 2-D matmuls at decode (q_a, q_b, "
                             "kv_a, k_rope, o, the shared expert's 3) at M=4, 2-bit, bf16"),
         "launches_olmoe_serve": olmoe["launches"]["fixedpoint_matmul_decode"],
         "launches_deepseek_serve": deepseek["launches"]["fixedpoint_matmul_decode"],
         "launches_gemma3_serve": gemma3["launches"]["fixedpoint_matmul_decode"],
         "launches_speculative_drafts": {t: r["launches"]["fixedpoint_matmul_decode"]
                                         for t, r in spec.items()},
         "launches_gemma3_prefix_chunk_serves": {
             w: r["launches"]["fixedpoint_matmul_decode"] for w, r in prefix.items()},
         "recurrent_decode_layers": {
             k: dict(v, work=f"one {k.split(' M=')[0]} layer's packed projections at M=4, "
                             "2-bit, bf16")
             for k, v in rec_fp.items() if k.endswith("M=4")},
         "launches_recurrent_serves": {k: r["launches"]["fixedpoint_matmul_decode"]
                                       for k, r in rec_serves.items()},
         "encdec_vlm_decode_layers": {
             k: dict(v, work=f"one {k.split(' M=')[0]} layer's packed projections at M=4, "
                             "2-bit, bf16")
             for k, v in ev_fp.items() if k.endswith("M=4")},
         "launches_encdec_vlm_serves": {k: r["launches"]["fixedpoint_matmul_decode"]
                                        for k, r in ev_serves.items()},
         "gemma3_decode_layer": dict(
             fpg_layer, work="one gemma3-4b layer's 7 projections at M=4, 2-bit, bf16"),
         "gemma3_head": dict(_case_entry(fpg_head), stream_ms=fpg_head["stream_ms"],
                             work="gemma3-4b's 262,144-row head as a packed (2560, 262144) "
                                  "matrix at M=4, 2-bit, bf16 (the serve's tied head "
                                  "dequantizes the table instead: no launch)",
                             serve_head_dequant_matmul_ms=gemma3["head_dequant_matmul_ms"]),
         "decode_max_rows": cross["decode_max_rows"],
         "decode_crossover_rows": cross["2d"]["decode_crossover_rows"],
         "dec_faster_than_streaming_at_every_routed_case": dec_faster,
         "pass": dec_faster and all(r["pass"] and r.get("dec_bit_identical", True)
                                    for r in dec_rows)})
    summary.append(
        {"name": "fixedpoint_matmul_experts_decode", "route": "cuda",
         "source": "src/repro_torch/csrc/fixedpoint_matmul.cu",
         "replaces": "src/repro/kernels/fixedpoint_matmul/ops.py:81",
         "launches": deepseek["launches"]["fixedpoint_matmul_experts_decode"],
         "max_abs_err": _route_err(ex_rows, "decode"),
         "ms": fed_decode["ms"], "plain_ms": fed_decode["plain_ms"],
         "bound_ms": fed_decode["bound_ms"], "bound_by": "bytes",
         "library_ms": fed_decode["library_ms"],
         "bound_all_experts_ms": fed_decode["bound_all_ms"],
         "occupied_experts": fed_decode["occupied"],
         "every_expert_ms": fed_decode["dec_all_ms"],
         "streaming_kernel_ms": fed_decode["stream_ms"],
         "work": "one deepseek-v3 MoE layer's 3 expert stacks (256 experts, one f each) at "
                 "C=4, 2-bit, bf16, rows from a top-8 routing of 4 tokens (occupied_experts "
                 "summed over the 3 stacks); bound_ms counts the occupied experts' bytes",
         "olmoe_decode_layer": dict(
             fe_decode, work="one olmoe layer's 3 stacks (64 experts) at C=4, rows from a "
                             "top-8 routing of 4 tokens"),
         "launches_olmoe_serve": olmoe["launches"]["fixedpoint_matmul_experts_decode"],
         "decode_crossover_rows": cross["experts"]["decode_crossover_rows"],
         "dec_faster_than_streaming_at_every_routed_case": dec_faster,
         "pass": dec_faster and all(r["pass"] and r.get("dec_bit_identical", True)
                     and r.get("equal_to_every_expert", True) for r in dex_rows)})
    for name, form, work in (
            ("symog_update_clipped", "symog_update", "the clip form: the total gradient "
             "scaled by the clip's s read from the device (gscale)"),
            ("symog_sqnorm", "symog_sqnorm", "the clip's norm pass: sum of (g + lambda_eff "
             "(w - q))^2 over a leaf, partials summed in a fixed order")):
        r = clipped[name]
        summary.append(
            {"name": name, "route": "cuda", "source": "src/repro_torch/csrc/symog_update.cu",
             "replaces": "src/repro/kernels/symog_update/kernel.py:25",
             "replaces_note": "a form of row 6 for chain(clip_by_global_norm, sgd); JAX takes "
                              "the clip's norm in XLA (src/repro/optim/transform.py:54-56)",
             "launches": launcher["launches"][form], "max_abs_err": r["max_abs_err"],
             "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
             "bound_by": r["bound_by"], "library_ms": None,
             "library_note": "no single PyTorch call computes it (the SYMOG quantize is inside)",
             "work": f"internlm2-1.8b's largest leaf {r['leaf']} {r['shape']}: {work}",
             "launches_from": "the training launcher at internlm2-1.8b's full width and depth "
                              "(4 steps x 8 quantizable leaves)",
             "pass": r["pass"] and launcher["launches"][form] > 0})
    # phase 18: each kernel's launches on one rank's local shards (the same
    # on both ranks; gated equal to the 1-rank serve's in 18b)
    tp0, ep0, dp0 = (dist18["18b"]["ranks"][0], dist18["18d"]["ranks"][0],
                     dist18["18e"]["ranks"][0])
    for k in summary:
        n = k["name"]
        k["phase18_launches_per_rank"] = {
            "tp_serve_bf16_pool": tp0["bf16"]["launches"].get(n, 0),
            "tp_serve_int4_pool": tp0["int4_fp"]["launches"].get(n, 0),
            "ep_serve": ep0["launches"].get(n, 0),
            "dp_step": dp0["2_ranks"].get("symog_update" if n == "symog_update_clipped" else n,
                                          0)}
    # phase 19: the update's launches in one rank's sharded step (fused)
    for k in summary:
        n = {"symog_update_clipped": "symog_update"}.get(k["name"], k["name"])
        k["phase19_launches_per_rank"] = {
            case: train19[case]["ranks"][0]["fused"]["launches"].get(n, 0)
            for case in ("19b", "19c", "19d")}
        form = {"symog_update": "update", "symog_sqnorm": "sqnorm"}.get(k["name"])
        if form:  # each rank's shard of the case's leaf, after its step
            k["phase19_shard_cases"] = [
                dict({f: x["kernels"][f] for f in ("leaf", "shard_shape", "groups", "lam_eff")},
                     case=case, rank=i, **x["kernels"][form])
                for case in ("19b", "19c", "19d")
                for i, x in enumerate(r["fused"] for r in train19[case]["ranks"])]
    # phase 20: each kernel's launches on one rank's local shards in the
    # families' sharded serves (gated equal to the 1-rank serves') and fused
    # steps, and the kernels held and timed at one rank's shapes
    for k in summary:
        n = {"symog_update_clipped": "symog_update"}.get(k["name"], k["name"])
        k["phase20_launches_per_rank"] = {
            **{f"serve {c} {a}": x["ranks"][0][c]["launches"].get(n, 0)
               for a, x in fam20["20a"].items() for c in FTP_COMPUTE},
            **{f"train {a}": x["ranks"][0]["launches"].get(n, 0)
               for a, x in fam20["20b"].items()}}
        k["phase20_kernel_cases"] = [c for c in fam20["20c"] if c["kernel"] == k["name"]]
    # phase 21: each kernel's launches in 21a's fused-route training step and
    # 21b's kernel-route serve (the traced and gated runs take the plain routes)
    for k in summary:
        n = {"symog_update_clipped": "symog_update"}.get(k["name"], k["name"])
        k["phase21_launches"] = {
            "21a train fused": dry21["21a"]["fused_real"]["launches"].get(n, 0),
            "21b serve kernel route": dry21["21b"]["kernel_route_real"]["launches"].get(n, 0)}
    if not all(k["pass"] for k in summary):
        print("chip_smoke: FAILED: a kernel row did not pass", file=sys.stderr)
        return 1
    emit({"kernels": summary})
    if "jax" in sys.modules or any(m == "repro" or m.startswith("repro.") for m in sys.modules):
        print("chip_smoke: jax or the JAX package was imported", file=sys.stderr)
        return 1
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
