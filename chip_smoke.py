#!/usr/bin/env python3
"""Drive the PyTorch port's paths on one CUDA card and check them.

    python3 chip_smoke.py [--profile] [--repeats 5] [--trace PATH]
                          [--only 18|19|20|21|22]

Phases, each printing one line (any failure raises and exits non-zero):

1. the card (``nvidia-smi`` name and power limit) and torch/CUDA versions;
2. the build of every CUDA kernel from ``src/repro_torch/csrc`` (nvcc,
   one process per source, all started together), then a
   ``{"flash_ptxas": ...}`` line: each of the 18 flash-attention kernel
   instantiations (K7, K8a, K8b; bf16 on the tensor cores, float32 on the
   CUDA cores) with its ptxas registers, spill bytes and shared memory,
   none of which may spill; and a ``{"irls_ptxas": ...}`` line: the same
   for the 17 instantiations of the IRLS kernels that K3, K5 (rows, Gram,
   reduce: 7 each) and K6 (Gram, reduce: 3) wrap around the shared bodies
   of ``csrc/irls_tc.cuh``, with the launch plan each entry's
   ``repro_k*_plan`` gives at d = 128; and a ``{"shamir_ptxas": ...}``
   line: K1's two instantiations (f32/f64 payload), K2's and K4's with
   registers, spills and stack frame, none of which may spill or keep a
   local array, and each one's emulated-division instructions in its SASS
   (``cuobjdump -sass``: ``MUFU.RCP*`` and ``CALL``), which must be none
   (their field arithmetic is Barrett's, ``csrc/field_arith.cuh``);
3. each kernel against its plain PyTorch version on the card, at the
   shapes the paths give it: K1 encode+share and K2 reveal bit-identical,
   K3 summaries within the stated tolerances, two calls bit-identical;
   K5 cross-validated summaries at the λ-path's (5 folds) and refit's
   (fold -1) shapes and at a ragged shape with a count past N_max, H
   within 2e-5 max|H|, g and the deviances within 1e-10 of the sums of
   absolute terms, held-out counts exact, two calls bit-identical; K4
   leaf-wise shares bit-identical at n = 1,000,000, R = 2, (t, w) = (2,
   3) and (3, 5), and at (2, 3) on inputs 1 and 3 elements into their
   storage (off 16-byte alignment); K6 weighted Gram within 2e-5 max|H| at
   one institution's (25,000 x 128) and the pooled (200,000 x 128) shape,
   two calls bit-identical; for K3, K5 and K6 the distance of the kernel's
   and of the plain version's H to the float64 sum of the float32
   products is printed, and the kernel's may be no larger;
4. a full ``secure_fit`` at the acceptance configuration (S=8
   institutions, d=128, N=200,000 rows split +-5%, protect="both", 2-of-3
   Shamir over the (2^31-1, 2^31-19) CRT pair, 28 fractional bits)
   through ``SecureCollective(backend="kernel")`` and the kernel
   summaries rung, checked for convergence, exact wire bytes, beta
   against the port's ``centralized_fit``, and one launch of each kernel
   per iteration; then the same fit as ``SecureFitDriver(rounds="scan")``
   blocks, checked against it (iterations, bytes, beta);
5. the secure cross-validated λ path on the same study at
   ``benchmarks/lambda_path.py``'s acceptance configuration (8 λs from
   logspace(1.5, -1.5), 5 folds, lam_block 1, 8 rounds per sync, at most
   50 rounds, refit on, seed 0, the kernel rung), through
   ``secure_cv_path`` and once through ``SelectionCoordinator.run_path``:
   every fold and the refit converged, exact bytes, the refit beta
   against ``centralized_fit`` at λ_1se, and K5, K1 and K2 launched once
   per executed round (K3 never);
6. leaf-wise Shamir at ``benchmarks/secure_overhead.py``'s largest size
   (1,000,000 parameters, 4 institutions, 2-of-3 over the CRT pair, 28
   fractional bits) through ``ShamirScheme(backend="kernel")``: every
   institution's encoded leaf shared (K4, one launch each), the shares
   summed in the field, reconstructed from each 2-subset (K2 residues
   mode, one launch per residue) and revealed as a per-leaf tree through
   ``SecureCollective(backend="kernel").reveal``; every reveal equal to
   the decoded exact sum bit for bit;
7. the weighted Gram through ``ops.gram_hessian`` (K6): each
   institution's X^T diag(w) X at the IRLS weights, their sum against the
   pooled Gram;
8. fault-tolerant supervision: ``benchmarks/fault_overhead.py``'s own
   configuration (S=4, d=64, N=80,000, protect="both", its policy, the
   fused ``StudyCoordinator``) bare and supervised without faults
   (bit-identical beta, per-round host-clock overhead), then under its
   three canned schedules (center schedules bit-identical to the
   fault-free beta, the flap within (S+1)/2^28), with its CPU run's counts
   printed beside for reference; a supervised ``SecureFitDriver`` at phase
   4's configuration under a mid-round center loss (same beta, iterations
   and bytes as phase 4) and a supervised ``SelectionCoordinator`` of
   phase 5's path under center faults (same report and refit beta);
9. multi-study rounds: 4 studies at phase 4's shape (seeds 0-3, λ = 0.3,
   1, 3, 10), 10 rounds through ``run_multistudy_rounds``, each study's
   beta within (S+1)/2^28 of its own ``SecureFitDriver`` round by round,
   and per round 4 K3 launches, one K1 and one K2;
10. serving a dense GQA decoder at Qwen2.5-32B's full width
   (``src/repro_torch/configs/qwen2_5_32b.py``: d_model 5120, 40 query / 8
   KV heads of 128, d_ff 27,648, vocab 152,064, QKV bias, RoPE θ 1e6,
   bf16) with its depth cut to 8 of 64 layers (5,457,982,464 parameters,
   10.9 GB, drawn on the card from a seed): first K7 (causal flash
   attention) against its plain version at the serving shape (B 4, S
   2048, H 40, KVH 8, D 128, bf16), an H2O-like ragged shape (1, 1000,
   32, 8, 120, bf16), MQA (2, 384, 4, 1, 64, f32), an f32 many-block
   case with score outliers and a recurrentgemma-like head_dim 256 shape
   (1, 2048, 16, 1, 256, bf16) (o within 2e-5 f32, 5e-3 + 1e-2 relative
   bf16, m and l within 1e-5 relative); then 8 requests in batches of 4,
   prompts of 2048 tokens, 32 greedy new tokens each, through
   ``launch.serve.serve_requests`` (prefill -> KV-cache decode): 256
   tokens, every logit finite, K7 launched once per layer of each
   prefill (16) and never in decode; then the continuation check
   (decode's logits after a 2048-token prefill against the last-position
   logits of a prefill over those 2049 tokens: in bf16 within 2e-2
   max|logits|, the port's bf16 tolerance against the JAX package, and
   with the same weights in float32 within 1e-4 max|logits|); a
   ``{"serve": ...}`` JSON line;
11. with ``--profile`` only: ``--repeats`` more timed runs of the fit, the
   λ path, the multi-study rounds and the serving run (and, in phase 16,
   each model's serving run, its MoE routing and dispatch a category of
   its own), then one of each
   under ``torch.profiler`` (device time
   per kernel name, the union of device-busy intervals over the run's
   wall window, so the card's idle share), as ``profile`` JSON lines; a
   fit and a multi-study round must attribute time to K3 and none to K5,
   a path round to K5 and none to K3; then K6 alone at 25,000 x 128 and
   200,000 x 128, 20 calls a run (its Gram kernel beside its reduce);
   ``--trace`` also writes the fit's Chrome trace;
13. training at Qwen2.5-32B's full width with its depth cut to 2 of 64
   layers (2,532,350,976 parameters), after the serving weights are
   freed: (a) K8a/K8b (the flash-attention backward) against their plain
   versions at K7's shapes and the training shape (B 1, S 2048, H 40, KVH
   8, D 128, bf16), there also with q scaled by 4 (a peaked softmax); (b) in float32 with remat, the central difference of
   ``loss_fn`` along u = g / |g| (h = 1e-2) against |g| within 2e-2
   relative, one sequence of 2048 tokens; (c) 8 bf16 ``train_step`` calls
   (2 institutions of one 2048-token sequence, lr 3e-4, AdamW, remat),
   every loss and grad norm finite, every weight matrix moved, K7 8, K8a 4 and
   K8b 4 launches a step, seconds a step, tokens/s and peak bytes in a
   ``{"train": ...}`` line (with ``--profile``, one profiled step and one
   profiled AdamW update); (d) ``run_lm`` with ``--secure-agg shamir`` at
   the smoke config (the int32 shares of the full-width model do not fit
   the card): the loss falls, one K1 and one K2 a step, exact wire bytes,
   and the step-0 secure mean gradient within S * 2^-28 of the plain mean;
14. the multi-device wires on ``torch.distributed`` at
   ``benchmarks/secure_psum.py``'s size (10^6 float32 parameters: a leaf
   of 999,984 and a 4 x 4 leaf, 2-of-3 over the CRT pair, 28 fractional
   bits), after the training weights are freed: (a) a single-rank NCCL
   group on the card: ``secure_psum`` replicated, sharded, sharded with
   ``out="tile"`` (its ``gather``) and the per-leaf oracle, each reveal
   equal to the decoded exact sum bit for bit, one K1 and one K2 launch a
   flat call (the counted run: K1 3, K2 3), and a (2, 17) call revealed
   from all 17 centers; (b) 4 spawned ranks on one gloo group, every one
   on cuda:0 (NCCL refuses two ranks on one card; gloo's reduce-scatter
   and all-gather of CUDA tensors go through the host, counted): the same
   modes, bit-identical to each other and to the decode of 4 x tree, a 2
   x 2 (pod, share) ``secure_psum_2d`` bit-identical to the 1D wire over
   its 2 pods, ``run_scanned_rounds`` of 4 rounds in both reveal modes
   (mean within 1e-4, trace (4,), one K1 and one K2 a round) and
   ``compressed_psum`` (within half a quantization step of the mean);
   (c) the lifted caps at protocol sizes: K1 at (t, w) = (2, 17) and (17,
   20) on the 10^6-parameter wire buffer, K4 there at n = 10^6, K2 with k
   = 17 and 20, each bit-identical to its plain version.  A ``{"wires":
   ...}`` line: seconds a call per mode, 2D and a scanned round, each
   rank's bytes on the wire (operands, and under the 4-byte ring model of
   ``benchmarks/secure_psum.py``), the bytes staged through the host and
   each group's backend, with the card's name and power limit.  Every
   process group has a 120 s timeout and the spawn a deadline;
15. the privacy gate and the runtime audit (``repro_torch.analysis``,
   ``repro_torch.obs.audit``), after phase 14: (a) the eight
   single-process driver specs at the JAX package's toy shapes with every
   tensor on the card, each certified clean by the taint interpreter,
   its host reads and collectives linted (the scan blocks' per-slot
   ``settled`` read reported as the documented deviation), the three leak
   fixtures caught (``skip_protect`` through K3's real output), every
   spec's ungated run reconciled against its census and the audit's extra
   reveal flagged; every declared kernel call of a gated run a CUDA launch
   (K1, K2, K3 and K5 among them); (b) the fused round at phase 4's
   configuration certified under both protect modes (one K3, K1 and K2
   launch each), then phase 4's fit and its gradient-mode twin under the
   ledger: every (site, shape) count equal to iterations x the certified
   census; the cost of a disabled hook; (c) inside phase 14's spawned
   ranks, the three 1D psum specs on its 4-rank pod mesh and the 2D spec
   on its 2 x 2 mesh, certified and audited on every rank.  A
   ``{"privacy_gate": ...}`` line: specs, findings, fixtures caught, the
   census, seconds to certify each spec at toy and full size, the fit's
   seconds a round in this run and the card's name and power limit;
16. the MoE and MLA families and the ``embeddings`` frontend, after
   phase 15, one model on the card at a time: K7 against its plain
   version at the new families' prefill shapes (bf16, B 4, S 2048: MLA's
   16 heads of Dk 192 with V's 128 columns zero-padded to 192,
   Qwen3-MoE's 64/4 GQA at D 128, MusicGen's 24 heads of 64); (d)
   ``moe_ffn`` at Qwen3-MoE's prefill (T 8,192, E 128, top 8, capacity
   640) in float32 on the card against the CPU on the same inputs (x and
   the router on a grid, so the router's logits are exact): expert ids,
   queue positions, kept slots and drops equal, y within 1e-5 max|y|;
   then (a) DeepSeek-V2-Lite whole (``configs/deepseek_v2_lite.py``: 27
   layers, MLA with kv_lora 512, rope 64, Dk 192, Dv 128; 64 routed
   experts top 6 and 2 shared; 15,706,484,224 parameters, bf16, from a
   seed), (b) Qwen3-MoE-235B at full width cut to 8 of 94 layers
   (21,146,701,824 parameters: d_model 4096, 64/4 heads of 128, 128
   experts top 8) and (c) MusicGen-medium whole (1,365,394,944
   parameters, the embeddings frontend): (a) and (b) serve phase 10's
   traffic through ``serve_requests`` (8 requests, batch 4, prompts of
   2048, 32 greedy tokens), (c) one batch of 4 x 2048 seeded bf16 frame
   embeddings and 32 decode steps on frames; K7 launched once per layer
   of each prefill and nothing else, every logit finite; then the
   continuation check drop-free (capacity_factor = E, so a decode step
   drops nothing a prefill keeps) at batch 1 on a 512-step prompt: bf16
   within 2e-2 max|logits|, MLA's absorbed decode against the expanded
   one within the same, and in float32 on the first 4 (a), 2 (b) or all
   (c) layers within 1e-4; a ``{"serve_f3a": ...}`` line a model
   (prefill tokens/s, decode ms a step, peak bytes, the card) and a
   ``{"moe_check": ...}`` line;
17. the recurrent families whole, after phase 16, one model on the card
   at a time: (d) K7 against its plain version at RecurrentGemma's local
   attention in serving (bf16, B 4, S 2048, 16 query heads on 1 KV head
   of 256); (e) one layer of RWKV6-3B (d 2560, 40 heads of 64) and one
   RG-LRU block of RecurrentGemma-9B (W 4096, conv 4) at B 2, S 256 in
   float32, the card against the CPU on the same seeded inputs:
   ``rwkv6_mix`` per token and chunked (``rwkv_chunk`` 16), its channel
   mix and ``rglru_block``, each output and final state within 1e-4 of
   its max, the chunked form on the card within the same of the
   per-token one; each loop alone at the serving shape (B 4, S 2048): ms
   a layer and its kernels (a ``{"recurrent_check": ...}`` line); then
   (a) RWKV6-3B whole (``configs/rwkv6_3b.py``: 32 layers, d 2560, 40
   heads of 64, d_ff 8960, vocab 65,536; 3,073,231,360 parameters) and
   (b) RecurrentGemma-9B whole (``configs/recurrentgemma_9b.py``: 38
   layers, 26 RG-LRU of width 4096 and 12 local-attention layers, window
   2048, MQA of 256; 9,572,782,080 parameters), bf16 from a seed, each
   serving phase 10's traffic through ``serve_requests``: K7 once per
   local layer of each prefill (24 for (b)) and nothing else, every
   logit finite; the continuation at batch 1 on P = 512 (and for (b) P =
   2,100, past the window: the banded scan, the rolled ring cache), in
   float32 (the whole model converted in place) within 1e-4 max|logits|
   and in bf16 within phase 16's bound; a ``{"serve_f3b": ...}`` line a
   model (prefill tokens/s, decode ms a step, peak bytes, the card), and
   with ``--profile`` a ``profile`` line a model of one batch, the
   recurrences' step ops in categories of their own;
18. the F3a and F3b families trained at full width, after phase 17, one
   model on the card at a time, each cut in depth to fit 80 GB beside
   its AdamW moments: K8a/K8b against their plain versions at the
   families' training shapes (bf16, B 1, S 2048: MLA's 16 heads of Dk
   192 with V and do zero past 128 columns, Qwen3-MoE's 64/4 GQA at D
   128, MusicGen's 24 heads of 64); (b) ``moe_ffn``'s backward at
   Qwen3-MoE's and DeepSeek-V2-Lite's widths (its shared experts too), T
   2048, in float32 on the card against the CPU (x and the router on a
   grid: expert ids, queue positions, slots and drops equal, the
   gradients of x, the router and every expert and shared leaf within
   1e-5 of their max; a ``{"moe_grad_check": ...}`` line each); the
   float32 central difference of ``loss_fn`` along g / |g| (h 1e-2,
   within 2e-2 of |g|) of MusicGen-medium whole, RWKV6-3B whole at
   ``rwkv_chunk`` 32, RecurrentGemma-9B's first 6 layers and
   DeepSeek-V2-Lite's dense MLA layer 0 alone (a ``{"grad_check_f4":
   ...}`` line each); (a) 6 bf16 ``train_step`` calls of each of
   DeepSeek-V2-Lite (4 of 27 layers: the dense layer and 3 MoE;
   2,254,983,168 parameters), Qwen3-MoE-235B (1 of 94; 3,732,418,560),
   MusicGen-medium whole (1,365,394,944, seeded bf16 frames), RWKV6-3B
   whole (3,073,231,360, chunked at 32) and RecurrentGemma-9B (6 of 38:
   4 RG-LRU and 2 local-attention layers; 3,275,968,512), phase 13's
   traffic (2 institutions of one 2048-token sequence, lr 3e-4, warm-up
   over half the run, remat): every loss and grad norm finite, every
   weight matrix moved, and each step K7 twice per K7 layer and
   institution (forward, remat), K8a and K8b once, nothing else (none at
   all for RWKV6); a ``{"train_f4": ...}`` line each (seconds a step:
   the median of steps 2-6, tokens/s, peak bytes, ``reduced``, the card;
   with ``--profile``, a ``profile`` line of one step); (c) phase 13
   (d)'s ``run_lm --secure-agg shamir`` at each family's smoke config
   (one K1 and one K2 a step, exact wire bytes, the step-0 secure mean
   within S * 2^-28 of the plain one; a ``{"secure_train_f4": ...}``
   line each).  ``--only 18`` runs phases 1, 2 and 18 alone;
19. the LM's sharded serving (``rules=``, ``distributed.sharding``),
   after phase 18: K7 against its plain version at the local heads a rank
   runs under a (1, 4) mesh (bf16, B 4, S 2048: Qwen2.5-32B's 10/2 of
   128, Qwen3-MoE's 16/1 of 128, RecurrentGemma's 4/1 of 256); (a) one
   NCCL rank with a (1, 1) mesh serves phase 10's requests (Qwen2.5-32B
   at 8 of 64 layers, batch 4, prompts of 2048, 32 greedy tokens)
   through ``serve_requests(..., rules=)``: the model's one program runs
   under the mesh, its specs and coordinates read from it, and skips
   every collective at size 1, so NCCL carries none; the tokens equal
   phase 10's, the prefill logits within phase 10's bf16 tolerance of the
   unsharded ones, K7 once per layer of each prefill; (b) 4 spawned ranks
   on one gloo group, all on cuda:0 (NCCL refuses two ranks on one card), a
   (1, 4) mesh, one model at a time, bf16 from a seed: Qwen2.5-32B at 2
   of 64 layers, Qwen3-MoE-235B at 1 of 94 (32 experts a rank),
   H2O-Danube3-4B at 2 of 24 with ``seq_parallel_prefill`` (S 8192: two
   halo chunks at window 4096) and RecurrentGemma-9B at 3 of 38 (its
   16/1 heads the mixed q/KV case, RG-LRU's channels split); each a
   batch of 4 prompts (Qwen3-MoE 1, drop-free), a teacher-forced
   prefill and 8 decode steps fed the unsharded run's greedy tokens
   (rank 0 serves it), every gathered logit within the larger of 2e-2
   max|logits| and twice the bf16 prefill's distance from the float32
   prefill (phase 16's rule); Qwen3-MoE's ``moe_ffn`` at 4 x 2048 tokens
   (capacity factor 1.0: assignments drop) expert-parallel against the
   unsharded function, its drop fraction the largest of the ranks' own
   drops (JAX's pmax), which add up to the unsharded drops; per rank the
   parameter and cache bytes beside the whole (about a quarter, by
   ``param_pspec``), ``wire_stats`` bytes per collective kind and staged
   through the host, K7 launches (equal to the count the config implies:
   one per attention layer a prefill runs through K7) and host
   seconds (gloo's host ring: no fabric is measured); a ``{"d2a": ...}``
   line.  ``--only 19`` runs phases 1, 2 and 19 alone;
20. gradients under a mesh (``loss_fn(rules=)``, ``mesh_train_step``),
   after phase 19: K8a/K8b against their plain versions at the local
   heads a rank's backward runs under a (1, 4) mesh (bf16, B 1, S 2048:
   Qwen2.5-32B's 10/2 and Qwen3-MoE's 16/1 of 128, RecurrentGemma's 4/1
   of 256); (a) one NCCL rank with a (1, 1) mesh runs 3
   ``mesh_train_step`` calls of phase 13's model and traffic (Qwen2.5-32B
   at 2 of 64 layers, a batch of 2 x 2048 tokens, remat): loss, grad norm
   and parameters bit for bit those of the same calls without rules, K7
   4, K8a 2 and K8b 2 launches a step; (b) 4 spawned ranks on one gloo
   group, all on cuda:0, a (1, 4) mesh, one model at a time, bf16 from a
   seed, remat: Qwen2.5-32B at 2 of 64 layers (batch 2), Qwen3-MoE-235B
   at 1 of 94 (batch 1, drop-free), H2O-Danube3-4B at 2 of 24 with
   ``seq_parallel_prefill`` (S 8192, batch 1) and RecurrentGemma-9B at 3
   of 38 (batch 2), S 2048 otherwise: rank 0 first computes the
   unsharded bf16 and float32 gradients (the whole models loaded one
   rank at a time), then every rank's ``loss_fn(rules=)`` gradient block
   of every leaf is held to rank 0's bf16 one by phase 16's rule (the
   larger of 2e-2 max|g| and twice the bf16 gradient's distance from the
   float32 one), the loss and the grad norm alike; then one
   ``mesh_train_step`` (the sharded AdamW) a model: every weight block
   moved, K7 twice and K8a, K8b once per K7 layer a rank (H2O's seq-layout
   windowed attention none); per rank the parameter, gradient and moment
   bytes beside the whole (about a quarter), ``wire_stats`` by kind and
   staged through the host, host seconds (gloo's host ring: no fabric is
   measured); a ``{"d2b": ...}`` line.  ``--only 20`` runs phases 1, 2
   and 20 alone;
21. the shape dry run (``repro_torch.launch.dryrun``): (a) the kernels'
   launch knobs (``kernels/tuning.py``) through ``lint_kernel_knobs`` with
   the built library's registers, every one of the 42 instantiations'
   model held to ``cudaFuncGetAttributes``, the occupancy API and the
   flash kernels' shared-memory exports, a line a family (registers,
   shared memory, blocks an SM); (b) phase 20 (a)'s step (Qwen2.5-32B at
   2 of 64 layers, batch 2 x 2048, remat) dry-run on a (1, 1) fake mesh on
   ``meta``, then run on one NCCL rank under the cost counter: argument
   bytes, counted FLOPs and kernel launches equal, and the card's
   ``max_memory_allocated`` within ``PEAK_BAND`` of the predicted peak;
   (c) phase 20 (b)'s four models dry-run on a (1, 4) fake mesh: a
   rank's parameter and gradient bytes, kernel launches and
   ``wire_stats`` equal to phase 20's (this run's, or with ``--only 21``
   ``D2B_RANK_WIRE``, phase 20's earlier run on the H100); (d) ``python
   -m repro_torch.launch.dryrun --all`` on the (16, 16) fake mesh at full
   size, baseline and ``--optimized``:
   a line a cell (argument and predicted peak GB against the card's
   memory, TFLOPs and collective GB a rank a step) and which fit one
   rank; a ``{"dry_run": ...}`` line.  The dry run is host arithmetic on
   the ``meta`` device: its figures are predictions, not measurements of
   the card.  ``--only 21`` runs phases 1, 2 and 21 alone;
22. the normal entry points, after phase 21: the twins of the four
   examples in process through their ``run(device)`` (``examples/
   torch_*.py``: each one's own asserts and its ``OK``; the LM twin's
   resumed steps 10-14 equal to an uninterrupted 15-step run's, losses
   and final checkpoint bit for bit), ``python examples/
   torch_quickstart.py`` once as a user types it (exit 0, last line
   ``OK``), then ``launch.train.main`` on the paper's four studies at
   paper size (``--fused --protect both``: converged, R^2 against the
   pooled fit above 0.999999, at most 10 rounds, bytes exactly rounds x
   ``round_bytes``), ``--rounds scan`` on Synthetic (the step run's
   rounds and bytes; the fit's host reads counted by site: one block
   read-back, one ``settled`` read a slot, one headroom maximum a round),
   ``--select-lambda`` on Insurance, ``--l1`` on Parkinsons.Total, a
   checkpointed run stopped after its round n - 2 and ``--resume``d (beta
   bit for bit), the LM trainer with ``--fail-at 2 --compress`` and
   ``launch.serve.main`` on three archs; every run's launches held to its
   model (the coordinator's fused rounds K1 and K2 a round and no K3,
   λ selection K5, K1 and K2 a round, the LM trainer K1 and K2 a step
   and K7, K8a, K8b a layer an institution, serving K7 a layer a
   prefill) and its ``device`` field; and an institution's CPU tensors
   under a coordinator on the card: uploaded once, at construction, and
   never in a round.  A ``{"entry_points": ...}`` line with each run's
   wall seconds and launches.  ``--only 22`` runs phases 1, 2 and 22;
12. (printed last) one JSON line with each kernel's time, bound and
   launches, K8a/K8b with the SDPA backward as their one library call
   (also at phase 18's three training shapes, MLA's bound and SDPA call
   counting the function's own work: V, do and dv at 128 columns);
   K7 also at RecurrentGemma's serving shape and at phase 16's three
   shapes (MLA's bound and SDPA call count
   the function's own work: V and o at 128 columns, 2 x 192 + 2 x 128
   operations a pair), and with K8a and K8b at the head_dim 256 shape, K6 also at one
   institution's 25,000 x 128, K1 and K2 also at the λ path's round (K1
   over 5 x 8 slices of 136 rows, K2 over the 5 aggregates) and at 2^24
   elements, K4 at (t, w) = (3, 5) and at 2^24 elements a residue, and
   (phase 14c) K1 and K4 at (2, 17) and (17, 20), K2 at k = 17 and 20, each
   held bit-identical to its plain version there (``at_shapes``), and
   K7 at phase 19's local-head shapes, K8a/K8b at phase 20's; before
   it, the event floor: an empty launch
   (``torch.cuda._sleep(0)``) timed as the kernels are.

The last line is ``{"ok": true, "device": {...}}``.  Without a CUDA card
the script exits non-zero before printing any result.
"""
from __future__ import annotations

import argparse
import collections
import gc
import json
import math
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM peaks (NVIDIA data sheet, dense): HBM3 bytes/s, CUDA-core
# float64 and float32 FLOP/s, tensor-core TF32 and bfloat16 FLOP/s
PEAK_BYTES = 3.35e12
PEAK_F64 = 34e12
PEAK_F32 = 67e12
PEAK_TF32 = 495e12
PEAK_BF16 = 989e12

S, D, N, PROTECT, FRAC_BITS = 8, 128, 200_000, "both", 28
SEED = 0
QUANT_TOL = (S + 1) / 2**FRAC_BITS  # 3.35e-8
# the lambda path: benchmarks/lambda_path.py's acceptance configuration
NUM_LAMBDAS, FOLDS, LAM_BLOCK, ROUNDS_PER_SYNC, MAX_ROUNDS = 8, 5, 1, 8, 50
PATH_ROUND_BYTES = 16_711_680
# what the JAX package printed there (a CPU run, with its own fold ids):
# shown for reference, not checked
JAX_PATH = {"rounds": 37, "lambda_1se": 31.622776601683793,
            "lambda_best": 4.393970560760792}
SPIN_CYCLES = 5_000_000  # a few ms of card time, longer than any enqueue
# leaf-wise Shamir: benchmarks/secure_overhead.py's largest default size
LEAF_N, LEAF_INST = 1_000_000, 4
# supervision: benchmarks/fault_overhead.py's configuration and schedules
FAULT_S, FAULT_D, FAULT_N, FAULT_MAX_ROUNDS = 4, 64, 80_000, 60
FAULT_REPEATS = 5  # interleaved bare/supervised pairs
FAULT_SCHEDULES = {
    "flap_quorum_retry": {2: [("flap", "i1", 3.0), ("flap", "i2", 3.0),
                              ("flap", "i3", 3.0)]},
    "midround_abort_reshare": {2: [("center_midround", 2),
                                   ("center_midround", 3)]},
    "center_loss_reprovision": {2: [("center_crash", 2),
                                    ("center_crash", 3)]},
}
CENTER_ONLY = ("midround_abort_reshare", "center_loss_reprovision")
# what the JAX package's CPU run counted (BENCH_fault_overhead.json):
# shown for reference, not checked
BENCH_FAULT = {
    "flap_quorum_retry": dict(rounds=9, retries=2, aborted_attempts=0,
                              degraded_rounds=1, sim_backoff_seconds=3.0),
    "midround_abort_reshare": dict(rounds=9, retries=1, aborted_attempts=1,
                                   degraded_rounds=1,
                                   sim_backoff_seconds=1.0),
    "center_loss_reprovision": dict(rounds=9, retries=1, aborted_attempts=0,
                                    degraded_rounds=1,
                                    sim_backoff_seconds=1.0),
}
# center faults that leave three live centers for every executed round,
# so bytes match the unsupervised runs: a below-threshold mid-round loss
# (abort, re-provision, re-share) and a two-center crash (re-provision)
FIT_FAULTS = {3: [("center_midround", 1), ("center_midround", 2)]}
PATH_FAULTS = {2: [("center_midround", 1), ("center_midround", 2)],
               4: [("center_crash", 2), ("center_crash", 3)]}
# multi-study rounds: M studies at the fit's shape
MS_SEEDS, MS_LAMS, MS_ROUNDS = (0, 1, 2, 3), (0.3, 1.0, 3.0, 10.0), 10
# serving: Qwen2.5-32B at full width, depth cut so the weights (10.9 GB)
# leave the card room beside the earlier phases
SERVE_ARCH, SERVE_LAYERS, SERVE_PARAMS = "qwen2_5_32b", 8, 5_457_982_464
SERVE_REQUESTS, SERVE_BATCH, SERVE_PROMPT, SERVE_NEW = 8, 4, 2048, 32
# decode vs prefill continuation: bf16 within 2e-2 max|logits| (the
# port's bf16 tolerance against the JAX package), float32 within 1e-4;
# phase 16 holds bf16 to the larger of 2e-2 max|logits| and twice the
# bf16 prefill's own distance from the float32 prefill of the same
# weights, where the whole model runs in float32 (DeepSeek-V2-Lite's 27
# bf16 layers put its continued token on other experts in some layers)
CONT_TOL, CONT_TOL_F32 = 2e-2, 1e-4
# K7 against its plain version: (B, S, H, KVH, D, dtype, what is done to
# q: None, "outliers" (one query row scaled by 30) or "peaked" (q scaled
# by 4, a peaked softmax, where K8a's dS cancels hardest))
# K7's o against its plain version, (abs, rel): float32 the JAX tests' own;
# bf16 set from the measured error of the first, CUDA-core kernel (1.95e-3
# at most over these shapes on the H100, under one bf16 unit in the last
# place of |o| < 2); the tensor-core kernel, which also rounds P to bf16,
# stays inside it (1.56e-2 at most, on outputs with |o| > 1)
K7_TOL = {"float32": (2e-5, 2e-5), "bfloat16": (5e-3, 1e-2)}
K7_CASES = (
    ("serving", 4, 2048, 40, 8, 128, "bfloat16", None),
    ("h2o-like ragged", 1, 1000, 32, 8, 120, "bfloat16", None),
    ("mqa", 2, 384, 4, 1, 64, "float32", None),
    ("outliers many-block", 1, 256, 2, 2, 32, "float32", "outliers"),
    # recurrentgemma-like local attention (head_dim 256, window >= S)
    ("d256", 1, 2048, 16, 1, 256, "bfloat16", None),
)
# the shapes phase 12 times besides each flash kernel's own path shape
FLASH_TIMED = ("d256",)
# K1, K2 and K4 also at slice D's scale: 2^24 elements (a secure training
# step at full width runs ~2.5e9), where the bytes, not the launch, bound
BIG_ELEMENTS = 2**24
# K8a/K8b against their plain versions: K7's shapes and the training
# shape; bf16 as K7, float32 within 2e-5 of the larger of max|plain out|
# and max|do|
K8_CASES = K7_CASES + (
    ("training", 1, 2048, 40, 8, 128, "bfloat16", None),
    ("training peaked", 1, 2048, 40, 8, 128, "bfloat16", "peaked"),
)
K8_F32_TOL = 2e-5
# training: Qwen2.5-32B at full width, depth cut to 2 of 64 layers
TRAIN_ARCH, TRAIN_LAYERS, TRAIN_PARAMS = "qwen2_5_32b", 2, 2_532_350_976
TRAIN_BATCH, TRAIN_INST, TRAIN_SEQ, TRAIN_STEPS, TRAIN_LR = 2, 2, 2048, 8, \
    3e-4
# the float32 directional-derivative check: central difference along
# g / |g| with step h, against |g|
GRAD_H, GRAD_TOL = 1e-2, 2e-2
# secure gradient aggregation at the smoke config (the int32 shares of
# 2.53e9 parameters would take 24 B each per institution)
SECURE_ARGV = ["--arch", "qwen2_5_32b", "--smoke", "--secure-agg", "shamir",
               "--institutions", "2", "--batch", "4", "--seq-len", "32",
               "--steps", "8", "--lr", "1e-2", "--log-every", "100"]
# the multi-device wires at benchmarks/secure_psum.py's defaults: 10^6
# float32 parameters (a leaf of 999,984 and a 4 x 4 leaf), 2-of-3 over
# FIELD_WIDE, 28 fractional bits; D = 4 ranks on one gloo group, a 2 x 2
# (pod, share) mesh, 4 scanned rounds; seconds a call are medians of
# WIRE_REPS calls after a warm-up
WIRE_PARAMS, WIRE_RANKS, WIRE_ROUNDS, WIRE_REPS = 1_000_000, 4, 4, 5
WIRE_MESH_2D = (2, 2)
WIRE_DEADLINE_S = 420.0  # the spawned ranks, imports and CUDA init included
GROUP_TIMEOUT_S = 120  # every process group fails a hung collective
# the repaired caps at protocol sizes: (t, w), and K2's reveal sizes k
CAP_SHAPES, CAP_KS = ((2, 17), (17, 20)), (17, 20)
# phase 16: the MoE and MLA families and the embeddings frontend at full
# width, one model on the card at a time: (arch, layers kept (None:
# all), parameters, layers of the float32 continuation (None: all, the
# bf16 weights converted in place: DeepSeek-V2-Lite's 62.9 GB fit, 8 of
# Qwen3-MoE's layers, 84.6 GB, do not))
F3A_MODELS = (("deepseek_v2_lite", None, 15_706_484_224, None),
              ("qwen3_moe_235b", 8, 21_146_701_824, 2),
              ("musicgen_medium", None, 1_365_394_944, None))
# the continuation runs drop-free (capacity_factor = E, so capacity = T k)
# at batch 1 on a prompt of this many tokens: a decode step's capacity
# max(1, int(4 * 6 * 1.25 / 64)) = 1 would drop what the prefill keeps
F3A_CONT_PROMPT = 512
# K7 on the new families' prefill shapes (bf16): MLA's Dk 192 with V's
# 128 columns zero-padded to 192 ("v128"), Qwen3-MoE's 64/4 GQA at D
# 128, MusicGen's MHA at D 64; checked against the plain version at
# K7_TOL and timed in phase 12 beside K7's own shapes
F3A_K7_CASES = (
    ("mla", 4, 2048, 16, 16, 192, "bfloat16", "v128"),
    ("qwen3_moe", 4, 2048, 64, 4, 128, "bfloat16", None),
    ("musicgen", 4, 2048, 24, 24, 64, "bfloat16", None),
)
MLA_DV = 128
# phase 17: the recurrent families whole, one model on the card at a time:
# (arch, parameters, the continuation's prompt lengths P: RecurrentGemma's
# 2,100 is past its 2,048-token window, so its prefill takes the banded
# scan and its decode the rolled ring)
F3B_MODELS = (("rwkv6_3b", 3_073_231_360, (512,)),
              ("recurrentgemma_9b", 9_572_782_080, (512, 2100)))
# K7 at RecurrentGemma's local attention in serving (bf16, B 4, S 2048,
# 16 query heads on 1 KV head of 256): checked at K7_TOL, timed in phase 12
F3B_K7_CASES = (("recurrentgemma", 4, 2048, 16, 1, 256, "bfloat16", None),)
# (e) the recurrent modules at full width in float32, the card against
# the CPU: one layer of RWKV6-3B and one of RecurrentGemma-9B at B 2, S
# 256, outputs and states within this share of their max; RWKV6 also
# chunked (rwkv_chunk 16), held to its per-token form alike
F3B_CHECK_B, F3B_CHECK_S, F3B_CHECK_CHUNK, F3B_CHECK_TOL = 2, 256, 16, 1e-4
# moe_ffn at Qwen3-MoE's prefill (T = 4 x 2048, E 128, top 8, capacity
# 640) in float32 on the card against the CPU: ids, slots and drops
# equal, y within this share of max|y| (summation order)
MOE_CHECK_TOL = 1e-5
# phase 18: the F3a and F3b families trained at full width, one model on
# the card at a time, each cut in depth to fit 80 GB beside its AdamW
# moments (16 B a parameter: bf16 weights and per-institution gradient,
# float32 mean and two moments): (arch, layers kept (None: all),
# parameters); bf16 from SEED with cell 8's traffic (TRAIN_INST
# institutions of one TRAIN_SEQ-token sequence, TRAIN_LR, warm-up over
# half the run, remat), F4_STEPS steps; RWKV6 in its chunked form at the
# JAX package's training preset (``configs/perf_presets.py``: 32)
F4_MODELS = (("deepseek_v2_lite", 4, 2_254_983_168),
             ("qwen3_moe_235b", 1, 3_732_418_560),
             ("musicgen_medium", None, 1_365_394_944),
             ("rwkv6_3b", None, 3_073_231_360),
             ("recurrentgemma_9b", 6, 3_275_968_512))
F4_STEPS, F4_RWKV_CHUNK = 6, 32
# (b) the float32 directional derivative (GRAD_TOL) of the families
# without routing, and DeepSeek-V2-Lite's dense layer 0 alone (MLA):
# (arch, layers kept, parameters, the steps h, the last one checked); a
# MoE layer's finite difference can cross a routing boundary, so
# moe_ffn's backward at F4_MOE_ARCHS' widths is held card against CPU.
# RWKV6-3B's loss curves hard along g (|g| 163 at init, the token table's
# share 98): its central difference converges as h^2 (relative error
# 0.16, 0.046, 0.012, 0.0020 at h = 1e-2, 5e-3, 2.5e-3, 1e-3 on the
# H100), so it is read at GRAD_H and held at 1e-3
F4_GRAD_CHECKS = (("musicgen_medium", None, 1_365_394_944, (GRAD_H,)),
                  ("rwkv6_3b", None, 3_073_231_360, (GRAD_H, 1e-3)),
                  ("recurrentgemma_9b", 6, 3_275_968_512, (GRAD_H,)),
                  ("deepseek_v2_lite", 1, 500_439_552, (GRAD_H,)))
F4_MOE_ARCHS = ("qwen3_moe_235b", "deepseek_v2_lite")
# K8a/K8b at the families' training shapes (bf16, B 1, S 2048): MLA's Dk
# 192 with V and do zero past 128 columns, as ``attend`` pads V;
# Qwen3-MoE's 64/4 GQA; MusicGen's 24 heads of 64 (RecurrentGemma's 16/1
# at D 256 is K8_CASES' "d256"); checked at K7_TOL, timed in phase 12
F4_K8_CASES = (
    ("train_mla", 1, 2048, 16, 16, 192, "bfloat16", "v128"),
    ("train_qwen3_moe", 1, 2048, 64, 4, 128, "bfloat16", None),
    ("train_musicgen", 1, 2048, 24, 24, 64, "bfloat16", None),
)
# phase 19: the sharded serving path.  (b): D2A_RANKS spawned gloo ranks
# on cuda:0 with a D2A_MESH (data, model) mesh, one model at a time:
# (arch, layers kept, flags, prompt length, batch); a teacher-forced
# prefill and D2A_STEPS decode steps fed the unsharded run's greedy
# tokens, held to it by phase 16's rule (CONT_TOL or twice the bf16
# noise).  The MoE serves drop-free (capacity_factor E / k: a capacity
# of T, so a token the two runs route a hair differently drops nothing),
# at batch 1: the unsharded (E, T, d) buffer of 4 x 2048 tokens would
# take 8.6 GB in bf16 (64 GB at capacity_factor E); its moe_ffn check
# runs at D2A_MOE_BATCH x 2048 tokens at a capacity factor of D2A_MOE_CF,
# a capacity of the mean load, so that assignments drop
D2A_RANKS, D2A_MESH, D2A_STEPS, D2A_MOE_BATCH = 4, (1, 4), 8, 4
D2A_MOE_CF = 1.0
D2A_MODELS = (("qwen2_5_32b", 2, {}, 2048, 4),
              ("qwen3_moe_235b", 1, {}, 2048, 1),
              ("h2o_danube3_4b", 2, {"seq_parallel_prefill": True}, 8192, 4),
              ("recurrentgemma_9b", 3, {}, 2048, 4))
D2A_DEADLINE_S = 600.0  # the spawned ranks, imports and CUDA init included
# K7 at the local heads a rank runs under the (1, 4) mesh (bf16, B 4, S
# 2048): Qwen2.5-32B's 40/8 -> 10/2, Qwen3-MoE's 64/4 -> 16/1,
# RecurrentGemma's 16/1 -> 4/1 at D 256 (its one KV head whole on every
# rank); checked at K7_TOL, timed in phase 12
D2A_K7_CASES = (
    ("tp4_qwen2_5", 4, 2048, 10, 2, 128, "bfloat16", None),
    ("tp4_qwen3_moe", 4, 2048, 16, 1, 128, "bfloat16", None),
    ("tp4_recurrentgemma", 4, 2048, 4, 1, 256, "bfloat16", None),
)


# phase 20: gradients under a mesh.  (a) D2B_STEPS ``mesh_train_step``
# calls of phase 13's configuration and traffic (Qwen2.5-32B at 2 of 64
# layers, one batch of TRAIN_BATCH x TRAIN_SEQ tokens a step) on one NCCL
# rank with a (1, 1) mesh and without rules, bit for bit; (b) D2B_RANKS
# spawned gloo ranks on cuda:0 with a D2B_MESH (data, model) mesh, one
# model at a time: (arch, layers kept, flags, sequence length, batch),
# bf16 from SEED, remat, one ``mesh_train_step`` each; every rank's
# gradient blocks held per leaf to rank 0's unsharded bf16 gradient by
# phase 16's rule (the larger of CONT_TOL max|g| and twice that
# gradient's distance from the float32 one), the loss and the grad norm
# alike.  The MoE runs drop-free (capacity factor E / k) at batch 1: its
# unsharded float32 reference at batch 2 would take the card's memory.
D2B_RANKS, D2B_MESH, D2B_STEPS = 4, (1, 4), 3
D2B_MODELS = (("qwen2_5_32b", 2, {}, 2048, 2),
              ("qwen3_moe_235b", 1, {}, 2048, 1),
              ("h2o_danube3_4b", 2, {"seq_parallel_prefill": True}, 8192, 1),
              ("recurrentgemma_9b", 3, {}, 2048, 2))
D2B_DEADLINE_S = 900.0  # the spawned ranks, imports and CUDA init included
# K8a/K8b at the local heads a rank's backward runs under the (1, 4) mesh
# (bf16, B 1, S 2048: Qwen2.5-32B's 10/2 and Qwen3-MoE's 16/1 of 128,
# RecurrentGemma's 4/1 of 256); checked at K7_TOL, timed in phase 12
D2B_K8_CASES = (
    ("train_tp4_qwen2_5", 1, 2048, 10, 2, 128, "bfloat16", None),
    ("train_tp4_qwen3_moe", 1, 2048, 16, 1, 128, "bfloat16", None),
    ("train_tp4_recurrentgemma", 1, 2048, 4, 1, 256, "bfloat16", None),
)


# phase 21: the shape dry run.  (b) phase 20 (a)'s step, predicted on a
# (1, 1) fake mesh and measured on one rank: the card's
# max_memory_allocated over the step may exceed the predicted peak by the
# allocator's rounding (each block to 512 bytes) and the cuBLAS
# workspaces it hands out, neither of which the counter counts: at most
# PEAK_BAND bytes more, and never less.  Measured on an NVIDIA H100 80GB
# HBM3 at 700 W: +68,160,488 B with --only 21 (cuBLAS's workspace made
# inside the step) and +1,051,624 B in the whole script (made before it)
PEAK_BAND = 128 << 20
# (c) phase 20 (b)'s counts a rank from its earlier run on an NVIDIA H100
# 80GB HBM3 at 700 W (PERF.md section 6): held when phase 20 does not
# run (--only 21)
D2B_RANK_BYTES = {"qwen2_5_32b": 1_266_235_392,
                  "qwen3_moe_235b": 1_867_014_144,
                  "h2o_danube3_4b": 277_747_200,
                  "recurrentgemma_9b": 1_343_447_040}
D2B_RANK_WIRE = {
    "qwen2_5_32b": {"all_reduce": 587_251_716, "all_reduce_calls": 17,
                    "all_gather": 7_168, "all_gather_calls": 6},
    "qwen3_moe_235b": {"all_reduce": 135_290_900, "all_reduce_calls": 16},
    "h2o_danube3_4b": {"all_reduce": 125_958_148, "all_reduce_calls": 9,
                       "all_gather": 341_114_880, "all_gather_calls": 30,
                       "ppermute": 94_371_840, "ppermute_calls": 24,
                       "reduce_scatter": 619_315_200,
                       "reduce_scatter_calls": 14},
    "recurrentgemma_9b": {"all_reduce": 683_720_708, "all_reduce_calls": 29,
                          "all_gather": 16_818_176, "all_gather_calls": 16}}
# (d) the sweep's subprocesses at once, and how long it may take
SWEEP_JOBS, SWEEP_DEADLINE_S = 8, 420
# phase 22: the normal entry points.  The twins of the four examples
# (examples/torch_*.py, their own sizes), then launch.train's command
# line on the paper's four studies at paper size (``load_study`` scale
# 1.0: Insurance 9,822 x 84 and the Parkinsons studies 5,875 x 20 over 5
# institutions, Synthetic 999,996 x 6 over 6), fused rounds, protect
# "both", 2-of-3 over the CRT pair; the LM trainer with a failure and
# compression; launch.serve's smoke configs (the JAX package's serve
# always serves its smoke config)
EP_STUDIES = {"insurance": (84, 5, 9_822),
              "parkinsons.motor": (20, 5, 5_875),
              "parkinsons.total": (20, 5, 5_875),
              "synthetic": (6, 6, 999_996)}
EP_FUSED = ["--fused", "--protect", "both"]
EP_SELECT = ["--study", "insurance", "--select-lambda", "10,3,1,0.3",
             "--folds", "3"]
EP_L1 = ["--study", "parkinsons.total", "--l1", "0.1"]
EP_FAIL = ["--arch", "qwen2_5_32b", "--smoke", "--steps", "4", "--batch",
           "4", "--seq-len", "32", "--institutions", "4", "--fail-at", "2",
           "--compress"]
EP_SERVE = ("qwen2_5_32b", "deepseek_v2_lite", "rwkv6_3b")
# host-to-device copies of at least this many elements count as uploads
EP_UPLOAD_MIN = 1024


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def shape_q(q, how):
    """q as a flash case asks (``K7_CASES``' last field), in place."""
    if how == "outliers":
        q[:, 17] *= 30.0
    elif how == "peaked":
        q *= 4.0
    return q


def cuda_times(fn, reps: int) -> tuple[float, float]:
    """(device ms, call ms) of ``fn``, medians over ``reps`` samples.

    Device ms: CUDA events around one call, recorded while the card is
    kept busy by a spin kernel, so the host's enqueue cost (Python,
    ctypes, allocation) never shows as card time.  Call ms: host clock
    around one call and a synchronize — what a caller pays, wrapper
    overhead included.
    """
    import torch

    fn()  # warm-up
    dev, call = [], []
    for _ in range(reps):
        torch.cuda.synchronize()
        torch.cuda._sleep(SPIN_CYCLES)  # the host enqueues behind this
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        dev.append(a.elapsed_time(b))
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        call.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(dev), statistics.median(call)


def bound(work):
    """(least ms, what bounds it) of a kernel's work
    (``repro_torch.kernels.work``: the one definition the cost counter
    charges too): the larger of the bytes' time and the operations' time;
    each type's operations run at its own peak on its own pipe, so the
    operations take the longest of them.  A float32 Gram counts as three
    TF32 products (hi x hi, hi x lo, lo x hi), the least work that keeps
    float32's precision on the tensor cores."""
    t_bytes = work.bytes / PEAK_BYTES
    t_ops = max(work.tf32 / PEAK_TF32, work.f64 / PEAK_F64,
                work.bf16 / PEAK_BF16, work.f32 / PEAK_F32)
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def _union_us(intervals) -> float:
    total, end = 0.0, -1.0
    for a, b in sorted(intervals):
        if a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


# device-time categories of a round, by kernel-name substring (first hit)
CATEGORIES = (
    ("K5 fused_irls_cv", ("irls_cv_rows_kernel", "irls_cv_gram_kernel",
                          "irls_cv_reduce_kernel")),
    ("K3 fused_irls", ("k3_rows_kernel", "k3_gram_kernel",
                       "k3_reduce_kernel")),
    ("K1 encode_share", ("encode_share",)),
    ("K2 reconstruct", ("reconstruct_kernel",)),
    ("K4 leaf-wise share", ("leafwise_share",)),
    ("K6 gram_hessian", ("k6_gram_kernel", "k6_reduce_kernel")),
    ("solve (LU, cuBLAS/cuSOLVER)", ("getrf", "getrs", "laswp", "trsm",
                                     "trsv", "ipiv", "lu_", "magma",
                                     "solve", "gemv", "batch_")),
    ("memcpy/memset", ("Memcpy", "Memset", "memcpy", "memset")),
)


# the serving run's categories (first hit): cuBLAS names its bf16 matmuls
# nvjet_*, and the float32 products of decode attention gemmSN_*/gemv*
SERVE_CATEGORIES = (
    ("K7 flash_attention", ("flash_attention_fwd", "flash_fwd_bf16")),
    ("decode attention products (float32)", ("gemmSN", "gemv")),
    ("matmul (cuBLAS)", ("nvjet", "gemm", "xmma", "cutlass", "sm90_",
                         "splitKreduce")),
    ("copies and casts", ("direct_copy", "bfloat16_copy", "CatArray")),
    ("memcpy/memset", ("Memcpy", "Memset", "memcpy", "memset")),
)


# phase 16's serving runs: the serving categories and the MoE FFN's
# routing and dispatch (sort, the counts, scatters and gathers)
F3A_CATEGORIES = SERVE_CATEGORIES[:3] + (
    ("MoE routing and dispatch", ("sort", "Sort", "scatter", "gather",
                                  "index", "scan", "cumsum")),
) + SERVE_CATEGORIES[3:]


# phase 17's serving runs: the recurrences' steps apart from the rest
# (RWKV6's per-token r . S products are cuBLAS's small batched gemv, as
# are decode attention's float32 products; the elementwise multiplies,
# adds and casts of both loops, which the blocks' own few elementwise ops
# a layer join)
F3B_CATEGORIES = SERVE_CATEGORIES[:1] + (
    ("recurrence steps: r . S products (RWKV6), decode attention "
     "products", ("gemmSN", "gemv", "gemmk1")),
) + SERVE_CATEGORIES[2:3] + (
    ("recurrence steps: elementwise (mul, add, cast)", (
        "MulFunctor", "AddFunctor", "CUDAFunctor_add", "mul_kernel",
        "add_kernel", "bfloat16_copy", "direct_copy")),
) + SERVE_CATEGORIES[3:]


# a training step's categories (first hit); the AdamW update is profiled
# on its own, where every kernel is its elementwise work
TRAIN_CATEGORIES = (
    ("K7 flash_attention", ("flash_attention_fwd", "flash_fwd_bf16")),
    ("K8a flash_dq", ("flash_dq_kernel", "flash_dq_bf16")),
    ("K8b flash_dkdv", ("flash_dkdv_kernel", "flash_dkdv_bf16")),
    ("matmul (cuBLAS)", ("nvjet", "gemm", "xmma", "cutlass", "sm90_",
                         "splitKreduce")),
    ("softmax / log_softmax", ("softmax",)),
    ("copies and casts", ("direct_copy", "bfloat16_copy", "CatArray")),
    ("memcpy/memset", ("Memcpy", "Memset", "memcpy", "memset")),
)
# phase 18's training steps: cell 8's categories and the MoE FFN's
# routing and dispatch
F4_CATEGORIES = TRAIN_CATEGORIES[:4] + F3A_CATEGORIES[3:4] \
    + TRAIN_CATEGORIES[4:]
ADAMW_CATEGORIES = (
    ("reductions (grad norm)", ("reduce_kernel",)),
    ("memcpy/memset", ("Memcpy", "Memset", "memcpy", "memset")),
    ("AdamW elementwise (casts, mul, add, sqrt, div, copy)",
     ("elementwise", "copy", "pow")),
)


def _category(name: str, categories=CATEGORIES) -> str:
    for cat, keys in categories:
        if any(k in name for k in keys):
            return cat
    return "small ops"


def profile_run(run, rounds_of, label: str, repeats: int,
                trace: str = "", categories=CATEGORIES) -> dict:
    """``repeats`` timed runs, then one under ``torch.profiler``: the
    device time per kernel name and per category, and the card's idle
    share of the run.  ``rounds_of(result)`` counts the run's rounds."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    per_round = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = run()
        torch.cuda.synchronize()
        per_round.append((time.perf_counter() - t0) / rounds_of(res))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        with record_function(label):
            res = run()
            torch.cuda.synchronize()
    rounds = rounds_of(res)
    events = prof.events()
    window = next(e for e in events if e.name == label
                  and e.device_type == DeviceType.CPU)
    w0, w1 = window.time_range.start, window.time_range.end
    by_name: dict = collections.defaultdict(lambda: [0, 0.0])
    busy = []
    for e in events:
        # device kernels and copies only: the record_function range is
        # mirrored on the device timeline as an annotation, skip it
        if e.device_type != DeviceType.CUDA or e.name == label \
                or getattr(e, "is_user_annotation", False):
            continue
        a, b = e.time_range.start, e.time_range.end
        by_name[e.name][0] += 1
        by_name[e.name][1] += b - a
        busy.append((max(a, w0), min(b, w1)))
    busy_us = _union_us([(a, b) for a, b in busy if b > a])
    wall_us = w1 - w0
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])
    by_cat: dict = collections.defaultdict(float)
    for n, (_, us) in top:
        by_cat[_category(n, categories)] += us / rounds
    if trace:
        prof.export_chrome_trace(trace)
    return {
        "run": label,
        "rounds": rounds,
        "seconds_per_round": per_round,
        "profiled_wall_us": wall_us,
        "device_busy_us": busy_us,
        "device_idle_share": 1.0 - busy_us / wall_us,
        "device_us_per_round": sum(us for _, (_, us) in top) / rounds,
        "device_us_per_round_by_category": dict(
            sorted(by_cat.items(), key=lambda kv: -kv[1])),
        "device_kernels": [{"name": n[:120], "count": c, "us": us}
                           for n, (c, us) in top],
    }


def rel_close(got, want, scale, rtol: float) -> bool:
    """|got - want| <= rtol * scale elementwise (scale: sums of absolute
    terms, so a sum that cancels to ~0 is still held to its terms)."""
    return bool(((got - want).abs() <= rtol * scale + 1e-300).all())


def gram_f64(Xm, w32):
    """(S, d, d): the float32 products (Xm w) x Xm of the Gram summed in
    float64 — what the kernel and the plain version each round only in
    their float32 sums, so each one's summation error shows against it."""
    import torch

    return torch.einsum("sni,snj->sij",
                        (Xm * w32[..., None]).double(), Xm.double())


def check_k5(dev, gen, packed, beta):
    """K5 against its plain version on the card; returns (max|dH| over
    the cases, the path-shape arguments for timing, and per case the
    largest |H - gram_f64| of the kernel and of the plain version)."""
    import torch
    from repro_torch.kernels.fused_irls import fused_irls_cv_kernel, \
        fused_irls_cv_plain
    from repro_torch.kernels.ref import masked_cv_terms
    from repro_torch.selection import assign_folds, pack_fold_ids

    n_max = packed.X.shape[1]
    fids = pack_fold_ids([assign_folds(int(c), FOLDS, j) for j, c in
                          enumerate(packed.counts.tolist())], n_max, dev)
    betas = beta[None] + 0.01 * torch.randn(
        (FOLDS, D), generator=gen, dtype=torch.float64, device=dev)
    folds = torch.arange(FOLDS, dtype=torch.int32, device=dev)
    path = (betas, packed.X, packed.X32, packed.y, packed.counts, fids,
            folds)
    refit = (betas[:1],) + path[1:6] + (
        torch.tensor([-1], dtype=torch.int32, device=dev),)
    # ragged, d = 130 (two H tiles per edge), a count past N_max, 4
    # folds: fold_of holds -1 and every fold
    n_r, d_r = 2500, 130
    Xr = torch.randn((3, n_r, d_r), generator=gen, dtype=torch.float64,
                     device=dev)
    yr = (torch.rand((3, n_r), generator=gen, device=dev) < 0.4).double()
    cr = torch.tensor([1000, 37, 3000], dtype=torch.int32, device=dev)
    fr = pack_fold_ids([assign_folds(n_r, 4, f"r{j}") for j in range(3)],
                       n_r, dev)
    fr = torch.where(torch.arange(n_r, device=dev)[None] < cr[:, None], fr,
                     -1)
    ragged = (0.05 * torch.randn((5, d_r), generator=gen,
                                 dtype=torch.float64, device=dev),
              Xr, Xr.float(), yr, cr, fr,
              torch.tensor([-1, 0, 1, 2, 3], dtype=torch.int32, device=dev))
    k5_err, vs_f64 = 0.0, {}
    for name, args in (("path C=5", path), ("refit C=1", refit),
                       ("ragged C=5 d=130", ragged)):
        got = fused_irls_cv_kernel(*args)
        again = fused_irls_cv_kernel(*args)
        check(all(torch.equal(a, b) for a, b in zip(got, again)),
              f"K5 {name}: two calls bit-identical")
        want = fused_irls_cv_plain(*args)
        b, X, _, y, cnt, fid, fold_of = args
        n = X.shape[1]
        valid = (torch.arange(n, device=dev)[None, :]
                 < cnt.clamp(max=n)[:, None])[None]
        z = torch.einsum("snd,cd->csn", X, b)
        p = torch.sigmoid(z)
        g_scale = torch.einsum("snd,csn->csd", X.abs(),
                               ((y[None] - p) * valid).abs())
        ll = (y[None] * z - torch.logaddexp(torch.zeros_like(z), z)) * valid
        dev_scale = 2.0 * ll.abs().sum(dim=2)
        dH = float((got[0] - want[0]).abs().max())
        check(dH <= 2e-5 * float(want[0].abs().max()), f"K5 {name} H {dH}")
        check(rel_close(got[1], want[1], g_scale, 1e-10), f"K5 {name} g")
        for k, what in ((2, "dev_train"), (3, "dev_val")):
            check(rel_close(got[k], want[k], dev_scale, 1e-10),
                  f"K5 {name} {what}")
        for k, what in ((4, "correct_val"), (5, "count_val")):
            check(torch.equal(got[k], want[k]), f"K5 {name} {what}")
        k5_err = max(k5_err, dH)
        w32 = masked_cv_terms(b, X, y, cnt, fid, fold_of)[0].float()
        H64 = torch.stack([gram_f64(args[2], w_c) for w_c in w32])
        vs_f64[name] = (float((got[0] - H64).abs().max()),
                        float((want[0] - H64).abs().max()))
    torch.cuda.synchronize()
    return k5_err, path, vs_f64


def check_path_launches(launches: dict, rounds: int, what: str) -> None:
    """Every executed round of the λ path, sweep and refit alike, is one
    multi-configuration round: one K5, one K1 protect and one K2 reveal;
    K3 (the single-configuration summaries) never runs there."""
    want = {"fused_irls_cv_kernel": rounds, "encode_share_kernel": rounds,
            "reconstruct_kernel": rounds, "fused_irls_kernel": 0}
    check(all(launches[k] == n for k, n in want.items()),
          f"{what} launches {launches} vs {rounds} rounds")


def k4_args(dev, gen, t: int, w: int, n: int, offset: int = 0):
    """K4's arguments over ``FIELD_WIDE``: (R, n) secrets with 0 and p - 1
    among them and (R, t-1, n) coefficients, each starting ``offset``
    elements into its storage (1 and 3 leave it off 16-byte alignment)."""
    import torch
    from repro_torch.core.field import FIELD_WIDE

    moduli = FIELD_WIDE.moduli

    def draw(*shape):
        x = torch.empty((len(moduli) * math.prod(shape) + offset,),
                        dtype=torch.int64, device=dev)
        x = x[offset:].view(len(moduli), *shape)
        for r, p in enumerate(moduli):
            x[r].random_(0, p, generator=gen)
        return x

    secret, coeffs = draw(n), draw(t - 1, n)
    secret[:, 0] = 0
    secret[:, 1] = torch.tensor(moduli, device=dev) - 1
    return secret, coeffs, moduli, w


def check_k4(dev, gen):
    """K4 against its plain version at the leaf-wise phase's size: n =
    1,000,000 elements, R = 2 residues, (t, w) = (2, 3) and (3, 5), and
    (2, 3) on inputs 1 and 3 elements into their storage.  Returns the
    (2, 3) and (3, 5) arguments."""
    import torch
    from repro_torch.kernels.shamir_poly import share_kernel, share_plain

    cases = {}
    for t, w, offset in ((2, 3, 0), (3, 5, 0), (2, 3, 1), (2, 3, 3)):
        args = k4_args(dev, gen, t, w, LEAF_N, offset)
        check(torch.equal(share_kernel(*args), share_plain(*args)),
              f"K4 t={t} w={w} n={LEAF_N} offset {offset}")
        if not offset:
            cases[(t, w)] = args
    return cases


def check_k6(X_all, w_all):
    """K6 against its plain version at one institution's (25,000 x 128)
    and the pooled (200,000 x 128) shape; returns (max|dH|, per shape the
    largest |H - float64 sum of the float32 products| of the kernel and of
    the plain version, the pooled float32 arguments)."""
    import torch
    from repro_torch.kernels.fused_irls import gram_hessian_kernel, \
        gram_hessian_plain

    X32, w32 = X_all.float(), w_all.float()
    err, vs_f64 = 0.0, {}
    for rows in (25_000, X32.shape[0]):
        Xr, wr = X32[:rows], w32[:rows]
        H = gram_hessian_kernel(Xr, wr)
        check(torch.equal(H, gram_hessian_kernel(Xr, wr)),
              f"K6 ({rows} x {Xr.shape[1]}): two calls bit-identical")
        Hp = gram_hessian_plain(Xr, wr)
        dH = float((H - Hp).abs().max())
        check(dH <= 2e-5 * float(Hp.abs().max()),
              f"K6 ({rows} x {Xr.shape[1]}) H err {dH}")
        H64 = gram_f64(Xr[None], wr[None])[0]
        vs_f64[f"{rows}x{Xr.shape[1]}"] = (float((H - H64).abs().max()),
                                           float((Hp - H64).abs().max()))
        err = max(err, dH)
    return err, vs_f64, (X32, w32)


def leafwise_phase(dev, counts):
    """Phase 6: leaf-wise Shamir through the kernel scheme at 1,000,000
    parameters and 4 institutions.  ``counts`` is (reset, read) of the
    launch counters.  Returns (seconds of the share calls, seconds of the
    three reconstructions, launches)."""
    import torch
    from repro_torch.core.collective import SecureCollective
    from repro_torch.core.field import FIELD_WIDE, fsum
    from repro_torch.core.fixed_point import FixedPointCodec
    from repro_torch.core.shamir import ShamirScheme

    reset, read = counts
    codec = FixedPointCodec(FIELD_WIDE, FRAC_BITS)
    scheme = ShamirScheme(2, 3, FIELD_WIDE, backend="kernel")
    gen = torch.Generator(device=dev).manual_seed(SEED + 6)
    leaves = [100.0 * torch.randn((LEAF_N,), generator=gen,
                                  dtype=torch.float64, device=dev)
              for _ in range(LEAF_INST)]
    encoded = [codec.encode(x) for x in leaves]  # (R, n) int64 each
    exact = codec.decode(fsum(torch.stack(encoded), FIELD_WIDE, axis=0,
                              residue_axis=0))
    torch.cuda.synchronize()
    reset()
    t0 = time.perf_counter()
    shares = [scheme.share(gen, e) for e in encoded]  # (3, R, n) each
    torch.cuda.synchronize()
    share_s = time.perf_counter() - t0
    agg_shares = fsum(torch.stack(shares), FIELD_WIDE, axis=0,
                      residue_axis=1)
    collective = SecureCollective(scheme=scheme, codec=codec)
    t0 = time.perf_counter()
    for pts in ((1, 2), (1, 3), (2, 3)):
        sel = agg_shares[[q - 1 for q in pts]]
        rec = codec.decode(scheme.reconstruct(sel, pts))
        check(torch.equal(rec, exact), f"leaf-wise reconstruct {pts}")
        tree = collective.reveal({"leaf": sel}, points=pts)
        check(torch.equal(tree["leaf"], exact), f"leaf-wise reveal {pts}")
    torch.cuda.synchronize()
    rec_s = time.perf_counter() - t0
    launches = read()
    R = FIELD_WIDE.num_residues
    want = {"share_kernel": LEAF_INST, "reconstruct_kernel": 2 * 3 * R,
            "encode_share_kernel": 0}
    check(all(launches[k] == n for k, n in want.items()),
          f"leaf-wise launches {launches}")
    check(float((exact - sum(leaves)).abs().max()) <= LEAF_INST / 2**FRAC_BITS,
          "leaf-wise exact sum vs float sum")
    return share_s, rec_s, launches


def gram_phase(parts, beta, counts):
    """Phase 7: each institution's weighted Gram at the IRLS weights
    through ``ops.gram_hessian`` (K6, X cast to float32 in the call), and
    their sum against the pooled Gram."""
    import torch
    from repro_torch.kernels import ops

    reset, read = counts
    ws = [torch.sigmoid(X @ beta) for X, _ in parts]
    ws = [p * (1.0 - p) for p in ws]
    torch.cuda.synchronize()
    reset()
    t0 = time.perf_counter()
    Hs = [ops.gram_hessian(X, w) for (X, _), w in zip(parts, ws)]
    pooled = ops.gram_hessian(torch.cat([X for X, _ in parts]),
                              torch.cat(ws))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = read()
    check(launches["gram_hessian_kernel"] == len(parts) + 1,
          f"gram launches {launches}")
    dsum = float((torch.stack(Hs).sum(0) - pooled).abs().max())
    check(dsum <= 2e-5 * float(pooled.abs().max()),
          f"sum of institution Grams vs pooled {dsum}")
    return secs, launches, dsum, float(pooled.abs().max())


def _fault_policy():
    from repro_torch.runtime import FaultPolicy

    # benchmarks/fault_overhead.py's _policy()
    return FaultPolicy(max_retries=4, backoff_base=1.0, backoff_factor=2.0,
                       round_seconds=1.0, heartbeat_timeout=5.0,
                       reprovision_after=1)


def supervisor_phase(dev, agg) -> dict:
    """Phase 8a: the fused ``StudyCoordinator`` at
    ``benchmarks/fault_overhead.py``'s configuration, bare and supervised
    (fault-free, interleaved), then under its three canned schedules."""
    import torch
    from repro_torch.core.protocol import Institution, StudyCoordinator
    from repro_torch.data import generate_synthetic
    from repro_torch.runtime import FailureInjector, RoundSupervisor

    fparts = generate_synthetic(SEED, FAULT_S, FAULT_N // FAULT_S, FAULT_D,
                                device=dev).parts

    def coord():
        return StudyCoordinator(
            [Institution(f"i{j}", X, y) for j, (X, y) in enumerate(fparts)],
            lam=1.0, protect=PROTECT, aggregator=agg, seed=SEED, fused=True,
            device=dev)

    def bare():
        c = coord()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        while not c.converged and c.iteration < FAULT_MAX_ROUNDS:
            c.step()
        torch.cuda.synchronize()
        return time.perf_counter() - t0, c, None

    def supervised(schedule=None):
        c = coord()
        sup = RoundSupervisor(c, policy=_fault_policy(),
                              injector=FailureInjector(schedule or {}))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sup.run(max_rounds=FAULT_MAX_ROUNDS)
        torch.cuda.synchronize()
        return time.perf_counter() - t0, c, sup

    bare()  # warm-up: allocator, pack cache
    supervised()
    per_round = {"bare": [], "supervised": []}
    for rep in range(FAULT_REPEATS):
        order = ("bare", "supervised") if rep % 2 == 0 else \
            ("supervised", "bare")
        for which in order:
            dt, c, _ = (bare if which == "bare" else supervised)()
            per_round[which].append(dt / c.iteration)
            if which == "bare":
                oracle = c
            else:
                sup_c = c
    check(oracle.converged and sup_c.converged, "fault-free runs converged")
    check(torch.equal(oracle.beta, sup_c.beta),
          "supervised fault-free beta bit-identical to the bare run")
    med = {k: statistics.median(v) for k, v in per_round.items()}
    out = {"rounds": oracle.iteration, "seconds_per_round": per_round,
           "overhead_pct": (med["supervised"] / med["bare"] - 1.0) * 100.0,
           "schedules": {}}
    quant = (FAULT_S + 1) / 2**FRAC_BITS
    for name, schedule in FAULT_SCHEDULES.items():
        dt, c, sup = supervised(schedule)
        err = float((c.beta - oracle.beta).abs().max())
        tol = 0.0 if name in CENTER_ONLY else quant
        check(c.converged and err <= tol,
              f"{name}: converged {c.converged}, err {err} > {tol}")
        out["schedules"][name] = {
            "rounds": c.iteration,
            "retries": sup.total_retries,
            "aborted_attempts": sum(r.aborted_attempts for r in sup.rounds),
            "degraded_rounds": sum(1 for r in sup.rounds if r.degraded),
            "sim_backoff_seconds": sup.total_backoff,
            "seconds": dt,
            "max_abs_err_vs_fault_free": err,
            "jax_cpu_run": BENCH_FAULT[name],
        }
    return out


def multistudy_phase(dev, agg, parts, counts):
    """Phase 9: four studies at the fit's shape advanced by one collective
    round each, ten rounds, against four independent fits.  Returns the
    results and the timed run (for ``--profile``)."""
    import torch
    from repro_torch.core import (
        fused_multistudy_iteration,
        run_multistudy_rounds,
        stack_studies,
    )
    from repro_torch.core.newton import SecureFitDriver
    from repro_torch.data import generate_synthetic, ragged_sizes, split_rows

    reset, read = counts
    studies = []
    for seed in MS_SEEDS:
        if seed == SEED:
            studies.append(parts)
            continue
        Xs, ys = generate_synthetic(seed, num_institutions=1,
                                    records_per_institution=N, dim=D,
                                    device=dev).pooled()
        studies.append(split_rows(Xs, ys, ragged_sizes(N, S)))

    def run():
        return run_multistudy_rounds(
            studies, MS_LAMS, MS_ROUNDS, aggregator=agg, protect=PROTECT,
            seed=SEED, device=dev)

    run()  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset()
    t0 = time.perf_counter()
    betas, trace = run()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = read()
    peak = torch.cuda.max_memory_allocated()
    M = len(studies)
    want = {"fused_irls_kernel": M * MS_ROUNDS,
            "encode_share_kernel": MS_ROUNDS, "reconstruct_kernel": MS_ROUNDS,
            "fused_irls_cv_kernel": 0, "share_kernel": 0}
    check(all(launches[k] == n for k, n in want.items()),
          f"multi-study launches {launches} over {MS_ROUNDS} rounds")
    # the same rounds one at a time, for the per-round betas
    packed = stack_studies(studies)
    x_bytes = packed.X.numel() * 12  # float64 X + its float32 copy
    b = torch.zeros((M, D), dtype=torch.float64, device=dev)
    lams = torch.tensor(MS_LAMS, dtype=torch.float64, device=dev)
    per_round = []
    for r in range(MS_ROUNDS):
        b = fused_multistudy_iteration(
            b, agg.round_key(SEED, r, dev), packed.X, packed.X32, packed.y,
            packed.counts, lams, agg, PROTECT, 0.0)[0]
        per_round.append(b)
    check(torch.equal(b, betas), "per-round loop vs run_multistudy_rounds")
    err, obj_err = 0.0, 0.0
    for m, study in enumerate(studies):
        drv = SecureFitDriver(study, lam=MS_LAMS[m], protect=PROTECT,
                              aggregator=agg, summaries_backend="kernel",
                              device=dev)
        for r in range(MS_ROUNDS):
            if not drv.converged:
                rep = drv.step()
                obj_err = max(obj_err, abs(float(trace[r, m])
                                           - rep.objective))
            e = float((per_round[r][m] - drv.beta).abs().max())
            check(e <= QUANT_TOL, f"study {m} round {r + 1}: beta err {e}")
            err = max(err, e)
    return {"studies": M, "rounds": MS_ROUNDS, "seconds": secs,
            "seconds_per_round": secs / MS_ROUNDS, "launches": launches,
            "max_beta_err_vs_independent": err,
            "max_objective_err_vs_independent": obj_err,
            "x_bytes_on_card": x_bytes, "peak_bytes_allocated": peak}, run


def check_k7(dev, cases=K7_CASES, timed_names=("serving",) + FLASH_TIMED):
    """K7 against its plain version on the card at the shapes of
    ``cases``; returns (the largest |o - plain o| over them, the (q, k, v)
    of the shapes in ``timed_names`` by name, for timing).  A case's
    "v128" zeroes V past MLA's 128 columns, as ``attend`` pads it."""
    import torch
    from repro_torch.kernels.flash_attention import flash_attention_kernel, \
        flash_attention_plain

    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    err, timed = 0.0, {}
    for name, B, S_, H, KVH, Dh, dt, how in cases:
        dtype = getattr(torch, dt)
        q, k, v = (torch.randn((B, S_, n, Dh), generator=gen, device=dev)
                   for n in (H, KVH, KVH))
        if how == "v128":
            v[..., MLA_DV:] = 0.0
        q, k, v = shape_q(q, how).to(dtype), k.to(dtype), v.to(dtype)
        o, m, l = flash_attention_kernel(q, k, v)
        op, mp, lp = flash_attention_plain(q, k, v)
        atol, rtol = K7_TOL[dt]
        do = (o.float() - op.float()).abs()
        check(bool((do <= atol + rtol * op.float().abs()).all()),
              f"K7 {name} o err {float(do.max())}")
        dm = (m - mp).abs()
        check(bool((dm <= 1e-6 + 1e-5 * mp.abs()).all()),
              f"K7 {name} m err {float(dm.max())}")
        check(bool(((l - lp).abs() <= 1e-5 * lp).all()),
              f"K7 {name} l err {float((l - lp).abs().max())}")
        err = max(err, float(do.max()))
        if name in timed_names:
            timed[name] = (q, k, v)
        del op, mp, lp
    torch.cuda.synchronize()
    return err, timed


def serving_phase(dev, smi, counts):
    """Phase 10b: 8 requests at Qwen2.5-32B's full width (8 of 64 layers)
    through ``launch.serve.serve_requests``, then the continuation check.
    Returns (the ``serve`` line's fields, the timed run for --profile, the
    served tokens by request)."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import serve_requests
    from repro_torch.models import transformer as T

    reset, read = counts
    full = get_config(SERVE_ARCH)
    cfg = dataclasses.replace(full, num_layers=SERVE_LAYERS)
    check(T.count_params(cfg) == SERVE_PARAMS,
          f"serving params {T.count_params(cfg)}")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = T.init_params(cfg, seed=SEED, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    gen = torch.Generator().manual_seed(SEED)
    prompts = torch.randint(0, cfg.vocab_size,
                            (SERVE_REQUESTS, SERVE_PROMPT + 1),
                            generator=gen).to(dev)
    served = prompts[:, :SERVE_PROMPT]

    def run():
        return serve_requests(params, cfg, served, SERVE_BATCH, SERVE_NEW)

    serve_requests(params, cfg, served[:SERVE_BATCH], SERVE_BATCH, 2)  # warm
    torch.cuda.synchronize()
    reset()
    t0 = time.perf_counter()
    completed, stats = run()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = read()
    peak = torch.cuda.max_memory_allocated()
    tokens = sum(len(v) for v in completed.values())
    want = {"flash_attention_kernel": stats["batches"] * SERVE_LAYERS}
    want.update({k: 0 for k in launches if k not in want})
    check(launches == want, f"serving launches {launches}: K7 once per "
          f"layer of each of {stats['batches']} prefills, nothing else")
    check(tokens == SERVE_REQUESTS * SERVE_NEW, f"tokens {tokens}")
    check(stats["nonfinite_logits"] == 0,
          f"{stats['nonfinite_logits']} non-finite logits")
    # continuation: decode after a P-token prefill == prefill over P + 1
    batch = prompts[:SERVE_BATCH]

    def continuation(p, c):
        with torch.inference_mode():
            _, caches, n = T.prefill(p, c, batch[:, :SERVE_PROMPT],
                                     cache_len=SERVE_PROMPT + 1)
            dec, _, _ = T.decode_step(p, caches, n, c,
                                      batch[:, SERVE_PROMPT])
            del caches
            ref, _, _ = T.prefill(p, c, batch)
        return dec.float(), ref.float()

    dec, ref = continuation(params, cfg)
    # the same weights in float32: the path itself, without bf16 rounding
    cfg32 = dataclasses.replace(cfg, dtype_str="float32")
    p32 = {k: (v.float() if torch.is_tensor(v) else
               [{n: t.float() for n, t in seg.items()} for seg in v])
           for k, v in params.items()}
    dec32, ref32 = continuation(p32, cfg32)
    del p32
    torch.cuda.empty_cache()
    cont_err = float((dec - ref).abs().max())
    cont32_err = float((dec32 - ref32).abs().max())
    bf16_noise = float((ref - ref32).abs().max())
    scale = float(ref.abs().max())
    check(cont32_err <= CONT_TOL_F32 * float(ref32.abs().max()),
          f"float32 continuation: max|decode - prefill| {cont32_err}")
    check(cont_err <= CONT_TOL * scale,
          f"continuation: max|decode - prefill| {cont_err} (max|logit| "
          f"{scale}, bf16 vs float32 prefill {bf16_noise})")
    agree = float((dec.argmax(-1) == ref.argmax(-1)).float().mean())
    prefill_tokens = stats["batches"] * SERVE_BATCH * SERVE_PROMPT
    out = {
        "arch": full.name, "num_layers": SERVE_LAYERS,
        "reduced": {"num_layers": f"{SERVE_LAYERS} of {full.num_layers}"},
        "params": SERVE_PARAMS, "params_full_depth": T.count_params(full),
        "requests": SERVE_REQUESTS, "batch": SERVE_BATCH,
        "prompt_len": SERVE_PROMPT, "new_tokens": SERVE_NEW,
        "tokens_generated": tokens, "seconds": secs,
        "tokens_per_second": tokens / secs,
        "prefill_seconds": stats["prefill_seconds"],
        "prefill_tokens_per_second": prefill_tokens
        / stats["prefill_seconds"],
        "decode_steps": stats["decode_steps"],
        "decode_ms_per_step": stats["decode_seconds"]
        / stats["decode_steps"] * 1e3,
        "launches": launches,
        "continuation_max_abs_err": cont_err,
        "continuation_max_abs_logit": scale,
        "continuation_f32_max_abs_err": cont32_err,
        "bf16_vs_f32_prefill_max_abs_err": bf16_noise,
        "continuation_argmax_agreement": agree,
        "init_params_seconds": init_s,
        "peak_bytes_allocated": peak,
        "sample_output": completed[0][:8],
        "card": smi,
    }
    return out, run, completed


def check_routing(what, card, cpu, top_k: int, capacity: int) -> None:
    """The router's expert ids, and the queue positions, kept mask, slots
    and drops ``moe._dispatch`` makes of them, equal on the card and the
    CPU for ``card`` and ``cpu`` = (x (B, S, d), router (d, E))."""
    import torch
    from repro_torch.models import moe

    routes = [moe._route(x.reshape(-1, x.shape[-1]), w, top_k)[1]
              for x, w in (card, cpu)]
    check(torch.equal(routes[0].cpu(), routes[1]),
          f"{what}: expert ids on the card vs the CPU")
    E = card[1].shape[1]
    for name, a, b in zip(("queue positions", "kept", "slots", "dropped"),
                          moe._dispatch(routes[0], capacity, 0, E, E),
                          moe._dispatch(routes[1], capacity, 0, E, E)):
        check(torch.equal(a.cpu(), b), f"{what}: {name} card vs CPU")


def moe_check(dev):
    """Phase 16 (d): ``moe_ffn`` at Qwen3-MoE's prefill (T = 4 x 2048,
    d 4096, E 128, top 8, h 1536, capacity 640) in float32 on the card
    against the same function on the CPU, same inputs.  x and the router
    are drawn on a grid (multiples of 1/8 and 1/64), so the router's
    logits are exact in any summation order and the expert ids, queue
    positions, kept slots and drops must be equal; y within
    ``MOE_CHECK_TOL`` of max|y|."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import moe

    cfg = get_config("qwen3_moe_235b")
    T_ = SERVE_BATCH * SERVE_PROMPT
    d, E, h, k = cfg.d_model, cfg.moe_num_experts, cfg.moe_d_ff, \
        cfg.moe_top_k
    capacity = max(1, int(T_ * k * cfg.capacity_factor / E))
    check(capacity == 640, f"Qwen3-MoE prefill capacity {capacity}")
    gen = torch.Generator(device=dev).manual_seed(SEED + 16)
    params = {"router": torch.randint(-8, 9, (d, E), generator=gen,
                                      device=dev) / 64.0}
    for name, shape in (("experts_w1", (E, d, h)), ("experts_w3", (E, d, h)),
                        ("experts_w2", (E, h, d))):
        params[name] = min(0.02, shape[1] ** -0.5) * torch.randn(
            shape, generator=gen, device=dev)
    x = torch.randint(-8, 9, (SERVE_BATCH, SERVE_PROMPT, d), generator=gen,
                      device=dev) / 8.0
    host = {n: t.cpu() for n, t in params.items()}
    x_host = x.cpu()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    y, aux, drop = moe.moe_ffn(x, params, cfg)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    y_cpu, aux_cpu, drop_cpu = moe.moe_ffn(x_host, host, cfg)
    cpu_s = time.perf_counter() - t0
    check_routing("moe_ffn", (x, params["router"]),
                  (x_host, host["router"]), k, capacity)
    check(float(drop) == float(drop_cpu),
          f"moe_ffn drop fraction {float(drop)} vs {float(drop_cpu)}")
    scale = float(y_cpu.abs().max())
    err = float((y.cpu() - y_cpu).abs().max())
    check(err <= MOE_CHECK_TOL * scale,
          f"moe_ffn y card vs CPU {err} (max|y| {scale})")
    out = {"T": T_, "d_model": d, "experts": E, "top_k": k, "d_ff": h,
           "capacity": capacity, "dropped_fraction": float(drop),
           "y_max_abs_err": err, "y_max_abs": scale,
           "aux": float(aux), "aux_cpu": float(aux_cpu),
           "card_seconds_first_call": card_s, "cpu_seconds": cpu_s}
    del params, host, x, y
    torch.cuda.empty_cache()
    return out


def cut_layers(params, cfg, n: int, dtype):
    """(the first ``n`` layers of ``params`` cast to ``dtype``, ``cfg``
    cut to them): a cut config's segments are a prefix of the full
    one's."""
    import dataclasses

    import torch
    from repro_torch.models.config import segments

    c = dataclasses.replace(cfg, num_layers=n, dtype_str=str(dtype)
                            .removeprefix("torch."))
    segs = [{k: v[:cnt].to(dtype) for k, v in seg.items()}
            for (_, cnt), seg in zip(segments(c), params["segments"])]
    out = {k: params[k].to(dtype) for k in ("embed", "final_norm",
                                             "lm_head")}
    out["segments"] = segs
    torch.cuda.synchronize()
    return out, c


def to_float32_in_place(params, cfg):
    """(``params`` converted to float32 leaf by leaf in place, the largest
    first, each bf16 leaf freed as its copy is made: the peak is the
    float32 model plus the last, smallest leaf; ``cfg`` in float32)."""
    import dataclasses

    import torch

    leaves = [(tree, name) for tree in (params, *params["segments"])
              for name, leaf in tree.items() if torch.is_tensor(leaf)]
    for tree, name in sorted(leaves, key=lambda tn: -tn[0][tn[1]].numel()):
        tree[name] = tree[name].float()
    return params, dataclasses.replace(cfg, dtype_str="float32")


def serve_frames(params, cfg, frames, prompt: int, steps: int):
    """The embeddings frontend's serving loop (MusicGen): one prefill of
    ``frames[:, :prompt]``, then ``steps`` decode steps, each on the next
    frame, the greedy codebook token of every step read back as
    ``serve_requests`` reads its tokens.  Returns (slot -> its tokens,
    the stats ``serve_requests`` returns)."""
    import torch
    from repro_torch.models import transformer as T

    with torch.inference_mode():
        t0 = time.perf_counter()
        logits, caches, n = T.prefill(params, cfg, embeds=frames[:, :prompt],
                                      cache_len=prompt + steps)
        nonfinite = (~torch.isfinite(logits)).sum()
        outs = [[t] for t in torch.argmax(logits, dim=-1).tolist()]
        t1 = time.perf_counter()
        for i in range(steps):
            logits, caches, n = T.decode_step(params, caches, n, cfg,
                                              embeds=frames[:, prompt + i])
            nonfinite += (~torch.isfinite(logits)).sum()
            for out, t in zip(outs, torch.argmax(logits, dim=-1).tolist()):
                out.append(t)
        t2 = time.perf_counter()
    return dict(enumerate(outs)), {
        "prefill_seconds": t1 - t0, "decode_seconds": t2 - t1,
        "decode_steps": steps, "batches": 1,
        "nonfinite_logits": int(nonfinite)}


def f3a_phase(dev, smi, counts, arch, layers, n_params, f32_layers,
              profile_repeats: int = 0):
    """Phase 16 (a)-(c): one model of ``F3A_MODELS`` at full width on the
    card: served (8 requests of 2048 tokens, batch 4, 32 greedy tokens,
    through ``serve_requests``; the embeddings frontend one batch of 4 x
    2048 frames then 32 decode steps on frames), K7 once per layer of each
    prefill and nothing else launched, every logit finite; then the
    drop-free continuation at batch 1 on a 512-token prompt: decode after
    the prefill against the (P + 1)-token prefill in bf16, MLA's absorbed
    decode against the expanded one, and the same in float32 on the first
    ``f32_layers`` layers.  With ``profile_repeats``, that many more timed
    serving runs and one under ``torch.profiler`` (a ``profile`` line).
    Frees the model; returns its line's fields."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import serve_requests
    from repro_torch.models import moe
    from repro_torch.models import transformer as T

    reset, read = counts
    full = get_config(arch)
    cfg = full if layers is None else dataclasses.replace(full,
                                                          num_layers=layers)
    check(T.count_params(cfg) == n_params,
          f"{arch} params {T.count_params(cfg)}")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = T.init_params(cfg, seed=SEED, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    gen = torch.Generator(device=dev).manual_seed(SEED)
    frontend = cfg.frontend == "embeddings"
    if frontend:  # seeded normal frame embeddings, bf16
        inputs = torch.randn((SERVE_BATCH, SERVE_PROMPT + SERVE_NEW,
                              cfg.d_model), generator=gen, device=dev).to(
                                  torch.bfloat16)

        def run():
            return serve_frames(params, cfg, inputs, SERVE_PROMPT,
                                SERVE_NEW)

        serve_frames(params, cfg, inputs[:, :64], 32, 2)  # warm-up
    else:
        inputs = torch.randint(0, cfg.vocab_size,
                               (SERVE_REQUESTS, SERVE_PROMPT), generator=gen,
                               device=dev)

        def run():
            return serve_requests(params, cfg, inputs, SERVE_BATCH,
                                  SERVE_NEW)

        serve_requests(params, cfg, inputs[:SERVE_BATCH, :64], SERVE_BATCH,
                       2)  # warm-up
    torch.cuda.synchronize()
    reset()
    t0 = time.perf_counter()
    completed, stats = run()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = read()
    peak = torch.cuda.max_memory_allocated()
    want = {"flash_attention_kernel": stats["batches"] * cfg.num_layers}
    want.update({k: 0 for k in launches if k not in want})
    check(launches == want, f"{arch} launches {launches}: K7 once per "
          f"layer of each of {stats['batches']} prefills, nothing else")
    check(stats["nonfinite_logits"] == 0,
          f"{arch}: {stats['nonfinite_logits']} non-finite logits")
    tokens = sum(len(v) for v in completed.values())
    prefill_tokens = stats["batches"] * SERVE_BATCH * SERVE_PROMPT
    if profile_repeats:  # a round is one batch: its prefill and decode
        print(json.dumps({"profile": profile_run(
            run, lambda r: r[1]["batches"], f"serve {arch}",
            profile_repeats, categories=F3A_CATEGORIES), "card": smi}))

    # the continuation, drop-free, at batch 1
    P = F3A_CONT_PROMPT
    ext = {"capacity_factor": float(cfg.moe_num_experts)} \
        if cfg.moe_num_experts else {}
    if frontend:
        seq = {"embeds": inputs[:1, :P + 1]}
    else:
        seq = {"tokens": inputs[:1, :P + 1]}

    def continuation(p, c):
        """(decode after a P-step prefill, MLA's absorbed decode there or
        None, the last logits of a (P + 1)-step prefill, all float32; the
        MoE layers, counted from 0, whose top-k experts for the continued
        token differ between the decode and the prefill)."""
        c = dataclasses.replace(c, **ext)
        pre = {k: v[:, :P] for k, v in seq.items()}
        step = {k: v[:, P] for k, v in seq.items()}
        route, now = moe._route, [None]
        dec_picks, ref_picks = [], []

        def logged(x, w, k):  # each MoE layer's experts for the last token
            out = route(x, w, k)
            if now[0] is not None:
                now[0].append(out[1][-1])
            return out

        moe._route = logged
        try:
            with torch.inference_mode():
                _, caches, n = T.prefill(p, c, cache_len=P + 1, **pre)
                now[0] = dec_picks
                dec, _, _ = T.decode_step(p, caches, n, c, **step)
                now[0] = None
                absorbed = None
                if c.attention == "mla":  # rewrites slot P alike
                    absorbed, _, _ = T.decode_step(
                        p, caches, n,
                        dataclasses.replace(c, mla_absorb=True), **step)
                    absorbed = absorbed.float()
                del caches
                now[0] = ref_picks
                ref, _, _ = T.prefill(p, c, **seq)
        finally:
            moe._route = route
        flips = [i for i, (a, b) in enumerate(zip(dec_picks, ref_picks))
                 if set(a.tolist()) != set(b.tolist())]
        return dec.float(), absorbed, ref.float(), flips

    dec, absorbed, ref, flips = continuation(params, cfg)
    # float32: the whole model where it fits the card (converted leaf by
    # leaf in place, the largest first, each bf16 leaf freed as its copy
    # is made: the peak is the float32 model plus the last, smallest
    # leaf), else the first f32_layers layers
    n32 = f32_layers or cfg.num_layers
    if n32 == cfg.num_layers:
        p32, cfg32 = to_float32_in_place(params, cfg)
    else:
        p32, cfg32 = cut_layers(params, cfg, n32, torch.float32)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    dec32, absorbed32, ref32, flips32 = continuation(p32, cfg32)
    del p32
    gc.collect()
    torch.cuda.empty_cache()
    scale, scale32 = float(ref.abs().max()), float(ref32.abs().max())
    cont_err = float((dec - ref).abs().max())
    cont32_err = float((dec32 - ref32).abs().max())
    # bf16's own noise: the bf16 prefill against the float32 prefill of
    # the same weights (whole-model float32 only)
    noise = float((ref - ref32).abs().max()) if n32 == cfg.num_layers \
        else None
    bf16_bound = max(CONT_TOL * scale, 2 * (noise or 0.0))
    out = {
        "arch": full.name, "num_layers": cfg.num_layers,
        "reduced": ({"num_layers": f"{cfg.num_layers} of {full.num_layers}"}
                    if layers is not None else {}),
        "params": n_params, "params_full_depth": T.count_params(full),
        "frontend": cfg.frontend, "batch": SERVE_BATCH,
        "requests": stats["batches"] * SERVE_BATCH if frontend
        else SERVE_REQUESTS,
        "prompt_len": SERVE_PROMPT, "new_tokens": SERVE_NEW,
        "seconds": secs, "prefill_seconds": stats["prefill_seconds"],
        "prefill_tokens_per_second": prefill_tokens
        / stats["prefill_seconds"],
        "decode_steps": stats["decode_steps"],
        "decode_ms_per_step": stats["decode_seconds"]
        / stats["decode_steps"] * 1e3,
        "tokens_generated": tokens, "launches": launches,
        "continuation_prompt": P, "continuation_capacity_factor":
        ext.get("capacity_factor"),
        "continuation_max_abs_err": cont_err,
        "continuation_max_abs_logit": scale,
        "continuation_f32_layers": n32,
        "continuation_f32_max_abs_err": cont32_err,
        "continuation_f32_max_abs_logit": scale32,
        "continuation_argmax_agreement": float(
            (dec.argmax(-1) == ref.argmax(-1)).float().mean()),
        "continuation_bf16_bound": bf16_bound,
        "bf16_vs_f32_prefill_max_abs_err": noise,
        "continuation_moe_layers_rerouted": flips,
        "continuation_f32_moe_layers_rerouted": flips32,
        "init_params_seconds": init_s, "peak_bytes_allocated": peak,
        "card": smi,
    }
    if absorbed is not None:
        out.update(
            absorbed_vs_expanded_max_abs_err=float(
                (absorbed - dec).abs().max()),
            absorbed_vs_expanded_f32_max_abs_err=float(
                (absorbed32 - dec32).abs().max()))
    if not frontend:
        out["sample_output"] = completed[0][:8]
    print(json.dumps({"serve_f3a": out}))  # before its checks
    check(cont32_err <= CONT_TOL_F32 * scale32,
          f"{arch} float32 continuation: max|decode - prefill| "
          f"{cont32_err} (max|logit| {scale32})")
    check(cont_err <= bf16_bound,
          f"{arch} continuation: max|decode - prefill| {cont_err} "
          f"(max|logit| {scale}, bf16 vs float32 prefill {noise})")
    if absorbed is not None:
        check(out["absorbed_vs_expanded_max_abs_err"] <= bf16_bound,
              f"{arch} absorbed vs expanded decode {out}")
        check(out["absorbed_vs_expanded_f32_max_abs_err"]
              <= CONT_TOL_F32 * scale32,
              f"{arch} float32 absorbed vs expanded decode {out}")
    return out


def _recurrent_layer(cfg, kind, gen):
    """Seeded float32 leaves of one block's mixer (and RWKV6's channel
    mix) on the CPU: token-shift mixes in [0, 1], decay logits around -1,
    RG-LRU's lambda the init's linspace, the rest normal, matrices scaled
    by fan_in**-0.5."""
    import torch
    from repro_torch.models import transformer as T

    out = {}
    for name, shape in sorted(T._block_param_shapes(cfg, kind).items()):
        if not name.startswith(("rwkv", "lru")):
            continue
        if name.startswith("rwkv_mu"):
            out[name] = torch.rand(shape, generator=gen)
        elif name == "rwkv_w0":
            out[name] = -1.0 + 0.5 * torch.randn(shape, generator=gen)
        elif name == "lru_lambda":
            out[name] = torch.linspace(1.0, 4.0, shape[0])
        elif len(shape) == 2:
            out[name] = torch.randn(shape, generator=gen) * shape[0] ** -0.5
        else:
            out[name] = 0.5 * torch.randn(shape, generator=gen)
    return out


def _kernel_count(fn) -> int:
    """CUDA kernels ``fn()`` launches (one ``torch.profiler`` run)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA)


def recurrent_check(dev):
    """Phase 17 (e): one RWKV6-3B layer (d 2560, 40 heads of 64, d_ff
    8960) and one RecurrentGemma-9B recurrent block (W 4096, conv 4) at B
    2, S 256 in float32, the card against the CPU on the same seeded
    inputs: ``rwkv6_mix`` per token and chunked (``rwkv_chunk`` 16),
    ``rwkv6_channelmix`` and ``rglru_block``, each output and final state
    within ``F3B_CHECK_TOL`` of its max on the CPU; the chunked form on
    the card within the same of the per-token one.  Then each loop alone
    at its serving shape (B 4, S 2048) on the card: ms a layer (CUDA
    events, 3 calls) and the kernels it launches (the profiler)."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import ssm

    f32 = "float32"
    gen = torch.Generator().manual_seed(SEED + 17)
    B, S_ = F3B_CHECK_B, F3B_CHECK_S
    out = {"B": B, "S": S_, "tol": F3B_CHECK_TOL}

    def held(what, card, cpu):
        err = float((card.cpu() - cpu).abs().max())
        scale = float(cpu.abs().max())
        out[what] = {"max_abs_err": err, "max_abs": scale}
        check(err <= F3B_CHECK_TOL * scale,
              f"{what}: card vs CPU {err} (max {scale})")

    def on(tree):
        return {n: t.to(dev) for n, t in tree.items()}

    cfg = dataclasses.replace(get_config("rwkv6_3b"), dtype_str=f32)
    p = _recurrent_layer(cfg, ("rwkv6", "channelmix"), gen)
    x = torch.randn((B, S_, cfg.d_model), generator=gen)
    pc, xc = on(p), x.to(dev)
    per_token = None
    for chunk in (0, F3B_CHECK_CHUNK):
        c = dataclasses.replace(cfg, rwkv_chunk=chunk)
        with torch.inference_mode():
            y_cpu, (st_cpu, _) = ssm.rwkv6_mix(p, x, c)
            y, (st, _) = ssm.rwkv6_mix(pc, xc, c)
        name = f"rwkv6_mix chunk {chunk}" if chunk else "rwkv6_mix"
        held(f"{name} y", y, y_cpu)
        held(f"{name} state", st, st_cpu)
        if per_token is None:
            per_token = (y.cpu(), st.cpu())
        else:  # the chunked form against the per-token one, both on card
            held("rwkv6_mix chunked vs per-token y", y, per_token[0])
            held("rwkv6_mix chunked vs per-token state", st, per_token[1])
    with torch.inference_mode():
        held("rwkv6_channelmix y", ssm.rwkv6_channelmix(pc, xc)[0],
             ssm.rwkv6_channelmix(p, x)[0])
    del p, pc
    cfg = dataclasses.replace(get_config("recurrentgemma_9b"), dtype_str=f32)
    p = _recurrent_layer(cfg, ("rglru", "dense"), gen)
    x = torch.randn((B, S_, cfg.d_model), generator=gen)
    with torch.inference_mode():
        y_cpu, (h_cpu, tail_cpu) = ssm.rglru_block(p, x, cfg)
        y, (h, tail) = ssm.rglru_block(on(p), x.to(dev), cfg)
    held("rglru_block y", y, y_cpu)
    held("rglru_block h", h, h_cpu)
    held("rglru_block conv tail", tail, tail_cpu)
    del p

    # the loops alone at the serving shape, the inputs the card's
    Bs, Ss = SERVE_BATCH, SERVE_PROMPT
    g = torch.Generator(device=dev).manual_seed(SEED + 17)
    rcfg = get_config("rwkv6_3b")
    H, D = rcfg.num_heads, rcfg.rwkv_head_dim
    rkv = [torch.randn((Bs, Ss, H, D), generator=g, device=dev)
           for _ in range(3)]
    w = torch.rand((Bs, Ss, H, D), generator=g, device=dev) * 0.5 + 0.5
    u = torch.randn((H, D), generator=g, device=dev)
    s0 = torch.zeros((Bs, H, D, D), device=dev)
    W = get_config("recurrentgemma_9b").lru_width
    a = torch.rand((Bs, Ss, W), generator=g, device=dev) * 0.5 + 0.5
    gx = torch.randn((Bs, Ss, W), generator=g, device=dev).to(
        torch.bfloat16)
    h0 = torch.zeros((Bs, W), device=dev)
    loops = {
        "rwkv6_recurrence": lambda: ssm._rwkv6_recurrence(*rkv, w, u, s0),
        "rglru_recurrence": lambda: ssm._rglru_recurrence(
            a, gx, h0, torch.bfloat16)}
    for name, fn in loops.items():
        with torch.inference_mode():
            fn()  # warm-up
            ms = []
            for _ in range(3):
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                fn()
                e1.record()
                e1.synchronize()
                ms.append(e0.elapsed_time(e1))
            out[f"{name} serving shape"] = {
                "B": Bs, "S": Ss, "ms_per_layer": statistics.median(ms),
                "kernels_per_layer": _kernel_count(fn)}
    del rkv, w, a, gx
    torch.cuda.empty_cache()
    return out


def f3b_phase(dev, smi, counts, arch, n_params, prompts,
              profile_repeats: int = 0):
    """Phase 17 (a)/(b): one recurrent model whole on the card (bf16 from
    ``SEED``), served at phase 10's traffic (8 requests of 2048 tokens,
    batch 4, 32 greedy tokens, through ``serve_requests``): K7 once per
    full-causal (local) layer of each prefill and nothing else, every
    logit finite; then the continuation at batch 1 for each P of
    ``prompts``: decode after a P-token prefill against the (P + 1)-token
    prefill's last logits, with the whole model converted to float32 in
    place within ``CONT_TOL_F32`` max|logits| and in bf16 within phase
    16's bound (the larger of ``CONT_TOL`` max|logits| and twice the bf16
    prefill's distance from the float32 prefill).  With
    ``profile_repeats``, that many timed serving runs of one batch and one
    under ``torch.profiler`` (a ``profile`` line).  Frees the model;
    returns its line's fields."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import serve_requests
    from repro_torch.models import transformer as T
    from repro_torch.models.config import block_kinds

    reset, read = counts
    cfg = get_config(arch)
    check(T.count_params(cfg) == n_params,
          f"{arch} params {T.count_params(cfg)}")
    local = sum(1 for m, _ in block_kinds(cfg) if m == "local")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = T.init_params(cfg, seed=SEED, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    gen = torch.Generator(device=dev).manual_seed(SEED)
    tokens = torch.randint(0, cfg.vocab_size, (
        SERVE_REQUESTS, max(SERVE_PROMPT, max(prompts) + 1)),
        generator=gen, device=dev)
    inputs = tokens[:, :SERVE_PROMPT]

    def run(rows=SERVE_REQUESTS):
        return serve_requests(params, cfg, inputs[:rows], SERVE_BATCH,
                              SERVE_NEW)

    serve_requests(params, cfg, inputs[:SERVE_BATCH, :64], SERVE_BATCH,
                   2)  # warm-up
    torch.cuda.synchronize()
    reset()
    t0 = time.perf_counter()
    completed, stats = run()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = read()
    peak = torch.cuda.max_memory_allocated()
    want = {"flash_attention_kernel": stats["batches"] * local}
    want.update({k: 0 for k in launches if k not in want})
    check(launches == want, f"{arch} launches {launches}: K7 once per "
          f"local layer ({local}) of each of {stats['batches']} prefills, "
          "nothing else")
    check(stats["nonfinite_logits"] == 0,
          f"{arch}: {stats['nonfinite_logits']} non-finite logits")
    prefill_tokens = stats["batches"] * SERVE_BATCH * SERVE_PROMPT
    if profile_repeats:  # one batch: its prefill and decode
        print(json.dumps({"profile": profile_run(
            lambda: run(SERVE_BATCH), lambda r: r[1]["batches"],
            f"serve {arch}", profile_repeats, categories=F3B_CATEGORIES),
            "card": smi}))

    def continuation(p, c, P):
        """(decode after a P-token prefill, the last logits of a (P +
        1)-token prefill), float32, at batch 1."""
        seq = tokens[:1, :P + 1]
        with torch.inference_mode():
            _, caches, n = T.prefill(p, c, seq[:, :P], cache_len=P + 1)
            dec, _, _ = T.decode_step(p, caches, n, c, seq[:, P])
            del caches
            ref, _, _ = T.prefill(p, c, seq)
        return dec.float(), ref.float()

    bf16 = {P: continuation(params, cfg, P) for P in prompts}
    p32, cfg32 = to_float32_in_place(params, cfg)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    f32 = {P: continuation(p32, cfg32, P) for P in prompts}
    del p32
    gc.collect()
    torch.cuda.empty_cache()
    cont = {}
    for P in prompts:
        (dec, ref), (dec32, ref32) = bf16[P], f32[P]
        noise = float((ref - ref32).abs().max())
        cont[P] = {
            "max_abs_err": float((dec - ref).abs().max()),
            "max_abs_logit": float(ref.abs().max()),
            "f32_max_abs_err": float((dec32 - ref32).abs().max()),
            "f32_max_abs_logit": float(ref32.abs().max()),
            "bf16_vs_f32_prefill_max_abs_err": noise,
            # phase 16's rule: the bf16 layers move the prefill's logits
            # 26% (RWKV6-3B) and 5-6% (RecurrentGemma-9B) from the float32
            # prefill's; decode vs prefill read 2.0% and 3.5-3.9% in bf16
            # where float32 holds 1.6e-5 at most
            "bf16_bound": max(CONT_TOL * float(ref.abs().max()), 2 * noise),
            "argmax_agreement": float(
                (dec.argmax(-1) == ref.argmax(-1)).float().mean()),
            "past_window": bool(cfg.window and P > cfg.window)}
    out = {
        "arch": cfg.name, "num_layers": cfg.num_layers, "reduced": {},
        "params": n_params, "local_attention_layers": local,
        "batch": SERVE_BATCH, "requests": SERVE_REQUESTS,
        "prompt_len": SERVE_PROMPT, "new_tokens": SERVE_NEW,
        "seconds": secs, "prefill_seconds": stats["prefill_seconds"],
        "prefill_tokens_per_second": prefill_tokens
        / stats["prefill_seconds"],
        "decode_steps": stats["decode_steps"],
        "decode_ms_per_step": stats["decode_seconds"]
        / stats["decode_steps"] * 1e3,
        "tokens_generated": sum(len(v) for v in completed.values()),
        "launches": launches, "continuation": cont,
        "init_params_seconds": init_s, "peak_bytes_allocated": peak,
        "sample_output": completed[0][:8], "card": smi,
    }
    print(json.dumps({"serve_f3b": out}))  # before its checks
    for P, c in cont.items():
        check(c["f32_max_abs_err"] <= CONT_TOL_F32 * c["f32_max_abs_logit"],
              f"{arch} float32 continuation at P {P}: {c}")
        check(c["max_abs_err"] <= c["bf16_bound"],
              f"{arch} bf16 continuation at P {P}: {c}")
    return out


def check_k8(dev, cases=K8_CASES, timed_names=("training",) + FLASH_TIMED):
    """K8a and K8b against their plain versions on the card at the shapes
    of ``cases``, from K7's statistics; returns (the largest |dq|, |dk|,
    |dv| error over them, the (q, k, v, do, m, linv, delta) of the shapes
    in ``timed_names`` by name, for timing).  A case's "v128" zeroes V and
    do past MLA's 128 columns, as ``attend``'s padding leaves them."""
    import torch
    from repro_torch.kernels.flash_attention import flash_attention_kernel
    from repro_torch.kernels.flash_attention_bwd import flash_dkdv_kernel, \
        flash_dkdv_plain, flash_dq_kernel, flash_dq_plain

    gen = torch.Generator(device=dev).manual_seed(SEED + 8)
    err, timed = 0.0, {}
    for name, B, S_, H, KVH, Dh, dt, how in cases:
        dtype = getattr(torch, dt)
        q, k, v, do = (torch.randn((B, S_, n, Dh), generator=gen,
                                   device=dev) for n in (H, KVH, KVH, H))
        if how == "v128":
            v[..., MLA_DV:] = 0.0
            do[..., MLA_DV:] = 0.0
        shape_q(q, how)
        q, k, v, do = (t.to(dtype) for t in (q, k, v, do))
        with torch.no_grad():
            o, m, l = flash_attention_kernel(q, k, v)
        delta = (do.float() * o.float()).sum(-1).transpose(1, 2) \
            .contiguous()
        args = (q, k, v, do, m, 1.0 / torch.clamp(l, min=1e-30), delta)
        got = (flash_dq_kernel(*args), *flash_dkdv_kernel(*args))
        want = (flash_dq_plain(*args), *flash_dkdv_plain(*args))
        for what, g, w in zip(("dq", "dk", "dv"), got, want):
            d = (g.float() - w.float()).abs()
            if dt == "float32":
                scale = max(float(w.abs().max()), float(do.abs().max()))
                check(float(d.max()) <= K8_F32_TOL * scale,
                      f"K8 {name} {what} err {float(d.max())}")
            else:
                atol, rtol = K7_TOL[dt]
                check(bool((d <= atol + rtol * w.float().abs()).all()),
                      f"K8 {name} {what} err {float(d.max())}")
            err = max(err, float(d.max()))
        if name in timed_names:
            timed[name] = args
        del got, want
    torch.cuda.synchronize()
    return err, timed


def k7_timing(args, dv=None):
    """Phase 12's K7 row on one shape's (q, k, v): the kernel, its plain
    version, SDPA on the same tensors heads first (copied outside the
    timing) and the bound: q, k, v read once, o written, m and l
    (float32); the causal half, each allowed (query, key) pair 2 D for
    q.k and 2 D for p v, at the bf16 tensor-core peak.  With ``dv`` (MLA:
    V zero-padded from dv columns to D) the bound and SDPA count the
    function's own work: V read and o written at dv columns, 2 D + 2 dv
    a pair."""
    import torch
    from repro_torch.kernels import work
    from repro_torch.kernels.flash_attention import flash_attention_kernel, \
        flash_attention_plain

    q, k, v = args
    b, s, h, d = q.shape
    kvh = k.shape[2]
    qt, kt, vt = (t.transpose(1, 2).contiguous()
                  for t in (q, k, v[..., :dv or d]))
    return dict(
        run=lambda: flash_attention_kernel(q, k, v),
        plain=lambda: flash_attention_plain(q, k, v),
        library=lambda: torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True),
        bound=bound(work.k7_flash(b, s, h, kvh, d, q.element_size(), dv)))


def k6_timing(X, w):
    """Phase 12's K6 row on one (X, w) float32 pair: the kernel, its plain
    version, ``torch.matmul`` of (X w)^T and X, and the bound: X and w read
    once, H written; the symmetric Gram as three TF32 products."""
    import torch
    from repro_torch.kernels import work
    from repro_torch.kernels.fused_irls import gram_hessian_kernel, \
        gram_hessian_plain

    return dict(
        run=lambda: gram_hessian_kernel(X, w),
        plain=lambda: gram_hessian_plain(X, w),
        library=lambda: torch.matmul((X * w[:, None]).T, X),
        bound=bound(work.k6_gram_hessian(*X.shape)))


def k8_timing(args, dv=None):
    """Phase 12's K8a and K8b rows on one shape's (q, k, v, do, m, linv,
    delta), with SDPA's backward on the same tensors heads first as the
    one library call for both (its forward runs once, outside the
    timing).  Bounds: q, k, v, do (input dtype) and m, linv, delta
    (float32) read once, the outputs written; per allowed pair K8a 6 D
    (q.k, do.v, ds k), K8b 8 D (q.k, do.v, p do, ds q) at the bf16
    tensor-core peak.  With ``dv`` (MLA: V and do zero past dv columns)
    the bounds and SDPA count the function's own work: v, do and dv at dv
    columns, K8a 4 D + 2 dv and K8b 4 D + 4 dv a pair."""
    import torch
    from repro_torch.kernels import work
    from repro_torch.kernels.flash_attention_bwd import flash_dkdv_kernel, \
        flash_dkdv_plain, flash_dq_kernel, flash_dq_plain

    q, k, v, do = args[:4]
    b, s, h, d = q.shape
    dims = (b, s, h, k.shape[2], d, q.element_size(), dv)
    qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_(True)
                  for t in (q, k, v[..., :dv or d]))
    dot = do[..., :dv or d].transpose(1, 2).contiguous()
    ot = torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True)

    def sdpa_backward():
        return torch.autograd.grad(ot, (qt, kt, vt), dot, retain_graph=True)
    return {
        "K8a": dict(run=lambda: flash_dq_kernel(*args),
                    plain=lambda: flash_dq_plain(*args),
                    library=sdpa_backward,
                    bound=bound(work.k8a_flash_dq(*dims))),
        "K8b": dict(run=lambda: flash_dkdv_kernel(*args),
                    plain=lambda: flash_dkdv_plain(*args),
                    library=sdpa_backward,
                    bound=bound(work.k8b_flash_dkdv(*dims))),
    }


def ptxas_report(log_text: str, names) -> list:
    """Registers, spill bytes, stack frame (local memory) and static
    shared memory of each kernel of the build's ptxas report (``-Xptxas
    -v``) whose mangled name matches a pattern of ``names``: (pattern,
    describe), where ``describe(match)`` gives the row's label and the
    dynamic shared memory a launch asks for."""
    import re

    out, cur = [], None
    for ln in log_text.splitlines():
        m = re.search(r"entry function '(\w+)'", ln)
        if m:
            cur = None
            for pat, describe in names:
                hit = re.search(pat, m.group(1))
                if hit:
                    label, smem = describe(hit)
                    cur = {"kernel": label, "registers": None,
                           "spill_stores": None, "spill_loads": None,
                           "stack_frame": None,
                           "smem_static": 0, "smem_dynamic": smem}
                    out.append(cur)
                    break
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m:
            cur["spill_stores"], cur["spill_loads"] = map(int, m.groups())
            m = re.search(r"(\d+) bytes stack frame", ln)
            cur["stack_frame"] = int(m.group(1)) if m else 0
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            cur["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", ln)
            cur["smem_static"] = int(m.group(1)) if m else 0
    return out


def flash_ptxas(log_text: str, lib) -> list:
    """Each flash kernel's ptxas row, with the dynamic bytes a launch at
    the instantiation's largest head dim asks for (``repro_k7_smem_bytes``
    / ``repro_k8_smem_bytes``).  The template argument is the tensor-core
    kernels' head dim and the CUDA-core kernels' columns a thread (16
    each)."""
    def named(label, smem):
        def describe(hit):
            n = int(hit.group(1))
            d = n if "tensor" in label else 16 * n
            return f"{label}, D <= {d}", smem(d)
        return describe

    return ptxas_report(log_text, (  # mangled prefix -> row
        (r"flash_fwd_bf16_kernelILi(\d+)E", named(
            "K7 bf16 tensor cores", lambda d: lib.repro_k7_smem_bytes(d, 1))),
        (r"flash_attention_fwd_kernelILi(\d+)E", named(
            "K7 f32 CUDA cores", lambda d: lib.repro_k7_smem_bytes(d, 0))),
        (r"flash_dq_bf16_kernelILi(\d+)E", named(
            "K8a bf16 tensor cores",
            lambda d: lib.repro_k8_smem_bytes(0, d, 1))),
        (r"flash_dq_kernelILi\d+ELi(\d+)E", named(
            "K8a f32 CUDA cores",
            lambda d: lib.repro_k8_smem_bytes(0, d, 0))),
        (r"flash_dkdv_bf16_kernelILi(\d+)E", named(
            "K8b bf16 tensor cores",
            lambda d: lib.repro_k8_smem_bytes(1, d, 1))),
        (r"flash_dkdv_kernelILi\d+ELi(\d+)E", named(
            "K8b f32 CUDA cores",
            lambda d: lib.repro_k8_smem_bytes(1, d, 0))),
    ))


def irls_ptxas(log_text: str, lib) -> dict:
    """The IRLS kernels' instantiations' ptxas rows (K3, K5 and K6 wrap
    the bodies of ``csrc/irls_tc.cuh`` in kernels of their own names), and
    what each entry's plan gives at the path's d: configurations a rows
    block, the rows and Gram kernels' tile rows, the Gram units a
    configuration and blocks an SM."""
    import ctypes

    plans = {}
    for k in ("k3", "k5", "k6"):
        out = (ctypes.c_int * 5)()
        check(getattr(lib, f"repro_{k}_plan")(D, out) == 0,
              f"repro_{k}_plan")
        plans[k.upper()] = dict(zip(
            ("configs_per_rows_block", "rows_tile_rows", "gram_tile_rows",
             "gram_units", "gram_blocks_per_sm"), out))
    rows = ptxas_report(log_text, tuple(
        pat for name, prefix in (("K5", "irls_cv_"), ("K3", "k3_"),
                                 ("K6", "k6_"))
        for pat in (
            (rf"{prefix}rows_kernelILi(\d+)E", lambda h, n=name: (
                f"{n} rows (float64 mma), {h.group(1)} column tiles a warp",
                None)),
            (rf"{prefix}gram_kernelILi(\d+)E", lambda h, n=name: (
                f"{n} Gram (3xTF32 wgmma), {h.group(1)}-row tiles", None)),
            (rf"{prefix}reduce_kernel", lambda h, n=name: (
                f"{n} reduce", 0)))))
    return {"kernels": rows, "d": D, "plans": plans}


# K1's instantiations (payload dtype; the struct or the table path), K2's
# (the struct or the table path) and K4
SHAMIR_KERNELS = (r"(encode_share_kernel|reconstruct_kernel"
                  r"|leafwise_share_kernel)(I([df])?Lb([01])E)?")


def _shamir_label(hit) -> str:
    if hit.group(1) == "leafwise_share_kernel":
        return "K4"
    path = "" if hit.group(4) is None else \
        (" table path" if hit.group(4) == "1" else " struct path")
    if hit.group(1) == "reconstruct_kernel":
        return "K2" + path
    payload = "" if hit.group(3) is None else \
        f" {'f64' if hit.group(3) == 'd' else 'f32'} payload"
    return "K1" + payload + path


def shamir_sass(lib_path) -> dict:
    """The emulated-division instructions in each K1, K2 and K4 kernel of
    a built library's SASS (``cuobjdump -sass``), by kernel: ``MUFU.RCP*``
    (the reciprocal a 64-bit integer remainder and a float64 division
    start from) and ``CALL`` (the call to their slow-path routine), beside
    the kernel's instruction count."""
    import re

    from repro_torch.kernels import _build

    tool = pathlib.Path(_build._nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(tool), "-sass", str(lib_path)],
                          capture_output=True, text=True, check=True).stdout
    out, cur = {}, None
    for ln in text.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            hit = re.search(SHAMIR_KERNELS, m.group(1))
            cur = out.setdefault(_shamir_label(hit), {
                "instructions": 0, "mufu_rcp": 0, "calls": 0}) if hit \
                else None
            continue
        if cur is None or not re.search(r"/\*[0-9a-f]{4,}\*/\s+\S", ln):
            continue
        cur["instructions"] += 1
        cur["mufu_rcp"] += "MUFU.RCP" in ln
        cur["calls"] += bool(re.search(r"\bCALL\b", ln))
    return out


def shamir_ptxas(log_text: str, lib_path) -> dict:
    """K1's, K2's and K4's instantiations: ptxas registers and spills, and
    the emulated-division instructions in their SASS."""
    rows = ptxas_report(log_text, (
        (SHAMIR_KERNELS, lambda h: (_shamir_label(h), 0)),))
    return {"kernels": rows, "division_sass": shamir_sass(lib_path)}


def train_config(arch, layers, dtype_str=None):
    """(``arch``'s full config, the one trained here: its first ``layers``
    layers (None: all), in ``dtype_str`` (None: its own), RWKV6 in its
    chunked form at ``F4_RWKV_CHUNK``)."""
    import dataclasses

    from repro_torch.configs import get_config

    full = get_config(arch)
    cut = {"num_layers": layers} if layers is not None else {}
    if dtype_str:
        cut["dtype_str"] = dtype_str
    if full.mixer == "rwkv6":
        cut["rwkv_chunk"] = F4_RWKV_CHUNK
    return full, dataclasses.replace(full, **cut)


def k7_layers(cfg, seq: int) -> int:
    """Layers whose attention runs K7 on a ``seq``-token sequence: the
    full-causal and MLA ones, and the windowed ones whose window covers
    it."""
    from repro_torch.models.config import block_kinds

    return sum(1 for m, _ in block_kinds(cfg)
               if m in ("full", "mla") or (m in ("swa", "local") and (
                   not cfg.window or cfg.window >= seq)))


def grad_check(dev, arch=TRAIN_ARCH, layers=TRAIN_LAYERS,
               n_params=TRAIN_PARAMS, steps=(GRAD_H,)):
    """Phase 13b (and 18 (b)): float32 ``loss_fn`` of ``arch`` at full
    width (``layers`` layers, remat on), one sequence of 2048 tokens (or
    frames): the central difference along u = g / |g| at each step h of
    ``steps``, the last one held against |g|.  The parameters are moved
    in place (to +h u, then -h u, for each h) and dropped afterwards."""
    import torch
    from repro_torch.core.flatbuf import tree_flatten
    from repro_torch.launch.train import _loss_and_grads, corpus_batch
    from repro_torch.models import transformer as T

    _, cfg = train_config(arch, layers, "float32")
    check(cfg.remat and T.count_params(cfg) == n_params,
          f"grad-check config: remat {cfg.remat}, params "
          f"{T.count_params(cfg)}")
    params = T.init_params(cfg, seed=SEED, device=dev)
    batch = corpus_batch(SEED, 0, 1, TRAIN_SEQ, cfg.vocab_size, dev,
                         cfg.d_model if cfg.frontend == "embeddings" else 0)
    t0 = time.perf_counter()
    loss0, grads = _loss_and_grads(params, batch, cfg)
    torch.cuda.synchronize()
    grad_s = time.perf_counter() - t0
    gnorm = float(sum((g * g).sum(dtype=torch.float64)
                      for g in grads)) ** 0.5
    leaves = tree_flatten(params)[0]
    for g in grads:
        g.div_(gnorm)  # g is now u
    at = 0.0  # where the parameters are now, along u

    def loss_at(x: float) -> float:
        nonlocal at
        for p, u in zip(leaves, grads):
            p.add_(u, alpha=x - at)
        at = x
        with torch.no_grad():
            return float(T.loss_fn(params, batch, cfg)[0])

    sweep = []
    for h in steps:
        f_plus, f_minus = loss_at(h), loss_at(-h)
        fd = (f_plus - f_minus) / (2 * h)
        sweep.append({"h": h, "f_plus": f_plus, "f_minus": f_minus,
                      "central_difference": fd,
                      "rel_err": abs(fd - gnorm) / gnorm})
    last = sweep[-1]
    check(all(map(math.isfinite, [loss0, gnorm] + [
        c[k] for c in sweep for k in ("f_plus", "f_minus")])),
          "grad check finite")
    check(last["rel_err"] <= GRAD_TOL,
          f"{arch} directional derivative {last['central_difference']} vs "
          f"|g| {gnorm} at h {last['h']} (rel {last['rel_err']})")
    del params, grads, leaves
    torch.cuda.empty_cache()
    return {"arch": arch, "num_layers": cfg.num_layers, "params": n_params,
            "rwkv_chunk": cfg.rwkv_chunk, "loss": loss0, "grad_norm": gnorm,
            **last, "steps": sweep if len(sweep) > 1 else None,
            "grad_seconds": grad_s}


def secure_phase(dev, counts, arch=TRAIN_ARCH):
    """Phase 13d (and 18 (c)): ``run_lm`` with Shamir gradient aggregation
    at ``arch``'s smoke config; then the step-0 secure mean against the
    plain one."""
    import torch
    from repro_torch.configs import smoke_config
    from repro_torch.core.collective import SecureCollective
    from repro_torch.core.flatbuf import tree_flatten
    from repro_torch.launch import train
    from repro_torch.models import transformer as T

    reset, read = counts
    cfg = smoke_config(arch)
    argv = ["--arch", arch] + SECURE_ARGV[2:]
    args = train.parse_args(argv + ["--device", str(dev)])
    S_ = args.institutions
    reset()
    rep = train.run_lm(args)
    torch.cuda.synchronize()
    launches = read()
    n = T.count_params(cfg)
    rows = math.ceil(math.ceil(n / 128) / 8) * 8  # 128 lanes, rows in 8s
    agg = SecureCollective(backend="kernel", overflow_check=True)
    w, r = agg.scheme.num_shares, agg.scheme.field.num_residues
    want_bytes = S_ * w * r * rows * 128 * 4
    check(rep["loss_last"] < rep["loss_first"],
          f"secure loss {rep['loss_first']} -> {rep['loss_last']}")
    check(rep["bytes_per_step"] == [want_bytes] * args.steps,
          f"secure bytes per step {rep['bytes_per_step']} != {want_bytes}")
    # smoke config: no remat
    L = k7_layers(cfg, args.seq_len) * S_ * args.steps
    want = {"encode_share_kernel": args.steps,
            "reconstruct_kernel": args.steps,
            "flash_attention_kernel": L, "flash_dq_kernel": L,
            "flash_dkdv_kernel": L}
    want.update({k: 0 for k in launches if k not in want})
    check(launches == want, f"secure training launches {launches}")
    # step 0 again: the secure mean against the plain mean
    params = T.init_params(cfg, seed=args.seed, device=dev)
    b = train.corpus_batch(args.seed, 0, args.batch, args.seq_len,
                           cfg.vocab_size, dev,
                           cfg.d_model if cfg.frontend == "embeddings" else 0)
    per = args.batch // S_
    insts = [{k: v[j * per:(j + 1) * per] for k, v in b.items()}
             for j in range(S_)]
    _, plain, _ = train.mean_gradients(params, insts, cfg)
    _, secure, nbytes = train.mean_gradients(
        params, insts, cfg, agg, SecureCollective.round_key(args.seed, 0,
                                                            dev))
    err = max(float((a - p).abs().max()) for a, p in
              zip(tree_flatten(secure)[0], tree_flatten(plain)[0]))
    check(err <= S_ * 2.0**-FRAC_BITS, f"secure vs plain mean grads {err}")
    check(nbytes == want_bytes, f"step-0 bytes {nbytes}")
    return {"arch": cfg.name, "config": "smoke", "params": n,
            "argv": argv, "losses": rep["losses"],
            "loss_first": rep["loss_first"], "loss_last": rep["loss_last"],
            "bytes_per_step": want_bytes, "launches": launches,
            "step0_secure_vs_plain_max_abs": err,
            "quantization_bound": S_ * 2.0**-FRAC_BITS,
            "seconds": rep["seconds"],
            "reduced": "smoke config: the int32 shares of the full-width "
                       "2-layer model would take 24 B a parameter per "
                       "institution (122 GB for two)"}


def moe_grad_check(dev, arch):
    """Phase 18 (b): ``moe_ffn``'s backward at ``arch``'s full width (its
    shared experts too), T = TRAIN_SEQ tokens, in float32 on the card
    against the CPU on the same inputs: the gradients of sum(y c) + aux
    (c a seeded cotangent) for x, the router and every expert and shared
    leaf.  x and the router on a grid (multiples of 1/8 and 1/64), so the
    router's logits are exact: the expert ids, queue positions, kept slots
    and drops must be equal, and each gradient within ``MOE_CHECK_TOL``
    of its max on the CPU."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import moe
    from repro_torch.models import transformer as T

    cfg = get_config(arch)
    d, E, k = cfg.d_model, cfg.moe_num_experts, cfg.moe_top_k
    capacity = max(1, int(TRAIN_SEQ * k * cfg.capacity_factor / E))
    gen = torch.Generator(device=dev).manual_seed(SEED + 18)
    mixer = "mla" if cfg.attention == "mla" else "full"
    shapes = {n: sh for n, sh in
              T._block_param_shapes(cfg, (mixer, "moe")).items()
              if n == "router" or n.startswith(("experts_", "shared_"))}
    card = {"x": torch.randint(-8, 9, (1, TRAIN_SEQ, d), generator=gen,
                               device=dev) / 8.0,
            "router": torch.randint(-8, 9, shapes.pop("router"),
                                    generator=gen, device=dev) / 64.0}
    for name, shape in sorted(shapes.items()):
        card[name] = min(0.02, shape[-2] ** -0.5) * torch.randn(
            shape, generator=gen, device=dev)
    cot = torch.randn((1, TRAIN_SEQ, d), generator=gen, device=dev)
    host = {n: t.cpu() for n, t in card.items()}

    def grads(tree, c):
        names = sorted(tree)
        req = {n: tree[n].detach().requires_grad_(True) for n in names}
        x = req.pop("x")
        y, aux, drop = moe.moe_ffn(x, req, cfg)
        g = torch.autograd.grad((y * c).sum() + aux,
                                [x] + [req[n] for n in names if n != "x"])
        return drop, dict(zip(["x"] + [n for n in names if n != "x"], g))

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    drop, got = grads(card, cot)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    drop_cpu, want = grads(host, cot.cpu())
    cpu_s = time.perf_counter() - t0
    check_routing(f"{arch} moe_ffn backward", (card["x"], card["router"]),
                  (host["x"], host["router"]), k, capacity)
    check(float(drop) == float(drop_cpu),
          f"{arch} moe_ffn drop fraction {float(drop)} vs {float(drop_cpu)}")
    out = {"arch": arch, "T": TRAIN_SEQ, "d_model": d, "experts": E,
           "top_k": k, "d_ff": cfg.moe_d_ff, "shared": cfg.moe_num_shared,
           "capacity": capacity, "dropped_fraction": float(drop),
           "tol": MOE_CHECK_TOL, "grads": {},
           "card_seconds_first_call": card_s, "cpu_seconds": cpu_s}
    for name, w in want.items():
        scale = float(w.abs().max())
        err = float((got[name].cpu() - w).abs().max())
        out["grads"][name] = {"max_abs_err": err, "max_abs": scale}
        check(scale > 0.0 and err <= MOE_CHECK_TOL * scale,
              f"{arch} moe_ffn d{name} card vs CPU {err} (max {scale})")
    del card, host, got, want
    torch.cuda.empty_cache()
    return out


def training_phase(dev, smi, counts, arch=TRAIN_ARCH, layers=TRAIN_LAYERS,
                   n_params=TRAIN_PARAMS, steps=TRAIN_STEPS):
    """Phase 13c (and 18 (a)): ``steps`` bf16 ``train_step`` calls of
    ``arch`` at full width (``layers`` layers, remat on), 2 institutions
    of one 2048-token sequence (or frames) each, lr 3e-4 with run_lm's
    warm-up over half the run: every loss and grad norm finite, each step
    K7 twice per K7 layer and institution (forward, remat), K8a and K8b
    once, nothing else, and every weight matrix moved.  Returns (the
    ``train`` line's fields, one more step for --profile, the AdamW
    update alone for --profile); the model lives until both are freed."""
    import torch
    from repro_torch.launch.train import corpus_batch, mean_gradients, \
        train_step
    from repro_torch.models import transformer as T
    from repro_torch.optim import AdamWConfig, adamw_init, adamw_update

    reset, read = counts
    full, cfg = train_config(arch, layers)
    check(cfg.remat and cfg.dtype == torch.bfloat16
          and T.count_params(cfg) == n_params,
          f"{arch} training config: params {T.count_params(cfg)}")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = T.init_params(cfg, seed=SEED, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    # run_lm's schedule: warm-up over half the run
    opt = AdamWConfig(lr=TRAIN_LR, warmup_steps=max(1, steps // 2))
    state = adamw_init(params)
    per = TRAIN_BATCH // TRAIN_INST
    embed_dim = cfg.d_model if cfg.frontend == "embeddings" else 0

    def insts(step):
        b = corpus_batch(SEED, step, TRAIN_BATCH, TRAIN_SEQ, cfg.vocab_size,
                         dev, embed_dim)
        return [{k: v[j * per:(j + 1) * per] for k, v in b.items()}
                for j in range(TRAIN_INST)]

    def matrices():
        """The weight matrices (a segment's leaves of 3 dims, the lm_head)
        and, where the model reads tokens, the token table's row of the
        first token trained on: what a bf16 step of ~lr must move (a gain
        near 1, or a row no batch reads, moves by less than a bf16
        unit)."""
        out = [params["lm_head"]] + [
            leaf for seg in params["segments"] for leaf in seg.values()
            if leaf.dim() >= 3]
        if not embed_dim:
            out.append(params["embed"][int(insts(0)[0]["tokens"][0, 0])])
        return out

    watch = [leaf.reshape(-1)[:64].clone() for leaf in matrices()]
    n_k7 = k7_layers(cfg, TRAIN_SEQ)
    want = {"flash_attention_kernel": 2 * n_k7 * TRAIN_INST,
            "flash_dq_kernel": n_k7 * TRAIN_INST,
            "flash_dkdv_kernel": n_k7 * TRAIN_INST}
    ms, total = [], collections.Counter()
    for step in range(steps):
        batches = insts(step)
        torch.cuda.synchronize()
        reset()
        t0 = time.perf_counter()
        params, state, m = train_step(params, state, batches, cfg, opt)
        torch.cuda.synchronize()
        m["seconds"] = time.perf_counter() - t0
        got = read()
        total.update(got)
        w = dict(want)
        w.update({k: 0 for k in got if k not in w})
        check(got == w, f"{arch} step {step} launches {got}: K7 twice per "
              f"K7 layer ({n_k7}) and institution, K8a and K8b once")
        check(all(math.isfinite(x) for x in (m["loss"], m["grad_norm"])),
              f"{arch} step {step}: loss {m['loss']} grad norm "
              f"{m['grad_norm']}")
        ms.append(m)
    peak = torch.cuda.max_memory_allocated()
    moved = [float((leaf.reshape(-1)[:64].float() - w.float()).abs().max())
             for leaf, w in zip(matrices(), watch)]
    check(min(moved) > 0.0, f"{arch}: a weight matrix did not move "
          f"({moved})")
    secs = [m["seconds"] for m in ms]
    steady = statistics.median(secs[1:])
    out = {
        "arch": full.name, "num_layers": cfg.num_layers,
        "reduced": ({"num_layers": f"{cfg.num_layers} of {full.num_layers}"}
                    if cfg.num_layers < full.num_layers else {}),
        "params": n_params, "params_full_depth": T.count_params(full),
        "dtype": "bfloat16", "remat": cfg.remat,
        "rwkv_chunk": cfg.rwkv_chunk, "frontend": cfg.frontend,
        "institutions": TRAIN_INST, "batch": TRAIN_BATCH,
        "seq_len": TRAIN_SEQ, "steps": steps, "lr": TRAIN_LR,
        "warmup_steps": opt.warmup_steps,
        "losses": [m["loss"] for m in ms],
        "grad_norms": [m["grad_norm"] for m in ms],
        "seconds_per_step": secs,
        "median_seconds_per_step_after_the_first": steady,
        "tokens_per_second": TRAIN_BATCH * TRAIN_SEQ / steady,
        "k7_layers": n_k7, "launches_per_step": want,
        "launches": dict(total), "peak_bytes_allocated": peak,
        "weight_matrices": len(moved), "min_matrix_move": min(moved),
        "max_matrix_move": max(moved),
        "init_params_seconds": init_s, "card": smi,
    }

    def profiled_step():
        nonlocal params, state
        params, state, m = train_step(params, state, insts(0), cfg, opt)
        return m

    def adamw_only():
        _, grads, _ = mean_gradients(params, insts(1), cfg)
        torch.cuda.synchronize()
        return lambda: adamw_update(grads, state, params, opt)

    return out, profiled_step, adamw_only


def training_families_phase(dev, smi, counts, profile_repeats: int = 0):
    """Phase 18: the F3a and F3b families trained on the card (see the
    module docstring).  Prints each part's line; returns (the largest K8
    error at ``F4_K8_CASES``, their timing arguments by name, the
    ``train_f4`` fields by arch, the secure runs' launches by arch)."""
    import torch

    gc.collect()
    torch.cuda.empty_cache()
    print(f"phase 18: {torch.cuda.memory_allocated()} bytes on the card "
          "from earlier phases")
    k8_err, k8_args = check_k8(dev, F4_K8_CASES,
                               tuple(c[0] for c in F4_K8_CASES))
    print(f"K8a/K8b vs plain: {[c[0] for c in F4_K8_CASES]} within "
          f"tolerance, max|d(dq, dk, dv)| {k8_err:.3e}")
    for arch in F4_MOE_ARCHS:
        print(json.dumps({"moe_grad_check": moe_grad_check(dev, arch),
                          "card": smi}))
    for arch, layers, n_params, steps in F4_GRAD_CHECKS:
        print(json.dumps({"grad_check_f4": grad_check(
            dev, arch, layers, n_params, steps), "card": smi}))
    trained = {}
    for arch, layers, n_params in F4_MODELS:
        trained[arch], run, adamw_run = training_phase(
            dev, smi, counts, arch, layers, n_params, F4_STEPS)
        print(json.dumps({"train_f4": trained[arch]}))
        if profile_repeats:
            print(json.dumps({"profile": profile_run(
                run, lambda r: 1, f"train_step {arch}", profile_repeats,
                categories=F4_CATEGORIES), "card": smi}))
        del run, adamw_run  # the model and its moments
        gc.collect()
        torch.cuda.empty_cache()
    secure = {}
    for arch, _, _ in F4_MODELS:
        out = secure_phase(dev, counts, arch)
        secure[arch] = out["launches"]
        print(json.dumps({"secure_train_f4": out, "card": smi}))
    return k8_err, k8_args, trained, secure


def wire_tree(dev, params: int = WIRE_PARAMS):
    """The JAX secure_psum tests' tree at the benchmark's size, drawn on
    ``dev`` from SEED: 0.5 x normals in a leaf of ``params`` - 16 (999,984)
    and a 4 x 4 leaf of 3.25, 10^6 float32 parameters in all."""
    import torch

    g = torch.Generator(device=dev).manual_seed(SEED)
    return {"g": 0.5 * torch.randn(params - 16, generator=g, device=dev),
            "h": torch.full((4, 4), 3.25, device=dev)}


def decoded_sum(tree, copies: int):
    """What the wire must reveal for ``copies`` ranks holding ``tree``: the
    exact field sum of their encodings, decoded.  A float32 leaf encodes
    s = round(x 2^28) in float32 (K1's float32 rule); copies x s is exact
    in float64, and so is the decode's 2^-28; the result is cast back."""
    import torch

    scale = float(2**FRAC_BITS)
    return {k: (torch.round(v * scale).double() * copies / scale).to(v.dtype)
            for k, v in tree.items()}


def trees_equal(a, b) -> bool:
    import torch

    return sorted(a) == sorted(b) and all(torch.equal(a[k], b[k]) for k in a)


def ring(d: int) -> float:
    """A ring collective's share of a buffer each rank moves, as
    benchmarks/secure_psum.py counts it ((D - 1) / D, 1 at D = 1)."""
    return (d - 1) / d if d > 1 else 1.0


def wire_model_bytes(mode: str, d: int, agg, params: int) -> float:
    """benchmarks/secure_psum.py's per-rank payload model at D ranks: ring
    accounting, shares at 4 bytes (a fabric with per-hop modular adds),
    the per-leaf oracle's int64 shares at 8, plaintext float32."""
    from repro_torch.core.flatbuf import LANES, ROW_ALIGN, _rows_for

    sch = agg.scheme
    w, t, r = sch.num_shares, sch.threshold, sch.field.num_residues
    rows = _rows_for(params, ROW_ALIGN)
    rows_sh = _rows_for(params, math.lcm(ROW_ALIGN, d))
    return {"per_leaf": 2 * w * r * params * 8,
            "replicated": 2 * t * r * rows * LANES * 4,
            "sharded": t * r * rows_sh * LANES * 4 + rows_sh * LANES * 4,
            }[mode.replace("_tile", "")] * ring(d)


def wire_measured_bytes(stats: dict, d: int) -> dict:
    """What this rank handed its collectives (``compat.wire_stats``): the
    operands' bytes, and the same under the model's ring accounting (an
    all-reduce operand 2 (D-1)/D, a reduce-scatter operand (D-1)/D, an
    all-gather operand, one rank's tile, D - 1 times)."""
    ar, rs = stats.get("all_reduce", 0), stats.get("reduce_scatter", 0)
    ag = stats.get("all_gather", 0)
    return {"operand_bytes": ar + rs + ag,
            "ring_bytes": 2 * ar * ring(d) + rs * ring(d) + ag * max(d - 1, 1),
            "host_staged_bytes": stats.get("host_staged", 0)}


def run_wire_modes(tree, want, d: int, reset, read):
    """Each 1D ``secure_psum`` mode on the current mesh's pod axis: a
    warm-up call of each, then the counted run (``reset()``, one call of
    each mode, each reveal checked equal to ``want`` bit for bit and its
    K1 and K2 launches read from the counts' growth, ``read()``), then
    WIRE_REPS timed calls of each.  Returns (per mode the seconds a call,
    the launches and the bytes on the wire; the counted run's launches)."""
    from repro_torch.core.collective import SecureCollective, secure_psum
    from repro_torch.distributed import compat

    calls = {}
    for mode, backend, reveal in (("per_leaf", "reference", "replicated"),
                                  ("replicated", "kernel", "replicated"),
                                  ("sharded", "kernel", "sharded"),
                                  ("sharded_tile", "kernel", "sharded")):
        agg = SecureCollective(backend=backend)

        def call(agg=agg, reveal=reveal, tile=mode == "sharded_tile"):
            if tile:
                return secure_psum(tree, "pod", SEED, aggregator=agg,
                                   reveal="sharded", out="tile").gather("pod")
            return secure_psum(tree, "pod", SEED, aggregator=agg,
                               reveal=reveal)

        calls[mode] = (agg, call)
        call()  # warm-up
    out = {}
    reset()
    for mode, (agg, call) in calls.items():
        before = read()
        compat.reset_wire_stats()
        got = call()
        stats = compat.wire_stats()
        after = read()
        launches = {k: after[k] - before[k] for k in after}
        check(trees_equal(got, want),
              f"secure_psum {mode} at D={d}: the reveal is not the decoded "
              "exact sum")
        # a wrapper counts the launches of its kernel, never its plain
        # version's runs on a CPU tensor (the CPU rehearsal)
        flat = int(mode != "per_leaf" and got["g"].is_cuda)
        check(all(v == (flat if k in ("encode_share_kernel",
                                      "reconstruct_kernel") else 0)
                  for k, v in launches.items()),
              f"secure_psum {mode} launches {launches}")
        out[mode] = {"launches": launches,
                     "model_ring_bytes_4B": wire_model_bytes(
                         mode, d, agg, sum(v.numel() for v in tree.values())),
                     **wire_measured_bytes(stats, d)}
    total = read()
    for mode, (_, call) in calls.items():
        out[mode]["seconds_per_call"] = _timed(call)
    return out, total


def _sync() -> None:
    """Wait for the card (the CPU rehearsal of phase 14 has none)."""
    import torch

    if torch.cuda.is_available():
        torch.cuda.synchronize()


def _timed(call, reps: int = WIRE_REPS) -> float:
    """Median host seconds of ``call`` to a synchronize."""
    times = []
    for _ in range(reps):
        _sync()
        t0 = time.perf_counter()
        call()
        _sync()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def _wire_rank(rank, world, rdzv, out_path, args):
    """One of phase 14's spawned ranks, on ``device`` (cuda:0 on the card)
    over one gloo group: the
    1D modes, the scanned rounds and compressed_psum on a pod mesh of
    ``world``, then the 2D wire against the 1D wire on a 2 x 2 mesh.
    Every check raises here, so a failure exits the rank non-zero."""
    import datetime

    import torch
    import torch.distributed as dist
    from repro_torch.core.collective import SecureCollective, secure_psum
    from repro_torch.distributed import compat, multihost
    from repro_torch.kernels.shamir_poly import encode_share_kernel
    from repro_torch.kernels.shamir_reconstruct import reconstruct_kernel
    from repro_torch.optim.compression import compressed_psum

    dist.init_process_group(
        "gloo", init_method=rdzv, rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    device, params = args
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    counters = (encode_share_kernel, reconstruct_kernel)

    def reset():
        for k in counters:
            k.launches = 0

    def read():
        return {k.__name__: k.launches for k in counters}

    tree = wire_tree(dev, params)
    out = {"rank": rank}
    try:
        with compat.use_mesh(multihost.pod_mesh(world)):
            out["backend_pod"] = dist.get_backend(compat.axis_group("pod"))
            out["modes"], out["launches"] = run_wire_modes(
                tree, decoded_sum(tree, world), world, reset, read)
            out["reveal_g"] = secure_psum(tree, "pod", SEED)["g"].cpu()
            scanned = {}
            for reveal in ("replicated", "sharded"):
                reset()
                t0 = time.perf_counter()
                final, trace = multihost.run_scanned_rounds(
                    world, tree, SEED, WIRE_ROUNDS, reveal=reveal,
                    device=dev)
                _sync()
                sec = time.perf_counter() - t0
                err = max(float((final[k] - tree[k]).abs().max())
                          for k in tree)
                check(tuple(trace.shape) == (WIRE_ROUNDS,),
                      f"scanned trace {tuple(trace.shape)}")
                check(err <= 1e-4, f"scanned rounds ({reveal}) moved the "
                      f"mean by {err}")
                launches = read()
                check(all(v == WIRE_ROUNDS * dev.type.startswith("cuda")
                          for v in launches.values()),
                      f"scanned rounds launches {launches}")
                scanned[reveal] = {"seconds_per_round": sec / WIRE_ROUNDS,
                                   "max_abs_mean_drift": err,
                                   "launches": launches}
            out["scanned"] = scanned
            grads = {k: v * (rank + 1) for k, v in tree.items()}
            efb = {k: torch.zeros_like(v) for k, v in tree.items()}
            mean, _ = compressed_psum(grads, "pod", efb)
            true = {k: v * (world + 1) / 2 for k, v in tree.items()}
            # the shared scale is the largest rank's absmax / 127; each
            # rank's code is within half a scale step, so is the mean
            step = max(float(v.abs().max()) for v in tree.values()) \
                * world / 127
            cerr = max(float((mean[k] - true[k]).abs().max()) for k in tree)
            check(cerr <= 0.5 * step * (1 + 1e-5) + 1e-5,
                  f"compressed_psum error {cerr} > half a step {step}")
            out["compressed"] = {
                "seconds_per_call": _timed(
                    lambda: compressed_psum(grads, "pod", efb)),
                "max_abs_err_vs_mean": cerr, "half_step": 0.5 * step}
            # phase 15 (c): the 1D psum specs under the gate, on this rank
            out["privacy_gate"] = gate_on_rank(
                ("secure_psum[replicated]", "secure_psum[sharded,tree]",
                 "secure_psum[sharded,tile]"), dev)
        with compat.use_mesh(multihost.pod_share_mesh(*WIRE_MESH_2D)):
            out["backend_share"] = dist.get_backend(
                compat.axis_group("share"))
            agg = SecureCollective(backend="kernel")
            multihost.secure_psum_2d(tree, SEED, aggregator=agg)  # warm-up
            reset()
            compat.reset_wire_stats()
            r2d = multihost.secure_psum_2d(tree, SEED, aggregator=agg)
            _sync()
            stats = compat.wire_stats()
            launches = read()
            r1d = secure_psum(tree, "pod", SEED, aggregator=agg)
            check(trees_equal(r2d, r1d), "2D wire != 1D wire on its pods")
            check(trees_equal(r2d, decoded_sum(tree, WIRE_MESH_2D[0])),
                  "2D wire != the decoded exact sum")
            check(launches == {"encode_share_kernel": int(dev.type == "cuda"),
                               "reconstruct_kernel": 0},
                  f"2D launches {launches}")
            out["2d"] = {"seconds_per_call": _timed(
                lambda: multihost.secure_psum_2d(tree, SEED,
                                                 aggregator=agg)),
                "launches": launches, **wire_measured_bytes(
                    stats, WIRE_MESH_2D[0])}
            out["privacy_gate"].update(gate_on_rank(("secure_psum_2d",),
                                                    dev))
        gathered = [None] * world
        dist.all_gather_object(gathered, out["reveal_g"])
        out["ranks_agree"] = all(torch.equal(g, out["reveal_g"])
                                 for g in gathered)
        if rank == 0:
            torch.save(out, out_path)
    finally:
        dist.destroy_process_group()


def wires_phase(dev, smi, counts, params: int = WIRE_PARAMS,
                cap_n: int = LEAF_N):
    """Phase 14: the multi-device wires.  (a) a single-rank NCCL group on
    the card: every 1D mode, a (2, 17) reveal from all 17 centers; (b) D =
    4 spawned ranks on one gloo group, all on cuda:0 (NCCL refuses two
    ranks on one card): the 1D modes, the 2 x 2 mesh, the scanned rounds
    and compressed_psum; (c) the repaired caps: K1, K4 and K2 past 16
    shares, each against its plain version.  Returns the ``{"wires": ...}``
    record, the launches of (a)'s counted run and (c)'s timing cases."""
    import datetime
    import tempfile

    import torch
    import torch.distributed as dist
    from repro_torch.core.collective import SecureCollective, secure_psum
    from repro_torch.core.field import FIELD_WIDE
    from repro_torch.core.flatbuf import pack_pytree
    from repro_torch.core.shamir import ShamirScheme
    from repro_torch.distributed import compat, multihost
    from repro_torch.kernels.shamir_poly import encode_share_kernel, \
        encode_share_plain, share_kernel, share_plain
    from repro_torch.kernels.shamir_reconstruct import reconstruct_kernel, \
        reconstruct_plain

    reset, read = counts
    tree = wire_tree(dev, params)
    out = {"params": params, "card": smi}
    # (a) one rank, NCCL on the card (gloo in a CPU rehearsal)
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group(
            "nccl" if dev.type == "cuda" else "gloo",
            init_method=f"file://{tmp}/rdzv", rank=0, world_size=1,
            timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
        try:
            with compat.use_mesh(multihost.pod_mesh(1)):
                single = {"backend": dist.get_backend(
                    compat.axis_group("pod"))}
                single["modes"], launches = run_wire_modes(
                    tree, decoded_sum(tree, 1), 1, reset, read)
                wide = SecureCollective(backend="kernel", scheme=ShamirScheme(
                    threshold=2, num_shares=17))
                every = tuple(range(1, 18))
                got = secure_psum(tree, "pod", SEED, aggregator=wide,
                                  points=every)
                check(trees_equal(got, decoded_sum(tree, 1)),
                      "a (2, 17) secure_psum revealed from all 17 centers")
                single["t2_w17_all_points_seconds_per_call"] = _timed(
                    lambda: secure_psum(tree, "pod", SEED, aggregator=wide,
                                        points=every))
        finally:
            dist.destroy_process_group()
    out["single_rank"] = single
    flat = 3 if dev.type == "cuda" else 0
    check(all(v == (flat if k in ("encode_share_kernel",
                                  "reconstruct_kernel") else 0)
              for k, v in launches.items()),
          f"phase 14 (a) launches {launches}: one K1 and one K2 a flat call")
    # (b) D ranks, spawned, one gloo group, every rank on cuda:0
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = multihost.spawn_ranks(
        WIRE_RANKS, _wire_rank,
        ("cuda:0" if dev.type == "cuda" else str(dev), params),
        deadline_s=WIRE_DEADLINE_S)
    spawn_s = time.perf_counter() - t0
    check(ranks["ranks_agree"], "the spawned ranks' reveals differ")
    check(torch.equal(ranks["reveal_g"],
                      decoded_sum(tree, WIRE_RANKS)["g"].cpu()),
          f"D={WIRE_RANKS} reveal != the decode of {WIRE_RANKS} x tree")
    ranks.pop("reveal_g")
    out["gloo_ranks"] = {"ranks": WIRE_RANKS, "mesh_2d": WIRE_MESH_2D,
                         "spawn_seconds": spawn_s, **ranks}
    # (c) the repaired caps at protocol sizes
    buf, layout = pack_pytree(tree)
    gen = torch.Generator(device=dev).manual_seed(SEED + 14)
    cases = {"K1": {}, "K2": {}, "K4": {}}
    for t, w in CAP_SHAPES:
        coeffs = torch.stack([
            torch.randint(0, p, (t - 1, layout.rows, 128), generator=gen,
                          device=dev) for p in FIELD_WIDE.moduli
        ]).to(torch.int32)
        args = (buf, coeffs, FIELD_WIDE.moduli, FRAC_BITS,
                tuple(range(1, w + 1)))
        check(torch.equal(encode_share_kernel(*args),
                          encode_share_plain(*args)),
              f"K1 at (t, w) = ({t}, {w}) vs its plain version")
        cases["K1"][f"t{t}_w{w}"] = args
        k4 = k4_args(dev, gen, t, w, cap_n)
        check(torch.equal(share_kernel(*k4), share_plain(*k4)),
              f"K4 at (t, w) = ({t}, {w}) vs its plain version")
        cases["K4"][f"t{t}_w{w}"] = k4
    for k in CAP_KS:
        shares = torch.stack([torch.stack([
            torch.randint(0, p, (layout.rows, 128), generator=gen,
                          device=dev) for p in FIELD_WIDE.moduli])
            for _ in range(k)]).to(torch.int32)
        for fb in (FRAC_BITS, None):
            args = (shares, tuple(range(1, k + 1)), FIELD_WIDE.moduli, fb)
            check(torch.equal(reconstruct_kernel(*args),
                              reconstruct_plain(*args)),
                  f"K2 with k = {k} (frac_bits {fb}) vs its plain version")
        cases["K2"][f"k{k}"] = (shares, tuple(range(1, k + 1)),
                                FIELD_WIDE.moduli, FRAC_BITS)
    out["caps_checked"] = {"K1": list(cases["K1"]), "K4": list(cases["K4"]),
                           "K2": list(cases["K2"]), "bit_identical": True}
    return out, launches, cases


def _census_json(census: dict) -> dict:
    return {f"{site}{list(shape)}": n for (site, shape), n in
            sorted(census.items())}


def gate_on_rank(names, dev) -> dict:
    """Phase 15 (c) on one of phase 14's ranks, under its mesh: each named
    psum spec certified (its taint findings and this rank's run linted)
    and audited (an ungated run's ledger counts against the census).
    Every check raises, so a failure exits the rank non-zero."""
    from repro_torch.analysis.drivers import certify_on_rank

    out = {}
    for name in names:
        t0 = time.perf_counter()
        r = certify_on_rank((name,), str(dev), audit=True)[name]
        sec = time.perf_counter() - t0
        rep = r["report"]
        check(rep.ok, f"the gate on a rank: {rep.format()}")
        check(r["audit"].ok, f"the audit on a rank: {r['audit'].findings()}")
        out[name] = {"census": _census_json(r["census"]),
                     "rounds": r["rounds"], "reconciled": True,
                     "collective_axes": sorted({e.axis for e in
                                                r["collectives"]}),
                     "declassifications": len(rep.declassifications),
                     "seconds_gate_and_audit": sec}
    return out


def privacy_gate_phase(dev, smi, counts, parts, fit_kw) -> dict:
    """Phase 15: the privacy gate and the runtime audit on the card.
    (a) every single-process spec certified clean at the JAX package's toy
    shapes with every tensor on the card, the three leak fixtures caught
    (skip_protect through K3's real output) and the audit's extra reveal
    flagged; every declared kernel call of a gated run a launch of its
    CUDA kernel.  (b) the fused round at phase 4's configuration certified
    under both protect modes, then phase 4's fit (and its gradient-mode
    twin) under the ledger: every (site, shape) count equals iterations x
    the certified round's census.  Returns the ``{"privacy_gate": ...}``
    record (phase 14's ranks add (c))."""
    import torch
    from repro_torch.analysis.drivers import DriverSpec, all_driver_specs, \
        certify
    from repro_torch.analysis.fixtures import leak_fixture_specs
    from repro_torch.analysis.taint import PUBLIC, SECRET
    from repro_torch.core.batched_summaries import pack_partitions
    from repro_torch.core.newton import _fused_secure_iteration, secure_fit
    from repro_torch.obs import audit, gate, ledger

    reset, read = counts
    out = {"card": smi, "specs": {}, "fixtures": {}}
    # (a) the certified surface at toy size, every tensor on the card
    local = [s for s in all_driver_specs() if not s.world]
    gate_calls = collections.Counter()
    local[0].runner(dev)  # warm-up: the toy pack, the allocator
    reset()
    for spec in local:
        t0 = time.perf_counter()
        rep, trace = certify(spec, dev, lint=True)
        _sync()
        sec = time.perf_counter() - t0
        check(rep.ok, f"gate on the card: {rep.format()}")
        gate_calls += trace.kernels
        census, rounds, _ = trace.round_census()
        out["specs"][spec.name] = {
            "ok": True, "census": _census_json(census), "rounds": rounds,
            "declassifications": len(rep.declassifications),
            "warnings": [f.message for f in rep.findings
                         if f.severity == "warning"],
            "host_reads": len(trace.host_reads), "seconds_certify": sec}
    for spec in leak_fixture_specs():
        rep, trace = certify(spec, dev)
        gate_calls += trace.kernels
        errs = rep.errors()
        check(bool(errs), f"{spec.name} passed the gate on the card")
        out["fixtures"][spec.name] = {"caught": True,
                                      "where": errs[0].where}
    launched = read()
    on_card = dev.type == "cuda"  # a CPU rehearsal runs the plain versions
    check(all(n == gate_calls.get(k, 0) * on_card
              for k, n in launched.items())
          and all(gate_calls[k] > 0 for k in (
              "encode_share_kernel", "reconstruct_kernel",
              "fused_irls_kernel", "fused_irls_cv_kernel")),
          f"launches under the gate {launched} vs its kernel calls "
          f"{dict(gate_calls)}: every declared call a CUDA launch, K1, K2, "
          "K3 and K5 among them")
    out["launches_under_gate"] = {k: v for k, v in launched.items() if v}
    # the audit of each spec, and the extra reveal it must flag
    audits = {spec.name: audit.audit_spec(spec, dev) for spec in local}
    for name, a in audits.items():
        check(a.ok, f"audit on the card: {a.findings()}")
    extra = audit.extra_reveal_fixture(local[0], dev)
    check(not extra.ok, "the extra reveal was not flagged on the card")
    out["audit"] = {name: {"reconciled": True, "rounds": a.rounds}
                    for name, a in audits.items()}
    out["extra_reveal_flagged"] = extra.findings()

    # (b) full width: phase 4's round, certified, then phase 4's fit
    agg = fit_kw["aggregator"]
    packed = pack_partitions(parts)
    out["full_size"] = {}
    for protect in ("both", "gradient"):
        def setup(device, protect=protect):
            def fn(beta, generator, packed):
                return _fused_secure_iteration(
                    beta, generator, packed, 1.0, agg, protect, 0.0,
                    summaries_backend="kernel")

            beta = torch.zeros((D,), dtype=torch.float64, device=device)
            gen = torch.Generator(device=device).manual_seed(SEED)
            return fn, (beta, gen, packed), (PUBLIC, PUBLIC, SECRET)

        spec = DriverSpec(f"secure_fit_fused[protect={protect}] at "
                          f"S={S} d={D} N={N}", setup,
                          agg.scheme.threshold)
        reset()
        t0 = time.perf_counter()
        rep, trace = certify(spec, dev)
        _sync()
        cert_s = time.perf_counter() - t0
        certified_launches = {k: v for k, v in read().items() if v}
        census, rounds, _ = trace.round_census()
        check(rep.ok and rounds == 1, f"full-size gate: {rep.format()}")
        check(dict(trace.kernels) == {"fused_irls_kernel": 1,
                                      "encode_share_kernel": 1,
                                      "reconstruct_kernel": 1}
              and certified_launches == (dict(trace.kernels) if on_card
                                         else {}),
              f"full-size launches under the gate {certified_launches}")
        kw = dict(fit_kw, protect=protect)
        reset()
        t0 = time.perf_counter()
        with ledger.capture() as cap:
            res = secure_fit(parts, **kw)
        _sync()
        fit_s = time.perf_counter() - t0
        a = audit.reconcile(spec.name, census, res.iterations, cap)
        check(res.converged and a.ok,
              f"phase 4's fit ({protect}) vs {res.iterations} x the "
              f"certified census: {a.findings()}")
        out["full_size"][protect] = {
            "census": _census_json(census),
            "declassifications": rep.declassifications,
            "seconds_certify": cert_s,
            "launches_certified_round": certified_launches,
            "fit_iterations": res.iterations,
            "recorded": _census_json(a.recorded),
            "reconciled": True,
            "fit_seconds_per_round_under_ledger": fit_s / res.iterations,
            "fit_launches": {k: v for k, v in read().items() if v}}
    # a disabled hook: one global read and a branch, against the bare call
    probe = gate.boundary("probe")(lambda: None)
    reps = 200_000
    t0 = time.perf_counter()
    for _ in range(reps):
        probe()
    hooked = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(reps):
        probe.__wrapped__()
    bare = time.perf_counter() - t0
    out["disabled_hook_ns"] = (hooked - bare) / reps * 1e9
    return out


# ------------------------------------------------------------------ phase 19
def _owned(tree):
    """``tree`` with every tensor copied to storage of its own (a rank's
    blocks, so the whole parameters can be freed)."""
    if isinstance(tree, dict):
        return {k: _owned(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_owned(v) for v in tree]
    return tree.clone()


def _d2a_config(arch, layers, flags, smoke):
    """Phase 19 (b)'s config: the arch at full width (its smoke config in
    a CPU rehearsal) cut to ``layers``, with ``flags``."""
    import dataclasses

    from repro_torch.configs import get_config, smoke_config

    base = smoke_config(arch) if smoke else get_config(arch)
    return dataclasses.replace(base, num_layers=layers, **flags)


def _k7_prefill_launches(cfg, rules, batch, prompt):
    """K7 launches a rank's prefill implies (and the K7 layers of its
    training forward, whose layouts are the prefill's): one per attention
    layer that attends through ``attend``'s K7 branch (no window, or one
    the prompt does not pass), none for a windowed layer in the ``seq``
    layout (``swa_attend_cp``'s scan); a decode step launches none."""
    from repro_torch.distributed._tp import block_layout
    from repro_torch.models.config import segments

    n = 0
    for (mixer, _), layers in segments(cfg):
        if mixer not in ("full", "swa", "local", "mla"):
            continue
        window = cfg.window if mixer in ("swa", "local") else 0
        if block_layout(cfg, rules, batch, prompt, mixer, "prefill") == "seq":
            continue
        if not window or window >= prompt:
            n += layers
    return n


def _moe_rank_drops(x, router, cfg, ranks):
    """(the unsharded function's dropped assignments, each of ``ranks``
    expert-parallel ranks' drops among its own E / ranks experts): the
    router's choices of ``x`` (B, S, d) and ``moe._dispatch``'s queues."""
    from repro_torch.models import moe

    E, k = cfg.moe_num_experts, cfg.moe_top_k
    T = x.shape[0] * x.shape[1]
    _, experts, _ = moe._route(x.reshape(T, -1), router, k)
    capacity = max(1, int(T * k * cfg.capacity_factor / E))
    e_loc = E // ranks
    per_rank = [int(moe._dispatch(experts, capacity, r * e_loc, e_loc, E)[3])
                for r in range(ranks)]
    return int(moe._dispatch(experts, capacity, 0, E, E)[3]), per_rank


def _d2a_model(rank, dev, rules, arch, layers, flags, prompt, batch,
               smoke):
    """One model of phase 19 (b) on this rank; returns its record (rank
    0's with the comparison against the unsharded run)."""
    import dataclasses

    import torch
    import torch.distributed as dist
    from repro_torch.distributed import compat
    from repro_torch.distributed.sharding import shard_params, tree_bytes
    from repro_torch.kernels.flash_attention import flash_attention_kernel
    from repro_torch.models import transformer as T
    from repro_torch.models.moe import moe_ffn

    cfg = _d2a_config(arch, layers, flags, smoke)
    serve_cfg = cfg
    if cfg.moe_num_experts:  # drop-free: a capacity of T
        serve_cfg = dataclasses.replace(
            cfg, capacity_factor=cfg.moe_num_experts / cfg.moe_top_k)
    t0 = time.perf_counter()
    params = T.init_params(cfg, seed=SEED, device=dev)
    _sync()
    out = {"arch": cfg.name, "num_layers": layers, "flags": flags,
           "prompt_len": prompt, "batch": batch,
           "capacity_factor": serve_cfg.capacity_factor,
           "init_params_seconds": time.perf_counter() - t0}
    local = _owned(shard_params(params, rules, cfg))
    whole_moe = None
    if rank == 0 and cfg.moe_num_experts:  # for the moe_ffn check
        seg = next(s for s in params["segments"] if "router" in s)
        whole_moe = {k: v[0] for k, v in seg.items()
                     if k.startswith(("router", "experts_", "shared_"))}
    if rank != 0:  # rank 0 serves the unsharded run first
        del params
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    gen = torch.Generator().manual_seed(SEED)
    tokens = torch.randint(0, cfg.vocab_size, (batch, prompt),
                           generator=gen).to(dev)
    cache_len = prompt + D2A_STEPS
    ref = None
    if rank == 0:  # the unsharded run: greedy tokens, logits, bf16 noise
        with torch.inference_mode():
            logits, caches, n = T.prefill(params, serve_cfg, tokens,
                                          cache_len=cache_len)
            ref, picks = [logits.float()], []
            for _ in range(D2A_STEPS):
                picks.append(torch.argmax(logits, dim=-1))
                logits, caches, n = T.decode_step(params, caches, n,
                                                  serve_cfg, picks[-1])
                ref.append(logits.float())
            del caches
            p32 = {k: (v.float() if torch.is_tensor(v) else
                       [{m: t.float() for m, t in seg.items()} for seg in v])
                   for k, v in params.items()}
            ref32, _, _ = T.prefill(p32, dataclasses.replace(
                serve_cfg, dtype_str="float32"), tokens, cache_len=cache_len)
            del p32
        out["bf16_vs_f32_prefill_max_abs_err"] = float(
            (ref[0] - ref32.float()).abs().max())
        del ref32, params
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        picks = torch.stack(picks).cpu()
    else:
        picks = None
    box = [picks]
    dist.broadcast_object_list(box, src=0)
    picks = box[0].to(dev)
    out["param_bytes"] = tree_bytes(local)
    out["param_bytes_whole"] = T.count_params(cfg) * 2
    # the sharded run, every rank
    flash_attention_kernel.launches = 0
    compat.reset_wire_stats()
    got = []
    _sync()
    t0 = time.perf_counter()
    with torch.inference_mode():
        logits, caches, n = T.prefill(local, serve_cfg, tokens,
                                      cache_len=cache_len, rules=rules)
        got.append(T.gather_logits(logits, serve_cfg, rules).float())
        _sync()
        t1 = time.perf_counter()
        for i in range(D2A_STEPS):
            logits, caches, n = T.decode_step(local, caches, n, serve_cfg,
                                              picks[i], rules=rules)
            got.append(T.gather_logits(logits, serve_cfg, rules).float())
        _sync()
    t2 = time.perf_counter()
    want_k7 = _k7_prefill_launches(serve_cfg, rules, batch, prompt) \
        if dev.type == "cuda" else 0
    check(flash_attention_kernel.launches == want_k7,
          f"{arch} rank {rank}: K7 launched {flash_attention_kernel.launches}"
          f" times, the config implies {want_k7}")
    out.update({
        "prefill_seconds": t1 - t0, "decode_seconds_per_step":
        (t2 - t1) / D2A_STEPS,
        "k7_launches": flash_attention_kernel.launches,
        "k7_launches_implied": want_k7,
        "wire_stats": compat.wire_stats(),
        "cache_bytes": tree_bytes(list(caches)),
        "cache_bytes_whole": tree_bytes(T.init_cache(
            serve_cfg, batch, cache_len, device="meta"))})
    del caches
    if cfg.moe_num_experts:  # moe_ffn at D2A_MOE_BATCH prompts, cf 1.0
        mcfg = dataclasses.replace(cfg, capacity_factor=D2A_MOE_CF)
        x = torch.randn((D2A_MOE_BATCH, prompt, cfg.d_model), generator=torch.
                        Generator().manual_seed(SEED + 19)).to(dev).to(
                            cfg.dtype)
        mseg = next(i for i, s in enumerate(local["segments"])
                    if "router" in s)
        mine = {k: v[0] for k, v in local["segments"][mseg].items()
                if k.startswith(("router", "experts_", "shared_"))}
        with torch.inference_mode(), compat.use_mesh(rules.mesh):
            y, aux, drop = moe_ffn(x, mine, mcfg, rules=rules)
        if rank == 0:
            with torch.inference_mode():
                y0, aux0, drop0 = moe_ffn(x, whole_moe, mcfg)
                total, per_rank = _moe_rank_drops(
                    x, whole_moe["router"], mcfg, rules.tp_size)
            tk = x.shape[0] * x.shape[1] * cfg.moe_top_k
            err, scale = float((y - y0).abs().max()), float(y0.abs().max())
            out["moe_check"] = {
                "tokens": D2A_MOE_BATCH * prompt,
                "capacity_factor": mcfg.capacity_factor, "experts_a_rank":
                mine["experts_w1"].shape[0], "y_max_abs_err": err,
                "y_max_abs": scale, "aux": float(aux),
                "aux_unsharded": float(aux0), "drop_fraction": float(drop),
                "drop_fraction_unsharded": float(drop0),
                "dropped_unsharded": total, "dropped_by_rank": per_rank}
            check(total > 0, f"{arch} moe_ffn check: no assignment drops at "
                  f"capacity factor {mcfg.capacity_factor}")
            check(total == sum(per_rank), f"{arch} moe_ffn: the ranks' "
                  f"drops {per_rank} do not add up to {total}")
            check(round(float(drop0) * tk) == total,
                  f"{arch} moe_ffn unsharded drop {float(drop0)} vs "
                  f"{total} of {tk}")
            # each rank drops over its own experts' capacity; JAX's pmax
            # over the model axis keeps the largest
            want = float(torch.tensor(max(per_rank), dtype=torch.float32)
                         / tk)
            check(float(drop) == want, f"{arch} moe_ffn expert-parallel "
                  f"drop {float(drop)} != max{per_rank} / {tk}")
            check(err <= CONT_TOL * scale, f"{arch} moe_ffn expert-parallel "
                  f"y err {err} (max|y| {scale})")
            check(abs(float(aux) - float(aux0)) <= 1e-5 * abs(float(aux0)),
                  f"{arch} moe_ffn aux {float(aux)} != {float(aux0)}")
        del whole_moe, x, y
    if rank == 0:
        noise = out["bf16_vs_f32_prefill_max_abs_err"]
        errs = [float((g - r).abs().max()) for g, r in zip(got, ref)]
        scale = max(float(r.abs().max()) for r in ref)
        bound = max(CONT_TOL * scale, 2 * noise)
        out.update({"max_abs_err_by_step": errs, "max_abs_logit": scale,
                    "bound": bound, "argmax_agreement": float(
                        (torch.stack(got).argmax(-1)
                         == torch.stack(ref).argmax(-1)).float().mean())})
        check(max(errs) <= bound, f"{arch} sharded logits: max|err| by step "
              f"{errs} > {bound} (max|logit| {scale}, bf16 noise {noise})")
    return out


def _d2a_rank(rank, world, rdzv, out_path, args):
    """One of phase 19 (b)'s spawned ranks on ``device`` (cuda:0 on the
    card) over one gloo group, a (data, model) mesh of ``D2A_MESH``:
    every model of ``models`` in turn; rank 0 saves every rank's
    records.  A failed check exits the rank non-zero."""
    import datetime

    import torch
    import torch.distributed as dist
    from repro_torch.distributed import compat
    from repro_torch.distributed.sharding import MeshRules

    dist.init_process_group(
        "gloo", init_method=rdzv, rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    device, models, mesh_shape, smoke = args
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    try:
        rules = MeshRules(compat.make_mesh(mesh_shape, ("data", "model")))
        recs = {}
        for arch, layers, flags, prompt, batch in models:
            if dev.type == "cuda":
                torch.cuda.reset_peak_memory_stats()
            recs[arch] = _d2a_model(rank, dev, rules, arch, layers, flags,
                                    prompt, batch, smoke)
            if dev.type == "cuda":
                recs[arch]["peak_bytes_allocated"] = \
                    torch.cuda.max_memory_allocated()
            gc.collect()
            if dev.type == "cuda":
                torch.cuda.empty_cache()
        gathered = [None] * world
        dist.all_gather_object(gathered, recs)
        if rank == 0:
            torch.save(gathered, out_path)
    finally:
        dist.destroy_process_group()


def d2a_phase(dev, smi, counts, phase10_tokens=None, models=D2A_MODELS,
              smoke=False):
    """Phase 19: the sharded serving path.  (a) one rank (NCCL on the
    card, gloo in a CPU rehearsal) with a (1, 1) mesh serves phase 10's
    requests through ``rules=``; (b) ``D2A_RANKS`` spawned ranks on one
    gloo group, all on ``dev``, with a ``D2A_MESH`` mesh: ``models`` one
    at a time (``_d2a_model``).  ``smoke`` runs the smoke configs (a CPU
    rehearsal).  Returns the ``{"d2a": ...}`` record."""
    import dataclasses
    import datetime
    import tempfile

    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.distributed import compat
    from repro_torch.distributed.sharding import MeshRules
    from repro_torch.launch.serve import serve_requests
    from repro_torch.models import transformer as T

    reset, read = counts
    t_phase = time.perf_counter()
    base = smoke_config(SERVE_ARCH) if smoke else get_config(SERVE_ARCH)
    cfg = dataclasses.replace(base, num_layers=SERVE_LAYERS)
    prompt = 64 if smoke else SERVE_PROMPT
    params = T.init_params(cfg, seed=SEED, device=dev)
    gen = torch.Generator().manual_seed(SEED)
    served = torch.randint(0, cfg.vocab_size, (SERVE_REQUESTS, prompt + 1),
                           generator=gen).to(dev)[:, :prompt]
    single = {}
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group(
            "nccl" if dev.type == "cuda" else "gloo",
            init_method=f"file://{tmp}/rdzv", rank=0, world_size=1,
            timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
        try:
            rules = MeshRules(compat.make_mesh((1, 1), ("data", "model")))
            single["backend"] = dist.get_backend()
            if phase10_tokens is None:
                phase10_tokens, _ = serve_requests(params, cfg, served,
                                                   SERVE_BATCH, SERVE_NEW)
                single["reference"] = "served unsharded in this phase"
            else:
                single["reference"] = "phase 10's tokens"
            _sync()
            reset()
            t0 = time.perf_counter()
            completed, stats = serve_requests(params, cfg, served,
                                              SERVE_BATCH, SERVE_NEW,
                                              rules=rules)
            _sync()
            secs = time.perf_counter() - t0
            launches = read()
            with torch.inference_mode():
                got, _, _ = T.prefill(params, cfg, served[:SERVE_BATCH],
                                      rules=rules)
                want, _, _ = T.prefill(params, cfg, served[:SERVE_BATCH])
        finally:
            dist.destroy_process_group()
    del params
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    err = float((got.float() - want.float()).abs().max())
    scale = float(want.float().abs().max())
    check(completed == phase10_tokens,
          "phase 19 (a): the (1, 1) mesh's tokens differ from phase 10's")
    check(err <= CONT_TOL * scale, f"phase 19 (a): prefill logits err {err}"
          f" (max|logit| {scale})")
    if dev.type == "cuda":
        want_k7 = {"flash_attention_kernel": stats["batches"] * SERVE_LAYERS}
        want_k7.update({k: 0 for k in launches if k not in want_k7})
        check(launches == want_k7, f"phase 19 (a) launches {launches}")
    single.update({
        "arch": cfg.name, "num_layers": SERVE_LAYERS, "mesh": [1, 1],
        "requests": SERVE_REQUESTS, "batch": SERVE_BATCH,
        "prompt_len": prompt, "new_tokens": SERVE_NEW,
        "tokens_equal_reference": True, "prefill_max_abs_err": err,
        "prefill_max_abs_logit": scale, "seconds": secs,
        "launches": launches})
    # (b) D2A_RANKS ranks, spawned, one gloo group, every rank on dev
    t0 = time.perf_counter()
    from repro_torch.distributed import multihost

    ranks = multihost.spawn_ranks(
        D2A_RANKS, _d2a_rank,
        ("cuda:0" if dev.type == "cuda" else str(dev), models, D2A_MESH,
         smoke), deadline_s=D2A_DEADLINE_S)
    spawn_s = time.perf_counter() - t0
    per_model = {}
    for arch, *_ in models:
        recs = [r[arch] for r in ranks]
        for r in recs:  # about a quarter of the parameters on each rank
            check(r["param_bytes"] <= 0.3 * r["param_bytes_whole"],
                  f"{arch}: {r['param_bytes']} parameter bytes on a rank of "
                  f"{r['param_bytes_whole']}")
        per_model[arch] = {**recs[0], "ranks": [
            {k: r[k] for k in ("param_bytes", "cache_bytes", "k7_launches",
                               "wire_stats", "prefill_seconds",
                               "decode_seconds_per_step",
                               "peak_bytes_allocated") if k in r}
            for r in recs]}
        for k in ("param_bytes", "cache_bytes", "k7_launches", "wire_stats",
                  "prefill_seconds", "decode_seconds_per_step",
                  "peak_bytes_allocated"):
            per_model[arch].pop(k, None)
    return {"single_rank": single, "gloo_ranks": {
        "ranks": D2A_RANKS, "mesh": list(D2A_MESH),
        "transport": "gloo over the host (the ranks share one card): "
                     "times are host-ring times, no fabric is measured",
        "spawn_seconds": spawn_s, "models": per_model},
        "phase_seconds": time.perf_counter() - t_phase, "card": smi}


# ------------------------------------------------------------------ phase 20
def _block_of(whole, path, rules, cfg, rank):
    """Global ``rank``'s block of a whole leaf by its spec on
    ``rules.mesh`` (``shard_params`` for another rank)."""
    from repro_torch.distributed.sharding import leaf_spec

    names = rules.axis_names
    at = (rules.mesh.mesh == rank).nonzero()[0].tolist()
    coords = dict(zip(names, at))
    for dim, axes in enumerate(leaf_spec(path, whole.shape, rules, cfg)):
        if axes is None:
            continue
        idx, n = 0, 1
        for a in ((axes,) if isinstance(axes, str) else axes):
            idx, n = idx * rules.axis_size(a) + coords[a], \
                n * rules.axis_size(a)
        step = whole.shape[dim] // n
        whole = whole.narrow(dim, idx * step, step)
    return whole


def _d2b_reference(params, batch, cfg):
    """Rank 0's unsharded reference: (bf16 loss, float32 loss, bf16 grad
    norm, float32 grad norm, the bf16 gradient leaves on the host, each
    leaf's bound: the larger of CONT_TOL max|g| and twice its distance
    from the float32 gradient).  ``params`` go to float32 in place and
    are freed."""
    import torch
    from repro_torch.launch.train import _value_and_grad

    def norm(gs):
        return float(torch.sqrt(sum(torch.sum(torch.square(g.float()))
                                    for g in gs)))

    loss16, _, g16 = _value_and_grad(params, batch, cfg)
    gn16 = norm(g16)
    g16 = [g.cpu() for g in g16]
    params, cfg32 = to_float32_in_place(params, cfg)
    loss32, _, g32 = _value_and_grad(params, batch, cfg32)
    del params
    gn32 = norm(g32)
    bounds = []
    for i, g in enumerate(g32):
        h = g16[i].to(g.device).float()
        bounds.append(max(CONT_TOL * float(h.abs().max()),
                          2 * float((h - g).abs().max())))
        g32[i] = None
        del h, g
    return float(loss16), float(loss32), gn16, gn32, g16, bounds


def _d2b_model(rank, dev, rules, arch, layers, flags, seq, batch, smoke):
    """One model of phase 20 (b) on this rank; returns its record (rank
    0's with the per-leaf comparison against its unsharded run)."""
    import dataclasses

    import torch
    import torch.distributed as dist
    from repro_torch.core.flatbuf import tree_paths
    from repro_torch.distributed import compat
    from repro_torch.distributed.sharding import shard_params, tree_bytes
    from repro_torch.kernels.flash_attention import flash_attention_kernel
    from repro_torch.kernels.flash_attention_bwd import flash_dkdv_kernel, \
        flash_dq_kernel
    from repro_torch.launch.train import _value_and_grad, corpus_batch, \
        mesh_train_step
    from repro_torch.models import transformer as T
    from repro_torch.optim import AdamWConfig, adamw_init

    cfg = _d2a_config(arch, layers, flags, smoke)
    if cfg.moe_num_experts:  # drop-free: a capacity of T
        cfg = dataclasses.replace(
            cfg, capacity_factor=cfg.moe_num_experts / cfg.moe_top_k)
    t0 = time.perf_counter()
    world = dist.get_world_size()
    for r in range(world):  # one whole model on the card at a time
        if r == rank:
            params = T.init_params(cfg, seed=SEED, device=dev)
            local = _owned(shard_params(params, rules, cfg))
            if rank != 0:  # rank 0 keeps it for the references
                del params
            gc.collect()
            if dev.type == "cuda":
                torch.cuda.empty_cache()
        dist.barrier()
    out = {"arch": cfg.name, "num_layers": layers, "flags": flags,
           "seq_len": seq, "batch": batch, "remat": cfg.remat,
           "capacity_factor": cfg.capacity_factor,
           "init_params_seconds": time.perf_counter() - t0}
    data = corpus_batch(SEED, 0, batch, seq, cfg.vocab_size, dev)
    ref = None
    if rank == 0:  # the unsharded references, while the others wait
        t0 = time.perf_counter()
        ref = _d2b_reference(params, data, cfg)
        del params
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        out["reference_seconds"] = time.perf_counter() - t0
        if dev.type == "cuda":
            out["reference_peak_bytes_allocated"] = \
                torch.cuda.max_memory_allocated()
            torch.cuda.reset_peak_memory_stats()
        print(f"phase 20 (b) {arch}: the unsharded references in "
              f"{out['reference_seconds']:.1f} s", flush=True)
    dist.barrier()
    # the sharded gradient, held leaf by leaf on rank 0
    _sync()
    t0 = time.perf_counter()
    loss, _, grads = _value_and_grad(local, data, cfg, rules)
    _sync()
    out["gradient_seconds"] = time.perf_counter() - t0
    out["grad_bytes"] = sum(g.numel() * g.element_size() for g in grads)
    t0 = time.perf_counter()
    worst, ratios = (0.0, None), []
    for i, path in enumerate(tree_paths(local)):
        blk = grads[i].cpu().contiguous()
        grads[i] = None
        got = [torch.empty_like(blk) for _ in range(world)] \
            if rank == 0 else None
        dist.gather(blk, got, dst=0)
        if rank == 0:
            _, _, _, _, g16, bounds = ref
            for r, g in enumerate(got):  # compared on the card
                want = _block_of(g16[i], path, rules, cfg, r).to(dev)
                err = float((g.to(dev).float() - want.float()).abs().max())
                ratios.append(err / bounds[i] if bounds[i] else 0.0)
                check(err <= bounds[i], f"{arch} rank {r} {path}: gradient "
                      f"err {err} > {bounds[i]}")
                if ratios[-1] >= worst[0]:
                    worst = (ratios[-1], f"rank {r} {path}")
    del grads
    out["gradient_check_seconds"] = time.perf_counter() - t0
    # one mesh_train_step: launches, wire, seconds, every block moved
    matrices = [local["lm_head"]] + [leaf for seg in local["segments"]
                                     for leaf in seg.values()
                                     if leaf.dim() >= 3]
    watch = [leaf.reshape(-1)[:64].clone() for leaf in matrices]
    state = adamw_init(local)
    kernels = (flash_attention_kernel, flash_dq_kernel, flash_dkdv_kernel)
    for k in kernels:
        k.launches = 0
    compat.reset_wire_stats()
    _sync()
    t0 = time.perf_counter()
    local, state, m = mesh_train_step(local, state, data, cfg,
                                      AdamWConfig(lr=TRAIN_LR,
                                                  warmup_steps=1),
                                      rules=rules)
    _sync()
    out["step_seconds"] = time.perf_counter() - t0
    launches = {k.__name__: k.launches for k in kernels}
    n_k7 = _k7_prefill_launches(cfg, rules, batch, seq) \
        if dev.type == "cuda" else 0
    want = {"flash_attention_kernel": 2 * n_k7, "flash_dq_kernel": n_k7,
            "flash_dkdv_kernel": n_k7}
    check(launches == want, f"{arch} rank {rank}: launches {launches}, the "
          f"config implies {want} (K7 twice and K8a, K8b once a K7 layer)")
    moved = [float((leaf.reshape(-1)[:64].float() - w.float()).abs().max())
             for leaf, w in zip(matrices, watch)]
    check(min(moved) > 0.0, f"{arch} rank {rank}: a weight block did not "
          f"move ({moved})")
    check(all(math.isfinite(m[k]) for k in ("loss", "grad_norm")),
          f"{arch} rank {rank}: {m}")
    whole = T.count_params(cfg)
    out.update({
        "loss": m["loss"], "grad_norm": m["grad_norm"], "ce": m["ce"],
        "aux": m["aux"], "launches": launches, "k7_layers": n_k7,
        "wire_stats": compat.wire_stats(),
        "param_bytes": tree_bytes(local),
        "moment_bytes": tree_bytes(state.mu) + tree_bytes(state.nu),
        "param_bytes_whole": whole * 2, "moment_bytes_whole": whole * 8,
        "weight_blocks_moved": len(moved), "min_block_move": min(moved)})
    if rank == 0:
        print(f"phase 20 (b) {arch}: init {out['init_params_seconds']:.1f}"
              f" s, gradient {out['gradient_seconds']:.1f} s (its check "
              f"{out['gradient_check_seconds']:.1f} s), step "
              f"{out['step_seconds']:.1f} s, worst leaf {worst[1]} at "
              f"{max(ratios):.3f} of its bound", flush=True)
        loss16, loss32, gn16, gn32, _, _ = ref
        for name, got, w16, w32 in (("loss", float(loss), loss16, loss32),
                                    ("step loss", m["loss"], loss16, loss32),
                                    ("grad norm", m["grad_norm"], gn16,
                                     gn32)):
            b = max(CONT_TOL * abs(w16), 2 * abs(w16 - w32))
            check(abs(got - w16) <= b, f"{arch} {name} {got} vs the "
                  f"unsharded {w16} (float32 {w32}; bound {b})")
        out.update({"loss_unsharded_bf16": loss16,
                    "loss_unsharded_f32": loss32,
                    "grad_norm_unsharded_bf16": gn16,
                    "grad_norm_unsharded_f32": gn32,
                    "leaves": len(ref[4]),
                    "max_err_over_bound": max(ratios),
                    "worst_leaf": worst[1]})
    del state, local
    return out


def _d2b_rank(rank, world, rdzv, out_path, args):
    """One of phase 20 (b)'s spawned ranks on ``device`` (cuda:0 on the
    card) over one gloo group, a (data, model) mesh of ``D2B_MESH``:
    every model of ``models`` in turn; rank 0 saves every rank's
    records.  A failed check exits the rank non-zero."""
    import datetime
    import os

    # read at this process's first CUDA allocation: rank 0's float32
    # reference at Qwen3-MoE's width left 7.3 GB of its cache reserved
    # and unused when it ran out of memory with fixed segments
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    import torch
    import torch.distributed as dist
    from repro_torch.distributed import compat
    from repro_torch.distributed.sharding import MeshRules

    dist.init_process_group(
        "gloo", init_method=rdzv, rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    device, models, mesh_shape, smoke = args
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    try:
        rules = MeshRules(compat.make_mesh(mesh_shape, ("data", "model")))
        recs = {}
        for arch, layers, flags, seq, batch in models:
            if dev.type == "cuda":
                torch.cuda.reset_peak_memory_stats()
            recs[arch] = _d2b_model(rank, dev, rules, arch, layers, flags,
                                    seq, batch, smoke)
            if dev.type == "cuda":
                recs[arch]["peak_bytes_allocated"] = \
                    torch.cuda.max_memory_allocated()
            gc.collect()
            if dev.type == "cuda":
                torch.cuda.empty_cache()
        gathered = [None] * world
        dist.all_gather_object(gathered, recs)
        if rank == 0:
            torch.save(gathered, out_path)
    finally:
        dist.destroy_process_group()


def d2b_phase(dev, smi, counts, models=D2B_MODELS, smoke=False):
    """Phase 20: gradients under a mesh.  (a) one rank (NCCL on the card,
    gloo in a CPU rehearsal) with a (1, 1) mesh runs ``D2B_STEPS``
    ``mesh_train_step`` calls of phase 13's model and traffic, bit for
    bit those without rules; (b) ``D2B_RANKS`` spawned ranks on one gloo
    group, all on ``dev``, with a ``D2B_MESH`` mesh: ``models`` one at a
    time (``_d2b_model``).  ``smoke`` runs the smoke configs at short
    sequences (a CPU rehearsal).  Returns the ``{"d2b": ...}`` record."""
    import datetime
    import tempfile

    import torch
    import torch.distributed as dist
    from repro_torch.core.flatbuf import tree_flatten
    from repro_torch.distributed import compat
    from repro_torch.distributed.sharding import MeshRules
    from repro_torch.launch.train import corpus_batch, mesh_train_step
    from repro_torch.models import transformer as T
    from repro_torch.optim import AdamWConfig, adamw_init

    reset, read = counts
    t_phase = time.perf_counter()
    cfg = _d2a_config(TRAIN_ARCH, TRAIN_LAYERS, {}, smoke)
    seq = 64 if smoke else TRAIN_SEQ
    opt = AdamWConfig(lr=TRAIN_LR, warmup_steps=D2B_STEPS)
    single = {}
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group(
            "nccl" if dev.type == "cuda" else "gloo",
            init_method=f"file://{tmp}/rdzv", rank=0, world_size=1,
            timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
        try:
            rules = MeshRules(compat.make_mesh((1, 1), ("data", "model")))
            single["backend"] = dist.get_backend()
            runs = []
            for r in (None, rules):
                params = T.init_params(cfg, seed=SEED, device=dev)
                state = adamw_init(params)
                ms = []
                _sync()
                reset()
                t0 = time.perf_counter()
                for step in range(D2B_STEPS):
                    params, state, m = mesh_train_step(
                        params, state, corpus_batch(
                            SEED, step, TRAIN_BATCH, seq, cfg.vocab_size,
                            dev), cfg, opt, rules=r)
                    ms.append(m)
                _sync()
                runs.append((ms, params, read(),
                             (time.perf_counter() - t0) / D2B_STEPS))
                del state, params
                gc.collect()
                if dev.type == "cuda":
                    torch.cuda.empty_cache()
        finally:
            dist.destroy_process_group()
    (ms0, p0, _, _), (ms1, p1, launches, secs) = runs
    same = ms0 == ms1 and all(torch.equal(a, b) for a, b in zip(
        tree_flatten(p0)[0], tree_flatten(p1)[0]))
    del runs, p0, p1
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    check(same, f"phase 20 (a): the (1, 1) mesh's steps differ from the "
          f"unsharded ones: {ms1} vs {ms0}")
    if dev.type == "cuda":
        n_k7 = k7_layers(cfg, seq)
        want = {"flash_attention_kernel": 2 * n_k7 * D2B_STEPS,
                "flash_dq_kernel": n_k7 * D2B_STEPS,
                "flash_dkdv_kernel": n_k7 * D2B_STEPS}
        want.update({k: 0 for k in launches if k not in want})
        check(launches == want, f"phase 20 (a) launches {launches}")
    single.update({
        "arch": cfg.name, "num_layers": cfg.num_layers, "mesh": [1, 1],
        "batch": TRAIN_BATCH, "seq_len": seq, "steps": D2B_STEPS,
        "bitwise_equal_to_unsharded": True,
        "losses": [m["loss"] for m in ms1],
        "grad_norms": [m["grad_norm"] for m in ms1],
        "seconds_per_step": secs, "launches": launches})
    # (b) D2B_RANKS ranks, spawned, one gloo group, every rank on dev
    if smoke:
        models = tuple((a, n, f, 64 if f else 32, b)
                       for a, n, f, _, b in models)
    t0 = time.perf_counter()
    from repro_torch.distributed import multihost

    ranks = multihost.spawn_ranks(
        D2B_RANKS, _d2b_rank,
        ("cuda:0" if dev.type == "cuda" else str(dev), models, D2B_MESH,
         smoke), deadline_s=D2B_DEADLINE_S)
    spawn_s = time.perf_counter() - t0
    per_rank = ("param_bytes", "grad_bytes", "moment_bytes", "launches",
                "wire_stats", "gradient_seconds", "step_seconds",
                "peak_bytes_allocated", "loss", "grad_norm")
    per_model = {}
    for arch, *_ in models:
        recs = [r[arch] for r in ranks]
        for r in recs:  # about a quarter of the state on each rank
            check(r["param_bytes"] <= 0.3 * r["param_bytes_whole"]
                  and r["grad_bytes"] <= 0.3 * r["param_bytes_whole"]
                  and r["moment_bytes"] <= 0.3 * r["moment_bytes_whole"],
                  f"{arch}: {r['param_bytes']} parameter, "
                  f"{r['grad_bytes']} gradient and {r['moment_bytes']} "
                  f"moment bytes on a rank")
        per_model[arch] = {**{k: v for k, v in recs[0].items()
                              if k not in per_rank},
                           "ranks": [{k: r[k] for k in per_rank if k in r}
                                     for r in recs]}
    return {"single_rank": single, "gloo_ranks": {
        "ranks": D2B_RANKS, "mesh": list(D2B_MESH),
        "transport": "gloo over the host (the ranks share one card): "
                     "times are host-ring times, no fabric is measured",
        "spawn_seconds": spawn_s, "models": per_model},
        "phase_seconds": time.perf_counter() - t_phase, "card": smi}


# ------------------------------------------------------------------ phase 21
def knob_phase(dev) -> dict:
    """Phase 21 (a): ``lint_kernel_knobs`` with the built library's
    registers, and every instantiation's model (``kernels/tuning.py``)
    held to the compiled kernel and the flash kernels' shared-memory
    exports.  Returns {family: its registers, shared memory and blocks an
    SM}.  On the CPU (a rehearsal) the lint alone, from the model."""
    from repro_torch.analysis.lints import lint_kernel_knobs
    from repro_torch.kernels import tuning

    if dev.type != "cuda":
        rep = lint_kernel_knobs()
        check(rep.ok, rep.format(verbose=True))
        return {"lint": [f.message for f in rep.findings]}
    from repro_torch.kernels import _build

    attrs = tuning.compiled_attributes()
    families = tuning.check_compiled(attributes=attrs)
    rep = lint_kernel_knobs(registers={n: a["registers"]
                                       for n, a in attrs.items()})
    check(rep.ok, rep.format(verbose=True))
    lib = _build.library()
    for fam in ("K7", "K8a", "K8b"):
        for inst in tuning.instantiations(tuning.DEFAULT_KNOBS[fam]):
            _, kind, dim = inst.name.split()  # e.g. "K8a bf16 D128"
            d, bf16 = int(dim[1:]), int(kind == "bf16")
            got = (lib.repro_k7_smem_bytes(d, bf16) if fam == "K7" else
                   lib.repro_k8_smem_bytes(int(fam == "K8b"), d, bf16))
            check(got == inst.dynamic_smem, f"{inst.name}: the model's "
                  f"{inst.dynamic_smem} bytes of dynamic shared memory, the "
                  f"export's {got}")
    for fam, rec in families.items():
        print(f"phase 21 (a) {fam}: {rec['instantiations']} "
              f"instantiation(s), up to {rec['registers']} registers a "
              f"thread, up to {rec['smem_bytes']} B of shared memory, "
              f"{rec['blocks_per_sm']} block(s) an SM at least")
    return {"families": families, "instantiations": attrs,
            "lint": [f.message for f in rep.findings]}


def _cell8(smoke):
    """Phase 20 (a)'s configuration and step shape."""
    from repro_torch.models.config import ShapeConfig

    cfg = _d2a_config(TRAIN_ARCH, TRAIN_LAYERS, {}, smoke)
    return cfg, ShapeConfig("cell8", 64 if smoke else TRAIN_SEQ,
                            TRAIN_BATCH, "train")


def one_rank_phase(dev, counts, smoke=False) -> dict:
    """Phase 21 (b): phase 20 (a)'s step dry-run on a (1, 1) fake mesh on
    ``meta``, then run on one rank of the card (NCCL; gloo on the CPU)
    under the cost counter, its batch int32 as the dry run's."""
    import datetime
    import tempfile

    import torch
    import torch.distributed as dist
    from repro_torch.distributed import compat
    from repro_torch.distributed.sharding import MeshRules, tree_bytes
    from repro_torch.launch.cost_analysis import CostCounter
    from repro_torch.launch.dryrun import dry_run
    from repro_torch.launch.mesh import fake_world
    from repro_torch.launch.train import corpus_batch, mesh_train_step
    from repro_torch.models import transformer as T
    from repro_torch.optim import AdamWConfig, adamw_init

    reset, read = counts
    cfg, shape = _cell8(smoke)
    t0 = time.perf_counter()
    with fake_world(1):
        rules = MeshRules(compat.make_mesh((1, 1), ("data", "model")))
        pred = dry_run(cfg, shape, rules, probe_loops=0)
    meta_s = time.perf_counter() - t0
    cuda = dev.type == "cuda"
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group(
            "nccl" if cuda else "gloo", init_method=f"file://{tmp}/rdzv",
            rank=0, world_size=1,
            timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
        try:
            rules = MeshRules(compat.make_mesh((1, 1), ("data", "model")))
            base = torch.cuda.memory_allocated(dev) if cuda else 0
            params = T.init_params(cfg, seed=SEED, device=dev)
            state = adamw_init(params)
            batch = {k: v.to(torch.int32) for k, v in corpus_batch(
                SEED, 0, shape.global_batch, shape.seq_len, cfg.vocab_size,
                dev).items()}
            args = tree_bytes(params) + tree_bytes(state.mu) + \
                tree_bytes(state.nu) + state.step.element_size() + \
                tree_bytes(batch)
            counter = CostCounter()
            _sync()
            if cuda:
                torch.cuda.reset_peak_memory_stats(dev)
            reset()
            t0 = time.perf_counter()
            with counter:
                counter.track(params, state, batch)
                params, state, m = mesh_train_step(
                    params, state, batch, cfg,
                    AdamWConfig(lr=TRAIN_LR, warmup_steps=D2B_STEPS),
                    rules=rules)
            _sync()
            step_s = time.perf_counter() - t0
            launches = {k: v for k, v in read().items() if v}
            measured = (torch.cuda.max_memory_allocated(dev) - base
                        if cuda else None)
            del params, state, batch
        finally:
            dist.destroy_process_group()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    cp = pred["cost_analysis"]
    n_k7 = k7_layers(cfg, shape.seq_len)  # K7 again in remat's backward
    want = {"K7": (1 + cfg.remat) * n_k7, "K8a": n_k7, "K8b": n_k7}
    check(pred["memory"]["argument_bytes_per_device"] == args,
          f"phase 21 (b): predicted argument bytes "
          f"{pred['memory']['argument_bytes_per_device']}, the rank's {args}")
    check(cp["flops_per_device"] == counter.flops,
          f"phase 21 (b): predicted FLOPs {cp['flops_per_device']}, counted "
          f"on {dev.type} {counter.flops}")
    check(cp["kernel_calls"] == dict(counter.kernel_calls) == want,
          f"phase 21 (b): kernel calls predicted {cp['kernel_calls']}, "
          f"counted {dict(counter.kernel_calls)}, the config's {want}")
    if cuda:
        check(launches == {"flash_attention_kernel": want["K7"],
                           "flash_dq_kernel": want["K8a"],
                           "flash_dkdv_kernel": want["K8b"]},
              f"phase 21 (b): launches on the card {launches}")
    peak = cp["predicted_peak_bytes_per_device"]
    out = {"arch": cfg.name, "num_layers": cfg.num_layers,
           "seq_len": shape.seq_len, "batch": shape.global_batch,
           "remat": cfg.remat, "argument_bytes": args,
           "flops": counter.flops, "flops_predicted": cp["flops_per_device"],
           "bytes_counted": counter.bytes,
           "bytes_predicted": cp["bytes_per_device"],
           "kernel_calls": dict(counter.kernel_calls),
           "launches": launches, "predicted_peak_bytes": peak,
           "counted_peak_bytes": counter.peak_bytes,
           "max_memory_allocated": measured, "meta_seconds": meta_s,
           "step_seconds": step_s}
    if cuda:
        out["peak_gap_bytes"] = measured - peak
        check(peak <= measured <= peak + PEAK_BAND,
              f"phase 21 (b): max_memory_allocated {measured} against the "
              f"predicted peak {peak} (band {PEAK_BAND})")
    print(f"phase 21 (b) {cfg.name} x {cfg.num_layers} layers: arguments "
          f"{args} B, {counter.flops:.6e} FLOPs and "
          f"{dict(counter.kernel_calls)}"
          f" on {dev.type} as predicted; peak predicted {peak} B, counted "
          f"{counter.peak_bytes} B, max_memory_allocated {measured}",
          flush=True)
    return out


def tp4_phase(d2b_out=None, smoke=False) -> dict:
    """Phase 21 (c): phase 20 (b)'s four models dry-run as rank 0 of a
    (1, 4) fake mesh: a rank's parameter and gradient bytes, kernel calls
    and ``wire_stats`` against phase 20's (``d2b_out``, this run's, else
    ``D2B_RANK_BYTES`` and ``D2B_RANK_WIRE``)."""
    import dataclasses

    from repro_torch.distributed import compat
    from repro_torch.distributed.sharding import (MeshRules, shard_params,
                                                  tree_bytes)
    from repro_torch.launch.cost_analysis import CostCounter
    from repro_torch.launch.dryrun import _owned, dry_run
    from repro_torch.launch.mesh import fake_world
    from repro_torch.launch.specs import input_specs
    from repro_torch.launch.train import _value_and_grad
    from repro_torch.models import transformer as T
    from repro_torch.models.config import ShapeConfig

    models = D2B_MODELS
    if smoke:
        models = tuple((a, n, f, 64 if f else 32, b)
                       for a, n, f, _, b in models)
    out = {}
    for arch, layers, flags, seq, batch in models:
        cfg = _d2a_config(arch, layers, flags, smoke)
        if cfg.moe_num_experts:  # phase 20's drop-free capacity
            cfg = dataclasses.replace(
                cfg, capacity_factor=cfg.moe_num_experts / cfg.moe_top_k)
        shape = ShapeConfig("d2b", seq, batch, "train")
        t0 = time.perf_counter()
        with fake_world(D2B_RANKS):
            rules = MeshRules(compat.make_mesh(D2B_MESH, ("data", "model")))
            local = _owned(shard_params(T.abstract_params(cfg), rules, cfg))
            with CostCounter(probe_loops=8):
                _, _, grads = _value_and_grad(local, input_specs(cfg, shape),
                                              cfg, rules)
            grad_bytes = sum(g.numel() * g.element_size() for g in grads)
            rec = dry_run(cfg, shape, rules, probe_loops=0)
        wire = {k: v for k, v in rec["wire_stats"].items()}
        n_k7 = k7_layers(cfg, seq)
        got = {"param_bytes": tree_bytes(local), "grad_bytes": grad_bytes,
               "kernel_calls": rec["cost_analysis"]["kernel_calls"],
               "wire_stats": wire,
               "collective_bytes":
                   rec["cost_analysis"]["collective_bytes_per_device"],
               "predicted_peak_bytes":
                   rec["cost_analysis"]["predicted_peak_bytes_per_device"],
               "seconds": time.perf_counter() - t0}
        want_calls = {k: v for k, v in (("K7", (1 + cfg.remat) * n_k7),
                                         ("K8a", n_k7), ("K8b", n_k7)) if v}
        check(got["kernel_calls"] == want_calls,
              f"phase 21 (c) {arch}: kernel calls {got['kernel_calls']}, "
              f"phase 20's {want_calls}")
        if d2b_out is not None:
            r0 = d2b_out["gloo_ranks"]["models"][arch]["ranks"][0]
            want_bytes, want_wire = r0["param_bytes"], {
                k: v for k, v in r0["wire_stats"].items()
                if not k.startswith("host_staged")}
            check(r0["grad_bytes"] == want_bytes, f"{arch}: {r0}")
            got["measured_peak_bytes_allocated"] = \
                r0.get("peak_bytes_allocated")
        elif not smoke:
            want_bytes, want_wire = D2B_RANK_BYTES[arch], D2B_RANK_WIRE[arch]
        else:
            want_bytes, want_wire = got["param_bytes"], wire
        check(got["param_bytes"] == got["grad_bytes"] == want_bytes,
              f"phase 21 (c) {arch}: parameter {got['param_bytes']} and "
              f"gradient {got['grad_bytes']} bytes a rank, phase 20's "
              f"{want_bytes}")
        check(wire == want_wire, f"phase 21 (c) {arch}: wire_stats {wire}, "
              f"phase 20's {want_wire}")
        print(f"phase 21 (c) {arch}: {got['param_bytes']} parameter and "
              f"gradient bytes a rank, wire_stats and kernel calls as phase "
              f"20 counted ({got['seconds']:.1f} s)", flush=True)
        out[arch] = got
        del local, grads
        gc.collect()
    return out


def sweep_phase(dev, smoke=False) -> dict:
    """Phase 21 (d): ``python -m repro_torch.launch.dryrun --all`` on the
    (16, 16) fake mesh at full size (a 2 x 2 one at smoke size), baseline
    and ``--optimized``; a line a cell and which fit one card."""
    import os
    import tempfile

    import torch
    from repro_torch.launch.dryrun import LM_ARCHS
    from repro_torch.models.config import SHAPES

    limit = (torch.cuda.get_device_properties(dev).total_memory
             if dev.type == "cuda" else 80e9)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = {"mesh": "2x2" if smoke else "16x16", "card_bytes": limit,
           "note": "host arithmetic on the meta device: predictions, not "
                   "measurements of the card"}
    with tempfile.TemporaryDirectory() as tmp:
        for variant in ("baseline", "optimized"):
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--all",
                   "--jobs", str(SWEEP_JOBS), "--out", tmp, "--variant",
                   variant]
            if variant == "optimized":
                cmd.append("--optimized")
            if smoke:
                cmd += ["--smoke", "--mesh-shape", "2,2"]
            t0 = time.perf_counter()
            res = subprocess.run(cmd, env=env, capture_output=True,
                                 text=True, timeout=SWEEP_DEADLINE_S)
            secs = time.perf_counter() - t0
            check(res.returncode == 0, f"phase 21 (d) {variant}: "
                  f"{res.stdout[-2000:]}{res.stderr[-2000:]}")
            cells, fits = {}, []
            tag = "singlepod" + ("" if variant == "baseline"
                                 else f"__{variant}")
            for arch in LM_ARCHS:
                for shape in SHAPES:
                    rec = json.load(open(os.path.join(
                        tmp, f"{arch}__{shape}__{tag}.json")))
                    if "skipped" in rec:
                        check(shape == "long_500k", f"{arch} {shape} "
                              f"skipped: {rec['skipped']}")
                        cells[f"{arch} {shape}"] = "skipped"
                        continue
                    mem, ca = rec["memory"], rec["cost_analysis"]
                    peak = ca["predicted_peak_bytes_per_device"]
                    check(ca["flops_per_device"] > 0 and peak > 0,
                          f"{arch} {shape}: {rec}")
                    cell = {"argument_gb": mem["argument_bytes_per_device"]
                            / 1e9, "peak_gb": peak / 1e9,
                            "tflops": ca["flops_per_device"] / 1e12,
                            "collective_gb": sum(
                                ca["collective_bytes_per_device"].values())
                            / 1e9, "fits": peak <= limit,
                            "n_micro": rec["n_micro"],
                            "scaled_loops": sorted(ca["scaled_loops"]),
                            "seconds": rec["seconds"]}
                    cells[f"{arch} {shape}"] = cell
                    if cell["fits"]:
                        fits.append(f"{arch} {shape}")
                    print(f"phase 21 (d) {variant} {arch} {shape}: "
                          f"arguments {cell['argument_gb']:.3f} GB, peak "
                          f"{cell['peak_gb']:.3f} GB of {limit / 1e9:.1f} "
                          f"({'fits' if cell['fits'] else 'does not fit'}),"
                          f" {cell['tflops']:.3f} TFLOP, collectives "
                          f"{cell['collective_gb']:.3f} GB a rank a step",
                          flush=True)
            run = [k for k, v in cells.items() if v != "skipped"]
            check(len(cells) == len(LM_ARCHS) * len(SHAPES),
                  f"phase 21 (d) {variant}: {len(cells)} records")
            print(f"phase 21 (d) {variant}: {len(fits)} of {len(run)} cells "
                  f"fit one rank ({secs:.1f} s): {fits}", flush=True)
            out[variant] = {"seconds": secs, "cells": cells, "fit": fits}
    return out


def dryrun_phase(dev, smi, counts, d2b_out=None, smoke=False) -> dict:
    """Phase 21: the shape dry run, (a)-(d).  ``smoke`` runs the smoke
    configs (a CPU rehearsal); the record for the ``{"dry_run": ...}``
    line."""
    t_phase = time.perf_counter()
    out = {"knobs": knob_phase(dev)}
    out["one_rank"] = one_rank_phase(dev, counts, smoke)
    out["tp4"] = tp4_phase(d2b_out, smoke)
    out["sweep"] = sweep_phase(dev, smoke)
    out["phase_seconds"] = time.perf_counter() - t_phase
    out["card"] = smi
    return out


def load_twin(name: str):
    """The module ``examples/<name>.py`` (a twin of a JAX example)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def transfer_counter(dev):
    """A dispatch mode that counts, by the innermost ``repro_torch`` frame
    that made them (``path:function``), the run's blocking reads of
    ``dev``'s tensors on the host (a scalar read, or a copy to the CPU)
    in ``reads``, and its copies of at least ``EP_UPLOAD_MIN`` elements
    from the CPU to ``dev`` in ``uploads``.  On the CPU (a rehearsal) the
    scalar reads count and no copy does."""
    import os
    import traceback

    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    pkg = str(ROOT / "src" / "repro_torch") + os.sep
    aten = torch.ops.aten

    def site():
        for fr in reversed(traceback.extract_stack()):
            if fr.filename.startswith(pkg):
                return f"{fr.filename[len(pkg):]}:{fr.name}"
        return "outside repro_torch"

    class Transfers(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.reads = collections.Counter()
            self.uploads = collections.Counter()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if func is aten._local_scalar_dense.default:
                if args[0].device.type == dev.type:
                    self.reads[site()] += 1
            elif func in (aten._to_copy.default, aten.copy_.default):
                src, dst = ((args[0], out) if func is aten._to_copy.default
                            else (args[1], args[0]))
                if not (isinstance(src, torch.Tensor)
                        and isinstance(dst, torch.Tensor)):
                    return out
                if src.device.type == dev.type != "cpu" \
                        and dst.device.type == "cpu":
                    self.reads[site()] += 1
                elif src.device.type == "cpu" != dev.type \
                        and dst.device.type == dev.type \
                        and src.numel() >= EP_UPLOAD_MIN:
                    self.uploads[site()] += 1
            return out

    # the first op under a dispatch mode imports torch's tracing modules
    # (seconds): pay it here, outside any timed run
    with Transfers():
        torch.zeros(2).add_(1)
    return Transfers()


def entry_points_phase(dev, smi, counts, smoke=False) -> dict:
    """Phase 22: the system's normal entry points on ``dev``.  The four
    example twins in process through ``run(device)`` (each one's own
    asserts and its ``OK``), the quickstart twin once as a user types it,
    then ``launch.train.main`` on the paper's four studies at paper size
    (``smoke``: scale 0.02, a CPU rehearsal), scan rounds, λ selection,
    L1, a checkpointed logreg run stopped and resumed, the LM trainer
    with a failure and compression, and ``launch.serve.main`` on three
    archs; each run's wall seconds and launches, held to its launch
    model on the card.  The record for the ``{"entry_points": ...}``
    line; each run's ``launches`` lists the counters it moved."""
    import contextlib
    import io
    import shutil
    import tempfile

    import numpy as np
    import torch
    from repro_torch.configs import smoke_config
    from repro_torch.core.collective import SecureCollective
    from repro_torch.core.protocol import Institution, StudyCoordinator
    from repro_torch.core.shamir import ShamirScheme
    from repro_torch.data import generate_synthetic
    from repro_torch.launch import serve, train

    reset, read = counts
    on_card = dev.type == "cuda"
    scale = "0.02" if smoke else "1.0"
    K1, K2, K3, K5 = ("encode_share_kernel", "reconstruct_kernel",
                      "fused_irls_kernel", "fused_irls_cv_kernel")
    K7, K8A, K8B = "flash_attention_kernel", "flash_dq_kernel", \
        "flash_dkdv_kernel"
    runs: dict = {}
    t_phase = time.perf_counter()

    def timed(label, fn):
        """Run ``fn`` with its output captured; record its wall seconds
        (to a synchronize) and launches; returns (result, its lines,
        launches)."""
        buf = io.StringIO()
        if on_card:
            torch.cuda.synchronize()
        reset()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            res = fn()
        if on_card:
            torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = read()
        launched = {k: v for k, v in launches.items() if v}
        runs[label] = {"seconds": secs, "launches": launched}
        print(f"phase 22 {label}: {secs:.3f} s, launches {launched}",
              flush=True)
        return res, buf.getvalue().splitlines(), launches

    def want(launches, label, **n):
        """On the card, ``launches`` is exactly ``n`` (others 0)."""
        if on_card:
            full = {k: 0 for k in launches}
            full.update({{"K1": K1, "K2": K2, "K3": K3, "K5": K5,
                          "K7": K7, "K8a": K8A, "K8b": K8B}[k]: v
                         for k, v in n.items()})
            check(launches == full, f"phase 22 {label}: launches "
                  f"{launches} != {full}")

    def on_dev(t: torch.Tensor, what: str):
        check(t.device == (torch.device("cuda", 0) if on_card else dev),
              f"phase 22 {what} on {t.device}")

    def device_field(rep, label):
        check(rep["device"] == str(dev), f"phase 22 {label}: device "
              f"{rep['device']}")

    # -- (a) the twins of the four examples ----------------------------------
    qs = load_twin("torch_quickstart")
    out, lines, launches = timed("quickstart", lambda: qs.run(dev))
    sec = out["secure"]
    check(lines[-1] == "OK" and out["device"] == str(dev),
          f"phase 22 quickstart: {lines[-3:]}")
    # the JAX example's aggregator: ShamirScheme's default reference
    # backend, the loop path in both packages (no kernel)
    qs_round = SecureCollective(scheme=ShamirScheme(2, 3)).round_bytes(
        8, 5, "gradient", num_live_centers=3)
    check(sec.converged and sec.iterations <= 10
          and sec.bytes_transmitted == sec.iterations * qs_round,
          f"phase 22 quickstart: {sec.iterations} iterations, "
          f"{sec.bytes_transmitted} bytes")
    want(launches, "quickstart")
    runs["quickstart"].update(iterations=sec.iterations, r2=out["r2"],
                              bytes=sec.bytes_transmitted)

    cmd = [sys.executable, str(ROOT / "examples" / "torch_quickstart.py")]
    if not on_card:
        cmd += ["--device", "cpu"]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, cwd=str(ROOT), capture_output=True, text=True,
                         timeout=300)
    check(res.returncode == 0 and res.stdout.splitlines()[-1] == "OK",
          f"phase 22 {' '.join(cmd[1:])}: rc {res.returncode} "
          f"{res.stdout[-500:]}{res.stderr[-2000:]}")
    runs["quickstart_subprocess"] = {
        "seconds": time.perf_counter() - t0, "argv": cmd[1:],
        "last_line": res.stdout.splitlines()[-1]}
    print(f"phase 22 python examples/torch_quickstart.py: exit 0, last line "
          f"OK, {runs['quickstart_subprocess']['seconds']:.3f} s", flush=True)

    ftc = load_twin("torch_fault_tolerant_consortium")
    out, lines, launches = timed("consortium", lambda: ftc.run(dev))
    coord, sup = out["coord"], out["supervisor"]
    check(lines[-1] == "OK" and coord.converged and out["r2"] > 0.999,
          f"phase 22 consortium: {lines[-3:]}")
    on_dev(coord.beta, "the consortium's beta")
    # the coordinator's fused round keeps its float64 reference summaries
    # by default in both packages (per-round parity with the loop oracle):
    # K1 and K2 a round, no K3; every attempt ran (no retry here)
    check(sup.total_retries == 0, "phase 22 consortium: retries")
    want(launches, "consortium", K1=coord.iteration, K2=coord.iteration)
    runs["consortium"].update(
        iterations=coord.iteration,
        centers=sorted(c.index for c in coord.centers if c.online),
        degraded=sum(1 for r in sup.rounds if r.degraded), r2=out["r2"])

    sg = load_twin("torch_smart_grid_selection")
    out, lines, launches = timed("smart_grid", lambda: sg.run(dev))
    rep = out["report"]
    check(lines[-1].startswith("OK") and rep.lambda_1se >= rep.lambda_best,
          f"phase 22 smart grid: {lines[-3:]}")
    on_dev(out["coord"].study.beta, "the smart grid's refit beta")
    if on_card:
        check_path_launches(launches, rep.rounds_total, "phase 22 smart grid")
    runs["smart_grid"].update(
        rounds=rep.rounds_total, lambda_best=rep.lambda_best,
        lambda_1se=rep.lambda_1se, selected=out["selected"],
        bytes_per_round=rep.bytes_per_round)

    lm = load_twin("torch_secure_lm_training")
    cfg7 = smoke_config("deepseek_7b")
    out, lines, launches = timed("secure_lm", lambda: lm.run(dev))
    check(lines[-1] == "OK" and out["device"] == str(dev),
          f"phase 22 secure LM: {lines[-3:]}")
    p1, p2 = out["phase1"], out["phase2"]
    check((p1["steps"], p2["steps"]) == (10, 5)
          and all(np.isfinite(p1["losses"] + p2["losses"])),
          f"phase 22 secure LM: steps {p1['steps']}, {p2['steps']}")
    # K1 and K2 once a step; K7, K8a and K8b once a layer an institution
    # (the smoke config runs without remat)
    att = k7_layers(cfg7, 64) * 4 * 15
    want(launches, "secure_lm", K1=15, K2=15, K7=att, K8a=att, K8b=att)
    runs["secure_lm"].update(losses=p1["losses"] + p2["losses"],
                             bytes_per_step=p1["bytes_per_step"][0])
    same, _, launches = timed("secure_lm_resume_check",
                              lambda: lm.resume_against_uninterrupted(dev))
    check(same["losses_equal"] and same["state_equal"],
          "phase 22 secure LM: the resumed steps 10-14 vs the "
          f"uninterrupted run: losses {same['resumed']['losses']} vs "
          f"{same['whole']['losses'][10:]}, final state equal "
          f"{same['state_equal']}")
    att = k7_layers(cfg7, 64) * 4 * 20
    want(launches, "secure_lm_resume_check", K1=20, K2=20, K7=att, K8a=att,
         K8b=att)
    runs["secure_lm_resume_check"].update(
        losses_equal=same["losses_equal"], state_equal=same["state_equal"],
        resumed_losses=same["resumed"]["losses"])

    # -- (b) launch.train's command line at paper size ------------------------

    def logreg(label, argv, study):
        d, s, n = EP_STUDIES[study]
        rep, _, launches = timed(label, lambda: train.main(
            ["--arch", "logreg_paper", "--scale", scale] + argv
            + ["--device", str(dev)]))
        agg = SecureCollective(scheme=ShamirScheme(2, 3, backend="kernel"))
        rb = agg.round_bytes(d, s, "both", include_count=True,
                             num_live_centers=3)
        check(rep["converged"] and rep["r2_vs_gold"] > 0.999999
              and rep["iterations"] <= 10
              and rep["bytes_transmitted"] == rep["iterations"] * rb,
              f"phase 22 {label}: {rep}")
        check(rep["features"] == d and (smoke or rep["samples"] == n),
              f"phase 22 {label}: {rep['samples']} x {rep['features']}")
        device_field(rep, label)
        # K1 and K2 a round; the coordinator's reference summaries (no K3)
        want(launches, label, K1=rep["iterations"], K2=rep["iterations"])
        runs[label].update(
            samples=rep["samples"], features=d, iterations=rep["iterations"],
            r2_vs_gold=rep["r2_vs_gold"],
            max_abs_err_vs_gold=rep["max_abs_err_vs_gold"],
            fit_seconds=rep["total_seconds"],
            fit_seconds_per_iteration=rep["total_seconds"]
            / rep["iterations"], bytes_per_round=rb,
            bytes_transmitted=rep["bytes_transmitted"])
        return rep

    for study in EP_STUDIES:
        logreg(f"train_fused_{study}", ["--study", study] + EP_FUSED, study)

    scan_argv = ["--study", "synthetic", "--rounds", "scan"] + EP_FUSED
    scan = logreg("train_scan_synthetic", scan_argv, "synthetic")
    # again, counting the fit's host reads: the counter runs inside the
    # coordinator's rounds only (not the study's draw or the gold fit)
    counter = transfer_counter(dev)
    step_fn = StudyCoordinator.step

    def counted_step(self, *a, **kw):
        with counter:
            return step_fn(self, *a, **kw)

    StudyCoordinator.step = counted_step
    try:
        counted = logreg("train_scan_synthetic_counted", scan_argv,
                         "synthetic")
    finally:
        StudyCoordinator.step = step_fn
    step_run = runs["train_fused_synthetic"]
    check(scan["iterations"] == step_run["iterations"]
          and scan["bytes_transmitted"] == step_run["bytes_transmitted"],
          f"phase 22 scan vs step rounds: {scan['iterations']} vs "
          f"{step_run['iterations']}")
    # the fit is one block of 50 slots: one marked read-back, one
    # `settled` read a slot (the documented deviation, ROADMAP item 12)
    # and, with overflow_check armed as the command line arms it, one
    # headroom maximum a round (the JAX package's is a debug callback);
    # no other read and no upload
    reads = dict(counter.reads)
    fit_reads = {"core/scanfit.py:run_fit_block": 1,
                 "core/scanfit.py:scan_rounds": 50,
                 "core/fixed_point.py:check_headroom": counted["iterations"]}
    if not on_card:  # a copy from the CPU to the CPU is no copy
        del fit_reads["core/scanfit.py:run_fit_block"]
    check(reads == fit_reads and not counter.uploads,
          f"phase 22 scan: the fit's host reads by site {reads} (want "
          f"{fit_reads}), uploads {dict(counter.uploads)} (want none)")
    runs["train_scan_synthetic_counted"]["fit_host_reads_by_site"] = reads

    rep, _, launches = timed("train_select_insurance", lambda: train.main(
        ["--arch", "logreg_paper", "--scale", scale] + EP_SELECT
        + ["--device", str(dev)]))
    check(rep["lambda_1se"] >= rep["lambda_best"]
          and rep["lambda_1se"] in rep["lambdas"] and rep["folds"] == 3,
          f"phase 22 select: {rep}")
    device_field(rep, "select")
    if on_card:
        check_path_launches(launches, rep["secure_rounds"],
                            "phase 22 select")
    runs["train_select_insurance"].update(
        rounds=rep["secure_rounds"], lambda_best=rep["lambda_best"],
        lambda_1se=rep["lambda_1se"], bytes_per_round=rep["bytes_per_round"],
        nonzero_coefs=rep["nonzero_coefs"])

    rep, _, launches = timed("train_l1_parkinsons_total", lambda: train.main(
        ["--arch", "logreg_paper", "--scale", scale] + EP_L1
        + ["--device", str(dev)]))
    check(rep["converged"] and 0 < rep["nonzero_coefs"] <= 20,
          f"phase 22 l1: {rep}")
    device_field(rep, "l1")
    # secure_fit with its default aggregator: the reference loop
    want(launches, "train_l1_parkinsons_total")
    runs["train_l1_parkinsons_total"].update(
        iterations=rep["iterations"], nonzero_coefs=rep["nonzero_coefs"])

    with tempfile.TemporaryDirectory() as tmp:
        whole, stopped = pathlib.Path(tmp) / "whole", \
            pathlib.Path(tmp) / "stopped"
        ck = ["--study", "parkinsons.total"] + EP_FUSED
        rep = logreg("train_checkpointed_parkinsons_total",
                     ck + ["--checkpoint-dir", str(whole)],
                     "parkinsons.total")
        n = rep["iterations"]
        shutil.copytree(whole, stopped)
        for p in stopped.iterdir():  # stopped after round n - 2
            if int(p.name[5:15]) > n - 2:
                p.unlink()
        res, _, launches = timed("train_resumed_parkinsons_total",
                                 lambda: train.main(
                                     ["--arch", "logreg_paper", "--scale",
                                      scale] + ck + [
                                         "--checkpoint-dir", str(stopped),
                                         "--resume", "--device", str(dev)]))
        final = f"ckpt_{n:010d}.npz"
        with np.load(whole / final) as a, np.load(stopped / final) as b:
            same_beta = np.array_equal(a["beta"], b["beta"])
        check(res["iterations"] == n and res["converged"] and same_beta
              and res["max_abs_err_vs_gold"] == rep["max_abs_err_vs_gold"],
              f"phase 22 resumed logreg: {res}")
        want(launches, "train_resumed_parkinsons_total", K1=2, K2=2)
        runs["train_resumed_parkinsons_total"].update(
            resumed_at=n - 2, iterations=n, beta_bit_identical=same_beta)

    rep, _, launches = timed("train_lm_fail_compress",
                             lambda: train.main(EP_FAIL
                                                + ["--device", str(dev)]))
    check(rep["steps"] == 4 and all(np.isfinite(rep["losses"])),
          f"phase 22 LM --fail-at 2 --compress: {rep}")
    device_field(rep, "LM --fail-at")
    # four institutions for steps 0-1, three after the failure at step 2
    att = k7_layers(smoke_config("qwen2_5_32b"), 32) * (4 + 4 + 3 + 3)
    want(launches, "train_lm_fail_compress", K7=att, K8a=att, K8b=att)
    runs["train_lm_fail_compress"]["losses"] = rep["losses"]

    # -- (c) launch.serve's command line ---------------------------------------
    for arch in EP_SERVE:
        rep, _, launches = timed(f"serve_{arch}", lambda a=arch: serve.main(
            ["--arch", a, "--device", str(dev)]))
        check(rep["tokens_generated"] == 8 * 16 and rep["batches"] == 2
              and rep["nonfinite_logits"] == 0, f"phase 22 serve {arch}: "
              f"{rep}")
        device_field(rep, f"serve {arch}")
        att = k7_layers(smoke_config(arch), 32) * 2  # a prefill a batch
        want(launches, f"serve_{arch}", K7=att)
        runs[f"serve_{arch}"].update(
            tokens_per_second=rep["tokens_per_second"],
            prefill_seconds=rep["prefill_seconds"],
            decode_seconds=rep["decode_seconds"])

    # -- (d) an institution's CPU tensors under a coordinator on the card ----
    parts = generate_synthetic(0, 5, 2_000, 8, device="cpu").parts
    counter = transfer_counter(dev)
    with counter:
        coord = StudyCoordinator(
            [Institution(f"i{j}", X, y) for j, (X, y) in enumerate(parts)],
            aggregator=SecureCollective(backend="kernel"), fused=True,
            device=dev)
        at_start = sum(counter.uploads.values())
        for _ in range(3):
            coord.step()
    per_round = sum(counter.uploads.values()) - at_start
    if on_card:
        check(at_start == 2 * len(parts) and per_round == 0,
              f"phase 22 CPU institutions: {at_start} uploads at the start, "
              f"{per_round} in 3 rounds: {dict(counter.uploads)}")
    runs["cpu_institutions"] = {"uploads_at_construction": at_start,
                                "uploads_in_3_rounds": per_round}
    print(f"phase 22 CPU institutions under a coordinator on {dev}: "
          f"{at_start} uploads at construction, {per_round} in 3 rounds",
          flush=True)
    return {"runs": runs, "scale": float(scale),
            "phase_seconds": time.perf_counter() - t_phase, "card": smi}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="also time and profile the fit and the path "
                         "(phase 10)")
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--trace", default="",
                    help="with --profile, write the Chrome trace here")
    ap.add_argument("--only", type=int, choices=(18, 19, 20, 21, 22),
                    default=None,
                    help="after the card and the build, run only this "
                         "phase (no kernels line, no last line)")
    args = ap.parse_args()
    t_script = time.perf_counter()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    from repro_torch.core.batched_summaries import (
        batched_local_summaries, pack_partitions,
    )
    from repro_torch.core.collective import SecureCollective
    from repro_torch.core.field import FIELD31, FIELD_WIDE, fsum
    from repro_torch.core.flatbuf import pack_pytree_batched
    from repro_torch.core.newton import centralized_fit, secure_fit
    from repro_torch.core.protocol import Institution
    from repro_torch.data import generate_synthetic, ragged_sizes, split_rows
    from repro_torch.kernels import _build, work
    from repro_torch.kernels.fused_irls import fused_irls_cv_kernel, \
        fused_irls_cv_plain, fused_irls_kernel, fused_irls_plain
    from repro_torch.selection import SelectionCoordinator, secure_cv_path
    from repro_torch.kernels.fused_irls import gram_hessian_kernel
    from repro_torch.kernels.shamir_poly import encode_share_kernel, \
        encode_share_plain, share_kernel, share_plain
    from repro_torch.kernels.shamir_reconstruct import reconstruct_kernel, \
        reconstruct_plain
    from repro_torch.kernels.flash_attention import flash_attention_kernel, \
        flash_attention_plain
    from repro_torch.kernels.flash_attention_bwd import flash_dkdv_kernel, \
        flash_dkdv_plain, flash_dq_kernel, flash_dq_plain

    # full float32 products everywhere: the plain versions and the
    # library yardstick must not drop to TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    counters = (encode_share_kernel, reconstruct_kernel, fused_irls_kernel,
                fused_irls_cv_kernel, share_kernel, gram_hessian_kernel,
                flash_attention_kernel, flash_dq_kernel, flash_dkdv_kernel)

    def reset_counts():
        for k in counters:
            k.launches = 0

    def read_counts():
        return {k.__name__: k.launches for k in counters}

    counts = (reset_counts, read_counts)

    # -- 1. the card -------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")

    # -- 2. build -------------------------------------------------------------
    t0 = time.perf_counter()
    _build.library()
    ptxas = [ln.strip() for ln in _build.build_log().read_text().splitlines()
             if "registers" in ln or "spill" in ln]
    print(f"build: {time.perf_counter() - t0:.1f} s; ptxas: "
          + " | ".join(ptxas))
    log_text = _build.build_log().read_text()
    flash = flash_ptxas(log_text, _build.library())
    print(json.dumps({"flash_ptxas": flash}))
    irls_rep = irls_ptxas(log_text, _build.library())
    print(json.dumps({"irls_ptxas": irls_rep}))
    for r in flash + irls_rep["kernels"]:
        check(r["registers"] is not None and r["spill_stores"] is not None,
              f"no ptxas report for {r['kernel']}")
        check(r["spill_stores"] == r["spill_loads"] == 0,
              f"{r['kernel']} spills: {r}")
    shamir_rep = shamir_ptxas(log_text, _build.build())
    print(json.dumps({"shamir_ptxas": shamir_rep}))
    for r in shamir_rep["kernels"]:
        check(r["registers"] is not None and r["spill_stores"] is not None,
              f"no ptxas report for {r['kernel']}")
        check(r["spill_stores"] == r["spill_loads"] == r["stack_frame"] == 0,
              f"{r['kernel']} spills or keeps a local array: {r}")
    # K1 f32/f64 and K2, each on its struct and its table path, and K4,
    # none with a division sequence
    check(len(shamir_rep["kernels"]) == 7
          and len(shamir_rep["division_sass"]) == 7
          and "K4" in shamir_rep["division_sass"],
          f"K1/K2/K4 instantiations in the ptxas report and SASS: "
          f"{shamir_rep}")
    for name, c in shamir_rep["division_sass"].items():
        check(c["instructions"] > 0 and c["mufu_rcp"] == c["calls"] == 0,
              f"{name}: an emulated division in its SASS: {c}")
    check(len(flash) == 18, f"{len(flash)} flash kernels in the ptxas report")
    # rows 4, Gram 2 and the reduce for K3 and K5; K6 has no rows kernel
    check(len(irls_rep["kernels"]) == 17,
          f"{len(irls_rep['kernels'])} IRLS kernel instantiations (K3 7, "
          "K5 7, K6 3) in the ptxas report")
    if args.only == 18:
        training_families_phase(dev, smi, counts,
                                args.repeats if args.profile else 0)
        return 0
    if args.only == 19:
        d2a_k7_err, _ = check_k7(dev, D2A_K7_CASES, ())
        print(f"K7 vs plain: {[c[0] for c in D2A_K7_CASES]} within "
              f"tolerance, max|do| {d2a_k7_err:.3e}")
        print(json.dumps({"d2a": d2a_phase(dev, smi, counts)}))
        return 0
    if args.only == 20:
        d2b_k8_err, _ = check_k8(dev, D2B_K8_CASES, ())
        print(f"K8a/K8b vs plain: {[c[0] for c in D2B_K8_CASES]} within "
              f"tolerance, max|d(dq, dk, dv)| {d2b_k8_err:.3e}")
        print(json.dumps({"d2b": d2b_phase(dev, smi, counts)}))
        return 0
    if args.only == 21:
        print(json.dumps({"dry_run": dryrun_phase(dev, smi, counts)}))
        return 0
    if args.only == 22:
        print(json.dumps({"entry_points": entry_points_phase(dev, smi,
                                                             counts)}))
        return 0

    # -- the study (Algorithm 3, drawn on the card from a seed) -------------
    study = generate_synthetic(SEED, num_institutions=1,
                               records_per_institution=N, dim=D, device=dev)
    X_all, y_all = study.pooled()
    parts = split_rows(X_all, y_all, ragged_sizes(N, S))
    packed = pack_partitions(parts)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    beta = 0.02 * torch.randn((D,), generator=gen, dtype=torch.float64,
                              device=dev)

    # -- 3. kernels vs plain versions --------------------------------------
    k3_args = (beta, packed.X, packed.X32, packed.y, packed.counts)
    H, g, dv = fused_irls_kernel(*k3_args)
    check(all(torch.equal(a, b) for a, b in
              zip((H, g, dv), fused_irls_kernel(*k3_args))),
          "K3: two calls bit-identical")
    Hp, gp, dvp = fused_irls_plain(*k3_args)
    n_max = packed.X.shape[1]
    mask = (torch.arange(n_max, device=dev)[None, :]
            < packed.counts[:, None]).double()
    z = torch.einsum("snd,d->sn", packed.X, beta)
    p = torch.sigmoid(z)
    g_scale = torch.einsum("snd,sn->sd", packed.X.abs(),
                           ((packed.y - p) * mask).abs())
    dev_scale = ((packed.y * z - torch.logaddexp(torch.zeros_like(z), z))
                 * mask).abs().sum(dim=1)
    dH = float((H - Hp).abs().max())
    check(dH <= 2e-5 * float(Hp.abs().max()), f"K3 H err {dH}")
    H64 = gram_f64(packed.X32, (p * (1 - p) * mask).float())
    k3_vs_f64 = (float((H - H64).abs().max()), float((Hp - H64).abs().max()))
    check(bool(((g - gp).abs() <= 1e-12 * g_scale).all()), "K3 g err")
    check(bool(((dv - dvp).abs() <= 1e-12 * dev_scale).all()), "K3 dev err")
    k3_err = dH
    # d = 130 (two H tiles per edge) with ragged counts
    Xb = torch.randn((3, 2500, 130), generator=gen, dtype=torch.float64,
                     device=dev)
    yb = (torch.rand((3, 2500), generator=gen, device=dev) < 0.4).double()
    cb = torch.tensor([1000, 37, 2500], dtype=torch.int32, device=dev)
    bb = 0.05 * torch.randn((130,), generator=gen, dtype=torch.float64,
                            device=dev)
    small = (bb, Xb, Xb.float(), yb, cb)
    Hb, gb, dvb = fused_irls_kernel(*small)
    Hbp, gbp, dvbp = fused_irls_plain(*small)
    check(float((Hb - Hbp).abs().max()) <= 2e-5 * float(Hbp.abs().max()),
          "K3 d=130 H err")
    check(float((gb - gbp).abs().max()) <= 1e-9, "K3 d=130 g err")
    check(float((dvb - dvbp).abs().max()) <= 1e-9, "K3 d=130 dev err")

    sm = batched_local_summaries(beta, packed, backend="kernel")
    tree = {"deviance": sm.deviance, "gradient": sm.gradient,
            "hessian": sm.hessian}
    buf, layout = pack_pytree_batched(tree)
    rows = layout.rows
    x = buf.reshape(S * rows, 128).contiguous()  # (1088, 128) f64
    check(tuple(x.shape) == (1088, 128), f"protect payload {x.shape}")
    cap = FIELD_WIDE.max_signed / 2**FRAC_BITS
    edges = torch.tensor([0.5, 1.5, 2.5, -0.5, -1.5, 0.0, -0.0, cap, -cap,
                          2 * cap, -2 * cap, 1e20, -1e20], dtype=torch.float64,
                         device=dev)
    x_edge = x.clone()
    x_edge.view(-1)[:13] = edges * 2**-FRAC_BITS
    x_edge.view(-1)[13:26] = edges
    x31 = (x / x.abs().max() * 3.0).contiguous()  # inside FIELD31 capacity

    def coeffs_for(field, t, n_rows):
        return torch.stack([
            torch.randint(0, p, (t - 1, n_rows, 128), generator=gen,
                          device=dev) for p in field.moduli
        ]).to(torch.int32)

    coeffs = coeffs_for(FIELD_WIDE, 2, S * rows)
    k1_cases = [
        (x, coeffs, FIELD_WIDE, (1, 2, 3)),
        (x_edge, coeffs, FIELD_WIDE, (1, 2, 3)),
        (x_edge.float(), coeffs, FIELD_WIDE, (1, 2, 3)),
        (x, coeffs, FIELD_WIDE, (2,)),
        (x_edge, coeffs, FIELD_WIDE, (1, 3)),
        (x31, coeffs_for(FIELD31, 2, S * rows), FIELD31, (1, 2, 3)),
        (x31.float(), coeffs_for(FIELD31, 2, S * rows), FIELD31, (1, 2, 3)),
    ]
    k1_err = 0.0
    for xi, ci, field, pts in k1_cases:
        got = encode_share_kernel(xi, ci, field.moduli, FRAC_BITS, pts)
        want = encode_share_plain(xi, ci, field.moduli, FRAC_BITS, pts)
        check(torch.equal(got, want),
              f"K1 {field.name} {xi.dtype} points {pts}")
        k1_err = max(k1_err, float((got.long() - want.long()).abs().max()))
    shares = encode_share_kernel(x, coeffs, FIELD_WIDE.moduli, FRAC_BITS,
                                 (1, 2, 3))  # (3, 2, 1088, 128)
    aggd = fsum(shares.reshape(3, 2, S, rows, 128), FIELD_WIDE, axis=2,
                residue_axis=1)  # (3, 2, 136, 128)
    shares31 = encode_share_kernel(x31, coeffs_for(FIELD31, 2, S * rows),
                                   FIELD31.moduli, FRAC_BITS, (1, 2, 3))
    aggd31 = fsum(shares31.reshape(3, 1, S, rows, 128), FIELD31, axis=2,
                  residue_axis=1)
    k2_err = 0.0
    for agg_buf, field in ((aggd, FIELD_WIDE), (aggd31, FIELD31)):
        for pts in ((1, 2), (1, 3), (2, 3)):
            sel = agg_buf[[q - 1 for q in pts]].contiguous()
            for fb in (FRAC_BITS, None):
                got = reconstruct_kernel(sel, pts, field.moduli, fb)
                want = reconstruct_plain(sel, pts, field.moduli, fb)
                check(torch.equal(got, want),
                      f"K2 {field.name} points {pts} frac_bits {fb}")
                k2_err = max(k2_err, float((got.double() - want.double())
                                           .abs().max()))
    revealed = reconstruct_kernel(aggd[[0, 1]].contiguous(), (1, 2),
                                  FIELD_WIDE.moduli, FRAC_BITS)
    want_sum = buf.sum(dim=0)
    check(float((revealed - want_sum).abs().max()) <= (S + 1) / 2**FRAC_BITS,
          "K2 reveal vs plaintext sum")
    k5_err, k5_args, k5_vs_f64 = check_k5(dev, gen, packed, beta)
    k4_cases = check_k4(dev, gen)
    p_all = torch.sigmoid(X_all @ beta)
    k6_err, k6_vs_f64, k6_args = check_k6(X_all, p_all * (1.0 - p_all))
    torch.cuda.synchronize()
    print("kernels vs plain: K1 bit-identical (2 fields, f32/f64, points, "
          f"edges); K2 bit-identical (3 point sets, R=1 and 2, residues); "
          f"K3 max|dH| {dH:.3e} (<= 2e-5 max|H| {float(Hp.abs().max()):.4e})"
          ", g/dev within 1e-12 of the abs sums, two calls bit-identical; "
          "d=130 ok; K5 max|dH| "
          f"{k5_err:.3e} over the path (C=5), refit (C=1) and ragged "
          "(d=130, count > N_max) shapes, g/dev within 1e-10, held-out "
          "counts exact, two calls bit-identical; K4 bit-identical "
          f"(n={LEAF_N}, R=2, (t, w) = (2, 3) and (3, 5), (2, 3) at "
          "offsets 1 and 3); K6 max|dH| "
          f"{k6_err:.3e} at (25000 x 128) and "
          f"({N} x 128) (<= 2e-5 max|H|), two calls bit-identical")
    print("max|H - float64 sum of the float32 products| (kernel, plain): "
          f"K3 {k3_vs_f64}; K5 {k5_vs_f64}; K6 {k6_vs_f64}")
    # the tensor-core Gram is no farther from the float64 sum than the
    # plain version's exact float32 products
    for name, (kern, plain) in [("K3", k3_vs_f64), *(
            (f"K5 {k}", v) for k, v in k5_vs_f64.items()), *(
            (f"K6 {k}", v) for k, v in k6_vs_f64.items())]:
        check(kern <= plain, f"{name}: H {kern} from the float64 sum, the "
              f"plain version's {plain}")

    # -- 4. the main path: secure_fit at the acceptance config --------------
    agg = SecureCollective(backend="kernel")
    fit_kw = dict(protect=PROTECT, aggregator=agg, summaries_backend="kernel",
                  device=dev)
    secure_fit(parts, **fit_kw)  # warm-up: allocator, pack cache
    gold = centralized_fit(X_all, y_all, device=dev)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    res = secure_fit(parts, **fit_kw)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = read_counts()
    round_bytes = agg.round_bytes(D, S, PROTECT)
    err = float(abs(res.beta - gold.beta).max())
    check(res.converged, "secure_fit converged")
    check(round_bytes == 3_342_336, f"round bytes {round_bytes}")
    check(res.bytes_transmitted == res.iterations * 3_342_336,
          f"bytes {res.bytes_transmitted} for {res.iterations} iterations")
    check(err <= (S + 1) / 2**FRAC_BITS, f"beta err vs centralized {err}")
    check(all(launches[k.__name__] == res.iterations
              for k in counters[:3])
          and all(launches[k.__name__] == 0 for k in counters[3:]),
          f"launches {launches} != iterations {res.iterations}")
    print(f"secure_fit: S={S} d={D} N={N} protect={PROTECT} iterations "
          f"{res.iterations} converged {res.converged} bytes "
          f"{res.bytes_transmitted} max|beta - centralized| {err:.3e} "
          f"seconds {fit_s:.4f} per-iter {fit_s / res.iterations:.4f} "
          f"launches {launches}")

    # the same fit in scan blocks of 4 rounds: one trace read per block
    reset_counts()
    t0 = time.perf_counter()
    scan = secure_fit(parts, rounds="scan", rounds_per_sync=4, **fit_kw)
    torch.cuda.synchronize()
    scan_s = time.perf_counter() - t0
    scan_launches = read_counts()
    scan_err = float(abs(scan.beta - res.beta).max())
    check(scan.converged and scan.iterations == res.iterations,
          f"scan iterations {scan.iterations} vs step {res.iterations}")
    check(scan.bytes_transmitted == res.bytes_transmitted,
          f"scan bytes {scan.bytes_transmitted}")
    check(scan_err <= QUANT_TOL, f"scan beta vs step {scan_err}")
    check(all(scan_launches[k.__name__] == scan.iterations
              for k in counters[:3]), f"scan launches {scan_launches}")
    print(f"secure_fit rounds=scan (blocks of 4): iterations "
          f"{scan.iterations} bytes {scan.bytes_transmitted} max|beta - "
          f"step beta| {scan_err:.3e} seconds {scan_s:.4f} per-iter "
          f"{scan_s / scan.iterations:.4f} launches {scan_launches}")

    # -- 5. the secure cross-validated lambda path ---------------------------
    lambdas = [float(v) for v in np.logspace(1.5, -1.5, NUM_LAMBDAS)]
    path_kw = dict(num_folds=FOLDS, protect=PROTECT, aggregator=agg,
                   lam_block=LAM_BLOCK, rounds_per_sync=ROUNDS_PER_SYNC,
                   max_rounds=MAX_ROUNDS, refit=True, seed=SEED,
                   summaries_backend="kernel")

    def run_path():
        return secure_cv_path(parts, lambdas, device=dev, **path_kw)

    secure_cv_path(parts, lambdas[:1], device=dev, **path_kw)  # warm-up
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    rep = run_path()
    torch.cuda.synchronize()
    path_s = time.perf_counter() - t0
    path_launches = read_counts()
    refit_bytes = agg.round_bytes(D, S, PROTECT, include_count=True,
                                  num_configs=1, extra_scalars=3)
    check(agg.round_bytes(D, S, PROTECT, include_count=True,
                          num_configs=FOLDS * LAM_BLOCK, extra_scalars=3)
          == PATH_ROUND_BYTES, "path round_bytes model")
    check(bool(rep.fold_converged.all()), "every fold configuration "
          f"converged: {rep.fold_converged.tolist()}")
    check(rep.refit_rounds < MAX_ROUNDS, "the refit converged "
          f"({rep.refit_rounds} rounds)")
    check(rep.bytes_per_round == PATH_ROUND_BYTES,
          f"path bytes per round {rep.bytes_per_round}")
    sweep_rounds = rep.rounds_total - rep.refit_rounds
    check(rep.bytes_total == sweep_rounds * PATH_ROUND_BYTES
          + rep.refit_rounds * refit_bytes, f"path bytes {rep.bytes_total}")
    gold_1se = centralized_fit(X_all, y_all, lam=rep.lambda_1se, device=dev)
    refit_err = float(abs(rep.beta - gold_1se.beta).max())
    check(refit_err <= QUANT_TOL, f"refit beta vs centralized {refit_err}")
    check_path_launches(path_launches, rep.rounds_total, "secure_cv_path")
    print(f"lambda path: S={S} d={D} N={N} L={NUM_LAMBDAS} K={FOLDS} "
          f"protect={PROTECT} rounds {rep.rounds_total} (refit "
          f"{rep.refit_rounds}) lambda_best {rep.lambda_best:.6g} "
          f"lambda_1se {rep.lambda_1se:.6g} bytes/round "
          f"{rep.bytes_per_round} bytes {rep.bytes_total} max|refit - "
          f"centralized(lambda_1se)| {refit_err:.3e} seconds {path_s:.4f} "
          f"per-round {path_s / rep.rounds_total:.5f} launches "
          f"{path_launches}; the JAX package's CPU run (its own folds): "
          f"{JAX_PATH}")

    # the deployment shape: institutions named by index get the same folds
    reset_counts()
    t0 = time.perf_counter()
    sel = SelectionCoordinator(
        [Institution(str(j), X, y) for j, (X, y) in enumerate(parts)],
        lambdas, device=dev, **path_kw)
    crep = sel.run_path()
    torch.cuda.synchronize()
    coord_s = time.perf_counter() - t0
    coord_launches = read_counts()
    coord_err = float(abs(crep.beta - rep.beta).max())
    check(bool(crep.fold_converged.all())
          and bool(sel.state["refit_converged"]), "coordinator converged")
    check((crep.lambda_best, crep.lambda_1se, crep.rounds_total,
           crep.bytes_total) == (rep.lambda_best, rep.lambda_1se,
                                 rep.rounds_total, rep.bytes_total),
          "coordinator report vs secure_cv_path")
    check(coord_err <= QUANT_TOL, f"coordinator refit beta {coord_err}")
    check_path_launches(coord_launches, crep.rounds_total,
                        "SelectionCoordinator")
    print(f"SelectionCoordinator.run_path: rounds {crep.rounds_total} "
          f"lambda_1se {crep.lambda_1se:.6g} bytes {crep.bytes_total} "
          f"max|beta - secure_cv_path beta| {coord_err:.3e} seconds "
          f"{coord_s:.4f} launches {coord_launches}")

    # -- 6. leaf-wise Shamir through the kernel scheme (K4, K2 residues) ---
    share_s, rec_s, leaf_launches = leafwise_phase(dev, counts)
    print(f"leaf-wise Shamir: n={LEAF_N} institutions {LEAF_INST} 2-of-3 "
          f"over {FIELD_WIDE.name}: every reveal from (1,2), (1,3), (2,3) "
          f"and the per-leaf tree reveal equals the decoded exact sum; "
          f"share seconds {share_s} (4 calls) reconstruct+reveal "
          f"seconds {rec_s} (6 reveals) launches {leaf_launches}")

    # -- 7. the weighted Gram through ops.gram_hessian (K6) -----------------
    gram_s, gram_launches, gram_dsum, gram_max = gram_phase(parts, beta,
                                                            counts)
    print(f"ops.gram_hessian: {S} institutions + the pooled study, "
          f"max|sum of institution Grams - pooled| {gram_dsum:.3e} (max|H| "
          f"{gram_max:.4e}) seconds {gram_s:.4f} launches {gram_launches}")

    # -- 8. fault-tolerant supervision --------------------------------------
    from repro_torch.core.newton import SecureFitDriver
    from repro_torch.runtime import FailureInjector, RoundSupervisor

    sup_out = supervisor_phase(dev, agg)
    print(json.dumps({"supervisor": sup_out, "card": smi}))
    drv = SecureFitDriver(parts, **fit_kw)
    sup = RoundSupervisor(drv, policy=_fault_policy(),
                          injector=FailureInjector(FIT_FAULTS))
    reset_counts()
    t0 = time.perf_counter()
    sres = sup.run(max_rounds=FAULT_MAX_ROUNDS)
    torch.cuda.synchronize()
    sfit_s = time.perf_counter() - t0
    sfit_launches = read_counts()
    check(np.array_equal(sres.beta, res.beta)
          and (sres.iterations, sres.bytes_transmitted)
          == (res.iterations, res.bytes_transmitted),
          "supervised secure_fit vs phase 4 (beta, iterations, bytes)")
    check([r.aborted_attempts for r in sup.rounds][2] == 1,
          "the mid-round loss aborted round 3 once")
    print(f"supervised SecureFitDriver ({FIT_FAULTS}): iterations "
          f"{sres.iterations} bytes {sres.bytes_transmitted} beta "
          "bit-identical to phase 4, retries "
          f"{sup.total_retries} aborted "
          f"{sum(r.aborted_attempts for r in sup.rounds)} seconds "
          f"{sfit_s:.4f} launches {sfit_launches}")
    ssel = SelectionCoordinator(
        [Institution(str(j), X, y) for j, (X, y) in enumerate(parts)],
        lambdas, device=dev, **path_kw)
    sup = RoundSupervisor(ssel, policy=_fault_policy(),
                          injector=FailureInjector(PATH_FAULTS))
    t0 = time.perf_counter()
    srep = sup.run(max_rounds=50)
    torch.cuda.synchronize()
    spath_s = time.perf_counter() - t0
    check((srep.lambda_best, srep.lambda_1se, srep.rounds_total,
           srep.bytes_total) == (rep.lambda_best, rep.lambda_1se,
                                 rep.rounds_total, rep.bytes_total),
          "supervised selection report vs phase 5")
    check(np.array_equal(srep.beta, crep.beta),
          "supervised selection refit beta vs phase 5's coordinator")
    print(f"supervised SelectionCoordinator ({PATH_FAULTS}): chunks "
          f"{len(sup.rounds)} rounds {srep.rounds_total} lambda_1se "
          f"{srep.lambda_1se:.6g} bytes {srep.bytes_total} refit beta "
          f"bit-identical to phase 5, retries {sup.total_retries} aborted "
          f"{sum(r.aborted_attempts for r in sup.rounds)} seconds "
          f"{spath_s:.4f}")

    # -- 9. multi-study rounds -----------------------------------------------
    ms_out, ms_run = multistudy_phase(dev, agg, parts, counts)
    print(json.dumps({"multistudy": ms_out, "card": smi}))

    # -- 10. serving at Qwen2.5-32B's full width (K7 on every prefill) -----
    k7_err, k7_args = check_k7(dev)
    print(f"K7 vs plain: {[c[0] for c in K7_CASES]} within tolerance, "
          f"max|do| {k7_err:.3e}")
    serve_out, serve_run, serve_tokens = serving_phase(dev, smi, counts)
    print(json.dumps({"serve": serve_out}))

    # -- 11. where the time goes (--profile) --------------------------------
    if args.profile:
        profiles = {
            "secure_fit": profile_run(
                lambda: secure_fit(parts, **fit_kw), lambda r: r.iterations,
                "secure_fit", args.repeats, args.trace),
            "lambda_path": profile_run(
                run_path, lambda r: r.rounds_total, "lambda_path",
                args.repeats),
            "multistudy": profile_run(
                ms_run, lambda r: MS_ROUNDS, "multistudy", args.repeats)}
        for prof in profiles.values():
            print(json.dumps({"profile": prof, "card": smi}))
        # each summaries kernel's time lands in its own category only: a
        # fit or multi-study round runs K3 and never K5, a path round K5
        # and never K3
        for run, (want, never) in {
                "secure_fit": ("K3", "K5"), "multistudy": ("K3", "K5"),
                "lambda_path": ("K5", "K3")}.items():
            cats = [c.split()[0] for c in
                    profiles[run]["device_us_per_round_by_category"]]
            check(want in cats and never not in cats,
                  f"{run} profile categories {cats}: {want} without {never}")
        # K6 alone at one institution's shape and the pooled one, 20 calls
        # a run: its Gram kernel beside its reduce (the share of the
        # slices' partials)
        X6, w6 = k6_args
        for rows6 in (25_000, X6.shape[0]):
            print(json.dumps({"profile": profile_run(
                lambda n=rows6: [gram_hessian_kernel(X6[:n], w6[:n])
                                 for _ in range(20)],
                len, f"gram_hessian {rows6}x{D}", args.repeats),
                "card": smi}))
        # a round is one batch: its prefill and its decode steps
        print(json.dumps({"profile": profile_run(
            serve_run, lambda r: r[1]["batches"], "serve", args.repeats,
            categories=SERVE_CATEGORIES), "card": smi}))

    # -- 13. training at Qwen2.5-32B's full width (K7, K8a, K8b) -----------
    del serve_run  # the serving weights
    gc.collect()
    torch.cuda.empty_cache()
    k8_err, k8_args = check_k8(dev)
    print(f"K8a/K8b vs plain: {[c[0] for c in K8_CASES]} within tolerance, "
          f"max|d(dq, dk, dv)| {k8_err:.3e}")
    grad_out = grad_check(dev)
    print(json.dumps({"grad_check": grad_out, "card": smi}))
    train_out, train_run, adamw_run = training_phase(dev, smi, counts)
    print(json.dumps({"train": train_out}))
    if args.profile:
        print(json.dumps({"profile": profile_run(
            train_run, lambda r: 1, "train_step", args.repeats,
            categories=TRAIN_CATEGORIES), "card": smi}))
        print(json.dumps({"profile": profile_run(
            adamw_run(), lambda r: 1, "adamw_update", args.repeats,
            categories=ADAMW_CATEGORIES), "card": smi}))
    del train_run, adamw_run  # the training weights and moments
    gc.collect()
    torch.cuda.empty_cache()
    secure_out = secure_phase(dev, counts)
    print(json.dumps({"secure_train": secure_out, "card": smi}))

    # -- 14. the multi-device wires (torch.distributed) ----------------------
    gc.collect()
    torch.cuda.empty_cache()
    wires_out, wire_launches, cap_cases = wires_phase(dev, smi, counts)
    wire_gate = wires_out["gloo_ranks"].pop("privacy_gate")
    print(json.dumps({"wires": wires_out}))

    # -- 15. the privacy gate and the runtime audit -------------------------
    gate_out = privacy_gate_phase(dev, smi, counts, parts, fit_kw)
    gate_out["psum_specs_on_phase_14_ranks"] = {
        "ranks": WIRE_RANKS, "mesh_2d": WIRE_MESH_2D, **wire_gate}
    gate_out["phase_4_fit_seconds_per_round"] = fit_s / res.iterations
    print(json.dumps({"privacy_gate": gate_out}))

    # -- 16. the MoE and MLA families and the embeddings frontend -----------
    gc.collect()
    torch.cuda.empty_cache()
    print(f"phase 16: {torch.cuda.memory_allocated()} bytes on the card "
          "from earlier phases")
    f3a_k7_err, f3a_k7_args = check_k7(
        dev, F3A_K7_CASES, tuple(c[0] for c in F3A_K7_CASES))
    print(f"K7 vs plain: {[c[0] for c in F3A_K7_CASES]} within tolerance, "
          f"max|do| {f3a_k7_err:.3e}")
    moe_out = moe_check(dev)
    print(json.dumps({"moe_check": moe_out, "card": smi}))
    f3a_out = {}
    for arch, layers, n_params, f32_layers in F3A_MODELS:
        gc.collect()
        torch.cuda.empty_cache()
        f3a_out[arch] = f3a_phase(dev, smi, counts, arch, layers, n_params,
                                  f32_layers,
                                  args.repeats if args.profile else 0)

    # -- 17. the recurrent families (RWKV6, RG-LRU) -------------------------
    gc.collect()
    torch.cuda.empty_cache()
    f3b_k7_err, f3b_k7_args = check_k7(
        dev, F3B_K7_CASES, tuple(c[0] for c in F3B_K7_CASES))
    print(f"K7 vs plain: {[c[0] for c in F3B_K7_CASES]} within tolerance, "
          f"max|do| {f3b_k7_err:.3e}")
    rec_out = recurrent_check(dev)
    print(json.dumps({"recurrent_check": rec_out, "card": smi}))
    f3b_out = {}
    for arch, n_params, prompts in F3B_MODELS:
        gc.collect()
        torch.cuda.empty_cache()
        f3b_out[arch] = f3b_phase(dev, smi, counts, arch, n_params, prompts,
                                  args.repeats if args.profile else 0)

    # -- 18. training the F3a and F3b families ------------------------------
    f4_k8_err, f4_k8_args, f4_out, f4_secure = training_families_phase(
        dev, smi, counts, args.repeats if args.profile else 0)

    # -- 19. the sharded serving path ---------------------------------------
    gc.collect()
    torch.cuda.empty_cache()
    d2a_k7_err, d2a_k7_args = check_k7(
        dev, D2A_K7_CASES, tuple(c[0] for c in D2A_K7_CASES))
    print(f"K7 vs plain: {[c[0] for c in D2A_K7_CASES]} within tolerance, "
          f"max|do| {d2a_k7_err:.3e}")
    d2a_out = d2a_phase(dev, smi, counts, phase10_tokens=serve_tokens)
    print(json.dumps({"d2a": d2a_out}))

    # -- 20. gradients under a mesh -----------------------------------------
    gc.collect()
    torch.cuda.empty_cache()
    d2b_k8_err, d2b_k8_args = check_k8(
        dev, D2B_K8_CASES, tuple(c[0] for c in D2B_K8_CASES))
    print(f"K8a/K8b vs plain: {[c[0] for c in D2B_K8_CASES]} within "
          f"tolerance, max|d(dq, dk, dv)| {d2b_k8_err:.3e}")
    d2b_out = d2b_phase(dev, smi, counts)
    print(json.dumps({"d2b": d2b_out}))

    # -- 21. the shape dry run ------------------------------------------------
    gc.collect()
    torch.cuda.empty_cache()
    print(json.dumps({"dry_run": dryrun_phase(dev, smi, counts,
                                              d2b_out=d2b_out)}))

    # -- 22. the normal entry points ------------------------------------------
    gc.collect()
    torch.cuda.empty_cache()
    ep_out = entry_points_phase(dev, smi, counts)
    print(json.dumps({"entry_points": ep_out}))

    # -- 12. times and bounds ------------------------------------------------
    n1 = S * rows * 128
    rows_total = int(packed.counts.sum())
    k2_in = aggd[[0, 1]].contiguous()
    w32 = (p * (1 - p) * mask).float()
    Xm = packed.X32
    from repro_torch.kernels.ref import masked_cv_terms
    k5_b, k5_X, _, k5_y, k5_c, k5_f, k5_o = k5_args
    k5_terms = masked_cv_terms(k5_b, k5_X, k5_y, k5_c, k5_f, k5_o)
    # (C, S, N) float32 train-fold weights for the library call
    w5 = k5_terms[0].float()
    n_cfg = k5_b.shape[0]
    # (configuration, row) pairs on train rows: a held-out row has weight
    # 0 and adds nothing to H or g
    k5_train = n_cfg * rows_total - int(k5_terms[5].sum())
    X6, w6 = k6_args
    # K1 and K2 at the lambda path's round (C = 5 configurations x S
    # slices of 136 rows; K2 over the C aggregates) and at 2^24 elements,
    # each held bit-identical to its plain version there
    c_path = FOLDS * LAM_BLOCK
    x_path = x.repeat(c_path, 1).contiguous()  # (5440, 128) float64
    co_path = coeffs_for(FIELD_WIDE, 2, c_path * S * rows)
    sh_path = encode_share_kernel(x_path, co_path, FIELD_WIDE.moduli,
                                  FRAC_BITS, (1, 2, 3))
    k2_path = fsum(sh_path.reshape(3, 2, c_path, S, rows, 128), FIELD_WIDE,
                   axis=3, residue_axis=1)[[0, 1]].reshape(
                       2, 2, c_path * rows, 128).contiguous()
    big_rows = BIG_ELEMENTS // 128
    x_big = 3.0 * torch.randn((big_rows, 128), generator=gen,
                              dtype=torch.float64, device=dev)
    co_big = coeffs_for(FIELD_WIDE, 2, big_rows)
    k2_big = torch.empty((2, 2, big_rows, 128), dtype=torch.int32,
                         device=dev)
    for r, p_r in enumerate(FIELD_WIDE.moduli):
        k2_big[:, r].random_(0, p_r, generator=gen)

    def k1_shape(xs, cs, points=(1, 2, 3)):
        def run():
            return encode_share_kernel(xs, cs, FIELD_WIDE.moduli, FRAC_BITS,
                                       points)

        def plain():
            return encode_share_plain(xs, cs, FIELD_WIDE.moduli, FRAC_BITS,
                                      points)

        check(torch.equal(run(), plain()),
              f"K1 at {xs.numel()} elements, {len(points)} points vs its "
              "plain version")
        # payload and coefficients read once, each point's shares written
        return dict(run=run, plain=plain, library=None,
                    bound=bound(work.k1_encode_share(
                        xs.numel(), xs.element_size(), cs.shape[0],
                        cs.shape[1], len(points))))

    def k2_shape(shs, points=(1, 2)):
        def run():
            return reconstruct_kernel(shs, points, FIELD_WIDE.moduli,
                                      FRAC_BITS)

        def plain():
            return reconstruct_plain(shs, points, FIELD_WIDE.moduli,
                                     FRAC_BITS)

        check(torch.equal(run(), plain()),
              f"K2 at {shs[0, 0].numel()} elements, k = {len(points)} vs "
              "its plain version")
        # k R int32 shares read once, the float64 aggregate written
        return dict(run=run, plain=plain, library=None,
                    bound=bound(work.k2_reconstruct(
                        shs[0, 0].numel(), len(points), shs.shape[1],
                        True)))

    def k4_shape(args):
        def run():
            return share_kernel(*args)

        def plain():
            return share_plain(*args)

        R, tm1, n = args[1].shape
        check(torch.equal(run(), plain()),
              f"K4 at t={tm1 + 1} w={args[3]} n={n} vs its plain version")
        # int64 secret and coefficients read once, w shares written; the
        # integer multiply-high steps have no peak in the float table, and
        # the bytes bound it
        return dict(run=run, plain=plain, library=None,
                    bound=bound(work.k4_share(n, R, tm1, args[3])))

    k1_shapes = {"lambda_path": k1_shape(x_path, co_path),
                 "2^24": k1_shape(x_big, co_big),
                 **{name: k1_shape(*args[:2], points=args[4])
                    for name, args in cap_cases["K1"].items()}}
    k2_shapes = {"lambda_path": k2_shape(k2_path), "2^24": k2_shape(k2_big),
                 **{name: k2_shape(args[0], points=args[1])
                    for name, args in cap_cases["K2"].items()}}
    # an empty launch timed as the kernels are: what the events add
    event_floor_ms = cuda_times(lambda: torch.cuda._sleep(0), 30)[0]
    print(f"event floor (an empty launch, CUDA events): {event_floor_ms:.6f}"
          " ms")
    k7_main = k7_timing(k7_args["serving"])
    k7_shapes = {n: k7_timing(k7_args[n]) for n in FLASH_TIMED}
    k7_shapes.update({name: k7_timing(f3a_k7_args[name],
                                      MLA_DV if how == "v128" else None)
                      for name, *_, how in F3A_K7_CASES})
    k7_shapes.update({name: k7_timing(f3b_k7_args[name])
                      for name, *_ in F3B_K7_CASES})
    k7_shapes.update({name: k7_timing(d2a_k7_args[name])
                      for name, *_ in D2A_K7_CASES})
    k8_main = k8_timing(k8_args["training"])
    k8_shapes = {n: k8_timing(k8_args[n]) for n in FLASH_TIMED}
    k8_shapes.update({name: k8_timing(f4_k8_args[name],
                                      MLA_DV if how == "v128" else None)
                      for name, *_, how in F4_K8_CASES})
    k8_shapes.update({name: k8_timing(d2b_k8_args[name])
                      for name, *_ in D2B_K8_CASES})
    entries = [
        dict(name="K1 encode_share", fn=encode_share_kernel,
             path="secure_fit",
             source="src/repro_torch/csrc/shamir_poly.cu",
             replaces="src/repro/kernels/shamir_poly.py:223",
             run=lambda: encode_share_kernel(x, coeffs, FIELD_WIDE.moduli,
                                             FRAC_BITS, (1, 2, 3)),
             plain=lambda: encode_share_plain(x, coeffs, FIELD_WIDE.moduli,
                                              FRAC_BITS, (1, 2, 3)),
             library=None, err=k1_err, shapes=k1_shapes,
             bound=bound(work.k1_encode_share(n1, 8, 2, 1, 3))),
        dict(name="K2 reconstruct", fn=reconstruct_kernel, path="secure_fit",
             source="src/repro_torch/csrc/shamir_reconstruct.cu",
             replaces="src/repro/kernels/shamir_reconstruct.py:120",
             run=lambda: reconstruct_kernel(k2_in, (1, 2), FIELD_WIDE.moduli,
                                            FRAC_BITS),
             plain=lambda: reconstruct_plain(k2_in, (1, 2),
                                             FIELD_WIDE.moduli, FRAC_BITS),
             library=None, err=k2_err, shapes=k2_shapes,
             bound=bound(work.k2_reconstruct(rows * 128, k2_in.shape[0],
                                             k2_in.shape[1], True))),
        dict(name="K3 fused_irls", fn=fused_irls_kernel, path="secure_fit",
             source="src/repro_torch/csrc/fused_irls.cu",
             replaces="src/repro/kernels/fused_irls.py:100",
             run=lambda: fused_irls_kernel(*k3_args),
             plain=lambda: fused_irls_plain(*k3_args),
             library=lambda: torch.matmul(
                 (Xm * w32[..., None]).transpose(1, 2), Xm),
             err=k3_err,
             bound=bound(work.k3_fused_irls(rows_total, D, S))),
        dict(name="K5 fused_irls_cv", fn=fused_irls_cv_kernel,
             path="lambda_path",
             source="src/repro_torch/csrc/fused_irls_cv.cu",
             replaces="src/repro/kernels/fused_irls.py:270",
             run=lambda: fused_irls_cv_kernel(*k5_args),
             plain=lambda: fused_irls_cv_plain(*k5_args),
             library=lambda: torch.matmul(
                 (Xm[None] * w5[..., None]).transpose(-1, -2), Xm[None]),
             err=k5_err,
             bound=bound(work.k5_fused_irls_cv(rows_total, k5_train, D,
                                               n_cfg, S))),
        dict(name="K4 leaf-wise share", fn=share_kernel, path="leafwise",
             source="src/repro_torch/csrc/shamir_share.cu",
             replaces="src/repro/kernels/shamir_poly.py:116",
             err=0.0, **k4_shape(k4_cases[(2, 3)]),
             shapes={"t3_w5": k4_shape(k4_cases[(3, 5)]),
                     "2^24": k4_shape(k4_args(dev, gen, 2, 3,
                                              BIG_ELEMENTS)),
                     **{name: k4_shape(args)
                        for name, args in cap_cases["K4"].items()}}),
        dict(name="K6 gram_hessian", fn=gram_hessian_kernel, path="gram",
             source="src/repro_torch/csrc/gram_hessian.cu",
             replaces="src/repro/kernels/fused_irls.py:387",
             err=k6_err, **k6_timing(X6, w6),
             # one institution's shape, beside the pooled one
             shapes={"25000x128": k6_timing(X6[:25_000], w6[:25_000])}),
        dict(name="K7 flash_attention", fn=flash_attention_kernel,
             path="serve",
             source="src/repro_torch/csrc/flash_attention.cu",
             replaces="src/repro/kernels/flash_attention.py:116",
             err=max(k7_err, f3a_k7_err, f3b_k7_err, d2a_k7_err), **k7_main,
             shapes=k7_shapes),
        dict(name="K8a flash_dq", fn=flash_dq_kernel, path="train",
             source="src/repro_torch/csrc/flash_attention_bwd.cu",
             replaces="src/repro/kernels/flash_attention_bwd.py:145",
             library_covers="K8a + K8b",
             err=max(k8_err, f4_k8_err, d2b_k8_err),
             **k8_main["K8a"],
             shapes={n: sh["K8a"] for n, sh in k8_shapes.items()}),
        dict(name="K8b flash_dkdv", fn=flash_dkdv_kernel, path="train",
             source="src/repro_torch/csrc/flash_attention_bwd.cu",
             replaces="src/repro/kernels/flash_attention_bwd.py:188",
             library_covers="K8a + K8b",
             err=max(k8_err, f4_k8_err, d2b_k8_err),
             **k8_main["K8b"],
             shapes={n: sh["K8b"] for n, sh in k8_shapes.items()}),
    ]
    by_path = {"secure_fit": launches, "lambda_path": path_launches,
               "leafwise": leaf_launches, "gram": gram_launches,
               "supervised_fit": sfit_launches,
               "multistudy": ms_out["launches"],
               "serve": serve_out["launches"],
               "train": train_out["launches"],
               "secure_train": secure_out["launches"],
               "wires": wire_launches,
               "serve_d2a_single_rank": d2a_out["single_rank"]["launches"],
               "train_d2b_single_rank": d2b_out["single_rank"]["launches"],
               **{f"serve_{arch}": out["launches"]
                  for arch, out in (*f3a_out.items(), *f3b_out.items())},
               **{f"train_{arch}": out["launches"]
                  for arch, out in f4_out.items()},
               **{f"secure_train_{arch}": launches
                  for arch, launches in f4_secure.items()},
               **{f"entry_{label}": collections.defaultdict(
                   int, run["launches"])
                  for label, run in ep_out["runs"].items()
                  if "launches" in run}}
    kernels = []
    for e in entries:
        ms, call_ms = cuda_times(e["run"], 30)
        plain_ms, _ = cuda_times(e["plain"], 20)
        lib_ms = cuda_times(e["library"], 20)[0] if e["library"] else None
        bound_ms, bound_by = e["bound"]
        at_shapes = {}
        for k, sh in e.get("shapes", {}).items():
            b_ms, b_by = sh["bound"]
            at_shapes[k] = {
                "ms": cuda_times(sh["run"], 30)[0],
                "plain_ms": cuda_times(sh["plain"], 20)[0],
                "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": (cuda_times(sh["library"], 20)[0]
                               if sh["library"] else None)}
        kernels.append({
            "name": e["name"], "route": "cuda", "source": e["source"],
            "replaces": e["replaces"],
            # each kernel's count on the path it was ported for: K1-K3
            # the secure_fit run, K5 the lambda path, K4 the leaf-wise
            # shares, K6 the weighted Grams, K7 the serving run, K8 the
            # training run
            "launches": by_path[e["path"]][e["fn"].__name__],
            "launches_by_path": {k: v[e["fn"].__name__]
                                 for k, v in by_path.items()},
            "max_abs_err": e["err"], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib_ms,
            "call_ms": call_ms,
            **({"at_shapes": at_shapes} if at_shapes else {}),
            **({"event_floor_ms": event_floor_ms}
               if e["name"][:2] in ("K1", "K2", "K4") else {}),
            **({"library_covers": e["library_covers"]}
               if "library_covers" in e else {}),
        })
    k8_ms = {k["name"]: k for k in kernels if k["name"].startswith("K8")}
    b8, s8, h8, d8 = k8_args["training"][0].shape
    print(f"K8a + K8b {k8_ms['K8a flash_dq']['ms'] + k8_ms['K8b flash_dkdv']['ms']:.5f} "
          f"ms vs the SDPA backward {k8_ms['K8a flash_dq']['library_ms']:.5f} ms "
          f"(B {b8}, S {s8}, H {h8}, KVH {k8_args['training'][1].shape[2]}, "
          f"D {d8}, bf16)")
    print(json.dumps({
        "kernels": kernels,
        "event_floor_ms": event_floor_ms,
        "fit_seconds_per_iter": fit_s / res.iterations,
        "fit_iterations": res.iterations,
        "scan_fit_seconds_per_iter": scan_s / scan.iterations,
        "path_seconds": path_s,
        "path_rounds": rep.rounds_total,
        "path_seconds_per_round": path_s / rep.rounds_total,
        "coordinator_path_seconds": coord_s,
        "multistudy_seconds_per_round": ms_out["seconds_per_round"],
        "supervisor_overhead_pct": sup_out["overhead_pct"],
        "serve_tokens_per_second": serve_out["tokens_per_second"],
        "serve_prefill_tokens_per_second":
            serve_out["prefill_tokens_per_second"],
        "serve_decode_ms_per_step": serve_out["decode_ms_per_step"],
        "train_seconds_per_step":
            train_out["median_seconds_per_step_after_the_first"],
        "train_tokens_per_second": train_out["tokens_per_second"],
        "train_peak_bytes_allocated": train_out["peak_bytes_allocated"],
        "grad_check_rel_err": grad_out["rel_err"],
        "f3a_serve": {arch: {k: out[k] for k in (
            "prefill_tokens_per_second", "decode_ms_per_step",
            "peak_bytes_allocated", "continuation_max_abs_err",
            "continuation_f32_max_abs_err")} for arch, out in f3a_out.items()},
        "f3b_serve": {arch: {k: out[k] for k in (
            "prefill_tokens_per_second", "decode_ms_per_step",
            "peak_bytes_allocated", "continuation")}
            for arch, out in f3b_out.items()},
        "recurrence_loops": {k: v for k, v in rec_out.items()
                             if k.endswith("serving shape")},
        "d2a_phase_seconds": d2a_out["phase_seconds"],
        "d2a_k7_launches_per_rank": {
            arch: [r["k7_launches"] for r in m["ranks"]]
            for arch, m in d2a_out["gloo_ranks"]["models"].items()},
        "d2b_phase_seconds": d2b_out["phase_seconds"],
        "d2b_launches_per_rank": {
            arch: [r["launches"] for r in m["ranks"]]
            for arch, m in d2b_out["gloo_ranks"]["models"].items()},
        "entry_points_phase_seconds": ep_out["phase_seconds"],
        "entry_points_seconds": {label: run["seconds"] for label, run in
                                 ep_out["runs"].items() if "seconds" in run},
        "script_seconds_to_here": time.perf_counter() - t_script,
        "f4_train": {arch: {k: out[k] for k in (
            "median_seconds_per_step_after_the_first", "tokens_per_second",
            "peak_bytes_allocated", "launches_per_step")}
            for arch, out in f4_out.items()},
        "card": smi,
    }))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
