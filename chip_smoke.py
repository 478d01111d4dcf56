#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA GPU, end to end.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py

Phases, each of which fails the script when it fails:

1. device   — needs ``torch.cuda.is_available()``; prints the card's name
              and power limit (``nvidia-smi``) and compute capability.
2. build    — builds the port's CUDA sources (``src/repro_torch/csrc``) with
              ``nvcc``, one process per source, all started together; then
              reads K9's differentiated kernels (``namespace grad``) in the
              built SASS (``cuobjdump``): each bf16 kernel must run HMMA and
              none may use an atomic; their registers and local (spill)
              bytes are printed; likewise K10's (``ssd_grad_sass``: each
              bf16 tensor-core kernel runs HMMA, no atomic in its
              ``namespace grad``).
3. kernels  — holds every kernel of the main paths against its plain PyTorch
              version on the card, in f64 (1e-12 relative) and f32 (2e-4;
              the RBF Gram matvec 2e-4 relative / 5e-4 absolute), at the
              main paths' shapes (n = 36 551 and the cut n = 16 384 of the
              preconditioned sequences) and at a ragged small n; times each (CUDA
              events, median of 25 launches, 3 for the RBF Gram matvec, L2
              flushed before each) beside its plain version, the one
              PyTorch call that computes the same function where there is
              one, and its bound.  The RBF Gram matvec (K3) must repeat bit
              for bit at the paper's n.  K6's and K2's entries
              time their step arms (``fused_rz_step``, the preconditioned
              def-CG tail; ``fused_direction_step``, the direction update
              with the ``p`` select: no single PyTorch call, library null),
              beside every other arm (one device kernel a call each, or the
              phase fails) and the previous designs' times: K6's no-AW arm
              beside ``torch.dot(r, z)``, its pair arm (the sharded
              def-CG's four reductions) at main-shard's per-rank n beside
              the two one-vector calls it replaces, K2's k = 0 step arm
              beside ``torch.addcmul(r, β, p)``.  The LSMR
              update (K7) is held at the
              least-squares path's n = 16 384, the Gauss-Newton parameter
              count 32 768, lsq_bench's 2²⁰ and a ragged n.  K1's and K7's
              step arms (the def-CG and LSMR iteration tails, one launch
              each) are held against their plain versions in live, frozen,
              breakdown and exact-termination states, f64 and f32 (scalars
              bit for bit, vectors to the bars above, a repeat bit for bit)
              and timed beside their TPU-function arms, the previous
              designs' times and their bounds, with the device kernels a
              call (``torch.profiler``); K1's and K7's entries in the
              kernels line are their step arms, the arms the main paths
              run.  Both step arms are also held armed with the stall
              detector (window 4) in five stall states, f64 and f32: the
              window-0 outputs bit for bit, the detector's best residual,
              stall count and status bit for bit (STAGNATED latched on the
              same step), and timed beside the window-0 arm.  The two
              extraction kernels at the least-squares windows' 96, 112 and
              128 stacked rows (timed at 112 rows, n = 16 384; ``self_gram``
              exactly symmetric and repeating bit for bit).  The
              rectangular Gram matvec (K8) is held at d = 784, r = 1 and 8,
              on the sharded blocks (m, n) = (4 096, 16 384) and (2 048,
              16 384) of 4 and 8 ranks, (9 138, 36 552) and a ragged
              (1 000, 3 001), and timed beside the dense GEMV over the
              materialized block.  The lane axis of K1's, K6's and K2's
              step arms (batched solves) at n = 36 551: B = 1, 8, 64
              lanes, every lane bit for bit the one-lane arm on its data
              (SHA-256 digests), two launches bit for bit, the plain
              versions lane by lane to the f64 bar, each lane arm timed at
              B = 8 and 64; the same for K7's step arm at n = 16 384
              (B = 1, 8, 64, and armed with window 10 at B = 8; live,
              frozen, converging, diverging and exactly terminating lanes),
              timed at B = 8 and 64 beside B one-lane calls; K3 and K8 gated
              off (every flag false): zeros, timed beside the ungated
              calls.
4. check    — small Newton sequences (n = 400) on the card against the same
              sequences run on the CPU through the plain versions: the
              dense-K solvers, and the matrix-free Jacobi-preconditioned
              front door (log p to 1e-10, iterations within one).
5. main     — the paper's GP-classification Newton sequence at n = 36 551
              (Table 1's n; ``benchmarks/common.py`` settings: digits seed 0,
              noise 0.10, θ = 3, λ = 3, f64, dense K built on the card),
              solved by Cholesky, CG, def-CG(8, 12) through RecycleManager,
              and the SolveSpec front door at the paper's solver tol 1e-5.
              def-CG must beat CG on iterations after system 1, and every
              kernel must have launched in that run (the counts in the
              kernels line) while no plain version ran on the card.  The
              per-step log p gap to Cholesky at tol 1e-5 is reported; the
              three iterative solvers are then run again at solver tol 1e-10
              (counted apart) and must agree with Cholesky's log p to 1e-6.
              ``scripts/paper_tol_witness.py`` shows on the CPU that the
              reference has the same gap at tol 1e-5, growing with n.
              Counted apart, ``torch.profiler`` over 16 deflated def-CG
              iterations on the dense system gives the launches per
              iteration (``profile_defcg_steps``), and over 16 with the
              Jacobi preconditioner (``profile_pdefcg_steps``).
5b. paper   — the paper's experiments on main's data and dense K:
              Fig. 2 and Table 1 from main's tol 1e-5 runs (per-system
              counts, totals, the saving after system 1, log p agreement);
              Fig. 3, CG and def-CG(8, 12) at tol 1e-8 with residual
              histories (``benchmarks/paper_fig23.py``): def-CG's mean
              log10-residual slope after system 1 must be steeper; Fig. 4
              (``paper_fig4.py``): Cholesky at Newton tol 1e-3,
              ``subset_gpc`` at m = n/16 … n/2 (generator seeded m), CG and
              def-CG at tol 1e-8: relative errors and seconds, and the
              precision gap, which must pass 1e2.  K1, K2, K3, K4 and K5
              must launch (counted apart) and no plain version run.
5c. strategies — ``benchmarks/seq_bench.py``'s strategy matrix on main's
              data and dense K: six genuine Newton systems (exact inner
              solves), def-CG(8, 12), tol 1e-5, for HarmonicRitz,
              WindowedRecombine and MGeometryHarmonic (Jacobi): iterations,
              matvecs and time per system; every residual within 10× tol.
5d. batch   — ``benchmarks/batch_bench.py``'s tenants on main's dense K
              (shared): B = 1, 8, 64 through ``solve_batch`` (one (n, B)
              product and the lane-axis step arms an iteration) against B
              sequential ``solve`` calls (at B = 64 its first 16 tenants,
              the loop's time scaled by 4; every tenant converged, x within
              1e-4, the count differences and wall times reported: at
              ~185 iterations counts move with summation order, ROADMAP
              P1), device launches per batched iteration at
              B = 8 (``torch.profiler``), one Jacobi batch at B = 8 (K6's
              lane arm), one matrix-free batch over K3
              (B = 8, one call of r = 8 an iteration, gated by the lanes)
              and one ``solve_pool_step`` with half the slots idle (their
              states bit-untouched, their info scrubbed).  The lane arms
              must launch and no plain version run.
5e. serve   — ``benchmarks/serve_bench.py``'s traffic through
              ``repro_torch.serve.SolveService`` on main's data and dense K
              (shared), def-CG(8, 12), tol 1e-5: Poisson arrivals, drifting
              Newton sequences (drift 0.15); B = 8 slots with 3 systems a
              tenant beside the sequential ``solve`` loop, B = 64 with 3
              (the pool alone): µs a system, systems a second, occupancy,
              ticks, batched and single steps, evictions, every tenant
              converged; the B = 1 fence (one system through ``solve``
              against an 8-slot pool step with one slot active); then 6
              tenants through 4 slots spilling into a temporary directory
              (the re-admitted tenant's state restored bit for bit, its next
              solve warm).  K1, K2 (lane arms), K4 and K5 must launch and no
              plain version run.
6. scale    — one RBF Gram matvec each in f32 and f64 at n = 131 072,
              d = 784, where a dense K would need 69 GB (f32) or 137 GB.
7. main-mf  — the matrix-free Newton sequence (K never formed; every K
              product is the RBF Gram matvec kernel) on the same n = 36 551
              data, f64, solver tol 1e-5: def-CG(8, 12) through
              RecycleManager, and the SolveSpec front door with
              precond="jacobi" and precond="nystrom" (rank 16, generator
              seed 0).  The two preconditioned sequences run at n = 16 384
              when the kernel's measured f64 time passes 0.25 s per call.
              Every kernel must launch in this run, no plain version may
              run on the card, and every log p must be finite; each is set
              beside a Cholesky log p of the same data.  The K3 calls of
              frozen steps are gated off on the card (counted apart from
              the live passes).
7b. chaos   — ``benchmarks/chaos_bench.py``'s 4 drifting H½ systems on
              the digits at the cut n = 16 384 (seed 0) over the
              matrix-free K3 operator, def-CG(8, 12),
              tol 1e-5: the recovery ladder armed and disarmed (identical
              iterates, rungs 0); system 1 poisoned with NaN (rungs
              0/3/0/0, finite x, the neighbours converged; the extra
              matvecs and the ladder's wall time); the chunked driver
              checkpointing every 2 systems into a temporary directory, then
              a resume past a truncated newest checkpoint (both bit for bit
              the single run; the checkpoint overhead); the stale refresh
              at tol 1e-10 (the rungs P9's ladder climbs); a
              Jacobi-preconditioned solve with every product perturbed by
              1e-3 and the stall detector armed (window 10), which must stop
              STAGNATED where the stall rule on its history fires.  K1, K2,
              K3, K4, K5 and K6 must launch and no plain version run.
8. agree    — at n = 4 000, matrix-free def-CG against dense def-CG, both
              f64: at solver tol 1e-10 iterations within one per system,
              at solver tol 1e-12 log p to 1e-10.
9. check-lsq — ``benchmarks/lsq_bench.py``'s own problem (m = 180, n = 120,
              12 systems, logspace and flat spectra, drift 0.02, λ = 1e-4,
              tol 1e-8, deflsmr(8, 48)) on the card against the CPU: cold
              iterations within one (or 5 %) per system, recycled within
              10 % (ROADMAP P5), every x within 1e-6 relative; and six
              ``hf_step``s at ``tests/test_optim.py``'s size in each mode
              (Gauss-Newton and GGN), loss to 1e-10 and iterations equal.
10. main-lsq — the least-squares main path: lsq_bench's drifting ridge
              sequence at m = 24 576, n = 16 384 (f64, 3.2 GB a system, A_0
              built on the card), cold LSMR per system and deflsmr(8, 48)
              through the front door, over 8 systems.  Every system must
              converge, the last x must match a Cholesky solve of AᵀA + λI
              to 1e-5, and the LSMR update and both extraction kernels must
              launch.  Then, counted apart, ``torch.profiler`` over 16 LSMR
              iterations gives the launches per iteration.
10b. batch-lsq — eight tenants, each its own lsq_bench drifting ridge
              sequence (2 systems, seeds 0–7) at m = 12 288, n = 8 192 (12.9
              GB in one (8, 2, m, n) tensor), through ``solve_batch(
              deflsmr(8, 48), sequence=True)`` (batched products read in
              place, K7's lane arm) beside eight sequential
              ``solve_sequence`` runs: every system converged, x within
              1e-6, counts within ROADMAP P5's bars; the wall times; device
              launches per batched LSMR iteration (``torch.profiler``); one
              ``solve_pool_step`` with half the slots idle.  K7's lane arm
              must launch and no plain version run.
11. main-gn  — Gauss-Newton training: ``hf_step(solver="gauss_newton")`` on
              a teacher-student tanh residual, 65 536 samples, d = 1024, 32
              outputs (32 768 parameters), f64, 10 steps with recycling and
              10 without; the loss must fall and stay finite, and the LSMR
              update must launch.

12. check-shard — the sharded engine (``solve(..., mesh=)``) on small
              systems against the unsharded port, both on the card, on one
              NCCL rank and on 4 gloo ranks: the dense n = 64 system of
              ``tests/test_sharded_engine.py`` (cg, def-CG(4, 6), LSMR), the
              RBF operator at n = 256 (def-CG, K8 products) and lsq_bench's
              flat 180 × 120 (LSMR); the bars of ``tests/test_torch_sharded.py``
              and its collective contract (one all-reduce and one all-gather
              per cg / def-CG iteration, two of each per LSMR iteration).
13. main-shard — the sharded main path: the matrix-free GP Newton systems
              on the digits data at n = 16 384 (the cut n of 7), d = 784,
              f64, solved unsharded by def-CG(8, 12) through the front door at
              tol 1e-5 (the control), then replayed through ``solve(...,
              mesh=)`` on 4 gloo ranks sharing the one card (NCCL refuses two
              ranks on one GPU), carrying the RecycleState.  Each system's
              iterations within one of the control's, x within
              2·tol·‖b‖ + 1e-10·‖b‖ of it, fewer iterations after system 1,
              K8 launched on every rank while K3 and every plain version stay
              at 0.  Four ranks share one card: this is no scaling number.
              The 4-rank cases of 12 and the replay of 13 run in one spawn
              (starting ranks on the card takes tens of seconds).

14. check-lm — flash attention (K9) and the SSD scan (K10) against their
              plain versions on the card, f32 (2e-4 / 5e-4) and bf16 (2e-2 /
              5e-2; the SSD scan relative to its output's scale), at
              ``tests/test_kernels.py``'s shapes, qwen1.5-0.5b's prefill
              (4 × 16 heads × 4 096, dh 64, causal), a GQA shape at dh 128
              (32 over 8 heads), a ragged causal block with an offset, and
              mamba2-1.3b's prefill (4 × 4 096, 64 heads × 64, n 128, chunk
              128) with and without state in and out, and once more at
              mamba2's widths with x, B and C the ``torch.split`` views the
              Mamba mixer passes (ragged l = 1 000); the SSD scan's f32
              final state is held at the f32 bar in both dtypes (bf16 runs
              feed the kernel's non-bf16 factors as hi + lo pairs, which
              keep f32 accuracy); two launches of each must agree bit for
              bit.  Also at stablelm-12b's attention (``ATTN_160``: h 32 over
              hkv 8, dh 160, 2 × 2 048, causal; and a ragged block) and
              jamba-v0.1-52b's SSD layers (``SSD_JAMBA``: 128 heads × 64,
              state 16, one group, 2 × 2 048).  Also at seamless-m4t-large-v2's
              non-causal dh 64 (``ATTN_ENCDEC_CHECK``): the encoder's 4 × 16
              heads × 4 096, the prefill's cross call (1 024 queries against
              4 096 keys), decode's one-row cross call, a ragged one-row
              call against 333 keys.
15. main-lm-attn — qwen1.5-0.5b serves at full width (24 layers, d 1024,
              vocab 151 936; f32 weights from a generator seeded 0, bf16
              compute): 4 prompts of 4 096 tokens from ``TokenPipeline``,
              ``prefill`` and 16 greedy ``decode_step``s.  Then, counted
              apart: the same through the plain versions (fed the same
              tokens), held on the prefill and first decode logits at the
              bf16 bar relative to the logits' scale; an f32 control of
              both, held element by element at the f32 bar (bf16 rounding
              noise alone moves some logits past the bf16 bar element by
              element: ROADMAP P7); a teacher-forced decode of the first 16
              tokens against ``forward_hidden`` at 2e-2, held in f32;
              ``torch.profiler`` over one prefill (with its top device
              operations by time) and over 8 decode steps.
16. main-lm-ssm — the same for mamba2-1.3b (48 layers, d 2048, 64 SSD
              heads × 64, state 128, vocab 50 280).
16b. main-lm-moe — the same for olmoe-1b-7b at full width and depth (16
              layers, d 2048, 64 experts top-8, capacity factor 1.25, vocab
              50 304): the held plain and f32-control runs replay the kernel
              runs' routing (``models.moe.replay_routing``); a free plain
              run gives the share of (token, layer) expert sets the two
              runs agree on, and the prefill's dropped assignments per
              layer are printed; the teacher-forced decode runs a dropless
              copy (capacity factor E / k).
16d. main-lm-encdec — the same for seamless-m4t-large-v2 at full width and
              depth (24 encoder and 24 decoder layers, d 1024, 16 heads of
              64, GELU d_ff 8 192, vocab 256 206): 4 × 4 096 source frames
              (normal, seeded 0) and 4 × 1 024 prompt tokens (the
              reference's prefill shape); K9 must launch exactly 72 times in
              the prefill (encoder, self and cross calls) and 24 times a
              decode step (the one-row cross call); the teacher-forced
              decode reads the encoded source's memory; the decode profile
              covers 8 steps alone.
16c. zoo    — qwen3-8b (36 layers), starcoder2-3b (30), stablelm-12b (40),
              chameleon-34b cut to 16 of 48 layers, jamba-v0.1-52b cut to one
              period (8 of 32) at full width, arctic-480b at SMOKE (one
              full-width layer's f32 experts alone hold 53.6 GB): a prefill
              of 2 × 2 048 tokens and 4 decode steps through the kernels and
              through the plain versions (MoE routing replayed), the logits
              held at the model's dtype's bar; wall s, peak memory, K9 / K10
              launches and the routing agreement per model.
17. timing  — K9 at qwen1.5's prefill shape, at prefill_32k's 32 768
              tokens (b 1), at ``ATTN_160`` and at seamless's encoder, cross
              and one-row decode shapes (non-causal), K10 at mamba2's and at
              ``SSD_JAMBA``: kernel, plain version,
              ``scaled_dot_product_attention`` as K9's yardstick (never on
              the path), and the bound (bf16 operations at 989 TFLOP/s
              against bytes read once at 3.35 TB/s; K10's operations are
              those ``ssd_work`` counts as needed); K9 also in f32 at
              the prefill shape.  The redesigned kernels' timing lines (K3,
              K4, K5, K8, K9, K10) print the previous designs' times
              (``PREVIOUS_MS``) beside this run's.
18. check-lm-grad — K9's three differentiated arms (the forward with the
              row log-sum-exp, the backward, the forward-mode JVP; custom
              ops inside ``FlashAttention``) against their plain versions
              at dh 16, 64 and 128, causal and not, GQA (h 8, hkv 2), f32
              and bf16, qwen1.5-0.5b's training shape (bf16) and the
              Hessian-free LM's (f32), seamless's non-causal encoder at 2 ×
              2 048 and a ragged cross shape: f32 2e-4 and bf16 5e-2 of the plain
              version's max abs, the lse arm's output bit for bit the
              serving arm's, each arm twice bit for bit; timed at the
              training shape beside the plain versions, SDPA's forward and
              backward (its forward subtracted), the bound (2.5 × the
              forward's flops for the backward and the JVP) and, for the
              backward and the JVP, the CUDA-core design's time
              (``PREVIOUS_MS``).  Then K10's (custom ops inside
              ``SSDScan``): the training forward (the serving arm's three
              launches, returning the chunk-entry states and ``cs``: its y
              bit for bit the serving arm's), the backward and the JVP
              against their plain versions at ``SSD_CHECK``'s cases and
              mamba2-1.3b's training shape (b 2, l 1 024), f32 and bf16,
              without and with a state in and out: the outputs in the
              inputs' dtype at ``GRAD_BAR``, the f32 ones (dt's, a's and
              the states' gradients and tangents) at its f32 bar, each arm
              twice bit for bit; timed at the training shape in bf16 beside
              the plain versions, the bound (``ssd_grad_work``; no PyTorch
              call computes the scan's derivative) and the CUDA-core
              design's time (``PREVIOUS_MS``).
19. train   — qwen1.5-0.5b at full width (24 layers, d 1024, vocab
              151 936, tied, f32 parameters, bf16 compute), 4 × 4 096
              tokens, through ``launch.train.build`` and the ``Trainer``:
              one step's loss and gradients through the kernels against
              ``backend="plain"`` on the card (loss 1e-2, each leaf 5e-2 in
              relative norm) and the same gradients again leaf by leaf; 6
              AdamW steps with checkpoints every 3 into a temporary
              directory, then the same with a failure injected at step 4
              (the replay's final state bit for bit the uninterrupted
              run's); ms a step, tokens/s, peak memory, K9 launches a step
              (48 lse under ``cfg.remat``, 24 backward), MFU from
              ``model_flops``; one more
              step under ``torch.profiler``.  Then mamba2-1.3b at full
              width (48 layers, d 2048, 64 SSD heads × 64, state 128, vocab
              50 280, f32 parameters, bf16 compute), 2 × 1 024 tokens, the
              same way (``TRAIN_SSM``): loss 1e-2; each leaf's gradient
              within max(5e-2, twice the same leaf's rounding floor, the
              plain versions at chunk 64 against chunk 128: bf16 rounding
              alone moves a 48-layer model's gradients, ROADMAP P7) and,
              in an f32-compute control at full width cut to 12 layers,
              within 5e-2; 4 AdamW steps through the step function (no
              Trainer, no fault replay); K10 launches a
              step (96 training forward under ``cfg.remat``, 48 backward).
              Every train cell runs with ``cfg.remat`` (each block
              checkpointed) and also takes the step's gradients with it off:
              bit for bit, with both times and peak memories.  Then
              olmoe-1b-7b at full width cut to 4 of 16 layers (``TRAIN_MOE``,
              2 × 2 048 tokens; the plain run replays the kernel run's
              routing): loss 1e-2, each leaf 5e-2, the gradients twice bit
              for bit, 2 AdamW steps (the step function alone, no Trainer)
              with a finite positive aux loss.  Then
              one mamba2-1.3b step at 4 × 4 096 tokens with ``cfg.remat``
              (``TRAIN_SSM_BIG``): its time and peak memory.  Then
              seamless-m4t-large-v2 at full width and depth
              (``TRAIN_ENCDEC``: 2 × 2 048 seeded source frames and 2 × 2 048
              tokens): loss 1e-2, each leaf 5e-2, the gradients twice and
              with remat off bit for bit, 2 AdamW steps through the step
              function (no Trainer); K9's lse arm 144 and backward 72
              launches a step.
20. hf-lm   — ``examples/hessian_free_lm.py``'s 10 Hessian-free steps
              (qwen1.5 SMOKE, batch 4 × 32, ``HFConfig(k=4, ell=8,
              cg_tol=1e-3, cg_maxiter=50, init_damping=10.0)``), recycled
              and cold, through the kernels (K9's three arms in the GGN
              products, ``matvec`` and ``basis_matvec``'s ``linearize``; K1,
              K2, K4, K5 in def-CG) against the same runs with
              ``backend="plain"`` on the card (iterations within one a
              step, loss to 1e-4); one recycled step profiled; one step at
              qwen1.5-0.5b's full widths with its depth cut to 2 layers
              (the reckoned parameter-sized vectors and the peak printed).
              Then mamba2's SMOKE model (f32), 3 recycled steps through the
              kernels (K10's training forward and backward in the
              gradients, its tangent map in ``linearize``) against the
              plain runs: iterations within one a step, loss to 1e-4.
21. dryrun  — the dry-run (``repro_torch.launch.dryrun``'s trace on the
              meta device, ``launch.trace_stats``) of shapes the script ran
              at full width, each predicted peak held within
              ``DRYRUN_TOL`` (15 %) of the ``max_memory_allocated()`` its
              phase measured (``report``): qwen1.5-0.5b's gradient step
              with ``cfg.remat`` on and off (parameters,
              AdamW state and the first gradients held, as the train
              phase holds them), main-lm-encdec's and main-lm-moe's
              prefill and decode; the traced FLOPs beside ``model_flops``
              and the roofline bound beside the measured time.  Then the
              GPC cell (``launch.gpc_dryrun``: one def-CG(8) iteration over
              K3 on pre-scaled digits) at n = 4 096 in f64 against the same
              iteration on the plain versions (1e-12 relative, K3
              launched), and at n = 131 072 in f32, its predicted peak
              (X, the vectors, K3's scratch) held against the measured one
              and its time beside its bound.  The paper's n = 2²⁰ cell is
              traced, not run.

A ``[summary]`` line gives the device launches per damped LSMR and
deflated def-CG iteration (without and with the Jacobi preconditioner),
main-lsq's ms per cold LSMR iteration and main-gn's device busy share.

Each main path (5, 5b–5e, 7, 7b, 10, 10b, 11, 13, 15, 16, 16b, 16d, each
model of 16c, and 19 and 20 for each model) is driven with the launch counters set to 0 just before
it and read just after (13: on every rank); the ``{"kernels": [...]}`` JSON line gives each
kernel's launches summed over the paths (13: over its ranks), and its
launches per arm (``arms``; lane-axis arms end in ``_lanes``).  K9's and
K10's backward and forward-mode arms have entries of their own
(``flash_attention_bwd``, ``flash_attention_jvp``, ``ssd_scan_bwd``,
``ssd_scan_jvp``); K9's and K10's entries count their forward arms
(serving, and lse or the training forward).  ``[summary] wall s a phase`` gives each
phase's wall time.  Further
``[summary]`` lines give the strategies, batch, serve, batch-lsq, paper
and chaos phases' results.  Last comes the
``{"ok": true, "device": {...}}`` line; the full report also goes to
``chiprun_out/chip_smoke.json``.
``--lm-only`` runs phases 1, 2 and 14–17 alone and prints no ok line;
``--train-only`` runs phases 1, 2 and 18–20 alone, likewise;
``--zoo-only`` runs phases 1, 2 and this slice's: check-lm and
check-lm-grad at ATTN_160 and SSD_JAMBA (each arm held and timed),
main-lm-moe, zoo, and train's mamba2 (remat on against off), olmoe and
mamba2 4 x 4 096 cells, likewise; ``--encdec-only`` runs phases 1, 2 and
the encoder–decoder's: check-lm and check-lm-grad at its shapes (held and
timed), main-lm-encdec and train's seamless cell, likewise;
``--dryrun-only`` runs phases 1, 2, main-lm-encdec, train's qwen1.5 cell
and the dry-run's phase 21 on their peaks, likewise.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.configs.gpc_mnist import CONFIG as GPC  # noqa: E402
from repro_torch.kernels.work import (  # noqa: E402
    attn_work,
    grad_work,
    rbf_work,
    rect_work,
    ssd_grad_work,
    ssd_work,
)
from repro_torch.launch.roofline import PEAKS  # noqa: E402  (card peaks, keyed by name)

PAPER_N = 36551  # benchmarks/paper_table1.py: the paper's Table 1 n
RAGGED_N = 1000
K, ELL = 8, 12
M = K + ELL  # window rows after system 1: Z = [W, P]
TOL = {"float64": 1e-12, "float32": 2e-4}
RBF_TOL_F32 = (2e-4, 5e-4)  # relative, absolute: tests/test_kernels.py
REPS = 25
RBF_REPS = 3  # one f64 call at the paper's n takes a quarter second

# configs/gpc_mnist.py's widths: d = 784, θ = λ = 3, block 1024; the
# Nyström sketch of SolveSpec's default rank.
D, THETA, LENGTHSCALE, BLOCK = GPC.d, GPC.theta, GPC.lengthscale, GPC.block
PRECOND_RANK = 16
RBF_RS = (1, K, PRECOND_RANK + 8)  # a CG step, the A·W refresh, the sketch
SCALE_N = 131072
AGREE_N = 4000
CUT_N = 16384  # the preconditioned sequences' n when the kernel is slow
CUT_MS = 250.0

# Card peaks: launch/roofline.py's PEAKS (NVIDIA data sheets; dense).
# "float64"/"float32" are the CUDA-core rates the SIMT kernels run at;
# "float64_tensor" is the FP64 tensor-core rate, the least time of f64
# GEMM-shaped work (the RBF Gram matvec, the extraction's S Sᵀ and uᵀS).
GEMM_SHAPED = ("self_gram", "recombine_blocks")
# The arm each kernel's entry of the kernels line times, where it is not
# the TPU function's: the arm the main paths run.
TIMED_ARM = {"fused_rz_reduce": "fused_rz_step", "fused_deflate_direction": "fused_direction_step"}

# benchmarks/lsq_bench.py's drifting ridge sequence (λ = 1e-4, tol 1e-8,
# deflsmr(8, 48), exact NW refresh, drift 0.02), at its own size for the
# card-against-CPU check and at m = 24 576, n = 16 384 (its m/n = 1.5) for
# the least-squares main path; maxiter 4000 there (the bench's 600 is for
# n = 120).
LSQ_DAMP, LSQ_TOL, LSQ_K, LSQ_ELL, LSQ_DRIFT = 1e-4, 1e-8, 8, 48, 0.02
LSQ_BENCH = {"m": 180, "n": 120, "num": 12, "maxiter": 600}
LSQ_MAIN = {"m": 24576, "n": 16384, "num": 8, "maxiter": 4000}
# Gauss-Newton training: tests/test_optim.py's teacher-student residual
# tanh(x @ w) − y widened to 65 536 samples, d = 1024, 32 outputs, f64.
GN = {"samples": 65536, "d": 1024, "out": 32, "steps": 10}
# K7 sizes: the least-squares main path's n, the GN parameter count,
# lsq_bench's microbench n, a ragged n.
K7_NS = (LSQ_MAIN["n"], GN["d"] * GN["out"], 1 << 20, RAGGED_N)
# Stacked window rows the extraction kernels must take: def-CG's 2(k + ℓ)
# = 40, and the least-squares windows (lsq_bench 2·56 = 112).
GRAM_ROWS = (96, 112, 128)
# The sharded main path: the matrix-free Newton systems on the digits data
# at the cut n = 16 384, d = 784, replayed over 4 gloo ranks on the one card
# (NCCL refuses two ranks on one GPU); check-shard also runs 1 NCCL rank.
SHARD_N, SHARD_RANKS, SHARD_TOL, SHARD_TIMEOUT_S = CUT_N, 4, 1e-5, 300.0
# K8's (m, n): the main-shard blocks at 4 and 8 ranks, the paper's n at 4
# ranks (36 552 = 4 · 9 138), a ragged block; r: a product, the A·W refresh.
K8_SHAPES = ((SHARD_N // 4, SHARD_N), (SHARD_N // 8, SHARD_N), (9138, 36552), (1000, 3001))
K8_RS = (1, K)
# The model zoo's serving paths at full width (configs/qwen1_5_0_5b.py,
# configs/mamba2_1_3b.py): 4 prompts of 4 096 tokens, 16 greedy decode
# steps, teacher-forced decode of the first 16 tokens (32 and 32 until the
# script's time limit asked for room: decode is host-bound, its ms a step
# steady after a few steps).
# main-lm-moe: olmoe-1b-7b (configs/olmoe_1b_7b.py) the same way, at full
# width and depth (16 layers, d 2048, 64 experts top-8, capacity factor
# 1.25, vocab 50 304).  main-lm-encdec: seamless-m4t-large-v2
# (configs/seamless_m4t_large_v2.py: 24 encoder and 24 decoder layers, d
# 1024, 16 heads of 64, GELU d_ff 8 192, vocab 256 206) at full width and
# depth on 4 x 4 096 seeded normal source frames and 4 x 1 024 prompt tokens
# (launch/steps.py's prefill shape, max(source_len / 4, 64)), 32 greedy
# decode steps and a teacher-forced decode of the first 32 tokens.
LM_PATHS = {
    "main-lm-attn": {"arch": "qwen1.5-0.5b", "batch": 4, "prompt": 4096, "decode": 16,
                     "teacher": 16, "kernel": "flash_attention_"},
    "main-lm-ssm": {"arch": "mamba2-1.3b", "batch": 4, "prompt": 4096, "decode": 16,
                    "teacher": 16, "kernel": "ssd_scan_"},
    "main-lm-moe": {"arch": "olmoe-1b-7b", "batch": 4, "prompt": 4096, "decode": 16,
                    "teacher": 16, "kernel": "flash_attention_"},
    "main-lm-encdec": {"arch": "seamless-m4t-large-v2", "batch": 4, "prompt": 1024,
                       "source": 4096, "decode": 32, "teacher": 32, "kernel": "flash_attention_"},
}
LM_PATH_KERNELS = {"main-lm-attn": ("flash_attention",), "main-lm-ssm": ("ssd_scan",),
                   "main-lm-moe": ("flash_attention",), "main-lm-encdec": ("flash_attention",)}
# zoo: every other decoder-only architecture at full width (arctic-480b at
# SMOKE: one layer's f32 experts alone hold 53.6 GB), a prefill of 2 x 2 048
# tokens and 4 greedy decode steps through the kernels and through the plain
# versions; depth cut where the f32 parameters would not fit beside the run
# (chameleon-34b to 16 of 48 layers, jamba-v0.1-52b to one period, 8 of 32).
ZOO = (("qwen3-8b", None), ("starcoder2-3b", None), ("stablelm-12b", None),
       ("chameleon-34b", 16), ("jamba-v0.1-52b", 8), ("arctic-480b", "smoke"))
ZOO_RUN = {"batch": 2, "prompt": 2048, "decode": 4}
LM_TOL = {"float32": (2e-4, 5e-4), "bfloat16": (2e-2, 5e-2)}  # tests/test_kernels.py
TOP_OPS = 12  # device operations listed from each profiled prefill
# K9 (b, h, hkv, sq, sk, dh, causal, q_offset): tests/test_kernels.py's
# ATTN_CASES, qwen1.5-0.5b's prefill, a GQA shape at dh = 128, a ragged
# causal block with an offset; timed at the prefill and at prefill_32k's
# length (configs/registry.py SHAPES) with b = 1.
ATTN_MAIN = (4, 16, 16, 4096, 4096, 64, True, 0)
ATTN_LONG = (1, 16, 16, 32768, 32768, 64, True, 0)
ATTN_CHECK = ((2, 4, 2, 64, 64, 32, False, 0), (1, 8, 2, 96, 96, 64, True, 0),
              (2, 4, 4, 1, 133, 64, True, 132), (1, 2, 1, 40, 200, 16, False, 0),
              (1, 16, 2, 33, 33, 128, True, 0), ATTN_MAIN, (1, 32, 8, 2048, 2048, 128, True, 0),
              (2, 4, 1, 70, 150, 64, True, 80))
# stablelm-12b's attention (h 32 over hkv 8, dh 160: 5120 / 32) at the
# zoo's prefill of 2 x 2 048 tokens, and a ragged causal block with an
# offset: K9's four arms at dh 160, timed at ATTN_160.
ATTN_160 = (2, 32, 8, 2048, 2048, 160, True, 0)
ATTN_160_CHECK = (ATTN_160, (1, 32, 8, 300, 333, 160, True, 33))
ATTN_CHECK += ATTN_160_CHECK
# seamless-m4t-large-v2's attention (16 heads, dh 64, non-causal): the
# encoder's self-attention over 4 x 4 096 frames, prefill's cross-attention
# (1 024 queries against 4 096 keys), decode's one-row cross call, and a
# ragged one-row call; each timed but the last.  K9 launches 72 times in a
# prefill (24 encoder, 24 self, 24 cross) and 24 times a decode step.
ATTN_ENC = (4, 16, 16, 4096, 4096, 64, False, 0)
ATTN_CROSS = (4, 16, 16, 1024, 4096, 64, False, 0)
ATTN_CROSS_DECODE = (4, 16, 16, 1, 4096, 64, False, 0)
ATTN_ENCDEC_CHECK = (ATTN_ENC, ATTN_CROSS, ATTN_CROSS_DECODE, (1, 16, 16, 1, 333, 64, False, 0))
ATTN_ENCDEC_TIMED = (("encoder", ATTN_ENC), ("cross", ATTN_CROSS),
                     ("decode_cross", ATTN_CROSS_DECODE))
ATTN_CHECK += ATTN_ENCDEC_CHECK
LONG_REPS = 3
# The times of the designs the redesigned kernels replaced, printed beside
# this run's (PERF.md §6: chip_smoke.py on an NVIDIA H100 80GB HBM3 at
# 700 W): K9's SIMT kernel in bf16, K4's two-instance partial pass with one
# reduce block per pair, K5's thread-per-column kernel, K3's SIMT kernel
# over every 64 × 64 tile and K8 on it, K10's one block per (batch, head)
# walking its chunks in order on the CUDA cores, K1's two launches (partials,
# then a reduce kernel), K7's grid capped at 8 blocks an SM, K6's two
# launches and K2's one element a thread on a capped grid; K9's backward
# and forward-mode arms in bf16 on the CUDA cores (at ATTN_TRAIN); K10's
# backward and forward-mode arms in bf16 on the CUDA cores (at SSD_TRAIN,
# check-lm-grad's timing).
PREVIOUS_MS = {"fused_rz_reduce float64 n=36551": 0.0114,
               "fused_rz_reduce no-aw float64 n=36551": 0.0094,
               "fused_deflate_direction float64 n=36551": 0.0081,
               "fused_deflate_direction recording float64 n=36551": 0.0087,
               "ssd_scan main": 9.389, "flash_attention main": 6.243, "flash_attention 32k": 92.68,
               "self_gram 40x36551": 0.0441, "self_gram 112x16384": 0.1187,
               "recombine_blocks 40x36551": 0.0201, "recombine_blocks 112x16384": 0.0387,
               "rbf_matvec float64 r=1": 262.21, "rbf_matvec float64 r=8": 264.86,
               "rbf_matvec float64 r=24": 274.49, "rbf_matvec float32 r=1": 172.03,
               "rbf_matvec_rect float64 m=4096 n=16384 r=1": 11.37,
               "fused_cg_update float64 n=36551": 0.0134, "lsmr_update float64 n=16384": 0.0065,
               "lsmr_update float64 n=32768": 0.0069, "lsmr_update float64 n=1048576": 0.0281,
               "lsmr_update float32 n=1048576": 0.0173,
               "flash_attention:bwd": 20.509, "flash_attention:jvp": 13.859,
               "ssd_scan:bwd": 3.481, "ssd_scan:jvp": 2.984}
# K9's differentiated arms (forward with the row log-sum-exp, backward,
# forward mode; q_offset 0), b, h, hkv, sq, sk, dh, causal: dh 16, 64 and
# 128, causal and not, GQA (h 8, hkv 2), ragged tiles, in f32 and bf16;
# qwen1.5-0.5b's training shape in bf16 (timed there) and the Hessian-free
# LM example's shape (qwen1.5 SMOKE, batch 4 × 32) in f32.
ATTN_TRAIN = (4, 16, 16, 4096, 4096, 64, True)
ATTN_HF = (4, 4, 4, 32, 32, 16, True)
GRAD_CHECK = ((2, 8, 2, 256, 256, 16, False), (1, 8, 2, 300, 300, 64, True),
              (1, 8, 2, 200, 330, 128, False), (2, 8, 2, 130, 130, 128, True))
GRAD_160_CHECK = (ATTN_160[:7], (1, 32, 8, 300, 333, 160, False))
GRAD_CHECK += GRAD_160_CHECK
# seamless-m4t-large-v2's training shape (the encoder at 2 x 2 048 frames,
# non-causal; timed there) and a ragged cross shape with sq < sk.
ATTN_ENC_TRAIN = (2, 16, 16, 2048, 2048, 64, False)
GRAD_ENCDEC_CHECK = (ATTN_ENC_TRAIN, (1, 16, 16, 100, 333, 64, False))
GRAD_CHECK += GRAD_ENCDEC_CHECK
GRAD_BAR = {"float32": 2e-4, "bfloat16": 5e-2}  # of the plain version's max abs
# train: launch/train.py's build at qwen1.5-0.5b's full width (24 layers,
# d 1024, vocab 151 936, tied; f32 parameters, bf16 compute), 4 × 4 096
# tokens, AdamW lr 1e-4; 6 steps with checkpoints every 3, then the same
# with a failure injected at step 4.
TRAIN = {"arch": "qwen1.5-0.5b", "batch": 4, "seq": 4096, "lr": 1e-4, "steps": 6,
         "every": 3, "fault_at": 4, "arms": ("flash_attention:lse", "flash_attention:bwd"),
         "kernel": "attn", "tag": "[train]"}
# mamba2-1.3b at full width (48 layers, d 2048, 64 SSD heads x 64, state
# 128, vocab 50 280; f32 parameters, bf16 compute), 2 x 1 024 tokens, beside
# 21.5 GB of parameters, gradients and AdamW moments; 4 AdamW steps through
# the step function alone (the Trainer's closing checkpoint of 15.7 GB took
# ≈ 28 s; qwen1.5's cell drives the Trainer and its fault replay).  Every
# train cell runs with cfg.remat (each block
# checkpointed: its forward arm launches twice a step, once recomputed) and
# compares one step's gradients with remat off, bit for bit, with both
# step times and peak memories.
TRAIN_SSM = {"arch": "mamba2-1.3b", "batch": 2, "seq": 1024, "lr": 1e-4, "steps": 4,
             "every": 1000, "fault_at": None, "trainer": False,
             "arms": ("ssd_scan:fwd", "ssd_scan:bwd"),
             "kernel": "ssd_", "tag": "[train mamba2]", "floor_chunk": 64,
             "f32_control_layers": 12}
# hf-lm: examples/hessian_free_lm.py's loop (qwen1.5 SMOKE, batch 4 × 32,
# HFConfig(k=4, ell=8, cg_tol=1e-3, cg_maxiter=50, init_damping=10.0), 10
# steps, recycled and cold); then one step at qwen1.5-0.5b's full widths
# with its depth cut to `full_layers`.
# olmoe-1b-7b at full width (d 2048, 64 experts top-8, capacity factor 1.25,
# vocab 50 304; f32 parameters, bf16 compute) cut to 4 of its 16 layers (at
# 16, its 6.92 B parameters need about 110 GB for parameters, gradients and
# AdamW's moments), 2 x 2 048 tokens; the plain run replays the kernel run's
# routing (models/moe.py: replay_routing), 2 AdamW steps through the step
# function alone (no Trainer: its closing checkpoint of 22.6 GB takes ≈ 29 s
# and this cell replays no fault).
TRAIN_MOE = {"arch": "olmoe-1b-7b", "layers": 4, "batch": 2, "seq": 2048, "lr": 1e-4,
             "steps": 2, "every": 1000, "fault_at": None, "trainer": False,
             "arms": ("flash_attention:lse", "flash_attention:bwd"), "kernel": "attn",
             "tag": "[train olmoe]"}
# seamless-m4t-large-v2 at full width and depth (24 + 24 layers, d 1024,
# vocab 256 206; f32 parameters, bf16 compute), 2 x 2 048 seeded normal
# source frames and 2 x 2 048 tokens with labels (launch/steps.py's train
# batch: one s for both), cfg.remat on; 2 AdamW steps through the step
# function alone (the reference's TokenPipeline makes no source frames, so
# no Trainer).  K9's lse arm launches 144 times a step (72 calls, each
# recomputed) and its backward 72.  bf16 rounding alone moves the decoder's
# query and key gradients past 5e-2 (ROADMAP P7): each leaf is held to twice
# the plain versions' own floor (K9's plain key block 512 against 1 024) and,
# in an f32-compute control with the decoder cut to 12 layers, to 5e-2.
TRAIN_ENCDEC = {"arch": "seamless-m4t-large-v2", "batch": 2, "seq": 2048, "source": 2048,
                "lr": 1e-4, "steps": 2, "every": 1000, "fault_at": None, "trainer": False,
                "arms": ("flash_attention:lse", "flash_attention:bwd"), "kernel": "attn",
                "tag": "[train encdec]", "floor_block_k": 512, "f32_control_layers": 12}
# One mamba2-1.3b step (AdamW included) at 4 x 4 096 tokens, where the
# activations of 48 blocks need cfg.remat.
TRAIN_SSM_BIG = {"arch": "mamba2-1.3b", "batch": 4, "seq": 4096, "lr": 1e-4}
HF_LM = {"arch": "qwen1.5-0.5b", "batch": 4, "seq": 32, "steps": 10, "full_layers": 2,
         "settings": {"k": 4, "ell": 8, "cg_tol": 1e-3, "cg_maxiter": 50, "init_damping": 10.0}}
HF_LM_PATH_KERNELS = ("fused_cg_update", "fused_deflate_direction", "self_gram",
                      "recombine_blocks")
HF_LM_PATH_ARMS = ("flash_attention:lse", "flash_attention:bwd", "flash_attention:jvp")
# ... and mamba2's SMOKE model through the same loop, 3 recycled steps: K10's
# training forward and backward arms in the gradients, its tangent map in
# the GGN products' linearize.
HF_LM_SSM = {"arch": "mamba2-1.3b", "steps": 3}
HF_LM_SSM_PATH_ARMS = ("ssd_scan:fwd", "ssd_scan:bwd", "ssd_scan:jvp")
# K10 (b, l, h, p, g, n, chunk): SSD_CASES and mamba2-1.3b's prefill.
SSD_MAIN = (4, 4096, 64, 64, 1, 128, 128)
# jamba-v0.1-52b's SSD layers (d_inner 8192: 128 heads x 64, state 16, one
# group, chunk 128) at the zoo's prefill of 2 x 2 048 tokens: every K10 arm
# held and timed there too.
SSD_JAMBA = (2, 2048, 128, 64, 1, 16, 128)
SSD_CHECK = ((1, 64, 2, 16, 1, 16, 32), (2, 100, 4, 8, 2, 24, 32), (1, 37, 2, 4, 2, 8, 16),
             (2, 128, 8, 32, 1, 64, 64), SSD_MAIN, SSD_JAMBA)
# K10 on the views models/mamba.py hands it (x, B, C split from one tensor).
SSD_STRIDED = (2, 1000, 64, 64, 1, 128, 128)
# K10's differentiated arms (training forward, backward, tangent map) are
# held at SSD_CHECK's cases and at mamba2-1.3b's training shape (TRAIN_SSM:
# b 2, l 1 024), timed there in bf16.
SSD_TRAIN = (2, 1024, 64, 64, 1, 128, 128)

# Which TPU kernel each port kernel replaces, and the port's source.
REPLACES = {
    "fused_cg_update": "src/repro/kernels/cg_fused.py:122",
    "fused_deflate_direction": "src/repro/kernels/cg_fused.py:426",
    "rbf_matvec": "src/repro/kernels/rbf_matvec.py:77",
    "self_gram": "src/repro/kernels/cg_fused.py:558",
    "recombine_blocks": "src/repro/kernels/cg_fused.py:639",
    "fused_rz_reduce": "src/repro/kernels/cg_fused.py:252",
    "lsmr_update": "src/repro/kernels/cg_fused.py:336",
    "rbf_matvec_rect": "src/repro/kernels/rbf_matvec.py:134",
    "flash_attention": "src/repro/kernels/flash_attention.py:116",
    "ssd_scan": "src/repro/kernels/ssd_scan.py:92",
}
SOURCES = dict.fromkeys(REPLACES, "src/repro_torch/csrc/cg_fused.cu")
SOURCES["rbf_matvec"] = SOURCES["rbf_matvec_rect"] = "src/repro_torch/csrc/rbf_matvec.cu"
SOURCES["flash_attention"] = "src/repro_torch/csrc/flash_attention.cu"
# K9's backward and forward-mode arms: kernels of their own in K9's source,
# each an arm of the TPU kernel's function (whose derivative the reference
# takes by autodiff of its chunked lowering).
for _arm in ("flash_attention_bwd", "flash_attention_jvp"):
    REPLACES[_arm] = REPLACES["flash_attention"]
    SOURCES[_arm] = SOURCES["flash_attention"]
SOURCES["ssd_scan"] = "src/repro_torch/csrc/ssd_scan.cu"
# K10's backward and forward-mode arms likewise (the reference takes the
# scan's derivative by autodiff of its chunked lowering, ops.py:_ssd_chunked).
for _arm in ("ssd_scan_bwd", "ssd_scan_jvp"):
    REPLACES[_arm] = REPLACES["ssd_scan"]
    SOURCES[_arm] = SOURCES["ssd_scan"]
# The arms split off a kernel's launches into entries of their own.
SPLIT_ARMS = {"flash_attention_bwd": "flash_attention:bwd",
              "flash_attention_jvp": "flash_attention:jvp",
              "ssd_scan_bwd": "ssd_scan:bwd", "ssd_scan_jvp": "ssd_scan:jvp"}
DENSE_PATH_KERNELS = ("fused_cg_update", "fused_deflate_direction", "self_gram",
                      "recombine_blocks")
MF_PATH_KERNELS = DENSE_PATH_KERNELS + ("rbf_matvec", "fused_rz_reduce")
LSQ_PATH_KERNELS = ("lsmr_update", "self_gram", "recombine_blocks")
GN_PATH_KERNELS = ("lsmr_update",)
SHARD_PATH_KERNELS = ("fused_cg_update", "fused_deflate_direction", "fused_rz_reduce",
                      "self_gram", "recombine_blocks", "rbf_matvec_rect")
PAPER_PATH_KERNELS = DENSE_PATH_KERNELS
CHAOS_PATH_KERNELS = MF_PATH_KERNELS
# The paper's experiments on the main path's data (benchmarks/paper_fig23.py,
# paper_fig4.py): Fig. 3's solver tol and maxiter, Fig. 4's Newton and
# solver tol and its subsets m = n / div.
FIG3 = {"tol": 1e-8, "maxiter": 800}
FIG4 = {"newton_tol": 1e-3, "solver_tol": 1e-8, "subset_divs": (16, 8, 4, 2)}
# benchmarks/chaos_bench.py's sequence at the cut n = 16 384 (the phase runs
# it five times over K3: 153 s at n = 36 551, so cut to make room for the
# training phases): 4 drifting H½ systems over the
# matrix-free K3 operator, def-CG(8, 12), tol 1e-5, maxiter 400; system 1
# poisoned with NaN; checkpoints every 2 systems; P9's stale refresh at tol
# 1e-10; one Jacobi-preconditioned solve with the stall detector armed
# (window 10) on system 0's operator with every product perturbed by 1e-3
# (tests/test_faults.py's stagnation case).
CHAOS = {"n": CUT_N, "num": 4, "tol": 1e-5, "maxiter": 400, "poisoned": 1, "chunk": 2,
         "stale_tol": 1e-10, "window": 10, "stall_poison": 1e-3, "stall_tol": 1e-12}
# The lane axis of K1's, K6's and K2's step arms: lanes checked against the
# one-lane arm (main's n, k = 8 and 0) and timed.
LANE_SIZES = (1, 8, 64)
# benchmarks/seq_bench.py's strategy_matrix: six genuine Newton systems
# (exact inner solves), def-CG(8, 12), tol 1e-5, maxiter 2000; harmonic,
# windowed and M-geometry (Jacobi), on main's data and dense K.
STRATEGY = {"num": 6, "tol": 1e-5, "maxiter": 2000, "inner_tol": 1e-10}
STRATEGY_PATH_KERNELS = DENSE_PATH_KERNELS + ("fused_rz_reduce",)
# benchmarks/batch_bench.py: B tenants sharing main's K (dense), per-tenant
# H½ and b (_tenants: latents ~ N(0, 0.5²), b ~ N(0, 1), numpy seed 1),
# def-CG(8, 12), tol 1e-5, maxiter 200, against B sequential solves; one
# matrix-free batch over K3 (r = 8) and one pool step with half the slots
# idle.
BATCH = {"sizes": (1, 8, 64), "tol": 1e-5, "maxiter": 200, "mf_lanes": 8, "pool": 8,
         "loop_lanes": 16}  # B = 64's sequential loop: its first 16 tenants, timed × 4
BATCH_PATH_KERNELS = DENSE_PATH_KERNELS + ("rbf_matvec", "fused_rz_reduce")
# K7's step arm on the lane axis: main-lsq's n, B = 1, 8, 64, and armed with
# the stall detector (this window) at B = 8.
LSMR_LANE_WINDOW = 10
# benchmarks/serve_bench.py's traffic on main's dense K (shared): T = B
# tenants with drifting Newton sequences (latents ~ N(0, 0.5²), drift 0.15,
# numpy seed B), Poisson arrivals, def-CG(8, 12), tol 1e-5, maxiter 200; B =
# 8 with 3 systems a tenant beside the sequential loop, B = 64 with 3 (the
# pool alone); then 6 tenants through 4 slots, spilling into a temporary
# directory.
SERVE = {"sizes": (8, 64), "systems": {8: 3, 64: 3}, "loop": (8,), "tol": 1e-5,
         "maxiter": 200, "drift": 0.15, "evict_slots": 4, "evict_tenants": 6}
SERVE_PATH_KERNELS = DENSE_PATH_KERNELS
SERVE_LANE_ARMS = ("fused_cg_update:fused_cg_step_lanes",
                   "fused_deflate_direction:fused_direction_step_lanes")
# Batched least squares: B tenants, each its own lsq_bench drifting ridge
# sequence (logspace, drift 0.02, λ = 1e-4, tol 1e-8, deflsmr(8, 48), numpy
# and torch seeds 0 … B − 1) at half main-lsq's sides, 805 MB a system.
LSQ_BATCH = {"lanes": 8, "m": 12288, "n": 8192, "num": 2, "maxiter": 4000}
LSQ_BATCH_PATH_KERNELS = LSQ_PATH_KERNELS


def log(msg=""):
    print(msg, flush=True)


def peaks_for(name: str) -> dict:
    for key, peaks in PEAKS.items():
        if key in name:
            return peaks
    raise RuntimeError(f"no peak table for card {name!r}")


def device_ms(torch, fn, reps=REPS) -> float:
    """Median device time of one ``fn()``: CUDA events around each of
    ``reps`` calls queued behind a spin kernel (so host launch overhead is
    not timed), with a 96 MiB write before each to evict the 50 MB L2 —
    the def-CG loop reads the 10.7 GB dense K between two calls."""
    flush = torch.empty(96 << 20, dtype=torch.uint8, device="cuda")
    # Warm every kernel of the loop first: a kernel's first launch loads
    # its module, which can block the host until the spin kernel ends.
    for _ in range(2):
        flush.zero_()
        fn()
    torch.cuda.synchronize()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    torch.cuda._sleep(100_000_000)
    for s, e in zip(starts, ends):
        flush.zero_()
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in zip(starts, ends))


def _device_us(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def _is_device(evt) -> bool:
    return "cuda" in str(getattr(evt, "device_type", "")).lower()


def profile_kernels(torch, fn, reps=REPS):
    """Device time per call of each GPU kernel ``fn`` launches, from a
    ``torch.profiler`` trace of ``reps`` calls: ``{kernel name: ms}``."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for evt in prof.key_averages():
        us = _device_us(evt)
        if _is_device(evt) and us > 0 and evt.count >= reps:
            out[evt.key[:60]] = us / reps / 1e3
    return out


def _profiled_kernels(torch, fn, calls):
    """Device kernel events a ``torch.profiler`` session of ``calls`` calls
    of ``fn`` records."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages() if _is_device(e) and _device_us(e) > 0)


def kernels_per_call(torch, fn, reps=REPS):
    """Device kernels launched by one ``fn()``: the difference between a
    ``torch.profiler`` session of ``2 reps`` calls and one of ``reps``,
    over ``reps``.  Some sessions come back with no device events, others
    one or a few short (on some machines every session drops one); the
    difference cancels a constant loss, and a pair that gives no events
    or not a whole number of kernels a call is run again (three at most)."""
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        one, two = _profiled_kernels(torch, fn, reps), _profiled_kernels(torch, fn, 2 * reps)
        if one and two and (two - one) % reps == 0:
            break
    return (two - one) / reps


def compare(torch, got, want, dtype_name, what):
    """Max abs error of a kernel output against its plain version; raises
    when the error relative to the output's scale passes the tolerance."""
    got = [g for g in got if g is not None]
    want = [w for w in want if w is not None]
    if len(got) != len(want):
        raise AssertionError(f"{what}: {len(got)} outputs, plain gave {len(want)}")
    worst_abs = 0.0
    for g, w in zip(got, want):
        if g.shape != w.shape or not bool(torch.isfinite(g).all()):
            raise AssertionError(f"{what}: bad output shape or non-finite values")
        err = float((g - w).abs().max())
        scale = max(1.0, float(w.abs().max()))
        if err / scale > TOL[dtype_name]:
            raise AssertionError(
                f"{what}: error {err:.3e} (relative {err / scale:.3e}) "
                f"> {TOL[dtype_name]}"
            )
        worst_abs = max(worst_abs, err)
    return worst_abs


def kernel_inputs(torch, n, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device="cuda", dtype=dtype)

    t = {
        "x": rnd(n), "r": rnd(n), "p": rnd(n), "ap": rnd(n),
        "aw": rnd(K, n), "w": rnd(K, n), "mu": rnd(K), "waw_inv": rnd(K, K),
        "alpha": rnd(()), "beta": rnd(()), "so": rnd(2 + K),
        "p_buf": rnd(ELL + 1, n), "ap_buf": rnd(ELL + 1, n),
        "idx": torch.tensor(5, device="cuda"), "on": torch.tensor(True, device="cuda"),
        "s": rnd(2 * M, n), "u": rnd(M, K),
    }
    t["rs"] = torch.dot(t["r"], t["r"])
    return t


def kernel_calls(cf, t):
    """name -> list of (label, kernel call, plain call) on inputs ``t``.
    K6's and K2's first arms are their step arms, the arms the main paths
    run (K2's reads β and μ from a view of a packed ``[rs', β, μ…]``, as
    the loops hand it K6's or K1's step output)."""
    bufs = lambda: (t["p_buf"].clone(), t["ap_buf"].clone())  # noqa: E731
    # The step arms' recording targets, allocated here, not in the timed
    # calls: a copy or fill there is a device kernel of its own.
    rows = dict(row=3, a_rows=t["p_buf"].new_zeros(ELL + 1), b_rows=t["p_buf"].new_zeros(ELL + 1))
    rec = dict(ap=t["ap"], active=t["on"], row=3, p_buf=t["p_buf"], ap_buf=t["ap_buf"])
    beta, mu = t["so"][1], t["so"][2:]
    rz_step = dict(alpha=t["alpha"], active=t["on"])
    return {
        "fused_cg_update": [
            ("aw", lambda: cf.fused_cg_update_cuda(t["x"], t["r"], t["p"], t["ap"], t["alpha"], t["aw"]),
             lambda: cf.fused_cg_update_plain(t["x"], t["r"], t["p"], t["ap"], t["alpha"], t["aw"])),
            ("no-aw", lambda: cf.fused_cg_update_cuda(t["x"], t["r"], t["p"], t["ap"], t["alpha"]),
             lambda: cf.fused_cg_update_plain(t["x"], t["r"], t["p"], t["ap"], t["alpha"])),
        ],
        "fused_deflate_direction": [
            ("step", lambda: (cf.fused_direction_step_cuda(t["r"], t["p"], beta, t["on"], t["w"], mu),),
             lambda: (cf.fused_direction_step_plain(t["r"], t["p"], beta, t["on"], t["w"], mu),)),
            ("step-rec", lambda: (cf.fused_direction_step_cuda(t["r"], t["p"], beta, t["on"], t["w"], mu, **rec),),
             lambda: (cf.fused_direction_step_plain(t["r"], t["p"], beta, t["on"], t["w"], mu, **rec),)),
            ("step-k0", lambda: (cf.fused_direction_step_cuda(t["r"], t["p"], beta, t["on"]),),
             lambda: (cf.fused_direction_step_plain(t["r"], t["p"], beta, t["on"]),)),
            ("direction", lambda: cf.fused_deflate_direction_cuda(t["r"], t["p"], t["beta"], t["w"], t["mu"]),
             lambda: cf.fused_deflate_direction_plain(t["r"], t["p"], t["beta"], t["w"], t["mu"])),
            ("buffered", lambda: cf.fused_deflate_direction_cuda(t["r"], t["p"], t["beta"], t["w"], t["mu"], t["ap"], t["idx"], *bufs()),
             lambda: cf.fused_deflate_direction_plain(t["r"], t["p"], t["beta"], t["w"], t["mu"], t["ap"], t["idx"], *bufs())),
            ("plain-cg", lambda: cf.fused_deflate_direction_cuda(t["r"], t["p"], t["beta"]),
             lambda: cf.fused_deflate_direction_plain(t["r"], t["p"], t["beta"])),
        ],
        "self_gram": [
            ("S", lambda: (cf.self_gram_cuda(t["s"]),), lambda: (cf.self_gram_plain(t["s"]),)),
        ],
        "fused_rz_reduce": [
            ("step", lambda: (cf.fused_rz_step_cuda(t["r"], t["p"], t["rs"], t["aw"], t["waw_inv"]),),
             lambda: (cf.fused_rz_step_plain(t["r"], t["p"], t["rs"], t["aw"], t["waw_inv"]),)),
            ("step-rec", lambda: (cf.fused_rz_step_cuda(t["r"], t["p"], t["rs"], t["aw"], t["waw_inv"], **rz_step, **rows),),
             lambda: (cf.fused_rz_step_plain(t["r"], t["p"], t["rs"], t["aw"], t["waw_inv"], **rz_step, **rows),)),
            ("pair", lambda: cf.fused_rz_pair_cuda(t["r"], t["ap"], t["aw"]),
             lambda: cf.fused_rz_pair_plain(t["r"], t["ap"], t["aw"])),
            ("aw", lambda: cf.fused_rz_reduce_cuda(t["r"], t["p"], t["aw"]),
             lambda: cf.fused_rz_reduce_plain(t["r"], t["p"], t["aw"])),
            ("no-aw", lambda: cf.fused_rz_reduce_cuda(t["r"], t["p"]),
             lambda: cf.fused_rz_reduce_plain(t["r"], t["p"])),
        ],
        "recombine_blocks": [
            ("S,u", lambda: (cf.recombine_blocks_cuda(t["s"], t["u"]),),
             lambda: (cf.recombine_blocks_plain(t["s"], t["u"]),)),
        ],
    }


def work(name, n, itemsize):
    """(bytes moved, operations) of one call at the main path's shapes:
    each input read once, each output written once."""
    if name == "fused_cg_update":
        return (6 * n + K * n + K + 2) * itemsize, (6 + 2 * K) * n
    if name == "fused_deflate_direction":
        return (3 * n + K * n + K + 1) * itemsize, (2 + 2 * K) * n
    if name == "self_gram":
        m2 = 2 * M
        return (m2 * n + m2 * m2) * itemsize, m2 * (m2 + 1) * n
    if name == "recombine_blocks":
        return (2 * M * n + M * K + 2 * K * n) * itemsize, 4 * K * M * n
    if name == "fused_rz_reduce":
        return ((2 + K) * n + K + 1) * itemsize, 2 * (1 + K) * n
    if name == "fused_rz_step":  # r, z, AW, (WᵀAW)⁻¹, rs, α in; [rs', β, μ] out
        return ((2 + K) * n + K * K + 2 + 2 + K) * itemsize, 2 * (1 + K) * n + 2 * K * K + 1
    if name == "fused_rz_pair":  # r, ap, AW in; both sets of sums out
        return ((2 + K) * n + 2 * (1 + K)) * itemsize, 4 * (1 + K) * n
    if name == "fused_direction_step":  # as the TPU arm; the keep flag besides
        return (3 * n + K * n + K + 1) * itemsize + 1, (2 + 2 * K) * n
    if name == "lsmr_update":  # x, h̄, h, v and c0..c2 in; x', h̄', h' out
        return (7 * n + 3) * itemsize, 6 * n
    raise KeyError(name)


def ops_peak(peaks, name, dname):
    """The card's peak rate for ``name``'s operations in ``dname``."""
    if dname == "float64" and name in GEMM_SHAPED:
        return peaks["float64_tensor"]
    return peaks[dname]


def phase_kernels(torch, cf, peaks):
    f64 = torch.float64
    report = {}
    for dtype in (torch.float64, torch.float32):
        dname = str(dtype).split(".")[-1]
        for n in (PAPER_N, CUT_N, RAGGED_N):
            t = kernel_inputs(torch, n, dtype, seed=n)
            for name, calls in kernel_calls(cf, t).items():
                for label, kern, plain in calls:
                    got, want = kern(), plain()
                    torch.cuda.synchronize()
                    err = compare(torch, got, want, dname, f"{name}[{label}] {dname} n={n}")
                    log(f"[kernels] {name:24s} {label:9s} {dname} n={n:6d}: max abs err {err:.3e}")
                    if dtype == f64 and n == PAPER_N:
                        entry = report.setdefault(name, {"max_abs_err": 0.0})
                        entry["max_abs_err"] = max(entry["max_abs_err"], err)

    t = kernel_inputs(torch, PAPER_N, f64, seed=1)
    ut = t["u"].T
    # One PyTorch call computing the timed arm's function, where one exists.
    # K6's and K2's timed arms are their step arms (no single call); K6's
    # no-AW arm is timed beside torch.dot and K2's k = 0 step arm beside
    # torch.addcmul below.
    library = {
        "self_gram": lambda: t["s"] @ t["s"].T,
        "recombine_blocks": lambda: torch.matmul(ut, t["s"].view(2, M, PAPER_N)),
    }
    calls = kernel_calls(cf, t)
    for name, entry in report.items():
        _, kern, plain = calls[name][0]
        nbytes, ops = work(TIMED_ARM.get(name, name), PAPER_N, 8)
        entry["ms"] = device_ms(torch, kern)
        entry["plain_ms"] = device_ms(torch, plain)
        entry["library_ms"] = device_ms(torch, library[name]) if name in library else None
        t_bytes, t_ops = nbytes / peaks["bytes"], ops / ops_peak(peaks, name, "float64")
        entry["bound_ms"] = 1e3 * max(t_bytes, t_ops)
        entry["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
        entry["profiled_kernels_ms"] = profile_kernels(torch, kern)
        extra = f" profiler {entry['profiled_kernels_ms']}"
        if name in TIMED_ARM:
            extra += arms_timing(torch, cf, name, entry, t, calls[name], peaks)
        if name in ("self_gram", "recombine_blocks"):
            extra += f" previous design {PREVIOUS_MS.get(f'{name} {2 * M}x{PAPER_N}')} ms"
        log(f"[timing] {name:24s} f64 n={PAPER_N}: kernel {entry['ms']:.4f} ms, plain "
            f"{entry['plain_ms']:.4f} ms, library {entry['library_ms']} ms, bound "
            f"{entry['bound_ms']:.4f} ms ({entry['bound_by']}){extra}")
    return report


def arms_timing(torch, cf, name, entry, t, calls, peaks):
    """K6's and K2's arms at the main path's n (f64, k = 8): each timed, its
    device kernels a call counted (one each, or the phase fails), beside
    the previous design's time; K6's no-AW arm beside ``torch.dot(r, z)``,
    its pair arm at main-shard's per-rank n beside the two one-vector calls
    it replaces, K2's k = 0 step arm beside ``torch.addcmul(r, β, p)``.
    Returns the log line's tail."""
    arms = {label: kern for label, kern, _ in calls}
    if name == "fused_rz_reduce":
        n_loc = SHARD_N // SHARD_RANKS
        r, ap, aw = t["r"][:n_loc], t["ap"][:n_loc], t["aw"][:, :n_loc].contiguous()
        arms["pair n_loc"] = lambda: cf.fused_rz_pair_cuda(r, ap, aw)
        two = lambda: (cf.fused_rz_reduce_cuda(r, ap, aw), cf.fused_rz_reduce_cuda(r, r, aw))  # noqa: E731
        library = {"no-aw": lambda: torch.dot(t["r"], t["p"]), "pair n_loc": two}
        previous = {"aw": PREVIOUS_MS["fused_rz_reduce float64 n=36551"],
                    "no-aw": PREVIOUS_MS["fused_rz_reduce no-aw float64 n=36551"]}
        nbytes, ops = work("fused_rz_pair", n_loc, 8)
        entry["pair_n"] = n_loc
        entry["pair_bound_ms"] = 1e3 * max(nbytes / peaks["bytes"], ops / peaks["float64"])
    else:
        # The buffered arm's check writes copies of the buffers; timed, it
        # writes the buffers themselves.
        arms["buffered"] = lambda: cf.fused_deflate_direction_cuda(
            t["r"], t["p"], t["beta"], t["w"], t["mu"], t["ap"], t["idx"], t["p_buf"], t["ap_buf"])
        library = {"step-k0": lambda: torch.addcmul(t["r"], t["so"][1], t["p"])}
        previous = {"direction": PREVIOUS_MS["fused_deflate_direction float64 n=36551"],
                    "buffered": PREVIOUS_MS["fused_deflate_direction recording float64 n=36551"]}
    arms.pop("plain-cg", None)
    entry["arms"] = out = {}
    for label, fn in arms.items():
        out[label] = a = {"ms": device_ms(torch, fn), "kernels_per_call": kernels_per_call(torch, fn),
                          "previous_design_ms": previous.get(label)}
        if label in library:
            a["library_ms"] = device_ms(torch, library[label])
        if a["kernels_per_call"] != 1:
            raise AssertionError(f"[timing] {name}[{label}]: {a['kernels_per_call']} device "
                                 "kernels a call, not one")
    return "; arms " + ", ".join(
        f"{label} {a['ms']:.4f} ms" + (f" (previous {a['previous_design_ms']})"
                                       if a["previous_design_ms"] else "")
        + (f" beside {a['library_ms']:.4f}" if "library_ms" in a else "")
        for label, a in out.items()) + ", one device kernel a call each"


def rbf_inputs(torch, n, d, r, dtype, seed, device="cuda"):
    """Pixel-like data in [0, 1) (the digits' range) and Gaussian V."""
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.rand((n, d), generator=g, device=device, dtype=dtype)
    v = torch.randn((n, r), generator=g, device=device, dtype=dtype)
    return x, v


def phase_rbf(torch, rbf, peaks):
    """The RBF Gram matvec against its plain version in f64 and f32 at the
    paper's n, the cut n of the preconditioned sequences and a ragged n,
    then timed at the main path's shapes.  The f32 bound is taken at the
    FP32 vector rate, not the TF32 tensor-core rate: TF32's 10-bit
    mantissa cannot hold ‖xᵢ‖² + ‖xⱼ‖² − 2xᵢ·xⱼ to the f32 tolerance, so
    no f32 kernel of this accuracy can run at that rate."""
    report = {"max_abs_err": 0.0}
    for dtype in (torch.float64, torch.float32):
        dname = str(dtype).split(".")[-1]
        for n, d in ((PAPER_N, D), (CUT_N, D), (RAGGED_N, 50)):
            for r in RBF_RS:
                x, v = rbf_inputs(torch, n, d, r, dtype, seed=n + r)
                got = rbf.rbf_matvec_cuda(x, v, THETA, LENGTHSCALE)
                want = rbf.rbf_matvec_plain(x, v, THETA, LENGTHSCALE, BLOCK)
                torch.cuda.synchronize()
                what = f"rbf_matvec {dname} n={n} d={d} r={r}"
                if got.shape != want.shape or not bool(torch.isfinite(got).all()):
                    raise AssertionError(f"{what}: bad output shape or non-finite values")
                err = float((got - want).abs().max())
                if dtype == torch.float64:
                    scale = max(1.0, float(want.abs().max()))
                    if err / scale > TOL["float64"]:
                        raise AssertionError(f"{what}: relative error {err / scale:.3e}")
                    if n == PAPER_N:
                        report["max_abs_err"] = max(report["max_abs_err"], err)
                        if not torch.equal(got, rbf.rbf_matvec_cuda(x, v, THETA, LENGTHSCALE)):
                            raise AssertionError(f"{what}: two launches differ")
                else:
                    rtol, atol = RBF_TOL_F32
                    if bool(((got - want).abs() > atol + rtol * want.abs()).any()):
                        raise AssertionError(f"{what}: error {err:.3e} past {RBF_TOL_F32}")
                log(f"[kernels] rbf_matvec {dname} n={n:6d} d={d} r={r:2d}: max abs err "
                    f"{err:.3e} (max |y| {float(want.abs().max()):.3e})")

    timings = {}
    for dtype, rs in ((torch.float64, RBF_RS), (torch.float32, (1,))):
        dname = str(dtype).split(".")[-1]
        itemsize = 8 if dtype == torch.float64 else 4
        peak = peaks["float64_tensor"] if dtype == torch.float64 else peaks["float32"]
        for r in rs:
            x, v = rbf_inputs(torch, PAPER_N, D, r, dtype, seed=r)
            kms = device_ms(torch, lambda: rbf.rbf_matvec_cuda(x, v, THETA, LENGTHSCALE),
                            RBF_REPS)
            pms = device_ms(torch, lambda: rbf.rbf_matvec_plain(x, v, THETA, LENGTHSCALE, BLOCK),
                            RBF_REPS)
            nbytes, ops = rbf_work(PAPER_N, D, r, itemsize)
            t_bytes, t_ops = nbytes / peaks["bytes"], ops / peak
            timings[f"{dname} r={r}"] = t = {
                "ms": kms, "plain_ms": pms, "bound_ms": 1e3 * max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "tflop_s": ops / kms / 1e9,
            }
            log(f"[timing] rbf_matvec {dname} n={PAPER_N} d={D} r={r:2d}: kernel {kms:.2f} ms "
                f"({t['tflop_s']:.2f} TFLOP/s; previous design "
                f"{PREVIOUS_MS.get(f'rbf_matvec {dname} r={r}')} ms), plain {pms:.2f} ms, bound "
                f"{t['bound_ms']:.2f} ms ({t['bound_by']}), library null")
    main = timings["float64 r=1"]
    report.update(ms=main["ms"], plain_ms=main["plain_ms"], library_ms=None,
                  bound_ms=main["bound_ms"], bound_by=main["bound_by"], timings=timings)
    x, v = rbf_inputs(torch, PAPER_N, D, 1, torch.float64, seed=1)
    report["profiled_kernels_ms"] = profile_kernels(
        torch, lambda: rbf.rbf_matvec_cuda(x, v, THETA, LENGTHSCALE), reps=2)
    log(f"[timing] rbf_matvec profiler {report['profiled_kernels_ms']}")
    return report


def phase_scale(torch, rbf):
    """One Gram matvec each in f32 and f64 at n = 131 072, where a dense K
    does not fit the card."""
    out = {}
    for dtype in (torch.float32, torch.float64):
        dname = str(dtype).split(".")[-1]
        itemsize = 8 if dtype == torch.float64 else 4
        x, v = rbf_inputs(torch, SCALE_N, D, 1, dtype, seed=7)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        y = rbf.rbf_matvec_cuda(x, v, THETA, LENGTHSCALE)
        end.record()
        torch.cuda.synchronize()
        if y.shape != (SCALE_N, 1) or not bool(torch.isfinite(y).all()):
            raise AssertionError(f"[scale] {dname}: bad output")
        ms = start.elapsed_time(end)
        out[dname] = {"ms": ms, "dense_k_gb": SCALE_N * SCALE_N * itemsize / 1e9}
        log(f"[scale] rbf_matvec {dname} n={SCALE_N} d={D}: {ms:.1f} ms "
            f"(a dense K would need {out[dname]['dense_k_gb']:.0f} GB)")
        del x, v, y
    return out


def phase_rect_kernels(torch, rbf, peaks):
    """K8 (``rbf_matvec_rect``) against its plain version in f64 (1e-12
    relative) and f32 (K3's bars) at K8_SHAPES, d = 784, r = 1 and 8; then
    timed (CUDA events, median of 3, L2 flushed) at the shapes of 4 and 8
    ranks and the paper's n, beside the dense GEMV over the materialized
    (m, n) block.  Bound: ``rect_work`` at the FP64 tensor-core rate (f32:
    the FP32 vector rate, as K3)."""
    report = {"max_abs_err": 0.0, "timings": {}}
    for dtype in (torch.float64, torch.float32):
        dname = str(dtype).split(".")[-1]
        for m, n in K8_SHAPES:
            for r in K8_RS:
                g = torch.Generator(device="cuda").manual_seed(m + n + r)
                xr = torch.rand((m, D), generator=g, device="cuda", dtype=dtype)
                xc = torch.rand((n, D), generator=g, device="cuda", dtype=dtype)
                v = torch.randn((n, r), generator=g, device="cuda", dtype=dtype)
                got = rbf.rbf_matvec_rect_cuda(xr, xc, v, THETA, LENGTHSCALE)
                want = rbf.rbf_matvec_rect_plain(xr, xc, v, THETA, LENGTHSCALE, BLOCK)
                torch.cuda.synchronize()
                what = f"rbf_matvec_rect {dname} m={m} n={n} r={r}"
                if got.shape != want.shape or not bool(torch.isfinite(got).all()):
                    raise AssertionError(f"{what}: bad output shape or non-finite values")
                err = float((got - want).abs().max())
                if dtype == torch.float64:
                    scale = max(1.0, float(want.abs().max()))
                    if err / scale > TOL["float64"]:
                        raise AssertionError(f"{what}: relative error {err / scale:.3e}")
                    if (m, n) == K8_SHAPES[0]:
                        report["max_abs_err"] = max(report["max_abs_err"], err)
                else:
                    rtol, atol = RBF_TOL_F32
                    if bool(((got - want).abs() > atol + rtol * want.abs()).any()):
                        raise AssertionError(f"{what}: error {err:.3e} past {RBF_TOL_F32}")
                log(f"[kernels] rbf_matvec_rect {dname} m={m:5d} n={n:5d} r={r}: max abs err "
                    f"{err:.3e} (max |y| {float(want.abs().max()):.3e})")

    timed = [(torch.float64, shape, r) for shape in K8_SHAPES[:3] for r in (1,)]
    timed += [(torch.float64, K8_SHAPES[0], K), (torch.float32, K8_SHAPES[0], 1)]
    for dtype, (m, n), r in timed:
        dname = str(dtype).split(".")[-1]
        itemsize = 8 if dtype == torch.float64 else 4
        peak = peaks["float64_tensor"] if dtype == torch.float64 else peaks["float32"]
        g = torch.Generator(device="cuda").manual_seed(r)
        xr = torch.rand((m, D), generator=g, device="cuda", dtype=dtype)
        xc = torch.rand((n, D), generator=g, device="cuda", dtype=dtype)
        v = torch.randn((n, r), generator=g, device="cuda", dtype=dtype)
        kms = device_ms(torch, lambda: rbf.rbf_matvec_rect_cuda(xr, xc, v, THETA, LENGTHSCALE),
                        RBF_REPS)
        pms = device_ms(torch, lambda: rbf.rbf_matvec_rect_plain(xr, xc, v, THETA, LENGTHSCALE,
                                                                 BLOCK), RBF_REPS)
        nbytes, ops = rect_work(m, n, D, r, itemsize)
        t_bytes, t_ops = nbytes / peaks["bytes"], ops / peak
        t = {"ms": kms, "plain_ms": pms, "bound_ms": 1e3 * max(t_bytes, t_ops),
             "bound_by": "bytes" if t_bytes >= t_ops else "operations",
             "tflop_s": ops / kms / 1e9}
        if r == 1:  # the dense GEMV over the materialized (m, n) block
            xrs, xcs = xr / LENGTHSCALE, xc / LENGTHSCALE
            kb = (xrs @ xcs.T).mul_(-2.0).add_(xrs.pow(2).sum(1)[:, None]
                                               + xcs.pow(2).sum(1)[None, :])
            kb.clamp_(min=0.0).mul_(-0.5).exp_().mul_(THETA**2)
            t["block_gemv_ms"] = device_ms(torch, lambda: kb @ v[:, 0])
            del kb, xrs, xcs
        key = f"{dname} m={m} n={n} r={r}"
        report["timings"][key] = t
        log(f"[timing] rbf_matvec_rect {dname} m={m} n={n} d={D} r={r}: kernel {kms:.2f} ms "
            f"({t['tflop_s']:.2f} TFLOP/s; previous design "
            f"{PREVIOUS_MS.get('rbf_matvec_rect ' + key)} ms), plain {pms:.2f} ms, bound "
            f"{t['bound_ms']:.3f} ms "
            f"({t['bound_by']}), library null"
            + (f", dense GEMV over the materialized block {t['block_gemv_ms']:.4f} ms"
               if "block_gemv_ms" in t else ""))
    main = report["timings"][f"float64 m={K8_SHAPES[0][0]} n={K8_SHAPES[0][1]} r=1"]
    report.update(ms=main["ms"], plain_ms=main["plain_ms"], library_ms=None,
                  bound_ms=main["bound_ms"], bound_by=main["bound_by"])
    return report


def laplace_runs(torch, launches, x, y, k_dense, solver_tol, log_prefix,
                 solvers=("cholesky", "cg", "defcg", "spec"), dense=True):
    """One ``laplace_gpc`` Newton sequence per solver: ``cholesky``, ``cg``,
    ``defcg`` (RecycleManager), ``spec`` (the front door), or ``jacobi`` /
    ``nystrom`` (the front door, preconditioned).  ``dense`` applies K as
    the dense ``k_dense @ v``; otherwise through the RBF Gram matvec."""
    from repro_torch.core import RecycleManager, SolveSpec
    from repro_torch.gp import RBFKernel, laplace_gpc

    runs = {}
    for solver in solvers:
        kw = {"solver": solver}
        if solver == "defcg":
            kw["recycle"] = RecycleManager(k=K, ell=ELL)
        if solver in ("spec", "jacobi", "nystrom"):
            precond = "none" if solver == "spec" else solver
            kw = {"spec": SolveSpec(k=K, ell=ELL, tol=solver_tol, precond=precond,
                                    precond_rank=PRECOND_RANK)}
            if solver == "nystrom":
                kw["precond_generator"] = torch.Generator().manual_seed(0)
        before = dict(launches)
        t0 = time.perf_counter()
        res = laplace_gpc(
            x, y, RBFKernel(theta=THETA, lengthscale=LENGTHSCALE),
            solver_tol=solver_tol, newton_tol=1.0, block=BLOCK,
            k_dense=k_dense, dense_matvec=dense, **kw,
        )
        if x.is_cuda:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        f = res.f
        if f.shape != x.shape[:1] or not bool(torch.isfinite(f).all()):
            raise AssertionError(f"{solver}: non-finite or misshaped latent f")
        acc = float((torch.sign(f) == y).double().mean())
        launched = {k: launches[k] - before[k] for k in before}
        runs[solver] = {
            "logp": res.logp,
            "logp_trace": res.trace.logp,
            "newton_steps": len(res.trace.logp),
            "iterations": res.trace.solver_iterations,
            "matvecs": res.trace.solver_matvecs,
            "cumulative_solve_s": res.trace.cumulative_time,
            "wall_s": wall,
            "train_accuracy": acc,
            "launches": launched,
        }
        log(f"{log_prefix} {solver:8s} logp={res.logp:.10f} newton={len(res.trace.logp)} "
            f"iters={res.trace.solver_iterations} matvecs={res.trace.solver_matvecs} "
            f"solve_s={[round(v, 4) for v in res.trace.cumulative_time]} wall={wall:.2f}s "
            f"acc={acc:.4f} launches={launched}")
    return runs


def step_states(torch, n, dtype, seed, case, k=K):
    """Inputs of K1's and K7's step arms on the card: ``case`` is "live",
    "frozen", "breakdown" (K1: pᵀAp < 0; K7: c̄ = NaN) or "exact" (K7:
    β⁺ = 0, the exact-termination latch).  Returns ``(cg_args, lsmr_args)``."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device="cuda", dtype=dtype)

    def scalar(v):
        return torch.tensor(v, dtype=dtype, device="cuda")

    js = torch.tensor([2, 0], dtype=torch.int32, device="cuda")
    active = torch.tensor(case != "frozen", device="cuda")
    x, r, p, ap = (rnd(n) for _ in range(4))
    d = torch.dot(p, ap).abs() + 1.0
    if case == "breakdown":
        d = -d
    rs = torch.dot(r, r)
    cg = (x, r, p, ap, d, rs, torch.sqrt(rs), js, active, scalar(1e-6), scalar(1e8), 100,
          rnd(k, n), rnd(k, k))
    w = rnd(n)
    s = rnd(7).abs() + 0.1
    if case == "breakdown":
        s[5] = float("nan")
    beta = scalar(0.0) if case == "exact" else rnd(()).abs() + 0.1
    lsmr = (rnd(n), rnd(n), rnd(n), rnd(n), w, torch.dot(w, w), beta, s, js, active,
            scalar(1e-6), scalar(1e8), 100)
    return cg, lsmr


def _same(torch, a, b):
    return torch.equal(torch.isnan(a), torch.isnan(b)) and torch.equal(
        torch.nan_to_num(a), torch.nan_to_num(b))


def check_cg_step(torch, cf, args, dname, what):
    """K1's step arm against its plain version: α, j, the status and the
    flags bit for bit; √rr, β = rr / safe(rs) and μ (its fixed order, from
    the kernel's own sums) bit for bit; the sums and vectors to the kernel
    bar; a repeat bit for bit.  Returns the max abs error."""
    x, r, p, ap, d, rs, rnorm, js, active = args[:9]
    aw, waw_inv = args[12], args[13]
    got = cf.fused_cg_step_cuda(*args[:3], ap.clone(), *args[4:])
    want = cf.fused_cg_step_plain(*args[:3], ap.clone(), *args[4:])
    again = cf.fused_cg_step_cuda(*args[:3], ap.clone(), *args[4:])
    torch.cuda.synchronize()
    so, sw = got[3], want[3]
    err = compare(torch, got[:3] + (so,), want[:3] + (sw,), dname, what)
    _, _, rr2, awr = cf.fused_cg_update_cuda(x, r, p, got[2], so[2], aw)
    mu = torch.zeros_like(so[4:])
    for j in range(mu.shape[0]):
        mu = mu + waw_inv[:, j] * awr[j]
    exact = {
        "alpha": torch.equal(so[2], sw[2]), "js": torch.equal(got[4], want[4]),
        "flags": torch.equal(got[5], want[5]), "rr both arms": torch.equal(rr2, so[0]),
        "rnorm": torch.equal(so[1], torch.where(active, torch.sqrt(so[0]), rnorm)),
        "beta": torch.equal(so[3], so[0] / torch.where(rs == 0.0, 1.0, rs)),
        "mu": torch.equal(so[4:], mu),
        "repeat": all(_same(torch, a, b) for a, b in zip(got, again)),
    }
    if not all(exact.values()):
        raise AssertionError(f"{what}: not bit for bit: {exact}")
    return err


def check_lsmr_step(torch, cf, args, dname, what):
    """K7's step arm against its plain version: every scalar, j, the
    status and the active flag bit for bit, the vectors to the kernel bar
    (NaN where the plain version has NaN), a repeat bit for bit."""
    got = cf.lsmr_step_cuda(*args)
    want = cf.lsmr_step_plain(*args)
    again = cf.lsmr_step_cuda(*args)
    torch.cuda.synchronize()
    for g_, w_ in zip(got[:4], want[:4]):
        if not torch.equal(torch.isfinite(g_), torch.isfinite(w_)):
            raise AssertionError(f"{what}: non-finite entries differ")
    err = compare(torch, [torch.nan_to_num(t) for t in got[:4]],
                  [torch.nan_to_num(t) for t in want[:4]], dname, what)
    exact = {"scalars": _same(torch, got[4], want[4]), "js": torch.equal(got[5], want[5]),
             "active": torch.equal(got[6], want[6]),
             "repeat": all(_same(torch, a, b) for a, b in zip(got, again))}
    if not all(exact.values()):
        raise AssertionError(f"{what}: not bit for bit: {exact}")
    return err


# The stall detector's states against a step's fresh residual r' (best far
# above it, at it, at r' / 0.99 where the bar's own rounding decides, the
# latching step, a frozen step), checked with window STALL_WINDOW.
STALL_CASES = ("improved", "stall", "bar", "latch", "frozen")
STALL_WINDOW = 4


def armed_step_args(torch, cf, cg_args, lsmr_args, case):
    """K1's and K7's step-arm inputs with the stall detector armed:
    ``js`` gains the stall count (``window − 1`` on the latching step),
    and the best residual is set against the window-0 arm's fresh residual
    as ``case`` says.  Returns ``(cg_args, best, lsmr_args)``."""
    def best_for(fresh):
        return {"improved": 1.5 * fresh, "bar": fresh / 0.99}.get(case, fresh).reshape(())

    def js3(js):
        stall = STALL_WINDOW - 1 if case == "latch" else 1
        return torch.cat([js, torch.tensor([stall], dtype=torch.int32, device=js.device)])

    base = cf.fused_cg_step_cuda(*cg_args[:3], cg_args[3].clone(), *cg_args[4:])
    best = best_for(torch.sqrt(base[3][0])).contiguous()
    cg = cg_args[:7] + (js3(cg_args[7]),) + cg_args[8:]
    live = lsmr_args[:9] + (torch.ones_like(lsmr_args[9]),) + lsmr_args[10:]
    normar = cf.lsmr_step_cuda(*live)[4][1].abs()
    ls = lsmr_args[:7] + (torch.cat([lsmr_args[7], best_for(normar).reshape(1)]),
                          js3(lsmr_args[8])) + lsmr_args[9:]
    return cg, best, ls


def check_armed_steps(torch, cf, cg_args, lsmr_args, case, what):
    """The armed step arms in one stall state: every window-0 output bit
    for bit; K1's ``(best', stall', fail')`` those of
    ``cg_fused.stagnation_update`` (eager ops on the card) on the kernel's
    own ``√rr``, K7's scalars, status and flag its plain version's, bit for
    bit; STAGNATED latched exactly on the latching step."""
    cg, best, ls = armed_step_args(torch, cf, cg_args, lsmr_args, case)
    base = cf.fused_cg_step_cuda(*cg_args[:3], cg_args[3].clone(), *cg_args[4:])
    got = cf.fused_cg_step_cuda(*cg[:3], cg[3].clone(), *cg[4:], window=STALL_WINDOW, best=best)
    want = cf.stagnation_update(best, cg[7][2], torch.sqrt(base[3][0]), base[4][1], cg[8],
                                STALL_WINDOW)
    latched = int(want[2]) == cf.STAGNATED
    k7_base = cf.lsmr_step_cuda(*lsmr_args)
    k7 = cf.lsmr_step_cuda(*ls, window=STALL_WINDOW)
    k7_plain = cf.lsmr_step_plain(*ls, window=STALL_WINDOW)
    torch.cuda.synchronize()
    exact = {
        "K1 window-0 outputs": all(_same(torch, a, b) for a, b in zip(got[:3], base[:3]))
        and _same(torch, got[3][:-1], base[3]) and bool(got[4][0] == base[4][0])
        and bool(got[5][1] == base[5][1]),
        "K1 detector": _same(torch, got[3][-1], want[0]) and bool(got[4][2] == want[1])
        and bool(got[4][1] == want[2]),
        "K1 latch": latched == (case == "latch")
        and bool(got[5][0]) == (bool(base[5][0]) and not latched),
        "K7 window-0 outputs": all(_same(torch, a, b) for a, b in zip(k7[:4], k7_base[:4]))
        and _same(torch, k7[4][:-1], k7_base[4]),
        "K7 plain": _same(torch, k7[4], k7_plain[4]) and torch.equal(k7[5], k7_plain[5])
        and torch.equal(k7[6], k7_plain[6]),
        "K7 latch": (int(k7[5][1]) == cf.STAGNATED) == (case == "latch"),
    }
    if not all(exact.values()):
        raise AssertionError(f"{what}: {exact}")


def step_work(name, n, itemsize, k=K):
    """(bytes, operations) of one step-arm call: each vector read and
    written once, the scalars besides."""
    if name == "fused_cg_update":  # x, r, p, ap, AW, (AW)ᵀ… in; x', r' out
        return ((6 + k) * n + k * k + 4 + k + 12) * itemsize, (6 + 2 * k) * n + 2 * k * k
    # x, h̄, h, v, w in; x', h̄', h', v' out; ~7 flops an element
    return (9 * n + 16) * itemsize, 7 * n


def phase_step_kernels(torch, cf, peaks):
    """The step arms of K1 (``fused_cg_step``) and K7 (``lsmr_step``)
    against their plain versions in f64 and f32, live, frozen, breakdown
    and (K7) exact-termination states: K1 at n = 36 551, 16 384 and a
    ragged n with k = 8, K7 at K7_NS.  Then each step arm timed beside its
    TPU-function arm, the previous two-launch design's time, its plain
    version and its bound, and profiled (device kernels per call)."""
    report = {"fused_cg_update": {}, "lsmr_update": {}}
    for dtype in (torch.float64, torch.float32):
        dname = str(dtype).split(".")[-1]
        for n in sorted(set((PAPER_N, CUT_N, RAGGED_N) + K7_NS)):
            for case in ("live", "frozen", "breakdown", "exact"):
                cg_args, lsmr_args = step_states(torch, n, dtype, n + len(case), case)
                if case != "exact" and n in (PAPER_N, CUT_N, RAGGED_N):
                    e = check_cg_step(torch, cf, cg_args, dname, f"fused_cg_step {dname} n={n} {case}")
                    report["fused_cg_update"][f"err {dname} n={n} {case}"] = e
                if n in K7_NS:
                    e = check_lsmr_step(torch, cf, lsmr_args, dname, f"lsmr_step {dname} n={n} {case}")
                    report["lsmr_update"][f"err {dname} n={n} {case}"] = e
        log(f"[kernels] step arms {dname}: K1 and K7 scalars bit for bit with their plain "
            f"versions, vectors within {TOL[dname]}, repeats bit for bit")
        for case in STALL_CASES:
            cg_args, lsmr_args = step_states(torch, PAPER_N, dtype, 5 + len(case),
                                             "frozen" if case == "frozen" else "live")
            lsmr_n = step_states(torch, LSQ_MAIN["n"], dtype, 5 + len(case),
                                 "frozen" if case == "frozen" else "live")[1]
            check_armed_steps(torch, cf, cg_args, lsmr_n, case,
                              f"armed step arms {dname} {case}")
        log(f"[kernels] armed step arms {dname} (window {STALL_WINDOW}, K1 n={PAPER_N}, K7 "
            f"n={LSQ_MAIN['n']}; {', '.join(STALL_CASES)}): window-0 outputs unchanged, the "
            f"detector bit for bit, STAGNATED latched on the same step")

    timings = {}
    for name, n, dname in (("fused_cg_update", PAPER_N, "float64"),
                           ("lsmr_update", LSQ_MAIN["n"], "float64"),
                           ("lsmr_update", GN["d"] * GN["out"], "float64"),
                           ("lsmr_update", 1 << 20, "float64"),
                           ("lsmr_update", 1 << 20, "float32")):
        dtype = getattr(torch, dname)
        cg_args, lsmr_args = step_states(torch, n, dtype, 7, "live")
        armed_cg, best, armed_ls = armed_step_args(torch, cf, cg_args, lsmr_args, "stall")
        if name == "fused_cg_update":
            # ap is zeroed in place only on a breakdown: a live state reuses it.
            kern = lambda: cf.fused_cg_step_cuda(*cg_args)  # noqa: E731
            armed = lambda: cf.fused_cg_step_cuda(  # noqa: E731
                *armed_cg, window=STALL_WINDOW, best=best)
            plain = lambda: cf.fused_cg_step_plain(*cg_args)  # noqa: E731
            x, r, p, ap = cg_args[:4]
            alpha = torch.tensor(0.3, dtype=dtype, device="cuda")
            tpu = lambda: cf.fused_cg_update_cuda(x, r, p, ap, alpha, cg_args[12])  # noqa: E731
            previous = PREVIOUS_MS.get(f"fused_cg_update {dname} n={n}")
        else:
            kern = lambda: cf.lsmr_step_cuda(*lsmr_args)  # noqa: E731
            armed = lambda: cf.lsmr_step_cuda(*armed_ls, window=STALL_WINDOW)  # noqa: E731
            plain = lambda: cf.lsmr_step_plain(*lsmr_args)  # noqa: E731
            x, hbar, h, v = lsmr_args[:4]
            c = [torch.tensor(q, dtype=dtype, device="cuda") for q in (0.5, -0.25, 2.0)]
            tpu = lambda: cf.lsmr_update_cuda(x, hbar, h, v, *c)  # noqa: E731
            previous = PREVIOUS_MS.get(f"lsmr_update {dname} n={n}")
        itemsize = 8 if dname == "float64" else 4
        nbytes, ops = step_work(name, n, itemsize)
        t_bytes, t_ops = nbytes / peaks["bytes"], ops / peaks[dname]
        tpu_bytes, tpu_ops = work(name, n, itemsize)
        t = {"n": n, "dtype": dname, "ms": device_ms(torch, kern), "plain_ms": device_ms(torch, plain),
             "tpu_arm_ms": device_ms(torch, tpu), "previous_design_ms": previous,
             "bound_ms": 1e3 * max(t_bytes, t_ops),
             "bound_by": "bytes" if t_bytes >= t_ops else "operations",
             "tpu_arm_bound_ms": 1e3 * max(tpu_bytes / peaks["bytes"], tpu_ops / peaks[dname]),
             "kernels_per_call": kernels_per_call(torch, kern),
             "tpu_arm_kernels_per_call": kernels_per_call(torch, tpu),
             "armed_ms": device_ms(torch, armed),
             "armed_kernels_per_call": kernels_per_call(torch, armed)}
        timings[f"{name} {dname} n={n}"] = t
        log(f"[timing] {name} step arm {dname} n={n}: kernel {t['ms']:.4f} ms "
            f"({t['kernels_per_call']} device kernel a call), plain {t['plain_ms']:.4f} ms, bound "
            f"{t['bound_ms']:.5f} ms ({t['bound_by']}); TPU-function arm {t['tpu_arm_ms']:.4f} ms "
            f"({t['tpu_arm_kernels_per_call']} device kernel a call, bound "
            f"{t['tpu_arm_bound_ms']:.5f} ms), previous two-launch / grid-capped design "
            f"{previous} ms; armed with the stall detector {t['armed_ms']:.4f} ms "
            f"({t['armed_kernels_per_call']} device kernel a call)")
    report["timings"] = timings
    return report


def phase_lsmr_kernels(torch, cf, peaks):
    """K7 (``lsmr_update``) in f64 and f32 against its plain version at
    K7_NS, timed at each in f64 and at 2²⁰ in f32; then the extraction
    kernels (K4, K5) at the least-squares window rows, K4 and K5 timed at
    112 rows and n = 16 384, beside their bounds and the one PyTorch call
    that computes each."""
    report = {"max_abs_err": 0.0, "timings": {}}
    for dtype in (torch.float64, torch.float32):
        dname = str(dtype).split(".")[-1]
        itemsize = 8 if dtype == torch.float64 else 4
        for n in K7_NS:
            g = torch.Generator(device="cuda").manual_seed(n)
            x, hbar, h, v = (torch.randn(n, generator=g, device="cuda", dtype=dtype)
                             for _ in range(4))
            c = [torch.randn((), generator=g, device="cuda", dtype=dtype) for _ in range(3)]
            got = cf.lsmr_update_cuda(x, hbar, h, v, *c)
            want = cf.lsmr_update_plain(x, hbar, h, v, *c)
            torch.cuda.synchronize()
            err = compare(torch, got, want, dname, f"lsmr_update {dname} n={n}")
            log(f"[kernels] lsmr_update {dname} n={n:7d}: max abs err {err:.3e}")
            if dtype == torch.float64 and n == LSQ_MAIN["n"]:
                report["max_abs_err"] = err
            if n == RAGGED_N or (dtype == torch.float32 and n != 1 << 20):
                continue
            nbytes, ops = work("lsmr_update", n, itemsize)
            t_bytes, t_ops = nbytes / peaks["bytes"], ops / peaks[dname]
            t = {"ms": device_ms(torch, lambda: cf.lsmr_update_cuda(x, hbar, h, v, *c)),
                 "plain_ms": device_ms(torch, lambda: cf.lsmr_update_plain(x, hbar, h, v, *c)),
                 "bound_ms": 1e3 * max(t_bytes, t_ops),
                 "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
            report["timings"][f"{dname} n={n}"] = t
            log(f"[timing] lsmr_update {dname} n={n}: kernel {t['ms']:.4f} ms, plain "
                f"{t['plain_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms ({t['bound_by']}), "
                f"library null")
    main = report["timings"][f"float64 n={LSQ_MAIN['n']}"]
    report.update(main, library_ms=None)

    gram = {}
    for dtype in (torch.float64, torch.float32):
        dname = str(dtype).split(".")[-1]
        for rows in GRAM_ROWS:
            for n in (LSQ_MAIN["n"], RAGGED_N):
                g = torch.Generator(device="cuda").manual_seed(rows + n)
                s_ = torch.randn(rows, n, generator=g, device="cuda", dtype=dtype)
                u = torch.randn(rows // 2, K, generator=g, device="cuda", dtype=dtype)
                g_ = cf.self_gram_cuda(s_)
                e1 = compare(torch, (g_,), (cf.self_gram_plain(s_),),
                             dname, f"self_gram rows={rows} n={n}")
                if not (torch.equal(g_, g_.T) and torch.equal(g_, cf.self_gram_cuda(s_))):
                    raise AssertionError(f"self_gram {dname} rows={rows} n={n}: not exactly "
                                         "symmetric, or two launches differ")
                e2 = compare(torch, (cf.recombine_blocks_cuda(s_, u),),
                             (cf.recombine_blocks_plain(s_, u),), dname,
                             f"recombine_blocks rows={rows} n={n}")
                log(f"[kernels] self_gram / recombine_blocks {dname} rows={rows} n={n:6d}: "
                    f"max abs err {e1:.3e} / {e2:.3e}; self_gram exactly symmetric, two "
                    "launches bitwise equal")
    rows, n = 2 * (LSQ_K + LSQ_ELL), LSQ_MAIN["n"]
    g = torch.Generator(device="cuda").manual_seed(3)
    s_ = torch.randn(rows, n, generator=g, device="cuda", dtype=torch.float64)
    u = torch.randn(rows // 2, LSQ_K, generator=g, device="cuda", dtype=torch.float64)
    ut = u.T.contiguous()
    for name, kern, plain, lib, nbytes, ops in (
        ("self_gram", lambda: cf.self_gram_cuda(s_), lambda: cf.self_gram_plain(s_),
         lambda: s_ @ s_.T, (rows * n + rows * rows) * 8, rows * (rows + 1) * n),
        ("recombine_blocks", lambda: cf.recombine_blocks_cuda(s_, u),
         lambda: cf.recombine_blocks_plain(s_, u),
         lambda: torch.matmul(ut, s_.view(2, rows // 2, n)),
         (rows * n + rows // 2 * LSQ_K + 2 * LSQ_K * n) * 8, 2 * LSQ_K * rows * n),
    ):
        t_bytes, t_ops = nbytes / peaks["bytes"], ops / ops_peak(peaks, name, "float64")
        gram[name] = t = {"rows": rows, "n": n, "ms": device_ms(torch, kern),
                          "plain_ms": device_ms(torch, plain),
                          "library_ms": device_ms(torch, lib),
                          "bound_ms": 1e3 * max(t_bytes, t_ops),
                          "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
        previous = f" (previous design {PREVIOUS_MS.get(f'{name} {rows}x{n}')} ms)"
        log(f"[timing] {name} f64 rows={rows} n={n}: kernel {t['ms']:.4f} ms{previous}, plain "
            f"{t['plain_ms']:.4f} ms, library {t['library_ms']:.4f} ms, bound "
            f"{t['bound_ms']:.4f} ms ({t['bound_by']})")
    report["lsq_windows"] = gram
    return report


def drifting_lsq(torch, num, m, n, device, decay="logspace", seed=0):
    """``benchmarks/lsq_bench.py``'s drifting ridge sequence: singular
    values logspace(0, −3, n) (``decay="flat"``: |N(0, 1)| + 0.5) under
    random orthogonal factors, then A_{i+1} = A_i + drift·‖A_i‖_F/√(mn)·G.
    Yields ``(A_i, b_i)`` one system at a time.  On the CPU it is the
    bench's numpy recipe exactly (full (m, m) QR); on the card (logspace
    only) the left factor is the reduced QR of an (m, n) Gaussian, the
    same distribution without the (m, m) factor, drawn from a torch
    generator."""
    import numpy as np

    if device == "cpu":
        rng = np.random.default_rng(seed)
        U, _ = np.linalg.qr(rng.standard_normal((m, m)))
        V, _ = np.linalg.qr(rng.standard_normal((n, n)))
        s = np.logspace(0, -3, n) if decay == "logspace" else np.abs(rng.standard_normal(n)) + 0.5
        base = U[:, :n] @ np.diag(s) @ V.T
        for _ in range(num):
            b = rng.standard_normal(m)
            yield torch.from_numpy(base), torch.from_numpy(b)
            base = base + LSQ_DRIFT * np.linalg.norm(base) / np.sqrt(m * n) * \
                rng.standard_normal((m, n))
        return
    f64 = torch.float64
    g = torch.Generator(device=device).manual_seed(seed)
    U = torch.linalg.qr(torch.randn(m, n, generator=g, device=device, dtype=f64)).Q
    V = torch.linalg.qr(torch.randn(n, n, generator=g, device=device, dtype=f64)).Q
    U.mul_(torch.logspace(0, -3, n, device=device, dtype=f64))
    base = U @ V.T
    del U, V
    for _ in range(num):
        b = torch.randn(m, generator=g, device=device, dtype=f64)
        yield base, b
        step = torch.randn(m, n, generator=g, device=device, dtype=f64)
        base = step.mul_(LSQ_DRIFT * float(torch.linalg.norm(base)) / math.sqrt(m * n)).add_(base)


def lsq_runs(torch, systems, maxiter, log_prefix):
    """Cold LSMR per system and deflsmr(8, 48) over the sequence, both
    through the SolveSpec front door, each timed on the host clock ended
    by a synchronize."""
    from repro_torch.core import DenseMatrixOperator, SolveSpec, solve, solve_sequence

    sync = torch.cuda.synchronize if systems[0][0].is_cuda else (lambda: None)
    spec = dict(tol=LSQ_TOL, maxiter=maxiter, lsq_shift=LSQ_DAMP)
    cold, t0 = [], time.perf_counter()
    for A, b in systems:
        res = solve(DenseMatrixOperator(A), b, SolveSpec(method="lsmr", **spec))
        cold.append((res.x, res.info))
    sync()
    cold_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    seq = solve_sequence([A for A, _ in systems], [b for _, b in systems],
                         SolveSpec(method="deflsmr", k=LSQ_K, ell=LSQ_ELL, refresh_aw="exact",
                                   **spec),
                         make_operator=DenseMatrixOperator)
    sync()
    rec_s = time.perf_counter() - t0
    out = {
        "cold": {"iterations": [int(i.iterations) for _, i in cold],
                 "matvecs": [int(i.matvecs) for _, i in cold],
                 "converged": [bool(i.converged) for _, i in cold], "wall_s": cold_s},
        "recycled": {"iterations": [int(i) for i in seq.info.iterations],
                     "matvecs": [int(i) for i in seq.info.matvecs],
                     "converged": [bool(c) for c in seq.info.converged], "wall_s": rec_s},
    }
    for name, run in out.items():
        log(f"{log_prefix} {name:8s} iterations {run['iterations']} (sum "
            f"{sum(run['iterations'])}), matvecs {sum(run['matvecs'])}, wall {run['wall_s']:.2f} s")
    return out, [x for x, _ in cold], seq


def _close_counts(got, want, frac):
    return all(abs(a - b) <= max(1, math.ceil(frac * b)) for a, b in zip(got, want))


def phase_check_lsq(torch, cf):
    """lsq_bench's own problem (m = 180, n = 120, 12 systems, logspace and
    flat) on the card against the CPU (plain versions), and six
    ``hf_step``s in each mode (tests/test_optim.py's size) likewise."""
    import numpy as np

    out = {}
    cfg = LSQ_BENCH
    for decay in ("logspace", "flat"):
        cpu = list(drifting_lsq(torch, cfg["num"], cfg["m"], cfg["n"], "cpu", decay))
        card = [(A.cuda(), b.cuda()) for A, b in cpu]
        res = {}
        for dev, systems in (("cuda", card), ("cpu", cpu)):
            res[dev] = lsq_runs(torch, systems, cfg["maxiter"], f"[check-lsq {decay} {dev}]")
        (rc, xc, sc), (rh, xh, sh) = res["cuda"], res["cpu"]
        # Cold solves stop within one iteration (or 5 %) of the CPU's; the
        # recycled ones within 10 %: past ~10 iterations each device's
        # rounding grows through the recurrence (ROADMAP P5).
        for name, frac in (("cold", 0.05), ("recycled", 0.10)):
            if not all(rc[name]["converged"]):
                raise AssertionError(f"[check-lsq] {decay} {name}: a card solve did not converge")
            if not _close_counts(rc[name]["iterations"], rh[name]["iterations"], frac):
                raise AssertionError(f"[check-lsq] {decay} {name}: iterations "
                                     f"{rc[name]['iterations']} vs CPU {rh[name]['iterations']}")
        xs = [(a, b) for a, b in zip(xc, xh)] + [(a, b) for a, b in zip(sc.x, sh.x)]
        worst = max(float(torch.linalg.norm(a.cpu() - b) / torch.linalg.norm(b)) for a, b in xs)
        log(f"[check-lsq] {decay}: worst x gap card vs CPU {worst:.2e} (relative)")
        if worst > 1e-6:
            raise AssertionError(f"[check-lsq] {decay}: x gap {worst:.2e} > 1e-6")
        if decay == "logspace" and not sum(rc["recycled"]["matvecs"]) < sum(rc["cold"]["matvecs"]):
            raise AssertionError("[check-lsq] recycling did not save products on the card")
        out[decay] = {"cuda": rc, "cpu": rh, "worst_x_gap": worst}

    # hf_step at tests/test_optim.py's size in both modes, card against CPU:
    # Gauss-Newton ((def)LSMR on the Jacobian: K7, K4, K5) and GGN (def-CG
    # on the damped GGN through torch.func: K1, K2, K4, K5).
    from repro_torch import convert
    from repro_torch.optim import HFConfig, hf_init, hf_step, squared_loss_hvp

    rng = np.random.default_rng(0)
    xs, wt = rng.standard_normal((64, 8)), rng.standard_normal((8, 3))
    w0 = rng.standard_normal((8, 3)) * 0.1

    def model_fn(p, bt):
        return torch.tanh(bt["x"] @ p["w"])

    def loss_fn(outputs, bt):
        return torch.mean(torch.square(outputs - bt["y"]))

    def residual_fn(p, bt):
        return model_fn(p, bt) - bt["y"]

    for solver in ("gauss_newton", "ggn"):
        hcfg = HFConfig(k=4, ell=8, cg_tol=1e-10, cg_maxiter=200, init_damping=0.1,
                        solver=solver)
        fns = (dict(residual_fn=residual_fn) if solver == "gauss_newton" else
               dict(model_fn=model_fn, loss_fn=loss_fn, loss_hvp=squared_loss_hvp))
        # One bootstrap basis for both devices, carried across by convert.
        boot = convert.hf_state_to_numpy(
            hf_init({"w": torch.tensor(w0)}, hcfg, torch.Generator().manual_seed(0)))
        gn = {}
        for dev in ("cuda", "cpu"):
            batch = {"x": torch.tensor(xs, device=dev),
                     "y": torch.tanh(torch.tensor(xs @ wt, device=dev))}
            params = {"w": torch.tensor(w0, device=dev)}
            state = convert.hf_state_from_numpy(**boot, dtype=torch.float64, device=dev)
            losses, its = [], []
            for _ in range(6):
                params, state, m = hf_step(params, state, batch, cfg=hcfg, **fns)
                losses.append(float(m["loss"]))
                its.append(int(m["cg_iterations"]))
            gn[dev] = {"loss": losses, "iterations": its}
        tag = f"[check-gn {solver}]"
        log(f"{tag} card loss {gn['cuda']['loss']} iterations {gn['cuda']['iterations']}; "
            f"CPU iterations {gn['cpu']['iterations']}")
        for a, b in zip(gn["cuda"]["loss"], gn["cpu"]["loss"]):
            if abs(a - b) > 1e-10 * abs(b):
                raise AssertionError(f"{tag} loss {gn['cuda']['loss']} vs CPU {gn['cpu']['loss']}")
        if gn["cuda"]["iterations"] != gn["cpu"]["iterations"]:
            raise AssertionError(f"{tag} iterations {gn['cuda']['iterations']} vs CPU "
                                 f"{gn['cpu']['iterations']}")
        out["gn" if solver == "gauss_newton" else "ggn"] = gn
    return out


def profile_lsmr_steps(torch, A, b, W=None, NW=None, steps=16):
    """``torch.profiler`` over ``steps`` LSMR iterations (tol 0, so every
    step is live): device kernels launched per iteration, and device time
    per iteration split into the two GEMVs and everything else.  ``A`` is a
    matrix, or a batched operator for ``(B, m)`` right-hand sides (B lanes
    an iteration)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import DenseMatrixOperator, lsmr

    op = DenseMatrixOperator(A) if isinstance(A, torch.Tensor) else A
    # A one-system call passes no lanes= (tools/step_times.py runs this
    # against trees whose lsmr has none).
    lanes = {"lanes": True} if b.ndim == 2 else {}
    lsmr(op, b, W=W, NW=NW, damp=LSQ_DAMP, tol=0.0, maxiter=steps, **lanes)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        lsmr(op, b, W=W, NW=NW, damp=LSQ_DAMP, tol=0.0, maxiter=steps, **lanes)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches, gemv_us, other_us, names = 0, 0.0, 0.0, {}
    for evt in prof.key_averages():
        us = _device_us(evt)
        if not (_is_device(evt) and us > 0):
            continue
        launches += evt.count
        key = evt.key.lower()
        if any(part in key for part in ("gemv", "gemm", "row_sq_norms", "rbf_tiles",
                                        "sum_parts")):
            gemv_us += us
        else:
            other_us += us
        names[evt.key[:50]] = evt.count
    return {"steps": steps, "launches_per_iteration": launches / steps,
            "gemv_ms_per_iteration": gemv_us / steps / 1e3,
            "other_ms_per_iteration": other_us / steps / 1e3,
            "wall_ms_per_iteration_profiled": 1e3 * wall / steps, "kernels": names}


def profile_defcg_steps(torch, k_dense, steps=16, precond=False, x=None):
    """``torch.profiler`` over ``steps`` deflated def-CG iterations (k = 8,
    tol 0, so every step is live) on the dense main path's Newton system
    ``I + H½ K H½`` at H½ = ½·I, with a random orthonormal basis W and its
    products AW; ``precond`` adds the Jacobi preconditioner ``diag(A)``;
    ``x`` (the data, ``k_dense`` None) runs the matrix-free operator over
    K3 instead, its gate in every step: device kernels launched per
    iteration, and device time per iteration split into the product (the
    dense GEMV, or K3's three kernels) and everything else."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import KernelSystemOperator, RBFKernelSystemOperator, defcg, jacobi

    dtype = torch.float64 if k_dense is None else k_dense.dtype
    n = x.shape[0] if k_dense is None else k_dense.shape[0]
    g = torch.Generator(device="cuda").manual_seed(5)
    half = torch.full((n,), 0.5, dtype=dtype, device="cuda")
    if k_dense is None:
        op = RBFKernelSystemOperator(x, half, THETA, LENGTHSCALE, block=BLOCK)
    else:
        op = KernelSystemOperator(lambda v: k_dense @ v, half)
    M = jacobi(1.0 + half * half * torch.diagonal(k_dense)) if precond else None
    b = torch.randn(n, generator=g, device="cuda", dtype=dtype)
    W = torch.linalg.qr(torch.randn(n, K, generator=g, device="cuda",
                                    dtype=dtype)).Q.T.contiguous()
    AW = op.basis_matvec(W)
    defcg(op, b, W=W, AW=AW, tol=0.0, maxiter=steps, M=M)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = defcg(op, b, W=W, AW=AW, tol=0.0, maxiter=steps, M=M)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    if int(res.info.iterations) != steps:
        raise AssertionError(f"[profile def-CG] ran {int(res.info.iterations)} of {steps} steps")
    launches, gemv_us, other_us, names = 0, 0.0, 0.0, {}
    for evt in prof.key_averages():
        us = _device_us(evt)
        if not (_is_device(evt) and us > 0):
            continue
        launches += evt.count
        key = evt.key.lower()
        if any(part in key for part in ("gemv", "gemm", "row_sq_norms", "rbf_tiles",
                                        "sum_parts")):
            gemv_us += us
        else:
            other_us += us
        names[evt.key[:50]] = evt.count
    return {"n": n, "k": K, "steps": steps, "preconditioner": "jacobi" if precond else None,
            "operator": "dense" if k_dense is not None else "matrix-free",
            "launches_per_iteration": launches / steps,
            "gemv_ms_per_iteration": gemv_us / steps / 1e3,
            "other_ms_per_iteration": other_us / steps / 1e3,
            "wall_ms_per_iteration_profiled": 1e3 * wall / steps, "kernels": names}


def profile_pdefcg_steps(torch, k_dense, steps=16):
    """:func:`profile_defcg_steps` with the Jacobi preconditioner: the
    preconditioned deflated def-CG iteration, which ends in K6's and K2's
    step arms."""
    return profile_defcg_steps(torch, k_dense, steps, precond=True)


def phase_main_lsq(torch, cf, peaks):
    """The least-squares main path at m = 24 576, n = 16 384 (f64, 3.2 GB a
    system): cold LSMR per system and deflsmr(8, 48) over the drifting
    sequence, through the front door.  Every system must converge, the
    last x must match a Cholesky solve of AᵀA + λI, and K7, K4 and K5 must
    launch while no plain version runs.  The caller zeroes the counters."""
    m, n = LSQ_MAIN["m"], LSQ_MAIN["n"]
    from repro_torch.core import engine

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    systems = list(drifting_lsq(torch, LSQ_MAIN["num"], m, n, "cuda"))
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    A0, b0 = systems[0]
    gemv_ms = device_ms(torch, lambda: A0 @ b0[:n])
    gemv_t_ms = device_ms(torch, lambda: A0.T @ b0)
    bound_ms = 2 * m * n * 8 / peaks["bytes"] * 1e3
    log(f"[main-lsq] m={m} n={n}: {len(systems)} systems built on the card in {build_s:.1f} s; "
        f"GEMV A v {gemv_ms:.4f} ms, Aᵀ u {gemv_t_ms:.4f} ms (bound of the pair "
        f"{bound_ms:.4f} ms)")

    runs, xs_cold, seq = lsq_runs(torch, systems, LSQ_MAIN["maxiter"], "[main-lsq]")
    for name, run in runs.items():
        if not all(run["converged"]):
            raise AssertionError(f"[main-lsq] {name}: a system did not converge")
        ell = 0 if name == "cold" else LSQ_ELL
        frozen = sum(frozen_steps(i, ell, engine.CHUNK) for i in run["iterations"])
        its = sum(run["iterations"])
        run.update(frozen_products=2 * frozen,
                   ms_per_iteration=1e3 * run["wall_s"] / its,
                   ms_per_step_run=1e3 * run["wall_s"] / (its + frozen))
        log(f"[main-lsq] {name:8s} {its} iterations, {sum(run['matvecs'])} A/Aᵀ products "
            f"counted, {2 * frozen} frozen products (computed, discarded), "
            f"{run['ms_per_iteration']:.3f} ms per iteration "
            f"({run['ms_per_step_run']:.3f} ms per step run; GEMV pair bound {bound_ms:.3f} ms)")
    A, b = systems[-1]
    N = A.T @ A
    N.diagonal().add_(LSQ_DAMP)
    x_ref = torch.cholesky_solve((A.T @ b)[:, None], torch.linalg.cholesky(N))[:, 0]
    del N
    gaps = {name: float(torch.linalg.norm(x - x_ref) / torch.linalg.norm(x_ref))
            for name, x in (("cold", xs_cold[-1]), ("recycled", seq.x[-1]))}
    log(f"[main-lsq] last system against Cholesky of AᵀA + λI: relative gap {gaps}")
    if max(gaps.values()) > 1e-5:
        raise AssertionError(f"[main-lsq] last x off the ridge solution: {gaps}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    saved = 1 - sum(runs["recycled"]["matvecs"]) / sum(runs["cold"]["matvecs"])
    log(f"[main-lsq] recycled vs cold A/Aᵀ products: {saved:+.1%} saved; peak memory "
        f"{peak_gb:.1f} GB")
    report = {"m": m, "n": n, "num": len(systems), "runs": runs,
              "gemv_ms": gemv_ms, "gemv_t_ms": gemv_t_ms, "gemv_pair_bound_ms": bound_ms,
              "cholesky_gap": gaps, "products_saved": saved, "peak_memory_gb": peak_gb,
              "build_systems_s": build_s}
    return report, systems, seq.state


def phase_main_gn(torch):
    """Gauss-Newton training (``hf_step`` with ``solver="gauss_newton"``) on
    the teacher-student residual at 65 536 samples, d = 1024, 32 outputs
    (32 768 parameters), f64, 10 steps with recycling and 10 without.  The
    loss must fall and stay finite.  The caller zeroes the counters."""
    from repro_torch.optim import HFConfig, hf_init, hf_step

    f64 = torch.float64
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(GN["samples"], GN["d"], generator=g, device="cuda", dtype=f64)
    x.mul_(math.sqrt(8.0 / GN["d"]))  # pre-activations at the test's scale
    y = torch.tanh(x @ torch.randn(GN["d"], GN["out"], generator=g, device="cuda", dtype=f64))
    w0 = torch.randn(GN["d"], GN["out"], generator=g, device="cuda", dtype=f64) * 0.1
    batch = {"x": x, "y": y}

    def residual_fn(p, bt):
        return torch.tanh(bt["x"] @ p["w"]) - bt["y"]

    out = {}
    for recycle in (True, False):
        cfg = HFConfig(k=4, ell=8, cg_tol=1e-6, cg_maxiter=200, init_damping=0.1,
                       solver="gauss_newton", recycle=recycle)
        params = {"w": w0.clone()}
        state = hf_init(params, cfg, torch.Generator(device="cuda").manual_seed(1))
        rows = []
        for _ in range(GN["steps"]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, state, mt = hf_step(params, state, batch, residual_fn=residual_fn, cfg=cfg)
            torch.cuda.synchronize()
            rows.append({"loss": float(mt["loss"]), "new_loss": float(mt["new_loss"]),
                         "damping": float(mt["damping"]), "accepted": bool(mt["accepted"]),
                         "iterations": int(mt["cg_iterations"]),
                         "matvecs": int(mt["cg_matvecs"]), "wall_s": time.perf_counter() - t0})
        name = "recycled" if recycle else "cold"
        its = sum(r["iterations"] for r in rows)
        wall = sum(r["wall_s"] for r in rows)
        out[name] = {"steps": rows, "iterations": its, "wall_s": wall,
                     "ms_per_iteration": 1e3 * wall / max(its, 1)}
        log(f"[main-gn] {name:8s} loss {rows[0]['loss']:.4e} -> {rows[-1]['new_loss']:.4e}; "
            f"LSMR iterations per step {[r['iterations'] for r in rows]}; "
            f"{wall:.2f} s, {out[name]['ms_per_iteration']:.3f} ms per LSMR iteration "
            f"(step included)")
        losses = [r["loss"] for r in rows] + [rows[-1]["new_loss"]]
        if not all(math.isfinite(v) for v in losses) or not losses[-1] < losses[0]:
            raise AssertionError(f"[main-gn] {name}: loss did not fall: {losses}")
        out[name]["final_state"] = (params, state, cfg)
    return out, batch, residual_fn


def profile_gn_step(torch, params, state, batch, residual_fn, cfg):
    """``torch.profiler`` over one Gauss-Newton step: device kernels
    launched, device time by kernel class, and the wall time."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.optim import hf_step

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, _, m = hf_step(params, state, batch, residual_fn=residual_fn, cfg=cfg)
        its = int(m["cg_iterations"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches, gemm_us, other_us = 0, 0.0, 0.0
    for evt in prof.key_averages():
        us = _device_us(evt)
        if not (_is_device(evt) and us > 0):
            continue
        launches += evt.count
        if "gemm" in evt.key.lower() or "gemv" in evt.key.lower():
            gemm_us += us
        else:
            other_us += us
    busy = (gemm_us + other_us) / 1e3
    return {"iterations": its, "launches": launches, "gemm_ms": gemm_us / 1e3,
            "other_ms": other_us / 1e3, "wall_ms_profiled": 1e3 * wall,
            "device_busy_share": busy / (1e3 * wall)}


def _sync(torch, device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _timed(torch, device, fn):
    """``(fn(), seconds)`` on the host clock, the device synchronized
    before and after."""
    _sync(torch, device)
    t0 = time.perf_counter()
    res = fn()
    _sync(torch, device)
    return res, time.perf_counter() - t0


def _zero_counts():
    from repro_torch.kernels import _runtime

    for key in _runtime.LAUNCHES:
        _runtime.LAUNCHES[key] = _runtime.PLAIN_ON_CUDA[key] = 0
    _runtime.ARMS.clear()


def _arms():
    """The launches per arm since the counts were zeroed."""
    from repro_torch.kernels import _runtime

    return dict(_runtime.ARMS)


def _every_rank(value):
    """``value`` from every rank, in rank order (not a counted collective)."""
    import torch.distributed as dist

    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, value)
    return out


def dense_spd(n, cond, seed):
    """``tests/conftest.py:make_spd`` (log-spaced spectrum, random basis)
    and the next draw as b, from ``numpy.random.default_rng(seed)``."""
    import numpy as np

    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    return (q * np.logspace(0, np.log10(cond), n)) @ q.T, rng.standard_normal(n)


def shard_check_rank(dense, rbf_in, lsq, device="cuda"):
    """check-shard on one rank: each small system sharded over the group
    and unsharded on this rank's device; the sharded solves' launches and
    plain versions on the card per rank; the collective contract."""
    import torch

    from repro_torch.core import (DenseMatrixOperator, RBFKernelSystemOperator, RecycleState,
                                  SolveSpec, solve)
    from repro_torch.kernels import _runtime
    from repro_torch.launch import COLLECTIVES, make_solve_mesh

    mesh = make_solve_mesh(device=device)
    dev = mesh.device

    def t(a):
        return torch.as_tensor(a, dtype=torch.float64, device=dev)

    _zero_counts()
    sharded_launches = dict.fromkeys(_runtime.LAUNCHES, 0)
    sharded_plain = dict.fromkeys(_runtime.LAUNCHES, 0)

    def sharded(*args, **kw):
        before = (dict(_runtime.LAUNCHES), dict(_runtime.PLAIN_ON_CUDA))
        res = solve(*args, mesh=mesh, **kw)
        for key in sharded_launches:
            sharded_launches[key] += _runtime.LAUNCHES[key] - before[0][key]
            sharded_plain[key] += _runtime.PLAIN_ON_CUDA[key] - before[1][key]
        return res

    def pair(name, A, b, spec, state=None):
        got, want = sharded(A, b, spec, state), solve(A, b, spec, state)
        row = {"x_gap": float((got.x - want.x).abs().max()),
               "x_norm": float(torch.linalg.norm(want.x)),
               "iterations": (int(got.info.iterations), int(want.info.iterations)),
               "matvecs": (int(got.info.matvecs), int(want.info.matvecs)),
               "status": (int(got.info.status), int(want.info.status)),
               "converged": bool(got.info.converged) and bool(want.info.converged),
               "rank_iterations": _every_rank(int(got.info.iterations))}
        if spec.method == "defcg":
            W = mesh.gather_state(got.state)
            signs = torch.sign(torch.sum(W.W * want.state.W, dim=1))[:, None]
            row["basis_gap"] = max(float((W.W * signs - want.state.W).abs().max()),
                                   float((W.AW * signs - want.state.AW).abs().max()),
                                   float((W.theta - want.state.theta).abs().max()))
        out[name] = row

    out = {}
    A, b = DenseMatrixOperator(t(dense[0])), t(dense[1])
    cold = RecycleState.zeros(4, b.shape[0], dtype=torch.float64, device=dev)
    for method in ("cg", "defcg", "lsmr"):
        pair(f"dense-{method}", A, b, SolveSpec(method=method, k=4, ell=6, tol=1e-12,
                                                 maxiter=300), cold)
    A_rbf = RBFKernelSystemOperator(t(rbf_in[0]), t(rbf_in[1]), theta=1.3, lengthscale=1.1,
                                    block=64)
    b_rbf = t(rbf_in[2])
    pair("rbf-defcg", A_rbf, b_rbf, SolveSpec(method="defcg", k=4, ell=6, tol=1e-9,
                                              maxiter=400),
         RecycleState.zeros(4, b_rbf.shape[0], dtype=torch.float64, device=dev))
    pair("lsq-lsmr", DenseMatrixOperator(t(lsq[0])), t(lsq[1]),
         SolveSpec(method="lsmr", tol=LSQ_TOL, maxiter=LSQ_BENCH["maxiter"], lsq_shift=LSQ_DAMP))

    # The contract by difference: tol 0, N and N + 8 live iterations.
    contract = {}
    for method in ("cg", "defcg", "lsmr"):
        counts = []
        for maxiter in (8, 16):
            before = dict(COLLECTIVES)
            res = sharded(A, b, SolveSpec(method=method, k=4, ell=6, tol=0.0, maxiter=maxiter),
                          cold)
            counts.append((int(res.info.iterations),
                           {k: COLLECTIVES[k] - before[k] for k in before}))
        contract[method] = counts
    out["contract"] = contract
    out["launches"] = _every_rank(sharded_launches)
    out["plain_on_cuda"] = _every_rank(sharded_plain)
    out["mesh"] = {"size": mesh.size, "backend": mesh.backend, "device": str(dev)}
    return out


def check_shard_inputs(torch):
    """check-shard's systems as numpy, and the x bar of its LSMR case."""
    import numpy as np

    dense = dense_spd(64, 50.0, 0)
    rng = np.random.default_rng(1)
    rbf_in = (rng.standard_normal((256, 3)), 0.5 + rng.random(256), rng.standard_normal(256))
    A, b = next(drifting_lsq(torch, 1, LSQ_BENCH["m"], LSQ_BENCH["n"], "cpu", "flat"))
    lsq = (A.numpy(), b.numpy())
    lam_min = float(np.linalg.svd(lsq[0], compute_uv=False).min()) ** 2 + LSQ_DAMP
    lsq_bound = 2 * LSQ_TOL * float(np.linalg.norm(lsq[0].T @ lsq[1])) / lam_min
    return (dense, rbf_in, lsq), lsq_bound


def judge_check_shard(torch, tag, out, lsq_bound, device):
    """check-shard's bars, as the CPU tests hold them: x to 1e-10,
    cg/def-CG iterations within 1 and matvecs within 2, LSMR within 5 and
    10, statuses equal, def-CG bases sign-aligned to 1e-10, every rank the
    same count; lsq's x to twice LSMR's stopping bound
    tol·‖Aᵀb‖/λ_min(AᵀA + λI) (ROADMAP P6).  The collective contract: tol
    0, N and N + 8 iterations differ by exactly 8 all-reduces and
    all-gathers (cg, def-CG), 16 of each (LSMR).  On the card every rank
    launched K8 and neither K3 nor a plain version."""
    for name, row in out.items():
        if not isinstance(row, dict) or "x_gap" not in row:
            continue
        slack = 5 if name.endswith("lsmr") else 1
        mv_slack = 1 if name.startswith("rbf") else 2 * slack
        (its_s, its_u), (mv_s, mv_u) = row["iterations"], row["matvecs"]
        x_bar = lsq_bound if name == "lsq-lsmr" else 1e-10
        log(f"{tag} {name:11s} x gap {row['x_gap']:.2e} (bar {x_bar:.1e}); iterations "
            f"{its_s} vs {its_u}; matvecs {mv_s} vs {mv_u}; per rank {row['rank_iterations']}"
            + (f"; basis gap {row['basis_gap']:.2e}" if "basis_gap" in row else ""))
        bad = (row["x_gap"] > x_bar or abs(its_s - its_u) > slack
               or abs(mv_s - mv_u) > mv_slack or row["status"][0] != row["status"][1]
               or not row["converged"] or len(set(row["rank_iterations"])) != 1
               or row.get("basis_gap", 0.0) > 1e-10)
        if bad:
            raise AssertionError(f"{tag} {name}: sharded vs unsharded {row}")
    for method, ((its_a, ca), (its_b, cb)) in out["contract"].items():
        per = 2 if method == "lsmr" else 1
        diff = {k: cb[k] - ca[k] for k in ca}
        log(f"{tag} contract {method}: {its_a} → {its_b} iterations add {diff}")
        if (its_a, its_b) != (8, 16) or diff != {"all_reduce": 8 * per, "all_gather": 8 * per}:
            raise AssertionError(f"{tag} collective contract broken for {method}: {diff}")
    for rank, (launched, plain) in enumerate(zip(out["launches"], out["plain_on_cuda"])):
        if torch.device(device).type == "cuda" and (
                any(plain.values()) or not launched["rbf_matvec_rect"] or launched["rbf_matvec"]):
            raise AssertionError(f"{tag} rank {rank}: launches {launched}, plain {plain}")
    log(f"{tag} rank 0 sharded launches {out['launches'][0]}")
    return out


def shard_world_rank(check_args, main_args=None):
    """One rank of a shard world: check-shard's cases, then, when given,
    main-shard's replay (one spawn for both: starting ranks on the card
    takes tens of seconds)."""
    out = {"check": shard_check_rank(*check_args)}
    if main_args is not None:
        out["main"] = shard_main_rank(*main_args)
    return out


def shard_main_rank(x_path, systems, device="cuda"):
    """main-shard on one rank: replay the recorded Newton systems through
    ``solve(..., mesh=)``, carrying the RecycleState; counts zeroed just
    before and read just after.  Then, apart from the counts: one K8 call
    per rank at once (the card shared by the ranks), and the host time of
    a collective on CUDA tensors (which gloo stages through host memory
    itself) and on host tensors: the difference is the staging."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.core import RBFKernelSystemOperator, SolveSpec, solve
    from repro_torch.kernels import _runtime, ops as kops
    from repro_torch.launch import COLLECTIVES, make_solve_mesh

    mesh = make_solve_mesh(device=device)
    dev = mesh.device
    x = torch.from_numpy(np.load(x_path)).to(dev)
    spec = SolveSpec(k=K, ell=ELL, tol=SHARD_TOL)

    def t(a):
        return None if a is None else torch.from_numpy(a).to(dev)

    state, rows = None, []
    _sync(torch, dev)
    _zero_counts()
    before = dict(COLLECTIVES)
    for sysm in systems:
        op = RBFKernelSystemOperator(x, t(sysm["sqrt_h"]), THETA, LENGTHSCALE, block=BLOCK)
        _sync(torch, dev)
        t0 = time.perf_counter()
        res = solve(op, t(sysm["b"]), spec, state, x0=t(sysm["x0"]), mesh=mesh)
        _sync(torch, dev)
        state = res.state
        rows.append({"iterations": int(res.info.iterations), "matvecs": int(res.info.matvecs),
                     "converged": bool(res.info.converged),
                     "wall_s": time.perf_counter() - t0,
                     "x": res.x.cpu().numpy() if mesh.rank == 0 else None})
    launches, plain = dict(_runtime.LAUNCHES), dict(_runtime.PLAIN_ON_CUDA)
    collectives = {k: COLLECTIVES[k] - before[k] for k in before}

    def host_ms(fn, reps):
        dist.barrier()
        _sync(torch, dev)
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        _sync(torch, dev)
        return 1e3 * (time.perf_counter() - t0) / reps

    n_loc = x.shape[0] // mesh.size
    x_loc = x[mesh.block(x.shape[0])]
    packed = torch.zeros(2 * K + 4, dtype=torch.float64, device=dev)  # def-CG's merged psum
    vec = torch.zeros(n_loc, dtype=torch.float64, device=dev)
    packed_h, vec_h = packed.cpu(), vec.cpu()  # gloo takes these as they are
    staging = {
        "all_reduce_ms": host_ms(lambda: mesh.all_reduce(packed), 50),
        "all_reduce_host_ms": host_ms(lambda: mesh.all_reduce(packed_h), 50),
        "all_gather_ms": host_ms(lambda: mesh.all_gather(vec), 50),
        "all_gather_host_ms": host_ms(lambda: mesh.all_gather(vec_h), 50),
        "x_gather_ms": host_ms(lambda: mesh.all_gather(x_loc), 3),
    }
    k8_ms = None
    if dev.type == "cuda":  # every rank launches one K8 call at once
        u = torch.randn(x.shape[0], dtype=torch.float64, device=dev)
        kops.rbf_matvec_rect(x_loc, x, u, THETA, LENGTHSCALE)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        dist.barrier()
        torch.cuda.synchronize(dev)
        start.record()
        kops.rbf_matvec_rect(x_loc, x, u, THETA, LENGTHSCALE)
        end.record()
        torch.cuda.synchronize(dev)
        k8_ms = start.elapsed_time(end)
    return {"rows": rows, "launches": _every_rank(launches), "plain_on_cuda": _every_rank(plain),
            "rank_iterations": _every_rank([r["iterations"] for r in rows]),
            "collectives": collectives, "staging": _every_rank(staging),
            "k8_shared_ms": _every_rank(k8_ms), "backend": mesh.backend, "size": mesh.size}


def shard_control(torch, device, n):
    """main-shard's control: the unsharded matrix-free def-CG(8, 12) Newton
    loop of ``laplace_gpc`` through the front door at tol 1e-5 (K3
    products) on the digits data, each Newton system's H½, b and warm
    start recorded.  Returns the data and the systems as numpy."""
    from repro_torch.core import RBFKernelSystemOperator, SolveSpec, solve
    from repro_torch.data import make_infinite_digits
    from repro_torch.gp import RBFKernel
    from repro_torch.gp.laplace import logistic_quantities

    xs_np, ys_np = make_infinite_digits(n, seed=0, noise=0.10)
    x = torch.as_tensor(xs_np, dtype=torch.float64, device=device)
    y = torch.as_tensor(ys_np, dtype=torch.float64, device=device)
    k_mv = RBFKernel(theta=THETA, lengthscale=LENGTHSCALE).matvec_fn(x, block=BLOCK)
    spec = SolveSpec(k=K, ell=ELL, tol=SHARD_TOL)
    f = torch.zeros(n, dtype=torch.float64, device=device)
    state, x_prev, psi_prev, control = None, None, float("-inf"), []
    for _ in range(30):
        _, grad, hdiag = logistic_quantities(f, y)
        sqrt_h = torch.sqrt(hdiag)
        bg = hdiag * f + grad
        b = sqrt_h * k_mv(bg)
        op = RBFKernelSystemOperator(x, sqrt_h, THETA, LENGTHSCALE, block=BLOCK)
        _sync(torch, device)
        t0 = time.perf_counter()
        res = solve(op, b, spec, state, x0=x_prev)
        _sync(torch, device)
        control.append({"sqrt_h": sqrt_h.cpu().numpy(), "b": b.cpu().numpy(),
                        "x0": None if x_prev is None else x_prev.cpu().numpy(),
                        "x": res.x.cpu().numpy(), "iterations": int(res.info.iterations),
                        "matvecs": int(res.info.matvecs), "wall_s": time.perf_counter() - t0})
        state, x_prev = res.state, res.x
        a_vec = bg - sqrt_h * res.x
        f = k_mv(a_vec)
        logp_new, _, _ = logistic_quantities(f, y)
        psi = float(logp_new - 0.5 * torch.dot(a_vec, f))
        if abs(psi - psi_prev) < 1.0:
            break
        psi_prev = psi
    log(f"[main-shard] control n={n}: {len(control)} Newton systems, def-CG iterations "
        f"{[c['iterations'] for c in control]}, solve {sum(c['wall_s'] for c in control):.2f} s")
    return xs_np, control


def judge_main_shard(torch, out, control, device, n, ranks):
    """main-shard's bars: each system's sharded iterations within 1 of the
    control's, ‖x_shard − x_ref‖ ≤ 2·tol·‖b‖ + 1e-10·‖b‖ (both solves stop
    at ‖r‖ ≤ tol·‖b‖ and λ_min(I + H½KH½) ≥ 1), later systems fewer
    iterations than the cold first, every rank the same counts, and on
    every rank K8 launched while K3 and the plain versions did not."""
    import numpy as np

    from repro_torch.core import engine

    rows = out["rows"]
    for i, (row, c) in enumerate(zip(rows, control)):
        b_norm = float(np.linalg.norm(c["b"]))
        gap = float(np.linalg.norm(row["x"] - c["x"]))
        row.update(control_iterations=c["iterations"], control_matvecs=c["matvecs"],
                   control_wall_s=c["wall_s"], x_gap=gap, x_bar=(2 * SHARD_TOL + 1e-10) * b_norm)
        del row["x"]
        log(f"[main-shard] system {i + 1}: sharded {row['iterations']} iterations, "
            f"{row['matvecs']} matvecs, {row['wall_s']:.2f} s; control {c['iterations']}, "
            f"{c['matvecs']}, {c['wall_s']:.2f} s; ‖Δx‖ {gap:.2e} (bar {row['x_bar']:.2e})")
        if abs(row["iterations"] - c["iterations"]) > 1 or gap > row["x_bar"] or not row["converged"]:
            raise AssertionError(f"[main-shard] system {i + 1} off the control: {row}")
    its = [r["iterations"] for r in rows]
    if len(rows) != len(control) or not all(i < its[0] for i in its[1:]):
        raise AssertionError(f"[main-shard] recycling did not cut iterations: {its}")
    if any(len(set(col)) != 1 for col in zip(*out["rank_iterations"])):
        raise AssertionError(f"[main-shard] ranks disagree: {out['rank_iterations']}")
    for rank, (launched, plain) in enumerate(zip(out["launches"], out["plain_on_cuda"])):
        if torch.device(device).type == "cuda" and (
                any(plain.values()) or launched["rbf_matvec"]
                or not all(launched[k] for k in SHARD_PATH_KERNELS)):
            raise AssertionError(f"[main-shard] rank {rank}: launches {launched}, plain {plain}")
    out["launches_summed"] = {k: sum(r[k] for r in out["launches"]) for k in out["launches"][0]}
    wall = sum(r["wall_s"] for r in rows)
    products = sum(r["matvecs"] for r in rows)
    frozen = sum(frozen_steps(i, ELL, engine.CHUNK) for i in its)
    out.update(n=n, ranks=ranks, wall_s=wall, control_wall_s=sum(c["wall_s"] for c in control),
               products_counted=products, frozen_products=frozen,
               ms_per_product=1e3 * wall / (products + frozen))
    log(f"[main-shard] {ranks} {out['backend']} ranks on one card (no scaling number: they "
        f"share it): {len(rows)} systems, iterations {its}, {wall:.2f} s (control "
        f"{out['control_wall_s']:.2f} s), {out['ms_per_product']:.1f} ms per sharded product "
        f"({products} counted + {frozen} frozen); K8 per rank, all ranks at once, "
        f"{out['k8_shared_ms']} ms; K8 launches per rank "
        f"{[r['rbf_matvec_rect'] for r in out['launches']]}; collectives per rank "
        f"{out['collectives']}; host ms per collective (rank 0) {out['staging'][0]}")
    return out


def phase_shard(torch, device="cuda", n=SHARD_N, ranks=SHARD_RANKS, nccl=True):
    """check-shard on one NCCL rank, then main-shard's control, then one
    spawn of ``ranks`` gloo ranks that runs check-shard's cases and
    main-shard's replay.  Returns ``{"check_shard": ..., "main_shard": ...}``."""
    import shutil
    import tempfile

    import numpy as np

    from repro_torch.launch import run_ranks

    check_args, lsq_bound = check_shard_inputs(torch)
    check_args = (*check_args, device)
    report = {"check_shard": {}}
    if nccl:
        t0 = time.perf_counter()
        out = run_ranks(shard_world_rank, 1, backend="nccl", device=device,
                        args=(check_args,), timeout_s=SHARD_TIMEOUT_S)
        tag = "[check-shard nccl x1]"
        report["check_shard"]["nccl1"] = judge_check_shard(torch, tag, out["check"], lsq_bound,
                                                           device)
        log(f"{tag} spawn and cases {time.perf_counter() - t0:.1f} s")

    xs_np, control = shard_control(torch, device, n)
    workdir = tempfile.mkdtemp(prefix="chip_smoke_shard_")
    try:
        x_path = os.path.join(workdir, "x.npy")
        np.save(x_path, xs_np.astype(np.float64))
        systems = [{k: c[k] for k in ("sqrt_h", "b", "x0")} for c in control]
        t0 = time.perf_counter()
        out = run_ranks(shard_world_rank, ranks, backend="gloo", device=device,
                        args=(check_args, (x_path, systems, device)), timeout_s=SHARD_TIMEOUT_S)
        spawn_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    tag = f"[check-shard gloo x{ranks}]"
    report["check_shard"][f"gloo{ranks}"] = judge_check_shard(torch, tag, out["check"],
                                                              lsq_bound, device)
    report["main_shard"] = judge_main_shard(torch, out["main"], control, device, n, ranks)
    report["main_shard"]["spawn_wall_s"] = spawn_s
    log(f"[main-shard] one spawn of {ranks} gloo ranks for both phases: {spawn_s:.1f} s")
    return report


# ---------------------------------------------------------------------------
# The model zoo's serving path: check-lm, main-lm-attn, main-lm-ssm, timing
# ---------------------------------------------------------------------------


def logit_gap(got, want, tol):
    """Max and mean abs gap of two tensors, the share of elements past
    ``atol + rtol·|want|``, and the share past it on values divided by the
    scale ``max(1, max |want|)`` (how the kernel tests hold the SSD scan's
    outputs)."""
    rtol, atol = tol
    want = want.float()
    err = (got.float() - want).abs()
    scale = max(1.0, float(want.abs().max()))
    return {"max_abs": float(err.max()), "mean_abs": float(err.mean()), "scale": scale,
            "outside": float((err > atol + rtol * want.abs()).float().mean()),
            "outside_scaled": float((err / scale > atol + rtol * want.abs() / scale)
                                    .float().mean())}


def lm_close(torch, got, want, dname, what, scaled=False):
    """Max abs error of ``got`` against ``want``; raises past the tolerance
    of ``tests/test_kernels.py`` for ``dname`` (elementwise rtol/atol, or
    on values divided by the output's scale for the SSD scan)."""
    if got.shape != want.shape or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{what}: bad output shape or non-finite values")
    gap = logit_gap(got, want, LM_TOL[dname])
    if gap["outside_scaled" if scaled else "outside"] > 0:
        raise AssertionError(f"{what}: max abs error {gap['max_abs']:.3e} (scale "
                             f"{gap['scale']:.3e}) past rtol/atol {LM_TOL[dname]}")
    return gap["max_abs"]


def attn_inputs(torch, b, h, hkv, sq, sk, dh, dtype, seed, device="cuda"):
    g = torch.Generator(device=device).manual_seed(seed)
    return tuple(torch.randn(b, n, s, dh, generator=g, device=device).to(dtype)
                 for n, s in ((h, sq), (hkv, sk), (hkv, sk)))


def ssd_inputs(torch, b, l, h, p, g, n, dtype, seed, device="cuda", strided=False):
    """x, dt, a, B, C, D and a state: the ranges of ``tests/test_kernels.py``.
    ``strided``: x, B and C are ``torch.split`` views of one (b, l, h·p +
    2·g·n) tensor, as ``models/mamba.py`` passes them."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device=device)

    dt = 0.01 + 0.39 * torch.rand(b, l, h, generator=gen, device=device)
    a = -(0.3 + 1.7 * torch.rand(h, generator=gen, device=device))
    if strided:
        xc, bc, cc = torch.split(rnd(b, l, h * p + 2 * g * n).to(dtype), [h * p, g * n, g * n],
                                 dim=-1)
        x, bm, cm = xc.reshape(b, l, h, p), bc.reshape(b, l, g, n), cc.reshape(b, l, g, n)
    else:
        x, bm, cm = rnd(b, l, h, p).to(dtype), rnd(b, l, g, n).to(dtype), rnd(b, l, g, n).to(dtype)
    return x, dt, a, bm, cm, rnd(h), rnd(b, h, p, n)


def phase_check_lm(torch, device="cuda", attn_cases=ATTN_CHECK, ssd_cases=SSD_CHECK,
                   strided=True):
    """K9 and K10 against their plain versions on the card, at the kernel
    tests' shapes and the serving paths' own (``attn_cases``,
    ``ssd_cases``; with ``strided`` the split views too), f32 and bf16,
    plus a bit-for-bit repeat; returns the worst abs error at the main
    shapes (and at ATTN_160, ATTN_ENCDEC_TIMED's and SSD_JAMBA)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as ss

    worst = {"flash_attention": 0.0, "ssd_scan": 0.0, "flash_attention dh160": 0.0,
             "ssd_scan jamba": 0.0}
    encdec = {case: f"flash_attention {label}" for label, case in ATTN_ENCDEC_TIMED}
    worst.update(dict.fromkeys(encdec.values(), 0.0))
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        for case in attn_cases:
            b, h, hkv, sq, sk, dh, causal, off = case
            q, k, v = attn_inputs(torch, b, h, hkv, sq, sk, dh, dtype, seed=sum(case[:6]),
                                  device=device)
            got = fa.flash_attention_cuda(q, k, v, causal=causal, q_offset=off)
            want = fa.flash_attention_plain(q, k, v, causal=causal, q_offset=off)
            _sync(torch, device)
            err = lm_close(torch, got, want, dname, f"flash_attention {case} {dname}")
            if not torch.equal(got, fa.flash_attention_cuda(q, k, v, causal=causal, q_offset=off)):
                raise AssertionError(f"[check-lm] flash_attention {case} {dname}: two launches "
                                     "differ")
            log(f"[check-lm] flash_attention {case} {dname}: max abs err {err:.3e}, two "
                "launches bitwise equal")
            if case == ATTN_MAIN:
                worst["flash_attention"] = max(worst["flash_attention"], err)
            if case == ATTN_160:
                worst["flash_attention dh160"] = max(worst["flash_attention dh160"], err)
            if case in encdec:
                worst[encdec[case]] = max(worst[encdec[case]], err)
        views = [(SSD_STRIDED, True)] if strided else []
        for case, strided in [(c, False) for c in ssd_cases] + views:
            b, l, h, p, g, n, chunk = case
            x, dt, a, bm, cm, d, h0 = ssd_inputs(torch, b, l, h, p, g, n, dtype, seed=sum(case),
                                                 device=device, strided=strided)
            if strided and x.is_contiguous():
                raise AssertionError("[check-lm] ssd_scan: the split views are contiguous")
            for state in (False, True):
                kw = dict(chunk=chunk, initial_state=h0 if state else None, return_state=state)
                got = ss.ssd_scan_cuda(x, dt, a, bm, cm, d, **kw)
                want = ss.ssd_plain(x, dt, a, bm, cm, d, **kw)
                _sync(torch, device)
                got, want = (got, want) if state else ((got,), (want,))
                what = f"ssd_scan {case}{' split views' if strided else ''} {dname} state={state}"
                # y at its dtype's bar; the f32 final state at the f32 bar.
                errs = [lm_close(torch, gv, wv, dname if i == 0 else "float32", what,
                                 scaled=True) for i, (gv, wv) in enumerate(zip(got, want))]
                log(f"[check-lm] {what}: max abs err "
                    + ", ".join(f"{e:.3e}" for e in errs) + (" (y, final state)" if state else ""))
                if case == SSD_MAIN:
                    worst["ssd_scan"] = max(worst["ssd_scan"], *errs)
                if case == SSD_JAMBA:
                    worst["ssd_scan jamba"] = max(worst["ssd_scan jamba"], *errs)
    if not ssd_cases:
        return worst
    # Two launches on the same inputs agree bit for bit (no atomics).
    x, dt, a, bm, cm, d, h0 = ssd_inputs(torch, *SSD_MAIN[:6], torch.bfloat16, seed=1,
                                         device=device)
    fn = lambda: ss.ssd_scan_cuda(x, dt, a, bm, cm, d, initial_state=h0,  # noqa: E731
                                  return_state=True)
    if not all(torch.equal(u, w) for u, w in zip(fn(), fn())):
        raise AssertionError("[check-lm] ssd_scan: two launches differ")
    log("[check-lm] ssd_scan: two launches bitwise equal")
    return worst


def lm_serve(torch, model, cfg, tokens, backend, decode_steps, feed=None, max_len=None,
             src=None):
    """Prefill ``tokens`` (b, s) and take ``decode_steps`` greedy decode
    steps through the serving entry points; host clock around each part,
    ended by a synchronize.  With ``feed`` (b, decode_steps + 1) the decode
    steps take its tokens instead of their own argmax (which is still
    recorded in ``greedy``), so two runs can be compared step for step.
    The caches hold ``max_len`` positions (default ``s + decode_steps``: a
    decode step's reductions run over them, so two runs compared bit for
    bit need the same).  An encoder–decoder's prefill encodes ``src``
    (its ``src_embeds``, b × frames × d)."""
    from repro_torch import models
    from repro_torch.launch import make_prefill_step, make_serve_step

    b, s = tokens.shape
    max_len = s + decode_steps if max_len is None else max_len
    prefill = make_prefill_step(cfg, max_len, backend=backend)
    serve = make_serve_step(cfg, backend=backend)
    state = models.init_decode_state(cfg, b, max_len, device=tokens.device)
    batch = {"tokens": tokens} if src is None else {"tokens": tokens, "src_embeds": src}
    _sync(torch, tokens.device)
    t0 = time.perf_counter()
    state, last = prefill(model, batch, state)
    _sync(torch, tokens.device)
    prefill_s = time.perf_counter() - t0
    tok = last[:, -1, : cfg.vocab_size].argmax(-1, keepdim=True)
    greedy, first = [tok], None
    t0 = time.perf_counter()
    for i in range(decode_steps):
        logits, state = serve(model, tok if feed is None else feed[:, i : i + 1], state)
        if first is None:
            first = logits
        tok = logits[:, -1, : cfg.vocab_size].argmax(-1, keepdim=True)
        greedy.append(tok)
    _sync(torch, tokens.device)
    decode_s = time.perf_counter() - t0
    return {"prefill_s": prefill_s, "decode_s": decode_s, "last": last, "first": first,
            "greedy": torch.cat(greedy, dim=1), "state": state}


def profile_serving(torch, fn, kernel, device="cuda"):
    """``torch.profiler`` over one call of ``fn``: device time of
    ``kernel`` (the CUDA kernel's symbol contains the name) and of all
    device work, launches, and wall time under the profiler."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _sync(torch, device)
        t0 = time.perf_counter()
        fn()
        _sync(torch, device)
        wall_ms = 1e3 * (time.perf_counter() - t0)
    total_us = kernel_us = 0.0
    launches = kernel_launches = 0
    ops = []
    for evt in prof.key_averages():
        us = _device_us(evt)
        if not (_is_device(evt) and us > 0):
            continue
        total_us += us
        launches += evt.count
        ops.append((evt.key[:80], us / 1e3, evt.count))
        if kernel in evt.key:
            kernel_us += us
            kernel_launches += evt.count
    top = [{"name": k, "ms": ms, "calls": n} for k, ms, n in sorted(ops, key=lambda o: -o[1])]
    return {"device_ms": total_us / 1e3, "kernel_ms": kernel_us / 1e3,
            "kernel_launches": kernel_launches, "launches": launches, "top_ops": top[:TOP_OPS],
            "wall_ms_profiled": wall_ms,
            "kernel_share_of_device": kernel_us / total_us if total_us else None,
            "device_idle_share": 1.0 - total_us / 1e3 / wall_ms if total_us else None}


def routing_report(cfg, kernel, other):
    """Two runs' routing records (``models.moe.record_routing``, the same
    calls in the same order): the share of (token, MoE layer) decisions
    whose set of k experts agree, and the kernel run's tokens dropped per
    layer in its first (prefill) call of each layer."""
    agree = total = 0
    for a, b in zip(kernel, other, strict=True):
        same = (a.experts.sort(dim=-1).values == b.experts.sort(dim=-1).values).all(dim=-1)
        agree += int(same.sum())
        total += same.numel()
    layers = sum(kind.startswith("moe") for kind in cfg.ffn_kinds())
    dropped = [int((~r.kept).sum()) for r in kernel[:layers]]
    return {"agree": agree, "decisions": total, "agree_share": agree / total,
            "dropped_per_layer": dropped,
            "dropped_share": sum(dropped) / sum(r.kept.numel() for r in kernel[:layers])}


def moe_pairs(torch, model, cfg, cfg32, tokens, run, tag):
    """A MoE model's comparison runs beside the kernels' ``run``, each
    through the prefill and one decode step: the kernels again with the
    routing recorded (bit for bit ``run``), the plain versions free
    (recorded, for the routing agreement) and replaying the kernels'
    routing, and the f32 control (kernels recorded, plain replaying them).
    Returns (plain replayed, f32 kernels, f32 plain replayed, plain free,
    routing report)."""
    from repro_torch.models import moe

    # The held logits are the prefill's and the first decode step's: the
    # comparison runs stop after one decode step, with ``run``'s caches.
    serve = functools.partial(lm_serve, torch, model, feed=run["greedy"],
                              max_len=tokens.shape[1] + run["greedy"].shape[1] - 1)
    with moe.record_routing() as rec_k:
        again = serve(cfg, tokens, "auto", 1)
    if not (torch.equal(again["last"], run["last"]) and torch.equal(again["first"], run["first"])):
        raise AssertionError(f"{tag} two kernel runs differ")
    with moe.record_routing() as rec_p:
        free = serve(cfg, tokens, "plain", 1)
    with moe.replay_routing(rec_k):
        plain = serve(cfg, tokens, "plain", 1)
    with moe.record_routing() as rec_k32:
        k32 = serve(cfg32, tokens, "auto", 1)
    with moe.replay_routing(rec_k32):
        p32 = serve(cfg32, tokens, "plain", 1)
    routing = routing_report(cfg, rec_k, rec_p)
    log(f"{tag} routing, kernels against plain (free): {routing['agree']} of "
        f"{routing['decisions']} (token, layer) expert sets agree ({routing['agree_share']:.4%}); "
        f"the kernel run's prefill drops "
        f"{routing['dropped_share']:.2%} of its assignments, per layer "
        f"{routing['dropped_per_layer']} (capacity factor {cfg.capacity_factor}); the held pairs "
        "replay the kernel runs' routing")
    return plain, k32, p32, free, routing


def phase_main_lm(torch, key, device="cuda"):
    """One serving main path (``LM_PATHS[key]``) at full width: random f32
    weights from a generator seeded 0, bf16 compute, the prompts of
    ``TokenPipeline(vocab, batch, prompt, seed=0)``, prefill and greedy
    decode through the kernels; then the same through the plain versions
    and a teacher-forced decode against ``forward_hidden``, counted apart.
    An encoder–decoder (``spec["source"]``) also takes ``batch`` x
    ``source`` normal source frames from a generator seeded 0, and K9 must
    launch exactly once a layer call (prefill: encoder, self and cross;
    decode: cross).  Returns (report, launches of the main run)."""
    from repro_torch import models
    from repro_torch.configs import get_config
    from repro_torch.data import TokenPipeline
    from repro_torch.kernels import _runtime
    from repro_torch.models import transformer
    from repro_torch.models.layers import lm_head_weights

    spec = LM_PATHS[key]
    tag = f"[{key}]"
    cfg = get_config(spec["arch"])
    t0 = time.perf_counter()
    model = models.init(torch.Generator(device=device).manual_seed(0), cfg, device=device)
    _sync(torch, device)
    init_s = time.perf_counter() - t0
    batch = TokenPipeline(cfg.vocab_size, spec["batch"], spec["prompt"], seed=0).make_batch(0)
    tokens = torch.as_tensor(batch["tokens"].astype("int64"), device=device)
    src = None
    if "source" in spec:
        src = torch.randn(spec["batch"], spec["source"], cfg.d_model, device=device,
                          generator=torch.Generator(device=device).manual_seed(0))
    # warm-up (cuBLAS, module loads)
    lm_serve(torch, model, cfg, tokens[:, :256], "auto", 2, src=None if src is None else src[:, :256])

    on_card = torch.device(device).type == "cuda"
    held_gb = float("nan")
    if on_card:
        torch.cuda.reset_peak_memory_stats()
        held_gb = torch.cuda.memory_allocated() / 1e9
    _zero_counts()
    run = lm_serve(torch, model, cfg, tokens, "auto", spec["decode"], src=src)
    launches = dict(_runtime.LAUNCHES)
    arms = _arms()
    plain_on_cuda = dict(_runtime.PLAIN_ON_CUDA)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9 if on_card else float("nan")
    n_tok = tokens.numel()
    report = {
        "arms": arms,
        "arch": cfg.name, "batch": spec["batch"], "prompt": spec["prompt"],
        "source": spec.get("source"), "encoder_layers": cfg.encoder_layers,
        "decode_steps": spec["decode"], "layers": cfg.n_layers, "d_model": cfg.d_model,
        "params": sum(p.numel() for p in model.parameters()), "init_s": init_s,
        "prefill_ms": 1e3 * run["prefill_s"], "prefill_tokens_per_s": n_tok / run["prefill_s"],
        "decode_ms_per_step": 1e3 * run["decode_s"] / spec["decode"],
        "peak_memory_gb": peak_gb, "held_gb": held_gb, "launches": launches,
        "plain_on_cuda": plain_on_cuda,
    }
    for name, val in (("last", run["last"]), ("first", run["first"])):
        if not bool(torch.isfinite(val).all()):
            raise AssertionError(f"{tag} non-finite {name} logits")
    source = ""
    if src is not None:
        report["prefill_source_frames_per_s"] = src.shape[0] * src.shape[1] / run["prefill_s"]
        source = (f"{cfg.encoder_layers} encoder layers over {spec['batch']} x {spec['source']} "
                  f"source frames ({report['prefill_source_frames_per_s']:.0f} frames/s in "
                  "prefill); ")
    log(f"{tag} {cfg.name}: {cfg.n_layers} layers, d {cfg.d_model}, "
        f"{report['params'] / 1e9:.3f} B params ({cfg.param_dtype}), {cfg.dtype} compute; {source}"
        f"prompts {spec['batch']} x {spec['prompt']}: prefill {report['prefill_ms']:.1f} ms "
        f"({report['prefill_tokens_per_s']:.0f} tokens/s), decode "
        f"{report['decode_ms_per_step']:.2f} ms per step ({spec['batch']} tokens), peak "
        f"memory {peak_gb:.2f} GB; launches {launches}; plain on the card {plain_on_cuda}")
    if cfg.is_encdec:
        calls = cfg.encoder_layers + 2 * cfg.n_layers + cfg.n_layers * spec["decode"]
        if launches["flash_attention"] != calls:
            raise AssertionError(f"{tag} K9 launched {launches['flash_attention']} times, not "
                                 f"once a layer call ({calls})")

    # The same run through the plain versions, counted apart, fed the
    # kernels' greedy tokens so that every decode step reads the same
    # token: near-tied logits of random weights flip an argmax now and then.
    # The f32 control: the same weights and tokens at dtype float32, where
    # bf16 rounding cannot hide a kernel fault.  A MoE model's plain runs
    # replay the kernel runs' routing (held), and run free once (reported:
    # rounding flips a near-tied top-k choice, ROADMAP P7).
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    pairs = ()
    if cfg.n_experts:
        plain, k32, p32, free, report["routing"] = moe_pairs(torch, model, cfg, cfg32, tokens,
                                                             run, tag)
        pairs = (("bf16 kernels vs plain, free routing", run, free, "bfloat16", None),)
    else:
        plain = lm_serve(torch, model, cfg, tokens, "plain", spec["decode"], feed=run["greedy"],
                         src=src)
        k32 = lm_serve(torch, model, cfg32, tokens, "auto", 1, feed=run["greedy"], src=src)
        p32 = lm_serve(torch, model, cfg32, tokens, "plain", 1, feed=run["greedy"], src=src)
    n_same = plain["greedy"].shape[1]  # a MoE model's plain run takes one decode step
    same = int((run["greedy"][:, :n_same] == plain["greedy"]).sum())
    report.update(plain_prefill_ms=1e3 * plain["prefill_s"],
                  plain_decode_ms_per_step=1e3 * plain["decode_s"] / (n_same - 1),
                  greedy_tokens_equal=f"{same} of {plain['greedy'].numel()}",
                  max_abs_logit=float(p32["last"].abs().max()))
    # What is held: in f32 the kernels against the plain versions element
    # by element at the f32 bar; in bf16 at the bf16 bar on logits divided
    # by their scale.  Element by element the bf16 pair sits at the
    # model's own bf16 rounding noise, which the last two pairs measure
    # against f32 (ROADMAP P7).
    failures = []
    pairs = (("bf16 kernels vs plain", run, plain, "bfloat16", "outside_scaled"),
             ("f32 kernels vs plain", k32, p32, "float32", "outside"),
             ("bf16 kernels vs f32 plain", run, p32, "bfloat16", None),
             ("bf16 plain vs f32 plain", plain, p32, "bfloat16", None)) + pairs
    for label, got, want, dname, held in pairs:
        for name in ("last", "first"):
            gap = logit_gap(got[name], want[name], LM_TOL[dname])
            report.setdefault("logit_gaps", {})[f"{label}, {name}"] = gap
            log(f"{tag} {label}, {'prefill' if name == 'last' else 'first decode'} logits: "
                f"max abs {gap['max_abs']:.3e}, mean abs {gap['mean_abs']:.3e}; past rtol/atol "
                f"{LM_TOL[dname]}: {gap['outside']:.2e} of the logits, "
                f"{gap['outside_scaled']:.2e} relative to the scale {gap['scale']:.3f}"
                + (f" (held: {held})" if held else " (reported)"))
            if held and gap[held] > 0:
                failures.append(f"{label}, {name}")
    log(f"{tag} max |logit| {report['max_abs_logit']:.3f}; greedy tokens equal {same} of "
        f"{plain['greedy'].numel()}; plain prefill {report['plain_prefill_ms']:.1f} ms")
    del plain, k32, p32

    # Teacher-forced decode of the first tokens against forward_hidden:
    # the cache / state invariant of tests/test_archs_smoke.py at its
    # 2e-2, held in f32; in bf16 reported (the forward's f32 scores and
    # the decode read's bf16 ones round apart by the bf16 noise above).
    # A MoE model runs it dropless (capacity factor E / k, as the
    # reference's SMOKE configs are): the prefill drops tokens that one-
    # token decode steps never drop.
    # An encoder–decoder's steps read the memory of the encoded source.
    head = tokens[:, : spec["teacher"]]
    inputs = {"tokens": head} if src is None else {"tokens": head, "src_embeds": src}
    dropless = {"capacity_factor": cfg.n_experts / cfg.experts_per_token} if cfg.n_experts else {}
    for c in (dataclasses.replace(cfg, **dropless), dataclasses.replace(cfg32, **dropless)):
        hidden, _ = models.forward_hidden(model, inputs, c)
        full = (hidden @ lm_head_weights(model.embed, c)).float()
        state = models.init_decode_state(c, head.shape[0], head.shape[1], device=device)
        if c.is_encdec:
            state = state._replace(memory=transformer._cross_memory(
                model, transformer._encode(model, inputs, c), c))
        steps = []
        for t in range(head.shape[1]):
            logits, state = models.decode_step(model, head[:, t : t + 1], state, c)
            steps.append(logits[:, 0])
        gap = logit_gap(torch.stack(steps, dim=1), full, (2e-2, 2e-2))
        report.setdefault("teacher_forced", {})[c.dtype] = gap
        held = c.dtype == "float32"
        log(f"{tag} teacher-forced decode of {spec['teacher']} tokens vs forward_hidden, "
            f"{c.dtype}: max abs {gap['max_abs']:.3e}, mean abs {gap['mean_abs']:.3e}; past "
            f"2e-2 + 2e-2·|logit|: {gap['outside']:.2e} of the logits"
            + (" (held)" if held else " (reported)"))
        if held and gap["outside"] > 0:
            failures.append(f"teacher-forced {c.dtype}")
    if failures:
        raise AssertionError(f"{tag} logits past their bars: {failures}")

    # Profiles of one prefill and of decode steps, counted apart.
    prof_prefill = profile_serving(
        torch, lambda: lm_serve(torch, model, cfg, tokens, "auto", 0, src=src), spec["kernel"],
        device)
    if src is None:
        decode_what = "16-token prefill + 8 decode steps"
        prof_decode = profile_serving(
            torch, lambda: lm_serve(torch, model, cfg, tokens[:, :16], "auto", 8),
            spec["kernel"], device)
    else:  # the decode steps alone: the encoder's prefill would fill the profile
        decode_what = f"8 decode steps (cross-attending to {spec['source']} frames)"
        primed = lm_serve(torch, model, cfg, tokens[:, :16], "auto", 0, max_len=24, src=src)

        def decode_steps():
            state, tok = primed["state"], primed["greedy"]
            for _ in range(8):
                logits, state = models.decode_step(model, tok, state, cfg)
                tok = logits[:, -1, : cfg.vocab_size].argmax(-1, keepdim=True)

        prof_decode = profile_serving(torch, decode_steps, spec["kernel"], device)
    report["profile_prefill"], report["profile_decode_8"] = prof_prefill, prof_decode
    share = lambda v: "not measured" if v is None else f"{v:.1%}"  # noqa: E731
    log(f"{tag} profile prefill: {prof_prefill['kernel_launches']} {spec['kernel']} launches, "
        f"{prof_prefill['kernel_ms']:.1f} of {prof_prefill['device_ms']:.1f} ms device time "
        f"({share(prof_prefill['kernel_share_of_device'])}), {prof_prefill['launches']} device "
        f"launches, wall {prof_prefill['wall_ms_profiled']:.1f} ms under the profiler, device "
        f"idle {share(prof_prefill['device_idle_share'])}")
    log(f"{tag} profile prefill, top device operations (ms, calls): "
        + "; ".join(f"{o['name']} {o['ms']:.2f} ms x{o['calls']}" for o in prof_prefill["top_ops"]))
    log(f"{tag} profile {decode_what}: {prof_decode['launches']} device "
        f"launches, device {prof_decode['device_ms']:.1f} ms in {prof_decode['wall_ms_profiled']:.1f} "
        f"ms wall, device idle {share(prof_decode['device_idle_share'])}")
    del model, run
    if on_card:
        torch.cuda.empty_cache()
    return report, launches


def phase_zoo(torch, device="cuda"):
    """Every other decoder-only architecture (``ZOO``) at full width, depth
    cut where noted: random f32 weights from a generator seeded 0, the
    prompts of ``TokenPipeline(vocab, 2, 2 048, seed=0)``, a prefill and 4
    greedy decode steps through the kernels (counted and timed; a MoE
    model's run again with its routing recorded, bit for bit the same),
    then through the plain versions fed the same tokens (a MoE model's
    plain run replaying the kernels' routing, and once free for the routing
    agreement): the
    prefill and first decode logits held at the model's dtype's bar (bf16
    relative to the logits' scale, f32 element by element).  Returns
    (report, launches summed over the models)."""
    from repro_torch import models
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.data import TokenPipeline
    from repro_torch.kernels import _runtime
    from repro_torch.models import moe

    report, launches = {}, {}
    b, s, steps = ZOO_RUN["batch"], ZOO_RUN["prompt"], ZOO_RUN["decode"]
    for arch, cut in ZOO:
        tag = f"[zoo {arch}]"
        t_model = time.perf_counter()
        full = get_config(arch)
        if cut == "smoke":
            cfg = get_smoke_config(arch)
        else:
            cfg = full if cut is None else dataclasses.replace(full, n_layers=cut)
        reckoned_gb = 4 * cfg.total_params() / 1e9
        torch.cuda.reset_peak_memory_stats()
        model = models.init(torch.Generator(device=device).manual_seed(0), cfg, device=device)
        batch = TokenPipeline(cfg.vocab_size, b, s, seed=0).make_batch(0)
        tokens = torch.as_tensor(batch["tokens"].astype("int64"), device=device)
        lm_serve(torch, model, cfg, tokens[:, :64], "auto", 1)  # warm-up
        _zero_counts()
        run = lm_serve(torch, model, cfg, tokens, "auto", steps)
        counts = {k: v for k, v in _runtime.LAUNCHES.items() if v}
        plain_on_cuda = {k: v for k, v in _runtime.PLAIN_ON_CUDA.items() if v}
        rec_k = []
        if cfg.n_experts:
            # The routing is read in a repeat of the timed run (recording
            # copies each layer's ids to the host), bit for bit the same.
            with moe.record_routing() as rec_k:
                again = lm_serve(torch, model, cfg, tokens, "auto", steps)
            if not (torch.equal(again["last"], run["last"])
                    and torch.equal(again["first"], run["first"])):
                raise AssertionError(f"{tag} two kernel runs differ")
            del again
        with moe.replay_routing(rec_k):
            plain = lm_serve(torch, model, cfg, tokens, "plain", steps, feed=run["greedy"])
        entry = {"layers": cfg.n_layers, "full_layers": full.n_layers, "d_model": cfg.d_model,
                 "dtype": cfg.dtype, "params": sum(p.numel() for p in model.parameters()),
                 "reckoned_f32_gb": reckoned_gb, "full_depth_f32_gb": 4 * full.total_params() / 1e9,
                 "prefill_ms": 1e3 * run["prefill_s"],
                 "decode_ms_per_step": 1e3 * run["decode_s"] / steps, "launches": counts,
                 "plain_on_cuda": plain_on_cuda}
        if cfg.n_experts:
            with moe.record_routing() as rec_p:
                lm_serve(torch, model, cfg, tokens, "plain", steps, feed=run["greedy"])
            entry["routing"] = routing_report(cfg, rec_k, rec_p)
        dname = cfg.dtype
        held = "outside_scaled" if dname == "bfloat16" else "outside"
        bad = []
        for name in ("last", "first"):
            gap = logit_gap(run[name], plain[name], LM_TOL[dname])
            entry[f"gap_{name}"] = gap
            if not bool(torch.isfinite(run[name]).all()) or gap[held] > 0:
                bad.append(name)
        entry["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
        del model, run, plain
        torch.cuda.empty_cache()
        entry["wall_s"] = time.perf_counter() - t_model
        report[arch] = entry
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
        depth = ("SMOKE (full width does not fit)" if cut == "smoke" else
                 f"{cfg.n_layers} of {full.n_layers} layers (cut: "
                 f"{entry['full_depth_f32_gb']:.1f} GB of f32 parameters at full depth)"
                 if cut else f"{cfg.n_layers} layers")
        routing = entry.get("routing")
        log(f"{tag} {depth}, d {cfg.d_model}, {entry['params'] / 1e9:.3f} B parameters "
            f"({reckoned_gb:.1f} GB f32), {dname} compute; prefill {b} x {s} "
            f"{entry['prefill_ms']:.1f} ms, decode {entry['decode_ms_per_step']:.2f} ms a step; "
            f"launches {counts}; prefill / first decode logits against plain: max abs "
            f"{entry['gap_last']['max_abs']:.3e} / {entry['gap_first']['max_abs']:.3e}, past "
            f"{LM_TOL[dname]} ({held}): {entry['gap_last'][held]:.2e} / "
            f"{entry['gap_first'][held]:.2e}"
            + (f"; routing agreement (free plain run) {routing['agree_share']:.4%}, prefill "
               f"drops {routing['dropped_share']:.2%}" if routing else "")
            + f"; peak memory {entry['peak_memory_gb']:.1f} GB; wall {entry['wall_s']:.1f} s")
        need = ["flash_attention"] + (["ssd_scan"] if "ssm" in cfg.layer_kinds() else [])
        if bad or plain_on_cuda or not all(counts.get(k) for k in need):
            raise AssertionError(f"{tag} failed: logits past the bar {bad}, launches {counts}, "
                                 f"plain on the card {plain_on_cuda}")
    return report, launches


def attn_timing(torch, peaks, case, reps, device="cuda"):
    """K9's serving arm at ``case`` in bf16: kernel, plain version,
    ``scaled_dot_product_attention`` (GQA through ``enable_gqa``) and the
    bound."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa

    b, h, hkv, sq, sk, dh, causal, _ = case
    q, k, v = attn_inputs(torch, b, h, hkv, sq, sk, dh, torch.bfloat16, seed=2, device=device)
    nbytes, ops = attn_work(b, h, hkv, sq, sk, dh, causal, 2)
    t_bytes, t_ops = nbytes / peaks["bytes"], ops / peaks["bfloat16_tensor"]
    t = {
        "shape": case,
        "ms": device_ms(torch, lambda: fa.flash_attention_cuda(q, k, v, causal=causal), reps),
        "plain_ms": device_ms(torch, lambda: fa.flash_attention_plain(q, k, v, causal=causal),
                              reps),
        "library_ms": device_ms(torch, lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=causal, enable_gqa=h != hkv), reps),
        "bound_ms": 1e3 * max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
    }
    t["tflop_s"] = ops / t["ms"] / 1e9
    return t


def ssd_timing(torch, peaks, case, worst, device="cuda"):
    """K10's serving arm at ``case`` in bf16: kernel (without and with the
    state in and out), plain version and bound (no PyTorch call computes
    the scan)."""
    from repro_torch.kernels import ssd_scan as ss

    b, l, h, p, g, n, c = case
    x, dt, a, bm, cm, d, h0 = ssd_inputs(torch, b, l, h, p, g, n, torch.bfloat16, seed=2,
                                         device=device)
    nbytes, ops = ssd_work(b, l, h, p, g, n, c, 2)
    t_bytes, t_ops = nbytes / peaks["bytes"], ops / peaks["bfloat16_tensor"]
    k10 = {
        "shape": case, "max_abs_err": worst,
        "ms": device_ms(torch, lambda: ss.ssd_scan_cuda(x, dt, a, bm, cm, d, chunk=c)),
        "plain_ms": device_ms(torch, lambda: ss.ssd_plain(x, dt, a, bm, cm, d, chunk=c), 5),
        "library_ms": None,
        "bound_ms": 1e3 * max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
    }
    k10["stateful_ms"] = device_ms(torch, lambda: ss.ssd_scan_cuda(
        x, dt, a, bm, cm, d, chunk=c, initial_state=h0, return_state=True))
    k10["tflop_s"] = ops / k10["ms"] / 1e9
    return k10


def phase_timing_lm(torch, peaks, worst, device="cuda", only=None):
    """K9 at qwen1.5-0.5b's prefill shape, at prefill_32k's length (b 1),
    at stablelm-12b's (ATTN_160) and at seamless-m4t-large-v2's three
    non-causal ones (ATTN_ENCDEC_TIMED), K10 at mamba2-1.3b's and at
    jamba-v0.1-52b's (SSD_JAMBA): kernel, plain version, the library
    yardstick (``scaled_dot_product_attention`` for K9, causal as the case
    is; none computes the SSD scan) and the bound, bf16.  ``only="zoo"``
    times ATTN_160 and SSD_JAMBA alone, ``only="encdec"``
    ATTN_ENCDEC_TIMED's shapes alone."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa

    out = {}
    encdec = tuple((label, case, REPS) for label, case in ATTN_ENCDEC_TIMED)
    shapes = {None: (("main", ATTN_MAIN, REPS), ("32k", ATTN_LONG, LONG_REPS),
                     ("dh160", ATTN_160, REPS)) + encdec,
              "zoo": (("dh160", ATTN_160, REPS),), "encdec": encdec}[only]
    for label, case, reps in shapes:
        out[label] = t = attn_timing(torch, peaks, case, reps, device)
        if f"flash_attention {label}" in worst:
            t["max_abs_err"] = worst[f"flash_attention {label}"]
        previous = PREVIOUS_MS.get("flash_attention " + label)
        prev = "" if previous is None else f"; the previous SIMT kernel {previous} ms"
        log(f"[timing] flash_attention {case} bf16: kernel {t['ms']:.3f} ms "
            f"({t['tflop_s']:.1f} TFLOP/s{prev}), plain {t['plain_ms']:.3f} ms, "
            f"scaled_dot_product_attention {t['library_ms']:.3f} ms, bound {t['bound_ms']:.4f} ms "
            f"({t['bound_by']})")
    encdec_out = {label: out[label] for label, _ in ATTN_ENCDEC_TIMED if label in out}
    if only == "encdec":
        return {"flash_attention": dict(out["encoder"], **encdec_out)}
    jamba = ssd_timing(torch, peaks, SSD_JAMBA, worst["ssd_scan jamba"], device)
    log(f"[timing] ssd_scan {SSD_JAMBA} bf16 (jamba's SSD layers): kernel {jamba['ms']:.3f} ms "
        f"({jamba['tflop_s']:.1f} TFLOP/s; with state in and out {jamba['stateful_ms']:.3f} ms), "
        f"plain {jamba['plain_ms']:.3f} ms, library null, bound {jamba['bound_ms']:.4f} ms "
        f"({jamba['bound_by']})")
    if only == "zoo":
        return {"flash_attention": dict(out["dh160"], dh160=out["dh160"]),
                "ssd_scan": dict(jamba, jamba=jamba)}
    # The f32 arithmetic (CUDA cores, the f32 control runs) at the prefill shape.
    b, h, hkv, sq, sk, dh, causal, _ = ATTN_MAIN
    q, k, v = attn_inputs(torch, b, h, hkv, sq, sk, dh, torch.float32, seed=2, device=device)
    out["f32"] = t = {"ms": device_ms(torch, lambda: fa.flash_attention_cuda(q, k, v,
                                                                               causal=causal)),
                      "library_ms": device_ms(torch, lambda: F.scaled_dot_product_attention(
                          q, k, v, is_causal=causal))}
    log(f"[timing] flash_attention {ATTN_MAIN} f32: kernel {t['ms']:.3f} ms, "
        f"scaled_dot_product_attention {t['library_ms']:.3f} ms")
    del q, k, v
    k9 = dict(out["main"], max_abs_err=worst["flash_attention"], at_32k=out["32k"],
              f32=out["f32"], dh160=out["dh160"], **encdec_out)

    k10 = ssd_timing(torch, peaks, SSD_MAIN, worst["ssd_scan"], device)
    log(f"[timing] ssd_scan {SSD_MAIN} bf16: kernel {k10['ms']:.3f} ms ({k10['tflop_s']:.1f} "
        f"TFLOP/s; with state in and out {k10['stateful_ms']:.3f} ms; the previous design "
        f"{PREVIOUS_MS['ssd_scan main']} ms), plain "
        f"{k10['plain_ms']:.3f} ms, library null (no PyTorch call computes the scan), bound "
        f"{k10['bound_ms']:.4f} ms ({k10['bound_by']})")
    k10["jamba"] = jamba
    return {"flash_attention": k9, "ssd_scan": k10}


def phase_lm(torch, peaks, report, device="cuda", only=None):
    """check-lm, main-lm-attn, main-lm-ssm, main-lm-moe, main-lm-encdec and
    the timing of K9 and K10 (``only="zoo"``: check-lm at ATTN_160_CHECK and
    SSD_JAMBA, main-lm-moe and their timing alone; ``only="encdec"``: at
    ATTN_ENCDEC_CHECK, main-lm-encdec and its timing).  Each main path runs
    with the counters set to 0 just before it and read just after; its
    kernel must have launched and no plain version may have run on the
    card.  Returns (K9/K10 kernel entries, launches per path)."""
    if only == "zoo":
        worst = phase_check_lm(torch, device, ATTN_160_CHECK, (SSD_JAMBA,), strided=False)
    elif only == "encdec":
        worst = phase_check_lm(torch, device, ATTN_ENCDEC_CHECK, (), strided=False)
    else:
        worst = phase_check_lm(torch, device)
    report["check_lm"] = worst
    launches = {}
    keys = {None: tuple(LM_PATHS), "zoo": ("main-lm-moe",), "encdec": ("main-lm-encdec",)}[only]
    for key in keys:
        report[key], launches[key] = phase_main_lm(torch, key, device)
        if not all(launches[key][k] for k in LM_PATH_KERNELS[key]):
            raise AssertionError(f"[{key}] a kernel never launched: {launches[key]}")
        if any(report[key]["plain_on_cuda"].values()):
            raise AssertionError(f"[{key}] plain versions ran on the card: "
                                 f"{report[key]['plain_on_cuda']}")
    return phase_timing_lm(torch, peaks, worst, device, only=only), launches


def _rel_err(torch, got, want):
    """Max abs error over the plain version's max abs."""
    return float((got.float() - want.float()).abs().max() / want.float().abs().max())


def grad_inputs(torch, case, dtype, seed, device="cuda"):
    """q, k, v and an output cotangent and input tangents for ``case``."""
    b, h, hkv, sq, sk, dh, _ = case
    g = torch.Generator(device=device).manual_seed(seed)
    shapes = ((b, h, sq, dh), (b, hkv, sk, dh), (b, hkv, sk, dh), (b, h, sq, dh),
              (b, h, sq, dh), (b, hkv, sk, dh), (b, hkv, sk, dh))
    return tuple(torch.randn(*s, generator=g, device=device).to(dtype) for s in shapes)


def check_ssd_grad(torch, peaks, device="cuda", cases=SSD_CHECK + (SSD_TRAIN,),
                   timed=(SSD_TRAIN, SSD_JAMBA)):
    """K10's training forward, backward and forward-mode arms against their
    plain versions on the card at SSD_CHECK's cases and at mamba2-1.3b's
    training shape (SSD_TRAIN), f32 and bf16, without and with a state in
    and out: GRAD_BAR of each output's plain max abs (the f32 outputs, dt's
    and a's gradients and the states', at the f32 bar), the training
    forward's y bit for bit the serving arm's, each arm twice bit for bit;
    then timed at each shape of ``timed`` (SSD_TRAIN and jamba's SSD_JAMBA)
    in bf16 beside the plain versions and the bound (no PyTorch call
    computes the scan's derivative).  Returns the bwd and jvp arms' kernel
    entries at ``timed[0]``, each with the others' under their shapes, and
    the training forward's times (``fwd_ms``, ``fwd_ms_at``)."""
    from repro_torch.kernels import ssd_scan as ss

    worst = {case: {"bwd": 0.0, "jvp": 0.0} for case in timed}
    checks = [(c, d, st) for c in cases
              for d in (torch.float32, torch.bfloat16) for st in (False, True)]
    for case, dtype, state in checks:
        dname = str(dtype).split(".")[-1]
        b, l, h, p, g, n, c = case
        x, dt, a, bm, cm, _, h0 = ssd_inputs(torch, b, l, h, p, g, n, dtype, seed=sum(case),
                                             device=device)
        gen = torch.Generator(device=device).manual_seed(sum(case) + 1)
        rnd = lambda *shape: torch.randn(*shape, generator=gen, device=device)  # noqa: E731
        dy, tx = rnd(b, l, h, p).to(dtype), rnd(b, l, h, p).to(dtype)
        tb, tc = rnd(b, l, g, n).to(dtype), rnd(b, l, g, n).to(dtype)
        tdt, ta = 0.1 * rnd(b, l, h), 0.1 * rnd(h)
        h0 = h0 if state else None
        dh, th0 = (rnd(b, h, p, n), rnd(b, h, p, n)) if state else (None, None)
        y, h1, hs, cs = ss.ssd_scan_fwd_cuda(x, dt, a, bm, cm, h0, chunk=c)
        _, _, hs_p, cs_p = ss.ssd_fwd_plain(x, dt, a, bm, cm, h0, chunk=c)
        grads = ss.ssd_scan_bwd_cuda(dy, x, dt, a, bm, cm, h0, hs_p, cs_p, dh, chunk=c)
        grads_p = ss.ssd_bwd_plain(dy, x, dt, a, bm, cm, h0, hs_p, cs_p, dh, chunk=c)
        tang = ss.ssd_scan_jvp_cuda(x, dt, a, bm, cm, h0, hs_p, cs_p, tx, tdt, ta, tb, tc, th0,
                                    chunk=c)
        tang_p = ss.ssd_jvp_plain(x, dt, a, bm, cm, h0, hs_p, cs_p, tx, tdt, ta, tb, tc, th0,
                                  chunk=c)
        _sync(torch, device)
        what = f"[check-lm-grad] ssd_scan {case} {dname} state={state}"
        names = ("dx", "ddt", "da", "dB", "dC", "dh0", "ty", "th")
        errs = {k: _rel_err(torch, u, w) for k, u, w in zip(names, (*grads, *tang),
                                                             (*grads_p, *tang_p))}
        errs["H"] = _rel_err(torch, hs, hs_p)
        bars = {k: GRAD_BAR[dname if k in ("dx", "dB", "dC", "ty") else "float32"] for k in errs}
        bad = [k for k, e in errs.items() if not e <= bars[k]]
        if bad or not all(bool(torch.isfinite(t).all()) for t in (*grads, *tang)):
            raise AssertionError(f"{what}: past the bars {bars}: {errs}")
        same = (torch.equal(y, ss.ssd_scan_cuda(x, dt, a, bm, cm, chunk=c, initial_state=h0))
                and all(torch.equal(u, w) for u, w in zip(grads, ss.ssd_scan_bwd_cuda(
                    dy, x, dt, a, bm, cm, h0, hs_p, cs_p, dh, chunk=c)))
                and all(torch.equal(u, w) for u, w in zip(tang, ss.ssd_scan_jvp_cuda(
                    x, dt, a, bm, cm, h0, hs_p, cs_p, tx, tdt, ta, tb, tc, th0, chunk=c))))
        if not same:
            raise AssertionError(f"{what}: two launches differ, or the training forward's y is "
                                 "not the serving arm's")
        log(f"{what}: errors / plain max abs " + ", ".join(f"{k} {e:.2e}" for k, e in errs.items())
            + f" (bar {GRAD_BAR[dname]:g} on dx, dB, dC, ty; {GRAD_BAR['float32']:g} on the f32 "
            "outputs); y bit for bit the serving arm's, two launches of each arm bitwise equal")
        if case in worst and dtype == torch.bfloat16:
            w = worst[case]
            w["bwd"] = max(w["bwd"], max(float((u - v).float().abs().max())
                                         for u, v in zip(grads, grads_p)))
            w["jvp"] = max(w["jvp"], max(float((u - v).float().abs().max())
                                         for u, v in zip(tang, tang_p)))
        del x, dt, a, bm, cm, dy, tx, tb, tc, y, h1, hs, cs, hs_p, cs_p, grads, grads_p
        del tang, tang_p

    entries = {"bwd": {}, "jvp": {}, "fwd_ms_at": {}}
    for case in timed:
        timing = ssd_grad_timing(torch, peaks, case, worst[case], device)
        entries["fwd_ms_at"][str(case)] = timing.pop("fwd_ms")
        for arm, e in timing.items():
            if case == timed[0]:
                entries[arm].update(e)
            entries[arm][str(case)] = e
    entries["fwd_ms"] = entries["fwd_ms_at"][str(timed[0])]
    return entries


def ssd_grad_timing(torch, peaks, case, worst, device="cuda"):
    """K10's bwd and jvp arms (and the training forward) at ``case``, bf16,
    no state (the training path): kernel, plain version and bound."""
    from repro_torch.kernels import ssd_scan as ss

    b, l, h, p, g, n, c = case
    x, dt, a, bm, cm, _, _ = ssd_inputs(torch, b, l, h, p, g, n, torch.bfloat16, seed=2,
                                        device=device)
    gen = torch.Generator(device=device).manual_seed(3)
    rnd = lambda *shape: torch.randn(*shape, generator=gen, device=device)  # noqa: E731
    dy, tx = rnd(b, l, h, p).to(torch.bfloat16), rnd(b, l, h, p).to(torch.bfloat16)
    tb, tc = rnd(b, l, g, n).to(torch.bfloat16), rnd(b, l, g, n).to(torch.bfloat16)
    tdt, ta = 0.1 * rnd(b, l, h), 0.1 * rnd(h)
    _, _, hs, cs = ss.ssd_scan_fwd_cuda(x, dt, a, bm, cm, chunk=c)
    calls = {
        "bwd": (lambda: ss.ssd_scan_bwd_cuda(dy, x, dt, a, bm, cm, None, hs, cs, chunk=c),
                lambda: ss.ssd_bwd_plain(dy, x, dt, a, bm, cm, None, hs, cs, chunk=c)),
        "jvp": (lambda: ss.ssd_scan_jvp_cuda(x, dt, a, bm, cm, None, hs, cs, tx, tdt, ta, tb, tc,
                                             chunk=c),
                lambda: ss.ssd_jvp_plain(x, dt, a, bm, cm, None, hs, cs, tx, tdt, ta, tb, tc,
                                         chunk=c)),
    }
    entries = {}
    fwd_ms = device_ms(torch, lambda: ss.ssd_scan_fwd_cuda(x, dt, a, bm, cm, chunk=c))
    for arm, (kernel, plain) in calls.items():
        nbytes, ops = ssd_grad_work(b, l, h, p, g, n, c, 2, arm)
        t_bytes, t_ops = nbytes / peaks["bytes"], ops / peaks["bfloat16_tensor"]
        e = entries[arm] = {
            "shape": case, "max_abs_err": worst[arm], "ms": device_ms(torch, kernel),
            "plain_ms": device_ms(torch, plain, 5), "library_ms": None,
            "bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "gflop": ops / 1e9, "fp32_simt_bound_ms": 1e3 * ops / peaks["float32"],
        }
        e["tflop_s"] = ops / e["ms"] / 1e9
        prev = (f"previous design {PREVIOUS_MS[f'ssd_scan:{arm}']} ms; " if case == SSD_TRAIN
                else "")
        log(f"[timing] ssd_scan:{arm} {case} bf16: kernel {e['ms']:.3f} ms ({prev}"
            f"{e['tflop_s']:.1f} TFLOP/s, {e['gflop']:.1f} GFLOP; the f32 CUDA-core rate's bound "
            f"{e['fp32_simt_bound_ms']:.3f} ms), plain {e['plain_ms']:.3f} ms, library null (no "
            f"PyTorch call computes the scan's derivative), bound {e['bound_ms']:.4f} ms "
            f"({e['bound_by']}); training forward {fwd_ms:.3f} ms")
    entries["fwd_ms"] = fwd_ms
    return entries


def _sass_name(symbol):
    """``attn_bwd_dkdv_tc<64>``-style name of a mangled kernel symbol of
    ``namespace grad`` (``<bf16, 64>`` / ``<f32, 64>`` for the typed ones),
    or None for any other symbol."""
    m = re.search(r"4grad(\d+)(?=attn_)", symbol)
    if m is None:
        return None
    name = symbol[m.end():m.end() + int(m.group(1))]
    rest = symbol[m.end() + int(m.group(1)):]
    dh = re.search(r"Li(\d+)E", rest).group(1)
    dtype = "bf16, " if "__nv_bfloat16" in rest[:24] else "f32, " if rest.startswith("If") else ""
    return f"{name}<{dtype}{dh}>"


def _sass_report(build, source, name, label):
    """HMMA instructions and atomics (ATOM / RED of any width) per kernel
    of ``csrc/<source>.cu`` in the built SASS, and registers, stack (spill)
    and local bytes (``cuobjdump -res-usage``), for the kernels ``name``
    maps a mangled symbol to (None for the others); logged as ``label``."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    lib = str(build.library_path(source))
    sass = subprocess.run([tool, "-sass", lib], capture_output=True, text=True, timeout=300,
                          check=True).stdout
    res = subprocess.run([tool, "-res-usage", lib], capture_output=True, text=True,
                         timeout=300, check=True).stdout
    kernels, fn = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = name(m.group(1))
            if fn:
                kernels[fn] = {"HMMA": 0, "atomics": 0}
            continue
        if fn and re.search(r"\bHMMA\b", line):
            kernels[fn]["HMMA"] += 1
        if fn and re.search(r"\b(ATOM|ATOMS|ATOMG|RED|REDG)\.", line):
            kernels[fn]["atomics"] += 1
    fn = None
    for line in res.splitlines():
        m = re.search(r"Function (\S+):", line)
        if m:
            fn = name(m.group(1))
            continue
        m = re.search(r"REG:(\d+) STACK:(\d+).*LOCAL:(\d+)", line)
        if fn in kernels and m:
            kernels[fn].update(registers=int(m.group(1)), stack_bytes=int(m.group(2)),
                               local_bytes=int(m.group(3)))
    log(f"[build] {label} SASS: " + "; ".join(
        f"{k} HMMA {v['HMMA']}, atomics {v['atomics']}, registers {v.get('registers')}, "
        f"stack {v.get('stack_bytes')} B, local {v.get('local_bytes')} B"
        for k, v in sorted(kernels.items())))
    return kernels


def grad_sass(build):
    """K9's differentiated kernels in the built SASS of
    ``csrc/flash_attention.cu`` (:func:`_sass_report`).  Raises unless
    every bf16 tensor-core kernel (``*_tc``) runs HMMA and no kernel of
    ``namespace grad`` has an atomic."""
    kernels = _sass_report(build, "flash_attention", _sass_name,
                           "flash_attention namespace grad")
    tc = [k for k in kernels if "_tc<" in k]
    # three tensor-core kernels (dkdv, dq, jvp) at each of the five head
    # dims 16, 32, 64, 128, 160
    if len(tc) != 15 or any(kernels[k]["HMMA"] == 0 for k in tc):
        raise AssertionError(f"[build] the bf16 grad kernels must run HMMA: {kernels}")
    if any(v["atomics"] for v in kernels.values()):
        raise AssertionError(f"[build] an atomic in namespace grad: {kernels}")
    return kernels


def ssd_grad_sass(build):
    """K10's differentiated kernels (``namespace grad`` of
    ``csrc/ssd_scan.cu``) in the built SASS (:func:`_sass_report`).
    Raises unless all fifteen are there (the f32 arms' nine CUDA-core
    kernels, the shared backward state pass, and bf16's four tensor-core
    kernels and its reduction), every tensor-core kernel (``*_tc``) runs
    HMMA and none has an atomic (their sums run in a fixed order)."""
    def name(symbol):  # "ssd_bwd_dx<f32>" / "ssd_bwd_chunk_tc" from the mangled name, or None
        m = re.search(r"4grad(\d+)(?=ssd_)", symbol)
        if m is None:
            return None
        end = m.end() + int(m.group(1))
        rest = symbol[end:end + 24]
        dtype = "<bf16>" if "__nv_bfloat16" in rest else "<f32>" if rest.startswith("If") else ""
        return symbol[m.end():end] + dtype

    kernels = _sass_report(build, "ssd_scan", name, "ssd_scan namespace grad")
    tc = [k for k in kernels if k.endswith("_tc")]
    if len(kernels) != 15 or len(tc) != 4 or any(kernels[k]["HMMA"] == 0 for k in tc):
        raise AssertionError(f"[build] K10's grad kernels missing, or a tensor-core one without "
                             f"HMMA: {kernels}")
    if any(v["atomics"] for v in kernels.values()):
        raise AssertionError(f"[build] an atomic in K10's namespace grad: {kernels}")
    return kernels


def phase_check_lm_grad(torch, peaks, device="cuda", cases=GRAD_CHECK,
                        timed=(ATTN_TRAIN, ATTN_160[:7], ATTN_ENC_TRAIN)):
    """K9's forward-with-lse, backward and forward-mode arms against their
    plain versions on the card at ``cases`` (and qwen1.5-0.5b's training
    shape and the Hessian-free LM's when ``cases`` is GRAD_CHECK; the lse
    arm's output bit for bit the serving arm's; each arm twice, bit for
    bit), then timed at each shape of ``timed`` in bf16 beside the plain
    versions, the library call (SDPA's forward for lse, its backward for
    bwd, none for jvp) and the bound.  Returns the three arms' kernel
    entries at ``timed[0]``, each with the others' under their shapes."""
    from repro_torch.kernels import flash_attention as fa

    worst = {case: {"lse": 0.0, "bwd": 0.0, "jvp": 0.0} for case in timed}
    checks = [(c, d) for c in cases for d in (torch.float32, torch.bfloat16)]
    if cases is GRAD_CHECK:
        checks += [(ATTN_TRAIN, torch.bfloat16), (ATTN_HF, torch.float32)]
    for case, dtype in checks:
        dname = str(dtype).split(".")[-1]
        bar = GRAD_BAR[dname]
        causal = case[-1]
        q, k, v, dout, tq, tk, tv = grad_inputs(torch, case, dtype, seed=sum(case[:6]),
                                                device=device)
        out, lse = fa.flash_attention_lse_cuda(q, k, v, causal=causal)
        out_p, lse_p = fa.flash_attention_lse_plain(q, k, v, causal=causal)
        grads = fa.flash_attention_bwd_cuda(dout, q, k, v, out_p, lse_p, causal=causal)
        grads_p = fa.flash_attention_bwd_plain(dout, q, k, v, out_p, lse_p, causal=causal)
        tout = fa.flash_attention_jvp_cuda(q, k, v, out_p, lse_p, tq, tk, tv, causal=causal)
        tout_p = fa.flash_attention_jvp_plain(q, k, v, out_p, lse_p, tq, tk, tv, causal=causal)
        _sync(torch, device)
        what = f"[check-lm-grad] flash_attention {case} {dname}"
        errs = {"out": _rel_err(torch, out, out_p), "lse": _rel_err(torch, lse, lse_p),
                "dq": _rel_err(torch, grads[0], grads_p[0]),
                "dk": _rel_err(torch, grads[1], grads_p[1]),
                "dv": _rel_err(torch, grads[2], grads_p[2]), "jvp": _rel_err(torch, tout, tout_p)}
        bars = dict.fromkeys(errs, bar, ) | {"lse": GRAD_BAR["float32"]}
        bad = [key for key, e in errs.items() if not e <= bars[key]]
        if bad or not all(bool(torch.isfinite(t).all()) for t in (*grads, tout, lse)):
            raise AssertionError(f"{what}: past the bars {bars}: {errs}")
        same = (torch.equal(out, fa.flash_attention_cuda(q, k, v, causal=causal))
                and torch.equal(lse, fa.flash_attention_lse_cuda(q, k, v, causal=causal)[1])
                and all(torch.equal(a, b) for a, b in zip(grads, fa.flash_attention_bwd_cuda(
                    dout, q, k, v, out_p, lse_p, causal=causal)))
                and torch.equal(tout, fa.flash_attention_jvp_cuda(q, k, v, out_p, lse_p, tq, tk,
                                                                  tv, causal=causal)))
        if not same:
            raise AssertionError(f"{what}: two launches differ, or the lse arm's output is not "
                                 "the serving arm's")
        log(f"{what}: errors / plain max abs " + ", ".join(f"{k} {e:.2e}" for k, e in errs.items())
            + f" (bar {bar:g}, lse {GRAD_BAR['float32']:g}); serving arm's output bit for bit, "
            "two launches of each arm bitwise equal")
        if case in worst and dtype == torch.bfloat16:
            w = worst[case]
            w["lse"] = float((lse - lse_p).abs().max())
            w["bwd"] = max(float((g - w_).float().abs().max()) for g, w_ in zip(grads, grads_p))
            w["jvp"] = float((tout - tout_p).float().abs().max())
        del q, k, v, dout, tq, tk, tv, out, lse, out_p, lse_p, grads, grads_p, tout, tout_p

    entries = {arm: {} for arm in ("lse", "bwd", "jvp")}
    for case in timed:
        for arm, e in attn_grad_timing(torch, peaks, case, worst[case], device).items():
            if case == timed[0]:
                entries[arm].update(e)
            entries[arm][str(case)] = e
    return entries


def attn_grad_timing(torch, peaks, case, worst, device="cuda"):
    """K9's lse, bwd and jvp arms at ``case`` in bf16: kernel, plain
    version, SDPA (GQA through ``enable_gqa``; none for jvp) and bound."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa

    b, h, hkv, sq, sk, dh, causal = case
    q, k, v, dout, tq, tk, tv = grad_inputs(torch, case, torch.bfloat16, seed=2, device=device)
    out, lse = fa.flash_attention_lse_cuda(q, k, v, causal=causal)
    qr, kr, vr = (t.detach().requires_grad_(True) for t in (q, k, v))

    def sdpa_fwd():
        return F.scaled_dot_product_attention(qr, kr, vr, is_causal=causal, enable_gqa=h != hkv)

    def sdpa_fwd_bwd():
        return torch.autograd.grad(sdpa_fwd(), (qr, kr, vr), dout)

    sdpa_f = device_ms(torch, sdpa_fwd)
    calls = {
        "lse": (lambda: fa.flash_attention_lse_cuda(q, k, v, causal=causal),
                lambda: fa.flash_attention_lse_plain(q, k, v, causal=causal), sdpa_f),
        "bwd": (lambda: fa.flash_attention_bwd_cuda(dout, q, k, v, out, lse, causal=causal),
                lambda: fa.flash_attention_bwd_plain(dout, q, k, v, out, lse, causal=causal),
                device_ms(torch, sdpa_fwd_bwd) - sdpa_f),
        "jvp": (lambda: fa.flash_attention_jvp_cuda(q, k, v, out, lse, tq, tk, tv, causal=causal),
                lambda: fa.flash_attention_jvp_plain(q, k, v, out, lse, tq, tk, tv,
                                                     causal=causal), None),
    }
    entries = {}
    for arm, (kernel, plain, library) in calls.items():
        nbytes, ops = grad_work(b, h, hkv, sq, sk, dh, causal, 2, arm)
        t_bytes, t_ops = nbytes / peaks["bytes"], ops / peaks["bfloat16_tensor"]
        e = entries[arm] = {
            "shape": case, "max_abs_err": worst[arm], "ms": device_ms(torch, kernel),
            "plain_ms": device_ms(torch, plain, 5), "library_ms": library,
            "bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        }
        e["tflop_s"] = ops / e["ms"] / 1e9
        lib = "null (no PyTorch call computes the tangent)" if library is None else (
            f"{library:.3f} ms (scaled_dot_product_attention's "
            f"{'forward' if arm == 'lse' else 'backward, its forward subtracted'})")
        previous = PREVIOUS_MS.get(f"flash_attention:{arm}") if case == ATTN_TRAIN else None
        prev = "" if previous is None else f", previous design {previous} ms"
        log(f"[timing] flash_attention:{arm} {case} bf16: kernel {e['ms']:.3f} ms "
            f"({e['tflop_s']:.1f} TFLOP/s{prev}), plain {e['plain_ms']:.3f} ms, library {lib}, bound "
            f"{e['bound_ms']:.4f} ms ({e['bound_by']})")
    return entries


def lm_hf_functions(torch, cfg, backend):
    """``(model_fn, loss_fn)`` of examples/hessian_free_lm.py over the port:
    the LM's logits ``hidden @ lm_head_weights`` run on a parameter dict
    through ``torch.func.functional_call``, and the example's mean
    cross-entropy."""
    from repro_torch import models
    from repro_torch.models.layers import lm_head_weights

    skeleton = models.transformer.Model(None, cfg, "meta")

    def logits(model, batch):
        hidden, _ = models.forward_hidden(model, batch, cfg, backend=backend)
        return hidden @ lm_head_weights(model.embed, cfg)

    def model_fn(p, batch):
        return torch.func.functional_call(skeleton, p, (logits, batch))

    def loss_fn(lg, batch):
        labels = batch["labels"]
        lse = torch.logsumexp(lg, dim=-1)
        return torch.mean(lse - lg.gather(-1, labels[..., None])[..., 0])

    return model_fn, loss_fn


def hf_lm_run(torch, cfg, params, steps, recycle, backend, device, tag):
    """The example's loop: ``steps`` Hessian-free steps from ``params``;
    per step the loss, CG iterations, damping, accept and seconds."""
    from repro_torch.convert import train_batch_from_numpy
    from repro_torch.data import TokenPipeline
    from repro_torch.optim import HFConfig, hf_init, hf_step, softmax_xent_hvp

    model_fn, loss_fn = lm_hf_functions(torch, cfg, backend)
    hcfg = HFConfig(**HF_LM["settings"], recycle=recycle)
    state = hf_init(params, hcfg, torch.Generator(device=device).manual_seed(1))
    pipe = TokenPipeline(vocab_size=cfg.vocab_size, batch=HF_LM["batch"], seq_len=HF_LM["seq"])
    rows = []
    for i in range(steps):
        batch = train_batch_from_numpy(pipe.make_batch(i), device=device)
        (params, state, m), sec = _timed(torch, device, lambda: hf_step(
            params, state, batch, model_fn=model_fn, loss_fn=loss_fn,
            loss_hvp=softmax_xent_hvp, cfg=hcfg))
        rows.append({"loss": float(m["loss"]), "cg_iters": int(m["cg_iterations"]),
                     "damping": float(m["damping"]), "accepted": bool(m["accepted"]), "s": sec})
        log(f"{tag} step {i:3d} loss {rows[-1]['loss']:.4f} cg_iters {rows[-1]['cg_iters']:3d} "
            f"damping {rows[-1]['damping']:.2e} accepted {rows[-1]['accepted']} "
            f"({1e3 * sec:.0f} ms)")
    return rows, params, state


def phase_hf_lm(torch, device="cuda"):
    """examples/hessian_free_lm.py on the port: its first HF_LM["steps"] steps, recycled and
    cold, through the kernels (K9's lse, backward and forward-mode arms
    inside the GGN products; K1, K2, K4, K5 inside def-CG), held against
    the same runs with ``backend="plain"`` on the card (iterations within
    one a step, ROADMAP P1; loss to 1e-4); then one step at qwen1.5-0.5b's
    full widths, depth cut to ``HF_LM["full_layers"]``.  Returns (report,
    launches and arms of the kernel runs)."""
    from repro_torch import models
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.convert import train_batch_from_numpy
    from repro_torch.data import TokenPipeline
    from repro_torch.kernels import _runtime
    from repro_torch.launch import params_dict
    from repro_torch.optim import HFConfig, hf_init, hf_step, softmax_xent_hvp

    cfg = get_smoke_config(HF_LM["arch"])
    params = params_dict(models.init(torch.Generator(device=device).manual_seed(0), cfg,
                                     device=device))
    report = {"arch": cfg.name, "batch": HF_LM["batch"], "seq": HF_LM["seq"],
              "settings": HF_LM["settings"]}
    _zero_counts()
    for mode, recycle in (("recycled", True), ("cold", False)):
        report[mode] = {"card": hf_lm_run(torch, cfg, params, HF_LM["steps"], recycle, "auto",
                                          device, f"[hf-lm {mode}]")[0]}
    launches, arms = dict(_runtime.LAUNCHES), _arms()
    plain_on_cuda = dict(_runtime.PLAIN_ON_CUDA)
    for mode, recycle in (("recycled", True), ("cold", False)):
        plain = hf_lm_run(torch, cfg, params, HF_LM["steps"], recycle, "plain", device,
                          f"[hf-lm {mode} plain]")[0]
        card = report[mode]["card"]
        report[mode]["plain"] = plain
        for i, (c, p) in enumerate(zip(card, plain)):
            if abs(c["cg_iters"] - p["cg_iters"]) > 1 or abs(c["loss"] - p["loss"]) > 1e-4 * abs(
                    p["loss"]):
                raise AssertionError(f"[hf-lm {mode}] step {i}: card {c} vs plain {p}")
        report[mode]["total_cg_iters"] = sum(r["cg_iters"] for r in card)
        report[mode]["s_per_step"] = statistics.median(r["s"] for r in card[1:])
    # One more recycled step under the profiler, counted apart: the device
    # work against the host's (linearize traces the model every step).
    model_fn, loss_fn = lm_hf_functions(torch, cfg, "auto")
    hcfg = HFConfig(**HF_LM["settings"])
    state = hf_init(params, hcfg, torch.Generator(device=device).manual_seed(1))
    batch = train_batch_from_numpy(TokenPipeline(cfg.vocab_size, HF_LM["batch"], HF_LM["seq"])
                                   .make_batch(0), device=device)
    prof = report["profile_recycled_step"] = profile_serving(torch, lambda: hf_step(
        params, state, batch, model_fn=model_fn, loss_fn=loss_fn, loss_hvp=softmax_xent_hvp,
        cfg=hcfg), "attn", device)
    log(f"[hf-lm] profile of one recycled step: device {prof['device_ms']:.1f} ms in "
        f"{prof['wall_ms_profiled']:.1f} ms wall, {prof['launches']} device launches, K9 "
        f"{prof['kernel_ms']:.2f} ms")
    rec, cold = report["recycled"]["total_cg_iters"], report["cold"]["total_cg_iters"]
    log(f"[hf-lm] CG iterations over {HF_LM['steps']} steps: recycled def-CG {rec}, cold CG "
        f"{cold} ({1 - rec / cold:.1%} fewer); card against plain: every step within one "
        f"iteration and 1e-4 in loss; median s a step {report['recycled']['s_per_step']:.3f} / "
        f"{report['cold']['s_per_step']:.3f}")

    # One step at full widths, depth cut so that the solver's vectors fit.
    full = dataclasses.replace(get_config(HF_LM["arch"]), n_layers=HF_LM["full_layers"])
    torch.cuda.reset_peak_memory_stats()
    fparams = params_dict(models.init(torch.Generator(device=device).manual_seed(0), full,
                                      device=device))
    n = sum(t.numel() for t in fparams.values())
    k, ell = HF_LM["settings"]["k"], HF_LM["settings"]["ell"]
    # Parameter-sized f32 vectors live at the extraction, the step's peak:
    # parameters, their flat copies (step, operator), gradients (tree and
    # flat), b, x0, the previous step (8 with x); W, AW (2k); the window P,
    # AP (2ell); the stack [W, P; AW, AP] (2(k + ell)); K5's [W'; AW'] and
    # their rescaled copies (4k); r, p, Ap (3).
    vectors = 11 + 8 * k + 4 * ell
    full_n = get_config(HF_LM["arch"]).total_params()
    rows, _, _ = hf_lm_run(torch, full, fparams, 1, True, "auto", device,
                           f"[hf-lm full width, {HF_LM['full_layers']} layers]")
    peak = torch.cuda.max_memory_allocated() / 1e9
    report["full_width"] = {
        "layers": HF_LM["full_layers"], "params": n, "step": rows[0], "peak_memory_gb": peak,
        "reckoned_vectors": vectors, "gb_per_vector": 4 * n / 1e9,
        "reckoned_gb": vectors * 4 * n / 1e9, "full_depth_params": full_n,
        "full_depth_reckoned_gb": vectors * 4 * full_n / 1e9,
    }
    fw = report["full_width"]
    log(f"[hf-lm full width] {full.name} d {full.d_model}, vocab {full.vocab_size}, "
        f"{full.dtype} compute, f32 vectors; depth cut 24 -> {fw['layers']} layers: n = {n} "
        f"parameters, {fw['gb_per_vector']:.2f} GB a vector; reckoned {vectors} vectors x "
        f"{fw['gb_per_vector']:.2f} GB = {fw['reckoned_gb']:.1f} GB (at 24 layers "
        f"{fw['full_depth_reckoned_gb']:.1f} GB, past the card's 80); measured peak "
        f"{peak:.1f} GB; one step {rows[0]['s']:.2f} s, {rows[0]['cg_iters']} CG iterations")
    del fparams
    torch.cuda.empty_cache()
    report.update(launches=launches, arms=arms, plain_on_cuda=plain_on_cuda)
    return report


def phase_hf_lm_ssm(torch, device="cuda"):
    """examples/hessian_free_lm.py's loop on mamba2's SMOKE model (f32):
    ``HF_LM_SSM["steps"]`` recycled Hessian-free steps through the kernels
    (K10's training forward and backward in the gradients, its tangent map
    in ``linearize``; K1, K2, K4, K5 in def-CG) against the same steps with
    ``backend="plain"`` on the card: iterations within one a step, loss to
    1e-4.  Returns the report with the kernel run's launches and arms."""
    from repro_torch import models
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels import _runtime
    from repro_torch.launch import params_dict

    cfg = get_smoke_config(HF_LM_SSM["arch"])
    params = params_dict(models.init(torch.Generator(device=device).manual_seed(0), cfg,
                                     device=device))
    steps = HF_LM_SSM["steps"]
    _zero_counts()
    card = hf_lm_run(torch, cfg, params, steps, True, "auto", device, "[hf-lm mamba2]")[0]
    launches, arms = dict(_runtime.LAUNCHES), _arms()
    plain_on_cuda = dict(_runtime.PLAIN_ON_CUDA)
    plain = hf_lm_run(torch, cfg, params, steps, True, "plain", device,
                      "[hf-lm mamba2 plain]")[0]
    for i, (c, p) in enumerate(zip(card, plain)):
        if abs(c["cg_iters"] - p["cg_iters"]) > 1 or abs(c["loss"] - p["loss"]) > 1e-4 * abs(
                p["loss"]):
            raise AssertionError(f"[hf-lm mamba2] step {i}: card {c} vs plain {p}")
    log(f"[hf-lm mamba2] {cfg.name}: {steps} recycled steps, CG iterations "
        f"{[r['cg_iters'] for r in card]} (plain {[r['cg_iters'] for r in plain]}), losses "
        f"within 1e-4; s a step {[round(r['s'], 3) for r in card]}")
    return {"arch": cfg.name, "steps": steps, "card": card, "plain": plain,
            "launches": launches, "arms": arms, "plain_on_cuda": plain_on_cuda}


def _leaf_rel(torch, got, want):
    """Each leaf's ‖got − want‖ / ‖want‖."""
    return {name: float(torch.linalg.vector_norm((got[name] - want[name]).float())
                        / torch.linalg.vector_norm(want[name].float())) for name in want}


def f32_control(torch, cfg, params, batch, spec, tag):
    """The same step's loss and gradients at full width in f32 compute,
    depth cut to ``spec["f32_control_layers"]`` (f32 activations of every
    layer would not fit beside the bf16 run's state; an encoder–decoder's
    decoder is cut, its encoder kept whole), through the kernels
    against the plain versions: loss 1e-2, each leaf 5e-2 in relative norm
    (it is ≈ 1e-5: summation order alone)."""
    from repro_torch.launch import loss_and_grads

    layers = spec["f32_control_layers"]
    ccfg = dataclasses.replace(cfg, dtype="float32", n_layers=layers)
    keep = {name: t for name, t in params.items()
            if not name.startswith("blocks.") or int(name.split(".")[1]) < layers}
    loss_c, _, grads_c = loss_and_grads(ccfg, keep, batch)
    loss_p, _, grads_p = loss_and_grads(ccfg, keep, batch, backend="plain")
    rel = _leaf_rel(torch, grads_c, grads_p)
    loss_rel = abs(float(loss_c) - float(loss_p)) / abs(float(loss_p))
    worst = max(rel, key=rel.get)
    log(f"{tag} (i) f32 control, {layers} layers at full width: loss rel {loss_rel:.2e}; "
        f"gradients: worst leaf {worst} at {rel[worst]:.2e} in relative norm (bar 5e-2), median "
        f"{statistics.median(rel.values()):.2e}")
    if not (loss_rel <= 1e-2 and rel[worst] <= 5e-2):
        raise AssertionError(f"{tag} (i) f32 control: kernels against plain versions past the "
                             "bars")
    del grads_c, grads_p
    torch.cuda.empty_cache()
    return {"layers": layers, "loss_rel": loss_rel, "grad_rel_norm": rel}


@contextlib.contextmanager
def _plain_attention_block_k(block_k):
    """K9's differentiated plain arms (forward with lse, backward) on key
    blocks of ``block_k`` instead of their default 1 024, for the length
    of the block."""
    from repro_torch.kernels import flash_attention as fa

    saved = fa.flash_attention_lse_plain, fa.flash_attention_bwd_plain
    fa.flash_attention_lse_plain = functools.partial(saved[0], block_k=block_k)
    fa.flash_attention_bwd_plain = functools.partial(saved[1], block_k=block_k)
    try:
        yield
    finally:
        fa.flash_attention_lse_plain, fa.flash_attention_bwd_plain = saved


def _with_source(torch, pipe, batch, frames, d, device):
    """``pipe`` with each step's batch given ``src_embeds``: ``batch`` x
    ``frames`` x ``d`` normal frames on ``device`` from a generator seeded
    with the step (the reference's TokenPipeline makes none)."""

    class Sourced:
        @staticmethod
        def make_batch(step):
            gen = torch.Generator(device=device).manual_seed(step)
            return dict(pipe.make_batch(step), src_embeds=torch.randn(
                batch, frames, d, generator=gen, device=device))

    return Sourced


def phase_train(torch, peaks, spec, device="cuda"):
    """One LM at full width through ``launch.train.build`` and the
    ``Trainer`` (``spec``: ``TRAIN`` or ``TRAIN_SSM``): (i) one step's loss
    and gradients through the kernels against ``backend="plain"`` on the
    card (loss 1e-2 relative, every leaf's gradient 5e-2 in relative norm);
    (ii) ``spec["steps"]`` steps, with checkpoints every ``spec["every"]``
    and, where ``spec["fault_at"]`` names a step, the same again with a
    failure injected there: the replay's final state bit for bit the
    uninterrupted run's (with ``spec["trainer"]`` False, the steps through
    the step function alone); (iii) step time, tokens/s, peak memory, the
    path's kernel arms a step (the backward arm once a layer call, the
    forward arm twice under ``cfg.remat``: forward and recompute; an
    encoder–decoder's attention calls are its encoder's, its decoder's and
    their cross-attention) and MFU.  With ``spec["source"]`` each batch
    also takes ``source`` seeded normal frames a sequence.  Before
    (ii), the same step's gradients again (bit for bit where no fault
    replay follows) and with ``cfg.remat`` off (bit for bit), each with its
    time and peak memory.  A MoE model's
    plain run replays the kernel run's routing
    (``models.moe.replay_routing``) and its steps' aux losses must be
    finite and positive.  Returns the report, with the launches and arms of
    the uninterrupted run."""
    import shutil
    import tempfile

    from repro_torch.configs.registry import ShapeSpec
    from repro_torch.core import pytree as pt
    from repro_torch.kernels import _runtime
    from repro_torch.launch import loss_and_grads, model_flops
    from repro_torch.launch import train as train_lib
    from repro_torch.models import moe
    from repro_torch.runtime import Trainer, TrainerConfig, TrainerEvents

    tag = spec["tag"]
    torch.cuda.reset_peak_memory_stats()
    (cfg, mesh, state0, pipe, step_fn), init_s = _timed(torch, device, lambda: train_lib.build(
        spec["arch"], "full", spec["batch"], spec["seq"], spec["lr"], device,
        n_layers=spec.get("layers")))
    params = state0[0]
    if spec.get("source"):
        pipe = _with_source(torch, pipe, spec["batch"], spec["source"], cfg.d_model, device)
    n_params = sum(t.numel() for t in params.values())
    report = {"arch": cfg.name, "layers": cfg.n_layers, "d_model": cfg.d_model,
              "vocab": cfg.vocab_size, "params": n_params, "batch": spec["batch"],
              "seq": spec["seq"], "init_s": init_s}
    log(f"{tag} {cfg.name}: {cfg.n_layers} layers, d {cfg.d_model}, vocab {cfg.vocab_size}, "
        f"{n_params / 1e6:.1f} M parameters ({cfg.param_dtype}), {cfg.dtype} compute; batch "
        f"{spec['batch']} x {spec['seq']}; mesh {mesh.axes}; built in {init_s:.1f} s")

    # (i) one step's loss and gradients: kernels against plain versions.
    batch = pipe.make_batch(0)
    with moe.record_routing() as routing:
        (loss_c, met_c, grads_c), sec_c = _timed(torch, device,
                                                 lambda: loss_and_grads(cfg, params, batch))
    grad_peak = torch.cuda.max_memory_allocated() / 1e9
    with moe.replay_routing(routing):
        (loss_p, _, grads_p), sec_p = _timed(torch, device, lambda: loss_and_grads(
            cfg, params, batch, backend="plain"))
    if cfg.n_experts:
        layers = sum(kind.startswith("moe") for kind in cfg.ffn_kinds())
        dropped = [int((~r.kept).sum()) for r in routing[:layers]]
        report["routing"] = {"dropped_per_layer": dropped, "aux": float(met_c["aux"])}
        log(f"{tag} (i) aux {float(met_c['aux']):.4f}; the kernel run drops {dropped} of "
            f"{routing[0].kept.numel()} assignments a layer; the plain run replays its routing")
    del routing
    rel = _leaf_rel(torch, grads_c, grads_p)
    loss_rel = abs(float(loss_c) - float(loss_p)) / abs(float(loss_p))
    worst = max(rel, key=rel.get)
    log(f"{tag} (i) loss {float(loss_c):.6f} through the kernels, {float(loss_p):.6f} plain "
        f"(rel {loss_rel:.2e}, bar 1e-2); gradients: worst leaf {worst} at {rel[worst]:.2e} in "
        f"relative norm, median {statistics.median(rel.values()):.2e}; "
        f"{sec_c:.2f} s vs {sec_p:.2f} s plain; peak memory of the step {grad_peak:.1f} GB")
    if "floor_chunk" in spec or "floor_block_k" in spec:
        # bf16 rounding alone moves a deep model's gradients (ROADMAP P7):
        # the plain versions at another chunk length (K10) or key block (K9:
        # another running max, so other bf16 roundings of P) compute the
        # same function in another summation order; the kernels' distance
        # from the plain run is held to that floor's, leaf by leaf.
        if "floor_chunk" in spec:
            floor_what = f"chunk {spec['floor_chunk']} against {cfg.ssm_chunk}"
            floor_cfg = dataclasses.replace(cfg, ssm_chunk=spec["floor_chunk"])
            _, _, grads_f = loss_and_grads(floor_cfg, params, batch, backend="plain")
        else:
            floor_what = f"K9's key block {spec['floor_block_k']} against 1024"
            with _plain_attention_block_k(spec["floor_block_k"]):
                _, _, grads_f = loss_and_grads(cfg, params, batch, backend="plain")
        floor = _leaf_rel(torch, grads_f, grads_p)
        del grads_f
        bars = {name: max(5e-2, 2.0 * floor[name]) for name in rel}
        log(f"{tag} (i) the rounding floor (plain, {floor_what}): worst leaf "
            f"{max(floor, key=floor.get)} at {max(floor.values()):.2e}, median "
            f"{statistics.median(floor.values()):.2e}; bar a leaf max(5e-2, 2 x its floor)")
        report["rounding_floor_rel_norm"] = floor
    else:
        bars = dict.fromkeys(rel, 5e-2)
    bad = sorted(name for name in rel if not rel[name] <= bars[name])
    if not loss_rel <= 1e-2 or bad:
        raise AssertionError(f"{tag} (i) kernels against plain versions past the bars: loss "
                             f"{loss_rel:.2e}, " + ", ".join(f"{k} {rel[k]:.2e} (bar {bars[k]:.2e})"
                                                             for k in bad))
    del grads_p
    if "f32_control_layers" in spec:
        report["f32_control"] = f32_control(torch, cfg, params, batch, spec, tag)
    # Determinism: the same step again, leaf by leaf bit for bit (held
    # where no fault replay follows, which tolerates an order-dependent
    # leaf); then with cfg.remat off, every leaf bit for bit the first
    # gradients (held).  Each is timed, its peak memory taken with the same
    # tensors live (parameters, AdamW state, the first gradients).
    remat = {}
    for label, c in (("on", cfg), ("off", dataclasses.replace(cfg, remat=False))):
        torch.cuda.reset_peak_memory_stats()
        held_gb = torch.cuda.memory_allocated() / 1e9
        (_, _, grads_again), sec = _timed(torch, device, lambda: loss_and_grads(c, params, batch))
        remat[label] = {"grad_s": sec, "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
                        "held_gb": held_gb,
                        "leaves_differing": sorted(name for name in grads_c if not torch.equal(
                            grads_c[name], grads_again[name]))}
        del grads_again
    moved = remat["on"]["leaves_differing"]
    log(f"{tag} the same gradients again: {len(grads_c) - len(moved)} of {len(grads_c)} leaves "
        f"bit for bit" + (f"; differing: {moved}" if moved else ""))
    log(f"{tag} cfg.remat on / off: gradient step {remat['on']['grad_s']:.3f} / "
        f"{remat['off']['grad_s']:.3f} s, peak memory {remat['on']['peak_memory_gb']:.2f} / "
        f"{remat['off']['peak_memory_gb']:.2f} GB; leaves differing with remat off "
        f"{remat['off']['leaves_differing']}")
    if moved and spec["fault_at"] is None:
        raise AssertionError(f"{tag} the same step's gradients differ between two runs: {moved}")
    if remat["off"]["leaves_differing"]:
        raise AssertionError(f"{tag} cfg.remat changed gradients")
    report.update(loss_kernels=float(loss_c), loss_plain=float(loss_p), loss_rel=loss_rel,
                  grad_rel_norm=rel, grads_nondeterministic=moved, grad_s=sec_c,
                  grad_plain_s=sec_p, grad_step_peak_gb=grad_peak, remat=remat)
    del grads_c
    torch.cuda.empty_cache()

    # (ii) the Trainer, uninterrupted and, with a fault step, with a failure
    # there; or (spec["trainer"] False) the step function alone.
    root = tempfile.mkdtemp(prefix="train_ckpt_")
    runs = {}
    labels = (("uninterrupted", None),) + (
        (("faulted", spec["fault_at"]),) if spec["fault_at"] is not None else ())
    try:
        for label, fault_at in labels if spec.get("trainer", True) else ():
            fails = {fault_at} if fault_at is not None else set()

            def fault_hook(step):
                if step in fails:
                    fails.discard(step)
                    raise RuntimeError("injected device failure")

            losses, auxes = [], []

            def logging_step(state, batch):
                state, metrics = step_fn(state, batch)
                losses.append(float(metrics["loss"]))
                auxes.append(float(metrics["aux"]))
                return state, metrics

            cfg_t = TrainerConfig(total_steps=spec["steps"], checkpoint_every=spec["every"],
                                  checkpoint_dir=os.path.join(root, label), keep_checkpoints=1)
            trainer = Trainer(logging_step, pipe.make_batch, state0, cfg_t, device=device,
                              fault_hook=fault_hook)
            if label == labels[-1][0]:
                # The last run's Trainer holds the only reference to the
                # initial state, so a step holds two states, not three
                # (olmoe's 4 layers: 22.6 GB each with AdamW's moments).
                state0 = params = None
            torch.cuda.reset_peak_memory_stats()
            _zero_counts()
            out, wall = _timed(torch, device, trainer.run)
            runs[label] = {"out": out, "wall_s": wall, "losses": losses, "auxes": auxes,
                           "launches": dict(_runtime.LAUNCHES), "arms": _arms(),
                           "plain_on_cuda": dict(_runtime.PLAIN_ON_CUDA),
                           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
            ev = out["events"]
            log(f"{tag} (ii) {label}: {out['final_step']} steps in {wall:.1f} s, restarts "
                f"{ev.restarts}, losses " + " ".join(f"{x:.4f}" for x in losses)
                + f"; step s " + " ".join(f"{t:.3f}" for t in ev.step_times))
            shutil.rmtree(os.path.join(root, label), ignore_errors=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    if not spec.get("trainer", True):
        state, events, losses, auxes = state0, TrainerEvents(), [], []
        state0 = params = None
        torch.cuda.reset_peak_memory_stats()
        _zero_counts()
        t_run = time.perf_counter()
        for step in range(spec["steps"]):
            (state, metrics), sec = _timed(torch, device,
                                           lambda: step_fn(state, pipe.make_batch(step)))
            events.step_times.append(sec)
            losses.append(float(metrics["loss"]))
            auxes.append(float(metrics["aux"]))
        runs["uninterrupted"] = {
            "out": {"final_step": spec["steps"], "state": state, "events": events},
            "wall_s": time.perf_counter() - t_run, "losses": losses, "auxes": auxes,
            "launches": dict(_runtime.LAUNCHES), "arms": _arms(),
            "plain_on_cuda": dict(_runtime.PLAIN_ON_CUDA),
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
        del state
        log(f"{tag} (ii) the step function alone: {spec['steps']} steps, losses "
            + " ".join(f"{x:.4f}" for x in losses)
            + f"; step s " + " ".join(f"{t:.3f}" for t in events.step_times))
    ref = runs["uninterrupted"]
    same, final_rel = None, None
    if "faulted" in runs:
        rep = runs["faulted"]
        ref_leaves = pt.tree_leaves(ref["out"]["state"])
        rep_leaves = pt.tree_leaves(rep["out"]["state"])
        same = len(ref_leaves) == len(rep_leaves) and all(
            torch.equal(a, b) for a, b in zip(ref_leaves, rep_leaves))
        final_rel = abs(ref["losses"][-1] - rep["losses"][-1]) / abs(ref["losses"][-1])
        log(f"{tag} (ii) the replay's final parameters and Adam state "
            + ("equal the uninterrupted run's bit for bit" if same else
               f"differ from the uninterrupted run's; final loss rel {final_rel:.2e}"))
        if rep["out"]["events"].restarts != 1 or rep["out"]["final_step"] != spec["steps"]:
            raise AssertionError(f"{tag} (ii) the faulted run did not restart once and finish")
        if not same and (moved == [] or final_rel > 1e-3):
            raise AssertionError(f"{tag} (ii) the replay differs from the uninterrupted run")
    if not all(math.isfinite(x) for x in ref["losses"]):
        raise AssertionError(f"{tag} (ii) non-finite losses {ref['losses']}")
    if cfg.n_experts and not all(math.isfinite(x) and x > 0 for x in ref["auxes"]):
        raise AssertionError(f"{tag} (ii) aux losses {ref['auxes']}: not finite and positive")

    # (iii) step time, tokens/s, memory, launches a step, MFU.
    times = ref["out"]["events"].step_times
    step_s = statistics.median(times[1:])
    tokens = spec["batch"] * spec["seq"]
    flops = model_flops(cfg, ShapeSpec("train", spec["seq"], spec["batch"], "train"))
    arms = ref["arms"]
    per_step = {arm: arms.get(arm, 0) / spec["steps"] for arm in spec["arms"]}
    kind = "attn" if spec["arms"][0].startswith("flash") else "ssm"
    n_kind = sum(k == kind for k in cfg.layer_kinds())
    if kind == "attn":  # an encoder–decoder's encoder and cross calls
        n_kind += cfg.encoder_layers + (cfg.n_layers if cfg.cross_attention else 0)
    expected = {spec["arms"][0]: n_kind * (2 if cfg.remat else 1), spec["arms"][1]: n_kind}
    report.update(
        step_ms=[1e3 * t for t in times], median_step_ms=1e3 * step_s,
        tokens_per_s=tokens / step_s, peak_memory_gb=ref["peak_memory_gb"],
        launches_per_step=per_step, model_flops=flops,
        mfu=flops / step_s / peaks["bfloat16_tensor"], replay_bit_for_bit=same,
        final_loss_rel=final_rel, losses={k: r["losses"] for k, r in runs.items()},
        auxes=ref["auxes"],
        trainer_wall_s={k: r["wall_s"] for k, r in runs.items()},
        launches=ref["launches"], arms=arms, plain_on_cuda=ref["plain_on_cuda"])
    log(f"{tag} (iii) median step {1e3 * step_s:.1f} ms (steps after the first), "
        f"{tokens / step_s:.0f} tokens/s, peak memory {ref['peak_memory_gb']:.1f} GB, kernel "
        f"launches a step {per_step} ({expected} expected: cfg.remat recomputes the forward), "
        f"aux {ref['auxes']}, MFU {report['mfu']:.1%} "
        f"(6·N·tokens = {flops / 1e12:.1f} TFLOP a step against {peaks['bfloat16_tensor'] / 1e12:.0f} "
        f"TFLOP/s bf16)")
    if per_step != expected:
        raise AssertionError(f"{tag} kernel launches a step {per_step}")
    # Where a step's time goes: torch.profiler over one more step, counted
    # apart (the path's kernels carry spec["kernel"] in their names).
    final = ref["out"]["state"]
    prof = profile_serving(torch, lambda: step_fn(final, batch), spec["kernel"], device)
    report["profile_step"] = prof
    share = lambda v: "not measured" if v is None else f"{v:.1%}"  # noqa: E731
    log(f"{tag} profile of one step: device {prof['device_ms']:.1f} ms in "
        f"{prof['wall_ms_profiled']:.1f} ms wall (idle {share(prof['device_idle_share'])}), "
        f"{spec['kernel']} kernels {prof['kernel_ms']:.1f} ms "
        f"({share(prof['kernel_share_of_device'])}), {prof['launches']} device launches; top: "
        + "; ".join(f"{o['name']} {o['ms']:.2f} ms x{o['calls']}" for o in prof["top_ops"]))
    del runs, ref, final, step_fn
    torch.cuda.empty_cache()
    return report


def phase_train_big(torch, spec=TRAIN_SSM_BIG, device="cuda"):
    """One training step (gradients and AdamW) of ``spec``'s model at full
    width and depth under ``cfg.remat``, at a batch whose activations would
    not fit without it: its time, peak memory and the reckoned size of the
    activations remat keeps (each block's input)."""
    from repro_torch.launch import train as train_lib

    torch.cuda.reset_peak_memory_stats()
    cfg, _, state, pipe, step_fn = train_lib.build(spec["arch"], "full", spec["batch"],
                                                   spec["seq"], spec["lr"], device)
    batch = pipe.make_batch(0)
    (state, metrics), sec = _timed(torch, device, lambda: step_fn(state, batch))
    peak = torch.cuda.max_memory_allocated() / 1e9
    n_params = sum(t.numel() for t in state[0].values())
    tokens = spec["batch"] * spec["seq"]
    kept_gb = cfg.n_layers * tokens * cfg.d_model * 2 / 1e9
    out = {"arch": cfg.name, "batch": spec["batch"], "seq": spec["seq"], "remat": cfg.remat,
           "step_s": sec, "peak_memory_gb": peak, "loss": float(metrics["loss"]),
           "params": n_params, "block_inputs_gb": kept_gb,
           "params_grads_adam_gb": 16 * n_params / 1e9}
    log(f"[train mamba2 4x4096] {cfg.name} one step at {spec['batch']} x {spec['seq']} tokens "
        f"with cfg.remat: {sec:.2f} s (first step, allocator cold), loss {out['loss']:.4f}, peak "
        f"memory {peak:.1f} GB ({out['params_grads_adam_gb']:.1f} GB of parameters, gradients "
        f"and AdamW moments; the kept block inputs {kept_gb:.2f} GB)")
    if not math.isfinite(out["loss"]):
        raise AssertionError(f"[train mamba2 4x4096] non-finite loss {out['loss']}")
    del state, step_fn
    torch.cuda.empty_cache()
    return out


def phase_training(torch, peaks, report, device="cuda", only=None):
    """check-lm-grad, train (qwen1.5-0.5b, mamba2-1.3b, olmoe-1b-7b cut to 4
    layers, one mamba2 step at 4 x 4 096, seamless-m4t-large-v2) and hf-lm
    (qwen1.5 SMOKE, then mamba2 SMOKE); with ``only="zoo"`` check-lm-grad
    at GRAD_160_CHECK and SSD_JAMBA and the mamba2, olmoe and mamba2 4 x
    4 096 cells alone; with ``only="encdec"`` check-lm-grad at
    GRAD_ENCDEC_CHECK and the seamless cell alone.  Each main path runs with the
    counts set to 0 just before it and read just after; its kernels and
    arms must have launched and no plain version may have run on the card.
    Returns (the kernel entries of K9's and K10's differentiated arms,
    {path: launches}, {path: arms}), with each path's K9 and K10 counts
    split: ``flash_attention`` / ``ssd_scan`` their forward arms,
    ``*_bwd`` / ``*_jvp`` the other two (``SPLIT_ARMS``)."""
    if only == "zoo":
        entries = phase_check_lm_grad(torch, peaks, device, GRAD_160_CHECK, (ATTN_160[:7],))
        entries["ssd"] = check_ssd_grad(torch, peaks, device, (SSD_JAMBA,), (SSD_JAMBA,))
    elif only == "encdec":
        entries = phase_check_lm_grad(torch, peaks, device, GRAD_ENCDEC_CHECK, (ATTN_ENC_TRAIN,))
    else:
        entries = phase_check_lm_grad(torch, peaks, device)
        entries["ssd"] = check_ssd_grad(torch, peaks, device)
    report["check_lm_grad"] = entries
    _lap(report, "check-lm-grad")
    paths = []
    if only is None:
        report["train"] = phase_train(torch, peaks, TRAIN, device)
        _lap(report, "train")
        paths.append(("train", (), TRAIN["arms"]))
    if only in (None, "zoo"):
        report["train_ssm"] = phase_train(torch, peaks, TRAIN_SSM, device)
        _lap(report, "train-mamba2")
        report["train_moe"] = phase_train(torch, peaks, TRAIN_MOE, device)
        _lap(report, "train-olmoe")
        report["train_ssm_big"] = phase_train_big(torch, TRAIN_SSM_BIG, device)
        _lap(report, "train-mamba2-4x4096")
        paths += [("train_ssm", (), TRAIN_SSM["arms"]), ("train_moe", (), TRAIN_MOE["arms"])]
    if only in (None, "encdec"):
        report["train_encdec"] = phase_train(torch, peaks, TRAIN_ENCDEC, device)
        _lap(report, "train-encdec")
        paths.append(("train_encdec", (), TRAIN_ENCDEC["arms"]))
    if only is None:
        report["hf_lm"] = phase_hf_lm(torch, device)
        _lap(report, "hf-lm")
        report["hf_lm_ssm"] = phase_hf_lm_ssm(torch, device)
        _lap(report, "hf-lm-mamba2")
        paths += [("hf_lm", HF_LM_PATH_KERNELS, HF_LM_PATH_ARMS),
                  ("hf_lm_ssm", HF_LM_PATH_KERNELS, HF_LM_SSM_PATH_ARMS)]
    launches, arms = {}, {}
    for key, need_k, need_a in paths:
        r = report[key]
        if not all(r["launches"][k] for k in need_k) or not all(r["arms"].get(a) for a in need_a):
            raise AssertionError(f"[{key}] a kernel or arm never launched: {r['launches']}, "
                                 f"{r['arms']}")
        if any(r["plain_on_cuda"].values()):
            raise AssertionError(f"[{key}] plain versions ran on the card: {r['plain_on_cuda']}")
        split = dict(r["launches"])
        for name, arm in SPLIT_ARMS.items():
            n = r["arms"].get(arm, 0)
            split[name] = n
            split[arm.split(":")[0]] -= n
        launches[key], arms[key] = split, r["arms"]
        log(f"[{key}] launches {r['launches']}; arms {r['arms']}; plain versions on the card "
            f"{r['plain_on_cuda']}")
    return entries, launches, arms


# The dry-run's phase (21): shapes the script ran at full width traced on the
# meta device (launch/trace_stats.py), each predicted peak held within
# DRYRUN_TOL of the max_memory_allocated() its phase measured.  The training
# cells' gradient steps hold what phase_train holds (parameters, AdamW state,
# the first gradients); the serving cells' prefill and one decode step what
# phase_main_lm holds (parameters, caches, prompts and frames).
DRYRUN_TOL = 0.15
DRYRUN_TRAIN = (("train", TRAIN),)
DRYRUN_SERVE = ("main-lm-encdec", "main-lm-moe")
# The GPC cell: held against its plain run at DRYRUN_GPC_N in f64, run once
# at SCALE_N in f32 for its peak and time.
DRYRUN_GPC_N = 4096


def dryrun_train(torch, spec, remat):
    """``(counts, model_flops)`` of ``spec``'s gradient step traced on the
    meta device with ``cfg.remat`` as given."""
    from repro_torch.configs import ShapeSpec, get_config
    from repro_torch.launch import (init_opt_state, input_specs, loss_and_grads, model_flops,
                                    params_dict, trace_stats)
    from repro_torch.models import transformer

    cfg = dataclasses.replace(get_config(spec["arch"]), remat=remat)
    shape = ShapeSpec("train", spec["seq"], spec["batch"], "train")
    skeleton = transformer.Model(None, cfg, "meta")
    params = params_dict(skeleton)
    grads = {name: torch.empty_like(t) for name, t in params.items()}
    batch = input_specs(cfg, shape)
    _, counts = trace_stats.trace(lambda: loss_and_grads(cfg, params, batch, skeleton=skeleton),
                                  live=[params, init_opt_state(params), grads, batch])
    return counts, model_flops(cfg, shape)


def dryrun_serve(torch, key):
    """``(prefill counts, decode-step counts, model_flops of the prefill)``
    of ``LM_PATHS[key]`` traced on the meta device: its prompts (and
    frames) into caches ``prompt + decode`` deep, then one decode step."""
    from repro_torch import models
    from repro_torch.configs import ShapeSpec, get_config
    from repro_torch.launch import make_prefill_step, make_serve_step, model_flops, trace_stats

    spec = LM_PATHS[key]
    cfg = get_config(spec["arch"])
    skeleton = models.transformer.Model(None, cfg, "meta")
    params = list(skeleton.parameters())
    b, s = spec["batch"], spec["prompt"]
    max_len = s + spec["decode"]
    meta = dict(device="meta")
    batch = {"tokens": torch.empty((b, s), dtype=torch.int64, **meta)}
    if "source" in spec:
        batch["src_embeds"] = torch.empty((b, spec["source"], cfg.d_model), **meta)
    state = models.init_decode_state(cfg, b, max_len, device="meta")
    (state, _), pre = trace_stats.trace(make_prefill_step(cfg, max_len), skeleton, batch, state,
                                        live=[params])
    tok = torch.empty((b, 1), dtype=torch.int64, **meta)
    _, dec = trace_stats.trace(make_serve_step(cfg), skeleton, tok, state, live=[params, batch])
    shape = ShapeSpec("prefill", spec.get("source", s), b, "prefill")
    return pre, dec, model_flops(cfg, shape)


def gpc_inputs(torch, n, dtype, device="cuda", seed=0):
    """The GPC iteration's inputs: pixel-like X in [0, 1) pre-scaled by λ,
    √h of Laplace weights in [0.05, 0.25], random x, r, p, an orthonormal W
    with AW near it and (W AWᵀ)⁻¹."""
    g = torch.Generator(device=device).manual_seed(seed)
    kw = dict(generator=g, device=device, dtype=dtype)
    x = torch.rand((n, D), **kw).div_(LENGTHSCALE)
    sqrt_h = (0.05 + 0.2 * torch.rand(n, **kw)).sqrt_()
    xv, r, p = (torch.randn(n, **kw) for _ in range(3))
    w = torch.linalg.qr(torch.randn((n, K), **kw))[0].T.contiguous()
    aw = w + 0.1 * torch.randn((K, n), **kw)
    return x, sqrt_h, (xv, r, p, r @ r, w, aw, torch.linalg.inv(w @ aw.T))


def _bound_ms(peaks, counts, unit):
    return 1e3 * max(counts["flops"] / peaks[unit], counts["bytes"] / peaks["bytes"])


def _held(checks, label, predicted, measured_gb, held_gb, held_pred):
    """Hold ``predicted`` bytes within DRYRUN_TOL of the measured peak and
    record the check."""
    rel = predicted / 1e9 / measured_gb - 1.0
    checks[label] = {"predicted_gb": predicted / 1e9, "measured_gb": measured_gb,
                     "rel": rel, "held_predicted_gb": held_pred / 1e9, "held_measured_gb": held_gb}
    log(f"[dryrun] {label}: predicted peak {predicted / 1e9:.2f} GB, measured "
        f"{measured_gb:.2f} GB ({rel:+.1%}; held before the step: predicted "
        f"{held_pred / 1e9:.2f}, measured {held_gb:.2f} GB)")
    if not abs(rel) <= DRYRUN_TOL:
        raise AssertionError(f"[dryrun] {label}: predicted peak {predicted / 1e9:.2f} GB is "
                             f"{rel:+.1%} from the measured {measured_gb:.2f} GB")


def phase_dryrun(torch, peaks, report, device="cuda"):
    """Phase 21 (see the module docstring).  Returns the checks, the FLOPs
    and bounds beside the measured times, and the GPC cells."""
    from dataclasses import replace

    from repro_torch.kernels import _runtime
    from repro_torch.launch import gpc_dryrun

    t_phase = time.perf_counter()
    checks, flops = {}, {}
    for key, spec in DRYRUN_TRAIN:
        if key not in report:
            continue
        for label, remat in (("on", True), ("off", False)):
            t0 = time.perf_counter()
            counts, mf = dryrun_train(torch, spec, remat)
            got = report[key]["remat"][label]
            tag = f"{spec['arch']} {spec['batch']} x {spec['seq']} gradient step, remat {label}"
            _held(checks, tag, counts["peak_bytes"], got["peak_memory_gb"],
                  got["held_gb"], counts["held_bytes"])
            flops[tag] = {"traced_tflop": counts["flops"] / 1e12, "model_tflop": mf / 1e12,
                          "bound_ms": _bound_ms(peaks, counts, "bfloat16_tensor"),
                          "measured_ms": 1e3 * got["grad_s"], "launches": counts["launches"],
                          "trace_s": time.perf_counter() - t0}
    for key in DRYRUN_SERVE:
        if key not in report:
            continue
        t0 = time.perf_counter()
        pre, dec, mf = dryrun_serve(torch, key)
        got = report[key]
        tag = f"{key} ({got['arch']}) prefill and decode"
        _held(checks, tag, max(pre["peak_bytes"], dec["peak_bytes"]),
              got["peak_memory_gb"], got["held_gb"], pre["held_bytes"])
        flops[f"{key} prefill"] = {
            "traced_tflop": pre["flops"] / 1e12, "model_tflop": mf / 1e12,
            "bound_ms": _bound_ms(peaks, pre, "bfloat16_tensor"),
            "measured_ms": got["prefill_ms"], "launches": pre["launches"],
            "trace_s": time.perf_counter() - t0}
        flops[f"{key} decode step"] = {
            "traced_tflop": dec["flops"] / 1e12, "bound_ms": _bound_ms(peaks, dec,
                                                                       "bfloat16_tensor"),
            "measured_ms": got["decode_ms_per_step"], "launches": dec["launches"]}
    for tag, f in flops.items():
        mf = f" against model_flops {f['model_tflop']:.2f}" if "model_tflop" in f else ""
        log(f"[dryrun] {tag}: traced {f['traced_tflop']:.3f} TFLOP{mf}, {f['launches']} "
            f"launches; roofline bound {f['bound_ms']:.3f} ms against {f['measured_ms']:.1f} ms "
            f"measured")
    if len(checks) < 3 or not any("remat on" in k for k in checks) or not any(
            "prefill" in k for k in checks):
        raise AssertionError(f"[dryrun] too few peaks held: {sorted(checks)}")

    # The GPC cell on K3: against the plain versions in f64, then once at
    # SCALE_N in f32 for its peak and time.
    gpc = {}
    cfg = replace(GPC, n=DRYRUN_GPC_N, dtype="float64")
    x, sqrt_h, state = gpc_inputs(torch, cfg.n, torch.float64, device)
    before = _runtime.LAUNCHES["rbf_matvec"]
    got = gpc_dryrun.make_defcg_iteration(cfg)(x, sqrt_h, state)
    launched = _runtime.LAUNCHES["rbf_matvec"] - before
    want = gpc_dryrun.make_defcg_iteration(cfg, backend="plain")(x, sqrt_h, state)
    rel = max(float((a - b).abs().max() / b.abs().max().clamp_min(1e-300))
              for a, b in zip(got, want))
    gpc["check"] = {"n": cfg.n, "dtype": "float64", "max_rel_err": rel, "k3_launches": launched}
    log(f"[dryrun] GPC iteration n={cfg.n} f64 on K3 ({launched} launch) against the plain "
        f"versions: max relative error {rel:.2e} over the seven outputs")
    if not (rel <= TOL["float64"] and launched == 1):
        raise AssertionError(f"[dryrun] GPC iteration: error {rel:.2e}, K3 launches {launched}")
    del x, sqrt_h, state, got, want

    cfg = replace(GPC, n=SCALE_N)
    predicted = gpc_dryrun.trace_cell(cfg)
    torch.cuda.empty_cache()
    before_gb = torch.cuda.memory_allocated() / 1e9
    x, sqrt_h, state = gpc_inputs(torch, cfg.n, torch.float32, device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held_gb = torch.cuda.memory_allocated() / 1e9 - before_gb
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = gpc_dryrun.make_defcg_iteration(cfg)(x, sqrt_h, state)
    end.record()
    torch.cuda.synchronize()
    if not all(bool(torch.isfinite(t).all()) for t in out):
        raise AssertionError("[dryrun] GPC iteration at SCALE_N: non-finite outputs")
    measured_gb = torch.cuda.max_memory_allocated() / 1e9 - before_gb
    _held(checks, f"GPC iteration n={cfg.n} f32 (K3)", predicted["peak_bytes"],
          measured_gb, held_gb, predicted["held_bytes"])
    ms = start.elapsed_time(end)
    gpc["scale"] = {"n": cfg.n, "ms": ms, "bound_ms": _bound_ms(peaks, predicted, "float32"),
                    "traced_tflop": predicted["flops"] / 1e12,
                    "model_tflop": gpc_dryrun.model_flops(cfg) / 1e12}
    log(f"[dryrun] GPC iteration n={cfg.n} f32: {ms:.1f} ms against a {gpc['scale']['bound_ms']:.1f}"
        f" ms bound (f32 CUDA cores; {gpc['scale']['traced_tflop']:.2f} TFLOP traced, "
        f"model_flops {gpc['scale']['model_tflop']:.2f})")
    del x, sqrt_h, state, out
    torch.cuda.empty_cache()
    paper = gpc_dryrun.trace_cell(GPC)
    gpc["paper"] = {"n": GPC.n, "peak_gb": paper["peak_bytes"] / 1e9,
                    "traced_tflop": paper["flops"] / 1e12,
                    "model_tflop": gpc_dryrun.model_flops(GPC) / 1e12,
                    "bound_ms": _bound_ms(peaks, paper, "float32")}
    log(f"[dryrun] GPC iteration n={GPC.n} f32, dry-run only: peak "
        f"{gpc['paper']['peak_gb']:.2f} GB, {gpc['paper']['traced_tflop']:.1f} TFLOP traced "
        f"(model_flops {gpc['paper']['model_tflop']:.1f}), bound {gpc['paper']['bound_ms']:.1f} ms")
    phase_s = time.perf_counter() - t_phase
    log(f"[dryrun] {len(checks)} predicted peaks held within {DRYRUN_TOL:.0%}; phase "
        f"{phase_s:.1f} s")
    return {"checks": checks, "flops": flops, "gpc": gpc, "phase_s": phase_s}


def fig3_slope(trace) -> float:
    """``benchmarks/paper_fig23.py``'s mean log10-residual slope per
    iteration of one recorded residual history."""
    import numpy as np

    r = np.asarray(trace)
    r = r[np.isfinite(r)]
    r = r[r > 0]
    if len(r) < 3:
        return 0.0
    return float((np.log10(r[-1]) - np.log10(r[0])) / (len(r) - 1))


def phase_paper(torch, x, y, k_dense, runs, device="cuda"):
    """The paper's three experiments on the main path's data (n = 36 551,
    dense K): Fig. 2 and Table 1 from ``runs`` (main's tol 1e-5 Cholesky,
    CG and def-CG(8, 12) sequences, not solved again), Fig. 3 (CG and
    def-CG at solver tol 1e-8 with their residual histories; def-CG's mean
    slope after system 1 must be steeper) and Fig. 4 (Cholesky at Newton
    tol 1e-3; ``subset_gpc`` at m = n/16 … n/2, each subset drawn by a
    generator seeded m; CG and def-CG at solver tol 1e-8: the relative
    log p errors, each run's seconds, and the precision gap, which must
    pass 1e2)."""
    from repro_torch.core import RecycleManager
    from repro_torch.gp import RBFKernel, laplace_gpc, subset_gpc

    kernel = RBFKernel(theta=THETA, lengthscale=LENGTHSCALE)
    n = x.shape[0]
    out = {"n": n}
    cg_its, def_its = runs["cg"]["iterations"], runs["defcg"]["iterations"]
    chol = runs["cholesky"]["logp"]
    saving = 1.0 - sum(def_its[1:]) / max(sum(cg_its[1:]), 1)
    agreement = max(abs(runs[s]["logp"] - chol) / abs(chol) for s in ("cg", "defcg"))
    out["fig2"] = {"cg": cg_its, "defcg": def_its}
    out["table1"] = {"cg_total": sum(cg_its), "defcg_total": sum(def_its),
                     "saving_after_system_1": saving, "agreement": agreement,
                     "solve_s": {s: runs[s]["cumulative_solve_s"][-1]
                                 for s in ("cholesky", "cg", "defcg")}}
    log(f"[paper] n={n} fig2 iterations per system: cg {cg_its}, defcg {def_its}")
    log(f"[paper] table1: totals cg {sum(cg_its)}, defcg {sum(def_its)}; "
        f"{saving:.1%} fewer def-CG iterations after system 1; log p agreement with "
        f"cholesky {agreement:.2e} (P2 at tol 1e-5); solve s {out['table1']['solve_s']}")

    dense = dict(k_dense=k_dense, dense_matvec=True, block=BLOCK)
    fig3 = {}
    for solver in ("cg", "defcg"):
        recycle = (RecycleManager(k=K, ell=ELL, tol=FIG3["tol"], maxiter=FIG3["maxiter"])
                   if solver == "defcg" else None)
        t0 = time.perf_counter()
        res = laplace_gpc(x, y, kernel, solver=solver, recycle=recycle, solver_tol=FIG3["tol"],
                          newton_tol=1.0, record_residuals=True,
                          solver_maxiter=FIG3["maxiter"], **dense)
        _sync(torch, device)
        slopes = [fig3_slope(t.cpu()) for t in res.trace.residual_traces[1:]]
        fig3[solver] = {"iterations": res.trace.solver_iterations, "slopes": slopes,
                        "mean_slope": sum(slopes) / max(len(slopes), 1),
                        "wall_s": time.perf_counter() - t0}
    p3 = fig3["defcg"]["mean_slope"] < fig3["cg"]["mean_slope"]
    out["fig3"] = dict(fig3, P3_pass=p3)
    log(f"[paper] fig3 (tol {FIG3['tol']:g}): iterations cg {fig3['cg']['iterations']}, defcg "
        f"{fig3['defcg']['iterations']}; mean log10-residual slope per iteration after system 1: "
        f"cg {fig3['cg']['mean_slope']:.4f}, defcg {fig3['defcg']['mean_slope']:.4f} "
        f"(P3 pass={p3})")
    if not p3:
        raise AssertionError("[paper] fig3: def-CG's residual slope is not steeper than CG's")

    t0 = time.perf_counter()
    exact = laplace_gpc(x, y, kernel, solver="cholesky", newton_tol=FIG4["newton_tol"], **dense)
    _sync(torch, device)
    rows = {"cholesky": {"seconds": time.perf_counter() - t0, "logp": exact.logp,
                         "newton_steps": len(exact.trace.logp)}}
    for div in FIG4["subset_divs"]:
        m = n // div
        sub = subset_gpc(x, y, kernel, m, generator=torch.Generator().manual_seed(m))
        rows[f"subset_m={m}"] = {"seconds": sub.seconds, "logp": sub.logp_full,
                                 "rel_err": abs(sub.logp_full - exact.logp) / abs(exact.logp)}
    for solver in ("cg", "defcg"):
        recycle = RecycleManager(k=K, ell=ELL) if solver == "defcg" else None
        t0 = time.perf_counter()
        res = laplace_gpc(x, y, kernel, solver=solver, recycle=recycle,
                          solver_tol=FIG4["solver_tol"], newton_tol=FIG4["newton_tol"], **dense)
        _sync(torch, device)
        rows[solver] = {"seconds": time.perf_counter() - t0, "logp": res.logp,
                        "rel_err": abs(res.logp - exact.logp) / abs(exact.logp),
                        "iterations": res.trace.solver_iterations}
    best_subset = min(r["rel_err"] for k_, r in rows.items() if k_.startswith("subset"))
    it_err = max(rows[s]["rel_err"] for s in ("cg", "defcg"))
    gap = best_subset / max(it_err, 1e-16)
    out["fig4"] = dict(rows, precision_gap=gap, P4_pass=gap > 1e2)
    for name, r in rows.items():
        log(f"[paper] fig4 {name:>16s}: {r['seconds']:8.3f} s, "
            + (f"rel err {r['rel_err']:.3e}" if "rel_err" in r else f"log p {r['logp']:.6f}")
            + (f", iterations {r['iterations']}" if "iterations" in r else ""))
    log(f"[paper] fig4 precision gap iterative vs best subset: {gap:.2e} (P4 pass={gap > 1e2})")
    if not all(math.isfinite(r["logp"]) for r in rows.values()):
        raise AssertionError(f"[paper] fig4: a non-finite log p: {rows}")
    if not gap > 1e2:
        raise AssertionError(f"[paper] fig4: precision gap {gap:.2e} <= 1e2")
    return out


def chaos_trace(torch, x, num, seed=0):
    """``benchmarks/chaos_bench.py``'s drifting H½ systems on ``x``'s data:
    per system ``sqrt_h`` from latents ~ N(0, 0.5²) and a right-hand side
    ~ N(0, 1), both from ``numpy.random.default_rng(seed + 1)``."""
    import numpy as np

    rng = np.random.default_rng(seed + 1)
    fs = rng.standard_normal((num, x.shape[0])) * 0.5
    pis = 1.0 / (1.0 + np.exp(-fs))
    bs = rng.standard_normal((num, x.shape[0]))
    return (torch.as_tensor(np.sqrt(pis * (1.0 - pis)), device=x.device),
            torch.as_tensor(bs, device=x.device))


def stall_step(trace, window):
    """The iteration at which the stall rule (the best residual not down
    1 % for ``window`` iterations) first fires on a residual history."""
    best, stall = trace[0], 0
    for j, r in enumerate(trace[1:], start=1):
        if not math.isfinite(r):
            return None
        stall = 0 if r < 0.99 * best else stall + 1
        best = min(best, r)
        if stall >= window:
            return j
    return None


def phase_chaos(torch, x, device="cuda"):
    """``benchmarks/chaos_bench.py``'s sequence over the matrix-free K3
    operator (``RBFKernelSystemOperator``): the clean sequence with the
    recovery ladder armed and disarmed (the same iterates, rungs 0); system
    1 poisoned with NaN (rungs 0/3/0/0, finite x, the neighbours
    converged, the extra matvecs and the ladder's wall time); the chunked,
    checkpointed driver (every 2 systems, a temporary directory) against
    the single run, then a resume past a truncated newest checkpoint (the
    same iterates, bit for bit); ``refresh_aw="stale"`` at tol 1e-10 (the
    rungs P9's ladder climbs); and one Jacobi-preconditioned solve with the
    stall detector armed, which must stop STAGNATED where the stall rule on
    its own residual history fires."""
    import shutil
    import tempfile

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.core import (
        FaultInjectingOperator,
        RBFKernelSystemOperator,
        SolveSpec,
        SolveStatus,
        jacobi,
        solve,
        solve_sequence,
        truncate_latest_checkpoint,
    )

    num = CHAOS["num"]
    sqrt_hs, bs = chaos_trace(torch, x, num)
    spec = SolveSpec(k=K, ell=ELL, tol=CHAOS["tol"], maxiter=CHAOS["maxiter"])

    def make(s):
        return RBFKernelSystemOperator(x, s["sqrt_h"], THETA, LENGTHSCALE, block=BLOCK)

    def make_faulty(s):
        return FaultInjectingOperator(make(s), s["poison"])

    timed = functools.partial(_timed, torch, device)

    def its(res):
        return [int(v) for v in res.info.iterations.tolist()]

    systems = {"sqrt_h": sqrt_hs}
    out = {"n": x.shape[0]}
    clean, t_clean = timed(lambda: solve_sequence(systems, bs, spec, make_operator=make))
    off, t_off = timed(lambda: solve_sequence(systems, bs, spec, make_operator=make,
                                              divergence_fallback=False))
    mv_clean = int(clean.info.matvecs.sum())
    unchanged = (its(clean) == its(off) and torch.equal(clean.x, off.x)
                 and not bool(clean.report.rung.any()))
    out["clean"] = {"iterations": its(clean), "matvecs": clean.info.matvecs.tolist(),
                    "armed_s": t_clean, "disarmed_s": t_off, "unchanged": unchanged}
    log(f"[chaos] n={x.shape[0]} clean: iterations {its(clean)}, armed {t_clean:.3f} s, disarmed "
        f"{t_off:.3f} s (iterates unchanged={unchanged}, rungs {clean.report.rung.tolist()})")
    if not unchanged or not bool(clean.info.converged.all()):
        raise AssertionError(f"[chaos] the armed ladder changed a clean sequence: {out['clean']}")

    poison = torch.zeros(num, dtype=bs.dtype, device=x.device)
    poison[CHAOS["poisoned"]] = float("nan")
    chaos, t_chaos = timed(lambda: solve_sequence({"sqrt_h": sqrt_hs, "poison": poison}, bs,
                                                  spec, make_operator=make_faulty))
    rungs = chaos.report.rung.tolist()
    status = [SolveStatus.describe(v) for v in chaos.report.status.tolist()]
    conv = chaos.info.converged.tolist()
    healthy = all(c for i, c in enumerate(conv) if i != CHAOS["poisoned"])
    finite = bool(torch.isfinite(chaos.x).all())
    mv_chaos = int(chaos.info.matvecs.sum())
    out["recovery"] = {"rungs": rungs, "status": status, "iterations": its(chaos),
                       "extra_matvecs": mv_chaos - mv_clean, "finite": finite,
                       "neighbours_converged": healthy, "seconds": t_chaos,
                       "ladder_s": t_chaos - t_clean}
    log(f"[chaos] system {CHAOS['poisoned']} poisoned (NaN): statuses {status}, rungs {rungs}; "
        f"matvecs {mv_clean} -> {mv_chaos} (+{mv_chaos - mv_clean} recovery), "
        f"{t_chaos:.3f} s (+{t_chaos - t_clean:.3f} s); finite={finite}, neighbours "
        f"converged={healthy}")
    want_rungs = [3 if i == CHAOS["poisoned"] else 0 for i in range(num)]
    if rungs != want_rungs or not finite or not healthy:
        raise AssertionError(f"[chaos] recovery: {out['recovery']}")

    ckpt = tempfile.mkdtemp(prefix="chaos_ckpt_")
    try:
        chunked, t_chunk = timed(lambda: solve_sequence(
            systems, bs, spec, make_operator=make, checkpoint=CheckpointManager(ckpt),
            checkpoint_every=CHAOS["chunk"]))
        torn = truncate_latest_checkpoint(ckpt)
        mgr = CheckpointManager(ckpt)
        resumed, t_resume = timed(lambda: solve_sequence(
            systems, bs, spec, make_operator=make, checkpoint=mgr,
            checkpoint_every=CHAOS["chunk"], resume=True))
        skipped = [step for step, _ in mgr.last_skipped]
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    parity = its(chunked) == its(clean) and torch.equal(chunked.x, clean.x)
    resume_parity = its(resumed) == its(clean) and torch.equal(resumed.x, clean.x)
    out["checkpoint"] = {"chunk": CHAOS["chunk"], "seconds": t_chunk,
                         "overhead_s": t_chunk - t_clean, "parity": parity,
                         "truncated_step": torn, "skipped": skipped,
                         "resume_s": t_resume, "resume_parity": resume_parity}
    log(f"[chaos] chunked + checkpointed every {CHAOS['chunk']}: {t_chunk:.3f} s against the "
        f"single run's {t_clean:.3f} s (overhead {t_chunk - t_clean:+.3f} s), parity={parity}; "
        f"resume past the truncated step {torn} (skipped {skipped}): {t_resume:.3f} s, "
        f"parity={resume_parity}")
    if not (parity and resume_parity and skipped == [torn]):
        raise AssertionError(f"[chaos] checkpoint: {out['checkpoint']}")

    stale_spec = SolveSpec(k=K, ell=ELL, tol=CHAOS["stale_tol"], maxiter=CHAOS["maxiter"],
                           refresh_aw="stale")
    stale, t_stale = timed(lambda: solve_sequence(systems, bs, stale_spec, make_operator=make))
    out["stale"] = {"tol": CHAOS["stale_tol"], "iterations": its(stale),
                    "rungs": stale.report.rung.tolist(),
                    "status": [SolveStatus.describe(v) for v in stale.report.status.tolist()],
                    "matvecs": stale.info.matvecs.tolist(), "seconds": t_stale}
    log(f"[chaos] refresh_aw='stale' at tol {CHAOS['stale_tol']:g} (P9): iterations "
        f"{its(stale)}, rungs {out['stale']['rungs']}, statuses {out['stale']['status']}, "
        f"matvecs {out['stale']['matvecs']}, {t_stale:.3f} s")
    if not bool(stale.info.converged.all()):
        raise AssertionError(f"[chaos] stale refresh: a system did not converge: {out['stale']}")

    sh = sqrt_hs[0]
    op = FaultInjectingOperator(make({"sqrt_h": sh}), CHAOS["stall_poison"])
    M = jacobi(1.0 + sh * sh * THETA ** 2)
    stall_spec = SolveSpec(k=K, ell=ELL, tol=CHAOS["stall_tol"], maxiter=CHAOS["maxiter"],
                           precond="jacobi", stagnation_window=CHAOS["window"],
                           recovery_rungs=0)
    res, t_stall = timed(lambda: solve(op, bs[0], stall_spec, M=M, record_residuals=True))
    trace = res.info.residual_norms.tolist()
    status = SolveStatus.describe(res.report.status)
    fired = stall_step(trace, CHAOS["window"])
    out["stagnation"] = {"window": CHAOS["window"], "iterations": int(res.info.iterations),
                         "status": status, "rule_step": fired, "seconds": t_stall}
    log(f"[chaos] stall detector (window {CHAOS['window']}, Jacobi, every product + "
        f"{CHAOS['stall_poison']:g}): {status} after {int(res.info.iterations)} iterations "
        f"(the rule on its history: {fired}), {t_stall:.3f} s")
    if status != "STAGNATED" or fired != int(res.info.iterations):
        raise AssertionError(f"[chaos] stagnation: {out['stagnation']}")
    # Frozen steps of the runs over the gated operator (the fault-injecting
    # wrapper has no gate: its frozen products run in full).
    from repro_torch.core import engine

    gated = sum(frozen_steps(i, ELL, engine.CHUNK)
                for run in (clean, off, chunked, resumed, stale) for i in its(run))
    out["gated_frozen_steps"] = gated
    log(f"[chaos] K3 calls of frozen steps, gated off on the card: {gated}")
    return out


def phase_lane_kernels(torch, cf, rbf, kernels, device="cuda", n=PAPER_N, n7=None):
    """The lane axis of K1's, K6's and K2's step arms
    (``tests/torch_lane_cases.py``: K1's step, K6's step and K2's step
    chained as the preconditioned def-CG loop runs them, per-lane scalars
    as strided views, live, frozen, indefinite and diverging lanes) at
    main's n = 36 551, f64: at B = 1, 8 and 64, k = 8 plain and recording
    and k = 0, and armed with the stall detector at B = 8, every lane bit
    for bit the one-lane arm on that lane's data (SHA-256 digests of both),
    two launches bit for bit, and the lane-by-lane plain versions to the
    f64 bar (flags, counts and statuses exactly).  Then each lane arm timed
    at B = 8 and 64 beside B one-lane calls, and the gated K3 / K8 calls
    with every flag off: zeros, timed beside the ungated calls.  K7's step
    arm likewise at main-lsq's n (``n7``; :func:`lsmr_lane_kernels`)."""
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import torch_lane_cases as lc

    n7 = LSQ_MAIN["n"] if n7 is None else n7

    out = {"digests": {}, "max_abs_err": 0.0}
    cases = [(lanes, K, mode) for lanes in LANE_SIZES for mode in ("plain", "recording")]
    cases += [(lanes, 0, "plain") for lanes in LANE_SIZES] + [(8, K, "armed")]
    for lanes, k, mode in cases:
        t = lc.lane_step_inputs(torch, device, torch.float64, lanes, n, k, mode=mode,
                                seed=lanes + k)
        full, per_lane = lc.run_lane_arms(torch, cf, t)
        again = lc.run_steps(torch, cf, t)
        plain = lc.run_steps(torch, cf, t, arms="plain")
        what = f"B={lanes} k={k} {mode}"
        bad = lc.lane_mismatches(torch, full, per_lane) + lc.lane_mismatches(torch, full, again)
        bad += [key for key in ("jo", "bo", "k1r_js", "k1r_flags")
                if not torch.equal(full[key], plain[key])]
        for key, got in full.items():
            if got.dtype.is_floating_point:
                want = torch.nan_to_num(plain[key])
                scale = max(1.0, float(want.abs().max()))
                err = float((torch.nan_to_num(got) - want).abs().max()) / scale
                out["max_abs_err"] = max(out["max_abs_err"], err)
                if err > TOL["float64"]:
                    bad.append(f"{key} {err:.2e}")
        if bad:
            raise AssertionError(f"[lanes] {what}: {bad}")
        out["digests"][what] = [lc.digest(torch, full)[:16], lc.digest(torch, per_lane)[:16]]
    log(f"[lanes] K1, K6 and K2 lane arms at n={n}, B in {LANE_SIZES}: every lane bit "
        f"for bit the one-lane arm, repeats bit for bit, plain versions within "
        f"{out['max_abs_err']:.1e}; digests {out['digests']}")

    timings = {}
    for lanes in (8, 64):
        t = lc.lane_step_inputs(torch, device, torch.float64, lanes, n, K, seed=3)
        ap = t["ap"]
        so = torch.zeros(lanes, 4 + K, dtype=torch.float64, device=device)
        on = torch.ones(lanes, dtype=torch.bool, device=device)
        k1 = lambda: cf.fused_cg_step_cuda(  # noqa: E731
            t["x"], t["r"], t["p"], ap, t["d"], t["rs"], t["rnorm"], t["js"], t["active"],
            t["threshold"], t["diverged_at"], 10, t["aw"], t["waw_inv"])
        k6 = lambda: cf.fused_rz_step_cuda(t["r"], t["z"], t["rs"], t["aw"],  # noqa: E731
                                           t["waw_inv"])
        k2 = lambda: cf.fused_direction_step_cuda(t["z"], t["p"], so[:, 1], on,  # noqa: E731
                                                  t["w"], so[:, 2:2 + K])
        one1 = lambda: [cf.fused_cg_step_cuda(  # noqa: E731
            t["x"][i], t["r"][i], t["p"][i], ap[i], t["d"][i], t["rs"][i], t["rnorm"][i],
            t["js"][i], t["active"][i], t["threshold"][i], t["diverged_at"][i], 10,
            t["aw"][i], t["waw_inv"][i]) for i in range(lanes)]
        for name, fn in (("K1 step", k1), ("K6 step", k6), ("K2 step", k2),
                         ("K1 step, one lane at a time", one1)):
            timings[f"{name} B={lanes}"] = device_ms(torch, fn)
    out["timings"] = timings
    log(f"[lanes] f64 n={n} k={K}: " + ", ".join(f"{k} {v:.4f} ms" for k, v in timings.items()))
    for name, key in (("fused_cg_update", "K1 step"), ("fused_rz_reduce", "K6 step"),
                      ("fused_deflate_direction", "K2 step")):
        kernels[name]["lane_arm_ms"] = {f"B={b}": timings[f"{key} B={b}"] for b in (8, 64)}
    out["k7"] = lsmr_lane_kernels(torch, cf, lc, kernels, device, n7)

    # The gate: every flag off, the product is zeros and skips its tiles.
    x, v = rbf_inputs(torch, n, D, 1, torch.float64, 7, device)
    off = torch.zeros(8, 2, dtype=torch.bool, device=device)[:, 0]
    y = rbf.rbf_matvec_cuda(x, v, THETA, LENGTHSCALE, gate=off)
    xr = x[:4096].contiguous()
    yr = rbf.rbf_matvec_rect_cuda(xr, x[:16384], v[:16384], THETA, LENGTHSCALE, gate=off[:1])
    if bool(y.any()) or bool(yr.any()):
        raise AssertionError("[lanes] a gated-off K3 / K8 call wrote a nonzero")
    gate = {"k3_gated_off_ms": device_ms(torch, lambda: rbf.rbf_matvec_cuda(
                x, v, THETA, LENGTHSCALE, gate=off)),
            "k3_ungated_ms": kernels["rbf_matvec"]["ms"],
            "k8_gated_off_ms": device_ms(torch, lambda: rbf.rbf_matvec_rect_cuda(
                xr, x[:16384], v[:16384], THETA, LENGTHSCALE, gate=off[:1])),
            "k8_ungated_ms": kernels["rbf_matvec_rect"]["ms"]}
    out["gate"] = gate
    kernels["rbf_matvec"]["gated_off_ms"] = gate["k3_gated_off_ms"]
    kernels["rbf_matvec_rect"]["gated_off_ms"] = gate["k8_gated_off_ms"]
    log(f"[lanes] gated-off K3 n={n} r=1: zeros, {gate['k3_gated_off_ms']:.4f} ms (ungated "
        f"{gate['k3_ungated_ms']:.2f} ms); gated-off K8 4096 x 16384: zeros, "
        f"{gate['k8_gated_off_ms']:.4f} ms (ungated {gate['k8_ungated_ms']:.3f} ms)")
    return out


def lsmr_lane_kernels(torch, cf, lc, kernels, device, n):
    """K7's step arm on the lane axis (``tests/torch_lane_cases.py``'s LSMR
    case: live, frozen, converging, diverging and exactly terminating
    lanes, ``s`` rows of a wider buffer, the other per-lane scalars strided
    views) at main-lsq's n, f64: B = 1, 8, 64 unarmed and B = 8 armed
    (window 10).  Every lane bit for bit the one-lane arm on its data
    (SHA-256 digests of both), two launches bit for bit, the lane-by-lane
    plain version to the f64 bar (``s`` and the trace too; flags, counts
    and statuses exactly).  Then the lane arm timed at B = 8 and 64 beside
    B one-lane calls, with its bound (B × the one-lane arm's bytes)."""
    out = {"digests": {}, "max_abs_err": 0.0}
    cases = [(lanes, 0) for lanes in LANE_SIZES] + [(8, LSMR_LANE_WINDOW)]
    for lanes, window in cases:
        t = lc.lsmr_lane_inputs(torch, device, torch.float64, lanes, n, window=window,
                                seed=lanes + window)
        full, per_lane = lc.run_lsmr_lane_arms(torch, cf, t)
        again = lc.run_lsmr_steps(torch, cf, t)
        plain = lc.run_lsmr_steps(torch, cf, t, arms="plain")
        what = f"B={lanes} window={window}"
        bad = lc.lane_mismatches(torch, full, per_lane) + lc.lane_mismatches(torch, full, again)
        bad += [key for key in ("jo", "ao") if not torch.equal(full[key], plain[key])]
        for key, got in full.items():
            if got.dtype.is_floating_point:
                want = torch.nan_to_num(plain[key])
                scale = max(1.0, float(want.abs().max()))
                err = float((torch.nan_to_num(got) - want).abs().max()) / scale
                out["max_abs_err"] = max(out["max_abs_err"], err)
                if err > TOL["float64"]:
                    bad.append(f"{key} {err:.2e}")
        if bad:
            raise AssertionError(f"[lanes] K7 {what}: {bad}")
        out["digests"][what] = [lc.digest(torch, full)[:16], lc.digest(torch, per_lane)[:16]]
    log(f"[lanes] K7 lane arm at n={n}, B in {LANE_SIZES} and armed (window "
        f"{LSMR_LANE_WINDOW}) at B=8: every lane bit for bit the one-lane arm, repeats bit "
        f"for bit, plain version within {out['max_abs_err']:.1e}; digests {out['digests']}")

    timings = {}
    for lanes in (8, 64):
        t = lc.lsmr_lane_inputs(torch, device, torch.float64, lanes, n, seed=5)
        args = [t[key] for key in lc.LSMR_ARGS]

        def lane_call(args=args):
            cf.lsmr_step_cuda(*args)

        def one_lane_calls(args=args, lanes=lanes):
            for i in range(lanes):
                cf.lsmr_step_cuda(*(a[i] if isinstance(a, torch.Tensor) else a for a in args))

        timings[f"K7 step B={lanes}"] = device_ms(torch, lane_call)
        timings[f"K7 step, one lane at a time B={lanes}"] = device_ms(torch, one_lane_calls)
    out["timings"] = timings
    one_bound = kernels["lsmr_update"]["bound_ms"]
    entry = kernels["lsmr_update"]
    entry["lane_arm_ms"] = {f"B={b}": timings[f"K7 step B={b}"] for b in (8, 64)}
    entry["lane_one_lane_calls_ms"] = {
        f"B={b}": timings[f"K7 step, one lane at a time B={b}"] for b in (8, 64)}
    entry["lane_bound_ms"] = {f"B={b}": b * one_bound for b in (8, 64)}
    entry["max_abs_err"] = max(entry["max_abs_err"], out["max_abs_err"])
    log(f"[lanes] K7 f64 n={n}: " + ", ".join(f"{k} {v:.4f} ms" for k, v in timings.items())
        + f"; bound {entry['lane_bound_ms']['B=8']:.5f} / {entry['lane_bound_ms']['B=64']:.5f}"
        " ms (B × the one-lane arm's bytes at 3.35 TB/s)")
    return out


def newton_systems(torch, k_dense, y, num, inner_tol):
    """``seq_bench.strategy_matrix_bench``'s genuine Newton sequence: per
    Newton iterate ``(H½, b)`` of the Laplace mode's Newton system, the
    iterate advanced by an exact (CG at ``inner_tol``) inner solve."""
    from repro_torch.core import KernelSystemOperator, cg

    n = y.shape[0]
    f = torch.zeros(n, dtype=k_dense.dtype, device=k_dense.device)
    shs, bs = [], []
    for _ in range(num):
        pi = torch.sigmoid(f)
        grad, hdiag = (y + 1.0) / 2.0 - pi, pi * (1.0 - pi)
        sh = torch.sqrt(hdiag)
        bg = hdiag * f + grad
        b = sh * (k_dense @ bg)
        shs.append(sh)
        bs.append(b)
        xs = cg(KernelSystemOperator(lambda v: k_dense @ v, sh), b, tol=inner_tol,
                maxiter=20 * n).x
        f = k_dense @ (bg - sh * xs)
    return torch.stack(shs), torch.stack(bs)


def phase_strategies(torch, y, k_dense, device="cuda"):
    """``benchmarks/seq_bench.py``'s strategy matrix at main's n on main's
    dense K: six genuine Newton systems, def-CG(8, 12), tol 1e-5, for
    HarmonicRitz, WindowedRecombine and MGeometryHarmonic (with Jacobi):
    iterations, matvecs and seconds per system; every system must meet
    the tolerance's residual."""
    from repro_torch.core import (
        KernelSystemOperator,
        MGeometryHarmonic,
        SolveSpec,
        WindowedRecombine,
        jacobi,
        solve_sequence,
    )

    _sync(torch, device)
    t0 = time.perf_counter()
    shs, bs = newton_systems(torch, k_dense, y, STRATEGY["num"], STRATEGY["inner_tol"])
    _sync(torch, device)
    out = {"n": y.shape[0], "systems": STRATEGY["num"], "setup_s": time.perf_counter() - t0}
    common = dict(k=K, ell=ELL, tol=STRATEGY["tol"], maxiter=STRATEGY["maxiter"])
    cases = (("harmonic", SolveSpec(**common), None),
             ("windowed", SolveSpec(strategy=WindowedRecombine(), **common), None),
             ("mgeometry", SolveSpec(precond="jacobi", strategy=MGeometryHarmonic(), **common),
              lambda op: jacobi(1.0 + op.sqrt_h ** 2 * THETA ** 2)))

    def make(sh):
        return KernelSystemOperator(lambda v: k_dense @ v, sh)

    for name, spec, make_prec in cases:
        _sync(torch, device)
        t0 = time.perf_counter()
        seq = solve_sequence(shs, bs, spec, make_operator=make, make_preconditioner=make_prec)
        _sync(torch, device)
        secs = time.perf_counter() - t0
        res = [float(torch.linalg.norm(bs[i] - make(shs[i])(seq.x[i])) / torch.linalg.norm(bs[i]))
               for i in range(STRATEGY["num"])]
        its = [int(v) for v in seq.info.iterations.tolist()]
        mvs = [int(v) for v in seq.info.matvecs.tolist()]
        out[name] = {"iterations": its, "matvecs": mvs, "seconds": secs,
                     "ms_per_system": 1e3 * secs / STRATEGY["num"], "residuals": res,
                     "total_matvecs": sum(mvs)}
        log(f"[strategies] {name:9s} n={y.shape[0]}: iterations {its}, matvecs {mvs} (total "
            f"{sum(mvs)}), {1e3 * secs / STRATEGY['num']:.1f} ms a system, worst relative "
            f"residual {max(res):.1e}")
        if not bool(seq.info.converged.all()) or max(res) > 10 * STRATEGY["tol"]:
            raise AssertionError(f"[strategies] {name}: {out[name]}")
    return out


def phase_batch(torch, x, k_dense, cf, device="cuda"):
    """``benchmarks/batch_bench.py``'s tenants at main's n on main's dense K:
    B = 1, 8, 64 tenants through ``solve_batch`` (one (n, B) product an
    iteration, the lane arms) against B sequential ``solve`` calls:
    per-tenant iterations, wall time of the batch against the loop, and
    (B = 8, ``torch.profiler``) device launches per batched iteration.
    Then one matrix-free batch over K3 (B = 8: one K3 call of r = 8 an
    iteration), one Jacobi-preconditioned batch (B = 8: K6's lane arm) and
    one ``solve_pool_step`` with half the slots idle (their states
    bit-untouched, their info scrubbed)."""
    from repro_torch.core import (
        KernelSystemOperator,
        RBFKernelSystemOperator,
        SolveSpec,
        jacobi,
        solve,
        solve_batch,
        solve_pool_step,
    )

    spec = SolveSpec(k=K, ell=ELL, tol=BATCH["tol"], maxiter=BATCH["maxiter"])

    def kmv(v):
        return k_dense @ v

    timed = functools.partial(_timed, torch, device)

    out = {"n": x.shape[0]}
    for lanes in BATCH["sizes"]:
        shs, bs = chaos_trace(torch, x, lanes)
        before = dict(cf.LAUNCHES)
        batch, t_batch = timed(lambda: solve_batch(KernelSystemOperator(kmv, shs), bs, spec))
        launched = {k: cf.LAUNCHES[k] - before[k] for k in before}
        looped = min(lanes, BATCH["loop_lanes"])  # the loop's tenants, timed and scaled
        singles, t_looped = timed(lambda: [solve(KernelSystemOperator(kmv, shs[i]), bs[i], spec)
                                           for i in range(looped)])
        t_loop = t_looped * lanes / looped
        its_b = [int(v) for v in batch.info.iterations.tolist()]
        its_s = [int(r.info.iterations) for r in singles]
        diff = [a - b for a, b in zip(its_b, its_s)]
        xerr = max(float(torch.linalg.norm(batch.x[i] - singles[i].x)
                         / torch.linalg.norm(singles[i].x)) for i in range(looped))
        entry = {"iterations": its_b, "sequential_iterations": its_s,
                 "iteration_differences": diff, "batch_s": t_batch, "loop_s": t_loop,
                 "looped_tenants": looped, "looped_s": t_looped,
                 "speedup": t_loop / t_batch, "x_rel_diff": xerr, "launches": launched,
                 "step_launches_per_iteration": launched["fused_cg_update"] / max(its_b)}
        out[f"B={lanes}"] = entry
        scaled = f" (its first {looped} tenants, x{lanes / looped:g})" if looped < lanes else ""
        log(f"[batch] B={lanes}: iterations {its_b[:8]}{'…' if lanes > 8 else ''} (sequential "
            f"differ by {sorted(set(diff))}), batch {t_batch:.3f} s vs loop {t_loop:.3f} s"
            f"{scaled} ({t_loop / t_batch:.1f}x), x within {xerr:.1e}, K1 launches per batched "
            f"iteration {entry['step_launches_per_iteration']:.2f}")
        # A lane's pᵀAp and the (n, B) product sum in another order than a
        # sequential solve's dot and GEMV; at ~185 iterations that moves a
        # count by a few (P1), so the counts are reported, the answers held.
        if not bool(batch.info.converged.all()) or xerr > 1e-4:
            raise AssertionError(f"[batch] B={lanes}: {entry}")
        if lanes == BATCH["pool"]:
            pool_state, pool_data = batch.state, (shs, bs)
        del singles, batch

    # Device launches per batched iteration at B = 8, counted apart.
    from torch.profiler import ProfilerActivity, profile

    shs, bs = pool_data
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        prof_run = solve_batch(KernelSystemOperator(kmv, shs), bs, spec)
        _sync(torch, device)
    count = sum(e.count for e in prof.key_averages() if _is_device(e) and _device_us(e) > 0)
    out["profile_B8"] = {"device_launches": count,
                         "iterations": int(prof_run.info.iterations.max()),
                         "launches_per_iteration": count / int(prof_run.info.iterations.max())}
    log(f"[batch] profile B=8: {count} device launches over "
        f"{out['profile_B8']['iterations']} batched iterations "
        f"({out['profile_B8']['launches_per_iteration']:.1f} per iteration, setup and "
        f"extraction included)")

    # Jacobi tenants at B = 8: K6's lane arm after each M⁻¹r.
    shs, bs = pool_data
    pspec = SolveSpec(k=K, ell=ELL, tol=BATCH["tol"], maxiter=BATCH["maxiter"],
                      precond="jacobi")
    before = cf.LAUNCHES["fused_rz_reduce"]
    pre, t_pre = timed(lambda: solve_batch(
        KernelSystemOperator(kmv, shs), bs, pspec,
        make_preconditioner=lambda op: jacobi(1.0 + op.sqrt_h ** 2 * THETA ** 2)))
    its_p = [int(v) for v in pre.info.iterations.tolist()]
    out["jacobi_B8"] = {"iterations": its_p, "seconds": t_pre,
                        "k6_launches": cf.LAUNCHES["fused_rz_reduce"] - before}
    log(f"[batch] Jacobi B={BATCH['pool']}: iterations {its_p}, {t_pre:.3f} s, "
        f"{out['jacobi_B8']['k6_launches']} K6 launches")
    if not bool(pre.info.converged.all()):
        raise AssertionError(f"[batch] Jacobi: {out['jacobi_B8']}")

    # One matrix-free batch: K3 with r = 8 an iteration, gated by the lanes.
    lanes = BATCH["mf_lanes"]
    shs, bs = chaos_trace(torch, x, lanes)
    before = cf.LAUNCHES["rbf_matvec"]
    mf, t_mf = timed(lambda: solve_batch(
        RBFKernelSystemOperator(x, shs, THETA, LENGTHSCALE, block=BLOCK), bs, spec))
    k3 = cf.LAUNCHES["rbf_matvec"] - before
    its_mf = [int(v) for v in mf.info.iterations.tolist()]
    live = max(its_mf)
    frozen = frozen_steps(live, ELL, 8)
    out["matrix_free_B8"] = {"iterations": its_mf, "seconds": t_mf, "k3_calls": k3,
                             "k3_live_calls": live, "k3_gated_calls": frozen,
                             "ms_per_live_k3_call": 1e3 * t_mf / live}
    log(f"[batch] matrix-free B={lanes}: iterations {its_mf}, {t_mf:.2f} s, {k3} K3 calls of "
        f"r = {lanes} ({live} live steps, {frozen} gated frozen steps, the rest setup)")
    if not bool(mf.info.converged.all()) or k3 > live + frozen + 2:
        raise AssertionError(f"[batch] matrix-free: {out['matrix_free_B8']}")

    # One pool step: half the slots idle.
    shs, bs = pool_data
    active = torch.arange(BATCH["pool"], device=device) % 2 == 0
    step = solve_pool_step(KernelSystemOperator(kmv, shs), bs.flip(0).contiguous(), spec,
                           pool_state, active)
    idle = ~active
    untouched = all(torch.equal(getattr(step.state, f)[idle], getattr(pool_state, f)[idle])
                    for f in ("W", "AW", "theta", "systems_solved", "drift"))
    scrubbed = not (step.info.iterations[idle].any() or step.info.matvecs[idle].any()
                    or step.report.status[idle].any() or step.x[idle].any())
    out["pool_step"] = {"active": active.tolist(), "iterations": step.info.iterations.tolist(),
                        "idle_untouched": untouched, "idle_scrubbed": scrubbed}
    log(f"[batch] pool step, slots {active.tolist()}: iterations "
        f"{step.info.iterations.tolist()}, idle states untouched={untouched}, "
        f"scrubbed={scrubbed}")
    if not (untouched and scrubbed and bool(step.info.converged.all())):
        raise AssertionError(f"[batch] pool step: {out['pool_step']}")
    return out


def serve_traffic(torch, tenants, num, k_mv, n, device, seed, drift):
    """``benchmarks/serve_bench.py``'s ``_tenant_traffic``: per tenant a
    drifting Newton sequence over the shared K (latents ~ N(0, 0.5²), b ~
    N(0, 1), the latents drifting by ``drift``·N(0, 1) a system; numpy
    ``default_rng(seed)`` drawn in the bench's order), and the Poisson
    arrival schedule (≈ tenants / 2 a tick).  Returns ``(ops, rhs,
    arrivals)`` by tenant key."""
    import numpy as np

    from repro_torch.core import KernelSystemOperator

    rng = np.random.default_rng(seed)
    ops, rhs = {}, {}
    for t in range(tenants):
        f = rng.standard_normal(n) * 0.5
        systems, bs = [], []
        for _ in range(num):
            pi = 1.0 / (1.0 + np.exp(-f))
            systems.append(KernelSystemOperator(
                k_mv, torch.as_tensor(np.sqrt(pi * (1 - pi)), device=device)))
            bs.append(torch.as_tensor(rng.standard_normal(n), device=device))
            f = f + drift * rng.standard_normal(n)
        ops[f"t{t}"], rhs[f"t{t}"] = systems, bs
    arrivals, remaining = [], [f"t{t}" for t in range(tenants)]
    while remaining:
        batch = min(int(rng.poisson(max(tenants / 2, 1))), len(remaining))
        if batch == 0 and not arrivals:
            batch = 1  # never start with an empty tick
        arrivals.append(remaining[:batch])
        remaining = remaining[batch:]
    return ops, rhs, arrivals


def phase_serve(torch, x, k_dense, device="cuda"):
    """``benchmarks/serve_bench.py`` on main's data and dense K (shared):
    tenants arrive over a Poisson schedule, each with a drifting Newton
    sequence, and ``SolveService`` (B slots) serves every resident tenant's
    next system with one ``solve_pool_step`` a tick (the lane arms of K1 and
    K2, one (n, B) product an iteration), K4 and K5 once a lane a system.
    B = 8 (3 systems a tenant) beside the sequential ``solve`` loop over the
    same tenants, B = 64 (3 a tenant) the pool alone: µs a system, systems
    a second, occupancy, ticks, batched and single steps, evictions, every
    tenant converged.  Then eviction: 6 tenants through 4 slots spilling
    into a temporary directory; the re-admitted tenant's restored state
    must equal its spilled one bit for bit, and its next solve take fewer
    iterations than its cold start.  Between them the B = 1 fence: one
    system through ``solve`` against a pool step of 8 slots with one
    active, three pairs alternating which side runs first."""
    import shutil
    import tempfile

    from repro_torch.core import SolveSpec, solve
    from repro_torch.serve import SolveService

    spec = SolveSpec(k=K, ell=ELL, tol=SERVE["tol"], maxiter=SERVE["maxiter"])
    n = x.shape[0]

    def kmv(v):
        return k_dense @ v

    timed = functools.partial(_timed, torch, device)

    def run_pool(slots, ops, rhs, arrivals, checkpoint_dir=None):
        svc = SolveService(spec, slots=slots, checkpoint_dir=checkpoint_dir)
        tickets = []
        for arriving in arrivals:
            for t in arriving:
                session = svc.session(t)
                tickets += [session.submit(A, b) for A, b in zip(ops[t], rhs[t])]
            svc.tick()
        svc.run_until_idle()
        return svc, [svc.result(tk, drive=False) for tk in tickets]

    def run_loop(ops, rhs):
        outs = []
        for t in ops:
            state = None
            for A, b in zip(ops[t], rhs[t]):
                res = solve(A, b, spec, state)
                state = res.state
                outs.append(res)
        return outs

    out = {"n": n}
    for slots in SERVE["sizes"]:
        num = SERVE["systems"][slots]
        ops, rhs, arrivals = serve_traffic(torch, slots, num, kmv, n, device, slots,
                                           SERVE["drift"])
        total = slots * num
        (svc, results), t_pool = timed(lambda: run_pool(slots, ops, rhs, arrivals))
        snap = svc.metrics_snapshot()["pool"]
        converged = all(r.converged for r in results)
        entry = {"tenants": slots, "systems_per_tenant": num, "systems": total,
                 "arrival_ticks": len(arrivals), "seconds": t_pool,
                 "us_per_system": 1e6 * t_pool / total, "systems_per_s": total / t_pool,
                 "occupancy": snap["mean_serving_occupancy"], "ticks": snap["ticks"],
                 "batched_steps": snap["batched_steps"], "single_steps": snap["single_steps"],
                 "evictions": snap["evictions"], "converged": converged,
                 "iterations": [r.iterations for r in results]}
        if slots in SERVE["loop"]:
            loop, t_loop = timed(lambda: run_loop(ops, rhs))
            xerr = max(float(torch.linalg.norm(r.x - s.x) / torch.linalg.norm(s.x))
                       for r, s in zip(results, loop))
            entry.update(loop_seconds=t_loop, loop_us_per_system=1e6 * t_loop / total,
                         speedup=t_loop / t_pool, loop_converged=all(
                             bool(s.info.converged) for s in loop), x_rel_diff=xerr,
                         iteration_differences=sorted({
                             r.iterations - int(s.info.iterations)
                             for r, s in zip(results, loop)}))
            converged = converged and entry["loop_converged"] and xerr <= 1e-4
        out[f"B={slots}"] = entry
        loop_txt = (f" | loop {entry['loop_us_per_system']:.0f} us/system "
                    f"({entry['speedup']:.2f}x), counts differ by "
                    f"{entry['iteration_differences']}, x within {entry['x_rel_diff']:.1e}"
                    if "loop_seconds" in entry else "")
        log(f"[serve] B={slots} n={n} T={slots}x{num}: pool {entry['us_per_system']:.0f} "
            f"us/system ({entry['systems_per_s']:.1f} sys/s){loop_txt} | occupancy "
            f"{entry['occupancy']:.2f} ticks {entry['ticks']} batched {entry['batched_steps']} "
            f"single {entry['single_steps']} evictions {entry['evictions']} "
            f"converged={converged}")
        if not converged:
            raise AssertionError(f"[serve] B={slots}: {entry}")
        del svc, results, ops, rhs

    # The B = 1 fence: one tenant's system through plain solve against a
    # pool step of 8 slots with only its slot active, three pairs with
    # the side that runs first alternating.
    from repro_torch.core import solve_pool_step

    slots = SERVE["loop"][0]
    ops, rhs, _ = serve_traffic(torch, slots, 1, kmv, n, device, 2, SERVE["drift"])
    keys = list(ops)
    onehot = torch.arange(slots, device=device) == 0

    def fence_solve():
        return solve(ops[keys[0]][0], rhs[keys[0]][0], spec)

    def fence_pool():
        return solve_pool_step([ops[t][0] for t in keys], torch.stack([rhs[t][0] for t in keys]),
                               spec, None, onehot)

    t_one, t_pooled = [], []
    for pair in range(3):
        for side in ((fence_solve, fence_pool) if pair % 2 == 0 else (fence_pool, fence_solve)):
            res, sec = timed(side)
            if side is fence_solve:
                one = res
                t_one.append(sec)
            else:
                pooled = res
                t_pooled.append(sec)
    ratios = sorted(p / o for o, p in zip(t_one, t_pooled))
    out["fence"] = {"slots": slots, "solve_s": t_one, "pool_step_s": t_pooled,
                    "pool_over_solve": ratios, "iterations": int(one.info.iterations),
                    "pool_iterations": int(pooled.info.iterations[0])}
    log(f"[serve] B = 1 fence: one system through solve {[f'{t:.3f}' for t in t_one]} s "
        f"({out['fence']['iterations']} iterations) against a {slots}-slot pool step with "
        f"one slot active {[f'{t:.3f}' for t in t_pooled]} s "
        f"({out['fence']['pool_iterations']} iterations), three pairs alternating which runs "
        f"first: pool / solve {ratios[1]:.2f}x (spread {ratios[0]:.2f}-{ratios[2]:.2f}x)")

    # Eviction: 6 tenants through 4 slots, spilling to disk.
    tenants = [f"t{i}" for i in range(SERVE["evict_tenants"])]
    ops, rhs, _ = serve_traffic(torch, len(tenants), 2, kmv, n, device, 1, SERVE["drift"])
    spill = tempfile.mkdtemp(prefix="serve_spill_")
    try:
        svc = SolveService(spec, slots=SERVE["evict_slots"], checkpoint_dir=spill)
        first = tenants[:SERVE["evict_slots"]]
        tickets = {t: svc.session(t).submit(ops[t][0], rhs[t][0]) for t in first}
        svc.run_until_idle()
        cold = {t: svc.result(tk, drive=False) for t, tk in tickets.items()}
        kept = svc.pool.slot_state(svc.pool.slot_of(tenants[0]))
        later = {t: svc.session(t).submit(ops[t][0], rhs[t][0])
                 for t in tenants[SERVE["evict_slots"]:]}
        svc.run_until_idle()
        evicted = [t for t in first if not svc.pool.resident(t)]
        restored = svc.store.restore(tenants[0], svc.pool.zero_slot_state())
        bit_for_bit = all(torch.equal(getattr(kept, f), getattr(restored, f))
                          for f in ("W", "AW", "theta", "systems_solved", "drift"))
        back = svc.session(tenants[0]).solve(ops[tenants[0]][1], rhs[tenants[0]][1])
        snap = svc.metrics_snapshot()
        later_ok = all(svc.result(tk, drive=False).converged for tk in later.values())
    finally:
        shutil.rmtree(spill, ignore_errors=True)
    evict = {"slots": SERVE["evict_slots"], "tenants": len(tenants), "evicted": evicted,
             "restored_bit_for_bit": bit_for_bit, "cold_iterations": cold[tenants[0]].iterations,
             "readmitted_iterations": back.iterations, "restores": snap["pool"]["restores"],
             "evictions": snap["pool"]["evictions"], "single_steps": snap["pool"]["single_steps"],
             "converged": all(r.converged for r in cold.values()) and later_ok and back.converged}
    out["eviction"] = evict
    log(f"[serve] eviction: {len(tenants)} tenants through {SERVE['evict_slots']} slots, "
        f"evicted {evicted}, {tenants[0]}'s spilled state restored bit for bit: "
        f"{bit_for_bit}; its re-admitted solve {back.iterations} iterations against "
        f"{cold[tenants[0]].iterations} cold; evictions {evict['evictions']}, restores "
        f"{evict['restores']}")
    if not (bit_for_bit and evict["converged"] and tenants[0] in evicted
            and back.iterations < cold[tenants[0]].iterations and evict["restores"] >= 1):
        raise AssertionError(f"[serve] eviction: {evict}")
    return out


def phase_batch_lsq(torch, cf, device="cuda"):
    """Batched least squares: B = 8 tenants, each its own lsq_bench drifting
    ridge sequence (logspace, drift 0.02, λ = 1e-4, tol 1e-8, 3 systems,
    seeds 0–7) at m = 12 288, n = 8 192 (805 MB a system, 19.3 GB for the
    24), through ``solve_batch(deflsmr(8, 48), sequence=True)`` (one batched
    product of the stack and one of its adjoint an iteration, read in place
    from the (B, N, m, n) tensor, and K7's lane arm) beside the eight
    sequential ``solve_sequence`` runs.  Every system must converge, x
    within 1e-6 relative of the sequential solve, counts within ROADMAP
    P5's bars (8 a system, 3 % in total).  The wall times, the device
    launches per batched LSMR iteration (``torch.profiler``), then one
    ``solve_pool_step(deflsmr)`` with half the slots idle: their states
    bit-untouched, their info scrubbed."""
    from repro_torch.core import (
        DenseMatrixOperator,
        SolveSpec,
        solve_batch,
        solve_pool_step,
        solve_sequence,
    )
    from repro_torch.core import operators as ops_mod

    cfg = LSQ_BATCH
    B, N, m, n = cfg["lanes"], cfg["num"], cfg["m"], cfg["n"]

    timed = functools.partial(_timed, torch, device)

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    mats = torch.empty((B, N, m, n), dtype=torch.float64, device=device)
    bs = torch.empty((B, N, m), dtype=torch.float64, device=device)
    for i in range(B):
        for j, (A, b) in enumerate(drifting_lsq(torch, N, m, n, device, seed=i)):
            mats[i, j].copy_(A)
            bs[i, j].copy_(b)
            del A
    _sync(torch, device)
    build_s = time.perf_counter() - t0
    spec = SolveSpec(method="deflsmr", k=LSQ_K, ell=LSQ_ELL, refresh_aw="exact", tol=LSQ_TOL,
                     maxiter=cfg["maxiter"], lsq_shift=LSQ_DAMP)
    batch, t_batch = timed(lambda: solve_batch(mats, bs, spec, make_operator=DenseMatrixOperator,
                                               sequence=True))
    seqs, t_loop = timed(lambda: [solve_sequence(mats[i], bs[i], spec,
                                                 make_operator=DenseMatrixOperator)
                                  for i in range(B)])
    its_b = batch.info.iterations.tolist()
    its_s = [s.info.iterations.tolist() for s in seqs]
    worst = max(abs(a - b) for rb, rs in zip(its_b, its_s) for a, b in zip(rb, rs))
    total_b, total_s = sum(map(sum, its_b)), sum(map(sum, its_s))
    xerr = max(float(torch.linalg.norm(batch.x[i, j] - seqs[i].x[j])
                     / torch.linalg.norm(seqs[i].x[j])) for i in range(B) for j in range(N))
    converged = bool(batch.info.converged.all()) and all(
        bool(s.info.converged.all()) for s in seqs)
    out = {"lanes": B, "systems": N, "m": m, "n": n, "build_s": build_s,
           "batch_s": t_batch, "loop_s": t_loop, "speedup": t_loop / t_batch,
           "iterations": its_b, "sequential_iterations": its_s,
           "worst_system_difference": worst, "total_iterations": total_b,
           "sequential_total_iterations": total_s, "x_rel_diff": xerr, "converged": converged,
           "matvecs": batch.info.matvecs.tolist()}
    log(f"[batch-lsq] B={B} tenants x {N} systems, {m} x {n} f64 ({B * N} systems built in "
        f"{build_s:.1f} s): batch {t_batch:.2f} s vs {B} sequential solve_sequence runs "
        f"{t_loop:.2f} s ({t_loop / t_batch:.2f}x); iterations {its_b} vs {its_s} (worst "
        f"system {worst}, totals {total_b} / {total_s}); x within {xerr:.1e}")
    if not converged or xerr > 1e-6 or worst > 8 or abs(total_b - total_s) > max(
            1, 0.03 * total_s):
        raise AssertionError(f"[batch-lsq] {out}")

    # Device launches per batched LSMR iteration (one product of the stack
    # and its adjoint, K7's lane arm, the eager ops between).
    lane_op = ops_mod.LaneDenseOperator(mats[:, -1])
    out["profile"] = profile_lsmr_steps(torch, lane_op, bs[:, -1].contiguous(), W=batch.state.W,
                                        NW=batch.state.AW)
    prof = out["profile"]
    log(f"[batch-lsq] profile: {prof['launches_per_iteration']:.1f} device launches per "
        f"batched LSMR iteration (B = {B}); device {prof['gemv_ms_per_iteration']:.4f} ms "
        f"products + {prof['other_ms_per_iteration']:.4f} ms other per iteration; kernels "
        f"{prof['kernels']}")

    # One pool step, half the slots idle.
    active = torch.arange(B, device=device) % 2 == 0
    step = solve_pool_step(mats[:, 0], bs[:, 0].flip(0).contiguous(), spec, batch.state,
                           active, make_operator=DenseMatrixOperator)
    idle = ~active
    untouched = all(torch.equal(getattr(step.state, f)[idle], getattr(batch.state, f)[idle])
                    for f in ("W", "AW", "theta", "systems_solved", "drift"))
    scrubbed = not (step.info.iterations[idle].any() or step.info.matvecs[idle].any()
                    or step.report.status[idle].any() or step.x[idle].any())
    out["pool_step"] = {"active": active.tolist(), "iterations": step.info.iterations.tolist(),
                        "idle_untouched": untouched, "idle_scrubbed": scrubbed}
    out["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    log(f"[batch-lsq] pool step, slots {active.tolist()}: iterations "
        f"{step.info.iterations.tolist()}, idle states untouched={untouched}, "
        f"scrubbed={scrubbed}; peak memory {out['peak_memory_gb']:.1f} GB")
    if not (untouched and scrubbed and bool(step.info.converged.all())):
        raise AssertionError(f"[batch-lsq] pool step: {out['pool_step']}")
    return out


def zoo_summary(report):
    """``[summary]`` lines of this slice's cells: main-lm-moe, the zoo, and
    the train cells' remat comparison."""
    mo = report["main-lm-moe"]
    log(f"[summary] main-lm-moe ({mo['arch']}, {mo['batch']} x {mo['prompt']}): prefill "
        f"{mo['prefill_ms']:.1f} ms ({mo['prefill_tokens_per_s']:.0f} tokens/s), decode "
        f"{mo['decode_ms_per_step']:.2f} ms a step, peak {mo['peak_memory_gb']:.1f} GB, routing "
        f"agreement {mo['routing']['agree_share']:.4%}, prefill drops "
        f"{mo['routing']['dropped_share']:.2%}")
    log("[summary] zoo: " + "; ".join(
        f"{arch} {e['layers']} layers: wall {e['wall_s']:.1f} s, peak {e['peak_memory_gb']:.1f} "
        f"GB, launches {e['launches']}" for arch, e in report["zoo"].items()))
    log("[summary] cfg.remat on / off, gradient step s and peak GB: " + "; ".join(
        f"{report[key]['arch']} {r['on']['grad_s']:.3f} / {r['off']['grad_s']:.3f} s, "
        f"{r['on']['peak_memory_gb']:.1f} / {r['off']['peak_memory_gb']:.1f} GB"
        for key in ("train", "train_ssm", "train_moe") if key in report
        for r in [report[key]["remat"]])
        + f"; mamba2 at 4 x 4 096 with remat {report['train_ssm_big']['step_s']:.2f} s, "
        f"{report['train_ssm_big']['peak_memory_gb']:.1f} GB")


def encdec_summary(report):
    """``[summary]`` line of the encoder–decoder's cells: main-lm-encdec and
    train encdec, with K9 at their shapes."""
    se, te = report["main-lm-encdec"], report["train_encdec"]
    share = lambda v: "not measured" if v is None else f"{v:.1%}"  # noqa: E731
    rm = te["remat"]
    log(f"[summary] main-lm-encdec ({se['arch']}, {se['batch']} x {se['source']} frames, "
        f"{se['batch']} x {se['prompt']} tokens): prefill {se['prefill_ms']:.1f} ms "
        f"({se['prefill_tokens_per_s']:.0f} tokens/s), device idle "
        f"{share(se['profile_prefill']['device_idle_share'])}; decode "
        f"{se['decode_ms_per_step']:.2f} ms a step, device idle "
        f"{share(se['profile_decode_8']['device_idle_share'])}; peak {se['peak_memory_gb']:.1f} "
        f"GB; train encdec ({te['batch']} x {te['seq']}): {te['median_step_ms']:.1f} ms a step, "
        f"{te['tokens_per_s']:.0f} tokens/s, MFU {te['mfu']:.1%}, peak "
        f"{te['peak_memory_gb']:.1f} GB; remat on / off {rm['on']['grad_s']:.3f} / "
        f"{rm['off']['grad_s']:.3f} s, {rm['on']['peak_memory_gb']:.1f} / "
        f"{rm['off']['peak_memory_gb']:.1f} GB")


def kernel_entry(name, entry, launches, arms=None):
    out = {"name": name, "route": "cuda", "source": SOURCES[name], "replaces": REPLACES[name],
           "launches": launches, "max_abs_err": entry["max_abs_err"], "ms": entry["ms"],
           "plain_ms": entry["plain_ms"], "bound_ms": entry["bound_ms"],
           "bound_by": entry["bound_by"], "library_ms": entry["library_ms"]}
    if arms:
        out["arms"] = {arm.split(":", 1)[1]: count for arm, count in sorted(arms.items())
                       if arm.split(":", 1)[0] == name}
    return out


_CLOCK = [time.perf_counter()]


def _lap(report, name):
    """Wall seconds since the previous lap, under ``report["phase_s"]``."""
    now = time.perf_counter()
    report.setdefault("phase_s", {})[name] = now - _CLOCK[0]
    _CLOCK[0] = now


def _write_report(report):
    """The full report, ``chiprun_out/chip_smoke.json`` beside the script."""
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke.json"), "w") as fh:
        json.dump(report, fh, indent=1, default=str)


def frozen_steps(iterations, ell, chunk):
    """Masked steps the harness runs past convergence (host reads every
    ``chunk`` steps after the ``ell`` recording steps)."""
    steps = ell
    if iterations > ell:
        steps += chunk * math.ceil((iterations - ell) / chunk)
    return steps - iterations


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    from repro_torch.core import engine
    from repro_torch.data import make_infinite_digits
    from repro_torch.gp import RBFKernel
    from repro_torch.kernels import _build
    from repro_torch.kernels import cg_fused as cf
    from repro_torch.kernels import rbf_matvec as rbf

    report = {}
    # -- 1. device ----------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    card = torch.cuda.get_device_name(0)
    log(smi)
    log(f"[device] {card}, capability {torch.cuda.get_device_capability(0)}, "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    report["card"] = smi
    peaks = peaks_for(card)
    torch.backends.cuda.matmul.allow_tf32 = False

    # -- 2. build -----------------------------------------------------------
    t0 = time.perf_counter()
    sources = sorted(p[:-3] for p in os.listdir(_build.CSRC) if p.endswith(".cu"))
    logs = _build.build(sources)
    report["build_s"] = time.perf_counter() - t0
    log(f"[build] {sources} in {report['build_s']:.1f} s")
    _lap(report, "build")
    for src, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line and "0 bytes spill" not in line:
                log(f"[build] {src}: {line.strip()}")
    report["grad_sass"] = grad_sass(_build)
    report["ssd_grad_sass"] = ssd_grad_sass(_build)

    if "--lm-only" in argv:  # the model zoo's phases alone: no ok line
        lm_kernels, lm_launches = phase_lm(torch, peaks, report)
        totals = {k: sum(launches[k] for launches in lm_launches.values()) for k in lm_kernels}
        log(json.dumps({"kernels": [kernel_entry(k, e, totals[k])
                                    for k, e in lm_kernels.items()]}))
        return 0
    if "--zoo-only" in argv:  # this slice's phases alone: no ok line
        lm_kernels, lm_launches = phase_lm(torch, peaks, report, only="zoo")
        _lap(report, "lm")
        report["zoo"], lm_launches["zoo"] = phase_zoo(torch)
        _lap(report, "zoo")
        grad_k, tr_launches, _ = phase_training(torch, peaks, report, only="zoo")
        lm_launches.update(tr_launches)
        entries = dict(lm_kernels, flash_attention_bwd=grad_k["bwd"],
                       flash_attention_jvp=grad_k["jvp"], ssd_scan_bwd=grad_k["ssd"]["bwd"],
                       ssd_scan_jvp=grad_k["ssd"]["jvp"])
        totals = {k: sum(path.get(k, 0) for path in lm_launches.values()) for k in entries}
        zoo_summary(report)
        log("[summary] wall s a phase: " + ", ".join(f"{k} {v:.1f}" for k, v in
                                                     report["phase_s"].items()))
        _write_report(report)
        log(json.dumps({"kernels": [kernel_entry(k, e, totals[k]) for k, e in entries.items()]}))
        return 0
    if "--encdec-only" in argv:  # this slice's phases alone: no ok line
        lm_kernels, lm_launches = phase_lm(torch, peaks, report, only="encdec")
        _lap(report, "lm")
        grad_k, tr_launches, _ = phase_training(torch, peaks, report, only="encdec")
        lm_launches.update(tr_launches)
        entries = dict(lm_kernels, flash_attention_bwd=grad_k["bwd"],
                       flash_attention_jvp=grad_k["jvp"])
        totals = {k: sum(path.get(k, 0) for path in lm_launches.values()) for k in entries}
        encdec_summary(report)
        log("[summary] wall s a phase: " + ", ".join(f"{k} {v:.1f}" for k, v in
                                                     report["phase_s"].items()))
        _write_report(report)
        log(json.dumps({"kernels": [kernel_entry(k, e, totals[k]) for k, e in entries.items()]}))
        return 0
    if "--dryrun-only" in argv:  # the dry-run on its phases' peaks alone: no ok line
        report["main-lm-encdec"], _ = phase_main_lm(torch, "main-lm-encdec")
        _lap(report, "lm")
        report["train"] = phase_train(torch, peaks, TRAIN)
        _lap(report, "train")
        report["dryrun"] = phase_dryrun(torch, peaks, report)
        _lap(report, "dryrun")
        log("[summary] wall s a phase: " + ", ".join(f"{k} {v:.1f}" for k, v in
                                                     report["phase_s"].items()))
        _write_report(report)
        return 0
    if "--train-only" in argv:  # K9's grad arms, train and hf-lm alone: no ok line
        grad_k, tr_launches, tr_arms = phase_training(torch, peaks, report)
        entries = {"flash_attention": grad_k["lse"], "flash_attention_bwd": grad_k["bwd"],
                   "flash_attention_jvp": grad_k["jvp"], "ssd_scan_bwd": grad_k["ssd"]["bwd"],
                   "ssd_scan_jvp": grad_k["ssd"]["jvp"]}
        totals = {k: sum(path.get(k, 0) for path in tr_launches.values()) for k in entries}
        _write_report(report)
        log(json.dumps({"kernels": [kernel_entry(k, e, totals[k]) for k, e in entries.items()]}))
        return 0

    # -- 3. kernels ---------------------------------------------------------
    kernels = phase_kernels(torch, cf, peaks)
    kernels["rbf_matvec"] = rbf_k = phase_rbf(torch, rbf, peaks)
    kernels["lsmr_update"] = phase_lsmr_kernels(torch, cf, peaks)
    kernels["rbf_matvec_rect"] = phase_rect_kernels(torch, rbf, peaks)
    # K1 and K7 are timed at their step arms, the arms the main paths run
    # (main-shard alone runs K1's TPU-function arm: reduced across ranks
    # before its scalars are used); each entry keeps its TPU-function arm.
    steps = phase_step_kernels(torch, cf, peaks)
    for name, key in (("fused_cg_update", f"fused_cg_update float64 n={PAPER_N}"),
                      ("lsmr_update", f"lsmr_update float64 n={LSQ_MAIN['n']}")):
        entry, t = kernels[name], steps["timings"][key]
        entry.update(tpu_arm={k: entry[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")},
                     step_arm=t, ms=t["ms"], plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
                     bound_by=t["bound_by"],
                     max_abs_err=max([entry["max_abs_err"]] + [
                         v for k, v in steps[name].items() if "float64" in k]))
    kernels["step_timings"] = steps["timings"]
    report["lanes"] = phase_lane_kernels(torch, cf, rbf, kernels)
    _lap(report, "kernels")

    # -- 4. small check: card against CPU ------------------------------------
    xs, ys = make_infinite_digits(400, seed=1, noise=0.10)
    small = {}
    for dev in ("cuda", "cpu"):
        x = torch.as_tensor(xs, dtype=torch.float64, device=dev)
        y = torch.as_tensor(ys, dtype=torch.float64, device=dev)
        small[dev] = laplace_runs(torch, cf.LAUNCHES, x, y, None, 1e-10, f"[check {dev}]")
    for solver, run in small["cuda"].items():
        cpu = small["cpu"][solver]
        if abs(run["logp"] - cpu["logp"]) > 1e-8 * abs(cpu["logp"]):
            raise AssertionError(f"[check] {solver}: card logp {run['logp']} vs CPU {cpu['logp']}")
        if len(run["iterations"]) != len(cpu["iterations"]) or any(
            abs(a - b) > 1 for a, b in zip(run["iterations"], cpu["iterations"])
        ):
            raise AssertionError(f"[check] {solver}: iterations {run['iterations']} vs {cpu['iterations']}")
    report["check"] = small
    # The matrix-free, Jacobi-preconditioned front door: RBF Gram matvec
    # and fused_rz_reduce kernels on the card, their plain versions on the
    # CPU.
    small_mf = {}
    for dev in ("cuda", "cpu"):
        x = torch.as_tensor(xs, dtype=torch.float64, device=dev)
        y = torch.as_tensor(ys, dtype=torch.float64, device=dev)
        small_mf[dev] = laplace_runs(torch, cf.LAUNCHES, x, y, None, 1e-10,
                                     f"[check-mf {dev}]", solvers=("jacobi",), dense=False)
    run, cpu = small_mf["cuda"]["jacobi"], small_mf["cpu"]["jacobi"]
    if abs(run["logp"] - cpu["logp"]) > 1e-10 * abs(cpu["logp"]):
        raise AssertionError(f"[check-mf] card logp {run['logp']} vs CPU {cpu['logp']}")
    if len(run["iterations"]) != len(cpu["iterations"]) or any(
        abs(a - b) > 1 for a, b in zip(run["iterations"], cpu["iterations"])
    ):
        raise AssertionError(f"[check-mf] iterations {run['iterations']} vs {cpu['iterations']}")
    if not (run["launches"]["rbf_matvec"] and run["launches"]["fused_rz_reduce"]):
        raise AssertionError(f"[check-mf] kernels not launched: {run['launches']}")
    report["check_mf"] = small_mf
    _lap(report, "check")

    # -- 5. main path -------------------------------------------------------
    t0 = time.perf_counter()
    xn, yn = make_infinite_digits(PAPER_N, seed=0, noise=0.10)
    data_s = time.perf_counter() - t0
    x = torch.as_tensor(xn, dtype=torch.float64, device="cuda")
    y = torch.as_tensor(yn, dtype=torch.float64, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    k_dense = RBFKernel(theta=THETA, lengthscale=LENGTHSCALE).gram(x)
    torch.cuda.synchronize()
    gram_s = time.perf_counter() - t0
    log(f"[main] n={PAPER_N}: digits {data_s:.1f} s (CPU), dense K {gram_s:.3f} s")
    ones = torch.ones(PAPER_N, dtype=torch.float64, device="cuda")
    gemv_ms = device_ms(torch, lambda: k_dense @ ones)
    log(f"[main] dense GEMV K @ v: {gemv_ms:.4f} ms")

    # The main path: the paper's solver tol 1e-5.  Its counts alone go into
    # the kernels line.
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    runs = laplace_runs(torch, cf.LAUNCHES, x, y, k_dense, 1e-5, "[main]")
    launches = dict(cf.LAUNCHES)
    arms = {"main": _arms()}
    plain_on_cuda = dict(cf.PLAIN_ON_CUDA)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"[main] launches {launches}; plain versions on the card {plain_on_cuda}; "
        f"peak memory {peak_gb:.2f} GB")
    # The agreement check at solver tol 1e-10, counted on its own.
    _zero_counts()
    tight = laplace_runs(torch, cf.LAUNCHES, x, y, k_dense, 1e-10, "[main tol=1e-10]",
                         solvers=("cg", "defcg", "spec"))
    tight_launches = dict(cf.LAUNCHES)
    tight_plain = dict(cf.PLAIN_ON_CUDA)
    log(f"[main tol=1e-10] launches {tight_launches}; plain versions on the card "
        f"{tight_plain}")

    # Launches per deflated def-CG iteration, without and with the Jacobi
    # preconditioner, counted apart from the runs.
    report["defcg_profile"] = profile_defcg_steps(torch, k_dense)
    report["pdefcg_profile"] = profile_pdefcg_steps(torch, k_dense)
    for what, prof in (("", report["defcg_profile"]), (", Jacobi", report["pdefcg_profile"])):
        log(f"[main] profile def-CG (deflated{what}, k = {K}, n = {PAPER_N}): "
            f"{prof['launches_per_iteration']:.1f} launches per iteration; device "
            f"{prof['gemv_ms_per_iteration']:.4f} ms GEMV + {prof['other_ms_per_iteration']:.4f} ms "
            f"other per iteration; wall {prof['wall_ms_per_iteration_profiled']:.4f} ms per "
            f"iteration under the profiler; kernels {prof['kernels']}")

    # At the paper's solver tol (1e-5) the iterative Newton sequences drift
    # from Cholesky's by far more than the tolerance, by a gap that grows
    # with n (the reference does the same: scripts/paper_tol_witness.py),
    # and may take one more Newton step; the per-step δ (paper Table 1's
    # column) is reported.  The agreement itself is held at solver tol 1e-10.
    chol = runs["cholesky"]
    for solver in ("cg", "defcg", "spec"):
        run = runs[solver]
        deltas = [abs(a - b) / abs(b) for a, b in zip(run["logp_trace"], chol["logp_trace"])]
        run["delta_vs_cholesky"] = deltas
        log(f"[main] {solver:8s} per-step δ vs cholesky (tol 1e-5): "
            + " ".join(f"{d:.1e}" for d in deltas))
        t = tight[solver]
        rel = abs(t["logp"] - chol["logp"]) / abs(chol["logp"])
        t["delta_vs_cholesky"] = rel
        log(f"[main] {solver:8s} tol 1e-10: logp {t['logp']:.10f}, δ vs cholesky {rel:.2e}, "
            f"newton {t['newton_steps']} vs {chol['newton_steps']}")
        if rel > 1e-6 or t["newton_steps"] != chol["newton_steps"]:
            raise AssertionError(f"[main] {solver} at tol 1e-10 disagrees with cholesky")
    cg_after = sum(runs["cg"]["iterations"][1:])
    def_after = sum(runs["defcg"]["iterations"][1:])
    if not def_after < cg_after:
        raise AssertionError(f"[main] def-CG {def_after} iterations after system 1, CG {cg_after}")
    if not all(launches[k] > 0 for k in DENSE_PATH_KERNELS):
        raise AssertionError(f"[main] a kernel never launched: {launches}")
    if any(plain_on_cuda.values()) or any(tight_plain.values()):
        raise AssertionError(
            f"[main] plain versions ran on the card: {plain_on_cuda}, {tight_plain}")
    log(f"[main] iterations after system 1: cg {cg_after}, defcg {def_after} "
        f"({1 - def_after / cg_after:.1%} fewer)")

    frozen = {
        s: sum(frozen_steps(i, ELL if s in ("defcg", "spec") else 0, engine.CHUNK)
               for i in runs[s]["iterations"])
        for s in ("cg", "defcg", "spec")
    }
    log(f"[main] frozen-step matvecs (computed, discarded, not counted): {frozen}; "
        f"at {gemv_ms:.4f} ms each: "
        + ", ".join(f"{s} {c * gemv_ms:.2f} ms" for s, c in frozen.items()))
    # Passes over the 10.7 GB K inside the timed solves: every masked step,
    # the initial residual, and one multi-RHS refresh per carried basis.
    per_pass = {}
    for s in ("cg", "defcg", "spec"):
        run = runs[s]
        refreshes = len(run["iterations"]) - 1 if s != "cg" else 0
        passes = sum(run["iterations"]) + frozen[s] + len(run["iterations"]) + refreshes
        per_pass[s] = 1e3 * run["cumulative_solve_s"][-1] / passes
    log("[main] solve time per pass over K (GEMV "
        f"{gemv_ms:.4f} ms): " + ", ".join(f"{s} {v:.4f} ms" for s, v in per_pass.items()))

    report.update(
        main={"n": PAPER_N, "runs": runs, "tight": tight, "launches": launches,
              "tight_launches": tight_launches, "plain_on_cuda": plain_on_cuda,
              "tight_plain_on_cuda": tight_plain, "peak_memory_gb": peak_gb,
              "gemv_ms": gemv_ms, "gram_s": gram_s, "digits_s": data_s,
              "frozen_step_matvecs": frozen, "solve_ms_per_k_pass": per_pass},
    )
    log(f"[main] RBF Gram matvec f64 r=1: {rbf_k['ms']:.2f} ms against the dense GEMV "
        f"K @ v {gemv_ms:.4f} ms ({rbf_k['ms'] / gemv_ms:.0f}x)")
    chol_logp = runs["cholesky"]["logp"]
    _lap(report, "main")

    # -- 5b. paper: the paper's experiments on the main path's data ---------
    _zero_counts()
    report["paper"] = phase_paper(torch, x, y, k_dense, runs)
    paper_launches = dict(cf.LAUNCHES)
    arms["paper"] = _arms()
    paper_plain = dict(cf.PLAIN_ON_CUDA)
    report["paper"].update(launches=paper_launches, plain_on_cuda=paper_plain)
    log(f"[paper] launches {paper_launches}; plain versions on the card {paper_plain}")
    if not all(paper_launches[k] for k in PAPER_PATH_KERNELS):
        raise AssertionError(f"[paper] a kernel never launched: {paper_launches}")
    if any(paper_plain.values()):
        raise AssertionError(f"[paper] plain versions ran on the card: {paper_plain}")
    _lap(report, "paper")

    # -- 5c. strategies: seq_bench's strategy matrix on main's data ---------
    _zero_counts()
    report["strategies"] = phase_strategies(torch, y, k_dense)
    strat_launches, strat_plain = dict(cf.LAUNCHES), dict(cf.PLAIN_ON_CUDA)
    arms["strategies"] = _arms()
    report["strategies"].update(launches=strat_launches, plain_on_cuda=strat_plain)
    log(f"[strategies] launches {strat_launches}; plain versions on the card {strat_plain}")
    if not all(strat_launches[k] for k in STRATEGY_PATH_KERNELS):
        raise AssertionError(f"[strategies] a kernel never launched: {strat_launches}")
    if any(strat_plain.values()):
        raise AssertionError(f"[strategies] plain versions ran on the card: {strat_plain}")
    _lap(report, "strategies")

    # -- 5d. batch: batch_bench's tenants on main's K --------------------------
    _zero_counts()
    report["batch"] = phase_batch(torch, x, k_dense, cf)
    batch_launches, batch_plain = dict(cf.LAUNCHES), dict(cf.PLAIN_ON_CUDA)
    arms["batch"] = _arms()
    report["batch"].update(launches=batch_launches, plain_on_cuda=batch_plain,
                           arms=arms["batch"])
    log(f"[batch] launches {batch_launches}; arms {arms['batch']}; plain versions on the card "
        f"{batch_plain}")
    lane_arms = ("fused_cg_update:fused_cg_step_lanes", "fused_rz_reduce:fused_rz_step_lanes",
                 "fused_deflate_direction:fused_direction_step_lanes")
    if not all(batch_launches[k] for k in BATCH_PATH_KERNELS) or not all(
            arms["batch"].get(a) for a in lane_arms):
        raise AssertionError(f"[batch] a kernel or lane arm never launched: {arms['batch']}")
    if any(batch_plain.values()):
        raise AssertionError(f"[batch] plain versions ran on the card: {batch_plain}")
    _lap(report, "batch")

    # -- 5e. serve: serve_bench's traffic through SolveService on main's K ----
    _zero_counts()
    report["serve"] = phase_serve(torch, x, k_dense)
    serve_launches, serve_plain = dict(cf.LAUNCHES), dict(cf.PLAIN_ON_CUDA)
    arms["serve"] = _arms()
    report["serve"].update(launches=serve_launches, plain_on_cuda=serve_plain,
                           arms=arms["serve"])
    log(f"[serve] launches {serve_launches}; arms {arms['serve']}; plain versions on the card "
        f"{serve_plain}")
    if not all(serve_launches[k] for k in SERVE_PATH_KERNELS) or not all(
            arms["serve"].get(a) for a in SERVE_LANE_ARMS):
        raise AssertionError(f"[serve] a kernel or lane arm never launched: {arms['serve']}")
    if any(serve_plain.values()):
        raise AssertionError(f"[serve] plain versions ran on the card: {serve_plain}")
    del k_dense
    torch.cuda.empty_cache()
    _lap(report, "serve")

    # -- 6. scale: past what a dense K allows --------------------------------
    report["scale"] = phase_scale(torch, rbf)
    _lap(report, "scale")

    # -- 7. the matrix-free main path -----------------------------------------
    cut = rbf_k["ms"] > CUT_MS
    pre_n = CUT_N if cut else PAPER_N
    if cut:
        xc, yc = (torch.as_tensor(a, dtype=torch.float64, device="cuda")
                  for a in make_infinite_digits(CUT_N, seed=0, noise=0.10))
        log(f"[main-mf] the kernel takes {rbf_k['ms']:.1f} ms > {CUT_MS} ms per call: "
            f"the preconditioned sequences run at n = {CUT_N}")
    else:
        xc, yc = x, y
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    mf = laplace_runs(torch, cf.LAUNCHES, x, y, None, 1e-5, "[main-mf]",
                      solvers=("defcg",), dense=False)
    mf.update(laplace_runs(torch, cf.LAUNCHES, xc, yc, None, 1e-5, f"[main-mf n={pre_n}]",
                           solvers=("jacobi", "nystrom"), dense=False))
    mf_launches = dict(cf.LAUNCHES)
    arms["main_mf"] = _arms()
    mf_plain = dict(cf.PLAIN_ON_CUDA)
    mf_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"[main-mf] launches {mf_launches}; plain versions on the card {mf_plain}; "
        f"peak memory {mf_peak_gb:.2f} GB")
    if not all(mf_launches[k] for k in MF_PATH_KERNELS):
        raise AssertionError(f"[main-mf] a kernel never launched: {mf_launches}")
    if any(mf_plain.values()):
        raise AssertionError(f"[main-mf] plain versions ran on the card: {mf_plain}")
    if cut:  # Cholesky on the cut data (dense K, no kernel), counted apart
        kc = RBFKernel(theta=THETA, lengthscale=LENGTHSCALE).gram(xc)
        chol_cut = laplace_runs(torch, cf.LAUNCHES, xc, yc, kc, 1e-5,
                                f"[main-mf n={pre_n}]", solvers=("cholesky",))["cholesky"]
        del kc
        torch.cuda.empty_cache()
    for solver, run in mf.items():
        if not all(math.isfinite(v) for v in run["logp_trace"]):
            raise AssertionError(f"[main-mf] {solver}: non-finite log p {run['logp_trace']}")
        n_run = PAPER_N if solver == "defcg" else pre_n
        ref = chol_logp if n_run == PAPER_N else chol_cut["logp"]
        steps = run["newton_steps"]
        # K3 calls inside the timed solves: all but b and f of each step.
        # A frozen step's call is gated off on the card (its flag is false:
        # zeros, no Gram tiles), so the live passes carry the time.
        passes = run["launches"]["rbf_matvec"] - 2 * steps
        gated = sum(frozen_steps(i, ELL, engine.CHUNK) for i in run["iterations"])
        run.update(n=n_run, k3_passes=passes, gated_frozen_passes=gated,
                   live_k3_passes=passes - gated,
                   solve_ms_per_k3_pass=1e3 * run["cumulative_solve_s"][-1] / passes,
                   solve_ms_per_live_k3_pass=1e3 * run["cumulative_solve_s"][-1]
                   / (passes - gated),
                   cholesky_logp=ref, delta_vs_cholesky=abs(run["logp"] - ref) / abs(ref),
                   frozen_steps=gated)
        log(f"[main-mf] {solver:8s} n={n_run}: newton {steps}, iterations {run['iterations']}, "
            f"matvecs {run['matvecs']}, solve {run['cumulative_solve_s'][-1]:.2f} s, "
            f"{passes} K3 calls: {passes - gated} live at "
            f"{run['solve_ms_per_live_k3_pass']:.1f} ms each and {gated} gated (frozen steps), "
            f"logp {run['logp']:.10f} vs cholesky {ref:.10f} "
            f"(δ {run['delta_vs_cholesky']:.2e})")
    # Launches per live matrix-free iteration (the gate's `where` and K3's
    # three kernels in place of the GEMV), beside the dense path's.
    mf_prof = profile_defcg_steps(torch, None, x=x)
    log(f"[main-mf] profile: {mf_prof['launches_per_iteration']:.1f} launches per def-CG "
        f"iteration (dense {report['defcg_profile']['launches_per_iteration']:.1f}); device "
        f"{mf_prof['gemv_ms_per_iteration']:.3f} ms K3 + {mf_prof['other_ms_per_iteration']:.4f} "
        f"ms other per iteration")
    report["main_mf"] = {"runs": mf, "launches": mf_launches, "plain_on_cuda": mf_plain,
                         "peak_memory_gb": mf_peak_gb, "preconditioned_n": pre_n,
                         "cut": cut, "profile": mf_prof}
    _lap(report, "main-mf")

    # -- 7b. chaos: failure handling over the matrix-free K3 operator --------
    # At the cut n (its sequence is five passes over the same four systems).
    xch = xc if xc.shape[0] == CHAOS["n"] else torch.as_tensor(
        make_infinite_digits(CHAOS["n"], seed=0, noise=0.10)[0], dtype=torch.float64,
        device="cuda")
    _zero_counts()
    report["chaos"] = phase_chaos(torch, xch)
    del xch
    chaos_launches = dict(cf.LAUNCHES)
    arms["chaos"] = _arms()
    chaos_plain = dict(cf.PLAIN_ON_CUDA)
    report["chaos"].update(launches=chaos_launches, plain_on_cuda=chaos_plain)
    log(f"[chaos] launches {chaos_launches}; plain versions on the card {chaos_plain}")
    if not all(chaos_launches[k] for k in CHAOS_PATH_KERNELS):
        raise AssertionError(f"[chaos] a kernel never launched: {chaos_launches}")
    if any(chaos_plain.values()):
        raise AssertionError(f"[chaos] plain versions ran on the card: {chaos_plain}")
    _lap(report, "chaos")

    # -- 8. agreement: matrix-free against dense where both fit --------------
    # At solver tol 1e-10 the iterations must agree within one per system.
    # The log p is held to 1e-10 at solver tol 1e-12: at 1e-10 the cold
    # first system of the two paths can stop an iteration apart, and the log
    # p gap is then of the solver tolerance's size, in the reference's own
    # dense and matrix-free paths too (scripts/matrix_free_witness.py).
    xa, ya = (torch.as_tensor(a, dtype=torch.float64, device="cuda")
              for a in make_infinite_digits(AGREE_N, seed=0, noise=0.10))
    ka = RBFKernel(theta=THETA, lengthscale=LENGTHSCALE).gram(xa)
    report["agree"] = agree = {"n": AGREE_N}
    for tol in (1e-10, 1e-12):
        dense_run = laplace_runs(torch, cf.LAUNCHES, xa, ya, ka, tol, f"[agree dense {tol:g}]",
                                 solvers=("defcg",))["defcg"]
        mf_run = laplace_runs(torch, cf.LAUNCHES, xa, ya, None, tol, f"[agree mf {tol:g}]",
                              solvers=("defcg",), dense=False)["defcg"]
        rel = abs(mf_run["logp"] - dense_run["logp"]) / abs(dense_run["logp"])
        its_m, its_d = mf_run["iterations"], dense_run["iterations"]
        agree[f"{tol:g}"] = {"dense": dense_run, "matrix_free": mf_run, "logp_rel": rel}
        log(f"[agree] n={AGREE_N} tol {tol:g}: logp matrix-free {mf_run['logp']:.12f} vs dense "
            f"{dense_run['logp']:.12f} (rel {rel:.2e}); iterations {its_m} vs {its_d}")
        if len(its_m) != len(its_d):
            raise AssertionError(f"[agree] tol {tol:g}: Newton steps differ")
        if tol == 1e-10 and any(abs(a - b) > 1 for a, b in zip(its_m, its_d)):
            raise AssertionError(f"[agree] tol {tol:g}: iterations differ by more than one")
        if tol == 1e-12 and rel > 1e-10:
            raise AssertionError(f"[agree] tol {tol:g}: log p differs by {rel:.2e}")

    del ka, xa, ya, x, y, xc, yc
    torch.cuda.empty_cache()
    _lap(report, "agree")

    # -- 9. least squares at lsq_bench's size: card against CPU --------------
    report["check_lsq"] = phase_check_lsq(torch, cf)
    _lap(report, "check-lsq")

    # -- 10. the least-squares main path ----------------------------------------
    _zero_counts()
    lsq, lsq_systems, lsq_state = phase_main_lsq(torch, cf, peaks)
    lsq_launches = dict(cf.LAUNCHES)
    arms["main_lsq"] = _arms()
    lsq_plain = dict(cf.PLAIN_ON_CUDA)
    log(f"[main-lsq] launches {lsq_launches}; plain versions on the card {lsq_plain}")
    if not all(lsq_launches[k] for k in LSQ_PATH_KERNELS):
        raise AssertionError(f"[main-lsq] a kernel never launched: {lsq_launches}")
    if any(lsq_plain.values()):
        raise AssertionError(f"[main-lsq] plain versions ran on the card: {lsq_plain}")
    # Launches per LSMR iteration (eager PyTorch: every scalar op is one),
    # counted apart from the main path's run.
    lsq["profile"] = {
        "cold": profile_lsmr_steps(torch, *lsq_systems[0]),
        "deflated": profile_lsmr_steps(torch, *lsq_systems[-1], W=lsq_state.W, NW=lsq_state.AW),
    }
    for name, prof in lsq["profile"].items():
        log(f"[main-lsq] profile {name}: {prof['launches_per_iteration']:.1f} launches per "
            f"iteration; device {prof['gemv_ms_per_iteration']:.4f} ms GEMV + "
            f"{prof['other_ms_per_iteration']:.4f} ms other per iteration; wall "
            f"{prof['wall_ms_per_iteration_profiled']:.4f} ms per iteration under the profiler")
    report["main_lsq"] = lsq
    _lap(report, "main-lsq")
    del lsq_systems, lsq_state
    torch.cuda.empty_cache()

    # -- 10b. batch-lsq: eight tenants' drifting ridge sequences at once -------
    _zero_counts()
    report["batch_lsq"] = phase_batch_lsq(torch, cf)
    lsq_batch_launches, lsq_batch_plain = dict(cf.LAUNCHES), dict(cf.PLAIN_ON_CUDA)
    arms["batch_lsq"] = _arms()
    report["batch_lsq"].update(launches=lsq_batch_launches, plain_on_cuda=lsq_batch_plain,
                               arms=arms["batch_lsq"])
    log(f"[batch-lsq] launches {lsq_batch_launches}; arms {arms['batch_lsq']}; plain versions "
        f"on the card {lsq_batch_plain}")
    if not all(lsq_batch_launches[k] for k in LSQ_BATCH_PATH_KERNELS) or not arms[
            "batch_lsq"].get("lsmr_update:lsmr_step_lanes"):
        raise AssertionError(f"[batch-lsq] a kernel or K7's lane arm never launched: "
                             f"{arms['batch_lsq']}")
    if any(lsq_batch_plain.values()):
        raise AssertionError(f"[batch-lsq] plain versions ran on the card: {lsq_batch_plain}")
    _lap(report, "batch-lsq")
    torch.cuda.empty_cache()

    # -- 11. Gauss-Newton training ---------------------------------------------
    _zero_counts()
    report["main_gn"], gn_batch, gn_residual = phase_main_gn(torch)
    gn_launches = dict(cf.LAUNCHES)
    arms["main_gn"] = _arms()
    gn_plain = dict(cf.PLAIN_ON_CUDA)
    log(f"[main-gn] launches {gn_launches}; plain versions on the card {gn_plain}")
    if not all(gn_launches[k] for k in GN_PATH_KERNELS):
        raise AssertionError(f"[main-gn] a kernel never launched: {gn_launches}")
    if any(gn_plain.values()):
        raise AssertionError(f"[main-gn] plain versions ran on the card: {gn_plain}")
    report["main_gn"]["launches"] = gn_launches
    # One more step of the recycled run under the profiler, counted apart.
    gn_params, gn_state, gn_cfg = report["main_gn"]["recycled"].pop("final_state")
    prof = profile_gn_step(torch, gn_params, gn_state, gn_batch, gn_residual, gn_cfg)
    report["main_gn"]["cold"].pop("final_state")
    report["main_gn"]["profile"] = prof
    log(f"[main-gn] profile of one more recycled step: {prof['iterations']} LSMR iterations, "
        f"{prof['launches']} device launches, device {prof['gemm_ms']:.2f} ms GEMM + "
        f"{prof['other_ms']:.2f} ms other, wall {prof['wall_ms_profiled']:.2f} ms under the "
        f"profiler (device busy {prof['device_busy_share']:.0%})")
    _lap(report, "main-gn")

    torch.cuda.empty_cache()

    # -- 12./13. the sharded engine: check-shard and main-shard ---------------
    report.update(phase_shard(torch))
    shard_launches = report["main_shard"]["launches_summed"]
    log(f"[main-shard] launches summed over ranks {shard_launches}; K8 alone (kernels "
        f"phase) {kernels['rbf_matvec_rect']['ms']:.2f} ms per call")
    _lap(report, "shard")

    # -- 14.–17. the model zoo's serving paths --------------------------------
    lm_kernels, lm_launches = phase_lm(torch, peaks, report)
    kernels.update(lm_kernels)
    _lap(report, "lm")
    report["zoo"], lm_launches["zoo"] = phase_zoo(torch)
    _lap(report, "zoo")

    # -- 18.–20. K9's differentiated arms, LM training, Hessian-free LM -----
    grad_k, tr_launches, tr_arms = phase_training(torch, peaks, report)
    kernels["flash_attention"]["lse_arm"] = grad_k["lse"]
    kernels["flash_attention_bwd"], kernels["flash_attention_jvp"] = grad_k["bwd"], grad_k["jvp"]
    kernels["ssd_scan_bwd"], kernels["ssd_scan_jvp"] = grad_k["ssd"]["bwd"], grad_k["ssd"]["jvp"]
    kernels["ssd_scan"]["training_fwd_ms"] = grad_k["ssd"]["fwd_ms"]
    lm_launches.update(tr_launches)

    # -- 21. the dry-run against the peaks measured above ---------------------
    report["dryrun"] = phase_dryrun(torch, peaks, report)
    _lap(report, "dryrun")

    names = list(cf.LAUNCHES) + list(SPLIT_ARMS)
    totals = {name: launches.get(name, 0) + paper_launches.get(name, 0)
              + strat_launches.get(name, 0) + batch_launches.get(name, 0)
              + serve_launches.get(name, 0) + mf_launches.get(name, 0)
              + chaos_launches.get(name, 0) + lsq_launches.get(name, 0)
              + lsq_batch_launches.get(name, 0) + gn_launches.get(name, 0)
              + shard_launches.get(name, 0) + sum(lm.get(name, 0) for lm in lm_launches.values())
              for name in names}
    report["launch_totals"] = totals
    # Launches per arm over the paths run in this process (main-shard's
    # ranks are in the totals, not split by arm).
    arms.update({key: report[key]["arms"] for key in LM_PATHS})
    arms.update(tr_arms)
    arm_totals = {}
    for path in arms.values():
        for arm, count in path.items():
            arm_totals[arm] = arm_totals.get(arm, 0) + count
    report["arm_totals"] = arm_totals
    lp = report["main_lsq"]["profile"]
    log(f"[summary] device launches per iteration: damped LSMR (main-lsq) cold "
        f"{lp['cold']['launches_per_iteration']:.1f}, deflated "
        f"{lp['deflated']['launches_per_iteration']:.1f}; deflated def-CG (main, n = {PAPER_N}) "
        f"{report['defcg_profile']['launches_per_iteration']:.1f}, Jacobi-preconditioned "
        f"{report['pdefcg_profile']['launches_per_iteration']:.1f}, matrix-free (main-mf) "
        f"{report['main_mf']['profile']['launches_per_iteration']:.1f}; main-lsq "
        f"{report['main_lsq']['runs']['cold']['ms_per_iteration']:.3f} ms per cold LSMR "
        f"iteration; main-gn device busy {report['main_gn']['profile']['device_busy_share']:.1%}, "
        f"{report['main_gn']['recycled']['ms_per_iteration']:.3f} ms per LSMR iteration (recycled)")
    st, bt = report["strategies"], report["batch"]
    log(f"[summary] strategies (n = {st['n']}): total matvecs harmonic "
        f"{st['harmonic']['total_matvecs']}, windowed {st['windowed']['total_matvecs']}, "
        f"mgeometry {st['mgeometry']['total_matvecs']}; batch B=64 {bt['B=64']['speedup']:.1f}x "
        f"the loop, {bt['profile_B8']['launches_per_iteration']:.1f} device launches per "
        f"batched iteration at B=8; gated-off K3 "
        f"{report['lanes']['gate']['k3_gated_off_ms']:.4f} ms")
    sv, bl = report["serve"], report["batch_lsq"]
    log(f"[summary] serve (n = {sv['n']}): B=8 {sv['B=8']['us_per_system']:.0f} us a system "
        f"({sv['B=8']['speedup']:.2f}x the loop), B=64 {sv['B=64']['us_per_system']:.0f} us a "
        f"system, occupancy {sv['B=8']['occupancy']:.2f} / {sv['B=64']['occupancy']:.2f}; "
        f"eviction restored bit for bit {sv['eviction']['restored_bit_for_bit']}; batch-lsq "
        f"B={bl['lanes']} {bl['batch_s']:.2f} s vs loop {bl['loop_s']:.2f} s "
        f"({bl['speedup']:.2f}x), {bl['profile']['launches_per_iteration']:.1f} device launches "
        f"per batched LSMR iteration; K7 lane arm B=8 "
        f"{report['lanes']['k7']['timings']['K7 step B=8']:.4f} ms, B=64 "
        f"{report['lanes']['k7']['timings']['K7 step B=64']:.4f} ms")
    pp, ch = report["paper"], report["chaos"]
    log(f"[summary] paper (n = {pp['n']}): fig3 slopes cg {pp['fig3']['cg']['mean_slope']:.4f}, "
        f"defcg {pp['fig3']['defcg']['mean_slope']:.4f}; fig4 gap {pp['fig4']['precision_gap']:.2e}; "
        f"chaos (n = {ch['n']}): rungs {ch['recovery']['rungs']}, extra matvecs "
        f"{ch['recovery']['extra_matvecs']}, checkpoint overhead "
        f"{ch['checkpoint']['overhead_s']:+.3f} s, stale rungs {ch['stale']['rungs']}")
    tr, hl = report["train"], report["hf_lm"]
    log(f"[summary] train ({tr['arch']}, {tr['batch']} x {tr['seq']}): "
        f"{tr['median_step_ms']:.1f} ms a step, {tr['tokens_per_s']:.0f} tokens/s, MFU "
        f"{tr['mfu']:.1%}, peak {tr['peak_memory_gb']:.1f} GB, replay bit for bit "
        f"{tr['replay_bit_for_bit']}; hf-lm CG iterations recycled "
        f"{hl['recycled']['total_cg_iters']}, cold {hl['cold']['total_cg_iters']}; K9 backward "
        f"{kernels['flash_attention_bwd']['ms']:.3f} ms (SDPA's backward "
        f"{kernels['flash_attention_bwd']['library_ms']:.3f}), forward mode "
        f"{kernels['flash_attention_jvp']['ms']:.3f} ms at {ATTN_TRAIN}")
    ts, hs = report["train_ssm"], report["hf_lm_ssm"]
    log(f"[summary] train ({ts['arch']}, {ts['batch']} x {ts['seq']}): "
        f"{ts['median_step_ms']:.1f} ms a step, {ts['tokens_per_s']:.0f} tokens/s, MFU "
        f"{ts['mfu']:.1%}, peak {ts['peak_memory_gb']:.1f} GB; hf-lm mamba2 CG iterations "
        f"{[r['cg_iters'] for r in hs['card']]}; K10 backward "
        f"{kernels['ssd_scan_bwd']['ms']:.3f} ms, forward mode "
        f"{kernels['ssd_scan_jvp']['ms']:.3f} ms at {SSD_TRAIN}")
    zoo_summary(report)
    encdec_summary(report)
    dr = report["dryrun"]
    worst = max(dr["checks"], key=lambda k: abs(dr["checks"][k]["rel"]))
    log(f"[summary] dryrun: {len(dr['checks'])} predicted peaks within {DRYRUN_TOL:.0%} of the "
        f"measured (worst {worst}: {dr['checks'][worst]['rel']:+.1%}); GPC iteration n="
        f"{dr['gpc']['scale']['n']} f32 {dr['gpc']['scale']['ms']:.1f} ms (bound "
        f"{dr['gpc']['scale']['bound_ms']:.1f}), n={dr['gpc']['paper']['n']} dry-run peak "
        f"{dr['gpc']['paper']['peak_gb']:.2f} GB")
    log("[summary] wall s a phase: " + ", ".join(f"{k} {v:.1f}" for k, v in
                                                 report["phase_s"].items()))
    kernel_line = {"kernels": [kernel_entry(name, kernels[name], totals[name], arm_totals)
                               for name in names]}
    report["kernels"] = kernels
    _write_report(report)
    log(json.dumps(kernel_line))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
