#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA Hopper card.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. build  — compile every Hopper kernel from ``src/repro_torch/kernels/csrc``
   with nvcc for sm_90a (one process per source, all at once);
2. device — the card's name and power limit as ``nvidia-smi`` prints them;
3. kernels at the main-path shape — frsz2_32 (bs=32, l=32, f64 values) on a
   101-row basis of n = 1,259,712 (``synth:atmosmod --n 1270432``): each
   kernel against its plain PyTorch version on the card (codec bit-equal,
   contractions within 1e-12 relative at r = 101 and r = 51 rows), spot
   checks of f32/f16/bf16 values, l = 8/16, bs = 1/8/64/128 and a ragged n;
   the row codec at 65,536 and 70,000 rows (one launch each, past the first
   design's grid limit) and on views at an offset (``cardcheck.codec_edges``);
   the matvec at 1, 2, 7, 33, 64, 65 and 101 rows, two calls bit-equal,
   x one-hot equal to the decoded basis, and rows whose exponents cross the scaled decode's
   guard (flush zone, 2*bias+1) equal to ``decompress``; the rmatvec
   (slice 12) bit-equal to its row-order plain sum (``ref.rmatvec_rows_ref``:
   one fma a row, rows in order) at those rows, at every f32/f64 spot at
   n = 1001 and on codes one code past a 16-byte word, two calls bit-equal,
   one replay of a captured call equal to the eager call, and rows whose
   codec blocks cross the guard (bs 32 and 2, h one-hot) equal to
   ``decompress``;
   the ELL SpMV on that operator, dense and with a frsz2_32-coded operand,
   bit-equal to its plain version and to a second call, with spot checks of
   f32 values, a ragged column count and bs = 8/64/128; the scaled FRSZ2
   decode through the ELL kernel (an identity operator on coded vectors of
   every l = 16 code and of l = 8 and l = 32 codes, at exponents in the
   flush zone, on the guard's edges and at 2*bias+1, w = 7 and w = 1)
   bit-equal to ``ops.decompress`` after ``+ 0.0``; the Givens step of
   the device cycle over m = 100 steps, bit-equal to its plain version; and
   CUDA-event times (median of 30) beside the byte bound, the plain version
   and a PyTorch call computing the same function (``torch.mv`` on the
   decoded basis, ``torch.sparse_csr_tensor @ x``);
4. solve to convergence — a float16 basis write on the card bit-equal to
   numpy's ``astype(float32).astype(float16)`` (f64 rounded through f32,
   as the JAX reference rounds; numpy's single rounding is counted against
   it), then ``synth:atmosmod`` n = 8000,
   m = 100, frsz2_32 and
   float64, MGS: the device driver (one CUDA graph replay per restart)
   against the host driver (equal iterations, restarts, ``bytes_read`` and
   ``op_reads``, x within 1e-10), two device solves bit-equal, and the
   kernel route against the plain route on the card;
5. full-width solve — ``synth:atmosmod --n 1270432``, m = 100, float64 and
   frsz2_32 with a bounded iteration budget, through ``gmres`` as a user
   calls it, host driver (slice 1's path) and device driver (slice 2's
   path, twice: capture, then replay), each with the launch counts set to 0
   just before and read just after.  The device driver matches the host
   driver as in phase 4; every kernel of a path launched in its frsz2_32
   solve, and no FRSZ2 kernel in the float64 ones;
6. block kernels at the main-path block shape — a frsz2_32 block basis of
   p = 8 segments of n_seg = 1,259,776: the fused block dots and block
   combine against their plain versions (within 1e-12 relative) at 101 and
   51 live block rows, with spot checks (f32 values, p = 1 and 3, a ragged
   n, bs = 1/8/64/128, l = 8/16); the block dots twice, bit-equal, and with
   one-hot rows of W equal to the decoded basis at those columns; the
   block combine bit-equal to the row-order plain sum (one fma a segment
   row, the first combine kernel's sum) at 1, 2, 7, 33, 64, 65 and 101
   block rows (M = 8..808) and in every spot check, twice bit-equal, with
   one-hot rows of Y equal to the decoded basis rows, and across the
   decode guard equal to ``decompress``; the
   batched ELL SpMV (8 operands, one launch, the matrix read once) bit-equal
   to its plain version and to a second call, and at 3 and 16 operands; the
   block Givens step of the
   block cycle bit-equal to its plain version over m = 100 steps at p = 8;
   CUDA-event times beside the bound, the plain version and ``torch.mm``
   on the decoded basis (``torch.sparse_csr_tensor @ X`` for the ELL);
7. block solves (slice 3's path) — ``gmres_batched`` at n = 8000, p = 8,
   m = 100, float64 and frsz2_32: the block device driver against the block
   host driver (equal per-column iterations, restarts, ``bytes_read``,
   ``op_reads``, bits of X), the kernel route against the plain route and
   the vmap baseline; then at full width (n = 1,259,712, p = 8 right-hand
   sides from ``_batch_rhs``, m = 100), block on the device driver twice
   (capture, then replay) and on the host driver, and vmap, each with the
   launch counts set to 0 just before and read just after: every column
   converges, the drivers agree, every kernel of the block path launches in
   the frsz2_32 block solve and no FRSZ2 kernel in the float64 one.
7b. operator planning (slice 5) — ``synth:unstructured`` at n = 1,259,712
   (w = 27, the paper's atmosmodd row count): ``plan_operator(A, 1,
   reorder="rcm")`` on the host, timed, with the raw and RCM bandwidths,
   and a second call that must hit the plan cache (the same object, under
   a second); kernels 5 and 6 (a frsz2_32 operand) on the raw and the
   permuted operator, bit-equal to their plain versions, CUDA-event times
   beside the byte bound (added to the ``ell_spmv`` / ``ell_spmv_frsz2``
   entries as ``unstructured_raw_ms``, ``unstructured_rcm_ms``,
   ``unstructured_bound_ms``); float64 and frsz2_32 device solves, m =
   100, ``reorder="none"`` against ``"rcm"``, each twice: equal restarts,
   iterations within one, x within 1e-9 relative after ``unpermute``,
   equal ``bytes_read``/``op_reads`` and replayed launches when the
   iterations agree, the float64 RRNs within 1e-5 relative and 1e-16
   absolute (``tests/test_reorder.py``'s tolerance; frsz2_32's
   both under the target: FRSZ2's blocks span consecutive entries, which
   the permutation regroups), and the repeated solve capturing no new
   graph; the RCM block solve (p = 8, frsz2_32) with the iterations of
   ``"none"``'s, X within 1e-9; the ``emul:sz_abs:1e-10``,
   ``emul:sz_pwrel:1e-6`` and ``emul:zfp_fr:32`` formats at n = 8000 on
   the device driver (captured, replayed) against the host driver, and
   their roundtrip of a full-width row on the card against the CPU's
   (bit-equal for ``sz_abs`` and ``zfp_fr``; ``sz_pwrel``'s differing
   entries counted), timed beside its byte bound; kernels 5 and 6 on the
   raw and RCM operator are also timed as their plain versions and as
   cuSPARSE (``torch.sparse_csr_tensor @ x``).  With the NCCL group of
   phase 7c, a ``gmres(..., shard=1, reorder="auto")`` frsz2_32 solve of
   the same operator prints the plan's executed mode and must take the
   iterations of the RCM solve.
7c. the sharded solve (slice 6) — a NCCL group of one rank (``file://``
   rendezvous, initialized eagerly on the card before phase 3), and
   ``gmres(..., shard=1, shard_matvec="halo")`` on the full-width
   atmosmodd operator, m = 100, MGS, frsz2_32 and float64, with
   ``shard_transport`` ``plain``, ``compressed`` and ``compressed+norms``,
   each twice (capture, then replay: no new graph, equal bits), the launch
   counts set to 0 just before and read just after: the plain solves equal
   phase 5's unsharded device solves in iterations, restarts,
   ``bytes_read`` and ``op_reads`` with x within 1e-12 relative, the coded
   ones converge to the target within 2 iterations of plain; wall per
   iteration beside the unsharded one.  Before them, kernels 1 and 2 at
   the wire specs (the dots' 101 partials at bs 128, l 16, f32; the halo
   strip of 11,664 values at bs 128, l 32, f64) bit-equal to their plain
   versions and kernel 5 on the halo-localized ELL of the chunk (x with
   its zero halos) bit-equal to its plain version, timed beside their byte
   bounds; then the sharded block solve (p = 8, frsz2_32, plain) against
   phase 7's unsharded one.  Slice 10: the peer reduction (MGS's
   second-pass reductions inside the IF node) at one rank, bit-equal to
   its plain version (NCCL's all-gather, the decode, the sum in rank
   order) at the scalar body's 101 f64, plain and coded, and the block
   body's 101 x 8 x 8 f64, timed beside NCCL's all-reduce; then the
   frsz2_32 plain MGS solve at eta 0.3, where the pass fires at some steps
   only, unsharded and sharded (capture, then the replay under the census,
   the launch counts set to 0 just before and read just after): the route
   ``if+peer_gather``, the unsharded iterations, one replayed cycle
   launching kernels 3 and 4 m + fired times and the peer gather twice a
   fired step, bit-equal to the same cycle run eagerly, the census of the
   cycles' reductions equal to ``cycle_wire_bytes`` with the fired steps,
   the IF bodies holding peer reductions only; the frsz2_32 solve at the
   default eta on the IF route against the select route (route, select,
   select, route; one replayed cycle of each profiled); the gate's MGS
   census at eta 0.3.  With more than one card the same solves
   (and a frsz2_32 coded solve on the plan's own matvec, block3d at P = 4)
   run again on ``device_count()`` spawned NCCL ranks (one a card), each
   captured and replayed with equal bits, converged; plain within an
   iteration of phase 5's solve (NCCL sums in another order), x within
   1e-9; coded within 2 iterations of plain, but for float64, whose 32-bit
   coded halo strips are lossier than its basis (the reference takes the
   same extra iterations: ``tests/test_torch_sharded.py::
   test_coded_halo_costs_float64_iterations_as_in_the_reference``); the
   block solve's columns within an iteration of phase 7's; slice 10's
   eta 0.3 MGS solve, held as at one rank (iterations within one of the
   unsharded solve's), with the gate's MGS census and the reads audit of
   the fixed trajectory at that eta over every rank, the peer reduction's
   times and the two routes over the cards.  Their modelled wire bytes and every rank's
   timeline (start, problem, each plan, capture and replay, teardown) are
   printed; one card skips that by count.

8. decode attention (slice 4's kernel) at the ``decode_32k`` length with
   yi-9b's heads — B = 8, Hkv = 4, G = 8, D = 128, S = 32768, lengths from
   a seed in [1, S] and one full row, FRSZ2 K/V with uint8 exponents, l = 16
   and l = 8: the kernel against its plain version on the card (within
   1e-5 of the largest output), spot checks (D = 64, G = 1/2/3/4/5/6/12
   (5 and 6: llama4's and mixtral's groups), S = 1000, bf16 q, int32
   exponents, a length-1 row; lengths 0, 1, 63, 64, 65, 128, 129 and 317 in
   a cache of 319, across the kernel's 64-position tiles and its splits;
   K/V blocks whose exponents cross the scaled decode's guard, V rows equal
   to ``decompress``, ``kernels/cardcheck.py``), CUDA-event times beside the
   bound, the plain version and ``scaled_dot_product_attention`` on the
   decoded K/V with a length mask, at S = 32768 and at phase 9's serving
   shape (S = 2120, lengths 2048-2112);
9. serving yi-9b at full width and depth (48 layers, bf16, random weights
   from a seed): the teacher-forcing check (prefill + one decode step
   against the parallel forward, B = 2, S = 256) for ``bf16`` and
   ``frsz2_16`` caches, within 5e-2 of the largest logit; then
   ``serve`` as a user calls it, 16 requests over 8 slots, prompt 2048,
   32 new tokens each (64 decode steps, a 2120-position cache) for
   ``frsz2_16``, ``frsz2_8`` and ``bf16``, each with the launch counts set
   to 0 just before and read just after: 32 tokens in range per request,
   finite logits, ``decode_attn`` launched 48 times a decode step in the
   FRSZ2 runs and never in the ``bf16`` one, ``frsz2_cache_write`` (K and V
   of a layer in one launch) once a layer per prefill and decode step and
   ``frsz2_compress`` never (``serve``'s ``stats`` count the prefill's and
   the decode steps' launches apart).  After each FRSZ2 run, on what that
   run served: the last layer's cache codes and exponents bit-equal to the
   plain compress of the K/V that the prefill (B x Hkv x 2048 rows) and the
   last decode step wrote there, and the kernel against its plain version
   on the last decode attention's q, cache and lengths (bf16 q as served,
   within one bf16 step of the largest output; the same q in f32, within
   1e-5 of it).  Then the cache write of one layer at its two serving
   shapes, on the K/V that the ``frsz2_16`` run wrote in its last decode
   step (B 8, T 1) and its prefill (T 2048): ``kvcache.append`` and
   ``kvcache.build_cache`` timed by CUDA events and by the host clock, the
   fused kernel alone and its plain version beside them, all caches equal.
10. serving the MoE family at full width and a cut depth (8 layers of
   each, bf16, random weights from a seed; the depth cut is printed):
   mixtral-8x22b (d 6144, 48/8 heads, 8 experts, top-2, a sliding window
   of 4096, so its cache is a ring of 4096 slots) and then, with
   mixtral's weights released, llama4-scout-17b-a16e (d 5120, 40/8 heads,
   16 experts, top-1).  Each: the teacher-forcing check (prefill of
   S = 5120 tokens, past mixtral's window, and one decode step against
   the parallel forward over 6144 tokens, B = 2, a capacity factor of
   E / k so that no token is dropped) for ``bf16`` and ``frsz2_16``,
   within 5e-2 of the largest logit; ``serve`` as a user calls it, 8
   requests over 8 slots, prompt 4096, 32 new tokens (every mixtral
   decode step writes into the wrapped ring): ``frsz2_16``, ``frsz2_8``
   and ``bf16`` for mixtral, ``frsz2_16`` for llama4, with the launch
   checks of phase 9 (``decode_attn`` 8 times a decode step in the FRSZ2
   runs) and the peak memory; on mixtral's last decode step's q, ring
   cache and lengths, the kernel against the reference's masked softmax
   over the ring (f32 q within 1e-5 of the largest output, bf16 q within
   one bf16 step), timed beside its bound and SDPA on the decoded K/V;
   the cache write into the ring against its plain version: the last
   layer's served cache equal to the plain writes replayed (its prefill
   into the ring and every decode write past it), and the kernel equal
   to plain and timed at the prefill, a prefill rolled into the ring and
   a decode write past it; each decode step's byte bound on the experts
   its kept choices reach, beside the bound with all of them; and
   mixtral's decode steps profiled (``launch.profile``).
11. serving the SSM and hybrid families at full width and full depth
   (bf16, random weights from a seed), one model at a time:
   falcon-mamba-7b (64 Mamba1 layers, d 4096, no attention and no KV
   cache) and zamba2-7b (81 Mamba2 layers, d 3584, one shared attention
   block of 32 heads at head_dim 112 applied after every sixth layer, 13
   times, each application with its own FRSZ2 cache).  Each: the
   teacher-forcing check (prefill of 1023 tokens and one decode step
   against the parallel forward over 1024, B = 2: the scans' chunks are 93
   and 128 positions), within 5e-2 of the largest logit: falcon-mamba in
   bf16, zamba2 on its weights cast to f32 with ``bf16`` and ``frsz2_16``
   caches (in bf16 its 94 blocks amplify last-bit differences past 5e-2;
   that error is measured and printed beside it, a prefill of 1024 against
   a forward over 2048); ``serve`` with phase 9's traffic (16
   requests over 8 slots, prompt 2048, 32 new tokens), for zamba2 in
   ``frsz2_16`` and ``frsz2_8`` (its ``bf16`` run is left out for time):
   tokens in range, finite logits,
   zamba2's ``decode_attn`` and ``frsz2_cache_write`` once an application
   a decode step (13) and the cache write once an application in the
   prefill, ``frsz2_compress`` never, falcon-mamba no launch at all (it
   has no stream for the codec); kernel 9 at D = 112 on the served cache
   against its plain version (f32 q within 1e-5 of the largest output,
   the served bf16 q within one bf16 step), timed beside its bound, the
   plain version and SDPA on the decoded K/V, for l 16 and 8; the cache
   write at D = 112: the last application's served cache equal to the
   plain writes replayed, and the prefill and a decode write timed beside
   their bounds; each step's byte bound (``launch.profile.
   decode_step_bytes``: weights, the shared block once an application,
   the SSM states read and written, the K/V attended), the peak memory and
   the cache's size; two decode steps of each model profiled, the kernels
   that took the most device time listed (their prefills run unprofiled:
   a profiler over falcon-mamba's ~10^5 launches takes minutes).
12. serving the encoder-decoder and VLM families at full width and full
   depth (bf16, random weights from a seed), one model at a time:
   whisper-medium (24 decoder layers, each cross-attending to a 24-layer
   bidirectional encoder's states over 1,536 stub frames; d 1024, 16 heads,
   hd 64) and llama-3.2-vision-11b (40 self layers, a cross block with its
   own MLP after every fifth, over 1,664 stub image tokens; d 4096, 32/8
   heads, hd 128).  Each: the teacher-forcing check (B = 2, S = 256, the
   same frames or image embeddings in the forward) for ``bf16`` and
   ``frsz2_16`` caches, within 5e-2 of the largest logit; ``serve`` as a
   user calls it (its frames or image embeddings drawn by ``serve``), 16
   requests over 8 slots, 32 new tokens: whisper with a prompt of 384 in
   ``frsz2_16``, ``frsz2_8`` and ``bf16``, the VLM with 2048 in
   ``frsz2_16`` and ``frsz2_8``; tokens in range, finite logits, in the
   FRSZ2 runs ``decode_attn`` 48 times a decode step (whisper 24 self + 24
   cross, the VLM 40 + 8), ``frsz2_cache_write`` 24 / 40 a step and 48 in
   the prefill (self and cross), ``frsz2_compress`` never, and neither
   kernel in ``bf16``; every cross cache bit for bit as the prefill left
   it after the decode steps; the last cross layer's codes bit-equal to
   the plain compress of the K/V the prefill wrote there, and that write
   (kernel 1 through ``build_cache``) equal to its plain version and timed
   beside its bound; kernel 9 on the last decode step's cross q and the
   last cross cache (every position valid) against its plain version (f32
   q within 1e-5 of the largest output, the served bf16 q within one bf16
   step), timed beside its bound, the plain version and SDPA on the
   decoded K/V, for l 16 and 8; each step's byte bound
   (``decode_step_bytes``: the weights a step reads, the self K/V
   attended, every cross cache whole), the peak memory and the caches'
   sizes; two decode steps of each model profiled (prefills unprofiled).
13. training at full width: yi-9b (d 4096, 32/4 heads, d_ff 11008, vocab
   64,000, bf16, remat on), 8 of its 48 layers (the gradients and coded
   moments of all 48 pass the card without the reference's FSDP), S 4,096
   (``train_4k``), batch 4 in one microbatch, AdamW with FRSZ2-coded
   moments (bs 128, l 16, f32, nearest) through ``launch.train.train`` as
   a user calls it: 5 steps with a checkpoint every 3, so one at step 3
   (finite losses; ``frsz2_compress`` and ``frsz2_decompress`` exactly 2 x
   12 leaves a step, and 24 compresses of the zero state), then a fresh
   ``train()`` that resumes from step 3 over steps 3 and 4 (what it
   restores bit-equal to the step-3 snapshot written, its losses within
   1e-3 of the uninterrupted run's); one more step with
   every m and v code and exponent held against the plain compress of the
   same f32 moments and every decode against the plain decompress, 24
   launches of each; the step profiled (``launch.profile.profile_train``:
   wall, device time, busy share, launches, MFU against 989 TFLOP/s) and
   the AdamW update alone against its codec's byte bound; kernels 1 and 2
   on one row of the largest leaf (``mlp/wg``, 360.7 M values) and of the
   embedding, timed beside the plain codec and their bounds (rows 1o and
   2o); 2 steps with the plain f32 state on the same weights (no codec
   launch, its bytes and peak); and mixtral-8x22b, falcon-mamba-7b,
   zamba2-7b, whisper-medium and llama-3.2-vision-11b at ``reduced()``, 2
   coded steps each: finite losses, the codec's launches as counted.
14. the roofline of the card's steps (slice 7e): phase 9's decode step
   (yi-9b, 8 slots, ~2,052 positions, frsz2_16: its device time profiled
   at the end of phase 9 through ``launch.profile.profile_decode``) and
   phase 13's training step (8 layers, S 4,096, batch 4: its profiled
   device time, the peaks of its coded and plain runs) against the dry
   run of the same cells on a fake 1x1 mesh (``python -m
   repro_torch.launch.dryrun --mesh 1x1 ...``: counted FLOPs and bytes,
   ``bytes_model`` and ``model_flops_for``, the three terms under
   ``HW_H100``, ``step_roofline_fraction``, the counted peak of live bytes
   against ``torch.cuda.max_memory_allocated``), and the dry run's probes
   of yi-9b x decode_32k and mixtral-8x22b x train_4k on the fake 16x16
   mesh; four subprocesses, all started together; a failed row fails the
   script.
15. the analysis gate (slice 8) at the main path's full width (n =
   1,259,712, m = 100): the fixed-trajectory reads audit (``target_rrn=0``,
   CGS2, 2 cycles) of the device driver in frsz2_32 and float64 and of the
   p = 8 frsz2_32 block driver (kernels 7, 8 and 5b), whose ``bytes_read``
   and ``op_reads`` must equal the model on the real store tensors;
   recapture (a second solve captures nothing) and host reads (the sync
   warnings and host-to-device copies of a warmed solve equal each
   driver's ``HOST_TRAFFIC``) of both drivers; the f64 audit of an
   frsz2_16 cycle at f32 arithmetic (kernels 1-6); the collective census
   on phase 7c's NCCL group of one rank (every matvec mode, a rows-mode
   solve whose cycles replay from a graph); one ``{"phase": "analysis"}``
   row each, any finding fails; then ``python -m repro_torch.analysis
   --check --format json`` in a subprocess, which must print ``[]``.
16. the solver's options (slice 11): (a) ``repro_torch.examples.
   quickstart``'s ``codec_demo`` and ``solve_demo`` on the card beside the
   CPU in this process (the codec's lines equal, its codes bit-equal; the
   float64 / float32 / frsz2_32 solves converged, within one iteration of
   the CPU's) and ``solve_cfd.pipeline_demo(8000, "cuda")`` (Jacobi in
   fewer iterations than the identity on ``synth:varcoef``, the adaptive
   policy under static frsz2_32's ``bytes_read``); (b) the paper's grid,
   every problem of ``PROBLEMS`` x float64, float32, float16, frsz2_32 and
   frsz2_16 at n = 8000, m = 50: the device driver twice (capture, then
   replay, bit-equal) and the host driver, equal iterations, restarts,
   ``bytes_read`` and ``op_reads``, every solve converged; the FRSZ2
   pairs within one iteration of the plain route (two on
   ``synth:varcoef``), launching kernels 1, 3, 4 and 6, the native pairs
   no FRSZ2 kernel; the ELL row kernel serving aniso2d (w = 5) and lung
   (w = 4); the 40 rows printed with the reference's headline check
   (frsz2_32 iterations <= float32's, printed, not gated); (c) at full
   width (atmosmodd, m = 100) float32, float16, frsz2_16,
   ``mixed:2:frsz2_32``, frsz2_32 with CGS2 and ``policy="adaptive"`` (at
   m = 100 and at m = 10, where it steps through its levels), then
   ``synth:varcoef`` at the same n with frsz2_32 and Jacobi: device
   (capture, replay: no new graph) and host drivers bit-equal, converged
   within ``FULL_MAX_ITERS``, one graph a level reached, each launching
   its format's kernels, walls, ``bytes_read`` an iteration and peaks
   beside phase 5's; (d) kernels 3 and 4 at the frsz2_16 solver spec (bs
   32, l 16, f64, 101 x 1,259,712) against their plain versions (1e-12
   relative), timed beside the bound and ``torch.mv`` on the decoded basis
   (rows ``frsz2_matvec_l16`` and ``frsz2_rmatvec_l16``, "3h" and "4h",
   launches from the full-width frsz2_16 solve); (e, slice 12) a float32
   block basis at full width (p = 8, m = 100): the block device driver
   (capture, replay) bit-equal to the block host driver, its peak memory
   (``max_memory_allocated``) printed, no FRSZ2 kernel launched.

Slice 9 (MGS's second pass as a CUDA graph IF node, ``remat_policy=
"dots"``) adds to these phases: in 3, the IF node's condition kernel
(``graph_if``) against the branch-free select; before 5, one replayed
cycle of the full-width frsz2_32 scalar and block solves under
``torch.profiler`` in a fresh process, whose kernels 3 and 4 (7 and 8)
run m + fired times, as ``ops.LAUNCHES`` counts; in 5 and 7, the steps a
cycle where MGS fired (scalar and block, float64 and frsz2_32), one
replayed cycle's launches, and the replayed solves bit-equal to the host
driver's; in 7c, the census of a warmed MGS sharded
solve equal to ``cycle_wire_bytes`` with its fired steps; in 13, 3 steps
under ``remat_policy="dots"`` beside full remat (losses within 1e-5
relative, step walls, peak memory); in 15, the MGS reads audits.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.  Needs one CUDA card; imports no JAX.

On a machine with more cards, ``--multi-card`` runs phase 7c's
multi-card run after the phases (5, 7, 7c) that make the unsharded solves
it is held to, and nothing else.
The sharded path's entries (``frsz2_compress_wire``, ...) carry
``kernel`` (the counter they read) and ``path: "sharded"``.
"""
from __future__ import annotations

import contextlib
import functools
import json
import math
import pathlib
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM data sheet: HBM3 at 3.35 TB/s; FP64 outside the tensor cores at
# 34 TFLOP/s.  The codec does integer bit work only, for which the data sheet
# lists no peak rate: its bound is its bytes.
HBM_BYTES_PER_S = 3.35e12
FP64_FLOPS = 34e12
FP32_FLOPS = 67e12         # f32 outside the tensor cores (data sheet)

N_MAIN = 1270432           # --n of the paper-sized atmosmod problem
M = 100                    # restart length
R_FULL, R_HALF = 101, 51   # live basis rows: m + 1, and half of it
REPS = 30
FULL_MAX_ITERS = 500

#: kernels by the path whose solve launches them: slice 1's host driver
#: reads each basis row decompressed; slice 2's device driver hands it to
#: the ELL kernel coded (``ell_spmv_frsz2``) and steps the least squares
#: with ``gmres_givens``.  Both run the dense ELL kernel on every residual.
HOST_PATH = ("frsz2_compress", "frsz2_decompress", "frsz2_matvec",
             "frsz2_rmatvec", "ell_spmv")
DEVICE_PATH = ("frsz2_compress", "frsz2_matvec", "frsz2_rmatvec", "ell_spmv",
               "ell_spmv_frsz2", "gmres_givens", "graph_if")
#: slice 3's block path: each block row written and read back through the
#: codec, the fused block contractions, the batched ELL, the block Givens
#: step, MGS's IF node (slice 9); no scalar contraction
BLOCK_PATH = ("frsz2_compress", "frsz2_decompress", "frsz2_block_dots",
              "frsz2_block_combine", "ell_spmv", "gmres_block_givens",
              "graph_if")
#: slice 9: the full-width replay walls (s) of the branch-free MGS pass
#: that the IF node replaced, on an H100 80GB HBM3 at 700.00 W: the
#: device solves, and the p = 8 frsz2_32 block solve
BRANCH_FREE_WALLS = {"float64": 0.0888, "frsz2_32": 0.1301, "block": 1.2565}
#: the fresh process of the one-cycle profiles: seconds it may take
PROFILE_DEADLINE_S = 180
P_BLOCK = 8                # right-hand sides of the block solves
#: slice 6's path on one rank: the basis written and read back through the
#: codec (the sharded matvec exchanges decoded rows, so no coded-operand
#: ELL), the wire codec of the coded reductions and halo strips, the local
#: contractions and the ELL on localized columns, the Givens step; slice
#: 10: MGS's second pass in the IF node, its reductions over the peer
#: gather
SHARDED_PATH = ("frsz2_compress", "frsz2_decompress", "frsz2_matvec",
                "frsz2_rmatvec", "ell_spmv", "gmres_givens", "graph_if",
                "peer_gather")
#: slice 10: the eta of the MGS solves whose fired pattern is mixed (at
#: the default eta the pass fires at nearly every step)
MIXED_ETA = 0.3
#: NVLink on an H100 SXM: 900 GB/s to the other cards, 450 GB/s each way
NVLINK_BYTES_PER_S = 450e9
TRANSPORTS = ("plain", "compressed", "compressed+norms")

#: phase 7b: operator planning on the paper's atmosmodd row count
#: (``synth:unstructured``, 8·54³ rows, w = 27); the solves converge in
#: about 70-90 iterations (CPU runs at 1/8 of the width), the caps bound a
#: failure's card time
PLAN_N = 1259712
PLAN_MAX_ITERS = 2000
PLAN_BLOCK_MAX_ITERS = 1000
EMUL_FORMATS = ("emul:sz_abs:1e-10", "emul:sz_pwrel:1e-6", "emul:zfp_fr:32")

#: phase 8: yi-9b's heads at the decode_32k length (``SHAPES``).  Its
#: tolerances are ``kernels/cardcheck.py``'s, shared with the card tests:
#: f32 q within 1e-5 of the largest plain output (f32 sums in another
#: order, base-2 exponentials), bf16 q within one bf16 step (2^-7 absolute
#: in the spot checks, 2^-7 of the largest output on the served cache)
ATTN_B, ATTN_HKV, ATTN_G, ATTN_D, ATTN_S = 8, 4, 8, 128, 32768
#: phase 9: the serving run, and the teacher-forcing check's tolerance
SERVE_ARCH = "yi-9b"
SERVE_REQUESTS, SERVE_SLOTS, SERVE_PROMPT, SERVE_NEW = 16, 8, 2048, 32
SERVE_FORMATS = ("frsz2_16", "frsz2_8", "bf16")
TF_B, TF_S, TF_TOL = 2, 256, 5e-2
#: phase 10: the MoE family at full width, 8 layers each (mixtral's 56
#: would take ~280 GB of bf16 weights).  The teacher-forcing prompt is past
#: mixtral's window of 4096; it and the forward's length are multiples of
#: the blocked attention's chunk of 1024, so the prompt's positions see the
#: same chunks in both (other chunks give other bf16 roundings, which move
#: the routing of a few tokens)
MOE_ARCHS = ("mixtral-8x22b", "llama4-scout-17b-a16e")
MOE_LAYERS = 8
MOE_REQUESTS, MOE_SLOTS, MOE_PROMPT, MOE_NEW = 8, 8, 4096, 32
MOE_FORMATS = {"mixtral-8x22b": ("frsz2_16", "frsz2_8", "bf16"),
               "llama4-scout-17b-a16e": ("frsz2_16",)}
MOE_TF_S, MOE_TF_FORWARD = 5120, 6144
#: phase 11: the SSM and hybrid families at full width and full depth,
#: with phase 9's traffic.  The teacher-forcing prompt and the forward's
#: length have large divisors: the scans' chunks (the largest divisor up
#: to 128) are 93 and 128 positions.  zamba2's check runs on its weights
#: in f32: in bf16 the 94 blocks of the random-weight model amplify the
#: last-bit differences between differently shaped products (the decode
#: step's M = 2 against the forward's M = 2048) past 5e-2 even where the
#: chunks line up (``SSM_TF_BF16``, measured and printed beside it)
SSM_ARCHS = ("falcon-mamba-7b", "zamba2-7b")
#: zamba2's ``bf16`` run (phase 9's third format) is left out to keep the
#: phase near 90 s: with it the phase took 120 s
SSM_FORMATS = {"falcon-mamba-7b": ("frsz2_16",),
               "zamba2-7b": ("frsz2_16", "frsz2_8")}
#: decode steps profiled a model: the profiler's processing of a step's
#: 4,000-8,000 launches takes seconds each
SSM_PROFILE_STEPS = 2
SSM_TF_S = 1023
SSM_TF_BF16 = (1024, 2048)
#: phase 12: the encoder-decoder and VLM families at full width and full
#: depth, 16 requests over 8 slots, 32 new tokens each: whisper-medium with
#: 1,536 frames a request and a prompt of 384 (448 decoder positions, the
#: real model's decoder context), llama-3.2-vision-11b with 1,664 image
#: tokens a request and phase 9's prompt of 2048
CROSS_ARCHS = ("whisper-medium", "llama-3.2-vision-11b")
CROSS_TAG = {"whisper-medium": "whisper", "llama-3.2-vision-11b": "vlm"}
CROSS_PROMPT = {"whisper-medium": 384, "llama-3.2-vision-11b": 2048}
CROSS_FORMATS = {"whisper-medium": ("frsz2_16", "frsz2_8", "bf16"),
                 "llama-3.2-vision-11b": ("frsz2_16", "frsz2_8")}
CROSS_PROFILE_STEPS = 2
#: phase 13: training yi-9b at full width, 8 of its 48 layers (all 48 with
#: their gradients, coded moments and f32 update temporaries pass 80 GB:
#: the reference shards them with FSDP, which the port has not yet),
#: ``train_4k``'s sequence, global batch 4 in one microbatch, AdamW with
#: FRSZ2-coded moments; 5 steps with a checkpoint every 3 (one, at step 3),
#: then a run that resumes from it over steps 3 and 4; the plain state for 2 steps; every other family at
#: ``reduced()`` for 2 coded steps
TRAIN_ARCH, TRAIN_LAYERS, TRAIN_BATCH = "yi-9b", 8, 4
TRAIN_STEPS, TRAIN_CKPT_EVERY, TRAIN_PLAIN_STEPS = 5, 3, 2
#: slice 9: steps under ``remat_policy="dots"`` (the reference ladder's last
#: rung), and their losses' tolerance against full remat's first steps
TRAIN_DOTS_STEPS, TRAIN_DOTS_TOL = 3, 1e-5
TRAIN_RESUME_TOL = 1e-3
TRAIN_FAMILIES = ("mixtral-8x22b", "falcon-mamba-7b", "zamba2-7b",
                  "whisper-medium", "llama-3.2-vision-11b")
#: phase 14: the dry runs' deadline (s) and the cache length of the decode
#: cell: phase 9's profiled steps attend 2,051-2,054 positions
ROOF_DEADLINE_S, ROOF_DECODE_SEQ = 300, 2052
#: the step times and peaks phases 9 and 13 measured, for phase 14
STEP_TIMES: dict = {}
#: H100 SXM data sheet: dense bf16 tensor-core peak (the MFU's denominator)
BF16_FLOPS = 989e12
#: phase 16 (slice 11): 16a's ``pipeline_demo`` size; 16b's grid (the
#: formats of ``benchmarks/iteration_table.py`` over ``PROBLEMS``) at phase
#: 4's n, the reference's m = 50; 16c's options at full width (label,
#: storage, options; at m = 100 the float64 level converges within the
#: first cycle, so the adaptive policy runs again at ``pipeline_demo``'s
#: m = 10, where it steps through its levels); each within
#: ``FULL_MAX_ITERS``, as the Jacobi solve of ``synth:varcoef`` at that n
DEMO_N = 8000
GRID_FORMATS = ("float64", "float32", "float16", "frsz2_32", "frsz2_16")
GRID_N, GRID_M, GRID_MAX_ITERS = 8000, 50, 6000
#: iterations the kernel route may take from the plain route (phase 4's
#: one); ``synth:varcoef``'s 25-28 restarts of a row-scaled operator drift
#: by two (frsz2_16: 1,370 against 1,368 on an H100), as the port drifts
#: from the JAX package there (``tests/test_torch_examples.py``)
GRID_DRIFT = {"synth:varcoef": 2}
FULL_OPTIONS = (("float32", "float32", {}), ("float16", "float16", {}),
                ("frsz2_16", "frsz2_16", {}),
                ("mixed:2:frsz2_32", "mixed:2:frsz2_32", {}),
                ("frsz2_32+cgs2", "frsz2_32", {"ortho": "cgs2"}),
                ("adaptive", None, {"policy": "adaptive"}),
                ("adaptive, m = 10", None, {"policy": "adaptive", "m": 10}))


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: {what}")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def timed(fn, reps: int = REPS) -> float:
    """Median device time of ``fn`` in ms (CUDA events).  A sleep kernel
    ahead of each start event keeps the card busy while the host enqueues
    ``fn``, so the events bracket device work, not Python overhead."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound_ms(nbytes: float, flops: float = 0.0, peak: float = FP64_FLOPS):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def entry(name, source, replaces, ms, plain_ms, nbytes, flops, err,
          library_ms=None, peak=FP64_FLOPS, **extra):
    """One kernel's record for the ``{"kernels": [...]}`` line, printed as
    it is measured; ``launches`` is filled in from the path's run."""
    b, by = bound_ms(nbytes, flops, peak)
    e = dict(name=name, route="cuda", source=source, replaces=replaces,
             launches=0, max_abs_err=err, ms=ms, plain_ms=plain_ms,
             bound_ms=b, bound_by=by, library_ms=library_ms,
             status="matches plain", **extra)
    emit(e)
    return e


def phase_build():
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    paths = build.build_all()
    for name in paths:
        build.library(name)
    dt = time.perf_counter() - t0
    print(f"[build] {len(paths)} libraries in {dt:.1f} s -> {build.build_dir()}")
    for name in sorted(paths):
        log = build.build_dir() / f"{name}.log"
        text = log.read_text() if log.exists() else ""
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", text)]
        spills = [int(a) + int(b) for a, b in re.findall(
            r"(\d+) bytes spill stores, (\d+) bytes spill loads", text)]
        print(f"[build] {name}: {len(regs)} kernels, at most "
              f"{max(regs, default=0)} registers, "
              f"{sum(1 for x in spills if x)} with spills")


def phase_device():
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    line = smi.stdout.strip().splitlines()[0]
    print(line)
    name = torch.cuda.get_device_name(0)
    cap = torch.cuda.get_device_capability(0)
    print(f"[device] {name} capability {cap} count {torch.cuda.device_count()}"
          f" torch {torch.__version__} cuda {torch.version.cuda}")
    check(cap == (9, 0), f"the kernels are built for sm_90a, card is {cap}")
    return line


def _bits(t):
    import torch

    return t.view({8: torch.int64, 4: torch.int32, 2: torch.int16}[
        t.element_size()])


def _codec_pair(x, spec):
    """Kernel and plain compress/decompress of ``x``; asserts bit equality.

    Returns the kernel's codes and values and the largest differences from
    the plain version: in code units for compress (codes and exponents),
    in values for decompress."""
    import torch

    from repro_torch.kernels import ops

    bk = ops.compress(x, spec, kernel=True)
    bp = ops.compress(x, spec, kernel=False)
    code_err = max(float((a.long() - b.long()).abs().max())
                   for a, b in ((bk.codes, bp.codes), (bk.exps, bp.exps)))
    check(torch.equal(bk.codes, bp.codes) and torch.equal(bk.exps, bp.exps),
          f"compress != plain for {spec.name} shape {tuple(x.shape)}")
    vk = ops.decompress(bk, kernel=True)
    vp = ops.decompress(bp, kernel=False)
    check(torch.equal(_bits(vk), _bits(vp)),
          f"decompress != plain for {spec.name} shape {tuple(x.shape)}")
    value_err = float((vk.double() - vp.double()).abs().max())
    return bk, vk, code_err, value_err


def _contraction_err(bc, vec, op, r):
    """Relative max error of the kernel against the plain version."""
    from repro_torch.core import frsz2 as F
    from repro_torch.kernels import ops

    sub = F.BlockCompressed(codes=bc.codes[:r], exps=bc.exps[:r], n=bc.n,
                            spec=bc.spec)
    fn = ops.matvec if op == "matvec" else ops.rmatvec
    yk = fn(sub, vec, kernel=True)
    yp = fn(sub, vec, kernel=False)
    abs_err = float((yk - yp).abs().max())
    return abs_err, abs_err / float(yp.abs().max()), sub


def _matvec_guard_checks(dev):
    """The matvec on rows whose one codec block exponent crosses the guard
    (``cardcheck.matvec_across_guard``): equal to ``decompress``."""
    import torch

    from repro_torch.core import frsz2 as F
    from repro_torch.kernels import cardcheck

    gen = torch.Generator(device=dev).manual_seed(31)
    checked = 0
    for dtype, bias in cardcheck.GUARD_DTYPES:
        for l in (32, 16, 8):
            bad, rows = cardcheck.matvec_across_guard(dtype, bias, l, gen)
            check(not bad, f"matvec across the guard ({F.dtype_name(dtype)}, "
                           f"l={l}, columns {bad}) != decompress")
            checked += rows
    print(f"[kernels] matvec across the decode guards: {checked} rows (f64/f32,"
          " l 8/16/32, exponents 0..l+8, a spread, 2*bias+l-55..2*bias+l-53, "
          "2*bias-1..2*bias+1) equal to decompress")


def _matvec_checks(bc, Vdec, w):
    """The matvec at the main-path shape: within 1e-12 of its plain version
    at EDGE_ROWS live rows; two calls bit-equal; one-hot x equal to the
    decoded basis."""
    import torch

    from repro_torch.core import frsz2 as F
    from repro_torch.kernels import ops
    from repro_torch.kernels.cardcheck import EDGE_ROWS, same_values

    for r in EDGE_ROWS:
        _, rel, _ = _contraction_err(bc, w, "matvec", r)
        check(rel <= 1e-12, f"matvec r={r} relative error {rel:.3e} > 1e-12")
    sub = F.BlockCompressed(codes=bc.codes[:R_FULL], exps=bc.exps[:R_FULL],
                            n=bc.n, spec=bc.spec)
    y = ops.matvec(sub, w, kernel=True)
    check(torch.equal(y, ops.matvec(sub, w, kernel=True)),
          "matvec: two calls differ")
    n = bc.n
    at = [0, 1, 3, 4, 1023, 1024, 4097, n // 2 + 5, n - 1]
    for c in at:
        x = torch.zeros_like(w)
        x[c] = 1.0
        check(same_values(ops.matvec(sub, x, kernel=True),
                          Vdec[:R_FULL, c].contiguous()),
              f"matvec with x one-hot at column {c} != the decoded basis")
    print(f"[kernels] matvec at rows {list(EDGE_ROWS)} within 1e-12; two "
          f"calls bit-equal; x one-hot at columns {at} equal to the decoded "
          "basis")
    _matvec_guard_checks(bc.codes.device)


def _rmatvec_checks(bc, h):
    """The rmatvec at the main-path shape bit-equal to its row-order plain
    sum (``ref.rmatvec_rows_ref``) at EDGE_ROWS live rows and on codes one
    code past a 16-byte word; two calls bit-equal; one replay of a captured
    call equal to the eager call; across the decode guards."""
    import torch

    from repro_torch.core import frsz2 as F
    from repro_torch.kernels import cardcheck, ops
    from repro_torch.kernels.cardcheck import EDGE_ROWS

    for r in EDGE_ROWS:
        sub = F.BlockCompressed(codes=bc.codes[:r], exps=bc.exps[:r],
                                n=bc.n, spec=bc.spec)
        check(cardcheck.rmatvec_rows_equal(sub, h[:r]),
              f"rmatvec r={r} != the row-order plain sum")
    check(cardcheck.rmatvec_rows_equal(cardcheck.offset_view(bc), h),
          "rmatvec on codes at an offset != the row-order plain sum")
    check(torch.equal(ops.rmatvec(bc, h), ops.rmatvec(bc, h)),
          "rmatvec: two calls differ")
    check(cardcheck.replay_equals_eager(lambda: ops.rmatvec(bc, h)),
          "rmatvec: a captured call's replay != the eager call")
    gen = torch.Generator(device=bc.codes.device).manual_seed(32)
    checked = 0
    for dtype, bias in cardcheck.GUARD_DTYPES:
        for l in (32, 16, 8):
            for bs in (32, 2):
                bad, codes = cardcheck.rmatvec_across_guard(dtype, bias, l,
                                                            bs, gen)
                check(not bad, f"rmatvec across the guard "
                               f"({F.dtype_name(dtype)}, l={l}, bs={bs}, "
                               f"rows {bad}) != decompress")
                checked += codes
    print(f"[kernels] rmatvec bit-equal to the row-order plain sum at rows "
          f"{list(EDGE_ROWS)} and on codes one code past a word; two calls "
          "bit-equal; a graph replay = the eager call; across the decode "
          f"guards {checked} codes (f64/f32, l 8/16/32, bs 32/2) equal to "
          "decompress")


def phase_kernels():
    import torch

    from repro_torch.core import frsz2 as F
    from repro_torch.kernels import cardcheck, ops

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1234)
    s = round(N_MAIN ** (1 / 3))
    n = s * s * s
    spec = F.FrszSpec(bs=32, l=32, dtype=torch.float64)
    V = torch.randn((R_FULL, n), generator=gen, dtype=torch.float64, device=dev)
    V /= torch.linalg.vector_norm(V, dim=1, keepdim=True)   # Krylov-like rows
    w = torch.randn((n,), generator=gen, dtype=torch.float64, device=dev)

    bc, Vdec, code_err, value_err = _codec_pair(V, spec)
    results = {}
    for r in (R_FULL, R_HALF):
        h = torch.randn((r,), generator=gen, dtype=torch.float64, device=dev)
        for op, vec in (("matvec", w), ("rmatvec", h)):
            abs_err, rel, _ = _contraction_err(bc, vec, op, r)
            check(rel <= 1e-12, f"{op} r={r} relative error {rel:.3e} > 1e-12")
            results[(op, r)] = dict(abs=abs_err, rel=rel, vec=vec)
            print(f"[kernels] {op} r={r}: max abs err {abs_err:.3e}, "
                  f"relative {rel:.3e}")

    # spot checks: other value types, code widths, block sizes, ragged n
    g2 = torch.Generator(device=dev).manual_seed(7)
    spots = cardcheck.CODEC_SPOTS
    for dtype, l, bs in spots:
        for rounding in ("truncate", "nearest"):
            sp = F.FrszSpec(bs=bs, l=l, dtype=dtype, rounding=rounding)
            x = torch.randn((5, 1001), generator=g2, dtype=torch.float64,
                            device=dev)
            x = (x * torch.exp2(torch.randint(-8, 8, (5, 1001), generator=g2,
                                              device=dev).double())).to(dtype)
            x[0, ::7] = 0.0
            sbc, *_ = _codec_pair(x, sp)
            if dtype in (torch.float32, torch.float64):
                tol = 1e-12 if dtype == torch.float64 else 1e-5
                hv = torch.randn((5,), generator=g2, dtype=dtype, device=dev)
                xv = torch.randn((1001,), generator=g2, dtype=dtype, device=dev)
                for op, vec in (("matvec", xv), ("rmatvec", hv)):
                    _, rel, _ = _contraction_err(sbc, vec, op, 5)
                    check(rel <= tol, f"{op} {sp.name} relative error {rel:.3e}")
                for view in (sbc, cardcheck.offset_view(sbc)):
                    check(cardcheck.rmatvec_rows_equal(view, hv),
                          f"rmatvec {sp.name} != the row-order plain sum "
                          f"(codes at {view.codes.data_ptr() % 16} bytes "
                          "past a word)")
    print(f"[kernels] spot checks passed: {len(spots) * 2} specs, ragged "
          "n=1001; the rmatvec bit-equal to its row-order plain sum there, "
          "also on codes at an offset")
    faults = cardcheck.codec_edges(g2)
    check(not faults, f"row codec edge cases: {faults}")
    print(f"[kernels] row codec: rows {[c[0] for c in cardcheck.CODEC_MANY_ROWS]}"
          " (past the first design's grid limit), every spot at n=1001, views "
          "at an offset: bit-equal to plain, one launch each")
    _matvec_checks(bc, Vdec, w)
    _rmatvec_checks(bc, results[("rmatvec", R_FULL)]["vec"])

    # times at the main-path shape
    npad = bc.codes.shape[1] * spec.bs
    nb = bc.codes.shape[1]
    row_bytes = npad * 4 + nb * 4
    x_row = V[7].contiguous()
    codes_row = torch.empty_like(bc.codes[0])
    exps_row = torch.empty_like(bc.exps[0])
    row_bc = F.BlockCompressed(codes=bc.codes[7], exps=bc.exps[7], n=n,
                               spec=spec)
    entries = {}
    codec_src = "src/repro_torch/kernels/csrc/frsz2_codec.cu"
    dot_src = "src/repro_torch/kernels/csrc/frsz2_dot.cu"
    entries["frsz2_compress"] = entry(
        "frsz2_compress", codec_src, "src/repro/kernels/frsz2_kernel.py:113",
        timed(lambda: ops.compress(x_row, spec, out=(codes_row, exps_row),
                                   kernel=True)),
        timed(lambda: ops.compress(x_row, spec, out=(codes_row, exps_row),
                                   kernel=False)),
        n * 8 + row_bytes, 0.0, code_err, shape=f"1 x {n}",
        err_unit="code")
    entries["frsz2_decompress"] = entry(
        "frsz2_decompress", codec_src, "src/repro/kernels/frsz2_kernel.py:75",
        timed(lambda: ops.decompress(row_bc, kernel=True)),
        timed(lambda: ops.decompress(row_bc, kernel=False)),
        row_bytes + n * 8, 0.0, value_err, shape=f"1 x {n}")
    for r in (R_FULL, R_HALF):
        sub = F.BlockCompressed(codes=bc.codes[:r], exps=bc.exps[:r], n=n,
                                spec=spec)
        Vr = Vdec[:r]
        for op, fn, lib, replaces in (
                ("matvec", ops.matvec, lambda Vr=Vr: torch.mv(Vr, w),
                 "src/repro/kernels/frsz2_dot.py:77"),
                ("rmatvec", ops.rmatvec,
                 lambda Vr=Vr, r=r: torch.mv(Vr.t(), results[("rmatvec", r)]["vec"]),
                 "src/repro/kernels/frsz2_dot.py:114")):
            vec = results[(op, r)]["vec"]
            nbytes = r * row_bytes + n * 8 + r * 8
            e = entry(f"frsz2_{op}", dot_src, replaces,
                      timed(lambda fn=fn, sub=sub, vec=vec: fn(sub, vec,
                                                                kernel=True)),
                      timed(lambda fn=fn, sub=sub, vec=vec: fn(sub, vec,
                                                                kernel=False)),
                      nbytes, 2.0 * r * n, results[(op, r)]["abs"],
                      library_ms=timed(lib), rows=r, shape=f"{r} x {n}",
                      library="torch.mv on the decoded f64 basis")
            if r == R_FULL:
                entries[f"frsz2_{op}"] = e
    del V, Vdec, bc
    torch.cuda.empty_cache()
    return entries


def _rel_err(yk, yp):
    """(max abs error, the same relative to max |plain|)."""
    abs_err = float((yk.double() - yp.double()).abs().max())
    return abs_err, abs_err / max(float(yp.double().abs().max()), 1e-300)


def _all_codes(l, gen):
    """Every code of l <= 16 bits; for l = 32, the edge codes (0, the sign
    alone, 1, all ones, the largest and smallest fields of either sign)
    and seeded codes, 2^16 in all.  As the codec's signed containers."""
    import torch

    from repro_torch.core import frsz2 as F

    dev = gen.device
    if l <= 16:
        c = torch.arange(1 << l, device=dev)
    else:
        edges = torch.tensor([0, 1 << 31, 1, (1 << 32) - 1, (1 << 31) - 1,
                              (1 << 31) + 1, 1 << 30, 3 << 30], device=dev)
        c = torch.cat([edges, torch.randint(0, 1 << 32, ((1 << 16) - 8,),
                                            generator=gen, device=dev)])
    if l < 64 and l > 8:
        c = c - (c >= (1 << (l - 1))).long() * (1 << l)
    return c.to(F.code_dtype(l))


def _identity_ell_checks(dev):
    """The scaled decode through the ELL kernel: an identity operator on a
    coded vector built directly from codes and exponents (every l = 16
    code, l = 8 codes, 2^16 l = 32 codes, each block under exponents
    0..l+8, a seeded spread, 2*bias and 2*bias+1) equals ``ops.decompress``
    of the same vector, as integer bits after ``+ 0.0``.  Slot 0 of row i
    holds entry i; at w = 7 (the compiled width) the other slots hold entry
    0, code 0 (+0), with value 0."""
    import torch

    from repro_torch.core import frsz2 as F
    from repro_torch.kernels import ops

    gen = torch.Generator(device=dev).manual_seed(17)
    bs = 32
    checked = 0
    for dtype, bias, ibits in ((torch.float64, 1023, torch.int64),
                               (torch.float32, 127, torch.int32)):
        for l in (16, 32, 8):
            codes = _all_codes(l, gen)
            spread = torch.randint(0, 2 * bias + 2, (16,), generator=gen,
                                   device=dev)
            emax = torch.cat([torch.arange(l + 9, device=dev), spread,
                              torch.tensor([2 * bias - 1, 2 * bias,
                                            2 * bias + 1], device=dev)])
            per = codes.numel() // bs
            spec = F.FrszSpec(bs=bs, l=l, dtype=dtype)
            bc = F.BlockCompressed(
                codes=codes.reshape(per, bs).repeat(emax.numel(), 1),
                exps=emax.to(torch.int32).repeat_interleave(per),
                n=emax.numel() * codes.numel(), spec=spec)
            n = bc.n
            want = ops.decompress(bc, kernel=True) + 0.0
            check(torch.equal(want.view(ibits),
                              (ops.decompress(bc, kernel=False) + 0.0
                               ).view(ibits)),
                  f"decompress kernel != plain on every code, l={l}")
            for w in (7, 1):
                cols = torch.zeros((n, w), dtype=torch.int32, device=dev)
                cols[:, 0] = torch.arange(n, dtype=torch.int32, device=dev)
                vals = torch.zeros((n, w), dtype=dtype, device=dev)
                vals[:, 0] = 1.0
                got = ops.ell_spmv(vals, cols, bc, kernel=True) + 0.0
                check(torch.equal(got.view(ibits), want.view(ibits)),
                      f"scaled decode through ell_spmv_frsz2 != decompress "
                      f"({F.dtype_name(dtype)}, l={l}, w={w}): "
                      f"{int((got.view(ibits) != want.view(ibits)).sum())} "
                      "entries differ")
                checked += n
            del bc, want, cols, vals, got
    print(f"[ell] scaled decode: {checked} coded entries through the ELL "
          "kernel (w 7 and 1, f64/f32, l 8/16/32, exponents 0..l+8, a "
          "spread, 2*bias, 2*bias+1) bit-equal to decompress")


def phase_ell(A):
    """The ELL SpMV kernels on the main-path operator, and spot checks."""
    import torch

    from repro_torch.core import frsz2 as F
    from repro_torch.kernels import ops

    dev = A.device
    E = A.to_ell()
    nr, w = E.vals.shape
    gen = torch.Generator(device=dev).manual_seed(11)
    x = torch.randn((nr,), generator=gen, dtype=torch.float64, device=dev)
    v = x / torch.linalg.vector_norm(x)                # a Krylov-like row
    spec = F.FrszSpec(bs=32, l=32, dtype=torch.float64)
    bc = ops.compress(v, spec)
    errs = {}
    for name, operand in (("ell_spmv", x), ("ell_spmv_frsz2", bc)):
        yk = ops.ell_spmv(E.vals, E.cols, operand, kernel=True)
        yp = ops.ell_spmv(E.vals, E.cols, operand, kernel=False)
        errs[name] = _rel_err(yk, yp)
        check(torch.equal(yk, yp), f"{name} != plain: relative error "
                                   f"{errs[name][1]:.3e}")
        check(torch.equal(ops.ell_spmv(E.vals, E.cols, operand, kernel=True),
                          yk), f"{name}: two calls differ")
        print(f"[ell] {name} n={nr} w={w}: bit-equal to plain, two calls "
              "bit-equal")
    _identity_ell_checks(dev)

    # spot checks: f32 values, a ragged column count, other block sizes
    g2 = torch.Generator(device=dev).manual_seed(5)
    nr2, nc2, w2 = 777, 1001, 5
    cols = torch.randint(0, nc2, (nr2, w2), generator=g2, device=dev,
                         dtype=torch.int32)
    vals = torch.randn((nr2, w2), generator=g2, dtype=torch.float64, device=dev)
    pad = torch.rand((nr2, w2), generator=g2, device=dev) < 0.2
    cols[pad] = 0
    vals[pad] = 0.0
    xr = torch.randn((nc2,), generator=g2, dtype=torch.float64, device=dev)
    spots = 0
    for dtype, tol in ((torch.float64, 1e-13), (torch.float32, 1e-6)):
        vd = vals.to(dtype)
        operands = [xr.to(dtype)] + [
            ops.compress(xr.to(dtype), F.FrszSpec(bs=bs, l=l, dtype=dtype))
            for bs, l in ((8, 32), (64, 16), (128, 8), (32, 32))]
        for op in operands:
            _, rel = _rel_err(ops.ell_spmv(vd, cols, op, kernel=True),
                              ops.ell_spmv(vd, cols, op, kernel=False))
            check(rel <= tol, f"ell spot check {dtype} relative error {rel:.3e}")
            spots += 1
    # the main path's operator in f32 values
    _, rel = _rel_err(ops.ell_spmv(E.vals.float(), E.cols, x, kernel=True),
                      ops.ell_spmv(E.vals.float(), E.cols, x, kernel=False))
    check(rel <= 1e-6, f"ell f32 main-shape relative error {rel:.3e}")
    print(f"[ell] spot checks passed: {spots + 1} (f32/f64 values, nc=1001 "
          "ragged, frsz2 bs 8/32/64/128, l 8/16/32)")

    # times; the bound counts vals, cols, the operand and y once each
    mat_bytes = E.vals.numel() * 8 + E.cols.numel() * 4
    indptr = A.indptr
    csr = torch.sparse_csr_tensor(indptr, A.indices, A.data, size=A.shape)
    src = "src/repro_torch/kernels/csrc/ell_spmv.cu"
    entries = {}
    for name, operand, x_bytes, replaces in (
            ("ell_spmv", x, nr * 8, "src/repro/kernels/ell_spmv.py:49"),
            ("ell_spmv_frsz2", bc, bc.codes.numel() * 4 + bc.exps.numel() * 4,
             "src/repro/kernels/ell_spmv.py:76")):
        lib_x = x if name == "ell_spmv" else ops.decompress(bc)
        entries[name] = entry(
            name, src, replaces,
            timed(lambda op=operand: ops.ell_spmv(E.vals, E.cols, op,
                                                  kernel=True)),
            timed(lambda op=operand: ops.ell_spmv(E.vals, E.cols, op,
                                                  kernel=False)),
            mat_bytes + x_bytes + nr * 8, 2.0 * nr * w, errs[name][0],
            library_ms=timed(lambda lx=lib_x: csr @ lx),
            shape=f"{nr} x {w}, nnz {A.nnz}",
            library="torch.sparse_csr_tensor @ x (decoded operand)")
    return entries


def phase_givens():
    """The device cycle's Givens step over a cycle of m = 100 steps: kernel
    bit-equal to its plain version; its time at the last step."""
    import torch

    from repro_torch.kernels import ops, ref

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    m = M
    L = ref.givens_layout(m)
    sk, sp = ref.givens_init_ref(m, dev), ref.givens_init_ref(m, dev)
    b_norm = torch.tensor(3.0, dtype=torch.float64, device=dev)
    for s in (sk, sp):
        s[L["g"]] = 1.5
    steps = []
    for j in range(m):
        h = torch.randn((j + 1,), generator=gen, dtype=torch.float64,
                        device=dev)
        hj1 = torch.rand((), generator=gen, dtype=torch.float64, device=dev)
        w_pre = hj1 + torch.rand((), generator=gen, dtype=torch.float64,
                                 device=dev)
        fired = hj1 < 0.7 * w_pre
        steps.append((h, hj1, w_pre, fired))
        ops.givens_step(sk, h, hj1, w_pre, fired, b_norm, j, m, 1e-300,
                        kernel=True)
        ops.givens_step(sp, h, hj1, w_pre, fired, b_norm, j, m, 1e-300,
                        kernel=False)
    check(torch.equal(sk, sp), "gmres_givens != plain over a 100-step cycle")
    check(float(sk[L["alive"]]) == 1.0, "Givens cycle died on random input")
    err = float((sk - sp).abs().max())
    print(f"[givens] m={m}: kernel bit-equal to plain over {m} steps")
    h, hj1, w_pre, fired = steps[-1]
    j = m - 1
    # bytes: h, the three scalars, cs/sn/g read and R's column, cs, sn, g,
    # est written; flops: 6 per earlier rotation plus the new one
    nbytes = (j + 1) * 8 + 3 * 8 + 2 * j * 8 + 2 * 8 + (j + 2) * 8 + 6 * 8
    return {"gmres_givens": entry(
        "gmres_givens", "src/repro_torch/kernels/csrc/gmres_step.cu",
        "src/repro/solver/gmres.py:159 (jnp in the device cycle; no Pallas "
        "kernel: a helper, not a TPU-kernel port)",
        timed(lambda: ops.givens_step(sk, h, hj1, w_pre, fired, b_norm, j, m,
                                      1e-300, kernel=True)),
        timed(lambda: ops.givens_step(sp, h, hj1, w_pre, fired, b_norm, j, m,
                                      1e-300, kernel=False), reps=5),
        nbytes, 6.0 * j + 10.0, err, shape=f"step j={j} of m={m}",
        helper=True)}


def phase_graph_if():
    """Slice 9's helper kernel: the IF node's condition
    (``csrc/graph_if.cu``) through ``solver.graphs.device_if``, in a
    captured graph whose node doubles a main-path row, replayed with the
    condition true and false against the plain version of the branch (the
    body run, then ``torch.where``); its time where it does not fire
    beside the branch-free graph's."""
    import torch

    from repro_torch.solver import graphs

    n = round(N_MAIN ** (1 / 3)) ** 3
    gen = torch.Generator(device="cuda").manual_seed(9)
    x = torch.randn((n,), generator=gen, dtype=torch.float64, device="cuda")
    y = torch.empty_like(x)
    pred = torch.zeros((), dtype=torch.bool, device="cuda")

    def branch():
        with graphs.device_if(pred) as put:
            put(y, x * 2.0)

    def plain():
        y.copy_(torch.where(pred, x * 2.0, y))

    made = {}
    for name, body in (("if", branch), ("plain", plain)):
        body()                                      # warm-up, eagerly
        g = torch.cuda.CUDAGraph()
        with graphs.capturing(g), torch.cuda.graph(g):
            body()
        made[name] = g
    err = 0.0
    for p in (True, False):
        for name, g in made.items():
            y.fill_(-1.0)
            pred.fill_(p)
            g.replay()
            want = x * 2.0 if p else torch.full_like(x, -1.0)
            check(torch.equal(y, want), f"graph_if: the {name} graph with "
                                        f"the condition {p} wrote other bits")
    pred.fill_(False)
    ms = timed(made["if"].replay)
    plain_ms = timed(made["plain"].replay)
    pred.fill_(True)
    fired_ms = timed(made["if"].replay)
    print(f"[graph_if] an IF node over a row of {n}: bit-equal to the "
          f"branch-free select both ways; replay {ms * 1e3:.1f} us not "
          f"firing, {fired_ms * 1e3:.1f} us firing, branch-free "
          f"{plain_ms * 1e3:.1f} us")
    return {"graph_if": entry(
        "graph_if", "src/repro_torch/kernels/csrc/graph_if.cu",
        "src/repro/solver/pipeline.py:131 (jax.lax.cond of MGS's second "
        "pass; no Pallas kernel: a helper, not a TPU-kernel port)",
        ms, plain_ms, 1.0, 0.0, err, shape=f"a 0-d bool; body: a row of {n}",
        fired_ms=fired_ms, helper=True)}


def _solve_row(label, A, b, x_sol, fmt, target, max_iters, driver,
               reorder="auto", m=M, **kw):
    """One ``gmres`` solve as a user calls it, the launch counts set to 0
    just before and read just after; ``kw``: the pipeline's options
    (``ortho``, ``policy``, ``precond``), recorded in the row."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.solver import gmres

    ops.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = gmres(A, b, storage=fmt, m=m, max_iters=max_iters, target_rrn=target,
                driver=driver, reorder=reorder, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    err = float(torch.linalg.vector_norm(res.x - x_sol)
                / torch.linalg.vector_norm(x_sol))
    row = dict(phase=label, n=A.shape[0], format=getattr(fmt, "name", fmt),
               driver=driver, iters=res.iterations, restarts=res.restarts,
               rrn=res.rrn, converged=bool(res.converged), x_err=err,
               wall_s=wall, wall_per_iter_ms=wall * 1e3 / max(res.iterations, 1),
               bytes_read=res.bytes_read,
               bytes_read_per_s=res.bytes_read / wall, op_reads=res.op_reads,
               peak_mem_bytes=torch.cuda.max_memory_allocated(),
               launches=launches)
    if reorder != "auto":
        row["reorder"] = reorder
    if m != M:
        row["m"] = m
    row.update({k: str(v) for k, v in kw.items()})
    emit(row)
    return res, row


def _check_launches(row, path, what):
    """Every kernel of ``path`` launched; no other FRSZ2 kernel did."""
    lc = row["launches"]
    check(all(lc[k] > 0 for k in path), f"{what} skipped a kernel: {lc}")
    check(not any(v for k, v in lc.items()
                  if k.startswith("frsz2_") and k not in path),
          f"{what} launched a kernel off its path: {lc}")


def _check_drivers_agree(dev_res, host_res, dev_row, host_row, what):
    import torch

    for key in ("iters", "restarts", "bytes_read", "op_reads"):
        check(dev_row[key] == host_row[key],
              f"{what}: device driver {key} {dev_row[key]} != host "
              f"{host_row[key]}")
    rel = float(torch.linalg.vector_norm(dev_res.x - host_res.x)
                / torch.linalg.vector_norm(host_res.x))
    check(rel <= 1e-10, f"{what}: device x vs host x relative {rel:.3e}")
    return rel


def _f16_write_check():
    """A float16 basis write on the card rounds f64 through f32, as the JAX
    reference does; returns how many of the same values numpy's single
    rounding gives otherwise.  Also times one such write of a main-path
    row (n = 1,259,712) beside a plain ``copy_``."""
    import numpy as np
    import torch

    from repro_torch.core.accessor import BasisAccessor, NativeFormat

    rng = np.random.default_rng(16)
    ties = 1.0 + np.arange(1, 1024) * 2.0 ** -10 + 2.0 ** -11
    x = np.concatenate([rng.standard_normal(1_000_000),
                        rng.standard_normal(100_000) * 1e-5,
                        rng.standard_normal(100_000) * 6e4,
                        ties + 2.0 ** -40, ties - 2.0 ** -40,
                        [0.0, -0.0, np.inf, -np.inf, 1e300, 1e-300, 65519.99,
                         65520.0, 2.0 ** -25, 1.5 * 2.0 ** -24]])
    with np.errstate(over="ignore"):
        want = x.astype(np.float32).astype(np.float16).view(np.int16)
        once = x.astype(np.float16).view(np.int16)
    xt = torch.from_numpy(x).to("cuda")
    acc = BasisAccessor(fmt=NativeFormat(dtype=torch.float16), m=2,
                        n=x.size, device="cuda")
    store = acc.empty()
    acc.write_row(store, 1, xt)
    got = store[1].cpu().numpy().view(np.int16)
    check(np.array_equal(got, want), f"float16 basis write on the card != "
          f"f64 -> f32 -> f16 in {int((got != want).sum())} values")
    n_diff = int((once != want).sum())
    print(f"[solve] float16 basis write on the card: bit-equal to f64 -> "
          f"f32 -> f16 (the JAX reference's rounding) on {x.size} values; "
          f"numpy's single rounding differs from it in {n_diff}")
    n = round(N_MAIN ** (1 / 3)) ** 3
    row = BasisAccessor(fmt=NativeFormat(dtype=torch.float16), m=1, n=n,
                        device="cuda")
    rs = row.empty()
    v = torch.randn((n,), dtype=torch.float64, device="cuda")
    once = timed(lambda: row.write_row(rs, 0, v))
    twice = timed(lambda: rs[0].copy_(v))
    print(f"[solve] float16 basis write of n = {n}: {once * 1e3:.1f} us, "
          f"{twice * 1e3:.1f} us as one copy_")
    return n_diff


def phase_solve():
    import torch

    from repro_torch.core.accessor import format_by_name
    from repro_torch.sparse import make_problem, rhs_for

    _f16_write_check()
    A, target = make_problem("synth:atmosmod", 8000, device="cuda")
    b, x_sol = rhs_for(A, device="cuda")
    rows = {}
    for fmt in ("frsz2_32", "float64"):
        h, rh = _solve_row("solve", A, b, x_sol, fmt, target, 20000, "host")
        d1, rd1 = _solve_row("solve-capture", A, b, x_sol, fmt, target, 20000,
                             "device")
        d2, rd2 = _solve_row("solve", A, b, x_sol, fmt, target, 20000,
                             "device")
        check(d1.converged and h.converged, f"n=8000 {fmt} did not converge")
        check(rd1["x_err"] < 1e-6, f"n=8000 {fmt} solution error "
                                   f"{rd1['x_err']:.3e}")
        rel = _check_drivers_agree(d1, h, rd1, rh, f"n=8000 {fmt}")
        check(d1.iterations == d2.iterations and torch.equal(d1.x, d2.x),
              f"n=8000 {fmt}: two device solves differ: not deterministic")
        rows[fmt] = (h, rh, d2, rd2)
        print(f"[solve] {fmt}: device {d1.iterations} it = host "
              f"{h.iterations} it, x rel diff {rel:.3e}, two device solves "
              "bit-equal")
    _check_launches(rows["frsz2_32"][1], HOST_PATH, "n=8000 host frsz2_32")
    _check_launches(rows["frsz2_32"][3], DEVICE_PATH, "n=8000 device frsz2_32")
    _check_launches(rows["float64"][3], ("ell_spmv", "gmres_givens"),
                    "n=8000 device float64")
    plain = format_by_name("frsz2_32", use_kernels=False)
    p, rp = _solve_row("solve-plain", A, b, x_sol, plain, target, 20000,
                       "host")
    k = rows["frsz2_32"][0]
    check(p.converged, "n=8000 plain-route solve did not converge")
    check(abs(k.iterations - p.iterations) <= 1,
          f"kernel route {k.iterations} vs plain {p.iterations} iterations")
    check(not any(v for kk, v in rp["launches"].items()
                  if kk.startswith("frsz2_")),
          f"plain route launched FRSZ2 kernels: {rp['launches']}")
    print(f"[solve] kernel route {k.iterations} it, plain route "
          f"{p.iterations} it")


def _cycle_launches(contractions, givens, m, fired) -> dict:
    """What one replayed cycle of m steps, ``fired`` of them where MGS
    fired, launches: each kernel of ``contractions`` at every step and
    again at every fired one, MGS's IF condition and ``givens`` at every
    step."""
    want = dict.fromkeys(contractions, m + fired)
    want.update({"graph_if": m, givens: m})
    return want


def _one_replay(call, contractions, givens, m, what):
    """One replayed cycle (``call()`` returns the cycle's host tuple, its
    fired slots last): ``ops.LAUNCHES`` must count each kernel of
    ``contractions`` m + (fired steps) times, MGS's IF condition and
    ``givens`` m times.  Returns (fired steps, those counts).  The
    profiler's own count of the same replay runs in a fresh process
    (:func:`phase_cycle_profiles`)."""
    from repro_torch.kernels import ops

    ops.reset_launches()
    fired = int(call()[-1].sum())
    want = _cycle_launches(contractions, givens, m, fired)
    for k, v in want.items():
        check(ops.LAUNCHES[k] == v,
              f"{what}: one replayed cycle counted {k} {ops.LAUNCHES[k]} "
              f"launches, expected {v} (m = {m}, {fired} fired steps)")
    return fired, {k: ops.LAUNCHES[k] for k in want}


def _profile_one_cycle(call, contractions, givens, m, what) -> dict:
    """As :func:`_one_replay`, and the replay under ``torch.profiler``: each
    kernel must also have run as often as ``ops.LAUNCHES`` counts."""
    from repro_torch.kernels import cardcheck, ops

    ops.reset_launches()
    out = {}
    counted = cardcheck.profiled_launches(lambda: out.update(r=call()))
    fired = int(out["r"][-1].sum())
    want = _cycle_launches(contractions, givens, m, fired)
    for k, v in want.items():
        check(counted[k] == ops.LAUNCHES[k] == v,
              f"{what}: one replayed cycle ran {k} {counted[k]} times (the "
              f"profiler), counted {ops.LAUNCHES[k]}, expected {v} (m = {m},"
              f" {fired} fired steps)")
    return dict(fired=fired, m=m, profiled={k: counted[k] for k in want})


def _cycle_profiles_child(path: str) -> int:
    """The fresh process of :func:`phase_cycle_profiles`: the full-width
    frsz2_32 block and scalar device solves (capture, then replay), one
    replayed cycle of each under the profiler, the result as JSON."""
    import torch

    from repro_torch.launch.solve import _batch_rhs
    from repro_torch.solver import gmres, gmres_batched
    from repro_torch.sparse import make_problem, rhs_for

    A, target = make_problem("synth:atmosmod", N_MAIN, device="cuda")
    b, _ = rhs_for(A, device="cuda")
    B = _batch_rhs(b, P_BLOCK)
    kw = dict(storage="frsz2_32", m=M, max_iters=FULL_MAX_ITERS,
              target_rrn=target)
    out = {}
    for _ in range(2):
        gmres_batched(A, B, method="block", **kw)
    cyc = _last_cycle()
    bn = torch.clamp(torch.linalg.vector_norm(B, dim=1), min=1e-300)
    out["block"] = _profile_one_cycle(
        lambda: cyc(B, bn), ("frsz2_block_dots", "frsz2_block_combine"),
        "gmres_block_givens", M, "full-width block frsz2_32")
    del cyc
    release()
    for _ in range(2):
        gmres(A, b, **kw)
    cyc = _last_cycle()
    bn = torch.linalg.vector_norm(b)
    out["scalar"] = _profile_one_cycle(
        lambda: cyc(b, bn, bn), ("frsz2_matvec", "frsz2_rmatvec"),
        "gmres_givens", M, "full-width frsz2_32")
    pathlib.Path(path).write_text(json.dumps(out))
    return 0


def phase_cycle_profiles(device_line):
    """Slice 9: one replayed cycle of the full-width frsz2_32 scalar and
    block device solves under ``torch.profiler``, in a fresh process:
    kernels 3 and 4 (7 and 8) run m + (fired steps) times, the IF
    condition and the Givens step m times, each as ``ops.LAUNCHES``
    counts.  A fresh process, because in one that has made and freed
    other graphs the profiler names some kernel records of the IF nodes'
    bodies after other kernels (a block cycle's block-dots records read
    fewer than ran, while its results stay bit-equal to the host
    driver's)."""
    import os

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_prof_") as d:
        path = pathlib.Path(d) / "profiles.json"
        proc = subprocess.run(
            [sys.executable, str(ROOT / "chip_smoke.py"),
             "--one-cycle-profiles", str(path)], cwd=ROOT,
            env=dict(os.environ), capture_output=True, text=True,
            timeout=PROFILE_DEADLINE_S)
        check(proc.returncode == 0 and path.exists(),
              f"the one-cycle profiles exited {proc.returncode}: "
              f"{proc.stdout[-2000:]} {proc.stderr[-3000:]}")
        got = json.loads(path.read_text())
    wall = time.perf_counter() - t0
    emit(dict(phase="one-cycle-profiles", wall_s=wall, device=device_line,
              **got))
    for label, r in got.items():
        print(f"[profile] {label} frsz2_32, one replayed cycle of m = "
              f"{r['m']} steps, {r['fired']} fired: "
              + ", ".join(f"{k} {v}" for k, v in r["profiled"].items())
              + " kernel executions (the profiler), equal to ops.LAUNCHES")
    print(f"[profile] in a fresh process: {wall:.1f} s")


def _last_cycle():
    """The cycle the last device solve replayed (the most recently used
    entry of the graph cache)."""
    from repro_torch.solver.gmres import _GRAPHS

    return next(reversed(_GRAPHS.values()))


def phase_full_width(A, target):
    """Each path's full-width frsz2_32 solve, counts read just after it:
    returns the launches per kernel from the path that runs it, and each
    format's replayed device solve (phase 7c compares against it).  Slice
    9: the steps a cycle where MGS fired, and one replayed cycle's
    launches (kernels 3 and 4 m + fired times; the profiler's count of
    the same is :func:`phase_cycle_profiles`')."""
    import torch

    from repro_torch.sparse import rhs_for

    b, x_sol = rhs_for(A, device="cuda")
    launches = {}
    device_runs = {}
    for fmt in ("float64", "frsz2_32"):
        h, rh = _solve_row("full", A, b, x_sol, fmt, target, FULL_MAX_ITERS,
                           "host")
        d1, rd1 = _solve_row("full-capture", A, b, x_sol, fmt, target,
                             FULL_MAX_ITERS, "device")
        d2, rd2 = _solve_row("full", A, b, x_sol, fmt, target,
                             FULL_MAX_ITERS, "device")
        for res in (h, d1, d2):
            check(bool(torch.isfinite(res.x).all()) and res.rrn < 1.0,
                  f"{fmt} full-width solve did not reduce the residual")
        rel = _check_drivers_agree(d2, h, rd2, rh, f"full-width {fmt}")
        check(torch.equal(d1.x, d2.x) and torch.equal(d2.x, h.x),
              f"full-width {fmt}: the device solves and the host solve are "
              "not bit-equal")
        device_runs[fmt] = (d2, rd2)
        # the replayed cycle's first cycle again, from the solve's inputs
        cyc = _last_cycle()
        bn = torch.linalg.vector_norm(b)
        fired, counted = _one_replay(
            lambda: cyc(b, bn, bn),
            ("frsz2_matvec", "frsz2_rmatvec") if fmt == "frsz2_32" else (),
            "gmres_givens", M, f"full-width {fmt}")
        check(fired == int(d2.fired[0].sum()), f"full-width {fmt}: the "
              f"replayed cycle fired {fired} steps, the solve's first "
              f"{int(d2.fired[0].sum())}")
        emit(dict(phase="full-one-cycle", format=fmt, m=M, fired=fired,
                  launches=counted,
                  fired_device=d2.fired.sum(1).tolist(),
                  fired_host=h.fired.sum(1).tolist()))
        print(f"[full] {fmt}: device {d2.iterations} it = host "
              f"{h.iterations} it, x rel diff {rel:.3e} (bit-equal); walls "
              f"host {rh['wall_s']:.4f} s, device first {rd1['wall_s']:.4f} "
              f"s, second {rd2['wall_s']:.4f} s (branch-free pass "
              f"{BRANCH_FREE_WALLS[fmt]:.4f} s); peak memory device "
              f"{rd1['peak_mem_bytes'] / 2**30:.2f} GiB; MGS fired at "
              f"{d2.fired.sum(1).tolist()} of {M} steps a cycle on the "
              f"device ({h.fired.sum(1).tolist()} of the live steps on the "
              f"host); one replayed cycle launched "
              + ", ".join(f"{k} {v}" for k, v in counted.items()))
        if fmt == "float64":
            _check_launches(rh, ("ell_spmv",), "float64 host solve")
            _check_launches(rd2, ("ell_spmv", "gmres_givens"),
                            "float64 device solve")
        else:
            _check_launches(rh, HOST_PATH, "frsz2_32 host solve (slice 1)")
            _check_launches(rd2, DEVICE_PATH, "frsz2_32 device solve (slice 2)")
            launches = {k: rh["launches"][k] for k in HOST_PATH}
            launches.update({k: rd2["launches"][k] for k in DEVICE_PATH})
            paths = {k: "host" for k in HOST_PATH}
            paths.update({k: "device" for k in DEVICE_PATH})
    return launches, paths, device_runs


def release():
    """Free the captured cycles (their stores and graph pools) and the
    allocator's cache between phases."""
    import torch

    from repro_torch.solver import clear_graph_cache

    clear_graph_cache()
    torch.cuda.empty_cache()


def _block_store(spec, p, n, rows, gen):
    """A frsz2 block basis of ``rows`` block rows of ``p`` Krylov-like
    (unit-norm) vectors of length ``n``, written as the block cycle writes
    it; returns the accessor, the store and its BlockCompressed view."""
    import torch

    from repro_torch.core import frsz2 as F
    from repro_torch.core.accessor import BlockBasisAccessor, FrszFormat

    acc = BlockBasisAccessor(fmt=FrszFormat(spec), m=rows, p=p, n=n,
                             arith_dtype=spec.dtype, device="cuda")
    store = acc.empty()
    for i in range(rows):
        W = torch.randn((p, n), generator=gen, dtype=torch.float64,
                        device="cuda")
        W /= torch.linalg.vector_norm(W, dim=1, keepdim=True)
        acc.write_block(store, i, W.to(spec.dtype))
    bc = F.BlockCompressed(codes=store["codes"], exps=store["exps"],
                           n=acc.n_flat, spec=spec)
    return acc, store, bc


def _block_pair(bc, p, W, Y, rows):
    """Kernel and plain block dots and combine; relative errors."""
    from repro_torch.kernels import ops

    out = {}
    for op, fn, arg in (("dots", ops.block_dots, W),
                        ("combine", ops.block_combine, Y)):
        kw = dict(p=p, rows=rows) if op == "dots" else dict(p=p)
        a = arg if op == "dots" else arg[:rows]
        out[op] = _rel_err(fn(bc, a, kernel=True, **kw),
                           fn(bc, a, kernel=False, **kw))
    return out


def _one_hot_dots_check(bc, p, n, n_seg, spec):
    """Block dots against one-hot rows of W: each column of H is the
    decoded basis at that row's column (one product by 1, the rest by 0),
    at columns on chunk, stage and step edges of the kernel."""
    import torch

    from repro_torch.core import frsz2 as F
    from repro_torch.kernels import ops

    dev = bc.codes.device
    q = 8
    at = [0, 1, 255, 256, 4095, 4097, n_seg // 2 + 5, n - 1]
    W1 = torch.zeros((q, n), dtype=spec.dtype, device=dev)
    W1[torch.arange(q), torch.tensor(at)] = 1.0
    H = ops.block_dots(bc, W1, p=p, rows=R_FULL, kernel=True)
    M = R_FULL * p
    nbs = n_seg // spec.bs
    cv = bc.codes[:R_FULL].reshape(M, nbs, spec.bs)
    ev = bc.exps[:R_FULL].reshape(M, nbs)
    for b, c in enumerate(at):
        blk = c // spec.bs
        v = ops.decompress(F.BlockCompressed(
            codes=cv[:, blk:blk + 1].contiguous(),
            exps=ev[:, blk:blk + 1].contiguous(), n=spec.bs, spec=spec),
            kernel=False)[:, c % spec.bs]
        check(torch.equal(H[:, :, b].reshape(M), v),
              f"block dots with a one-hot row at column {c} != the decoded "
              "basis there")
    print(f"[block] dots with one-hot W rows at columns {at}: equal to the "
          "decoded basis")


def _combine_rows_equal(bc, p, Y, rows):
    """The combine kernel bit-equal to the row-order plain sum (one fma a
    segment row, rows in order: the first combine kernel's sum)."""
    import torch

    from repro_torch.kernels import ops, ref

    got = ops.block_combine(bc, Y[:rows], p=p, kernel=True)
    codes, exps, _ = ops._block_view(bc, p, rows)
    want = ref.block_combine_rows_ref(codes, exps,
                                      Y[:rows].reshape(rows * p, -1), bc.spec)
    return torch.equal(got, want)


def _combine_guard_checks(dev):
    """The combine over one segment row whose codec blocks carry exponents
    across the guard, Y = 1 (``cardcheck.combine_across_guard``): equal to
    ``decompress``."""
    import torch

    from repro_torch.core import frsz2 as F
    from repro_torch.kernels import cardcheck

    gen = torch.Generator(device=dev).manual_seed(37)
    checked = 0
    for dtype, bias in cardcheck.GUARD_DTYPES:
        for l in (32, 16, 8):
            ok, codes = cardcheck.combine_across_guard(dtype, bias, l, gen)
            check(ok, f"block combine across the guard "
                      f"({F.dtype_name(dtype)}, l={l}) != decompress")
            checked += codes
    print(f"[block] combine across the decode guards: {checked} codes (f64/f32,"
          " l 8/16/32, exponents 0..l+8, a spread, 2*bias+l-55..2*bias+l-53, "
          "2*bias-1..2*bias+1) equal to decompress")


def _combine_checks(bc, p, Y, n_seg, spec):
    """The combine at the main-path block shape: bit-equal to the row-order
    plain sum at EDGE_ROWS block rows (M = 8 ... 808) and to a second call;
    one-hot Y rows equal to the decoded basis rows, at segment rows on the
    edges of the ring turns and Y tiles."""
    import torch

    from repro_torch.core import frsz2 as F
    from repro_torch.kernels import ops
    from repro_torch.kernels.cardcheck import EDGE_ROWS, same_values

    for r in EDGE_ROWS:
        check(_combine_rows_equal(bc, p, Y, r),
              f"block combine rows={r} != the row-order plain sum")
    out = ops.block_combine(bc, Y, p=p, kernel=True)
    check(torch.equal(out, ops.block_combine(bc, Y, p=p, kernel=True)),
          "block combine: two calls differ")
    del out
    q = Y.shape[2]
    M = R_FULL * p
    at = [i for i in (0, 7, 8, 127, 128, 129, 511) if i < M - 1][:q - 1] + [M - 1]
    Y1 = torch.zeros_like(Y)
    for b, i in enumerate(at):
        Y1[i // p, i % p, b] = 1.0
    out = ops.block_combine(bc, Y1, p=p, kernel=True)
    nbs = n_seg // spec.bs
    cv = bc.codes[:R_FULL].reshape(M, nbs, spec.bs)
    ev = bc.exps[:R_FULL].reshape(M, nbs)
    for b, i in enumerate(at):
        v = ops.decompress(F.BlockCompressed(codes=cv[i], exps=ev[i], n=n_seg,
                                             spec=spec), kernel=False)
        check(same_values(out[b], v), f"block combine with a one-hot Y row "
                                      f"at segment row {i} != the decoded row")
    print(f"[block] combine bit-equal to the row-order plain sum at block rows"
          f" {list(EDGE_ROWS)} (M = {EDGE_ROWS[0] * p}..{M}) and to a second "
          f"call; one-hot Y rows at segment rows {at} equal to the decoded "
          "basis")
    _combine_guard_checks(bc.codes.device)


def phase_block_kernels(A):
    """The block kernels at the main-path block shape, and spot checks."""
    import torch

    from repro_torch.core import frsz2 as F
    from repro_torch.kernels import ops, ref

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(21)
    n = A.shape[0]
    p = q = P_BLOCK
    spec = F.FrszSpec(bs=32, l=32, dtype=torch.float64)
    acc, store, bc = _block_store(spec, p, n, R_FULL, gen)
    n_seg = acc.n_seg
    W = torch.randn((q, n), generator=gen, dtype=torch.float64, device=dev)
    Y = torch.randn((R_FULL, p, q), generator=gen, dtype=torch.float64,
                    device=dev)
    errs = {}
    for r in (R_FULL, R_HALF):
        errs[r] = _block_pair(bc, p, W, Y, r)
        for op, (abs_err, rel) in errs[r].items():
            check(rel <= 1e-12, f"block {op} r={r} relative error "
                                f"{rel:.3e} > 1e-12")
            print(f"[block] {op} rows={r} (p={p}, n_seg={n_seg}): max abs "
                  f"err {abs_err:.3e}, relative {rel:.3e}")
    check(torch.equal(ops.block_dots(bc, W, p=p, rows=R_FULL, kernel=True),
                      ops.block_dots(bc, W, p=p, rows=R_FULL, kernel=True)),
          "block dots: two calls differ")
    _one_hot_dots_check(bc, p, n, n_seg, spec)
    _combine_checks(bc, p, Y, n_seg, spec)

    # spot checks: f32 values, p = 1 and 3, a ragged n, other bs and l
    g2 = torch.Generator(device=dev).manual_seed(8)
    spots = [(torch.float32, 32, 32, 8), (torch.float64, 32, 32, 1),
             (torch.float64, 32, 32, 3), (torch.float64, 32, 8, 4),
             (torch.float64, 32, 64, 3), (torch.float64, 16, 128, 8),
             (torch.float32, 8, 32, 16), (torch.float64, 32, 32, 13),
             (torch.float64, 32, 1, 3), (torch.float32, 16, 8, 1)]
    for dtype, l, bs, pp in spots:
        sp = F.FrszSpec(bs=bs, l=l, dtype=dtype)
        _, _, sbc = _block_store(sp, pp, 1001, 7, g2)
        Ws = torch.randn((pp, 1001), generator=g2, dtype=dtype, device=dev)
        Ys = torch.randn((7, pp, pp), generator=g2, dtype=dtype, device=dev)
        tol = 1e-12 if dtype == torch.float64 else 1e-5
        for rows in (7, 3):
            for op, (_, rel) in _block_pair(sbc, pp, Ws, Ys, rows).items():
                check(rel <= tol, f"block {op} spot {sp.name} p={pp} "
                                  f"rows={rows}: relative error {rel:.3e}")
            check(_combine_rows_equal(sbc, pp, Ys, rows),
                  f"block combine spot {sp.name} p={pp} rows={rows} != the "
                  "row-order plain sum")
    print(f"[block] spot checks passed: {len(spots)} (f32/f64, p 1/3/4/8/13/"
          "16, n=1001 ragged, bs 1/8/32/64/128, l 8/16/32; the combine "
          "bit-equal to the row-order plain sum)")

    # the batched ELL SpMV: one launch for p operands, bit-equal
    E = A.to_ell()
    X = torch.randn((p, n), generator=gen, dtype=torch.float64, device=dev)
    yk = ops.ell_spmv(E.vals, E.cols, X, kernel=True)
    yp = ops.ell_spmv(E.vals, E.cols, X, kernel=False)
    check(torch.equal(yk, yp), "batched ell_spmv != plain")
    check(torch.equal(ops.ell_spmv(E.vals, E.cols, X, kernel=True), yk),
          "batched ell_spmv: two calls differ")
    g3 = torch.Generator(device=dev).manual_seed(31)
    for qq in (3, 16):
        Xq = torch.randn((qq, n), generator=g3, dtype=torch.float64,
                         device=dev)
        yq = ops.ell_spmv(E.vals, E.cols, Xq, kernel=True)
        check(torch.equal(yq, ops.ell_spmv(E.vals, E.cols, Xq, kernel=False)),
              f"batched ell_spmv q={qq} != plain")
        check(torch.equal(ops.ell_spmv(E.vals, E.cols, Xq, kernel=True), yq),
              f"batched ell_spmv q={qq}: two calls differ")
        del Xq, yq
    print(f"[block] batched ell_spmv (q = 3, {p}, 16 x {n}, "
          f"w={E.vals.shape[1]}): bit-equal to plain, two calls bit-equal")

    # the block Givens step over a cycle of m = 100 block steps
    m = M
    L = ref.block_givens_layout(m, p)
    sk = ref.block_givens_init_ref(m, p, dev)
    S = torch.triu(torch.rand((p, p), generator=gen, dtype=torch.float64,
                              device=dev)) + torch.eye(p, device=dev)
    sk[L["G"]:L["G"] + p * p] = S.reshape(-1)
    sp = sk.clone()
    bn = 1.0 + torch.rand((p,), generator=gen, dtype=torch.float64,
                          device=dev)
    for j in range(m):
        H = torch.randn((j + 1, p, p), generator=gen, dtype=torch.float64,
                        device=dev)
        T = torch.triu(torch.rand((p, p), generator=gen, dtype=torch.float64,
                                  device=dev)) + 0.5 * torch.eye(p, device=dev)
        fired = torch.tensor(j % 3 == 0, device=dev)
        ops.block_givens_step(sk, H, T, fired, bn, j, m, p, 1e-300,
                              kernel=True)
        ops.block_givens_step(sp, H, T, fired, bn, j, m, p, 1e-300,
                              kernel=False)
        check(torch.equal(sk, sp), f"gmres_block_givens != plain at step {j}")
    check(float(sk[L["alive"]]) == 1.0, "block Givens cycle died on random "
                                        "input")
    print(f"[block] block Givens step m={m} p={p}: kernel bit-equal to plain "
          f"over {m} steps")

    # times
    entries = {}
    src = "src/repro_torch/kernels/csrc/frsz2_block.cu"
    nb = n_seg // spec.bs
    seg_bytes = n_seg * 4 + nb * 4
    for r in (R_FULL, R_HALF):
        M_rows = r * p
        Vdec = ops.decompress(F.BlockCompressed(
            codes=bc.codes[:r].reshape(M_rows, nb, spec.bs),
            exps=bc.exps[:r].reshape(M_rows, nb), n=n_seg, spec=spec))
        Wp = torch.nn.functional.pad(W, (0, n_seg - n))
        Y2 = Y[:r].reshape(M_rows, q)
        flops = 2.0 * M_rows * n_seg * q
        for op, call, lib, replaces, io_bytes in (
                ("dots", lambda k, r=r: ops.block_dots(bc, W, p=p, rows=r,
                                                       kernel=k),
                 lambda V=Vdec, Wp=Wp: V @ Wp.T,
                 "src/repro/kernels/frsz2_block.py:64",
                 q * n_seg * 8 + M_rows * q * 8),
                ("combine", lambda k, r=r: ops.block_combine(bc, Y[:r], p=p,
                                                             kernel=k),
                 lambda V=Vdec, Y2=Y2: Y2.T @ V,
                 "src/repro/kernels/frsz2_block.py:104",
                 M_rows * q * 8 + q * n_seg * 8)):
            e = entry(f"frsz2_block_{op}", src, replaces,
                      timed(functools.partial(call, True)),
                      timed(functools.partial(call, False), reps=3),
                      M_rows * seg_bytes + io_bytes, flops, errs[r][op][0],
                      library_ms=timed(lib), rows=r, p=p, q=q,
                      shape=f"{r} x {p} x {n_seg}",
                      library="torch.mm on the decoded f64 basis",
                      path="block")
            if r == R_FULL:
                entries[f"frsz2_block_{op}"] = e
        del Vdec
    mat_bytes = E.vals.numel() * 8 + E.cols.numel() * 4
    csr = torch.sparse_csr_tensor(A.indptr, A.indices, A.data, size=A.shape)
    XT = X.T.contiguous()
    entries["ell_spmv_batched"] = entry(
        "ell_spmv_batched", "src/repro_torch/kernels/csrc/ell_spmv.cu",
        "src/repro/kernels/ell_spmv.py:49 (jax.vmap over ell_spmv_2d, "
        "src/repro/solver/block.py:219)",
        timed(lambda: ops.ell_spmv(E.vals, E.cols, X, kernel=True)),
        timed(lambda: ops.ell_spmv(E.vals, E.cols, X, kernel=False)),
        mat_bytes + 2 * p * n * 8, 2.0 * p * E.vals.numel(), 0.0,
        library_ms=timed(lambda: csr @ XT), kernel="ell_spmv",
        shape=f"{p} x {n} x {E.vals.shape[1]}", path="block",
        library="torch.sparse_csr_tensor @ X (n, 8)")
    j = m - 1
    H = torch.randn((j + 1, p, p), generator=gen, dtype=torch.float64,
                    device=dev)
    T = torch.triu(torch.rand((p, p), generator=gen, dtype=torch.float64,
                              device=dev)) + 0.5 * torch.eye(p, device=dev)
    fired = torch.tensor(False, device=dev)
    jp = j * p
    # bytes: H, T, bn, cs/sn of the jp earlier columns read; R's column
    # block, G's 2p rows, cs/sn's p rows and est written.  Flops: 6 per
    # element rotation, p columns, jp*p earlier and p*p new rotations
    nbytes = ((j + 1) * p * p + p * p + p + 2 * jp * p
              + (m + 1) * p * p + 2 * 2 * p * p + 2 * p * p + p) * 8
    flops = 6.0 * p * (jp * p + p * p)
    entries["gmres_block_givens"] = entry(
        "gmres_block_givens", "src/repro_torch/kernels/csrc/gmres_step.cu",
        "src/repro/solver/block.py:140 (jnp _block_apply_prior and "
        "_block_triangularize in the block cycle; no Pallas kernel: a "
        "helper, not a TPU-kernel port)",
        timed(lambda: ops.block_givens_step(sk, H, T, fired, bn, j, m, p,
                                            1e-300, kernel=True)),
        timed(lambda: ops.block_givens_step(sp, H, T, fired, bn, j, m, p,
                                            1e-300, kernel=False), reps=3),
        nbytes, flops, 0.0, shape=f"block step j={j} of m={m}, p={p}",
        helper=True, path="block")
    del store, bc
    return entries


def _block_row(label, A, B, x_sol, fmt, target, max_iters, method, driver,
               reorder="auto"):
    import torch

    from repro_torch.kernels import ops
    from repro_torch.solver import gmres_batched

    ops.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = gmres_batched(A, B, storage=fmt, m=M, max_iters=max_iters,
                        target_rrn=target, method=method, driver=driver,
                        reorder=reorder)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    X = torch.stack([r.x for r in res])
    err = float(torch.linalg.vector_norm(res[0].x - x_sol)
                / torch.linalg.vector_norm(x_sol))
    p = B.shape[0]
    row = dict(phase=label, n=A.shape[0], p=p, method=method,
               format=getattr(fmt, "name", fmt), driver=driver,
               iters=[r.iterations for r in res],
               restarts=[r.restarts for r in res],
               converged=all(r.converged for r in res),
               rrn_max=max(r.rrn for r in res), x_err_rhs0=err,
               wall_s=wall, wall_per_solve_s=wall / p,
               bytes_read_per_rhs=sum(r.bytes_read for r in res) / p,
               op_reads_per_rhs=sum(r.op_reads for r in res) / p,
               bytes_read=[r.bytes_read for r in res],
               op_reads=[r.op_reads for r in res],
               peak_mem_bytes=torch.cuda.max_memory_allocated(),
               launches=launches)
    if reorder != "auto":
        row["reorder"] = reorder
    emit(row)
    return res, X, row


def _check_block_drivers(dev_X, host_X, dev_row, host_row, what):
    import torch

    for key in ("iters", "restarts", "bytes_read", "op_reads"):
        check(dev_row[key] == host_row[key],
              f"{what}: block device driver {key} {dev_row[key]} != host "
              f"{host_row[key]}")
    check(torch.equal(dev_X, host_X), f"{what}: block device X != host X")


def phase_block_solve():
    """Block solves at n = 8000: device vs host driver, kernel vs plain
    route, and the vmap baseline."""
    from repro_torch.core.accessor import format_by_name
    from repro_torch.launch.solve import _batch_rhs
    from repro_torch.sparse import make_problem, rhs_for

    A, target = make_problem("synth:atmosmod", 8000, device="cuda")
    b, x_sol = rhs_for(A, device="cuda")
    B = _batch_rhs(b, P_BLOCK)
    host_rows = {}
    for fmt in ("frsz2_32", "float64"):
        _, Xh, rh = _block_row("block-solve", A, B, x_sol, fmt, target,
                               20000, "block", "host")
        host_rows[fmt] = rh
        _, Xd1, rd1 = _block_row("block-solve-capture", A, B, x_sol, fmt,
                                 target, 20000, "block", "device")
        _, Xd2, rd2 = _block_row("block-solve", A, B, x_sol, fmt, target,
                                 20000, "block", "device")
        _, _, rv = _block_row("vmap-solve", A, B, x_sol, fmt, target, 20000,
                              "vmap", "device")
        for r in (rh, rd1, rd2, rv):
            check(r["converged"], f"n=8000 {fmt} {r['method']} "
                                  f"{r['driver']} did not converge")
        _check_block_drivers(Xd1, Xh, rd1, rh, f"n=8000 {fmt}")
        _check_block_drivers(Xd2, Xh, rd2, rh, f"n=8000 {fmt} replay")
        if fmt == "frsz2_32":
            _check_launches(rd2, BLOCK_PATH, "n=8000 block frsz2_32")
        print(f"[block-solve] {fmt}: block device = host, iterations "
              f"{rd2['iters']}, restarts {rd2['restarts'][0]}; vmap "
              f"{rv['iters']}; bytes per RHS block/vmap "
              f"{rd2['bytes_read_per_rhs'] / rv['bytes_read_per_rhs']:.3f}")
    plain = format_by_name("frsz2_32", use_kernels=False)
    _, _, rp = _block_row("block-solve-plain", A, B, x_sol, plain, target,
                          20000, "block", "host")
    check(rp["converged"], "n=8000 plain-route block solve did not converge")
    rk = host_rows["frsz2_32"]
    check(all(abs(a - b) <= 1 for a, b in zip(rp["iters"], rk["iters"])),
          f"block kernel route {rk['iters']} vs plain {rp['iters']}")
    check(not any(v for k, v in rp["launches"].items()
                  if k.startswith("frsz2_")),
          f"plain route launched FRSZ2 kernels: {rp['launches']}")
    print(f"[block-solve] kernel route {rk['iters']}, plain route "
          f"{rp['iters']}")


def phase_block_full_width(A, target):
    """Slice 3's path at full width: returns its launches per kernel, read
    from the frsz2_32 block device-driver solve (the replay), and that
    solve's X and row (phase 7c compares against them).  Slice 9: the block
    steps a cycle where MGS fired, and one replayed cycle's launches
    (kernels 7 and 8 m + fired times)."""
    import torch

    from repro_torch.launch.solve import _batch_rhs
    from repro_torch.sparse import rhs_for

    b, x_sol = rhs_for(A, device="cuda")
    B = _batch_rhs(b, P_BLOCK)
    launches = {}
    for fmt in ("float64", "frsz2_32"):
        _, Xd1, rd1 = _block_row("block-full-capture", A, B, x_sol, fmt,
                                 target, FULL_MAX_ITERS, "block", "device")
        rs2, Xd2, rd2 = _block_row("block-full", A, B, x_sol, fmt, target,
                                   FULL_MAX_ITERS, "block", "device")
        # the replayed cycle's first cycle again, from the solve's inputs
        cyc = _last_cycle()
        bn = torch.clamp(torch.linalg.vector_norm(B, dim=1), min=1e-300)
        fired, counted = _one_replay(
            lambda: cyc(B, bn),
            (("frsz2_block_dots", "frsz2_block_combine")
             if fmt == "frsz2_32" else ()),
            "gmres_block_givens", M, f"full-width block {fmt}")
        check(fired == int(rs2[0].fired[0].sum()), f"full-width block {fmt}:"
              f" the replayed cycle fired {fired} steps, the solve's first "
              f"{int(rs2[0].fired[0].sum())}")
        emit(dict(phase="block-full-one-cycle", format=fmt, m=M, p=P_BLOCK,
                  fired=fired, launches=counted,
                  fired_device=rs2[0].fired.sum(1).tolist()))
        print(f"[block-full] {fmt}: MGS fired at "
              f"{rs2[0].fired.sum(1).tolist()} of {M} block steps a cycle; "
              "one replayed cycle launched "
              + ", ".join(f"{k} {v}" for k, v in counted.items()))
        del cyc
        _, Xh, rh = _block_row("block-full", A, B, x_sol, fmt, target,
                               FULL_MAX_ITERS, "block", "host")
        release()
        _, _, rv = _block_row("vmap-full", A, B, x_sol, fmt, target,
                              FULL_MAX_ITERS, "vmap", "device")
        release()
        for r in (rd1, rd2, rh, rv):
            check(r["converged"], f"full-width {fmt} {r['method']} "
                                  f"{r['driver']}: a column did not converge")
        _check_block_drivers(Xd1, Xh, rd1, rh, f"full-width {fmt}")
        _check_block_drivers(Xd2, Xh, rd2, rh, f"full-width {fmt} replay")
        ratio = rd2["bytes_read_per_rhs"] / rv["bytes_read_per_rhs"]
        check(torch.equal(Xd2, Xh), f"full-width block {fmt}: the replay "
              "and the host solve are not bit-equal")
        walls_before = (f" (branch-free pass {BRANCH_FREE_WALLS['block']:.4f} s)"
                    if fmt == "frsz2_32" else "")
        print(f"[block-full] {fmt}: block iterations {rd2['iters']} "
              f"restarts {rd2['restarts'][0]}, vmap {rv['iters']}; walls "
              f"block device first {rd1['wall_s']:.4f} s, replay "
              f"{rd2['wall_s']:.4f} s{walls_before}, host {rh['wall_s']:.4f} s, "
              f"vmap "
              f"{rv['wall_s']:.4f} s; peak memory block "
              f"{rd1['peak_mem_bytes'] / 2**30:.2f} GiB, vmap "
              f"{rv['peak_mem_bytes'] / 2**30:.2f} GiB; modelled basis "
              f"bytes per RHS block/vmap {ratio:.3f}")
        if fmt == "float64":
            _check_launches(rd2, ("ell_spmv", "gmres_block_givens"),
                            "float64 block solve")
        else:
            _check_launches(rd2, BLOCK_PATH, "frsz2_32 block solve (slice 3)")
            launches = {k: rd2["launches"][k] for k in BLOCK_PATH}
            replay = (Xd2, rd2)
    return launches, replay


def _plan_ell_times(A, plan, entries):
    """Kernels 5 and 6 on the raw and the RCM-permuted operator (w = 27):
    bit-equal to their plain versions on both, CUDA-event times beside the
    byte bound, added to the ``ell_spmv``/``ell_spmv_frsz2`` entries."""
    import torch

    from repro_torch.core import frsz2 as F
    from repro_torch.kernels import ops

    n = A.shape[0]
    gen = torch.Generator(device="cuda").manual_seed(19)
    x = torch.randn((n,), generator=gen, dtype=torch.float64, device="cuda")
    v = x / torch.linalg.vector_norm(x)
    bc = ops.compress(v, F.FrszSpec(bs=32, l=32, dtype=torch.float64))
    times = {}
    xd = ops.decompress(bc)
    for which, op in (("raw", A), ("rcm", plan.operator)):
        E = op._ell()
        w = E.vals.shape[1]
        check(w == 27, f"{which} unstructured operator has ELL width {w}")
        mat_bytes = E.vals.numel() * 8 + E.cols.numel() * 4
        csr = torch.sparse_csr_tensor(op.indptr, op.indices, op.data,
                                      size=op.shape)
        for name, operand, x_bytes in (
                ("ell_spmv", x, n * 8),
                ("ell_spmv_frsz2", bc,
                 bc.codes.numel() * 4 + bc.exps.numel() * 4)):
            yk = ops.ell_spmv(E.vals, E.cols, operand, kernel=True)
            yp = ops.ell_spmv(E.vals, E.cols, operand, kernel=False)
            check(torch.equal(yk, yp), f"{name} on the {which} unstructured "
                                       "operator != plain")
            ms = timed(lambda E=E, op=operand: ops.ell_spmv(
                E.vals, E.cols, op, kernel=True))
            plain = timed(lambda E=E, op=operand: ops.ell_spmv(
                E.vals, E.cols, op, kernel=False))
            lib_x = x if name == "ell_spmv" else xd
            lib = timed(lambda csr=csr, lx=lib_x: csr @ lx)
            bound, _ = bound_ms(mat_bytes + x_bytes + n * 8, 2.0 * n * w)
            times[name, which] = (ms, bound, plain, lib)
            print(f"[plan] {name} {which}: n={n} w={w} bit-equal to plain; "
                  f"{ms * 1e3:.1f} us, bound {bound * 1e3:.1f} us, plain "
                  f"{plain * 1e3:.1f} us, cuSPARSE {lib * 1e3:.1f} us")
    for name in ("ell_spmv", "ell_spmv_frsz2"):
        raw, rcm = times[name, "raw"], times[name, "rcm"]
        entries[name].update(unstructured_raw_ms=raw[0],
                             unstructured_rcm_ms=rcm[0],
                             unstructured_bound_ms=rcm[1],
                             unstructured_raw_plain_ms=raw[2],
                             unstructured_rcm_plain_ms=rcm[2],
                             unstructured_raw_library_ms=raw[3],
                             unstructured_rcm_library_ms=rcm[3])
        print(f"[plan] {name}: raw / rcm {raw[0] / rcm[0]:.3f}, rcm / bound "
              f"{rcm[0] / rcm[1]:.3f}")


def _plan_solves(A, target):
    """Full-width device solves of the unstructured operator, ``none``
    against ``rcm``: the agreement the permutation owes, and the replay of
    a repeated RCM solve."""
    import torch

    from repro_torch.solver.gmres import _GRAPHS
    from repro_torch.sparse import rhs_for

    b, x_sol = rhs_for(A, device="cuda")
    rcm_iters = {}
    for fmt in ("float64", "frsz2_32"):
        rows = {}
        for reorder in ("none", "rcm"):
            first = _solve_row("plan-capture", A, b, x_sol, fmt, target,
                               PLAN_MAX_ITERS, "device", reorder)
            keys = set(_GRAPHS)
            rows[reorder] = _solve_row("plan", A, b, x_sol, fmt, target,
                                       PLAN_MAX_ITERS, "device", reorder)
            check(set(_GRAPHS) == keys, f"{fmt} {reorder}: the repeated "
                                        "solve captured a new graph")
            check(rows[reorder][0].iterations == first[0].iterations
                  and torch.equal(rows[reorder][0].x, first[0].x),
                  f"{fmt} {reorder}: a repeated solve differs")
        (rn, wn), (rr, wr) = rows["none"], rows["rcm"]
        rcm_iters[fmt] = rr.iterations
        for res, what in ((rn, "none"), (rr, "rcm")):
            check(res.converged and bool(torch.isfinite(res.x).all()),
                  f"full-width unstructured {fmt} {what} did not converge "
                  f"within {PLAN_MAX_ITERS} iterations")
        d_it = rr.iterations - rn.iterations
        check(abs(d_it) <= 1 and rr.restarts == rn.restarts,
              f"{fmt}: rcm {rr.iterations} it / {rr.restarts} restarts, none "
              f"{rn.iterations} / {rn.restarts}")
        if d_it == 0:
            for key in ("bytes_read", "op_reads"):
                check(wr[key] == wn[key], f"{fmt}: rcm {key} {wr[key]} != "
                                          f"none {wn[key]}")
            check(wr["launches"] == wn["launches"],
                  f"{fmt}: replayed launches differ: rcm {wr['launches']}, "
                  f"none {wn['launches']}")
        x_rel = float(torch.linalg.vector_norm(rr.x - rn.x)
                      / torch.linalg.vector_norm(rn.x))
        check(x_rel <= 1e-9, f"{fmt}: rcm x vs none x relative {x_rel:.3e}")
        rrn_rel = abs(rr.rrn - rn.rrn) / rn.rrn
        if fmt == "float64":
            # tests/test_reorder.py's tolerance: 1e-5 relative, 1e-16
            # absolute (an RRN near 1e-13 is resolved to ~1e-18)
            check(abs(rr.rrn - rn.rrn) <= 1e-16 + 1e-5 * rn.rrn,
                  f"{fmt}: rcm RRN {rr.rrn:.6e} vs none {rn.rrn:.6e}")
        else:
            # FRSZ2's block exponents span 32 consecutive entries, which
            # the permutation regroups: another compressed basis, whose
            # final RRN differs below the target
            check(max(rr.rrn, rn.rrn) <= target,
                  f"{fmt}: RRN rcm {rr.rrn:.3e} none {rn.rrn:.3e} over the "
                  f"target {target:.1e}")
        print(f"[plan] {fmt}: iterations none {rn.iterations} rcm "
              f"{rr.iterations} ({d_it:+d}), restarts {rn.restarts}; RRN "
              f"none {rn.rrn:.6e} rcm {rr.rrn:.6e} (relative {rrn_rel:.3e}); "
              f"x relative {x_rel:.3e}; wall none {wn['wall_s']:.4f} s "
              f"({wn['wall_per_iter_ms']:.4f} ms/it), rcm {wr['wall_s']:.4f} "
              f"s ({wr['wall_per_iter_ms']:.4f} ms/it), ratio "
              f"{wr['wall_per_iter_ms'] / wn['wall_per_iter_ms']:.3f}; "
              "repeated solves replayed (no recapture)")
    return rcm_iters


def _plan_block_solve(A, target):
    """The RCM block solve (p = 8, frsz2_32) against the unreordered one."""
    import torch

    from repro_torch.launch.solve import _batch_rhs
    from repro_torch.sparse import rhs_for

    b, x_sol = rhs_for(A, device="cuda")
    B = _batch_rhs(b, P_BLOCK)
    out = {}
    for reorder in ("none", "rcm"):
        _, X, row = _block_row("plan-block", A, B, x_sol, "frsz2_32", target,
                               PLAN_BLOCK_MAX_ITERS, "block", "device",
                               reorder)
        out[reorder] = (X, row)
        release()
    (Xn, rn), (Xr, rr) = out["none"], out["rcm"]
    check(rr["iters"] == rn["iters"], f"block rcm iterations {rr['iters']} "
                                      f"!= none {rn['iters']}")
    check(bool(torch.isfinite(Xr).all()), "block rcm X not finite")
    x_rel = float(torch.linalg.vector_norm(Xr - Xn)
                  / torch.linalg.vector_norm(Xn))
    check(x_rel <= 1e-9, f"block rcm X vs none relative {x_rel:.3e}")
    _check_launches(rr, BLOCK_PATH, "full-width rcm block solve")
    print(f"[plan] block p={P_BLOCK} frsz2_32: iterations {rr['iters']} "
          f"(none {rn['iters']}), converged {rr['converged']}/"
          f"{rn['converged']}, X relative {x_rel:.3e}; walls none "
          f"{rn['wall_s']:.4f} s, rcm {rr['wall_s']:.4f} s")


def _plan_emulators(n_row):
    """The emulator formats: device driver (one captured graph a cycle)
    against the host driver at n = 8000, and the roundtrip of a
    full-width row on the card against the CPU's, timed."""
    import torch

    from repro_torch.core.accessor import format_by_name
    from repro_torch.sparse import make_problem, rhs_for

    A, target = make_problem("synth:atmosmod", 8000, device="cuda")
    b, x_sol = rhs_for(A, device="cuda")
    for name in EMUL_FORMATS:
        h, rh = _solve_row("emul", A, b, x_sol, name, target, 20000, "host")
        d1, rd1 = _solve_row("emul-capture", A, b, x_sol, name, target,
                             20000, "device")
        d2, rd2 = _solve_row("emul", A, b, x_sol, name, target, 20000,
                             "device")
        check(h.converged and d1.converged, f"{name} did not converge")
        _check_drivers_agree(d1, h, rd1, rh, name)
        _check_drivers_agree(d2, h, rd2, rh, f"{name} replay")
        check(torch.equal(d1.x, d2.x), f"{name}: two device solves differ")
        print(f"[plan] {name}: device {d2.iterations} it = host "
              f"{h.iterations} it, bytes_read {rd2['bytes_read']:.0f}")
    gen = torch.Generator(device="cuda").manual_seed(23)
    v = torch.randn((n_row,), generator=gen, dtype=torch.float64,
                    device="cuda")
    v = v / torch.linalg.vector_norm(v)
    vc = v.cpu()
    for name in EMUL_FORMATS:
        fmt = format_by_name(name)
        got = fmt.roundtrip(v).cpu()
        want = fmt.roundtrip(vc)
        n_diff = int((got.view(torch.int64) != want.view(torch.int64)).sum())
        ulps = int((got.view(torch.int64) - want.view(torch.int64)).abs()
                   .max())
        if "pwrel" not in name:
            check(n_diff == 0, f"{name} roundtrip on the card != CPU in "
                               f"{n_diff} of {n_row} entries")
        ms = timed(lambda f=fmt: f.roundtrip(v))
        bound, _ = bound_ms(16.0 * n_row)
        emit(dict(phase="plan-emul", format=name, n=n_row, card_vs_cpu_diff=
                  n_diff, max_ulps=ulps, ms=ms, bound_ms=bound))
        print(f"[plan] {name} roundtrip n={n_row}: card vs CPU {n_diff} "
              f"entries differ (max {ulps} ulp); {ms * 1e3:.1f} us, bound "
              f"{bound * 1e3:.2f} us")


def phase_plan(entries):
    """Operator planning at full width (slice 5): the RCM plan of
    ``synth:unstructured`` (n = 1,259,712, w = 27) built on the host and
    fetched again from the plan cache, kernels 5 and 6 on the raw and the
    permuted operator, ``none`` against ``rcm`` solves, the RCM block
    solve, and the emulator formats."""
    import torch

    from repro_torch.sparse import make_problem, plan_operator
    from repro_torch.sparse.reorder import rcm_permutation

    t0 = time.perf_counter()
    A, target = make_problem("synth:unstructured", PLAN_N, device="cuda")
    torch.cuda.synchronize()
    t_make = time.perf_counter() - t0
    check(A.shape[0] == PLAN_N, f"unstructured n = {A.shape[0]}")
    t0 = time.perf_counter()
    plan = plan_operator(A, 1, reorder="rcm")
    torch.cuda.synchronize()
    t_plan = time.perf_counter() - t0
    t0 = time.perf_counter()
    again = plan_operator(A, 1, reorder="rcm")
    t_hit = time.perf_counter() - t0
    check(again is plan, "a second plan_operator call missed the cache")
    check(t_hit < 1.0, f"the plan-cache hit took {t_hit:.3f} s")
    t0 = time.perf_counter()
    perm = rcm_permutation(A)
    t_rcm = time.perf_counter() - t0
    check(bool((perm == plan.perm).all()), "rcm_permutation not repeatable")
    check(plan.reorder == "rcm" and plan.probe.bandwidth < plan.raw_bandwidth,
          f"RCM did not narrow the band: {plan.describe()}")
    emit(dict(phase="plan-build", n=A.shape[0], nnz=A.nnz,
              make_problem_s=t_make, plan_s=t_plan, plan_hit_s=t_hit,
              rcm_permutation_s=t_rcm, raw_bandwidth=plan.raw_bandwidth,
              rcm_bandwidth=plan.probe.bandwidth))
    print(f"[plan] {plan.describe()}; nnz {A.nnz}; host: make_problem "
          f"{t_make:.2f} s, plan_operator {t_plan:.2f} s (rcm_permutation "
          f"alone {t_rcm:.2f} s), cache hit {t_hit * 1e3:.3f} ms")
    _plan_ell_times(A, plan, entries)
    rcm_iters = _plan_solves(A, target)
    release()
    _plan_sharded_solve(A, target, rcm_iters["frsz2_32"])
    release()
    _plan_block_solve(A, target)
    del A, plan, again
    release()
    _plan_emulators(PLAN_N)


# ---------------------------------------------------------------------------
# Phase 7c: the sharded solve (slice 6)
# ---------------------------------------------------------------------------


def _sharded_row(label, A, b, x_sol, fmt, target, max_iters, transport,
                 matvec="halo", reorder="auto"):
    """One ``gmres(..., shard=P)`` solve on this process's rank, as
    :func:`_solve_row` records it."""
    import torch
    import torch.distributed as dist

    from repro_torch.kernels import ops
    from repro_torch.solver import gmres

    ops.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = gmres(A, b, storage=fmt, m=M, max_iters=max_iters,
                target_rrn=target, shard=dist.get_world_size(),
                shard_transport=transport, shard_matvec=matvec,
                reorder=reorder)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    err = float(torch.linalg.vector_norm(res.x - x_sol)
                / torch.linalg.vector_norm(x_sol))
    row = dict(phase=label, n=A.shape[0], format=fmt,
               shard=dist.get_world_size(), transport=transport,
               matvec=matvec, reorder=reorder, iters=res.iterations,
               restarts=res.restarts, rrn=res.rrn,
               converged=bool(res.converged), x_err=err, wall_s=wall,
               wall_per_iter_ms=wall * 1e3 / max(res.iterations, 1),
               bytes_read=res.bytes_read, op_reads=res.op_reads,
               peak_mem_bytes=torch.cuda.max_memory_allocated(),
               launches=dict(ops.LAUNCHES))
    emit(row)
    return res, row


def _sharded_kernels(A):
    """Kernels 1 and 2 at the two wire specs on the main path's payloads,
    and kernel 5 on the halo-localized ELL of this rank's chunk: bit-equal
    to their plain versions, timed beside their byte bounds."""
    import torch
    import torch.distributed as dist

    from repro_torch.core import frsz2 as F
    from repro_torch.dist import collectives
    from repro_torch.kernels import ops
    from repro_torch.sparse import partition_matvec, plan_operator

    P, rank = dist.get_world_size(), dist.get_rank()
    plan = plan_operator(A, P, matvec_mode="halo")
    check(plan.matvec_mode == "halo", f"atmosmodd plan: {plan.describe()}")
    gen = torch.Generator(device="cuda").manual_seed(29)
    codec_src = "src/repro_torch/kernels/csrc/frsz2_codec.cu"
    entries = {}
    # the dots' wire: the m + 1 partials of one reduction, as f32
    h = torch.randn((M + 1,), generator=gen, dtype=torch.float64,
                    device="cuda")
    strip = torch.randn((plan.probe.strips[0],), generator=gen,
                        dtype=torch.float64, device="cuda")
    for tag, x, spec in (
            ("wire", h.to(torch.float32), collectives.WIRE_SPEC),
            ("halo", strip, collectives.halo_wire_spec(torch.float64))):
        bc, _, code_err, value_err = _codec_pair(x, spec)
        code_bytes = bc.codes.numel() * bc.codes.element_size() \
            + bc.exps.numel() * 4
        x_bytes = x.numel() * x.element_size()
        what = f"{x.numel()} x {F.dtype_name(spec.dtype)}, bs {spec.bs}, " \
               f"l {spec.l}"
        entries[f"frsz2_compress_{tag}"] = entry(
            f"frsz2_compress_{tag}", codec_src,
            "src/repro/kernels/frsz2_kernel.py:113",
            timed(lambda x=x, spec=spec: ops.compress(x, spec, kernel=True)),
            timed(lambda x=x, spec=spec: ops.compress(x, spec,
                                                      kernel=False)),
            x_bytes + code_bytes, 0.0, code_err, kernel="frsz2_compress",
            path="sharded", shape=what, err_unit="code")
        entries[f"frsz2_decompress_{tag}"] = entry(
            f"frsz2_decompress_{tag}", codec_src,
            "src/repro/kernels/frsz2_kernel.py:75",
            timed(lambda bc=bc: ops.decompress(bc, kernel=True)),
            timed(lambda bc=bc: ops.decompress(bc, kernel=False)),
            code_bytes + x_bytes, 0.0, value_err, kernel="frsz2_decompress",
            path="sharded", shape=what)
        print(f"[sharded] codec at {what}: bit-equal to plain")
    # kernel 5 on the localized columns, against the halo-extended chunk
    mv = partition_matvec(plan=plan, rank=rank, device="cuda")
    part = mv.partition
    x = torch.randn((plan.n_local,), generator=gen, dtype=torch.float64,
                    device="cuda")
    x_ext = collectives.halo_exchange(x, plan.probe.strips, P)
    yk = ops.ell_spmv(part.vals, part.cols, x_ext, kernel=True)
    yp = ops.ell_spmv(part.vals, part.cols, x_ext, kernel=False)
    check(torch.equal(yk, yp), "kernel 5 on the halo-localized ELL != plain")
    check(torch.equal(mv(x), yk), "the halo matvec != kernel 5 on x_ext")
    nr, w = part.vals.shape
    nbytes = part.vals.numel() * 8 + part.cols.numel() * 4 \
        + x_ext.numel() * 8 + nr * 8
    csr = torch.sparse_csr_tensor(A.indptr, A.indices, A.data, size=A.shape)
    lib = timed(lambda: csr @ x) if P == 1 else None
    entries["ell_spmv_halo"] = entry(
        "ell_spmv_halo", "src/repro_torch/kernels/csrc/ell_spmv.cu",
        "src/repro/kernels/ell_spmv.py:49",
        timed(lambda: ops.ell_spmv(part.vals, part.cols, x_ext,
                                   kernel=True)),
        timed(lambda: ops.ell_spmv(part.vals, part.cols, x_ext,
                                   kernel=False)),
        nbytes, 2.0 * nr * w, 0.0, library_ms=lib, kernel="ell_spmv",
        path="sharded",
        shape=f"{nr} x {w} rows of rank {rank}, x_ext {x_ext.numel()}",
        library="torch.sparse_csr_tensor @ x (the whole operator, one rank)")
    print(f"[sharded] kernel 5 on the halo-localized ELL ({nr} x {w}, "
          f"x_ext {x_ext.numel()}): bit-equal to plain and to the matvec")
    t = _peer_gather_times(P)
    sc = t["scalar"]
    entries["peer_gather"] = entry(
        "peer_gather", "src/repro_torch/kernels/csrc/peer_gather.cu",
        "src/repro/solver/pipeline.py:118-132 (the psums inside "
        "jax.lax.cond's branch of MGS's second pass; no Pallas kernel: a "
        "helper, not a TPU-kernel port)",
        sc["ms"], sc["plain_ms"], sc["moved"], 0.0, 0.0,
        library_ms=sc["library_ms"], kernel="peer_gather", path="sharded",
        shape=f"{sc['shape']} f64 over {P} rank(s)", helper=True,
        library="NCCL all_reduce of the same values (collectives.psum)",
        coded=t["coded"], block=t["block"])
    return entries


def _peer_gather_times(P: int) -> dict:
    """Slice 10's helper kernel on this rank of the default group of P
    (every rank calls it together): the peer reduction
    (``csrc/peer_gather.cu``: every rank's buffer gathered through peer
    memory and summed in rank order) at MGS's second-pass sizes, the scalar
    body's (m + 1) f64 dots plain and coded (``WIRE_SPEC`` codes, decoded
    before the sum) and the block body's (m + 1) p^2 f64 plain, bit-equal
    to its plain version (NCCL's all-gather, the decode, the sum in rank
    order) twice (the slots' two parities); its CUDA-event time beside the
    plain version's, NCCL's all-reduce of the same f64 values
    (``collectives.psum``, the yardstick) and its bound: the larger of the
    bytes over HBM (the buffer read, the sums written) and P - 1 buffers
    over NVLink each way.  Latency rules at these sizes."""
    import torch

    from repro_torch.dist import collectives
    from repro_torch.kernels import ops, peer_gather
    from repro_torch.solver.sharded import second_pass_bytes

    gen = torch.Generator(device="cuda").manual_seed(37)
    route = peer_gather.Route(None, "cuda", second_pass_bytes(M, P_BLOCK))
    out = {}
    for tag, shape, coded in (("scalar", (M + 1,), False),
                              ("coded", (M + 1,), True),
                              ("block", (M + 1, P_BLOCK, P_BLOCK), False)):
        x = torch.randn(shape, generator=gen, dtype=torch.float64,
                        device="cuda")
        src, kw = x, {}
        if coded:
            bc = ops.compress(x.reshape(-1).to(collectives.WIRE_SPEC.dtype),
                              collectives.WIRE_SPEC)
            src, kw = collectives._pack(bc), dict(coded=bc,
                                                  out_dtype=torch.float64)

        def kern(src=src, kw=kw):
            return peer_gather.reduce(src, route, **kw)  # graphlint: ok[raw-collective] the kernel against its plain version

        def plain(src=src, kw=kw):
            return peer_gather.reduce(src, route, kernel=False, **kw)  # graphlint: ok[raw-collective] its plain version

        for _ in range(2):
            check(torch.equal(kern(), plain()),
                  f"peer reduction of {tag} {shape} over {P} rank(s) != its "
                  "plain version")
        nbytes = src.numel() * src.element_size()
        moved = nbytes + x.numel() * x.element_size()
        hbm = moved / HBM_BYTES_PER_S * 1e3
        link = (P - 1) * nbytes / NVLINK_BYTES_PER_S * 1e3
        out[tag] = dict(shape=list(shape), nbytes=nbytes, moved=moved, P=P,
                        ms=timed(kern), plain_ms=timed(plain),
                        library_ms=timed(lambda x=x: collectives.psum(x)),
                        bound_ms=max(hbm, link),
                        bound_by="bytes (NVLink)" if link > hbm else "bytes")
    if torch.distributed.get_rank() != 0:
        return out
    print(f"[peer_gather] over {P} rank(s): " + "; ".join(
        f"{tag} {r['nbytes']} B: kernel {r['ms'] * 1e3:.1f} us, plain "
        f"(NCCL all-gather + sum) {r['plain_ms'] * 1e3:.1f} us, NCCL "
        f"all-reduce {r['library_ms'] * 1e3:.1f} us, bound "
        f"{r['bound_ms'] * 1e3:.3f} us" for tag, r in out.items())
        + "; bit-equal to the plain version", flush=True)
    return out


def _mgs_mixed(A, b, target, P: int) -> dict:
    """Slice 10's main path: the full-width frsz2_32 MGS solve sharded over
    the default group of P ranks (halo matvec, plain transport) at eta
    :data:`MIXED_ETA`, where the second pass fires at some steps and not at
    others, captured and then replayed, the replay under the census with
    the launch counts set to 0 just before and read just after; then one
    replayed cycle on its own inputs against the same cycle run eagerly
    (``cardcheck.replay_against_eager``).  Every rank calls it; returns
    its row (:func:`_check_mgs_mixed` holds it)."""
    import torch

    from repro_torch.analysis import traffic
    from repro_torch.dist.census import Census
    from repro_torch.dist.collectives import reduce_bytes
    from repro_torch.kernels import cardcheck, ops
    from repro_torch.solver import gmres
    from repro_torch.solver.sharded import cycle_wire_bytes

    kw = dict(storage="frsz2_32", m=M, max_iters=FULL_MAX_ITERS,
              target_rrn=target, eta=MIXED_ETA, shard=P,
              shard_transport="plain", shard_matvec="halo")
    first = gmres(A, b, **kw)
    ops.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with Census() as cen:
        res = gmres(A, b, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    cyc = cardcheck.last_sharded_cycle()
    one_fired, one, eager_equal = cardcheck.replay_against_eager(cyc)
    fired = [int(c.sum()) for c in res.fired]
    # the cycles' reductions as cycle_wire_bytes prices them, less the two
    # restart norms it adds a cycle (the restart loop issues those)
    r1 = reduce_bytes(1, compressed=False)
    model = [cycle_wire_bytes(M, M, f, passes=1, dots_compressed=False,
                              norms_compressed=False, inner_mv_bytes=0,
                              residual_mv_bytes=0) for f in fired]
    priced = traffic.price_calls(cen.calls)["cycle"]
    return dict(
        phase="sharded-mgs-mixed", shard=P, eta=MIXED_ETA,
        format="frsz2_32", transport="plain", matvec="halo",
        route=res.second_pass, iters=res.iterations, restarts=res.restarts,
        rrn=res.rrn, converged=bool(res.converged), fired=fired,
        replay_equal=bool(torch.equal(first.x, res.x)
                          and first.iterations == res.iterations),
        wall_s=wall, wall_per_iter_ms=wall * 1e3 / max(res.iterations, 1),
        bytes_read=res.bytes_read,
        launches={k: launches[k] for k in SHARDED_PATH},
        one_cycle=dict(fired=one_fired, eager_equal=eager_equal,
                       launches={k: one[k] for k in (
                           "frsz2_matvec", "frsz2_rmatvec", "graph_if",
                           "gmres_givens", "peer_gather")}),
        census_cycle={k: priced.get(k, 0) for k in ("dots", "norms")},
        model_cycle=dict(dots=sum(c["dots"] for c in model),
                         norms=sum(c["norms"] - 2 * r1 for c in model)),
        body_calls=sorted({c.name for body in cyc.bodies
                           for c in body.calls}))


@contextlib.contextmanager
def _without_peer_access():
    """Inside, a sharded solve takes the select route (the branch-free
    pass, its reductions on NCCL), as on cards without peer access: the
    capability the route is decided from (``peer_gather.reachable``)
    answers no, and its cached answers are forgotten on both sides."""
    import repro_torch.solver.sharded as S
    from repro_torch.kernels import peer_gather

    reachable = peer_gather.reachable
    peer_gather.reachable = lambda group, device: False
    S._REACHABLE.clear()
    try:
        yield
    finally:
        peer_gather.reachable = reachable
        S._REACHABLE.clear()


def _split_summary(split: dict) -> dict:
    """The card's time in one replayed cycle (``cardcheck.profiled_split``)
    by kind: NCCL's kernels, the peer kernel, the basis kernels 3 and 4,
    the ELL, the rest; with the busy and span microseconds."""
    kinds = dict(nccl=0.0, peer_gather=0.0, kernels_3_4=0.0, ell=0.0,
                 other=0.0)
    for name, us in split["kernels"].items():
        if name.startswith("nccl"):
            kinds["nccl"] += us
        elif name == "peer_reduce_kernel":
            kinds["peer_gather"] += us
        elif name in ("matvec_rows_kernel", "matvec_finish_kernel",
                      "rmatvec_rows_kernel"):
            kinds["kernels_3_4"] += us
        elif name.startswith("ell_"):
            kinds["ell"] += us
        else:
            kinds["other"] += us
    return dict(kinds, busy_us=split["busy_us"], span_us=split["span_us"],
                top=dict(list(split["kernels"].items())[:8]))


def _second_pass_routes(A, b, target, P: int) -> dict:
    """The full-width frsz2_32 MGS solve sharded over the default group of
    P ranks at the default eta (the pass fires at nearly every step), halo
    matvec, plain and compressed transports, on the group's route
    (``if+peer_gather``: the IF node, its reductions on the peer kernel)
    and on the select route (:func:`_without_peer_access`), in the order
    route, select, select, route: each solve captured, then replayed three
    times (walls by the host clock ending in a synchronize), then one
    replayed cycle under the profiler (``cardcheck.profiled_split``; the
    first of each route is printed: after a captured graph has been freed
    the profiler may misname the kernels of an IF node's body, so the
    split by kernel of the route's first run holds only in a process that
    has freed none).  Every rank calls it; returns one row."""
    import torch

    from repro_torch.kernels import cardcheck
    from repro_torch.solver import clear_graph_cache, gmres

    row = dict(phase="sharded-routes", shard=P, format="frsz2_32",
               matvec="halo")
    for transport in ("plain", "compressed"):
        kw = dict(storage="frsz2_32", m=M, max_iters=FULL_MAX_ITERS,
                  target_rrn=target, shard=P, shard_transport=transport,
                  shard_matvec="halo")
        runs = {"peer": [], "select": []}
        for route in ("peer", "select", "select", "peer"):
            with (_without_peer_access() if route == "select"
                  else contextlib.nullcontext()):
                gmres(A, b, **kw)
                walls = []
                for _ in range(3):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    res = gmres(A, b, **kw)
                    torch.cuda.synchronize()
                    walls.append(time.perf_counter() - t0)
                cyc = cardcheck.last_sharded_cycle()
                r, beta, bn = (cyc.r.clone(), cyc.beta.clone(),
                               cyc.b_norm.clone())
                split = cardcheck.profiled_split(lambda: cyc(r, beta, bn))
            runs[route].append(dict(
                route=res.second_pass, iters=res.iterations,
                converged=bool(res.converged),
                fired=res.fired.sum(1).tolist(), walls=walls,
                ms_per_iter=min(walls) * 1e3 / max(res.iterations, 1),
                cycle=_split_summary(split)))
            clear_graph_cache()
        row[transport] = runs
    return row


def _check_routes(row) -> None:
    """The checks of a :func:`_second_pass_routes` row, and its print."""
    P = row["shard"]
    for transport in ("plain", "compressed"):
        runs = row[transport]
        what = f"frsz2_32 {transport} MGS over {P} rank(s)"
        check(all(r["route"] == "if+peer_gather" for r in runs["peer"])
              and all(r["route"] == "select" for r in runs["select"]),
              f"{what}: routes {[r['route'] for v in runs.values() for r in v]}")
        check(all(r["converged"] for v in runs.values() for r in v),
              f"{what}: a solve did not converge")
        # the plain norm sums in another order on each route: within one
        its = [r["iters"] for v in runs.values() for r in v]
        check(max(its) - min(its) <= 1, f"{what}: iterations {its}")
        med = {k: statistics.median(r["ms_per_iter"] for r in v)
               for k, v in runs.items()}
        cyc = {k: v[0]["cycle"] for k, v in runs.items()}
        print(f"[sharded] {what}, default eta (fired {runs['peer'][0]['fired']}"
              f"): ms/it IF+peer {med['peer']:.4f}, select {med['select']:.4f}"
              f" ({[round(r['ms_per_iter'], 4) for v in runs.values() for r in v]}"
              "); one replayed cycle on the card (us): " + "; ".join(
                  f"{k}: busy {c['busy_us']:.0f} of {c['span_us']:.0f}, nccl "
                  f"{c['nccl']:.0f}, peer {c['peer_gather']:.0f}, kernels 3/4 "
                  f"{c['kernels_3_4']:.0f}, ell {c['ell']:.0f}, other "
                  f"{c['other']:.0f}" for k, c in cyc.items()), flush=True)


def _check_mgs_mixed(row, unsharded_iters, tol: int) -> None:
    """The checks of a :func:`_mgs_mixed` row: the IF node with the peer
    gather; converged, the replay equal to the capture and one replayed
    cycle to the same cycle run eagerly; the fired pattern mixed; kernels
    3 and 4 m + fired times in that cycle, the IF condition m times, the
    peer gather twice a fired step (the dots and the norm); the census of
    the cycles' reductions equal to ``cycle_wire_bytes`` with each cycle's
    fired steps; only peer gathers in the IF bodies; iterations within
    ``tol`` of the unsharded solve's."""
    what = f"MGS at eta {row['eta']} over {row['shard']} rank(s)"
    check(row["route"] == "if+peer_gather",
          f"{what}: second pass route {row['route']}")
    check(row["converged"] and row["replay_equal"],
          f"{what}: not converged or the replay differs")
    one = row["one_cycle"]
    f = one["fired"]
    check(one["eager_equal"], f"{what}: a replayed cycle differs from the "
                              "same cycle run eagerly")
    check(0 < sum(row["fired"]) < M * len(row["fired"]),
          f"{what}: the fired pattern {row['fired']} is not mixed")
    want = dict(frsz2_matvec=M + f, frsz2_rmatvec=M + f, graph_if=M,
                gmres_givens=M, peer_gather=2 * f)
    check(one["launches"] == want, f"{what}: one replayed cycle launched "
                                   f"{one['launches']}, expected {want}")
    check(row["census_cycle"] == row["model_cycle"],
          f"{what}: the census of the cycles' reductions "
          f"{row['census_cycle']} != cycle_wire_bytes {row['model_cycle']}")
    check(row["body_calls"] == ["peer_gather"],
          f"{what}: the IF bodies hold {row['body_calls']}")
    check(abs(row["iters"] - unsharded_iters) <= tol,
          f"{what}: {row['iters']} it vs unsharded {unsharded_iters}")
    print(f"[sharded] {what}: route {row['route']}, {row['iters']} it "
          f"(unsharded {unsharded_iters}), fired {row['fired']} of "
          f"{M} a cycle; one replayed cycle ({f} fired): kernels 3/4 "
          f"{one['launches']['frsz2_rmatvec']}, peer gathers "
          f"{one['launches']['peer_gather']}, IF conditions "
          f"{one['launches']['graph_if']}, bit-equal to the eager cycle; "
          f"census dots {row['census_cycle']['dots']} B, norms "
          f"{row['census_cycle']['norms']} B = cycle_wire_bytes; wall "
          f"{row['wall_per_iter_ms']:.4f} ms/it")


def phase_sharded(A, target, unsharded, block_unsharded):
    """Slice 6's path on this process's NCCL rank at full width: returns
    the kernel entries and the launches per kernel, read from the
    frsz2_32 compressed-transport replay (every kernel of the path)."""
    import torch

    from repro_torch.launch.solve import _batch_rhs
    from repro_torch.solver.gmres import _GRAPHS
    from repro_torch.sparse import rhs_for

    entries = _sharded_kernels(A)
    b, x_sol = rhs_for(A, device="cuda")
    launches = None
    for fmt in ("frsz2_32", "float64"):
        d, rd = unsharded[fmt]
        runs = {}
        for transport in TRANSPORTS:
            first, _ = _sharded_row("sharded-capture", A, b, x_sol, fmt,
                                    target, FULL_MAX_ITERS, transport)
            keys = set(_GRAPHS)
            res, row = _sharded_row("sharded", A, b, x_sol, fmt, target,
                                    FULL_MAX_ITERS, transport)
            check(set(_GRAPHS) == keys, f"sharded {fmt} {transport}: the "
                                        "repeated solve captured a new graph")
            check(torch.equal(res.x, first.x) and
                  res.iterations == first.iterations,
                  f"sharded {fmt} {transport}: a replayed solve differs")
            check(res.converged and res.rrn <= target,
                  f"sharded {fmt} {transport} did not converge: "
                  f"{res.iterations} it, RRN {res.rrn:.3e}")
            runs[transport] = (res, row)
            if transport == "compressed" and fmt == "frsz2_32":
                _check_launches(row, SHARDED_PATH,
                                "sharded frsz2_32 solve (slice 6)")
                check(row["launches"]["ell_spmv_frsz2"] == 0,
                      "the sharded solve launched the coded-operand ELL")
                launches = {k: row["launches"][k] for k in SHARDED_PATH}
            release()
        res, row = runs["plain"]
        for key in ("iters", "restarts", "bytes_read", "op_reads"):
            check(row[key] == rd[key], f"sharded plain {fmt}: {key} "
                                       f"{row[key]} != unsharded {rd[key]}")
        x_rel = float(torch.linalg.vector_norm(res.x - d.x)
                      / torch.linalg.vector_norm(d.x))
        check(x_rel <= 1e-12, f"sharded plain {fmt}: x relative {x_rel:.3e}")
        for transport in TRANSPORTS[1:]:
            it = runs[transport][1]["iters"]
            check(abs(it - row["iters"]) <= 2,
                  f"sharded {fmt} {transport}: {it} it vs plain "
                  f"{row['iters']}")
        print(f"[sharded] {fmt}: iterations unsharded {rd['iters']}, "
              + ", ".join(f"{t} {runs[t][1]['iters']}" for t in TRANSPORTS)
              + f"; plain x relative {x_rel:.3e}; wall per iteration "
              f"unsharded {rd['wall_per_iter_ms']:.4f} ms, "
              + ", ".join(f"{t} {runs[t][1]['wall_per_iter_ms']:.4f} ms"
                          for t in TRANSPORTS))
    # the sharded block solve against phase 7's unsharded one
    import torch.distributed as dist

    from repro_torch.kernels import ops
    from repro_torch.solver import gmres_batched

    Xu, ru = block_unsharded
    B = _batch_rhs(b, P_BLOCK)
    out = []
    for label in ("sharded-block-capture", "sharded-block"):
        ops.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rs = gmres_batched(A, B, storage="frsz2_32", m=M,
                           max_iters=FULL_MAX_ITERS, target_rrn=target,
                           method="block", shard=dist.get_world_size(),
                           shard_transport="plain", shard_matvec="halo")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        X = torch.stack([r.x for r in rs])
        row = dict(phase=label, n=A.shape[0], p=P_BLOCK, format="frsz2_32",
                   transport="plain", iters=[r.iterations for r in rs],
                   restarts=[r.restarts for r in rs],
                   converged=all(r.converged for r in rs), wall_s=wall,
                   launches=dict(ops.LAUNCHES))
        emit(row)
        out.append((X, row))
    (X1, r1), (X2, r2) = out
    check(r2["converged"] and torch.equal(X1, X2),
          "sharded block solve: not converged or the replay differs")
    check(r2["iters"] == ru["iters"], f"sharded block iterations "
                                      f"{r2['iters']} != unsharded "
                                      f"{ru['iters']}")
    x_rel = float(torch.linalg.vector_norm(X2 - Xu)
                  / torch.linalg.vector_norm(Xu))
    check(x_rel <= 1e-12, f"sharded block X relative {x_rel:.3e}")
    _check_launches(r2, BLOCK_PATH, "sharded block solve")
    print(f"[sharded] block p={P_BLOCK} frsz2_32 plain: iterations "
          f"{r2['iters']} (unsharded {ru['iters']}), X relative "
          f"{x_rel:.3e}; walls capture {r1['wall_s']:.4f} s, replay "
          f"{r2['wall_s']:.4f} s (unsharded replay {ru['wall_s']:.4f} s)")
    release()
    # slice 10: MGS at a mixed fired pattern, unsharded and on this rank
    from repro_torch.solver import gmres

    mixed = gmres(A, b, storage="frsz2_32", m=M, max_iters=FULL_MAX_ITERS,
                  target_rrn=target, eta=MIXED_ETA)
    mixed_ref = dict(iters=mixed.iterations,
                     fired=mixed.fired.sum(1).tolist())
    row = _mgs_mixed(A, b, target, dist.get_world_size())
    row["unsharded_iters"], row["unsharded_fired"] = (mixed_ref["iters"],
                                                      mixed_ref["fired"])
    emit(row)
    _check_mgs_mixed(row, mixed_ref["iters"], 0)
    entries["peer_gather"]["mixed_eta_launches"] = row["launches"][
        "peer_gather"]
    release()
    routes = _second_pass_routes(A, b, target, dist.get_world_size())
    emit(routes)
    _check_routes(routes)
    _sharded_mgs_census()
    return entries, launches, mixed_ref


def _sharded_mgs_census():
    """Slice 9: the census of a warmed MGS sharded solve on this NCCL rank
    (the gate's rows-mode solve: atmosmod n 256, m 8, 2 full cycles), at
    eta :data:`MIXED_ETA` (slice 10): the replays put the second pass's
    reductions, over the peer gather, on the wire only at the fired steps,
    and the recorded bytes equal ``cycle_wire_bytes`` with them; the IF
    bodies hold no NCCL call."""
    from repro_torch.analysis import traffic

    info = {}
    t0 = time.perf_counter()
    findings = traffic.census_world(0, "cuda", info=info, ortho="mgs",
                                    eta=MIXED_ETA)
    row = info["census[rows, mgs]"]
    emit(dict(phase="sharded-mgs-census", wall_s=time.perf_counter() - t0,
              findings=[f.render() for f in findings], fired=row["fired"],
              priced=row["priced"], model=row["model"], calls=row["calls"]))
    check(not findings, "the MGS census: "
          + "; ".join(f.render() for f in findings))
    check(0 < sum(row["fired"]) < 16,
          f"the MGS census: fired {row['fired']}, not a mixed pattern")
    cyc = row["priced"]["cycle"]
    print(f"[sharded] MGS census on one NCCL rank (n 256, m 8, 2 cycles, "
          f"eta {MIXED_ETA}, fired steps {row['fired']}): cycle dots "
          f"{cyc['dots']} B, norms {cyc['norms']} B, equal to "
          f"cycle_wire_bytes; {row['calls']} calls a solve, "
          f"{row['names'].get('peer_gather', 0)} of them peer gathers")


def _plan_sharded_solve(A, target, rcm_iters):
    """``reorder="auto"`` on the unstructured operator through the sharded
    solve on this rank: the plan's executed mode, one frsz2_32 solve with
    the RCM solve's iterations, run twice (the second replays)."""
    import torch
    import torch.distributed as dist

    from repro_torch.solver.sharded import _plan_and_precond
    from repro_torch.sparse import rhs_for

    P = dist.get_world_size()
    plan, _ = _plan_and_precond(A, P, "auto", "auto", None)
    print(f"[plan] sharded over {P}: {plan.describe()}")
    b, x_sol = rhs_for(A, device="cuda")
    first, r1 = _sharded_row("plan-sharded-capture", A, b, x_sol, "frsz2_32",
                             target, PLAN_MAX_ITERS, "plain", matvec="auto")
    res, row = _sharded_row("plan-sharded", A, b, x_sol, "frsz2_32", target,
                            PLAN_MAX_ITERS, "plain", matvec="auto")
    check(res.converged, "sharded unstructured solve did not converge")
    check(torch.equal(res.x, first.x), "sharded unstructured: the replayed "
                                       "solve differs")
    check(res.iterations == rcm_iters, f"sharded unstructured {plan.reorder}"
          f"/{plan.matvec_mode} solve: {res.iterations} it != RCM solve "
          f"{rcm_iters}")
    print(f"[plan] sharded frsz2_32 (executed reorder {plan.reorder}, matvec "
          f"{plan.matvec_mode}): {res.iterations} it = RCM solve; wall "
          f"first (plan, partition, capture) {r1['wall_s']:.4f} s, replay "
          f"{row['wall_s']:.4f} s ({row['wall_per_iter_ms']:.4f} ms/it)")


#: seconds the multi-card world may take: five times its 58.6 s on four
#: H100s (35.7 s of it before the ranks' first step)
MULTI_DEADLINE_S = 300.0


def _sharded_rank(rank, dev, target, ref, block_ref):
    """One rank of the multi-card run at P = ``device_count()``: phase
    7c's full-width atmosmodd solves (halo, every transport, frsz2_32 and
    float64; the frsz2_32 coded solve also on the plan's own matvec; the
    p = 8 block solve), each captured and then replayed; then slice 10's
    MGS solve at eta :data:`MIXED_ETA` (:func:`_mgs_mixed`), the gate's
    MGS census and the reads audit of the fixed trajectory at that eta
    over every rank, and the peer gather's times at P.  Rank 0 returns the
    rows, with the modelled wire bytes a cycle, and every rank's
    timeline: seconds from its start to the end of each step."""
    import torch
    import torch.distributed as dist

    from repro_torch.analysis import traffic
    from repro_torch.dist.collectives import gather_objects
    from repro_torch.launch.solve import _batch_rhs
    from repro_torch.solver import clear_graph_cache, gmres, gmres_batched
    from repro_torch.solver.sharded import _plan_and_precond, wire_bytes
    from repro_torch.sparse import make_problem, rhs_for

    t_start = time.time()
    marks = []

    def mark(what):
        torch.cuda.synchronize()
        marks.append((what, time.time() - t_start))
        if rank == 0:                  # as it goes: a world cut short shows
            print(f"[sharded] rank 0: {what} at {marks[-1][1]:.1f} s",
                  flush=True)

    def twice(label, fn):
        """Capture, then replay: the replay's result and wall, the
        capture's wall, and whether the two agree bit for bit."""
        outs = []
        for step in ("capture", "replay"):
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            outs.append((out, time.perf_counter() - t0))
            mark(f"{label} {step}")
        (first, capture_s), (res, wall) = outs
        pairs = zip(*(r if isinstance(r, list) else [r]
                      for r in (first, res)))
        same = all(torch.equal(u.x, v.x) and u.iterations == v.iterations
                   for u, v in pairs)
        return res, wall, capture_s, same

    A, _ = make_problem("synth:atmosmod", N_MAIN, device=dev)
    b, _ = rhs_for(A, device=dev)
    P = dist.get_world_size()
    mark("problem")
    rows = []
    try:
        # first: the profiler names the kernels of an IF node's body
        # reliably only before this process has freed a captured graph
        rows.append(_second_pass_routes(A, b, target, P))
        mark("second-pass routes")
        for fmt in ("frsz2_32", "float64"):
            cases = [("halo", t) for t in TRANSPORTS]
            if fmt == "frsz2_32":
                cases.append(("auto", "compressed"))
            x_ref = torch.from_numpy(ref[fmt]["x"]).to(dev)
            for matvec, transport in cases:
                label = f"{fmt} {transport} {matvec}"
                plan, _ = _plan_and_precond(A, P, "auto", matvec, None)
                mark(f"{label} plan")
                res, wall, capture_s, same = twice(
                    label, lambda fmt=fmt, mv=matvec, t=transport: gmres(
                        A, b, storage=fmt, m=M, max_iters=FULL_MAX_ITERS,
                        target_rrn=target, shard=P, shard_transport=t,
                        shard_matvec=mv))
                rows.append(dict(
                    phase="sharded-multi", shard=P, format=fmt,
                    transport=transport, matvec=plan.matvec_mode,
                    iters=res.iterations, restarts=res.restarts,
                    rrn=res.rrn, converged=bool(res.converged),
                    replay_equal=same, capture_s=capture_s, wall_s=wall,
                    wall_per_iter_ms=wall * 1e3 / max(res.iterations, 1),
                    unsharded_iters=ref[fmt]["iters"],
                    unsharded_wall_per_iter_ms=ref[fmt]["wall_per_iter_ms"],
                    x_rel_to_unsharded=float(
                        torch.linalg.vector_norm(res.x - x_ref)
                        / torch.linalg.vector_norm(x_ref)),
                    modelled_wire_bytes_per_cycle=wire_bytes(
                        res, plan, storage=fmt, m=M, transport=transport),
                    plan=plan.describe()))
            del x_ref
            clear_graph_cache()
        B = _batch_rhs(b, P_BLOCK)
        rb, wall, capture_s, same = twice("block", lambda: gmres_batched(
            A, B, storage="frsz2_32", m=M, max_iters=FULL_MAX_ITERS,
            target_rrn=target, method="block", shard=P,
            shard_transport="plain", shard_matvec="halo"))
        rows.append(dict(phase="sharded-multi-block", shard=P,
                         format="frsz2_32", transport="plain", p=P_BLOCK,
                         iters=[r.iterations for r in rb],
                         unsharded_iters=block_ref,
                         converged=all(r.converged for r in rb),
                         replay_equal=same, capture_s=capture_s,
                         wall_s=wall))
        del rb
        clear_graph_cache()
        row = _mgs_mixed(A, b, target, P)
        row.update(unsharded_iters=ref["mgs_mixed"]["iters"],
                   unsharded_fired=ref["mgs_mixed"]["fired"])
        mark("mgs mixed")
        clear_graph_cache()
        info = {}
        row["census"] = [f.render() for f in traffic.census_world(
            rank, dev, info=info, ortho="mgs", eta=MIXED_ETA)]
        row["census_info"] = info["census[rows, mgs]"]
        row["reads"] = [f.render() for f in traffic.audit_reads(
            A, b, storage="frsz2_32", m=M, k=2, info=info, ortho="mgs",
            eta=MIXED_ETA, shard=P)]
        row["reads_info"] = info[f"reads[frsz2_32, mgs, shard={P}]"]
        mark("mgs census and reads")
        clear_graph_cache()
        row["peer_gather"] = _peer_gather_times(P)
        mark("peer gather times")
        rows.append(row)
    finally:
        clear_graph_cache()
        mark("end")
    timelines = gather_objects(dict(rank=rank, start=t_start, marks=marks))
    return dict(rows=rows, timelines=timelines) if rank == 0 else None


def phase_sharded_multi(target, unsharded, block_unsharded, mixed_ref):
    """With more than one card: :func:`_sharded_rank` on one spawned NCCL
    rank a card, held against phase 5's, phase 7's and phase 7c's
    unsharded solves (``unsharded``, ``block_unsharded``, ``mixed_ref``:
    MGS at eta :data:`MIXED_ETA`); prints the rows and where the world's
    time went."""
    import torch

    from repro_torch.dist import spawn

    P = torch.cuda.device_count()
    if P < 2:
        print(f"[sharded] {P} card: the multi-card run is skipped by count")
        return
    ref = {fmt: dict(iters=rd["iters"], wall_per_iter_ms=rd[
        "wall_per_iter_ms"], x=d.x.cpu().numpy())
        for fmt, (d, rd) in unsharded.items()}
    ref["mgs_mixed"] = mixed_ref
    t0 = time.time()
    out = spawn(_sharded_rank, P, target, ref, block_unsharded[1]["iters"],
                device="cuda", timeout_s=MULTI_DEADLINE_S)
    total = time.time() - t0
    rows, timelines = out["rows"], out["timelines"]
    plain = {r["format"]: r["iters"] for r in rows
             if r["phase"] == "sharded-multi" and r["transport"] == "plain"
             and r["matvec"] == "halo"}
    for row in rows:
        emit(row)
        if row["phase"] == "sharded-routes":
            _check_routes(row)
            continue
        if row["phase"] == "sharded-mgs-mixed":
            # NCCL sums the first pass in another order: within an
            # iteration, as the plain solves above
            _check_mgs_mixed(row, row["unsharded_iters"], 1)
            check(not row["census"] and not row["reads"],
                  f"MGS over {P}: census {row['census']}, reads "
                  f"{row['reads']}")
            ci = row["census_info"]
            print(f"[sharded] MGS census over {P} ranks (n 256, m 8, eta "
                  f"{MIXED_ETA}): fired {ci['fired']}, priced "
                  f"{ci['priced']['cycle']} = the model; reads audit over "
                  f"{P} ranks (m {M}, 2 cycles): fired "
                  f"{row['reads_info'].get('fired_steps')}, bytes_read "
                  f"{row['reads_info']['bytes_read']} = the model")
            continue
        what = (f"sharded over {P}: {row['format']} {row['transport']} "
                f"{row.get('matvec', 'block')}")
        check(row["converged"], f"{what} did not converge")
        check(row["replay_equal"], f"{what}: the replay differs from its "
                                   "capture")
        if row["phase"] == "sharded-multi-block":
            check(all(abs(i - j) <= 1 for i, j in
                      zip(row["iters"], row["unsharded_iters"])),
                  f"{what}: iterations {row['iters']} vs unsharded "
                  f"{row['unsharded_iters']}")
        elif row["transport"] == "plain":
            check(abs(row["iters"] - row["unsharded_iters"]) <= 1,
                  f"{what}: {row['iters']} it vs unsharded "
                  f"{row['unsharded_iters']}")
            check(row["x_rel_to_unsharded"] <= 1e-9,
                  f"{what}: x relative {row['x_rel_to_unsharded']:.3e}")
        elif row["format"] != "float64":
            # float64's coded halo strips (l = 32) are lossier than its
            # basis and cost it iterations, as in the reference
            check(abs(row["iters"] - plain[row["format"]]) <= 2,
                  f"{what}: {row['iters']} it vs plain "
                  f"{plain[row['format']]}")
    print(f"[sharded] over {P} cards: " + "; ".join(
        f"{r['format']} {r['transport']} {r.get('matvec', 'block')}: "
        f"{r['iters']} it" for r in rows
        if r["phase"] in ("sharded-multi", "sharded-multi-block")))
    starts = [tl["start"] - t0 for tl in timelines]
    ends = [tl["start"] + tl["marks"][-1][1] - t0 for tl in timelines]
    print(f"[sharded] multi-card world {total:.1f} s: ranks started "
          f"{min(starts):.1f}-{max(starts):.1f} s after the spawn, worked "
          f"until {min(ends):.1f}-{max(ends):.1f} s, teardown and join "
          f"{total - max(ends):.1f} s")
    for tl in timelines:
        steps, last = [], 0.0
        for what, t in tl["marks"]:
            steps.append(f"{what} {t - last:.2f}")
            last = t
        print(f"[sharded] rank {tl['rank']} timeline (s): "
              + "; ".join(steps))


def _attn_inputs(gen, B, Hkv, G, S, D, l, exp_dtype, qdt=None):
    """Seeded q and K/V coded on the card by the compress kernel."""
    import torch

    from repro_torch.core import frsz2 as F
    from repro_torch.kernels import ops

    dev = torch.device("cuda")
    spec = F.FrszSpec(bs=D, l=l, dtype=torch.float32, rounding="nearest",
                      exp_dtype=exp_dtype)
    bcs = []
    for _ in range(2):
        x = torch.randn((B, Hkv, S, D), generator=gen, device=dev)
        bc = ops.compress(x, spec)
        bcs.append(F.BlockCompressed(codes=bc.codes, exps=bc.exps, n=D,
                                     spec=spec))
        del x
    q = torch.randn((B, Hkv * G, D), generator=gen, device=dev)
    return q if qdt is None else q.to(qdt), bcs[0], bcs[1]


def phase_decode_attn():
    """Slice 4's kernel at the decode_32k length with yi-9b's heads."""
    import torch

    from repro_torch.core import frsz2 as F
    from repro_torch.kernels import cardcheck, ops
    from repro_torch.kernels.cardcheck import ATTN_TOL, ATTN_TOL_BF16
    from repro_torch.kernels.cardcheck import attn_pair as _attn_pair

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(4242)
    B, Hkv, G, D, S = ATTN_B, ATTN_HKV, ATTN_G, ATTN_D, ATTN_S
    lengths = torch.randint(1, S + 1, (B,), generator=gen, device=dev,
                            dtype=torch.int32)
    lengths[-1] = S
    valid = int(lengths.sum())
    print(f"[attn] B={B} Hkv={Hkv} G={G} D={D} S={S}; lengths "
          f"{lengths.tolist()}")
    entries = {}
    src = "src/repro_torch/kernels/csrc/decode_attn.cu"
    for l in (16, 8):
        q, kbc, vbc = _attn_inputs(gen, B, Hkv, G, S, D, l, torch.uint8)
        ok, err, rel = _attn_pair(q, kbc, vbc, lengths)
        print(f"[attn] l={l}: kernel vs plain max abs error {err:.3e}, "
              f"{rel:.3e} of the largest output (tolerance {ATTN_TOL})")
        check(rel <= ATTN_TOL, f"decode_attn l={l}: max abs error {err:.3e}"
                               f" is {rel:.3e} of the largest output")
        # the PyTorch call computing the same function: SDPA over the
        # decoded K/V, the G query heads of a kv head as its G queries
        kd = ops.decompress(kbc, kernel=True).view(B, Hkv, S, D)
        vd = ops.decompress(vbc, kernel=True).view(B, Hkv, S, D)
        q4 = q.view(B, Hkv, G, D)
        mask = (torch.arange(S, device=dev)[None, :] < lengths[:, None]
                )[:, None, None, :]
        sdpa = functools.partial(
            torch.nn.functional.scaled_dot_product_attention, q4, kd, vd,
            attn_mask=mask)
        lib_err = float((sdpa().reshape(B, Hkv * G, D) - ok).abs().max())
        check(lib_err <= ATTN_TOL * float(ok.abs().max()),
              f"SDPA on the decoded cache differs by {lib_err:.3e}")
        code_bytes = F.code_dtype(l).itemsize
        nbytes = (2 * valid * Hkv * (D * code_bytes + 1)
                  + 2 * B * Hkv * G * D * 4)
        flops = 4.0 * valid * Hkv * G * D
        e = entry("decode_attn", src, "src/repro/kernels/decode_attn.py:85",
                  timed(lambda: ops.decode_attention(q, kbc, vbc, lengths,
                                                     kernel=True)),
                  timed(lambda: ops.decode_attention(q, kbc, vbc, lengths,
                                                     kernel=False), reps=3),
                  nbytes, flops, err, library_ms=timed(sdpa),
                  peak=FP32_FLOPS, l=l, rel_err=rel,
                  shape=f"B={B} Hkv={Hkv} G={G} D={D} S={S}, "
                        f"{valid} valid positions",
                  library="scaled_dot_product_attention on the decoded "
                          "f32 K/V with a length mask",
                  library_err=lib_err, path="serve")
        if l == 16:
            entries["decode_attn"] = e
        del q, kbc, vbc, kd, vd, ok, sdpa
        torch.cuda.empty_cache()

    # the serve shape (phase 9's cache: 2120 positions, lengths 2048-2112)
    S2 = SERVE_PROMPT + 2 * SERVE_NEW + 8
    lens2 = torch.randint(SERVE_PROMPT, SERVE_PROMPT + 2 * SERVE_NEW + 1, (B,),
                          generator=gen, device=dev, dtype=torch.int32)
    q, kbc, vbc = _attn_inputs(gen, B, Hkv, G, S2, D, 16, torch.uint8)
    _, err2, rel2 = _attn_pair(q, kbc, vbc, lens2)
    check(rel2 <= ATTN_TOL, f"decode_attn at the serve shape: {rel2:.3e} of "
                            "the largest output")
    kd = ops.decompress(kbc, kernel=True).view(B, Hkv, S2, D)
    vd = ops.decompress(vbc, kernel=True).view(B, Hkv, S2, D)
    mask2 = (torch.arange(S2, device=dev)[None, :] < lens2[:, None]
             )[:, None, None, :]
    valid2 = int(lens2.sum())
    serve = dict(
        serve_shape=f"B={B} Hkv={Hkv} G={G} D={D} S={S2}, lengths "
                    f"{int(lens2.min())}-{int(lens2.max())}, {valid2} valid "
                    "positions, l=16",
        serve_ms=timed(lambda: ops.decode_attention(q, kbc, vbc, lens2,
                                                    kernel=True)),
        serve_bound_ms=bound_ms(2 * valid2 * Hkv * (D * 2 + 1)
                                + 2 * B * Hkv * G * D * 4,
                                4.0 * valid2 * Hkv * G * D, FP32_FLOPS)[0],
        serve_library_ms=timed(functools.partial(
            torch.nn.functional.scaled_dot_product_attention,
            q.view(B, Hkv, G, D), kd, vd, attn_mask=mask2)),
        serve_rel_err=rel2)
    entries["decode_attn"].update(serve)
    print(f"[attn] serve shape {serve['serve_shape']}: kernel "
          f"{serve['serve_ms'] * 1e3:.1f} us, bound "
          f"{serve['serve_bound_ms'] * 1e3:.2f} us, SDPA on the decoded K/V "
          f"{serve['serve_library_ms'] * 1e3:.1f} us; kernel vs plain "
          f"{rel2:.3e} of the largest output")
    del q, kbc, vbc, kd, vd
    torch.cuda.empty_cache()

    # spot checks: head width, group sizes, ragged S, bf16 q, int32
    # exponents, a length-1 row
    g2 = torch.Generator(device=dev).manual_seed(77)
    spots = [(64, 16, 2, torch.uint8, torch.float32),
             (64, 8, 1, torch.int32, torch.float32),
             (128, 16, 4, torch.uint8, torch.bfloat16),
             (128, 8, 3, torch.uint8, torch.float32),
             (128, 16, 12, torch.int32, torch.float32),
             (64, 16, 8, torch.uint8, torch.bfloat16),
             # mixtral's and llama4's query groups (48/8, 40/8 heads)
             (128, 16, 6, torch.uint8, torch.float32),
             (128, 16, 6, torch.uint8, torch.bfloat16),
             (128, 8, 5, torch.uint8, torch.float32),
             (128, 16, 5, torch.uint8, torch.bfloat16),
             # zamba2-7b's head_dim (bs = D = 112, no power of two)
             (112, 16, 1, torch.uint8, torch.float32),
             (112, 8, 4, torch.uint8, torch.bfloat16),
             (112, 16, 4, torch.int32, torch.float32)]
    lens = torch.tensor([1, 517, 1000], dtype=torch.int32, device=dev)
    for D_, l, G_, edt, qdt in spots:
        q, kbc, vbc = _attn_inputs(g2, 3, 2, G_, 1000, D_, l, edt, qdt)
        _, err, rel = _attn_pair(q, kbc, vbc, lens)
        ok = rel <= ATTN_TOL if qdt == torch.float32 else err <= ATTN_TOL_BF16
        check(ok, f"decode_attn spot D={D_} l={l} G={G_} {edt} {qdt}: max "
                  f"abs error {err:.3e}, {rel:.3e} of the largest output")
    print(f"[attn] spot checks passed: {len(spots)} (D 64/112/128, G 1/2/3/4/"
          "5/6/8/12, S=1000, bf16 q, int32 exponents, a length-1 row)")

    # the kernel's tile and split edges; K/V blocks across the decode guard
    edge = cardcheck.ATTN_EDGE_LENGTHS
    lens_e = torch.tensor(edge, dtype=torch.int32, device=dev)
    S_e = max(edge) + 2
    for D_, l, G_, edt, qdt in ((128, 16, 8, torch.uint8, torch.float32),
                                (64, 8, 3, torch.int32, torch.bfloat16),
                                (128, 8, 12, torch.uint8, torch.float32),
                                (112, 16, 1, torch.uint8, torch.float32)):
        q, kbc, vbc = _attn_inputs(g2, len(edge), 2, G_, S_e, D_, l, edt, qdt)
        out, err, rel = _attn_pair(q, kbc, vbc, lens_e)
        ok = rel <= ATTN_TOL if qdt == torch.float32 else err <= ATTN_TOL_BF16
        check(ok and not out[0].any(),
              f"decode_attn edge lengths {edge} D={D_} l={l} G={G_} {qdt}: "
              f"max abs error {err:.3e}, {rel:.3e} of the largest output")
    rows = 0
    for l in (16, 8):
        for edt in (torch.uint8, torch.int32):
            v_ok, rel, n = cardcheck.attn_across_guard(l, edt, g2)
            check(v_ok, f"decode_attn l={l} {edt}: V rows across the decode "
                        "guard differ from decompress")
            check(rel <= ATTN_TOL, f"decode_attn l={l} {edt}: K across the "
                                   f"decode guard, {rel:.3e} of the largest "
                                   "output")
            rows += n
    print(f"[attn] tile edges: lengths {list(edge)} in S={S_e} (D 64/112/128,"
          f" l 8/16, G 1/3/8/12, bf16 q) within tolerance, the empty row 0; "
          f"across the decode guard: {rows} sequences, V equal to "
          "decompress, K within tolerance")
    return entries


def _cache_write_times(writes, fmt):
    """The serving cache write of one layer at its two shapes (``writes``:
    the K and V of a decode step, ``(B, 1, Hkv, D)``, and of the prefill,
    ``(B, prompt, Hkv, D)``, as the model hands them to the cache): timed
    as the model calls it, ``kvcache.append`` into a layer of the served
    cache's length at lengths ``prompt`` and ``kvcache.build_cache`` of the
    prefill, by CUDA events (device time) and by the host clock over
    back-to-back calls (what a host-bound step pays), and the fused kernel
    alone and its plain version, whose caches must be equal."""
    import torch

    from repro_torch.kernels import frsz2_kernel as K
    from repro_torch.kernels import ops
    from repro_torch.models import kvcache

    k1, v1 = writes["step"]
    kp, vp = writes["prefill"]
    B, prompt, Hkv, D = kp.shape
    S = SERVE_PROMPT + 72
    spec = fmt.spec(D)
    lengths = torch.full((B,), prompt, dtype=torch.int32, device=k1.device)

    def layer():
        return {n: t[0] for n, t in kvcache.init_cache(
            fmt, 1, B, Hkv, S, D, device=k1.device).items()}

    # the floor of the CUDA-event timing: one launch that does nothing
    # worth timing (a one-element fill)
    tiny = torch.zeros(1, device=k1.device)
    out = {"floor_ms": timed(lambda: tiny.zero_())}
    for name, (k, v) in (("step", (k1, v1)), ("prefill", (kp, vp))):
        lc = layer()
        if name == "step":
            def write(lc=lc, k=k, v=v):
                kvcache.append(lc, k, v, lengths, fmt)
        else:
            def write(lc=lc, k=k, v=v):
                kvcache.build_cache(k, v, fmt, cache_len=S, out=lc)
        rows = 2 * k.numel() // D
        cd = torch.empty((), dtype=fmt.code_dtype()).element_size()
        # K and V in their dtype read once, codes and a uint8 exponent a
        # row written once, the lengths read
        nbytes = rows * D * (k.element_size() + cd) + rows + 4 * B
        for _ in range(3):             # first calls load and query
            write()
        torch.cuda.synchronize()
        reps = 200 if name == "step" else 20
        t0 = time.perf_counter()
        for _ in range(reps):
            write()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) / reps * 1e3
        out.update({f"{name}_rows": rows, f"{name}_shape": list(k.shape),
                    f"{name}_ms": timed(write), f"{name}_host_ms": host_ms,
                    f"{name}_bytes": nbytes,
                    f"{name}_bound_ms": bound_ms(nbytes)[0]})
        kl = layer()
        pl = layer()
        # as append and build_cache call it: the prefill from position 0,
        # its padding cleared
        lens, clear = (None, prompt) if name == "prefill" else (lengths, S)
        args = (k, v, lens, kl["k_codes"], kl["k_exps"], kl["v_codes"],
                kl["v_exps"], 0, clear, spec)
        K.cache_write(*args)
        ops.cache_write(k, v, lens, pl["k_codes"], pl["k_exps"],
                        pl["v_codes"], pl["v_exps"], spec, clear_from=clear,
                        kernel=False)
        for n in kl:
            check(torch.equal(kl[n], pl[n]) and torch.equal(kl[n], lc[n]),
                  f"cache write at the serve {name} shape: {n} != plain")
        out[f"{name}_kernel_ms"] = timed(lambda a=args: K.cache_write(*a))
        out[f"{name}_plain_ms"] = timed(lambda: ops.cache_write(
            k, v, lens, pl["k_codes"], pl["k_exps"], pl["v_codes"],
            pl["v_exps"], spec, clear_from=clear, kernel=False), reps=3)
        print(f"[serve] cache write, one layer's {name} ({tuple(k.shape)} "
              f"{str(k.dtype)[6:]} K and V, l {spec.l}): "
              f"{'append' if name == 'step' else 'build_cache'} "
              f"{out[f'{name}_ms'] * 1e3:.2f} us by events, "
              f"{out[f'{name}_host_ms'] * 1e3:.2f} us of host a call, the "
              f"kernel alone {out[f'{name}_kernel_ms'] * 1e3:.2f} us, plain "
              f"{out[f'{name}_plain_ms'] * 1e3:.1f} us, bound {out[f'{name}_bound_ms'] * 1e3:.4f} us (the "
              f"events' floor {out['floor_ms'] * 1e3:.2f} us)")
    return out


def _serve_config(kv_format):
    import dataclasses

    from repro_torch.configs import get_arch

    return dataclasses.replace(get_arch(SERVE_ARCH), kv_format=kv_format)


def _teacher_forcing(params, kv_format):
    """Relative errors of prefill's and one decode step's logits against
    the parallel forward over S+1 tokens."""
    import torch

    from repro_torch.models import decode_step, prefill, trunk
    from repro_torch.models.layers import rms_norm

    cfg = _serve_config(kv_format)
    gen = torch.Generator(device="cuda").manual_seed(5)
    tokens = torch.randint(0, cfg.vocab_size, (TF_B, TF_S + 1), generator=gen,
                           device="cuda")
    h, _ = trunk(params, cfg, tokens)

    def head(x):
        return (rms_norm(x, params["final_ln"]) @ params["unembed"]).float()

    want, want2 = head(h[:, TF_S - 1]), head(h[:, TF_S])
    del h
    got, cache = prefill(params, cfg, tokens[:, :TF_S], cache_len=TF_S + 4)
    got2, _ = decode_step(params, cfg, cache, tokens[:, TF_S])

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max())

    return rel(got, want), rel(got2, want2)


class _ServeTap:
    """For one serve run, keeps the inputs of the last decode attention and
    the K/V of the last cache write of each kind (prefill, decode step):
    the last layer's.  ``ops.cache_write`` and ``ops.decode_attention`` are
    wrapped for the run and run unchanged."""

    def __init__(self):
        from repro_torch.kernels import ops

        self.prefill = self.decode = self.attn = None
        self._slots = ((ops, "cache_write"), (ops, "decode_attention"))
        self._orig = [getattr(m, n) for m, n in self._slots]

    def __enter__(self):
        write, attend = self._orig

        def cache_write(k, v, lengths, *args, **kw):
            # the prefill writes from position 0 (lengths None), a decode
            # step one position a row
            if lengths is None:
                self.prefill = (k, v)
            elif k.shape[1] == 1:
                self.decode = (k, v)
            return write(k, v, lengths, *args, **kw)

        def decode_attention(q, k_bc, v_bc, lengths, **kw):
            self.attn = (q, k_bc, v_bc, lengths, kw)
            return attend(q, k_bc, v_bc, lengths, **kw)

        for (m, n), f in zip(self._slots, (cache_write, decode_attention)):
            setattr(m, n, f)
        return self

    def __exit__(self, *exc):
        for (m, n), f in zip(self._slots, self._orig):
            setattr(m, n, f)


def _check_served_cache(tap, fmt_name):
    """The last layer's coded K/V and its last decode attention, as served,
    against the plain versions; returns the errors."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels.cardcheck import ATTN_TOL, ATTN_TOL_BF16
    from repro_torch.kernels.cardcheck import attn_pair as _attn_pair

    check(None not in (tap.attn, tap.prefill, tap.decode),
          f"{fmt_name}: the serve run wrote or read no FRSZ2 cache")
    q, kbc, vbc, lengths, kw = tap.attn
    B, Hkv, S = kbc.exps.shape[:3]
    pos = lengths.reshape(B).long() - 1          # the last decode write
    bi = torch.arange(B, device=pos.device)
    rows = 0
    for bc, xp, xd in zip((kbc, vbc), tap.prefill, tap.decode):
        # prefill: positions [0, prompt); decode: position lengths - 1
        for x, codes, exps in (
                (xp.transpose(1, 2), bc.codes[:, :, :SERVE_PROMPT],
                 bc.exps[:, :, :SERVE_PROMPT]),
                (xd[:, 0], bc.codes[bi, :, pos], bc.exps[bi, :, pos])):
            want = ops.compress(x.float(), bc.spec, kernel=False)
            check(torch.equal(codes.reshape(want.codes.shape), want.codes)
                  and torch.equal(exps.reshape(want.exps.shape),
                                  want.exps.to(exps.dtype)),
                  f"{fmt_name}: served cache codes differ from the plain "
                  f"compress of the same K/V ({tuple(x.shape)})")
            rows += x.numel() // x.shape[-1]
    _, err16, rel16 = _attn_pair(q, kbc, vbc, lengths, **kw)
    check(rel16 <= ATTN_TOL_BF16,
          f"{fmt_name}: decode_attn on the served cache, {q.dtype} q: max abs "
          f"error {err16:.3e}, {rel16:.3e} of the largest output")
    _, err32, rel32 = _attn_pair(q.float(), kbc, vbc, lengths, **kw)
    check(rel32 <= ATTN_TOL,
          f"{fmt_name}: decode_attn on the served cache, f32 q: max abs "
          f"error {err32:.3e}, {rel32:.3e} of the largest output")
    lens = lengths.reshape(B).tolist()
    print(f"[serve] {fmt_name} served cache: {rows} coded rows of the last "
          f"layer bit-equal to the plain compress; decode_attn vs plain at "
          f"B={B} Hkv={Hkv} G={q.shape[1] // Hkv} S={S} lengths "
          f"{min(lens)}..{max(lens)}: {q.dtype} q {err16:.3e} ({rel16:.3e} "
          f"of the largest output), f32 q {err32:.3e} ({rel32:.3e})")
    return dict(served_attn_err=err16, served_attn_rel_err=rel16,
                served_attn_err_f32q=err32, served_attn_rel_err_f32q=rel32,
                served_rows_bit_equal=rows)


def phase_serve(device_line):
    """Slice 4's path: yi-9b served at full width and depth."""
    import numpy as np
    import torch

    from repro_torch.kernels import ops
    from repro_torch.launch.serve import ServeConfig, decode_steps, serve
    from repro_torch.models import init_params, kvcache

    cfg = _serve_config("frsz2_16")
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    w_bytes = sum(t.numel() * t.element_size() for t in
                  _leaves(params))
    print(f"[serve] {SERVE_ARCH}: {cfg.num_layers} layers, d={cfg.d_model}, "
          f"{cfg.num_heads}/{cfg.num_kv_heads} heads, hd={cfg.hd}, "
          f"{cfg.dtype}; {w_bytes / 1e9:.3f} GB of weights drawn in "
          f"{time.perf_counter() - t0:.1f} s")
    for fmt in ("bf16", "frsz2_16"):
        e1, e2 = _teacher_forcing(params, fmt)
        print(f"[serve] teacher forcing {fmt}: prefill {e1:.3e}, decode "
              f"{e2:.3e} (relative to the largest logit, tolerance {TF_TOL})")
        check(e1 <= TF_TOL and e2 <= TF_TOL,
              f"teacher forcing {fmt}: {e1:.3e}, {e2:.3e} > {TF_TOL}")
    torch.cuda.empty_cache()

    rng = np.random.default_rng(0)
    reqs = [rng.integers(0, cfg.vocab_size, SERVE_PROMPT).astype(np.int32)
            for _ in range(SERVE_REQUESTS)]
    sc = ServeConfig(slots=SERVE_SLOTS, prompt_len=SERVE_PROMPT,
                     max_new=SERVE_NEW)
    steps = decode_steps(len(reqs), sc)
    sc.max_ctx = SERVE_PROMPT + steps + 8
    # the byte bound of a decode step: every weight but the embedding
    # table, and the cache positions it reads (mean over the run's steps)
    step_w = w_bytes - params["embed"].numel() * params["embed"].element_size()
    mean_len = SERVE_PROMPT + (steps + 1) / 2
    rows, launches = [], {}
    for fmt_name in SERVE_FORMATS:
        cfg_f = _serve_config(fmt_name)
        fmt = kvcache.cache_format(fmt_name)
        torch.cuda.reset_peak_memory_stats()
        stats = {}
        with _ServeTap() as tap:
            ops.reset_launches()
            t = time.perf_counter()
            out = serve(cfg_f, sc, reqs, params=params, device="cuda",
                        verbose=False, stats=stats)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            got = dict(ops.LAUNCHES)
        check(sorted(out) == list(range(len(reqs))), "serve lost a request")
        check(all(len(v) == SERVE_NEW and all(0 <= x < cfg.vocab_size
                                              for x in v)
                  for v in out.values()),
              f"{fmt_name}: a completion is not {SERVE_NEW} tokens in range")
        check(stats["nonfinite_logits"] == 0,
              f"{fmt_name}: {stats['nonfinite_logits']} logits not finite")
        check(len(stats["step_s"]) == steps and len(stats["prefill_s"]) == 1,
              f"{fmt_name}: {len(stats['step_s'])} decode steps, "
              f"{len(stats['prefill_s'])} prefills")
        frsz = fmt.kind == "frsz2"
        want = {"decode_attn": cfg.num_layers * steps if frsz else 0,
                "frsz2_cache_write": cfg.num_layers * (1 + steps)
                if frsz else 0, "frsz2_compress": 0}
        for k, n in want.items():
            check(got[k] == n, f"{fmt_name}: {k} launched {got[k]} times, "
                               f"the path implies {n}")
        others = {k: v for k, v in got.items() if v and k not in want}
        check(not others, f"{fmt_name}: other kernels launched: {others}")
        served = _check_served_cache(tap, fmt_name) if frsz else {}
        if fmt_name == "frsz2_16":
            writes = {"step": tap.decode, "prefill": tap.prefill}
        del tap
        # the same counts split between the prefill and the decode steps
        # (``stats``): a layer's launches in each
        split = {"prefill": stats["prefill_launches"],
                 "step": stats["step_launches"]}
        per_layer = {"prefill": (1, {"decode_attn": 0, "frsz2_cache_write": 1,
                                     "frsz2_compress": 0}),
                     "step": (steps, {"decode_attn": 1, "frsz2_cache_write": 1,
                                      "frsz2_compress": 0})}
        for part, (n, per) in per_layer.items():
            for k, m in per.items():
                n_want = n * m * cfg.num_layers if frsz else 0
                check(split[part][k] == n_want,
                      f"{fmt_name}: {k} launched {split[part][k]} times in "
                      f"the {part}, the path implies {n_want}")
        per_pos = (cfg.hd * fmt.bits_per_value(cfg.hd) / 8) * 2
        cache_read = (cfg.num_layers * SERVE_SLOTS * cfg.num_kv_heads
                      * mean_len * per_pos)
        step_bound = (step_w + cache_read) / HBM_BYTES_PER_S * 1e3
        step_ms = statistics.median(stats["step_s"]) * 1e3
        row = dict(phase="serve", kv_format=fmt_name, arch=SERVE_ARCH,
                   requests=len(reqs), slots=SERVE_SLOTS,
                   prompt=SERVE_PROMPT, max_new=SERVE_NEW,
                   max_ctx=sc.max_ctx, decode_steps=steps,
                   prefill_s=stats["prefill_s"],
                   step_ms_median=step_ms,
                   step_ms_min=min(stats["step_s"]) * 1e3,
                   decode_tokens_per_s=SERVE_SLOTS * steps
                   / sum(stats["step_s"]),
                   step_bound_ms=step_bound,
                   step_weight_bytes=step_w, step_cache_bytes=cache_read,
                   wall_s=wall,
                   peak_mem_bytes=torch.cuda.max_memory_allocated(),
                   cache_nbytes=kvcache.cache_nbytes(
                       fmt, cfg.num_layers, SERVE_SLOTS, cfg.num_kv_heads,
                       sc.max_ctx, cfg.hd),
                   launches={k: v for k, v in got.items() if v},
                   prefill_launches={k: v for k, v in
                                     split["prefill"].items() if v},
                   step_launches={k: v for k, v in split["step"].items()
                                  if v},
                   sample=out[0][:8], device=device_line, **served)
        emit(row)
        rows.append(row)
        if fmt_name == "frsz2_16":
            launches = dict(got, **{f"{k}_{part}": v
                                    for part, c in split.items()
                                    for k, v in c.items()})
    for r in rows:
        print(f"[serve] {r['kv_format']}: prefill {r['prefill_s'][0]:.3f} s, "
              f"decode step median {r['step_ms_median']:.2f} ms (bound "
              f"{r['step_bound_ms']:.2f} ms), {r['decode_tokens_per_s']:.1f} "
              f"tokens/s, peak {r['peak_mem_bytes'] / 2**30:.2f} GiB, cache "
              f"{r['cache_nbytes'] / 1e9:.3f} GB")
    # the frsz2_16 decode steps' device time, for phase 14's roofline
    from repro_torch.launch.profile import profile_decode

    torch.cuda.reset_peak_memory_stats()
    prof = profile_decode(_serve_config("frsz2_16"), params, top=4,
                          profile_prefill=False)
    STEP_TIMES["decode"] = dict(
        device_ms=prof["device_per_step_ms"],
        wall_ms=prof["wall_per_step_ms"],
        peak=torch.cuda.max_memory_allocated(),
        served_peak=[r["peak_mem_bytes"] for r in rows
                     if r["kv_format"] == "frsz2_16"][0],
        slots=prof["slots"], prompt=prof["prompt"], steps=prof["steps"])
    print(f"[serve] frsz2_16 decode steps profiled: "
          f"{prof['device_per_step_ms']:.2f} ms of device time a step, "
          f"{prof['wall_per_step_ms']:.2f} ms of wall, busy "
          f"{prof['device_busy_share']:.3f}")
    return launches, _cache_write_times(writes, kvcache.cache_format(
        "frsz2_16"))


def _moe_config(arch, kv_format, **kw):
    import dataclasses

    from repro_torch.configs import get_arch

    return dataclasses.replace(get_arch(arch), num_layers=MOE_LAYERS,
                               kv_format=kv_format, **kw)


def _moe_teacher_forcing(params, arch, kv_format):
    """Relative errors of a prefill of ``MOE_TF_S`` tokens and of one decode
    step against the parallel forward over ``MOE_TF_FORWARD`` tokens, and
    the cache's slots.  The forward is causal and, at a capacity factor of
    E / k, drops no token (the forward groups its tokens otherwise than the
    prefill and the step), so its positions past S change nothing before
    them."""
    import dataclasses

    import torch

    from repro_torch.models import decode_step, prefill, trunk
    from repro_torch.models.layers import rms_norm

    base = _moe_config(arch, kv_format)
    cfg = dataclasses.replace(
        base, capacity_factor=base.num_experts / base.top_k)
    S = MOE_TF_S
    gen = torch.Generator(device="cuda").manual_seed(5)
    tokens = torch.randint(0, cfg.vocab_size, (TF_B, MOE_TF_FORWARD),
                           generator=gen, device="cuda")
    h, _ = trunk(params, cfg, tokens)

    def head(x):
        return (rms_norm(x, params["final_ln"]) @ params["unembed"]).float()

    want, want2 = head(h[:, S - 1]), head(h[:, S])
    del h
    torch.cuda.empty_cache()
    got, cache = prefill(params, cfg, tokens[:, :S], cache_len=S + 4)
    slots = next(iter(cache["self"].values())).shape[3]
    got2, _ = decode_step(params, cfg, cache, tokens[:, S])

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max())

    return rel(got, want), rel(got2, want2), slots


class _MoeServeTap:
    """For one serve run of an ``L``-layer model: the arguments of the last
    ``kvcache.attend`` (the last layer's, in the last decode step); the
    last layer's cache writes in order (``writes``: its prefill, then one
    a decode step, each ``(k, v, lengths, kw)``); and the routing of each
    decode step's MoE layers (``routes``: ``(gidx, keep)`` of every
    ``_top_k_dispatch`` over the ``slots`` tokens of a step).  Everything
    runs unchanged; the tap only keeps references."""

    def __init__(self, L, slots):
        from repro_torch.kernels import ops
        from repro_torch.models import kvcache, layers

        self.L, self.slots = L, slots
        self.last, self.writes, self.routes, self._n = None, [], [], 0
        self._slots = ((kvcache, "attend"), (ops, "cache_write"),
                       (layers, "_top_k_dispatch"))
        self._orig = [getattr(m, n) for m, n in self._slots]

    def __enter__(self):
        attend0, write0, dispatch0 = self._orig

        def attend(q, layer_cache, lengths, fmt, **kw):
            self.last = (q, layer_cache, lengths, fmt, kw)
            return attend0(q, layer_cache, lengths, fmt, **kw)

        def cache_write(k, v, lengths, *args, **kw):
            # a prefill writes every layer once, a decode step every layer
            # once: the last layer's is every L-th call
            self._n += 1
            if self._n % self.L == 0:
                self.writes.append((k, v, lengths, kw))
            return write0(k, v, lengths, *args, **kw)

        def dispatch(gates, *args, **kw):
            out = dispatch0(gates, *args, **kw)
            if gates.shape[0] * gates.shape[1] == self.slots:
                self.routes.append((out[0], out[2]))
            return out

        for (m, n), f in zip(self._slots, (attend, cache_write, dispatch)):
            setattr(m, n, f)
        return self

    def __exit__(self, *exc):
        for (m, n), f in zip(self._slots, self._orig):
            setattr(m, n, f)


def _served_cache_writes(tap, fmt, key="ring_write", tag="[moe]"):
    """The cache write (kernel 1) on a served cache.  The last layer's
    served cache (zamba2: the last application's), as the kernel left it
    after the prefill and every decode write (into a ring: slot = position
    mod ring), against the plain version (``ops.cache_write(...,
    kernel=False)``) replayed from the same K/V and lengths: every code and
    exponent equal.  Then, on fresh layers, the kernel through the model's
    calls against the plain version at the prefill as served, into a ring
    a prefill of ring + 1024 positions (the roll: the last ring positions
    at their modular slots, its first 1024 dropped), and the last decode
    write; each equal, and timed beside its byte bound, as ``{key}_*``."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.models import kvcache

    q, lc, lengths, _, kw = tap.last
    ring = kw.get("ring", 0)
    D = q.shape[-1]
    spec = fmt.spec(D)
    names = ("k_codes", "k_exps", "v_codes", "v_exps")
    B, Hkv, S, _ = lc["k_codes"].shape
    check(len(tap.writes) >= 2 and tap.writes[0][2] is None
          and all(w[2] is not None for w in tap.writes[1:]),
          f"the last layer's cache writes are not a prefill and decode "
          f"steps: {[None if w[2] is None else tuple(w[0].shape) for w in tap.writes]}")
    check(all(w[3].get("ring") == ring for w in tap.writes),
          "a cache write of the served cache passed another ring")

    def fresh():
        return {n: torch.zeros_like(lc[n]) for n in names}

    def plain(layer, k, v, lens, clear):
        ops.cache_write(k, v, lens, *(layer[n] for n in names), spec,
                        ring=ring, clear_from=clear, kernel=False)

    replay = fresh()
    for k, v, lens, wkw in tap.writes:
        plain(replay, k, v, lens, wkw.get("clear_from"))
    for n in names:
        check(torch.equal(replay[n], lc[n]),
              f"the served cache's {n} differ from the plain writes "
              f"replayed (a prefill of {tap.writes[0][0].shape[1]} and "
              f"{len(tap.writes) - 1} decode writes, ring {ring}, lengths "
              f"{lengths.tolist()})")
    kp, vp = tap.writes[0][:2]
    kd, vd, ld = tap.writes[-1][:3]
    cases = {"prefill": (kp, vp, None)}
    if ring:
        roll = 1024
        cases["rolled_prefill"] = tuple(torch.cat([x, x[:, :roll]], 1)
                                        for x in (kp, vp)) + (None,)
    cases["step"] = (kd, vd, ld)
    out = {f"{key}_ring": ring, f"{key}_replayed": len(tap.writes)}
    where = f"into the ring of {ring}" if ring else f"at D = {D}"
    cd = torch.empty((), dtype=fmt.code_dtype()).element_size()
    for name, (k, v, lens) in cases.items():
        T = k.shape[1]
        stored = min(T, ring) if ring else T
        kl = fresh()
        if lens is None:
            def write(kl=kl, k=k, v=v):
                kvcache.build_cache(k, v, fmt, cache_len=S, ring=ring, out=kl)
        else:
            def write(kl=kl, k=k, v=v, lens=lens):
                kvcache.append(kl, k, v, lens, fmt, ring=ring)
        clear = stored if lens is None else None
        write()
        pl = fresh()
        plain(pl, k, v, lens, clear)
        for n in names:
            check(torch.equal(kl[n], pl[n]),
                  f"cache write {where}, {name} ({tuple(k.shape)}): {n} != "
                  "plain")
        # K and V read once and their codes and a uint8 exponent a row
        # written once, for the rows that land (a roll drops the rest)
        rows = 2 * B * Hkv * stored
        nbytes = rows * D * (k.element_size() + cd) + rows + (
            4 * B if lens is not None else 0)
        out.update({
            f"{key}_{name}_shape": list(k.shape),
            f"{key}_{name}_ms": timed(write),
            f"{key}_{name}_plain_ms": timed(
                lambda k=k, v=v, lens=lens, clear=clear: plain(
                    fresh(), k, v, lens, clear), reps=3),
            f"{key}_{name}_bound_ms": bound_ms(nbytes)[0]})
        print(f"{tag} cache write {where}, {name} "
              f"({tuple(k.shape)} {str(k.dtype)[6:]} K and V, l {spec.l}"
              + (f", lengths {int(lens.min())}-{int(lens.max())}"
                 if lens is not None else "") + "): equal to plain, "
              f"{out[f'{key}_{name}_ms'] * 1e3:.2f} us, plain "
              f"{out[f'{key}_{name}_plain_ms'] * 1e3:.1f} us, bound "
              f"{out[f'{key}_{name}_bound_ms'] * 1e3:.3f} us")
    print(f"{tag} the served cache of the last layer ({B}x{Hkv}x{S} slots"
          + (f", a ring of {ring}" if ring else "") + ", lengths "
          f"{int(lengths.min())}-{int(lengths.max())}) equals the plain "
          f"version replayed over its {len(tap.writes)} writes")
    return out


def _ring_attention_check(tap):
    """Kernel 9 on the served ring cache (the last decode step's q, the last
    layer's cache, its lengths clamped to the slots as ``attend`` clamps
    them) against the reference's masked softmax over the ring
    (``kvcache.masked_attend``, unclamped lengths); then timed beside its
    bound, the masked softmax and SDPA on the decoded K/V."""
    import torch

    from repro_torch.core import frsz2 as F
    from repro_torch.kernels import ops
    from repro_torch.kernels.cardcheck import ATTN_TOL, ATTN_TOL_BF16
    from repro_torch.models import kvcache

    check(tap.last is not None, "the MoE serve run attended no cache")
    q, lc, lengths, fmt, kw = tap.last
    ring = kw.get("ring", 0)
    B, H, D = q.shape
    _, Hkv, S, _ = lc["k_codes"].shape
    G = H // Hkv
    check(ring == S and int(lengths.min()) > ring,
          f"the last attention is not on a wrapped ring: ring {ring}, "
          f"{S} slots, lengths {lengths.tolist()}")
    spec = fmt.spec(D)
    kbc, vbc = (F.BlockCompressed(codes=lc[f"{n}_codes"].view(B, Hkv, S, 1, D),
                                  exps=lc[f"{n}_exps"], n=D, spec=spec)
                for n in "kv")
    clamped = lengths.clamp(max=S)
    out = {}
    for label, qq, tol in (("served", q, ATTN_TOL_BF16),
                           ("f32", q.float(), ATTN_TOL)):
        got = ops.decode_attention(qq, kbc, vbc, clamped, kernel=True)
        want = kvcache.masked_attend(qq, lc, lengths, fmt, ring=ring)
        err = float((got.float() - want.float()).abs().max())
        rel = err / float(want.float().abs().max())
        check(rel <= tol, f"decode_attn on the ring cache, {qq.dtype} q: max "
                          f"abs error {err:.3e}, {rel:.3e} of the largest "
                          "output of the masked softmax")
        out[f"ring_rel_err_{label}_q"] = rel
        out[f"ring_err_{label}_q"] = err
    valid = int(clamped.sum())
    kd = ops.decompress(kbc, kernel=True).view(B, Hkv, S, D)
    vd = ops.decompress(vbc, kernel=True).view(B, Hkv, S, D)
    mask = (torch.arange(S, device=q.device)[None, :] < clamped[:, None]
            )[:, None, None, :]
    sdpa = functools.partial(
        torch.nn.functional.scaled_dot_product_attention,
        q.float().view(B, Hkv, G, D), kd, vd, attn_mask=mask)
    code_bytes = F.code_dtype(spec.l).itemsize
    nbytes = 2 * valid * Hkv * (D * code_bytes + 1) + 2 * B * H * D * q.element_size()
    b, by = bound_ms(nbytes, 4.0 * valid * Hkv * G * D, FP32_FLOPS)
    out.update(
        ring_shape=f"B={B} Hkv={Hkv} G={G} D={D} S={S} (a ring of {ring}), "
                   f"lengths {int(lengths.min())}-{int(lengths.max())} "
                   f"clamped to {S}, l={spec.l}, {q.dtype} q",
        ring_ms=timed(lambda: ops.decode_attention(q, kbc, vbc, clamped,
                                                   kernel=True)),
        ring_plain_ms=timed(lambda: kvcache.masked_attend(
            q, lc, lengths, fmt, ring=ring), reps=3),
        ring_bound_ms=b, ring_bound_by=by,
        ring_library_ms=timed(sdpa))
    print(f"[moe] kernel 9 on the ring cache ({out['ring_shape']}): "
          f"{out['ring_ms'] * 1e3:.1f} us, bound {b * 1e3:.2f} us, masked "
          f"softmax {out['ring_plain_ms'] * 1e3:.1f} us, SDPA on the decoded "
          f"K/V {out['ring_library_ms'] * 1e3:.1f} us; against the masked "
          f"softmax: served q {out['ring_rel_err_served_q']:.3e}, f32 q "
          f"{out['ring_rel_err_f32_q']:.3e} of the largest output")
    return out


def _moe_serve(arch, params, fmt_name, device_line):
    """One ``serve`` run of the MoE model with the launch checks of phase 9;
    returns its row and, for a FRSZ2 ring cache, the kernel's check."""
    import numpy as np
    import torch

    from repro_torch.kernels import ops
    from repro_torch.launch.serve import ServeConfig, decode_steps, serve
    from repro_torch.models import kvcache

    cfg = _moe_config(arch, fmt_name)
    rng = np.random.default_rng(0)
    reqs = [rng.integers(0, cfg.vocab_size, MOE_PROMPT).astype(np.int32)
            for _ in range(MOE_REQUESTS)]
    sc = ServeConfig(slots=MOE_SLOTS, prompt_len=MOE_PROMPT, max_new=MOE_NEW)
    steps = decode_steps(len(reqs), sc)
    sc.max_ctx = MOE_PROMPT + steps + 8
    fmt = kvcache.cache_format(fmt_name)
    frsz = fmt.kind == "frsz2"
    torch.cuda.reset_peak_memory_stats()
    stats = {}
    with _MoeServeTap(cfg.num_layers, MOE_SLOTS) as tap:
        ops.reset_launches()
        t = time.perf_counter()
        out = serve(cfg, sc, reqs, params=params, device="cuda",
                    verbose=False, stats=stats)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        got = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    check(sorted(out) == list(range(len(reqs))), f"{arch}: serve lost a "
                                                 "request")
    check(all(len(v) == MOE_NEW and all(0 <= x < cfg.vocab_size for x in v)
              for v in out.values()),
          f"{arch} {fmt_name}: a completion is not {MOE_NEW} tokens in range")
    check(stats["nonfinite_logits"] == 0,
          f"{arch} {fmt_name}: {stats['nonfinite_logits']} logits not finite")
    L = cfg.num_layers
    split = {"prefill": stats["prefill_launches"],
             "step": stats["step_launches"]}
    per_layer = {"prefill": (1, {"decode_attn": 0, "frsz2_cache_write": 1,
                                 "frsz2_compress": 0}),
                 "step": (steps, {"decode_attn": 1, "frsz2_cache_write": 1,
                                  "frsz2_compress": 0})}
    for part, (n, per) in per_layer.items():
        for k, m in per.items():
            want = n * m * L if frsz else 0
            check(split[part][k] == want,
                  f"{arch} {fmt_name}: {k} launched {split[part][k]} times "
                  f"in the {part}, the path implies {want}")
    others = {k: v for k, v in got.items() if v and k not in
              per_layer["step"][1]}
    check(not others, f"{arch} {fmt_name}: other kernels launched: {others}")
    window = cfg.window
    slots = next(iter(tap.last[1].values())).shape[2] if tap.last else None
    if window:
        check(slots == window, f"{arch}: the cache holds {slots} slots, not "
                               f"the window's {window}")
    ring = {}
    if frsz and window:
        ring = _ring_attention_check(tap)
        ring.update(_served_cache_writes(tap, fmt))
    # the byte bound of a decode step, as phase 9's: the weights it needs,
    # every one but the embedding table and the experts that none of the
    # step's kept choices reach (the distinct experts of each layer's
    # routing, averaged over the steps), and the cache positions it reads
    # (a ring: all its slots; otherwise the mean length over the run's
    # steps); beside it the bound with every expert read, as moe_block
    # reads them
    check(len(tap.routes) == steps * L,
          f"{arch} {fmt_name}: {len(tap.routes)} decode routings, the path "
          f"implies {steps * L}")
    touched = torch.tensor([int(torch.unique(g[k]).numel())
                            for g, k in tap.routes], dtype=torch.float64)
    del tap
    moe = params["layers"]["moe"]
    expert_bytes = sum(moe[n].numel() * moe[n].element_size()
                       for n in ("wg", "wi", "wo"))
    per_expert = expert_bytes / (L * cfg.num_experts)
    step_w_all = sum(t.numel() * t.element_size() for t in _leaves(params)
                     ) - params["embed"].numel() * params["embed"].element_size()
    step_w = (step_w_all - expert_bytes
              + per_expert * float(touched.sum()) / steps)
    mean_len = MOE_PROMPT + (steps + 1) / 2
    if window:
        mean_len = min(mean_len, window)
    cache_read = (L * MOE_SLOTS * cfg.num_kv_heads * mean_len
                  * cfg.hd * fmt.bits_per_value(cfg.hd) / 8 * 2)
    step_bound = (step_w + cache_read) / HBM_BYTES_PER_S * 1e3
    step_bound_all = (step_w_all + cache_read) / HBM_BYTES_PER_S * 1e3
    row = dict(phase="moe-serve", arch=arch, layers=L, kv_format=fmt_name,
               requests=len(reqs), slots=MOE_SLOTS, prompt=MOE_PROMPT,
               max_new=MOE_NEW, decode_steps=steps, cache_slots=slots,
               prefill_s=stats["prefill_s"],
               step_ms_median=statistics.median(stats["step_s"]) * 1e3,
               step_ms_min=min(stats["step_s"]) * 1e3,
               decode_tokens_per_s=MOE_SLOTS * steps / sum(stats["step_s"]),
               step_bound_ms=step_bound, step_weight_bytes=step_w,
               step_all_experts_bound_ms=step_bound_all,
               step_all_experts_weight_bytes=step_w_all,
               experts_touched_mean=float(touched.mean()),
               experts_touched_min=int(touched.min()),
               experts_touched_max=int(touched.max()),
               step_cache_bytes=cache_read, wall_s=wall, peak_mem_bytes=peak,
               launches={k: v for k, v in got.items() if v},
               step_launches={k: v for k, v in split["step"].items() if v},
               sample=out[0][:8], device=device_line, **ring)
    emit(row)
    print(f"[moe] {arch} {fmt_name}: prefill {row['prefill_s'][0]:.3f} s, "
          f"decode step median {row['step_ms_median']:.2f} ms (bound "
          f"{step_bound:.2f} ms on the {row['experts_touched_mean']:.2f} of "
          f"{cfg.num_experts} experts a layer that the step routes to, "
          f"{step_bound_all:.2f} ms with all), "
          f"{row['decode_tokens_per_s']:.1f} tokens/s, peak "
          f"{peak / 2**30:.2f} GiB, decode_attn "
          f"{split['step']['decode_attn']} in {steps} steps")
    return row, split["step"]["decode_attn"]


def phase_moe(device_line):
    """Slice 7a's path: the MoE family served at full width, 8 layers."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.launch.profile import profile_decode
    from repro_torch.models import init_params

    attn = write = None
    for arch in MOE_ARCHS:
        full = get_arch(arch)
        cfg = _moe_config(arch, "frsz2_16")
        t0 = time.perf_counter()
        params = init_params(cfg, torch.Generator(device="cuda")
                             .manual_seed(0))
        torch.cuda.synchronize()
        n = sum(t.numel() for t in _leaves(params))
        w_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
        print(f"[moe] {arch}: depth cut to {cfg.num_layers} of "
              f"{full.num_layers} layers at full width (d={cfg.d_model}, "
              f"{cfg.num_heads}/{cfg.num_kv_heads} heads, hd={cfg.hd}, "
              f"{cfg.num_experts} experts, top-{cfg.top_k}, "
              f"d_ff={cfg.d_ff}, window={cfg.window}, vocab="
              f"{cfg.vocab_size}, {cfg.dtype}): {n / 1e9:.2f} B parameters, "
              f"{w_bytes / 1e9:.2f} GB drawn in {time.perf_counter() - t0:.1f}"
              f" s; all {full.num_layers} layers would hold "
              f"{full.param_count() * 2 / 1e9:.0f} GB")
        for fmt in ("bf16", "frsz2_16"):
            e1, e2, slots = _moe_teacher_forcing(params, arch, fmt)
            print(f"[moe] {arch} teacher forcing {fmt} (B={TF_B}, "
                  f"S={MOE_TF_S}, {slots} cache slots): prefill {e1:.3e}, "
                  f"decode {e2:.3e} (relative to the largest logit, "
                  f"tolerance {TF_TOL})")
            check(e1 <= TF_TOL and e2 <= TF_TOL,
                  f"{arch} teacher forcing {fmt}: {e1:.3e}, {e2:.3e} > "
                  f"{TF_TOL}")
            emit(dict(phase="moe-teacher-forcing", arch=arch, kv_format=fmt,
                      prefill_rel_err=e1, decode_rel_err=e2,
                      cache_slots=slots))
            torch.cuda.empty_cache()
        rows = {}
        for fmt in MOE_FORMATS[arch]:
            rows[fmt] = _moe_serve(arch, params, fmt, device_line)
            torch.cuda.empty_cache()
        if arch == MOE_ARCHS[0]:
            prof = profile_decode(_moe_config(arch, "frsz2_16"), params,
                                  slots=MOE_SLOTS, prompt_len=MOE_PROMPT)
            prof.pop("top", None)
            emit(dict(phase="moe-profile", device=device_line, **prof))
            print(f"[moe] {arch} frsz2_16 profiled: "
                  f"{prof['wall_per_step_ms']:.2f} ms wall and "
                  f"{prof['device_per_step_ms']:.2f} ms of device time a "
                  f"decode step, busy {prof['device_busy_share']:.3f}, "
                  f"{prof['launches_per_step']:.0f} launches a step")
            row, launches = rows["frsz2_16"]
            attn = {k: v for k, v in row.items() if k.startswith("ring_")
                    and not k.startswith("ring_write_")}
            attn.update(ring_serve_launches=launches, ring_profile=prof)
            write = {k: v for k, v in row.items()
                     if k.startswith("ring_write_")}
        del params, rows
        torch.cuda.empty_cache()
    return attn, write


def _served_attention_check(q, lc, lengths, fmt, pre, tag):
    """Kernel 9 on a served cache (a decode step's q, one layer's cache and
    its lengths) against its plain version on the card, f32 q within 1e-5
    of the largest output and the served bf16 q within one bf16 step; timed
    beside its bound, the plain version and SDPA on the decoded K/V.  The
    results are keyed ``{pre}<name>_l<l>``."""
    import torch

    from repro_torch.core import frsz2 as F
    from repro_torch.kernels import ops
    from repro_torch.kernels.cardcheck import ATTN_TOL, ATTN_TOL_BF16
    from repro_torch.kernels.cardcheck import attn_pair as _attn_pair

    B, H, D = q.shape
    _, Hkv, S, _ = lc["k_codes"].shape
    G = H // Hkv
    spec = fmt.spec(D)
    kbc, vbc = (F.BlockCompressed(codes=lc[f"{n}_codes"].view(B, Hkv, S, 1, D),
                                  exps=lc[f"{n}_exps"], n=D, spec=spec)
                for n in "kv")
    sfx = f"_l{spec.l}"
    out = {}
    for label, qq, tol in (("served", q, ATTN_TOL_BF16),
                           ("f32", q.float(), ATTN_TOL)):
        ops.reset_launches()
        _, err, rel = _attn_pair(qq, kbc, vbc, lengths)
        check(ops.LAUNCHES["decode_attn"] == 1,
              f"{tag}: kernel 9 did not launch")
        check(rel <= tol, f"{tag}: decode_attn at l = {spec.l}, {qq.dtype} "
                          f"q: max abs error {err:.3e}, {rel:.3e} of the "
                          "largest output")
        out[f"{pre}rel_err_{label}_q{sfx}"] = rel
        out[f"{pre}err_{label}_q{sfx}"] = err
    valid = int(lengths.clamp(max=S).sum())
    kd = ops.decompress(kbc, kernel=False).view(B, Hkv, S, D)
    vd = ops.decompress(vbc, kernel=False).view(B, Hkv, S, D)
    mask = (torch.arange(S, device=q.device)[None, :] < lengths[:, None]
            )[:, None, None, :]
    sdpa = functools.partial(
        torch.nn.functional.scaled_dot_product_attention,
        q.float().view(B, Hkv, G, D), kd, vd, attn_mask=mask)
    code_bytes = F.code_dtype(spec.l).itemsize
    nbytes = (2 * valid * Hkv * (D * code_bytes + 1)
              + 2 * B * H * D * q.element_size())
    b, by = bound_ms(nbytes, 4.0 * valid * Hkv * G * D, FP32_FLOPS)
    out.update({
        pre + "shape" + sfx: f"B={B} Hkv={Hkv} G={G} D={D} S={S}, lengths "
                             f"{int(lengths.min())}-{int(lengths.max())}, "
                             f"{valid} valid positions, l={spec.l}, "
                             f"{q.dtype} q",
        pre + "ms" + sfx: timed(lambda: ops.decode_attention(
            q, kbc, vbc, lengths, kernel=True)),
        pre + "plain_ms" + sfx: timed(lambda: ops.decode_attention(
            q, kbc, vbc, lengths, kernel=False), reps=3),
        pre + "bound_ms" + sfx: b, pre + "bound_by" + sfx: by,
        pre + "bytes" + sfx: nbytes,
        pre + "library_ms" + sfx: timed(sdpa)})
    print(f"{tag} kernel 9 ({out[pre + 'shape' + sfx]}): "
          f"{out[pre + 'ms' + sfx] * 1e3:.1f} us, bound {b * 1e3:.2f} us, "
          f"plain {out[pre + 'plain_ms' + sfx] * 1e3:.1f} us, SDPA on the "
          f"decoded K/V {out[pre + 'library_ms' + sfx] * 1e3:.1f} us; "
          f"against the plain version: served q "
          f"{out[pre + 'rel_err_served_q' + sfx]:.3e}, f32 q "
          f"{out[pre + 'rel_err_f32_q' + sfx]:.3e} of the largest output")
    return out


def _hd112_attention_check(tap):
    """Kernel 9 at D = 112 on zamba2's served cache: the last decode step's
    q, the last application's cache and lengths."""
    check(tap.last is not None, "zamba2's serve run attended no cache")
    q, lc, lengths, fmt, _ = tap.last
    check(q.shape[-1] == 112, f"zamba2 attended at D = {q.shape[-1]}")
    return _served_attention_check(q, lc, lengths, fmt, "hd112_",
                                   "[ssm] zamba2's served cache,")


def _ssm_teacher_forcing(params, cfg, S=SSM_TF_S, forward=SSM_TF_S + 1):
    """Relative errors of a prefill of ``S`` tokens and of one decode step
    against the parallel forward over ``forward`` tokens (causal: the
    positions past S change nothing before them)."""
    import torch

    from repro_torch.models import decode_step, prefill, trunk
    from repro_torch.models.layers import rms_norm

    gen = torch.Generator(device="cuda").manual_seed(5)
    tokens = torch.randint(0, cfg.vocab_size, (TF_B, forward), generator=gen,
                           device="cuda")
    h, _ = trunk(params, cfg, tokens)

    def head(x):
        return (rms_norm(x, params["final_ln"]) @ params["unembed"]).float()

    want, want2 = head(h[:, S - 1]), head(h[:, S])
    del h
    torch.cuda.empty_cache()
    got, cache = prefill(params, cfg, tokens[:, :S], cache_len=S + 4)
    got2, _ = decode_step(params, cfg, cache, tokens[:, S])

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max())

    return rel(got, want), rel(got2, want2)


def _ssm_serve(cfg, params, device_line):
    """One ``serve`` run of an SSM-family model with phase 9's traffic and
    launch checks; returns its row and, for zamba2's FRSZ2 runs, the checks
    of kernels 9 and 1 on what it served."""
    import numpy as np
    import torch

    from repro_torch.kernels import ops
    from repro_torch.launch.profile import decode_step_bytes
    from repro_torch.launch.serve import ServeConfig, decode_steps, serve
    from repro_torch.models import kvcache
    from repro_torch.models.lm import kv_layers

    rng = np.random.default_rng(0)
    reqs = [rng.integers(0, cfg.vocab_size, SERVE_PROMPT).astype(np.int32)
            for _ in range(SERVE_REQUESTS)]
    sc = ServeConfig(slots=SERVE_SLOTS, prompt_len=SERVE_PROMPT,
                     max_new=SERVE_NEW)
    steps = decode_steps(len(reqs), sc)
    sc.max_ctx = SERVE_PROMPT + steps + 8
    fmt = kvcache.cache_format(cfg.kv_format)
    R = kv_layers(cfg)
    frsz = fmt.kind == "frsz2" and R > 0
    torch.cuda.reset_peak_memory_stats()
    stats = {}
    with _MoeServeTap(max(R, 1), SERVE_SLOTS) as tap:
        ops.reset_launches()
        t = time.perf_counter()
        out = serve(cfg, sc, reqs, params=params, device="cuda",
                    verbose=False, stats=stats)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        got = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    label = f"{cfg.name} {cfg.kv_format if R else '(no KV cache)'}"
    check(sorted(out) == list(range(len(reqs))), f"{label}: serve lost a "
                                                 "request")
    check(all(len(v) == SERVE_NEW and all(0 <= x < cfg.vocab_size for x in v)
              for v in out.values()),
          f"{label}: a completion is not {SERVE_NEW} tokens in range")
    check(stats["nonfinite_logits"] == 0,
          f"{label}: {stats['nonfinite_logits']} logits not finite")
    check(len(stats["step_s"]) == steps and len(stats["prefill_s"]) == 1,
          f"{label}: {len(stats['step_s'])} decode steps, "
          f"{len(stats['prefill_s'])} prefills")
    split = {"prefill": stats["prefill_launches"],
             "step": stats["step_launches"]}
    # zamba2: its shared block writes its cache once an application in the
    # prefill and in each step, and attends once an application a step
    per = {"prefill": (1, {"decode_attn": 0, "frsz2_cache_write": 1,
                           "frsz2_compress": 0}),
           "step": (steps, {"decode_attn": 1, "frsz2_cache_write": 1,
                            "frsz2_compress": 0})}
    for part, (n, want) in per.items():
        for k, m in want.items():
            n_want = n * m * R if frsz else 0
            check(split[part][k] == n_want,
                  f"{label}: {k} launched {split[part][k]} times in the "
                  f"{part}, the path implies {n_want}")
    others = {k: v for k, v in got.items() if v and k not in per["step"][1]}
    check(not others, f"{label}: other kernels launched: {others}")
    if not R:
        check(not any(got.values()),
              f"{label}: FRSZ2 kernels launched: {got}")
        print(f"[ssm] {cfg.name}: 0 FRSZ2 launches in the prefill and the "
              f"{steps} decode steps: a pure SSM keeps no KV cache, so the "
              "paper's technique has no written-once, re-read-many stream "
              "to compress here (its state is rewritten every step)")
    checks = {}
    if frsz:
        checks = _hd112_attention_check(tap)
        if fmt.l == 16:
            checks.update(_served_cache_writes(tap, fmt, "hd112_write",
                                               "[ssm]"))
    del tap
    mean_len = SERVE_PROMPT + (steps + 1) / 2
    bound = decode_step_bytes(cfg, params, SERVE_SLOTS, mean_len)
    row = dict(phase="ssm-serve", arch=cfg.name, layers=cfg.num_layers,
               kv_format=cfg.kv_format if R else None, kv_layers=R,
               requests=len(reqs), slots=SERVE_SLOTS, prompt=SERVE_PROMPT,
               max_new=SERVE_NEW, decode_steps=steps,
               prefill_s=stats["prefill_s"],
               step_ms_median=statistics.median(stats["step_s"]) * 1e3,
               step_ms_min=min(stats["step_s"]) * 1e3,
               decode_tokens_per_s=SERVE_SLOTS * steps / sum(stats["step_s"]),
               step_bound_ms=bound["bound_ms"],
               step_weight_bytes=bound["weight_bytes"],
               step_state_bytes=bound["state_bytes"],
               step_cache_bytes=bound["cache_bytes"], wall_s=wall,
               peak_mem_bytes=peak,
               cache_nbytes=kvcache.cache_nbytes(
                   fmt, R, SERVE_SLOTS, cfg.num_kv_heads, sc.max_ctx,
                   cfg.hd) if R else 0,
               launches={k: v for k, v in got.items() if v},
               step_launches={k: v for k, v in split["step"].items() if v},
               prefill_launches={k: v for k, v in split["prefill"].items()
                                 if v},
               sample=out[0][:8], device=device_line, **checks)
    emit(row)
    print(f"[ssm] {label}: prefill {row['prefill_s'][0]:.3f} s, decode step "
          f"median {row['step_ms_median']:.2f} ms (bound "
          f"{row['step_bound_ms']:.2f} ms: {bound['weight_bytes'] / 1e9:.2f}"
          f" GB of weights, {bound['state_bytes'] / 1e9:.3f} GB of state, "
          f"{bound['cache_bytes'] / 1e9:.3f} GB of cache), "
          f"{row['decode_tokens_per_s']:.1f} tokens/s, peak "
          f"{peak / 2**30:.2f} GiB, cache {row['cache_nbytes'] / 1e9:.3f} GB,"
          f" decode_attn {split['step']['decode_attn']} and "
          f"frsz2_cache_write {split['step']['frsz2_cache_write']} in "
          f"{steps} steps")
    return row


def phase_ssm(device_line):
    """Slice 7b's path: falcon-mamba-7b and zamba2-7b served at full width
    and full depth."""
    import dataclasses

    import torch

    from repro_torch.configs import get_arch
    from repro_torch.launch.profile import profile_decode
    from repro_torch.models import init_params
    from repro_torch.models.lm import kv_layers

    t_phase = time.perf_counter()
    marks = []                                 # (what, seconds) in order

    def mark(what, t0):
        marks.append((what, time.perf_counter() - t0))
        return time.perf_counter()

    attn, write, launches = {}, {}, {}
    for arch in SSM_ARCHS:
        cfg = get_arch(arch)
        t0 = time.perf_counter()
        params = init_params(cfg, torch.Generator(device="cuda")
                             .manual_seed(0))
        torch.cuda.synchronize()
        n = sum(t.numel() for t in _leaves(params))
        w_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
        R = kv_layers(cfg)
        print(f"[ssm] {arch}: full width and depth ({cfg.num_layers} "
              f"Mamba{cfg.mamba_version} layers, d={cfg.d_model}, "
              f"d_inner={cfg.d_inner}, N={cfg.ssm_state}"
              + (f", P={cfg.ssm_head_dim}, one shared attention block "
                 f"({cfg.num_heads}/{cfg.num_kv_heads} heads, hd={cfg.hd}, "
                 f"d_ff={cfg.d_ff}) applied {R} times"
                 if cfg.family == "hybrid" else "")
              + f", vocab={cfg.vocab_size}, {cfg.dtype}): {n / 1e9:.2f} B "
              f"parameters, {w_bytes / 1e9:.2f} GB drawn in "
              f"{time.perf_counter() - t0:.1f} s")
        t0 = mark(f"{arch} weights", t0)
        # zamba2's check on its weights cast to f32 (see SSM_TF_BF16)
        tf_params = _cast(params, torch.float32) if R else params
        tf_dtype = "float32" if R else cfg.dtype
        for fmt in ("bf16", "frsz2_16") if R else (cfg.kv_format,):
            e1, e2 = _ssm_teacher_forcing(tf_params, dataclasses.replace(
                cfg, kv_format=fmt, dtype=tf_dtype))
            print(f"[ssm] {arch} teacher forcing, {tf_dtype} weights"
                  + (f", {fmt} cache" if R else "") + f" (B={TF_B}, "
                  f"S={SSM_TF_S}, the forward over {SSM_TF_S + 1}): prefill "
                  f"{e1:.3e}, decode {e2:.3e} (relative to the largest "
                  f"logit, tolerance {TF_TOL})")
            check(e1 <= TF_TOL and e2 <= TF_TOL,
                  f"{arch} teacher forcing {fmt}: {e1:.3e}, {e2:.3e} > "
                  f"{TF_TOL}")
            emit(dict(phase="ssm-teacher-forcing", arch=arch,
                      dtype=tf_dtype, kv_format=fmt if R else None,
                      prefill_rel_err=e1, decode_rel_err=e2))
        del tf_params
        torch.cuda.empty_cache()
        if R:
            S_, F_ = SSM_TF_BF16
            e1, e2 = _ssm_teacher_forcing(params, dataclasses.replace(
                cfg, kv_format="frsz2_16"), S_, F_)
            print(f"[ssm] {arch} in bf16 (frsz2_16 cache, S={S_}, the "
                  f"forward over {F_}: the chunks line up): prefill "
                  f"{e1:.3e}, decode {e2:.3e}; measured, not held to "
                  f"{TF_TOL}: bf16 roundings of differently shaped products,"
                  f" amplified over {cfg.num_layers + 2 * R} blocks")
            emit(dict(phase="ssm-teacher-forcing", arch=arch,
                      dtype=cfg.dtype, kv_format="frsz2_16", prompt=S_,
                      forward=F_, prefill_rel_err=e1, decode_rel_err=e2,
                      checked=False))
            torch.cuda.empty_cache()
        t0 = mark(f"{arch} teacher forcing", t0)
        for fmt in SSM_FORMATS[arch]:
            row = _ssm_serve(dataclasses.replace(cfg, kv_format=fmt), params,
                             device_line)
            torch.cuda.empty_cache()
            t0 = mark(f"{arch} serve {fmt if R else ''}".rstrip(), t0)
            if R and fmt.startswith("frsz2"):
                attn.update({k: v for k, v in row.items()
                             if k.startswith("hd112_")
                             and not k.startswith("hd112_write_")})
                write.update({k: v for k, v in row.items()
                              if k.startswith("hd112_write_")})
            if R and fmt == "frsz2_16":
                launches = row["step_launches"]
        cfg_p = dataclasses.replace(cfg, kv_format=SSM_FORMATS[arch][0])
        prof = profile_decode(cfg_p, params, top=8,
                              steps=SSM_PROFILE_STEPS, profile_prefill=False)
        t0 = mark(f"{arch} profile", t0)
        emit(dict(phase="ssm-profile", device=device_line, **prof))
        print(f"[ssm] {arch}" + (f" {cfg_p.kv_format}" if R else "")
              + f" profiled: {prof['wall_per_step_ms']:.2f} ms wall and "
              f"{prof['device_per_step_ms']:.2f} ms of device time a decode "
              f"step (bound {prof['step_bound_ms']:.2f} ms), busy "
              f"{prof['device_busy_share']:.3f}, "
              f"{prof['launches_per_step']:.0f} launches a step")
        if R:
            attn["hd112_profile"] = prof
        else:
            attn["ssm_profile_" + arch] = prof
        del params
        release()
    print(f"[ssm] phase 11 took {time.perf_counter() - t_phase:.1f} s: "
          + "; ".join(f"{w} {t:.1f}" for w, t in marks))
    attn["hd112_serve_step_launches"] = launches.get("decode_attn", 0)
    write["hd112_serve_step_launches"] = launches.get("frsz2_cache_write", 0)
    return attn, write


class _CrossServeTap:
    """For one serve run of an encdec or VLM model: the cross caches as the
    prefill left them (a clone of ``cache["cross"]``, and the cache itself,
    which the decode steps then use in place), the inputs of the last
    cross-attention of the last decode step (``attn``: q, the layer's
    cache, the source lengths, the format), and the K/V of the last cross
    layer's prefill write (``write``: a whole write of ``cross_len``
    positions from position 0).  Everything runs unchanged."""

    def __init__(self, cross_len):
        from repro_torch.kernels import ops
        from repro_torch.launch import serve as serve_mod
        from repro_torch.models import kvcache, lm

        self.cross_len = cross_len
        self.cache = self.snapshot = self.attn = self.write = None
        self._in_cross = False
        self._slots = ((serve_mod, "prefill"), (lm, "_cross_attn_decode"),
                       (kvcache, "attend"), (ops, "cache_write"))
        self._orig = [getattr(m, n) for m, n in self._slots]

    def __enter__(self):
        prefill0, cross0, attend0, write0 = self._orig

        def prefill(*args, **kw):
            logits, cache = prefill0(*args, **kw)
            self.cache = cache
            self.snapshot = {n: t.clone() for n, t in cache["cross"].items()}
            return logits, cache

        def cross_attn_decode(*args, **kw):
            self._in_cross = True
            try:
                return cross0(*args, **kw)
            finally:
                self._in_cross = False

        def attend(q, layer_cache, lengths, fmt, **kw):
            if self._in_cross:
                self.attn = (q, layer_cache, lengths, fmt)
            return attend0(q, layer_cache, lengths, fmt, **kw)

        def cache_write(k, v, lengths, *args, **kw):
            if lengths is None and k.shape[1] == self.cross_len:
                self.write = (k, v)
            return write0(k, v, lengths, *args, **kw)

        for (m, n), f in zip(self._slots, (prefill, cross_attn_decode, attend,
                                           cache_write)):
            setattr(m, n, f)
        return self

    def __exit__(self, *exc):
        for (m, n), f in zip(self._slots, self._orig):
            setattr(m, n, f)


def _cross_attention_check(tap, tag):
    """Kernel 9 on the served cross cache: the last decode step's last
    cross-attention q, the last cross layer's cache, every position
    valid."""
    check(tap.attn is not None, f"{tag}: the serve run read no cross cache")
    q, lc, lengths, fmt = tap.attn
    S = lc["k_codes"].shape[2]
    check(S == tap.cross_len and bool((lengths == S).all()),
          f"{tag}: the cross attention read lengths {lengths.tolist()} of a "
          f"cache of {S} positions, not all {tap.cross_len}")
    return _served_attention_check(q, lc, lengths, fmt, f"cross_{tag}_",
                                   f"[cross] {tag}'s served cross cache,")


def _cross_cache_checks(tap, tag, fmt):
    """The cross caches as served: every layer bit for bit as the prefill
    left it after all the decode steps; for an FRSZ2 format, the last
    cross layer's codes and exponents bit-equal to the plain compress of
    the K/V the prefill wrote there (``src @ wk``, ``src @ wv``), and that
    write (kernel 1 through ``kvcache.build_cache``) equal to its plain
    version on a fresh layer and timed beside its bound."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.models import kvcache

    cross = tap.cache["cross"]
    for n, t in tap.snapshot.items():
        check(torch.equal(cross[n], t),
              f"{tag}: the decode steps changed the cross cache's {n}")
    name = f"l{fmt.l}" if fmt.kind == "frsz2" else fmt.raw_dtype
    out = {f"cross_{tag}_unchanged_bytes_{name}": sum(
        t.numel() * t.element_size() for t in tap.snapshot.values())}
    if fmt.kind != "frsz2":
        return out
    check(tap.write is not None, f"{tag}: no whole cross-cache write seen")
    k, v = tap.write
    B, S, Hkv, D = k.shape
    spec = fmt.spec(D)
    lc = {n: t[-1] for n, t in cross.items()}
    for x, name in ((k, "k"), (v, "v")):
        want = ops.compress(x.transpose(1, 2).float(), spec, kernel=False)
        check(torch.equal(lc[f"{name}_codes"].reshape(want.codes.shape),
                          want.codes)
              and torch.equal(lc[f"{name}_exps"].reshape(want.exps.shape),
                              want.exps.to(torch.uint8)),
              f"{tag}: the last cross layer's {name} codes differ from the "
              "plain compress of the prefill's K/V")
    names = ("k_codes", "k_exps", "v_codes", "v_exps")

    def fresh():
        return {n: torch.zeros_like(lc[n]) for n in names}

    kl, pl = fresh(), fresh()

    def write():
        kvcache.build_cache(k, v, fmt, out=kl)

    def plain(layer):
        ops.cache_write(k, v, None, *(layer[n] for n in names), spec,
                        clear_from=S, kernel=False)

    write()
    plain(pl)
    for n in names:
        check(torch.equal(kl[n], pl[n]) and torch.equal(kl[n], lc[n]),
              f"{tag}: the cross cache write's {n} != plain")
    rows = 2 * B * S * Hkv
    cd = torch.empty((), dtype=fmt.code_dtype()).element_size()
    nbytes = rows * D * (k.element_size() + cd) + rows
    pre = f"cross_{tag}_write_l{spec.l}_"
    out.update({pre + "shape": list(k.shape), pre + "ms": timed(write),
                pre + "plain_ms": timed(lambda: plain(fresh()), reps=3),
                pre + "bytes": nbytes, pre + "bound_ms": bound_ms(nbytes)[0],
                pre + "rows_bit_equal": rows})
    print(f"[cross] {tag}: every cross cache unchanged across the decode "
          f"steps; the last cross layer ({B}x{Hkv}x{S}) bit-equal to the "
          f"plain compress of the prefill's K/V; its write "
          f"({tuple(k.shape)} {str(k.dtype)[6:]} K and V, l {spec.l}) "
          f"{out[pre + 'ms'] * 1e3:.2f} us through build_cache, plain "
          f"{out[pre + 'plain_ms'] * 1e3:.1f} us, bound "
          f"{out[pre + 'bound_ms'] * 1e3:.2f} us")
    return out


def _cross_teacher_forcing(params, cfg):
    """Relative errors of a prefill of TF_S tokens and of one decode step
    against the parallel forward over TF_S + 1, with the same frames or
    image embeddings."""
    import torch

    from repro_torch.launch.serve import aux_for
    from repro_torch.models import decode_step, prefill, trunk
    from repro_torch.models.layers import rms_norm

    gen = torch.Generator(device="cuda").manual_seed(5)
    tokens = torch.randint(0, cfg.vocab_size, (TF_B, TF_S + 1), generator=gen,
                           device="cuda")
    aux = aux_for(cfg, TF_B, gen)
    h, _ = trunk(params, cfg, tokens, aux)

    def head(x):
        return (rms_norm(x, params["final_ln"]) @ params["unembed"]).float()

    want, want2 = head(h[:, TF_S - 1]), head(h[:, TF_S])
    del h
    torch.cuda.empty_cache()
    got, cache = prefill(params, cfg, tokens[:, :TF_S], aux,
                         cache_len=TF_S + 4)
    got2, _ = decode_step(params, cfg, cache, tokens[:, TF_S])

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max())

    return rel(got, want), rel(got2, want2)


def _cross_serve(cfg, params, device_line):
    """One ``serve`` run of an encdec or VLM model as a user calls it (its
    frames or image embeddings drawn by ``serve``), with the launch checks;
    returns its row with, for the FRSZ2 runs, the checks of kernels 9 and
    1 on the served cross caches."""
    import numpy as np
    import torch

    from repro_torch.kernels import ops
    from repro_torch.launch.profile import decode_step_bytes
    from repro_torch.launch.serve import ServeConfig, decode_steps, serve
    from repro_torch.models import kvcache
    from repro_torch.models.lm import cross_layers, cross_len, kv_layers

    tag = CROSS_TAG[cfg.name]
    prompt = CROSS_PROMPT[cfg.name]
    rng = np.random.default_rng(0)
    reqs = [rng.integers(0, cfg.vocab_size, prompt).astype(np.int32)
            for _ in range(SERVE_REQUESTS)]
    sc = ServeConfig(slots=SERVE_SLOTS, prompt_len=prompt, max_new=SERVE_NEW)
    steps = decode_steps(len(reqs), sc)
    sc.max_ctx = prompt + steps + 8
    fmt = kvcache.cache_format(cfg.kv_format)
    R, X, Ss = kv_layers(cfg), cross_layers(cfg), cross_len(cfg)
    frsz = fmt.kind == "frsz2"
    torch.cuda.reset_peak_memory_stats()
    stats = {}
    with _CrossServeTap(Ss) as tap:
        ops.reset_launches()
        t = time.perf_counter()
        out = serve(cfg, sc, reqs, params=params, device="cuda",
                    verbose=False, stats=stats)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        got = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    label = f"{cfg.name} {cfg.kv_format}"
    check(sorted(out) == list(range(len(reqs))), f"{label}: serve lost a "
                                                 "request")
    check(all(len(v) == SERVE_NEW and all(0 <= x < cfg.vocab_size for x in v)
              for v in out.values()),
          f"{label}: a completion is not {SERVE_NEW} tokens in range")
    check(stats["nonfinite_logits"] == 0,
          f"{label}: {stats['nonfinite_logits']} logits not finite")
    check(len(stats["step_s"]) == steps and len(stats["prefill_s"]) == 1,
          f"{label}: {len(stats['step_s'])} decode steps, "
          f"{len(stats['prefill_s'])} prefills")
    split = {"prefill": stats["prefill_launches"],
             "step": stats["step_launches"]}
    # the prefill writes every self layer's cache and every cross cache
    # once; a decode step writes the self layers only, and attends once a
    # self layer and once a cross block
    want = {"prefill": {"decode_attn": 0, "frsz2_cache_write": R + X,
                        "frsz2_compress": 0},
            "step": {"decode_attn": (R + X) * steps,
                     "frsz2_cache_write": R * steps, "frsz2_compress": 0}}
    for part, per in want.items():
        for k, n in per.items():
            n_want = n if frsz else 0
            check(split[part][k] == n_want,
                  f"{label}: {k} launched {split[part][k]} times in the "
                  f"{part}, the path implies {n_want}")
    others = {k: v for k, v in got.items() if v and k not in want["step"]}
    check(not others, f"{label}: other kernels launched: {others}")
    checks = _cross_cache_checks(tap, tag, fmt)
    if frsz:
        checks.update(_cross_attention_check(tap, tag))
    del tap
    torch.cuda.empty_cache()
    mean_len = prompt + (steps + 1) / 2
    bound = decode_step_bytes(cfg, params, SERVE_SLOTS, mean_len)
    row = dict(phase="cross-serve", arch=cfg.name, layers=cfg.num_layers,
               kv_format=cfg.kv_format, kv_layers=R, cross_layers=X,
               cross_len=Ss, requests=len(reqs), slots=SERVE_SLOTS,
               prompt=prompt, max_new=SERVE_NEW, decode_steps=steps,
               prefill_s=stats["prefill_s"],
               step_ms_median=statistics.median(stats["step_s"]) * 1e3,
               step_ms_min=min(stats["step_s"]) * 1e3,
               decode_tokens_per_s=SERVE_SLOTS * steps / sum(stats["step_s"]),
               step_bound_ms=bound["bound_ms"],
               step_weight_bytes=bound["weight_bytes"],
               step_cache_bytes=bound["cache_bytes"],
               step_cross_bytes=bound["cross_bytes"], wall_s=wall,
               peak_mem_bytes=peak,
               cache_nbytes=kvcache.cache_nbytes(
                   fmt, R, SERVE_SLOTS, cfg.num_kv_heads, sc.max_ctx, cfg.hd),
               cross_cache_nbytes=kvcache.cache_nbytes(
                   fmt, X, SERVE_SLOTS, cfg.num_kv_heads, Ss, cfg.hd),
               launches={k: v for k, v in got.items() if v},
               step_launches={k: v for k, v in split["step"].items() if v},
               prefill_launches={k: v for k, v in split["prefill"].items()
                                 if v},
               sample=out[0][:8], device=device_line, **checks)
    emit(row)
    print(f"[cross] {label}: prefill {row['prefill_s'][0]:.3f} s, decode "
          f"step median {row['step_ms_median']:.2f} ms (bound "
          f"{row['step_bound_ms']:.3f} ms: {bound['weight_bytes'] / 1e9:.3f}"
          f" GB of weights, {bound['cache_bytes'] / 1e9:.3f} GB of self "
          f"cache, {bound['cross_bytes'] / 1e9:.3f} GB of cross caches), "
          f"{row['decode_tokens_per_s']:.1f} tokens/s, peak "
          f"{peak / 2**30:.2f} GiB, caches {row['cache_nbytes'] / 1e9:.3f} "
          f"GB self + {row['cross_cache_nbytes'] / 1e9:.3f} GB cross, "
          f"decode_attn {split['step']['decode_attn']} and "
          f"frsz2_cache_write {split['step']['frsz2_cache_write']} in "
          f"{steps} steps, {split['prefill']['frsz2_cache_write']} writes in "
          "the prefill")
    return row


def phase_cross(device_line):
    """Slice 7c's path: whisper-medium and llama-3.2-vision-11b served at
    full width and full depth, one at a time."""
    import dataclasses

    import torch

    from repro_torch.configs import get_arch
    from repro_torch.launch.profile import profile_decode
    from repro_torch.models import init_params
    from repro_torch.models.lm import cross_layers, cross_len, kv_layers

    t_phase = time.perf_counter()
    marks = []

    def mark(what, t0):
        marks.append((what, time.perf_counter() - t0))
        return time.perf_counter()

    attn, write = {}, {}
    for arch in CROSS_ARCHS:
        cfg = get_arch(arch)
        tag = CROSS_TAG[arch]
        t0 = time.perf_counter()
        params = init_params(cfg, torch.Generator(device="cuda")
                             .manual_seed(0))
        torch.cuda.synchronize()
        n = sum(t.numel() for t in _leaves(params))
        w_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
        print(f"[cross] {arch}: full width and depth ({cfg.num_layers} "
              f"decoder layers"
              + (f", {cfg.encoder_layers} encoder layers over "
                 f"{cfg.encoder_seq} frames" if cfg.family == "encdec" else
                 f", a cross block after every {cfg.cross_attn_every}th over "
                 f"{cfg.num_image_tokens} image tokens")
              + f", d={cfg.d_model}, {cfg.num_heads}/{cfg.num_kv_heads} "
              f"heads, hd={cfg.hd}, d_ff={cfg.d_ff}, vocab={cfg.vocab_size},"
              f" {cfg.dtype}; {kv_layers(cfg)} self and {cross_layers(cfg)} "
              f"cross caches of {cross_len(cfg)} positions): "
              f"{n / 1e9:.2f} B parameters, {w_bytes / 1e9:.2f} GB drawn in "
              f"{time.perf_counter() - t0:.1f} s")
        t0 = mark(f"{tag} weights", t0)
        for fmt in ("bf16", "frsz2_16"):
            e1, e2 = _cross_teacher_forcing(
                params, dataclasses.replace(cfg, kv_format=fmt))
            print(f"[cross] {arch} teacher forcing, {fmt} caches (B={TF_B}, "
                  f"S={TF_S}): prefill {e1:.3e}, decode {e2:.3e} (relative "
                  f"to the largest logit, tolerance {TF_TOL})")
            check(e1 <= TF_TOL and e2 <= TF_TOL,
                  f"{arch} teacher forcing {fmt}: {e1:.3e}, {e2:.3e} > "
                  f"{TF_TOL}")
            emit(dict(phase="cross-teacher-forcing", arch=arch,
                      kv_format=fmt, prefill_rel_err=e1, decode_rel_err=e2))
            torch.cuda.empty_cache()
        t0 = mark(f"{tag} teacher forcing", t0)
        for fmt in CROSS_FORMATS[arch]:
            row = _cross_serve(dataclasses.replace(cfg, kv_format=fmt),
                               params, device_line)
            t0 = mark(f"{tag} serve {fmt}", t0)
            attn.update({k: v for k, v in row.items()
                         if k.startswith(f"cross_{tag}_")
                         and not k.startswith(f"cross_{tag}_write_")})
            write.update({k: v for k, v in row.items()
                          if k.startswith(f"cross_{tag}_write_")})
            if fmt == "frsz2_16":
                attn[f"cross_{tag}_serve_step_launches"] = \
                    row["step_launches"]["decode_attn"]
                write[f"cross_{tag}_serve_step_launches"] = \
                    row["step_launches"]["frsz2_cache_write"]
                write[f"cross_{tag}_serve_prefill_launches"] = \
                    row["prefill_launches"]["frsz2_cache_write"]
        cfg_p = dataclasses.replace(cfg, kv_format="frsz2_16")
        prof = profile_decode(cfg_p, params, top=8, slots=SERVE_SLOTS,
                              prompt_len=CROSS_PROMPT[arch],
                              steps=CROSS_PROFILE_STEPS,
                              profile_prefill=False)
        t0 = mark(f"{tag} profile", t0)
        emit(dict(phase="cross-profile", device=device_line, **prof))
        print(f"[cross] {arch} frsz2_16 profiled: "
              f"{prof['wall_per_step_ms']:.2f} ms wall and "
              f"{prof['device_per_step_ms']:.2f} ms of device time a decode "
              f"step (bound {prof['step_bound_ms']:.3f} ms), busy "
              f"{prof['device_busy_share']:.3f}, "
              f"{prof['launches_per_step']:.0f} launches a step; top: "
              + "; ".join(f"{k['name'][:40]} {k['device_ms_per_step']:.3f} ms"
                          for k in prof["top"][:4]))
        attn[f"cross_{tag}_profile"] = prof
        del params
        release()
    print(f"[cross] phase 12 took {time.perf_counter() - t_phase:.1f} s: "
          + "; ".join(f"{w} {t:.1f}" for w, t in marks))
    return attn, write


# ---------------------------------------------------------------------------
# Phase 13: training (slice 7d)
# ---------------------------------------------------------------------------


def _bits_equal(a, b) -> bool:
    """Two trees of tensors and ``BlockCompressed`` leaves, bit for bit."""
    import torch

    from repro_torch.kernels.cardcheck import bits
    from repro_torch.tree import leaves_with_paths

    la, lb = leaves_with_paths(a), leaves_with_paths(b)
    if [k for k, _ in la] != [k for k, _ in lb]:
        return False
    for (_, x), (_, y) in zip(la, lb):
        if x.dtype != y.dtype or x.shape != y.shape:
            return False
        xb = bits(x) if x.is_floating_point() else x
        yb = bits(y) if y.is_floating_point() else y
        if not torch.equal(xb, yb.to(xb.device)):
            return False
    return True


def _expect_codec(got, per_step, steps, init, what):
    """The codec's launches of a coded run: ``per_step`` of each a step,
    and ``per_step`` compress more for the zero state of ``adamw_init``
    (``init``); nothing else launched."""
    want = {"frsz2_compress": per_step * (steps + init),
            "frsz2_decompress": per_step * steps}
    others = {k: v for k, v in got.items() if v and k not in want}
    check({k: got[k] for k in want} == want and not others,
          f"{what}: launches {({k: v for k, v in got.items() if v})}, the "
          f"path implies {want}")


class _MomentTap:
    """During one training step, every ``ops.compress`` and
    ``ops.decompress`` (the AdamW moments through kernels 1 and 2) held
    against the plain codec on the same inputs: codes and exponents of the
    f32 moments, and the decoded values, bit for bit.  The comparisons run
    the plain codec and launch nothing."""

    def __enter__(self):
        from repro_torch.kernels import cardcheck, ops

        self.ops, self.n = ops, {"compress": 0, "decompress": 0, "values": 0}
        self._orig = ops.compress, ops.decompress
        compress0, decompress0 = self._orig

        def compress(x, spec, **kw):
            bc = compress0(x, spec, **kw)
            check(x.is_cuda and cardcheck.row_codes_equal(x, bc),
                  f"a moment's codes ({bc.n} values) differ from the plain "
                  "compress of the same f32 values")
            self.n["compress"] += 1
            self.n["values"] += bc.n
            return bc

        def decompress(bc, **kw):
            out = decompress0(bc, **kw)
            check(cardcheck.row_decode_equal(bc, out),
                  f"a moment's decode ({bc.n} values) differs from the "
                  "plain decompress")
            self.n["decompress"] += 1
            return out

        ops.compress, ops.decompress = compress, decompress
        return self

    def __exit__(self, *exc):
        self.ops.compress, self.ops.decompress = self._orig


def _opt_kernel_entries(state, largest, embed):
    """Kernels 1 and 2 as the coded AdamW runs them (rows 1o and 2o): one
    row of the largest leaf and of the embedding, f32 values, bs 128, l 16,
    nearest, on the final state's decoded moments; timed by CUDA events
    beside the plain codec (the largest leaf) and the bytes they move."""
    import torch

    from repro_torch.core import frsz2 as F
    from repro_torch.kernels import cardcheck, ops

    rows = {}
    for key, name in ((largest, "largest"), (embed, "embed")):
        bc = state["m"]
        for k in key.split("/"):
            bc = bc[k]
        x = ops.decompress(bc)
        codes, exps = torch.empty_like(bc.codes), torch.empty_like(bc.exps)
        n, nb = bc.n, bc.exps.numel()
        coded = codes.numel() * codes.element_size() + nb * 4
        row = dict(leaf=key, n=n, bytes=4 * n + coded)
        row["compress_ms"] = timed(lambda x=x, bc=bc, out=(codes, exps):
                                   ops.compress(x, bc.spec, out=out))
        row["decompress_ms"] = timed(lambda bc=bc: ops.decompress(bc))
        check(cardcheck.row_codes_equal(x, F.BlockCompressed(
            codes=codes, exps=exps, n=n, spec=bc.spec)),
            f"kernel 1 on {key} != plain")
        if name == "largest":
            row["compress_plain_ms"] = timed(
                lambda x=x, bc=bc: F.compress(x, bc.spec), reps=1)
            row["decompress_plain_ms"] = timed(
                lambda bc=bc: F.decompress(bc), reps=1)
        rows[name] = row
        del x, codes, exps
        torch.cuda.empty_cache()
    big = rows["largest"]

    def one(kernel):
        e = entry(f"frsz2_{kernel}_opt",
                  "src/repro_torch/kernels/csrc/frsz2_codec.cu",
                  "src/repro/kernels/frsz2_kernel.py:"
                  + ("113" if kernel == "compress" else "75"),
                  big[f"{kernel}_ms"], big[f"{kernel}_plain_ms"],
                  big["bytes"], 0.0, 0.0, kernel=f"frsz2_{kernel}",
                  path="train", err_unit="code" if kernel == "compress"
                  else "value bits",
                  shape=f"1 row of {big['n']} f32 ({big['leaf']}), bs 128, "
                        "l 16, nearest",
                  **{f"embed_{k}": v for k, v in rows["embed"].items()
                     if k != "bytes"},
                  embed_bound_ms=bound_ms(rows["embed"]["bytes"])[0])
        return e

    return {"frsz2_compress_opt": one("compress"),
            "frsz2_decompress_opt": one("decompress")}


def _train_family(arch, root):
    """One other family at ``reduced()`` on the card: 2 coded steps, the
    losses finite, the codec's launches as counted."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops
    from repro_torch.launch.train import TrainConfig, train
    from repro_torch.models import init_params
    from repro_torch.optim import AdamWConfig
    from repro_torch.tree import tree_leaves

    cfg = get_arch(arch).reduced()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    leaves = len(tree_leaves(params))
    opt = AdamWConfig(warmup_steps=5, decay_steps=2, compress_state=True)
    tc = TrainConfig(steps=2, global_batch=2, seq_len=64, ckpt_every=0,
                     ckpt_dir=str(root / arch))
    ops.reset_launches()
    t = time.perf_counter()
    _, hist = train(cfg, opt, tc, params=params, device="cuda",
                    verbose=False)
    wall = time.perf_counter() - t
    got = dict(ops.LAUNCHES)
    losses = [h["loss"] for h in hist]
    check(len(losses) == 2 and all(math.isfinite(x) for x in losses),
          f"{arch} reduced: losses {losses}")
    _expect_codec(got, 2 * leaves, 2, 1, f"{arch} reduced")
    print(f"[train] {arch} reduced ({cfg.family}, {leaves} leaves): losses "
          f"{losses[0]:.4f}, {losses[1]:.4f}; frsz2_compress "
          f"{got['frsz2_compress']}, frsz2_decompress "
          f"{got['frsz2_decompress']} ({wall:.1f} s)")
    return dict(arch=arch, family=cfg.family, leaves=leaves, losses=losses,
                launches={k: v for k, v in got.items() if v}, wall_s=wall)


def phase_train(device_line):
    """Slice 7d's path: yi-9b trained at full width (8 layers) with
    FRSZ2-coded AdamW moments through kernels 1 and 2, checkpointed,
    resumed; the plain state; every other family's backward."""
    import dataclasses
    import statistics as stats_mod

    import torch

    from repro_torch.configs import get_arch
    from repro_torch.data import GlobalBatchSpec
    from repro_torch.kernels import ops
    from repro_torch.checkpoint import store
    from repro_torch.launch import train as train_mod
    from repro_torch.launch.profile import profile_train, train_step_flops
    from repro_torch.launch.train import TrainConfig, make_step, train
    from repro_torch.models import init_params
    from repro_torch.models.config import SHAPES
    from repro_torch.optim import AdamWConfig
    from repro_torch.tree import leaves_with_paths, tree_leaves

    t_phase = time.perf_counter()
    marks = []

    def mark(what, t0):
        marks.append((what, time.perf_counter() - t0))
        return time.perf_counter()

    cfg = dataclasses.replace(get_arch(TRAIN_ARCH), num_layers=TRAIN_LAYERS)
    seq = SHAPES["train_4k"].seq_len
    # the CLI's schedule for --steps 5: warmup max(5 // 20, 5), decay 5
    opt = AdamWConfig(warmup_steps=5, decay_steps=TRAIN_STEPS,
                      compress_state=True)
    t0 = time.perf_counter()
    params0 = init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    paths = leaves_with_paths(params0)
    L = len(paths)
    N = sum(t.numel() for _, t in paths)
    largest = max(paths, key=lambda kv: kv[1].numel())[0]
    print(f"[train] {TRAIN_ARCH} at full width, {TRAIN_LAYERS} of "
          f"{get_arch(TRAIN_ARCH).num_layers} layers (d={cfg.d_model}, "
          f"{cfg.num_heads}/{cfg.num_kv_heads} heads, d_ff={cfg.d_ff}, "
          f"vocab={cfg.vocab_size}, {cfg.dtype}, remat {cfg.remat}): {N:,} "
          f"parameters in {L} leaves (largest {largest}), S={seq}, "
          f"batch {TRAIN_BATCH}, {time.perf_counter() - t0:.1f} s to draw")
    t0 = mark("weights", t0)
    root = pathlib.Path(tempfile.mkdtemp(prefix="chip_smoke_train_"))
    out = {}
    try:
        tc = TrainConfig(steps=TRAIN_STEPS, global_batch=TRAIN_BATCH,
                         seq_len=seq, ckpt_dir=str(root / "yi"),
                         ckpt_every=TRAIN_CKPT_EVERY, keep=2)
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        final, saved, restored = {}, {}, {}
        save0, restore0 = store.save, train_mod.restore

        def keep_save(root_, step, tree, **kw):
            # the host snapshot the async writer wrote, kept for the check
            # of what a resumed run restores
            saved[step] = tree
            return save0(root_, step, tree, **kw)

        def keep_restore(*a, **kw):
            out = restore0(*a, **kw)
            restored[out[0]] = out[1]
            return out

        store.save, train_mod.restore = keep_save, keep_restore
        try:
            t = time.perf_counter()
            _, hist = train(cfg, opt, tc, params=params0, device="cuda",
                            verbose=False, state_out=final)
            wall_a = time.perf_counter() - t
            launches_a = dict(ops.LAUNCHES)
            peak = torch.cuda.max_memory_allocated()
            losses = [h["loss"] for h in hist]
            check([h["step"] for h in hist] == list(range(TRAIN_STEPS))
                  and all(math.isfinite(x) for x in losses),
                  f"the training run's losses: {losses}")
            _expect_codec(launches_a, 2 * L, TRAIN_STEPS, 1, "the training run")
            step_s = [h["dt"] for h in hist]
            step_med = stats_mod.median(step_s[1:])
            flops = train_step_flops(cfg, TRAIN_BATCH, seq)
            mfu = flops / (step_med * BF16_FLOPS)
            coded = sum(bc.nbytes() for part in ("m", "v")
                        for bc in tree_leaves(final["opt"][part]))
            print(f"[train] {TRAIN_STEPS} coded steps in {wall_a:.1f} s (the "
                  f"checkpoint at {TRAIN_CKPT_EVERY} included): losses "
                  + ", ".join(f"{x:.4f}" for x in losses)
                  + f"; step wall median {step_med * 1e3:.1f} ms (first "
                  f"{step_s[0] * 1e3:.1f}), {TRAIN_BATCH * seq / step_med:.0f} "
                  f"tokens/s, model FLOPs {flops / 1e12:.1f} T, MFU {mfu:.4f} "
                  f"(bound {flops / BF16_FLOPS * 1e3:.1f} ms at 989 TFLOP/s); "
                  f"peak {peak / 2**30:.2f} GiB; optimizer state {coded / 1e9:.3f}"
                  f" GB coded against {8 * N / 1e9:.3f} GB f32; frsz2_compress "
                  f"{launches_a['frsz2_compress']} and frsz2_decompress "
                  f"{launches_a['frsz2_decompress']} ({2 * L} each a step, "
                  f"{2 * L} compress for the zero state)")
            t0 = mark(f"{TRAIN_STEPS} steps", t0)
            ckpt_bytes = sum(f.stat().st_size for f in (
                root / "yi" / f"step_{TRAIN_CKPT_EVERY:08d}").iterdir())

            # a fresh train() that resumes from the one checkpoint (step 3,
            # as after a crash after it), writing none
            ops.reset_launches()
            t = time.perf_counter()
            _, hist_b = train(cfg, opt, dataclasses.replace(tc, ckpt_every=0),
                              params=params0, device="cuda", verbose=False)
            wall_b = time.perf_counter() - t
        finally:
            store.save, train_mod.restore = save0, restore0
        check(sorted(restored) == [TRAIN_CKPT_EVERY]
              and _bits_equal(restored[TRAIN_CKPT_EVERY],
                              saved[TRAIN_CKPT_EVERY]),
              "the resumed run's restored params and coded moments differ "
              "from the step-3 checkpoint's snapshot")
        del restored, saved
        _expect_codec(dict(ops.LAUNCHES), 2 * L,
                      TRAIN_STEPS - TRAIN_CKPT_EVERY, 1, "the resumed run")
        check([h["step"] for h in hist_b]
              == list(range(TRAIN_CKPT_EVERY, TRAIN_STEPS)),
              f"the resumed run ran steps {[h['step'] for h in hist_b]}")
        resume_rel = max(abs(b["loss"] - a["loss"]) / abs(a["loss"])
                         for a, b in zip(hist[TRAIN_CKPT_EVERY:], hist_b))
        check(resume_rel <= TRAIN_RESUME_TOL,
              f"the resumed losses differ by {resume_rel:.3e} (relative)")
        print(f"[train] resumed from step {TRAIN_CKPT_EVERY} in a fresh "
              f"train() ({wall_b:.1f} s): losses "
              + ", ".join(f"{h['loss']:.4f}" for h in hist_b)
              + f", within {resume_rel:.2e} of the uninterrupted run's; "
              f"the params and coded moments it restored bit-equal to the "
              f"step-3 snapshot written ({ckpt_bytes / 1e9:.2f} GB a "
              f"checkpoint)")
        t0 = mark("resume", t0)
        del hist_b
        torch.cuda.empty_cache()

        # one more step with the moments held against the plain codec, and
        # its launches exactly 2 x leaves of each
        data = GlobalBatchSpec(seed=0, seq_len=seq, global_batch=TRAIN_BATCH,
                               vocab=cfg.vocab_size)
        batch = {"tokens": torch.from_numpy(
            data.global_batch_at(TRAIN_STEPS)).cuda()}
        step_fn = make_step(cfg, opt, tc)
        with _MomentTap() as tap:
            ops.reset_launches()
            params7, state7, _ = step_fn(final["params"], final["opt"], batch)
            torch.cuda.synchronize()
            step_launches = dict(ops.LAUNCHES)
        _expect_codec(step_launches, 2 * L, 1, 0, "one step")
        check(tap.n["compress"] == tap.n["decompress"] == 2 * L
              and tap.n["values"] == 2 * N,
              f"the tap saw {tap.n}, expected {2 * L} rows of each, "
              f"{2 * N} values")
        del params7, state7
        print(f"[train] one step: {2 * L} frsz2_compress and {2 * L} "
              f"frsz2_decompress launches; every m and v code and exponent "
              f"({2 * N:,} values) bit-equal to the plain compress of the "
              "same f32 moments, every decode bit-equal to the plain "
              "decompress")
        t0 = mark("moment check", t0)

        # the step under the profiler, and the update alone
        torch.cuda.empty_cache()
        prof = profile_train(cfg, opt, batch=TRAIN_BATCH, seq=seq,
                             params=final["params"], opt_state=final["opt"],
                             top=8, reps=3, warmup=False)
        emit(dict(phase="train-profile", device=device_line, **prof))
        print(f"[train] profiled step: {prof['step_wall_ms']:.1f} ms wall, "
              f"{prof['step_device_ms']:.1f} ms of device time, busy "
              f"{prof['device_busy_share']:.3f}, {prof['step_launches']} "
              f"launches, MFU {prof['mfu']:.4f}; top: "
              + "; ".join(f"{k['name'][:40]} {k['device_ms']:.1f} ms"
                          for k in prof["top"][:5])
              + f"; the AdamW update {prof['update_ms']:.2f} ms by events, "
              f"{prof['update_device_ms']:.2f} ms of device time in "
              f"{prof['update_launches']} launches, its codec kernels "
              f"{prof['update_codec_ms']:.2f} ms against their byte bound "
              f"{prof['update_codec_bound_ms']:.2f} ms "
              f"({prof['update_codec_bytes'] / 1e9:.2f} GB)")
        t0 = mark("profile", t0)

        # kernels 1 and 2 at the largest leaf and at the embedding
        kernels = _opt_kernel_entries(final["opt"], largest, "embed")
        for e in kernels.values():
            e.update(launches_per_step=2 * L)
        t0 = mark("kernel times", t0)
        del final
        torch.cuda.empty_cache()

        # the plain state on the same weights
        plain = dataclasses.replace(opt, compress_state=False)
        tcp = dataclasses.replace(tc, steps=TRAIN_PLAIN_STEPS, ckpt_every=0,
                                  ckpt_dir=str(root / "plain"))
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        plain_out = {}
        _, hist_p = train(cfg, plain, tcp, params=params0, device="cuda",
                          verbose=False, state_out=plain_out)
        check(not any(ops.LAUNCHES.values()),
              f"the plain-state run launched {ops.LAUNCHES}")
        plain_bytes = sum(t.numel() * t.element_size() for part in ("m", "v")
                          for t in tree_leaves(plain_out["opt"][part]))
        plain_peak = torch.cuda.max_memory_allocated()
        check(all(math.isfinite(h["loss"]) for h in hist_p),
              "plain-state losses")
        check(hist_p[0]["loss"] == hist[0]["loss"],
              "the plain and coded runs' first losses differ on the same "
              "weights and tokens")
        print(f"[train] plain state: {TRAIN_PLAIN_STEPS} steps, walls "
              + ", ".join(f"{h['dt'] * 1e3:.1f}" for h in hist_p)
              + f" ms; {plain_bytes / 1e9:.3f} GB of f32 moments; peak "
              f"{plain_peak / 2**30:.2f} GiB")
        del plain_out
        release()
        t0 = mark("plain state", t0)

        # remat_policy="dots" (slice 9) on the same weights and tokens:
        # the products with no batch dimension kept, the rest recomputed
        dots = _train_dots(cfg, opt, tc, params0, root, hist, peak, step_med)
        del params0
        release()
        t0 = mark("dots remat", t0)

        families = [_train_family(a, root) for a in TRAIN_FAMILIES]
        release()
        t0 = mark("families", t0)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    STEP_TIMES["train"] = dict(
        device_ms=prof["step_device_ms"], wall_ms=prof["step_wall_ms"],
        step_ms_median=step_med * 1e3, peak_coded=peak,
        peak_plain=plain_peak)
    row = dict(phase="train", arch=TRAIN_ARCH, layers=TRAIN_LAYERS,
               params=N, leaves=L, seq=seq, batch=TRAIN_BATCH, microbatch=1,
               steps=TRAIN_STEPS, losses=losses, step_s=step_s,
               step_ms_median=step_med * 1e3,
               tokens_per_s=TRAIN_BATCH * seq / step_med, model_flops=flops,
               mfu=mfu, peak_mem_bytes=peak, opt_state_bytes_coded=coded,
               opt_state_bytes_f32=8 * N, ckpt_bytes=ckpt_bytes,
               resume_wall_s=wall_b, resume_rel_err=resume_rel,
               launches={k: v for k, v in launches_a.items() if v},
               step_launches={k: v for k, v in step_launches.items() if v},
               update_ms=prof["update_ms"],
               update_device_ms=prof["update_device_ms"],
               update_codec_ms=prof["update_codec_ms"],
               update_codec_bound_ms=prof["update_codec_bound_ms"],
               plain_step_s=[h["dt"] for h in hist_p],
               plain_state_bytes=plain_bytes, plain_peak_mem_bytes=plain_peak,
               dots=dots, families=families, device=device_line)
    emit(row)
    print(f"[train] phase 13 took {time.perf_counter() - t_phase:.1f} s: "
          + "; ".join(f"{w} {t:.1f}" for w, t in marks))
    return kernels, {k: v for k, v in launches_a.items() if v}


def _train_dots(cfg, opt, tc, params0, root, hist, peak, step_med) -> dict:
    """Slice 9: ``TRAIN_DOTS_STEPS`` coded steps under ``remat_policy=
    "dots"`` on phase 13's weights and tokens, beside the full-remat run's
    first steps (``hist``, its peak and median step wall): finite losses
    within ``TRAIN_DOTS_TOL`` relative of full remat's, the step walls and
    the peak memory."""
    import dataclasses
    import statistics as stats_mod

    import torch

    from repro_torch.launch.train import train

    dcfg = dataclasses.replace(cfg, remat_policy="dots")
    tcd = dataclasses.replace(tc, steps=TRAIN_DOTS_STEPS, ckpt_every=0,
                              ckpt_dir=str(root / "dots"))
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    _, hist_d = train(dcfg, opt, tcd, params=params0, device="cuda",
                      verbose=False)
    wall = time.perf_counter() - t
    dots_peak = torch.cuda.max_memory_allocated()
    losses = [h["loss"] for h in hist_d]
    full = [h["loss"] for h in hist[:TRAIN_DOTS_STEPS]]
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses, full))
    check(len(losses) == TRAIN_DOTS_STEPS
          and all(math.isfinite(x) for x in losses) and rel <= TRAIN_DOTS_TOL,
          f"the dots-remat losses {losses} against full remat's {full}: "
          f"relative {rel:.3e}")
    step_s = [h["dt"] for h in hist_d]
    med = stats_mod.median(step_s[1:])
    print(f"[train] remat_policy=\"dots\": {TRAIN_DOTS_STEPS} coded steps "
          f"in {wall:.1f} s: losses "
          + ", ".join(f"{x:.4f}" for x in losses)
          + f", within {rel:.2e} of full remat's; step wall median "
          f"{med * 1e3:.1f} ms (full remat {step_med * 1e3:.1f} ms), "
          f"walls " + ", ".join(f"{x * 1e3:.1f}" for x in step_s)
          + f" ms; peak {dots_peak / 2**30:.2f} GiB (full remat "
          f"{peak / 2**30:.2f} GiB)")
    return dict(losses=losses, full_losses=full, rel_err=rel, step_s=step_s,
                step_ms_median=med * 1e3, peak_mem_bytes=dots_peak,
                full_peak_mem_bytes=peak, full_step_ms_median=step_med * 1e3)


#: phase 14's dry runs: (label, the dry-run CLI's arguments)
ROOF_RUNS = (
    ("decode 1x1", ["--arch", SERVE_ARCH, "--shape", "decode_32k", "--mesh",
                    "1x1", "--batch", str(SERVE_SLOTS), "--seq",
                    str(ROOF_DECODE_SEQ)]),
    ("train 1x1", ["--arch", TRAIN_ARCH, "--shape", "train_4k", "--mesh",
                   "1x1", "--batch", str(TRAIN_BATCH), "--layers",
                   str(TRAIN_LAYERS), "--microbatch", "1"]),
    ("decode 16x16 probes", ["--arch", "yi-9b", "--shape", "decode_32k",
                             "--probes"]),
    ("train 16x16 probes", ["--arch", "mixtral-8x22b", "--shape", "train_4k",
                            "--probes"]),
)


def _dry_runs(root):
    """Run :data:`ROOF_RUNS` as subprocesses, all at once -> label -> its
    JSON row; a run that fails or a row that is not ``ok`` fails."""
    import os

    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src")] + ([env["PYTHONPATH"]]
                               if env.get("PYTHONPATH") else []))
    env["CUDA_VISIBLE_DEVICES"] = ""          # the dry run needs no card
    procs = []
    for i, (label, args) in enumerate(ROOF_RUNS):
        out = root / f"run{i}.jsonl"
        log = open(root / f"run{i}.log", "w")
        procs.append((label, out, log, subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", *args,
             "--json", str(out)], cwd=ROOT, env=env, stdout=log,
            stderr=subprocess.STDOUT)))
    rows = {}
    deadline = time.perf_counter() + ROOF_DEADLINE_S
    try:
        for label, out, log, p in procs:
            rc = p.wait(timeout=max(deadline - time.perf_counter(), 1))
            log.close()
            text = (root / out.name.replace(".jsonl", ".log")).read_text()
            check(rc == 0, f"the dry run '{label}' exited {rc}:\n"
                  + text[-3000:])
            with open(out) as f:
                row = json.loads(f.read().splitlines()[-1])
            check(row.get("status") == "ok",
                  f"the dry run '{label}' gave a {row.get('status')} row: "
                  f"{row.get('error') or row}")
            rows[label] = row
    finally:
        for _, _, log, p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    return rows


def _roof_report(row):
    from repro_torch.roofline.analysis import HW_H100, RooflineReport

    return RooflineReport(
        flops=row["flops_per_dev"], bytes_hbm=row["bytes_per_dev"],
        bytes_coll=row["coll_bytes_per_dev"], coll_by_op=row["coll_by_op"],
        t_compute=row["t_compute"], t_memory=row["t_memory"],
        t_collective=row["t_collective"],
        model_flops=row["model_flops_per_dev"],
        bytes_model=row["bytes_model_per_dev"], hw=HW_H100)


def phase_roofline(device_line):
    """Slice 7e: the card's decode and training steps (phases 9 and 13) set
    against the dry run's roofline of the same cells, and the dry run on
    the fake 16x16 mesh under this machine's torch."""
    t_phase = time.perf_counter()
    root = pathlib.Path(tempfile.mkdtemp(prefix="chip_smoke_dryrun_"))
    try:
        rows = _dry_runs(root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out = {}
    for kind, label in (("decode", "decode 1x1"), ("train", "train 1x1")):
        row, meas = rows[label], STEP_TIMES[kind]
        rep = _roof_report(row)
        counted = (row["arg_gib"] + row["temp_gib"]) * 2**30
        peaks = ({"max_memory_allocated (profiled decode)": meas["peak"],
                  "max_memory_allocated (serve run)": meas["served_peak"]}
                 if kind == "decode" else
                 {"max_memory_allocated (coded run)": meas["peak_coded"],
                  "max_memory_allocated (plain run)": meas["peak_plain"]})
        r = dict(phase="roofline", step=kind, cell=label,
                 counted_flops=rep.flops, counted_bytes=rep.bytes_hbm,
                 bytes_model=rep.bytes_model,
                 model_flops=rep.model_flops,
                 t_compute_ms=rep.t_compute * 1e3,
                 t_memory_ms=rep.t_memory * 1e3,
                 t_memory_floor_ms=rep.t_memory_floor * 1e3,
                 t_bound_ms=rep.t_bound * 1e3, dominant=rep.dominant,
                 step_roofline_fraction=rep.step_roofline_fraction,
                 device_ms=meas["device_ms"], wall_ms=meas["wall_ms"],
                 device_over_bound=meas["device_ms"] / (rep.t_bound * 1e3),
                 counted_peak_bytes=counted, arg_bytes=row["arg_gib"] * 2**30,
                 temp_bytes=row["temp_gib"] * 2**30, trace_s=row["trace_s"],
                 device=device_line, **peaks)
        check(all(math.isfinite(v) and v > 0 for v in (
            rep.flops, rep.bytes_hbm, rep.bytes_model, rep.t_bound)),
            f"the {kind} cell's roofline terms: {r}")
        emit(r)
        print(f"[roofline] {kind} ({label}): counted {rep.flops:.4e} FLOPs, "
              f"{rep.bytes_hbm:.4e} bytes; bytes_model {rep.bytes_model:.4e}"
              f", model_flops_for {rep.model_flops:.4e}; t_compute "
              f"{rep.t_compute * 1e3:.3f} ms, t_memory "
              f"{rep.t_memory * 1e3:.3f} ms, t_memory_floor "
              f"{rep.t_memory_floor * 1e3:.3f} ms -> {rep.dominant}, "
              f"step_roofline_fraction {rep.step_roofline_fraction:.4f}; "
              f"device {meas['device_ms']:.2f} ms a step = "
              f"{r['device_over_bound']:.2f} x t_bound "
              f"{rep.t_bound * 1e3:.3f} ms; counted peak "
              f"{counted / 2**30:.2f} GiB (args {row['arg_gib']:.2f} + "
              f"temp {row['temp_gib']:.2f}) against "
              + ", ".join(f"{k} {v / 2**30:.2f} GiB" for k, v in peaks.items())
              + f" ({device_line})")
        out[kind] = r
    for label in ("decode 16x16 probes", "train 16x16 probes"):
        row = rows[label]
        emit(dict(phase="roofline-dryrun", cell=label, **row))
        print(f"[roofline] {row['arch']} x {row['shape']} on the fake "
              f"{row['mesh']} mesh ({row['chips']} ranks), probes in "
              f"{row['trace_s']:.1f} s: {row['flops_per_dev']:.4e} FLOPs, "
              f"{row['coll_bytes_per_dev']:.4e} collective bytes a device; "
              f"t_compute {row['t_compute'] * 1e3:.3f} ms, t_memory_floor "
              f"{row['t_memory_floor'] * 1e3:.3f} ms, t_collective "
              f"{row['t_collective'] * 1e3:.3f} ms -> {row['dominant']}, "
              f"step_roofline_fraction {row['step_roofline_fraction']}")
    print(f"[roofline] phase 14 took {time.perf_counter() - t_phase:.1f} s")
    return out


# ---------------------------------------------------------------------------
# Phase 15: the analysis gate on the card (slice 8)
# ---------------------------------------------------------------------------

#: phase 15: cycles of the fixed trajectories at the main path's m, the
#: block audits' right-hand sides, the gate's subprocess deadline (s)
GATE_K = 2
GATE_P = 8
GATE_DEADLINE_S = 600
#: the f64 audit's cycle runs these kernels (fused: the coded-operand ELL;
#: unfused: the decoded row through the dense ELL)
F64_AUDIT_KERNELS = ("frsz2_compress", "frsz2_decompress", "frsz2_matvec",
                     "frsz2_rmatvec", "ell_spmv", "ell_spmv_frsz2")
#: the block reads audit's kernels 7, 8 and 5b (the batched ELL)
BLOCK_AUDIT_KERNELS = ("frsz2_block_dots", "frsz2_block_combine", "ell_spmv")


def _gate_row(audit, fn, kernels=(), **extra):
    """Run one audit, timed, with the launches it makes: one ``{"phase":
    "analysis", ...}`` row; a finding fails the script after the row."""
    import torch

    from repro_torch.kernels import ops

    info = {}
    before = dict(ops.LAUNCHES)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    findings = fn(info)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    info.pop("calls", None)       # the census's recorded calls: not a row
    launched = {k: ops.LAUNCHES[k] - before[k] for k in before
                if ops.LAUNCHES[k] != before[k]}
    row = dict(phase="analysis", audit=audit, wall_s=wall,
               findings=[f.render() for f in findings], launches=launched,
               info=info, **extra)
    emit(row)
    print(f"[analysis] {audit}: {len(findings)} finding(s) in {wall:.2f} s")
    check(not findings, f"the gate's {audit} audit: "
          + "; ".join(row["findings"]))
    missing = [k for k in kernels if not launched.get(k)]
    check(not missing, f"the gate's {audit} audit launched no {missing}")
    return row


def phase_analysis(device_line):
    """Slice 8: the analysis gate at the main path's full width (the
    fixed-trajectory reads of the device driver in float64 and frsz2_32
    and of the p = 8 frsz2_32 block driver, CGS2 and, slice 9, MGS;
    recapture and host reads of
    both drivers; the f64 audit of an frsz2_16 cycle at f32 arithmetic; the
    census on phase 7c's NCCL group of one rank), then ``python -m
    repro_torch.analysis --check --format json`` in a subprocess, which
    must print ``[]``."""
    import os

    import numpy as np
    import torch

    from repro_torch.analysis import traceaudit, traffic
    from repro_torch.sparse import make_problem, rhs_for

    t_phase = time.perf_counter()
    A, _ = make_problem("synth:atmosmod", N_MAIN, device="cuda")
    b, _ = rhs_for(A, device="cuda")
    n = A.shape[0]
    walls = {}
    for storage in ("frsz2_32", "float64"):
        r = _gate_row(f"reads[{storage}]", lambda info, s=storage:
                      traffic.audit_reads(A, b, storage=s, m=M, k=GATE_K,
                                          info=info), n=n, m=M, k=GATE_K,
                      device=device_line)
        walls[r["audit"]] = r["wall_s"]
        release()
    r = _gate_row("block-reads[frsz2_32]", lambda info: traffic.audit_reads(
        A, b, storage="frsz2_32", m=M, k=GATE_K, p=GATE_P, info=info),
        BLOCK_AUDIT_KERNELS, n=n, m=M, k=GATE_K, p=GATE_P,
        device=device_line)
    walls[r["audit"]] = r["wall_s"]
    release()
    # slice 9: MGS, its second sweep counted at the fired slots
    r = _gate_row("reads[frsz2_32, mgs]", lambda info: traffic.audit_reads(
        A, b, storage="frsz2_32", m=M, k=GATE_K, info=info, ortho="mgs"),
        ("frsz2_matvec", "frsz2_rmatvec", "graph_if"), n=n, m=M, k=GATE_K,
        device=device_line)
    walls[r["audit"]] = r["wall_s"]
    release()
    r = _gate_row("block-reads[frsz2_32, mgs]", lambda info:
                  traffic.audit_reads(A, b, storage="frsz2_32", m=M,
                                      k=GATE_K, p=GATE_P, info=info,
                                      ortho="mgs"),
                  BLOCK_AUDIT_KERNELS + ("graph_if",), n=n, m=M, k=GATE_K,
                  p=GATE_P, device=device_line)
    walls[r["audit"]] = r["wall_s"]
    release()
    for audit, fn in (("recapture", traceaudit.audit_recapture),
                      ("host-reads", traceaudit.audit_host_reads)):
        r = _gate_row(audit, lambda info, f=fn: f(A, b, m=M, k=GATE_K,
                                                  p=GATE_P, info=info),
                      n=n, m=M, k=GATE_K, p=GATE_P, device=device_line)
        walls[audit] = r["wall_s"]
        release()
    A32, _ = make_problem("synth:atmosmod", N_MAIN, dtype=np.float32,
                          device="cuda")
    b32 = b.to(torch.float32)
    r = _gate_row("f64-leak", lambda info: traceaudit.audit_f64_leak(
        A32, b32, m=M, info=info), F64_AUDIT_KERNELS, n=n, m=M,
        device=device_line)
    walls["f64-leak"] = r["wall_s"]
    del A32, b32
    release()
    r = _gate_row("census", lambda info: traffic.census_world(
        0, "cuda", rows_A=A, halo_A=A, info=info), n=n,
        device=device_line)
    walls["census"] = r["wall_s"]
    del A, b
    release()

    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src")] + ([env["PYTHONPATH"]]
                               if env.get("PYTHONPATH") else []))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", "--check", "--format",
         "json"], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=GATE_DEADLINE_S)
    wall = time.perf_counter() - t0
    out = proc.stdout.strip()
    try:
        payload = json.loads(out[out.index("["):])
    except ValueError:
        payload = None
    emit(dict(phase="analysis", audit="python -m repro_torch.analysis "
              "--check --format json", exit=proc.returncode, wall_s=wall,
              findings=payload, device=device_line))
    print(f"[analysis] the gate's CLI exited {proc.returncode} in "
          f"{wall:.1f} s")
    check(proc.returncode == 0 and payload == [],
          f"the gate's CLI exited {proc.returncode} with {out[-3000:]!r}; "
          f"stderr {proc.stderr[-3000:]!r}")
    walls["cli"] = wall
    print(f"[analysis] phase 15 took {time.perf_counter() - t_phase:.1f} s: "
          + ", ".join(f"{k} {v:.1f} s" for k, v in walls.items()))


def _coded_launch_check(row, coded: bool, what):
    """A device solve on an FRSZ2 basis (``coded``) launches kernels 1, 3, 4
    and 6 (and the rest of the device path); on a native one no FRSZ2
    kernel."""
    lc = row["launches"]
    if coded:
        _check_launches(row, DEVICE_PATH, what)
    else:
        check(lc["ell_spmv"] > 0 and lc["gmres_givens"] > 0,
              f"{what}: the device path skipped a kernel: {lc}")
        check(not any(v for k, v in lc.items()
                      if k.startswith("frsz2_") or k == "ell_spmv_frsz2"),
              f"{what}: a native basis launched an FRSZ2 kernel: {lc}")


def _phase_quickstart(walls):
    """16a: the quickstart's two functions on the card beside the CPU, then
    ``pipeline_demo(DEMO_N, "cuda")``."""
    import numpy as np
    import torch

    from repro_torch.core import FRSZ2_16, FrszSpec, compress
    from repro_torch.examples import quickstart, solve_cfd
    from repro_torch.sparse.problems import PROBLEMS

    t0 = time.perf_counter()
    card, cpu = quickstart.codec_demo("cuda"), quickstart.codec_demo("cpu")
    check(card == cpu, f"quickstart's codec lines differ: card {card}, "
                       f"CPU {cpu}")
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal(4096).astype(np.float32))
    x64 = torch.from_numpy(rng.standard_normal(4096))
    for v, spec in ((x, FRSZ2_16),
                    (x64, FrszSpec(bs=32, l=32, dtype=torch.float64))):
        bg, bc = compress(v.cuda(), spec), compress(v, spec)
        check(torch.equal(bg.codes.cpu(), bc.codes)
              and torch.equal(bg.exps.cpu(), bc.exps),
              f"quickstart's {spec.name} codes differ on the card")
    for line in card:
        print(f"[options] quickstart (card = CPU, codes bit-equal): {line}")
    target = PROBLEMS["synth:atmosmod"][1]
    lines_card, res_card = quickstart.solve_demo("cuda")
    lines_cpu, res_cpu = quickstart.solve_demo("cpu")
    for fmt in quickstart.FORMATS:
        g, c = res_card[fmt], res_cpu[fmt]
        check(g.converged and g.rrn <= target,
              f"quickstart {fmt} on the card: rrn {g.rrn:.3e}, converged "
              f"{g.converged}")
        check(abs(g.iterations - c.iterations) <= 1,
              f"quickstart {fmt}: {g.iterations} iterations on the card, "
              f"{c.iterations} on the CPU")
    for a, b in zip(lines_card[1:-1], lines_cpu[1:-1]):
        print(f"[options] quickstart card: {a.strip()} | CPU: {b.strip()}")
    emit(dict(phase="options-quickstart",
              card={f: [r.iterations, r.rrn] for f, r in res_card.items()},
              cpu={f: [r.iterations, r.rrn] for f, r in res_cpu.items()}))
    walls["16a quickstart"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    lines, res = solve_cfd.pipeline_demo(DEMO_N, "cuda")
    for line in lines:
        print(f"[options] pipeline_demo({DEMO_N}): {line}")
    check(all(r.converged for r in res.values()),
          f"pipeline_demo: not every solve converged: "
          f"{ {k: r.rrn for k, r in res.items()} }")
    check(res["jacobi"].iterations < res["identity"].iterations,
          "pipeline_demo: Jacobi took no fewer iterations than the identity")
    check(res["adaptive"].bytes_read < res["static"].bytes_read,
          "pipeline_demo: the adaptive policy read no fewer bytes than "
          "static frsz2_32")
    emit(dict(phase="options-pipeline-demo", n=DEMO_N,
              **{k: dict(iters=r.iterations, restarts=r.restarts, rrn=r.rrn,
                         bytes_read=r.bytes_read) for k, r in res.items()}))
    walls["16a pipeline_demo"] = time.perf_counter() - t0


def _phase_grid(walls):
    """16b: the paper's grid on the card; returns the rows."""
    import torch

    from repro_torch.core.accessor import format_by_name
    from repro_torch.kernels import ell_spmv as KE
    from repro_torch.sparse import make_problem, rhs_for
    from repro_torch.sparse.problems import PROBLEMS

    t0 = time.perf_counter()
    table = []
    for name in PROBLEMS:
        A, target = make_problem(name, GRID_N, device="cuda")
        b, x_sol = rhs_for(A, device="cuda")
        w = A._ell().vals.shape[1]
        iters = {}
        for fmt in GRID_FORMATS:
            what = f"grid {name} {fmt}"
            kw = dict(m=GRID_M)     # the reference's restart length
            d1, rd1 = _solve_row("grid-capture", A, b, x_sol, fmt, target,
                                 GRID_MAX_ITERS, "device", **kw)
            d2, rd2 = _solve_row("grid", A, b, x_sol, fmt, target,
                                 GRID_MAX_ITERS, "device", **kw)
            h, rh = _solve_row("grid", A, b, x_sol, fmt, target,
                               GRID_MAX_ITERS, "host", **kw)
            check(d1.converged and d2.converged and h.converged,
                  f"{what} did not converge: rrn {d1.rrn:.3e}, "
                  f"stagnated {d1.stagnated}")
            _check_drivers_agree(d1, h, rd1, rh, what)
            check(d1.iterations == d2.iterations and torch.equal(d1.x, d2.x),
                  f"{what}: two device solves differ")
            _coded_launch_check(rd2, fmt.startswith("frsz2_"), what)
            row = dict(problem=name, n=A.shape[0], w=w, format=fmt,
                       iters=d2.iterations, restarts=d2.restarts, rrn=d2.rrn,
                       converged=d2.converged, wall_s=rd2["wall_s"],
                       host_wall_s=rh["wall_s"])
            if fmt.startswith("frsz2_"):
                p, rp = _solve_row("grid-plain", A, b, x_sol,
                                   format_by_name(fmt, use_kernels=False),
                                   target, GRID_MAX_ITERS, "host", **kw)
                drift = GRID_DRIFT.get(name, 1)
                check(p.converged
                      and abs(p.iterations - d2.iterations) <= drift,
                      f"{what}: kernel route {d2.iterations} iterations, "
                      f"plain route {p.iterations} (converged "
                      f"{p.converged}), more than {drift} apart")
                check(not any(v for k, v in rp["launches"].items()
                              if k.startswith("frsz2_")
                              or k == "ell_spmv_frsz2"),
                      f"{what}: the plain route launched FRSZ2 kernels")
                row["plain_iters"] = p.iterations
            iters[fmt] = d2.iterations
            table.append(row)
        if KE.body(w) == "row":
            print(f"[options] {name}: ELL width {w}, every solve's SpMV on "
                  f"the row kernel (ell_row_kernel, "
                  f"{rd2['launches']['ell_spmv']} ell_spmv and "
                  f"{rd2['launches']['ell_spmv_frsz2']} ell_spmv_frsz2 "
                  "launches in its frsz2_16 device solve)")
        print(f"[options] {name}: frsz2_32 {iters['frsz2_32']} <= float32 "
              f"{iters['float32']} iterations (the paper's headline check, "
              f"not gated): {iters['frsz2_32'] <= iters['float32']}")
        del A, b, x_sol, d1, d2, h
        release()
    print("[options] the paper's grid on the card, n = 8000, m = 50: "
          "iterations / restarts / final rrn / converged / device wall s")
    for row in table:
        print(f"[options]   {row['problem']:20s} {row['format']:9s} "
              f"{row['iters']:5d} {row['restarts']:3d} {row['rrn']:.3e} "
              f"{row['converged']} {row['wall_s']:.4f}")
    emit(dict(phase="options-grid", rows=table))
    walls["16b grid"] = time.perf_counter() - t0
    return table


def _full_launch_check(label, row, cycles):
    """A full-width option's device launches match its format(s); for the
    adaptive policy, each level's captured cycle matches its own."""
    lc = row["launches"]
    if label in ("float32", "float16"):
        _coded_launch_check(row, False, f"full-width {label}")
    elif label == "frsz2_32+cgs2":
        path = tuple(k for k in DEVICE_PATH if k != "graph_if")
        _check_launches(row, path, "full-width frsz2_32 CGS2")
        check(lc["graph_if"] == 0, f"CGS2 launched an IF node: {lc}")
    elif label == "jacobi":
        # the preconditioned operator reads each row decoded (kernel 2)
        _check_launches(row, ("frsz2_compress", "frsz2_decompress",
                              "frsz2_matvec", "frsz2_rmatvec", "ell_spmv",
                              "gmres_givens", "graph_if"),
                        "full-width frsz2_32 Jacobi")
        check(lc["ell_spmv_frsz2"] == 0, f"Jacobi fused the operand: {lc}")
    elif label.startswith("adaptive"):
        # the coded path where a level past float64 ran
        _coded_launch_check(row, any("frsz2" in c.acc.fmt.name
                                     for c in cycles), f"full-width {label}")
    else:
        _check_launches(row, DEVICE_PATH, f"full-width {label}")
    for cyc in cycles:
        fmt = cyc.acc.fmt.name
        coded = any(cyc.launches.get(k) for k in (
            "frsz2_compress", "frsz2_matvec", "frsz2_rmatvec",
            "ell_spmv_frsz2"))
        check(coded == ("frsz2" in fmt),
              f"full-width {label}: the {fmt} level's cycle launches "
              f"{cyc.launches}")


def _policy_levels(res, target):
    """The adaptive policy's level at each cycle ``res`` ran."""
    import torch

    from repro_torch.solver.pipeline import resolve_policy

    policy = resolve_policy("adaptive", None, torch.float64, target, M)
    return [policy.level(float(rr), i)
            for i, rr in enumerate(res.restart_rrns[:len(res.fired)])]


def _full_option(label, A, b, x_sol, target, fmt, kw):
    """One option at full width: the device driver twice (capture, then
    replay: no new graph) and the host driver, bit-equal; the launches of
    its path and of each captured level's cycle.  Returns the replay's row
    and the graphs its capture made."""
    import torch

    from repro_torch.solver.gmres import _GRAPHS

    keys = set(_GRAPHS)
    d1, rd1 = _solve_row("options-full-capture", A, b, x_sol, fmt, target,
                         FULL_MAX_ITERS, "device", **kw)
    new = [_GRAPHS[k] for k in _GRAPHS if k not in keys]
    keys = set(_GRAPHS)
    d2, rd2 = _solve_row("options-full", A, b, x_sol, fmt, target,
                         FULL_MAX_ITERS, "device", **kw)
    check(set(_GRAPHS) == keys,
          f"full-width {label}: the second solve captured a graph")
    h, rh = _solve_row("options-full", A, b, x_sol, fmt, target,
                       FULL_MAX_ITERS, "host", **kw)
    for res in (d1, d2, h):
        check(res.converged, f"full-width {label}: not converged within "
              f"{FULL_MAX_ITERS} iterations (rrn {res.rrn:.3e}, stagnated "
              f"{res.stagnated})")
    rel = _check_drivers_agree(d2, h, rd2, rh, f"full-width {label}")
    check(torch.equal(d1.x, d2.x) and torch.equal(d2.x, h.x),
          f"full-width {label}: the device solves and the host solve are "
          "not bit-equal")
    _full_launch_check(label, rd2, new)
    levels = (sorted(set(_policy_levels(d2, target))) if "policy" in kw
              else [0])
    check(len(new) == len(levels),
          f"full-width {label}: {len(new)} graphs captured for the levels "
          f"{levels}")
    graphs = [c.acc.fmt.name for c in new]
    it = max(d2.iterations, 1)
    emit(dict(phase="options-full-summary", option=label, graphs=graphs,
              levels=levels, x_rel_host=rel, stagnated=d2.stagnated,
              capture_wall_s=rd1["wall_s"], host_wall_s=rh["wall_s"]))
    print(f"[options] full width {label}: device {d2.iterations} it = host "
          f"{h.iterations} it ({d2.restarts} restarts, rrn {d2.rrn:.3e}, "
          f"converged {d2.converged}), bit-equal; graphs {graphs}; wall "
          f"{rd2['wall_s']:.4f} s, {rd2['wall_per_iter_ms']:.4f} ms/it (host"
          f" {rh['wall_per_iter_ms']:.4f}, capture {rd1['wall_s']:.2f} s), "
          f"{d2.bytes_read / it / 1e6:.1f} MB read/it, peak "
          f"{rd1['peak_mem_bytes'] / 2**30:.2f} GiB; launches "
          + ", ".join(f"{k} {v}" for k, v in rd2["launches"].items() if v))
    return rd2


def _phase_options_full(walls, full_rows):
    """16c: the options at full width; returns the frsz2_16 replay's
    launches (rows 3h and 4h)."""
    from repro_torch.sparse import make_problem, rhs_for

    t0 = time.perf_counter()
    A, target = make_problem("synth:atmosmod", N_MAIN, device="cuda")
    b, x_sol = rhs_for(A, device="cuda")
    rows = {}
    for label, fmt, kw in FULL_OPTIONS:
        rows[label] = _full_option(label, A, b, x_sol, target, fmt, kw)
        release()
    del A, b, x_sol
    A, target = make_problem("synth:varcoef", N_MAIN, device="cuda")
    b, x_sol = rhs_for(A, device="cuda")
    rows["jacobi"] = _full_option("jacobi", A, b, x_sol, target, "frsz2_32",
                                  dict(precond="jacobi"))
    del A, b, x_sol
    release()
    for fmt, row in full_rows.items():
        print(f"[options] beside phase 5's {fmt}: {row['iters']} it, wall "
              f"{row['wall_s']:.4f} s, {row['wall_per_iter_ms']:.4f} ms/it, "
              f"{row['bytes_read'] / max(row['iters'], 1) / 1e6:.1f} MB "
              f"read/it, peak {row['peak_mem_bytes'] / 2**30:.2f} GiB")
    walls["16c full width"] = time.perf_counter() - t0
    return dict(rows["frsz2_16"]["launches"])


def _phase_l16_kernels(walls):
    """16d: kernels 3 and 4 at the frsz2_16 solver spec (bs 32, l 16, f64
    values), 101 rows of a main-path row, timed as phase 3 times them."""
    import torch

    from repro_torch.core import frsz2 as F
    from repro_torch.kernels import ops

    t0 = time.perf_counter()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1616)
    n = round(N_MAIN ** (1 / 3)) ** 3
    spec = F.FrszSpec(bs=32, l=16, dtype=torch.float64)
    V = torch.randn((R_FULL, n), generator=gen, dtype=torch.float64,
                    device=dev)
    V /= torch.linalg.vector_norm(V, dim=1, keepdim=True)
    w = torch.randn((n,), generator=gen, dtype=torch.float64, device=dev)
    h = torch.randn((R_FULL,), generator=gen, dtype=torch.float64, device=dev)
    bc, Vdec, _, _ = _codec_pair(V, spec)
    del V
    dot_src = "src/repro_torch/kernels/csrc/frsz2_dot.cu"
    nbytes = (R_FULL * (bc.codes[0].numel() * 2 + bc.exps[0].numel() * 4)
              + n * 8 + R_FULL * 8)
    entries = {}
    for row, op, fn, vec, lib, replaces in (
            ("3h", "matvec", ops.matvec, w, lambda: torch.mv(Vdec, w),
             "src/repro/kernels/frsz2_dot.py:77"),
            ("4h", "rmatvec", ops.rmatvec, h, lambda: torch.mv(Vdec.t(), h),
             "src/repro/kernels/frsz2_dot.py:114")):
        abs_err, rel, _ = _contraction_err(bc, vec, op, R_FULL)
        check(rel <= 1e-12, f"{op} at l 16: relative error {rel:.3e}")
        entries[f"frsz2_{op}_l16"] = entry(
            f"frsz2_{op}_l16", dot_src, replaces,
            timed(lambda fn=fn, vec=vec: fn(bc, vec, kernel=True)),
            timed(lambda fn=fn, vec=vec: fn(bc, vec, kernel=False)),
            nbytes, 2.0 * R_FULL * n, abs_err, library_ms=timed(lib),
            rows=R_FULL, shape=f"{R_FULL} x {n}, bs 32, l 16, f64",
            library="torch.mv on the decoded f64 basis", row=row,
            kernel=f"frsz2_{op}", path="options")
    del bc, Vdec
    release()
    walls["16d kernels at l 16"] = time.perf_counter() - t0
    return entries


def _phase_block_float32(walls):
    """16e: a float32 block basis at full width (atmosmodd, p = P_BLOCK,
    m = M, phase 7's frsz2_32 block solve's settings otherwise): the block
    device driver (capture, then replay) bit-equal to the block host
    driver, within the card's memory (its contractions convert the live
    block rows in chunks of a fixed size), launching no FRSZ2 kernel."""
    import torch

    from repro_torch.launch.solve import _batch_rhs
    from repro_torch.sparse import make_problem, rhs_for

    t0 = time.perf_counter()
    A, target = make_problem("synth:atmosmod", N_MAIN, device="cuda")
    b, x_sol = rhs_for(A, device="cuda")
    B = _batch_rhs(b, P_BLOCK)
    what = "full-width float32 block"
    _, Xd1, rd1 = _block_row("options-block-capture", A, B, x_sol, "float32",
                             target, FULL_MAX_ITERS, "block", "device")
    _, Xd2, rd2 = _block_row("options-block", A, B, x_sol, "float32", target,
                             FULL_MAX_ITERS, "block", "device")
    _, Xh, rh = _block_row("options-block", A, B, x_sol, "float32", target,
                           FULL_MAX_ITERS, "block", "host")
    for r in (rd1, rd2, rh):
        check(r["converged"], f"{what} {r['driver']}: a column did not "
                              "converge")
    _check_block_drivers(Xd1, Xh, rd1, rh, what)
    _check_block_drivers(Xd2, Xh, rd2, rh, f"{what} replay")
    lc = rd2["launches"]
    check(lc["ell_spmv"] > 0 and lc["gmres_block_givens"] > 0
          and not any(v for k, v in lc.items()
                      if k.startswith("frsz2_") or k == "ell_spmv_frsz2"),
          f"{what}: launches {lc}")
    print(f"[options] {what} (p = {P_BLOCK}, m = {M}): device = host, "
          f"iterations {rd2['iters']}, restarts {rd2['restarts'][0]}, rrn "
          f"max {rd2['rrn_max']:.3e}; walls capture {rd1['wall_s']:.3f} s, "
          f"replay {rd2['wall_s']:.3f} s, host {rh['wall_s']:.3f} s; "
          f"max_memory_allocated capture "
          f"{rd1['peak_mem_bytes'] / 2**30:.2f} GiB, replay "
          f"{rd2['peak_mem_bytes'] / 2**30:.2f} GiB, host "
          f"{rh['peak_mem_bytes'] / 2**30:.2f} GiB")
    del A, b, x_sol, B, Xd1, Xd2, Xh
    release()
    walls["16e float32 block"] = time.perf_counter() - t0


def phase_options(device_line, full_rows):
    """Slice 11: the solver's storage formats and pipeline options on the
    card (16a-16e); returns rows 3h and 4h and their launches."""
    t_phase = time.perf_counter()
    walls = {}
    _phase_quickstart(walls)
    release()
    _phase_grid(walls)
    l16 = _phase_options_full(walls, full_rows)
    _phase_block_float32(walls)
    entries = _phase_l16_kernels(walls)
    emit(dict(phase="options", walls=walls, device=device_line))
    print(f"[options] phase 16 took {time.perf_counter() - t_phase:.1f} s: "
          + ", ".join(f"{k} {v:.1f} s" for k, v in walls.items()))
    return entries, l16


def _cast(tree, dtype):
    """A copy of a weight tree with every floating tensor in ``dtype``."""
    return {k: _cast(v, dtype) if isinstance(v, dict)
            else v.to(dtype) if v.is_floating_point() else v
            for k, v in tree.items()}


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def main(run=None) -> int:
    """The full run (:func:`_run`), or ``run`` in its place after the same
    set-up."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401  (fails outside a checkout of the repo)

    import torch.distributed as dist

    from repro_torch.dist import init_rank

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t_start = time.perf_counter()
    phase_build()
    device_line = phase_device()
    # phase 7c's group: this process, one rank on cuda:0, NCCL initialized
    # eagerly so that a captured cycle can hold its collectives
    rdv = tempfile.mkdtemp(prefix="chip_smoke_rdv_")
    init_rank(0, 1, "file://" + str(pathlib.Path(rdv) / "rendezvous"))
    try:
        return (run or _run)(t_start, device_line)
    finally:
        dist.destroy_process_group()
        shutil.rmtree(rdv, ignore_errors=True)


def _run(t_start, device_line) -> int:
    import torch

    from repro_torch.sparse import make_problem

    t0 = time.perf_counter()
    A, target = make_problem("synth:atmosmod", N_MAIN, device="cuda")
    torch.cuda.synchronize()
    print(f"[setup] n={A.shape[0]} nnz={A.nnz} in "
          f"{time.perf_counter() - t0:.1f} s")
    entries = phase_kernels()
    entries.update(phase_ell(A))
    entries.update(phase_givens())
    entries.update(phase_graph_if())
    phase_solve()
    phase_cycle_profiles(device_line)
    launches, paths, unsharded = phase_full_width(A, target)
    release()
    entries.update(phase_block_kernels(A))
    release()
    phase_block_solve()
    release()
    block_launches, block_unsharded = phase_block_full_width(A, target)
    release()
    sharded_entries, sharded_launches, mixed_ref = phase_sharded(
        A, target, unsharded, block_unsharded)
    entries.update(sharded_entries)
    release()
    phase_sharded_multi(target, unsharded, block_unsharded, mixed_ref)
    full_rows = {fmt: row for fmt, (_, row) in unsharded.items()}
    del A, unsharded, block_unsharded
    release()
    phase_plan(entries)
    release()
    entries.update(phase_decode_attn())
    release()
    serve_launches, writes = phase_serve(device_line)
    release()
    ring_attn, ring_write = phase_moe(device_line)
    entries["decode_attn"].update(ring_attn)
    release()
    hd112_attn, hd112_write = phase_ssm(device_line)
    entries["decode_attn"].update(hd112_attn)
    release()
    cross_attn, cross_write = phase_cross(device_line)
    entries["decode_attn"].update(cross_attn)
    release()
    train_entries, train_launches = phase_train(device_line)
    entries.update(train_entries)
    release()
    phase_roofline(device_line)
    release()
    phase_analysis(device_line)
    release()
    options_entries, options_launches = phase_options(device_line, full_rows)
    entries.update(options_entries)
    # kernel 1 as the serving cache writes with it, counted in the prefill
    # and in the decode steps of the frsz2_16 run; timed at the prefill's
    # shape, where the kernel does work worth timing, a decode step's (at
    # the CUDA events' floor, ``floor_ms``) beside it
    entries["frsz2_cache_write"] = entry(
        "frsz2_cache_write", "src/repro_torch/kernels/csrc/frsz2_codec.cu",
        "src/repro/kernels/frsz2_kernel.py:113", writes["prefill_kernel_ms"],
        writes["prefill_plain_ms"], writes["prefill_bytes"], 0.0, 0.0,
        path="serve",
        shape=f"K and V {writes['prefill_shape']} bf16, bs 128, l 16",
        err_unit="code", **writes,
        serve_step_launches=serve_launches["frsz2_cache_write_step"],
        serve_prefill_launches=serve_launches["frsz2_cache_write_prefill"],
        **ring_write, **hd112_write, **cross_write)
    entries["frsz2_compress"]["serve_launches"] = serve_launches[
        "frsz2_compress"]
    for name, e in entries.items():
        key = e.get("kernel", name)
        if e.get("path") == "block":
            e["launches"] = block_launches[key]
        elif e.get("path") == "sharded":
            e["launches"] = sharded_launches[key]
        elif e.get("path") == "serve":
            e["launches"] = serve_launches[key]
        elif e.get("path") == "train":
            e["launches"] = train_launches[key]
        elif e.get("path") == "options":
            e["launches"] = options_launches[key]
        else:
            e["launches"] = launches[key]
            e["path"] = paths[key]
    print(f"[done] {time.perf_counter() - t_start:.1f} s")
    emit({"kernels": list(entries.values())})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


def _multi_card(t_start, device_line) -> int:
    """``python3 chip_smoke.py --multi-card``: phase 7c's multi-card run
    (:func:`phase_sharded_multi`, one rank a card) after the phases that
    make the unsharded solves it is held to, run as the full run runs them:
    5 (:func:`phase_full_width`), 7 (:func:`phase_block_full_width`) and
    7c (:func:`phase_sharded`, on one rank)."""
    import torch

    from repro_torch.sparse import make_problem

    A, target = make_problem("synth:atmosmod", N_MAIN, device="cuda")
    torch.cuda.synchronize()
    _, _, unsharded = phase_full_width(A, target)
    release()
    _, block_unsharded = phase_block_full_width(A, target)
    release()
    _, _, mixed_ref = phase_sharded(A, target, unsharded, block_unsharded)
    release()
    phase_sharded_multi(target, unsharded, block_unsharded, mixed_ref)
    print(f"[done] {time.perf_counter() - t_start:.1f} s")
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--one-cycle-profiles"]:
        sys.exit(_cycle_profiles_child(sys.argv[2]))
    if sys.argv[1:2] == ["--multi-card"]:
        sys.exit(main(_multi_card))
    sys.exit(main())
