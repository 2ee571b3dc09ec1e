#!/usr/bin/env python3
"""On-card check of the PyTorch/CUDA port (``markovmodels_tpu_torch``).

Drives the port's main paths at B=128 sequences × N=700 frames: first the
LF-MMI training step, ``lfmmi_loss`` of 128 stacked 'banded' numerator lattices
(78 states each, the shape ``bench.py`` builds) against the 2M-arc
trigram-LM ∘ HMM denominator (49,153 states, 2,195,457 arcs, 384 pdfs),
with the gradient in the log-likelihoods, through the hand-written CUDA
kernels K2-K4 of ``markovmodels_tpu_torch/ops/csrc/block_scan.cu`` (the
denominator) and K5a/K5b of ``.../csrc/banded_scan.cu`` (the numerators);
then the same step against a 'dense' denominator (the V=32 LM ∘ HMM graph:
3,073 states, 38,913 arcs, 96 pdfs, within 6 % of the WSJ denominator's
padded width) through K6a/K6b of ``.../csrc/dense_scan.cu``; then the
Viterbi decode of the 2M-arc graph through K7 and the backtrace walk of
``.../csrc/vit_scan.cu`` (and, last, the chunk-recompute decode of a
'dense' graph and of the 2M-arc graph past the id budget, phases 31-33,
and the separate-state graph's decode through the family branch of K7
and K7n, phases 34-37);
then the training step against the separate-state
backoff LM ∘ HMM denominator (V=128, 10 % of the trigrams kept: 49,537
states, 339,895 arcs, 384 pdfs), which ``compile_fsm``'s default lowers to
the capped/overflow layout, through the overflow branch of K2-K4, in
phases:

1. the card's name and power limit (nvidia-smi);
2. build the kernels from the sources in the checkout (nvcc, sm_90a);
3. build the graph and compile it onto the card (strategy 'block',
   precision 'high');
4. each kernel against its plain PyTorch twin on the same inputs, at the
   main-path graph with B=128 and N=128 (a mid-sequence chunk boundary,
   mixed lengths, ±30-nat emission cliffs), K2, K3 and K4 run twice:
   bit-equal;
5. ``pdfposteriors`` at B=2, N=40 against the exact float64 host oracle
   (the port's ``oracle.host_oracle``): |ΔlogZ| and |Δposts| ≤ 1e-4;
6. the denominator ``pdfposteriors`` at B=128, N=700 with launch counters,
   output checks, and the kernel path timed beside the plain PyTorch scan;
7. K5a and K5b against their plain twins at the numerators' main shape
   (G=128 lattices, Sp=80, N=700; ragged lengths with infeasible ones and
   a length of 1, ±30-nat emission cliffs), each run twice and bit-equal,
   K5b's posteriors outside each graph's plan exactly 0, and the
   admission's shared-memory figures equal to the kernels' own;
8. stacked-numerator ``pdfposteriors`` against the f64 oracle: 4 chain
   lattices at N=40, then 4 with skip arcs (three band offsets, up to 130
   states) at N=150, where K5a and K5b are held to their twins too;
8b. stacked numerators past the narrow K5's 1,024 states, the route line
    printed: 4 skip-arc lattices of ~1,200 states (K5's wide
    instantiation) at N=700, then 4 of ~3,000 (its cluster one, one CTA a
    graph) at N=2,400, through ``pdfposteriors`` and ``lfmmi_loss`` with
    the 2M-arc denominator against the f64 oracle and γ_den - γ_num, the
    admission's instantiations, cluster sizes and shared memory against
    the kernels' (and the clusters the card holds at once); a G=128 stack
    of each: K5a and K5b each run twice (bit-equal) and against their
    twins, through the training step (one launch each, the gradient
    against γ_den - γ_num) timed beside phase 9's, and timed; a G=128
    stack of ~1,350-state lattices at N=700 (the cluster one just past
    the wide one; they do not reach their end in 700 frames, so their
    posteriors are 0) held to the twins and timed, its frame beside the
    wide stack's; then a G=128 stack at Sp = 24,576 with three offsets (the
    JAX package's fused bound; clusters of 4 and 8 CTAs) at N=128 through
    ``pdfposteriors`` (one launch each), held to the twins and timed (its
    long lattice cannot reach its end, so its CTAs past rank 0 carry
    zeros); a G=8 stack at Sp = 6,504 and N=6,000 in float32 and in
    float64 (clusters of 2 and 3 CTAs, every lattice feasible, alpha and
    gamma mass asserted in every CTA's range), held to the twins and
    timed; and a G=4 stack of 52,008 states past what 8 CTAs hold (the
    global instantiation) at N=64, held to the twins (run after phase 9);
    every K5 stack within 1e-4 absolute and 1e-12 relative of the float64
    twins;
8c. a barely feasible narrow lattice (784 states, N=394, about its
    shortest path) whose frames' γ sums are subnormal: the narrow K5b,
    which divides there, against its twin, its posteriors finite;
9. the training step at B=128, N=700 with launch counters (K2-K5b), the
   gradient against γ_den - γ_num, and its time beside the denominator's;
   a ``torch.profiler`` breakdown of one step (K5a's and K5b's device
   time and share) and of one den-only ``pdfposteriors``:
   exactly one K2 launch and one K3 and one K4 launch per 64-frame chunk
   (the persistent ``fwd_chunk_kernel`` and ``bwd_chunk_kernel``) and no
   per-frame step or finalize launch; K2 over the N=700 sweep, K3 and K4
   over its last chunk, each split into its parts (the whole operator, no
   tier, no bands or families, neither: the frame without work);
10. the V=32 graph compiled with the default strategy ('auto' -> 'dense',
    precision 'high');
11. K6a and K6b against their plain twins at B=128, N=700, Sp=3,200 (mixed
    lengths with 1 and N, ±30-nat emission cliffs), each run twice and
    bit-equal; then on a random fully dense operator at Sp=4,096, whose
    tiles do not fit shared memory and stream every frame: whole sweeps
    in float32 at N=128, and the bf16 kernels one frame at a time;
12. dense ``pdfposteriors`` at B=2, N=40 against the f64 oracle;
13. phase 7's checks and the K5 timings on the dense step's numerators
    (P=96); the training step with the dense denominator and 128 stacked
    numerators at B=128, N=700: exactly one launch each of K5a, K5b, K6a and
    K6b and no other kernel, the gradient against γ_den - γ_num, its time
    beside the denominator's, and a ``torch.profiler`` breakdown (one
    sweep launch per direction, no finalize launch); then K6a/K6b timed
    beside ``torch.matmul`` and ``torch.sparse.mm`` of their product, the
    bounds, and a frame without the product (an all-zero operator);
14. four stacked non-banded 'dense' graphs (B = G = 4) through the
    per-graph route on the card against the f64 oracle;
15. K7 and the walk against their plain twins at the 2M-arc graph, B=128
    and B=126 (the kernel's scalar branch), N=128 (mixed lengths with 1 and
    N, ±30-nat cliffs): ids and omega argmaxes bit-equal, scores within
    1e-5;
16. ``viterbi`` at B=2, N=40 against the f64 max-plus optimum
    (``oracle.host_viterbi_score``): |Δscore| ≤ 1e-3, the decoded paths'
    f64 weight within 1e-4 of it;
17. the decode at B=128, N=700 with launch counters (exactly one K7 and one
    walk launch, by the counters and by the profiler's kernel count), every
    path walked in float64 (``oracle.validate_paths``, gap < 2e-3), the
    sweep and the walk timed apart, audio-s/s, a ``torch.profiler``
    breakdown, the decode's parts apart (admissions, emission prep, sweep,
    score, walk, the ``orig_state`` gather), K7's frame split (whole, no
    tier, no bands, neither), and the plain twins timed beside them and
    held to the kernels at this shape (ids, omega argmaxes and walked
    states bit-equal, scores within 1e-5);
18. the separate-state graph compiled with the default arguments onto the
    card ('block', ``ov_layout`` (128, 3)) and its fast-path report;
19. K2, K3 and K4 against their plain twins on it at B=128, N=128 (lengths
    1 and N mixed, ±30-nat cliffs), each run twice: bit-equal;
20. its ``pdfposteriors`` at B=2, N=40 against the f64 oracle;
21. the training step with it and the 128 stacked numerators at B=128,
    N=700: exact launch counts (K2 1, K3 and K4 once per chunk, K5a 1,
    K5b 1, no other kernel), the gradient against γ_den - γ_num, its time
    beside den-only ``pdfposteriors`` and beside the embedded layout's
    den-only ``pdfposteriors`` (the same LM with its backoff states on the
    diagonal of the trigram rows), and the separate/embedded ratio
    (printed; ``bench.py`` holds the JAX package's under 1.2); the
    den-only profile and the frame splits of phase 9 on this graph;

then ``precision='bf16'`` (``BASELINE.json`` config 4, the mixed-precision
scan): the tier of K2-K4 and the product of K6a/K6b on bf16 operands on
the tensor cores, float32 everywhere else:

22. the 2M-arc, separate-state and V=32 graphs compiled with
    ``precision='bf16'``; their fast-path reports;
23. the bf16 K2, K3 and K4 against their plain twins (which round the same
    operands), on the 2M-arc graph and on the separate-state graph (the
    overflow branch), with the bf16 launch counters: one frame at a time
    from the same state, where both round the same values (1e-4), then
    over whole sweeps at B=128, N=128, where each rounds its own float32
    state (TOL_KERNEL_BF16; K2-K4 twice, bit-equal, on both graphs);
24. the bf16 K6a and K6b likewise, the sweeps at B=128, N=128 and N=700;
25. ``pdfposteriors`` at B=2, N=700 (lengths N and 2N/3, ``bench.py``'s
    shape) against the f64 oracle, run once per graph for its 'high' and
    its bf16 compile: 'high' within 1e-3 in logZ and 1e-4 in the
    posteriors (``bench.py:380-392``), bf16 within 2e-3 / 1e-3 on the
    'block' graphs (``bench.py:507-525``) and 2e-2 / 5e-3 on the 'dense'
    one; every reading printed beside the 1e-4 contract;
26. the training step with the bf16 2M-arc denominator at B=128, N=700:
    only bf16 K2-K4 launched (and K5a/K5b), the gradient against
    γ_den - γ_num;
27. the same with the bf16 separate-state denominator, and 28. with the
    bf16 dense one (K6a/K6b, exact counts and profiled as in 13);
29. the step and den-only ``pdfposteriors``, bf16 beside f32, medians of 5
    warm runs in turns, and their ratios (printed: ``bench.py`` requires
    bf16 < f32 of the JAX package; here a slow kernel stays and is
    written down), a ``torch.profiler`` breakdown of the bf16 den-only
    runs (on the block graphs with phase 9's launch checks); then each bf16
    kernel and its twin timed and held to it at N=700, the frame splits on both
    bf16 block graphs, and the bf16 ``torch.mm`` yardstick of K6;
30. Viterbi of the bf16 2M-arc graph: K7's ids, ω argmaxes and scores
    bit-equal to the 'high' graph's at B=128, N=128 (K7 takes float32
    panels on any graph);

then the chunk-recompute Viterbi decode ('dense' graphs and 'block' graphs
past the uint8 id budget) through K6t (the tropical instantiation of K6a,
``.../csrc/dense_scan.cu``), K7n (K7 without the ids, ``.../csrc/vit_scan.cu``)
and the recompute walk W2 (``.../csrc/rec_walk.cu``):

31. K6t on the V=32 dense graph and K7n on the 2M-arc graph against their
    plain twins at B=128, N=128 (lengths 1, 2N/3 and N mixed, ±30-nat
    cliffs), each run twice, bit-equal to each other and to the twin, and
    restarted mid-sweep from a saved frame; K7n's final value, ksum and
    shift bit-equal to K7's on the same input, its checkpoints equal to
    the saved frames; W2 bit-equal to its twin on both graphs' saved
    frames, whole and in two chunks; the decode with chunk_size 7 and 64
    equal to the one-chunk decode (states and scores);
32. ``viterbi`` on the V=32 dense graph at B=128, N=700 (seed 0): exactly
    one K6t and one W2 launch and no other kernel (counters and the
    profiler), all 128 paths walked in f64, 8 sequences of mixed lengths
    against the f64 max-plus optimum (1e-3); the decode (median of 5),
    audio-s/s, the K6t sweep (µs per frame) and the walk timed beside their
    bounds and their twins (held bit-equal at this shape), the device idle
    share of one profiled decode; then BASELINE.json config 1 (a
    left-to-right 5-state HMM, T=100, B=1) on the card: states equal to the
    CPU route's, the score against the optimum;
33. the 2M-arc graph at B=128, N=1,024, past the id stream's 6 GB budget:
    the route is named by the budget, one K7n checkpoint sweep and per
    64-frame chunk one K7n recompute and one W2 walk (counters), all 128
    paths walked in f64; the decode (median of 3), the checkpoint sweep,
    one chunk's recompute and walk timed beside their bounds and twins
    (bit-equal); at N=700 (phase 17's input) the recompute route called
    directly beside K7's decode: scores within 1e-5, every path of both
    f64-valid, the sequences whose states differ counted (near-ties of the
    two routes' arithmetic) and held to the other route's score;

then the overflow-family decode of the separate-state graph of phases
18-21 (its capped layout's families, which the TPU K7 refuses and the JAX
package decodes in XLA), through the family branch of K7 and K7n (FAM,
``.../csrc/vit_scan.cu``) and the walk with its decode tables:

34. K7's family branch and the walk against their plain twins at B=128
    and B=126, N=128 (lengths 1, 2 (infeasible) and N mixed, ±30-nat
    cliffs): K7 run twice and bit-equal, ids and omega argmaxes bit-equal
    to the twin, the walk equal to its twin; K7n's family branch bit-equal
    to its twin;
35. ``viterbi`` at B=2, N=40 against the f64 max-plus optimum on the
    separate-state graph and on its embedded layout (the same LM with its
    backoff states on the trigram rows' diagonal, uniform K7);
36. the separate-state decode at B=128, N=700 (seed 0): exactly one K7
    launch (the family branch) and one walk launch (counters and the
    profiler), every path walked in f64 (gap < 2e-3), the embedded
    layout's decode gated likewise; both timed (median of 5) beside phase
    17's 2M-arc decode, the decode's parts, the idle share of one profiled
    decode, K7's frame split; K7 and the walk timed and held to their
    twins at this shape;
37. the separate-state graph at B=128, N=1,024, past the id budget: phase
    33's checks through K7n's family branch (1 + 17 K7n and 17 W2
    launches, all in the family branch), and at N=700 the recompute route
    called directly beside phase 36's decode.

then float64 (``compile_fsm(dtype=torch.float64)``: K2-K4's float64
instantiation for 'block' graphs, K5a/K5b's for stacked numerators,
K6a/K6b's for 'dense' graphs and K7's, K7n's, K6t's and W2's for the
decode; a general-Ĉ graph has no kernel yet and is refused on the card):

38. the 2M-arc and separate-state graphs compiled float64; K2-K4's
    float64 instantiation against its float64 plain twin on both at B=8,
    N=700, chunk 64 (lengths 1, N/2+1, 2N/3 and N mixed, ±30-nat
    cliffs): K2's checkpoints, last state, shift and ksum (logZ within
    1e-12 relative), every chunk's K3 alphas and K4 posteriors and beta
    (1e-10), every call twice, bit-equal, with the float64 launch
    counters (``LAUNCHES_F64``);
39. the two float64 graphs against the f64 oracle at B=2, N=700 (phase
    25's input and oracle): |dlogZ| and |dposts| within the 1e-4
    contract, printed beside phase 25's float32 readings;
40. per graph, the LF-MMI step (float64 stacked numerators through
    K5a/K5b's float64 instantiation) and den-only ``pdfposteriors`` in
    float64 beside float32, medians of 5 in turns, the float64 step's
    launches (exactly K2-K5's float64 instantiations, no float32
    kernel); one float64 step under ``torch.profiler``; the float64
    den-only profile (phase 9's launch checks); K2-K4 in float64 timed
    beside their twins and held to them at B=128, N=700, their frame
    splits and bounds (the tier at the FP64 tensor-core rate);
41. K5a/K5b's float64 instantiation against its float64 twin on the
    main-path numerators (G=128, N=700, phase 7's lengths and cliffs),
    each run twice, bit-equal, the admission's shared memory against the
    kernels', and timed; the wide float64 instantiation on 4 skip-arc
    numerators of ~1,200 states against its twin and the f64 oracle, then
    on a G=128 stack of them through ``pdfposteriors`` (one float64
    launch each), twice bit-equal, against the twins and timed; the
    float64 cluster instantiation (K5b on a cluster of 2 CTAs) on a G=8
    stack of ~3,000-state lattices at N=2,400 against the f64 oracle and
    its twins, twice bit-equal, and timed;
42. K6a and K6b in float64 against their float64 twins on the V=32 graph
    at B=128, N=700 (phase 11's input in float64), each run twice and
    bit-equal: logZ within 1e-12 relative, states and posteriors within
    1e-12, only float64 launches; then (phase 39 extended) the float64
    dense graph's ``pdfposteriors`` at B=2, N=700 against the f64 oracle
    within 1e-8, on exactly one K6a and one K6b float64 launch;
43. K6t and W2 in float64 on the V=32 dense decode at B=128, N=700
    (lengths 1, 2N/3 and N mixed, ±30-nat cliffs): K6t twice, bit-equal
    to each other and to its twin, restarted mid-sweep; W2 bit-equal to
    its twin whole and in two chunks; K6t at B=126 (the scalar branch);
44. K7 (the 2M-arc graph at B=128 and 126; the separate-state graph: the
    family branch), K7n and W2 in float64 against their twins at N=128:
    every call twice and bit-equal, ids, omega argmaxes, final values,
    ksum and shift bit-equal to the twin, K7n ending as K7, its
    checkpoints, a restart, W2 whole and in two chunks;
45. ``viterbi`` in float64 at B=128, N=700 on the dense, 2M-arc and
    separate-state graphs (exactly one K6t and one W2, or one K7 and one
    walk, all float64), every path's float64 weight within 1e-8 of its
    score; at B=2, N=40 the scores within 1e-8 of the f64 max-plus
    optimum on every route (the 2M-arc graph also through the
    chunk-recompute route); the 2M-arc decode at B=128, N=1,024, past the
    id budget (1 + 17 K7n and 17 W2 float64 launches), its checkpoint
    sweep, one recompute and its walk bit-equal to their twins and timed;
46. float64 beside float32, medians of 5 in turns: the dense step (float64
    numerators through K5a/K5b's float64 instantiation; its launches:
    exactly K5a, K5b, K6a, K6b float64 once each) and den-only call, the
    2M-arc, separate-state and dense decodes at N=700 and the 2M-arc
    decode at N=1,024; K6a/K6b in float64 timed beside their twins, float64
    ``torch.matmul`` and ``torch.sparse.mm`` ×701 and their bounds (the
    product at the FP64 tensor-core rate, and at the non-tensor FP64 rate
    beside it); K7 in float64 timed beside its twin on both block graphs;
47. the log-space scans, which the JAX package runs outside any Pallas
    kernel and the port runs in plain PyTorch on every device: the V=48
    phone n-gram denominator (``workloads.make_lm_hmm_graph(V=48)``: 6,913
    states, 124,417 arcs, P=144; BASELINE config 3) compiled 'segment' and
    'ell', and 32 numerators stacked in domain 'log' (BASELINE config 2):
    ``fast_path_report`` names the plain log-space route; at B=2, N=700
    logZ and posteriors against the f64 host oracle (float32 at 1e-3 /
    1e-4, float64 compiles at the 1e-4 contract); at B=32, N=700 (lengths
    1 .. 700, ±30-nat cliffs) ``pdfposteriors`` and ``logmarginal`` with
    its gradient (equal to the posteriors, bit for bit), no kernel launch
    (the counters and ``torch.profiler``), two runs bit-equal, the card
    against the CPU on the same inputs, medians of 5, and for reference the
    same graph compiled 'dense' on K6a/K6b ('block' compiles it in two
    tiers, which K2-K4 refuse);
48. the tropical decodes of that route: ``viterbi`` of the V=48 'segment'
    graph and the forced alignment of the 32 stacked numerators at B=32,
    N=700 against the f64 max-plus optimum and ``oracle.validate_paths``,
    ``maxstateposteriors`` at B=2, N=700 (its best-path states at 0), no
    kernel launch, two runs bit-equal, the card against the CPU, medians
    of 5;
49. the 2M-arc 'block' graph and the V=32 'dense' graph compiled in domain
    'log': ``viterbi`` at B=32, N=700 launches the kernels of the
    probability-domain decode (K7 and its walk; K6t and W2), bit-equal to
    the probability-domain graphs' decodes, medians of 5 in turns;
50. the graphs whose JAX counterpart runs in XLA, on the port's plain
    routes on the card: the general-Ĉ V=8 graph ('dense' and 'block',
    float32 and float64) and the 'block' graphs K2-K4 refuse (the V=16
    one-hot reduction, the V=32 two tiers, the V=64 generic
    gather/scatter): ``fast_path_report`` names the route;
    ``pdfposteriors``, ``lfmmi_loss`` (2 stacked log-domain numerators)
    with its gradient and ``viterbi`` at B=2, N=40 against the f64 oracles
    and against the same calls on the CPU; no K2-K7 launch; then one
    den-only ``pdfposteriors`` and one ``viterbi`` of the 2M-arc graph
    compiled at ``ov_cap=64`` (two tiers) at B=128, N=700, timed;
51. K6a and K6b in float64, redesigned for the FP64 tensor cores: their
    ``ptxas`` report (spill bytes), their float64 twins on a fully dense
    Sp = 4,096 operator (streamed) at B=128, N=128, each run twice and
    bit-equal (the V=32 operator: phase 42), and phase 46's times beside
    float64 ``torch.matmul`` / ``torch.sparse.mm`` x701, the float64 dense
    step and den-only call, with the frame without the product;
52. K2-K4 in float64, redesigned for Hopper (the tier on the FP64 tensor
    cores, its stages through a ``cp.async`` ring): the ``ptxas`` report of
    every ``fwd_chunk_kernel`` / ``bwd_chunk_kernel<..., double>``
    instantiation (fails on any spill), their float64 twins at B=126,
    N=128 (the scalar branch) on both block graphs, each call twice and
    bit-equal, and this run's float64 frame splits of K2 and K4, K2/K3/K4
    times and bounds and phase 40's float64 steps, each beside float32;
53. K7 and K7n in float64, redesigned for Hopper (the tier's compares on
    the FP64 pipe, its stages through a ``cp.async`` ring): the ``ptxas``
    report of every ``vit_sweep_kernel<..., double>`` instantiation (fails
    on any spill or stack byte), the library's float64 layout, K7 and K7n
    against their float64 twins at B=126, N=128 (the scalar branch) on
    both block graphs, each call twice and bit-equal, with K7n's
    checkpoints and restart, and this run's float64 K7 frame splits, K7,
    K7 fam. and K7n times and bounds and phase 46's float64 decodes, each
    beside float32;
54. the float32 K7n, redesigned for Hopper (its tier streamed through a
    ``cp.async`` ring that the item before fills during its epilogue, the
    heavy rows four to an item): the ``ptxas`` report of its four
    instantiations, every instantiation's shared memory against the
    admission's reckoning, both branches against their twins at B = 128,
    126 and 124 (twice, ending as K7, checkpoints, restart, chunked
    decodes equal to one chunk), and its frame split on both block graphs;
55. the library's ``ptxas`` report: K5a's and K5b's cluster
    instantiations spill 0 bytes, the narrow K5b's entries are listed
    beside the table's, and every other entry but W2's and the walk's
    equals the parent commit's table ``tools/ptxas_ref.json``;
56. W2 and the walk over the ids, redesigned for Hopper (W2: one round of
    packed in-arc records, then their alphas, per frame, the next row
    fetched with them, the ω step over the ω support; the walk: its
    decode tables in shared memory): their ``ptxas`` entries spill
    nothing; both bit-equal to their twins, and to themselves, on inputs
    built to take each branch (ties, the park on fin, in-degrees past 32,
    the Dmax cap, the ω step's full scan, lengths 0, 1 and N, the family
    tables, the id 255) at B = 128, 126 and 124, W2 in float32 and
    float64; ``viterbi`` of a small 'block' graph at B = 24,576, past
    K7's and K7n's shared memory, in slices, through both routes, equal
    to the plain twins (float32 and float64); the walks' times from the
    phases before beside their chain floors (``tools/latency_probe.py``'s
    latencies), the decodes' times, and one profile of the dense decode.

Every kernel's entry in the JSON line (K6t, K7n and W2 from phases 32-33,
the family branch's K7, walk, K7n and W2 from phases 36-37, K2-K4's
float64 instantiation on both block graphs and K5a/K5b's on the main-path
numerators, and the float64 K6a, K6b, K6t, W2, K7 (uniform and family
branch) and K7n of phases 42-46, held again at B=126 in phase 53, among
them) carries its bound:
the larger of its
operations over the card's peak rate for their type and its bytes over the
memory bandwidth (H100 SXM data sheet), computed from this run's shapes.

Needs one CUDA card; exits non-zero before printing any result when there
is none or when any phase fails.  Run from the root of the checkout:

    python3 chip_smoke.py

The last two lines are a JSON object of per-kernel results and
{"ok": true, "device": {...}}.
"""
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

FRAME_SHIFT_S = 0.03
# Kernel vs plain twin (phase 4): the same math with float32 sums taken in
# another order (the tier's 128-term products, per-tile partial sums, the
# atomic posterior group sums), compounded over up to 129 frames.  States
# are compared after normalising each column to max 1..2.
TOL_KERNEL = 1e-4
TOL_ORACLE = 1e-4  # the repo's f64-oracle gate (bench.py, BASELINE.md)
TOL_POST_SUM = 1e-4  # per-frame posterior mass of a feasible sequence
# K5 vs plain twin (phase 7): float32 sums in another order (fused
# multiply-adds, the warp-shuffle omega dot and gamma sum, shared-memory
# atomics for repeated pdfs), compounded over 701 frames; states compared
# after normalising each column to max 1
TOL_K5 = 1e-4
# K5 vs its float64 twin, relative: every float64 output (K5a's alphas and
# logZ pieces, the float64 posteriors) within 1e-12 of the twin's largest
# magnitude of that output; float32 posteriors within that of the twin's
# float64 posteriors plus their own rounding (half an ulp of float32)
TOL_REL_K5 = 1e-12
TOL_GRAD = 1e-5  # lhs.grad vs posts_den - posts_num from separate calls
TOL_GRAD_SUM = 1e-4  # the gradient's sum over pdfs on an active frame
# K6 vs plain twin (phase 11): float32 sums of the 3,200-term products and
# of the per-pdf posterior sums in another order, compounded over 701
# frames; states compared after normalising each (frame, column) to max 1
TOL_K6 = 1e-4
# K7 vs plain twin (phase 15): the same float32 products and compares, so
# the ids and the omega argmaxes must be bit-equal; the scores are then
# equal too (the bound allows for the log and the ksum·ln2 split only)
TOL_VIT = 1e-5
TOL_VIT_ORACLE = 1e-3  # |dscore| vs the f64 max-plus optimum (bench.py gate)
TOL_VIT_PATH = 1e-4  # a decoded path's f64 weight vs that optimum
TOL_VIT_WALK = 2e-3  # path weight vs the device score over 700 frames
# 'high' logZ at B=2 N=700 against the f64 oracle: float32 round-off grows
# ~linearly in N (bench.py:380-392 gates the JAX package at 1e-3); the
# posteriors keep TOL_ORACLE
TOL_ORACLE_700 = 1e-3
# bf16 at B=2 N=700 against the f64 oracle: bench.py:507-525's gate of the
# mixed-precision mode on 'block' graphs, whose bf16 tier carries only the
# word-to-word arcs ...
TOL_BF16_LOGZ, TOL_BF16_POSTS = 2e-3, 1e-3
# ... while a 'dense' graph rounds every arc weight and state every frame:
# ~7e-3 in logZ on the WSJ graph by the JAX package's own account
# (semiring_ops.py:119-121)
TOL_DENSE_BF16_LOGZ, TOL_DENSE_BF16_POSTS = 2e-2, 5e-3
# A bf16 kernel against its twin over a whole sweep: the two round their own
# float32 states, which differ in the last bits (sums in another order), so
# now and then a state element rounds to the neighbouring bf16 value, a
# step of up to 2^-7 of its term; where one term dominates a posterior
# (<= 1) or a normalised state, that moves it by up to ~7.8e-3.  The same
# kernels from the same inputs, one frame at a time, where both round the
# same values, are held to TOL_KERNEL (phases 23 and 24, first).
TOL_KERNEL_BF16 = 1e-2

# Peak rates of one H100 SXM at 700 W (NVIDIA's data sheet, dense, outside
# the tensor cores for the float types the kernels compute in) for the
# kernels' bounds: the larger of operations / peak and bytes / bandwidth.
PEAK_F32 = 67e12  # float32 FLOP/s
# float64 FLOP/s outside the tensor cores (K5a/K5b keep their state in
# float64; K2-K4's float64 instantiation; data sheet: 33.5)
PEAK_F64 = 34e12
# float64 FLOP/s on the tensor cores (DMMA, full IEEE float64; data sheet:
# 67): the float64 tier's products could run there
PEAK_F64_TC = 67e12
# float32 instructions that are not FMAs (a multiply, a compare, a select):
# one per lane and clock, half the FMA FLOP rate
PEAK_F32_OPS = PEAK_F32 / 2
# the same for float64 (a double multiply, max or compare on the FP64 pipe)
PEAK_F64_OPS = PEAK_F64 / 2
PEAK_BYTES = 3.35e12  # HBM3 bytes/s
PEAK_BF16 = 989e12  # dense bf16 tensor-core FLOP/s


def bound(flops, nbytes, peak=PEAK_F32, tc_flops=0, tc_peak=PEAK_BF16):
    """(bound_ms, bound_by): the least time the card could take for work of
    ``flops`` operations at ``peak`` plus ``tc_flops`` tensor-core
    operations at ``tc_peak`` (bf16 by default) on ``nbytes`` bytes (each
    input read once, each output written once)."""
    t_ops, t_bytes = flops / peak + tc_flops / tc_peak, nbytes / PEAK_BYTES
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


def _state_past_l2(kop, B, l2_bytes):
    """(Sp B, value bytes, whether two slots of the (Sp, B) state pass
    ``l2_bytes``, by default the card's L2): where they do (float64 at
    B=128: 2 x 50 MB against the H100's 50 MB), each frame reads its
    predecessor's state and writes its own through HBM."""
    if l2_bytes is None:
        import torch

        l2_bytes = torch.cuda.get_device_properties(0).L2_cache_size
    f = kop.alpha0.element_size()  # 8: the float64 instantiation
    SB = kop.Sp * B
    return SB, f, 2 * SB * f > l2_bytes


def block_traffic(cf, B, Npad, chunk, l2_bytes=None):
    """{kernel: (operations, bytes, peak, tensor-core operations, their
    peak)} of K2 over Npad frames and K3 and K4 over one chunk, as timed:
    the tier's multiply-adds, the bands, the overflow-family terms, the
    omega dot, the emission and the rescale (forward), plus gamma and its
    pdf sums (backward).  The operator's bytes include the per-row pdf
    table (the per-lane emissions of the overflow rows), the family terms
    and, for K4, each pdf's list of overflow rows.  A bf16 graph's tier
    runs on the tensor cores (PEAK_BF16) over panels of 2 bytes; a
    float64 graph's tier on the float64 tensor cores (PEAK_F64_TC) and its
    other operations at the FP64 FMA rate (PEAK_F64), over values of 8
    bytes.

    The carried state: where two slots of it (2 Sp B values, the state a
    frame reads and the one it writes) fit the card's L2 (``l2_bytes``,
    by default ``torch.cuda.get_device_properties(0).L2_cache_size``), it
    counts once per call, read on entry and written on exit.  Where they
    do not (float64 at B=128: 2 x 50 MB against the H100's 50 MB), every
    frame reads its predecessor's state and writes its own through HBM,
    and each frame counts both: K2 2 Npad Sp B values, K3 chunk Sp B
    reads beside the alphas it writes, K4 2 chunk Sp B beside the alphas
    it reads."""
    from markovmodels_tpu_torch.ops import block_scan as bs

    kop = bs.kernel_operator(cf)
    K, Sm, D = kop.fwd.W.shape
    nO, Sp, P1 = len(kop.fwd.offsets), kop.Sp, kop.P1
    nf_f, nf_b = kop.fwd.fam_dst.numel(), kop.bwd.fam_dst.numel()
    n_ov = kop.ov_hi - kop.ov_lo
    wb = kop.fwd.W.element_size()
    SB, f, past = _state_past_l2(kop, B, l2_bytes)
    peak = PEAK_F64 if f == 8 else PEAK_F32
    tier = B * 2 * K * Sm * D
    st2, st3, st4 = ((2 * Npad * SB, chunk * SB, 2 * chunk * SB) if past
                     else (2 * SB, SB, 2 * SB))

    def op(nf):
        # panels, bands, omega, the int32 row tables, the family terms
        return (wb * K * Sm * D + f * (nO * Sp + Sp) + 4 * (2 * Sp + 1)
                + (4 + f) * nf)

    fwd = B * (2 * nO * Sp + 2 * nf_f + 4 * Sp)
    bwd = B * (2 * nO * Sp + 2 * nf_b + 6 * Sp)
    tc = wb == 2 or f == 8  # the tier on the tensor cores
    tcp = PEAK_BF16 if wb == 2 else PEAK_F64_TC
    fwd, bwd, ttc = ((fwd, bwd, tier) if tc
                     else (fwd + tier, bwd + tier, 0))
    C = Npad // chunk
    return {
        "K2": (Npad * fwd, op(nf_f) + f * (st2 + Npad * (P1 + 1) * B
                                          + C * (Sp + 1) * B + 3 * B),
               peak, Npad * ttc, tcp),
        "K3": (chunk * fwd, op(nf_f) + f * (st3 + B + chunk * P1 * B
                                            + chunk * (Sp + 1) * B),
               peak, chunk * ttc, tcp),
        "K4": (chunk * bwd, op(nf_b) + f * (st4 + B + chunk * (Sp + 1) * B
                                            + 2 * chunk * P1 * B + B)
               + 4 * (P1 + 1 + n_ov), peak, chunk * ttc, tcp),
    }


def block_bounds(cf, B, Npad, chunk, l2_bytes=None):
    """{kernel: (bound ms, "bytes" or "operations")} of K2-K4 from
    :func:`block_traffic`."""
    return {name: bound(flops, nbytes, peak, tc_flops=tcf, tc_peak=tcp)
            for name, (flops, nbytes, peak, tcf, tcp) in block_traffic(
                cf, B, Npad, chunk, l2_bytes).items()}


def banded_bounds(num_cf, Nf):
    """K5a and K5b over the Nf-frame sweep of G lattices: float64 state,
    each frame's alphas written once (K5a) and read once (K5b), in any
    layout; the emission of each of a graph's distinct pdfs (its plan's
    entries, what these lattices need) read once per frame; the inputs and
    the posteriors of f bytes (4, or 8 for a float64 stack)."""
    from markovmodels_tpu_torch.ops import banded_scan as bsc

    kop = bsc.kernel_operator(num_cf)
    Sp, G, P1, nO = kop.Sp, kop.G, kop.P1, len(kop.offsets)
    f = kop.a0.element_size()
    op = f * (2 * nO * Sp * G + 2 * Sp * G) + 4 * Sp * G
    emis = f * Nf * int(kop.plan[:, 0].sum())
    return {
        "K5a": bound(Nf * G * (2 * nO * Sp + 4 * Sp),
                     op + emis + f * Nf * G + 8 * Nf * Sp * G + 24 * G,
                     PEAK_F64),
        "K5b": bound(Nf * G * (2 * nO * Sp + 5 * Sp),
                     op + emis + 8 * Nf * Sp * G + f * Nf * P1 * G,
                     PEAK_F64),
    }


def dense_bounds(dcf, B, Nf, dense=False, f64_tc=True):
    """K6a and K6b over the Nf-frame sweep: per frame the product over the
    operator's non-zero entries (what these inputs need: a zero weight adds
    nothing), the emission, rescale and posterior work; a bf16 graph's
    product on the tensor cores (PEAK_BF16), a float64 graph's on the
    float64 tensor cores (PEAK_F64_TC, as K2<double>'s tier is counted;
    ``f64_tc`` False: at the non-tensor FP64 rate, the kernel's own) with
    the rest at PEAK_F64 over 8-byte values.  The operator is read once as
    a CSR (each non-zero with a 4-byte column index, the row pointers).
    With ``dense``: the dense-equivalent bound of the full (Sp, Sp)
    product over the dense operator, as if no entry were zero."""
    import torch

    from markovmodels_tpu_torch.ops import dense_scan as ds

    kop = ds.kernel_operator(dcf)
    Sp, P1 = kop.Sp, kop.P1
    wb = kop.wf.element_size()
    f = kop.alpha0.element_size()
    out = {}
    for name, w, extra, state_bytes in (
            ("K6a", kop.wf, 3, Sp * B + Nf * (P1 + 1) * B
             + Nf * (Sp + 1) * B + 3 * B),
            ("K6b", kop.wb, 5, Nf * (Sp + 1) * B + 2 * Nf * P1 * B)):
        nnz = Sp * Sp if dense else int(torch.count_nonzero(w))
        op = wb * nnz if dense else (wb + 4) * nnz + 4 * (Sp + 1)
        prod = Nf * B * 2 * nnz
        rest = Nf * B * extra * Sp
        if f == 8:
            tc, vec = (prod, rest) if f64_tc else (0, prod + rest)
            out[name] = bound(vec, op + f * state_bytes, PEAK_F64,
                              tc_flops=tc, tc_peak=PEAK_F64_TC)
            continue
        f32, tc = (0, prod) if wb == 2 else (prod, 0)
        out[name] = bound(f32 + rest, op + 4 * state_bytes, tc_flops=tc)
    return out


def vit_traffic(cf, B, Nf, l2_bytes=None, g=None):
    """{kernel: (operations, bytes, peak)} of K7 over the Nf-frame sweep:
    per tier candidate the work the function needs, one multiply and one
    max, and the id ~1/g of that (g tier candidates per id compare of the
    library's group rule, ``vit_scan.layout(..., f64=False)``, unless
    given: per group a compare and the selects of the running value and of
    the group; the winner's recovery is one group more per output; the
    float64 kernel compares every candidate, layout's g = 1 there, which
    the bound, the function's least work, does not charge); per band
    candidate a
    multiply, a compare and two selects; per state the omega product and
    max, the emission multiply and the rescale; the ids written once.
    Each operation at one per lane and clock (PEAK_F32_OPS, PEAK_F64_OPS
    in float64).  "K7 (4 instructions)": the same with the four
    instructions per tier candidate of a running (max, argmax) loop (a
    multiply, a compare, two selects).  A capped layout's family terms
    (the family branch) add a multiply and a max each, and their tables
    (per-row pointers, sources, weights, uint8 ids, the row pdfs) are read
    once.  The state, where two slots of it pass L2 (``_state_past_l2``),
    is read and written every frame (2 Nf Sp B values).  The walk: per
    frame and sequence one id read and one state written, its decode
    tables once (:func:`walk_ids_bytes`)."""
    from markovmodels_tpu_torch.ops import block_scan as bs
    from markovmodels_tpu_torch.ops import vit_scan as vs

    kop = bs.kernel_operator(cf, vs._vit_dtype(cf))
    K, Sm, D = kop.fwd.W.shape
    nO, Sp, P1 = len(kop.fwd.offsets), kop.Sp, kop.P1
    nfam = kop.fwd.fam_dst.numel()
    RW = vs._main_region(cf)
    SB, f, past = _state_past_l2(kop, B, l2_bytes)
    peak = PEAK_F64_OPS if f == 8 else PEAK_F32_OPS
    nbytes = (f * (K * Sm * D + nO * Sp + 2 * Sp + Nf * (P1 + 1) * B)
              + Nf * RW * B + 4 * Nf * B + 3 * f * B)
    if vs._is_fam(kop):
        nbytes += 4 * (2 * Sp + 1) + (5 + f) * nfam
    if past:
        nbytes += 2 * Nf * SB * f
    rest = 4 * nO * RW + 2 * Sp + 2 * Sp + 2 * nfam
    tier = K * Sm * D
    if g is None:
        g = vs.layout(B, Nf - 1, False)[1]
    ops = Nf * B * (2 * (1 + 1 / g) * tier + rest)
    ops4 = Nf * B * (4 * tier + rest)
    return {"K7": (ops, nbytes, peak),
            "K7 (4 instructions)": (ops4, nbytes, peak),
            "K7w": (0, walk_ids_bytes(cf, B, Nf), PEAK_F32)}


def walk_ids_bytes(cf, B, Nf):
    """The bytes the walk over the ids moves: per frame and sequence one
    id read and one state written, the lengths and the fins read at each
    length, and the decode tables read once (the tier sources, the
    narrowed tier-block table, the band offsets; with families ovout and
    ov_dec)."""
    from markovmodels_tpu_torch.ops import vit_scan as vs

    wt = vs.walk_tables(cf)
    tables = 4 * wt.sidx.numel() + wt.kt.numel() * wt.kt.element_size() \
        + 4 * wt.offs.numel()
    if wt.ov_hi > wt.ov_lo:
        tables += 4 * (wt.ovout.numel() + wt.ov_dec.numel())
    return (Nf - 1) * B * (1 + 4) + 8 * B + tables


def vit_bounds(cf, B, Nf, l2_bytes=None, g=None):
    """{kernel: (bound ms, "bytes" or "operations")} of K7 and its walk
    from :func:`vit_traffic`."""
    return {k: bound(ops, nbytes, peak) for k, (ops, nbytes, peak)
            in vit_traffic(cf, B, Nf, l2_bytes, g).items()}


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps=1, warm=True):
    """Mean milliseconds of ``fn()`` over ``reps`` runs after one warm-up
    (unless ``warm`` is False), timed with CUDA events."""
    import torch

    if warm:
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def profile_device(fn):
    """Where one warm call of ``fn`` spends the card's time, from
    torch.profiler's device events: ({kernel: ms}, busy ms, span ms,
    {kernel: launches}), the span running from the first device event's
    start to the last one's end; None when the profiler records no device
    event.  The profiler's window first takes one call of ``fn`` and a
    marker kernel (``torch.cuda._sleep``'s spin kernel): a tracer that
    came up late has lost the start of that first call (seen once on the
    card: a den-only call's first 30 ms missing), so only the events of
    the call after the marker count."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
        torch.cuda._sleep(100_000)  # the marker between the two calls
        torch.cuda.synchronize()
        fn()
        torch.cuda.synchronize()
    def short(name):  # "void ns::k<...>(args)" -> "k<...>"
        m = re.search(r"(\w+(?:<[^()]*>)?)\(", name)
        return (m.group(1) if m else name)[:60]

    spans = sorted((e.time_range.start, e.time_range.end, short(e.name))
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    marks = [t1 for _, t1, name in spans if name.startswith("spin_kernel")]
    if not marks:
        return None
    spans = [x for x in spans if x[0] >= marks[-1]]
    if not spans:
        return None
    by_name, counts = {}, {}
    for t0, t1, name in spans:
        by_name[name] = by_name.get(name, 0.0) + (t1 - t0) / 1e3
        counts[name] = counts.get(name, 0) + 1
    busy, (lo, hi) = 0.0, spans[0][:2]
    for t0, t1, _ in spans[1:]:
        if t0 > hi:
            busy, lo, hi = busy + hi - lo, t0, t1
        else:
            hi = max(hi, t1)
    busy += hi - lo
    span = max(t1 for _, t1, _ in spans) - spans[0][0]
    return by_name, busy / 1e3, span / 1e3, counts


def make_inputs(rng, B, N, P, cliffs=False):
    lhs = (rng.normal(size=(B, N, P)) * 0.5).astype(np.float32)
    if cliffs:
        # +30 nats on plane-2 pdfs, unreachable before frame 2 (left-to-
        # right HMMs), on frames 0-1; -30 nats on every pdf but plane 0 at
        # one frame mid-sequence
        planes = np.arange(P).reshape(-1, 3)
        lhs[:, 0:2, planes[:, 2]] += 30.0
        lhs[:, N // 2, planes[:, 1:].ravel()] -= 30.0
    return lhs


def phase_kernels(cf, P, dev, B=128, N=128, chunk=64, label="phase 4",
                  twice=False, tol=TOL_KERNEL):
    """Phase 4 (19, 23): K2, K3 and K4 against their plain twins on one
    input; with ``twice``, every K2, K3 and K4 call runs again and must
    give bit-equal results (which CTA of a persistent grid runs an item
    changes from run to run)."""
    import torch

    from markovmodels_tpu_torch.ops import block_scan as bs
    from markovmodels_tpu_torch.ops.emissions import (pad_emissions,
                                                      prepare_emissions)

    rng = np.random.default_rng(1)
    lhs = torch.from_numpy(make_inputs(rng, B, N, P, cliffs=True)).to(dev)
    lens_np = rng.integers(1, N + 1, size=B).astype(np.int32)
    lens_np[:4] = [N, 1, 2 * N // 3, N // 2 + 1]
    lens = torch.from_numpy(lens_np).to(dev)
    kop = bs.kernel_operator(cf)
    ext, msh = prepare_emissions(lhs, lens, P)
    Nf = N + 1
    K = min(chunk, Nf)
    C = -(-Nf // K)
    Npad = C * K
    assert C >= 3, "need a mid-sequence chunk boundary"
    ext, msh = pad_emissions(ext, msh, Npad)
    a0 = kop.alpha0[:, None].expand(kop.Sp, B).contiguous()

    def again(fn, out, name):
        """``fn`` run once more: bit-equal to ``out``."""
        if twice:
            assert all(torch.equal(x, y) for x, y in zip(out, fn())), \
                f"{name} differs run to run"
        return out

    errs = {}
    fn = lambda: bs.fwd_sweep(kop, a0, ext, msh, K)
    fk = again(fn, fn(), "K2")
    torch.cuda.synchronize()
    fp = bs.fwd_sweep_plain(kop, a0, ext, msh, K)
    zk, zp = sweep_logz(kop, fk), sweep_logz(kop, fp)
    fin = np.isfinite(zp)
    assert (np.isfinite(zk) == fin).all(), "K2: -inf pattern differs"
    assert fin.sum() > B // 2 and not fin[1], "K2: unexpected -inf pattern"
    errs["K2"] = sweep_err(kop, fk, fp)

    c = C // 2  # a chunk in the middle of the sequence
    sl = slice(c * K, (c + 1) * K)
    fn = lambda: bs.recompute(kop, fk[0][c], fk[1][c], ext[sl], c * K)
    ak, sk = again(fn, fn(), "K3")
    torch.cuda.synchronize()
    ap, sp = bs.recompute_plain(kop, fk[0][c], fk[1][c], ext[sl], c * K)
    errs["K3"] = float((scaled(ak, sk) - scaled(ap, sp)).abs().max())

    beta = torch.ones_like(a0)
    bsc = torch.ones(B, device=dev)
    for cc in reversed(range(C)):  # the backward over every chunk
        slc = slice(cc * K, (cc + 1) * K)
        fn = lambda: bs.recompute(kop, fk[0][cc], fk[1][cc], ext[slc], cc * K)
        al, asc = again(fn, fn(), "K3")
        fn = lambda: bs.backward(kop, beta, bsc, al, asc, ext[slc], cc * K,
                                 Npad)
        pk, bk, bsk = again(fn, fn(), "K4")
        torch.cuda.synchronize()
        pp, bp, bsp = bs.backward_plain(kop, beta, bsc, al, asc, ext[slc],
                                        cc * K, Npad)
        errs["K4"] = max(errs.get("K4", 0.0),
                         bwd_err((pk, bk, bsk), (pp, bp, bsp)))
        beta, bsc = bk, bsk
    for name, e in errs.items():
        print(f"{label}: {name} kernel vs plain max |err| = {e:.3e} "
              f"(tol {tol:g})")
        assert np.isfinite(e) and e <= tol, f"{name} disagrees: {e}"
    if twice:
        print(f"{label}: K2 run twice, K3 and K4 twice on each of {C} "
              "chunks: bit-equal")
    return errs


def sweep_logz(kop, out):
    """logZ (B,) from a K2 sweep's outputs, as a numpy array, combined in
    float64: the shift and ksum·ln2 reach ~1e3 over 700 frames, where one
    float32 rounding of their sum (1.2e-4) would swamp the sweeps'
    difference."""
    from markovmodels_tpu_torch import inference as tinf

    _, _, a, s, ksum, shift = out
    v = a[kop.fin].double() * s.double()
    return tinf._combine_shift(tinf._log_final(v), ksum.double(),
                               shift.double()).cpu().numpy()


def scaled(a, s):
    """An unscaled state (.., Sp, B) times its scale (.., B)."""
    return a * s[..., None, :] if a.dim() == 3 else a * s[None, :]


def sweep_err(kop, fk, fp):
    """K2 against its twin: logZ where finite, checkpoints and last state."""
    zk, zp = sweep_logz(kop, fk), sweep_logz(kop, fp)
    fin = np.isfinite(zp)
    return max(
        float(np.abs(zk[fin] - zp[fin]).max(initial=0.0)),
        float((scaled(fk[0], fk[1]) - scaled(fp[0], fp[1])).abs().max()),
        float((scaled(fk[2], fk[3]) - scaled(fp[2], fp[3])).abs().max()),
    )


def bwd_err(k, p):
    """K4 against its twin: posteriors and the outgoing beta."""
    return max(float((k[0] - p[0]).abs().max()),
               float((scaled(k[1], k[2]) - scaled(p[1], p[2])).abs().max()))


def phase_oracle(fsm, spdf, cf, P, dev, n=40, label="phase 5"):
    """Phase 5 (12): pdfposteriors at B=2 against the exact f64 host
    oracle."""
    import torch

    import markovmodels_tpu_torch as mt

    rng = np.random.default_rng(7)
    lhs = rng.normal(size=(2, n, P)).astype(np.float32)
    lens = np.array([n, max(2, 2 * n // 3)], dtype=np.int32)
    ref_z, ref_p = mt.oracle.host_oracle(fsm, spdf, P,
                                         lhs.astype(np.float64), lens)
    posts, z = mt.pdfposteriors(cf, torch.from_numpy(lhs).to(dev),
                                torch.from_numpy(lens).to(dev))
    err = float(np.abs(z.cpu().numpy() - ref_z).max())
    perr = float(np.abs(posts.cpu().numpy() - ref_p).max())
    print(f"{label}: B=2 N={n} vs f64 oracle |dlogZ| = {err:.3e}, "
          f"|dposts| = {perr:.3e} (tol {TOL_ORACLE:g})")
    assert err <= TOL_ORACLE and perr <= TOL_ORACLE, "oracle gate failed"


def phase_main(cf, P, dev, B=128, N=700):
    """Phase 6: the main path through the kernels, checked and timed."""
    import torch

    import markovmodels_tpu_torch as mt
    from markovmodels_tpu_torch import inference as tinf
    from markovmodels_tpu_torch.ops import block_scan as bs

    rng = np.random.default_rng(0)
    lhs = torch.from_numpy(make_inputs(rng, B, N, P)).to(dev)
    lengths = torch.full((B,), N, dtype=torch.int32, device=dev)
    torch.cuda.synchronize()
    bs.reset_launch_counts()
    posts, logz = mt.pdfposteriors(cf, lhs, lengths)
    torch.cuda.synchronize()
    launches = dict(bs.LAUNCHES)
    print(f"phase 6: launches {json.dumps(launches)}")
    assert all(v > 0 for v in launches.values()), "a kernel never launched"

    z = logz.cpu().numpy()
    p = posts.cpu().numpy()
    assert p.shape == (B, N, P) and z.shape == (B,), "output shapes"
    assert np.isfinite(z).all(), "non-finite logZ"
    assert np.isfinite(p).all() and (p >= 0).all(), "bad posteriors"
    mass = np.abs(p.sum(axis=2) - 1.0).max()
    print(f"phase 6: logZ in [{z.min():.3f}, {z.max():.3f}], "
          f"max |sum_p posts - 1| = {mass:.3e}")
    assert mass <= TOL_POST_SUM, "posteriors do not sum to 1"

    # ragged copy: zeros past each length
    lens2 = torch.from_numpy(
        rng.integers(N // 2, N + 1, size=B).astype(np.int32)).to(dev)
    p2, _ = mt.pdfposteriors(cf, lhs, lens2)
    p2 = p2.cpu().numpy()
    for b, L in enumerate(lens2.cpu().numpy()):
        assert (p2[b, L:] == 0).all(), "posteriors past the length"

    t_kern = cuda_ms(lambda: mt.pdfposteriors(cf, lhs, lengths), reps=2)
    t_plain = cuda_ms(
        lambda: tinf._fb_prob(cf, lhs, lengths, tinf._auto_chunk(cf, lhs),
                              True))
    audio = B * N * FRAME_SHIFT_S
    print(f"phase 6: pdfposteriors B={B} N={N}: kernel path "
          f"{t_kern / 1e3:.4f} s = {audio / (t_kern / 1e3):.1f} audio-s/s; "
          f"plain torch path {t_plain / 1e3:.4f} s = "
          f"{audio / (t_plain / 1e3):.1f} audio-s/s")
    return launches, t_kern, t_plain


def time_kernels(cf, P, dev, B=128, N=700, chunk=64, tol=TOL_KERNEL):
    """Each kernel and its plain twin at the main path's shapes: K2 over
    all Npad frames, K3 and K4 over one 64-frame chunk; then each kernel
    held to its twin on these inputs.  Returns ({name: (kernel ms, plain
    ms)}, {name: max |err|})."""
    import torch

    from markovmodels_tpu_torch.ops import block_scan as bs
    from markovmodels_tpu_torch.ops.emissions import (pad_emissions,
                                                      prepare_emissions)

    rng = np.random.default_rng(0)
    dt = cf.alpha_hat.dtype  # the float64 instantiation for a float64 graph
    lhs = torch.from_numpy(make_inputs(rng, B, N, P)).to(dev, dt)
    lens = torch.full((B,), N, dtype=torch.int32, device=dev)
    kop = bs.kernel_operator(cf)
    ext, msh = prepare_emissions(lhs, lens, P, dt)
    Nf = N + 1
    K = min(chunk, Nf)
    C = -(-Nf // K)
    ext, msh = pad_emissions(ext, msh, C * K)
    a0 = kop.alpha0[:, None].expand(kop.Sp, B).contiguous()
    bounds, bscale = bs.fwd_sweep(kop, a0, ext, msh, K)[:2]
    c = C - 1
    sl = slice(c * K, (c + 1) * K)
    al, asc = bs.recompute(kop, bounds[c], bscale[c], ext[sl], c * K)
    beta = torch.ones_like(a0)
    bsc = torch.ones(B, device=dev, dtype=dt)
    calls = {
        "K2": (lambda: bs.fwd_sweep(kop, a0, ext, msh, K),
               lambda: bs.fwd_sweep_plain(kop, a0, ext, msh, K)),
        "K3": (lambda: bs.recompute(kop, bounds[c], bscale[c], ext[sl], c * K),
               lambda: bs.recompute_plain(kop, bounds[c], bscale[c], ext[sl],
                                          c * K)),
        "K4": (lambda: bs.backward(kop, beta, bsc, al, asc, ext[sl], c * K,
                                   C * K),
               lambda: bs.backward_plain(kop, beta, bsc, al, asc, ext[sl],
                                         c * K, C * K)),
    }
    out = {}
    for name, (kern, plain) in calls.items():
        # plain, kernel, kernel, plain: both orders on one card in one call
        p1, k1, k2, p2 = (cuda_ms(plain), cuda_ms(kern), cuda_ms(kern),
                          cuda_ms(plain))
        out[name] = ((k1 + k2) / 2, (p1 + p2) / 2)
        print(f"timing: {name} kernel {k1:.3f}/{k2:.3f} ms, plain "
              f"{p1:.3f}/{p2:.3f} ms")
    res = {name: (kern(), plain()) for name, (kern, plain) in calls.items()}
    errs = {
        "K2": sweep_err(kop, *res["K2"]),
        "K3": float((scaled(*res["K3"][0]) - scaled(*res["K3"][1]))
                    .abs().max()),
        "K4": bwd_err(*res["K4"]),
    }
    for name, e in errs.items():
        print(f"timing: {name} kernel vs plain at B={B} N={N} (K2 over "
              f"{C * K} frames) max |err| = {e:.3e} (tol {tol:g})")
        assert np.isfinite(e) and e <= tol, f"{name} disagrees: {e}"
    return out, errs


def cut_operator(kop, tier=True, bands=True, direction="bwd"):
    """A copy of ``kop`` whose ``direction`` operator ('fwd': K2/K3's,
    'bwd': K4's) keeps the tier (``tier``) and the band offsets and family
    terms (``bands``): a timing probe of a kernel's parts, not the graph's
    function.  Without the tier, its rows become band rows (tiles of 64
    rows that skip the product)."""
    import torch

    kd = getattr(kop, direction)
    dev = kd.band_rows.device
    if not tier:
        rows = np.sort(np.concatenate([kd.band_rows.cpu().numpy(),
                                       kd.dst_rows.cpu().numpy().ravel()]))
        kd = kd._replace(W=kd.W[:0], src_rows=kd.src_rows[:0],
                         dst_rows=kd.dst_rows[:0],
                         band_rows=torch.from_numpy(
                             rows.astype(np.int32)).to(dev))
    if not bands:
        kd = kd._replace(offsets=(), band_w=kd.band_w[:0],
                         fam_ptr=torch.zeros_like(kd.fam_ptr),
                         fam_src=kd.fam_src[:0], fam_w=kd.fam_w[:0],
                         fam_dst=kd.fam_dst[:0])
    # a fresh plan cache; a copy of the package from before K4 kept plans
    # (timed by ab_block.py) has none
    extra = {"plans": {}} if "plans" in kop._fields else {}
    return kop._replace(**{direction: kd}, **extra)


def frame_split(cf, P, dev, label, B=128, N=700, chunk=64):
    """K2 over the N=700 sweep, and K3 and K4 over its last chunk
    (time_kernels' input), each on its whole operator and on three cut
    copies of it: without the tier product, without the bands and family
    terms, and without either (the frame without work: the epilogue, the
    statistics and the frame-to-frame dependency).  Prints and returns
    {kernel: {part: us per frame}}, CUDA events, mean of 3 warm runs
    each."""
    import torch

    from markovmodels_tpu_torch.ops import block_scan as bs
    from markovmodels_tpu_torch.ops.emissions import (pad_emissions,
                                                      prepare_emissions)

    rng = np.random.default_rng(0)
    dt = cf.alpha_hat.dtype
    lhs = torch.from_numpy(make_inputs(rng, B, N, P)).to(dev, dt)
    lens = torch.full((B,), N, dtype=torch.int32, device=dev)
    kop = bs.kernel_operator(cf)
    ext, msh = prepare_emissions(lhs, lens, P, dt)
    C = -(-(N + 1) // chunk)
    ext, msh = pad_emissions(ext, msh, C * chunk)
    a0 = kop.alpha0[:, None].expand(kop.Sp, B).contiguous()
    bounds, bscale = bs.fwd_sweep(kop, a0, ext, msh, chunk)[:2]
    c = C - 1
    sl = slice(c * chunk, (c + 1) * chunk)
    al, asc = bs.recompute(kop, bounds[c], bscale[c], ext[sl], c * chunk)
    beta, bsc = torch.ones_like(a0), torch.ones(B, device=dev, dtype=dt)
    calls = {
        "K2": ("fwd", C * chunk, lambda op: bs.fwd_sweep(op, a0, ext, msh,
                                                         chunk)),
        "K3": ("fwd", chunk, lambda op: bs.recompute(
            op, bounds[c], bscale[c], ext[sl], c * chunk)),
        "K4": ("bwd", chunk, lambda op: bs.backward(
            op, beta, bsc, al, asc, ext[sl], c * chunk, C * chunk)),
    }
    out = {}
    for name, (direction, frames, call) in calls.items():
        out[name] = {}
        for part, cut in (
                ("whole", kop),
                ("no tier", cut_operator(kop, tier=False,
                                         direction=direction)),
                ("no bands/families", cut_operator(kop, bands=False,
                                                   direction=direction)),
                ("without work", cut_operator(kop, False, False,
                                              direction))):
            out[name][part] = 1e3 * cuda_ms(lambda: call(cut),
                                            reps=3) / frames
        grid = (bs._bwd_grid if direction == "bwd" else bs._fwd_grid)(
            kop, dev, B, kop.fwd.W.dtype)
        print(f"timing: {name} frame split on the {label}: " + "; ".join(
            f"{k} {v:.2f} us" for k, v in out[name].items())
            + f" per frame (over {frames} frames, {grid} CTAs)")
    return out


def profile_block_den(cf, P, dev, label, B=128, N=700, chunk=64):
    """One block den-only pdfposteriors under torch.profiler: its device
    time by kernel and idle share, printed; asserts exactly one K2 and one
    K3 launch per chunk (the persistent ``fwd_chunk_kernel``), one K4
    launch per chunk (``bwd_chunk_kernel``), and no per-frame step or
    finalize launch.  The input in the graph's dtype."""
    import torch

    import markovmodels_tpu_torch as mt

    rng = np.random.default_rng(0)
    lhs = torch.from_numpy(make_inputs(rng, B, N, P)).to(dev,
                                                         cf.alpha_hat.dtype)
    lens = torch.full((B,), N, dtype=torch.int32, device=dev)
    prof = profile_device(lambda: mt.pdfposteriors(cf, lhs, lens))
    if prof is None:
        print(f"{label}: profile of the den-only pdfposteriors: not measured "
              "(no device events recorded)")
        return None
    by_name, busy, span, counts = prof
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    print(f"{label}: profile of one den-only pdfposteriors: device busy "
          f"{busy:.3f} ms of a {span:.3f} ms span (idle "
          f"{1 - busy / span:.1%}); " + "; ".join(
              f"{k} {v:.3f} ms ({counts[k]} launches)" for k, v in top))
    C = -(-(N + 1) // chunk)
    n = lambda prefix: sum(v for k, v in counts.items()
                           if k.startswith(prefix))
    assert n("fwd_chunk_kernel") == 1 + C, f"K2/K3 launches {counts}"
    assert n("bwd_chunk_kernel") == C, f"K4 launches {counts}"
    assert not any("finalize" in k or "step_kernel" in k for k in counts), \
        f"a per-frame launch: {counts}"
    return prof


def build_numerators(P, G=128, Lp=78, seed=3):
    """``bench.py``'s numerators: G linear lattices over random Lp-pdf
    sequences, self-loop and chain arcs at 0.5, final weight 0.5.
    Returns [(fsm, spdf)]."""
    import markovmodels_tpu_torch as mt

    rng = np.random.default_rng(seed)
    out = []
    for _ in range(G):
        seq = rng.integers(0, P, size=Lp)
        arcs = [((i, i), np.log(0.5)) for i in range(Lp)] + [
            ((i, i + 1), np.log(0.5)) for i in range(Lp - 1)]
        fsm = mt.fsm.FSM.from_pairs(
            [(0, 0.0)], arcs, [(Lp - 1, np.log(0.5))],
            [mt.labels.Label(int(s)) for s in seq], mt.semiring.LOG)
        out.append((fsm, np.append(seq, P).astype(np.int32)))
    return out


def stack_numerators(graphs, P, dev, dtype=None):
    import markovmodels_tpu_torch as mt

    kw = {} if dtype is None else {"dtype": dtype}
    return mt.stack([mt.compile_fsm(f, sp, P, strategy="banded", device=dev,
                                    **kw)
                     for f, sp in graphs])


def banded_inputs(num_cf, P, dev, N=700, seed=11):
    """Phase 7's input: ragged lengths with a length of 1 and a length of 60
    (both shorter than the 78-state lattice: infeasible) and one of exactly
    78 (a single path), ±30-nat cliffs; in the stack's dtype."""
    import torch

    from markovmodels_tpu_torch.ops.emissions import prepare_emissions

    G, dt = num_cf.alpha_hat.shape[0], num_cf.alpha_hat.dtype
    rng = np.random.default_rng(seed)
    lhs = torch.from_numpy(make_inputs(rng, G, N, P, cliffs=True)).to(dev,
                                                                       dt)
    lens = rng.integers(N // 2, N + 1, size=G).astype(np.int32)
    lens[:4] = [N, 1, 60, 78]
    ext, msh = prepare_emissions(lhs, torch.from_numpy(lens).to(dev), P, dt)
    return ext, msh


def plan_mask(kop):
    """(P1, G) bool: the pdfs of each graph's K5b plan (its own pdfs)."""
    import torch

    from markovmodels_tpu_torch.ops import banded_scan as bsc

    n, pdf = (x.long() for x in bsc.plan_fields(kop.plan, kop.Sp)[:2])
    valid = torch.arange(kop.Sp, device=n.device)[None, :] < n[:, None]
    graph = torch.arange(kop.G, device=n.device)[:, None].expand_as(pdf)
    mask = torch.zeros((kop.P1, kop.G), dtype=torch.bool, device=n.device)
    mask[pdf[valid], graph[valid]] = True
    return mask


def phase_banded_kernels(num_cf, P, dev, label="phase 7", tol=TOL_K5,
                         inputs=None):
    """Phase 7 (and 13, on the dense step's numerators; 41, float64): K5a
    and K5b against their plain twins on one input (phase 7's, or
    ``inputs``, (ext, mshift), whose lengths are all feasible), each run
    twice and bit-equal; K5b's posteriors outside each graph's plan
    exactly 0; the admission's shared-memory figures equal the
    kernels'."""
    import torch

    from markovmodels_tpu_torch import inference as tinf
    from markovmodels_tpu_torch.ops import banded_scan as bsc

    kop = bsc.kernel_operator(num_cf)
    ext, msh = inputs or banded_inputs(num_cf, P, dev)

    def logz(vfin, shift, ksum):
        return tinf._combine_shift(tinf._log_final(vfin), ksum,
                                   shift).cpu().numpy()

    def norm(a):  # each (frame, graph) column over its max
        m = a.amax(dim=1, keepdim=True)
        return a / torch.where(m > 0, m, torch.ones_like(m))

    ak, *fk = bsc.fwd_sweep(kop, ext, msh)
    again = bsc.fwd_sweep(kop, ext, msh)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip((ak, *fk), again)), (
        "K5a: two runs differ")
    del again
    ap, *fp = bsc.fwd_sweep_plain(kop, ext, msh)
    zk, zp = logz(*fk), logz(*fp)
    fin = np.isfinite(zp)
    assert (np.isfinite(zk) == fin).all(), "K5a: -inf pattern differs"
    assert (fin.all() if inputs else fin[0] and fin[3] and not fin[1]
            and not fin[2]), "K5a: unexpected -inf pattern"
    errs = {"K5a": max(float(np.abs(zk[fin] - zp[fin]).max()),
                       float((norm(ak) - norm(ap)).abs().max()))}
    pk = bsc.backward(kop, ext, ak)
    torch.cuda.synchronize()
    assert torch.equal(pk, bsc.backward(kop, ext, ak)), "K5b: two runs differ"
    pp = bsc.backward_plain(kop, ext, ak)
    assert torch.isfinite(pk).all(), "K5b: non-finite posteriors"
    assert inputs or (pk[:, :, 1:3] == 0).all(), (
        "K5b: infeasible graphs not zero")
    outside = ~plan_mask(kop)
    assert (pk[:, outside] == 0).all(), (
        "K5b: a posterior outside its graph's plan is not 0")
    smem = check_modes(kop, bsc._kernel_modes(kop))
    print(f"{label}: P={P}: K5a and K5b run twice, bit-equal; K5b's "
          f"posteriors at the {int(outside.sum())} of {outside.numel()} "
          f"(pdf, graph) pairs outside the graphs' plans exactly 0 in all "
          f"{pk.shape[0]} frames; shared memory per CTA K5a {smem[0]} B, "
          f"K5b {smem[1]} B (the admission's figures)")
    errs["K5b"] = float((pk - pp).abs().max())
    for name, e in errs.items():
        print(f"{label}: P={P}: {name} kernel vs plain max |err| = {e:.3e} "
              f"(tol {tol:g})")
        assert np.isfinite(e) and e <= tol, f"{name} disagrees: {e}"
    return errs


def skip_numerators(P, lengths, seed):
    """Numerator lattices with skip arcs (i -> i + 2 besides the self-loop
    and the chain: three band offsets), the last over 3 pdfs only (each
    repeated).  Returns [(fsm, spdf)]."""
    import markovmodels_tpu_torch as mt

    rng = np.random.default_rng(seed)
    out = []
    for g, Lp in enumerate(lengths):
        seq = rng.integers(0, 3 if g == len(lengths) - 1 else P, size=Lp)
        arcs = ([((i, i), np.log(0.5)) for i in range(Lp)]
                + [((i, i + 1), np.log(0.3)) for i in range(Lp - 1)]
                + [((i, i + 2), np.log(0.2)) for i in range(Lp - 2)])
        fsm = mt.fsm.FSM.from_pairs(
            [(0, 0.0)], arcs, [(Lp - 1, np.log(0.5))],
            [mt.labels.Label(int(s)) for s in seq], mt.semiring.LOG)
        out.append((fsm, np.append(seq, P).astype(np.int32)))
    return out


def phase_banded_oracle(P, dev):
    """Phase 8: stacked-numerator pdfposteriors through K5a/K5b against
    the exact f64 host oracle: 4 lattices of 10-38 states at N=40, then 4
    lattices with skip arcs (offsets (0, 1, 2): the kernels' loop over
    the offsets past the second) of 10-130 states (Sp = 136: 5 states per
    lane) at N=150, where K5a and K5b are also held to their twins."""
    import torch

    import markovmodels_tpu_torch as mt
    from markovmodels_tpu_torch.ops import banded_scan as bsc
    from markovmodels_tpu_torch.ops.emissions import prepare_emissions

    rng = np.random.default_rng(5)
    chains = []
    for Lp in (10, 20, 30, 38):
        chains += build_numerators(P, G=1, Lp=Lp, seed=int(rng.integers(99)))
    for graphs, n, lens in (
            (chains, 40, [40, 35, 40, 39]),
            (skip_numerators(P, (10, 60, 130, 40), seed=6), 150,
             [150, 120, 150, 9])):
        num_cf = stack_numerators(graphs, P, dev)
        lhs = rng.normal(size=(4, n, P)).astype(np.float32)
        lens = np.array(lens, dtype=np.int32)
        tl, tn = torch.from_numpy(lhs).to(dev), torch.from_numpy(lens).to(dev)
        posts, z = mt.pdfposteriors(num_cf, tl, tn)
        z, posts = z.cpu().numpy(), posts.cpu().numpy()
        err = perr = 0.0
        for g, (fsm, spdf) in enumerate(graphs):
            rz, rp = mt.oracle.host_oracle(fsm, spdf, P,
                                           lhs[g:g + 1].astype(np.float64),
                                           lens[g:g + 1])
            fin = np.isfinite(rz[0])
            assert np.isfinite(z[g]) == fin, "feasibility differs"
            if fin:
                err = max(err, float(np.abs(z[g] - rz[0])))
            perr = max(perr, float(np.abs(posts[g] - rp[0]).max()))
        kop = bsc.kernel_operator(num_cf)
        tag = (f"G=4 N={n}, Sp = {kop.Sp}, offsets {kop.offsets}")
        print(f"phase 8: numerators {tag} vs f64 oracle |dlogZ| = "
              f"{err:.3e}, |dposts| = {perr:.3e} (tol {TOL_ORACLE:g})")
        assert err <= TOL_ORACLE and perr <= TOL_ORACLE, "oracle gate failed"
        if len(kop.offsets) > 2:
            ext, msh = prepare_emissions(tl, tn, P)
            fk = bsc.fwd_sweep(kop, ext, msh)
            fp = bsc.fwd_sweep_plain(kop, ext, msh)
            ka = float((fk[0] - fp[0]).abs().max())
            kb = float((bsc.backward(kop, ext, fk[0])
                        - bsc.backward_plain(kop, ext, fk[0])).abs().max())
            print(f"phase 8: {tag}: K5a alphas vs plain max |err| = "
                  f"{ka:.3e}, K5b {kb:.3e} (tol {TOL_K5:g})")
            assert ka <= TOL_K5 and kb <= TOL_K5, "K5 disagrees with its twin"


def check_modes(kop, want, sizes=None, label=None):
    """The instantiations K5a and K5b take for the kernels' operator
    ``kop``: the admission's (``banded_scan._modes``), the library's and
    ``want``; the cluster's CTAs a graph (``_cluster_sizes``, the
    library's, ``sizes`` where given); and the admission's shared memory,
    the kernels'.  Where a kernel takes the cluster instantiation, asserts
    that the card holds such a cluster (cudaOccupancyMaxActiveClusters)
    and prints how many at once.  Returns the shared-memory bytes of
    each."""
    import ctypes

    from markovmodels_tpu_torch.ops import _build
    from markovmodels_tpu_torch.ops import banded_scan as bsc

    lib = _build.library()
    dims = bsc._kop_dims(kop)
    tw = dims[2]
    cs = bsc._cluster_sizes(*dims)
    metas = [bsc._imeta(kop, 1, False, c) for c in cs]
    ptrs = [ctypes.c_void_p(m.ctypes.data) for m in metas]
    modes = bsc._modes(*dims)
    lm = tuple(bsc.MODES[lib.mm_banded_mode(ptrs[k], k, tw - 1)]
               for k in (0, 1))
    assert modes == lm == want, (modes, lm, want)
    lc = tuple(lib.mm_banded_cluster(ptrs[k], k, tw - 1) for k in (0, 1))
    assert cs == lc and (sizes is None or cs == tuple(sizes)), (cs, lc,
                                                                 sizes)
    smem = [lib.mm_banded_smem(ptrs[k], k, tw - 1) for k in (0, 1)]
    assert smem == [4 * w for w in bsc._smem_words(*dims)], (
        f"admission's shared memory {bsc._smem_words(*dims)} words, the "
        f"kernels' {smem} bytes")
    for k, c in enumerate(cs):
        if c:
            held = lib.mm_banded_resident(ptrs[k], k, tw - 1, c)
            assert held > 0, held
            print(f"{label or 'modes'}: K5{'ab'[k]} cluster of {c} "
                  f"({smem[k]} B a CTA): the card holds {held} clusters at "
                  f"once, {kop.G} graphs take {-(-kop.G // held)} wave(s)")
    return smem


def rel_err(k, p):
    """max |k - p| over max |p| (0 where both are 0), in float64."""
    d = float((k.double() - p.double()).abs().max())
    m = float(p.double().abs().max())
    return d / m if m > 0 else d


def held_to_twins(kop, ext, msh, label, rel_tol=TOL_REL_K5):
    """K5a and K5b on the card each run twice (bit-equal) and against their
    plain twins: within TOL_K5 (absolute) and ``rel_tol`` (relative to the
    float64 twins; None: printed only, where a frame's gamma sum is
    subnormal and so carries fewer bits than 1e-12 needs); K5b's
    posteriors finite and 0 outside each graph's plan.  Returns {"K5a":
    err, "K5b": err} (absolute) and prints the relative errors beside
    them."""
    import torch

    from markovmodels_tpu_torch.ops import banded_scan as bsc

    fk, again = bsc.fwd_sweep(kop, ext, msh), bsc.fwd_sweep(kop, ext, msh)
    pk, pk2 = bsc.backward(kop, ext, fk[0]), bsc.backward(kop, ext, fk[0])
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(fk, again)), "K5a: runs"
    assert torch.equal(pk, pk2), "K5b: two runs differ"
    assert torch.isfinite(pk).all(), "K5b: non-finite posteriors"
    assert (pk[:, ~plan_mask(kop)] == 0).all(), "K5b: outside the plan"
    del again, pk2
    fp = bsc.fwd_sweep_plain(kop, ext, msh)
    pairs = [(a, b) for a, b in zip(fk, fp) if a is not None]
    errs = {"K5a": max(float((a - b).abs().max()) for a, b in pairs)}
    rel = {"K5a": max(rel_err(a, b) for a, b in pairs)}
    del fp, pairs
    p64 = bsc.backward_plain(kop, ext, fk[0], dtype=torch.float64)
    errs["K5b"] = float((pk - bsc.backward_plain(kop, ext, fk[0])).abs()
                        .max())
    f32 = pk.dtype != torch.float64
    if f32:  # the float64 value within the tolerance, then its rounding
        past = ((pk.double() - p64).abs() - p64.abs() * 2.0 ** -24).max()
        m = float(p64.abs().max())  # 0 where no lattice reaches its end
        rel["K5b"] = max(float(past), 0.0) / (m if m > 0 else 1.0)
    else:
        rel["K5b"] = rel_err(pk, p64)
    del fk, pk, p64
    torch.cuda.empty_cache()
    print(f"{label}: K5a and K5b run twice, bit-equal; kernel vs plain max "
          f"|err| K5a {errs['K5a']:.3e}, K5b {errs['K5b']:.3e} "
          f"(tol {TOL_K5:g}); relative to the float64 twins K5a "
          f"{rel['K5a']:.3e}, K5b {rel['K5b']:.3e}"
          + (" past float32's rounding" if f32 else "")
          + (f" (tol {rel_tol:g})" if rel_tol else " (not gated)"))
    assert all(np.isfinite(e) and e <= TOL_K5 for e in errs.values()), errs
    assert rel_tol is None or all(e <= rel_tol for e in rel.values()), rel
    return errs


def phase_big_numerators(cf, P, dev, t_step, lengths=(1200, 1180, 1150, 1199),
                         N=700, lens=(700, 690, 640, 700), label="phase 8b",
                         instantiation="wide"):
    """Phase 8b: stacked numerators past the narrow K5's 1,024 states
    (lattices with skip arcs: three offsets) take K5's wide instantiation
    (~1,200 states) or its global one (~3,000): 4 of them through
    ``pdfposteriors`` and ``lfmmi_loss`` with the 2M-arc denominator
    against the f64 oracle, the route line and the admission's
    instantiations and shared memory against the kernels'; then a G=128
    stack of them: K5a and K5b each run twice (bit-equal) and held to
    their twins, through the training step (the counts set to 0 before
    it, one launch each after it), timed beside the Sp = 80 step
    (``t_step``, N=700), and timed.  N frames (a path crosses at most two
    states a frame, and with few frames to spare the skips' share puts the
    final state's mass past float64's range against the frame's max: a
    ~3,000-state lattice takes N=2,400), the lattices' lengths ``lens``
    (tiled over the G=128 stack).  Returns (t_big, launches, errs,
    times, bounds) of the G=128 stack."""
    import torch

    import markovmodels_tpu_torch as mt
    from markovmodels_tpu_torch.ops import banded_scan as bsc
    from markovmodels_tpu_torch.ops import block_scan as bs
    from markovmodels_tpu_torch.ops.emissions import prepare_emissions

    graphs = skip_numerators(P, lengths, seed=7)
    compiled = [mt.compile_fsm(f, sp, P, strategy="banded", device=dev)
                for f, sp in graphs]
    num = mt.stack(compiled)
    Sp, nO = num.padded_states, len(num.banded_offsets)
    report = mt.fast_path_report(num, 4)
    print(f"{label}: 4 skip-arc numerators, Sp = {Sp}, offsets "
          f"{num.banded_offsets}; path: {report}")
    assert report.startswith("cuda-banded-scan") and Sp > 1024, report
    smem = check_modes(bsc.kernel_operator(num), (instantiation,) * 2,
                       label=label)
    rng = np.random.default_rng(8)
    lhs = rng.normal(size=(4, N, P)).astype(np.float32)
    lens = np.array(lens, dtype=np.int32)
    tl, tn = torch.from_numpy(lhs).to(dev), torch.from_numpy(lens).to(dev)
    bsc.reset_launch_counts()
    posts, z = mt.pdfposteriors(num, tl, tn)
    x = tl.clone().requires_grad_()
    loss = mt.lfmmi_loss(num, cf, x, tn)
    loss.sum().backward()
    torch.cuda.synchronize()
    counts = dict(bsc.LAUNCHES)
    assert all(v > 0 for v in counts.values()), counts
    pd, zd = mt.pdfposteriors(cf, tl, tn)
    z_, posts_ = z.cpu().numpy(), posts.cpu().numpy()
    err = perr = 0.0
    for g, (fsm, spdf) in enumerate(graphs):
        rz, rp = mt.oracle.host_oracle(fsm, spdf, P,
                                       lhs[g:g + 1].astype(np.float64),
                                       lens[g:g + 1])
        assert np.isfinite(rz[0]) and np.isfinite(z_[g]), "infeasible"
        err = max(err, float(np.abs(z_[g] - rz[0])))
        perr = max(perr, float(np.abs(posts_[g] - rp[0]).max()))
    lerr = float((loss - (zd - z)).abs().max())
    gerr = float((x.grad - (pd - posts)).abs().max())
    print(f"{label}: pdfposteriors G=4 N={N} vs f64 oracle |dlogZ| = "
          f"{err:.3e}, |dposts| = {perr:.3e} (tol {TOL_ORACLE:g}); "
          f"lfmmi_loss with the 2M-arc denominator: |loss - (logZ_den - "
          f"logZ_num)| = {lerr:.3e}, |grad - (posts_den - posts_num)| = "
          f"{gerr:.3e} (tol {TOL_GRAD:g}); K5 launches {json.dumps(counts)}; "
          f"shared memory per CTA K5a {smem[0]} B, K5b {smem[1]} B")
    assert err <= TOL_ORACLE and perr <= TOL_ORACLE, "oracle gate failed"
    assert lerr <= TOL_ORACLE and gerr <= TOL_GRAD, "loss or gradient"
    del posts, x, loss, pd

    big = mt.stack(compiled * 32)
    lhs = torch.from_numpy(make_inputs(np.random.default_rng(0), 128, N,
                                       P)).to(dev)
    lens = torch.from_numpy(np.tile(lens, 32)).to(dev)
    kop = bsc.kernel_operator(big)
    check_modes(kop, (instantiation,) * 2, label=f"{label}: G=128")
    ext, msh = prepare_emissions(lhs, lens, P)
    errs = held_to_twins(kop, ext, msh, f"{label}: G=128 N={N} "
                                        f"({bsc.instantiations(big)})")

    def step():
        x = lhs.clone().requires_grad_()
        loss = mt.lfmmi_loss(big, cf, x, lens)
        loss.sum().backward()
        return loss.detach(), x.grad

    for m in (bs, bsc):
        m.reset_launch_counts()
    loss, grad = step()
    torch.cuda.synchronize()
    counts = {**bs.LAUNCHES, **bsc.LAUNCHES}
    assert (bsc.LAUNCHES == {"banded_fwd": 1, "banded_bwd": 1}
            and bs.LAUNCHES["block_fwd"] == 1), counts
    launches = dict(bsc.LAUNCHES)
    pn, zn = mt.pdfposteriors(big, lhs, lens)
    pd, zd = mt.pdfposteriors(cf, lhs, lens)
    assert torch.isfinite(zn).all(), "infeasible numerator"
    lerr = float((loss - (zd - zn)).abs().max())
    gerr = float((grad - (pd - pn)).abs().max())
    print(f"{label}: LF-MMI step G=128 N={N}: |loss - (logZ_den - "
          f"logZ_num)| = {lerr:.3e}, |grad - (posts_den - posts_num)| = "
          f"{gerr:.3e} (tol {TOL_GRAD:g})")
    assert lerr <= TOL_ORACLE and gerr <= TOL_GRAD, "loss or gradient"
    del loss, grad, pn, pd
    t_big = cuda_ms(step, reps=2)
    print(f"{label}: LF-MMI step B=G=128 N={N} with the ~{lengths[0]:,}-"
          f"state numerators (path: {mt.fast_path_report(big, 128)}): "
          f"{t_big:.2f} ms, beside the Sp = 80 step's {t_step:.2f} ms "
          f"(N=700); launches {json.dumps(counts)}")
    times = time_banded(big, P, dev, (ext, msh),
                        f"{instantiation}, Sp = {Sp}, N = {N}")
    return t_big, launches, errs, times, banded_bounds(big, N + 1)


def phase_longest_numerators(P, dev, N=128, label="phase 8b"):
    """Phase 8b, last: a G=128 stack at Sp = 24,576 with three offsets,
    the JAX package's own fused bound at G = 128 ((3 + 5) Sp G 4 B =
    96 MiB), which K5's cluster instantiation takes: a ~24,575-state
    skip-arc lattice beside three of 150-200 states (which reach their end
    in N = 128 frames; the long one cannot, so its alphas are 0 past the
    first few hundred states), 32 of each.  ``pdfposteriors`` through the
    kernels (the counts set to 0 before it, one launch each after it),
    K5a and K5b each run twice (bit-equal) and held to their twins, and
    timed.  Returns (launches, errs, times, bounds)."""
    import torch

    import markovmodels_tpu_torch as mt
    from markovmodels_tpu_torch.ops import banded_scan as bsc
    from markovmodels_tpu_torch.ops.emissions import prepare_emissions

    t0 = time.perf_counter()
    graphs = skip_numerators(P, (24575, 200, 180, 150), seed=9)
    compiled = [mt.compile_fsm(f, sp, P, strategy="banded", device=dev)
                for f, sp in graphs]
    big = mt.stack(compiled * 32)
    Sp, nO = big.padded_states, len(big.banded_offsets)
    assert Sp == 24576 and nO == 3, (Sp, nO)
    assert (nO + 5) * Sp * 128 * 4 <= 96 * 1024 * 1024  # JAX's VMEM rule
    check_modes(bsc.kernel_operator(big), (bsc.CLUSTER,) * 2, (4, 8),
                label=label)
    lhs = torch.from_numpy(make_inputs(np.random.default_rng(10), 128, N,
                                       P, cliffs=True)).to(dev)
    lens = torch.from_numpy(np.tile(np.array([N, N - 8, N - 16, N],
                                             dtype=np.int32), 32)).to(dev)
    bsc.reset_launch_counts()
    posts, z = mt.pdfposteriors(big, lhs, lens)
    torch.cuda.synchronize()
    launches = dict(bsc.LAUNCHES)
    assert launches == {"banded_fwd": 1, "banded_bwd": 1}, launches
    z = z.cpu().numpy().reshape(32, 4)
    assert np.isneginf(z[:, 0]).all() and np.isfinite(z[:, 1:]).all(), z
    mass = posts.double().sum(dim=2)
    want = (torch.arange(N, device=dev)[None, :] < lens[:, None]).double()
    want[0::4] = 0  # the longest lattice cannot reach its end
    merr = float((mass - want).abs().max())
    print(f"{label}: G=128 N={N}, Sp = {Sp} ({nO} offsets; compiled and "
          f"stacked in {time.perf_counter() - t0:.1f} s), path: "
          f"{mt.fast_path_report(big, 128)}; launches "
          f"{json.dumps(launches)}; posterior mass per active frame vs 1 "
          f"(0 for the infeasible lattice) max |err| {merr:.3e} "
          f"(tol {TOL_POST_SUM:g})")
    assert merr <= TOL_POST_SUM, merr
    del posts
    kop = bsc.kernel_operator(big)
    ext, msh = prepare_emissions(lhs, lens, P)
    errs = held_to_twins(kop, ext, msh, f"{label}: G=128 N={N}, Sp = {Sp} "
                                        f"({bsc.instantiations(big)})")
    times = time_banded(big, P, dev, (ext, msh),
                        f"cluster, Sp = {Sp}, N = {N}")
    return launches, errs, times, banded_bounds(big, N + 1)


def phase_numerator_stack(P, dev, lengths, N, lens, want, G=128, seed=5,
                          label="phase 8b"):
    """Phase 8b: a stack of G skip-arc lattices (``lengths`` tiled) at N
    frames, lengths ``lens``: the instantiations ``want`` it takes (the
    admission's and the library's), ``pdfposteriors`` through the kernels
    (the counts set to 0 before it, one launch each after it), K5a and K5b
    each run twice (bit-equal) and held to their twins, and timed.
    Returns (launches, errs, times, bounds)."""
    import torch

    import markovmodels_tpu_torch as mt
    from markovmodels_tpu_torch.ops import banded_scan as bsc
    from markovmodels_tpu_torch.ops.emissions import prepare_emissions

    t0 = time.perf_counter()
    graphs = skip_numerators(P, lengths, seed=seed)
    compiled = [mt.compile_fsm(f, sp, P, strategy="banded", device=dev)
                for f, sp in graphs]
    big = mt.stack(compiled * (G // len(lengths)))
    kop = bsc.kernel_operator(big)
    check_modes(kop, want, label=label)
    lhs = torch.from_numpy(make_inputs(np.random.default_rng(seed), G, N,
                                       P, cliffs=True)).to(dev)
    lens = torch.from_numpy(np.tile(np.array(lens, dtype=np.int32),
                                    G // len(lengths))).to(dev)
    bsc.reset_launch_counts()
    posts, z = mt.pdfposteriors(big, lhs, lens)
    torch.cuda.synchronize()
    launches = dict(bsc.LAUNCHES)
    assert launches == {"banded_fwd": 1, "banded_bwd": 1}, launches
    assert torch.isfinite(posts).all(), "non-finite posteriors"
    print(f"{label}: G={G} N={N}, Sp = {kop.Sp} (compiled and stacked in "
          f"{time.perf_counter() - t0:.1f} s), path: "
          f"{mt.fast_path_report(big, G)}; launches {json.dumps(launches)}")
    del posts, z
    ext, msh = prepare_emissions(lhs, lens, P)
    errs = held_to_twins(kop, ext, msh, f"{label}: G={G} N={N}, Sp = "
                                        f"{kop.Sp} ({bsc.instantiations(big)})")
    times = time_banded(big, P, dev, (ext, msh),
                        f"{bsc.instantiations(big)}, N = {N}")
    for name, (t, _) in times.items():
        print(f"{label}: {name} at Sp = {kop.Sp}: {1e3 * t / (N + 1):.2f} us "
              "a frame")
    return launches, errs, times, banded_bounds(big, N + 1)


def rank_masses(kop, C, x):
    """(C, G) float64: the mass of ``x`` (Nf, Sp, G), summed over frames, in
    each cluster CTA's range of states (``banded_scan._range_len``)."""
    from markovmodels_tpu_torch.ops import banded_scan as bsc

    L = bsc._range_len(kop.Sp, C)
    return np.array([x[:, r * L:(r + 1) * L].double().sum(dim=(0, 1))
                     .cpu().numpy() for r in range(C)])


def phase_cluster_ranks(P, dev, dtype, G=8, N=6000,
                        lengths=(6500, 6450, 6400, 6490),
                        lens=(6000, 5980, 5950, 6000), label="phase 8b"):
    """Phase 8b: a stack long enough that K5a and K5b both run on clusters
    of more than one CTA (Sp = 6,504: 2 and 3 CTAs a graph, in float32
    and in float64), and feasible (every lattice reaches its end: a path
    crosses at most two states a frame, but at N = 5,600 the final
    state's mass already falls past float64's range and every lattice is
    lost), so that the alphas and the gammas carry mass in every CTA's
    range of every graph (asserted) and every frame's edge states, keys,
    omega dots and pdf partials cross the CTAs.  ``pdfposteriors``
    through the kernels (the counts set to 0 before it, one launch each
    after it), logZ finite; K5a and K5b twice (bit-equal) and held to
    their twins (``held_to_twins``: the relative gate); timed.  Returns
    (launches, errs, times, bounds)."""
    import torch

    import markovmodels_tpu_torch as mt
    from markovmodels_tpu_torch.ops import banded_scan as bsc
    from markovmodels_tpu_torch.ops.emissions import prepare_emissions

    t0 = time.perf_counter()
    name = "float64" if dtype == torch.float64 else "float32"
    graphs = skip_numerators(P, lengths, seed=13)
    big = mt.stack([mt.compile_fsm(f, sp, P, strategy="banded", dtype=dtype,
                                   device=dev) for f, sp in graphs]
                   * (G // len(lengths)))
    kop = bsc.kernel_operator(big)
    check_modes(kop, (bsc.CLUSTER,) * 2, (2, 3), label=label)
    lhs = torch.from_numpy(make_inputs(np.random.default_rng(13), G, N,
                                       P)).to(dev, dtype)
    lens_t = torch.from_numpy(np.tile(np.array(lens, dtype=np.int32),
                                      G // len(lengths))).to(dev)
    counts = bsc._counts(dtype)
    bsc.reset_launch_counts()
    posts, z = mt.pdfposteriors(big, lhs, lens_t)
    torch.cuda.synchronize()
    launches = dict(counts)
    assert launches == {"banded_fwd": 1, "banded_bwd": 1}, launches
    assert counts is bsc.LAUNCHES or not any(bsc.LAUNCHES.values())
    assert torch.isfinite(z).all(), "a lattice does not reach its end"
    mass = posts.double().sum(dim=2)
    want = (torch.arange(N, device=dev)[None, :] < lens_t[:, None]).double()
    merr = float((mass - want).abs().max())
    assert merr <= TOL_POST_SUM, merr
    del posts, z, mass
    ext, msh = prepare_emissions(lhs, lens_t, P, dtype)
    alphas = bsc.fwd_sweep(kop, ext, msh)[0]
    ca, cb = bsc._kernel_clusters(kop)
    am = rank_masses(kop, ca, alphas)
    gsum = torch.zeros((kop.Sp, G), dtype=torch.float64, device=dev)
    for _, g in bsc.gammas_plain(kop, ext, alphas):
        gsum += g
    gm = rank_masses(kop, cb, gsum[None])
    del alphas, gsum
    print(f"{label}: {name} G={G} N={N}, Sp = {kop.Sp} (compiled and "
          f"stacked in {time.perf_counter() - t0:.1f} s), path: "
          f"{mt.fast_path_report(big, G)}; launches {json.dumps(launches)}; "
          f"posterior mass per active frame vs 1 max |err| {merr:.3e} (tol "
          f"{TOL_POST_SUM:g}); least alpha mass in a K5a CTA's range "
          f"{am.min():.3e} (of {ca} a graph), least gamma mass in a K5b "
          f"CTA's range {gm.min():.3e} (of {cb})")
    assert (am > 0).all() and (gm > 0).all(), (am, gm)
    errs = held_to_twins(kop, ext, msh, f"{label}: {name} G={G} N={N}, "
                                        f"Sp = {kop.Sp} "
                                        f"({bsc.instantiations(big)})")
    times = time_banded(big, P, dev, (ext, msh),
                        f"{bsc.instantiations(big)}, G={G}, N = {N}")
    return launches, errs, times, banded_bounds(big, N + 1)


def phase_narrow_subnormal(P, dev, Lp=780, N=394, label="phase 8c"):
    """Phase 8c: a barely feasible narrow lattice: 4 skip-arc lattices of
    ``Lp`` states (Sp = 784, three offsets: K5b's narrow instantiation)
    at N frames, about their shortest path (a path crosses at most two
    states a frame), where a frame's gamma sum falls below float64's
    normal range (its reciprocal overflows).  K5a and K5b each run twice
    (bit-equal) and against their twins, which divide by the sum; K5b's
    posteriors finite.  Prints the frames whose gamma sum is subnormal."""
    import torch

    import markovmodels_tpu_torch as mt
    from markovmodels_tpu_torch.ops import banded_scan as bsc
    from markovmodels_tpu_torch.ops.emissions import prepare_emissions

    graphs = skip_numerators(P, (Lp,) * 4, seed=21)
    num = mt.stack([mt.compile_fsm(f, sp, P, strategy="banded", device=dev)
                    for f, sp in graphs])
    kop = bsc.kernel_operator(num)
    check_modes(kop, (bsc.NARROW,) * 2, label=label)
    rng = np.random.default_rng(0)
    lhs = torch.from_numpy(rng.normal(size=(4, N, P)).astype(
        np.float32)).to(dev)
    lens = torch.full((4,), N, dtype=torch.int32, device=dev)
    ext, msh = prepare_emissions(lhs, lens, P)
    errs = held_to_twins(kop, ext, msh, f"{label}: Sp = {kop.Sp} N={N}",
                         rel_tol=None)
    alphas = bsc.fwd_sweep_plain(kop, ext, msh)[0]
    tots = torch.stack([g.sum(dim=0) for _, g in
                        bsc.gammas_plain(kop, ext, alphas)])
    sub = (tots > 0) & (tots < 2.0 ** -1022)
    print(f"{label}: {int(sub.sum())} of {tots.numel()} (frame, graph) "
          f"gamma sums subnormal (least {float(tots[tots > 0].min()):.3e}), "
          f"{int((tots == 0).sum())} zero: the narrow K5b divides there, "
          "its posteriors finite and held to the twin")
    assert sub.any(), "no subnormal gamma sum: the repair is not exercised"
    return errs


def launch_counts(mods, bf16=False):
    """The launch counts of the ops modules ``mods``; with ``bf16``, those of
    the bf16 instantiations (``LAUNCHES_BF16``, keys suffixed ``_bf16``)
    where a module has them, after asserting that its float32 ones stayed
    0 (no float32 kernel ran for a bf16 graph)."""
    out = {}
    for m in mods:
        if bf16 and hasattr(m, "LAUNCHES_BF16"):
            assert not any(m.LAUNCHES.values()), (
                f"a float32 kernel ran for a bf16 graph: {m.LAUNCHES}")
            out.update({f"{k}_bf16": v for k, v in m.LAUNCHES_BF16.items()})
        else:
            out.update(m.LAUNCHES)
    return out


def phase_step(num_cf, cf, P, dev, mods, label, B=128, N=700, bf16=False):
    """Phase 9 (13, 21, 26-28): the LF-MMI training step through the kernels
    of the ops modules ``mods`` (with ``bf16``: their bf16 instantiations),
    checked and timed beside the denominator-only pdfposteriors."""
    import torch

    import markovmodels_tpu_torch as mt

    rng = np.random.default_rng(0)
    lhs = torch.from_numpy(make_inputs(rng, B, N, P)).to(dev)
    lengths = torch.full((B,), N, dtype=torch.int32, device=dev)

    def step():
        x = lhs.clone().requires_grad_()
        loss = mt.lfmmi_loss(num_cf, cf, x, lengths)
        loss.sum().backward()
        return loss.detach(), x.grad

    torch.cuda.synchronize()
    for m in mods:
        m.reset_launch_counts()
    loss, grad = step()
    torch.cuda.synchronize()
    launches = launch_counts(mods, bf16)
    # K6t belongs to the Viterbi decode: the step must not launch it
    assert not launches.pop("dense_trop", 0), "the step launched K6t"
    print(f"{label}: launches {json.dumps(launches)}")
    assert all(v > 0 for v in launches.values()), "a kernel never launched"

    assert torch.isfinite(loss).all(), "non-finite LF-MMI loss"
    pn, zn = mt.pdfposteriors(num_cf, lhs, lengths)
    pd, zd = mt.pdfposteriors(cf, lhs, lengths)
    assert torch.isfinite(zn).all(), "infeasible numerator"
    lerr = float((loss - (zd - zn)).abs().max())
    gerr = float((grad - (pd - pn)).abs().max())
    gsum = float(grad.sum(dim=2).abs().max())
    print(f"{label}: loss sum {float(loss.sum()):.4f}; |loss - (logZ_den - "
          f"logZ_num)| = {lerr:.3e}; |grad - (posts_den - posts_num)| = "
          f"{gerr:.3e} (tol {TOL_GRAD:g}); max |sum_p grad| = {gsum:.3e} "
          f"(tol {TOL_GRAD_SUM:g})")
    assert lerr <= TOL_ORACLE, "loss differs from the separate logZ"
    assert gerr <= TOL_GRAD, "gradient is not posts_den - posts_num"
    assert gsum <= TOL_GRAD_SUM, "gradient does not sum to 0 over pdfs"

    t_step = cuda_ms(step, reps=2)
    t_den = cuda_ms(lambda: mt.pdfposteriors(cf, lhs, lengths), reps=2)
    audio = B * N * FRAME_SHIFT_S
    print(f"{label}: LF-MMI step B={B} N={N} (num + den + grad): "
          f"{t_step / 1e3:.4f} s = {audio / (t_step / 1e3):.1f} audio-s/s; "
          f"den-only pdfposteriors {t_den / 1e3:.4f} s = "
          f"{audio / (t_den / 1e3):.1f} audio-s/s; ratio "
          f"{t_step / t_den:.3f}")
    return launches, t_step, t_den


def time_banded(num_cf, P, dev, inputs=None, tag=None):
    """K5a and K5b and their plain twins over the whole 701-frame sweep at
    the numerators' main shape, ``P`` pdfs (or on ``inputs``, (ext,
    mshift))."""
    from markovmodels_tpu_torch.ops import banded_scan as bsc

    kop = bsc.kernel_operator(num_cf)
    ext, msh = inputs or banded_inputs(num_cf, P, dev)
    alphas = bsc.fwd_sweep(kop, ext, msh)[0]
    calls = {
        "K5a": (lambda: bsc.fwd_sweep(kop, ext, msh),
                lambda: bsc.fwd_sweep_plain(kop, ext, msh)),
        "K5b": (lambda: bsc.backward(kop, ext, alphas),
                lambda: bsc.backward_plain(kop, ext, alphas)),
    }
    out = {}
    for name, (kern, plain) in calls.items():
        p1, k1, k2, p2 = (cuda_ms(plain), cuda_ms(kern, reps=5),
                          cuda_ms(kern, reps=5), cuda_ms(plain))
        out[name] = ((k1 + k2) / 2, (p1 + p2) / 2)
        print(f"timing: {name} at P={P}{', ' + tag if tag else ''}: kernel "
              f"{k1:.3f}/{k2:.3f} ms, plain {p1:.3f}/{p2:.3f} ms")
    return out


def dense_inputs(P, dev, B=128, N=700, seed=2, dtype=None):
    """Phase 11's input: mixed lengths with 1 and N, ±30-nat cliffs; the
    emissions in ``dtype`` (float32 by default; float64 from float64
    log-likelihoods)."""
    import torch

    from markovmodels_tpu_torch.ops.emissions import prepare_emissions

    dtype = dtype or torch.float32
    rng = np.random.default_rng(seed)
    lhs = torch.from_numpy(make_inputs(rng, B, N, P, cliffs=True)).to(
        dev, dtype)
    lens = rng.integers(1, N + 1, size=B).astype(np.int32)
    lens[:4] = [N, 1, 2 * N // 3, N // 2 + 1]
    return prepare_emissions(lhs, torch.from_numpy(lens).to(dev), P, dtype)


def phase_dense_kernels(kop, P, dev, N=700, label="phase 11", tol=TOL_K6,
                        B=128):
    """Phase 11 (24, 42, 51): K6a and K6b on the operator ``kop`` against
    their plain twins on one input of ``B`` columns, each kernel run twice
    and bit-equal.  A float64 operator (phase 42) takes float64 emissions,
    and its logZ is held to the twin's relative to |logZ|
    (TOL_F64_LOGZ_REL)."""
    import torch

    from markovmodels_tpu_torch import inference as tinf
    from markovmodels_tpu_torch.ops import dense_scan as ds

    f64 = kop.alpha0.dtype == torch.float64
    ext, msh = dense_inputs(P, dev, B=B, N=N, dtype=kop.alpha0.dtype)
    a0 = kop.alpha0[:, None].expand(kop.Sp, B).contiguous()

    def logz(out):
        _, _, a, s, ksum, shift = out
        return tinf._combine_shift(tinf._log_final(a[kop.fin] * s), ksum,
                                   shift).cpu().numpy()

    def norm(a):  # each (frame, column) over its max
        m = a.amax(dim=1, keepdim=True)
        return a / torch.where(m > 0, m, torch.ones_like(m))

    fk = ds.fwd_sweep(kop, a0, ext, msh)
    again = ds.fwd_sweep(kop, a0, ext, msh)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(fk, again)), (
        "K6a is not bit-equal run to run")
    del again
    fp = ds.fwd_sweep_plain(kop, a0, ext, msh)
    zk, zp = logz(fk), logz(fp)
    fin = np.isfinite(zp)
    assert (np.isfinite(zk) == fin).all(), "K6a: -inf pattern differs"
    assert fin.sum() > B // 2 and fin[0], "K6a: unexpected -inf pattern"
    errs = {"K6a": max(float(np.abs(zk[fin] - zp[fin]).max()),
                       float((norm(fk[0]) - norm(fp[0])).abs().max()))}
    if f64:  # logZ relative to |logZ| beside the states' error
        zrel = float((np.abs(zk[fin] - zp[fin])
                      / np.maximum(np.abs(zp[fin]), 1.0)).max())
        print(f"{label}: K6a (float64) logZ vs its twin relative {zrel:.3e} "
              f"(tol {TOL_F64_LOGZ_REL:g}), absolute "
              f"{float(np.abs(zk[fin] - zp[fin]).max()):.3e}")
        assert zrel <= TOL_F64_LOGZ_REL, f"K6a float64 logZ: {zrel}"
        errs["K6a"] = max(zrel, float((norm(fk[0]) - norm(fp[0])).abs()
                                      .max()))
    del fp
    pk = ds.backward(kop, ext, fk[0], fk[1])
    again = ds.backward(kop, ext, fk[0], fk[1])
    torch.cuda.synchronize()
    assert torch.equal(pk, again), "K6b is not bit-equal run to run"
    del again
    pp = ds.backward_plain(kop, ext, fk[0], fk[1])
    assert torch.isfinite(pk).all(), "K6b: non-finite posteriors"
    errs["K6b"] = float((pk - pp).abs().max())
    for name, e in errs.items():
        print(f"{label}: {name} kernel vs plain at N={N} max |err| = {e:.3e} "
              f"(tol {tol:g}); run twice: bit-equal")
        assert np.isfinite(e) and e <= tol, f"{name} disagrees: {e}"
    return errs


def full_dense_op(dev, Sp=4096, P=96, bf16=False, seed=12, dtype=None):
    """A DenseOp with a random fully dense (Sp, Sp) operator (every 32 x 32
    tile non-zero; rows summing to ~0.5), random pdfs with the phony pdf P
    on the final state Sp - 1, random initial probabilities, in float32
    (``dtype`` float64: the same draws in float64): its tiles cannot stay
    in shared memory, so K6a/K6b stream them every frame."""
    import torch

    from markovmodels_tpu_torch.ops import dense_scan as ds

    rng = np.random.default_rng(seed)
    w = torch.from_numpy(
        (rng.uniform(0.01, 1.0, size=(Sp, Sp)) / Sp).astype(np.float32))
    spdf = np.append(rng.integers(0, P, size=Sp - 1), P)
    a0 = torch.from_numpy(rng.uniform(size=Sp).astype(np.float32))
    vdt = dtype or torch.float32
    wdt = torch.bfloat16 if bf16 else vdt
    w, a0 = w.to(dev, wdt), a0.to(vdt)
    return ds.dense_op(a0.to(dev), w, w.T.contiguous(),
                       torch.from_numpy(spdf).to(dev),
                       torch.arange(Sp, device=dev), P + 1, Sp - 1)


def phase_dense_full(dev, P=96, N=128):
    """Phase 11, second part: K6a and K6b on a fully dense operator at
    Sp = 4,096 (the largest 'dense' graph of compile_fsm's 'auto' rule),
    whose ranges are streamed, against their twins: whole sweeps in
    float32, then the bf16 instantiations one frame at a time; then K6t
    on it (``phase_trop_full``)."""
    from markovmodels_tpu_torch.ops import dense_scan as ds

    kop = full_dense_op(dev, P=P)
    pl = kop.pf
    print(f"phase 11: fully dense Sp = {kop.Sp}: {pl.tile_k.numel()} tiles "
          f"over {pl.lo.numel() - 1} CTAs, up to {pl.max_tiles} per range "
          f"({pl.max_tiles * 4608 / 1024:.0f} KB of float32 tiles per CTA: "
          "streamed)")
    errs = phase_dense_kernels(kop, P, dev, N=N,
                               label="phase 11 (fully dense Sp = 4,096)")
    errs.update(phase_dense_frames(full_dense_op(dev, P=P, bf16=True), P, dev,
                                   "phase 11 (fully dense Sp = 4,096, bf16)",
                                   N=N))
    errs["K6t"] = phase_trop_full(kop, P, dev, "phase 11")
    return errs


def phase_trop_full(kop, P, dev, label, N=16):
    """K6t on a fully dense operator (``full_dense_op``: 16.8 M non-zeros,
    every row's 4,096 entries one piece): against its twin at B = 128 and
    124 (``trop_checks``) and its frame split at B=128.  Returns max
    |K6t - twin|."""
    from markovmodels_tpu_torch.ops import dense_scan as ds

    top = ds.with_trop_plan(kop)
    pt = top.pt
    print(f"{label}: K6t's plan of the fully dense Sp = {top.Sp} operator "
          f"({top.wf.dtype}): {pt.src.numel()} entries in "
          f"{pt.pieces.shape[0]} pieces over {pt.wp.numel() - 1} warps, "
          f"{pt.n_partials} partial slots")
    err = trop_checks(top, lambda B_, N_: dense_inputs(
        P, dev, B=B_, N=N_, dtype=top.wf.dtype),
        f"{label} (fully dense Sp = 4,096, {top.wf.dtype})", Bs=(128, 124),
        N=N)
    ext, msh = dense_inputs(P, dev, B=128, N=N, dtype=top.wf.dtype)
    split = trop_frame_split(top, ext, msh, reps=1)
    print(f"{label}: K6t's frame on the fully dense operator (us, B=128): "
          + ", ".join(f"{k} {v:.2f}" for k, v in split.items()))
    return err


def random_graph(rng, S, P):
    """A non-banded graph: S states, three random out-arcs each (mass
    0.8), initial state 0, final weight 0.2 on every state, random pdfs.
    Returns (fsm, spdf)."""
    import markovmodels_tpu_torch as mt

    arcs = []
    for i in range(S):
        js = rng.choice(S, size=3, replace=False)
        w = rng.uniform(0.1, 1.0, size=3)
        w *= 0.8 / w.sum()
        arcs += [((i, int(j)), float(np.log(x))) for j, x in zip(js, w)]
    pdfs = rng.integers(0, P, size=S)
    fsm = mt.fsm.FSM.from_pairs(
        [(0, 0.0)], arcs, [(i, np.log(0.2)) for i in range(S)],
        [mt.labels.Label(int(p)) for p in pdfs], mt.semiring.LOG)
    return fsm, np.append(pdfs, P).astype(np.int32)


def phase_dense_stack(dev, P=24, n=40):
    """Phase 14: four stacked non-banded graphs (the default strategy picks
    'dense') through the per-graph route on the card, against the f64
    oracle; no K6 launch (the JAX package runs this route outside its
    dense kernels)."""
    import torch

    import markovmodels_tpu_torch as mt
    from markovmodels_tpu_torch.ops import dense_scan as ds

    rng = np.random.default_rng(9)
    graphs = [random_graph(rng, S, P) for S in (10, 25, 40, 57)]
    cf = mt.stack([mt.compile_fsm(f, sp, P, device=dev) for f, sp in graphs])
    assert cf.strategy == "dense" and cf.batched
    report = mt.fast_path_report(cf, 4)
    assert "per-graph" in report, report
    lhs = rng.normal(size=(4, n, P)).astype(np.float32)
    lens = np.array([n, 33, n, 21], dtype=np.int32)
    ds.reset_launch_counts()
    posts, z = mt.pdfposteriors(cf, torch.from_numpy(lhs).to(dev),
                                torch.from_numpy(lens).to(dev))
    z, posts = z.cpu().numpy(), posts.cpu().numpy()
    assert sum(ds.LAUNCHES.values()) == 0, "the per-graph route launched K6"
    err = perr = 0.0
    for g, (fsm, spdf) in enumerate(graphs):
        rz, rp = mt.oracle.host_oracle(fsm, spdf, P,
                                       lhs[g:g + 1].astype(np.float64),
                                       lens[g:g + 1])
        err = max(err, float(np.abs(z[g] - rz[0])))
        perr = max(perr, float(np.abs(posts[g] - rp[0]).max()))
    print(f"phase 14: stacked dense G=4 N={n} on {dev} ({report}) vs f64 "
          f"oracle |dlogZ| = {err:.3e}, |dposts| = {perr:.3e} "
          f"(tol {TOL_ORACLE:g})")
    assert err <= TOL_ORACLE and perr <= TOL_ORACLE, "oracle gate failed"


def time_dense(cf, P, dev):
    """K6a and K6b and their plain twins over the whole 701-frame sweep at
    the main shape (B=128, Sp=3,200), in the graph's dtype."""
    from markovmodels_tpu_torch.ops import dense_scan as ds

    kop = ds.kernel_operator(cf)
    ext, msh = dense_inputs(P, dev, dtype=kop.alpha0.dtype)
    B = ext.shape[2]
    a0 = kop.alpha0[:, None].expand(kop.Sp, B).contiguous()
    alphas, ascale = ds.fwd_sweep(kop, a0, ext, msh)[:2]
    calls = {
        "K6a": (lambda: ds.fwd_sweep(kop, a0, ext, msh),
                lambda: ds.fwd_sweep_plain(kop, a0, ext, msh)),
        "K6b": (lambda: ds.backward(kop, ext, alphas, ascale),
                lambda: ds.backward_plain(kop, ext, alphas, ascale)),
    }
    out = {}
    for name, (kern, plain) in calls.items():
        p1, k1, k2, p2 = (cuda_ms(plain), cuda_ms(kern), cuda_ms(kern),
                          cuda_ms(plain))
        out[name] = ((k1 + k2) / 2, (p1 + p2) / 2)
        print(f"timing: {name} kernel {k1:.3f}/{k2:.3f} ms, plain "
              f"{p1:.3f}/{p2:.3f} ms")
    return out


def matmul_yardstick(dcf, dev, B=128, Nf=701):
    """The dense scan's product alone as one PyTorch call per frame: the
    (Sp, Sp) @ (Sp, B) ``torch.matmul`` in the operator's dtype (float32,
    or float64) times Nf (a yardstick for K6a/K6b, which also rescale, emit
    and reduce; not a kernel of the port)."""
    import torch

    from markovmodels_tpu_torch.ops import dense_scan as ds

    kop = ds.kernel_operator(dcf)
    a = torch.rand((kop.Sp, B), device=dev).to(kop.wf.dtype)
    return Nf * cuda_ms(lambda: torch.matmul(kop.wf, a), reps=50)


def sparse_yardstick(dcf, dev, B=128, Nf=701):
    """A second yardstick for K6a/K6b: ``torch.sparse.mm`` of the forward
    operator as a CSR matrix by a (Sp, B) state, one PyTorch call per
    frame, times Nf (the product alone; not a kernel of the port).  In the
    operator's dtype; None where this PyTorch build does not multiply a
    CSR matrix of that dtype."""
    import torch

    from markovmodels_tpu_torch.ops import dense_scan as ds

    kop = ds.kernel_operator(dcf)
    csr = kop.wf.to_sparse_csr()
    a = torch.rand((kop.Sp, B), device=dev).to(kop.wf.dtype)
    try:
        torch.sparse.mm(csr, a)
    except RuntimeError as e:
        print(f"timing: torch.sparse.mm of a {kop.wf.dtype} CSR matrix: "
              f"not measured ({str(e).splitlines()[0]})")
        return None
    return Nf * cuda_ms(lambda: torch.sparse.mm(csr, a), reps=50)


def ms_or_not(t):
    return "not measured" if t is None else f"{t:.3f}"


def frame_floor(dcf, P, dev, N=700):
    """K6a and K6b on the graph's emissions and pdfs with an all-zero
    operator: no tile, so no product; what is left of a frame is the
    epilogue, the per-frame statistics and the grid barrier, in the
    graph's dtype.  Returns (K6a, K6b) microseconds per frame, CUDA
    events."""
    import torch

    from markovmodels_tpu_torch.ops import dense_scan as ds

    kop = ds.kernel_operator(dcf)
    zero = ds.dense_op(kop.alpha0, torch.zeros_like(kop.wf),
                       torch.zeros_like(kop.wb), kop.spdf, kop.perm.long(),
                       kop.P1, kop.fin)
    assert zero.pf.tile_k.numel() == zero.pb.tile_k.numel() == 0
    ext, msh = dense_inputs(P, dev, N=N, dtype=kop.alpha0.dtype)
    B = ext.shape[2]
    a0 = zero.alpha0[:, None].expand(zero.Sp, B).contiguous()
    alphas, ascale = ds.fwd_sweep(zero, a0, ext, msh)[:2]
    Nf = N + 1
    return (1e3 * cuda_ms(lambda: ds.fwd_sweep(zero, a0, ext, msh),
                          reps=3) / Nf,
            1e3 * cuda_ms(lambda: ds.backward(zero, ext, alphas, ascale),
                          reps=3) / Nf)


def profile_step(num_cf, cf, P, dev, label, B=128, N=700):
    """The LF-MMI step under torch.profiler: its device time by kernel and
    idle share, and the numerator kernels' device time and share of the
    busy time, printed; asserts one launch each of K5a and K5b.  Returns
    profile_device's result, or None."""
    import torch

    import markovmodels_tpu_torch as mt

    rng = np.random.default_rng(0)
    lhs = torch.from_numpy(make_inputs(rng, B, N, P)).to(dev)
    lens = torch.full((B,), N, dtype=torch.int32, device=dev)

    def step():
        x = lhs.clone().requires_grad_()
        mt.lfmmi_loss(num_cf, cf, x, lens).sum().backward()

    prof = profile_device(step)
    if prof is None:
        print(f"{label}: profile of the step: not measured (no device "
              "events recorded)")
        return None
    by_name, busy, span, counts = prof
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    print(f"{label}: profile of one LF-MMI step: device busy "
          f"{busy:.3f} ms of a {span:.3f} ms span (idle {1 - busy / span:.1%})"
          f"; " + "; ".join(f"{k} {v:.3f} ms ({counts[k]} launches)"
                            for k, v in top))
    k5 = {k: v for k, v in by_name.items() if k.startswith("banded_")}
    assert sorted(counts[k] for k in k5) == [1, 1] and any(
        k.startswith("banded_fwd") for k in k5), f"K5 launches {counts}"
    print(f"{label}: numerator kernels in the step: " + "; ".join(
        f"{k} {v:.3f} ms" for k, v in sorted(k5.items()))
        + f"; K5a + K5b {sum(k5.values()):.3f} ms = "
        f"{sum(k5.values()) / busy:.1%} of the busy time")
    return prof


def profile_dense_step(num_cf, cf, P, dev, label):
    """profile_step with a dense denominator; asserts one launch of each
    sweep kernel (K6a and K6b: one per sweep, the frame loop inside) and no
    finalize launch."""
    prof = profile_step(num_cf, cf, P, dev, label)
    if prof is None:
        return
    counts = prof[3]
    sweeps = {k: v for k, v in counts.items() if k.startswith("sweep_kernel")}
    assert len(sweeps) == 2 and set(sweeps.values()) == {1}, sweeps
    assert not any("finalize" in k for k in counts), counts


def vit_inputs(P, dev, B=128, N=128, seed=4):
    """Phase 15's input: mixed lengths with 1 and N, ±30-nat cliffs."""
    import torch

    rng = np.random.default_rng(seed)
    lhs = torch.from_numpy(make_inputs(rng, B, N, P, cliffs=True)).to(dev)
    lens = rng.integers(1, N + 1, size=B).astype(np.int32)
    lens[:4] = [N, 1, 2 * N // 3, N // 2 + 1]
    return lhs, torch.from_numpy(lens).to(dev)


def vit_score(out):
    from markovmodels_tpu_torch import inference as tinf

    _, _, vfin, shift, ksum = out
    return tinf._combine_shift(tinf._log_final(vfin), ksum,
                               shift).cpu().numpy()


def phase_vit_kernels(cf, P, dev, B=128, N=128):
    """Phase 15: K7 and the walk against their plain twins on one input at
    the main graph, N=128; B=128 and B=126 (B % 4 != 0: the kernel's
    scalar branch)."""
    import torch

    from markovmodels_tpu_torch.ops import vit_scan as vs
    from markovmodels_tpu_torch.ops.emissions import prepare_emissions

    lhs, lens = vit_inputs(P, dev, B, N)
    ext, msh = prepare_emissions(lhs, lens, P)
    out_k = vs.viterbi_fwd(cf, ext, msh)
    torch.cuda.synchronize()
    out_p = vs.viterbi_fwd_plain(cf, ext, msh)
    n_bp = int((out_k[0] != out_p[0]).sum())
    n_fin = int((out_k[1] != out_p[1]).sum())
    zk, zp = vit_score(out_k), vit_score(out_p)
    fin = np.isfinite(zp)
    assert (np.isfinite(zk) == fin).all(), "K7: -inf pattern differs"
    assert fin.sum() > B // 2 and not fin[1], "K7: unexpected -inf pattern"
    serr = float(np.abs(zk[fin] - zp[fin]).max())
    wt = vs.walk_tables(cf)
    sk = vs.walk(wt, out_k[0], out_k[1], lens)
    torch.cuda.synchronize()
    sp = vs.walk_plain(wt, out_k[0], out_k[1], lens)
    werr = float((sk - sp).abs().max())
    print(f"phase 15: B={B}: K7 vs plain: {n_bp} of {out_k[0].numel()} ids "
          f"and {n_fin} of {out_k[1].numel()} omega argmaxes differ; max "
          f"|dscore| = {serr:.3e} (tol {TOL_VIT:g}); walk kernel vs plain "
          f"max |dstate| = {werr:g}")
    assert n_bp == 0 and n_fin == 0, "K7 ids differ from the plain twin"
    assert serr <= TOL_VIT, f"K7 scores disagree: {serr}"
    assert werr == 0, "the walk kernel disagrees with its plain twin"
    return {"K7": serr, "K7w": werr}


def phase_vit_oracle(fsm, spdf, cf, P, dev, n=40, label="phase 16"):
    """Phase 16 (35): viterbi at B=2 against the exact f64 max-plus optimum
    (the gate bench.py holds the JAX package to)."""
    import torch

    import markovmodels_tpu_torch as mt

    rng = np.random.default_rng(11)
    lhs = rng.normal(size=(2, n, P)).astype(np.float32)
    lens = np.array([n, max(2, 2 * n // 3)], dtype=np.int32)
    ref = mt.oracle.host_viterbi_score(fsm, spdf, P, lhs.astype(np.float64),
                                       lens)
    states, score = mt.viterbi(cf, torch.from_numpy(lhs).to(dev),
                               torch.from_numpy(lens).to(dev))
    serr = float(np.abs(score.cpu().numpy() - ref).max())
    # the decoded paths' f64 weight against the optimum itself
    gap = mt.oracle.validate_paths(fsm, spdf, lhs, lens,
                                   states.cpu().numpy(), ref,
                                   atol=TOL_VIT_PATH)
    print(f"{label}: viterbi B=2 N={n} vs f64 oracle |dscore| = "
          f"{serr:.3e} (tol {TOL_VIT_ORACLE:g}); path-weight gap = "
          f"{gap:.3e} (tol {TOL_VIT_PATH:g})")
    assert serr <= TOL_VIT_ORACLE, "Viterbi score gate failed"


def vit_frame_split(cf, ext, msh, reps=3, ids=True, stride=64):
    """K7 (``ids``; else K7n as the checkpoint sweep runs it, saving every
    ``stride``-th frame) over the whole sweep on the forward operator and
    on three cut copies of it (``cut_operator(..., direction="fwd")``: no
    tier, no band offsets, neither: the frame without work), µs per frame,
    CUDA events, mean of ``reps`` warm runs each.  The sweep takes its
    operator from the graph's cache, so a cut copy put there is what it
    runs; the whole one is put back after."""
    import torch

    from markovmodels_tpu_torch.ops import block_scan as bs
    from markovmodels_tpu_torch.ops import vit_scan as vs

    vdt = vs._vit_dtype(cf)  # float64 for a float64 graph
    key = ("block_scan", vdt)
    kop = bs.kernel_operator(cf, vdt)
    out = {}
    try:
        for part, cut in (
                ("whole", kop),
                ("no tier", cut_operator(kop, tier=False, direction="fwd")),
                ("no bands", cut_operator(kop, bands=False,
                                          direction="fwd")),
                ("without work", cut_operator(kop, False, False, "fwd"))):
            cf._cache[key] = cut
            kw = {} if ids else {"ids": False, "stride": stride}
            t = cuda_ms(lambda: vs.viterbi_fwd(cf, ext, msh, **kw),
                        reps=reps)
            out[part] = 1e3 * t / ext.shape[0]
    finally:
        cf._cache[key] = kop
    return out


def decode_parts(cf, lhs, lengths):
    """The decode's steps apart, as ``viterbi._viterbi_scale_bp`` runs
    them: the two admissions (host ms, from the host clock), the emission
    prep, the K7 sweep, the score, the walk and the ``orig_state`` gather
    with its transpose (device ms, CUDA events, mean of 3 warm runs)."""
    import importlib

    import torch

    from markovmodels_tpu_torch import inference as tinf
    from markovmodels_tpu_torch.ops import vit_scan as vs
    from markovmodels_tpu_torch.ops.emissions import prepare_emissions

    tvit = importlib.import_module("markovmodels_tpu_torch.viterbi")
    B, N, P = lhs.shape

    def admissions():
        assert tvit._bp_vit_reject_reason(cf, lhs) is None
        assert vs.vit_scan_reject_reason(cf, B, n_frames=N,
                                         device=lhs.device) is None

    admissions()
    t0 = time.perf_counter()
    for _ in range(3):
        admissions()
    t_adm = 1e3 * (time.perf_counter() - t0) / 3
    ext, msh = prepare_emissions(lhs, lengths, P)
    out = vs.viterbi_fwd(cf, ext, msh)
    wt = vs.walk_tables(cf)
    st = vs.walk(wt, out[0], out[1], lengths)
    return {
        "admissions (host)": t_adm,
        "emission prep": cuda_ms(lambda: prepare_emissions(lhs, lengths, P),
                                 reps=3),
        "K7 sweep": cuda_ms(lambda: vs.viterbi_fwd(cf, ext, msh), reps=3),
        "score": cuda_ms(lambda: tinf._combine_shift(
            tinf._log_final(out[2]), out[4], out[3]).to(lhs.dtype), reps=3),
        "walk": cuda_ms(lambda: vs.walk(wt, out[0], out[1], lengths),
                        reps=3),
        "orig_state gather": cuda_ms(
            lambda: cf.orig_state[st.long()].T.contiguous(), reps=3),
    }


def phase_vit_main(fsm, spdf, cf, P, dev, B=128, N=700):
    """Phase 17: the full decode through K7 and the walk, checked and
    timed: the sweep and the walk separately, the decode end to end, and
    the plain twins beside them, whose outputs are held to the kernels'."""
    import torch

    import markovmodels_tpu_torch as mt
    from markovmodels_tpu_torch.ops import banded_scan as bsc
    from markovmodels_tpu_torch.ops import block_scan as bs
    from markovmodels_tpu_torch.ops import dense_scan as ds
    from markovmodels_tpu_torch.ops import vit_scan as vs
    from markovmodels_tpu_torch.ops.emissions import prepare_emissions

    rng = np.random.default_rng(0)
    lhs = torch.from_numpy(make_inputs(rng, B, N, P)).to(dev)
    lengths = torch.full((B,), N, dtype=torch.int32, device=dev)
    torch.cuda.synchronize()
    for m in (vs, bs, bsc, ds):
        m.reset_launch_counts()
    states, score = mt.viterbi(cf, lhs, lengths)
    torch.cuda.synchronize()
    launches = dict(vs.LAUNCHES)
    others = {k: v for m in (bs, bsc, ds) for k, v in m.LAUNCHES.items()}
    print(f"phase 17: launches {json.dumps(launches)}; other kernels "
          f"{json.dumps(others)}")
    assert launches == {"vit_fwd": 1, "vit_walk": 1, "vit_fwd_noid": 0,
                        "rec_walk": 0}, launches
    assert not any(others.values()), "the decode launched another kernel"

    st, sc = states.cpu().numpy(), score.cpu().numpy()
    assert st.shape == (B, N) and st.dtype == np.int32, "output shapes"
    assert sc.shape == (B,) and np.isfinite(sc).all(), "non-finite score"
    assert ((st >= 0) & (st < len(fsm.alpha_hat))).all(), "bad state ids"
    gap = mt.oracle.validate_paths(fsm, spdf, lhs.cpu().numpy(),
                                   lengths.cpu().numpy(), st, sc,
                                   atol=TOL_VIT_WALK)
    print(f"phase 17: all {B} paths walked in float64: max |path weight - "
          f"score| = {gap:.3e} (tol {TOL_VIT_WALK:g}); score in "
          f"[{sc.min():.3f}, {sc.max():.3f}]")

    ext, msh = prepare_emissions(lhs, lengths, P)
    wt = vs.walk_tables(cf)
    out = vs.viterbi_fwd(cf, ext, msh)
    t_sweep = cuda_ms(lambda: vs.viterbi_fwd(cf, ext, msh), reps=2)
    t_walk = cuda_ms(lambda: vs.walk(wt, out[0], out[1], lengths), reps=10)
    t_dec = cuda_ms(lambda: mt.viterbi(cf, lhs, lengths), reps=2)
    audio = B * N * FRAME_SHIFT_S
    print(f"phase 17: viterbi B={B} N={N}: decode {t_dec:.3f} ms = "
          f"{audio / (t_dec / 1e3):.1f} audio-s/s; K7 sweep {t_sweep:.3f} ms "
          f"({1e3 * t_sweep / (N + 1):.2f} us/frame), walk {t_walk:.3f} ms")
    prof = profile_device(lambda: mt.viterbi(cf, lhs, lengths))
    if prof is None:
        print("phase 17: profile of the decode: not measured (no device "
              "events recorded)")
    else:
        by_name, busy, span, counts = prof
        top = sorted(by_name.items(), key=lambda kv: -kv[1])
        print(f"phase 17: profile of one decode: device busy {busy:.3f} ms "
              f"of a {span:.3f} ms span (idle {1 - busy / span:.1%}); "
              + "; ".join(f"{k} {v:.3f} ms ({counts[k]} launches)"
                          for k, v in top))
        vit = {k: v for k, v in counts.items() if k.startswith("vit_")}
        assert sorted(vit.items()) == [
            ("vit_sweep_kernel<true, true, false, float>", 1),
            ("vit_walk_kernel<unsigned char, true>", 1)], counts
    parts = decode_parts(cf, lhs, lengths)
    for k, v in parts.items():
        print(f"phase 17: decode part: {k} {v:.3f} ms")
    print(f"phase 17: decode parts sum {sum(parts.values()):.3f} ms against "
          f"the decode's {t_dec:.3f} ms; outside the sweep "
          f"{sum(parts.values()) - parts['K7 sweep']:.3f} ms")
    split = vit_frame_split(cf, ext, msh)
    print("timing: K7 frame split on the 2M-arc graph: " + "; ".join(
        f"{k} {v:.2f} us" for k, v in split.items()) + f" per frame (over "
        f"{ext.shape[0]} frames, {vs._vit_grid(bs.kernel_operator(cf), dev, B)}"
        " CTAs)")

    # plain twins beside the kernels: plain, kernel, kernel, plain at
    # N=128, then once each at the full N=700
    n2 = min(128, N)
    lhs2, len2 = lhs[:, :n2].contiguous(), torch.full_like(lengths, n2)
    ext2, msh2 = prepare_emissions(lhs2, len2, P)
    kern2 = lambda: vs.viterbi_fwd(cf, ext2, msh2)
    plain2 = lambda: vs.viterbi_fwd_plain(cf, ext2, msh2)
    p1, k1, k2, p2 = (cuda_ms(plain2), cuda_ms(kern2), cuda_ms(kern2),
                      cuda_ms(plain2))
    print(f"timing: K7 at B={B} N={n2}: kernel {k1:.3f}/{k2:.3f} ms, plain "
          f"{p1:.3f}/{p2:.3f} ms")
    plain, walked = [], []
    t_plain = cuda_ms(lambda: plain.append(vs.viterbi_fwd_plain(cf, ext, msh)),
                      warm=False)
    t_walk_plain = cuda_ms(lambda: walked.append(
        vs.walk_plain(wt, out[0], out[1], lengths)), warm=False)
    print(f"timing: K7 at B={B} N={N}: kernel {t_sweep:.3f} ms, plain "
          f"{t_plain:.3f} ms; walk kernel {t_walk:.3f} ms, plain "
          f"{t_walk_plain:.3f} ms")

    # the same plain runs hold K7 and the walk to their twins at this shape
    # (the ids past 2^32 bytes included)
    out_p = plain[0]
    n_bp = int((out[0] != out_p[0]).sum())
    n_fin = int((out[1] != out_p[1]).sum())
    zk, zp = vit_score(out), vit_score(out_p)
    assert np.isfinite(zk).all() and np.isfinite(zp).all(), "K7: -inf score"
    serr = float(np.abs(zk - zp).max())
    werr = float((vs.walk(wt, out[0], out[1], lengths) - walked[0])
                 .abs().max())
    print(f"phase 17: K7 vs plain at B={B} N={N}: {n_bp} of {out[0].numel()} "
          f"ids and {n_fin} of {out[1].numel()} omega argmaxes differ; max "
          f"|dscore| = {serr:.3e} (tol {TOL_VIT:g}); walk kernel vs plain "
          f"max |dstate| = {werr:g}")
    assert n_bp == 0 and n_fin == 0, "K7 ids differ from the plain twin"
    assert serr <= TOL_VIT, f"K7 scores disagree: {serr}"
    assert werr == 0, "the walk kernel disagrees with its plain twin"
    times = {"K7": (t_sweep, t_plain), "K7w": (t_walk, t_walk_plain)}
    return launches, times, t_dec, {"K7": serr, "K7w": werr}, split


def phase_ov_step(num_cf, cf, ecf, P, dev, B=128, N=700, chunk=64):
    """Phase 21: the training step with the separate-state denominator
    (phase_step's checks), its exact launch counts, and the den-only time
    of the embedded layout of the same LM beside it."""
    import torch

    import markovmodels_tpu_torch as mt
    from markovmodels_tpu_torch.ops import banded_scan as bsc
    from markovmodels_tpu_torch.ops import block_scan as bs
    from markovmodels_tpu_torch.ops import dense_scan as ds
    from markovmodels_tpu_torch.ops import vit_scan as vs

    ds.reset_launch_counts()
    vs.reset_launch_counts()
    launches, t_step, t_den = phase_step(num_cf, cf, P, dev, (bs, bsc),
                                         "phase 21", B, N)
    C = -(-(N + 1) // chunk)
    want = {"block_fwd": 1, "block_recompute": C, "block_bwd": C,
            "banded_fwd": 1, "banded_bwd": 1}
    others = {k: v for m in (ds, vs) for k, v in m.LAUNCHES.items()}
    assert launches == want, f"launches {launches}, expected {want}"
    assert not any(others.values()), f"another kernel launched: {others}"
    rng = np.random.default_rng(0)
    lhs = torch.from_numpy(make_inputs(rng, B, N, P)).to(dev)
    lengths = torch.full((B,), N, dtype=torch.int32, device=dev)
    t_emb = cuda_ms(lambda: mt.pdfposteriors(ecf, lhs, lengths), reps=2)
    audio = B * N * FRAME_SHIFT_S
    print(f"phase 21: embedded layout den-only pdfposteriors {t_emb / 1e3:.4f}"
          f" s = {audio / (t_emb / 1e3):.1f} audio-s/s; separate/embedded "
          f"den-only ratio {t_den / t_emb:.3f} (bench.py holds the JAX "
          f"package's under 1.2; printed only)")
    return launches, t_step, t_den, t_emb


def phase_block_frames(cf, P, dev, label, B=128, N=128, chunk=64):
    """Phase 23's frame checks: K2, K3 and K4 against their twins one frame
    at a time from the same input (the kernels' own states of a
    mid-sequence chunk), so that both round the same float32 values and
    only the order of the float32 sums differs: K3 and K4 on every frame
    of the chunk, K2 over two frames (the first, which skips the matvec,
    and one step) from every 8th.  Returns {name: max |err|}."""
    import torch

    from markovmodels_tpu_torch.ops import block_scan as bs
    from markovmodels_tpu_torch.ops.emissions import (pad_emissions,
                                                      prepare_emissions)

    rng = np.random.default_rng(1)
    lhs = torch.from_numpy(make_inputs(rng, B, N, P, cliffs=True)).to(dev)
    lens_np = rng.integers(1, N + 1, size=B).astype(np.int32)
    lens_np[:4] = [N, 1, 2 * N // 3, N // 2 + 1]
    kop = bs.kernel_operator(cf)
    ext, msh = prepare_emissions(lhs, torch.from_numpy(lens_np).to(dev), P)
    K = min(chunk, N + 1)
    C = -(-(N + 1) // K)
    Npad = C * K
    ext, msh = pad_emissions(ext, msh, Npad)
    a0 = kop.alpha0[:, None].expand(kop.Sp, B).contiguous()
    bounds, bscale = bs.fwd_sweep(kop, a0, ext, msh, K)[:2]
    c = C // 2
    t0 = c * K
    al, asc = bs.recompute(kop, bounds[c], bscale[c], ext[t0:t0 + K], t0)
    errs = {"K2": 0.0, "K3": 0.0, "K4": 0.0}
    for j in range(1, K):
        t = t0 + j
        args = (kop, al[j - 1], asc[j - 1], ext[t:t + 1], t)
        k, p = bs.recompute(*args), bs.recompute_plain(*args)
        errs["K3"] = max(errs["K3"],
                         float((scaled(*k) - scaled(*p)).abs().max()))
    for j in range(0, K - 2, 8):
        t = t0 + j
        args = (kop, al[j].contiguous(), ext[t:t + 2], msh[t:t + 2], 2)
        errs["K2"] = max(errs["K2"], sweep_err(kop, bs.fwd_sweep(*args),
                                               bs.fwd_sweep_plain(*args)))
    beta, bsc = torch.ones_like(a0), torch.ones(B, device=dev)
    for cc in reversed(range(c + 1, C)):  # the kernels' beta after chunk c
        sl = slice(cc * K, (cc + 1) * K)
        a_, s_ = bs.recompute(kop, bounds[cc], bscale[cc], ext[sl], cc * K)
        _, beta, bsc = bs.backward(kop, beta, bsc, a_, s_, ext[sl], cc * K,
                                   Npad)
    for j in reversed(range(K)):
        t = t0 + j
        args = (kop, beta, bsc, al[j:j + 1], asc[j:j + 1], ext[t:t + 1], t,
                Npad)
        k = bs.backward(*args)
        errs["K4"] = max(errs["K4"], bwd_err(k, bs.backward_plain(*args)))
        beta, bsc = k[1], k[2]
    torch.cuda.synchronize()
    for name, e in errs.items():
        print(f"{label}: {name} kernel vs plain one frame at a time from the "
              f"same state max |err| = {e:.3e} (tol {TOL_KERNEL:g})")
        assert np.isfinite(e) and e <= TOL_KERNEL, f"{name} disagrees: {e}"
    return errs


def phase_dense_frames(kop, P, dev, label, N=128):
    """Phase 24's frame checks on the bf16 operator ``kop``: K6a over two
    frames (the first skips the product) from the kernel's own state of
    every 8th frame, and K6b over two frames (the last starts from beta =
    1, the other multiplies it) on the kernel's alphas: the same float32
    values rounded on both sides.  Returns {name: max |err|}."""
    import torch

    from markovmodels_tpu_torch.ops import dense_scan as ds

    ext, msh = dense_inputs(P, dev, N=N)
    B = ext.shape[2]
    a0 = kop.alpha0[:, None].expand(kop.Sp, B).contiguous()
    al, asc = ds.fwd_sweep(kop, a0, ext, msh)[:2]
    errs = {"K6a": 0.0, "K6b": 0.0}
    for t in range(1, N - 1, 8):
        args = (kop, al[t].contiguous(), ext[t:t + 2], msh[t:t + 2])
        k, p = ds.fwd_sweep(*args), ds.fwd_sweep_plain(*args)
        errs["K6a"] = max(errs["K6a"], float(
            (scaled(k[0], k[1]) - scaled(p[0], p[1])).abs().max()))
        args = (kop, ext[t:t + 2], al[t:t + 2].contiguous(),
                asc[t:t + 2].contiguous())
        errs["K6b"] = max(errs["K6b"], float(
            (ds.backward(*args) - ds.backward_plain(*args)).abs().max()))
    torch.cuda.synchronize()
    for name, e in errs.items():
        print(f"{label}: {name} kernel vs plain one frame at a time from the "
              f"same state max |err| = {e:.3e} (tol {TOL_K6:g})")
        assert np.isfinite(e) and e <= TOL_K6, f"{name} disagrees: {e}"
    return errs


def phase_oracle_700(fsm, spdf, P, dev, cfs, label, n=700, refs=None):
    """Phase 25 (39): ``pdfposteriors`` at B=2, N=700 (lengths N and 2N/3,
    the inputs of ``bench.py``'s parity gate) against the exact f64 host
    oracle, which runs once for the graph (with ``refs``, a dict: once per
    graph and dict, kept there under the graph's id); ``cfs`` maps a name
    to (compile of the graph, logZ gate, posterior gate), each fed the
    log-likelihoods in its dtype.  Every reading is printed beside the
    1e-4 contract.  Returns {name: (|dlogZ|, |dposts|)} and the oracle's
    seconds."""
    import torch

    import markovmodels_tpu_torch as mt

    rng = np.random.default_rng(7)
    lhs = rng.normal(size=(2, n, P)).astype(np.float32)
    lens = np.array([n, max(2, 2 * n // 3)], dtype=np.int32)
    t0 = time.perf_counter()
    refs = {} if refs is None else refs
    if id(fsm) not in refs:
        refs[id(fsm)] = mt.oracle.host_oracle(fsm, spdf, P,
                                              lhs.astype(np.float64), lens)
    ref_z, ref_p = refs[id(fsm)]
    t_oracle = time.perf_counter() - t0
    out = {}
    for name, (cf, tz, tp) in cfs.items():
        posts, z = mt.pdfposteriors(
            cf, torch.from_numpy(lhs).to(dev, cf.alpha_hat.dtype),
            torch.from_numpy(lens).to(dev))
        err = float(np.abs(z.cpu().numpy() - ref_z).max())
        perr = float(np.abs(posts.cpu().numpy() - ref_p).max())
        met = lambda e: "met" if e <= TOL_ORACLE else "missed"
        print(f"{label}: {name} B=2 N={n} vs f64 oracle |dlogZ| = {err:.3e} "
              f"(gate {tz:g}; contract {TOL_ORACLE:g} {met(err)}), |dposts| "
              f"= {perr:.3e} (gate {tp:g}; contract {TOL_ORACLE:g} "
              f"{met(perr)})")
        assert err <= tz and perr <= tp, f"{name}: N={n} oracle gate failed"
        out[name] = (err, perr)
    print(f"{label}: the f64 oracle took {t_oracle:.1f} s")
    return out, t_oracle


def bf16_checks(label, mods, fn):
    """Run ``fn`` (a check of bf16 kernels against their twins) with every
    launch count of ``mods`` set to 0, and assert that it launched only
    bf16 instantiations, each at least once."""
    import torch

    for m in mods:
        m.reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    counts = launch_counts(mods, bf16=True)
    print(f"{label}: bf16 launches of the check {json.dumps(counts)}")
    assert all(counts.values()), "a bf16 kernel never launched"
    return out


def median_ms(fns, reps=5):
    """{name: median ms of ``reps`` warm runs} of the callables ``fns``,
    run in turns (one of each per round, after one warm-up each), each
    timed with CUDA events."""
    import torch

    for fn in fns.values():
        fn()
    ts = {k: [] for k in fns}
    for _ in range(reps):
        for k, fn in fns.items():
            torch.cuda.synchronize()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            torch.cuda.synchronize()
            ts[k].append(a.elapsed_time(b))
    return {k: float(np.median(v)) for k, v in ts.items()}


def time_bf16_paths(pairs, dev, B=128, N=700):
    """Phase 29: each (f32, bf16) pair of callables on the same inputs,
    medians of 5 warm runs in turns; prints the bf16/f32 ratio.  Returns
    {name: (f32 ms, bf16 ms)}."""
    out = {}
    for name, (f32, b16) in pairs.items():
        t = median_ms({"f32": f32, "bf16": b16})
        out[name] = (t["f32"], t["bf16"])
        audio = B * N * FRAME_SHIFT_S
        print(f"phase 29: {name} B={B} N={N}: f32 {t['f32']:.2f} ms, bf16 "
              f"{t['bf16']:.2f} ms = {audio / (t['bf16'] / 1e3):.1f} "
              f"audio-s/s; bf16/f32 {t['bf16'] / t['f32']:.3f} (medians of "
              f"5; printed, not gated)")
    return out


def matmul_yardstick_bf16(dcf, dev, B=128, Nf=701):
    """K6's bf16 yardstick: the (Sp, Sp) bf16 operator by a (Sp, B) bf16
    state with a float32 result (``torch.mm(..., out_dtype=float32)``, one
    PyTorch call per frame) times Nf; not a kernel of the port."""
    import torch

    from markovmodels_tpu_torch.ops import dense_scan as ds

    kop = ds.kernel_operator(dcf)
    a = torch.rand((kop.Sp, B), device=dev).to(torch.bfloat16)
    y = torch.mm(kop.wf, a, out_dtype=torch.float32)
    assert y.dtype == torch.float32 and kop.wf.dtype == torch.bfloat16
    return Nf * cuda_ms(lambda: torch.mm(kop.wf, a, out_dtype=torch.float32),
                        reps=50)


def phase_bf16_decode(cf, cf16, P, dev, B=128, N=128):
    """Phase 30: K7 on the bf16 graph takes the float32 panels (the TPU K7
    ignores the precision): its ids, ω argmaxes and scores equal the
    'high' graph's bit for bit, and so do the decoded paths."""
    import torch

    import markovmodels_tpu_torch as mt
    from markovmodels_tpu_torch.ops import vit_scan as vs
    from markovmodels_tpu_torch.ops.emissions import prepare_emissions

    lhs, lens = vit_inputs(P, dev, B, N)
    ext, msh = prepare_emissions(lhs, lens, P)
    vs.reset_launch_counts()
    hi, lo = vs.viterbi_fwd(cf, ext, msh), vs.viterbi_fwd(cf16, ext, msh)
    torch.cuda.synchronize()
    assert vs.LAUNCHES["vit_fwd"] == 2, vs.LAUNCHES
    same = [torch.equal(x, y) for x, y in zip(hi, lo)]
    s_hi, z_hi = mt.viterbi(cf, lhs, lens)
    s_lo, z_lo = mt.viterbi(cf16, lhs, lens)
    paths = torch.equal(s_hi, s_lo) and torch.equal(z_hi, z_lo)
    print(f"phase 30: K7 on the bf16 graph vs the 'high' graph at B={B} "
          f"N={N}: ids, omega argmaxes, vfin, shift, ksum bit-equal "
          f"{same}; decoded paths and scores bit-equal {paths}")
    assert all(same) and paths, "the bf16 graph decodes differently"


def trop_bounds(dcf, B, Nf, kop=None):
    """K6t over an Nf-frame sweep that keeps every frame, for the sparse
    product it computes: per frame and column one candidate per non-zero
    of the operator, a multiply and a max, at 1.5 instructions a candidate
    in float32 (an FMUL and half a 3-input integer max, one instruction per
    lane and clock: PEAK_F32_OPS) and 2 in float64 (a DMUL and a compare,
    PEAK_F64_OPS), and the emission and rescale per state; the plan's
    entries read once (a source and a weight each), the initial state,
    every frame's state and scale written, the emissions.  ``kop``: the
    operator (:func:`ds.trop_operator` of ``dcf`` where None)."""
    import torch

    from markovmodels_tpu_torch.ops import dense_scan as ds

    kop = ds.trop_operator(dcf) if kop is None else kop
    Sp, P1 = kop.Sp, kop.P1
    f = kop.wf.element_size()  # 8: the float64 instantiation
    nnz = int(torch.count_nonzero(kop.wf))
    nbytes = (f + 4) * nnz + f * (
        Sp * B + Nf * (P1 + 1) * B + Nf * (Sp + 1) * B + 3 * B)
    per = 2 if f == 8 else 1.5
    return bound(Nf * B * (per * nnz + 3 * Sp), nbytes,
                 PEAK_F64_OPS if f == 8 else PEAK_F32_OPS)


def trop_checks(kop, ext_of, label, Bs=(128, 126, 124), N=128, h=None):
    """K6t on ``kop`` against its plain twin at each batch of ``Bs`` on
    ``ext_of(B, N)``'s (ext, mshift): run twice, bit-equal to each other
    and to the twin (states, scales, ksum and shift), and restarted at
    frame ``h`` (N // 2) from the saved frame, bit-equal to the twin's
    restart and to the whole sweep's frames.  Returns max |K6t - twin|."""
    import torch

    from markovmodels_tpu_torch.ops import dense_scan as ds

    def same(xs, ys):
        return all(torch.equal(x, y) for x, y in zip(xs, ys))

    h = N // 2 if h is None else h
    err = 0.0
    for B in Bs:
        ext, msh = ext_of(B, N)
        a0 = kop.alpha0[:, None].expand(kop.Sp, B).contiguous()
        s0 = torch.ones(B, device=ext.device, dtype=ext.dtype)
        k1 = ds.trop_sweep(kop, a0, s0, ext, msh, first=True)
        k2 = ds.trop_sweep(kop, a0, s0, ext, msh, first=True)
        torch.cuda.synchronize()
        p = ds.trop_sweep_plain(kop, a0, s0, ext, msh, first=True)
        mid = (k1[0][h - 1], k1[1][h - 1], ext[h:], msh[h:])
        m_k = ds.trop_sweep(kop, *mid, first=False)
        m_p = ds.trop_sweep_plain(kop, *mid, first=False)
        ok = {"twice": same(k1, k2), "twin": same(k1, p),
              "restart": same(m_k, m_p) and torch.equal(m_k[0], k1[0][h:])}
        err = max(err, max(float((x.double() - y.double()).abs().max())
                           for x, y in zip(k1, p)))
        print(f"{label}: K6t B={B} N={N}: states, scales, ksum and shift "
              f"bit-equal {ok}")
        assert all(ok.values()), f"{label}: K6t disagrees at B={B}: {ok}"
        del k1, k2, p, m_k, m_p
    return err


def trop_frame_split(kop, ext, msh, reps=3):
    """K6t's frame split, us per frame: ``whole`` (the sweep from the
    initial state over the frames of ``ext``) and ``no product`` (the same
    sweep on an all-zero operator: every row a piece without entries, so
    what is left is the epilogues, the column maxima and the grid barrier),
    CUDA events."""
    import torch

    from markovmodels_tpu_torch.ops import dense_scan as ds

    Nf, _, B = ext.shape
    dev = ext.device
    zero = ds.dense_op(kop.alpha0, torch.zeros_like(kop.wf),
                       torch.zeros_like(kop.wf), kop.spdf,
                       torch.arange(kop.Sp, device=dev), kop.P1, kop.fin)
    zero = getattr(ds, "with_trop_plan", lambda k: k)(zero)
    a0 = kop.alpha0[:, None].expand(kop.Sp, B).contiguous()
    one = torch.ones(B, device=dev, dtype=ext.dtype)
    return {k: 1e3 * cuda_ms(lambda: ds.trop_sweep(op, a0, one, ext, msh,
                                                    first=True),
                             reps=reps) / Nf
            for k, op in (("whole", kop), ("no product", zero))}


def noid_traffic(cf, B, Nf, saved, l2_bytes=None):
    """(operations, bytes, peak) of K7n over Nf frames saving ``saved`` of
    them: K7's work without the id (per tier candidate a multiply and a
    max, the max in float32 half an instruction: a 3-input integer max on
    the products' bits takes two candidates (VIMNMX3), so 1.5 instructions
    a candidate, where float64 has no such max and counts 2; per band
    candidate a multiply and a max, per family term (a capped layout) a
    multiply and a max, per state the omega product and max, the emission
    and the rescale) at PEAK_F32_OPS (PEAK_F64_OPS in float64); the
    operator with its family tables, the emissions, the
    start state and the saved states and scales, each value of its
    dtype's bytes.  Where two slots of the state pass L2
    (``_state_past_l2``), each frame's read of its predecessor beyond the
    start state ((Nf - 1) Sp B values) and, where the sweep runs in its
    two work slots (saved < Nf: the checkpoint sweep), each frame's write
    there (Nf Sp B) beside the saves."""
    from markovmodels_tpu_torch.ops import block_scan as bs
    from markovmodels_tpu_torch.ops import vit_scan as vs

    kop = bs.kernel_operator(cf, vs._vit_dtype(cf))
    K, Sm, D = kop.fwd.W.shape
    nO, Sp, P1 = len(kop.fwd.offsets), kop.Sp, kop.P1
    nfam = kop.fwd.fam_dst.numel()
    RW = vs._main_region(cf)
    SB, f, past = _state_past_l2(kop, B, l2_bytes)
    tier = 2 if f == 8 else 1.5  # instructions per tier candidate
    ops = Nf * B * (tier * K * Sm * D + 2 * nO * RW + 2 * nfam + 4 * Sp)
    nbytes = f * (K * Sm * D + nO * Sp + 2 * Sp + Nf * (P1 + 1) * B
                  + Sp * B + saved * (Sp + 1) * B + 8 * B)
    if vs._is_fam(kop):
        nbytes += 4 * (2 * Sp + 1) + (4 + f) * nfam
    if past:
        nbytes += f * SB * ((Nf - 1) + (Nf if saved < Nf else 0))
    return ops, nbytes, PEAK_F64_OPS if f == 8 else PEAK_F32_OPS


def noid_bounds(cf, B, Nf, saved, l2_bytes=None):
    """(bound ms, "bytes" or "operations") of K7n from
    :func:`noid_traffic`."""
    return bound(*noid_traffic(cf, B, Nf, saved, l2_bytes))


def walk_bounds(wt, path, s_next, lengths, t0, Sp):
    """W2 over one launch, from its own path (the work depends on the
    data): ``path`` (nK, B) the walked states of frames t0 .., ``s_next``
    the states of the frame after.  Per frame and sequence before the
    length's last frame, the in-arcs of the next frame's state, each a
    record (source and weight) read, an alpha gathered and a multiply,
    log, add and compare; at the last frame the omega argmax over the ω
    support (a (state, ω) record and an alpha read, two multiplies and a
    compare each: the states outside it score 0, below the support's
    positive maximum on these inputs); per frame the (begin, count) pair,
    the scale and the state written.  ``Sp`` is the states the full scan
    would take where the support's maximum is 0 (not counted: these
    inputs never need it)."""
    rowptr = wt.rowptr.cpu().numpy().astype(np.int64)
    path = path.cpu().numpy().astype(np.int64)  # compiled ids
    L = lengths.cpu().numpy().astype(np.int64)[None, :]
    t = t0 + np.arange(path.shape[0])[:, None]
    nxt = np.concatenate([path[1:], s_next.cpu().numpy()[None]]).astype(
        np.int64)
    cnt = np.minimum(rowptr[nxt + 1] - rowptr[nxt], wt.dmax)
    cnt = np.where((nxt == wt.fin) | (t >= L - 1), 0, cnt)
    cand = int(cnt.sum())
    steps = path.size
    omega_steps = int(((t == L - 1) & (L >= 1)).sum())
    f = wt.w.element_size()  # 8: the float64 instantiation
    n_sup = int((wt.omega != 0).sum())
    rec = 4 + (f + 4 if f == 8 else f)  # a packed record's bytes
    ops = 4 * cand + 3 * n_sup * omega_steps
    nbytes = ((rec + f) * cand + (rec + f) * n_sup * omega_steps
              + (8 + f + 4) * steps)
    return bound(ops, nbytes, PEAK_F64_OPS if f == 8 else PEAK_F32_OPS)


def hmm5(seed=7, S=5):
    """BASELINE.json config 1: a left-to-right 5-state HMM (self-loop and
    forward arc per state, random weights from ``seed``, final weight 0.3 on
    the last state), one pdf per state: (fsm, state_pdf, P)."""
    import markovmodels_tpu_torch as mt

    rng = np.random.default_rng(seed)
    arcs = []
    for i in range(S):
        js = [j for j in (i, i + 1) if j < S]
        w = rng.uniform(0.1, 1.0, size=len(js))
        w /= w.sum() * rng.uniform(1.0, 1.5)
        arcs += [((i, j), float(np.log(x))) for j, x in zip(js, w)]
    fsm = mt.fsm.FSM.from_pairs(
        [(0, 0.0)], arcs, [(S - 1, float(np.log(0.3)))],
        [mt.labels.Label(i) for i in range(S)], mt.LOG)
    return fsm, np.arange(S + 1, dtype=np.int32), S


def all_launches():
    """Every kernel entry point's launch count, across the ops modules."""
    from markovmodels_tpu_torch.ops import banded_scan as bsc
    from markovmodels_tpu_torch.ops import block_scan as bs
    from markovmodels_tpu_torch.ops import dense_scan as ds
    from markovmodels_tpu_torch.ops import vit_scan as vs

    out = {}
    for m in (bs, bsc, ds, vs):
        out.update(m.LAUNCHES)
    out.update({f"{k}_bf16": v for m in (bs, ds)
                for k, v in m.LAUNCHES_BF16.items()})
    out.update({f"{k}_f64": v for m in (bs, bsc, ds, vs)
                for k, v in m.LAUNCHES_F64.items()})
    return out


def reset_all_launches():
    from markovmodels_tpu_torch.ops import banded_scan as bsc
    from markovmodels_tpu_torch.ops import block_scan as bs
    from markovmodels_tpu_torch.ops import dense_scan as ds
    from markovmodels_tpu_torch.ops import vit_scan as vs

    for m in (bs, bsc, ds, vs):
        m.reset_launch_counts()


def phase_rec_kernels(dcf, dP, cf, P, dev, B=128, N=128):
    """Phase 31: K6t (the V=32 dense graph), K7n (the 2M-arc graph) and W2
    (both) against their plain twins on phase 15's input at N=128 (lengths
    1, 2N/3 and N mixed, ±30-nat cliffs): K6t (at B = 128, 126 and 124)
    and K7n each run twice, bit-equal run to run and to the twin, also
    restarted mid-sweep from a saved frame; K7n's final value, ksum and shift bit-equal to K7's on the
    same input, its checkpoints every 64 frames equal to the saved frames;
    W2 bit-equal to its twin over the whole sweep and in two chunks; the
    decode with chunk_size 7 and 64 against the one-chunk decode: the same
    states and scores.  Returns {kernel: max |kernel - twin|}."""
    import importlib

    import torch

    import markovmodels_tpu_torch as mt
    from markovmodels_tpu_torch.ops import dense_scan as ds
    from markovmodels_tpu_torch.ops import vit_scan as vs
    from markovmodels_tpu_torch.ops.emissions import prepare_emissions

    tvit = importlib.import_module("markovmodels_tpu_torch.viterbi")

    def same(xs, ys):
        return all(torch.equal(x, y) for x, y in zip(xs, ys))

    def err(xs, ys):
        return max(float((x.double() - y.double()).abs().max())
                   for x, y in zip(xs, ys))

    h = 64  # the mid-sweep restart frame
    kop = ds.trop_operator(dcf)
    e_k6t = trop_checks(
        kop, lambda B_, N_: prepare_emissions(*vit_inputs(dP, dev, B_, N_),
                                              dP),
        "phase 31 (the V=32 dense graph)", Bs=(B, 126, 124), N=N, h=h)
    lhs_d, lens_d = vit_inputs(dP, dev, B, N)
    ext, msh = prepare_emissions(lhs_d, lens_d, dP)
    a0 = kop.alpha0[:, None].expand(kop.Sp, B).contiguous()
    k1 = ds.trop_sweep(kop, a0, torch.ones(B, device=dev), ext, msh,
                       first=True)

    lhs_b, lens_b = vit_inputs(P, dev, B, N)
    ext2, msh2 = prepare_emissions(lhs_b, lens_b, P)
    n1 = vs.viterbi_fwd(cf, ext2, msh2, ids=False)
    n2 = vs.viterbi_fwd(cf, ext2, msh2, ids=False)
    torch.cuda.synchronize()
    np_ = vs.viterbi_fwd_plain(cf, ext2, msh2, ids=False)
    k7 = vs.viterbi_fwd(cf, ext2, msh2)
    fin = cf.final_state
    ck = vs.viterbi_fwd(cf, ext2, msh2, ids=False, stride=h)
    mid = dict(a0=n1[0][h - 1], s0=n1[1][h - 1], t0=h)
    r_k = vs.viterbi_fwd(cf, ext2[h:], msh2[h:], ids=False, **mid)
    r_p = vs.viterbi_fwd_plain(cf, ext2[h:], msh2[h:], ids=False, **mid)
    k7n = {"twice": same(n1, n2), "twin": same(n1, np_),
           "as K7": (torch.equal(n1[2][fin] * n1[3], k7[2])
                     and torch.equal(n1[4][0], k7[4])
                     and torch.equal(n1[4][1], k7[3])),
           "checkpoints": (torch.equal(ck[0], n1[0][h - 1::h])
                           and torch.equal(ck[1], n1[1][h - 1::h])
                           and same(ck[2:], n1[2:])),
           "restart": same(r_k, r_p) and torch.equal(r_k[0], n1[0][h:])}
    e_k7n = max(err(n1, np_), err(r_k, r_p))
    del n2, np_, r_k, r_p, ck
    print(f"phase 31: K7n on the 2M-arc graph B={B} N={N}: saved states "
          f"and scales, final value, ksum and shift bit-equal {k7n}; max "
          f"|K7n - plain| = {e_k7n:g}")
    assert all(k7n.values()), f"K7n disagrees: {k7n}"

    e_w2 = 0.0
    for name, g, (st, sc), lens in (("V=32 dense", dcf, k1[:2], lens_d),
                                    ("2M-arc", cf, n1[:2], lens_b)):
        wt = vs.rec_walk_tables(g)
        s_end = torch.full((B,), wt.fin, dtype=torch.int32, device=dev)
        wk = vs.rec_walk(wt, st, sc, lens, 0, s_end)
        torch.cuda.synchronize()
        wp = vs.rec_walk_plain(wt, st, sc, lens, 0, s_end)
        w_hi = vs.rec_walk(wt, st[h:], sc[h:], lens, h, s_end)
        w_lo = vs.rec_walk(wt, st[:h], sc[:h], lens, 0, w_hi[0])
        ok = {"twin": torch.equal(wk, wp),
              "chunks": torch.equal(torch.cat([w_lo, w_hi]), wk)}
        e_w2 = max(e_w2, float((wk - wp).abs().max()))
        print(f"phase 31: W2 on the {name} graph's saved frames: states "
              f"equal {ok}; {int((wk != wp).sum())} of {wk.numel()} differ")
        assert all(ok.values()), f"W2 disagrees on the {name} graph: {ok}"
    del n1, k1

    for name, g, lhs, lens in (("V=32 dense", dcf, lhs_d, lens_d),
                               ("2M-arc", cf, lhs_b, lens_b)):
        one = tvit._viterbi_recompute(g, lhs, lens)
        for k in (7, 64):
            got = tvit._viterbi_recompute(g, lhs, lens, k)
            ok = same(got, one)
            print(f"phase 31: {name} chunk-recompute decode, chunk_size {k} "
                  f"against one chunk: states and scores equal {ok}")
            assert ok, f"the chunked {name} decode differs"
    return {"K6t": e_k6t, "K7n": e_k7n, "W2": e_w2}


def phase_dense_decode(dfsm, dspdf, dcf, dP, dev, B=128, N=700):
    """Phase 32: ``viterbi`` on the V=32 dense graph at B=128, N=700
    (phase 17's input form, seed 0) through K6t and W2 only (launch
    counters and the profiler's kernel count), every path walked in f64,
    8 sequences of mixed lengths against the f64 max-plus optimum; the
    decode (median of 5), the sweep and the walk timed, K6t's frame split
    (``trop_frame_split``), their plain twins timed and held to them at
    this shape, the profiled idle share; then
    BASELINE.json config 1 (a left-to-right 5-state HMM, T=100, B=1) on
    the card against the CPU route and the optimum."""
    import torch

    import markovmodels_tpu_torch as mt
    from markovmodels_tpu_torch.ops import dense_scan as ds
    from markovmodels_tpu_torch.ops import vit_scan as vs
    from markovmodels_tpu_torch.ops.emissions import prepare_emissions

    rng = np.random.default_rng(0)
    lhs = torch.from_numpy(make_inputs(rng, B, N, dP)).to(dev)
    lengths = torch.full((B,), N, dtype=torch.int32, device=dev)
    torch.cuda.synchronize()
    reset_all_launches()
    states, score = mt.viterbi(dcf, lhs, lengths)
    torch.cuda.synchronize()
    counts = all_launches()
    print(f"phase 32: launches {json.dumps(counts)}")
    want = {k: 0 for k in counts}
    want.update(dense_trop=1, rec_walk=1)
    assert counts == want, f"the dense decode launched {counts}"
    st, sc = states.cpu().numpy(), score.cpu().numpy()
    assert st.shape == (B, N) and np.isfinite(sc).all(), "dense decode"
    gap = mt.oracle.validate_paths(dfsm, dspdf, lhs.cpu().numpy(),
                                   lengths.cpu().numpy(), st, sc,
                                   atol=TOL_VIT_WALK)
    l8 = np.array([N, 1, 2 * N // 3, N // 2 + 1, N - 1, 2, N // 3, N],
                  dtype=np.int32)
    s8, z8 = mt.viterbi(dcf, lhs[:8], torch.from_numpy(l8).to(dev))
    z8 = z8.cpu().numpy()
    ref = mt.oracle.host_viterbi_score(dfsm, dspdf, dP,
                                       lhs[:8].cpu().numpy()
                                       .astype(np.float64), l8)
    feas = np.isfinite(ref)
    assert (np.isfinite(z8) == feas).all(), "dense decode: -inf pattern"
    serr = float(np.abs(z8[feas] - ref[feas]).max())
    gap8 = mt.oracle.validate_paths(dfsm, dspdf, lhs[:8].cpu().numpy()[feas],
                                    l8[feas], s8.cpu().numpy()[feas],
                                    ref[feas], atol=TOL_VIT_WALK)
    print(f"phase 32: V=32 dense decode B={B} N={N}: all {B} paths walked "
          f"in float64, max |path weight - score| = {gap:.3e} (tol "
          f"{TOL_VIT_WALK:g}); 8 mixed lengths ({feas.sum()} feasible) vs "
          f"the f64 optimum |dscore| = {serr:.3e} (tol {TOL_VIT_ORACLE:g}), "
          f"their paths within {gap8:.3e}")
    assert serr <= TOL_VIT_ORACLE, "dense decode: oracle gate"

    ext, msh = prepare_emissions(lhs, lengths, dP)
    kop = ds.trop_operator(dcf)
    a0 = kop.alpha0[:, None].expand(kop.Sp, B).contiguous()
    s0 = torch.ones(B, device=dev)
    out = ds.trop_sweep(kop, a0, s0, ext, msh, first=True)
    wt = vs.rec_walk_tables(dcf)
    s_end = torch.full((B,), wt.fin, dtype=torch.int32, device=dev)
    path = vs.rec_walk(wt, out[0], out[1], lengths, 0, s_end)
    t_sweep = cuda_ms(lambda: ds.trop_sweep(kop, a0, s0, ext, msh,
                                            first=True), reps=3)
    t_walk = cuda_ms(lambda: vs.rec_walk(wt, out[0], out[1], lengths, 0,
                                         s_end), reps=5)
    split = trop_frame_split(kop, ext, msh)
    t_dec = median_ms({"decode": lambda: mt.viterbi(dcf, lhs, lengths)})[
        "decode"]
    audio = B * N * FRAME_SHIFT_S
    prof = profile_device(lambda: mt.viterbi(dcf, lhs, lengths))
    idle = "not measured (no device events recorded)"
    if prof is not None:
        by_name, busy, span, kcounts = prof
        idle = f"{1 - busy / span:.1%} of a {span:.3f} ms span"
        ours = {k: v for k, v in kcounts.items()
                if k.startswith(("sweep_kernel", "trop_kernel", "rec_walk",
                                 "vit_"))}
        print("phase 32: profile of one decode: " + "; ".join(
            f"{k} {v:.3f} ms ({kcounts[k]} launches)" for k, v in
            sorted(by_name.items(), key=lambda kv: -kv[1])[:6]))
        assert sorted(ours.items()) == [
            ("rec_walk_kernel<float, 2>", 1),
            ("trop_kernel<true, float>", 1)], kcounts
    plain = []
    t_sweep_plain = cuda_ms(lambda: plain.append(ds.trop_sweep_plain(
        kop, a0, s0, ext, msh, first=True)), warm=False)
    walked = []
    t_walk_plain = cuda_ms(lambda: walked.append(vs.rec_walk_plain(
        wt, out[0], out[1], lengths, 0, s_end)), warm=False)
    twin = all(torch.equal(x, y) for x, y in zip(out, plain[0]))
    e_k6t = max(float((x.double() - y.double()).abs().max())
                for x, y in zip(out, plain[0]))
    w_ok = torch.equal(path, walked[0])
    bd = trop_bounds(dcf, B, N + 1)
    bw = walk_bounds(wt, path, s_end, lengths, 0, kop.Sp)
    print(f"phase 32: viterbi B={B} N={N} on the V=32 dense graph: decode "
          f"{t_dec:.3f} ms (median of 5) = {audio / (t_dec / 1e3):.1f} "
          f"audio-s/s; K6t sweep {t_sweep:.3f} ms ({1e3 * t_sweep / (N + 1):.2f}"
          f" us/frame; bound {bd[0]:.4f} ms, {bd[1]}), W2 walk "
          f"{t_walk:.3f} ms (bound {bw[0]:.4f} ms, {bw[1]}); device idle "
          f"{idle}; plain twins {t_sweep_plain:.1f} / {t_walk_plain:.1f} ms, "
          f"K6t and W2 bit-equal to them at this shape {twin} / {w_ok}; "
          "K6t's frame (us): " + ", ".join(f"{k} {v:.2f}"
                                         for k, v in split.items()))
    assert twin and w_ok, "K6t or W2 differs from its twin at N=700"

    fsm5, spdf5, P5 = hmm5()
    cf5 = mt.compile_fsm(fsm5, spdf5, P5, device=dev)
    cf5c = mt.compile_fsm(fsm5, spdf5, P5, device="cpu")
    lhs5 = np.random.default_rng(1).normal(size=(1, 100, P5)).astype(
        np.float32)
    reset_all_launches()
    s5, z5 = mt.viterbi(cf5, torch.from_numpy(lhs5).to(dev))
    c5 = {k: v for k, v in all_launches().items() if v}
    s5c, z5c = mt.viterbi(cf5c, torch.from_numpy(lhs5))
    ref5 = mt.oracle.host_viterbi_score(fsm5, spdf5, P5,
                                        lhs5.astype(np.float64),
                                        np.array([100]))
    same5 = bool((s5.cpu() == s5c).all())
    print(f"phase 32: BASELINE.json config 1 (left-to-right 5-state HMM, "
          f"T=100, strategy {cf5.strategy!r}, Sp = {cf5.padded_states}) on "
          f"the card: launches {c5}; states equal to the CPU route's "
          f"{same5}; score {float(z5[0]):.5f} (CPU {float(z5c[0]):.5f}, f64 "
          f"optimum {float(ref5[0]):.5f})")
    assert same5 and c5 == {"dense_trop": 1, "rec_walk": 1}, "config 1"
    assert abs(float(z5[0]) - ref5[0]) <= TOL_VIT_ORACLE, "config 1 score"
    return ({"K6t": (t_sweep, t_sweep_plain), "W2": (t_walk, t_walk_plain)},
            {"K6t": e_k6t, "W2": 0.0}, {"K6t": bd, "W2": bw}, t_dec, counts)


def phase_block_recompute(fsm, spdf, cf, P, dev, B=128, N=1024, K=64,
                          label="phase 33", name="2M-arc"):
    """Phase 33 (37): the 2M-arc graph (the separate-state graph, through
    K7n's family branch) at B=128, N=1,024, past the id stream's budget:
    the route is the chunk-recompute decode (K7n once for the checkpoints,
    then per chunk one K7n and one W2), every path walked in f64; the
    decode (median of 3), the checkpoint sweep, one chunk's recompute and
    walk timed, their plain twins timed and held to them; then at N=700
    (phase 17's or 36's input) the recompute route called directly beside
    the K7 decode: scores within TOL_VIT, every path of both f64-valid, and
    the sequences whose states differ counted (near-ties of the two
    routes' arithmetic; each such path within TOL_VIT_WALK of the other
    route's score)."""
    import importlib

    import torch

    import markovmodels_tpu_torch as mt
    from markovmodels_tpu_torch.ops import block_scan as bs
    from markovmodels_tpu_torch.ops import vit_scan as vs
    from markovmodels_tpu_torch.ops.emissions import prepare_emissions

    tvit = importlib.import_module("markovmodels_tpu_torch.viterbi")
    rng = np.random.default_rng(0)
    lhs = torch.from_numpy(make_inputs(rng, B, N, P)).to(dev)
    lengths = torch.full((B,), N, dtype=torch.int32, device=dev)
    reason = tvit._bp_vit_reject_reason(cf, lhs)
    assert reason is not None and "budget" in reason, reason
    C = -(-(N + 1) // K)
    torch.cuda.synchronize()
    reset_all_launches()
    states, score = mt.viterbi(cf, lhs, lengths)
    torch.cuda.synchronize()
    counts = all_launches()
    want = {k: 0 for k in counts}
    want.update(vit_fwd_noid=1 + C, rec_walk=C)
    fam = dict(vs.LAUNCHES_FAM)
    print(f"{label}: {name} decode B={B} N={N}: route reason: {reason}; "
          f"launches {json.dumps(counts)}, of them in the family branch "
          f"{json.dumps(fam)}")
    assert counts == want, f"the over-budget decode launched {counts}"
    is_fam = vs._is_fam(bs.kernel_operator(cf, torch.float32))
    assert fam == {"vit_fwd": 0, "vit_fwd_noid": (1 + C) * is_fam}, fam
    st, sc = states.cpu().numpy(), score.cpu().numpy()
    assert st.shape == (B, N) and np.isfinite(sc).all(), "block decode"
    gap = mt.oracle.validate_paths(fsm, spdf, lhs.cpu().numpy(),
                                   lengths.cpu().numpy(), st, sc,
                                   atol=TOL_VIT_WALK)
    t_dec = median_ms({"decode": lambda: mt.viterbi(cf, lhs, lengths)},
                      reps=3)["decode"]
    ext, msh = prepare_emissions(lhs, lengths, P)
    t_ck = cuda_ms(lambda: vs.viterbi_fwd(cf, ext, msh, ids=False,
                                          stride=K), reps=2)
    ck = vs.viterbi_fwd(cf, ext, msh, ids=False, stride=K)
    ck_plain = []
    t_ck_plain = cuda_ms(lambda: ck_plain.append(vs.viterbi_fwd_plain(
        cf, ext, msh, ids=False, stride=K)), warm=False)
    ck_twin = all(torch.equal(x, y) for x, y in zip(ck, ck_plain[0]))
    del ck_plain
    c = C // 2  # a chunk from the middle, from its checkpoint
    t0 = c * K
    rec = dict(a0=ck[0][c - 1], s0=ck[1][c - 1], t0=t0)
    e_c, m_c = ext[t0:t0 + K], msh[t0:t0 + K]
    out = vs.viterbi_fwd(cf, e_c, m_c, ids=False, **rec)
    wt = vs.rec_walk_tables(cf)
    # the chunk's walk starts from the decoded state of the frame after it
    # (host ids back to compiled ones)
    real = torch.nonzero(cf.orig_state >= 0)[:, 0]
    to_compiled = torch.empty_like(cf.orig_state)
    to_compiled[cf.orig_state[real].long()] = real.to(torch.int32)
    s_end = to_compiled[states[:, t0 + K].long()].contiguous()
    t_rec = cuda_ms(lambda: vs.viterbi_fwd(cf, e_c, m_c, ids=False, **rec),
                    reps=3)
    t_walk = cuda_ms(lambda: vs.rec_walk(wt, out[0], out[1], lengths, t0,
                                         s_end), reps=5)
    plain = []
    t_rec_plain = cuda_ms(lambda: plain.append(vs.viterbi_fwd_plain(
        cf, e_c, m_c, ids=False, **rec)), warm=False)
    walked = []
    t_walk_plain = cuda_ms(lambda: walked.append(vs.rec_walk_plain(
        wt, out[0], out[1], lengths, t0, s_end)), warm=False)
    twin = all(torch.equal(x, y) for x, y in zip(out, plain[0]))
    e_k7n = max(float((x.double() - y.double()).abs().max())
                for x, y in zip(out, plain[0]))
    w_ok = torch.equal(vs.rec_walk(wt, out[0], out[1], lengths, t0, s_end),
                       walked[0])
    audio = B * N * FRAME_SHIFT_S
    b_ck = noid_bounds(cf, B, N + 1, (N + 1) // K)
    b_rec = noid_bounds(cf, B, K, K)
    b_walk = walk_bounds(wt, walked[0], s_end, lengths, t0, cf.padded_states)
    print(f"{label}: all {B} paths walked in float64, max |path weight - "
          f"score| = {gap:.3e} (tol {TOL_VIT_WALK:g}); decode {t_dec:.3f} "
          f"ms (median of 3) = {audio / (t_dec / 1e3):.1f} audio-s/s; K7n "
          f"checkpoint sweep {t_ck:.3f} ms over {N + 1} frames "
          f"({1e3 * t_ck / (N + 1):.2f} us/frame; bound {b_ck[0]:.3f} ms), "
          f"one {K}-frame recompute {t_rec:.3f} ms (bound {b_rec[0]:.3f} "
          f"ms), its W2 walk {t_walk:.3f} ms (bound {b_walk[0]:.4f} ms, "
          f"{b_walk[1]}); plain twins "
          f"{t_ck_plain:.1f} (sweep) / {t_rec_plain:.1f} (recompute) / "
          f"{t_walk_plain:.1f} ms, K7n (sweep, recompute) and W2 bit-equal "
          f"to them {ck_twin}, {twin} / {w_ok}")
    assert ck_twin and twin and w_ok, "K7n or W2 differs from its twin"
    del ck, out, plain

    n7 = 700
    rng = np.random.default_rng(0)
    lhs7 = torch.from_numpy(make_inputs(rng, B, n7, P)).to(dev)
    len7 = torch.full((B,), n7, dtype=torch.int32, device=dev)
    assert tvit._bp_vit_reject_reason(cf, lhs7) is None
    s_bp, z_bp = mt.viterbi(cf, lhs7, len7)
    s_rc, z_rc = tvit._viterbi_recompute(cf, lhs7, len7)
    s_bp, z_bp, s_rc, z_rc = (x.cpu().numpy() for x in (s_bp, z_bp, s_rc,
                                                         z_rc))
    dz = float(np.abs(z_bp - z_rc).max())
    lh, ln = lhs7.cpu().numpy(), len7.cpu().numpy()
    g_bp = mt.oracle.validate_paths(fsm, spdf, lh, ln, s_bp, z_bp,
                                    atol=TOL_VIT_WALK)
    g_rc = mt.oracle.validate_paths(fsm, spdf, lh, ln, s_rc, z_rc,
                                    atol=TOL_VIT_WALK)
    diff = np.flatnonzero((s_bp != s_rc).any(axis=1))
    g_x = (mt.oracle.validate_paths(fsm, spdf, lh[diff], ln[diff],
                                    s_rc[diff], z_bp[diff],
                                    atol=TOL_VIT_WALK) if len(diff) else 0.0)
    print(f"{label}: N={n7}: the recompute route beside K7's decode: "
          f"max |dscore| = {dz:.3e} (tol {TOL_VIT:g}); paths f64-valid "
          f"within {g_bp:.3e} (K7) / {g_rc:.3e} (recompute); {len(diff)} of "
          f"{B} sequences' states differ, each within {g_x:.3e} of K7's "
          f"score")
    assert dz <= TOL_VIT, "the two routes' scores disagree"
    return ({"K7n": (t_ck, t_ck_plain), "K7n recompute": (t_rec, t_rec_plain),
             "W2": (t_walk, t_walk_plain)},
            {"K7n": e_k7n}, {"K7n": b_ck, "K7n recompute": b_rec,
                             "W2": b_walk},
            t_dec, counts)


def phase_ov_vit_kernels(cf, P, dev, B=128, N=128):
    """Phase 34: K7's family branch and the walk with its decode tables
    against their plain twins on the separate-state graph at N=128
    (phase 15's input: lengths 1, 2 (infeasible: shorter than the 3-state
    HMMs) and N mixed, ±30-nat cliffs), B=128 and B=126 (the scalar
    branch): K7 run twice, bit-equal run to run, ids and omega argmaxes
    bit-equal to the twin, the walk equal to its twin; K7n's family branch
    bit-equal to its twin on the same input."""
    import torch

    from markovmodels_tpu_torch.ops import vit_scan as vs
    from markovmodels_tpu_torch.ops.emissions import prepare_emissions

    lhs, lens = vit_inputs(P, dev, B, N)
    lens[4] = 2
    ext, msh = prepare_emissions(lhs, lens, P)
    vs.reset_launch_counts()
    out_k = vs.viterbi_fwd(cf, ext, msh)
    out_k2 = vs.viterbi_fwd(cf, ext, msh)
    torch.cuda.synchronize()
    assert vs.LAUNCHES_FAM["vit_fwd"] == 2, "K7 took the uniform branch"
    again = all(torch.equal(x, y) for x, y in zip(out_k, out_k2))
    out_p = vs.viterbi_fwd_plain(cf, ext, msh)
    n_bp = int((out_k[0] != out_p[0]).sum())
    n_fin = int((out_k[1] != out_p[1]).sum())
    zk, zp = vit_score(out_k), vit_score(out_p)
    fin = np.isfinite(zp)
    assert (np.isfinite(zk) == fin).all(), "K7: -inf pattern differs"
    assert fin.sum() > B // 2 and not fin[1] and not fin[4], \
        "K7: unexpected -inf pattern"
    serr = float(np.abs(zk[fin] - zp[fin]).max())
    wt = vs.walk_tables(cf)
    sk = vs.walk(wt, out_k[0], out_k[1], lens)
    torch.cuda.synchronize()
    sp = vs.walk_plain(wt, out_k[0], out_k[1], lens)
    werr = float((sk - sp).abs().max())
    nk = vs.viterbi_fwd(cf, ext, msh, ids=False)
    n_twin = all(torch.equal(x, y) for x, y in zip(
        nk, vs.viterbi_fwd_plain(cf, ext, msh, ids=False)))
    print(f"phase 34: B={B}: K7 (family branch) run twice bit-equal "
          f"{again}; vs plain: {n_bp} of {out_k[0].numel()} ids and {n_fin} "
          f"of {out_k[1].numel()} omega argmaxes differ; max |dscore| = "
          f"{serr:.3e} (tol {TOL_VIT:g}); walk kernel vs plain max |dstate| "
          f"= {werr:g}; K7n (family branch) bit-equal to its twin {n_twin}")
    assert again, "K7's family branch differs run to run"
    assert n_bp == 0 and n_fin == 0, "K7 ids differ from the plain twin"
    assert serr <= TOL_VIT, f"K7 scores disagree: {serr}"
    assert werr == 0, "the walk kernel disagrees with its plain twin"
    assert n_twin, "K7n's family branch differs from its twin"
    return {"K7": serr, "K7w": werr, "K7n": 0.0}


def phase_ov_vit_main(fsm, spdf, cf, efsm, espdf, ecf, P, dev, t_dec2m,
                      B=128, N=700):
    """Phase 36: the decode of the separate-state graph at B=128, N=700
    (seed 0): exactly one K7 launch (its family branch) and one walk launch
    (counters and the profiler's kernel count), every path walked in f64;
    the decode (median of 5) beside phase 17's 2M-arc decode and beside the
    embedded layout's (the same LM, uniform K7; its paths walked too), the
    decode's parts and the device's idle share; K7 and the walk timed and
    held to their plain twins at this shape."""
    import torch

    import markovmodels_tpu_torch as mt
    from markovmodels_tpu_torch.ops import block_scan as bs
    from markovmodels_tpu_torch.ops import vit_scan as vs
    from markovmodels_tpu_torch.ops.emissions import prepare_emissions

    rng = np.random.default_rng(0)
    lhs = torch.from_numpy(make_inputs(rng, B, N, P)).to(dev)
    lengths = torch.full((B,), N, dtype=torch.int32, device=dev)
    torch.cuda.synchronize()
    reset_all_launches()
    states, score = mt.viterbi(cf, lhs, lengths)
    torch.cuda.synchronize()
    counts = {k: v for k, v in all_launches().items() if v}
    fam = dict(vs.LAUNCHES_FAM)
    print(f"phase 36: separate-state decode B={B} N={N}: launches "
          f"{json.dumps(counts)}, of them in the family branch "
          f"{json.dumps(fam)}")
    assert counts == {"vit_fwd": 1, "vit_walk": 1}, counts
    assert fam == {"vit_fwd": 1, "vit_fwd_noid": 0}, fam
    st, sc = states.cpu().numpy(), score.cpu().numpy()
    assert st.shape == (B, N) and st.dtype == np.int32, "output shapes"
    assert sc.shape == (B,) and np.isfinite(sc).all(), "non-finite score"
    gap = mt.oracle.validate_paths(fsm, spdf, lhs.cpu().numpy(),
                                   lengths.cpu().numpy(), st, sc,
                                   atol=TOL_VIT_WALK)
    elhs = torch.from_numpy(make_inputs(np.random.default_rng(0), B, N,
                                        ecf.num_pdfs)).to(dev)
    reset_all_launches()
    es, ez = mt.viterbi(ecf, elhs, lengths)
    torch.cuda.synchronize()
    ecounts = {k: v for k, v in all_launches().items() if v}
    assert ecounts == {"vit_fwd": 1, "vit_walk": 1}, ecounts
    assert vs.LAUNCHES_FAM["vit_fwd"] == 0, "the embedded layout is uniform"
    ez = ez.cpu().numpy()
    assert np.isfinite(ez).all(), "embedded decode: non-finite score"
    egap = mt.oracle.validate_paths(efsm, espdf, elhs.cpu().numpy(),
                                    lengths.cpu().numpy(), es.cpu().numpy(),
                                    ez, atol=TOL_VIT_WALK)
    med = median_ms({"separate": lambda: mt.viterbi(cf, lhs, lengths),
                     "embedded": lambda: mt.viterbi(ecf, elhs, lengths)})
    audio = B * N * FRAME_SHIFT_S
    print(f"phase 36: all {B} paths walked in float64: max |path weight - "
          f"score| = {gap:.3e} (embedded layout {egap:.3e}; tol "
          f"{TOL_VIT_WALK:g}); decode (median of 5) separate-state "
          f"{med['separate']:.3f} ms = "
          f"{audio / (med['separate'] / 1e3):.1f} audio-s/s, embedded "
          f"layout {med['embedded']:.3f} ms, 2M-arc (phase 17) "
          f"{t_dec2m:.3f} ms; separate/embedded "
          f"{med['separate'] / med['embedded']:.3f}")
    prof = profile_device(lambda: mt.viterbi(cf, lhs, lengths))
    if prof is None:
        print("phase 36: profile of the decode: not measured (no device "
              "events recorded)")
    else:
        by_name, busy, span, pcounts = prof
        top = sorted(by_name.items(), key=lambda kv: -kv[1])
        print(f"phase 36: profile of one decode: device busy {busy:.3f} ms "
              f"of a {span:.3f} ms span (idle {1 - busy / span:.1%}); "
              + "; ".join(f"{k} {v:.3f} ms ({pcounts[k]} launches)"
                          for k, v in top))
        vit = {k: v for k, v in pcounts.items() if k.startswith("vit_")}
        assert sorted(vit.items()) == [
            ("vit_sweep_kernel<true, true, true, float>", 1),
            ("vit_walk_kernel<unsigned char, true>", 1)], pcounts
    parts = decode_parts(cf, lhs, lengths)
    print("phase 36: decode parts: " + "; ".join(
        f"{k} {v:.3f} ms" for k, v in parts.items()))
    ext, msh = prepare_emissions(lhs, lengths, P)
    wt = vs.walk_tables(cf)
    out = vs.viterbi_fwd(cf, ext, msh)
    t_sweep = cuda_ms(lambda: vs.viterbi_fwd(cf, ext, msh), reps=2)
    t_walk = cuda_ms(lambda: vs.walk(wt, out[0], out[1], lengths), reps=10)
    split = vit_frame_split(cf, ext, msh)
    print("timing: K7 (family branch) frame split on the separate-state "
          "graph: " + "; ".join(f"{k} {v:.2f} us" for k, v in split.items())
          + f" per frame ({vs._vit_grid(bs.kernel_operator(cf), dev, B)} "
          "CTAs)")
    plain, walked = [], []
    t_plain = cuda_ms(lambda: plain.append(vs.viterbi_fwd_plain(cf, ext, msh)),
                      warm=False)
    t_walk_plain = cuda_ms(lambda: walked.append(
        vs.walk_plain(wt, out[0], out[1], lengths)), warm=False)
    out_p = plain[0]
    n_bp = int((out[0] != out_p[0]).sum())
    n_fin = int((out[1] != out_p[1]).sum())
    serr = float(np.abs(vit_score(out) - vit_score(out_p)).max())
    werr = float((vs.walk(wt, out[0], out[1], lengths) - walked[0])
                 .abs().max())
    print(f"timing: K7 (family branch) at B={B} N={N}: kernel {t_sweep:.3f} "
          f"ms ({1e3 * t_sweep / (N + 1):.2f} us/frame), plain "
          f"{t_plain:.3f} ms; walk kernel {t_walk:.3f} ms, plain "
          f"{t_walk_plain:.3f} ms; vs plain: {n_bp} ids and {n_fin} omega "
          f"argmaxes differ, max |dscore| = {serr:.3e}, walk max |dstate| = "
          f"{werr:g}")
    assert n_bp == 0 and n_fin == 0, "K7 ids differ from the plain twin"
    assert serr <= TOL_VIT, f"K7 scores disagree: {serr}"
    assert werr == 0, "the walk kernel disagrees with its plain twin"
    return (counts, {"K7": (t_sweep, t_plain), "K7w": (t_walk, t_walk_plain)},
            med, {"K7": serr, "K7w": werr}, split)


# ---- float64 and general Ĉ (phases 38-41) ----------------------------------
# K2-K4's float64 instantiation against its float64 twin: the same sums in
# another order, in float64 (53 bits), compounded over 704 frames: logZ
# within 1e-12 relative, the states (each column normalised to max 1..2)
# and the posteriors within 1e-10
TOL_F64_LOGZ_REL = 1e-12
TOL_F64 = 1e-10


def phase_f64_kernels(cf, P, dev, label, B=8, N=700, chunk=64):
    """Phase 38: K2, K3 and K4 in their float64 instantiation against their
    float64 plain twins on one input (lengths 1, 2N/3, N/2+1 and N mixed,
    ±30-nat cliffs): K2's checkpoints, last state, shift and ksum (as
    logZ), every chunk's K3 alphas from K2's checkpoint and K4's
    posteriors and outgoing beta over the whole backward; every kernel call
    run twice, bit-equal.  Returns {name: max abs error} (K2's includes
    |dlogZ|)."""
    import torch

    from markovmodels_tpu_torch.ops import block_scan as bs
    from markovmodels_tpu_torch.ops.emissions import (pad_emissions,
                                                      prepare_emissions)

    f64 = torch.float64
    rng = np.random.default_rng(1)
    lhs = torch.from_numpy(make_inputs(rng, B, N, P, cliffs=True)).to(
        dev, f64)
    lens_np = rng.integers(1, N + 1, size=B).astype(np.int32)
    lens_np[:4] = [N, 1, 2 * N // 3, N // 2 + 1]
    lens = torch.from_numpy(lens_np).to(dev)
    kop = bs.kernel_operator(cf)
    assert kop.fwd.W.dtype == kop.bwd.W.dtype == kop.alpha0.dtype == f64
    ext, msh = prepare_emissions(lhs, lens, P, f64)
    Nf = N + 1
    K = min(chunk, Nf)
    C = -(-Nf // K)
    Npad = C * K
    ext, msh = pad_emissions(ext, msh, Npad)
    a0 = kop.alpha0[:, None].expand(kop.Sp, B).contiguous()

    def twice(fn, name):
        out = fn()
        assert all(torch.equal(x, y) for x, y in zip(out, fn())), \
            f"{name} differs run to run"
        return out

    bs.reset_launch_counts()
    fk = twice(lambda: bs.fwd_sweep(kop, a0, ext, msh, K), "K2 (float64)")
    torch.cuda.synchronize()
    fp = bs.fwd_sweep_plain(kop, a0, ext, msh, K)
    zk, zp = sweep_logz(kop, fk), sweep_logz(kop, fp)
    fin = np.isfinite(zp)
    assert (np.isfinite(zk) == fin).all() and not fin[1], "K2: -inf pattern"
    zrel = float((np.abs(zk[fin] - zp[fin])
                  / np.maximum(np.abs(zp[fin]), 1.0)).max())
    errs = {"K2": sweep_err(kop, fk, fp)}
    errs["K3"] = errs["K4"] = 0.0
    beta = torch.ones_like(a0)
    bsc = torch.ones(B, device=dev, dtype=f64)
    for c in reversed(range(C)):  # every chunk: K3, then K4
        sl = slice(c * K, (c + 1) * K)
        ak, sk = twice(lambda: bs.recompute(kop, fk[0][c], fk[1][c], ext[sl],
                                            c * K), "K3 (float64)")
        ap, sp = bs.recompute_plain(kop, fk[0][c], fk[1][c], ext[sl], c * K)
        errs["K3"] = max(errs["K3"], float(
            (scaled(ak, sk) - scaled(ap, sp)).abs().max()))
        out = twice(lambda: bs.backward(kop, beta, bsc, ak, sk, ext[sl],
                                        c * K, Npad), "K4 (float64)")
        ref = bs.backward_plain(kop, beta, bsc, ak, sk, ext[sl], c * K, Npad)
        errs["K4"] = max(errs["K4"], bwd_err(out, ref))
        beta, bsc = out[1], out[2]
    torch.cuda.synchronize()
    counts = dict(bs.LAUNCHES_F64)
    assert counts == {"block_fwd": 2, "block_recompute": 2 * C,
                      "block_bwd": 2 * C}, counts
    assert not any(bs.LAUNCHES.values()) and not any(
        bs.LAUNCHES_BF16.values()), "a float32 kernel ran for float64"
    print(f"{label}: K2 vs its float64 twin: logZ relative {zrel:.3e} "
          f"(tol {TOL_F64_LOGZ_REL:g}); max |err| K2 {errs['K2']:.3e}, K3 "
          f"{errs['K3']:.3e} over {C} chunks, K4 {errs['K4']:.3e} (tol "
          f"{TOL_F64:g}); K2 twice, K3 and K4 twice on each chunk: "
          f"bit-equal; float64 launches {json.dumps(counts)}")
    assert zrel <= TOL_F64_LOGZ_REL, f"K2 logZ: {zrel}"
    assert all(np.isfinite(e) and e <= TOL_F64 for e in errs.values()), errs
    return errs


def step_fns(num, den, P, dev, dtype, B=128, N=700):
    """(the training step, den-only pdfposteriors) on phase 9's input, the
    log-likelihoods in ``dtype``."""
    import torch

    import markovmodels_tpu_torch as mt

    rng = np.random.default_rng(0)
    lhs = torch.from_numpy(make_inputs(rng, B, N, P)).to(dev, dtype)
    lens = torch.full((B,), N, dtype=torch.int32, device=dev)

    def run():
        x = lhs.clone().requires_grad_()
        mt.lfmmi_loss(num, den, x, lens).sum().backward()
    return run, lambda: mt.pdfposteriors(den, lhs, lens)


def phase_f64_steps(pairs, label, C=11):
    """Phase 40: per graph, the LF-MMI step and den-only pdfposteriors in
    float32 and float64 (float64 stacked numerators), medians of 5 warm
    runs in turns; one float64 step's launches counted: exactly 1 + C + C
    launches of K2-K4's float64 instantiation and one of each of K5a/K5b's,
    and no other kernel.  ``pairs``: {graph: ((f32 step, f32 den), (f64
    step, f64 den))}.  Returns ({graph: {name: ms}}, {graph: the float64
    step's launches of K2-K5})."""
    import torch

    out, launches = {}, {}
    for name, ((s32, d32), (s64, d64)) in pairs.items():
        reset_all_launches()
        s64()
        torch.cuda.synchronize()
        counts = {k: v for k, v in all_launches().items() if v}
        want = {"block_fwd_f64": 1, "block_recompute_f64": C,
                "block_bwd_f64": C, "banded_fwd_f64": 1,
                "banded_bwd_f64": 1}
        assert counts == want, f"{name} float64 step launches {counts}"
        launches[name] = {k.removesuffix("_f64"): v for k, v in counts.items()}
        t = median_ms({"f32 step": s32, "f64 step": s64, "f32 den": d32,
                       "f64 den": d64})
        out[name] = t
        print(f"{label}: {name} B=128 N=700 medians of 5: LF-MMI step f32 "
              f"{t['f32 step']:.2f} ms, f64 {t['f64 step']:.2f} ms (f64/f32 "
              f"{t['f64 step'] / t['f32 step']:.3f}); den-only f32 "
              f"{t['f32 den']:.2f} ms, f64 {t['f64 den']:.2f} ms (f64/f32 "
              f"{t['f64 den'] / t['f32 den']:.3f}); the f64 step's "
              f"launches {json.dumps(counts)}")
    return out, launches


def profile_f64_step(fn, label):
    """One float64 LF-MMI step under torch.profiler: busy time, idle share,
    kernels and launches, printed."""
    prof = profile_device(fn)
    if prof is None:
        print(f"{label}: profile of the float64 step: not measured (no "
              "device events recorded)")
        return None
    by_name, busy, span, counts = prof
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    print(f"{label}: profile of one float64 LF-MMI step: device busy "
          f"{busy:.3f} ms of a {span:.3f} ms span (idle {1 - busy / span:.1%}"
          f"), {sum(counts.values())} launches; " + "; ".join(
              f"{k} {v:.3f} ms ({counts[k]} launches)" for k, v in top))
    return prof


def multi_pdf_graph(V=8, every=3):
    """The V-word LM ∘ HMM graph with a general Ĉ: each state's own pdf,
    and every ``every``-th real state one more, the next pdf.  Returns
    (fsm, Ĉ, P)."""
    import markovmodels_tpu_torch as mt

    fsm, spdf, P, _ = mt.workloads.make_lm_hmm_graph(V=V)
    S1 = len(spdf)
    sets = [[int(spdf[s])] + ([(int(spdf[s]) + 1) % P]
                              if s % every == 1 and s < S1 - 1 else [])
            for s in range(S1)]
    rows = np.repeat(np.arange(S1), [len(x) for x in sets])
    cols = np.concatenate([np.array(x) for x in sets])
    C = mt.hostsparse.spmat_from_coo(rows, cols, np.zeros(len(rows)),
                                     (S1, P + 1), mt.LOG)
    return fsm, C, P


def phase_k5_f64(num64, P, dev, label="phase 41"):
    """Phase 41: K5a/K5b's float64 instantiation against its float64 twin
    on the main-path numerators (phase 7's input, run twice, bit-equal)
    and on 4 skip-arc numerators of ~1,200 states (the wide
    instantiation), only float64 launches; those 4 through
    ``pdfposteriors`` against the f64 oracle; then a G=128 stack of them
    (phase 8b's shape, float64): ``pdfposteriors`` through the kernels
    (the counts set to 0 before it, one float64 launch each after it),
    K5a and K5b twice (bit-equal) and against their twins, and timed; the
    main-path numerators timed; and the cluster instantiation in float64
    (``phase_cluster_f64``).  Returns (errs, times) of the
    main-path numerators, (launches, errs, times, bounds) of the G=128
    stack and of ``phase_cluster_f64``'s."""
    import torch

    import markovmodels_tpu_torch as mt
    from markovmodels_tpu_torch.ops import banded_scan as bsc
    from markovmodels_tpu_torch.ops.emissions import prepare_emissions

    f64 = torch.float64
    assert bsc.instantiations(num64).startswith("K5a narrow, K5b narrow")
    bsc.reset_launch_counts()
    errs = phase_banded_kernels(num64, P, dev, label, tol=TOL_F64)
    torch.cuda.synchronize()
    assert not any(bsc.LAUNCHES.values()), "a float32 K5 ran for float64"
    assert bsc.LAUNCHES_F64 == {"banded_fwd": 2, "banded_bwd": 2}, \
        bsc.LAUNCHES_F64
    graphs = skip_numerators(P, (1200, 1180, 1150, 1199), seed=7)
    compiled = [mt.compile_fsm(f, sp, P, strategy="banded", dtype=f64,
                               device=dev) for f, sp in graphs]
    big = mt.stack(compiled)
    Sp, nO = big.padded_states, len(big.banded_offsets)
    check_modes(bsc.kernel_operator(big), (bsc.WIDE,) * 2, label=label)
    N = 700
    rng = np.random.default_rng(8)
    lhs = torch.from_numpy(make_inputs(rng, 4, N, P, cliffs=True)).to(dev,
                                                                       f64)
    lens = torch.tensor([N, N - 10, N - 60, N], dtype=torch.int32,
                        device=dev)
    werrs = phase_banded_kernels(big, P, dev, f"{label} (wide, Sp = {Sp})",
                                 tol=TOL_F64,
                                 inputs=prepare_emissions(lhs, lens, P, f64))
    posts, z = mt.pdfposteriors(big, lhs, lens)
    z, posts, x = (t.cpu().numpy() for t in (z, posts, lhs))
    err = perr = 0.0
    for g, (fsm, spdf) in enumerate(graphs):
        rz, rp = mt.oracle.host_oracle(fsm, spdf, P, x[g:g + 1],
                                       lens[g:g + 1].cpu().numpy())
        err = max(err, float(np.abs(z[g] - rz[0])))
        perr = max(perr, float(np.abs(posts[g] - rp[0]).max()))
    print(f"{label}: float64 pdfposteriors G=4 N={N}, Sp = {Sp} (wide) vs "
          f"f64 oracle |dlogZ| = {err:.3e}, |dposts| = {perr:.3e} (tol "
          f"{TOL_ORACLE:g})")
    assert err <= TOL_ORACLE and perr <= TOL_ORACLE, "oracle gate failed"

    wide = mt.stack(compiled * 32)
    lhs = torch.from_numpy(make_inputs(np.random.default_rng(0), 128, N,
                                       P)).to(dev, f64)
    lens = torch.from_numpy(np.tile(np.array([N, N - 10, N - 60, N],
                                             dtype=np.int32), 32)).to(dev)
    bsc.reset_launch_counts()
    posts, z = mt.pdfposteriors(wide, lhs, lens)
    torch.cuda.synchronize()
    wl = dict(bsc.LAUNCHES_F64)
    assert not any(bsc.LAUNCHES.values()), "a float32 K5 ran for float64"
    assert wl == {"banded_fwd": 1, "banded_bwd": 1}, wl
    assert torch.isfinite(z).all(), "infeasible numerator"
    print(f"{label}: float64 pdfposteriors G=128 N={N}, Sp = {Sp}: path "
          f"{mt.fast_path_report(wide, 128)}; launches {json.dumps(wl)}")
    del posts
    kop = bsc.kernel_operator(wide)
    ext, msh = prepare_emissions(lhs, lens, P, f64)
    w128 = held_to_twins(kop, ext, msh, f"{label}: float64 G=128 N={N}, "
                                        f"Sp = {Sp} (wide)")
    wtimes = time_banded(wide, P, dev, (ext, msh), f"wide, float64, Sp = {Sp}")
    times = time_banded(num64, P, dev, tag="float64")
    wbounds = banded_bounds(wide, N + 1)
    del ext, msh, kop, wide
    c64 = phase_cluster_f64(P, dev, label)
    return ({k: max(v, werrs[k]) for k, v in errs.items()}, times,
            (wl, w128, wtimes, wbounds), c64)


def phase_cluster_f64(P, dev, label="phase 41", G=8, N=2400):
    """Phase 41, last: K5a/K5b's float64 cluster instantiation (K5a one CTA
    a graph, K5b a cluster of 2: its pdf partials added across the CTAs)
    on a G=8 float64 stack of ~3,000-state skip-arc lattices at N=2,400:
    ``pdfposteriors`` through the kernels (the counts set to 0 before it,
    one float64 launch each after it), against the f64 oracle on the
    first 4 lattices, K5a and K5b twice (bit-equal) and against their
    twins, and timed.  Returns (launches, errs, times, bounds)."""
    import torch

    import markovmodels_tpu_torch as mt
    from markovmodels_tpu_torch.ops import banded_scan as bsc
    from markovmodels_tpu_torch.ops.emissions import prepare_emissions

    f64 = torch.float64
    graphs = skip_numerators(P, (3000, 2950, 2900, 2990), seed=7)
    compiled = [mt.compile_fsm(f, sp, P, strategy="banded", dtype=f64,
                               device=dev) for f, sp in graphs]
    big = mt.stack(compiled * (G // 4))
    kop = bsc.kernel_operator(big)
    check_modes(kop, (bsc.CLUSTER,) * 2, (1, 2), label=label)
    lhs = torch.from_numpy(make_inputs(np.random.default_rng(0), G, N,
                                       P)).to(dev, f64)
    lens = torch.from_numpy(np.tile(np.array([N, N - 20, N - 50, N],
                                             dtype=np.int32),
                                    G // 4)).to(dev)
    bsc.reset_launch_counts()
    posts, z = mt.pdfposteriors(big, lhs, lens)
    torch.cuda.synchronize()
    launches = dict(bsc.LAUNCHES_F64)
    assert not any(bsc.LAUNCHES.values()), "a float32 K5 ran for float64"
    assert launches == {"banded_fwd": 1, "banded_bwd": 1}, launches
    z, posts, x = (t.cpu().numpy() for t in (z, posts, lhs))
    err = perr = 0.0
    for g, (fsm, spdf) in enumerate(graphs):
        rz, rp = mt.oracle.host_oracle(fsm, spdf, P, x[g:g + 1],
                                       lens[g:g + 1].cpu().numpy())
        assert np.isfinite(rz[0]) and np.isfinite(z[g]), "infeasible"
        err = max(err, float(np.abs(z[g] - rz[0])))
        perr = max(perr, float(np.abs(posts[g] - rp[0]).max()))
    print(f"{label}: float64 pdfposteriors G={G} N={N}, Sp = {kop.Sp} "
          f"({bsc.instantiations(big)}) vs f64 oracle |dlogZ| = "
          f"{err:.3e}, |dposts| = {perr:.3e} (tol {TOL_ORACLE:g}); "
          f"launches {json.dumps(launches)}")
    assert err <= TOL_ORACLE and perr <= TOL_ORACLE, "oracle gate failed"
    del posts, z
    ext, msh = prepare_emissions(lhs, lens, P, f64)
    errs = held_to_twins(kop, ext, msh, f"{label}: float64 G={G} N={N}, "
                                        f"Sp = {kop.Sp} (cluster)")
    assert all(e <= TOL_F64 for e in errs.values()), errs
    times = time_banded(big, P, dev, (ext, msh),
                        f"cluster, float64, Sp = {kop.Sp}, G={G}, N = {N}")
    return launches, errs, times, banded_bounds(big, N + 1)


def set_oracle(fsm, sets, P, lhs, lengths):
    """The float64 oracles of a general-Ĉ graph (the pdf-set oracle of the
    JAX package's multi-pdf tests, on ``oracle.host_oracle``'s frames): a
    state's emission the sum of its pdfs' likelihoods (the decode: the max
    of their log-likelihoods), a pdf's posterior the gammas of the states
    whose set holds it over the frame's pdf-space total.  ``sets``: each
    real state's pdfs.  Returns (logZ (B,), posteriors (B, N, P), best-path
    scores (B,))."""
    import scipy.sparse as sp

    import markovmodels_tpu_torch as mt

    rows, cols, data = mt.hostsparse.findnz(fsm.T_hat)
    data = np.asarray(data, dtype=np.float64)
    S1 = len(fsm.alpha_hat)
    Tt = sp.csr_matrix((np.exp(data), (cols, rows)), shape=(S1, S1))
    Tm = Tt.T.tocsr()
    la0 = np.asarray(fsm.alpha_hat, dtype=np.float64)
    M = np.zeros((S1 - 1, P))
    for s, ps in enumerate(sets):
        M[s, ps] = 1.0
    B, N, _ = lhs.shape
    logZ, best, posts = [], [], np.zeros((B, N, P))
    for b in range(B):
        L = int(lengths[b])

        def emis(t):
            e = np.zeros(S1)
            if t < L:
                e[: S1 - 1] = M @ np.exp(lhs[b, t])
            else:
                e[S1 - 1] = 1.0
            return e

        A = np.zeros((L + 1, S1))
        v, shift = np.exp(la0), 0.0
        for t in range(L + 1):
            v = (v if t == 0 else Tt @ v) * emis(t)
            m = v.max()
            if m > 0:
                v, shift = v / m, shift + np.log(m)
            A[t] = v
        logZ.append(np.log(v[S1 - 1]) + shift if v[S1 - 1] > 0 else -np.inf)
        bb = np.zeros(S1)
        bb[S1 - 1] = 1.0
        for t in range(L, -1, -1):
            y = bb if t == L else Tm @ bb
            if y.max() > 0:
                y = y / y.max()
            if t < L:
                gp = (A[t] * y)[: S1 - 1] @ M
                posts[b, t] = gp / (gp.sum() if gp.sum() > 0 else 1.0)
            bb = y * emis(t)
        lv = la0.copy()
        for t in range(L + 1):
            if t > 0:
                y = np.full(S1, -np.inf)
                np.maximum.at(y, cols, data + lv[rows])
                lv = y
            e = np.full(S1, -np.inf)
            if t < L:
                e[: S1 - 1] = [lhs[b, t][ps].max() for ps in sets]
            else:
                e[S1 - 1] = 0.0
            lv = lv + e
        best.append(lv[S1 - 1])
    return np.array(logZ), posts, np.array(best)


def phase_card_routes(dev, big, card, label="phase 50"):
    """Phase 50: the graphs whose JAX counterpart runs in XLA answer on the
    card through the port's plain routes, launching no kernel: the
    general-Ĉ V=8 graph ('dense' and 'block', float32 and float64) and the
    'block' graphs that K2-K4 refuse (the V=16 one-hot reduction of
    ``reorder='none'``, the V=32 graph's two tiers, the V=64 generic
    gather/scatter), each through ``pdfposteriors``, ``lfmmi_loss`` with it
    as the denominator (2 stacked log-domain numerators, plain too) and
    ``viterbi`` at B=2, N=40 against the f64 oracles (logZ, posteriors and
    the loss's gradient at 1e-4 each, the loss at 2e-4, the Viterbi score
    at 1e-3) and against the same calls on the CPU; ``fast_path_report``
    names the plain route; no K2-K7 launch.  Then the 2M-arc graph
    compiled at ``ov_cap=64`` (two tiers): one den-only ``pdfposteriors``
    and one ``viterbi`` at B=128, N=700 timed (``big``: (fsm, spdf, P))."""
    import torch

    import markovmodels_tpu_torch as mt

    f32, f64 = torch.float32, torch.float64
    fsm8, C8, P8 = multi_pdf_graph()
    sets8 = [list(C8.indices[C8.indptr[s]:C8.indptr[s + 1]])
             for s in range(len(C8.indptr) - 2)]
    cases = []  # (name, fsm, spdf or None, sets or None, P, kw, dtype)
    for strategy in ("dense", "block"):
        for dt in (f32, f64):
            cases.append((f"general-C-hat V=8 {strategy!r} "
                          f"{str(dt)[6:]}", fsm8, C8, sets8, P8,
                          dict(strategy=strategy, dtype=dt), dt))
    for V, reorder, what in ((16, "none", "one-hot reduction"),
                             (32, "auto", "two tiers"),
                             (64, "auto", "generic gather/scatter")):
        fsm, spdf, P, _ = mt.workloads.make_lm_hmm_graph(V=V)
        cases.append((f"V={V} 'block' ({what})", fsm, spdf, None, P,
                      dict(strategy="block", reorder=reorder), f32))
    n = 40
    lens = np.array([n, 2 * n // 3], dtype=np.int32)
    reset_all_launches()
    for name, fsm, spdf, sets, P, kw, dt in cases:
        cf = mt.compile_fsm(fsm, spdf, P, device=dev, **kw)
        ccf = mt.compile_fsm(fsm, spdf, P, device="cpu", **kw)
        report = mt.fast_path_report(cf, 2)
        assert report.startswith("plain torch scan on the card"), report
        rng = np.random.default_rng(50)
        lhs = rng.normal(size=(2, n, P))
        nums = build_numerators(P, G=2, Lp=12, seed=51)
        num = mt.stack([mt.compile_fsm(f, sp, P, strategy="banded",
                                       domain="log", dtype=dt, device=dev)
                        for f, sp in nums])
        if sets is None:
            rz, rp = mt.oracle.host_oracle(fsm, spdf, P, lhs, lens)
            rv = mt.oracle.host_viterbi_score(fsm, spdf, P, lhs, lens)
        else:
            rz, rp, rv = set_oracle(fsm, sets, P, lhs, lens)
        nz, npst = zip(*(mt.oracle.host_oracle(f, sp, P, lhs[g:g + 1],
                                               lens[g:g + 1])
                         for g, (f, sp) in enumerate(nums)))
        nz, npst = np.concatenate(nz), np.concatenate(npst)
        x = torch.from_numpy(lhs).to(dev, dt)
        tl = torch.from_numpy(lens).to(dev)
        posts, z = mt.pdfposteriors(cf, x, tl)
        xg = x.clone().requires_grad_(True)
        loss = mt.lfmmi_loss(num, cf, xg, tl)
        loss.sum().backward()
        states, score = mt.viterbi(cf, x, tl)
        z, posts, score = (t.cpu().numpy() for t in (z, posts, score))
        errs = {"logZ": np.abs(z - rz).max(),
                "posts": np.abs(posts - rp).max(),
                "loss": np.abs(loss.detach().cpu().numpy() - (rz - nz)).max(),
                "grad": np.abs(xg.grad.cpu().numpy() - (rp - npst)).max(),
                "score": np.abs(score - rv).max()}
        for k, tol in (("logZ", TOL_ORACLE), ("posts", TOL_ORACLE),
                       ("loss", 2 * TOL_ORACLE), ("grad", TOL_ORACLE),
                       ("score", TOL_VIT_ORACLE)):
            assert errs[k] <= tol, f"{name}: {k} {errs[k]} > {tol}"
        # the same route on the CPU
        cx, ctl = torch.from_numpy(lhs).to(dt), torch.from_numpy(lens)
        cposts, cz = mt.pdfposteriors(ccf, cx, ctl)
        cstates, cscore = mt.viterbi(ccf, cx, ctl)
        cpu = {"logZ": np.abs(z - cz.numpy()).max(),
               "posts": np.abs(posts - cposts.numpy()).max(),
               "score": np.abs(score - cscore.numpy()).max()}
        same = int((states.cpu() == cstates).all(dim=1).sum())
        assert max(cpu.values()) <= TOL_ORACLE, f"{name}: card vs CPU {cpu}"
        print(f"{label}: {name}: {report}; vs f64 oracle at B=2 N={n} "
              + ", ".join(f"|d{k}| {v:.2e}" for k, v in errs.items())
              + "; card vs CPU " + ", ".join(f"|d{k}| {v:.2e}"
                                            for k, v in cpu.items())
              + f", {same} of 2 paths equal")
    counts = launched({})
    print(f"{label}: kernel launches over these calls: {counts or 'none'}")

    fsm, spdf, P = big
    t0 = time.perf_counter()
    cf = mt.compile_fsm(fsm, spdf, P, strategy="block", ov_cap=64,
                        device=dev)
    t_c = time.perf_counter() - t0
    report = mt.fast_path_report(cf, 128)
    assert report.startswith("plain torch scan on the card"), report
    N = 700
    rng = np.random.default_rng(0)
    lhs = torch.from_numpy(make_inputs(rng, 128, N, P)).to(dev)
    reset_all_launches()

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, 1e3 * (time.perf_counter() - t0)

    (posts, z), t_den = timed(lambda: mt.pdfposteriors(cf, lhs))
    assert torch.isfinite(z).all() and torch.isfinite(posts).all()
    # the plain decode at N=70 first: past ~60 s at N=700 the batch halves
    _, t70 = timed(lambda: mt.viterbi(cf, lhs[:, :70]))
    B = 128 if 10 * t70 <= 60e3 else 64
    (states, score), t_dec = timed(lambda: mt.viterbi(cf, lhs[:B]))
    assert torch.isfinite(score).all()
    counts = launched({})
    halved = "" if B == 128 else (f" (B halved to {B}: the N=70 decode "
                                  f"took {t70:.0f} ms)")
    print(f"{label}: 2M-arc graph at ov_cap=64 (compiled in {t_c:.1f} s, "
          f"ov_layout {cf.ov_layout}): {report}; den-only pdfposteriors "
          f"B=128 N={N} {t_den:.1f} ms, viterbi B={B} N={N} {t_dec:.1f} ms"
          f"{halved}; kernel launches {counts or 'none'}; {card}")
    return {"den": t_den, "decode": t_dec, "B": B}


# ---- float64 'dense' scan and float64 decode (phases 42-46) ----------------

TOL_K6_F64 = 1e-12  # K6a/K6b<double> against their float64 twin
# float64 end to end: |dlogZ|, |dposts| and |dscore| against the f64 oracle
# and the f64 max-plus optimum, and a float64 path's weight against its
# score
TOL_F64_ORACLE = 1e-8


def launched(want):
    """The nonzero launch counts since the last reset, held to ``want``."""
    import torch

    torch.cuda.synchronize()
    counts = {k: v for k, v in all_launches().items() if v}
    assert counts == want, f"launches {counts}, want {want}"
    return counts


def phase_f64_dense(dcf64, dP, dev, label="phase 42"):
    """Phase 42: K6a and K6b in their float64 instantiation against their
    float64 twins on the V=32 graph at B=128, N=700 (phase 11's input in
    float64: lengths 1 and N mixed, ±30-nat cliffs), each run twice and
    bit-equal: logZ within 1e-12 relative, states and posteriors within
    1e-12; only float64 launches."""
    import torch

    from markovmodels_tpu_torch.ops import dense_scan as ds

    kop = ds.kernel_operator(dcf64)
    assert (kop.wf.dtype == kop.pf.tiles.dtype == kop.alpha0.dtype
            == torch.float64)
    reset_all_launches()
    errs = phase_dense_kernels(kop, dP, dev, label=label, tol=TOL_K6_F64)
    counts = launched({"dense_fwd_f64": 2, "dense_bwd_f64": 2})
    print(f"{label}: launches {json.dumps(counts)}; tile plans' shared "
          f"memory (resident, streaming) {ds.smem_bytes(kop.pf)} bytes")
    return errs


def ptxas_entries(log, rx):
    """{the groups of ``rx`` in the mangled name: {registers, stack,
    spill_stores, spill_loads, smem}} of the entries of a ``ptxas -v``
    report whose names match ``rx``."""
    out, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            k = re.search(rx, m.group(1))
            cur = None if k is None else k.groups()
            if cur is not None:
                out[cur] = {}
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            out[cur].update(stack=int(m.group(1)),
                            spill_stores=int(m.group(2)),
                            spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[cur]["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", line)
            out[cur]["smem"] = int(m.group(1)) if m else 0
            cur = None
    return out


def k6_f64_ptxas(log):
    """{(kernel, vec): ptxas entry} of the float64 ``sweep_kernel``
    (K6a, K6b) and ``trop_kernel`` (K6t) instantiations, each with and
    without 16-byte accesses, in the library's ``ptxas -v`` report."""
    out = {(("K6a", "K6b")[int(bwd)], int(vec)): v
           for (bwd, vec), v in ptxas_entries(
               log, r"sweep_kernelILb([01])ELb([01])ELb0EdE").items()}
    out.update({("K6t", int(vec[0])): v for vec, v in ptxas_entries(
        log, r"trop_kernelILb([01])EdE").items()})
    return out


def block_f64_ptxas(log):
    """{(kernel, vec, fam): ptxas entry} of the float64 K2/K3
    (``fwd_chunk_kernel``) and K4 (``bwd_chunk_kernel``) instantiations."""
    return {(k, int(vec), int(fam)): v for (k, vec, fam), v in ptxas_entries(
        log, r"(fwd|bwd)_chunk_kernelILb([01])ELb([01])ELb0EdE").items()}


def phase_dmma(dcf64, dev, v32_errs, times, card, P=96, N=128,
               label="phase 51"):
    """Phase 51: K6a and K6b in float64, their product on the FP64 tensor
    cores (``mma.sync`` m8n8k4) with the V=32 operator's tiles resident:
    the ``ptxas`` report of their instantiations (registers and spill
    bytes, printed beside K6t's), their float64
    twins on the V=32 operator (phase 42 of this run: B=128, N=700, lengths
    1 and N mixed, ±30-nat cliffs, each run twice bit-equal; here again at
    B=126, N=128: the scalar branch) and on a random fully dense
    Sp = 4,096 float64 operator (its tiles streamed: 128 MiB of them) at
    B=128, N=128, each run twice, bit-equal, then K6t<double> on it
    (``phase_trop_full``); and this run's times (phase 46: the kernels
    beside float64 ``torch.matmul`` and ``torch.sparse.mm`` x701, the
    float64 dense step and den-only call, medians of 5), with the frame
    without the product (an all-zero operator)."""
    import torch

    from markovmodels_tpu_torch.ops import _build
    from markovmodels_tpu_torch.ops import dense_scan as ds

    ents = k6_f64_ptxas(_build.PTXAS_LOG)
    assert {k[0] for k in ents} == {"K6a", "K6b", "K6t"}, ents
    spills = sum(v["spill_stores"] + v["spill_loads"]
                 for k, v in ents.items() if k[0] in ("K6a", "K6b"))
    print(f"{label}: ptxas of the float64 sweep_kernel and trop_kernel "
          "instantiations (kernel, 16-byte accesses): " + "; ".join(
              f"{k[0]} vec={k[1]}: {v}" for k, v in sorted(ents.items()))
          + f"; K6a/K6b spill bytes (stores + loads): {spills}")
    assert spills == 0, f"K6a/K6b<double> spill {spills} bytes"
    kop = ds.kernel_operator(dcf64)
    print(f"{label}: V=32 float64 plans: up to {kop.pf.max_tiles} / "
          f"{kop.pb.max_tiles} tiles per CTA, shared memory (resident, "
          f"streaming) {ds.smem_bytes(kop.pf)} / {ds.smem_bytes(kop.pb)} "
          f"bytes; K6a/K6b vs their float64 twins (phase 42) "
          + ", ".join(f"{k} {v:.3e}" for k, v in v32_errs.items()))
    reset_all_launches()
    errs = phase_dense_kernels(kop, P, dev, N=N, tol=TOL_K6_F64, B=126,
                               label=f"{label} (V=32, float64, B=126)")
    launched({"dense_fwd_f64": 2, "dense_bwd_f64": 2})
    full = full_dense_op(dev, P=P, dtype=torch.float64)
    print(f"{label}: fully dense Sp = {full.Sp} float64: "
          f"{full.pf.tile_k.numel()} tiles over {full.pf.lo.numel() - 1} "
          f"CTAs, up to {full.pf.max_tiles} per range, shared memory "
          f"(resident, streaming) {ds.smem_bytes(full.pf)} bytes: streamed")
    reset_all_launches()
    e_full = phase_dense_kernels(full, P, dev, N=N, tol=TOL_K6_F64,
                                 label=f"{label} (fully dense Sp = 4,096, "
                                       "float64)")
    launched({"dense_fwd_f64": 2, "dense_bwd_f64": 2})
    errs = {k: max(v, e_full[k]) for k, v in errs.items()}
    phase_trop_full(full, P, dev, label)
    del full
    torch.cuda.empty_cache()
    floor = frame_floor(dcf64, 96, dev)
    t = times
    print(f"{label}: K6a float64 {t['K6a']:.3f} ms, K6b float64 "
          f"{t['K6b']:.3f} ms over 701 frames (B=128, Sp=3,200); float64 "
          f"torch.matmul x701 {t['matmul']:.3f} ms, torch.sparse.mm x701 "
          f"{ms_or_not(t['sparse'])} ms; frame without the product "
          f"{floor[0]:.2f} / {floor[1]:.2f} us; float64 dense step "
          f"{t['step']:.2f} ms, den-only {t['den']:.2f} ms (medians of 5); "
          f"{card}")
    return errs


def phase_block_f64(graphs, dev, splits, steps, card, label="phase 52"):
    """Phase 52: K2-K4 in float64 on the FP64 tensor cores (the tier as
    ``mma.sync`` m16n8k4 f64, its stages through a ``cp.async`` ring,
    ``block_scan.cu`` ``tier_tile_dm``): the ``ptxas`` report of every
    ``fwd_chunk_kernel`` / ``bwd_chunk_kernel<..., double>`` instantiation
    (fails on any spill); their float64 twins again at B=126, N=128 (the
    scalar branch: B % 4 != 0) on both block graphs, each call twice
    bit-equal; and this run's readings side by side: K2's and K4's frame
    splits in float64 beside float32 on the 2M-arc graph (phases 9 and
    40), K2/K3/K4 in float64 beside float32 with their bounds on both
    block graphs, and phase 40's float64 steps.  ``graphs``: {name:
    (float64 graph, P, float64 times, float32 times, float64 bounds,
    float32 bounds)}; ``splits``: {name: frame_split}; ``steps``: phase
    40's medians."""
    from markovmodels_tpu_torch.ops import _build

    ents = block_f64_ptxas(_build.PTXAS_LOG)
    assert len(ents) == 8, ents  # {fwd, bwd} x vec x fam
    spills = sum(v["spill_stores"] + v["spill_loads"] for v in ents.values())
    print(f"{label}: ptxas of the float64 fwd_chunk_kernel / "
          "bwd_chunk_kernel instantiations (kernel, 16-byte accesses, "
          "capped layout): " + "; ".join(
              f"{k[0]} vec={k[1]} fam={k[2]}: {v}"
              for k, v in sorted(ents.items()))
          + f"; spill bytes (stores + loads): {spills}")
    assert spills == 0, f"K2-K4<double> spill {spills} bytes"
    errs = {}
    for name, (c64, P, *_) in graphs.items():
        errs[name] = phase_f64_kernels(c64, P, dev, f"{label} ({name}, B=126, "
                                       "N=128)", B=126, N=128)
    for k in ("K2", "K4"):
        s64, s32 = splits["2M-arc f64"][k], splits["2M-arc"][k]
        print(f"{label}: {k} frame split on the 2M-arc graph, us per frame "
              f"(float64; float32 in parentheses): " + ", ".join(
                  f"{part} {s64[part]:.2f} ({s32[part]:.2f})"
                  for part in s64))
    for name, (_, _, t64, t32, b64, b32) in graphs.items():
        print(f"{label}: {name} graph, ms (float32 in parentheses): "
              + ", ".join(f"{k} {t64[k][0]:.3f} ({t32[k][0]:.3f}), bound "
                          f"{b64[k][0]:.3f} ({b32[k][0]:.3f}, {b64[k][1]})"
                          for k in ("K2", "K3", "K4")))
    print(f"{label}: float64 steps (phase 40, medians of 5; float32 in "
          "parentheses): " + "; ".join(
              f"{k} step {v['f64 step']:.2f} ({v['f32 step']:.2f}) ms, "
              f"den-only {v['f64 den']:.2f} ({v['f32 den']:.2f}) ms"
              for k, v in steps.items()) + f"; {card}")
    return errs


def vit_f64_ptxas(log):
    """{(vec, ids, fam): ptxas entry} of the eight float64
    ``vit_sweep_kernel`` instantiations (K7 with ids, K7n without; the
    uniform and the family branch; 16-byte accesses or not)."""
    return {tuple(int(x) for x in k): v for k, v in ptxas_entries(
        log, r"vit_sweep_kernelILb([01])ELb([01])ELb([01])EdE").items()}


def phase_vit_f64(cf64, scf64, P, sP, dev, splits, times, bounds, t46,
                  card, label="phase 53"):
    """Phase 53: K7 and K7n in float64 with the tier's running (max,
    position) compared on the FP64 pipe (``vit_scan.cu`` ``tier_dbl``: a
    DSETP and selects per candidate, the stages through a ``cp.async``
    ring): the ``ptxas`` report of every ``vit_sweep_kernel<...,
    double>`` instantiation (fails on any spill or stack byte); the
    library's double layout (``vit_scan.layout``); K7 and K7n against
    their float64 twins again at B=126, N=128 (the scalar branch, B % 4 !=
    0; phase 44 ran B=128) on both block graphs, each call twice
    bit-equal, with K7n's checkpoints and restart; and this run's
    readings side by side: the float64 frame split (``vit_frame_split``
    on phase 17's input in float64) beside float32 (phases 17 and 36) on
    both graphs, K7, K7 fam. and K7n (checkpoint sweep and recompute) in
    float64 beside float32 with their bounds, and phase 46's float64
    decodes.  ``splits``: {graph: float32 split}; ``times`` / ``bounds``:
    {row: (float64, float32)}; ``t46``: phase 46's medians."""
    import torch

    from markovmodels_tpu_torch.ops import _build
    from markovmodels_tpu_torch.ops import vit_scan as vs
    from markovmodels_tpu_torch.ops.emissions import prepare_emissions

    ents = vit_f64_ptxas(_build.PTXAS_LOG)
    assert len(ents) == 8, ents  # vec x ids x fam
    waste = sum(v["spill_stores"] + v["spill_loads"] + v["stack"]
                for v in ents.values())
    print(f"{label}: ptxas of the float64 vit_sweep_kernel instantiations "
          "(16-byte accesses, ids, family branch): " + "; ".join(
              f"vec={k[0]} ids={k[1]} fam={k[2]}: {v}"
              for k, v in sorted(ents.items()))
          + f"; spill and stack bytes: {waste}")
    assert waste == 0, f"K7/K7n<double> spill or stack {waste} bytes"
    lay32, lay64 = vs.layout(128, 700, False), vs.layout(128, 700, True)
    print(f"{label}: layout (scratch bytes, tier candidates per id compare) "
          f"at B=128 N=700: float32 {lay32}, float64 {lay64}")
    assert lay64[1] == 1 and lay32[1] == 8, (lay32, lay64)
    errs = phase_f64_vit(cf64, scf64, P, sP, dev, B=126, N=128,
                         label=f"{label} (B=126)")
    for name, cf, P_ in (("2M-arc", cf64, P), ("separate-state", scf64, sP)):
        rng = np.random.default_rng(0)
        lhs = torch.from_numpy(make_inputs(rng, 128, 700, P_)).to(
            dev, torch.float64)
        lengths = torch.full((128,), 700, dtype=torch.int32, device=dev)
        ext, msh = prepare_emissions(lhs, lengths, P_, torch.float64)
        s64, s32 = vit_frame_split(cf, ext, msh), splits[name]
        print(f"{label}: K7 frame split on the {name} graph, us per frame "
              "(float64; float32 in parentheses): " + ", ".join(
                  f"{part} {s64[part]:.2f} ({s32[part]:.2f})"
                  for part in s64))
        del ext, msh
    print(f"{label}: ms (float32 in parentheses): " + ", ".join(
        f"{k} {t[0]:.3f} ({t[1]:.3f}), bound {bounds[k][0][0]:.3f} "
        f"({bounds[k][1][0]:.3f}, {bounds[k][0][1]})"
        for k, t in times.items()))
    print(f"{label}: float64 decodes (phase 46, medians of 5; float32 in "
          "parentheses): " + "; ".join(
              f"{k} {t46[k + ' f64']:.2f} ({t46[k + ' f32']:.2f}) ms"
              for k in ("2M-arc decode", "separate-state decode",
                        "2M-arc decode N=1,024")) + f"; {card}")
    return errs


def noid_f32_ptxas(log):
    """{(vec, fam): ptxas entry} of the four float32 K7n
    ``vit_sweep_kernel<VEC, false, FAM, float>`` instantiations."""
    return {(int(vec), int(fam)): v for (vec, fam), v in ptxas_entries(
        log, r"vit_sweep_kernelILb([01])ELb0ELb([01])EfE").items()}


def phase_noid_f32(cf, scf, P, sP, dev, card, N=128, h=64,
                   label="phase 54"):
    """Phase 54: the float32 K7n redesigned for Hopper (its tier streamed
    through a ``cp.async`` ring beside the epilogue's tables, the next
    item's first stages issued before an item's epilogue, the separate-
    state graph's heavy rows four to an item): the ``ptxas`` report of its
    four ``vit_sweep_kernel<VEC, false, FAM, float>`` instantiations; the
    library's shared memory of every instantiation (``mm_vit_smem``)
    against the admission's reckoning (``vit_scan.smem_bytes``); both
    branches of K7n against their twins at B = 128, 126 and 124 (the
    2M-arc graph: uniform; the separate-state graph: the family branch)
    at N=128 on phase 34's input (lengths 1, 2 and N mixed, ±30-nat
    cliffs): twice, bit-equal, ending as K7, its stride-64 checkpoints the
    saved frames, restarted mid-sweep, and at B=124 the chunk-recompute
    decode with chunk_size 7 and 64 equal to one chunk; only float32 K7n
    launches, the family ones in the family branch; then K7n's frame split
    on both graphs (phase 17's input, the checkpoint sweep's form).
    Returns {"K7n": max |K7n - twin|}."""
    import importlib

    import torch

    from markovmodels_tpu_torch.ops import _build
    from markovmodels_tpu_torch.ops import vit_scan as vs
    from markovmodels_tpu_torch.ops.emissions import prepare_emissions

    tvit = importlib.import_module("markovmodels_tpu_torch.viterbi")
    ents = noid_f32_ptxas(_build.PTXAS_LOG)
    assert len(ents) == 4, ents  # vec x fam
    print(f"{label}: ptxas of the float32 K7n vit_sweep_kernel<VEC, false, "
          "FAM, float> instantiations: " + "; ".join(
              f"vec={k[0]} fam={k[1]}: {v}" for k, v in sorted(ents.items())))
    lib = _build.library()
    smem = {}
    for ids in (1, 0):
        for fam in (0, 1):
            for f64 in (0, 1):
                for B in (128, 124):
                    got = lib.mm_vit_smem(ids, fam, f64, B)
                    want = vs.smem_bytes(B, bool(ids), bool(fam), bool(f64))
                    assert got == want, (ids, fam, f64, B, got, want)
                    smem[(ids, fam, f64)] = got
    print(f"{label}: shared memory of a CTA at B=124 (ids, fam, f64): "
          + ", ".join(f"{k} {v}" for k, v in smem.items())
          + " bytes, the library's equal to vit_scan.smem_bytes")

    def same(xs, ys):
        return all(torch.equal(x, y) for x, y in zip(xs, ys))

    err = 0.0
    for name, g, P_ in (("2M-arc", cf, P), ("separate-state", scf, sP)):
        reset_all_launches()
        fam = name == "separate-state"
        for B in (128, 126, 124):
            lhs, lens = vit_inputs(P_, dev, B, N)
            lens[4] = 2
            ext, msh = prepare_emissions(lhs, lens, P_)
            n1 = vs.viterbi_fwd(g, ext, msh, ids=False)
            n2 = vs.viterbi_fwd(g, ext, msh, ids=False)
            torch.cuda.synchronize()
            npl = vs.viterbi_fwd_plain(g, ext, msh, ids=False)
            k7 = vs.viterbi_fwd(g, ext, msh)
            ck = vs.viterbi_fwd(g, ext, msh, ids=False, stride=h)
            mid = dict(a0=n1[0][h - 1], s0=n1[1][h - 1], t0=h)
            r_k = vs.viterbi_fwd(g, ext[h:], msh[h:], ids=False, **mid)
            r_p = vs.viterbi_fwd_plain(g, ext[h:], msh[h:], ids=False,
                                       **mid)
            fn = g.final_state
            ok = {"twice": same(n1, n2), "twin": same(n1, npl),
                  "as K7": (torch.equal(n1[2][fn] * n1[3], k7[2])
                            and torch.equal(n1[4][0], k7[4])
                            and torch.equal(n1[4][1], k7[3])),
                  "checkpoints": (torch.equal(ck[0], n1[0][h - 1::h])
                                  and torch.equal(ck[1], n1[1][h - 1::h])
                                  and same(ck[2:], n1[2:])),
                  "restart": (same(r_k, r_p)
                              and torch.equal(r_k[0], n1[0][h:]))}
            err = max(err, max(float((x.double() - y.double()).abs().max())
                               for x, y in zip(n1, npl)))
            if B == 124:
                one = tvit._viterbi_recompute(g, lhs, lens)
                for k in (7, 64):
                    ok[f"chunk_size {k}"] = same(
                        tvit._viterbi_recompute(g, lhs, lens, k), one)
            print(f"{label}: K7n on the {name} graph B={B} N={N}: "
                  f"bit-equal {ok}")
            assert all(ok.values()), f"K7n on the {name} graph: {ok}"
            del n1, n2, npl, k7, ck, r_k, r_p
        counts = {k: v for k, v in all_launches().items() if v}
        famc = dict(vs.LAUNCHES_FAM)
        print(f"{label}: {name} launches {json.dumps(counts)}, of them in "
              f"the family branch {json.dumps(famc)}")
        assert set(counts) <= {"vit_fwd", "vit_fwd_noid", "rec_walk"}, counts
        assert famc["vit_fwd_noid"] == (counts["vit_fwd_noid"] if fam
                                        else 0), famc
    for name, g, P_ in (("2M-arc", cf, P), ("separate-state", scf, sP)):
        rng = np.random.default_rng(0)
        lhs = torch.from_numpy(make_inputs(rng, 128, 700, P_)).to(dev)
        lengths = torch.full((128,), 700, dtype=torch.int32, device=dev)
        ext, msh = prepare_emissions(lhs, lengths, P_)
        sp = vit_frame_split(g, ext, msh, ids=False)
        print(f"{label}: K7n frame split on the {name} graph, us per frame "
              "(B=128, N=700, stride 64): " + ", ".join(
                  f"{k} {v:.2f}" for k, v in sp.items()) + f"; {card}")
        del ext, msh
    return {"K7n": err}


PTXAS_REF = Path(__file__).resolve().parent / "tools" / "ptxas_ref.json"


def ptxas_key(mangled):
    """An instantiation's name and template arguments from its mangled
    name, without the anonymous namespace (whose name hashes the file):
    e.g. ``trop_kernel<Lb1E,f>`` for ``trop_kernel<true, float>``."""
    m = re.search(r"(\d+)_GLOBAL__N__", mangled)  # <length><namespace>
    if m is None:
        return mangled
    i = m.start(1) + len(m.group(1)) + int(m.group(1))
    n = re.match(r"\d+", mangled[i:])  # <length><name>
    if n is None:
        return mangled
    n = n.group(0)
    i += len(n)
    name = mangled[i:i + int(n)]
    i += len(name)
    args = []
    if mangled[i:i + 1] == "I":
        i += 1
        while mangled[i] != "E":
            j = mangled.index("E", i) + 1 if mangled[i] == "L" else i + 1
            args.append(mangled[i:j])
            i = j
    return f"{name}<{','.join(args)}>" if args else name


def ptxas_table(log):
    """{ptxas_key: {registers, stack, spill_stores, spill_loads, smem}} of
    every entry of a ``ptxas -v`` report."""
    return {ptxas_key(k[0]): v
            for k, v in ptxas_entries(log, r"^(.*)$").items()}


def nvcc_version():
    """The last line of ``nvcc --version`` (its release and build)."""
    from markovmodels_tpu_torch.ops import _build

    out = subprocess.run([_build._nvcc(), "--version"], capture_output=True,
                         text=True, check=True)
    return out.stdout.strip().splitlines()[-1]


# K5a/K5b's cluster instantiations (banded_scan.cu), new in this tree, and
# the narrow K5b, whose pdf sums divide where a frame's gamma sum is
# subnormal: the entries phase 55 does not hold to the parent's table
K5_CLUSTER_ENTRIES = ("banded_fwd_cluster_kernel<",
                      "banded_bwd_cluster_kernel<")
K5B_NARROW_ENTRIES = ("banded_bwd_kernel<",)
# W2's and the walk's instantiations (rec_walk.cu, vit_scan.cu), redesigned
# in this tree: phase 55 leaves them out, phase 56 requires them spill-free
WALK_ENTRIES = ("rec_walk_kernel<", "vit_walk_kernel")


def phase_ptxas(log, label="phase 55"):
    """Phase 55: the library's ``ptxas`` report.  K5a's and K5b's cluster
    instantiations (``K5_CLUSTER_ENTRIES``, float and double) spill 0
    bytes and keep no stack; the narrow K5b's entries are listed beside
    the table's; W2's and the walk's (``WALK_ENTRIES``) are phase 56's;
    every other entry equals the table ``tools/ptxas_ref.py``
    made of the parent commit (``tools/ptxas_ref.json``), compared where
    the nvcc that built the table built this library too."""
    tab = ptxas_table(log)
    assert tab, "no ptxas report (the library was not built by this run)"
    k5 = {k: v for k, v in tab.items() if k.startswith(K5_CLUSTER_ENTRIES)}
    print(f"{label}: ptxas of K5a/K5b's cluster instantiations: "
          + "; ".join(f"{k}: {v}" for k, v in sorted(k5.items())))
    assert len(k5) == 4 and all(
        v["spill_stores"] + v["spill_loads"] + v["stack"] == 0
        for v in k5.values()), f"K5 cluster spill: {k5}"
    ref = json.loads(PTXAS_REF.read_text())
    skip = K5_CLUSTER_ENTRIES + K5B_NARROW_ENTRIES + WALK_ENTRIES
    narrow = {k: v for k, v in tab.items() if k.startswith(
        K5B_NARROW_ENTRIES)}
    print(f"{label}: the narrow K5b's entries (the subnormal rule), this "
          "build / the table: " + "; ".join(
              f"{k}: {v['registers']} / "
              f"{ref['entries'].get(k, {}).get('registers')} registers, "
              f"{v['spill_stores']} / "
              f"{ref['entries'].get(k, {}).get('spill_stores')} spill bytes"
              for k, v in sorted(narrow.items())))
    want = {k: v for k, v in ref["entries"].items()
            if not k.startswith(skip)}
    others = {k: v for k, v in tab.items() if not k.startswith(skip)}
    nvcc = nvcc_version()
    if ref["nvcc"] != nvcc:
        print(f"{label}: the other {len(others)} entries not compared: "
              f"this nvcc ({nvcc}) is not the table's ({ref['nvcc']})")
        return
    diff = sorted(k for k in set(others) | set(want)
                  if others.get(k) != want.get(k))
    print(f"{label}: the other {len(others)} entries against "
          f"{PTXAS_REF.name} ({len(want)} of its {len(ref['entries'])} "
          f"entries, {ref['nvcc']}): {len(diff)} differ" + "".join(
              f"\n  {k}: {others.get(k)} (table {want.get(k)})"
              for k in diff))
    assert not diff, f"{len(diff)} ptxas entries differ from the table"


def walk_ptxas(log):
    """{entry: ptxas figures} of W2's and the walk's instantiations."""
    return {k: v for k, v in ptxas_table(log).items()
            if k.startswith(WALK_ENTRIES)}


def w2_branch_inputs(wt, Sp, B, nK, dt, dev, seed):
    """(states, scales, lengths, s_next) of a W2 chunk of nK frames from
    frame 0 that take each of W2's branches: alphas of {0, 1/4, 1/2, 1}
    (ties wherever two in-arcs' weights agree too; zeros give -inf
    candidates), column 1 zero throughout (every candidate -inf: the walk
    parks on fin), column 2's ω support zero at its last frame (the full
    scan over Sp states), powers of two as scales, lengths 1, nK (the ω
    step in the chunk's first walked frame), 2 nK (the walk enters from
    s_next) and others, s_next random states with fin among them."""
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    lev = torch.tensor([0.0, 0.25, 0.5, 1.0], dtype=dt, device=dev)
    a = lev[torch.randint(0, 4, (nK, Sp, B), generator=g, device=dev)]
    a[:, :, 1] = 0
    L = torch.randint(1, 2 * nK + 1, (B,), generator=g, device=dev)
    L[:6] = torch.tensor([nK, 2 * nK, nK // 2, 1, nK, 2 * nK], device=dev)
    sup = torch.nonzero(wt.omega != 0)[:, 0]
    a[nK // 2 - 1, sup, 2] = 0
    sc = (2.0 ** torch.randint(-3, 4, (nK, B), generator=g, device=dev)).to(dt)
    s_next = torch.randint(0, Sp, (B,), generator=g, device=dev)
    s_next[5::7] = wt.fin
    return (a, sc, L.to(torch.int32),
            s_next.to(torch.int32))


def walk_branch_inputs(cf, wt, Nf, B, dev, seed, fam_share=0.0):
    """(ids, fins, lengths) for the walk over the ids that take each of
    its branches: tier positions, each band id where its source is a state
    (the row at least its offset), the out-family id Sm + nO on a
    ``fam_share`` of the rows (elsewhere 0.5 %: on a uniform graph it
    decodes to fin), 255 on 1 %, the overflow rows' ids through ov_dec;
    fins any state; lengths 0, 1, Nf - 1 and others."""
    import torch

    from markovmodels_tpu_torch.ops import vit_scan as vs

    RW = vs._main_region(cf)
    g = torch.Generator(device=dev).manual_seed(seed)
    Sm, nO = wt.Sm, wt.nO
    ids = torch.randint(0, Sm, (Nf, RW, B), generator=g, device=dev)
    r = torch.rand((Nf, RW, B), generator=g, device=dev)
    rows = torch.arange(RW, device=dev)[None, :, None]
    for oi in range(nO):
        off = int(wt.offs[oi])
        band = (r >= 0.1 * oi) & (r < 0.1 * (oi + 1)) & (rows - off >= 0)
        ids = torch.where(band, Sm + oi, ids)
    fam = (r >= 0.5) & (r < 0.5 + max(fam_share, 0.005))
    ids = torch.where(fam, Sm + nO, ids)
    ids = torch.where(r >= 0.99, 255, ids).to(torch.uint8)
    fins = torch.randint(0, cf.padded_states, (Nf, B), generator=g,
                         device=dev).to(torch.int32)
    L = torch.randint(0, Nf, (B,), generator=g, device=dev)
    L[:4] = torch.tensor([0, 1, Nf - 1, Nf - 1], device=dev)
    return ids, fins, L.to(torch.int32)


def sliced_decodes(dev, dtypes, B=24_576, label="phase 56"):
    """``viterbi`` of a small 'block' graph (V=128, one HMM state, 5 % of
    the trigram arcs: Sp = 16,512) at a batch past K7's and K7n's shared
    memory, decoded in slices on the card: N=8 through the
    compressed-backpointer route (K7 and its walk) in each of ``dtypes``,
    N=16 past the id budget through the chunk-recompute route (K7n and
    W2) in float32; against the same routes' plain twins on the card (in
    slices of 2,048): states equal, scores within TOL_VIT (the twins' K7
    scores differ from K7's in the last bits, phase 17).  Returns the slice
    counts."""
    import importlib

    import torch

    import markovmodels_tpu_torch as mt
    from markovmodels_tpu_torch.ops import vit_scan as vs

    tvit = importlib.import_module("markovmodels_tpu_torch.viterbi")
    fsm, spdf, P, _ = mt.workloads.make_lm_hmm_graph(V=128, hmm_states=1,
                                                     keep=0.05)
    torch.cuda.empty_cache()  # ~20 GB at a time for the recompute slices
    out = {}
    for dt in dtypes:
        cf = mt.compile_fsm(fsm, spdf, P, strategy="block", dtype=dt,
                            device=dev)
        for N, route in ((8, "bp"), (16, "recompute")):
            if route == "recompute" and dt == torch.float64:
                continue
            rng = np.random.default_rng(N)
            lhs = torch.from_numpy(make_inputs(rng, B, N, P)).to(dev, dt)
            lens = torch.from_numpy(rng.integers(1, N + 1, size=B).astype(
                np.int32)).to(dev)
            lens[:2] = N
            bp = tvit._bp_vit_reject_reason(cf, lhs) is None
            assert bp == (route == "bp"), route
            width = tvit._slice_width(cf, lhs, bp)
            n_slices = -(-B // width)
            assert width == vs.max_batch(bp, False, dt == torch.float64)
            reset_all_launches()
            t0 = time.perf_counter()
            st, sc = mt.viterbi(cf, lhs, lens)
            torch.cuda.synchronize()
            t_k = time.perf_counter() - t0
            counts = {k: v for k, v in all_launches().items() if v}
            key = "" if dt == torch.float32 else "_f64"
            if route == "bp":
                assert counts == {f"vit_fwd{key}": n_slices,
                                  "vit_walk": n_slices}, counts
            else:
                assert counts["vit_fwd_noid"] == n_slices, counts
                assert counts["rec_walk"] == n_slices, counts
            real = tvit._plain_decode
            tvit._plain_decode = lambda *a, **k: "the plain twins, by hand"
            try:
                t0 = time.perf_counter()
                ps, pz = tvit._viterbi_scale(cf, lhs, lens, width=2048)
                torch.cuda.synchronize()
                t_p = time.perf_counter() - t0
            finally:
                tvit._plain_decode = real
            same = torch.equal(st, ps)
            fin = torch.isfinite(sc)
            assert torch.equal(fin, torch.isfinite(pz)), "-inf pattern"
            dz = float((sc[fin].double() - pz[fin].double()).abs().max())
            print(f"{label}: viterbi at B={B} N={N} ({route} route, {dt}) "
                  f"in {n_slices} slices of at most {width}: launches "
                  f"{json.dumps(counts)}, {t_k:.2f} s; the plain twins "
                  f"(slices of 2,048) {t_p:.2f} s: states equal {same}, "
                  f"max |dscore| {dz:.3e} (tol {TOL_VIT:g}), "
                  f"{int(fin.sum())} of {B} feasible")
            assert same and dz <= TOL_VIT, "the sliced decode disagrees"
            out[f"{route} {dt}"] = n_slices
            del lhs, st, sc, ps, pz
        del cf
        torch.cuda.empty_cache()
    return out


def phase_walks(graphs, dev, times, decodes, card, label="phase 56"):
    """Phase 56: W2 and the walk over the ids redesigned.  Their
    ``ptxas`` entries spill nothing; both are bit-equal to their plain
    twins on inputs built to take each branch
    (:func:`w2_branch_inputs`, :func:`walk_branch_inputs`: ties, the park
    on fin, in-degrees past 32, the Dmax cap (tables with a smaller
    Dmax), the ω step's full scan, lengths 0, 1 and N; the family branch's
    tables and the id 255) at B = 128, 126 and 124, in float32 and
    float64 (W2; the walk has one instantiation per table width); a batch
    past K7's shared memory decoded in slices (:func:`sliced_decodes`);
    then the walks' times from the phases before (``times``: name ->
    (ms, frames, {latency: round trips a frame})) beside their chain
    floors (frames × round trips × the latency ``tools/latency_probe.py``
    measures) and
    the decodes' (``decodes``), and one profile of the dense decode with
    its idle share.  ``graphs``: name -> (compiled graph, P)."""
    import importlib.util

    import torch

    import markovmodels_tpu_torch as mt
    from markovmodels_tpu_torch.ops import _build
    from markovmodels_tpu_torch.ops import vit_scan as vs

    tab = walk_ptxas(_build.PTXAS_LOG)
    print(f"{label}: ptxas of W2 and the walk: " + "; ".join(
        f"{k}: {v}" for k, v in sorted(tab.items())))
    assert len(tab) == 11 and all(
        v["spill_stores"] + v["spill_loads"] + v["stack"] == 0
        for v in tab.values()), f"walk spill: {tab}"

    ok = {}
    for name in ("V=32 dense", "2M-arc", "V=32 dense f64", "2M-arc f64"):
        cf, _ = graphs[name]
        wt = vs.rec_walk_tables(cf)
        cap = wt._replace(dmax=max(wt.dmax * 2 // 3, 1), rec=None, rows=None,
                          sup=None)
        a, sc, L, nxt = w2_branch_inputs(wt, cf.padded_states, 128, 64,
                                         wt.w.dtype, dev, seed=56)
        for B in (128, 126, 124):
            args = (a[..., :B].contiguous(), sc[:, :B].contiguous(),
                    L[:B].contiguous(), 0, nxt[:B].contiguous())
            for tag, t in (("", wt), (" Dmax cap", cap)):
                k1, k2 = vs.rec_walk(t, *args), vs.rec_walk(t, *args)
                ok[f"W2 {name}{tag} B={B}"] = (
                    torch.equal(k1, k2)
                    and torch.equal(k1, vs.rec_walk_plain(t, *args)))
        del a
    for name, share in (("2M-arc", 0.0), ("separate-state", 0.1)):
        cf, _ = graphs[name]
        wt = vs.walk_tables(cf)
        ids, fins, L = walk_branch_inputs(cf, wt, 40, 128, dev, seed=57,
                                          fam_share=share)
        for B in (128, 126, 124):
            args = (ids[..., :B].contiguous(), fins[:, :B].contiguous(),
                    L[:B].contiguous())
            k1 = vs.walk(wt, *args)
            ok[f"walk {name} B={B}"] = (
                torch.equal(k1, vs.walk(wt, *args))
                and torch.equal(k1, vs.walk_plain(wt, *args)))
        del ids
    bad = [k for k, v in ok.items() if not v]
    print(f"{label}: W2 and the walk bit-equal to their twins (and to "
          f"themselves) on the branch inputs: {len(ok) - len(bad)} of "
          f"{len(ok)} cases" + (f"; differ: {bad}" if bad else ""))
    assert not bad, f"the walks differ from their twins: {bad}"

    slices = sliced_decodes(dev, (torch.float32, torch.float64))

    spec = importlib.util.spec_from_file_location(
        "latency_probe", Path(__file__).resolve().parent / "tools"
        / "latency_probe.py")
    probe = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(probe)
    lat = probe.measure()
    print(f"{label}: dependent-load latency (tools/latency_probe.py): "
          + "; ".join(f"{k} {v['ns']:.1f} ns ({v['cycles']:.0f} cycles)"
                      for k, v in lat.items()) + f"; {card}")
    floors = {}
    for name, (ms, frames, trips) in times.items():
        ns = sum(lat[k]["ns"] * n for k, n in trips.items())
        floors[name] = frames * ns / 1e6
        print(f"timing: {name} {ms:.3f} ms over {frames} frames "
              f"({1e3 * ms / frames:.3f} us a frame); chain floor "
              f"{floors[name]:.4f} ms (" + " + ".join(
                  f"{n:g} x {k}" for k, n in trips.items())
              + f" a frame: {ns:.1f} ns); {card}")
    print(f"timing: decodes " + "; ".join(f"{k} {v:.2f} ms"
                                          for k, v in decodes.items()))

    dcf, dP = graphs["V=32 dense"]
    rng = np.random.default_rng(0)
    lhs = torch.from_numpy(make_inputs(rng, 128, 700, dP)).to(dev)
    lens = torch.full((128,), 700, dtype=torch.int32, device=dev)
    prof = profile_device(lambda: mt.viterbi(dcf, lhs, lens))
    if prof is None:
        print(f"{label}: profile of the dense decode: not measured (no "
              "device events recorded)")
    else:
        by_name, busy, span, counts = prof
        print(f"{label}: profile of one dense decode B=128 N=700: device "
              f"busy {busy:.3f} ms of a {span:.3f} ms span (idle "
              f"{1 - busy / span:.1%}); " + "; ".join(
                  f"{k} {v:.3f} ms ({counts[k]} launches)" for k, v in
                  sorted(by_name.items(), key=lambda kv: -kv[1])[:6]))
    return floors, slices


def phase_f64_trop(dcf64, dP, dev, B=128, N=700, label="phase 43"):
    """Phase 43: K6t and W2 in float64 on the V=32 dense decode at B=128,
    N=700 (phase 15's input form in float64: lengths 1, 2N/3 and N mixed,
    ±30-nat cliffs): K6t run twice, bit-equal to each other and to its
    twin, restarted mid-sweep from a saved frame; W2 bit-equal to its twin
    over the whole sweep and in two chunks; then K6t at B=126 (the scalar
    branch) and 124, N=64, twice, against its twin and restarted.  Only
    float64 launches.  K6t's frame split (``trop_frame_split``).  Returns
    (errs, times, bounds) with the sweep's and the walk's ms beside their
    twins'."""
    import torch

    from markovmodels_tpu_torch.ops import dense_scan as ds
    from markovmodels_tpu_torch.ops import vit_scan as vs
    from markovmodels_tpu_torch.ops.emissions import prepare_emissions

    f64 = torch.float64

    def same(xs, ys):
        return all(torch.equal(x, y) for x, y in zip(xs, ys))

    kop = ds.trop_operator(dcf64)
    assert kop.wf.dtype == f64
    lhs, lens = vit_inputs(dP, dev, B, N)
    ext, msh = prepare_emissions(lhs.double(), lens, dP, f64)
    a0 = kop.alpha0[:, None].expand(kop.Sp, B).contiguous()
    s0 = torch.ones(B, device=dev, dtype=f64)
    reset_all_launches()
    k1 = ds.trop_sweep(kop, a0, s0, ext, msh, first=True)
    k2 = ds.trop_sweep(kop, a0, s0, ext, msh, first=True)
    torch.cuda.synchronize()
    plain = []
    t_plain = cuda_ms(lambda: plain.append(ds.trop_sweep_plain(
        kop, a0, s0, ext, msh, first=True)), warm=False)
    h = N // 2
    mid = (k1[0][h - 1], k1[1][h - 1], ext[h:], msh[h:])
    m_k = ds.trop_sweep(kop, *mid, first=False)
    m_p = ds.trop_sweep_plain(kop, *mid, first=False)
    ok = {"twice": same(k1, k2), "twin": same(k1, plain[0]),
          "restart": same(m_k, m_p) and torch.equal(m_k[0], k1[0][h:])}
    del k2, plain, m_k, m_p
    wt = vs.rec_walk_tables(dcf64)
    assert wt.w.dtype == wt.omega.dtype == f64
    s_end = torch.full((B,), wt.fin, dtype=torch.int32, device=dev)
    wk = vs.rec_walk(wt, k1[0], k1[1], lens, 0, s_end)
    torch.cuda.synchronize()
    walked = []
    t_wplain = cuda_ms(lambda: walked.append(vs.rec_walk_plain(
        wt, k1[0], k1[1], lens, 0, s_end)), warm=False)
    w_hi = vs.rec_walk(wt, k1[0][h:], k1[1][h:], lens, h, s_end)
    w_lo = vs.rec_walk(wt, k1[0][:h], k1[1][:h], lens, 0, w_hi[0])
    ok["W2 twin"] = torch.equal(wk, walked[0])
    ok["W2 chunks"] = torch.equal(torch.cat([w_lo, w_hi]), wk)
    assert all(ok.values()), f"K6t or W2 (float64) disagrees: {ok}"

    def inputs64(B_, N_):
        lhs_, lens_ = vit_inputs(dP, dev, B_, N_, seed=9)
        return prepare_emissions(lhs_.double(), lens_, dP, f64)

    trop_checks(kop, inputs64, f"{label} (float64)", Bs=(126, 124), N=64)
    counts = launched({"dense_trop_f64": 9, "rec_walk_f64": 3})
    t_sweep = cuda_ms(lambda: ds.trop_sweep(kop, a0, s0, ext, msh,
                                            first=True), reps=3)
    split = trop_frame_split(kop, ext, msh)
    t_walk = cuda_ms(lambda: vs.rec_walk(wt, k1[0], k1[1], lens, 0, s_end),
                     reps=5)
    bd = trop_bounds(dcf64, B, N + 1)
    bw = walk_bounds(wt, wk, s_end, lens, 0, kop.Sp)
    print(f"{label}: K6t and W2 (float64) on the V=32 dense graph B={B} "
          f"N={N}: bit-equal {ok}; launches {json.dumps(counts)}; K6t "
          f"{t_sweep:.3f} ms ({1e3 * t_sweep / (N + 1):.2f} us/frame; bound "
          f"{bd[0]:.4f} ms, {bd[1]}; twin {t_plain:.1f} ms), W2 "
          f"{t_walk:.3f} ms (bound {bw[0]:.4f} ms, {bw[1]}; twin "
          f"{t_wplain:.1f} ms); K6t's frame (us): " + ", ".join(
              f"{k} {v:.2f}" for k, v in split.items()))
    return ({"K6t": 0.0, "W2": 0.0},
            {"K6t": (t_sweep, t_plain), "W2": (t_walk, t_wplain)},
            {"K6t": bd, "W2": bw})


def phase_f64_vit(cf64, scf64, P, sP, dev, B=128, N=128, label="phase 44"):
    """Phase 44: K7, K7n and W2 in float64 against their float64 twins at
    N=128 (phase 34's input in float64: lengths 1, 2 and N mixed, ±30-nat
    cliffs) on the 2M-arc graph (uniform K7, also at B=126: the scalar
    branch) and the separate-state graph (K7's and K7n's family branch):
    K7 twice, bit-equal, its ids, omega argmaxes, final value, ksum and
    shift bit-equal to the twin, the walk over its ids equal to its twin;
    K7n twice, bit-equal to its twin and ending as K7, its stride-64
    checkpoints the saved frames, restarted mid-sweep; W2 on K7n's frames
    bit-equal to its twin, whole and in two chunks.  Only float64 launches
    (and the walk over the ids, which has no value type)."""
    import torch

    from markovmodels_tpu_torch.ops import vit_scan as vs
    from markovmodels_tpu_torch.ops.emissions import prepare_emissions

    f64 = torch.float64

    def same(xs, ys):
        return all(torch.equal(x, y) for x, y in zip(xs, ys))

    h = min(64, N // 2)
    for name, cf, P_, batches in (("2M-arc", cf64, P, (B, B - 2)),
                                  ("separate-state", scf64, sP, (B,))):
        fam = name == "separate-state"
        reset_all_launches()
        for Bx in batches:
            lhs, lens = vit_inputs(P_, dev, Bx, N)
            lens[4] = 2
            ext, msh = prepare_emissions(lhs.double(), lens, P_, f64)
            k1 = vs.viterbi_fwd(cf, ext, msh)
            k2 = vs.viterbi_fwd(cf, ext, msh)
            torch.cuda.synchronize()
            kp = vs.viterbi_fwd_plain(cf, ext, msh)
            wt = vs.walk_tables(cf)
            sk = vs.walk(wt, k1[0], k1[1], lens)
            zk = vit_score(k1)
            fin = np.isfinite(zk)
            ok = {"K7 twice": same(k1, k2), "K7 twin": same(k1, kp),
                  "walk": torch.equal(sk, vs.walk_plain(wt, k1[0], k1[1],
                                                        lens)),
                  "-inf": not fin[1] and fin[0]}
            del k2, kp
            if Bx == B:
                n1 = vs.viterbi_fwd(cf, ext, msh, ids=False)
                n2 = vs.viterbi_fwd(cf, ext, msh, ids=False)
                torch.cuda.synchronize()
                npl = vs.viterbi_fwd_plain(cf, ext, msh, ids=False)
                ck = vs.viterbi_fwd(cf, ext, msh, ids=False, stride=h)
                midk = dict(a0=n1[0][h - 1], s0=n1[1][h - 1], t0=h)
                r_k = vs.viterbi_fwd(cf, ext[h:], msh[h:], ids=False, **midk)
                r_p = vs.viterbi_fwd_plain(cf, ext[h:], msh[h:], ids=False,
                                           **midk)
                fn = cf.final_state
                ok.update({
                    "K7n twice": same(n1, n2), "K7n twin": same(n1, npl),
                    "K7n as K7": (torch.equal(n1[2][fn] * n1[3], k1[2])
                                  and torch.equal(n1[4][0], k1[4])
                                  and torch.equal(n1[4][1], k1[3])),
                    "checkpoints": (torch.equal(ck[0], n1[0][h - 1::h])
                                    and torch.equal(ck[1], n1[1][h - 1::h])
                                    and same(ck[2:], n1[2:])),
                    "restart": (same(r_k, r_p)
                                and torch.equal(r_k[0], n1[0][h:]))})
                del n2, npl, ck, r_k, r_p
                rt = vs.rec_walk_tables(cf)
                s_end = torch.full((Bx,), rt.fin, dtype=torch.int32,
                                   device=dev)
                wk = vs.rec_walk(rt, n1[0], n1[1], lens, 0, s_end)
                w_hi = vs.rec_walk(rt, n1[0][h:], n1[1][h:], lens, h, s_end)
                w_lo = vs.rec_walk(rt, n1[0][:h], n1[1][:h], lens, 0,
                                   w_hi[0])
                ok["W2 twin"] = torch.equal(wk, vs.rec_walk_plain(
                    rt, n1[0], n1[1], lens, 0, s_end))
                ok["W2 chunks"] = torch.equal(torch.cat([w_lo, w_hi]), wk)
                del n1
            print(f"{label}: {name} B={Bx} N={N} (float64): bit-equal {ok}")
            assert all(ok.values()), f"{name} float64 decode kernels: {ok}"
        nb = len(batches)
        counts = launched({"vit_fwd_f64": 2 * nb, "vit_walk": nb,
                           "vit_fwd_noid_f64": 4, "rec_walk_f64": 3})
        famc = dict(vs.LAUNCHES_FAM)
        print(f"{label}: {name} launches {json.dumps(counts)}, of them in "
              f"the family branch {json.dumps(famc)}")
        assert famc == ({"vit_fwd": 2 * nb, "vit_fwd_noid": 4} if fam
                        else {"vit_fwd": 0, "vit_fwd_noid": 0}), famc
    return {"K7": 0.0, "K7w": 0.0, "K7n": 0.0, "W2": 0.0}


def phase_f64_decodes(graphs, cf64, fsm, spdf, P, dev, B=128, N=700,
                      n2=1024, label="phase 45"):
    """Phase 45: ``viterbi`` in float64 through the float64 kernels:
    ``graphs`` maps a name to (fsm, state_pdf, P, float64 compile, the
    launches its decode must make).  At B=128, N=700 (seed 0): exactly
    those launches and no float32 one, every path's float64 weight within
    1e-8 of its score; at B=2, N=40 the scores within 1e-8 of the f64
    max-plus optimum and the paths valid, for every graph and for the
    2M-arc graph through the chunk-recompute route (K7n and W2, chunks of
    7); then the 2M-arc decode at B=128, N=1,024, past the id budget: 1 +
    17 K7n and 17 W2 launches, every path f64-valid, the checkpoint sweep,
    one 64-frame recompute and its walk timed and held bit-equal to their
    twins.  Returns (counts, times, bounds, errs)."""
    import importlib

    import torch

    import markovmodels_tpu_torch as mt
    from markovmodels_tpu_torch.ops import vit_scan as vs
    from markovmodels_tpu_torch.ops.emissions import prepare_emissions

    tvit = importlib.import_module("markovmodels_tpu_torch.viterbi")
    f64 = torch.float64
    counts = {}
    for name, (g, sp_, P_, cf, want) in graphs.items():
        rng = np.random.default_rng(0)
        lhs = torch.from_numpy(make_inputs(rng, B, N, P_)).to(dev, f64)
        lengths = torch.full((B,), N, dtype=torch.int32, device=dev)
        reset_all_launches()
        states, score = mt.viterbi(cf, lhs, lengths)
        counts[name] = launched(want)
        famc = {k: v for k, v in vs.LAUNCHES_FAM.items() if v}
        assert score.dtype == f64 and np.isfinite(score.cpu().numpy()).all()
        gap = mt.oracle.validate_paths(g, sp_, lhs.cpu().numpy(),
                                       lengths.cpu().numpy(),
                                       states.cpu().numpy(),
                                       score.cpu().numpy(),
                                       atol=TOL_F64_ORACLE)
        rng = np.random.default_rng(11)
        x2 = rng.normal(size=(2, 40, P_))
        l2 = np.array([40, 26], dtype=np.int32)
        ref = mt.oracle.host_viterbi_score(g, sp_, P_, x2, l2)
        routes = [("", lambda c, x, ln: mt.viterbi(c, x, ln))]
        if name == "2M-arc":
            routes.append((" (chunk-recompute, chunks of 7)",
                           lambda c, x, ln: tvit._viterbi_recompute(
                               c, x, ln, 7)))
        for rname, fn in routes:
            reset_all_launches()
            s2, z2 = fn(cf, torch.from_numpy(x2).to(dev),
                        torch.from_numpy(l2).to(dev))
            c2 = {k: v for k, v in all_launches().items() if v}
            assert all(k.endswith("_f64") or k == "vit_walk" for k in c2), c2
            serr = float(np.abs(z2.cpu().numpy() - ref).max())
            g2 = mt.oracle.validate_paths(g, sp_, x2, l2, s2.cpu().numpy(),
                                          ref, atol=TOL_F64_ORACLE)
            print(f"{label}: {name}{rname} float64 viterbi B=2 N=40 vs the "
                  f"f64 optimum |dscore| = {serr:.3e}, path-weight gap "
                  f"{g2:.3e} (tol {TOL_F64_ORACLE:g}); launches {c2}")
            assert serr <= TOL_F64_ORACLE, f"{name}{rname}: oracle gate"
        print(f"{label}: {name} float64 decode B={B} N={N}: launches "
              f"{json.dumps(counts[name])} (family branch {famc}); all {B} "
              f"paths walked in float64, max |path weight - score| = "
              f"{gap:.3e} (tol {TOL_F64_ORACLE:g})")

    K = min(64, n2 // 2)
    C = -(-(n2 + 1) // K)
    rng = np.random.default_rng(0)
    lhs = torch.from_numpy(make_inputs(rng, B, n2, P)).to(dev, f64)
    lengths = torch.full((B,), n2, dtype=torch.int32, device=dev)
    reason = tvit._bp_vit_reject_reason(cf64, lhs)
    assert reason is not None and "budget" in reason, reason
    reset_all_launches()
    states, score = mt.viterbi(cf64, lhs, lengths)
    counts["2M-arc N=1,024"] = launched({"vit_fwd_noid_f64": 1 + C,
                                         "rec_walk_f64": C})
    gap = mt.oracle.validate_paths(fsm, spdf, lhs.cpu().numpy(),
                                   lengths.cpu().numpy(),
                                   states.cpu().numpy(), score.cpu().numpy(),
                                   atol=TOL_F64_ORACLE)
    ext, msh = prepare_emissions(lhs, lengths, P, f64)
    t_ck = cuda_ms(lambda: vs.viterbi_fwd(cf64, ext, msh, ids=False,
                                          stride=K), reps=2)
    ck = vs.viterbi_fwd(cf64, ext, msh, ids=False, stride=K)
    ck_plain = []
    t_ck_plain = cuda_ms(lambda: ck_plain.append(vs.viterbi_fwd_plain(
        cf64, ext, msh, ids=False, stride=K)), warm=False)
    ok = {"checkpoints": all(torch.equal(x, y)
                             for x, y in zip(ck, ck_plain[0]))}
    del ck_plain
    c = C // 2
    t0 = c * K
    rec = dict(a0=ck[0][c - 1], s0=ck[1][c - 1], t0=t0)
    e_c, m_c = ext[t0:t0 + K], msh[t0:t0 + K]
    out = vs.viterbi_fwd(cf64, e_c, m_c, ids=False, **rec)
    plain = []
    t_rec_plain = cuda_ms(lambda: plain.append(vs.viterbi_fwd_plain(
        cf64, e_c, m_c, ids=False, **rec)), warm=False)
    ok["recompute"] = all(torch.equal(x, y) for x, y in zip(out, plain[0]))
    wt = vs.rec_walk_tables(cf64)
    real = torch.nonzero(cf64.orig_state >= 0)[:, 0]
    to_compiled = torch.empty_like(cf64.orig_state)
    to_compiled[cf64.orig_state[real].long()] = real.to(torch.int32)
    s_end = to_compiled[states[:, t0 + K].long()].contiguous()
    wk = vs.rec_walk(wt, out[0], out[1], lengths, t0, s_end)
    walked = []
    t_walk_plain = cuda_ms(lambda: walked.append(vs.rec_walk_plain(
        wt, out[0], out[1], lengths, t0, s_end)), warm=False)
    ok["walk"] = torch.equal(wk, walked[0])
    real_path = to_compiled[states[:, t0:t0 + K].long()].T
    ok["walk = decode"] = torch.equal(wk, real_path)
    t_rec = cuda_ms(lambda: vs.viterbi_fwd(cf64, e_c, m_c, ids=False, **rec),
                    reps=3)
    t_walk = cuda_ms(lambda: vs.rec_walk(wt, out[0], out[1], lengths, t0,
                                         s_end), reps=5)
    bounds = {"K7n": noid_bounds(cf64, B, n2 + 1, (n2 + 1) // K),
              "K7n recompute": noid_bounds(cf64, B, K, K),
              "W2": walk_bounds(wt, wk, s_end, lengths, t0,
                                cf64.padded_states)}
    print(f"{label}: 2M-arc float64 decode B={B} N={n2}: route reason: "
          f"{reason}; launches {json.dumps(counts['2M-arc N=1,024'])}; all "
          f"{B} paths walked in float64 within {gap:.3e}; K7n checkpoint "
          f"sweep {t_ck:.3f} ms over {n2 + 1} frames (bound "
          f"{bounds['K7n'][0]:.3f} ms; twin {t_ck_plain:.1f}), one {K}-frame "
          f"recompute {t_rec:.3f} ms (bound {bounds['K7n recompute'][0]:.3f}"
          f" ms; twin {t_rec_plain:.1f}), its W2 walk {t_walk:.3f} ms (bound "
          f"{bounds['W2'][0]:.4f} ms; twin {t_walk_plain:.1f}); bit-equal to "
          f"the twins and the decode {ok}")
    assert all(ok.values()), f"K7n or W2 (float64) differs: {ok}"
    times = {"K7n": (t_ck, t_ck_plain), "K7n recompute": (t_rec, t_rec_plain),
             "W2 chunk": (t_walk, t_walk_plain)}
    return counts, times, bounds


def time_f64_vit(cf, P, dev, B=128, N=700):
    """K7 (float64) over the 701-frame sweep at B=128 on phase 17's input
    in float64, CUDA events (mean of 3 warm runs), beside its twin (one
    run)."""
    import torch

    from markovmodels_tpu_torch.ops import vit_scan as vs
    from markovmodels_tpu_torch.ops.emissions import prepare_emissions

    rng = np.random.default_rng(0)
    lhs = torch.from_numpy(make_inputs(rng, B, N, P)).to(dev, torch.float64)
    lengths = torch.full((B,), N, dtype=torch.int32, device=dev)
    ext, msh = prepare_emissions(lhs, lengths, P, torch.float64)
    t = cuda_ms(lambda: vs.viterbi_fwd(cf, ext, msh), reps=3)
    out = vs.viterbi_fwd(cf, ext, msh)
    plain = []
    tp = cuda_ms(lambda: plain.append(vs.viterbi_fwd_plain(cf, ext, msh)),
                 warm=False)
    assert all(torch.equal(x, y) for x, y in zip(out, plain[0])), \
        "K7 (float64) differs from its twin at N=700"
    return t, tp


# ---- the log-space scans and the tropical decodes (phases 47-48) -----------
# The card against the CPU on the same inputs: the same float32 operations,
# but the card's segment sums, row sums and matmuls add in another order
# (logZ relative to max(1, |logZ|), posteriors absolute)
TOL_CPU = 1e-5
# the kernels of the port's CUDA extension, as the profiler names them
_EXT_KERNEL = re.compile(r"(fwd_chunk_kernel|bwd_chunk_kernel|banded_\w*kernel"
                         r"|sweep_kernel|trop_kernel|vit_sweep_kernel"
                         r"|vit_walk_kernel|rec_walk_kernel)")


def log_inputs(P, dev, B=32, N=700, seed=47, lmin=1, dtype=None):
    """(lhs (B, N, P) with ±30-nat cliffs, lengths (B,)) on ``dev`` and as
    numpy: lengths 1 and N, the rest drawn in [lmin, N)."""
    import torch

    rng = np.random.default_rng(seed)
    lhs = make_inputs(rng, B, N, P, cliffs=True)
    lens = np.r_[1, N, rng.integers(max(lmin, 2), N, size=B - 2)]
    lens = lens.astype(np.int32)
    x = torch.from_numpy(lhs).to(dev, dtype or torch.float32)
    return x, torch.from_numpy(lens).to(dev), lhs, lens


def rel_logz_err(z, ref):
    """max |dlogZ| / max(1, |logZ|) over the finite entries; the -inf
    entries must agree."""
    z, ref = np.asarray(z, np.float64), np.asarray(ref, np.float64)
    assert (np.isneginf(z) == np.isneginf(ref)).all(), "feasibility differs"
    fin = np.isfinite(ref)
    d = np.abs(z[fin] - ref[fin]) / np.maximum(1.0, np.abs(ref[fin]))
    return float(d.max(initial=0.0))


def no_extension_launch(fn, label, what):
    """One profiled call of ``fn``: no kernel of the port's CUDA extension
    among the device events (the launch counters are checked besides)."""
    prof = profile_device(fn)
    if prof is None:
        print(f"{label}: {what}: the profiler recorded no device event "
              "(the launch counters stand alone)")
        return
    by_name, busy, span, counts = prof
    ext = sorted(n for n in by_name if _EXT_KERNEL.search(n))
    assert not ext, f"{what}: extension kernels launched: {ext}"
    print(f"{label}: {what}: profile {sum(counts.values())} launches of "
          f"{len(counts)} kernels, none of the port's extension; device busy "
          f"{busy:.2f} of {span:.2f} ms (idle share "
          f"{1 - busy / span if span else 0:.3f})")


def bit_equal(a, b):
    """Two runs' outputs equal bit for bit (NaN where the other has NaN)."""
    import torch

    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    same = a == b
    if a.is_floating_point():
        same |= torch.isnan(a) & torch.isnan(b)
    return bool(same.all())


def assert_posts(posts, z, lens, what):
    """Finite (B, N, P) posteriors summing to 1 on the active frames of a
    feasible sequence and exactly 0 elsewhere."""
    p = posts.double().cpu().numpy()
    zz = z.double().cpu().numpy()
    assert np.isfinite(p).all(), f"{what}: non-finite posteriors"
    for b, L in enumerate(np.asarray(lens)):
        if np.isfinite(zz[b]):
            e = np.abs(p[b, :L].sum(axis=1) - 1).max(initial=0)
            assert e <= TOL_POST_SUM, f"{what}: posterior mass off by {e}"
            assert (p[b, L:] == 0).all(), f"{what}: posteriors past the end"
        else:
            assert (p[b] == 0).all(), f"{what}: infeasible, posteriors != 0"


def phase_log_scans(dev, label="phase 47"):
    """Phase 47: the log-space scans on the card (the plain PyTorch route
    the JAX package runs outside any Pallas kernel), at BASELINE configs 2
    and 3: the V=48 phone n-gram denominator (6,913 states, 124,417 arcs,
    P=144) compiled 'segment' and 'ell', and 32 stacked log-domain 'banded'
    numerators; returns what phase 48 reuses."""
    import torch

    import markovmodels_tpu_torch as mt

    f32, f64 = torch.float32, torch.float64
    t0 = time.perf_counter()
    fsm, spdf, P, info = mt.workloads.make_lm_hmm_graph(V=48)
    cfs = {(s, d): mt.compile_fsm(fsm, spdf, P, strategy=s, dtype=d,
                                  device=dev)
           for s in ("segment", "ell") for d in (f32, f64)}
    nums = build_numerators(P, G=32)
    num = {d: mt.stack([mt.compile_fsm(f, sp, P, strategy="banded",
                                       domain="log", dtype=d, device=dev)
                        for f, sp in nums]) for d in (f32, f64)}
    seg, ell = cfs["segment", f32], cfs["ell", f32]
    E, D = seg.fwd_src.shape[0], ell.ell_fwd_src.shape[1]
    print(f"{label}: graph {info} compiled 'segment' and 'ell' (float32 and "
          f"float64), 32 numerators stacked in domain 'log', in "
          f"{time.perf_counter() - t0:.1f} s; Sp = {seg.padded_states}, "
          f"E = {E}, ell in-degree D = {D} fwd / "
          f"{ell.ell_bwd_src.shape[1]} bwd: at B=32 the segment "
          f"contribution is {E * 32 * 4 / 1e6:.0f} MB, the ell one "
          f"{seg.padded_states * D * 32 * 4 / 1e9:.2f} GB a frame")
    for name, c in (("segment", seg), ("ell", ell),
                    ("numerators", num[f32])):
        report = mt.fast_path_report(c, 32, device=dev)
        print(f"{label}: {name} route: {report}")
        assert report.startswith("plain torch log-space scan"), report

    # B=2, N=700 against the f64 host oracle (bench.py's parity inputs)
    refs = {}
    phase_oracle_700(fsm, spdf, P, dev, {
        "V=48 segment": (seg, TOL_ORACLE_700, TOL_ORACLE),
        "V=48 ell": (ell, TOL_ORACLE_700, TOL_ORACLE),
        "V=48 segment float64": (cfs["segment", f64], TOL_ORACLE,
                                 TOL_ORACLE),
        "V=48 ell float64": (cfs["ell", f64], TOL_ORACLE, TOL_ORACLE)},
        label, refs=refs)
    rng = np.random.default_rng(7)
    nl = rng.normal(size=(2, 700, P)).astype(np.float32)
    nlen = np.array([700, 467], dtype=np.int32)
    rz, rp = zip(*(mt.oracle.host_oracle(*nums[g], P, nl[g:g + 1].astype(
        np.float64), nlen[g:g + 1]) for g in range(2)))
    rz, rp = np.concatenate(rz), np.concatenate(rp)
    for d, tz in ((f32, TOL_ORACLE_700), (f64, TOL_ORACLE)):
        st = mt.stack([mt.compile_fsm(f, sp, P, strategy="banded",
                                      domain="log", dtype=d, device=dev)
                       for f, sp in nums[:2]])
        posts, z = mt.pdfposteriors(st, torch.from_numpy(nl).to(dev, d),
                                    torch.from_numpy(nlen).to(dev))
        err = float(np.abs(z.cpu().numpy() - rz).max())
        perr = float(np.abs(posts.cpu().numpy() - rp).max())
        print(f"{label}: 2 stacked log-domain numerators ({d}) B=2 N=700 vs "
              f"f64 oracle |dlogZ| = {err:.3e} (gate {tz:g}), |dposts| = "
              f"{perr:.3e} (gate {TOL_ORACLE:g})")
        assert err <= tz and perr <= TOL_ORACLE, "numerator oracle gate"

    # the main path: B=32, N=700, mixed lengths with 1 and 700, cliffs
    lhs, lens, lhs_np, lens_np = log_inputs(P, dev)
    nlhs, nlens, nlhs_np, nlens_np = log_inputs(P, dev, seed=48, lmin=78)
    out = {}

    def posts_of(name, c, x, ln):
        def run():
            out[name] = mt.pdfposteriors(c, x, ln)
        return run

    def grad_of(name, c, x, ln):
        def run():
            xg = x.clone().requires_grad_()
            z = mt.logmarginal(c, xg, ln)
            z.sum().backward()
            out[name] = (xg.grad, z.detach())
        return run

    calls = {
        "segment pdfposteriors": posts_of("sp", seg, lhs, lens),
        "segment logmarginal+grad": grad_of("sg", seg, lhs, lens),
        "numerators pdfposteriors": posts_of("np", num[f32], nlhs, nlens),
    }
    # 'ell' moves its 2 GB contribution ~9 times a frame: one timed call
    # each, its second run the pdfposteriors inside logmarginal
    slow = {"ell pdfposteriors": posts_of("ep", ell, lhs, lens),
            "ell logmarginal+grad": grad_of("eg", ell, lhs, lens)}
    reset_all_launches()
    t_one = {k: cuda_ms(fn, warm=False)
             for k, fn in {**calls, **slow}.items()}
    counts = all_launches()
    assert not any(counts.values()), f"kernel launches: {counts}"
    first = dict(out)
    for key, what in (("sp", "segment"), ("ep", "ell"), ("np", "numerators")):
        posts, z = first[key]
        ln = nlens_np if key == "np" else lens_np
        assert posts.shape == (32, 700, P) and z.shape == (32,)
        assert_posts(posts, z, ln, what)
        assert np.isneginf(z[0].item()) and np.isfinite(z[1].item()), what
    for p, g in (("sp", "sg"), ("ep", "eg")):
        assert torch.equal(first[g][1], first[p][1]), "logmarginal != logZ"
        assert torch.equal(first[g][0], first[p][0]), "grad != posteriors"
    e = rel_logz_err(first["ep"][1].cpu(), first["sp"][1].cpu())
    pe = float((first["ep"][0] - first["sp"][0]).abs().max())
    print(f"{label}: B=32 N=700: 'ell' vs 'segment' |dlogZ|/max(1,|logZ|) = "
          f"{e:.3e}, |dposts| = {pe:.3e}; gradients equal to the posteriors "
          f"and logmarginal to logZ, bit for bit; launches of the extension "
          f"{sum(counts.values())}")
    assert e <= TOL_CPU and pe <= TOL_CPU

    t = median_ms(calls)
    for key in ("sp", "sg", "np"):  # the last timed run
        assert all(bit_equal(a, b) for a, b in zip(out[key], first[key])), \
            f"{key}: two runs differ"
    t.update({f"{k} (one call)": t_one[k] for k in slow})
    print(f"{label}: two runs of every call bit-equal ('ell': its "
          "pdfposteriors and the one inside logmarginal); first calls "
          + ", ".join(f"{k} {v:.2f} ms" for k, v in t_one.items()))
    # the profiles over 100 frames (the same route; ~37 launches a frame)
    n = 100
    for what, c, x, ln in (("segment", seg, lhs, lens),
                           ("numerators", num[f32], nlhs, nlens),
                           ("ell", ell, lhs[:2], lens[:2])):
        no_extension_launch(
            posts_of("prof", c, x[:, :n], torch.clamp(ln, max=n)), label,
            f"{what} pdfposteriors B={x.shape[0]} N={n}")

    # the card against the CPU on the same inputs (short: the CPU's ell
    # contribution is 6,920 x D per column)
    for name, c, x, ln, n in (
            ("segment", seg, lhs[:2], lens[:2], 60),
            ("ell", ell, lhs[:2], lens[:2], 8),
            ("numerators", num[f32], nlhs, nlens, 120)):
        ln = torch.clamp(ln, max=n)
        pc, zc = mt.pdfposteriors(c, x[:, :n], ln)
        ph, zh = mt.pdfposteriors(c.to("cpu"), x[:, :n].cpu(), ln.cpu())
        e = rel_logz_err(zc.cpu(), zh)
        pe = float((pc.cpu() - ph).abs().max())
        print(f"{label}: {name} card vs CPU B={x.shape[0]} N={n}: "
              f"|dlogZ|/max(1,|logZ|) = {e:.3e}, |dposts| = {pe:.3e} (tol "
              f"{TOL_CPU:g})")
        assert e <= TOL_CPU and pe <= TOL_CPU, f"{name}: card vs CPU"

    # for reference: the same graph on the kernels.  'block' compiles it in
    # two tiers, which K2-K4 refuse (ROADMAP item 16); 'dense' runs K6a/K6b
    blk = mt.compile_fsm(fsm, spdf, P, strategy="block", device=dev)
    print(f"{label}: V=48 'block': {mt.fast_path_report(blk, 32)}")
    dn = mt.compile_fsm(fsm, spdf, P, strategy="dense", device=dev)
    t.update(median_ms({"V=48 'dense' den-only on K6a/K6b (reference)":
                        lambda: mt.pdfposteriors(dn, lhs, lens)}))
    card = card_line()
    for k, v in t.items():
        print(f"timing: {label} {k} B=32 N=700"
              f"{'' if 'one call' in k else ' median of 5'}: {v:.2f} ms "
              f"({card})")
    print(f"{label}: {time.perf_counter() - t0:.1f} s in all")
    return dict(fsm=fsm, spdf=spdf, P=P, seg=seg, num=num[f32], nums=nums,
                lhs=(lhs, lens, lhs_np, lens_np),
                nlhs=(nlhs, nlens, nlhs_np, nlens_np), times=t)


def phase_trop_decodes(dev, g, label="phase 48"):
    """Phase 48: the tropical decodes of the log-domain route on the card
    (``_viterbi_single``: int32 backpointers, plain PyTorch): the V=48
    'segment' graph and the forced alignment of the 32 stacked numerators
    at B=32, N=700, and ``maxstateposteriors``."""
    import torch

    import markovmodels_tpu_torch as mt

    t0 = time.perf_counter()
    fsm, spdf, P, seg, num = g["fsm"], g["spdf"], g["P"], g["seg"], g["num"]
    lhs, lens, lhs_np, lens_np = g["lhs"]
    nlhs, nlens, nlhs_np, nlens_np = g["nlhs"]
    out = {}

    def dec(name, c, x, ln):
        def run():
            out[name] = mt.viterbi(c, x, ln)
        return run

    def msp(name, c, x, ln):
        def run():
            out[name] = mt.maxstateposteriors(c, x, ln)
        return run

    calls = {"segment viterbi B=32 N=700": dec("sv", seg, lhs, lens),
             "numerators forced alignment B=32 N=700": dec("nv", num, nlhs,
                                                           nlens),
             "segment maxstateposteriors B=2 N=700": msp("ms", seg,
                                                         lhs[1:3],
                                                         lens[1:3])}
    reset_all_launches()
    for fn in calls.values():
        fn()
    torch.cuda.synchronize()
    counts = all_launches()
    assert not any(counts.values()), f"kernel launches: {counts}"
    first = dict(out)

    states, score = (a.cpu().numpy() for a in first["sv"])
    assert states.shape == (32, 700) and states.dtype == np.int32
    feas = np.isfinite(score)
    assert not feas[0] and feas[1:].all(), "feasibility"
    idx = [1, int(np.argsort(lens_np)[16])]  # lengths 700 and a middle one
    ref = mt.oracle.host_viterbi_score(fsm, spdf, P, lhs_np[idx].astype(
        np.float64), lens_np[idx])
    serr = float(np.abs(score[idx] - ref).max())
    gap = mt.oracle.validate_paths(fsm, spdf, lhs_np[feas], lens_np[feas],
                                   states[feas], score[feas],
                                   atol=TOL_VIT_WALK)
    print(f"{label}: segment viterbi B=32 N=700: |dscore| vs the f64 "
          f"optimum at lengths {lens_np[idx].tolist()} = {serr:.3e} (tol "
          f"{TOL_VIT_ORACLE:g}); 31 feasible paths' f64 weight vs score "
          f"<= {gap:.3e} (tol {TOL_VIT_WALK:g}); length 1 infeasible")
    assert serr <= TOL_VIT_ORACLE

    nst, nsc = (a.cpu().numpy() for a in first["nv"])
    nfeas = np.isfinite(nsc)
    assert not nfeas[0] and nfeas[1:].all(), "numerator feasibility"
    serr = gap = 0.0
    for b in np.flatnonzero(nfeas):
        f, sp = g["nums"][b]
        ref = mt.oracle.host_viterbi_score(f, sp, P, nlhs_np[b:b + 1].astype(
            np.float64), nlens_np[b:b + 1])
        serr = max(serr, float(abs(nsc[b] - ref[0])))
        gap = max(gap, mt.oracle.validate_paths(
            f, sp, nlhs_np[b:b + 1], nlens_np[b:b + 1], nst[b:b + 1],
            nsc[b:b + 1], atol=TOL_VIT_WALK))
    print(f"{label}: forced alignment of 32 numerators B=32 N=700: |dscore| "
          f"vs each graph's f64 optimum <= {serr:.3e} (tol "
          f"{TOL_VIT_ORACLE:g}); paths' f64 weight vs score <= {gap:.3e}")
    assert serr <= TOL_VIT_ORACLE

    gam, msc = first["ms"]
    gm = gam.cpu().numpy()
    assert gm.shape == (2, 700, seg.padded_states)
    np.testing.assert_allclose(msc.cpu().numpy(), score[1:3], rtol=0,
                               atol=TOL_VIT)
    on = top = 0.0
    for b in range(2):
        L = int(lens_np[1 + b])
        on = max(on, float(np.abs(gm[b, np.arange(L),
                                     states[1 + b, :L]]).max()))
        top = max(top, float(gm[b, :L].max()))
    print(f"{label}: maxstateposteriors B=2 N=700 (2 x 700 x "
          f"{seg.padded_states}, lengths {lens_np[1:3].tolist()}): the "
          f"best-path states |gamma| <= {on:.3e}, the max over all states "
          f"{top:.3e} (tol {TOL_VIT_WALK:g}); scores equal viterbi's")
    assert on <= TOL_VIT_WALK and top <= TOL_VIT_WALK

    t = median_ms(calls)
    for key in ("sv", "nv", "ms"):
        assert all(bit_equal(a, b) for a, b in zip(out[key], first[key])), \
            f"{key}: two runs differ"
    print(f"{label}: two runs of every call bit-equal")
    no_extension_launch(dec("prof", num, nlhs[:, :100],
                            torch.clamp(nlens, max=100)),
                        label, "forced alignment B=32 N=100")
    for name, c, x, ln, n in (("segment", seg, lhs[:2], lens[:2], 60),
                              ("numerators", num, nlhs, nlens, 120)):
        ln = torch.clamp(ln, max=n)
        sc_, zc = mt.viterbi(c, x[:, :n], ln)
        sh, zh = mt.viterbi(c.to("cpu"), x[:, :n].cpu(), ln.cpu())
        same = bool(torch.equal(sc_.cpu(), sh))
        e = rel_logz_err(zc.cpu(), zh)
        print(f"{label}: {name} viterbi card vs CPU B={x.shape[0]} N={n}: "
              f"states equal {same}, |dscore|/max(1,|score|) = {e:.3e}")
        assert same and e <= TOL_CPU, f"{name}: card vs CPU decode"
    card = card_line()
    for k, v in t.items():
        print(f"timing: {label} {k} median of 5: {v:.2f} ms ({card})")
    print(f"{label}: {time.perf_counter() - t0:.1f} s in all")
    return t


def phase_log_kernel_decodes(graphs, dev, B=32, N=700, label="phase 49"):
    """Phase 49: a log-domain 'block' or 'dense' graph decodes on the
    kernels of its probability-domain twin (K7 and its walk, K6t and W2):
    the Viterbi decode does not depend on the domain.  ``graphs``: (name,
    fsm, spdf, P, the probability-domain compile, compile_fsm's keyword
    arguments, the launches wanted).  Each graph is compiled anew with
    ``domain='log'``; its decode at B=32, N=700 must launch the kernels
    and equal the probability-domain graph's decode bit for bit."""
    import torch

    import markovmodels_tpu_torch as mt

    t0 = time.perf_counter()
    calls = {}
    for name, fsm, spdf, P, cf, kw, want in graphs:
        lcf = mt.compile_fsm(fsm, spdf, P, domain="log", device=dev, **kw)
        assert lcf.domain == "log" and lcf.strategy == cf.strategy
        lhs, lens = vit_inputs(P, dev, B=B, N=N, seed=49)
        reset_all_launches()
        sl, zl = mt.viterbi(lcf, lhs, lens)
        counts = launched(want)
        sp, zp = mt.viterbi(cf, lhs, lens)
        same = bit_equal(sl, sp) and bit_equal(zl, zp)
        print(f"{label}: {name} compiled domain='log', viterbi B={B} N={N}: "
              f"launches {counts}; states and scores bit-equal to the "
              f"probability-domain graph's {same}")
        assert same, f"{name}: the log-domain decode differs"
        calls[f"{name} log-domain viterbi B={B} N={N}"] = (
            lambda c=lcf, x=lhs, ln=lens: mt.viterbi(c, x, ln))
        calls[f"{name} probability-domain viterbi B={B} N={N}"] = (
            lambda c=cf, x=lhs, ln=lens: mt.viterbi(c, x, ln))
    t = median_ms(calls)
    torch.cuda.synchronize()
    card = card_line()
    for k, v in t.items():
        print(f"timing: {label} {k} median of 5: {v:.2f} ms ({card})")
    print(f"{label}: {time.perf_counter() - t0:.1f} s in all")
    return t


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this check "
              "needs a CUDA card", file=sys.stderr)
        return 1
    # full float32 everywhere, in the plain twins' matmuls too
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")

    import markovmodels_tpu_torch as mt
    from markovmodels_tpu_torch.ops import _build
    from markovmodels_tpu_torch.ops import banded_scan as bsc
    from markovmodels_tpu_torch.ops import block_scan as bs
    from markovmodels_tpu_torch.ops import dense_scan as ds
    from markovmodels_tpu_torch.ops import vit_scan as vs

    card = card_line()
    print(card)

    t0 = time.perf_counter()
    _build.library()
    print(f"phase 2: kernels built in {time.perf_counter() - t0:.1f} s "
          f"into {_build.build_dir()}")
    if _build.PTXAS_LOG:
        print(_build.PTXAS_LOG, file=sys.stderr)

    t0 = time.perf_counter()
    fsm, spdf, P, info = mt.workloads.make_lm_hmm_graph(V=128)
    cf = mt.compile_fsm(fsm, spdf, P, strategy="block", precision="high",
                        device=dev)
    print(f"phase 3: graph {info} compiled in "
          f"{time.perf_counter() - t0:.1f} s; Sp = {cf.padded_states}; "
          f"path: {mt.fast_path_report(cf, 128)}")

    t0 = time.perf_counter()
    num_cf = stack_numerators(build_numerators(P), P, dev)
    print(f"phase 3: 128 numerators compiled and stacked in "
          f"{time.perf_counter() - t0:.1f} s; Sp = {num_cf.padded_states}, "
          f"offsets {num_cf.banded_offsets}; path: "
          f"{mt.fast_path_report(num_cf, 128)}")

    errs = phase_kernels(cf, P, dev, twice=True)
    phase_oracle(fsm, spdf, cf, P, dev)
    _, t_kern, t_plain = phase_main(cf, P, dev)
    errs.update(phase_banded_kernels(num_cf, P, dev))
    phase_banded_oracle(P, dev)
    launches, t_step, t_den = phase_step(num_cf, cf, P, dev, (bs, bsc),
                                         "phase 9")
    t_big, w_launches, w_errs, w_times, w_bounds = phase_big_numerators(
        cf, P, dev, t_step)
    g14 = phase_numerator_stack(P, dev, (1350, 1340, 1300, 1349), 700,
                                (700, 690, 680, 700), (bsc.CLUSTER,) * 2)
    print("phase 8b: a frame just past the wide instantiation: K5a "
          f"{1e3 * g14[2]['K5a'][0] / 701:.2f} us (Sp = 1,352, cluster) "
          f"beside {1e3 * w_times['K5a'][0] / 701:.2f} (Sp = 1,208, wide), "
          f"K5b {1e3 * g14[2]['K5b'][0] / 701:.2f} beside "
          f"{1e3 * w_times['K5b'][0] / 701:.2f}; {card}")
    t_big3, *g3 = phase_big_numerators(
        cf, P, dev, t_step, lengths=(3000, 2950, 2900, 2990), N=2400,
        lens=(2400, 2380, 2350, 2400), instantiation="cluster")
    g24 = phase_longest_numerators(P, dev)
    for dt in (torch.float32, torch.float64):
        e8r = phase_cluster_ranks(P, dev, dt)[1]
        errs.update({k: max(errs[k], v) for k, v in e8r.items()})
    gpast = phase_numerator_stack(P, dev, (52000, 120, 100, 80), 64,
                                  (64, 60, 50, 64), (bsc.GLOBAL,) * 2, G=4,
                                  seed=11)
    e8c = phase_narrow_subnormal(P, dev)
    errs.update({k: max(errs[k], v) for k, v in e8c.items()})
    profile_step(num_cf, cf, P, dev, "phase 9")
    profile_block_den(cf, P, dev, "phase 9")
    times, terrs = time_kernels(cf, P, dev)
    errs.update({k: max(errs[k], v) for k, v in terrs.items()})
    splits = {"2M-arc": frame_split(cf, P, dev, "2M-arc graph")}
    times.update(time_banded(num_cf, P, dev))
    bounds = block_bounds(cf, 128, -(-701 // 64) * 64, 64)
    bounds.update(banded_bounds(num_cf, 701))

    t0 = time.perf_counter()
    dfsm, dspdf, dP, dinfo = mt.workloads.make_lm_hmm_graph(V=32)
    dcf = mt.compile_fsm(dfsm, dspdf, dP, device=dev)  # default: 'auto'
    assert dcf.strategy == "dense" and dcf.precision == "high", dcf.strategy
    print(f"phase 10: graph {dinfo} compiled (strategy {dcf.strategy!r}, "
          f"precision {dcf.precision!r}) in {time.perf_counter() - t0:.1f} "
          f"s; Sp = {dcf.padded_states}; path: "
          f"{mt.fast_path_report(dcf, 128)}")
    dnum_cf = stack_numerators(build_numerators(dP), dP, dev)
    errs.update(phase_dense_kernels(ds.kernel_operator(dcf), dP, dev))
    phase_dense_full(dev)
    phase_oracle(dfsm, dspdf, dcf, dP, dev, label="phase 12")
    bs.reset_launch_counts()
    vs.reset_launch_counts()
    e96 = phase_banded_kernels(dnum_cf, dP, dev, "phase 13")
    times96 = time_banded(dnum_cf, dP, dev)
    bounds96 = banded_bounds(dnum_cf, 701)
    dlaunches, t_dstep, t_dden = phase_step(dnum_cf, dcf, dP, dev,
                                            (bsc, ds), "phase 13")
    assert dlaunches == {"banded_fwd": 1, "banded_bwd": 1, "dense_fwd": 1,
                         "dense_bwd": 1}, dlaunches
    assert not any(bs.LAUNCHES.values()) and not any(vs.LAUNCHES.values())
    profile_dense_step(dnum_cf, dcf, dP, dev, "phase 13")
    phase_dense_stack(dev)
    times.update(time_dense(dcf, dP, dev))
    bounds.update(dense_bounds(dcf, 128, 701))
    dense_eq = dense_bounds(dcf, 128, 701, dense=True)
    t_mm = matmul_yardstick(dcf, dev)
    t_sp = sparse_yardstick(dcf, dev)
    floor = frame_floor(dcf, dP, dev)
    print(f"timing: K6 yardsticks x701 frames: torch.matmul of the (3200, "
          f"3200) operator by the (3200, 128) state {t_mm:.3f} ms; "
          f"torch.sparse.mm of its CSR ({int(ds.kernel_operator(dcf).wf.count_nonzero())} "
          f"non-zeros) {ms_or_not(t_sp)} ms; bounds from the non-zeros K6a "
          f"{bounds['K6a'][0]:.4f} ms, K6b {bounds['K6b'][0]:.4f} ms, "
          f"dense-equivalent {dense_eq['K6a'][0]:.2f} / "
          f"{dense_eq['K6b'][0]:.2f} ms; a frame without the product "
          f"(epilogue, statistics, grid barrier): K6a {floor[0]:.2f} us, "
          f"K6b {floor[1]:.2f} us")

    verrs = [phase_vit_kernels(cf, P, dev, B=b) for b in (128, 126)]
    errs.update({k: max(e[k] for e in verrs) for k in verrs[0]})
    phase_vit_oracle(fsm, spdf, cf, P, dev)
    vlaunches, vtimes, t_dec, verrs, vsplit = phase_vit_main(fsm, spdf, cf,
                                                             P, dev)
    errs.update({k: max(errs[k], v) for k, v in verrs.items()})
    times.update(vtimes)
    splits["2M-arc"]["K7"] = vsplit
    bounds.update(vit_bounds(cf, 128, 701))
    print(f"timing: K7 bound {bounds['K7'][0]:.3f} ms ({bounds['K7'][1]}: a "
          f"multiply and a max per tier candidate, the id 1/"
          f"{vs.layout(128, 700, False)[1]} of "
          f"that); the four-instruction count of a running (max, argmax) "
          f"loop gives {bounds['K7 (4 instructions)'][0]:.3f} ms; sweep "
          f"{times['K7'][0]:.3f} ms")

    t0 = time.perf_counter()
    sfsm, sspdf, sP, sinfo = mt.workloads.make_backoff_lm_hmm_graph(
        V=128, keep=0.1, layout="separate")
    scf = mt.compile_fsm(sfsm, sspdf, sP, device=dev)  # the defaults
    report = mt.fast_path_report(scf, 128)
    print(f"phase 18: graph {sinfo} compiled (strategy {scf.strategy!r}, "
          f"ov_layout {scf.ov_layout}) in {time.perf_counter() - t0:.1f} s; "
          f"Sp = {scf.padded_states}; path: {report}")
    assert scf.strategy == "block" and scf.ov_layout == (128, 3), "layout"
    assert report.startswith("cuda-block-scan"), report
    ov_errs = phase_kernels(scf, sP, dev, label="phase 19", twice=True)
    phase_oracle(sfsm, sspdf, scf, sP, dev, label="phase 20")
    efsm, espdf, eP, _ = mt.workloads.make_backoff_lm_hmm_graph(
        V=128, keep=0.1, layout="embedded")
    ecf = mt.compile_fsm(efsm, espdf, eP, device=dev)
    assert ecf.pdf_group and mt.fast_path_report(ecf, 128).startswith(
        "cuda-block-scan"), "embedded layout"
    ov_launches, t_ostep, t_oden, t_emb = phase_ov_step(num_cf, scf, ecf, sP,
                                                        dev)
    profile_block_den(scf, sP, dev, "phase 21")
    ov_times, terrs = time_kernels(scf, sP, dev)
    ov_errs.update({k: max(ov_errs[k], v) for k, v in terrs.items()})
    splits["separate-state"] = frame_split(scf, sP, dev,
                                           "separate-state graph")
    ov_bounds = block_bounds(scf, 128, -(-701 // 64) * 64, 64)

    # ---- precision='bf16' -------------------------------------------------
    t0 = time.perf_counter()
    cf16 = mt.compile_fsm(fsm, spdf, P, strategy="block", precision="bf16",
                          device=dev)
    scf16 = mt.compile_fsm(sfsm, sspdf, sP, precision="bf16", device=dev)
    dcf16 = mt.compile_fsm(dfsm, dspdf, dP, precision="bf16", device=dev)
    for c, want in ((cf16, "cuda-block-scan"), (scf16, "cuda-block-scan"),
                    (dcf16, "cuda-dense-scan")):
        report = mt.fast_path_report(c, 128)
        assert c.precision == "bf16" and report.startswith(want), report
    assert scf16.ov_layout == (128, 3) and dcf16.strategy == "dense"
    assert bs.kernel_operator(cf16).fwd.W.dtype == torch.bfloat16
    assert ds.kernel_operator(dcf16).wf.dtype == torch.bfloat16
    print(f"phase 22: the 2M-arc, separate-state and V=32 graphs compiled "
          f"with precision='bf16' in {time.perf_counter() - t0:.1f} s; "
          f"paths: {mt.fast_path_report(cf16, 128)}; "
          f"{mt.fast_path_report(dcf16, 128)}")

    bf16_checks("phase 23", (bs,), lambda: phase_block_frames(
        cf16, P, dev, "phase 23"))
    bf16_checks("phase 23", (bs,), lambda: phase_block_frames(
        scf16, sP, dev, "phase 23 (separate)"))
    b_errs = bf16_checks("phase 23", (bs,), lambda: phase_kernels(
        cf16, P, dev, label="phase 23", twice=True, tol=TOL_KERNEL_BF16))
    sb_errs = bf16_checks("phase 23", (bs,), lambda: phase_kernels(
        scf16, sP, dev, label="phase 23 (separate)", twice=True,
        tol=TOL_KERNEL_BF16))

    def dense_checks():
        kop16 = ds.kernel_operator(dcf16)
        e128 = phase_dense_kernels(kop16, dP, dev, N=128, label="phase 24",
                                   tol=TOL_KERNEL_BF16)
        e700 = phase_dense_kernels(kop16, dP, dev, label="phase 24",
                                   tol=TOL_KERNEL_BF16)
        return {k: max(e128[k], e700[k]) for k in e128}

    bf16_checks("phase 24", (ds,), lambda: phase_dense_frames(
        ds.kernel_operator(dcf16), dP, dev, "phase 24"))
    d_errs = bf16_checks("phase 24", (ds,), dense_checks)

    t0 = time.perf_counter()
    oracle, oracle_refs = {}, {}  # the f64 oracle of each graph, kept
    for gname, (g, sp_, P_, hi, lo, (tz, tp)) in {
            "2M-arc": (fsm, spdf, P, cf, cf16,
                       (TOL_BF16_LOGZ, TOL_BF16_POSTS)),
            "separate-state": (sfsm, sspdf, sP, scf, scf16,
                               (TOL_BF16_LOGZ, TOL_BF16_POSTS)),
            "V=32 dense": (dfsm, dspdf, dP, dcf, dcf16,
                           (TOL_DENSE_BF16_LOGZ, TOL_DENSE_BF16_POSTS)),
    }.items():
        res, _ = phase_oracle_700(g, sp_, P_, dev, {
            f"{gname} high": (hi, TOL_ORACLE_700, TOL_ORACLE),
            f"{gname} bf16": (lo, tz, tp)}, "phase 25", refs=oracle_refs)
        oracle.update(res)
    print(f"phase 25: N=700 oracle gates in {time.perf_counter() - t0:.1f} s")

    b_launches, _, _ = phase_step(num_cf, cf16, P, dev, (bs, bsc),
                                  "phase 26", bf16=True)
    sb_launches, _, _ = phase_step(num_cf, scf16, sP, dev, (bs, bsc),
                                   "phase 27", bf16=True)
    d_launches, _, _ = phase_step(dnum_cf, dcf16, dP, dev, (bsc, ds),
                                  "phase 28", bf16=True)
    assert d_launches == {"banded_fwd": 1, "banded_bwd": 1,
                          "dense_fwd_bf16": 1, "dense_bwd_bf16": 1}, d_launches
    profile_dense_step(dnum_cf, dcf16, dP, dev, "phase 28")

    def step(num, den, P_):
        """(the training step, den-only pdfposteriors) on phase 9's input"""
        rng = np.random.default_rng(0)
        lhs = torch.from_numpy(make_inputs(rng, 128, 700, P_)).to(dev)
        lens = torch.full((128,), 700, dtype=torch.int32, device=dev)

        def run():
            x = lhs.clone().requires_grad_()
            mt.lfmmi_loss(num, den, x, lens).sum().backward()
        return run, lambda: mt.pdfposteriors(den, lhs, lens)

    (s32, p32), (s16, p16) = step(num_cf, cf, P), step(num_cf, cf16, P)
    (ds32, dp32), (ds16, dp16) = (step(dnum_cf, dcf, dP),
                                  step(dnum_cf, dcf16, dP))
    (ss32, sp32), (ss16, sp16) = (step(num_cf, scf, sP),
                                  step(num_cf, scf16, sP))
    paths16 = time_bf16_paths({
        "2M-arc LF-MMI step": (s32, s16),
        "2M-arc den-only pdfposteriors": (p32, p16),
        "dense LF-MMI step": (ds32, ds16),
        "dense den-only pdfposteriors": (dp32, dp16),
        "separate-state LF-MMI step": (ss32, ss16),
        "separate-state den-only pdfposteriors": (sp32, sp16),
    }, dev)
    for name, c16, P_ in (("2M-arc", cf16, P), ("separate-state", scf16, sP)):
        profile_block_den(c16, P_, dev, f"phase 29 ({name} bf16)")
    for name, fn in (("dense", dp16),):
        prof = profile_device(fn)
        if prof is None:
            print(f"phase 29: profile of the {name} bf16 den-only "
                  "pdfposteriors: not measured (no device events recorded)")
            continue
        by_name, busy, span, _ = prof
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
        print(f"phase 29: profile of one {name} bf16 den-only pdfposteriors: "
              f"device busy {busy:.3f} ms of a {span:.3f} ms span (idle "
              f"{1 - busy / span:.1%}); "
              + "; ".join(f"{k} {v:.3f} ms" for k, v in top))
    b_times, terrs = time_kernels(cf16, P, dev, tol=TOL_KERNEL_BF16)
    b_errs.update({k: max(b_errs[k], v) for k, v in terrs.items()})
    sb_times, terrs = time_kernels(scf16, sP, dev, tol=TOL_KERNEL_BF16)
    sb_errs.update({k: max(sb_errs[k], v) for k, v in terrs.items()})
    splits["2M-arc bf16"] = frame_split(cf16, P, dev, "2M-arc graph (bf16)")
    splits["separate-state bf16"] = frame_split(
        scf16, sP, dev, "separate-state graph (bf16)")
    d_times = time_dense(dcf16, dP, dev)
    t_mm16 = matmul_yardstick_bf16(dcf16, dev)
    t_sp16 = sparse_yardstick(dcf16, dev)
    print(f"timing: K6 bf16 yardstick, torch.mm of the bf16 (3200, 3200) "
          f"operator by a bf16 (3200, 128) state into float32, x701 frames: "
          f"{t_mm16:.3f} ms (float32: {t_mm:.3f} ms); torch.sparse.mm of "
          f"its bf16 CSR x701: {ms_or_not(t_sp16)} ms")
    b_bounds = block_bounds(cf16, 128, -(-701 // 64) * 64, 64)
    sb_bounds = block_bounds(scf16, 128, -(-701 // 64) * 64, 64)
    d_bounds = dense_bounds(dcf16, 128, 701)
    phase_bf16_decode(cf, cf16, P, dev)
    del cf16, scf16, dcf16

    # ---- the chunk-recompute decode ----------------------------------------
    r_errs = phase_rec_kernels(dcf, dP, cf, P, dev)
    d_times, d_errs2, d_bounds2, t_ddec, d_counts = phase_dense_decode(
        dfsm, dspdf, dcf, dP, dev)
    b_times2, b_errs2, b_bounds2, t_bdec, b_counts = phase_block_recompute(
        fsm, spdf, cf, P, dev)

    # ---- the overflow-family decode (the separate-state graph) ------------
    o_errs = [phase_ov_vit_kernels(scf, sP, dev, B=b) for b in (128, 126)]
    phase_vit_oracle(sfsm, sspdf, scf, sP, dev, label="phase 35")
    phase_vit_oracle(efsm, espdf, ecf, eP, dev,
                     label="phase 35 (embedded layout)")
    o_counts, o_times, o_med, e36, o_split = phase_ov_vit_main(
        sfsm, sspdf, scf, efsm, espdf, ecf, sP, dev, t_dec)
    o_errs.append(e36)
    o_bounds = vit_bounds(scf, 128, 701)
    print(f"timing: K7 (family branch) bound {o_bounds['K7'][0]:.3f} ms "
          f"({o_bounds['K7'][1]}; the uniform K7's on the 2M-arc graph "
          f"{bounds['K7'][0]:.3f} ms); sweep {o_times['K7'][0]:.3f} ms")
    o_times2, o_errs2, o_bounds2, t_odec, o_counts2 = phase_block_recompute(
        sfsm, sspdf, scf, sP, dev, label="phase 37", name="separate-state")

    # ---- float64 and general C-hat ----------------------------------------
    f64 = torch.float64
    t0 = time.perf_counter()
    cf64 = mt.compile_fsm(fsm, spdf, P, strategy="block", dtype=f64,
                          device=dev)
    scf64 = mt.compile_fsm(sfsm, sspdf, sP, dtype=f64, device=dev)
    dcf64 = mt.compile_fsm(dfsm, dspdf, dP, dtype=f64, device=dev)
    for c, want in ((cf64, "cuda-block-scan"), (scf64, "cuda-block-scan"),
                    (dcf64, "cuda-dense-scan")):
        report = mt.fast_path_report(c, 128)
        assert report.startswith(want) and c.alpha_hat.dtype == f64, report
    assert scf64.ov_layout == (128, 3) and dcf64.strategy == "dense"
    assert bs.kernel_operator(cf64).fwd.W.dtype == f64
    print(f"phase 38: the 2M-arc, separate-state and V=32 graphs compiled "
          f"float64 in {time.perf_counter() - t0:.1f} s; paths: "
          f"{mt.fast_path_report(cf64, 128)}; "
          f"{mt.fast_path_report(dcf64, 128)}")
    f_errs = phase_f64_kernels(cf64, P, dev, "phase 38")
    sf_errs = phase_f64_kernels(scf64, sP, dev, "phase 38 (separate)")

    t0 = time.perf_counter()
    for gname, (g, sp_, P_, c64) in {
            "2M-arc": (fsm, spdf, P, cf64),
            "separate-state": (sfsm, sspdf, sP, scf64)}.items():
        res, _ = phase_oracle_700(g, sp_, P_, dev, {
            f"{gname} float64": (c64, TOL_ORACLE, TOL_ORACLE)}, "phase 39",
            refs=oracle_refs)
        (e, pe), (e32, pe32) = res[f"{gname} float64"], oracle[
            f"{gname} high"]
        print(f"phase 39: {gname} float64 |dlogZ| {e:.3e}, |dposts| "
              f"{pe:.3e} beside float32 (phase 25) {e32:.3e}, {pe32:.3e}; "
              f"the contract {TOL_ORACLE:g}")
    print(f"phase 39: float64 oracle gates in {time.perf_counter() - t0:.1f} "
          "s")

    num64 = stack_numerators(build_numerators(P), P, dev, f64)
    report = mt.fast_path_report(num64, 128)
    assert report.startswith("cuda-banded-scan") and report.endswith(
        ", float64)"), report
    f_steps, f_launches = phase_f64_steps({
        "2M-arc": (step_fns(num_cf, cf, P, dev, torch.float32),
                   step_fns(num64, cf64, P, dev, f64)),
        "separate-state": (step_fns(num_cf, scf, sP, dev, torch.float32),
                           step_fns(num64, scf64, sP, dev, f64)),
    }, "phase 40")
    profile_f64_step(step_fns(num64, cf64, P, dev, f64)[0], "phase 40")
    profile_block_den(cf64, P, dev, "phase 40 (2M-arc float64)")
    f_times, terrs = time_kernels(cf64, P, dev, tol=TOL_F64)
    f_errs.update({k: max(f_errs[k], v) for k, v in terrs.items()})
    sf_times, terrs = time_kernels(scf64, sP, dev, tol=TOL_F64)
    sf_errs.update({k: max(sf_errs[k], v) for k, v in terrs.items()})
    splits["2M-arc f64"] = frame_split(cf64, P, dev, "2M-arc graph (float64)")
    splits["separate-state f64"] = frame_split(
        scf64, sP, dev, "separate-state graph (float64)")
    f_bounds = block_bounds(cf64, 128, -(-701 // 64) * 64, 64)
    sf_bounds = block_bounds(scf64, 128, -(-701 // 64) * 64, 64)
    for name in ("K2", "K3", "K4"):
        print(f"timing: {name} float64 {f_times[name][0]:.3f} ms (float32 "
              f"{times[name][0]:.3f} ms), bound {f_bounds[name][0]:.3f} ms "
              f"({f_bounds[name][1]}; float32 {bounds[name][0]:.3f} ms); "
              f"separate-state float64 {sf_times[name][0]:.3f} ms (float32 "
              f"{ov_times[name][0]:.3f} ms), bound {sf_bounds[name][0]:.3f} "
              f"ms")

    k5_errs, k5_times, k5w64, k5c64 = phase_k5_f64(num64, P, dev)
    k5_bounds = banded_bounds(num64, 701)
    for name in ("K5a", "K5b"):
        print(f"timing: {name} float64 {k5_times[name][0]:.3f} ms (float32 "
              f"{times[name][0]:.3f} ms), bound {k5_bounds[name][0]:.3f} ms "
              f"({k5_bounds[name][1]}; float32 {bounds[name][0]:.3f} ms)")

    # ---- the float64 'dense' scan and the float64 decode (phases 42-46) ----
    d64_errs = phase_f64_dense(dcf64, dP, dev)
    reset_all_launches()
    phase_oracle_700(dfsm, dspdf, dP, dev, {
        "V=32 dense float64": (dcf64, TOL_F64_ORACLE, TOL_F64_ORACLE)},
        "phase 39 (the float64 'dense' graph, on K6a/K6b)", refs=oracle_refs)
    print(f"phase 39: the float64 dense graph's launches "
          f"{launched({'dense_fwd_f64': 1, 'dense_bwd_f64': 1})}")
    t64_errs, t64_times, t64_bounds = phase_f64_trop(dcf64, dP, dev)
    v64_errs = phase_f64_vit(cf64, scf64, P, sP, dev)
    dec64_counts, dec64_times, dec64_bounds = phase_f64_decodes({
        "V=32 dense": (dfsm, dspdf, dP, dcf64,
                       {"dense_trop_f64": 1, "rec_walk_f64": 1}),
        "2M-arc": (fsm, spdf, P, cf64, {"vit_fwd_f64": 1, "vit_walk": 1}),
        "separate-state": (sfsm, sspdf, sP, scf64,
                           {"vit_fwd_f64": 1, "vit_walk": 1}),
    }, cf64, fsm, spdf, P, dev)

    dnum64 = stack_numerators(build_numerators(dP), dP, dev, f64)
    dstep64, dden64 = step_fns(dnum64, dcf64, dP, dev, f64)
    dstep32, dden32 = step_fns(dnum_cf, dcf, dP, dev, torch.float32)
    reset_all_launches()
    dstep64()
    dstep64_counts = launched({"banded_fwd_f64": 1, "banded_bwd_f64": 1,
                               "dense_fwd_f64": 1, "dense_bwd_f64": 1})

    def decode(cf_, P_, n, dtype):
        rng = np.random.default_rng(0)
        x = torch.from_numpy(make_inputs(rng, 128, n, P_)).to(dev, dtype)
        ln = torch.full((128,), n, dtype=torch.int32, device=dev)
        return lambda: mt.viterbi(cf_, x, ln)

    f32 = torch.float32
    t46 = median_ms({"dense step f32": dstep32, "dense step f64": dstep64,
                     "dense den f32": dden32, "dense den f64": dden64})
    t46.update(median_ms({
        "2M-arc decode f32": decode(cf, P, 700, f32),
        "2M-arc decode f64": decode(cf64, P, 700, f64),
        "separate-state decode f32": decode(scf, sP, 700, f32),
        "separate-state decode f64": decode(scf64, sP, 700, f64),
        "dense decode f32": decode(dcf, dP, 700, f32),
        "dense decode f64": decode(dcf64, dP, 700, f64)}))
    t46.update(median_ms({
        "2M-arc decode N=1,024 f32": decode(cf, P, 1024, f32),
        "2M-arc decode N=1,024 f64": decode(cf64, P, 1024, f64)}))
    for what in ("dense step", "dense den", "2M-arc decode",
                 "separate-state decode", "dense decode",
                 "2M-arc decode N=1,024"):
        a, b = t46[f"{what} f32"], t46[f"{what} f64"]
        print(f"phase 46: {what} B=128 medians of 5 in turns: float32 "
              f"{a:.2f} ms, float64 {b:.2f} ms (f64/f32 {b / a:.3f})")
    print(f"phase 46: the float64 dense step's launches "
          f"{json.dumps(dstep64_counts)}")
    d64_times = time_dense(dcf64, dP, dev)
    t_mm64 = matmul_yardstick(dcf64, dev)
    t_sp64 = sparse_yardstick(dcf64, dev)
    d64_bounds = dense_bounds(dcf64, 128, 701)
    d64_bounds_vec = dense_bounds(dcf64, 128, 701, f64_tc=False)
    k7_64 = {"2M-arc": time_f64_vit(cf64, P, dev),
             "separate-state": time_f64_vit(scf64, sP, dev)}
    k7_64b = {"2M-arc": vit_bounds(cf64, 128, 701)["K7"],
              "separate-state": vit_bounds(scf64, 128, 701)["K7"]}
    for name in ("K6a", "K6b"):
        print(f"timing: {name} float64 {d64_times[name][0]:.3f} ms (float32 "
              f"{times[name][0]:.3f} ms; twin {d64_times[name][1]:.1f} ms), "
              f"bound {d64_bounds[name][0]:.4f} ms at the FP64 tensor-core "
              f"rate ({d64_bounds[name][1]}), "
              f"{d64_bounds_vec[name][0]:.4f} ms at the non-tensor FP64 "
              f"rate; float64 torch.matmul x701 {t_mm64:.3f} ms, "
              f"torch.sparse.mm x701 {ms_or_not(t_sp64)} ms")
    for name, (t, tp) in k7_64.items():
        print(f"timing: K7 float64 on the {name} graph {t:.3f} ms over 701 "
              f"frames (twin {tp:.1f} ms), bound {k7_64b[name][0]:.3f} ms "
              f"({k7_64b[name][1]})")

    # ---- the log-space scans and the tropical decodes (phases 47-48) ------
    g47 = phase_log_scans(dev)
    t48 = phase_trop_decodes(dev, g47)
    phase_log_kernel_decodes(
        [("2M-arc 'block' graph", fsm, spdf, P, cf,
          dict(strategy="block", precision="high"),
          {"vit_fwd": 1, "vit_walk": 1}),
         ("V=32 'dense' graph", dfsm, dspdf, dP, dcf, {},
          {"dense_trop": 1, "rec_walk": 1})], dev)

    # ---- the card's plain routes, the float64 K6a/K6b (phases 50-51) ----
    t50 = phase_card_routes(dev, (fsm, spdf, P), card)
    phase_dmma(dcf64, dev, d64_errs, {
        "K6a": d64_times["K6a"][0], "K6b": d64_times["K6b"][0],
        "matmul": t_mm64, "sparse": t_sp64, "step": t46["dense step f64"],
        "den": t46["dense den f64"]}, card)
    b52 = phase_block_f64({
        "2M-arc": (cf64, P, f_times, times, f_bounds, bounds),
        "separate-state": (scf64, sP, sf_times, ov_times, sf_bounds,
                           ov_bounds)}, dev, splits, f_steps, card)
    f_errs.update({k: max(f_errs[k], v) for k, v in b52["2M-arc"].items()})
    sf_errs.update({k: max(sf_errs[k], v)
                    for k, v in b52["separate-state"].items()})
    e53 = phase_vit_f64(
        cf64, scf64, P, sP, dev,
        {"2M-arc": vsplit, "separate-state": o_split},
        {"K7": (k7_64["2M-arc"][0], times["K7"][0]),
         "K7 fam.": (k7_64["separate-state"][0], o_times["K7"][0]),
         "K7n": (dec64_times["K7n"][0], b_times2["K7n"][0]),
         "K7n recompute": (dec64_times["K7n recompute"][0],
                           b_times2["K7n recompute"][0])},
        {"K7": (k7_64b["2M-arc"], bounds["K7"]),
         "K7 fam.": (k7_64b["separate-state"], o_bounds["K7"]),
         "K7n": (dec64_bounds["K7n"], b_bounds2["K7n"]),
         "K7n recompute": (dec64_bounds["K7n recompute"],
                           b_bounds2["K7n recompute"])}, t46, card)
    v64_errs.update({k: max(v64_errs[k], v) for k, v in e53.items()})
    e54 = phase_noid_f32(cf, scf, P, sP, dev, card)
    r_errs["K7n"] = max(r_errs["K7n"], e54["K7n"])
    phase_ptxas(_build.PTXAS_LOG)

    # ---- W2 and the walk redesigned, the sliced decode (phase 56) ---------
    # the in-arc records, then the alphas, a gather of 32 scattered values
    w2_trips = {"L2": 1, "device, warp gather (128 warps)": 1}
    # the id, then the tier block and source in shared memory
    walk_trips = {"device, frame stride": 1, "shared": 1}
    phase_walks(
        {"V=32 dense": (dcf, dP), "2M-arc": (cf, P),
         "separate-state": (scf, sP), "V=32 dense f64": (dcf64, dP),
         "2M-arc f64": (cf64, P)}, dev,
        {"W2 (V=32 dense decode)": (d_times["W2"][0], 701, w2_trips),
         "W2 (2M-arc N=1,024: one 64-frame chunk)": (b_times2["W2"][0], 64,
                                                     w2_trips),
         "W2 (separate-state N=1,024: one 64-frame chunk)": (
             o_times2["W2"][0], 64, w2_trips),
         "W2 float64 (V=32 dense decode)": (t64_times["W2"][0], 701,
                                            w2_trips),
         "W2 float64 (2M-arc N=1,024: one 64-frame chunk)": (
             dec64_times["W2 chunk"][0], 64, w2_trips),
         "walk (2M-arc decode)": (times["K7w"][0], 700, walk_trips),
         "walk (separate-state decode, family tables)": (
             o_times["K7w"][0], 700, walk_trips)},
        {"2M-arc N=700 (phase 17)": t_dec,
         "V=32 dense N=700 (phase 32, median of 5)": t_ddec,
         "2M-arc N=1,024 (phase 33, median of 3)": t_bdec,
         "separate-state N=1,024 (phase 37, median of 3)": t_odec,
         **{f"{k} (phase 46, median of 5)": t46[k] for k in (
             "2M-arc decode f32", "dense decode f32",
             "2M-arc decode N=1,024 f32", "2M-arc decode f64",
             "dense decode f64", "2M-arc decode N=1,024 f64")}}, card)

    block_src = "markovmodels_tpu_torch/ops/csrc/block_scan.cu"
    banded_src = "markovmodels_tpu_torch/ops/csrc/banded_scan.cu"
    dense_src = "markovmodels_tpu_torch/ops/csrc/dense_scan.cu"
    vit_src = "markovmodels_tpu_torch/ops/csrc/vit_scan.cu"
    walk_src = "markovmodels_tpu_torch/ops/csrc/rec_walk.cu"
    launches.update({k: v for k, v in dlaunches.items()
                     if k in ds.LAUNCHES})
    launches.update(vlaunches)
    table = {  # name: (counter, source, the TPU kernel it replaces)
        "K2": ("block_fwd", block_src,
               "markovmodels_tpu/ops/pallas_block.py:862"),
        "K3": ("block_recompute", block_src,
               "markovmodels_tpu/ops/pallas_block.py:907"),
        "K4": ("block_bwd", block_src,
               "markovmodels_tpu/ops/pallas_block.py:945"),
        "K5a": ("banded_fwd", banded_src,
                "markovmodels_tpu/ops/pallas_banded.py:180"),
        "K5b": ("banded_bwd", banded_src,
                "markovmodels_tpu/ops/pallas_banded.py:215"),
        "K6a": ("dense_fwd", dense_src,
                "markovmodels_tpu/ops/pallas_scan.py:220"),
        "K6b": ("dense_bwd", dense_src,
                "markovmodels_tpu/ops/pallas_scan.py:269"),
        "K7": ("vit_fwd", vit_src,
               "markovmodels_tpu/ops/pallas_block.py:1387"),
        # the walk replaces XLA code, no Pallas kernel: the line of wstep
        "K7w": ("vit_walk", vit_src, "markovmodels_tpu/viterbi.py:382"),
    }
    library = {"K6a": t_mm, "K6b": t_mm}  # the torch.matmul yardstick
    kernels = [
        {"name": f"{name} {counter}", "route": "cuda", "source": source,
         "replaces": replaces, "launches": launches[counter],
         "max_abs_err": errs[name], "ms": times[name][0],
         "plain_ms": times[name][1], "bound_ms": bounds[name][0],
         "bound_by": bounds[name][1], "library_ms": library.get(name)}
        for name, (counter, source, replaces) in table.items()
    ]
    kernels += [  # the dense step's numerators: P = 96
        {"name": f"{name} {counter} (numerators at P=96, dense step)",
         "route": "cuda", "source": source, "replaces": replaces,
         "launches": dlaunches[counter], "max_abs_err": e96[name],
         "ms": times96[name][0], "plain_ms": times96[name][1],
         "bound_ms": bounds96[name][0], "bound_by": bounds96[name][1],
         "library_ms": None}
        for name, (counter, source, replaces) in table.items()
        if name in times96
    ]
    for tag, (l_, e_, t_, b_) in (  # the wide and global instantiations
            ("wide, ~1,200-state skip-arc numerators, N=700",
             (w_launches, w_errs, w_times, w_bounds)),
            ("cluster, ~1,350-state skip-arc numerators, N=700", g14),
            ("cluster, ~3,000-state skip-arc numerators, N=2,400", g3),
            ("cluster, Sp = 24,576, N=128", g24),
            ("global, Sp = 52,008, G=4, N=64", gpast),
            ("wide, float64, ~1,200-state skip-arc numerators, N=700",
             k5w64),
            ("cluster, float64, ~3,000-state skip-arc numerators, G=8, "
             "N=2,400", k5c64)):
        kernels += [
            {"name": f"{name} {counter} ({tag})", "route": "cuda",
             "source": source, "replaces": replaces, "launches": l_[counter],
             "max_abs_err": e_[name], "ms": t_[name][0],
             "plain_ms": t_[name][1], "bound_ms": b_[name][0],
             "bound_by": b_[name][1], "library_ms": None}
            for name, (counter, source, replaces) in table.items()
            if name in t_
        ]
    kernels += [  # the overflow branch, on the separate-state graph
        {"name": f"{name} {counter} (separate-state backoff graph)",
         "route": "cuda", "source": source, "replaces": replaces,
         "launches": ov_launches[counter], "max_abs_err": ov_errs[name],
         "ms": ov_times[name][0], "plain_ms": ov_times[name][1],
         "bound_ms": ov_bounds[name][0], "bound_by": ov_bounds[name][1],
         "library_ms": None}
        for name, (counter, source, replaces) in table.items()
        if name in ov_times
    ]
    for tag, l16, e16, t16, bd16, lib in (
            ("2M-arc graph", b_launches, b_errs, b_times, b_bounds, {}),
            ("separate-state backoff graph", sb_launches, sb_errs, sb_times,
             sb_bounds, {}),
            ("V=32 dense graph", d_launches, d_errs, d_times, d_bounds,
             {"K6a": t_mm16, "K6b": t_mm16})):
        kernels += [  # the bf16 branches: the tier / product on tensor cores
            {"name": f"{name} {counter} (bf16, {tag})", "route": "cuda",
             "source": source, "replaces": replaces,
             "launches": l16[f"{counter}_bf16"], "max_abs_err": e16[name],
             "ms": t16[name][0], "plain_ms": t16[name][1],
             "bound_ms": bd16[name][0], "bound_by": bd16[name][1],
             "library_ms": lib.get(name)}
            for name, (counter, source, replaces) in table.items()
            if name in t16
        ]
    rec_lines = (  # name, counter, source, replaces, launches, err, (ms,
        # plain ms), bound
        ("K6t dense_trop (V=32 dense decode, 701 frames)", "dense_trop",
         dense_src, "markovmodels_tpu/viterbi.py:129", d_counts,
         max(r_errs["K6t"], d_errs2["K6t"]), d_times["K6t"],
         d_bounds2["K6t"]),
        ("W2 rec_walk (V=32 dense decode, 701 frames)", "rec_walk", walk_src,
         "markovmodels_tpu/viterbi.py:514", d_counts, r_errs["W2"],
         d_times["W2"], d_bounds2["W2"]),
        ("K7n vit_fwd_noid (2M-arc decode at N=1,024: checkpoint sweep, "
         "1,025 frames)", "vit_fwd_noid", vit_src,
         "markovmodels_tpu/viterbi.py:137", b_counts,
         max(r_errs["K7n"], b_errs2["K7n"]), b_times2["K7n"],
         b_bounds2["K7n"]),
        ("K7n vit_fwd_noid (2M-arc decode at N=1,024: one 64-frame "
         "recompute)", "vit_fwd_noid", vit_src,
         "markovmodels_tpu/viterbi.py:137", b_counts,
         max(r_errs["K7n"], b_errs2["K7n"]), b_times2["K7n recompute"],
         b_bounds2["K7n recompute"]),
        ("W2 rec_walk (2M-arc decode at N=1,024: one 64-frame chunk)",
         "rec_walk", walk_src, "markovmodels_tpu/viterbi.py:514", b_counts,
         r_errs["W2"], b_times2["W2"], b_bounds2["W2"]),
    )
    o_err = {k: max(e[k] for e in o_errs if k in e) for k in o_errs[0]}
    rec_lines += (  # the family branch: the separate-state graph's decodes
        ("K7 vit_fwd (family branch: separate-state decode, 701 frames)",
         "vit_fwd", vit_src, "markovmodels_tpu/viterbi.py:338", o_counts,
         o_err["K7"], o_times["K7"], o_bounds["K7"]),
        ("K7w vit_walk (separate-state decode, with the overflow decode "
         "tables)", "vit_walk", vit_src, "markovmodels_tpu/viterbi.py:382",
         o_counts, o_err["K7w"], o_times["K7w"], o_bounds["K7w"]),
        ("K7n vit_fwd_noid (family branch: separate-state decode at N=1,024,"
         " checkpoint sweep, 1,025 frames)", "vit_fwd_noid", vit_src,
         "markovmodels_tpu/viterbi.py:137", o_counts2,
         max(o_err["K7n"], o_errs2["K7n"]), o_times2["K7n"],
         o_bounds2["K7n"]),
        ("K7n vit_fwd_noid (family branch: separate-state decode at N=1,024,"
         " one 64-frame recompute)", "vit_fwd_noid", vit_src,
         "markovmodels_tpu/viterbi.py:137", o_counts2,
         max(o_err["K7n"], o_errs2["K7n"]), o_times2["K7n recompute"],
         o_bounds2["K7n recompute"]),
        ("W2 rec_walk (separate-state decode at N=1,024: one 64-frame "
         "chunk)", "rec_walk", walk_src, "markovmodels_tpu/viterbi.py:514",
         o_counts2, r_errs["W2"], o_times2["W2"], o_bounds2["W2"]),
    )
    kernels += [
        {"name": name, "route": "cuda", "source": source,
         "replaces": replaces, "launches": cnt[counter], "max_abs_err": err,
         "ms": t[0], "plain_ms": t[1], "bound_ms": bd[0], "bound_by": bd[1],
         "library_ms": None}
        for name, counter, source, replaces, cnt, err, t, bd in rec_lines
    ]
    for tag, lch, e64, t64, bd64 in (
            ("2M-arc graph", f_launches["2M-arc"], f_errs, f_times, f_bounds),
            ("separate-state backoff graph", f_launches["separate-state"],
             sf_errs, sf_times, sf_bounds)):
        kernels += [  # the float64 instantiation (phases 38-40)
            {"name": f"{name} {counter} (float64, {tag})", "route": "cuda",
             "source": source, "replaces": replaces,
             "launches": lch[counter], "max_abs_err": e64[name],
             "ms": t64[name][0], "plain_ms": t64[name][1],
             "bound_ms": bd64[name][0], "bound_by": bd64[name][1],
             "library_ms": None}
            for name, (counter, source, replaces) in table.items()
            if name in t64
        ]
    f64_lines = (  # the float64 'dense' scan and decode (phases 42-46)
        ("K6a dense_fwd (float64, V=32 dense step)", "dense_fwd_f64",
         dense_src, "markovmodels_tpu/ops/pallas_scan.py:220",
         dstep64_counts, d64_errs["K6a"], d64_times["K6a"],
         d64_bounds["K6a"], t_mm64),
        ("K6b dense_bwd (float64, V=32 dense step)", "dense_bwd_f64",
         dense_src, "markovmodels_tpu/ops/pallas_scan.py:269",
         dstep64_counts, d64_errs["K6b"], d64_times["K6b"],
         d64_bounds["K6b"], t_mm64),
        ("K6t dense_trop (float64, V=32 dense decode, 701 frames)",
         "dense_trop_f64", dense_src, "markovmodels_tpu/viterbi.py:129",
         dec64_counts["V=32 dense"], t64_errs["K6t"], t64_times["K6t"],
         t64_bounds["K6t"], None),
        ("W2 rec_walk (float64, V=32 dense decode, 701 frames)",
         "rec_walk_f64", walk_src, "markovmodels_tpu/viterbi.py:514",
         dec64_counts["V=32 dense"], t64_errs["W2"], t64_times["W2"],
         t64_bounds["W2"], None),
        ("K7 vit_fwd (float64, 2M-arc decode, 701 frames)", "vit_fwd_f64",
         vit_src, "markovmodels_tpu/ops/pallas_block.py:1387",
         dec64_counts["2M-arc"], v64_errs["K7"], k7_64["2M-arc"],
         k7_64b["2M-arc"], None),
        ("K7 vit_fwd (float64, family branch: separate-state decode, 701 "
         "frames)", "vit_fwd_f64", vit_src,
         "markovmodels_tpu/viterbi.py:338", dec64_counts["separate-state"],
         v64_errs["K7"], k7_64["separate-state"], k7_64b["separate-state"],
         None),
        ("K7n vit_fwd_noid (float64, 2M-arc decode at N=1,024: checkpoint "
         "sweep, 1,025 frames)", "vit_fwd_noid_f64", vit_src,
         "markovmodels_tpu/viterbi.py:137", dec64_counts["2M-arc N=1,024"],
         v64_errs["K7n"], dec64_times["K7n"], dec64_bounds["K7n"], None),
        ("K7n vit_fwd_noid (float64, 2M-arc decode at N=1,024: one 64-frame "
         "recompute)", "vit_fwd_noid_f64", vit_src,
         "markovmodels_tpu/viterbi.py:137", dec64_counts["2M-arc N=1,024"],
         v64_errs["K7n"], dec64_times["K7n recompute"],
         dec64_bounds["K7n recompute"], None),
        ("W2 rec_walk (float64, 2M-arc decode at N=1,024: one 64-frame "
         "chunk)", "rec_walk_f64", walk_src,
         "markovmodels_tpu/viterbi.py:514", dec64_counts["2M-arc N=1,024"],
         v64_errs["W2"], dec64_times["W2 chunk"], dec64_bounds["W2"], None),
    )
    kernels += [
        {"name": name, "route": "cuda", "source": source,
         "replaces": replaces, "launches": cnt[counter], "max_abs_err": err,
         "ms": t[0], "plain_ms": t[1], "bound_ms": bd[0], "bound_by": bd[1],
         "library_ms": lib}
        for name, counter, source, replaces, cnt, err, t, bd, lib in f64_lines
    ]
    kernels += [  # K5's float64 instantiation (phases 40-41)
        {"name": f"{name} {counter} (float64 numerators)", "route": "cuda",
         "source": source, "replaces": replaces,
         "launches": f_launches["2M-arc"][counter],
         "max_abs_err": k5_errs[name], "ms": k5_times[name][0],
         "plain_ms": k5_times[name][1], "bound_ms": k5_bounds[name][0],
         "bound_by": k5_bounds[name][1], "library_ms": None}
        for name, (counter, source, replaces) in table.items()
        if name in k5_times
    ]
    print(f"card: {card}; pdfposteriors B=128 N=700 kernel path "
          f"{t_kern:.2f} ms, plain path {t_plain:.2f} ms; LF-MMI step "
          f"{t_step:.2f} ms, den-only {t_den:.2f} ms; with the ~1,200-state "
          f"numerators (K5 wide) {t_big:.2f} ms, with the ~3,000-state ones "
          f"at N=2,400 (K5 cluster) {t_big3:.2f} ms; dense-den LF-MMI "
          f"step "
          f"{t_dstep:.2f} ms, dense den-only {t_dden:.2f} ms; viterbi "
          f"B=128 N=700 {t_dec:.2f} ms; dense viterbi B=128 N=700 "
          f"{t_ddec:.2f} ms; 2M-arc viterbi B=128 N=1,024 (chunk-recompute) "
          f"{t_bdec:.2f} ms; separate-state viterbi B=128 N=700 "
          f"{o_med['separate']:.2f} ms (embedded layout "
          f"{o_med['embedded']:.2f} ms), N=1,024 (chunk-recompute) "
          f"{t_odec:.2f} ms; K6 matmul yardstick {t_mm:.2f} ms; "
          f"separate-state LF-MMI step {t_ostep:.2f} ms, den-only "
          f"{t_oden:.2f} ms, embedded den-only {t_emb:.2f} ms; bf16 (f32) "
          f"medians: " + "; ".join(f"{k} {b:.2f} ({a:.2f}) ms"
                                   for k, (a, b) in paths16.items())
          + f"; K6 bf16 yardstick {t_mm16:.2f} ms; float64 medians (f32): "
          + "; ".join(f"{k} step {v['f64 step']:.2f} ({v['f32 step']:.2f}) "
                      f"ms, den-only {v['f64 den']:.2f} ({v['f32 den']:.2f}) "
                      f"ms" for k, v in f_steps.items())
          + "; float64 (float32) medians: " + "; ".join(
              f"{k} {t46[k + ' f64']:.2f} ({t46[k + ' f32']:.2f}) ms"
              for k in ("dense step", "dense den", "2M-arc decode",
                        "separate-state decode", "dense decode",
                        "2M-arc decode N=1,024"))
          + "; log-space (no kernel): " + "; ".join(
              f"{k} {v:.2f} ms" for k, v in {**g47["times"], **t48}.items())
          + f"; plain routes on the card: 2M-arc at ov_cap=64 den-only "
          f"{t50['den']:.1f} ms, viterbi (B={t50['B']}) {t50['decode']:.1f} "
          f"ms; per frame, whole / "
          f"without work: " + "; ".join(
              f"{k} {name} {v['whole']:.2f} / {v['without work']:.2f} us"
              for k, sp in splits.items() for name, v in sp.items()))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
