"""Drive the PyTorch port of the solver end to end on one NVIDIA GPU.

    python3 chip_smoke.py [--profile PATH]

Phases (any failure raises and the script exits nonzero):

  1. device: requires CUDA and prints the card's name and power limit;
  2. build: compiles the CUDA C++ kernels (nvcc, one process per source)
     and, in ``WARM_WORKERS`` processes beside it, every Triton
     specialisation the later phases launch (``warm_steps``: the static
     forms, and the deep and tensor-core forms of the deep-history
     phases), then launches each from the shared cache, and prints the
     seconds;
  3. kernels: K1-K4 and OWL-QN's K8 (both forms), K10, K13 and K14
     against their plain torch versions on the card at n = 2^24 and at a
     ragged even n, for f32 vectors with a bf16 and an f32 history and for
     f64 with f64, the OWL-QN kernels with the window [0, n - 1) and with
     one whose ends are off the blocks' boundaries (K4's and K14's ring
     writes bit for bit, K8's two forms bit for bit against each other),
     and each kernel's time at n = 2^24 beside its plain version's (device
     time from torch.profiler, a session that saw nothing on the card run
     again and, after three such, CUDA events behind a spin kernel; the
     event times of every kernel are printed beside the profiler's); R,
     the second stage of every kernel's partials (``csrc/partials.cu``),
     at the paths' row counts and widths in float32, float64 and the wide
     form: bit for bit its order twin in torch ops, within the sum
     tolerance of a float64 sum, a column's bits alike at every width, in
     a batch and through a strided view, and timed beside torch's sum;
     every path's launch counts show R ran;
  4. goldens: the n = 100 float64 Rosenbrock runs through the kernels
     (35 iterations at the defaults; the recorded 2018 trajectory,
     38 iterations, without the step cap), through ``lbfgs().minimize``
     and through ``minimize_jit``;
  5. OWL-QN golden: from that L-BFGS solution, OWL-QN with c = 1 on
     [0, 99) without the step cap, through both entry points and the
     kernels (the recorded fx 43.50249999999999, x[0] 0.25, x[1] 0.0575);
  6. main path: n = 2^24 Rosenbrock, f32, m = 6, bf16 history,
     More-Thuente, uncapped step, epsilon 0, 100 iterations of
     ``minimize_jit``, with the kernel launch counts checked (K1 once, K4
     and the combine+probe fusion K15 per iteration, K2 per probe that
     K15 did not carry in); then ``minimize_jit`` through the plain
     versions on the card against the kernels, after 8 and after 15
     iterations;
  7. OWL-QN main path: n = 2^24, f32, m = 6, bf16 history, c = 1 on
     [0, n - 1), BacktrackingArmijo, uncapped step, time to epsilon 3e-2
     within 300 iterations of ``minimize_jit`` (K1 and K10 once, K14 and
     K16 per iteration, K8 per probe not carried in), with the launch
     counts checked (no plain version and no plain stand-in runs); then
     the plain versions against the kernels after 8 and 15 iterations;
  8. north star: n = 1e8, m = 3, time to epsilon 3e-2;
  9. damped f64 n = 100: Powell damping, with ``damping_fixed``, and
     damped OWL-QN (c = 1 on [0, 99)), 50 iterations each through
     ``minimize`` with a progress callback (the capped step: K6, K13),
     per iteration against the same runs on the CPU, and against the JAX
     package's recorded runs (``DAMPED_N100``); damping case 1 and case 2
     must fire;
 10. LJ38: the reference's 38-atom cluster in f64 on the card, default
     L-BFGS to the relaxed energy, and ``with_gradient_only()`` for 50
     iterations per iteration against the CPU (the composed damped
     branch and K3);
 11. damped main path: the plain main path with ``damping=True`` (K1, K2
     per probe not carried in, K4 with its . gp column and K15's form
     that persists the damped row per iteration), then through the plain
     versions against the kernels after 8 and 15 iterations;
 12. gradient-only main path: the same size with
     ``with_gradient_only()``, 50 iterations;
 13. damped OWL-QN main path: the OWL-QN main path with ``damping=True``
     (K8 per probe not carried in, K14 with its . gp columns and K16 per
     iteration);
 14. K5 route: a Rosenbrock that has the trial and probe kernels but no
     one-pass epilogue, damped, 10 iterations at n = 2^24 (K1 per
     materialized trial, K2, K5 with the . gp column and K6);
 15. K12 route: the same objective under damped OWL-QN, 10 iterations
     (K1 and K10 at the start, K7 per accepted point, K8 per probe, K10,
     K12 with the . gp column and K13 per iteration), against the K14
     route after 8 iterations;
 16. Poisson main path: the L1 Poisson regression at the JAX package's
     at-scale width (2048 x 2^20, X float32, seed 0), c = 1 on [1, n),
     m = 6, bf16 history, BacktrackingArmijo, epsilon 0, 100 iterations
     of ``minimize_jit`` through the composed OWL-QN branch (K11 once, K9
     per trial point, K10, K12 and K13 per iteration), then the same with
     ``with_fx_wide()``, and one profiled run (device ms per iteration and
     per evaluation); then all of it again with X in bfloat16 (the JAX
     package's accelerator cell; the float32 X freed first), and its two
     products (``torch.mm`` with a float32 output) at beta0 and at the
     final beta against the widened product (normwise 1e-4) and timed
     beside their bound;
 16b. batched Poisson (with the float32 X of phase 16, freed after it):
     ``minimize_batched`` on the Poisson regression at that width, B = 16
     (beta0 = 0 and 15 seeded N(0, 1e-3) offsets), phase 16's settings, 20
     iterations through the generic batched route (K11 b once, K9 b per
     trip, K10 b, K12 b and K13 b per iteration; the products with X one
     GEMM each under the vmap): device and wall ms per iteration,
     evaluations per iteration, instance-iterations/s; instance 0 against
     the solo run after 8 iterations;
 17. Poisson f64: 500 x 21 float64 (the reference's shape), c = 1 on
     [1, 21), epsilon 1e-4, through ``minimize`` per iteration against
     the same run on the CPU;
 18. f32 floor: the 512 x 64 Poisson pair of runs, float32 and wide,
     through the step-at-a-time loop, their statuses recorded;
 19. wide OWL-QN main path: the OWL-QN main path with ``with_fx_wide()``
     (K7 once at the start, then K8, K14, K16): 12 iterations against the
     default run, then the run to epsilon 3e-2;
 20. OWL-QN north star: n = 1e8, m = 3, c = 1 on [0, n - 1), epsilon
     3e-2, within 300 iterations, wide and then default;
 21. unfused main path: the main path on an objective without the
     combine+probe fusion's hooks, so K3 runs in place of K15 and K2 on
     every probe; its syncs and probes per iteration beside the main
     path's (the fusion must save at least half a read per iteration);
     the main path against it and against its plain versions after 8
     and 15 iterations; ms/iter of both in turns; then both stepped side
     by side, printing for how many iterations they agree bit for bit
     and in their evaluations;
 22. unfused OWL-QN main path: the same for the OWL-QN main path, K13 in
     place of K16, CONVERGED at epsilon 3e-2;
 23. adaptive entry: the OWL-QN main path with
     ``with_adaptive_entry_step(2.0)``, with and without the fusion, each
     CONVERGED, evaluations beside the literal run's;
 24. unfused damped main path: 30 iterations with K6 in place of K15's
     damped-row form, and the same trajectory checks;
 25. quadratic main path: bench.py's quadratic row, the weighted
     quadratic ``separable.quadratic(w, t)`` with its two extras (w = 0.5
     + U[0, 1), t = N(0, 1)) at n = 2^24, f32, m = 6, bf16 history,
     More-Thuente, uncapped step, x0 = 0, epsilon 1e-4 (K1 once, K4 and
     K15 per iteration, K2 per probe not carried in, all with the
     extras); x held to t, device busy per iteration, and the run against
     the plain twin after 8 iterations;
 26. lasso main path: OWL-QN on the same objective, c = 0.3 on [0, n),
     BacktrackingArmijo, epsilon 1e-4 (K1, K10, K14, K16 and K8 with the
     extras); x held to the soft-threshold oracle;
 27. lasso variants: the lasso damped (K14's . gp form with the extras)
     and with ``with_fx_wide()`` (K7 with the extras at the start), each
     held to the oracle;
 28. damped quartic main path: ``separable.scaled_quartic(w)`` with
     damping (K4 with the . gp column and K15's damped-row form with one
     extra) to fx < 1e-8 and max |x| < 1e-3, and against the plain twin
     after 8 iterations;
 29. deep history: m = 80 ring rows at n = 2^20 on Rosenbrock, plain,
     damped, OWL-QN and damped OWL-QN, each through the deep forms of the
     Triton epilogues and fusions (above ``factory.MAX_M`` rows: K1 once,
     K4 and K15, K14 and K16 under OWL-QN, per iteration, the . gp forms
     and K15-fix when damped) and through the any-depth route (an
     objective without their hooks: K1, K5 or K12, K3, K6 or K13), with
     the launches checked, device and wall ms and syncs per iteration in
     turns, and each against its plain versions after 8 iterations; then
     the deep forms of K4, K14 (each with and without the . gp column),
     K15 (and its damped row) and K16 at m = 65, 80 and 130 and K3, K5,
     K6, K12 (both forms) and K13 at m = 80 against their plain versions
     in the three dtype pairs (ring rows bit for bit; the deep epilogues'
     x, g, pg, objective and changed bit for bit the static launch's at
     m = 6, the . gp columns 0-2 the 3-column launch's, an in-place launch
     the launch into fresh vectors; K15's r and probe K3's and K2's,
     K15-fix's r and row K6's, K16's rc and probe K13's and K8's), the
     deep epilogues bit for bit the static ones at m = 19, every deep
     form's registers and spills (``deep_compiled``: a spill fails), and
     each ``_m80`` kernel timed; over f32 and f64 rings K4 and K14 take
     their tensor-core row-block form at these depths (held the same way,
     and their deep fold forms too at m = 80), and at the ``FOLD_ROWS``
     rows (f32 and f64 rings at m = 80, a bf16 ring at m = 260) the
     row-block form is held to its plain version and to the fold form on
     the same inputs and timed;
 29c. solo tensor-core kernels (``solo_mma_kernels``): the one-pass
     form's products against the float64 product of their operands at m =
     19, 80 and 200, the row-block form's at the ``FOLD_ROWS`` rows with 2,
     32 and 64 chunks a program (1e-6 normwise with f32 vectors, 1e-12 with
     f64), the matrix instructions each row-block kernel compiled to, and
     every solo tensor-core kernel's registers (a spill fails);
 29d. deep fold paths: the ``FOLD_ROWS`` rows through the plain and
     OWL-QN deep-history settings, 10 iterations, every K4 and K14 launch
     in the row-block form, fx finite;
 29b. deep main path: the main path's settings at m = 80 (n = 2^24, two
     bf16 rings of 2.7 GB), epsilon 0, 40 iterations, through the deep
     forms (K1 once, K4 and K15 per iteration, K2 per probe K15 did not
     carry in) and through the any-depth route, reported as phase 29's
     runs;
 30. booth: the reference's two-variable test on the card, to (1, 3);
 31. scan two-loop: ``with_compact_two_loop(False)``, the recorded n = 100
     float64 golden uncapped through both entry points (38 iterations),
     then the main path's widths at epsilon 0 within 100 iterations and
     against its plain versions after 8 (K1 per accepted point, K2 per
     probe, nothing that reads the ring);
 32. float16 history: the main path's widths with a float16 ring to
     epsilon 1e-5 within 100 iterations (the composed pair + Gram pass
     and combine in torch ops, K1 and K2), its plain-call counts printed,
     and against its plain versions after 8;
 33. native: the recorded L-BFGS and OWL-QN goldens through
     ``backend="native"`` (38 and 172 iterations) and
     ``minimize_native_rosenbrock`` at n = 2^24 for 10 iterations, its
     seconds printed;
 34. checkpoint: the main path at n = 2^20 through ``LbfgsState``, saved
     at iteration 10, resumed into a fresh state for 10 more, every field
     bit for bit the uninterrupted run's;
 35. batched kernels: the batched runner's K2 b, K4 b and
     K3 b against their plain versions at B = 1024 instances of n = 2^14,
     m = 6, f32 vectors, bf16 rings, a third of the instances frozen (the
     ring rows and the frozen instances bit for bit), instances 0, 511 and
     1023 against the solo K2, K4 and K3 on that instance alone (x, g, the
     rings and r bit for bit), and each timed beside its plain version;
 36. batched main path: ``minimize_batched`` on bench_batched.py's
     configuration at B x n = 1024 x 2^14 (2^24 elements, the main path's
     bytes), m = 6, bf16 ring, More-Thuente, capped step, epsilon 0, 30
     iterations (K2 b per search trip, K4 b and K3 b per iteration, nothing
     else), every fx finite, instance-iterations/s, device ms, syncs and
     host launch calls per iteration beside the solo main path's device ms
     per iteration; then instances 0-7 solo through ``minimize_jit``
     against the batch after 8 iterations (same k and evaluations, fx rel
     1e-3);
 37. batched baseline: BASELINE.md's batch regime, B = 10,000 x n = 64,
     30 iterations at lbfgs()'s defaults, epsilon 0, instance-iterations/s;
 38. batched OWL-QN kernels: K8 b (the pg form), K14 b, K13 b and
     K10 b against their plain versions at the batched kernels' shapes
     (B = 1024 x n = 2^14, m = 6, f32 vectors, bf16 rings, a third of the
     instances frozen) on the window [0, n - 1) and one off every tile
     edge (ring rows and frozen instances bit for bit), instances 0, 511
     and 1023 against the solo K8, K14, K13 and K10 on that instance alone
     (x, g, pg, the rings, rc and K10's pg bit for bit), each timed beside
     its plain version;
 39. batched OWL-QN main path: ``minimize_batched`` at the batched main
     path's widths and starts with c = 1 on [0, n - 1), BacktrackingArmijo,
     capped step, epsilon 0, 30 iterations (K10 b once, K8 b per search
     trip, K14 b and K13 b per iteration, nothing else), every fx finite,
     its instance-iterations/s, device ms, syncs and host launch calls per
     iteration beside the batched main path's; then instances 0-7 solo
     through ``minimize_jit`` against the batch after 8 iterations;
 40. batched fusion kernels: K15 b and K16 b (the batched combine+probe
     fusions) at m = 6 and their M = 0 forms at m = 80, and K4 b and K14 b
     at m = 6, 19 and 80 (the static form at 6, the tensor-core form at 19
     and 80; each launch's form, geometry and registers printed), against
     their plain versions at B = 1024 x n = 2^14 (f32 vectors, bf16 rings,
     a third of the instances frozen, the OWL-QN forms on a window off
     every block edge; ring rows and frozen instances bit for bit),
     instances 0, 511 and 1023 against the solo K15, K16 (r, rc, the sums
     and the probes bit for bit) and the solo K4 and K14 (x, g, pg and the
     rings bit for bit; the products' gap printed), each timed beside its
     plain version, and every compiled batched form's registers (a spill
     fails);
 41. batched uncapped main paths: the batched main path with the step
     uncapped, literal and with the adaptive entry step (growth 2), and the
     batched OWL-QN main path uncapped (K2 b / K8 b per probe not carried
     in, K4 b / K14 b and K15 b / K16 b per iteration), each in turns with
     the same run on the objective without the fusions' hooks (K3 b / K13
     b, a probe every trip): every search after an instance's first
     carries its first trip, the fused run makes at least 0.5 fewer syncs
     per iteration, every fx finite; instance-iterations/s, device ms,
     syncs and host launch calls per iteration of both; then instances 0-7
     solo against the batch after 8 iterations;
 42. batched deep: the batched uncapped paths at m = 80 (plain and
     OWL-QN; two bf16 rings of 2.7 GB), 30 iterations: K4 b (K14 b) in its
     tensor-core form and the M = 0 K15 b (K16 b) per iteration;
 42b. batched damped kernels: K4 b and K14 b with their . gp columns at m =
     6, 19 and 80, K6 b (the capped combine with the damped row) and K15 b's
     fix form at m = 6 and in their deep forms at m = 80 (K15 b fix with M =
     0), and K3 b and
     K13 b at m = 80, against their plain versions at 1024 x 2^14 (f32, bf16
     rings, a third of the instances frozen; ring rows, damped rows and
     frozen instances bit for bit, the . gp launches' columns 0-2 the
     3-column launches'), instances 0, 511 and 1023 against the solo
     kernels bit for bit (x, g, pg, rings, r, rc, damped rows; K15 b fix's
     sums and probe), each timed beside its plain version, every compiled
     batched form's registers (a spill fails);
 42c. batched damped main paths: ``minimize_batched`` at 1024 x 2^14, 30
     iterations, damped capped (K6 b) and uncapped (K15 b fix), gradient-only
     and damped OWL-QN capped (K13 b and the row blend) and uncapped (K16 b),
     each epilogue with its . gp column: the launches, no plain version,
     reads per iteration outside the searches no more than the undamped
     path's; then instances 0-7 solo against the batch after 8 iterations;
 42d. batched m = 80: the capped batched plain and OWL-QN runs at m = 80
     (K3 b and K13 b with their coefficients sized at launch) and the
     damped capped, uncapped and OWL-QN runs there, 10 iterations each;
 42e. batched generic kernels: K9 b, K11 b and K12 b (m = 6 and 80) in the
     three dtype pairs at 1024 x 2^14 (m = 80 with float64 at 512 x 2^14)
     against their plain versions, the points, pg and ring rows of
     instances 0, B/2 - 1 and B - 1 bit for bit the solo K9's, K11's and
     K12's (K12 b's sums within the sum tolerance), K12 b's registers (a
     spill fails), each timed at f32/bf16 beside its plain version;
 42f. batched generic main paths: ``minimize_batched`` on a hook-free
     Rosenbrock at 1024 x 2^14, f32, bf16 ring, 20 iterations, capped,
     uncapped and damped capped (More-Thuente: K3 b per iteration and no
     other kernel) and under OWL-QN (c = 1 on [0, n - 1), Armijo: K11 b
     once, K9 b per trip, K10 b, K12 b undamped and K13 b per iteration;
     and 5 iterations at m = 80); instances 0-7 solo against each batch
     after 8 iterations;
 42g. batched trial kernels: K1 b, K7 b and K5 b (with and without its
     . gp column) in f32/bf16 and f64 at 1024 x 2^14 against their plain
     versions (K1 b and K7 b in both modes of the objective scalar), the
     points, gradients and ring rows of instances 0, 511 and 1023 bit for
     bit the solo K1's, K7's and K5's, K1 b's and K7 b's (f, g.d) bit for
     bit K2 b's and K8 b's, K5 b's . gp columns 0-2 its 3-column launch's;
     K1 b and K7 b with the quadratic's two extras at n = 2^14 + 2; their
     registers (a spill fails), each timed at f32/bf16;
 42h. batched settings: ``minimize_batched`` at 1024 x 2^14, 20
     iterations, under the wide scalar (plain capped and uncapped, OWL-QN,
     damped: fx float64, the init one K1 b, under OWL-QN K7 b and K10 b),
     with the scan two-loop and over a float16 ring (plain and OWL-QN: one
     K1 b or K7 b per iteration and no ring kernel), and on the trial-only
     objective (plain: K1 b, K5 b, K3 b; damped: K5 b's . gp form, K6 b;
     OWL-QN: K7 b, K10 b, K12 b, K13 b; damped OWL-QN without K12 b);
     instances 0-7 solo against each batch after 8 iterations;
 42i. batched tensor-core rules (``batched_mma_rules``, after the batched
     fusion kernels): K4 b and K14 b with their . gp columns at m = 19 and
     80, at 1024 x 2^14, 1024 x (2^14 + 2) and 4 x 2^24: the tensor-core
     form at an n that is a multiple of 16 (at most 64 chunks a program,
     the products within 3e-7 normwise of the float64 product of their own
     operands), the deep fold form at 2^14 + 2, no spill;
 42j. batched fold kernels (``batched_fold_kernels``, after the batched
     tensor-core rules): K4 b and K14 b with and without their . gp
     columns at the ``FOLD_ROWS`` settings (f32 and f64 rings at m = 80, a
     bf16 ring at m = 260), which the deep fold form took until the row-block
     form did, in the tensor-core row-block form (``"mma_rows"``) on the batch-wide grid:
     against their plain versions and the deep fold form on the same
     inputs (x, g, pg, the rings and the frozen instances bit for bit, the
     sums within the sum tolerance) on 512 (f32, bf16) and 256 (f64)
     instances of 2^14, three instances against the solo K4 and K14 bit
     for bit, the products within ``BATCHED_ROWS_GAP`` of the float64
     product of their own operands at 2, 32 and 64 chunks a program; then
     each timed at 1024 x 2^14 beside its plain version and in turns
     against the deep fold form, with its bound; every compiled batched
     form's registers (a spill fails);
 42k. batched fold paths (``batched_fold_paths``, after the batched m = 80
     runs): ``minimize_batched`` at 1024 x 2^14 at each ``FOLD_ROWS``
     setting, plain and OWL-QN (uncapped, epsilon 0), 10 iterations: every
     K4 b (K14 b) launch in the row-block form, every fx finite; instances
     0-7 solo against the batch after 8 iterations;
 43. sharded world size 1: an NCCL group of one rank in this process
     (``lbfgs_torch.parallel``), the main path and the OWL-QN main path at
     n = 2^24 under ``kernels_on_mesh``, each against the same run with no
     mesh: iterations, evaluations, fx and x bit for bit, the same
     launches, no plain version; collectives and ms per iteration of both
     (eight runs in turns), the all-reduce ms per iteration, and where
     one all-reduce of a launch's scalars spends its time (timed pieces
     and torch.profiler traces); then the generic objectives under the
     local contract (the generic Rosenbrock at 2^24 capped, 40 iterations,
     and damped, 20; the Poisson regression at 2048 x 2^20 under OWL-QN, 20
     iterations), each bit for bit its run with no mesh, the collectives
     the CPU tests' formula;
 44. sharded two ranks: two spawned gloo ranks sharing cuda:0 (this script
     with ``--sharded-rank``), n = 2^24 in all, the main, OWL-QN and damped
     main paths: both ranks bit for bit alike (iterations, evaluations,
     fx, the gathered x), K1, K2 (K8), K4 (K14) and K15 (K16) launched on
     the card and no plain version, no vector gathered inside a run; on
     each rank every mesh form those paths launch (and the quadratic's
     whole extras, a body reading the global index) held to the
     single-process launch, vectors and ring rows bit for bit; the main
     path's iterations and every path's fx against the solo phases, the
     first 8 iterations in float64 the solo run's steps; collectives, ms
     and all-reduce ms per iteration; the mesh forms' checks also at m = 80
     (the deep K4, K14, K15 and K16, n = 2^20); the mesh forms of K3, K6,
     K9, K11, K12 (+-gp, also at m = 80) and K13; the generic objectives
     (the Poisson regression on each rank's 2048 x 2^19 column block), the
     ranks alike, fx against the world-size-1 phase's solo runs, the first
     8 iterations in float64 the solo run's steps; and a checkpoint of the
     main path at n = 2^22 saved by both ranks at iteration 10 and resumed
     here with no mesh, from the sharded files and from the gathered state,
     bit for bit alike and ending as the solo run;
 44b. examples: the port's six example scripts on the card at their
     default sizes (``examples/*_torch.py``; the sharded one in a
     subprocess at world size 1 over NCCL), each launching its kernels,
     calling no plain version and ending as its JAX script says;
 44c. the speculative K-way search (``with_speculative_linesearch``, K =
     ``SPEC_K`` = 4): ``speculative_kernels`` holds K2 s and K8 s at 2,
     4, 8 and 11 lanes (above
     ``factory.SPEC_MAX_LANES`` in chunks) at n = 2^24 and 2^14 + 2, in
     f64 and with the quadratic's extras, each lane bit for bit K2's and
     K8's at its step (at 2^24 in both scalar modes) and within the sum
     tolerance of the plain versions, and K2 b s and K8 b s at 1024 x
     2^14 bit for bit K2 b's and K8 b's per lane on the live instances;
     registers (a spill fails), times beside the bounds, every lane count
     against that many one-lane launches; ``speculative_main_path`` and
     ``speculative_owlqn_main_path`` at n = 2^24 in turns with the
     sequential run on the same route (the objective without K4 / K14:
     bit for bit) and with the sequential main path (the same status),
     launches, reads, logical and physical evaluations per iteration;
     ``speculative_poisson`` (run after the Poisson main path, on its
     X: vmapped candidates, two GEMMs a round; in turns with the
     sequential run, its iterations and fx rel 1e-6); ``batched_speculative`` at 1024 x 2^14,
     plain and OWL-QN, in turns with the sequential runs (bit for bit on
     the same route), instances 0-7 against their solo speculative runs;
     ``sharded_speculative_world1``: both main paths on an NCCL mesh of
     one rank, bit for bit the solo runs;
 45. launch_overhead: microseconds per back-to-back launch of the
     calibration kernel (``csrc/calibrate.cu``) and per launch with one
     synchronising read, and the share of each main path's ms/iter that
     its launches and reads per iteration explain;
 46. with ``--profile PATH`` only: one run of each main path (plain,
     OWL-QN, damped, damped OWL-QN, Poisson, and the first three without
     the fusion) under torch.profiler (device busy time against the
     unprofiled walls, device items, host launch and copy calls); the
     operator tables go to PATH.

Phase 3 also holds K15 (with its damped-row form), K16 (the
combine+probe fusions), K17 (axpy + dot) and the calibration kernel to
their plain versions (K15's and K16's probe scalars bit for bit those of
K2 and of K8's pg form at the point they form, in both objective-scalar
modes; their directions bit for bit K3's, K6's and K13's, so the step
cap, which picks one or the other, does not change the trajectory; the
damped row bit for bit K6's), prints each K4/K14 form's registers,
spills and 16-byte loads (``epilogue_compiled``: a form that spills
fails), holds the OWL-QN kernels K7, K9, K11 and K12 to their plain
versions (K9's point, K11's pg against K10's, K12's ring rows and K7's
ft against K8's bit for bit; K12 also at m = 1, 3, 6 and 12 and on
misaligned operands), prints ``pair_gram_compiled`` (registers and
spills of every K5 and K12 instantiation: a spill fails), and a
``wide_kernels`` phase checks the
wide objective scalar's forms of K1, K2, K4, K7 and K8 against the
default launches and against a float64 sum on the host.  Phase 3 also
holds every factory kernel with the quadratic's two extras (``_ex``
rows) to its plain version at both sizes with the same bitwise checks,
times each, and prints the registers of every K4/K14 form with 0, 1 and
2 extras; the deep-history phase adds the ``_m80`` rows (the deep forms
and the any-depth kernels at m = 80).

Prints one JSON line per phase result, the kernel table as one JSON line
before the last, and ``{"ok": true, "device": {...}}`` as the last line.
"""

from __future__ import annotations

import argparse
import contextlib
import datetime
import importlib
import io
import json
import os
import re
import shutil
import subprocess
import sys
import time
from contextlib import nullcontext
from types import SimpleNamespace

import numpy as np
import torch
import torch.distributed as dist

from lbfgs_torch import LbfgsError, default_evaluate, lbfgs
from lbfgs_torch.batched import minimize_batched
from lbfgs_torch.core import as_ring, is_ring, ring_stride, ring_zeros, to_host
from lbfgs_torch.linesearch import carried
from lbfgs_torch.minimize import LbfgsState, minimize_jit
from lbfgs_torch.models import booth, lennard_jones, logistic, rosenbrock, separable
from lbfgs_torch.native import minimize_native_rosenbrock
from lbfgs_torch.ops import _build, factory, fused
from lbfgs_torch.orthantwise import Orthantwise, choose_orthant
from lbfgs_torch.parallel import (gather_state, gather_vector, init_distributed,
                                  kernels_on_mesh, make_mesh, shard_vector)
from lbfgs_torch.params import Lbfgs, LbfgsParams, LineSearchAlgorithm
from lbfgs_torch.status import Status
from lbfgs_torch.utils import profiling
from lbfgs_torch.utils.checkpoint import fields, load_state, save_state

SEED = 20261016
N_BIG = 1 << 24
N_RAGGED = 3_000_002          # even, not a multiple of any kernel block
M = 6
STP, END = 0.37, 2
#: normwise tolerances (max |kernel - plain| / max |plain|): the kernels
#: sum in another order and may fuse a multiply-add, so f32 agrees to a
#: few ulps per element and to ~1e-6 on sums of 2^24 terms.  K4's ring
#: write has no tolerance: it is checked bit for bit (``check_ring``)
TOL = {
    (torch.float32, "vec"): 1e-5, (torch.float32, "sum"): 1e-4,
    (torch.float64, "vec"): 1e-12, (torch.float64, "sum"): 1e-10,
}
KERNELS = {
    "K1_trial": ("triton", "lbfgs_torch/ops/_factory_triton.py",
                 "lbfgs_tpu/ops/factory.py:161"),
    "K2_probe": ("triton", "lbfgs_torch/ops/_factory_triton.py",
                 "lbfgs_tpu/ops/factory.py:280"),
    "K3_combine": ("cuda", "lbfgs_torch/csrc/combine.cu",
                   "lbfgs_tpu/ops/fused.py:1359"),
    "K4_trial_pair_gram": ("triton", "lbfgs_torch/ops/_factory_triton.py",
                           "lbfgs_tpu/ops/factory.py:722"),
    "K4_trial_pair_gram_gp": ("triton", "lbfgs_torch/ops/_factory_triton.py",
                              "lbfgs_tpu/ops/factory.py:722 (with_gp)"),
    "K5_pair_gram": ("cuda", "lbfgs_torch/csrc/pair_gram.cu",
                     "lbfgs_tpu/ops/fused.py:837"),
    "K6_combine_fix": ("cuda", "lbfgs_torch/csrc/combine.cu",
                       "lbfgs_tpu/ops/fused.py:1216"),
    "K7_owlqn_trial": ("triton", "lbfgs_torch/ops/_factory_triton.py",
                       "lbfgs_tpu/ops/factory.py:389"),
    "K8_owlqn_probe": ("triton", "lbfgs_torch/ops/_factory_triton.py",
                       "lbfgs_tpu/ops/factory.py:487"),
    "K9_owlqn_trial_step": ("cuda", "lbfgs_torch/csrc/owlqn.cu",
                            "lbfgs_tpu/ops/fused.py:481"),
    "K10_pseudo_gradient_norm": ("cuda", "lbfgs_torch/csrc/owlqn.cu",
                                 "lbfgs_tpu/ops/fused.py:619"),
    "K11_pseudo_gradient": ("cuda", "lbfgs_torch/csrc/owlqn.cu",
                            "lbfgs_tpu/ops/fused.py:567"),
    "K12_pair_gram_xg": ("cuda", "lbfgs_torch/csrc/pair_gram.cu",
                         "lbfgs_tpu/ops/fused.py:1055"),
    "K12_pair_gram_xg_gp": ("cuda", "lbfgs_torch/csrc/pair_gram.cu",
                            "lbfgs_tpu/ops/fused.py:1055 (with K14's . gp column and "
                            "scalars, lbfgs_tpu/ops/factory.py:923 with_gp)"),
    "K13_combine_ow": ("cuda", "lbfgs_torch/csrc/combine.cu",
                       "lbfgs_tpu/ops/fused.py:1464"),
    "K14_owlqn_trial_pair_gram": ("triton", "lbfgs_torch/ops/_factory_triton.py",
                                  "lbfgs_tpu/ops/factory.py:923"),
    "K14_owlqn_trial_pair_gram_gp": ("triton", "lbfgs_torch/ops/_factory_triton.py",
                                     "lbfgs_tpu/ops/factory.py:923 (with_gp)"),
    "K15_combine_probe": ("triton", "lbfgs_torch/ops/_factory_triton.py",
                          "lbfgs_tpu/ops/factory.py:1195"),
    "K15_combine_probe_fix": ("triton", "lbfgs_torch/ops/_factory_triton.py",
                              "lbfgs_tpu/ops/factory.py:1195 (with K6's damped row, "
                              "lbfgs_tpu/ops/fused.py:1216)"),
    "K16_combine_ow_probe": ("triton", "lbfgs_torch/ops/_factory_triton.py",
                             "lbfgs_tpu/ops/factory.py:1345"),
    "K17_axpy_dot": ("cuda", "lbfgs_torch/csrc/axpy_dot.cu", "lbfgs_tpu/ops/fused.py:743"),
    "cal_null_launch": ("cuda", "lbfgs_torch/csrc/calibrate.cu", "bench_kernels.py:108"),
    # R: every kernel's second stage (the TPU kernels carry their sums
    # across their sequential grid; what is left the JAX package adds with
    # jnp.sum, no pallas_call)
    "R_reduce_partials": ("cuda", "lbfgs_torch/csrc/partials.cu",
                          "none: the kernels' cross-program sums, jnp.sum in "
                          "lbfgs_tpu/ops/fused.py:285-296"),
}
#: the factory kernels with extra operand streams (``_ex`` rows: checked
#: and timed with the quadratic's two extras, their launches counted on
#: the extras paths: the quadratic, the lasso and the damped quartic), and
#: the any-depth kernels at m = 80 (``_m80`` rows, the deep-history path)
EX_REPLACES = {
    "K1_trial": ":164, :184", "K2_probe": ":283, :302", "K4_trial_pair_gram": ":727, :756",
    "K4_trial_pair_gram_gp": ":727, :756", "K7_owlqn_trial": ":392, :415",
    "K8_owlqn_probe": ":490, :519", "K14_owlqn_trial_pair_gram": ":929, :968",
    "K14_owlqn_trial_pair_gram_gp": ":929, :968", "K15_combine_probe": ":1198, :1224",
    "K15_combine_probe_fix": ":1198, :1224", "K16_combine_ow_probe": ":1348, :1382",
}
KERNELS.update({
    name + "_ex": (route, src, f"{rep} (extras: lbfgs_tpu/ops/factory.py{EX_REPLACES[name]})")
    for name, (route, src, rep) in list(KERNELS.items()) if name in EX_REPLACES})
DEEP_KERNELS = ("K3_combine", "K5_pair_gram", "K6_combine_fix", "K12_pair_gram_xg",
                "K12_pair_gram_xg_gp", "K13_combine_ow")
#: the deep forms of the Triton epilogues and fusions (above
#: ``factory.MAX_M`` ring rows), whose launches are counted apart
#: (``_factory_launches``)
DEEP_FORMS = ("K4_trial_pair_gram", "K4_trial_pair_gram_gp", "K14_owlqn_trial_pair_gram",
              "K14_owlqn_trial_pair_gram_gp", "K15_combine_probe", "K15_combine_probe_fix",
              "K16_combine_ow_probe")
DEEP_KERNELS += DEEP_FORMS
KERNELS.update({f"{name}_m80": (route, src, f"{rep} (m = 80)")
                for name, (route, src, rep) in list(KERNELS.items()) if name in DEEP_KERNELS})
#: the depths the solo K4 and K14 took in their fold forms until the
#: tensor-core row-block form (``"mma_rows"``) took them: f32 and f64
#: rings at m = 80 and a bf16 ring at m = 260, n = 2^20
#: (``phase_deep_fold_paths``; the one-pass tensor-core form runs f32
#: vectors over a bf16 ring from ``factory.MMA_MIN_M`` to
#: ``factory.MMA_MAX_M`` rows)
FOLD_ROWS = {"_f32_m80": (torch.float32, torch.float32, 80),
             "_f64_m80": (torch.float64, torch.float64, 80),
             "_m260": (torch.float32, torch.bfloat16, 260)}
KERNELS.update({
    f"{name}{sfx}": (route, src,
                     f"{rep} (m = {m}, {str(vd)[6:]}/{str(hd)[6:]}, tensor-core row-block form)")
    for name, (route, src, rep) in list(KERNELS.items())
    if name in ("K4_trial_pair_gram", "K14_owlqn_trial_pair_gram")
    for sfx, (vd, hd, m) in FOLD_ROWS.items()})
#: the batched runner's kernels (the JAX package vmaps the solo kernels,
#: lbfgs_tpu/batched.py:28-72, adding a batch axis to each grid)
VMAPPED = " under vmap (lbfgs_tpu/batched.py:28-72)"
KERNELS.update({
    "K2b_probe_batched": ("triton", "lbfgs_torch/ops/_factory_triton.py",
                          "lbfgs_tpu/ops/factory.py:280" + VMAPPED),
    "K4b_trial_pair_gram_batched": ("triton", "lbfgs_torch/ops/_factory_triton.py",
                                    "lbfgs_tpu/ops/factory.py:722" + VMAPPED),
    "K3b_combine_batched": ("cuda", "lbfgs_torch/csrc/combine.cu",
                            "lbfgs_tpu/ops/fused.py:1359" + VMAPPED),
})
BATCHED_PATH = ("K2b_probe_batched", "K4b_trial_pair_gram_batched", "K3b_combine_batched")
#: the batched runner's OWL-QN kernels: each search trip's
#: projected probe, each iteration's epilogue and combine, and the init's
#: pseudo-gradient
KERNELS.update({
    "K8b_owlqn_probe_batched": ("triton", "lbfgs_torch/ops/_factory_triton.py",
                                "lbfgs_tpu/ops/factory.py:487" + VMAPPED),
    "K14b_owlqn_trial_pair_gram_batched": ("triton", "lbfgs_torch/ops/_factory_triton.py",
                                           "lbfgs_tpu/ops/factory.py:923" + VMAPPED),
    "K13b_combine_ow_batched": ("cuda", "lbfgs_torch/csrc/combine.cu",
                                "lbfgs_tpu/ops/fused.py:1464" + VMAPPED),
    "K10b_pseudo_gradient_norm_batched": ("cuda", "lbfgs_torch/csrc/owlqn.cu",
                                          "lbfgs_tpu/ops/fused.py:619" + VMAPPED),
})
BATCHED_OWLQN_PATH = ("K8b_owlqn_probe_batched", "K14b_owlqn_trial_pair_gram_batched",
                      "K13b_combine_ow_batched")
BATCHED_OWLQN_INIT = ("K10b_pseudo_gradient_norm_batched",)
#: the batched runner's combine+probe fusions (the uncapped step), and the
#: deep forms of its epilogues and fusions (above factory.MAX_M ring rows:
#: the ``_m80`` rows, at m = 80)
KERNELS.update({
    "K15b_combine_probe_batched": ("triton", "lbfgs_torch/ops/_factory_triton.py",
                                   "lbfgs_tpu/ops/factory.py:1195" + VMAPPED),
    "K16b_combine_ow_probe_batched": ("triton", "lbfgs_torch/ops/_factory_triton.py",
                                      "lbfgs_tpu/ops/factory.py:1345" + VMAPPED),
})
BATCHED_DEEP_FORMS = ("K4b_trial_pair_gram_batched", "K14b_owlqn_trial_pair_gram_batched",
                      "K15b_combine_probe_batched", "K16b_combine_ow_probe_batched")
KERNELS.update({f"{name}_m80": (route, src, f"{rep} (m = 80)")
                for name, (route, src, rep) in list(KERNELS.items())
                if name in BATCHED_DEEP_FORMS})
#: the batched runner's damped forms (damping and the gradient-only mode):
#: the epilogues' . gp columns (K4 b's, K14 b's with gp.gp and gp.pg), the
#: capped combine with the damped row (K6 b) and K15 b's fix form, each at
#: m = 6 and in its deep form at m = 80 (``_m80``); and the capped combines
#: K3 b and K13 b at m = 80 (their coefficients sized at launch)
KERNELS.update({
    "K4b_trial_pair_gram_batched_gp": ("triton", "lbfgs_torch/ops/_factory_triton.py",
                                       "lbfgs_tpu/ops/factory.py:722 (with_gp)" + VMAPPED),
    "K14b_owlqn_trial_pair_gram_batched_gp": ("triton", "lbfgs_torch/ops/_factory_triton.py",
                                              "lbfgs_tpu/ops/factory.py:923 (with_gp)"
                                              + VMAPPED),
    "K6b_combine_fix_batched": ("cuda", "lbfgs_torch/csrc/combine.cu",
                                "lbfgs_tpu/ops/fused.py:1216" + VMAPPED),
    "K15b_combine_probe_batched_fix": ("triton", "lbfgs_torch/ops/_factory_triton.py",
                                       "lbfgs_tpu/ops/factory.py:1195 (with K6's damped row, "
                                       "lbfgs_tpu/ops/fused.py:1216)" + VMAPPED),
})
BATCHED_DAMPED_FORMS = ("K4b_trial_pair_gram_batched_gp", "K14b_owlqn_trial_pair_gram_batched_gp",
                        "K6b_combine_fix_batched", "K15b_combine_probe_batched_fix",
                        "K3b_combine_batched", "K13b_combine_ow_batched")
#: the batched epilogues at the ``FOLD_ROWS`` settings, where they took
#: their deep fold forms until the row-block form (``"mma_rows"``) took
#: them: at 1024 x 2^14 (``phase_batched_fold_kernels``,
#: ``phase_batched_fold_paths``)
KERNELS.update({
    f"{name}{sfx}": (route, src,
                     f"{rep} (m = {m}, {str(vd)[6:]}/{str(hd)[6:]}, tensor-core row-block form)")
    for name, (route, src, rep) in list(KERNELS.items())
    if name in ("K4b_trial_pair_gram_batched", "K14b_owlqn_trial_pair_gram_batched")
    for sfx, (vd, hd, m) in FOLD_ROWS.items()})
KERNELS.update({f"{name}_m80": (route, src, f"{rep} (m = 80)")
                for name, (route, src, rep) in list(KERNELS.items())
                if name in BATCHED_DAMPED_FORMS})
#: the batched runner's OWL-QN kernels for generic objectives: each trial
#: point (K9 b), the init's pseudo-gradient (K11 b) and each undamped
#: iteration's pair update (K12 b; ``_m80`` at m = 80)
KERNELS.update({
    "K9b_owlqn_trial_step_batched": ("cuda", "lbfgs_torch/csrc/owlqn.cu",
                                     "lbfgs_tpu/ops/fused.py:481" + VMAPPED),
    "K11b_pseudo_gradient_batched": ("cuda", "lbfgs_torch/csrc/owlqn.cu",
                                     "lbfgs_tpu/ops/fused.py:567" + VMAPPED),
    "K12b_pair_gram_xg_batched": ("cuda", "lbfgs_torch/csrc/pair_gram.cu",
                                  "lbfgs_tpu/ops/fused.py:1055" + VMAPPED),
})
KERNELS["K12b_pair_gram_xg_batched_m80"] = (
    "cuda", "lbfgs_torch/csrc/pair_gram.cu", "lbfgs_tpu/ops/fused.py:1055 (m = 80)" + VMAPPED)
#: the batched runner's materializations and its pair + Gram pass where no
#: batched epilogue runs (the wide init, the scan two-loop, a float16 ring,
#: an objective with a fused trial and no epilogue): K1 b, K7 b, K5 b (with
#: the . gp column damped)
KERNELS.update({
    "K1b_trial_batched": ("triton", "lbfgs_torch/ops/_factory_triton.py",
                          "lbfgs_tpu/ops/factory.py:161" + VMAPPED),
    "K7b_owlqn_trial_batched": ("triton", "lbfgs_torch/ops/_factory_triton.py",
                                "lbfgs_tpu/ops/factory.py:389" + VMAPPED),
    "K5b_pair_gram_batched": ("cuda", "lbfgs_torch/csrc/pair_gram.cu",
                              "lbfgs_tpu/ops/fused.py:837" + VMAPPED),
    "K5b_pair_gram_batched_gp": ("cuda", "lbfgs_torch/csrc/pair_gram.cu",
                                 "lbfgs_tpu/ops/fused.py:837 (with_gp)" + VMAPPED),
})
#: the speculative search's K-lane probes: no Pallas kernel (the JAX
#: package's candidate pass is XLA's fusion of the vmapped value_and_grad)
SPEC_REPLACES = ("none: the counterpart of the vmapped _fts, "
                 "lbfgs_tpu/linesearch.py:999-1008")
KERNELS.update({
    "K2s_probe_steps": ("triton", "lbfgs_torch/ops/_factory_triton.py", SPEC_REPLACES),
    "K8s_owlqn_probe_steps": ("triton", "lbfgs_torch/ops/_factory_triton.py", SPEC_REPLACES),
    "K2bs_probe_steps_batched": ("triton", "lbfgs_torch/ops/_factory_triton.py",
                                 SPEC_REPLACES + VMAPPED),
    "K8bs_owlqn_probe_steps_batched": ("triton", "lbfgs_torch/ops/_factory_triton.py",
                                       SPEC_REPLACES + VMAPPED),
})
#: the lanes of the speculative phases (``with_speculative_linesearch``),
#: at which the K-lane rows are timed and bounded
SPEC_K = 4
#: every lane count a K-lane probe launch takes in the speculative phases
#: (11 lanes launch as 8 + 3: ``factory.SPEC_MAX_LANES``)
SPEC_LANES = (2, SPEC_K, 8, factory.SPEC_MAX_LANES + 3)
SPEC_WARM_LANES = (2, 3, SPEC_K, 8)
BATCHED_UNCAPPED_PATH = ("K2b_probe_batched", "K4b_trial_pair_gram_batched",
                         "K15b_combine_probe_batched")
BATCHED_OWLQN_UNCAPPED_PATH = ("K8b_owlqn_probe_batched", "K14b_owlqn_trial_pair_gram_batched",
                               "K16b_combine_ow_probe_batched")
BATCHED_DEEP_PATH = ("K2b_probe_batched", "K4b_trial_pair_gram_batched_m80",
                     "K15b_combine_probe_batched_m80")
BATCHED_OWLQN_DEEP_PATH = ("K8b_owlqn_probe_batched", "K14b_owlqn_trial_pair_gram_batched_m80",
                           "K16b_combine_ow_probe_batched_m80")
#: the kernels each main path must launch, and whose launches the kernel
#: table shows from that path
#: R, the second stage of every kernel's partials (every path launches it)
R_NAME = "R_reduce_partials"
PLAIN_PATH = ("K1_trial", "K2_probe", "K4_trial_pair_gram", "K15_combine_probe", R_NAME)
OWLQN_PATH = ("K1_trial", "K8_owlqn_probe", "K10_pseudo_gradient_norm",
              "K14_owlqn_trial_pair_gram", "K16_combine_ow_probe")
#: the kernel of each other path whose launches the kernel table shows
DAMPED_PATH = ("K4_trial_pair_gram_gp", "K15_combine_probe_fix")
DAMPED_OWLQN_PATH = ("K14_owlqn_trial_pair_gram_gp",)
K5_PATH = ("K5_pair_gram",)
POISSON_PATH = ("K9_owlqn_trial_step", "K11_pseudo_gradient", "K12_pair_gram_xg")
K12_PATH = ("K12_pair_gram_xg_gp",)
WIDE_OWLQN_PATH = ("K7_owlqn_trial",)
#: the extras paths' kernels (the lasso's first trial is K1's, or K7's
#: under the wide scalar; the damped lasso runs K14's . gp form)
QUADRATIC_PATH = ("K1_trial_ex", "K2_probe_ex", "K4_trial_pair_gram_ex", "K15_combine_probe_ex")
LASSO_PATH = ("K8_owlqn_probe_ex", "K14_owlqn_trial_pair_gram_ex", "K16_combine_ow_probe_ex")
LASSO_VARIANTS_PATH = ("K7_owlqn_trial_ex", "K14_owlqn_trial_pair_gram_gp_ex")
QUARTIC_PATH = ("K4_trial_pair_gram_gp_ex", "K15_combine_probe_fix_ex")
UNFUSED_PATH = ("K3_combine",)
UNFUSED_OWLQN_PATH = ("K13_combine_ow",)
UNFUSED_DAMPED_PATH = ("K6_combine_fix",)
#: stp1 values the fusions are checked at: the literal entry, and two an
#: adaptive entry can take
STP1 = (1.0, 0.37, 2.0 ** -3)
#: elements of the calibration kernel's one block
N_NULL = profiling.NULL_ELEMS


def cost(name: str, v: int, h: int, m: int) -> tuple:
    """(bytes, float operations) per element of one call of the kernel as
    the main paths run it, with v-byte vectors, an h-byte history and ring
    depth m: each input read once and each output written once (the ring
    row ``end`` that a pair update overwrites is not read), and the
    multiply-adds of its sums counted as two operations.  An ``_ex`` row
    reads the quadratic's two extras too (2v bytes); its operations are
    counted as Rosenbrock's body's, which does more per element than the
    quadratic's (5); ``_m80`` (``_m19``, ``_m260``; ``_f32_m80`` and
    ``_f64_m80`` over f32 and f64 rings; ``_rg`` at an n off 16 over the
    padded ring) rows are their kernel's at ring depth m."""
    if name.endswith("_ex"):
        b, f = cost(name[:-3], v, h, m)
        return b + 2 * v, f
    rings = 2 * (m - 1) * h + 2 * h
    name = re.sub(r"(_rg)?(_f32|_f64)?_m\d+$", "", name)
    return {
        "K1_trial": (4 * v, 20),
        "K2_probe": (2 * v, 16),
        "K3_combine": (2 * v + 2 * m * h, 4 * m + 6),
        "K4_trial_pair_gram": (5 * v + rings, 12 * m + 24),
        "K4_trial_pair_gram_gp": (5 * v + rings, 16 * m + 24),
        "K5_pair_gram": (3 * v + rings, 16 * m + 4),
        "K6_combine_fix": (2 * v + 2 * m * h + h, 4 * m + 10),
        "K7_owlqn_trial": (5 * v, 30),
        "K8_owlqn_probe": (3 * v, 24),
        "K9_owlqn_trial_step": (4 * v, 4),
        "K10_pseudo_gradient_norm": (3 * v, 6),
        "K11_pseudo_gradient": (3 * v, 4),
        "K12_pair_gram_xg": (5 * v + rings, 12 * m + 3),
        # and the . gp column (two more sums per ring row), gp.gp and gp.pg
        "K12_pair_gram_xg_gp": (5 * v + rings, 16 * m + 7),
        "K13_combine_ow": (2 * v + 2 * m * h, 4 * m + 10),
        "K14_owlqn_trial_pair_gram": (7 * v + rings, 12 * m + 40),
        "K14_owlqn_trial_pair_gram_gp": (7 * v + rings, 16 * m + 44),
        # K3's pass with x read and K2's probe added; K13's with K8's
        "K15_combine_probe": (3 * v + 2 * m * h, 4 * m + 22),
        # and K6's damped row: one more row written, its blend
        "K15_combine_probe_fix": (3 * v + 2 * m * h + h, 4 * m + 26),
        "K16_combine_ow_probe": (3 * v + 2 * m * h, 4 * m + 34),
        "K17_axpy_dot": (4 * v, 4),
        # the batched forms: their solo kernel's per element of the batch
        # (the [B] steps, masks and coefficients are below a byte each)
        "K2b_probe_batched": (2 * v, 16),
        "K4b_trial_pair_gram_batched": (5 * v + rings, 12 * m + 24),
        "K3b_combine_batched": (2 * v + 2 * m * h, 4 * m + 6),
        "K8b_owlqn_probe_batched": (3 * v, 24),
        "K14b_owlqn_trial_pair_gram_batched": (7 * v + rings, 12 * m + 40),
        "K13b_combine_ow_batched": (2 * v + 2 * m * h, 4 * m + 10),
        "K10b_pseudo_gradient_norm_batched": (3 * v, 6),
        "K15b_combine_probe_batched": (3 * v + 2 * m * h, 4 * m + 22),
        "K16b_combine_ow_probe_batched": (3 * v + 2 * m * h, 4 * m + 34),
        # the damped forms: their solo forms' per element
        "K4b_trial_pair_gram_batched_gp": (5 * v + rings, 16 * m + 24),
        "K14b_owlqn_trial_pair_gram_batched_gp": (7 * v + rings, 16 * m + 44),
        "K6b_combine_fix_batched": (2 * v + 2 * m * h + h, 4 * m + 10),
        "K15b_combine_probe_batched_fix": (3 * v + 2 * m * h + h, 4 * m + 26),
        # the generic objectives' forms: their solo kernels' per element (K9
        # b reads pg in the orthant's place)
        "K9b_owlqn_trial_step_batched": (4 * v, 4),
        "K11b_pseudo_gradient_batched": (3 * v, 4),
        "K12b_pair_gram_xg_batched": (5 * v + rings, 12 * m + 3),
        # the materializations and K5 b: their solo kernels' per element
        # (K7 b reads pg in the orthant's place; K5 b 3-column and . gp)
        "K1b_trial_batched": (4 * v, 20),
        "K7b_owlqn_trial_batched": (5 * v, 30),
        "K5b_pair_gram_batched": (3 * v + rings, 12 * m + 4),
        "K5b_pair_gram_batched_gp": (3 * v + rings, 16 * m + 4),
        # the K-lane probes: K2's and K8's vectors read once, the body per
        # lane (SPEC_K lanes), no gradient product
        "K2s_probe_steps": (2 * v, 16 * SPEC_K),
        "K8s_owlqn_probe_steps": (3 * v, 24 * SPEC_K),
        "K2bs_probe_steps_batched": (2 * v, 16 * SPEC_K),
        "K8bs_owlqn_probe_steps_batched": (3 * v, 24 * SPEC_K),
        # reads and writes one float32 per element, at n = N_NULL
        "cal_null_launch": (8, 1),
    }[name]


#: the H100 SXM's published peaks (NVIDIA's data sheet, at 700 W): HBM3
#: bytes/s and float32 operations/s outside the tensor cores
HBM_BYTES_PER_S, F32_OPS_PER_S = 3.35e12, 67e12


def bound(name: str, n: int, v: int, h: int, m: int) -> tuple:
    """(ms, "bytes" or "operations"): the least time the card could take
    for one call at n elements, the larger of its two bounds."""
    b, f = cost(name, v, h, m)
    t_bytes, t_ops = n * b / HBM_BYTES_PER_S, n * f / F32_OPS_PER_S
    return (1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")
def r_bound(P: int, C: int, v: int) -> tuple:
    """R's (ms, bound kind) on a [P, C] array of v-byte partials: P*C
    values read and C written, P*C adds."""
    t_bytes, t_ops = (P * C + C) * v / HBM_BYTES_PER_S, P * C / F32_OPS_PER_S
    return (1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


#: the OWL-QN kernels' L1 weight in the kernel checks (not 1: its
#: rounding to the vectors' dtype is part of what is checked)
C_L1 = 0.7
DTYPES = [
    (torch.float32, torch.bfloat16),
    (torch.float32, torch.float32),
    (torch.float64, torch.float64),
]


def emit(**kw) -> None:
    print(json.dumps(kw), flush=True)


def err(a: torch.Tensor, b: torch.Tensor) -> float:
    """Normwise error max |a - b| / max |b|."""
    a, b = a.double(), b.double()
    scale = max(float(b.abs().max()), 1e-300)
    return float((a - b).abs().max()) / scale


def check(name: str, a: torch.Tensor, b: torch.Tensor, tol: float) -> tuple:
    """Hold a kernel output to its plain version's within the normwise
    tolerance; returns (max absolute error, normwise error)."""
    e = err(a, b)
    if not e <= tol:
        raise AssertionError(f"{name}: normwise error {e:.3e} exceeds {tol:.1e}")
    return float((a.double() - b.double()).abs().max()), e


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    return (a.shape == b.shape and a.dtype == b.dtype
            and torch.equal(a.reshape(-1).contiguous().view(torch.uint8),
                            b.reshape(-1).contiguous().view(torch.uint8)))


def check_ring(name: str, S_out, Y_out, S_in, Y_in, s, y, end: int = END) -> None:
    """K4's, K5's and K14's ring write, bit for bit: row ``end`` holds the
    pair (s, y) rounded to the history dtype (round to nearest even), every
    other row is its input unchanged."""
    keep = [j for j in range(S_in.shape[0]) if j != end]
    for ring, out, inp, new in (("S", S_out, S_in, s), ("Y", Y_out, Y_in, y)):
        want = new.to(out.dtype)
        if not same_bits(out[end], want):
            bad = int((out[end] != want).sum())
            raise AssertionError(f"{name}: {ring}[end] differs from the rounded "
                                 f"pair in {bad} elements")
        if not same_bits(out[keep], inp[keep]):
            raise AssertionError(f"{name}: {ring} rows other than end changed")


def check_extends(name: str, base, ext, cols) -> None:
    """A . gp launch against the 3-column launch on the same inputs, bit
    for bit: the outputs at ``cols`` ([m, 4]) in their columns 0-2, every
    other output whole."""
    for i, (a, b) in enumerate(zip(base, ext)):
        if i in cols:
            if b.shape[1] != 4:
                raise AssertionError(f"{name}: output {i} has shape {tuple(b.shape)}")
            b = b[:, :3]
        if not same_bits(a, b):
            raise AssertionError(f"{name}: output {i} differs from the 3-column launch")


def wall_ms(fn, reps: int) -> float:
    """Milliseconds of host wall per call of fn over reps calls back to
    back, the card drained before and after (``profiling.timed``).  Where
    the host launches slower than the card runs (K1 and K2's wrappers)
    this is the host's launch time, not the card's."""
    return 1e3 * profiling.timed(lambda: [fn() for _ in range(reps)]) / reps


def averages(prof):
    """``prof.key_averages()``, summed once per profiler session and kept on
    it: the sums over a session of thousands of launches take seconds, and
    every reader of a session shares them."""
    ka = getattr(prof, "_averages", None)
    if ka is None:
        ka = prof._averages = prof.key_averages()
    return ka


def device_events(prof) -> list:
    """The kernels and copies a torch.profiler run saw on the card."""
    from torch.autograd import DeviceType

    return [e for e in averages(prof) if e.device_type == DeviceType.CUDA]


#: profiler sessions that saw nothing, or part of the work, on the card and
#: were run again, and device times that came from CUDA events because
#: every session was empty or partial
PROFILER_MISSES = {"empty_sessions": 0, "partial_sessions": 0, "event_timed": 0}
#: what the timing costs the script: profiler sessions and their host
#: seconds, and the host seconds inside ``device_time`` (each phase's share
#: is printed with its seconds)
TIMING_COST = {"profiler_sessions": 0, "profiler_s": 0.0, "device_time_s": 0.0}


def profiled(fn, tries: int = 3):
    """(profiler, fn's value) of one call of fn under torch.profiler
    (``profiling.trace``), the card drained before the session closes.
    CUPTI now and then delivers no device activity for a session; such a
    session is run again, and after ``tries`` empty ones the profiler
    returned is None."""
    for _ in range(tries):
        t0 = time.perf_counter()
        with profiling.trace() as prof:
            out = fn()
            torch.cuda.synchronize()
        seen = sum(e.self_device_time_total for e in device_events(prof)) > 0
        TIMING_COST["profiler_sessions"] += 1
        TIMING_COST["profiler_s"] += time.perf_counter() - t0
        if seen:
            return prof, out
        PROFILER_MISSES["empty_sessions"] += 1
    return None, out


#: SM cycles per millisecond the spin kernel is sized by; above the
#: H100's 1.98 GHz boost clock, so the spin lasts at least as long as asked
SPIN_CYCLES_PER_MS = 2_000_000


def event_time(fn, reps: int) -> float:
    """Device milliseconds per call of fn from CUDA events around reps
    calls queued behind a spin kernel (``torch.cuda._sleep``) that lasts
    twice the host's time to launch them: the card reaches the first event
    only after the host has queued every call, so the events time the
    card's work and its gaps between kernels, not the host's launch rate.
    A call that reads back to the host drains the queue, and is then timed
    at its wall."""
    host_ms = wall_ms(fn, reps) * reps
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(int(2 * host_ms * SPIN_CYCLES_PER_MS) + 1)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


#: a profiler session whose device time falls under this share of the
#: same calls' CUDA-event time saw part of the work (on an H100 80GB HBM3
#: sessions summed K2 at 0.034 ms a call against its 0.058 event time, and
#: K15 with extras at 0.215 against 0.268, each under the time its bytes
#: alone take; whole sessions ran at 0.916-0.998 of it); work under
#: ``PARTIAL_MIN_MS`` a call is exempt, as launch gaps make much of its
#: event time
PARTIAL_SHARE, PARTIAL_MIN_MS = 0.9, 0.01


def device_time(fn, reps: int, tries: int = 1) -> float:
    """Device milliseconds per call of fn: the summed durations of every
    kernel and copy it puts on the card (kernel, partial sums,
    allocations' fills), from torch.profiler.  A session that saw part of
    the work (``PARTIAL_SHARE`` of ``event_time``) is run again up to
    ``tries`` sessions (an empty one twice); where every session came
    back empty or partial the time is ``event_time``'s.
    ``device_time.source`` then says which timed it: "profiler" or
    "events"."""
    t0 = time.perf_counter()
    try:
        fn()
        torch.cuda.synchronize()
        ev = event_time(fn, reps)
        for _ in range(tries):
            prof, _ = profiled(lambda: [fn() for _ in range(reps)], tries=2)
            if prof is None:
                break
            t = sum(e.self_device_time_total for e in device_events(prof)) / 1e3 / reps
            if t >= PARTIAL_SHARE * ev or ev < PARTIAL_MIN_MS:
                device_time.source = "profiler"
                return t
            PROFILER_MISSES["partial_sessions"] += 1
        PROFILER_MISSES["event_timed"] += 1
        device_time.source = "events"
        return ev
    finally:
        TIMING_COST["device_time_s"] += time.perf_counter() - t0


device_time.source = None


#: calls a sample of a plain version takes, at most: the plain versions
#: are torch compositions 10-200x slower than their kernels, timed for the
#: record and compared with nothing
PLAIN_REPS = 4


def kernel_vs_plain(kern, plain, reps: int) -> tuple:
    """(kernel ms, plain ms, the kernel's timer, the plain's timer) from
    ``device_time`` in the order kernel, plain, kernel, so that both sides
    see the same clocks; the kernel the lesser of its two calls of reps
    calls, the plain version one call of at most ``PLAIN_REPS``, each with
    the timer ("profiler" or "events") that gave it."""
    k1, p, k2 = ((device_time(f, n), device_time.source)
                 for f, n in ((kern, reps), (plain, min(reps, PLAIN_REPS)), (kern, reps)))
    k = min(k1, k2)
    return k[0], p[0], k[1], p[1]


def inputs(n: int, vd, hd, seed: int):
    """Seeded inputs of every kernel; xp has exact zeros at every 17th
    element (the OWL-QN orthant's at-zero choice) and pg is random."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=g, device="cuda", dtype=torch.float64)
    xp = (rosenbrock.initial_point(n, torch.float64, "cuda") + 0.1 * r(n)).to(vd)
    xp0 = xp.clone()
    xp0[::17] = 0.0
    return dict(
        xp=xp, d=(0.1 * r(n)).to(vd), gp=r(n).to(vd),
        S=r(M, n).to(hd), Y=r(M, n).to(hd),
        gamma=torch.tensor(0.8, dtype=vd, device="cuda"),
        cs=r(M).to(vd), cy=r(M).to(vd),
        xp0=xp0, pg=r(n).to(vd),
    )


def windows(n: int) -> list:
    """The OWL-QN windows the kernels are checked on: the main path's
    [0, n - 1), and one whose ends fall inside kernel blocks."""
    return [(0, n - 1), (3 * 1024 + 5, n - 7 * 1024 - 3)]


# ---------------------------------------------------------------------------


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke needs a CUDA device; none is available")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    # full-precision float32 products everywhere (the two-loop's [m, m]
    # algebra and the plain versions' matvecs)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit(phase="device", name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda, python=sys.version.split()[0], nvidia_smi=smi)
    return smi


#: worker processes that compile the Triton specialisations of
#: ``warm_steps`` into the shared on-disk cache while nvcc builds the CUDA
#: library (Triton compiles on the host, one kernel at a time a process)
WARM_WORKERS = 6


def warm_steps() -> list:
    """The build phase's launches, one step per group: each step takes
    ``lib`` (whether it may launch the CUDA library's kernels, which only
    the main process builds) and launches, at small sizes, every Triton
    specialisation of its group that the later phases use (the dtype pair,
    n divisible by 16 or not, the ring depth: the static forms at m = 6
    and 3, the deep and tensor-core forms the deep-history phases run, the
    forced fold forms of their checks, and the batched runner's forms at
    m = 6, 19 and 80)."""
    steps = []

    def group(vd, hd, n, m):
        def step(lib):
            x = torch.ones(n, dtype=vd, device="cuda")
            S = torch.zeros((m, n), dtype=hd, device="cuda")
            rosenbrock.trial(x, x, 0.0)
            rosenbrock.probe(x, x, 0.0)
            rosenbrock.trial_pair_gram(x, x, x.clone(), 0.0, S, S.clone(), 1)
            z = torch.zeros(m, dtype=vd, device="cuda")
            if lib:
                fused.combine(x, S, S, z[0], z, z)
            # the combine+probe fusions (K15 with and without its damped-row
            # form, K16)
            rosenbrock.combine_probe(x, x, S, S, z[0], z, z, 1.0)
            rosenbrock.combine_probe(x, x, S, S.clone(), z[0], z, z, 1.0, fix=(1, z[0], z[0]))
            rosenbrock.combine_ow_probe(x, x, S, S, z[0], z, z, 1.0, 0, n - 1, 1.0)
        return step

    def owlqn(vd, hd, n):
        # the OWL-QN kernels run at m = M only, and the damped paths' . gp forms
        def step(lib):
            x = torch.ones(n, dtype=vd, device="cuda")
            S = torch.zeros((M, n), dtype=hd, device="cuda")
            rosenbrock.owlqn_trial(x, x, x, 0.0, 1.0, 0, n - 1)
            rosenbrock.owlqn_probe(x, x, x, 0.0, 1.0, 0, n - 1)
            rosenbrock.owlqn_probe_pg(x, x, x, 0.0, 1.0, 0, n - 1)
            rosenbrock.owlqn_trial_pair_gram(x, x, x.clone(), x.clone(), 0.0, 1.0, 0,
                                             n - 1, S, S.clone(), 1)
            rosenbrock.trial_pair_gram(x, x, x.clone(), 0.0, S, S.clone(), 1, with_gp=True)
            rosenbrock.owlqn_trial_pair_gram(x, x, x.clone(), x.clone(), 0.0, 1.0, 0,
                                             n - 1, S, S.clone(), 1, with_gp=True)
        return step

    def deep(vd, hd, m, force=None):
        # K4 and K14 (each with and without the . gp column) in the form m
        # takes, or the fold form ``static_forms_up_to(force)`` picks, and
        # above MAX_M the fusions' deep forms
        def step(lib):
            n = 4096
            x = torch.ones(n, dtype=vd, device="cuda")
            S = torch.zeros((m, n), dtype=hd, device="cuda")
            z = torch.zeros(m, dtype=vd, device="cuda")
            with static_forms_up_to(force) if force is not None else nullcontext():
                for gp in (False, True):
                    rosenbrock.trial_pair_gram(x, x, x.clone(), 0.0, S, S.clone(), 1,
                                               with_gp=gp)
                    rosenbrock.owlqn_trial_pair_gram(x, x, x.clone(), x.clone(), 0.0, 1.0, 0,
                                                     n - 1, S, S.clone(), 1, with_gp=gp)
                if m > factory.MAX_M and force is None:
                    rosenbrock.combine_probe(x, x, S, S, z[0], z, z, 1.0)
                    rosenbrock.combine_probe(x, x, S, S.clone(), z[0], z, z, 1.0,
                                             fix=(1, z[0], z[0]))
                    rosenbrock.combine_ow_probe(x, x, S, S, z[0], z, z, 1.0, 0, n - 1, 1.0)
        return step

    def extras(n):
        # the factory kernels with extras: every form with the quadratic's
        # two (f32 vectors, bf16 history, n divisible by 16 or not)
        def step(lib):
            x = torch.ones(n, device="cuda")
            S = torch.zeros((M, n), dtype=torch.bfloat16, device="cuda")
            z = torch.zeros(M, device="cuda")
            q = separable.quadratic(x.clone(), x.clone()).kernels
            q.trial(x, x, 0.0)
            q.probe(x, x, 0.0)
            q.owlqn_trial(x, x, x, 0.0, 1.0, 0, n - 1)
            q.owlqn_probe(x, x, x, 0.0, 1.0, 0, n - 1)
            q.owlqn_probe_pg(x, x, x, 0.0, 1.0, 0, n - 1)
            for with_gp in (False, True):
                q.trial_pair_gram(x, x, x.clone(), 0.0, S, S.clone(), 1, with_gp=with_gp)
                q.owlqn_trial_pair_gram(x, x, x.clone(), x.clone(), 0.0, 1.0, 0, n - 1, S,
                                        S.clone(), 1, with_gp=with_gp)
            q.combine_probe(x, x, S, S, z[0], z, z, 1.0)
            q.combine_probe(x, x, S, S.clone(), z[0], z, z, 1.0, fix=(1, z[0], z[0]))
            q.combine_ow_probe(x, x, S, S, z[0], z, z, 1.0, 0, n - 1, 1.0)
            WARM[f"quadratic n={n}"] = q
        return step

    def quartic(lib):
        # the damped path's forms with the quartic's one extra
        x = torch.ones(4096, device="cuda")
        S = torch.zeros((M, 4096), dtype=torch.bfloat16, device="cuda")
        z = torch.zeros(M, device="cuda")
        q = separable.scaled_quartic(x.clone()).kernels
        q.trial(x, x, 0.0)
        q.probe(x, x, 0.0)
        q.trial_pair_gram(x, x, x.clone(), 0.0, S, S.clone(), 1, with_gp=True)
        q.combine_probe(x, x, S, S.clone(), z[0], z, z, 1.0, fix=(1, z[0], z[0]))
        WARM["quartic"] = q

    def north_star(lib):
        # the OWL-QN north star's ring depth
        x = torch.ones(4096, device="cuda")
        S = torch.zeros((3, 4096), dtype=torch.bfloat16, device="cuda")
        rosenbrock.owlqn_trial_pair_gram(x, x, x.clone(), x.clone(), 0.0, 1.0, 0, 4095, S,
                                         S.clone(), 1)

    def batched(m):
        # the batched runner's Triton forms at m ring rows (f32 vectors, bf16
        # rings, n a multiple of 16): K2 b, K8 b, K1 b and K7 b (at m = M),
        # K4 b and K14 b (with and without the . gp column: the static form's
        # flag is compiled in, the tensor-core form's is not), and K15 b (with
        # and without its fix form) and K16 b
        def step(lib):
            k = rosenbrock.value_and_grad.kernels
            n = 4096
            x = torch.ones((2, n), device="cuda")
            S = torch.zeros((2, m, n), dtype=torch.bfloat16, device="cuda")
            stp = torch.zeros(2, device="cuda")
            live = torch.ones(2, dtype=torch.bool, device="cuda")
            if m == M:
                k.probe_batched(x, x, stp, live)
                k.owlqn_probe_pg_batched(x, x, x, stp, 1.0, 0, n - 1, live)
                k.trial_batched(x, x, stp, live, x.clone(), x.clone())
                k.owlqn_trial_batched(x, x, x, stp, 1.0, 0, n - 1, live, x.clone(), x.clone())
            for gp in (False, True):
                k.trial_pair_gram_batched(x.clone(), x, x.clone(), stp, S, S.clone(), 1, live,
                                          with_gp=gp)
                k.owlqn_trial_pair_gram_batched(x.clone(), x, x.clone(), x.clone(), stp, 1.0, 0,
                                                n - 1, S, S.clone(), 1, live, with_gp=gp)
            if m != DEEP_VS_STATIC_M:
                coef = torch.zeros((2, 2 * m + 1), device="cuda")
                coef_fix = torch.zeros((2, 2 * m + 3), device="cuda")
                k.combine_probe_batched(x, x, S, S, coef, stp, live, x.clone())
                k.combine_probe_batched(x, x, S, S.clone(), coef_fix, stp, live, x.clone(), fix=1)
                k.combine_ow_probe_batched(x, x, S, S, coef, 1.0, 0, n - 1, stp, live, x.clone())
        return step

    def batched_rules(lib):
        # K4 b and K14 b (each with and without the . gp column) in the deep
        # fold form that an n off a multiple of 16 takes (``batched_mma_rules``)
        k = rosenbrock.value_and_grad.kernels
        n = 4098
        x = torch.ones((2, n), device="cuda")
        S = torch.zeros((2, DEEP_VS_STATIC_M, n), dtype=torch.bfloat16, device="cuda")
        stp = torch.zeros(2, device="cuda")
        live = torch.ones(2, dtype=torch.bool, device="cuda")
        for gp in (False, True):
            k.trial_pair_gram_batched(x.clone(), x, x.clone(), stp, S, S.clone(), 1, live,
                                      with_gp=gp)
            k.owlqn_trial_pair_gram_batched(x.clone(), x, x.clone(), x.clone(), stp, 1.0, 0,
                                            n - 1, S, S.clone(), 1, live, with_gp=gp)

    for vd, hd in DTYPES:
        for n in (4096, 4098):
            steps += [group(vd, hd, n, m) for m in (M, 3)] + [owlqn(vd, hd, n)]
        steps.append(deep(vd, hd, DEEP_M))
    bf16 = (torch.float32, torch.bfloat16)
    steps += [deep(*bf16, m) for m in (DEEP_VS_STATIC_M, 130)]
    steps += [deep(*bf16, DEEP_VS_STATIC_M, force=M),
              deep(*bf16, DEEP_VS_STATIC_M, force=DEEP_VS_STATIC_M)]
    # the row-block form over a bf16 ring above 256 rows, and the fold forms
    # the row-block form's checks hold it to at the FOLD_ROWS depths
    steps += [deep(*bf16, FOLD_ROWS["_m260"][2])]
    steps += [deep(vd, hd, m, force=M) for vd, hd, m in FOLD_ROWS.values() if hd != bf16[1]]
    def speculative(n, K):
        # the K-lane probes at the lanes the speculative phases take (K2 s
        # and K8 s at 2, 3, 4 and 8 lanes, 11 as 8 + 3; f32, n divisible by
        # 16 or not) and their batched forms; at SPEC_K lanes off 16 also
        # f64 and the quadratic's extras
        def step(lib):
            k = rosenbrock.value_and_grad.kernels
            x = torch.ones(n, device="cuda")
            stp = np.full(K, 0.5, np.float32)
            k.probe_steps(x, x, stp)
            k.owlqn_probe_steps(x, x, x, stp, 1.0, 0, n - 1)
            if n % 16 == 0:
                xb = x.view(2, n // 2)
                stb = torch.full((2, K), 0.5, device="cuda")
                live = torch.ones(2, dtype=torch.bool, device="cuda")
                k.probe_steps_batched(xb, xb, stb, live)
                k.owlqn_probe_pg_steps_batched(xb, xb, xb, stb, 1.0, 0, n // 2 - 1, live)
            if K != SPEC_K:
                return
            if n % 16:
                x64, stp64 = x.double(), stp.astype(np.float64)
                k.probe_steps(x64, x64, stp64)
                k.owlqn_probe_steps(x64, x64, x64, stp64, 1.0, 0, n - 1)
                q = separable.quadratic(x.clone(), x.clone()).kernels
                q.probe_steps(x, x, stp)
                q.owlqn_probe_steps(x, x, x, stp, 1.0, 0, n - 1)
        return step

    def batched_fold(vd, hd, m):
        # the batched runner's forms at a ``FOLD_ROWS`` setting: K4 b and K14
        # b in the row-block form (one binary for both launches) and in the
        # deep fold form their checks hold them to (each with and without
        # the . gp column), and the fold paths' probes and M = 0 fusions
        def step(lib):
            k = rosenbrock.value_and_grad.kernels
            n = 4096
            x = torch.ones((2, n), dtype=vd, device="cuda")
            S = torch.zeros((2, m, n), dtype=hd, device="cuda")
            stp = torch.zeros(2, dtype=vd, device="cuda")
            live = torch.ones(2, dtype=torch.bool, device="cuda")
            for force in (None, M):
                with static_forms_up_to(force) if force is not None else nullcontext():
                    for gp in (False, True):
                        k.trial_pair_gram_batched(x.clone(), x, x.clone(), stp, S, S.clone(), 1,
                                                  live, with_gp=gp)
                        k.owlqn_trial_pair_gram_batched(x.clone(), x, x.clone(), x.clone(), stp,
                                                        1.0, 0, n - 1, S, S.clone(), 1, live,
                                                        with_gp=gp)
            if vd != torch.float32:
                k.probe_batched(x, x, stp, live)
                k.owlqn_probe_pg_batched(x, x, x, stp, 1.0, 0, n - 1, live)
            coef = torch.zeros((2, 2 * m + 1), dtype=vd, device="cuda")
            k.combine_probe_batched(x, x, S, S, coef, stp, live, x.clone())
            k.combine_ow_probe_batched(x, x, S, S, coef, 1.0, 0, n - 1, stp, live, x.clone())
        return step

    def ragged(vd, hd, m):
        # the ragged phases' forms at an n off 16 (n = 4098 compiles what
        # 2^20 + 2, 2^24 + 2 and 2^14 + 2 take): K4 and K14, K4 b and K14 b
        # over the padded ring (the tensor-core forms) and over a ring of
        # row stride n (the deep fold forms they are held to), each with and
        # without the . gp column; the ragged paths' fusions at m = 80 and
        # their probes
        def step(lib):
            k = rosenbrock.value_and_grad.kernels
            n = 4098
            x = torch.ones(n, dtype=vd, device="cuda")
            xb = torch.ones((2, n), dtype=vd, device="cuda")
            stp = torch.zeros(2, dtype=vd, device="cuda")
            live = torch.ones(2, dtype=torch.bool, device="cuda")
            for ring in (lambda *sh: ring_zeros(sh, hd, "cuda"),
                         lambda *sh: torch.zeros(sh, dtype=hd, device="cuda")):
                S, Y, Sb, Yb = ring(m, n), ring(m, n), ring(2, m, n), ring(2, m, n)
                for gp in (False, True):
                    k.trial_pair_gram(x, x, x.clone(), 0.0, S, Y, 1, with_gp=gp)
                    k.owlqn_trial_pair_gram(x, x, x.clone(), x.clone(), 0.0, 1.0, 0, n - 1, S,
                                            Y, 1, with_gp=gp)
                    k.trial_pair_gram_batched(xb.clone(), xb, xb.clone(), stp, Sb, Yb, 1, live,
                                              with_gp=gp)
                    k.owlqn_trial_pair_gram_batched(xb.clone(), xb, xb.clone(), xb.clone(), stp,
                                                    1.0, 0, n - 1, Sb, Yb, 1, live, with_gp=gp)
            if m != DEEP_M:
                return
            S = ring_zeros((m, n), hd, "cuda")
            Sb = ring_zeros((2, m, n), hd, "cuda")
            z = torch.zeros(m, dtype=vd, device="cuda")
            k.combine_probe(x, x, S, S, z[0], z, z, 1.0)
            k.combine_ow_probe(x, x, S, S, z[0], z, z, 1.0, 0, n - 1, 1.0)
            coef = torch.zeros((2, 2 * m + 1), dtype=vd, device="cuda")
            k.combine_probe_batched(xb, xb, Sb, Sb, coef, stp, live, xb.clone())
            k.combine_ow_probe_batched(xb, xb, Sb, Sb, coef, 1.0, 0, n - 1, stp, live,
                                       xb.clone())
            k.probe_batched(xb, xb, stp, live)
            k.owlqn_probe_pg_batched(xb, xb, xb, stp, 1.0, 0, n - 1, live)
            k.probe(x, x, 0.0)
            k.owlqn_probe(x, x, x, 0.0, 1.0, 0, n - 1)
            k.trial(x, x, 0.0)
            k.owlqn_trial(x, x, x, 0.0, 1.0, 0, n - 1)
        return step

    steps += [speculative(n, K) for n in (8192, 4098) for K in SPEC_WARM_LANES]
    steps += [ragged(vd, hd, m) for vd, hd, m in RAGGED_ROWS.values()]
    steps += [batched(m) for m in (M, DEEP_VS_STATIC_M, DEEP_M)]
    steps += [batched_fold(vd, hd, m) for vd, hd, m in FOLD_ROWS.values()]
    return steps


def warm_part(part: int, parts: int) -> None:
    """``warm_steps``' steps part, part + parts, ... without the CUDA
    library (a build worker).  The Triton wrappers' second stage, R, is
    the library's; a worker only compiles Triton's kernels, so torch's sum
    takes R's place here."""
    _build.import_triton()
    fused.reduce_partials = fused.reduce_partials_ref
    for i, step in enumerate(warm_steps()):
        if i % parts == part:
            step(False)
    torch.cuda.synchronize()


def phase_build() -> None:
    """The CUDA library (nvcc, one process per source) and every Triton
    specialisation of ``warm_steps``: ``WARM_WORKERS`` processes compile
    the steps into the shared cache while nvcc runs, then this process
    launches every step (the cache's binaries) with the library."""
    t0 = time.perf_counter()
    _build.import_triton()
    workers = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--warm",
                                 str(i), str(WARM_WORKERS)])
               for i in range(WARM_WORKERS)]
    try:
        _build.load_library()
        t_nvcc = time.perf_counter() - t0
        for line in _build.build_log().splitlines():
            if "registers" in line or "spill" in line:
                print("ptxas:", line.strip(), flush=True)
        rcs = [w.wait(timeout=900) for w in workers]
    finally:
        for w in workers:
            if w.poll() is None:
                w.kill()
    if any(rcs):
        raise AssertionError(f"build workers exited {rcs}")
    t1 = time.perf_counter()
    for step in warm_steps():
        step(True)
    torch.cuda.synchronize()
    emit(phase="build", nvcc_s=round(t_nvcc, 3), workers=WARM_WORKERS,
         workers_s=round(t1 - t0, 3), triton_from_cache_s=round(time.perf_counter() - t1, 3),
         triton=_build.import_triton().__version__)


#: the factory kernels of the build phase's objectives with extras, whose
#: compiled epilogues ``epilogue_compiled`` reports
WARM = {}


def _fold(errs: dict, name: str, *pairs) -> None:
    a, r = errs[name]
    errs[name] = (max([a] + [p[0] for p in pairs]), max([r] + [p[1] for p in pairs]))


def phase_kernels() -> dict:
    errs = {k: (0.0, 0.0) for k in KERNELS}
    for n in (N_BIG, N_RAGGED):
        for vd, hd in DTYPES:
            a = inputs(n, vd, hd, SEED + n)
            tv, ts = TOL[(vd, "vec")], TOL[(vd, "sum")]
            tag = f"n={n} {vd} {hd}"
            check_factory(errs, rosenbrock, a, tag, tv, ts)
            # K3
            k = fused.combine(a["gp"], a["S"], a["Y"], a["gamma"], a["cs"], a["cy"])
            p = fused.combine_ref(a["gp"], a["S"], a["Y"], a["gamma"], a["cs"], a["cy"])
            _fold(errs, "K3_combine", check(f"K3 r {tag}", k[0], p[0], tv),
                  *(check(f"K3 sum{i} {tag}", k[i], p[i], ts) for i in (1, 2)))
            del k, p
            check_k5_k6(errs, a, tag, tv, ts)
            check_k12_depths(errs, a, tag, ts)
            check_fusions(errs, a, n, tag, tv, ts)
            for lo, hi in windows(n):
                check_owlqn(errs, a, lo, hi, f"{tag} window=[{lo},{hi})", tv, ts)
                check_composed(errs, a, lo, hi, f"{tag} window=[{lo},{hi})", tv, ts)
            del a
            torch.cuda.empty_cache()
        check_extras(errs, n)
        emit(phase="kernels", n=n, max_abs_err={k: v[0] for k, v in errs.items()},
             max_normwise_err={k: v[1] for k, v in errs.items()},
             tol={"f32_vec": TOL[(torch.float32, "vec")],
                  "f32_sum": TOL[(torch.float32, "sum")],
                  "f64_vec": TOL[(torch.float64, "vec")],
                  "f64_sum": TOL[(torch.float64, "sum")],
                  "k4_k5_k6_k12_k14_ring_row": "bit-exact", "k8_forms": "bit-exact",
                  "with_gp_columns_0_2": "bit-exact", "k9_point": "bit-exact",
                  "k11_vs_k10_pg": "bit-exact", "k7_ft_vs_k8": "bit-exact",
                  "k15_probe_vs_k2": "bit-exact", "k16_probe_vs_k8_pg": "bit-exact",
                  "k15_fix_row_vs_k6": "bit-exact", "k15_r_vs_k3": "bit-exact",
                  "k15_fix_r_vs_k6": "bit-exact", "k16_rc_vs_k13": "bit-exact",
                  "k17_z": "bit-exact", "null_launch": "bit-exact"})

    check_k17_null(errs)
    r_times = check_r(errs)

    # times at the main path's shapes: n = 2^24, f32 vectors, bf16 history
    a = inputs(N_BIG, torch.float32, torch.bfloat16, SEED)
    S, Y = a["S"], a["Y"]
    cases = {
        "K1_trial": (lambda: rosenbrock.trial(a["xp"], a["d"], STP),
                     lambda: rosenbrock.trial_ref(a["xp"], a["d"], STP)),
        "K2_probe": (lambda: rosenbrock.probe(a["xp"], a["d"], STP),
                     lambda: rosenbrock.probe_ref(a["xp"], a["d"], STP)),
        "K3_combine": (
            lambda: fused.combine(a["gp"], S, Y, a["gamma"], a["cs"], a["cy"]),
            lambda: fused.combine_ref(a["gp"], S, Y, a["gamma"], a["cs"], a["cy"])),
        "K4_trial_pair_gram": (
            lambda: rosenbrock.trial_pair_gram(a["xp"], a["d"], a["gp"], STP, S, Y, END),
            lambda: rosenbrock.trial_pair_gram_ref(a["xp"], a["d"], a["gp"], STP, S, Y, END)),
    }
    # the OWL-QN kernels in the form the OWL-QN main path runs them: c = 1
    # on [0, n - 1), K8 with the orthant rebuilt from pg
    xp0, pg, hi = a["xp0"], a["pg"], N_BIG - 1
    ca, cb = (torch.tensor(v, dtype=torch.float32, device="cuda") for v in (0.7, -0.2))
    # the damped kernels in the form their paths run them: K4, K5 and K14
    # with the . gp column
    cases.update({
        "K4_trial_pair_gram_gp": (
            lambda: rosenbrock.trial_pair_gram(a["xp"], a["d"], a["gp"], STP, S, Y, END,
                                               with_gp=True),
            lambda: rosenbrock.trial_pair_gram_ref(a["xp"], a["d"], a["gp"], STP, S, Y,
                                                   END, with_gp=True)),
        "K5_pair_gram": (
            lambda: fused.pair_gram_sd(STP, a["d"], pg, a["gp"], S, Y, END, with_gp=True),
            lambda: fused.pair_gram_sd_ref(STP, a["d"], pg, a["gp"], S, Y, END,
                                           with_gp=True)),
        "K6_combine_fix": (
            lambda: fused.combine_fix(a["gp"], S, Y, a["gamma"], a["cs"], a["cy"], END,
                                      ca, cb),
            lambda: fused.combine_fix_ref(a["gp"], S, Y, a["gamma"], a["cs"], a["cy"],
                                          END, ca, cb)),
        "K14_owlqn_trial_pair_gram_gp": (
            lambda: rosenbrock.owlqn_trial_pair_gram(xp0, a["d"], a["gp"], pg, STP, 1.0,
                                                     0, hi, S, Y, END, with_gp=True),
            lambda: rosenbrock.owlqn_trial_pair_gram_ref(xp0, a["d"], a["gp"], pg, STP,
                                                         1.0, 0, hi, S, Y, END,
                                                         with_gp=True)),
    })
    cases.update({
        "K8_owlqn_probe": (
            lambda: rosenbrock.owlqn_probe_pg(xp0, a["d"], pg, STP, 1.0, 0, hi),
            lambda: rosenbrock.owlqn_probe_pg_ref(xp0, a["d"], pg, STP, 1.0, 0, hi)),
        "K10_pseudo_gradient_norm": (
            lambda: fused.pseudo_gradient_norm(xp0, a["gp"], 1.0, 0, hi),
            lambda: fused.pseudo_gradient_norm_ref(xp0, a["gp"], 1.0, 0, hi)),
        "K13_combine_ow": (
            lambda: fused.combine_ow(pg, S, Y, a["gamma"], a["cs"], a["cy"], 0, hi),
            lambda: fused.combine_ow_ref(pg, S, Y, a["gamma"], a["cs"], a["cy"], 0, hi)),
        "K14_owlqn_trial_pair_gram": (
            lambda: rosenbrock.owlqn_trial_pair_gram(xp0, a["d"], a["gp"], pg, STP, 1.0,
                                                     0, hi, S, Y, END),
            lambda: rosenbrock.owlqn_trial_pair_gram_ref(xp0, a["d"], a["gp"], pg, STP,
                                                         1.0, 0, hi, S, Y, END)),
    })
    # the composed OWL-QN kernels in the form the Poisson main path runs
    # them, and K7 as the wide OWL-QN main path's init
    wp = choose_orthant(Orthantwise(1.0, 0, hi), xp0, pg)
    x9 = fused.owlqn_trial_step(xp0, a["d"], wp, STP, 0, hi)
    cases.update({
        "K7_owlqn_trial": (
            lambda: rosenbrock.owlqn_trial(xp0, a["d"], wp, STP, 1.0, 0, hi),
            lambda: rosenbrock.owlqn_trial_ref(xp0, a["d"], wp, STP, 1.0, 0, hi)),
        "K9_owlqn_trial_step": (
            lambda: fused.owlqn_trial_step(xp0, a["d"], wp, STP, 0, hi),
            lambda: fused.owlqn_trial_step_ref(xp0, a["d"], wp, STP, 0, hi)),
        "K11_pseudo_gradient": (
            lambda: fused.pseudo_gradient(xp0, a["gp"], 1.0, 0, hi),
            lambda: fused.pseudo_gradient_ref(xp0, a["gp"], 1.0, 0, hi)),
        "K12_pair_gram_xg": (
            lambda: fused.pair_gram_xg(x9, xp0, pg, a["gp"], a["xp"], S, Y, END),
            lambda: fused.pair_gram_xg_ref(x9, xp0, pg, a["gp"], a["xp"], S, Y, END)),
        "K12_pair_gram_xg_gp": (
            lambda: fused.pair_gram_xg(x9, xp0, pg, a["gp"], a["xp"], S, Y, END, with_gp=True),
            lambda: fused.pair_gram_xg_ref(x9, xp0, pg, a["gp"], a["xp"], S, Y, END,
                                           with_gp=True)),
    })
    # the fusions in the form their main paths run them (stp1 = 1; the
    # damped-row form on a ring of its own, which it rewrites), K17 on
    # three of the inputs' vectors, the calibration kernel on one block
    xn = torch.zeros(N_NULL, device="cuda")
    Yf = Y.clone()
    cases.update({
        "K15_combine_probe": (
            lambda: rosenbrock.combine_probe(a["gp"], a["xp"], S, Y, a["gamma"], a["cs"],
                                             a["cy"], 1.0),
            lambda: rosenbrock.combine_probe_ref(a["gp"], a["xp"], S, Y, a["gamma"], a["cs"],
                                                 a["cy"], 1.0)),
        "K15_combine_probe_fix": (
            lambda: rosenbrock.combine_probe(a["gp"], a["xp"], S, Yf, a["gamma"], a["cs"],
                                             a["cy"], 1.0, fix=(END, ca, cb)),
            lambda: rosenbrock.combine_probe_ref(a["gp"], a["xp"], S, Yf, a["gamma"], a["cs"],
                                                 a["cy"], 1.0, fix=(END, ca, cb))),
        "K16_combine_ow_probe": (
            lambda: rosenbrock.combine_ow_probe(pg, xp0, S, Y, a["gamma"], a["cs"], a["cy"],
                                                1.0, 0, hi, 1.0),
            lambda: rosenbrock.combine_ow_probe_ref(pg, xp0, S, Y, a["gamma"], a["cs"],
                                                    a["cy"], 1.0, 0, hi, 1.0)),
        "K17_axpy_dot": (lambda: fused.axpy_dot(a["gp"], a["d"], 0.37, a["xp"]),
                         lambda: fused.axpy_dot_ref(a["gp"], a["d"], 0.37, a["xp"])),
        "cal_null_launch": (lambda: profiling.null_launch(xn),
                            lambda: profiling.null_launch_ref(xn)),
    })
    # R on K2's and K15's partials at n = 2^24
    rp = torch.randn(R_TIMED["p16384_c2"][0], device="cuda",
                     generator=torch.Generator(device="cuda").manual_seed(SEED + 41))
    cases[R_NAME] = (lambda: fused.reduce_partials(rp), lambda: fused.reduce_partials_ref(rp))
    # the factory kernels with the quadratic's two extras, in the forms the
    # extras paths run them (K8 with the orthant rebuilt from pg)
    wq, tq = quadratic_data(N_BIG, SEED + 5)
    qk = separable.quadratic(wq, tq).kernels
    Yq = Y.clone()
    ex_cases = {
        "K1_trial": (qk.trial, qk.trial_ref, (a["xp"], a["d"], STP), {}),
        "K2_probe": (qk.probe, qk.probe_ref, (a["xp"], a["d"], STP), {}),
        "K4_trial_pair_gram": (qk.trial_pair_gram, qk.trial_pair_gram_ref,
                               (a["xp"], a["d"], a["gp"], STP, S, Y, END), {}),
        "K4_trial_pair_gram_gp": (qk.trial_pair_gram, qk.trial_pair_gram_ref,
                                  (a["xp"], a["d"], a["gp"], STP, S, Y, END),
                                  dict(with_gp=True)),
        "K7_owlqn_trial": (qk.owlqn_trial, qk.owlqn_trial_ref,
                           (xp0, a["d"], wp, STP, 1.0, 0, hi), {}),
        "K8_owlqn_probe": (qk.owlqn_probe_pg, qk.owlqn_probe_pg_ref,
                           (xp0, a["d"], pg, STP, 1.0, 0, hi), {}),
        "K14_owlqn_trial_pair_gram": (qk.owlqn_trial_pair_gram, qk.owlqn_trial_pair_gram_ref,
                                      (xp0, a["d"], a["gp"], pg, STP, 1.0, 0, hi, S, Y, END),
                                      {}),
        "K14_owlqn_trial_pair_gram_gp": (qk.owlqn_trial_pair_gram,
                                         qk.owlqn_trial_pair_gram_ref,
                                         (xp0, a["d"], a["gp"], pg, STP, 1.0, 0, hi, S, Y,
                                          END), dict(with_gp=True)),
        "K15_combine_probe": (qk.combine_probe, qk.combine_probe_ref,
                              (a["gp"], a["xp"], S, Y, a["gamma"], a["cs"], a["cy"], 1.0), {}),
        "K15_combine_probe_fix": (qk.combine_probe, qk.combine_probe_ref,
                                  (a["gp"], a["xp"], S, Yq, a["gamma"], a["cs"], a["cy"], 1.0),
                                  dict(fix=(END, ca, cb))),
        "K16_combine_ow_probe": (qk.combine_ow_probe, qk.combine_ow_probe_ref,
                                 (pg, xp0, S, Y, a["gamma"], a["cs"], a["cy"], 1.0, 0, hi,
                                  1.0), {}),
    }
    cases.update({
        name + "_ex": ((lambda f=kern, x=args, kw=kw: f(*x, **kw)),
                       (lambda f=plain, x=args, kw=kw: f(*x, **kw)))
        for name, (kern, plain, args, kw) in ex_cases.items()})
    times, walls, timed_by = {}, {}, {}
    for name, (kern, plain) in cases.items():
        k_ms, p_ms, k_by, p_by = kernel_vs_plain(kern, plain, 20)
        times[name], timed_by[name] = (k_ms, p_ms), (k_by, p_by)
        walls[name] = (event_time(kern, 20), event_time(plain, 20))
    # the one kernel a single PyTorch call computes: the calibration
    # kernel's o = x + 1 (timed here only, used nowhere in the port)
    library = {"cal_null_launch": min(device_time(lambda: torch.add(xn, 1.0), 20)
                                      for _ in range(2)),
               # and R's column sums: torch's sum over the same axis
               R_NAME: min(device_time(lambda: rp.sum(dim=0), 20) for _ in range(2))}
    # each kernel's bound from this run's shapes: n = 2^24, 4-byte vectors,
    # a 2-byte history, m = M; R's from its [16384, 2] float32 partials
    bounds = {name: bound(name, N_NULL if name == "cal_null_launch" else N_BIG,
                          xp0.element_size(), S.element_size(), S.shape[0])
              for name in KERNELS if not name.endswith("_m80") and name != R_NAME}
    bounds[R_NAME] = r_bound(*rp.shape, rp.element_size())
    # what K15 replaces: K3 and one K2, two launches and 40 B/elem
    k3_k2 = dict(ms=times["K3_combine"][0] + times["K2_probe"][0],
                 bound_ms=bounds["K3_combine"][0] + bounds["K2_probe"][0])
    emit(phase="kernel_times", n=N_BIG, dtype="f32/bf16",
         device_ms={k: {"kernel": v[0], "plain": v[1], "bound": bounds[k][0]}
                    for k, v in times.items()},
         event_ms={k: {"kernel": v[0], "plain": v[1]} for k, v in walls.items()},
         timed_by={k: {"kernel": v[0], "plain": v[1]} for k, v in timed_by.items()},
         library_ms=library, k15_replaces_k3_plus_k2=k3_k2, r_vs_torch_sum=r_times)
    epilogue_compiled()
    pair_gram_compiled()
    del a, S, Y, Yf, x9, xn, wq, tq, qk, Yq, ex_cases
    torch.cuda.empty_cache()
    return {"errs": errs, "times": times, "bounds": bounds, "library": library,
            "timed_by": timed_by}


def check_factory(errs: dict, kern, a: dict, tag: str, tv: float, ts: float,
                  sfx: str = "") -> None:
    """K1, K2 and K4 (and its . gp form) of the factory objective whose
    kernels are ``kern`` (the Rosenbrock module, or an objective's
    ``.kernels``) against their plain versions; K4's ring row bit for bit
    the rounded pair of each side's own g, the . gp form's columns 0-2,
    other outputs and ring bit for bit the 3-column launch's.  Rows in
    ``errs`` carry the suffix ``sfx``."""
    k = kern.trial(a["xp"], a["d"], STP)
    p = kern.trial_ref(a["xp"], a["d"], STP)
    _fold(errs, "K1_trial" + sfx,
          check(f"K1{sfx} xt {tag}", k[0], p[0], tv),
          check(f"K1{sfx} g {tag}", k[2], p[2], tv),
          *(check(f"K1{sfx} sum{i} {tag}", k[i], p[i], ts) for i in (1, 3, 4, 5)))
    if bool(k[6]) != bool(p[6]):
        raise AssertionError(f"K1{sfx} changed flag differs {tag}")
    k = kern.probe(a["xp"], a["d"], STP)
    p = kern.probe_ref(a["xp"], a["d"], STP)
    _fold(errs, "K2_probe" + sfx,
          *(check(f"K2{sfx} {tag} {i}", k[i], p[i], ts) for i in (0, 1)))
    # K4 (the rings are written in place: each side gets a copy).  Row end
    # must hold s = STP*d and y = g - gp, each side's own g, rounded to the
    # history dtype, bit for bit
    Sk, Yk, Sp, Yp = (a["S"].clone(), a["Y"].clone(), a["S"].clone(), a["Y"].clone())
    k = kern.trial_pair_gram(a["xp"], a["d"], a["gp"], STP, Sk, Yk, END)
    p = kern.trial_pair_gram_ref(a["xp"], a["d"], a["gp"], STP, Sp, Yp, END)
    s = STP * a["d"]
    check_ring(f"K4{sfx} kernel {tag}", Sk, Yk, a["S"], a["Y"], s, k[2] - a["gp"])
    check_ring(f"K4{sfx} plain {tag}", Sp, Yp, a["S"], a["Y"], s, p[2] - a["gp"])
    _fold(errs, "K4_trial_pair_gram" + sfx,
          check(f"K4{sfx} x {tag}", k[0], p[0], tv),
          check(f"K4{sfx} g {tag}", k[2], p[2], tv),
          *(check(f"K4{sfx} sum{i} {tag}", k[i], p[i], ts) for i in (1, 3, 4, 5, 7, 8)))
    if bool(k[6]) != bool(p[6]):
        raise AssertionError(f"K4{sfx} changed flag differs {tag}")
    # K4 with the . gp column: the 3-column launch's outputs and ring bit
    # for bit, the column against the plain version
    Sg, Yg, Sq, Yq = (a["S"].clone(), a["Y"].clone(), a["S"].clone(), a["Y"].clone())
    kg = kern.trial_pair_gram(a["xp"], a["d"], a["gp"], STP, Sg, Yg, END, with_gp=True)
    pg_ = kern.trial_pair_gram_ref(a["xp"], a["d"], a["gp"], STP, Sq, Yq, END, with_gp=True)
    check_extends(f"K4{sfx}+gp {tag}", k, kg, (7, 8))
    if not (same_bits(Sg, Sk) and same_bits(Yg, Yk)):
        raise AssertionError(f"K4{sfx}+gp ring differs from the 3-column launch {tag}")
    _fold(errs, "K4_trial_pair_gram_gp" + sfx,
          check(f"K4{sfx}+gp g {tag}", kg[2], pg_[2], tv),
          *(check(f"K4{sfx}+gp sum{i} {tag}", kg[i], pg_[i], ts) for i in (7, 8)))


def quadratic_data(n: int, seed: int) -> tuple:
    """The weighted quadratic's extras (bench.py:127-135): w = 0.5 + U[0, 1)
    and t = N(0, 1), float32, from a seeded generator on the card."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    return (0.5 + torch.rand(n, generator=g, device="cuda"),
            torch.randn(n, generator=g, device="cuda"))


def check_extras(errs: dict, n: int) -> None:
    """Every factory kernel with extras (the quadratic's two, w and t)
    against its plain version at n, f32 vectors, bf16 history: K1, K2, K4
    (and . gp) by ``check_factory``; K15 (and its damped-row form) and K16
    by ``check_fusions`` (their probes bit for bit K2's and K8's, their
    directions K3's, K6's and K13's); K8 in both forms, K14 (and . gp) by
    ``check_owlqn``; K7 against K8 bit for bit by ``check_k7``, on both
    windows."""
    w, t = quadratic_data(n, SEED + 3 * n)
    obj = separable.quadratic(w, t)
    a = inputs(n, torch.float32, torch.bfloat16, SEED + n)
    tv, ts = TOL[(torch.float32, "vec")], TOL[(torch.float32, "sum")]
    tag = f"n={n} extras=2"
    check_factory(errs, obj.kernels, a, tag, tv, ts, "_ex")
    check_fusions(errs, a, n, tag, tv, ts, obj.kernels, "_ex")
    for lo, hi in windows(n):
        wt = f"{tag} window=[{lo},{hi})"
        check_owlqn(errs, a, lo, hi, wt, tv, ts, obj.kernels, "_ex")
        wp = choose_orthant(Orthantwise(C_L1, lo, hi), a["xp0"], a["pg"])
        check_k7(errs, obj.kernels, a, wp, fused.owlqn_trial_step(
            a["xp0"], a["d"], wp, STP, lo, hi), lo, hi, wt, tv, ts, "_ex")
    del a, w, t, obj
    torch.cuda.empty_cache()


def epilogue_compiled() -> None:
    """Registers and spills of every compiled form of K4 and K14 (the last
    launch of each: at n = 2^24 for f32/bf16, the ragged n for the other
    dtype pairs), with no extras (Rosenbrock) and with the quadratic's two
    and the quartic's one (the build phase's forms, which the extras paths
    run), and the 16- and 8-byte global loads in its PTX; a form that
    spills fails the phase (the launch in ``factory.EPILOGUE`` is chosen
    not to)."""
    forms = []
    objs = {"rosenbrock": rosenbrock, **WARM}
    for label, kern in objs.items():
        nex = 0 if label == "rosenbrock" else len(kern.extras)
        for form, fn in (("K4", kern.trial_pair_gram), ("K14", kern.owlqn_trial_pair_gram)):
            for (vd, hd, with_gp), k in sorted(fn.compiled.items(), key=str):
                k._init_handles()
                forms.append(dict(form=form + ("_gp" if with_gp else ""), objective=label,
                                  extras=nex, vectors=str(vd).removeprefix("torch."),
                                  history=str(hd).removeprefix("torch."), n_regs=k.n_regs,
                                  n_spills=k.n_spills,
                                  ld_global_v4=k.asm["ptx"].count("ld.global.v4"),
                                  ld_global_v2=k.asm["ptx"].count("ld.global.v2")))
    emit(phase="epilogue_compiled", launch={"/".join(str(t).removeprefix("torch.") for t in k): v
                                            for k, v in factory.EPILOGUE.items()},
         programs_max=factory.EPILOGUE_PROGRAMS, forms=forms)
    spilled = [f for f in forms if f["n_spills"]]
    if spilled:
        raise AssertionError(f"K4/K14 forms spill registers: {spilled}")


#: K5's and K12's instantiations in ptxas's mangled names: vector and
#: history type (f float, d double, 13__nv_bfloat16), ring rows MP, the
#: . gp column, K12's pair; and how many there are: three dtype pairs,
#: five row counts (1-4 and a group of 6), with and without . gp, each
#: kernel's pair; K12 b's five row counts (no . gp); K5 b's, with and
#: without . gp
PAIR_GRAM_KERNEL = re.compile(
    r"pair_gram_kernelI([fd])(13__nv_bfloat16|[fd])Li(\d+)ELb([01])ELb([01])ELb([01])E")
PAIR_GRAM_FORMS = 3 * 5 * 2 * 2 + 3 * 5 + 3 * 5 * 2
K5_TYPES = {"f": "float32", "d": "float64", "13__nv_bfloat16": "bfloat16"}


def ptxas_kernels(log: str) -> dict:
    """kernel (mangled name): registers, shared memory and spill bytes, from
    the ``-Xptxas=-v`` lines of the build log."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function '|Function properties for )([\w$]+)", line)
        if m:
            name = m.group(1)
            out.setdefault(name, {})
            continue
        if name is None:
            continue
        if m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line):
            out[name].update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        if m := re.search(r"Used (\d+) registers", line):
            out[name]["n_regs"] = int(m.group(1))
            smem = re.search(r"(\d+) bytes smem", line)
            out[name]["smem"] = int(smem.group(1)) if smem else 0
    return out


def pair_gram_forms() -> list:
    """Registers, shared memory and spills of every K5, K12, K12 b and K5 b
    instantiation in the build log."""
    forms = []
    for name, info in ptxas_kernels(_build.build_log()).items():
        m = PAIR_GRAM_KERNEL.search(name)
        if m:
            kernel = ("K12" if m.group(5) == "1" else "K5") + ("b" if m.group(6) == "1" else "")
            forms.append(dict(kernel=kernel, vectors=K5_TYPES[m.group(1)],
                              history=K5_TYPES[m.group(2)], rows=int(m.group(3)),
                              with_gp=m.group(4) == "1", **info))
    forms.sort(key=lambda f: (f["kernel"], f["vectors"], f["history"], f["rows"], f["with_gp"]))
    return forms


def pair_gram_compiled() -> list:
    """Registers, shared memory and spills of every K5, K12, K12 b and K5 b
    instantiation (``PAIR_GRAM_FORMS``) from the build log; a form that
    spills, or a log that does not show them all, fails the phase."""
    forms = pair_gram_forms()
    emit(phase="pair_gram_compiled", launch={"/".join(str(t).removeprefix("torch.") for t in k): v
                                             for k, v in fused.PAIR_GRAM.items()},
         blocks_max=fused.PAIR_GRAM_BLOCKS, forms=forms)
    if len(forms) != PAIR_GRAM_FORMS or any("n_regs" not in f or "spill_stores" not in f
                                            for f in forms):
        raise AssertionError(f"K5/K12: the build log shows {len(forms)} of {PAIR_GRAM_FORMS} "
                             "instantiations")
    spilled = [f for f in forms if f["spill_stores"] or f["spill_loads"]]
    if spilled:
        raise AssertionError(f"K5/K12 instantiations spill registers: {spilled}")
    return forms


def check_fusions(errs: dict, a: dict, n: int, tag: str, tv: float, ts: float,
                  kern=rosenbrock, sfx: str = "") -> None:
    """K15 and K16 against their plain versions at every stp1 of ``STP1``
    (K16 on both windows); their probe scalars bit for bit those of K2 at
    (x, r, stp1) and of K8's pg form at (x, rc, pg, stp1), in both
    objective-scalar modes (the remat contract); their directions bit for
    bit K3's, K6's and K13's (the CUDA combines round as the fusions do, so
    the step cap, which picks one or the other, does not change the
    trajectory), their r.r and r.g against those at the sum tolerance
    (another reduction tree).  ``kern`` and ``sfx`` as ``check_factory``'s."""
    xp, gp, pg, S, Y = a["xp"], a["gp"], a["pg"], a["S"], a["Y"]
    coefs = (a["gamma"], a["cs"], a["cy"])
    k3 = fused.combine(gp, S, Y, *coefs)
    for stp1 in STP1:
        t = f"{tag} stp1={stp1}"
        k = kern.combine_probe(gp, xp, S, Y, *coefs, stp1)
        p = kern.combine_probe_ref(gp, xp, S, Y, *coefs, stp1)
        if not same_bits(k[0], k3[0]):
            raise AssertionError(f"K15{sfx}'s r differs from K3's in "
                                 f"{int((k[0] != k3[0]).sum())} elements {t}")
        _fold(errs, "K15_combine_probe" + sfx, check(f"K15{sfx} r {t}", k[0], p[0], tv),
              *(check(f"K15{sfx} sum{i} {t}", k[i], p[i], ts) for i in (1, 2, 3, 4)),
              *(check(f"K15{sfx} sum{i} vs K3 {t}", k[i], k3[i], ts) for i in (1, 2)))
        for wide in (False, True):
            with fused.wide_fx(wide):
                kw = kern.combine_probe(gp, xp, S, Y, *coefs, stp1)
                k2 = kern.probe(xp, kw[0], stp1)
            if not (same_bits(kw[3], k2[0]) and same_bits(kw[4], k2[1])):
                raise AssertionError(f"K15{sfx}'s probe differs from K2's (wide={wide}) {t}: "
                                     f"{kw[3].item()} {k2[0].item()}")
    # K15's damped-row form: the fixed ring bit for bit the plain
    # version's and K6's, the probe bit for bit K2's at its r
    ca, cb = (torch.tensor(v, dtype=gp.dtype, device="cuda") for v in (0.7, -0.2))
    Yk, Yp, Y6 = Y.clone(), Y.clone(), Y.clone()
    k = kern.combine_probe(gp, xp, S, Yk, *coefs, 0.37, fix=(END, ca, cb))
    p = kern.combine_probe_ref(gp, xp, S, Yp, *coefs, 0.37, fix=(END, ca, cb))
    k6 = fused.combine_fix(gp, S, Y6, *coefs, END, ca, cb)
    if not (same_bits(Yk, Yp) and same_bits(Yk, Y6)):
        raise AssertionError(f"K15{sfx}'s damped row differs from the plain version's or "
                             f"K6's {tag}")
    if not same_bits(k[0], k6[0]):
        raise AssertionError(f"K15{sfx}'s fix form's r differs from K6's in "
                             f"{int((k[0] != k6[0]).sum())} elements {tag}")
    k2 = kern.probe(xp, k[0], 0.37)
    if not (same_bits(k[3], k2[0]) and same_bits(k[4], k2[1])):
        raise AssertionError(f"K15{sfx}'s damped-row form's probe differs from K2's {tag}")
    _fold(errs, "K15_combine_probe_fix" + sfx, check(f"K15{sfx} fix r {tag}", k[0], p[0], tv),
          *(check(f"K15{sfx} fix sum{i} {tag}", k[i], p[i], ts) for i in (1, 2, 3, 4)),
          *(check(f"K15{sfx} fix sum{i} vs K6 {tag}", k[i], k6[i], ts) for i in (1, 2)))
    del Yk, Yp, Y6, k6
    for lo, hi in windows(n):
        k13 = fused.combine_ow(pg, S, Y, *coefs, lo, hi)
        for stp1 in STP1:
            t = f"{tag} window=[{lo},{hi}) stp1={stp1}"
            k = kern.combine_ow_probe(pg, a["xp0"], S, Y, *coefs, C_L1, lo, hi, stp1)
            p = kern.combine_ow_probe_ref(pg, a["xp0"], S, Y, *coefs, C_L1, lo, hi, stp1)
            if not same_bits(k[0], k13[0]):
                raise AssertionError(f"K16{sfx}'s rc differs from K13's in "
                                     f"{int((k[0] != k13[0]).sum())} elements {t}")
            _fold(errs, "K16_combine_ow_probe" + sfx, check(f"K16{sfx} rc {t}", k[0], p[0], tv),
                  *(check(f"K16{sfx} sum{i} {t}", k[i], p[i], ts) for i in (1, 2, 3, 4, 5)),
                  *(check(f"K16{sfx} sum{i} vs K13 {t}", k[i], k13[i], ts) for i in (1, 2, 3)))
            for wide in (False, True):
                with fused.wide_fx(wide):
                    kw = kern.combine_ow_probe(pg, a["xp0"], S, Y, *coefs, C_L1, lo, hi,
                                               stp1)
                    k8 = kern.owlqn_probe_pg(a["xp0"], kw[0], pg, stp1, C_L1, lo, hi)
                if not (same_bits(kw[4], k8[0]) and same_bits(kw[5], k8[1])):
                    raise AssertionError(f"K16{sfx}'s probe differs from K8's (wide={wide}) {t}: "
                                         f"{kw[4].item()} {k8[0].item()}")


def check_k17_null(errs: dict) -> None:
    """K17 at n = 2^24 and at N_RAGGED in both vector dtypes (z bit for bit
    the plain version's: the product and the sum are rounded one by one),
    and the calibration kernel bit for bit."""
    g = torch.Generator(device="cuda").manual_seed(SEED + 17)
    for n in (N_BIG, N_RAGGED):
        for vd in (torch.float32, torch.float64):
            y, x, w = (torch.randn(n, generator=g, device="cuda", dtype=vd) for _ in range(3))
            k = fused.axpy_dot(y, x, 0.37, w)
            p = fused.axpy_dot_ref(y, x, 0.37, w)
            if not same_bits(k[0], p[0]):
                raise AssertionError(f"K17's z differs from the plain version's n={n} {vd}")
            _fold(errs, "K17_axpy_dot", check(f"K17 z.w n={n} {vd}", k[1], p[1],
                                              TOL[(vd, "sum")]))
    x = torch.randn(N_NULL, generator=g, device="cuda")
    if not same_bits(profiling.null_launch(x), profiling.null_launch_ref(x)):
        raise AssertionError("the calibration kernel differs from x + 1")
    _fold(errs, "cal_null_launch", (0.0, 0.0))


#: R's checks: the row counts of the paths' partials (the batched
#: kernels' 16 programs an instance at 2^14, K2's 1024 and 16384 at 2^20
#: and 2^24, the epilogue's 4224) and odd ones, at the widths the wrappers
#: pass (1-8 lanes, K1's 5, 4 + 6m at m = 6 and 80)
R_ROWS = (1, 16, 33, 1024, 3001, 4224, 16384)
R_WIDTHS = (1, 2, 5, 8, 4 + 6 * M, 4 + 6 * 80)
#: R's timed shapes: K2's and K15's [16384, 2] at n = 2^24 (the kernel
#: table's row), K2 s's four lanes, K8 b s's four lanes per instance at
#: 1024 x 2^14
R_TIMED = {"p16384_c2": ((N_BIG // 1024, 2), 0), "p16384_c4": ((N_BIG // 1024, 4), 0),
           "b1024_p16_c8": ((1024, 16, 8), 1)}


def check_r(errs: dict) -> dict:
    """R (``fused.reduce_partials``) at ``R_ROWS`` x ``R_WIDTHS``, in float32,
    float64 and the wide form, one instance and a batch of three: its sums
    bit for bit its order twin's (``fused.reduce_partials_order_ref`` in
    torch ops) and within the sum tolerance of a float64 sum; a column's
    bits the same at every width, in every instance and through a strided
    view.  Then R at ``R_TIMED`` beside torch's sum over the same axis,
    in turns (torch, R, R, torch).  Returns the timed shapes' ms."""
    lib = _build.load_library()
    if fused.PARTIAL_LANES != lib.lbfgs_partials_lanes() or any(
            fused.partials_scratch(*bpc) != lib.lbfgs_partials_scratch(*bpc)
            for bpc in ((1, 16384, 2), (1, 16384, 40), (3, 4224, 40), (3, 1024, 484),
                        (2, 8192, 32))):
        raise AssertionError("R's lanes or scratch rule differ between the source and fused")
    g = torch.Generator(device="cuda").manual_seed(SEED + 40)
    for P in R_ROWS:
        for vd, wide in ((torch.float32, False), (torch.float64, False), (torch.float32, True)):
            tol = TOL[(torch.float64 if wide else vd, "sum")]
            col = torch.randn(P, generator=g, device="cuda", dtype=vd)
            want = fused.reduce_partials(col, 0, wide)
            for C in R_WIDTHS:
                x = torch.randn(3, P, C, generator=g, device="cuda", dtype=vd)
                j = C // 3
                x[1, :, j] = col
                for t, dim in ((x[1], 0), (x, 1)):
                    got = fused.reduce_partials(t, dim, wide)
                    if not same_bits(got, fused.reduce_partials_order_ref(t, dim, wide)):
                        raise AssertionError(f"R P={P} C={C} {vd} wide={wide}: not its "
                                             f"order's bits")
                    _fold(errs, R_NAME, check(f"R P={P} C={C} {vd} wide={wide}", got,
                                              t.double().sum(dim=dim), tol))
                cols = (fused.reduce_partials(x[1], 0, wide)[j],
                        fused.reduce_partials(x[1, :, j], 0, wide),
                        fused.reduce_partials(x, 1, wide)[1, j],
                        fused.reduce_partials(x[:, :, j], 1, wide)[1])
                if not all(same_bits(c, want) for c in cols):
                    raise AssertionError(f"R P={P} C={C} {vd} wide={wide}: a column's sum "
                                         f"depends on the array around it")
    times = {}
    for key, (shape, dim) in R_TIMED.items():
        x = torch.randn(shape, generator=g, device="cuda")
        lib, mine = (lambda: x.sum(dim=dim)), (lambda: fused.reduce_partials(x, dim))
        t1, k1, k2, t2 = (device_time(f, 20) for f in (lib, mine, mine, lib))
        times[key] = dict(torch_ms=min(t1, t2), ms=min(k1, k2), runs=[t1, k1, k2, t2])
    emit(phase="partials", rows=list(R_ROWS), widths=list(R_WIDTHS), batch=3,
         order_twin="bit-exact", column_vs_width_batch_view="bit-exact",
         lanes=fused.PARTIAL_LANES, max_normwise_err=errs[R_NAME][1], times=times)
    return times


def check_owlqn(errs: dict, a: dict, lo: int, hi: int, tag: str, tv: float,
                ts: float, kern=rosenbrock, sfx: str = "") -> None:
    """K8 (both forms), K10, K13 and K14 against their plain versions on
    one window; K8's two forms bit for bit against each other, K14's ring
    write bit for bit.  ``kern`` and ``sfx`` as ``check_factory``'s (K10
    and K13, which never see the objective, with the Rosenbrock kernels
    only)."""
    xp, d, gp, pg = a["xp0"], a["d"], a["gp"], a["pg"]
    wp = choose_orthant(Orthantwise(C_L1, lo, hi), xp, pg)
    # K8: materialized orthant and the orthant rebuilt from (xp, pg)
    k = kern.owlqn_probe(xp, d, wp, STP, C_L1, lo, hi)
    p = kern.owlqn_probe_ref(xp, d, wp, STP, C_L1, lo, hi)
    k2 = kern.owlqn_probe_pg(xp, d, pg, STP, C_L1, lo, hi)
    p2 = kern.owlqn_probe_pg_ref(xp, d, pg, STP, C_L1, lo, hi)
    _fold(errs, "K8_owlqn_probe" + sfx,
          *(check(f"K8{sfx} wp {tag} {i}", k[i], p[i], ts) for i in (0, 1)),
          *(check(f"K8{sfx} pg {tag} {i}", k2[i], p2[i], ts) for i in (0, 1)))
    if not (same_bits(k[0], k2[0]) and same_bits(k[1], k2[1])):
        raise AssertionError(f"K8{sfx}'s two forms differ {tag}: {k} {k2}")
    if not sfx:
        # K10 on a point with exact zeros
        k = fused.pseudo_gradient_norm(xp, gp, C_L1, lo, hi)
        p = fused.pseudo_gradient_norm_ref(xp, gp, C_L1, lo, hi)
        _fold(errs, "K10_pseudo_gradient_norm", check(f"K10 pg {tag}", k[0], p[0], tv),
              check(f"K10 pg.pg {tag}", k[1], p[1], ts))
        # K13 with d = pg
        args = (pg, a["S"], a["Y"], a["gamma"], a["cs"], a["cy"], lo, hi)
        k = fused.combine_ow(*args)
        p = fused.combine_ow_ref(*args)
        _fold(errs, "K13_combine_ow", check(f"K13 rc {tag}", k[0], p[0], tv),
              *(check(f"K13 sum{i} {tag}", k[i], p[i], ts) for i in (1, 2, 3)))
    # K14: the ring row is the pair of each side's own projected x and g
    Sk, Yk, Sp, Yp = (a["S"].clone(), a["Y"].clone(), a["S"].clone(), a["Y"].clone())
    k = kern.owlqn_trial_pair_gram(xp, d, gp, pg, STP, C_L1, lo, hi, Sk, Yk, END)
    p = kern.owlqn_trial_pair_gram_ref(xp, d, gp, pg, STP, C_L1, lo, hi, Sp, Yp, END)
    check_ring(f"K14{sfx} kernel {tag}", Sk, Yk, a["S"], a["Y"], k[0] - xp, k[1] - gp)
    check_ring(f"K14{sfx} plain {tag}", Sp, Yp, a["S"], a["Y"], p[0] - xp, p[1] - gp)
    _fold(errs, "K14_owlqn_trial_pair_gram" + sfx,
          *(check(f"K14{sfx} {name} {tag}", k[i], p[i], tv)
            for i, name in ((0, "x"), (1, "g"), (2, "pg"))),
          *(check(f"K14{sfx} sum{i} {tag}", k[i], p[i], ts) for i in (3, 4, 5, 6)))
    if bool(k[7]) != bool(p[7]):
        raise AssertionError(f"K14{sfx} changed flag differs {tag}")
    # K14 with the . gp column, gp.gp and gp.pg: the 3-column launch's
    # outputs and ring bit for bit, the rest against the plain version
    Sg, Yg, Sq, Yq = (a["S"].clone(), a["Y"].clone(), a["S"].clone(), a["Y"].clone())
    kg = kern.owlqn_trial_pair_gram(xp, d, gp, pg, STP, C_L1, lo, hi, Sg, Yg, END,
                                    with_gp=True)
    pg_ = kern.owlqn_trial_pair_gram_ref(xp, d, gp, pg, STP, C_L1, lo, hi, Sq, Yq, END,
                                         with_gp=True)
    check_extends(f"K14{sfx}+gp {tag}", k, kg[:8], (3, 4))
    if not (same_bits(Sg, Sk) and same_bits(Yg, Yk)):
        raise AssertionError(f"K14{sfx}+gp ring differs from the 3-column launch {tag}")
    _fold(errs, "K14_owlqn_trial_pair_gram_gp" + sfx,
          check(f"K14{sfx}+gp pg {tag}", kg[2], pg_[2], tv),
          *(check(f"K14{sfx}+gp sum{i} {tag}", kg[i], pg_[i], ts) for i in (3, 4, 8, 9)))


def check_composed(errs: dict, a: dict, lo: int, hi: int, tag: str, tv: float,
                   ts: float) -> None:
    """K9, K11, K12 and K7 against their plain versions on one window, bit
    for bit where the issue is a rounding rule: K9's projected point
    (round(xp + round(stp*d)), no fma), K11's pg against K10's, K12's ring
    rows (the rounded pair of K9's point), K7's point against K9's, and
    K7's ft and g.d against K8's at the same step and orthant in both
    objective-scalar modes (the remat contract)."""
    xp, d, gp, pg = a["xp0"], a["d"], a["gp"], a["pg"]
    wp = choose_orthant(Orthantwise(C_L1, lo, hi), xp, pg)
    x = fused.owlqn_trial_step(xp, d, wp, STP, lo, hi)
    if not same_bits(x, fused.owlqn_trial_step_ref(xp, d, wp, STP, lo, hi)):
        raise AssertionError(f"K9's point differs from the plain version's {tag}")
    k = fused.pseudo_gradient(xp, gp, C_L1, lo, hi)
    if not same_bits(k, fused.pseudo_gradient_norm(xp, gp, C_L1, lo, hi)[0]):
        raise AssertionError(f"K11's pg differs from K10's {tag}")
    _fold(errs, "K11_pseudo_gradient",
          check(f"K11 pg {tag}", k, fused.pseudo_gradient_ref(xp, gp, C_L1, lo, hi), tv))
    # K12 on K9's point, with the random pg as the new gradient
    check_k12(errs, tag, ts, x, xp, a["pg"], gp, k, a["S"], a["Y"], END)
    check_k7(errs, rosenbrock, a, wp, x, lo, hi, tag, tv, ts)
    _fold(errs, "K9_owlqn_trial_step", (0.0, 0.0))


def check_k7(errs: dict, kern, a: dict, wp, x9, lo: int, hi: int, tag: str, tv: float,
             ts: float, sfx: str = "") -> None:
    """K7 against its plain version on one window, its point bit for bit
    K9's (``x9``), and its ft and g.d bit for bit K8's at the same step and
    orthant in both objective-scalar modes (the remat contract); ``kern``
    and ``sfx`` as ``check_factory``'s."""
    xp, d = a["xp0"], a["d"]
    for wide in (False, True):
        with fused.wide_fx(wide):
            k7 = kern.owlqn_trial(xp, d, wp, STP, C_L1, lo, hi)
            k8 = kern.owlqn_probe(xp, d, wp, STP, C_L1, lo, hi)
            p = kern.owlqn_trial_ref(xp, d, wp, STP, C_L1, lo, hi)
        want = torch.float64 if wide or xp.dtype == torch.float64 else xp.dtype
        if k7[1].dtype != want or p[1].dtype != want:
            raise AssertionError(f"K7{sfx} ft dtype {k7[1].dtype}, plain {p[1].dtype} {tag}")
        if not (same_bits(k7[1], k8[0]) and same_bits(k7[3], k8[1])):
            raise AssertionError(f"K7{sfx} and K8 differ at one step (wide={wide}) {tag}: "
                                 f"{k7[1].item()} {k8[0].item()}")
        if not same_bits(k7[0], x9):
            raise AssertionError(f"K7{sfx}'s point differs from K9's {tag}")
        _fold(errs, "K7_owlqn_trial" + sfx,
              *(check(f"K7{sfx} {name} {tag}", k7[i], p[i], tv)
                for i, name in ((0, "x"), (2, "g"))),
              *(check(f"K7{sfx} sum{i} {tag}", k7[i], p[i], ts) for i in (1, 3, 4)))
        if bool(k7[5]) != bool(p[5]):
            raise AssertionError(f"K7{sfx} changed flag differs {tag}")


#: K5's ring depths and new rows in the kernel checks: the main path's,
#: the north star's, and one that takes two groups of ring rows with the
#: new row in the second
K5_RINGS = ((M, END), (3, END), (2 * M, END + M))


def check_k5(errs: dict, tag: str, ts: float, d, gx, gp, S, Y, end: int) -> None:
    """K5 (3 and 4 columns) against its plain version: the ring write bit
    for bit (row ``end`` the rounded (STP*d, gx - gp)), the 4-column
    launch's columns 0-2 and rings bit for bit the 3-column launch's, the
    sums at the sum tolerance."""
    S3, Y3, S4, Y4, Sp, Yp = (S.clone(), Y.clone(), S.clone(), Y.clone(), S.clone(),
                              Y.clone())
    k3 = fused.pair_gram_sd(STP, d, gx, gp, S3, Y3, end)
    k4 = fused.pair_gram_sd(STP, d, gx, gp, S4, Y4, end, with_gp=True)
    p4 = fused.pair_gram_sd_ref(STP, d, gx, gp, Sp, Yp, end, with_gp=True)
    check_ring(f"K5 kernel {tag}", S3, Y3, S, Y, STP * d, gx - gp, end)
    check_ring(f"K5 plain {tag}", Sp, Yp, S, Y, STP * d, gx - gp, end)
    check_extends(f"K5 4 columns {tag}", k3, k4, (0, 1))
    if not (same_bits(S4, S3) and same_bits(Y4, Y3)):
        raise AssertionError(f"K5's two forms wrote different rings {tag}")
    _fold(errs, "K5_pair_gram", *(check(f"K5 {tag} {i}", k4[i], p4[i], ts) for i in (0, 1)))


#: K12's ring depths and new rows in the kernel checks: one row, the north
#: star's 3, the main path's 6, and two groups of ring rows with the new
#: row in the second (m = 80 in the deep-history phase)
K12_RINGS = ((1, 0), (3, END), (M, END), (2 * M, END + M))


def check_k12(errs: dict, tag: str, ts: float, x, xp, gx, gp, pg, S, Y, end: int) -> None:
    """K12 (3 columns and . gp) against its plain version: the ring write
    bit for bit (row ``end`` the rounded (x - xp, gx - gp)), the . gp
    launch's columns 0-2 and rings bit for bit the 3-column launch's, the
    sums at the sum tolerance."""
    Sk, Yk, Sg, Yg, Sp, Yp = (S.clone(), Y.clone(), S.clone(), Y.clone(), S.clone(),
                              Y.clone())
    k = fused.pair_gram_xg(x, xp, gx, gp, pg, Sk, Yk, end)
    p = fused.pair_gram_xg_ref(x, xp, gx, gp, pg, Sp, Yp, end)
    check_ring(f"K12 kernel {tag}", Sk, Yk, S, Y, x - xp, gx - gp, end)
    check_ring(f"K12 plain {tag}", Sp, Yp, S, Y, x - xp, gx - gp, end)
    _fold(errs, "K12_pair_gram_xg", *(check(f"K12 {tag} {i}", k[i], p[i], ts) for i in (0, 1)))
    Sp.copy_(S)
    Yp.copy_(Y)
    kg = fused.pair_gram_xg(x, xp, gx, gp, pg, Sg, Yg, end, with_gp=True)
    p = fused.pair_gram_xg_ref(x, xp, gx, gp, pg, Sp, Yp, end, with_gp=True)
    if not (same_bits(Sg, Sk) and same_bits(Yg, Yk)):
        raise AssertionError(f"K12 . gp's ring rows differ from the 3-column launch's {tag}")
    check_extends(f"K12 . gp {tag}", k, kg, (0, 1))
    _fold(errs, "K12_pair_gram_xg_gp",
          *(check(f"K12 . gp {tag} {i}", kg[i], p[i], ts) for i in range(4)))


def misaligned(t: torch.Tensor) -> torch.Tensor:
    """t's values in a contiguous view one element past an aligned start,
    which takes the pair + Gram kernels' per-element loads."""
    out = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)[1:].view(t.shape)
    return out.copy_(t)


def check_k12_depths(errs: dict, a: dict, tag: str, ts: float) -> None:
    """K12 (``check_k12``) at each depth of ``K12_RINGS`` on K9's point of
    the window [0, n - 1), and at m = 6 with its five vectors in misaligned
    views (the rings it writes are aligned copies), which takes the
    kernel's per-element loads."""
    xp, d, gp, pg, n = a["xp0"], a["d"], a["gp"], a["pg"], a["xp0"].shape[0]
    x = fused.owlqn_trial_step(xp, d, torch.sign(xp), STP, 0, n - 1)
    for m, end in K12_RINGS:
        Sm = torch.cat([a["S"], a["Y"]])[:m] if m > M else a["S"][:m]
        Ym = torch.cat([a["Y"], a["S"]])[:m] if m > M else a["Y"][:m]
        check_k12(errs, f"{tag} m={m}", ts, x, xp, pg, gp, a["xp"], Sm.contiguous(),
                  Ym.contiguous(), end)
        del Sm, Ym
    vectors = [misaligned(t) for t in (x, xp, pg, gp, a["xp"])]
    check_k12(errs, f"{tag} misaligned", ts, *vectors, a["S"], a["Y"], END)


def check_k5_k6(errs: dict, a: dict, tag: str, tv: float, ts: float) -> None:
    """K5 at each depth of ``K5_RINGS`` (``check_k5``; gx here the random
    pg) and K6 against their plain versions: K6's fixed row round(ca*Y[END]
    + cb*g) bit for bit the plain version's, the other rows untouched."""
    d, gx, gp, S, Y = a["d"], a["pg"], a["gp"], a["S"], a["Y"]
    for m, end in K5_RINGS:
        # rings of m rows from the inputs' M
        Sm = torch.cat([S, Y])[:m] if m > M else S[:m]
        Ym = torch.cat([Y, S])[:m] if m > M else Y[:m]
        check_k5(errs, f"{tag} m={m}", ts, d, gx, gp, Sm.contiguous(), Ym.contiguous(), end)
        del Sm, Ym
    ca, cb = (torch.tensor(v, dtype=d.dtype, device="cuda") for v in (0.7, -0.2))
    Yk, Yq = Y.clone(), Y.clone()
    k = fused.combine_fix(gp, S, Yk, a["gamma"], a["cs"], a["cy"], END, ca, cb)
    p = fused.combine_fix_ref(gp, S, Yq, a["gamma"], a["cs"], a["cy"], END, ca, cb)
    if not same_bits(Yk, Yq):
        raise AssertionError(f"K6's fixed ring differs from the plain version's {tag}")
    keep = [j for j in range(M) if j != END]
    if not same_bits(Yk[keep], Y[keep]):
        raise AssertionError(f"K6 changed rows other than end {tag}")
    _fold(errs, "K6_combine_fix", check(f"K6 r {tag}", k[0], p[0], tv),
          *(check(f"K6 sum{i} {tag}", k[i], p[i], ts) for i in (1, 2)))


#: the extras paths' objectives, whose launches and plain calls the counts
#: include, by name
EXTRAS = {}
#: the factory's plain versions, by attribute name
FACTORY_REFS = ("trial_ref", "probe_ref", "trial_pair_gram_ref", "owlqn_trial_ref",
                "owlqn_probe_ref", "owlqn_probe_pg_ref", "owlqn_trial_pair_gram_ref",
                "combine_probe_ref", "combine_ow_probe_ref", "probe_batched_ref",
                "trial_pair_gram_batched_ref", "owlqn_probe_pg_batched_ref",
                "owlqn_trial_pair_gram_batched_ref", "combine_probe_batched_ref",
                "combine_ow_probe_batched_ref", "trial_batched_ref", "owlqn_trial_batched_ref",
                "probe_steps_ref", "owlqn_probe_steps_ref", "probe_steps_batched_ref",
                "owlqn_probe_pg_steps_batched_ref")
FACTORY_WRAPPERS = ("trial", "probe", "trial_pair_gram", "owlqn_trial", "owlqn_probe",
                    "owlqn_probe_pg", "owlqn_trial_pair_gram", "combine_probe",
                    "combine_ow_probe", "probe_batched", "trial_pair_gram_batched",
                    "owlqn_probe_pg_batched", "owlqn_trial_pair_gram_batched",
                    "combine_probe_batched", "combine_ow_probe_batched", "trial_batched",
                    "owlqn_trial_batched", "probe_steps", "owlqn_probe_steps",
                    "probe_steps_batched", "owlqn_probe_pg_steps_batched")
#: the K-lane probes, whose lanes are counted too (``.lanes``)
LANE_PROBES = ("probe_steps", "owlqn_probe_steps", "probe_steps_batched",
               "owlqn_probe_pg_steps_batched")


def _factory_launches(k, sfx: str) -> dict:
    """The launches of one factory objective's kernels ``k`` under the
    table's names, each with the suffix ``sfx``."""
    tpg, ow_tpg, cp = k.trial_pair_gram, k.owlqn_trial_pair_gram, k.combine_probe
    cp_ow = k.combine_ow_probe
    out = {
        "K1_trial" + sfx: k.trial.launches,
        "K2_probe" + sfx: k.probe.launches,
        "K7_owlqn_trial" + sfx: k.owlqn_trial.launches,
        "K8_owlqn_probe" + sfx: k.owlqn_probe.launches + k.owlqn_probe_pg.launches,
    }
    # the static forms (at most factory.MAX_M ring rows) of K4, K14, K15 and
    # K16, each with its flagged form, and their deep forms (the ``_m80``
    # rows, Rosenbrock's only: no path runs an objective with extras that
    # deep)
    for name, fn, flag in (("K4_trial_pair_gram", tpg, "gp"),
                           ("K14_owlqn_trial_pair_gram", ow_tpg, "gp"),
                           ("K15_combine_probe", cp, "fix"), ("K16_combine_ow_probe", cp_ow, None)):
        flagged = getattr(fn, flag + "_launches") if flag else 0
        deep_flagged = getattr(fn, f"deep_{flag}_launches") if flag else 0
        out[name + sfx] = fn.launches - flagged - (fn.deep_launches - deep_flagged)
        if flag:
            out[f"{name}_{flag}{sfx}"] = flagged - deep_flagged
        if not sfx:
            out[name + "_m80"] = fn.deep_launches - deep_flagged
            if flag:
                out[f"{name}_{flag}_m80"] = deep_flagged
    return out


def _batched_forms(k) -> dict:
    """The launches of the batched epilogues and fusions ``k`` under the
    table's names: the static forms (at most factory.MAX_M ring rows) and
    the deep forms (``_m80``) apart, each with its flagged form (the
    epilogues' . gp, K15 b's fix) apart."""
    out = {}
    for name, fn, flag in (("K4b_trial_pair_gram_batched", k.trial_pair_gram_batched, "gp"),
                           ("K14b_owlqn_trial_pair_gram_batched",
                            k.owlqn_trial_pair_gram_batched, "gp"),
                           ("K15b_combine_probe_batched", k.combine_probe_batched, "fix"),
                           ("K16b_combine_ow_probe_batched", k.combine_ow_probe_batched, None)):
        flagged = getattr(fn, flag + "_launches") if flag else 0
        deep_flagged = getattr(fn, f"deep_{flag}_launches") if flag else 0
        out[name] = fn.launches - flagged - (fn.deep_launches - deep_flagged)
        out[name + "_m80"] = fn.deep_launches - deep_flagged
        if flag:
            out[f"{name}_{flag}"] = flagged - deep_flagged
            out[f"{name}_{flag}_m80"] = deep_flagged
    return out


def launches() -> dict:
    """Every counted kernel's launches since the last ``reset_counts``: the
    Rosenbrock objective's factory kernels, the CUDA kernels, and the
    factory kernels of the objectives with extras (``_ex``, summed)."""
    out = {
        **_factory_launches(rosenbrock.value_and_grad.kernels, ""),
        "K3_combine": fused.combine.launches,
        "K5_pair_gram": fused.pair_gram_sd.launches,
        "K6_combine_fix": fused.combine_fix.launches,
        "K9_owlqn_trial_step": fused.owlqn_trial_step.launches,
        "K10_pseudo_gradient_norm": fused.pseudo_gradient_norm.launches,
        "K11_pseudo_gradient": fused.pseudo_gradient.launches,
        "K12_pair_gram_xg": fused.pair_gram_xg.launches - fused.pair_gram_xg.gp_launches,
        "K12_pair_gram_xg_gp": fused.pair_gram_xg.gp_launches,
        "K13_combine_ow": fused.combine_ow.launches,
        "K17_axpy_dot": fused.axpy_dot.launches,
        "cal_null_launch": profiling.null_launch.launches,
        "R_reduce_partials": fused.reduce_partials.launches,
        "K2b_probe_batched": rosenbrock.value_and_grad.kernels.probe_batched.launches,
        "K3b_combine_batched": fused.combine_batched.launches,
        "K6b_combine_fix_batched": fused.combine_fix_batched.launches,
        "K8b_owlqn_probe_batched":
            rosenbrock.value_and_grad.kernels.owlqn_probe_pg_batched.launches,
        "K13b_combine_ow_batched": fused.combine_ow_batched.launches,
        "K10b_pseudo_gradient_norm_batched": fused.pseudo_gradient_norm_batched.launches,
        "K9b_owlqn_trial_step_batched": fused.owlqn_trial_step_batched.launches,
        "K11b_pseudo_gradient_batched": fused.pseudo_gradient_batched.launches,
        "K12b_pair_gram_xg_batched": fused.pair_gram_xg_batched.launches,
        "K1b_trial_batched": rosenbrock.value_and_grad.kernels.trial_batched.launches,
        "K7b_owlqn_trial_batched": rosenbrock.value_and_grad.kernels.owlqn_trial_batched.launches,
        "K5b_pair_gram_batched": (fused.pair_gram_sd_batched.launches
                                  - fused.pair_gram_sd_batched.gp_launches),
        "K5b_pair_gram_batched_gp": fused.pair_gram_sd_batched.gp_launches,
        **_batched_forms(rosenbrock.value_and_grad.kernels),
        "K2s_probe_steps": rosenbrock.value_and_grad.kernels.probe_steps.launches,
        "K8s_owlqn_probe_steps": rosenbrock.value_and_grad.kernels.owlqn_probe_steps.launches,
        "K2bs_probe_steps_batched":
            rosenbrock.value_and_grad.kernels.probe_steps_batched.launches,
        "K8bs_owlqn_probe_steps_batched":
            rosenbrock.value_and_grad.kernels.owlqn_probe_pg_steps_batched.launches,
    }
    ex = dict.fromkeys(_factory_launches(rosenbrock.value_and_grad.kernels, "_ex"), 0)
    for obj in EXTRAS.values():
        for name, v in _factory_launches(obj.kernels, "_ex").items():
            ex[name] += v
    return {**out, **ex}


#: the plain versions
PLAIN = {
    "K1_trial": rosenbrock.trial_ref,
    "K2_probe": rosenbrock.probe_ref,
    "K3_combine": fused.combine_ref,
    "K4_trial_pair_gram": rosenbrock.trial_pair_gram_ref,
    "K8_owlqn_probe": rosenbrock.owlqn_probe_ref,
    "K8_owlqn_probe_pg": rosenbrock.owlqn_probe_pg_ref,
    "K10_pseudo_gradient_norm": fused.pseudo_gradient_norm_ref,
    "K13_combine_ow": fused.combine_ow_ref,
    "K14_owlqn_trial_pair_gram": rosenbrock.owlqn_trial_pair_gram_ref,
    "K5_pair_gram": fused.pair_gram_sd_ref,
    "K6_combine_fix": fused.combine_fix_ref,
    "K7_owlqn_trial": rosenbrock.owlqn_trial_ref,
    "K9_owlqn_trial_step": fused.owlqn_trial_step_ref,
    "K11_pseudo_gradient": fused.pseudo_gradient_ref,
    "K12_pair_gram_xg": fused.pair_gram_xg_ref,
    "K15_combine_probe": rosenbrock.combine_probe_ref,
    "K16_combine_ow_probe": rosenbrock.combine_ow_probe_ref,
    "K17_axpy_dot": fused.axpy_dot_ref,
    "cal_null_launch": profiling.null_launch_ref,
    "K2b_probe_batched": rosenbrock.value_and_grad.kernels.probe_batched_ref,
    "K4b_trial_pair_gram_batched": rosenbrock.value_and_grad.kernels.trial_pair_gram_batched_ref,
    "K3b_combine_batched": fused.combine_batched_ref,
    "K6b_combine_fix_batched": fused.combine_fix_batched_ref,
    "K8b_owlqn_probe_batched": rosenbrock.value_and_grad.kernels.owlqn_probe_pg_batched_ref,
    "K14b_owlqn_trial_pair_gram_batched":
        rosenbrock.value_and_grad.kernels.owlqn_trial_pair_gram_batched_ref,
    "K13b_combine_ow_batched": fused.combine_ow_batched_ref,
    "K10b_pseudo_gradient_norm_batched": fused.pseudo_gradient_norm_batched_ref,
    "K15b_combine_probe_batched": rosenbrock.value_and_grad.kernels.combine_probe_batched_ref,
    "K16b_combine_ow_probe_batched":
        rosenbrock.value_and_grad.kernels.combine_ow_probe_batched_ref,
    "K9b_owlqn_trial_step_batched": fused.owlqn_trial_step_batched_ref,
    "K11b_pseudo_gradient_batched": fused.pseudo_gradient_batched_ref,
    "K12b_pair_gram_xg_batched": fused.pair_gram_xg_batched_ref,
    "K1b_trial_batched": rosenbrock.value_and_grad.kernels.trial_batched_ref,
    "K7b_owlqn_trial_batched": rosenbrock.value_and_grad.kernels.owlqn_trial_batched_ref,
    "K5b_pair_gram_batched": fused.pair_gram_sd_batched_ref,
    "K2s_probe_steps": rosenbrock.value_and_grad.kernels.probe_steps_ref,
    "K8s_owlqn_probe_steps": rosenbrock.value_and_grad.kernels.owlqn_probe_steps_ref,
    "K2bs_probe_steps_batched": rosenbrock.value_and_grad.kernels.probe_steps_batched_ref,
    "K8bs_owlqn_probe_steps_batched":
        rosenbrock.value_and_grad.kernels.owlqn_probe_pg_steps_batched_ref,
}


def plain_calls() -> dict:
    """Calls of every plain version, those of the objectives with extras
    summed per kernel (``<ref>_ex``)."""
    out = {name: fn.calls for name, fn in PLAIN.items()}
    for ref in FACTORY_REFS:
        out[ref + "_ex"] = sum(getattr(obj.kernels, ref).calls for obj in EXTRAS.values())
    return out


def _reset_factory(k) -> None:
    for name in FACTORY_WRAPPERS:
        getattr(k, name).launches = 0
    for name in LANE_PROBES:
        getattr(k, name).lanes = 0
    for fn in (k.trial_pair_gram, k.owlqn_trial_pair_gram, k.trial_pair_gram_batched,
               k.owlqn_trial_pair_gram_batched):
        fn.gp_launches = fn.deep_gp_launches = fn.mma_launches = 0
    for fn in (k.trial_pair_gram, k.owlqn_trial_pair_gram, k.trial_pair_gram_batched,
               k.owlqn_trial_pair_gram_batched):
        fn.mma_rows_launches = 0
    for fn in (k.trial_pair_gram, k.owlqn_trial_pair_gram, k.combine_probe, k.combine_ow_probe,
               k.trial_pair_gram_batched, k.owlqn_trial_pair_gram_batched,
               k.combine_probe_batched, k.combine_ow_probe_batched):
        fn.deep_launches = 0
    for fn in (k.combine_probe, k.combine_probe_batched):
        fn.fix_launches = fn.deep_fix_launches = 0
    for name in FACTORY_REFS:
        getattr(k, name).calls = 0


def reset_counts() -> None:
    _reset_factory(rosenbrock.value_and_grad.kernels)
    for obj in EXTRAS.values():
        _reset_factory(obj.kernels)
    for fn in (fused.combine, fused.pseudo_gradient_norm, fused.combine_ow,
               fused.pair_gram_sd, fused.combine_fix, fused.owlqn_trial_step,
               fused.pseudo_gradient, fused.pair_gram_xg, fused.axpy_dot,
               profiling.null_launch, fused.combine_batched, fused.combine_ow_batched,
               fused.pseudo_gradient_norm_batched, fused.combine_fix_batched,
               fused.owlqn_trial_step_batched, fused.pseudo_gradient_batched,
               fused.pair_gram_xg_batched, fused.pair_gram_sd_batched, fused.reduce_partials):
        fn.launches = 0
    fused.pair_gram_xg.gp_launches = fused.pair_gram_sd_batched.gp_launches = 0
    for fn in PLAIN.values():
        fn.calls = 0
    to_host.reads = 0
    carried.used = carried.ignored = 0


def phase_goldens() -> None:
    x0 = rosenbrock.initial_point(100, torch.float64, "cuda")
    for entry in ("minimize", "minimize_jit"):
        reset_counts()
        b = lbfgs()
        r = getattr(b, entry)(x0, default_evaluate())
        if r.niter != 35:
            raise AssertionError(f"{entry} defaults: niter {r.niter} != 35")
        b = lbfgs().with_constrain_step_size(False)
        r2 = getattr(b, entry)(x0, default_evaluate())
        ok = (r2.niter == 38
              and abs(r2.fx / 1.2832127771605377e-15 - 1) <= 1e-3
              and abs(r2.gnorm / 9.486547293218877e-07 - 1) <= 1e-6)
        if not ok:
            raise AssertionError(f"{entry} golden: {r2}")
        # the capped run takes K3, the uncapped one K15
        lc, pc = launches(), plain_calls()
        if min(lc[k] for k in PLAIN_PATH + UNFUSED_PATH) == 0 or max(pc.values()) != 0:
            raise AssertionError(f"{entry} golden did not run on the kernels: {lc} {pc}")
        emit(phase="golden_f64_n100", entry=entry, niter_default=r.niter,
             niter=r2.niter, fx=r2.fx, gnorm=r2.gnorm, launches=lc)


#: the recorded OWL-QN trajectory (tests/test_native_parity.py:57-66)
OWLQN_GOLDEN = dict(fx=43.50249999999999, x0=0.25, x1=0.0575, niter=172)

#: the JAX package's n = 100 float64 damped runs from initial_point(100),
#: at most 50 iterations through ``minimize``: iterations, fx after 15 and
#: the final fx (tests/test_torch_damped.py holds these to lbfgs_tpu)
DAMPED_N100 = {
    "damped": dict(niter=34, fx15=40.059866126029206, fx=7.9619800215897e-14),
    "damped_fixed": dict(niter=43, fx15=90.57043092482998, fx=3.912403849224467e-14),
    "damped_owlqn": dict(niter=50, fx15=257.9911080938514, fx=47.247445716752445),
}


def phase_owlqn_golden() -> None:
    x0 = rosenbrock.initial_point(100, torch.float64, "cuda")
    x1 = lbfgs().with_constrain_step_size(False).minimize(x0, default_evaluate()).x
    b = lbfgs().with_orthantwise(1.0, 0, 99).with_constrain_step_size(False)
    for entry in ("minimize", "minimize_jit"):
        reset_counts()
        r = getattr(b, entry)(x1.clone(), default_evaluate())
        lc, pc = launches(), plain_calls()
        g = OWLQN_GOLDEN
        ok = (abs(r.fx / g["fx"] - 1) <= 1e-6 and abs(float(r.x[0]) - g["x0"]) <= 1e-4
              and abs(float(r.x[1]) - g["x1"]) <= 1e-4)
        if not ok:
            raise AssertionError(f"{entry} OWL-QN golden: {r}")
        if min(lc[k] for k in OWLQN_PATH) == 0 or max(pc.values()) != 0:
            raise AssertionError(f"{entry} OWL-QN golden did not run on the kernels: "
                                 f"{lc} {pc}")
        emit(phase="owlqn_golden_f64_n100", entry=entry, niter=r.niter,
             niter_recorded=g["niter"], fx=r.fx, x0=float(r.x[0]), x1=float(r.x[1]),
             gnorm=r.gnorm, launches=lc)


#: the main path: n = 2^24 (N_BIG), f32, m = 6, bf16 history, More-Thuente,
#: uncapped step, epsilon 0, at most 100 iterations
MAIN_PARAMS = LbfgsParams(m=M, history_dtype="bfloat16", constrain_step_size=False,
                          epsilon=0.0, max_iterations=101)
#: (iterations, rel fx, normwise x) bounds of the plain run against the
#: kernel run: the kernels sum in another order, and Rosenbrock amplifies
#: those ulps (15 iterations is the pointwise horizon of the
#: kernel-vs-composed pins; past ~18 the trajectories part)
VS_PLAIN = ((8, 1e-3, 1e-2), (15, 5e-2, 0.25))


def phase_main_path() -> dict:
    params = MAIN_PARAMS
    x0 = rosenbrock.initial_point(N_BIG, torch.float32, "cuda")
    f0 = float(rosenbrock.probe_ref(x0, x0, 0.0)[0])
    st, dt, lc, pc, reads = _run_2e24("main path", params)
    used = carried.used
    iters, probes = st.k - 1, st.prob.neval - 1
    fx = float(st.prob.fx)
    if not (np.isfinite(fx) and fx < f0):
        raise AssertionError(f"main path: fx {fx} (start {f0})")
    _expect("main path", lc, pc, K1_trial=1, K2_probe=probes - used, K4_trial_pair_gram=iters,
            K15_combine_probe=iters)
    _carried_all("main path", used, iters)
    _expect_mma("main path", 0)
    # bytes per iteration from the shapes (f32 vectors, bf16 history):
    # K2 reads xp, d; K4 reads xp, d, gp and m-1 rows of S and Y, writes
    # x, g and one row of each; K15 reads g, x and both rings, writes d
    v, h = 4, 2
    bpi = N_BIG * (lc["K2_probe"] / iters * 2 * v + (5 * v + 2 * (M - 1) * h + 2 * h)
                   + (3 * v + 2 * M * h))
    out = _report_2e24("main_path", st, dt, lc, reads,
                       carried_probes=used, k2_per_iter=lc["K2_probe"] / iters,
                       bytes_per_iter_model=bpi, gb_per_s_model=bpi * iters / dt / 1e9,
                       gb_per_s_vs_1_44=1.44 * iters / dt, fx0=f0, plain_calls=pc)

    # the same entry point through the plain versions on the card, against
    # the kernels, at two iteration budgets
    for bounds in VS_PLAIN:
        emit(phase="main_path_vs_plain", **_vs_plain("main path", params, *bounds))
    del st
    torch.cuda.empty_cache()
    return lc, out


def _vs_plain(name: str, params: LbfgsParams, n_it: int, fx_tol: float, x_tol: float) -> dict:
    """``minimize_jit`` from Rosenbrock's start at n = 2^24 through the
    plain versions on the card against the kernels, ``n_it`` iterations at
    epsilon 0: the same iterations, fx within ``fx_tol`` relative and x
    within ``x_tol`` normwise."""
    x0 = rosenbrock.initial_point(N_BIG, torch.float32, "cuda")
    p = params.replace(epsilon=0.0, max_iterations=n_it + 1)
    st_k = minimize_jit(p, x0, default_evaluate(), return_state=True)
    st_p = minimize_jit(p, x0, default_evaluate().plain, return_state=True)
    rel = abs(float(st_k.prob.fx) / float(st_p.prob.fx) - 1)
    x_err = err(st_k.prob.x, st_p.prob.x)
    if st_k.k != st_p.k or st_k.k != n_it + 1:
        raise AssertionError(f"{name} plain run: niter {st_p.k - 1}, kernel {st_k.k - 1}, "
                             f"budget {n_it}")
    if not (rel <= fx_tol and x_err <= x_tol):
        raise AssertionError(f"{name} plain vs kernel after {n_it} iterations: rel fx "
                             f"{rel:.3e} (tol {fx_tol}), x {x_err:.3e} (tol {x_tol})")
    return dict(iters=n_it, rel_fx=rel, fx_tol=fx_tol, x_err=x_err, x_tol=x_tol)


#: the OWL-QN main path (bench_owlqn.py:61-76 at n = 2^24): f32, m = 6,
#: bf16 history, c = 1 on [0, n - 1), BacktrackingArmijo, uncapped step,
#: time to epsilon 3e-2 within 300 iterations
OWLQN_PARAMS = LbfgsParams(
    m=M, history_dtype="bfloat16", constrain_step_size=False, epsilon=3e-2,
    max_iterations=301, orthantwise=Orthantwise(1.0, 0, N_BIG - 1),
).replace_ls(algorithm=LineSearchAlgorithm.BacktrackingArmijo)
#: bound on the plain-vs-kernel rel fx after 15 OWL-QN iterations, set
#: before the first run (PERF.md, section 6); printed, not asserted
OWLQN_VS_PLAIN_15 = 1e-2


def phase_owlqn_main_path() -> dict:
    params = OWLQN_PARAMS
    x0 = rosenbrock.initial_point(N_BIG, torch.float32, "cuda")
    f0 = float(rosenbrock.probe_ref(x0, x0, 0.0)[0]) + float(x0[:-1].abs().sum())
    st, dt, lc, pc, reads = _run_2e24("OWL-QN main path", params)
    used = carried.used
    iters, probes = st.k - 1, st.prob.neval - 1
    fx = float(st.prob.fx)
    if st.status != Status.CONVERGED:
        raise AssertionError(f"OWL-QN main path: status {st.status} after {iters} "
                             f"iterations (fx {fx})")
    if not (np.isfinite(fx) and fx < f0):
        raise AssertionError(f"OWL-QN main path: fx {fx} (start {f0})")
    _expect("OWL-QN main path", lc, pc, **_owlqn_launches(iters, probes, used))
    _carried_all("OWL-QN main path", used, iters)
    out = _report_2e24("owlqn_main_path", st, dt, lc, reads, eps=3e-2,
                       carried_probes=used, k8_per_iter=lc["K8_owlqn_probe"] / iters,
                       fx0=f0, gnorm=float(np.sqrt(st.prob.gnorm2)), plain_calls=pc)

    # minimize_jit through the plain versions on the card against the
    # kernels: the same evaluations and fx to rel 1e-4 after 8 iterations
    # (tests/test_native_parity.py:228-229); after 15 the difference is
    # printed beside the bound set before the first run
    for n_it in (8, 15):
        p = params.replace(epsilon=0.0, max_iterations=n_it + 1)
        st_k = minimize_jit(p, x0, default_evaluate(), return_state=True)
        st_p = minimize_jit(p, x0, default_evaluate().plain, return_state=True)
        rel = abs(float(st_k.prob.fx) / float(st_p.prob.fx) - 1)
        x_err = err(st_k.prob.x, st_p.prob.x)
        same = (st_k.k, st_k.prob.neval) == (st_p.k, st_p.prob.neval)
        if n_it == 8 and not (same and st_k.k == n_it + 1 and rel <= 1e-4):
            raise AssertionError(
                f"OWL-QN plain vs kernel after 8 iterations: k/neval {st_k.k}/"
                f"{st_k.prob.neval} vs {st_p.k}/{st_p.prob.neval}, rel fx {rel:.3e}")
        emit(phase="owlqn_main_path_vs_plain", iters=n_it, neval_kernel=st_k.prob.neval,
             neval_plain=st_p.prob.neval, rel_fx=rel,
             fx_tol=1e-4 if n_it == 8 else OWLQN_VS_PLAIN_15, asserted=n_it == 8,
             x_err=x_err)
        del st_k, st_p
    del st
    torch.cuda.empty_cache()
    return lc, out


def phase_profile(path: str) -> None:
    """For each main path (plain, OWL-QN, damped, damped OWL-QN, Poisson,
    and the first three on the objective without the combine+probe
    fusion's hooks), one run under torch.profiler after three unprofiled
    ones: device busy time (the summed durations of the kernels and copies
    the profiler saw on the card) against the walls, the device items by
    time, and the host's launch and copy calls.  The full operator tables
    go to ``path``."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        for name, params in (("main_path", MAIN_PARAMS), ("owlqn_main_path", OWLQN_PARAMS),
                             ("damped_main_path", DAMPED_PARAMS),
                             ("damped_owlqn_main_path", DAMPED_OWLQN_PARAMS)):
            _profile_one(name, params, f)
        for name, params in (("main_path_unfused", MAIN_PARAMS),
                             ("owlqn_main_path_unfused", OWLQN_PARAMS),
                             ("damped_main_path_unfused", DAMPED_PARAMS)):
            _profile_one(name, params, f, fn=unfused(default_evaluate()))
        X, y = logistic.synthetic(POISSON_NROW, POISSON_NCOL, seed=0, device="cuda")
        _profile_one("poisson_main_path", poisson_params(False), f,
                     torch.zeros(POISSON_NCOL, device="cuda"), logistic.make_objective(X, y))
        del X, y
        torch.cuda.empty_cache()


def _profile_one(name: str, params: LbfgsParams, f, x0=None, fn=None) -> None:
    if x0 is None:
        x0 = rosenbrock.initial_point(N_BIG, torch.float32, "cuda")
    fn = fn or default_evaluate()
    walls = [1e3 * profiling.timed(lambda: minimize_jit(params, x0, fn, return_state=True),
                                   warmup=0)
             for _ in range(3)]

    def one_run():
        t0 = time.perf_counter()
        st = minimize_jit(params, x0, fn, return_state=True)
        torch.cuda.synchronize()
        return st, 1e3 * (time.perf_counter() - t0)

    prof, (st, wall_prof) = profiled(one_run)
    if prof is None:
        raise AssertionError(f"{name}: the profiler recorded no device time")
    iters = st.k - 1
    ka = averages(prof)
    dev = sorted(device_events(prof), key=lambda e: -e.self_device_time_total)
    busy = sum(e.self_device_time_total for e in dev) / 1e3
    api = {e.key: e.count for e in ka
           if e.key.startswith(("cudaLaunch", "cuLaunch", "cudaMemcpy"))}
    top = [dict(name=e.key[:70], ms=e.self_device_time_total / 1e3, count=e.count)
           for e in dev[:12]]
    out = dict(phase="profile", path=name, n=x0.shape[0], iters=iters, walls_ms=walls,
               profiled_wall_ms=wall_prof, device_busy_ms=busy,
               device_busy_ms_per_iter=busy / iters,
               busy_share_of_walls=[busy / w for w in walls],
               device_items=len(dev), host_calls=api, top=top)
    f.write(json.dumps(out) + "\n\n")
    f.write(ka.table(sort_by="self_device_time_total", row_limit=60) + "\n\n")
    emit(**out)


# ---------------------------------------------------------------------------
# The damped paths
# ---------------------------------------------------------------------------

#: the damped n = 100 configurations (DAMPED_N100 holds their JAX runs)
DAMPED_CONFIGS = {
    "damped": lambda b: b.with_damping(True),
    "damped_fixed": lambda b: b.with_damping(True).with_damping_fixed(),
    "damped_owlqn": lambda b: b.with_orthantwise(1.0, 0, 99).with_damping(True),
}
#: per-iteration bounds of a card run against the same run on the CPU:
#: the JAX package's own pins to the native core (damped OWL-QN,
#: tests/test_damped_fused.py:221-226; LJ38, tests/test_lennard_jones.py:
#: 100-104).  The plain damped Rosenbrock runs are held to them up to
#: HORIZON iterations only: the valley amplifies a sum's rounding ~10x
#: every two iterations (the port against the JAX package on the CPU:
#: rel fx 1.3e-10 at iteration 16, 7.3e-9 at 22, 5.5e-6 at 34), so past it
#: only the iterations, the status and the final fx are held
TRACE_TOL = dict(fx=1e-9, gnorm=1e-6, step=1e-6)
LJ_TOL = dict(fx=1e-8, gnorm=1e-6, step=1e-6)
HORIZON = 15


def run_traced(builder: Lbfgs, x0: torch.Tensor, fn) -> tuple:
    """``minimize`` with a progress callback that records (niter, fx,
    gnorm, step, neval) per iteration; returns (trace, report)."""
    trace = []

    def progress(p) -> bool:
        trace.append((p.niter, p.fx, p.gnorm, p.step, p.neval))
        return False

    return trace, builder.minimize(x0, fn, progress)


def compare_traces(name: str, card: list, cpu: list, tol: dict, upto: int) -> dict:
    """Hold the card's trace to the CPU's per iteration up to ``upto``:
    the same evaluations, fx, gnorm and step within ``tol`` (relative).
    Returns the largest relative gaps over the whole common prefix."""
    worst = dict.fromkeys(tol, 0.0)
    if len(card) != len(cpu):
        raise AssertionError(f"{name}: {len(card)} iterations on the card, {len(cpu)} on "
                             "the CPU")
    for (k, *a, ea), (kc, *b, eb) in zip(card, cpu):
        gaps = {key: abs(x - y) / max(abs(y), 1e-300) for key, x, y in zip(tol, a, b)}
        for key, g in gaps.items():
            worst[key] = max(worst[key], g)
        if k > upto:
            continue
        if k != kc or ea != eb:
            raise AssertionError(f"{name}: iteration {k}/{kc}, evaluations {ea}/{eb}")
        bad = {key: g for key, g in gaps.items() if not g <= tol[key]}
        if bad:
            raise AssertionError(f"{name}: iteration {k} differs from the CPU: {bad}")
    return worst


def phase_damped_n100() -> dict:
    """The three damped f64 runs at n = 100 through the kernels, each held
    to the same run on the CPU and to the JAX package's recorded run;
    returns the damping cases seen."""
    x0 = rosenbrock.initial_point(100, torch.float64, "cuda")
    seen = {}
    for name, chain in DAMPED_CONFIGS.items():
        b = chain(lbfgs()).with_max_iterations(50)
        ow = name == "damped_owlqn"
        reset_counts()
        tk, rk = run_traced(b, x0, default_evaluate())
        lc, pc = launches(), plain_calls()
        tc, rc = run_traced(b, x0.cpu(), default_evaluate())
        worst = compare_traces(name, tk, tc, TRACE_TOL, 50 if ow else HORIZON)
        if (rk.niter, rk.status) != (rc.niter, rc.status):
            raise AssertionError(f"{name}: card {rk.niter}/{rk.status}, CPU "
                                 f"{rc.niter}/{rc.status}")
        # the JAX package's run: iterations, fx after 15, the final fx
        # (rel 1e-9 under OWL-QN; the plain runs end at fx ~1e-13, where
        # the packages' rounding has grown to ~1e-5 rel)
        want = DAMPED_N100[name]
        fx15 = tk[HORIZON - 1][1]
        final_tol = 1e-9 if ow else 1e-3
        if not (rk.niter == want["niter"]
                and abs(fx15 / want["fx15"] - 1) <= 1e-9
                and abs(rk.fx / want["fx"] - 1) <= final_tol):
            raise AssertionError(f"{name}: niter {rk.niter}, fx15 {fx15}, fx {rk.fx} "
                                 f"against the JAX package's {want}")
        iters, probes = rk.niter - 1, rk.neval - 1
        if ow:
            _expect(name, lc, pc, K1_trial=1, K10_pseudo_gradient_norm=1,
                    K8_owlqn_probe=probes, K13_combine_ow=iters,
                    K14_owlqn_trial_pair_gram_gp=iters)
        else:
            _expect(name, lc, pc, K1_trial=1, K2_probe=probes,
                    K4_trial_pair_gram_gp=iters, K6_combine_fix=iters)
        seen[name] = rk.damping_cases
        emit(phase="damped_f64_n100", config=name, niter=rk.niter, status=rk.status,
             fx=rk.fx, fx15=fx15, fx_jax=want["fx"], neval=rk.neval,
             damping_cases=dict(zip(("none", "case1", "case2"), rk.damping_cases)),
             max_rel_gap_vs_cpu=worst, asserted_to=50 if ow else HORIZON, launches=lc)
    if seen["damped"][1] == 0 or seen["damped_fixed"][2] == 0:
        raise AssertionError(f"damping did not fire: {seen}")
    return seen


def phase_lj38() -> None:
    """LJ38 in f64 on the card: the start energy, default L-BFGS to the
    relaxed energy, and 50 gradient-only iterations against the CPU."""
    obj = lennard_jones.make_objective()
    x0 = lennard_jones.lj38_positions(device="cuda")
    e0 = float(obj(x0)[0])
    if abs(e0 - (-116.84147098)) > 1e-6:
        raise AssertionError(f"LJ38 start energy {e0}")
    reset_counts()
    t0 = time.perf_counter()
    r = lbfgs().with_max_iterations(400).minimize(x0, obj)
    dt = time.perf_counter() - t0
    if abs(r.fx - (-164.2701507)) > 1e-4:
        raise AssertionError(f"LJ38 default L-BFGS: fx {r.fx} after {r.niter} iterations")
    emit(phase="lj38_default", niter=r.niter, fx=r.fx, status=r.status, seconds=dt)
    b = lbfgs().with_gradient_only().with_max_iterations(50)
    reset_counts()
    tk, rk = run_traced(b, x0, obj)
    lc, pc = launches(), plain_calls()
    tc, _ = run_traced(b, x0.cpu(), obj)
    worst = compare_traces("lj38 gradient_only", tk, tc, LJ_TOL, 50)
    if not tk[-1][1] < -150.0:
        raise AssertionError(f"LJ38 gradient-only ends at fx {tk[-1][1]}")
    _expect("LJ38 gradient-only", lc, pc, K3_combine=rk.niter - 1)
    emit(phase="lj38_gradient_only", niter=rk.niter, fx=rk.fx, neval=rk.neval,
         damping_cases=dict(zip(("none", "case1", "case2"), rk.damping_cases)),
         max_rel_gap_vs_cpu=worst, tol=LJ_TOL, launches=lc)


def _run_2e24(name: str, params: LbfgsParams, fn=None, x0=None) -> tuple:
    """One warm and one timed ``minimize_jit`` at n = 2^24 (the counts
    reset between them), from Rosenbrock's start unless ``x0`` is given;
    returns (state, seconds, launches, plain calls, host reads)."""
    fn = fn or default_evaluate()
    if x0 is None:
        x0 = rosenbrock.initial_point(N_BIG, torch.float32, "cuda")
    minimize_jit(params, x0, fn, return_state=True)
    torch.cuda.synchronize()
    reset_counts()
    out = []
    dt = profiling.timed(lambda: out.append(minimize_jit(params, x0, fn, return_state=True)),
                         warmup=0)
    st = out[0]
    lc, pc, reads = launches(), plain_calls(), to_host.reads
    if st.status not in (Status.CONVERGED, Status.MAX_ITERATIONS):
        raise AssertionError(f"{name}: status {st.status} after {st.k - 1} iterations")
    if not np.isfinite(float(st.prob.fx)):
        raise AssertionError(f"{name}: fx {st.prob.fx}")
    return st, dt, lc, pc, reads


def _expect(name: str, lc: dict, pc: dict, **counts) -> None:
    """A run's launches are ``counts`` for the named kernels and none of
    any other, and it called no plain version (stand-ins included).  R,
    the second stage of every kernel's partials, launched at least once
    if any kernel did (its count is each wrapper's own affair)."""
    want = dict.fromkeys(lc, 0)
    want.update(counts)
    want[R_NAME] = counts.get(R_NAME, lc[R_NAME])
    if lc != want:
        raise AssertionError(f"{name} launch counts {lc}, expected {want}")
    if any(counts.values()) and not lc[R_NAME]:
        raise AssertionError(f"{name}: no launch of R, the partials' second stage")
    if max(pc.values()) != 0:
        raise AssertionError(f"{name} called plain versions: {pc}")


def _expect_mma(name: str, iters: int, owlqn: bool = False, rows: int = 0) -> None:
    """The solo epilogue (K4, or K14 under OWL-QN) ran in its tensor-core
    form ``iters`` times and in its row-block form ``rows`` times since the
    last ``reset_counts`` (0: never)."""
    k = rosenbrock.value_and_grad.kernels
    fn = k.owlqn_trial_pair_gram if owlqn else k.trial_pair_gram
    if (fn.mma_launches, fn.mma_rows_launches) != (iters, rows):
        raise AssertionError(f"{name}: {fn.mma_launches} tensor-core and "
                             f"{fn.mma_rows_launches} row-block epilogue launches, {iters} and "
                             f"{rows} expected")


def _carried_all(name: str, used: int, iters: int) -> None:
    """Every search after the first took the combine+probe fusion's carried
    first trip (the entry step is the probed one by construction)."""
    if used != iters - 1:
        raise AssertionError(f"{name}: {used} carried first trips in {iters} iterations")


def _owlqn_launches(iters: int, probes: int, used: int) -> dict:
    """The OWL-QN main path's launches: K1 and K10 once, K14 and K16 per
    iteration, K8 per probe the fusion did not carry in."""
    return dict(K1_trial=1, K10_pseudo_gradient_norm=1, K8_owlqn_probe=probes - used,
                K14_owlqn_trial_pair_gram=iters, K16_combine_ow_probe=iters)


def unfused(fn):
    """The objective ``fn`` without the combine+probe fusion's hooks, as an
    objective that does not carry them: the solver then runs K3 (K6, K13)
    and probes every first trip (the fusion-off side of the comparisons)."""
    def vag(x):
        return fn(x)

    vag.__dict__.update({k: v for k, v in fn.__dict__.items()
                         if not k.startswith(("__lbfgs_combine_probe", "__lbfgs_combine_ow_probe"))})
    return vag


def _report_2e24(phase: str, st, dt: float, lc: dict, reads: int, **extra) -> dict:
    iters = st.k - 1
    out = dict(phase=phase, n=N_BIG, iters=iters, status=st.status, seconds=dt,
               iters_per_s=iters / dt, ms_per_iter=1e3 * dt / iters,
               evals=st.prob.neval, probes_per_iter=(st.prob.neval - 1) / iters,
               syncs_per_iter=reads / iters, fx=float(st.prob.fx),
               damping_cases=dict(zip(("none", "case1", "case2"), st.damping_cases)),
               launches=lc, **extra)
    emit(**out)
    return out


#: the damped main path: bench.py's BENCH_DAMPING=1 configuration
#: (bench.py:21, 101) at the main path's widths, epsilon 0, at most 100
#: iterations
DAMPED_PARAMS = MAIN_PARAMS.replace(damping=True)
#: the damped OWL-QN main path: the OWL-QN main path with damping
DAMPED_OWLQN_PARAMS = OWLQN_PARAMS.replace(damping=True)


def phase_damped_main_path(undamped_syncs: float) -> dict:
    st, dt, lc, pc, reads = _run_2e24("damped main path", DAMPED_PARAMS)
    used = carried.used
    iters = st.k - 1
    _expect("damped main path", lc, pc, K1_trial=1, K2_probe=st.prob.neval - 1 - used,
            K4_trial_pair_gram_gp=iters, K15_combine_probe_fix=iters)
    _carried_all("damped main path", used, iters)
    out = _report_2e24("damped_main_path", st, dt, lc, reads,
                       carried_probes=used, syncs_per_iter_undamped=undamped_syncs)
    del st
    torch.cuda.empty_cache()
    return lc, out


def phase_gradient_only_main_path() -> None:
    params = Lbfgs(MAIN_PARAMS).with_gradient_only().with_max_iterations(51).param
    st, dt, lc, pc, reads = _run_2e24("gradient-only main path", params)
    used = carried.used
    iters = st.k - 1
    _expect("gradient-only main path", lc, pc, K1_trial=1, K2_probe=st.prob.neval - 1 - used,
            K4_trial_pair_gram_gp=iters, K15_combine_probe_fix=iters)
    _report_2e24("gradient_only_main_path", st, dt, lc, reads, carried_probes=used)
    del st
    torch.cuda.empty_cache()


def phase_damped_owlqn_main_path() -> dict:
    st, dt, lc, pc, reads = _run_2e24("damped OWL-QN main path", DAMPED_OWLQN_PARAMS)
    used = carried.used
    iters, probes = st.k - 1, st.prob.neval - 1
    want = _owlqn_launches(iters, probes, used)
    want["K14_owlqn_trial_pair_gram_gp"] = want.pop("K14_owlqn_trial_pair_gram")
    _expect("damped OWL-QN main path", lc, pc, **want)
    _report_2e24("damped_owlqn_main_path", st, dt, lc, reads, eps=3e-2, carried_probes=used,
                 gnorm=float(np.sqrt(st.prob.gnorm2)))
    del st
    torch.cuda.empty_cache()
    return lc


def trial_only_objective():
    """Rosenbrock with its trial (K1; K7 under OWL-QN) and probe (K2; K8)
    kernels but no one-pass epilogue and no combine+probe fusion, so that
    the damped solver takes K5 and K6 (the K5 route), under OWL-QN K12
    with its . gp column and K13 (the K12 route), and above 64 ring rows
    the any-depth route; its plain twin is Rosenbrock's.  With the batched
    trials and probes too (K1 b, K7 b, K2 b, K8 b), so that the batched
    runner takes its trial route: K5 b (its . gp form and K6 b damped) and
    K3 b, under OWL-QN K7 b, K10 b, K12 b and K13 b."""
    def vag(x):
        return rosenbrock.value_and_grad(x)

    k = rosenbrock.value_and_grad.kernels
    vag.__lbfgs_value_and_grad__ = True
    vag.__lbfgs_trial__ = rosenbrock.trial
    vag.__lbfgs_trial_probe__ = rosenbrock.probe
    vag.__lbfgs_owlqn_trial__ = rosenbrock.owlqn_trial
    vag.__lbfgs_owlqn_probe__ = rosenbrock.owlqn_probe
    vag.__lbfgs_owlqn_probe_pg__ = rosenbrock.owlqn_probe_pg
    vag.__lbfgs_trial_batched__ = k.trial_batched
    vag.__lbfgs_owlqn_trial_batched__ = k.owlqn_trial_batched
    vag.__lbfgs_probe_batched__ = k.probe_batched
    vag.__lbfgs_owlqn_probe_pg_batched__ = k.owlqn_probe_pg_batched
    vag.plain = rosenbrock.value_and_grad.plain
    return vag


def phase_k5_route() -> dict:
    params = DAMPED_PARAMS.replace(max_iterations=11)
    st, dt, lc, pc, reads = _run_2e24("K5 route", params, trial_only_objective())
    iters = st.k - 1
    # K1 at the start and once per iteration to materialize the search's
    # accepted point
    _expect("K5 route", lc, pc, K1_trial=1 + iters, K2_probe=st.prob.neval - 1,
            K5_pair_gram=iters, K6_combine_fix=iters)
    x0 = rosenbrock.initial_point(N_BIG, torch.float32, "cuda")
    p = DAMPED_PARAMS.replace(max_iterations=9)
    st5 = minimize_jit(p, x0, trial_only_objective(), return_state=True)
    st4 = minimize_jit(p, x0, default_evaluate(), return_state=True)
    _report_2e24("k5_route", st, dt, lc, reads,
                 vs_epilogue_after_8=dict(
                     rel_fx=abs(float(st5.prob.fx) / float(st4.prob.fx) - 1),
                     neval=(st5.prob.neval, st4.prob.neval)))
    del st, st5, st4
    torch.cuda.empty_cache()
    return lc


def phase_k12_route() -> dict:
    """Damped OWL-QN at the main path's shapes without the one-pass
    epilogue (``trial_only_objective``, 10 iterations at epsilon 0): K1 and
    K10 at the start, then per iteration K7 at the accepted point, K10,
    K12 with its . gp column (K14's damped reconstruction follows) and
    K13, K8 per probe; against the K14 route after 8 iterations."""
    params = DAMPED_OWLQN_PARAMS.replace(epsilon=0.0, max_iterations=11)
    st, dt, lc, pc, reads = _run_2e24("K12 route", params, trial_only_objective())
    iters = st.k - 1
    _expect("K12 route", lc, pc, K1_trial=1, K7_owlqn_trial=iters,
            K8_owlqn_probe=st.prob.neval - 1, K10_pseudo_gradient_norm=1 + iters,
            K12_pair_gram_xg_gp=iters, K13_combine_ow=iters)
    x0 = rosenbrock.initial_point(N_BIG, torch.float32, "cuda")
    p = params.replace(max_iterations=9)
    st12 = minimize_jit(p, x0, trial_only_objective(), return_state=True)
    st14 = minimize_jit(p, x0, default_evaluate(), return_state=True)
    _report_2e24("k12_route", st, dt, lc, reads,
                 vs_epilogue_after_8=dict(
                     rel_fx=abs(float(st12.prob.fx) / float(st14.prob.fx) - 1),
                     neval=(st12.prob.neval, st14.prob.neval)))
    del st, st12, st14
    torch.cuda.empty_cache()
    return lc


# ---------------------------------------------------------------------------
# The wide objective scalar and the Poisson regression
# ---------------------------------------------------------------------------


def _rosen_f64(x: torch.Tensor) -> float:
    """Extended Rosenbrock of a float32 point, summed in float64 on the host."""
    x = x.double().cpu()
    t1 = 1.0 - x[0::2]
    t2 = 10.0 * (x[1::2] - x[0::2] ** 2)
    return float((t1 * t1 + t2 * t2).sum())


def phase_wide_kernels() -> None:
    """The wide forms of K1, K2, K4, K7 and K8 at n = 2^24 on a 1e12-sized
    fx (Rosenbrock at x0 + 10, tests/test_wide_fx.py:47-75): the objective
    (and K7's and K8's L1) column reduced in float64, every other output
    bit for bit the default launch's; each form's fx against a float64
    sum on the host.  With float64 vectors the mode changes nothing, bit
    for bit."""
    n, c, lo, hi = N_BIG, 1.0, 0, N_BIG - 1
    g = torch.Generator(device="cuda").manual_seed(SEED + 7)
    xp = rosenbrock.initial_point(n, torch.float32, "cuda") + 10.0
    d = 1e-3 * torch.randn(n, generator=g, device="cuda")
    gp, pg = (torch.randn(n, generator=g, device="cuda") for _ in range(2))
    S, Y = (torch.randn((M, n), generator=g, device="cuda").to(torch.bfloat16)
            for _ in range(2))
    wp = choose_orthant(Orthantwise(c, lo, hi), xp, pg)
    forms = {  # name: (launch, index of fx)
        "K1_trial": (lambda: rosenbrock.trial(xp, d, STP), 1),
        "K2_probe": (lambda: rosenbrock.probe(xp, d, STP), 0),
        "K4_trial_pair_gram": (
            lambda: rosenbrock.trial_pair_gram(xp, d, gp, STP, S.clone(), Y.clone(), END)
            + (S, Y), 1),
        "K7_owlqn_trial": (lambda: rosenbrock.owlqn_trial(xp, d, wp, STP, c, lo, hi), 1),
        "K8_owlqn_probe": (lambda: rosenbrock.owlqn_probe(xp, d, wp, STP, c, lo, hi), 0),
        "K8_owlqn_probe_pg": (lambda: rosenbrock.owlqn_probe_pg(xp, d, pg, STP, c, lo, hi), 0),
    }
    xt = rosenbrock.trial(xp, d, STP)[0]
    x7 = rosenbrock.owlqn_trial(xp, d, wp, STP, c, lo, hi)[0]
    exact = _rosen_f64(xt)
    exact_ow = _rosen_f64(x7) + c * float(x7[lo:hi].double().abs().sum())
    rel = {}
    for name, (launch, fi) in forms.items():
        base = launch()
        with fused.wide_fx():
            wide = launch()
        if base[fi].dtype != torch.float32 or wide[fi].dtype != torch.float64:
            raise AssertionError(f"{name}: fx dtypes {base[fi].dtype}, {wide[fi].dtype}")
        for i, (a, b) in enumerate(zip(base, wide)):
            if i != fi and not same_bits(a, b):
                raise AssertionError(f"{name}: output {i} differs under the wide mode")
        want = exact_ow if name.startswith(("K7", "K8")) else exact
        rel[name] = dict(f32=abs(float(base[fi]) / want - 1), wide=abs(float(wide[fi]) / want - 1))
        if not rel[name]["wide"] <= 1e-6:
            raise AssertionError(f"{name}: wide fx off the float64 sum by {rel[name]['wide']}")
    x64 = xp.double()
    base = rosenbrock.trial(x64, d.double(), STP)
    with fused.wide_fx():
        wide = rosenbrock.trial(x64, d.double(), STP)
    if not all(same_bits(a, b) for a, b in zip(base, wide)):
        raise AssertionError("the wide mode changed a float64 launch")
    emit(phase="wide_kernels", n=n, fx_f64=exact, fx_owlqn_f64=exact_ow, rel_err=rel,
         others="bit-exact against the default launch", f64_vectors="unchanged")
    del xp, d, gp, pg, S, Y, wp, xt, x7
    torch.cuda.empty_cache()


#: the Poisson main path: the JAX package's at-scale configuration
#: (bench_logistic.py:13-17, 81-129) with X in float32: 2048 x 2^20
POISSON_NROW, POISSON_NCOL = 1 << 11, 1 << 20


def poisson_params(wide: bool, iters: int = 100) -> LbfgsParams:
    """c = 1 on [1, n) (the intercept outside the L1 window), m = 6, bf16
    history, BacktrackingArmijo, uncapped step, epsilon 0."""
    return LbfgsParams(
        m=M, history_dtype="bfloat16", constrain_step_size=False, epsilon=0.0,
        max_iterations=iters + 1, fx_wide=wide,
        orthantwise=Orthantwise(1.0, 1, POISSON_NCOL),
    ).replace_ls(algorithm=LineSearchAlgorithm.BacktrackingArmijo)


def _expect_composed(name: str, st, lc: dict, pc: dict) -> None:
    """The composed OWL-QN branch's launches: K11 once at the start, K9 per
    trial point, K10, K12 and K13 per iteration, and nothing else."""
    iters = st.k - 1
    _expect(name, lc, pc, K9_owlqn_trial_step=st.prob.neval - 1, K10_pseudo_gradient_norm=iters,
            K11_pseudo_gradient=1, K12_pair_gram_xg=iters, K13_combine_ow=iters)


def phase_poisson_main_path() -> tuple:
    """The Poisson main path with X float32 (see ``_poisson_path``); its X,
    y and objective are kept for ``phase_batched_poisson``."""
    return _poisson_path(torch.float32, keep=True)


def phase_poisson_bf16_main_path(f32_out: dict) -> tuple:
    """The Poisson main path with X bfloat16 (``bench_logistic.py:160-161``,
    the JAX package's accelerator cell): the same runs and checks as the
    float32 X's, evaluations and ms per evaluation printed beside that
    run's, and both products held to the widened product and timed."""
    return _poisson_path(torch.bfloat16, f32_out)


def _poisson_path(x_dtype: torch.dtype, f32_out: dict | None = None,
                  keep: bool = False) -> tuple:
    """The Poisson main path at 2048 x 2^20 with X in ``x_dtype`` (y and the
    vectors float32; the X of an earlier call is freed, so at most the
    float32 X it is made from and its bfloat16 copy live together, ~12
    GiB): a warm run, then 100 iterations of ``minimize_jit``, float32 and
    wide, each with the composed OWL-QN branch's launches checked, finite
    fx and 0 < nnz < n - 1; then one profiled float32 run for device ms
    per iteration and per evaluation.  With a bfloat16 X both products at
    beta0 and at the final beta against the widened product
    (``_bf16_products``).  Returns (launches of the float32-vector run,
    {wide: summary}), with ``keep`` also {"X", "y", "obj"}, which then stay
    allocated for the caller."""
    tag = str(x_dtype).removeprefix("torch.")
    t0 = time.perf_counter()
    X, y = logistic.synthetic(POISSON_NROW, POISSON_NCOL, seed=0, device="cuda",
                              x_dtype=x_dtype)
    torch.cuda.synchronize()
    t_data = time.perf_counter() - t0
    obj = logistic.make_objective(X, y)
    x0 = torch.zeros(POISSON_NCOL, device="cuda")
    n = POISSON_NCOL
    minimize_jit(poisson_params(False, 2), x0, obj, return_state=True)  # warm
    out = {}
    for wide in (False, True):
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st = minimize_jit(poisson_params(wide), x0, obj, return_state=True)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        lc, pc, reads = launches(), plain_calls(), to_host.reads
        name = f"Poisson main path (X {tag})" + (" (wide)" if wide else "")
        _expect_composed(name, st, lc, pc)
        iters, evals = st.k - 1, st.prob.neval
        fx = st.prob.fx
        nnz = int((st.prob.x[1:] != 0).sum())
        if type(fx) is not (np.float64 if wide else np.float32):
            raise AssertionError(f"{name}: fx is {type(fx).__name__}")
        if not (np.isfinite(fx) and 0 < nnz < n - 1):
            raise AssertionError(f"{name}: fx {fx}, {nnz} nonzero coefficients")
        out[wide] = dict(status=st.status, iters=iters, evals=evals,
                         ms_per_eval=1e3 * dt / evals, fx=float(fx))
        if not wide:
            lc_main, beta = lc, st.prob.x.clone()
        emit(phase="poisson_main_path", nrow=POISSON_NROW, ncol=n, x_dtype=tag,
             fx_wide=wide, iters=iters, evals=evals, status=st.status,
             status_name=Status(st.status).name, seconds=dt, iters_per_s=iters / dt,
             evals_per_s=evals / dt, ms_per_eval=1e3 * dt / evals,
             syncs_per_iter=reads / max(iters, 1), fx=float(fx), fx_dtype=type(fx).__name__,
             nnz=nnz, data_seconds=t_data, launches=lc, plain_calls=pc,
             f32_run=out.get(False) if wide else None,
             x_float32_run=None if f32_out is None else f32_out[wide])
        del st
    prof, st = profiled(lambda: minimize_jit(poisson_params(False), x0, obj, return_state=True))
    busy = None if prof is None else sum(
        e.self_device_time_total for e in device_events(prof)) / 1e3
    emit(phase="poisson_device_time", x_dtype=tag, iters=st.k - 1, evals=st.prob.neval,
         device_ms_per_iter=None if busy is None else busy / (st.k - 1),
         device_ms_per_eval=None if busy is None else busy / st.prob.neval)
    if x_dtype == torch.bfloat16:
        _bf16_products(X, y, {"beta0": x0, "final": beta})
    del st
    if keep:
        return lc_main, out, {"X": X, "y": y, "obj": obj}
    del X, y, obj
    torch.cuda.empty_cache()
    return lc_main, out


#: rows of X widened at a time for the bfloat16 products' reference (1 GiB)
WIDEN_ROWS = 256


def _bf16_products(X: torch.Tensor, y: torch.Tensor, betas: dict) -> None:
    """Both products of the bfloat16-X objective (``logistic.bf16_matvec``:
    X . round_bf16(beta) and X^T . round_bf16(r), r = y - exp(X beta)) at
    each beta against the widened product on the card (X widened a block
    of ``WIDEN_ROWS`` rows at a time, never whole), normwise within the
    f32-sum tolerance 1e-4; then each product's device time at the final
    beta beside its bound: X read once (4 GiB) plus its vector in and out,
    over 3.35 TB/s.  This is a library call (``torch.mm`` with
    ``out_dtype``), not a TPU kernel's counterpart: no row of the kernel
    table."""
    tol = TOL[(torch.float32, "sum")]
    nrow, ncol = X.shape
    errs = {}
    for tag, beta in betas.items():
        xb = logistic.bf16_matvec(X, beta)
        r = y - torch.exp(xb)
        xtr = logistic.bf16_matvec(X.T, r)
        b, rb = beta.bfloat16().float(), r.bfloat16().float()
        xb_ref = torch.cat([X[i:i + WIDEN_ROWS].float() @ b
                            for i in range(0, nrow, WIDEN_ROWS)])
        xtr_ref = torch.zeros(ncol, device=X.device)
        for i in range(0, nrow, WIDEN_ROWS):
            xtr_ref += X[i:i + WIDEN_ROWS].float().T @ rb[i:i + WIDEN_ROWS]
        errs[tag] = dict(xbeta=err(xb, xb_ref), xtr=err(xtr, xtr_ref))
        if max(errs[tag].values()) > tol:
            raise AssertionError(f"bf16-X products at {tag}: {errs[tag]} (tol {tol})")
    beta = betas["final"]
    r = y - torch.exp(logistic.bf16_matvec(X, beta))
    times, bounds = {}, {}
    for name, fn, vin, vout in (("xbeta", lambda: logistic.bf16_matvec(X, beta), ncol, nrow),
                                ("xtr", lambda: logistic.bf16_matvec(X.T, r), nrow, ncol)):
        times[name] = device_time(fn, 20)
        times[name + "_timed_by"] = device_time.source
        bounds[name] = 1e3 * (X.numel() * 2 + (vin + vout) * 4) / HBM_BYTES_PER_S
    emit(phase="poisson_bf16_products", route="torch.mm(out_dtype=torch.float32)",
         nrow=nrow, ncol=ncol, max_normwise_err=errs, tol=tol, ms=times, bound_ms=bounds,
         share_of_bound={k: bounds[k] / times[k] for k in bounds})


def phase_poisson_f64_vs_cpu() -> None:
    """500 x 21 float64 (the reference's shape, ``synthetic_dataset``), c = 1
    on [1, 21), epsilon 1e-4, through ``minimize``: per iteration the card
    against the port on the CPU (fx rel 1e-9), the composed branch's
    launches on the card."""
    b = lbfgs().with_orthantwise(1.0, 1, 21).with_epsilon(1e-4)
    runs = {}
    for dev in ("cuda", "cpu"):
        X, y = logistic.synthetic_dataset(500, 21, device=dev)
        reset_counts()
        runs[dev] = run_traced(b, torch.zeros(21, dtype=torch.float64, device=dev),
                               logistic.make_objective(X, y))
        if dev == "cuda":
            lc, pc = launches(), plain_calls()
    (tk, rk), (tc, rc) = runs["cuda"], runs["cpu"]
    tol = dict(fx=1e-9, gnorm=1e-6, step=1e-6)
    worst = compare_traces("Poisson f64", tk, tc, tol, len(tk))
    if (rk.niter, rk.status) != (rc.niter, rc.status) or rk.status != Status.CONVERGED:
        raise AssertionError(f"Poisson f64: card {rk.niter}/{rk.status}, CPU "
                             f"{rc.niter}/{rc.status}")
    iters = rk.niter - 1
    _expect("Poisson f64", lc, pc, K9_owlqn_trial_step=rk.neval - 1,
            K10_pseudo_gradient_norm=iters, K11_pseudo_gradient=1, K12_pair_gram_xg=iters,
            K13_combine_ow=iters)
    emit(phase="poisson_f64_vs_cpu", nrow=500, ncol=21, niter=rk.niter, neval=rk.neval,
         fx=rk.fx, fx_cpu=rc.fx, max_rel_gap_vs_cpu=worst, tol=tol, launches=lc)


def phase_f32_floor() -> None:
    """The f32 objective floor (tests/test_owlqn_logistic.py:90-143): 512 x 64
    Poisson data from the port's generator (seed 0 on the CPU, moved to the
    card), c = 5 on [1, 64), Armijo, epsilon 1e-4, 60 iterations of the
    step-at-a-time loop, float32 and wide.  The wide run must carry fx
    in float64; where each run stops is recorded, not held: past the
    objective floor both live at the f32 vector floor, where the first
    pair with s.y or y.y exactly 0 ends a run, and which iteration rounds
    to one depends on the order of the products' sums (PERF.md)."""
    X, y = logistic.synthetic(512, 64, nnz=8, device="cpu",
                              generator=torch.Generator().manual_seed(0))
    obj = logistic.make_objective(X.cuda(), y.cuda())
    res = {}
    for wide in (False, True):
        b = (lbfgs().with_orthantwise(5.0, 1, 64).with_linesearch_algorithm("BacktrackingArmijo")
             .with_epsilon(1e-4).with_max_iterations(60).with_fx_wide(wide))
        st = b.build(torch.zeros(64, device="cuda"), obj)
        error = None
        try:
            while not st.is_converged():
                st.propagate()
        except LbfgsError as e:
            error = str(e)
        fx = st.state.prob.fx
        res["wide" if wide else "f32"] = dict(
            k=st.state.k, status=st.state.status, status_name=Status(st.state.status).name,
            error=error, fx=float(fx), fx_dtype=type(fx).__name__)
    if res["wide"]["fx_dtype"] != "float64" or res["f32"]["fx_dtype"] != "float32":
        raise AssertionError(f"f32 floor: fx dtypes {res}")
    if not all(np.isfinite(r["fx"]) for r in res.values()):
        raise AssertionError(f"f32 floor: {res}")
    emit(phase="f32_floor", nrow=512, ncol=64, runs=res,
         wide_stops_no_earlier=res["wide"]["k"] >= res["f32"]["k"])


def phase_wide_owlqn_main_path() -> dict:
    """The OWL-QN main path with the wide objective scalar: K7 once at the
    start, then K8 per probe, K14 and K13 per iteration.  12 iterations at
    epsilon 0 against the default run (the same iterations, fx rel 1e-3,
    tests/test_wide_fx.py:121-163), then the run to epsilon 3e-2."""
    wide = OWLQN_PARAMS.replace(fx_wide=True)
    x0 = rosenbrock.initial_point(N_BIG, torch.float32, "cuda")
    short = dict(epsilon=0.0, max_iterations=13)
    reset_counts()
    st_w = minimize_jit(wide.replace(**short), x0, default_evaluate(), return_state=True)
    lc, pc, used = launches(), plain_calls(), carried.used
    st_d = minimize_jit(OWLQN_PARAMS.replace(**short), x0, default_evaluate(),
                        return_state=True)
    rel = abs(float(st_w.prob.fx) / float(st_d.prob.fx) - 1)
    if type(st_w.prob.fx) is not np.float64 or st_w.k != st_d.k or not rel <= 1e-3:
        raise AssertionError(f"wide OWL-QN after 12: k {st_w.k} vs {st_d.k}, rel fx {rel}, "
                             f"fx {type(st_w.prob.fx).__name__}")
    _expect("wide OWL-QN, 12 iterations", lc, pc,
            **_wide_owlqn_launches(st_w.k - 1, st_w.prob.neval - 1, used))
    emit(phase="wide_owlqn_vs_default", iters=12, rel_fx=rel, fx_wide=float(st_w.prob.fx),
         fx_default=float(st_d.prob.fx), neval=(st_w.prob.neval, st_d.prob.neval))
    del st_w, st_d
    st, dt, lc, pc, reads = _run_2e24("wide OWL-QN main path", wide)
    used = carried.used
    _expect("wide OWL-QN main path", lc, pc,
            **_wide_owlqn_launches(st.k - 1, st.prob.neval - 1, used))
    _report_2e24("wide_owlqn_main_path", st, dt, lc, reads, eps=3e-2, carried_probes=used,
                 status_name=Status(st.status).name, fx_dtype=type(st.prob.fx).__name__,
                 gnorm=float(np.sqrt(st.prob.gnorm2)))
    del st
    torch.cuda.empty_cache()
    return lc


def _wide_owlqn_launches(iters: int, probes: int, used: int) -> dict:
    """The OWL-QN main path's launches with K7 in K1's place at the start."""
    want = _owlqn_launches(iters, probes, used)
    want["K7_owlqn_trial"] = want.pop("K1_trial")
    return want


def phase_owlqn_north_star() -> None:
    """OWL-QN at n = 1e8, m = 3, bf16 history, c = 1 on [0, n - 1), epsilon
    3e-2 within 300 iterations: the configuration the wide objective scalar
    was built for, wide and then default, with each run's status."""
    n = 100_000_000
    params = LbfgsParams(
        m=3, history_dtype="bfloat16", constrain_step_size=False, epsilon=3e-2,
        max_iterations=301, orthantwise=Orthantwise(1.0, 0, n - 1),
    ).replace_ls(algorithm=LineSearchAlgorithm.BacktrackingArmijo)
    x0 = rosenbrock.initial_point(n, torch.float32, "cuda")
    for wide in (True, False):
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st = minimize_jit(params.replace(fx_wide=wide), x0, default_evaluate(),
                          return_state=True)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        lc = launches()
        fx = st.prob.fx
        if not np.isfinite(fx) or (wide and lc["K7_owlqn_trial"] != 1):
            raise AssertionError(f"OWL-QN n=1e8 (wide={wide}): fx {fx}, launches {lc}")
        emit(phase="owlqn_north_star", n=n, m=3, eps=3e-2, fx_wide=wide, status=st.status,
             status_name=Status(st.status).name, iters=st.k - 1, evals=st.prob.neval,
             seconds=dt, ms_per_iter=1e3 * dt / max(st.k - 1, 1), fx=float(fx),
             fx_dtype=type(fx).__name__, gnorm=float(np.sqrt(st.prob.gnorm2)),
             launches={k: v for k, v in lc.items() if v})
        del st
        torch.cuda.empty_cache()


def phase_north_star() -> None:
    n = 100_000_000
    params = LbfgsParams(m=3, history_dtype="bfloat16", constrain_step_size=False,
                         epsilon=3e-2)
    x0 = rosenbrock.initial_point(n, torch.float32, "cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st = minimize_jit(params, x0, default_evaluate(), return_state=True)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    if st.status != Status.CONVERGED:
        raise AssertionError(f"n=1e8 did not converge: status {st.status}")
    emit(phase="north_star", n=n, m=3, eps=3e-2, iters=st.k - 1, seconds=dt,
         ms_per_iter=1e3 * dt / max(st.k - 1, 1), fx=float(st.prob.fx))


# ---------------------------------------------------------------------------
# The combine+probe fusions against the unfused paths, the adaptive entry
# step and the launch overhead
# ---------------------------------------------------------------------------


#: the fused run against the unfused run, and the fused run's plain
#: versions against its kernels: the same iterations (and evaluations) and
#: fx within rel 1e-3 after 8 iterations (tests/test_combine_probe.py:
#: 113-116); after 15 printed
FUSION_TOL_8 = 1e-3


def _fusion_trajectories(name: str, params: LbfgsParams) -> None:
    """After 8 and 15 iterations at epsilon 0: the fused run against the
    same run on the objective without the fusion's hooks, and the fused
    run through the plain versions against the kernels; asserted after 8,
    printed after 15."""
    x0 = rosenbrock.initial_point(N_BIG, torch.float32, "cuda")
    fn = default_evaluate()
    for n_it in (8, 15):
        p = params.replace(epsilon=0.0, max_iterations=n_it + 1)
        st_on = minimize_jit(p, x0, fn, return_state=True)
        st_pl = minimize_jit(p, x0, fn.plain, return_state=True)
        st_off = minimize_jit(p, x0, unfused(fn), return_state=True)
        rel_off = abs(float(st_on.prob.fx) / float(st_off.prob.fx) - 1)
        rel_pl = abs(float(st_on.prob.fx) / float(st_pl.prob.fx) - 1)
        key = lambda st: (st.k, st.prob.neval)
        if n_it == 8 and not (key(st_on) == key(st_off) == key(st_pl)
                              and st_on.k == n_it + 1
                              and max(rel_off, rel_pl) <= FUSION_TOL_8):
            raise AssertionError(
                f"{name} after 8 iterations: k/neval fused {key(st_on)}, unfused "
                f"{key(st_off)}, plain {key(st_pl)}; rel fx vs unfused {rel_off:.3e}, vs "
                f"plain {rel_pl:.3e}")
        emit(phase=f"{name}_trajectory", iters=n_it, k_neval_fused=key(st_on),
             k_neval_unfused=key(st_off), k_neval_plain=key(st_pl), rel_fx_vs_unfused=rel_off,
             rel_fx_vs_plain=rel_pl, fx_tol=FUSION_TOL_8, asserted=n_it == 8,
             x_err_vs_unfused=err(st_on.prob.x, st_off.prob.x))
        del st_on, st_pl, st_off
    _agreement(name, params)


def _agreement(name: str, params: LbfgsParams) -> None:
    """Step the fused and the unfused run side by side (``LbfgsState``)
    until either stops or their evaluations part, and print for how many
    iterations the two agree: bit for bit (iterate and fx), and in their
    evaluations.  The directions are the same bit for bit (K15 against K3,
    K16 against K13, K15's fix form against K6), but r.r and r.g come from
    other reduction trees, so a search that interpolates may step
    otherwise in the last bits."""
    x0 = rosenbrock.initial_point(N_BIG, torch.float32, "cuda")
    b = Lbfgs(params)
    runs = [b.build(x0, fn) for fn in (default_evaluate(), unfused(default_evaluate()))]
    bits, evals, rel = 0, 0, 0.0

    def step(run):
        # a run that ends in an error status (at epsilon 0 the last
        # iterations may) stops both; its status is printed
        try:
            return run.propagate()
        except LbfgsError:
            return None

    while not any([r.is_converged() for r in runs]):
        on, off = (step(r) for r in runs)
        if on is None or off is None or (on.niter, on.neval) != (off.niter, off.neval):
            break
        evals = on.niter
        rel = max(rel, abs(on.fx / off.fx - 1) if off.fx else abs(on.fx))
        if bits == on.niter - 1 and on.fx == off.fx and same_bits(on.x, off.x):
            bits = on.niter
    emit(phase=f"{name}_agreement", iters_bit_identical=bits, iters_same_evals=evals,
         max_rel_fx_while_same_evals=rel, stopped_at=[int(r.state.k) for r in runs],
         statuses=[int(r.state.status) for r in runs])
    del runs
    torch.cuda.empty_cache()


def _walls(params: LbfgsParams) -> dict:
    """ms per iteration of ``minimize_jit`` at n = 2^24 with the fusion and
    without it, in turns (off, on, on, off, off, on): the host's pace
    drifts within a call, so the two are compared only side by side."""
    x0 = rosenbrock.initial_point(N_BIG, torch.float32, "cuda")
    fn = default_evaluate()
    out = {"off": [], "on": []}
    for on in (False, True, True, False, False, True):
        runs = []
        dt = profiling.timed(lambda: runs.append(
            minimize_jit(params, x0, fn if on else unfused(fn), return_state=True)), warmup=0)
        out["on" if on else "off"].append(1e3 * dt / (runs[0].k - 1))
        del runs
    return out


def _unfused_run(name: str, params: LbfgsParams, fused: dict, expect, converged: bool):
    """One timed ``minimize_jit`` of a main path on the objective without
    the fusion's hooks: its launches are ``expect(iters, probes)``, no
    plain version runs and no first trip is carried in; printed beside
    the fused run ``fused`` of this call, with ms/iter of both in turns.
    The fusion must save at least half a read per iteration."""
    st, dt, lc, pc, reads = _run_2e24(name, params, unfused(default_evaluate()))
    iters, probes = st.k - 1, st.prob.neval - 1
    if converged and st.status != Status.CONVERGED:
        raise AssertionError(f"{name}: status {st.status} after {iters} iterations")
    _expect(name, lc, pc, **expect(iters, probes))
    if carried.used:
        raise AssertionError(f"{name}: {carried.used} carried first trips without the fusion")
    out = _report_2e24(
        name.replace(" ", "_"), st, dt, lc, reads,
        fused={k: fused[k] for k in ("iters", "evals", "ms_per_iter", "syncs_per_iter",
                                     "probes_per_iter")},
        ms_per_iter_in_turns=_walls(params))
    if not fused["syncs_per_iter"] <= out["syncs_per_iter"] - 0.5:
        raise AssertionError(f"{name}: {fused['syncs_per_iter']} syncs per iteration with the "
                             f"fusion against {out['syncs_per_iter']} without")
    del st
    torch.cuda.empty_cache()
    return lc, out


def phase_unfused_main_path(fused: dict) -> tuple:
    """The main path without the fusion: K3 in place of K15, K2 on every
    probe (``fused``: the main path of this call)."""
    lc, out = _unfused_run(
        "unfused main path", MAIN_PARAMS, fused,
        lambda it, pr: dict(K1_trial=1, K2_probe=pr, K3_combine=it, K4_trial_pair_gram=it),
        converged=False)
    _fusion_trajectories("main_path_vs_unfused", MAIN_PARAMS)
    return lc, out


def phase_unfused_owlqn_main_path(fused: dict) -> tuple:
    """The OWL-QN main path without the fusion: K13 in place of K16,
    CONVERGED at 3e-2."""
    lc, out = _unfused_run(
        "unfused OWL-QN main path", OWLQN_PARAMS, fused,
        lambda it, pr: dict(K1_trial=1, K10_pseudo_gradient_norm=1, K8_owlqn_probe=pr,
                            K13_combine_ow=it, K14_owlqn_trial_pair_gram=it),
        converged=True)
    _fusion_trajectories("owlqn_main_path_vs_unfused", OWLQN_PARAMS)
    return lc, out


def phase_unfused_damped_main_path(fused: dict) -> dict:
    """The damped main path without the fusion: K6 persists the damped row
    in place of K15's fix form; then the damped main path against it and
    against its plain versions after 8 and 15 iterations."""
    lc, _ = _unfused_run(
        "unfused damped main path", DAMPED_PARAMS, fused,
        lambda it, pr: dict(K1_trial=1, K2_probe=pr, K4_trial_pair_gram_gp=it,
                            K6_combine_fix=it),
        converged=False)
    _fusion_trajectories("damped_main_path_vs_unfused", DAMPED_PARAMS)
    return lc


def phase_adaptive_entry(literal: dict) -> dict:
    """The OWL-QN main path with ``with_adaptive_entry_step(2.0)``, with and
    without the fusion: each CONVERGED; evaluations beside the literal
    run's (``literal``).  Then the JAX package's own case at n = 2^14
    (``tests/test_adaptive_entry.py:93-115``: c = 1 on the whole vector,
    f32 history, at most 400 iterations), literal and adaptive, to set the
    main path's count beside the scale the policy was measured at."""
    params = OWLQN_PARAMS.replace(adaptive_entry_step=2.0)
    runs = {}
    for on in (True, False):
        name = "adaptive entry" + ("" if on else " unfused")
        fn = default_evaluate()
        st, dt, lc, pc, reads = _run_2e24(name, params, fn if on else unfused(fn))
        used = carried.used
        iters, probes = st.k - 1, st.prob.neval - 1
        if st.status != Status.CONVERGED:
            raise AssertionError(f"{name}: status {st.status} after {iters} iterations")
        want = _owlqn_launches(iters, probes, used)
        if not on:
            want["K13_combine_ow"] = want.pop("K16_combine_ow_probe")
        _expect(name, lc, pc, **want)
        if on:
            _carried_all(name, used, iters)
        runs[on] = _report_2e24(
            "adaptive_entry", st, dt, lc, reads, fusion=on, growth=2.0, eps=3e-2,
            carried_probes=used, literal_evals=literal["evals"],
            literal_iters=literal["iters"], literal_ms_per_iter=literal["ms_per_iter"],
            gnorm=float(np.sqrt(st.prob.gnorm2)))
        del st
    n = 1 << 14
    small = LbfgsParams(epsilon=3e-2, max_iterations=400, constrain_step_size=False,
                        orthantwise=Orthantwise(1.0, 0, None))
    x0 = rosenbrock.initial_point(n, torch.float32, "cuda")
    at_2e14 = {}
    for growth in (0.0, 2.0):
        st = minimize_jit(small.replace(adaptive_entry_step=growth), x0, default_evaluate(),
                          return_state=True)
        if st.status != Status.CONVERGED:
            raise AssertionError(f"adaptive entry at n = 2^14 (growth {growth}): status "
                                 f"{st.status}")
        at_2e14[growth] = dict(iters=st.k - 1, evals=st.prob.neval, fx=float(st.prob.fx))
    emit(phase="adaptive_entry_2e14", n=n, literal=at_2e14[0.0], adaptive=at_2e14[2.0])
    torch.cuda.empty_cache()
    return runs


# ---------------------------------------------------------------------------
# The factory's extras: the separable models at full width; deep histories;
# booth
# ---------------------------------------------------------------------------

#: bench.py's quadratic row (bench.py:72-77, 112-138) at the main path's
#: widths: n = 2^24, f32 vectors, m = 6, bf16 history, More-Thuente,
#: uncapped step, x0 = 0, epsilon 1e-4
QUAD_PARAMS = MAIN_PARAMS.replace(epsilon=1e-4, max_iterations=101)
#: the diagonal LASSO on the same objective (tests/test_factory_objective.py:
#: 243-276): c = 0.3 on [0, n), BacktrackingArmijo, epsilon 1e-4
LASSO_C = 0.3
LASSO_PARAMS = QUAD_PARAMS.replace(
    max_iterations=301, orthantwise=Orthantwise(LASSO_C, 0, N_BIG),
).replace_ls(algorithm=LineSearchAlgorithm.BacktrackingArmijo)
#: the damped quartic (tests/test_factory_objective.py:227-240, damped):
#: epsilon 1e-5, x0 = N(0, 1)
QUARTIC_PARAMS = MAIN_PARAMS.replace(damping=True, epsilon=1e-5, max_iterations=201)


def _busy_per_iter(params: LbfgsParams, x0, fn) -> float | None:
    """Device busy ms per iteration of one profiled ``minimize_jit`` (the
    summed durations of the kernels and copies on the card), None where
    every profiler session came back empty."""
    prof, st = profiled(lambda: minimize_jit(params, x0, fn, return_state=True))
    if prof is None:
        return None
    busy = sum(e.self_device_time_total for e in device_events(prof)) / 1e3
    return busy / (st.k - 1)


def _vs_twin(name: str, params: LbfgsParams, x0, fn) -> dict:
    """The run after 8 iterations at epsilon 0 through the kernels against
    the same run through the objective's plain twin on the card: the same
    iterations and evaluations, fx within rel ``FUSION_TOL_8``."""
    p = params.replace(epsilon=0.0, max_iterations=9)
    st_k = minimize_jit(p, x0, fn, return_state=True)
    st_p = minimize_jit(p, x0, fn.plain, return_state=True)
    rel = abs(float(st_k.prob.fx) / float(st_p.prob.fx) - 1)
    key = lambda st: (st.k, st.prob.neval)
    if not (key(st_k) == key(st_p) and st_k.k == 9 and rel <= FUSION_TOL_8):
        raise AssertionError(f"{name} against its plain twin after 8 iterations: k/neval "
                             f"{key(st_k)} vs {key(st_p)}, rel fx {rel:.3e}")
    out = dict(iters=8, k_neval=key(st_k), k_neval_plain=key(st_p), rel_fx=rel,
               fx_tol=FUSION_TOL_8, x_err=err(st_k.prob.x, st_p.prob.x))
    del st_k, st_p
    return out


def phase_quadratic_main_path() -> dict:
    """bench.py's quadratic row through the kernels with two extras: K1
    once, K4 and K15 per iteration, K2 per probe K15 did not carry in; x
    held to t (rtol and atol 1e-3, tests/test_factory_objective.py:216-218);
    then against the plain twin after 8 iterations."""
    w, t = quadratic_data(N_BIG, SEED + 11)
    obj = separable.quadratic(w, t)
    EXTRAS["quadratic"] = obj
    x0 = torch.zeros(N_BIG, device="cuda")
    st, dt, lc, pc, reads = _run_2e24("quadratic main path", QUAD_PARAMS, obj, x0)
    used = carried.used
    iters, probes = st.k - 1, st.prob.neval - 1
    if st.status != Status.CONVERGED:
        raise AssertionError(f"quadratic main path: status {st.status} after {iters}")
    _expect("quadratic main path", lc, pc, K1_trial_ex=1, K2_probe_ex=probes - used,
            K4_trial_pair_gram_ex=iters, K15_combine_probe_ex=iters)
    _carried_all("quadratic main path", used, iters)
    gap = (st.prob.x - t).abs()
    bad = int((gap > 1e-3 + 1e-3 * t.abs()).sum())
    out = _report_2e24("quadratic_main_path", st, dt, lc, reads, eps=QUAD_PARAMS.epsilon,
                       extras=2, carried_probes=used,
                       device_busy_ms_per_iter=_busy_per_iter(QUAD_PARAMS, x0, obj),
                       max_abs_x_minus_t=float(gap.max()), x_outside_tol=bad,
                       x_tol=dict(rtol=1e-3, atol=1e-3))
    if bad:
        raise AssertionError(f"quadratic main path: {bad} elements of x off t")
    del st, gap
    emit(phase="quadratic_main_path_vs_plain", **_vs_twin("quadratic main path",
                                                           QUAD_PARAMS, x0, obj))
    torch.cuda.empty_cache()
    return lc, out


def phase_lasso_main_path() -> dict:
    """OWL-QN on the quadratic (c = 0.3 on [0, n), BacktrackingArmijo,
    epsilon 1e-4) through the kernels with two extras: K1 and K10 once,
    K14 and K16 per iteration, K8 per probe K16 did not carry in; x held
    to the soft-threshold oracle sign(t) max(|t| - c/w, 0) (rtol 1e-2,
    atol 2e-3, tests/test_factory_objective.py:243-276).  The float32
    objective scalar reaches epsilon here (PERF.md, section 6): no wide
    run."""
    obj = EXTRAS["quadratic"]
    w, t = obj.kernels.extras
    x0 = torch.zeros(N_BIG, device="cuda")
    st, dt, lc, pc, reads = _run_2e24("lasso main path", LASSO_PARAMS, obj, x0)
    used = carried.used
    iters, probes = st.k - 1, st.prob.neval - 1
    x_star = torch.sign(t) * torch.clamp(t.abs() - LASSO_C / w, min=0.0)
    gap = (st.prob.x - x_star).abs()
    bad = int((gap > 2e-3 + 1e-2 * x_star.abs()).sum())
    out = _report_2e24("lasso_main_path", st, dt, lc, reads, eps=LASSO_PARAMS.epsilon,
                       extras=2, c=LASSO_C, carried_probes=used,
                       status_name=Status(st.status).name,
                       gnorm=float(np.sqrt(st.prob.gnorm2)),
                       max_abs_x_minus_xstar=float(gap.max()), x_outside_tol=bad,
                       x_tol=dict(rtol=1e-2, atol=2e-3),
                       zeros_x=int((st.prob.x == 0).sum()), zeros_xstar=int((x_star == 0).sum()))
    if st.status != Status.CONVERGED or bad:
        raise AssertionError(f"lasso main path: status {st.status} after {iters} iterations, "
                             f"{bad} elements off the soft threshold")
    _expect("lasso main path", lc, pc, K1_trial_ex=1, K10_pseudo_gradient_norm=1,
            K8_owlqn_probe_ex=probes - used, K14_owlqn_trial_pair_gram_ex=iters,
            K16_combine_ow_probe_ex=iters)
    _carried_all("lasso main path", used, iters)
    del st, gap, x_star
    torch.cuda.empty_cache()
    return lc, out


def phase_lasso_variants() -> dict:
    """The lasso's two other forms, each to epsilon and held to the
    soft-threshold oracle as the lasso is: damped (K14's . gp form with
    the two extras per iteration) and with the wide objective scalar (the
    first trial is K7 with the extras at stp = 0, in K1's place)."""
    obj = EXTRAS["quadratic"]
    w, t = obj.kernels.extras
    x0 = torch.zeros(N_BIG, device="cuda")
    x_star = torch.sign(t) * torch.clamp(t.abs() - LASSO_C / w, min=0.0)
    out = {}
    for name, params in (("damped", LASSO_PARAMS.replace(damping=True)),
                         ("wide", LASSO_PARAMS.replace(fx_wide=True))):
        st, dt, lc, pc, reads = _run_2e24(f"lasso {name}", params, obj, x0)
        used = carried.used
        iters, probes = st.k - 1, st.prob.neval - 1
        gap = (st.prob.x - x_star).abs()
        bad = int((gap > 2e-3 + 1e-2 * x_star.abs()).sum())
        _report_2e24(f"lasso_{name}_main_path", st, dt, lc, reads, eps=params.epsilon,
                     extras=2, c=LASSO_C, carried_probes=used,
                     status_name=Status(st.status).name,
                     fx_dtype=type(st.prob.fx).__name__,
                     max_abs_x_minus_xstar=float(gap.max()), x_outside_tol=bad)
        if st.status != Status.CONVERGED or bad:
            raise AssertionError(f"lasso {name}: status {st.status} after {iters} iterations, "
                                 f"{bad} elements off the soft threshold")
        first = "K7_owlqn_trial_ex" if name == "wide" else "K1_trial_ex"
        pair = ("K14_owlqn_trial_pair_gram_gp_ex" if name == "damped"
                else "K14_owlqn_trial_pair_gram_ex")
        _expect(f"lasso {name}", lc, pc, **{first: 1, pair: iters},
                K10_pseudo_gradient_norm=1, K8_owlqn_probe_ex=probes - used,
                K16_combine_ow_probe_ex=iters)
        _carried_all(f"lasso {name}", used, iters)
        out[name] = lc
        del st, gap
    del x_star
    torch.cuda.empty_cache()
    return {"K14_owlqn_trial_pair_gram_gp_ex": out["damped"]["K14_owlqn_trial_pair_gram_gp_ex"],
            "K7_owlqn_trial_ex": out["wide"]["K7_owlqn_trial_ex"]}


def phase_damped_quartic_main_path() -> dict:
    """The damped path on ``scaled_quartic(w)`` (one extra): K1 once, K4
    with its . gp column and K15's damped-row form per iteration, K2 per
    probe not carried in; fx < 1e-8 and max |x| < 1e-3 within the budget
    (tests/test_factory_objective.py:227-240); then against the plain twin
    after 8 iterations."""
    g = torch.Generator(device="cuda").manual_seed(SEED + 13)
    w = 0.5 + torch.rand(N_BIG, generator=g, device="cuda")
    x0 = torch.randn(N_BIG, generator=g, device="cuda")
    obj = separable.scaled_quartic(w)
    EXTRAS["quartic"] = obj
    st, dt, lc, pc, reads = _run_2e24("damped quartic main path", QUARTIC_PARAMS, obj, x0)
    used = carried.used
    iters, probes = st.k - 1, st.prob.neval - 1
    fx, xmax = float(st.prob.fx), float(st.prob.x.abs().max())
    out = _report_2e24("damped_quartic_main_path", st, dt, lc, reads, extras=1,
                       eps=QUARTIC_PARAMS.epsilon, carried_probes=used,
                       status_name=Status(st.status).name, max_abs_x=xmax,
                       device_busy_ms_per_iter=_busy_per_iter(QUARTIC_PARAMS, x0, obj))
    if not (fx < 1e-8 and xmax < 1e-3):
        raise AssertionError(f"damped quartic: fx {fx}, max |x| {xmax} after {iters}")
    _expect("damped quartic main path", lc, pc, K1_trial_ex=1, K2_probe_ex=probes - used,
            K4_trial_pair_gram_gp_ex=iters, K15_combine_probe_fix_ex=iters)
    _carried_all("damped quartic main path", used, iters)
    del st
    emit(phase="damped_quartic_main_path_vs_plain",
         **_vs_twin("damped quartic main path", QUARTIC_PARAMS, x0, obj))
    torch.cuda.empty_cache()
    return lc, out


#: the deep-history path: Rosenbrock at n = 2^20 (at 2^24 the two bf16
#: rings of m = 80 rows hold 5.4 GB, and eight runs would take the time
#: limit's share of several main paths: ``phase_deep_main_path`` runs one
#: configuration at that width) with m = 80 ring rows, f32 vectors, bf16
#: history, 30 iterations at epsilon 0.  Above ``factory.MAX_M`` the solver
#: takes the deep forms of K4 and K15 (K14 and K16 under OWL-QN); an
#: objective without their hooks (``trial_only_objective``) takes the
#: any-depth route, K1, K5 (K12 under OWL-QN) and K3, K6 or K13
DEEP_N, DEEP_M = 1 << 20, 80
DEEP_CONFIGS = {
    "plain": MAIN_PARAMS.replace(m=DEEP_M, max_iterations=31),
    "damped": DAMPED_PARAMS.replace(m=DEEP_M, max_iterations=31),
    "owlqn": OWLQN_PARAMS.replace(m=DEEP_M, epsilon=0.0, max_iterations=31,
                                  orthantwise=Orthantwise(1.0, 0, DEEP_N - 1)),
    "damped_owlqn": DAMPED_OWLQN_PARAMS.replace(m=DEEP_M, epsilon=0.0, max_iterations=31,
                                                orthantwise=Orthantwise(1.0, 0, DEEP_N - 1)),
}
#: the two routes above 64 ring rows: the deep forms of the one-pass
#: epilogue and the combine+probe fusion, and the any-depth kernels
DEEP_ROUTES = {"epilogue": default_evaluate, "any_depth": trial_only_objective}
#: the depths the deep forms are checked at: one row past the static
#: forms, the deep-history path's, and past two groups of 64
DEEP_DEPTHS = (65, DEEP_M, 130)
#: a depth both forms of the epilogues take (several groups, the last one
#: partial), where the deep forms are held to the static ones
DEEP_VS_STATIC_M = 19
#: the deep forms' compiled kernels: K4 and K14, each with and without
#: the . gp column, K15 with and without its damped row, and K16, in the
#: three dtype pairs
DEEP_FORMS_COMPILED = 7 * len(DTYPES)


def _deep_launches(name: str, iters: int, evals: int, used: int, route: str) -> dict:
    """The deep-history runs' launches.  Through the deep forms (route
    "epilogue") those of the m = 6 path of the same name, with the deep
    forms' ``_m80`` counts: K1 once, K4 and K15 per iteration (damped: K4
    with the . gp column and K15-fix), K2 per probe the fusion did not carry
    in; under OWL-QN K1 and K10 once, K14 (damped: its . gp form) and K16
    per iteration, K8 per probe not carried in.  Through the any-depth
    route ("any_depth"): K1 at the start and at each accepted point, K2 per
    probe, K5 and K3 (damped: K6) per iteration; under OWL-QN K1 once, K7
    per accepted point, K8 per probe, K10 at the start and per iteration,
    K12 (damped: its . gp form) and K13 per iteration."""
    owlqn, damped = name in ("owlqn", "damped_owlqn"), name.startswith("damped")
    if route == "epilogue":
        if owlqn:
            want = _owlqn_launches(iters, evals - 1, used)
            del want["K14_owlqn_trial_pair_gram"], want["K16_combine_ow_probe"]
            want["K14_owlqn_trial_pair_gram" + ("_gp" if damped else "") + "_m80"] = iters
            want["K16_combine_ow_probe_m80"] = iters
            return want
        return {"K1_trial": 1, "K2_probe": evals - 1 - used,
                "K4_trial_pair_gram" + ("_gp" if damped else "") + "_m80": iters,
                "K15_combine_probe" + ("_fix" if damped else "") + "_m80": iters}
    if owlqn:
        k12 = "K12_pair_gram_xg_gp" if damped else "K12_pair_gram_xg"
        return {"K1_trial": 1, "K7_owlqn_trial": iters, "K8_owlqn_probe": evals - 1,
                "K10_pseudo_gradient_norm": 1 + iters, k12: iters, "K13_combine_ow": iters}
    combine = "K6_combine_fix" if damped else "K3_combine"
    return {"K1_trial": 1 + iters, "K2_probe": evals - 1, "K5_pair_gram": iters,
            combine: iters}


def _deep_run(label: str, name: str, params: LbfgsParams, x0, route: str,
              form: str = "mma") -> tuple:
    """One ``minimize_jit`` of a deep-history configuration through a route
    (``DEEP_ROUTES``), after a 3-iteration warm-up, its launches checked
    (``_deep_launches``; through the epilogue route every K4 or K14 in the
    tensor-core form ``form``, "mma" or "mma_rows"); returns (state,
    seconds, launches, host reads, carried first trips)."""
    fn = DEEP_ROUTES[route]()
    minimize_jit(params.replace(max_iterations=3), x0, fn, return_state=True)
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st = minimize_jit(params, x0, fn, return_state=True)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    lc, pc, reads, used = launches(), plain_calls(), to_host.reads, carried.used
    fx = float(st.prob.fx)
    if not np.isfinite(fx) or st.status not in (Status.CONVERGED, Status.MAX_ITERATIONS):
        raise AssertionError(f"{label} {name} ({route}): status {st.status}, fx {fx}")
    _expect(f"{label} {name} ({route})", lc, pc,
            **_deep_launches(name, st.k - 1, st.prob.neval, used, route))
    # f32 vectors over a bf16 ring of 80 rows: K4 and K14 in the tensor-core
    # form, every launch (the fold paths' rings: the row-block form); the
    # any-depth route launches neither
    ep = (st.k - 1) * (route == "epilogue")
    _expect_mma(f"{label} {name} ({route})", ep * (form == "mma"),
                name in ("owlqn", "damped_owlqn"), ep * (form == "mma_rows"))
    return st, dt, lc, reads, used


def _deep_routes(label: str, name: str, params: LbfgsParams, x0) -> tuple:
    """A deep-history configuration through both routes: each one counted
    run, then ms per iteration in turns (epilogue, any-depth, any-depth,
    epilogue), device busy ms per iteration of one profiled run, and each
    route against the plain versions after 8 iterations (``_vs_twin``);
    returns (the summed launches of the counted runs, the report)."""
    out, lc_all = {}, {}
    f0 = float(rosenbrock.probe_ref(x0, x0, 0.0)[0])
    for route in DEEP_ROUTES:
        st, dt, lc, reads, used = _deep_run(label, name, params, x0, route)
        iters, fx = st.k - 1, float(st.prob.fx)
        if not fx < f0:
            raise AssertionError(f"{label} {name} ({route}): fx {fx} from {f0}")
        out[route] = dict(iters=iters, evals=st.prob.neval, status=st.status, fx=fx,
                          seconds=dt, syncs_per_iter=reads / iters, carried_probes=used,
                          launches={k: v for k, v in lc.items() if v})
        for k, v in lc.items():
            lc_all[k] = lc_all.get(k, 0) + v
        del st
    for route in ("epilogue", "any_depth", "any_depth", "epilogue"):
        fn, runs = DEEP_ROUTES[route](), []
        dt = profiling.timed(lambda: runs.append(minimize_jit(params, x0, fn, return_state=True)),
                             warmup=0)
        out[route].setdefault("wall_ms_per_iter", []).append(1e3 * dt / (runs[0].k - 1))
        del runs
    for route in DEEP_ROUTES:
        out[route]["device_ms_per_iter"] = _busy_per_iter(params, x0, DEEP_ROUTES[route]())
        out[route]["vs_plain"] = _vs_twin(f"{label} {name} ({route})", params, x0,
                                          DEEP_ROUTES[route]())
    torch.cuda.empty_cache()
    return lc_all, out


def phase_deep_history() -> tuple:
    """m = 80 at n = 2^20: plain, damped, OWL-QN and damped OWL-QN on
    Rosenbrock (``DEEP_CONFIGS``) through the deep forms and through the
    any-depth route (``_deep_routes``); then the deep forms of K4, K14, K15
    and K16 at the depths ``DEEP_DEPTHS`` and K3, K5 (. gp form, the damped
    route's), K6, K12 (both forms) and K13 at m = 80 against their plain
    versions in the three dtype pairs (``check_deep_forms``,
    ``check_deep``), the deep epilogues against the static ones at a
    depth both take (``DEEP_VS_STATIC_M``, f32/bf16), the deep forms'
    registers and spills (``deep_compiled``), and every ``_m80`` kernel's
    time in f32/bf16 beside its bound at (n, m) = (2^20, 80)."""
    x0 = rosenbrock.initial_point(DEEP_N, torch.float32, "cuda")
    lc_all = {}
    for name, params in DEEP_CONFIGS.items():
        lc, out = _deep_routes("deep history", name, params, x0)
        emit(phase="deep_history", config=name, n=DEEP_N, m=DEEP_M, **out)
        for k, v in lc.items():
            lc_all[k] = lc_all.get(k, 0) + v
    errs = {name: (0.0, 0.0) for name in DEEP_KERNELS}
    for vd, hd in DTYPES:
        tv, ts = TOL[(vd, "vec")], TOL[(vd, "sum")]
        a = deep_inputs(vd, hd)
        check_deep(errs, a, f"m={DEEP_M} {vd} {hd}", tv, ts)
        del a
        for m in DEEP_DEPTHS:
            a = deep_inputs(vd, hd, m)
            bits = check_deep_forms(errs, a, f"m={m} {vd} {hd}", tv, ts)
            emit(phase="deep_forms_checked", m=m, dtypes=f"{vd}/{hd}".replace("torch.", ""),
                 scalar_sums_bit_for_bit_vs_m6=bits,
                 form=rosenbrock.trial_pair_gram.last_form.form)
            if m == DEEP_M and rosenbrock.trial_pair_gram.last_form.form == "mma_rows":
                # the deep fold forms, which these rings take at an n off a
                # multiple of 16, on the same inputs
                with static_forms_up_to(M):
                    bits = check_deep_forms(errs, a, f"m={m} {vd} {hd} fold", tv, ts)
                emit(phase="deep_forms_checked", m=m, dtypes=f"{vd}/{hd}".replace("torch.", ""),
                     scalar_sums_bit_for_bit_vs_m6=bits, form="deep")
            del a
        torch.cuda.empty_cache()
    # the deep epilogues against the static ones where both run (the other
    # dtype pairs: tests/test_torch_deep_fusions.py on the card), and the
    # tensor-core form, which f32 vectors over a bf16 ring take there,
    # against both
    a = deep_inputs(torch.float32, torch.bfloat16, DEEP_VS_STATIC_M)
    ts = TOL[(torch.float32, "sum")]
    with static_forms_up_to(M):
        deep = epilogue_outputs(a)
    with static_forms_up_to(DEEP_VS_STATIC_M):
        static = epilogue_outputs(a)
    tag = f"m={DEEP_VS_STATIC_M} f32/bf16"
    bits = forms_agree(deep, static, f"deep vs static {tag}", ts)
    mma = epilogue_outputs(a)
    if rosenbrock.trial_pair_gram.last_form.form != "mma":
        raise AssertionError(f"the solo epilogues at {tag} did not take the tensor-core form")
    forms_agree(mma, static, f"tensor cores vs static {tag}", ts, sums=True)
    forms_agree(mma, deep, f"tensor cores vs deep {tag}", ts, sums=True)
    emit(phase="deep_vs_static", m=DEEP_VS_STATIC_M, dtypes="float32/bfloat16",
         products_bit_for_bit=bits, mma_vectors_and_rings_bit_for_bit=True)
    del a, deep, static, mma
    deep_compiled()
    a = deep_inputs(torch.float32, torch.bfloat16)
    S, Y, xp0, pg = a["S"], a["Y"], a["xp0"], a["pg"]
    coefs = (a["gamma"], a["cs"], a["cy"])
    ca, cb = (torch.tensor(v, device="cuda") for v in (0.7, -0.2))
    hi = DEEP_N - 1
    x9 = fused.owlqn_trial_step(xp0, a["d"], torch.sign(xp0), STP, 0, hi)
    Yf = Y.clone()
    cases = {
        "K3_combine": (lambda: fused.combine(a["gp"], S, Y, *coefs),
                       lambda: fused.combine_ref(a["gp"], S, Y, *coefs)),
        "K5_pair_gram": (
            lambda: fused.pair_gram_sd(STP, a["d"], pg, a["gp"], S, Y, END, with_gp=True),
            lambda: fused.pair_gram_sd_ref(STP, a["d"], pg, a["gp"], S, Y, END, with_gp=True)),
        "K6_combine_fix": (lambda: fused.combine_fix(a["gp"], S, Y, *coefs, END, ca, cb),
                           lambda: fused.combine_fix_ref(a["gp"], S, Y, *coefs, END, ca, cb)),
        "K12_pair_gram_xg": (
            lambda: fused.pair_gram_xg(x9, xp0, pg, a["gp"], a["xp"], S, Y, END),
            lambda: fused.pair_gram_xg_ref(x9, xp0, pg, a["gp"], a["xp"], S, Y, END)),
        "K12_pair_gram_xg_gp": (
            lambda: fused.pair_gram_xg(x9, xp0, pg, a["gp"], a["xp"], S, Y, END, with_gp=True),
            lambda: fused.pair_gram_xg_ref(x9, xp0, pg, a["gp"], a["xp"], S, Y, END,
                                           with_gp=True)),
        "K13_combine_ow": (lambda: fused.combine_ow(pg, S, Y, *coefs, 0, hi),
                           lambda: fused.combine_ow_ref(pg, S, Y, *coefs, 0, hi)),
    }
    # the deep forms in the forms their paths run them (K14 and K16 with
    # c = 1 on [0, n - 1), K15's damped row on a ring of its own)
    for gp_form in (False, True):
        sfx = "_gp" if gp_form else ""
        cases["K4_trial_pair_gram" + sfx] = (
            lambda w=gp_form: rosenbrock.trial_pair_gram(a["xp"], a["d"], a["gp"], STP, S, Y,
                                                         END, with_gp=w),
            lambda w=gp_form: rosenbrock.trial_pair_gram_ref(a["xp"], a["d"], a["gp"], STP, S,
                                                             Y, END, with_gp=w))
        cases["K14_owlqn_trial_pair_gram" + sfx] = (
            lambda w=gp_form: rosenbrock.owlqn_trial_pair_gram(xp0, a["d"], a["gp"], pg, STP,
                                                               1.0, 0, hi, S, Y, END, with_gp=w),
            lambda w=gp_form: rosenbrock.owlqn_trial_pair_gram_ref(
                xp0, a["d"], a["gp"], pg, STP, 1.0, 0, hi, S, Y, END, with_gp=w))
    cases.update({
        "K15_combine_probe": (
            lambda: rosenbrock.combine_probe(a["gp"], a["xp"], S, Y, *coefs, 1.0),
            lambda: rosenbrock.combine_probe_ref(a["gp"], a["xp"], S, Y, *coefs, 1.0)),
        "K15_combine_probe_fix": (
            lambda: rosenbrock.combine_probe(a["gp"], a["xp"], S, Yf, *coefs, 1.0,
                                             fix=(END, ca, cb)),
            lambda: rosenbrock.combine_probe_ref(a["gp"], a["xp"], S, Yf, *coefs, 1.0,
                                                 fix=(END, ca, cb))),
        "K16_combine_ow_probe": (
            lambda: rosenbrock.combine_ow_probe(pg, xp0, S, Y, *coefs, 1.0, 0, hi, 1.0),
            lambda: rosenbrock.combine_ow_probe_ref(pg, xp0, S, Y, *coefs, 1.0, 0, hi, 1.0)),
    })
    times, bounds, timed_by, forms = {}, {}, {}, {}
    epilogues = {"K4": rosenbrock.trial_pair_gram, "K14": rosenbrock.owlqn_trial_pair_gram}
    for name, (kern, plain) in cases.items():
        k_ms, p_ms, k_by, p_by = kernel_vs_plain(kern, plain, 10)
        times[name + "_m80"], timed_by[name + "_m80"] = (k_ms, p_ms), (k_by, p_by)
        bounds[name + "_m80"] = bound(name, DEEP_N, 4, 2, DEEP_M)
        if name.split("_")[0] in epilogues:
            forms[name + "_m80"] = epilogues[name.split("_")[0]].last_form.kernel
    del a, S, Y, Yf, x9
    torch.cuda.empty_cache()
    # the row-block form at the depths the fold forms took until it came
    # (FOLD_ROWS), each held to its plain version (x, g, pg and the ring
    # rows bit for bit, sums and products normwise) and to the fold form on
    # the same inputs (x, g, pg, the rings and the changed flag bit for
    # bit), and timed beside its plain version and its bound
    fold_errs = {}
    for sfx, (vd, hd, m) in FOLD_ROWS.items():
        a = deep_inputs(vd, hd, m)
        tv, ts = TOL[(vd, "vec")], TOL[(vd, "sum")]
        hi = DEEP_N - 1
        fold = {
            "K4_trial_pair_gram": (
                lambda S, Y: rosenbrock.trial_pair_gram(a["xp"], a["d"], a["gp"], STP, S, Y, END),
                lambda S, Y: rosenbrock.trial_pair_gram_ref(a["xp"], a["d"], a["gp"], STP, S, Y,
                                                            END), (0, 2), (1, 3, 4, 5, 7, 8)),
            "K14_owlqn_trial_pair_gram": (
                lambda S, Y: rosenbrock.owlqn_trial_pair_gram(a["xp0"], a["d"], a["gp"], a["pg"],
                                                              STP, 1.0, 0, hi, S, Y, END),
                lambda S, Y: rosenbrock.owlqn_trial_pair_gram_ref(
                    a["xp0"], a["d"], a["gp"], a["pg"], STP, 1.0, 0, hi, S, Y, END),
                (0, 1, 2), (3, 4, 5, 6)),
        }
        for name, (kern, plain, vecs, sums) in fold.items():
            row = name + sfx
            Sk, Yk, Sp, Yp, Sf, Yf = (a[r].clone() for r in ("S", "Y") * 3)
            k_out, p_out = kern(Sk, Yk), plain(Sp, Yp)
            fn = epilogues[name.split("_")[0]]
            f = fn.last_form
            if f.form != "mma_rows":
                raise AssertionError(f"{row}: the {f.form} form ran")
            solo_form(fn, DEEP_N)
            if not (same_bits(Sk, Sp) and same_bits(Yk, Yp)
                    and all(same_bits(k_out[i], p_out[i]) for i in vecs)):
                raise AssertionError(f"{row}: x, g, pg or the rings differ from the plain "
                                     f"version's")
            with static_forms_up_to(M):
                f_out = kern(Sf, Yf)
            flag = 7 if name.startswith("K14") else 6
            if not (same_bits(Sk, Sf) and same_bits(Yk, Yf)
                    and all(same_bits(k_out[i], f_out[i]) for i in vecs + (flag,))):
                raise AssertionError(f"{row}: x, g, pg, the rings or the flag differ from the "
                                     f"fold form's")
            fold_errs[row] = (0.0, 0.0)
            _fold(fold_errs, row, *(check(f"{row} out{i}", k_out[i], p_out[i], tv) for i in vecs),
                  *(check(f"{row} out{i}", k_out[i], p_out[i], ts) for i in sums))
            del Sk, Yk, Sp, Yp, Sf, Yf, k_out, p_out, f_out
            k_ms, p_ms, k_by, p_by = kernel_vs_plain(lambda: kern(a["S"], a["Y"]),
                                                     lambda: plain(a["S"], a["Y"]), 10)
            times[row], timed_by[row], forms[row] = (k_ms, p_ms), (k_by, p_by), f.kernel
            bounds[row] = bound(row, DEEP_N, vd.itemsize, hd.itemsize, m)
        del a
        torch.cuda.empty_cache()
    emit(phase="deep_kernel_times", n=DEEP_N, m=DEEP_M, dtype="f32/bf16 (and FOLD_ROWS)",
         forms=forms,
         device_ms={k: {"kernel": v[0], "plain": v[1], "bound": bounds[k][0]}
                    for k, v in times.items()},
         timed_by={k: {"kernel": v[0], "plain": v[1]} for k, v in timed_by.items()},
         max_abs_err={**{k + "_m80": v[0] for k, v in errs.items()},
                      **{k: v[0] for k, v in fold_errs.items()}},
         max_normwise_err={**{k + "_m80": v[1] for k, v in errs.items()},
                           **{k: v[1] for k, v in fold_errs.items()}})
    # each _m80 row's launches on its route: the deep forms' own counts
    # through the deep forms, the any-depth kernels' through the any-depth
    # route (which alone launches them)
    return ({name + "_m80": lc_all[name + "_m80" if name in DEEP_FORMS else name]
             for name in DEEP_KERNELS},
            {"errs": {**{k + "_m80": v for k, v in errs.items()}, **fold_errs},
             "times": times, "bounds": bounds, "timed_by": timed_by})


#: the main path's settings (n = 2^24, f32 vectors, bf16 history,
#: More-Thuente, uncapped step) at m = 80, epsilon 0, at most 40
#: iterations: the deep forms at full width (two bf16 rings of 2.7 GB)
DEEP_MAIN_PARAMS = MAIN_PARAMS.replace(m=DEEP_M, max_iterations=41)


def phase_deep_main_path() -> dict:
    """``DEEP_MAIN_PARAMS`` through the deep forms (K1 once, K4 and K15 per
    iteration, K2 per probe K15 did not carry in) and through the any-depth
    route, as ``_deep_routes``: launches, device and wall ms and syncs per
    iteration in turns, each against its plain versions after 8
    iterations; then each route's pair + Gram pass and combine (deep K4
    and K15, K5 and K3) timed at this width beside their bounds."""
    x0 = rosenbrock.initial_point(N_BIG, torch.float32, "cuda")
    _, out = _deep_routes("deep main path", "plain", DEEP_MAIN_PARAMS, x0)
    ep = out["epilogue"]
    _carried_all("deep main path", ep["carried_probes"], ep["iters"])
    # each route's kernels at this width: the deep K4 and K15 (programs of
    # several tiles, factory.solo_epilogue_grid) and K5 and K3
    g = torch.Generator(device="cuda").manual_seed(SEED + 24)
    r = lambda *s: torch.randn(*s, generator=g, device="cuda")
    xp, d, gp = x0 + 0.1 * r(N_BIG), 0.1 * r(N_BIG), r(N_BIG)
    S, Y = r(DEEP_M, N_BIG).to(torch.bfloat16), r(DEEP_M, N_BIG).to(torch.bfloat16)
    coefs = (torch.tensor(0.8, device="cuda"), r(DEEP_M), r(DEEP_M))
    cases = {
        "K4_trial_pair_gram": lambda: rosenbrock.trial_pair_gram(xp, d, gp, STP, S, Y, END),
        "K15_combine_probe": lambda: rosenbrock.combine_probe(gp, xp, S, Y, *coefs, 1.0),
        "K5_pair_gram": lambda: fused.pair_gram_sd(STP, d, xp, gp, S, Y, END),
        "K3_combine": lambda: fused.combine(gp, S, Y, *coefs),
    }
    times = {}
    for name, fn in cases.items():
        fn()
        times[name] = dict(ms=min(device_time(fn, 5) for _ in range(2)),
                           timed_by=device_time.source,
                           bound=bound(name, N_BIG, 4, 2, DEEP_M)[0])
    times["K4_trial_pair_gram"]["form"] = solo_form(rosenbrock.trial_pair_gram, N_BIG)["kernel"]
    emit(phase="deep_main_path", n=N_BIG, m=DEEP_M, kernel_ms=times, **out)
    del xp, d, gp, S, Y
    torch.cuda.empty_cache()
    return out


class static_forms_up_to:
    """Inside, the fold forms alone run: the static K4, K14, K15 and K16
    take rings of at most ``m`` rows (``factory.EPILOGUE_MAX_M`` of every
    dtype pair and ``factory.MAX_M`` are m), the deep forms every deeper
    ring, and the tensor-core forms none (``factory.MMA_MAX_M`` is 0 and
    ``factory.MMA_ROWS_MIN_M`` past any depth): to hold the forms to each
    other at a depth several take."""

    def __init__(self, m: int):
        self.m = m

    def __enter__(self):
        self.saved = (factory.MAX_M, factory.EPILOGUE_MAX_M, factory.MMA_MAX_M,
                      factory.MMA_ROWS_MIN_M)
        factory.MAX_M, factory.MMA_MAX_M = self.m, 0
        factory.EPILOGUE_MAX_M = dict.fromkeys(factory.EPILOGUE_MAX_M, self.m)
        factory.MMA_ROWS_MIN_M = dict.fromkeys(factory.MMA_ROWS_MIN_M, 1 << 62)

    def __exit__(self, *exc):
        (factory.MAX_M, factory.EPILOGUE_MAX_M, factory.MMA_MAX_M,
         factory.MMA_ROWS_MIN_M) = self.saved


class rows_form_from:
    """Inside, the solo K4 and K14 take the tensor-core row-block form
    (``"mma_rows"``) at every depth from ``m`` rows in every dtype pair
    (the static forms up to m - 1 rows, the one-pass tensor-core form
    none): to time it against the fold forms at depths the routing gives
    to them."""

    def __init__(self, m: int):
        self.m = m

    def __enter__(self):
        self.saved = (factory.EPILOGUE_MAX_M, factory.MMA_MAX_M, factory.MMA_ROWS_MIN_M)
        factory.MMA_MAX_M = 0
        factory.EPILOGUE_MAX_M = {pair: min(cap, self.m - 1)
                                  for pair, cap in factory.EPILOGUE_MAX_M.items()}
        factory.MMA_ROWS_MIN_M = dict.fromkeys(factory.MMA_ROWS_MIN_M, self.m)

    def __exit__(self, *exc):
        factory.EPILOGUE_MAX_M, factory.MMA_MAX_M, factory.MMA_ROWS_MIN_M = self.saved


def deep_inputs(vd, hd, m: int = DEEP_M, n: int = DEEP_N) -> dict:
    """``inputs`` at n elements (2^20 by default) with rings and
    coefficients of m rows."""
    a = inputs(n, vd, hd, SEED + DEEP_M)
    g = torch.Generator(device="cuda").manual_seed(SEED + m + 1)
    r = lambda *s: torch.randn(*s, generator=g, device="cuda", dtype=torch.float64)
    a.update(S=r(m, n).to(hd), Y=r(m, n).to(hd), cs=r(m).to(vd), cy=r(m).to(vd))
    return a


def check_deep(errs: dict, a: dict, tag: str, tv: float, ts: float) -> None:
    """K3, K6, K13, K5 and K12 (both forms each) at m = 80 against their
    plain versions; ring rows (K5's, K12's and K6's fixed row) bit for bit,
    K12 . gp's columns 0-2 those of its 3-column launch."""
    S, Y, gp, pg, d = a["S"], a["Y"], a["gp"], a["pg"], a["d"]
    coefs = (a["gamma"], a["cs"], a["cy"])
    end = DEEP_M - 3
    k, p = fused.combine(gp, S, Y, *coefs), fused.combine_ref(gp, S, Y, *coefs)
    _fold(errs, "K3_combine", check(f"K3 r {tag}", k[0], p[0], tv),
          *(check(f"K3 sum{i} {tag}", k[i], p[i], ts) for i in (1, 2)))
    ca, cb = (torch.tensor(v, dtype=gp.dtype, device="cuda") for v in (0.7, -0.2))
    Yk, Yq = Y.clone(), Y.clone()
    k = fused.combine_fix(gp, S, Yk, *coefs, end, ca, cb)
    p = fused.combine_fix_ref(gp, S, Yq, *coefs, end, ca, cb)
    if not same_bits(Yk, Yq):
        raise AssertionError(f"K6's fixed ring differs from the plain version's {tag}")
    _fold(errs, "K6_combine_fix", check(f"K6 r {tag}", k[0], p[0], tv),
          *(check(f"K6 sum{i} {tag}", k[i], p[i], ts) for i in (1, 2)))
    del Yk, Yq
    k = fused.combine_ow(pg, S, Y, *coefs, 5, DEEP_N - 9)
    p = fused.combine_ow_ref(pg, S, Y, *coefs, 5, DEEP_N - 9)
    _fold(errs, "K13_combine_ow", check(f"K13 rc {tag}", k[0], p[0], tv),
          *(check(f"K13 sum{i} {tag}", k[i], p[i], ts) for i in (1, 2, 3)))
    check_k5_errs = {"K5_pair_gram": errs["K5_pair_gram"]}
    check_k5(check_k5_errs, tag, ts, d, pg, gp, S, Y, end)
    errs["K5_pair_gram"] = check_k5_errs["K5_pair_gram"]
    x = fused.owlqn_trial_step(a["xp0"], d, torch.sign(a["xp0"]), STP, 0, DEEP_N - 1)
    check_k12(errs, tag, ts, x, a["xp0"], pg, gp, a["xp"], S, Y, end)


def _same(name: str, got: tuple, want: tuple, idx) -> None:
    """Outputs ``idx`` of one launch bit for bit another's."""
    for i in idx:
        if not same_bits(got[i], want[i]):
            raise AssertionError(f"{name}: output {i} differs")


def check_deep_forms(errs: dict, a: dict, tag: str, tv: float, ts: float) -> dict:
    """The deep forms of K4 and K14 (each with and without the . gp column),
    K15 (and its damped row) and K16 at the inputs' ring depth against
    their plain versions and the kernels whose function they share: ring
    rows bit for bit the plain versions'; K4's and K14's x, g and pg, K4's
    objective and both changed flags bit for bit the static launch's at m
    = 6 on the same vectors, their scalar sums against it at the sum
    tolerance (torch's column sums of the partials split the programs by
    the array's width: ``forms_agree`` holds them bit for bit at a depth
    both forms take); the . gp launch's columns 0-2, other outputs and ring
    bit for bit the 3-column launch's; an in-place launch bit for bit the
    launch into fresh vectors; K15's r bit for bit K3's and its probe
    K2's, K15-fix's r and ring K6's, K16's rc K13's and its probe K8's pg
    form's; the other outputs against the plain versions at the normwise
    tolerances.  Rows of ``errs`` by the kernels' names (the deep-history
    phase reports them as their ``_m80`` rows).  Returns, for each
    epilogue form, whether its scalar sums came out bit for bit the static
    launch's all the same."""
    xp, xp0, d, gp, pg, S, Y = (a[k] for k in ("xp", "xp0", "d", "gp", "pg", "S", "Y"))
    m, n = S.shape
    end, lo, hi = m - 3, 5, n - 9
    coefs = (a["gamma"], a["cs"], a["cy"])
    ring = lambda: (S.clone(), Y.clone())
    S6, Y6 = S[:M].clone(), Y[:M].clone()
    # K4: x, fx, g and changed those of the static launch at m = 6
    st = rosenbrock.trial_pair_gram(xp, d, gp, STP, S6, Y6, END)
    base, sums_bits = None, {}
    for wg in (False, True):
        name, t = "K4_trial_pair_gram" + ("_gp" if wg else ""), f"K4 deep gp={wg} {tag}"
        Sk, Yk = ring()
        k = rosenbrock.trial_pair_gram(xp, d, gp, STP, Sk, Yk, end, with_gp=wg)
        # the tensor-core form sums the objective per chunk of its own, the
        # fold forms per tile of the static launch's
        fx_bits = (() if solo_form(rosenbrock.trial_pair_gram, n)["form"] in ("mma", "mma_rows")
                   else (1,))
        Sp, Yp = ring()
        p = rosenbrock.trial_pair_gram_ref(xp, d, gp, STP, Sp, Yp, end, with_gp=wg)
        check_ring(f"{t} kernel", Sk, Yk, S, Y, STP * d, k[2] - gp, end)
        check_ring(f"{t} plain", Sp, Yp, S, Y, STP * d, p[2] - gp, end)
        _same(f"{t} against the static launch", k, st, (0, 2, 6) + fx_bits)
        if bool(k[6]) != bool(p[6]):
            raise AssertionError(f"{t}: changed flag differs")
        _fold(errs, name, check(f"{t} x", k[0], p[0], tv), check(f"{t} g", k[2], p[2], tv),
              *(check(f"{t} sum{i}", k[i], p[i], ts) for i in (1, 3, 4, 5, 7, 8)),
              *(check(f"{t} sum{i} vs static", k[i], st[i], ts) for i in (1, 3, 4, 5)))
        sums_bits[name] = all(same_bits(k[i], st[i]) for i in (3, 4, 5))
        if wg:
            check_extends(t, base[0], k, (7, 8))
            if not (same_bits(Sk, base[1]) and same_bits(Yk, base[2])):
                raise AssertionError(f"{t}: ring differs from the 3-column launch")
        xi, gi = xp.clone(), gp.clone()
        Si, Yi = ring()
        ki = rosenbrock.trial_pair_gram(xi, d, gi, STP, Si, Yi, end, inplace=True, with_gp=wg)
        _same(f"{t} in place", ki, k, range(9))
        if not (same_bits(Si, Sk) and same_bits(Yi, Yk)):
            raise AssertionError(f"{t} in place: ring differs")
        base = (k, Sk, Yk)
        del Sp, Yp, Si, Yi, xi, gi
    # K14: x, g, pg and changed those of the static launch at m = 6
    S6, Y6 = S[:M].clone(), Y[:M].clone()
    st = rosenbrock.owlqn_trial_pair_gram(xp0, d, gp, pg, STP, C_L1, lo, hi, S6, Y6, END,
                                          with_gp=True)
    for wg in (False, True):
        name = "K14_owlqn_trial_pair_gram" + ("_gp" if wg else "")
        t = f"K14 deep gp={wg} {tag}"
        Sk, Yk = ring()
        k = rosenbrock.owlqn_trial_pair_gram(xp0, d, gp, pg, STP, C_L1, lo, hi, Sk, Yk, end,
                                             with_gp=wg)
        solo_form(rosenbrock.owlqn_trial_pair_gram, n)
        Sp, Yp = ring()
        p = rosenbrock.owlqn_trial_pair_gram_ref(xp0, d, gp, pg, STP, C_L1, lo, hi, Sp, Yp, end,
                                                 with_gp=wg)
        check_ring(f"{t} kernel", Sk, Yk, S, Y, k[0] - xp0, k[1] - gp, end)
        check_ring(f"{t} plain", Sp, Yp, S, Y, p[0] - xp0, p[1] - gp, end)
        _same(f"{t} against the static launch", k, st, (0, 1, 2, 7))
        if bool(k[7]) != bool(p[7]):
            raise AssertionError(f"{t}: changed flag differs")
        sums = (3, 4, 5, 6, 8, 9) if wg else (3, 4, 5, 6)
        _fold(errs, name, *(check(f"{t} {v}", k[i], p[i], tv)
                            for i, v in ((0, "x"), (1, "g"), (2, "pg"))),
              *(check(f"{t} sum{i}", k[i], p[i], ts) for i in sums),
              *(check(f"{t} sum{i} vs static", k[i], st[i], ts)
                for i in ((5, 6, 8, 9) if wg else (5, 6))))
        sums_bits[name] = all(same_bits(k[i], st[i]) for i in ((5, 6, 8, 9) if wg else (5, 6)))
        if wg:
            check_extends(t, base[0], k[:8], (3, 4))
            if not (same_bits(Sk, base[1]) and same_bits(Yk, base[2])):
                raise AssertionError(f"{t}: ring differs from the 3-column launch")
        xi, gi, pgi = xp0.clone(), gp.clone(), pg.clone()
        Si, Yi = ring()
        ki = rosenbrock.owlqn_trial_pair_gram(xi, d, gi, pgi, STP, C_L1, lo, hi, Si, Yi, end,
                                              inplace=True, with_gp=wg)
        _same(f"{t} in place", ki, k, range(len(k)))
        if not (same_bits(Si, Sk) and same_bits(Yi, Yk)):
            raise AssertionError(f"{t} in place: ring differs")
        base = (k, Sk, Yk)
        del Sp, Yp, Si, Yi, xi, gi, pgi
    del base, S6, Y6, st
    # K15 and its damped row against K3, K6 and K2
    k3 = fused.combine(gp, S, Y, *coefs)
    for stp1 in (1.0, 0.37):
        t = f"K15 deep stp1={stp1} {tag}"
        k = rosenbrock.combine_probe(gp, xp, S, Y, *coefs, stp1)
        p = rosenbrock.combine_probe_ref(gp, xp, S, Y, *coefs, stp1)
        _same(f"{t} r against K3's", k, k3, (0,))
        _same(f"{t} probe against K2's", k[3:], rosenbrock.probe(xp, k[0], stp1), (0, 1))
        _fold(errs, "K15_combine_probe", check(f"{t} r", k[0], p[0], tv),
              *(check(f"{t} sum{i}", k[i], p[i], ts) for i in (1, 2, 3, 4)))
    ca, cb = (torch.tensor(v, dtype=gp.dtype, device="cuda") for v in (0.7, -0.2))
    Yk, Yp, Y6 = Y.clone(), Y.clone(), Y.clone()
    t = f"K15-fix deep {tag}"
    k = rosenbrock.combine_probe(gp, xp, S, Yk, *coefs, 0.37, fix=(end, ca, cb))
    p = rosenbrock.combine_probe_ref(gp, xp, S, Yp, *coefs, 0.37, fix=(end, ca, cb))
    k6 = fused.combine_fix(gp, S, Y6, *coefs, end, ca, cb)
    if not (same_bits(Yk, Yp) and same_bits(Yk, Y6)):
        raise AssertionError(f"{t}: the damped row differs from the plain version's or K6's")
    _same(f"{t} r against K6's", k, k6, (0,))
    _same(f"{t} probe against K2's", k[3:], rosenbrock.probe(xp, k[0], 0.37), (0, 1))
    _fold(errs, "K15_combine_probe_fix", check(f"{t} r", k[0], p[0], tv),
          *(check(f"{t} sum{i}", k[i], p[i], ts) for i in (1, 2, 3, 4)))
    del Yk, Yp, Y6, k6
    # K16 against K13 and K8's pg form
    k13 = fused.combine_ow(pg, S, Y, *coefs, lo, hi)
    t = f"K16 deep {tag}"
    k = rosenbrock.combine_ow_probe(pg, xp0, S, Y, *coefs, C_L1, lo, hi, 1.0)
    p = rosenbrock.combine_ow_probe_ref(pg, xp0, S, Y, *coefs, C_L1, lo, hi, 1.0)
    _same(f"{t} rc against K13's", k, k13, (0,))
    _same(f"{t} probe against K8's", k[4:],
          rosenbrock.owlqn_probe_pg(xp0, k[0], pg, 1.0, C_L1, lo, hi), (0, 1))
    _fold(errs, "K16_combine_ow_probe", check(f"{t} rc", k[0], p[0], tv),
          *(check(f"{t} sum{i}", k[i], p[i], ts) for i in (1, 2, 3, 4, 5)))
    return sums_bits


def epilogue_outputs(a: dict) -> dict:
    """Every output (and the written rings) of K4 and K14, each with and
    without the . gp column, on the inputs, in whichever form
    ``factory.solo_epilogue_grid`` picks at their depth."""
    xp, xp0, d, gp, pg, S, Y = (a[k] for k in ("xp", "xp0", "d", "gp", "pg", "S", "Y"))
    n = S.shape[1]
    out = {}
    for wg in (False, True):
        Sk, Yk = S.clone(), Y.clone()
        out[f"K4 gp={wg}"] = (*rosenbrock.trial_pair_gram(xp, d, gp, STP, Sk, Yk, END,
                                                          with_gp=wg), Sk, Yk)
        Sk, Yk = S.clone(), Y.clone()
        out[f"K14 gp={wg}"] = (*rosenbrock.owlqn_trial_pair_gram(
            xp0, d, gp, pg, STP, C_L1, 5, n - 9, Sk, Yk, END, with_gp=wg), Sk, Yk)
    return out


#: the products in ``epilogue_outputs``: K4's SP and YP, K14's
PRODUCTS = {"K4 gp=False": (7, 8), "K4 gp=True": (7, 8), "K14 gp=False": (3, 4),
            "K14 gp=True": (3, 4)}
#: and their scalar sums: K4's fx, g.d, g.g, x.x; K14's x.x, pg.pg (with
#: the . gp column gp.gp, gp.pg)
SUMS = {"K4 gp=False": (1, 3, 4, 5), "K4 gp=True": (1, 3, 4, 5), "K14 gp=False": (5, 6),
        "K14 gp=True": (5, 6, 8, 9)}


def forms_agree(got: dict, want: dict, tag: str, ts: float, sums: bool = False) -> bool:
    """One form's epilogue outputs (``epilogue_outputs``) against another's
    at a depth both take: x, g, pg, the rings and the changed flags bit for
    bit; the products, which each form sums over its own layout, at the
    sum tolerance, and with ``sums`` the scalar sums too (the tensor-core
    form's partials are per chunk, not per tile); the deep and static
    forms' scalar sums bit for bit (the same partials' shapes, so torch
    sums their columns alike).  Returns whether the products agreed bit
    for bit too."""
    bits = True
    for key, outs in got.items():
        near = PRODUCTS.get(key, ()) + (SUMS.get(key, ()) if sums else ())
        for i, (g, w) in enumerate(zip(outs, want[key])):
            if i in near:
                check(f"{key} output {i} {tag}", g, w, ts)
                bits = bits and (i not in PRODUCTS[key] or same_bits(g, w))
            elif not same_bits(g, w):
                raise AssertionError(f"{key} output {i} differs {tag}")
    return bits


def _compiled_info(k) -> dict:
    k._init_handles()
    return dict(n_regs=k.n_regs, n_spills=k.n_spills)


def deep_compiled() -> list:
    """Registers and spills of every compiled deep form (K4 and K14 with and
    without the . gp column, K15 with and without its damped row, K16; one
    compile each for every depth, in the three dtype pairs); a form that
    spills, or a form missing, fails the phase."""
    forms = []
    k = rosenbrock.value_and_grad.kernels
    for form, fn in (("K4", k.trial_pair_gram), ("K14", k.owlqn_trial_pair_gram),
                     ("K15", k.combine_probe), ("K16", k.combine_ow_probe)):
        for (vd, hd, flag), ck in sorted(fn.deep_compiled.items(), key=str):
            forms.append(dict(form=form + ({"K15": "_fix"}.get(form, "_gp") if flag else ""),
                              vectors=str(vd).removeprefix("torch."),
                              history=str(hd).removeprefix("torch."), **_compiled_info(ck)))
    emit(phase="deep_compiled", forms=forms,
         group={"/".join(str(t).removeprefix("torch.") for t in k): v
                for k, v in factory.DEEP_GROUP.items()})
    if len(forms) != DEEP_FORMS_COMPILED:
        raise AssertionError(f"{len(forms)} deep forms compiled, {DEEP_FORMS_COMPILED} expected")
    spilled = [f for f in forms if f["n_spills"]]
    if spilled:
        raise AssertionError(f"deep forms spill registers: {spilled}")
    return forms


#: the solo tensor-core form's products against the float64 product of
#: the same operands: its depths (RP 32, 128, 256), the chunks per program
#: forced at n = 2^20 and 2^24 (``factory.SOLO_MMA_PROGRAMS`` and
#: ``factory.MMA_MAX_CHUNKS``), and the
#: widths below one chunk and off a whole chunk, which take the chosen
#: grid (off the 16-element alignment, 100 and 2^14 + 2, over the padded ring)
NUMERICS_DEPTHS = (DEEP_VS_STATIC_M, DEEP_M, 200)
NUMERICS_CHUNKS = (2, 32, 64, 256)
NUMERICS_SMALL_N = (64, 96, 100, (1 << 14) + 16, (1 << 14) + 2)
#: every solo tensor-core launch's form and compiled kernel that a check
#: held (``solo_form``), by kernel, RP and whether n is a multiple of 16
SOLO_FORMS = {}


def solo_form(fn, n: int) -> dict:
    """The form and geometry of a solo epilogue's last launch
    (``fn.last_form``, ``factory.solo_epilogue_grid``) and, for the
    tensor-core forms, its compiled kernel's registers and spills (and for
    the row-block form its passes and matrix instructions), kept in
    ``SOLO_FORMS``."""
    f = fn.last_form
    out = dict(kernel=f.kernel, form=f.form,
               dtypes="/".join(str(t).removeprefix("torch.") for t in f.dtypes),
               programs=f.programs, tiles_per_program=f.tiles, tile=f.T,
               **{key: v for key, v in f.consts.items() if key != "m"}, **f.launch)
    if f.form in ("mma", "mma_rows"):
        out.update(_compiled_info(f.compiled))
        if f.form == "mma_rows":
            out.update(passes=-(-f.consts["m"] // f.consts["RP"]), **_dot_instructions(f.compiled))
        SOLO_FORMS[(f.kernel, out["dtypes"], f.consts["RP"], n % 16 == 0)] = out
    return out


def _dot_instructions(ck) -> dict:
    """The matrix instructions in a compiled Triton kernel's PTX (``mma``,
    ``wgmma``), and its float64 fused multiply-adds: whether a float64
    ``tl.dot`` became Hopper's FP64 tensor-core MMA or an FMA loop."""
    ptx = ck.asm["ptx"]
    return dict(dot_instructions=sorted(set(re.findall(r"\b(?:wgmma|mma)\.[\w.]+", ptx))),
                fma_f64=len(re.findall(r"\bfma\.rn\.f64\b", ptx)))


def numerics_inputs(n: int, m: int, seed: int) -> dict:
    """Seeded f32 vectors (xp0: xp with zeros at every 17th element, and a
    pseudo-gradient pg) and bf16 rings of m rows at n elements in the
    solver's padded layout (``core.ring_zeros``), the rings made 16 rows at
    a time (at 2^24 x 200 a float32 draw of a whole ring would take 13
    GB)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=g, device="cuda")
    a = dict(xp=rosenbrock.initial_point(n, torch.float32, "cuda") + 0.1 * r(n),
             d=0.1 * r(n), gp=r(n), pg=r(n))
    a["xp0"] = a["xp"].clone()
    a["xp0"][::17] = 0.0
    for ring in ("S", "Y"):
        a[ring] = ring_zeros((m, n), torch.bfloat16, "cuda")
        for j in range(0, m, 16):
            a[ring][j:j + 16] = r(min(16, m - j), n)
    return a


def products_f64(S, Y, s, y, d0, gp, end: int) -> tuple:
    """SP and YP ([m, 4]: against y, s, d0 and gp) in float64 from the
    tensor-core form's own operands: the ring rows as stored, widened, row
    ``end`` the unrounded pair, and the float32 vectors widened."""
    V = torch.stack([y, s, d0, gp], dim=1).double()
    out = []
    for R, new in ((S, s), (Y, y)):
        P = torch.cat([R[j:j + 16].double() @ V for j in range(0, R.shape[0], 16)])
        P[end] = new.double() @ V
        out.append(P)
    return tuple(out)


def solo_mma_numerics() -> list:
    """The solo tensor-core K4's SP and YP with the . gp column against
    ``products_f64`` at ``NUMERICS_DEPTHS``: at n = 2^20 and 2^24 with
    ``NUMERICS_CHUNKS`` chunks per program (the program cap and the chunk
    bound forced) and at ``NUMERICS_SMALL_N`` on the chosen grid (over the
    padded ring the tensor-core form at every n), each normwise gap within the
    sum tolerance and printed beside its form and chunk count; at n = 2^20
    the deep fold form's gap beside them."""
    ts = TOL[(torch.float32, "sum")]
    k = rosenbrock.value_and_grad.kernels
    rows = []
    for m in NUMERICS_DEPTHS:
        end = m - 3
        for n in (DEEP_N, N_BIG) + NUMERICS_SMALL_N:
            a = numerics_inputs(n, m, SEED + 90 + m)
            ntiles = factory.solo_epilogue_grid(n, m, torch.float32, torch.bfloat16).ntiles
            s = torch.full((1,), STP, dtype=torch.float32, device="cuda") * a["d"]
            forced = [-(-ntiles // c) for c in NUMERICS_CHUNKS] if n >= DEEP_N else [None]
            for cap in forced:
                saved = factory.SOLO_MMA_PROGRAMS, factory.MMA_MAX_CHUNKS
                if cap:
                    factory.SOLO_MMA_PROGRAMS, factory.MMA_MAX_CHUNKS = cap, ntiles
                try:
                    out = k.trial_pair_gram(a["xp"], a["d"], a["gp"], STP, a["S"], a["Y"], end,
                                            with_gp=True)
                finally:
                    factory.SOLO_MMA_PROGRAMS, factory.MMA_MAX_CHUNKS = saved
                form = solo_form(k.trial_pair_gram, n)
                # the padded ring: the tensor-core form at every n
                want_form = "mma"
                if form["form"] != want_form:
                    raise AssertionError(f"numerics m={m} n={n}: the {form['form']} form ran")
                g = out[2]
                want = products_f64(a["S"], a["Y"], s, g - a["gp"], -g, a["gp"], end)
                tag = f"solo K4 {form['form']} m={m} n={n} chunks={form['tiles_per_program']}"
                row = dict(m=m, n=n, form=form["form"], RP=form.get("RP"),
                           programs=form["programs"],
                           chunks_per_program=form["tiles_per_program"],
                           sp_gap=check(f"{tag} SP vs float64", out[7], want[0], ts)[1],
                           yp_gap=check(f"{tag} YP vs float64", out[8], want[1], ts)[1])
                if n == DEEP_N and cap == forced[0]:
                    with static_forms_up_to(M):
                        fold = k.trial_pair_gram(a["xp"], a["d"], a["gp"], STP, a["S"],
                                                 a["Y"], end, with_gp=True)
                    row.update(fold_sp_gap=err(fold[7], want[0]), fold_yp_gap=err(fold[8], want[1]))
                    del fold
                rows.append(row)
                del out, want, g
            del a, s
            torch.cuda.empty_cache()
    rows += rows_form_numerics()
    emit(phase="solo_mma_numerics", rows=rows)
    return rows


#: the row-block form's products against the float64 product of the same
#: operands: at the ``FOLD_ROWS`` depths and pairs, n = 2^20, with the
#: program cap forced for these chunks a program, within the vectors'
#: dtype's bound
ROWS_CHUNKS = (2, 32, 64)
ROWS_PRODUCT_TOL = {torch.float32: 1e-6, torch.float64: 1e-12}


def rows_form_numerics() -> list:
    """The row-block K4's and K14's SP and YP with the . gp column (its 3
    columns are the 3-column launch's bit for bit) against
    ``products_f64`` at each ``FOLD_ROWS`` row with ``ROWS_CHUNKS`` chunks
    a program, each gap within ``ROWS_PRODUCT_TOL``; the deep fold form's
    gap beside them."""
    k = rosenbrock.value_and_grad.kernels
    rows = []
    for sfx, (vd, hd, m) in FOLD_ROWS.items():
        a = deep_inputs(vd, hd, m)
        hi = DEEP_N - 1
        tol = ROWS_PRODUCT_TOL[vd]
        ntiles = factory.solo_epilogue_grid(DEEP_N, m, vd, hd).ntiles

        def k4():
            out = k.trial_pair_gram(a["xp"], a["d"], a["gp"], STP, a["S"], a["Y"], END,
                                    with_gp=True)
            g = out[2]
            s = torch.full((1,), STP, dtype=vd, device="cuda") * a["d"]
            return k.trial_pair_gram, out[7:9], (s, g - a["gp"], -g)

        def k14():
            out = k.owlqn_trial_pair_gram(a["xp0"], a["d"], a["gp"], a["pg"], STP, 1.0, 0, hi,
                                          a["S"], a["Y"], END, with_gp=True)
            return k.owlqn_trial_pair_gram, out[3:5], (out[0] - a["xp0"], out[1] - a["gp"],
                                                       -out[2])

        for name, call in (("K4", k4), ("K14", k14)):
            for chunks in ROWS_CHUNKS:
                saved = factory.SOLO_MMA_PROGRAMS, factory.MMA_MAX_CHUNKS
                factory.SOLO_MMA_PROGRAMS, factory.MMA_MAX_CHUNKS = -(-ntiles // chunks), chunks
                try:
                    fn, (SP, YP), (s, y, d0) = call()
                finally:
                    factory.SOLO_MMA_PROGRAMS, factory.MMA_MAX_CHUNKS = saved
                form = solo_form(fn, DEEP_N)
                if form["form"] != "mma_rows" or form["tiles_per_program"] != chunks:
                    raise AssertionError(f"numerics {name}{sfx}: {form}")
                want = products_f64(a["S"], a["Y"], s, y, d0, a["gp"], END)
                tag = f"row-block {name}{sfx} chunks={chunks}"
                row = dict(kernel=name + sfx, m=m, n=DEEP_N, dtypes=form["dtypes"],
                           form=form["form"], RP=form["RP"], passes=form["passes"],
                           programs=form["programs"],
                           chunks_per_program=chunks, tol=tol,
                           sp_gap=check(f"{tag} SP vs float64", SP, want[0], tol)[1],
                           yp_gap=check(f"{tag} YP vs float64", YP, want[1], tol)[1])
                if chunks == ROWS_CHUNKS[-1]:
                    with static_forms_up_to(M):
                        _, (SP, YP), (s, y, d0) = call()
                    want = products_f64(a["S"], a["Y"], s, y, d0, a["gp"], END)
                    row.update(fold_sp_gap=err(SP, want[0]), fold_yp_gap=err(YP, want[1]))
                rows.append(row)
                del SP, YP, want
        del a
        torch.cuda.empty_cache()
    return rows


def solo_mma_compiled() -> list:
    """Registers and spills of every solo tensor-core kernel the checks
    launched (``SOLO_FORMS``: K4 and K14 by RP, n a multiple of 16 or
    not); a form that spills, or none at all, fails the phase."""
    forms = [dict(f, n_multiple_of_16=div16) for (*_, div16), f in
             sorted(SOLO_FORMS.items(), key=str)]
    emit(phase="solo_mma_compiled", programs_max=factory.SOLO_MMA_PROGRAMS,
         chunks_max=factory.MMA_MAX_CHUNKS, forms=forms)
    if not forms:
        raise AssertionError("no solo tensor-core form was launched")
    spilled = [f for f in forms if f["n_spills"]]
    if spilled:
        raise AssertionError(f"solo tensor-core forms spill registers: {spilled}")
    return forms


def phase_solo_mma_kernels() -> None:
    """The solo tensor-core epilogues' products against the float64 product
    (``solo_mma_numerics``), then the registers and spills of every solo
    tensor-core kernel launched so far (``solo_mma_compiled``)."""
    solo_mma_numerics()
    solo_mma_compiled()


#: the iterations of each fold path (``phase_deep_fold_paths``)
DEEP_FOLD_ITERS = 11


def phase_deep_fold_paths() -> dict:
    """The depths the solo K4 and K14 took in their fold forms until the
    row-block form (``FOLD_ROWS``: f32 and f64 rings at m = 80, a bf16 ring
    at m = 260, n = 2^20), each through the deep-history path's plain and
    OWL-QN settings (``DEEP_CONFIGS``), 10 iterations of ``minimize_jit``:
    the launches checked (``_deep_run``: every K4 and K14 launch in the
    row-block form), fx finite; returns each row's launches (the row-block
    form's count)."""
    k = rosenbrock.value_and_grad.kernels
    lc_rows = {}
    for sfx, (vd, hd, m) in FOLD_ROWS.items():
        x0 = rosenbrock.initial_point(DEEP_N, vd, "cuda")
        for name, kern, fn in (("plain", "K4_trial_pair_gram", k.trial_pair_gram),
                               ("owlqn", "K14_owlqn_trial_pair_gram", k.owlqn_trial_pair_gram)):
            params = DEEP_CONFIGS[name].replace(m=m, history_dtype=str(hd)[6:],
                                                max_iterations=DEEP_FOLD_ITERS)
            st, dt, lc, reads, _ = _deep_run("deep fold path", name, params, x0, "epilogue",
                                             form="mma_rows")
            lc_rows[kern + sfx] = fn.mma_rows_launches
            emit(phase="deep_fold_path", config=name, row=kern + sfx, n=DEEP_N, m=m,
                 iters=st.k - 1, evals=st.prob.neval, status=st.status, fx=float(st.prob.fx),
                 seconds=dt, syncs_per_iter=reads / (st.k - 1))
            del st
        del x0
        torch.cuda.empty_cache()
    return lc_rows


def phase_booth() -> None:
    """Booth (n = 2) on the card from (-1.2, 1.0), float64, through both
    entry points: x = (1, 3) within 1e-6 and fx < 1e-10, as the
    reference's test (tests/simple.rs:57-83)."""
    x0 = torch.tensor([-1.2, 1.0], dtype=torch.float64, device="cuda")
    for entry in ("minimize", "minimize_jit"):
        r = getattr(lbfgs(), entry)(x0, booth.value_and_grad)
        x = [float(v) for v in r.x]
        if not (abs(x[0] - 1.0) <= 1e-6 and abs(x[1] - 3.0) <= 1e-6 and r.fx < 1e-10):
            raise AssertionError(f"booth ({entry}): x {x}, fx {r.fx}")
        emit(phase="booth", entry=entry, niter=r.niter, fx=r.fx, x=x, device=str(r.x.device))


#: the host's launch and copy calls as torch.profiler names them
LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cuLaunchKernelEx",
                "cudaLaunchKernelExC")


def _host_us(fn, reps: int) -> float:
    """Microseconds of host wall per call of fn, back to back, the card
    drained before and after."""
    return 1e3 * wall_ms(fn, reps)


def phase_launch_overhead(paths: dict) -> dict:
    """Launch and read costs from the calibration kernel, and what they
    explain of each main path's ms/iter.

    Per call, back to back: the calibration kernel through the port's
    ctypes wrapper (how K3, K5, K6 and K9-K13, K17 launch), a one-program
    K2 launched by Triton's own launcher with its operands made before
    (the launch of K1, K2, K4, K7, K8, K14-K16, without the wrapper's
    step fill and partial sums, which are torch ops), a torch elementwise
    op (the two-loop's [m]-sized algebra, the fills and sums), the
    calibration kernel followed by a one-element copy to the host (the
    synchronising read, without ``to_host``'s own torch ops), and the same
    followed by one ``to_host`` read instead (printed; the model below
    counts ``to_host``'s torch ops among the torch launches).  Then, for each
    path (name: (params, fused, ms_per_iter, syncs_per_iter) of this call,
    ``fused`` False for the objective without the fusion's hooks), one
    15-iteration run under torch.profiler counts the host's launch calls
    per iteration, split by route from the kernels' own counters, and
    the modelled host ms/iter = Triton launches x Triton us + ctypes
    launches x null us + other launches x torch us + reads x read us is
    printed beside the measured ms/iter."""
    reset_counts()
    x = torch.zeros(N_NULL, device="cuda")
    xp = torch.ones(factory.BLOCK, device="cuda")
    stp, part = torch.full((1,), 0.5, device="cuda"), torch.empty((1, 2), device="cuda")
    probe_kernel, body = factory._kernels().probe_kernel, rosenbrock._rosen_block()

    def triton_launch():
        probe_kernel[(1,)](xp, xp, stp, part, factory.BLOCK, 0, ex=(), SHARD=False, body=body,
                           ROWS=factory.BLOCK // 2, W=2, **factory.LAUNCH)

    us = dict(
        null=_host_us(lambda: profiling.null_launch(x), 2000),
        triton=_host_us(triton_launch, 2000),
        torch_op=_host_us(lambda: torch.add(x, 1.0), 2000),
        null_read=_host_us(lambda: profiling.null_launch(x)[:1].cpu(), 500),
        null_to_host=_host_us(lambda: to_host(profiling.null_launch(x)[0]), 500),
    )
    us["read"] = us["null_read"] - us["null"]
    null_launches = profiling.null_launch.launches
    # the counted kernels by route (the deep forms' _m80 rows count apart;
    # the any-depth kernels' _m80 rows are K3-K13's own counts)
    triton_k = [k for k in launches() if KERNELS[k][0] == "triton"]
    cuda_k = [k for k in launches() if KERNELS[k][0] == "cuda"]
    out = {}
    x0 = rosenbrock.initial_point(N_BIG, torch.float32, "cuda")
    for name, (params, fused, ms_per_iter, syncs) in paths.items():
        fn = default_evaluate() if fused else unfused(default_evaluate())

        def one_run():
            reset_counts()
            return minimize_jit(params.replace(epsilon=0.0, max_iterations=16), x0, fn,
                                return_state=True)

        prof, st = profiled(one_run)
        iters, lc = st.k - 1, launches()
        per = dict(triton=sum(lc[k] for k in triton_k) / iters,
                   cuda=sum(lc[k] for k in cuda_k) / iters)
        if prof is None:
            # no session saw the card: the host's launch calls are unknown
            out[name] = dict(launches_per_iter=per, launch_calls_per_iter=None,
                             syncs_per_iter=syncs, ms_per_iter=ms_per_iter,
                             modelled_host_ms_per_iter=None, share_explained=None)
            continue
        calls = sum(e.count for e in averages(prof) if e.key in LAUNCH_CALLS)
        per["torch_op"] = calls / iters - per["triton"] - per["cuda"]
        model = 1e-3 * (per["triton"] * us["triton"] + per["cuda"] * us["null"]
                        + per["torch_op"] * us["torch_op"] + syncs * us["read"])
        out[name] = dict(launches_per_iter=per, launch_calls_per_iter=calls / iters,
                         syncs_per_iter=syncs, ms_per_iter=ms_per_iter,
                         modelled_host_ms_per_iter=model,
                         share_explained=model / ms_per_iter)
        del st
    emit(phase="launch_overhead", us_per_call=us, paths=out)
    return {"cal_null_launch": null_launches}


#: the main path with the literal scan two-loop
SCAN_PARAMS = MAIN_PARAMS.replace(compact_two_loop=False)
#: the main path with a float16 ring; at epsilon 1e-5, which the float32
#: path reaches: at epsilon 0 a float16 ring may end the run on rounding
#: near fx = 0 ("x not changed")
F16_PARAMS = MAIN_PARAMS.replace(history_dtype="float16", epsilon=1e-5)


def _expect_materialized(name: str, st, lc: dict, pc: dict) -> None:
    """The launches of a run that takes no ring kernel (the scan two-loop,
    or a ring the kernels refuse): K1 at the start and once per iteration
    (the accepted point), K2 per probe, nothing else, no plain version."""
    _expect(name, lc, pc, K1_trial=st.k, K2_probe=st.prob.neval - 1)


def phase_scan() -> dict:
    """The literal scan two-loop (``with_compact_two_loop(False)``): the
    recorded n = 100 float64 golden through the kernels, uncapped, through
    both entry points (38 iterations, fx rel 1e-3, gnorm rel 1e-6;
    ``tests/test_native_parity.py:69-80``), then the main path's widths for
    at most 100 iterations at epsilon 0 and against its plain versions
    after 8.  K1 and K2 launch, nothing that reads the ring."""
    x0 = rosenbrock.initial_point(100, torch.float64, "cuda")
    b = lbfgs().with_compact_two_loop(False).with_constrain_step_size(False)
    for entry in ("minimize", "minimize_jit"):
        reset_counts()
        r = getattr(b, entry)(x0, default_evaluate())
        lc, pc = launches(), plain_calls()
        ok = (r.niter == 38 and abs(r.fx / 1.2832127771605377e-15 - 1) <= 1e-3
              and abs(r.gnorm / 9.486547293218877e-07 - 1) <= 1e-6)
        if not ok:
            raise AssertionError(f"scan golden ({entry}): {r}")
        _expect(f"scan golden ({entry})", lc, pc, K1_trial=r.niter, K2_probe=r.neval - 1)
        emit(phase="scan_golden_f64_n100", entry=entry, niter=r.niter, fx=r.fx,
             gnorm=r.gnorm, launches={k: v for k, v in lc.items() if v})
    st, dt, lc, pc, reads = _run_2e24("scan main path", SCAN_PARAMS)
    _expect_materialized("scan main path", st, lc, pc)
    out = _report_2e24("scan_main_path", st, dt, lc, reads, plain_calls=pc)
    emit(phase="scan_main_path_vs_plain", **_vs_plain("scan main path", SCAN_PARAMS, *VS_PLAIN[0]))
    del st
    torch.cuda.empty_cache()
    return out


def phase_float16_history() -> dict:
    """The main path's widths with a float16 ring (``F16_PARAMS``), at most
    100 iterations: the ring kernels refuse (float32, float16), so the
    pair + Gram pass and the combine are the composed torch ops the JAX
    package runs there with jnp (``fused.pair_gram_ref``,
    ``fused.combine_plain``); K1 and K2 still launch.  Its plain-call
    counts are printed; then against its plain versions after 8
    iterations."""
    st, dt, lc, pc, reads = _run_2e24("float16-history main path", F16_PARAMS)
    if st.status != Status.CONVERGED:
        raise AssertionError(f"float16-history main path: status {st.status}")
    _expect_materialized("float16-history main path", st, lc, pc)
    out = _report_2e24("float16_history_main_path", st, dt, lc, reads, eps=F16_PARAMS.epsilon,
                       plain_calls=pc, ring_dtype=str(st.hist.s.dtype))
    emit(phase="float16_history_vs_plain",
         **_vs_plain("float16-history main path", F16_PARAMS, *VS_PLAIN[0]))
    del st
    torch.cuda.empty_cache()
    return out


#: the native core's baseline: its C++ Rosenbrock at the main path's n
NATIVE_N, NATIVE_ITERS = N_BIG, 10


def phase_native() -> None:
    """``backend="native"``, a host core with no device: the recorded
    L-BFGS and OWL-QN goldens through the builder (38 iterations, fx rel
    1e-9 and gnorm rel 1e-9; 172 iterations, fx rel 1e-12, x[0] and x[1]
    rel 1e-8; ``tests/test_native_parity.py:48-67``), then
    ``minimize_native_rosenbrock`` at n = 2^24 for 10 iterations, its
    seconds printed (the denominator of a benchmark's ``vs_baseline``)."""
    x0 = rosenbrock.initial_point(100, torch.float64, "cpu")
    b = lbfgs().with_constrain_step_size(False)
    t0 = time.perf_counter()
    r1 = b.minimize(x0, default_evaluate(), backend="native")
    r2 = b.with_orthantwise(1.0, 0, 99).minimize(r1.x, default_evaluate(), backend="native")
    dt = time.perf_counter() - t0
    ok1 = (r1.niter == 38 and abs(r1.fx / 1.2832127771605377e-15 - 1) <= 1e-9
           and abs(r1.gnorm / 9.486547293218877e-07 - 1) <= 1e-9)
    ok2 = (r2.niter == 172 and abs(r2.fx / OWLQN_GOLDEN["fx"] - 1) <= 1e-12
           and abs(float(r2.x[0]) / 0.2500000069348678 - 1) <= 1e-8
           and abs(float(r2.x[1]) / 0.057500004213084016 - 1) <= 1e-8)
    if not (ok1 and ok2):
        raise AssertionError(f"native goldens: {r1} {r2}")
    x0 = torch.tensor([-1.2, 1.0], dtype=torch.float64).repeat(NATIVE_N // 2)
    params = LbfgsParams(max_iterations=NATIVE_ITERS, epsilon=0.0)
    t0 = time.perf_counter()
    r = minimize_native_rosenbrock(params, x0)
    dt_r = time.perf_counter() - t0
    if r.niter != NATIVE_ITERS or not np.isfinite(r.fx):
        raise AssertionError(f"native Rosenbrock: {r.niter} iterations, fx {r.fx}")
    emit(phase="native", golden_niter=r1.niter, golden_fx=r1.fx, owlqn_niter=r2.niter,
         owlqn_fx=r2.fx, goldens_seconds=dt, rosenbrock_n=NATIVE_N,
         rosenbrock_iters=r.niter, rosenbrock_evals=r.neval, rosenbrock_fx=r.fx,
         rosenbrock_seconds=dt_r, rosenbrock_ms_per_iter=1e3 * dt_r / r.niter)


#: the checkpoint phase: the main path's settings at n = 2^20, saved after
#: 10 iterations and resumed for 10 more
CKPT_N, CKPT_AT = 1 << 20, 10


def _bits(v):
    """A state value as comparable bits: a tensor's bytes, else itself."""
    if isinstance(v, torch.Tensor):
        return v.detach().reshape(-1).view(torch.uint8).cpu().numpy().tobytes()
    if isinstance(v, np.ndarray):
        return v.tobytes()
    return v


def _state_bits(st) -> dict:
    return {k: _bits(v) for k, v in fields(st)}


def phase_checkpoint() -> None:
    """The main path at n = 2^20 through ``LbfgsState``: saved at iteration
    10 (``utils.checkpoint``, to the build directory), loaded into a fresh
    state, 10 more iterations; every field of the state must equal the
    uninterrupted run's bit for bit (the kernels' partials reduce in a
    fixed order)."""
    params = MAIN_PARAMS.replace(max_iterations=0)
    x0 = rosenbrock.initial_point(CKPT_N, torch.float32, "cuda")
    whole = LbfgsState.build(params, x0, default_evaluate())
    for _ in range(2 * CKPT_AT):
        whole.propagate()
    first = LbfgsState.build(params, x0, default_evaluate())
    for _ in range(CKPT_AT):
        first.propagate()
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    path = _build.BUILD_DIR / f"checkpoint_{os.getpid()}.npz"
    try:
        save_state(str(path), first.state)
        size = path.stat().st_size
        resumed = LbfgsState.build(params, x0, default_evaluate())
        resumed.restore(load_state(str(path), resumed.state))
    finally:
        path.unlink(missing_ok=True)
    on_card = resumed.state.prob.x.device.type == "cuda"
    for _ in range(CKPT_AT):
        resumed.propagate()
    a, b = _state_bits(resumed.state), _state_bits(whole.state)
    differ = sorted(k for k in a if a[k] != b.get(k)) + sorted(set(b) - set(a))
    if differ or not on_card:
        raise AssertionError(f"checkpoint resume: fields {differ} differ (on card {on_card})")
    emit(phase="checkpoint", n=CKPT_N, saved_at=CKPT_AT, resumed_to=resumed.state.k,
         fields=len(a), bytes=size, fx=float(resumed.state.prob.fx), bit_for_bit=True)


# ---------------------------------------------------------------------------
# the batched runner (minimize_batched): K2 b, K4 b and K3 b
# ---------------------------------------------------------------------------

#: the batched kernels' and main path's shapes: B instances of n elements,
#: 2^24 elements in all (the solo main path's bytes), m = M; the kernel
#: checks write ring row BATCH_END and freeze every third instance from the
#: third, so that instances 0, 511 and 1023, held to the solo kernels, are live
BATCH_B, BATCH_N, BATCH_END = 1024, 1 << 14, 3
BATCH_SOLO = (0, 511, 1023)
#: the batched main path: bench_batched.py's configuration (lbfgs()'s
#: defaults, epsilon 0, 30 iterations, x0 = the Rosenbrock start + 0.05 *
#: N(0, 1) from numpy seed 0; bench_batched.py:47-56) at B x n = 1024 x
#: 2^14, with the main path's bfloat16 ring
BATCHED_PARAMS = LbfgsParams(m=M, history_dtype="bfloat16", epsilon=0.0, max_iterations=31)
#: BASELINE.md's batch regime: 10,000 instances of n = 64, bench_batched.py's
#: accelerator default, at lbfgs()'s defaults (a float32 ring)
BASELINE_B, BASELINE_N = 10_000, 64
BASELINE_PARAMS = LbfgsParams(epsilon=0.0, max_iterations=31)
#: timed runs of each batched path: host walls spread within one call
#: (the card's host CPU is shared), so the least of three is reported
BATCHED_RUNS = 3


def batched_x0(B: int, n: int) -> torch.Tensor:
    """bench_batched.py's starts: the Rosenbrock start plus 0.05 * N(0, 1)
    from numpy seed 0, float32, on the card; made once per shape (numpy's
    16.7 million normals of the main path's batch take most of a second)
    and handed out as a copy."""
    key = (B, n)
    if key not in _BATCHED_X0:
        rng = np.random.RandomState(0)
        base = rosenbrock.initial_point(n, torch.float32, "cpu").numpy()
        _BATCHED_X0[key] = torch.from_numpy(
            base[None, :] + 0.05 * rng.randn(B, n).astype(np.float32)).cuda()
    return _BATCHED_X0[key].clone()


#: ``batched_x0``'s starts by (B, n)
_BATCHED_X0 = {}


def batched_inputs(seed: int) -> dict:
    """Seeded [B, n] inputs of the batched kernels, f32 vectors and bf16
    rings, every third instance from the third frozen."""
    B, n = BATCH_B, BATCH_N
    g = torch.Generator(device="cuda").manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=g, device="cuda")
    live = torch.ones(B, dtype=torch.bool, device="cuda")
    live[2::3] = False
    xp = rosenbrock.initial_point(n, torch.float32, "cuda")[None, :] + 0.1 * r(B, n)
    return dict(xp=xp, d=0.1 * r(B, n), gp=r(B, n), S=r(B, M, n).bfloat16(),
                Y=r(B, M, n).bfloat16(), stp=0.2 + torch.rand(B, generator=g, device="cuda"),
                coef=0.5 * r(B, 1 + 2 * M), live=live)


def phase_batched_kernels() -> dict:
    """K2 b, K4 b and K3 b against their plain versions on the card at B =
    1024, n = 2^14, m = 6, f32 vectors, bf16 rings, end = 3, a third of the
    instances frozen (normwise 1e-5 on vectors, 1e-4 on sums; K4 b's ring
    rows bit for bit the rounding of its own pair, the other rows kept;
    every frozen instance's x, g, ring rows and direction untouched bit for
    bit); then instances 0, 511 and 1023 against the solo K2, K4 and K3 on
    that instance alone: x, g, the rings and r bit for bit, K2's sums
    printed.  Each kernel timed with every instance live, beside its plain
    version and its bound."""
    k = rosenbrock.value_and_grad.kernels
    a = batched_inputs(SEED + 12)
    live, frozen = a["live"], ~a["live"]
    tv, ts = TOL[(torch.float32, "vec")], TOL[(torch.float32, "sum")]
    errs = {}
    ft, dg = k.probe_batched(a["xp"], a["d"], a["stp"], live)
    pft, pdg = k.probe_batched_ref(a["xp"], a["d"], a["stp"], live)
    errs["K2b_probe_batched"] = (
        check("K2b ft", ft[live], pft[live], ts), check("K2b g.d", dg[live], pdg[live], ts))

    def k4(fn):
        x, g, S, Y = (a[name].clone() for name in ("xp", "gp", "S", "Y"))
        return (x, g, S, Y), fn(x, a["d"], g, a["stp"], S, Y, BATCH_END, live)

    (xk, gk, Sk, Yk), outk = k4(k.trial_pair_gram_batched)
    (xq, gq, Sq, Yq), outp = k4(k.trial_pair_gram_batched_ref)
    e4 = [check("K4b x", xk[live], xq[live], tv), check("K4b g", gk[live], gq[live], tv)]
    e4 += [check(f"K4b sum{i}", outk[i][live], outp[i][live], ts) for i in (0, 1, 2, 4, 5)]
    if not torch.equal(outk[3][live], outp[3][live]):
        raise AssertionError("K4b: changed differs from the plain version")
    errs["K4b_trial_pair_gram_batched"] = tuple(e4)
    # the ring rows: row end of a live instance the rounding of the
    # kernel's own pair (s, y) = (stp d, g - gp); every other row kept
    s_new = (a["stp"][:, None] * a["d"]).to(torch.bfloat16)
    y_new = (gk - a["gp"]).to(torch.bfloat16)
    keep = [j for j in range(M) if j != BATCH_END]
    if not (same_bits(Sk[live][:, BATCH_END], s_new[live])
            and same_bits(Yk[live][:, BATCH_END], y_new[live])
            and same_bits(Sk[:, keep], a["S"][:, keep])
            and same_bits(Yk[:, keep], a["Y"][:, keep])):
        raise AssertionError("K4b: the ring rows are not the rounded pair and the kept rows")
    rk = torch.zeros_like(a["d"])
    rq = torch.zeros_like(a["d"])
    ck = fused.combine_batched(a["gp"], a["S"], a["Y"], a["coef"], live, rk)
    cq = fused.combine_batched_ref(a["gp"], a["S"], a["Y"], a["coef"], live, rq)
    errs["K3b_combine_batched"] = (
        check("K3b r", rk[live], rq[live], tv),
        *(check(f"K3b sum{i}", ck[i][live], cq[i][live], ts) for i in (0, 1)))
    # frozen instances: nothing of theirs written
    untouched = all(same_bits(out[frozen], a[name][frozen])
                    for out, name in ((xk, "xp"), (gk, "gp"), (Sk, "S"), (Yk, "Y")))
    if not (untouched and not rk[frozen].any()):
        raise AssertionError("a batched kernel wrote a frozen instance")
    # instances 0, 511, 1023 against the solo kernels on that instance alone
    solo = {}
    for b in BATCH_SOLO:
        stp = float(a["stp"][b])
        sft, sdg = k.probe(a["xp"][b], a["d"][b], stp)
        Sb, Yb = a["S"][b].clone(), a["Y"][b].clone()
        x1, _, g1 = k.trial_pair_gram(a["xp"][b], a["d"][b], a["gp"][b], stp, Sb, Yb,
                                      BATCH_END)[:3]
        c = a["coef"][b]
        r1 = fused.combine(a["gp"][b], a["S"][b], a["Y"][b], c[0], c[1:1 + M], c[1 + M:])[0]
        bits = dict(x=same_bits(xk[b], x1), g=same_bits(gk[b], g1), S=same_bits(Sk[b], Sb),
                    Y=same_bits(Yk[b], Yb), r=same_bits(rk[b], r1))
        if not all(bits.values()):
            raise AssertionError(f"instance {b} differs from the solo kernels: {bits}")
        solo[b] = dict(k2_sums_bit_for_bit=same_bits(ft[b], sft) and same_bits(dg[b], sdg),
                       k2_ft_rel=abs(float(ft[b]) / float(sft) - 1))
    del xk, gk, Sk, Yk, xq, gq, Sq, Yq, outk, outp, rq, s_new, y_new
    torch.cuda.empty_cache()
    # times with every instance live, on copies the in-place K4 b advances
    every = torch.ones_like(live)
    x, g, S, Y = (a[name].clone() for name in ("xp", "gp", "S", "Y"))
    cases = {
        "K2b_probe_batched": (lambda: k.probe_batched(x, a["d"], a["stp"], every),
                              lambda: k.probe_batched_ref(x, a["d"], a["stp"], every)),
        "K4b_trial_pair_gram_batched": (
            lambda: k.trial_pair_gram_batched(x, a["d"], g, a["stp"], S, Y, BATCH_END, every),
            lambda: k.trial_pair_gram_batched_ref(x, a["d"], g, a["stp"], S, Y, BATCH_END,
                                                  every)),
        "K3b_combine_batched": (
            lambda: fused.combine_batched(a["gp"], a["S"], a["Y"], a["coef"], every, rk),
            lambda: fused.combine_batched_ref(a["gp"], a["S"], a["Y"], a["coef"], every, rk)),
    }
    times, timed_by = {}, {}
    for name, (kern, plain) in cases.items():
        k_ms, p_ms, k_by, p_by = kernel_vs_plain(kern, plain, 20)
        times[name], timed_by[name] = (k_ms, p_ms), (k_by, p_by)
    bounds = {name: bound(name, BATCH_B * BATCH_N, 4, 2, M) for name in cases}
    errs = {name: (max(e[0] for e in v), max(e[1] for e in v)) for name, v in errs.items()}
    emit(phase="batched_kernels", B=BATCH_B, n=BATCH_N, m=M, end=BATCH_END,
         frozen=int(frozen.sum()), max_abs_err={n_: e[0] for n_, e in errs.items()},
         max_normwise_err={n_: e[1] for n_, e in errs.items()},
         tol=dict(vec=tv, sum=ts, ring_rows="bit-exact", frozen="bit-exact",
                  vs_solo_x_g_rings_r="bit-exact"), vs_solo=solo,
         device_ms={n_: {"kernel": t[0], "plain": t[1], "bound": bounds[n_][0]}
                    for n_, t in times.items()},
         timed_by={n_: {"kernel": t[0], "plain": t[1]} for n_, t in timed_by.items()})
    del a, x, g, S, Y, rk
    torch.cuda.empty_cache()
    return {"errs": errs, "times": times, "bounds": bounds, "timed_by": timed_by}


def _batched_run(name: str, params: LbfgsParams, B: int, n: int, path=BATCHED_PATH,
                 init=(), runs: int = BATCHED_RUNS, dtype=torch.float32) -> tuple:
    """One warm and ``runs`` timed ``minimize_batched`` of B instances of n
    elements from ``batched_x0`` (in ``dtype``), the counts reset before each; returns
    (state, the walls in seconds, launches, plain calls, host reads, loop
    iterations, the starts), the counts and state of the last run.
    ``path`` names the run's probe, epilogue and combine kernels, ``init``
    the kernels its init launches once."""
    x0b = batched_x0(B, n).to(dtype)
    fn = default_evaluate()
    minimize_batched(params, x0b, fn)
    torch.cuda.synchronize()
    walls = []
    for _ in range(runs):
        reset_counts()
        out = []
        walls.append(profiling.timed(
            lambda: out.append(minimize_batched(params, x0b, fn, return_state=True)), warmup=0))
    st = out[0]
    lc, pc, reads = launches(), plain_calls(), to_host.reads
    iters = int(st.k.max()) - 1
    if not np.isfinite(st.fx).all():
        raise AssertionError(f"{name}: {int((~np.isfinite(st.fx)).sum())} instances end "
                             f"with a non-finite fx")
    if st.x.device.type != "cuda":
        raise AssertionError(f"{name}: the run left the card")
    # the loop's epilogues and combines, one each per iteration; the probes
    # one per search trip; the init's kernels once; nothing else launched,
    # no plain version
    probe, epilogue, combine = path
    if not (1 <= lc[epilogue] == lc[combine] <= iters
            and (carried.used or lc[probe] >= lc[epilogue])):
        raise AssertionError(f"{name}: launches {lc} in {iters} iterations")
    _expect(name, lc, pc, **{k: lc[k] for k in path}, **dict.fromkeys(init, 1))
    return st, walls, lc, pc, reads, iters, x0b


def _batched_report(phase: str, st, walls: list, lc: dict, reads: int, iters: int,
                    path=BATCHED_PATH, **extra) -> dict:
    """The run's line: instance-iterations/s and wall ms per iteration from
    the least of the walls (all printed), per-iteration counts."""
    codes, counts = np.unique(st.status, return_counts=True)
    inst_iters = int(np.maximum(st.k - 1, 0).sum())
    dt = min(walls)
    out = dict(phase=phase, B=int(st.x.shape[0]), n=int(st.x.shape[1]), iters=iters,
               instance_iters=inst_iters, seconds=dt, seconds_runs=walls,
               instance_iters_per_s=inst_iters / dt,
               wall_ms_per_iter=1e3 * dt / iters, syncs_per_iter=reads / iters,
               probes_per_iter=extra.pop("probes_per_iter", lc[path[0]] / iters),
               evals_per_instance=float(st.neval.mean()),
               status={int(c): int(v) for c, v in zip(codes, counts)},
               fx_median=float(np.median(st.fx)), fx_max=float(st.fx.max()),
               launches={k: lc[k] for k in path}, **extra)
    emit(**out)
    return out


def _batched_profile(params: LbfgsParams, x0b: torch.Tensor, fn=None, top: int = 0) -> dict:
    """Device busy ms and host launch calls per iteration of one profiled
    batched run on the objective ``fn`` (Rosenbrock's by default; None
    where every profiler session came back empty); with ``top`` also the
    ``top`` device items by time, each with its ms and calls per
    iteration."""
    fn = fn or default_evaluate()
    prof, st = profiled(lambda: minimize_batched(params, x0b, fn, return_state=True))
    iters = int(st.k.max()) - 1
    if prof is None:
        return dict(device_ms_per_iter=None, launch_calls_per_iter=None)
    events = device_events(prof)
    busy = sum(e.self_device_time_total for e in events) / 1e3
    calls = sum(e.count for e in averages(prof) if e.key in LAUNCH_CALLS)
    out = dict(device_ms_per_iter=busy / iters, launch_calls_per_iter=calls / iters)
    if top:
        events.sort(key=lambda e: -e.self_device_time_total)
        out["top_device_items_per_iter"] = [
            dict(name=e.key[:80], ms=e.self_device_time_total / 1e3 / iters,
                 calls=e.count / iters) for e in events[:top]]
    return out


def phase_batched_main_path() -> dict:
    """``minimize_batched`` on bench_batched.py's configuration at kernel
    scale (``BATCHED_PARAMS``, B = 1024 x n = 2^14 from ``batched_x0``):
    K2 b per search trip, K4 b and K3 b per iteration, nothing else and no
    plain version; every fx finite.  Prints instance-iterations/s, device
    ms, syncs and host launch calls per iteration, and the solo main path's
    device ms per iteration at n = 2^24 beside it.  Then instances 0-7 run
    solo through ``minimize_jit`` against a batched run of 8 iterations:
    the same iterations and evaluations, fx rel ``FUSION_TOL_8``."""
    params = BATCHED_PARAMS
    st, walls, lc, pc, reads, iters, x0b = _batched_run("batched main path", params, BATCH_B,
                                                         BATCH_N)
    prof = _batched_profile(params, x0b)
    solo = _busy_per_iter(MAIN_PARAMS, rosenbrock.initial_point(N_BIG, torch.float32, "cuda"),
                          default_evaluate())
    out = _batched_report("batched_main_path", st, walls, lc, reads, iters, **prof,
                          solo_main_path_device_ms_per_iter=solo, plain_calls=pc)
    del st
    emit(phase="batched_vs_solo", iters=8, fx_tol=FUSION_TOL_8,
         instances=_vs_solo_8("batched", params, x0b))
    del x0b
    torch.cuda.empty_cache()
    return lc, out


def phase_batched_baseline() -> dict:
    """BASELINE.md's batch regime: B = 10,000 x n = 64 (``BASELINE_PARAMS``,
    30 iterations, epsilon 0), instance-iterations/s; the same launch
    checks as the main path, every fx finite."""
    st, walls, lc, pc, reads, iters, x0b = _batched_run("batched baseline", BASELINE_PARAMS,
                                                         BASELINE_B, BASELINE_N)
    out = _batched_report("batched_baseline", st, walls, lc, reads, iters,
                          **_batched_profile(BASELINE_PARAMS, x0b))
    del st, x0b
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# the batched runner under OWL-QN: K8 b, K14 b, K13 b and K10 b
# ---------------------------------------------------------------------------

#: the batched OWL-QN main path: the batched main path's widths and starts
#: (1024 x 2^14, bf16 ring, m = 6, epsilon 0, 30 iterations, capped step)
#: with c = 1 on [0, n - 1) and BacktrackingArmijo
BATCHED_OWLQN_PARAMS = BATCHED_PARAMS.replace(
    orthantwise=Orthantwise(1.0, 0, BATCH_N - 1),
).replace_ls(algorithm=LineSearchAlgorithm.BacktrackingArmijo)


def batched_owlqn_inputs(seed: int) -> dict:
    """``batched_inputs`` with a random pseudo-gradient pg and xp zero at
    every 17th element (the orthant's at-zero choice)."""
    a = batched_inputs(seed)
    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    a["pg"] = torch.randn(BATCH_B, BATCH_N, generator=g, device="cuda")
    a["xp"][:, ::17] = 0.0
    return a


def phase_batched_owlqn_kernels() -> dict:
    """K8 b, K14 b, K13 b and K10 b against their plain versions on the
    card at B = 1024, n = 2^14, m = 6, f32 vectors, bf16 rings, end = 3, a
    third of the instances frozen, L1 weight ``C_L1``, on the windows [0,
    n - 1) and one whose ends fall inside every kernel's tiles (normwise
    1e-5 on vectors, 1e-4 on sums; K14 b's ring rows bit for bit the
    rounding of its own pair, the other rows kept; every frozen instance's
    x, g, pg, ring rows and outputs untouched bit for bit); then instances
    0, 511 and 1023 against the solo K8 (pg form), K14, K13 and K10 on that
    instance alone: x, g, pg, the rings, rc and K10's pg bit for bit, K8's
    sums printed.  Each kernel timed on the first window with every
    instance live, beside its plain version and its bound."""
    k = rosenbrock.value_and_grad.kernels
    a = batched_owlqn_inputs(SEED + 14)
    live, frozen = a["live"], ~a["live"]
    tv, ts = TOL[(torch.float32, "vec")], TOL[(torch.float32, "sum")]
    c, end = C_L1, BATCH_END
    errs = {name: [] for name in BATCHED_OWLQN_PATH + BATCHED_OWLQN_INIT}
    solo = {}
    for wi, (lo, hi) in enumerate(windows(BATCH_N)):
        tag = f"w{wi}"
        ft, dg = k.owlqn_probe_pg_batched(a["xp"], a["d"], a["pg"], a["stp"], c, lo, hi, live)
        pft, pdg = k.owlqn_probe_pg_batched_ref(a["xp"], a["d"], a["pg"], a["stp"], c, lo, hi,
                                                live)
        errs["K8b_owlqn_probe_batched"] += [check(f"K8b ft {tag}", ft[live], pft[live], ts),
                                            check(f"K8b g.d {tag}", dg[live], pdg[live], ts)]

        def k14(fn):
            t = {name: a[name].clone() for name in ("xp", "gp", "pg", "S", "Y")}
            out = fn(t["xp"], a["d"], t["gp"], t["pg"], a["stp"], c, lo, hi, t["S"], t["Y"],
                     end, live)
            return t, out

        tk, outk = k14(k.owlqn_trial_pair_gram_batched)
        tq, outq = k14(k.owlqn_trial_pair_gram_batched_ref)
        e14 = [check(f"K14b {name} {tag}", tk[name][live], tq[name][live], tv)
               for name in ("xp", "gp", "pg")]
        e14 += [check(f"K14b sum{i} {tag}", outk[i][live], outq[i][live], ts)
                for i in (0, 1, 3, 4)]
        if not torch.equal(outk[2][live], outq[2][live]):
            raise AssertionError(f"K14b {tag}: changed differs from the plain version")
        errs["K14b_owlqn_trial_pair_gram_batched"] += e14
        # row end of a live instance the rounding of the kernel's own pair
        # (x - xp, g - gp); every other row kept
        s_new = (tk["xp"] - a["xp"]).to(torch.bfloat16)
        y_new = (tk["gp"] - a["gp"]).to(torch.bfloat16)
        keep = [j for j in range(M) if j != end]
        if not (same_bits(tk["S"][live][:, end], s_new[live])
                and same_bits(tk["Y"][live][:, end], y_new[live])
                and same_bits(tk["S"][:, keep], a["S"][:, keep])
                and same_bits(tk["Y"][:, keep], a["Y"][:, keep])):
            raise AssertionError(f"K14b {tag}: the ring rows are not the rounded pair and the "
                                 f"kept rows")
        rk, rq = torch.zeros_like(a["d"]), torch.zeros_like(a["d"])
        ck = fused.combine_ow_batched(a["pg"], a["S"], a["Y"], a["coef"], live, rk, lo, hi)
        cq = fused.combine_ow_batched_ref(a["pg"], a["S"], a["Y"], a["coef"], live, rq, lo, hi)
        errs["K13b_combine_ow_batched"] += [
            check(f"K13b rc {tag}", rk[live], rq[live], tv),
            *(check(f"K13b sum{i} {tag}", ck[i][live], cq[i][live], ts) for i in range(3))]
        pk, pq = torch.zeros_like(a["d"]), torch.zeros_like(a["d"])
        nk = fused.pseudo_gradient_norm_batched(a["xp"], a["gp"], c, lo, hi, live, pk)
        nq = fused.pseudo_gradient_norm_batched_ref(a["xp"], a["gp"], c, lo, hi, live, pq)
        errs["K10b_pseudo_gradient_norm_batched"] += [
            check(f"K10b pg {tag}", pk[live], pq[live], tv),
            check(f"K10b pg.pg {tag}", nk[live], nq[live], ts)]
        untouched = all(same_bits(tk[name][frozen], a[name][frozen])
                        for name in ("xp", "gp", "pg", "S", "Y"))
        if not (untouched and not rk[frozen].any() and not pk[frozen].any()):
            raise AssertionError(f"{tag}: a batched OWL-QN kernel wrote a frozen instance")
        # instances 0, 511, 1023 against the solo kernels on that instance alone
        for b in BATCH_SOLO:
            stp = float(a["stp"][b])
            sft, sdg = k.owlqn_probe_pg(a["xp"][b], a["d"][b], a["pg"][b], stp, c, lo, hi)
            Sb, Yb = a["S"][b].clone(), a["Y"][b].clone()
            x1, g1, pg1 = k.owlqn_trial_pair_gram(a["xp"][b], a["d"][b], a["gp"][b],
                                                  a["pg"][b], stp, c, lo, hi, Sb, Yb, end)[:3]
            cf = a["coef"][b]
            r1 = fused.combine_ow(a["pg"][b], a["S"][b], a["Y"][b], cf[0], cf[1:1 + M],
                                  cf[1 + M:], lo, hi)[0]
            p1 = fused.pseudo_gradient_norm(a["xp"][b], a["gp"][b], c, lo, hi)[0]
            bits = dict(x=same_bits(tk["xp"][b], x1), g=same_bits(tk["gp"][b], g1),
                        pg=same_bits(tk["pg"][b], pg1), S=same_bits(tk["S"][b], Sb),
                        Y=same_bits(tk["Y"][b], Yb), rc=same_bits(rk[b], r1),
                        pg_k10=same_bits(pk[b], p1))
            if not all(bits.values()):
                raise AssertionError(f"{tag} instance {b} differs from the solo kernels: "
                                     f"{bits}")
            solo[f"{tag}_{b}"] = dict(
                k8_sums_bit_for_bit=same_bits(ft[b], sft) and same_bits(dg[b], sdg),
                k8_ft_rel=abs(float(ft[b]) / float(sft) - 1))
        del tk, tq, outk, outq, rk, rq, pk, pq, s_new, y_new
        torch.cuda.empty_cache()
    # times on the first window with every instance live, on copies the
    # in-place K14 b advances
    lo, hi = windows(BATCH_N)[0]
    every = torch.ones_like(live)
    x, g, pg, S, Y = (a[name].clone() for name in ("xp", "gp", "pg", "S", "Y"))
    out = torch.zeros_like(a["d"])
    cases = {
        "K8b_owlqn_probe_batched": (
            lambda: k.owlqn_probe_pg_batched(x, a["d"], pg, a["stp"], c, lo, hi, every),
            lambda: k.owlqn_probe_pg_batched_ref(x, a["d"], pg, a["stp"], c, lo, hi, every)),
        "K14b_owlqn_trial_pair_gram_batched": (
            lambda: k.owlqn_trial_pair_gram_batched(x, a["d"], g, pg, a["stp"], c, lo, hi, S,
                                                    Y, end, every),
            lambda: k.owlqn_trial_pair_gram_batched_ref(x, a["d"], g, pg, a["stp"], c, lo, hi,
                                                        S, Y, end, every)),
        "K13b_combine_ow_batched": (
            lambda: fused.combine_ow_batched(a["pg"], a["S"], a["Y"], a["coef"], every, out,
                                             lo, hi),
            lambda: fused.combine_ow_batched_ref(a["pg"], a["S"], a["Y"], a["coef"], every,
                                                 out, lo, hi)),
        "K10b_pseudo_gradient_norm_batched": (
            lambda: fused.pseudo_gradient_norm_batched(a["xp"], a["gp"], c, lo, hi, every,
                                                       out),
            lambda: fused.pseudo_gradient_norm_batched_ref(a["xp"], a["gp"], c, lo, hi, every,
                                                           out)),
    }
    times, timed_by = {}, {}
    for name, (kern, plain) in cases.items():
        k_ms, p_ms, k_by, p_by = kernel_vs_plain(kern, plain, 20)
        times[name], timed_by[name] = (k_ms, p_ms), (k_by, p_by)
    bounds = {name: bound(name, BATCH_B * BATCH_N, 4, 2, M) for name in cases}
    errs = {name: (max(e[0] for e in v), max(e[1] for e in v)) for name, v in errs.items()}
    # registers and spills: K14 b's Triton form at these dtypes, and every
    # instantiation of the CUDA K3 b/K13 b and K10/K10 b/K11 bodies
    compiled = {}
    fn = k.owlqn_trial_pair_gram_batched
    for kind, forms in (("", fn.compiled), (" mma", fn.mma_compiled)):
        for (vd, hd, gp), kc in forms.items():
            compiled[f"K14b{' gp' if gp else ''}{kind} {vd} {hd}"] = _compiled_info(kc)
    for name, v in ptxas_kernels(_build.build_log()).items():
        if m := re.search(r"(combine_batched_kernel|pseudo_grad_kernel)I(\w+?)EEv", name):
            compiled[f"{m.group(1)}<{m.group(2)}>"] = v
    spilled = {n_: v for n_, v in compiled.items()
               if v.get("n_spills") or v.get("spill_stores") or v.get("spill_loads")}
    if spilled:
        raise AssertionError(f"batched OWL-QN forms spill registers: {spilled}")
    emit(phase="batched_owlqn_kernels", compiled=compiled, B=BATCH_B, n=BATCH_N, m=M, end=end, c=c,
         windows=windows(BATCH_N), frozen=int(frozen.sum()),
         max_abs_err={n_: e[0] for n_, e in errs.items()},
         max_normwise_err={n_: e[1] for n_, e in errs.items()},
         tol=dict(vec=tv, sum=ts, ring_rows="bit-exact", frozen="bit-exact",
                  vs_solo_x_g_pg_rings_rc_pg="bit-exact"), vs_solo=solo,
         device_ms={n_: {"kernel": t[0], "plain": t[1], "bound": bounds[n_][0]}
                    for n_, t in times.items()},
         timed_by={n_: {"kernel": t[0], "plain": t[1]} for n_, t in timed_by.items()})
    del a, x, g, pg, S, Y, out
    torch.cuda.empty_cache()
    return {"errs": errs, "times": times, "bounds": bounds, "timed_by": timed_by}


def phase_batched_owlqn_main_path(plain: dict) -> dict:
    """``minimize_batched`` under OWL-QN at the batched main path's widths
    (``BATCHED_OWLQN_PARAMS``, B = 1024 x n = 2^14 from ``batched_x0``):
    K10 b once, K8 b per search trip, K14 b and K13 b per iteration,
    nothing else and no plain version; every fx finite.  Prints
    instance-iterations/s, device ms, syncs and host launch calls per
    iteration beside the plain batched main path's (``plain``).  Then
    instances 0-7 run solo through ``minimize_jit`` against a batched run
    of 8 iterations: the same iterations and evaluations, fx rel
    ``FUSION_TOL_8``."""
    params = BATCHED_OWLQN_PARAMS
    st, walls, lc, pc, reads, iters, x0b = _batched_run(
        "batched OWL-QN main path", params, BATCH_B, BATCH_N, BATCHED_OWLQN_PATH,
        BATCHED_OWLQN_INIT)
    prof = _batched_profile(params, x0b)
    beside = {key: plain.get(key) for key in (
        "instance_iters_per_s", "wall_ms_per_iter", "device_ms_per_iter", "syncs_per_iter",
        "launch_calls_per_iter", "probes_per_iter")}
    out = _batched_report("batched_owlqn_main_path", st, walls, lc, reads, iters,
                          BATCHED_OWLQN_PATH, **prof, plain_batched_main_path=beside,
                          init_launches={k: lc[k] for k in BATCHED_OWLQN_INIT}, plain_calls=pc)
    del st
    emit(phase="batched_owlqn_vs_solo", iters=8, fx_tol=FUSION_TOL_8,
         instances=_vs_solo_8("batched OWL-QN", params, x0b))
    del x0b
    torch.cuda.empty_cache()
    return lc, out


# ---------------------------------------------------------------------------
# the batched runner at the uncapped step and at any depth: K15 b, K16 b and
# the deep forms of K4 b, K14 b, K15 b and K16 b
# ---------------------------------------------------------------------------

#: the batched uncapped main paths: the batched main path (More-Thuente)
#: and the batched OWL-QN main path (c = 1 on [0, n - 1), Armijo) with the
#: step uncapped, the plain one also with the adaptive entry step (growth
#: 2; the solo adaptive phase's setting)
BATCHED_UNCAPPED_PARAMS = BATCHED_PARAMS.replace(constrain_step_size=False)
BATCHED_ADAPTIVE_PARAMS = BATCHED_UNCAPPED_PARAMS.replace(adaptive_entry_step=2.0)
BATCHED_OWLQN_UNCAPPED_PARAMS = BATCHED_OWLQN_PARAMS.replace(constrain_step_size=False)
#: the batched deep phase: both at m = 80 (two bf16 rings of 2.7 GB)
BATCHED_DEEP_PARAMS = {
    "plain": (BATCHED_UNCAPPED_PARAMS.replace(m=DEEP_M), BATCHED_DEEP_PATH, ()),
    "owlqn": (BATCHED_OWLQN_UNCAPPED_PARAMS.replace(m=DEEP_M), BATCHED_OWLQN_DEEP_PATH,
              BATCHED_OWLQN_INIT),
}


#: the ring depths the batched epilogues K4 b and K14 b are checked at
#: (``factory.batched_epilogue_grid`` picks the form at each); m = 19 is
#: ``DEEP_VS_STATIC_M``, whose solo static forms the deep-history phase
#: has compiled
BATCHED_EPILOGUE_DEPTHS = ((M, ""), (DEEP_VS_STATIC_M, "_m19"), (DEEP_M, "_m80"))


def batched_form(fn, with_gp: bool) -> dict:
    """The form and launch geometry of a batched epilogue's last launch
    (``fn.last_form``, ``factory.batched_epilogue_grid``) and its compiled
    kernel's registers and spills."""
    f = fn.last_form
    compiled = {"mma": fn.mma_compiled, "mma_rows": fn.mma_rows_compiled, "static": fn.compiled,
                "deep": fn.deep_compiled}[f.form]
    ck = compiled[(*f.dtypes, with_gp)]
    return dict(kernel=f.kernel, form=f.form, programs_per_instance=f.programs,
                tiles_per_program=f.tiles, tile=f.T, programs=f.total,
                **{key: v for key, v in f.consts.items() if key != "m"}, **f.launch,
                **_compiled_info(ck))


def batched_fusion_inputs(seed: int, m: int) -> dict:
    """Seeded inputs of the batched fusions and deep epilogues at B x n =
    1024 x 2^14 with rings of depth m (bf16), a pseudo-gradient, xp zero
    at every 17th element and every third instance from the third
    frozen."""
    B, n = BATCH_B, BATCH_N
    g = torch.Generator(device="cuda").manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=g, device="cuda")
    live = torch.ones(B, dtype=torch.bool, device="cuda")
    live[2::3] = False
    xp = rosenbrock.initial_point(n, torch.float32, "cuda")[None, :] + 0.1 * r(B, n)
    xp[:, ::17] = 0.0
    return dict(xp=xp, d=0.1 * r(B, n), gp=r(B, n), pg=r(B, n),
                S=(0.1 * r(B, m, n)).bfloat16(), Y=(0.1 * r(B, m, n)).bfloat16(),
                stp=0.2 + torch.rand(B, generator=g, device="cuda"),
                coef=(0.5 / m ** 0.5) * r(B, 1 + 2 * m), live=live)


def _check_batched_fusions(k, a: dict, m: int, sfx: str, errs: dict, solo: dict,
                           cases: dict) -> None:
    """K15 b and K16 b at ring depth m against their plain versions and, on
    instances ``BATCH_SOLO``, against the solo K15 and K16 (r and rc, the
    combine's sums and the probe's (ft, g.r) bit for bit); adds each
    form's timing case to ``cases``."""
    tv, ts = TOL[(torch.float32, "vec")], TOL[(torch.float32, "sum")]
    live, frozen = a["live"], ~a["live"]
    lo, hi = windows(BATCH_N)[1]
    c = C_L1
    forms = {
        "K15b_combine_probe_batched": (
            k.combine_probe_batched, k.combine_probe_batched_ref,
            lambda f, out, lv: f(a["gp"], a["xp"], a["S"], a["Y"], a["coef"], a["stp"], lv, out),
            lambda b, cf, stp: k.combine_probe(a["gp"][b], a["xp"][b], a["S"][b], a["Y"][b],
                                               cf[0], cf[1:1 + m], cf[1 + m:], stp)),
        "K16b_combine_ow_probe_batched": (
            k.combine_ow_probe_batched, k.combine_ow_probe_batched_ref,
            lambda f, out, lv: f(a["pg"], a["xp"], a["S"], a["Y"], a["coef"], c, lo, hi,
                                 a["stp"], lv, out),
            lambda b, cf, stp: k.combine_ow_probe(a["pg"][b], a["xp"][b], a["S"][b], a["Y"][b],
                                                  cf[0], cf[1:1 + m], cf[1 + m:], c, lo, hi,
                                                  stp)),
    }
    every = torch.ones_like(live)
    for name, (kern, ref, call, one) in forms.items():
        rk, rq = torch.zeros_like(a["d"]), torch.zeros_like(a["d"])
        sk, sq = call(kern, rk, live), call(ref, rq, live)
        errs[name + sfx] = (check(f"{name}{sfx} r", rk[live], rq[live], tv),
                            *(check(f"{name}{sfx} sum{i}", sk[i][live], sq[i][live], ts)
                              for i in range(len(sk))))
        if rk[frozen].any():
            raise AssertionError(f"{name}{sfx} wrote a frozen instance")
        for b in BATCH_SOLO:
            cf = a["coef"][b]
            want = one(b, cf, float(a["stp"][b]))
            if not same_bits(rk[b], want[0]):
                raise AssertionError(f"{name}{sfx} instance {b}: r differs from the solo kernel")
            bits = [same_bits(u[b], v) for u, v in zip(sk, want[1:])]
            if not all(bits):
                raise AssertionError(f"{name}{sfx} instance {b}: the sums (combine's, then the "
                                     f"probe's) against the solo kernel's bit for bit: {bits}")
            solo[f"{name}{sfx}_{b}"] = "bit-exact"
        out = torch.zeros_like(a["d"])
        cases[name + sfx] = (lambda call=call, kern=kern, out=out: call(kern, out, every),
                             lambda call=call, ref=ref, out=out: call(ref, out, every), m)


def _check_batched_deep_epilogues(k, a: dict, m: int, sfx: str, errs: dict, solo: dict,
                                  cases: dict, forms: dict) -> None:
    """K4 b and K14 b at ring depth m (the tensor-core form with f32
    vectors over a bf16 ring up to ``factory.MMA_MAX_M`` rows; the deep
    form's launches counted in ``.deep_launches`` above ``factory.MAX_M``)
    against their plain versions (vectors and sums normwise, ring row
    ``end`` bit for bit the rounding of the kernel's own pair, the other
    rows kept, frozen instances untouched) and, on instances
    ``BATCH_SOLO``, against the solo K4 and K14 (x, g, pg and the rings bit
    for bit; the products' normwise gap to the solo kernel's fold
    printed); adds their timing cases (in place, on copies) to
    ``cases`` and each launch's form and geometry to ``forms``."""
    tv, ts = TOL[(torch.float32, "vec")], TOL[(torch.float32, "sum")]
    live, frozen = a["live"], ~a["live"]
    lo, hi = windows(BATCH_N)[1]
    c, end = C_L1, m - 3
    names = ("xp", "gp", "pg", "S", "Y")

    def tpg(fn, t, lv):
        return fn(t["xp"], a["d"], t["gp"], a["stp"], t["S"], t["Y"], end, lv)

    def ow_tpg(fn, t, lv):
        return fn(t["xp"], a["d"], t["gp"], t["pg"], a["stp"], c, lo, hi, t["S"], t["Y"], end,
                  lv)

    epilogues = {
        "K4b_trial_pair_gram_batched": (k.trial_pair_gram_batched,
                                        k.trial_pair_gram_batched_ref, tpg, False),
        "K14b_owlqn_trial_pair_gram_batched": (k.owlqn_trial_pair_gram_batched,
                                               k.owlqn_trial_pair_gram_batched_ref, ow_tpg, True),
    }
    for base, (kern, ref, call, ow) in epilogues.items():
        name = base + sfx
        tk = {n_: a[n_].clone() for n_ in names}
        deep = kern.deep_launches
        outk = call(kern, tk, live)
        if kern.deep_launches != deep + (m > factory.MAX_M):
            raise AssertionError(f"{name}: the deep count does not follow the depth")
        forms[name] = batched_form(kern, False)
        tq = {n_: a[n_].clone() for n_ in ("xp", "gp", "pg")}
        tq["S"], tq["Y"] = a["S"].clone(), a["Y"].clone()
        outq = call(ref, tq, live)
        vecs = ("xp", "gp", "pg") if ow else ("xp", "gp")
        e = [check(f"{name} {n_}", tk[n_][live], tq[n_][live], tv) for n_ in vecs]
        e += [check(f"{name} sum{i}", u[live], v[live], ts)
              for i, (u, v) in enumerate(zip(outk, outq)) if u.dtype != torch.bool]
        if not all(torch.equal(u[live], v[live])
                   for u, v in zip(outk, outq) if u.dtype == torch.bool):
            raise AssertionError(f"{name}: changed differs from the plain version")
        errs[name] = tuple(e)
        s_new = ((tk["xp"] - a["xp"]) if ow else a["stp"][:, None] * a["d"]).to(torch.bfloat16)
        y_new = (tk["gp"] - a["gp"]).to(torch.bfloat16)
        keep = [j for j in range(m) if j != end]
        if not (same_bits(tk["S"][live][:, end], s_new[live])
                and same_bits(tk["Y"][live][:, end], y_new[live])
                and same_bits(tk["S"][:, keep], a["S"][:, keep])
                and same_bits(tk["Y"][:, keep], a["Y"][:, keep])):
            raise AssertionError(f"{name}: the ring rows are not the rounded pair and the kept "
                                 f"rows")
        if not all(same_bits(tk[n_][frozen], a[n_][frozen]) for n_ in names):
            raise AssertionError(f"{name} wrote a frozen instance")
        del tq, outq, s_new, y_new
        torch.cuda.empty_cache()
        SP, YP = outk[3:5] if ow else outk[4:6]
        for b in BATCH_SOLO:
            Sb, Yb = a["S"][b].clone(), a["Y"][b].clone()
            stp = float(a["stp"][b])
            if ow:
                x1, g1, pg1, SP1, YP1 = k.owlqn_trial_pair_gram(
                    a["xp"][b], a["d"][b], a["gp"][b], a["pg"][b], stp, c, lo, hi, Sb, Yb,
                    end)[:5]
            else:
                x1, _, g1, *_, SP1, YP1 = k.trial_pair_gram(a["xp"][b], a["d"][b], a["gp"][b],
                                                             stp, Sb, Yb, end)
                pg1 = tk["pg"][b]
            bits = dict(x=same_bits(tk["xp"][b], x1), g=same_bits(tk["gp"][b], g1),
                        pg=same_bits(tk["pg"][b], pg1), S=same_bits(tk["S"][b], Sb),
                        Y=same_bits(tk["Y"][b], Yb))
            if not all(bits.values()):
                raise AssertionError(f"{name} instance {b} differs from the solo kernel: "
                                     f"{bits}")
            solo[f"{name}_{b}"] = dict(bits, products_normwise=max(err(SP[b], SP1),
                                                                   err(YP[b], YP1)))
        del tk, outk, SP, YP
        torch.cuda.empty_cache()
        t = {n_: a[n_].clone() for n_ in names}
        every = torch.ones_like(live)
        cases[name] = (lambda call=call, kern=kern, t=t: call(kern, t, every),
                       lambda call=call, ref=ref, t=t: call(ref, t, every), m)


def batched_compiled() -> list:
    """Registers and spills of every compiled batched epilogue and fusion
    (K4 b, K14 b, their tensor-core, row-block and deep forms, each with and without
    the . gp column, K15 b (with and without its fix form) and K16 b with M
    = m and M = 0); a form that spills fails the phase."""
    k = rosenbrock.value_and_grad.kernels
    forms = []
    for form, fn in (("K4b", k.trial_pair_gram_batched),
                     ("K14b", k.owlqn_trial_pair_gram_batched)):
        for kind, compiled in (("", fn.compiled), (" mma", fn.mma_compiled),
                               (" mma_rows", fn.mma_rows_compiled), (" deep", fn.deep_compiled)):
            for (vd, hd, gp), ck in sorted(compiled.items(), key=str):
                forms.append(dict(form=form + (" gp" if gp else "") + kind,
                                  vectors=str(vd), history=str(hd), **_compiled_info(ck)))
    for form, fn in (("K15b", k.combine_probe_batched), ("K16b", k.combine_ow_probe_batched)):
        for (vd, hd, deep, *fix), ck in sorted(fn.compiled.items(), key=str):
            forms.append(dict(form=form + (" fix" if any(fix) else "") + (" M=0" if deep else ""),
                              vectors=str(vd), history=str(hd), **_compiled_info(ck)))
    emit(phase="batched_compiled", forms=forms)
    spilled = [f for f in forms if f["n_spills"]]
    if spilled:
        raise AssertionError(f"batched forms spill registers: {spilled}")
    return forms


def phase_batched_fusion_kernels() -> dict:
    """K15 b and K16 b at m = 6 and their M = 0 forms at m = 80, and K4 b
    and K14 b at m = 6, 19 and 80 (``BATCHED_EPILOGUE_DEPTHS``; each
    launch's form and geometry printed), against their plain versions on
    the card at B = 1024, n = 2^14, f32 vectors, bf16 rings, a third of the
    instances frozen, the OWL-QN forms on a window whose ends fall inside
    the kernels' blocks (normwise 1e-5 on vectors, 1e-4 on sums; the ring
    rows and the frozen instances bit for bit); instances 0, 511 and 1023
    against the solo K15, K16 (r and rc, the sums and the probes bit for
    bit) and the solo K4 and K14 (x, g, pg and the rings bit for bit).
    Each timed with every instance live beside its plain version and its
    bound (5 launches a sample at m = 80, 20 below); every compiled form's
    registers and spills (``batched_compiled``)."""
    k = rosenbrock.value_and_grad.kernels
    errs, solo, cases, forms = {}, {}, {}, {}
    times, timed_by, bounds = {}, {}, {}
    for m, sfx in BATCHED_EPILOGUE_DEPTHS:
        a = batched_fusion_inputs(SEED + 16, m)
        if m in (M, DEEP_M):
            _check_batched_fusions(k, a, m, sfx, errs, solo, cases)
        _check_batched_deep_epilogues(k, a, m, sfx, errs, solo, cases, forms)
        for name, (kern, plain, depth) in cases.items():
            k_ms, p_ms, k_by, p_by = kernel_vs_plain(kern, plain,
                                                     20 if m <= factory.MAX_M else 5)
            times[name], timed_by[name] = (k_ms, p_ms), (k_by, p_by)
            bounds[name] = bound(name, BATCH_B * BATCH_N, 4, 2, depth)
        cases.clear()
        del a
        torch.cuda.empty_cache()
    compiled = batched_compiled()
    errs = {name: (max(e[0] for e in v), max(e[1] for e in v)) for name, v in errs.items()}
    emit(phase="batched_fusion_kernels", B=BATCH_B, n=BATCH_N,
         m=[m for m, _ in BATCHED_EPILOGUE_DEPTHS],
         window=windows(BATCH_N)[1], frozen=len(range(2, BATCH_B, 3)), max_abs_err={n_: e[0] for n_, e in errs.items()},
         max_normwise_err={n_: e[1] for n_, e in errs.items()},
         tol=dict(vec=TOL[(torch.float32, "vec")], sum=TOL[(torch.float32, "sum")],
                  ring_rows="bit-exact", frozen="bit-exact",
                  vs_solo_r_rc_sums_probes_x_g_pg_rings="bit-exact"),
         vs_solo=solo, compiled=len(compiled), epilogue_forms=forms,
         device_ms={n_: {"kernel": t[0], "plain": t[1], "bound": bounds[n_][0],
                         **({"n_regs": forms[n_]["n_regs"]} if n_ in forms else {})}
                    for n_, t in times.items()},
         timed_by={n_: {"kernel": t[0], "plain": t[1]} for n_, t in timed_by.items()})
    return {"errs": errs, "times": times, "bounds": bounds, "timed_by": timed_by}


#: the batched tensor-core form under the solo form's rules (n a multiple of
#: ``factory.MMA_ALIGN``, at most ``factory.MMA_MAX_CHUNKS`` chunks a
#: program, the chunks' products carried in float32 adds): the depths, the
#: (B, n) shapes (the batched main path's, its n off 16, and four
#: instances at n = 2^24) and the gap to the float64 product it must keep
#: (the solo forms' level)
RULES_DEPTHS = (DEEP_VS_STATIC_M, DEEP_M)
RULES_SHAPES = ((BATCH_B, BATCH_N), (BATCH_B, BATCH_N + 2), (4, N_BIG))
RULES_GAP = 3e-7


def rules_inputs(B: int, n: int, m: int, seed: int) -> dict:
    """Seeded inputs of the batched epilogues at B x n with m bf16 ring rows
    in the runner's padded layout (``core.ring_zeros``; made 16 rows of one
    instance at a time: at 4 x 2^24 x 80 a float32
    draw of a whole ring would take 21 GB), every instance live, xp zero at
    every 17th element."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=g, device="cuda")
    xp = rosenbrock.initial_point(n, torch.float32, "cuda")[None, :] + 0.1 * r(B, n)
    xp[:, ::17] = 0.0
    a = dict(xp=xp, d=0.1 * r(B, n), gp=r(B, n), pg=r(B, n),
             stp=0.2 + torch.rand(B, generator=g, device="cuda"),
             live=torch.ones(B, dtype=torch.bool, device="cuda"))
    for ring in ("S", "Y"):
        a[ring] = ring_zeros((B, m, n), torch.bfloat16, "cuda")
        for b in range(B):
            for j in range(0, m, 16):
                a[ring][b, j:j + 16] = 0.1 * r(min(16, m - j), n)
    return a


def phase_batched_mma_rules() -> list:
    """K4 b and K14 b with their . gp columns under the solo form's rules,
    at ``RULES_DEPTHS`` and ``RULES_SHAPES``: the form the grid picks (over
    the runner's padded ring the tensor-core form at every n, 2^14 + 2
    too, as the solo launch picks there), its compiled
    registers (a spill fails), and for the tensor-core form the chunks a
    program sums (at most ``factory.MMA_MAX_CHUNKS``) and each instance's
    SP and YP against the float64 product of its own operands
    (``products_f64``; instances 0, B/2 and B - 1), normwise within
    ``RULES_GAP``; then every compiled batched form's registers
    (``batched_compiled``)."""
    k = rosenbrock.value_and_grad.kernels
    rows = []
    for m in RULES_DEPTHS:
        end = m - 3
        for B, n in RULES_SHAPES:
            a = rules_inputs(B, n, m, SEED + 22 + m)
            x0, g0, pg0 = a["xp"].clone(), a["gp"].clone(), a["pg"].clone()
            lo, hi = 5, n - 7
            for ow in (False, True):
                kern = k.owlqn_trial_pair_gram_batched if ow else k.trial_pair_gram_batched
                if ow:
                    a["xp"].copy_(x0)
                    a["gp"].copy_(g0)
                    a["pg"].copy_(pg0)
                    out = kern(a["xp"], a["d"], a["gp"], a["pg"], a["stp"], 0.7, lo, hi,
                               a["S"], a["Y"], end, a["live"], with_gp=True)
                    SP, YP = out[3:5]
                else:
                    out = kern(a["xp"], a["d"], a["gp"], a["stp"], a["S"], a["Y"], end,
                               a["live"], with_gp=True)
                    SP, YP = out[4:6]
                torch.cuda.synchronize()
                f = kern.last_form
                info = _compiled_info(f.compiled)
                grid = factory.batched_epilogue_grid(B, n, m, torch.float32, torch.bfloat16)
                # the padded ring: the tensor-core form at every n
                want = "mma"
                tag = f"{'K14b' if ow else 'K4b'} gp m={m} B={B} n={n}"
                if f.form != want or grid.form != want or info["n_spills"]:
                    raise AssertionError(f"{tag}: the {f.form} form ran ({want} wanted), {info}")
                row = dict(kernel=f.kernel, m=m, B=B, n=n, form=f.form,
                           programs_per_instance=f.programs, chunks_per_program=f.tiles,
                           tile=f.T, **info)
                if f.form == "mma":
                    if f.tiles > factory.MMA_MAX_CHUNKS:
                        raise AssertionError(f"{tag}: {f.tiles} chunks a program")
                    gaps = []
                    for b in sorted({0, B // 2, B - 1}):
                        g = a["gp"][b]
                        s = a["xp"][b] - x0[b] if ow else a["stp"][b] * a["d"][b]
                        d0 = -a["pg"][b] if ow else -g
                        want_p = products_f64(a["S"][b], a["Y"][b], s, g - g0[b], d0, g0[b], end)
                        gaps.append((check(f"{tag} instance {b} SP vs float64", SP[b],
                                           want_p[0], RULES_GAP)[1],
                                     check(f"{tag} instance {b} YP vs float64", YP[b],
                                           want_p[1], RULES_GAP)[1]))
                        del want_p
                    row.update(sp_gap=max(p for p, _ in gaps), yp_gap=max(q for _, q in gaps))
                rows.append(row)
                # the next launch starts from the same point and rings
                a["xp"].copy_(x0)
                a["gp"].copy_(g0)
                del out, SP, YP
            del a, x0, g0, pg0
            torch.cuda.empty_cache()
    emit(phase="batched_mma_rules", tol=RULES_GAP, chunks_max=factory.MMA_MAX_CHUNKS,
         align=factory.MMA_ALIGN, rows=rows)
    batched_compiled()
    return rows


def _batched_turns(name: str, params: LbfgsParams, path: tuple, unfused_path: tuple,
                   init: tuple = ()) -> dict:
    """The fused batched run (the objective's K15 b or K16 b) and, in turns
    with it, the same run on the objective without the fusions' hooks
    (``unfused``: K3 b or K13 b, a probe on every trip) from ``batched_x0``
    at B x n = 1024 x 2^14: one warm run of each, then ``BATCHED_RUNS``
    timed runs of each in turns, the counts reset before each.  Each
    side's last run must launch its path and its init and nothing else,
    call no plain version, end with every fx finite, and launch its
    epilogue and its combine once per iteration; the fused side's searches
    after each instance's first take their first trip carried, the
    unfused side's none.  Returns, per side, (state, walls, launches,
    reads, carried first trips, iterations) and the starts."""
    x0b = batched_x0(BATCH_B, BATCH_N)
    fns = {"fused": default_evaluate(), "unfused": unfused(default_evaluate())}
    for fn in fns.values():
        minimize_batched(params, x0b, fn)
    torch.cuda.synchronize()
    runs = {side: dict(walls=[]) for side in fns}
    for _ in range(BATCHED_RUNS):
        for side, fn in fns.items():
            reset_counts()
            out = []
            runs[side]["walls"].append(profiling.timed(
                lambda: out.append(minimize_batched(params, x0b, fn, return_state=True)),
                warmup=0))
            runs[side].update(st=out[0], lc=launches(), pc=plain_calls(), reads=to_host.reads,
                              used=carried.used)
    for side, r in runs.items():
        st, lc = r["st"], r["lc"]
        p = path if side == "fused" else unfused_path
        iters = int(st.k.max()) - 1
        r["iters"] = iters
        if not np.isfinite(st.fx).all() or st.x.device.type != "cuda":
            raise AssertionError(f"{name} ({side}): non-finite fx or the run left the card")
        if not 1 <= lc[p[1]] == lc[p[2]] <= iters:
            raise AssertionError(f"{name} ({side}): launches {lc} in {iters} iterations")
        _expect(f"{name} ({side})", lc, r["pc"], **{k: lc[k] for k in p},
                **dict.fromkeys(init, 1))
        # every search after an instance's first carries its first trip
        want = int(np.maximum(st.k - 2, 0).sum()) if side == "fused" else 0
        if r["used"] != want:
            raise AssertionError(f"{name} ({side}): {r['used']} carried first trips, {want} "
                                 f"expected")
    runs["x0b"] = x0b
    return runs


def _vs_solo_8(name: str, params: LbfgsParams, x0b: torch.Tensor, fn=None) -> list:
    """Instances 0-7 solo through ``minimize_jit`` against a batched run of
    8 iterations on the objective ``fn`` (Rosenbrock's by default): the
    same iterations and evaluations, fx rel ``FUSION_TOL_8``."""
    fn = fn or default_evaluate()
    p8 = params.replace(max_iterations=9)
    st8 = minimize_batched(p8, x0b, fn, return_state=True)
    held = []
    for b in range(8):
        so = minimize_jit(p8, x0b[b].clone(), fn, return_state=True)
        rel = abs(float(st8.fx[b]) / float(so.prob.fx) - 1)
        if (so.k, so.prob.neval) != (int(st8.k[b]), int(st8.neval[b])) or not rel <= FUSION_TOL_8:
            raise AssertionError(f"{name} instance {b} against its solo run after 8 "
                                 f"iterations: k/neval {(int(st8.k[b]), int(st8.neval[b]))} vs "
                                 f"{(so.k, so.prob.neval)}, rel fx {rel:.3e}")
        held.append(dict(k=so.k, neval=so.prob.neval, rel_fx=rel))
    return held


def _uncapped_phase(phase: str, params: LbfgsParams, path: tuple, unfused_path: tuple,
                    init: tuple, beside: dict) -> tuple:
    """One batched uncapped path, fused and unfused in turns
    (``_batched_turns``), each side's line (``_batched_report``, with its
    device ms and host launch calls per iteration from a profiled run),
    the fused side at least 0.5 syncs per iteration below the unfused, and
    instances 0-7 against their solo runs."""
    runs = _batched_turns(phase, params, path, unfused_path, init)
    x0b = runs.pop("x0b")
    out = {}
    for side, r in runs.items():
        fn = default_evaluate() if side == "fused" else unfused(default_evaluate())
        out[side] = _batched_report(
            f"{phase}_{side}" if side == "unfused" else phase, r["st"], r["walls"], r["lc"],
            r["reads"], r["iters"], path if side == "fused" else unfused_path,
            **_batched_profile(params, x0b, fn), carried_first_trips=r["used"],
            **({"capped_batched_main_path": beside} if side == "fused" else {}))
    gain = out["unfused"]["syncs_per_iter"] - out["fused"]["syncs_per_iter"]
    if not gain >= 0.5:
        raise AssertionError(f"{phase}: the fusion saves {gain:.3f} syncs per iteration, "
                             f"0.5 at least expected")
    a, b = runs["fused"]["st"], runs["unfused"]["st"]
    same = (a.k == b.k) & (a.neval == b.neval) & (a.fx == b.fx)
    emit(phase=f"{phase}_vs_solo", iters=8, fx_tol=FUSION_TOL_8,
         instances=_vs_solo_8(phase, params, x0b), syncs_saved_per_iter=gain,
         fused_unfused_same_k_neval_fx=int(same.sum()))
    del runs, a, b, x0b
    torch.cuda.empty_cache()
    return out["fused"]["launches"], out


def phase_batched_uncapped_main_path(capped: dict) -> tuple:
    """``minimize_batched`` at the batched main path's configuration with
    the step uncapped (``BATCHED_UNCAPPED_PARAMS``), literal and with the
    adaptive entry step (``BATCHED_ADAPTIVE_PARAMS``): K2 b per probe not
    carried in, K4 b and K15 b per iteration; each in turns with the same
    run without the fusion (K3 b, a probe every trip).  Returns the literal
    run's launches and both fused lines."""
    beside = {key: capped.get(key) for key in (
        "instance_iters_per_s", "wall_ms_per_iter", "device_ms_per_iter", "syncs_per_iter",
        "launch_calls_per_iter")}
    lc, literal = _uncapped_phase("batched_uncapped_main_path", BATCHED_UNCAPPED_PARAMS,
                                  BATCHED_UNCAPPED_PATH, BATCHED_PATH, (), beside)
    _, adaptive = _uncapped_phase("batched_adaptive_main_path", BATCHED_ADAPTIVE_PARAMS,
                                  BATCHED_UNCAPPED_PATH, BATCHED_PATH, (), beside)
    return lc, dict(literal=literal, adaptive=adaptive)


def phase_batched_owlqn_uncapped_main_path(capped: dict) -> tuple:
    """The batched OWL-QN main path with the step uncapped
    (``BATCHED_OWLQN_UNCAPPED_PARAMS``): K10 b once, K8 b per probe not
    carried in, K14 b and K16 b per iteration, in turns with the same run
    without the fusion (K13 b)."""
    beside = {key: capped.get(key) for key in (
        "instance_iters_per_s", "wall_ms_per_iter", "device_ms_per_iter", "syncs_per_iter",
        "launch_calls_per_iter")}
    return _uncapped_phase("batched_owlqn_uncapped_main_path", BATCHED_OWLQN_UNCAPPED_PARAMS,
                           BATCHED_OWLQN_UNCAPPED_PATH, BATCHED_OWLQN_PATH, BATCHED_OWLQN_INIT,
                           beside)


def phase_batched_deep() -> dict:
    """``minimize_batched`` at m = 80 ring rows (``BATCHED_DEEP_PARAMS``),
    1024 x 2^14, f32 vectors, bf16 rings, uncapped, epsilon 0, 30
    iterations, plain and OWL-QN: K4 b (its tensor-core form; counted in
    the ``_m80`` row) and K15 b's M = 0 form per iteration (K14 b and K16 b
    under OWL-QN), K2 b (K8 b) per probe
    not carried in, nothing else, every fx finite; instance-iterations/s,
    device ms and syncs per iteration.  Returns the launches of both."""
    lc = {}
    for label, (params, path, init) in BATCHED_DEEP_PARAMS.items():
        st, walls, lc_run, pc, reads, iters, x0b = _batched_run(
            f"batched deep {label}", params, BATCH_B, BATCH_N, path, init)
        _batched_report(f"batched_deep_{label}", st, walls, lc_run, reads, iters, path,
                        **_batched_profile(params, x0b), m=params.m, plain_calls=pc)
        lc.update({name: lc_run[name] for name in path[1:]})
        del st, x0b
        torch.cuda.empty_cache()
    return lc


# ---------------------------------------------------------------------------
# the batched runner under damping and the gradient-only mode: K4 b ·gp,
# K14 b ·gp, K6 b and K15 b's fix form; K3 b and K13 b above 64 ring rows
# ---------------------------------------------------------------------------

_BD_PLAIN = ("K2b_probe_batched", "K4b_trial_pair_gram_batched_gp")
_BD_OWLQN = ("K8b_owlqn_probe_batched", "K14b_owlqn_trial_pair_gram_batched_gp")
#: the batched damped main paths, 30 iterations at 1024 x 2^14 from
#: ``batched_x0``: the batched main path (More-Thuente) and the batched
#: OWL-QN main path (c = 1 on [0, n - 1), Armijo) damped, capped and
#: uncapped, and ``with_gradient_only()`` (damping, strong-Wolfe
#: backtracking with the literal exit) at the cap; (params, the path's
#: probe, epilogue and combine, the init's kernels, the undamped path whose
#: reads it is held to)
BATCHED_DAMPED_PATHS = {
    "damped": (BATCHED_PARAMS.replace(damping=True), _BD_PLAIN + ("K6b_combine_fix_batched",),
               (), "capped"),
    "damped_uncapped": (BATCHED_UNCAPPED_PARAMS.replace(damping=True),
                        _BD_PLAIN + ("K15b_combine_probe_batched_fix",), (), "uncapped"),
    "gradient_only": (Lbfgs(BATCHED_PARAMS).with_gradient_only().param,
                      _BD_PLAIN + ("K6b_combine_fix_batched",), (), "capped"),
    "owlqn_damped": (BATCHED_OWLQN_PARAMS.replace(damping=True),
                     _BD_OWLQN + ("K13b_combine_ow_batched",), BATCHED_OWLQN_INIT,
                     "owlqn_capped"),
    "owlqn_damped_uncapped": (BATCHED_OWLQN_UNCAPPED_PARAMS.replace(damping=True),
                              _BD_OWLQN + ("K16b_combine_ow_probe_batched",),
                              BATCHED_OWLQN_INIT, "owlqn_uncapped"),
}
#: the batched runner at m = 80 ring rows (two bf16 rings of 2.7 GB), 10
#: iterations: capped, plain and OWL-QN (K3 b and K13 b with their
#: coefficients sized at launch), and damped capped, uncapped and OWL-QN
#: (the deep . gp epilogues, K6 b and K15 b fix with M = 0)
_B80 = dict(m=DEEP_M, max_iterations=11)
BATCHED_M80_PATHS = {
    "capped": (BATCHED_PARAMS.replace(**_B80),
               ("K2b_probe_batched", "K4b_trial_pair_gram_batched_m80", "K3b_combine_batched"),
               ()),
    "owlqn_capped": (BATCHED_OWLQN_PARAMS.replace(**_B80),
                     ("K8b_owlqn_probe_batched", "K14b_owlqn_trial_pair_gram_batched_m80",
                      "K13b_combine_ow_batched"), BATCHED_OWLQN_INIT),
    "damped": (BATCHED_PARAMS.replace(damping=True, **_B80),
               ("K2b_probe_batched", "K4b_trial_pair_gram_batched_gp_m80",
                "K6b_combine_fix_batched"), ()),
    "damped_uncapped": (BATCHED_UNCAPPED_PARAMS.replace(damping=True, **_B80),
                        ("K2b_probe_batched", "K4b_trial_pair_gram_batched_gp_m80",
                         "K15b_combine_probe_batched_fix_m80"), ()),
    "owlqn_damped": (BATCHED_OWLQN_PARAMS.replace(damping=True, **_B80),
                     ("K8b_owlqn_probe_batched", "K14b_owlqn_trial_pair_gram_batched_gp_m80",
                      "K13b_combine_ow_batched"), BATCHED_OWLQN_INIT),
}
#: the CUDA batched combines' instantiations (K3 b, K13 b, K6 b, each with
#: the static and the launch-sized coefficient array, in the three dtype
#: pairs) in the build log
COMBINE_BATCHED_KERNEL = re.compile(
    r"combine_batched_kernelI([fd])(13__nv_bfloat16|[fd])Lb([01])ELb([01])ELb([01])E")
COMBINE_BATCHED_FORMS = 3 * 3 * 2


def batched_damped_inputs(seed: int, m: int) -> dict:
    """``batched_fusion_inputs`` with each instance's damped-row
    coefficients (ca, cb) appended to its coefficient row (``coef_fix``, [B,
    2m + 3]): ca in [0.5, 1) and cb in (-0.3, 0], as a case-1 blend gives
    them, so that repeated timing launches keep the row bounded."""
    a = batched_fusion_inputs(seed, m)
    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    u = torch.rand(BATCH_B, 2, generator=g, device="cuda")
    a["coef_fix"] = torch.cat([a["coef"], 0.5 + 0.5 * u[:, :1], -0.3 * u[:, 1:]],
                              dim=1).contiguous()
    return a


def _check_gp_epilogues(k, a: dict, m: int, sfx: str, errs: dict, solo: dict,
                        cases: dict, forms: dict) -> None:
    """K4 b and K14 b with the . gp column (``with_gp=True``; the form
    ``factory.batched_epilogue_grid`` picks, recorded in ``forms``) against
    their plain versions (vectors and sums normwise, ring row ``end`` bit
    for bit the rounding of the kernel's own pair, the other rows kept,
    frozen instances untouched), every output but the new column bit for
    bit the 3-column launch's, and on instances ``BATCH_SOLO`` against the
    solo K4 and K14 with_gp (x, g, pg and the
    rings bit for bit; whether the products are too, their normwise gap and
    the . gp column's, printed); adds the timing cases (in place, on
    copies) to ``cases``."""
    tv, ts = TOL[(torch.float32, "vec")], TOL[(torch.float32, "sum")]
    live, frozen = a["live"], ~a["live"]
    lo, hi = windows(BATCH_N)[1]
    c, end = C_L1, (BATCH_END if m == M else m - 3)
    names = ("xp", "gp", "pg", "S", "Y")

    def tpg(fn, t, lv, **kw):
        return fn(t["xp"], a["d"], t["gp"], a["stp"], t["S"], t["Y"], end, lv, **kw)

    def ow_tpg(fn, t, lv, **kw):
        return fn(t["xp"], a["d"], t["gp"], t["pg"], a["stp"], c, lo, hi, t["S"], t["Y"], end,
                  lv, **kw)

    epilogues = {
        "K4b_trial_pair_gram_batched_gp": (k.trial_pair_gram_batched,
                                           k.trial_pair_gram_batched_ref, tpg, False),
        "K14b_owlqn_trial_pair_gram_batched_gp": (k.owlqn_trial_pair_gram_batched,
                                                  k.owlqn_trial_pair_gram_batched_ref, ow_tpg,
                                                  True),
    }
    clone = lambda: {n_: a[n_].clone() for n_ in names}
    for base, (kern, ref, call, ow) in epilogues.items():
        name = base + sfx
        tk = clone()
        gp_launches = kern.gp_launches
        outk = call(kern, tk, live, with_gp=True)
        if kern.gp_launches != gp_launches + 1:
            raise AssertionError(f"{name}: the . gp form did not launch")
        forms[name] = batched_form(kern, True)
        t3 = clone()
        out3 = call(kern, t3, live)
        # (a frozen instance's sums are undefined: never written)
        if not (all(same_bits(tk[n_], t3[n_]) for n_ in names)
                and all(same_bits((u[..., :3] if u.ndim == 3 else u)[live], v[live])
                        for u, v in zip(outk, out3))):
            raise AssertionError(f"{name}: columns 0-2 or another output differ from the "
                                 f"3-column launch's")
        del t3, out3
        tq = clone()
        outq = call(ref, tq, live, with_gp=True)
        vecs = ("xp", "gp", "pg") if ow else ("xp", "gp")
        e = [check(f"{name} {n_}", tk[n_][live], tq[n_][live], tv) for n_ in vecs]
        e += [check(f"{name} sum{i}", u[live], v[live], ts)
              for i, (u, v) in enumerate(zip(outk, outq)) if u.dtype != torch.bool]
        if not all(torch.equal(u[live], v[live])
                   for u, v in zip(outk, outq) if u.dtype == torch.bool):
            raise AssertionError(f"{name}: changed differs from the plain version")
        errs[name] = tuple(e)
        s_new = ((tk["xp"] - a["xp"]) if ow else a["stp"][:, None] * a["d"]).to(torch.bfloat16)
        y_new = (tk["gp"] - a["gp"]).to(torch.bfloat16)
        keep = [j for j in range(m) if j != end]
        if not (same_bits(tk["S"][live][:, end], s_new[live])
                and same_bits(tk["Y"][live][:, end], y_new[live])
                and same_bits(tk["S"][:, keep], a["S"][:, keep])
                and same_bits(tk["Y"][:, keep], a["Y"][:, keep])):
            raise AssertionError(f"{name}: the ring rows are not the rounded pair and the kept "
                                 f"rows")
        if not all(same_bits(tk[n_][frozen], a[n_][frozen]) for n_ in names):
            raise AssertionError(f"{name} wrote a frozen instance")
        del tq, outq, s_new, y_new
        torch.cuda.empty_cache()
        SP, YP = outk[3:5] if ow else outk[4:6]
        for b in BATCH_SOLO:
            Sb, Yb = a["S"][b].clone(), a["Y"][b].clone()
            stp = float(a["stp"][b])
            if ow:
                x1, g1, pg1, SP1, YP1 = k.owlqn_trial_pair_gram(
                    a["xp"][b], a["d"][b], a["gp"][b], a["pg"][b], stp, c, lo, hi, Sb, Yb, end,
                    with_gp=True)[:5]
            else:
                x1, _, g1, *_, SP1, YP1 = k.trial_pair_gram(a["xp"][b], a["d"][b], a["gp"][b],
                                                             stp, Sb, Yb, end, with_gp=True)
                pg1 = tk["pg"][b]
            bits = dict(x=same_bits(tk["xp"][b], x1), g=same_bits(tk["gp"][b], g1),
                        pg=same_bits(tk["pg"][b], pg1), S=same_bits(tk["S"][b], Sb),
                        Y=same_bits(tk["Y"][b], Yb))
            if not all(bits.values()):
                raise AssertionError(f"{name} instance {b} differs from the solo kernel: {bits}")
            solo[f"{name}_{b}"] = dict(
                bits, products_bit_for_bit=same_bits(SP[b], SP1) and same_bits(YP[b], YP1),
                products_normwise=max(err(SP[b], SP1), err(YP[b], YP1)),
                gp_column_normwise=max(err(SP[b][:, 3], SP1[:, 3]),
                                       err(YP[b][:, 3], YP1[:, 3])))
        del tk, outk, SP, YP
        torch.cuda.empty_cache()
        t = clone()
        every = torch.ones_like(live)
        cases[name] = (lambda call=call, kern=kern, t=t: call(kern, t, every, with_gp=True),
                       lambda call=call, ref=ref, t=t: call(ref, t, every, with_gp=True), m)


def _check_fix_combines(k, a: dict, m: int, sfx: str, errs: dict, solo: dict,
                        cases: dict) -> None:
    """K6 b and K15 b's fix form (M = m up to ``factory.MAX_M`` rows, M = 0
    above) against their plain versions (r and the sums normwise, the
    damped rows bit for bit, frozen instances untouched), K15 b fix's rows
    bit for bit K6 b's, and on instances ``BATCH_SOLO`` against the solo K6
    and K15 fix (r and the damped row bit for bit, and K15 b's sums and
    probe too); adds the timing cases to ``cases``."""
    tv, ts = TOL[(torch.float32, "vec")], TOL[(torch.float32, "sum")]
    live, frozen = a["live"], ~a["live"]
    end, cf = (BATCH_END if m == M else m - 3), a["coef_fix"]

    def k6(fn, Y, out, lv):
        return fn(a["gp"], a["S"], Y, cf, lv, out, end)

    def k15(fn, Y, out, lv):
        return fn(a["gp"], a["xp"], a["S"], Y, cf, a["stp"], lv, out, fix=end)

    forms = {
        "K6b_combine_fix_batched": (fused.combine_fix_batched, fused.combine_fix_batched_ref,
                                    k6),
        "K15b_combine_probe_batched_fix": (k.combine_probe_batched,
                                           k.combine_probe_batched_ref, k15),
    }
    rows = {}
    for base, (kern, ref, call) in forms.items():
        name = base + sfx
        Yk, rk = a["Y"].clone(), torch.zeros_like(a["d"])
        sk = call(kern, Yk, rk, live)
        Yq, rq = a["Y"].clone(), torch.zeros_like(a["d"])
        sq = call(ref, Yq, rq, live)
        errs[name] = (check(f"{name} r", rk[live], rq[live], tv),
                      *(check(f"{name} sum{i}", u[live], v[live], ts)
                        for i, (u, v) in enumerate(zip(sk, sq))))
        if not same_bits(Yk, Yq):
            raise AssertionError(f"{name}: the damped rows differ from the plain version's")
        if rk[frozen].any() or not same_bits(Yk[frozen], a["Y"][frozen]):
            raise AssertionError(f"{name} wrote a frozen instance")
        rows[base] = Yk[:, end].clone()
        del Yq, rq
        for b in BATCH_SOLO:
            c1 = cf[b]
            args = (c1[0], c1[1:1 + m], c1[1 + m:1 + 2 * m])
            Yb = a["Y"][b].clone()
            if call is k6:
                want = fused.combine_fix(a["gp"][b], a["S"][b], Yb, *args, end, c1[1 + 2 * m],
                                         c1[2 + 2 * m])
                sums = True
            else:
                want = k.combine_probe(a["gp"][b], a["xp"][b], a["S"][b], Yb, *args,
                                       float(a["stp"][b]), fix=(end, c1[1 + 2 * m],
                                                                c1[2 + 2 * m]))
                sums = all(same_bits(u[b], v) for u, v in zip(sk, want[1:]))
            bits = dict(r=same_bits(rk[b], want[0]), Y=same_bits(Yk[b], Yb), sums=sums)
            if not all(bits.values()):
                raise AssertionError(f"{name} instance {b} differs from the solo kernel: {bits}")
            solo[f"{name}_{b}"] = "bit-exact"
        del Yk, rk
        Yt, out = a["Y"].clone(), torch.zeros_like(a["d"])
        every = torch.ones_like(live)
        cases[name] = (lambda call=call, kern=kern, Yt=Yt, out=out: call(kern, Yt, out, every),
                       lambda call=call, ref=ref, Yt=Yt, out=out: call(ref, Yt, out, every), m)
    if not same_bits(rows["K6b_combine_fix_batched"], rows["K15b_combine_probe_batched_fix"]):
        raise AssertionError(f"K15b fix{sfx}: the damped rows differ from K6 b's")


def _check_deep_capped_combines(a: dict, m: int, errs: dict, solo: dict, cases: dict) -> None:
    """K3 b and K13 b above ``factory.MAX_M`` rows (the coefficients in
    shared memory sized at launch) against their plain versions, and r and
    rc on instances ``BATCH_SOLO`` bit for bit the solo K3 and K13 (their
    own launch-sized form); adds the timing cases to ``cases``."""
    tv, ts = TOL[(torch.float32, "vec")], TOL[(torch.float32, "sum")]
    live, frozen = a["live"], ~a["live"]
    lo, hi = windows(BATCH_N)[1]
    coef = a["coef"]
    forms = {
        "K3b_combine_batched_m80": (
            fused.combine_batched, fused.combine_batched_ref,
            lambda f, out, lv: f(a["gp"], a["S"], a["Y"], coef, lv, out),
            lambda b, *cs: fused.combine(a["gp"][b], a["S"][b], a["Y"][b], *cs)),
        "K13b_combine_ow_batched_m80": (
            fused.combine_ow_batched, fused.combine_ow_batched_ref,
            lambda f, out, lv: f(a["pg"], a["S"], a["Y"], coef, lv, out, lo, hi),
            lambda b, *cs: fused.combine_ow(a["pg"][b], a["S"][b], a["Y"][b], *cs, lo, hi)),
    }
    every = torch.ones_like(live)
    for name, (kern, ref, call, one) in forms.items():
        rk, rq = torch.zeros_like(a["d"]), torch.zeros_like(a["d"])
        sk, sq = call(kern, rk, live), call(ref, rq, live)
        errs[name] = (check(f"{name} r", rk[live], rq[live], tv),
                      *(check(f"{name} sum{i}", u[live], v[live], ts)
                        for i, (u, v) in enumerate(zip(sk, sq))))
        if rk[frozen].any():
            raise AssertionError(f"{name} wrote a frozen instance")
        for b in BATCH_SOLO:
            if not same_bits(rk[b], one(b, coef[b, 0], coef[b, 1:1 + m], coef[b, 1 + m:])[0]):
                raise AssertionError(f"{name} instance {b}: r differs from the solo kernel")
            solo[f"{name}_{b}"] = "bit-exact"
        out = torch.zeros_like(a["d"])
        cases[name] = (lambda call=call, kern=kern, out=out: call(kern, out, every),
                       lambda call=call, ref=ref, out=out: call(ref, out, every), m)


def combine_batched_compiled() -> list:
    """Registers, shared memory and spills of every instantiation of the
    CUDA batched combines (``COMBINE_BATCHED_FORMS``) from the build log; a
    form that spills, or a log that does not show them all, fails."""
    forms = []
    for name, info in ptxas_kernels(_build.build_log()).items():
        if m := COMBINE_BATCHED_KERNEL.search(name):
            kind = "K13b" if m.group(3) == "1" else ("K6b" if m.group(4) == "1" else "K3b")
            forms.append(dict(kernel=kind, vectors=K5_TYPES[m.group(1)],
                              history=K5_TYPES[m.group(2)], dyn=m.group(5) == "1", **info))
    forms.sort(key=lambda f: (f["kernel"], f["vectors"], f["history"], f["dyn"]))
    if len(forms) != COMBINE_BATCHED_FORMS or any("n_regs" not in f for f in forms):
        raise AssertionError(f"the build log shows {len(forms)} of {COMBINE_BATCHED_FORMS} "
                             f"batched combine instantiations")
    spilled = [f for f in forms if f.get("spill_stores") or f.get("spill_loads")]
    if spilled:
        raise AssertionError(f"batched combines spill registers: {spilled}")
    return forms


def phase_batched_damped_kernels() -> dict:
    """K4 b ·gp and K14 b ·gp at m = 6, 19 and 80 (``BATCHED_EPILOGUE_DEPTHS``,
    each launch's form and geometry printed), K6 b and K15 b's fix form at
    m = 6 and in their deep forms at m = 80 (K15 b fix with M = 0), and K3 b
    and K13 b at m = 80, against their plain versions on the card at B =
    1024, n = 2^14, f32 vectors, bf16 rings, a third of the instances
    frozen, the OWL-QN forms on a window whose ends fall inside the
    kernels' blocks (normwise 1e-5 on vectors, 1e-4 on sums; ring rows,
    damped rows and frozen instances bit for bit); instances 0, 511 and
    1023 against the solo kernels bit for bit (``_check_gp_epilogues``, ``_check_fix_combines``,
    ``_check_deep_capped_combines``).  Each timed with every instance live
    beside its plain version and its bound (5 launches a sample at m = 80,
    20 below); the registers and spills of
    every compiled batched Triton form (``batched_compiled``) and CUDA
    combine (``combine_batched_compiled``): a spill fails."""
    k = rosenbrock.value_and_grad.kernels
    errs, solo, cases, forms = {}, {}, {}, {}
    times, timed_by, bounds = {}, {}, {}
    for m, sfx in BATCHED_EPILOGUE_DEPTHS:
        a = batched_damped_inputs(SEED + 17, m)
        _check_gp_epilogues(k, a, m, sfx, errs, solo, cases, forms)
        if m in (M, DEEP_M):
            _check_fix_combines(k, a, m, sfx, errs, solo, cases)
        if m == DEEP_M:
            _check_deep_capped_combines(a, m, errs, solo, cases)
        for name, (kern, plain, depth) in cases.items():
            k_ms, p_ms, k_by, p_by = kernel_vs_plain(kern, plain,
                                                     20 if m <= factory.MAX_M else 5)
            times[name], timed_by[name] = (k_ms, p_ms), (k_by, p_by)
            bounds[name] = bound(name, BATCH_B * BATCH_N, 4, 2, depth)
        cases.clear()
        del a
        torch.cuda.empty_cache()
    compiled = batched_compiled() + combine_batched_compiled()
    errs = {name: (max(e[0] for e in v), max(e[1] for e in v)) for name, v in errs.items()}
    emit(phase="batched_damped_kernels", B=BATCH_B, n=BATCH_N,
         m=[m for m, _ in BATCHED_EPILOGUE_DEPTHS], epilogue_forms=forms,
         window=windows(BATCH_N)[1], frozen=len(range(2, BATCH_B, 3)),
         max_abs_err={n_: e[0] for n_, e in errs.items()},
         max_normwise_err={n_: e[1] for n_, e in errs.items()},
         tol=dict(vec=TOL[(torch.float32, "vec")], sum=TOL[(torch.float32, "sum")],
                  ring_rows_damped_rows="bit-exact", frozen="bit-exact",
                  gp_columns_0_2_vs_3_column="bit-exact",
                  vs_solo_x_g_pg_rings_r_rows="bit-exact"),
         vs_solo=solo, compiled=compiled,
         device_ms={n_: {"kernel": t[0], "plain": t[1], "bound": bounds[n_][0],
                         **({"n_regs": forms[n_]["n_regs"]} if n_ in forms else {})}
                    for n_, t in times.items()},
         timed_by={n_: {"kernel": t[0], "plain": t[1]} for n_, t in timed_by.items()})
    return {"errs": errs, "times": times, "bounds": bounds, "timed_by": timed_by}


def _outside_search(line: dict) -> float:
    """A batched path's host reads per iteration outside its searches: its
    syncs less its probe launches (one read each) and the init's read."""
    return line["syncs_per_iter"] - line["probes_per_iter"] - 1 / line["iters"]


def phase_batched_damped_main_path(undamped: dict) -> dict:
    """``minimize_batched`` on the damped batched paths
    (``BATCHED_DAMPED_PATHS``, 1024 x 2^14, 30 iterations): each launches
    its probe per trip (not carried in), its . gp epilogue and its combine
    per iteration, its init's kernels once and nothing else, calls no plain
    version, ends with every fx finite, and reads the host per iteration
    outside its searches no more often than its undamped path
    (``undamped``, by ``_outside_search``; its syncs and probes per
    iteration printed beside).  Instance-iterations/s, device ms, syncs and
    host launch calls per iteration; then instances 0-7 solo against the
    batch after 8 iterations.  Returns each path's launches."""
    lc_all = {}
    for label, (params, path, init, base) in BATCHED_DAMPED_PATHS.items():
        st, walls, lc, pc, reads, iters, x0b = _batched_run(
            f"batched {label} main path", params, BATCH_B, BATCH_N, path, init)
        beside = undamped[base]
        outside, outside_undamped = (reads - lc[path[0]] - 1) / iters, _outside_search(beside)
        _batched_report(
            f"batched_{label}_main_path", st, walls, lc, reads, iters, path,
            **_batched_profile(params, x0b), plain_calls=pc,
            init_launches={k: lc[k] for k in init}, reads_outside_search_per_iter=outside,
            undamped={key: beside[key] for key in ("syncs_per_iter", "probes_per_iter",
                                                   "instance_iters_per_s",
                                                   "device_ms_per_iter")}
            | dict(path=base, reads_outside_search_per_iter=outside_undamped))
        if not outside <= outside_undamped + 1e-9:
            raise AssertionError(f"batched {label}: {outside} reads per iteration outside the "
                                 f"searches, the undamped path {outside_undamped}")
        del st
        emit(phase=f"batched_{label}_vs_solo", iters=8, fx_tol=FUSION_TOL_8,
             instances=_vs_solo_8(f"batched {label}", params, x0b))
        lc_all[label] = lc
        del x0b
        torch.cuda.empty_cache()
    return lc_all


def phase_batched_m80() -> dict:
    """``minimize_batched`` at m = 80 ring rows (``BATCHED_M80_PATHS``,
    1024 x 2^14, 10 iterations; one warm and one timed run each): capped
    plain and OWL-QN through K3 b and K13 b, damped capped, uncapped and
    OWL-QN through the deep . gp epilogues, K6 b and K15 b fix (M = 0);
    each path's kernels and nothing else, no plain version, every fx
    finite.  Returns each path's launches."""
    lc_all = {}
    for label, (params, path, init) in BATCHED_M80_PATHS.items():
        st, walls, lc, pc, reads, iters, x0b = _batched_run(
            f"batched m80 {label}", params, BATCH_B, BATCH_N, path, init, runs=1)
        _batched_report(f"batched_m80_{label}", st, walls, lc, reads, iters, path, m=params.m,
                        plain_calls=pc)
        lc_all[label] = lc
        del st, x0b
        torch.cuda.empty_cache()
    return lc_all


# ---------------------------------------------------------------------------
# the batched row-block form: K4 b and K14 b at the FOLD_ROWS settings
# ---------------------------------------------------------------------------

#: the instances of the batched row-block checks per ``FOLD_ROWS`` setting
#: (the timings and the paths take ``BATCH_B``): a check holds four copies
#: of the rings (an f32 ring of 1024 x 80 x 2^14 is 10.7 GB, an f64 one
#: 21.5 GB) and the plain version widens a bf16 ring to float32
BATCHED_FOLD_CHECK_B = {"_f32_m80": 512, "_f64_m80": 256, "_m260": 512}
#: chunks a program at which the row-block form's products (the . gp
#: launches') are held to the float64 product of their own operands, and
#: the normwise gap they must keep per vector dtype (the solo row-block
#: form kept 4.3e-8-1.7e-7 with f32 vectors, 1.2e-16-2.1e-15 with f64)
BATCHED_ROWS_CHUNKS = (2, 32, 64)
BATCHED_ROWS_GAP = {torch.float32: 3e-7, torch.float64: 2e-15}
#: the batched epilogues' table rows and their ``with_gp`` launches
BATCHED_FOLD_EPILOGUES = ("K4b_trial_pair_gram_batched", "K14b_owlqn_trial_pair_gram_batched")


class forced_chunks:
    """Inside, a batched tensor-core launch on B instances sums ``chunks``
    chunks a program (one program's worth of the batch-wide cap an
    instance, at most ``chunks`` chunks each)."""

    def __init__(self, B: int, chunks: int):
        self.B, self.chunks = B, chunks

    def __enter__(self):
        self.saved = factory.EPILOGUE_PROGRAMS, factory.MMA_MAX_CHUNKS
        factory.EPILOGUE_PROGRAMS, factory.MMA_MAX_CHUNKS = self.B, self.chunks

    def __exit__(self, *exc):
        factory.EPILOGUE_PROGRAMS, factory.MMA_MAX_CHUNKS = self.saved


def _fold_epilogues(k, a: dict, m: int) -> dict:
    """K4 b's and K14 b's (wrapper, plain version, call(fn, vectors and
    rings t, live, with_gp) in place on t, the solo launch on instance b
    with_gp on fresh rings) on the inputs ``a`` at ring depth m: end = m -
    3, K14 b on a window whose ends fall inside the kernels' chunks."""
    n = a["xp"].shape[1]
    lo, hi = windows(n)[1]
    end = m - 3

    def k4(fn, t, lv, gp):
        return fn(t["xp"], a["d"], t["gp"], a["stp"], t["S"], t["Y"], end, lv, with_gp=gp)

    def k14(fn, t, lv, gp):
        return fn(t["xp"], a["d"], t["gp"], t["pg"], a["stp"], C_L1, lo, hi, t["S"], t["Y"],
                  end, lv, with_gp=gp)

    def k4_solo(b, gp, S, Y):
        x, _, g, *_, SP, YP = k.trial_pair_gram(a["xp"][b], a["d"][b], a["gp"][b],
                                                float(a["stp"][b]), S, Y, end, with_gp=gp)
        return (x, g, None), (SP, YP)

    def k14_solo(b, gp, S, Y):
        x, g, pg, SP, YP = k.owlqn_trial_pair_gram(a["xp"][b], a["d"][b], a["gp"][b],
                                                   a["pg"][b], float(a["stp"][b]), C_L1, lo, hi,
                                                   S, Y, end, with_gp=gp)[:5]
        return (x, g, pg), (SP, YP)

    return {
        "K4b_trial_pair_gram_batched": (k.trial_pair_gram_batched,
                                        k.trial_pair_gram_batched_ref, k4, k4_solo),
        "K14b_owlqn_trial_pair_gram_batched": (k.owlqn_trial_pair_gram_batched,
                                               k.owlqn_trial_pair_gram_batched_ref, k14,
                                               k14_solo),
    }


def _check_batched_rows(k, a: dict, m: int, sfx: str, errs: dict, solo: dict, gaps: list,
                        forms: dict) -> None:
    """K4 b and K14 b, each with and without the . gp column, at ring depth
    m in the row-block form (``.mma_rows_launches``) against their plain
    versions (vectors and sums normwise, the changed flags, ring row
    ``end`` bit for bit the rounding of the kernel's own pair, the other
    rows kept, frozen instances untouched), against the deep fold form
    (which ran these depths before the row-block form) on the same inputs (x, g, pg, the rings and the flags
    bit for bit, the sums at the sum tolerance), the . gp launch's columns
    0-2 and other outputs against the 3-column launch's (bit for bit), on
    three instances against the solo K4 and K14 (x, g, pg and the rings
    bit for bit; the products' normwise gap printed), and the . gp
    launches' products against the float64 product of their own operands
    at ``BATCHED_ROWS_CHUNKS`` chunks a program (``BATCHED_ROWS_GAP``)."""
    vd, hd = a["xp"].dtype, a["S"].dtype
    tv, ts = TOL[(vd, "vec")], TOL[(vd, "sum")]
    B = a["xp"].shape[0]
    live, frozen = a["live"], ~a["live"]
    end = m - 3
    names = ("xp", "gp", "pg", "S", "Y")
    for base, (kern, ref, call, one) in _fold_epilogues(k, a, m).items():
        ow = base.startswith("K14b")
        vecs = ("xp", "gp", "pg") if ow else ("xp", "gp")
        three = None
        for gp in (False, True):
            name = base + ("_gp" if gp else "") + sfx
            tk = {n_: a[n_].clone() for n_ in names}
            rows = kern.mma_rows_launches
            outk = call(kern, tk, live, gp)
            if kern.last_form.form != "mma_rows" or kern.mma_rows_launches != rows + 1:
                raise AssertionError(f"{name}: the {kern.last_form.form} form ran")
            forms[name] = batched_form(kern, gp)
            tq = {n_: a[n_].clone() for n_ in names}
            outq = call(ref, tq, live, gp)
            e = [check(f"{name} {n_}", tk[n_][live], tq[n_][live], tv) for n_ in vecs]
            e += [check(f"{name} sum{i}", u[live], v[live], ts)
                  for i, (u, v) in enumerate(zip(outk, outq)) if u.dtype != torch.bool]
            if not all(torch.equal(u[live], v[live])
                       for u, v in zip(outk, outq) if u.dtype == torch.bool):
                raise AssertionError(f"{name}: changed differs from the plain version")
            errs[name] = tuple(e)
            del tq, outq
            torch.cuda.empty_cache()
            s_new = ((tk["xp"] - a["xp"]) if ow else a["stp"][:, None] * a["d"]).to(hd)
            y_new = (tk["gp"] - a["gp"]).to(hd)
            keep = [j for j in range(m) if j != end]
            if not (same_bits(tk["S"][live][:, end], s_new[live])
                    and same_bits(tk["Y"][live][:, end], y_new[live])
                    and same_bits(tk["S"][:, keep], a["S"][:, keep])
                    and same_bits(tk["Y"][:, keep], a["Y"][:, keep])):
                raise AssertionError(f"{name}: the ring rows are not the rounded pair and the "
                                     f"kept rows")
            if not all(same_bits(tk[n_][frozen], a[n_][frozen]) for n_ in names):
                raise AssertionError(f"{name} wrote a frozen instance")
            del s_new, y_new
            # the deep fold form on the same inputs
            tf = {n_: a[n_].clone() for n_ in names}
            with static_forms_up_to(M):
                outf = call(kern, tf, live, gp)
            if kern.last_form.form != "deep":
                raise AssertionError(f"{name}: the {kern.last_form.form} form ran as the fold")
            bits = {n_: same_bits(tk[n_], tf[n_]) for n_ in names}
            bits["changed"] = all(torch.equal(u[live], v[live]) for u, v in zip(outk, outf)
                                  if u.dtype == torch.bool)
            if not all(bits.values()):
                raise AssertionError(f"{name} against the deep fold form: {bits}")
            for i, (u, v) in enumerate(zip(outk, outf)):
                if u.dtype != torch.bool:
                    check(f"{name} sum{i} vs the fold form", u[live], v[live], ts)
            del tf, outf
            torch.cuda.empty_cache()
            if gp:
                t3, o3 = three
                if not (all(same_bits(t3[n_], tk[n_]) for n_ in names) and all(
                        same_bits((u[..., :3] if u.ndim == 3 else u)[live], v[live])
                        for u, v in zip(outk, o3))):
                    raise AssertionError(f"{name}: columns 0-2 or another output differ from "
                                         f"the 3-column launch's")
            SP, YP = outk[3:5] if ow else outk[4:6]
            for b in _generic_solo(B):
                Sb, Yb = a["S"][b].clone(), a["Y"][b].clone()
                (x1, g1, pg1), (SP1, YP1) = one(b, gp, Sb, Yb)
                bits = dict(x=same_bits(tk["xp"][b], x1), g=same_bits(tk["gp"][b], g1),
                            pg=pg1 is None or same_bits(tk["pg"][b], pg1),
                            S=same_bits(tk["S"][b], Sb), Y=same_bits(tk["Y"][b], Yb))
                if not all(bits.values()):
                    raise AssertionError(f"{name} instance {b} differs from the solo kernel: "
                                         f"{bits}")
                solo[f"{name}_{b}"] = dict(bits, products_normwise=max(err(SP[b], SP1),
                                                                       err(YP[b], YP1)))
                del Sb, Yb, SP1, YP1
            del SP, YP
            if gp:
                del three, t3, o3
            else:
                three = (tk, outk)
                continue
            del tk, outk
            torch.cuda.empty_cache()
            # the products against the float64 product at chunks a program
            for chunks in BATCHED_ROWS_CHUNKS:
                t = {n_: a[n_].clone() for n_ in names}
                with forced_chunks(B, chunks):
                    out = call(kern, t, live, True)
                if kern.last_form.tiles != chunks:
                    raise AssertionError(f"{name}: {kern.last_form.tiles} chunks a program")
                SP, YP = out[3:5] if ow else out[4:6]
                row = dict(kernel=name, m=m, B=B, chunks_per_program=chunks,
                           programs_per_instance=kern.last_form.programs,
                           tol=BATCHED_ROWS_GAP[vd], sp_gap=0.0, yp_gap=0.0)
                for b in _generic_solo(B):
                    g = t["gp"][b]
                    s = t["xp"][b] - a["xp"][b] if ow else a["stp"][b] * a["d"][b]
                    d0 = -t["pg"][b] if ow else -g
                    want = products_f64(t["S"][b], t["Y"][b], s, g - a["gp"][b], d0, a["gp"][b],
                                        end)
                    tag = f"{name} chunks={chunks} instance {b}"
                    row["sp_gap"] = max(row["sp_gap"], check(f"{tag} SP vs float64", SP[b],
                                                             want[0], BATCHED_ROWS_GAP[vd])[1])
                    row["yp_gap"] = max(row["yp_gap"], check(f"{tag} YP vs float64", YP[b],
                                                             want[1], BATCHED_ROWS_GAP[vd])[1])
                    del want
                gaps.append(row)
                del t, out, SP, YP
                torch.cuda.empty_cache()


def phase_batched_fold_kernels() -> dict:
    """K4 b and K14 b (each with and without the . gp column) in the
    tensor-core row-block form at each ``FOLD_ROWS`` setting (f32 and f64
    rings at m = 80, a bf16 ring at m = 260), which the deep fold form took
    until the row-block form did: checked on ``BATCHED_FOLD_CHECK_B`` instances of 2^14
    (``_check_batched_rows``; a third of the instances frozen), then at
    1024 x 2^14 with every instance live each launch timed beside its plain
    version and in turns against the deep fold form (fold, row-block,
    row-block, fold), with its bound; the compiled forms' registers
    (``batched_compiled``: a spill fails).  Returns the table's errs,
    times, bounds and timers (the 3-column launches' rows; the . gp
    launches' in the phase's line)."""
    k = rosenbrock.value_and_grad.kernels
    errs, solo, gaps, forms = {}, {}, [], {}
    times, timed_by, bounds, turns = {}, {}, {}, {}
    for sfx, (vd, hd, m) in FOLD_ROWS.items():
        a = batched_generic_inputs(SEED + 26 + m, vd, hd, m, BATCHED_FOLD_CHECK_B[sfx])
        _check_batched_rows(k, a, m, sfx, errs, solo, gaps, forms)
        del a
        torch.cuda.empty_cache()
        a = batched_generic_inputs(SEED + 27 + m, vd, hd, m, BATCH_B)
        every = torch.ones_like(a["live"])
        t = {n_: a[n_] for n_ in ("xp", "gp", "pg", "S", "Y")}
        for base, (kern, ref, call, _) in _fold_epilogues(k, a, m).items():
            for gp in (False, True):
                name = base + ("_gp" if gp else "") + sfx
                rows = lambda kern=kern, call=call, gp=gp: call(kern, t, every, gp)
                plain = lambda ref=ref, call=call, gp=gp: call(ref, t, every, gp)

                def fold(kern=kern, call=call, gp=gp):
                    with static_forms_up_to(M):
                        return call(kern, t, every, gp)

                k_ms, p_ms, k_by, p_by = kernel_vs_plain(rows, plain, 5)
                f1, r1, r2, f2 = (device_time(f, 5) for f in (fold, rows, rows, fold))
                times[name], timed_by[name] = (k_ms, p_ms), (k_by, p_by)
                bounds[name] = bound(name, BATCH_B * BATCH_N, vd.itemsize, hd.itemsize, m)
                turns[name] = dict(fold_ms=[f1, f2], rows_ms=[r1, r2])
        del a, t, every
        torch.cuda.empty_cache()
    compiled = batched_compiled()
    errs = {name: (max(e[0] for e in v), max(e[1] for e in v)) for name, v in errs.items()}
    emit(phase="batched_fold_kernels", B=BATCH_B, n=BATCH_N, checked_B=BATCHED_FOLD_CHECK_B,
         settings={sfx: dict(vectors=str(vd)[6:], rings=str(hd)[6:], m=m)
                   for sfx, (vd, hd, m) in FOLD_ROWS.items()},
         max_abs_err={n_: e[0] for n_, e in errs.items()},
         max_normwise_err={n_: e[1] for n_, e in errs.items()},
         tol=dict(vec={str(v)[6:]: TOL[(v, "vec")] for v in (torch.float32, torch.float64)},
                  sum={str(v)[6:]: TOL[(v, "sum")] for v in (torch.float32, torch.float64)},
                  products_vs_float64={str(v)[6:]: g for v, g in BATCHED_ROWS_GAP.items()},
                  ring_rows="bit-exact", frozen="bit-exact",
                  vs_fold_form_and_solo_x_g_pg_rings="bit-exact"),
         vs_solo=solo, products_vs_float64=gaps, compiled=len(compiled), forms=forms,
         device_ms={n_: {"kernel": v[0], "plain": v[1], "bound": bounds[n_][0],
                         "share_of_bound": bounds[n_][0] / v[0], **turns[n_]}
                    for n_, v in times.items()},
         timed_by={n_: {"kernel": v[0], "plain": v[1]} for n_, v in timed_by.items()})
    return {"errs": errs, "times": times, "bounds": bounds, "timed_by": timed_by}


#: the iterations of each batched fold path (``phase_batched_fold_paths``)
BATCHED_FOLD_ITERS = 11


def phase_batched_fold_paths() -> dict:
    """``minimize_batched`` at each ``FOLD_ROWS`` setting (f32 vectors over
    an f32 ring at m = 80, f64 over f64 at m = 80, f32 over a bf16 ring at
    m = 260), 1024 x 2^14 from ``batched_x0`` in the vectors' dtype, the
    batched deep phase's plain and OWL-QN settings (uncapped, epsilon 0),
    10 iterations (one warm and one timed run each): K4 b (K14 b under
    OWL-QN) per iteration, every launch in the row-block form
    (``.mma_rows_launches``), K15 b's (K16 b's) M = 0 form, the probes,
    nothing else and no plain version, every fx finite; then instances 0-7
    solo against the batch after 8 iterations (``_vs_solo_8``).  Returns
    each setting's row-block launches under the table's rows."""
    k = rosenbrock.value_and_grad.kernels
    lc_rows = {}
    for sfx, (vd, hd, m) in FOLD_ROWS.items():
        for label, (params, path, init) in BATCHED_DEEP_PARAMS.items():
            params = params.replace(m=m, history_dtype=str(hd)[6:],
                                    max_iterations=BATCHED_FOLD_ITERS)
            fn = k.owlqn_trial_pair_gram_batched if label == "owlqn" else \
                k.trial_pair_gram_batched
            row = BATCHED_FOLD_EPILOGUES[label == "owlqn"] + sfx
            st, walls, lc, pc, reads, iters, x0b = _batched_run(
                f"batched fold {label}{sfx}", params, BATCH_B, BATCH_N, path, init, runs=1,
                dtype=vd)
            if fn.mma_rows_launches != lc[path[1]] or fn.last_form.form != "mma_rows":
                raise AssertionError(f"batched fold {label}{sfx}: {fn.mma_rows_launches} "
                                     f"row-block launches of {lc[path[1]]} epilogues")
            lc_rows[row] = fn.mma_rows_launches
            _batched_report(f"batched_fold_{label}{sfx}", st, walls, lc, reads, iters, path,
                            m=m, vectors=str(vd)[6:], rings=str(hd)[6:], plain_calls=pc,
                            row_block_launches=fn.mma_rows_launches,
                            instances=_vs_solo_8(f"batched fold {label}{sfx}", params, x0b))
            del st, x0b
            torch.cuda.empty_cache()
    return lc_rows


# ---------------------------------------------------------------------------
# the batched runner on generic objectives: K9 b, K11 b and K12 b
# ---------------------------------------------------------------------------

#: the generic kernels' ring depths, and the batch each dtype pair is
#: checked at with m = 80: the timed shape for f32/bf16, fewer instances for
#: the wider rings (a float64 ring of 1024 x 80 x 2^14 is 10.7 GB, and the
#: checks hold three of each)
GENERIC_DEPTHS = (M, DEEP_M)
GENERIC_M80_B = {(torch.float32, torch.bfloat16): BATCH_B, (torch.float32, torch.float32): 512,
                 (torch.float64, torch.float64): 256}
#: K12 b's instantiations: five row counts in each dtype pair
K12B_FORMS = 3 * 5


def batched_generic_inputs(seed: int, vd, hd, m: int, B: int, n: int = BATCH_N) -> dict:
    """Seeded [B, n] inputs of K9 b, K11 b and K12 b (and of K1 b, K7 b and
    K5 b): the points xp and x near the Rosenbrock start with exact zeros
    (every 17th, 13th element), a direction, gradients, a pseudo-gradient,
    [B, m, n] rings and [B] steps; every third instance from the third
    frozen."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=g, device="cuda", dtype=vd)
    live = torch.ones(B, dtype=torch.bool, device="cuda")
    live[2::3] = False
    xp = rosenbrock.initial_point(n, vd, "cuda")[None, :] + 0.1 * r(B, n)
    xp[:, ::17] = 0.0
    x = xp + 0.1 * r(B, n)
    x[:, ::13] = 0.0
    return dict(xp=xp, x=x, d=0.1 * r(B, n), gx=r(B, n), gp=r(B, n), pg=r(B, n),
                S=(0.1 * r(B, m, n)).to(hd), Y=(0.1 * r(B, m, n)).to(hd),
                stp=0.2 + torch.rand(B, generator=g, device="cuda", dtype=vd), live=live)


def _generic_solo(B: int) -> tuple:
    """The instances held to the solo kernels: 0, 511 and 1023 at B = 1024."""
    return (0, B // 2 - 1, B - 1)


def _check_k9b_k11b(a: dict, vd, errs: dict, solo: dict) -> None:
    """K9 b and K11 b on both windows against their plain versions and, on
    the solo instances, the solo K9 (with the search's orthant) and K11
    bit for bit; a frozen instance's row untouched."""
    live, frozen = a["live"], ~a["live"]
    tv = TOL[(vd, "vec")]
    B = live.shape[0]
    tag = str(vd).removeprefix("torch.")
    for lo, hi in windows(BATCH_N):
        cases = (
            ("K9b_owlqn_trial_step_batched", fused.owlqn_trial_step_batched,
             fused.owlqn_trial_step_batched_ref,
             (a["xp"], a["d"], a["pg"], a["stp"], lo, hi, live),
             lambda b: fused.owlqn_trial_step(
                 a["xp"][b], a["d"][b],
                 choose_orthant(Orthantwise(1.0, lo, hi), a["xp"][b], a["pg"][b]),
                 float(a["stp"][b]), lo, hi)),
            ("K11b_pseudo_gradient_batched", fused.pseudo_gradient_batched,
             fused.pseudo_gradient_batched_ref, (a["x"], a["gx"], C_L1, lo, hi, live),
             lambda b: fused.pseudo_gradient(a["x"][b], a["gx"][b], C_L1, lo, hi)),
        )
        for name, kern, plain, args, one in cases:
            out_k, out_p = torch.zeros_like(a["d"]), torch.zeros_like(a["d"])
            kern(*args, out_k)
            plain(*args, out_p)
            errs.setdefault(name, []).append(check(f"{name} {tag}", out_k[live], out_p[live], tv))
            if out_k[frozen].any():
                raise AssertionError(f"{name} {tag}: a frozen instance's row was written")
            for b in _generic_solo(B):
                if not same_bits(out_k[b], one(b)):
                    raise AssertionError(f"{name} {tag}: instance {b} differs from the solo "
                                         f"kernel")
            solo.setdefault(name, {})[tag] = dict(
                vs_plain_bit_for_bit=same_bits(out_k[live], out_p[live]),
                vs_solo_bit_for_bit=list(_generic_solo(B)))


def _check_k12b(a: dict, vd, m: int, errs: dict, solo: dict) -> None:
    """K12 b against its plain version (sums at the sum tolerance, the rings
    bit for bit) and, on the solo instances, the solo K12: ring rows bit for
    bit, the sums within the sum tolerance, each printed with whether it is
    bit for bit (an instance's partials are the solo kernel's; torch adds
    the [B, blocks, 6m] partials in an order that depends on B); a frozen
    instance's rings untouched."""
    live, frozen = a["live"], ~a["live"]
    ts = TOL[(vd, "sum")]
    B, end = live.shape[0], m - 3
    tag = f"{str(vd).removeprefix('torch.')}/{str(a['S'].dtype).removeprefix('torch.')} m={m}"
    name = "K12b_pair_gram_xg_batched" + ("_m80" if m == DEEP_M else "")
    vecs = tuple(a[k] for k in ("x", "xp", "gx", "gp", "pg"))
    Sk, Yk = a["S"].clone(), a["Y"].clone()
    SPk, YPk = fused.pair_gram_xg_batched(*vecs, Sk, Yk, end, live)
    Sp, Yp = a["S"].clone(), a["Y"].clone()
    SPp, YPp = fused.pair_gram_xg_batched_ref(*vecs, Sp, Yp, end, live)
    errs.setdefault(name, []).extend([check(f"{name} SP {tag}", SPk[live], SPp[live], ts),
                                      check(f"{name} YP {tag}", YPk[live], YPp[live], ts)])
    if not (same_bits(Sk, Sp) and same_bits(Yk, Yp)):
        raise AssertionError(f"{name} {tag}: the rings differ from the plain version's")
    del Sp, Yp
    if not (same_bits(Sk[frozen], a["S"][frozen]) and same_bits(Yk[frozen], a["Y"][frozen])):
        raise AssertionError(f"{name} {tag}: a frozen instance's rings were written")
    sums = {}
    for b in _generic_solo(B):
        Sb, Yb = a["S"][b].clone(), a["Y"][b].clone()
        SP1, YP1 = fused.pair_gram_xg(*(v[b] for v in vecs), Sb, Yb, end)
        if not (same_bits(Sk[b], Sb) and same_bits(Yk[b], Yb)):
            raise AssertionError(f"{name} {tag}: instance {b}'s rings differ from the solo K12's")
        e = max(check(f"{name} SP {tag} vs solo {b}", SPk[b], SP1, ts)[1],
                check(f"{name} YP {tag} vs solo {b}", YPk[b], YP1, ts)[1])
        sums[b] = dict(normwise=e, bit_for_bit=same_bits(SPk[b], SP1) and same_bits(YPk[b], YP1))
    solo.setdefault(name, {})[tag] = dict(rings_bit_for_bit=list(_generic_solo(B)), sums=sums)


def _time_generic(a: dict, m: int, times: dict, timed_by: dict, bounds: dict) -> None:
    """Time K12 b (and at m = 6 K9 b and K11 b) on the f32/bf16 inputs ``a``
    with every instance live, each beside its plain version and its
    bound (``kernel_vs_plain``); the rings' row m - 3 is rewritten with the
    same pair on every launch (the checks are done with ``a``)."""
    every = torch.ones(BATCH_B, dtype=torch.bool, device="cuda")
    lo, hi = windows(BATCH_N)[0]
    out = torch.empty_like(a["d"])
    vecs = tuple(a[k] for k in ("x", "xp", "gx", "gp", "pg"))
    S, Y = a["S"], a["Y"]
    cases = {"K12b_pair_gram_xg_batched" + ("_m80" if m == DEEP_M else ""): (
        lambda: fused.pair_gram_xg_batched(*vecs, S, Y, m - 3, every),
        lambda: fused.pair_gram_xg_batched_ref(*vecs, S, Y, m - 3, every))}
    if m == M:
        step = (a["xp"], a["d"], a["pg"], a["stp"], lo, hi, every, out)
        pg = (a["x"], a["gx"], C_L1, lo, hi, every, out)
        cases.update({
            "K9b_owlqn_trial_step_batched": (
                lambda: fused.owlqn_trial_step_batched(*step),
                lambda: fused.owlqn_trial_step_batched_ref(*step)),
            "K11b_pseudo_gradient_batched": (lambda: fused.pseudo_gradient_batched(*pg),
                                             lambda: fused.pseudo_gradient_batched_ref(*pg)),
        })
    for name, (kern, plain) in cases.items():
        k_ms, p_ms, k_by, p_by = kernel_vs_plain(kern, plain, 20)
        times[name], timed_by[name] = (k_ms, p_ms), (k_by, p_by)
        bounds[name] = bound(name, BATCH_B * BATCH_N, 4, 2, m)


def phase_batched_generic_kernels() -> dict:
    """K9 b, K11 b and K12 b (m = 6 and 80) in the three dtype pairs at B =
    1024 x n = 2^14 (m = 80 at ``GENERIC_M80_B``), a third of the instances
    frozen, against their plain versions at the kernel tolerances
    (``TOL``) and, on instances 0, B/2 - 1 and B - 1, against the solo K9,
    K11 and K12: the points, pg and ring rows bit for bit, K12 b's sums
    within the sum tolerance; the registers of every K12 b instantiation
    (a spill fails).  Each form timed at f32/bf16 with every instance live,
    beside its plain version and its bound (``_time_generic``)."""
    errs, solo = {}, {}
    times, timed_by, bounds = {}, {}, {}
    for vd, hd in DTYPES:
        a = batched_generic_inputs(SEED + 18, vd, hd, M, BATCH_B)
        _check_k9b_k11b(a, vd, errs, solo)
        _check_k12b(a, vd, M, errs, solo)
        if hd == torch.bfloat16:
            _time_generic(a, M, times, timed_by, bounds)
        del a
        torch.cuda.empty_cache()
        a = batched_generic_inputs(SEED + 19, vd, hd, DEEP_M, GENERIC_M80_B[(vd, hd)])
        _check_k12b(a, vd, DEEP_M, errs, solo)
        if hd == torch.bfloat16:
            _time_generic(a, DEEP_M, times, timed_by, bounds)
        del a
        torch.cuda.empty_cache()
    forms = [f for f in pair_gram_forms() if f["kernel"] == "K12b"]
    emit(phase="batched_generic_compiled", forms=forms)
    if len(forms) != K12B_FORMS or any("n_regs" not in f or "spill_stores" not in f
                                       for f in forms):
        raise AssertionError(f"the build log shows {len(forms)} of {K12B_FORMS} K12 b "
                             f"instantiations")
    if any(f["spill_stores"] or f["spill_loads"] for f in forms):
        raise AssertionError(f"K12 b instantiations spill registers: {forms}")
    errs = {name: (max(e[0] for e in v), max(e[1] for e in v)) for name, v in errs.items()}
    emit(phase="batched_generic_kernels", B=BATCH_B, n=BATCH_N, m=list(GENERIC_DEPTHS),
         m80_B={"/".join(str(t).removeprefix("torch.") for t in k): v
                for k, v in GENERIC_M80_B.items()},
         max_abs_err={n_: e[0] for n_, e in errs.items()},
         max_normwise_err={n_: e[1] for n_, e in errs.items()},
         tol=dict(TOL={f"{str(k[0]).removeprefix('torch.')} {k[1]}": v for k, v in TOL.items()},
                  rings="bit-exact", frozen="bit-exact",
                  vs_solo_points_pg_rings="bit-exact", vs_solo_sums="sum tolerance"),
         vs_solo=solo,
         device_ms={n_: {"kernel": t[0], "plain": t[1], "bound": bounds[n_][0]}
                    for n_, t in times.items()},
         timed_by={n_: {"kernel": t[0], "plain": t[1]} for n_, t in timed_by.items()})
    return {"errs": errs, "times": times, "bounds": bounds, "timed_by": timed_by}


#: the batched generic main paths: a hook-free Rosenbrock (the plain
#: evaluation of ``rosenbrock``, vmapped) at the batched main path's
#: widths and starts (1024 x 2^14, f32, m = 6, bf16 ring), More-Thuente,
#: epsilon 0, 20 iterations; capped, uncapped and damped capped
BATCHED_GENERIC_PARAMS = BATCHED_PARAMS.replace(max_iterations=21)
BATCHED_GENERIC_RUNS = {
    "capped": BATCHED_GENERIC_PARAMS,
    "uncapped": BATCHED_GENERIC_PARAMS.replace(constrain_step_size=False),
    "damped": BATCHED_GENERIC_PARAMS.replace(damping=True),
}
#: and under OWL-QN (c = 1 on [0, n - 1), Armijo); ``m80`` (5 iterations)
#: gives K12 b's launches at m = 80
BATCHED_GENERIC_OWLQN_PARAMS = BATCHED_GENERIC_PARAMS.replace(
    orthantwise=Orthantwise(1.0, 0, BATCH_N - 1),
).replace_ls(algorithm=LineSearchAlgorithm.BacktrackingArmijo)
BATCHED_GENERIC_OWLQN_RUNS = {
    "capped": BATCHED_GENERIC_OWLQN_PARAMS,
    "uncapped": BATCHED_GENERIC_OWLQN_PARAMS.replace(constrain_step_size=False),
    "damped": BATCHED_GENERIC_OWLQN_PARAMS.replace(damping=True),
    "m80": BATCHED_GENERIC_OWLQN_PARAMS.replace(m=DEEP_M, max_iterations=6),
}


def generic_objective():
    """The Rosenbrock objective without any kernel hook: its plain torch
    evaluation, which the batched runner vmaps (a generic objective)."""
    return rosenbrock._plain_value_and_grad


def _generic_run(name: str, params: LbfgsParams, x0b: torch.Tensor, fn, runs: int) -> tuple:
    """One warm and ``runs`` timed ``minimize_batched`` on the generic
    objective ``fn``, the counts reset before each; returns (state, walls
    in seconds, launches, plain calls, host reads, loop iterations, search
    trips) of the last run.  Every fx finite, the run on the card."""
    minimize_batched(params, x0b, fn)
    torch.cuda.synchronize()
    walls = []
    for _ in range(runs):
        reset_counts()
        out = []
        walls.append(profiling.timed(
            lambda: out.append(minimize_batched(params, x0b, fn, return_state=True)), warmup=0))
    st = out[0]
    lc, pc, reads = launches(), plain_calls(), to_host.reads
    iters = int(st.k.max()) - 1
    if not np.isfinite(st.fx).all():
        raise AssertionError(f"{name}: {int((~np.isfinite(st.fx)).sum())} instances end "
                             f"with a non-finite fx")
    if st.x.device.type != "cuda":
        raise AssertionError(f"{name}: the run left the card")
    # the init's read, one per search trip, one per iteration
    return st, walls, lc, pc, reads, iters, reads - 1 - iters


def _runs_phase(phase: str, runs: dict, expect, fn, timed: int = 2) -> dict:
    """Each of ``runs`` on the objective ``fn`` through ``_generic_run`` from
    ``batched_x0`` (``timed`` timed runs, one where the label is m80), its
    launches held to ``expect(label, iters, trips)`` and nothing else
    launched, no plain version, fx float64 exactly where the wide scalar
    runs over float32 vectors; its line (``_batched_report``; the first
    run's with device ms per iteration and its top device items), then, but
    at m80, instances 0-7 against their solo runs after 8 iterations (the
    same iterations and evaluations, fx rel ``FUSION_TOL_8``).  Returns each
    run's launches."""
    x0b = batched_x0(BATCH_B, BATCH_N)
    lc_all = {}
    for i, (label, params) in enumerate(runs.items()):
        name = f"{phase}_{label}"
        st, walls, lc, pc, reads, iters, trips = _generic_run(
            name, params, x0b, fn, 1 if label == "m80" else timed)
        want = expect(label, iters, trips)
        _expect(name, lc, pc, **want)
        if (st.fx.dtype == np.float64) != (params.fx_wide and x0b.dtype == torch.float32):
            raise AssertionError(f"{name}: fx is {st.fx.dtype}")
        prof = _batched_profile(params, x0b, fn, top=6) if i == 0 else {}
        _batched_report(name, st, walls, lc, reads, iters, tuple(want), m=params.m,
                        probes_per_iter=trips / iters, fx_dtype=str(st.fx.dtype),
                        history=str(st.hist.s.dtype), **prof)
        lc_all[label] = lc
        del st
        if label != "m80":
            emit(phase=f"{name}_vs_solo", iters=8, fx_tol=FUSION_TOL_8,
                 instances=_vs_solo_8(name, params, x0b, fn))
        torch.cuda.empty_cache()
    del x0b
    torch.cuda.empty_cache()
    return lc_all


def phase_batched_generic_main_path() -> dict:
    """``minimize_batched`` on the hook-free Rosenbrock
    (``BATCHED_GENERIC_RUNS``): every trip materializes the trials in torch
    and evaluates the batch with torch.func.vmap, so the run launches K3 b
    once per iteration and no other kernel of the table, no probe kernel
    and no plain version; capped, uncapped (K3 b there too: a generic
    objective has no fusion) and damped capped (the composed damped pair,
    then K3 b).  Instances 0-7 against their solo generic runs after 8
    iterations.  Returns each run's launches."""
    return _runs_phase("batched_generic_main_path", BATCHED_GENERIC_RUNS,
                       lambda label, iters, trips: dict(K3b_combine_batched=iters),
                       generic_objective())


def phase_batched_generic_owlqn_main_path() -> dict:
    """The hook-free Rosenbrock under OWL-QN (``BATCHED_GENERIC_OWLQN_RUNS``):
    K11 b once at the init, K9 b per search trip, K10 b and K13 b per
    iteration, K12 b per iteration undamped and never damped, nothing else
    and no plain version; capped, uncapped, damped capped, and m = 80 for
    K12 b's launches at that depth.  Instances 0-7 against their solo
    generic runs.  Returns each run's launches."""
    def expect(label, iters, trips):
        out = dict(K11b_pseudo_gradient_batched=1, K9b_owlqn_trial_step_batched=trips,
                   K10b_pseudo_gradient_norm_batched=iters, K13b_combine_ow_batched=iters)
        if label != "damped":
            out["K12b_pair_gram_xg_batched"] = iters
        return out

    return _runs_phase("batched_generic_owlqn_main_path", BATCHED_GENERIC_OWLQN_RUNS, expect,
                       generic_objective())


# ---------------------------------------------------------------------------
# the batched runner where no batched epilogue runs: K1 b, K7 b and K5 b
# ---------------------------------------------------------------------------

#: K5 b's instantiations: five row counts in each dtype pair, with and
#: without the . gp column
K5B_FORMS = 3 * 5 * 2
#: the extras case of K1 b and K7 b: the quadratic's two extras at an n off
#: 16, a few instances
TRIAL_EX_B, TRIAL_EX_N = 64, (1 << 14) + 2


def _check_trials_batched(k, a: dict, vd, errs: dict, solo: dict, tag: str) -> None:
    """K1 b and K7 b (on both windows) of the factory kernels ``k`` against
    their plain versions at the kernel tolerances, in both modes of the
    objective scalar; a frozen instance's rows unwritten; their (f, g.d)
    bit for bit K2 b's and K8 b's at the same step (the remat contract;
    float64 under the wide mode); on the solo instances the point and
    gradient bit for bit the solo K1's and K7's (with the search's
    orthant)."""
    live, frozen = a["live"], ~a["live"]
    tv, ts = TOL[(vd, "vec")], TOL[(vd, "sum")]
    n = a["xp"].shape[1]
    rows = _generic_solo(live.shape[0])
    cases = [("K1b_trial_batched", k.trial_batched, k.trial_batched_ref, k.probe_batched,
              (a["xp"], a["d"], a["stp"], live),
              lambda b: k.trial(a["xp"][b], a["d"][b], float(a["stp"][b])))]
    for lo, hi in windows(n):
        cases.append((
            "K7b_owlqn_trial_batched", k.owlqn_trial_batched, k.owlqn_trial_batched_ref,
            k.owlqn_probe_pg_batched, (a["xp"], a["d"], a["pg"], a["stp"], C_L1, lo, hi, live),
            lambda b, lo=lo, hi=hi: k.owlqn_trial(
                a["xp"][b], a["d"][b],
                choose_orthant(Orthantwise(1.0, lo, hi), a["xp"][b], a["pg"][b]),
                float(a["stp"][b]), C_L1, lo, hi)))
    for wide in (False, True):
        with fused.wide_fx(wide):
            for name, kern, plain, probe, args, one in cases:
                t = f"{name} {tag}{' wide' if wide else ''}"
                xk, gk, xq, gq = (torch.zeros_like(a["xp"]) for _ in range(4))
                sk, sq = kern(*args, xk, gk), plain(*args, xq, gq)
                e = [check(f"{t} x", xk[live], xq[live], tv),
                     check(f"{t} g", gk[live], gq[live], tv)]
                e += [check(f"{t} sum{i}", sk[i][live], sq[i][live], ts)
                      for i in range(len(sk) - 1)]
                errs.setdefault(name, []).extend(e)
                if not torch.equal(sk[-1][live], sq[-1][live]):
                    raise AssertionError(f"{t}: changed differs from the plain version")
                if xk[frozen].any() or gk[frozen].any():
                    raise AssertionError(f"{t}: a frozen instance's rows were written")
                if wide and vd == torch.float32 and sk[0].dtype != torch.float64:
                    raise AssertionError(f"{t}: fx is {sk[0].dtype} under the wide mode")
                pf, pd = probe(*args)
                remat = same_bits(sk[0][live], pf[live]) and same_bits(sk[1][live], pd[live])
                if not remat:
                    raise AssertionError(f"{t}: (f, g.d) differ from the batched probe's")
                for b in rows:
                    so = one(b)
                    if not (same_bits(xk[b], so[0]) and same_bits(gk[b], so[2])):
                        raise AssertionError(f"{t}: instance {b} differs from the solo kernel")
                solo.setdefault(name, {})[t] = dict(
                    vs_solo_x_g_bit_for_bit=list(rows), probe_sums_bit_for_bit=remat)


def _check_k5b(a: dict, vd, errs: dict, solo: dict) -> None:
    """K5 b with and without its . gp column against its plain version
    (sums at the sum tolerance, the rings bit for bit), the . gp launch's
    columns 0-2 and rings bit for bit the 3-column launch's; on the solo
    instances the solo K5's rings bit for bit and sums within the sum
    tolerance; a frozen instance's rings untouched."""
    live, frozen = a["live"], ~a["live"]
    ts = TOL[(vd, "sum")]
    end = M - 3
    tag = f"{str(vd).removeprefix('torch.')}/{str(a['S'].dtype).removeprefix('torch.')}"
    vecs = (a["stp"], a["d"], a["gx"], a["gp"])
    out = {}
    for with_gp in (False, True):
        name = "K5b_pair_gram_batched" + ("_gp" if with_gp else "")
        Sk, Yk, Sp, Yp = (a[r].clone() for r in ("S", "Y", "S", "Y"))
        SPk, YPk = fused.pair_gram_sd_batched(*vecs, Sk, Yk, end, live, with_gp=with_gp)
        SPp, YPp = fused.pair_gram_sd_batched_ref(*vecs, Sp, Yp, end, live, with_gp=with_gp)
        errs.setdefault(name, []).extend([check(f"{name} SP {tag}", SPk[live], SPp[live], ts),
                                          check(f"{name} YP {tag}", YPk[live], YPp[live], ts)])
        if not (same_bits(Sk, Sp) and same_bits(Yk, Yp)):
            raise AssertionError(f"{name} {tag}: the rings differ from the plain version's")
        if not (same_bits(Sk[frozen], a["S"][frozen]) and same_bits(Yk[frozen], a["Y"][frozen])):
            raise AssertionError(f"{name} {tag}: a frozen instance's rings were written")
        sums = {}
        for b in _generic_solo(live.shape[0]):
            Sb, Yb = a["S"][b].clone(), a["Y"][b].clone()
            SP1, YP1 = fused.pair_gram_sd(float(a["stp"][b]), *(v[b] for v in vecs[1:]), Sb, Yb,
                                          end, with_gp=with_gp)
            if not (same_bits(Sk[b], Sb) and same_bits(Yk[b], Yb)):
                raise AssertionError(f"{name} {tag}: instance {b}'s rings differ from the solo "
                                     f"K5's")
            e = max(check(f"{name} SP {tag} vs solo {b}", SPk[b], SP1, ts)[1],
                    check(f"{name} YP {tag} vs solo {b}", YPk[b], YP1, ts)[1])
            sums[b] = dict(normwise=e, bit_for_bit=same_bits(SPk[b], SP1)
                           and same_bits(YPk[b], YP1))
        solo.setdefault(name, {})[tag] = dict(rings_bit_for_bit=True, sums=sums)
        out[with_gp] = (SPk, YPk, Sk, Yk)
        del Sp, Yp, SPp, YPp
    (SP3, YP3, S3, Y3), (SPg, YPg, Sg, Yg) = out[False], out[True]
    if not (same_bits(SPg[live][..., :3], SP3[live]) and same_bits(YPg[live][..., :3], YP3[live])
            and same_bits(S3, Sg) and same_bits(Y3, Yg)):
        raise AssertionError(f"K5b {tag}: the . gp launch's columns 0-2 or rings differ from "
                             f"the 3-column launch's")


def _time_trials(a: dict, times: dict, timed_by: dict, bounds: dict) -> None:
    """Time K1 b, K7 b (the main path's window) and K5 b with and without
    its . gp column on the f32/bf16 inputs ``a`` with every instance live,
    each beside its plain version and its bound."""
    k = rosenbrock.value_and_grad.kernels
    every = torch.ones(BATCH_B, dtype=torch.bool, device="cuda")
    lo, hi = windows(BATCH_N)[0]
    xt, g = torch.empty_like(a["xp"]), torch.empty_like(a["xp"])
    t1 = (a["xp"], a["d"], a["stp"], every, xt, g)
    t7 = (a["xp"], a["d"], a["pg"], a["stp"], C_L1, lo, hi, every, xt, g)
    pair = (a["stp"], a["d"], a["gx"], a["gp"], a["S"], a["Y"], M - 3, every)
    cases = {
        "K1b_trial_batched": (lambda: k.trial_batched(*t1), lambda: k.trial_batched_ref(*t1)),
        "K7b_owlqn_trial_batched": (lambda: k.owlqn_trial_batched(*t7),
                                    lambda: k.owlqn_trial_batched_ref(*t7)),
        "K5b_pair_gram_batched": (lambda: fused.pair_gram_sd_batched(*pair),
                                  lambda: fused.pair_gram_sd_batched_ref(*pair)),
        "K5b_pair_gram_batched_gp": (
            lambda: fused.pair_gram_sd_batched(*pair, with_gp=True),
            lambda: fused.pair_gram_sd_batched_ref(*pair, with_gp=True)),
    }
    for name, (kern, plain) in cases.items():
        k_ms, p_ms, k_by, p_by = kernel_vs_plain(kern, plain, 20)
        times[name], timed_by[name] = (k_ms, p_ms), (k_by, p_by)
        bounds[name] = bound(name, BATCH_B * BATCH_N, 4, 2, M)


def phase_batched_trial_kernels() -> dict:
    """K1 b, K7 b and K5 b (with and without its . gp column) in f32/bf16
    and f64/f64 at B = 1024 x n = 2^14, m = 6, a third of the instances
    frozen, against their plain versions at the kernel tolerances
    (``TOL``; both modes of the objective scalar for K1 b and K7 b) and, on
    instances 0, 511 and 1023, against the solo K1, K7 and K5: points,
    gradients and ring rows bit for bit, K5 b's sums within the sum
    tolerance; K1 b's and K7 b's (f, g.d) bit for bit K2 b's and K8 b's
    (the remat contract); K5 b's . gp columns 0-2 bit for bit its 3-column
    launch's.  Then K1 b and K7 b with the quadratic's two extras at n =
    2^14 + 2 (``TRIAL_EX_N``, off 16) the same way.  The registers and
    spills of every K1 b, K7 b and K5 b form (a spill fails).  Each form
    timed at f32/bf16 with every instance live, beside its plain version
    and its bound."""
    k = rosenbrock.value_and_grad.kernels
    errs, solo = {}, {}
    times, timed_by, bounds = {}, {}, {}
    for vd, hd in (DTYPES[0], DTYPES[2]):
        a = batched_generic_inputs(SEED + 20, vd, hd, M, BATCH_B)
        tag = str(vd).removeprefix("torch.")
        _check_trials_batched(k, a, vd, errs, solo, tag)
        _check_k5b(a, vd, errs, solo)
        if hd == torch.bfloat16:
            _time_trials(a, times, timed_by, bounds)
        del a
        torch.cuda.empty_cache()
    # the extras: the quadratic's weights and targets, n off 16
    g = torch.Generator(device="cuda").manual_seed(SEED + 21)
    w = 0.5 + torch.rand(TRIAL_EX_N, generator=g, device="cuda")
    t = torch.randn(TRIAL_EX_N, generator=g, device="cuda")
    q = separable.quadratic(w, t).kernels
    a = batched_generic_inputs(SEED + 22, torch.float32, torch.bfloat16, M, TRIAL_EX_B,
                               TRIAL_EX_N)
    ex_errs = {}
    _check_trials_batched(q, a, torch.float32, ex_errs, solo, f"float32 extras n={TRIAL_EX_N}")
    for name, v in ex_errs.items():
        errs[name].extend(v)
    del a
    compiled = []
    for label, fn in (("K1b", k.trial_batched), ("K7b", k.owlqn_trial_batched),
                      ("K1b extras", q.trial_batched), ("K7b extras", q.owlqn_trial_batched)):
        for vd, ck in fn.compiled.items():
            compiled.append(dict(kernel=label, vectors=str(vd), **_compiled_info(ck)))
    k5b = [f for f in pair_gram_forms() if f["kernel"] == "K5b"]
    emit(phase="batched_trial_compiled", triton=compiled, k5b=k5b)
    if len(compiled) != 6 or any(c["n_spills"] for c in compiled):
        raise AssertionError(f"K1 b / K7 b forms: {compiled}")
    if len(k5b) != K5B_FORMS or any("n_regs" not in f or f["spill_stores"] or f["spill_loads"]
                                    for f in k5b):
        raise AssertionError(f"K5 b instantiations ({len(k5b)} of {K5B_FORMS}): {k5b}")
    errs = {name: (max(e[0] for e in v), max(e[1] for e in v)) for name, v in errs.items()}
    emit(phase="batched_trial_kernels", B=BATCH_B, n=BATCH_N, m=M,
         extras=dict(B=TRIAL_EX_B, n=TRIAL_EX_N),
         max_abs_err={n_: e[0] for n_, e in errs.items()},
         max_normwise_err={n_: e[1] for n_, e in errs.items()},
         tol=dict(TOL={f"{str(k_[0]).removeprefix('torch.')} {k_[1]}": v
                       for k_, v in TOL.items()},
                  rings="bit-exact", frozen="bit-exact", vs_solo_points_rings="bit-exact",
                  probe_sums="bit-exact", vs_solo_sums="sum tolerance"),
         vs_solo=solo,
         device_ms={n_: {"kernel": t_[0], "plain": t_[1], "bound": bounds[n_][0]}
                    for n_, t_ in times.items()},
         timed_by={n_: {"kernel": t_[0], "plain": t_[1]} for n_, t_ in timed_by.items()})
    torch.cuda.empty_cache()
    return {"errs": errs, "times": times, "bounds": bounds, "timed_by": timed_by}


#: the batched settings' main paths: the batched main path's widths and
#: starts (1024 x 2^14, f32, m = 6, bf16 ring unless a float16 one), 20
#: iterations at epsilon 0; More-Thuente, and under OWL-QN c = 1 on
#: [0, n - 1) with Armijo
BATCHED_SETTINGS_PARAMS = BATCHED_PARAMS.replace(max_iterations=21)
BATCHED_SETTINGS_OWLQN_PARAMS = BATCHED_OWLQN_PARAMS.replace(max_iterations=21)
#: the wide scalar (``fx_wide``): plain capped and uncapped, OWL-QN capped,
#: damped capped
BATCHED_WIDE_RUNS = {
    "capped": BATCHED_SETTINGS_PARAMS.replace(fx_wide=True),
    "uncapped": BATCHED_SETTINGS_PARAMS.replace(fx_wide=True, constrain_step_size=False),
    "owlqn": BATCHED_SETTINGS_OWLQN_PARAMS.replace(fx_wide=True),
    "damped": BATCHED_SETTINGS_PARAMS.replace(fx_wide=True, damping=True),
}
#: the scan two-loop and a float16 ring, plain and OWL-QN
BATCHED_SCAN_RUNS = {
    "plain": BATCHED_SETTINGS_PARAMS.replace(compact_two_loop=False),
    "owlqn": BATCHED_SETTINGS_OWLQN_PARAMS.replace(compact_two_loop=False),
}
BATCHED_F16_RUNS = {
    "plain": BATCHED_SETTINGS_PARAMS.replace(history_dtype="float16"),
    "owlqn": BATCHED_SETTINGS_OWLQN_PARAMS.replace(history_dtype="float16"),
}
#: the trial-only objective (``trial_only_objective``): plain, damped,
#: OWL-QN and damped OWL-QN, capped
BATCHED_TRIAL_RUNS = {
    "plain": BATCHED_SETTINGS_PARAMS,
    "damped": BATCHED_SETTINGS_PARAMS.replace(damping=True),
    "owlqn": BATCHED_SETTINGS_OWLQN_PARAMS,
    "owlqn_damped": BATCHED_SETTINGS_OWLQN_PARAMS.replace(damping=True),
}


def phase_batched_wide_main_path() -> dict:
    """The batched runner under the wide objective scalar
    (``BATCHED_WIDE_RUNS``): fx float64 [B]; the init one K1 b at stp = 0
    (under OWL-QN one K7 b with the identity projection and one K10 b),
    then the epilogue route per iteration (K2 b or K8 b per trip, K4 b and
    K3 b; uncapped K15 b; OWL-QN K14 b and K13 b; damped K4 b's . gp form
    and K6 b), each summing its objective column in float64 per
    instance."""
    def expect(label, iters, trips):
        if label == "owlqn":
            return dict(K7b_owlqn_trial_batched=1, K10b_pseudo_gradient_norm_batched=1,
                        K8b_owlqn_probe_batched=trips,
                        K14b_owlqn_trial_pair_gram_batched=iters, K13b_combine_ow_batched=iters)
        out = dict(K1b_trial_batched=1, K2b_probe_batched=trips)
        out.update({"capped": dict(K4b_trial_pair_gram_batched=iters, K3b_combine_batched=iters),
                    "uncapped": dict(K4b_trial_pair_gram_batched=iters,
                                     K15b_combine_probe_batched=iters),
                    "damped": dict(K4b_trial_pair_gram_batched_gp=iters,
                                   K6b_combine_fix_batched=iters)}[label])
        return out

    return _runs_phase("batched_wide_main_path", BATCHED_WIDE_RUNS, expect, default_evaluate(), 1)


def _materialized(label: str, iters: int, trips: int) -> dict:
    """The scan's and the float16 ring's launches: per trip K2 b (K8 b), per
    iteration one K1 b (K7 b and K10 b), the default OWL-QN init's K10 b,
    and no ring kernel: the recursion, the pair + Gram pass and the combine
    run in torch ops."""
    if label == "owlqn":
        return dict(K8b_owlqn_probe_batched=trips, K7b_owlqn_trial_batched=iters,
                    K10b_pseudo_gradient_norm_batched=1 + iters)
    return dict(K2b_probe_batched=trips, K1b_trial_batched=iters)


def phase_batched_scan_main_path() -> dict:
    """The batched runner with the scan two-loop (``BATCHED_SCAN_RUNS``):
    each iteration materializes the accepted points with one K1 b (K7 b),
    writes the composed pair into the ring and runs the literal recursion
    in torch ops (``solver.two_loop_scan_batched``), no ring kernel."""
    return _runs_phase("batched_scan_main_path", BATCHED_SCAN_RUNS, _materialized,
                       default_evaluate(), 1)


def phase_batched_float16_main_path() -> dict:
    """The batched runner over a float16 ring (``BATCHED_F16_RUNS``): one K1
    b (K7 b) per iteration, then the composed pair + Gram pass and combine
    in torch ops, as the JAX package runs jnp there."""
    return _runs_phase("batched_float16_main_path", BATCHED_F16_RUNS, _materialized,
                       default_evaluate(), 1)


def phase_batched_trial_route_main_path() -> dict:
    """The batched runner on the trial-only objective (``BATCHED_TRIAL_RUNS``,
    ``trial_only_objective``): per trip K2 b (K8 b), per iteration one K1 b
    and K5 b and K3 b, damped K5 b's . gp form and K6 b; under OWL-QN K11 b
    at the init, per iteration K7 b, K10 b, K12 b (the composed pair
    damped) and K13 b; never K4 b or K14 b."""
    def expect(label, iters, trips):
        if label.startswith("owlqn"):
            out = dict(K11b_pseudo_gradient_batched=1, K8b_owlqn_probe_batched=trips,
                       K7b_owlqn_trial_batched=iters, K10b_pseudo_gradient_norm_batched=iters,
                       K13b_combine_ow_batched=iters)
            if label == "owlqn":
                out["K12b_pair_gram_xg_batched"] = iters
            return out
        if label == "damped":
            return dict(K2b_probe_batched=trips, K1b_trial_batched=iters,
                        K5b_pair_gram_batched_gp=iters, K6b_combine_fix_batched=iters)
        return dict(K2b_probe_batched=trips, K1b_trial_batched=iters,
                    K5b_pair_gram_batched=iters, K3b_combine_batched=iters)

    return _runs_phase("batched_trial_route_main_path", BATCHED_TRIAL_RUNS, expect,
                       trial_only_objective(), 1)


#: the batched Poisson regression: instances of the Poisson main path's
#: fit over one 2048 x 2^20 float32 X, instance 0 from beta0 = 0 and the
#: others from seeded N(0, 1e-3) offsets, 20 iterations
BATCHED_POISSON_B = 16
BATCHED_POISSON_ITERS = 20


def phase_batched_poisson(data: dict) -> dict:
    """The full-width path: the L1 Poisson regression batched at
    ``bench_logistic.py``'s at-scale width (2048 x 2^20, X float32, the X
    of the Poisson main path, freed here), c = 1 on [1, n), m = 6, bf16
    ring, Armijo, epsilon 0, the step uncapped as the solo Poisson main
    path runs it (``poisson_params``), B = 16, 20 iterations: K11 b once,
    K9 b per trip, K10 b, K12 b and K13 b per iteration, nothing else and
    no plain version (the objective's two products with X are torch
    GEMMs under the vmap); every fx finite and 0 < nnz < n - 1 per
    instance.  Prints device and wall ms per iteration, evaluations per
    iteration and instance-iterations/s.  Then instance 0 against the solo
    Poisson run after 8 iterations: the same iterations and evaluations, fx
    rel ``FUSION_TOL_8``.  Returns the run's launches."""
    X, y, obj = data.pop("X"), data.pop("y"), data.pop("obj")
    n = POISSON_NCOL
    rng = np.random.RandomState(0)
    x0b = torch.zeros(BATCHED_POISSON_B, n, device="cuda")
    x0b[1:] = torch.from_numpy(1e-3 * rng.randn(BATCHED_POISSON_B - 1, n).astype(np.float32))
    params = poisson_params(False, BATCHED_POISSON_ITERS)
    minimize_batched(poisson_params(False, 2), x0b, obj)  # warm
    reset_counts()
    out = []
    dt = profiling.timed(lambda: out.append(minimize_batched(params, x0b, obj,
                                                             return_state=True)), warmup=0)
    st = out[0]
    lc, pc, reads = launches(), plain_calls(), to_host.reads
    iters = int(st.k.max()) - 1
    trips = reads - 1 - iters
    _expect("batched Poisson", lc, pc, K11b_pseudo_gradient_batched=1,
            K9b_owlqn_trial_step_batched=trips, K10b_pseudo_gradient_norm_batched=iters,
            K12b_pair_gram_xg_batched=iters, K13b_combine_ow_batched=iters)
    nnz = (st.x[:, 1:] != 0).sum(dim=1).cpu().numpy()
    if not (np.isfinite(st.fx).all() and np.all((0 < nnz) & (nnz < n - 1))):
        raise AssertionError(f"batched Poisson: fx {st.fx}, nonzero coefficients {nnz}")
    prof = _batched_profile(params, x0b, obj, top=6)
    inst_iters = int((st.k - 1).sum())
    evals = st.neval - 1
    # instance 0 against the solo Poisson run
    p8 = poisson_params(False, 8)
    st8 = minimize_batched(p8, x0b, obj, return_state=True)
    so = minimize_jit(p8, x0b[0].clone(), obj, return_state=True)
    rel = abs(float(st8.fx[0]) / float(so.prob.fx) - 1)
    if (so.k, so.prob.neval) != (int(st8.k[0]), int(st8.neval[0])) or not rel <= FUSION_TOL_8:
        raise AssertionError(f"batched Poisson instance 0 against its solo run after 8 "
                             f"iterations: k/neval {(int(st8.k[0]), int(st8.neval[0]))} vs "
                             f"{(so.k, so.prob.neval)}, rel fx {rel:.3e}")
    emit(phase="batched_poisson", B=BATCHED_POISSON_B, nrow=POISSON_NROW, ncol=n, iters=iters,
         instance_iters=inst_iters, seconds=dt, instance_iters_per_s=inst_iters / dt,
         wall_ms_per_iter=1e3 * dt / iters, **prof, syncs_per_iter=reads / iters,
         trips_per_iter=trips / iters, evals_per_iter=float(evals.mean()) / iters,
         evals_per_instance=evals.tolist(), status={int(c): int(v) for c, v in zip(
             *np.unique(st.status, return_counts=True))},
         fx=st.fx.tolist(), nnz=nnz.tolist(), launches=lc,
         vs_solo=dict(iters=8, k=so.k, neval=so.prob.neval, rel_fx=rel, fx_tol=FUSION_TOL_8))
    del st, st8, so, x0b, X, y, obj
    torch.cuda.empty_cache()
    return lc



# ---------------------------------------------------------------------------
# sharding (parallel): the main paths on a mesh
# ---------------------------------------------------------------------------

#: the sharded phases' paths: the main path, the OWL-QN main path and
#: the damped main path (n = 2^24 in all), and the kernels each must
#: launch on the card
SHARDED_PATHS = {
    "main_path": (MAIN_PARAMS, PLAIN_PATH),
    "owlqn_main_path": (OWLQN_PARAMS, ("K1_trial", "K8_owlqn_probe",
                                       "K10_pseudo_gradient_norm",
                                       "K14_owlqn_trial_pair_gram", "K16_combine_ow_probe")),
    "damped_main_path": (DAMPED_PARAMS, ("K1_trial", "K2_probe") + DAMPED_PATH),
}
#: seconds a two-rank job may take before its ranks are killed
SHARDED_TIMEOUT = 300
#: sharded_world1's timed runs of each path: solo (s) and mesh (m) in turns
WORLD1_TURNS = "smmssmms"
#: the mesh forms' scalars against the single-process launch's
#: (tests/test_kernels_mesh.py's bounds): rel on objective values and
#: squared norms, rel with abs on directional products, rtol with atol on
#: the Gram products, and equality on ``changed``
MESH_NORM, MESH_DOT, MESH_GRAM, MESH_EQUAL = (1e-5, 0.0), (1e-4, 1e-2), (2e-4, 1e-2), (0.0, 0.0)


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _sharded_run(mesh, params: LbfgsParams, x0: torch.Tensor) -> tuple:
    """One ``minimize_jit`` of this rank's shard of x0 under
    ``kernels_on_mesh``, after which the counts are read: (state, seconds,
    launches, plain calls, host reads, collectives)."""
    xs = shard_vector(x0, mesh)
    torch.cuda.synchronize()
    reset_counts()
    mesh.reset_counts()
    out = []
    with kernels_on_mesh(mesh):
        dt = profiling.timed(lambda: out.append(
            minimize_jit(params, xs, default_evaluate(), return_state=True)), warmup=0)
    if mesh.gathers:
        raise AssertionError(f"{mesh.gathers} vector gathers inside a sharded run")
    return out[0], dt, launches(), plain_calls(), to_host.reads, mesh.collectives


def _allreduce_ms(mesh, params: LbfgsParams, x0: torch.Tensor) -> float:
    """All-reduce ms per iteration of one more run, each of the mesh's
    collectives timed between two synchronisations of the card (a wrapper
    around ``mesh.all_reduce`` for this run only)."""
    xs = shard_vector(x0, mesh)
    spent, reduce = [], mesh.all_reduce

    def timed_reduce(t):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        reduce(t)
        torch.cuda.synchronize()
        spent.append(time.perf_counter() - t0)
        return t

    mesh.all_reduce = timed_reduce
    try:
        with kernels_on_mesh(mesh):
            st = minimize_jit(params, xs, default_evaluate(), return_state=True)
    finally:
        del mesh.all_reduce
    return 1e3 * sum(spent) / (st.k - 1)


def _median(v: list) -> float:
    return float(np.median(v))


def _collective_probe(mesh) -> dict:
    """Where one all-reduce of a launch's few scalars spends its time, in
    microseconds per call (medians of 200): two synchronisations of the
    card with nothing between them; ``dist.all_reduce`` of 5 float32
    values between two synchronisations; the same call's host time alone
    (its enqueue); ``mesh_sum`` of five 0-d scalars (pack, one
    all-reduce, unpack) between two synchronisations; and torch.profiler
    traces of 20 ``dist.all_reduce`` and of 20 ``mesh_sum`` calls: host
    and device microseconds per call of their operators and kernels."""
    t = torch.zeros(5, device="cuda")
    vals = [torch.zeros((), device="cuda") for _ in range(5)]

    def per_call(fn, sync: bool, reps: int = 200) -> float:
        got = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            if sync:
                torch.cuda.synchronize()
            got.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
        return 1e6 * _median(got)

    out = dict(
        sync_pair_us=per_call(lambda: None, True),
        all_reduce_us=per_call(lambda: dist.all_reduce(t, group=mesh.group), True),
        all_reduce_enqueue_us=per_call(lambda: dist.all_reduce(t, group=mesh.group), False))
    with kernels_on_mesh(mesh):
        out["mesh_sum_us"] = per_call(lambda: fused.mesh_sum(*vals), True)
    with profiling.trace() as prof:
        for _ in range(20):
            dist.all_reduce(t, group=mesh.group)
        torch.cuda.synchronize()
    rows = sorted(averages(prof), key=lambda e: -(e.cpu_time_total + e.device_time_total))
    out["all_reduce_profile_per_call"] = [
        dict(name=e.key[:60], count=e.count, host_us=e.cpu_time_total / 20,
             device_us=e.device_time_total / 20) for e in rows[:8]]
    with kernels_on_mesh(mesh), profiling.trace() as prof:
        for _ in range(20):
            fused.mesh_sum(*vals)
        torch.cuda.synchronize()
    rows = sorted(averages(prof), key=lambda e: -(e.cpu_time_total + e.device_time_total))
    out["mesh_sum_profile_per_call"] = [
        dict(name=e.key[:60], count=e.count, host_us=e.cpu_time_total / 20,
             device_us=e.device_time_total / 20) for e in rows[:10]]
    return out


def _expect_on_card(name: str, lc: dict, pc: dict, kernels: tuple) -> None:
    if min(lc[k] for k in kernels) == 0 or max(pc.values()) != 0:
        raise AssertionError(f"{name} did not run on the kernels: {lc} {pc}")


#: the early runs of each sharded path: its first 8 iterations at epsilon
#: 0 in float32 (its own settings) and in float64 (float64 vectors and
#: ring), the latter held to the solo run at the f64 tests' rel 1e-9
EARLY_DTYPES = {"f32": torch.float32, "f64": torch.float64}
EARLY_F64_REL = 1e-9


def _early(params: LbfgsParams, dtype: torch.dtype) -> LbfgsParams:
    """A path's first 8 iterations at epsilon 0 (the horizon over which
    another summation order keeps the same steps in float32,
    ``FUSION_TOL_8``), with a float64 ring for float64 vectors."""
    p = params.replace(epsilon=0.0, max_iterations=9)
    return p if dtype == torch.float32 else p.replace(history_dtype=None)


def _early_runs(params: LbfgsParams, mesh=None) -> dict:
    """k, evaluations and fx of ``_early`` in each of ``EARLY_DTYPES`` from
    Rosenbrock's start at n = 2^24, solo or (given ``mesh``) sharded."""
    out = {}
    for key, dt in EARLY_DTYPES.items():
        x0 = rosenbrock.initial_point(N_BIG, dt, "cuda")
        p = _early(params, dt)
        st = (minimize_jit(p, x0, default_evaluate(), return_state=True) if mesh is None
              else _sharded_run(mesh, p, x0)[0])
        out[key] = dict(k=st.k, neval=st.prob.neval, fx=float(st.prob.fx))
        del st, x0
        torch.cuda.empty_cache()
    return out


#: the generic objectives' sharded paths, under the local contract
#: (``parallel.local_objective``: the objective gets the rank's shard and
#: returns the whole fx and the shard's gradient): the generic Rosenbrock
#: at n = 2^24 (f32, bf16 ring, More-Thuente, the step capped, 40
#: iterations: K3 per iteration), the same damped for 20 (the composed
#: damped branch: ``update_pair``, then K3) and the Poisson regression at
#: its at-scale width (2048 x 2^20, X float32 from seed 0, c = 1 on [1, n),
#: Armijo, m = 6, bf16 ring, 20 iterations: K11 once, K9 per trip, K10, K12
#: and K13 per iteration); name -> (params, model, the kernels it launches)
GENERIC_SHARDED = {
    "generic_rosenbrock": (MAIN_PARAMS.replace(constrain_step_size=True, max_iterations=41),
                           "rosenbrock", ("K3_combine",)),
    "generic_rosenbrock_damped": (MAIN_PARAMS.replace(constrain_step_size=True, damping=True,
                                                      max_iterations=21),
                                  "rosenbrock", ("K3_combine",)),
    "generic_poisson": (poisson_params(False, 20), "poisson",
                        ("K9_owlqn_trial_step", "K10_pseudo_gradient_norm",
                         "K11_pseudo_gradient", "K12_pair_gram_xg", "K13_combine_ow")),
}


def generic_collectives(params: LbfgsParams, k: int, neval: int) -> int:
    """The collectives of a generic objective's run, as
    ``tests/test_torch_sharded_generic.py`` pins them: two at the init
    (three under OWL-QN), per search trip the objective's all-reduce and
    g.d (and under OWL-QN the L1 term), per iteration the point's norms,
    the pair + Gram pass and the combine (and under OWL-QN K10, damped
    ``update_pair``'s products).  A run whose last search failed may take
    another count at its end."""
    ow, damped = params.orthantwise is not None, bool(params.damping)
    return 2 + ow + (2 + ow) * (neval - 1) + (3 + ow + damped) * (k - 1)


def generic_problem(model: str, dtype: torch.dtype, mesh=None) -> tuple:
    """(objective, whole x0) of a generic sharded path in ``dtype``: the
    generic Rosenbrock at n = 2^24, or the Poisson regression over X made
    on the card in float32 from seed 0, on a mesh cut to this rank's column
    block (``shard_vector``; the whole X freed) and then widened to
    ``dtype``."""
    if model == "rosenbrock":
        return rosenbrock.generic_value_and_grad, rosenbrock.initial_point(N_BIG, dtype, "cuda")
    X, y = logistic.synthetic(POISSON_NROW, POISSON_NCOL, seed=0, device="cuda")
    if mesh is not None:
        Xb = shard_vector(X, mesh)
        del X
        torch.cuda.empty_cache()
        X = Xb
    obj = logistic.make_objective(X.to(dtype), y.to(dtype))
    del X
    torch.cuda.empty_cache()
    return obj, torch.zeros(POISSON_NCOL, dtype=dtype, device="cuda")


def _generic_sharded_run(params: LbfgsParams, obj, x0: torch.Tensor, mesh=None) -> tuple:
    """One ``minimize_jit`` of a generic objective, solo or (given ``mesh``)
    on this rank's shard of x0: (state, seconds, launches, plain calls,
    collectives past the init, gathers)."""
    xs = x0 if mesh is None else shard_vector(x0, mesh)
    torch.cuda.synchronize()
    reset_counts()
    out = []
    with nullcontext() if mesh is None else kernels_on_mesh(mesh):
        if mesh is not None:
            mesh.reset_counts()
        dt = profiling.timed(lambda: out.append(minimize_jit(params, xs, obj,
                                                             return_state=True)), warmup=0)
    coll = gathers = 0
    if mesh is not None:
        coll, gathers = mesh.collectives, mesh.gathers
        if gathers:
            raise AssertionError(f"{gathers} vector gathers inside a sharded run")
    return out[0], dt, launches(), plain_calls(), coll, gathers


def _early_generic(params: LbfgsParams, model: str, mesh=None) -> dict:
    """k, evaluations and fx of a generic path's first 8 iterations at
    epsilon 0 in float64 (float64 vectors and ring), solo or sharded."""
    obj, x0 = generic_problem(model, torch.float64, mesh)
    st = _generic_sharded_run(_early(params, torch.float64), obj, x0, mesh)[0]
    out = dict(k=st.k, neval=st.prob.neval, fx=float(st.prob.fx))
    del obj, x0, st
    torch.cuda.empty_cache()
    return out


def _generic_world1(mesh) -> dict:
    """``GENERIC_SHARDED`` on the world-size-1 mesh, each path once solo and
    once sharded from the same x0 and data: k, evaluations, fx and x bit for
    bit, the same launches, no plain version, the kernels launched, and the
    collectives per iteration the formula's (``generic_collectives``).
    Returns each path's solo run (iterations, evaluations, fx)."""
    out = {}
    for name, (params, model, kernels) in GENERIC_SHARDED.items():
        obj, x0 = generic_problem(model, torch.float32)
        st_s, dt_s, lc_s, pc_s, _, _ = _generic_sharded_run(params, obj, x0)
        if model == "poisson":
            del obj
            torch.cuda.empty_cache()
            obj, _ = generic_problem(model, torch.float32, mesh)
        st_m, dt_m, lc_m, pc_m, coll, _ = _generic_sharded_run(params, obj, x0, mesh)
        same = (st_s.k == st_m.k and st_s.prob.neval == st_m.prob.neval
                and _bits(np.asarray(st_s.prob.fx)) == _bits(np.asarray(st_m.prob.fx))
                and _bits(st_s.prob.x) == _bits(st_m.prob.x))
        if not same or lc_s != lc_m:
            raise AssertionError(
                f"sharded_world1 {name}: k/neval/fx {st_m.k}/{st_m.prob.neval}/{st_m.prob.fx} "
                f"against {st_s.k}/{st_s.prob.neval}/{st_s.prob.fx}, launches {lc_m} against "
                f"{lc_s}")
        _expect_on_card(f"sharded_world1 {name} (solo)", lc_s, pc_s, kernels)
        _expect_on_card(f"sharded_world1 {name}", lc_m, pc_m, kernels)
        formula = generic_collectives(params, st_m.k, st_m.prob.neval)
        if coll != formula and st_m.ls_status == 0:
            raise AssertionError(f"sharded_world1 {name}: {coll} collectives, the formula "
                                 f"{formula}")
        iters = st_m.k - 1
        out[name] = dict(iters=iters, evals=st_s.prob.neval, fx=float(st_s.prob.fx))
        emit(phase="sharded_world1_generic", path=name, world=1, backend="nccl",
             iters=iters, evals=st_m.prob.neval, fx=float(st_m.prob.fx), status=st_m.status,
             bit_for_bit=True, collectives_per_iter=coll / iters,
             collectives_formula_per_iter=formula / iters,
             ms_per_iter_solo=1e3 * dt_s / iters, ms_per_iter_mesh=1e3 * dt_m / iters,
             launches={k: lc_m[k] for k in kernels})
        del obj, x0, st_s, st_m
        torch.cuda.empty_cache()
    return out


def phase_sharded_world1() -> dict:
    """The main path and the OWL-QN main path at n = 2^24 under
    ``kernels_on_mesh`` of an NCCL group of world size 1 in this process
    (a TCP store on a free port), each against the same run with no mesh:
    iterations, evaluations, fx and x bit for bit, the same launches.
    Prints the collectives per iteration and the ms per iteration of both
    (runs in turns, ``WORLD1_TURNS``: their medians, their spreads, and
    whether the mesh's overhead exceeds both spreads), the all-reduce ms,
    and where one all-reduce spends its time (``_collective_probe``).
    Then the generic objectives under the local contract
    (``_generic_world1``: one run each, solo and sharded, bit for bit),
    whose solo runs it returns under "generic"."""
    init_distributed(init_method=f"tcp://localhost:{_free_port()}", world_size=1, rank=0)
    out = {}
    try:
        mesh = make_mesh()
        if dist.get_backend() != "nccl":
            raise AssertionError(f"world-size-1 mesh on {dist.get_backend()}, not NCCL")
        # NCCL makes its communicator at the first collective: not in a timed run
        mesh.all_reduce(torch.zeros(1, device="cuda"))
        for name in ("main_path", "owlqn_main_path"):
            params, kernels = SHARDED_PATHS[name]
            x0 = rosenbrock.initial_point(N_BIG, torch.float32, "cuda")
            solo, mesh_runs = [], []
            for turn in WORLD1_TURNS:
                if turn == "s":
                    torch.cuda.synchronize()
                    reset_counts()
                    got = []
                    dt = profiling.timed(lambda: got.append(minimize_jit(
                        params, x0, default_evaluate(), return_state=True)), warmup=0)
                    solo.append((got[0], dt, launches()))
                else:
                    mesh_runs.append(_sharded_run(mesh, params, x0))
            st_s, _, lc_s = solo[0]
            st_m, _, lc_m, pc_m, reads, coll = mesh_runs[0]
            same = (st_s.k == st_m.k and st_s.prob.neval == st_m.prob.neval
                    and _bits(np.asarray(st_s.prob.fx)) == _bits(np.asarray(st_m.prob.fx))
                    and _bits(st_s.prob.x) == _bits(st_m.prob.x))
            if not same or lc_s != lc_m:
                raise AssertionError(
                    f"sharded_world1 {name}: k/neval/fx {st_m.k}/{st_m.prob.neval}/"
                    f"{st_m.prob.fx} against {st_s.k}/{st_s.prob.neval}/{st_s.prob.fx}, "
                    f"x bits {_bits(st_s.prob.x) == _bits(st_m.prob.x)}, launches "
                    f"{lc_m} against {lc_s}")
            _expect_on_card(f"sharded_world1 {name}", lc_m, pc_m, kernels)
            iters = st_m.k - 1
            ms_solo = [1e3 * dt / iters for _, dt, _ in solo]
            ms_mesh = [1e3 * r[1] / iters for r in mesh_runs]
            overhead = _median(ms_mesh) - _median(ms_solo)
            spread = max(max(ms_solo) - min(ms_solo), max(ms_mesh) - min(ms_mesh))
            out[name] = dict(
                iters=iters, evals=st_m.prob.neval, fx=float(st_m.prob.fx), bit_for_bit=True,
                collectives_per_iter=coll / iters, syncs_per_iter=reads / iters,
                turns=WORLD1_TURNS, ms_per_iter_solo=ms_solo, ms_per_iter_mesh=ms_mesh,
                overhead_ms_per_iter=overhead, spread_ms_per_iter=spread,
                overhead_resolved=abs(overhead) > spread,
                allreduce_ms_per_iter=_allreduce_ms(mesh, params, x0),
                launches={k: lc_m[k] for k in kernels})
            emit(phase="sharded_world1", path=name, n=N_BIG, world=1, backend="nccl",
                 **out[name])
            del solo, mesh_runs, st_s, st_m
            torch.cuda.empty_cache()
        out["collective_probe"] = _collective_probe(mesh)
        emit(phase="sharded_world1_collective", world=1, backend="nccl",
             **out["collective_probe"])
        out["generic"] = _generic_world1(mesh)
    finally:
        dist.destroy_process_group()
    return out


def phase_sharded_two_rank(solo: dict) -> dict:
    """Two spawned ranks of a gloo group, both on cuda:0, n = 2^24 in all
    (2^23 each): the main, OWL-QN and damped main paths, and the generic
    objectives under the local contract (``GENERIC_SHARDED``; the Poisson
    regression with each rank's 2048 x 2^19 column block of X, the whole X
    freed): both ranks bit for bit alike, their kernels launched and no
    plain version, no gather, the collectives the formula's, fx within rel
    1e-3 of the world-size-1 phase's solo runs (``solo["generic"]``) and
    the first 8 iterations in float64 the solo run's steps; then the
    sharded checkpoint (``_checkpoint_save``, ``_checkpoint_resume``).
    The factory paths:  Each rank's runs
    must agree bit for bit with the other's (iterations, evaluations, fx,
    the gathered x), launch K1, K2 (K8 under OWL-QN), K4 (K14) and K15
    (K16) on the card and no plain version, and hold every mesh form it
    launched to the single-process launch (``_mesh_kernel_checks``).
    Against the solo runs (``solo``: path -> its report): the main path
    ends at the same iteration, every path's fx within rel 1e-3
    (tests/test_multiprocess.py:166); every path's first 8 iterations in
    float64 take the same steps to fx within ``EARLY_F64_REL``.  Where
    float32 parts a run (its ends, its first 8 iterations against
    ``FUSION_TOL_8``), the difference is printed.
    Prints each rank's launches, the collectives and all-reduce ms per
    iteration."""
    port = _free_port()
    outdir = _build.BUILD_DIR / f"sharded_{os.getpid()}"
    outdir.mkdir(parents=True, exist_ok=True)
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--sharded-rank",
                               str(r), str(port), str(outdir)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=SHARDED_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            raise AssertionError(f"sharded_two_rank: rank {r} exited {p.returncode}:\n"
                                 f"{log[-6000:]}")
    ranks = [json.loads((outdir / f"rank{r}.json").read_text()) for r in range(2)]
    for r, rk in enumerate(ranks):
        emit(phase="sharded_two_rank_kernels", rank=r, offset=rk["kernel_checks"]["offset"],
             worst_rel_scalar=rk["kernel_checks"]["cases"])
    out = {}
    for name, (params, kernels) in SHARDED_PATHS.items():
        a, b = (rk[name] for rk in ranks)
        keys = ("k", "neval", "status", "fx_hex", "x_sha")
        if any(a[k] != b[k] for k in keys) or a["early"] != b["early"]:
            raise AssertionError(f"sharded_two_rank {name}: the ranks part: "
                                 f"{[{k: rk[name][k] for k in (*keys, 'early')} for rk in ranks]}")
        for r, rk in enumerate(ranks):
            _expect_on_card(f"sharded_two_rank {name} rank {r}", rk[name]["launches"],
                            rk[name]["plain_calls"], kernels)
        ref = solo[name]
        iters = a["k"] - 1
        rel = abs(a["fx"] - ref["fx"]) / (abs(ref["fx"]) or 1.0)
        early_solo = _early_runs(params)
        early = {}
        for key, e in a["early"].items():
            e_s = early_solo[key]
            early[key] = dict(
                k_neval=[e["k"], e["neval"]], k_neval_solo=[e_s["k"], e_s["neval"]],
                rel_fx=abs(e["fx"] / e_s["fx"] - 1),
                same_steps=(e["k"], e["neval"]) == (e_s["k"], e_s["neval"]))
        e64 = early["f64"]
        if not (e64["same_steps"] and e64["rel_fx"] <= EARLY_F64_REL):
            raise AssertionError(f"sharded_two_rank {name}: float64, after 8 iterations "
                                 f"{a['early']['f64']} against the solo run's "
                                 f"{early_solo['f64']}")
        if not rel <= 1e-3 or (name == "main_path" and iters != ref["iters"]):
            raise AssertionError(f"sharded_two_rank {name}: {iters} iterations to fx {a['fx']} "
                                 f"against the solo run's {ref['iters']} to {ref['fx']}")
        out[name] = dict(
            iters=iters, iters_solo=ref["iters"], evals=a["neval"], evals_solo=ref["evals"],
            fx=a["fx"], fx_solo=ref["fx"], rel_fx_vs_solo=rel,
            iters_minus_solo=iters - ref["iters"], early=early,
            early_f32_within_fusion_tol=early["f32"]["same_steps"]
            and early["f32"]["rel_fx"] <= FUSION_TOL_8,
            status=a["status"], ranks_bit_for_bit=True,
            collectives_per_iter=a["collectives"] / iters,
            ms_per_iter=[rk[name]["ms_per_iter"] for rk in ranks],
            allreduce_ms_per_iter=[rk[name]["allreduce_ms_per_iter"] for rk in ranks],
            launches=[{k: v for k, v in rk[name]["launches"].items() if v} for rk in ranks])
        emit(phase="sharded_two_rank", path=name, n=N_BIG, world=2, backend="gloo",
             device="cuda:0 (both ranks)", **out[name])
    for name, (params, model, kernels) in GENERIC_SHARDED.items():
        a, b = (rk[name] for rk in ranks)
        keys = ("k", "neval", "status", "fx_hex", "x_sha")
        if any(a[k] != b[k] for k in keys) or a["early"] != b["early"]:
            raise AssertionError(f"sharded_two_rank {name}: the ranks part: "
                                 f"{[{k: rk[name][k] for k in (*keys, 'early')} for rk in ranks]}")
        for r, rk in enumerate(ranks):
            _expect_on_card(f"sharded_two_rank {name} rank {r}", rk[name]["launches"],
                            rk[name]["plain_calls"], kernels)
            if rk[name]["gathers"] or (rk[name]["collectives"] != rk[name]["collectives_formula"]
                                       and rk[name]["ls_status"] == 0):
                raise AssertionError(f"sharded_two_rank {name} rank {r}: {rk[name]['gathers']} "
                                     f"gathers, {rk[name]['collectives']} collectives against "
                                     f"the formula's {rk[name]['collectives_formula']}")
        ref = solo["generic"][name]
        iters = a["k"] - 1
        rel = abs(a["fx"] - ref["fx"]) / (abs(ref["fx"]) or 1.0)
        e, e_s = a["early"]["f64"], _early_generic(params, model)
        rel64 = abs(e["fx"] / e_s["fx"] - 1)
        if (e["k"], e["neval"]) != (e_s["k"], e_s["neval"]) or not rel64 <= EARLY_F64_REL:
            raise AssertionError(f"sharded_two_rank {name}: float64, after 8 iterations {e} "
                                 f"against the solo run's {e_s}")
        if not rel <= 1e-3:
            raise AssertionError(f"sharded_two_rank {name}: {iters} iterations to fx {a['fx']} "
                                 f"against the solo run's {ref['iters']} to {ref['fx']}")
        out[name] = dict(
            iters=iters, iters_solo=ref["iters"], evals=a["neval"], evals_solo=ref["evals"],
            fx=a["fx"], fx_solo=ref["fx"], rel_fx_vs_solo=rel, status=a["status"],
            early_f64=dict(k_neval=[e["k"], e["neval"]], k_neval_solo=[e_s["k"], e_s["neval"]],
                           rel_fx=rel64), ranks_bit_for_bit=True,
            collectives_per_iter=a["collectives"] / iters,
            collectives_formula_per_iter=a["collectives_formula"] / iters,
            ms_per_iter=[rk[name]["ms_per_iter"] for rk in ranks],
            launches=[{k: rk[name]["launches"][k] for k in kernels} for rk in ranks])
        emit(phase="sharded_two_rank_generic", path=name, world=2, backend="gloo",
             device="cuda:0 (both ranks)", **out[name])
    out["checkpoint"] = _checkpoint_resume(outdir, ranks)
    shutil.rmtree(outdir)
    return out


def _gidx_block(x, gidx):
    """(w x^2 / 2, w x) with w = 1 + (gidx mod 7) / 10: a body that reads
    the global index beyond its parity (Rosenbrock's reads only that).
    Both the Triton body (``_gidx_body``) and its torch twin."""
    w = 1.0 + 0.1 * (gidx % 7).to(x.dtype)
    return 0.5 * (w * (x * x)), w * x


_GIDX_BODY = []


def _gidx_body():
    if not _GIDX_BODY:
        import triton

        _GIDX_BODY.append(triton.jit(_gidx_block))
    return _GIDX_BODY[0]


def _mesh_kernel_checks(mesh) -> dict:
    """Every mesh form the sharded paths launch (K1, K2, K4 +-gp, K8 in
    both forms, K10, K14 +-gp, K15 +-fix, K16; the generic objectives' K3,
    K9, K11, K12 +-gp and K13; K6, which the trial-only route's damped
    capped combine launches), the quadratic's K1 and K4
    with its extras passed whole (each rank narrows them to its shard) and
    a body that reads the global index beyond its parity (K1, K2), each
    called under the mesh on this rank's shard of seeded inputs at n =
    2^24 and held to the single-process launch on the whole inputs: the
    vectors and ring rows it writes bit for bit on the shard's elements,
    its scalars within ``MESH_*``; each mesh call must launch its kernel
    once and call no plain version.  The OWL-QN forms run on a window
    that starts and ends in different shards and on one inside rank 1's
    shard only.  Raises on any mismatch; returns the offset and each
    case's largest relative scalar difference.  At m = 80 ring rows (n =
    2^20; ``_m80``) K4 and K14 (the tensor-core form), the deep K15 and
    K16 and K12 +-gp take the same checks, and so do K4 and K14 +-gp over
    f32 and f64 rings in their row-block form (``_m80_f32``, ``_m80_f64``),
    rank 1's kernels with the shard's offset compiled in (``SHARD``)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 13)

    def r(*shape, s=1.0):
        return torch.randn(*shape, generator=gen, device="cuda") * s

    def data(n: int, m: int, vd=torch.float32, hd=torch.bfloat16) -> dict:
        x0 = rosenbrock.initial_point(n, torch.float32, "cuda")
        a = dict(xp=x0 + r(n, s=0.1), d=r(n, s=0.1), gp=r(n), gx=r(n), pg=r(n),
                 x=x0 + r(n, s=0.1), wp=torch.sign(r(n)), cs=r(m), cy=r(m))
        a = {key: v.to(vd) for key, v in a.items()}
        a.update(S=r(m, n, s=0.1).to(hd), Y=r(m, n, s=0.1).to(hd))
        a["xz"] = a["xp"].clone()
        a["xz"][::5] = 0.0
        return a

    n = N_BIG
    n_loc = n // mesh.size
    off = mesh.rank * n_loc
    a = data(n, M)
    k = rosenbrock.value_and_grad.kernels
    quad = separable.quadratic(0.5 + r(n).abs(), r(n))
    gobj = factory.make_fused_objective(_gidx_body, block_ref=_gidx_block)
    gamma = torch.tensor(0.7, device="cuda")
    fix = (4, torch.tensor(0.8, device="cuda"), torch.tensor(-0.15, device="cuda"))
    c = 0.8
    windows = {"cross": (130, n - 7), "rank1": (n_loc + 1000, n_loc + 5000)}
    trial_b = {1: MESH_NORM, 3: MESH_DOT, 4: MESH_NORM, 5: MESH_NORM, 6: MESH_EQUAL}
    epi_b = {**trial_b, 7: MESH_GRAM, 8: MESH_GRAM}
    ow_epi_b = {3: MESH_GRAM, 4: MESH_GRAM, 5: MESH_NORM, 6: MESH_NORM, 7: MESH_EQUAL}
    probe_b = {0: MESH_NORM, 1: MESH_DOT}
    # (name, the wrapper whose launches count, the call on whole or shard
    # inputs, its vector outputs, its scalar outputs' bounds, writes rings)
    cases = [
        ("K1_trial", k.trial, lambda v: k.trial(v.xp, v.d, 0.2), (0, 2), trial_b, False),
        ("K2_probe", k.probe, lambda v: k.probe(v.xp, v.d, 0.2), (), probe_b, False),
        *[(f"K4_trial_pair_gram{'_gp' if gp else ''}", k.trial_pair_gram, lambda v, gp=gp:
           k.trial_pair_gram(v.xp, v.d, v.gp, 0.6, v.S, v.Y, 4, with_gp=gp), (0, 2), epi_b,
           True) for gp in (False, True)],
        ("K15_combine_probe", k.combine_probe, lambda v: k.combine_probe(
            v.gp, v.x, v.S, v.Y, gamma, v.cs, v.cy, 0.3), (0,),
         {1: MESH_NORM, 2: MESH_DOT, 3: MESH_NORM, 4: MESH_DOT}, True),
        ("K15_combine_probe_fix", k.combine_probe, lambda v: k.combine_probe(
            v.gp, v.x, v.S, v.Y, gamma, v.cs, v.cy, 0.3, fix=fix), (0,),
         {1: MESH_NORM, 2: MESH_DOT, 3: MESH_NORM, 4: MESH_DOT}, True),
        ("quadratic_K1_extras_whole", quad.kernels.trial,
         lambda v: quad.kernels.trial(v.xp, v.d, 0.37), (0, 2), trial_b, False),
        ("quadratic_K4_extras_whole", quad.kernels.trial_pair_gram,
         lambda v: quad.kernels.trial_pair_gram(v.xp, v.d, v.gp, 0.3, v.S, v.Y, 1), (0, 2),
         epi_b, True),
        ("gidx_K1", gobj.kernels.trial, lambda v: gobj.kernels.trial(v.xp, v.d, 0.4), (0, 2),
         {1: MESH_NORM, 3: MESH_DOT, 4: MESH_NORM, 5: MESH_NORM}, False),
        ("gidx_K2", gobj.kernels.probe, lambda v: gobj.kernels.probe(v.xp, v.d, 0.4), (),
         probe_b, False),
    ]
    for w, (lo, hi) in windows.items():
        cases += [
            (f"K8_owlqn_probe_{w}", k.owlqn_probe, lambda v, lo=lo, hi=hi: k.owlqn_probe(
                v.xz, v.d, v.wp, 0.37, c, lo, hi), (), probe_b, False),
            (f"K8_owlqn_probe_pg_{w}", k.owlqn_probe_pg, lambda v, lo=lo, hi=hi:
             k.owlqn_probe_pg(v.xz, v.d, v.pg, 0.37, c, lo, hi), (), probe_b, False),
            (f"K10_pseudo_gradient_norm_{w}", fused.pseudo_gradient_norm,
             lambda v, lo=lo, hi=hi: fused.pseudo_gradient_norm(v.xz, v.gx, c, lo, hi), (0,),
             {1: MESH_NORM}, False),
            (f"K16_combine_ow_probe_{w}", k.combine_ow_probe, lambda v, lo=lo, hi=hi:
             k.combine_ow_probe(v.pg, v.xz, v.S, v.Y, -gamma, v.cs, v.cy, c, lo, hi, 0.3),
             (0,), {1: MESH_NORM, 2: MESH_NORM, 3: MESH_DOT, 4: MESH_NORM, 5: MESH_DOT}, False)]
        for gp in (False, True):
            cases.append((f"K14_owlqn_trial_pair_gram{'_gp' if gp else ''}_{w}",
                          k.owlqn_trial_pair_gram, lambda v, lo=lo, hi=hi, gp=gp:
                          k.owlqn_trial_pair_gram(v.xz, v.d, v.gp, v.pg, 0.37, c, lo, hi,
                                                  v.S, v.Y, 2, with_gp=gp), (0, 1, 2),
                          {**ow_epi_b, **({8: MESH_NORM, 9: MESH_DOT} if gp else {})}, True))

    # the composed paths' mesh forms (generic objectives and the trial-only
    # route): K3, K6, K12 with and without its . gp column, and K9, K11 and
    # K13 on both windows
    cases += [
        ("K3_combine", fused.combine, lambda v: fused.combine(v.d, v.S, v.Y, gamma, v.cs, v.cy),
         (0,), {1: MESH_NORM, 2: MESH_DOT}, False),
        ("K6_combine_fix", fused.combine_fix, lambda v: fused.combine_fix(
            v.d, v.S, v.Y, gamma, v.cs, v.cy, *fix), (0,), {1: MESH_NORM, 2: MESH_DOT}, True),
        *[(f"K12_pair_gram_xg{'_gp' if gp else ''}", fused.pair_gram_xg, lambda v, gp=gp:
           fused.pair_gram_xg(v.x, v.xp, v.gx, v.gp, v.pg, v.S, v.Y, 2, with_gp=gp), (),
           {0: MESH_GRAM, 1: MESH_GRAM, **({2: MESH_NORM, 3: MESH_DOT} if gp else {})}, True)
          for gp in (False, True)],
    ]
    for w, (lo, hi) in windows.items():
        cases += [
            (f"K9_owlqn_trial_step_{w}", fused.owlqn_trial_step, lambda v, lo=lo, hi=hi: (
                fused.owlqn_trial_step(v.xp, v.d, v.wp, 0.3, lo, hi),), (0,), {}, False),
            (f"K11_pseudo_gradient_{w}", fused.pseudo_gradient, lambda v, lo=lo, hi=hi: (
                fused.pseudo_gradient(v.xz, v.gx, c, lo, hi),), (0,), {}, False),
            (f"K13_combine_ow_{w}", fused.combine_ow, lambda v, lo=lo, hi=hi: fused.combine_ow(
                v.pg, v.S, v.Y, -gamma, v.cs, v.cy, lo, hi), (0,),
             {1: MESH_NORM, 2: MESH_NORM, 3: MESH_DOT}, False)]

    def plain_total() -> int:
        return (sum(plain_calls().values())
                + sum(getattr(o.kernels, ref).calls for o in (quad, gobj) for ref in FACTORY_REFS))

    # the deep forms at m = 80 (n = 2^20): K4 and K14 with and without the
    # . gp column, K15 with and without its damped row and K16, the OWL-QN
    # forms on a window that starts and ends in different shards
    n_deep = 1 << 20
    lo_d, hi_d = 130, n_deep - 7
    deep_cases = [
        *[(f"K4_trial_pair_gram{'_gp' if gp else ''}_m80", k.trial_pair_gram, lambda v, gp=gp:
           k.trial_pair_gram(v.xp, v.d, v.gp, 0.6, v.S, v.Y, 4, with_gp=gp), (0, 2), epi_b,
           True) for gp in (False, True)],
        *[(f"K14_owlqn_trial_pair_gram{'_gp' if gp else ''}_m80", k.owlqn_trial_pair_gram,
           lambda v, gp=gp: k.owlqn_trial_pair_gram(v.xz, v.d, v.gp, v.pg, 0.37, c, lo_d, hi_d,
                                                    v.S, v.Y, 2, with_gp=gp), (0, 1, 2),
           {**ow_epi_b, **({8: MESH_NORM, 9: MESH_DOT} if gp else {})}, True)
          for gp in (False, True)],
        *[(f"K15_combine_probe{'_fix' if fx else ''}_m80", k.combine_probe, lambda v, fx=fx:
           k.combine_probe(v.gp, v.x, v.S, v.Y, gamma, v.cs, v.cy, 0.3,
                           fix=fix if fx else None), (0,),
           {1: MESH_NORM, 2: MESH_DOT, 3: MESH_NORM, 4: MESH_DOT}, True) for fx in (False, True)],
        ("K16_combine_ow_probe_m80", k.combine_ow_probe, lambda v: k.combine_ow_probe(
            v.pg, v.xz, v.S, v.Y, -gamma, v.cs, v.cy, c, lo_d, hi_d, 0.3), (0,),
         {1: MESH_NORM, 2: MESH_NORM, 3: MESH_DOT, 4: MESH_NORM, 5: MESH_DOT}, False),
        *[(f"K12_pair_gram_xg{'_gp' if gp else ''}_m80", fused.pair_gram_xg, lambda v, gp=gp:
           fused.pair_gram_xg(v.x, v.xp, v.gx, v.gp, v.pg, v.S, v.Y, 2, with_gp=gp), (),
           {0: MESH_GRAM, 1: MESH_GRAM, **({2: MESH_NORM, 3: MESH_DOT} if gp else {})}, True)
          for gp in (False, True)],
    ]

    # the row-block form at m = 80 over f32 and f64 rings (n = 2^20): K4 and
    # K14 with and without the . gp column
    rows_cases = [
        *[(f"K4_trial_pair_gram{'_gp' if gp else ''}_m80", k.trial_pair_gram, lambda v, gp=gp:
           k.trial_pair_gram(v.xp, v.d, v.gp, 0.6, v.S, v.Y, 4, with_gp=gp), (0, 2), epi_b,
           True) for gp in (False, True)],
        *[(f"K14_owlqn_trial_pair_gram{'_gp' if gp else ''}_m80", k.owlqn_trial_pair_gram,
           lambda v, gp=gp: k.owlqn_trial_pair_gram(v.xz, v.d, v.gp, v.pg, 0.37, c, lo_d, hi_d,
                                                    v.S, v.Y, 2, with_gp=gp), (0, 1, 2),
           {**ow_epi_b, **({8: MESH_NORM, 9: MESH_DOT} if gp else {})}, True)
          for gp in (False, True)],
    ]

    res = _mesh_cases(mesh, a, cases, off, n_loc, plain_total)
    n_loc_d = n_deep // mesh.size
    res.update(_mesh_cases(mesh, data(n_deep, DEEP_M), deep_cases, mesh.rank * n_loc_d, n_loc_d,
                           plain_total))
    for vd, tag in ((torch.float32, "f32"), (torch.float64, "f64")):
        got = _mesh_cases(mesh, data(n_deep, DEEP_M, vd, vd), rows_cases, mesh.rank * n_loc_d,
                          n_loc_d, plain_total, form="mma_rows")
        res.update({f"{name}_{tag}": v for name, v in got.items()})
        torch.cuda.empty_cache()
    # the index body's single-process launch against its plain version
    xt, _, g, *_ = gobj.kernels.trial(a["xp"], a["d"], 0.4)
    _, _, g_ref, *_ = gobj.kernels.trial_ref(a["xp"], a["d"], 0.4)
    res["gidx_K1_vs_plain"] = check("gidx K1 g vs plain", g, g_ref,
                                    TOL[(torch.float32, "vec")])[1]
    torch.cuda.empty_cache()
    return dict(offset=off, cases=res)


def _mesh_cases(mesh, a: dict, cases: list, off: int, n_loc: int, plain_total,
                form: str = "mma") -> dict:
    """``_mesh_kernel_checks``'s cases on the inputs ``a``, this rank's
    shard the elements [off, off + n_loc); a case named ``_m80`` must
    launch above ``factory.MAX_M`` rows (``.deep_launches``), K4 and K14 in
    their tensor-core form ``form`` ("mma", or "mma_rows": the row-block
    form)."""
    res = {}
    for name, wrapper, fn, vecs, bounds, rings in cases:
        whole = SimpleNamespace(**{key: (t.clone() if key in ("S", "Y") else t)
                                   for key, t in a.items()})
        single = fn(whole)
        part = SimpleNamespace(**{key: (t if key in ("cs", "cy") else shard_vector(t, mesh))
                                  for key, t in a.items()})
        launched, plain = wrapper.launches, plain_total()
        deep = getattr(wrapper, "deep_launches", 0)
        count = form + "_launches"
        mma = getattr(wrapper, count, 0)
        with kernels_on_mesh(mesh):
            got = fn(part)
        torch.cuda.synchronize()
        if wrapper.launches != launched + 1 or plain_total() != plain:
            raise AssertionError(f"mesh check {name}: {wrapper.launches - launched} launches, "
                                 f"{plain_total() - plain} plain calls")
        if (name.endswith("_m80") and hasattr(wrapper, "deep_launches")
                and wrapper.deep_launches != deep + 1):
            raise AssertionError(f"mesh check {name}: the deep form did not launch")
        # K4 and K14 at 80 rows: the tensor-core form (bf16 rings) or the
        # row-block form (f32 and f64), spilling nothing (rank 1's with the
        # shard's offset compiled in)
        if name.endswith("_m80") and hasattr(wrapper, count):
            info = _compiled_info(wrapper.last_form.compiled)
            if getattr(wrapper, count) != mma + 1 or info["n_spills"]:
                raise AssertionError(f"mesh check {name}: {getattr(wrapper, count) - mma} "
                                     f"{form} launches, {info}")
        shard = lambda t: t.narrow(-1, off, n_loc)
        bad = [f"out{i}" for i in vecs if not same_bits(got[i], shard(single[i]))]
        if rings:
            bad += [ring for ring in ("S", "Y")
                    if not same_bits(getattr(part, ring), shard(getattr(whole, ring)))]
        worst = 0.0
        for i, (rel, ab) in bounds.items():
            g_, s_ = (np.asarray(torch.as_tensor(v).double().cpu()) for v in (got[i], single[i]))
            if not np.all(np.abs(g_ - s_) <= ab + rel * np.abs(s_)):
                bad.append(f"out{i}: {g_.ravel()[:4]} against {s_.ravel()[:4]}")
            worst = max(worst, float(np.max(np.abs(g_ - s_) / np.maximum(np.abs(s_), 1e-30))))
        if bad:
            raise AssertionError(f"mesh check {name} on rank {mesh.rank} (offset {off}): "
                                 f"{bad}")
        res[name] = worst
        del whole, part, single, got
    return res


#: the sharded checkpoint: the main path at n = 2^22, saved by both ranks
#: at iteration ``CKPT_AT`` and resumed in one process with no mesh
CKPT_N, CKPT_AT = 1 << 22, 10


def _until(state: LbfgsState, k: int | None = None) -> None:
    """Propagate ``state`` to iteration k, or to its end."""
    while not state.is_converged() and (k is None or state.state.k < k):
        state.propagate()


def _checkpoint_save(mesh, outdir: str) -> dict:
    """The main path at ``CKPT_N`` on this rank's shard through
    ``LbfgsState`` to iteration ``CKPT_AT``, saved with the sharded
    ``save_state`` under the mesh into OUTDIR/ckpt (the gathers of the
    save counted); rank 0 then writes ``gather_state``'s whole state with
    no mesh (OUTDIR/ckpt_whole.npz), outside the run."""
    x0 = rosenbrock.initial_point(CKPT_N, torch.float32, "cuda")
    reset_counts()
    with kernels_on_mesh(mesh):
        state = LbfgsState.build(MAIN_PARAMS, shard_vector(x0, mesh), default_evaluate())
        _until(state, CKPT_AT)
        mesh.reset_counts()
        save_state(os.path.join(outdir, "ckpt"), state.state)
        gathers = mesh.gathers
    lc, pc = launches(), plain_calls()
    whole = gather_state(state.state, mesh)
    if mesh.rank == 0:
        save_state(os.path.join(outdir, "ckpt_whole.npz"), whole)
    return dict(k=int(state.state.k), save_gathers=gathers, launches=lc, plain_calls=pc)


def _checkpoint_resume(outdir, ranks: list) -> dict:
    """The two-rank phase's checkpoint, loaded with no mesh in this process:
    the sharded checkpoint (OUTDIR/ckpt) and the gathered whole state
    (OUTDIR/ckpt_whole.npz) into fresh states of the main path at
    ``CKPT_N``, every tensor bit for bit alike; the two runs resumed from
    them to their ends bit for bit alike (k, evaluations, fx, x) on the
    kernels, and ending as the same path's solo run does (the same k, fx
    rel 1e-3)."""
    for r, rk in enumerate(ranks):
        c = rk["checkpoint"]
        if c["k"] != CKPT_AT or c["save_gathers"]:
            raise AssertionError(f"checkpoint: rank {r} saved at k = {c['k']} with "
                                 f"{c['save_gathers']} gathers")
        _expect_on_card(f"checkpoint rank {r}", c["launches"], c["plain_calls"], PLAIN_PATH)
    x0 = rosenbrock.initial_point(CKPT_N, torch.float32, "cuda")
    states = {}
    for key, path in (("sharded", outdir / "ckpt"), ("whole", outdir / "ckpt_whole.npz")):
        like = LbfgsState.build(MAIN_PARAMS, x0, default_evaluate())
        states[key] = (like, load_state(str(path), like.state))
    if _state_bits(states["sharded"][1]) != _state_bits(states["whole"][1]):
        raise AssertionError("checkpoint: the sharded checkpoint's state is not the gathered "
                             "state bit for bit")
    ends = {}
    for key, (state, st) in states.items():
        state.restore(st)
        reset_counts()
        _until(state)
        # past the init: no K1
        _expect_on_card(f"checkpoint resumed from {key}", launches(), plain_calls(),
                        PLAIN_PATH[1:])
        s = state.state
        ends[key] = dict(k=s.k, neval=s.prob.neval, fx=float(s.prob.fx),
                         fx_hex=float(s.prob.fx).hex(), x=s.prob.x)
    solo = LbfgsState.build(MAIN_PARAMS, x0, default_evaluate())
    _until(solo)
    a, b = ends["sharded"], ends["whole"]
    if (a["k"], a["neval"], a["fx_hex"]) != (b["k"], b["neval"], b["fx_hex"]) or not same_bits(
            a["x"], b["x"]):
        raise AssertionError(f"checkpoint: the resumed runs part: {a['k']}/{a['fx']} against "
                             f"{b['k']}/{b['fx']}")
    fx_solo = float(solo.state.prob.fx)
    rel = abs(a["fx"] - fx_solo) / (abs(fx_solo) or 1.0)
    if a["k"] != solo.state.k or not rel <= 1e-3:
        raise AssertionError(f"checkpoint: resumed to k = {a['k']}, fx {a['fx']}; the solo "
                             f"run {solo.state.k}, {fx_solo}")
    out = dict(n=CKPT_N, saved_at=CKPT_AT, world_saved=2, loaded_bit_for_bit=True,
               resumed_bit_for_bit=True, k=a["k"], evals=a["neval"], fx=a["fx"],
               k_solo=solo.state.k, fx_solo=fx_solo, rel_fx_vs_solo=rel,
               files=sorted(f.name for f in (outdir / "ckpt").iterdir()))
    emit(phase="sharded_checkpoint", **out)
    return out


def sharded_rank(rank: int, port: int, outdir: str) -> None:
    """One rank of ``phase_sharded_two_rank``: joins the gloo group on
    cuda:0, runs each sharded path three times (the launch counts and the
    check, the wall, the timed collectives) and its early runs
    (``_early_runs``), then holds the mesh forms to the single-process launches
    (``_mesh_kernel_checks``), and writes its results."""
    import hashlib

    if not torch.cuda.is_available():
        raise SystemExit("sharded rank: no CUDA device")
    init_distributed(backend="gloo", device="cuda:0", init_method=f"tcp://localhost:{port}",
                     world_size=2, rank=rank, timeout=datetime.timedelta(seconds=240))
    res = {}
    try:
        mesh = make_mesh()
        for name, (params, _) in SHARDED_PATHS.items():
            x0 = rosenbrock.initial_point(N_BIG, torch.float32, "cuda")
            st, _, lc, pc, reads, coll = _sharded_run(mesh, params, x0)
            dt = _sharded_run(mesh, params, x0)[1]
            iters = st.k - 1
            x = gather_vector(st.prob.x, mesh)
            res[name] = dict(
                k=st.k, neval=st.prob.neval, status=st.status, fx=float(st.prob.fx),
                fx_hex=float(st.prob.fx).hex(),
                x_sha=hashlib.sha256(x.cpu().numpy().tobytes()).hexdigest(),
                launches=lc, plain_calls=pc, collectives=coll, syncs=reads,
                ms_per_iter=1e3 * dt / iters,
                allreduce_ms_per_iter=_allreduce_ms(mesh, params, x0),
                early=_early_runs(params, mesh))
            del st, x, x0
            torch.cuda.empty_cache()
        for name, (params, model, _) in GENERIC_SHARDED.items():
            obj, x0 = generic_problem(model, torch.float32, mesh)
            st, dt, lc, pc, coll, gathers = _generic_sharded_run(params, obj, x0, mesh)
            x = gather_vector(st.prob.x, mesh)
            res[name] = dict(
                k=st.k, neval=st.prob.neval, status=st.status, fx=float(st.prob.fx),
                fx_hex=float(st.prob.fx).hex(),
                x_sha=hashlib.sha256(x.cpu().numpy().tobytes()).hexdigest(),
                launches=lc, plain_calls=pc, collectives=coll, gathers=gathers,
                ls_status=int(st.ls_status),
                collectives_formula=generic_collectives(params, st.k, st.prob.neval),
                ms_per_iter=1e3 * dt / (st.k - 1))
            del obj, x0, st, x
            torch.cuda.empty_cache()
            res[name]["early"] = {"f64": _early_generic(params, model, mesh)}
        res["checkpoint"] = _checkpoint_save(mesh, outdir)
        res["kernel_checks"] = _mesh_kernel_checks(mesh)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(outdir, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)


# ---------------------------------------------------------------------------
# the port's example scripts (examples/*_torch.py) on the card
# ---------------------------------------------------------------------------

EXAMPLES_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "examples")


def _example(name: str):
    if EXAMPLES_DIR not in sys.path:
        sys.path.insert(0, EXAMPLES_DIR)
    return importlib.import_module(name)


def _near(name: str, x: torch.Tensor, want: torch.Tensor, rtol: float, atol: float) -> float:
    gap = float(torch.max(torch.abs(x - want) - rtol * torch.abs(want)))
    if not gap <= atol:
        raise AssertionError(f"example {name}: off its oracle by {gap} beyond rtol {rtol}")
    return gap


def _sample_ok(rep) -> dict:
    """The reference's sample: converged to Rosenbrock's minimum."""
    if rep.status != Status.CONVERGED or not rep.fx <= 1e-10:
        raise AssertionError(f"example sample: status {rep.status}, fx {rep.fx}")
    _near("sample", rep.x, torch.ones_like(rep.x), 0.0, 1e-5)
    return dict(niter=rep.niter, fx=rep.fx)


def _lj_ok(rep) -> dict:
    """The relaxed LJ38 energy ``phase_lj38`` checks."""
    if abs(rep.fx - (-164.2701507)) > 1e-4:
        raise AssertionError(f"example lj: energy {rep.fx} after {rep.niter} iterations")
    return dict(niter=rep.niter, fx=rep.fx)


def _owlqn_logistic_ok(rep) -> dict:
    """The 500 x 21 float64 fit, against the same script on the CPU."""
    with contextlib.redirect_stdout(io.StringIO()):
        cpu = _example("owlqn_logistic_torch").main(["--device", "cpu"])
    rel = abs(rep.fx / cpu.fx - 1)
    if (rep.niter, rep.neval, rep.status) != (cpu.niter, cpu.neval, cpu.status) or rel > 1e-9:
        raise AssertionError(f"example owlqn_logistic: {rep.niter}/{rep.neval}/{rep.fx} on the "
                             f"card, {cpu.niter}/{cpu.neval}/{cpu.fx} on the CPU")
    return dict(niter=rep.niter, neval=rep.neval, fx=rep.fx, rel_fx_vs_cpu=rel,
                nnz=int((rep.x != 0).sum()))


def _owlqn_wide_fx_ok(rep) -> dict:
    """CONVERGED with a float64 fx over float32 vectors."""
    if rep.status != Status.CONVERGED or type(rep.fx) is not np.float64:
        raise AssertionError(f"example owlqn_wide_fx: status {rep.status}, fx {rep.fx!r}")
    return dict(niter=rep.niter, neval=rep.neval, fx=float(rep.fx))


def _separable_ok(reps) -> dict:
    """The three runs at their oracles (``tests/test_factory_objective.py``'s
    bounds): the quadratic's and the Huber loss's x = t at rtol and atol
    1e-3, the LASSO's soft threshold at rtol 1e-2, atol 2e-3."""
    n = reps[0].x.shape[0]
    rng = np.random.RandomState(0)
    w = torch.from_numpy((0.5 + np.abs(rng.randn(n))).astype(np.float32)).cuda()
    t = torch.from_numpy(rng.randn(n).astype(np.float32)).cuda()
    star = torch.sign(t) * torch.clamp(torch.abs(t) - 0.3 / w, min=0.0)
    gaps = [_near("separable quadratic", reps[0].x, t, 1e-3, 1e-3),
            _near("separable lasso", reps[1].x, star, 1e-2, 2e-3),
            _near("separable huber", reps[2].x, t, 1e-3, 1e-3)]
    return dict(niter=[r.niter for r in reps], fx=[float(r.fx) for r in reps],
                oracle_gaps=gaps)


#: the in-process examples: (the kernels each must launch, its check)
EXAMPLES = {
    "sample_torch": (("K1_trial", "K2_probe", "K4_trial_pair_gram", "K3_combine"), _sample_ok),
    "lj_torch": (("K3_combine",), _lj_ok),
    "owlqn_logistic_torch": (POISSON_PATH + ("K10_pseudo_gradient_norm", "K13_combine_ow"),
                             _owlqn_logistic_ok),
    "owlqn_wide_fx_torch": (("K7_owlqn_trial", "K8_owlqn_probe", "K10_pseudo_gradient_norm",
                             "K14_owlqn_trial_pair_gram", "K16_combine_ow_probe"),
                            _owlqn_wide_fx_ok),
    "separable_torch": (("K1_trial_ex", "K2_probe_ex", "K4_trial_pair_gram_ex",
                         "K15_combine_probe_ex", "K8_owlqn_probe_ex",
                         "K14_owlqn_trial_pair_gram_ex", "K16_combine_ow_probe_ex"),
                        _separable_ok),
}
#: the sharded example's kernels (the factory run capped: K1, K2, K4, K3;
#: the generic run K3)
SHARDED_EXAMPLE_KERNELS = ("K1_trial", "K2_probe", "K4_trial_pair_gram", "K3_combine")


def _run_example(name: str, argv: list) -> tuple:
    """``examples/<name>.py``'s ``main(argv)`` with its printout captured,
    counting the launches and plain calls of the factory objectives it
    builds beside this module's (``EXTRAS`` for the run): (its result,
    seconds, launches, plain calls, its last printed lines)."""
    mod = _example(name)
    made, orig = [], factory.make_fused_objective

    def recording(*a, **kw):
        obj = orig(*a, **kw)
        made.append(obj)
        return obj

    factory.make_fused_objective = recording
    if hasattr(mod, "make_fused_objective"):
        mod.make_fused_objective = recording
    reset_counts()
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            t0 = time.perf_counter()
            rep = mod.main(argv)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
        for i, obj in enumerate(made):
            EXTRAS[f"example_{i}"] = obj
        lc, pc = launches(), plain_calls()
    finally:
        factory.make_fused_objective = orig
        if hasattr(mod, "make_fused_objective"):
            mod.make_fused_objective = orig
        for i in range(len(made)):
            EXTRAS.pop(f"example_{i}", None)
    return rep, dt, lc, pc, buf.getvalue().strip().splitlines()[-3:]


def example_sharded() -> None:
    """``examples/sharded_giant_torch.py`` in this process, its rank taken
    from the environment (as ``torchrun`` sets it): prints one JSON line of
    its reports, launches and plain calls."""
    reps, dt, lc, pc, last = _run_example("sharded_giant_torch", [])
    print(json.dumps(dict(reports=[dict(niter=r.niter, neval=r.neval, fx=float(r.fx),
                                        status=r.status) for r in reps],
                          seconds=dt, launches=lc, plain_calls=pc, last_lines=last)))


def phase_examples() -> dict:
    """The port's example scripts on the card at their default sizes: five
    in this process (``EXAMPLES``: each launches its kernels and calls no
    plain version, and ends as its JAX script says it should), and
    ``sharded_giant_torch.py`` as a subprocess at world size 1 over NCCL
    (its rendezvous in the environment, as ``torchrun`` sets it): both of
    its runs (the factory Rosenbrock and the generic one under the local
    contract) at n = 2^22 finite, its kernels launched, no plain version."""
    out = {}
    for name, (kernels, ok) in EXAMPLES.items():
        rep, dt, lc, pc, last = _run_example(name, [])
        _expect_on_card(f"example {name}", lc, pc, kernels)
        out[name] = dict(seconds=dt, **ok(rep))
        emit(phase="examples", example=name, **out[name], printed=last,
             launches={k: lc[k] for k in kernels})
        del rep
        torch.cuda.empty_cache()
    env = dict(os.environ, MASTER_ADDR="localhost", MASTER_PORT=str(_free_port()),
               WORLD_SIZE="1", RANK="0", LOCAL_RANK="0")
    p = subprocess.run([sys.executable, os.path.abspath(__file__), "--example-sharded"],
                       env=env, capture_output=True, text=True, timeout=SHARDED_TIMEOUT)
    if p.returncode != 0:
        raise AssertionError(f"example sharded_giant_torch exited {p.returncode}:\n"
                             f"{p.stdout[-3000:]}\n{p.stderr[-3000:]}")
    res = json.loads(p.stdout.strip().splitlines()[-1])
    _expect_on_card("example sharded_giant_torch", res["launches"], res["plain_calls"],
                    SHARDED_EXAMPLE_KERNELS)
    if not all(np.isfinite(r["fx"]) for r in res["reports"]) or len(res["reports"]) != 2:
        raise AssertionError(f"example sharded_giant_torch: {res['reports']}")
    out["sharded_giant_torch"] = dict(reports=res["reports"], seconds=res["seconds"])
    emit(phase="examples", example="sharded_giant_torch", world=1, backend="nccl",
         reports=res["reports"], seconds=res["seconds"], printed=res["last_lines"],
         launches={k: res["launches"][k] for k in SHARDED_EXAMPLE_KERNELS})
    return out


# ---------------------------------------------------------------------------
# the speculative K-way search: K2 s, K8 s and their batched forms
# ---------------------------------------------------------------------------

#: the speculative kernel checks: (n, vector dtype, objective, lanes); the
#: main path's n, and n = 2^14 + 2 (off 16) in f32 and f64 and with the
#: quadratic's two extras (the lasso's under OWL-QN)
SPEC_SOLO_CASES = ((N_BIG, torch.float32, "rosenbrock", SPEC_LANES),
                   ((1 << 14) + 2, torch.float32, "rosenbrock", SPEC_LANES),
                   ((1 << 14) + 2, torch.float64, "rosenbrock", (SPEC_K,)),
                   ((1 << 14) + 2, torch.float32, "quadratic", (SPEC_K,)))
#: timed calls per ``device_time`` in the speculative kernel phase
SPEC_REPS = 10


def _ladder(stp: float, K: int, vd) -> np.ndarray:
    """K steps of the backtracking ladder from stp, in the vectors' dtype."""
    f = np.float32 if vd == torch.float32 else np.float64
    return f(stp) * f(0.5) ** np.arange(K).astype(f)


def _lanes_held(name: str, got: torch.Tensor, want: list, live=None) -> None:
    """Each lane of a K-lane probe bit for bit the one-lane kernel's value
    at its step (the live instances' of a batched one)."""
    for j, w in enumerate(want):
        g = got[..., j] if got.ndim == 2 else got[j]
        if live is not None:
            g, w = g[live].contiguous(), w[live].contiguous()
        if not same_bits(g, w):
            raise AssertionError(f"{name}: lane {j} differs from the one-lane kernel")


def _kernel_only_ms(fn, reps: int, name: str) -> float | None:
    """Device ms per call of fn's kernels whose name holds ``name`` alone
    (the K-lane kernel without its wrapper's torch sums and copies), from
    one profiler session; None where the session came back empty."""
    prof, _ = profiled(lambda: [fn() for _ in range(reps)])
    if prof is None:
        return None
    return sum(e.self_device_time_total for e in device_events(prof)
               if name in e.key) / 1e3 / reps


def phase_speculative_kernels() -> dict:
    """K2 s and K8 s at the lanes of ``SPEC_SOLO_CASES``
    (above ``factory.SPEC_MAX_LANES`` in chunks), each lane bit for bit K2's
    and K8's at its step (at n = 2^24 in both modes of the objective
    scalar), and against their plain versions on the card within the sum
    tolerance (``TOL``); K2 b s and K8 b s at B x n = 1024 x 2^14 with a
    third of the instances frozen, at 2, 4, 8 and 11 lanes, each live
    instance's lane bit for bit K2 b's and K8 b's.  Registers and spills of
    every compiled form (a spill fails).  Then each at SPEC_K lanes timed
    beside its plain version and bound, and at every lane count against
    that many one-lane launches, in turns."""
    k = rosenbrock.value_and_grad.kernels
    errs, times, timed_by, bounds = {}, {}, {}, {}
    lanes_vs_seq, kernel_only = {}, {}
    for n, vd, model, Ks in SPEC_SOLO_CASES:
        a = inputs(n, vd, torch.float32 if vd == torch.float32 else vd, SEED + 30)
        kk = k if model == "rosenbrock" else separable.quadratic(
            *quadratic_data(n, SEED + 31)).kernels
        xp, d, x0, pg = a["xp"], a["d"], a["xp0"], a["pg"]
        lo, hi = windows(n)[0]
        wp = choose_orthant(Orthantwise(C_L1, lo, hi), x0, pg)
        tag = f"{model} {str(vd)[6:]} n={n}"
        tv = TOL[(vd, "sum")]
        for K in Ks:
            steps = _ladder(STP, K, vd)
            modes = (True, False) if n == N_BIG and K == SPEC_K else (False,)
            for wide in modes:
                with fused.wide_fx(wide):
                    f2 = kk.probe_steps(xp, d, steps)
                    _lanes_held(f"K2 s {tag} K={K}", f2, [kk.probe(xp, d, s)[0] for s in steps])
                    f8 = kk.owlqn_probe_steps(x0, d, wp, steps, C_L1, lo, hi)
                    _lanes_held(f"K8 s {tag} K={K}", f8,
                                [kk.owlqn_probe(x0, d, wp, s, C_L1, lo, hi)[0] for s in steps])
            errs.setdefault("K2s_probe_steps", []).append(check(
                f"K2 s {tag}", f2, kk.probe_steps_ref(xp, d, steps), tv))
            errs.setdefault("K8s_owlqn_probe_steps", []).append(check(
                f"K8 s {tag}", f8, kk.owlqn_probe_steps_ref(x0, d, wp, steps, C_L1, lo, hi), tv))
        if n == N_BIG:
            steps = _ladder(STP, SPEC_K, vd)
            k2 = lambda: k.probe_steps(xp, d, steps)
            k8 = lambda: k.owlqn_probe_steps(x0, d, wp, steps, C_L1, lo, hi)
            for name, kern, plain in (
                    ("K2s_probe_steps", k2, lambda: k.probe_steps_ref(xp, d, steps)),
                    ("K8s_owlqn_probe_steps", k8,
                     lambda: k.owlqn_probe_steps_ref(x0, d, wp, steps, C_L1, lo, hi))):
                t = kernel_vs_plain(kern, plain, SPEC_REPS)
                times[name], timed_by[name] = t[:2], t[2:]
                bounds[name] = bound(name, n, 4, 2, M)
                kernel_only[name] = _kernel_only_ms(kern, SPEC_REPS, "probe_steps")
            # every lane count against that many one-lane launches, in turns
            for K in SPEC_LANES:
                steps = _ladder(STP, K, vd)
                turns = {}
                for label, fn in (
                        ("k2_seq", lambda: [k.probe(xp, d, s) for s in steps]),
                        ("k2s", lambda: k.probe_steps(xp, d, steps)),
                        ("k8_seq", lambda: [k.owlqn_probe(x0, d, wp, s, C_L1, lo, hi)
                                            for s in steps]),
                        ("k8s", lambda: k.owlqn_probe_steps(x0, d, wp, steps, C_L1, lo, hi))):
                    turns[label] = device_time(fn, SPEC_REPS)
                lanes_vs_seq[K] = dict(
                    **{f"{key}_ms": v for key, v in turns.items()},
                    k2s_bound_ms=bound("K2_probe", n, 4, 2, M)[0],
                    k8s_bound_ms=bound("K8_owlqn_probe", n, 4, 2, M)[0],
                    k2s_wall_ms=wall_ms(lambda: k.probe_steps(xp, d, steps), SPEC_REPS),
                    k2_seq_wall_ms=wall_ms(lambda: [k.probe(xp, d, s) for s in steps],
                                           SPEC_REPS))
        del a, xp, d, x0, pg, wp
        torch.cuda.empty_cache()
    # the batched forms
    b = batched_inputs(SEED + 32)
    xp, d, live, stp = b["xp"], b["d"], b["live"], b["stp"]
    pg = torch.randn(xp.shape, generator=torch.Generator(device="cuda").manual_seed(SEED + 33),
                     device="cuda")
    lo, hi = 0, BATCH_N - 1
    for K in SPEC_LANES:
        stps = (stp[:, None] * 0.5 ** torch.arange(K, device="cuda")).contiguous()
        cols = [stps[:, j].contiguous() for j in range(K)]
        f2 = k.probe_steps_batched(xp, d, stps, live)
        _lanes_held(f"K2 b s K={K}", f2, [k.probe_batched(xp, d, c, live)[0] for c in cols],
                    live)
        f8 = k.owlqn_probe_pg_steps_batched(xp, d, pg, stps, C_L1, lo, hi, live)
        _lanes_held(f"K8 b s K={K}", f8,
                    [k.owlqn_probe_pg_batched(xp, d, pg, c, C_L1, lo, hi, live)[0] for c in cols],
                    live)
        tv = TOL[(torch.float32, "sum")]
        errs.setdefault("K2bs_probe_steps_batched", []).append(check(
            f"K2 b s K={K}", f2[live], k.probe_steps_batched_ref(xp, d, stps, live)[live], tv))
        errs.setdefault("K8bs_owlqn_probe_steps_batched", []).append(check(
            f"K8 b s K={K}", f8[live],
            k.owlqn_probe_pg_steps_batched_ref(xp, d, pg, stps, C_L1, lo, hi, live)[live], tv))
    every = torch.ones_like(live)
    stps = (stp[:, None] * 0.5 ** torch.arange(SPEC_K, device="cuda")).contiguous()
    for name, kern, plain in (
            ("K2bs_probe_steps_batched", lambda: k.probe_steps_batched(xp, d, stps, every),
             lambda: k.probe_steps_batched_ref(xp, d, stps, every)),
            ("K8bs_owlqn_probe_steps_batched",
             lambda: k.owlqn_probe_pg_steps_batched(xp, d, pg, stps, C_L1, lo, hi, every),
             lambda: k.owlqn_probe_pg_steps_batched_ref(xp, d, pg, stps, C_L1, lo, hi, every))):
        t = kernel_vs_plain(kern, plain, SPEC_REPS)
        times[name], timed_by[name] = t[:2], t[2:]
        bounds[name] = bound(name, BATCH_B * BATCH_N, 4, 2, M)
        kernel_only[name] = _kernel_only_ms(kern, SPEC_REPS, "probe_steps")
    del b, xp, d, pg, stps
    compiled = []
    for label, fn in (("K2s", k.probe_steps), ("K8s", k.owlqn_probe_steps),
                      ("K2bs", k.probe_steps_batched), ("K8bs", k.owlqn_probe_pg_steps_batched)):
        for (vd, lanes), ck in sorted(fn.compiled.items(), key=str):
            compiled.append(dict(kernel=label, vectors=str(vd)[6:], lanes=lanes,
                                 **_compiled_info(ck)))
    emit(phase="speculative_compiled", forms=compiled, max_lanes=factory.SPEC_MAX_LANES)
    if any(c["n_spills"] for c in compiled):
        raise AssertionError(f"K-lane probes spill registers: {compiled}")
    errs = {name: (max(e[0] for e in v), max(e[1] for e in v)) for name, v in errs.items()}
    emit(phase="speculative_kernels", lanes=list(SPEC_LANES), max_lanes=factory.SPEC_MAX_LANES,
         cases=[dict(n=n, vectors=str(vd)[6:], model=m, lanes=list(Ks))
                for n, vd, m, Ks in SPEC_SOLO_CASES],
         batched=dict(B=BATCH_B, n=BATCH_N), lanes_vs_one_lane_kernels="bit-exact",
         max_abs_err={n_: e[0] for n_, e in errs.items()},
         max_normwise_err={n_: e[1] for n_, e in errs.items()},
         device_ms={n_: {"kernel": t_[0], "plain": t_[1], "bound": bounds[n_][0]}
                    for n_, t_ in times.items()},
         timed_by={n_: {"kernel": t_[0], "plain": t_[1]} for n_, t_ in timed_by.items()},
         kernel_only_ms=kernel_only, lanes_vs_sequential_n2e24=lanes_vs_seq)
    torch.cuda.empty_cache()
    return {"errs": errs, "times": times, "bounds": bounds, "timed_by": timed_by}


#: the speculative main path: the main path's widths (n = 2^24, f32, m = 6,
#: bf16 ring, uncapped, epsilon 0, at most 100 iterations) on the Armijo
#: ladder, sequential and with SPEC_K lanes; the OWL-QN main path with
#: SPEC_K lanes.  The Armijo ladder's L-BFGS pairs may lose their
#: curvature, and its searches then start uphill: the reference's ascent
#: warning (one log line a search) is off in these runs
SPEC_SEQ_PARAMS = MAIN_PARAMS.replace_ls(algorithm=LineSearchAlgorithm.BacktrackingArmijo,
                                         warn_ascent=False)
SPEC_PARAMS = SPEC_SEQ_PARAMS.replace_ls(speculative=SPEC_K)
SPEC_OWLQN_PARAMS = OWLQN_PARAMS.replace_ls(speculative=SPEC_K)
#: the order of the timed runs of a speculative phase: the sequential run
#: on the speculative run's route (s), the sequential run with the one-pass
#: epilogue, as the main paths run (e), and the speculative run (p)
SPEC_TURNS = "seppes"
#: what each key of SPEC_TURNS names in the phases' lines
SPEC_SIDES = {"s": "sequential_same_route", "e": "sequential_epilogue", "p": "speculative"}


def epilogue_free(fn):
    """The objective ``fn`` without its one-pass epilogues (K4, K14 and their
    batched forms): a sequential search on it takes the speculative
    search's route, the accepted point materialized by K1 (K7; K1 b, K7 b)
    and the pair by K5 (K12; K5 b, K12 b), so the two runs differ in their
    searches alone."""
    def vag(x):
        return fn(x)

    vag.__dict__.update({k: v for k, v in fn.__dict__.items()
                         if not k.startswith(("__lbfgs_trial_pair_gram",
                                              "__lbfgs_owlqn_trial_pair_gram"))})
    return vag


def _spec_turns(runners: dict) -> dict:
    """One warm run of each of ``runners`` (key -> a run returning its
    state), then the timed runs of ``SPEC_TURNS``, the counts reset before
    each.  Returns key -> [(state, seconds, launches, plain calls, host
    reads, lanes evaluated, carried probes unused), ...]."""
    for run in runners.values():
        run()
    torch.cuda.synchronize()
    k = rosenbrock.value_and_grad.kernels
    out = {key: [] for key in runners}
    for turn in SPEC_TURNS:
        if turn not in runners:
            continue
        reset_counts()
        got = []
        dt = profiling.timed(lambda: got.append(runners[turn]()), warmup=0)
        lanes = sum(getattr(k, f).lanes for f in LANE_PROBES)
        out[turn].append((got[0], dt, launches(), plain_calls(), to_host.reads, lanes,
                          carried.ignored))
    return out


def _same_run(name: str, a, b) -> None:
    """Two solo runs alike: iterations, evaluations, status, fx and x bit
    for bit."""
    if not ((a.k, a.prob.neval, a.status) == (b.k, b.prob.neval, b.status)
            and _bits(np.asarray(a.prob.fx)) == _bits(np.asarray(b.prob.fx))
            and _bits(a.prob.x) == _bits(b.prob.x)):
        raise AssertionError(f"{name}: k/neval/status/fx {a.k}/{a.prob.neval}/{a.status}/"
                             f"{a.prob.fx} against {b.k}/{b.prob.neval}/{b.status}/{b.prob.fx}")


def _spec_report(phase: str, runs: dict, fx_tol: float, **extra) -> dict:
    """The runs side by side: ms per iteration of every turn, reads, probe
    launches, logical and physical evaluations per iteration.  The
    speculative run is held to the sequential run on its route bit for bit
    where ``fx_tol`` is None, else to the same status and fx within fx_tol
    relative; to the sequential run with the epilogue (another pair + Gram
    pass, so another trajectory) by the same status alone."""
    rows = {}
    for side, label in SPEC_SIDES.items():
        if side not in runs:
            continue
        st, _, lc, _, reads, lanes, ignored = runs[side][0]
        iters = st.k - 1
        probes = sum(lc[name] for name in ("K2_probe", "K8_owlqn_probe", "K2s_probe_steps",
                                           "K8s_owlqn_probe_steps"))
        # each trial is one evaluation; the speculative search's physical
        # ones are its lanes and one materialization an iteration
        physical = (lanes + iters) if side == "p" else st.prob.neval - 1
        rows[label] = dict(
            iters=iters, status=st.status, fx=float(st.prob.fx), evals=st.prob.neval,
            ms_per_iter=[1e3 * r[1] / (r[0].k - 1) for r in runs[side]],
            reads_per_iter=reads / iters, probe_launches_per_iter=probes / iters,
            logical_evals_per_iter=(st.prob.neval - 1) / iters,
            physical_evals_per_iter=physical / iters, carried_probes_unused=ignored,
            launches={n_: v for n_, v in lc.items() if v})
    s, p = runs["s"][0][0], runs["p"][0][0]
    rel = abs(float(p.prob.fx) / float(s.prob.fx) - 1) if float(s.prob.fx) else abs(
        float(p.prob.fx))
    out = dict(phase=phase, lanes=SPEC_K, turns=SPEC_TURNS, **rows, rel_fx=rel,
               vs_same_route="bit-exact" if fx_tol is None else dict(fx_tol=fx_tol), **extra)
    emit(**out)
    if fx_tol is None:
        _same_run(phase, p, s)
    elif p.status != s.status or not rel <= fx_tol:
        raise AssertionError(f"{phase}: status {p.status} against the sequential {s.status}, "
                             f"rel fx {rel:.3e} (tol {fx_tol})")
    if "e" in runs and runs["e"][0][0].status != p.status:
        raise AssertionError(f"{phase}: status {p.status} against the epilogue run's "
                             f"{runs['e'][0][0].status}")
    return out


def _spec_rounds(name: str, runs: dict, probe: str, expect) -> dict:
    """The speculative runs' launches: ``expect(iters, rounds)`` for the
    named kernels, nothing else and no plain version; one read per round
    and per iteration after the init's."""
    st, _, lc, pc, reads, lanes, _ = runs["p"][0]
    iters, rounds = st.k - 1, lc[probe]
    if not iters <= rounds <= iters * 19 or reads != 1 + rounds + iters:
        raise AssertionError(f"{name}: {rounds} rounds, {reads} reads in {iters} iterations")
    _expect(name, lc, pc, **expect(iters, rounds))
    return lc


def _solo_runners(seq: LbfgsParams, spec: LbfgsParams, x0, fn=None) -> dict:
    fn = fn or default_evaluate()
    bare = epilogue_free(fn)
    return {"s": lambda: minimize_jit(seq, x0, bare, return_state=True),
            "e": lambda: minimize_jit(seq, x0, fn, return_state=True),
            "p": lambda: minimize_jit(spec, x0, fn, return_state=True)}


def phase_speculative_main_path() -> dict:
    """``SPEC_PARAMS`` at n = 2^24 in turns (``SPEC_TURNS``) with the
    sequential Armijo run on its route (the objective without its
    epilogue), held bit for bit, and with the sequential run through K4
    (the same status).  The speculative run launches K1 at the init and per
    iteration (the accepted point), K2 s per round, K5 and K15 per
    iteration, nothing else; one read per round and per iteration."""
    x0 = rosenbrock.initial_point(N_BIG, torch.float32, "cuda")
    runs = _spec_turns(_solo_runners(SPEC_SEQ_PARAMS, SPEC_PARAMS, x0))
    lc = _spec_rounds("speculative main path", runs, "K2s_probe_steps", lambda it, r: dict(
        K1_trial=it + 1, K2s_probe_steps=r, K5_pair_gram=it, K15_combine_probe=it))
    _spec_report("speculative_main_path", runs, None)
    del runs
    torch.cuda.empty_cache()
    return lc


def phase_speculative_owlqn_main_path() -> dict:
    """``SPEC_OWLQN_PARAMS`` (bench_owlqn.py:61-76's configuration, c = 1 on
    [0, n - 1), epsilon 3e-2) in turns with the sequential OWL-QN run on
    its route (without K14), held bit for bit, and with the OWL-QN main
    path (K14): all CONVERGED.  The speculative run launches K1 and K10 at
    the init, K8 s per round, K7, K10, K12 and K16 per iteration."""
    x0 = rosenbrock.initial_point(N_BIG, torch.float32, "cuda")
    runs = _spec_turns(_solo_runners(OWLQN_PARAMS, SPEC_OWLQN_PARAMS, x0))
    lc = _spec_rounds("speculative OWL-QN main path", runs, "K8s_owlqn_probe_steps",
                      lambda it, r: dict(K1_trial=1, K10_pseudo_gradient_norm=it + 1,
                                         K8s_owlqn_probe_steps=r, K7_owlqn_trial=it,
                                         K12_pair_gram_xg=it, K16_combine_ow_probe=it))
    if runs["p"][0][0].status != Status.CONVERGED:
        raise AssertionError(f"speculative OWL-QN main path: status {runs['p'][0][0].status}")
    _spec_report("speculative_owlqn_main_path", runs, None, eps=OWLQN_PARAMS.epsilon)
    del runs
    torch.cuda.empty_cache()
    return lc


#: the speculative Poisson path: the Poisson main path's configuration
#: (X f32, c = 1 on [1, n), Armijo, uncapped) for 20 iterations
SPEC_POISSON_ITERS = 20
#: its fx against the sequential run's, relative (0 on an H100, where the
#: accepted steps are the sequential run's)
SPEC_POISSON_FX_TOL = 1e-6


def phase_speculative_poisson(data: dict) -> dict:
    """The Poisson regression at 2048 x 2^20 (the Poisson main path's X,
    which stays allocated for the batched Poisson phase) with SPEC_K lanes
    in turns with the sequential run, ``SPEC_POISSON_ITERS`` iterations: a
    generic objective, so each round evaluates its SPEC_K candidate points
    under ``torch.func.vmap`` (the objective's two products with X as
    GEMMs); K11 at the init, K9 (the accepted point), K10, K12 and K13 per
    iteration; the sequential run's iterations and status, finite fx within
    ``SPEC_POISSON_FX_TOL`` of its fx, 0 < nnz < n - 1."""
    obj = data["obj"]
    x0 = torch.zeros(POISSON_NCOL, device="cuda")
    seq = poisson_params(False, SPEC_POISSON_ITERS)
    spec = seq.replace_ls(speculative=SPEC_K)
    runs = _spec_turns({"s": lambda: minimize_jit(seq, x0, obj, return_state=True),
                        "p": lambda: minimize_jit(spec, x0, obj, return_state=True)})
    st, _, lc, pc, reads, _, _ = runs["p"][0]
    iters = st.k - 1
    rounds = reads - 1 - iters
    _expect("speculative Poisson", lc, pc, K11_pseudo_gradient=1, K9_owlqn_trial_step=iters,
            K10_pseudo_gradient_norm=iters, K12_pair_gram_xg=iters, K13_combine_ow=iters)
    nnz = int((st.prob.x[1:] != 0).sum())
    if not (np.isfinite(float(st.prob.fx)) and 0 < nnz < POISSON_NCOL - 1):
        raise AssertionError(f"speculative Poisson: fx {st.prob.fx}, {nnz} nonzero")
    # the candidates' products are one GEMM over the lanes, the sequential
    # search's one GEMV a trial: another summation order, which decides
    # acceptance alone; fx comes from the accepted point's evaluation
    if st.k != runs["s"][0][0].k:
        raise AssertionError(f"speculative Poisson: {iters} iterations against the "
                             f"sequential run's {runs['s'][0][0].k - 1}")
    _spec_report("speculative_poisson", runs, SPEC_POISSON_FX_TOL, nrow=POISSON_NROW,
                 ncol=POISSON_NCOL, rounds_per_iter=rounds / iters, nnz=nnz)
    del runs, st
    torch.cuda.empty_cache()
    return lc


def _spec_batched_runs(seq: LbfgsParams, x0b: torch.Tensor) -> dict:
    """The batched run with SPEC_K lanes in turns with the sequential ones:
    on its route (the objective without its batched epilogue) and through
    the batched epilogue."""
    fn = default_evaluate()
    bare = epilogue_free(fn)
    spec = seq.replace_ls(speculative=SPEC_K)
    return _spec_turns({"s": lambda: minimize_batched(seq, x0b, bare, return_state=True),
                        "e": lambda: minimize_batched(seq, x0b, fn, return_state=True),
                        "p": lambda: minimize_batched(spec, x0b, fn, return_state=True)})


def phase_batched_speculative() -> dict:
    """``minimize_batched`` at 1024 x 2^14 (the batched main path's starts,
    bf16 ring, capped, epsilon 0, 30 iterations), plain and OWL-QN (c = 1
    on [0, n - 1)), on the Armijo ladder with SPEC_K lanes, in turns with
    the sequential runs: K2 b s (K8 b s) per round, K1 b (K7 b, then K10 b)
    and K5 b (K12 b) and K3 b (K13 b) per iteration, nothing else; every fx
    finite.  Then instances 0-7 against their solo speculative runs after 8
    iterations: the same iterations and evaluations, fx rel
    ``FUSION_TOL_8``."""
    x0b = batched_x0(BATCH_B, BATCH_N)
    out = {}
    for label, seq, lanes, expect in (
            ("plain", BATCHED_PARAMS.replace_ls(algorithm=LineSearchAlgorithm.BacktrackingArmijo,
                                                warn_ascent=False),
             "K2bs_probe_steps_batched",
             lambda it, r: dict(K2bs_probe_steps_batched=r, K1b_trial_batched=it,
                                K5b_pair_gram_batched=it, K3b_combine_batched=it)),
            ("owlqn", BATCHED_OWLQN_PARAMS, "K8bs_owlqn_probe_steps_batched",
             lambda it, r: dict(K8bs_owlqn_probe_steps_batched=r, K7b_owlqn_trial_batched=it,
                                K10b_pseudo_gradient_norm_batched=it + 1,
                                K12b_pair_gram_xg_batched=it, K13b_combine_ow_batched=it))):
        name = f"batched speculative {label}"
        runs = _spec_batched_runs(seq, x0b)
        st, walls, lc, pc, reads, lanes_n, _ = runs["p"][0]
        iters = int(st.k.max()) - 1
        rounds = lc[lanes]
        if reads != 1 + rounds + iters or not np.isfinite(st.fx).all():
            raise AssertionError(f"{name}: {rounds} rounds, {reads} reads in {iters} "
                                 f"iterations; fx finite {np.isfinite(st.fx).all()}")
        _expect(name, lc, pc, **expect(iters, rounds))
        # on its route the sequential run is the speculative one bit for bit
        s_st = runs["s"][0][0]
        for field in ("k", "neval", "status", "fx"):
            if not np.array_equal(getattr(s_st, field), getattr(st, field)):
                raise AssertionError(f"{name}: {field} differs from the sequential run on its "
                                     f"route")
        if not same_bits(s_st.x, st.x):
            raise AssertionError(f"{name}: x differs from the sequential run on its route")
        rows = {}
        for side, tag in SPEC_SIDES.items():
            r_st, _, r_lc, _, r_reads, r_lanes, _ = runs[side][0]
            r_it = int(r_st.k.max()) - 1
            inst = int(np.maximum(r_st.k - 1, 0).sum())
            rows[tag] = dict(
                iters=r_it, wall_ms_per_iter=[1e3 * r[1] / r_it for r in runs[side]],
                instance_iters_per_s=[inst / r[1] for r in runs[side]],
                syncs_per_iter=r_reads / r_it,
                evals_per_instance=float(r_st.neval.mean()),
                physical_evals_per_instance=(r_lanes / BATCH_B + r_it) if side == "p" else None,
                fx_median=float(np.median(r_st.fx)),
                status={int(c): int(v) for c, v in zip(*np.unique(r_st.status,
                                                                   return_counts=True))})
        vs_solo = _vs_solo_8(name, seq.replace_ls(speculative=SPEC_K), x0b)
        emit(phase="batched_speculative", path=label, B=BATCH_B, n=BATCH_N, lanes=SPEC_K,
             turns=SPEC_TURNS, **rows, launches={k_: v for k_, v in lc.items() if v},
             vs_same_route="bit-exact", vs_solo=vs_solo, fx_tol=FUSION_TOL_8)
        out[label] = lc
        del runs, st
    del x0b
    torch.cuda.empty_cache()
    return out


def phase_sharded_speculative_world1() -> dict:
    """The speculative main path and OWL-QN main path at n = 2^24 under
    ``kernels_on_mesh`` of an NCCL group of world size 1 in this process,
    each against the same run with no mesh: iterations, evaluations, fx and
    x bit for bit, the same launches (K2 s and K8 s on the rank's shard,
    one collective per round for all its lanes); collectives per
    iteration."""
    init_distributed(init_method=f"tcp://localhost:{_free_port()}", world_size=1, rank=0)
    out = {}
    try:
        mesh = make_mesh()
        if dist.get_backend() != "nccl":
            raise AssertionError(f"world-size-1 mesh on {dist.get_backend()}, not NCCL")
        mesh.all_reduce(torch.zeros(1, device="cuda"))
        for name, params, lanes in (("main_path", SPEC_PARAMS, "K2s_probe_steps"),
                                    ("owlqn_main_path", SPEC_OWLQN_PARAMS,
                                     "K8s_owlqn_probe_steps")):
            x0 = rosenbrock.initial_point(N_BIG, torch.float32, "cuda")
            reset_counts()
            st_s = minimize_jit(params, x0, default_evaluate(), return_state=True)
            lc_s = launches()
            st_m, dt, lc_m, pc_m, reads, coll = _sharded_run(mesh, params, x0)
            same = (st_s.k == st_m.k and st_s.prob.neval == st_m.prob.neval
                    and _bits(np.asarray(st_s.prob.fx)) == _bits(np.asarray(st_m.prob.fx))
                    and _bits(st_s.prob.x) == _bits(st_m.prob.x))
            if not same or lc_s != lc_m or not lc_m[lanes]:
                raise AssertionError(
                    f"sharded speculative {name}: k/neval/fx {st_m.k}/{st_m.prob.neval}/"
                    f"{st_m.prob.fx} against {st_s.k}/{st_s.prob.neval}/{st_s.prob.fx}, "
                    f"launches {lc_m} against {lc_s}")
            iters = st_m.k - 1
            out[name] = dict(iters=iters, evals=st_m.prob.neval, fx=float(st_m.prob.fx),
                             bit_for_bit=True, rounds=lc_m[lanes],
                             collectives_per_iter=coll / iters, syncs_per_iter=reads / iters,
                             ms_per_iter_mesh=1e3 * dt / iters)
            emit(phase="sharded_speculative_world1", path=name, n=N_BIG, world=1,
                 backend="nccl", lanes=SPEC_K, **out[name])
            del st_s, st_m
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    return out


# ---------------------------------------------------------------------------
# the tensor-core epilogues at an n off a multiple of 16, over the ring
# whose row stride is padded to 16 elements
# ---------------------------------------------------------------------------

#: the widths off a multiple of 16 of the ragged phases: solo (n = 2^20 + 2;
#: the paths 2^24 + 2) and batched (1024 x (2^14 + 2))
RAGGED_N, RAGGED_PATH_N, RAGGED_BN = (1 << 20) + 2, (1 << 24) + 2, (1 << 14) + 2
#: the settings the ragged checks take: f32 and f64 rings at m = 80 (the
#: row-block form), a bf16 ring at m = 80 (the one-pass tensor-core form)
#: and at m = 260 (the row-block form); before the padded ring every one
#: of them took the deep fold form at such an n
RAGGED_ROWS = {"_rg_m80": (torch.float32, torch.bfloat16, 80),
               "_rg_m260": (torch.float32, torch.bfloat16, 260),
               "_rg_f64_m80": (torch.float64, torch.float64, 80),
               "_rg_f32_m80": (torch.float32, torch.float32, 80)}
#: the settings the ragged paths run (``phase_ragged_paths``), whose rows
#: the kernel table shows: solo over f32 and bf16 rings, batched over f32,
#: f64 and bf16 rings, m = 80
RAGGED_SOLO_ROWS = ("_rg_f32_m80", "_rg_m80")
RAGGED_BATCHED_ROWS = ("_rg_f32_m80", "_rg_f64_m80", "_rg_m80")
#: instances of the batched ragged checks, which hold four copies of the
#: rings (the timings take ``BATCH_B`` and hold their launches there too,
#: on two copies: ``_hold_timed``)
RAGGED_CHECK_B = 48
#: timed calls of each launch in the ragged phases' turns
RAGGED_REPS = 5
KERNELS.update({
    f"{name}{sfx}": (route, src, f"{rep} (m = {RAGGED_ROWS[sfx][2]}, "
                                 f"{str(RAGGED_ROWS[sfx][0])[6:]}/{str(RAGGED_ROWS[sfx][1])[6:]}"
                                 f", an n off 16 over the padded ring)")
    for name, (route, src, rep) in list(KERNELS.items())
    for sfx in (RAGGED_SOLO_ROWS if name in ("K4_trial_pair_gram", "K14_owlqn_trial_pair_gram")
                else RAGGED_BATCHED_ROWS if name in BATCHED_FOLD_EPILOGUES else ())})
#: K5 b at m = 80 (the batched trial route over a bf16 ring; ``phase_ragged_paths``)
KERNELS["K5b_pair_gram_batched_m80"] = (
    "cuda", "lbfgs_torch/csrc/pair_gram.cu", "lbfgs_tpu/ops/fused.py:837 (m = 80)" + VMAPPED)


def ring_pads_zero(R: torch.Tensor) -> bool:
    """Whether every pad column [n, ld) of a padded ring ([m, n] or [B, m,
    n]) is exactly zero."""
    *lead, n = R.shape
    ld = R.stride(-2)
    rows = int(np.prod(lead))
    return bool((R.as_strided((rows, ld), (ld, 1), R.storage_offset())[:, n:] == 0).all())


def _ld_global(ck) -> dict:
    """The global loads in a compiled Triton kernel's PTX: register loads,
    vector (``.v2``, ``.v4``) and scalar, and the pipelined loads into
    shared memory (``cp.async``) by their bytes: a ring tile that loads in
    16-byte vectors takes ``cp.async`` of 16 bytes."""
    ptx = ck.asm["ptx"]
    loads = re.findall(r"\bld\.global(?:\.[\w:]+)*", ptx)
    vec = [ld for ld in loads if re.search(r"\.v[24]\b", ld)]
    cp = re.findall(r"\bcp\.async\.c[ag]\.shared\.global\s*\[[^\]]*\],\s*\[[^\]]*\],"
                    r"\s*(0x[0-9a-fA-F]+|\d+)", ptx)
    sizes = {}
    for b in cp:
        sizes[str(int(b, 0))] = sizes.get(str(int(b, 0)), 0) + 1
    return dict(ld_global_vector=len(vec), ld_global_scalar=len(loads) - len(vec),
                cp_async_bytes=sizes)


def ragged_inputs(vd, hd, m: int, n: int, B=None, seed: int = SEED + 27) -> dict:
    """Seeded vectors near the Rosenbrock start ([n], or [B, n] with every
    third instance from the third frozen) and rings of m rows in the
    padded layout (``core.as_ring``), made 16 rows at a time."""
    g = torch.Generator(device="cuda").manual_seed(seed + m + n)
    lead = () if B is None else (B,)
    r = lambda *s: torch.randn(*lead, *s, generator=g, device="cuda", dtype=vd)
    a = dict(xp=rosenbrock.initial_point(n, vd, "cuda") + 0.1 * r(n), d=0.1 * r(n), gp=r(n),
             pg=r(n), end=m - 3, window=(5, n - 7))
    a["xp"] = a["xp"].expand(*lead, n).contiguous()
    a["xp0"] = a["xp"].clone()
    a["xp0"][..., ::17] = 0.0
    for ring in ("S", "Y"):
        R = ring_zeros((*lead, m, n), hd, "cuda")
        for j in range(0, m, 16):
            R[..., j:j + 16, :] = (0.1 * r(min(16, m - j), n)).to(hd)
        a[ring] = R
    if B is not None:
        a["stp"] = 0.2 + torch.rand(B, generator=g, device="cuda", dtype=vd)
        a["live"] = torch.ones(B, dtype=torch.bool, device="cuda")
        a["live"][2::3] = False
    return a


def _ragged_calls(k, a: dict, batched: bool) -> dict:
    """name: (wrapper, plain version, call(fn, rings, with_gp, live) ->
    (the vectors it wrote, its outputs)) of K4 and K14 (K4 b and K14 b) on
    copies of a's vectors; the solo launches in place."""
    lo, hi = a["window"]
    end = a["end"]

    def k4(fn, R, gp, live):
        t = dict(xp=a["xp"].clone(), gp=a["gp"].clone())
        if batched:
            out = fn(t["xp"], a["d"], t["gp"], a["stp"], *R, end, live, with_gp=gp)
        else:
            out = fn(t["xp"], a["d"], t["gp"], STP, *R, end, inplace=True, with_gp=gp)
        return t, out

    def k14(fn, R, gp, live):
        t = dict(xp=a["xp0"].clone(), gp=a["gp"].clone(), pg=a["pg"].clone())
        if batched:
            out = fn(t["xp"], a["d"], t["gp"], t["pg"], a["stp"], C_L1, lo, hi, *R, end, live,
                     with_gp=gp)
        else:
            out = fn(t["xp"], a["d"], t["gp"], t["pg"], STP, C_L1, lo, hi, *R, end,
                     inplace=True, with_gp=gp)
        return t, out

    b = "_batched" if batched else ""
    return {
        ("K4b_trial_pair_gram_batched" if batched else "K4_trial_pair_gram"): (
            getattr(k, "trial_pair_gram" + b), getattr(k, f"trial_pair_gram{b}_ref"), k4),
        ("K14b_owlqn_trial_pair_gram_batched" if batched else "K14_owlqn_trial_pair_gram"): (
            getattr(k, "owlqn_trial_pair_gram" + b), getattr(k, f"owlqn_trial_pair_gram{b}_ref"),
            k14),
    }


def _is_sum(u: torch.Tensor, n: int) -> bool:
    """Whether an epilogue's output is a sum (a scalar, a [B] sum, the
    products), not one of its [n] vectors or a changed flag."""
    return u.dtype.is_floating_point and (u.ndim == 0 or u.shape[-1] != n)


def _ragged_pair(a: dict, t: dict, ow: bool, hd):
    """The pair the launch formed from its own outputs, rounded to the
    ring's dtype: s = stp*d (K4) or x - xp (K14), y = g - gp."""
    xp = a["xp0"] if ow else a["xp"]
    if ow:
        s = t["xp"] - xp
    elif "stp" in a:
        s = a["stp"][:, None] * a["d"]
    else:
        s = torch.full((1,), STP, dtype=a["d"].dtype, device="cuda") * a["d"]
    return s, t["gp"] - a["gp"]


def _check_ragged(k, a: dict, m: int, tag: str, batched: bool, errs: dict, rows: list) -> None:
    """K4 and K14 (K4 b and K14 b), each with and without the . gp column,
    at an n off 16 over the padded ring: the tensor-core form the depth
    takes (``factory.solo_epilogue_grid`` / ``batched_epilogue_grid``)
    against the plain version (vectors and sums normwise, the changed flags,
    ring row ``end`` the rounding of the kernel's own pair, the other rows
    kept, frozen instances untouched), against the deep fold form on the
    same values in a ring of row stride n (x, g, pg and the rings bit for
    bit, the sums at the sum tolerance), the pads zero, the . gp launch's
    products against the float64 product of its own operands
    (``BATCHED_ROWS_GAP``); the compiled kernel's registers, spills and
    global loads (a spill fails)."""
    vd, hd = a["xp"].dtype, a["S"].dtype
    tv, ts = TOL[(vd, "vec")], TOL[(vd, "sum")]
    n = a["xp"].shape[-1]
    live = a.get("live")
    sel = (lambda v: v[live]) if batched else (lambda v: v)
    grid = (factory.batched_epilogue_grid(a["xp"].shape[0], n, m, vd, hd) if batched
            else factory.solo_epilogue_grid(n, m, vd, hd))
    want = "mma" if hd == torch.bfloat16 and m <= factory.MMA_MAX_M else "mma_rows"
    if grid.form != want:
        raise AssertionError(f"{tag}: the grid picks {grid.form}, {want} wanted")
    end = a["end"]
    keep = [j for j in range(m) if j != end]
    for base, (kern, ref, call) in _ragged_calls(k, a, batched).items():
        ow = base.startswith("K14")
        vecs = ("xp", "gp", "pg") if ow else ("xp", "gp")
        for gp in (False, True):
            name = base + ("_gp" if gp else "") + tag
            R = (as_ring(a["S"].clone()), as_ring(a["Y"].clone()))
            t, out = call(kern, R, gp, live)
            f = kern.last_form
            info = dict(_compiled_info(f.compiled), **_ld_global(f.compiled))
            if f.form != want or info["n_spills"]:
                raise AssertionError(f"{name}: the {f.form} form ran ({want} wanted), {info}")
            if not all(is_ring(r_) and ring_pads_zero(r_) for r_ in R):
                raise AssertionError(f"{name}: the ring lost its padded layout or its zero pads")
            Rq = (a["S"].clone(), a["Y"].clone())
            tq, outq = call(ref, Rq, gp, live)
            e = [check(f"{name} {v}", sel(t[v]), sel(tq[v]), tv) for v in vecs]
            e += [check(f"{name} sum{i}", sel(u), sel(w), ts) for i, (u, w) in
                  enumerate(zip(out, outq)) if _is_sum(u, n)]
            if not all(torch.equal(sel(u), sel(w)) for u, w in zip(out, outq)
                       if u.dtype == torch.bool):
                raise AssertionError(f"{name}: changed differs from the plain version")
            errs[name] = (max(x[0] for x in e), max(x[1] for x in e))
            s, y = _ragged_pair(a, t, ow, hd)
            rows_ok = (same_bits(sel(R[0][..., end, :]), sel(s.to(hd)))
                       and same_bits(sel(R[1][..., end, :]), sel(y.to(hd)))
                       and same_bits(R[0][..., keep, :], a["S"][..., keep, :])
                       and same_bits(R[1][..., keep, :], a["Y"][..., keep, :]))
            if not rows_ok:
                raise AssertionError(f"{name}: the ring rows are not the rounded pair and the "
                                     f"kept rows")
            if batched and not all(same_bits(t[v][~live], a["xp0" if (ow and v == "xp")
                                                          else v][~live]) for v in vecs):
                raise AssertionError(f"{name} wrote a frozen instance")
            del tq, outq, Rq
            # the deep fold form on the same values in a ring of row stride n
            Rf = (a["S"].contiguous(), a["Y"].contiguous())
            tf, outf = call(kern, Rf, gp, live)
            if kern.last_form.form != "deep":
                raise AssertionError(f"{name}: the {kern.last_form.form} form ran as the fold")
            bits = {v: same_bits(t[v], tf[v]) for v in vecs}
            bits.update(S=torch.equal(R[0], Rf[0]), Y=torch.equal(R[1], Rf[1]))
            if not all(bits.values()):
                raise AssertionError(f"{name} against the deep fold form: {bits}")
            fold_info = dict(_compiled_info(kern.last_form.compiled),
                             **_ld_global(kern.last_form.compiled))
            gap = 0.0
            for i, (u, w) in enumerate(zip(out, outf)):
                if _is_sum(u, n):
                    gap = max(gap, check(f"{name} sum{i} vs the fold form", sel(u), sel(w),
                                         ts)[1])
            del tf, outf, Rf
            row = dict(kernel=f.kernel, name=name, form=f.form, m=m, n=n,
                       programs=f.programs, chunks_per_program=f.tiles,
                       **{key: v for key, v in f.consts.items() if key != "m"}, **info,
                       fold=dict(kernel="deep", **fold_info), vs_fold_sum_gap=gap)
            if gp:
                SP, YP = out[3:5] if ow else (out[4:6] if batched else out[7:9])
                d0 = -(t["pg"] if ow else t["gp"])
                # three live instances: the first, the middle one and the last
                held = torch.nonzero(live).flatten().tolist() if batched else []
                held = [held[0], held[len(held) // 2], held[-1]] if batched else []
                want_p = ([products_f64(R[0][b], R[1][b], s[b], y[b], d0[b], a["gp"][b], end)
                           for b in held] if batched else
                          [products_f64(R[0], R[1], s, y, d0, a["gp"], end)])
                got = [(SP[b], YP[b]) for b in held] if batched else [(SP, YP)]
                row["products_vs_float64"] = max(
                    max(check(f"{name} SP vs float64", g_[0], w_[0], BATCHED_ROWS_GAP[vd])[1],
                        check(f"{name} YP vs float64", g_[1], w_[1], BATCHED_ROWS_GAP[vd])[1])
                    for g_, w_ in zip(got, want_p))
            rows.append(row)
            del t, out, R
            torch.cuda.empty_cache()


def _hold_timed(name: str, kern, ref, call, a: dict, R: tuple, gp: bool, ow: bool, want: str,
                errs: dict) -> None:
    """One batched launch at the timed shape (``BATCH_B`` x (2^14 + 2), a
    third of the instances frozen) on the rings R the timings take, held
    to its plain version on the same values: the form the grid picks with
    no spill, vectors and sums at the tolerances, the changed flags, ring
    row ``end`` the rounding of the launch's own pair (the pads zero), the
    frozen instances' vectors and row untouched, the . gp launch's products
    against the float64 product of its own operands at three instances;
    errs[name] takes the larger error of this and ``_check_ragged``'s."""
    vd, hd = a["xp"].dtype, a["S"].dtype
    tv, ts = TOL[(vd, "vec")], TOL[(vd, "sum")]
    n, end, live = a["xp"].shape[-1], a["end"], a["live"]
    vecs = ("xp", "gp", "pg") if ow else ("xp", "gp")
    row0 = (R[0][:, end].clone(), R[1][:, end].clone())
    t, out = call(kern, R, gp, live)
    f = kern.last_form
    info = _compiled_info(f.compiled)
    if f.form != want or info["n_spills"]:
        raise AssertionError(f"{name} at B = {BATCH_B}: the {f.form} form ran ({want} "
                             f"wanted), {info}")
    s, y = _ragged_pair(a, t, ow, hd)
    if not (same_bits(R[0][live, end], s.to(hd)[live]) and same_bits(R[1][live, end],
                                                                      y.to(hd)[live])
            and same_bits(R[0][~live, end], row0[0][~live])
            and same_bits(R[1][~live, end], row0[1][~live])
            and all(ring_pads_zero(r_) for r_ in R)):
        raise AssertionError(f"{name} at B = {BATCH_B}: ring row end is not the rounded pair "
                             f"(a frozen instance's row untouched), or a pad is not zero")
    if not all(same_bits(t[v][~live], a["xp0" if (ow and v == "xp") else v][~live])
               for v in vecs):
        raise AssertionError(f"{name} at B = {BATCH_B} wrote a frozen instance")
    e = []
    if gp:
        SP, YP = out[3:5] if ow else out[4:6]
        d0 = -(t["pg"] if ow else t["gp"])
        idx = torch.nonzero(live).flatten().tolist()
        for b in (idx[0], idx[len(idx) // 2], idx[-1]):
            wS, wY = products_f64(R[0][b], R[1][b], s[b], y[b], d0[b], a["gp"][b], end)
            check(f"{name} SP[{b}] vs float64", SP[b], wS, BATCHED_ROWS_GAP[vd])
            check(f"{name} YP[{b}] vs float64", YP[b], wY, BATCHED_ROWS_GAP[vd])
    del row0, s, y
    tq, outq = call(ref, R, gp, live)
    e += [check(f"{name} {v} at B = {BATCH_B}", t[v][live], tq[v][live], tv) for v in vecs]
    e += [check(f"{name} sum{i} at B = {BATCH_B}", u[live], w[live], ts)
          for i, (u, w) in enumerate(zip(out, outq)) if _is_sum(u, n)]
    if not all(torch.equal(u[live], w[live]) for u, w in zip(out, outq) if u.dtype == torch.bool):
        raise AssertionError(f"{name} at B = {BATCH_B}: changed differs from the plain version")
    errs[name] = tuple(max(x) for x in zip(errs[name], *e))


def _time_ragged(k, a: dict, m: int, tag: str, batched: bool, times: dict, timed_by: dict,
                 bounds: dict, turns: dict, errs: dict) -> None:
    """Each launch of ``_check_ragged`` timed: its plain version once, then
    in turns against the deep fold form over a ring of row stride n, the
    layout and form such an n took before (fold, padded, padded, fold;
    the launch's time the lesser of its two), with its bound.  Batched,
    the launches are held at this shape too, on the rings the timings take
    (a third of the instances frozen): to the plain version
    (``_hold_timed``), then after the turns to the fold form (x, g, pg and
    both whole rings bit for bit, the sums at the sum tolerance), and the
    rings' kept rows to their values before the first launch (their
    float64 row sums, bit for bit)."""
    vd, hd = a["xp"].dtype, a["S"].dtype
    every = torch.ones_like(a["live"]) if batched else None
    elems = a["xp"].numel()
    n, end = a["xp"].shape[-1], a["end"]
    keep = [j for j in range(m) if j != end]
    R = (a["S"], a["Y"])
    kept = [r_.sum(-1, dtype=torch.float64)[..., keep] for r_ in R]
    want = "mma" if hd == torch.bfloat16 and m <= factory.MMA_MAX_M else "mma_rows"
    calls = _ragged_calls(k, a, batched)
    # the plain versions first: they widen the ring, so the fold form's
    # copy of the rings is made after
    plain_ms = {}
    for base, (kern, ref, call) in calls.items():
        for gp in (False, True):
            name = base + ("_gp" if gp else "") + tag
            plain = lambda ref=ref, call=call, gp=gp: call(ref, R, gp, every)
            plain_ms[name] = (device_time(plain, min(RAGGED_REPS, PLAIN_REPS)),
                              device_time.source)
            bounds[name] = bound(base + ("_gp" if gp else "") + "_m80", elems, vd.itemsize,
                                 hd.itemsize, m)
            if batched:
                _hold_timed(name, kern, ref, call, a, R, gp, base.startswith("K14"), want, errs)
            torch.cuda.empty_cache()
    Rf = (a["S"].contiguous(), a["Y"].contiguous())
    for base, (kern, ref, call) in calls.items():
        for gp in (False, True):
            name = base + ("_gp" if gp else "") + tag
            new = lambda kern=kern, call=call, gp=gp: call(kern, R, gp, every)
            fold = lambda kern=kern, call=call, gp=gp: call(kern, Rf, gp, every)
            f1 = device_time(fold, RAGGED_REPS)
            r1 = device_time(new, RAGGED_REPS)
            r2, by = device_time(new, RAGGED_REPS), device_time.source
            f2 = device_time(fold, RAGGED_REPS)
            times[name] = (min(r1, r2), plain_ms[name][0])
            timed_by[name] = (by, plain_ms[name][1])
            turns[name] = dict(fold_ms=[f1, f2], padded_ms=[r1, r2],
                               share_of_bound=bounds[name][0] / min(r1, r2),
                               fold_share_of_bound=bounds[name][0] / min(f1, f2))
            if batched:
                live = a["live"]
                t, out = call(kern, R, gp, live)
                tf, outf = call(kern, Rf, gp, live)
                if kern.last_form.form != "deep":
                    raise AssertionError(f"{name}: the {kern.last_form.form} form ran as the "
                                         f"fold")
                vecs = ("xp", "gp", "pg") if base.startswith("K14") else ("xp", "gp")
                bits = {v: same_bits(t[v], tf[v]) for v in vecs}
                bits.update(S=torch.equal(R[0], Rf[0]), Y=torch.equal(R[1], Rf[1]))
                if not all(bits.values()):
                    raise AssertionError(f"{name} at B = {BATCH_B} against the deep fold form: "
                                         f"{bits}")
                for i, (u, w) in enumerate(zip(out, outf)):
                    if _is_sum(u, n):
                        turns[name]["vs_fold_sum_gap"] = max(
                            turns[name].get("vs_fold_sum_gap", 0.0),
                            check(f"{name} sum{i} vs the fold form at B = {BATCH_B}",
                                  u[live], w[live], TOL[(vd, "sum")])[1])
                del t, out, tf, outf
    if not all(torch.equal(r_.sum(-1, dtype=torch.float64)[..., keep], k_)
               for r_, k_ in zip(R, kept)):
        raise AssertionError(f"{tag}: a launch changed a ring row other than row end")
    del Rf
    torch.cuda.empty_cache()


def _check_k5b_m80(errs: dict, rows: list, times: dict, timed_by: dict, bounds: dict) -> None:
    """K5 b (each with and without the . gp column) at m = 80 over a bf16
    ring: at 1024 x 2^14 (rings of row stride n) and at 1024 x (2^14 + 2)
    over the padded ring, against its plain version (its products at the
    sum tolerance, the ring rows bit for bit, the pads zero), timed beside
    the plain version at 1024 x 2^14 with its bound."""
    vd, hd, m = torch.float32, torch.bfloat16, DEEP_M
    ts = TOL[(vd, "sum")]
    for n, padded in ((BATCH_N, False), (RAGGED_BN, True)):
        a = ragged_inputs(vd, hd, m, n, BATCH_B)
        if not padded:
            a["S"], a["Y"] = a["S"].contiguous(), a["Y"].contiguous()
        s = a["stp"][:, None] * a["d"]
        gx = a["gp"] + 0.1 * a["pg"]
        for gp in (False, True):
            name = "K5b_pair_gram_batched" + ("_gp" if gp else "") + "_m80" + (
                "_rg" if padded else "")
            Rk = (a["S"].clone(), a["Y"].clone()) if not padded else (as_ring(a["S"].clone()),
                                                                     as_ring(a["Y"].clone()))
            Rq = (a["S"].clone(), a["Y"].clone())
            out = fused.pair_gram_sd_batched(a["stp"], a["d"], gx, a["gp"], *Rk, a["end"],
                                             a["live"], with_gp=gp)
            ref = fused.pair_gram_sd_batched_ref(a["stp"], a["d"], gx, a["gp"], *Rq, a["end"],
                                                 a["live"], with_gp=gp)
            live = a["live"]
            e = [check(f"{name} {i}", u[live], w[live], ts) for i, (u, w) in
                 enumerate(zip(out, ref))]
            if not (torch.equal(Rk[0], Rq[0]) and torch.equal(Rk[1], Rq[1])):
                raise AssertionError(f"{name}: the ring rows differ from the plain version's")
            if padded and not all(ring_pads_zero(r_) for r_ in Rk):
                raise AssertionError(f"{name}: a pad column is not zero")
            errs[name] = (max(x[0] for x in e), max(x[1] for x in e))
            row = dict(kernel=name, n=n, m=m, B=int(a["xp"].shape[0]), padded=padded,
                       ring_stride=Rk[0].stride(-2), normwise=errs[name][1])
            if not padded:
                call = lambda gp=gp: fused.pair_gram_sd_batched(
                    a["stp"], a["d"], gx, a["gp"], a["S"], a["Y"], a["end"], a["live"],
                    with_gp=gp)
                plain = lambda gp=gp: fused.pair_gram_sd_batched_ref(
                    a["stp"], a["d"], gx, a["gp"], a["S"], a["Y"], a["end"], a["live"],
                    with_gp=gp)
                k_ms, p_ms, k_by, p_by = kernel_vs_plain(call, plain, RAGGED_REPS)
                key = "K5b_pair_gram_batched" + ("_gp" if gp else "") + "_m80"
                times[key], timed_by[key] = (k_ms, p_ms), (k_by, p_by)
                bounds[key] = bound("K5b_pair_gram_batched" + ("_gp" if gp else "") + "_m80",
                                    a["xp"].numel(), vd.itemsize, hd.itemsize, m)
                row.update(ms=k_ms, plain_ms=p_ms, bound_ms=bounds[key][0],
                           share_of_bound=bounds[key][0] / k_ms)
            rows.append(row)
            del Rk, Rq, out, ref
        del a, s, gx
        torch.cuda.empty_cache()


def _check_ragged_extras(errs: dict, rows: list) -> None:
    """The extras forms at an n off 16 over the padded ring: the quadratic's
    K4 (``K4_trial_pair_gram_ex``) and K14 (the lasso's,
    ``K14_owlqn_trial_pair_gram_ex``), each with and without the . gp
    column, at n = 2^20 + 2 with a bf16 ring of 80 rows (the tensor-core
    form) against their plain versions: vectors and sums normwise, the
    ring row the rounded pair, the other rows kept, the pads zero."""
    vd, hd, m, n = torch.float32, torch.bfloat16, DEEP_M, RAGGED_N
    g = torch.Generator(device="cuda").manual_seed(SEED + 29)
    w = 0.5 + torch.rand(n, generator=g, device="cuda")
    tq = torch.randn(n, generator=g, device="cuda")
    q = separable.quadratic(w, tq).kernels
    a = ragged_inputs(vd, hd, m, n)
    tv, ts = TOL[(vd, "vec")], TOL[(vd, "sum")]
    for base, (kern, ref, call) in _ragged_calls(q, a, False).items():
        ow = base.startswith("K14")
        for gp in (False, True):
            name = base + ("_gp" if gp else "") + "_ex_rg"
            R = (as_ring(a["S"].clone()), as_ring(a["Y"].clone()))
            t, out = call(kern, R, gp, None)
            form, info = kern.last_form.form, _compiled_info(kern.last_form.compiled)
            if form != "mma" or info["n_spills"]:
                raise AssertionError(f"{name}: the {form} form ran, {info}")
            Rq = (a["S"].clone(), a["Y"].clone())
            tr, outr = call(ref, Rq, gp, None)
            vecs = ("xp", "gp", "pg") if ow else ("xp", "gp")
            e = [check(f"{name} {v}", t[v], tr[v], tv) for v in vecs]
            e += [check(f"{name} sum{i}", u, v_, ts) for i, (u, v_) in enumerate(zip(out, outr))
                  if _is_sum(u, n)]
            s, y = _ragged_pair(a, t, ow, hd)
            keep = [j for j in range(m) if j != a["end"]]
            if not (same_bits(R[0][a["end"]], s.to(hd)) and same_bits(R[1][a["end"]], y.to(hd))
                    and same_bits(R[0][keep], a["S"][keep])
                    and all(ring_pads_zero(r_) for r_ in R)):
                raise AssertionError(f"{name}: the ring rows or pads are wrong")
            errs[name] = (max(x[0] for x in e), max(x[1] for x in e))
            rows.append(dict(kernel=kern.last_form.kernel, name=name, n=n, m=m, form=form,
                             **info, normwise=errs[name][1]))
            del t, out, tr, outr, R, Rq
    del a, q, w, tq
    torch.cuda.empty_cache()


def phase_ragged_kernels() -> dict:
    """K4, K14, K4 b and K14 b (each with and without the . gp column) at an
    n off a multiple of 16 over the padded ring, at each ``RAGGED_ROWS``
    setting: solo at n = 2^20 + 2 and batched at ``RAGGED_CHECK_B`` x
    (2^14 + 2), a third of the instances frozen (``_check_ragged``), then
    solo at 2^20 + 2 and batched at 1024 x (2^14 + 2), every instance live,
    timed against the plain version and in turns against the deep fold form
    over a ring of row stride n (``_time_ragged``), the batched launches
    held at that shape too (``_hold_timed``, and the fold form after the
    turns); the solo launches held again at the paths' n = 2^24 + 2
    (``RAGGED_SOLO_ROWS``); the extras forms at n = 2^20 + 2
    (``_check_ragged_extras``) and K5 b at m = 80 (``_check_k5b_m80``).
    Returns the table's errs, times, bounds and timers for the rows the
    ragged paths run."""
    k = rosenbrock.value_and_grad.kernels
    errs, rows = {}, []
    times, timed_by, bounds, turns = {}, {}, {}, {}
    for sfx, (vd, hd, m) in RAGGED_ROWS.items():
        for batched in (False, True):
            a = ragged_inputs(vd, hd, m, RAGGED_BN if batched else RAGGED_N,
                              RAGGED_CHECK_B if batched else None)
            _check_ragged(k, a, m, sfx, batched, errs, rows)
            del a
            torch.cuda.empty_cache()
            a = ragged_inputs(vd, hd, m, RAGGED_BN if batched else RAGGED_N,
                              BATCH_B if batched else None)
            _time_ragged(k, a, m, sfx, batched, times, timed_by, bounds, turns, errs)
            del a
            torch.cuda.empty_cache()
    # the solo launches at the ragged paths' width (2^24 + 2: more chunks a
    # program than at 2^20 + 2), held as at 2^20 + 2
    for sfx in RAGGED_SOLO_ROWS:
        vd, hd, m = RAGGED_ROWS[sfx]
        a = ragged_inputs(vd, hd, m, RAGGED_PATH_N)
        path_errs = {}
        _check_ragged(k, a, m, sfx, False, path_errs, rows)
        for name, e in path_errs.items():
            errs[name] = tuple(max(x) for x in zip(errs[name], e))
        del a
        torch.cuda.empty_cache()
    extras, k5b = [], []
    _check_ragged_extras(errs, extras)
    _check_k5b_m80(errs, k5b, times, timed_by, bounds)
    emit(phase="ragged_kernels", n=RAGGED_N, B=BATCH_B, batched_n=RAGGED_BN,
         checked_B=RAGGED_CHECK_B,
         settings={sfx: dict(vectors=str(vd)[6:], rings=str(hd)[6:], m=m,
                             ring_stride=ring_stride(RAGGED_N))
                   for sfx, (vd, hd, m) in RAGGED_ROWS.items()},
         tol=dict(vec={str(v)[6:]: TOL[(v, "vec")] for v in (torch.float32, torch.float64)},
                  sum={str(v)[6:]: TOL[(v, "sum")] for v in (torch.float32, torch.float64)},
                  products_vs_float64={str(v)[6:]: g for v, g in BATCHED_ROWS_GAP.items()},
                  ring_rows="bit-exact", frozen="bit-exact",
                  vs_fold_form_x_g_pg_rings="bit-exact"),
         max_normwise_err={n_: e[1] for n_, e in errs.items()}, forms=rows,
         extras=extras, k5b_m80=k5b,
         device_ms={n_: {"kernel": v[0], "plain": v[1], "bound": bounds[n_][0], **turns.get(
             n_, {"share_of_bound": bounds[n_][0] / v[0]})} for n_, v in times.items()},
         timed_by={n_: {"kernel": v[0], "plain": v[1]} for n_, v in timed_by.items()})
    table = {n_ for n_ in KERNELS if n_ in times}
    return {"errs": {n_: errs[n_] for n_ in table},
            "times": {n_: times[n_] for n_ in table},
            "bounds": {n_: bounds[n_] for n_ in table},
            "timed_by": {n_: timed_by[n_] for n_ in table}}


#: the iterations of each ragged path
RAGGED_ITERS = 11


def phase_ragged_paths() -> dict:
    """The main paths' settings at an n off a multiple of 16, m = 80, 10
    iterations each: solo ``minimize_jit`` at n = 2^24 + 2 over f32 and
    bf16 rings (``RAGGED_SOLO_ROWS``) through the deep-history path's plain
    and OWL-QN settings (``_deep_run``: every K4 and K14 launch in the
    tensor-core form the ring takes, the one-pass form over bf16, the
    row-block form over f32), and ``minimize_batched`` at 1024 x (2^14 + 2)
    over f32, f64 and bf16 rings (``RAGGED_BATCHED_ROWS``) through the
    batched deep phase's settings, every K4 b and K14 b launch in the
    tensor-core form, instances 0-7 held to solo runs (``_vs_solo_8``);
    after each path the rings' layout and zero pads.  Then K5 b at m = 80:
    the batched trial route (``trial_only_objective``) at 1024 x 2^14 over
    a bf16 ring.  Returns each row's launches."""
    k = rosenbrock.value_and_grad.kernels
    lc_rows = {}

    def held(label, st):
        R = (st.hist.s, st.hist.y)
        if not all(is_ring(r_) and r_.stride(-2) == ring_stride(r_.shape[-1])
                   and ring_pads_zero(r_) for r_ in R):
            raise AssertionError(f"{label}: the rings lost the padded layout or a pad is not "
                                 f"zero")

    for sfx in RAGGED_SOLO_ROWS:
        vd, hd, m = RAGGED_ROWS[sfx]
        form = "mma" if hd == torch.bfloat16 else "mma_rows"
        x0 = rosenbrock.initial_point(RAGGED_PATH_N, vd, "cuda")
        for name, kern, fn in (("plain", "K4_trial_pair_gram", k.trial_pair_gram),
                               ("owlqn", "K14_owlqn_trial_pair_gram", k.owlqn_trial_pair_gram)):
            params = DEEP_CONFIGS[name].replace(m=m, history_dtype=str(hd)[6:],
                                                max_iterations=RAGGED_ITERS)
            if name == "owlqn":
                params = params.replace(orthantwise=Orthantwise(1.0, 0, RAGGED_PATH_N - 1))
            st, dt, lc, reads, _ = _deep_run("ragged path", name, params, x0, "epilogue",
                                             form=form)
            held(f"ragged path {name}{sfx}", st)
            lc_rows[kern + sfx] = fn.mma_launches if form == "mma" else fn.mma_rows_launches
            emit(phase="ragged_path", config=name, row=kern + sfx, n=RAGGED_PATH_N, m=m,
                 vectors=str(vd)[6:], rings=str(hd)[6:], form=form,
                 ring_stride=st.hist.s.stride(0), iters=st.k - 1, evals=st.prob.neval,
                 status=st.status, fx=float(st.prob.fx), seconds=dt,
                 ms_per_iter=1e3 * dt / (st.k - 1), syncs_per_iter=reads / (st.k - 1))
            del st
        del x0
        torch.cuda.empty_cache()
    for sfx in RAGGED_BATCHED_ROWS:
        vd, hd, m = RAGGED_ROWS[sfx]
        form = "mma" if hd == torch.bfloat16 else "mma_rows"
        for label, (params, path, init) in BATCHED_DEEP_PARAMS.items():
            params = params.replace(m=m, history_dtype=str(hd)[6:],
                                    max_iterations=RAGGED_ITERS)
            fn = k.owlqn_trial_pair_gram_batched if label == "owlqn" else \
                k.trial_pair_gram_batched
            row = BATCHED_FOLD_EPILOGUES[label == "owlqn"] + sfx
            st, walls, lc, pc, reads, iters, x0b = _batched_run(
                f"batched ragged {label}{sfx}", params, BATCH_B, RAGGED_BN, path, init, runs=1,
                dtype=vd)
            count = fn.mma_launches if form == "mma" else fn.mma_rows_launches
            if count != lc[path[1]] or fn.last_form.form != form:
                raise AssertionError(f"batched ragged {label}{sfx}: {count} {form} launches of "
                                     f"{lc[path[1]]} epilogues")
            held(f"batched ragged {label}{sfx}", st)
            lc_rows[row] = count
            _batched_report(f"batched_ragged_{label}{sfx}", st, walls, lc, reads, iters, path,
                            m=m, vectors=str(vd)[6:], rings=str(hd)[6:], plain_calls=pc,
                            form=form, tensor_core_launches=count,
                            ring_stride=st.hist.s.stride(1),
                            instances=_vs_solo_8(f"batched ragged {label}{sfx}", params, x0b))
            del st, x0b
            torch.cuda.empty_cache()
    # K5 b at m = 80: the batched trial route over a bf16 ring
    params = BATCHED_PARAMS.replace(m=DEEP_M, max_iterations=RAGGED_ITERS)
    x0b = batched_x0(BATCH_B, BATCH_N)
    fn = trial_only_objective()
    minimize_batched(params.replace(max_iterations=3), x0b, fn)
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st = minimize_batched(params, x0b, fn, return_state=True)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    lc = launches()
    iters = int(st.k.max()) - 1
    if lc["K5b_pair_gram_batched"] != iters or not np.isfinite(st.fx).all():
        raise AssertionError(f"K5 b m80 path: {lc['K5b_pair_gram_batched']} K5 b launches in "
                             f"{iters} iterations")
    lc_rows["K5b_pair_gram_batched_m80"] = lc["K5b_pair_gram_batched"]
    emit(phase="ragged_path", config="k5b_m80", B=BATCH_B, n=BATCH_N, m=DEEP_M, iters=iters,
         seconds=dt, launches={key: v for key, v in lc.items() if v},
         fx_median=float(np.median(st.fx)))
    del st, x0b
    torch.cuda.empty_cache()
    return lc_rows


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", metavar="PATH",
                    help="also profile one run of each main path; operator tables to PATH")
    ap.add_argument("--sharded-rank", nargs=3, metavar=("RANK", "PORT", "OUTDIR"),
                    help=argparse.SUPPRESS)
    ap.add_argument("--warm", nargs=2, type=int, metavar=("PART", "PARTS"),
                    help=argparse.SUPPRESS)
    ap.add_argument("--example-sharded", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.warm:
        warm_part(*args.warm)
        return
    if args.example_sharded:
        torch.backends.cuda.matmul.allow_tf32 = False
        example_sharded()
        return
    if args.sharded_rank:
        torch.backends.cuda.matmul.allow_tf32 = False
        rank, port, outdir = args.sharded_rank
        sharded_rank(int(rank), int(port), outdir)
        return
    seconds, timing = {}, {}

    def run(fn, *a):
        t0, before = time.perf_counter(), dict(TIMING_COST)
        out = fn(*a)
        name = fn.__name__.removeprefix("phase_")
        seconds[name] = round(time.perf_counter() - t0, 3)
        spent = {k: round(v - before[k], 3) for k, v in TIMING_COST.items()}
        timing[name] = spent
        # each phase's seconds as it ends (the timing line comes at the end)
        print(f"phase {name}: {seconds[name]} s {spent}", file=sys.stderr, flush=True)
        return out

    run(phase_device)
    run(phase_build)
    k = run(phase_kernels)
    run(phase_goldens)
    run(phase_owlqn_golden)
    lc_main, main_out = run(phase_main_path)
    lc_ow, ow_out = run(phase_owlqn_main_path)
    run(phase_north_star)
    run(phase_damped_n100)
    run(phase_lj38)
    lc_d, d_out = run(phase_damped_main_path, main_out["syncs_per_iter"])
    run(phase_gradient_only_main_path)
    lc_dow = run(phase_damped_owlqn_main_path)
    lc_k5 = run(phase_k5_route)
    lc_k12 = run(phase_k12_route)
    run(phase_wide_kernels)
    lc_poisson, poisson_out, poisson_data = run(phase_poisson_main_path)
    lc_spec_poisson = run(phase_speculative_poisson, poisson_data)
    run(phase_batched_poisson, poisson_data)
    run(phase_poisson_bf16_main_path, poisson_out)
    run(phase_poisson_f64_vs_cpu)
    run(phase_f32_floor)
    lc_wide = run(phase_wide_owlqn_main_path)
    run(phase_owlqn_north_star)
    lc_un, un_out = run(phase_unfused_main_path, main_out)
    lc_unow, unow_out = run(phase_unfused_owlqn_main_path, ow_out)
    run(phase_adaptive_entry, ow_out)
    lc_und = run(phase_unfused_damped_main_path, d_out)
    lc_quad, _ = run(phase_quadratic_main_path)
    lc_lasso, _ = run(phase_lasso_main_path)
    lc_lasso_var = run(phase_lasso_variants)
    lc_quartic, _ = run(phase_damped_quartic_main_path)
    lc_deep, deep = run(phase_deep_history)
    run(phase_deep_main_path)
    run(phase_solo_mma_kernels)
    lc_fold = run(phase_deep_fold_paths)
    run(phase_booth)
    run(phase_scan)
    run(phase_float16_history)
    run(phase_native)
    run(phase_checkpoint)
    batched = run(phase_batched_kernels)
    lc_batched, batched_out = run(phase_batched_main_path)
    run(phase_batched_baseline)
    batched_ow = run(phase_batched_owlqn_kernels)
    lc_batched_ow, batched_ow_out = run(phase_batched_owlqn_main_path, batched_out)
    batched_fu = run(phase_batched_fusion_kernels)
    run(phase_batched_mma_rules)
    batched_fold = run(phase_batched_fold_kernels)
    lc_bu, bu_out = run(phase_batched_uncapped_main_path, batched_out)
    lc_bowu, bowu_out = run(phase_batched_owlqn_uncapped_main_path, batched_ow_out)
    lc_bdeep = run(phase_batched_deep)
    batched_dm = run(phase_batched_damped_kernels)
    lc_bd = run(phase_batched_damped_main_path, {
        "capped": batched_out, "owlqn_capped": batched_ow_out,
        "uncapped": bu_out["literal"]["fused"], "owlqn_uncapped": bowu_out["fused"]})
    lc_b80 = run(phase_batched_m80)
    lc_bfold = run(phase_batched_fold_paths)
    ragged = run(phase_ragged_kernels)
    lc_ragged = run(phase_ragged_paths)
    batched_gen = run(phase_batched_generic_kernels)
    run(phase_batched_generic_main_path)
    lc_bgow = run(phase_batched_generic_owlqn_main_path)
    batched_tr = run(phase_batched_trial_kernels)
    run(phase_batched_wide_main_path)
    lc_bscan = run(phase_batched_scan_main_path)
    run(phase_batched_float16_main_path)
    lc_btrial = run(phase_batched_trial_route_main_path)
    world1 = run(phase_sharded_world1)
    run(phase_sharded_two_rank, {"main_path": main_out, "owlqn_main_path": ow_out,
                                 "damped_main_path": d_out, "generic": world1["generic"]})
    run(phase_examples)
    spec = run(phase_speculative_kernels)
    lc_spec = run(phase_speculative_main_path)
    lc_spec_ow = run(phase_speculative_owlqn_main_path)
    lc_spec_b = run(phase_batched_speculative)
    run(phase_sharded_speculative_world1)
    for key in ("errs", "times", "bounds", "timed_by"):
        k[key].update(spec[key])
        k[key].update(deep[key])
        k[key].update(batched[key])
        k[key].update(batched_ow[key])
        k[key].update(batched_fu[key])
        k[key].update(batched_fold[key])
        k[key].update(batched_dm[key])
        k[key].update(batched_gen[key])
        k[key].update(batched_tr[key])
        k[key].update(ragged[key])
    lc_cal = run(phase_launch_overhead, {
        name: (params, fused, out["ms_per_iter"], out["syncs_per_iter"])
        for name, params, fused, out in (
            ("main_path", MAIN_PARAMS, True, main_out),
            ("owlqn_main_path", OWLQN_PARAMS, True, ow_out),
            ("main_path_unfused", MAIN_PARAMS, False, un_out),
            ("owlqn_main_path_unfused", OWLQN_PARAMS, False, unow_out))})
    if args.profile:
        run(phase_profile, args.profile)
    emit(phase="timing", seconds=seconds, profiler_misses=PROFILER_MISSES,
         timing_cost=TIMING_COST, timing_cost_by_phase=timing)
    # each kernel's launches on its own path; K17 lies on no solver path,
    # and its count is the main path's run's, which stays 0
    lc = {**{name: lc_main[name] for name in PLAIN_PATH},
          **{name: lc_ow[name] for name in OWLQN_PATH if name not in PLAIN_PATH},
          **{name: lc_d[name] for name in DAMPED_PATH},
          **{name: lc_dow[name] for name in DAMPED_OWLQN_PATH},
          **{name: lc_k5[name] for name in K5_PATH},
          **{name: lc_k12[name] for name in K12_PATH},
          **{name: lc_poisson[name] for name in POISSON_PATH},
          **{name: lc_wide[name] for name in WIDE_OWLQN_PATH},
          **{name: lc_un[name] for name in UNFUSED_PATH},
          **{name: lc_unow[name] for name in UNFUSED_OWLQN_PATH},
          **{name: lc_und[name] for name in UNFUSED_DAMPED_PATH},
          **{name: lc_quad[name] for name in QUADRATIC_PATH},
          **{name: lc_lasso[name] for name in LASSO_PATH},
          **{name: lc_quartic[name] for name in QUARTIC_PATH},
          **{name: lc_lasso_var[name] for name in LASSO_VARIANTS_PATH}, **lc_deep, **lc_fold,
          **{name: lc_batched[name] for name in BATCHED_PATH},
          **{name: lc_batched_ow[name] for name in BATCHED_OWLQN_PATH + BATCHED_OWLQN_INIT},
          "K15b_combine_probe_batched": lc_bu["K15b_combine_probe_batched"],
          "K16b_combine_ow_probe_batched": lc_bowu["K16b_combine_ow_probe_batched"],
          **lc_bdeep, **lc_bfold, **lc_ragged,
          # the damped batched forms from the damped main paths (m = 6) and
          # the m = 80 runs, K3 b and K13 b at m = 80 from the capped ones
          **{name: lc_bd[label][name] for label, name in (
              ("damped", "K4b_trial_pair_gram_batched_gp"), ("damped", "K6b_combine_fix_batched"),
              ("damped_uncapped", "K15b_combine_probe_batched_fix"),
              ("owlqn_damped", "K14b_owlqn_trial_pair_gram_batched_gp"))},
          **{name + "_m80": lc_b80[label][name + m80] for label, name, m80 in (
              ("capped", "K3b_combine_batched", ""), ("owlqn_capped", "K13b_combine_ow_batched", ""),
              ("damped", "K4b_trial_pair_gram_batched_gp", "_m80"),
              ("damped", "K6b_combine_fix_batched", ""),
              ("damped_uncapped", "K15b_combine_probe_batched_fix", "_m80"),
              ("owlqn_damped", "K14b_owlqn_trial_pair_gram_batched_gp", "_m80"))},
          # the generic objectives' forms from the batched generic OWL-QN
          # main path (capped), K12 b at m = 80 from its m80 run
          **{name: lc_bgow["capped"][name] for name in (
              "K9b_owlqn_trial_step_batched", "K11b_pseudo_gradient_batched",
              "K12b_pair_gram_xg_batched")},
          "K12b_pair_gram_xg_batched_m80": lc_bgow["m80"]["K12b_pair_gram_xg_batched"],
          # the materializations from the batched scan paths, K5 b from the
          # trial-only objective's plain and damped runs
          "K1b_trial_batched": lc_bscan["plain"]["K1b_trial_batched"],
          "K7b_owlqn_trial_batched": lc_bscan["owlqn"]["K7b_owlqn_trial_batched"],
          "K5b_pair_gram_batched": lc_btrial["plain"]["K5b_pair_gram_batched"],
          "K5b_pair_gram_batched_gp": lc_btrial["damped"]["K5b_pair_gram_batched_gp"],
          "K17_axpy_dot": lc_main["K17_axpy_dot"],
          # the K-lane probes from the speculative main paths, solo and batched
          "K2s_probe_steps": lc_spec["K2s_probe_steps"],
          "K8s_owlqn_probe_steps": lc_spec_ow["K8s_owlqn_probe_steps"],
          "K2bs_probe_steps_batched": lc_spec_b["plain"]["K2bs_probe_steps_batched"],
          "K8bs_owlqn_probe_steps_batched": lc_spec_b["owlqn"]["K8bs_owlqn_probe_steps_batched"],
          **lc_cal}
    # library_ms: one PyTorch call computing the same function, where one
    # exists (only the calibration kernel's o = x + 1)
    table = [
        dict(name=name, route=route, source=src, replaces=rep, launches=lc[name],
             max_abs_err=k["errs"][name][0], max_normwise_err=k["errs"][name][1],
             ms=k["times"][name][0], plain_ms=k["times"][name][1],
             ms_timed_by=k["timed_by"][name][0], plain_ms_timed_by=k["timed_by"][name][1],
             bound_ms=k["bounds"][name][0], bound_by=k["bounds"][name][1],
             library_ms=k["library"].get(name))
        for name, (route, src, rep) in KERNELS.items()
    ]
    print(json.dumps({"kernels": table}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
