#!/usr/bin/env python3
"""Drive the PyTorch port's main paths once on one CUDA card and check them.

    python3 chip_smoke.py

The flagship model: RNODE, nvars = 8, naug = 8, MLP 16 -> 48 -> 16 with
tanh, lambda1 = lambda2 = lambda3 = 1e-2, steer_rate 0.1, tspan (0, 13),
tsit5 at rtol 1e-3 / atol 1e-6, one Gaussian VJP Hutchinson probe, batch
4096.  Weights are random, made from a seed with numpy; the configurations
and their weight and data recipes are those of
continuousnf_tpu_torch/utils/configs.py.  The main paths:
  * serving: `ICNFDist(icnf, Mode.TEST, ps).logpdf` and `.sample`, whose
    solve runs in K3;
  * training: `fit(ICNFModel(icnf, n_epochs=1, batch_size=4096), X)` on
    4 x 4096 samples, four Lion steps whose forward solve runs in K1 and
    whose BACKSOLVE adjoint runs in K2;
  * exact training: the same `fit` on the same model with
    `VecJacMode(fused=True, exact_trace=True)` (no probes: the exact trace
    and ||J||_F), whose forward solve runs in the K4 forward kernel and
    whose adjoint runs in the K4 adjoint kernel;
  * the deep chain: the tabular power6 model of benchmarks/tabular.py
    (RNODE, nvars = 6, MLP 6 -> 64 -> 64 -> 6 tanh, lambda1 = lambda2 =
    1e-2, tspan (0, 1), no steering, one VJP probe, batch 4096) served
    through K7 TEST, trained through the K1 and K2 chain forms and, under
    exact trace, through the K7 exact forward with the plain backward;
  * the conditional recipe of continuousnf_tpu/recipes.py:254-289 (BASELINE
    config #3: CondRNODE, nvars = 1, one conditioning input y, MLP
    2 -> 64 -> 64 -> 1 tanh on [x | y], lambda1 = lambda2 = 1e-2, tspan
    (0, 13), steer_rate 0.1, data y ~ U(-1, 1), x | y ~ N(0.7 y, 0.3^2)):
    `CondICNFDist(icnf, Mode.TEST, ps, ys).logpdf` at B = 4096 with per-sample
    ys and `.sample(4096)` with one ys, through K7 TEST with conditioning
    rows (K8); `fit(CondICNFModel(icnf, n_epochs=1, batch_size=128), X, Y)`
    on 512 samples, four Lion steps through the K1 and K2 chain forms with
    conditioning rows and the ys cotangent; under exact trace the K7 exact
    forward with conditioning rows;
  * the README workflow (examples/readme_example.py): RNODE, MLP 2 -> 6 -> 2
    tanh, nvars 1, naug 1, tspan (0, 13), steer_rate 0.1, lambda1 = lambda2
    = lambda3 = 1e-2, calibrated aug noise, the README tolerances with
    method "auto", which picks verner65 (the example names no method and so
    runs tsit5 at them): `fit` on 1024 Beta(2, 4) samples at batch 32
    through K1 and K2 under verner65, `save_checkpoint` / `load_checkpoint`,
    and `ICNFDist.pdf` / `sample` through K3 under verner65; the same
    tolerances at full width on the flagship and power6, and the other
    embedded tableaus (dop853, dopri5, bosh3) and identity layers (K9) in
    every kernel family;
  * the tabular MINIBOONE model of benchmarks/tabular.py:58 (RNODE,
    nvars = 43, MLP 43 -> 128 -> 128 -> 43 tanh, lambda1 = lambda2 = 1e-2,
    tspan (0, 1), no steering, one VJP probe, batch 2048), past the chain
    kernels' widths: served through wide K7 TEST, trained through the wide
    K1 and K2 chain forms and, under exact trace, through wide K7 exact with
    the plain backward;
  * K-probe and forward-mode Hutchinson training (K6, the model of
    benchmarks/probe_scaling.py and __graft_entry__.py): the flagship and
    power6 with K VJP probes (`VecJacMode(num_probes=K)`) or K JVP probes
    (`JacVecMode(num_probes=K)`), the loss and its gradient through the
    probe instances of K1 and K2 (the flagship) and of the K1 and K2 chain
    forms (power6), and `fit` at K = 4; the same at the MINIBOONE width
    (B = 2048) through the probe instances of the wide K1 and K2 chain
    forms (K6 in the wide forms, BASELINE config #5's probe axis);
  * TEST-mode gradients of 2-layer nets through K5, the TEST backward
    kernel: the flagship's TEST loss gradient (K3 forward, K5 backward),
    the score (the x-gradient of `ICNFDist.logpdf`) and the params-gradient
    of `sample(4096, z1=...)`, a conditional 2-layer net at the flagship
    widths (CondRNODE, MLP 17 -> 48 -> 16 on [z | ys], one ys column,
    nvars 8, naug 8, tspan (0, 13)) through K3's and K5's COND
    instance, and the README model's TEST gradient under verner65;
  * the paths the whole-solve kernels do not take, on the flagship: the
    loss gradient under `SolverOptions(adjoint=Adjoint.DIRECT)` and under 32
    rk4 steps, whose TRAIN field runs stage by stage in K10 (the per-stage
    fused field), `fit` under DIRECT, tstops (4, 8) under BACKSOLVE through
    K1 and K2 per segment, `adjoint_stats`, and `sample`'s DIRECT gradient;
    and the trajectory example (examples/trajectory_plot.py: FFJORD, MLP
    2 -> 32 -> 32 -> 2 tanh, tspan (0, 8), saveat linspace(0, 8, 33),
    `inference(..., trajectory=True)` on 64 two-moons points) through K7
    TEST per segment;
  * 2-layer nets past state width 32: the README net family
    MLP((n_in, 3 n_in, n_in)) at the HEPMASS width (hepmass42: RNODE,
    nvars = naug = 21, MLP 42 -> 126 -> 42 tanh, the flagship recipe, batch
    4096), served through wide K3 (`logpdf`, `sample(4096)`), its TEST loss
    gradient and score through wide K3 and wide K5, trained through the
    wide K1 and K2 chain forms (`fit`, four Lion steps; one K = 4 and one
    JVP loss gradient through their probe instances) and, under exact
    trace, through wide K7 exact and the wide K4 adjoint;
  * chains whose weights pass a block's shared memory: FFJORD's tabular
    MINIBOONE model (miniboone860: RNODE, nvars = 43, MLP 43 -> 860 ->
    860 -> 43 tanh, hidden widths 20 x d as in FFJORD's appendix, lambda1
    = lambda2 = 1e-2, tspan (0, 1), no steering, one VJP probe, batch 1024,
    the tabular data recipe), served through streamed K7 TEST (`logpdf`,
    `sample(1024)`), trained through the streamed K1 and K2 chain forms
    (`fit`, four Lion steps) and, under exact trace, one train step through
    streamed K7 exact with the plain backward;
  * 2-layer nets past the wide 2-layer kernels' limits: the README net
    family at the MINIBOONE width (miniboone86: RNODE, nvars = naug = 43,
    MLP 86 -> 258 -> 86 tanh, the flagship recipe, batch 4096), served
    through streamed K3 (`logpdf`, `sample(4096)`), its TEST loss gradient
    and score through streamed K3 and K5, trained through the streamed K1
    and K2 chain forms at state width 86 (`fit`, four Lion steps) and,
    under exact trace, through streamed K7 exact and the streamed K4 adjoint
    (`fit`, four Lion steps); the same kernels at BSDS300's width (bsds126:
    MLP 126 -> 378 -> 126, batch 2048) and on MLP 40 -> 160 -> 40; the
    streamed K4 adjoint beside the wide K4 adjoint on hepmass42's inputs;
  * K-probe and forward-mode Hutchinson training past the wide limits (K6
    in the streamed forms): miniboone860 (B = 1024) and miniboone86
    (B = 4096) with K VJP or JVP probes, the loss and its gradient through
    the probe instances of the streamed K1 and K2 chain forms, and `fit` at
    K = 4; those probe instances at bsds126 (B = 2048), and a chain the
    wide forms keep with one probe but not with K
    (MLP 64 -> 128 -> 128 -> 120 -> 64) reaching them through
    `make_full_solve`;
  * conditional nets past the narrow widths (K8 in the wide forms):
    CondRNODE at the HEPMASS width (cond_hepmass42: nvars = naug = 21, one
    conditioning column, MLP 43 -> 126 -> 42 tanh on [z | ys], hepmass42's
    recipe, batch 4096, ys one of HEPMASS's five standardised signal
    masses), served through wide K3's COND instance
    (`CondICNFDist.logpdf`, `sample(4096)`), its TEST loss gradient through
    wide K3's and wide K5's, trained through the wide K1 and K2 chain
    forms' (`fit`, four Lion steps); those chain-form instances on a
    conditional 3-layer chain (MLP 44 -> 128 -> 128 -> 43); and every
    conditional configuration still outside the kernels raising on the
    card;
  * conditional exact training and conditional deep-chain serving past the
    narrow widths (K8 in wide K7 and in the wide K4 adjoint):
    cond_hepmass42 under exact trace, trained through wide K7 exact's and
    the wide K4 adjoint's COND instances (the train step, `fit`, four Lion
    steps), and the conditional 3-layer chain (MLP 44 -> 128 -> 128 -> 43,
    B = 2048) served through wide K7 TEST's (`CondICNFDist.logpdf`,
    `sample`) and trained under exact trace through wide K7 exact's, its
    backward plain;
  * chains of every depth: the reference benchmark suite's model
    (ContinuousNormalizingFlows.jl's benchmark/benchmarks.jl: refbench16,
    RNODE, nvars = naug = 8, MLP 16 -> 16, one tanh layer, on the flagship
    recipe, B = 4096 and the suite's n = 64) and its conditional form
    (cond_refbench16, MLP 17 -> 16 on [z | ys]) through the narrow chain
    kernels, served (`logpdf`, `sample`), trained (the loss gradient with
    one VJP probe, K = 4 and JVP, `fit` for four Lion steps, at K = 4 too)
    and under exact trace; chains of 5 and 8 layers through the narrow,
    wide and streamed forms, conditional ones through the COND instances;
  * the README net in conditional form at the flagship widths
    (cond_flagship: CondRNODE, nvars = naug = 8, one conditioning column,
    MLP 17 -> 48 -> 16 tanh on [z | ys], the flagship recipe, B = 4096, ys
    the standardised MiniBooNE label as cond_refbench16's) through the COND
    instances of the 2-layer kernels (K8): served through K3's
    (`CondICNFDist.logpdf`, `sample(4096)`), its TEST loss gradient through
    K3's and K5's, trained under exact trace through the K4 forward's and
    the K4 adjoint's (the train step, `fit`, four Lion steps); the same
    kernels at the widest state they keep, MLP 35 -> 96 -> 32 with three ys
    columns, B = 1024.

Phases, each failing the run (nonzero exit) on any mismatch:
  1. versions and the card's name and power limit;
  2. build of every kernel from the sources in this checkout (one nvcc per
     source, at most eight at once, the largest first), with the ptxas lines;
  3. TF32 off for matmuls and cuDNN;
  4. the flagship model with Glorot weights, small nonzero biases and
     xs ~ U[0, 1) of shape (4096, 8);
  5. K3 against its plain version at the main path's shapes, then logpdf
     through the kernel against logpdf through the plain path (same steps;
     |dlogp| within 1e-4 * max(1, max |logp|));
  6. the serving path (logpdf, sample, logpdf of the samples) with the
     launch counters reset just before it;
  7. K1 against `solve_train_plain` from nonzero accumulators (same steps;
     z and each accumulator row within 1e-4 * max(1, max |.|)), and K2
     against `adjoint_train_plain` from K1's output with the same cotangent
     and warm start (same steps; z0 and a_z0 within 1e-4 relative of the
     float64 twin, or within 4x the float32 twin's own distance from it;
     each parameter gradient within 1e-3 * max(1, max |g|): sums of 4096
     terms in another order);
  8. one training loss and its gradient through fused=True (K1, K2) and
     fused=False (the plain BACKSOLVE adjoint): losses within 1e-4
     relative; both gradients within 2e-2 * max|g| of a float64 rtol 1e-7
     plain solve (the two backward solves run on different step grids, and
     the warm-started fused one is the coarser, as in the JAX package);
  9. the training path, `fit` for one epoch of four Lion steps with the
     launch counters reset just before it: four steps, finite losses, K1
     and K2 each launched at least four times;
 10. the K1 and K2 chain forms on the flagship's 2-layer net, held to the
     twins as K1 and K2 are, and CUDA-event timings of the kernels (the
     chain forms beside K1 and K2, at B = 4096 and 512), their plain
     versions and the training step;
 11. the K4 forward against `solve_train_exact_plain` from nonzero
     accumulators (same steps; z and each accumulator row within
     1e-4 * max(1, max |.|)), and the K4 adjoint against
     `adjoint_train_exact_plain` from the K4 forward's output with its last
     step as the warm start (same steps; z0 and a_z0 held to the float64
     twin as K2's are; the chained gradients within 1e-3 * max|g|);
 12. the exact training loss and gradient through fused=True (K4) and
     fused=False: losses within 1e-4 relative, both gradients within
     2e-2 * max|g| of a float64 rtol 1e-7 plain solve;
 13. the exact training path, `fit` for four Lion steps with the launch
     counters reset just before it: the K4 forward and the K4 adjoint
     each launched exactly four times;
 14. CUDA-event timings of the K4 kernels, their plain versions and the
     exact training step;
 15. the power6 model with Glorot weights and N(0, 0.05) biases, data from
     the recipe of the JAX package's synthetic_tabular (tanh(z mix) + 0.1 z);
 16. the K1 chain form against `solve_train_plain` from nonzero
     accumulators and the K2 chain form against `adjoint_train_plain` from
     its output with its last step as the warm start (bounds as K1's and
     K2's);
 17. K7 TEST against `solve_test_plain` and the K7 exact forward against
     `solve_train_exact_plain` (bounds as K1's);
 18. the serving path (logpdf, sample) through K7 TEST, counters reset just
     before it, and logpdf through the kernel against the plain path;
 19. one Hutchinson loss and its gradient through fused=True and
     fused=False, held as in phase 8;
 20. the training path, `fit` for four Lion steps, counters reset just
     before it: the K1 and K2 chain forms each launched at least four times;
 21. one exact loss and its gradient (K7 exact forward, plain backward),
     held as in phase 12, and the exact `fit` for four Lion steps: K7 exact
     launched at least four times;
 22. CUDA-event timings of the chain kernels, their plain versions, the
     power6 train steps and logpdf;
 23. the conditional recipe's model with Glorot weights and N(0, 0.05)
     biases and 4096 pairs (x, y) of its data, and the chain kernels'
     shared memory at its widths;
 24. the K1 chain form with ys against `solve_train_plain` from nonzero
     accumulators, and the K2 chain form with ys against
     `adjoint_train_plain` from its output with its last step as the warm
     start (bounds as K1's and K2's; a_ys0 and the ys rows of g_W0 held
     like the other gradients).  With one state dimension the norm rates
     have kinks, and a solve can sit at a near-tie of the step controller
     (continuousnf_tpu_torch/utils/near_tie.py): a conditional solve that
     misses its twin's bound passes only if its twin's own steps or values
     move when its inputs move by one float32 ulp, and then only within the
     near-tie rule (steps within the twin's own range, each value within 4x
     the twin's own move of it);
 25. K7 TEST and K7 exact with ys against their twins (bounds as K1's, the
     same near-tie gate);
 26. the serving path through CondICNFDist (logpdf with per-sample ys,
     sample with one ys), counters reset just before it: K7 TEST launched
     by both and no other kernel; logpdf through the kernel against the
     plain path;
 27. the Hutchinson loss and its gradient in the params and in ys at
     B = 4096 through fused=True and fused=False, held as in phase 19;
 28. the training path, `fit` at batch 128 for four Lion steps, counters
     reset just before it: the K1 and K2 chain forms each launched at least
     four times; then the exact loss and gradient at B = 512 (K7 exact
     forward, plain backward) held as in phase 21, and the exact `fit` at
     batch 128 for four Lion steps: K7 exact launched at least four times;
     then the K1 and K2 chain forms and K7 exact on the inputs the fits'
     first steps gave them (the recipe's own batch of 128), held to their
     twins as in phases 24 and 25;
 29. CUDA-event timings of the conditional kernels, their plain versions,
     the train steps at B = 128 and 4096, logpdf and sample;
 30. the README workflow: `fit` for one epoch at batch 32 (32 Lion steps,
     lr 3e-4, no weight decay) with the counters reset just before it: K1
     and K2 each launched at least 32 times, every call under verner65,
     finite losses; the checkpoint round-trips bitwise; `ICNFDist.pdf` of
     the 1024 points (through the kernel and the plain path: equal steps,
     logp within 1e-4 * max(1, max|logp|)) and `sample(1024)`, counters
     reset just before them: K3 and no other kernel; mad / msd / tv against
     20 x (1 - x)^3 printed, not gated (one epoch is not a trained model);
 31. the flagship at the README tolerances (verner65), B = 4096: K3, K1,
     K2, the K4 forward and adjoint against their twins (the bounds of
     phases 5, 7 and 11; a solve that misses them passes only under the
     last-step rule, where the two part only at the final step, or the
     near-tie rule), the Hutchinson and exact loss and gradient through
     fused, plain and a float64 solve as in phases 8 and 12, the exact `fit`
     (the K4 pair's main path), and CUDA-event timings;
 32. power6 at the README tolerances: K7 TEST, K7 exact and the K1 and K2
     chain forms against their twins, their main paths (logpdf and sample,
     fit, exact fit, counters reset before each) and timings;
 33. dop853 at rtol 1e-6 / atol 1e-8, dopri5 and bosh3 at rtol 1e-3: K3, K1
     and K2 on the flagship and the four chain kernels on power6 against
     their twins (dop853: where float32 roundoff drives its error
     estimate, steps within max(2, steps / 20) and values within the
     bounds), each family's main path (logpdf and a loss gradient), timings;
 34. identity output layers on the flagship's and power6's nets: the fused
     path (logpdf, a Hutchinson and an exact loss gradient) launches the
     four chain kernels and no 2-layer kernel; the chain kernels against
     their twins;
 35. power6's TEST-mode loss gradient: K7 TEST launched once and no other
     kernel (the plain backward), the gradient within 2e-2 * max|g| of a
     float64 rtol 1e-7 solve;
 36. the MINIBOONE model with Glorot weights and N(0, 0.05) biases, 2048
     samples of the synthetic_tabular recipe at 43 variables, and the wide
     kernels' launch shapes (threads, blocks, tile, shared memory; their
     registers are in phase 2's ptxas lines);
 37. the wide K1 chain form against `solve_train_plain` from nonzero
     accumulators and the wide K2 chain form against `adjoint_train_plain`
     from its output with its last step as the warm start (the bounds of
     phase 16), each timed beside its plain version;
 38. wide K7 TEST against `solve_test_plain` and wide K7 exact against
     `solve_train_exact_plain` (the bounds of phase 17), timed;
 39. logpdf through the kernel against the plain path at B = 16 and 2048;
 40. the Hutchinson loss and its gradient (the wide K1 and K2 chain forms)
     and the exact one (wide K7 exact, plain backward) through fused, plain
     and a float64 rtol 1e-7 solve, held as in phases 19 and 21;
 41. the main paths, counters reset just before each: logpdf and sample
     launch wide K7 TEST and no other kernel, `fit` at batch 2048 for four
     Lion steps the wide K1 and K2 chain forms (each at least four times)
     and no other, the exact `fit` wide K7 exact (at least four times) and
     no other; CUDA-event timings of the train steps and logpdf;
 42. K6, the flagship (K1, K2) and power6 (the K1 and K2 chain forms), B =
     4096: each probe instance at K = 2, 4 and 8 VJP probes and K = 1 and 2
     JVP probes against its twin, the forward from nonzero accumulators and
     the adjoint from its output with its last step as the warm start (the
     bounds of phase 7, the last-step and near-tie rules allowed), timed;
 43. the train step's loss and gradient at K = 4 and under JVP (K = 1)
     through fused=True, fused=False and a float64 rtol 1e-7 solve, held as
     in phase 8, the fused one launching the two probe instances once each;
 44. the main paths, counters reset just before each: the loss and its
     gradient at every probe configuration of phase 42 launch the two probe
     instances once each and no other kernel;
 45. `fit` on the flagship at K = 4 for four Lion steps, counters reset just
     before it: K1's and K2's probe instances each launched at least four
     times and no other kernel;
 46. the probe curve: CUDA-event times and microseconds per attempted step
     of the two kernels at K = 1 (the one-probe instance), 2, 4 and 8 on the
     same inputs;
 47. the flagship's TEST loss and its gradient in the params and xs at
     B = 4096, counters reset just before it: K3 and K5 launched exactly
     once each; the losses of the fused and plain paths within 1e-4
     relative, each fused gradient within 2e-2 * max|g| of a float64 rtol
     1e-7 solve or, where the plain path of the same method at the same
     tolerances is itself farther than that, within 2x the plain path's
     own distance (both printed); then K5 against `adjoint_test_plain`
     from K3's output with its last step as the warm start (the bounds of
     phase 7's K2: equal steps, z0 and a_z0 held to the float64 twin,
     gradients within 1e-3 * max|g|; the near-tie rule allowed), timed;
 48. the score (the x-gradient of `ICNFDist.logpdf`) and the params-gradient
     of a weighted sum of `sample(4096, z1=...)` (its solve runs t1 -> t0,
     its backward t0 -> t1), each launching K3 and K5 once, held as in
     phase 47;
 49. K5's COND instance: a conditional 2-layer net at the flagship widths,
     its TEST loss gradient in the params, xs and ys launching K3's and
     K5's COND instances once each, held as in phase 47; K5 COND against
     its twin (a_ys0 and the ys rows of g_W1 among the gradients) from K3
     COND's output, timed;
 50. the README model's TEST gradient at the README tolerances (method
     "auto", verner65: the non-FSAL refresh) on the README workflow's
     weights and data at B = 4096, K3 and K5 launched once each under
     verner65 only, held as in phase 47; K5 under verner65 against its
     twin;
 51. K10 against its plain version at the flagship's shapes (B = 4096,
     16 -> 48 -> 16), the README model's (2 -> 6 -> 2, B = 32) and an odd
     batch (B = 4097), in float32 and float64, every output within
     1e-5 * max(1, max|.|); CUDA-event times of both over 200 calls and
     the kernel's own time from the profiler;
 52. the flagship's loss gradient (params and probes, steered) under
     DIRECT and under 32 rk4 steps, counters reset just before each: K10
     launched once per forward field evaluation and no other kernel; the
     plain field (fused=False) at the same NFE, or a near-tie shown on the
     plain path (its NFE moves under one-ulp moves of xs and covers the
     fused one); probe gradients within 1e-3 * max|g| of each other; the
     losses and parameter gradients held as in phase 8;
 53. `fit` under DIRECT for four Lion steps, counters reset just before it:
     K10 alone launched, at least four times;
 54. tstops (4, 8) under BACKSOLVE: K1 and K2 launched three times each and
     nothing else, held as in phase 8 with the NFE rule of phase 52; the
     trajectory example: K7 TEST launched 32 times and nothing else, the
     same grid, steps, zs and logp as the plain path (within 1e-4); the
     flagship's `adjoint_stats`, whose backward steps equal those of K2 in
     the gradient;
 55. `sample`'s params-gradient under DIRECT on phase 48's draw (no kernel
     launched: the plain forward is recorded), printed beside phase 48's
     BACKSOLVE gradients and a float64 DIRECT solve at rtol 1e-7, each as
     its distance to the float64 BACKSOLVE solve;
 56. K6 in the wide forms, the MINIBOONE model at B = 2048: the probe
     instances' launch shapes (threads, blocks, tile, shared memory; one
     shape for K = 2, 4 and 8, a run-time argument; registers in phase 2);
 57. the wide K1 and K2 chain forms' probe instances at K = 2, 4 and 8 VJP
     and K = 1 and 2 JVP probes against their twins, held and timed as in
     phase 42;
 58. the MINIBOONE loss and its gradient at K = 4 and under JVP (K = 1)
     through fused=True, fused=False and a float64 rtol 1e-7 solve, held as
     in phase 40; and at every probe configuration of phase 57, counters
     reset just before each, the fused gradient launching the two wide
     probe instances once each and no other kernel;
 59. `fit` at K = 4 for four Lion steps at B = 2048, counters reset just
     before it: the two wide probe instances each launched at least four
     times and no other kernel;
 60. the wide probe curve: CUDA-event times and microseconds per attempted
     step of both wide kernels at K = 1 (the one-probe instance), 2, 4
     and 8 on the same inputs;
 61. hepmass42 at B = 4096: the launch shapes of wide K3, wide K5 and the
     wide K4 adjoint (threads, blocks, tile, the K4 adjoint's basis rows a
     chunk, shared memory; registers in phase 2);
 62. the path's six kernels against their twins, held as in phases 7 and
     11 and timed: wide K3, the wide K1 chain form and wide K7 exact from
     nonzero accumulators; wide K5 from wide K3's output, the wide K2 chain
     form from the wide K1 chain form's and the wide K4 adjoint from wide
     K7 exact's, each warm-started from its forward's last step;
 63. logpdf through wide K3 against the plain path, held as in phase 5;
 64. the Hutchinson, exact and TEST losses and their gradients (the TEST
     one in xs too) through fused=True, fused=False and a float64 rtol
     1e-7 solve, held as in phases 8 and 47, counters reset just before
     each fused call: the Hutchinson gradient launches the wide K1 and K2
     chain forms once each, the exact one wide K7 exact and the wide K4
     adjoint, the TEST one wide K3 and wide K5, and nothing else; one K = 4
     and one JVP loss gradient launch the wide probe instances once each;
 65. the main paths, counters reset just before each: logpdf and sample
     launch wide K3 twice and nothing else; `fit` for four Lion steps the
     wide K1 and K2 chain forms four times each; the exact `fit` wide K7
     exact and the wide K4 adjoint four times each;
 66. CUDA-event times of the train step, the exact train step, `logpdf`
     and the TEST loss gradient;
 67. miniboone860 at B = 1024: the launch shapes of the streamed K1 and K2
     chain forms and streamed K7 TEST and exact (threads, blocks, tile or
     basis rows a chunk, shared memory, the global tile scratch; registers
     in phase 2);
 68. the four streamed kernels against their twins, held as in phases 16
     and 17 and timed (two calls each): the K1 chain form, K7 TEST and
     exact from nonzero accumulators, the K2 chain form from the K1 chain
     form's output warm-started from its last step;
 69. logpdf through streamed K7 TEST against the plain path, held as in
     phase 5;
 70. the Hutchinson and exact losses and their gradients through
     fused=True, fused=False and a float64 rtol 1e-7 solve, held as in
     phase 8, counters reset just before each fused call: the Hutchinson
     gradient launches the streamed K1 and K2 chain forms once each, the
     exact one streamed K7 exact once, and nothing else;
 71. the main paths, counters reset just before each: logpdf and
     sample(1024) launch streamed K7 TEST twice and nothing else; `fit` for
     four Lion steps the streamed K1 and K2 chain forms at least four times
     each; one exact train step streamed K7 exact once;
 72. CUDA-event times of the train step (fused and plain) and `logpdf`.
 73. bf16 stage matmuls (`VecJacMode(fused=True, bf16=True)`), the
     flagship and microbench (the flagship at tspan (0, 1), the
     configuration of benchmarks/kernel_microbench.py): the build seconds
     of bf16 K3, K1 and K2, their launch shapes (threads, blocks: a block
     is a tile of as many samples; shared memory) and the tensor-core
     instructions (HMMA) in each instance's SASS (cuobjdump), none in K3's,
     K1's and K2's;
 74. bf16 K3 and K1 from nonzero accumulators and bf16 K2 from bf16 K1's
     output (warm-started from its last step) against their bf16 twins at
     the flagship and microbench, B = 4096 (the GPU tests hold B = 4000 and
     ragged warps), under the bf16 rule (`near_tie.within_bf16_noise`):
     attempted steps within max(2, steps / 20) of the twin's or within the
     twin's own range, each value within max(1e-4 (forward, z0, a_z0) or
     1e-3 (gradients), 4x the twin's own spread over 2 (flagship) or 4
     (microbench) runs with every input moved one float32 ulp); the bf16
     and f32 solves of one input apart;
 75. serving under bf16, counters reset just before it: logpdf and sample
     launch bf16 K3 twice and nothing else;
 76. the bf16 loss and its gradient, counters reset just before it: bf16 K1
     and bf16 K2 once each and nothing else, the gradient within max(2e-2,
     4x the twins' own move when xs and the params move one ulp) * max|g|
     of the same gradient through the bf16 twins on the card (the distance
     of both, and of the f32 kernels', to a float64 rtol 1e-7 solve of the
     f32 field printed beside it); `fit` for four Lion steps: bf16 K1 and K2
     at least four times each and nothing else;
 77. the bf16 configurations the kernels do not cover raise on the card
     naming ROADMAP's bf16 row (a 3-layer chain, two probes, JVP probes, a
     state past 32, a conditional net, exact trace, the TEST gradient);
 78. CUDA-event times: each bf16 kernel beside its f32 kernel on the same
     input (ms, attempted steps, µs a step) and its twin, at the flagship
     and microbench; kernel_microbench's quantities from the port
     (`train_fwd_nfe_us`, `test_nfe_us`, `grad_step_us`, f32 and bf16) and
     the flagship's bf16 train step, `logpdf` and `sample`;
 79. miniboone86 at B = 4096: the launch shapes of streamed K3 and K5 and
     the streamed K1 and K2 chain forms (threads, blocks, tile, shared
     memory, the global tile scratch; registers in phase 2);
 80. the four kernels against their twins, held as in phases 16, 17 and 47
     and timed: streamed K3 and the streamed K1 chain form from nonzero
     accumulators, streamed K5 from streamed K3's output and the streamed K2
     chain form from the K1 chain form's, each warm-started from its
     forward's last step;
 81. logpdf through streamed K3 against the plain path, held as in phase 5;
     where the steps part (the plain path's cuBLAS sums sit on the other
     side of a near-tie), logp still within the bound and that call's
     kernel held to its twin on the card on the same arguments (equal
     steps and values within 1e-4, or the near-tie rule);
 82. the Hutchinson loss gradient (the streamed K1 and K2 chain forms once
     each and nothing else), the TEST loss gradient and the score (streamed
     K3 and K5 once each and nothing else), counters reset just before each
     fused call, held against fused=False and a float64 rtol 1e-7 solve as
     in phases 8 and 47;
 83. the main paths, counters reset just before each: logpdf and
     sample(4096) launch streamed K3 twice and nothing else; `fit` for four
     Lion steps the streamed K1 and K2 chain forms at least four times each
     and nothing else; the exact loss gradient at B = 256 streamed K7 exact
     and the streamed K4 adjoint once each and nothing else, held against
     fused=False and a float64 rtol 1e-7 solve as in phase 8;
 84. CUDA-event times of the train step (fused and plain), `logpdf`,
     `sample` and the TEST loss gradient;
 85. bsds126 at B = 2048: the four kernels against their twins (one timed
     call each), logpdf against the plain path (as in phase 81), and its logpdf, Hutchinson
     and TEST loss gradients launching streamed K3, the streamed K1 and K2
     chain forms, and streamed K3 and K5 once each;
 86. MLP 40 -> 160 -> 40 at B = 4096 (RNODE, nvars = naug = 20, tspan
     (0, 13)): streamed K3 and K5 against their twins, streamed K3 timed
     beside streamed K7 TEST (its TEST forward before) on the same input,
     and its TEST loss gradient launching streamed K3 and K5 once each;
 87. exact training past the wide limits, miniboone86 at B = 4096 and
     bsds126 at B = 2048: the streamed K4 adjoint's launch shape (threads,
     blocks, tile, shared memory, the global tile scratch); streamed K7 exact against its twin from nonzero accumulators
     and the streamed K4 adjoint against its twin from that output,
     warm-started from its last step (equal steps, z0 and a_z0 held to the
     float64 twin, gradients within 1e-3 of max|g|), one timed call each,
     µs a step beside the FMA bound;
 88. the main paths, counters reset just before each: the exact `fit` for
     four Lion steps at miniboone86 launches streamed K7 exact and the
     streamed K4 adjoint at least four times each and nothing else;
     bsds126's exact loss gradient launches each once;
 89. CUDA-event times of the exact train step at both widths;
 90. the streamed K4 adjoint on hepmass42's inputs (B = 4096, through the
     wrapper's launcher: the routing keeps hepmass42 on the wide K4
     adjoint) beside the wide K4 adjoint on the same inputs: equal steps,
     held to each other within the twin bounds, each timed (a b b a), µs a
     step beside the FMA bound;
 91. K6 in the streamed forms: the launch shapes of the streamed K1 and K2
     chain forms' probe instances (threads, blocks, tile, shared memory,
     the global tile scratch; K is a run-time argument) at miniboone860,
     B = 1024, and miniboone86, B = 4096;
 92. at each of the two, each probe instance against its twin at K = 2, 4,
     8 VJP and K = 1, 2 JVP, held as in phase 42 (two timed calls each);
 93. the train step's loss and gradient at K = 4 VJP and K = 1 JVP through
     the probe instances, the plain path and a float64 rtol 1e-7 solve at
     B = 256 (the float64 solve's batch), held as in phase 43; the main
     paths, counters reset just before each: the loss and its gradient at
     every probe configuration, at the full batch, launch the two streamed
     probe instances once each and no other kernel;
 94. `fit` at K = 4 for four Lion steps launching only the two streamed
     probe instances, at least four times each;
 95. the streamed probe curve: CUDA-event ms and µs per attempted step at
     K = 1 (the one-probe instances), 2, 4 and 8;
 96. bsds126 at B = 2048: the two probe instances against their twins at
     K = 4 VJP and K = 1 JVP; MLP 64 -> 128 -> 128 -> 120 -> 64 (RNODE,
     nvars = 64, tspan (0, 1), B = 1024) through `make_full_solve` with two
     VJP probes: the solve and its adjoint launch the streamed probe
     instances once each and no wide kernel, against the plain path.
 97. K8 in the wide forms, cond_hepmass42 (CondRNODE, nvars = naug = 21,
     one ys column, MLP 43 -> 126 -> 42 on [z | ys], hepmass42's recipe,
     ys the five standardised HEPMASS masses) at B = 4096: the launch shapes
     of the COND instances of wide K3, wide K5 and the wide K1 and K2 chain
     forms;
 98. each against its twin from nonzero accumulators (forwards; the
     adjoints from their forward's output with its last step as the warm
     start): equal steps, values within TOL, gradients and a_ys0 within
     GRAD_TOL; each timed (µs per attempted step beside its FMA bound);
 99. the wide K1 and K2 chain forms' COND instances held the same way on a
     conditional 3-layer chain past hidden 64 (CondRNODE, MLP 44 -> 128 ->
     128 -> 43, one ys column, nvars 43, tspan (0, 1)) at B = 2048, and its
     train step's gradient launching them once each;
100. at B = 256, the train step's loss and gradient (params and ys) and the
     TEST loss gradient (params, xs and ys) through the COND instances, the
     plain path and a float64 rtol 1e-7 solve, within SOLVE_REL;
101. the main paths at B = 4096, counters reset just before each:
     `CondICNFDist.logpdf` and `sample` each launching wide K3 COND once and
     nothing else, the TEST loss gradient wide K3 COND and wide K5 COND once
     each, the train step's gradient the wide K1 and K2 chain forms' COND
     instances once each, the conditional `fit` for four Lion steps only
     those two, at least four times each; and a conditional net past the
     wide limits (MLP 87 -> 258 -> 86 at B = 256) training through the
     streamed forms' COND instances (phases 113-117);
102. CUDA-event times of the train step, `logpdf` and the TEST loss
     gradient at cond_hepmass42, each beside hepmass42's in the same run;
103. K8 in wide K7 and in the wide K4 adjoint: the launch shapes of wide K7
     TEST's COND instance (the conditional 3-layer chain MLP 44 -> 128 ->
     128 -> 43, B = 2048), wide K7 exact's (that chain and cond_hepmass42,
     B = 4096) and the wide K4 adjoint's (cond_hepmass42), and ptxas's
     registers, stack frame and spills of the three instances beside the
     unconditional ones;
104. wide K7 exact COND and, from its output with its last step as the warm
     start, the wide K4 adjoint COND against their twins at cond_hepmass42
     (equal steps, values within TOL; the gradients, W1's ys rows not zero,
     and a_ys0 within GRAD_TOL; z0 and a_z0 held to the float64 twin), and
     wide K7 TEST COND and exact COND on the 3-layer chain, each timed;
105. cond_hepmass42's exact loss and gradients (params and ys) at B = 256
     through the COND instances, the plain path and a float64 rtol 1e-7
     solve, within SOLVE_REL;
106. the main paths, counters reset just before each: cond_hepmass42's
     exact train step (loss, gradient, Lion) launching wide K7 exact COND
     and the wide K4 adjoint COND once each and nothing else, its exact
     `fit` for four Lion steps only those two, at least four times each;
     the 3-layer chain's `logpdf` and `sample(2048)` each wide K7 TEST COND
     once (its logpdf within TOL of the plain path's), its exact loss
     gradient wide K7 exact COND once (the backward plain);
107. CUDA-event times, in the order a b b a: cond_hepmass42's exact train
     step beside hepmass42's, the 3-layer chain's `logpdf` beside
     miniboone43's (B = 2048), in the same run;
108. K6 x K8: the launch shapes of the wide K1 and K2 chain forms' probe
     COND instances at cond_hepmass42 (B = 4096) and the 3-layer chain
     (B = 2048), ptxas's registers, stack frame and spills;
109. each against its twin at K = 2, 4, 8 VJP and K = 1, 2 JVP on both
     nets, timed beside hepmass42's and miniboone43's wide probe instances;
110. cond_hepmass42's K = 4 gradient in the params and ys at B = 256
     against the plain path and a float64 rtol 1e-7 solve;
111. every probe configuration's loss gradient, the K = 4 train step and
     `fit`, the 3-layer JVP step, each launching only the probe COND
     instances;
112. the K = 4 train step beside hepmass42's, a b b a;
113. K8 in the streamed forms, cond_miniboone86 (CondRNODE, nvars = naug =
     43, one ys column, MLP 87 -> 258 -> 86 on [z | ys], miniboone86's
     recipe, ys the standardised MiniBooNE label) at B = 4096 and the
     conditional miniboone860 chain (MLP 44 -> 860 -> 860 -> 43, one ys
     column, B = 1024): the launch shapes of the COND instances of streamed
     K3, streamed K5 and the streamed K1 and K2 chain forms, and ptxas's
     registers, stack frame and spills beside the unconditional instances';
114. each against its twin (forwards from nonzero accumulators, adjoints
     from their forward's output with its last step as the warm start:
     equal steps, values within TOL, gradients and a_ys0 within GRAD_TOL,
     W1's ys rows' gradient not zero), the chain forms' also on the
     miniboone860 chain; each timed beside miniboone86's unconditional
     instance in the same run, a b b a, per attempted step;
115. at B = 256, the train step's loss and gradient (params and ys) and the
     TEST loss gradient (params, xs and ys) through the COND instances, the
     plain path and a float64 rtol 1e-7 solve, within SOLVE_REL;
116. the main paths at cond_miniboone86, counters reset just before each:
     `CondICNFDist.logpdf` and `sample` each launching streamed K3 COND
     once and nothing else, the TEST loss gradient streamed K3 COND and
     streamed K5 COND once each, the train step (loss, gradient, Lion) the
     streamed K1 and K2 chain forms' COND instances once each (the
     miniboone860 chain's train step too), `fit` for four Lion steps only
     those two, at least four times each; what row (d5) refused now runs:
     the exact loss gradient at B = 256 (streamed K7 exact COND and the
     streamed K4 adjoint COND once each), the miniboone860 chain's `logpdf`
     (streamed K7 TEST COND once); and what row (d6) refused: the loss
     gradient with two probes at B = 256 (the streamed K1 and K2 chain
     forms' COND wrappers once each, counted under (2, False));
117. CUDA-event times of the train step, `logpdf` and the TEST loss
     gradient at cond_miniboone86, each beside miniboone86's in the same
     run, a b b a;
118. K8 in streamed K7 and in the streamed K4 adjoint: the launch shapes of
     streamed K7 exact's and the streamed K4 adjoint's COND instances at
     cond_miniboone86 (B = 4096) and of streamed K7 TEST's and exact's at
     cond_miniboone860 (CondRNODE, MLP 44 -> 860 -> 860 -> 43 on [z | ys],
     nvars 43, one ys column, B = 1024), and ptxas's registers, stack frame
     and spills of the three instances (and of the streamed K4 adjoint's
     stage calls) beside the unconditional ones;
119. streamed K7 exact COND and, from its output with its last step as the
     warm start, the streamed K4 adjoint COND against their twins at
     cond_miniboone86 (equal steps, values within TOL; the gradients, W1's
     ys rows not zero, and a_ys0 within GRAD_TOL; z0 and a_z0 held to the
     float64 twin), streamed K7 TEST COND and exact COND at
     cond_miniboone860, each timed; each beside its unconditional instance
     on miniboone86's or miniboone860's inputs in the same run, a b b a,
     per attempted step;
120. cond_miniboone86's exact loss and gradients (params and ys) at B = 256
     through the COND instances, the plain path and a float64 rtol 1e-7
     solve, within SOLVE_REL;
121. the main paths, counters reset just before each: cond_miniboone86's
     exact train step launching streamed K7 exact COND and the streamed K4
     adjoint COND once each and nothing else, its exact `fit` for four Lion
     steps only those two, at least four times each; cond_miniboone860's
     `logpdf` and `sample(1024)` each streamed K7 TEST COND once (its
     logpdf within TOL of the plain path's), its exact train step streamed
     K7 exact COND once (the backward plain);
122. CUDA-event times, a b b a in the same run: cond_miniboone86's exact
     train step beside miniboone86's, cond_miniboone860's `logpdf` beside
     miniboone860's;
123. K6 x K8 in the streamed forms: the launch shapes of the probe COND
     instances of the streamed K1 and K2 chain forms at cond_miniboone86
     (B = 4096), cond_miniboone860 (B = 1024) and MLP 65 -> 128 -> 128 ->
     120 -> 64 with one ys column (B = 1024, past the wide probe COND
     instances' shared memory), and ptxas's registers, stack frames and
     spills (and the K2 stages' calls) beside the probe instances';
124. each against its twin at cond_miniboone86 (K = 4 and JVP) and
     cond_miniboone860 (K = 4): equal steps, values within TOL, gradients
     and a_ys0 within COND_PROBE_GRAD_TOL, W0's ys rows' gradient not zero,
     two timed calls each; then the ys = 0 yardstick: the COND instance
     with ys = 0 and W0's ys rows 0 beside the unconditional streamed probe
     instance on the same weights without those rows (steps within one;
     with equal steps, values within TOL and GRAD_TOL), a b b a, per
     attempted step;
125. cond_miniboone86's K = 4 loss and gradients (params and ys) at B = 256
     through the probe COND instances, the plain path and a float64 rtol
     1e-7 solve, within SOLVE_REL;
126. the main paths, counters reset just before each: the K = 4 and JVP
     train steps of cond_miniboone86 (B = 4096) and cond_miniboone860
     (B = 1024) and the K = 2 train step of the 65-128-128-120-64 chain,
     each launching the streamed probe COND instances once and nothing
     else, cond_miniboone86's K = 4 `fit` only those, at least four times
     each;
127. the K = 4 train step at cond_miniboone86 beside miniboone86's, a b b
     a;
128. chains of every depth: coverage and routing of the depth
     configurations (DEPTH_MODELS: refbench16 and cond_refbench16, 1-layer
     nets; MLP 6 -> 32 x 7 -> 6 on the narrow forms; power6's widths at 5
     and 8 layers and MLP 43 -> 64 x 4 -> 43 on the wide forms, their K2
     slots past the narrow forms' shared memory; MLP 43 -> 128 x 4 -> 43,
     miniboone860's widths at 5 layers and its conditional form on the
     streamed forms), the narrow kernels' launch shapes, a 9-layer chain
     and a 1-layer net of state width 33 raising on the card (shape
     variants (b2), (c2)), ptxas's registers, stack frames and spills of
     the chain sources' builds for every depth (`@depths`: every narrow
     instance, the wide and streamed COND instances);
129. refbench16 (RNODE 8 + 8, MLP 16 -> 16 tanh, the reference benchmark
     suite's model, on the flagship recipe, B = 4096): K7 TEST, K7 exact and
     the K1 and K2 chain forms, and their probe instances at K = 4 VJP
     and K = 1 JVP, against their twins (steps equal, values within
     TOL, gradients within GRAD_TOL, the last-step and near-tie rules),
     logpdf against the plain path (where it misses TOL, held by the
     near-tie rule on the kernel's own call), the main paths with the counters reset
     just before each (serving, the one-probe, K-probe, JVP and exact loss
     gradients, `fit` and the exact `fit` for four Lion steps, launching
     only the narrow chain kernels), the K = 4 loss gradient against a
     float64 rtol 1e-7 solve (`hold_depth_gradients`: SOLVE_REL, or 2x the
     plain path's own distance where that path misses it);
130. refbench16's train step and logpdf, fused and plain (the plain ones
     one call each), at B = 4096 and at the suite's n = 64;
131. cond_refbench16 (CondRNODE, MLP 17 -> 16 on [z | ys]) as phase 129,
     through the narrow kernels with ys rows, with K = 4 and JVP probe
     instances, its K = 4 gradient in the params and ys at B = 256;
132. the narrow 8-layer chain and the 5- and 8-layer chains of the wide
     forms as phase 131, each through its form's kernels, the one-probe
     gradient against the float64 solve at B = 256;
133. the 5-layer chains of the streamed forms (MLP 43 -> 128 x 4 -> 43,
     B = 2048; miniboone860's widths at 5 layers, B = 1024, one timed call,
     and its conditional form through the COND instances) as phase 132,
     and the 5-layer streamed K2 chain form's time a step beside its
     prediction (DEPTH_K2S_PREDICTED_US);
134. K8 in the 2-layer kernels: cond_flagship (CondRNODE, MLP 17 -> 48 -> 16
     on [z | ys], one ys column, the flagship recipe, B = 4096) and the dz-32
     edge (MLP 35 -> 96 -> 32, three ys columns, B = 1024) covered by the
     COND instances of K3, the K4 forward and the K4 adjoint, their launch
     shapes and the K4 adjoint COND's shared memory, ptxas's registers,
     stack frames and spills of the COND instances beside the unconditional;
135. the three COND instances against their twins at cond_flagship (the
     forwards from nonzero accumulators, the adjoint from the K4 forward
     COND's output with its last step as the warm start; the bounds of
     phases 5 and 11, a_ys0 and W1's ys rows among the gradients, the
     last-step and near-tie rules), timed, each step's microseconds beside
     its prediction (COND2_PREDICTED_US);
136. cond_flagship's serving, counters reset just before each
     (`CondICNFDist.logpdf` with per-sample ys, `sample(4096)` with one ys:
     K3 COND once each and nothing else), logpdf against the plain path,
     and the TEST loss gradient at B = 1024 launching K3 COND and K5 once
     each: the params and xs held as in phase 47, the per-sample ys
     cotangent's distance to the float64 solve printed at rtol 1e-3 (the
     fused backward's discretization, COND_FINE_SOLVER) and, with every
     other gradient, held within 2e-2 * max|g| at rtol 1e-4;
137. cond_flagship's exact train step at B = 4096 launching the K4 forward
     COND and the K4 adjoint COND once each and nothing else, the exact loss
     and its gradients at B = 1024: the params' within 2e-2 * max|g| of a
     float64 rtol 1e-7 solve, the ys cotangent's distance printed, and at
     rtol 1e-4 all within 2e-2 * max|g|; the exact `fit` for four Lion steps
     launching only those two kernels, at least four times each; the K1 and
     K2 chain forms' COND instances (Hutchinson training) against their
     twins, timed, and the Hutchinson train step launching them once each;
138. the dz-32 edge: the three COND instances against their twins, its
     logpdf and exact loss gradient launching them once each; CUDA-event
     times of cond_flagship's exact train step beside the flagship's (a b b
     a), of both logpdfs and of cond_flagship's TEST loss gradient.
Every kernel's record carries its bound: the larger of the operations its
inputs need (FMA counted from the widths, times the field evaluations of the
timed call: the first stage, S - 1 per attempted step and a non-FSAL
tableau's refresh per accepted step; K10 evaluates the field once) at
67 TFLOP/s f32 and the bytes of its
inputs and outputs at 3.35 TB/s (the H100 SXM's data-sheet rates); a bf16
kernel's operations are its stage products at 989 TFLOP/s (bf16 dense) plus
its elementwise and trace FMA at 67 TFLOP/s.  A record
of a K9 run carries its tableau (or "identity") in its name, one of a probe
instance its probes ("K4", "jvp-K2").  The last lines are the
kernels' JSON record, the nvidia-smi line, and {"ok": true, "device":
{...}}.  Without a CUDA device it exits nonzero and prints no result.
"""

import contextlib
import ctypes
import json
import re
import subprocess
import sys
import time

import numpy as np

SEED = 0
BATCH = 4096
TOL = 1e-4  # relative bound on kernel-vs-plain differences (f32 sums in another order)
GRAD_TOL = 1e-3  # K2's and K4's batch-summed parameter gradients: 4096-term sums in another order
SOLVE_REL = 2e-2  # training gradients vs a float64 rtol 1e-7 solve, relative to max|g|
N_STEPS = 4  # Lion steps of the training path
F32_FLOPS = 67e12  # H100 SXM f32 rate outside the tensor cores
BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core rate
HBM_BYTES = 3.35e12  # H100 SXM memory rate
SOURCE = "continuousnf_tpu_torch/ops/csrc/"


def nvidia_smi_line() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return proc.stdout.strip().splitlines()[0]


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def rel_err(got, ref) -> float:
    """max|got - ref| / max(1, max|ref|)."""
    return float((got - ref).abs().max()) / max(1.0, float(ref.abs().max()))


def to64(v):
    """A kernel's keyword argument in float64 (tensors and lists of them)."""
    import torch

    if torch.is_tensor(v):
        return v.double()
    return [x.double() for x in v] if isinstance(v, list) else v


def hold_backward_state(label, out_k, out_p, out_64):
    """z0 and a_z0 of a backsolve against the float64 twin.  The state
    reconstructed backward is ill-conditioned here: the twin's own float32
    result differs from its float64 one by more than 1e-4 (step sizes set by
    a roundoff-level eest, errors grown over tspan 13; PERF.md).  So the
    kernel is held, beside the 1e-4 bound, to at most 4x the twin's own
    float32 distance from the float64 twin."""
    for what, i in (("z0", 0), ("a_z0", 2)):
        e_k, e_p, e_kp = rel_err(out_k[i], out_64[i]), rel_err(out_p[i], out_64[i]), rel_err(out_k[i], out_p[i])
        check(e_k <= max(TOL, 4.0 * e_p), f"{label} {what}: {e_k} from the float64 twin, the float32 twin {e_p}")
        print(f"{label} {what}: relative distance to the float64 twin {e_k:.3e} (float32 twin {e_p:.3e}); "
              f"to the float32 twin {e_kp:.3e}")


def hold_near_tie(label, out_k, out_p, twin, spec, kw, state, tab=None) -> None:
    """A solve that misses its twin's bound passes only on an input whose
    twin shows a near-tie of the step controller: `near_tie.witness` runs
    the twin again with its inputs moved by one float32 ulp (the state
    `state` alone, then every input), and its steps or values must move
    (by more than TOL for a forward, GRAD_TOL for an adjoint).  The kernel
    must then meet `near_tie.within_near_tie`: attempted steps within the
    range of the twin's own, each value within max(TOL, 4x the twin's own
    move of that value) of the twin's (gradients and a_ys0: GRAD_TOL).  The
    float64 twin's distances are printed beside them.  `tab`: the tableau
    (tsit5 when None)."""
    import torch
    from continuousnf_tpu_torch.ode.tableaus import TSIT5
    from continuousnf_tpu_torch.utils import near_tie

    tab = tab or TSIT5
    steps, spreads = near_tie.witness(twin, tab, spec, kw, state, ref=out_p)
    s_p = near_tie.split(out_p)[0]
    shown = near_tie.shows_near_tie(s_p, steps, spreads, TOL if near_tie.is_forward(out_p) else GRAD_TOL)
    print(f"{label}: the twin under one-ulp moves of its inputs: steps {steps}, spread {max(spreads):.3e}"
          + (" (a near-tie)" if shown else " (no near-tie)"))
    check(shown, f"{label} misses its twin's bound, and its twin shows no near-tie")
    holds, line = near_tie.within_near_tie(out_k, out_p, steps, spreads, TOL, GRAD_TOL)
    print(f"{label}, the near-tie rule: {line}")
    with torch.no_grad():
        out_64 = twin(tab, spec, **{k: to64(v) for k, v in kw.items()})
    (s_k, v_k), (_, v_p), (s_64, v_64) = (near_tie.split(o) for o in (out_k, out_p, out_64))
    print(f"{label}, beside the float64 twin ({s_64} steps; the kernel {s_k}, the twin {s_p}): relative distance "
          + ", ".join(f"kernel {near_tie.rel(a, c):.3e} twin {near_tie.rel(b, c):.3e}" for a, b, c in zip(v_k, v_p, v_64)))
    check(holds, f"{label} misses the near-tie rule: {line}")


def roundoff_gate(label, s_k, s_p, errs, tol, gate) -> bool:
    """For dop853 at rtol 1e-6, where the float32 error estimate is
    roundoff (the float64 twin takes a fraction of the float32 twin's
    steps): values within `tol` and attempted steps within `gate` =
    max(2, steps / 20) of the twin's (the JAX package's own gate for this
    regime, tests/test_tpu_parity.py:58, experiments/tpu_parity_r5.py:63-66).
    Returns whether the solve meets it (False when no gate is given)."""
    if not gate:
        return False
    g = max(gate, s_p // 20)
    holds = abs(s_k - s_p) <= g and max(errs) <= tol
    print(f"{label}, the roundoff gate: steps {s_k} vs {s_p} (within {g}: {abs(s_k - s_p) <= g}), "
          f"largest relative error {max(errs):.3e}")
    return holds


def hold_forward(label, out_k, out_p, near=None, gate=0) -> float:
    """A forward kernel's (zT, accT, steps, accepted, dt_last, dt_used)
    against its twin's: equal attempted and accepted steps, finite values,
    z and each accumulator row within TOL * max(1, max|.|).  A solve that
    misses that bound passes under `roundoff_gate` when `gate` is given;
    given `near` = (twin, spec, kwargs[, tableau]), it passes if the two
    part only at the last step (`near_tie.last_step_tie`: one stops short of
    t1 and takes one more, shorter step), or under the near-tie rule
    (`hold_near_tie`) on an input whose twin shows a near-tie.  Returns the
    largest absolute difference."""
    import torch
    from continuousnf_tpu_torch.utils import near_tie

    B = out_k[0].shape[0]
    rows = lambda o: [o[0]] + list(o[1].reshape(-1, B))  # noqa: E731
    errs = [rel_err(a, b) for a, b in zip(rows(out_k), rows(out_p))]
    print(f"{label} vs plain: steps {int(out_k[2])}/{int(out_k[3])} (plain {int(out_p[2])}/{int(out_p[3])}), "
          "relative errors z and accumulators " + ", ".join(f"{e:.3e}" for e in errs)
          + f"; dt_last {float(out_k[4]):.5f} vs {float(out_p[4]):.5f}, last step taken {float(out_k[5]):.5f} vs "
          f"{float(out_p[5]):.5f}")
    check(bool(torch.isfinite(out_k[0]).all() and torch.isfinite(out_k[1]).all()), f"{label} output not finite")
    if (int(out_k[2]), int(out_k[3])) != (int(out_p[2]), int(out_p[3])) or max(errs) > TOL:
        if not roundoff_gate(label, int(out_k[2]), int(out_p[2]), errs, TOL, gate):
            check(near is not None, f"{label} differs from its twin: steps {int(out_k[2])}/{int(out_k[3])} vs "
                  f"{int(out_p[2])}/{int(out_p[3])}, z and accumulator rows relative errors {errs}")
            last, line = near_tie.last_step_tie(out_k, out_p, TOL)
            if last:
                print(f"{label}, the last-step rule: {line}")
            else:
                hold_near_tie(label, out_k, out_p, *near[:3], "z0", *near[3:])
    return max(float((out_k[0] - out_p[0]).abs().max()), float((out_k[1] - out_p[1]).abs().max()))


def hold_adjoint(label, adj_k, adj_p, adj_64, near=None, gate=0, grad_tol=GRAD_TOL) -> float:
    """A Hutchinson adjoint kernel's (z0, acc0, a_z0, g_ws, g_bs, steps,
    accepted[, a_ys0]) against its twin's: equal steps, finite values, z0
    and a_z0 held to the float64 twin, each gradient (and a_ys0, the
    conditioning's per-sample cotangent) within grad_tol * max(1, max|g|).
    Given `near` = (twin, spec, kwargs), a solve that misses the steps or
    the gradients' bound is held to the near-tie rule instead
    (`hold_near_tie`), or under `roundoff_gate` when `gate` is given.
    Returns the largest absolute difference."""
    import torch

    grads_k, grads_p = adj_k[3] + adj_k[4] + list(adj_k[7:]), adj_p[3] + adj_p[4] + list(adj_p[7:])
    check(all(bool(torch.isfinite(x).all()) for x in [adj_k[0], adj_k[2]] + grads_k), f"{label} output not finite")
    e_g = [rel_err(a, b) for a, b in zip(grads_k, grads_p)]
    print(f"{label} vs plain: steps {int(adj_k[5])}/{int(adj_k[6])} (plain {int(adj_p[5])}/{int(adj_p[6])}), "
          "gradient relative errors (ws, bs[, a_ys0]) " + ", ".join(f"{e:.3e}" for e in e_g))
    if (int(adj_k[5]), int(adj_k[6])) == (int(adj_p[5]), int(adj_p[6])) and max(e_g) <= grad_tol:
        hold_backward_state(label, adj_k, adj_p, adj_64)
    elif not roundoff_gate(label, int(adj_k[5]), int(adj_p[5]), e_g, grad_tol, gate):
        check(near is not None, f"{label} differs from its twin: steps {int(adj_k[5])}/{int(adj_k[6])} vs "
              f"{int(adj_p[5])}/{int(adj_p[6])}, gradients (ws, bs[, a_ys0]) {e_g}")
        hold_near_tie(label, adj_k, adj_p, *near[:3], "zT", *near[3:])
    return max(float((a - b).abs().max()) for a, b in zip([adj_k[0], adj_k[2]] + grads_k,
                                                          [adj_p[0], adj_p[2]] + grads_p))


def hold_logpdf(cnf, label, icnf_k, icnf_p, xs, ps, ys=None, kernel=None) -> None:
    """TEST inference through the kernel against the plain path at B = 16
    and B = len(xs) (given ys, with its first rows): equal steps, logp
    within TOL * max(1, max|logp|).  Given `kernel` = (fs, the name of the
    forward wrapper the fused path calls, its twin), a call whose steps part
    from the plain path's, or whose logp misses that bound, is held by
    `logpdf_near_tie` instead: the kernel's own call against its twin, and
    for a logp that misses, only where the twin shows a near-tie."""
    import torch

    for n in (16, len(xs)):
        kw = {} if ys is None else {"ys": ys[:n]}
        with torch.no_grad():
            lp_k, _, st_k = cnf.inference(icnf_k, cnf.Mode.TEST, xs[:n], ps, **kw)
            lp_p, _, st_p = cnf.inference(icnf_p, cnf.Mode.TEST, xs[:n], ps, **kw)
        dlp = float((lp_k - lp_p).abs().max())
        missed = dlp > TOL * max(1.0, float(lp_p.abs().max()))
        parted = int(st_k.steps) != int(st_p.steps)
        if kernel is not None and (missed or parted):
            logpdf_near_tie(cnf, f"{label} B={n}", icnf_k, xs[:n], ps, int(st_k.steps), int(st_p.steps), *kernel,
                            ys=kw.get("ys"), dlp=dlp if missed else None)
        else:
            check(not missed, f"{label} B={n}: logp differs by {dlp}")
            check(not parted, f"{label} B={n}: steps {int(st_k.steps)} != {int(st_p.steps)}")
        print(f"{label} logpdf B={n}: steps {int(st_k.steps)}, nfe {int(st_k.nfe)}, max|dlogp| {dlp:.3e}")



def logpdf_near_tie(cnf, label, icnf_k, xs, ps, s_k, s_p, fs, name, twin, ys=None, dlp=None) -> None:
    """A `logpdf` whose attempted steps part from the plain path's, or
    (`dlp`, its largest difference) whose logp misses TOL against it: the
    kernel's own call on that path, its arguments recorded
    (`first_calls`), is held to the kernel's twin on the card on the same
    arguments.  Steps alone: `hold_forward` (equal steps and values within
    TOL, or the last-step and near-tie rules).  A logp that misses: the
    near-tie rule (`hold_near_tie`), which passes only where the twin's own
    result moves by more than TOL under one-ulp moves of its inputs.  The
    plain path runs other float32 sums (cuBLAS products) and may sit on the
    other side of a near-tie of the step controller, or, on such an input,
    more than TOL from the kernel."""
    import torch
    from continuousnf_tpu_torch.ode.tableaus import TSIT5

    with first_calls(fs, (name,)) as seen, torch.no_grad():
        cnf.inference(icnf_k, cnf.Mode.TEST, xs, ps, **({} if ys is None else {"ys": ys}))
    kw = seen[name]
    spec = fs.chain_spec(icnf_k.nn, icnf_k.zdim)
    with torch.no_grad():
        out_k = getattr(fs, name)(TSIT5, spec, **kw)
        out_p = twin(TSIT5, spec, **kw)
    what = f"max|dlogp| {dlp:.3e} over TOL" if dlp is not None else "logp within TOL"
    print(f"{label} logpdf: steps {s_k} vs the plain path's {s_p}, {what}; the kernel's call against its twin on its "
          "arguments:")
    if dlp is None:
        hold_forward(f"{label} ({name}'s call)", out_k, out_p, near=(twin, spec, kw))
    else:
        hold_near_tie(f"{label} ({name}'s call)", out_k, out_p, twin, spec, kw, "z0")



def loss_grad(cnf, icnf, ps_np, xs, dev, dtype=None, ys=None, **kw):
    """One TRAIN loss and its gradient in the params' leaves (w1, b1, w2,
    b2, ...) and, given the conditioning ys, in ys (last)."""
    import torch

    dtype = dtype or torch.float32
    p = cnf.params_from_numpy(ps_np, dev)
    leaves = [x.to(dtype).requires_grad_() for layer in p for x in (layer["w"], layer["b"])]
    p = tuple({"w": w, "b": b} for w, b in zip(leaves[::2], leaves[1::2]))
    if ys is not None:
        ys = ys.detach().to(dtype).requires_grad_()
        kw["ys"] = ys
    l, m = cnf.loss_and_metrics(icnf, cnf.Mode.TRAIN, xs.to(dtype), p, **kw)
    return l.detach(), torch.autograd.grad(l, leaves + ([] if ys is None else [ys])), m


def kernel_record(name, source, replaces, launches, err, ms, plain_ms, fma, B, steps, floats, tab=None,
                  accepted=0):
    """One kernel's line of the JSON record.  Its bound is the larger of
    2 * fma * B * evaluations operations (fma per sample and field
    evaluation; the evaluations of the timed call: the first stage, S - 1
    per attempted step, and for a non-FSAL tableau the refresh after each
    of the `accepted` steps; tsit5 when `tab` is None) at F32_FLOPS and
    4 * floats bytes (each input read once, each output written once) at
    HBM_BYTES."""
    from continuousnf_tpu_torch.ode.tableaus import TSIT5

    tab = tab or TSIT5
    evals = 1 + (tab.num_stages - 1) * int(steps) + (0 if tab.fsal else int(accepted))
    t_ops = 2.0 * fma * B * evals / F32_FLOPS * 1e3
    t_bytes = 4.0 * floats / HBM_BYTES * 1e3
    return {
        "name": name, "route": "cuda", "source": SOURCE + source, "replaces": replaces,
        "launches": int(launches), "max_abs_err": float(err), "ms": float(ms), "plain_ms": float(plain_ms),
        "bound_ms": max(t_ops, t_bytes), "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": None,
    }


def two_layer_fma(dz, H):
    """FMA per sample and field evaluation of the 2-layer kernels, counted
    from the widths: K3 (forward, M dh), K1 (forward, one pullback), K2
    (forward, pullback, both VJPs, the outer products of P entries), the K4
    forward (forward, the dz rows of m) and adjoint (that, ct_m, the VJPs,
    the outer products with g_pm), K5 (`k5_fma`)."""
    P = 2 * dz * H + H + dz
    return {"k3": 3 * dz * H, "k1": 4 * dz * H, "k2": 8 * dz * H + 2 * P,
            "k4": 2 * dz * H + dz * dz * H, "k4a": 3 * dz * dz * H + 6 * dz * H, "k5": k5_fma(dz, H)}


def k5_fma(dz, H, n_cond=0):
    """FMA per sample and field evaluation of K5: 6 dz H for the products
    (the forward, m dh, m^T ct_mdh, W2 ct_pre2, W1 ct_pre1), the outer
    products of the P gradient entries, dz H for ct_m and, for n_cond
    conditioning rows, their forward and ct_ys products (2 n_cond H; their
    outer products are in P)."""
    P = 2 * dz * H + n_cond * H + H + dz
    return 6 * dz * H + P + dz * H + 2 * n_cond * H


def chain_fma(dims, n_cond=0):
    """The same for the chain kernels, with S = sum in_i out_i (the first
    layer at dz + n_cond inputs: the forward pass) and Sz = S - n_cond H1
    (its z rows only: the pullback and the basis push): the K1 chain form
    S + Sz (forward, pullback); K7 exact S plus dz columns of H1 +
    sum_(i>0) in_i out_i; K7 TEST S plus dz columns of H1 + the middle
    layers' in_i out_i + H_(N-1) (only the diagonal entry of the last
    layer's product); the K2 chain form 2 S + 4 Sz + n_cond H1 + sum out_i
    (four passes, the ys cotangent, and the outer products: ys x ca_0 alone
    for the ys rows); a 1-layer net K7 exact S + dz^2 and K7 TEST S + dz
    (the basis push is the gated W0z^T itself)."""
    pairs = list(zip(dims[:-1], dims[1:]))
    S = sum(a * b for a, b in pairs)
    Sz = S - n_cond * dims[1]
    middle = sum(a * b for a, b in pairs[1:-1])
    dz = dims[-1]
    fma = {"k1c": S + Sz, "k7e": S + dz * (dims[1] + middle + dims[-2] * dz),
           "k7t": S + dz * (dims[1] + middle + dims[-2]), "k2c": 2 * S + 4 * Sz + n_cond * dims[1] + sum(dims[1:])}
    if len(pairs) == 1:
        fma.update(k7e=S + dz * dz, k7t=S + dz)
    return fma


def hold_gradients(label, l_k, g_k, l_p, g_p, l_t, g_t, names=None):
    """The fused and plain losses within 1e-4 relative, and both gradients
    within SOLVE_REL * max|g| of the float64 rtol 1e-7 solve.  The two
    backward solves run on different step grids: the fused one is
    warm-started from the forward's last step and takes about half the
    plain one's steps.  At the flagship the JAX package's own fused gradient
    sits 3.5e-3 * max|g| from such a solve and its plain one 5e-4 (PERF.md),
    so rtol 2e-3 between them is out of reach there."""
    check(abs(float(l_k - l_p)) <= TOL * max(1.0, abs(float(l_p))), f"{label} losses {float(l_k)} vs {float(l_p)}")
    names = names or [f"{x}{i + 1}" for i in range(len(g_t) // 2) for x in ("w", "b")]
    for name, a, b, t in zip(names, g_k, g_p, g_t):
        d_k, d_p = float((a.double() - t).abs().max()), float((b.double() - t).abs().max())
        scale = float(t.abs().max())
        check(max(d_k, d_p) <= SOLVE_REL * scale,
              f"{label} g_{name}: fused {d_k} and plain {d_p} from the float64 solve, max|g| {scale}")
        print(f"{label} g_{name}: max|g| {scale:.4e}; distance to the float64 rtol 1e-7 solve: fused {d_k:.4e}, "
              f"plain {d_p:.4e}; fused vs plain {float((a - b).abs().max()):.4e}")


class _Recorder:
    """Stands in for a kernel wrapper: keeps a copy of the keyword arguments
    of the first call and the names of the tableaus of all calls, and passes
    every call on to the wrapper.  Its `launches` is the wrapper's own, so
    the count the wrapper keeps where it launches lands where it always
    does."""

    def __init__(self, wrapper):
        self.wrapper, self.first, self.tabs = wrapper, None, set()

    def __call__(self, tab, spec, **kw):
        import torch

        self.tabs.add(tab.name)
        if self.first is None:
            copy = lambda v: v.detach().clone() if torch.is_tensor(v) else v  # noqa: E731
            self.first = {k: [copy(x) for x in v] if isinstance(v, list) else copy(v) for k, v in kw.items()}
        return self.wrapper(tab, spec, **kw)

    @property
    def launches(self):
        return self.wrapper.launches

    @launches.setter
    def launches(self, n):
        self.wrapper.launches = n


class _StepsRecorder(_Recorder):
    """A `_Recorder` of an adjoint wrapper that also keeps the attempted
    steps of each call's output."""

    def __init__(self, wrapper):
        super().__init__(wrapper)
        self.steps = []

    def __call__(self, tab, spec, **kw):
        out = super().__call__(tab, spec, **kw)
        self.steps.append(int(out[5]))
        return out


@contextlib.contextmanager
def first_calls(fs, names):
    """While open, each wrapper fs.<name> is looked up as a `_Recorder`; the
    yielded dict then holds, under each name, the keyword arguments of the
    first call the main path made to it, and under "tableaus" the names of
    the tableaus of all their calls."""
    recorders = {name: _Recorder(getattr(fs, name)) for name in names}
    seen = {}
    for name, rec in recorders.items():
        setattr(fs, name, rec)
    try:
        yield seen
    finally:
        for name, rec in recorders.items():
            setattr(fs, name, rec.wrapper)
    seen.update({name: rec.first for name, rec in recorders.items()})
    check(all(v is not None for v in seen.values()), f"the main path did not call each of {names}")
    seen["tableaus"] = set().union(*(rec.tabs for rec in recorders.values()))


def fit_path(cnf, fs, icnf, ps_np, dev, X, Y=None, batch_size=BATCH):
    """`fit` for one epoch of N_STEPS Lion steps at `batch_size` on the data
    X (numpy; with the conditioning Y for a conditional model), every launch
    counter reset just before it.  Checks the step count and finite losses
    and params; returns the FitResult."""
    import torch

    X = torch.from_numpy(X).to(dev)
    Y = None if Y is None else torch.from_numpy(Y).to(dev)
    lion_steps = []

    def lion(params):
        opt = cnf.Lion(params, lr=1e-3)
        opt.register_step_post_hook(lambda *_: lion_steps.append(1))
        return opt

    fs.reset_launches()
    model = (cnf.ICNFModel if Y is None else cnf.CondICNFModel)(icnf, optimizers=(lion,), n_epochs=1,
                                                                 batch_size=batch_size)
    res = cnf.fit(model, X, Y, ps=cnf.params_from_numpy(ps_np, dev), seed=SEED)
    torch.cuda.synchronize()
    check(len(lion_steps) == N_STEPS, f"{len(lion_steps)} Lion steps, expected {N_STEPS}")
    check(bool(np.isfinite(res.losses).all()), f"fit losses {res.losses}")
    check(all(bool(torch.isfinite(x).all()) for layer in res.ps for x in layer.values()), "fitted params not finite")
    return res


def paired_ms(fa, fb, reps: int):
    """CUDA-event milliseconds per call of fa and of fb, each the mean of two
    timings taken in the order a, b, b, a."""
    from continuousnf_tpu_torch.utils.configs import cuda_ms

    a1, b1, b2, a2 = cuda_ms(fa, reps), cuda_ms(fb, reps), cuda_ms(fb, reps), cuda_ms(fa, reps)
    return (a1 + a2) / 2, (b1 + b2) / 2


def step_ms(cnf, icnf, ps_np, xs, gen, dev, reps, ys=None, warmup=True):
    """CUDA-event milliseconds of one step of the step body (loss, gradient,
    Lion); a plain model's step, whose loss and gradient have run already,
    goes without a warm-up call."""
    from continuousnf_tpu_torch.utils.configs import cuda_ms

    p = cnf.params_from_numpy(ps_np, dev)
    leaves = [x.requires_grad_() for layer in p for x in (layer["w"], layer["b"])]
    step = cnf.parallel.make_train_step_body(icnf, cnf.Lion(leaves, lr=1e-3))
    return cuda_ms(lambda: step(p, xs, gen, ys=ys), reps, warmup)


def serving(cnf, fs, TSIT5, icnf_k, icnf_p, ps, xs, rng, dev):
    """Phases 5 and 6 and K3's timings.  Returns K3's record."""
    import torch
    from continuousnf_tpu_torch.utils.configs import cuda_ms

    opts = icnf_k.solver
    zdim = icnf_k.zdim
    z0 = torch.cat([xs, torch.zeros((BATCH, icnf_k.naugmented), device=dev)], dim=1)
    dlogp0 = torch.from_numpy(rng.normal(0.0, 0.1, BATCH).astype("float32")).to(dev)
    spec = fs.chain_spec(icnf_k.nn, zdim)
    kw = dict(
        rtol=opts.rtol, atol=opts.atol, max_steps=opts.max_steps,
        ws=[p["w"] for p in ps], bs=[p["b"] for p in ps], z0=z0, dlogp0=dlogp0,
        t0=torch.tensor(0.0, device=dev), t1=torch.tensor(icnf_k.tspan[1], device=dev),
        dt_init=torch.tensor(0.05, device=dev),
    )
    with torch.no_grad():
        out_k = fs.run_solve_kernel(TSIT5, spec, **kw)
        out_p = fs.solve_test_plain(TSIT5, spec, **kw)
    torch.cuda.synchronize()
    err_k3 = hold_forward("K3", out_k, out_p)
    steps_k = int(out_k[2])
    hold_logpdf(cnf, "flagship", icnf_k, icnf_p, xs, ps)

    # Phase 6: the serving path, counters reset just before it.
    dist = cnf.ICNFDist(icnf_k, cnf.Mode.TEST, ps)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    fs.run_solve_kernel.launches = 0
    with torch.no_grad():
        lp = dist.logpdf(xs)
        n_logpdf = fs.run_solve_kernel.launches
        samples = dist.sample(BATCH, generator=gen)
        n_sample = fs.run_solve_kernel.launches - n_logpdf
        lp_samples = dist.logpdf(samples)
    torch.cuda.synchronize()
    launches = fs.run_solve_kernel.launches
    check(n_logpdf >= 1 and n_sample >= 1, f"K3 launches: logpdf {n_logpdf}, sample {n_sample}")
    check(tuple(lp.shape) == (BATCH,) and bool(torch.isfinite(lp).all()), "logpdf not finite")
    check(tuple(samples.shape) == (BATCH, icnf_k.nvars) and bool(torch.isfinite(samples).all()), "samples not finite")
    check(bool(torch.isfinite(lp_samples).all()), "logpdf of samples not finite")
    print(f"serving path: logpdf mean {float(lp.mean()):.4f}, logpdf(samples) mean "
          f"{float(lp_samples.mean()):.4f}, K3 launches {launches}")

    with torch.no_grad():
        _, _, st = cnf.inference(icnf_k, cnf.Mode.TEST, xs, ps)
        nfe = int(st.nfe)
        ms_k = cuda_ms(lambda: dist.logpdf(xs), 10)
        ms_s = cuda_ms(lambda: dist.sample(BATCH, generator=gen), 10)
        ms_p = cuda_ms(lambda: cnf.inference(icnf_p, cnf.Mode.TEST, xs, ps), 1, warmup=False)
        ms_kernel = cuda_ms(lambda: fs.run_solve_kernel(TSIT5, spec, **kw), 10)
        ms_plain = cuda_ms(lambda: fs.solve_test_plain(TSIT5, spec, **kw), 1, warmup=False)
    print(f"logpdf B={BATCH}: kernel {ms_k:.4f} ms ({BATCH / ms_k * 1e3:.1f} evals/s, "
          f"{ms_k * 1e3 / nfe:.3f} us/NFE), plain {ms_p:.4f} ms ({BATCH / ms_p * 1e3:.1f} evals/s); "
          f"steps {int(st.steps)}, NFE {nfe}")
    print(f"sample n={BATCH}: kernel {ms_s:.4f} ms ({BATCH / ms_s * 1e3:.1f} samples/s)")
    print(f"K3 alone: {ms_kernel:.4f} ms, plain version {ms_plain:.4f} ms ({steps_k} steps)")
    dz, H = zdim, spec.out_dims[0]
    return kernel_record(fs.K3_KERNEL, "k3_test_solve.cu", "continuousnf_tpu/ops/fused_solve.py:1043", launches,
                         err_k3, ms_kernel, ms_plain, two_layer_fma(dz, H)["k3"], BATCH, steps_k,
                         2 * dz * H + H + dz + 2 * BATCH * (dz + 1))


def training(cnf, fs, TSIT5, icnf_k, icnf_p, ps_np, xs, rng, dev):
    """Phases 7 to 10 for K1, K2 and the training step.  Returns their
    records."""
    import torch
    from continuousnf_tpu_torch.utils.configs import cuda_ms, make_icnf, model_data

    opts = icnf_k.solver
    zdim = icnf_k.zdim
    ps = cnf.params_from_numpy(ps_np, dev)
    spec = fs.chain_spec(icnf_k.nn, zdim)
    T = lambda a: torch.from_numpy(a.astype("float32")).to(dev)
    eps = T(rng.normal(size=(1, BATCH, zdim)))
    base = dict(norm_z=True, norm_j=True, rtol=opts.rtol, atol=opts.atol, max_steps=opts.max_steps,
                ws=[p["w"] for p in ps], bs=[p["b"] for p in ps], eps=eps)

    # Phase 7a: K1 against its twin, from nonzero accumulators.
    kw1 = dict(base, z0=torch.cat([xs, torch.zeros((BATCH, icnf_k.naugmented), device=dev)], dim=1),
               acc0=T(rng.normal(0.0, 0.1, (3, BATCH))), t0=torch.tensor(0.0, device=dev),
               t1=torch.tensor(icnf_k.tspan[1], device=dev), dt_init=torch.tensor(0.05, device=dev))
    with torch.no_grad():
        out_k = fs.run_train_solve_kernel(TSIT5, spec, **kw1)
        out_p = fs.solve_train_plain(TSIT5, spec, **kw1)
    torch.cuda.synchronize()
    abs1 = hold_forward("K1", out_k, out_p)

    # Phase 7b: K2 against its twin from K1's final state, a loss-like
    # cotangent and K1's last step as the warm start.
    kw2 = dict(base, zT=out_k[0], accT=out_k[1], azT=T(rng.normal(0.0, 1.0 / BATCH, (BATCH, zdim))),
               aaccT=T(np.stack([np.full(BATCH, 1.0 / BATCH), np.full(BATCH, 1e-2 / BATCH),
                                 np.full(BATCH, 1e-2 / BATCH)])),
               t_hi=torch.tensor(icnf_k.tspan[1], device=dev), t_lo=torch.tensor(0.0, device=dev),
               dt_init=-out_k[4].abs())
    with torch.no_grad():
        adj_k = fs.run_adjoint_kernel(TSIT5, spec, **kw2)
        adj_p = fs.adjoint_train_plain(TSIT5, spec, **kw2)
        adj_64 = fs.adjoint_train_plain(TSIT5, spec, **{k: to64(v) for k, v in kw2.items()})
    torch.cuda.synchronize()
    abs2 = hold_adjoint("K2", adj_k, adj_p, adj_64)

    # Phase 8: the loss and its gradient through both paths, same draws.
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    eps_s = icnf_k.draw_eps(gen, BATCH, dev)
    steer_r = 0.05

    kw = dict(eps=eps_s, steer_r=steer_r)
    n1, n2 = fs.run_train_solve_kernel.launches, fs.run_adjoint_kernel.launches
    l_k, g_k, m_k = loss_grad(cnf, icnf_k, ps_np, xs, dev, **kw)
    check(fs.run_train_solve_kernel.launches == n1 + 1 and fs.run_adjoint_kernel.launches == n2 + 1,
          "the fused gradient did not run K1 and K2 once each")
    l_p, g_p, _ = loss_grad(cnf, icnf_p, ps_np, xs, dev, **kw)
    icnf_t = make_icnf("flagship", dev, fused=False, dtype=torch.float64,
                       solver=cnf.SolverOptions(rtol=1e-7, atol=1e-9))
    l_t, g_t, _ = loss_grad(cnf, icnf_t, ps_np, xs, dev, torch.float64, eps=eps_s.double(), steer_r=steer_r)
    torch.cuda.synchronize()
    hold_gradients("Hutchinson", l_k, g_k, l_p, g_p, l_t, g_t)
    print(f"train step B={BATCH}: loss fused {float(l_k):.6f} plain {float(l_p):.6f} float64 {float(l_t):.6f}, "
          f"forward NFE {int(m_k['nfe'])}")

    # Phase 9: the training path, counters reset just before it.
    res = fit_path(cnf, fs, icnf_k, ps_np, dev, model_data("flagship", np.random.default_rng(SEED + 2), N_STEPS * BATCH))
    n_k1, n_k2 = fs.run_train_solve_kernel.launches, fs.run_adjoint_kernel.launches
    check(n_k1 >= N_STEPS and n_k2 >= N_STEPS, f"fit launched K1 {n_k1} and K2 {n_k2} times")
    print(f"training path: fit {N_STEPS} Lion steps at B={BATCH}, epoch loss {float(res.losses[0]):.6f}, "
          f"{float(res.metrics['samples_per_s'][0]):.1f} samples/s (host clock), K1 launches {n_k1}, "
          f"K2 launches {n_k2}")

    # Phase 10: the K1 and K2 chain forms on this 2-layer net, held to the
    # same twins, then timings.  The chain forms are timed beside K1 and K2
    # (order 2-layer, chain, chain, 2-layer) at BATCH and BATCH / 8: the
    # fused solve keeps K1 and K2 for 2-layer nets where they are faster.
    with torch.no_grad():
        out_c = fs.run_chain_train_solve_kernel(TSIT5, spec, **kw1)
        adj_c = fs.run_chain_adjoint_kernel(TSIT5, spec, **kw2)
    torch.cuda.synchronize()
    hold_forward("K1 chain form, 2 layers", out_c, out_p)
    hold_adjoint("K2 chain form, 2 layers", adj_c, adj_p, adj_64)
    ms_step = step_ms(cnf, icnf_k, ps_np, xs, gen, dev, 5)
    ms_step_p = step_ms(cnf, icnf_p, ps_np, xs, gen, dev, 1, warmup=False)
    with torch.no_grad():
        ms_k1, ms_k1c = paired_ms(lambda: fs.run_train_solve_kernel(TSIT5, spec, **kw1),
                                  lambda: fs.run_chain_train_solve_kernel(TSIT5, spec, **kw1), 10)
        ms_p1 = cuda_ms(lambda: fs.solve_train_plain(TSIT5, spec, **kw1), 1, warmup=False)
        ms_k2, ms_k2c = paired_ms(lambda: fs.run_adjoint_kernel(TSIT5, spec, **kw2),
                                  lambda: fs.run_chain_adjoint_kernel(TSIT5, spec, **kw2), 10)
        ms_p2 = cuda_ms(lambda: fs.adjoint_train_plain(TSIT5, spec, **kw2), 1, warmup=False)
        b = BATCH // 8
        kw1_b = dict(kw1, z0=kw1["z0"][:b], eps=eps[:, :b], acc0=kw1["acc0"][:, :b])
        out_b = fs.run_train_solve_kernel(TSIT5, spec, **kw1_b)
        kw2_b = dict(kw2, eps=eps[:, :b], zT=out_b[0], accT=out_b[1], azT=kw2["azT"][:b], aaccT=kw2["aaccT"][:, :b],
                     dt_init=-out_b[4].abs())
        small = [paired_ms(lambda: fs.run_train_solve_kernel(TSIT5, spec, **kw1_b),
                           lambda: fs.run_chain_train_solve_kernel(TSIT5, spec, **kw1_b), 10),
                 paired_ms(lambda: fs.run_adjoint_kernel(TSIT5, spec, **kw2_b),
                           lambda: fs.run_chain_adjoint_kernel(TSIT5, spec, **kw2_b), 10)]
    print(f"train step B={BATCH} (loss, gradient, Lion): fused {ms_step:.4f} ms "
          f"({BATCH / ms_step * 1e3:.1f} samples/s), plain {ms_step_p:.4f} ms ({BATCH / ms_step_p * 1e3:.1f} samples/s)")
    print(f"K1 alone: {ms_k1:.4f} ms, plain version {ms_p1:.4f} ms ({int(out_k[2])} steps); "
          f"the K1 chain form on the same input {ms_k1c:.4f} ms ({ms_k1c / ms_k1:.3f}x)")
    print(f"K2 alone: {ms_k2:.4f} ms, plain version {ms_p2:.4f} ms ({int(adj_k[5])} steps); "
          f"the K2 chain form on the same input {ms_k2c:.4f} ms ({ms_k2c / ms_k2:.3f}x)")
    print(f"B={b}: K1 {small[0][0]:.4f} ms, the K1 chain form {small[0][1]:.4f} ms ({small[0][1] / small[0][0]:.3f}x); "
          f"K2 {small[1][0]:.4f} ms, the K2 chain form {small[1][1]:.4f} ms ({small[1][1] / small[1][0]:.3f}x)")
    dz, H = zdim, spec.out_dims[0]
    fma, P = two_layer_fma(dz, H), 2 * dz * H + H + dz
    return [
        kernel_record(fs.K1_KERNEL, "k1_train_solve.cu", "continuousnf_tpu/ops/fused_solve.py:1043", n_k1, abs1,
                      ms_k1, ms_p1, fma["k1"], BATCH, out_k[2], P + BATCH * (3 * dz + 6)),
        kernel_record(fs.K2_KERNEL, "k2_train_adjoint.cu", "continuousnf_tpu/ops/fused_solve.py:1767", n_k2, abs2,
                      ms_k2, ms_p2, fma["k2"], BATCH, adj_k[5], 2 * P + BATCH * (5 * dz + 9)),
    ]


def exact_training(cnf, fs, TSIT5, ps_np, xs, rng, dev):
    """Phases 11 to 14 for the K4 forward, the K4 adjoint and the exact
    training step.  Returns their records."""
    import torch
    from continuousnf_tpu_torch.utils.configs import cuda_ms, make_icnf, model_data

    icnf_k, icnf_p = (make_icnf("flagship", dev, fused=fused, exact=True) for fused in (True, False))
    zdim = icnf_k.zdim
    opts = icnf_k.solver
    ps = cnf.params_from_numpy(ps_np, dev)
    spec = fs.chain_spec(icnf_k.nn, zdim)
    T = lambda a: torch.from_numpy(a.astype("float32")).to(dev)
    base = dict(norm_z=True, norm_j=True, rtol=opts.rtol, atol=opts.atol, max_steps=opts.max_steps,
                ws=[p["w"] for p in ps], bs=[p["b"] for p in ps])

    # Phase 11a: the K4 forward against its twin, from nonzero accumulators.
    kw1 = dict(base, z0=torch.cat([xs, torch.zeros((BATCH, icnf_k.naugmented), device=dev)], dim=1),
               acc0=T(rng.normal(0.0, 0.1, (3, BATCH))), t0=torch.tensor(0.0, device=dev),
               t1=torch.tensor(icnf_k.tspan[1], device=dev), dt_init=torch.tensor(0.05, device=dev))
    with torch.no_grad():
        out_k = fs.run_exact_solve_kernel(TSIT5, spec, **kw1)
        out_p = fs.solve_train_exact_plain(TSIT5, spec, **kw1)
    torch.cuda.synchronize()
    abs_f = hold_forward("K4 forward", out_k, out_p)

    # Phase 11b: the K4 adjoint against its twin from the K4 forward's final
    # state, a loss-like cotangent and its last step as the warm start.
    kw2 = dict(base, zT=out_k[0], accT=out_k[1], azT=T(rng.normal(0.0, 1.0 / BATCH, (BATCH, zdim))),
               aaccT=T(np.stack([np.full(BATCH, 1.0 / BATCH), np.full(BATCH, 1e-2 / BATCH),
                                 np.full(BATCH, 1e-2 / BATCH)])),
               t_hi=torch.tensor(icnf_k.tspan[1], device=dev), t_lo=torch.tensor(0.0, device=dev),
               dt_init=-out_k[4].abs())
    with torch.no_grad():
        adj_k = fs.run_exact_adjoint_kernel(TSIT5, spec, **kw2)
        adj_p = fs.adjoint_train_exact_plain(TSIT5, spec, **kw2)
        adj_64 = fs.adjoint_train_exact_plain(TSIT5, spec, **{k: to64(v) for k, v in kw2.items()})
    torch.cuda.synchronize()
    check((int(adj_k[5]), int(adj_k[6])) == (int(adj_p[5]), int(adj_p[6])),
          f"K4 adjoint steps/accepted {int(adj_k[5])}/{int(adj_k[6])} != plain {int(adj_p[5])}/{int(adj_p[6])}")
    check(all(bool(torch.isfinite(x).all()) for x in [adj_k[0], adj_k[2]] + adj_k[3] + adj_k[4]),
          "K4 adjoint output not finite")
    hold_backward_state("K4 adjoint", adj_k, adj_p, adj_64)
    e_g = [float((a - b).abs().max()) / float(b.abs().max()) for a, b in zip(adj_k[3] + adj_k[4], adj_p[3] + adj_p[4])]
    check(max(e_g) <= GRAD_TOL, f"K4 adjoint gradients differ from the twin: w1, w2, b1, b2 (of max|g|) {e_g}")
    abs_a = max(float((a - b).abs().max()) for a, b in zip(
        [adj_k[0], adj_k[2]] + adj_k[3] + adj_k[4], [adj_p[0], adj_p[2]] + adj_p[3] + adj_p[4]))
    print(f"K4 adjoint vs plain: steps {int(adj_k[5])}, chained gradient errors (of max|g|) g_w1 {e_g[0]:.3e}, "
          f"g_w2 {e_g[1]:.3e}, g_b1 {e_g[2]:.3e}, g_b2 {e_g[3]:.3e}")

    # Phase 12: the exact loss and its gradient through both paths.
    n_f, n_a = fs.run_exact_solve_kernel.launches, fs.run_exact_adjoint_kernel.launches
    l_k, g_k, m_k = loss_grad(cnf, icnf_k, ps_np, xs, dev, steer_r=0.05)
    check((fs.run_exact_solve_kernel.launches, fs.run_exact_adjoint_kernel.launches) == (n_f + 1, n_a + 1),
          "the exact fused gradient did not run the K4 forward and adjoint once each")
    l_p, g_p, _ = loss_grad(cnf, icnf_p, ps_np, xs, dev, steer_r=0.05)
    icnf_t = make_icnf("flagship", dev, fused=False, exact=True, dtype=torch.float64,
                       solver=cnf.SolverOptions(rtol=1e-7, atol=1e-9))
    l_t, g_t, _ = loss_grad(cnf, icnf_t, ps_np, xs, dev, torch.float64, steer_r=0.05)
    torch.cuda.synchronize()
    hold_gradients("exact", l_k, g_k, l_p, g_p, l_t, g_t)
    print(f"exact train step B={BATCH}: loss fused {float(l_k):.6f} plain {float(l_p):.6f} float64 {float(l_t):.6f}, "
          f"forward NFE {int(m_k['nfe'])}")

    # Phase 13: the exact training path, counters reset just before it.
    res = fit_path(cnf, fs, icnf_k, ps_np, dev, model_data("flagship", np.random.default_rng(SEED + 3), N_STEPS * BATCH))
    n_fwd, n_adj = fs.run_exact_solve_kernel.launches, fs.run_exact_adjoint_kernel.launches
    check(n_fwd == N_STEPS and n_adj == N_STEPS,
          f"exact fit launched the K4 forward {n_fwd} and the K4 adjoint {n_adj} times")
    print(f"exact training path: fit {N_STEPS} Lion steps at B={BATCH}, epoch loss {float(res.losses[0]):.6f}, "
          f"{float(res.metrics['samples_per_s'][0]):.1f} samples/s (host clock), K4 forward launches {n_fwd}, "
          f"K4 adjoint launches {n_adj}")

    # Phase 14: timings.
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    steps = [step_ms(cnf, icnf_k, ps_np, xs, gen, dev, 5), step_ms(cnf, icnf_p, ps_np, xs, gen, dev, 1, warmup=False)]
    with torch.no_grad():
        ms_f = cuda_ms(lambda: fs.run_exact_solve_kernel(TSIT5, spec, **kw1), 10)
        ms_pf = cuda_ms(lambda: fs.solve_train_exact_plain(TSIT5, spec, **kw1), 1, warmup=False)
        ms_a = cuda_ms(lambda: fs.run_exact_adjoint_kernel(TSIT5, spec, **kw2), 5)
        ms_pa = cuda_ms(lambda: fs.adjoint_train_exact_plain(TSIT5, spec, **kw2), 1, warmup=False)
    print(f"exact train step B={BATCH} (loss, gradient, Lion): fused {steps[0]:.4f} ms "
          f"({BATCH / steps[0] * 1e3:.1f} samples/s), plain {steps[1]:.4f} ms ({BATCH / steps[1] * 1e3:.1f} samples/s)")
    print(f"K4 forward alone: {ms_f:.4f} ms, plain version {ms_pf:.4f} ms ({int(out_k[2])} steps, "
          f"{ms_f * 1e3 / int(out_k[2]):.1f} us per attempted step)")
    print(f"K4 adjoint alone: {ms_a:.4f} ms, plain version {ms_pa:.4f} ms ({int(adj_k[5])} steps, "
          f"{ms_a * 1e3 / int(adj_k[5]):.1f} us per attempted step)")
    dz, H = zdim, spec.out_dims[0]
    fma, P = two_layer_fma(dz, H), 2 * dz * H + H + dz
    return [
        kernel_record(fs.K4_KERNEL, "k4_exact_solve.cu", "continuousnf_tpu/ops/fused_solve.py:1043", n_fwd, abs_f,
                      ms_f, ms_pf, fma["k4"], BATCH, out_k[2], P + BATCH * (2 * dz + 6)),
        kernel_record(fs.K4A_KERNEL, "k4_exact_adjoint.cu", "continuousnf_tpu/ops/fused_solve.py:1767", n_adj, abs_a,
                      ms_a, ms_pa, fma["k4a"], BATCH, adj_k[5], 2 * P + BATCH * (4 * dz + 9)),
    ]


def deep_chain(cnf, fs, TSIT5, rng, dev):
    """Phases 15 to 22: the power6 model through the chain kernels.  Returns
    their records."""
    import torch
    from continuousnf_tpu_torch.utils.configs import MODELS, cuda_ms, glorot_params, make_icnf, model_data

    dims = MODELS["power6"]["dims"]
    dz = dims[-1]
    ps_np = glorot_params(rng, dims)
    xs_np = model_data("power6", rng, BATCH)
    ps = cnf.params_from_numpy(ps_np, dev)
    xs = torch.from_numpy(xs_np).to(dev)
    T = lambda a: torch.from_numpy(a.astype("float32")).to(dev)

    def model(fused: bool, exact: bool = False, dtype=torch.float32, **kw):
        return make_icnf("power6", dev, fused=fused, exact=exact, dtype=dtype, **kw)

    icnf_k, icnf_p = model(True), model(False)
    opts = icnf_k.solver
    spec = fs.chain_spec(icnf_k.nn, dz)
    widths = ", ".join(str(w) for w in dims)
    for lib_name, fn in ((fs.K1C_KERNEL, "cnf_k1c_smem_bytes"), (fs.K7_KERNEL, "cnf_k7_smem_bytes"),
                         (fs.K2C_KERNEL, "cnf_k2c_smem_bytes")):
        arr = (ctypes.c_int * len(dims))(*dims)
        sizes = {blk: getattr(fs._library(lib_name), fn)(len(dims) - 1, arr, blk) for blk in (128, 64, 32)}
        print(f"{lib_name} dynamic shared memory per block at widths ({widths}): "
              + ", ".join(f"{v} bytes at {k} threads" for k, v in sizes.items()))
    base = dict(rtol=opts.rtol, atol=opts.atol, max_steps=opts.max_steps,
                ws=[p["w"] for p in ps], bs=[p["b"] for p in ps])
    span = dict(t0=torch.tensor(0.0, device=dev), t1=torch.tensor(1.0, device=dev),
                dt_init=torch.tensor(0.05, device=dev))

    # Phase 16: the K1 chain form from nonzero accumulators, the K2 chain form
    # from its output.
    eps = T(rng.normal(size=(1, BATCH, dz)))
    train = dict(base, norm_z=True, norm_j=True, eps=eps)
    kw1 = dict(train, z0=xs, acc0=T(rng.normal(0.0, 0.1, (3, BATCH))), **span)
    with torch.no_grad():
        out_k = fs.run_chain_train_solve_kernel(TSIT5, spec, **kw1)
        out_p = fs.solve_train_plain(TSIT5, spec, **kw1)
    torch.cuda.synchronize()
    abs1 = hold_forward("K1 chain form", out_k, out_p)
    kw2 = dict(train, zT=out_k[0], accT=out_k[1], azT=T(rng.normal(0.0, 1.0 / BATCH, (BATCH, dz))),
               aaccT=T(np.stack([np.full(BATCH, 1.0 / BATCH), np.full(BATCH, 1e-2 / BATCH),
                                 np.full(BATCH, 1e-2 / BATCH)])),
               t_hi=torch.tensor(1.0, device=dev), t_lo=torch.tensor(0.0, device=dev), dt_init=-out_k[4].abs())
    with torch.no_grad():
        adj_k = fs.run_chain_adjoint_kernel(TSIT5, spec, **kw2)
        adj_p = fs.adjoint_train_plain(TSIT5, spec, **kw2)
        adj_64 = fs.adjoint_train_plain(TSIT5, spec, **{k: to64(v) for k, v in kw2.items()})
    torch.cuda.synchronize()
    abs2 = hold_adjoint("K2 chain form", adj_k, adj_p, adj_64)

    # Phase 17: K7 TEST and the K7 exact forward.
    kwt = dict(base, z0=xs, dlogp0=T(rng.normal(0.0, 0.1, BATCH)), **span)
    kwe = dict(base, norm_z=True, norm_j=True, z0=xs, acc0=T(rng.normal(0.0, 0.1, (3, BATCH))), **span)
    with torch.no_grad():
        t_k = fs.run_chain_test_solve_kernel(TSIT5, spec, **kwt)
        t_p = fs.solve_test_plain(TSIT5, spec, **kwt)
        e_k = fs.run_chain_exact_solve_kernel(TSIT5, spec, **kwe)
        e_p = fs.solve_train_exact_plain(TSIT5, spec, **kwe)
    torch.cuda.synchronize()
    abs_t = hold_forward("K7 TEST", t_k, t_p)
    abs_e = hold_forward("K7 exact", e_k, e_p)

    # Phase 18: serving through K7 TEST, counters reset just before it.
    hold_logpdf(cnf, "power6", icnf_k, icnf_p, xs, ps)
    dist = cnf.ICNFDist(icnf_k, cnf.Mode.TEST, ps)
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    k7t = fs.run_chain_test_solve_kernel
    fs.reset_launches()
    with torch.no_grad():
        lp = dist.logpdf(xs)
        n_logpdf = k7t.launches
        samples = dist.sample(BATCH, generator=gen)
        n_sample = k7t.launches - n_logpdf
    torch.cuda.synchronize()
    n_k7t = k7t.launches
    others = {k: w.launches for k, w in fs.KERNEL_WRAPPERS.items() if w is not k7t and w.launches}
    check(n_logpdf >= 1 and n_sample >= 1 and not others,
          f"K7 TEST launches: logpdf {n_logpdf}, sample {n_sample}; other kernels {others}")
    check(tuple(lp.shape) == (BATCH,) and bool(torch.isfinite(lp).all()), "power6 logpdf not finite")
    check(tuple(samples.shape) == (BATCH, dz) and bool(torch.isfinite(samples).all()), "power6 samples not finite")
    print(f"power6 serving path: logpdf mean {float(lp.mean()):.4f}, sample mean |x| "
          f"{float(samples.abs().mean()):.4f}, K7 TEST launches {n_k7t}")

    # Phase 19: the Hutchinson loss and its gradient through both paths.
    gen = torch.Generator(device=dev).manual_seed(SEED + 6)
    eps_s = icnf_k.draw_eps(gen, BATCH, dev)
    n1, n2 = fs.run_chain_train_solve_kernel.launches, fs.run_chain_adjoint_kernel.launches
    l_k, g_k, m_k = loss_grad(cnf, icnf_k, ps_np, xs, dev, eps=eps_s)
    check((fs.run_chain_train_solve_kernel.launches, fs.run_chain_adjoint_kernel.launches) == (n1 + 1, n2 + 1),
          "the fused power6 gradient did not run the K1 and K2 chain forms once each")
    l_p, g_p, _ = loss_grad(cnf, icnf_p, ps_np, xs, dev, eps=eps_s)
    icnf_t = model(False, dtype=torch.float64, solver=cnf.SolverOptions(rtol=1e-7, atol=1e-9))
    l_t, g_t, _ = loss_grad(cnf, icnf_t, ps_np, xs, dev, torch.float64, eps=eps_s.double())
    torch.cuda.synchronize()
    hold_gradients("power6 Hutchinson", l_k, g_k, l_p, g_p, l_t, g_t)
    print(f"power6 train step B={BATCH}: loss fused {float(l_k):.6f} plain {float(l_p):.6f} "
          f"float64 {float(l_t):.6f}, forward NFE {int(m_k['nfe'])}")

    # Phase 20: the training path, counters reset just before it.
    X = model_data("power6", np.random.default_rng(SEED + 7), N_STEPS * BATCH)
    res = fit_path(cnf, fs, icnf_k, ps_np, dev, X)
    n_k1c, n_k2c = fs.run_chain_train_solve_kernel.launches, fs.run_chain_adjoint_kernel.launches
    check(n_k1c >= N_STEPS and n_k2c >= N_STEPS, f"power6 fit launched the K1 chain form {n_k1c} and the K2 chain "
          f"form {n_k2c} times")
    print(f"power6 training path: fit {N_STEPS} Lion steps at B={BATCH}, epoch loss {float(res.losses[0]):.6f}, "
          f"{float(res.metrics['samples_per_s'][0]):.1f} samples/s (host clock), K1 chain form launches {n_k1c}, "
          f"K2 chain form launches {n_k2c}")

    # Phase 21: the exact loss and gradient (K7 exact forward, plain
    # backward), then the exact training path.
    icnf_ek, icnf_ep = model(True, True), model(False, True)
    n7 = fs.run_chain_exact_solve_kernel.launches
    l_k, g_k, m_k = loss_grad(cnf, icnf_ek, ps_np, xs, dev)
    check(fs.run_chain_exact_solve_kernel.launches == n7 + 1, "the exact power6 gradient did not run K7 exact once")
    l_p, g_p, _ = loss_grad(cnf, icnf_ep, ps_np, xs, dev)
    icnf_t = model(False, True, torch.float64, solver=cnf.SolverOptions(rtol=1e-7, atol=1e-9))
    l_t, g_t, _ = loss_grad(cnf, icnf_t, ps_np, xs, dev, torch.float64)
    torch.cuda.synchronize()
    hold_gradients("power6 exact", l_k, g_k, l_p, g_p, l_t, g_t)
    res = fit_path(cnf, fs, icnf_ek, ps_np, dev, X)
    n_k7e = fs.run_chain_exact_solve_kernel.launches
    check(n_k7e >= N_STEPS, f"power6 exact fit launched K7 exact {n_k7e} times")
    print(f"power6 exact training path: fit {N_STEPS} Lion steps at B={BATCH}, epoch loss "
          f"{float(res.losses[0]):.6f}, {float(res.metrics['samples_per_s'][0]):.1f} samples/s (host clock), "
          f"K7 exact launches {n_k7e}")

    # Phase 22: timings.
    gen = torch.Generator(device=dev).manual_seed(SEED + 9)
    ms_step = step_ms(cnf, icnf_k, ps_np, xs, gen, dev, 5)
    ms_step_p = step_ms(cnf, icnf_p, ps_np, xs, gen, dev, 1, warmup=False)
    ms_estep = step_ms(cnf, icnf_ek, ps_np, xs, gen, dev, 2)
    with torch.no_grad():
        _, _, st = cnf.inference(icnf_k, cnf.Mode.TEST, xs, ps)
        ms_lp = cuda_ms(lambda: dist.logpdf(xs), 10)
        ms_lp_p = cuda_ms(lambda: cnf.inference(icnf_p, cnf.Mode.TEST, xs, ps), 1, warmup=False)
        times = {}
        for name, kernel, plain, kw in (
            ("k1c", fs.run_chain_train_solve_kernel, fs.solve_train_plain, kw1),
            ("k2c", fs.run_chain_adjoint_kernel, fs.adjoint_train_plain, kw2),
            ("k7t", fs.run_chain_test_solve_kernel, fs.solve_test_plain, kwt),
            ("k7e", fs.run_chain_exact_solve_kernel, fs.solve_train_exact_plain, kwe),
        ):
            times[name] = (cuda_ms(lambda: kernel(TSIT5, spec, **kw), 5),
                           cuda_ms(lambda: plain(TSIT5, spec, **kw), 1, warmup=False))
    print(f"power6 train step B={BATCH} (loss, gradient, Lion): fused {ms_step:.4f} ms "
          f"({BATCH / ms_step * 1e3:.1f} samples/s), plain {ms_step_p:.4f} ms ({BATCH / ms_step_p * 1e3:.1f} samples/s)")
    print(f"power6 exact train step B={BATCH}: fused forward, plain backward {ms_estep:.4f} ms "
          f"({BATCH / ms_estep * 1e3:.1f} samples/s)")
    print(f"power6 logpdf B={BATCH}: kernel {ms_lp:.4f} ms ({BATCH / ms_lp * 1e3:.1f} evals/s), plain {ms_lp_p:.4f} ms; "
          f"steps {int(st.steps)}, NFE {int(st.nfe)}")
    steps = {"k1c": out_k[2], "k2c": adj_k[5], "k7t": t_k[2], "k7e": e_k[2]}
    for name, label in (("k1c", "K1 chain form"), ("k2c", "K2 chain form"), ("k7t", "K7 TEST"), ("k7e", "K7 exact")):
        ms_k, ms_p = times[name]
        n = int(steps[name])
        print(f"{label} alone: {ms_k:.4f} ms, plain version {ms_p:.4f} ms ({n} steps, "
              f"{ms_k * 1e3 / max(n, 1):.1f} us per attempted step)")
    fma = chain_fma(dims)
    P = sum(a * b + b for a, b in zip(dims[:-1], dims[1:]))
    return [
        kernel_record(fs.K1C_KERNEL, "k1_chain_solve.cu", "continuousnf_tpu/ops/fused_solve.py:1043", n_k1c, abs1,
                      *times["k1c"], fma["k1c"], BATCH, out_k[2], P + BATCH * (3 * dz + 6)),
        kernel_record(fs.K2C_KERNEL, "k2_chain_adjoint.cu", "continuousnf_tpu/ops/fused_solve.py:1767", n_k2c, abs2,
                      *times["k2c"], fma["k2c"], BATCH, adj_k[5], 2 * P + BATCH * (5 * dz + 9)),
        kernel_record(fs.K7_KERNEL + "/test", "k7_chain_solve.cu", "continuousnf_tpu/ops/fused_solve.py:1043",
                      n_k7t, abs_t, *times["k7t"], fma["k7t"], BATCH, t_k[2], P + BATCH * (2 * dz + 2)),
        kernel_record(fs.K7_KERNEL + "/exact", "k7_chain_solve.cu", "continuousnf_tpu/ops/fused_solve.py:1043",
                      n_k7e, abs_e, *times["k7e"], fma["k7e"], BATCH, e_k[2], P + BATCH * (2 * dz + 6)),
    ]


def conditional(cnf, fs, TSIT5, rng, dev):
    """Phases 23 to 29: the conditional recipe through the chain kernels with
    conditioning rows (K8).  Returns their records."""
    import torch
    from continuousnf_tpu_torch.utils.configs import MODELS, cuda_ms, glorot_params, make_icnf, model_data

    cfg = MODELS["cond_gaussian"]
    dims, nc, b_fit = cfg["dims"], cfg["n_cond"], cfg["batch_size"]
    dz = dims[-1]
    ps_np = glorot_params(rng, dims)
    xs_np, ys_np = model_data("cond_gaussian", rng, BATCH)
    ps = cnf.params_from_numpy(ps_np, dev)
    xs, ys = torch.from_numpy(xs_np).to(dev), torch.from_numpy(ys_np).to(dev)
    T = lambda a: torch.from_numpy(a.astype("float32")).to(dev)

    def model(fused: bool, exact: bool = False, dtype=torch.float32, **kw):
        return make_icnf("cond_gaussian", dev, fused=fused, exact=exact, dtype=dtype, **kw)

    icnf_k, icnf_p = model(True), model(False)
    opts = icnf_k.solver
    spec = fs.chain_spec(icnf_k.nn, dz)
    widths = ", ".join(str(w) for w in dims)
    for lib_name, fn in ((fs.K1C_KERNEL, "cnf_k1c_smem_bytes"), (fs.K7_KERNEL, "cnf_k7_smem_bytes"),
                         (fs.K2C_KERNEL, "cnf_k2c_smem_bytes")):
        arr = (ctypes.c_int * len(dims))(*dims)
        sizes = {blk: getattr(fs._library(lib_name), fn)(len(dims) - 1, arr, blk) for blk in (128, 64, 32)}
        print(f"{lib_name} dynamic shared memory per block at widths ({widths}), {nc} conditioning input: "
              + ", ".join(f"{v} bytes at {k} threads" for k, v in sizes.items()))
    t1 = cfg["tspan"][1]
    base = dict(rtol=opts.rtol, atol=opts.atol, max_steps=opts.max_steps,
                ws=[p["w"] for p in ps], bs=[p["b"] for p in ps], ys=ys)
    span = dict(t0=torch.tensor(0.0, device=dev), t1=torch.tensor(t1, device=dev),
                dt_init=torch.tensor(0.05, device=dev))

    # Phase 24: the K1 chain form with ys from nonzero accumulators, the K2
    # chain form with ys from its output.
    eps = T(rng.normal(size=(1, BATCH, dz)))
    train = dict(base, norm_z=True, norm_j=True, eps=eps)
    kw1 = dict(train, z0=xs, acc0=T(rng.normal(0.0, 0.1, (3, BATCH))), **span)
    with torch.no_grad():
        out_k = fs.run_chain_train_solve_kernel(TSIT5, spec, **kw1)
        out_p = fs.solve_train_plain(TSIT5, spec, **kw1)
    torch.cuda.synchronize()
    abs1 = hold_forward("K1 chain form with ys", out_k, out_p, (fs.solve_train_plain, spec, kw1))
    kw2 = dict(train, zT=out_k[0], accT=out_k[1], azT=T(rng.normal(0.0, 1.0 / BATCH, (BATCH, dz))),
               aaccT=T(np.stack([np.full(BATCH, 1.0 / BATCH), np.full(BATCH, 1e-2 / BATCH),
                                 np.full(BATCH, 1e-2 / BATCH)])),
               t_hi=torch.tensor(t1, device=dev), t_lo=torch.tensor(0.0, device=dev), dt_init=-out_k[4].abs())
    with torch.no_grad():
        adj_k = fs.run_chain_adjoint_kernel(TSIT5, spec, **kw2)
        adj_p = fs.adjoint_train_plain(TSIT5, spec, **kw2)
        adj_64 = fs.adjoint_train_plain(TSIT5, spec, **{k: to64(v) for k, v in kw2.items()})
    torch.cuda.synchronize()
    abs2 = hold_adjoint("K2 chain form with ys", adj_k, adj_p, adj_64, (fs.adjoint_train_plain, spec, kw2))
    check(len(adj_k) == 8 and float(adj_k[3][0][dz:].abs().max()) > 0.0,
          "the K2 chain form returned no a_ys0 or a zero gradient for the ys rows of W0")

    # Phase 25: K7 TEST and K7 exact with ys.
    kwt = dict(base, z0=xs, dlogp0=T(rng.normal(0.0, 0.1, BATCH)), **span)
    kwe = dict(base, norm_z=True, norm_j=True, z0=xs, acc0=T(rng.normal(0.0, 0.1, (3, BATCH))), **span)
    with torch.no_grad():
        t_k = fs.run_chain_test_solve_kernel(TSIT5, spec, **kwt)
        t_p = fs.solve_test_plain(TSIT5, spec, **kwt)
        e_k = fs.run_chain_exact_solve_kernel(TSIT5, spec, **kwe)
        e_p = fs.solve_train_exact_plain(TSIT5, spec, **kwe)
    torch.cuda.synchronize()
    abs_t = hold_forward("K7 TEST with ys", t_k, t_p, (fs.solve_test_plain, spec, kwt))
    abs_e = hold_forward("K7 exact with ys", e_k, e_p, (fs.solve_train_exact_plain, spec, kwe))

    # Phase 26: serving through CondICNFDist, counters reset just before it.
    hold_logpdf(cnf, "conditional", icnf_k, icnf_p, xs, ps, ys)
    dist = cnf.CondICNFDist(icnf_k, cnf.Mode.TEST, ps, ys)
    one = cnf.CondICNFDist(icnf_k, cnf.Mode.TEST, ps, torch.tensor([0.5], device=dev))
    gen = torch.Generator(device=dev).manual_seed(SEED + 10)
    k7t = fs.run_chain_test_solve_kernel
    fs.reset_launches()
    with torch.no_grad():
        lp = dist.logpdf(xs)
        n_logpdf = k7t.launches
        samples = one.sample(BATCH, generator=gen)
        n_sample = k7t.launches - n_logpdf
    torch.cuda.synchronize()
    n_k7t = k7t.launches
    others = {k: w.launches for k, w in fs.KERNEL_WRAPPERS.items() if w is not k7t and w.launches}
    check(n_logpdf >= 1 and n_sample >= 1 and not others,
          f"K7 TEST launches: logpdf {n_logpdf}, sample {n_sample}; other kernels {others}")
    check(tuple(lp.shape) == (BATCH,) and bool(torch.isfinite(lp).all()), "conditional logpdf not finite")
    check(tuple(samples.shape) == (BATCH, 1) and bool(torch.isfinite(samples).all()), "conditional samples not finite")
    print(f"conditional serving path: logpdf mean {float(lp.mean()):.4f}, samples given y = 0.5: mean "
          f"{float(samples.mean()):.4f}, std {float(samples.std()):.4f}; K7 TEST launches {n_k7t}")

    # Phase 27: the Hutchinson loss and its gradient in the params and ys.
    gen = torch.Generator(device=dev).manual_seed(SEED + 11)
    eps_s = icnf_k.draw_eps(gen, BATCH, dev)
    steer_r = 0.05
    n1, n2 = fs.run_chain_train_solve_kernel.launches, fs.run_chain_adjoint_kernel.launches
    l_k, g_k, m_k = loss_grad(cnf, icnf_k, ps_np, xs, dev, ys=ys, eps=eps_s, steer_r=steer_r)
    check((fs.run_chain_train_solve_kernel.launches, fs.run_chain_adjoint_kernel.launches) == (n1 + 1, n2 + 1),
          "the fused conditional gradient did not run the K1 and K2 chain forms once each")
    l_p, g_p, _ = loss_grad(cnf, icnf_p, ps_np, xs, dev, ys=ys, eps=eps_s, steer_r=steer_r)
    icnf_t = model(False, dtype=torch.float64, solver=cnf.SolverOptions(rtol=1e-7, atol=1e-9))
    l_t, g_t, _ = loss_grad(cnf, icnf_t, ps_np, xs, dev, torch.float64, ys=ys, eps=eps_s.double(), steer_r=steer_r)
    torch.cuda.synchronize()
    names = [f"{x}{i + 1}" for i in range(len(dims) - 1) for x in ("w", "b")] + ["ys"]
    hold_gradients("conditional Hutchinson", l_k, g_k, l_p, g_p, l_t, g_t, names)
    print(f"conditional train step B={BATCH}: loss fused {float(l_k):.6f} plain {float(l_p):.6f} "
          f"float64 {float(l_t):.6f}, forward NFE {int(m_k['nfe'])}")

    # Phase 28: the training path at the recipe's batch, then the exact loss.
    X, Y = model_data("cond_gaussian", np.random.default_rng(SEED + 12), N_STEPS * b_fit)
    with first_calls(fs, ("run_chain_train_solve_kernel", "run_chain_adjoint_kernel")) as first:
        res = fit_path(cnf, fs, icnf_k, ps_np, dev, X, Y, b_fit)
    n_k1c, n_k2c = fs.run_chain_train_solve_kernel.launches, fs.run_chain_adjoint_kernel.launches
    check(n_k1c >= N_STEPS and n_k2c >= N_STEPS, f"conditional fit launched the K1 chain form {n_k1c} and the K2 "
          f"chain form {n_k2c} times")
    print(f"conditional training path: fit {N_STEPS} Lion steps at B={b_fit}, epoch loss {float(res.losses[0]):.6f}, "
          f"{float(res.metrics['samples_per_s'][0]):.1f} samples/s (host clock), K1 chain form launches {n_k1c}, "
          f"K2 chain form launches {n_k2c}")
    b_ex = 512
    icnf_ek, icnf_ep = model(True, True), model(False, True)
    n7 = fs.run_chain_exact_solve_kernel.launches
    l_k, g_k, _ = loss_grad(cnf, icnf_ek, ps_np, xs[:b_ex], dev, ys=ys[:b_ex], steer_r=steer_r)
    check(fs.run_chain_exact_solve_kernel.launches == n7 + 1, "the exact conditional gradient did not run K7 exact once")
    l_p, g_p, _ = loss_grad(cnf, icnf_ep, ps_np, xs[:b_ex], dev, ys=ys[:b_ex], steer_r=steer_r)
    icnf_t = model(False, True, torch.float64, solver=cnf.SolverOptions(rtol=1e-7, atol=1e-9))
    l_t, g_t, _ = loss_grad(cnf, icnf_t, ps_np, xs[:b_ex], dev, torch.float64, ys=ys[:b_ex], steer_r=steer_r)
    torch.cuda.synchronize()
    hold_gradients(f"conditional exact B={b_ex}", l_k, g_k, l_p, g_p, l_t, g_t, names)
    with first_calls(fs, ("run_chain_exact_solve_kernel",)) as first_exact:
        res = fit_path(cnf, fs, icnf_ek, ps_np, dev, X, Y, b_fit)
    n_k7e = fs.run_chain_exact_solve_kernel.launches
    check(n_k7e >= N_STEPS, f"conditional exact fit launched K7 exact {n_k7e} times")
    print(f"conditional exact training path: fit {N_STEPS} Lion steps at B={b_fit}, epoch loss "
          f"{float(res.losses[0]):.6f}, K7 exact launches {n_k7e}")

    # The recipe's own training batch: the K1 and K2 chain forms and K7
    # exact on the inputs the fits' first steps gave them (their first B =
    # 128 rows of X and Y, probe, steered span and first step), held to the
    # twins as at B = 4096.
    first.update(first_exact)
    with torch.no_grad():
        kw = first["run_chain_train_solve_kernel"]
        f_k = fs.run_chain_train_solve_kernel(TSIT5, spec, **kw)
        f_p = fs.solve_train_plain(TSIT5, spec, **kw)
        hold_forward(f"K1 chain form with ys, fit batch B={b_fit}", f_k, f_p, (fs.solve_train_plain, spec, kw))
        kw = first["run_chain_adjoint_kernel"]
        a_k = fs.run_chain_adjoint_kernel(TSIT5, spec, **kw)
        a_p = fs.adjoint_train_plain(TSIT5, spec, **kw)
        a_64 = fs.adjoint_train_plain(TSIT5, spec, **{k: to64(v) for k, v in kw.items()})
        hold_adjoint(f"K2 chain form with ys, fit batch B={b_fit}", a_k, a_p, a_64, (fs.adjoint_train_plain, spec, kw))
        kw = first["run_chain_exact_solve_kernel"]
        x_k = fs.run_chain_exact_solve_kernel(TSIT5, spec, **kw)
        x_p = fs.solve_train_exact_plain(TSIT5, spec, **kw)
        hold_forward(f"K7 exact with ys, fit batch B={b_fit}", x_k, x_p, (fs.solve_train_exact_plain, spec, kw))

    # Phase 29: timings.
    gen = torch.Generator(device=dev).manual_seed(SEED + 13)
    ms_step = step_ms(cnf, icnf_k, ps_np, xs, gen, dev, 5, ys)
    ms_step_p = step_ms(cnf, icnf_p, ps_np, xs, gen, dev, 1, ys, warmup=False)
    ms_small = step_ms(cnf, icnf_k, ps_np, xs[:b_fit], gen, dev, 10, ys[:b_fit])
    ms_small_p = step_ms(cnf, icnf_p, ps_np, xs[:b_fit], gen, dev, 1, ys[:b_fit], warmup=False)
    with torch.no_grad():
        _, _, st = cnf.inference(icnf_k, cnf.Mode.TEST, xs, ps, ys=ys)
        ms_lp = cuda_ms(lambda: dist.logpdf(xs), 10)
        ms_lp_p = cuda_ms(lambda: cnf.inference(icnf_p, cnf.Mode.TEST, xs, ps, ys=ys), 1, warmup=False)
        ms_s = cuda_ms(lambda: one.sample(BATCH, generator=gen), 10)
        times = {}
        for name, kernel, plain, kw in (
            ("k1c", fs.run_chain_train_solve_kernel, fs.solve_train_plain, kw1),
            ("k2c", fs.run_chain_adjoint_kernel, fs.adjoint_train_plain, kw2),
            ("k7t", fs.run_chain_test_solve_kernel, fs.solve_test_plain, kwt),
            ("k7e", fs.run_chain_exact_solve_kernel, fs.solve_train_exact_plain, kwe),
        ):
            times[name] = (cuda_ms(lambda: kernel(TSIT5, spec, **kw), 5),
                           cuda_ms(lambda: plain(TSIT5, spec, **kw), 1, warmup=False))
    print(f"conditional train step B={BATCH} (loss, gradient, Lion): fused {ms_step:.4f} ms "
          f"({BATCH / ms_step * 1e3:.1f} samples/s), plain {ms_step_p:.4f} ms ({BATCH / ms_step_p * 1e3:.1f} samples/s)")
    print(f"conditional train step B={b_fit}: fused {ms_small:.4f} ms ({b_fit / ms_small * 1e3:.1f} samples/s), "
          f"plain {ms_small_p:.4f} ms ({b_fit / ms_small_p * 1e3:.1f} samples/s)")
    print(f"conditional logpdf B={BATCH}: kernel {ms_lp:.4f} ms ({BATCH / ms_lp * 1e3:.1f} evals/s), plain "
          f"{ms_lp_p:.4f} ms; steps {int(st.steps)}, NFE {int(st.nfe)}; sample n={BATCH}: {ms_s:.4f} ms "
          f"({BATCH / ms_s * 1e3:.1f} samples/s)")
    steps = {"k1c": out_k[2], "k2c": adj_k[5], "k7t": t_k[2], "k7e": e_k[2]}
    for name, label in (("k1c", "K1 chain form"), ("k2c", "K2 chain form"), ("k7t", "K7 TEST"), ("k7e", "K7 exact")):
        ms_k, ms_p = times[name]
        n = int(steps[name])
        print(f"{label} with ys alone: {ms_k:.4f} ms, plain version {ms_p:.4f} ms ({n} steps, "
              f"{ms_k * 1e3 / max(n, 1):.1f} us per attempted step)")
    fma = chain_fma(dims, nc)
    P = sum(a * b + b for a, b in zip(dims[:-1], dims[1:]))
    return [
        kernel_record(fs.K1C_KERNEL + "/cond", "k1_chain_solve.cu", "continuousnf_tpu/ops/fused_solve.py:1043", n_k1c,
                      abs1, *times["k1c"], fma["k1c"], BATCH, out_k[2], P + BATCH * (3 * dz + 6 + nc)),
        kernel_record(fs.K2C_KERNEL + "/cond", "k2_chain_adjoint.cu", "continuousnf_tpu/ops/fused_solve.py:1767",
                      n_k2c, abs2, *times["k2c"], fma["k2c"], BATCH, adj_k[5], 2 * P + BATCH * (5 * dz + 9 + 2 * nc)),
        kernel_record(fs.K7_KERNEL + "/test/cond", "k7_chain_solve.cu", "continuousnf_tpu/ops/fused_solve.py:1043",
                      n_k7t, abs_t, *times["k7t"], fma["k7t"], BATCH, t_k[2], P + BATCH * (2 * dz + 2 + nc)),
        kernel_record(fs.K7_KERNEL + "/exact/cond", "k7_chain_solve.cu", "continuousnf_tpu/ops/fused_solve.py:1043",
                      n_k7e, abs_e, *times["k7e"], fma["k7e"], BATCH, e_k[2], P + BATCH * (2 * dz + 6 + nc)),
    ]


# ---- K9: every embedded tableau, identity layers, the README workflow ----

README_DIMS = (2, 6, 2)  # examples/readme_example.py: MLP((n_in, 3 n_in, n_in)), n_in = nvars + naug = 2
README_N = 1024
README_BATCH = 32
# tableau name -> (rtol, atol) of phase 33: dop853 as experiments/tpu_parity_r5.py:130 runs it.
OTHER_TABLEAUS = {"dop853": (1e-6, 1e-8), "dopri5": (1e-3, 1e-6), "bosh3": (1e-3, 1e-6)}


def readme_model(cnf, dev, fused=True, dtype=None, solver=None):
    """The README model (examples/readme_example.py:42-54): RNODE, MLP
    2 -> 6 -> 2 tanh, nvars 1, naug 1, tspan (0, 13), steer_rate 0.1,
    lambda1 = lambda2 = lambda3 = 1e-2, calibrated aug noise, the README
    tolerances with method "auto", which picks verner65 there (the example
    names no method, so it runs tsit5 at them); `dtype` and `solver` replace
    float32 and those tolerances (the float64 reference solve)."""
    import torch

    dtype = dtype or torch.float32
    return cnf.construct(
        cnf.RNODE, cnf.MLP(README_DIMS, device=dev, dtype=dtype), 1, 1, tspan=(0.0, 13.0), steer_rate=0.1,
        lam1=1e-2, lam2=1e-2, lam3=1e-2, aug_noise="calibrated", compute_mode=cnf.VecJacMode(fused=fused),
        solver=solver or cnf.SolverOptions(method="auto", **cnf.README_TOLERANCES), dtype=dtype,
    )


def timed(fn):
    """(fn(), CUDA-event milliseconds of that one call)."""
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def kernel_inputs(icnf, ps, xs, rng, dev):
    """A model's kernel arguments at its solver and span, B = len(xs): TEST
    (z0 = [xs | 0], nonzero dlogp0), TRAIN from nonzero accumulators with a
    Gaussian probe, exact TRAIN, and an adjoint's loss-like cotangents and
    span (the forward's output is added by `adjoint_kw`)."""
    import torch

    B, opts = xs.shape[0], icnf.solver
    T = lambda a: torch.from_numpy(a.astype("float32")).to(dev)  # noqa: E731
    z0 = torch.cat([xs, torch.zeros((B, icnf.zdim - xs.shape[1]), device=dev)], dim=1)
    t0, t1 = (torch.tensor(t, device=dev) for t in icnf.tspan)
    base = dict(rtol=opts.rtol, atol=opts.atol, max_steps=opts.max_steps, ws=[p["w"] for p in ps],
                bs=[p["b"] for p in ps], t0=t0, t1=t1, dt_init=torch.tensor(0.05, device=dev))
    test = dict(base, z0=z0, dlogp0=T(rng.normal(0.0, 0.1, B)))
    exact = dict(base, norm_z=True, norm_j=True, z0=z0, acc0=T(rng.normal(0.0, 0.1, (3, B))))
    train = dict(exact, eps=T(rng.normal(size=(1, B, icnf.zdim))))
    cot = dict(azT=T(rng.normal(0.0, 1.0 / B, (B, icnf.zdim))),
               aaccT=T(np.stack([np.full(B, 1.0 / B), np.full(B, 1e-2 / B), np.full(B, 1e-2 / B)])), t_hi=t1, t_lo=t0)
    return test, train, exact, cot


def adjoint_kw(fwd_kw, out, cot):
    """An adjoint's arguments from its forward's: the forward's final state
    and last step (the warm start), and the cotangents `cot`."""
    import torch

    kw = {k: v for k, v in fwd_kw.items() if k not in ("z0", "acc0", "t0", "t1", "dt_init")}
    tdir = torch.sign(fwd_kw["t1"] - fwd_kw["t0"])
    return dict(kw, **cot, zT=out[0], accT=out[1], dt_init=-tdir * out[4].abs())


def run_pair(label, kernel, twin, tab, spec, kw, adjoint=False, gate=0, reps=5, grad_tol=GRAD_TOL):
    """`kernel` and its twin on `kw` under `tab`, held to each other
    (`hold_forward` / `hold_adjoint` with `grad_tol`, the last-step and
    near-tie rules allowed; `gate`: `roundoff_gate`), then the kernel timed.  Returns
    (out_k, largest absolute difference, kernel ms, the twin's ms: the
    checked call, unwarmed)."""
    import torch
    from continuousnf_tpu_torch.utils.configs import cuda_ms

    with torch.no_grad():
        out_k = kernel(tab, spec, **kw)
        out_p, plain_ms = timed(lambda: twin(tab, spec, **kw))
        out_64 = twin(tab, spec, **{k: to64(v) for k, v in kw.items()}) if adjoint else None
    near = (twin, spec, kw, tab)
    err = (hold_adjoint(label, out_k, out_p, out_64, near, gate, grad_tol) if adjoint
           else hold_forward(label, out_k, out_p, near, gate))
    with torch.no_grad():
        ms = cuda_ms(lambda: kernel(tab, spec, **kw), reps, warmup=False)
    n = int(out_k[5] if adjoint else out_k[2])
    print(f"{label} alone: {ms:.4f} ms, plain version {plain_ms:.4f} ms ({n} steps, "
          f"{ms * 1e3 / max(n, 1):.1f} us per attempted step)")
    return out_k, err, ms, plain_ms


def steps_of(out):
    """(attempted, accepted) of a forward's or an adjoint's output."""
    from continuousnf_tpu_torch.utils import near_tie

    return (out[2], out[3]) if near_tie.is_forward(out) else (out[5], out[6])


def launched(fs):
    """The kernels launched since the counters were last reset, by name."""
    return {k: w.launches for k, w in fs.KERNEL_WRAPPERS.items() if w.launches}


def readme_workflow(cnf, fs, dev):
    """Phase 30: the README workflow through the kernels under verner65.
    Returns the launch counts of its main paths: K1 and K2 in `fit`, K3 in
    `pdf` and `sample`."""
    import pathlib

    import torch
    from continuousnf_tpu_torch.ode.tableaus import VERNER65
    from continuousnf_tpu_torch.utils.configs import glorot_params

    icnf_k, icnf_p = readme_model(cnf, dev), readme_model(cnf, dev, fused=False)
    tab = fs.get_tableau(icnf_k.solver.method, icnf_k.solver.rtol)
    check(tab is VERNER65, f"the README tolerances with method auto picked {tab.name}, expected verner65")
    X_np = np.random.default_rng(SEED).beta(2.0, 4.0, (README_N, 1)).astype("float32")
    X = torch.from_numpy(X_np).to(dev)
    ps_np = glorot_params(np.random.default_rng(SEED + 30), README_DIMS)
    lion_steps = []

    def lion(params):
        opt = cnf.Lion(params, lr=3e-4, weight_decay=0.0)
        opt.register_step_post_hook(lambda *_: lion_steps.append(1))
        return opt

    model = cnf.ICNFModel(icnf_k, optimizers=(lion,), n_epochs=1, batch_size=README_BATCH)
    with first_calls(fs, ("run_train_solve_kernel", "run_adjoint_kernel")) as seen:
        fs.reset_launches()
        res = cnf.fit(model, X, ps=cnf.params_from_numpy(ps_np, dev), seed=SEED)
        torch.cuda.synchronize()
        counts = launched(fs)
    n_steps = README_N // README_BATCH
    n_k1, n_k2 = counts.get(fs.K1_KERNEL, 0), counts.get(fs.K2_KERNEL, 0)
    check(len(lion_steps) == n_steps, f"README fit took {len(lion_steps)} Lion steps, expected {n_steps}")
    check(n_k1 >= n_steps and n_k2 >= n_steps and set(counts) == {fs.K1_KERNEL, fs.K2_KERNEL},
          f"README fit launched {counts}")
    check(seen["tableaus"] == {"verner65"}, f"README fit ran the tableaus {seen['tableaus']}")
    check(bool(np.isfinite(res.losses).all()), f"README fit losses {res.losses}")
    print(f"README fit: {n_steps} Lion steps at batch {README_BATCH} (lr 3e-4, no weight decay) under verner65, "
          f"epoch loss {float(res.losses[0]):.6f}, mean forward NFE {float(res.metrics['nfe'][0]):.1f}, "
          f"{float(res.metrics['samples_per_s'][0]):.1f} samples/s (host clock); K1 launches {n_k1}, K2 {n_k2}")

    path = pathlib.Path(__file__).resolve().parent / "build" / "readme_fitted.pt"
    path.parent.mkdir(parents=True, exist_ok=True)
    cnf.save_checkpoint(str(path), res.ps)
    ps = cnf.load_checkpoint(str(path), tuple({k: torch.zeros_like(v) for k, v in p.items()} for p in res.ps))
    check(all(torch.equal(a[k], b[k]) for a, b in zip(ps, res.ps) for k in ("w", "b")),
          "the checkpoint did not round-trip bitwise")
    print(f"README checkpoint: {path.name} round-trips bitwise")

    dist = cnf.ICNFDist(icnf_k, cnf.Mode.TEST, ps)
    fs.reset_launches()
    with torch.no_grad():
        pdf = dist.pdf(X)
        n_pdf = fs.run_solve_kernel.launches
        samples = dist.sample(README_N, generator=torch.Generator(device=dev).manual_seed(SEED + 31))
    torch.cuda.synchronize()
    counts = launched(fs)
    n_k3 = counts.get(fs.K3_KERNEL, 0)
    check(n_pdf >= 1 and n_k3 > n_pdf and set(counts) == {fs.K3_KERNEL}, f"README pdf and sample launched {counts}")
    check(tuple(samples.shape) == (README_N, 1) and bool(torch.isfinite(samples).all()), "README samples not finite")
    with torch.no_grad():
        lp_k, _, st_k = cnf.inference(icnf_k, cnf.Mode.TEST, X, ps)
        lp_p, _, st_p = cnf.inference(icnf_p, cnf.Mode.TEST, X, ps)
    dlp = float((lp_k - lp_p).abs().max())
    check(int(st_k.steps) == int(st_p.steps), f"README pdf: steps {int(st_k.steps)} != {int(st_p.steps)}")
    check(dlp <= TOL * max(1.0, float(lp_p.abs().max())), f"README pdf: logp differs by {dlp}")
    check(bool(torch.allclose(pdf, torch.exp(lp_k), rtol=1e-6, atol=0.0)), "README pdf is not exp(logpdf)")
    est = pdf.double().cpu().numpy()
    x = X_np[:, 0].astype(np.float64)
    diff = est - 20.0 * x * (1.0 - x) ** 3  # the Beta(2, 4) density
    print(f"README pdf of {README_N} points: steps {int(st_k.steps)} (plain {int(st_p.steps)}), NFE {int(st_k.nfe)}, "
          f"max|dlogp| kernel vs plain {dlp:.3e}; K3 launches {n_k3} (pdf {n_pdf}); against 20 x (1 - x)^3 after one "
          f"epoch: mad {np.mean(np.abs(diff)):.4f} msd {np.mean(diff ** 2):.4f} tv {np.sum(np.abs(diff)) / 2 / README_N:.4f}"
          f"; samples mean {float(samples.mean()):.4f} (Beta(2, 4): {2 / 6:.4f})")
    return {"k3": n_k3, "k1": n_k1, "k2": n_k2}


def readme_tolerances_flagship(cnf, fs, dev, readme_launches):
    """Phase 31: the flagship at the README tolerances (verner65), B =
    4096.  Returns the verner65 records of the 2-layer kernels (the launches
    of K3, K1 and K2 from the README workflow's main paths, those of the K4
    pair from this phase's exact `fit`)."""
    import torch
    from continuousnf_tpu_torch.ode.tableaus import VERNER65
    from continuousnf_tpu_torch.utils.configs import glorot_params, make_icnf, model_data

    tab = VERNER65
    solver = cnf.SolverOptions(method="auto", **cnf.README_TOLERANCES)
    rng = np.random.default_rng(SEED + 40)
    dims = (16, 48, 16)
    ps_np = glorot_params(rng, dims)
    xs = torch.from_numpy(model_data("flagship", rng, BATCH)).to(dev)
    ps = cnf.params_from_numpy(ps_np, dev)
    icnf_k, icnf_p = (make_icnf("flagship", dev, fused=f, solver=solver) for f in (True, False))
    spec = fs.chain_spec(icnf_k.nn, icnf_k.zdim)
    test, train, exact, cot = kernel_inputs(icnf_k, ps, xs, rng, dev)
    out3, e3, ms3, p3 = run_pair("K3 verner65", fs.run_solve_kernel, fs.solve_test_plain, tab, spec, test)
    out1, e1, ms1, p1 = run_pair("K1 verner65", fs.run_train_solve_kernel, fs.solve_train_plain, tab, spec, train)
    out2, e2, ms2, p2 = run_pair("K2 verner65", fs.run_adjoint_kernel, fs.adjoint_train_plain, tab, spec,
                                 adjoint_kw(train, out1, cot), adjoint=True)
    out4, e4, ms4, p4 = run_pair("K4 forward verner65", fs.run_exact_solve_kernel, fs.solve_train_exact_plain, tab,
                                 spec, exact)
    out4a, e4a, ms4a, p4a = run_pair("K4 adjoint verner65", fs.run_exact_adjoint_kernel, fs.adjoint_train_exact_plain,
                                     tab, spec, adjoint_kw(exact, out4, cot), adjoint=True, reps=2)

    # The Hutchinson and the exact loss and gradient through the kernels,
    # the plain path and a float64 rtol 1e-7 solve.
    gen = torch.Generator(device=dev).manual_seed(SEED + 41)
    kw = dict(eps=icnf_k.draw_eps(gen, BATCH, dev), steer_r=0.05)
    truth = cnf.SolverOptions(rtol=1e-7, atol=1e-9)
    for label, exact_trace in (("flagship verner65 Hutchinson", False), ("flagship verner65 exact", True)):
        extra = {"steer_r": 0.05} if exact_trace else kw
        fs.reset_launches()
        l_k, g_k, m_k = loss_grad(cnf, make_icnf("flagship", dev, exact=exact_trace, solver=solver), ps_np, xs, dev,
                                  **extra)
        want = {fs.K4_KERNEL, fs.K4A_KERNEL} if exact_trace else {fs.K1_KERNEL, fs.K2_KERNEL}
        check(set(launched(fs)) == want, f"{label}: the fused gradient launched {launched(fs)}")
        l_p, g_p, _ = loss_grad(cnf, make_icnf("flagship", dev, fused=False, exact=exact_trace, solver=solver), ps_np,
                                xs, dev, **extra)
        icnf_t = make_icnf("flagship", dev, fused=False, exact=exact_trace, dtype=torch.float64, solver=truth)
        extra_t = dict(extra, eps=extra["eps"].double()) if "eps" in extra else extra
        l_t, g_t, _ = loss_grad(cnf, icnf_t, ps_np, xs, dev, torch.float64, **extra_t)
        hold_gradients(label, l_k, g_k, l_p, g_p, l_t, g_t)
        print(f"{label}: loss fused {float(l_k):.6f} plain {float(l_p):.6f} float64 {float(l_t):.6f}, "
              f"forward NFE {int(m_k['nfe'])}")

    # The exact training path at the README tolerances (the K4 pair's main path).
    res = fit_path(cnf, fs, make_icnf("flagship", dev, exact=True, solver=solver), ps_np, dev,
                   model_data("flagship", rng, N_STEPS * BATCH))
    n4, n4a = fs.run_exact_solve_kernel.launches, fs.run_exact_adjoint_kernel.launches
    check(n4 == N_STEPS and n4a == N_STEPS, f"the verner65 exact fit launched the K4 forward {n4} and adjoint {n4a}")
    print(f"flagship verner65 exact training path: fit {N_STEPS} Lion steps at B={BATCH}, epoch loss "
          f"{float(res.losses[0]):.6f}, K4 forward launches {n4}, K4 adjoint launches {n4a}")
    dz, H = icnf_k.zdim, dims[1]
    fma, P = two_layer_fma(dz, H), 2 * dz * H + H + dz
    rec = lambda name, src, at, n, err, ms, pms, f, out, floats: kernel_record(  # noqa: E731
        f"{name}/verner65", src, f"continuousnf_tpu/ops/fused_solve.py:{at}", n, err, ms, pms, f, BATCH,
        steps_of(out)[0], floats, tab, steps_of(out)[1])
    return [
        rec(fs.K3_KERNEL, "k3_test_solve.cu", 1043, readme_launches["k3"], e3, ms3, p3, fma["k3"], out3,
            2 * dz * H + H + dz + 2 * BATCH * (dz + 1)),
        rec(fs.K1_KERNEL, "k1_train_solve.cu", 1043, readme_launches["k1"], e1, ms1, p1, fma["k1"], out1,
            P + BATCH * (3 * dz + 6)),
        rec(fs.K2_KERNEL, "k2_train_adjoint.cu", 1767, readme_launches["k2"], e2, ms2, p2, fma["k2"], out2,
            2 * P + BATCH * (5 * dz + 9)),
        rec(fs.K4_KERNEL, "k4_exact_solve.cu", 1043, n4, e4, ms4, p4, fma["k4"], out4, P + BATCH * (2 * dz + 6)),
        rec(fs.K4A_KERNEL, "k4_exact_adjoint.cu", 1767, n4a, e4a, ms4a, p4a, fma["k4a"], out4a,
            2 * P + BATCH * (4 * dz + 9)),
    ]


def chain_names(fs, wide=False, stream=False):
    """The chain kernels' record keys (k1c, k2c, k7t, k7e) -> (their
    KERNEL_WRAPPERS name, wrapper, source): the narrow forms or, `wide`,
    the wide forms or, `stream`, the streamed forms."""
    if stream:
        return {"k1c": (fs.K1S_KERNEL, fs.run_stream_train_solve_kernel, "k1_stream_solve.cu"),
                "k2c": (fs.K2S_KERNEL, fs.run_stream_adjoint_kernel, "k2_stream_adjoint.cu"),
                "k7t": (fs.K7S_KERNEL + "/test", fs.run_stream_test_solve_kernel, "k7_stream_solve.cu"),
                "k7e": (fs.K7S_KERNEL + "/exact", fs.run_stream_exact_solve_kernel, "k7_stream_solve.cu")}
    if wide:
        return {"k1c": (fs.K1W_KERNEL, fs.run_wide_train_solve_kernel, "k1_wide_solve.cu"),
                "k2c": (fs.K2W_KERNEL, fs.run_wide_adjoint_kernel, "k2_wide_adjoint.cu"),
                "k7t": (fs.K7W_KERNEL + "/test", fs.run_wide_test_solve_kernel, "k7_wide_solve.cu"),
                "k7e": (fs.K7W_KERNEL + "/exact", fs.run_wide_exact_solve_kernel, "k7_wide_solve.cu")}
    return {"k1c": (fs.K1C_KERNEL, fs.run_chain_train_solve_kernel, "k1_chain_solve.cu"),
            "k2c": (fs.K2C_KERNEL, fs.run_chain_adjoint_kernel, "k2_chain_adjoint.cu"),
            "k7t": (fs.K7_KERNEL + "/test", fs.run_chain_test_solve_kernel, "k7_chain_solve.cu"),
            "k7e": (fs.K7_KERNEL + "/exact", fs.run_chain_exact_solve_kernel, "k7_chain_solve.cu")}


def chain_records(fs, suffix, dims, runs, launches, tab=None, B=BATCH, wide=False, stream=False):
    """The chain kernels' records (their wide forms' when `wide`, their
    streamed forms' when `stream`) at batch B: `runs` maps k1c, k2c, k7t,
    k7e to (out_k, err, ms, plain_ms), `launches` to their main-path counts;
    `suffix` (None: none) ends each name."""
    fma = chain_fma(dims)
    dz = dims[-1]
    P = sum(a * b + b for a, b in zip(dims[:-1], dims[1:]))
    floats = {"k1c": P + B * (3 * dz + 6), "k2c": 2 * P + B * (5 * dz + 9), "k7t": P + B * (2 * dz + 2),
              "k7e": P + B * (2 * dz + 6)}
    at = {"k1c": 1043, "k2c": 1767, "k7t": 1043, "k7e": 1043}
    names = chain_names(fs, wide, stream)
    records = []
    for key, (out, err, ms, pms) in runs.items():
        name, _, src = names[key]
        records.append(kernel_record(name if suffix is None else f"{name}/{suffix}", src,
                                     f"continuousnf_tpu/ops/fused_solve.py:{at[key]}", launches[key], err, ms, pms,
                                     fma[key], B, steps_of(out)[0], floats[key], tab, steps_of(out)[1]))
    return records


def chain_runs(fs, tab, spec, test, train, exact, cot, label, gate=0, wide=False, stream=False, reps=5):
    """The four chain kernels (their wide forms when `wide`, their streamed
    forms when `stream`) against their twins on one model's inputs, each
    timed over `reps` calls."""
    run = {key: wrapper for key, (_, wrapper, _) in chain_names(fs, wide, stream).items()}
    form = "streamed " if stream else "wide " if wide else ""
    runs = {"k7t": run_pair(f"{form}K7 TEST {label}", run["k7t"], fs.solve_test_plain, tab, spec, test, gate=gate,
                            reps=reps),
            "k7e": run_pair(f"{form}K7 exact {label}", run["k7e"], fs.solve_train_exact_plain, tab, spec, exact,
                            gate=gate, reps=reps),
            "k1c": run_pair(f"{form}K1 chain form {label}", run["k1c"], fs.solve_train_plain, tab, spec, train,
                            gate=gate, reps=reps)}
    runs["k2c"] = run_pair(f"{form}K2 chain form {label}", run["k2c"], fs.adjoint_train_plain, tab, spec,
                           adjoint_kw(train, runs["k1c"][0], cot), adjoint=True, gate=gate, reps=reps)
    return runs


def chain_main_path(cnf, fs, icnf, icnf_exact, ps_np, xs, dev, X, wide=False):
    """The chain kernels' main paths (their wide forms' when `wide`):
    serving (logpdf, sample) through K7 TEST, `fit` at batch len(xs) through
    the K1 and K2 chain forms and the exact `fit` through K7 exact, each with
    the counters reset just before it and launching those kernels and no
    other.  Returns the launch counts."""
    import torch

    names = {key: name for key, (name, _, _) in chain_names(fs, wide).items()}
    ps = cnf.params_from_numpy(ps_np, dev)
    dist = cnf.ICNFDist(icnf, cnf.Mode.TEST, ps)
    fs.reset_launches()
    with torch.no_grad():
        lp = dist.logpdf(xs)
        samples = dist.sample(xs.shape[0], generator=torch.Generator(device=dev).manual_seed(SEED + 50))
    torch.cuda.synchronize()
    n7t = launched(fs)
    check(set(n7t) == {names["k7t"]}, f"serving launched {n7t}")
    check(bool(torch.isfinite(lp).all() and torch.isfinite(samples).all()), "serving output not finite")
    fit_path(cnf, fs, icnf, ps_np, dev, X, batch_size=xs.shape[0])
    n12 = launched(fs)
    check(set(n12) == {names["k1c"], names["k2c"]} and min(n12.values()) >= N_STEPS, f"fit launched {n12}")
    fit_path(cnf, fs, icnf_exact, ps_np, dev, X, batch_size=xs.shape[0])
    n7e = launched(fs)
    check(set(n7e) == {names["k7e"]} and min(n7e.values()) >= N_STEPS, f"exact fit launched {n7e}")
    print(f"main paths: logpdf and sample launched {n7t}, fit {n12}, exact fit {n7e}")
    return {"k7t": n7t[names["k7t"]], "k1c": n12[names["k1c"]], "k2c": n12[names["k2c"]], "k7e": n7e[names["k7e"]]}


def readme_tolerances_power6(cnf, fs, dev):
    """Phase 32: power6 at the README tolerances (verner65), B = 4096: the
    chain kernels against their twins, their main paths, and timings.
    Returns their records."""
    import torch
    from continuousnf_tpu_torch.ode.tableaus import VERNER65
    from continuousnf_tpu_torch.utils.configs import MODELS, glorot_params, make_icnf, model_data

    solver = cnf.SolverOptions(method="auto", **cnf.README_TOLERANCES)
    rng = np.random.default_rng(SEED + 60)
    dims = MODELS["power6"]["dims"]
    ps_np = glorot_params(rng, dims)
    xs = torch.from_numpy(model_data("power6", rng, BATCH)).to(dev)
    icnf_k = make_icnf("power6", dev, solver=solver)
    spec = fs.chain_spec(icnf_k.nn, icnf_k.zdim)
    inputs = kernel_inputs(icnf_k, cnf.params_from_numpy(ps_np, dev), xs, rng, dev)
    runs = chain_runs(fs, VERNER65, spec, *inputs, "verner65")
    launches = chain_main_path(cnf, fs, icnf_k, make_icnf("power6", dev, exact=True, solver=solver), ps_np, xs, dev,
                               model_data("power6", rng, N_STEPS * BATCH))
    return chain_records(fs, "verner65", dims, runs, launches, VERNER65)


def other_tableaus(cnf, fs, dev):
    """Phase 33: dop853, dopri5 and bosh3: K3, K1 and K2 on the flagship
    and the four chain kernels on power6 against their twins, each
    family's main path (`logpdf` and one loss gradient through the
    entry points) with the counters reset just before it, and timings.
    Returns their records."""
    import torch
    from continuousnf_tpu_torch.ode.tableaus import TABLEAUS
    from continuousnf_tpu_torch.utils.configs import MODELS, glorot_params, make_icnf, model_data

    records = []
    for name, (rtol, atol) in OTHER_TABLEAUS.items():
        tab = TABLEAUS[name]
        solver = cnf.SolverOptions(method=name, rtol=rtol, atol=atol)
        gate = 2 if name == "dop853" else 0
        for model in ("flagship", "power6"):
            rng = np.random.default_rng(SEED + 70)
            dims = MODELS[model]["dims"]
            ps_np = glorot_params(rng, dims)
            xs = torch.from_numpy(model_data(model, rng, BATCH)).to(dev)
            icnf_k = make_icnf(model, dev, solver=solver)
            spec = fs.chain_spec(icnf_k.nn, icnf_k.zdim)
            test, train, exact, cot = kernel_inputs(icnf_k, cnf.params_from_numpy(ps_np, dev), xs, rng, dev)
            label = f"{model} {name}"
            if model == "flagship":
                runs = {"k3": run_pair(f"K3 {label}", fs.run_solve_kernel, fs.solve_test_plain, tab, spec, test,
                                       gate=gate),
                        "k1": run_pair(f"K1 {label}", fs.run_train_solve_kernel, fs.solve_train_plain, tab, spec,
                                       train, gate=gate)}
                runs["k2"] = run_pair(f"K2 {label}", fs.run_adjoint_kernel, fs.adjoint_train_plain, tab, spec,
                                      adjoint_kw(train, runs["k1"][0], cot), adjoint=True, gate=gate)
            else:
                runs = chain_runs(fs, tab, spec, test, train, exact, cot, label, gate)
            # The main path: logpdf and one loss gradient (and, on power6, the
            # exact one) through the entry points.
            fs.reset_launches()
            with torch.no_grad():
                lp = cnf.ICNFDist(icnf_k, cnf.Mode.TEST, cnf.params_from_numpy(ps_np, dev)).logpdf(xs)
            gen = torch.Generator(device=dev).manual_seed(SEED + 71)
            l_k, g_k, _ = loss_grad(cnf, icnf_k, ps_np, xs, dev, generator=gen)
            if model == "power6":
                loss_grad(cnf, make_icnf(model, dev, exact=True, solver=solver), ps_np, xs, dev)
            torch.cuda.synchronize()
            counts = launched(fs)
            check(bool(torch.isfinite(lp).all()) and bool(torch.isfinite(l_k)) and
                  all(bool(torch.isfinite(g).all()) for g in g_k), f"{label} main path not finite")
            print(f"{label} main path (logpdf, loss gradient): launched {counts}")
            if model == "flagship":
                want = {"k3": fs.K3_KERNEL, "k1": fs.K1_KERNEL, "k2": fs.K2_KERNEL}
                check(set(counts) == set(want.values()), f"{label} main path launched {counts}")
                dz, H = icnf_k.zdim, dims[1]
                fma, P = two_layer_fma(dz, H), 2 * dz * H + H + dz
                floats = {"k3": 2 * dz * H + H + dz + 2 * BATCH * (dz + 1), "k1": P + BATCH * (3 * dz + 6),
                          "k2": 2 * P + BATCH * (5 * dz + 9)}
                src = {"k3": ("k3_test_solve.cu", 1043), "k1": ("k1_train_solve.cu", 1043),
                       "k2": ("k2_train_adjoint.cu", 1767)}
                for key, (out, err, ms, pms) in runs.items():
                    records.append(kernel_record(
                        f"{want[key]}/{name}", src[key][0], f"continuousnf_tpu/ops/fused_solve.py:{src[key][1]}",
                        counts[want[key]], err, ms, pms, fma[key], BATCH, steps_of(out)[0], floats[key], tab,
                        steps_of(out)[1]))
            else:
                keys = {"k7t": fs.K7_KERNEL + "/test", "k7e": fs.K7_KERNEL + "/exact", "k1c": fs.K1C_KERNEL,
                        "k2c": fs.K2C_KERNEL}
                check(set(counts) == set(keys.values()), f"{label} main path launched {counts}")
                records += chain_records(fs, name, dims, runs, {k: counts[v] for k, v in keys.items()}, tab)
    return records


def identity_layers(cnf, fs, dev):
    """Phase 34: the flagship's and power6's nets with an identity output
    layer (tsit5 at rtol 1e-3): the fused path launches the chain kernels
    and no 2-layer kernel (logpdf, a Hutchinson and an exact loss
    gradient, counters reset just before), and the four chain kernels
    against their twins.  Returns power6's records."""
    import torch
    from continuousnf_tpu_torch.utils.configs import MODELS, glorot_params, model_data

    records = []
    chain = {fs.K7_KERNEL + "/test", fs.K7_KERNEL + "/exact", fs.K1C_KERNEL, fs.K2C_KERNEL}
    for model in ("flagship", "power6"):
        cfg = MODELS[model]
        rng = np.random.default_rng(SEED + 80)
        dims = cfg["dims"]
        ps_np = glorot_params(rng, dims)
        xs = torch.from_numpy(model_data(model, rng, BATCH)).to(dev)

        def icnf(exact=False, fused=True, dtype=torch.float32):
            return cnf.construct(cnf.RNODE, cnf.MLP(dims, final_activation=None, device=dev, dtype=dtype),
                                 cfg["nvars"], cfg["naug"], tspan=cfg["tspan"], dtype=dtype,
                                 compute_mode=cnf.VecJacMode(fused=fused, exact_trace=exact))

        icnf_k = icnf()
        spec = fs.chain_spec(icnf_k.nn, icnf_k.zdim)
        check(not spec.acts[-1] and fs._kernel_covers(fs.get_tableau("tsit5", 1e-3), spec) is not None,
              f"{model} identity: the 2-layer kernels should refuse the net")
        fs.reset_launches()
        with torch.no_grad():
            lp_k = cnf.ICNFDist(icnf_k, cnf.Mode.TEST, cnf.params_from_numpy(ps_np, dev)).logpdf(xs)
        gen = torch.Generator(device=dev).manual_seed(SEED + 81)
        loss_grad(cnf, icnf_k, ps_np, xs, dev, generator=gen)
        loss_grad(cnf, icnf(exact=True), ps_np, xs, dev)
        torch.cuda.synchronize()
        counts = launched(fs)
        check(set(counts) == chain, f"{model} identity: the fused path launched {counts}")
        # A linear output layer lets the flagship's flow expand over its span
        # (|logp| ~ 1e3): logp through the kernel is held to the plain path
        # within 1e-4 relative, or within 4x the plain path's own distance
        # from a float64 solve.
        ps64 = tuple({k: v.double() for k, v in p.items()} for p in cnf.params_from_numpy(ps_np, dev))
        with torch.no_grad():
            lp_p = cnf.ICNFDist(icnf(fused=False), cnf.Mode.TEST, cnf.params_from_numpy(ps_np, dev)).logpdf(xs)
            lp_64 = cnf.ICNFDist(icnf(fused=False, dtype=torch.float64), cnf.Mode.TEST, ps64).logpdf(xs.double())
        dlp, d64 = float((lp_k - lp_p).abs().max()), float((lp_p.double() - lp_64).abs().max())
        scale = max(1.0, float(lp_p.abs().max()))
        check(dlp <= max(TOL * scale, 4.0 * d64), f"{model} identity logpdf differs by {dlp} (plain vs float64 {d64})")
        print(f"{model} identity output layer: the fused path launched {counts}; logpdf kernel vs plain {dlp:.3e} "
              f"(max|logp| {scale:.4e}; plain vs float64 {d64:.3e}, kernel vs float64 "
              f"{float((lp_k.double() - lp_64).abs().max()):.3e})")
        inputs = kernel_inputs(icnf_k, cnf.params_from_numpy(ps_np, dev), xs, rng, dev)
        runs = chain_runs(fs, fs.get_tableau("tsit5", 1e-3), spec, *inputs, f"{model} identity")
        if model == "power6":
            records += chain_records(fs, "identity", dims, runs,
                                     {"k7t": counts[fs.K7_KERNEL + "/test"], "k7e": counts[fs.K7_KERNEL + "/exact"],
                                      "k1c": counts[fs.K1C_KERNEL], "k2c": counts[fs.K2C_KERNEL]})
    return records


def deep_test_gradient(cnf, fs, dev):
    """Phase 35: power6's TEST-mode loss gradient through K7 TEST and the
    plain BACKSOLVE backward (the JAX package has no TEST backward kernel
    for deeper chains), within SOLVE_REL * max|g| of a float64 rtol 1e-7
    solve."""
    import torch
    from continuousnf_tpu_torch.utils.configs import MODELS, glorot_params, make_icnf, model_data

    rng = np.random.default_rng(SEED + 90)
    ps_np = glorot_params(rng, MODELS["power6"]["dims"])
    xs = torch.from_numpy(model_data("power6", rng, BATCH)).to(dev)

    def test_grad(icnf, dtype):
        p = cnf.params_from_numpy(ps_np, dev)
        leaves = [x.to(dtype).requires_grad_() for layer in p for x in (layer["w"], layer["b"])]
        p = tuple({"w": w, "b": b} for w, b in zip(leaves[::2], leaves[1::2]))
        l = cnf.loss(icnf, cnf.Mode.TEST, xs.to(dtype), p)
        return l.detach(), torch.autograd.grad(l, leaves)

    fs.reset_launches()
    l_k, g_k = test_grad(make_icnf("power6", dev), torch.float32)
    torch.cuda.synchronize()
    counts = launched(fs)
    check(counts == {fs.K7_KERNEL + "/test": 1}, f"the power6 TEST gradient launched {counts}")
    l_t, g_t = test_grad(make_icnf("power6", dev, fused=False, dtype=torch.float64,
                                   solver=cnf.SolverOptions(rtol=1e-7, atol=1e-9)), torch.float64)
    check(abs(float(l_k) - float(l_t)) <= TOL * max(1.0, abs(float(l_t))), f"TEST loss {float(l_k)} vs {float(l_t)}")
    for i, (a, t) in enumerate(zip(g_k, g_t)):
        d, scale = float((a.double() - t).abs().max()), float(t.abs().max())
        check(d <= SOLVE_REL * scale, f"power6 TEST gradient {i}: {d} from the float64 solve, max|g| {scale}")
        print(f"power6 TEST gradient {i}: max|g| {scale:.4e}, distance to the float64 rtol 1e-7 solve {d:.4e}")
    print(f"power6 TEST loss fused {float(l_k):.6f} float64 {float(l_t):.6f}; K7 TEST launches {counts}")


def miniboone(cnf, fs, dev):
    """Phases 36 to 41: the tabular MINIBOONE model (benchmarks/tabular.py:58:
    RNODE, MLP 43 -> 128 -> 128 -> 43 tanh, tspan (0, 1), batch 2048) through
    the chain kernels' wide forms.  Returns their records."""
    import torch
    from continuousnf_tpu_torch.utils.configs import MODELS, cuda_ms, glorot_params, make_icnf, model_data

    cfg = MODELS["miniboone43"]
    dims, B = cfg["dims"], cfg["batch"]
    rng = np.random.default_rng(SEED + 100)
    ps_np = glorot_params(rng, dims)
    xs = torch.from_numpy(model_data("miniboone43", rng, B)).to(dev)
    ps = cnf.params_from_numpy(ps_np, dev)
    model = lambda **kw: make_icnf("miniboone43", dev, **kw)  # noqa: E731
    icnf_k, icnf_p = model(), model(fused=False)
    spec = fs.chain_spec(icnf_k.nn, icnf_k.zdim)
    check(fs._wide_chain(spec) and fs._kernel_covers(fs.TSIT5, spec, chain=True) is None,
          "the MINIBOONE chain should run the wide forms")

    # Phase 36: the wide kernels' launch shapes at B = 2048.
    arr = (ctypes.c_int * len(dims))(*dims)
    for lib_name, fn in ((fs.K1W_KERNEL, "cnf_k1w_shape"), (fs.K2W_KERNEL, "cnf_k2w_shape"),
                         (fs.K7W_KERNEL, "cnf_k7w_test_shape"), (fs.K7W_KERNEL, "cnf_k7w_exact_shape")):
        out = (ctypes.c_int * 4)()
        err = getattr(fs._library(lib_name), fn)(len(dims) - 1, arr, B, out)
        check(err == 0 and out[1] >= 1, f"{fn}: cudaError {err}")
        print(f"{fn} at widths {dims}, B={B}: {out[0]} threads a block, {out[1]} blocks, tile {out[2]}, "
              f"{out[3]} bytes of dynamic shared memory")

    # Phases 37 and 38: the four wide kernels against their twins (the
    # bounds of phases 16 and 17), with their timings.
    test, train, exact, cot = kernel_inputs(icnf_k, ps, xs, rng, dev)
    runs = chain_runs(fs, fs.TSIT5, spec, test, train, exact, cot, "miniboone", wide=True)

    # Phase 39: logpdf through the kernel against the plain path.
    hold_logpdf(cnf, "miniboone", icnf_k, icnf_p, xs, ps)

    # Phase 40: the Hutchinson and exact loss and gradient through the
    # kernels, the plain path and a float64 rtol 1e-7 solve.
    truth = cnf.SolverOptions(rtol=1e-7, atol=1e-9)
    gen = torch.Generator(device=dev).manual_seed(SEED + 101)
    eps = icnf_k.draw_eps(gen, B, dev)
    for label, exact_trace in (("miniboone Hutchinson", False), ("miniboone exact", True)):
        extra = {} if exact_trace else {"eps": eps}
        fs.reset_launches()
        l_k, g_k, m_k = loss_grad(cnf, model(exact=exact_trace), ps_np, xs, dev, **extra)
        want = {fs.K7W_KERNEL + "/exact"} if exact_trace else {fs.K1W_KERNEL, fs.K2W_KERNEL}
        check(set(launched(fs)) == want, f"{label}: the fused gradient launched {launched(fs)}")
        l_p, g_p, _ = loss_grad(cnf, model(fused=False, exact=exact_trace), ps_np, xs, dev, **extra)
        extra_t = {} if exact_trace else {"eps": eps.double()}
        l_t, g_t, _ = loss_grad(cnf, model(fused=False, exact=exact_trace, dtype=torch.float64, solver=truth), ps_np,
                                xs, dev, torch.float64, **extra_t)
        torch.cuda.synchronize()
        hold_gradients(label, l_k, g_k, l_p, g_p, l_t, g_t)
        print(f"{label} B={B}: loss fused {float(l_k):.6f} plain {float(l_p):.6f} float64 {float(l_t):.6f}, "
              f"forward NFE {int(m_k['nfe'])}")

    # Phase 41: the main paths (serving, fit, exact fit at batch 2048), each
    # with the counters reset just before it.
    icnf_e = model(exact=True)
    launches = chain_main_path(cnf, fs, icnf_k, icnf_e, ps_np, xs, dev, model_data("miniboone43", rng, N_STEPS * B),
                               wide=True)

    # Timings of the paths.
    gen = torch.Generator(device=dev).manual_seed(SEED + 102)
    ms_step = step_ms(cnf, icnf_k, ps_np, xs, gen, dev, 3)
    ms_step_p = step_ms(cnf, icnf_p, ps_np, xs, gen, dev, 1, warmup=False)
    ms_estep = step_ms(cnf, icnf_e, ps_np, xs, gen, dev, 2)
    dist = cnf.ICNFDist(icnf_k, cnf.Mode.TEST, ps)
    with torch.no_grad():
        _, _, st = cnf.inference(icnf_k, cnf.Mode.TEST, xs, ps)
        ms_lp = cuda_ms(lambda: dist.logpdf(xs), 3)
        ms_lp_p = cuda_ms(lambda: cnf.inference(icnf_p, cnf.Mode.TEST, xs, ps), 1, warmup=False)
    print(f"miniboone train step B={B} (loss, gradient, Lion): fused {ms_step:.4f} ms ({B / ms_step * 1e3:.1f} "
          f"samples/s), plain {ms_step_p:.4f} ms ({B / ms_step_p * 1e3:.1f} samples/s)")
    print(f"miniboone exact train step B={B}: fused forward, plain backward {ms_estep:.4f} ms "
          f"({B / ms_estep * 1e3:.1f} samples/s)")
    print(f"miniboone logpdf B={B}: kernel {ms_lp:.4f} ms ({B / ms_lp * 1e3:.1f} evals/s), plain {ms_lp_p:.4f} ms; "
          f"steps {int(st.steps)}, NFE {int(st.nfe)}")
    return chain_records(fs, None, dims, runs, launches, B=B, wide=True)


def miniboone860(cnf, fs, dev):
    """Phases 67 to 72: FFJORD's MINIBOONE model (miniboone860: RNODE, MLP
    43 -> 860 -> 860 -> 43 tanh, tspan (0, 1), batch 1024), whose weights
    pass a block's shared memory, through the chain kernels' streamed forms.
    Returns their records."""
    import torch
    from continuousnf_tpu_torch.utils.configs import MODELS, cuda_ms, glorot_params, make_icnf, model_data

    cfg = MODELS["miniboone860"]
    dims, B = cfg["dims"], cfg["batch"]
    rng = np.random.default_rng(SEED + 130)
    ps_np = glorot_params(rng, dims)
    xs = torch.from_numpy(model_data("miniboone860", rng, B)).to(dev)
    ps = cnf.params_from_numpy(ps_np, dev)
    model = lambda **kw: make_icnf("miniboone860", dev, **kw)  # noqa: E731
    icnf_k, icnf_p = model(), model(fused=False)
    spec = fs.chain_spec(icnf_k.nn, icnf_k.zdim)
    check(fs._stream_chain(spec) and fs._kernel_covers(fs.TSIT5, spec, chain=True) is None,
          "the miniboone860 chain should run the streamed forms")
    names = {key: name for key, (name, _, _) in chain_names(fs, stream=True).items()}

    # Phase 67: the streamed kernels' launch shapes at B = 1024.
    arr = (ctypes.c_int * len(dims))(*dims)
    for lib_name, fn in ((fs.K1S_KERNEL, "cnf_k1s_shape"), (fs.K2S_KERNEL, "cnf_k2s_shape"),
                         (fs.K7S_KERNEL, "cnf_k7s_test_shape"), (fs.K7S_KERNEL, "cnf_k7s_exact_shape")):
        out = (ctypes.c_int * 5)()
        err = getattr(fs._library(lib_name), fn)(len(dims) - 1, arr, B, out)
        check(err == 0 and out[1] >= 1, f"{fn}: cudaError {err}")
        print(f"{fn} at widths {dims}, B={B}: {out[0]} threads a block, {out[1]} blocks, tile {out[2]}, "
              f"{out[3]} bytes of dynamic shared memory, {out[4]} floats of global tile scratch a block")

    # Phase 68: the four streamed kernels against their twins (the bounds of
    # phases 16 and 17), with their timings.
    test, train, exact, cot = kernel_inputs(icnf_k, ps, xs, rng, dev)
    runs = chain_runs(fs, fs.TSIT5, spec, test, train, exact, cot, "miniboone860", stream=True, reps=2)

    # Phase 69: logpdf through the kernel against the plain path.
    hold_logpdf(cnf, "miniboone860", icnf_k, icnf_p, xs, ps)

    # Phase 70: the Hutchinson and exact loss and gradient through the
    # kernels, the plain path and a float64 rtol 1e-7 solve.
    truth = cnf.SolverOptions(rtol=1e-7, atol=1e-9)
    gen = torch.Generator(device=dev).manual_seed(SEED + 131)
    eps = icnf_k.draw_eps(gen, B, dev)
    for label, exact_trace in (("miniboone860 Hutchinson", False), ("miniboone860 exact", True)):
        extra = {} if exact_trace else {"eps": eps}
        fs.reset_launches()
        l_k, g_k, m_k = loss_grad(cnf, model(exact=exact_trace), ps_np, xs, dev, **extra)
        want = {names["k7e"]: 1} if exact_trace else {names["k1c"]: 1, names["k2c"]: 1}
        check(launched(fs) == want, f"{label}: the fused gradient launched {launched(fs)}")
        l_p, g_p, _ = loss_grad(cnf, model(fused=False, exact=exact_trace), ps_np, xs, dev, **extra)
        extra_t = {} if exact_trace else {"eps": eps.double()}
        l_t, g_t, _ = loss_grad(cnf, model(fused=False, exact=exact_trace, dtype=torch.float64, solver=truth), ps_np,
                                xs, dev, torch.float64, **extra_t)
        torch.cuda.synchronize()
        hold_gradients(label, l_k, g_k, l_p, g_p, l_t, g_t)
        print(f"{label} B={B}: loss fused {float(l_k):.6f} plain {float(l_p):.6f} float64 {float(l_t):.6f}, "
              f"forward NFE {int(m_k['nfe'])}")

    # Phase 71: the main paths, each with the counters reset just before it:
    # logpdf and sample(1024) through streamed K7 TEST, `fit` for four Lion
    # steps through the streamed K1 and K2 chain forms, one exact train step
    # through streamed K7 exact and the plain backward.
    dist = cnf.ICNFDist(icnf_k, cnf.Mode.TEST, ps)
    fs.reset_launches()
    with torch.no_grad():
        lp = dist.logpdf(xs)
        samples = dist.sample(B, generator=torch.Generator(device=dev).manual_seed(SEED + 132))
    torch.cuda.synchronize()
    n7t = launched(fs)
    check(n7t == {names["k7t"]: 2}, f"serving launched {n7t}")
    check(bool(torch.isfinite(lp).all() and torch.isfinite(samples).all()) and tuple(samples.shape) == (B, 43),
          "serving output not finite or of the wrong shape")
    fit_path(cnf, fs, icnf_k, ps_np, dev, model_data("miniboone860", rng, N_STEPS * B), batch_size=B)
    n12 = launched(fs)
    check(set(n12) == {names["k1c"], names["k2c"]} and min(n12.values()) >= N_STEPS, f"fit launched {n12}")
    icnf_e = model(exact=True)
    gen = torch.Generator(device=dev).manual_seed(SEED + 133)
    p = cnf.params_from_numpy(ps_np, dev)
    leaves = [x.requires_grad_() for layer in p for x in (layer["w"], layer["b"])]
    step = cnf.parallel.make_train_step_body(icnf_e, cnf.Lion(leaves, lr=1e-3))
    fs.reset_launches()
    l_e = step(p, xs, gen)
    torch.cuda.synchronize()
    n7e = launched(fs)
    check(n7e == {names["k7e"]: 1}, f"the exact train step launched {n7e}")
    check(all(bool(torch.isfinite(x).all()) for x in leaves) and bool(torch.isfinite(l_e["loss"])),
          "the exact train step's loss or params are not finite")
    print(f"main paths: logpdf and sample launched {n7t}, fit {n12}, the exact train step {n7e}")
    launches = {"k7t": n7t[names["k7t"]], "k1c": n12[names["k1c"]], "k2c": n12[names["k2c"]],
                "k7e": n7e[names["k7e"]]}

    # Phase 72: timings of the paths.
    gen = torch.Generator(device=dev).manual_seed(SEED + 134)
    ms_step = step_ms(cnf, icnf_k, ps_np, xs, gen, dev, 2)
    ms_step_p = step_ms(cnf, icnf_p, ps_np, xs, gen, dev, 1, warmup=False)
    with torch.no_grad():
        _, _, st = cnf.inference(icnf_k, cnf.Mode.TEST, xs, ps)
        ms_lp = cuda_ms(lambda: dist.logpdf(xs), 2)
        ms_lp_p = cuda_ms(lambda: cnf.inference(icnf_p, cnf.Mode.TEST, xs, ps), 1, warmup=False)
    print(f"miniboone860 train step B={B} (loss, gradient, Lion): fused {ms_step:.4f} ms ({B / ms_step * 1e3:.1f} "
          f"samples/s), plain {ms_step_p:.4f} ms ({B / ms_step_p * 1e3:.1f} samples/s)")
    print(f"miniboone860 logpdf B={B}: kernel {ms_lp:.4f} ms ({B / ms_lp * 1e3:.1f} evals/s), plain {ms_lp_p:.4f} ms; "
          f"steps {int(st.steps)}, NFE {int(st.nfe)}")
    return chain_records(fs, None, dims, runs, launches, B=B, stream=True)


PROBE_CONFIGS = ((2, False), (4, False), (8, False), (1, True), (2, True))  # (K, JVP?) of the K6 kernel holds
PROBE_PATHS = ((4, False), (1, True))  # held through the train step against a float64 solve
PROBE_CURVE = (1, 2, 4, 8)


def probe_tag(k, jvp) -> str:
    return f"jvp-K{k}" if jvp else f"K{k}"


def probe_fma(dims, k, n_cond=0, chain=False):
    """FMA per sample and field evaluation of the Hutchinson kernels with k
    probes, VJP or JVP alike (a pushforward costs a pullback), counted from
    the widths: the forward pass once, then per probe its pass (K1) and,
    in the adjoint, its VJP, then the forward chain's VJP and the outer
    products (one a probe, one for the forward chain).  2-layer: K1
    2 dz H (1 + k), K2 4 dz H (1 + k) + (k + 1) P; chains (S = sum in_i
    out_i, Sz its z rows): the K1 chain form S + k Sz, the K2 chain form
    2 S + (3 k + 1) Sz + n_cond H1 + sum out_i.  At k = 1 these are
    two_layer_fma's and chain_fma's.  The wide chain forms run the same
    products as the narrow ones (at 43 -> 128 -> 128 -> 43, S = 27,392: the
    wide K1 S (1 + k), the wide K2 2 S + (3 k + 1) S + 299); `chain`
    counts a 2-layer net by the chain forms' products, as the streamed chain
    forms run it."""
    if len(dims) == 3 and not chain:
        dz, H = dims[0], dims[1]
        P = 2 * dz * H + H + dz
        return {"k1": 2 * dz * H * (1 + k), "k2": 4 * dz * H * (1 + k) + (k + 1) * P}
    pairs = list(zip(dims[:-1], dims[1:]))
    S = sum(a * b for a, b in pairs)
    Sz = S - n_cond * dims[1]
    return {"k1c": S + k * Sz, "k2c": 2 * S + (3 * k + 1) * Sz + n_cond * dims[1] + sum(dims[1:])}


def probe_records(dims, k, jvp, held, launches, names, sources, keys, B, suffix=None, n_cond=0):
    """The records of a form's two probe instances (`probe_form`) at k
    probes: `held` their (out, err, ms, plain ms) from `run_pair`,
    `launches` their counts on the main path; `suffix` (None: none) ends
    each name; `n_cond` the conditioning inputs of a conditional chain."""
    P = sum(a * b + b for a, b in zip(dims[:-1], dims[1:]))
    dz = dims[-1]
    fma = probe_fma(dims, k, n_cond, chain=keys[0] == "k1c")
    extra = (k - 1) * B * dz
    records = []
    for i, (r, floats) in enumerate(((held[0], P + B * (3 * dz + 6 + n_cond) + extra),
                                     (held[1], 2 * P + B * (5 * dz + 9 + 2 * n_cond) + extra))):
        out, err, ms, pms = r
        records.append(kernel_record(f"{names[i]}/{probe_tag(k, jvp)}" + (f"/{suffix}" if suffix else ""), sources[i],
                                     f"continuousnf_tpu/ops/fused_solve.py:{1043 if i == 0 else 1767}",
                                     launches[i], err, ms, pms, fma[keys[i]], B, steps_of(out)[0], floats,
                                     accepted=steps_of(out)[1]))
    return records


def probe_form(fs, form):
    """The probe instances of a form ("two-layer", "chain", "wide" or
    "stream"): their wrappers, KERNEL_WRAPPERS names, sources, labels and
    probe_fma keys."""
    if form == "stream":
        return ((fs.run_stream_train_solve_kernel, fs.run_stream_adjoint_kernel), (fs.K1S_KERNEL, fs.K2S_KERNEL),
                ("k1_stream_solve.cu", "k2_stream_adjoint.cu"),
                ("the streamed K1 chain form", "the streamed K2 chain form"), ("k1c", "k2c"))
    if form == "wide":
        return ((fs.run_wide_train_solve_kernel, fs.run_wide_adjoint_kernel), (fs.K1W_KERNEL, fs.K2W_KERNEL),
                ("k1_wide_solve.cu", "k2_wide_adjoint.cu"), ("the wide K1 chain form", "the wide K2 chain form"),
                ("k1c", "k2c"))
    if form == "chain":
        return ((fs.run_chain_train_solve_kernel, fs.run_chain_adjoint_kernel), (fs.K1C_KERNEL, fs.K2C_KERNEL),
                ("k1_chain_solve.cu", "k2_chain_adjoint.cu"), ("the K1 chain form", "the K2 chain form"),
                ("k1c", "k2c"))
    return ((fs.run_train_solve_kernel, fs.run_adjoint_kernel), (fs.K1_KERNEL, fs.K2_KERNEL),
            ("k1_train_solve.cu", "k2_train_adjoint.cu"), ("K1", "K2"), ("k1", "k2"))


def probe_model(cnf, fs, dev, name, form, rng, B, fit, phases, truth_batch=None, reps=5, suffix=None):
    """K-probe and JVP Hutchinson training (K6) of one model through the
    probe instances of one form (`probe_form`) at batch B: `phases` numbers
    the kernel holds, the held train steps, the main paths, `fit` at K = 4
    (run when `fit`) and the probe curve (42-46; 57-60 at the wide forms,
    whose held train steps and main paths are both phase 58; 92-95 at the
    streamed forms).  The held train steps run at `truth_batch` samples
    when given (the float64 solve's batch), and each kernel is timed over
    `reps` calls; `suffix` (None: none) ends each record's name.  Returns
    the records."""
    import torch
    from continuousnf_tpu_torch.ode.tableaus import TSIT5
    from continuousnf_tpu_torch.utils.configs import MODELS, cuda_ms, glorot_params, make_icnf, model_data

    records = []
    truth = cnf.SolverOptions(rtol=1e-7, atol=1e-9)
    kmax = max(k for k, _ in PROBE_CONFIGS)
    curve = {}
    dims = MODELS[name]["dims"]
    ps_np = glorot_params(rng, dims)
    xs = torch.from_numpy(model_data(name, rng, B)).to(dev)
    ps = cnf.params_from_numpy(ps_np, dev)
    model = lambda k=1, jvp=False, **kw: make_icnf(name, dev, num_probes=k, ad="jvp" if jvp else "vjp", **kw)  # noqa: E731
    icnf = model()
    spec = fs.chain_spec(icnf.nn, icnf.zdim)
    steer = {"steer_r": 0.05} if icnf.steer_rate > 0 else {}  # the same steering draw on every path
    _, train, _, cot = kernel_inputs(icnf, ps, xs, rng, dev)
    eps_all = torch.from_numpy(rng.normal(size=(kmax, B, icnf.zdim)).astype("float32")).to(dev)
    (run1, run2), names, sources, label, keys = probe_form(fs, form)
    holds, paths, mains, fits, curves = phases

    # Phase 42 (holds): each probe instance against its twin (the forward
    # from nonzero accumulators, the adjoint from its output with its last
    # step as the warm start), timed.
    held = {}
    for k, jvp in PROBE_CONFIGS:
        tag = probe_tag(k, jvp)
        kw1 = dict(train, eps=eps_all[:k].contiguous(), jvp=jvp)
        r1 = run_pair(f"{label[0]} {tag} ({name})", run1, fs.solve_train_plain, TSIT5, spec, kw1, reps=reps)
        r2 = run_pair(f"{label[1]} {tag} ({name})", run2, fs.adjoint_train_plain, TSIT5, spec,
                      adjoint_kw(kw1, r1[0], cot), adjoint=True, reps=reps)
        held[(k, jvp)] = (r1, r2)
    print(f"phase {holds}: {name} probe instances held to their twins")

    # Phase 43 (paths): the train step's loss and gradient through the
    # kernels, the plain path and a float64 rtol 1e-7 solve, on the same
    # draws, the fused one launching the two probe instances once each and
    # no other kernel.
    bt = truth_batch or B
    for k, jvp in PROBE_PATHS:
        tag = probe_tag(k, jvp)
        icnf_k = model(k, jvp)
        gen = torch.Generator(device=dev).manual_seed(SEED + 210 + k)
        eps = icnf_k.draw_eps(gen, bt, dev)
        xt = xs[:bt]
        fs.reset_launches()
        l_k, g_k, m_k = loss_grad(cnf, icnf_k, ps_np, xt, dev, eps=eps, **steer)
        check(set(launched(fs)) == set(names) and {w.__name__: dict(w.probe_launches) for w in (run1, run2)}
              == {w.__name__: {(k, jvp): 1} for w in (run1, run2)},
              f"{name} {tag}: the fused gradient launched {launched(fs)}")
        l_p, g_p, _ = loss_grad(cnf, model(k, jvp, fused=False), ps_np, xt, dev, eps=eps, **steer)
        l_t, g_t, _ = loss_grad(cnf, model(k, jvp, fused=False, dtype=torch.float64, solver=truth), ps_np, xt,
                                dev, torch.float64, eps=eps.double(), **steer)
        torch.cuda.synchronize()
        hold_gradients(f"{name} {tag}", l_k, g_k, l_p, g_p, l_t, g_t)
        print(f"{name} {tag} train step B={bt}{' (the float64 solve at a cut batch)' if bt != B else ''}: "
              f"loss fused {float(l_k):.6f} plain {float(l_p):.6f} float64 {float(l_t):.6f}, forward NFE "
              f"{int(m_k['nfe'])}")

    # Phase 44 (mains): the main paths, counters reset just before each: the
    # loss and its gradient at each probe configuration launch the two probe
    # instances once each and no other kernel.
    launches = {}
    for k, jvp in PROBE_CONFIGS:
        icnf_k = model(k, jvp)
        eps = icnf_k.draw_eps(torch.Generator(device=dev).manual_seed(SEED + 220 + k), B, dev)
        fs.reset_launches()
        _, g, _ = loss_grad(cnf, icnf_k, ps_np, xs, dev, eps=eps, **steer)
        torch.cuda.synchronize()
        counts = [w.probe_launches.get((k, jvp), 0) for w in (run1, run2)]
        check(set(launched(fs)) == set(names) and counts == [1, 1]
              and all(bool(torch.isfinite(x).all()) for x in g),
              f"{name} {probe_tag(k, jvp)}: launched {launched(fs)}, probe instances {counts}")
        launches[(k, jvp)] = counts
    print(f"phase {mains}: {name} main paths (loss and gradient): probe-instance launches "
          + ", ".join(f"{probe_tag(k, jvp)} {c}" for (k, jvp), c in launches.items()))

    # Phase 45 (fits): fit for four Lion steps at K = 4.
    if fit:
        fit_path(cnf, fs, model(4), ps_np, dev, model_data(name, rng, N_STEPS * B), batch_size=B)
        n = [w.probe_launches.get((4, False), 0) for w in (run1, run2)]
        check(min(n) >= N_STEPS and set(launched(fs)) == set(names), f"fit at K = 4 launched {launched(fs)}")
        print(f"phase {fits}: fit at K = 4 ({name}): {N_STEPS} Lion steps at B={B}, probe-instance launches {n} "
              f"({label[0]}, {label[1]}), no other kernel")

    # Phase 46 (curves): the probe curve, microseconds per attempted step at
    # K = 1 (the one-probe instance), 2, 4 and 8, on the same inputs.
    with torch.no_grad():
        for k in PROBE_CURVE:
            kw1 = dict(train, eps=eps_all[:k].contiguous())
            out = run1(TSIT5, spec, **kw1)
            kw2 = adjoint_kw(kw1, out, cot)
            adj = run2(TSIT5, spec, **kw2)
            ms1, ms2 = cuda_ms(lambda: run1(TSIT5, spec, **kw1), reps), cuda_ms(lambda: run2(TSIT5, spec, **kw2), reps)
            curve[k] = (ms1 * 1e3 / int(out[2]), ms2 * 1e3 / int(adj[5]))
            print(f"probe curve {name} K={k}: {label[0]} {ms1:.4f} ms ({int(out[2])} steps, "
                  f"{curve[k][0]:.1f} us per attempted step), {label[1]} {ms2:.4f} ms ({int(adj[5])} "
                  f"steps, {curve[k][1]:.1f} us per attempted step)")
    print(f"phase {curves}: probe curve {name}, per attempted step relative to K = 1: "
          + "; ".join(f"K={k} {curve[k][0] / curve[1][0]:.3f}x / {curve[k][1] / curve[1][1]:.3f}x"
                      for k in PROBE_CURVE))

    for (k, jvp), pair in held.items():
        records += probe_records(dims, k, jvp, pair, launches[(k, jvp)], names, sources, keys, B, suffix)
    return records


def probe_paths(cnf, fs, dev):
    """Phases 42 to 46: K-probe and JVP Hutchinson training (K6) through the
    probe instances of K1 and K2 (the flagship) and of their chain forms
    (power6).  Returns their records."""
    return (probe_model(cnf, fs, dev, "flagship", "two-layer", np.random.default_rng(SEED + 200), BATCH, True,
                        (42, 43, 44, 45, 46))
            + probe_model(cnf, fs, dev, "power6", "chain", np.random.default_rng(SEED + 201), BATCH, False,
                          (42, 43, 44, 45, 46)))


def wide_probe_paths(cnf, fs, dev):
    """Phases 56 to 60: K-probe and JVP Hutchinson training at the MINIBOONE
    width (K6 in the wide forms) through the probe instances of the wide K1
    and K2 chain forms, B = 2048.  Returns their records."""
    from continuousnf_tpu_torch.utils.configs import MODELS

    cfg = MODELS["miniboone43"]
    dims, B = cfg["dims"], cfg["batch"]
    spec = fs.chain_spec(cnf.MLP(dims, device=dev), dims[-1])
    check(fs._wide_chain(spec) and all(fs._kernel_covers(fs.TSIT5, spec, k, chain=True, jvp=jvp) is None
                                       for k, jvp in PROBE_CONFIGS),
          "the MINIBOONE chain with probes should run the wide forms' probe instances")

    # Phase 56: the probe instances' launch shapes at B = 2048 (K is a
    # run-time argument: one shape for K = 2, 4 and 8).
    arr = (ctypes.c_int * len(dims))(*dims)
    for lib_name, fn in ((fs.K1W_KERNEL, "cnf_k1wp_shape"), (fs.K2W_KERNEL, "cnf_k2wp_shape")):
        out = (ctypes.c_int * 4)()
        err = getattr(fs._library(lib_name), fn)(len(dims) - 1, arr, B, out)
        check(err == 0 and out[1] >= 1, f"{fn}: cudaError {err}")
        print(f"phase 56: {fn} at widths {dims}, B={B}, K = 2, 4 and 8: {out[0]} threads a block, {out[1]} blocks, "
              f"tile {out[2]}, {out[3]} bytes of dynamic shared memory")

    # Phases 57 to 60: the holds, the held train steps and the main paths
    # (58), `fit` at K = 4 (59) and the wide probe curve (60).
    return probe_model(cnf, fs, dev, "miniboone43", "wide", np.random.default_rng(SEED + 300), B, True,
                       (57, 58, 58, 59, 60))


# ---- K6 in the streamed forms: K-probe and JVP training past the wide limits ----

STREAM_PROBE_TRUTH_BATCH = 256  # phase 93's float64 rtol 1e-7 solve (and its fused and plain steps) at 256 samples
PROBE_ONLY_DIMS = (64, 128, 128, 120, 64)  # phase 96: the wide forms keep it with one probe, not with K
PROBE_ONLY_BATCH = 1024


def stream_probe_paths(cnf, fs, dev):
    """Phases 91 to 96: K-probe and JVP Hutchinson training past the wide
    limits (K6 in the streamed forms) through the probe instances of the
    streamed K1 and K2 chain forms at miniboone860 (B = 1024) and
    miniboone86 (B = 4096), their holds and one loss gradient each at
    K = 4 and JVP at bsds126 (B = 2048), and a chain that only the streamed
    probe instances keep with probes, through `make_full_solve`.  Returns
    their records."""
    import torch
    from continuousnf_tpu_torch.ode.tableaus import TSIT5
    from continuousnf_tpu_torch.utils.configs import MODELS, glorot_params, make_icnf, model_data

    (run1, run2), names, sources, label, keys = probe_form(fs, "stream")
    records = []
    for i, name in enumerate(("miniboone860", "miniboone86")):
        dims, B = MODELS[name]["dims"], MODELS[name].get("batch", BATCH)
        spec = fs.chain_spec(cnf.MLP(dims, device=dev), dims[-1])
        check(fs._stream_chain(spec, True) and all(fs._kernel_covers(TSIT5, spec, k, chain=True, jvp=jvp) is None
                                                   for k, jvp in PROBE_CONFIGS),
              f"{name} with probes should run the streamed probe instances")
        # Phase 91: the probe instances' launch shapes (K is a run-time
        # argument: one shape for every K).
        arr = (ctypes.c_int * len(dims))(*dims)
        for lib_name, fn in ((fs.K1S_KERNEL, "cnf_k1sp_shape"), (fs.K2S_KERNEL, "cnf_k2sp_shape")):
            out = (ctypes.c_int * 5)()
            err = getattr(fs._library(lib_name), fn)(len(dims) - 1, arr, B, out)
            check(err == 0 and out[1] >= 1, f"{fn}: cudaError {err}")
            print(f"phase 91: {fn} at widths {dims}, B={B}, every K: {out[0]} threads a block, {out[1]} blocks, "
                  f"tile {out[2]}, {out[3]} bytes of dynamic shared memory, {out[4]} floats of global tile scratch "
                  "a block")
        # Phases 92 to 95: the holds, the held train steps and the main
        # paths (93), `fit` at K = 4 (94) and the streamed probe curve (95).
        records += probe_model(cnf, fs, dev, name, "stream", np.random.default_rng(SEED + 400 + i), B, True,
                               (92, 93, 93, 94, 95), truth_batch=STREAM_PROBE_TRUTH_BATCH, reps=2,
                               suffix=None if name == "miniboone860" else name)

    # Phase 96: bsds126's probe instances against their twins at K = 4 and
    # JVP, and one loss gradient each (the main path, counters reset just
    # before it).
    name = "bsds126"
    dims, B = MODELS[name]["dims"], MODELS[name]["batch"]
    rng = np.random.default_rng(SEED + 410)
    ps_np = glorot_params(rng, dims)
    xs = torch.from_numpy(model_data(name, rng, B)).to(dev)
    ps = cnf.params_from_numpy(ps_np, dev)
    icnf = make_icnf(name, dev)
    spec = fs.chain_spec(icnf.nn, icnf.zdim)
    _, train, _, cot = kernel_inputs(icnf, ps, xs, rng, dev)
    eps_all = torch.from_numpy(rng.normal(size=(4, B, icnf.zdim)).astype("float32")).to(dev)
    for k, jvp in PROBE_PATHS:
        tag = probe_tag(k, jvp)
        kw1 = dict(train, eps=eps_all[:k].contiguous(), jvp=jvp)
        r1 = run_pair(f"{label[0]} {tag} ({name})", run1, fs.solve_train_plain, TSIT5, spec, kw1, reps=2)
        r2 = run_pair(f"{label[1]} {tag} ({name})", run2, fs.adjoint_train_plain, TSIT5, spec,
                      adjoint_kw(kw1, r1[0], cot), adjoint=True, reps=2)
        icnf_k = make_icnf(name, dev, num_probes=k, ad="jvp" if jvp else "vjp")
        eps = icnf_k.draw_eps(torch.Generator(device=dev).manual_seed(SEED + 411 + k), B, dev)
        fs.reset_launches()
        _, g, _ = loss_grad(cnf, icnf_k, ps_np, xs, dev, eps=eps, steer_r=0.05)
        torch.cuda.synchronize()
        counts = [w.probe_launches.get((k, jvp), 0) for w in (run1, run2)]
        check(set(launched(fs)) == set(names) and counts == [1, 1] and all(bool(torch.isfinite(x).all()) for x in g),
              f"{name} {tag}: launched {launched(fs)}, probe instances {counts}")
        records += probe_records(dims, k, jvp, (r1, r2), counts, names, sources, keys, B, name)
    print(f"phase 96: {name} B={B}: the streamed probe instances held to their twins at K = 4 and JVP; each loss "
          "gradient launched them once each and no other kernel")

    # Phase 96: a chain the wide forms keep with one probe but not with two
    # reaches the streamed probe instances through make_full_solve.
    dims, B = PROBE_ONLY_DIMS, PROBE_ONLY_BATCH
    rng = np.random.default_rng(SEED + 420)
    ps_np = glorot_params(rng, dims)
    xs = torch.from_numpy(rng.normal(size=(B, dims[0])).astype("float32")).to(dev)

    def model(fused=True, dtype=None, solver=None):
        kw = {} if solver is None else {"solver": solver}
        dtype = dtype or torch.float32
        return cnf.construct(cnf.RNODE, cnf.MLP(dims, device=dev, dtype=dtype), dims[0], 0, dtype=dtype,
                             compute_mode=cnf.VecJacMode(2, fused=fused), **kw)

    spec = fs.chain_spec(model().nn, dims[-1])
    check(not fs._stream_chain(spec) and fs._stream_chain(spec, True),
          f"{dims} should stream with probes only")
    eps = model().draw_eps(torch.Generator(device=dev).manual_seed(SEED + 421), B, dev)
    fs.reset_launches()
    l_k, g_k, _ = loss_grad(cnf, model(), ps_np, xs, dev, eps=eps)
    torch.cuda.synchronize()
    counts = [w.probe_launches.get((2, False), 0) for w in (run1, run2)]
    check(set(launched(fs)) == set(names) and counts == [1, 1],
          f"{dims} K2: launched {launched(fs)}, streamed probe instances {counts}")
    l_p, g_p, _ = loss_grad(cnf, model(False), ps_np, xs, dev, eps=eps)
    l_t, g_t, _ = loss_grad(cnf, model(False, torch.float64, cnf.SolverOptions(rtol=1e-7, atol=1e-9)), ps_np, xs, dev,
                            torch.float64, eps=eps.double())
    torch.cuda.synchronize()
    hold_gradients(f"{dims} K2", l_k, g_k, l_p, g_p, l_t, g_t)
    print(f"phase 96: MLP{dims} B={B}, two VJP probes through make_full_solve: launched {launched(fs)}, loss fused "
          f"{float(l_k):.6f} plain {float(l_p):.6f} float64 {float(l_t):.6f}")
    return records


# ---- K5: TEST-mode gradients of 2-layer nets ----

COND_TWO_LAYER = (17, 48, 16)  # phase 49: CondRNODE at the flagship widths on [z | ys], one ys column


def cond_two_layer(cnf, dev, fused=True, dtype=None, solver=None):
    """Phase 49's conditional 2-layer net: CondRNODE, MLP 17 -> 48 -> 16 tanh
    on [z | ys], nvars 8, naug 8, one conditioning input, tspan (0, 13), the
    flagship's steer_rate and lambdas, tsit5 at rtol 1e-3 (`solver` and
    `dtype` replace them for the float64 reference solve)."""
    import torch
    from continuousnf_tpu_torch.utils.configs import MODELS

    dtype = dtype or torch.float32
    return cnf.construct(cnf.CondRNODE, cnf.MLP(COND_TWO_LAYER, device=dev, dtype=dtype), 8, 8, tspan=(0.0, 13.0),
                         compute_mode=cnf.VecJacMode(fused=fused), dtype=dtype, **MODELS["flagship"]["extra"],
                         **({"solver": solver} if solver else {}))


def test_loss_grad(cnf, icnf, ps_np, xs, dev, dtype=None, ys=None):
    """One TEST loss (the exact-trace maximum likelihood) and its gradient in
    the params' leaves (w1, b1, w2, b2), in xs and, given the conditioning
    ys, in ys (last)."""
    import torch

    dtype = dtype or torch.float32
    p = cnf.params_from_numpy(ps_np, dev)
    leaves = [x.to(dtype).requires_grad_() for layer in p for x in (layer["w"], layer["b"])]
    p = tuple({"w": w, "b": b} for w, b in zip(leaves[::2], leaves[1::2]))
    x = xs.detach().to(dtype).requires_grad_()
    kw = {} if ys is None else {"ys": ys.detach().to(dtype).requires_grad_()}
    l = cnf.loss(icnf, cnf.Mode.TEST, x, p, **kw)
    return l.detach(), torch.autograd.grad(l, leaves + [x] + list(kw.values()))


def hold_test_gradients(label, names, g_k, g_p, g_t):
    """Each gradient through the fused TEST path (K5) within SOLVE_REL *
    max|g| of the float64 rtol 1e-7 solve, finite.  Where the plain path of
    the same method at the same tolerances (the generic BACKSOLVE backward,
    float32) is itself farther than that from the float64 solve, the fused
    one is held to 2x the plain one's distance instead: the method's own
    accuracy at those tolerances, which the warm-started fused backward (on
    its coarser step grid) may not beat.  Both distances are printed."""
    import torch

    for name, a, b, t in zip(names, g_k, g_p, g_t):
        d_k, d_p = float((a.double() - t).abs().max()), float((b.double() - t).abs().max())
        scale = float(t.abs().max())
        bound = SOLVE_REL * scale if d_p <= SOLVE_REL * scale else 2.0 * d_p
        rule = "SOLVE_REL" if d_p <= SOLVE_REL * scale else "2x the plain path's own distance"
        check(bool(torch.isfinite(a).all()) and d_k <= bound,
              f"{label} g_{name}: fused {d_k} from the float64 solve (bound {bound}: {rule}), plain {d_p}, "
              f"max|g| {scale}")
        print(f"{label} g_{name}: max|g| {scale:.4e}; distance to the float64 rtol 1e-7 solve: fused {d_k:.4e} "
              f"({d_k / scale:.3e} max|g|), plain {d_p:.4e} ({d_p / scale:.3e} max|g|); bound {rule}")


def test_gradient_path(label, cnf, fs, models, ps_np, xs, dev, want, ys=None):
    """A TEST loss gradient's main path: counters reset just before the fused
    call, which must launch exactly `want`; then the plain path and a
    float64 rtol 1e-7 solve, the losses within 1e-4 relative and the
    gradients (in the params, xs and ys) held by `hold_test_gradients`.
    `models` = (fused, plain, float64).  Returns the launches."""
    import torch

    fs.reset_launches()
    l_k, g_k = test_loss_grad(cnf, models[0], ps_np, xs, dev, ys=ys)
    torch.cuda.synchronize()
    counts = launched(fs)
    check(counts == want, f"{label}: the fused TEST gradient launched {counts}, expected {want}")
    l_p, g_p = test_loss_grad(cnf, models[1], ps_np, xs, dev, ys=ys)
    l_t, g_t = test_loss_grad(cnf, models[2], ps_np, xs, dev, torch.float64, ys=ys)
    check(abs(float(l_k - l_p)) <= TOL * max(1.0, abs(float(l_p))), f"{label} losses {float(l_k)} vs {float(l_p)}")
    hold_test_gradients(label, ["w1", "b1", "w2", "b2", "xs"] + ([] if ys is None else ["ys"]), g_k, g_p, g_t)
    print(f"{label}: TEST loss fused {float(l_k):.6f} plain {float(l_p):.6f} float64 {float(l_t):.6f}; "
          f"launches {counts}")
    return counts


def k5_pair(label, fs, tab, spec, fwd, fwd_kw, rng, dev):
    """K5 against its twin on the forward kernel's final state: `fwd` run on
    `fwd_kw` (a TEST solve from dlogp0 = 0, with the conditioning ys of a
    conditional net), then a loss-like cotangent
    (a_z ~ N(0, 1 / B), a_dlogp = 1 / B) and the forward's last step as the
    warm start (`run_pair`: equal steps or the near-tie rule, z0 and a_z0
    held to the float64 twin).  Returns (out_k, error, ms, plain ms)."""
    import torch

    B, dz = fwd_kw["z0"].shape
    with torch.no_grad():
        out = fwd(tab, spec, **fwd_kw)
    T = lambda a: torch.from_numpy(np.asarray(a, "float32")).to(dev)  # noqa: E731
    adj = dict(adjoint_kw(fwd_kw, out, dict(azT=T(rng.normal(0.0, 1.0 / B, (B, dz))), aaccT=T(np.full((1, B), 1.0 / B)),
                                            t_hi=fwd_kw["t1"], t_lo=fwd_kw["t0"])), accT=out[1][None])
    adj.pop("dlogp0")
    return run_pair(label, fs.run_test_adjoint_kernel, fs.adjoint_test_plain, tab, spec, adj, adjoint=True)


def test_gradients(cnf, fs, dev, keep):
    """Phases 47 to 50: TEST-mode gradients of 2-layer nets through K5.
    Returns the records of K5 and of its COND instance; `keep` receives
    phase 48's draws and `sample` gradients (phase 55 reads them)."""
    import torch
    from continuousnf_tpu_torch.ode.tableaus import TSIT5, VERNER65
    from continuousnf_tpu_torch.utils.configs import glorot_params, make_icnf, model_data

    rng = np.random.default_rng(SEED + 100)
    truth = cnf.SolverOptions(rtol=1e-7, atol=1e-9)
    t0, t13 = torch.tensor(0.0, device=dev), torch.tensor(13.0, device=dev)

    # Phase 47: the flagship's TEST loss gradient through K3 and K5.
    dims = (16, 48, 16)
    ps_np = glorot_params(rng, dims)
    ps = cnf.params_from_numpy(ps_np, dev)
    xs = torch.from_numpy(model_data("flagship", rng, BATCH)).to(dev)
    models = (make_icnf("flagship", dev), make_icnf("flagship", dev, fused=False),
              make_icnf("flagship", dev, fused=False, dtype=torch.float64, solver=truth))
    spec = fs.chain_spec(models[0].nn, 16)
    n_k5 = test_gradient_path("flagship TEST gradient", cnf, fs, models, ps_np, xs, dev,
                              {fs.K3_KERNEL: 1, fs.K5_KERNEL: 1})[fs.K5_KERNEL]
    z0 = torch.cat([xs, torch.zeros((BATCH, 8), device=dev)], dim=1)
    fwd_kw = dict(rtol=1e-3, atol=1e-6, max_steps=models[0].solver.max_steps, ws=[p["w"] for p in ps],
                  bs=[p["b"] for p in ps], z0=z0, dlogp0=torch.zeros(BATCH, device=dev), t0=t0, t1=t13,
                  dt_init=torch.tensor(0.05, device=dev))
    out5, e5, ms5, p5 = k5_pair("K5", fs, TSIT5, spec, fs.run_solve_kernel, fwd_kw, rng, dev)
    print(f"K5 vs K2 on this card: {ms5 * 1e3 / int(out5[5]):.1f} us per attempted step (K2: phase 10's line)")

    # Phase 48: the score (the x-gradient of ICNFDist.logpdf) and the
    # params-gradient of sample(4096, z1=...), whose solve runs t1 -> t0.
    z1_np = rng.normal(size=(BATCH, 16)).astype("float32")
    w_np = rng.normal(size=(BATCH, 8)).astype("float32")

    def serving_grads(icnf, dtype):
        p = cnf.params_from_numpy(ps_np, dev)
        leaves = [x.to(dtype).requires_grad_() for layer in p for x in (layer["w"], layer["b"])]
        p = tuple({"w": w, "b": b} for w, b in zip(leaves[::2], leaves[1::2]))
        dist = cnf.ICNFDist(icnf, cnf.Mode.TEST, p)
        x = xs.to(dtype).requires_grad_()
        fs.reset_launches()
        (g_x,) = torch.autograd.grad(dist.logpdf(x).sum(), [x])
        n_lp = launched(fs)
        fs.reset_launches()
        obj = torch.sum(dist.sample(BATCH, z1=torch.from_numpy(z1_np).to(dev, dtype)) * torch.from_numpy(w_np).to(dev, dtype))
        g_s = torch.autograd.grad(obj, leaves)
        torch.cuda.synchronize()
        return [g_x] + list(g_s), n_lp, launched(fs)

    g_k, n_lp, n_s = serving_grads(models[0], torch.float32)
    want = {fs.K3_KERNEL: 1, fs.K5_KERNEL: 1}
    check(n_lp == want and n_s == want, f"the logpdf and sample gradients launched {n_lp} and {n_s}, expected {want}")
    g_p, _, _ = serving_grads(models[1], torch.float32)
    g_t, _, _ = serving_grads(models[2], torch.float64)
    hold_test_gradients("flagship serving", ["score (x)", "sample w1", "sample b1", "sample w2", "sample b2"], g_k, g_p,
                        g_t)
    keep.update(ps_np=ps_np, z1_np=z1_np, w_np=w_np, g_k=g_k[1:], g_p=g_p[1:], g_t=g_t[1:])
    print(f"logpdf and sample gradients: launches {n_lp} and {n_s}")

    # Phase 49: K5's COND instance, behind K3's COND instance.
    ps_np_c = glorot_params(rng, COND_TWO_LAYER)
    ps_c = cnf.params_from_numpy(ps_np_c, dev)
    ys = torch.from_numpy(rng.uniform(-1.0, 1.0, (BATCH, 1)).astype("float32")).to(dev)
    models_c = (cond_two_layer(cnf, dev), cond_two_layer(cnf, dev, fused=False),
                cond_two_layer(cnf, dev, fused=False, dtype=torch.float64, solver=truth))
    spec_c = fs.chain_spec(models_c[0].nn, 16)
    n_k5c = test_gradient_path("conditional 2-layer TEST gradient", cnf, fs, models_c, ps_np_c, xs, dev,
                               {fs.K3_KERNEL + "/cond": 1, fs.K5_KERNEL: 1}, ys=ys)[fs.K5_KERNEL]
    fwd_c = dict(fwd_kw, ws=[p["w"] for p in ps_c], bs=[p["b"] for p in ps_c], ys=ys)
    out5c, e5c, ms5c, p5c = k5_pair("K5 COND", fs, TSIT5, spec_c, fs.run_cond_solve_kernel, fwd_c, rng, dev)

    # Phase 50: the README model's TEST gradient at the README tolerances
    # (verner65: the non-FSAL refresh), K3 and K5 under verner65 only, on
    # the README workflow's weights and data (phase 30's draws; at some
    # other Glorot draws the backsolve of this contracting 2-d flow is
    # chaotic, and even the float64 rtol 1e-7 solve is no reference: PERF.md).
    ps_np_r = glorot_params(np.random.default_rng(SEED + 30), README_DIMS)
    x_r = torch.from_numpy(np.random.default_rng(SEED).beta(2.0, 4.0, (BATCH, 1)).astype("float32")).to(dev)
    models_r = (readme_model(cnf, dev), readme_model(cnf, dev, fused=False),
                readme_model(cnf, dev, fused=False, dtype=torch.float64, solver=truth))
    with first_calls(fs, ("run_solve_kernel", "run_test_adjoint_kernel")) as seen:
        test_gradient_path("README TEST gradient", cnf, fs, models_r, ps_np_r, x_r, dev,
                           {fs.K3_KERNEL: 1, fs.K5_KERNEL: 1})
    check(seen["tableaus"] == {"verner65"}, f"the README TEST gradient ran the tableaus {seen['tableaus']}")
    ps_r = cnf.params_from_numpy(ps_np_r, dev)
    fwd_r = dict(fwd_kw, **cnf.README_TOLERANCES, ws=[p["w"] for p in ps_r], bs=[p["b"] for p in ps_r],
                 z0=torch.cat([x_r, torch.zeros((BATCH, 1), device=dev)], dim=1))
    k5_pair("K5 verner65 (README model)", fs, VERNER65, fs.chain_spec(models_r[0].nn, 2), fs.run_solve_kernel,
            fwd_r, rng, dev)

    dz, H = 16, 48
    rec = lambda name, n, err, ms, pms, out, nc, fma: kernel_record(  # noqa: E731
        name, "k5_test_adjoint.cu", "continuousnf_tpu/ops/fused_solve.py:1767", n, err, ms, pms, fma, BATCH, out[5],
        2 * (2 * dz * H + nc * H + H + dz) + BATCH * (4 * dz + 3 + 2 * nc))
    return [rec(fs.K5_KERNEL, n_k5, e5, ms5, p5, out5, 0, two_layer_fma(dz, H)["k5"]),
            rec(fs.K5_KERNEL + "/cond", n_k5c, e5c, ms5c, p5c, out5c, 1, k5_fma(dz, H, 1))]


# ---- K10: the per-stage TRAIN field; DIRECT and fixed-step gradients, tstops, trajectories ----

FLAGSHIP_DIMS = (16, 48, 16)
K10_REPS = 200  # launches per CUDA-event timing of K10 and of its plain version
K10_TOL = 1e-5  # K10 against its plain version, relative to max(1, max|.|)
TSTOPS = (4.0, 8.0)
TRAJ_DIMS = (2, 32, 32, 2)  # examples/trajectory_plot.py:40-55: FFJORD, tspan (0, 8), 33 save points
TRAJ_N = 64


def k10_inputs(dims, B, dev, dtype, rng):
    """K10's arguments (w1, b1, w2, b2, z, eps) for a 2-layer net of widths
    `dims`: Glorot weights, N(0, 0.05) biases, z and eps ~ N(0, 1)."""
    import torch
    from continuousnf_tpu_torch.utils.configs import glorot_params

    ps = glorot_params(rng, dims)
    T = lambda a: torch.from_numpy(np.asarray(a)).to(dev, dtype)  # noqa: E731
    return [T(ps[0]["w"]), T(ps[0]["b"]), T(ps[1]["w"]), T(ps[1]["b"]), T(rng.normal(size=(B, dims[0]))),
            T(rng.normal(size=(B, dims[0])))]


def k10_pairs(fd, dev, rng):
    """Phase 51: K10 against its plain version on the card at the flagship's
    shapes, the README model's and an odd batch, in float32 and float64,
    each output within K10_TOL * max(1, max|.|); then CUDA-event times of
    both over K10_REPS calls at the flagship's shapes in float32 and float64
    (a call's time: K10 is far shorter than its launch), and the kernel's
    own time on the card from the profiler.  Returns (the largest absolute
    error at the flagship's shapes, ms, plain ms), in float32."""
    import torch
    from continuousnf_tpu_torch.utils.configs import cuda_ms

    flagship = {}
    for label, dims, B in (("flagship", FLAGSHIP_DIMS, BATCH), ("README model", README_DIMS, 32),
                           ("odd batch", FLAGSHIP_DIMS, BATCH + 1)):
        for dtype in (torch.float32, torch.float64):
            xs = k10_inputs(dims, B, dev, dtype, rng)
            n = fd.run_fused_field_kernel.launches
            with torch.no_grad():
                got = fd.run_fused_field_kernel(*xs)
                ref = fd.fused_field_plain(*xs)
            torch.cuda.synchronize()
            check(fd.run_fused_field_kernel.launches == n + 1, f"K10 {label} did not launch once")
            errs = [rel_err(a, b) for a, b in zip(got, ref)]
            check(all(a.dtype == dtype and a.shape == b.shape and bool(torch.isfinite(a).all()) for a, b in zip(got, ref))
                  and max(errs) <= K10_TOL, f"K10 {label} {dtype}: relative errors (y, tr, |y|, |eJ|) {errs}")
            print(f"K10 {label} B={B} {str(dtype)[6:]}: relative errors (y, tr, |y|, |eJ|) "
                  + ", ".join(f"{e:.3e}" for e in errs))
            if label == "flagship":
                flagship[dtype] = xs, max(float((a - b).abs().max()) for a, b in zip(got, ref))
    for dtype, (xs, err) in flagship.items():
        with torch.no_grad():
            ms_k = cuda_ms(lambda: fd.run_fused_field_kernel(*xs), K10_REPS)
            ms_p = cuda_ms(lambda: fd.fused_field_plain(*xs), K10_REPS)
            ms_k2 = cuda_ms(lambda: fd.run_fused_field_kernel(*xs), K10_REPS)
            with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
                for _ in range(K10_REPS):
                    fd.run_fused_field_kernel(*xs)
                torch.cuda.synchronize()
        dev_us = [e.device_time_total / e.count for e in prof.key_averages() if "k10_fused_field" in e.key and e.count]
        print(f"K10 at the flagship's shapes (B={BATCH}, {str(dtype)[6:]}), mean of {K10_REPS} calls: kernel "
              f"{ms_k:.4f} ms (again {ms_k2:.4f}), plain version {ms_p:.4f} ms; the kernel's own time on the card "
              "(profiler): " + (f"{dev_us[0]:.3f} us" if dev_us else "not measured (no device events)"))
        if dtype == torch.float32:
            record = err, (ms_k + ms_k2) / 2, ms_p
    return record


def hold_steps(label, nfe_k, nfe_p, cnf, icnf_p, ps_np, xs, eps, steer_r, dev) -> None:
    """Equal NFE (so equal attempted steps) of the fused and the plain path,
    or a near-tie shown on the plain path: the NFE of its TRAIN forward
    (`icnf_p` on xs, eps, steer_r) moves when xs moves by one float32 ulp
    (`near_tie.nudge`, eight draws), and the fused NFE lies within the plain
    path's own range."""
    import torch
    from continuousnf_tpu_torch.utils import near_tie

    if nfe_k == nfe_p:
        return

    def nudged(i):
        with torch.no_grad():
            return int(cnf.loss_and_metrics(icnf_p, cnf.Mode.TRAIN, near_tie.nudge(xs, torch.Generator().manual_seed(i)),
                                            cnf.params_from_numpy(ps_np, dev), eps=eps, steer_r=steer_r)[1]["nfe"])

    moved = sorted({nfe_p} | {nudged(i) for i in range(8)})
    print(f"{label}: NFE {nfe_k} vs plain {nfe_p}; the plain path under one-ulp moves of its inputs: {moved}")
    check(len(moved) > 1 and moved[0] <= nfe_k <= moved[-1],
          f"{label}: NFE {nfe_k} vs {nfe_p}, and the plain path shows no near-tie covering it ({moved})")


def direct_grad(cnf, icnf, ps_np, xs, dev, eps, steer_r, dtype=None, ys=None):
    """The TRAIN loss and its gradient in the params' leaves and in the
    probes: (loss, param gradients, probe gradient, metrics)."""
    import torch

    dtype = dtype or torch.float32
    p = cnf.params_from_numpy(ps_np, dev)
    leaves = [x.to(dtype).requires_grad_() for layer in p for x in (layer["w"], layer["b"])]
    p = tuple({"w": w, "b": b} for w, b in zip(leaves[::2], leaves[1::2]))
    e = eps.to(dtype).requires_grad_()
    l, m = cnf.loss_and_metrics(icnf, cnf.Mode.TRAIN, xs.to(dtype), p, eps=e, steer_r=steer_r)
    g = torch.autograd.grad(l, leaves + [e])
    return l.detach(), g[:-1], g[-1], m


def recorded_gradient(label, cnf, fs, icnf_k, icnf_p, g_truth, ps_np, xs, eps, steer_r, dev):
    """One loss gradient through a path the whole-solve kernels do not take:
    K10 (fused=True, counters reset just before it, K10 launched once per
    forward field evaluation and no other kernel) against the plain field
    (fused=False): equal NFE or a near-tie (`hold_steps`), the probe
    gradients within GRAD_TOL * max|g| of each other, and the losses and
    parameter gradients held by `hold_gradients` against the float64 rtol
    1e-7 solve `g_truth` = (loss, gradients).  Returns (K10's launches, the
    CUDA-event ms of the fused and the plain loss gradient)."""
    import torch
    from continuousnf_tpu_torch.utils.configs import cuda_ms

    fs.reset_launches()
    torch.cuda.reset_peak_memory_stats(dev)
    base_mb = torch.cuda.memory_allocated(dev) / 2**20
    l_k, g_k, ge_k, m_k = direct_grad(cnf, icnf_k, ps_np, xs, dev, eps, steer_r)
    torch.cuda.synchronize()
    graph_mb = torch.cuda.max_memory_allocated(dev) / 2**20 - base_mb
    counts = launched(fs)
    nfe_k = int(m_k["nfe"])
    check(counts == {fs.K10_KERNEL: nfe_k}, f"{label}: launches {counts}, expected K10 {nfe_k} times and nothing else")
    l_p, g_p, ge_p, m_p = direct_grad(cnf, icnf_p, ps_np, xs, dev, eps, steer_r)
    hold_steps(label, nfe_k, int(m_p["nfe"]), cnf, icnf_p, ps_np, xs, eps, steer_r, dev)
    e_eps = float((ge_k - ge_p).abs().max()) / max(1e-30, float(ge_p.abs().max()))
    check(bool(torch.isfinite(ge_k).all()) and float(ge_k.abs().max()) > 0.0 and e_eps <= GRAD_TOL,
          f"{label}: the probe gradient through K10 is {e_eps} max|g| from the plain path's")
    hold_gradients(label, l_k, g_k, l_p, g_p, *g_truth)
    ms_k = cuda_ms(lambda: direct_grad(cnf, icnf_k, ps_np, xs, dev, eps, steer_r), 3)
    ms_p = cuda_ms(lambda: direct_grad(cnf, icnf_p, ps_np, xs, dev, eps, steer_r), 3)
    print(f"{label}: loss fused {float(l_k):.6f} plain {float(l_p):.6f} float64 {float(g_truth[0]):.6f}; NFE {nfe_k} "
          f"(plain {int(m_p['nfe'])}); K10 launches {nfe_k}; the probe gradient: max|g| {float(ge_p.abs().max()):.4e}, "
          f"fused vs plain {e_eps:.3e} max|g|; loss and gradient {ms_k:.4f} ms (plain field {ms_p:.4f} ms); "
          f"peak memory above the inputs {graph_mb:.1f} MiB (the recorded solve, no checkpointing)")
    return nfe_k, ms_k, ms_p


def trajectory_example(cnf, fs, dev):
    """Phase 54b: the trajectory example's `inference(..., trajectory=True)`
    on 64 two-moons points through K7 TEST per segment (32 launches, no other
    kernel) against the plain path: the same grid, equal summed steps, zs and
    logp within TOL * max(1, max|.|)."""
    import torch
    from continuousnf_tpu_torch.utils.configs import cuda_ms, glorot_params, two_moons

    rng = np.random.default_rng(SEED + 54)
    ps = cnf.params_from_numpy(glorot_params(rng, TRAJ_DIMS), dev)
    xs = torch.from_numpy(two_moons(rng, TRAJ_N)).to(dev)
    solver = cnf.SolverOptions(saveat=tuple(np.linspace(0.0, 8.0, 33)))
    mk = lambda fused: cnf.construct(cnf.FFJORD, cnf.MLP(TRAJ_DIMS, device=dev), 2, 0, tspan=(0.0, 8.0),  # noqa: E731
                                     compute_mode=cnf.VecJacMode(fused=fused), solver=solver)
    fs.reset_launches()
    with torch.no_grad():
        lp_k, _, st_k, (ts_k, zs_k) = cnf.inference(mk(True), cnf.Mode.TEST, xs, ps, trajectory=True)
        torch.cuda.synchronize()
        counts = launched(fs)
        lp_p, _, st_p, (ts_p, zs_p) = cnf.inference(mk(False), cnf.Mode.TEST, xs, ps, trajectory=True)
    check(counts == {fs.K7_KERNEL + "/test": 32}, f"the trajectory launched {counts}, expected K7 TEST 32 times")
    check(tuple(zs_k.shape) == (33, TRAJ_N, 2) and bool(torch.isfinite(zs_k).all()) and torch.equal(ts_k, ts_p),
          f"trajectory shapes {tuple(zs_k.shape)}")
    e_z, e_l = rel_err(zs_k, zs_p), rel_err(lp_k, lp_p)
    check(int(st_k.steps) == int(st_p.steps) and max(e_z, e_l) <= TOL,
          f"trajectory: steps {int(st_k.steps)} vs {int(st_p.steps)}, zs {e_z}, logp {e_l}")
    with torch.no_grad():
        ms_k = cuda_ms(lambda: cnf.inference(mk(True), cnf.Mode.TEST, xs, ps, trajectory=True), 3)
        ms_p = cuda_ms(lambda: cnf.inference(mk(False), cnf.Mode.TEST, xs, ps, trajectory=True), 1)
    print(f"trajectory example (FFJORD {TRAJ_DIMS}, {TRAJ_N} points, 33 save points over (0, 8)): steps "
          f"{int(st_k.steps)} (plain {int(st_p.steps)}), zs {e_z:.3e}, logp {e_l:.3e} from the plain path; "
          f"K7 TEST launches {counts[fs.K7_KERNEL + '/test']}; {ms_k:.4f} ms (plain {ms_p:.4f} ms)")


def direct_paths(cnf, fs, dev, sample_draw):
    """Phases 51 to 55: K10 and the paths the whole-solve kernels do not
    take, on the flagship.  Returns K10's record."""
    import dataclasses

    import torch
    from continuousnf_tpu_torch.ops import fused_dynamics as fd
    from continuousnf_tpu_torch.utils.configs import glorot_params, make_icnf, model_data

    rng = np.random.default_rng(SEED + 51)
    err, ms_k10, ms_p10 = k10_pairs(fd, dev, rng)

    # Phase 52: the flagship's loss gradient under DIRECT and under 32 rk4
    # steps, K10 against the plain field and a float64 rtol 1e-7 solve.
    ps_np = glorot_params(rng, FLAGSHIP_DIMS)
    xs = torch.from_numpy(model_data("flagship", rng, BATCH)).to(dev)
    eps = torch.from_numpy(rng.normal(size=(1, BATCH, 16)).astype("float32")).to(dev)
    steer_r = 0.05
    truth = make_icnf("flagship", dev, fused=False, dtype=torch.float64, solver=cnf.SolverOptions(rtol=1e-7, atol=1e-9))
    l_t, g_t, _ = loss_grad(cnf, truth, ps_np, xs, dev, torch.float64, eps=eps.double(), steer_r=steer_r)
    direct = cnf.SolverOptions(adjoint=cnf.Adjoint.DIRECT)
    fixed = cnf.SolverOptions(method="rk4", fixed_num_steps=32)
    n_k10, ms_d, ms_dp = recorded_gradient("DIRECT", cnf, fs, make_icnf("flagship", dev, solver=direct),
                                           make_icnf("flagship", dev, fused=False, solver=direct), (l_t, g_t), ps_np,
                                           xs, eps, steer_r, dev)
    _, ms_f, ms_fp = recorded_gradient("rk4 x 32", cnf, fs, make_icnf("flagship", dev, solver=fixed),
                                       make_icnf("flagship", dev, fused=False, solver=fixed), (l_t, g_t), ps_np, xs,
                                       eps, steer_r, dev)

    # Phase 53: fit under DIRECT, four Lion steps through K10 alone.
    fit_path(cnf, fs, make_icnf("flagship", dev, solver=direct), ps_np, dev,
             model_data("flagship", np.random.default_rng(SEED + 53), N_STEPS * BATCH), batch_size=BATCH)
    counts = launched(fs)
    check(set(counts) == {fs.K10_KERNEL} and counts[fs.K10_KERNEL] >= N_STEPS,
          f"fit under DIRECT launched {counts}, expected K10 alone")
    print(f"fit under DIRECT: {N_STEPS} Lion steps at B={BATCH}, launches {counts}")

    # Phase 54: tstops under BACKSOLVE through K1 and K2 per segment, the
    # trajectory example through K7 TEST per segment, and adjoint_stats.
    stops = cnf.SolverOptions(tstops=TSTOPS)
    icnf_k, icnf_p = make_icnf("flagship", dev, solver=stops), make_icnf("flagship", dev, fused=False, solver=stops)
    fs.reset_launches()
    l_k, g_k, m_k = loss_grad(cnf, icnf_k, ps_np, xs, dev, eps=eps, steer_r=steer_r)
    torch.cuda.synchronize()
    counts = launched(fs)
    want = {fs.K1_KERNEL: len(TSTOPS) + 1, fs.K2_KERNEL: len(TSTOPS) + 1}
    check(counts == want, f"the tstops gradient launched {counts}, expected {want}")
    l_p, g_p, m_p = loss_grad(cnf, icnf_p, ps_np, xs, dev, eps=eps, steer_r=steer_r)
    hold_steps("tstops", int(m_k["nfe"]), int(m_p["nfe"]), cnf, icnf_p, ps_np, xs, eps, steer_r, dev)
    hold_gradients("tstops", l_k, g_k, l_p, g_p, l_t, g_t)
    print(f"tstops {TSTOPS}: loss fused {float(l_k):.6f} plain {float(l_p):.6f}; NFE {int(m_k['nfe'])} (plain "
          f"{int(m_p['nfe'])}); launches {counts}")
    trajectory_example(cnf, fs, dev)
    flag_k, flag_p = make_icnf("flagship", dev), make_icnf("flagship", dev, fused=False)
    k2 = _StepsRecorder(fs.run_adjoint_kernel)
    fs.run_adjoint_kernel = k2
    try:
        loss_grad(cnf, flag_k, ps_np, xs, dev, eps=eps, steer_r=steer_r)
        fwd, bwd = cnf.adjoint_stats(flag_k, cnf.Mode.TRAIN, xs, cnf.params_from_numpy(ps_np, dev), eps=eps,
                                     steer_r=steer_r)
    finally:
        fs.run_adjoint_kernel = k2.wrapper
    k2_steps = k2.steps
    fwd_p, bwd_p = cnf.adjoint_stats(flag_p, cnf.Mode.TRAIN, xs, cnf.params_from_numpy(ps_np, dev), eps=eps,
                                     steer_r=steer_r)
    check(k2_steps[:1] == [int(bwd.steps)] and len(k2_steps) == 2,
          f"adjoint_stats' backward took {int(bwd.steps)} steps, K2 in the gradient {k2_steps[:1]}")
    print(f"adjoint_stats: forward {int(fwd.steps)} steps / NFE {int(fwd.nfe)}, backward {int(bwd.steps)} steps / "
          f"NFE {int(bwd.nfe)} (K2 in the gradient: {k2_steps[0]} steps); the plain path: forward "
          f"{int(fwd_p.steps)} / {int(fwd_p.nfe)}, backward {int(bwd_p.steps)} / {int(bwd_p.nfe)}")

    # Phase 55: sample's params-gradient under DIRECT on phase 48's draw,
    # beside the BACKSOLVE ones and the float64 rtol 1e-7 solve.
    sd = sample_draw
    ps48 = sd["ps_np"]
    z1, w = (torch.from_numpy(sd[k]).to(dev) for k in ("z1_np", "w_np"))

    def sample_grad(icnf, dtype=torch.float32):
        p = cnf.params_from_numpy(ps48, dev)
        leaves = [x.to(dtype).requires_grad_() for layer in p for x in (layer["w"], layer["b"])]
        p = tuple({"w": a, "b": b} for a, b in zip(leaves[::2], leaves[1::2]))
        obj = torch.sum(cnf.generate(icnf, cnf.Mode.TEST, p, BATCH, z1=z1.to(dtype)) * w.to(dtype))
        return torch.autograd.grad(obj, leaves)

    direct_test = dataclasses.replace(direct, direct_max_steps=4096)
    fs.reset_launches()
    g_d = sample_grad(make_icnf("flagship", dev, solver=direct_test))
    check(not launched(fs), f"sample's DIRECT gradient launched {launched(fs)}: its forward is the plain solve")
    g_d64 = sample_grad(make_icnf("flagship", dev, fused=False, dtype=torch.float64,
                                  solver=dataclasses.replace(direct_test, rtol=1e-7, atol=1e-9)), torch.float64)
    names = ("w1", "b1", "w2", "b2")
    for name, gd, gd64, gk, gp, gt in zip(names, g_d, g_d64, sd["g_k"], sd["g_p"], sd["g_t"]):
        scale = float(gt.abs().max())
        dist = lambda g: float((g.double() - gt).abs().max()) / scale  # noqa: E731
        check(bool(torch.isfinite(gd).all()), f"sample's DIRECT gradient g_{name} not finite")
        print(f"sample g_{name}: max|g| {scale:.4e}; distance to the float64 rtol 1e-7 BACKSOLVE solve, in max|g|: "
              f"DIRECT {dist(gd):.3e}, BACKSOLVE fused (K3 + K5) {dist(gk):.3e}, BACKSOLVE plain {dist(gp):.3e}, "
              f"float64 DIRECT at rtol 1e-7 {dist(gd64):.3e}")

    dz, H = FLAGSHIP_DIMS[0], FLAGSHIP_DIMS[1]
    print(f"K10 on the DIRECT loss gradient: {n_k10} launches; DIRECT loss gradient {ms_d:.4f} ms (plain field "
          f"{ms_dp:.4f}), rk4 x 32 {ms_f:.4f} ms (plain field {ms_fp:.4f})")
    return [kernel_record(fs.K10_KERNEL, "k10_fused_field.cu", "continuousnf_tpu/ops/fused_dynamics.py:93", n_k10,
                          err, ms_k10, ms_p10, 4 * dz * H, BATCH, 0, 2 * dz * H + H + dz + BATCH * (3 * dz + 3))]


# ---- 2-layer nets past state width 32: the README net family at the HEPMASS width ----


def wide_two_layer_names(fs):
    """The hepmass42 path's kernels: record key -> (KERNEL_WRAPPERS name,
    wrapper, twin, source, the TPU site)."""
    at = "continuousnf_tpu/ops/fused_solve.py:"
    return {
        "k3w": (fs.K3W_KERNEL, fs.run_wide_test2_solve_kernel, fs.solve_test_plain, "k3_wide_solve.cu", at + "1043"),
        "k5w": (fs.K5W_KERNEL, fs.run_wide_test_adjoint_kernel, fs.adjoint_test_plain, "k5_wide_adjoint.cu",
                at + "1767"),
        "k4w": (fs.K4WA_KERNEL, fs.run_wide_exact_adjoint_kernel, fs.adjoint_train_exact_plain, "k4_wide_adjoint.cu",
                at + "1767"),
        "k1c": (fs.K1W_KERNEL, fs.run_wide_train_solve_kernel, fs.solve_train_plain, "k1_wide_solve.cu", at + "1043"),
        "k2c": (fs.K2W_KERNEL, fs.run_wide_adjoint_kernel, fs.adjoint_train_plain, "k2_wide_adjoint.cu", at + "1767"),
        "k7e": (fs.K7W_KERNEL + "/exact", fs.run_wide_exact_solve_kernel, fs.solve_train_exact_plain,
                "k7_wide_solve.cu", at + "1043"),
    }


def wide_two_layer(cnf, fs, dev):
    """Phases 61 to 66: the README net family MLP((n_in, 3 n_in, n_in)) at
    the HEPMASS width (hepmass42: RNODE, nvars = naug = 21, MLP 42 -> 126 ->
    42 tanh, the flagship recipe, B = 4096), past the 2-layer kernels' state
    width: wide K3 and wide K5 (TEST), the wide K1 and K2 chain forms
    (Hutchinson TRAIN), wide K7 exact and the wide K4 adjoint (exact TRAIN).
    Returns their records."""
    import torch
    from continuousnf_tpu_torch.ode.tableaus import TSIT5
    from continuousnf_tpu_torch.utils.configs import MODELS, cuda_ms, glorot_params, make_icnf, model_data

    cfg = MODELS["hepmass42"]
    dims, B = cfg["dims"], BATCH
    dz, H = dims[0], dims[1]
    rng = np.random.default_rng(SEED + 400)
    ps_np = glorot_params(rng, dims)
    xs = torch.from_numpy(model_data("hepmass42", rng, B)).to(dev)
    ps = cnf.params_from_numpy(ps_np, dev)
    model = lambda **kw: make_icnf("hepmass42", dev, **kw)  # noqa: E731
    icnf_k, icnf_p = model(), model(fused=False)
    spec = fs.chain_spec(icnf_k.nn, icnf_k.zdim)
    check(fs._wide_two_layer(spec) and fs._wide_two_layer_covers(TSIT5, spec) is None,
          "the hepmass42 net should run the wide 2-layer kernels")
    names = wide_two_layer_names(fs)

    # Phase 61: the wide 2-layer kernels' launch shapes at B = 4096.
    arr = (ctypes.c_int * 3)(*dims)
    for lib_name, fn, n_out in ((fs.K3W_KERNEL, "cnf_k3w_shape", 4), (fs.K5W_KERNEL, "cnf_k5w_shape", 4),
                                (fs.K4WA_KERNEL, "cnf_k4w_shape", 5)):
        out = (ctypes.c_int * n_out)()
        err = getattr(fs._library(lib_name), fn)(2, arr, B, out)
        check(err == 0 and out[1] >= 1, f"{fn}: cudaError {err}")
        tile = f"tile {out[2]}" + (f", {out[3]} basis rows a chunk" if n_out == 5 else "")
        print(f"phase 61: {fn} at widths {dims}, B={B}: {out[0]} threads a block, {out[1]} blocks, {tile}, "
              f"{out[n_out - 1]} bytes of dynamic shared memory")

    # Phase 62: each kernel of the path against its twin (forwards from
    # nonzero accumulators, adjoints from their forward's output with its
    # last step as the warm start), timed.
    test, train, exact, cot = kernel_inputs(icnf_k, ps, xs, rng, dev)
    T = lambda a: torch.from_numpy(np.asarray(a, "float32")).to(dev)  # noqa: E731
    runs = {}
    for key in ("k3w", "k1c", "k7e"):
        kw = {"k3w": test, "k1c": train, "k7e": exact}[key]
        runs[key] = run_pair(f"{names[key][0]} (hepmass42)", names[key][1], names[key][2], TSIT5, spec, kw)
    runs["k2c"] = run_pair(f"{fs.K2W_KERNEL} (hepmass42)", names["k2c"][1], names["k2c"][2], TSIT5, spec,
                           adjoint_kw(train, runs["k1c"][0], cot), adjoint=True)
    runs["k4w"] = run_pair(f"{fs.K4WA_KERNEL} (hepmass42)", names["k4w"][1], names["k4w"][2], TSIT5, spec,
                           adjoint_kw(exact, runs["k7e"][0], cot), adjoint=True)
    k5_kw = dict(adjoint_kw(test, runs["k3w"][0], dict(azT=T(rng.normal(0.0, 1.0 / B, (B, dz))),
                                                       aaccT=T(np.full((1, B), 1.0 / B)), t_hi=test["t1"],
                                                       t_lo=test["t0"])), accT=runs["k3w"][0][1][None])
    k5_kw.pop("dlogp0")
    runs["k5w"] = run_pair(f"{fs.K5W_KERNEL} (hepmass42)", names["k5w"][1], names["k5w"][2], TSIT5, spec, k5_kw,
                           adjoint=True)
    print("phase 62: hepmass42 kernels held to their twins")

    # Phase 63: logpdf through the kernel against the plain path.
    hold_logpdf(cnf, "hepmass42", icnf_k, icnf_p, xs, ps)

    # Phase 64: the Hutchinson, exact and TEST losses and gradients through
    # the kernels, the plain path and a float64 rtol 1e-7 solve; the fused
    # gradient launches its route's two kernels once each and nothing else.
    truth = cnf.SolverOptions(rtol=1e-7, atol=1e-9)
    gen = torch.Generator(device=dev).manual_seed(SEED + 401)
    eps = icnf_k.draw_eps(gen, B, dev)
    steer = {"steer_r": 0.05}
    for label, exact_trace in (("hepmass42 Hutchinson", False), ("hepmass42 exact", True)):
        extra = dict(steer) if exact_trace else dict(steer, eps=eps)
        fs.reset_launches()
        l_k, g_k, m_k = loss_grad(cnf, model(exact=exact_trace), ps_np, xs, dev, **extra)
        torch.cuda.synchronize()
        want = ({names["k7e"][0]: 1, fs.K4WA_KERNEL: 1} if exact_trace else {fs.K1W_KERNEL: 1, fs.K2W_KERNEL: 1})
        check(launched(fs) == want, f"{label}: the fused gradient launched {launched(fs)}, expected {want}")
        l_p, g_p, _ = loss_grad(cnf, model(fused=False, exact=exact_trace), ps_np, xs, dev, **extra)
        extra_t = dict(steer) if exact_trace else dict(steer, eps=eps.double())
        l_t, g_t, _ = loss_grad(cnf, model(fused=False, exact=exact_trace, dtype=torch.float64, solver=truth), ps_np,
                                xs, dev, torch.float64, **extra_t)
        torch.cuda.synchronize()
        hold_gradients(label, l_k, g_k, l_p, g_p, l_t, g_t)
        print(f"{label} B={B}: loss fused {float(l_k):.6f} plain {float(l_p):.6f} float64 {float(l_t):.6f}, "
              f"forward NFE {int(m_k['nfe'])}")
    models = (icnf_k, icnf_p, model(fused=False, dtype=torch.float64, solver=truth))
    n_test = test_gradient_path("hepmass42 TEST gradient", cnf, fs, models, ps_np, xs, dev,
                                {fs.K3W_KERNEL: 1, fs.K5W_KERNEL: 1})
    # One K = 4 call and one JVP call: the wide probe instances, once each.
    for k, jvp in ((4, False), (1, True)):
        icnf_pr = model(num_probes=k, ad="jvp" if jvp else "vjp")
        eps_k = icnf_pr.draw_eps(torch.Generator(device=dev).manual_seed(SEED + 402 + k), B, dev)
        fs.reset_launches()
        _, g, _ = loss_grad(cnf, icnf_pr, ps_np, xs, dev, eps=eps_k, **steer)
        torch.cuda.synchronize()
        counts = [w.probe_launches.get((k, jvp), 0) for w in (names["k1c"][1], names["k2c"][1])]
        check(set(launched(fs)) == {fs.K1W_KERNEL, fs.K2W_KERNEL} and counts == [1, 1]
              and all(bool(torch.isfinite(x).all()) for x in g),
              f"hepmass42 {probe_tag(k, jvp)}: launched {launched(fs)}, probe instances {counts}")
        print(f"phase 64: hepmass42 {probe_tag(k, jvp)} loss gradient: the wide probe instances launched {counts}")

    # Phase 65: the main paths, each with the counters reset just before it:
    # serving (logpdf, sample) through wide K3 alone; `fit` for four Lion
    # steps through the wide K1 and K2 chain forms; the exact `fit` through
    # wide K7 exact and the wide K4 adjoint.
    dist = cnf.ICNFDist(icnf_k, cnf.Mode.TEST, ps)
    fs.reset_launches()
    with torch.no_grad():
        lp = dist.logpdf(xs)
        samples = dist.sample(B, generator=torch.Generator(device=dev).manual_seed(SEED + 403))
    torch.cuda.synchronize()
    n_serve = launched(fs)
    check(n_serve == {fs.K3W_KERNEL: 2}, f"hepmass42 serving launched {n_serve}")
    check(bool(torch.isfinite(lp).all() and torch.isfinite(samples).all()), "hepmass42 serving output not finite")
    X = model_data("hepmass42", rng, N_STEPS * B)
    fit_path(cnf, fs, icnf_k, ps_np, dev, X, batch_size=B)
    n_fit = launched(fs)
    check(n_fit == {fs.K1W_KERNEL: N_STEPS, fs.K2W_KERNEL: N_STEPS}, f"hepmass42 fit launched {n_fit}")
    icnf_e = model(exact=True)
    fit_path(cnf, fs, icnf_e, ps_np, dev, X, batch_size=B)
    n_efit = launched(fs)
    check(n_efit == {names["k7e"][0]: N_STEPS, fs.K4WA_KERNEL: N_STEPS}, f"hepmass42 exact fit launched {n_efit}")
    print(f"phase 65: hepmass42 main paths: logpdf and sample launched {n_serve}, fit {n_fit}, exact fit {n_efit}")
    launches = {"k3w": n_serve[fs.K3W_KERNEL], "k5w": n_test[fs.K5W_KERNEL], "k1c": n_fit[fs.K1W_KERNEL],
                "k2c": n_fit[fs.K2W_KERNEL], "k7e": n_efit[names["k7e"][0]], "k4w": n_efit[fs.K4WA_KERNEL]}

    # Phase 66: the paths' timings.
    gen = torch.Generator(device=dev).manual_seed(SEED + 404)
    ms_step = step_ms(cnf, icnf_k, ps_np, xs, gen, dev, 3)
    ms_step_p = step_ms(cnf, icnf_p, ps_np, xs, gen, dev, 1, warmup=False)
    ms_estep = step_ms(cnf, icnf_e, ps_np, xs, gen, dev, 2)
    with torch.no_grad():
        _, _, st = cnf.inference(icnf_k, cnf.Mode.TEST, xs, ps)
        ms_lp = cuda_ms(lambda: dist.logpdf(xs), 3)
        ms_lp_p = cuda_ms(lambda: cnf.inference(icnf_p, cnf.Mode.TEST, xs, ps), 1, warmup=False)
    ms_tg = cuda_ms(lambda: test_loss_grad(cnf, icnf_k, ps_np, xs, dev), 3)
    print(f"phase 66: hepmass42 train step B={B} (loss, gradient, Lion): fused {ms_step:.4f} ms "
          f"({B / ms_step * 1e3:.1f} samples/s), plain {ms_step_p:.4f} ms ({B / ms_step_p * 1e3:.1f} samples/s)")
    print(f"phase 66: hepmass42 exact train step B={B}: {ms_estep:.4f} ms ({B / ms_estep * 1e3:.1f} samples/s)")
    print(f"phase 66: hepmass42 logpdf B={B}: kernel {ms_lp:.4f} ms ({B / ms_lp * 1e3:.1f} evals/s), plain "
          f"{ms_lp_p:.4f} ms; steps {int(st.steps)}, NFE {int(st.nfe)}; TEST loss gradient {ms_tg:.4f} ms")

    fma = dict(two_layer_fma(dz, H), **chain_fma(dims))
    fma = {"k3w": fma["k3"], "k5w": fma["k5"], "k4w": fma["k4a"], "k1c": fma["k1c"], "k2c": fma["k2c"],
           "k7e": fma["k7e"]}
    P = 2 * dz * H + H + dz
    Pt = P + dz * dz * H
    floats = {"k3w": P + 2 * B * (dz + 1), "k5w": 2 * P + B * (4 * dz + 3), "k4w": P + Pt + B * (4 * dz + 9),
              "k1c": P + B * (3 * dz + 6), "k2c": 2 * P + B * (5 * dz + 9), "k7e": P + B * (2 * dz + 6)}
    records = []
    for key, (out, err, ms, pms) in runs.items():
        name, _, _, src, at = names[key]
        records.append(kernel_record(f"{name}/hepmass42" if key in ("k1c", "k2c", "k7e") else name, src, at,
                                     launches[key], err, ms, pms, fma[key], B, steps_of(out)[0], floats[key],
                                     accepted=steps_of(out)[1]))
    return records


# ---- 2-layer nets past the wide limits: the README net family at the MINIBOONE width ----


def stream_two_layer_names(fs):
    """The miniboone86 path's kernels: record key -> (KERNEL_WRAPPERS name,
    wrapper, twin, source, the TPU site)."""
    at = "continuousnf_tpu/ops/fused_solve.py:"
    return {
        "k3s": (fs.K3S_KERNEL, fs.run_stream_test2_solve_kernel, fs.solve_test_plain, "k3_stream_solve.cu",
                at + "1043"),
        "k5s": (fs.K5S_KERNEL, fs.run_stream_test_adjoint_kernel, fs.adjoint_test_plain, "k5_stream_adjoint.cu",
                at + "1767"),
        "k1c": (fs.K1S_KERNEL, fs.run_stream_train_solve_kernel, fs.solve_train_plain, "k1_stream_solve.cu",
                at + "1043"),
        "k2c": (fs.K2S_KERNEL, fs.run_stream_adjoint_kernel, fs.adjoint_train_plain, "k2_stream_adjoint.cu",
                at + "1767"),
    }


def stream_two_layer_runs(label, fs, spec, test, train, cot, rng, dev, keys=("k3s", "k5s", "k1c", "k2c"), reps=3,
                          names=None, kws=None):
    """The path's kernels against their twins on one model's inputs (held as
    phases 16, 17 and 47 hold theirs), each timed: streamed K3 and the
    streamed K1 chain form from nonzero accumulators, streamed K5 from
    streamed K3's output and the streamed K2 chain form from the K1 chain
    form's, each warm-started from its forward's last step.  `names`: the
    kernels of the K3, K5, K1 and K2 roles under those keys
    (`stream_two_layer_names` unless given); `kws` receives each kernel's
    arguments."""
    import torch
    from continuousnf_tpu_torch.ode.tableaus import TSIT5

    names = names or stream_two_layer_names(fs)
    kws = {} if kws is None else kws
    B, dz = test["z0"].shape
    T = lambda a: torch.from_numpy(np.asarray(a, "float32")).to(dev)  # noqa: E731
    runs = {}

    def run(key, kw, adjoint=False):
        kws[key] = kw
        runs[key] = run_pair(f"{names[key][0]} ({label})", names[key][1], names[key][2], TSIT5, spec, kw,
                             adjoint=adjoint, reps=reps)

    for key, kw in (("k3s", test), ("k1c", train)):
        if key in keys:
            run(key, kw)
    if "k2c" in keys:
        run("k2c", adjoint_kw(train, runs["k1c"][0], cot), adjoint=True)
    if "k5s" in keys:
        k5_kw = dict(adjoint_kw(test, runs["k3s"][0], dict(azT=T(rng.normal(0.0, 1.0 / B, (B, dz))),
                                                           aaccT=T(np.full((1, B), 1.0 / B)), t_hi=test["t1"],
                                                           t_lo=test["t0"])), accT=runs["k3s"][0][1][None])
        k5_kw.pop("dlogp0")
        run("k5s", k5_kw, adjoint=True)
    return runs


def stream_two_layer_records(fs, suffix, dims, runs, launches, B):
    """The records of the path's kernels (`stream_two_layer_names`) at
    batch B, each name ending with `suffix`."""
    dz, H = dims[0], dims[1]
    fma = dict(two_layer_fma(dz, H), **chain_fma(dims))
    fma = {"k3s": fma["k3"], "k5s": fma["k5"], "k1c": fma["k1c"], "k2c": fma["k2c"]}
    P = 2 * dz * H + H + dz
    floats = {"k3s": P + 2 * B * (dz + 1), "k5s": 2 * P + B * (4 * dz + 3), "k1c": P + B * (3 * dz + 6),
              "k2c": 2 * P + B * (5 * dz + 9)}
    names = stream_two_layer_names(fs)
    records = []
    for key, (out, err, ms, pms) in runs.items():
        name, _, _, src, at = names[key]
        records.append(kernel_record(f"{name}/{suffix}", src, at, launches[key], err, ms, pms, fma[key], B,
                                     steps_of(out)[0], floats[key], accepted=steps_of(out)[1]))
    return records


def stream_two_layer(cnf, fs, dev):
    """Phases 79 to 86: the README net family MLP((n_in, 3 n_in, n_in)) past
    the wide 2-layer kernels' limits: miniboone86 (RNODE, nvars = naug =
    43, MLP 86 -> 258 -> 86 tanh, the flagship recipe, B = 4096) through
    streamed K3 and K5 (TEST) and the streamed K1 and K2 chain forms
    (Hutchinson TRAIN); bsds126 (MLP 126 -> 378 -> 126, B = 2048); and a
    2-layer net of dz 40 past hidden 128, MLP((40, 160, 40)), where streamed
    K3 replaces streamed K7 TEST.  Returns their records."""
    import torch
    from continuousnf_tpu_torch.ode.tableaus import TSIT5
    from continuousnf_tpu_torch.utils.configs import (MODELS, cuda_ms, glorot_params, make_icnf, model_data,
                                                      tabular_data)

    cfg = MODELS["miniboone86"]
    dims, B = cfg["dims"], BATCH
    dz, nv = dims[0], cfg["nvars"]
    rng = np.random.default_rng(SEED + 500)
    ps_np = glorot_params(rng, dims)
    xs = torch.from_numpy(model_data("miniboone86", rng, B)).to(dev)
    ps = cnf.params_from_numpy(ps_np, dev)
    model = lambda **kw: make_icnf("miniboone86", dev, **kw)  # noqa: E731
    icnf_k, icnf_p = model(), model(fused=False)
    spec = fs.chain_spec(icnf_k.nn, icnf_k.zdim)
    check(fs._stream_two_layer(spec) and fs._stream_two_layer_covers(TSIT5, spec) is None
          and fs._kernel_covers(TSIT5, spec, chain=True) is None,
          "the miniboone86 net should run streamed K3 and K5 and the streamed chain forms")
    names = stream_two_layer_names(fs)

    # Phase 79: the launch shapes at B = 4096.
    arr = (ctypes.c_int * 3)(*dims)
    for lib_name, fn in ((fs.K3S_KERNEL, "cnf_k3s_shape"), (fs.K5S_KERNEL, "cnf_k5s_shape"),
                         (fs.K1S_KERNEL, "cnf_k1s_shape"), (fs.K2S_KERNEL, "cnf_k2s_shape")):
        out = (ctypes.c_int * 5)()
        err = getattr(fs._library(lib_name), fn)(2, arr, B, out)
        check(err == 0 and out[1] >= 1, f"{fn}: cudaError {err}")
        print(f"phase 79: {fn} at widths {dims}, B={B}: {out[0]} threads a block, {out[1]} blocks, tile {out[2]}, "
              f"{out[3]} bytes of dynamic shared memory, {out[4]} floats of global tile scratch a block")

    # Phase 80: the four kernels against their twins, timed.
    test, train, _, cot = kernel_inputs(icnf_k, ps, xs, rng, dev)
    runs = stream_two_layer_runs("miniboone86", fs, spec, test, train, cot, rng, dev)
    print("phase 80: miniboone86 kernels held to their twins")

    # Phase 81: logpdf through streamed K3 against the plain path (at B = 16
    # the kernel took 24 attempted steps on an H100 where its twin and the
    # plain path took 23: that call's kernel is held to its twin, here under
    # the last-step rule).
    hold_logpdf(cnf, "miniboone86", icnf_k, icnf_p, xs, ps,
                kernel=(fs, "run_stream_test2_solve_kernel", fs.solve_test_plain))

    # Phase 82: the Hutchinson and TEST loss gradients and the score, counters
    # reset just before each fused call, against fused=False and a float64
    # rtol 1e-7 solve.
    truth = cnf.SolverOptions(rtol=1e-7, atol=1e-9)
    gen = torch.Generator(device=dev).manual_seed(SEED + 501)
    eps = icnf_k.draw_eps(gen, B, dev)
    steer = {"steer_r": 0.05}
    fs.reset_launches()
    l_k, g_k, m_k = loss_grad(cnf, icnf_k, ps_np, xs, dev, eps=eps, **steer)
    torch.cuda.synchronize()
    n_grad = launched(fs)
    check(n_grad == {fs.K1S_KERNEL: 1, fs.K2S_KERNEL: 1}, f"miniboone86 Hutchinson gradient launched {n_grad}")
    l_p, g_p, _ = loss_grad(cnf, icnf_p, ps_np, xs, dev, eps=eps, **steer)
    icnf_t = model(fused=False, dtype=torch.float64, solver=truth)
    l_t, g_t, _ = loss_grad(cnf, icnf_t, ps_np, xs, dev, torch.float64, eps=eps.double(), **steer)
    torch.cuda.synchronize()
    hold_gradients("miniboone86 Hutchinson", l_k, g_k, l_p, g_p, l_t, g_t)
    print(f"phase 82: miniboone86 Hutchinson B={B}: loss fused {float(l_k):.6f} plain {float(l_p):.6f} float64 "
          f"{float(l_t):.6f}, forward NFE {int(m_k['nfe'])}, launches {n_grad}")
    n_test = test_gradient_path("miniboone86 TEST gradient", cnf, fs, (icnf_k, icnf_p, icnf_t), ps_np, xs, dev,
                                {fs.K3S_KERNEL: 1, fs.K5S_KERNEL: 1})

    def score(icnf, dtype):
        p = tuple({k: v.to(dtype) for k, v in layer.items()} for layer in cnf.params_from_numpy(ps_np, dev))
        dist = cnf.ICNFDist(icnf, cnf.Mode.TEST, p)
        x = xs.to(dtype).requires_grad_()
        fs.reset_launches()
        (g_x,) = torch.autograd.grad(dist.logpdf(x).sum(), [x])
        torch.cuda.synchronize()
        return [g_x], launched(fs)

    g_sk, n_score = score(icnf_k, torch.float32)
    check(n_score == {fs.K3S_KERNEL: 1, fs.K5S_KERNEL: 1}, f"miniboone86 score launched {n_score}")
    hold_test_gradients("miniboone86 score", ["score (x)"], g_sk, score(icnf_p, torch.float32)[0],
                        score(icnf_t, torch.float64)[0])
    print(f"phase 82: miniboone86 score launched {n_score}")

    # Phase 83: the main paths, counters reset just before each: logpdf and
    # sample(4096) through streamed K3 alone; `fit` for four Lion steps
    # through the streamed K1 and K2 chain forms; the exact gradient raises
    # naming ROADMAP queue 2 row (e).
    dist = cnf.ICNFDist(icnf_k, cnf.Mode.TEST, ps)
    fs.reset_launches()
    with torch.no_grad():
        lp = dist.logpdf(xs)
        samples = dist.sample(B, generator=torch.Generator(device=dev).manual_seed(SEED + 502))
    torch.cuda.synchronize()
    n_serve = launched(fs)
    check(n_serve == {fs.K3S_KERNEL: 2}, f"miniboone86 serving launched {n_serve}")
    check(bool(torch.isfinite(lp).all() and torch.isfinite(samples).all()) and tuple(samples.shape) == (B, nv),
          "miniboone86 serving output not finite or of the wrong shape")
    fit_path(cnf, fs, icnf_k, ps_np, dev, model_data("miniboone86", rng, N_STEPS * B), batch_size=B)
    n_fit = launched(fs)
    check(set(n_fit) == {fs.K1S_KERNEL, fs.K2S_KERNEL} and min(n_fit.values()) >= N_STEPS,
          f"miniboone86 fit launched {n_fit}")
    # The exact gradient at B = 256 through streamed K7 exact and the
    # streamed K4 adjoint, against fused=False and a float64 rtol 1e-7 solve.
    nb = 256
    fs.reset_launches()
    l_k, g_k, _ = loss_grad(cnf, model(exact=True), ps_np, xs[:nb], dev, **steer)
    torch.cuda.synchronize()
    n_exact = launched(fs)
    check(n_exact == {fs.K7S_KERNEL + "/exact": 1, fs.K4SA_KERNEL: 1}, f"miniboone86 exact gradient launched {n_exact}")
    l_p, g_p, _ = loss_grad(cnf, model(exact=True, fused=False), ps_np, xs[:nb], dev, **steer)
    l_t, g_t, _ = loss_grad(cnf, model(exact=True, fused=False, dtype=torch.float64, solver=truth), ps_np, xs[:nb],
                            dev, torch.float64, **steer)
    torch.cuda.synchronize()
    hold_gradients(f"miniboone86 exact B={nb}", l_k, g_k, l_p, g_p, l_t, g_t)
    print(f"phase 83: miniboone86 main paths: logpdf and sample launched {n_serve}, fit {n_fit}, the exact gradient "
          f"at B={nb} {n_exact}")
    launches = {"k3s": n_serve[fs.K3S_KERNEL], "k5s": n_test[fs.K5S_KERNEL], "k1c": n_fit[fs.K1S_KERNEL],
                "k2c": n_fit[fs.K2S_KERNEL]}

    # Phase 84: the paths' times.
    gen = torch.Generator(device=dev).manual_seed(SEED + 503)
    ms_step = step_ms(cnf, icnf_k, ps_np, xs, gen, dev, 3)
    ms_step_p = step_ms(cnf, icnf_p, ps_np, xs, gen, dev, 1, warmup=False)
    with torch.no_grad():
        _, _, st = cnf.inference(icnf_k, cnf.Mode.TEST, xs, ps)
        ms_lp = cuda_ms(lambda: dist.logpdf(xs), 3)
        ms_lp_p = cuda_ms(lambda: cnf.inference(icnf_p, cnf.Mode.TEST, xs, ps), 1, warmup=False)
        ms_s = cuda_ms(lambda: dist.sample(B, generator=gen), 3)
    ms_tg = cuda_ms(lambda: test_loss_grad(cnf, icnf_k, ps_np, xs, dev), 3)
    print(f"phase 84: miniboone86 train step B={B} (loss, gradient, Lion): fused {ms_step:.4f} ms "
          f"({B / ms_step * 1e3:.1f} samples/s), plain {ms_step_p:.4f} ms ({B / ms_step_p * 1e3:.1f} samples/s)")
    print(f"phase 84: miniboone86 logpdf B={B}: kernel {ms_lp:.4f} ms ({B / ms_lp * 1e3:.1f} evals/s), plain "
          f"{ms_lp_p:.4f} ms; steps {int(st.steps)}, NFE {int(st.nfe)}; sample({B}) {ms_s:.4f} ms; TEST loss "
          f"gradient {ms_tg:.4f} ms")
    records = stream_two_layer_records(fs, "miniboone86", dims, runs, launches, B)

    # Phase 85: bsds126 at B = 2048: the four kernels against their twins,
    # logpdf against the plain path, and the launches of its Hutchinson and
    # TEST loss gradients.
    cfg = MODELS["bsds126"]
    dims_b, B_b = cfg["dims"], cfg["batch"]
    ps_np_b = glorot_params(rng, dims_b)
    xs_b = torch.from_numpy(model_data("bsds126", rng, B_b)).to(dev)
    ps_b = cnf.params_from_numpy(ps_np_b, dev)
    icnf_b = make_icnf("bsds126", dev)
    spec_b = fs.chain_spec(icnf_b.nn, icnf_b.zdim)
    test_b, train_b, _, cot_b = kernel_inputs(icnf_b, ps_b, xs_b, rng, dev)
    runs_b = stream_two_layer_runs("bsds126", fs, spec_b, test_b, train_b, cot_b, rng, dev, reps=1)
    hold_logpdf(cnf, "bsds126", icnf_b, make_icnf("bsds126", dev, fused=False), xs_b, ps_b,
                kernel=(fs, "run_stream_test2_solve_kernel", fs.solve_test_plain))
    fs.reset_launches()
    with torch.no_grad():
        lp_b = cnf.ICNFDist(icnf_b, cnf.Mode.TEST, ps_b).logpdf(xs_b)
    n_lp_b = launched(fs)
    fs.reset_launches()
    _, g_b, _ = loss_grad(cnf, icnf_b, ps_np_b, xs_b, dev, eps=icnf_b.draw_eps(gen, B_b, dev), **steer)
    torch.cuda.synchronize()
    n_grad_b = launched(fs)
    fs.reset_launches()
    _, g_tb = test_loss_grad(cnf, icnf_b, ps_np_b, xs_b, dev)
    torch.cuda.synchronize()
    n_test_b = launched(fs)
    check(n_lp_b == {fs.K3S_KERNEL: 1} and n_grad_b == {fs.K1S_KERNEL: 1, fs.K2S_KERNEL: 1}
          and n_test_b == {fs.K3S_KERNEL: 1, fs.K5S_KERNEL: 1}, f"bsds126 launched {n_lp_b}, {n_grad_b}, {n_test_b}")
    check(bool(torch.isfinite(lp_b).all()) and all(bool(torch.isfinite(x).all()) for x in list(g_b) + list(g_tb)),
          "bsds126 logpdf or gradients not finite")
    print(f"phase 85: bsds126 B={B_b}: logpdf launched {n_lp_b}, the Hutchinson gradient {n_grad_b}, the TEST "
          f"gradient {n_test_b}")
    records += stream_two_layer_records(fs, "bsds126", dims_b, runs_b,
                                        {"k3s": n_lp_b[fs.K3S_KERNEL], "k5s": n_test_b[fs.K5S_KERNEL],
                                         "k1c": n_grad_b[fs.K1S_KERNEL], "k2c": n_grad_b[fs.K2S_KERNEL]}, B_b)

    # Phase 86: a 2-layer net of dz 40 past hidden 128 at B = 4096: streamed
    # K3 and K5 against their twins, streamed K3 timed beside streamed K7
    # TEST (which ran it before) on the same input, and its TEST loss
    # gradient launching streamed K3 and K5 once each.
    dims_d = (40, 160, 40)
    ps_np_d = glorot_params(rng, dims_d)
    icnf_d = cnf.construct(cnf.RNODE, cnf.MLP(dims_d, device=dev), 20, 20, tspan=(0.0, 13.0), steer_rate=0.1,
                           lam3=1e-2, compute_mode=cnf.VecJacMode(fused=True))
    xs_d = torch.from_numpy(tabular_data(rng, B, 20)).to(dev)
    ps_d = cnf.params_from_numpy(ps_np_d, dev)
    spec_d = fs.chain_spec(icnf_d.nn, 40)
    test_d, _, _, cot_d = kernel_inputs(icnf_d, ps_d, xs_d, rng, dev)
    runs_d = stream_two_layer_runs("dz40", fs, spec_d, test_d, None, cot_d, rng, dev, keys=("k3s", "k5s"))
    out7, _, ms7, _ = run_pair(f"{fs.K7S_KERNEL}/test (dz40)", fs.run_stream_test_solve_kernel, fs.solve_test_plain,
                               TSIT5, spec_d, test_d)
    ms3, n3, n7 = runs_d["k3s"][2], int(runs_d["k3s"][0][2]), int(out7[2])
    print(f"phase 86: dz40 streamed K3 {ms3:.4f} ms ({n3} steps) vs streamed K7 TEST {ms7:.4f} ms ({n7} steps): "
          f"{ms7 / ms3:.2f}x, per attempted step {(ms7 / max(n7, 1)) / (ms3 / max(n3, 1)):.2f}x (FMA ratio dz / 3 = "
          f"{40 / 3:.2f})")
    fs.reset_launches()
    _, g_d = test_loss_grad(cnf, icnf_d, ps_np_d, xs_d, dev)
    torch.cuda.synchronize()
    n_d = launched(fs)
    check(n_d == {fs.K3S_KERNEL: 1, fs.K5S_KERNEL: 1} and all(bool(torch.isfinite(x).all()) for x in g_d),
          f"dz40 TEST gradient launched {n_d}")
    records += stream_two_layer_records(fs, "dz40", dims_d, runs_d,
                                        {"k3s": n_d[fs.K3S_KERNEL], "k5s": n_d[fs.K5S_KERNEL]}, B)
    return records


def k4s_record(fs, suffix, dims, out, err, ms, plain_ms, launches, B):
    """The streamed K4 adjoint's record at batch B (bound: the wide K4
    adjoint's FMA count, `two_layer_fma`'s "k4a", and its bytes)."""
    dz, H = dims[0], dims[1]
    P = 2 * dz * H + H + dz
    return kernel_record(f"{fs.K4SA_KERNEL}/{suffix}", "k4_stream_adjoint.cu", "continuousnf_tpu/ops/fused_solve.py:1767",
                         launches, err, ms, plain_ms, two_layer_fma(dz, H)["k4a"], B, steps_of(out)[0],
                         P + (P + dz * dz * H) + B * (4 * dz + 9), accepted=steps_of(out)[1])


def k4s_step_bound_us(dims, B, tab=None) -> float:
    """The FMA bound of one attempted step of the exact adjoint (S - 1 stage
    evaluations at `two_layer_fma`'s "k4a" a sample) in microseconds."""
    from continuousnf_tpu_torch.ode.tableaus import TSIT5

    tab = tab or TSIT5
    return 2.0 * two_layer_fma(dims[0], dims[1])["k4a"] * B * (tab.num_stages - 1) / F32_FLOPS * 1e6


def stream_exact(cnf, fs, dev):
    """Phases 87 to 90: exact training of the README net family past the wide
    limits, miniboone86 (B = 4096) and bsds126 (B = 2048), through streamed
    K7 exact forward and the streamed K4 adjoint backward; then the streamed
    K4 adjoint on hepmass42's inputs beside the wide K4 adjoint, which keeps
    that net.  Returns the streamed K4 adjoint's records."""
    import torch
    from continuousnf_tpu_torch.ode.tableaus import TSIT5
    from continuousnf_tpu_torch.utils.configs import MODELS, cuda_ms, glorot_params, make_icnf, model_data

    label_k = fs.K4SA_KERNEL
    lib = fs._library(label_k)
    steer = {"steer_r": 0.05}
    gen = torch.Generator(device=dev).manual_seed(SEED + 620)
    records, cases = [], {}
    for i, key in enumerate(("miniboone86", "bsds126")):
        cfg = MODELS[key]
        dims, B = cfg["dims"], cfg.get("batch", BATCH)
        rng = np.random.default_rng(SEED + 600 + i)
        ps_np = glorot_params(rng, dims)
        xs = torch.from_numpy(model_data(key, rng, B)).to(dev)
        ps = cnf.params_from_numpy(ps_np, dev)
        icnf = make_icnf(key, dev, exact=True)
        spec = fs.chain_spec(icnf.nn, icnf.zdim)
        check(fs._stream_exact_covers(TSIT5, spec) is None, f"the streamed K4 adjoint should take {key}")

        # Phase 87: the launch shape; streamed K7 exact against its twin from
        # nonzero accumulators, then the streamed K4 adjoint against its twin
        # from that output, warm-started from its last step: equal steps, the
        # state held to the float64 twin, gradients within GRAD_TOL; timed.
        arr = (ctypes.c_int * 3)(*dims)
        shape = (ctypes.c_int * 5)()
        err = lib.cnf_k4s_shape(2, arr, B, shape)
        check(err == 0 and shape[1] >= 1, f"cnf_k4s_shape: cudaError {err}")
        print(f"phase 87: cnf_k4s_shape at widths {dims}, B={B}: {shape[0]} threads a block, {shape[1]} blocks, tile "
              f"{shape[2]}, {shape[3]} bytes of dynamic shared memory, {shape[4]} floats of global tile scratch a "
              "block")
        _, _, exact, cot = kernel_inputs(icnf, ps, xs, rng, dev)
        fwd = run_pair(f"{fs.K7S_KERNEL}/exact ({key})", fs.run_stream_exact_solve_kernel, fs.solve_train_exact_plain,
                       TSIT5, spec, exact, reps=1)[0]
        kw = adjoint_kw(exact, fwd, cot)
        with torch.no_grad():
            out_k = fs.run_stream_exact_adjoint_kernel(TSIT5, spec, **kw)
            out_p, plain_ms = timed(lambda: fs.adjoint_train_exact_plain(TSIT5, spec, **kw))
            out_64 = fs.adjoint_train_exact_plain(TSIT5, spec, **{k: to64(v) for k, v in kw.items()})
        check([int(x) for x in steps_of(out_k)] == [int(x) for x in steps_of(out_p)],
              f"{label_k} ({key}) steps {steps_of(out_k)} vs its twin's {steps_of(out_p)}")
        err = hold_adjoint(f"{label_k} ({key})", out_k, out_p, out_64)
        with torch.no_grad():
            ms = cuda_ms(lambda: fs.run_stream_exact_adjoint_kernel(TSIT5, spec, **kw), 1, warmup=False)
        n = int(out_k[5])
        print(f"phase 87: {label_k} ({key}) B={B}: {ms:.4f} ms, plain version {plain_ms:.4f} ms ({n} steps, "
              f"{ms * 1e3 / max(n, 1):.1f} us per attempted step; the FMA bound {k4s_step_bound_us(dims, B):.1f} us)")
        cases[key] = (dims, B, ps_np, xs, out_k, err, ms, plain_ms)

    # Phase 88: the main paths, counters reset just before each: the exact
    # `fit` for four Lion steps at miniboone86 (B = 4096); the exact loss
    # gradient of bsds126 (B = 2048).
    dims, B, ps_np, xs, *_ = cases["miniboone86"]
    fit_path(cnf, fs, make_icnf("miniboone86", dev, exact=True), ps_np, dev,
             model_data("miniboone86", np.random.default_rng(SEED + 602), N_STEPS * B), batch_size=B)
    n_efit = launched(fs)
    check(set(n_efit) == {fs.K7S_KERNEL + "/exact", label_k} and min(n_efit.values()) >= N_STEPS,
          f"miniboone86 exact fit launched {n_efit}")
    dims_b, B_b, ps_np_b, xs_b, *_ = cases["bsds126"]
    fs.reset_launches()
    l_b, g_b, _ = loss_grad(cnf, make_icnf("bsds126", dev, exact=True), ps_np_b, xs_b, dev, **steer)
    torch.cuda.synchronize()
    n_grad_b = launched(fs)
    check(n_grad_b == {fs.K7S_KERNEL + "/exact": 1, label_k: 1}, f"bsds126 exact gradient launched {n_grad_b}")
    check(bool(torch.isfinite(l_b)) and all(bool(torch.isfinite(x).all()) for x in g_b),
          "bsds126 exact loss or gradient not finite")
    print(f"phase 88: miniboone86 exact fit ({N_STEPS} Lion steps at B={B}) launched {n_efit}; bsds126 exact loss "
          f"gradient at B={B_b} {n_grad_b}, loss {float(l_b):.6f}")
    launches = {"miniboone86": n_efit[label_k], "bsds126": n_grad_b[label_k]}

    # Phase 89: CUDA-event times of the exact train step (loss, gradient,
    # Lion) at both widths.
    for key in ("miniboone86", "bsds126"):
        dims, B, ps_np, xs, out_k, err, ms, plain_ms = cases[key]
        ms_step = step_ms(cnf, make_icnf(key, dev, exact=True), ps_np, xs, gen, dev, 2)
        print(f"phase 89: {key} exact train step B={B}: {ms_step:.4f} ms ({B / ms_step * 1e3:.1f} samples/s)")
        records.append(k4s_record(fs, key, dims, out_k, err, ms, plain_ms, launches[key], B))

    # Phase 90: the streamed K4 adjoint on hepmass42's inputs (B = 4096,
    # from wide K7 exact's output), through the wrapper's launcher (the
    # wrapper's rule keeps hepmass42 on the wide K4 adjoint), beside the wide
    # K4 adjoint on the same inputs: held to each other within the twin
    # bounds, each timed (a b b a).
    cfg = MODELS["hepmass42"]
    dims, B = cfg["dims"], BATCH
    rng = np.random.default_rng(SEED + 610)
    ps_np = glorot_params(rng, dims)
    xs = torch.from_numpy(model_data("hepmass42", rng, B)).to(dev)
    icnf = make_icnf("hepmass42", dev, exact=True)
    spec = fs.chain_spec(icnf.nn, icnf.zdim)
    check(fs._wide_two_layer_covers(TSIT5, spec) is None and fs._stream_exact_covers(TSIT5, spec) is not None,
          "hepmass42 should stay on the wide K4 adjoint")
    _, _, exact, cot = kernel_inputs(icnf, cnf.params_from_numpy(ps_np, dev), xs, rng, dev)
    with torch.no_grad():
        kw = adjoint_kw(exact, fs.run_wide_exact_solve_kernel(TSIT5, spec, **exact), cot)
        run_w = lambda: fs.run_wide_exact_adjoint_kernel(TSIT5, spec, **kw)  # noqa: E731
        run_s = lambda: fs._launch_stream_exact_adjoint(TSIT5, spec, **kw)  # noqa: E731
        out_w, out_s = run_w(), run_s()
        out_64 = fs.adjoint_train_exact_plain(TSIT5, spec, **{k: to64(v) for k, v in kw.items()})
    check([int(x) for x in steps_of(out_s)] == [int(x) for x in steps_of(out_w)],
          f"hepmass42: the streamed K4 adjoint's steps {steps_of(out_s)} vs the wide K4 adjoint's {steps_of(out_w)}")
    hold_adjoint(f"{label_k} vs {fs.K4WA_KERNEL} (hepmass42)", out_s, out_w, out_64)
    with torch.no_grad():
        ms_w, ms_s = paired_ms(run_w, run_s, 2)
    n = int(out_s[5])
    print(f"phase 90: hepmass42 B={B}, {n} attempted steps: the wide K4 adjoint {ms_w:.4f} ms "
          f"({ms_w * 1e3 / max(n, 1):.1f} us a step), the streamed K4 adjoint {ms_s:.4f} ms "
          f"({ms_s * 1e3 / max(n, 1):.1f} us a step); the FMA bound {k4s_step_bound_us(dims, B):.1f} us a step")
    return records


BF16_WITNESS = {"flagship": 2, "microbench": 4}  # phase 74: the twin's own runs, every input moved one ulp
BF16_ROW = "bf16 stage dots"  # ROADMAP queue 2's row that every bf16 refusal names


def bf16_fma(dz, H):
    """(stage-product FMA, elementwise and trace FMA) per sample and field
    evaluation of bf16 K3, K1 and K2, counted from the widths: the products
    (K3: z W1, h W2, dh M^T; K1: z W1, h W2 and the pullback's v1 W2^T,
    v0 W1^T; K2: those four, the four of the VJP, and the two weight
    gradients' four outer products), then the gates, the trace and the
    norms (K2: with the cotangents' gates and the bias sums)."""
    return {"k3b": (3 * dz * H, H + 2 * dz), "k1b": (4 * dz * H, 2 * H + 5 * dz),
            "k2b": (12 * dz * H, 7 * H + 11 * dz)}


def bf16_record(name, source, replaces, launches, err, ms, plain_ms, fma, B, steps, floats):
    """`kernel_record` with a bf16 kernel's bound: its stage products at
    BF16_FLOPS plus its elementwise FMA at F32_FLOPS over the field
    evaluations of the timed call (tsit5), or its bytes if larger."""
    from continuousnf_tpu_torch.ode.tableaus import TSIT5

    rec = kernel_record(name, source, replaces, launches, err, ms, plain_ms, 0, B, steps, floats)
    evals = 1 + (TSIT5.num_stages - 1) * int(steps)
    t_ops = 2.0 * B * evals * (fma[0] / BF16_FLOPS + fma[1] / F32_FLOPS) * 1e3
    t_bytes = 4.0 * floats / HBM_BYTES * 1e3
    rec.update(bound_ms=max(t_ops, t_bytes), bound_by="operations" if t_ops >= t_bytes else "bytes")
    return rec


def hmma_counts(path):
    """{kernel function: HMMA instructions} in a built library's SASS
    (cuobjdump beside nvcc)."""
    from pathlib import Path

    from continuousnf_tpu_torch.ops import _build

    tool = Path(_build._nvcc()).parent / "cuobjdump"
    out = subprocess.run([str(tool), "-sass", str(path)], capture_output=True, text=True, timeout=300, check=True)
    counts, fn = {}, None
    for line in out.stdout.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            counts[fn] = 0
        elif fn is not None and "HMMA" in line:
            counts[fn] += 1
    return counts


def hold_bf16(label, out_k, out_p, twin, spec, kw, n):
    """A bf16 kernel's output against its bf16 twin's under the bf16 rule
    (`near_tie.within_bf16_noise`), with the twin's own steps and spread
    over n runs whose every input moved one float32 ulp
    (`near_tie.roundoff_witness`).  Returns the largest absolute
    difference."""
    from continuousnf_tpu_torch.ode.tableaus import TSIT5
    from continuousnf_tpu_torch.utils import near_tie

    steps, spreads = near_tie.roundoff_witness(twin, TSIT5, spec, kw, ref=out_p, n=n)
    holds, line = near_tie.within_bf16_noise(out_k, out_p, spreads, TOL, GRAD_TOL, steps)
    print(f"{label} vs its bf16 twin: {line}")
    check(holds, f"{label} misses the bf16 rule: {line}")
    (_, vk), (_, vp) = near_tie.split(out_k), near_tie.split(out_p)
    return max(float((a - b).abs().max()) for a, b in zip(vk, vp))


@contextlib.contextmanager
def bf16_twins(fs):
    """While open, the bf16 wrappers run their twins on the card (the path
    through the twins, phase 76's reference)."""
    import functools

    saved = {n: getattr(fs, n) for n in ("run_bf16_train_solve_kernel", "run_bf16_adjoint_kernel")}
    fs.run_bf16_train_solve_kernel = functools.partial(fs.solve_train_plain, bf16=True)
    fs.run_bf16_adjoint_kernel = functools.partial(fs.adjoint_train_plain, bf16=True)
    try:
        yield
    finally:
        for n, w in saved.items():
            setattr(fs, n, w)


def bf16_paths(cnf, fs, dev):
    """Phases 73 to 78: bf16 stage matmuls on the flagship and microbench.
    Returns the records of bf16 K3, K1 and K2."""
    import functools

    import torch
    from continuousnf_tpu_torch.ops import _build
    from continuousnf_tpu_torch.ode.tableaus import TSIT5
    from continuousnf_tpu_torch.utils import near_tie
    from continuousnf_tpu_torch.utils.configs import MODELS, cuda_ms, glorot_params, make_icnf, model_data

    # Phase 73: build seconds, launch shapes, the tensor-core instructions.
    names = (fs.K3B_KERNEL, fs.K1B_KERNEL, fs.K2B_KERNEL)
    print("bf16 sources' nvcc seconds (in parallel with the others): "
          + ", ".join(f"{n} {_build.BUILD_SECONDS.get(n, float('nan')):.2f}" for n in names))
    dims = MODELS["flagship"]["dims"]
    dz, H = dims[0], dims[1]
    for n in names:
        lib, tag = fs._library(n), n[:2]
        cap = ctypes.c_int(0)
        err = getattr(lib, f"cnf_{tag}b_max_grid")(dz, H, 128, ctypes.byref(cap))
        print(f"{n} at dz={dz}, H={H}: 128 threads a block (a tile of 128 samples), co-resident grid {cap.value} "
              f"(cudaError {err}), {getattr(lib, f'cnf_{tag}b_smem_bytes')(dz, H, 128)} bytes of dynamic shared "
              f"memory; B = {BATCH}: {-(-BATCH // 128)} blocks")
    for n in names + (fs.K3_KERNEL, fs.K1_KERNEL, fs.K2_KERNEL):
        counts = hmma_counts(_build.build_library(n)[0])
        print(f"{n} SASS: " + ", ".join(f"{f[-40:]} {c} HMMA" for f, c in counts.items()))
        check(all((c > 0) == (n in names) for c in counts.values()), f"{n}: HMMA counts {counts}")

    # Phase 74: each kernel against its twin; the f32 kernel on the same input.
    rng = np.random.default_rng(SEED + 40)
    ps_np = glorot_params(rng, dims)
    ps = cnf.params_from_numpy(ps_np, dev)
    spec = fs.chain_spec(cnf.MLP(dims, device=dev), dz)
    trio = ((fs.run_bf16_solve_kernel, fs.solve_test_plain, fs.run_solve_kernel),
            (fs.run_bf16_train_solve_kernel, fs.solve_train_plain, fs.run_train_solve_kernel),
            (fs.run_bf16_adjoint_kernel, fs.adjoint_train_plain, fs.run_adjoint_kernel))
    kinds = ("bf16 K3", "bf16 K1", "bf16 K2")
    rows = {}
    for model in ("flagship", "microbench"):
        B = BATCH
        icnf = make_icnf(model, dev, bf16=True)
        xs = torch.from_numpy(model_data(model, rng, B)).to(dev)
        test, train, _, cot = kernel_inputs(icnf, ps, xs, rng, dev)
        outs = []
        for kind, (kernel, twin, f32), kw in zip(kinds, trio, (test, train, None)):
            if kw is None:
                kw = adjoint_kw(train, outs[1], cot)
            twin = functools.partial(twin, bf16=True)
            with torch.no_grad():
                out_k = kernel(TSIT5, spec, **kw)
                out_p, plain_ms = timed(lambda: twin(TSIT5, spec, **kw))
                out_f = f32(TSIT5, spec, **kw)
            torch.cuda.synchronize()
            label = f"{kind} ({model}, B = {B})"
            err = hold_bf16(label, out_k, out_p, twin, spec, kw, BF16_WITNESS[model])
            (s_k, v_k), (s_f, v_f) = near_tie.split(out_k), near_tie.split(out_f)
            apart = max(near_tie.rel(a, b) for a, b in zip(v_k, v_f))
            print(f"{label}: the f32 kernel on the same input {s_f} steps, the bf16 one {s_k}; largest relative "
                  f"distance {apart:.3e}")
            check(s_k != s_f or apart > TOL, f"{label}: the bf16 and f32 solves of one input agree")
            outs.append(out_k)
            with torch.no_grad():
                ms_f, ms_k = paired_ms(lambda: f32(TSIT5, spec, **kw), lambda: kernel(TSIT5, spec, **kw), 3)
            rows[(kind, model)] = dict(err=err, ms=ms_k, steps=s_k, plain_ms=plain_ms, ms_f=ms_f, steps_f=s_f)
            print(f"{label} alone: {ms_k:.4f} ms, {s_k} attempted steps, {ms_k * 1e3 / s_k:.1f} us a step; f32 "
                  f"{ms_f:.4f} ms, {s_f} steps, {ms_f * 1e3 / s_f:.1f} us a step; plain version {plain_ms:.4f} ms")

    # Phase 75: serving under bf16.
    icnf_b = make_icnf("flagship", dev, bf16=True)
    xs = torch.from_numpy(model_data("flagship", rng, BATCH)).to(dev)
    dist = cnf.ICNFDist(icnf_b, cnf.Mode.TEST, ps)
    gen = torch.Generator(device=dev).manual_seed(SEED + 41)
    fs.reset_launches()
    with torch.no_grad():
        lp = dist.logpdf(xs)
        samples = dist.sample(BATCH, generator=gen)
    torch.cuda.synchronize()
    serving_launches = launched(fs)
    check(serving_launches == {fs.K3B_KERNEL: 2}, f"bf16 serving launched {serving_launches}")
    check(bool(torch.isfinite(lp).all()) and bool(torch.isfinite(samples).all()) and
          tuple(samples.shape) == (BATCH, icnf_b.nvars), "bf16 serving: values not finite")
    print(f"bf16 serving: logpdf mean {float(lp.mean()):.4f}, launches {serving_launches}")

    # Phase 76: the loss gradient against the path through the twins, and fit.
    eps_s = icnf_b.draw_eps(gen, BATCH, dev)
    kw = dict(eps=eps_s, steer_r=0.05)
    fs.reset_launches()
    l_k, g_k, m_k = loss_grad(cnf, icnf_b, ps_np, xs, dev, **kw)
    grad_launches = launched(fs)
    check(grad_launches == {fs.K1B_KERNEL: 1, fs.K2B_KERNEL: 1}, f"the bf16 gradient launched {grad_launches}")
    spread = [0.0] * len(g_k)
    with bf16_twins(fs):
        l_p, g_p, _ = loss_grad(cnf, icnf_b, ps_np, xs, dev, **kw)
        for seed in range(1):
            nudge_gen = torch.Generator().manual_seed(seed)
            ps_n = tuple({k: near_tie.nudge(torch.from_numpy(v), nudge_gen).numpy() for k, v in layer.items()}
                         for layer in ps_np)
            _, g_n, _ = loss_grad(cnf, icnf_b, ps_n, near_tie.nudge(xs, nudge_gen), dev, **kw)
            spread = [max(d, float((a - b).abs().max()) / float(b.abs().max())) for d, a, b in zip(spread, g_n, g_p)]
    icnf_t = make_icnf("flagship", dev, fused=False, dtype=torch.float64, solver=cnf.SolverOptions(rtol=1e-7, atol=1e-9))
    _, g_t, _ = loss_grad(cnf, icnf_t, ps_np, xs, dev, torch.float64, eps=eps_s.double(), steer_r=0.05)
    _, g_f, _ = loss_grad(cnf, make_icnf("flagship", dev), ps_np, xs, dev, **kw)
    torch.cuda.synchronize()
    for name, a, b, t, f, d in zip(("w1", "b1", "w2", "b2"), g_k, g_p, g_t, g_f, spread):
        scale = float(b.abs().max())
        e = float((a - b).abs().max()) / scale
        print(f"bf16 g_{name}: kernels vs twins {e:.3e} of max|g| (the twins' own move {d:.3e}); distance to the "
              f"float64 f32-field solve: bf16 {float((a.double() - t).abs().max()) / scale:.3e}, f32 kernels "
              f"{float((f.double() - t).abs().max()) / scale:.3e}")
        check(bool(torch.isfinite(a).all()) and e <= max(SOLVE_REL, 4.0 * d), f"bf16 g_{name}: {e} vs its spread {d}")
    print(f"bf16 loss {float(l_k):.6f} (through the twins {float(l_p):.6f}), forward NFE {int(m_k['nfe'])}")
    res = fit_path(cnf, fs, icnf_b, ps_np, dev, model_data("flagship", np.random.default_rng(SEED + 42),
                                                             N_STEPS * BATCH), batch_size=BATCH)
    fit_launches = launched(fs)
    check(set(fit_launches) == {fs.K1B_KERNEL, fs.K2B_KERNEL} and min(fit_launches.values()) >= N_STEPS,
          f"bf16 fit launched {fit_launches}")
    print(f"bf16 training path: fit {N_STEPS} Lion steps, epoch loss {float(res.losses[0]):.6f}, launches "
          f"{fit_launches}")

    # Phase 77: what the bf16 kernels do not cover raises on the card.
    def refused(label, fn):
        fs.reset_launches()
        try:
            fn()
        except NotImplementedError as exc:
            check(BF16_ROW in str(exc), f"{label}: the refusal does not name the bf16 row: {exc}")
            others = {k: v for k, v in launched(fs).items() if k != fs.K3B_KERNEL}
            check(not others, f"{label}: launched {others} before refusing")
            print(f"bf16 refusal, {label}: {exc}")
            return
        check(False, f"{label}: not refused on the card")

    small = lambda name, n=256: torch.from_numpy(model_data(name, rng, n)).to(dev)  # noqa: E731
    p6 = glorot_params(rng, MODELS["power6"]["dims"])
    h42 = glorot_params(rng, MODELS["hepmass42"]["dims"])
    refused("a 3-layer chain (power6)", lambda: loss_grad(cnf, make_icnf("power6", dev, bf16=True), p6,
                                                          small("power6"), dev))
    refused("two VJP probes", lambda: loss_grad(cnf, make_icnf("flagship", dev, bf16=True, num_probes=2), ps_np,
                                                xs, dev))
    refused("a JVP probe", lambda: loss_grad(cnf, make_icnf("flagship", dev, bf16=True, ad="jvp"), ps_np, xs, dev))
    refused("state width 42 (hepmass42)", lambda: loss_grad(cnf, make_icnf("hepmass42", dev, bf16=True), h42,
                                                             small("hepmass42"), dev))
    refused("exact trace", lambda: loss_grad(cnf, make_icnf("flagship", dev, bf16=True, exact=True), ps_np, xs, dev))
    cond = cnf.construct(cnf.CondRNODE, cnf.MLP(COND_TWO_LAYER, device=dev), 8, 8, tspan=(0.0, 13.0),
                         compute_mode=cnf.VecJacMode(fused=True, bf16=True))
    refused("a conditional net", lambda: cnf.inference(cond, cnf.Mode.TEST, xs[:256], cnf.params_from_numpy(
        glorot_params(rng, COND_TWO_LAYER), dev), ys=torch.zeros(256, 1, device=dev)))
    leaves = [x.detach().requires_grad_() for layer in ps for x in (layer["w"], layer["b"])]
    p_req = tuple({"w": w, "b": b} for w, b in zip(leaves[::2], leaves[1::2]))
    refused("the TEST gradient (K5)", lambda: torch.autograd.grad(cnf.loss(icnf_b, cnf.Mode.TEST, xs, p_req), leaves))

    # Phase 78: timings of the paths, and kernel_microbench's quantities.
    micro = {}
    for tag, bf16 in (("f32", False), ("bf16", True)):
        icnf = make_icnf("microbench", dev, bf16=bf16)
        xm = torch.from_numpy(model_data("microbench", np.random.default_rng(SEED + 43), BATCH)).to(dev)
        g = torch.Generator(device=dev).manual_seed(SEED)
        with torch.no_grad():
            _, _, st = cnf.inference(icnf, cnf.Mode.TRAIN, xm, ps, generator=g)
            ms = cuda_ms(lambda: cnf.inference(icnf, cnf.Mode.TRAIN, xm, ps, generator=g), 5)
            micro[f"train_fwd_nfe_us_{tag}"] = ms * 1e3 / int(st.nfe)
            micro[f"train_fwd_nfe_{tag}"] = int(st.nfe)
            _, _, st = cnf.inference(icnf, cnf.Mode.TEST, xm, ps)
            ms = cuda_ms(lambda: cnf.inference(icnf, cnf.Mode.TEST, xm, ps), 5)
            micro[f"test_nfe_us_{tag}"] = ms * 1e3 / int(st.nfe)
            micro[f"test_nfe_{tag}"] = int(st.nfe)
        micro[f"grad_step_us_{tag}"] = 1e3 * cuda_ms(
            lambda: loss_grad(cnf, icnf, ps_np, xm, dev, generator=g), 3)
    print("kernel_microbench's quantities (the port, B = 4096): " + json.dumps(micro))
    with torch.no_grad():
        ms_lp = cuda_ms(lambda: dist.logpdf(xs), 3)
        ms_s = cuda_ms(lambda: dist.sample(BATCH, generator=gen), 3)
    ms_step = step_ms(cnf, icnf_b, ps_np, xs, gen, dev, 3)
    print(f"flagship bf16 B={BATCH}: train step {ms_step:.4f} ms ({BATCH / ms_step * 1e3:.1f} samples/s), logpdf "
          f"{ms_lp:.4f} ms, sample {ms_s:.4f} ms")

    fma = bf16_fma(dz, H)
    P = 2 * dz * H + H + dz
    launches = {fs.K3B_KERNEL: serving_launches[fs.K3B_KERNEL], fs.K1B_KERNEL: fit_launches[fs.K1B_KERNEL],
                fs.K2B_KERNEL: fit_launches[fs.K2B_KERNEL]}
    records = []
    for n, kind, src, site, tag, floats in (
            (fs.K3B_KERNEL, "bf16 K3", "k3_bf16_solve.cu", "continuousnf_tpu/ops/fused_solve.py:1043", "k3b",
             2 * dz * H + H + dz + 2 * BATCH * (dz + 1)),
            (fs.K1B_KERNEL, "bf16 K1", "k1_bf16_solve.cu", "continuousnf_tpu/ops/fused_solve.py:1043", "k1b",
             P + BATCH * (3 * dz + 6)),
            (fs.K2B_KERNEL, "bf16 K2", "k2_bf16_adjoint.cu", "continuousnf_tpu/ops/fused_solve.py:1767", "k2b",
             2 * P + BATCH * (5 * dz + 9))):
        for model in ("flagship", "microbench"):
            r = rows[(kind, model)]
            rec = bf16_record(n if model == "flagship" else f"{n}/microbench", src, site, launches[n], r["err"],
                              r["ms"], r["plain_ms"], fma[tag], BATCH, r["steps"], floats)
            print(f"{kind} ({model}): {r['ms']:.4f} ms, {r['steps']} steps, {r['ms'] * 1e3 / r['steps']:.1f} us a "
                  f"step (f32 {r['ms_f'] * 1e3 / r['steps_f']:.1f}); bound {rec['bound_ms']:.4f} ms "
                  f"({rec['bound_by']}); plain {r['plain_ms']:.4f} ms; launches {launches[n]}")
            records.append(rec)
    return records


# ---- K8 in the wide forms: conditional nets past the narrow widths ----

COND_CHAIN_DIMS = (44, 128, 128, 43)  # phase 99: a conditional 3-layer chain past hidden 64, one ys column
COND_CHAIN_BATCH = 2048
COND_TRUTH_BATCH = 256  # phase 100's float64 rtol 1e-7 solves


def cond_wide_names(fs):
    """The cond_hepmass42 path's kernels: record key -> (KERNEL_WRAPPERS
    name, wrapper, twin, source, the TPU site)."""
    at = "continuousnf_tpu/ops/fused_solve.py:"
    return {
        "k3wc": (fs.K3W_KERNEL + "/cond", fs.run_wide_cond_test2_solve_kernel, fs.solve_test_plain,
                 "k3_wide_solve.cu", at + "1043"),
        "k5wc": (fs.K5W_KERNEL + "/cond", fs.run_wide_cond_test_adjoint_kernel, fs.adjoint_test_plain,
                 "k5_wide_adjoint.cu", at + "1767"),
        "k1wc": (fs.K1W_KERNEL + "/cond", fs.run_wide_cond_train_solve_kernel, fs.solve_train_plain,
                 "k1_wide_solve.cu", at + "1043"),
        "k2wc": (fs.K2W_KERNEL + "/cond", fs.run_wide_cond_adjoint_kernel, fs.adjoint_train_plain,
                 "k2_wide_adjoint.cu", at + "1767"),
    }


def cond_fma_floats(dims, nc, B):
    """FMA per sample and field evaluation and the floats read and written of
    the COND instances at `dims` (the input width dz + nc first): the
    unconditional counts with the first layer's ys rows (the forward's
    nc H1, the ys gradient's nc H1) and the ys values, k_ays and a_ys0."""
    dz, H = dims[-1], dims[1]
    P = sum(a * b + b for a, b in zip(dims[:-1], dims[1:]))
    chain = chain_fma(dims, nc)
    fma = {"k1wc": chain["k1c"], "k2wc": chain["k2c"]}
    floats = {"k1wc": P + B * (3 * dz + 6 + nc), "k2wc": 2 * P + B * (5 * dz + 9 + 2 * nc)}
    if len(dims) == 3:
        fma.update(k3wc=3 * dz * H + nc * H, k5wc=k5_fma(dz, H, nc))
        floats.update(k3wc=P + B * (2 * dz + 2 + nc), k5wc=2 * P + B * (4 * dz + 3 + 2 * nc))
    return fma, floats


def refuses(fs, label, why, fn, phase=101) -> None:
    """`fn()` raises NotImplementedError naming `why` on the card and
    launches nothing (the counters reset just before it); printed under
    `phase`."""
    import torch

    fs.reset_launches()
    try:
        fn()
    except NotImplementedError as e:
        torch.cuda.synchronize()
        check(why in str(e) and not launched(fs), f"{label}: raised {e!r}, launched {launched(fs)}")
        print(f"phase {phase}: {label} raises on the card: {str(e)[:160]}")
        return
    check(False, f"{label} ran on the card; it should raise naming {why!r}")


def cond_wide(cnf, fs, dev):
    """Phases 97 to 102: CondRNODE at the HEPMASS width (cond_hepmass42,
    MLP 43 -> 126 -> 42 on [z | ys]) through the COND instances of wide K3,
    wide K5 and the wide K1 and K2 chain forms (K8 in the wide forms), and
    the chain forms' on a conditional 3-layer chain.  Returns their
    records."""
    import torch
    from continuousnf_tpu_torch.ode.tableaus import TSIT5
    from continuousnf_tpu_torch.utils.configs import MODELS, cuda_ms, glorot_params, make_icnf, model_data

    cfg = MODELS["cond_hepmass42"]
    dims, nc, B = cfg["dims"], cfg["n_cond"], BATCH
    dz = dims[-1]
    rng = np.random.default_rng(SEED + 900)
    ps_np = glorot_params(rng, dims)
    xs_np, ys_np = model_data("cond_hepmass42", rng, B)
    xs, ys = torch.from_numpy(xs_np).to(dev), torch.from_numpy(ys_np).to(dev)
    ps = cnf.params_from_numpy(ps_np, dev)
    model = lambda **kw: make_icnf("cond_hepmass42", dev, **kw)  # noqa: E731
    icnf_k, icnf_p = model(), model(fused=False)
    spec = fs.chain_spec(icnf_k.nn, icnf_k.zdim)
    check(spec.n_cond == nc and fs._wide_two_layer(spec) and fs._wide_two_layer_covers(TSIT5, spec) is None
          and fs._kernel_covers(TSIT5, spec, chain=True) is None,
          "cond_hepmass42 should run the COND instances of the wide forms")
    names = cond_wide_names(fs)
    T = lambda a: torch.from_numpy(np.asarray(a, "float32")).to(dev)  # noqa: E731

    # Phase 97: the COND instances' launch shapes at B = 4096.
    arr = (ctypes.c_int * 3)(*dims)
    for lib_name, fn in ((fs.K3W_KERNEL, "cnf_k3wc_shape"), (fs.K5W_KERNEL, "cnf_k5wc_shape"),
                         (fs.K1W_KERNEL, "cnf_k1wc_shape"), (fs.K2W_KERNEL, "cnf_k2wc_shape")):
        out = (ctypes.c_int * 4)()
        err = getattr(fs._library(lib_name), fn)(2, arr, B, out)
        check(err == 0 and out[1] >= 1, f"{fn}: cudaError {err}")
        print(f"phase 97: {fn} at widths {dims}, B={B}: {out[0]} threads a block, {out[1]} blocks, tile {out[2]}, "
              f"{out[3]} bytes of dynamic shared memory")

    # Phase 98: each COND instance against its twin, timed.
    test, train, _, cot = kernel_inputs(icnf_k, ps, xs, rng, dev)
    test["ys"], train["ys"] = ys, ys
    runs = {}
    for key, kw in (("k3wc", test), ("k1wc", train)):
        runs[key] = run_pair(f"{names[key][0]} (cond_hepmass42)", names[key][1], names[key][2], TSIT5, spec, kw)
    runs["k2wc"] = run_pair(f"{names['k2wc'][0]} (cond_hepmass42)", names["k2wc"][1], names["k2wc"][2], TSIT5, spec,
                            adjoint_kw(train, runs["k1wc"][0], cot), adjoint=True)
    k5_kw = dict(adjoint_kw(test, runs["k3wc"][0], dict(azT=T(rng.normal(0.0, 1.0 / B, (B, dz))),
                                                        aaccT=T(np.full((1, B), 1.0 / B)), t_hi=test["t1"],
                                                        t_lo=test["t0"])), accT=runs["k3wc"][0][1][None])
    k5_kw.pop("dlogp0")
    runs["k5wc"] = run_pair(f"{names['k5wc'][0]} (cond_hepmass42)", names["k5wc"][1], names["k5wc"][2], TSIT5, spec,
                            k5_kw, adjoint=True)
    for key in ("k2wc", "k5wc"):
        out = runs[key][0]
        check(len(out) == 8 and tuple(out[7].shape) == (B, nc) and float(out[3][0][dz:].abs().max()) > 0.0,
              f"{names[key][0]} returned no a_ys0 or a zero gradient for W1's ys rows")
    print("phase 98: cond_hepmass42 COND instances held to their twins")

    # Phase 99: the chain forms' COND instances on a conditional 3-layer chain.
    Bc = COND_CHAIN_BATCH
    ps_c = glorot_params(rng, COND_CHAIN_DIMS)
    xs_c = torch.from_numpy(model_data("miniboone43", rng, Bc)).to(dev)
    ys_c = T(rng.uniform(-1.0, 1.0, (Bc, 1)))
    icnf_c = cnf.construct(cnf.CondRNODE, cnf.MLP(COND_CHAIN_DIMS, device=dev), 43, 0, tspan=(0.0, 1.0),
                           compute_mode=cnf.VecJacMode(fused=True))
    spec_c = fs.chain_spec(icnf_c.nn, icnf_c.zdim)
    check(fs._wide_chain(spec_c) and fs._kernel_covers(TSIT5, spec_c, chain=True) is None,
          "the conditional 3-layer chain should run the wide chain forms' COND instances")
    _, train_c, _, cot_c = kernel_inputs(icnf_c, cnf.params_from_numpy(ps_c, dev), xs_c, rng, dev)
    train_c["ys"] = ys_c
    runs_c = {"k1wc": run_pair(f"{names['k1wc'][0]} (3-layer, B={Bc})", names["k1wc"][1], names["k1wc"][2], TSIT5,
                               spec_c, train_c, reps=3)}
    runs_c["k2wc"] = run_pair(f"{names['k2wc'][0]} (3-layer, B={Bc})", names["k2wc"][1], names["k2wc"][2], TSIT5,
                              spec_c, adjoint_kw(train_c, runs_c["k1wc"][0], cot_c), adjoint=True, reps=3)
    eps_c = icnf_c.draw_eps(torch.Generator(device=dev).manual_seed(SEED + 901), Bc, dev)
    fs.reset_launches()
    _, g_c, _ = loss_grad(cnf, icnf_c, ps_c, xs_c, dev, ys=ys_c, eps=eps_c)
    torch.cuda.synchronize()
    n_c = launched(fs)
    check(n_c == {names["k1wc"][0]: 1, names["k2wc"][0]: 1} and all(bool(torch.isfinite(g).all()) for g in g_c),
          f"the 3-layer conditional train step launched {n_c}")
    print(f"phase 99: the 3-layer conditional chain's train step launched {n_c}")

    # Phase 100: the train step's and the TEST loss's gradients at B = 256
    # against the plain path and a float64 rtol 1e-7 solve.
    b = COND_TRUTH_BATCH
    truth = cnf.SolverOptions(rtol=1e-7, atol=1e-9)
    eps = icnf_k.draw_eps(torch.Generator(device=dev).manual_seed(SEED + 902), b, dev)
    steer = {"steer_r": 0.05}
    fs.reset_launches()
    l_k, g_k, _ = loss_grad(cnf, icnf_k, ps_np, xs[:b], dev, ys=ys[:b], eps=eps, **steer)
    torch.cuda.synchronize()
    want = {names["k1wc"][0]: 1, names["k2wc"][0]: 1}
    check(launched(fs) == want, f"cond_hepmass42 train gradient launched {launched(fs)}, expected {want}")
    l_p, g_p, _ = loss_grad(cnf, icnf_p, ps_np, xs[:b], dev, ys=ys[:b], eps=eps, **steer)
    l_t, g_t, _ = loss_grad(cnf, model(fused=False, dtype=torch.float64, solver=truth), ps_np, xs[:b], dev,
                            torch.float64, ys=ys[:b], eps=eps.double(), **steer)
    torch.cuda.synchronize()
    hold_gradients(f"cond_hepmass42 Hutchinson B={b}", l_k, g_k, l_p, g_p, l_t, g_t,
                   names=["w1", "b1", "w2", "b2", "ys"])
    models = (icnf_k, icnf_p, model(fused=False, dtype=torch.float64, solver=truth))
    test_gradient_path(f"cond_hepmass42 TEST gradient B={b}", cnf, fs, models, ps_np, xs[:b], dev,
                       {names["k3wc"][0]: 1, names["k5wc"][0]: 1}, ys=ys[:b])
    print("phase 100: cond_hepmass42 gradients held to the float64 solve")

    # Phase 101: the main paths, counters reset just before each.
    dist = cnf.CondICNFDist(icnf_k, cnf.Mode.TEST, ps, ys)
    n_serve = {}
    for what, call in (("logpdf", lambda: dist.logpdf(xs)),
                       ("sample", lambda: dist.sample(B, generator=torch.Generator(device=dev).manual_seed(SEED + 903)))):
        fs.reset_launches()
        with torch.no_grad():
            out = call()
        torch.cuda.synchronize()
        n = launched(fs)
        check(n == {names["k3wc"][0]: 1} and bool(torch.isfinite(out).all()), f"cond_hepmass42 {what} launched {n}")
        n_serve[what] = n[names["k3wc"][0]]
    fs.reset_launches()
    _, g_tk = test_loss_grad(cnf, icnf_k, ps_np, xs, dev, ys=ys)
    torch.cuda.synchronize()
    n_test = launched(fs)
    check(n_test == {names["k3wc"][0]: 1, names["k5wc"][0]: 1} and all(bool(torch.isfinite(g).all()) for g in g_tk),
          f"cond_hepmass42 TEST loss gradient launched {n_test}")
    eps_b = icnf_k.draw_eps(torch.Generator(device=dev).manual_seed(SEED + 904), B, dev)
    fs.reset_launches()
    _, g_b, _ = loss_grad(cnf, icnf_k, ps_np, xs, dev, ys=ys, eps=eps_b, **steer)
    torch.cuda.synchronize()
    n_step = launched(fs)
    check(n_step == want and all(bool(torch.isfinite(g).all()) for g in g_b),
          f"cond_hepmass42 train step gradient launched {n_step}")
    X, Y = model_data("cond_hepmass42", rng, N_STEPS * B)
    fit_path(cnf, fs, icnf_k, ps_np, dev, X, Y, batch_size=B)
    n_fit = launched(fs)
    check(set(n_fit) == set(want) and min(n_fit.values()) >= N_STEPS, f"cond_hepmass42 fit launched {n_fit}")
    print(f"phase 101: cond_hepmass42 main paths: logpdf {n_serve['logpdf']} and sample {n_serve['sample']} "
          f"launches of {names['k3wc'][0]}, TEST loss gradient {n_test}, train step {n_step}, fit {n_fit}")
    # A conditional net past the wide limits, refused here until the
    # streamed forms' COND instances (phases 113-117), trains through them.
    small = slice(0, COND_TRUTH_BATCH)
    fs.reset_launches()
    _, g_past, _ = loss_grad(cnf, cnf.construct(cnf.CondRNODE, cnf.MLP((87, 258, 86), device=dev), 43, 43,
                                                tspan=(0.0, 1.0), compute_mode=cnf.VecJacMode(fused=True)),
                             glorot_params(np.random.default_rng(SEED + 905), (87, 258, 86)), xs_c[small, :43], dev,
                             ys=ys[small])
    torch.cuda.synchronize()
    n_past = launched(fs)
    check(n_past == {fs.K1S_KERNEL + "/cond": 1, fs.K2S_KERNEL + "/cond": 1}
          and all(bool(torch.isfinite(g).all()) for g in g_past),
          f"a conditional net past the wide limits (MLP 87 -> 258 -> 86) launched {n_past}")
    print(f"phase 101: a conditional net past the wide limits (MLP 87 -> 258 -> 86) trains on the card: {n_past}")

    # Phase 102: CUDA-event times beside hepmass42's, in the same run.
    gen = torch.Generator(device=dev).manual_seed(SEED + 906)
    hep = MODELS["hepmass42"]["dims"]
    rng_h = np.random.default_rng(SEED + 400)
    ps_h = glorot_params(rng_h, hep)
    xs_h = torch.from_numpy(model_data("hepmass42", rng_h, B)).to(dev)
    icnf_h = make_icnf("hepmass42", dev)
    dist_h = cnf.ICNFDist(icnf_h, cnf.Mode.TEST, cnf.params_from_numpy(ps_h, dev))
    rows = []
    for label, icnf, p_np, x, y, d in (("cond_hepmass42", icnf_k, ps_np, xs, ys, dist),
                                       ("hepmass42", icnf_h, ps_h, xs_h, None, dist_h)):
        ms_step = step_ms(cnf, icnf, p_np, x, gen, dev, 3, ys=y)
        with torch.no_grad():
            _, _, st = cnf.inference(icnf, cnf.Mode.TEST, x, cnf.params_from_numpy(p_np, dev),
                                     **({} if y is None else {"ys": y}))
            ms_lp = cuda_ms(lambda: d.logpdf(x), 3)
        ms_tg = cuda_ms(lambda: test_loss_grad(cnf, icnf, p_np, x, dev, ys=y), 3)
        rows.append((label, ms_step, ms_lp, ms_tg, int(st.steps)))
        print(f"phase 102: {label} B={B}: train step {ms_step:.4f} ms ({B / ms_step * 1e3:.1f} samples/s), logpdf "
              f"{ms_lp:.4f} ms ({int(st.steps)} steps, {ms_lp * 1e3 / int(st.steps):.1f} us a step), TEST loss "
              f"gradient {ms_tg:.4f} ms")
    (_, a1, a2, a3, _), (_, b1, b2, b3, _) = rows
    print(f"phase 102: cond_hepmass42 / hepmass42: train step {a1 / b1:.3f}, logpdf {a2 / b2:.3f}, TEST loss "
          f"gradient {a3 / b3:.3f} (other data: other step counts)")

    fma, floats = cond_fma_floats(dims, nc, B)
    launches = {"k3wc": n_serve["logpdf"] + n_serve["sample"], "k5wc": n_test[names["k5wc"][0]],
                "k1wc": n_fit[names["k1wc"][0]], "k2wc": n_fit[names["k2wc"][0]]}
    records = []
    for key, (out, err, ms, pms) in runs.items():
        name, _, _, src, at = names[key]
        records.append(kernel_record(name, src, at, launches[key], err, ms, pms, fma[key], B, steps_of(out)[0],
                                     floats[key], accepted=steps_of(out)[1]))
    fma_c, floats_c = cond_fma_floats(COND_CHAIN_DIMS, 1, Bc)
    for key, (out, err, ms, pms) in runs_c.items():
        name, _, _, src, at = names[key]
        records.append(kernel_record(f"{name}/chain3", src, at, n_c[name], err, ms, pms, fma_c[key], Bc,
                                     steps_of(out)[0], floats_c[key], accepted=steps_of(out)[1]))
    return records


# ---- K8 in wide K7 and in the wide K4 adjoint: conditional exact training and deep-chain serving ----


def cond_exact_names(fs):
    """The conditional exact and deep-chain paths' kernels: record key ->
    (KERNEL_WRAPPERS name, wrapper, twin, source, the TPU site)."""
    at = "continuousnf_tpu/ops/fused_solve.py:"
    return {
        "k7tc": (fs.K7W_KERNEL + "/test/cond", fs.run_wide_cond_test_solve_kernel, fs.solve_test_plain,
                 "k7_wide_solve.cu", at + "1043"),
        "k7ec": (fs.K7W_KERNEL + "/exact/cond", fs.run_wide_cond_exact_solve_kernel, fs.solve_train_exact_plain,
                 "k7_wide_solve.cu", at + "1043"),
        "k4wc": (fs.K4WA_KERNEL + "/cond", fs.run_wide_cond_exact_adjoint_kernel, fs.adjoint_train_exact_plain,
                 "k4_wide_adjoint.cu", at + "1767"),
    }


def cond_exact_fma_floats(dims, nc, B):
    """FMA per sample and field evaluation and the floats read and written of
    the COND instances of wide K7 (TEST and exact, `chain_fma` with the ys
    rows in the forward) and, for a 2-layer net, of the wide K4 adjoint (the
    unconditional count and 3 nc H: the ys rows in the forward, k_ays and
    their gradient rows), the ys values and a_ys0 among the floats."""
    dz, H = dims[-1], dims[1]
    P = sum(a * b + b for a, b in zip(dims[:-1], dims[1:]))
    chain = chain_fma(dims, nc)
    fma = {"k7tc": chain["k7t"], "k7ec": chain["k7e"]}
    floats = {"k7tc": P + B * (2 * dz + 2 + nc), "k7ec": P + B * (2 * dz + 6 + nc)}
    if len(dims) == 3:
        fma["k4wc"] = two_layer_fma(dz, H)["k4a"] + 3 * nc * H
        floats["k4wc"] = 2 * P + dz * dz * H + B * (4 * dz + 9 + 2 * nc)
    return fma, floats


def ptxas_report(log, part):
    """{entry function: its registers, stack frame and spill bytes} of the
    entry functions in a ptxas -v log whose mangled names hold `part`."""
    import re

    out, entry, props = {}, None, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            entry = m.group(1)
            continue
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            props = m.group(1)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and props is not None and part in props:
            out.setdefault(props, {}).update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                                             spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m and entry is not None and part in entry:
            out.setdefault(entry, {})["registers"] = int(m.group(1))
    return out


def cond_wide_exact(cnf, fs, dev, built):
    """Phases 103 to 107: cond_hepmass42 (CondRNODE, MLP 43 -> 126 -> 42 on
    [z | ys]) under exact trace through the COND instances of wide K7 exact
    and the wide K4 adjoint (K8 in wide K7 and in the wide K4 adjoint), and
    the conditional 3-layer chain MLP 44 -> 128 -> 128 -> 43 served through
    wide K7 TEST's COND instance and trained under exact trace through wide
    K7 exact's (its backward plain).  `built`: the build's {kernel: (library,
    nvcc log)}.  Returns the records."""
    import torch
    from continuousnf_tpu_torch.ode.tableaus import TSIT5
    from continuousnf_tpu_torch.utils.configs import MODELS, cuda_ms, glorot_params, make_icnf, model_data

    cfg = MODELS["cond_hepmass42"]
    dims, nc, B = cfg["dims"], cfg["n_cond"], BATCH
    rng = np.random.default_rng(SEED + 1000)
    ps_np = glorot_params(rng, dims)
    xs_np, ys_np = model_data("cond_hepmass42", rng, B)
    xs, ys = torch.from_numpy(xs_np).to(dev), torch.from_numpy(ys_np).to(dev)
    ps = cnf.params_from_numpy(ps_np, dev)
    model = lambda **kw: make_icnf("cond_hepmass42", dev, exact=True, **kw)  # noqa: E731
    icnf_k, icnf_p = model(), model(fused=False)
    spec = fs.chain_spec(icnf_k.nn, icnf_k.zdim)
    check(spec.n_cond == nc and fs._wide_two_layer(spec) and fs._wide_two_layer_covers(TSIT5, spec) is None,
          "cond_hepmass42 should run the COND instances of wide K7 exact and the wide K4 adjoint")
    names = cond_exact_names(fs)
    T = lambda a: torch.from_numpy(np.asarray(a, "float32")).to(dev)  # noqa: E731
    Bc, dims_c = COND_CHAIN_BATCH, COND_CHAIN_DIMS
    rng_c = np.random.default_rng(SEED + 1001)
    ps_c = glorot_params(rng_c, dims_c)
    xs_c = torch.from_numpy(model_data("miniboone43", rng_c, Bc)).to(dev)
    ys_c = T(rng_c.uniform(-1.0, 1.0, (Bc, 1)))
    chain = lambda **kw: cnf.construct(cnf.CondRNODE, cnf.MLP(dims_c, device=dev), 43, 0, tspan=(0.0, 1.0),  # noqa
                                       compute_mode=cnf.VecJacMode(**kw))
    icnf_c, icnf_cp, icnf_ce = chain(fused=True), chain(fused=False), chain(fused=True, exact_trace=True)
    spec_c = fs.chain_spec(icnf_c.nn, icnf_c.zdim)
    check(fs._wide_chain(spec_c) and fs._kernel_covers(TSIT5, spec_c, chain=True) is None,
          "the conditional 3-layer chain should run wide K7's COND instances")

    # Phase 103: the launch shapes at the paths' batches; ptxas's registers,
    # stack frame and spills of the COND instances beside the unconditional.
    for lib_name, fn, widths, b in ((fs.K7W_KERNEL, "cnf_k7wc_test_shape", dims_c, Bc),
                                    (fs.K7W_KERNEL, "cnf_k7wc_exact_shape", dims, B),
                                    (fs.K7W_KERNEL, "cnf_k7wc_exact_shape", dims_c, Bc),
                                    (fs.K4WA_KERNEL, "cnf_k4wc_shape", dims, B)):
        n_out = 5 if fn == "cnf_k4wc_shape" else 4
        out = (ctypes.c_int * n_out)()
        err = getattr(fs._library(lib_name), fn)(len(widths) - 1, (ctypes.c_int * len(widths))(*widths), b, out)
        check(err == 0 and out[1] >= 1, f"{fn} at {widths}: cudaError {err}")
        tile = f"{out[2]} samples a tile, {out[3]} basis rows a chunk" if n_out == 5 else f"{out[2]} basis rows a chunk"
        print(f"phase 103: {fn} at widths {widths}, B={b}: {out[0]} threads a block, {out[1]} blocks, {tile}, "
              f"{out[n_out - 1]} bytes of dynamic shared memory")
    for lib_name, parts in ((fs.K7W_KERNEL, ("18k7_wide_cond_solve", "13k7_wide_solve")),
                            (fs.K4WA_KERNEL, ("20k4_wide_cond_adjoint", "15k4_wide_adjoint"))):
        log = built.get(lib_name, (None, ""))[1]
        for part in parts:
            found = ptxas_report(log, part)
            if not found:
                print(f"phase 103: {part[2:]}: no ptxas lines (the library was not compiled by this process)")
            for fn, r in found.items():
                print(f"phase 103: ptxas {part[2:]} ({'TEST' if 'ILi1E' in fn else 'exact' if 'ILi3E' in fn else 'one'}"
                      f" entry): {r.get('registers')} registers, {r.get('stack')} bytes stack frame, "
                      f"{r.get('spill_stores')} bytes spill stores, {r.get('spill_loads')} bytes spill loads")

    # Phase 104: each COND instance against its twin, timed.
    _, _, exact, cot = kernel_inputs(icnf_k, ps, xs, rng, dev)
    exact["ys"] = ys
    runs = {"k7ec": run_pair(f"{names['k7ec'][0]} (cond_hepmass42)", names["k7ec"][1], names["k7ec"][2], TSIT5,
                             spec, exact)}
    runs["k4wc"] = run_pair(f"{names['k4wc'][0]} (cond_hepmass42)", names["k4wc"][1], names["k4wc"][2], TSIT5, spec,
                            adjoint_kw(exact, runs["k7ec"][0], cot), adjoint=True, reps=3)
    out = runs["k4wc"][0]
    check(len(out) == 8 and tuple(out[7].shape) == (B, nc) and float(out[3][0][dims[-1]:].abs().max()) > 0.0,
          f"{names['k4wc'][0]} returned no a_ys0 or a zero gradient for W1's ys rows")
    ps_ct = cnf.params_from_numpy(ps_c, dev)
    test_c, _, exact_c, _ = kernel_inputs(icnf_c, ps_ct, xs_c, rng_c, dev)
    test_c["ys"], exact_c["ys"] = ys_c, ys_c
    runs_c = {key: run_pair(f"{names[key][0]} (3-layer, B={Bc})", names[key][1], names[key][2], TSIT5, spec_c, kw,
                            reps=3) for key, kw in (("k7tc", test_c), ("k7ec", exact_c))}
    print("phase 104: the COND instances of wide K7 and the wide K4 adjoint held to their twins")

    # Phase 105: cond_hepmass42's exact loss and gradients (params and ys) at
    # B = 256 against the plain path and a float64 rtol 1e-7 solve.
    b = COND_TRUTH_BATCH
    truth = cnf.SolverOptions(rtol=1e-7, atol=1e-9)
    steer = {"steer_r": 0.05}
    want = {names["k7ec"][0]: 1, names["k4wc"][0]: 1}
    fs.reset_launches()
    l_k, g_k, _ = loss_grad(cnf, icnf_k, ps_np, xs[:b], dev, ys=ys[:b], **steer)
    torch.cuda.synchronize()
    check(launched(fs) == want, f"cond_hepmass42 exact gradient launched {launched(fs)}, expected {want}")
    l_p, g_p, _ = loss_grad(cnf, icnf_p, ps_np, xs[:b], dev, ys=ys[:b], **steer)
    l_t, g_t, _ = loss_grad(cnf, model(fused=False, dtype=torch.float64, solver=truth), ps_np, xs[:b], dev,
                            torch.float64, ys=ys[:b], **steer)
    torch.cuda.synchronize()
    hold_gradients(f"cond_hepmass42 exact B={b}", l_k, g_k, l_p, g_p, l_t, g_t, names=["w1", "b1", "w2", "b2", "ys"])
    print("phase 105: cond_hepmass42 exact gradients held to the float64 solve")

    # Phase 106: the main paths, counters reset just before each: the exact
    # train step and the exact `fit` (wide K7 exact COND and the wide K4
    # adjoint COND), the 3-layer chain's logpdf and sample (wide K7 TEST
    # COND) and its exact step (wide K7 exact COND, the backward plain).
    gen = torch.Generator(device=dev).manual_seed(SEED + 1002)
    p = cnf.params_from_numpy(ps_np, dev)
    leaves = [x.requires_grad_() for layer in p for x in (layer["w"], layer["b"])]
    step = cnf.parallel.make_train_step_body(icnf_k, cnf.Lion(leaves, lr=1e-3))
    fs.reset_launches()
    metrics = step(p, xs, gen, ys=ys)
    torch.cuda.synchronize()
    n_step = launched(fs)
    check(n_step == want and bool(torch.isfinite(metrics["loss"])) and all(bool(torch.isfinite(x).all())
                                                                            for x in leaves),
          f"cond_hepmass42 exact train step launched {n_step}, loss {float(metrics['loss'])}")
    X, Y = model_data("cond_hepmass42", rng, N_STEPS * B)
    fit_path(cnf, fs, icnf_k, ps_np, dev, X, Y, batch_size=B)
    n_fit = launched(fs)
    check(set(n_fit) == set(want) and min(n_fit.values()) >= N_STEPS, f"cond_hepmass42 exact fit launched {n_fit}")
    dist_c = cnf.CondICNFDist(icnf_c, cnf.Mode.TEST, ps_ct, ys_c)
    n_serve = {}
    for what, call in (("logpdf", lambda: dist_c.logpdf(xs_c)),
                       ("sample", lambda: dist_c.sample(Bc, generator=torch.Generator(device=dev).manual_seed(
                           SEED + 1003)))):
        fs.reset_launches()
        with torch.no_grad():
            out = call()
        torch.cuda.synchronize()
        n = launched(fs)
        check(n == {names["k7tc"][0]: 1} and bool(torch.isfinite(out).all()), f"3-layer chain {what} launched {n}")
        n_serve[what] = n[names["k7tc"][0]]
    with torch.no_grad():
        lp_k, _, st_k = cnf.inference(icnf_c, cnf.Mode.TEST, xs_c, ps_ct, ys=ys_c)
        lp_p, _, st_p = cnf.inference(icnf_cp, cnf.Mode.TEST, xs_c, ps_ct, ys=ys_c)
    dlp = float((lp_k - lp_p).abs().max())
    check(dlp <= TOL * max(1.0, float(lp_p.abs().max())), f"3-layer chain logpdf differs from the plain path by {dlp}")
    print(f"phase 106: 3-layer chain logpdf B={Bc}: max|dlogp| against the plain path {dlp:.3e}, steps "
          f"{int(st_k.steps)} (plain {int(st_p.steps)}; the kernel is held to its twin in phase 104)")
    fs.reset_launches()
    l_c, g_c, _ = loss_grad(cnf, icnf_ce, ps_c, xs_c, dev, ys=ys_c, **steer)
    torch.cuda.synchronize()
    n_c = launched(fs)
    check(n_c == {names["k7ec"][0]: 1} and all(bool(torch.isfinite(g).all()) for g in g_c),
          f"the 3-layer chain's exact step launched {n_c}")
    print(f"phase 106: cond_hepmass42 exact train step launched {n_step}, exact fit {n_fit}; 3-layer chain logpdf "
          f"and sample {n_serve}, exact step {n_c} (loss {float(l_c):.6f}, the backward plain)")

    # Phase 107: CUDA-event times beside hepmass42's exact step and
    # miniboone43's logpdf, in the same run (a, b, b, a).
    rng_h = np.random.default_rng(SEED + 400)
    ps_h = glorot_params(rng_h, MODELS["hepmass42"]["dims"])
    xs_h = torch.from_numpy(model_data("hepmass42", rng_h, B)).to(dev)
    icnf_h = make_icnf("hepmass42", dev, exact=True)
    gen = torch.Generator(device=dev).manual_seed(SEED + 1004)
    a1 = step_ms(cnf, icnf_k, ps_np, xs, gen, dev, 3, ys=ys)
    b1 = step_ms(cnf, icnf_h, ps_h, xs_h, gen, dev, 3)
    b2 = step_ms(cnf, icnf_h, ps_h, xs_h, gen, dev, 3)
    a2 = step_ms(cnf, icnf_k, ps_np, xs, gen, dev, 3, ys=ys)
    ms_c, ms_h = (a1 + a2) / 2, (b1 + b2) / 2
    print(f"phase 107: exact train step B={B}: cond_hepmass42 {ms_c:.4f} ms ({B / ms_c * 1e3:.1f} samples/s), "
          f"hepmass42 {ms_h:.4f} ms ({B / ms_h * 1e3:.1f} samples/s); ratio {ms_c / ms_h:.3f}")
    rng_m = np.random.default_rng(SEED + 1005)
    ps_m = cnf.params_from_numpy(glorot_params(rng_m, MODELS["miniboone43"]["dims"]), dev)
    xs_m = torch.from_numpy(model_data("miniboone43", rng_m, Bc)).to(dev)
    dist_m = cnf.ICNFDist(make_icnf("miniboone43", dev), cnf.Mode.TEST, ps_m)
    with torch.no_grad():
        _, _, st_m = cnf.inference(dist_m.icnf, cnf.Mode.TEST, xs_m, ps_m)
        lp_c, lp_m = paired_ms(lambda: dist_c.logpdf(xs_c), lambda: dist_m.logpdf(xs_m), 3)
    print(f"phase 107: logpdf B={Bc}: the 3-layer conditional chain {lp_c:.4f} ms ({int(st_k.steps)} steps, "
          f"{lp_c * 1e3 / int(st_k.steps):.1f} us a step), miniboone43 {lp_m:.4f} ms ({int(st_m.steps)} steps, "
          f"{lp_m * 1e3 / int(st_m.steps):.1f} us a step); ratio {lp_c / lp_m:.3f}")

    records = []
    fma, floats = cond_exact_fma_floats(dims, nc, B)
    launches = {"k7ec": n_fit[names["k7ec"][0]], "k4wc": n_fit[names["k4wc"][0]]}
    for key, (out, err, ms, pms) in runs.items():
        name, _, _, src, at = names[key]
        records.append(kernel_record(name, src, at, launches[key], err, ms, pms, fma[key], B, steps_of(out)[0],
                                     floats[key], accepted=steps_of(out)[1]))
    fma_c, floats_c = cond_exact_fma_floats(dims_c, 1, Bc)
    launches_c = {"k7tc": n_serve["logpdf"] + n_serve["sample"], "k7ec": n_c[names["k7ec"][0]]}
    for key, (out, err, ms, pms) in runs_c.items():
        name, _, _, src, at = names[key]
        records.append(kernel_record(name if key == "k7tc" else f"{name}/chain3", src, at, launches_c[key], err, ms,
                                     pms, fma_c[key], Bc, steps_of(out)[0], floats_c[key], accepted=steps_of(out)[1]))
    return records


# ---- K6 x K8: conditional K-probe and JVP training past the narrow widths ----

COND_PROBE_REPS = 3  # timed calls of each phase-109 hold
COND_PROBE_GRAD_TOL = 2e-4  # phase 109: the probe COND adjoints' gradients and a_ys0 against the twin, x max(1, max|g|)


def cond_probe_names(fs):
    """The probe COND instances' record keys -> (KERNEL_WRAPPERS name,
    wrapper, twin, source, the TPU site); their launches are the wrappers'
    `.probe_launches[(K, jvp)]`."""
    at = "continuousnf_tpu/ops/fused_solve.py:"
    return {
        "k1wpc": (fs.K1W_KERNEL + "/cond", fs.run_wide_cond_train_solve_kernel, fs.solve_train_plain,
                  "k1_wide_solve.cu", at + "1043"),
        "k2wpc": (fs.K2W_KERNEL + "/cond", fs.run_wide_cond_adjoint_kernel, fs.adjoint_train_plain,
                  "k2_wide_adjoint.cu", at + "1767"),
    }


def cond_probe_fma_floats(dims, nc, k, B):
    """FMA per sample and field evaluation and the floats read and written of
    the probe COND instances at k probes (`probe_fma` of the chain forms with
    the first layer's ys rows in the forward, the ys cotangent and its
    gradient rows; the COND instances' floats and k - 1 more probe planes)."""
    dz = dims[-1]
    P = sum(a * b + b for a, b in zip(dims[:-1], dims[1:]))
    fma = probe_fma(dims, k, n_cond=nc, chain=True)
    extra = (k - 1) * B * dz
    return ({"k1wpc": fma["k1c"], "k2wpc": fma["k2c"]},
            {"k1wpc": P + B * (3 * dz + 6 + nc) + extra, "k2wpc": 2 * P + B * (5 * dz + 9 + 2 * nc) + extra})


def cond_wide_probes(cnf, fs, dev, built):
    """Phases 108 to 112: K-probe and JVP Hutchinson training of conditional
    nets past the narrow widths (K6 x K8) through the probe COND instances of
    the wide K1 and K2 chain forms: cond_hepmass42 (CondRNODE, MLP 43 -> 126
    -> 42 on [z | ys], B = 4096) and the conditional 3-layer chain MLP 44 ->
    128 -> 128 -> 43 (B = 2048), beside the unconditional wide probe
    instances at hepmass42 and miniboone43.  `built`: the build's {kernel:
    (library, nvcc log)}.  Returns the records."""
    import torch
    from continuousnf_tpu_torch.ode.tableaus import TSIT5
    from continuousnf_tpu_torch.utils.configs import MODELS, cuda_ms, glorot_params, make_icnf, model_data

    names = cond_probe_names(fs)
    run1, run2 = names["k1wpc"][1], names["k2wpc"][1]
    want = {names["k1wpc"][0]: 1, names["k2wpc"][0]: 1}

    def probe_counts():
        return [dict(w.probe_launches) for w in (run1, run2)]

    cfg = MODELS["cond_hepmass42"]
    dims, nc, B = cfg["dims"], cfg["n_cond"], BATCH
    rng = np.random.default_rng(SEED + 1100)
    ps_np = glorot_params(rng, dims)
    xs_np, ys_np = model_data("cond_hepmass42", rng, B)
    xs, ys = torch.from_numpy(xs_np).to(dev), torch.from_numpy(ys_np).to(dev)
    model = lambda k=1, jvp=False, **kw: make_icnf("cond_hepmass42", dev, num_probes=k,  # noqa: E731
                                                   ad="jvp" if jvp else "vjp", **kw)
    Bc, dims_c = COND_CHAIN_BATCH, COND_CHAIN_DIMS
    rng_c = np.random.default_rng(SEED + 1101)
    ps_c = glorot_params(rng_c, dims_c)
    xs_c = torch.from_numpy(model_data("miniboone43", rng_c, Bc)).to(dev)
    ys_c = torch.from_numpy(rng_c.uniform(-1.0, 1.0, (Bc, 1)).astype("float32")).to(dev)
    chain = lambda k=1, jvp=False, **kw: cnf.construct(  # noqa: E731
        cnf.CondRNODE, cnf.MLP(dims_c, device=dev), 43, 0, tspan=(0.0, 1.0),
        compute_mode=(cnf.JacVecMode if jvp else cnf.VecJacMode)(k, **kw))
    nets = {"cond_hepmass42": (model(), ps_np, xs, ys, B, dims),
            "3-layer": (chain(fused=True), ps_c, xs_c, ys_c, Bc, dims_c)}
    for label, (icnf, _, _, _, _, d) in nets.items():
        spec = fs.chain_spec(icnf.nn, icnf.zdim)
        check(spec.n_cond and fs._wide_chain(spec) and not fs._stream_chain(spec, True)
              and all(fs._kernel_covers(TSIT5, spec, k, chain=True, jvp=jvp) is None for k, jvp in PROBE_CONFIGS),
              f"{label} with probes should run the probe COND instances")

    # Phase 108: the probe COND instances' launch shapes at both nets' batches
    # (K is a run-time argument: one shape for every K), and ptxas's
    # registers, stack frame and spills beside the probe instances'.
    for lib_name, fn in ((fs.K1W_KERNEL, "cnf_k1wpc_shape"), (fs.K2W_KERNEL, "cnf_k2wpc_shape")):
        for widths, b in ((dims, B), (dims_c, Bc)):
            out = (ctypes.c_int * 4)()
            err = getattr(fs._library(lib_name), fn)(len(widths) - 1, (ctypes.c_int * len(widths))(*widths), b, out)
            check(err == 0 and out[1] >= 1, f"{fn} at {widths}: cudaError {err}")
            print(f"phase 108: {fn} at widths {widths}, B={b}, every K: {out[0]} threads a block, {out[1]} blocks, "
                  f"tile {out[2]}, {out[3]} bytes of dynamic shared memory")
    for lib_name, parts in ((fs.K1W_KERNEL, ("24k1_wide_probe_cond_solve", "19k1_wide_probe_solve")),
                            (fs.K2W_KERNEL, ("26k2_wide_probe_cond_adjoint", "21k2_wide_probe_adjoint"))):
        log = built.get(lib_name, (None, ""))[1]
        for part in parts:
            found = ptxas_report(log, part)
            if not found:
                print(f"phase 108: {part[2:]}: no ptxas lines (the library was not compiled by this process)")
            for r in found.values():
                print(f"phase 108: ptxas {part[2:]}: {r.get('registers')} registers, {r.get('stack')} bytes stack "
                      f"frame, {r.get('spill_stores')} bytes spill stores, {r.get('spill_loads')} bytes spill loads")

    # Phase 109: each probe COND instance against its twin at every probe
    # configuration on both nets (the forward from nonzero accumulators, the
    # adjoint from its output warm-started from its last step), timed; the
    # unconditional wide probe instances on hepmass42 and miniboone43 at the
    # same batches and probes timed beside them (per attempted step).
    yard = {"cond_hepmass42": "hepmass42", "3-layer": "miniboone43"}
    held, per_step = {}, {}
    for label, (icnf, p_np, x, y, b, d) in nets.items():
        spec = fs.chain_spec(icnf.nn, icnf.zdim)
        ps = cnf.params_from_numpy(p_np, dev)
        _, train, _, cot = kernel_inputs(icnf, ps, x, rng, dev)
        train["ys"] = y
        eps_all = torch.from_numpy(rng.normal(size=(8, b, icnf.zdim)).astype("float32")).to(dev)
        rng_u = np.random.default_rng(SEED + 1102)
        icnf_u = make_icnf(yard[label], dev)
        dims_u = MODELS[yard[label]]["dims"]
        ps_u = cnf.params_from_numpy(glorot_params(rng_u, dims_u), dev)
        x_u = torch.from_numpy(model_data(yard[label], rng_u, b)).to(dev)
        spec_u = fs.chain_spec(icnf_u.nn, icnf_u.zdim)
        _, train_u, _, cot_u = kernel_inputs(icnf_u, ps_u, x_u, rng_u, dev)
        eps_u = torch.from_numpy(rng_u.normal(size=(8, b, icnf_u.zdim)).astype("float32")).to(dev)
        for k, jvp in PROBE_CONFIGS:
            tag = probe_tag(k, jvp)
            kw1 = dict(train, eps=eps_all[:k].contiguous(), jvp=jvp)
            r1 = run_pair(f"{names['k1wpc'][0]} {tag} ({label}, B={b})", run1, fs.solve_train_plain, TSIT5, spec, kw1,
                          reps=COND_PROBE_REPS)
            r2 = run_pair(f"{names['k2wpc'][0]} {tag} ({label}, B={b})", run2, fs.adjoint_train_plain, TSIT5, spec,
                          adjoint_kw(kw1, r1[0], cot), adjoint=True, reps=COND_PROBE_REPS,
                          grad_tol=COND_PROBE_GRAD_TOL)
            out2 = r2[0]
            check(len(out2) == 8 and tuple(out2[7].shape) == (b, d[0] - d[-1])
                  and float(out2[3][0][icnf.zdim:].abs().max()) > 0.0,
                  f"{label} {tag}: the probe COND adjoint returned no a_ys0 or a zero gradient for W1's ys rows")
            held[(label, k, jvp)] = (r1, r2)
            ku = dict(train_u, eps=eps_u[:k].contiguous(), jvp=jvp)
            with torch.no_grad():
                o1 = fs.run_wide_train_solve_kernel(TSIT5, spec_u, **ku)
                ka = adjoint_kw(ku, o1, cot_u)
                o2 = fs.run_wide_adjoint_kernel(TSIT5, spec_u, **ka)
                m1 = cuda_ms(lambda: fs.run_wide_train_solve_kernel(TSIT5, spec_u, **ku), COND_PROBE_REPS)
                m2 = cuda_ms(lambda: fs.run_wide_adjoint_kernel(TSIT5, spec_u, **ka), COND_PROBE_REPS)
            us = (r1[2] * 1e3 / int(r1[0][2]), r2[2] * 1e3 / int(out2[5]), m1 * 1e3 / int(o1[2]),
                  m2 * 1e3 / int(o2[5]))
            per_step[(label, k, jvp)] = us
            print(f"phase 109: {label} {tag} B={b}: per attempted step, probe COND K1 {us[0]:.1f} us / K2 "
                  f"{us[1]:.1f} us; {yard[label]}'s probe instances {us[2]:.1f} / {us[3]:.1f} us; ratio "
                  f"{us[0] / us[2]:.3f} / {us[1] / us[3]:.3f}")
    print("phase 109: the probe COND instances held to their twins")

    # Phase 110: cond_hepmass42's K = 4 loss gradient in the params and ys at
    # B = 256 against the plain path and a float64 rtol 1e-7 solve.
    bt = COND_TRUTH_BATCH
    truth = cnf.SolverOptions(rtol=1e-7, atol=1e-9)
    steer = {"steer_r": 0.05}
    eps = model(4).draw_eps(torch.Generator(device=dev).manual_seed(SEED + 1103), bt, dev)
    fs.reset_launches()
    l_k, g_k, _ = loss_grad(cnf, model(4), ps_np, xs[:bt], dev, ys=ys[:bt], eps=eps, **steer)
    torch.cuda.synchronize()
    check(launched(fs) == want and probe_counts() == [{(4, False): 1}] * 2,
          f"cond_hepmass42 K4 gradient launched {launched(fs)}, probe instances {probe_counts()}")
    l_p, g_p, _ = loss_grad(cnf, model(4, fused=False), ps_np, xs[:bt], dev, ys=ys[:bt], eps=eps, **steer)
    l_t, g_t, _ = loss_grad(cnf, model(4, fused=False, dtype=torch.float64, solver=truth), ps_np, xs[:bt], dev,
                            torch.float64, ys=ys[:bt], eps=eps.double(), **steer)
    torch.cuda.synchronize()
    hold_gradients(f"cond_hepmass42 K4 B={bt}", l_k, g_k, l_p, g_p, l_t, g_t, names=["w1", "b1", "w2", "b2", "ys"])
    print(f"phase 110: cond_hepmass42 K4 B={bt}: loss fused {float(l_k):.6f} plain {float(l_p):.6f} float64 "
          f"{float(l_t):.6f}; gradients held to the float64 solve")

    # Phase 111: the main paths, counters reset just before each: every probe
    # configuration's loss gradient on both nets, cond_hepmass42's K = 4
    # train step and K = 4 fit, the 3-layer chain's JVP train step; each
    # launches the probe COND instances alone, under its (K, jvp).
    launches = {}
    for label, (icnf, p_np, x, y, b, d) in nets.items():
        for k, jvp in PROBE_CONFIGS:
            icnf_k = model(k, jvp) if label == "cond_hepmass42" else chain(k, jvp, fused=True)
            e = icnf_k.draw_eps(torch.Generator(device=dev).manual_seed(SEED + 1104 + k), b, dev)
            fs.reset_launches()
            _, g, _ = loss_grad(cnf, icnf_k, p_np, x, dev, ys=y, eps=e, **steer)
            torch.cuda.synchronize()
            counts = probe_counts()
            check(launched(fs) == want and counts == [{(k, jvp): 1}] * 2
                  and all(bool(torch.isfinite(v).all()) for v in g),
                  f"{label} {probe_tag(k, jvp)}: launched {launched(fs)}, probe instances {counts}")
            launches[(label, k, jvp)] = [1, 1]
    gen = torch.Generator(device=dev).manual_seed(SEED + 1105)
    steps = {}
    for label, icnf_k, p_np, x, y, key in (("cond_hepmass42 K4", model(4), ps_np, xs, ys, (4, False)),
                                           ("3-layer jvp-K1", chain(1, True, fused=True), ps_c, xs_c, ys_c,
                                            (1, True))):
        p = cnf.params_from_numpy(p_np, dev)
        leaves = [v.requires_grad_() for layer in p for v in (layer["w"], layer["b"])]
        step = cnf.parallel.make_train_step_body(icnf_k, cnf.Lion(leaves, lr=1e-3))
        fs.reset_launches()
        metrics = step(p, x, gen, ys=y)
        torch.cuda.synchronize()
        counts = probe_counts()
        check(launched(fs) == want and counts == [{key: 1}] * 2 and bool(torch.isfinite(metrics["loss"]))
              and all(bool(torch.isfinite(v).all()) for v in leaves),
              f"{label} train step launched {launched(fs)}, probe instances {counts}")
        steps[label] = counts
    X, Y = model_data("cond_hepmass42", rng, N_STEPS * B)
    fit_path(cnf, fs, model(4), ps_np, dev, X, Y, batch_size=B)
    n_fit = probe_counts()
    check(set(launched(fs)) == set(want) and all(set(c) == {(4, False)} and c[(4, False)] >= N_STEPS for c in n_fit),
          f"cond_hepmass42 K4 fit launched {launched(fs)}, probe instances {n_fit}")
    launches[("cond_hepmass42", 4, False)] = [c[(4, False)] for c in n_fit]
    print(f"phase 111: every probe configuration's loss gradient on both nets launched the probe COND instances once "
          f"each and nothing else; train steps {steps}; cond_hepmass42 K4 fit ({N_STEPS} Lion steps at B={B}) "
          f"{[c[(4, False)] for c in n_fit]}")

    # Phase 112: CUDA-event times of cond_hepmass42's K = 4 train step beside
    # hepmass42's K = 4 step, in the same run (a, b, b, a).
    rng_h = np.random.default_rng(SEED + 400)
    ps_h = glorot_params(rng_h, MODELS["hepmass42"]["dims"])
    xs_h = torch.from_numpy(model_data("hepmass42", rng_h, B)).to(dev)
    icnf_h = make_icnf("hepmass42", dev, num_probes=4)
    gen = torch.Generator(device=dev).manual_seed(SEED + 1106)
    a1 = step_ms(cnf, model(4), ps_np, xs, gen, dev, 3, ys=ys)
    b1 = step_ms(cnf, icnf_h, ps_h, xs_h, gen, dev, 3)
    b2 = step_ms(cnf, icnf_h, ps_h, xs_h, gen, dev, 3)
    a2 = step_ms(cnf, model(4), ps_np, xs, gen, dev, 3, ys=ys)
    ms_c, ms_h = (a1 + a2) / 2, (b1 + b2) / 2
    print(f"phase 112: K = 4 train step B={B}: cond_hepmass42 {ms_c:.4f} ms ({B / ms_c * 1e3:.1f} samples/s), "
          f"hepmass42 {ms_h:.4f} ms ({B / ms_h * 1e3:.1f} samples/s); ratio {ms_c / ms_h:.3f} (other data: other "
          "step counts)")

    records = []
    for (label, k, jvp), (r1, r2) in held.items():
        d, b = nets[label][5], nets[label][4]
        fma, floats = cond_probe_fma_floats(d, d[0] - d[-1], k, b)
        suffix = "" if label == "cond_hepmass42" else "/chain3"
        for key, (out, err, ms, pms), n in zip(("k1wpc", "k2wpc"), (r1, r2), launches[(label, k, jvp)]):
            name, _, _, src, at = names[key]
            records.append(kernel_record(f"{name}/{probe_tag(k, jvp)}{suffix}", src, at, n, err, ms, pms, fma[key],
                                         b, steps_of(out)[0], floats[key], accepted=steps_of(out)[1]))
    return records


# ---- K8 in the streamed forms: conditional nets past the wide limits ----

COND_MB860_DIMS = (44, 860, 860, 43)  # phases 114 and 116: the conditional miniboone860 chain, one ys column


def cond_stream_names(fs):
    """The cond_miniboone86 path's kernels: record key -> (KERNEL_WRAPPERS
    name, wrapper, twin, source, the TPU site)."""
    at = "continuousnf_tpu/ops/fused_solve.py:"
    return {
        "k3sc": (fs.K3S_KERNEL + "/cond", fs.run_stream_cond_test2_solve_kernel, fs.solve_test_plain,
                 "k3_stream_solve.cu", at + "1043"),
        "k5sc": (fs.K5S_KERNEL + "/cond", fs.run_stream_cond_test_adjoint_kernel, fs.adjoint_test_plain,
                 "k5_stream_adjoint.cu", at + "1767"),
        "k1sc": (fs.K1S_KERNEL + "/cond", fs.run_stream_cond_train_solve_kernel, fs.solve_train_plain,
                 "k1_stream_solve.cu", at + "1043"),
        "k2sc": (fs.K2S_KERNEL + "/cond", fs.run_stream_cond_adjoint_kernel, fs.adjoint_train_plain,
                 "k2_stream_adjoint.cu", at + "1767"),
    }


def cond_stream(cnf, fs, dev, built):
    """Phases 113 to 117: K8 in the streamed forms, CondRNODE at the
    MINIBOONE width (cond_miniboone86, MLP 87 -> 258 -> 86 on [z | ys], B =
    4096) through the COND instances of streamed K3, streamed K5 and the
    streamed K1 and K2 chain forms, and the conditional miniboone860 chain
    MLP 44 -> 860 -> 860 -> 43 (B = 1024) through the chain forms', beside
    miniboone86's unconditional streamed instances.  `built`: the build's
    {kernel: (library, nvcc log)}.  Returns the records."""
    import torch
    from continuousnf_tpu_torch.ode.tableaus import TSIT5
    from continuousnf_tpu_torch.utils.configs import MODELS, cuda_ms, glorot_params, make_icnf, model_data

    cfg = MODELS["cond_miniboone86"]
    dims, nc, B = cfg["dims"], cfg["n_cond"], BATCH
    rng = np.random.default_rng(SEED + 1200)
    ps_np = glorot_params(rng, dims)
    xs_np, ys_np = model_data("cond_miniboone86", rng, B)
    xs, ys = torch.from_numpy(xs_np).to(dev), torch.from_numpy(ys_np).to(dev)
    ps = cnf.params_from_numpy(ps_np, dev)
    model = lambda **kw: make_icnf("cond_miniboone86", dev, **kw)  # noqa: E731
    icnf_k, icnf_p = model(), model(fused=False)
    spec = fs.chain_spec(icnf_k.nn, icnf_k.zdim)
    check(spec.n_cond == nc and fs._stream_two_layer(spec) and fs._stream_two_layer_covers(TSIT5, spec) is None
          and fs._kernel_covers(TSIT5, spec, chain=True) is None,
          "cond_miniboone86 should run the COND instances of the streamed forms")
    names = cond_stream_names(fs)
    want = {names["k1sc"][0]: 1, names["k2sc"][0]: 1}
    Bc, dims_c = MODELS["miniboone860"]["batch"], COND_MB860_DIMS
    rng_c = np.random.default_rng(SEED + 1201)
    ps_c = glorot_params(rng_c, dims_c)
    xs_c, ys_c = (torch.from_numpy(a).to(dev) for a in model_data("cond_miniboone86", rng_c, Bc))
    chain = lambda **kw: cnf.construct(cnf.CondRNODE, cnf.MLP(dims_c, device=dev), 43, 0, tspan=(0.0, 1.0),  # noqa
                                       compute_mode=cnf.VecJacMode(**kw))
    icnf_c = chain(fused=True)
    spec_c = fs.chain_spec(icnf_c.nn, icnf_c.zdim)
    check(fs._stream_chain(spec_c) and fs._kernel_covers(TSIT5, spec_c, chain=True) is None,
          "the conditional miniboone860 chain should run the streamed chain forms' COND instances")

    # Phase 113: the COND instances' launch shapes; ptxas's registers, stack
    # frame and spills beside the unconditional instances'.
    for lib_name, fn, widths, b in ((fs.K3S_KERNEL, "cnf_k3sc_shape", dims, B),
                                    (fs.K5S_KERNEL, "cnf_k5sc_shape", dims, B),
                                    (fs.K1S_KERNEL, "cnf_k1sc_shape", dims, B),
                                    (fs.K2S_KERNEL, "cnf_k2sc_shape", dims, B),
                                    (fs.K1S_KERNEL, "cnf_k1sc_shape", dims_c, Bc),
                                    (fs.K2S_KERNEL, "cnf_k2sc_shape", dims_c, Bc)):
        out = (ctypes.c_int * 5)()
        err = getattr(fs._library(lib_name), fn)(len(widths) - 1, (ctypes.c_int * len(widths))(*widths), b, out)
        check(err == 0 and out[1] >= 1, f"{fn} at {widths}: cudaError {err}")
        print(f"phase 113: {fn} at widths {widths}, B={b}: {out[0]} threads a block, {out[1]} blocks, tile {out[2]}, "
              f"{out[3]} bytes of dynamic shared memory, {out[4]} floats of global tile scratch a block")
    for lib_name, parts in ((fs.K3S_KERNEL, ("20k3_stream_cond_solve", "15k3_stream_solve")),
                            (fs.K5S_KERNEL, ("22k5_stream_cond_adjoint", "17k5_stream_adjoint")),
                            (fs.K1S_KERNEL, ("20k1_stream_cond_solve", "15k1_stream_solve")),
                            (fs.K2S_KERNEL, ("22k2_stream_cond_adjoint", "17k2_stream_adjoint"))):
        log = built.get(lib_name, (None, ""))[1]
        for part in parts:
            found = ptxas_report(log, part)
            if not found:
                print(f"phase 113: {part[2:]}: no ptxas lines (the library was not compiled by this process)")
            for r in found.values():
                print(f"phase 113: ptxas {part[2:]}: {r.get('registers')} registers, {r.get('stack')} bytes stack "
                      f"frame, {r.get('spill_stores')} bytes spill stores, {r.get('spill_loads')} bytes spill loads")

    # Phase 114: each COND instance against its twin (three timed calls),
    # the chain forms' also on the conditional miniboone860 chain; then each
    # beside miniboone86's unconditional instance on miniboone86's inputs in
    # the same run, a b b a, per attempted step.
    test, train, _, cot = kernel_inputs(icnf_k, ps, xs, rng, dev)
    test["ys"], train["ys"] = ys, ys
    roles = {"k3s": "k3sc", "k5s": "k5sc", "k1c": "k1sc", "k2c": "k2sc"}  # the unconditional keys -> the COND ones
    kws = {}
    runs = {roles[k]: r for k, r in stream_two_layer_runs("cond_miniboone86", fs, spec, test, train, cot, rng, dev,
                                                           names={k: names[c] for k, c in roles.items()},
                                                           kws=kws).items()}
    for key in ("k2sc", "k5sc"):
        out = runs[key][0]
        check(len(out) == 8 and tuple(out[7].shape) == (B, nc) and float(out[3][0][dims[-1]:].abs().max()) > 0.0,
              f"{names[key][0]} returned no a_ys0 or a zero gradient for W1's ys rows")
    _, train_c, _, cot_c = kernel_inputs(icnf_c, cnf.params_from_numpy(ps_c, dev), xs_c, rng_c, dev)
    train_c["ys"] = ys_c
    runs_c = {"k1sc": run_pair(f"{names['k1sc'][0]} (miniboone860 chain, B={Bc})", names["k1sc"][1],
                               names["k1sc"][2], TSIT5, spec_c, train_c, reps=2)}
    runs_c["k2sc"] = run_pair(f"{names['k2sc'][0]} (miniboone860 chain, B={Bc})", names["k2sc"][1], names["k2sc"][2],
                              TSIT5, spec_c, adjoint_kw(train_c, runs_c["k1sc"][0], cot_c), adjoint=True, reps=2)
    rng_u = np.random.default_rng(SEED + 1202)
    icnf_u = make_icnf("miniboone86", dev)
    spec_u = fs.chain_spec(icnf_u.nn, icnf_u.zdim)
    ps_u = cnf.params_from_numpy(glorot_params(rng_u, MODELS["miniboone86"]["dims"]), dev)
    xs_u = torch.from_numpy(model_data("miniboone86", rng_u, B)).to(dev)
    test_u, train_u, _, cot_u = kernel_inputs(icnf_u, ps_u, xs_u, rng_u, dev)
    un, kws_u = stream_two_layer_names(fs), {}
    runs_u = stream_two_layer_runs("miniboone86, the yardstick", fs, spec_u, test_u, train_u, cot_u, rng_u, dev, reps=1,
                                   kws=kws_u)
    per_step = {}
    with torch.no_grad():
        for ukey, key in roles.items():
            ms_a, ms_b = paired_ms(lambda: names[key][1](TSIT5, spec, **kws[ukey]),
                                   lambda: un[ukey][1](TSIT5, spec_u, **kws_u[ukey]), 3)
            n_a, n_b = int(steps_of(runs[key][0])[0]), int(steps_of(runs_u[ukey][0])[0])
            per_step[key] = (ms_a * 1e3 / n_a, ms_b * 1e3 / n_b)
            print(f"phase 114: {names[key][0]} {ms_a:.4f} ms ({n_a} steps, {per_step[key][0]:.1f} us a step) beside "
                  f"{un[ukey][0]} {ms_b:.4f} ms on miniboone86 ({n_b} steps, {per_step[key][1]:.1f} us a step), a b b "
                  f"a: {100.0 * (per_step[key][0] / per_step[key][1] - 1.0):+.1f} % a step")
    print("phase 114: the streamed COND instances held to their twins")

    # Phase 115: the train step's and the TEST loss's gradients at B = 256
    # against the plain path and a float64 rtol 1e-7 solve.
    b = COND_TRUTH_BATCH
    truth = cnf.SolverOptions(rtol=1e-7, atol=1e-9)
    eps = icnf_k.draw_eps(torch.Generator(device=dev).manual_seed(SEED + 1203), b, dev)
    steer = {"steer_r": 0.05}
    fs.reset_launches()
    l_k, g_k, _ = loss_grad(cnf, icnf_k, ps_np, xs[:b], dev, ys=ys[:b], eps=eps, **steer)
    torch.cuda.synchronize()
    check(launched(fs) == want, f"cond_miniboone86 train gradient launched {launched(fs)}, expected {want}")
    l_p, g_p, _ = loss_grad(cnf, icnf_p, ps_np, xs[:b], dev, ys=ys[:b], eps=eps, **steer)
    l_t, g_t, _ = loss_grad(cnf, model(fused=False, dtype=torch.float64, solver=truth), ps_np, xs[:b], dev,
                            torch.float64, ys=ys[:b], eps=eps.double(), **steer)
    torch.cuda.synchronize()
    hold_gradients(f"cond_miniboone86 Hutchinson B={b}", l_k, g_k, l_p, g_p, l_t, g_t,
                   names=["w1", "b1", "w2", "b2", "ys"])
    models = (icnf_k, icnf_p, model(fused=False, dtype=torch.float64, solver=truth))
    test_gradient_path(f"cond_miniboone86 TEST gradient B={b}", cnf, fs, models, ps_np, xs[:b], dev,
                       {names["k3sc"][0]: 1, names["k5sc"][0]: 1}, ys=ys[:b])
    print("phase 115: cond_miniboone86 gradients held to the float64 solve")

    # Phase 116: the main paths, counters reset just before each, and what
    # is still refused, by name.
    dist = cnf.CondICNFDist(icnf_k, cnf.Mode.TEST, ps, ys)
    n_serve = {}
    draw = torch.Generator(device=dev).manual_seed(SEED + 1204)
    for what, call in (("logpdf", lambda: dist.logpdf(xs)), ("sample", lambda: dist.sample(B, generator=draw))):
        fs.reset_launches()
        with torch.no_grad():
            out = call()
        torch.cuda.synchronize()
        n = launched(fs)
        check(n == {names["k3sc"][0]: 1} and bool(torch.isfinite(out).all()), f"cond_miniboone86 {what} launched {n}")
        n_serve[what] = n[names["k3sc"][0]]
    fs.reset_launches()
    _, g_tk = test_loss_grad(cnf, icnf_k, ps_np, xs, dev, ys=ys)
    torch.cuda.synchronize()
    n_test = launched(fs)
    check(n_test == {names["k3sc"][0]: 1, names["k5sc"][0]: 1} and all(bool(torch.isfinite(g).all()) for g in g_tk),
          f"cond_miniboone86 TEST loss gradient launched {n_test}")
    gen = torch.Generator(device=dev).manual_seed(SEED + 1205)
    n_steps = {}
    for label, icnf, p_np, x, y in (("cond_miniboone86", icnf_k, ps_np, xs, ys), (f"miniboone860 chain B={Bc}", icnf_c,
                                                                                   ps_c, xs_c, ys_c)):
        p = cnf.params_from_numpy(p_np, dev)
        leaves = [v.requires_grad_() for layer in p for v in (layer["w"], layer["b"])]
        step = cnf.parallel.make_train_step_body(icnf, cnf.Lion(leaves, lr=1e-3))
        fs.reset_launches()
        metrics = step(p, x, gen, ys=y)
        torch.cuda.synchronize()
        n_steps[label] = launched(fs)
        check(n_steps[label] == want and bool(torch.isfinite(metrics["loss"]))
              and all(bool(torch.isfinite(v).all()) for v in leaves), f"{label} train step launched {n_steps[label]}")
    X, Y = model_data("cond_miniboone86", rng, N_STEPS * B)
    fit_path(cnf, fs, icnf_k, ps_np, dev, X, Y, batch_size=B)
    n_fit = launched(fs)
    check(set(n_fit) == set(want) and min(n_fit.values()) >= N_STEPS, f"cond_miniboone86 fit launched {n_fit}")
    print(f"phase 116: cond_miniboone86 main paths: logpdf {n_serve['logpdf']} and sample {n_serve['sample']} "
          f"launches of {names['k3sc'][0]}, TEST loss gradient {n_test}, train steps {n_steps}, fit {n_fit}")
    small = slice(0, COND_TRUTH_BATCH)
    # What row (d5) refused runs now, through its COND instances (phases
    # 118-122 hold them).
    fs.reset_launches()
    _, g_e, _ = loss_grad(cnf, model(exact=True), ps_np, xs[small], dev, ys=ys[small])
    torch.cuda.synchronize()
    n_e = launched(fs)
    check(n_e == {fs.K7S_KERNEL + "/exact/cond": 1, fs.K4SA_KERNEL + "/cond": 1}
          and all(bool(torch.isfinite(g).all()) for g in g_e), f"cond_miniboone86 exact gradient launched {n_e}")
    fs.reset_launches()
    with torch.no_grad():
        lp_c = cnf.CondICNFDist(icnf_c, cnf.Mode.TEST, cnf.params_from_numpy(ps_c, dev),
                                ys_c[small]).logpdf(xs_c[small])
    torch.cuda.synchronize()
    n_lp = launched(fs)
    check(n_lp == {fs.K7S_KERNEL + "/test/cond": 1} and bool(torch.isfinite(lp_c).all()),
          f"the conditional miniboone860 chain's logpdf launched {n_lp}")
    print(f"phase 116: row (d5) runs: cond_miniboone86's exact loss gradient launched {n_e}, the conditional "
          f"miniboone860 chain's logpdf {n_lp}")
    # What row (d6) refused runs now, through the streamed probe COND
    # instances (phases 123-127 hold them).
    fs.reset_launches()
    _, g_2, _ = loss_grad(cnf, model(num_probes=2), ps_np, xs[small], dev, ys=ys[small])
    torch.cuda.synchronize()
    n_2 = launched(fs)
    probes_2 = [dict(names[key][1].probe_launches) for key in ("k1sc", "k2sc")]
    check(n_2 == want and probes_2 == [{(2, False): 1}] * 2 and all(bool(torch.isfinite(g).all()) for g in g_2),
          f"cond_miniboone86's two-probe gradient launched {n_2}, probe instances {probes_2}")
    print(f"phase 116: row (d6) runs: cond_miniboone86's loss gradient with two probes launched {n_2}, probe "
          f"instances {probes_2}")

    # Phase 117: CUDA-event times of the train step, `logpdf` and the TEST
    # loss gradient at cond_miniboone86, each beside miniboone86's in the
    # same run, a b b a.
    dist_u = cnf.ICNFDist(icnf_u, cnf.Mode.TEST, ps_u)
    ps_u_np = glorot_params(np.random.default_rng(SEED + 1202), MODELS["miniboone86"]["dims"])
    ms = {}
    for what, fa, fb in (
            ("train step", lambda: step_ms(cnf, icnf_k, ps_np, xs, gen, dev, 3, ys=ys),
             lambda: step_ms(cnf, icnf_u, ps_u_np, xs_u, gen, dev, 3)),
            ("logpdf", lambda: cuda_ms(lambda: dist.logpdf(xs), 3), lambda: cuda_ms(lambda: dist_u.logpdf(xs_u), 3)),
            ("TEST loss gradient", lambda: cuda_ms(lambda: test_loss_grad(cnf, icnf_k, ps_np, xs, dev, ys=ys), 3),
             lambda: cuda_ms(lambda: test_loss_grad(cnf, icnf_u, ps_u_np, xs_u, dev), 3))):
        with torch.no_grad() if what == "logpdf" else contextlib.nullcontext():
            a1, b1, b2, a2 = fa(), fb(), fb(), fa()
        ms[what] = ((a1 + a2) / 2, (b1 + b2) / 2)
        print(f"phase 117: {what} B={B}: cond_miniboone86 {ms[what][0]:.4f} ms, miniboone86 {ms[what][1]:.4f} ms, "
              f"ratio {ms[what][0] / ms[what][1]:.3f} (a b b a; other data: other step counts)")
    print(f"phase 117: cond_miniboone86 train step {B / ms['train step'][0] * 1e3:.1f} samples/s")

    fma, floats = cond_fma_floats(dims, nc, B)
    wide_keys = {"k3sc": "k3wc", "k5sc": "k5wc", "k1sc": "k1wc", "k2sc": "k2wc"}
    launches = {"k3sc": n_serve["logpdf"] + n_serve["sample"], "k5sc": n_test[names["k5sc"][0]],
                "k1sc": n_fit[names["k1sc"][0]], "k2sc": n_fit[names["k2sc"][0]]}
    records = []
    for key in roles.values():
        out, err, t_ms, pms = runs[key]
        name, _, _, src, at = names[key]
        records.append(kernel_record(name, src, at, launches[key], err, t_ms, pms, fma[wide_keys[key]], B,
                                     steps_of(out)[0], floats[wide_keys[key]], accepted=steps_of(out)[1]))
    fma_c, floats_c = cond_fma_floats(dims_c, 1, Bc)
    n_chain = n_steps[f"miniboone860 chain B={Bc}"]
    for key, (out, err, t_ms, pms) in runs_c.items():
        name, _, _, src, at = names[key]
        records.append(kernel_record(f"{name}/chain3", src, at, n_chain[name], err, t_ms, pms, fma_c[wide_keys[key]],
                                     Bc, steps_of(out)[0], floats_c[wide_keys[key]], accepted=steps_of(out)[1]))
    return records


# ---- K8 in streamed K7 and the streamed K4 adjoint ----


def cond_stream_exact_names(fs):
    """The conditional streamed exact and deep-chain paths' kernels: record
    key -> (KERNEL_WRAPPERS name, wrapper, twin, source, the TPU site)."""
    at = "continuousnf_tpu/ops/fused_solve.py:"
    return {
        "k7tc": (fs.K7S_KERNEL + "/test/cond", fs.run_stream_cond_test_solve_kernel, fs.solve_test_plain,
                 "k7_stream_solve.cu", at + "1043"),
        "k7ec": (fs.K7S_KERNEL + "/exact/cond", fs.run_stream_cond_exact_solve_kernel, fs.solve_train_exact_plain,
                 "k7_stream_solve.cu", at + "1043"),
        "k4wc": (fs.K4SA_KERNEL + "/cond", fs.run_stream_cond_exact_adjoint_kernel, fs.adjoint_train_exact_plain,
                 "k4_stream_adjoint.cu", at + "1767"),
    }


def cond_stream_exact(cnf, fs, dev, built):
    """Phases 118 to 122: cond_miniboone86 (CondRNODE, MLP 87 -> 258 -> 86 on
    [z | ys], B = 4096) under exact trace through the COND instances of
    streamed K7 exact and the streamed K4 adjoint (K8 in streamed K7 and in
    the streamed K4 adjoint), and cond_miniboone860 (MLP 44 -> 860 -> 860 ->
    43 on [z | ys], B = 1024) served through streamed K7 TEST's COND
    instance and trained under exact trace through streamed K7 exact's (its
    backward plain), beside miniboone86's and miniboone860's unconditional
    instances.  `built`: the build's {kernel: (library, nvcc log)}.  Returns
    the records."""
    import torch
    from continuousnf_tpu_torch.ode.tableaus import TSIT5
    from continuousnf_tpu_torch.utils.configs import MODELS, cuda_ms, glorot_params, make_icnf, model_data

    cfg = MODELS["cond_miniboone86"]
    dims, nc, B = cfg["dims"], cfg["n_cond"], BATCH
    rng = np.random.default_rng(SEED + 1300)
    ps_np = glorot_params(rng, dims)
    xs_np, ys_np = model_data("cond_miniboone86", rng, B)
    xs, ys = torch.from_numpy(xs_np).to(dev), torch.from_numpy(ys_np).to(dev)
    ps = cnf.params_from_numpy(ps_np, dev)
    model = lambda **kw: make_icnf("cond_miniboone86", dev, exact=True, **kw)  # noqa: E731
    icnf_k, icnf_p = model(), model(fused=False)
    spec = fs.chain_spec(icnf_k.nn, icnf_k.zdim)
    check(spec.n_cond == nc and fs._stream_two_layer(spec) and fs._stream_exact_covers(TSIT5, spec) is None,
          "cond_miniboone86 should run the COND instances of streamed K7 exact and the streamed K4 adjoint")
    names = cond_stream_exact_names(fs)
    cfg_c = MODELS["cond_miniboone860"]
    dims_c, Bc = cfg_c["dims"], cfg_c["batch"]
    rng_c = np.random.default_rng(SEED + 1301)
    ps_c = glorot_params(rng_c, dims_c)
    xs_c, ys_c = (torch.from_numpy(a).to(dev) for a in model_data("cond_miniboone860", rng_c, Bc))
    icnf_c, icnf_cp = make_icnf("cond_miniboone860", dev), make_icnf("cond_miniboone860", dev, fused=False)
    icnf_ce = make_icnf("cond_miniboone860", dev, exact=True)
    spec_c = fs.chain_spec(icnf_c.nn, icnf_c.zdim)
    check(fs._stream_chain(spec_c) and fs._kernel_covers(TSIT5, spec_c, chain=True) is None,
          "cond_miniboone860 should run streamed K7's COND instances")

    # Phase 118: the launch shapes at the paths' batches; ptxas's registers,
    # stack frame and spills of the COND instances beside the unconditional.
    for lib_name, fn, widths, b in ((fs.K7S_KERNEL, "cnf_k7sc_exact_shape", dims, B),
                                    (fs.K4SA_KERNEL, "cnf_k4sc_shape", dims, B),
                                    (fs.K7S_KERNEL, "cnf_k7sc_test_shape", dims_c, Bc),
                                    (fs.K7S_KERNEL, "cnf_k7sc_exact_shape", dims_c, Bc)):
        out = (ctypes.c_int * 5)()
        err = getattr(fs._library(lib_name), fn)(len(widths) - 1, (ctypes.c_int * len(widths))(*widths), b, out)
        check(err == 0 and out[1] >= 1, f"{fn} at {widths}: cudaError {err}")
        tile = f"tile {out[2]}" if fn == "cnf_k4sc_shape" else f"{out[2]} basis rows a chunk"
        print(f"phase 118: {fn} at widths {widths}, B={b}: {out[0]} threads a block, {out[1]} blocks, {tile}, "
              f"{out[3]} bytes of dynamic shared memory, {out[4]} floats of global tile scratch a block")
    for lib_name, parts in ((fs.K7S_KERNEL, ("20k7_stream_cond_solve", "15k7_stream_solve")),
                            (fs.K4SA_KERNEL, ("22k4_stream_cond_adjoint", "17k4_stream_adjoint",
                                              "23StreamExactCondAdjStage", "19StreamExactAdjStage"))):
        log = built.get(lib_name, (None, ""))[1]
        for part in parts:
            found = ptxas_report(log, part)
            if not found:
                print(f"phase 118: {part[2:]}: no ptxas lines (the library was not compiled by this process)")
            for fn, r in found.items():
                entry = "TEST" if "ILi1E" in fn else "exact" if "ILi3E" in fn else "one"
                print(f"phase 118: ptxas {part[2:]} ({entry}): {r.get('registers')} registers, {r.get('stack')} bytes "
                      f"stack frame, {r.get('spill_stores')} bytes spill stores, {r.get('spill_loads')} bytes spill "
                      "loads")

    # Phase 119: each COND instance against its twin, timed; then beside its
    # unconditional instance on miniboone86's or miniboone860's inputs, a b
    # b a, per attempted step.
    _, _, exact, cot = kernel_inputs(icnf_k, ps, xs, rng, dev)
    exact["ys"] = ys
    runs = {"k7ec": run_pair(f"{names['k7ec'][0]} (cond_miniboone86)", names["k7ec"][1], names["k7ec"][2], TSIT5,
                             spec, exact, reps=2)}
    adj = adjoint_kw(exact, runs["k7ec"][0], cot)
    runs["k4wc"] = run_pair(f"{names['k4wc'][0]} (cond_miniboone86)", names["k4wc"][1], names["k4wc"][2], TSIT5, spec,
                            adj, adjoint=True, reps=2)
    out = runs["k4wc"][0]
    check(len(out) == 8 and tuple(out[7].shape) == (B, nc) and float(out[3][0][dims[-1]:].abs().max()) > 0.0,
          f"{names['k4wc'][0]} returned no a_ys0 or a zero gradient for W1's ys rows")
    ps_ct = cnf.params_from_numpy(ps_c, dev)
    test_c, _, exact_c, _ = kernel_inputs(icnf_ce, ps_ct, xs_c, rng_c, dev)
    test_c["ys"], exact_c["ys"] = ys_c, ys_c
    runs_c = {key: run_pair(f"{names[key][0]} (cond_miniboone860, B={Bc})", names[key][1], names[key][2], TSIT5,
                            spec_c, kw, reps=2) for key, kw in (("k7tc", test_c), ("k7ec", exact_c))}
    rng_u = np.random.default_rng(SEED + 1302)
    icnf_u = make_icnf("miniboone86", dev, exact=True)
    spec_u = fs.chain_spec(icnf_u.nn, icnf_u.zdim)
    ps_u_np = glorot_params(rng_u, MODELS["miniboone86"]["dims"])
    xs_u = torch.from_numpy(model_data("miniboone86", rng_u, B)).to(dev)
    _, _, exact_u, cot_u = kernel_inputs(icnf_u, cnf.params_from_numpy(ps_u_np, dev), xs_u, rng_u, dev)
    rng_v = np.random.default_rng(SEED + 1303)
    icnf_v = make_icnf("miniboone860", dev, exact=True)
    spec_v = fs.chain_spec(icnf_v.nn, icnf_v.zdim)
    ps_v_np = glorot_params(rng_v, MODELS["miniboone860"]["dims"])
    xs_v = torch.from_numpy(model_data("miniboone860", rng_v, Bc)).to(dev)
    test_v, _, exact_v, _ = kernel_inputs(icnf_v, cnf.params_from_numpy(ps_v_np, dev), xs_v, rng_v, dev)
    with torch.no_grad():
        out_u = fs.run_stream_exact_solve_kernel(TSIT5, spec_u, **exact_u)
        adj_u = adjoint_kw(exact_u, out_u, cot_u)
        pairs = {
            "k7ec": (lambda: names["k7ec"][1](TSIT5, spec, **exact), runs["k7ec"][0],
                     lambda: fs.run_stream_exact_solve_kernel(TSIT5, spec_u, **exact_u), out_u, "miniboone86"),
            "k4wc": (lambda: names["k4wc"][1](TSIT5, spec, **adj), runs["k4wc"][0],
                     lambda: fs.run_stream_exact_adjoint_kernel(TSIT5, spec_u, **adj_u),
                     fs.run_stream_exact_adjoint_kernel(TSIT5, spec_u, **adj_u), "miniboone86"),
            "k7tc/chain3": (lambda: names["k7tc"][1](TSIT5, spec_c, **test_c), runs_c["k7tc"][0],
                            lambda: fs.run_stream_test_solve_kernel(TSIT5, spec_v, **test_v),
                            fs.run_stream_test_solve_kernel(TSIT5, spec_v, **test_v), "miniboone860"),
            "k7ec/chain3": (lambda: names["k7ec"][1](TSIT5, spec_c, **exact_c), runs_c["k7ec"][0],
                            lambda: fs.run_stream_exact_solve_kernel(TSIT5, spec_v, **exact_v),
                            fs.run_stream_exact_solve_kernel(TSIT5, spec_v, **exact_v), "miniboone860"),
        }
        for key, (fa, out_a, fb, out_b, other) in pairs.items():
            ms_a, ms_b = paired_ms(fa, fb, 2)
            n_a, n_b = int(steps_of(out_a)[0]), int(steps_of(out_b)[0])
            us_a, us_b = ms_a * 1e3 / n_a, ms_b * 1e3 / n_b
            print(f"phase 119: {key} {ms_a:.4f} ms ({n_a} steps, {us_a:.1f} us a step) beside the unconditional "
                  f"instance {ms_b:.4f} ms on {other} ({n_b} steps, {us_b:.1f} us a step), a b b a: "
                  f"{100.0 * (us_a / us_b - 1.0):+.1f} % a step")
    print("phase 119: the COND instances of streamed K7 and the streamed K4 adjoint held to their twins")

    # Phase 120: cond_miniboone86's exact loss and gradients (params and ys)
    # at B = 256 against the plain path and a float64 rtol 1e-7 solve.
    b = COND_TRUTH_BATCH
    truth = cnf.SolverOptions(rtol=1e-7, atol=1e-9)
    steer = {"steer_r": 0.05}
    want = {names["k7ec"][0]: 1, names["k4wc"][0]: 1}
    fs.reset_launches()
    l_k, g_k, _ = loss_grad(cnf, icnf_k, ps_np, xs[:b], dev, ys=ys[:b], **steer)
    torch.cuda.synchronize()
    check(launched(fs) == want, f"cond_miniboone86 exact gradient launched {launched(fs)}, expected {want}")
    l_p, g_p, _ = loss_grad(cnf, icnf_p, ps_np, xs[:b], dev, ys=ys[:b], **steer)
    l_t, g_t, _ = loss_grad(cnf, model(fused=False, dtype=torch.float64, solver=truth), ps_np, xs[:b], dev,
                            torch.float64, ys=ys[:b], **steer)
    torch.cuda.synchronize()
    hold_gradients(f"cond_miniboone86 exact B={b}", l_k, g_k, l_p, g_p, l_t, g_t, names=["w1", "b1", "w2", "b2", "ys"])
    print("phase 120: cond_miniboone86 exact gradients held to the float64 solve")

    # Phase 121: the main paths, counters reset just before each.
    gen = torch.Generator(device=dev).manual_seed(SEED + 1304)
    p = cnf.params_from_numpy(ps_np, dev)
    leaves = [x.requires_grad_() for layer in p for x in (layer["w"], layer["b"])]
    step = cnf.parallel.make_train_step_body(icnf_k, cnf.Lion(leaves, lr=1e-3))
    fs.reset_launches()
    metrics = step(p, xs, gen, ys=ys)
    torch.cuda.synchronize()
    n_step = launched(fs)
    check(n_step == want and bool(torch.isfinite(metrics["loss"])) and all(bool(torch.isfinite(x).all())
                                                                            for x in leaves),
          f"cond_miniboone86 exact train step launched {n_step}, loss {float(metrics['loss'])}")
    X, Y = model_data("cond_miniboone86", rng, N_STEPS * B)
    fit_path(cnf, fs, icnf_k, ps_np, dev, X, Y, batch_size=B)
    n_fit = launched(fs)
    check(set(n_fit) == set(want) and min(n_fit.values()) >= N_STEPS, f"cond_miniboone86 exact fit launched {n_fit}")
    dist_c = cnf.CondICNFDist(icnf_c, cnf.Mode.TEST, ps_ct, ys_c)
    n_serve = {}
    for what, call in (("logpdf", lambda: dist_c.logpdf(xs_c)),
                       ("sample", lambda: dist_c.sample(Bc, generator=torch.Generator(device=dev).manual_seed(
                           SEED + 1305)))):
        fs.reset_launches()
        with torch.no_grad():
            out = call()
        torch.cuda.synchronize()
        n = launched(fs)
        check(n == {names["k7tc"][0]: 1} and bool(torch.isfinite(out).all()), f"cond_miniboone860 {what} launched {n}")
        n_serve[what] = n[names["k7tc"][0]]
    with torch.no_grad():
        lp_k, _, st_k = cnf.inference(icnf_c, cnf.Mode.TEST, xs_c, ps_ct, ys=ys_c)
        lp_p, _, st_p = cnf.inference(icnf_cp, cnf.Mode.TEST, xs_c, ps_ct, ys=ys_c)
    dlp = float((lp_k - lp_p).abs().max())
    check(dlp <= TOL * max(1.0, float(lp_p.abs().max())), f"cond_miniboone860 logpdf differs from the plain path by "
          f"{dlp}")
    print(f"phase 121: cond_miniboone860 logpdf B={Bc}: max|dlogp| against the plain path {dlp:.3e}, steps "
          f"{int(st_k.steps)} (plain {int(st_p.steps)}; the kernel is held to its twin in phase 119)")
    p_c = cnf.params_from_numpy(ps_c, dev)
    leaves_c = [x.requires_grad_() for layer in p_c for x in (layer["w"], layer["b"])]
    step_c = cnf.parallel.make_train_step_body(icnf_ce, cnf.Lion(leaves_c, lr=1e-3))
    fs.reset_launches()
    metrics_c = step_c(p_c, xs_c, gen, ys=ys_c)
    torch.cuda.synchronize()
    n_c = launched(fs)
    check(n_c == {names["k7ec"][0]: 1} and bool(torch.isfinite(metrics_c["loss"]))
          and all(bool(torch.isfinite(x).all()) for x in leaves_c), f"cond_miniboone860's exact step launched {n_c}")
    print(f"phase 121: cond_miniboone86 exact train step launched {n_step}, exact fit {n_fit}; cond_miniboone860 "
          f"logpdf and sample {n_serve}, exact train step {n_c} (loss {float(metrics_c['loss']):.6f}, the backward "
          "plain)")

    # Phase 122: CUDA-event times beside the unconditional models' in the
    # same run (a, b, b, a).
    ps_v = cnf.params_from_numpy(ps_v_np, dev)
    dist_v = cnf.ICNFDist(make_icnf("miniboone860", dev), cnf.Mode.TEST, ps_v)
    for what, fa, fb in (
            ("exact train step B=4096: cond_miniboone86", lambda: step_ms(cnf, icnf_k, ps_np, xs, gen, dev, 2, ys=ys),
             lambda: step_ms(cnf, icnf_u, ps_u_np, xs_u, gen, dev, 2)),
            (f"logpdf B={Bc}: cond_miniboone860", lambda: cuda_ms(lambda: dist_c.logpdf(xs_c), 2),
             lambda: cuda_ms(lambda: dist_v.logpdf(xs_v), 2))):
        with torch.no_grad() if what.startswith("logpdf") else contextlib.nullcontext():
            a1, b1, b2, a2 = fa(), fb(), fb(), fa()
        ms_a, ms_b = (a1 + a2) / 2, (b1 + b2) / 2
        print(f"phase 122: {what} {ms_a:.4f} ms, the unconditional model {ms_b:.4f} ms, ratio {ms_a / ms_b:.3f} "
              "(a b b a; other data: other step counts)")

    records = []
    fma, floats = cond_exact_fma_floats(dims, nc, B)
    launches = {"k7ec": n_fit[names["k7ec"][0]], "k4wc": n_fit[names["k4wc"][0]]}
    for key, (out, err, ms, pms) in runs.items():
        name, _, _, src, at = names[key]
        records.append(kernel_record(name, src, at, launches[key], err, ms, pms, fma[key], B, steps_of(out)[0],
                                     floats[key], accepted=steps_of(out)[1]))
    fma_c, floats_c = cond_exact_fma_floats(dims_c, 1, Bc)
    launches_c = {"k7tc": n_serve["logpdf"] + n_serve["sample"], "k7ec": n_c[names["k7ec"][0]]}
    for key, (out, err, ms, pms) in runs_c.items():
        name, _, _, src, at = names[key]
        records.append(kernel_record(name if key == "k7tc" else f"{name}/chain3", src, at, launches_c[key], err, ms,
                                     pms, fma_c[key], Bc, steps_of(out)[0], floats_c[key], accepted=steps_of(out)[1]))
    return records



# ---- K6 x K8 in the streamed forms: conditional K-probe and JVP training past the wide limits ----

PROBE_ONLY_COND_DIMS = (65, 128, 128, 120, 64)  # phase 126: the wide COND forms keep it with one probe, not with K
STREAM_COND_PROBE_PATHS = ((4, False), (1, True))  # phase 124's holds and phase 126's train steps


def cond_stream_probe_names(fs):
    """The streamed probe COND instances' record keys -> (KERNEL_WRAPPERS
    name, wrapper, twin, source, the TPU site); their launches are the
    wrappers' `.probe_launches[(K, jvp)]`."""
    at = "continuousnf_tpu/ops/fused_solve.py:"
    return {
        "k1spc": (fs.K1S_KERNEL + "/cond", fs.run_stream_cond_train_solve_kernel, fs.solve_train_plain,
                  "k1_stream_solve.cu", at + "1043"),
        "k2spc": (fs.K2S_KERNEL + "/cond", fs.run_stream_cond_adjoint_kernel, fs.adjoint_train_plain,
                  "k2_stream_adjoint.cu", at + "1767"),
    }


def cond_stream_probes(cnf, fs, dev, built):
    """Phases 123 to 127: K-probe and JVP Hutchinson training of conditional
    nets past the wide limits (K6 x K8 in the streamed forms) through the
    probe COND instances of the streamed K1 and K2 chain forms:
    cond_miniboone86 (CondRNODE, MLP 87 -> 258 -> 86 on [z | ys], B = 4096)
    at K = 4 and under JVP, cond_miniboone860 (MLP 44 -> 860 -> 860 -> 43 on
    [z | ys], B = 1024) at K = 4 and under JVP, and MLP 65 -> 128 -> 128 ->
    120 -> 64 with one ys column at K = 2 (a wide chain past the wide probe
    COND instances' shared memory); the ys = 0 yardstick against the
    unconditional streamed probe instances on the same weights.  `built`:
    the build's {kernel: (library, nvcc log)}.  Returns the records."""
    import torch
    from continuousnf_tpu_torch.ode.tableaus import TSIT5
    from continuousnf_tpu_torch.utils.configs import MODELS, glorot_params, make_icnf, model_data

    names = cond_stream_probe_names(fs)
    run1, run2 = names["k1spc"][1], names["k2spc"][1]
    want = {names["k1spc"][0]: 1, names["k2spc"][0]: 1}

    def probe_counts():
        return [dict(w.probe_launches) for w in (run1, run2)]

    nets = {}
    for label, seed in (("cond_miniboone86", 1400), ("cond_miniboone860", 1401)):
        cfg = MODELS[label]
        b = cfg.get("batch", BATCH)
        rng = np.random.default_rng(SEED + seed)
        ps_np = glorot_params(rng, cfg["dims"])
        xs, ys = (torch.from_numpy(a).to(dev) for a in model_data(label, rng, b))
        nets[label] = (cfg["dims"], b, ps_np, xs, ys, rng)
    model = lambda label, k=1, jvp=False, **kw: make_icnf(label, dev, num_probes=k,  # noqa: E731
                                                          ad="jvp" if jvp else "vjp", **kw)
    dims_o, b_o = PROBE_ONLY_COND_DIMS, PROBE_ONLY_BATCH
    rng_o = np.random.default_rng(SEED + 1402)
    ps_o = glorot_params(rng_o, dims_o)
    xs_o = torch.from_numpy(rng_o.normal(size=(b_o, 32)).astype("float32")).to(dev)
    ys_o = torch.from_numpy(rng_o.uniform(-1.0, 1.0, (b_o, 1)).astype("float32")).to(dev)
    icnf_o = cnf.construct(cnf.CondRNODE, cnf.MLP(dims_o, device=dev), 32, 32, tspan=(0.0, 1.0),
                           compute_mode=cnf.VecJacMode(2, fused=True))
    for label, icnf in (("cond_miniboone86", model("cond_miniboone86", 4)),
                        ("cond_miniboone860", model("cond_miniboone860", 4)), ("MLP 65-128-128-120-64", icnf_o)):
        spec = fs.chain_spec(icnf.nn, icnf.zdim)
        check(spec.n_cond == 1 and fs._stream_chain(spec, True)
              and all(fs._kernel_covers(TSIT5, spec, k, chain=True, jvp=jvp) is None for k, jvp in PROBE_CONFIGS),
              f"{label} with probes should run the streamed probe COND instances")
    check(not fs._stream_chain(fs.chain_spec(icnf_o.nn, icnf_o.zdim)),
          "MLP 65-128-128-120-64 with one ys column should keep the wide COND instances with one probe")

    # Phase 123: the launch shapes at the paths' batches (K is a run-time
    # argument: one shape for every K); ptxas's registers, stack frames and
    # spills beside the probe instances'.
    for lib_name, fn in ((fs.K1S_KERNEL, "cnf_k1spc_shape"), (fs.K2S_KERNEL, "cnf_k2spc_shape")):
        for widths, b in ((nets["cond_miniboone86"][0], BATCH), (nets["cond_miniboone860"][0], nets[
                "cond_miniboone860"][1]), (dims_o, b_o)):
            out = (ctypes.c_int * 5)()
            err = getattr(fs._library(lib_name), fn)(len(widths) - 1, (ctypes.c_int * len(widths))(*widths), b, out)
            check(err == 0 and out[1] >= 1, f"{fn} at {widths}: cudaError {err}")
            print(f"phase 123: {fn} at widths {widths}, B={b}, every K: {out[0]} threads a block, {out[1]} blocks, "
                  f"tile {out[2]}, {out[3]} bytes of dynamic shared memory, {out[4]} floats of global tile scratch a "
                  "block")
    for lib_name, parts in ((fs.K1S_KERNEL, ("26k1_stream_probe_cond_solve", "21k1_stream_probe_solve")),
                            (fs.K2S_KERNEL, ("28k2_stream_probe_cond_adjoint", "23k2_stream_probe_adjoint",
                                             "20StreamProbeCondStage", "16StreamProbeStage"))):
        log = built.get(lib_name, (None, ""))[1]
        for part in parts:
            found = ptxas_report(log, part)
            if not found:
                print(f"phase 123: {part[2:]}: no ptxas lines (the library was not compiled by this process)")
            for fn, r in found.items():
                member = re.match(r"(\d+)(\w+)", fn.split(part)[-1])  # a stage's call: its mangled member name
                what = part[2:] + (f"::{member.group(2)[:int(member.group(1))]}" if member else "")
                print(f"phase 123: ptxas {what}: {r.get('registers')} registers, {r.get('stack')} bytes stack frame, "
                      f"{r.get('spill_stores')} bytes spill stores, {r.get('spill_loads')} bytes spill loads")

    # Phase 124: each probe COND instance against its twin (the forward from
    # nonzero accumulators, the adjoint from its output warm-started from its
    # last step; two timed calls each) at cond_miniboone86 (K = 4, JVP) and
    # cond_miniboone860 (K = 4); then the ys = 0 yardstick: the COND instance
    # with ys = 0 and W0's ys rows 0 against the unconditional streamed probe
    # instance on the same weights without those rows (the same field on the
    # same data), a b b a, per attempted step.
    held = {}
    for label, k, jvp in (("cond_miniboone86", 4, False), ("cond_miniboone86", 1, True),
                          ("cond_miniboone860", 4, False)):
        d, b, p_np, x, y, rng = nets[label]
        icnf = model(label, k, jvp)
        spec = fs.chain_spec(icnf.nn, icnf.zdim)
        dz = icnf.zdim
        _, train, _, cot = kernel_inputs(icnf, cnf.params_from_numpy(p_np, dev), x, rng, dev)
        eps = torch.from_numpy(rng.normal(size=(k, b, dz)).astype("float32")).to(dev)
        kw1 = dict(train, eps=eps, jvp=jvp, ys=y)
        tag = f"{probe_tag(k, jvp)} ({label}, B={b})"
        r1 = run_pair(f"{names['k1spc'][0]} {tag}", run1, fs.solve_train_plain, TSIT5, spec, kw1, reps=2)
        r2 = run_pair(f"{names['k2spc'][0]} {tag}", run2, fs.adjoint_train_plain, TSIT5, spec,
                      adjoint_kw(kw1, r1[0], cot), adjoint=True, reps=2, grad_tol=COND_PROBE_GRAD_TOL)
        out2 = r2[0]
        check(len(out2) == 8 and tuple(out2[7].shape) == (b, 1) and float(out2[3][0][dz:].abs().max()) > 0.0,
              f"{tag}: the probe COND adjoint returned no a_ys0 or a zero gradient for W0's ys rows")
        held[(label, k, jvp)] = (r1, r2)
        # The yardstick's inputs: ys = 0 and W0's ys rows 0 (COND), W0's z
        # rows alone (unconditional).
        ws0 = [w.clone() for w in kw1["ws"]]
        ws0[0][dz:] = 0.0
        kc = dict(kw1, ws=ws0, ys=torch.zeros_like(y))
        ku = dict({n: v for n, v in kw1.items() if n != "ys"}, ws=[ws0[0][:dz].contiguous()] + ws0[1:])
        spec_u = fs.chain_spec(cnf.MLP((dz,) + tuple(d[1:]), device=dev), dz)
        with torch.no_grad():
            oc1, ou1 = run1(TSIT5, spec, **kc), fs.run_stream_train_solve_kernel(TSIT5, spec_u, **ku)
            ac, au = adjoint_kw(kc, oc1, cot), adjoint_kw(ku, ou1, cot)
            oc2, ou2 = run2(TSIT5, spec, **ac), fs.run_stream_adjoint_kernel(TSIT5, spec_u, **au)
            # K2: z0, a_z0 and the gradient (W0's z rows against the
            # unconditional W0); W0's ys rows' gradient and a_ys0 are 0.
            d1 = max(rel_err(oc1[0], ou1[0]), rel_err(oc1[1], ou1[1]))
            pairs = [(oc2[0], ou2[0]), (oc2[2], ou2[2]), (oc2[3][0][:dz], ou2[3][0])] + list(
                zip(oc2[3][1:] + oc2[4], ou2[3][1:] + ou2[4]))
            d2 = max(rel_err(a, c) for a, c in pairs)
            zero = float(oc2[3][0][dz:].abs().max()) == 0.0 and float(oc2[7].abs().max()) == 0.0
            n = (int(oc1[2]), int(ou1[2]), int(oc2[5]), int(ou2[5]))
            # The adjoints' norms count the a_ys rows and W0's ys rows (0
            # here) among their elements, so their step sizes may part at
            # roundoff: values are held where the steps agree.
            same = n[0] == n[1] and n[2] == n[3]
            check(abs(n[0] - n[1]) <= 1 and abs(n[2] - n[3]) <= 1 and zero
                  and (not same or (d1 <= TOL and d2 <= GRAD_TOL)),
                  f"{tag} yardstick: steps {n}, relative differences {d1:.3e} / {d2:.3e}, ys parts 0: {zero}")
            m1 = paired_ms(lambda: run1(TSIT5, spec, **kc), lambda: fs.run_stream_train_solve_kernel(TSIT5, spec_u,
                                                                                                  **ku), 2)
            m2 = paired_ms(lambda: run2(TSIT5, spec, **ac), lambda: fs.run_stream_adjoint_kernel(TSIT5, spec_u, **au),
                           2)
        us = (m1[0] * 1e3 / n[0], m1[1] * 1e3 / n[1], m2[0] * 1e3 / n[2], m2[1] * 1e3 / n[3])
        print(f"phase 124: yardstick {tag}: steps K1 {n[0]} / {n[1]}, K2 {n[2]} / {n[3]}; relative "
              f"differences {d1:.3e} (K1 z) / {d2:.3e} (K2); per attempted step, COND ys = 0 against the "
              f"unconditional probe instance: K1 {us[0]:.1f} / {us[1]:.1f} us ({100.0 * (us[0] / us[1] - 1.0):+.1f} "
              f"%), K2 {us[2]:.1f} / {us[3]:.1f} us ({100.0 * (us[2] / us[3] - 1.0):+.1f} %), a b b a")
    print("phase 124: the streamed probe COND instances held to their twins")

    # Phase 125: cond_miniboone86's K = 4 loss gradient in the params and ys
    # at B = 256 against the plain path and a float64 rtol 1e-7 solve.
    d, b, p_np, x, y, _ = nets["cond_miniboone86"]
    bt = STREAM_PROBE_TRUTH_BATCH
    truth = cnf.SolverOptions(rtol=1e-7, atol=1e-9)
    steer = {"steer_r": 0.05}
    eps = model("cond_miniboone86", 4).draw_eps(torch.Generator(device=dev).manual_seed(SEED + 1403), bt, dev)
    fs.reset_launches()
    l_k, g_k, _ = loss_grad(cnf, model("cond_miniboone86", 4), p_np, x[:bt], dev, ys=y[:bt], eps=eps, **steer)
    torch.cuda.synchronize()
    check(launched(fs) == want and probe_counts() == [{(4, False): 1}] * 2,
          f"cond_miniboone86 K4 gradient launched {launched(fs)}, probe instances {probe_counts()}")
    l_p, g_p, _ = loss_grad(cnf, model("cond_miniboone86", 4, fused=False), p_np, x[:bt], dev, ys=y[:bt], eps=eps,
                            **steer)
    l_t, g_t, _ = loss_grad(cnf, model("cond_miniboone86", 4, fused=False, dtype=torch.float64, solver=truth), p_np,
                            x[:bt], dev, torch.float64, ys=y[:bt], eps=eps.double(), **steer)
    torch.cuda.synchronize()
    hold_gradients(f"cond_miniboone86 K4 B={bt}", l_k, g_k, l_p, g_p, l_t, g_t, names=["w1", "b1", "w2", "b2", "ys"])
    check(float(g_k[0][d[-1]:].abs().max()) > 0.0, "cond_miniboone86 K4: a zero gradient for W1's ys rows")
    print(f"phase 125: cond_miniboone86 K4 B={bt}: loss fused {float(l_k):.6f} plain {float(l_p):.6f} float64 "
          f"{float(l_t):.6f}; gradients held to the float64 solve")

    # Phase 126: the main paths, counters reset just before each: the K = 4
    # and JVP train steps of cond_miniboone86 and cond_miniboone860, the
    # K = 2 train step of MLP 65-128-128-120-64, cond_miniboone86's K = 4
    # fit; each launches the streamed probe COND instances alone, under its
    # (K, jvp).
    gen = torch.Generator(device=dev).manual_seed(SEED + 1404)
    steps = {}
    paths = [(label, model(label, k, jvp), nets[label][2], nets[label][3], nets[label][4], (k, jvp))
             for label in ("cond_miniboone86", "cond_miniboone860") for k, jvp in STREAM_COND_PROBE_PATHS]
    paths.append(("MLP 65-128-128-120-64", icnf_o, ps_o, xs_o, ys_o, (2, False)))
    for label, icnf, p_np, x, y, key in paths:
        p = cnf.params_from_numpy(p_np, dev)
        leaves = [v.requires_grad_() for layer in p for v in (layer["w"], layer["b"])]
        step = cnf.parallel.make_train_step_body(icnf, cnf.Lion(leaves, lr=1e-3))
        fs.reset_launches()
        metrics = step(p, x, gen, ys=y)
        torch.cuda.synchronize()
        counts = probe_counts()
        check(launched(fs) == want and counts == [{key: 1}] * 2 and bool(torch.isfinite(metrics["loss"]))
              and all(bool(torch.isfinite(v).all()) for v in leaves),
              f"{label} {probe_tag(*key)} train step launched {launched(fs)}, probe instances {counts}")
        steps[(label,) + key] = counts
    d, b, p_np, x, y, rng = nets["cond_miniboone86"]
    X, Y = model_data("cond_miniboone86", rng, N_STEPS * b)
    fit_path(cnf, fs, model("cond_miniboone86", 4), p_np, dev, X, Y, batch_size=b)
    n_fit = probe_counts()
    check(set(launched(fs)) == set(want) and all(set(c) == {(4, False)} and c[(4, False)] >= N_STEPS for c in n_fit),
          f"cond_miniboone86 K4 fit launched {launched(fs)}, probe instances {n_fit}")
    print(f"phase 126: train steps {steps}; cond_miniboone86 K4 fit ({N_STEPS} Lion steps at B={b}) "
          f"{[c[(4, False)] for c in n_fit]}; each launched the streamed probe COND instances alone")

    # Phase 127: CUDA-event times of cond_miniboone86's K = 4 train step
    # beside miniboone86's K = 4 step, in the same run (a, b, b, a).
    rng_u = np.random.default_rng(SEED + 1405)
    ps_u = glorot_params(rng_u, MODELS["miniboone86"]["dims"])
    xs_u = torch.from_numpy(model_data("miniboone86", rng_u, BATCH)).to(dev)
    icnf_u = make_icnf("miniboone86", dev, num_probes=4)
    icnf_c = model("cond_miniboone86", 4)
    a1 = step_ms(cnf, icnf_c, p_np, x, gen, dev, 2, ys=y)
    b1 = step_ms(cnf, icnf_u, ps_u, xs_u, gen, dev, 2)
    b2 = step_ms(cnf, icnf_u, ps_u, xs_u, gen, dev, 2)
    a2 = step_ms(cnf, icnf_c, p_np, x, gen, dev, 2, ys=y)
    ms_c, ms_u = (a1 + a2) / 2, (b1 + b2) / 2
    print(f"phase 127: K = 4 train step B={BATCH}: cond_miniboone86 {ms_c:.4f} ms ({BATCH / ms_c * 1e3:.1f} "
          f"samples/s), miniboone86 {ms_u:.4f} ms ({BATCH / ms_u * 1e3:.1f} samples/s); ratio {ms_c / ms_u:.3f} "
          "(other data: other step counts)")

    records = []
    launches = {("cond_miniboone86", 4, False): [c[(4, False)] for c in n_fit],
                ("cond_miniboone86", 1, True): [c[(1, True)] for c in steps[("cond_miniboone86", 1, True)]],
                ("cond_miniboone860", 4, False): [c[(4, False)] for c in steps[("cond_miniboone860", 4, False)]]}
    for (label, k, jvp), (r1, r2) in held.items():
        d, b = nets[label][0], nets[label][1]
        fma, floats = cond_probe_fma_floats(d, d[0] - d[-1], k, b)
        suffix = "" if label == "cond_miniboone86" else "/chain3"
        for key, wkey, (out, err, ms, pms), n in zip(("k1spc", "k2spc"), ("k1wpc", "k2wpc"), (r1, r2),
                                                      launches[(label, k, jvp)]):
            name, _, _, src, at = names[key]
            records.append(kernel_record(f"{name}/{probe_tag(k, jvp)}{suffix}", src, at, n, err, ms, pms, fma[wkey],
                                         b, steps_of(out)[0], floats[wkey], accepted=steps_of(out)[1]))
    return records


# ---- chains of every depth: 1-layer nets and chains of 5 to 8 layers ----

#: Phases 128-133's configurations (utils/configs.py) and the form of the
#: chain kernels each runs: the narrow forms, "wide" or "stream".
DEPTH_MODELS = {
    "refbench16": "narrow", "cond_refbench16": "narrow", "deep8_narrow": "narrow", "deep5_power6": "wide",
    "deep8_power6": "wide", "deep5_miniboone43": "wide", "deep5_miniboone128": "stream",
    "deep5_miniboone860": "stream", "cond_deep5_miniboone860": "stream",
}
DEPTH_PROBES = ((4, False), (1, True))  # the probe instances held at each depth configuration
#: The gradient each depth configuration holds to a float64 rtol 1e-7 solve:
#: (probes K, JVP?, batch).  refbench16's K = 4 gradient at its batch; the
#: others' one-probe gradient at 256 samples, cond_refbench16's K = 4 one.
DEPTH_TRUTH = {"refbench16": (4, False, 4096), "cond_refbench16": (4, False, 256)}
DEPTH_TRUTH_DEFAULT = (1, False, 256)
#: Phase 133's prediction, written before the first timed run: the 5-layer
#: streamed K2 chain form at 860 wide does 2,292,760 FMA a field against the
#: 3-layer one's 813,560, whose step took 52,204.9 us (PERF.md, PR 13), so
#: about 2.8x that a step if its time follows its FMA.
DEPTH_K2S_PREDICTED_US = 52_204.9 * 2_292_760 / 813_560


def hold_depth_gradients(label, l_k, g_k, l_p, g_p, l_t, g_t, names=None):
    """The fused and plain losses within 1e-4 relative, and each fused
    gradient held to the float64 rtol 1e-7 solve by `hold_test_gradients`'
    rule: within SOLVE_REL * max|g|, or within 2x the plain path's own
    distance where the plain path (the same method at the same tolerances,
    float32) is itself farther than that.  cond_refbench16 over tspan
    (0, 13) is such a case: its plain K = 4 gradient sits 3.5e-2 (w1) and
    4.3e-2 (ys) max|g| from the float64 solve at B = 256, the method's own
    accuracy at rtol 1e-3."""
    check(abs(float(l_k - l_p)) <= TOL * max(1.0, abs(float(l_p))), f"{label} losses {float(l_k)} vs {float(l_p)}")
    names = names or [f"{x}{i + 1}" for i in range(len(g_t) // 2) for x in ("w", "b")]
    hold_test_gradients(label, names, g_k, g_p, g_t)


def depth_names(fs, form, cond):
    """The four chain kernels of a form ("narrow", "wide" or "stream") and,
    for a conditional chain past the narrow forms, their COND instances:
    record key (k1c, k2c, k7t, k7e) -> (KERNEL_WRAPPERS name, wrapper,
    source).  The narrow forms take conditional chains in the same
    wrappers."""
    names = chain_names(fs, wide=form == "wide", stream=form == "stream")
    if form == "narrow" or not cond:
        return names
    pre = f"run_{form}_cond_"
    wrappers = {"k1c": pre + "train_solve_kernel", "k2c": pre + "adjoint_kernel", "k7t": pre + "test_solve_kernel",
                "k7e": pre + "exact_solve_kernel"}
    return {key: (name + "/cond", getattr(fs, wrappers[key]), src) for key, (name, _, src) in names.items()}


def depth_records(name, dims, nc, B, names, runs, launches, held, probe_launches):
    """The records of a depth configuration's four chain kernels (`runs`,
    `launches`) and of their probe instances at DEPTH_PROBES (`held`,
    `probe_launches`), each name ending in the configuration's."""
    fma = chain_fma(dims, nc)
    dz = dims[-1]
    P = sum(a * b + b for a, b in zip(dims[:-1], dims[1:]))
    floats = {"k1c": P + B * (3 * dz + 6 + nc), "k2c": 2 * P + B * (5 * dz + 9 + 2 * nc),
              "k7t": P + B * (2 * dz + 2 + nc), "k7e": P + B * (2 * dz + 6 + nc)}
    at = {"k1c": 1043, "k2c": 1767, "k7t": 1043, "k7e": 1043}
    records = []
    for key, (out, err, ms, pms) in runs.items():
        kname, _, src = names[key]
        records.append(kernel_record(f"{kname}/{name}", src, f"continuousnf_tpu/ops/fused_solve.py:{at[key]}",
                                     launches[key], err, ms, pms, fma[key], B, steps_of(out)[0], floats[key],
                                     accepted=steps_of(out)[1]))
    for (k, jvp), pair in held.items():
        records += probe_records(dims, k, jvp, pair, probe_launches[(k, jvp)], (names["k1c"][0], names["k2c"][0]),
                                 (names["k1c"][2], names["k2c"][2]), ("k1c", "k2c"), B, suffix=name, n_cond=nc)
    return records


def depth_model(cnf, fs, dev, name, rng, phase, reps=3, probes=DEPTH_PROBES, fit=False):
    """One depth configuration (DEPTH_MODELS) under `phase`: its four chain
    kernels of its form (COND instances for a conditional chain) and their
    probe instances at `probes` against their twins, each timed over `reps`
    calls; `logpdf` against the plain path; the main paths with the
    counters reset just before each (serving launches K7 TEST alone, the
    Hutchinson, K-probe, JVP and exact loss gradients their kernels once
    each; with `fit`, `fit` and the exact `fit` for four Lion steps); the
    loss gradient of DEPTH_TRUTH (params and ys) against a float64 rtol
    1e-7 solve (`hold_depth_gradients`).  Returns (records, the model's
    (ps_np, xs, ys), the microseconds per attempted step of each held
    kernel)."""
    import torch
    from continuousnf_tpu_torch.ode.tableaus import TSIT5
    from continuousnf_tpu_torch.utils.configs import MODELS, glorot_params, make_icnf, model_data

    cfg, form = MODELS[name], DEPTH_MODELS[name]
    dims, B, nc = cfg["dims"], cfg.get("batch", BATCH), cfg.get("n_cond", 0)
    ps_np = glorot_params(rng, dims)
    data = model_data(name, rng, B)
    xs, ys = (torch.from_numpy(a).to(dev) for a in data) if nc else (torch.from_numpy(data).to(dev), None)
    ps = cnf.params_from_numpy(ps_np, dev)
    model = lambda k=1, jvp=False, **kw: make_icnf(name, dev, num_probes=k, ad="jvp" if jvp else "vjp", **kw)  # noqa: E731
    icnf_k, icnf_p = model(), model(fused=False)
    spec = fs.chain_spec(icnf_k.nn, icnf_k.zdim)
    check(spec.n_layers == len(dims) - 1 and spec.n_cond == nc
          and fs._wide_chain(spec) == (form != "narrow") and fs._stream_chain(spec) == (form == "stream")
          and fs._stream_chain(spec, True) == (form == "stream")
          and all(fs._kernel_covers(TSIT5, spec, k, chain=True, jvp=jvp) is None for k, jvp in ((1, False),) + probes),
          f"{name} should run the {form} chain kernels with every probe configuration")
    names = depth_names(fs, form, nc)
    run = {key: w for key, (_, w, _) in names.items()}
    label = f"{form} {'COND ' if nc else ''}({name}, {spec.n_layers} layers, B={B})"

    # The four kernels and the probe instances against their twins.
    test, train, exact, cot = kernel_inputs(icnf_k, ps, xs, rng, dev)
    if nc:
        test, train, exact = (dict(d, ys=ys) for d in (test, train, exact))
    runs = {"k7t": run_pair(f"K7 TEST {label}", run["k7t"], fs.solve_test_plain, TSIT5, spec, test, reps=reps),
            "k7e": run_pair(f"K7 exact {label}", run["k7e"], fs.solve_train_exact_plain, TSIT5, spec, exact,
                            reps=reps),
            "k1c": run_pair(f"K1 chain form {label}", run["k1c"], fs.solve_train_plain, TSIT5, spec, train, reps=reps)}
    runs["k2c"] = run_pair(f"K2 chain form {label}", run["k2c"], fs.adjoint_train_plain, TSIT5, spec,
                           adjoint_kw(train, runs["k1c"][0], cot), adjoint=True, reps=reps)
    us = {key: r[2] * 1e3 / max(int(steps_of(r[0])[0]), 1) for key, r in runs.items()}
    held = {}
    if probes:
        eps_all = torch.from_numpy(rng.normal(size=(max(k for k, _ in probes), B, icnf_k.zdim)).astype("float32"))
        eps_all = eps_all.to(dev)
    for k, jvp in probes:
        tag = probe_tag(k, jvp)
        kw1 = dict(train, eps=eps_all[:k].contiguous(), jvp=jvp)
        r1 = run_pair(f"K1 chain form {tag} {label}", run["k1c"], fs.solve_train_plain, TSIT5, spec, kw1, reps=reps)
        r2 = run_pair(f"K2 chain form {tag} {label}", run["k2c"], fs.adjoint_train_plain, TSIT5, spec,
                      adjoint_kw(kw1, r1[0], cot), adjoint=True, reps=reps)
        held[(k, jvp)] = (r1, r2)
        us[f"k1c/{tag}"], us[f"k2c/{tag}"] = (r[2] * 1e3 / max(int(steps_of(r[0])[0]), 1) for r in (r1, r2))
    hold_logpdf(cnf, name, icnf_k, icnf_p, xs, ps, ys=ys, kernel=(fs, run["k7t"].__name__, fs.solve_test_plain))

    # The main paths, the counters reset just before each.
    kname = {key: n for key, (n, _, _) in names.items()}
    dist = cnf.CondICNFDist(icnf_k, cnf.Mode.TEST, ps, ys) if nc else cnf.ICNFDist(icnf_k, cnf.Mode.TEST, ps)
    one = cnf.CondICNFDist(icnf_k, cnf.Mode.TEST, ps, ys[0]) if nc else dist
    fs.reset_launches()
    with torch.no_grad():
        lp = dist.logpdf(xs)
        samples = one.sample(B, generator=torch.Generator(device=dev).manual_seed(SEED + 1500))
    torch.cuda.synchronize()
    n7t = launched(fs)
    check(n7t == {kname["k7t"]: 2}, f"{name} serving launched {n7t}")
    check(bool(torch.isfinite(lp).all() and torch.isfinite(samples).all()) and tuple(lp.shape) == (B,)
          and tuple(samples.shape) == (B, cfg["nvars"]), f"{name} serving output not finite or of the wrong shape")
    steer = {"steer_r": 0.05} if icnf_k.steer_rate > 0 else {}
    yk = {} if ys is None else {"ys": ys}
    launches = {"k7t": n7t[kname["k7t"]]}
    probe_launches = {}
    for k, jvp in ((1, False),) + tuple(probes):
        icnf = model(k, jvp)
        eps = icnf.draw_eps(torch.Generator(device=dev).manual_seed(SEED + 1510 + k), B, dev)
        fs.reset_launches()
        _, g, _ = loss_grad(cnf, icnf, ps_np, xs, dev, eps=eps, **steer, **yk)
        torch.cuda.synchronize()
        got = launched(fs)
        check(got == {kname["k1c"]: 1, kname["k2c"]: 1} and all(bool(torch.isfinite(x).all()) for x in g),
              f"{name} {probe_tag(k, jvp)} gradient launched {got}")
        if (k, jvp) == (1, False):
            launches.update(k1c=1, k2c=1)
        else:
            probe_launches[(k, jvp)] = [w.probe_launches.get((k, jvp), 0) for w in (run["k1c"], run["k2c"])]
            check(probe_launches[(k, jvp)] == [1, 1], f"{name} {probe_tag(k, jvp)} probe instances "
                  f"{probe_launches[(k, jvp)]}")
    fs.reset_launches()
    _, g, _ = loss_grad(cnf, model(exact=True), ps_np, xs, dev, **steer, **yk)
    torch.cuda.synchronize()
    check(launched(fs) == {kname["k7e"]: 1} and all(bool(torch.isfinite(x).all()) for x in g),
          f"{name} exact gradient launched {launched(fs)}")
    launches["k7e"] = 1
    if fit:
        X = model_data(name, rng, N_STEPS * B)
        check(form == "narrow" and not nc, "the depth fit runs on refbench16")
        launches = chain_main_path(cnf, fs, icnf_k, model(exact=True), ps_np, xs, dev, X)
    print(f"phase {phase}: {name} main paths: serving {n7t}, the loss gradients one launch of each kernel "
          f"(probe instances {probe_launches}), exact {kname['k7e']} 1" + (f"; fit {launches}" if fit else ""))

    # The loss gradient of DEPTH_TRUTH against a float64 rtol 1e-7 solve.
    truth = cnf.SolverOptions(rtol=1e-7, atol=1e-9)
    k, jvp, bt = DEPTH_TRUTH.get(name, DEPTH_TRUTH_DEFAULT)
    bt = min(B, bt)
    eps = model(k, jvp).draw_eps(torch.Generator(device=dev).manual_seed(SEED + 1520), bt, dev)
    yt = {} if ys is None else {"ys": ys[:bt]}
    fs.reset_launches()
    l_k, g_k, _ = loss_grad(cnf, model(k, jvp), ps_np, xs[:bt], dev, eps=eps, **steer, **yt)
    check(set(launched(fs)) == {kname["k1c"], kname["k2c"]}, f"{name} {probe_tag(k, jvp)}: launched {launched(fs)}")
    l_p, g_p, _ = loss_grad(cnf, model(k, jvp, fused=False), ps_np, xs[:bt], dev, eps=eps, **steer, **yt)
    l_t, g_t, _ = loss_grad(cnf, model(k, jvp, fused=False, dtype=torch.float64, solver=truth), ps_np, xs[:bt], dev,
                            torch.float64, eps=eps.double(), **steer, **yt)
    torch.cuda.synchronize()
    gnames = [f"{x}{i + 1}" for i in range(len(dims) - 1) for x in ("w", "b")] + (["ys"] if nc else [])
    hold_depth_gradients(f"{name} {probe_tag(k, jvp)} B={bt}", l_k, g_k, l_p, g_p, l_t, g_t, gnames)
    print(f"phase {phase}: {name} per attempted step (us): "
          + ", ".join(f"{key} {v:.1f}" for key, v in us.items()))
    return depth_records(name, dims, nc, B, names, runs, launches, held, probe_launches), (ps_np, xs, ys), us


def depth_paths(cnf, fs, dev, built):
    """Phases 128 to 133: 1-layer nets and chains of 5 to 8 layers through
    the chain kernels.  `built`: the build's {kernel: (library, nvcc
    log)}.  Returns the records."""
    import torch
    from continuousnf_tpu_torch.ode.tableaus import TSIT5
    from continuousnf_tpu_torch.utils.configs import MODELS, REFBENCH_BATCH, cuda_ms, make_icnf

    # Phase 128: coverage, routing and launch shapes at every depth
    # configuration; the refusals past 8 layers (b2) and of 1-layer nets
    # past state width 32 (c2); ptxas's registers, stack frames and spills
    # of the chain sources' builds for every depth (`@depths`): every
    # instance of the narrow ones, the COND instances of the others.
    for name, form in DEPTH_MODELS.items():
        cfg = MODELS[name]
        dims, B = cfg["dims"], cfg.get("batch", BATCH)
        spec = fs.chain_spec(cnf.MLP(dims, device=dev), dims[-1])
        narrow = (f", the narrow K2 chain form's shared memory at 32 threads {fs._narrow_smem_bytes(spec)} bytes"
                  if spec.dz <= fs.MAX_DZ and max(spec.out_dims[:-1], default=0) <= fs.CHAIN_MAX_WIDTH else "")
        line = f"phase 128: {name} {dims} ({spec.n_layers} layers, B={B}): the {form} forms{narrow}"
        if form == "narrow":
            widths = (ctypes.c_int * len(dims))(*dims)
            for lib_name, entry in ((fs.K1C_KERNEL, "cnf_k1c_max_grid"), (fs.K2C_KERNEL, "cnf_k2c_max_grid"),
                                    (fs.K7_KERNEL, "cnf_k7_exact_max_grid")):
                lib = fs._library(lib_name, spec)
                block, grid = fs._launch_shape(lambda blk, cap: getattr(lib, entry)(len(dims) - 1, widths, blk, cap),
                                               entry, B, fs._CHAIN_BLOCKS)
                line += f"; {entry} {block} threads x {grid} blocks"
        print(line)
    for label, dims, why in (("a 9-layer chain", (6,) + (16,) * 8 + (6,), "shape variants (b2)"),
                             ("a 1-layer net of state width 33", (33, 33), "shape variants (c2)")):
        spec = fs.chain_spec(cnf.MLP(dims, device=dev), dims[-1])
        kw = dict(rtol=1e-3, atol=1e-6, max_steps=100, ws=[torch.zeros(a, b, device=dev) for a, b in
                                                              zip(dims[:-1], dims[1:])],
                  bs=[torch.zeros(b, device=dev) for b in dims[1:]], z0=torch.zeros(8, dims[-1], device=dev),
                  dlogp0=torch.zeros(8, device=dev), t0=torch.tensor(0.0, device=dev),
                  t1=torch.tensor(1.0, device=dev), dt_init=torch.tensor(0.05, device=dev))
        refuses(fs, label, why, lambda: fs.run_chain_test_solve_kernel(TSIT5, spec, **kw), phase=128)
    for lib_name in (fs.K1C_KERNEL, fs.K2C_KERNEL, fs.K7_KERNEL, fs.K1W_KERNEL, fs.K2W_KERNEL, fs.K7W_KERNEL,
                     fs.K1S_KERNEL, fs.K2S_KERNEL, fs.K7S_KERNEL):
        name = lib_name + "@depths"
        if name not in built:
            print(f"phase 128: no ptxas lines for {name} (built by an earlier process)")
            continue
        narrow = lib_name in (fs.K1C_KERNEL, fs.K2C_KERNEL, fs.K7_KERNEL)
        for entry, props in sorted(ptxas_report(built[name][1], lib_name).items()):
            if narrow or "cond" in entry:
                print(f"phase 128: ptxas {name} {entry}: {props}")

    records = []
    # Phases 129-130: refbench16, the reference benchmark suite's model, at
    # B = 4096: the four kernels and their probe instances at K = 4 and
    # JVP against their twins, the main paths with `fit` and the exact
    # `fit`, the K = 4 gradient against a float64 solve (129); the train
    # step and logpdf at B = 4096 and at the suite's n = 64, fused and plain
    # (130).
    t_model = time.perf_counter()
    recs, (ps_np, xs, _), _ = depth_model(cnf, fs, dev, "refbench16", np.random.default_rng(SEED + 1600), 129,
                                          fit=True)
    records += recs
    print(f"phase 129: refbench16 took {time.perf_counter() - t_model:.2f} s")
    icnf_k, icnf_p = make_icnf("refbench16", dev), make_icnf("refbench16", dev, fused=False)
    ps = cnf.params_from_numpy(ps_np, dev)
    for n in (BATCH, REFBENCH_BATCH):
        gen = torch.Generator(device=dev).manual_seed(SEED + 1602)
        ms_step = step_ms(cnf, icnf_k, ps_np, xs[:n], gen, dev, 5)
        ms_step_p = step_ms(cnf, icnf_p, ps_np, xs[:n], gen, dev, 1)
        with torch.no_grad():
            _, _, st = cnf.inference(icnf_k, cnf.Mode.TEST, xs[:n], ps)
            ms_lp = cuda_ms(lambda: cnf.inference(icnf_k, cnf.Mode.TEST, xs[:n], ps), 5)
            ms_lp_p = cuda_ms(lambda: cnf.inference(icnf_p, cnf.Mode.TEST, xs[:n], ps), 1)
        print(f"phase 130: refbench16 B={n}: train step (loss, gradient, Lion) fused {ms_step:.4f} ms "
              f"({n / ms_step * 1e3:.1f} samples/s), plain {ms_step_p:.4f} ms; logpdf fused {ms_lp:.4f} ms "
              f"({n / ms_lp * 1e3:.1f} evals/s), plain {ms_lp_p:.4f} ms; TEST steps {int(st.steps)}, NFE {int(st.nfe)}")

    # Phases 131-133: cond_refbench16 (131); the narrow 8-layer chain and
    # the deep chains of the wide forms (132); those of the streamed forms,
    # the 5-layer miniboone860 chain and its conditional form (133).
    us_all = {}
    for name, phase, seed, reps in (("cond_refbench16", 131, 1610, 3), ("deep8_narrow", 132, 1611, 3),
                                    ("deep5_power6", 132, 1612, 3), ("deep8_power6", 132, 1613, 3),
                                    ("deep5_miniboone43", 132, 1614, 3), ("deep5_miniboone128", 133, 1615, 2),
                                    ("deep5_miniboone860", 133, 1616, 1), ("cond_deep5_miniboone860", 133, 1617, 1)):
        t_model = time.perf_counter()
        recs, _, us_all[name] = depth_model(cnf, fs, dev, name, np.random.default_rng(SEED + seed), phase, reps=reps)
        records += recs
        print(f"phase {phase}: {name} took {time.perf_counter() - t_model:.2f} s")
    got = us_all["deep5_miniboone860"]["k2c"]
    print(f"phase 133: the 5-layer streamed K2 chain form at 860 wide, B={MODELS['deep5_miniboone860']['batch']}: "
          f"{got:.1f} us per attempted step, "
          f"predicted {DEPTH_K2S_PREDICTED_US:.1f} (2.8x the 3-layer one's 52,204.9 by FMA), measured/predicted "
          f"{got / DEPTH_K2S_PREDICTED_US:.3f}")
    return records


# ---- K8 in the 2-layer kernels: the COND instances of K3 and the K4 pair ----

#: Phase 138's edge: the widest state the narrow 2-layer kernels keep (dz 32,
#: nvars = naug = 16) with three ys columns, hidden width 96, at B = 1024.
COND_EDGE_DIMS = (35, 96, 32)
COND_EDGE_BATCH = 1024
COND2_TRUTH_BATCH = 1024  # phases 136-137: the float64 rtol 1e-7 solves
#: Phases 136-137: the tolerances at which the per-sample ys cotangent is held
#: to the float64 solve.  At cond_flagship's own rtol 1e-3 the fused
#: backward's coarser, warm-started grid leaves it 6.1e-2 (TEST) and 9.8e-2
#: (exact) max|g| from that solve at B = 1024, the plain BACKSOLVE 2.2e-2 and
#: 2.0e-2, the parent's route (K7 TEST COND) 6.0e-2 (TEST): the method's
#: discretization, not the kernels, which hold their twins; at rtol 1e-4 the
#: fused path is 2.8e-3 and 2.5e-3 from it (PERF.md).
COND_FINE_SOLVER = dict(rtol=1e-4, atol=1e-7)
#: Phases 135 and 138's predictions, microseconds per attempted step, written
#: before the first timed run (PERF.md): cond_flagship's against the
#: flagship's unconditional K3 (1.0621 ms / 17 steps), K4 forward (3.8651 /
#: 17) and K4 adjoint (24.469 / 10), a few per cent up for the ys products and
#: loads; the edge by the per-sample FMA of one thread a sample (K3 x4, the K4
#: pair x7.5 of the flagship's).
COND2_PREDICTED_US = {"k3c": 66.0, "k4c": 232.0, "k4ac": 2_500.0,
                      "k3c/edge": 250.0, "k4c/edge": 1_700.0, "k4ac/edge": 18_000.0}


def cond2_names(fs):
    """The COND instances of the 2-layer kernels: record key ->
    (KERNEL_WRAPPERS name, wrapper, twin, source, the TPU site)."""
    at = "continuousnf_tpu/ops/fused_solve.py:"
    return {
        "k3c": (fs.K3_KERNEL + "/cond", fs.run_cond_solve_kernel, fs.solve_test_plain, "k3_test_solve.cu",
                at + "1043"),
        "k4c": (fs.K4_KERNEL + "/cond", fs.run_cond_exact_solve_kernel, fs.solve_train_exact_plain,
                "k4_exact_solve.cu", at + "1043"),
        "k4ac": (fs.K4A_KERNEL + "/cond", fs.run_cond_exact_adjoint_kernel, fs.adjoint_train_exact_plain,
                 "k4_exact_adjoint.cu", at + "1767"),
    }


def cond2_fma_floats(dims, nc, B):
    """FMA per sample and field evaluation and the floats read and written of
    the COND instances of K3, the K4 forward and the K4 adjoint: the
    unconditional counts (`two_layer_fma`) and nc H for the ys products of
    the forwards, 3 nc H for the adjoint's (the forward, k_ays and W1's ys
    rows); the ys values and a_ys0 among the floats, P counting W1's ys
    rows."""
    dz, H = dims[-1], dims[1]
    P = (dz + nc) * H + H + H * dz + dz
    f = two_layer_fma(dz, H)
    fma = {"k3c": f["k3"] + nc * H, "k4c": f["k4"] + nc * H, "k4ac": f["k4a"] + 3 * nc * H}
    floats = {"k3c": P + B * (2 * dz + 2 + nc), "k4c": P + B * (2 * dz + 6 + nc),
              "k4ac": 2 * P + dz * dz * H + B * (4 * dz + 9 + 2 * nc)}
    return fma, floats


def gradient_distances(label, names, g_k, g_p, g_t, gate=True):
    """Each fused gradient's distance to the float64 rtol 1e-7 solve, printed
    beside the plain path's (g_p, or None) in units of max|g|; with `gate`,
    each fused one finite and within SOLVE_REL * max|g|."""
    for i, (name, a, t) in enumerate(zip(names, g_k, g_t)):
        scale = float(t.abs().max())
        d_k = float((a.double() - t).abs().max()) / scale
        d_p = None if g_p is None else float((g_p[i].double() - t).abs().max()) / scale
        if gate:
            check(bool(a.isfinite().all()) and d_k <= SOLVE_REL,
                  f"{label} g_{name}: fused {d_k} max|g| from the float64 solve, over {SOLVE_REL}")
        print(f"{label} g_{name}: max|g| {scale:.4e}; distance to the float64 rtol 1e-7 solve (of max|g|): fused "
              f"{d_k:.3e}" + ("" if d_p is None else f", plain {d_p:.3e}") + ("" if gate else " (printed, not held)"))


def cond_edge_model(cnf, dev, exact=False, fused=True, dtype=None, solver=None):
    """Phase 138's edge net: CondRNODE, MLP 35 -> 96 -> 32 tanh on [z | ys],
    nvars = naug = 16, three ys columns, the flagship recipe (tspan (0, 13),
    steer_rate 0.1, lambda3 = 1e-2)."""
    import torch
    from continuousnf_tpu_torch.utils.configs import MODELS

    dtype = dtype or torch.float32
    return cnf.construct(cnf.CondRNODE, cnf.MLP(COND_EDGE_DIMS, device=dev, dtype=dtype), 16, 16, tspan=(0.0, 13.0),
                         compute_mode=cnf.VecJacMode(fused=fused, exact_trace=exact), dtype=dtype,
                         **MODELS["flagship"]["extra"], **({"solver": solver} if solver else {}))


def cond_two_layer_paths(cnf, fs, dev, built):
    """Phases 134 to 138: cond_flagship (the README net in conditional
    form, CondRNODE, MLP 17 -> 48 -> 16 on [z | ys], one ys column, the
    flagship recipe, B = 4096) through the COND instances of K3, the K4
    forward and the K4 adjoint (K8 in the 2-layer kernels), and the dz-32
    edge with three ys columns at B = 1024.  `built`: the build's {kernel:
    (library, nvcc log)}.  Returns the records."""
    import torch
    from continuousnf_tpu_torch.ode.tableaus import TSIT5
    from continuousnf_tpu_torch.utils.configs import MODELS, cuda_ms, glorot_params, make_icnf, model_data

    names = cond2_names(fs)
    B, dims, nc = BATCH, MODELS["cond_flagship"]["dims"], MODELS["cond_flagship"]["n_cond"]
    Be, nce = COND_EDGE_BATCH, COND_EDGE_DIMS[0] - COND_EDGE_DIMS[-1]

    # Phase 134: coverage and routing; the launch shapes at the paths'
    # batches and the K4 adjoint COND's shared memory; ptxas's registers,
    # stack frames and spills of the COND instances beside the unconditional.
    for label, d, n, b in (("cond_flagship", dims, nc, B), ("the dz-32 edge", COND_EDGE_DIMS, nce, Be)):
        spec = fs.chain_spec(cnf.MLP(d, device=dev), d[-1])
        dz, H = d[-1], d[1]
        check(spec.n_cond == n and fs._two_layer_tanh(spec) and not fs._wide_two_layer(spec)
              and fs._kernel_covers(TSIT5, spec, cond=True) is None,
              f"{label} should run the COND instances of K3 and the K4 pair")
        line = f"phase 134: {label} {d} ({n} ys columns, B={b}):"
        for lib_name, fn, blocks in ((fs.K3_KERNEL, "cnf_k3c_max_grid", fs._forward_blocks(b, dev)),
                                     (fs.K4_KERNEL, "cnf_k4c_max_grid", fs._forward_blocks(b, dev)),
                                     (fs.K4A_KERNEL, "cnf_k4ac_max_grid", (128, 64, 32))):
            lib = fs._library(lib_name)
            block, grid = fs._launch_shape(lambda blk, cap: getattr(lib, fn)(dz, H, n, blk, cap), fn, b, blocks)
            line += f" {fn} {block} threads x {grid} blocks;"
        lib = fs._library(fs.K4A_KERNEL)
        print(line + f" the K4 adjoint COND's shared memory at 128 threads {lib.cnf_k4ac_smem_bytes(dz, H, n, 128)} "
              f"bytes (unconditional {lib.cnf_k4a_smem_bytes(dz, H, 128)})")
    for lib_name, parts in ((fs.K3_KERNEL, ("18k3_test_cond_solve", "13k3_test_solve")),
                            (fs.K4_KERNEL, ("19k4_exact_cond_solve", "14k4_exact_solve")),
                            (fs.K4A_KERNEL, ("21k4_exact_cond_adjoint", "16k4_exact_adjoint"))):
        log = built.get(lib_name, (None, ""))[1]
        for part in parts:
            found = ptxas_report(log, part)
            if not found:
                print(f"phase 134: {part[2:]}: no ptxas lines (the library was not compiled by this process)")
            for fn, r in sorted(found.items()):
                dz = re.search(r"ILi(\d+)E", fn)
                print(f"phase 134: ptxas {part[2:]} DZ {dz.group(1) if dz else '?'}: {r.get('registers')} registers, "
                      f"{r.get('stack')} bytes stack frame, {r.get('spill_stores')} bytes spill stores, "
                      f"{r.get('spill_loads')} bytes spill loads")

    # Phase 135: each COND instance against its twin at cond_flagship,
    # B = 4096, timed: K3 COND and the K4 forward COND from nonzero
    # accumulators, the K4 adjoint COND from the K4 forward COND's output.
    rng = np.random.default_rng(SEED + 2500)
    ps_np = glorot_params(rng, dims)
    xs_np, ys_np = model_data("cond_flagship", rng, B)
    xs, ys = torch.from_numpy(xs_np).to(dev), torch.from_numpy(ys_np).to(dev)
    ps = cnf.params_from_numpy(ps_np, dev)
    icnf_k, icnf_p = make_icnf("cond_flagship", dev), make_icnf("cond_flagship", dev, fused=False)
    spec = fs.chain_spec(icnf_k.nn, icnf_k.zdim)
    test, train, exact, cot = kernel_inputs(icnf_k, ps, xs, rng, dev)
    test["ys"], train["ys"], exact["ys"] = ys, ys, ys
    runs = {"k3c": run_pair(f"{names['k3c'][0]} (cond_flagship)", names["k3c"][1], names["k3c"][2], TSIT5, spec,
                            test),
            "k4c": run_pair(f"{names['k4c'][0]} (cond_flagship)", names["k4c"][1], names["k4c"][2], TSIT5, spec,
                            exact)}
    runs["k4ac"] = run_pair(f"{names['k4ac'][0]} (cond_flagship)", names["k4ac"][1], names["k4ac"][2], TSIT5, spec,
                            adjoint_kw(exact, runs["k4c"][0], cot), adjoint=True, reps=3)
    out = runs["k4ac"][0]
    check(len(out) == 8 and tuple(out[7].shape) == (B, nc) and float(out[3][0][dims[-1]:].abs().max()) > 0.0,
          f"{names['k4ac'][0]} returned no a_ys0 or a zero gradient for W1's ys rows")
    us = {key: r[2] * 1e3 / max(int(steps_of(r[0])[0]), 1) for key, r in runs.items()}
    print("phase 135: cond_flagship per attempted step (us), measured / predicted: "
          + ", ".join(f"{key} {v:.1f} / {COND2_PREDICTED_US[key]:.1f} ({v / COND2_PREDICTED_US[key]:.3f})"
                      for key, v in us.items()))

    # Phase 136: serving (logpdf with per-sample ys, sample with one ys)
    # through K3 COND alone, logpdf against the plain path; the TEST loss
    # gradient through K3 COND and K5 COND against a float64 solve.
    hold_logpdf(cnf, "cond_flagship", icnf_k, icnf_p, xs, ps, ys=ys, kernel=(fs, "run_cond_solve_kernel",
                                                                              fs.solve_test_plain))
    n_serve = {}
    for what, call in (("logpdf", lambda: cnf.CondICNFDist(icnf_k, cnf.Mode.TEST, ps, ys).logpdf(xs)),
                       ("sample", lambda: cnf.CondICNFDist(icnf_k, cnf.Mode.TEST, ps, ys[0]).sample(
                           B, generator=torch.Generator(device=dev).manual_seed(SEED + 2501)))):
        fs.reset_launches()
        with torch.no_grad():
            res = call()
        torch.cuda.synchronize()
        n = launched(fs)
        check(n == {names["k3c"][0]: 1} and bool(torch.isfinite(res).all())
              and tuple(res.shape) == ((B,) if what == "logpdf" else (B, 8)), f"cond_flagship {what} launched {n}")
        n_serve[what] = n[names["k3c"][0]]
    # The TEST loss gradient at B = 1024: the params and xs held to the
    # float64 solve as in phase 47, the per-sample ys cotangent printed at
    # rtol 1e-3 and held within SOLVE_REL at COND_FINE_SOLVER's tolerances.
    b = COND2_TRUTH_BATCH
    truth = cnf.SolverOptions(rtol=1e-7, atol=1e-9)
    want_t = {names["k3c"][0]: 1, fs.K5_KERNEL: 1}
    fs.reset_launches()
    l_k, g_k = test_loss_grad(cnf, icnf_k, ps_np, xs[:b], dev, ys=ys[:b])
    torch.cuda.synchronize()
    check(launched(fs) == want_t, f"cond_flagship TEST gradient launched {launched(fs)}, expected {want_t}")
    l_p, g_p = test_loss_grad(cnf, icnf_p, ps_np, xs[:b], dev, ys=ys[:b])
    l_t, g_t = test_loss_grad(cnf, make_icnf("cond_flagship", dev, fused=False, dtype=torch.float64, solver=truth),
                              ps_np, xs[:b], dev, torch.float64, ys=ys[:b])
    check(abs(float(l_k - l_p)) <= TOL * max(1.0, abs(float(l_p))), f"cond_flagship TEST losses {float(l_k)} vs "
          f"{float(l_p)}")
    label = f"cond_flagship TEST gradient B={b}"
    hold_test_gradients(label, ["w1", "b1", "w2", "b2", "xs"], g_k[:5], g_p[:5], g_t[:5])
    gradient_distances(label + " rtol 1e-3", ["ys"], g_k[5:], g_p[5:], g_t[5:], gate=False)
    fs.reset_launches()
    _, g_f = test_loss_grad(cnf, make_icnf("cond_flagship", dev, solver=cnf.SolverOptions(**COND_FINE_SOLVER)),
                            ps_np, xs[:b], dev, ys=ys[:b])
    torch.cuda.synchronize()
    check(launched(fs) == want_t, f"cond_flagship TEST gradient at rtol 1e-4 launched {launched(fs)}")
    gradient_distances(label + " rtol 1e-4", ["w1", "b1", "w2", "b2", "xs", "ys"], g_f, None, g_t)
    print(f"phase 136: cond_flagship serving launched {n_serve} ({names['k3c'][0]} alone); the TEST gradient "
          f"{want_t}; losses fused {float(l_k):.6f} plain {float(l_p):.6f} float64 {float(l_t):.6f}")

    # Phase 137: the exact train step (K4 forward COND, K4 adjoint COND once
    # each) at B = 4096, its loss and gradients in the params and ys at
    # COND2_TRUTH_BATCH against the plain path and a float64 rtol 1e-7
    # solve, and the exact `fit` for four Lion steps.
    icnf_e, icnf_ep = make_icnf("cond_flagship", dev, exact=True), make_icnf("cond_flagship", dev, exact=True,
                                                                                fused=False)
    want = {names["k4c"][0]: 1, names["k4ac"][0]: 1}
    gen = torch.Generator(device=dev).manual_seed(SEED + 2502)
    p = cnf.params_from_numpy(ps_np, dev)
    leaves = [x.requires_grad_() for layer in p for x in (layer["w"], layer["b"])]
    step = cnf.parallel.make_train_step_body(icnf_e, cnf.Lion(leaves, lr=1e-3))
    fs.reset_launches()
    metrics = step(p, xs, gen, ys=ys)
    torch.cuda.synchronize()
    n_step = launched(fs)
    check(n_step == want and bool(torch.isfinite(metrics["loss"])) and all(bool(torch.isfinite(x).all())
                                                                            for x in leaves),
          f"cond_flagship exact train step launched {n_step}, loss {float(metrics['loss'])}")
    steer = {"steer_r": 0.05}
    fs.reset_launches()
    l_k, g_k, _ = loss_grad(cnf, icnf_e, ps_np, xs[:b], dev, ys=ys[:b], **steer)
    torch.cuda.synchronize()
    check(launched(fs) == want, f"cond_flagship exact gradient launched {launched(fs)}, expected {want}")
    l_p, g_p, _ = loss_grad(cnf, icnf_ep, ps_np, xs[:b], dev, ys=ys[:b], **steer)
    icnf_t = make_icnf("cond_flagship", dev, exact=True, fused=False, dtype=torch.float64, solver=truth)
    l_t, g_t, _ = loss_grad(cnf, icnf_t, ps_np, xs[:b], dev, torch.float64, ys=ys[:b], **steer)
    torch.cuda.synchronize()
    label = f"cond_flagship exact B={b}"
    check(abs(float(l_k - l_p)) <= TOL * max(1.0, abs(float(l_p))), f"{label} losses {float(l_k)} vs {float(l_p)}")
    gradient_distances(label + " rtol 1e-3", ["w1", "b1", "w2", "b2"], g_k[:4], g_p[:4], g_t[:4])
    gradient_distances(label + " rtol 1e-3", ["ys"], g_k[4:], g_p[4:], g_t[4:], gate=False)
    fs.reset_launches()
    fine = make_icnf("cond_flagship", dev, exact=True, solver=cnf.SolverOptions(**COND_FINE_SOLVER))
    _, g_f, _ = loss_grad(cnf, fine, ps_np, xs[:b], dev, ys=ys[:b], **steer)
    torch.cuda.synchronize()
    check(launched(fs) == want, f"cond_flagship exact gradient at rtol 1e-4 launched {launched(fs)}")
    gradient_distances(label + " rtol 1e-4", ["w1", "b1", "w2", "b2", "ys"], g_f, None, g_t)
    X, Y = model_data("cond_flagship", rng, N_STEPS * B)
    fit_path(cnf, fs, icnf_e, ps_np, dev, X, Y, batch_size=B)
    n_fit = launched(fs)
    check(set(n_fit) == set(want) and min(n_fit.values()) >= N_STEPS, f"cond_flagship exact fit launched {n_fit}")
    print(f"phase 137: cond_flagship exact train step launched {n_step}, exact fit ({N_STEPS} Lion steps at B={B}) "
          f"{n_fit}; exact loss fused {float(l_k):.6f} plain {float(l_p):.6f} float64 {float(l_t):.6f}")
    # Hutchinson training keeps the K1 and K2 chain forms' COND instances
    # (the JAX package's one `_stage_train` for every depth): each against
    # its twin, and the train step launching them once each.
    chain = {"k1c": (fs.K1C_KERNEL, fs.run_chain_train_solve_kernel, fs.solve_train_plain, "k1_chain_solve.cu",
                     "continuousnf_tpu/ops/fused_solve.py:1043"),
             "k2c": (fs.K2C_KERNEL, fs.run_chain_adjoint_kernel, fs.adjoint_train_plain, "k2_chain_adjoint.cu",
                     "continuousnf_tpu/ops/fused_solve.py:1767")}
    runs_h = {"k1c": run_pair("K1 chain form COND (cond_flagship)", chain["k1c"][1], chain["k1c"][2], TSIT5, spec,
                              train, reps=2)}
    runs_h["k2c"] = run_pair("K2 chain form COND (cond_flagship)", chain["k2c"][1], chain["k2c"][2], TSIT5, spec,
                             adjoint_kw(train, runs_h["k1c"][0], cot), adjoint=True, reps=2)
    p = cnf.params_from_numpy(ps_np, dev)
    leaves = [x.requires_grad_() for layer in p for x in (layer["w"], layer["b"])]
    step = cnf.parallel.make_train_step_body(icnf_k, cnf.Lion(leaves, lr=1e-3))
    fs.reset_launches()
    metrics = step(p, xs, gen, ys=ys)
    torch.cuda.synchronize()
    n_hutch = launched(fs)
    check(n_hutch == {fs.K1C_KERNEL: 1, fs.K2C_KERNEL: 1} and bool(torch.isfinite(metrics["loss"])),
          f"cond_flagship Hutchinson train step launched {n_hutch}")
    print(f"phase 137: cond_flagship Hutchinson train step launched {n_hutch} (the K1 and K2 chain forms' COND "
          "instances)")

    # Phase 138: the dz-32 edge (three ys columns, hidden 96) at B = 1024:
    # the three COND instances against their twins, its logpdf and exact
    # loss gradient launching them once each; then CUDA-event times of
    # cond_flagship's paths beside the flagship's, a b b a.
    rng_e = np.random.default_rng(SEED + 2503)
    ps_e = glorot_params(rng_e, COND_EDGE_DIMS)
    xs_e = torch.from_numpy(rng_e.uniform(0.0, 1.0, (Be, 16)).astype("float32")).to(dev)
    ys_e = torch.from_numpy(rng_e.uniform(-1.0, 1.0, (Be, nce)).astype("float32")).to(dev)
    pe = cnf.params_from_numpy(ps_e, dev)
    edge_k = cond_edge_model(cnf, dev)
    spec_e = fs.chain_spec(edge_k.nn, edge_k.zdim)
    test_e, _, exact_e, cot_e = kernel_inputs(edge_k, pe, xs_e, rng_e, dev)
    test_e["ys"], exact_e["ys"] = ys_e, ys_e
    runs_e = {key: run_pair(f"{names[key][0]} (dz-32 edge, B={Be})", names[key][1], names[key][2], TSIT5, spec_e, kw,
                            reps=2) for key, kw in (("k3c", test_e), ("k4c", exact_e))}
    runs_e["k4ac"] = run_pair(f"{names['k4ac'][0]} (dz-32 edge, B={Be})", names["k4ac"][1], names["k4ac"][2], TSIT5,
                              spec_e, adjoint_kw(exact_e, runs_e["k4c"][0], cot_e), adjoint=True, reps=1)
    check(tuple(runs_e["k4ac"][0][7].shape) == (Be, nce), "the edge's K4 adjoint COND returned no a_ys0 (B, 3)")
    fs.reset_launches()
    with torch.no_grad():
        lp_e = cnf.CondICNFDist(edge_k, cnf.Mode.TEST, pe, ys_e).logpdf(xs_e)
    torch.cuda.synchronize()
    n_lp = launched(fs)
    check(n_lp == {names["k3c"][0]: 1} and bool(torch.isfinite(lp_e).all()), f"the edge's logpdf launched {n_lp}")
    fs.reset_launches()
    _, g_e, _ = loss_grad(cnf, cond_edge_model(cnf, dev, exact=True), ps_e, xs_e, dev, ys=ys_e, **steer)
    torch.cuda.synchronize()
    n_ex = launched(fs)
    check(n_ex == want and all(bool(torch.isfinite(g).all()) for g in g_e),
          f"the edge's exact gradient launched {n_ex}")
    us_e = {f"{key}/edge": r[2] * 1e3 / max(int(steps_of(r[0])[0]), 1) for key, r in runs_e.items()}
    print(f"phase 138: the edge's logpdf launched {n_lp}, its exact gradient {n_ex}; per attempted step (us), "
          "measured / predicted: "
          + ", ".join(f"{key} {v:.1f} / {COND2_PREDICTED_US[key]:.1f}" for key, v in us_e.items()))
    rng_f = np.random.default_rng(SEED + 2504)
    ps_f = glorot_params(rng_f, MODELS["flagship"]["dims"])
    xs_f = torch.from_numpy(model_data("flagship", rng_f, B)).to(dev)
    icnf_fe = make_icnf("flagship", dev, exact=True)
    a1 = step_ms(cnf, icnf_e, ps_np, xs, gen, dev, 2, ys=ys)
    b1 = step_ms(cnf, icnf_fe, ps_f, xs_f, gen, dev, 2)
    b2 = step_ms(cnf, icnf_fe, ps_f, xs_f, gen, dev, 2)
    a2 = step_ms(cnf, icnf_e, ps_np, xs, gen, dev, 2, ys=ys)
    ms_c, ms_f = (a1 + a2) / 2, (b1 + b2) / 2
    dist_c = cnf.CondICNFDist(icnf_k, cnf.Mode.TEST, ps, ys)
    dist_f = cnf.ICNFDist(make_icnf("flagship", dev), cnf.Mode.TEST, cnf.params_from_numpy(ps_f, dev))
    with torch.no_grad():
        _, _, st_c = cnf.inference(icnf_k, cnf.Mode.TEST, xs, ps, ys=ys)
        _, _, st_f = cnf.inference(dist_f.icnf, cnf.Mode.TEST, xs_f, dist_f.ps)
        lp_c, lp_f = paired_ms(lambda: dist_c.logpdf(xs), lambda: dist_f.logpdf(xs_f), 3)
    ps_g = cnf.params_from_numpy(ps_np, dev)
    leaves_g = [x.requires_grad_() for layer in ps_g for x in (layer["w"], layer["b"])]
    ms_tg = cuda_ms(lambda: torch.autograd.grad(cnf.loss(icnf_k, cnf.Mode.TEST, xs, ps_g, ys=ys), leaves_g), 3)
    print(f"phase 138: exact train step B={B}: cond_flagship {ms_c:.4f} ms ({B / ms_c * 1e3:.1f} samples/s), "
          f"flagship {ms_f:.4f} ms ({B / ms_f * 1e3:.1f} samples/s), ratio {ms_c / ms_f:.3f}; logpdf cond_flagship "
          f"{lp_c:.4f} ms "
          f"({int(st_c.steps)} steps, {B / lp_c * 1e3:.1f} evals/s), flagship {lp_f:.4f} ms ({int(st_f.steps)} steps); "
          f"cond_flagship TEST loss gradient {ms_tg:.4f} ms")

    records = []
    fma, floats = cond2_fma_floats(dims, nc, B)
    launches = {"k3c": n_serve["logpdf"] + n_serve["sample"], "k4c": n_fit[names["k4c"][0]],
                "k4ac": n_fit[names["k4ac"][0]]}
    for key, (o, err, ms, pms) in runs.items():
        name, _, _, src, at = names[key]
        records.append(kernel_record(name, src, at, launches[key], err, ms, pms, fma[key], B, steps_of(o)[0],
                                     floats[key], accepted=steps_of(o)[1]))
    fma_c, P = chain_fma(dims, nc), sum(a * b + b for a, b in zip(dims[:-1], dims[1:]))
    dz = dims[-1]
    floats_c = {"k1c": P + B * (3 * dz + 6 + nc), "k2c": 2 * P + B * (5 * dz + 9 + 2 * nc)}
    for key, (o, err, ms, pms) in runs_h.items():
        name, _, _, src, at = chain[key]
        records.append(kernel_record(f"{name}/cond_flagship", src, at, n_hutch[name], err, ms, pms, fma_c[key], B,
                                     steps_of(o)[0], floats_c[key], accepted=steps_of(o)[1]))
    fma_e, floats_e = cond2_fma_floats(COND_EDGE_DIMS, nce, Be)
    launches_e = {"k3c": n_lp[names["k3c"][0]], "k4c": n_ex[names["k4c"][0]], "k4ac": n_ex[names["k4ac"][0]]}
    for key, (o, err, ms, pms) in runs_e.items():
        name, _, _, src, at = names[key]
        records.append(kernel_record(f"{name}/dz32-ncond3", src, at, launches_e[key], err, ms, pms, fma_e[key], Be,
                                     steps_of(o)[0], floats_e[key], accepted=steps_of(o)[1]))
    return records


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import continuousnf_tpu_torch as cnf
    from continuousnf_tpu_torch.ops import _build
    from continuousnf_tpu_torch.ops import fused_solve as fs
    from continuousnf_tpu_torch.ode.tableaus import TSIT5
    from continuousnf_tpu_torch.utils.configs import MODELS, glorot_params, make_icnf, model_data

    dev = torch.device("cuda", 0)
    smi = nvidia_smi_line()
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    print(f"card: {smi}")

    t_build = time.perf_counter()
    chain_sources = [fs.K1C_KERNEL, fs.K2C_KERNEL, fs.K7_KERNEL, fs.K1W_KERNEL, fs.K2W_KERNEL, fs.K7W_KERNEL,
                     fs.K1S_KERNEL, fs.K2S_KERNEL, fs.K7S_KERNEL]
    plain = [fs.K3_KERNEL, fs.K1_KERNEL, fs.K2_KERNEL, fs.K4_KERNEL, fs.K4A_KERNEL, fs.K5_KERNEL, fs.K10_KERNEL,
             fs.K3W_KERNEL, fs.K5W_KERNEL, fs.K4WA_KERNEL, fs.K3B_KERNEL, fs.K1B_KERNEL, fs.K2B_KERNEL,
             fs.K3S_KERNEL, fs.K5S_KERNEL, fs.K4SA_KERNEL] + chain_sources
    depths = [n + "@depths" for n in chain_sources]
    # Every library at once, the largest sources first; phases 4-127 need
    # only the first 25 and start when those are built, while the chain
    # sources' builds for every depth (phases 128-133) finish beside them.
    futures = _build.start_builds(plain + depths)
    done_at = {}
    for name, future in futures.items():
        future.add_done_callback(lambda _, n=name: done_at.setdefault(n, time.perf_counter()))
    built = {name: futures[name].result() for name in plain}
    print(f"built {len(built)} kernels in {time.perf_counter() - t_build:.2f} s (one nvcc each, {_build.MAX_NVCC} at "
          f"once; the {len(depths)} builds of the chain sources for every depth go on beside phases 4-127)")

    def print_ptxas(libs):
        for name, (lib_path, log) in libs.items():
            print(f"  {lib_path.name}")
            for line in log.splitlines():
                if any(k in line for k in ("entry function", "registers", "spill")):
                    print(f"    ptxas: {line.strip()}")

    print_ptxas(built)
    dims = MODELS["flagship"]["dims"]
    dz, H = dims[0], dims[1]
    print(f"K4 adjoint dynamic shared memory per 128-thread block at dz={dz}, H={H}: "
          f"{fs._library(fs.K4A_KERNEL).cnf_k4a_smem_bytes(dz, H, 128)} bytes")
    print(f"K5 dynamic shared memory per 128-thread block at dz={dz}, H={H}: "
          f"{fs._library(fs.K5_KERNEL).cnf_k5_smem_bytes(dz, H, 0, 128)} bytes, with one ys row "
          f"{fs._library(fs.K5_KERNEL).cnf_k5_smem_bytes(dz, H, 1, 128)} bytes")

    from continuousnf_tpu_torch.ops.fused_dynamics import _k10_library

    print(f"K10 dynamic shared memory per 256-thread block at dz={dz}, H={H}: "
          f"{_k10_library().cnf_k10_smem_bytes(dz, H, 4)} bytes (float32), "
          f"{_k10_library().cnf_k10_smem_bytes(dz, H, 8)} bytes (float64)")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    rng = np.random.default_rng(SEED)
    ps_np = glorot_params(rng, dims)
    xs_np = model_data("flagship", rng, BATCH)
    ps = cnf.params_from_numpy(ps_np, dev)
    xs = torch.from_numpy(xs_np).to(dev)
    icnf_k, icnf_p = make_icnf("flagship", dev, fused=True), make_icnf("flagship", dev, fused=False)
    t_paths = time.perf_counter()
    records = [serving(cnf, fs, TSIT5, icnf_k, icnf_p, ps, xs, rng, dev)]
    print(f"phases 4-6 took {time.perf_counter() - t_paths:.2f} s")
    readme, sample_draw = {}, {}
    for phases, path in (("7-10", lambda: training(cnf, fs, TSIT5, icnf_k, icnf_p, ps_np, xs, rng, dev)),
                         ("11-14", lambda: exact_training(cnf, fs, TSIT5, ps_np, xs, rng, dev)),
                         ("15-22", lambda: deep_chain(cnf, fs, TSIT5, rng, dev)),
                         ("23-29", lambda: conditional(cnf, fs, TSIT5, np.random.default_rng(SEED + 20), dev)),
                         ("30", lambda: readme.update(readme_workflow(cnf, fs, dev)) or []),
                         ("31", lambda: readme_tolerances_flagship(cnf, fs, dev, readme)),
                         ("32", lambda: readme_tolerances_power6(cnf, fs, dev)),
                         ("33", lambda: other_tableaus(cnf, fs, dev)),
                         ("34", lambda: identity_layers(cnf, fs, dev)),
                         ("35", lambda: deep_test_gradient(cnf, fs, dev) or []),
                         ("36-41", lambda: miniboone(cnf, fs, dev)),
                         ("42-46", lambda: probe_paths(cnf, fs, dev)),
                         ("47-50", lambda: test_gradients(cnf, fs, dev, sample_draw)),
                         ("51-55", lambda: direct_paths(cnf, fs, dev, sample_draw)),
                         ("56-60", lambda: wide_probe_paths(cnf, fs, dev)),
                         ("61-66", lambda: wide_two_layer(cnf, fs, dev)),
                         ("67-72", lambda: miniboone860(cnf, fs, dev)),
                         ("73-78", lambda: bf16_paths(cnf, fs, dev)),
                         ("79-86", lambda: stream_two_layer(cnf, fs, dev)),
                         ("87-90", lambda: stream_exact(cnf, fs, dev)),
                         ("91-96", lambda: stream_probe_paths(cnf, fs, dev)),
                         ("97-102", lambda: cond_wide(cnf, fs, dev)),
                         ("103-107", lambda: cond_wide_exact(cnf, fs, dev, built)),
                         ("108-112", lambda: cond_wide_probes(cnf, fs, dev, built)),
                         ("113-117", lambda: cond_stream(cnf, fs, dev, built)),
                         ("118-122", lambda: cond_stream_exact(cnf, fs, dev, built)),
                         ("123-127", lambda: cond_stream_probes(cnf, fs, dev, built)),
                         ("128-133", lambda: depth_paths(cnf, fs, dev, built)),
                         ("134-138", lambda: cond_two_layer_paths(cnf, fs, dev, built))):
        if phases == "128-133":
            t_wait = time.perf_counter()
            libs = {name: futures[name].result() for name in depths}
            print(f"the chain sources' builds for every depth: the last done {max(done_at.values()) - t_build:.2f} s "
                  f"after the build began, waited {time.perf_counter() - t_wait:.2f} s for here; nvcc seconds "
                  + ", ".join(f"{n} {_build.BUILD_SECONDS.get(n, float('nan')):.2f}" for n in plain + depths))
            print_ptxas(libs)
            built.update(libs)
        t_path = time.perf_counter()
        records += path()
        print(f"phases {phases} took {time.perf_counter() - t_path:.2f} s")
    check(all(r["launches"] >= 1 for r in records), "a kernel of a main path was launched no time: "
          + ", ".join(r["name"] for r in records if r["launches"] < 1))
    print(f"all phases took {time.perf_counter() - t_build:.2f} s, the build included")

    print(json.dumps({"kernels": records}))
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
