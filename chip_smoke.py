#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (greb_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py [--phases SPEC]

With no arguments it runs every step below.  ``--phases 1-17,23`` runs
the steps named (numbers and ranges), with steps 1-2 and the steps they
read from (_NEEDS: 3-7 run as one, 8 needs 3, 9 needs 8, 10 and 15 need
9, 19 needs 18, 21 needs 17, 19 and 20); it prints no kernel line (step
24), and its last line is the ok line.

1. prints the card's name and power limit (nvidia-smi);
2. builds the CUDA kernels from greb_tpu_torch/csrc/ (nvcc, sm_90a) into
   greb_tpu_torch/_build/ and prints the build time, each source's own
   and what was made meanwhile for later phases with no kernel of this
   package (_prebuild: the native record-IO library built with g++, the
   full-calendar forcing of 384x192, 192x96 and
   256x128 regridded, step 18's short-calendar 768x384 model and its fold;
   in processes of their own, this script with --plain-strict PATH, step
   21's plain sharded strict years, and with --plain-strict768 PATH, step
   23's plain first steps), then the ptxas registers and spills of every
   year, band and slab entry;
   and holds the kernel's own reckoning of a cluster block's shared
   memory against ops/cuda/year_kernel.cluster_layout for each kind at
   each size it offers, with how many such clusters the card runs at once;
3. holds the spin-up year kernel (fluxcorr_year, on a cluster of
   DEFAULT_CLUSTER blocks) against its plain PyTorch version on the card:
   one year at 96x48, 730 steps, 24 substeps, max |diff| 0 required;
4. holds the scenario year kernel (scenario_year) against its plain
   version the same way; holds it against the multi-year kernel at M=1,
   and the spin-up year kernel against the member spin-up kernel at M=1,
   at every size those offer (the same cluster body and per-cell device
   functions: bitwise equal required); then sweeps the cluster size (8,
   12, 16 blocks): ms per launch, bitwise equality with the plain version,
   and the same year at one substep per step, which splits a launch into
   substep time and per-step time; then times the year without the pole
   composites and a bare cluster barrier (csrc/cluster_probe.cu), with and
   without its release, which split a substep's time;
5. holds the member-batched spin-up kernel (fluxcorr_years) against its
   plain version at every size it offers, at the member chain's shape:
   M=3 members (ct_sens -2%, base, +2%), one full year, state and
   per-step tables bitwise;
6. holds the multi-year scenario kernel (scenario_years) against its plain
   version at every size it offers: M=2 (step 5's two perturbed members),
   two years at CO2 560 and 680, from step 5's output, state, monthly
   means and annual sums bitwise;
7. times both member kernels at the shapes their paths launch (K3 one
   member for LONG_BLOCK years, the long run's block; K4 step 5's 3
   members, the member chain's year): a warm-up launch, then 3 timed
   launches, the last of which is held bitwise against the plain version
   on the same inputs;
   then the member scaling: one year of each member kernel at M = 1 to
   132 members on each size it offers (one member a cluster, clusters
   beyond the card's capacity in waves; K3 also one block a member),
   against the size the wrappers pick by default;
8. drives the main path, GREB.run: 3 spin-up years and 10 scenario years at
   96x48 through the single-run kernels, MAIN_RUNS times (a process's
   first run is its slowest; the rate is the median of the later ones),
   with launch counts around each run, finiteness, the output file read
   back, and the warming under 680 ppm checked;
9. drives the long-run path: 3 spin-up years, then 50 scenario years
   through run_long + driver_year_runner in blocks of LONG_BLOCK years of
   the multi-year kernel, a checkpoint after each and the output file;
   then the same run stopped at year 20 and resumed to 50 in a fresh
   process (this script with --resume-long DIR), which must leave a
   bitwise equal final state and output file; its first 10 years are held
   to step 8's at the golden tolerances;
10. drives the member chain, GREB.run_members: 3 members (one with the
   base params) through 3 member-batched spin-up years and a LONG_BLOCK-year
   scenario block; the base member must equal step 9's run bit for bit;
11. the legacy log_exp switchboard: for every log_exp the kernels run
   (0-6, 9-15), at 96x48 on a 20-step calendar, K1 and K2 bitwise against
   their plain versions (state, tables, outs, annual sums); under 11 and
   15, K2 = K3 and K1 = K4 at M=1 at every size offered; one K1 and one
   K2 year on the full calendar with no circulation (log_exp 4) timed,
   the last timed launch of each held bitwise against its plain version;
   then the legacy path, the CLI's run_legacy at log_exp 13 (A1B CO2) on
   the full calendar, 3 spin-up, 1 control and 10 scenario years, with
   launch counts, finiteness, the control file's two layers and both
   files read back bitwise against a re-run, the A1B CO2 in the console
   lines, and the path's last spin-up year and first control year held
   bitwise against the plain versions on the same inputs;
12. the strict transport (each kernel's strict instantiation): the kernel's
   own layout of it against cluster_layout for each kind and size; K1
   and K2 bitwise against their plain versions on the 20-step calendar
   under the strict circulation and log_exp 7, 8, 16; K2 = K3 and K1 = K4
   at M=1 under the strict circulation and log_exp 16 at every size
   offered (K3's one-block body must refuse); one full-calendar K1 and K2
   year of the strict circulation timed (a warm-up, then 3 launches),
   the last launch of each held bitwise against its plain version, whose
   year is timed once; then the strict path, GREB.run with
   fast_circulation=False (3 spin-up + 10 scenario years, STRICT_RUNS
   times: launch counts, finiteness, the output file read back, the
   warming), and the CLI's --legacy at log_exp 16 (2 spin-up, 1 control,
   3 scenario years: launch counts, both files read back);
13. the refined grid (the four kernels' refined instantiation, 384x192 at
   dt_crcl=1800: sequential zonal splitting, packed pole composites,
   explicit polar segments), on forcing regridded from the 96x48 synthetic
   forcing by greb_tpu_torch/regrid.py: the kernel's own layout of the
   refined block against refined_layout, with how many such clusters the
   card runs at once; on a 20-step calendar of two months, K1 from the
   initial state and K2 from K1's end state with its corrections, bitwise
   against their plain versions (state, tables, outs, annual sums); K4 at
   M=2 (ct_sens 22.05, 22.95) and K3 at M=2 over 2 years from K4's end
   (with K4's tables, and with K1's as one shared table) bitwise against
   theirs; K4 = K1 and K3 = K2 at M=1 (K3's monthly means against K2's
   outs at the golden tolerances); the first and last of capacity + 1
   members (two waves) against plain; then the refined path, GREB.run
   at 384x192 (1 spin-up + 3 scenario years, full calendar: launch counts,
   finiteness, the output file read back, the warming, sim-yr/s), the
   same years through run_long in one K3 block (state bitwise, monthly
   means at the golden tolerances), the CLI's --ensemble 4 (1 + 1 years,
   K4 spin-ups) and --ensemble 8 --shared-spinup (1 + 2, two waves of
   K3): launch counts, files, member-yr/s, peak device memory; the
   path's own full-calendar K1 and K2 launches timed (CUDA events,
   _TimedLaunches: one cold launch each, not comparable with a median of
   3 after a warm-up), K4 at M=1 and K3 at M=1 x 2 years (a warm-up, then
   one launch;
   ms, us a substep, the bound from year_work / years_work with the
   packed ranks), one K3 year at M = capacity (one wave), and three K2
   probes;
14. 192x96 at dt_crcl=1800 (the refined instantiation's additive form:
   additive zonal splitting, explicit polar advection segments, dense
   192x192 pole composites read from L2), on forcing regridded from the
   96x48 synthetic forcing: the kernel's own layout of the block (and of
   the strict instantiation's) against Python's for each kind, with how
   many such clusters the card runs at once; on the 20-step calendar K1
   and K2 from K1's end, K4 at M=2 and K3 at M=2 over 2 years (a table per
   member, one shared), K4 = K1 and K3 = K2 at M=1, the first and last of
   capacity + 1 members, and the strict instantiation's K1 and K2, each
   bitwise against its plain version; GREB.run (3 + 10 years, full
   calendar: launch counts, finiteness, the output file read back, the
   warming, sim-yr/s), the same years through run_long in K3 blocks of
   G192_BLOCK (state bitwise, monthly means at the golden tolerances) and
   the CLI's --ensemble G192_SHARED_M --shared-spinup (3 + 3: files,
   member-yr/s, peak device memory); one full-calendar K1 and K2 year, K4
   at M=1 and K3 at M=1 x 2 years timed (a warm-up, then 3 launches; ms,
   us a substep, the bound), the last launches held bitwise: K4 = K1, K3 =
   K2's two years (a plain full-calendar 192x96 year takes ~68 s on an
   H100 at 700 W); and three K2 probes (one substep a step, no composite
   rows, no advection segments);
15. the ensemble path: K3 with one correction table that every member
   reads (1, T, 3, Y, X), M=3 over 2 years on the 20-step calendar at every
   size it offers, bitwise equal to the table copied M times and to the
   plain version, also under the strict circulation at C=16; the CLI's
   run_ensemble (--ensemble 65, the default ct_sens sweep, 3 K4 spin-up
   years and 10 scenario years through K3, 65 files) at the default
   --mxu-precision high, through the matmul circulation's member kernels
   at bf16_3x (step 25's): wall, member-yr/s, launch counts, the files
   read back, the first and last members' first year byte-equal to the
   plain twin on the same inputs; the same run at --mxu-precision highest
   (the member kernels at highest, which compute the exact fold's bits):
   its member-yr/s, and member 33 (ct_sens 22.5, the base) byte-equal to
   step 9's first 120 months; --ensemble 256 --shared-spinup (3 K1 years,
   3 scenario years, the matmul circulation): launch counts, the files and
   the peak device memory, below a per-member table set's 10.3 GB, and the
   first and last members' first year (in the first and the last cluster
   of K3) byte-equal to the plain twin on the same inputs; then the same
   run at highest, which from MXU_HIGHEST_PER_MEMBER_M members takes the
   exact fold's per-member kernels (K3's one-block body, in two waves):
   its member-yr/s, and members 1 and 256's first year byte-equal to the
   plain version on the same inputs; one K3 year at M=65 timed with a
   table per member and with the shared table;
16. the legacy fold words at the refined grids (the refined
   instantiation's legacy variant in both forms): for each of
   the seven log_exp whose word keeps the fold with a switch (5, 6, 9, 11,
   13, 14, 15), at 384x192 and at 192x96 on a 4-step calendar, the
   launchers' pick held against refined_entry, K1 from the initial state
   and K2 from it with zero corrections bitwise against their plain
   versions; under 11 and 15 on the 20-step calendar K1, K2 from its end,
   K4 at M=2 and K3 at M=2 x 2 years bitwise against plain (the plain
   steps replayed from CUDA graphs), K4 = K1 and K3 = K2 at M=1, each
   launch timed; the refined legacy path, run_legacy at log_exp 13 at
   384x192 (1 spin-up, 1 scenario year, full calendar: launch counts, the
   control and scenario files read back); --ensemble 4 under log_exp 11 at
   192x96 (1 + 1 years: K4 spin-ups, K3; launch counts, the members' files);
17. the strict transport at 384x192 (the refined instantiation's strict
   form): the kernel's own layout against
   strict_refined_layout for each kind; under the strict circulation,
   log_exp 7, 8, 16 and the no-transport word of log_exp 4, on a 2-step
   calendar, the launchers' pick, K1 and K2 (from the initial state, K2
   with zero corrections), K4 at M=2 and K3 at M=2 x 2 years under the
   strict circulation and log_exp 4, x 1 year under log_exp 7, 8 and 16
   (their year boundary is the step-start cluster.sync()
   the strict circulation's two years cover; from the initial states with
   zero tables) bitwise against their plain
   versions
   (the plain circulation replayed from CUDA graphs, _GraphedCirculation,
   one graphed call held bitwise to the eager one first) and K4 = K1, K3 =
   K2 at M=1, each launch and plain version timed; and the library
   default's path, GREB.run at 384x192 with GrebConfig's default transport
   (the strict circulation), 1 + 1 years: launch counts, finiteness, the
   output file read back, sim-yr/s, its own full-calendar strict K1 and K2
   launches timed (CUDA events around each launch of the path,
   _TimedLaunches); then the path's K2 year again on 2 clusters (the
   strict form's wide variant, scenario_year_strict_wide, forced by
   year_kernel._forced) from the spin-up's end state with its tables, its
   end state and monthly means bitwise against the path's;
18. 768x384 at dt_crcl=450 (config 5, 96 substeps a step; the refined
   instantiation's wide form: one run or member on 6 clusters of 16
   blocks, the halo rows across the clusters' edges through global memory
   at a grid barrier), on forcing regridded from the 96x48 synthetic
   forcing: the kernel's own layout of the wide block against
   refined_layout for each kind, with the clusters a run spans and how
   many the card runs at once; on a 2-step calendar (where a scenario after
   a spin-up with its tables is not finite) the
   launchers' pick, K1 from the initial state, K2 from it with zero
   corrections, K4 at M=2 and K3 at M=2 x 2 years from the initial states
   with zero tables (one member a launch), K4 = K1 and K3 = K2 at M=1, K3
   at M=2 reading K1's tables as one shared table, and K1 and K2 under
   log_exp 11, each bitwise against its plain version (eager) and finite;
   config 5's long run there (run_long in K3 blocks of G768_BLOCK years, a
   checkpoint after each) stopped at G768_STOP and resumed in a fresh
   process (this script with --resume-long768 DIR, which reads the fold
   the first process left in the temp directory and runs beside the next
   checks): final state and output file bitwise equal; on a 10-step
   calendar (where a scenario year after a spin-up stays finite) K1 and
   then K2 from K1's end with K1's tables, bitwise and finite, and the
   CLI's --ensemble G768_ENS_M (1 + 1: launch counts, the members' files
   read back finite);
   the strict circulation on a CUDA mesh refused before any launch
   (ROADMAP Queue 1 item 3j); then GREB.run at 768x384, 1 + 1 years on
   a 40-step calendar (G768_PATH; its forcing and fold made during the
   build; launch
   counts, finiteness, the output file read back, the warming, sim-yr/s,
   peak device memory with what earlier phases held, the path's own K1 and
   K2 launches timed with their bounds);
19. latitude x member sharding in the slab kernels (csrc/slab_kernel.cu:
   a shard's step as slab_start, nsub slab_substep, slab_finish, the halo
   rows copied between launches, a step replayed from one CUDA graph): at
   96x48 on the full calendar on 2 and 4 shards of the card against K1 ->
   K2 (state, tables, monthly and annual means bitwise; the monthly
   means taken a shard's rows at a time on both sides), the 4-shard path
   (1 + 1 years) timed on its second run and its launches counted; on a
   20-step calendar the graphed run against the eager one, each entry's
   launch timed (a graph of 50 launches of it on each shard) and its
   plain version's on one shard, 2 members (ct_sens) x 2 shards against
   K4 -> K3 at M=2, and two processes sharing the card over gloo (this
   script with --shard-worker RANK PORT PATH, which then runs step 21's
   strict transport on 10 steps) against one process; on 10
   steps from the initial state the 4-shard path against its plain sharded
   version (each shard's plain step in a thread, eager: host-bound);
   384x192 and 192x96 on 4 shards against K1 -> K2 on 20 steps and the
   plain sharded version on 4; 768x384 on 4 shards on step 18's 2-step
   model against the wide form (eager and graphed) and, for the spin-up,
   the plain sharded version, each entry's launch on each shard and a
   step timed;
20. the grids between 192x96 and 384x192 at dt_crcl=1800 (additive zonal
   splitting with packed pole composites and explicit polar segments: the
   refined instantiation's additive packed form; the strict transport,
   whose K3 block the cluster body does not hold there: its strict
   additive form; both built in csrc/band_kernel.cu), on forcing regridded
   from the 96x48 synthetic forcing: at 256x128 the kernel's own layouts of
   both forms against Python's for each kind, with how many such clusters
   the card runs at once; on a 20-step calendar the launchers' pick, K1,
   K2 from K1's end, K4 at M=2 and K3 at M=2 x 2 years from K4's end
   bitwise against their plain versions (the plain steps replayed from
   CUDA graphs), K4 = K1 and K3 = K2 at M=1, K3 reading K1's tables as one
   shared table equal to the table copied a member; K1 and K2 under
   log_exp 11 against plain, K4 = K1 and K3 = K2 at M=1; on a 2-step
   calendar the strict circulation's K1, K2, K4 at M=2 and K3 at M=2 x 2
   years from the initial states with zero tables against plain (the
   plain circulation replayed from CUDA graphs) and K4 = K1, K3 = K2 at
   M=1; at 224x112, 288x144, 320x160 and 352x176 the layouts, and K1 and K2
   (from the initial state with zero tables) under the fold on a 4-step
   calendar against plain (eager), at 224x112 also under the strict
   circulation on 2 steps with K4 = K1 and K3 = K2 at M=1; the long run at 256x128 on the 20-step calendar
   (run_long in K3 blocks of G256_BLOCK years, a checkpoint after each)
   stopped at G256_STOP and resumed in a fresh process (this script with
   --resume-long256 DIR): final state and output file bitwise equal; then
   GREB.run at 256x128, 1 + 1 years on the full calendar under the fold
   (launch counts, finiteness, the output file read back, sim-yr/s, the
   path's own K1 and K2 launches timed with their bounds), the same years
   in one K3 block and the CLI's --ensemble G256_SHARED_M --shared-spinup
   (the members' files), and GREB.run under GrebConfig's default (the
   strict circulation) the same way;
21. every word and the band grids on a CUDA mesh (the slab kernels'
   strict forms slab_strict<FORM>, slab_start_strict, slab_finish<legacy>
   and the additive packed form slab_substep<additive_packed>), each run
   bitwise and finite against the unsharded kernels in the same word: at
   96x48 the library default (the strict circulation) on the full
   calendar on 2 and 4 shards against K1 -> K2 (the 4-shard path timed
   on its second run, sim-yr/s beside the fold's, its launches counted by
   entry), against its plain sharded version on 10 steps (eager, made
   during the build) and two gloo processes (step 19's) against one, 2
   members x 2 shards against K4 -> K3 at M=2 on 20 steps; log_exp 11, 8,
   16 and 2 on 2 shards on 20 steps; 256x128 on 4 shards under the fold
   (step 20's 20-step model) and the strict circulation (its 2-step
   model); 384x192 strict on 4 shards (step 17's 2-step model); each new
   entry's launch timed on each shard (a CUDA graph of 50 launches), its
   plain version on the pole shard, its bound;
22. the host layer around the main path on step 8's 96x48 model, in at
   most HOST_PHASE_S seconds: GREB.run with 1 spin-up and 2 scenario
   years, check_finite_every=1 and an output file (launch counts read);
   analysis.read_greb, reading through the native record-IO library,
   returns the run's monthly means bit for bit, and the native read of
   the file equals the NumPy read byte for byte; check_finite passes on
   the run's end state and raises, naming .ts, on a copy with one NaN
   planted on the card; analysis._host gives the host copy of each array
   plots.save_all reads (the monthly means copied to the card, the run's
   diagnostics, the model's forcing on the card), and save_all draws the
   reference's figure set (Agg) from them where matplotlib is installed
   (the card's machine has none; tests/test_torch_plots.py draws it on
   the CPU from tensors np.asarray refuses); and one line, with
   no bound: diag/memory.memory_report for this configuration beside
   torch.cuda.max_memory_allocated() over the run after a reset, with
   the card's name and power limit;
23. the strict transport at 768x384 (the sequential strict form's wide
   variant, *_strict_wide: a run on 6 clusters, the halo rows across
   their edges at a grid barrier, each pole's rows' diffusion sub-cycle
   spread over its cluster's 16 blocks): the kernel's own layout of the
   wide strict block against strict_wide_layout for each kind, with the
   clusters the card runs at once; on a 2-step calendar, under the
   library default, log_exp 7, 8, 16 and 0-4, the launchers' pick, K1
   from the initial state and K2 from it with zero tables, finite; under
   the library default and log_exp 16 (S768_PLAIN_WORDS) K1's first step
   (its correction tables) and K2's (its output fields) bitwise against
   the plain version's first step, on a calendar of one-hour steps
   (S768_PLAIN: 8 substeps a step, each with the pole row's 6,612 rounds;
   made during the build by this script with --plain-strict768 PATH, the
   polar sub-cycles' rounds replayed from CUDA graphs, _GraphedSubcycle;
   its wall and each word's first steps' ms reported), the library
   default's K1 and K2 years there timed; K2 on the 2-step calendar timed
   at each of S768_ROUNDS rounds between the spread's exchanges (bitwise
   equal; year_kernel._forced), its year reckoned from its 2 steps beside
   the year's bound (printed, not in the kernels line); under log_exp 0-4
   (no transport) K1 and
   K2 bitwise against their plain years; K4 = K1 and K3 = K2 at M=1 under
   each word; config 5's long run under the library default (run_long
   in K3 blocks, checkpoints) stopped and resumed in a
   fresh process (this script with --resume-long768 DIR strict): final
   state and output file bitwise equal; on a 10-step calendar GREB.run
   with the library default (1 + 1 years: launch counts, the output file
   read back finite, sim-yr/s), the CLI's --ensemble S768_ENS_M (K4
   spin-ups, K3, one member a launch: the members' files) and run_legacy
   at log_exp 16 (its control and scenario files, finite);
24. prints one JSON line per kernel set ({"kernels": [...]}, with the modes
   each kernel was held bitwise in, for K1/K2 the strict year's ms, plain
   ms and bound, for all four the refined and the 192x96 launch's, the
   legacy fold words' and the strict 384x192 modes' launches, plain
   versions and bounds, for K3 the ensemble year's and the refined wave's,
   for all four the 768x384 wide entries, launches, plain versions and
   bounds, the entries of the grids between 192x96 and 384x192 with their
   modes, their 256x128 launches, plain versions and bounds, and each
   kernel's launches on every path; the three slab
   entries with their 768x384 launches, and step 21's six entries; for K1-K4
   step 23's strict wide entries, launches, times, bounds and the plain
   version's, and the two entries of step 25 with their modes, times,
   bounds, plain versions, launches on the ensemble paths and step 25's
   readings) and, last, {"ok": true, "device": {...}};
25. the member-batched matmul circulation (csrc/members_kernel.cu: K4 and
   K3 with mb members a 16-block cluster), run before the kernel line, in
   at most MXU_PHASE_S seconds: the kernel's own layout of a member block
   against multiyear.members_layout at each kind's default mb, with the
   clusters the card runs at once; at 96x48 on the full calendar at
   bf16_3x and highest, fluxcorr_years_mxu (M = 2 mb, 1 year) and
   scenario_years_mxu (M = 2 mb x 2 years, a table per member and one
   shared) bitwise against the plain twin (the members as one batch, each
   step from a CUDA graph), at highest K4 and K3 also against the exact
   fold's per-member kernels; on the 20-step calendar M = mb + 1 (the
   short last cluster) at both precisions; one K3 year at M = 65 and 256
   (the shared table) at both precisions and through the per-member
   kernel, timed (CUDA events, a warm-up, then 2 launches) in member-yr/s
   beside its bound (at bf16_3x the lesser of the split on CUDA cores and
   three dense bfloat16 products on tensor cores); at M = 96, 112 and 128
   highest against the per-member kernel (a warm-up, then 1 launch), which
   places the CLI's MXU_HIGHEST_PER_MEMBER_M; the substep's row dot alone
   by torch.bmm at its shapes (three bfloat16 products, or one float32
   product) for M = 65 and 256; the
   HIGH budget of a bf16_3x K4 + K3 year at M=2 against the exact fold's
   per-member kernels, read against tests/test_mxu.py:71's CPU bounds
   (Ts 5e-2 K, monthly RMS 5e-3, monthly max 5e-2) and printed within or
   a miss (a miss is recorded, as greb_tpu's TPU miss is).

Each phase prints its wall time ("phase ...: s wall"), and the run its
total before the JSON lines.

The plain versions of the 96x48 checks (steps 3-7, 11, 12 and 15), of
the 20-step checks at 384x192 and 192x96 (steps 13 and 14)
and of step 16's 20-step member checks replay each model step from a CUDA
graph of the eager step (_GraphedSteps): the same kernels on the same
values, a graphed step first held bitwise against the eager one; their
times (plain_ms) are the graphed plain versions'.  Step 17's replay the
strict circulation alone (_GraphedCirculation) the same way.  Step 18's
run eager: on its 2-step calendar a graph would be replayed once or twice
after a capture that costs more than the eager step.

Any failure raises, so the script exits non-zero and prints no ok line.
It needs a CUDA card and the repository's greb_tpu_torch package.
"""
from __future__ import annotations

import copy
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
# the steps of the module docstring: 1-2 (the card, the build) always run,
# 24 (the kernel line) only where every step ran
ALL_STEPS = frozenset(range(1, 26))
# steps that read what another made: 3-7 run as one, the main path (8)
# prints its kernels' share from step 3's times, the long run (9) holds
# its first years to the main path's, the member chain (10) and the
# ensemble (15) read the long run's, the sharded phase (19) step 18's
# short model, the sharded words (21) the models of 17, 19 and 20
_NEEDS = {8: (3,), 9: (8,), 10: (9,), 15: (9,), 19: (18,),
          21: (17, 19, 20)}


def _phases(spec: str) -> frozenset:
    """The steps of ``--phases SPEC`` ("1-17,23": numbers and ranges of
    the module docstring's steps) with steps 1-2 and what they need
    (_NEEDS)."""
    steps = {1, 2}
    for part in spec.split(","):
        lo, _, hi = part.partition("-")
        steps.update(range(int(lo), int(hi or lo) + 1))
    if steps & set(range(3, 8)):
        steps.update(range(3, 8))
    while True:
        more = {n for s in steps for n in _NEEDS.get(s, ())} - steps
        if not more:
            break
        steps |= more
    bad = steps - ALL_STEPS
    if bad:
        raise ValueError(f"--phases {spec}: no step {sorted(bad)}")
    return frozenset(steps)


def _spec(steps) -> str:
    """``steps`` as ranges ("1-17,23")."""
    runs, out = sorted(steps), []
    for n in runs:
        if out and out[-1][1] == n - 1:
            out[-1][1] = n
        else:
            out.append([n, n])
    return ",".join(f"{a}-{b}" if b > a else f"{a}" for a, b in out)

# Year-level tolerances of tests/test_golden_year.py (:29) for monthly
# means, which hold the long run's multi-year kernel against the main
# path's per-year one
TOL_T = 2e-2          # temperatures [K]
TOL_Q = 3e-6          # q [kg/kg]
TOL_ALBEDO = 5e-4

# H100 SXM peaks at the 700 W limit: HBM 3.35 TB/s (NVIDIA data sheet);
# float32 operations that do not fuse, 132 SMs x 128 lanes x 1.98 GHz.  The
# data sheet's 67 TFLOP/s counts a fused multiply-add as two operations,
# but the kernels build with --fmad=false (no add fuses), and year_work /
# years_work count each add and multiply as one operation.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OP_PER_S = 132 * 128 * 1.98e9
# dense bfloat16 on the tensor cores (the data sheet's 989 TFLOP/s, a
# multiply-add two operations, as years_work_dense counts them)
PEAK_BF16_OP_PER_S = 989e12


def _check(label, got, limit):
    ok = got <= limit
    print(f"  {label:<28s} {got:.3e}  (limit {limit:.1e})"
          f"{'' if ok else '  FAIL'}")
    if not ok:
        raise AssertionError(f"{label}: {got} > {limit}")
    return got


def _max_abs(a, b):
    """max |a - b|, equal values (infinities, zeros of either sign) and NaN
    on both sides counting 0, a NaN on one side only inf."""
    import torch
    d = torch.where(a == b, torch.zeros_like(a), (a - b).abs())
    d = torch.where(torch.isnan(a) & torch.isnan(b), torch.zeros_like(d), d)
    return float(torch.nan_to_num(d, nan=float("inf")).max())


def _time_ms(fn, repeats):
    import torch
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(repeats):
        out = fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / repeats, out


def _median(values):
    return sorted(values)[len(values) // 2]


def _launches_ms(fn, repeats):
    """ms of each of ``repeats`` calls of fn, timed one by one after a
    warm-up call, and the last call's result."""
    fn()
    got = []
    for _ in range(repeats):
        t, out = _time_ms(fn, 1)
        got.append(t)
    return got, out


def _runs(ms, after="after a warm-up"):
    return (f"median {_median(ms):.3f} ms of {len(ms)} {after} ("
            f"{' '.join(f'{v:.3f}' for v in ms)}; spread "
            f"{max(ms) - min(ms):.3f})")


def _bitwise(tag, pairs, quiet=False):
    """max |diff| of each (name, kernel, plain) pair; all must be 0.
    ``quiet`` prints one line for all pairs."""
    worst, names = 0.0, []
    for name, a, b in pairs:
        d = _max_abs(a, b)
        if not quiet:
            print(f"  {tag} {name:<22s} max |diff| {d:.3e}")
        worst = max(worst, d)
        names.append(name)
    if quiet:
        print(f"  {tag}: max |diff| {worst:.3e} over {', '.join(names)}")
    if worst != 0.0:
        raise AssertionError(f"{tag}: not bitwise equal (max |diff| {worst})")
    return worst


def _barrier_costs(build, threads_of):
    """Time a loop of cluster barriers (csrc/cluster_probe.cu) at each
    cluster size, with a remote store before each, as a substep does."""
    import ctypes
    lib = build.load("cluster_probe")
    lib.greb_cluster_barrier_ns.argtypes = [ctypes.c_int] * 4 + [
        ctypes.POINTER(ctypes.c_double)]
    lib.greb_cluster_barrier_ns.restype = ctypes.c_int
    for c, threads in threads_of.items():
        got = []
        for release in (1, 0):
            ns = ctypes.c_double()
            err = lib.greb_cluster_barrier_ns(c, threads, 17520, release,
                                              ctypes.byref(ns))
            if err:
                raise RuntimeError(f"cluster probe: CUDA error {err}")
            got.append(ns.value)
        print(f"cluster barrier C={c:2d}, {threads} threads: {got[0]:.1f} ns "
              f"with release (the kernels'), {got[1]:.1f} ns relaxed")


class _GraphedSteps:
    """Between start and stop (or inside ``with``), core.fluxcorr_step and
    core.scenario_step, which every plain version of the year kernels calls
    once a model step, are replayed from CUDA graphs: one graph of one step for each step kind,
    model data, fold, numerics, switchboard and CO2, captured on its first
    call from static copies of that call's tensors; each call copies its
    state, forcing step and corrections into them, replays and returns
    copies of the graph's outputs.  A graph launches the kernels the eager
    step launches, on the same values, so the plain versions' results are
    bit for bit the eager ones (``check`` holds one step of each kind); it
    only spares the host the eager step's ~2,500 launches, which make the
    96x48 plain years host-bound (ROADMAP Queue 1 item 1, the smoke's time
    budget).  On stop the eager steps are back and the graphs freed."""

    def start(self):
        from greb_tpu_torch.model import core
        self.core, self.graphs = core, {}
        self.eager = {"flux": core.fluxcorr_step, "scen": core.scenario_step}
        core.fluxcorr_step = lambda *a: self._call("flux", *a)
        core.scenario_step = lambda *a: self._call("scen", *a)
        return self

    def stop(self):
        self.core.fluxcorr_step = self.eager["flux"]
        self.core.scenario_step = self.eager["scen"]
        self.graphs.clear()

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    @staticmethod
    def _map(fn, x):
        """fn over every tensor of a step's arguments or results."""
        import torch
        if isinstance(x, torch.Tensor):
            return fn(x)
        if dataclasses.is_dataclass(x):
            return type(x)(**{f.name: _GraphedSteps._map(fn, getattr(x, f.name))
                              for f in dataclasses.fields(x)})
        if isinstance(x, tuple):
            vals = [_GraphedSteps._map(fn, v) for v in x]
            return type(x)(*vals) if hasattr(x, "_fields") else tuple(vals)
        return x

    @staticmethod
    def _copy_into(dst, src):
        import torch
        if isinstance(dst, torch.Tensor):
            dst.copy_(src)
        elif dataclasses.is_dataclass(dst):
            for f in dataclasses.fields(dst):
                _GraphedSteps._copy_into(getattr(dst, f.name),
                                         getattr(src, f.name))
        elif isinstance(dst, tuple):
            for d, v in zip(dst, src):
                _GraphedSteps._copy_into(d, v)

    def _call(self, kind, *args):
        import torch
        n_in = 3 if kind == "scen" else 2   # state, forcing (, corrections)
        tensors, rest = args[:n_in], args[n_in:]
        # the non-tensor arguments: CO2, model data, numerics, fold, exp;
        # the entry holds them, so no id is reused while it lives
        key = (kind, float(rest[0])) + tuple(id(a) for a in rest[1:])
        entry = self.graphs.get(key)
        if entry is None:
            static = self._map(torch.clone, tensors)
            step = self.eager[kind]
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                for _ in range(2):
                    step(*static, *rest)
            torch.cuda.current_stream().wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                out = step(*static, *rest)
            entry = self.graphs[key] = (graph, static, out, rest)
        graph, static, out, _ = entry
        self._copy_into(static, tensors)
        graph.replay()
        return self._map(torch.clone, out)

    def check(self, model, co2):
        """One graphed step of each kind bitwise against the eager step, on
        ``model``'s initial state and forcing step 1 (the scenario step
        with zero corrections)."""
        import torch
        yd = model.year_data
        s0, fx = model.initial_state(), yd.sfx.at(1)
        corr_t = (torch.zeros_like(s0.ts),) * 3
        pairs = []
        for kind, args in (("flux", (s0, fx, co2)),
                           ("scen", (s0, fx, corr_t, co2))):
            args = args + (yd.md, yd.num, yd.fold, yd.exp)
            got = self._call(kind, *args)
            want = self.eager[kind](*args)
            got_t, want_t = [], []
            self._map(got_t.append, got)
            self._map(want_t.append, want)
            pairs += [(f"{kind} {i}", a, b)
                      for i, (a, b) in enumerate(zip(got_t, want_t))]
        _bitwise("graphed plain step vs eager", pairs, quiet=True)


class _GraphedCirculation:
    """Between start and stop (or inside ``with``), stencils.circulation,
    the strict transport's plain version, which core.compute_tendencies
    calls once a model step (twice under log_exp 8), is replayed from CUDA
    graphs: one graph for each field shape, stencil constants (by value:
    models of one grid and forcing share them), kappa, substep count and
    advection switch, captured on its first call from static copies of
    that call's state, wz and winds; each call copies its state, wz and
    winds into them, replays and returns a copy of the graph's increment.  A graph launches the kernels the eager call launches, on
    the same values, so the plain versions' results are bit for bit the
    eager ones (``check`` holds one call); it spares the host the eager
    call's ~700,000 launches at 384x192 (1652 rounds of the polar diffusion
    sub-cycle in each of 24 substeps), which make a plain strict step there
    host-bound.  The step's pointwise physics, its CO2 and the members'
    parameters stay outside the graph, eager, so every year, member and
    CO2 of a model shares its graphs.  On stop the eager function is back
    and the graphs freed."""

    def start(self):
        from greb_tpu_torch.ops import stencils
        self.stc, self.graphs, self.sf_keys = stencils, {}, {}
        self.eager = stencils.circulation
        stencils.circulation = self._call
        return self

    def stop(self):
        self.stc.circulation = self.eager
        self.graphs.clear()
        self.sf_keys.clear()

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    _WINDS = ("u_m", "u_p", "v_m", "v_p")

    def _sf_key(self, sf):
        """The stencil fields' values, as bytes (made once per object,
        which the cache holds, so no id is reused)."""
        import dataclasses as dc
        hit = self.sf_keys.get(id(sf))
        if hit is None:
            hit = self.sf_keys[id(sf)] = (sf, b"".join(
                getattr(sf, f.name).cpu().numpy().tobytes()
                for f in dc.fields(sf)))
        return hit[1]

    def _call(self, x, wz, **kw):
        import torch
        key = (tuple(x.shape), kw["st"], self._sf_key(kw["sf"]),
               float(kw["kappa"]), kw["nsub"], kw.get("include_advection",
                                                      True))
        inputs = [x, wz] + [kw[k] for k in self._WINDS]
        entry = self.graphs.get(key)
        if entry is None:
            static = [t.clone() for t in inputs]
            rest = {k: v for k, v in kw.items() if k not in self._WINDS}

            def run():
                return self.eager(static[0], static[1], **dict(
                    zip(self._WINDS, static[2:])), **rest)

            # captured without a warm-up: the circulation's only lazy
            # state, stencils._d7_table, is made by the eager call that
            # check() runs first
            torch.cuda.synchronize()
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                out = run()
            # the entry holds the constants the graph reads
            entry = self.graphs[key] = (graph, static, out, rest)
        graph, static, out, _ = entry
        for dst, src in zip(static, inputs):
            dst.copy_(src)
        graph.replay()
        return out.clone()

    def check(self, model):
        """One strict circulation of ``model``'s initial (Ta, q) under
        forcing step 1's winds, eager, then graphed (its capture, then a
        replay), bitwise; returns (graphed ms, eager ms) of one call."""
        import torch
        md, fx, s0 = model.md, model.sfx.at(1), model.initial_state()
        kw = dict(u_m=torch.clamp(fx.u, min=0.0),
                  u_p=torch.clamp(fx.u, max=0.0),
                  v_m=torch.clamp(fx.v, min=0.0),
                  v_p=torch.clamp(fx.v, max=0.0), st=md.st, sf=md.sf,
                  kappa=md.params.kappa, nsub=model.num.nsub_crcl)
        x2 = torch.stack([s0.ta, s0.q])
        wz2 = torch.stack([md.derived.wz_air, md.derived.wz_vapor])
        eager_ms, want = _time_ms(lambda: self.eager(x2, wz2, **kw), 1)
        self._call(x2, wz2, **kw)
        graphed_ms, got = _time_ms(lambda: self._call(x2, wz2, **kw), 1)
        _bitwise("graphed strict circulation vs eager",
                 [("increment", got, want)], quiet=True)
        return graphed_ms, eager_ms


class _SharedFolds:
    """Between start and stop (or inside ``with``),
    fastcirc2.build_const (which GREB calls to build its
    fold) returns the fold it built before from the same inputs (wz of
    both fields, grid, stencil statics, kappa, device): models of one grid
    and topography on other calendars or words share it, read-only,
    instead of each repeating its float64 SVDs (~13 s at 768x384 on the
    card's host).  ``cache_dir`` (the smoke's temp directory): the folds
    also go to, and are read from, files there, for the smoke's fresh
    processes.  The key is the inputs' content (hashed): the grid's dims,
    dt_crcl and the winds of the calendar, and wz, which the topography of
    the forcing's seed and log_exp gives."""

    def __init__(self, cache_dir=None):
        self.cache_dir = cache_dir

    def start(self):
        import hashlib
        import pickle

        import torch
        from greb_tpu_torch.ops import fastcirc2
        self.mod, self.build, self.folds = fastcirc2, fastcirc2.build_const, {}

        def shared(wz_air, wz_vapor, grid, st, kappa, device=None,
                   plan=None):
            key = hashlib.sha256(pickle.dumps(
                (wz_air, wz_vapor, grid, st, float(kappa), str(device),
                 plan))).hexdigest()
            if key in self.folds:
                return self.folds[key]
            path = (os.path.join(self.cache_dir, f"fold-{key}.pt")
                    if self.cache_dir else None)
            if path and os.path.exists(path):
                self.folds[key] = torch.load(path, weights_only=False)
            else:
                self.folds[key] = self.build(wz_air, wz_vapor, grid, st,
                                             kappa, device=device, plan=plan)
                if path:
                    torch.save(self.folds[key], path)
            return self.folds[key]

        fastcirc2.build_const = shared
        return self

    def stop(self):
        self.mod.build_const = self.build
        self.folds.clear()

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()


class _TimedLaunches:
    """Between start and stop (or inside ``with``), every kernel launch of
    the wrappers (year_kernel._launch, which both kernel modules call) is
    bracketed by CUDA events on its stream, so a path's own launches are
    timed as it runs them; ``ms(entry)`` gives the milliseconds of each
    launch of the launchers whose name starts with ``entry`` (e.g.
    "greb_scenario_year_"), in launch order."""

    def start(self):
        import torch
        from greb_tpu_torch.ops.cuda import year_kernel as yk
        self.yk, self.launch, self.marks = yk, yk._launch, []

        def timed(fn_name, *args):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            self.launch(fn_name, *args)
            e1.record()
            self.marks.append((fn_name, e0, e1))

        yk._launch = timed
        return self

    def stop(self):
        self.yk._launch = self.launch

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    def ms(self, entry):
        import torch
        torch.cuda.synchronize()
        return [a.elapsed_time(b) for name, a, b in self.marks
                if name.startswith(entry)]


def _bound_of(nbytes, ops, bf16_ops=0):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = (ops / PEAK_F32_OP_PER_S + bf16_ops / PEAK_BF16_OP_PER_S) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _mxu_bound(plan, num, n_years, members, kind, precision,
               shared_corr=False):
    """(ms, "bytes" or "operations") of a member-kernel launch of the
    matmul circulation at ``precision``: at "bf16_3x" the lesser of its
    split on the CUDA cores (years_work) and three dense bfloat16 products
    a substep on the tensor cores, the rest in float32
    (years_work_dense)."""
    from greb_tpu_torch.ops.cuda import multiyear as my
    split = _bound_of(*my.years_work(plan, num, n_years, members, kind,
                                     shared_corr, precision=precision))
    if precision != "bf16_3x":
        return split
    return min(split, _bound_of(*my.years_work_dense(
        plan, num, n_years, members, kind, shared_corr)))


# runs of the main path; the first is a process's slowest
MAIN_RUNS = 5
# the long run: the reference's 50 scenario years (time_scnr) at 680 ppm,
# in blocks of 5 years, a checkpoint after each (10 until PR 7: the K3
# launch at this shape is held against its plain version, whose years the
# smoke's time limit pays for)
LONG_YEARS = 50
LONG_BLOCK = 5
LONG_STOP = 20
# member counts of the member scaling (132: one a streaming multiprocessor;
# 7/8 and 49/56 either side of the default size's crossovers; no more, to
# leave the refined phase room in the smoke's time limit)
SCALING_M = (1, 7, 8, 49, 56, 132)


# the legacy log_exp values the kernels run (7, 8 and 16 transport with the
# strict stencils, which the port does not have yet); under the member
# modes K3/K4 are also held against K2/K1 at M=1
LEGACY_EXPS = (0, 1, 2, 3, 4, 5, 6, 9, 10, 11, 12, 13, 14, 15)
LEGACY_MEMBER_EXPS = (11, 15)
# the legacy path: the CLI's run_legacy at log_exp 13 (A1B CO2, no
# hydrology) on the full calendar
LEGACY_PATH_EXP = 13
LEGACY_YEARS = dict(time_flux=3, time_ctrl=1, time_scnr=10)
# the strict transport: the strict circulation (log_exp None, no fold) and
# the legacy modes that move Ta (and q) with the strict stencils; under
# the member modes K3/K4 are also held against K2/K1 at M=1
STRICT_MODES = (None, 7, 8, 16)
STRICT_MEMBER_MODES = (None, 16)
# the strict path: GREB.run with fast_circulation=False, 3 spin-up and 10
# scenario years, STRICT_RUNS times; and the CLI's --legacy at log_exp 16
# on the full calendar, cut in depth for time
STRICT_YEARS = dict(time_flux=3, time_scnr=10)
STRICT_RUNS = 2
STRICT_CLI_EXP = 16
STRICT_CLI_YEARS = dict(time_flux=2, time_ctrl=1, time_scnr=3)
# the refined grid: 384x192 at dt_crcl=1800 (24 substeps a step), its
# kernels held to plain on a 20-step calendar of two months (a plain
# full-calendar year would take minutes), the refined path 1 + 3 years on
# the full calendar, per year and in one K3 block; the member kernels'
# refined paths: --ensemble REFINED_ENS_M (per-member spin-ups) and
# --ensemble REFINED_SHARED_M --shared-spinup (two waves of K3), cut in
# years for time
REFINED_GRID = dict(xdim=384, ydim=192, dt_crcl=1800)
REFINED_SHORT = dict(ndays_yr=10, jday_mon=(6, 4))
REFINED_YEARS = dict(time_flux=1, time_scnr=3)
REFINED_ENS_M = 4
REFINED_ENS_YEARS = dict(time_flux=1, time_scnr=1)
REFINED_SHARED_M = 8
REFINED_SHARED_YEARS = dict(time_flux=1, time_scnr=2)
# the legacy fold words at the refined grids: the seven log_exp whose word
# keeps the fold with a switch, K1 and K2 held to plain at 384x192 and
# 192x96 on WORDS_SHORT's 4 steps (a plain 384x192 step takes ~0.3 s on
# the card); under WORD_MEMBER_EXPS on REFINED_SHORT's 20 steps also K4 at
# M=2, K3 at M=2 x 2 years and K3 = K2, K4 = K1 at M=1, the plain steps
# replayed from CUDA graphs; the refined legacy path, run_legacy at
# WORD_PATH_EXP at 384x192 (1 spin-up + 1 scenario year); and
# --ensemble WORD_ENS[0] under WORD_ENS_EXP at 192x96
WORD_EXPS = (5, 6, 9, 11, 13, 14, 15)
WORD_MEMBER_EXPS = (11, 15)
WORDS_SHORT = dict(ndays_yr=2, jday_mon=(2,))
WORD_PATH_EXP = 13
WORD_PATH_YEARS = dict(time_flux=1, time_ctrl=0, time_scnr=1)
WORD_ENS_EXP = 11
WORD_ENS = (4, dict(time_flux=1, time_scnr=1))
# the strict transport at 384x192 (the refined instantiation's strict
# form): the strict circulation, log_exp 7, 8, 16 and the no-transport
# word of log_exp 4, each kernel held to plain on STRICT_REFINED_SHORT's 2
# steps (a plain strict step there runs 1652 sub-cycle rounds at each pole
# row in each of its 24 substeps, ~10 s eager on an H100's host; the
# circulation is replayed from CUDA graphs); the library default's path,
# GREB.run at 384x192, STRICT_REFINED_YEARS
STRICT_REFINED_MODES = (None, 7, 8, 16, 4)
STRICT_REFINED_SHORT = dict(ndays_yr=1, jday_mon=(1,))
STRICT_REFINED_YEARS = dict(time_flux=1, time_scnr=1)
# the ensemble path: the CLI's --ensemble with the default sweep (ct_sens
# 22.05..22.95), 65 members (the middle one, 33, has ct_sens 22.5, the
# base) for the main path's years; --shared-spinup with 256 members (a
# per-member table set would be 10.3 GB) for 3 + 3 years, members 1 and
# 256 (block 0 of K3's first wave, the last block of its second) held to
# the plain version over the first scenario year
ENS_M = 65
ENS_YEARS = dict(time_flux=3, time_scnr=10)
ENS_SHARED_M = 256
ENS_SHARED_YEARS = dict(time_flux=3, time_scnr=3)
ENS_SHARED_PLAIN = (1, ENS_SHARED_M)
# the 192x96 grid at dt_crcl=1800 (24 substeps a step): the refined
# instantiation's additive form (additive zonal splitting, advection
# segments, dense 192x192 pole composites read from L2) on forcing
# regridded from the 96x48 synthetic forcing; its kernels (and the strict
# instantiation's K1/K2) held to plain on REFINED_SHORT's 20 steps, timed
# on the full calendar; GREB.run for the main path's years, the same years
# through run_long in K3 blocks of G192_BLOCK, and the CLI's --ensemble
# G192_SHARED_M --shared-spinup, cut in years and members for the smoke's
# time limit
G192_GRID = dict(xdim=192, ydim=96, dt_crcl=1800)
G192_YEARS = dict(time_flux=3, time_scnr=10)
G192_BLOCK = 5
G192_SHARED_M = 8
G192_ENSEMBLES = (("shared", G192_SHARED_M, dict(time_flux=3, time_scnr=3),
                   ["--shared-spinup"]),)
# 768x384 at dt_crcl=450 (the repository's BASELINE config 5, 96 substeps
# a step): the refined instantiation's wide form (one run on 6 clusters of
# 16 blocks, the halo rows across their edges exchanged at a grid barrier)
# on forcing regridded from the 96x48 synthetic forcing; its kernels held
# to plain on G768_SHORT's 2 steps (the plain steps replayed from CUDA
# graphs), config 5's long run with checkpoints there (G768_LONG years in
# K3 blocks of G768_BLOCK, stopped at G768_STOP and resumed in a fresh
# process), GREB.run on G768_PATH's calendar (the full calendar's forcing
# is 6.9 GB, its regrid ~60 s and its two years ~61 s on an H100: the
# smoke's time limit keeps it out)
G768_GRID = dict(xdim=768, ydim=384, dt_crcl=450)
G768_SHORT = dict(ndays_yr=1, jday_mon=(1,))
# GREB.run's calendar: 40 steps in two months, where the scenario year
# ends warmer than its spin-up (on 10 steps it ends colder: at 96x48 and
# 192x96 on the CPU -0.87 and -1.24 K; on 40 steps +0.32 and +0.38 K)
G768_PATH = dict(ndays_yr=20, jday_mon=(10, 10), time_flux=1, time_scnr=1)
G768_LONG = 4
G768_BLOCK = 2
G768_STOP = 2
# the CLI's --ensemble G768_ENS_M at 768x384 (a spin-up each, then K3) on a
# 10-step calendar of two months, where a scenario year after a spin-up
# with its tables stays finite
G768_ENS_M = 2
G768_ENS = dict(ndays_yr=5, jday_mon=(3, 2), time_flux=1, time_scnr=1)


def _k1_vs_plain(tag, s0, co2, yd, got):
    """max |diff| (0 required) of K1's ``got`` = (state, corr) against the
    plain version's year from (s0, co2)."""
    from greb_tpu_torch.forcing import ModelState
    from greb_tpu_torch.ops.cuda import year_kernel as yk
    s_p, c_p = yk.fluxcorr_year_plain(s0, co2, yd)
    return _bitwise(tag, [(f"state {n}", getattr(got[0], n), getattr(s_p, n))
                          for n in ModelState.FIELDS]
                    + [(n, getattr(got[1], n), getattr(c_p, n))
                       for n in ("tf", "tof", "qf")], quiet=True)


def _k2_vs_plain(tag, s0, corr, co2, yd, got):
    """max |diff| (0 required) of K2's ``got`` = (state, outs, annual sums)
    against the plain version's year from (s0, corr, co2)."""
    from greb_tpu_torch.forcing import ModelState
    from greb_tpu_torch.ops.cuda import year_kernel as yk
    s_p, o_p, a_p = yk.scenario_year_plain(s0, corr, co2, yd)
    return _bitwise(tag, [(f"state {n}", getattr(got[0], n), getattr(s_p, n))
                          for n in ModelState.FIELDS]
                    + [("outs", got[1], o_p), ("annual sums", got[2], a_p)],
                    quiet=True)


def _legacy_phase(tmp, reset_counts, read_counts):
    """Step 11: the legacy switchboard in every kernel, and the legacy
    path.  Returns the worst max |diff| per kernel and the legacy path's
    launches."""
    import contextlib
    import io
    import re

    import numpy as np
    import torch
    from greb_tpu_torch.__main__ import run_legacy
    from greb_tpu_torch.config import (Diagnostics, Experiment, GrebConfig,
                                       Numerics)
    from greb_tpu_torch.io.binio import read_output, read_records
    from greb_tpu_torch.model import core
    from greb_tpu_torch.model.driver import GREB
    from greb_tpu_torch.ops.cuda import multiyear as my
    from greb_tpu_torch.ops.cuda import year_kernel as yk

    err = dict.fromkeys(("fluxcorr_year", "scenario_year", "fluxcorr_years",
                         "scenario_years"), 0.0)
    short = Numerics(ndays_yr=10, jday_mon=(6, 4))
    co2_scn = np.float32(680.0)
    t0 = time.perf_counter()
    plain_s = 0.0
    for e in LEGACY_EXPS:
        m = GREB(GrebConfig(numerics=short, experiment=Experiment(e),
                            fast_circulation=True),
                 device="cuda", verbose=False)
        yd, co2 = m.year_data, np.float32(m.exp.co2_ctrl)
        tag = f"log_exp {e:2d} (flags {yk.experiment_flags(m.exp):#04x})"
        s0 = m.initial_state()
        s_k, c_k = yk.fluxcorr_year(s0, co2, yd)
        s2_k, _, a_k = k2 = yk.scenario_year(s_k, c_k, co2_scn, yd)
        t1 = time.perf_counter()
        err["fluxcorr_year"] = max(err["fluxcorr_year"], _k1_vs_plain(
            f"K1 {tag}", s0, co2, yd, (s_k, c_k)))
        err["scenario_year"] = max(err["scenario_year"], _k2_vs_plain(
            f"K2 {tag}", s_k, c_k, co2_scn, yd, k2))
        plain_s += time.perf_counter() - t1
        if e not in LEGACY_MEMBER_EXPS:
            continue
        pp = my.pack_member_params([m.params], "cuda")
        corrp = torch.stack([c_k.tf, c_k.tof, c_k.qf], dim=1)[None]
        for c in yk.offered_sizes("scenario_years"):
            s3, _, a3 = my.scenario_years(s_k.stack()[:, None], pp, corrp,
                                          np.asarray([co2_scn]), yd,
                                          cluster=c)
            err["scenario_years"] = max(err["scenario_years"], _bitwise(
                f"K2 vs K3 {tag} (M=1, C={c})",
                [("state", s2_k.stack(), s3[:, 0]),
                 ("annual sums", a_k, a3[0, 0])], quiet=True))
        for c in yk.offered_sizes("fluxcorr"):
            s4, c4 = my.fluxcorr_years(s0.stack()[:, None], pp, co2, yd,
                                       cluster=c)
            err["fluxcorr_years"] = max(err["fluxcorr_years"], _bitwise(
                f"K1 vs K4 {tag} (M=1, C={c})",
                [("state", s_k.stack(), s4[:, 0])]
                + [(n, getattr(c_k, n), c4[0, :, i])
                   for i, n in enumerate(("tf", "tof", "qf"))], quiet=True))
    print(f"legacy kernels vs plain, {len(LEGACY_EXPS)} modes on a "
          f"{short.nstep_yr}-step calendar: {time.perf_counter() - t0:.1f} s"
          f" (plain versions {plain_s:.1f} s)")

    # -- one year with no circulation (log_exp 4) on the full calendar
    #    (the last timed launch of each against its plain version)
    m4 = GREB(GrebConfig(experiment=Experiment(4), fast_circulation=True),
              device="cuda", verbose=False)
    yd4, co2 = m4.year_data, np.float32(m4.exp.co2_ctrl)
    s0 = m4.initial_state()
    k1_off, (s4_, c4_) = _launches_ms(
        lambda: yk.fluxcorr_year(s0, co2, yd4), 5)
    k2_off_ms, k2_off = _launches_ms(
        lambda: yk.scenario_year(s4_, c4_, co2_scn, yd4), 5)
    print(f"no circulation (log_exp 4), {m4.num.nstep_yr} steps: K1 "
          f"{_runs(k1_off)}; K2 {_runs(k2_off_ms)}")
    err["fluxcorr_year"] = max(err["fluxcorr_year"], _k1_vs_plain(
        "K1 log_exp 4 timed", s0, co2, yd4, (s4_, c4_)))
    err["scenario_year"] = max(err["scenario_year"], _k2_vs_plain(
        "K2 log_exp 4 timed", s4_, c4_, co2_scn, yd4, k2_off))
    del m4, s4_, c4_, k2_off

    # -- the legacy path: run_legacy as the CLI runs it
    num = Numerics(**LEGACY_YEARS)
    out = os.path.join(tmp, "legacy", "scenario")
    m = GREB(GrebConfig(numerics=num,
                        experiment=Experiment(LEGACY_PATH_EXP),
                        diagnostics=Diagnostics(output_file=out),
                        fast_circulation=True),
             device="cuda")
    console = io.StringIO()
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(console):
        run_legacy(m, out)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    print(console.getvalue(), end="")
    years = num.time_flux + num.time_ctrl + num.time_scnr
    print(f"legacy path (log_exp {LEGACY_PATH_EXP}): {years} sim-years in "
          f"{wall:.3f} s = {years / wall:.3f} sim-yr/s ({num.time_flux} "
          f"spin-up, {num.time_ctrl} control, {num.time_scnr} scenario)")
    launches = read_counts("legacy path", {
        "fluxcorr_year": num.time_flux,
        "scenario_year": num.time_ctrl + num.time_scnr,
        "fluxcorr_years": 0, "scenario_years": 0})
    Y, X, nmon = num.ydim, num.xdim, len(num.jday_mon)
    ctl = read_records(os.path.join(tmp, "legacy", "control"), (Y, X))
    back = read_output(out, X, Y)
    if ctl.shape[0] != num.nstep_yr or not np.isfinite(ctl).all():
        raise AssertionError(f"control file {ctl.shape} not finite")
    if back.shape != (num.time_scnr * nmon, 5, Y, X) \
            or not np.isfinite(back).all():
        raise AssertionError(f"legacy scenario output {back.shape}")
    # both files against a re-run of the phases (the kernels are
    # deterministic): the control file's tail is the spin-up's TF_correct,
    # its head the control run's monthly means, the scenario file the
    # scenario's
    m.verbose = False
    state_fc, corr = m.flux_correction()
    tf = corr.tf.cpu().numpy()
    nrec = nmon * 5 * num.time_ctrl
    _, mon_ctl, _ = m.run_scenario(
        corr, years=num.time_ctrl, state=state_fc,
        co2_series=np.full(num.time_ctrl, m.exp.co2_ctrl, np.float32))
    _, mon_scn, _ = m.run_scenario(corr, state=state_fc)
    if not np.array_equal(ctl[nrec:], tf[nrec:]):
        raise AssertionError("control file tail is not the TF_correct dump")
    if not np.array_equal(ctl[:nrec], mon_ctl.reshape(-1, Y, X)) \
            or np.array_equal(ctl[:nrec], tf[:nrec]):
        raise AssertionError("control file head is not the control run")
    if not np.array_equal(back, mon_scn.reshape(back.shape)):
        raise AssertionError("legacy scenario output does not read back")
    print(f"  control file: {nrec} control records over the "
          f"{num.nstep_yr}-record TF_correct dump, its tail kept; both files "
          f"bitwise equal to a re-run")
    # the path's last spin-up year and its first control year against the
    # plain versions on the same inputs: the kernels' years are the path's
    # (end state and tables, monthly means bitwise)
    yd, co2_ctrl = m.year_data, np.float32(m.exp.co2_ctrl)
    s_last = m.initial_state()
    for _ in range(num.time_flux - 1):
        s_last, _ = yk.fluxcorr_year(s_last, co2_ctrl, yd)
    t1 = time.perf_counter()
    s_k, c_k = yk.fluxcorr_year(s_last, co2_ctrl, yd)
    if not (torch.equal(s_k.stack(), state_fc.stack())
            and torch.equal(c_k.tf, corr.tf)):
        raise AssertionError("K1's last spin-up year is not the path's")
    err["fluxcorr_year"] = max(err["fluxcorr_year"], _k1_vs_plain(
        f"K1 legacy path, spin-up year {num.time_flux}", s_last, co2_ctrl,
        yd, (s_k, c_k)))
    k2 = yk.scenario_year(state_fc, corr, co2_ctrl, yd)
    if not np.array_equal(
            core.monthly_means(m.month_mat, k2[1]).cpu().numpy(), mon_ctl[0]):
        raise AssertionError("K2's control year is not the path's")
    err["scenario_year"] = max(err["scenario_year"], _k2_vs_plain(
        "K2 legacy path, control year 1", state_fc, corr, co2_ctrl, yd, k2))
    print(f"  legacy path's years vs plain: {time.perf_counter() - t1:.1f} s")
    # the scenario's console lines carry the A1B ramp
    want = core.co2_series_for_run(num, m.exp,
                                   m.cfg.co2.series(num.time_scnr))
    scen = console.getvalue().rsplit("% MODEL RUN", 1)[1]
    got = re.findall(r"^ \d+ +(\S+) ", scen, flags=re.M)
    if got != [f"{v:.4f}" for v in want] or not want[0] < want[-1]:
        raise AssertionError(f"console CO2 {got}, want the A1B ramp {want}")
    print(f"  console CO2 follows the A1B ramp: {got[0]} .. {got[-1]} ppm")
    return dict(err=err, launches=launches)


def _strict_phase(tmp, reset_counts, read_counts):
    """Step 12: the strict transport in every kernel's strict
    instantiation, and the paths that run it.  Returns the worst max
    |diff| per kernel, the full-calendar years' times and work, and the
    strict path's launches."""
    import numpy as np
    import torch
    from greb_tpu_torch import __main__ as cli
    from greb_tpu_torch.config import (Diagnostics, Experiment, GrebConfig,
                                       Numerics)
    from greb_tpu_torch.io.binio import read_output, read_records
    from greb_tpu_torch.io.namelist import write_namelist
    from greb_tpu_torch.model.driver import GREB
    from greb_tpu_torch.ops.cuda import multiyear as my
    from greb_tpu_torch.ops.cuda import year_kernel as yk

    t_phase = time.perf_counter()
    err = dict.fromkeys(("fluxcorr_year", "scenario_year", "fluxcorr_years",
                         "scenario_years"), 0.0)
    short = Numerics(ndays_yr=10, jday_mon=(6, 4))
    co2_scn = np.float32(680.0)

    # -- the strict instantiation's shared memory: the kernel's own
    #    reckoning against cluster_layout, for each kind at each size
    plan = yk.StrictPlan(short.ydim, short.xdim)
    for kind in yk.KINDS:
        for c in yk.CLUSTER_SIZES[kind]:
            lay = yk.cluster_layout(plan, c, kind)
            parts, threads = yk.kernel_cluster_layout(plan, c, kind)
            if parts != dict(lay.parts) or threads != lay.threads:
                raise AssertionError(
                    f"strict {kind} C={c}: kernel layout {parts}, {threads} "
                    f"threads; cluster_layout {dict(lay.parts)}, "
                    f"{lay.threads}")
            print(f"strict cluster {kind:<14s} C={c:2d}: {lay.nbytes} B "
                  f"shared memory a block, "
                  f"{yk.cluster_capacity(plan, c, kind)} clusters at once; "
                  f"kernel and cluster_layout agree")

    # -- K1 and K2 against their plain versions under each strict mode on
    #    the 20-step calendar; K3 = K2, K4 = K1 at M=1 under the member
    #    modes at every size offered (the one-block body must refuse)
    t0, plain_s = time.perf_counter(), 0.0
    for e in STRICT_MODES:
        m = GREB(GrebConfig(numerics=short, experiment=Experiment(e),
                            fast_circulation=e is not None),
                 device="cuda", verbose=False)
        yd = m.year_data
        if yd.transport != "strict" or m.fold is not None:
            raise AssertionError(f"log_exp {e}: transport {yd.transport}")
        co2 = np.float32(m.exp.co2_ctrl if m.exp.active
                         else m.cfg.co2.co2_flux)
        tag = (f"strict {'circulation' if e is None else f'log_exp {e:2d}'}"
               f" (flags {yk.experiment_flags(m.exp, True):#05x})")
        s0 = m.initial_state()
        s_k, c_k = yk.fluxcorr_year(s0, co2, yd)
        s2_k, _, a_k = k2 = yk.scenario_year(s_k, c_k, co2_scn, yd)
        t1 = time.perf_counter()
        err["fluxcorr_year"] = max(err["fluxcorr_year"], _k1_vs_plain(
            f"K1 {tag}", s0, co2, yd, (s_k, c_k)))
        err["scenario_year"] = max(err["scenario_year"], _k2_vs_plain(
            f"K2 {tag}", s_k, c_k, co2_scn, yd, k2))
        plain_s += time.perf_counter() - t1
        if e not in STRICT_MEMBER_MODES:
            continue
        pp = my.pack_member_params([m.params], "cuda")
        corrp = torch.stack([c_k.tf, c_k.tof, c_k.qf], dim=1)[None]
        for c in yk.offered_sizes("scenario_years"):
            if c == 1:
                try:
                    my.scenario_years(s_k.stack()[:, None], pp, corrp,
                                      np.asarray([co2_scn]), yd, cluster=c)
                except NotImplementedError as exc:
                    print(f"  K3 {tag} C=1 refused: {exc}")
                    continue
                raise AssertionError("K3's one-block body ran the strict "
                                     "transport")
            s3, _, a3 = my.scenario_years(s_k.stack()[:, None], pp, corrp,
                                          np.asarray([co2_scn]), yd,
                                          cluster=c)
            err["scenario_years"] = max(err["scenario_years"], _bitwise(
                f"K2 vs K3 {tag} (M=1, C={c})",
                [("state", s2_k.stack(), s3[:, 0]),
                 ("annual sums", a_k, a3[0, 0])], quiet=True))
        for c in yk.offered_sizes("fluxcorr"):
            s4, c4 = my.fluxcorr_years(s0.stack()[:, None], pp, co2, yd,
                                       cluster=c)
            err["fluxcorr_years"] = max(err["fluxcorr_years"], _bitwise(
                f"K1 vs K4 {tag} (M=1, C={c})",
                [("state", s_k.stack(), s4[:, 0])]
                + [(n, getattr(c_k, n), c4[0, :, i])
                   for i, n in enumerate(("tf", "tof", "qf"))], quiet=True))
    print(f"strict kernels vs plain, {len(STRICT_MODES)} modes on a "
          f"{short.nstep_yr}-step calendar: {time.perf_counter() - t0:.1f} s"
          f" (plain versions {plain_s:.1f} s)")

    # -- one strict K1 and one strict K2 year on the full calendar, timed
    #    (a warm-up, then 3 launches), the last timed launch of each held
    #    bitwise against its plain version, whose one year is timed too
    m = GREB(GrebConfig(fast_circulation=False), device="cuda",
             verbose=False)
    yd, num = m.year_data, m.num
    co2f = np.float32(m.cfg.co2.co2_flux)
    s0 = m.initial_state()
    k1_ms, (s_k, c_k) = _launches_ms(
        lambda: yk.fluxcorr_year(s0, co2f, yd), 3)
    k2_ms, k2 = _launches_ms(
        lambda: yk.scenario_year(s_k, c_k, co2_scn, yd), 3)
    plain_k1, (s_p, c_p) = _time_ms(
        lambda: yk.fluxcorr_year_plain(s0, co2f, yd), 1)
    err["fluxcorr_year"] = max(err["fluxcorr_year"], _bitwise(
        "K1 strict circulation, full calendar (last timed launch)",
        [(f"state {n}", getattr(s_k, n), getattr(s_p, n))
         for n in ("ts", "ta", "to", "q", "cap_surf")]
        + [(n, getattr(c_k, n), getattr(c_p, n)) for n in ("tf", "tof", "qf")],
        quiet=True))
    plain_k2, (s2_p, o_p, a_p) = _time_ms(
        lambda: yk.scenario_year_plain(s_k, c_k, co2_scn, yd), 1)
    err["scenario_year"] = max(err["scenario_year"], _bitwise(
        "K2 strict circulation, full calendar (last timed launch)",
        [(f"state {n}", getattr(k2[0], n), getattr(s2_p, n))
         for n in ("ts", "ta", "to", "q", "cap_surf")]
        + [("outs", k2[1], o_p), ("annual sums", k2[2], a_p)], quiet=True))
    per_sub = 1e3 / (num.nstep_yr * num.nsub_crcl)
    print(f"strict circulation, {num.nstep_yr} steps: K1 {_runs(k1_ms)}; "
          f"K2 {_runs(k2_ms)} = {_median(k2_ms) * per_sub:.3f} us per "
          f"substep (a step's work included); plain K1 {plain_k1:.1f} ms, "
          f"plain K2 {plain_k2:.1f} ms")
    work = {k: yk.year_work(yd.plan, num, k == "scenario_year",
                            flags=yd.flags)
            for k in ("fluxcorr_year", "scenario_year")}
    del k2, s_p, c_p, s2_p, o_p, a_p

    # -- the strict path: GREB.run at fast_circulation=False
    snum = Numerics(**STRICT_YEARS)
    out = os.path.join(tmp, "strict", "scenario")
    os.makedirs(os.path.dirname(out))
    model = GREB(GrebConfig(numerics=snum, fast_circulation=False,
                            diagnostics=Diagnostics(output_file=out)),
                 device="cuda")
    walls = []
    for _ in range(STRICT_RUNS):
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, corr, monthly, diags = model.run(output_path=out)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        launches = read_counts("strict path", {
            "fluxcorr_year": snum.time_flux, "scenario_year": snum.time_scnr,
            "fluxcorr_years": 0, "scenario_years": 0})
    years = snum.time_flux + snum.time_scnr
    print(f"strict path (GREB.run, fast_circulation=False): {years} "
          f"sim-years, {STRICT_RUNS} runs: "
          f"{' '.join(f'{years / w:.3f}' for w in walls)} sim-yr/s")
    for name in ("ts", "ta", "to", "q", "cap_surf"):
        if not bool(torch.isfinite(getattr(state, name)).all()):
            raise AssertionError(f"strict state {name} not finite")
    if monthly.shape != (snum.time_scnr, len(snum.jday_mon), 5, snum.ydim,
                         snum.xdim) \
            or not np.isfinite(monthly).all():
        raise AssertionError(f"strict monthly means {monthly.shape}")
    back = read_output(out, snum.xdim, snum.ydim)
    if not np.array_equal(back, monthly.reshape(-1, 5, snum.ydim,
                                                snum.xdim)):
        raise AssertionError("strict output file does not read back")
    gm = [float(d.global_mean_ts) for d in diags]
    print(f"  global mean Ts [K] by scenario year: "
          f"{' '.join(f'{g:.4f}' for g in gm)}")
    if not gm[-1] > gm[0]:
        raise AssertionError(f"strict path: no warming under 680 ppm: {gm}")

    # -- the CLI's --legacy at log_exp 16 (Ta by the strict stencils, q
    #    not moved; SST + 1) on the full calendar
    nml = os.path.join(tmp, "strict", "namelist_original")
    write_namelist({"numerics": STRICT_CLI_YEARS,
                    "physics": {"log_exp": STRICT_CLI_EXP}}, nml)
    cli_out = os.path.join(tmp, "strict", "legacy", "scenario")
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rc = cli.main([nml, "--legacy", "--synthetic", "--output", cli_out,
                   "--quiet"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"--legacy at log_exp {STRICT_CLI_EXP}: rc {rc}")
    y = STRICT_CLI_YEARS
    read_counts(f"CLI --legacy, log_exp {STRICT_CLI_EXP}", {
        "fluxcorr_year": y["time_flux"],
        "scenario_year": y["time_ctrl"] + y["time_scnr"],
        "fluxcorr_years": 0, "scenario_years": 0})
    cnum = Numerics(**y)     # the namelist's calendar: the full year
    ctl = read_records(os.path.join(os.path.dirname(cli_out), "control"),
                       (cnum.ydim, cnum.xdim))
    back = read_output(cli_out, cnum.xdim, cnum.ydim)
    if ctl.shape[0] != cnum.nstep_yr or not np.isfinite(ctl).all() \
            or back.shape != (cnum.time_scnr * len(cnum.jday_mon), 5,
                              cnum.ydim, cnum.xdim) \
            or not np.isfinite(back).all():
        raise AssertionError(f"--legacy files: control {ctl.shape}, "
                             f"scenario {back.shape}")
    print(f"  CLI --legacy at log_exp {STRICT_CLI_EXP}: "
          f"{sum(y.values())} sim-years in {wall:.3f} s; control file "
          f"{ctl.shape[0]} records, scenario {back.shape[0]} months, finite")
    print(f"strict phase: {time.perf_counter() - t_phase:.1f} s")
    return dict(err=err, ms={"fluxcorr_year": _median(k1_ms),
                             "scenario_year": _median(k2_ms)},
                plain_ms={"fluxcorr_year": plain_k1,
                          "scenario_year": plain_k2},
                work=work, launches=launches)


# the forcing a process has regridded, by grid, calendar and source (the
# 96x48 synthetic forcing, which has no seed: the same arrays every run),
# shared read-only by the models of one grid and calendar
_REGRIDDED = {}


def _regridded(num):
    """(The 96x48 synthetic forcing of num's calendar regridded to num's
    grid by the port's regrid.py, seconds): from _REGRIDDED where this
    process made it before (~6 s for 384x192's full calendar on the card's
    host), and kept there for the next model."""
    import numpy as np
    from greb_tpu_torch.io.synthetic import make_synthetic_forcing
    from greb_tpu_torch.regrid import regrid_forcing_arrays
    t0 = time.perf_counter()
    key = (num.xdim, num.ydim, num.nstep_yr, num.ndays_yr, num.jday_mon,
           "synthetic 96x48")
    arrs = _REGRIDDED.get(key)
    if arrs is None:
        arrs = regrid_forcing_arrays(
            make_synthetic_forcing(96, 48, num.nstep_yr, num.ndays_yr), num)
        if not all(np.isfinite(a).all() for a in arrs.values()):
            raise AssertionError("regridded forcing not finite")
        _REGRIDDED[key] = arrs
    return arrs, time.perf_counter() - t0


def _prebuild(tmp, want=lambda step: True):
    """What later phases use and no kernel of this package computes, made
    while the kernels build: the native record-IO library (g++), the
    full-calendar forcing of the paths at
    384x192, 192x96 and 256x128 regridded into _REGRIDDED, and step 18's
    short-calendar 768x384 model (its fold's float64 SVDs; the fold left in
    ``tmp`` for step 18's fresh process) and its path's forcing and fold
    (G768_PATH's calendar); each only where a step of
    ``want`` uses it.  Returns ({what: seconds}, step 18's _grid768_model
    result or None)."""
    from greb_tpu_torch.config import Numerics
    from greb_tpu_torch.io import native_recordio
    t0 = time.perf_counter()
    native_recordio.build()
    took = {"record-IO library (g++)": time.perf_counter() - t0}
    for grid, steps in ((REFINED_GRID, (13, 16, 17)), (G192_GRID, (14, 16)),
                        (G256_GRID, (20,))):
        if any(map(want, steps)):
            num = Numerics(**grid)
            took[f"regrid {num.xdim}x{num.ydim}"] = _regridded(num)[1]
    m768 = None
    if want(18):
        with _SharedFolds(cache_dir=tmp):
            m768 = _grid768_model(Numerics(**G768_GRID, **G768_SHORT))
            took["768x384 short model"] = sum(m768[1:])
            # the path's forcing (into _REGRIDDED) and fold (a file in tmp)
            took["768x384 path's forcing and fold"] = sum(_grid768_model(
                Numerics(**G768_GRID, **G768_PATH))[1:])
    return took, m768


def _child_result(flag, path, proc):
    """(what the plain-version process ``flag`` saved to ``path``, its
    seconds), after it ended; raises where it failed or launched a kernel
    of this package."""
    import torch
    o, e = proc.communicate(timeout=900)
    if proc.returncode != 0:
        print(o[-4000:], e[-4000:], file=sys.stderr)
        raise AssertionError(f"{flag} exited {proc.returncode}")
    child = json.loads(o.strip().splitlines()[-1])
    if any(child["launches"].values()):
        raise AssertionError(f"{flag}: the plain version launched "
                             f"{child['launches']}")
    return torch.load(path, weights_only=False), child["s"]


def _plain_strict(path) -> int:
    """The plain sharded strict years that step 21 holds the slab kernels
    against, in a process of its own while the kernels build (no kernel of
    this package runs): the library default at 96x48 on SHARD_PATH_NY
    shards of the card, SHARD_PLAIN_96's 10 steps from the initial state
    (eager, each shard's plain step in a thread: host-bound), saved to
    ``path``.  ``python3 chip_smoke.py --plain-strict PATH``."""
    import torch
    from greb_tpu_torch.config import GrebConfig, Numerics
    from greb_tpu_torch.model.driver import GREB
    m10 = GREB(GrebConfig(numerics=Numerics(**SHARD_PLAIN_96)),
               device="cuda", verbose=False)
    res, secs, n = _sharded_run(m10, SHARD_PATH_NY, plain=True, from0=True)
    torch.save(res, path)
    print(json.dumps({"s": secs, "launches": n}))
    return 0


def _refined_model(num, out_path=None, verbose=False, fast=True,
                   log_exp=None):
    """GREB at a refined grid on the card, on forcing regridded by the
    port's regrid.py from the 96x48 synthetic forcing of num's calendar
    (``_regridded``), with the fold (``fast``), the
    strict circulation (``fast`` False) or the library's default (``fast``
    None: the strict circulation), and the switchboard at ``log_exp``;
    (model, seconds of the regrid)."""
    from greb_tpu_torch.config import Diagnostics, Experiment, GrebConfig
    from greb_tpu_torch.forcing import forcing_from_arrays
    from greb_tpu_torch.model.driver import GREB
    arrs, regrid_s = _regridded(num)
    diag = Diagnostics(output_file=out_path) if out_path else Diagnostics()
    kw = {} if fast is None else dict(fast_circulation=fast)
    model = GREB(GrebConfig(numerics=num, diagnostics=diag,
                            experiment=Experiment(log_exp), **kw),
                 forcing=forcing_from_arrays(arrs, "cuda"), device="cuda",
                 verbose=verbose)
    return model, regrid_s


def _with_years(model, **years):
    """``model`` with other spin-up and scenario years (a shallow copy:
    the years reach no kernel)."""
    other = copy.copy(model)
    other.num = dataclasses.replace(model.num, **years)
    other.cfg = dataclasses.replace(model.cfg, numerics=other.num)
    return other


def _months_close(tag, got, want):
    """Monthly means (..., 5, y, x) at the golden tolerances."""
    import numpy as np
    for v, (name, tol) in enumerate((("ts", TOL_T), ("ta", TOL_T),
                                     ("to", TOL_T), ("q", TOL_Q),
                                     ("albedo", TOL_ALBEDO))):
        _check(f"{tag} {name}", float(np.abs(
            np.asarray(got)[..., v, :, :]
            - np.asarray(want)[..., v, :, :]).max()), tol)


def _refined_member_checks(m, k1, k2, co2f, co2s, capacity,
                           tag="refined"):
    """K4 and K3's refined instantiation on the 20-step calendar of ``m``,
    bitwise against their plain versions: K4 at M=2 (ct_sens 22.05 and
    22.95) from the initial state; K3 at M=2 over 2 years from K4's end,
    with K4's tables (one a member) and with K1's (one shared); at M=1
    K4 = K1 and K3 = K2 (``k1``, ``k2``: the single-run years; state,
    annual sums bitwise, monthly means against core.monthly_means of K2's
    outs at the golden tolerances); at M = capacity + 1 (two waves) the
    first and last members; ``tag`` names the grid in the lines printed.
    Returns the worst max |diff| per kernel and
    the plain versions' ms (K4 M=2, K3 M=2 x 2 years)."""
    import numpy as np
    import torch
    from greb_tpu_torch.model import core
    from greb_tpu_torch.ops.cuda import multiyear as my
    from greb_tpu_torch.parallel import ensemble as ens
    yd, n = m.year_data, m.num.nstep_yr
    err, plain_ms = {}, {}
    two = _sweep_members(m, 2)
    pp2 = my.pack_member_params(two, "cuda")
    s5 = ens.ensemble_initial_state(two, m.forcing)
    s4, c4 = my.fluxcorr_years(s5, pp2, co2f, yd)
    plain_ms["fluxcorr_years"], (s4p, c4p) = _time_ms(
        lambda: my.fluxcorr_years_plain(s5, pp2, co2f, yd), 1)
    if torch.equal(c4[0], c4[1]):
        raise AssertionError(f"{tag} K4: the members do not differ")
    err["fluxcorr_years"] = _bitwise(
        f"K4 {tag} (M=2, {n} steps)", [("state", s4, s4p),
                                         ("tables", c4, c4p)], quiet=True)
    co2y = np.asarray([560.0, 680.0], np.float32)
    k1_tab = torch.stack([k1[1].tf, k1[1].tof, k1[1].qf], dim=1)[None]
    err["scenario_years"] = 0.0
    names = ("state", "monthly means", "annual sums")
    for label, tab in (("a table per member", c4), ("one shared table",
                                                     k1_tab)):
        got = my.scenario_years(s4, pp2, tab, co2y, yd)
        ms, want = _time_ms(
            lambda: my.scenario_years_plain(s4, pp2, tab, co2y, yd), 1)
        plain_ms.setdefault("scenario_years", ms)
        if torch.equal(got[1][0], got[1][1]):
            raise AssertionError(f"{tag} K3: the members do not differ")
        err["scenario_years"] = max(err["scenario_years"], _bitwise(
            f"K3 {tag} (M=2, 2 years, {n} steps, {label})",
            zip(names, got, want), quiet=True))
    print(f"  plain versions on the card, {n} steps: K4 M=2 "
          f"{plain_ms['fluxcorr_years']:.1f} ms, K3 M=2 x 2 years "
          f"{plain_ms['scenario_years']:.1f} ms")
    # M=1 with the base params: K4 = K1, K3 = K2
    base = my.pack_member_params([m.params], "cuda")
    s41, c41 = my.fluxcorr_years(m.initial_state().stack()[:, None], base,
                                 co2f, yd)
    _bitwise(f"K4 = K1 {tag} (M=1)", [("state", s41[:, 0], k1[0].stack()),
                                       ("tables", c41[0], k1_tab[0])],
             quiet=True)
    s31, m31, a31 = my.scenario_years(k1[0].stack()[:, None], base, k1_tab,
                                      np.asarray([co2s]), yd)
    _bitwise(f"K3 = K2 {tag} (M=1)", [("state", s31[:, 0], k2[0].stack()),
                                       ("annual sums", a31[0, 0], k2[2])],
             quiet=True)
    _months_close(f"K3 vs K2 {tag} monthly",
                  m31[0].cpu().numpy(),
                  core.monthly_means(m.month_mat, k2[1]).cpu().numpy())
    # two waves: the first and the last member against plain
    M = capacity + 1
    many = _sweep_members(m, M)
    ppm = my.pack_member_params(many, "cuda")
    s5m = ens.ensemble_initial_state(many, m.forcing)
    s4m, c4m = my.fluxcorr_years(s5m, ppm, co2f, yd)
    s3m, m3m, a3m = my.scenario_years(s4m, ppm, c4m, co2y[1:], yd)
    pick = [0, M - 1]
    s4p, c4p = my.fluxcorr_years_plain(s5m[:, pick], ppm[pick], co2f, yd)
    err["fluxcorr_years"] = max(err["fluxcorr_years"], _bitwise(
        f"K4 {tag}, members 1 and {M} of {M} (2 waves)",
        [("state", s4m[:, pick], s4p), ("tables", c4m[pick], c4p)],
        quiet=True))
    want = my.scenario_years_plain(s4m[:, pick], ppm[pick], c4m[pick],
                                   co2y[1:], yd)
    err["scenario_years"] = max(err["scenario_years"], _bitwise(
        f"K3 {tag}, members 1 and {M} of {M} (2 waves)",
        zip(names, (s3m[:, pick], m3m[pick], a3m[pick]), want), quiet=True))
    return err, plain_ms


# the CLI's ensembles at 384x192: (kind, members, years, flags)
REFINED_ENSEMBLES = (("ensemble", REFINED_ENS_M, REFINED_ENS_YEARS, []),
                     ("shared", REFINED_SHARED_M, REFINED_SHARED_YEARS,
                      ["--shared-spinup"]))


def _refined_member_paths(model, tmp, state, monthly, corr, reset_counts,
                          read_counts, block=None,
                          ensembles=REFINED_ENSEMBLES, tag="refined"):
    """The member kernels' paths at a grid of the refined instantiation
    on the full calendar, on ``model`` (384x192: 1 + 3 years), after its
    per-year run (``state``, ``monthly``, ``corr``): the long run in K3
    blocks of ``block`` years (run_long + driver_year_runner,
    years_per_call = block; by default all the scenario years in one
    block), held to the per-year run (state bitwise, monthly means at the
    golden tolerances); the CLI's ensembles (``ensembles``: tag, M, years,
    flags; at 384x192 --ensemble REFINED_ENS_M with K4 spin-ups and
    --ensemble REFINED_SHARED_M --shared-spinup, K1 and K3 in two waves),
    each with launch counts, its files read back and its peak device
    memory.  ``tag`` names the grid in the lines printed.  Returns each
    path's wall, launches and peak memory."""
    import gc

    import numpy as np
    import torch
    from greb_tpu_torch import __main__ as cli
    from greb_tpu_torch.forcing import ModelState
    from greb_tpu_torch.io.binio import read_output
    from greb_tpu_torch.model import longrun
    num = model.num
    out = {}
    # -- the long run in K3 blocks: run_scenario(years_per_call > 1)
    block = block or num.time_scnr
    path = os.path.join(tmp, tag, "blocks")
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s_fc, c_fc = model.flux_correction()
    runner = longrun.driver_year_runner(model, path, years_per_call=block)
    try:
        s_b, _, _ = longrun.run_long(
            num.time_scnr, s_fc, c_fc, model.cfg.co2.series(num.time_scnr),
            runner, chunk_years=block)
    finally:
        runner.close()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    years = num.time_flux + num.time_scnr
    out["block"] = dict(wall=wall, launches=read_counts(
        f"{tag} block path", {"fluxcorr_year": num.time_flux,
                              "scenario_year": 0, "fluxcorr_years": 0,
                              "scenario_years": -(-num.time_scnr // block)}))
    print(f"{tag} block path (run_long, K3 blocks of {block} years): "
          f"{years} sim-years in {wall:.3f} s = {years / wall:.4f} sim-yr/s")
    if not torch.equal(c_fc.tf, corr.tf):
        raise AssertionError(f"{tag} block path: spin-up differs")
    _bitwise(f"{tag} block path vs per year", [
        (f"state {n}", getattr(s_b, n), getattr(state, n))
        for n in ModelState.FIELDS], quiet=True)
    back = read_output(path, num.xdim, num.ydim)
    if not np.isfinite(back).all():
        raise AssertionError(f"{tag} block path: output not finite")
    _months_close(f"{tag} blocks vs per-year monthly",
                  back.reshape(monthly.shape), monthly)
    # -- the CLI's ensembles: K4 spin-ups, or one K1 spin-up (shared)
    for kind, M, years_kw, flags in ensembles:
        shared = "--shared-spinup" in flags
        want = dict(fluxcorr_year=years_kw["time_flux"] * shared,
                    fluxcorr_years=years_kw["time_flux"] * (not shared))
        m = _with_years(model, **years_kw)
        path = os.path.join(tmp, f"{tag}_{kind}", "member")
        os.makedirs(os.path.dirname(path))
        args = cli.build_parser().parse_args(
            ["--ensemble", str(M), "--quiet"] + flags)
        gc.collect()
        torch.cuda.empty_cache()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        _, wall = _synced_s(lambda: cli.run_ensemble(m, path, args))
        peak = torch.cuda.max_memory_allocated()
        blocks = -(-m.num.time_scnr // cli.ensemble_block_years(M, m.num))
        launches = read_counts(f"{tag} {kind} path (M={M})", dict(
            want, scenario_year=0, scenario_years=blocks))
        years = m.num.time_flux + m.num.time_scnr
        nbytes = _read_members(path, M, m.num)
        cmd = " ".join(["--ensemble", str(M)] + flags)
        print(f"{tag} {kind} path ({cmd}, "
              f"{m.num.time_flux} + {m.num.time_scnr} years): {wall:.3f} s "
              f"= {M * years / wall:.4f} member-yr/s; {M} files, {nbytes} "
              f"B, read back finite; peak device memory {peak} B ({held} B "
              f"held before)")
        out[kind] = dict(wall=wall, launches=launches, peak=peak)
    return out


def _refined_path(tag, tmp, grid, years, reset_counts, read_counts,
                  fast=True):
    """GREB.run at a grid of the refined instantiation (``grid``) on the
    calendar and years of ``years`` (the full calendar where it sets no
    other; spin-up, scenario), with the fold or the
    strict circulation (``fast``, as ``_refined_model``), its output in
    tmp/tag/scenario: launch counts (K1 and K2 alone), sim-yr/s, the
    finiteness of state, tables and monthly means, the output file read
    back, the warming under 680 ppm (over two scenario years or more).
    Returns (model, state, corr, monthly, launches, sim-yr/s, timing):
    timing holds the ms of the path's own K1 and K2 launches (CUDA events
    around each, _TimedLaunches), the spin-up's end state, and the
    seconds of the forcing's regrid and of the model's build."""
    import numpy as np
    import torch
    from greb_tpu_torch.config import Numerics
    from greb_tpu_torch.forcing import ModelState
    from greb_tpu_torch.io.binio import read_output
    num = Numerics(**grid, **years)
    out = os.path.join(tmp, tag, "scenario")
    os.makedirs(os.path.dirname(out))
    t0 = time.perf_counter()
    model, regrid_s = _refined_model(num, out, verbose=True, fast=fast)
    build_s = time.perf_counter() - t0 - regrid_s
    spin = model.flux_correction
    kept = []
    model.flux_correction = lambda *a, **k: kept.append(spin(*a, **k)) \
        or kept[-1]
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with _TimedLaunches() as timer:
        state, corr, monthly, diags = model.run(output_path=out)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    del model.flux_correction
    timing = dict(regrid_s=regrid_s, build_s=build_s, spin_state=kept[0][0],
                  fluxcorr_year=timer.ms("greb_fluxcorr_year_"),
                  scenario_year=timer.ms("greb_scenario_year_"))
    launches = read_counts(f"{tag} path", {
        "fluxcorr_year": num.time_flux, "scenario_year": num.time_scnr,
        "fluxcorr_years": 0, "scenario_years": 0})
    n = num.time_flux + num.time_scnr
    print(f"{tag} path (GREB.run at {num.xdim}x{num.ydim}): {n} "
          f"sim-years in {wall:.3f} s = {n / wall:.4f} sim-yr/s "
          f"({num.time_flux} spin-up + {num.time_scnr} scenario, "
          f"{num.nstep_yr} steps, {num.nsub_crcl} substeps); forcing regrid "
          f"{regrid_s:.2f} s, model build {build_s:.2f} s; the path's "
          f"kernel launches K1 "
          f"{' '.join(f'{v:.3f}' for v in timing['fluxcorr_year'])} ms, K2 "
          f"{' '.join(f'{v:.3f}' for v in timing['scenario_year'])} ms")
    for name in ModelState.FIELDS:
        if not bool(torch.isfinite(getattr(state, name)).all()):
            raise AssertionError(f"{tag} state {name} not finite")
    for name in ("tf", "tof", "qf"):
        if not bool(torch.isfinite(getattr(corr, name)).all()):
            raise AssertionError(f"{tag} corr {name} not finite")
    shape = (num.time_scnr, len(num.jday_mon), 5, num.ydim, num.xdim)
    if monthly.shape != shape or not np.isfinite(monthly).all():
        raise AssertionError(f"{tag} monthly means {monthly.shape}")
    back = read_output(out, num.xdim, num.ydim)
    if not np.array_equal(back, monthly.reshape(-1, 5, num.ydim,
                                                num.xdim)):
        raise AssertionError(f"{tag} output file does not read back")
    gm = [float(d.global_mean_ts) for d in diags]
    print(f"  output file {os.path.getsize(out)} B read back; global mean Ts "
          f"[K] by scenario year: {' '.join(f'{g:.4f}' for g in gm)}")
    if len(gm) > 1 and not gm[-1] > gm[0]:
        raise AssertionError(f"{tag} path: no warming under 680 ppm: {gm}")
    return model, state, corr, monthly, launches, n / wall, timing


def _refined_phase(tmp, reset_counts, read_counts):
    """Step 13: the four kernels' refined instantiation at 384x192, and
    the refined paths.  Returns the worst max |diff| per kernel, the timed
    full-calendar launches, their plain versions' times on the 20-step
    calendar, their work, and each refined path's launches."""
    import numpy as np
    import torch
    from greb_tpu_torch.config import Numerics
    from greb_tpu_torch.ops import fastcirc2 as fc2
    from greb_tpu_torch.ops.cuda import multiyear as my
    from greb_tpu_torch.ops.cuda import year_kernel as yk

    t_phase = time.perf_counter()
    short = Numerics(**REFINED_GRID, **REFINED_SHORT)
    m, regrid_s = _refined_model(short)
    yd, plan = m.year_data, m.fold[0]
    _, ranks = yk.packed_ranks(m.fold[1])
    print(f"refined {short.xdim}x{short.ydim}: {short.nstep_yr}-step "
          f"calendar, {short.nsub_crcl} substeps, plan {plan}; {len(ranks)} "
          f"composite rows, ranks {int(ranks.min())}..{int(ranks.max())}, "
          f"Rtot {int(ranks.sum())}; regrid {regrid_s:.2f} s")

    # -- the refined block's shared memory: the kernel's own reckoning
    #    against refined_layout, and how many such clusters fit at once
    capacity = {}
    for kind in yk.KINDS:
        for c in yk.REFINED_CLUSTER_SIZES:
            lay = yk.refined_layout(plan, c, kind)
            parts, threads = yk.kernel_cluster_layout(plan, c, kind)
            if parts != dict(lay.parts) or threads != lay.threads:
                raise AssertionError(
                    f"refined {kind} C={c}: kernel layout {parts}, {threads} "
                    f"threads; refined_layout {dict(lay.parts)}, "
                    f"{lay.threads}")
            capacity[kind] = yk.cluster_capacity(plan, c, kind)
            print(f"refined cluster {kind:<14s} C={c:2d}: {lay.rows} "
                  f"rows/block, {lay.threads} threads, {lay.nbytes} B shared "
                  f"memory a block, {capacity[kind]} clusters at once; kernel "
                  f"and refined_layout agree: {dict(lay.parts)}")

    # -- K1 from the initial state, K2 from K1's end state with its
    #    corrections, on the 20-step calendar, bitwise against plain (the
    #    plain steps replayed from CUDA graphs)
    err = {}
    co2f, co2s = np.float32(340.0), np.float32(680.0)
    s0 = m.initial_state()
    s_k, c_k = yk.fluxcorr_year(s0, co2f, yd)
    k2 = yk.scenario_year(s_k, c_k, co2s, yd)
    graphed = _GraphedSteps().start()
    graphed.check(m, co2f)
    plain_ms = {}
    plain_ms["fluxcorr_year"], _ = _time_ms(
        lambda: yk.fluxcorr_year_plain(s0, co2f, yd), 1)
    err["fluxcorr_year"] = _k1_vs_plain(
        f"K1 refined, {short.nstep_yr} steps", s0, co2f, yd, (s_k, c_k))
    plain_ms["scenario_year"], _ = _time_ms(
        lambda: yk.scenario_year_plain(s_k, c_k, co2s, yd), 1)
    err["scenario_year"] = _k2_vs_plain(
        f"K2 refined, {short.nstep_yr} steps", s_k, c_k, co2s, yd, k2)
    for name, ten in (("K1 state", s_k.stack()), ("K1 tf", c_k.tf),
                      ("K2 state", k2[0].stack()), ("K2 outs", k2[1])):
        if not bool(torch.isfinite(ten).all()):
            raise AssertionError(f"refined {name} not finite")
    print(f"  plain versions on the card, {short.nstep_yr} steps: K1 "
          f"{plain_ms['fluxcorr_year']:.1f} ms, K2 "
          f"{plain_ms['scenario_year']:.1f} ms")
    t_members = time.perf_counter()
    member_err, member_plain = _refined_member_checks(
        m, (s_k, c_k), k2, co2f, co2s, capacity["scenario_years"])
    graphed.stop()
    err.update(member_err)
    plain_ms.update(member_plain)
    print(f"  member kernel checks: "
          f"{time.perf_counter() - t_members:.1f} s")
    del m, yd, s_k, c_k, k2

    # -- the refined path: GREB.run at 384x192, 1 + 3 years on the full
    #    calendar; then one K1 and one K2 year of its model timed
    model, state, corr, monthly, launches, _, timing = _refined_path(
        "refined", tmp, REFINED_GRID, REFINED_YEARS, reset_counts,
        read_counts)
    num = model.num
    paths = _refined_member_paths(model, tmp, state, monthly, corr,
                                  reset_counts, read_counts)

    yd, plan = model.year_data, model.fold[0]
    _, ranks = yk.packed_ranks(model.fold[1])
    s0 = model.initial_state()
    # K1's and K2's full-calendar years timed: the path's own launches
    # (CUDA events; one launch each, not a median of 3 after a warm-up)
    k1_ms, k2_ms = timing["fluxcorr_year"], timing["scenario_year"]
    s_k, c_k = timing["spin_state"], corr
    per_sub = 1e3 / (num.nstep_yr * num.nsub_crcl)
    # the member kernels at M=1 (K3 two years from K1's end state with
    # its tables; a warm-up, then one timed launch), then one K3 year at
    # M = capacity (one wave)
    base = my.pack_member_params([model.params], "cuda")
    k1_tab = torch.stack([c_k.tf, c_k.tof, c_k.qf], dim=1)[None]
    co2y = np.full(2, co2s, np.float32)
    k4_ms, _ = _launches_ms(lambda: my.fluxcorr_years(
        s0.stack()[:, None], base, co2f, yd), 1)
    k3_ms, _ = _launches_ms(lambda: my.scenario_years(
        s_k.stack()[:, None], base, k1_tab, co2y, yd), 1)
    wave = capacity["scenario_years"]
    ppw = my.pack_member_params(_sweep_members(model, wave), "cuda")
    s5w = s_k.stack()[:, None].repeat(1, wave, 1, 1)
    wave_ms, _ = _time_ms(lambda: my.scenario_years(
        s5w, ppw, k1_tab, co2y[:1], yd), 1)
    del ppw, s5w
    work = {"fluxcorr_year": yk.year_work(plan, num, False, ranks),
            "scenario_year": yk.year_work(plan, num, True, ranks),
            "fluxcorr_years": my.years_work(plan, num, 1, 1, "fluxcorr",
                                            ranks=ranks),
            "scenario_years": my.years_work(plan, num, 2, 1, "scenario",
                                            shared_corr=True, ranks=ranks)}
    wave_work = my.years_work(plan, num, 1, wave, "scenario",
                              shared_corr=True, ranks=ranks)
    for name, ms, shape in (("fluxcorr_year", k1_ms, "1 year"),
                            ("scenario_year", k2_ms, "1 year"),
                            ("fluxcorr_years", k4_ms, "M=1 x 1 year"),
                            ("scenario_years", k3_ms, "M=1 x 2 years")):
        b_ms, b_by = _bound_of(*work[name])
        years = 2 if name == "scenario_years" else 1
        after = ("in the path" if name in ("fluxcorr_year", "scenario_year")
                 else "after a warm-up")
        print(f"refined {name} ({shape}), {num.nstep_yr} steps: "
              f"{_runs(ms, after)}"
              f" = {_median(ms) * per_sub / years:.3f} us a substep (a "
              f"step's work included); bound {b_ms:.3f} ms by {b_by}")
    b_ms, b_by = _bound_of(*wave_work)
    print(f"refined scenario_years one year at M={wave} (one wave, the "
          f"shared table): {wave_ms:.3f} ms = {wave / wave_ms * 1e3:.4f} "
          f"member-yr/s; bound {b_ms:.3f} ms by {b_by}")
    # timing probes, not the model: the same K2 year at one substep a step
    # splits substep time from per-step time; with rank-1 composites (the
    # pole blocks' reads of the packed factors gone) and without the
    # explicit segments it shows what each adds to a substep
    const = model.fold[1]
    rows = const.pmask.shape[0]
    eye = np.eye(rows, dtype=np.float32)
    rank1 = dataclasses.replace(
        const, pcu=const.pcu[:, :rows].contiguous(),
        pcw=const.pcw[:rows].contiguous(),
        pmask=torch.as_tensor(eye, device="cuda"),
        pidx=fc2.packed_index(eye, "cuda"))
    one = dataclasses.replace(num, dt_crcl=num.dt)
    for label, fold in (
            ("as run", (plan, const)), ("rank-1 composites", (plan, rank1)),
            ("no segments", (dataclasses.replace(plan, diff_segs=(),
                                                 adv_segs=()), const))):
        ms = []
        for n in (num, one):
            if n is num and label == "as run":
                ms.append(_median(k2_ms))
                continue
            ydp = yk.YearData(md=yd.md, sfx=yd.sfx, fold=fold, num=n)
            yk.scenario_year(s_k, c_k, co2s, ydp)
            ms.append(_time_ms(
                lambda: yk.scenario_year(s_k, c_k, co2s, ydp), 1)[0])
        us = (ms[0] - ms[1]) * 1e3 / (num.nstep_yr * (num.nsub_crcl - 1))
        print(f"refined K2 probe, {label}: {ms[0]:.3f} ms a year, "
              f"{ms[1]:.3f} ms at 1 substep a step -> {us:.3f} us a "
              f"substep, {ms[1] * 1e3 / num.nstep_yr - us:.3f} us a step "
              f"outside the substeps")
    print(f"refined phase: {time.perf_counter() - t_phase:.1f} s")
    return dict(err=err, ms={"fluxcorr_year": _median(k1_ms),
                             "scenario_year": _median(k2_ms),
                             "fluxcorr_years": _median(k4_ms),
                             "scenario_years": _median(k3_ms)},
                plain_ms=plain_ms, work=work, launches=launches,
                capacity=capacity, paths=paths, wave=(wave, wave_ms,
                                                      wave_work))


def _grid192_phase(tmp, reset_counts, read_counts):
    """Step 14: the four kernels at 192x96 (the refined instantiation's
    additive form), the strict instantiation's K1 and K2 there, and the
    paths through them.  Returns the worst max |diff| per kernel, the timed
    full-calendar launches, their plain versions' times on the 20-step
    calendar, their work and each path's launches."""
    import numpy as np
    import torch
    from greb_tpu_torch.config import Numerics
    from greb_tpu_torch.ops.cuda import multiyear as my
    from greb_tpu_torch.ops.cuda import year_kernel as yk

    t_phase = time.perf_counter()
    short = Numerics(**G192_GRID, **REFINED_SHORT)
    m, regrid_s = _refined_model(short)
    yd, plan = m.year_data, m.fold[0]
    n = short.nstep_yr
    if not (yk.is_refined(plan) and not plan.seq_zonal
            and plan.comp_mode == "dense"):
        raise AssertionError(f"192x96: not the additive form: {plan}")
    print(f"grid192 {short.xdim}x{short.ydim}: {n}-step calendar, "
          f"{short.nsub_crcl} substeps, plan {plan}; regrid {regrid_s:.2f} s")

    # -- the block's shared memory: the kernel's own reckoning against
    #    refined_layout, the strict instantiation's against cluster_layout,
    #    and how many such clusters fit at once
    capacity = {}
    strict_plan = yk.StrictPlan(short.ydim, short.xdim)
    c = yk.REFINED_CLUSTER_SIZES[0]
    for kind in yk.KINDS:
        lay = yk.refined_layout(plan, c, kind)
        strict_lay = yk.cluster_layout(strict_plan, c, kind)
        for p, want in ((plan, lay), (strict_plan, strict_lay)):
            parts, threads = yk.kernel_cluster_layout(p, c, kind)
            if parts != dict(want.parts) or threads != want.threads:
                raise AssertionError(
                    f"grid192 {kind} {type(p).__name__}: kernel layout "
                    f"{parts}, {threads} threads; Python {dict(want.parts)}, "
                    f"{want.threads}")
        capacity[kind] = yk.cluster_capacity(plan, c, kind)
        print(f"grid192 cluster {kind:<14s} C={c:2d}: {lay.rows} rows/block, "
              f"{lay.threads} threads, {lay.nbytes} B shared memory a block "
              f"(strict {strict_lay.nbytes} B), {capacity[kind]} clusters at "
              f"once; kernel and Python agree: {dict(lay.parts)}")

    # -- K1 from the initial state, K2 from K1's end state with its
    #    corrections, on the 20-step calendar, bitwise against plain (the
    #    plain version's time includes the comparison; its steps replayed
    #    from CUDA graphs)
    err, plain_ms = {}, {}
    co2f, co2s = np.float32(340.0), np.float32(680.0)
    s0 = m.initial_state()
    s_k, c_k = yk.fluxcorr_year(s0, co2f, yd)
    k2 = yk.scenario_year(s_k, c_k, co2s, yd)
    graphed = _GraphedSteps().start()
    graphed.check(m, co2f)
    plain_ms["fluxcorr_year"], err["fluxcorr_year"] = _time_ms(
        lambda: _k1_vs_plain(f"K1 grid192, {n} steps", s0, co2f, yd,
                             (s_k, c_k)), 1)
    plain_ms["scenario_year"], err["scenario_year"] = _time_ms(
        lambda: _k2_vs_plain(f"K2 grid192, {n} steps", s_k, c_k, co2s, yd,
                             k2), 1)
    for name, ten in (("K1 state", s_k.stack()), ("K1 tf", c_k.tf),
                      ("K2 state", k2[0].stack()), ("K2 outs", k2[1])):
        if not bool(torch.isfinite(ten).all()):
            raise AssertionError(f"grid192 {name} not finite")
    print(f"  plain versions on the card, {n} steps: K1 "
          f"{plain_ms['fluxcorr_year']:.1f} ms, K2 "
          f"{plain_ms['scenario_year']:.1f} ms")
    member_err, member_plain = _refined_member_checks(
        m, (s_k, c_k), k2, co2f, co2s, capacity["scenario_years"],
        tag="grid192")
    err.update(member_err)
    plain_ms.update(member_plain)
    # -- the strict instantiation at 192x96: K1 and K2 bitwise
    mst, _ = _refined_model(short, fast=False)
    yds = mst.year_data
    if yds.transport != "strict":
        raise AssertionError(f"grid192 strict model: {yds.transport}")
    s0 = mst.initial_state()
    s_sk, c_sk = yk.fluxcorr_year(s0, co2f, yds)
    k2s = yk.scenario_year(s_sk, c_sk, co2s, yds)
    strict_err = {
        "fluxcorr_year": _k1_vs_plain(f"K1 grid192 strict, {n} steps", s0,
                                      co2f, yds, (s_sk, c_sk)),
        "scenario_year": _k2_vs_plain(f"K2 grid192 strict, {n} steps", s_sk,
                                      c_sk, co2s, yds, k2s)}
    graphed.stop()
    del m, yd, mst, yds, s_k, c_k, k2, s_sk, c_sk, k2s
    print(f"  20-step checks: {time.perf_counter() - t_phase:.1f} s")

    # -- the 192x96 path: GREB.run on the full calendar
    model, state, corr, monthly, launches, _, _ = _refined_path(
        "grid192", tmp, G192_GRID, G192_YEARS, reset_counts, read_counts)
    num = model.num
    paths = _refined_member_paths(model, tmp, state, monthly, corr,
                                  reset_counts, read_counts,
                                  block=G192_BLOCK, ensembles=G192_ENSEMBLES,
                                  tag="grid192")

    # -- one K1 and one K2 year, K4 at M=1 and K3 at M=1 x 2 years on the
    #    full calendar, timed (a warm-up, then 3 launches); the last
    #    launches held bitwise: K4 = K1, K3 = K2's two years from K1's end
    yd, plan = model.year_data, model.fold[0]
    s0 = model.initial_state()
    k1_ms, (s_k, c_k) = _launches_ms(
        lambda: yk.fluxcorr_year(s0, co2f, yd), 3)
    k2_ms, k2 = _launches_ms(lambda: yk.scenario_year(s_k, c_k, co2s, yd), 3)
    k2b = yk.scenario_year(k2[0], c_k, co2s, yd)
    base = my.pack_member_params([model.params], "cuda")
    k1_tab = torch.stack([c_k.tf, c_k.tof, c_k.qf], dim=1)[None]
    co2y = np.full(2, co2s, np.float32)
    k4_ms, (s4, c4) = _launches_ms(lambda: my.fluxcorr_years(
        s0.stack()[:, None], base, co2f, yd), 3)
    k3_ms, (s3, _, a3) = _launches_ms(lambda: my.scenario_years(
        s_k.stack()[:, None], base, k1_tab, co2y, yd), 3)
    err["fluxcorr_years"] = max(err["fluxcorr_years"], _bitwise(
        "K4 = K1 grid192, full calendar, last timed launches",
        [("state", s4[:, 0], s_k.stack()), ("tables", c4[0], k1_tab[0])],
        quiet=True))
    err["scenario_years"] = max(err["scenario_years"], _bitwise(
        "K3 (2 years) = K2 twice grid192, full calendar, last timed launches",
        [("state", s3[:, 0], k2b[0].stack()), ("annual sums 1", a3[0, 0],
                                              k2[2]),
         ("annual sums 2", a3[0, 1], k2b[2])], quiet=True))
    work = {"fluxcorr_year": yk.year_work(plan, num, False),
            "scenario_year": yk.year_work(plan, num, True),
            "fluxcorr_years": my.years_work(plan, num, 1, 1, "fluxcorr"),
            "scenario_years": my.years_work(plan, num, 2, 1, "scenario",
                                            shared_corr=True)}
    per_sub = 1e3 / (num.nstep_yr * num.nsub_crcl)
    for name, ms, shape in (("fluxcorr_year", k1_ms, "1 year"),
                            ("scenario_year", k2_ms, "1 year"),
                            ("fluxcorr_years", k4_ms, "M=1 x 1 year"),
                            ("scenario_years", k3_ms, "M=1 x 2 years")):
        b_ms, b_by = _bound_of(*work[name])
        years = 2 if name == "scenario_years" else 1
        print(f"grid192 {name} ({shape}), {num.nstep_yr} steps: {_runs(ms)}"
              f" = {_median(ms) * per_sub / years:.3f} us a substep (a "
              f"step's work included); bound {b_ms:.3f} ms by {b_by}")
    # timing probes, not the model: the same K2 year at one substep a step
    # splits substep time from per-step time; without the composite rows
    # and without the advection segments it shows what each adds to a
    # substep (both probes still run the additive form)
    one = dataclasses.replace(num, dt_crcl=num.dt)
    const = model.fold[1]
    for label, probe in (
            ("as run", plan),
            ("no composites", dataclasses.replace(
                plan, comp_mode="none", comp_kt=0, comp_kb=0)),
            ("no segments", dataclasses.replace(plan, adv_segs=()))):
        ms = []
        for n in (num, one):
            if n is num and probe is plan:
                ms.append(_median(k2_ms))
                continue
            ydp = yk.YearData(md=yd.md, sfx=yd.sfx, fold=(probe, const),
                              num=n)
            yk.scenario_year(s_k, c_k, co2s, ydp)
            ms.append(_time_ms(
                lambda: yk.scenario_year(s_k, c_k, co2s, ydp), 1)[0])
        us = (ms[0] - ms[1]) * 1e3 / (num.nstep_yr * (num.nsub_crcl - 1))
        print(f"grid192 K2 probe, {label}: {ms[0]:.3f} ms a year, "
              f"{ms[1]:.3f} ms at 1 substep a step -> {us:.3f} us a "
              f"substep, {ms[1] * 1e3 / num.nstep_yr - us:.3f} us a step "
              f"outside the substeps")
    seconds = time.perf_counter() - t_phase
    print(f"grid192 phase: {seconds:.1f} s")
    return dict(err=err, strict_err=strict_err,
                ms={"fluxcorr_year": _median(k1_ms),
                    "scenario_year": _median(k2_ms),
                    "fluxcorr_years": _median(k4_ms),
                    "scenario_years": _median(k3_ms)},
                plain_ms=plain_ms, work=work, launches=launches,
                capacity=capacity, paths=paths)


def _pick_check(tag, kernel, yd):
    """The kernel's own pick of a refined launcher for yd's word and form
    (greb_refined_pick) must be the entry refined_entry names; returns
    that name."""
    from greb_tpu_torch.ops.cuda import year_kernel as yk
    name = yk.refined_entry(kernel, yd.plan, yd.flags)
    got = yk.kernel_entry(kernel, yd.plan, yd.flags)
    if got != name:
        raise AssertionError(f"{tag}: the launcher picks {got}, want {name}")
    return name


def _finite(tag, tensors):
    import torch
    for name, ten in tensors:
        if not bool(torch.isfinite(ten).all()):
            raise AssertionError(f"{tag} {name} not finite")


def _short_members(m, tag, co2f, co2s, k1, k2, k2_in, after_k4=True,
                   k3_years=2):
    """K4 at M=2 (ct_sens 22.05, 22.95) from the members' initial states
    and K3 at M=2 over ``k3_years`` years (CO2 560, 680) from K4's end with K4's
    tables (``after_k4``) or from the initial states with zero tables (on
    a calendar too short for a scenario after a spin-up to stay finite),
    each bitwise against its plain version on m's calendar; at M=1 with
    the base params K4 = K1 (``k1``: K1's year from the initial state at
    ``co2f``) and K3 = K2 (``k2``: K2's year at ``co2s`` from ``k2_in``, a
    state and its corrections).  Returns the worst max |diff| per kernel,
    the plain versions' ms and the kernels' launch ms (K4 M=2, K3 M=2 x
    k3_years years)."""
    import numpy as np
    import torch
    from greb_tpu_torch.ops.cuda import multiyear as my
    from greb_tpu_torch.parallel import ensemble as ens
    yd, n = m.year_data, m.num.nstep_yr
    err, plain_ms, ms = {}, {}, {}
    two = _sweep_members(m, 2)
    pp2 = my.pack_member_params(two, "cuda")
    s5 = ens.ensemble_initial_state(two, m.forcing)
    ms["fluxcorr_years"], (s4, c4) = _time_ms(
        lambda: my.fluxcorr_years(s5, pp2, co2f, yd), 1)
    plain_ms["fluxcorr_years"], (s4p, c4p) = _time_ms(
        lambda: my.fluxcorr_years_plain(s5, pp2, co2f, yd), 1)
    if torch.equal(c4[0], c4[1]):
        raise AssertionError(f"{tag} K4: the members do not differ")
    _finite(f"{tag} K4", [("state", s4), ("tables", c4)])
    err["fluxcorr_years"] = _bitwise(
        f"K4 {tag} (M=2, {n} steps)", [("state", s4, s4p),
                                         ("tables", c4, c4p)], quiet=True)
    co2y = np.asarray([560.0, 680.0][:k3_years], np.float32)
    s3_in, c3_in = (s4, c4) if after_k4 else (s5, torch.zeros_like(c4))
    ms["scenario_years"], got = _time_ms(
        lambda: my.scenario_years(s3_in, pp2, c3_in, co2y, yd), 1)
    plain_ms["scenario_years"], want = _time_ms(
        lambda: my.scenario_years_plain(s3_in, pp2, c3_in, co2y, yd), 1)
    if torch.equal(got[1][0], got[1][1]):
        raise AssertionError(f"{tag} K3: the members do not differ")
    names = ("state", "monthly means", "annual sums")
    _finite(f"{tag} K3", zip(names, got))
    err["scenario_years"] = _bitwise(
        f"K3 {tag} (M=2, {k3_years} years, {n} steps)", zip(names, got, want),
        quiet=True)
    base = my.pack_member_params([m.params], "cuda")
    k1_tab = torch.stack([k1[1].tf, k1[1].tof, k1[1].qf], dim=1)[None]
    s41, c41 = my.fluxcorr_years(m.initial_state().stack()[:, None], base,
                                 co2f, yd)
    err["fluxcorr_years"] = max(err["fluxcorr_years"], _bitwise(
        f"K4 = K1 {tag} (M=1)", [("state", s41[:, 0], k1[0].stack()),
                                  ("tables", c41[0], k1_tab[0])],
        quiet=True))
    s_in, tab = k2_in[0], torch.stack([k2_in[1].tf, k2_in[1].tof,
                                       k2_in[1].qf], dim=1)[None]
    s31, _, a31 = my.scenario_years(s_in.stack()[:, None], base, tab,
                                    np.asarray([co2s]), yd)
    err["scenario_years"] = max(err["scenario_years"], _bitwise(
        f"K3 = K2 {tag} (M=1)", [("state", s31[:, 0], k2[0].stack()),
                                  ("annual sums", a31[0, 0], k2[2])],
        quiet=True))
    return err, plain_ms, ms


def _words_phase(tmp, reset_counts, read_counts):
    """Step 16: the legacy fold words at the refined grids (the refined
    instantiation's legacy variant in both forms).  Returns the worst max
    |diff| per kernel, the plain versions' and the kernels' times and
    work, and each path's launches."""
    import contextlib
    import gc
    import io

    import numpy as np
    import torch
    from greb_tpu_torch import __main__ as cli
    from greb_tpu_torch.config import Numerics
    from greb_tpu_torch.forcing import Corrections
    from greb_tpu_torch.io.binio import read_output, read_records
    from greb_tpu_torch.ops.cuda import year_kernel as yk

    t_phase = time.perf_counter()
    err = dict.fromkeys(("fluxcorr_year", "scenario_year", "fluxcorr_years",
                         "scenario_years"), 0.0)
    co2s = np.float32(680.0)
    out = dict(plain_ms={}, ms={}, work={})
    # the words' models of a grid and calendar share one fold (none of
    # these words changes the topography)
    folds = _SharedFolds().start()
    # -- K1 from the initial state and K2 from it with zero corrections,
    #    bitwise against plain, under each fold word at both grids
    for gtag, grid in (("384x192", REFINED_GRID), ("192x96", G192_GRID)):
        short = Numerics(**grid, **WORDS_SHORT)
        t0, plain_s = time.perf_counter(), 0.0
        for e in WORD_EXPS:
            m, _ = _refined_model(short, log_exp=e)
            yd = m.year_data
            tag = f"{gtag} log_exp {e:2d} (flags {yd.flags:#04x})"
            names = [_pick_check(tag, k, yd) for k in
                     ("fluxcorr_year", "scenario_year", "fluxcorr_years",
                      "scenario_years")]
            co2 = np.float32(m.exp.co2_ctrl)
            s0 = m.initial_state()
            zero = Corrections.zeros(short.nstep_yr, short.ydim, short.xdim,
                                     device="cuda")
            k1 = yk.fluxcorr_year(s0, co2, yd)
            k2 = yk.scenario_year(s0, zero, co2s, yd)
            _finite(f"K1 {tag}", [("state", k1[0].stack()),
                                  ("tf", k1[1].tf)])
            _finite(f"K2 {tag}", [("state", k2[0].stack()),
                                  ("outs", k2[1])])
            t1 = time.perf_counter()
            err["fluxcorr_year"] = max(err["fluxcorr_year"], _k1_vs_plain(
                f"K1 {tag}", s0, co2, yd, k1))
            err["scenario_year"] = max(err["scenario_year"], _k2_vs_plain(
                f"K2 {tag}", s0, zero, co2s, yd, k2))
            plain_s += time.perf_counter() - t1
            print(f"  {tag}: {', '.join(names)}")
        print(f"legacy words at {gtag}, {len(WORD_EXPS)} words on a "
              f"{short.nstep_yr}-step calendar: "
              f"{time.perf_counter() - t0:.1f} s (plain versions "
              f"{plain_s:.1f} s)")

    # -- under the member words, on the 20-step calendar: K1, K2 from its
    #    end, K4 (M=2) and K3 (M=2 x 2 years) bitwise against plain, K4 =
    #    K1 and K3 = K2 at M=1 (the plain steps replayed from CUDA graphs)
    for gtag, grid in (("384x192", REFINED_GRID), ("192x96", G192_GRID)):
        short = Numerics(**grid, **REFINED_SHORT)
        for e in WORD_MEMBER_EXPS:
            t0 = time.perf_counter()
            m, _ = _refined_model(short, log_exp=e)
            yd = m.year_data
            tag = f"{gtag} log_exp {e}"
            co2 = np.float32(m.exp.co2_ctrl)
            s0 = m.initial_state()
            with _GraphedSteps() as graphed:
                graphed.check(m, co2)
                ms1, k1 = _time_ms(lambda: yk.fluxcorr_year(s0, co2, yd), 1)
                ms2, k2 = _time_ms(
                    lambda: yk.scenario_year(k1[0], k1[1], co2s, yd), 1)
                _finite(f"K2 {tag}", [("state", k2[0].stack())])
                p1, _ = _time_ms(lambda: _k1_vs_plain(
                    f"K1 {tag}, {short.nstep_yr} steps", s0, co2, yd, k1), 1)
                p2, _ = _time_ms(lambda: _k2_vs_plain(
                    f"K2 {tag}, {short.nstep_yr} steps", k1[0], k1[1], co2s,
                    yd, k2), 1)
                m_err, m_plain, m_ms = _short_members(m, tag, co2, co2s, k1,
                                                      k2, k1)
            for name, v in m_err.items():
                err[name] = max(err[name], v)
            if e == WORD_MEMBER_EXPS[0]:
                key = f"refined_legacy_{gtag}"
                out["ms"][key] = dict(fluxcorr_year=ms1, scenario_year=ms2,
                                      **m_ms)
                out["plain_ms"][key] = dict(fluxcorr_year=p1,
                                            scenario_year=p2, **m_plain)
                ranks = (yk.packed_ranks(m.fold[1])[1]
                         if m.fold[0].comp_mode == "packed" else None)
                out["work"][key] = _work4(m, ranks)
            print(f"  {tag}, {short.nstep_yr} steps: kernels K1 {ms1:.1f} "
                  f"ms, K2 {ms2:.1f} ms, K4 M=2 {m_ms['fluxcorr_years']:.1f}"
                  f" ms, K3 M=2 x 2 years {m_ms['scenario_years']:.1f} ms; "
                  f"plain (graphed) K1 {p1:.1f} ms, K2 {p2:.1f} ms, K4 "
                  f"{m_plain['fluxcorr_years']:.1f} ms, K3 "
                  f"{m_plain['scenario_years']:.1f} ms; "
                  f"{time.perf_counter() - t0:.1f} s")
            del m, yd, k1, k2
            gc.collect()
            torch.cuda.empty_cache()

    # -- the legacy path at 384x192: run_legacy at log_exp 13, 1 spin-up
    #    and 1 scenario year on the full calendar, both files written
    num = Numerics(**REFINED_GRID, **WORD_PATH_YEARS)
    path = os.path.join(tmp, "words", "scenario")
    m, _ = _refined_model(num, path, log_exp=WORD_PATH_EXP)
    console = io.StringIO()
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(console):
        cli.run_legacy(m, path)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    out["launches_path"] = read_counts(
        f"refined legacy path (384x192, log_exp {WORD_PATH_EXP})", {
            "fluxcorr_year": num.time_flux,
            "scenario_year": num.time_ctrl + num.time_scnr,
            "fluxcorr_years": 0, "scenario_years": 0})
    Y, X = num.ydim, num.xdim
    ctl = read_records(os.path.join(tmp, "words", "control"), (Y, X))
    back = read_output(path, X, Y)
    if ctl.shape[0] != num.nstep_yr or not np.isfinite(ctl).all() \
            or back.shape != (num.time_scnr * len(num.jday_mon), 5, Y, X) \
            or not np.isfinite(back).all():
        raise AssertionError(f"refined legacy path files: control "
                             f"{ctl.shape}, scenario {back.shape}")
    years = num.time_flux + num.time_scnr
    out["path_rate"] = years / wall
    print(f"refined legacy path (run_legacy at 384x192, log_exp "
          f"{WORD_PATH_EXP}): {years} sim-years in {wall:.3f} s = "
          f"{years / wall:.4f} sim-yr/s; control file {ctl.shape[0]} "
          f"records, scenario {back.shape[0]} months, finite")
    del m

    # -- run_ensemble under a legacy fold word at 192x96: K4 spin-ups, K3
    M, years_kw = WORD_ENS
    num = Numerics(**G192_GRID, **years_kw)
    m, _ = _refined_model(num, log_exp=WORD_ENS_EXP)
    path = os.path.join(tmp, "words_ensemble", "member")
    os.makedirs(os.path.dirname(path))
    args = cli.build_parser().parse_args(["--ensemble", str(M), "--quiet"])
    reset_counts()
    _, wall = _synced_s(lambda: cli.run_ensemble(m, path, args))
    out["launches_ensemble"] = read_counts(
        f"192x96 ensemble path, log_exp {WORD_ENS_EXP} (M={M})", {
            "fluxcorr_year": 0, "scenario_year": 0,
            "fluxcorr_years": num.time_flux,
            "scenario_years": -(-num.time_scnr
                                // cli.ensemble_block_years(M, num))})
    nbytes = _read_members(path, M, num)
    print(f"192x96 ensemble path under log_exp {WORD_ENS_EXP} (--ensemble "
          f"{M}, {num.time_flux} + {num.time_scnr} years): {wall:.3f} s; {M} "
          f"files, {nbytes} B, read back finite")
    folds.stop()
    out["err"] = err
    print(f"words phase: {time.perf_counter() - t_phase:.1f} s")
    return out


def _work4(m, ranks=None, k3_years=2):
    """year_work / years_work of the four kernels at m's calendar and
    word, at the shapes _short_members and the single-run checks launch:
    K1 and K2 a year, K4 M=2, K3 M=2 x k3_years years (a table per
    member)."""
    from greb_tpu_torch.ops.cuda import multiyear as my
    from greb_tpu_torch.ops.cuda import year_kernel as yk
    yd, num = m.year_data, m.num
    plan, flags = yd.plan, yd.flags
    return {"fluxcorr_year": yk.year_work(plan, num, False, ranks, flags),
            "scenario_year": yk.year_work(plan, num, True, ranks, flags),
            "fluxcorr_years": my.years_work(plan, num, 1, 2, "fluxcorr",
                                            ranks=ranks, flags=flags),
            "scenario_years": my.years_work(plan, num, k3_years, 2,
                                            "scenario", ranks=ranks,
                                            flags=flags)}


def _strict_refined_phase(tmp, reset_counts, read_counts):
    """Step 17: the strict transport at 384x192 (the refined
    instantiation's strict form) under every strict and no-transport word,
    and the library default's path there.  Returns the worst max |diff|
    per kernel, the launches' and plain versions' times and work, the
    full-calendar years' times, and the path's launches."""
    import gc

    import numpy as np
    import torch
    from greb_tpu_torch.config import Numerics
    from greb_tpu_torch.forcing import Corrections
    from greb_tpu_torch.model import core
    from greb_tpu_torch.ops.cuda import year_kernel as yk

    t_phase = time.perf_counter()
    err = dict.fromkeys(("fluxcorr_year", "scenario_year", "fluxcorr_years",
                         "scenario_years"), 0.0)
    co2s = np.float32(680.0)
    out = dict(plain_ms={}, ms={}, work={})
    short = Numerics(**REFINED_GRID, **STRICT_REFINED_SHORT)
    graphed = _GraphedCirculation().start()
    for e in STRICT_REFINED_MODES:
        t0 = time.perf_counter()
        m, _ = _refined_model(short, fast=e is not None, log_exp=e)
        yd = m.year_data
        if not (yk.refined_form(yd.plan) == "strict" and yk.is_refined(
                yd.plan)):
            raise AssertionError(f"log_exp {e}: plan {yd.plan}")
        if e == STRICT_REFINED_MODES[0]:
            plan = yd.plan
            for kind in yk.KINDS:
                lay = yk.strict_refined_layout(plan, 16, kind)
                parts, threads = yk.kernel_cluster_layout(plan, 16, kind)
                if parts != dict(lay.parts) or threads != lay.threads:
                    raise AssertionError(
                        f"strict refined {kind}: kernel layout {parts}, "
                        f"{threads} threads; Python {dict(lay.parts)}, "
                        f"{lay.threads}")
                print(f"strict refined cluster {kind:<14s} C=16: "
                      f"{lay.rows} rows/block, {lay.threads} threads, "
                      f"{lay.nbytes} B shared memory a block, "
                      f"{yk.cluster_capacity(plan, 16, kind)} clusters at "
                      f"once; kernel and strict_refined_layout agree: "
                      f"{dict(lay.parts)}")
            nd, na = plan.sub_cycles
            print(f"  sub-cycles from each pole: diffusion {nd[:8]}, "
                  f"advection {na[:8]}; {short.nstep_yr}-step calendar, "
                  f"{short.nsub_crcl} substeps")
            t1 = time.perf_counter()
            out["circulation_ms"] = graphed.check(m)
            print(f"  plain strict circulation of a step (Ta, q): "
                  f"{out['circulation_ms'][1]:.1f} ms eager, "
                  f"{out['circulation_ms'][0]:.1f} ms replayed from its CUDA "
                  f"graph; capture and check {time.perf_counter() - t1:.1f} s")
        mode = "strict circulation" if e is None else f"log_exp {e}"
        tag = f"384x192 {mode} (flags {yd.flags:#05x})"
        names = [_pick_check(tag, k, yd) for k in
                 ("fluxcorr_year", "scenario_year", "fluxcorr_years",
                  "scenario_years")]
        co2 = np.float32(m.exp.co2_ctrl if m.exp.active else 340.0)
        s0 = m.initial_state()
        zero = Corrections.zeros(short.nstep_yr, short.ydim, short.xdim,
                                 device="cuda")
        ms1, k1 = _time_ms(lambda: yk.fluxcorr_year(s0, co2, yd), 1)
        ms2, k2 = _time_ms(lambda: yk.scenario_year(s0, zero, co2s, yd), 1)
        _finite(f"K1 {tag}", [("state", k1[0].stack()), ("tf", k1[1].tf)])
        _finite(f"K2 {tag}", [("state", k2[0].stack()), ("outs", k2[1])])
        p1, e1 = _time_ms(lambda: _k1_vs_plain(f"K1 {tag}", s0, co2, yd,
                                               k1), 1)
        p2, e2 = _time_ms(lambda: _k2_vs_plain(f"K2 {tag}", s0, zero, co2s,
                                               yd, k2), 1)
        err["fluxcorr_year"] = max(err["fluxcorr_year"], e1)
        err["scenario_year"] = max(err["scenario_year"], e2)
        # K3 over two years (its year loop) under the strict circulation
        # and under log_exp 4, whose year boundary is ordered by the
        # __syncthreads() of the strict form without a step-start barrier;
        # one under log_exp 7, 8 and 16, whose boundary is the step-start
        # cluster.sync() the strict circulation's two years cover (a plain
        # strict step replays in ~2 s)
        ny = 2 if e in (None, 4) else 1
        m_err, m_plain, m_ms = _short_members(m, tag, co2, co2s, k1, k2,
                                              (s0, zero), after_k4=False,
                                              k3_years=ny)
        for name, v in m_err.items():
            err[name] = max(err[name], v)
        out["ms"][mode] = dict(fluxcorr_year=ms1, scenario_year=ms2, **m_ms)
        out["plain_ms"][mode] = dict(fluxcorr_year=p1, scenario_year=p2,
                                     **m_plain)
        out["work"][mode] = _work4(m, k3_years=ny)
        print(f"  {tag}: {', '.join(names)}; kernels K1 {ms1:.1f} ms, K2 "
              f"{ms2:.1f} ms, K4 M=2 {m_ms['fluxcorr_years']:.1f} ms, K3 M=2"
              f" x {ny} years {m_ms['scenario_years']:.1f} ms; plain K1 "
              f"{p1:.1f} ms, K2 {p2:.1f} ms, K4 {m_plain['fluxcorr_years']:.1f}"
              f" ms, K3 {m_plain['scenario_years']:.1f} ms; "
              f"{time.perf_counter() - t0:.1f} s")
        # the graphs stay for the next modes: the strict circulation's (2,
        # Y, X) call, log_exp 7's and 16's Ta and log_exp 8's Ta share the
        # advection graph of one field (a capture ~19 s on an H100); step 21
        # shards the strict circulation's model
        if e is None:
            out["short_model"] = m
        del m, yd, k1, k2
        gc.collect()
        torch.cuda.empty_cache()
    graphed.stop()

    # -- the library default at 384x192: GREB.run with the strict
    #    circulation (GrebConfig's default), 1 + 1 years; its own K1 and K2
    #    launches are the full-calendar strict years timed (CUDA events)
    model, state, corr, monthly, launches, rate, timing = _refined_path(
        "strict_refined", tmp, REFINED_GRID, STRICT_REFINED_YEARS,
        reset_counts, read_counts, fast=None)
    out["launches_path"], out["path_rate"] = launches, rate
    num, yd = model.num, model.year_data
    per_sub = 1e3 / (num.nstep_yr * num.nsub_crcl)
    # -- the strict form's wide variant forced onto 2 clusters
    #    (year_kernel._forced: each pole's rows spread over its own
    #    cluster, the halo rows across the clusters' edge at a grid
    #    barrier), the path's K2 year again from the spin-up's end state
    #    with its tables, bitwise against the path's
    #    (scenario_year_strict_refined) on the full calendar
    two = yk._forced(yd, groups=2)
    name = _pick_check("384x192 on 2 clusters", "scenario_year", two)
    ms_two, (s_two, o_two, _) = _time_ms(lambda: yk.scenario_year(
        timing["spin_state"], corr, model._co2_series()[0], two), 1)
    _bitwise(f"384x192 strict K2 on 2 clusters ({name}) vs the path's "
             f"(scenario_year_strict_refined), the full calendar", [
                 ("state", s_two.stack(), state.stack()),
                 ("monthly means", core.monthly_means(
                     model.month_mat, o_two).cpu(),
                  torch.from_numpy(monthly[0]))])
    out["two_clusters_ms"] = ms_two
    print(f"  384x192 strict K2 year on 2 clusters: {ms_two:.1f} ms (the "
          f"path's on 1: {timing['scenario_year'][0]:.1f} ms)")
    del two, s_two, o_two
    out["full_ms"] = {k: timing[k][0] for k in ("fluxcorr_year",
                                                "scenario_year")}
    out["full_work"] = {k: yk.year_work(yd.plan, num, k == "scenario_year",
                                        flags=yd.flags)
                        for k in ("fluxcorr_year", "scenario_year")}
    for name, ms in out["full_ms"].items():
        b_ms, b_by = _bound_of(*out["full_work"][name])
        print(f"strict refined {name} (1 year, the path's), "
              f"{num.nstep_yr} steps: {ms:.3f} ms = {ms * per_sub:.3f} us a "
              f"substep (a step's work included); {1e3 / ms:.4f} sim-yr/s; "
              f"bound {b_ms:.3f} ms by {b_by}")
    del model, yd, state, corr, monthly
    gc.collect()
    torch.cuda.empty_cache()
    out["err"] = err
    print(f"strict refined phase: {time.perf_counter() - t_phase:.1f} s")
    return out


def _grid768_model(num, **kw):
    """_refined_model at 768x384 with its host set-up timed: (model,
    seconds of the regrid, seconds of the model build)."""
    t0 = time.perf_counter()
    m, regrid_s = _refined_model(num, **kw)
    return m, regrid_s, time.perf_counter() - t0 - regrid_s


def _grid768_runner(model, tmp, tag):
    """Config 5's long run on G768_SHORT's calendar: a checkpoint every
    G768_BLOCK years, K3 blocks of G768_BLOCK years, the output file."""
    from greb_tpu_torch.io.checkpoint import Checkpointer
    from greb_tpu_torch.model import longrun
    ck = Checkpointer(os.path.join(tmp, f"ck768_{tag}"),
                      every_years=G768_BLOCK)
    runner = longrun.driver_year_runner(
        model, os.path.join(tmp, f"long768_{tag}"), years_per_call=G768_BLOCK)
    return ck, runner


def _resume_long768(tmp: str, strict: bool = False) -> int:
    """The fresh process of steps 18 and 23 (``strict``: the library
    default's): rebuild the 768x384 model on the short calendar (step
    18's fold read from the one the first process left in ``tmp``), resume
    config 5's stopped long run from its newest checkpoint and run it to
    G768_LONG years."""
    t0 = time.perf_counter()
    import numpy as np
    import torch
    from greb_tpu_torch.config import Numerics
    from greb_tpu_torch.model import longrun
    from greb_tpu_torch.ops.cuda import multiyear as my
    with _SharedFolds(cache_dir=tmp):
        model, _, _ = _grid768_model(Numerics(**G768_GRID, **G768_SHORT),
                                     fast=None if strict else True)
    ck, runner = _grid768_runner(model, tmp,
                                 "strict_resumed" if strict else "resumed")
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    _, _, start = longrun.run_long(
        G768_LONG, None, None, np.full(G768_LONG, 680.0, np.float32), runner,
        checkpointer=ck, chunk_years=G768_BLOCK, device=model.device)
    torch.cuda.synchronize()
    runner.close()
    print(json.dumps({"start": start, "setup_s": t1 - t0,
                      "run_s": time.perf_counter() - t1,
                      "scenario_years_launches": my.scenario_years.launches}))
    return 0


def _grid768_phase(tmp, reset_counts, read_counts, prebuilt=None):
    """Step 18: 768x384 at dt_crcl=450 (config 5) in the refined
    instantiation's wide form, and the paths through it (``prebuilt``:
    the short-calendar model as _grid768_model returned it, made during
    the build).  Returns the worst max |diff| per kernel, the
    short-calendar launches and plain versions, the full-calendar
    launches, their work, and each path's launches."""
    import gc
    import subprocess

    import numpy as np
    import torch
    from greb_tpu_torch import __main__ as cli
    from greb_tpu_torch.config import Numerics
    from greb_tpu_torch.forcing import Corrections, ModelState
    from greb_tpu_torch.model import longrun
    from greb_tpu_torch.ops.cuda import multiyear as my
    from greb_tpu_torch.ops.cuda import year_kernel as yk
    from greb_tpu_torch.parallel import ensemble as ens

    t_phase = time.perf_counter()
    out = dict(plain_ms={}, short_ms={}, ms={}, work={}, err={})
    short = Numerics(**G768_GRID, **G768_SHORT)
    # the short-calendar models (modern, log_exp 11, the ensemble's 10
    # steps) share one fold; the path's model builds its own, timed
    folds = _SharedFolds(cache_dir=tmp).start()
    m, regrid_s, build_s = prebuilt or _grid768_model(short)
    yd, plan = m.year_data, m.fold[0]
    n = short.nstep_yr
    groups = yk.refined_groups(plan)
    _, ranks = yk.packed_ranks(m.fold[1])
    if not (plan.seq_zonal and plan.comp_mode == "packed" and groups > 1):
        raise AssertionError(f"768x384: not the wide form: {plan}")
    print(f"grid768 {short.xdim}x{short.ydim}: {n}-step calendar, "
          f"{short.nsub_crcl} substeps, plan {plan}; {len(ranks)} composite "
          f"rows, ranks {int(ranks.min())}..{int(ranks.max())}, Rtot "
          f"{int(ranks.sum())}; regrid {regrid_s:.2f} s, build {build_s:.2f} s"
          + (" (on the host while the kernels built)" if prebuilt else ""))

    # -- the wide block's shared memory: the kernel's own reckoning against
    #    refined_layout on `groups` clusters, and how many clusters fit
    c = yk.REFINED_CLUSTER_SIZES[0]
    capacity = {}
    for kind in yk.KINDS:
        lay = yk.block_layout(plan, c, kind)
        parts, threads = yk.kernel_cluster_layout(plan, c, kind)
        if parts != dict(lay.parts) or threads != lay.threads \
                or lay.groups != groups:
            raise AssertionError(
                f"grid768 {kind}: kernel layout {parts}, {threads} threads; "
                f"refined_layout {dict(lay.parts)}, {lay.threads}, "
                f"{lay.groups} clusters")
        capacity[kind] = yk.cluster_capacity(plan, c, kind)
        print(f"grid768 {kind:<14s}: {groups} clusters of {c} blocks a run, "
              f"{lay.rows} rows/block, {lay.threads} threads, {lay.nbytes} B "
              f"shared memory a block, {capacity[kind]} clusters at once "
              f"({yk.check_resident(groups, capacity[kind], 99)} member(s) a "
              f"launch); kernel and refined_layout agree: {dict(lay.parts)}")

    # -- on the short calendar (where a scenario after a spin-up with its
    #    tables, or a second year on them, is not finite):
    #    K1 from the initial state, K2 from it with zero corrections, K4 at
    #    M=2, K3 at M=2 x 2 years from the initial states with zero tables
    #    (a table per member), K4 = K1 and K3 = K2 at M=1, and K3 at M=2
    #    reading K1's tables as one shared table for a year, each bitwise
    #    against its plain version, eager (on a 2-step calendar a step's
    #    CUDA graph would be replayed once or twice after a capture that
    #    costs more than the eager step); then K1 and K2 under log_exp 11
    err = dict.fromkeys(("fluxcorr_year", "scenario_year", "fluxcorr_years",
                         "scenario_years"), 0.0)
    co2f, co2s = np.float32(340.0), np.float32(680.0)
    s0 = m.initial_state()
    zero = Corrections.zeros(n, short.ydim, short.xdim, device="cuda")
    names = [_pick_check("grid768", k, yd) for k in
             ("fluxcorr_year", "scenario_year", "fluxcorr_years",
              "scenario_years")]
    reset_counts()
    ms1, k1 = _time_ms(lambda: yk.fluxcorr_year(s0, co2f, yd), 1)
    ms2, k2 = _time_ms(lambda: yk.scenario_year(s0, zero, co2s, yd), 1)
    _finite("grid768 K1", [("state", k1[0].stack()), ("tf", k1[1].tf)])
    _finite("grid768 K2", [("state", k2[0].stack()), ("outs", k2[1])])
    p1, err["fluxcorr_year"] = _time_ms(lambda: _k1_vs_plain(
        f"K1 grid768, {n} steps", s0, co2f, yd, k1), 1)
    p2, err["scenario_year"] = _time_ms(lambda: _k2_vs_plain(
        f"K2 grid768, {n} steps", s0, zero, co2s, yd, k2), 1)
    m_err, m_plain, m_ms = _short_members(m, "grid768", co2f, co2s, k1,
                                          k2, (s0, zero), after_k4=False)
    err.update(m_err)
    two = _sweep_members(m, 2)
    pp2 = my.pack_member_params(two, "cuda")
    s5 = ens.ensemble_initial_state(two, m.forcing)
    k1_tab = torch.stack([k1[1].tf, k1[1].tof, k1[1].qf], dim=1)[None]
    co2y = np.asarray([560.0], np.float32)
    got = my.scenario_years(s5, pp2, k1_tab, co2y, yd)
    want = my.scenario_years_plain(s5, pp2, k1_tab, co2y, yd)
    if torch.equal(got[1][0], got[1][1]):
        raise AssertionError("grid768 K3 shared: members do not differ")
    _finite("grid768 K3 shared", zip(("state", "monthly"), got))
    err["scenario_years"] = max(err["scenario_years"], _bitwise(
        f"K3 grid768 (M=2, 1 year, {n} steps, K1's tables shared)",
        zip(("state", "monthly means", "annual sums"), got, want),
        quiet=True))
    # the member kernels launch as many members at a time as the card
    # holds all clusters of (one on an H100, which runs 7 of 16
    # blocks): K4 at M=2 and M=1, K3 at M=2 twice and M=1
    per = {k: yk.check_resident(groups, capacity[k], 2)
           for k in ("fluxcorr", "scenario_years")}
    want_k4 = -(-2 // per["fluxcorr"]) + 1
    want_k3 = 2 * -(-2 // per["scenario_years"]) + 1
    read_counts("grid768 short checks", {
        "fluxcorr_year": 1, "scenario_year": 1,
        "fluxcorr_years": want_k4, "scenario_years": want_k3})
    del got, want, s5
    # log_exp 11: the wide form's legacy variant
    m11, _, _ = _grid768_model(short, log_exp=11)
    y11 = m11.year_data
    names += [_pick_check("grid768 log_exp 11", k, y11) for k in
              ("fluxcorr_year", "scenario_year", "fluxcorr_years",
               "scenario_years")]
    co2c = np.float32(m11.exp.co2_ctrl)
    s011 = m11.initial_state()
    k1l = yk.fluxcorr_year(s011, co2c, y11)
    k2l = yk.scenario_year(s011, zero, co2s, y11)
    _finite("grid768 log_exp 11 K2", [("state", k2l[0].stack()),
                                      ("outs", k2l[1])])
    err["fluxcorr_year"] = max(err["fluxcorr_year"], _k1_vs_plain(
        f"K1 grid768 log_exp 11, {n} steps", s011, co2c, y11, k1l))
    err["scenario_year"] = max(err["scenario_year"], _k2_vs_plain(
        f"K2 grid768 log_exp 11, {n} steps", s011, zero, co2s, y11,
        k2l))
    del m11, y11, k1l, k2l
    print(f"  {', '.join(sorted(set(names)))}")
    out["short_ms"] = dict(fluxcorr_year=ms1, scenario_year=ms2, **m_ms)
    out["plain_ms"] = dict(fluxcorr_year=p1, scenario_year=p2, **m_plain)
    print(f"  {n} steps: kernels K1 {ms1:.1f} ms, K2 {ms2:.1f} ms, K4 M=2 "
          f"{m_ms['fluxcorr_years']:.1f} ms, K3 M=2 x 2 years "
          f"{m_ms['scenario_years']:.1f} ms; plain (eager) K1 {p1:.1f} ms, "
          f"K2 {p2:.1f} ms, K4 {m_plain['fluxcorr_years']:.1f} ms, K3 "
          f"{m_plain['scenario_years']:.1f} ms; short checks "
          f"{time.perf_counter() - t_phase:.1f} s")

    # -- config 5's checkpoint and resume on the short calendar: run_long
    #    in K3 blocks from the initial state with zero tables (finite
    #    there), a checkpoint after each; the same run stopped at G768_STOP
    #    and resumed in a fresh process; the final state and the output
    #    file bitwise equal
    t0 = time.perf_counter()
    co2_long = np.full(G768_LONG, 680.0, np.float32)
    ck_full, run_full = _grid768_runner(m, tmp, "full")
    reset_counts()
    s_full, _, _ = longrun.run_long(G768_LONG, s0, zero, co2_long,
                                    run_full, checkpointer=ck_full,
                                    chunk_years=G768_BLOCK)
    run_full.close()
    long_blocks = G768_LONG // G768_BLOCK
    out["launches_long"] = read_counts("grid768 long run", {
        "fluxcorr_year": 0, "scenario_year": 0, "fluxcorr_years": 0,
        "scenario_years": long_blocks})
    _finite("grid768 long run", [(f"state {k}", getattr(s_full, k))
                                 for k in ModelState.FIELDS])
    ck_res, run_res = _grid768_runner(m, tmp, "resumed")
    longrun.run_long(G768_STOP, s0, zero, co2_long, run_res,
                     checkpointer=ck_res, chunk_years=G768_BLOCK)
    run_res.close()
    torch.cuda.synchronize()
    # the fresh process runs while this one makes the 10-step model and
    # holds its K1 and K2 against their plain versions (no timing there)
    t1 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--resume-long768", tmp],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

    def resumed():
        try:
            o, e = proc.communicate(timeout=600)
        finally:
            if proc.poll() is None:
                proc.kill()
        wall_resume = time.perf_counter() - t1
        if proc.returncode != 0:
            print(o[-4000:], e[-4000:], file=sys.stderr)
            raise AssertionError(f"768x384 resume exited {proc.returncode}")
        child = json.loads(o.strip().splitlines()[-1])
        if child["start"] != G768_STOP:
            raise AssertionError(f"768x384 resumed at {child['start']}")
        s_res, _, cursor = type(ck_res)(ck_res.dir).restore(device="cuda")
        if cursor.year_index != G768_LONG:
            raise AssertionError(f"768x384 last checkpoint "
                                 f"{cursor.year_index}")
        _bitwise("grid768 resumed vs uninterrupted", [
            (f"state {k}", getattr(s_res, k), getattr(s_full, k))
            for k in ModelState.FIELDS], quiet=True)
        with open(os.path.join(tmp, "long768_full"), "rb") as f, \
                open(os.path.join(tmp, "long768_resumed"), "rb") as g:
            full_bytes = f.read()
            if full_bytes != g.read():
                raise AssertionError("768x384 resumed output file differs")
        print(f"grid768 long run ({G768_LONG} years in K3 blocks of "
              f"{G768_BLOCK}, checkpoints every {G768_BLOCK}, {n}-step "
              f"calendar): stopped at {G768_STOP}, resumed in a fresh process"
              f" ({wall_resume:.1f} s wall, beside the 10-step checks: set-up "
              f"{child['setup_s']:.1f} s, years {child['start']}..{G768_LONG} "
              f"{child['run_s']:.3f} s, {child['scenario_years_launches']} K3 "
              f"launches); final state and output file ({len(full_bytes)} B) "
              f"bitwise equal; {time.perf_counter() - t0:.1f} s")

    try:
        # step 19 shards this short-calendar model and its fold
        out["short_model"] = m
        del m, yd, k1, k2, s0, zero

        # -- the CLI's --ensemble G768_ENS_M on G768_ENS's calendar: a
        #    spin-up each (K4), then K3, as many members a launch as the
        #    card holds
        M, enum = G768_ENS_M, Numerics(**G768_GRID, **G768_ENS)
        me, _, _ = _grid768_model(enum)
        # -- first, on this calendar (where a scenario year after a spin-up
        #    stays finite): K1 from the initial state, then K2 from K1's end
        #    with K1's tables, each bitwise and finite against its plain
        #    version (eager)
        ye, ne = me.year_data, enum.nstep_yr
        s0e = me.initial_state()
        k1e = yk.fluxcorr_year(s0e, co2f, ye)
        k2e = yk.scenario_year(k1e[0], k1e[1], co2s, ye)
        _finite("grid768 K1 (10 steps)", [("state", k1e[0].stack()),
                                          ("tf", k1e[1].tf)])
        _finite("grid768 K2 after K1 (10 steps)",
                [("state", k2e[0].stack()), ("outs", k2e[1])])
        err["fluxcorr_year"] = max(err["fluxcorr_year"], _k1_vs_plain(
            f"K1 grid768, {ne} steps", s0e, co2f, ye, k1e))
        err["scenario_year"] = max(err["scenario_year"], _k2_vs_plain(
            f"K2 grid768 from K1's end with K1's tables, {ne} steps",
            k1e[0], k1e[1], co2s, ye, k2e))
        del s0e, k1e, k2e
        resumed()
    finally:
        if proc.poll() is None:   # a check above failed
            proc.kill()
    del s_full
    gc.collect()
    torch.cuda.empty_cache()
    path = os.path.join(tmp, "ensemble768", "member")
    os.makedirs(os.path.dirname(path))
    args = cli.build_parser().parse_args(["--ensemble", str(M), "--quiet"])
    reset_counts()
    _, wall = _synced_s(lambda: cli.run_ensemble(me, path, args))
    chunks = {k: -(-M // yk.check_resident(groups, capacity[k], M))
              for k in ("fluxcorr", "scenario_years")}
    out["launches_ensemble"] = read_counts(
        f"grid768 ensemble path (M={M})", {
            "fluxcorr_year": 0, "scenario_year": 0,
            "fluxcorr_years": enum.time_flux * chunks["fluxcorr"],
            "scenario_years": -(-enum.time_scnr // cli.ensemble_block_years(
                M, enum)) * chunks["scenario_years"]})
    nbytes = _read_members(path, M, enum)
    print(f"grid768 ensemble path (--ensemble {M}, {enum.nstep_yr}-step "
          f"calendar, {enum.time_flux} + {enum.time_scnr} years): "
          f"{wall:.3f} s; {M} files, {nbytes} B, read back finite, the "
          f"members differ")
    del me
    gc.collect()
    torch.cuda.empty_cache()

    # -- the strict circulation on a CUDA mesh refuses before any launch
    #    (item 3j: a shard's strict block does not fit; step 23 runs it
    #    unsharded)
    from greb_tpu_torch.config import Experiment
    from greb_tpu_torch.parallel import sharded as sh
    reset_counts()
    try:
        sh.make_sharded_year_runners(
            sh.Mesh([[torch.device("cuda", 0)] * 4]),
            out["short_model"].md.st, short,
            Experiment(), torch.zeros(1, 2))
    except NotImplementedError as e:
        if "Queue 1 item 3j" not in str(e):
            raise
        print(f"grid768 strict circulation on a CUDA mesh refused: "
              f"...{str(e)[-60:]}")
    else:
        raise AssertionError("768x384 strict circulation on a CUDA mesh was "
                             "not refused")
    read_counts("grid768 strict refusal", dict.fromkeys(
        ("fluxcorr_year", "scenario_year", "fluxcorr_years",
         "scenario_years"), 0))

    # -- the path: GREB.run at 768x384 on G768_PATH's 40-step calendar
    #    (its forcing and fold made during the build), its peak device
    #    memory, its own K1 and K2 launches timed (CUDA events); the
    #    warming: the scenario year's end state against the spin-up's,
    #    area-weighted.  K3 and K4 are timed on the short calendar above
    #    (M=2), where each member's launch is held to plain and K4 = K1,
    #    K3 = K2 at M=1.
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    model, state, corr, monthly, launches, rate, timing = _refined_path(
        "grid768", tmp, G768_GRID, G768_PATH, reset_counts, read_counts)
    folds.stop()
    out["peak"] = torch.cuda.max_memory_allocated()
    out["launches_path"], out["path_rate"] = launches, rate
    out["setup_s"] = (timing["regrid_s"], timing["build_s"])
    num = model.num
    plan = model.fold[0]
    co2p = float(model.cfg.co2.series(num.time_scnr)[0])
    s_fc = timing["spin_state"]
    lat = torch.cos(torch.deg2rad(torch.linspace(-90 + 90 / num.ydim,
                                                 90 - 90 / num.ydim,
                                                 num.ydim, device="cuda")))
    gm = lambda ts: float((ts.mean(1) * lat).sum() / lat.sum())
    warm = gm(state.ts) - gm(s_fc.ts)
    print(f"  warming under {co2p:.0f} ppm: the scenario year's end state "
          f"{gm(state.ts):.4f} K against the spin-up's {gm(s_fc.ts):.4f} K "
          f"(+{warm:.4f} K, area-weighted)")
    if not warm > 0:
        raise AssertionError(f"grid768 path: no warming ({warm} K)")
    out["ms"] = {"fluxcorr_year": timing["fluxcorr_year"][0],
                 "scenario_year": timing["scenario_year"][0],
                 "fluxcorr_years": m_ms["fluxcorr_years"],
                 "scenario_years": m_ms["scenario_years"]}
    out["shape"] = {"fluxcorr_year": f"1 year, {num.nstep_yr} steps",
                    "scenario_year": f"1 year, {num.nstep_yr} steps",
                    "fluxcorr_years": f"M=2 x 1 year, {n} steps",
                    "scenario_years": f"M=2 x 2 years, {n} steps"}
    _, ranks_p = yk.packed_ranks(model.fold[1])
    out["work"] = {
        "fluxcorr_year": yk.year_work(plan, num, False, ranks_p),
        "scenario_year": yk.year_work(plan, num, True, ranks_p),
        "fluxcorr_years": my.years_work(plan, short, 1, 2, "fluxcorr",
                                        ranks=ranks),
        "scenario_years": my.years_work(plan, short, 2, 2, "scenario",
                                        ranks=ranks)}
    for name, ms in out["ms"].items():
        b_ms, b_by = _bound_of(*out["work"][name])
        # substeps of the launch: a year's, or each member-year's
        subs = {"fluxcorr_years": 2 * n, "scenario_years": 4 * n}.get(
            name, num.nstep_yr) * num.nsub_crcl
        print(f"grid768 {name} ({out['shape'][name]}): {ms:.3f} ms = "
              f"{ms * 1e3 / subs:.3f} us a substep (a step's work "
              f"included); bound {b_ms:.3f} ms by {b_by}, {ms / b_ms:.1f}x")
    print(f"  peak device memory of the path {out['peak']} B ({held} B held "
          f"before it, so {out['peak'] - held} B its own)")
    out["err"], out["capacity"], out["groups"] = err, capacity, groups
    del model, state, corr, monthly, s_fc, timing
    gc.collect()
    torch.cuda.empty_cache()
    print(f"grid768 phase: {time.perf_counter() - t_phase:.1f} s")
    return out


# step 19: latitude x member sharding in the slab kernels
# (csrc/slab_kernel.cu, ops/cuda/slab.py; parallel/sharded.py)
SHARD_NY = (2, 4)          # 96x48 on n_y shards of the one card
SHARD_PATH_NY = 4          # the sharded path whose launches are counted
SHARD_SHORT = dict(ndays_yr=10, jday_mon=(6, 4), time_flux=1, time_scnr=1)
# the plain sharded version's calendars (eager, each shard's step in a
# thread: host-bound), from the initial state (the scenario with zero
# tables): 96x48 on 10 steps, the refined grids on 4
SHARD_PLAIN_96 = dict(ndays_yr=5, jday_mon=(3, 2), time_flux=1, time_scnr=1)
SHARD_PLAIN_REFINED = dict(ndays_yr=2, jday_mon=(2,), time_flux=1,
                           time_scnr=1)
SHARD_REFINED_NY = 4       # 384x192 and 192x96 on 20 steps, 768x384 on 2
SHARD_CT_SENS = (22.05, 22.95)
SHARD_PROCS = 2            # processes sharing the card over gloo
SLAB_ENTRIES = ("slab_start", "slab_substep", "slab_finish")


def _slab_launches():
    from greb_tpu_torch.ops.cuda import slab
    return dict(zip(SLAB_ENTRIES, (slab.start.launches,
                                   slab.substep.launches,
                                   slab.finish.launches)))


def _slab_entry_launches():
    """The slab launches by kernel entry (slab.SlabShard.entry) since the last
    reset."""
    from greb_tpu_torch.ops.cuda import slab
    return {e: n for fn in (slab.start, slab.substep, slab.finish)
            for e, n in fn.entries.items()}


def _sharded_run(model, n_y, plain=False, members=None, n_ens=1,
                 from0=False, mesh=None, graphs=True, repeat=1,
                 scenario=True):
    """``model``'s spin-up year, then a scenario year from its end with its
    tables (``from0``: both from the initial state, the scenario with zero
    tables), sharded over an (n_ens, n_y) mesh of the card (or ``mesh``) in
    the slab kernels, or in the plain sharded runners (``plain``), the two
    years ``repeat`` times on the same runners (the first captures their
    graphs): ((state after each, tables, monthly means, annual means)
    gathered to the host, seconds of the last two years (host clock, the
    card synchronized at both ends), the slab launches of the last); not
    ``scenario``: the spin-up year alone (None for the scenario's)."""
    import numpy as np
    import torch
    from greb_tpu_torch.ops import fastcirc2 as fc2
    from greb_tpu_torch.ops.cuda import multiyear as my
    from greb_tpu_torch.parallel import ensemble as ens
    from greb_tpu_torch.parallel import sharded as sh
    mesh = mesh if mesh is not None else sh.make_mesh(n_ens, n_y)
    splan = fcc = None
    if model.fold is not None:
        splan, sconst = fc2.build_sharded(None, None, model.grid, model.st,
                                          0, mesh.n_y, fold=model.fold)
        fcc = sh.shard_fastcirc(mesh, sconst)
    make = sh.make_plain_year_runners if plain else \
        sh.make_sharded_year_runners
    batched = members is not None
    flux, scnr = make(mesh, model.st, model.num, model.exp, model.month_mat,
                      batched=batched, fast_plan=splan)
    if not (plain or graphs):
        flux.runner.graphs = False     # every launch eager, to be timed
    state, ppack = model.initial_state(), None
    if batched:
        state = ens.ensemble_initial_state(members, model.forcing)
        ppack = my.pack_member_params(members, "cuda")
    st_s, sfx_s, c0_s, md_s = sh.shard_inputs(mesh, batched, state,
                                              model.sfx, None, model.md,
                                              ppack)
    co2 = np.float32(680.0)
    from greb_tpu_torch.ops.cuda import slab
    for _ in range(repeat):
        # the slab counts from 0 just before the path, read just after
        slab.reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s1, c1 = flux(st_s, sfx_s, co2, md_s, fcc)
        if scenario:
            s2, mon, mean = scnr(st_s if from0 else s1, sfx_s,
                                 c0_s if from0 else c1, co2, md_s, fcc)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        n = _slab_launches()
    if not scenario:
        return (s1.gather(), c1.gather(), None, None, None), secs, n
    return ((s1.gather(), c1.gather(), s2.gather(), mon.gather(),
             mean.gather()), secs, n)


def _unsharded_run(model, n_y, from0=False):
    """K1, then K2 (from0 as ``_sharded_run``), unsharded: (state after
    each, tables, monthly means, annual means) on the host, the monthly
    means taken as a run on n_y shards takes them, one product a shard's
    rows (cuBLAS picks a product's reduction order by its shape)."""
    import numpy as np
    import torch
    from greb_tpu_torch.forcing import Corrections
    from greb_tpu_torch.model import core
    from greb_tpu_torch.ops.cuda import year_kernel as yk
    yd, num, co2 = model.year_data, model.num, np.float32(680.0)
    s0 = model.initial_state()
    s1, c1 = yk.fluxcorr_year(s0, co2, yd)
    if from0:
        zero = Corrections.zeros(num.nstep_yr, num.ydim, num.xdim,
                                 device="cuda")
        s2, outs, asum = yk.scenario_year(s0, zero, co2, yd)
    else:
        s2, outs, asum = yk.scenario_year(s1, c1, co2, yd)
    R = num.ydim // n_y
    mon = torch.cat([core.monthly_means(model.month_mat,
                                        outs[..., i * R:(i + 1) * R, :])
                     for i in range(n_y)], dim=-2)
    cpu = lambda v: type(v)(*[getattr(v, f.name).cpu()
                             for f in dataclasses.fields(v)])
    return (cpu(s1), cpu(c1), cpu(s2), mon.cpu(),
            core.StepOutputs(*[a.cpu() for a in core.annual_means(asum,
                                                                  num)]))


def _years_pairs(got, want, mon=True):
    """(name, got, want) of every field of two ``_sharded_run`` results."""
    from greb_tpu_torch.forcing import ModelState
    pairs = []
    for tag, a, b in (("spin-up", got[0], want[0]),
                      ("scenario", got[2], want[2])):
        if a is not None and b is not None:
            pairs += [(f"{tag} {n}", getattr(a, n), getattr(b, n))
                      for n in ModelState.FIELDS]
    pairs += [(f"table {n}", getattr(got[1], n), getattr(want[1], n))
              for n in ("tf", "tof", "qf")]
    if got[4] is not None and want[4] is not None:
        pairs += [(f"annual mean {i}", a, b)
                  for i, (a, b) in enumerate(zip(got[4], want[4]))]
        if mon:
            pairs.append(("monthly means", got[3], want[3]))
    return pairs


def _slab_ms(model, n_y, reps=50):
    """ms of one launch of each slab wrapper on each shard of ``model`` on
    n_y shards of the card: ``reps`` launches of the entry on the shard
    captured in a CUDA graph, the graph replayed once, then timed by CUDA
    events around a replay (the card's time, not the host's launches):
    {entry (the kernel the wrapper launches there, SlabShard.entry): {shard:
    ms}}.  On a runner of its own, after a spin-up year: the timing
    launches change its state, and count no launch of a path (a capture
    launches nothing, the replays are not counted)."""
    import numpy as np
    import torch
    from greb_tpu_torch.ops import fastcirc2 as fc2
    from greb_tpu_torch.ops.cuda import slab
    from greb_tpu_torch.parallel import sharded as sh
    mesh = sh.make_mesh(1, n_y)
    splan = fcc = None
    if model.fold is not None:
        splan, sconst = fc2.build_sharded(None, None, model.grid, model.st,
                                          0, n_y, fold=model.fold)
        fcc = sh.shard_fastcirc(mesh, sconst)
    flux, _ = sh.make_sharded_year_runners(mesh, model.st, model.num,
                                           model.exp, model.month_mat,
                                           fast_plan=splan)
    st_s, sfx_s, _, md_s = sh.shard_inputs(mesh, False, model.initial_state(),
                                           model.sfx, None, model.md)
    flux(st_s, sfx_s, np.float32(680.0), md_s, fcc)
    runner = flux.runner
    for step, _ in runner._counters.values():
        step.zero_()      # the launches read step 0's forcing
    launch = {"slab_start": lambda s: slab.start(s, False),
              "slab_substep": lambda s: slab.substep(s, 0, False),
              "slab_finish": lambda s: slab.finish(s, "fluxcorr", 0, False)}
    out = {}
    for wrapper, fn in launch.items():
        for k in sorted(runner.shards):
            shard = runner.shards[k]
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g, capture_error_mode="relaxed"):
                for _ in range(reps):
                    fn(shard)
            g.replay()
            out.setdefault(shard.entry(wrapper.split("_")[1]), {})[k[1]] = \
                _time_ms(g.replay, 3)[0] / reps
            del g
    return out


def _slab_wrapper_ms(model, n_y, reps=50):
    """_slab_ms of the fold's entries by wrapper (SLAB_ENTRIES): {wrapper:
    [ms of shard 0, 1, ...]}."""
    return {e.split("<")[0]: [v[k] for k in sorted(v)]
            for e, v in _slab_ms(model, n_y, reps).items()}


def _slab_plain_ms(model, n_y, shard=1):
    """ms of the plain version of each slab entry on one shard of
    ``model`` on n_y shards (the card, eager, 20 calls after a warm-up):
    slab_start (Ta, q stacked and fastcirc2.step_coeffs of the shard's
    rows), slab_substep (fastcirc2.substep of its rows with 2 halo rows
    each side), slab_finish (core.fluxcorr_step with the circulation's
    increment zero: the pointwise physics and update alone)."""
    import numpy as np
    import torch
    from greb_tpu_torch.model import core
    from greb_tpu_torch.ops import fastcirc2 as fc2
    from greb_tpu_torch.parallel import sharded as sh
    splan, sconst = fc2.build_sharded(None, None, model.grid, model.st, 0,
                                      n_y, fold=model.fold)
    plan, const = splan.plans[shard], sconst.shards[shard]
    lo, hi = splan.rows(shard)
    fx = sh._cut_sfx(model.sfx, lo, hi, "cuda").at(0)
    md = sh._cut_md(model.md, lo, hi, "cuda")
    s0 = model.initial_state()
    state = type(s0)(*[getattr(s0, f.name)[lo:hi].contiguous()
                       for f in dataclasses.fields(s0)])
    halo = torch.zeros((2, 2, model.num.xdim), device="cuda")
    ext = lambda x, w: torch.cat([halo, x, halo], dim=-2)
    x = torch.stack([state.ta, state.q], dim=-3)
    cf = fc2.step_coeffs(fx.u, fx.v, const, plan)
    fns = {"slab_start": lambda: (torch.stack([state.ta, state.q], dim=-3),
                                  fc2.step_coeffs(fx.u, fx.v, const, plan)),
           "slab_substep": lambda: fc2.substep(x, cf, const, plan, ext),
           "slab_finish": lambda: core.fluxcorr_step(
               state, fx, np.float32(680.0), md, model.num, (plan, const))}
    out = {}
    circ = fc2.circulation
    try:
        fc2.circulation = lambda x, *a, **k: torch.zeros_like(x)
        for name, fn in fns.items():
            fn()
            out[name] = _time_ms(fn, 20)[0]
    finally:
        fc2.circulation = circ
    return out, splan


def _shard_worker(argv) -> int:
    """One of SHARD_PROCS processes sharing the card over gloo: its shards
    of a 96x48 mesh of SHARD_PATH_NY shards in the slab kernels (the
    exchange across the processes through pinned host memory), first under
    the fold on SHARD_SHORT's calendar (step 19), then under the strict
    transport, the library default, on SHARD_PLAIN_96's from the initial
    state (the scenario with zero tables; step 21); rank 0
    saves the gathered years to ``argv[2]`` and ``argv[2]`` + ".strict".
    ``python3 chip_smoke.py --shard-worker RANK PORT PATH``."""
    import torch
    from greb_tpu_torch.config import GrebConfig, Numerics
    from greb_tpu_torch.model.driver import GREB
    from greb_tpu_torch.parallel import multihost as mh
    rank, port, path = int(argv[0]), int(argv[1]), argv[2]
    mh.initialize(f"localhost:{port}", SHARD_PROCS, rank, backend="gloo")
    try:
        mesh = mh.global_mesh(1, SHARD_PATH_NY, local_devices=["cuda"])
        runs = {}
        for tag, cal, fast in (("fold", SHARD_SHORT, True),
                               ("strict", SHARD_PLAIN_96, False)):
            model = GREB(GrebConfig(numerics=Numerics(**cal),
                                    fast_circulation=fast), device="cuda",
                         verbose=False)
            res, secs, n = _sharded_run(model, SHARD_PATH_NY, mesh=mesh,
                                        from0=tag == "strict")
            if rank == 0:
                torch.save(res, path + (".strict" if tag == "strict" else ""))
            runs[tag] = {"s": secs, "launches": n}
        print(json.dumps({"rank": rank, "shards": mesh.local(), **runs}))
    finally:
        mh.shutdown()
    return 0


def _shard_workers(tmp):
    """SHARD_PROCS processes of _shard_worker sharing the card: (the path
    rank 0 saved the years to, each process's JSON line, wall seconds)."""
    import socket
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    path = os.path.join(tmp, "shard_worker.pt")
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--shard-worker",
         str(r), str(port), path], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, cwd=ROOT)
        for r in range(SHARD_PROCS)]
    try:
        res = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, (o, e) in zip(procs, res):
        if p.returncode != 0:
            print(o[-4000:], e[-4000:], file=sys.stderr)
            raise AssertionError(f"shard worker exited {p.returncode}")
    child = [json.loads(o.strip().splitlines()[-1]) for o, _ in res]
    return path, child, time.perf_counter() - t0


def _sharded_phase(tmp, model, m768):
    """Step 19: the slab kernels against the unsharded kernels and the
    plain sharded version, at 96x48 (the full calendar on 2 and 4 shards of
    the card, the sharded path's years timed and its launches counted; 2
    members x 2 shards against K4 -> K3; two processes against one), 384x192
    and 192x96 on 20 steps, 768x384 (step 18's short model and fold) on
    2 steps; each entry's launch timed and its plain version's."""
    import numpy as np
    import torch
    from greb_tpu_torch.config import GrebConfig, Numerics
    from greb_tpu_torch.model import core
    from greb_tpu_torch.model.driver import GREB
    from greb_tpu_torch.ops import fastcirc2 as fc2
    from greb_tpu_torch.ops.cuda import multiyear as my
    from greb_tpu_torch.ops.cuda import slab
    from greb_tpu_torch.ops.cuda import year_kernel as yk
    from greb_tpu_torch.parallel import ensemble as ens

    out = dict(err=0.0)
    num = model.num
    T, nsub = num.nstep_yr, num.nsub_crcl
    ticks = [time.perf_counter()]

    def tick(what):
        ticks.append(time.perf_counter())
        print(f"  [{what}: {ticks[-1] - ticks[-2]:.1f} s]")

    def against_plain(tag, m, n_y, **kw):
        """The slab kernels against the plain sharded version (eager,
        each shard's step in a thread) on ``m``."""
        got, _, _ = _sharded_run(m, n_y, **kw)
        t0 = time.perf_counter()
        plain, _, n = _sharded_run(m, n_y, plain=True, **kw)
        if any(n.values()):
            raise AssertionError(f"the plain sharded version launched {n}")
        check(f"{tag} {n_y} shards vs its plain sharded version "
              f"({m.num.nstep_yr} steps)", _years_pairs(got, plain))
        return time.perf_counter() - t0

    def check(tag, pairs):
        out["err"] = max(out["err"], _bitwise(tag, pairs, quiet=True))

    # -- 96x48, full calendar: the slab kernels on n_y shards against K1
    #    -> K2; the sharded path (SHARD_PATH_NY shards) timed after a run
    #    that captures its graphs, its launches counted
    for n_y in SHARD_NY:
        want = _unsharded_run(model, n_y)
        got, secs, n = _sharded_run(model, n_y, repeat=2)
        check(f"96x48 {n_y} shards vs K1 -> K2 (full calendar)",
              _years_pairs(got, want))
        _finite("96x48 sharded", [("scenario ts", got[2].ts), ("monthly means", got[3])])
        if n != dict(slab_start=2 * T * n_y, slab_substep=2 * T * n_y * nsub,
                     slab_finish=2 * T * n_y):
            raise AssertionError(f"96x48 {n_y} shards: launches {n}")
        secs2 = secs
        print(f"sharded 96x48 on {n_y} shards of the card (1 + 1 years, "
              f"a step replayed from one CUDA graph, the second run on the "
              f"same runners): {secs2:.3f} s = {2 / secs2:.3f} sim-yr/s; "
              f"launches {n}")
        if n_y == SHARD_PATH_NY:
            out["rate"], out["launches"] = 2 / secs2, n
    tick("96x48 full calendar")
    # -- each entry's launch timed (eager) at the path's shape, on a
    #    20-step calendar; the plain sharded version there (eager, each
    #    shard's step in a thread of its own); members x shards against K4
    #    -> K3
    short = GREB(GrebConfig(numerics=Numerics(**SHARD_SHORT),
                            fast_circulation=True), device="cuda",
                 verbose=False)
    got4, _, _ = _sharded_run(short, SHARD_PATH_NY)
    got, secs_eager, _ = _sharded_run(short, SHARD_PATH_NY, graphs=False)
    check("96x48 eager vs graphed (20 steps)", _years_pairs(got, got4))
    ms = _slab_wrapper_ms(short, SHARD_PATH_NY)
    out["ms"] = {e: _median(v) for e, v in ms.items()}
    print(f"sharded 96x48 on {SHARD_PATH_NY} shards eager: {secs_eager:.3f} s"
          f" for 1 + 1 years of 20 steps; a launch (graphed, median of the "
          f"shards): " + ", ".join(f"{e} {v * 1e3:.2f} us"
                                   for e, v in out["ms"].items())
          + f"; each shard's: {ms}")
    out["plain_ms"], splan = _slab_plain_ms(model, SHARD_PATH_NY)
    out["work"] = {e: slab.slab_work(splan.plans[1], num, e)
                   for e in SLAB_ENTRIES}
    out["copies_a_year"] = 2 * T * (nsub + 1) * 2 * (SHARD_PATH_NY - 1)
    tick("launches timed")
    m10 = GREB(GrebConfig(numerics=Numerics(**SHARD_PLAIN_96),
                          fast_circulation=True), device="cuda",
               verbose=False)
    secs_plain = against_plain("96x48", m10, SHARD_PATH_NY, from0=True)
    print(f"  the plain sharded version (eager): {secs_plain:.1f} s for 1 + 1"
          f" years of {m10.num.nstep_yr} steps")
    tick("plain sharded 96x48")
    members = ens.perturbed_params(short.params,
                                   {"ct_sens": np.float32(SHARD_CT_SENS)})
    gotm, _, _ = _sharded_run(short, 2, members=members, n_ens=2)
    s5 = ens.ensemble_initial_state(members, short.forcing)
    pp = my.pack_member_params(members, "cuda")
    k4, corr = my.fluxcorr_years(s5, pp, 680.0, short.year_data)
    k3, _, asum = my.scenario_years(k4, pp, corr, np.float32([680.0]),
                                    short.year_data)
    check("2 members x 2 shards vs K4 -> K3 (M=2)",
          [("spin-up", gotm[0].stack(), k4.cpu()),
           ("scenario", gotm[2].stack(), k3.cpu())]
          + [(f"table {n}", getattr(gotm[1], n), corr[:, :, i].cpu())
             for i, n in enumerate(("tf", "tof", "qf"))]
          + [(f"annual mean {i}", a, b.cpu()) for i, (a, b) in enumerate(zip(
              gotm[4], core.annual_means(asum[:, 0].transpose(0, 1),
                                         short.num)))])

    # -- two processes on the card over gloo against one process (the
    #    workers run step 21's strict transport after the fold: one
    #    process start for both)
    path, child, wall = _shard_workers(tmp)
    check(f"{SHARD_PROCS} processes x {SHARD_PATH_NY // SHARD_PROCS} shards "
          f"(gloo, one card) vs one process x {SHARD_PATH_NY}",
          _years_pairs(torch.load(path, weights_only=False), got4))
    out["workers"] = (path + ".strict", child)
    years_s = ", ".join("%.2f" % c["fold"]["s"] for c in child)
    print(f"  {SHARD_PROCS} processes: {wall:.1f} s wall, the strict "
          f"transport's runs for step 21 included (the fold's years "
          f"{years_s} s; launches {[c['fold']['launches'] for c in child]})")
    tick("members, two processes")

    # -- 384x192 and 192x96: against K1 -> K2 on 20 steps, against the
    #    plain sharded version on 4 (the two models share their fold)
    for grid in (REFINED_GRID, G192_GRID):
        with _SharedFolds():
            mg, _ = _refined_model(Numerics(**grid, **SHARD_SHORT))
            mg4, _ = _refined_model(Numerics(**grid, **SHARD_PLAIN_REFINED))
        tag = f"{mg.num.xdim}x{mg.num.ydim}"
        tick(f"{tag} models")
        want = _unsharded_run(mg, SHARD_REFINED_NY)
        got, _, _ = _sharded_run(mg, SHARD_REFINED_NY)
        check(f"{tag} {SHARD_REFINED_NY} shards vs K1 -> K2 (20 steps)",
              _years_pairs(got, want))
        _finite(f"{tag} sharded", [("scenario ts", got[2].ts),
                                   ("monthly means", got[3])])
        against_plain(tag, mg4, SHARD_REFINED_NY, from0=True)
        del mg, mg4
        tick(tag)

    # -- 768x384 on step 18's 2-step model: against the wide form and the
    #    plain sharded version, from the initial state (the scenario with
    #    zero tables); each entry's launch on each shard timed (a graph of
    #    its launches), a step timed from the runner's graph
    n7 = SHARD_REFINED_NY
    want = _unsharded_run(m768, n7, from0=True)
    got, _, _ = _sharded_run(m768, n7, from0=True, graphs=False)
    check(f"768x384 {n7} shards vs the wide form (2 steps, eager)",
          _years_pairs(got, want))
    ms7 = _slab_wrapper_ms(m768, n7, reps=10)
    got, secs7, _ = _sharded_run(m768, n7, from0=True, repeat=2)
    check(f"768x384 {n7} shards graphed vs the wide form",
          _years_pairs(got, want))
    t0 = time.perf_counter()
    plain, _, _ = _sharded_run(m768, n7, from0=True, plain=True,
                               scenario=False)
    check(f"768x384 {n7} shards vs its plain sharded version (the spin-up, "
          f"2 steps, eager)", _years_pairs(got, plain))
    _finite("768x384 sharded", [("scenario ts", got[2].ts), ("monthly means", got[3])])
    n_step = 2 * m768.num.nstep_yr
    sub = ms7["slab_substep"]
    out["grid768"] = dict(
        ms={e: max(v) for e, v in ms7.items()},
        us_substep=sum(sub) * 1e3,
        ms_step=secs7 * 1e3 / n_step,
        plain_s=time.perf_counter() - t0)
    splan7, sconst7 = fc2.build_sharded(None, None, m768.grid, m768.st, 0,
                                        n7, fold=m768.fold)
    ranks = yk.packed_ranks(sconst7.shards[0])[1]
    out["grid768"]["work"] = {
        e: slab.slab_work(splan7.plans[0], m768.num, e, ranks=ranks)
        for e in SLAB_ENTRIES}
    g = out["grid768"]
    tick("768x384")
    print(f"768x384 on {n7} shards of the card: a step {g['ms_step']:.3f} ms "
          f"(graphed, 1 + 1 years of {m768.num.nstep_yr} steps), a substep "
          f"{g['us_substep']:.1f} us (the {n7} shards' substep launches, "
          f"graphed), a launch (the slowest shard's): "
          + ", ".join(f"{e} {v:.3f} ms" for e, v in g["ms"].items())
          + f"; each shard's: {ms7}; the plain sharded version "
          f"{g['plain_s']:.1f} s")
    return out


def _ensemble_run(tmp, tag, argv, num):
    """The CLI's run_ensemble on the card as ``python -m greb_tpu_torch``
    runs it (the flags ``argv`` through its own parser), on the synthetic
    forcing at ``num``'s grid and years; returns (members' file prefix,
    wall s, the model)."""
    import torch
    from greb_tpu_torch import __main__ as cli
    from greb_tpu_torch.config import GrebConfig
    from greb_tpu_torch.model.driver import GREB
    args = cli.build_parser().parse_args(argv + ["--quiet"])
    model = GREB(GrebConfig(numerics=num, fast_circulation=True),
                 device="cuda", verbose=False)
    out = os.path.join(tmp, tag, "member")
    os.makedirs(os.path.dirname(out))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cli.run_ensemble(model, out, args)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, model


def _sweep_members(model, M):
    """The params of run_ensemble's M members under the default
    --perturb, ct_sens=22.05:22.95."""
    import numpy as np
    from greb_tpu_torch.parallel import ensemble as ens
    return ens.perturbed_params(model.params, {
        "ct_sens": np.linspace(22.05, 22.95, M).astype(np.float32)})


def _synced_s(fn):
    """fn() and its seconds, the card synchronised at each end."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _read_members(out, M, num):
    """Each member's output file read back: the right shape, finite; the
    first and last members must differ.  Returns the byte count."""
    import numpy as np
    from greb_tpu_torch.io.binio import read_output
    shape = (num.time_scnr * len(num.jday_mon), 5, num.ydim, num.xdim)
    first = nbytes = None
    for i in range(1, M + 1):
        back = read_output(f"{out}_{i:03d}", num.xdim, num.ydim)
        if back.shape != shape or not np.isfinite(back).all():
            raise AssertionError(f"member {i}: output {back.shape}, want "
                                 f"{shape}, finite")
        if i == 1:
            first, nbytes = back, back.nbytes
        elif i == M and np.array_equal(back, first):
            raise AssertionError(f"members 1 and {M} do not differ")
    return nbytes * M


def _ensemble_phase(tmp, long_path, reset_counts, read_counts):
    """Step 15: K3's shared correction table, and the ensemble path (the
    CLI's --ensemble with and without --shared-spinup).  Returns the worst
    max |diff| of K3, the K3 year at M=ENS_M timed with a table per member
    and with the shared table, the work of each, and the launches of the
    two ensemble runs."""
    import gc

    import numpy as np
    import torch
    from greb_tpu_torch import __main__ as cli
    from greb_tpu_torch.config import GrebConfig, Numerics
    from greb_tpu_torch.io.binio import read_output
    from greb_tpu_torch.model.driver import GREB
    from greb_tpu_torch.ops.cuda import multiyear as my
    from greb_tpu_torch.ops.cuda import year_kernel as yk
    from greb_tpu_torch.parallel import ensemble as ens

    t_phase = time.perf_counter()
    short = Numerics(ndays_yr=10, jday_mon=(6, 4))
    co2y = np.asarray([560.0, 680.0], np.float32)

    # -- K3 with one table (1, T, 3, Y, X) for M=3 members, at every size
    #    it offers, against the same table copied M times and against the
    #    plain version; then under the strict circulation at C=16
    err = 0.0
    for fast, sizes in ((True, yk.offered_sizes("scenario_years")),
                        (False, (yk.DEFAULT_CLUSTER,))):
        m = GREB(GrebConfig(numerics=short, fast_circulation=fast),
                 device="cuda", verbose=False)
        yd = m.year_data
        pp = my.pack_member_params(ens.perturbed_params(
            m.params, {"ct_sens": np.linspace(22.05, 22.95, 3)}), "cuda")
        s0, corr = yk.fluxcorr_year(m.initial_state(),
                                    np.float32(m.cfg.co2.co2_flux), yd)
        s5 = s0.stack()[:, None].repeat(1, 3, 1, 1)
        shared = torch.stack([corr.tf, corr.tof, corr.qf], dim=1)[None]
        copies = shared.expand(3, -1, -1, -1, -1).contiguous()
        t1 = time.perf_counter()
        plain = my.scenario_years_plain(s5, pp, shared, co2y, yd)
        plain_s = time.perf_counter() - t1
        names = ("state", "monthly means", "annual sums")
        for c in sizes:
            got = my.scenario_years(s5, pp, shared, co2y, yd, cluster=c)
            want = my.scenario_years(s5, pp, copies, co2y, yd, cluster=c)
            if torch.equal(got[1][0], got[1][2]):
                raise AssertionError("K3 shared table: members do not differ")
            err = max(err, _bitwise(
                f"K3 shared table, {'modern' if fast else 'strict'} (M=3, "
                f"2 years, {short.nstep_yr} steps, C={c})",
                [(f"{n} vs copied", g, w) for n, g, w in zip(names, got, want)]
                + [(f"{n} vs plain", g, p) for n, g, p in zip(names, got,
                                                              plain)],
                quiet=True))
        print(f"  plain K3 with the shared table: {plain_s:.1f} s")
        del m, yd, s5, shared, copies, plain, got, want

    # -- the CLI's --ensemble: ENS_M members of the default sweep, a
    #    spin-up each, ENS_YEARS, at the default --mxu-precision (high: the
    #    matmul circulation's K4 and K3 at bf16_3x); then the same run at
    #    highest (the member kernels at highest, the exact fold's bits),
    #    whose middle member has the base ct_sens (22.5 exactly), so its
    #    file is the long run's first years
    num = Numerics(**ENS_YEARS)
    rates = {}
    if ENS_M >= cli.MXU_HIGHEST_PER_MEMBER_M:
        raise AssertionError(f"--ensemble {ENS_M} at highest would not run "
                             f"the member kernels")
    for flag in ("high", "highest"):
        prec = cli.MXU_PRECISION[flag]
        tag = f"matmul {prec}"
        reset_counts()
        out, wall, m = _ensemble_run(
            tmp, f"ensemble_{flag}",
            ["--ensemble", str(ENS_M), "--mxu-precision", flag], num)
        block = cli.ensemble_block_years(ENS_M, num)
        got = read_counts(f"ensemble path (M={ENS_M}, {tag})", {
            "fluxcorr_years_mxu": num.time_flux,
            "scenario_years_mxu": -(-num.time_scnr // block)})
        if flag == "high":
            launches = got
        # the spin-up alone: the run's time_flux K4 years again
        members = _sweep_members(m, ENS_M)
        pp = my.pack_member_params(members, "cuda")
        s5 = ens.ensemble_initial_state(members, m.forcing)
        co2 = np.float32(m.cfg.co2.co2_flux)
        mxu = m.members_mxu(prec)

        def spin_up(s5=s5):
            for _ in range(num.time_flux):
                s5, _ = my.fluxcorr_years(s5, pp, co2, m.year_data, mxu=mxu)

        _, spin = _synced_s(spin_up)
        years = num.time_flux + num.time_scnr
        rates[tag] = ENS_M * years / wall
        print(f"ensemble path (--ensemble {ENS_M}, {tag}, {num.time_flux} "
              f"spin-up + {num.time_scnr} scenario years): {wall:.3f} s = "
              f"{ENS_M * years / wall:.3f} member-yr/s; the spin-up alone "
              f"{spin:.3f} s, so the scenario with its files "
              f"{wall - spin:.3f} s = "
              f"{ENS_M * num.time_scnr / (wall - spin):.3f} member-yr/s")
        nbytes = _read_members(out, ENS_M, num)
        if flag == "highest":
            mid = (ENS_M + 1) // 2
            if np.linspace(22.05, 22.95, ENS_M).astype(np.float32)[mid - 1] \
                    != np.float32(22.5):
                raise AssertionError(f"member {mid}'s ct_sens is not the "
                                     f"base's")
            with open(f"{out}_{mid:03d}", "rb") as f, \
                    open(long_path, "rb") as g:
                mine = f.read()
                if mine != g.read(len(mine)):
                    raise AssertionError(f"member {mid}'s file is not the "
                                         f"long run's first {num.time_scnr} "
                                         f"years")
            print(f"  {ENS_M} files, {nbytes} B, read back finite; member "
                  f"{mid} (ct_sens 22.5) byte-equal to the long run's first "
                  f"{num.time_scnr * 12} months")
            shutil.rmtree(os.path.dirname(out))
        else:
            # members 1 and ENS_M's first scenario year against the plain
            # twin on the inputs K3 got: their K4 spin-ups again (two
            # members on one cluster: members do not interact)
            pick = [members[i - 1] for i in ENS_SHARED_PLAIN[:1] + (ENS_M,)]
            pp2 = my.pack_member_params(pick, "cuda")
            s2 = ens.ensemble_initial_state(pick, m.forcing)
            for _ in range(num.time_flux):
                s2, c2 = my.fluxcorr_years(s2, pp2, co2, m.year_data,
                                           mxu=mxu)
            (_, plain, _), plain_s = _synced_s(
                lambda: my.scenario_years_plain(
                    s2, pp2, c2, m.cfg.co2.series(num.time_scnr)[:1],
                    m.year_data, mxu))
            nmon = len(num.jday_mon)
            for k, i in enumerate((1, ENS_M)):
                back = read_output(f"{out}_{i:03d}", num.xdim,
                                   num.ydim)[:nmon]
                err = max(err, _bitwise(
                    f"ensemble member {i} of {ENS_M}, first year",
                    [("file vs plain twin", torch.from_numpy(back),
                      plain[k].cpu())]))
            print(f"  {ENS_M} files, {nbytes} B, read back finite; the "
                  f"plain twin's first year of members 1 and {ENS_M}: "
                  f"{plain_s:.1f} s")
        del m, members, pp, s5
    print(f"  --ensemble {ENS_M}: {rates['matmul bf16_3x']:.3f} member-yr/s "
          f"(matmul bf16_3x) against {rates['matmul highest']:.3f} (matmul "
          f"highest); the per-member kernels' K3 year is step 25's")

    # -- --shared-spinup: ENS_SHARED_M members read one K1 spin-up's
    #    tables; the peak device memory must stay below a per-member table
    #    set's size
    snum = Numerics(**ENS_SHARED_YEARS)
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    out, wall, m = _ensemble_run(
        tmp, "shared", ["--ensemble", str(ENS_SHARED_M), "--shared-spinup"],
        snum)
    peak = torch.cuda.max_memory_allocated()
    block = cli.ensemble_block_years(ENS_SHARED_M, snum)
    launches_shared = read_counts(
        f"shared spin-up ensemble path (M={ENS_SHARED_M})", {
            "fluxcorr_year": snum.time_flux,
            "scenario_years_mxu": -(-snum.time_scnr // block)})
    # the spin-up alone (the run's K1 years again), whose tables and end
    # state rebuild the inputs of the plain check below
    (state_fc, corr), spin = _synced_s(m.flux_correction)
    tables = ENS_SHARED_M * snum.nstep_yr * 3 * snum.ydim * snum.xdim * 4
    years = snum.time_flux + snum.time_scnr
    print(f"shared spin-up ensemble path (--ensemble {ENS_SHARED_M} "
          f"--shared-spinup, {snum.time_flux} + {snum.time_scnr} years): "
          f"{wall:.3f} s = {ENS_SHARED_M * years / wall:.3f} member-yr/s "
          f"(spin-up years counted a member each); the spin-up alone "
          f"{spin:.3f} s, so the scenario with its files {wall - spin:.3f} s "
          f"= {ENS_SHARED_M * snum.time_scnr / (wall - spin):.3f} "
          f"member-yr/s; peak device memory {peak} B ({base} B held "
          f"before), a per-member table set {tables} B")
    if peak >= tables:
        raise AssertionError(f"shared spin-up peak {peak} B >= {tables} B")
    nbytes = _read_members(out, ENS_SHARED_M, snum)
    print(f"  {ENS_SHARED_M} files, {nbytes} B, read back finite")
    # members ENS_SHARED_PLAIN's first scenario year from the plain twin
    # of the matmul circulation, on the inputs run_ensemble gave K3: the
    # shared tables, each member's initial state with the spun-up
    # cap_surf, its pack row
    pick = [_sweep_members(m, ENS_SHARED_M)[i - 1] for i in ENS_SHARED_PLAIN]
    s5 = ens.ensemble_initial_state(pick, m.forcing)
    s5[4] = state_fc.cap_surf
    (_, plain, _), plain_s = _synced_s(lambda: my.scenario_years_plain(
        s5, my.pack_member_params(pick, "cuda"),
        torch.stack([corr.tf, corr.tof, corr.qf], dim=1)[None],
        m.cfg.co2.series(snum.time_scnr)[:1], m.year_data,
        m.members_mxu("bf16_3x")))
    nmon = len(snum.jday_mon)
    for k, i in enumerate(ENS_SHARED_PLAIN):
        back = read_output(f"{out}_{i:03d}", snum.xdim, snum.ydim)[:nmon]
        err = max(err, _bitwise(
            f"shared spin-up member {i} of {ENS_SHARED_M}, first year",
            [("file vs plain twin", torch.from_numpy(back),
              plain[k].cpu())]))
    print(f"  plain twin's first year of members "
          f"{' and '.join(map(str, ENS_SHARED_PLAIN))}: {plain_s:.1f} s")
    del m, plain
    shutil.rmtree(os.path.dirname(out))
    # the same run at highest: from MXU_HIGHEST_PER_MEMBER_M members the
    # exact fold's per-member kernels (K3's one-block body, two waves at
    # 256); members ENS_SHARED_PLAIN's first scenario year from the plain
    # version on the same inputs (the same K1 tables and cap_surf)
    if ENS_SHARED_M < cli.MXU_HIGHEST_PER_MEMBER_M:
        raise AssertionError(f"--ensemble {ENS_SHARED_M} at highest would "
                             f"not run the per-member kernels")
    reset_counts()
    out_x, wall_x, m = _ensemble_run(
        tmp, "shared_highest", ["--ensemble", str(ENS_SHARED_M),
                                "--shared-spinup", "--mxu-precision",
                                "highest"], snum)
    read_counts(f"shared spin-up ensemble path (M={ENS_SHARED_M}, highest: "
                f"the per-member kernels)", {
                    "fluxcorr_year": snum.time_flux,
                    "scenario_years": -(-snum.time_scnr // block)})
    _read_members(out_x, ENS_SHARED_M, snum)
    (_, plain, _), plain_s = _synced_s(lambda: my.scenario_years_plain(
        s5, my.pack_member_params(pick, "cuda"),
        torch.stack([corr.tf, corr.tof, corr.qf], dim=1)[None],
        m.cfg.co2.series(snum.time_scnr)[:1], m.year_data))
    for k, i in enumerate(ENS_SHARED_PLAIN):
        back = read_output(f"{out_x}_{i:03d}", snum.xdim, snum.ydim)[:nmon]
        err = max(err, _bitwise(
            f"shared spin-up member {i} of {ENS_SHARED_M} (highest), first "
            f"year", [("file vs plain", torch.from_numpy(back),
                       plain[k].cpu())]))
    print(f"  plain first year of members "
          f"{' and '.join(map(str, ENS_SHARED_PLAIN))}: {plain_s:.1f} s")
    shutil.rmtree(os.path.dirname(out_x))
    rates["shared matmul bf16_3x"] = ENS_SHARED_M * years / wall
    rates["shared highest, per-member kernels"] = ENS_SHARED_M * years / wall_x
    print(f"  --ensemble {ENS_SHARED_M} --shared-spinup: {wall:.3f} s = "
          f"{rates['shared matmul bf16_3x']:.3f} member-yr/s (matmul "
          f"bf16_3x) against {wall_x:.3f} s = "
          f"{rates['shared highest, per-member kernels']:.3f} (highest: the "
          f"exact fold's per-member kernels)")
    del m, pick, s5, plain, state_fc, corr

    # -- one K3 year at M=ENS_M, a table per member against the shared
    #    table (a reading, not a gate): a warm-up, then 3 launches each
    m = GREB(GrebConfig(numerics=num, fast_circulation=True), device="cuda",
             verbose=False)
    yd = m.year_data
    members = ens.perturbed_params(
        m.params, {"ct_sens": np.linspace(22.05, 22.95, ENS_M)})
    pp = my.pack_member_params(members, "cuda")
    s5 = ens.ensemble_initial_state(members, m.forcing)
    _, corr = yk.fluxcorr_year(m.initial_state(),
                               np.float32(m.cfg.co2.co2_flux), yd)
    shared = torch.stack([corr.tf, corr.tof, corr.qf], dim=1)[None]
    co2 = np.asarray([680.0], np.float32)
    c = my.default_cluster("scenario_years", ENS_M, yk.cluster_capacity(
        yd.plan, yk.DEFAULT_CLUSTER, "scenario_years"))
    ms, work = {}, {}
    for label, tab in (("per-member tables", shared.expand(
            ENS_M, -1, -1, -1, -1).contiguous()), ("shared table", shared)):
        ms[label], _ = _launches_ms(
            lambda: my.scenario_years(s5, pp, tab, co2, yd), 3)
        work[label] = my.years_work(m.fold[0], m.num, 1, ENS_M, "scenario",
                                    shared_corr=tab is shared)
        b_ms, b_by = _bound_of(*work[label])
        print(f"K3 one year at M={ENS_M} (C={c}, the default), {label}: "
              f"{_runs(ms[label])}; bound {b_ms:.3f} ms by {b_by}")
    print(f"ensemble phase: {time.perf_counter() - t_phase:.1f} s")
    return dict(err=err, ms={k: _median(v) for k, v in ms.items()},
                work=work, launches=launches, launches_shared=launches_shared,
                rates=rates)


# step 25: the member-batched matmul circulation (csrc/members_kernel.cu):
# K4 and K3 with mb members a 16-block cluster at both precisions
MXU_PRECS = ("bf16_3x", "highest")
MXU_SHORT = dict(ndays_yr=10, jday_mon=(6, 4))     # the 20-step calendar
MXU_TIMED_M = (65, 256)                             # one K3 year timed
# one K3 year at highest against the per-member kernel, about the CLI's
# MXU_HIGHEST_PER_MEMBER_M
MXU_CROSS_M = (96, 112, 128)
# the HIGH budget of tests/test_mxu.py:71 (bf16_3x against the exact fold
# over a spin-up and a scenario year): end-state Ts [K], monthly RMS and
# monthly max
MXU_HIGH_BUDGET = dict(ts=5e-2, rms=5e-3, max=5e-2)
MXU_PHASE_S = 90.0


def _mxu_inputs(m, M):
    """(pack, initial states (5, M, Y, X)) of run_ensemble's first M
    members of the default sweep over M members."""
    from greb_tpu_torch.ops.cuda import multiyear as my
    from greb_tpu_torch.parallel import ensemble as ens
    members = _sweep_members(m, M)
    return (my.pack_member_params(members, "cuda"),
            ens.ensemble_initial_state(members, m.forcing))


def _mxu_phase(tmp, reset_counts, read_counts):
    """Step 25 (see the module docstring).  Returns the worst max |diff|,
    each kernel's ms, plain ms and work at its check's shape (bf16_3x),
    the timed K3 years, the torch.bmm row dots and the HIGH budget."""
    import numpy as np
    import torch
    from greb_tpu_torch import __main__ as cli
    from greb_tpu_torch.config import GrebConfig, Numerics
    from greb_tpu_torch.model.driver import GREB
    from greb_tpu_torch.ops.cuda import multiyear as my
    from greb_tpu_torch.ops.cuda import year_kernel as yk

    t_phase = time.perf_counter()
    m = GREB(GrebConfig(numerics=Numerics(), fast_circulation=True),
             device="cuda", verbose=False)
    yd, plan, num = m.year_data, m.fold[0], m.num
    co2f = np.float32(m.cfg.co2.co2_flux)
    co2y = np.asarray([560.0, 680.0], np.float32)

    # -- a member block's shared memory: the kernel's reckoning against
    #    members_layout at each kind's default mb, the clusters at once
    mbs, capacity = {}, {}
    for kind in my.KINDS:
        mb = mbs[kind] = my.default_mb(plan, kind)
        lay = my.members_layout(plan, mb, kind)
        parts, threads = my.kernel_members_layout(plan, mb, kind)
        if parts != dict(lay.parts) or threads != lay.threads:
            raise AssertionError(f"{kind} mb={mb}: kernel layout {parts}, "
                                 f"{threads} threads; members_layout "
                                 f"{dict(lay.parts)}, {lay.threads}")
        capacity[kind] = my.members_capacity(plan, mb, kind)
        print(f"  {kind}_mxu: mb={mb}, {lay.nbytes} B a block "
              f"({', '.join(f'{n} {b}' for n, b in lay.parts if b)}), "
              f"{threads} threads, {capacity[kind]} clusters at once")
    k4, k3 = "fluxcorr", "scenario_years"

    err, ms, plain_ms, bound = 0.0, {}, {}, {}
    launches0 = (my.fluxcorr_years_mxu.launches,
                 my.scenario_years_mxu.launches)
    for prec in MXU_PRECS:
        mxu = m.members_mxu(prec)
        # -- K4: M = 2 mb members, one year, against the plain twin (the
        #    members as one batch, each step from a CUDA graph); at
        #    "highest" also against the exact fold's per-member kernel
        M4 = 2 * mbs[k4]
        pp4, s4_in = _mxu_inputs(m, M4)
        t4, (s4, c4) = _launches_ms(
            lambda: my.fluxcorr_years_mxu(s4_in, pp4, co2f, yd, mxu), 1)
        (ps4, pc4), p4 = _synced_s(lambda: my.fluxcorr_years_plain(
            s4_in, pp4, co2f, yd, mxu))
        pairs = [("state", s4, ps4), ("tables", c4, pc4)]
        if prec == "highest":
            es4, ec4 = my.fluxcorr_years(s4_in, pp4, co2f, yd)
            pairs += [("state vs exact fold", s4, es4),
                      ("tables vs exact fold", c4, ec4)]
        err = max(err, _bitwise(f"fluxcorr_years_mxu {prec} (M={M4}, "
                                f"mb={mbs[k4]}, 1 year)", pairs, quiet=True))
        _finite(f"fluxcorr_years_mxu {prec}", [("state", s4),
                                                ("tables", c4)])
        # -- K3: M = 2 mb members x 2 years from K4's states, a table per
        #    member (K4's) and one shared (K1's of the base params); the
        #    twin runs both as one batch of 2M
        M3 = 2 * mbs[k3]
        s3_in = s4[:, :M3].contiguous()
        pp3, tabs = pp4[:M3].contiguous(), c4[:M3].contiguous()
        _, c1 = yk.fluxcorr_year(m.initial_state(), co2f, yd)
        shared = torch.stack([c1.tf, c1.tof, c1.qf], dim=1)[None]
        t3, got = _launches_ms(lambda: my.scenario_years_mxu(
            s3_in, pp3, tabs, co2y, yd, mxu), 1)
        got_sh = my.scenario_years_mxu(s3_in, pp3, shared, co2y, yd, mxu)
        plain, p3 = _synced_s(lambda: my.scenario_years_plain(
            torch.cat([s3_in, s3_in], dim=1), torch.cat([pp3, pp3]),
            torch.cat([tabs, shared.expand(M3, -1, -1, -1, -1)]), co2y, yd,
            mxu))
        names = ("state", "monthly means", "annual sums")
        pairs = ([(f"{n} (tables)", g, p[:, :M3] if n == "state" else
                   p[:M3]) for n, g, p in zip(names, got, plain)]
                 + [(f"{n} (shared)", g, p[:, M3:] if n == "state" else
                     p[M3:]) for n, g, p in zip(names, got_sh, plain)])
        if prec == "highest":
            for form, tab, mine in (("tables", tabs, got),
                                    ("shared", shared, got_sh)):
                exact = my.scenario_years(s3_in, pp3, tab, co2y, yd)
                pairs += [(f"{n} ({form}) vs exact fold", g, e)
                          for n, g, e in zip(names, mine, exact)]
        err = max(err, _bitwise(f"scenario_years_mxu {prec} (M={M3}, "
                                f"mb={mbs[k3]}, 2 years)", pairs,
                                quiet=True))
        _finite(f"scenario_years_mxu {prec}",
                list(zip(names, got)) + list(zip(names, got_sh)))
        ms[prec] = {k4: t4[0], k3: t3[0]}
        plain_ms[prec] = {k4: p4 * 1e3, k3: p3 * 1e3}
        bound[prec] = {
            k4: _mxu_bound(plan, num, 1, M4, "fluxcorr", prec),
            k3: _mxu_bound(plan, num, 2, M3, "scenario", prec)}
        print(f"  {prec}: K4 M={M4} a year {t4[0]:.3f} ms (plain twin "
              f"{p4:.1f} s); K3 M={M3} x 2 years {t3[0]:.3f} ms (plain twin "
              f"of both table forms {p3:.1f} s)")
        del s4, c4, ps4, pc4, got, got_sh, plain, tabs

    # -- the short last cluster: M = mb + 1 on the 20-step calendar
    ms_m = GREB(GrebConfig(numerics=Numerics(**MXU_SHORT),
                           fast_circulation=True), device="cuda",
                verbose=False)
    for prec in MXU_PRECS:
        mxu = ms_m.members_mxu(prec)
        M = mbs[k4] + 1
        pp, s_in = _mxu_inputs(ms_m, M)
        got4 = my.fluxcorr_years_mxu(s_in, pp, co2f, ms_m.year_data, mxu)
        want4 = my.fluxcorr_years_plain(s_in, pp, co2f, ms_m.year_data, mxu)
        M = mbs[k3] + 1
        got3 = my.scenario_years_mxu(got4[0][:, :M].contiguous(), pp[:M],
                                     got4[1][:M].contiguous(), co2y,
                                     ms_m.year_data, mxu)
        want3 = my.scenario_years_plain(got4[0][:, :M].contiguous(), pp[:M],
                                        got4[1][:M].contiguous(), co2y,
                                        ms_m.year_data, mxu)
        err = max(err, _bitwise(
            f"short last cluster {prec} (K4 M={mbs[k4] + 1}, K3 "
            f"M={mbs[k3] + 1} x 2 years, {MXU_SHORT['ndays_yr'] * 2} "
            f"steps)", [(n, g, w) for n, g, w in zip(
                ("K4 state", "K4 tables", "K3 state", "K3 monthly",
                 "K3 sums"), list(got4) + list(got3),
                list(want4) + list(want3))], quiet=True))
    del ms_m

    # -- one K3 year at M = 65 and 256 (the shared table, initial states):
    #    both precisions against the per-member kernel (its default size);
    #    a warm-up, then 2 launches each
    timed = {}
    _, c1 = yk.fluxcorr_year(m.initial_state(), co2f, yd)
    shared = torch.stack([c1.tf, c1.tof, c1.qf], dim=1)[None]
    co2 = np.asarray([680.0], np.float32)
    for M in MXU_TIMED_M:
        pp, s_in = _mxu_inputs(m, M)
        row = {}
        for prec in MXU_PRECS:
            mxu = m.members_mxu(prec)
            row[prec], _ = _launches_ms(lambda: my.scenario_years_mxu(
                s_in, pp, shared, co2, yd, mxu), 2)
        row["per-member"], _ = _launches_ms(lambda: my.scenario_years(
            s_in, pp, shared, co2, yd), 2)
        c = my.default_cluster(k3, M, yk.cluster_capacity(
            plan, yk.DEFAULT_CLUSTER, k3))
        timed[M] = {}
        for label, got in row.items():
            prec = label if label in MXU_PRECS else None
            b_ms, b_by = _mxu_bound(plan, num, 1, M, "scenario", prec,
                                    shared_corr=True)
            t = _median(got)
            timed[M][label] = dict(ms=t, member_yr_s=M / (t * 1e-3),
                                   bound_ms=b_ms, bound_by=b_by)
            print(f"  K3 one year at M={M}, {label}"
                  f"{f' (C={c})' if prec is None else ''}: {_runs(got)} = "
                  f"{M / (t * 1e-3):.1f} member-yr/s; bound {b_ms:.3f} ms "
                  f"by {b_by}")
        del pp, s_in
    # -- about the CLI's MXU_HIGHEST_PER_MEMBER_M: one K3 year at highest
    #    against the per-member kernel, a warm-up, then 1 launch each
    mxu = m.members_mxu("highest")
    for M in MXU_CROSS_M:
        pp, s_in = _mxu_inputs(m, M)
        b_ms, b_by = _mxu_bound(plan, num, 1, M, "scenario", "highest",
                                shared_corr=True)
        timed[M] = {}
        for label, fn in (
                ("highest", lambda: my.scenario_years_mxu(
                    s_in, pp, shared, co2, yd, mxu)),
                ("per-member", lambda: my.scenario_years(
                    s_in, pp, shared, co2, yd))):
            (t,), _ = _launches_ms(fn, 1)
            timed[M][label] = dict(ms=t, member_yr_s=M / (t * 1e-3),
                                   bound_ms=b_ms, bound_by=b_by)
        faster = min(timed[M], key=lambda k: timed[M][k]["ms"])
        route = ("per-member" if M >= cli.MXU_HIGHEST_PER_MEMBER_M
                 else "highest")
        print(f"  K3 one year at M={M}: highest "
              f"{timed[M]['highest']['ms']:.3f} ms, per-member "
              f"{timed[M]['per-member']['ms']:.3f} ms after a warm-up; the "
              f"faster {faster}, the CLI's route at highest {route}; bound "
              f"{b_ms:.3f} ms by {b_by}")
        del pp, s_in

    # -- the substep's row dot alone by torch.bmm at its shapes, (F*Y, M,
    #    X) @ (F*Y, X, 2X): three bfloat16 products (bf16_3x, their parts
    #    made once) or one float32 product, a substep of M members
    bmm = {}
    F, Y, X = 2, plan.ydim, plan.xdim
    gen = torch.Generator(device="cuda").manual_seed(0)
    for M in MXU_TIMED_M:
        x = torch.rand((F * Y, M, X), device="cuda", generator=gen)
        w = torch.rand((F * Y, X, 2 * X), device="cuda", generator=gen)
        xh, wh = x.to(torch.bfloat16), w.to(torch.bfloat16)
        xl = (x - xh.float()).to(torch.bfloat16)
        wl = (w - wh.float()).to(torch.bfloat16)
        for prec, fn in (
                ("bf16_3x", lambda: (torch.bmm(xh, wh) + torch.bmm(xh, wl))
                 + torch.bmm(xl, wh)),
                ("highest", lambda: torch.bmm(x, w))):
            fn()        # the library's first call picks its kernel
            t, _ = _time_ms(fn, 200)
            bmm[(M, prec)] = t
            print(f"  torch.bmm row dot, M={M}, {prec}: {t * 1e3:.2f} us a "
                  f"substep, {t * num.nsub_crcl * num.nstep_yr:.1f} ms a year")

    # -- the HIGH budget: a bf16_3x K4 + K3 year at M=2 against the exact
    #    fold's per-member kernels (tests/test_mxu.py:71's CPU bounds)
    pp, s_in = _mxu_inputs(m, 2)
    mxu = m.members_mxu("bf16_3x")
    hs, hc = my.fluxcorr_years_mxu(s_in, pp, co2f, yd, mxu)
    es, ec = my.fluxcorr_years(s_in, pp, co2f, yd)
    hs, hmon, _ = my.scenario_years_mxu(hs, pp, hc, co2y[1:], yd, mxu)
    es, emon, _ = my.scenario_years(es, pp, ec, co2y[1:], yd)
    _finite("HIGH budget, bf16_3x", [("state", hs), ("monthly", hmon)])
    dmon = (hmon - emon).double()
    budget = dict(ts=float((hs[0] - es[0]).abs().max()),
                  rms=float(dmon.pow(2).mean().sqrt()),
                  max=float(dmon.abs().max()))
    # a reading against the CPU bounds: a miss is recorded (ROADMAP Queue
    # 3, beside greb_tpu's own miss on the TPU), as the JAX package's TPU
    # run records its own; the finite check above holds
    within = {k: v < MXU_HIGH_BUDGET[k] for k, v in budget.items()}
    print(f"  HIGH budget (bf16_3x against the exact fold, M=2, 1 + 1 "
          f"years): " + ", ".join(
              f"{k} {v:.3e} ({'within' if within[k] else 'MISS of'} "
              f"{MXU_HIGH_BUDGET[k]:.0e})" for k, v in budget.items()))
    budget = dict(budget, within=within)
    print(f"  launches in this step: fluxcorr_years_mxu "
          f"{my.fluxcorr_years_mxu.launches - launches0[0]}, "
          f"scenario_years_mxu "
          f"{my.scenario_years_mxu.launches - launches0[1]}")
    seconds = time.perf_counter() - t_phase
    print(f"mxu phase: {seconds:.1f} s")
    return dict(err=err, ms=ms, plain_ms=plain_ms, bound=bound, timed=timed,
                bmm=bmm, budget=budget, mb=mbs, capacity=capacity,
                seconds=seconds)


def _long_runner(model, tmp, tag):
    from greb_tpu_torch.io.checkpoint import Checkpointer
    from greb_tpu_torch.model import longrun
    ck = Checkpointer(os.path.join(tmp, f"ck_{tag}"), every_years=LONG_BLOCK)
    runner = longrun.driver_year_runner(
        model, os.path.join(tmp, f"long_{tag}"), years_per_call=LONG_BLOCK)
    return ck, runner


def _resume_long(tmp: str) -> int:
    """The fresh process of step 9: resume the stopped long run from its
    newest checkpoint and run it to the end."""
    t0 = time.perf_counter()
    import numpy as np
    import torch
    from greb_tpu_torch.config import GrebConfig, Numerics
    from greb_tpu_torch.model import longrun
    from greb_tpu_torch.model.driver import GREB
    from greb_tpu_torch.ops.cuda import multiyear as my

    model = GREB(GrebConfig(numerics=Numerics(time_flux=3),
                            fast_circulation=True),
                 device="cuda", verbose=False)
    ck, runner = _long_runner(model, tmp, "resumed")
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    ck.restore(device="cuda")
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    _, _, start = longrun.run_long(
        LONG_YEARS, None, None, np.full(LONG_YEARS, 680.0, np.float32),
        runner, checkpointer=ck, chunk_years=LONG_BLOCK, device=model.device)
    torch.cuda.synchronize()
    runner.close()
    t3 = time.perf_counter()
    print(json.dumps({"start": start, "setup_s": t1 - t0,
                      "restore_s": t2 - t1, "run_s": t3 - t2,
                      "scenario_years_launches": my.scenario_years.launches}))
    return 0


def _path_shape_inputs(model, state, corr):
    """The member kernels' arguments at the shapes their paths launch: K3
    one member with the base params for LONG_BLOCK years at 680 ppm from
    (state, corr), the long run's block; K4 the member chain's 3 members
    (ct_sens -2%, base, +2%: the JAX CLI's default sweep) from the initial
    state, its spin-up year."""
    import numpy as np
    import torch
    from greb_tpu_torch.ops.cuda import multiyear as my
    from greb_tpu_torch.parallel import ensemble as ens
    yd = model.year_data
    pp1 = my.pack_member_params([model.params], "cuda")
    corr1 = torch.stack([corr.tf, corr.tof, corr.qf], dim=1)[None]
    pp3 = my.pack_member_params(ens.perturbed_params(
        model.params, {"ct_sens": np.linspace(22.05, 22.95, 3)}), "cuda")
    return {"scenario_years": (state.stack()[:, None], pp1, corr1,
                               np.full(LONG_BLOCK, 680.0, np.float32), yd),
            "fluxcorr_years": (
                model.initial_state().stack()[:, None].repeat(1, 3, 1, 1),
                pp3, np.float32(model.cfg.co2.co2_flux), yd)}


def _time_member_kernels(inputs, repeats=3):
    """ms of ``repeats`` launches of K3 and K4 on ``inputs``
    (``_path_shape_inputs``), each after a warm-up launch, and the last
    launch's outputs, through the wrappers' defaults."""
    from greb_tpu_torch.ops.cuda import multiyear as my
    ms, outs = {}, {}
    for name, args in inputs.items():
        ms[name], outs[name] = _launches_ms(
            lambda: getattr(my, name)(*args), repeats)
        print(f"{name} at its path's shape: {_runs(ms[name])}")
    return ms, outs


# step 20: the grids between 192x96 and 384x192 at dt_crcl=1800, where the
# fold has additive splitting with packed composites and the cluster body
# does not hold the strict transport's K3 (csrc/band_kernel.cu: the refined
# instantiation's additive packed and strict additive forms): 256x128 in
# full, the fold's kernels held to plain on REFINED_SHORT's 20 steps (the
# plain steps replayed from CUDA graphs; under log_exp 11 K1 and K2, and
# K4 = K1, K3 = K2 at M=1), the strict circulation's on
# STRICT_REFINED_SHORT's 2 (the plain circulation replayed from CUDA
# graphs), GREB.run under the fold and under GrebConfig's default (the
# strict circulation) for G256_YEARS on the full calendar, the same years in
# one K3 block, the CLI's --ensemble G256_SHARED_M --shared-spinup, and on
# the 20-step calendar the long run in K3 blocks of G256_BLOCK stopped at
# G256_STOP and resumed in a fresh process; at the band's other grids
# (BAND_GRIDS: 7, 9, 10, 11 rows a block, segment tables of other depths)
# K1 and K2 under the fold on WORDS_SHORT's 4 steps (K2 from the initial
# state with zero tables; eager plain steps: a graph would not repay its
# capture), and under the strict circulation on
# 2 at BAND_STRICT (K4 = K1, K3 = K2 at M=1 there), cut to these for the
# smoke's time limit (the strict checks at 288x144 took 20.5 s on an H100,
# most of it the eager strict circulation that their CUDA graph is held
# to; an eager strict step at 352x176 takes seconds)
G256_GRID = dict(xdim=256, ydim=128, dt_crcl=1800)
G256_YEARS = dict(time_flux=1, time_scnr=1)
G256_SHARED_M = 4
G256_ENSEMBLES = (("shared", G256_SHARED_M, G256_YEARS, ["--shared-spinup"]),)
G256_LONG = 4
G256_BLOCK = 2
G256_STOP = 2
BAND_GRIDS = ((224, 112), (288, 144), (320, 160), (352, 176))
BAND_STRICT = ((224, 112),)
BAND_KERNELS = ("fluxcorr_year", "scenario_year", "fluxcorr_years",
                "scenario_years")


def _grid256_runner(model, tmp, tag):
    """The 256x128 long run on REFINED_SHORT's calendar: a checkpoint every
    G256_BLOCK years, K3 blocks of G256_BLOCK years, the output file."""
    from greb_tpu_torch.io.checkpoint import Checkpointer
    from greb_tpu_torch.model import longrun
    ck = Checkpointer(os.path.join(tmp, f"ck256_{tag}"),
                      every_years=G256_BLOCK)
    runner = longrun.driver_year_runner(
        model, os.path.join(tmp, f"long256_{tag}"), years_per_call=G256_BLOCK)
    return ck, runner


def _resume_long256(tmp: str) -> int:
    """The fresh process of step 20: rebuild the 256x128 model on the
    20-step calendar, resume the stopped long run from its newest
    checkpoint and run it to G256_LONG years."""
    t0 = time.perf_counter()
    import numpy as np
    import torch
    from greb_tpu_torch.config import Numerics
    from greb_tpu_torch.model import longrun
    from greb_tpu_torch.ops.cuda import multiyear as my
    model, _ = _refined_model(Numerics(**G256_GRID, **REFINED_SHORT))
    ck, runner = _grid256_runner(model, tmp, "resumed")
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    _, _, start = longrun.run_long(
        G256_LONG, None, None, np.full(G256_LONG, 680.0, np.float32), runner,
        checkpointer=ck, chunk_years=G256_BLOCK, device=model.device)
    torch.cuda.synchronize()
    runner.close()
    print(json.dumps({"start": start, "setup_s": t1 - t0,
                      "run_s": time.perf_counter() - t1,
                      "scenario_years_launches": my.scenario_years.launches}))
    return 0


def _band_layouts(tag, plan, strict_plan):
    """The kernel's own reckoning of each kind's block for the fold's plan
    and the strict transport's against Python's (block_layout); returns the
    fold's capacity of 16-block clusters by kind."""
    from greb_tpu_torch.ops.cuda import year_kernel as yk
    capacity = {}
    for kind in yk.KINDS:
        for p in (plan, strict_plan):
            want = yk.block_layout(p, 16, kind)
            parts, threads = yk.kernel_cluster_layout(p, 16, kind)
            if parts != dict(want.parts) or threads != want.threads:
                raise AssertionError(
                    f"{tag} {kind} {type(p).__name__}: kernel layout "
                    f"{parts}, {threads} threads; Python {dict(want.parts)}, "
                    f"{want.threads}")
        capacity[kind] = yk.cluster_capacity(plan, 16, kind)
        print(f"{tag} {kind:<14s} C=16: fold "
              f"{yk.block_layout(plan, 16, kind).nbytes} B a block "
              f"({capacity[kind]} clusters at once), strict "
              f"{yk.block_layout(strict_plan, 16, kind).nbytes} B "
              f"({yk.cluster_capacity(strict_plan, 16, kind)}); kernel and "
              f"Python agree")
    return capacity


def _band_entries(tag, yd, entries, mode, members=""):
    """The entries the launchers pick for yd's plan and word (held against
    refined_entry); records in ``entries`` ``mode`` for K1's and K2's, and
    ``mode + members`` for K4's and K3's (None: they were not run);
    returns their names."""
    names = [_pick_check(tag, k, yd) for k in BAND_KERNELS]
    for kernel, name in zip(BAND_KERNELS, names):
        if kernel.endswith("s"):
            if members is None:
                continue
            entries.setdefault(name, []).append(mode + members)
        else:
            entries.setdefault(name, []).append(mode)
    return names


def _band_k1_k2(tag, m, co2f, co2s, zero_tables=False):
    """K1 from m's initial state and K2 from K1's end with its tables
    (``zero_tables``: from the initial state with zero tables), bitwise
    against their plain versions and finite: ({kernel: max |diff|},
    {kernel: ms}, {kernel: plain ms}, (K1's result, K2's result, K2's
    input state and tables))."""
    from greb_tpu_torch.forcing import Corrections
    from greb_tpu_torch.ops.cuda import year_kernel as yk
    yd, num = m.year_data, m.num
    s0 = m.initial_state()
    ms1, k1 = _time_ms(lambda: yk.fluxcorr_year(s0, co2f, yd), 1)
    k2_in = (s0, Corrections.zeros(num.nstep_yr, num.ydim, num.xdim,
                                   device="cuda")) if zero_tables else k1
    ms2, k2 = _time_ms(lambda: yk.scenario_year(*k2_in, co2s, yd), 1)
    _finite(f"K1 {tag}", [("state", k1[0].stack()), ("tf", k1[1].tf)])
    _finite(f"K2 {tag}", [("state", k2[0].stack()), ("outs", k2[1])])
    n = num.nstep_yr
    p1, e1 = _time_ms(lambda: _k1_vs_plain(f"K1 {tag}, {n} steps", s0, co2f,
                                           yd, k1), 1)
    p2, e2 = _time_ms(lambda: _k2_vs_plain(f"K2 {tag}, {n} steps", *k2_in,
                                           co2s, yd, k2), 1)
    return ({"fluxcorr_year": e1, "scenario_year": e2},
            {"fluxcorr_year": ms1, "scenario_year": ms2},
            {"fluxcorr_year": p1, "scenario_year": p2}, (k1, k2, k2_in))


def _single_members(m, tag, co2f, co2s, k1, k2, k2_in):
    """K4 = K1 and K3 = K2 at M=1 with the base params (``k1``: K1's year
    from m's initial state at ``co2f``; ``k2``: K2's year at ``co2s`` from
    ``k2_in``, a state and its tables), bitwise; the worst max |diff| per
    kernel."""
    import numpy as np
    import torch
    from greb_tpu_torch.ops.cuda import multiyear as my
    yd = m.year_data
    base = my.pack_member_params([m.params], "cuda")
    tab = lambda c: torch.stack([c.tf, c.tof, c.qf], dim=1)[None]
    s41, c41 = my.fluxcorr_years(m.initial_state().stack()[:, None], base,
                                 co2f, yd)
    s31, _, a31 = my.scenario_years(k2_in[0].stack()[:, None], base,
                                    tab(k2_in[1]), np.asarray([co2s]), yd)
    return {"fluxcorr_years": _bitwise(
                f"K4 = K1 {tag} (M=1)", [("state", s41[:, 0], k1[0].stack()),
                                          ("tables", c41[0], tab(k1[1])[0])],
                quiet=True),
            "scenario_years": _bitwise(
                f"K3 = K2 {tag} (M=1)", [("state", s31[:, 0], k2[0].stack()),
                                          ("annual sums", a31[0, 0], k2[2])],
                quiet=True)}


def _grid256_phase(tmp, reset_counts, read_counts):
    """Step 20: the grids between 192x96 and 384x192 (the refined
    instantiation's additive packed and strict additive forms), 256x128's
    paths through them.  Returns the worst max |diff| per kernel, each new
    entry's modes, the launches' and plain versions' ms and work at
    256x128 by mode, the paths' launches and full-calendar years."""
    import gc

    import numpy as np
    import torch
    from greb_tpu_torch.config import Numerics
    from greb_tpu_torch.forcing import ModelState
    from greb_tpu_torch.model import longrun
    from greb_tpu_torch.ops.cuda import multiyear as my
    from greb_tpu_torch.ops.cuda import year_kernel as yk

    t_phase = time.perf_counter()
    err = dict.fromkeys(BAND_KERNELS, 0.0)
    entries = {}
    out = dict(ms={}, plain_ms={}, work={}, shape={}, band={})

    def worse(e):
        for k, v in e.items():
            err[k] = max(err[k], v)

    def report(mode, names, ms, plain, t0):
        print(f"  {mode}: {', '.join(names)}; kernels "
              f"{', '.join(f'{k} {v:.1f}' for k, v in ms.items())} ms; plain "
              f"{', '.join(f'{k} {v:.1f}' for k, v in plain.items())} ms; "
              f"{time.perf_counter() - t0:.1f} s")

    co2f, co2s = np.float32(340.0), np.float32(680.0)
    # the 20-step models at 256x128 (the fold, log_exp 11, the long run's)
    # share one fold; the paths' models build their own, timed
    folds = _SharedFolds().start()
    # -- 256x128 on the 20-step calendar: the fold (all four kernels against
    #    plain, K3 also reading one shared table), then log_exp 11 (K1 and
    #    K2 against plain, K4 = K1 and K3 = K2 at M=1)
    t0 = time.perf_counter()
    short = Numerics(**G256_GRID, **REFINED_SHORT)
    graphed = _GraphedSteps().start()
    m, regrid_s = _refined_model(short)
    yd, plan = m.year_data, m.fold[0]
    if yk.refined_form(plan) != "additive_packed":
        raise AssertionError(f"256x128: not the additive packed form: {plan}")
    _, ranks = yk.packed_ranks(m.fold[1])
    print(f"grid256 {short.xdim}x{short.ydim}: {short.nstep_yr}-step "
          f"calendar, {short.nsub_crcl} substeps, plan {plan}, composite "
          f"ranks {ranks.tolist()} (Rtot {int(ranks.sum())}); regrid "
          f"{regrid_s:.2f} s")
    out["capacity"] = _band_layouts("grid256", plan,
                                    yk.StrictPlan(short.ydim, short.xdim))
    graphed.check(m, co2f)
    mode = "256x128 fold"
    names = _band_entries(mode, yd, entries, mode)
    e12, ms, plain, (k1, k2, _) = _band_k1_k2(mode, m, co2f, co2s)
    worse(e12)
    m_err, m_plain, m_ms = _short_members(m, mode, co2f, co2s, k1, k2, k1)
    worse(m_err)
    ms.update(m_ms)
    plain.update(m_plain)
    # K3 reading K1's tables as one shared table equals K3 reading them
    # copied a member (held to plain in _short_members' per-member run)
    two = my.pack_member_params(_sweep_members(m, 2), "cuda")
    s5 = torch.stack([k1[0].stack()] * 2, dim=1)
    tab = torch.stack([k1[1].tf, k1[1].tof, k1[1].qf], dim=1)[None]
    co2y = np.asarray([560.0, 680.0], np.float32)
    worse({"scenario_years": _bitwise(
        f"K3 {mode} (M=2, 2 years): one shared table vs the table copied",
        zip(("state", "monthly means", "annual sums"),
            my.scenario_years(s5, two, tab, co2y, yd),
            my.scenario_years(s5, two, tab.expand(2, -1, -1, -1, -1)
                              .contiguous(), co2y, yd)), quiet=True)})
    out["ms"][mode], out["plain_ms"][mode] = ms, plain
    out["work"][mode] = _work4(m, ranks)
    out["shape"][mode] = dict(fluxcorr_year="1 year, 20 steps",
                              scenario_year="1 year, 20 steps",
                              fluxcorr_years="M=2 x 1 year, 20 steps",
                              scenario_years="M=2 x 2 years, 20 steps")
    report(mode, names, ms, plain, t0)
    t0 = time.perf_counter()
    mode = "256x128 log_exp 11"
    m11, _ = _refined_model(short, log_exp=11)
    names = _band_entries(mode, m11.year_data, entries, mode,
                          " (M=1, = K1, K2)")
    e12, ms, plain, (k1, k2, _) = _band_k1_k2(mode, m11, co2f, co2s)
    worse(e12)
    worse(_single_members(m11, mode, co2f, co2s, k1, k2, k1))
    out["band"][mode] = dict(ms=ms, plain_ms=plain)
    report(mode, names, ms, plain, t0)
    graphed.stop()
    out["fold_model"] = m      # step 21 shards it
    del m, m11, yd, k1, k2, s5, tab
    # -- the strict circulation at 256x128 on 2 steps: all four kernels
    #    against plain, K4 = K1 and K3 = K2 at M=1
    t0 = time.perf_counter()
    circ = _GraphedCirculation().start()
    mode = "256x128 strict circulation"
    m, _ = _refined_model(Numerics(**G256_GRID, **STRICT_REFINED_SHORT),
                          fast=False)
    nd, na = m.year_data.plan.sub_cycles
    print(f"  strict sub-cycles from the top pole: diffusion {nd[:12]}, "
          f"advection {na[:12]}; {m.num.nstep_yr}-step calendar")
    out["circulation_ms"] = circ.check(m)
    names = _band_entries(mode, m.year_data, entries, mode)
    e12, ms, plain, (k1, k2, k2_in) = _band_k1_k2(mode, m, co2f, co2s,
                                                  zero_tables=True)
    worse(e12)
    m_err, m_plain, m_ms = _short_members(m, mode, co2f, co2s, k1, k2, k2_in,
                                          after_k4=False)
    worse(m_err)
    ms.update(m_ms)
    plain.update(m_plain)
    out["ms"][mode], out["plain_ms"][mode] = ms, plain
    out["work"][mode] = _work4(m)
    out["shape"][mode] = dict(fluxcorr_year="1 year, 2 steps",
                              scenario_year="1 year, 2 steps",
                              fluxcorr_years="M=2 x 1 year, 2 steps",
                              scenario_years="M=2 x 2 years, 2 steps")
    report(mode, names, ms, plain, t0)
    out["strict_model"] = m    # step 21 shards it
    del m, k1, k2, k2_in
    print(f"  256x128 short checks: {time.perf_counter() - t_phase:.1f} s")

    # -- the band's other grids
    for X, Y in BAND_GRIDS:
        t0 = time.perf_counter()
        g = dict(G256_GRID, xdim=X, ydim=Y)
        m, _ = _refined_model(Numerics(**g, **WORDS_SHORT))
        if yk.refined_form(m.fold[0]) != "additive_packed":
            raise AssertionError(f"{X}x{Y}: {m.fold[0]}")
        _band_layouts(f"grid{X}", m.fold[0], yk.StrictPlan(Y, X))
        mode = f"{X}x{Y} fold"
        names = _band_entries(mode, m.year_data, entries, mode, None)
        # K2 from the initial state with zero tables: on 4 steps a scenario
        # after a spin-up with its tables is not finite
        e12, ms, plain, _ = _band_k1_k2(mode, m, co2f, co2s,
                                        zero_tables=True)
        worse(e12)
        out["band"][mode] = dict(ms=ms, plain_ms=plain)
        report(mode, names, ms, plain, t0)
        del m
        if (X, Y) not in BAND_STRICT:
            continue
        t0 = time.perf_counter()
        mode = f"{X}x{Y} strict circulation"
        m, _ = _refined_model(Numerics(**g, **STRICT_REFINED_SHORT),
                              fast=False)
        circ.check(m)
        names = _band_entries(mode, m.year_data, entries, mode,
                              " (M=1, = K1, K2)")
        e12, ms, plain, (k1, k2, k2_in) = _band_k1_k2(mode, m, co2f, co2s,
                                                      zero_tables=True)
        worse(e12)
        worse(_single_members(m, mode, co2f, co2s, k1, k2, k2_in))
        out["band"][mode] = dict(ms=ms, plain_ms=plain)
        report(mode, names, ms, plain, t0)
        del m, k1, k2, k2_in
        circ.graphs.clear()
    circ.stop()
    gc.collect()
    torch.cuda.empty_cache()

    # -- the 256x128 long run on the 20-step calendar: run_long in K3
    #    blocks of G256_BLOCK from K1's end with its tables, a checkpoint
    #    after each; the same run stopped at G256_STOP and resumed in a
    #    fresh process; the final state and the output file bitwise equal
    t0 = time.perf_counter()
    m, _ = _refined_model(short)
    s1, c1 = yk.fluxcorr_year(m.initial_state(), co2f, m.year_data)
    co2_long = np.full(G256_LONG, 680.0, np.float32)
    ck_full, run_full = _grid256_runner(m, tmp, "full")
    reset_counts()
    s_full, _, _ = longrun.run_long(G256_LONG, s1, c1, co2_long, run_full,
                                    checkpointer=ck_full,
                                    chunk_years=G256_BLOCK)
    run_full.close()
    out["launches_long"] = read_counts("grid256 long run", {
        "fluxcorr_year": 0, "scenario_year": 0, "fluxcorr_years": 0,
        "scenario_years": G256_LONG // G256_BLOCK})
    _finite("grid256 long run", [(f"state {k}", getattr(s_full, k))
                                 for k in ModelState.FIELDS])
    ck_res, run_res = _grid256_runner(m, tmp, "resumed")
    longrun.run_long(G256_STOP, s1, c1, co2_long, run_res,
                     checkpointer=ck_res, chunk_years=G256_BLOCK)
    run_res.close()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--resume-long256", tmp],
        capture_output=True, text=True, timeout=600)
    wall_resume = time.perf_counter() - t1
    if proc.returncode != 0:
        print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
        raise AssertionError(f"256x128 resume exited {proc.returncode}")
    child = json.loads(proc.stdout.strip().splitlines()[-1])
    if child["start"] != G256_STOP:
        raise AssertionError(f"256x128 resumed at {child['start']}")
    s_res, _, cursor = type(ck_res)(ck_res.dir).restore(device="cuda")
    if cursor.year_index != G256_LONG:
        raise AssertionError(f"256x128 last checkpoint {cursor.year_index}")
    _bitwise("grid256 resumed vs uninterrupted", [
        (f"state {k}", getattr(s_res, k), getattr(s_full, k))
        for k in ModelState.FIELDS], quiet=True)
    with open(os.path.join(tmp, "long256_full"), "rb") as f, \
            open(os.path.join(tmp, "long256_resumed"), "rb") as g:
        full_bytes = f.read()
        if full_bytes != g.read():
            raise AssertionError("256x128 resumed output file differs")
    print(f"grid256 long run ({G256_LONG} years in K3 blocks of {G256_BLOCK},"
          f" checkpoints every {G256_BLOCK}, {short.nstep_yr}-step calendar):"
          f" stopped at {G256_STOP}, resumed in a fresh process "
          f"({wall_resume:.1f} s wall: set-up {child['setup_s']:.1f} s, years"
          f" {child['start']}..{G256_LONG} {child['run_s']:.3f} s, "
          f"{child['scenario_years_launches']} K3 launches); final state and "
          f"output file ({len(full_bytes)} B) bitwise equal; "
          f"{time.perf_counter() - t0:.1f} s")
    del m, s1, c1, s_full, s_res
    folds.stop()
    gc.collect()
    torch.cuda.empty_cache()

    # -- the 256x128 paths on the full calendar: GREB.run under the fold,
    #    the same years in one K3 block, --ensemble G256_SHARED_M
    #    --shared-spinup; then GREB.run under GrebConfig's default; each
    #    path's own K1 and K2 launches timed
    model, state, corr, monthly, launches, rate, timing = _refined_path(
        "grid256", tmp, G256_GRID, G256_YEARS, reset_counts, read_counts)
    out["paths"] = _refined_member_paths(
        model, tmp, state, monthly, corr, reset_counts, read_counts,
        block=2, ensembles=G256_ENSEMBLES, tag="grid256")
    out["launches_path"], out["rate"] = launches, rate
    num = model.num
    _, ranks = yk.packed_ranks(model.fold[1])
    out["full_ms"] = {"fold": {k: timing[k][0] for k in ("fluxcorr_year",
                                                        "scenario_year")}}
    out["full_work"] = {"fold": {
        k: yk.year_work(model.fold[0], num, k == "scenario_year", ranks)
        for k in ("fluxcorr_year", "scenario_year")}}
    del model, state, corr, monthly
    gc.collect()
    torch.cuda.empty_cache()
    model, _, _, _, launches, rate, timing = _refined_path(
        "grid256_strict", tmp, G256_GRID, G256_YEARS, reset_counts,
        read_counts, fast=None)
    out["launches_strict_path"], out["strict_rate"] = launches, rate
    yd = model.year_data
    out["full_ms"]["strict"] = {k: timing[k][0] for k in ("fluxcorr_year",
                                                          "scenario_year")}
    out["full_work"]["strict"] = {
        k: yk.year_work(yd.plan, num, k == "scenario_year", flags=yd.flags)
        for k in ("fluxcorr_year", "scenario_year")}
    per_sub = 1e3 / (num.nstep_yr * num.nsub_crcl)
    for transport, mss in out["full_ms"].items():
        for name, ms in mss.items():
            b_ms, b_by = _bound_of(*out["full_work"][transport][name])
            print(f"grid256 {transport} {name} (1 year, the path's), "
                  f"{num.nstep_yr} steps: {ms:.3f} ms = {ms * per_sub:.3f} "
                  f"us a substep (a step's work included); bound {b_ms:.3f} "
                  f"ms by {b_by}")
    del model, yd
    gc.collect()
    torch.cuda.empty_cache()
    out["err"], out["entries"] = err, entries
    print(f"grid256 phase: {time.perf_counter() - t_phase:.1f} s")
    return out


# step 21: every word and the band grids on a CUDA mesh: the slab kernels'
# strict forms (csrc/slab_kernel.cu slab_strict: the cluster body's at
# 96x48, the additive one at 256x128, the sequential one at 384x192), their
# step start without a fold, their finish with the switches of the flags
# word, and the additive packed form of 224x112 to 352x176's fold; step
# 17's 2-step strict 384x192 model and step 20's 256x128 models are reused
SHARD_WORD_EXPS = (11, 8, 16, 2)   # a fold word; strict, q by diffusion
                                   # alone; strict, q still; no transport
SHARD_STRICT_YEARS = dict(time_flux=1, time_scnr=1)
SHARD_WORD_NY = 2
STRICT_SLAB_ENTRIES = ("slab_start_strict", "slab_strict<strict_cluster>",
                       "slab_finish<legacy>", "slab_substep<additive_packed>",
                       "slab_strict<strict_additive>", "slab_strict<strict>")


def _strict_plain_ms(model, n_y, shard=0, reps=20):
    """ms of the plain version of each strict slab entry on one shard of
    ``model`` on n_y shards (the card, eager, ``reps`` calls after a
    warm-up): slab_start_strict ((Ta, q) stacked), slab_strict (one
    substep of stencils.circulation on the shard's rows in the masked
    full-field form the plain sharded runners run, zero halo rows),
    slab_finish<legacy> (core.fluxcorr_step under the model's word with
    the circulation's increment zero: the pointwise physics and update
    alone)."""
    import numpy as np
    import torch
    from greb_tpu_torch.model import core
    from greb_tpu_torch.ops import stencils as stc
    from greb_tpu_torch.parallel import sharded as sh
    R = model.num.ydim // n_y
    lo, hi = shard * R, (shard + 1) * R
    fx = sh._cut_sfx(model.sfx, lo, hi, "cuda").at(0)
    md = sh._cut_md(model.md, lo, hi, "cuda")
    st = dataclasses.replace(md.st, compact_polar=False)
    md = dataclasses.replace(md, st=st)
    s0 = model.initial_state()
    state = type(s0)(*[getattr(s0, f.name)[lo:hi].contiguous()
                       for f in dataclasses.fields(s0)])
    d = md.derived
    x2 = torch.stack([state.ta, state.q], dim=-3)
    wz2 = torch.stack([d.wz_air, d.wz_vapor], dim=-3)
    u, v = fx.u, fx.v
    fns = {"slab_start_strict": lambda: torch.stack([state.ta, state.q],
                                                    dim=-3),
           "slab_strict": lambda: stc.circulation(
               x2, wz2, u.clamp(min=0.0), u.clamp(max=0.0),
               v.clamp(min=0.0), v.clamp(max=0.0), st, md.sf,
               model.params.kappa, 1),
           "slab_finish<legacy>": lambda: core.fluxcorr_step(
               state, fx, np.float32(680.0), md, model.num, None, model.exp)}
    out = {}
    circ = stc.circulation
    try:
        for name, fn in fns.items():
            if name == "slab_finish<legacy>":
                stc.circulation = lambda x, *a, **k: torch.zeros_like(x)
            fn()
            out[name] = _time_ms(fn, reps)[0]
    finally:
        stc.circulation = circ
    return out


def _sharded_words_phase(tmp, m384=None, m256=None, m256s=None,
                         workers=None, plain96=None):
    """Step 21: the slab kernels under every word and at the band grids,
    each run against the unsharded kernels in the same word (K1 -> K2,
    K4 -> K3), bitwise and finite: 96x48 under the library default (the
    strict circulation) on the full calendar on 2 and 4 shards (the
    4-shard path timed on its second run, its launches counted by entry),
    against its plain sharded version on 10 steps (eager) and two gloo
    processes (step 19's workers, ``workers``) against one, 2 members x 2
    shards against K4 -> K3 at M=2 on 20 steps; the legacy words
    SHARD_WORD_EXPS on 2 shards on 20 steps; 256x128 on 4 shards under the
    fold (step 20's 20-step model: the pole shards' additive packed form)
    and the strict circulation (its 2-step model, from the initial state);
    384x192 strict on 4 shards (step 17's 2-step model); each new entry's
    launch timed on each shard (a CUDA graph of launches), its plain
    version's on the pole shard, its bound and its launches on its path.
    Returns the worst max |diff|, the sharded strict 96x48 rate and, by
    entry, ms, plain ms, work, launches, shape and the runs it was held
    bitwise in.  A model, the workers or the plain sharded years
    (``plain96``: _plain_strict's) not given (the phase run alone) are
    made here as those steps make them."""
    import gc

    import numpy as np
    import torch
    from greb_tpu_torch.config import Experiment, GrebConfig, Numerics
    from greb_tpu_torch.model import core
    from greb_tpu_torch.model.driver import GREB
    from greb_tpu_torch.ops import fastcirc2 as fc2
    from greb_tpu_torch.ops.cuda import multiyear as my
    from greb_tpu_torch.ops.cuda import slab
    from greb_tpu_torch.ops.cuda import year_kernel as yk
    from greb_tpu_torch.parallel import ensemble as ens

    t_phase = time.perf_counter()
    if m384 is None:
        m384, _ = _refined_model(Numerics(**REFINED_GRID,
                                          **STRICT_REFINED_SHORT), fast=False)
    if m256 is None:
        m256, _ = _refined_model(Numerics(**G256_GRID, **REFINED_SHORT))
    if m256s is None:
        m256s, _ = _refined_model(Numerics(**G256_GRID,
                                           **STRICT_REFINED_SHORT),
                                  fast=False)
    if workers is None:
        path, child, _ = _shard_workers(tmp)
        workers = (path + ".strict", child)
    out = dict(err=0.0, ms={}, plain_ms={}, work={}, launches={}, shape={},
               modes={e: [] for e in STRICT_SLAB_ENTRIES})
    ticks = [t_phase]

    def tick(what):
        ticks.append(time.perf_counter())
        print(f"  [{what}: {ticks[-1] - ticks[-2]:.1f} s]")

    def check(tag, pairs, entries=None):
        """Bitwise, and credit each new entry the run launched."""
        out["err"] = max(out["err"], _bitwise(tag, pairs, quiet=True))
        for e in entries or _slab_entry_launches():
            if e in out["modes"]:
                out["modes"][e].append(tag)

    def against(tag, m, n_y, launches=None, path=None, **kw):
        """The slab years of ``m`` on n_y shards against K1 -> K2 (from0:
        both from the initial state, K2 with zero tables), finite, with
        ``launches`` (start, substep, finish) a shard a step; ``path``:
        the new entries of this run take its launch counts."""
        want = _unsharded_run(m, n_y, from0=kw.get("from0", False))
        got, secs, n = _sharded_run(m, n_y, **kw)
        ents = _slab_entry_launches()
        check(f"{tag} {n_y} shards vs K1 -> K2 ({m.num.nstep_yr} steps)",
              _years_pairs(got, want), ents)
        _finite(f"{tag} sharded", [("scenario state", got[2].stack()),
                                   ("monthly means", got[3])])
        T = m.num.nstep_yr
        if launches and n != dict(zip(SLAB_ENTRIES, (2 * T * n_y * k
                                                     for k in launches))):
            raise AssertionError(f"{tag} {n_y} shards: launches {n}")
        for e in path or ():
            out["launches"][e] = ents[e]
        return got, secs, n, ents

    # -- 96x48 under the library default (the strict circulation), the
    #    full calendar on 2 and 4 shards; the 4-shard path's rate
    model = GREB(GrebConfig(numerics=Numerics(**SHARD_STRICT_YEARS)),
                 device="cuda", verbose=False)
    num = model.num
    T, nsub = num.nstep_yr, num.nsub_crcl
    if model.fold is not None or model.year_data.transport != "strict":
        raise AssertionError("the library default: not the strict transport")
    for n_y in SHARD_NY:
        path = n_y == SHARD_PATH_NY
        _, secs, n, ents = against(
            "96x48 strict circulation", model, n_y, (1, nsub, 1),
            STRICT_SLAB_ENTRIES[:3] if path else None, repeat=1 + path)
        if path:
            out["rate"] = 2 / secs
            print(f"sharded 96x48 strict circulation on {n_y} shards of the "
                  f"card (1 + 1 years, a step replayed from one CUDA graph, "
                  f"the second run on the same runners): {secs:.3f} s = "
                  f"{2 / secs:.3f} sim-yr/s (the fold's: step 19's); "
                  f"launches {ents}")
    tick("96x48 strict, full calendar")
    # -- the plain sharded strict version on 10 steps (eager, each shard's
    #    plain step in a thread; made during the build), and two gloo
    #    processes against one
    m10 = GREB(GrebConfig(numerics=Numerics(**SHARD_PLAIN_96)),
               device="cuda", verbose=False)
    plain = plain96
    if plain is None:
        plain, secs, n = _sharded_run(m10, SHARD_PATH_NY, plain=True,
                                      from0=True)
        if any(n.values()):
            raise AssertionError(f"the plain sharded version launched {n}")
        print(f"  the plain sharded strict version (eager): {secs:.1f} s "
              f"for 1 + 1 years of {m10.num.nstep_yr} steps")
    got10, _, _ = _sharded_run(m10, SHARD_PATH_NY, from0=True)
    ents = _slab_entry_launches()
    _finite("96x48 strict sharded (10 steps)",
            [("scenario state", got10[2].stack()),
             ("monthly means", got10[3])])
    check(f"96x48 strict {SHARD_PATH_NY} shards vs its plain sharded version "
          f"({m10.num.nstep_yr} steps)", _years_pairs(got10, plain), ents)
    path, child = workers
    check(f"96x48 strict {SHARD_PROCS} processes x "
          f"{SHARD_PATH_NY // SHARD_PROCS} shards (gloo, one card) vs one "
          f"process x {SHARD_PATH_NY} ({m10.num.nstep_yr} steps)",
          _years_pairs(torch.load(path, weights_only=False), got10), ents)
    print(f"  {SHARD_PROCS} processes (step 19's workers): the strict years "
          f"{', '.join('%.2f' % c['strict']['s'] for c in child)} s; "
          f"launches {[c['strict']['launches'] for c in child]}")
    del m10, got10, plain
    tick("plain sharded strict, two processes")
    # -- 2 members x 2 shards under the strict circulation against K4 -> K3
    short = GREB(GrebConfig(numerics=Numerics(**SHARD_SHORT)), device="cuda",
                 verbose=False)
    members = ens.perturbed_params(short.params,
                                   {"ct_sens": np.float32(SHARD_CT_SENS)})
    gotm, _, _ = _sharded_run(short, 2, members=members, n_ens=2)
    s5 = ens.ensemble_initial_state(members, short.forcing)
    pp = my.pack_member_params(members, "cuda")
    k4, corr = my.fluxcorr_years(s5, pp, 680.0, short.year_data)
    k3, _, asum = my.scenario_years(k4, pp, corr, np.float32([680.0]),
                                    short.year_data)
    check("2 members x 2 shards strict vs K4 -> K3 (M=2, 20 steps)",
          [("spin-up", gotm[0].stack(), k4.cpu()),
           ("scenario", gotm[2].stack(), k3.cpu())]
          + [(f"table {n}", getattr(gotm[1], n), corr[:, :, i].cpu())
             for i, n in enumerate(("tf", "tof", "qf"))]
          + [(f"annual mean {i}", a, b.cpu()) for i, (a, b) in enumerate(zip(
              gotm[4], core.annual_means(asum[:, 0].transpose(0, 1),
                                         short.num)))])
    _finite("strict members sharded", [("scenario state",
                                        gotm[2].stack())])
    del short, gotm, k4, k3, corr, asum
    tick("strict members")
    # -- the legacy words on SHARD_WORD_NY shards, 20 steps
    for e in SHARD_WORD_EXPS:
        mw = GREB(GrebConfig(numerics=Numerics(**SHARD_SHORT),
                             fast_circulation=True,
                             experiment=Experiment(e)), device="cuda",
                  verbose=False)
        k = 0 if mw.year_data.transport == "none" else 1
        _, _, _, ents = against(f"96x48 log_exp {e} ({mw.year_data.transport},"
                                f" flags {mw.year_data.flags:#05x})", mw,
                                SHARD_WORD_NY, (k, k * nsub, 1))
        print(f"  log_exp {e}: {ents}")
        del mw
    tick("legacy words")
    # -- 256x128 on 4 shards: the fold (the pole shards' additive packed
    #    form; step 20's 20-step model) and the strict circulation (the
    #    strict additive form; its 2-step model, from the initial state)
    n4 = SHARD_REFINED_NY
    against("256x128 fold", m256, n4, (1, m256.num.nsub_crcl, 1),
            STRICT_SLAB_ENTRIES[3:4])
    against("256x128 strict circulation", m256s, n4,
            (1, m256s.num.nsub_crcl, 1), STRICT_SLAB_ENTRIES[4:5],
            from0=True, graphs=False)
    # -- 384x192 strict on 4 shards (step 17's 2-step model)
    against("384x192 strict circulation", m384, n4,
            (1, m384.num.nsub_crcl, 1), STRICT_SLAB_ENTRIES[5:6],
            from0=True, graphs=False)
    tick("256x128, 384x192")

    # -- each new entry's launch on each shard (a CUDA graph of launches,
    #    CUDA events), its plain version on the pole shard (shard 0), its
    #    bound on the pole shard
    def timed(m, n_y, entries, plain_ms, shape):
        """Each of ``entries``' launch on ``m``'s n_y shards, its plain
        version's ``plain_ms`` and the pole shard's work."""
        ms = _slab_ms(m, n_y)
        R = m.num.ydim // n_y
        yd = m.year_data
        if m.fold is not None:
            splan, sconst = fc2.build_sharded(None, None, m.grid, m.st, 0,
                                              n_y, fold=m.fold)
            plan0 = splan.plans[0]
            ranks = (yk.packed_ranks(sconst.shards[0])[1]
                     if plan0.comp_mode == "packed" else None)
        else:
            plan0, ranks = slab.cut_strict(yd.plan, 0, R), None
        for e in entries:
            wrapper = ("slab_start" if e.startswith("slab_start") else
                       "slab_finish" if e.startswith("slab_finish") else
                       "slab_substep")
            out["ms"][e] = max(ms[e].values())
            out["plain_ms"][e] = plain_ms[e]
            out["work"][e] = slab.slab_work(plan0, m.num, wrapper,
                                            ranks=ranks, flags=yd.flags)
            out["shape"][e] = shape
            print(f"  {e}: a launch {out['ms'][e] * 1e3:.2f} us (the slowest"
                  f" shard; each shard's: "
                  f"{ {k: round(v * 1e3, 2) for k, v in ms[e].items()} } us),"
                  f" plain {plain_ms[e]:.3f} ms on shard 0")

    p96 = _strict_plain_ms(model, SHARD_PATH_NY)
    timed(model, SHARD_PATH_NY, STRICT_SLAB_ENTRIES[:3],
          {"slab_start_strict": p96["slab_start_strict"],
           "slab_strict<strict_cluster>": p96["slab_strict"],
           "slab_finish<legacy>": p96["slab_finish<legacy>"]},
          f"96x48 on {SHARD_PATH_NY} shards of the card, one shard's launch")
    p256, _ = _slab_plain_ms(m256, n4, shard=0)
    timed(m256, n4, STRICT_SLAB_ENTRIES[3:4],
          {"slab_substep<additive_packed>": p256["slab_substep"]},
          f"256x128 on {n4} shards, the pole shard's launch")
    p256s = _strict_plain_ms(m256s, n4, reps=3)
    timed(m256s, n4, STRICT_SLAB_ENTRIES[4:5],
          {"slab_strict<strict_additive>": p256s["slab_strict"]},
          f"256x128 on {n4} shards, the pole shard's launch")
    p384 = _strict_plain_ms(m384, n4, reps=1)
    timed(m384, n4, STRICT_SLAB_ENTRIES[5:6],
          {"slab_strict<strict>": p384["slab_strict"]},
          f"384x192 on {n4} shards, the pole shard's launch")
    tick("launches timed")
    del model
    gc.collect()
    torch.cuda.empty_cache()
    print(f"sharded words phase: {time.perf_counter() - t_phase:.1f} s")
    return out


# step 22: the host layer's wall limit [s]
HOST_PHASE_S = 10.0


def _host_layer_phase(tmp, model, smi, reset_counts, read_counts):
    """Step 22 (see the module docstring) on step 8's model ``model``."""
    import numpy as np
    import torch
    from greb_tpu_torch import analysis, plots
    from greb_tpu_torch.diag.memory import memory_report
    from greb_tpu_torch.diag.profiling import check_finite
    from greb_tpu_torch.io import binio
    from greb_tpu_torch.io.native_recordio import NativeRecordIO
    t_phase = time.perf_counter()
    m = _with_years(model, time_flux=1, time_scnr=2)
    m.cfg = dataclasses.replace(m.cfg, check_finite_every=1)
    num = m.num
    out = os.path.join(tmp, "host_scenario")
    reset_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    state, _, monthly, diags = m.run(output_path=out)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    read_counts("host layer run", {
        "fluxcorr_year": 1, "scenario_year": 2, "fluxcorr_years": 0,
        "scenario_years": 0})
    shape = (num.ydim, num.xdim)
    for i, var in enumerate(analysis.VARS):
        _, data = analysis.read_greb(out, var, num.xdim, num.ydim)
        if data.tobytes() != np.ascontiguousarray(
                monthly[:, :, i]).tobytes():
            raise AssertionError(f"read_greb {var}: not the run's monthly "
                                 f"means bit for bit")
    if not isinstance(binio._native, NativeRecordIO):
        raise AssertionError("the output file was not read natively")
    nat = binio.read_records(out, shape)
    if nat.tobytes() != binio._read_records_numpy(out, shape).tobytes():
        raise AssertionError("native and NumPy reads of the output differ")
    check_finite(state, name="state@end")
    bad = state.replace(ts=state.ts.clone())
    bad.ts[num.ydim // 2, 7] = float("nan")
    try:
        check_finite(bad, name="state@end")
    except FloatingPointError as e:
        if str(e) != "state@end.ts: 1 non-finite":
            raise AssertionError(f"check_finite said {e}")
    else:
        raise AssertionError("check_finite passed a NaN")
    # what save_all reads, on the card, through analysis._host: the
    # monthly means copied to the card, the run's diagnostics and the
    # model's forcing
    mon_dev = torch.as_tensor(monthly, device="cuda")
    f = m.forcing
    if f.z_topo.device.type != "cuda":
        raise AssertionError("the forcing is not on the card")
    for tag, t in ([("monthly", mon_dev), ("z_topo", f.z_topo),
                    ("uclim[0]", f.uclim[0]), ("vclim[0]", f.vclim[0])]
                   + [(f"diag {i} global_mean_ts", d.global_mean_ts)
                      for i, d in enumerate(diags)]):
        host = analysis._host(t)
        if not isinstance(host, np.ndarray) or \
                host.tobytes() != t.cpu().numpy().tobytes():
            raise AssertionError(f"_host({tag}) is not its host copy")
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        drawn = ("matplotlib is not installed here: save_all's inputs "
                 "checked through _host, no figure drawn")
    else:
        t0 = time.perf_counter()
        paths = plots.save_all(os.path.join(tmp, "host"), mon_dev,
                               diags=diags, forcing=f)
        names = [os.path.basename(p) for p in paths]
        if names != [f"host_{n}.png" for n in ("warming", "albedo_y1",
                                                "albedo_yN", "dtsurf",
                                                "mask", "wind")] \
                or min(os.path.getsize(p) for p in paths) < 2000:
            raise AssertionError(f"save_all wrote {names}")
        drawn = (f"{len(paths)} figures in "
                 f"{time.perf_counter() - t0:.1f} s")
    rep = memory_report(num)
    print(f"  {len(analysis.VARS)} variables read back bit for bit "
          f"(native = NumPy); check_finite on the end state and on one "
          f"NaN; {drawn}")
    print(f"  memory ({smi}): memory_report {rep.total} B resident "
          f"({num.xdim}x{num.ydim}, 1 member), "
          f"torch.cuda.max_memory_allocated over the "
          f"run {peak} B, with what this process held before it")
    seconds = time.perf_counter() - t_phase
    print(f"host layer phase: {seconds:.1f} s")
    if seconds > HOST_PHASE_S:
        raise AssertionError(f"step 22 took {seconds:.1f} s, over "
                             f"{HOST_PHASE_S} s")


# step 23: the strict transport at 768x384 (config 5's grid): the
# sequential strict form's wide variant (*_strict_wide), its pole rows'
# sub-cycle spread over the pole's cluster
# the library default, the strict legacy words, the no-transport words
S768_WORDS = (None, 7, 8, 16, 0, 1, 2, 3, 4)
S768_ROUNDS = (4, 8, 12, 16)   # the spread's rounds between exchanges, timed
S768_PATH = dict(ndays_yr=5, jday_mon=(3, 2), time_flux=1, time_scnr=1)
# the calendar of the first step held against the plain version: one-hour
# steps of 8 substeps (the sub-cycle counts follow dt_crcl: the same 6,612
# rounds a substep), so the plain step is 8 substeps, not 96
S768_PLAIN = dict(ndays_yr=1, jday_mon=(1,), dt=3600)
# the words whose first steps are held against the plain version there:
# the library default and a legacy strict word
S768_PLAIN_WORDS = (None, 16)
S768_LEGACY = dict(ndays_yr=5, jday_mon=(3, 2), time_flux=1, time_ctrl=1,
                   time_scnr=1)
S768_LEGACY_EXP = 16
S768_ENS_M = 2


class _GraphedSubcycle:
    """Between start and stop (or inside ``with``), stencils._subcycle, the
    polar sub-cycles' rounds of the strict transport's plain version,
    replays its rounds from a CUDA graph: in each call of at least 2 CHUNK
    rounds, CHUNK rounds of its body (the step, the clamp, the masked
    add; _subcycle's float32 operations) are captured once from static
    copies of the state and of the rounds' masks, and replayed for each
    whole CHUNK, the rest eager.  A graph launches the kernels the eager
    rounds launch, on the same values; the first such call also runs
    eager and must agree bit for bit.  At 768x384 the pole row's 6,612
    rounds a substep run over the whole grid (an extension-mode grid
    sub-cycles every row), ~160 s a step eager on the card's host."""
    CHUNK = 128

    def start(self):
        from greb_tpu_torch.ops import stencils
        self.stc, self.eager = stencils, stencils._subcycle
        self.checked = False
        stencils._subcycle = self._call
        return self

    def stop(self):
        self.stc._subcycle = self.eager

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    def _call(self, x0, itm, max_iter, step_fn):
        import torch
        n = self.CHUNK
        if max_iter < 2 * n:
            return self.eager(x0, itm, max_iter, step_fn)
        want = None if self.checked else self.eager(x0, itm, max_iter,
                                                    step_fn)
        t_in, m_in = x0.clone(), itm[:n].clone()

        def rounds(t, masks):
            for i in range(masks.shape[0]):
                d = step_fn(t)
                d = torch.where(d <= -t, -0.9 * t, d)
                t = torch.addcmul(t, d, masks[i])
            return t

        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = rounds(t_in, m_in)
        t1h = x0
        whole = max_iter // n * n
        for c in range(0, whole, n):
            t_in.copy_(t1h)
            m_in.copy_(itm[c:c + n])
            graph.replay()
            t1h = out.clone()
        t1h = rounds(t1h, itm[whole:max_iter])
        if want is not None:
            _bitwise("graphed polar sub-cycle vs eager",
                     [("rounds", t1h, want)], quiet=True)
            self.checked = True
        return t1h


def _plain_strict768(path) -> int:
    """The plain version that step 23 holds the strict wide kernels'
    first steps against, in a process of its own while the kernels build
    (no kernel of this package runs): at 768x384 on S768_PLAIN's calendar,
    under each word of S768_PLAIN_WORDS (the library default, log_exp 16),
    K1's first step from the initial state (its correction tables) and K2's
    from the initial state with zero tables at 680 ppm (its five output
    fields), which share the step's strict circulation (computed once, the
    second call held equal in its inputs), the sub-cycles' rounds replayed
    from CUDA graphs (_GraphedSubcycle).  Each word's two step calls are
    timed on the host's clock between two synchronizes: the plain first
    steps' ms, graph captures included.  ``python3 chip_smoke.py
    --plain-strict768 PATH``; prints the process's wall."""
    t_start = time.perf_counter()
    import numpy as np
    import torch
    from greb_tpu_torch.config import Numerics
    from greb_tpu_torch.model import core
    from greb_tpu_torch.ops import stencils
    eager, res = stencils.circulation, {}
    for e in S768_PLAIN_WORDS:
        m, _ = _refined_model(Numerics(**G768_GRID, **S768_PLAIN),
                              fast=None if e is None else True, log_exp=e)
        yd = m.year_data
        s0, fx = m.initial_state(), yd.sfx.at(0)
        co2 = np.float32(m.exp.co2_ctrl if m.exp.active else 340.0)
        seen = []

        def once(x, wz, **kw):
            for args, out in seen:
                if all(torch.equal(a, b) if torch.is_tensor(a) else a is b
                       or a == b for a, b in zip(args, (x, wz,
                                                        *kw.values()))):
                    return out.clone()
            out = eager(x, wz, **kw)
            seen.append(((x, wz, *kw.values()), out))
            return out

        stencils.circulation = once
        try:
            with _GraphedSubcycle():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                _, tabs = core.fluxcorr_step(s0, fx, co2, yd.md, yd.num,
                                             None, yd.exp)
                zero = tuple(torch.zeros_like(s0.ts) for _ in range(3))
                _, outs = core.scenario_step(s0, fx, zero, np.float32(680.0),
                                             yd.md, yd.num, None, yd.exp)
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1e3
        finally:
            stencils.circulation = eager
        if len(seen) != 1:
            raise AssertionError(f"log_exp {e}: K1's and K2's first steps "
                                 f"made {len(seen)} circulations, not one")
        res[e] = dict(tables=torch.stack(tabs),
                      outs=torch.stack(outs[:core.N_OUT]), ms=ms)
        del m, yd, seen
    torch.save(res, path)
    print(json.dumps({"s": time.perf_counter() - t_start, "launches": {}}))
    return 0


def _strict768_phase(tmp, reset_counts, read_counts, plain):
    """Step 23 (see the module docstring); ``plain``: _plain_strict768's
    first steps.  Returns the worst max |diff| per kernel, the launches'
    and plain versions' times and work, the paths' launches and rates."""
    import contextlib
    import gc
    import io

    import numpy as np
    import torch
    from greb_tpu_torch import __main__ as cli
    from greb_tpu_torch.config import Numerics
    from greb_tpu_torch.forcing import Corrections, ModelState
    from greb_tpu_torch.io.binio import read_output, read_records
    from greb_tpu_torch.model import core, longrun
    from greb_tpu_torch.ops.cuda import multiyear as my
    from greb_tpu_torch.ops.cuda import year_kernel as yk

    t_phase = time.perf_counter()
    kernels = ("fluxcorr_year", "scenario_year", "fluxcorr_years",
               "scenario_years")
    err = dict.fromkeys(kernels, 0.0)
    out = dict(ms={}, work={}, launches={}, rate={})
    short = Numerics(**G768_GRID, **G768_SHORT)
    full = Numerics(**G768_GRID)
    n = short.nstep_yr
    co2f, co2s = np.float32(340.0), np.float32(680.0)
    zero = Corrections.zeros(n, short.ydim, short.xdim, device="cuda")
    names = []
    for e in S768_WORDS:
        t0 = time.perf_counter()
        m, _ = _refined_model(short, fast=None if e is None else True,
                              log_exp=e)
        yd, plan = m.year_data, m.year_data.plan
        word = "library default" if e is None else f"log_exp {e}"
        tag = f"strict768 {word} (flags {yd.flags:#05x})"
        groups = yk.refined_groups(plan)
        if not (isinstance(plan, yk.StrictPlan) and plan.seq_zonal
                and groups > 1):
            raise AssertionError(f"{tag}: not the strict wide form: {plan}")
        names += [_pick_check(tag, k, yd) for k in kernels]
        if e is None:
            # the wide strict block: the kernel's reckoning against
            # strict_wide_layout, the spread's groups, the clusters at once
            H, W = yk.spread_layout(plan, 16, groups)
            for kind in yk.KINDS:
                lay = yk.block_layout(plan, 16, kind)
                parts, threads = yk.kernel_cluster_layout(plan, 16, kind)
                if parts != dict(lay.parts) or threads != lay.threads:
                    raise AssertionError(
                        f"{tag} {kind}: kernel layout {parts}, {threads} "
                        f"threads; strict_wide_layout {dict(lay.parts)}")
                cap = yk.cluster_capacity(plan, 16, kind)
                print(f"strict768 {kind:<14s}: {groups} clusters of 16 "
                      f"blocks a run, {lay.rows} rows/block, {lay.threads} "
                      f"threads, {lay.nbytes} B shared memory a block, {cap} "
                      f"clusters at once; kernel and strict_wide_layout "
                      f"agree: {dict(lay.parts)}")
            nd, na = plan.sub_cycles
            print(f"  sub-cycles from each pole: diffusion {nd[:6]}, "
                  f"advection {na[:4]}; {n}-step calendar, "
                  f"{short.nsub_crcl} substeps; the pole rows spread over "
                  f"{H} blocks of {W} columns, "
                  f"{yk.spread_rounds(plan, 16, groups)} rounds between "
                  f"exchanges")
        co2 = np.float32(m.exp.co2_ctrl if m.exp.active else co2f)
        s0 = m.initial_state()
        k1_fn = lambda: yk.fluxcorr_year(s0, co2, yd)
        k2_fn = lambda: yk.scenario_year(s0, zero, co2s, yd)
        if e is None:
            # timed after a warm-up launch (the run's set-up)
            (ms1,), k1 = _launches_ms(k1_fn, 1)
            (ms2,), k2 = _launches_ms(k2_fn, 1)
        else:
            ms1, k1 = _time_ms(k1_fn, 1)
            ms2, k2 = _time_ms(k2_fn, 1)
        _finite(f"K1 {tag}", [("state", k1[0].stack()), ("tf", k1[1].tf)])
        _finite(f"K2 {tag}", [("state", k2[0].stack()), ("outs", k2[1])])
        if e in plain:
            # the first step of each against the plain version (made in a
            # process of its own during the build), on S768_PLAIN's
            # calendar of one-hour steps, 8 substeps a step; under the
            # library default both launches there timed (a year of
            # S768_PLAIN's steps each)
            num_p = Numerics(**G768_GRID, **S768_PLAIN)
            mp, _ = _refined_model(num_p, fast=None if e is None else True,
                                   log_exp=e)
            ydp, sp0 = mp.year_data, mp.initial_state()
            zp = Corrections.zeros(num_p.nstep_yr, num_p.ydim, num_p.xdim,
                                   device="cuda")
            # each timed after a warm-up launch (the run's set-up)
            (ms1p,), k1p = _launches_ms(
                lambda: yk.fluxcorr_year(sp0, co2, ydp), 1)
            (ms2p,), k2p = _launches_ms(
                lambda: yk.scenario_year(sp0, zp, co2s, ydp), 1)
            tabs = torch.stack([k1p[1].tf[0], k1p[1].tof[0], k1p[1].qf[0]])
            err["fluxcorr_year"] = max(err["fluxcorr_year"], _bitwise(
                f"K1 {tag}, its first step's tables ({num_p.nsub_crcl} "
                f"substeps)", [("tables", tabs, plain[e]["tables"])],
                quiet=True))
            err["scenario_year"] = max(err["scenario_year"], _bitwise(
                f"K2 {tag}, its first step's outputs ({num_p.nsub_crcl} "
                f"substeps)", [("outs", k2p[1][0], plain[e]["outs"])],
                quiet=True))
            print(f"  {tag} on {num_p.nstep_yr} one-hour steps of "
                  f"{num_p.nsub_crcl} substeps: K1 {ms1p:.1f} ms, K2 "
                  f"{ms2p:.1f} ms a year; the plain first steps of K1 and "
                  f"K2 (one circulation) {plain[e]['ms']:.1f} ms")
            if e is None:
                out["ms_1h"] = dict(fluxcorr_year=ms1p, scenario_year=ms2p)
                out["work_1h"] = {
                    k: yk.year_work(ydp.plan, num_p, k == "scenario_year",
                                    flags=ydp.flags)
                    for k in ("fluxcorr_year", "scenario_year")}
                out["plain_ms_1h_first_steps"] = plain[e]["ms"]
            del mp, ydp, k1p, k2p
        if e is None:
            out["ms"] = dict(fluxcorr_year=ms1, scenario_year=ms2)
            # the work of the launches timed (a year of the short
            # calendar) and of a full year (the year reckoned, printed)
            out["short_work"], out["work"] = (
                {k: yk.year_work(plan, cal, k == "scenario_year",
                                 flags=yd.flags)
                 for k in ("fluxcorr_year", "scenario_year")}
                for cal in (short, full))
            # the spread's rounds between exchanges: K2 timed at each,
            # bitwise equal to the default's year
            for k in S768_ROUNDS:
                ydk = yk._forced(yd, rounds=k)
                (ms,), got = _launches_ms(lambda: yk.scenario_year(
                    s0, zero, co2s, ydk), 1)
                _bitwise(f"K2 {tag} at {k} rounds between exchanges",
                         [("outs", got[1], k2[1])], quiet=True)
                print(f"  K2 {n} steps at k={k}: {ms:.3f} ms, "
                      f"{ms * 1e3 / (n * short.nsub_crcl * nd[0]):.4f} us "
                      f"a pole round (the whole substep over the pole "
                      f"row's rounds)")
                del ydk, got
        elif yd.transport == "none":
            # no transport: the plain year is cheap, held in full
            err["fluxcorr_year"] = max(err["fluxcorr_year"], _k1_vs_plain(
                f"K1 {tag}", s0, co2, yd, k1))
            err["scenario_year"] = max(err["scenario_year"], _k2_vs_plain(
                f"K2 {tag}", s0, zero, co2s, yd, k2))
        ms_m, m_err = _time_ms(lambda: _single_members(
            m, tag, co2, co2s, k1, k2, (s0, zero)), 1)
        for name, v in m_err.items():
            err[name] = max(err[name], v)
        if e is None:
            out["ms"]["members_m1"] = ms_m
        print(f"  {tag}: K1 {ms1:.1f} ms, K2 {ms2:.1f} ms ({n} steps); "
              f"{time.perf_counter() - t0:.1f} s")
        del m, yd, k1, k2
    print(f"  {', '.join(sorted(set(names)))}")
    ms2 = out["ms"]["scenario_year"]
    b_ms, b_by = _bound_of(*out["work"]["scenario_year"])
    print(f"strict768 scenario_year: {ms2 / n:.3f} ms a step (timed on {n} "
          f"steps) x {full.nstep_yr} = {ms2 / n * full.nstep_yr:.1f} ms a "
          f"year, reckoned, not timed; bound {b_ms:.3f} ms a year by {b_by},"
          f" {ms2 / n * full.nstep_yr / b_ms:.0f}x")

    # -- config 5's long run under the library default: run_long in K3
    #    blocks from the initial state with zero tables, a checkpoint after
    #    each; stopped at G768_STOP and resumed in a fresh process beside
    #    the paths below; final state and output file bitwise equal
    m, _ = _refined_model(short, fast=None)
    s0 = m.initial_state()
    co2_long = np.full(G768_LONG, 680.0, np.float32)
    ck_full, run_full = _grid768_runner(m, tmp, "strict_full")
    reset_counts()
    s_full, _, _ = longrun.run_long(G768_LONG, s0, zero, co2_long, run_full,
                                    checkpointer=ck_full,
                                    chunk_years=G768_BLOCK)
    run_full.close()
    out["launches"]["long"] = read_counts("strict768 long run", {
        "fluxcorr_year": 0, "scenario_year": 0, "fluxcorr_years": 0,
        "scenario_years": G768_LONG // G768_BLOCK})
    _finite("strict768 long run", [(f"state {k}", getattr(s_full, k))
                                   for k in ModelState.FIELDS])
    ck_res, run_res = _grid768_runner(m, tmp, "strict_resumed")
    longrun.run_long(G768_STOP, s0, zero, co2_long, run_res,
                     checkpointer=ck_res, chunk_years=G768_BLOCK)
    run_res.close()
    torch.cuda.synchronize()
    del m
    t1 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--resume-long768", tmp,
         "strict"], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        # -- GREB.run (the library default, 1 + 1 years) on S768_PATH's
        #    10 steps, where a scenario year after a spin-up stays finite
        num = Numerics(**G768_GRID, **S768_PATH)
        path = os.path.join(tmp, "strict768", "scenario")
        m, _ = _refined_model(num, path, fast=None)
        reset_counts()
        _, wall = _synced_s(lambda: m.run(output_path=path))
        out["launches"]["path"] = read_counts("strict768 GREB.run", {
            "fluxcorr_year": num.time_flux, "scenario_year": num.time_scnr,
            "fluxcorr_years": 0, "scenario_years": 0})
        back = read_output(path, num.xdim, num.ydim)
        if back.shape != (num.time_scnr * len(num.jday_mon), 5, num.ydim,
                          num.xdim) or not np.isfinite(back).all():
            raise AssertionError(f"strict768 GREB.run output {back.shape}")
        years = num.time_flux + num.time_scnr
        out["rate"]["path"] = years / wall
        print(f"strict768 GREB.run (the library default, {years} years of "
              f"{num.nstep_yr} steps): {wall:.3f} s = {years / wall:.4f} "
              f"sim-yr/s; the output file read back finite")

        # -- run_members through the CLI's --ensemble: K4 spin-ups, K3,
        #    one member a launch
        path = os.path.join(tmp, "strict768_ens", "member")
        os.makedirs(os.path.dirname(path))
        args = cli.build_parser().parse_args(["--ensemble", str(S768_ENS_M),
                                              "--quiet"])
        per = yk.check_resident(yk.refined_groups(m.year_data.plan),
                                yk.wide_capacity(m.year_data, "fluxcorr"),
                                S768_ENS_M)
        reset_counts()
        _, wall = _synced_s(lambda: cli.run_ensemble(m, path, args))
        chunks = -(-S768_ENS_M // per)
        out["launches"]["ensemble"] = read_counts(
            f"strict768 ensemble path (M={S768_ENS_M})", {
                "fluxcorr_year": 0, "scenario_year": 0,
                "fluxcorr_years": num.time_flux * chunks,
                "scenario_years": chunks})
        nbytes = _read_members(path, S768_ENS_M, num)
        print(f"strict768 ensemble path (--ensemble {S768_ENS_M}): "
              f"{wall:.3f} s; {S768_ENS_M} files, {nbytes} B, read back "
              f"finite, the members differ")
        del m

        # -- run_legacy at log_exp 16: spin-up, a control year, a
        #    scenario year; both files read back finite
        num = Numerics(**G768_GRID, **S768_LEGACY)
        path = os.path.join(tmp, "strict768_legacy", "scenario")
        os.makedirs(os.path.dirname(path))
        m, _ = _refined_model(num, path, fast=True, log_exp=S768_LEGACY_EXP)
        reset_counts()
        with contextlib.redirect_stdout(io.StringIO()):
            _, wall = _synced_s(lambda: cli.run_legacy(m, path))
        out["launches"]["legacy"] = read_counts(
            f"strict768 legacy path (log_exp {S768_LEGACY_EXP})", {
                "fluxcorr_year": num.time_flux,
                "scenario_year": num.time_ctrl + num.time_scnr,
                "fluxcorr_years": 0, "scenario_years": 0})
        Y, X = num.ydim, num.xdim
        ctl = read_records(os.path.join(os.path.dirname(path), "control"),
                           (Y, X))
        back = read_output(path, X, Y)
        if ctl.shape[0] != num.nstep_yr or not np.isfinite(ctl).all() \
                or not np.isfinite(back).all():
            raise AssertionError(f"strict768 legacy files: control "
                                 f"{ctl.shape}, scenario {back.shape}")
        print(f"strict768 legacy path (run_legacy, log_exp "
              f"{S768_LEGACY_EXP}): {wall:.3f} s; control file "
              f"{ctl.shape[0]} records, scenario {back.shape[0]} months, "
              f"finite")
        del m

        o, e = proc.communicate(timeout=600)
        wall_resume = time.perf_counter() - t1
        if proc.returncode != 0:
            print(o[-4000:], e[-4000:], file=sys.stderr)
            raise AssertionError(f"strict768 resume exited "
                                 f"{proc.returncode}")
        child = json.loads(o.strip().splitlines()[-1])
        if child["start"] != G768_STOP:
            raise AssertionError(f"strict768 resumed at {child['start']}")
        s_res, _, _ = type(ck_res)(ck_res.dir).restore(device="cuda")
        _bitwise("strict768 resumed vs uninterrupted", [
            (f"state {k}", getattr(s_res, k), getattr(s_full, k))
            for k in ModelState.FIELDS], quiet=True)
        with open(os.path.join(tmp, "long768_strict_full"), "rb") as f, \
                open(os.path.join(tmp, "long768_strict_resumed"), "rb") as g:
            if f.read() != g.read():
                raise AssertionError("strict768 resumed output differs")
        print(f"strict768 long run ({G768_LONG} years in K3 blocks of "
              f"{G768_BLOCK}): stopped at {G768_STOP}, resumed in a fresh "
              f"process ({wall_resume:.1f} s wall beside the paths, set-up "
              f"{child['setup_s']:.1f} s, years {child['run_s']:.3f} s); "
              f"final state and output file bitwise equal")
    finally:
        if proc.poll() is None:
            proc.kill()
    del s_full
    gc.collect()
    torch.cuda.empty_cache()
    out["err"] = err
    print(f"strict768 phase: {time.perf_counter() - t_phase:.1f} s")
    return out


def main(argv) -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "runs on a CUDA card", file=sys.stderr)
        return 1
    if argv[:1] == ["--resume-long"]:
        return _resume_long(argv[1])
    if argv[:1] == ["--resume-long768"]:
        return _resume_long768(argv[1], argv[2:] == ["strict"])
    if argv[:1] == ["--shard-worker"]:
        return _shard_worker(argv[1:])
    if argv[:1] == ["--resume-long256"]:
        return _resume_long256(argv[1])
    if argv[:1] == ["--plain-strict"]:
        return _plain_strict(argv[1])
    if argv[:1] == ["--plain-strict768"]:
        return _plain_strict768(argv[1])
    steps = ALL_STEPS
    if argv[:1] == ["--phases"]:
        steps = _phases(argv[1])
    elif argv:
        print(f"chip_smoke: unknown arguments {argv}", file=sys.stderr)
        return 2
    want = steps.__contains__
    import math

    import numpy as np

    from greb_tpu_torch.config import Diagnostics, GrebConfig, Numerics
    from greb_tpu_torch.forcing import ModelState
    from greb_tpu_torch.io.binio import read_output
    from greb_tpu_torch.io.checkpoint import Checkpointer
    from greb_tpu_torch.model import core, longrun
    from greb_tpu_torch.model.driver import GREB
    from greb_tpu_torch.ops.cuda import build
    from greb_tpu_torch.ops.cuda import multiyear as my
    from greb_tpu_torch.ops.cuda import year_kernel as yk
    from greb_tpu_torch.parallel import ensemble as ens

    counters = {"fluxcorr_year": yk.fluxcorr_year,
                "scenario_year": yk.scenario_year,
                "fluxcorr_years": my.fluxcorr_years,
                "scenario_years": my.scenario_years,
                "fluxcorr_years_mxu": my.fluxcorr_years_mxu,
                "scenario_years_mxu": my.scenario_years_mxu}

    def reset_counts():
        for fn in counters.values():
            fn.launches = 0

    def read_counts(path, want):
        """Every counter against ``want`` (a counter it does not name: 0)."""
        want = {k: want.get(k, 0) for k in counters}
        got = {k: fn.launches for k, fn in counters.items()}
        print(f"  {path} launches: {got}")
        if got != want:
            raise AssertionError(f"{path}: launch counts {got}, want {want}")
        return got

    t_start = time.perf_counter()
    t_lap = [t_start]

    def lap(phase):
        """Print the wall time since the last phase ended."""
        now = time.perf_counter()
        print(f"phase {phase}: {now - t_lap[0]:.1f} s wall")
        t_lap[0] = now

    if steps != ALL_STEPS:
        print(f"steps {_spec(steps)} (with the steps they need)")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")

    with tempfile.TemporaryDirectory(dir=ROOT, prefix="_smoke_") as tmp:
        # -- build, while the host makes the set-up later phases share ----
        from concurrent.futures import ThreadPoolExecutor
        t0 = time.perf_counter()
        with ThreadPoolExecutor(1) as pool:
            job = pool.submit(build.build_all)
            # the plain versions that steps 21 and 23 hold their kernels
            # against, each in a process of its own (no kernel of this
            # package runs there)
            children = {}
            for step, flag in ((21, "--plain-strict"),
                               (23, "--plain-strict768")):
                if want(step):
                    path = os.path.join(tmp, flag[2:] + ".pt")
                    children[step] = (flag, path, subprocess.Popen(
                        [sys.executable, os.path.abspath(__file__), flag,
                         path], stdout=subprocess.PIPE,
                        stderr=subprocess.PIPE, text=True, cwd=ROOT))
            try:
                took, m768 = _prebuild(tmp, want)
                built = job.result()
                got = {step: _child_result(*child)
                       for step, child in children.items()}
            finally:
                for _, _, proc in children.values():
                    if proc.poll() is None:
                        proc.kill()
            if 21 in got:
                plain96, secs = got[21]
                took["plain sharded strict 96x48, 10 steps (a process of "
                     "its own)"] = secs
            if 23 in got:
                plain768, plain768_s = got[23]
                took["plain strict 768x384 first steps (a process of its "
                     "own)"] = plain768_s
        each = ", ".join(f"{k}.cu {v:.1f} s" for k, v in built.items())
        print(f"build: {time.perf_counter() - t0:.1f} s ({each or 'cached'});"
              f" meanwhile on the host: "
              + ", ".join(f"{k} {v:.1f} s" for k, v in took.items()))
        for source in ("year_kernel", "refined_kernel", "band_kernel",
                       "strict_wide_kernel", "members_kernel",
                       "slab_kernel"):
            with open(os.path.join(build.BUILD_DIR,
                                   f"{source}.ptxas.txt")) as f:
                for line in f:
                    if "Compiling entry function" in line:
                        print("  ptxas:", line.split("'")[1])
                    elif "registers" in line or "spill" in line:
                        print("  ptxas:   ", line.split(":", 1)[-1].strip())
        lap("build")

        out_path = os.path.join(tmp, "scenario")
        num = Numerics(time_flux=3, time_scnr=10)
        cfg = GrebConfig(numerics=num,
                         diagnostics=Diagnostics(output_file=out_path),
                         fast_circulation=True)
        model = GREB(cfg, device="cuda")
        yd, plan = model.year_data, model.fold[0]
        print(f"96x48: {num.nstep_yr} steps/yr, {num.nsub_crcl} substeps, "
              f"plan {plan}")

        # -- a cluster block's shared memory: the kernel's own reckoning
        #    against cluster_layout, for each kind at each size it offers,
        #    and how many such clusters the card runs at once
        C = yk.DEFAULT_CLUSTER
        capacity = {}
        for kind in yk.KINDS:
            for c in yk.CLUSTER_SIZES[kind]:
                lay = yk.cluster_layout(plan, c, kind)
                parts, threads = yk.kernel_cluster_layout(plan, c, kind)
                if parts != dict(lay.parts) or threads != lay.threads:
                    raise AssertionError(
                        f"{kind} C={c}: kernel layout {parts}, {threads} "
                        f"threads; cluster_layout {dict(lay.parts)}, "
                        f"{lay.threads}")
                capacity[kind, c] = yk.cluster_capacity(plan, c, kind)
                print(f"cluster {kind:<14s} C={c:2d}: {lay.rows} rows/block, "
                      f"{lay.threads} threads, {lay.nbytes} B shared memory "
                      f"a block, {capacity[kind, c]} clusters at once; "
                      f"kernel and cluster_layout agree: {dict(lay.parts)}")
        print(f"the single-run wrappers' default: clusters of C={C} blocks")

        if want(3):
            # -- K1: spin-up year kernel vs its plain version --------------------
            #    (the plain years below replay their steps from CUDA graphs)
            s0 = model.initial_state()
            co2f = np.float32(cfg.co2.co2_flux)
            graphed = _GraphedSteps().start()
            graphed.check(model, co2f)
            (s_k, c_k) = yk.fluxcorr_year(s0, co2f, yd)        # first launch
            ms_k1, (s_k, c_k) = _time_ms(lambda: yk.fluxcorr_year(s0, co2f, yd), 2)
            plain_k1, (s_p, c_p) = _time_ms(
                lambda: yk.fluxcorr_year_plain(s0, co2f, yd), 1)
            print(f"K1 fluxcorr_year (C={C}): kernel {ms_k1:.2f} ms/launch, "
                  f"plain {plain_k1:.1f} ms/year")
            err_k1 = _bitwise("K1", [(f"state {n}", getattr(s_k, n), getattr(s_p, n))
                                     for n in ModelState.FIELDS]
                              + [(f"table {n}", getattr(c_k, n), getattr(c_p, n))
                                 for n in ("tf", "tof", "qf")])

            # -- K2: scenario year kernel vs its plain version -------------------
            co2s = np.float32(680.0)
            s_k2, o_k, a_k = yk.scenario_year(s_p, c_p, co2s, yd)
            ms_k2, (s_k2, o_k, a_k) = _time_ms(
                lambda: yk.scenario_year(s_p, c_p, co2s, yd), 2)
            plain_k2, (s_p2, o_p, a_p) = _time_ms(
                lambda: yk.scenario_year_plain(s_p, c_p, co2s, yd), 1)
            print(f"K2 scenario_year (C={C}): kernel {ms_k2:.2f} ms/launch, "
                  f"plain {plain_k2:.1f} ms/year")

            def k2_pairs(s, o, a):
                return ([(f"state {n}", getattr(s, n), getattr(s_p2, n))
                         for n in ModelState.FIELDS]
                        + [("outs", o, o_p), ("annual sums", a, a_p)])

            err_k2 = _bitwise("K2", k2_pairs(s_k2, o_k, a_k))
            _bitwise("K2", [("monthly means", core.monthly_means(model.month_mat, o_k),
                             core.monthly_means(model.month_mat, o_p))])

            # -- K2 against K3 and K1 against K4 at M=1 with the base params, at
            #    every size the member kernel offers: the cluster body and the
            #    per-cell device functions are shared, so the year must agree
            #    bitwise
            pp_base = my.pack_member_params([model.params], "cuda")
            corr_base = torch.stack([c_p.tf, c_p.tof, c_p.qf], dim=1)[None]
            for c in yk.offered_sizes("scenario_years"):
                s3_1, _, a3_1 = my.scenario_years(
                    s_p.stack()[:, None], pp_base, corr_base,
                    np.asarray([co2s]), yd, cluster=c)
                _bitwise(f"K2 vs K3 (M=1, C={c})",
                         [("state", s_k2.stack(), s3_1[:, 0]),
                          ("annual sums", a_k, a3_1[0, 0])])
            for c in yk.offered_sizes("fluxcorr"):
                s4_1, c4_1 = my.fluxcorr_years(s0.stack()[:, None], pp_base, co2f,
                                               yd, cluster=c)
                _bitwise(f"K1 vs K4 (M=1, C={c})",
                         [("state", s_k.stack(), s4_1[:, 0])]
                         + [(f"table {n}", getattr(c_k, n), c4_1[0, :, i])
                            for i, n in enumerate(("tf", "tof", "qf"))])
            del s3_1, a3_1, s4_1, c4_1

            # -- cluster-size sweep of K2, and where a launch's time goes: the
            #    same year with one substep per step splits substep time from
            #    per-step time
            one = yk.YearData(md=yd.md, sfx=yd.sfx, fold=yd.fold,
                              num=dataclasses.replace(num, dt_crcl=num.dt))
            sweep = {}
            for c in yk.CLUSTER_SIZES["scenario"]:
                yk.scenario_year(s_p, c_p, co2s, yd, cluster=c)
                ms_c, (s_c, o_c, a_c) = _time_ms(
                    lambda: yk.scenario_year(s_p, c_p, co2s, yd, cluster=c), 2)
                _bitwise(f"K2 C={c}", k2_pairs(s_c, o_c, a_c))
                yk.scenario_year(s_p, c_p, co2s, one, cluster=c)
                ms_one, _ = _time_ms(
                    lambda: yk.scenario_year(s_p, c_p, co2s, one, cluster=c), 2)
                us_sub = (ms_c - ms_one) * 1e3 / (num.nstep_yr * (num.nsub_crcl - 1))
                sweep[c] = ms_c
                print(f"K2 sweep C={c:2d}: {ms_c:.3f} ms/launch; "
                      f"{ms_one:.3f} ms/launch at 1 substep/step -> "
                      f"{us_sub:.3f} us per substep, "
                      f"{ms_one * 1e3 / num.nstep_yr - us_sub:.3f} us per step "
                      f"outside the substeps")
            best = min(sweep, key=sweep.get)
            print(f"K2 sweep: fastest C={best} ({sweep[best]:.3f} ms); the "
                  f"wrappers' default is C={C}")
            del s_c, o_c, a_c
            # a timing probe, not the model: the same year on a plan without
            # the pole composite rows shows what they add to a substep (the
            # two pole blocks' extra phases, which every block waits for)
            bare = dataclasses.replace(plan, comp_mode="none", comp_kt=0,
                                       comp_kb=0)
            ms_bare = []
            for n in (num, one.num):
                ydb = yk.YearData(md=yd.md, sfx=yd.sfx, fold=(bare, yd.fold[1]),
                                  num=n)
                yk.scenario_year(s_p, c_p, co2s, ydb)
                ms_bare.append(_time_ms(
                    lambda: yk.scenario_year(s_p, c_p, co2s, ydb), 2)[0])
            us_bare = (ms_bare[0] - ms_bare[1]) * 1e3 / (
                num.nstep_yr * (num.nsub_crcl - 1))
            print(f"K2 C={C} without pole composites (timing probe): "
                  f"{ms_bare[0]:.3f} ms/launch, {ms_bare[1]:.3f} at 1 substep/step "
                  f"-> {us_bare:.3f} us per substep")
            # ... and what one cluster barrier costs, with the release the
            # kernels need (the pushed halo rows) and, for comparison, relaxed
            _barrier_costs(build, {
                c: yk.cluster_layout(plan, c, "scenario").threads
                for c in yk.CLUSTER_SIZES["scenario"]})
            lap("96x48 K1, K2, sweep and probes")

            # -- K4: member-batched spin-up year vs its plain version at the
            #    member chain's shape, at every size it offers: M=3 members,
            #    ct_sens -2%, base, +2%
            path_in = _path_shape_inputs(model, s_p, c_p)
            s5_0, pp3, _, _ = path_in["fluxcorr_years"]
            plain_k4, (s4_p, c4_p) = _time_ms(
                lambda: my.fluxcorr_years_plain(*path_in["fluxcorr_years"]), 1)
            print(f"K4 fluxcorr_years plain (M=3): {plain_k4:.1f} ms")
            err_k4 = 0.0
            for c in yk.offered_sizes("fluxcorr"):
                s4_k, c4_k = my.fluxcorr_years(s5_0, pp3, co2f, yd, cluster=c)
                if torch.equal(s4_k[:, 0], s4_k[:, 2]):
                    raise AssertionError("K4: the perturbed members did not "
                                         "differ")
                err_k4 = max(err_k4, _bitwise(f"K4 C={c}", [
                    ("state", s4_k, s4_p), ("tables", c4_k, c4_p)]))
            del s4_k, c4_k

            # -- K3: multi-year scenario block vs its plain version, at every
            #    size it offers; M=2, K4's two perturbed members, for two years
            #    at CO2 560 and 680 (its month and year boundaries)
            two = [0, 2]
            pp2, s3_in, c3_in = pp3[two], s4_p[:, two], c4_p[two]
            co2y = np.asarray([560.0, 680.0], np.float32)
            plain_k3_m2, (s3_p, m3_p, a3_p) = _time_ms(
                lambda: my.scenario_years_plain(s3_in, pp2, c3_in, co2y, yd), 1)
            print(f"K3 scenario_years plain (M=2, 2 years): {plain_k3_m2:.1f} ms")
            err_k3 = 0.0
            for c in yk.offered_sizes("scenario_years"):
                s3_k, m3_k, a3_k = my.scenario_years(s3_in, pp2, c3_in, co2y,
                                                     yd, cluster=c)
                if torch.equal(m3_k[0], m3_k[1]):
                    raise AssertionError("K3: the two members did not differ")
                err_k3 = max(err_k3, _bitwise(f"K3 C={c}", [
                    ("state", s3_k, s3_p), ("monthly means", m3_k, m3_p),
                    ("annual sums", a3_k, a3_p)]))
            del s3_k, m3_k, a3_k, s3_p, m3_p, a3_p

            # -- both member kernels at the shapes their paths launch, each
            #    timed launch held bitwise against its plain version on the same
            #    inputs (K4's plain version is step 5's)
            member_ms, member_out = _time_member_kernels(path_in)
            err_k4 = max(err_k4, _bitwise("K4 timed (M=3)", [
                ("state", member_out["fluxcorr_years"][0], s4_p),
                ("tables", member_out["fluxcorr_years"][1], c4_p)]))
            plain_k3, k3_p = _time_ms(
                lambda: my.scenario_years_plain(*path_in["scenario_years"]), 1)
            print(f"K3 scenario_years plain (M=1, {LONG_BLOCK} years): "
                  f"{plain_k3:.1f} ms")
            err_k3 = max(err_k3, _bitwise(
                f"K3 timed (M=1 x {LONG_BLOCK} years)",
                zip(("state", "monthly means", "annual sums"),
                    member_out["scenario_years"], k3_p)))
            del member_out, k3_p
            graphed.stop()
            lap("96x48 K4, K3 and their timed launches")

            # -- member scaling: one year of each member kernel at M = 1 .. 132
            #    on each size it offers (clusters beyond the card's capacity run
            #    in waves; one block a member is one SM), against the size the
            #    wrappers pick by default
            for M in SCALING_M:
                pp = my.pack_member_params(ens.perturbed_params(
                    model.params, {"ct_sens": np.linspace(22.05, 22.95, M)}),
                    "cuda")
                s5m = s4_p[:, :1].repeat(1, M, 1, 1)
                cpm = c4_p[:1].expand(M, -1, -1, -1, -1).contiguous()
                for kind in my.KINDS:
                    got = {}
                    for c in yk.offered_sizes(kind):
                        if kind == "fluxcorr":
                            def run():
                                return my.fluxcorr_years(s5m, pp, co2f, yd,
                                                         cluster=c)
                        else:
                            def run():
                                return my.scenario_years(s5m, pp, cpm, co2y[:1],
                                                         yd, cluster=c)
                        run()
                        got[c], _ = _time_ms(run, 1)
                        cap = 132 if c == 1 else capacity[kind, c]
                        print(f"member scaling {kind:<14s} C={c:2d} M={M:3d}: "
                              f"{got[c]:.3f} ms (1 year) = "
                              f"{M / got[c] * 1e3:.3f} member-yr/s; {cap} at "
                              f"once, {math.ceil(M / cap)} wave(s)")
                    best = min(got, key=got.get)
                    pick = my.default_cluster(kind, M, capacity[kind, C])
                    print(f"member scaling {kind:<14s} M={M:3d}: fastest C={best}"
                          f", default C={pick} ({got[pick] / got[best]:.3f}x the "
                          f"fastest)")
                del pp, s5m, cpm
            torch.cuda.empty_cache()
            lap("member scaling")

        if want(8):
            # -- the main path: GREB.run, 3 spin-up + 10 scenario years, run
            #    MAIN_RUNS times, the counts reset and read around each run ------
            walls = []
            for _ in range(MAIN_RUNS):
                reset_counts()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                state, corr, monthly, diags = model.run(output_path=out_path)
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
                launches = read_counts("main path", {
                    "fluxcorr_year": num.time_flux,
                    "scenario_year": num.time_scnr,
                    "fluxcorr_years": 0, "scenario_years": 0})
            years = num.time_flux + num.time_scnr
            rates = [years / w for w in walls]
            wall = _median(walls[1:])
            kern = (num.time_flux * ms_k1 + num.time_scnr * ms_k2) / 1e3
            print(f"main path: {years} sim-years, {MAIN_RUNS} runs: "
                  f"{' '.join(f'{r:.3f}' for r in rates)} sim-yr/s; after the "
                  f"first: median {years / wall:.3f} sim-yr/s, spread "
                  f"{(max(rates[1:]) - min(rates[1:])) / (years / wall):.1%}; "
                  f"kernels ~{kern:.3f} s of a run (launches x the times above), "
                  f"host ~{wall - kern:.3f} s = {(wall - kern) / wall:.1%}")
            for name in ("ts", "ta", "to", "q", "cap_surf"):
                if not bool(torch.isfinite(getattr(state, name)).all()):
                    raise AssertionError(f"state {name} not finite")
            for name in ("tf", "tof", "qf"):
                if not bool(torch.isfinite(getattr(corr, name)).all()):
                    raise AssertionError(f"corr {name} not finite")
            if monthly.shape != (num.time_scnr, 12, 5, num.ydim, num.xdim) \
                    or not np.isfinite(monthly).all():
                raise AssertionError(f"monthly means {monthly.shape} not finite")
            back = read_output(out_path, num.xdim, num.ydim)
            if not np.array_equal(back, monthly.reshape(-1, 5, num.ydim,
                                                        num.xdim)):
                raise AssertionError("output file does not read back")
            gm = [float(d.global_mean_ts) for d in diags]
            print(f"  global mean Ts [K] by scenario year: "
                  f"{' '.join(f'{g:.4f}' for g in gm)}")
            if not gm[-1] > gm[0]:
                raise AssertionError(f"no warming under 680 ppm: {gm}")
            lap("main path")

        if want(9):
            # -- the long-run path: 3 spin-up + 50 scenario years, checkpoints ---
            co2_long = np.full(LONG_YEARS, 680.0, np.float32)
            nmon = len(num.jday_mon)
            reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state_fc, corr_fc = model.flux_correction()
            ck_full, run_full = _long_runner(model, tmp, "full")
            s_full, _, _ = longrun.run_long(
                LONG_YEARS, state_fc, corr_fc, co2_long, run_full,
                checkpointer=ck_full, chunk_years=LONG_BLOCK)
            torch.cuda.synchronize()
            run_full.close()
            wall_long = time.perf_counter() - t0
            years_long = num.time_flux + LONG_YEARS
            print(f"long run: {years_long} sim-years in {wall_long:.3f} s = "
                  f"{years_long / wall_long:.3f} sim-yr/s ({num.time_flux} "
                  f"spin-up + {LONG_YEARS} scenario years in blocks of "
                  f"{LONG_BLOCK}, checkpoints every {LONG_BLOCK})")
            launches_long = read_counts("long run", {
                "fluxcorr_year": num.time_flux, "scenario_year": 0,
                "fluxcorr_years": 0, "scenario_years": LONG_YEARS // LONG_BLOCK})
            for name in ModelState.FIELDS:
                if not bool(torch.isfinite(getattr(s_full, name)).all()):
                    raise AssertionError(f"long run state {name} not finite")
            long_out = read_output(os.path.join(tmp, "long_full"), num.xdim,
                                   num.ydim)
            if long_out.shape != (LONG_YEARS * nmon, 5, num.ydim, num.xdim) \
                    or not np.isfinite(long_out).all():
                raise AssertionError(f"long run output {long_out.shape}")
            print(f"  output file {os.path.getsize(os.path.join(tmp, 'long_full'))}"
                  f" B; checkpoints {sorted(os.listdir(ck_full.dir))}")
            # its first 10 years against the main path's (both at 680 ppm): the
            # multi-year kernel sums monthly means step by step, GREB.run's path
            # as one product, so they agree at the golden tolerances
            first = long_out[:num.time_scnr * nmon].reshape(monthly.shape)
            for v, (name, tol) in enumerate((("ts", TOL_T), ("ta", TOL_T),
                                             ("to", TOL_T), ("q", TOL_Q),
                                             ("albedo", TOL_ALBEDO))):
                _check(f"long vs main monthly {name}", float(
                    np.abs(first[:, :, v] - monthly[:, :, v]).max()), tol)

            # stop at year 20, resume to 50 in a fresh process
            ck_res, run_res = _long_runner(model, tmp, "resumed")
            longrun.run_long(LONG_STOP, state_fc, corr_fc, co2_long, run_res,
                             checkpointer=ck_res, chunk_years=LONG_BLOCK)
            run_res.close()
            t0 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--resume-long", tmp],
                capture_output=True, text=True, timeout=900)
            wall_resume = time.perf_counter() - t0
            if proc.returncode != 0:
                print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
                raise AssertionError(f"resume process exited {proc.returncode}")
            child = json.loads(proc.stdout.strip().splitlines()[-1])
            print(f"resume in a fresh process: {wall_resume:.3f} s wall "
                  f"(setup {child['setup_s']:.3f} s, restore "
                  f"{child['restore_s']:.3f} s, years {child['start']}.."
                  f"{LONG_YEARS} in {child['run_s']:.3f} s, "
                  f"{child['scenario_years_launches']} scenario_years launches)")
            if child["start"] != LONG_STOP:
                raise AssertionError(f"resumed at {child['start']}")
            s_res, _, cursor = Checkpointer(ck_res.dir).restore(device="cuda")
            if cursor.year_index != LONG_YEARS:
                raise AssertionError(f"last checkpoint at {cursor.year_index}")
            for name in ModelState.FIELDS:
                if not torch.equal(getattr(s_res, name), getattr(s_full, name)):
                    raise AssertionError(f"resumed state {name} differs")
            with open(os.path.join(tmp, "long_full"), "rb") as f, \
                    open(os.path.join(tmp, "long_resumed"), "rb") as g:
                if f.read() != g.read():
                    raise AssertionError("resumed output file differs")
            print("  resumed run: final state and output file bitwise equal")
            lap("long run and resume")

        if want(10):
            # -- the member chain: 3 spin-up years + a LONG_BLOCK-year block,
            #    3 members
            members3 = ens.perturbed_params(
                model.params, {"ct_sens": np.linspace(22.05, 22.95, 3)})
            reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            s5_m, corr_m, mon_m, _ = model.run_members(
                members3, years=LONG_BLOCK, years_per_call=LONG_BLOCK,
                co2_series=co2_long)
            torch.cuda.synchronize()
            wall_m = time.perf_counter() - t0
            print(f"member chain: 3 members x {num.time_flux + LONG_BLOCK} years "
                  f"in {wall_m:.3f} s = {3 * (num.time_flux + LONG_BLOCK) / wall_m:.3f}"
                  f" member-yr/s")
            launches_m = read_counts("member chain", {
                "fluxcorr_year": 0, "scenario_year": 0,
                "fluxcorr_years": num.time_flux, "scenario_years": 1})
            if not (np.isfinite(mon_m).all()
                    and bool(torch.isfinite(s5_m).all())):
                raise AssertionError("member chain not finite")
            # member 1 has the base params: it is the long run's first block
            if not (torch.equal(corr_m[1, :, 0], corr_fc.tf)
                    and np.array_equal(mon_m[1], long_out[:LONG_BLOCK * nmon])):
                raise AssertionError("base member differs from the long run")
            if np.array_equal(mon_m[0], mon_m[2]):
                raise AssertionError("perturbed members do not differ")
            print("  base member bitwise equal to the long run's first block")
            lap("member chain")

        # -- the legacy switchboard in every kernel, and the legacy path ---
        if want(11):
            with _GraphedSteps():
                legacy = _legacy_phase(tmp, reset_counts, read_counts)
            lap("legacy")

        # -- the strict transport in every kernel, and the strict paths ----
        if want(12):
            with _GraphedSteps():
                strict = _strict_phase(tmp, reset_counts, read_counts)
            lap("strict")

        # -- the refined grid: K1/K2's refined instantiation, the refined
        #    path -----------------------------------------------------------
        if want(13):
            refined = _refined_phase(tmp, reset_counts, read_counts)
            lap("refined 384x192")

        # -- 192x96: the refined instantiation's additive form, its paths --
        if want(14):
            grid192 = _grid192_phase(tmp, reset_counts, read_counts)
            lap("192x96")

        # -- the legacy fold words at the refined grids, their paths -------
        if want(16):
            words = _words_phase(tmp, reset_counts, read_counts)
            lap("refined legacy words")

        # -- the strict transport at 384x192, the library default's path ---
        if want(17):
            strict_refined = _strict_refined_phase(tmp, reset_counts,
                                                   read_counts)
            lap("strict 384x192")

        # -- K3's shared table, and the ensemble path ----------------------
        if want(15):
            with _GraphedSteps():
                ensemble = _ensemble_phase(tmp, os.path.join(tmp,
                                                             "long_full"),
                                           reset_counts, read_counts)
            lap("ensemble")

        # -- 768x384 (config 5): the wide form, its paths -----------------
        if want(18):
            grid768 = _grid768_phase(tmp, reset_counts, read_counts, m768)
            del m768
            lap("768x384")

        # -- latitude x member sharding: the slab kernels, their paths ----
        if want(19):
            sharded = _sharded_phase(tmp, model, grid768.pop("short_model"))
            lap("sharded")

        # -- the grids between 192x96 and 384x192: the additive packed and
        #    strict additive forms, 256x128's paths ------------------------
        if want(20):
            band = _grid256_phase(tmp, reset_counts, read_counts)
            lap("256x128 band")

        # -- every word and the band grids on a CUDA mesh: the slab
        #    kernels' strict forms, legacy finish and additive packed form
        if want(21):
            words_sh = _sharded_words_phase(
                tmp, strict_refined.pop("short_model"), band.pop("fold_model"),
                band.pop("strict_model"), sharded.pop("workers"), plain96)
            del plain96
            lap("sharded words")

        # -- the host layer: analysis, plots, run diagnostics, native IO --
        if want(22):
            _host_layer_phase(tmp, model, smi, reset_counts, read_counts)
            lap("host layer")

        # -- the strict transport at 768x384: the strict form's wide
        #    variant, its paths ---------------------------------------------
        if want(23):
            strict768 = _strict768_phase(tmp, reset_counts, read_counts,
                                         plain768)
            del plain768
            lap("strict 768x384")

        # -- the member-batched matmul circulation in K3 and K4 ------------
        if want(25):
            with _GraphedSteps():
                mxu = _mxu_phase(tmp, reset_counts, read_counts)
            lap("mxu")
            if mxu["seconds"] > MXU_PHASE_S:
                raise AssertionError(f"step 25 took {mxu['seconds']:.1f} s, "
                                     f"over {MXU_PHASE_S} s")

    if steps != ALL_STEPS:
        print(f"smoke total: {time.perf_counter() - t_start:.1f} s wall "
              f"(steps {_spec(steps)}: no kernel line)")
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    # ms, plain_ms and bound_ms at the shape each path launches the kernel
    # (K3 one member for LONG_BLOCK years, K4 3 members: the median of
    # member_ms's 3 launches, on the size the wrapper picks for that
    # member count);
    # max_abs_err over that shape and every comparison above, the legacy,
    # strict and refined modes' included; "modes" the variants each kernel
    # was held bitwise in
    strict_name = lambda e: ("strict circulation" if e is None
                             else f"strict log_exp {e}")
    refined_mode = f"refined {REFINED_GRID['xdim']}x{REFINED_GRID['ydim']}"
    g192 = f"{G192_GRID['xdim']}x{G192_GRID['ydim']}"
    g192_mode = f"refined {g192} (additive splitting, dense composites)"
    # the strict transport at 384x192 (the refined strict form) in each
    # mode, the legacy fold words in both refined forms
    s384 = [f"strict 384x192 {'circulation' if e is None else f'log_exp {e}'}"
            for e in STRICT_REFINED_MODES]
    # 768x384 in the wide form: modern, and K1/K2 under log_exp 11
    wide_mode = "wide 768x384"
    # the grids between 192x96 and 384x192: each kernel's modes there, from
    # its entries' (step 20)
    band_modes = {name: sorted({m for e, ms in band["entries"].items()
                                if e.startswith(name + "_") for m in ms})
                  for name in BAND_KERNELS}
    single = (["modern"] + [f"log_exp {e}" for e in LEGACY_EXPS]
              + [strict_name(e) for e in STRICT_MODES] + [refined_mode,
                                                          g192_mode,
                                                          f"strict {g192}"]
              + [f"{g} log_exp {e}" for g in (refined_mode, g192_mode)
                 for e in WORD_EXPS] + s384
              + [wide_mode, f"{wide_mode} log_exp 11"])
    member = (["modern"] + [f"log_exp {e}" for e in LEGACY_MEMBER_EXPS]
              + [strict_name(e) for e in STRICT_MEMBER_MODES]
              + [refined_mode, g192_mode]
              + [f"{g} log_exp {e}" for g in (refined_mode, g192_mode)
                 for e in WORD_MEMBER_EXPS] + s384 + [wide_mode])
    k3_ms, k4_ms = (_median(member_ms[k])
                    for k in ("scenario_years", "fluxcorr_years"))
    kernels = []
    for name, src, line, count, ms, plain_ms, err, work, shape, c, modes in (
            ("fluxcorr_year", "year_kernel.py", 353,
             launches["fluxcorr_year"], ms_k1, plain_k1, err_k1,
             yk.year_work(plan, num, False), "1 year", C, single),
            ("scenario_year", "year_kernel.py", 231,
             launches["scenario_year"], ms_k2, plain_k2, err_k2,
             yk.year_work(plan, num, True), "1 year", C, single),
            ("scenario_years", "multiyear.py", 107,
             launches_long["scenario_years"], k3_ms, plain_k3,
             max(err_k3, ensemble["err"]),
             my.years_work(plan, num, LONG_BLOCK, 1, "scenario"),
             f"M=1 x {LONG_BLOCK} years", my.default_cluster(
                 "scenario_years", 1, capacity["scenario_years", C]),
             member + ["shared table", "strict shared table"]),
            ("fluxcorr_years", "multiyear.py", 253,
             launches_m["fluxcorr_years"], k4_ms, plain_k4, err_k4,
             my.years_work(plan, num, 1, 3, "fluxcorr"), "M=3 x 1 year",
             my.default_cluster("fluxcorr", 3, capacity["fluxcorr", C]),
             member)):
        bound_ms, bound_by = _bound_of(*work)
        entry = {
            "name": name, "route": "cuda",
            "source": "greb_tpu_torch/csrc/year_kernel.cu",
            "replaces": f"greb_tpu/ops/pallas/{src}:{line}",
            "launches": count,
            "max_abs_err": max(err, legacy["err"][name],
                               strict["err"][name],
                               refined["err"].get(name, 0.0),
                               grid192["err"][name],
                               grid192["strict_err"].get(name, 0.0),
                               words["err"][name],
                               strict_refined["err"][name],
                               grid768["err"][name], band["err"][name],
                               strict768["err"][name]),
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None, "cluster": c,
            "shape": shape, "modes": modes + band_modes[name],
            "launches_legacy_path": legacy["launches"][name],
            "launches_strict_path": strict["launches"][name],
            "launches_ensemble_path": ensemble["launches"][name],
            "launches_shared_ensemble_path": ensemble["launches_shared"][name]}
        if name == "scenario_years":
            # one year at M=ENS_M, a table per member and the shared table
            for key, label in (("per_member", "per-member tables"),
                               ("shared", "shared table")):
                e_bound, e_by = _bound_of(*ensemble["work"][label])
                entry.update({f"ensemble_{key}_ms": ensemble["ms"][label],
                              f"ensemble_{key}_bound_ms": e_bound,
                              f"ensemble_{key}_bound_by": e_by})
        if name in strict["ms"]:
            # the strict circulation's full-calendar year (its own
            # instantiation), its plain version and its bound
            s_bound, s_by = _bound_of(*strict["work"][name])
            entry.update(strict_ms=strict["ms"][name],
                         strict_plain_ms=strict["plain_ms"][name],
                         strict_bound_ms=s_bound, strict_bound_by=s_by)
        # the refined instantiation: its full-calendar launch at 384x192
        # (K1/K2 a year, K4 M=1, K3 M=1 x 2 years), the plain version on
        # the 20-step calendar (K1/K2 a year, K4 M=2, K3 M=2 x 2 years),
        # the bound and each refined path's launches
        r_bound, r_by = _bound_of(*refined["work"][name])
        paths = refined["paths"]
        entry.update(refined_ms=refined["ms"][name],
                     refined_plain_ms_20_steps=refined["plain_ms"][name],
                     refined_bound_ms=r_bound, refined_bound_by=r_by,
                     launches_refined_path=refined["launches"][name],
                     launches_refined_block_path=paths["block"]["launches"][
                         name],
                     launches_refined_ensemble_path=paths["ensemble"][
                         "launches"][name],
                     launches_refined_shared_ensemble_path=paths["shared"][
                         "launches"][name],
                     refined_cluster=yk.REFINED_CLUSTER_SIZES[0])
        # 192x96 (the refined instantiation's additive form): its
        # full-calendar launch (K1/K2 a year, K4 M=1, K3 M=1 x 2 years),
        # the plain version on the 20-step calendar (K1/K2 a year, K4 M=2,
        # K3 M=2 x 2 years), the bound and each 192x96 path's launches
        g_bound, g_by = _bound_of(*grid192["work"][name])
        g_paths = grid192["paths"]
        entry.update(grid192_ms=grid192["ms"][name],
                     grid192_plain_ms_20_steps=grid192["plain_ms"][name],
                     grid192_bound_ms=g_bound, grid192_bound_by=g_by,
                     launches_grid192_path=grid192["launches"][name],
                     launches_grid192_block_path=g_paths["block"][
                         "launches"][name],
                     launches_grid192_shared_ensemble_path=g_paths["shared"][
                         "launches"][name])
        # the legacy fold words at the refined grids (log_exp
        # WORD_MEMBER_EXPS[0] on REFINED_SHORT's calendar: K1/K2 a year,
        # K4 M=2, K3 M=2 x 2 years; plain steps from CUDA graphs) and the
        # strict transport at 384x192 (each mode on STRICT_REFINED_SHORT's
        # calendar at the same shapes; K1/K2 also a full-calendar year),
        # with their bounds and the paths' launches
        e0 = WORD_MEMBER_EXPS[0]
        for key, gtag in (("refined", "384x192"), ("grid192", "192x96")):
            wk = f"refined_legacy_{gtag}"
            b_ms, b_by = _bound_of(*words["work"][wk][name])
            entry.update({
                f"{key}_legacy_log_exp_{e0}_ms_20_steps": words["ms"][wk][
                    name],
                f"{key}_legacy_log_exp_{e0}_plain_ms_20_steps": words[
                    "plain_ms"][wk][name],
                f"{key}_legacy_log_exp_{e0}_bound_ms": b_ms,
                f"{key}_legacy_log_exp_{e0}_bound_by": b_by})
        for mode in strict_refined["ms"]:
            k = "strict_refined_" + mode.replace(" ", "_")
            b_ms, b_by = _bound_of(*strict_refined["work"][mode][name])
            entry.update({f"{k}_ms_short": strict_refined["ms"][mode][name],
                          f"{k}_plain_ms_short": strict_refined["plain_ms"][
                              mode][name],
                          f"{k}_bound_ms_short": b_ms,
                          f"{k}_bound_by_short": b_by})
        if name in strict_refined["full_ms"]:
            b_ms, b_by = _bound_of(*strict_refined["full_work"][name])
            entry.update(strict_refined_ms=strict_refined["full_ms"][name],
                         strict_refined_bound_ms=b_ms,
                         strict_refined_bound_by=b_by)
        entry.update(
            launches_strict_refined_path=strict_refined["launches_path"][
                name],
            launches_refined_legacy_path=words["launches_path"][name],
            launches_grid192_legacy_ensemble_path=words[
                "launches_ensemble"][name])
        # 768x384 (the wide form): its entries, the launch timed (K1/K2:
        # the path's full-calendar year; K4 M=2 and K3 M=2 x 2 years on the
        # short calendar), its bound, the launch and the plain version on
        # the short calendar (K1/K2 a year, K4 M=2, K3 M=2 x 2 years) and
        # each 768x384 path's launches
        g7_bound, g7_by = _bound_of(*grid768["work"][name])
        entry.update(
            grid768_entries=[name + "_wide", name + "_wide_legacy"],
            grid768_clusters_a_run=grid768["groups"],
            grid768_ms=grid768["ms"][name],
            grid768_shape=grid768["shape"][name],
            grid768_bound_ms=g7_bound, grid768_bound_by=g7_by,
            grid768_ms_short=grid768["short_ms"][name],
            grid768_plain_ms_short=grid768["plain_ms"][name],
            launches_grid768_path=grid768["launches_path"][name],
            launches_grid768_long_path=grid768["launches_long"][name],
            launches_grid768_ensemble_path=grid768["launches_ensemble"][
                name])
        # 768x384 under the library default (the strict form's wide
        # variant, csrc/strict_wide_kernel.cu): K1/K2 timed on the short
        # calendar (2 twelve-hour steps of 96 substeps) with that launch's
        # bound, and on S768_PLAIN's (24 one-hour steps of 8 substeps)
        # with its bound beside the plain version's first steps there (K1's
        # and K2's step together: one circulation), K4 and K3 at M=1 timed
        # together, the paths' launches
        entry.update(
            strict768_entries=[name + "_strict_wide"],
            strict768_source="greb_tpu_torch/csrc/strict_wide_kernel.cu",
            strict768_launches_path=strict768["launches"]["path"][name],
            strict768_launches_long_path=strict768["launches"]["long"][name],
            strict768_launches_ensemble_path=strict768["launches"][
                "ensemble"][name],
            strict768_launches_legacy_path=strict768["launches"]["legacy"][
                name],
            strict768_plain_ms_1h_first_steps=strict768[
                "plain_ms_1h_first_steps"])
        if name in strict768["ms"]:
            s7_bound, s7_by = _bound_of(*strict768["short_work"][name])
            h_bound, h_by = _bound_of(*strict768["work_1h"][name])
            entry.update(
                strict768_ms_short=strict768["ms"][name],
                strict768_bound_ms_short=s7_bound,
                strict768_bound_by_short=s7_by,
                strict768_ms_1h=strict768["ms_1h"][name],
                strict768_bound_ms_1h=h_bound,
                strict768_bound_by_1h=h_by)
        else:
            entry["strict768_ms_k4_k3_m1_short"] = strict768["ms"][
                "members_m1"]
        # the grids between 192x96 and 384x192: the entries of this kernel
        # with the modes each was held bitwise in; at 256x128 under the
        # fold and the strict circulation each launch (K1/K2 a year, K4
        # M=2, K3 M=2 x 2 years; the fold on 20 steps, the strict
        # circulation on 2), its plain version, its bound, the paths'
        # launches; K1/K2's full-calendar years of the two GREB.run paths
        # with their bounds; K1/K2 under log_exp 11 at 256x128 and at the
        # band's other grids, each launch and its plain version
        entry["band_entries"] = {
            e: modes for e, modes in sorted(band["entries"].items())
            if e.startswith(name + "_")}
        for mode in band["ms"]:
            key = "band_" + mode.replace(" ", "_")
            b_ms, b_by = _bound_of(*band["work"][mode][name])
            entry.update({f"{key}_ms": band["ms"][mode][name],
                          f"{key}_plain_ms": band["plain_ms"][mode][name],
                          f"{key}_bound_ms": b_ms, f"{key}_bound_by": b_by,
                          f"{key}_shape": band["shape"][mode][name]})
        for transport, mss in band["full_ms"].items():
            if name in mss:
                b_ms, b_by = _bound_of(*band["full_work"][transport][name])
                entry.update({
                    f"band_256x128_{transport}_full_ms": mss[name],
                    f"band_256x128_{transport}_full_bound_ms": b_ms,
                    f"band_256x128_{transport}_full_bound_by": b_by})
        for mode, g in band["band"].items():
            if name in g["ms"]:
                key = "band_" + mode.replace(" ", "_")
                entry.update({f"{key}_ms": g["ms"][name],
                              f"{key}_plain_ms": g["plain_ms"][name]})
        entry.update(
            launches_grid256_path=band["launches_path"][name],
            launches_grid256_strict_path=band["launches_strict_path"][name],
            launches_grid256_block_path=band["paths"]["block"]["launches"][
                name],
            launches_grid256_shared_ensemble_path=band["paths"]["shared"][
                "launches"][name],
            launches_grid256_long_path=band["launches_long"][name])
        if name == "scenario_years":
            # one year of a wave of members (M = the card's capacity)
            M, w_ms, w_work = refined["wave"]
            w_bound, w_by = _bound_of(*w_work)
            entry.update(refined_wave_members=M, refined_wave_ms=w_ms,
                         refined_wave_bound_ms=w_bound,
                         refined_wave_bound_by=w_by)
        kernels.append(entry)
    # the member-batched matmul circulation (step 25, csrc/members_kernel.cu):
    # ms, plain_ms (its twin: the members as one batch, each step from a
    # CUDA graph) and bound_ms at the check's shape at bf16_3x, the CLI's
    # default (K4 M = 2 mb, 1 year; K3 M = 2 mb x 2 years, a table per
    # member; the twin's time covers both of K3's table forms), the same at
    # highest; launches on the ensemble paths (--ensemble ENS_M, bf16_3x);
    # K3's timed years at MXU_TIMED_M members against the per-member
    # kernel, the torch.bmm row dots (information, not a library call of
    # the same function), the HIGH budget
    for name, line, kind, years in (("fluxcorr_years_mxu", 253, "fluxcorr",
                                     1),
                                    ("scenario_years_mxu", 107,
                                     "scenario_years", 2)):
        mb = mxu["mb"][kind]
        entry = {
            "name": name, "route": "cuda",
            "source": "greb_tpu_torch/csrc/members_kernel.cu",
            "replaces": f"greb_tpu/ops/pallas/multiyear.py:{line}",
            "replaces_circulation": "greb_tpu/ops/fastcirc2.py:782 "
                                    "mxu_members_circulation",
            "launches": ensemble["launches"][name],
            "launches_shared_ensemble_path": ensemble["launches_shared"][
                name],
            "max_abs_err": max(mxu["err"], ensemble["err"]),
            "library_ms": None, "cluster": 16, "mb": mb,
            "clusters_at_once": mxu["capacity"][kind],
            "shape": f"M={2 * mb} x {years} year{'s' * (years > 1)}",
            "modes": ["bf16_3x", "highest", "short last cluster (M = mb + 1)",
                      "ensemble path"]}
        for prec in MXU_PRECS:
            b_ms, b_by = mxu["bound"][prec][kind]
            pre = "" if prec == "bf16_3x" else "highest_"
            entry.update({f"{pre}ms": mxu["ms"][prec][kind],
                          f"{pre}plain_ms": mxu["plain_ms"][prec][kind],
                          f"{pre}bound_ms": b_ms, f"{pre}bound_by": b_by})
        if kind == "scenario_years":
            for M, row in mxu["timed"].items():
                for label, t in row.items():
                    key = f"year_M{M}_{label.replace('-', '_')}"
                    entry.update({f"{key}_ms": t["ms"],
                                  f"{key}_member_yr_s": t["member_yr_s"],
                                  f"{key}_bound_ms": t["bound_ms"],
                                  f"{key}_bound_by": t["bound_by"]})
            entry.update({f"bmm_row_dot_M{M}_{prec}_ms_substep": t
                          for (M, prec), t in mxu["bmm"].items()})
            entry["ensemble_member_yr_s"] = ensemble["rates"]
            entry["high_budget"] = mxu["budget"]
        kernels.append(entry)
    # the slab kernels (no TPU counterpart: greb_tpu's sharded fold runs on
    # XLA): ms a launch on the sharded path's shape (96x48, SHARD_PATH_NY
    # shards of the card, one shard's launch, eager), its plain version on
    # one shard, the bound of one launch, launches on the sharded path
    # (1 + 1 years); at 768x384 the same on SHARD_REFINED_NY shards
    for name in SLAB_ENTRIES:
        bound_ms, bound_by = _bound_of(*sharded["work"][name])
        g7 = sharded["grid768"]
        b7_ms, b7_by = _bound_of(*g7["work"][name])
        kernels.append({
            "name": name, "route": "cuda",
            "source": "greb_tpu_torch/csrc/slab_kernel.cu",
            "replaces": "none: greb_tpu/ops/fastcirc2.py:1184 "
                        "sharded_substep runs on XLA, no pallas_call",
            "launches": sharded["launches"][name],
            "max_abs_err": sharded["err"], "ms": sharded["ms"][name],
            "plain_ms": sharded["plain_ms"][name], "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None,
            "shape": f"96x48 on {SHARD_PATH_NY} shards of the card, one "
                     f"shard's launch",
            "grid768_ms": g7["ms"][name], "grid768_bound_ms": b7_ms,
            "grid768_bound_by": b7_by,
            "grid768_shards": SHARD_REFINED_NY,
            "grid768_us_substep": g7["us_substep"],
            "grid768_ms_step": g7["ms_step"],
            "sharded_sim_yr_per_s": sharded["rate"]})
    # the slab kernels' entries under the other words and at the band
    # grids (step 21): ms a launch on the slowest shard of their path's
    # shape, the plain version on the pole shard, its bound there, the
    # launches on their path (the 96x48 strict path: 4 shards, 1 + 1
    # years; 256x128 and 384x192: 4 shards on their short calendars), and
    # the runs each was held bitwise in
    for name in STRICT_SLAB_ENTRIES:
        bound_ms, bound_by = _bound_of(*words_sh["work"][name])
        kernels.append({
            "name": name, "route": "cuda",
            "source": "greb_tpu_torch/csrc/slab_kernel.cu",
            "replaces": "none: greb_tpu/parallel/sharded.py:115 "
                        "make_sharded_year_runners runs on XLA, no "
                        "pallas_call",
            "launches": words_sh["launches"][name],
            "max_abs_err": words_sh["err"], "ms": words_sh["ms"][name],
            "plain_ms": words_sh["plain_ms"][name], "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None,
            "shape": words_sh["shape"][name],
            "modes": words_sh["modes"][name],
            "sharded_strict_sim_yr_per_s": words_sh["rate"]})
    print(f"smoke total: {time.perf_counter() - t_start:.1f} s wall")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
