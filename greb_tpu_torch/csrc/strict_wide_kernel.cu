// The four year kernels under the strict transport and no transport at
// 768x384 (dt_crcl 450 s, the repository's BASELINE config 5): the
// sequential strict form's wide variant, in a library of its own.
//
// Replaces, with year_kernel.cu's entries, the four Pallas TPU kernels of
// greb_tpu/ops/pallas/ (year_kernel.py build_fluxcorr_year :353,
// build_scenario_year :231; multiyear.py build_scenario_years :107,
// build_fluxcorr_years :253) for the words that the JAX package runs on
// its XLA path at this grid (the strict circulation, the library default
// GrebConfig(), log_exp 7, 8, 16, and the no-transport words of log_exp
// 0-4):
//   _strict_wide
//       run_refined<..., R_STRICT, true, true>: the sequential strict
//       form's body (strict_seq_substep<true>) on the wide form's G = 6
//       clusters of 16 blocks, the halo rows across the cluster edges
//       through RefinedArgs::ghalo at a grid barrier (wide_exchange), each
//       pole's rows' diffusion sub-cycle spread over its own cluster
//       (spread_cycle); see year_kernel.cu's notes on the strict wide form.
// The device code is year_kernel.cu's (included below with
// GREB_DEVICE_ONLY); this file holds the entries and their launchers.  The
// libraries compile at once (ops/cuda/build.py), so these four entries do
// not lengthen year_kernel.cu's build.  ops/cuda/year_kernel.py sends a
// StrictPlan that runs on several clusters (refined_groups) to the
// launchers here (refined_launcher), any other plan elsewhere.

#define GREB_DEVICE_ONLY
#include "year_kernel.cu"

REFINED_KERNELS(_strict_wide, R_STRICT, true, true)

// Whether the launchers here run g's form under p's flags word: the
// sequential strict form on several clusters, for the strict transport or
// none.
static bool strict_wide_runs(const GrebParams& p, const RefinedArgs& g) {
  return g.form == R_STRICT && g.groups > 1 && variant(p) == V_STRICT;
}

// a.M members on a.M * g.groups clusters of C blocks of `kernel`, all
// resident at once (GREB_ERR_RESIDENT where the card does not run them:
// the grid barrier would never end); GREB_ERR_FLAGS where
// strict_wide_runs does not hold; the member kernels take the pack's
// columns (extra) before g.
template <typename Kernel, typename... Extra>
static int launch_strict_wide(Kernel kernel, const YearArgs& a,
                              const GrebParams& p, const RefinedArgs& g,
                              int C, void* stream, Extra... extra) {
  if (!strict_wide_runs(p, g)) return GREB_ERR_FLAGS;
  cudaLaunchAttribute attr[2];
  cudaLaunchConfig_t cfg;
  int clusters;
  const int err = refined_config(kernel, a, g, C, stream, attr, &cfg,
                                 &clusters);
  if (err) return err;
  if (clusters < a.M * g.groups) return GREB_ERR_RESIDENT;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, a, p, extra..., g);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

extern "C" {

// The four kernels in the strict wide form (strict_wide_runs; any other
// form or word: GREB_ERR_FLAGS); errors as year_kernel.cu's launchers
// (greb_error_string).
int greb_fluxcorr_year_strict_wide(YearArgs a, GrebParams p, RefinedArgs g,
                                   int C, void* stream) {
  return launch_strict_wide(fluxcorr_year_strict_wide, a, p, g, C, stream);
}

int greb_scenario_year_strict_wide(YearArgs a, GrebParams p, RefinedArgs g,
                                   int C, void* stream) {
  return launch_strict_wide(scenario_year_strict_wide, a, p, g, C, stream);
}

int greb_fluxcorr_years_strict_wide(YearArgs a, GrebParams p, PackCols c,
                                    RefinedArgs g, int C, void* stream) {
  return launch_strict_wide(fluxcorr_years_strict_wide, a, p, g, C, stream,
                            c);
}

int greb_scenario_years_strict_wide(YearArgs a, GrebParams p, PackCols c,
                                    RefinedArgs g, int C, void* stream) {
  return launch_strict_wide(scenario_years_strict_wide, a, p, g, C, stream,
                            c);
}

// How many clusters of C blocks of the strict wide kernel of `kind` (FLUX:
// fluxcorr_years, SCEN: scenario_year, SCEN_YEARS: scenario_years) the
// card runs at once, into *clusters; an error code as the launchers.
int greb_strict_wide_capacity(int Y, int X, int C, int kind, RefinedArgs g,
                              int* clusters) {
  YearArgs a = {};
  a.Y = Y; a.X = X; a.M = 1;
  cudaLaunchAttribute attr[2];
  cudaLaunchConfig_t cfg;
  if (g.form != R_STRICT || g.groups < 2) return GREB_ERR_LAYOUT;
  if (kind == FLUX)
    return refined_config(fluxcorr_years_strict_wide, a, g, C, nullptr, attr,
                          &cfg, clusters);
  if (kind == SCEN)
    return refined_config(scenario_year_strict_wide, a, g, C, nullptr, attr,
                          &cfg, clusters);
  return refined_config(scenario_years_strict_wide, a, g, C, nullptr, attr,
                        &cfg, clusters);
}

// Whether a launcher here runs a flags word in a form on `groups` clusters
// a run: 0 (the entry _strict_wide), -1 where it does not
// (GREB_ERR_FLAGS).
int greb_strict_wide_pick(int flags, int form, int groups) {
  GrebParams p = {};
  p.flags = flags;
  RefinedArgs g = {};
  g.form = form;
  g.groups = groups;
  return strict_wide_runs(p, g) ? 0 : -1;
}

}  // extern "C"
