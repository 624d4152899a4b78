// The refined instantiation's entries of the four year kernels, in a
// library of their own: the forms year_kernel.cu's device code runs for a
// fold or strict plan the cluster body does not hold (run_refined; see
// year_kernel.cu's notes on the refined instantiation), built beside the
// other libraries so that year_kernel.cu's build is shorter.
//
// Replaces, with year_kernel.cu's entries, the four Pallas TPU kernels of
// greb_tpu/ops/pallas/ (year_kernel.py build_fluxcorr_year :353,
// build_scenario_year :231; multiyear.py build_scenario_years :107,
// build_fluxcorr_years :253) at these plans:
//   _refined, _refined_legacy      384x192's sequential splitting with
//                                  packed composites, modern and legacy;
//   _additive, _additive_legacy    192x96's additive splitting with dense
//                                  composites read from L2;
//   _strict_refined                the strict transport (and none) with
//                                  sequential splitting, 384x192;
//   _wide, _wide_legacy            768x384's sequential fold on several
//                                  clusters a run.
// The device code is year_kernel.cu's (included below with
// GREB_DEVICE_ONLY); this file holds the entries and their launchers.
// ops/cuda/year_kernel.py sends the launchers greb_*_refined here
// (refined_launcher), the cluster body's entries to year_kernel.cu's.

#define GREB_DEVICE_ONLY
#include "year_kernel.cu"

REFINED_KERNELS(_refined, R_SEQ, false, false)
REFINED_KERNELS(_additive, R_ADDITIVE, false, false)
REFINED_KERNELS(_refined_legacy, R_SEQ, true, false)
REFINED_KERNELS(_additive_legacy, R_ADDITIVE, true, false)
REFINED_KERNELS(_strict_refined, R_STRICT, true, false)
REFINED_KERNELS(_wide, R_SEQ, false, true)
REFINED_KERNELS(_wide_legacy, R_SEQ, true, true)

// A launcher's refined kernels in the order refined_pick numbers them.
#define N_REFINED 7
#define REFINED_TABLE(K)                                                     \
  { K##_refined, K##_additive, K##_refined_legacy, K##_additive_legacy,     \
    K##_strict_refined, K##_wide, K##_wide_legacy }

// A kernel's parameters are passed by value: the largest set (the refined
// member kernels') stays under the 4 KB that every toolkit takes.
static_assert(sizeof(YearArgs) + sizeof(GrebParams) + sizeof(PackCols) +
                      sizeof(RefinedArgs) <= 4096,
              "kernel parameters over 4 KB");

// The refined kernel (REFINED_TABLE's index) that runs g.form under the
// variant of p's flags word: the fold's forms modern or legacy, the strict
// form for the strict transport or none, the wide form (g.groups > 1: the
// sequential form on several clusters) modern or legacy; -1 where none
// runs it (the forms of csrc/band_kernel.cu and the strict form on several
// clusters, csrc/strict_wide_kernel.cu's, included).
static int refined_pick(const GrebParams& p, const RefinedArgs& g) {
  const Variant v = variant(p);
  if (g.groups > 1) {
    if (g.form != R_SEQ) return -1;
    return v == V_MODERN ? 5 : v == V_LEGACY ? 6 : -1;
  }
  if (g.form == R_STRICT) return v == V_STRICT ? 4 : -1;
  if (g.form != R_SEQ && g.form != R_ADDITIVE) return -1;
  if (v == V_MODERN) return g.form;
  return v == V_LEGACY ? 2 + g.form : -1;
}

// The refined instantiation: a.M members on a.M clusters of C blocks of
// the kernel of `table` that refined_pick picks, as launch_cluster
// (GREB_ERR_FLAGS where none); the member kernels take the pack's columns
// (extra) before g.  The wide form (g.groups clusters a member) launches
// only where the card runs all a.M * g.groups clusters at once
// (GREB_ERR_RESIDENT: its grid barrier would never end).
template <typename Kernel, typename... Extra>
static int launch_refined(Kernel const (&table)[N_REFINED],
                          const YearArgs& a, const GrebParams& p,
                          const RefinedArgs& g, int C, void* stream,
                          Extra... extra) {
  const int k = refined_pick(p, g);
  if (k < 0) return GREB_ERR_FLAGS;
  cudaLaunchAttribute attr[2];
  cudaLaunchConfig_t cfg;
  int clusters;
  const int err = refined_config(table[k], a, g, C, stream, attr, &cfg,
                                 &clusters);
  if (err) return err;
  if (g.groups > 1 && clusters < a.M * g.groups) return GREB_ERR_RESIDENT;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, table[k], a, p, extra...,
                                           g);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

extern "C" {

// The four kernels at a grid of the refined instantiation, in the form
// g.form, under the variant of the flags word (refined_pick; any other
// word: GREB_ERR_FLAGS).
int greb_fluxcorr_year_refined(YearArgs a, GrebParams p, RefinedArgs g, int C,
                               void* stream) {
  decltype(&fluxcorr_year_refined) const t[] = REFINED_TABLE(fluxcorr_year);
  return launch_refined(t, a, p, g, C, stream);
}

int greb_scenario_year_refined(YearArgs a, GrebParams p, RefinedArgs g, int C,
                               void* stream) {
  decltype(&scenario_year_refined) const t[] = REFINED_TABLE(scenario_year);
  return launch_refined(t, a, p, g, C, stream);
}

int greb_fluxcorr_years_refined(YearArgs a, GrebParams p, PackCols c,
                                RefinedArgs g, int C, void* stream) {
  decltype(&fluxcorr_years_refined) const t[] = REFINED_TABLE(fluxcorr_years);
  return launch_refined(t, a, p, g, C, stream, c);
}

int greb_scenario_years_refined(YearArgs a, GrebParams p, PackCols c,
                                RefinedArgs g, int C, void* stream) {
  decltype(&scenario_years_refined) const t[] =
      REFINED_TABLE(scenario_years);
  return launch_refined(t, a, p, g, C, stream, c);
}

// The kernel's own reckoning of a refined block's shared memory in the
// form g.form: fills parts[N_QPARTS] (bytes, layout order), returns the
// total (0: no layout).
long long greb_refined_layout(int Y, int X, int ktc, int kbc, int C,
                              RefinedArgs g, long long* parts) {
  return form_parts(Y, X, ktc, kbc, C, g, parts);
}

// How many clusters of C blocks of the refined kernel of `kind` (FLUX:
// fluxcorr_years, SCEN: scenario_year, SCEN_YEARS: scenario_years; in the
// form g.form, its modern variant or the strict form's) the card runs at
// once, into *clusters; an error code as the launchers.
int greb_refined_capacity(int Y, int X, int ktc, int kbc, int C, int kind,
                          RefinedArgs g, int* clusters) {
  YearArgs a = {};
  a.Y = Y; a.X = X; a.ktc = ktc; a.kbc = kbc; a.M = 1;
  cudaLaunchAttribute attr[2];
  cudaLaunchConfig_t cfg;
  const int k = g.groups > 1 ? (g.form == R_SEQ ? 5 : -1)
                             : g.form == R_STRICT ? 4 : g.form;
  if (k < 0 || k >= N_REFINED) return GREB_ERR_LAYOUT;
  if (kind == FLUX) {
    decltype(&fluxcorr_years_refined) const t[] =
        REFINED_TABLE(fluxcorr_years);
    return refined_config(t[k], a, g, C, nullptr, attr, &cfg, clusters);
  }
  if (kind == SCEN) {
    decltype(&scenario_year_refined) const t[] = REFINED_TABLE(scenario_year);
    return refined_config(t[k], a, g, C, nullptr, attr, &cfg, clusters);
  }
  decltype(&scenario_years_refined) const t[] = REFINED_TABLE(scenario_years);
  return refined_config(t[k], a, g, C, nullptr, attr, &cfg, clusters);
}

// The refined kernel (REFINED_TABLE's index) that a launcher runs for a
// flags word in a form on `groups` clusters a run; -1: none
// (GREB_ERR_FLAGS).
int greb_refined_pick(int flags, int form, int groups) {
  GrebParams p = {};
  p.flags = flags;
  RefinedArgs g = {};
  g.form = form;
  g.groups = groups;
  return refined_pick(p, g);
}

}  // extern "C"
