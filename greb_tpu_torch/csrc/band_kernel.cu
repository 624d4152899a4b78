// The four year kernels at the grids between 192x96 and 384x192 at
// dt_crcl 1800 s (224x112, 256x128, 288x144, 320x160, 352x176): the
// refined instantiation's two forms for them, in a library of their own.
//
// Replaces, with year_kernel.cu's entries, the four Pallas TPU kernels of
// greb_tpu/ops/pallas/ (year_kernel.py build_fluxcorr_year :353,
// build_scenario_year :231; multiyear.py build_scenario_years :107,
// build_fluxcorr_years :253), which the JAX package runs at these grids
// (GREB._pallas_viable admits 224x112 to 288x144) under every word:
//   _additive_packed, _additive_packed_legacy
//       the fold: additive zonal splitting (the reference's envelope, no
//       seq_zonal), explicit polar diffusion and advection segments, and
//       packed SVD pole composites (fastcirc2.substep without seq_zonal,
//       _packed_comp): additive_substep<MEMBERS, true>, which calls
//       packed_comp, the sequential form's composite rows, where the
//       additive form calls dense_comp; modern (flags 0) and legacy (the
//       fold words with switches: log_exp 5, 6, 9, 11, 13-15);
//   _strict_additive
//       the strict transport (the strict circulation, the library default
//       GrebConfig(), log_exp 7, 8, 16) and the no-transport words of
//       log_exp 0-4 where the cluster body's strict block does not fit 227
//       KB at 16 blocks (K3 at 224x112, K2 and K3 at 256x128, all four
//       from 288x144): the cluster body's strict arithmetic
//       (strict_substep's, additive splitting with compact polar
//       sub-cycles) in strict_add_substep, with the state, the annual sums,
//       K3's monthly means and the winds in global memory and L2, as the
//       sequential strict form (_strict_refined) keeps them.
// The device code is year_kernel.cu's (run_refined, included below with
// GREB_DEVICE_ONLY); this file holds the entries and their launchers.  The
// two libraries compile at once (ops/cuda/build.py), so the forms added
// here do not lengthen the build, and year_kernel.cu's entries compile as
// they did.  ops/cuda/year_kernel.py sends a plan of these forms
// (refined_form) to the launchers here, any other to year_kernel.cu's.

#define GREB_DEVICE_ONLY
#include "year_kernel.cu"

REFINED_KERNELS(_additive_packed, R_ADDITIVE_PACKED, false, false)
REFINED_KERNELS(_additive_packed_legacy, R_ADDITIVE_PACKED, true, false)
REFINED_KERNELS(_strict_additive, R_STRICT_ADDITIVE, true, false)

// A launcher's kernels in the order band_pick numbers them
// (ops/cuda/year_kernel.py BAND_SUFFIXES).
#define N_BAND 3
#define BAND_TABLE(K)                                                        \
  { K##_additive_packed, K##_additive_packed_legacy, K##_strict_additive }

// The kernel (BAND_TABLE's index) that runs g.form under the variant of
// p's flags word: the fold's additive packed form modern or legacy, the
// strict additive form for the strict transport or none; -1 where none
// runs it (the other forms, and any run on several clusters).
static int band_pick(const GrebParams& p, const RefinedArgs& g) {
  const Variant v = variant(p);
  if (g.groups > 1) return -1;
  if (g.form == R_ADDITIVE_PACKED)
    return v == V_MODERN ? 0 : v == V_LEGACY ? 1 : -1;
  if (g.form == R_STRICT_ADDITIVE) return v == V_STRICT ? 2 : -1;
  return -1;
}

// a.M members on a.M clusters of C blocks of the kernel of `table` that
// band_pick picks (GREB_ERR_FLAGS where none), members beyond the card's
// capacity in waves; the member kernels take the pack's columns (extra)
// before g.
template <typename Kernel, typename... Extra>
static int launch_band(Kernel const (&table)[N_BAND], const YearArgs& a,
                       const GrebParams& p, const RefinedArgs& g, int C,
                       void* stream, Extra... extra) {
  const int k = band_pick(p, g);
  if (k < 0) return GREB_ERR_FLAGS;
  cudaLaunchAttribute attr[2];
  cudaLaunchConfig_t cfg;
  int clusters;
  const int err = refined_config(table[k], a, g, C, stream, attr, &cfg,
                                 &clusters);
  if (err) return err;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, table[k], a, p, extra...,
                                           g);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

extern "C" {

// The four kernels in the form g.form under the variant of the flags word
// (band_pick; any other word: GREB_ERR_FLAGS); errors as year_kernel.cu's
// launchers (greb_error_string).
int greb_fluxcorr_year_band(YearArgs a, GrebParams p, RefinedArgs g, int C,
                            void* stream) {
  decltype(&fluxcorr_year_additive_packed) const t[] =
      BAND_TABLE(fluxcorr_year);
  return launch_band(t, a, p, g, C, stream);
}

int greb_scenario_year_band(YearArgs a, GrebParams p, RefinedArgs g, int C,
                            void* stream) {
  decltype(&scenario_year_additive_packed) const t[] =
      BAND_TABLE(scenario_year);
  return launch_band(t, a, p, g, C, stream);
}

int greb_fluxcorr_years_band(YearArgs a, GrebParams p, PackCols c,
                             RefinedArgs g, int C, void* stream) {
  decltype(&fluxcorr_years_additive_packed) const t[] =
      BAND_TABLE(fluxcorr_years);
  return launch_band(t, a, p, g, C, stream, c);
}

int greb_scenario_years_band(YearArgs a, GrebParams p, PackCols c,
                             RefinedArgs g, int C, void* stream) {
  decltype(&scenario_years_additive_packed) const t[] =
      BAND_TABLE(scenario_years);
  return launch_band(t, a, p, g, C, stream, c);
}

// How many clusters of C blocks of the kernel of `kind` (FLUX:
// fluxcorr_years, SCEN: scenario_year, SCEN_YEARS: scenario_years; the
// form g.form's modern variant or the strict additive form) the card runs
// at once, into *clusters; an error code as the launchers.
int greb_band_capacity(int Y, int X, int ktc, int kbc, int C, int kind,
                       RefinedArgs g, int* clusters) {
  YearArgs a = {};
  a.Y = Y; a.X = X; a.ktc = ktc; a.kbc = kbc; a.M = 1;
  cudaLaunchAttribute attr[2];
  cudaLaunchConfig_t cfg;
  const int k = g.form == R_ADDITIVE_PACKED ? 0
                : g.form == R_STRICT_ADDITIVE ? 2 : -1;
  if (k < 0 || g.groups > 1) return GREB_ERR_LAYOUT;
  if (kind == FLUX) {
    decltype(&fluxcorr_years_additive_packed) const t[] =
        BAND_TABLE(fluxcorr_years);
    return refined_config(t[k], a, g, C, nullptr, attr, &cfg, clusters);
  }
  if (kind == SCEN) {
    decltype(&scenario_year_additive_packed) const t[] =
        BAND_TABLE(scenario_year);
    return refined_config(t[k], a, g, C, nullptr, attr, &cfg, clusters);
  }
  decltype(&scenario_years_additive_packed) const t[] =
      BAND_TABLE(scenario_years);
  return refined_config(t[k], a, g, C, nullptr, attr, &cfg, clusters);
}

// The kernel (BAND_TABLE's index) that a launcher runs for a flags word in
// a form on `groups` clusters a run; -1: none (GREB_ERR_FLAGS).
int greb_band_pick(int flags, int form, int groups) {
  GrebParams p = {};
  p.flags = flags;
  RefinedArgs g = {};
  g.form = form;
  g.groups = groups;
  return band_pick(p, g);
}

}  // extern "C"
