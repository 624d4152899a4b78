"""Uniform coefficient-folded circulation (``greb_tpu.ops.fastcirc2``).

The polar-band zonal stencils fold into the same full-field 7-point apply
as the interior rows, with per-row coefficient fields (reference
src/greb.f90:556-915):

* interior and polar zonal diffusion share the 10/4/1 smoothed 7-point
  form; only the per-row coefficient differs (:582 vs :654);
* interior (2-point upwind /3, :798-836) and polar (10/4/1 smooth3,
  :842-906) zonal advection are both linear with reach <= 3;
* the positivity clamps (:715, :907) apply on polar rows only — a masked
  ``where`` on the full-field increment;
* the outer wz of dX_diffuse = wz*(dTx+dTy) (:721) multiplies after the
  clamp, so the substep applies ``wz * dd`` once.

Rows with more diffusion sub-cycles than one collapse into composite
operators (dense, or packed SVD factors on refined grids); rows with a few
iterate explicitly (``diff_segs`` / ``adv_segs``).  A packed composite row
works on its own rank's columns of the factors (``PackedIndex``): the
masked full product's other terms are exact zeros.

The eager ``substep`` / ``circulation`` here are the plain PyTorch versions
the CUDA year kernels (ops/cuda/year_kernel.py) are held against.  Their
float32 operation order follows the JAX package: the balanced-tree 7-point
sum, the sequential meridional sum, ``x + wz*dd + da + dy``.  The composite
row sums run in a fixed blocked order (``_row_dot``) that the kernel
repeats.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as tnf

from ..grid import Grid
from . import fastcirc as v1
from . import stencils as stc

F32 = np.float32
F64 = np.float64

# composite row sums run over blocks of this many consecutive terms
COMP_BLOCK = 8

FastPlan = v1.FastPlan
_LON_IDX_SHIFT = v1._LON_IDX_SHIFT

# zam multiplier index map (x u_m for 0..3, x u_p for 4..7)
_ZA_M3, _ZA_M2, _ZA_M1, _ZA_CM = 0, 1, 2, 3
_ZA_CP, _ZA_P1, _ZA_P2, _ZA_P3 = 4, 5, 6, 7
# mer index map
_MD_KM1, _MD_KP1, _C0_MD = 0, 1, 2
_MAM2, _MAM1, _MAP1, _MAP2, _MA0M, _MA0P = 3, 4, 5, 6, 7, 8


@dataclass
class PackedIndex:
    """Where each packed composite row's factors lie, for working on its
    own columns alone.  Row i (of F*K, field-major) owns the columns
    [offs[i], offs[i] + ranks[i]) of U_all and the same rows of W_all; its
    t2 sum runs over the COMP_BLOCK-aligned blocks that cover them: slots
    [first[i] * COMP_BLOCK, (first[i] + nblk[i]) * COMP_BLOCK) of ``cols``
    (the column of each slot, ``valid`` where it is the row's own)."""
    offs: np.ndarray          # (F*K,) int64
    ranks: np.ndarray         # (F*K,) int64
    row_of_col: torch.Tensor  # (Rtot,) the row owning each column (0: none)
    cols: torch.Tensor        # (S,) a column for each slot (0 where not valid)
    valid: torch.Tensor       # (S,) bool
    first: torch.Tensor       # (F*K,) the row's first block of slots
    nblk: torch.Tensor        # (F*K, 1) its number of blocks
    nb_max: int


def packed_index(pmask: np.ndarray, device=None) -> PackedIndex:
    """The PackedIndex of a block-diagonal 0/1 mask in row order
    (``build_packed_composites``; a shard's cut, ``build_sharded``, may
    leave columns of no row between two rows' blocks); raises ValueError
    for another form."""
    mask = np.asarray(pmask)
    ranks = (mask != 0).sum(axis=1).astype(np.int64)
    offs = np.argmax(mask != 0, axis=1).astype(np.int64)
    want = np.zeros_like(mask)
    cols, valid, first, nblk = [], [], [], []
    for i, (o, r) in enumerate(zip(offs, ranks)):
        want[i, o:o + r] = 1
        b0 = o - o % COMP_BLOCK
        b1 = -(-(o + r) // COMP_BLOCK) * COMP_BLOCK
        c = np.arange(b0, b1)
        first.append(sum(nblk))
        nblk.append((b1 - b0) // COMP_BLOCK)
        ok = (c >= o) & (c < o + r)
        cols.append(np.where(ok, c, 0))
        valid.append(ok)
    if (not np.array_equal(mask, want) or (ranks < 1).any()
            or (offs[1:] < offs[:-1] + ranks[:-1]).any()):
        raise ValueError("packed composite mask is not block-diagonal in "
                         "row order")
    # the row owning each column (0 for a column of none: its z is unused)
    row_of_col = np.zeros(mask.shape[1], np.int64)
    for i, (o, r) in enumerate(zip(offs, ranks)):
        row_of_col[o:o + r] = i
    t = lambda a, dt: torch.as_tensor(np.asarray(a), dtype=dt, device=device)
    return PackedIndex(
        offs=offs, ranks=ranks,
        row_of_col=t(row_of_col, torch.int64),
        cols=t(np.concatenate(cols), torch.int64),
        valid=t(np.concatenate(valid), torch.bool),
        first=t(first, torch.int64), nblk=t(np.reshape(nblk, (-1, 1)),
                                            torch.int64),
        nb_max=int(max(nblk)))


@dataclass
class Fast2Const:
    """Time-constant tensors of the uniform fold."""
    zd: torch.Tensor       # (7, F, Y, X) zonal diffusion [m3,m2,m1,c,p1,p2,p3]
    zam: torch.Tensor      # (8, F, Y, X) zonal advection wind multipliers
    mer: torch.Tensor      # (9, F, Y, X) meridional constants/multipliers
    wz: torch.Tensor       # (F, Y, X) outer diffusion weight
    band: torch.Tensor     # (Y, 1) bool — rows whose zonal increments clamp
    pcomp: torch.Tensor    # dense composites (F, K, X, X); placeholder else
    pcu: torch.Tensor      # packed: (X, Rtot) U_all; placeholder else
    pcw: torch.Tensor      # packed: (Rtot, X) W_all; placeholder else
    pmask: torch.Tensor    # packed: (F*K, Rtot) 0/1 block mask
    pidx: Optional[PackedIndex] = None   # packed: pmask's blocks


# the (Y, X) planes Fast2Const holds for each transported field: zd's 7,
# zam's 8, mer's 9 and wz (diag/memory.py budgets the fold by it)
N_COEF_PLANES = 7 + 8 + 9 + 1


@dataclass
class Fast2Coeffs:
    """One step's assembled coefficients."""
    za: torch.Tensor       # (7, F, Y, X) zonal advection [m3,...,p3]
    mc: torch.Tensor       # (4, F, Y, X) meridional [km2,km1,kp1,kp2]
    c0m: torch.Tensor      # (F, Y, X) meridional centre


def step_coeffs(u: torch.Tensor, v: torch.Tensor, const: Fast2Const,
                plan: FastPlan) -> Fast2Coeffs:
    """Assemble one forcing step's wind-dependent coefficients
    (sign splits per src/greb.f90:203-216)."""
    zero = torch.zeros((), dtype=u.dtype, device=u.device)
    u_m = torch.maximum(u, zero)
    u_p = torch.minimum(u, zero)
    v_m = torch.maximum(v, zero)
    v_p = torch.minimum(v, zero)
    a = const.zam
    za = torch.stack([
        a[_ZA_M3] * u_m,
        a[_ZA_M2] * u_m,
        a[_ZA_M1] * u_m,
        a[_ZA_CM] * u_m + a[_ZA_CP] * u_p,
        a[_ZA_P1] * u_p,
        a[_ZA_P2] * u_p,
        a[_ZA_P3] * u_p,
    ])
    m = const.mer
    mc = torch.stack([
        m[_MAM2] * v_m,
        m[_MD_KM1] + m[_MAM1] * v_m,
        m[_MD_KP1] + m[_MAP1] * v_p,
        m[_MAP2] * v_p,
    ])
    c0m = m[_C0_MD] + m[_MA0M] * v_m + m[_MA0P] * v_p
    return Fast2Coeffs(za=za, mc=mc, c0m=c0m)


# ---------------------------------------------------------------------------
# construction (NumPy float64, float32 results)
# ---------------------------------------------------------------------------
def build_packed_composites(pdc64: np.ndarray, n_extra: np.ndarray,
                            ktc: int, kbc: int, F: int, B: int, X: int,
                            tol: float = v1.LOWRANK_TOL):
    """Block-diagonal packed SVD composites: per-(field,row) adaptive-rank
    factors concatenated along one axis, so the composite block applies as
    t2 = ((T @ U_all) * mask) @ W_all.

    Returns (U_all (X, Rtot) f32, W_all (Rtot, X) f32, mask (F*K, Rtot))."""
    rows_fb, pc64 = v1.composite_mats(pdc64, n_extra, ktc, kbc, F, B, X)
    K = ktc + kbc
    ublocks, wblocks, ranks = [], [], []
    for f in range(F):
        for k in range(K):
            b = k if k < ktc else B - K + k
            uu, s, vt = np.linalg.svd(pc64[(f, b)])
            r = max(1, int((s > tol * s[0]).sum()))
            ublocks.append(uu[:, :r] * s[:r])
            wblocks.append(vt[:r])
            ranks.append(r)
    rtot = sum(ranks)
    u_all = np.concatenate(ublocks, axis=1).astype(F32)
    w_all = np.concatenate(wblocks, axis=0).astype(F32)
    mask = np.zeros((F * K, rtot), F32)
    off = 0
    for i, r in enumerate(ranks):
        mask[i, off:off + r] = 1.0
        off += r
    return u_all, w_all, mask


def build_const(wz_air: np.ndarray, wz_vapor: np.ndarray, grid: Grid,
                st: stc.StencilStatic, kappa: float, device=None,
                plan: Optional[FastPlan] = None,
                ) -> Tuple[FastPlan, Fast2Const]:
    """Precompute the uniform constant coefficient fields (float64 builds,
    float32 results), as ``greb_tpu.ops.fastcirc2.build_const``."""
    if plan is None:
        plan = v1.make_plan(grid)
    Y, X = plan.ydim, plan.xdim
    wz2 = np.stack([np.asarray(wz_air, F64), np.asarray(wz_vapor, F64)])
    F = wz2.shape[0]

    w = v1._np_lon_shifts(wz2)
    col = lambda a: np.asarray(a, F64).reshape(Y, 1)
    dtc = F64(F32(st.dt_crcl))
    kap = F64(F32(kappa))
    dyy = F64(F32(st.dyy))
    polar = np.asarray(grid.polar_rows, bool).reshape(Y, 1)

    # --- zonal diffusion: one coefficient per row, no outer wz -------------
    # interior rows: cc = kappa*dt_crcl/dxlat^2 (src/greb.f90:582)
    # polar rows:    cc = kappa*dtdff2/dxlat^2  (:654)
    cc_in = kap * dtc / col(grid.dxlat.astype(F64) ** 2)
    cc_po = kap * col(grid.diff_sched.dtdff2) / col(grid.dxlat.astype(F64) ** 2)
    ccd = np.where(polar, cc_po, cc_in) / 20.0
    zd = np.stack([
        ccd * w["m3"],
        ccd * (3.0 * w["m2"] - w["m3"]),
        ccd * (6.0 * w["m1"] - 3.0 * w["m2"]),
        ccd * (-6.0 * (w["m1"] + w["p1"])),
        ccd * (6.0 * w["p1"] - 3.0 * w["p2"]),
        ccd * (3.0 * w["p2"] - w["p3"]),
        ccd * w["p3"],
    ])

    # --- zonal advection wind multipliers -----------------------------------
    # interior rows: 2-point upwind /3 (src/greb.f90:798-836)
    cax = col(np.asarray(grid.ccx_adv, F64)) / 3.0
    # polar rows: 10/4/1 smooth3 /20 with static ccx2 (:842-906) + jp2 quirk
    ca = col(grid.adv_sched.ccx2) / 20.0
    if st.quirk_jp2:
        qcol = (np.arange(X) == X - 3)              # Fortran j = xdim-2 (:881)
        wp2q = np.where(qcol, w["p1"], w["p2"])
    else:
        qcol = np.zeros(X, bool)
        wp2q = w["p2"]
    pp1 = ca * (-10.0 * w["p1"] + 4.0 * wp2q)
    pp2q = ca * (-4.0 * wp2q + w["p3"])
    zam = np.zeros((8, F, Y, X))
    zam[_ZA_M3] = np.where(polar, ca * w["m3"], 0.0)
    zam[_ZA_M2] = np.where(polar, ca * (4.0 * w["m2"] - w["m3"]), cax * w["m2"])
    zam[_ZA_M1] = np.where(polar, ca * (10.0 * w["m1"] - 4.0 * w["m2"]),
                           cax * w["m1"])
    zam[_ZA_CM] = np.where(polar, -10.0 * ca * w["m1"],
                           -cax * (w["m1"] + w["m2"]))
    zam[_ZA_CP] = np.where(polar, 10.0 * ca * w["p1"],
                           cax * (w["p1"] + w["p2"]))
    zam[_ZA_P1] = np.where(polar, pp1 + np.where(qcol, pp2q, 0.0),
                           -cax * w["p1"])
    zam[_ZA_P2] = np.where(polar, np.where(qcol, 0.0, pp2q), -cax * w["p2"])
    zam[_ZA_P3] = np.where(polar, -ca * w["p3"], 0.0)

    # --- meridional (diffusion parts carry the outer wz) --------------------
    ccy = kap * dtc / dyy ** 2
    wzm1 = v1._np_lat_shift(wz2, -1)
    wzm2 = v1._np_lat_shift(wz2, -2)
    wzp1 = v1._np_lat_shift(wz2, 1)
    wzp2 = v1._np_lat_shift(wz2, 2)
    ccy2 = dtc / dyy / 2.0
    rows = np.arange(Y).reshape(Y, 1)
    am = np.where(rows == 1, ccy2, ccy2 / 3.0)
    ap = np.where(rows == Y - 2, ccy2, ccy2 / 3.0)
    mer = np.zeros((9, F, Y, X))
    mer[_MD_KM1] = ccy * wzm1 * wz2
    mer[_MD_KP1] = ccy * wzp1 * wz2
    mer[_C0_MD] = -ccy * (wzm1 + wzp1) * wz2
    mer[_MAM2] = am * wzm2
    mer[_MAM1] = am * wzm1
    mer[_MAP1] = -ap * wzp1
    mer[_MAP2] = -ap * wzp2
    mer[_MA0M] = -am * (wzm1 + wzm2)
    mer[_MA0P] = ap * (wzp1 + wzp2)

    # --- composites of the extra diffusion iterations ------------------------
    B = plan.nband
    pcomp = np.zeros((1, 1, 1, 1), F32)
    pcu = np.zeros((1, 1), F32)
    pcw = np.zeros((1, 1), F32)
    pmask = np.zeros((1, 1), F32)
    if B and plan.diff_composite:
        bidx = np.r_[np.arange(plan.bt), np.arange(Y - plan.bb, Y)]
        pdc64 = zd[:, :, bidx, :]                   # (7, F, B, X)
        n_extra = np.asarray(grid.diff_sched.time2)[bidx] - 1
        if plan.comp_mode == "lowrank":
            pcu, pcw, pmask = build_packed_composites(
                pdc64, n_extra, plan.comp_kt, plan.comp_kb, F, B, X)
            plan = dataclasses.replace(plan, comp_mode="packed")
        else:
            pcomp = v1.build_composites(pdc64, n_extra, plan, F, B, X)

    band = np.zeros((Y, 1), bool)
    band[:plan.bt] = True
    if plan.bb:
        band[Y - plan.bb:] = True

    t = lambda a: torch.as_tensor(np.asarray(a), device=device)
    const = Fast2Const(
        zd=t(zd.astype(F32)), zam=t(zam.astype(F32)), mer=t(mer.astype(F32)),
        wz=t(wz2.astype(F32)), band=t(band), pcomp=t(pcomp), pcu=t(pcu),
        pcw=t(pcw), pmask=t(pmask),
        pidx=(packed_index(pmask, device) if plan.comp_mode == "packed"
              else None))
    return plan, const


# ---------------------------------------------------------------------------
# apply (eager PyTorch)
# ---------------------------------------------------------------------------
def _tree(terms):
    """The sum of the 7 terms [c, m3, m2, m1, p1, p2, p3] as the JAX
    package's balanced tree: ((c + m3) + (m2 + m1)) + ((p1 + p2) + p3)."""
    while len(terms) > 1:
        nxt = [terms[k] + terms[k + 1] for k in range(0, len(terms) - 1, 2)]
        if len(terms) % 2:
            nxt.append(terms[-1])
        terms = nxt
    return terms[0]


def _bf16(t: torch.Tensor) -> torch.Tensor:
    """t rounded to bfloat16 (to nearest, ties to even), as float32."""
    return t.to(torch.bfloat16).to(torch.float32)


def _apply7_rolled(rolls, x, coef, precision: str = "highest"):
    """sum_s coef[s] * roll(x, s) with the 6 rolls shared, summed in
    ``_tree``'s order.  ``precision="bf16_3x"``: the member kernels'
    matmul circulation (``MxuTwin``), each product split as ``_dot_b``
    splits it, hi*hi, hi*lo and lo*hi of bfloat16 parts (each exact in
    float32), the three sums added in _dot_b's order."""
    coefs = [coef[3]] + [coef[i] for i, _ in _LON_IDX_SHIFT]
    taps = [x] + list(rolls)
    if precision == "highest":
        return _tree([c * t for c, t in zip(coefs, taps)])
    th = [_bf16(t) for t in taps]
    tl = [_bf16(t - h) for t, h in zip(taps, th)]
    ch = [_bf16(c) for c in coefs]
    cl = [_bf16(c - h) for c, h in zip(coefs, ch)]
    hh = _tree([a * b for a, b in zip(th, ch)])
    hl = _tree([a * b for a, b in zip(th, cl)])
    lh = _tree([a * b for a, b in zip(tl, ch)])
    return (hh + hl) + lh


def _masked_clamp(d, x, band):
    """Positivity clamp on band rows only (src/greb.f90:715, :907):
    where(band & (d <= -x)) d = -0.9*x."""
    return torch.where(band & (d <= -x), F32(-0.9) * x, d)


def _row_dot(t_row: torch.Tensor, pmat: torch.Tensor) -> torch.Tensor:
    """(..., N) x (N, Z): out[j] = sum_i t[i] * P[i, j], with no library
    matmul on the state path.  The sum runs in a fixed order that the CUDA
    year kernel repeats: in sequence within each block of COMP_BLOCK
    consecutive i, then over the blocks in sequence (the last block padded
    with exact zeros)."""
    return _blocked_sum(t_row.unsqueeze(-1) * pmat)


def _block_partials(prod: torch.Tensor) -> torch.Tensor:
    """(..., N, Z) -> (..., nb, Z): the sums of each block of COMP_BLOCK
    consecutive n, in sequence (the last block padded with exact zeros)."""
    n = prod.shape[-2]
    nb = -(-n // COMP_BLOCK)
    if nb * COMP_BLOCK != n:
        prod = tnf.pad(prod, (0, 0, 0, nb * COMP_BLOCK - n))
    prod = prod.reshape(prod.shape[:-2] + (nb, COMP_BLOCK, prod.shape[-1]))
    part = prod[..., 0, :]
    for i in range(1, COMP_BLOCK):
        part = part + prod[..., i, :]
    return part


def _blocked_sum(prod: torch.Tensor) -> torch.Tensor:
    """(..., N, Z) -> (..., Z): the sum over N in _row_dot's order."""
    part = _block_partials(prod)
    out = part[..., 0, :]
    for b in range(1, part.shape[-2]):
        out = out + part[..., b, :]
    return out


def _packed_comp(x, dd, const: Fast2Const, plan: FastPlan):
    """Packed block-diagonal composites (comp_mode "packed"):
    t2 = ((T @ U_all) * mask) @ W_all, clamped once against the composite
    result (src/greb.f90:715 semantics).  Each row works on its own
    columns (``PackedIndex``): z = t1 U_all[:, own] in _row_dot's order,
    then t2 = z W_all[own, :] over the COMP_BLOCK-aligned blocks that hold
    them, in _row_dot's order with zeros in the blocks' other slots.  The
    full masked products' other terms are exact zeros, and adding a zero
    changes no sum but the sign of a zero, so the result is theirs."""
    Y = plan.ydim
    ktc, kbc = plan.comp_kt, plan.comp_kb
    X = x.shape[-1]
    x_slab = torch.cat([x[..., :ktc, :], x[..., Y - kbc:, :]], dim=-2)
    d_slab = torch.cat([dd[..., :ktc, :], dd[..., Y - kbc:, :]], dim=-2)
    t1 = x_slab + d_slab                              # (..., F, K, X)
    lead = t1.shape[:-3]
    fk = t1.shape[-3] * t1.shape[-2]
    flat = t1.reshape(lead + (fk, X))
    pi = const.pidx
    # z[c] = sum_i t1[row(c), i] * U_all[i, c], blocked over i; the
    # products laid out as U_all (X, Rtot), so the multiply and the sums
    # read memory in order (at 768x384 Rtot is ~12,900)
    rows = torch.index_select(flat.transpose(-1, -2).contiguous(), -1,
                              pi.row_of_col)              # (..., X, Rtot)
    z = _blocked_sum(rows * const.pcu)                    # (..., Rtot)
    zs = torch.where(pi.valid, z[..., pi.cols], 0.0)      # (..., S)
    part = _block_partials(zs.unsqueeze(-1)
                           * torch.index_select(const.pcw, 0, pi.cols))
    # each row's block sums in sequence, from its first block
    t2 = part[..., pi.first, :]
    last = part.shape[-2] - 1
    for b in range(1, pi.nb_max):
        nxt = part[..., (pi.first + b).clamp(max=last), :]
        t2 = torch.where(pi.nblk > b, t2 + nxt, t2)
    t2 = t2.reshape(t1.shape)
    t1 = t1 + v1._clamped(t2 - t1, t1)
    dcomp = t1 - x_slab
    return torch.cat([dcomp[..., :ktc, :], dd[..., ktc:Y - kbc, :],
                      dcomp[..., ktc:, :]], dim=-2)


def _extra_diffusion(x, dd, const: Fast2Const, plan: FastPlan,
                     row_dot=None):
    """Extra sub-cycle iterations for rows with diffusion time2 > 1: the
    explicit prefix/suffix segments (past the composite rows), then the
    composite rows, whose dense products take ``row_dot`` (default
    ``_row_dot``'s blocked order).  Returns the updated full-field dd."""
    row_dot = row_dot or _row_dot
    Y = plan.ydim
    ktc, kbc = plan.comp_kt, plan.comp_kb

    def seg_iter(dd, r0, r1, iters):
        t1 = x[..., r0:r1, :] + dd[..., r0:r1, :]
        t1 = v1._iterate(t1, const.zd[:, :, r0:r1, :], iters)
        return torch.cat([dd[..., :r0, :], t1 - x[..., r0:r1, :],
                          dd[..., r1:, :]], dim=-2)

    # segments are cumulative levels on nested prefixes/suffixes: apply in
    # order, carrying dd
    for kt, kb, iters in plan.diff_segs:
        if kt:
            dd = seg_iter(dd, ktc, ktc + kt, iters)
        if kb:
            dd = seg_iter(dd, Y - kbc - kb, Y - kbc, iters)

    if not plan.diff_composite:
        return dd
    if plan.comp_mode == "packed":
        return _packed_comp(x, dd, const, plan)

    def comp_rows(r0, n, k0):
        """Composite rows [r0, r0+n) of every field at once."""
        t1 = x[..., r0:r0 + n, :] + dd[..., r0:r0 + n, :]   # (..., F, n, X)
        t2 = row_dot(t1, const.pcomp[:, k0:k0 + n])
        t1 = t1 + v1._clamped(t2 - t1, t1)
        return t1 - x[..., r0:r0 + n, :]

    slabs = []
    if ktc:
        slabs.append(comp_rows(0, ktc, 0))
    slabs.append(dd[..., ktc:Y - kbc, :])
    if kbc:
        slabs.append(comp_rows(Y - kbc, kbc, ktc))
    return torch.cat(slabs, dim=-2)


def _extra_advection(x, da, cf: Fast2Coeffs, plan: FastPlan):
    """Extra advection sub-cycle iterations (adv_segs; empty at 96x48)."""
    Y = plan.ydim
    for kt, kb, iters in plan.adv_segs:
        if kt:
            t1 = x[..., :kt, :] + da[..., :kt, :]
            t1 = v1._iterate(t1, cf.za[:, :, :kt, :], iters)
            da = torch.cat([t1 - x[..., :kt, :], da[..., kt:, :]], dim=-2)
        if kb:
            t1 = x[..., Y - kb:, :] + da[..., Y - kb:, :]
            t1 = v1._iterate(t1, cf.za[:, :, Y - kb:, :], iters)
            da = torch.cat([da[..., :Y - kb, :], t1 - x[..., Y - kb:, :]],
                           dim=-2)
    return da


def extend_lat_zero(x: torch.Tensor, width: int) -> torch.Tensor:
    """Meridional halo: zeros beyond the poles (one-sided forms)."""
    return tnf.pad(x, (0, 0, width, width))


def substep(x: torch.Tensor, cf: Fast2Coeffs, const: Fast2Const,
            plan: FastPlan, extend=extend_lat_zero,
            precision: str = "highest") -> torch.Tensor:
    """One dt_crcl circulation substep on the (..., F, Y, X) stacked field.
    ``extend(x, 2)`` gives the meridional halo: zeros past the poles, or a
    shard's neighbour rows (parallel/halo.py).  ``precision`` of the two
    zonal applies (``_apply7_rolled``): "highest" the fold's exact float32,
    "bf16_3x" the split of the member kernels' matmul circulation."""
    Y = x.shape[-2]
    rolls = [torch.roll(x, s, dims=-1) for _, s in _LON_IDX_SHIFT]
    band = const.band

    # zonal diffusion (clamped on band rows), then extra iterations
    dd = _apply7_rolled(rolls, x, const.zd, precision)
    dd = _masked_clamp(dd, x, band)
    dd = _extra_diffusion(x, dd, const, plan)

    # zonal advection (clamped on band rows); extension grids advect the
    # zonally-diffused state
    if plan.seq_zonal:
        xa = x + const.wz * dd
        rolls_a = [torch.roll(xa, s, dims=-1) for _, s in _LON_IDX_SHIFT]
    else:
        xa, rolls_a = x, rolls
    da = _apply7_rolled(rolls_a, xa, cf.za, precision)
    da = _masked_clamp(da, xa, band)
    da = _extra_advection(xa, da, cf, plan)

    # meridional diffusion+advection, merged (never clamped; reads the
    # substep's initial state)
    xe = extend(x, 2)
    dy = cf.c0m * x
    dy = dy + cf.mc[0] * xe[..., 0:Y, :]        # km2
    dy = dy + cf.mc[1] * xe[..., 1:Y + 1, :]    # km1
    dy = dy + cf.mc[2] * xe[..., 3:Y + 3, :]    # kp1
    dy = dy + cf.mc[3] * xe[..., 4:Y + 4, :]    # kp2

    if plan.seq_zonal:
        return xa + da + dy
    return x + const.wz * dd + da + dy


def circulation(x: torch.Tensor, cf: Fast2Coeffs, const: Fast2Const,
                plan: FastPlan, nsub: int, extend=extend_lat_zero,
                precision: str = "highest") -> torch.Tensor:
    """Sub-cycled circulation increment over one 12-h step (``precision``:
    ``substep``'s)."""
    xc = x
    for _ in range(nsub):
        xc = substep(xc, cf, const, plan, extend, precision)
    return xc - x


# ---------------------------------------------------------------------------
# the matmul ("MXU") circulation (``greb_tpu.ops.fastcirc2`` MxuConst,
# build_mxu, adv_matrix, _row_matmul, mxu_substep_stacked, mxu_circulation;
# MxuMembers, build_mxu_members, _dot_b, mxu_members_circulation)
# ---------------------------------------------------------------------------
# Each zonal apply is a row vector times an (X, X) banded matrix that the
# members share: build_mxu densifies the 7 diffusion coefficients of each
# (field, row), adv_matrix a step's 7 advection coefficients, exactly (each
# output column has 7 non-zero entries, the rest exact zeros).  The two
# forms here are the plain PyTorch versions of greb_tpu's, with its
# library products (torch.bmm / torch.matmul in float32, TF32 off).
# Precision: greb_tpu's "high" is XLA's Precision.HIGH, bf16_3x on the TPU
# and exact float32 on XLA:CPU; the port gives it the one meaning greb_tpu
# documents, the explicit 3-pass bfloat16 split of _dot_b, on every
# device; "highest" is exact float32.  greb_tpu's "pair" and "fused" modes
# are not ported (MXU_NOT_PORTED), nor the pair form that mxu_circulation
# takes for sequential zonal splitting, nor the member form at plans with
# explicit segments or without dense composites (MXU_PLAN_ITEM).
#
# The member kernels (ops/cuda/multiyear.py, csrc/members_kernel.cu) run
# mxu_members_circulation's function with the dense dot evaluated over its
# 7 non-zero terms a column, from the fold's zd and the step's za, summed
# in the fold's balanced order (``_tree``), at "bf16_3x" each term split
# as _dot_b splits it.  Their plain twin is ``circulation(...,
# precision=...)``, reached through a fold tuple whose third element is an
# ``MxuTwin``.

# where what is not ported is queued
MXU_NOT_PORTED = "ROADMAP Queue 1, 'Not to port'"
MXU_PLAN_ITEM = "ROADMAP Queue 1 item 4b"
MXU_MODES = ("stacked",)
MXU_PRECISIONS = ("high", "highest")
MEMBER_PRECISIONS = ("bf16_3x", "highest")


@dataclass
class MxuConst:
    """Constants of the matmul circulation (greb_tpu's MxuConst): the dense
    zonal-diffusion row matrices and the one-hot shift tensors that densify
    a step's advection coefficients."""
    zd_mat: torch.Tensor     # (F, Y, X, X)
    shift1h: torch.Tensor    # (7, X, X)
    precision: str = "high"  # "high": bf16_3x (_dot_b); "highest": exact
    mode: str = "stacked"    # one (X, 2X) product a substep


def build_mxu(const: Fast2Const, plan: FastPlan, precision: str = "high",
              mode: str = "stacked") -> MxuConst:
    """The dense row matrices of the fold's zd and the shift tensors, on
    zd's device.  ``mode`` "pair" and "fused" raise NotImplementedError
    (MXU_NOT_PORTED): greb_tpu's default is "pair", the port's the one
    mode it runs."""
    if precision not in MXU_PRECISIONS:
        raise ValueError(f"precision {precision!r}: one of {MXU_PRECISIONS}")
    if mode not in MXU_MODES:
        raise NotImplementedError(
            f"build_mxu mode={mode!r}: the port runs mode 'stacked' only "
            f"({MXU_NOT_PORTED})")
    zd = const.zd.detach().cpu().numpy()            # (7, F, Y, X)
    _, F, Y, X = zd.shape
    jout = np.arange(X)
    zmat = np.zeros((F, Y, X, X), np.float32)
    zmat[:, :, jout, jout] = zd[3]
    for i, s in _LON_IDX_SHIFT:
        zmat[:, :, (jout - s) % X, jout] += zd[i]
    sh = np.zeros((7, X, X), np.float32)
    sh[3, jout, jout] = 1.0
    for i, s in _LON_IDX_SHIFT:
        sh[i, (jout - s) % X, jout] = 1.0
    dev = const.zd.device
    return MxuConst(zd_mat=torch.as_tensor(zmat, device=dev),
                    shift1h=torch.as_tensor(sh, device=dev),
                    precision=precision, mode=mode)


def adv_matrix(za: torch.Tensor, mxu) -> torch.Tensor:
    """One step's advection coefficients (7, F, Y, X) densified into
    (F, Y, X, X) row matrices through the one-hot shift tensors: each entry
    is one coefficient plus exact zeros, so the sum is exact."""
    out = None
    for s in range(7):
        term = za[s][:, :, None, :] * mxu.shift1h[s]
        out = term if out is None else out + term
    return out


def _dot_b(x: torch.Tensor, mat: torch.Tensor, precision: str) -> torch.Tensor:
    """(B, M, X) x (B, X, Z) batched over B.  "bf16_3x": the 3-pass
    bfloat16 split, hi@hi + hi@lo + lo@hi, each product of two bfloat16
    values exact in float32, summed by the float32 library product;
    "highest": one exact float32 product."""
    if precision == "bf16_3x":
        xh = _bf16(x)
        xl = _bf16(x - xh)
        mh = _bf16(mat)
        ml = _bf16(mat - mh)
        return (torch.bmm(xh, mh) + torch.bmm(xh, ml)) + torch.bmm(xl, mh)
    if precision != "highest":
        raise ValueError(f"precision {precision!r}: one of "
                         f"{MEMBER_PRECISIONS}")
    return torch.bmm(x, mat)


def _row_matmul(x: torch.Tensor, mat: torch.Tensor,
                precision: str = "high") -> torch.Tensor:
    """(..., F, Y, X) x (F, Y, X, Z) batched over the (F, Y) rows: "high"
    through _dot_b's bf16_3x split, "highest" exact float32."""
    F, Y, X = x.shape[-3:]
    lead = x.shape[:-3]
    xb = x.reshape((-1, F * Y, X)).transpose(0, 1)          # (FY, L, X)
    out = _dot_b(xb, mat.reshape(F * Y, X, -1),
                 "bf16_3x" if precision == "high" else precision)
    return out.transpose(0, 1).reshape(lead + (F, Y, out.shape[-1]))


def _meridional(x: torch.Tensor, cf: Fast2Coeffs) -> torch.Tensor:
    """The merged meridional step of the (..., F, Y, X) field, zeros past
    the poles, summed in sequence."""
    Y = x.shape[-2]
    xe = extend_lat_zero(x, 2)
    dy = cf.c0m * x
    dy = dy + cf.mc[0] * xe[..., 0:Y, :]
    dy = dy + cf.mc[1] * xe[..., 1:Y + 1, :]
    dy = dy + cf.mc[2] * xe[..., 3:Y + 3, :]
    dy = dy + cf.mc[3] * xe[..., 4:Y + 4, :]
    return dy


def _library_row_dot(t_row: torch.Tensor, pmat: torch.Tensor) -> torch.Tensor:
    """(..., F, n, X) x (F, n, X, Z): each (field, row)'s (L, X) x (X, Z)
    float32 library product, as greb_tpu's _row_dot (jnp.dot at HIGHEST)."""
    F, n, X = t_row.shape[-3:]
    lead = t_row.shape[:-3]
    rows = [[torch.matmul(t_row[..., f, j, :].reshape(-1, X), pmat[f, j])
             for j in range(n)] for f in range(F)]
    out = torch.stack([torch.stack(r, dim=-2) for r in rows], dim=-3)
    return out.reshape(lead + (F, n, pmat.shape[-1]))


def mxu_substep_stacked(x: torch.Tensor, cf: Fast2Coeffs,
                        dz_mat: torch.Tensor, const: Fast2Const,
                        mxu: MxuConst, plan: FastPlan) -> torch.Tensor:
    """One substep with both zonal applies in one (X, 2X)-output product
    (out[..., :X] diffusion, [..., X:] advection), then the clamps, the
    composite rows and segments, the meridional step and the combine."""
    X = x.shape[-1]
    both = _row_matmul(x, dz_mat, mxu.precision)
    dd = _masked_clamp(both[..., :X], x, const.band)
    dd = _extra_diffusion(x, dd, const, plan, _library_row_dot)
    da = _masked_clamp(both[..., X:], x, const.band)
    da = _extra_advection(x, da, cf, plan)
    return x + const.wz * dd + da + _meridional(x, cf)


def mxu_circulation(x: torch.Tensor, cf: Fast2Coeffs, const: Fast2Const,
                    mxu: MxuConst, plan: FastPlan,
                    nsub: int) -> torch.Tensor:
    """Sub-cycled circulation increment, matmul form (greb_tpu's
    mxu_circulation in mode "stacked").  A plan with sequential zonal
    splitting, which greb_tpu runs in the pair form, raises
    NotImplementedError (MXU_PLAN_ITEM)."""
    if plan.seq_zonal:
        raise NotImplementedError(
            f"mxu_circulation: sequential zonal splitting takes greb_tpu's "
            f"pair form, not ported ({MXU_PLAN_ITEM})")
    if mxu.mode not in MXU_MODES:
        raise NotImplementedError(f"mxu_circulation mode={mxu.mode!r} "
                                  f"({MXU_NOT_PORTED})")
    dz_mat = torch.cat([mxu.zd_mat, adv_matrix(cf.za, mxu)], dim=-1)
    xc = x
    for _ in range(nsub):
        xc = mxu_substep_stacked(xc, cf, dz_mat, const, mxu, plan)
    return xc - x


@dataclass
class MxuMembers:
    """Constants of the member-batched matmul circulation (greb_tpu's
    MxuMembers): build_mxu's matrices and the precision, "bf16_3x" or
    "highest"."""
    zd_mat: torch.Tensor     # (F, Y, X, X)
    shift1h: torch.Tensor    # (7, X, X)
    precision: str = "bf16_3x"


@dataclass(frozen=True)
class MxuTwin:
    """The third element of a fold tuple that runs the member kernels'
    matmul circulation in their own order (``circulation`` at
    ``precision``): their plain twin."""
    precision: str = "bf16_3x"


def members_covered(plan) -> bool:
    """Whether the member-batched matmul circulation runs ``plan``: a fold
    with no explicit segments, dense composites and additive splitting
    (greb_tpu's asserts, fastcirc2.py:792-794: its 96x48-class plans)."""
    return (isinstance(plan, FastPlan) and plan.diff_segs == ()
            and plan.adv_segs == () and plan.comp_mode == "dense"
            and not plan.seq_zonal)


def check_members_plan(plan) -> None:
    """NotImplementedError where ``members_covered`` does not hold."""
    if not members_covered(plan):
        what = (f"segments {plan.diff_segs}, {plan.adv_segs}, composites "
                f"{plan.comp_mode!r}, seq_zonal {plan.seq_zonal}"
                if isinstance(plan, FastPlan) else "no fold")
        raise NotImplementedError(
            f"the member-batched matmul circulation runs segment-free plans "
            f"with dense composites and additive splitting, not this one "
            f"({what}; {MXU_PLAN_ITEM})")


def build_mxu_members(const: Fast2Const, plan: FastPlan,
                      precision: str = "bf16_3x") -> MxuMembers:
    if precision not in MEMBER_PRECISIONS:
        raise ValueError(f"precision {precision!r}: one of "
                         f"{MEMBER_PRECISIONS}")
    base = build_mxu(const, plan, precision="highest")
    return MxuMembers(zd_mat=base.zd_mat, shift1h=base.shift1h,
                      precision=precision)


def mxu_members_circulation(x2: torch.Tensor, cf: Fast2Coeffs,
                            const: Fast2Const, mm: MxuMembers,
                            plan: FastPlan, nsub: int) -> torch.Tensor:
    """Sub-cycled circulation increment of (..., F, Y, X) members (the
    leading axes are the batch MB), greb_tpu's member-batched form: the
    state as (F*Y, MB, X) rows, one (FY, MB, X) @ (FY, X, 2X) product a
    substep (_dot_b at ``mm.precision``), the band clamps, the dense pole
    composites as exact float32 row products, the meridional step and the
    combine.  Raises NotImplementedError where ``members_covered`` does not
    hold (greb_tpu asserts)."""
    check_members_plan(plan)
    Fd, Y, X = x2.shape[-3:]
    lead = x2.shape[:-3]
    MB = int(np.prod(lead)) if lead else 1
    za_mat = adv_matrix(cf.za, mm)
    dzr = torch.cat([mm.zd_mat, za_mat], dim=-1).reshape(Fd * Y, X, 2 * X)
    band_m = const.band.repeat(Fd, 1)[..., None]             # (FY, 1, 1)
    wz_m = const.wz.reshape(Fd * Y, 1, X)
    c0m_m = cf.c0m[:, :, None, :]                            # (F, Y, 1, X)
    mc_m = cf.mc[:, :, :, None, :]                           # (4, F, Y, 1, X)
    kt, kb = plan.comp_kt, plan.comp_kb
    neg = F32(-0.9)

    def substep(xf):                                         # (FY, MB, X)
        both = _dot_b(xf, dzr, mm.precision)
        dd = torch.where(band_m & (both[..., :X] <= -xf), neg * xf,
                         both[..., :X])
        segs = []
        for f in range(Fd):
            base = f * Y

            def comp_one(r, k):
                t1 = xf[base + r] + dd[base + r]             # (MB, X)
                t2 = torch.matmul(t1, const.pcomp[f, k])
                t1 = t1 + v1._clamped(t2 - t1, t1)
                return (t1 - xf[base + r])[None]

            segs += [comp_one(r, r) for r in range(kt)]
            segs.append(dd[base + kt:base + Y - kb])
            segs += [comp_one(Y - kb + j, kt + j) for j in range(kb)]
        dd = torch.cat(segs, dim=0)
        da = torch.where(band_m & (both[..., X:] <= -xf), neg * xf,
                         both[..., X:])
        xr = xf.reshape(Fd, Y, MB, X)
        xe = tnf.pad(xr, (0, 0, 0, 0, 2, 2))
        dy = c0m_m * xr
        dy = dy + mc_m[0] * xe[:, 0:Y]
        dy = dy + mc_m[1] * xe[:, 1:Y + 1]
        dy = dy + mc_m[2] * xe[:, 3:Y + 3]
        dy = dy + mc_m[3] * xe[:, 4:Y + 4]
        return xf + wz_m * dd + da + dy.reshape(Fd * Y, MB, X)

    x = x2.reshape(MB, Fd, Y, X).permute(1, 2, 0, 3).reshape(Fd * Y, MB, X)
    xc = x
    for _ in range(nsub):
        xc = substep(xc)
    d = (xc - x).reshape(Fd, Y, MB, X).permute(2, 0, 1, 3)
    return d.reshape(lead + (Fd, Y, X))


# ---------------------------------------------------------------------------
# latitude sharding (``greb_tpu.ops.fastcirc2`` ShardPlan, build_sharded,
# sharded_circulation)
# ---------------------------------------------------------------------------
# Every zonal part of a substep is row-local: the applies, the band clamps,
# each composite row, the segments and the sequential splitting; only the
# meridional term reads +-2 rows.  So the unsharded fold, cut into row
# ranges, is each shard's fold: shard i's rows of zd, zam, mer, wz and band,
# the composites of the rows it owns, and a plan whose bands, composite rows
# and segments are its share of the global ones (still a top prefix and a
# bottom suffix of its rows).  Given its 2 halo rows a substep, a shard does
# the unsharded fold's arithmetic row for row, so a sharded run equals the
# unsharded one bit for bit.  greb_tpu's per-shard slot layout (identity-
# padded composite slots, masked advection levels, one SPMD plan for every
# shard) is not ported: it was built for shard_map's one program.

def _rows_in(r0: int, r1: int, a: int, b: int) -> int:
    """Rows of [r0, r1) in [a, b)."""
    return max(0, min(r1, b) - max(r0, a))


@dataclass(frozen=True)
class ShardGeometry:
    """Which of the global plan's rows each of ``n_shards`` shards of
    ``rloc`` rows owns: its composite rows (top ``kct[i]``, bottom
    ``kcb[i]``) and its band rows; from the grid's schedules alone."""
    rloc: int
    kt_g: int                 # global composite rows (top / bottom)
    kb_g: int
    kct: Tuple[int, ...]
    kcb: Tuple[int, ...]
    comp_mode: str            # the global plan's: "dense", "lowrank", "none"

    @property
    def K(self) -> int:
        """The most composite rows one shard owns."""
        return max(t + b for t, b in zip(self.kct, self.kcb))


def _check_shards(Y: int, n_shards: int) -> int:
    """Rows a shard; ValueError where ``n_shards`` does not divide ``Y`` or
    leaves a shard under the 2-row meridional halo."""
    if n_shards < 1 or Y % n_shards or Y // n_shards < 2:
        raise ValueError(f"{n_shards} latitude shards: {Y} rows must split "
                         f"evenly into shards of at least 2 rows")
    return Y // n_shards


def sharded_geometry(grid: Grid, n_shards: int,
                     plan: Optional[FastPlan] = None) -> ShardGeometry:
    """The composite rows of each of ``n_shards`` latitude shards of
    ``grid`` (``plan``: the grid's fold plan, ``fastcirc.make_plan``)."""
    plan = plan if plan is not None else v1.make_plan(grid)
    Y = plan.ydim
    R = _check_shards(Y, n_shards)
    ktc, kbc = plan.comp_kt, plan.comp_kb
    return ShardGeometry(
        rloc=R, kt_g=ktc, kb_g=kbc,
        kct=tuple(_rows_in(i * R, (i + 1) * R, 0, ktc)
                  for i in range(n_shards)),
        kcb=tuple(_rows_in(i * R, (i + 1) * R, Y - kbc, Y)
                  for i in range(n_shards)),
        comp_mode=plan.comp_mode)


def cut_plan(plan: FastPlan, lo: int, hi: int) -> FastPlan:
    """The plan of rows [lo, hi) of ``plan``: its band rows, composite
    rows and segment rows among them (each still a top prefix or a bottom
    suffix of the cut: the composite rows are the outermost, the diffusion
    segments follow them, the advection segments start at the poles)."""
    Y = plan.ydim
    ktc, kbc = plan.comp_kt, plan.comp_kb
    kt = _rows_in(lo, hi, 0, ktc)
    kb = _rows_in(lo, hi, Y - kbc, Y)
    dsegs = tuple(
        (_rows_in(lo, hi, ktc, ktc + a), _rows_in(lo, hi, Y - kbc - b, Y - kbc),
         n) for a, b, n in plan.diff_segs)
    asegs = tuple((_rows_in(lo, hi, 0, a), _rows_in(lo, hi, Y - b, Y), n)
                  for a, b, n in plan.adv_segs)
    return dataclasses.replace(
        plan, ydim=hi - lo, bt=_rows_in(lo, hi, 0, plan.bt),
        bb=_rows_in(lo, hi, Y - plan.bb, Y),
        diff_segs=tuple(s for s in dsegs if s[0] or s[1]),
        adv_segs=tuple(s for s in asegs if s[0] or s[1]),
        comp_mode=plan.comp_mode if kt + kb else "none",
        comp_kt=kt if kt + kb else 0, comp_kb=kb if kt + kb else 0)


def _comp_ks(plan: FastPlan, lo: int, hi: int) -> list:
    """The global composite indices k of rows [lo, hi), in the cut's order
    (its top rows, then its bottom rows)."""
    Y, ktc, kbc = plan.ydim, plan.comp_kt, plan.comp_kb
    return ([r for r in range(lo, min(hi, ktc))]
            + [ktc + r - (Y - kbc) for r in range(max(lo, Y - kbc), hi)])


def cut_const(plan: FastPlan, const: Fast2Const, lo: int, hi: int,
              device=None) -> Fast2Const:
    """Rows [lo, hi) of the fold's tensors, on ``device``: the planes and
    band rows, and the composites of the cut's composite rows (dense: their
    matrices; packed: their factors' columns, each row's at an offset that
    keeps its place in the blocks of COMP_BLOCK terms, so its sums take the
    unsharded order, with columns of no row between discontiguous rows)."""
    dev = device if device is not None else const.zd.device
    rows = lambda a: a[..., lo:hi, :].contiguous().to(dev)
    ks = _comp_ks(plan, lo, hi)
    pcomp, pcu, pcw, pmask, pidx = (const.pcomp, const.pcu, const.pcw,
                                    const.pmask, None)
    if not ks:
        pcomp = torch.zeros((1, 1, 1, 1), dtype=torch.float32)
        pcu = pcw = pmask = torch.zeros((1, 1), dtype=torch.float32)
    elif plan.comp_mode == "packed":
        K = plan.comp_kt + plan.comp_kb
        X = plan.xdim
        offs, ranks = const.pidx.offs, const.pidx.ranks
        gi = [f * K + k for f in range(2) for k in ks]
        loff, pos = [], 0
        for i in gi:
            pos += (int(offs[i]) - pos) % COMP_BLOCK
            loff.append(pos)
            pos += int(ranks[i])
        u = torch.zeros((X, pos), dtype=torch.float32)
        w = torch.zeros((pos, X), dtype=torch.float32)
        mask = np.zeros((len(gi), pos), F32)
        gu, gw = const.pcu.cpu(), const.pcw.cpu()
        for q, (i, o) in enumerate(zip(gi, loff)):
            g0, r = int(offs[i]), int(ranks[i])
            u[:, o:o + r] = gu[:, g0:g0 + r]
            w[o:o + r] = gw[g0:g0 + r]
            mask[q, o:o + r] = 1.0
        pcu, pcw, pmask = u, w, torch.as_tensor(mask)
        pidx = packed_index(mask, dev)
    elif plan.comp_mode != "none":
        pcomp = const.pcomp[:, ks].contiguous()
    return Fast2Const(
        zd=rows(const.zd), zam=rows(const.zam), mer=rows(const.mer),
        wz=rows(const.wz), band=const.band[lo:hi].contiguous().to(dev),
        pcomp=pcomp.to(dev), pcu=pcu.to(dev), pcw=pcw.to(dev),
        pmask=pmask.to(dev), pidx=pidx)


@dataclass(frozen=True)
class ShardPlan:
    """The fold of a ``ydim`` x ``xdim`` grid cut into ``n_shards`` row
    ranges of ``rloc`` rows: ``plans[i]`` is shard i's plan (``cut_plan``);
    ``plan`` the unsharded one."""
    ydim: int
    xdim: int
    n_shards: int
    plan: FastPlan
    plans: Tuple[FastPlan, ...]

    @property
    def rloc(self) -> int:
        return self.ydim // self.n_shards

    @property
    def comp_mode(self) -> str:
        return self.plan.comp_mode

    @property
    def seq_zonal(self) -> bool:
        return self.plan.seq_zonal

    def rows(self, i: int) -> Tuple[int, int]:
        """Shard i's global rows [lo, hi)."""
        return i * self.rloc, (i + 1) * self.rloc


@dataclass
class Fast2ShardConst:
    """Each shard's rows of the fold (``cut_const``), shard i's at
    ``shards[i]``."""
    shards: Tuple[Fast2Const, ...]


def shard_fold(plan: FastPlan, const: Fast2Const, n_shards: int,
               devices=None) -> Tuple[ShardPlan, Fast2ShardConst]:
    """The unsharded fold ``(plan, const)`` cut into ``n_shards`` latitude
    shards, shard i's tensors on ``devices[i]`` (default: const's device).
    Raises ValueError where ``n_shards`` does not divide the rows or leaves
    a shard under 2 rows."""
    R = _check_shards(plan.ydim, n_shards)
    devs = list(devices) if devices is not None else [None] * n_shards
    plans = tuple(cut_plan(plan, i * R, (i + 1) * R) for i in range(n_shards))
    consts = tuple(cut_const(plan, const, i * R, (i + 1) * R, devs[i])
                   for i in range(n_shards))
    return (ShardPlan(ydim=plan.ydim, xdim=plan.xdim, n_shards=n_shards,
                      plan=plan, plans=plans), Fast2ShardConst(consts))


def build_sharded(wz_air: np.ndarray, wz_vapor: np.ndarray, grid: Grid,
                  st: stc.StencilStatic, kappa: float, n_shards: int,
                  device=None, fold: Optional[Tuple[FastPlan, Fast2Const]]
                  = None) -> Tuple[ShardPlan, Fast2ShardConst]:
    """The sharded plan and each shard's tensors for an ``n_shards``
    latitude decomposition: the unsharded fold (``build_const``, or
    ``fold`` where the caller has built it) cut into row ranges
    (``shard_fold``).  ValueError where ``n_shards`` does not divide the
    rows or leaves a shard under 2 rows."""
    _check_shards(grid.ydim, n_shards)
    if fold is None:
        fold = build_const(wz_air, wz_vapor, grid, st, kappa, device=device)
    return shard_fold(*fold, n_shards)


def sharded_circulation(x: torch.Tensor, cf: Fast2Coeffs, const: Fast2Const,
                        splan: ShardPlan, nsub: int, extend,
                        shard: int) -> torch.Tensor:
    """The sub-cycled circulation increment of shard ``shard``'s rows
    (``const``: its rows of the fold); ``extend`` supplies the neighbour
    shards' 2 halo rows a substep (parallel/halo.py)."""
    return circulation(x, cf, const, splan.plans[shard], nsub, extend)
