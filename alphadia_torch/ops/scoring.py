"""Batched candidate scoring: 46 features and per-fragment outputs.

Feature index map (order of ``search/scoring.FEATURE_COLUMNS``):
0 base_width_mobility, 1 base_width_rt, 2 rt_observed, 3 mobility_observed,
4 mono_ms1_intensity, 5 top_ms1_intensity, 6 sum_ms1_intensity,
7 weighted_ms1_intensity, 8 weighted_mass_deviation, 9 weighted_mass_error,
10 mz_observed, 11 mono_ms1_height, 12 top_ms1_height, 13 sum_ms1_height,
14 weighted_ms1_height, 15 isotope_intensity_correlation,
16 isotope_height_correlation, 17 n_observations, 18 intensity_correlation,
19 height_correlation, 20 intensity_fraction, 21 height_fraction,
22 intensity_fraction_weighted, 23 height_fraction_weighted,
24 mean_observation_score, 25 sum_b_ion_intensity, 26 sum_y_ion_intensity,
27 diff_b_y_ion_intensity, 28 f_masked, 29 fragment_scan_correlation,
30 template_scan_correlation, 31 fragment_frame_correlation,
32 top3_frame_correlation, 33 template_frame_correlation,
34 top3_b_ion_correlation, 35 n_b_ions, 36 top3_y_ion_correlation,
37 n_y_ions, 38 cycle_fwhm, 39 mobility_fwhm, 40 delta_frame_peak,
41 top_3_ms2_mass_error, 42 mean_ms2_mass_error, 43 n_overlapping,
44 mean_overlapping_intensity, 45 mean_overlapping_mass_error.

Profiles are extracted re-centred: the XIC window starts at
``frame_center - W//2`` so the apex sits at the static index W//2. Each
XIC is read from the candidate's first cycle and then placed in that
window: a query reads at most ``slab`` peaks from where its read starts, so
reading from the window start would let the bucket W decide which peaks a
full slab keeps (the JAX package reads from the window start: there the
features of a candidate whose slab overflows depend on W). With
``compute_dtype="bfloat16"`` the dense intensity chains run in bfloat16;
all m/z-delta and mass-error math stays float32.

Ion-mobility data (``n_scan_bins > 1``): both XICs are cropped to the
candidate's scan window [scan_lo, scan_hi) in the kernel; the precursor
height and mass error weight the true (scan, cycle) cells of a 4D
extraction; and scan profiles fill features 29 and 30 (fragment and
template scan correlations), 39 (mobility FWHM) and ``scan_com`` (the
observed mobility in bin units; the driver maps it to a mobility and fills
feature 0 from the scan window's width). These 4D chains stay float32 in
every compute dtype. On 3D data features 0, 29, 30 and 39 stay 0.
"""

from __future__ import annotations

import torch

from alphadia_torch.constants.settings import NUM_FEATURES
from alphadia_torch.ops.features import (
    center_envelope_odd,
    cosine_rows,
    logistic_rectangle,
    masked_corrcoef,
    masked_mean,
    masked_median,
    or_envelope,
    pearson_rows_masked,
    ref_top3_ion_correlation,
    topk_mean_by,
    weighted_center_mean,
    weighted_center_of_mass,
)
from alphadia_torch.ops.xic import extract_scan_profile, extract_xic_4d
from alphadia_torch.ops.xic_cuda import extract_xic_cuda

# transport precision classes of the features (indices into FEATURE_COLUMNS):
# float32 = calibration-grade observables (rt/mobility/mz observed);
# bfloat16 = raw MS1 intensity sums (range over precision); float16 = the rest
_F32_FEATURES = (2, 3, 10)
_BF16_FEATURES = (4, 5, 6, 7, 11, 12, 13, 14, 44)


def _round(x, dtype):
    return x.to(dtype).to(torch.float32)


def round_transport(features, frag_out):
    """Round the scoring outputs to the precision classes in which the JAX
    driver ships them to the host, so both packages emit identical frames:
    features f32 / bf16 / f16 by class (f16 clipped to its range); fragment
    mass_error (clipped to +-2000 ppm) and correlation f16; height,
    intensity and obs_intensity bf16; scan_com f32."""
    # each column's class as a mask made on the device: indexing with a
    # list of columns would copy it to the card and wait for the stream
    cols = torch.arange(features.shape[1], device=features.device)
    is_f32 = torch.zeros_like(cols, dtype=torch.bool)
    is_bf16 = torch.zeros_like(cols, dtype=torch.bool)
    for i in _F32_FEATURES:
        is_f32 |= cols == i
    for i in _BF16_FEATURES:
        is_bf16 |= cols == i
    out = torch.where(
        is_f32,
        features,
        torch.where(
            is_bf16,
            _round(features, torch.bfloat16),
            _round(features.clamp(-65504.0, 65504.0), torch.float16),
        ),
    )
    fo = dict(frag_out)
    fo["mass_error"] = _round(frag_out["mass_error"].clamp(-2000.0, 2000.0), torch.float16)
    fo["correlation"] = _round(frag_out["correlation"], torch.float16)
    for k in ("height", "intensity", "obs_intensity"):
        fo[k] = _round(frag_out[k], torch.bfloat16)
    return out, fo


def score_candidates_batch(
    peak_store,  # PeakStore (DiaData.device_arrays)
    cell_start,  # i32 or i64[n_slots, n_bins, n_cycles+1]
    cycle_rt,  # f32[n_cycles]
    frag_mz,  # f32[B, KF] library (calibrated) fragment m/z; 0 = pad
    frag_valid,  # bool[B, KF]
    frag_intensity,  # f32[B, KF] library intensity
    frag_type,  # i32[B, KF] (98=b, 121=y)
    frag_position,  # i32[B, KF]
    iso_mz,  # f32[B, KI]
    iso_intensity,  # f32[B, KI]
    ms2_slot,  # i32[B, O2] (-1 pad)
    ms1_slot,  # i32[B, O1] (-1 pad)
    win_lo,  # f32[B, O2] quad window bounds per ms2 observation
    win_hi,  # f32[B, O2]
    quad_sigma,  # (2,) logistic edge sigmas
    quad_delta_mu,  # (2,)
    frame_center,  # i32[B] absolute cycle of the apex
    frame_start,  # i32[B]
    frame_stop,  # i32[B] exclusive
    fragment_tol_ppm: float,
    precursor_tol_ppm: float,
    *,
    scan_lo=None,  # i32[B] candidate scan window start (4D)
    scan_hi=None,  # i32[B] exclusive
    mobility_width=None,  # f32[B] |mobility extent| of the scan window
    n_cycles: int,
    n_bins: int,
    bin_mz_min: float,
    bin_width: float,
    n_scan_bins: int = 1,
    slab: int,
    window_len: int,
    quant_window: int = 3,
    quant_all: bool = True,
    experimental_xic: bool = True,
    compute_dtype: str = "float32",
):
    """Returns (features f32[B, 46], valid bool[B], fragment outputs)."""
    B, KF = frag_mz.shape
    KI = iso_mz.shape[1]
    O2 = ms2_slot.shape[1]
    O1 = ms1_slot.shape[1]
    W = window_len
    C = W // 2  # static apex index
    dev = frag_mz.device
    f32 = torch.float32
    frag_type = frag_type.to(torch.int32)
    frag_position = frag_position.to(torch.int32)
    frame_center = frame_center.to(torch.int32)
    frame_start = frame_start.to(torch.int32)
    frame_stop = frame_stop.to(torch.int32)
    cycle_start = frame_center - C
    use_4d = n_scan_bins > 1
    if use_4d:
        if scan_lo is None or scan_hi is None or mobility_width is None:
            raise ValueError("4D scoring needs scan_lo, scan_hi and mobility_width")
        scan_lo = scan_lo.to(torch.int32)
        scan_hi = scan_hi.to(torch.int32)
        mobility_width = mobility_width.to(f32)

    # ---- window masks -------------------------------------------------
    cyc = cycle_start[:, None] + torch.arange(W, dtype=torch.int32, device=dev)[None, :]
    in_candidate = (cyc >= frame_start[:, None]) & (cyc < frame_stop[:, None])
    wmask = in_candidate & (cyc >= 0) & (cyc < n_cycles)  # [B, W]

    xic_kw = dict(
        n_cycles=n_cycles, n_bins=n_bins, bin_mz_min=bin_mz_min,
        bin_width=bin_width, slab=slab, window_len=W, with_mz=True,
        mz_as_delta=True,
    )
    if use_4d:
        # crop both XICs to the candidate's scan window (kernel variant c)
        xic_kw.update(scan_lo=scan_lo, scan_hi=scan_hi)

    # ---- dense fragments [B, KF, O2, W] -------------------------------
    fslot = torch.where(frag_valid[:, :, None], ms2_slot[:, None, :], -1).to(torch.int32)
    fmzq = frag_mz[:, :, None].expand(B, KF, O2)
    # a query reads at most `slab` peaks from the start of its window: the
    # XICs are read from the candidate's first cycle and then placed in the
    # window, so that the peaks a slab keeps do not depend on W
    shift = frame_start - cycle_start
    d_frag_int, d_frag_dmz = (
        _to_window(x, shift)
        for x in extract_xic_cuda(
            peak_store, cell_start, fslot.reshape(B, KF * O2).contiguous(),
            fmzq.reshape(B, KF * O2).contiguous(), fragment_tol_ppm, frame_start, **xic_kw,
        )
    )
    d_frag_int = d_frag_int.reshape(B, KF, O2, W) * wmask[:, None, None, :]
    d_frag_dmz = d_frag_dmz.reshape(B, KF, O2, W) * wmask[:, None, None, :]
    # presence of the m/z plane is defined before the transmission mask
    frag_present = d_frag_int > 0

    cdt = torch.bfloat16 if compute_dtype == "bfloat16" else f32
    d_frag_int = d_frag_int.to(cdt)

    # ---- dense precursors, observations collapsed [B, KI, W] ----------
    islot = ms1_slot[:, None, :].expand(B, KI, O1)
    imzq = iso_mz[:, :, None].expand(B, KI, O1)
    d_prec_int_o, d_prec_dmz_o = (
        _to_window(x, shift)
        for x in extract_xic_cuda(
            peak_store, cell_start, islot.reshape(B, KI * O1).contiguous(),
            imzq.reshape(B, KI * O1).contiguous(), precursor_tol_ppm, frame_start, **xic_kw,
        )
    )
    d_prec_int_o = d_prec_int_o.reshape(B, KI, O1, W) * wmask[:, None, None, :]
    d_prec_dmz_o = d_prec_dmz_o.reshape(B, KI, O1, W) * wmask[:, None, None, :]
    d_prec_int = d_prec_int_o.sum(dim=2).to(cdt)
    nz = (d_prec_int_o > 0).sum(dim=2).to(f32)
    prec_present = nz > 0
    # observation merge is sum / (count + 1e-6) on absolute m/z, written in
    # delta space: (sum(d_j) - 1e-6 * qc) / (count + 1e-6)
    d_prec_dmz = torch.where(
        prec_present,
        (d_prec_dmz_o.sum(dim=2) - 1e-6 * iso_mz[:, :, None]) / (nz + 1e-6),
        0.0,
    )

    # ---- quadrupole transfer + template -------------------------------
    qtf = logistic_rectangle(
        win_lo[:, None, :] + float(quad_delta_mu[0]),
        win_hi[:, None, :] + float(quad_delta_mu[1]),
        float(quad_sigma[0]),
        float(quad_sigma[1]),
        iso_mz[:, :, None],
    )  # [B, KI, O2]
    obs_valid = ms2_slot >= 0
    qtf = qtf * obs_valid[:, None, :]

    # raw per-window fragment sums (training data of quadrupole fitting)
    obs_raw_sum = d_frag_int.sum(dim=(1, 3))  # [B, O2]

    qtf_mask = qtf.mean(dim=1)  # [B, O2]
    d_frag_int = d_frag_int * qtf_mask[:, None, :, None].to(cdt)

    template = (
        (iso_intensity[:, :, None, None] * qtf[:, :, :, None]).to(cdt)
        * d_prec_int[:, :, None, :]
    ).sum(dim=1)  # [B, O2, W]
    t_sum = template.sum(dim=-1)  # [B, O2]
    total = t_sum.sum(dim=-1, keepdim=True)
    obs_imp = torch.where(
        total > 0,
        t_sum / total.clamp(min=1e-12),
        obs_valid.to(f32) / obs_valid.sum(-1, keepdim=True).clamp(min=1),
    )

    # ---- fragment validity -------------------------------------------
    frag_signal = d_frag_int.sum(dim=(2, 3)) > 0
    fmask = frag_valid & frag_signal
    n_valid = fmask.sum(dim=1)
    n_input = frag_valid.sum(dim=1).clamp(min=1)

    feat: dict[int, torch.Tensor] = {28: n_valid / n_input}  # f_masked

    # ---- location features -------------------------------------------
    rt_start = cycle_rt[frame_start.long().clamp(0, n_cycles - 1)]
    rt_stop = cycle_rt[frame_stop.long().clamp(0, n_cycles - 1)]
    rt_obs = cycle_rt[frame_center.long().clamp(0, n_cycles - 1)]
    feat[1] = rt_stop - rt_start
    feat[2] = rt_obs
    feat[3] = torch.full((B,), 1e-6, dtype=f32, device=dev)

    # ---- precursor features ------------------------------------------
    sum_prec = d_prec_int.sum(dim=-1)  # [B, KI]
    feat[4] = sum_prec[:, 0]
    top_iso = torch.argmax(iso_intensity, dim=1)
    feat[5] = torch.gather(sum_prec, 1, top_iso[:, None])[:, 0]
    feat[6] = sum_prec.sum(dim=1)
    feat[7] = (sum_prec * iso_intensity).sum(dim=1)

    # precursor planes are weighted from window frame 1 relative to the
    # candidate START with scan centre 2 (a reference artifact)
    prec_ctr = (frame_start - cycle_start + 1).to(f32)
    if use_4d:
        prec_height, prec_dmz_obs = _precursor_cells_4d(
            peak_store, cell_start, islot, imzq, iso_mz,
            precursor_tol_ppm, cycle_start, prec_ctr, wmask, scan_lo, scan_hi,
            n_cycles=n_cycles, n_bins=n_bins, bin_mz_min=bin_mz_min,
            bin_width=bin_width, n_scan_bins=n_scan_bins, slab=slab, window_len=W,
        )
    else:
        center_arr = prec_ctr[:, None].expand(B, KI)
        prec_height = weighted_center_mean(
            d_prec_int, center_arr, wmask[:, None, :], scan_dist_sq=(4.0, 1.0)
        )
        prec_dmz_obs = weighted_center_mean(
            d_prec_dmz, center_arr, wmask[:, None, :], scan_dist_sq=(4.0, 1.0),
            nonzero=prec_present,
        )
    mz_nz = (prec_present & wmask[:, None, :]).any(dim=-1)
    mass_err_iso = prec_dmz_obs / iso_mz * 1e6
    weighted_mass_error = (
        torch.where(mz_nz, mass_err_iso, 0.0) * iso_intensity
    ).sum(dim=1)
    feat[8] = weighted_mass_error
    feat[9] = weighted_mass_error.abs()
    feat[10] = iso_mz[:, 0] + weighted_mass_error * 1e-6 * iso_mz[:, 0]
    feat[11] = prec_height[:, 0]
    feat[12] = torch.gather(prec_height, 1, top_iso[:, None])[:, 0]
    feat[13] = prec_height.sum(dim=1)
    feat[14] = (prec_height * iso_intensity).sum(dim=1)
    ones = torch.ones((B, KI), dtype=torch.bool, device=dev)
    feat[15] = masked_corrcoef(iso_intensity, sum_prec, ones)
    feat[16] = masked_corrcoef(iso_intensity, prec_height, ones)
    feat[17] = obs_valid.sum(dim=1).to(f32)

    # ---- fragment profiles -------------------------------------------
    frame_profile = d_frag_int  # [B, KF, O2, W]
    intensity_norm = torch.where(fmask, frag_intensity, 0.0)
    intensity_norm = intensity_norm / intensity_norm.sum(dim=1, keepdim=True).clamp(min=1e-12)

    com, _ = weighted_center_of_mass(template, wmask[:, None, :])  # [B, O2]

    if quant_all:
        best_profile = frame_profile.sum(dim=2)
    else:
        bo = torch.argmax(obs_imp, dim=1)
        best_profile = torch.gather(
            frame_profile, 2, bo[:, None, None, None].expand(B, KF, 1, W)
        )[:, :, 0, :]
    best_profile = center_envelope_odd(best_profile, C)

    qw = min(max(W // 2 - 1, 1), quant_window)
    prof_q = best_profile[:, :, C - qw : C + qw + 1]
    rt_win = cycle_rt[cyc.long().clamp(0, n_cycles - 1)]  # [B, W]
    rt_q = rt_win[:, C - qw : C + qw + 1]
    delta_rt_q = rt_q[:, 1:] - rt_q[:, :-1]
    fragment_area = (
        (prof_q[:, :, 1:] + prof_q[:, :, :-1]) * delta_rt_q[:, None, :] * 0.5
    ).sum(dim=-1)
    fragment_area_norm = fragment_area * qw  # [B, KF] -> 'intensity'
    observed_intensity = prof_q.sum(dim=-1)

    sum_frag_int = frame_profile.sum(dim=-1)  # [B, KF, O2]

    # observed m/z delta and height at the template centre of mass
    com_f = com[:, None, :].expand(B, KF, O2)
    wmask_f = wmask[:, None, None, :].expand(B, KF, O2, W)
    o_dmz = weighted_center_mean(d_frag_dmz, com_f, wmask_f, nonzero=frag_present)
    o_height = weighted_center_mean(d_frag_int, com_f, wmask_f)
    h_mask = o_height > 0
    h_w = h_mask * obs_imp[:, None, :]
    h_w = h_w / (h_w.sum(dim=-1, keepdim=True) + 1e-20)
    observed_dmz = (o_dmz * h_w).sum(dim=-1)  # [B, KF]
    has_obs = h_mask.any(dim=-1)
    observed_height = (o_height * h_w).sum(dim=-1)

    feat[18] = masked_corrcoef(fragment_area_norm, intensity_norm, fmask)
    feat[19] = masked_corrcoef(observed_height, intensity_norm, fmask)
    int_nz = (observed_intensity > 0) & fmask
    h_nz = (observed_height > 0) & fmask
    nf = n_valid.to(f32).clamp(min=1.0)
    feat[20] = int_nz.sum(dim=1) / nf
    feat[21] = h_nz.sum(dim=1) / nf
    feat[22] = (intensity_norm * int_nz).sum(dim=1)
    feat[23] = (intensity_norm * h_nz).sum(dim=1)

    cos = cosine_rows(sum_frag_int, t_sum[:, None, :])  # [B, KF]
    feat[24] = masked_mean(cos, int_nz)

    is_b = frag_type == 98
    is_y = frag_type == 121
    b_int = (observed_intensity * (is_b & fmask)).sum(dim=1)
    y_int = (observed_intensity * (is_y & fmask)).sum(dim=1)
    feat[25] = torch.log1p(b_int)
    feat[26] = torch.log1p(y_int)
    feat[27] = feat[25] - feat[26]

    # ---- frame correlation features ----------------------------------
    profile_all = frame_profile.sum(dim=2)  # [B, KF, W]
    if experimental_xic:
        # each profile is scaled by its mean over centre +-1; profiles with
        # zero centre intensity are zeroed
        center_int = profile_all[:, :, C - 1 : C + 2].mean(dim=-1, keepdim=True)
        norm_prof = torch.where(
            center_int > 0, profile_all / center_int.clamp(min=1e-12), 0.0
        )
        med_prof = masked_median(
            norm_prof, fmask[:, :, None] & wmask[:, None, :], dim=1
        )  # [B, W]
        frame_corr = pearson_rows_masked(
            (med_prof[:, None, :] * wmask[:, None, :]).expand(profile_all.shape),
            profile_all,
            wmask[:, None, :],
        )
    else:
        wcnt = wmask.sum(dim=-1).to(f32).clamp(min=1.0)[:, None, None]
        pmean = profile_all.sum(dim=-1, keepdim=True) / wcnt
        pm = (profile_all - pmean) * wmask[:, None, :]
        cov = torch.einsum("bfw,bgw->bfg", pm, pm) / wcnt
        sd = torch.sqrt((torch.einsum("bfw,bfw->bf", pm, pm) / wcnt[..., 0]).clamp(min=0.0))
        corr_mat = cov / (sd[:, :, None] * sd[:, None, :] + 1e-12)
        frame_corr = torch.einsum(
            "bfg,bg->bf", (corr_mat * fmask[:, None, :]).to(f32), frag_intensity
        )
    top3_corr = topk_mean_by(frame_corr, frag_intensity, fmask, 3)
    feat[31] = masked_mean(frame_corr, fmask)
    feat[32] = top3_corr

    tf_corr = pearson_rows_masked(
        frame_profile,
        template[:, None, :, :].expand(frame_profile.shape),
        wmask[:, None, None, :].expand(frame_profile.shape),
    )  # [B, KF, O2]
    tf_red = (tf_corr * obs_imp[:, None, :]).sum(dim=-1)
    feat[33] = (tf_red * intensity_norm).sum(dim=1)

    feat[34] = ref_top3_ion_correlation(frame_corr, frag_mz, frag_intensity, fmask, is_b)
    feat[35] = (fmask & is_b).sum(dim=1).to(f32)
    feat[36] = ref_top3_ion_correlation(frame_corr, frag_mz, frag_intensity, fmask, is_y)
    feat[37] = (fmask & is_y).sum(dim=1).to(f32)

    scan_com = torch.zeros((B,), dtype=f32, device=dev)
    if use_4d:
        scan_feat, scan_com = _scan_features(
            peak_store, cell_start, fslot, fmzq, islot, imzq,
            fragment_tol_ppm, precursor_tol_ppm, frame_start, frame_stop,
            cycle_start, scan_lo, scan_hi, mobility_width, iso_intensity, qtf,
            obs_imp, fmask, frag_intensity, intensity_norm,
            n_cycles=n_cycles, n_bins=n_bins, bin_mz_min=bin_mz_min,
            bin_width=bin_width, n_scan_bins=n_scan_bins, slab=slab, window_len=W,
        )
        feat.update(scan_feat)

    # ---- cycle FWHM ---------------------------------------------------
    # fraction above half max over the candidate's own profile length
    half_max = frame_profile.amax(dim=-1, keepdim=True) * 0.5
    cand_len = wmask.sum(dim=-1).to(f32).clamp(min=1.0)
    frac_above = (frame_profile > half_max).sum(dim=-1).to(f32) / cand_len[:, None, None]
    cycle_fwhm = frac_above * (rt_stop - rt_start)[:, None, None]
    fwhm_red = (cycle_fwhm * obs_imp[:, None, :]).sum(dim=-1)
    feat[38] = (fwhm_red * intensity_norm).sum(dim=1)

    # ---- delta frame peak --------------------------------------------
    # argmax over the candidate's own extent minus the extent midpoint
    peak_pos = torch.argmax(
        torch.where(wmask[:, None, None, :], frame_profile, -1.0), dim=-1
    ).to(f32)
    med_peak = masked_median(peak_pos, fmask[:, :, None] & obs_valid[:, None, :], dim=1)
    ext_center = (frame_start - cycle_start).to(f32) + torch.floor(
        (frame_stop - frame_start).to(f32) / 2.0
    )
    feat[40] = ((med_peak - ext_center[:, None]) * obs_imp).sum(dim=-1)

    # ---- MS2 mass errors ---------------------------------------------
    # a never-observed fragment keeps the (0 - mz)/mz = -1e6 ppm sentinel
    mass_error = torch.where(
        has_obs, observed_dmz / frag_mz.clamp(min=1e-6) * 1e6, -1e6
    )
    feat[41] = topk_mean_by(mass_error, frag_intensity, fmask, 3)
    feat[42] = masked_mean(mass_error, fmask)

    # ---- overlapping b/y series --------------------------------------
    big = 10_000
    pos = frag_position
    has_b = (fmask & is_b).any(dim=1)
    has_y = (fmask & is_y).any(dim=1)
    min_y = torch.where(fmask & is_y, pos, big).amin(dim=1)
    max_b = torch.where(fmask & is_b, pos, -big).amax(dim=1)
    overlapping = fmask & (
        (is_y & (pos < max_b[:, None])) | (is_b & (pos > min_y[:, None]))
    )
    overlapping = overlapping & has_b[:, None] & has_y[:, None]
    n_over = overlapping.sum(dim=1).to(f32)
    feat[43] = n_over
    feat[44] = torch.where(n_over > 0, masked_mean(fragment_area_norm, overlapping), 0.0)
    feat[45] = torch.where(
        n_over > 0,
        masked_mean(mass_error, overlapping),
        torch.where(has_b & has_y, 15.0, 0.0),
    )

    fragment_out = {
        "mz_observed": torch.where(has_obs, frag_mz + observed_dmz, 0.0),
        "mass_error": mass_error,
        "height": observed_height,
        "intensity": fragment_area_norm,
        "correlation": frame_corr,
        "valid": fmask,
        "obs_intensity": obs_raw_sum,
        "scan_com": scan_com,
    }
    zero = torch.zeros((B,), dtype=f32, device=dev)
    features = torch.stack(
        [feat[i].to(f32) if i in feat else zero for i in range(NUM_FEATURES)], dim=1
    )
    return features, n_valid >= 2, fragment_out


def _to_window(x, shift):
    """Planes [B, ..., W] read from cycle ``start + shift`` placed at
    ``start``: cell w takes the read's cell w - shift, 0 before it."""
    W = x.shape[-1]
    idx = torch.arange(W, device=x.device)[None, :] - shift.long()[:, None]  # [B, W]
    idx = idx.reshape(idx.shape[0], *([1] * (x.dim() - 2)), W)
    out = torch.gather(x, -1, idx.clamp(min=0).expand(x.shape))
    return torch.where(idx >= 0, out, 0.0)


def _precursor_cells_4d(
    peak_store, cell_start, islot, imzq, iso_mz, precursor_tol_ppm,
    cycle_start, prec_ctr, wmask, scan_lo, scan_hi, *, n_scan_bins, window_len, **xic_kw,
):
    """Precursor height and m/z delta [B, KI] on 4D data: exp(-0.1 * d)
    weighted means over the true (scan, cycle) cells of the candidate's
    scan window, observations merged cell by cell."""
    B, KI, O1 = islot.shape
    S, W = n_scan_bins, window_len
    dev = iso_mz.device
    f32 = torch.float32
    # read from the candidate's first cycle, as the XICs of the batch
    shift = prec_ctr.to(torch.int32) - 1
    i4_int_o, i4_dmz_o = (
        _to_window(x, shift)
        for x in extract_xic_4d(
            peak_store.packed[:, 0], peak_store.packed[:, 1], peak_store.scanbin, cell_start,
            islot.reshape(B, KI * O1), imzq.reshape(B, KI * O1), precursor_tol_ppm,
            cycle_start + shift, n_scan_bins=S, window_len=W, with_mz=True, **xic_kw,
        )
    )
    i4_int_o = i4_int_o.reshape(B, KI, O1, S, W)
    i4_dmz_o = i4_dmz_o.reshape(B, KI, O1, S, W)
    nz4 = (i4_int_o > 0).sum(dim=2).to(f32)  # [B, KI, S, W]
    i4_int = i4_int_o.sum(dim=2)
    i4_dmz = torch.where(
        nz4 > 0, (i4_dmz_o.sum(dim=2) - 1e-6 * iso_mz[:, :, None, None]) / (nz4 + 1e-6), 0.0
    )
    s_idx = torch.arange(S, dtype=f32, device=dev)
    smask = (s_idx[None, :] >= scan_lo[:, None]) & (s_idx[None, :] < scan_hi[:, None])  # [B, S]
    # the reference's scan axis runs against ours and its centre sits one
    # row past its window, one bin below our window start: ds = s - (lo - 1)
    ds = s_idx[None, :] - (scan_lo.to(f32)[:, None] - 1.0)  # [B, S]
    df = torch.arange(W, dtype=f32, device=dev)[None, :] - prec_ctr[:, None]  # [B, W]
    w4 = torch.exp(-0.1 * torch.sqrt(torch.square(ds)[:, None, :, None] + torch.square(df)[:, None, None, :]))
    present = (i4_int > 0) & smask[:, None, :, None] & wmask[:, None, None, :]
    w4m = torch.where(present, w4, 0.0)
    w4sum = w4m.sum(dim=(-2, -1))  # [B, KI]
    height = torch.where(w4sum > 0, (i4_int * w4m).sum(dim=(-2, -1)) / w4sum.clamp(min=1e-12), 0.0)
    dmz = torch.where(w4sum > 0, (i4_dmz * w4m).sum(dim=(-2, -1)) / w4sum.clamp(min=1e-12), 0.0)
    return height, dmz


def _scan_features(
    peak_store, cell_start, fslot, fmzq, islot, imzq,
    fragment_tol_ppm, precursor_tol_ppm, frame_start, frame_stop, cycle_start,
    scan_lo, scan_hi, mobility_width, iso_intensity, qtf, obs_imp, fmask,
    frag_intensity, intensity_norm, *, n_scan_bins, window_len, **xic_kw,
):
    """Features 29, 30 and 39 and the scan centre of mass (bin units) from
    the mobility scan profiles of the candidate's cycle extent, each
    or-enveloped first."""
    B, KF, O2 = fslot.shape
    KI, O1 = islot.shape[1:]
    S = n_scan_bins
    dev = fmask.device
    f32 = torch.float32
    smask = (torch.arange(S, device=dev)[None, :] >= scan_lo[:, None]) & (
        torch.arange(S, device=dev)[None, :] < scan_hi[:, None]
    )  # [B, S]
    c_lo = torch.maximum(frame_start, cycle_start)
    c_hi = torch.minimum(frame_stop, cycle_start + window_len)

    def profile(slot, mz, tol, Q):
        return extract_scan_profile(
            peak_store.packed[:, 0], peak_store.packed[:, 1], peak_store.scanbin, cell_start,
            slot.reshape(B, Q), mz.reshape(B, Q), tol, c_lo, c_hi, n_scan_bins=S, **xic_kw,
        )

    frag_scan = profile(fslot, fmzq, fragment_tol_ppm, KF * O2).reshape(B, KF, O2, S) * smask[:, None, None, :]
    frag_scan = or_envelope(frag_scan) * smask[:, None, None, :]
    prec_scan = profile(islot, imzq, precursor_tol_ppm, KI * O1).reshape(B, KI, O1, S).sum(dim=2) * smask[:, None, :]
    template_scan = (
        iso_intensity[:, :, None, None] * qtf[:, :, :, None] * prec_scan[:, :, None, :]
    ).sum(dim=1)  # [B, O2, S]
    template_scan = or_envelope(template_scan) * smask[:, None, :]

    # 29: pairwise fragment scan correlations, observation-reduced,
    # intensity-weighted
    cnt = smask.sum(-1).clamp(min=1).to(f32)  # [B]
    mu = frag_scan.sum(-1) / cnt[:, None, None]
    pm = (frag_scan - mu[..., None]) * smask[:, None, None, :]
    cov = torch.einsum("bfos,bgos->bfgo", pm, pm)
    sd = torch.sqrt(torch.einsum("bfos,bfos->bfo", pm, pm).clamp(min=0.0))
    corr = cov / (sd[:, :, None, :] * sd[:, None, :, :] + 1e-12)
    corr_red = (corr * obs_imp[:, None, None, :]).sum(-1)  # [B, KF, KF]
    sc_mask = fmask & (frag_scan.sum(dim=(2, 3)) > 0)
    w_scan = torch.where(sc_mask, frag_intensity, 0.0)
    w_scan = w_scan / w_scan.sum(-1, keepdim=True).clamp(min=1e-12)
    scan_corr = torch.einsum("bfg,bg->bf", corr_red * sc_mask[:, None, :], w_scan)
    # both scan correlations are 0 below 3 fragments with a scan profile
    scan_ok = sc_mask.sum(dim=1) >= 3
    feat = {29: torch.where(scan_ok, masked_mean(scan_corr, sc_mask), 0.0)}

    # 30: fragment against template scan correlation
    t_corr = masked_corrcoef(
        frag_scan,
        template_scan[:, None, :, :].expand(frag_scan.shape),
        smask[:, None, None, :].expand(frag_scan.shape),
    )  # [B, KF, O2]
    feat[30] = torch.where(scan_ok, ((t_corr * obs_imp[:, None, :]).sum(-1) * w_scan).sum(-1), 0.0)

    # 39: mobility FWHM, share of the window above half max x its width
    smax = frag_scan.amax(dim=-1, keepdim=True)
    frac = ((frag_scan > 0.5 * smax) & smask[:, None, None, :]).sum(-1).to(f32) / cnt[:, None, None]
    mf_red = (frac * mobility_width[:, None, None] * obs_imp[:, None, :]).sum(-1)
    feat[39] = (mf_red * intensity_norm).sum(-1)

    # observed mobility: scan centre of mass of the summed fragment profile
    total = (frag_scan * fmask[:, :, None, None]).sum(dim=(1, 2))  # [B, S]
    tmass = total.sum(-1)
    bins_c = torch.arange(S, dtype=f32, device=dev)[None, :] + 0.5
    scan_com = torch.where(tmass > 0, (total * bins_c).sum(-1) / tmass.clamp(min=1e-9), 0.0)
    return feat, scan_com
