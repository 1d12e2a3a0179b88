"""Parity harness: per-pulse time/amp/chi2 residuals vs a reference WF file.

The falsifiable form of the parity claim: given a
WF file produced by the reference ROOT macro (ref TEST_2.C:1383-1432) and a
WF .npz produced by this framework on the SAME input segment, align events on
(runnum, evt), align pulses block-by-block through the wfnpulse layout
(README.md:127), and emit residual histograms plus a pass/fail verdict
against the < 0.05-bin per-pulse time agreement bar.

Reference input formats:
- a ROOT WF file (read via uproot when available) with the reference's
  Snapshot columns {evt, runnum, wfnpulse, chi2, wfampl, wftime},
- another framework WF .npz (self-comparison / determinism checks).

Usage:
    python -m npswf.tools.cli parity --ref nps_production_..._wf.root \\
        --ours out_wf.npz [--time-tol-bins 0.05] [--json report.json]
"""
from __future__ import annotations

import json
import os
import sys
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np

# residual histogram binning (time in bins, amp relative, chi2 absolute)
TIME_HIST = (200, -0.5, 0.5)
AMP_HIST = (200, -0.2, 0.2)
CHI2_HIST = (200, -2.0, 2.0)


@dataclass
class WFColumns:
    """Canonical event-major view of a WF output file."""
    evt: np.ndarray           # [E]
    runnum: np.ndarray        # [E]
    wfnpulse: np.ndarray      # [E, B] i64 — per-block pulse counts
    chi2: np.ndarray          # [E, B]
    wftime: np.ndarray        # [total pulses] flat, block-order per event
    wfampl: np.ndarray        # [total pulses]
    offsets: np.ndarray       # [E+1] event boundaries in the flat arrays


def _from_object_rows(rows) -> Tuple[np.ndarray, np.ndarray]:
    counts = np.fromiter((len(r) for r in rows), np.int64, count=len(rows))
    offsets = np.zeros(len(rows) + 1, np.int64)
    np.cumsum(counts, out=offsets[1:])
    flat = (np.concatenate([np.asarray(r, np.float64) for r in rows])
            if offsets[-1] else np.zeros(0))
    return flat, offsets


def load_wf_root(path: str) -> WFColumns:
    """Load the reference macro's WF tree via uproot."""
    try:
        import uproot
    except ImportError as exc:  # pragma: no cover
        raise SystemExit(
            "reading a ROOT WF file requires the 'uproot' package") from exc
    with uproot.open(path) as f:
        tree = f["WF"]
        arrs = tree.arrays(["evt", "runnum", "wfnpulse", "chi2",
                            "wfampl", "wftime"], library="np")
    wfn = np.stack([np.asarray(r, np.int64) for r in arrs["wfnpulse"]])
    chi2 = np.stack([np.asarray(r, np.float64) for r in arrs["chi2"]])
    wftime, offsets = _from_object_rows(arrs["wftime"])
    wfampl, _ = _from_object_rows(arrs["wfampl"])
    return WFColumns(evt=np.asarray(arrs["evt"], np.float64),
                     runnum=np.asarray(arrs["runnum"], np.float64),
                     wfnpulse=wfn, chi2=chi2, wftime=wftime, wfampl=wfampl,
                     offsets=offsets)


def load_wf_npz(path: str) -> WFColumns:
    """Load a framework WF .npz (io/writer.py layout)."""
    z = np.load(path)
    return WFColumns(evt=z["evt"], runnum=z["runnum"],
                     wfnpulse=z["wfnpulse"].astype(np.int64),
                     chi2=z["chi2"],
                     wftime=z["wftime_flat"], wfampl=z["wfampl_flat"],
                     offsets=z["wf_offsets"])


def load_wf(path: str) -> WFColumns:
    if path.endswith(".root"):
        return load_wf_root(path)
    return load_wf_npz(path)


def _event_keys(wf: WFColumns) -> Dict[Tuple[float, float], int]:
    return {(float(r), float(e)): i
            for i, (r, e) in enumerate(zip(wf.runnum, wf.evt))}


def compare(ref: WFColumns, ours: WFColumns, dt_ns: float = 4.0,
            time_tol_bins: float = 0.05, chi2_fail: float = -100.0
            ) -> Dict:
    """Align and compare two WF files; returns the verdict report dict.

    Residual conventions: time residuals in BINS ((ours - ref) / dt_ns —
    the reference stores ns on all fitted paths, ref :782-815); amplitude
    residuals relative (ours/ref - 1); chi2 residuals absolute. Blocks whose
    pulse counts disagree are counted, not differenced; lanes where exactly
    one side flags chi2 = -100 are counted as fit-status mismatches.
    """
    ref_idx = _event_keys(ref)
    our_idx = _event_keys(ours)
    shared = sorted(set(ref_idx) & set(our_idx))
    report: Dict = {
        "events_ref": int(ref.evt.shape[0]),
        "events_ours": int(ours.evt.shape[0]),
        "events_aligned": len(shared),
    }
    B = ref.wfnpulse.shape[1]
    if ours.wfnpulse.shape[1] != B:
        raise ValueError(
            f"block-count mismatch: ref {B} vs ours {ours.wfnpulse.shape[1]}")

    dts, das, dchi = [], [], []
    n_blocks = n_npulse_mismatch = n_status_mismatch = n_pulses = 0
    for key in shared:
        i, j = ref_idx[key], our_idx[key]
        nr = ref.wfnpulse[i]
        no = ours.wfnpulse[j]
        n_blocks += B
        # walk the flat layout block by block (README.md:127)
        pr = int(ref.offsets[i])
        po = int(ours.offsets[j])
        for b in range(B):
            cr, co = int(nr[b]), int(no[b])
            if cr != co:
                n_npulse_mismatch += 1
            else:
                fr = chi2_fail == ref.chi2[i, b]
                fo = chi2_fail == ours.chi2[j, b]
                if fr != fo:
                    n_status_mismatch += 1
                elif cr > 0:
                    rt = ref.wftime[pr:pr + cr]
                    ot = ours.wftime[po:po + co]
                    ra = ref.wfampl[pr:pr + cr]
                    oa = ours.wfampl[po:po + co]
                    dts.append((ot - rt) / dt_ns)
                    with np.errstate(divide="ignore", invalid="ignore"):
                        das.append(np.where(ra != 0, oa / ra - 1.0, oa - ra))
                    if not (fr or fo):
                        dchi.append(ours.chi2[j, b] - ref.chi2[i, b])
                    n_pulses += cr
            pr += cr
            po += co

    dts = np.concatenate(dts) if dts else np.zeros(0)
    das = np.concatenate(das) if das else np.zeros(0)
    dchi = np.asarray(dchi)

    def q(x, p):
        return float(np.quantile(np.abs(x), p)) if x.size else 0.0

    report.update(
        blocks_compared=n_blocks,
        pulses_compared=n_pulses,
        npulse_mismatch=n_npulse_mismatch,
        fit_status_mismatch=n_status_mismatch,
        time_q50_bins=q(dts, 0.50), time_q95_bins=q(dts, 0.95),
        time_max_bins=float(np.max(np.abs(dts))) if dts.size else 0.0,
        amp_rel_q50=q(das, 0.50), amp_rel_q95=q(das, 0.95),
        chi2_q95=q(dchi, 0.95),
        time_hist=_hist(dts, TIME_HIST),
        amp_hist=_hist(das, AMP_HIST),
        chi2_hist=_hist(dchi, CHI2_HIST),
    )
    mismatch_rate = ((n_npulse_mismatch + n_status_mismatch) /
                     max(n_blocks, 1))
    report["mismatch_rate"] = mismatch_rate
    report["pass"] = bool(
        len(shared) > 0
        and report["time_q95_bins"] < time_tol_bins
        and mismatch_rate < 0.01)
    return report


def _hist(x: np.ndarray, spec) -> Dict:
    bins, lo, hi = spec
    counts, edges = np.histogram(x, bins=bins, range=(lo, hi))
    return {"counts": counts.tolist(), "lo": lo, "hi": hi,
            "underflow": int(np.sum(x < lo)), "overflow": int(np.sum(x > hi))}


def run_parity(ref_path: str, ours_path: str, dt_ns: float = 4.0,
               time_tol_bins: float = 0.05,
               json_out: Optional[str] = None) -> Dict:
    ref = load_wf(ref_path)
    ours = load_wf(ours_path)
    report = compare(ref, ours, dt_ns=dt_ns, time_tol_bins=time_tol_bins)
    if json_out:
        with open(json_out, "w") as f:
            json.dump(report, f, indent=1)
    print(f"parity: {report['events_aligned']} events aligned "
          f"({report['events_ref']} ref / {report['events_ours']} ours), "
          f"{report['pulses_compared']} pulses compared")
    print(f"  |dt| q50={report['time_q50_bins']:.4g} "
          f"q95={report['time_q95_bins']:.4g} "
          f"max={report['time_max_bins']:.4g} bins "
          f"(tolerance {time_tol_bins})")
    print(f"  |dA/A| q50={report['amp_rel_q50']:.4g} "
          f"q95={report['amp_rel_q95']:.4g}; "
          f"|dchi2| q95={report['chi2_q95']:.4g}")
    print(f"  npulse mismatches: {report['npulse_mismatch']}, "
          f"fit-status mismatches: {report['fit_status_mismatch']} "
          f"of {report['blocks_compared']} blocks "
          f"(rate {report['mismatch_rate']:.3%})")
    print(f"  VERDICT: {'PASS' if report['pass'] else 'FAIL'}")
    return report
