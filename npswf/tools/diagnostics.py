"""Per-event diagnostic plots (component C15, ref TEST_2.C:1134-1285).

For selected events, draws every block with found pulses: the raw waveform,
the fitted model curve (pedestal + sum of spline reference pulses rebuilt
from the stored fit results), and dashed vertical lines at each pulse
position reconstructed from the stored ns-times — the same inversion the
reference uses when plotting (ref :1228). One multi-panel page per event.
"""
from __future__ import annotations

import math
import os
from typing import List, Optional

import numpy as np

from npswf.core.calibration import CalibrationBundle, spline_eval_np
from npswf.core.config import NPSConfig, config_for_run
from npswf.golden.reference import decode_event_golden
from npswf.io.rawstream import read_segment
from npswf.io.writer import read_wf


def make_event_plots(wf_path: str, seg_path: str, calib_path: str,
                     outdir: str, events: Optional[List[int]] = None,
                     max_blocks: int = 25) -> int:
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    wf = read_wf(wf_path)
    seg = read_segment(seg_path)
    cal = CalibrationBundle.load(calib_path)
    cfg = config_for_run(cal.run)
    os.makedirs(outdir, exist_ok=True)

    rows = range(wf["evt"].shape[0]) if events is None else [
        int(np.nonzero(wf["evt"] == e)[0][0]) for e in events
        if (wf["evt"] == e).any()]
    npages = 0
    for row in rows:
        npulse = wf["wfnpulse"][row]
        active = np.nonzero(npulse > 0)[0][:max_blocks]
        if active.size == 0:
            continue
        sig, _, _, _ = decode_event_golden(cfg, seg.event_stream(row))
        offs = wf["wf_offsets"]
        t_flat = wf["wftime_flat"][offs[row]:offs[row + 1]]
        a_flat = wf["wfampl_flat"][offs[row]:offs[row + 1]]
        starts = np.zeros(cfg.nblocks + 1, np.int64)
        np.cumsum(npulse, out=starts[1:])
        corr = wf["corr_time_HMS"][row]
        chi2 = wf["chi2"][row]

        nc = math.ceil(math.sqrt(active.size))
        nr = math.ceil(active.size / nc)
        fig, axes = plt.subplots(nr, nc, figsize=(3 * nc, 3 * nr), squeeze=False)
        x = np.arange(cfg.ntime)
        for k, b in enumerate(active):
            ax = axes[k // nc][k % nc]
            ax.plot(x, sig[b], "k-", lw=0.8, label="raw")
            times = t_flat[starts[b]:starts[b + 1]]
            amps = a_flat[starts[b]:starts[b + 1]]
            fitted = chi2[b] >= 0
            if fitted:
                # invert the ns conversion back to bin offsets (ref :1228)
                t_rel = (times - corr + cal.cortime[b]
                         + cal.timerefacc * cfg.dt) / cfg.dt
                # the FITTED pedestal is persisted (pedwf column) so the
                # drawn curve is exactly the fitted model, not a re-estimate
                if "pedwf" in wf:
                    ped = wf["pedwf"][row, b]
                else:  # pre-round-2 WF files
                    ped = np.mean(sig[b, :cfg.ped_nsamples])
                model = np.full(cfg.ntime, ped)
                for tr, a in zip(t_rel, amps):
                    arg = x - tr
                    gate = (arg > cfg.spline_gate_lo) & (arg < cfg.ntime - 1)
                    model += np.where(gate, a * spline_eval_np(
                        cal.spline_coeffs[b], cal.spline_x0[b], arg), 0.0)
                ax.plot(x, model, "b-", lw=1.4, label="fit")
                marks = t_rel + cal.timeref[b]
            else:
                marks = times  # raw bin units on unfitted paths
            for m in marks:
                if 0 <= m <= cfg.ntime:
                    ax.axvline(m, color="r", ls="--", lw=0.8)
            ax.set_title(f"blk {b} chi2={chi2[b]:.1f}", fontsize=8)
        for k in range(active.size, nr * nc):
            axes[k // nc][k % nc].axis("off")
        evt = wf["evt"][row]
        fig.suptitle(f"evt {evt:.0f}")
        fig.tight_layout()
        fig.savefig(os.path.join(outdir, f"fits_evt{evt:.0f}.png"), dpi=110)
        plt.close(fig)
        npages += 1
    return npages
