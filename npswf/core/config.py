"""Typed configuration for the NPS waveform pipeline.

Replaces the reference's hardcoded compile-time constants that users were
expected to edit and recompile (ref TEST_2.C:51-73, README.md:165-171) with a
single frozen dataclass, plus framework-level knobs (dtypes, fit-lane
capacity, LM iteration budgets, mesh layout) that have no reference
equivalent because the reference is a single-process CPU macro.
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class NPSConfig:
    # ---- detector geometry (ref TEST_2.C:51-60) ----
    ntime: int = 110          # samples per fADC channel
    ncol: int = 30            # calorimeter columns
    nlin: int = 36            # calorimeter rows
    nslots: int = 1104        # max fADC slots (incl. 2 scintillator slots)
    maxwfpulses: int = 12     # max pulses per block the search may return
    scint_slot_a: int = 2000  # raw slot ids remapped to 1080/1081 (ref :862-865)
    scint_slot_b: int = 2001

    # ---- matched filter (ref TEST_2.C:64-69) ----
    mfleft: int = 5
    mfright: int = 5
    mfstart: int = 10         # peak-search window [mfstart, mfend] in 4ns bins
    mfend: int = 100

    # ---- thresholds (ref TEST_2.C:70-73) ----
    specthres: float = 0.02   # TSpectrum relative threshold
    mfthres: float = 1.5      # matched-filter peak amplitude threshold (mV)
    trig_thres: float = 10.0  # 3x3 cluster-sum trigger threshold (mV)
    coinc_width: int = 20     # coincidence window half-width (4ns bins)

    # ---- peak search (TSpectrum::Search semantics, ref TEST_2.C:187-188) ----
    spec_sigma: float = 2.0       # Search() sigma
    spec_decon_iterations: int = 3  # TSpectrum fgIterations default
    spec_aver_window: int = 3       # TSpectrum fgAverageWindow default (Markov)

    # ---- timing (ref TEST_2.C:354, 498-530) ----
    dt: float = 4.0           # ns per sample bin
    calodist: float = 9.5     # run-dependent; see geometry_for_run()
    timemean_base: float = 170.0  # timemean2 = 170 + timerefacc*dt (ref :526-530)

    # ---- fit configuration (ref TEST_2.C:656-704, 761-773) ----
    fit_lo_bin: int = 10      # fit bins [fit_lo_bin, fit_hi_bin) (ref :681)
    fit_hi_bin: int = 100
    ped_nsamples: int = 20    # pedestal seed = mean of first 20 samples (ref :672-676)
    ped_limit: float = 100.0  # pedestal bounds +-100 (ref :670)
    time_limit: float = 4.0   # time bounds seed +- 4 bins (ref :664)
    amp_lo_frac: float = 0.2  # amplitude bounds [0.2, 5] * seed (ref :665)
    amp_hi_frac: float = 5.0
    spline_gate_lo: float = 1.0    # model support gate 1 < dt0 < ntime-1 (ref :629)
    err_scale: float = 4.096       # error model sqrt(|y|*4.096/2)/4.096 (ref :949)
    err_floor_input: float = 1.0   # e < 1 -> recompute with y=1 (ref :951-954)
    amp_h12_thres: float = 20.0    # h1time/h2time fill threshold (ref :991)

    # ---- LM solver budgets (replaces Migrad strategy 1/1000 -> 2/5000,
    #      ref TEST_2.C:701-703, 765-767) ----
    # Budgets are knee-points measured on the dense bench batch (PERF.md):
    # stage-1 convergence is 88% by 10 iterations (median 4) and plateaus
    # at 95.3% by ~40; the stage-2 restart (10x lambda) rescues the rest to
    # a 1.7-1.8% failure rate with a 60-iteration budget — same rescue as
    # 120, half the cost. Cost is budget-bound, not typical-case-bound:
    # any straggler lane burns the whole budget for its chunk.
    lm_max_iter_stage1: int = 10
    lm_max_iter_stage2: int = 60
    # High-pileup lanes (npulse > lm_wide_pulses) get bigger per-LANE
    # budgets: many-param systems converge slower than the 1-2-pulse knee
    # the defaults above were tuned on, and such lanes are rare, so the
    # bigger budgets cost nothing on typical batches. Budgets are keyed on
    # the lane's own pulse count (not on bucket routing), so fit-lane
    # routing stays result-neutral.
    lm_wide_pulses: int = 2
    lm_stage1_wide: int = 20
    lm_stage2_wide: int = 120
    lm_lambda_init: float = 1e-3
    lm_lambda_up: float = 11.0
    lm_lambda_down: float = 9.0
    lm_lambda_min: float = 1e-12
    lm_lambda_max: float = 1e10
    lm_ftol: float = 1e-9     # relative chi2 decrease convergence
    lm_gtol: float = 1e-4     # scaled gradient-norm convergence (cosine of the
                              # gradient/residual angle; 1e-4 leaves parameter
                              # error ~1e-3 bins, 50x under the 0.05-bin parity
                              # bar, converges lanes ~2x sooner and lowers the
                              # failure rate into the reference's 1-2% band)
    # stage-2 retry layout: "compact" gathers failed lanes to the front and
    # re-solves fixed-size chunks under a while_loop (minimum FLOPs);
    # "masked" re-solves the full batch with only failed lanes active —
    # one solver call of depth <= lm_max_iter_stage2 instead of a
    # sequential chunk walk. Results are identical lane-for-lane (the LM
    # update is row-wise); pick by what the hardware is bound on.
    lm_stage2_mode: str = "compact"
    # stage-3 bound-escape restart (fit/lm.py): re-solves lanes still
    # failed after the stage-2 seed restart from the stage-1 end point
    # with bound-saturated sin-transform components pulled interior.
    # Cuts adversarial failure rates ~5x (SOLVER_AUDIT.md) for ~10% of
    # the dense-batch fit budget; disable for maximum throughput at the
    # reference's failure semantics (it stops after the strategy-2
    # retry, ref TEST_2.C:761-791 — PARITY.md Q8).
    lm_stage3: bool = True
    # stage-3 pull-back rungs: each magnitude m re-solves the lanes still
    # failed after the previous rung from the stage-1 end state with
    # bound-saturated components pulled back to sin(u) = +-m. The sweep
    # exists because one magnitude cannot fit every stuck lane: +-0.8
    # stays near the bound (right when the optimum hugs it), +-0.5
    # escapes deeper local structure (the residual clean-data class where
    # TRF beat the single-rung ladder, SOLVER_AUDIT.md round 2). Each
    # rung only sees still-failed lanes, so earlier results are
    # bit-unchanged and every rung is cond-skipped when nothing failed.
    lm_stage3_pullbacks: Tuple[float, ...] = (0.8, 0.5)
    # >0: split stage 1 into a full-width pass of this many iterations,
    # then a COMPACTED continuation of the unconverged lanes (their u,
    # lambda, and remaining budget carry over, so the LM trajectory — and
    # every result — is identical to the monolithic run). Median stage-1
    # convergence is 4 iterations while the budget is 10+: the tail burns
    # full-width system evals for a shrinking straggler set, and the
    # continuation runs those at compacted width instead. 0 = off.
    lm_stage1_tier: int = 4

    # ---- waveform model family (the reference hardcodes the spline model
    #      in its fit lambda, ref TEST_2.C:621-635; here it is pluggable) ----
    model_name: str = "spline_ref"   # registry name (npswf.models)
    # static per-model aux scalars, broadcast to every fit lane (e.g.
    # (("width", 4.0),) for the gaussian family); tuple-of-pairs so the
    # frozen config stays hashable for the jit cache
    model_aux: Tuple[Tuple[str, float], ...] = ()

    # ---- framework knobs (no reference equivalent) ----
    compute_dtype: str = "float32"   # on-device compute dtype
    solver_dtype: str = "float32"    # LM linear-algebra dtype
    fit_capacity: int = 0            # max fitted lanes per batch; 0 = all lanes
    search_capacity: int = 0         # max searched lanes per batch (matched
                                     # filter + peak search run on a compacted
                                     # present-lane subset); 0 = all lanes.
                                     # Real NPS events hit ~1-3% of the 1080
                                     # blocks (the reference loops only over
                                     # pres&&preswf blocks, TEST_2.C:944);
                                     # overflow lanes get npulse=0 and are
                                     # counted in n_search_dropped and flagged
                                     # per lane in search_overflow — set the
                                     # capacity to the per-batch present-lane
                                     # bound of your data, never below it.
                                     # NOTE: under mesh block-sharding the
                                     # compaction runs inside shard_map, so
                                     # the cap applies PER SHARD (effective
                                     # whole-batch capacity = capacity x
                                     # block shards); size it from per-shard
                                     # occupancy when sharding rows
    fit_chunk: int = 8640            # LM sub-batch size (lax.map chunks).
                                     # Fewer chunks = fewer fixed-cost
                                     # stage-2 retry rounds; 8640 = half the
                                     # 16-event full-geometry batch
    fit_small_pulses: int = 2        # bucket boundary: lanes with <= this many
                                     # pulses fit with a narrow parameter vector
    fit_mid_pulses: int = 4          # second boundary: lanes with small <
                                     # npulse <= this fit in a medium bucket
                                     # (M=9 systems instead of the wide
                                     # bucket's 25); <= fit_small_pulses
                                     # disables
    fit_big_frac: int = 8            # capacity of the wide bucket = cap/this
    spline_mode: str = "auto"        # segment select: "auto" | "gather" |
                                     # "onehot"; auto resolves per backend
                                     # (ops/spline.py)

    # ---- mesh layout (replaces ROOT implicit MT, ref TEST_2.C:313) ----
    mesh_data_axis: str = "data"     # event-batch sharding axis
    mesh_block_axis: str = "block"   # calorimeter-row sharding axis (halo exchange)

    # ------------------------------------------------------------------
    def __post_init__(self):
        # The reference's correlation reads signal[it + jt - mfright] over the
        # window [mfleft, ntime - mfright) (ref TEST_2.C:156-158): any
        # asymmetric mfleft/mfright makes it index out of bounds (UB in the
        # C++), so there is no well-defined behavior to reproduce — reject it.
        if self.mfleft != self.mfright:
            raise ValueError(
                f"mfleft ({self.mfleft}) must equal mfright ({self.mfright}): "
                "the reference's filter window reads out of bounds otherwise "
                "(TEST_2.C:156-158)")
        if self.lm_stage2_mode not in ("compact", "masked"):
            raise ValueError(
                f"lm_stage2_mode must be 'compact' or 'masked', "
                f"got {self.lm_stage2_mode!r}")

    @property
    def nblocks(self) -> int:
        return self.ncol * self.nlin

    @property
    def mfwidth(self) -> int:
        return self.mfleft + self.mfright + 1

    @property
    def nfitbins(self) -> int:
        return self.fit_hi_bin - self.fit_lo_bin

    @property
    def max_params(self) -> int:
        # pedestal + (time, amp) per pulse (ref TEST_2.C:361 "nbparameters")
        return 1 + 2 * self.maxwfpulses

    @property
    def ndata_max(self) -> int:
        # raw stream upper bound: nslots * (ntime + 2) (ref TEST_2.C:356)
        return self.nslots * (self.ntime + 2)

    def timerefacc(self, calodist: Optional[float] = None) -> float:
        """Accidental-time offset from calorimeter distance (ref TEST_2.C:524)."""
        d = self.calodist if calodist is None else calodist
        return (d - 9.5) / (3.0e8 * 1.0e-9 * self.dt)

    def err_floor(self) -> float:
        """Error floor applied when e < 1 (ref TEST_2.C:951-954)."""
        import math
        return math.sqrt(abs(self.err_floor_input * self.err_scale / 2.0)) / self.err_scale

    # ---- (de)serialization -------------------------------------------
    def replace(self, **kw) -> "NPSConfig":
        return dataclasses.replace(self, **kw)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "NPSConfig":
        d = json.loads(s)
        if "model_aux" in d:  # JSON lists -> hashable tuples
            d["model_aux"] = tuple((k, v) for k, v in d["model_aux"])
        if "lm_stage3_pullbacks" in d:
            d["lm_stage3_pullbacks"] = tuple(d["lm_stage3_pullbacks"])
        return cls(**d)


def calodist_for_run(run: int) -> float:
    """Run-number-keyed calorimeter distance (ref TEST_2.C:498-523)."""
    if 1571 < run < 3667:
        return 3.5
    if 3666 < run < 4632:
        return 4.0
    if 4635 < run < 4953:
        return 6.0
    if 4965 < run < 5344:
        return 4.0
    if 5354 < run < 5464:
        return 3.0
    if 5523 < run < 7013:
        return 3.5
    return 9.5


def config_for_run(run: int, **overrides) -> NPSConfig:
    """Config with run-dependent geometry resolved (ref TEST_2.C:498-530)."""
    return NPSConfig(calodist=calodist_for_run(run), **overrides)
