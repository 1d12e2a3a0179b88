from npswf.fit.lm import FitInputs, FitResult, fit_waveforms, lm_solve

__all__ = ["FitInputs", "FitResult", "fit_waveforms", "lm_solve"]
