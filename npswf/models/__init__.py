from npswf.models.waveform import (
    BiexpPulseModel,
    SplineRefModel,
    WaveformModel,
    get_model,
    register_model,
)

__all__ = ["WaveformModel", "SplineRefModel", "BiexpPulseModel", "get_model",
           "register_model"]
