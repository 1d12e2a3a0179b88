from npswf.core.config import NPSConfig
from npswf.core.calibration import CalibrationBundle, load_calibration, synthetic_calibration

__all__ = ["NPSConfig", "CalibrationBundle", "load_calibration", "synthetic_calibration"]
