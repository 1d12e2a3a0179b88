from npswf.utils.synthetic import SyntheticTruth, make_events
from npswf.utils.timers import StageTimer

__all__ = ["SyntheticTruth", "make_events", "StageTimer"]
