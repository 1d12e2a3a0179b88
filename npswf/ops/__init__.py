from npswf.ops.matched_filter import matched_filter
from npswf.ops.peak_search import tspectrum_search, find_pulses
from npswf.ops.cluster_gate import cluster_gate
from npswf.ops.spline import spline_eval, spline_eval_grad

__all__ = [
    "matched_filter",
    "tspectrum_search",
    "find_pulses",
    "cluster_gate",
    "spline_eval",
    "spline_eval_grad",
]
