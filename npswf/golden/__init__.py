from npswf.golden.reference import (
    matched_filter_golden,
    tspectrum_search_golden,
    find_pulses_golden,
    cluster_gate_golden,
    decode_event_golden,
    hms_correction_golden,
)

__all__ = [
    "matched_filter_golden",
    "tspectrum_search_golden",
    "find_pulses_golden",
    "cluster_gate_golden",
    "decode_event_golden",
    "hms_correction_golden",
]
