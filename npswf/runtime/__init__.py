from npswf.runtime.executor import RunResult, run_segment

__all__ = ["RunResult", "run_segment"]
