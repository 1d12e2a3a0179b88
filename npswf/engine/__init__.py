from npswf.engine.pipeline import EventBatch, PipelineOutput, make_pipeline, process_batch

__all__ = ["EventBatch", "PipelineOutput", "make_pipeline", "process_batch"]
