"""Deterministic, shardable, resumable synthetic data pipeline (the port's
copy of ``repro.data``)."""
from repro_torch.data.pipeline import DataConfig, DataState, SyntheticLM, make_global_batch

__all__ = ["DataConfig", "DataState", "SyntheticLM", "make_global_batch"]
