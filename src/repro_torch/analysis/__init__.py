"""Static launch preflight for the port's CUDA kernels."""
from repro_torch.analysis.launchplan import BlockPlan, LaunchPlan, LaunchPlanError
from repro_torch.analysis.preflight import SlabMeta, plan_spmm_sell

__all__ = ["BlockPlan", "LaunchPlan", "LaunchPlanError", "SlabMeta",
           "plan_spmm_sell"]
