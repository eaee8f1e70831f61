"""Static launch preflight for the port's CUDA kernels."""
from repro_torch.analysis.launchplan import BlockPlan, LaunchPlan, LaunchPlanError
from repro_torch.analysis.preflight import (
    LiveWidthMeta,
    SlabMeta,
    plan_bfs_ell,
    plan_bfs_sell,
    plan_embedding_gather,
    plan_embedding_gather_bwd,
    plan_embedding_gather_shard,
    plan_embedding_gather_shard_bwd,
    plan_fft_stockham,
    plan_moe_dispatch,
    plan_pagerank_ell,
    plan_pagerank_sell,
    plan_spmm_sell,
    plan_spmm_sell_sharded,
    plan_spmm_sell_stream,
    plan_spmv_ell,
    plan_ssd_fused,
    plan_ssd_fused_bwd,
)

__all__ = ["BlockPlan", "LaunchPlan", "LaunchPlanError", "LiveWidthMeta",
           "SlabMeta",
           "plan_bfs_ell", "plan_bfs_sell", "plan_embedding_gather",
           "plan_embedding_gather_bwd", "plan_embedding_gather_shard",
           "plan_embedding_gather_shard_bwd",
           "plan_fft_stockham",
           "plan_moe_dispatch", "plan_pagerank_ell", "plan_pagerank_sell",
           "plan_spmm_sell", "plan_spmm_sell_sharded",
           "plan_spmm_sell_stream", "plan_spmv_ell",
           "plan_ssd_fused", "plan_ssd_fused_bwd"]
