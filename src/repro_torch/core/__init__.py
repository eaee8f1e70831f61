"""Core of the port: the paper's contribution as a composable feature.

- :mod:`repro_torch.core.vconfig`  — the variable vector-length knob (§2.1)
- :mod:`repro_torch.core.sdv`      — Latency Controller + Bandwidth Limiter
  machine model (§2.2/§2.3) executing kernel transaction traces, with the
  H100 constants (:func:`repro_torch.core.sdv.h100_machine`)
- :mod:`repro_torch.core.traffic`  — transaction traces of the four paper kernels
- :mod:`repro_torch.core.sweep`    — the §4 evaluation harness (Figs 3/4/5)
  and machine-checkable claims
- :mod:`repro_torch.core.campaign` — named, composable sweep campaigns:
  vectorized cube evaluation, the schema-versioned BENCH_sweeps.json store
  and the port's kernels timed on the card (``measure_cuda``)
- :mod:`repro_torch.core.autotune` — the SELL layout tuner on a Hopper
  budget and the model-driven VL tuner
"""
from repro_torch.core.campaign import (
    BW_UNLIMITED,
    CampaignResult,
    CampaignSpec,
    SweepStore,
    campaign_names,
    get_campaign,
    register_campaign,
    run_campaign,
)
from repro_torch.core.autotune import (
    SellTuneResult,
    TuneResult,
    measured_pad_factor,
    tune_sell_layout,
    tune_vl,
)
from repro_torch.core.vconfig import (
    PAPER_VLS,
    SCALAR_VL,
    VectorConfig,
    series_label,
    sweep_configs,
)
from repro_torch.core.sdv import (
    MachineParams,
    MemOp,
    Phase,
    RunResult,
    SDVMachine,
    Trace,
    evaluate_cube,
    fpga_sdv_machine,
    h100_machine,
    tpu_v5e_machine,
)

__all__ = [
    "BW_UNLIMITED",
    "CampaignResult",
    "CampaignSpec",
    "SweepStore",
    "campaign_names",
    "get_campaign",
    "register_campaign",
    "run_campaign",
    "evaluate_cube",
    "series_label",
    "SellTuneResult",
    "TuneResult",
    "measured_pad_factor",
    "tune_sell_layout",
    "tune_vl",
    "PAPER_VLS",
    "SCALAR_VL",
    "VectorConfig",
    "sweep_configs",
    "MachineParams",
    "MemOp",
    "Phase",
    "RunResult",
    "SDVMachine",
    "Trace",
    "fpga_sdv_machine",
    "h100_machine",
    "tpu_v5e_machine",
]
