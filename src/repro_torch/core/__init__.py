"""Core: MetaSchedule-style probabilistic tensor-program tuning, ported to
PyTorch and CUDA.

Public API:
    Workload, Schedule, HardwareConfig / H100, tune(), TuningDatabase,
    CudaRunner / EmulateRunner / AnalyticRunner, MeasureScheduler,
    TuningSession, best_schedule() / kernel_params() / ensure_tuned().
"""

from repro_torch.core.hardware import (CPU_EMULATE, H100, INTERPRET, SWEEP,
                                       V5E, V5E_MXU256, V5E_VMEM32,
                                       V5E_VMEM64, CudaHardwareConfig,
                                       HardwareConfig)
from repro_torch.core.workload import (Workload, matmul, qmatmul, gemv,
                                       vmacc, attention)
from repro_torch.core.schedule import Schedule, Decision
from repro_torch.core.space import (space_for, concretize,
                                    concretize_cache_stats,
                                    clear_concretize_cache,
                                    DecisionDistribution, KernelParams,
                                    SpaceProgram, flat_space_v1,
                                    tile_candidates, v1_distinct_configs)
from repro_torch.core.build_cache import (BuildCache, build_cache_stats,
                                          clear_build_cache,
                                          global_build_cache)
from repro_torch.core.sampler import TraceSampler
from repro_torch.core.static_analysis import (Diagnostic, SpaceReport,
                                              analyze, lint_space,
                                              pruned_program)
from repro_torch.core.cost_model import (RidgeCostModel, features,
                                         pretrain_from_database)
from repro_torch.core.runner import (AnalyticRunner, CudaRunner,
                                     EmulateRunner, baseline_latency,
                                     run_batch)
from repro_torch.core.database import (TuningDatabase, default_db_path,
                                       global_database,
                                       reset_global_database)
from repro_torch.core.measure_scheduler import (AdaptiveDepthPolicy,
                                                MeasureScheduler,
                                                MeasureTicket,
                                                SerialMeasureQueue)
from repro_torch.core.tuner import tune, TuneDriver, TuneResult
from repro_torch.core.session import (BudgetLedger, EntropyStopPolicy,
                                      TuningSession, SessionResult,
                                      WorkloadReport, dedup_workloads,
                                      split_budget)
from repro_torch.core.dispatch import (best_schedule, ensure_tuned,
                                       fixed_library_schedule,
                                       invalidate_dispatch_caches,
                                       kernel_params)

__all__ = [
    "HardwareConfig", "CudaHardwareConfig", "V5E", "V5E_VMEM32", "V5E_VMEM64",
    "V5E_MXU256", "INTERPRET", "H100", "CPU_EMULATE", "SWEEP", "Workload",
    "matmul", "qmatmul", "gemv", "vmacc", "attention", "Schedule", "Decision",
    "space_for", "concretize", "concretize_cache_stats",
    "clear_concretize_cache", "BuildCache", "build_cache_stats",
    "clear_build_cache", "global_build_cache", "DecisionDistribution",
    "KernelParams", "SpaceProgram", "flat_space_v1", "tile_candidates",
    "v1_distinct_configs", "TraceSampler", "Diagnostic", "SpaceReport",
    "analyze", "lint_space", "pruned_program", "RidgeCostModel", "features",
    "pretrain_from_database", "CudaRunner", "EmulateRunner", "AnalyticRunner",
    "baseline_latency", "run_batch", "AdaptiveDepthPolicy",
    "MeasureScheduler", "MeasureTicket", "SerialMeasureQueue",
    "TuningDatabase", "default_db_path", "global_database",
    "reset_global_database", "tune", "TuneDriver", "TuneResult",
    "BudgetLedger", "EntropyStopPolicy", "TuningSession", "SessionResult",
    "WorkloadReport", "dedup_workloads", "split_budget", "best_schedule",
    "ensure_tuned", "fixed_library_schedule", "invalidate_dispatch_caches",
    "kernel_params",
]
