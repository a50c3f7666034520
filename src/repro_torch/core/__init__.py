"""LPF core — the paper's twelve primitives over virtual processes.

==========================  ==============================================
Paper primitive             This module
==========================  ==============================================
``lpf_exec``                :func:`repro_torch.core.exec_`
``lpf_hook``                :func:`repro_torch.core.hook`
``lpf_rehook``              :func:`repro_torch.core.rehook`
``lpf_register_local``      :meth:`LPFContext.register_local`
``lpf_register_global``     :meth:`LPFContext.register_global`
``lpf_deregister``          :meth:`LPFContext.deregister`
``lpf_resize_memory_...``   :meth:`LPFContext.resize_memory_register`
``lpf_resize_message_...``  :meth:`LPFContext.resize_message_queue`
``lpf_put``                 :meth:`LPFContext.put`
``lpf_get``                 :meth:`LPFContext.get`
``lpf_sync``                :meth:`LPFContext.sync`
``lpf_probe``               :meth:`LPFContext.probe` / :func:`probe`
==========================  ==============================================
"""

from .attrs import CompressSpec, LPF_SYNC_DEFAULT, SyncAttributes
from .context import LPFContext, exec_, hook, rehook, resolve_device
from .cost import (CostLedger, FUSED_METHODS, OVERLAP_L_FRACTION,
                   SuperstepCost, overlap_cost, schedule_seconds)
from .errors import (LPF_ERR_FATAL, LPF_ERR_OUT_OF_MEMORY,
                     LPF_ERR_TRANSIENT, LPF_SUCCESS, LPFAnalysisError,
                     LPFCapacityError, LPFError, LPFFatalError,
                     LPFTransientError, classify)
from .faultpoints import InjectedFault
from .machine import H100_SXM, HardwareModel, LinkModel, LPFMachine, probe
from .memslot import Slot, SlotRegistry, replicate
from .program import ProgramStep, dependency_cone
from .sync import (CacheStats, EXECUTED_METHODS, Msg, PlanCache, RoundPlan,
                   SuperstepPlan, conflict_free, execute_plan, execute_sync,
                   find_conflict, global_plan_cache, plan_cost,
                   plan_signature, plan_sync)

__all__ = [
    "LPFContext", "exec_", "hook", "rehook", "resolve_device",
    "SyncAttributes", "CompressSpec", "LPF_SYNC_DEFAULT",
    "CostLedger", "SuperstepCost", "FUSED_METHODS",
    "OVERLAP_L_FRACTION", "overlap_cost", "schedule_seconds",
    "conflict_free", "find_conflict", "dependency_cone",
    "LPFError", "LPFCapacityError", "LPFFatalError", "LPFAnalysisError",
    "LPFTransientError", "classify", "InjectedFault",
    "LPF_SUCCESS", "LPF_ERR_OUT_OF_MEMORY", "LPF_ERR_FATAL",
    "LPF_ERR_TRANSIENT",
    "HardwareModel", "LinkModel", "LPFMachine", "probe", "H100_SXM",
    "Slot", "SlotRegistry", "replicate", "Msg",
    "PlanCache", "CacheStats", "RoundPlan", "SuperstepPlan",
    "plan_sync", "plan_signature", "plan_cost", "execute_plan",
    "execute_sync",
    "EXECUTED_METHODS", "global_plan_cache",
    "ProgramStep",
]
