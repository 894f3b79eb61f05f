"""Adaptive hybrid execution planner (DESIGN.md §10), on the port.

The counterpart of ``repro.planner``, host code over the port's own copies
of the cost model, the mapper, the device technologies and the traffic
accounting: numpy and plain Python, no kernel launched and nothing built.
The paper's cross-layer results are a tension, not a verdict: centralized
wins communication ~790x, decentralized wins computation ~1400x, and the
authors call for a hybrid. Given graph statistics, a crossbar inventory,
and a churn/query workload profile, the planner searches ``setting ×
backend × cluster count × crossbar size × refresh policy × layout ×
device technology × neighbor mode`` through pluggable evaluators (the
calibrated Eqs. 1-7 cost model, the first-principles mapper rollup, the
device-technology accuracy bound, and measured traffic on the executed
exchange tables) and returns a Pareto frontier plus one recommended,
materializable ``ExecutionPlan``. Its modeled seconds and joules price the
paper's in-memory edge devices, not the card. ``ReplanMonitor`` closes the
loop online: when a serving ``StreamingGNNServer``'s measured commit
latency or traffic drifts from the prediction, the planner re-runs on the
live graph with the measured workload and swaps the plan in place; the
swapped server keeps its device and its parameters.

    from repro_torch.planner import WorkloadProfile, plan
    result = plan(graph, "throughput",
                  WorkloadProfile(churn=0.01, queries_per_tick=64))
    server = StreamingGNNServer(result.build_plan(graph), cfg)
    ReplanMonitor(result).attach(server)
"""
from ..telemetry import CommitSample, DriftLedger, commit_sample

from .evaluate import (DEFAULT_EVALUATORS, PlanContext, accuracy_evaluator,
                       cost_evaluator, evaluate, mapper_evaluator,
                       memory_evaluator, neighbor_evaluator,
                       traffic_evaluator)
from .objective import OBJECTIVES, effective_compute, score, tick_costs
from .plan import (PlannerResult, ScoredCandidate, pareto_frontier, plan,
                   score_candidate)
from .replan import ReplanEvent, ReplanMonitor
from .space import (BACKENDS, LAYOUTS, NEIGHBOR_MODES, POLICIES, SETTINGS,
                    Candidate, WorkloadProfile, candidate_space)

__all__ = [
    "BACKENDS", "LAYOUTS", "NEIGHBOR_MODES", "POLICIES", "SETTINGS",
    "Candidate", "WorkloadProfile", "candidate_space",
    "DEFAULT_EVALUATORS", "PlanContext", "accuracy_evaluator",
    "cost_evaluator", "evaluate",
    "mapper_evaluator", "memory_evaluator", "neighbor_evaluator",
    "traffic_evaluator",
    "OBJECTIVES", "effective_compute", "score", "tick_costs",
    "PlannerResult", "ScoredCandidate", "pareto_frontier", "plan",
    "score_candidate",
    "ReplanEvent", "ReplanMonitor",
    "CommitSample", "DriftLedger", "commit_sample",
]
