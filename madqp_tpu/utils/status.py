"""Solver status codes, execution statistics and counters.

Functional re-design of the MadNLP solver-abstraction surface consumed by the
reference (see /root/reference/src/solver.jl:363-399 for the status taxonomy
and MadNLPExecutionStats usage at src/solver.jl:351,399).  `success` is
`status == Status.SOLVE_SUCCEEDED`, matching the reference's `status == 1`
convention (scripts/tables/generate_tables.jl:66-68).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, Optional

import numpy as np


class Status(enum.IntEnum):
    """Terminal and internal solver statuses (MadNLP.Status equivalent)."""

    SOLVE_SUCCEEDED = 1
    SOLVED_TO_ACCEPTABLE_LEVEL = 2
    INFEASIBLE_PROBLEM_DETECTED = 3
    MAXIMUM_ITERATIONS_EXCEEDED = 4
    MAXIMUM_WALLTIME_EXCEEDED = 5
    ERROR_IN_STEP_COMPUTATION = 6
    NOT_ENOUGH_DEGREES_OF_FREEDOM = 7
    USER_REQUESTED_STOP = 8
    INTERNAL_ERROR = 9
    INVALID_NUMBER_DETECTED = 10
    INVALID_NUMBER_OBJECTIVE = 11
    INVALID_NUMBER_GRADIENT = 12
    INVALID_NUMBER_CONSTRAINTS = 13
    INVALID_NUMBER_JACOBIAN = 14
    INVALID_NUMBER_HESSIAN_LAGRANGIAN = 15
    DIVERGING_ITERATES = 16
    UNBOUNDED_PROBLEM_DETECTED = 17
    # Internal (non-terminal) states.
    INITIAL = 100
    REGULAR = 101


STATUS_OUTPUT = {
    Status.SOLVE_SUCCEEDED: "Optimal Solution Found.",
    Status.SOLVED_TO_ACCEPTABLE_LEVEL: "Solved To Acceptable Level.",
    Status.INFEASIBLE_PROBLEM_DETECTED: "Converged to a point of local infeasibility.",
    Status.MAXIMUM_ITERATIONS_EXCEEDED: "Maximum Number of Iterations Exceeded.",
    Status.MAXIMUM_WALLTIME_EXCEEDED: "Maximum wall-clock Time Exceeded.",
    Status.ERROR_IN_STEP_COMPUTATION: "Error in step computation.",
    Status.NOT_ENOUGH_DEGREES_OF_FREEDOM: "Problem has too few degrees of freedom.",
    Status.USER_REQUESTED_STOP: "Stopping optimization at current point as requested by user.",
    Status.INTERNAL_ERROR: "Internal error.",
    Status.INVALID_NUMBER_DETECTED: "Invalid number in NLP function or derivative detected.",
    Status.INVALID_NUMBER_OBJECTIVE: "Invalid number in NLP objective function detected.",
    Status.INVALID_NUMBER_GRADIENT: "Invalid number in NLP objective gradient detected.",
    Status.INVALID_NUMBER_CONSTRAINTS: "Invalid number in NLP constraint function detected.",
    Status.INVALID_NUMBER_JACOBIAN: "Invalid number in NLP constraint Jacobian detected.",
    Status.INVALID_NUMBER_HESSIAN_LAGRANGIAN: "Invalid number in NLP Hessian Lagrangian detected.",
    Status.DIVERGING_ITERATES: "Iterates diverging; problem might be unbounded or infeasible (no certificate).",
    Status.UNBOUNDED_PROBLEM_DETECTED: "Problem unbounded below (certified descent ray).",
    Status.INITIAL: "Initial.",
    Status.REGULAR: "Running.",
}


def get_status_output(status: Status) -> str:
    return STATUS_OUTPUT.get(status, f"Unknown status {status}.")


@dataclasses.dataclass
class Counters:
    """Timing and evaluation counters.

    Equivalent of MadNLP.MadNLPCounters consumed by the reference at
    src/structure.jl:84,153 and src/solver.jl:353,392.  We additionally split
    out compile time, which has no CUDA analogue but matters under XLA.
    """

    start_time: float = 0.0
    init_time: float = 0.0
    total_time: float = 0.0
    linear_solver_time: float = 0.0
    # Wall seconds spent in a two-phase solve's endgame (phase 2).  For
    # endgame="host" this is HOST-CPU time inside a nominally-device solve —
    # recorded so suite ratios can state the hybrid share honestly.
    endgame_time: float = 0.0
    endgame_backend: str = ""
    eval_function_time: float = 0.0
    compile_time: float = 0.0
    k: int = 0  # iteration count
    obj_cnt: int = 0
    con_cnt: int = 0
    grad_cnt: int = 0
    factorizations: int = 0
    backsolves: int = 0


@dataclasses.dataclass
class ExecutionStats:
    """Result object (MadNLPExecutionStats equivalent).

    Field names mirror the consumers in the reference's benchmark harness
    (scripts/benchmarks_cpu.jl:47-55) and test suite (test/runtests.jl:16-20):
    status, objective, solution, constraints, multipliers, multipliers_L,
    multipliers_U, iter, counters.
    """

    status: Status
    objective: float
    solution: np.ndarray
    constraints: np.ndarray
    multipliers: np.ndarray
    multipliers_L: np.ndarray
    multipliers_U: np.ndarray
    iter: int
    counters: Counters
    dual_objective: float = float("nan")
    primal_feas: float = float("nan")
    dual_feas: float = float("nan")
    complementarity: float = float("nan")
    options: Optional[Any] = None

    @property
    def success(self) -> bool:
        return self.status == Status.SOLVE_SUCCEEDED

    @property
    def total_time(self) -> float:
        return self.counters.total_time

    @property
    def linear_solver_time(self) -> float:
        return self.counters.linear_solver_time
