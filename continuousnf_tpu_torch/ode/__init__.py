from .solve import SolveStats, backsolve_stats, odeint, odeint_saveat, odeint_with_stats
from .tableaus import TABLEAUS, ButcherTableau, get_tableau

__all__ = [
    "odeint",
    "odeint_with_stats",
    "odeint_saveat",
    "backsolve_stats",
    "SolveStats",
    "TABLEAUS",
    "ButcherTableau",
    "get_tableau",
]
