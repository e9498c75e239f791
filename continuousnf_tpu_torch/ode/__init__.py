from .solve import SolveStats, odeint_with_stats
from .tableaus import TABLEAUS, ButcherTableau, get_tableau

__all__ = ["odeint_with_stats", "SolveStats", "TABLEAUS", "ButcherTableau", "get_tableau"]
