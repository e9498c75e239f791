from .modules import MLP, Chain, Dense, params_from_numpy

__all__ = ["Dense", "Chain", "MLP", "params_from_numpy"]
