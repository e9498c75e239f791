from .modules import MLP, Chain, CondLayer, CondWrap, Dense, params_from_numpy

__all__ = ["Dense", "Chain", "MLP", "CondLayer", "CondWrap", "params_from_numpy"]
