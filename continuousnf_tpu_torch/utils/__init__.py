from .debug import check_array

__all__ = ["check_array"]
