from rays1bench.utils import profiling, metrics

__all__ = ["profiling", "metrics"]
