from rays1bench.runtime import native

__all__ = ["native"]
