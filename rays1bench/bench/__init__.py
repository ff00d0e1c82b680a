from rays1bench.bench.harness import benchmark, BenchResult, log_results
from rays1bench.bench import report

__all__ = ["benchmark", "BenchResult", "log_results", "report"]
