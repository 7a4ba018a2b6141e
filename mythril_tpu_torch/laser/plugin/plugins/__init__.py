"""Built-in laser plugins."""
from .benchmark import BenchmarkPluginBuilder
from .call_depth_limiter import CallDepthLimitBuilder
from .coverage.coverage_plugin import CoveragePluginBuilder
from .dependency_pruner import DependencyPrunerBuilder
from .instruction_profiler import InstructionProfilerBuilder
from .mutation_pruner import MutationPrunerBuilder
