"""Step analysis (the port of ``repro.analysis``): FLOPs and traffic of
one step, counted over the aten ops it dispatches."""
from .op_stats import count_step
