"""host_cascade_ms: host ms a unit in the cascade, from the program's own
spans ``cascade`` (``opt/hierarchy.py::solve``) and ``cascade.level`` (each
level's solver call), self times under the profiler, no synchronize
(``program_trace.py``)."""
from benchmark import program_trace


def read(trace):
    return program_trace.layer_ms(trace, "cascade")
