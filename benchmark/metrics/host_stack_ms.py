"""host_stack_ms: host ms a unit in stack assembly, from the program's own
span ``stack`` (``stack/autostack.py::AutoStack.build``), self time under
the profiler, no synchronize (``program_trace.py``)."""
from benchmark import program_trace


def read(trace):
    return program_trace.layer_ms(trace, "stack")
