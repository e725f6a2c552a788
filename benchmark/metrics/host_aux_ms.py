"""host_aux_ms: host ms a unit in the tick's outputs, from the program's own
span ``aux`` (``plugins/force_acc.py::_step_impl``: the failure flag, the
dynamic-feasibility residual, ``ForceAccAux``), self time under the
profiler, no synchronize (``program_trace.py``)."""
from benchmark import program_trace


def read(trace):
    return program_trace.layer_ms(trace, "aux")
