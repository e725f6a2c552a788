"""host_tick_self_ms: host ms a unit in the tick that no layer's span
names: the self time of the program's span ``tick``
(``plugins/force_acc.py::_step_impl``) under the profiler, no synchronize
(``program_trace.py``)."""
from benchmark import program_trace


def read(trace):
    return program_trace.layer_ms(trace, "tick")
