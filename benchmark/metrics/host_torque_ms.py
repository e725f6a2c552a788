"""host_torque_ms: host ms a unit in torque reconstruction, from the
program's own span ``torque`` (``plugins/force_acc.py::step_core`` after
the solve: qddot and wrenches, the contact-Jacobian loop, ``rnea``), self
time under the profiler, no synchronize (``program_trace.py``)."""
from benchmark import program_trace


def read(trace):
    return program_trace.layer_ms(trace, "torque")
