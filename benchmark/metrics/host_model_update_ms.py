"""host_model_update_ms: host ms a unit in the model update, from the
program's own spans: ``model_update`` (``model/dynamics.py::
compute_model_data``) and its stages (fk, mass matrix, nonlinear term,
Jacobians, velocities, bias accelerations, CoM), self times under the
profiler, no synchronize (``program_trace.py``)."""
from benchmark import program_trace


def read(trace):
    return program_trace.layer_ms(trace, "model_update")
