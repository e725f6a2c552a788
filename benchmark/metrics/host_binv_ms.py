"""host_binv_ms: host ms a unit in the mass matrix's inverse of the model
update, from the program's own span ``model_update.binv``
(``model/dynamics.py::compute_model_data`` with ``need_binv``: one NS-kernel
launch for a float32 state on the card), self time under the profiler, no
synchronize (``program_trace.py``). None where no tick inverts its mass
matrix."""
from benchmark import program_trace


def read(trace):
    return program_trace.layer_ms(trace, "model_update.binv")
