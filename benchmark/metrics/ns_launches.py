"""ns_launches: NS-kernel launches a unit, from the program's counter
``ns_inverse.launch`` over the traced units (``program_trace.py``): in the
loop, the plant's mass-matrix inverse, one a substep."""
from benchmark import program_trace


def read(trace):
    return program_trace.count_per_unit(trace, "ns_inverse.launch")
