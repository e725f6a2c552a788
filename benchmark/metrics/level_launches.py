"""level_launches: level-kernel launches a unit, from the program's counter
``level_qp.launch`` over the traced units (``program_trace.py``). A count,
so it repeats exactly where the program's path does."""
from benchmark import program_trace


def read(trace):
    return program_trace.count_per_unit(trace, "level_qp.launch")
