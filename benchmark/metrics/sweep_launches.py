"""sweep_launches: model-sweep kernel launches a unit, from the program's
counter ``model_sweep.launch`` over the traced units (``program_trace.py``):
1 where each tick's model update runs its recursive sweeps (fk, nonlinear
term, bias accelerations) in the kernel. None for a program without the
kernel's dispatch, which counts neither ``model_sweep.launch`` nor
``model.plain_sweep``."""
from benchmark import program_trace


def read(trace):
    try:
        from qppvm_tpu_torch import telemetry
    except ImportError:
        return None
    totals = telemetry.counts()
    if not totals["model_sweep.launch"] and not totals["model.plain_sweep"]:
        return None
    return program_trace.count_per_unit(trace, "model_sweep.launch")
