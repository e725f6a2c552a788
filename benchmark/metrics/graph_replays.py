"""graph_replays: tick replays through the tick's CUDA graph a unit, from
the program's counter ``tick_graph.replay`` over the traced units
(``program_trace.py``): 1 where every traced tick ran as one graph launch
(``qppvm_tpu_torch/runtime/tick_graph.py``). None for a program without
the graph, which counts neither ``tick_graph.replay`` nor
``tick_graph.capture``."""
from benchmark import program_trace


def read(trace):
    try:
        from qppvm_tpu_torch import telemetry
    except ImportError:
        return None
    totals = telemetry.counts()
    if not totals["tick_graph.replay"] and not totals["tick_graph.capture"]:
        return None
    return program_trace.count_per_unit(trace, "tick_graph.replay")
