"""host_plant_ms: host ms a unit in the plant, from the program's own spans
``plant`` (``runtime/robot_interface.py::SimRobot.move``) and
``plant.substep``, self times under the profiler, no synchronize
(``program_trace.py``). The plant paces the free-running loop."""
from benchmark import program_trace


def read(trace):
    return program_trace.layer_ms(trace, "plant")
