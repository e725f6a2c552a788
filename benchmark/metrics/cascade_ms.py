"""cascade_ms: host-clock ms a unit inside the prioritized cascade
(``opt/hierarchy.py::solve``, which sends each level to the level kernel),
each call wrapped in synchronizes during the traced run's span pass."""


def read(trace):
    ms = trace["spans_ms"].get("cascade")
    return ms if ms else None
