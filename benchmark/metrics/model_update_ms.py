"""model_update_ms: host-clock ms a unit inside the model update
(``model/dynamics.py::compute_model_data``), each call wrapped in
synchronizes during the traced run's span pass."""


def read(trace):
    ms = trace["spans_ms"].get("model_update")
    return ms if ms else None
