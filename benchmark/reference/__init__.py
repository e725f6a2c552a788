"""The benchmark's plain reference: a frozen copy of the plain path of
``qppvm_tpu_torch`` (model, tasks, stack, cascade, ForceAcc plugin, plant,
rollouts, MPPI) as it stood when the benchmark was defined, with each
kernel route replaced by the kernel's plain function (``opt/level_qp.py``,
``opt/ns_inverse.py``) counted at its declared cost. It imports nothing of
the program and takes nothing the program made; ``scenario.py`` builds it
from a configuration file."""
