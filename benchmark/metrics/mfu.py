"""mfu: the whole unit's share of the card's float32 peak, in %: the
matrix-product FLOPs of one unit counted on the plain reference (level
solves and NS inverses at their frozen declared costs, ``accounting.py``)
over the unit's time in the run's untraced window, over 67 TFLOP/s."""
from benchmark.accounting import PEAK_F32_FLOPS


def read(trace):
    if not trace["flops_per_unit"] or trace["unit_s"] <= 0.0:
        return None
    return 100.0 * trace["flops_per_unit"] / trace["unit_s"] / PEAK_F32_FLOPS
