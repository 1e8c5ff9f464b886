"""k1_valid_share: the share of K1's swept slots that hold a valid pair,
in %: 100 x the port's ``k1.valid_pairs`` counter (valid rows x valid
columns) over its ``k1.slots`` (rows x columns swept), over the whole
window. K1's CUDA path keeps these counters; on the CPU the plain matcher
runs and the metric finds nothing."""

from portbench.program import get, ratio

CARD_ONLY = True  # nothing to read on the CPU (tests/test_program.py)


def read(data):
    p = data.program
    return ratio(get(p, "window", "k1.valid_pairs"), get(p, "window", "k1.slots"), 100.0)
