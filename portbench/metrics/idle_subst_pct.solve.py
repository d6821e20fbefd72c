"""Share of the profiled window of a solve cell in which the device was idle
while the host was in the substitutions (`tt.subst`: both sweeps and the
tail's triangular solves; those of the backward count as backward): the
spans of theseus_tpu_torch/tracing.py, split by portbench/spans.py."""

from portbench.spans import reader

read = reader("solve", "subst")
