"""Share of the profiled window of a training cell in which the device was
idle while the host was in the sparse factorization (`tt.factor`: the level
plan or the whole plan, the dense tail's update and its Cholesky): the spans
of theseus_tpu_torch/tracing.py, split by portbench/spans.py."""

from portbench.spans import reader

read = reader("train", "factor")
