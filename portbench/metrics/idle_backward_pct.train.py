"""Share of the profiled window of a training cell in which the device was
idle while the host was in the implicit backward (`tt.backward.*`: the
solve's VJP with the substitutions it runs, the assembly's and the twins'
VJPs): the spans of theseus_tpu_torch/tracing.py, split by
portbench/spans.py."""

from portbench.spans import reader

read = reader("train", "backward")
