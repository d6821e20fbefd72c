"""Share of the profiled window of a solve cell in which the device was idle
while the host was in the LM loop's own code (optim/nonlinear.py:
`tt.lm.init`, `tt.lm.sync`, and `tt.lm.iteration` and `tt.solve` outside
their children): the spans of theseus_tpu_torch/tracing.py, split by
portbench/spans.py."""

from portbench.spans import reader

read = reader("solve", "lm")
