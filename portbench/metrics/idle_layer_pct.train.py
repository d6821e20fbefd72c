"""Share of the profiled window of a training cell in which the device was
idle while the host was in the layer's own code (layer.py: `tt.forward`
outside its children, `tt.pack`, `tt.unpack`, `tt.implicit_step` outside its
children): the spans of theseus_tpu_torch/tracing.py, split by
portbench/spans.py."""

from portbench.spans import reader

read = reader("train", "layer")
