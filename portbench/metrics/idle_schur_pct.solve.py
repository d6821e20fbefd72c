"""Share of the profiled window of a solve cell in which the device was idle
while the host was in the Schur solve (optim/schur.py: `tt.schur.eliminate`,
`tt.schur.reduce`, `tt.schur.factor`, `tt.schur.backsub`): the spans of
theseus_tpu_torch/tracing.py, split by portbench/spans.py."""

from portbench.spans import idle_pct

NAMES = ("tt.schur.eliminate", "tt.schur.reduce", "tt.schur.factor", "tt.schur.backsub")


def read(ctx):
    return idle_pct(ctx, NAMES) if ctx.kind == "solve" else None
