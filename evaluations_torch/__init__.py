"""The paper-figure evaluations of theseus_tpu_torch, one for each script of evaluations/ that reproduces a figure or an ablation (same name, same options, plus --device)."""
