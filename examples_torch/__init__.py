"""The example scripts of theseus_tpu_torch, one for each script of examples/ (same name, same options, plus --device)."""
