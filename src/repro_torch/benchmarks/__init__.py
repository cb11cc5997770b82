"""The repository's evaluation scripts on the card: the counterparts of
the reference's ``benchmarks/`` (the paper's Tables 1 and 2, whole-step
validation and the rooflines), run as
``python -m repro_torch.benchmarks.<script>``."""
